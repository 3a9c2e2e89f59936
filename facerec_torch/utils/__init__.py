from facerec_torch.utils.profiling import StageTimer, timed_call, trace

__all__ = ["StageTimer", "timed_call", "trace"]
