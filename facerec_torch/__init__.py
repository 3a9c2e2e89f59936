"""PyTorch/CUDA port of the face-recognition serve step.

A second package beside ``facerec_tpu`` with the same sub-package layout
(``ops/``, ``models/``, ``detect/``, ``serve/``, ``data/``). It imports torch
and numpy only — never JAX, flax or ``facerec_tpu`` — and keeps its own
copies of the helpers it needs. The two hand-written Hopper kernels live in
``csrc/`` and are built with ``nvcc`` at first use (``facerec_torch.build``).

Entry points take ``device=None``, which means the first CUDA card; with no
card they raise instead of falling back to the CPU. Tests pass
``device="cpu"``, where every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "facerec_torch runs on a CUDA card by default and none is present; "
            "pass device='cpu' explicitly to run the plain PyTorch versions")
    return dev


def is_device_error(e: BaseException) -> bool:
    """A CUDA error, after which the card's context may be unusable: the
    flows that record a failure and go on (the tuner's trials, compare-all's
    model types) raise it instead."""
    accel = getattr(torch, "AcceleratorError", None)
    return (accel is not None and isinstance(e, accel)) or (
        isinstance(e, RuntimeError) and "CUDA error" in str(e))
