"""The port's command line (``python -m facerec_torch.cli.main``)."""
