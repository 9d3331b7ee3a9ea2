"""Command-line tools of the port: ``python -m repro_torch.tools.calibrate``
and ``python -m repro_torch.tools.precompile``."""
