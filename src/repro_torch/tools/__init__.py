"""Command-line tools of the port: ``python -m repro_torch.tools.calibrate``,
``python -m repro_torch.tools.precompile`` and
``python -m repro_torch.tools.verify_program``."""
