"""Launchers of the port (reference: ``repro/launch``): ``train`` and
``serve``, run as ``python -m repro_torch.launch.train`` / ``.serve``."""
