"""Launch layer of the port (reference: ``repro/launch``): the ``train`` and
``serve`` launchers (``python -m repro_torch.launch.train`` / ``.serve``),
the step builders (``steps``), meshes and sharding rules (``mesh``,
``sharding``), and the dry run over every (arch x shape x mesh) cell
(``dryrun``, ``sweep``) with its program trace (``hlo_analysis``)."""
