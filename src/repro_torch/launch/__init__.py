"""Entry points: ``python -m repro_torch.launch.train`` and
``python -m repro_torch.launch.serve``, the reference's launchers on one
device (the card unless ``--device`` names another).  The reference's mesh
modules (``mesh``, ``specs``, ``policy``, ``dryrun``, ``hlo_stats``) and
``hlo_costs`` are not ported yet (ROADMAP.md, queue 1 items 6a-6b)."""
