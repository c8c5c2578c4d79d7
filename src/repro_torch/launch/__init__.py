"""Entry points and the mesh layer: ``python -m repro_torch.launch.train``,
``.serve`` and ``.dryrun``; the device meshes (``mesh``), the spec trees
(``specs``), the parallelism policy (``policy``) and the per-rank cost and
collective counters (``hlo_costs``, ``hlo_stats``)."""
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh, mesh_chips  # noqa: F401
