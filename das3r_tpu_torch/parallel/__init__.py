"""Multi-device training over ``torch.distributed`` (port of
``das3r_tpu/parallel/``): the (data, gauss, tile) mesh (``mesh``), the
sharded step and render (``sharded``), process start-up (``multihost``),
the collectives (``collectives``) and their byte counts (``comm_stats``).

Only the mesh is imported here: ``ops/splat/rasterize.py`` imports
``collectives``, and ``sharded`` imports the renderer.
"""
from das3r_tpu_torch.parallel.mesh import Mesh, make_mesh
