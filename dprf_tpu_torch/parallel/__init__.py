"""Several devices: the mesh (mesh.py), the sharded runtime
(sharded.py) and the sharded mask worker (worker.py)."""

from dprf_tpu_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh"]
