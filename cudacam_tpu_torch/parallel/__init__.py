"""Tile sharding of the port: the (b, y, x) mesh, the packed halo round loop
and the sharded pipeline (``cudacam_tpu/parallel`` analog)."""
from cudacam_tpu_torch.parallel.mesh import AXES, TileMesh, make_mesh, single_device_mesh
from cudacam_tpu_torch.parallel.sharded import build_sharded_pipeline, shard_frame

__all__ = ["AXES", "TileMesh", "build_sharded_pipeline", "make_mesh", "shard_frame",
           "single_device_mesh"]
