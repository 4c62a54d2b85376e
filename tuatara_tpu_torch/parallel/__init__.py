from tuatara_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh
from tuatara_tpu_torch.parallel.sharding import shard_pages, sharded_ocr_programs

__all__ = ["Mesh", "init_distributed", "make_mesh", "shard_pages", "sharded_ocr_programs"]
