from dial_mpc_tpu_torch.parallel.distributed import init_distributed
from dial_mpc_tpu_torch.parallel.sharded import SampleMesh, ShardedMBDPI, global_sample_mesh

__all__ = ["SampleMesh", "ShardedMBDPI", "global_sample_mesh", "init_distributed"]
