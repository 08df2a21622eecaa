from volpick_tpu_torch.parallel.mesh import batch_sharding, initialize_distributed, make_mesh, replicated

__all__ = ["make_mesh", "batch_sharding", "replicated", "initialize_distributed"]
