"""pdx_torch.sim — data generators."""
