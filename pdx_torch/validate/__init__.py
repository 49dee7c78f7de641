"""pdx_torch.validate — rollout validation."""
