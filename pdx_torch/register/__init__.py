"""pdx_torch.register — image registration (phase correlation)."""
