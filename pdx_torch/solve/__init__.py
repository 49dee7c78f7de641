"""pdx_torch.solve — sparse regression on sufficient statistics."""
