"""pdx_torch.library — candidate-term dictionaries and dataset builders."""
