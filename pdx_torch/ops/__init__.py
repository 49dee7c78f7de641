"""pdx_torch.ops — stencils, metrics, linear algebra and the CUDA kernels."""
