"""pdx_torch.ops — stencils, FFT derivatives, filters, interpolation, metrics,
linear algebra and the CUDA kernels."""
