"""pdx_torch.ops.kernels — hand-written CUDA kernels for the hot paths.

Counterpart of ``pdx/ops/pallas/``. Each kernel has its plain PyTorch version
in the same module; a wrapper takes the plain version only for tensors on
the CPU, and on a CUDA tensor launches its kernel or raises.
"""
