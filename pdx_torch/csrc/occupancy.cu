// Registers a thread and resident CTAs per SM of kernels K1 and K3 at a tile
// shape (cudaFuncGetAttributes, cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// K2 and K4 answer the same question in their own sources.
#include "terms_common.cuh"

namespace pdx {
__global__ void fused_ks_gram_kernel(const float* __restrict__ U, const float* __restrict__ Ut,
                                     int T, int H, int W, int TH, int TW, int frames_per_cta,
                                     Stencil s, double* __restrict__ partials);
__global__ void fused_blockwise_gram_kernel(const float* __restrict__ U,
                                            const float* __restrict__ Ut, int T, int H, int W,
                                            int bt, int bx, int by, int TH, int TW,
                                            int tblocks_per_cta, Stencil s,
                                            double* __restrict__ partials);
}  // namespace pdx

extern "C" long long pdx_fused_ks_gram_smem_bytes(int TH, int TW);
extern "C" long long pdx_fused_blockwise_smem_bytes(int TH, int TW, int bx, int by);

extern "C" int pdx_fused_ks_gram_occupancy(int TH, int TW, int* regs, int* ctas) {
  return pdx::kernel_occupancy(pdx::fused_ks_gram_kernel, pdx::kThreads,
                               (size_t)pdx_fused_ks_gram_smem_bytes(TH, TW), regs, ctas);
}

extern "C" int pdx_fused_blockwise_occupancy(int TH, int TW, int bx, int by, int* regs,
                                             int* ctas) {
  return pdx::kernel_occupancy(pdx::fused_blockwise_gram_kernel, pdx::kThreads,
                               (size_t)pdx_fused_blockwise_smem_bytes(TH, TW, bx, by), regs,
                               ctas);
}
