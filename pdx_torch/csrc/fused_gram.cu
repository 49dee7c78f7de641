// K1 — fused KS dictionary + Gram statistics over the full field.
//
// Replaces the TPU kernel pdx/ops/pallas/fused_gram.py::fused_ks_gram
// (pallas_call at :320, kernel body _kernel at :72): the 14 sufficient
// statistics of the true KS library [lap, bih, |grad u|^2] against u_t over
// every (t, x, y) sample, n = T*H*W, without materialising the (3, T, H, W)
// term stack.
//
// What bounds it on the card: memory. It reads U and Ut once — at the main
// path's (1999, 100, 100) float32 shape 2 * 1999 * 100 * 100 * 4 B ~ 160 MB
// a pass — and does ~40 float32 and 28 float64 operations per 8 bytes read,
// below the card's ridge (~20 f32 / ~10 f64 flop per byte of HBM bandwidth).
// The design therefore reads each input element from device memory
// once per tile (the 2-cell halo re-reads ~1.16x of U at 50x50 tiles, from
// L2), keeps every intermediate field in shared memory / registers, writes
// only 14 doubles per CTA, and spreads (tiles x frame chunks) CTAs over all
// SMs so enough loads are in flight. Fields are float32 like the TPU kernel;
// products are accumulated in float64 (native on the H100), because a
// ~2e7-term float32 sum loses the digits the 1e-6 coefficient target needs.
//
// Ragged frames: the TPU wrapper zero-pads T to a block multiple (a copy of
// U); here a CTA loops over its real frames only. Ragged tiles: points
// outside the H x W frame are loaded (wrapped) for the halo but never
// accumulated.
#include "gram_common.cuh"

namespace pdx {

// grid = (tiles along H, tiles along W, frame chunks); block = kThreads.
__global__ void fused_ks_gram_kernel(const float* __restrict__ U,
                                     const float* __restrict__ Ut, int T, int H, int W,
                                     int TH, int TW, int frames_per_cta, Stencil s,
                                     double* __restrict__ partials) {
  extern __shared__ float smem[];
  float* su = smem;
  float* sl = smem + (TH + 4) * (TW + 4);
  const int x0 = blockIdx.x * TH, y0 = blockIdx.y * TW;
  const int t_begin = blockIdx.z * frames_per_cta;
  const int t_end = min(T, t_begin + frames_per_cta);
  const long long frame = (long long)H * W;

  double acc[kStats];
#pragma unroll
  for (int k = 0; k < kStats; ++k) acc[k] = 0.0;

  for (int t = t_begin; t < t_end; ++t) {
    load_patch(U + t * frame, H, W, x0, y0, TH, TW, su);
    __syncthreads();
    patch_laplacian(su, TH, TW, s, sl);
    __syncthreads();
    const float* ut = Ut + t * frame;
    for (int i = threadIdx.x; i < TH * TW; i += blockDim.x) {
      const int r = i / TW, c = i - r * TW;
      const int gx = x0 + r, gy = y0 + c;
      if (gx >= H || gy >= W) continue;
      float lap, bih, gsq;
      ks_terms(su, sl, TW, r, c, s, lap, bih, gsq);
      accumulate(acc, lap, bih, gsq, ut[(long long)gx * W + gy]);
    }
    __syncthreads();  // the next frame overwrites su / sl
  }
  const int cta = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  write_block_row(acc, partials + (long long)cta * kStats);
}

}  // namespace pdx

// Shared memory one CTA needs for a TH x TW tile; the wrapper checks it
// against the card's per-block limit before launching.
extern "C" long long pdx_fused_ks_gram_smem_bytes(int TH, int TW) {
  return (long long)(pdx::stencil_smem_floats(TH, TW) * sizeof(float));
}

// C interface (bound with ctypes). partials holds grid_x*grid_y*grid_z rows
// of 14 doubles; out receives the 14 statistics. Returns cudaGetLastError().
extern "C" int pdx_fused_ks_gram(const float* U, const float* Ut, int T, int H, int W,
                                 int TH, int TW, int frames_per_cta, int grid_x,
                                 int grid_y, int grid_z, float dx2, float dy2,
                                 float two_dx, float two_dy, double* partials,
                                 double* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = pdx::stencil_smem_floats(TH, TW) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pdx::fused_ks_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const pdx::Stencil s{dx2, dy2, two_dx, two_dy};
  pdx::fused_ks_gram_kernel<<<dim3(grid_x, grid_y, grid_z), pdx::kThreads, smem, st>>>(
      U, Ut, T, H, W, TH, TW, frames_per_cta, s, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pdx::reduce_rows_kernel<<<pdx::kStats, pdx::kThreads, 0, st>>>(
      partials, grid_x * grid_y * grid_z, pdx::kStats, out);
  return (int)cudaGetLastError();
}
