// K3 — fused blockwise average + Gram statistics.
//
// Replaces the TPU kernel pdx/ops/pallas/fused_blockwise.py::fused_blockwise_gram
// (pallas_call at :317, kernel body _kernel at :61): for every block of
// bt x bx x by samples it forms the block means of [lap, bih, |grad u|^2]
// and of u_t (ragged tails on every axis divide by their valid cell count,
// n_valid_t * cnt_sp), then accumulates the 14 sufficient statistics of
// those block-mean rows, n = nbt * nbx * nby. Neither the (3, T, H, W) term
// stack nor the (n_blocks, 3) design matrix is materialised.
//
// What bounds it on the card: memory, as for K1 — it reads U and Ut once
// (~160 MB a pass at the main path's (1999, 100, 100) float32 shape) and
// computes little per byte. The TPU kernel summed blocks with selector GEMMs
// (Px @ ts @ Py) only to work around a Mosaic reshape limit; here each
// spatial block is summed directly. A CTA's tile is a whole number of
// (bx, by) blocks and the CTA owns whole temporal blocks, so every block's
// bt x bx x by sum is complete inside one CTA (in float64 shared-memory
// accumulators, one warp per spatial block, no atomics) before its mean is
// squared into the statistics. The TPU wrapper's zero-padding of T (a copy
// of U) is replaced by looping over each temporal block's real frames.
#include "gram_common.cuh"

namespace pdx {

// grid = (tiles along H, tiles along W, temporal-block chunks); block = kThreads.
// The tile is TH x TW = (kbx * bx) x (kby * by) points.
__global__ void fused_blockwise_gram_kernel(const float* __restrict__ U,
                                            const float* __restrict__ Ut, int T, int H,
                                            int W, int bt, int bx, int by, int TH, int TW,
                                            int tblocks_per_cta, Stencil s,
                                            double* __restrict__ partials) {
  extern __shared__ float smem[];
  const size_t n_float = stencil_smem_floats(TH, TW);
  float* su = smem;
  float* sl = smem + (TH + 4) * (TW + 4);
  double* bacc = reinterpret_cast<double*>(smem + n_float + (n_float & 1));  // [nblk][4]

  const int kbx = TH / bx, kby = TW / by, nblk = kbx * kby;
  const int nbx = (H + bx - 1) / bx, nby = (W + by - 1) / by, nbt = (T + bt - 1) / bt;
  const int x0 = blockIdx.x * TH, y0 = blockIdx.y * TW;
  const int bi0 = blockIdx.x * kbx, bj0 = blockIdx.y * kby;
  const int tb_begin = blockIdx.z * tblocks_per_cta;
  const int tb_end = min(nbt, tb_begin + tblocks_per_cta);
  const long long frame = (long long)H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  const int bsize = bx * by;

  double acc[kStats];
#pragma unroll
  for (int k = 0; k < kStats; ++k) acc[k] = 0.0;
  for (int i = threadIdx.x; i < 4 * nblk; i += blockDim.x) bacc[i] = 0.0;

  for (int tb = tb_begin; tb < tb_end; ++tb) {
    const int t0 = tb * bt, t1 = min(T, t0 + bt);
    for (int t = t0; t < t1; ++t) {
      load_patch(U + t * frame, H, W, x0, y0, TH, TW, su);
      __syncthreads();
      patch_laplacian(su, TH, TW, s, sl);
      __syncthreads();
      const float* ut = Ut + t * frame;
      // warp `warp` owns spatial blocks warp, warp + nwarp, ... for every
      // frame, so its shared accumulators need no atomics
      for (int j = warp; j < nblk; j += nwarp) {
        const int bi = j / kby, bj = j - bi * kby;
        double v0 = 0.0, v1 = 0.0, v2 = 0.0, vy = 0.0;
        for (int p = lane; p < bsize; p += 32) {
          const int r = bi * bx + p / by, c = bj * by + p % by;
          const int gx = x0 + r, gy = y0 + c;
          if (gx >= H || gy >= W) continue;
          float lap, bih, gsq;
          ks_terms(su, sl, TW, r, c, s, lap, bih, gsq);
          v0 += lap; v1 += bih; v2 += gsq;
          vy += ut[(long long)gx * W + gy];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v0 += __shfl_down_sync(0xffffffffu, v0, off);
          v1 += __shfl_down_sync(0xffffffffu, v1, off);
          v2 += __shfl_down_sync(0xffffffffu, v2, off);
          vy += __shfl_down_sync(0xffffffffu, vy, off);
        }
        if (lane == 0) {
          bacc[4 * j] += v0; bacc[4 * j + 1] += v1;
          bacc[4 * j + 2] += v2; bacc[4 * j + 3] += vy;
        }
      }
      __syncthreads();  // the next frame overwrites su / sl; bacc complete
    }
    // block means of this temporal block -> statistics; reset accumulators
    for (int j = threadIdx.x; j < nblk; j += blockDim.x) {
      const int gbx = bi0 + j / kby, gby = bj0 + j % kby;
      if (gbx < nbx && gby < nby) {
        const double cnt = (double)(t1 - t0) * (double)min(bx, H - gbx * bx) *
                           (double)min(by, W - gby * by);
        accumulate(acc, bacc[4 * j] / cnt, bacc[4 * j + 1] / cnt, bacc[4 * j + 2] / cnt,
                   bacc[4 * j + 3] / cnt);
      }
      bacc[4 * j] = bacc[4 * j + 1] = bacc[4 * j + 2] = bacc[4 * j + 3] = 0.0;
    }
    __syncthreads();
  }
  const int cta = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  write_block_row(acc, partials + (long long)cta * kStats);
}

inline size_t blockwise_smem_bytes(int TH, int TW, int bx, int by) {
  const size_t n_float = stencil_smem_floats(TH, TW);
  return (n_float + (n_float & 1)) * sizeof(float) +
         (size_t)4 * (TH / bx) * (TW / by) * sizeof(double);
}

}  // namespace pdx

// Shared memory one CTA needs for a TH x TW tile of (bx, by) blocks; the
// wrapper checks it against the card's per-block limit before launching.
extern "C" long long pdx_fused_blockwise_smem_bytes(int TH, int TW, int bx, int by) {
  return (long long)pdx::blockwise_smem_bytes(TH, TW, bx, by);
}

// C interface (bound with ctypes). partials holds grid_x*grid_y*grid_z rows
// of 14 doubles; out receives the 14 statistics. Returns cudaGetLastError().
extern "C" int pdx_fused_blockwise_gram(const float* U, const float* Ut, int T, int H,
                                        int W, int bt, int bx, int by, int TH, int TW,
                                        int tblocks_per_cta, int grid_x, int grid_y,
                                        int grid_z, float dx2, float dy2, float two_dx,
                                        float two_dy, double* partials, double* out,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = pdx::blockwise_smem_bytes(TH, TW, bx, by);
  cudaError_t err = cudaFuncSetAttribute(pdx::fused_blockwise_gram_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const pdx::Stencil s{dx2, dy2, two_dx, two_dy};
  pdx::fused_blockwise_gram_kernel<<<dim3(grid_x, grid_y, grid_z), pdx::kThreads, smem,
                                     st>>>(U, Ut, T, H, W, bt, bx, by, TH, TW,
                                           tblocks_per_cta, s, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pdx::reduce_rows_kernel<<<pdx::kStats, pdx::kThreads, 0, st>>>(
      partials, grid_x * grid_y * grid_z, pdx::kStats, out);
  return (int)cudaGetLastError();
}
