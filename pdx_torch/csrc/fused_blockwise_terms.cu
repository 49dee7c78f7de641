// K4 — fused blockwise average + Gram statistics for any term list.
//
// Replaces the TPU kernel
// pdx/ops/pallas/fused_blockwise.py::fused_blockwise_gram_terms (pallas_call
// at :219, kernel body _kernel_terms at :109): for every block of
// bt x bx x by samples it forms the block means of any 1..9 terms of the
// rich KS vocabulary and of u_t (ragged tails on every axis divide by their
// valid cell count), then accumulates the S = p(p+1)/2 + 2p + 2 sufficient
// statistics of those block-mean rows, n = nbt * nbx * nby. Neither the
// (p, T, H, W) term stack nor the (n_blocks, p) design matrix is
// materialised.
//
// What bounds it on the card: memory. It reads U and Ut once (~160 MB at
// the main path's (1999, 100, 100) float32 shape, 0.048 ms at 3.35 TB/s);
// the block sums are p + 1 float64 adds a sample (0.006 ms at p = 9) and
// the Gram of the ~0.1 M block rows is negligible.
//
// Design: K3's structure. A CTA's tile is a whole number of (bx, by) blocks
// and the CTA owns whole temporal blocks, so every block sum completes
// inside one CTA. Per frame, one warp per spatial block sums the block's
// p term fields and u_t over its points (lanes stride the block, then a
// fixed shuffle order) into p + 1 float64 shared-memory sums. After the
// temporal block's last frame the sums become means, and the S statistics
// of the block-mean rows are accumulated with K2's scheme: each warp owns a
// fixed subset of the statistics, its lanes striding over the blocks. No
// atomics; two launches give the same bits. The block mean of `one` is
// exactly 1, ragged tails included (pdx masks padded frames at :121-127 for
// the same result; here there is no padding).
#include "gram_common.cuh"

namespace pdx {

// grid = (tiles along H, tiles along W, temporal-block chunks); block = kThreads.
// The tile is TH x TW = (kbx * bx) x (kby * by) points.
__global__ void fused_blockwise_gram_terms_kernel(const float* __restrict__ U,
                                                  const float* __restrict__ Ut, int T,
                                                  int H, int W, int bt, int bx, int by,
                                                  int TH, int TW, int tblocks_per_cta,
                                                  Stencil s, TermSpec spec,
                                                  double* __restrict__ partials) {
  extern __shared__ float smem[];
  const size_t n_float = stencil_smem_floats(TH, TW);
  float* su = smem;
  float* sl = smem + (TH + 4) * (TW + 4);
  double* bacc = reinterpret_cast<double*>(smem + n_float + (n_float & 1));  // [nblk][p + 1]

  const int p = spec.p, nc = p + 1;
  const int kbx = TH / bx, kby = TW / by, nblk = kbx * kby;
  const int nbx = (H + bx - 1) / bx, nby = (W + by - 1) / by, nbt = (T + bt - 1) / bt;
  const int x0 = blockIdx.x * TH, y0 = blockIdx.y * TW;
  const int bi0 = blockIdx.x * kbx, bj0 = blockIdx.y * kby;
  // the blocks of this tile that lie in the frame: a vkbx x vkby corner
  const int vkbx = min(kbx, nbx - bi0), vkby = min(kby, nby - bj0), nvalid = vkbx * vkby;
  const int tb_begin = blockIdx.z * tblocks_per_cta;
  const int tb_end = min(nbt, tb_begin + tblocks_per_cta);
  const long long frame = (long long)H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  const int bsize = bx * by;

  int sa[kSlots], sb[kSlots];
  double acc[kSlots];
  warp_slots(spec, sa, sb);
#pragma unroll
  for (int m = 0; m < kSlots; ++m) acc[m] = 0.0;
  for (int i = threadIdx.x; i < nc * nblk; i += blockDim.x) bacc[i] = 0.0;

  for (int tb = tb_begin; tb < tb_end; ++tb) {
    const int t0 = tb * bt, t1 = min(T, t0 + bt);
    for (int t = t0; t < t1; ++t) {
      load_patch(U + t * frame, H, W, x0, y0, TH, TW, su);
      __syncthreads();
      patch_laplacian(su, TH, TW, s, sl);
      __syncthreads();
      const float* ut = Ut + t * frame;
      // warp `warp` owns spatial blocks warp, warp + nwarp, ... for every
      // frame, so its shared sums need no atomics
      for (int j = warp; j < nblk; j += nwarp) {
        const int bi = j / kby, bj = j - bi * kby;
        double v[kMaxTerms + 1];  // p term sums, then u_t's in v[kMaxTerms]
#pragma unroll
        for (int c = 0; c <= kMaxTerms; ++c) v[c] = 0.0;
        for (int q = lane; q < bsize; q += 32) {
          const int r = bi * bx + q / by, c = bj * by + q % by;
          const int gx = x0 + r, gy = y0 + c;
          if (gx >= H || gy >= W) continue;
          const PointFields f = point_fields(su, sl, TW, r, c, s);
#pragma unroll
          for (int jj = 0; jj < kMaxTerms; ++jj)
            if (jj < p) v[jj] += term_value(spec.code[jj], f);
          v[kMaxTerms] += ut[(long long)gx * W + gy];
        }
#pragma unroll
        for (int c = 0; c <= kMaxTerms; ++c) {
          if (c < p || c == kMaxTerms) {  // warp-uniform
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v[c] += __shfl_down_sync(0xffffffffu, v[c], off);
          }
        }
        if (lane == 0) {
          double* b = bacc + j * nc;
#pragma unroll
          for (int c = 0; c < kMaxTerms; ++c)
            if (c < p) b[c] += v[c];
          b[p] += v[kMaxTerms];
        }
      }
      __syncthreads();  // the next frame overwrites su / sl; bacc complete
    }
    // block sums -> block means, for the blocks inside the frame
    for (int j = threadIdx.x; j < nblk; j += blockDim.x) {
      const int gbx = bi0 + j / kby, gby = bj0 + j % kby;
      if (gbx < nbx && gby < nby) {
        const double cnt = (double)(t1 - t0) * (double)min(bx, H - gbx * bx) *
                           (double)min(by, W - gby * by);
        for (int c = 0; c < nc; ++c) bacc[j * nc + c] /= cnt;
      }
    }
    __syncthreads();
    // statistics of the block-mean rows: warps own statistics, lanes stride blocks
    for (int jv = lane; jv < nvalid; jv += 32) {
      const double* row = bacc + ((jv / vkby) * kby + jv % vkby) * nc;
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        if (sa[m] < 0) continue;  // warp-uniform
        acc[m] += row[sa[m]] * (sb[m] == kOneColumn ? 1.0 : row[sb[m]]);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nc * nblk; i += blockDim.x) bacc[i] = 0.0;
    __syncthreads();
  }
  const int cta = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  write_slots_row(acc, spec.n_stats, partials + (long long)cta * spec.n_stats);
}

inline size_t blockwise_terms_smem_bytes(int TH, int TW, int bx, int by, int p) {
  const size_t n_float = stencil_smem_floats(TH, TW);
  return (n_float + (n_float & 1)) * sizeof(float) +
         (size_t)(p + 1) * (TH / bx) * (TW / by) * sizeof(double);
}

}  // namespace pdx

// Shared memory one CTA needs for a TH x TW tile of (bx, by) blocks and p
// terms; the wrapper checks it against the card's per-block limit.
extern "C" long long pdx_fused_blockwise_terms_smem_bytes(int TH, int TW, int bx, int by,
                                                          int p) {
  return (long long)pdx::blockwise_terms_smem_bytes(TH, TW, bx, by, p);
}

// C interface (bound with ctypes). codes: p indices into RICH_TERM_NAMES
// (host memory, copied here into the kernel's by-value TermSpec). partials
// holds grid_x*grid_y*grid_z rows of S doubles; out receives the S
// statistics. Returns a cudaError_t (cudaErrorInvalidValue for a bad list).
extern "C" int pdx_fused_blockwise_gram_terms(const float* U, const float* Ut, int T, int H,
                                              int W, int bt, int bx, int by, int TH, int TW,
                                              int tblocks_per_cta, int grid_x, int grid_y,
                                              int grid_z, float dx2, float dy2, float two_dx,
                                              float two_dy, const int* codes, int p,
                                              double* partials, double* out, void* stream) {
  pdx::TermSpec spec;
  if (!pdx::make_term_spec(codes, p, &spec)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = pdx::blockwise_terms_smem_bytes(TH, TW, bx, by, p);
  cudaError_t err = cudaFuncSetAttribute(pdx::fused_blockwise_gram_terms_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const pdx::Stencil s{dx2, dy2, two_dx, two_dy};
  pdx::fused_blockwise_gram_terms_kernel<<<dim3(grid_x, grid_y, grid_z), pdx::kThreads,
                                           smem, st>>>(U, Ut, T, H, W, bt, bx, by, TH, TW,
                                                       tblocks_per_cta, s, spec, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pdx::reduce_rows_kernel<<<spec.n_stats, pdx::kThreads, 0, st>>>(
      partials, grid_x * grid_y * grid_z, spec.n_stats, out);
  return (int)cudaGetLastError();
}
