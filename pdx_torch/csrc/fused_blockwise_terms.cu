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
// the main path's (1999, 100, 100) float32 shape, 0.048 ms at 3.35 TB/s;
// twice that for float64 input, which it reads directly); the block sums
// are p + 1 float64 adds a sample and the Gram of the ~0.1 M block rows is
// small. It is a stencil plus a segmented reduction.
//
// Design. A CTA's tile is kbx x kby whole (bx, by) blocks (the wrapper picks
// kbx, kby so that the ragged edge wastes little) and the CTA owns whole
// temporal blocks, so every block sum completes inside one CTA. G threads
// (a power of two, G | 32) share a spatial block: thread g owns the block's
// valid points g, g + G, ... for the whole temporal block and sums the
// fixed columns [u, u^2, u_x, u_y, lap, bih, |grad u|^2, u*lap, u_t] of
// those points in nine float64 registers, frame after frame, with no
// per-term selection and no division (points stepped by (row, column)).
// Once per temporal block the G threads reduce their sums by a fixed
// xor-shuffle tree and the block's first thread writes its mean row to
// shared memory, beside a column of ones for the blocks inside the frame;
// then every warp adds its share of the block-mean rows to its Gram on the
// FP64 tensor cores (K2's mma.sync m16n8k4 .f64 and column map), keeping
// its fragments in shared memory between temporal blocks, and the warps'
// fragments are summed in warp order at the end. Frame pipeline as K2's,
// with the tile's u_t staged by cp.async beside the patch: two
// __syncthreads() a frame. No atomics; two launches give the same bits.
// The block mean of `one` is exactly 1, ragged tails included (pdx masks
// padded frames at :121-127 for the same result; here there is no padding).
//
// Measured (tools/terms_kernel_ablation.py, PERF.md): the point loop takes
// the most time, then issuing the patch's 4-byte cp.async copies and the
// ring; waiting for the copies costs little.
#include "terms_common.cuh"

namespace pdx {

// grid = (tiles along H, tiles along W, temporal-block chunks);
// block = kbx * kby * G threads rounded up to a warp, at most kThreads.
template <typename In>
__global__ void __launch_bounds__(kThreads, 3)
fused_blockwise_gram_terms_kernel(const In* __restrict__ U, const In* __restrict__ Ut, int T,
                                  int H, int W, int bt, int bx, int by, int kbx, int kby,
                                  int G, int tblocks_per_cta, Stencil s, TermSpec spec,
                                  double* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TH = kbx * bx, TW = kby * by, nblk = kbx * kby, rs = sample_stride(nblk);
  const int x0 = blockIdx.x * TH, y0 = blockIdx.y * TW;
  const PipeLayout L = pipe_layout(TH, TW, TH * TW, sizeof(In) == 8, 0);
  const FramePipe<In> pipe(
      smem, L, TH, TileSpan{TW, W, min(TH, H - x0), min(TW, W - y0), x0 * W + y0});
  float* sl = reinterpret_cast<float*>(smem + L.sl);
  double* brow = reinterpret_cast<double*>(smem + L.extra);  // [kStored][rs] block-mean rows
  double* red = brow + kStored * rs;  // the warps' fragments between temporal blocks

  const int nbt = (T + bt - 1) / bt;
  const int t_begin = blockIdx.z * tblocks_per_cta * bt;
  const int t_end = min(T, min(nbt, (blockIdx.z + 1) * tblocks_per_cta) * bt);
  const long long frame = (long long)H * W;
  const int warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  // the tile's blocks inside the frame: a vkbx x vkby corner, whose rows
  // are the first nvalid of brow
  const int vkbx = min(kbx, (H + bx - 1) / bx - blockIdx.x * kbx);
  const int vkby = min(kby, (W + by - 1) / by - blockIdx.y * kby), nvalid = vkbx * vkby;

  // this thread's spatial block and its valid points, stepped without `%`
  const int gid = threadIdx.x / G, g = threadIdx.x - gid * G;
  const int bi = gid / kby, bj = gid - bi * kby;
  const int rx0 = bi * bx, cy0 = bj * by;  // the block's origin in the tile
  const bool mine = gid < nblk && bi < vkbx && bj < vkby;
  const int row = bi * vkby + bj;
  const int vbx = mine ? min(bx, H - x0 - rx0) : 0, vby = mine ? min(by, W - y0 - cy0) : 0;
  const int nv = vbx * vby;
  const int r_first = nv > 0 ? g / vby : 0, c_first = nv > 0 ? g - r_first * vby : 0;
  const int dr = nv > 0 ? G / vby : 0, dc = nv > 0 ? G - dr * vby : 0;
  const LaneColumns lc = lane_columns(spec, rs);
  const Divisors d = make_divisors(s);

  constexpr int kSums = kStored - 1;  // the fields and u_t; column 9 is the constant
  double v[kSums];  // this thread's sums over its points
#pragma unroll
  for (int m = 0; m < kSums; ++m) v[m] = 0.0;

  build_offsets(H, W, x0, y0, TH, TW, reinterpret_cast<int*>(smem + L.goff));
  for (int i = threadIdx.x; i < kStored * rs + nwarp * 256; i += blockDim.x)
    brow[i] = i >= kOneColumn * rs && i < kOneColumn * rs + nvalid ? 1.0 : 0.0;
  __syncthreads();
  if (t_begin < t_end) {
    pipe.issue(U + t_begin * frame, Ut + t_begin * frame, 0);
    pipe.land(0);
  }
  __syncthreads();

  int nf = 0;  // frames of the current temporal block seen so far
  for (int t = t_begin; t < t_end; ++t) {
    const int cur = (t - t_begin) & 1;
    const float* su = pipe.patch(cur);
    const float* st = pipe.tile(cur) + rx0 * TW + cy0;
    ring_laplacian(su, TH, TW, d, sl);
    __syncthreads();  // the ring is complete; the other buffers are free
    const bool more = t + 1 < t_end;
    if (more) pipe.issue(U + (t + 1) * frame, Ut + (t + 1) * frame, cur ^ 1);

    int r = r_first, c = c_first;
    for (int q = g; q < nv; q += G) {
      float f[kStored];
      stored_values(point_fields(su, sl, TW, rx0 + r, cy0 + c, d), st[r * TW + c], f);
#pragma unroll
      for (int m = 0; m < kSums; ++m) v[m] += (double)f[m];
      r += dr;
      c += dc;
      if (c >= vby) { c -= vby; ++r; }
    }

    const bool block_done = ++nf == bt || !more;
    if (block_done) {  // CTA-uniform
#pragma unroll
      for (int m = 0; m < kSums; ++m)
        for (int off = G >> 1; off > 0; off >>= 1)
          v[m] += __shfl_xor_sync(0xffffffffu, v[m], off);
      if (g == 0 && nv > 0) {
        const double inv = 1.0 / ((double)nf * (double)nv);  // one division a block
#pragma unroll
        for (int m = 0; m < kSums; ++m) brow[m * rs + row] = v[m] * inv;
      }
#pragma unroll
      for (int m = 0; m < kSums; ++m) v[m] = 0.0;
    }

    if (more) pipe.land(cur ^ 1);
    __syncthreads();  // the next frame and the block-mean rows are in place
    if (block_done) {  // each warp adds its chunks of the block-mean rows
      double acc[2][4];
      load_fragments(red, acc);
      if (spec.p + 2 > 8) {
        for (int k = warp; 4 * k < nvalid; k += nwarp) gram_chunk<true>(brow, lc, k, acc);
      } else {
        for (int k = warp; 4 * k < nvalid; k += nwarp) gram_chunk<false>(brow, lc, k, acc);
      }
      store_fragments(acc, red);
      nf = 0;
    }
  }
  __syncthreads();
  const int cta = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  write_gram_row(nwarp, spec, red, partials + (long long)cta * spec.n_stats);
}

inline int blockwise_threads(int kbx, int kby, int G) { return (kbx * kby * G + 31) / 32 * 32; }

inline PipeLayout blockwise_terms_layout(int kbx, int kby, int bx, int by, int G, bool f64) {
  const size_t rows = (size_t)kStored * sample_stride(kbx * kby) * sizeof(double);
  const size_t red = (size_t)(blockwise_threads(kbx, kby, G) / 32) * 256 * sizeof(double);
  return pipe_layout(kbx * bx, kby * by, kbx * bx * kby * by, f64, rows + red);
}

template <typename In>
int launch_blockwise_terms(const In* U, const In* Ut, int T, int H, int W, int bt, int bx, int by,
                           int kbx, int kby, int G, int tblocks_per_cta, int grid_x, int grid_y,
                           int grid_z, Stencil s, const TermSpec& spec, double* partials,
                           double* out, cudaStream_t st) {
  const size_t smem = blockwise_terms_layout(kbx, kby, bx, by, G, sizeof(In) == 8).total;
  cudaError_t err = cudaFuncSetAttribute(fused_blockwise_gram_terms_kernel<In>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_blockwise_gram_terms_kernel<In>
      <<<dim3(grid_x, grid_y, grid_z), blockwise_threads(kbx, kby, G), smem, st>>>(
          U, Ut, T, H, W, bt, bx, by, kbx, kby, G, tblocks_per_cta, s, spec, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<spec.n_stats, kThreads, 0, st>>>(partials, grid_x * grid_y * grid_z,
                                                         spec.n_stats, out);
  return (int)cudaGetLastError();
}

}  // namespace pdx

// Shared memory one CTA needs for a tile of kbx x kby (bx, by) blocks, G
// threads a block (f64:
// float64 input); the wrapper checks it against the card's per-block limit.
extern "C" long long pdx_fused_blockwise_terms_smem_bytes(int kbx, int kby, int bx, int by,
                                                          int G, int f64) {
  return (long long)pdx::blockwise_terms_layout(kbx, kby, bx, by, G, f64 != 0).total;
}

// Registers a thread and resident CTAs per SM of the kernel at this launch shape.
extern "C" int pdx_fused_blockwise_terms_occupancy(int kbx, int kby, int bx, int by, int G,
                                                   int f64, int* regs, int* ctas) {
  const size_t smem = pdx::blockwise_terms_layout(kbx, kby, bx, by, G, f64 != 0).total;
  const int threads = pdx::blockwise_threads(kbx, kby, G);
  return f64 ? pdx::kernel_occupancy(pdx::fused_blockwise_gram_terms_kernel<double>, threads,
                                     smem, regs, ctas)
             : pdx::kernel_occupancy(pdx::fused_blockwise_gram_terms_kernel<float>, threads,
                                     smem, regs, ctas);
}

// C interface (bound with ctypes). U and Ut: contiguous (T, H, W), float64
// if f64 else float32. The tile is kbx x kby blocks of bx x by points, G
// threads (a power of two <= 32) to a block, kbx * kby * G <= 256. codes: p
// indices into RICH_TERM_NAMES (host memory, copied here into the kernel's
// by-value TermSpec). partials holds grid_x*grid_y*grid_z rows of S doubles;
// out receives the S statistics. Returns a cudaError_t
// (cudaErrorInvalidValue for a bad list or launch shape).
extern "C" int pdx_fused_blockwise_gram_terms(const void* U, const void* Ut, int f64, int T,
                                              int H, int W, int bt, int bx, int by, int kbx,
                                              int kby, int G, int tblocks_per_cta, int grid_x,
                                              int grid_y, int grid_z, float dx2, float dy2,
                                              float two_dx, float two_dy, const int* codes,
                                              int p, double* partials, double* out,
                                              void* stream) {
  pdx::TermSpec spec;
  if (!pdx::make_term_spec(codes, p, &spec)) return (int)cudaErrorInvalidValue;
  if (G < 1 || G > 32 || (G & (G - 1)) || kbx * kby * G > pdx::kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const pdx::Stencil s{dx2, dy2, two_dx, two_dy};
  if (f64)
    return pdx::launch_blockwise_terms(static_cast<const double*>(U),
                                       static_cast<const double*>(Ut), T, H, W, bt, bx, by, kbx,
                                       kby, G, tblocks_per_cta, grid_x, grid_y, grid_z, s, spec,
                                       partials, out, st);
  return pdx::launch_blockwise_terms(static_cast<const float*>(U), static_cast<const float*>(Ut),
                                     T, H, W, bt, bx, by, kbx, kby, G, tblocks_per_cta, grid_x,
                                     grid_y, grid_z, s, spec, partials, out, st);
}
