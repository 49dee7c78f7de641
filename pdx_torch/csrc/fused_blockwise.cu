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
// (~160 MB at the main path's (1999, 100, 100) float32 shape, 0.048 ms at
// 3.35 TB/s; float64 input is read directly) and computes little per byte.
// The TPU kernel summed blocks with selector GEMMs (Px @ ts @ Py) only to
// work around a Mosaic reshape limit; here each spatial block is summed
// directly.
//
// Design (band_common.cuh). A CTA owns a band of kb whole block-rows at
// full frame width and a run of whole temporal blocks, so every block's
// bt x bx x by sum completes inside one CTA and the ragged tails are exact
// with no padding. Frames are staged as in K1 (bulk asynchronous copies of
// the band's contiguous runs, the element-wise route, or float64 rounded in
// flight where its raw band would not fit). G threads (a
// power of two, G | 32) share a spatial block: thread g owns the block's
// valid points g, g + G, ... for the whole temporal block and sums their
// lap, bih, |grad u|^2 and u_t in four float64 registers, frame after
// frame, points stepped by (row, column) with no division; where G is the
// block's width (8 x 8 blocks) that is a walk down one column with the rows
// above and below in registers. Once per
// temporal block the G threads reduce their sums by a fixed xor-shuffle
// tree and the group's first thread adds the block-mean row's 14 products
// to the group's float64 sums in shared memory (they are touched once a
// temporal block; in registers they crowded the stencil loops into
// spills). At the end the groups' sums are added in group order into the
// CTA's row of 14 partial sums; reduce_rows_kernel sums the rows in an
// order fixed by the shape. No atomics: two launches give the same bits.
#include "band_common.cuh"

namespace pdx {

__host__ __device__ inline size_t group_sums_bytes(int n_groups) {
  return (size_t)n_groups * kStats * sizeof(double);
}

// grid = (bands along H, temporal-block chunks); block = kb * nby * G
// threads rounded up to a warp.
template <typename In, int kRoute>
__global__ void __launch_bounds__(kBandMaxThreads)
fused_blockwise_gram_kernel(const In* __restrict__ U, const In* __restrict__ Ut, int T, int H,
                            int W, int bt, int bx, int by, int kb, int G, int tblocks_per_cta,
                            Stencil s, double* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int TH = kb * bx, x0 = blockIdx.x * TH, th = min(TH, H - x0);
  const int n_groups = blockDim.x / G;
  using Pipe = BandPipe<In, kRoute>;
  const BandLayout L = band_layout(TH, W, Pipe::kStaged64, group_sums_bytes(n_groups));
  double* sums = reinterpret_cast<double*>(smem + L.extra);  // [n_groups][14]
  for (int i = threadIdx.x; i < n_groups * kStats; i += blockDim.x) sums[i] = 0.0;
  const Pipe pipe(smem, L, H, W, x0, th);  // ends with a __syncthreads()
  float* sl = reinterpret_cast<float*>(smem + L.sl);

  const int nby = (W + by - 1) / by, nbt = (T + bt - 1) / bt;
  const int t_begin = blockIdx.y * tblocks_per_cta * bt;
  const int t_end = min(T, min(nbt, (blockIdx.y + 1) * tblocks_per_cta) * bt);
  const long long frame = (long long)H * W;
  const Divisors d = make_divisors(s);

  // this thread's spatial block and its valid points, stepped without `%`
  const int gid = threadIdx.x / G, g = threadIdx.x - gid * G;
  const int bi = gid / nby, bj = gid - bi * nby;
  const int rx0 = bi * bx, cy0 = bj * by;  // the block's origin in the band
  const bool mine = bi < kb && rx0 < th;
  const int vbx = mine ? min(bx, th - rx0) : 0, vby = mine ? min(by, W - cy0) : 0;
  const int nv = vbx * vby;
  const int r_first = nv > 0 ? g / vby : 0, c_first = nv > 0 ? g - r_first * vby : 0;
  const int dr = nv > 0 ? G / vby : 0, dc = nv > 0 ? G - dr * vby : 0;

  double v0 = 0.0, v1 = 0.0, v2 = 0.0, vy = 0.0;  // this thread's sums over its points

  int nf = 0;  // frames of the current temporal block seen so far
  for_band_frames(pipe, U, Ut, frame, t_begin, t_end, [&](const float* su, const In* ut0, int t) {
    band_laplacian(su, th, W, d, sl);
    __syncthreads();  // the ring is complete

    if (dr == 1 && dc == 0) {  // G = the block's width: this thread walks down column g
      band_strip_terms(su, sl, W, rx0, rx0 + vbx, cy0 + g, d,
                       [&](float lap, float bih, float gsq, int i) {
                         v0 += (double)lap;
                         v1 += (double)bih;
                         v2 += (double)gsq;
                         vy += (double)to_f32(ut0[i]);
                       });
    } else {
      const In* ut = ut0 + rx0 * W + cy0;
      int r = r_first, c = c_first;
      for (int q = g; q < nv; q += G) {
        float lap, bih, gsq;
        band_terms(su, sl, W, rx0 + r, cy0 + c, d, lap, bih, gsq);
        v0 += (double)lap;
        v1 += (double)bih;
        v2 += (double)gsq;
        vy += (double)to_f32(ut[r * W + c]);
        r += dr;
        c += dc;
        if (c >= vby) { c -= vby; ++r; }
      }
    }

    if (++nf == bt || t + 1 == t_end) {  // CTA-uniform: the temporal block is complete
      for (int off = G >> 1; off > 0; off >>= 1) {
        v0 += __shfl_xor_sync(0xffffffffu, v0, off);
        v1 += __shfl_xor_sync(0xffffffffu, v1, off);
        v2 += __shfl_xor_sync(0xffffffffu, v2, off);
        vy += __shfl_xor_sync(0xffffffffu, vy, off);
      }
      if (g == 0 && nv > 0) {
        const double cnt = (double)nf * (double)nv;
        accumulate(sums + gid * kStats, v0 / cnt, v1 / cnt, v2 / cnt, vy / cnt);
      }
      v0 = v1 = v2 = vy = 0.0;
      nf = 0;
    }
    __syncthreads();  // the next frame overwrites the ring (and float64's patch)
  });
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x < kStats) {  // the last barrier made every group's sums visible
    double v = 0.0;
    for (int q = 0; q < n_groups; ++q) v += sums[q * kStats + threadIdx.x];
    partials[(long long)cta * kStats + threadIdx.x] = v;
  }
}

inline int blockwise_band_threads(int W, int by, int kb, int G) {
  return (kb * ((W + by - 1) / by) * G + 31) / 32 * 32;
}

inline size_t blockwise_band_smem(int W, int bx, int by, int kb, int G, bool staged64) {
  return band_layout(kb * bx, W, staged64, group_sums_bytes(blockwise_band_threads(W, by, kb, G) / G))
      .total;
}

// Launch an instance (In follows from the kernel's own parameters; staged64:
// its stages hold float64), then the reduction of its rows.
template <typename In>
int launch_blockwise(void (*kernel)(const In*, const In*, int, int, int, int, int, int, int, int,
                                    int, Stencil, double*),
                     bool staged64, const void* U, const void* Ut, int T, int H, int W, int bt, int bx, int by,
                     int kb, int G, int tblocks_per_cta, int n_bands, int n_chunks, Stencil s,
                     double* partials, double* out, cudaStream_t st) {
  const size_t smem = blockwise_band_smem(W, bx, by, kb, G, staged64);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_bands, n_chunks), blockwise_band_threads(W, by, kb, G), smem, st>>>(
      static_cast<const In*>(U), static_cast<const In*>(Ut), T, H, W, bt, bx, by, kb, G,
      tblocks_per_cta, s, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<kStats, kThreads, 0, st>>>(partials, n_bands * n_chunks, kStats, out);
  return (int)cudaGetLastError();
}

// Call f with the kernel instance for (f64, route).
template <typename F>
auto with_blockwise_instance(int f64, int route, F&& f) {
  if (f64 && route == kRounded) return f(fused_blockwise_gram_kernel<double, kRounded>);
  if (f64)
    return route == kBulk ? f(fused_blockwise_gram_kernel<double, kBulk>)
                          : f(fused_blockwise_gram_kernel<double, kElementwise>);
  return route == kBulk ? f(fused_blockwise_gram_kernel<float, kBulk>)
                        : f(fused_blockwise_gram_kernel<float, kElementwise>);
}

}  // namespace pdx

// Shared memory a CTA of K3 needs for a band of kb block-rows of bx rows, G
// threads a block (staged64: the stages hold float64, as for K1).
extern "C" long long pdx_fused_blockwise_smem_bytes(int W, int bx, int by, int kb, int G,
                                                    int staged64) {
  return (long long)pdx::blockwise_band_smem(W, bx, by, kb, G, staged64 != 0);
}

// Registers a thread and resident CTAs per SM of the instance at this
// launch shape (a band of kb block-rows of bx rows, G threads a block).
extern "C" int pdx_fused_blockwise_occupancy(int W, int bx, int by, int kb, int G, int f64,
                                             int route, int* regs, int* ctas) {
  const size_t smem = pdx::blockwise_band_smem(W, bx, by, kb, G, f64 && route != pdx::kRounded);
  const int threads = pdx::blockwise_band_threads(W, by, kb, G);
  return pdx::with_blockwise_instance(f64, route, [&](auto* kernel) {
    return pdx::kernel_occupancy(kernel, threads, smem, regs, ctas);
  });
}

// C interface (bound with ctypes). U and Ut: contiguous (T, H, W), float64
// if f64 else float32. route: as for K1. A band is kb block-rows of bx rows,
// n_bands * kb * bx >= H; G threads (a power of two <= 32) share a block,
// kb * ceil(W / by) * G <= 768 threads; chunks of tblocks_per_cta temporal
// blocks of bt frames. partials holds n_bands * n_chunks rows of 14
// doubles; out receives the 14 statistics. Returns a cudaError_t
// (cudaErrorInvalidValue for a launch shape the kernel does not take).
extern "C" int pdx_fused_blockwise_gram(const void* U, const void* Ut, int f64, int route, int T,
                                        int H, int W, int bt, int bx, int by, int kb, int G,
                                        int tblocks_per_cta, int n_bands, int n_chunks, float dx2,
                                        float dy2, float two_dx, float two_dy, double* partials,
                                        double* out, void* stream) {
  const size_t item = f64 ? 8 : 4;
  if (bt < 1 || bx < 1 || by < 1 || kb < 1 || G < 1 || G > 32 || (G & (G - 1)))
    return (int)cudaErrorInvalidValue;
  const long long TH = (long long)kb * bx, nbt = (T + bt - 1) / bt;
  if (pdx::blockwise_band_threads(W, by, kb, G) > pdx::kBandMaxThreads || n_bands * TH < H ||
      (n_bands - 1) * TH >= H || (long long)n_chunks * tblocks_per_cta < nbt)
    return (int)cudaErrorInvalidValue;
  if (route < 0 || route > pdx::kRounded || (route == pdx::kRounded && !f64))
    return (int)cudaErrorInvalidValue;
  if (route == pdx::kBulk && (((size_t)U | (size_t)Ut) % 16 || (W * item) % 16))
    return (int)cudaErrorInvalidValue;
  const pdx::Stencil s{dx2, dy2, two_dx, two_dy};
  return pdx::with_blockwise_instance(f64, route, [&](auto* kernel) {
    return pdx::launch_blockwise(kernel, f64 && route != pdx::kRounded, U, Ut, T, H, W, bt, bx, by, kb, G, tblocks_per_cta,
                                 n_bands, n_chunks, s, partials, out,
                                 static_cast<cudaStream_t>(stream));
  });
}
