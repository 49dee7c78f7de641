// K2 — fused KS dictionary + Gram statistics for any term list, full field.
//
// Replaces the TPU kernel pdx/ops/pallas/fused_gram.py::fused_ks_gram_terms
// (pallas_call at :216, kernel body _kernel_terms at :150, fields
// _term_fields at :115): the S = p(p+1)/2 + 2p + 2 sufficient statistics of
// any 1..9 terms of the rich KS vocabulary (1, u, u^2, u_x, u_y, lap, bih,
// |grad u|^2, u*lap) against u_t over every (t, x, y) sample, n = T*H*W,
// without materialising the (p, T, H, W) term stack.
//
// What bounds it on the card: memory. It reads U and Ut once (~160 MB at
// the main path's (1999, 100, 100) float32 shape, 0.048 ms at 3.35 TB/s;
// twice that for float64 input, which it reads directly). At p = 9 the
// statistics need 45 float64 FMAs and 9 adds per sample: 2.0 GFLOP, 0.030 ms
// at the H100's 67 TFLOP/s FP64 through the tensor cores.
//
// Design. A CTA owns a TH x TW tile (at most 50 x 50) and a chunk of frames.
// Frame pipeline (terms_common.cuh): the periodic patch is staged by
// cp.async from precomputed wrapped offsets, double-buffered, so frame t+1
// loads while the CTA works on frame t; two __syncthreads() a frame; no `%`
// and no division in the frame loop (stencil divisions by a constant in
// three instructions). The statistics are entries of X~^T X~ with X~ =
// [the p terms, u_t, 1], computed on the FP64 tensor cores (mma.sync
// m16n8k4 .f64, the shape that runs at the card's full FP64 rate; m8n8k4
// runs at half): each warp takes batches of 32 tile points; each lane
// computes one point's fields and writes the fixed columns [u, u^2, u_x,
// u_y, lap, bih, |grad u|^2, u*lap, u_t, 1] (float32) into the warp's
// column-major buffer, with no per-term selection; the batch's 8 chunks of
// 4 samples then take one mma each (C <= 8, two accumulators to split the
// dependency chain) or two (C <= 16), each lane reading, through a column
// map fixed per CTA, the two X~ columns it feeds, each value converted to
// float64 once. Samples past the tile's points are zero rows, so <one, one>
// = T*H*W exactly. At the end the warps' fragments are summed in warp order
// into the CTA's row of S partial sums; reduce_rows_kernel sums the rows in
// an order fixed by the shape. No float atomics: two launches give the
// same bits.
//
// Measured (tools/terms_kernel_ablation.py, PERF.md): the mma are the
// largest part at p = 9 (two a chunk; the tensor pipe's floor alone is
// ~0.16 ms), then the per-point fields, stores and loads; the frame copies
// are hidden behind the work.
#include "terms_common.cuh"

namespace pdx {

constexpr int kTermsMinCtas = 3;  // resident CTAs per SM the registers are capped for
constexpr int kBatchStride = 36;  // sample_stride(32): a batch's column stride
constexpr int kBatchFloats = kStored * kBatchStride;

// grid = (tiles along H, tiles along W, frame chunks); block = kThreads.
// kTwo: X~ has more than 8 columns (p > 6), two mma a chunk.
template <typename In, bool kTwo>
__global__ void __launch_bounds__(kThreads, kTermsMinCtas)
fused_ks_gram_terms_kernel(const In* __restrict__ U, const In* __restrict__ Ut, int T, int H,
                           int W, int TH, int TW, int frames_per_cta, Stencil s,
                           TermSpec spec, double* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int x0 = blockIdx.x * TH, y0 = blockIdx.y * TW;
  const PipeLayout L = pipe_layout(TH, TW, 0, sizeof(In) == 8, 0);
  const FramePipe<In> pipe(smem, L, TH, TileSpan{TW, W, 0, 0, 0});
  float* sl = reinterpret_cast<float*>(smem + L.sl);
  float* xbuf = reinterpret_cast<float*>(smem + L.extra);  // [warp][kStored][kBatchStride]

  const int vh = min(TH, H - x0), vw = min(TW, W - y0), npt = vh * vw;
  const int t_begin = blockIdx.z * frames_per_cta;
  const int t_end = min(T, t_begin + frames_per_cta);
  const long long frame = (long long)H * W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  float* wb = xbuf + warp * kBatchFloats;
  const LaneColumns lc = lane_columns(spec, kBatchStride);
  const Divisors d = make_divisors(s);

  double acc[2][4] = {{0.0, 0.0, 0.0, 0.0}, {0.0, 0.0, 0.0, 0.0}};
  build_offsets(H, W, x0, y0, TH, TW, reinterpret_cast<int*>(smem + L.goff));
  // this lane's point in the warp's first batch; later batches step by
  // (dr, dc) without a division
  const int step = nwarp * 32, dr = step / vw, dc = step - dr * vw;
  const int r_first = (warp * 32 + lane) / vw, c_first = warp * 32 + lane - r_first * vw;
  __syncthreads();
  if (t_begin < t_end) {
    pipe.issue(U + t_begin * frame, nullptr, 0);
    pipe.land(0);
  }
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int cur = (t - t_begin) & 1;
    const float* su = pipe.patch(cur);
    ring_laplacian(su, TH, TW, d, sl);
    __syncthreads();  // the ring is complete; the other buffer is free
    const bool more = t + 1 < t_end;
    if (more) pipe.issue(U + (t + 1) * frame, nullptr, cur ^ 1);

    const In* ut = Ut + t * frame + (long long)x0 * W + y0;
    int r = r_first, c = c_first;
    for (int b0 = warp * 32; b0 < npt; b0 += step) {
      float v[kStored];
      if (b0 + lane < npt) {
        const float y = to_f32(ut[(long long)r * W + c]);
        stored_values(point_fields(su, sl, TW, r, c, d), y, v);
      } else {  // zero rows past the tile's points
#pragma unroll
        for (int m = 0; m < kStored; ++m) v[m] = 0.0f;
      }
#pragma unroll
      for (int m = 0; m < kStored; ++m) wb[m * kBatchStride + lane] = v[m];
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 8; k += 2) {
        gram_chunk<kTwo, 0>(wb, lc, k, acc);
        gram_chunk<kTwo, 1>(wb, lc, k + 1, acc);
      }
      __syncwarp();  // the next batch overwrites wb
      r += dr;
      c += dc;
      if (c >= vw) { c -= vw; ++r; }
    }

    if (more) pipe.land(cur ^ 1);
    __syncthreads();  // the next patch is in place; sl and this patch are free
  }
  if constexpr (!kTwo) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[0][i] += acc[1][i];
  }
  double* red = reinterpret_cast<double*>(xbuf);
  store_fragments(acc, red);
  __syncthreads();
  const int cta = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  write_gram_row(nwarp, spec, red, partials + (long long)cta * spec.n_stats);
}

inline PipeLayout terms_layout(int TH, int TW, bool f64) {
  const size_t batches = (size_t)kWarps * kBatchFloats * sizeof(float);
  const size_t red = (size_t)kWarps * 256 * sizeof(double);
  return pipe_layout(TH, TW, 0, f64, batches > red ? batches : red);
}

template <typename In, bool kTwo>
int launch_terms(const In* U, const In* Ut, int T, int H, int W, int TH, int TW,
                 int frames_per_cta, int grid_x, int grid_y, int grid_z, Stencil s,
                 const TermSpec& spec, double* partials, double* out, cudaStream_t st) {
  const size_t smem = terms_layout(TH, TW, sizeof(In) == 8).total;
  cudaError_t err = cudaFuncSetAttribute(fused_ks_gram_terms_kernel<In, kTwo>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_ks_gram_terms_kernel<In, kTwo><<<dim3(grid_x, grid_y, grid_z), kThreads, smem, st>>>(
      U, Ut, T, H, W, TH, TW, frames_per_cta, s, spec, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<spec.n_stats, kThreads, 0, st>>>(partials, grid_x * grid_y * grid_z,
                                                         spec.n_stats, out);
  return (int)cudaGetLastError();
}

template <typename In>
int launch_terms(const In* U, const In* Ut, int T, int H, int W, int TH, int TW,
                 int frames_per_cta, int grid_x, int grid_y, int grid_z, Stencil s,
                 const TermSpec& spec, double* partials, double* out, cudaStream_t st) {
  return spec.p + 2 > 8
             ? launch_terms<In, true>(U, Ut, T, H, W, TH, TW, frames_per_cta, grid_x, grid_y,
                                      grid_z, s, spec, partials, out, st)
             : launch_terms<In, false>(U, Ut, T, H, W, TH, TW, frames_per_cta, grid_x, grid_y,
                                       grid_z, s, spec, partials, out, st);
}

}  // namespace pdx

// Shared memory one CTA needs for a TH x TW tile (f64: float64 input); the
// wrapper checks it against the card's per-block limit before launching.
extern "C" long long pdx_fused_ks_gram_terms_smem_bytes(int TH, int TW, int f64) {
  return (long long)pdx::terms_layout(TH, TW, f64 != 0).total;
}

// Registers a thread and resident CTAs per SM of the kernel at this tile
// (the instance for p terms).
extern "C" int pdx_fused_ks_gram_terms_occupancy(int TH, int TW, int f64, int p, int* regs,
                                                 int* ctas) {
  const size_t smem = pdx::terms_layout(TH, TW, f64 != 0).total;
  const int n = pdx::kThreads;
  if (p + 2 > 8)
    return f64 ? pdx::kernel_occupancy(pdx::fused_ks_gram_terms_kernel<double, true>, n, smem,
                                       regs, ctas)
               : pdx::kernel_occupancy(pdx::fused_ks_gram_terms_kernel<float, true>, n, smem,
                                       regs, ctas);
  return f64 ? pdx::kernel_occupancy(pdx::fused_ks_gram_terms_kernel<double, false>, n, smem,
                                     regs, ctas)
             : pdx::kernel_occupancy(pdx::fused_ks_gram_terms_kernel<float, false>, n, smem,
                                     regs, ctas);
}

// C interface (bound with ctypes). U and Ut: contiguous (T, H, W), float64
// if f64 else float32. codes: p indices into RICH_TERM_NAMES (host memory,
// copied here into the kernel's by-value TermSpec). partials holds
// grid_x*grid_y*grid_z rows of S doubles; out receives the S statistics.
// Returns a cudaError_t (cudaErrorInvalidValue for a bad list).
extern "C" int pdx_fused_ks_gram_terms(const void* U, const void* Ut, int f64, int T, int H,
                                       int W, int TH, int TW, int frames_per_cta, int grid_x,
                                       int grid_y, int grid_z, float dx2, float dy2,
                                       float two_dx, float two_dy, const int* codes, int p,
                                       double* partials, double* out, void* stream) {
  pdx::TermSpec spec;
  if (!pdx::make_term_spec(codes, p, &spec)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const pdx::Stencil s{dx2, dy2, two_dx, two_dy};
  if (f64)
    return pdx::launch_terms(static_cast<const double*>(U), static_cast<const double*>(Ut), T,
                             H, W, TH, TW, frames_per_cta, grid_x, grid_y, grid_z, s, spec,
                             partials, out, st);
  return pdx::launch_terms(static_cast<const float*>(U), static_cast<const float*>(Ut), T, H, W,
                           TH, TW, frames_per_cta, grid_x, grid_y, grid_z, s, spec, partials,
                           out, st);
}
