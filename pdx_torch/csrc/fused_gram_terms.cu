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
// the main path's (1999, 100, 100) float32 shape, 0.048 ms at 3.35 TB/s).
// At p = 9 the statistics need 45 float64 FMAs and 9 adds per sample (the
// entries with `one` are sx, n and sy and need no product): 2.0 GFLOP,
// 0.030 ms at the H100's 67 TFLOP/s FP64 through the tensor cores, 0.058 ms
// at its 34 TFLOP/s outside them.
//
// Design. The frame of work is K1's: a CTA owns a TH x TW tile and a chunk
// of frames, stages a (TH+4) x (TW+4) patch of u wrapped mod H and mod W,
// and forms the Laplacian ring in shared memory. Holding all S float64 sums
// in every thread, as K1 does with its 14, would cost 130 registers at p = 9
// and spill. Instead, per frame, the CTA writes the p float32 term fields
// and u_t of its valid tile points into shared memory (columns of TH*TW
// floats), and each warp owns a fixed subset of the statistics (at most
// kSlots = 9), its lanes striding over the tile's points. At the end each
// owned statistic is shuffle-reduced in a fixed order into the CTA's row of
// S partial sums; reduce_rows_kernel sums the rows in an order fixed by the
// shape. No float atomics: two launches give the same bits.
//
// The TPU wrapper zero-pads T and corrects <one, one> and sx[one] in closed
// form; here a CTA loops over its real frames and points only, so
// <one, one> comes out as exactly T*H*W.
#include "gram_common.cuh"

namespace pdx {

// grid = (tiles along H, tiles along W, frame chunks); block = kThreads.
__global__ void fused_ks_gram_terms_kernel(const float* __restrict__ U,
                                           const float* __restrict__ Ut, int T, int H,
                                           int W, int TH, int TW, int frames_per_cta,
                                           Stencil s, TermSpec spec,
                                           double* __restrict__ partials) {
  extern __shared__ float smem[];
  float* su = smem;
  float* sl = su + (TH + 4) * (TW + 4);
  float* cols = sl + (TH + 2) * (TW + 2);  // (p + 1) columns of TH*TW; column p = u_t
  const int x0 = blockIdx.x * TH, y0 = blockIdx.y * TW;
  const int vh = min(TH, H - x0), vw = min(TW, W - y0), npt = vh * vw;
  const int stride = TH * TW, p = spec.p;
  const int t_begin = blockIdx.z * frames_per_cta;
  const int t_end = min(T, t_begin + frames_per_cta);
  const long long frame = (long long)H * W;
  const int lane = threadIdx.x & 31;

  int sa[kSlots], sb[kSlots];
  double acc[kSlots];
  warp_slots(spec, sa, sb);
#pragma unroll
  for (int m = 0; m < kSlots; ++m) acc[m] = 0.0;

  for (int t = t_begin; t < t_end; ++t) {
    load_patch(U + t * frame, H, W, x0, y0, TH, TW, su);
    __syncthreads();
    patch_laplacian(su, TH, TW, s, sl);
    __syncthreads();
    // the tile's fields; only points inside the frame are written
    const float* ut = Ut + t * frame;
    for (int i = threadIdx.x; i < npt; i += blockDim.x) {
      const int r = i / vw, c = i - r * vw;
      const PointFields f = point_fields(su, sl, TW, r, c, s);
      for (int j = 0; j < p; ++j) cols[j * stride + i] = term_value(spec.code[j], f);
      cols[p * stride + i] = ut[(long long)(x0 + r) * W + (y0 + c)];
    }
    __syncthreads();
    for (int i = lane; i < npt; i += 32) {
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        if (sa[m] < 0) continue;  // warp-uniform
        const double va = cols[sa[m] * stride + i];
        const double vb = sb[m] == kOneColumn ? 1.0 : (double)cols[sb[m] * stride + i];
        acc[m] += va * vb;
      }
    }
    __syncthreads();  // the next frame overwrites su / sl / cols
  }
  const int cta = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  write_slots_row(acc, spec.n_stats, partials + (long long)cta * spec.n_stats);
}

inline size_t terms_smem_bytes(int TH, int TW, int p) {
  return (stencil_smem_floats(TH, TW) + (size_t)(p + 1) * TH * TW) * sizeof(float);
}

}  // namespace pdx

// Shared memory one CTA needs for a TH x TW tile and p terms; the wrapper
// checks it against the card's per-block limit before launching.
extern "C" long long pdx_fused_ks_gram_terms_smem_bytes(int TH, int TW, int p) {
  return (long long)pdx::terms_smem_bytes(TH, TW, p);
}

// C interface (bound with ctypes). codes: p indices into RICH_TERM_NAMES
// (host memory, copied here into the kernel's by-value TermSpec). partials
// holds grid_x*grid_y*grid_z rows of S doubles; out receives the S
// statistics. Returns a cudaError_t (cudaErrorInvalidValue for a bad list).
extern "C" int pdx_fused_ks_gram_terms(const float* U, const float* Ut, int T, int H, int W,
                                       int TH, int TW, int frames_per_cta, int grid_x,
                                       int grid_y, int grid_z, float dx2, float dy2,
                                       float two_dx, float two_dy, const int* codes, int p,
                                       double* partials, double* out, void* stream) {
  pdx::TermSpec spec;
  if (!pdx::make_term_spec(codes, p, &spec)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = pdx::terms_smem_bytes(TH, TW, p);
  cudaError_t err = cudaFuncSetAttribute(pdx::fused_ks_gram_terms_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const pdx::Stencil s{dx2, dy2, two_dx, two_dy};
  pdx::fused_ks_gram_terms_kernel<<<dim3(grid_x, grid_y, grid_z), pdx::kThreads, smem, st>>>(
      U, Ut, T, H, W, TH, TW, frames_per_cta, s, spec, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pdx::reduce_rows_kernel<<<spec.n_stats, pdx::kThreads, 0, st>>>(
      partials, grid_x * grid_y * grid_z, spec.n_stats, out);
  return (int)cudaGetLastError();
}
