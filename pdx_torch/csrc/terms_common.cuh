// Shared pieces of the term-list kernels K2 (fused_gram_terms.cu) and K4
// (fused_blockwise_terms.cu): the term list, the frame pipeline that stages
// a periodic patch with cp.async, and the float64 Gram on the FP64 tensor
// cores (mma.sync m16n8k4 .f64).
//
// Term list: any 1..9 terms of the rich KS vocabulary, in the order of
// pdx_torch.ops.kernels.fused_gram.RICH_TERM_NAMES:
//   0 one  1 u  2 u^2  3 u_x  4 u_y  5 lap  6 bih  7 |grad u|^2  8 u*lap
// A sample is the row X~ = [the p terms, u_t, 1] (C = p + 2 <= 11 columns).
// For p terms there are S = p(p+1)/2 + 2p + 2 statistics, in the order of
// pdx's _kernel_terms: the Gram upper triangle row-major (i <= j), b_i, sx_i,
// sy, syy. Every one of them is an entry (a, b), a <= b, of X~^T X~: column
// p is u_t, column p + 1 the constant 1.
#pragma once

#include <cuda_runtime.h>

#include "gram_common.cuh"

namespace pdx {

constexpr int kMaxTerms = 9;
constexpr int kMaxTermStats = kMaxTerms * (kMaxTerms + 1) / 2 + 2 * kMaxTerms + 2;  // 65
constexpr int kWarps = kThreads / 32;

struct TermSpec {
  int p, n_stats;
  signed char code[kMaxTerms];
  signed char sa[kMaxTermStats], sb[kMaxTermStats];
};

// Build the statistic table of a term list; false if the list is invalid.
inline bool make_term_spec(const int* codes, int p, TermSpec* spec) {
  if (p < 1 || p > kMaxTerms) return false;
  spec->p = p;
  for (int i = 0; i < p; ++i) {
    if (codes[i] < 0 || codes[i] > 8) return false;
    spec->code[i] = (signed char)codes[i];
  }
  const int ut = p, one = p + 1;
  int k = 0;
  for (int i = 0; i < p; ++i)
    for (int j = i; j < p; ++j) { spec->sa[k] = i; spec->sb[k] = j; ++k; }
  for (int i = 0; i < p; ++i) { spec->sa[k] = i; spec->sb[k] = ut; ++k; }
  for (int i = 0; i < p; ++i) { spec->sa[k] = i; spec->sb[k] = one; ++k; }
  spec->sa[k] = ut; spec->sb[k] = one; ++k;
  spec->sa[k] = ut; spec->sb[k] = ut; ++k;
  spec->n_stats = k;
  return true;
}

// The stencil's divisors and their reciprocals. a / b for a fixed b in
// three instructions: with r = 1/b rounded to nearest, q = a r is within an
// ulp of a/b, and one FMA correction with the remainder a - q b (exact in an
// FMA) gives the correctly rounded quotient (Markstein's theorem; the last
// step of CUDA's own `/`, which adds a range check and a slow path for
// operands whose remainder would overflow or underflow, far outside what a
// stencil of float32 fields produces).
struct Divisors {
  float b[4], r[4];  // dx2, dy2, two_dx, two_dy and 1/b rounded to nearest
};

__device__ __forceinline__ Divisors make_divisors(Stencil s) {
  Divisors d{{s.dx2, s.dy2, s.two_dx, s.two_dy}, {}};
#pragma unroll
  for (int k = 0; k < 4; ++k) d.r[k] = __frcp_rn(d.b[k]);
  return d;
}

__device__ __forceinline__ float div_by(float a, const Divisors& d, int k) {
  const float q = a * d.r[k];
  return fmaf(fmaf(-d.b[k], q, a), d.r[k], q);
}

// Call f(r, c) for the cells of a rows x cols grid that this thread owns:
// cells threadIdx.x, threadIdx.x + blockDim.x, ... in row-major order, with
// (r, c) stepped without a division in the loop.
template <typename F>
__device__ __forceinline__ void for_my_cells(int rows, int cols, F&& f) {
  const int n = rows * cols, dr = blockDim.x / cols, dc = blockDim.x - dr * cols;
  int r = threadIdx.x / cols, c = threadIdx.x - r * cols;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= cols) { c -= cols; ++r; }
  }
}

// 5-point Laplacian of the staged patch on the (TH+2) x (TW+2) ring.
__device__ __forceinline__ void ring_laplacian(const float* __restrict__ su, int TH, int TW,
                                               const Divisors& d, float* __restrict__ sl) {
  const int PW = TW + 4, LW = TW + 2;
  for_my_cells(TH + 2, LW, [&](int r, int c) {
    const float* p = su + (r + 1) * PW + (c + 1);
    const float ctr = p[0];
    sl[r * LW + c] =
        div_by(p[PW] - 2.0f * ctr + p[-PW], d, 0) + div_by(p[1] - 2.0f * ctr + p[-1], d, 1);
  });
}

// The stencil quantities every term is made of, at interior tile point (r, c).
struct PointFields {
  float u, ux, uy, lap, bih;
};

__device__ __forceinline__ PointFields point_fields(const float* __restrict__ su,
                                                    const float* __restrict__ sl, int TW,
                                                    int r, int c, const Divisors& d) {
  const int PW = TW + 4, LW = TW + 2;
  const float* l = sl + (r + 1) * LW + (c + 1);
  const float* p = su + (r + 2) * PW + (c + 2);
  PointFields f;
  f.u = p[0];
  f.lap = l[0];
  f.bih = div_by(l[LW] - 2.0f * f.lap + l[-LW], d, 0) + div_by(l[1] - 2.0f * f.lap + l[-1], d, 1);
  f.ux = div_by(p[PW] - p[-PW], d, 2);
  f.uy = div_by(p[1] - p[-1], d, 3);
  return f;
}

// An input value rounded to float32 (the same value as .to(torch.float32)).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(double v) { return __double2float_rn(v); }

// ---------------------------------------------------------------------------
// Frame pipeline. A CTA stages the (TH+4) x (TW+4) patch of u around its
// tile, wrapped mod H and mod W, in one of two float32 buffers, and (K4) the
// tile's u_t in one of two more. The wrapped offset of every patch element
// is computed once per CTA (goff), so the frame loop has no `%`. Frame t+1
// is copied with cp.async while the CTA works on frame t; float64 input
// lands in a raw buffer and each thread rounds its own elements to float32
// once its copies have landed.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Shared-memory layout of the pipeline, in bytes from the start: two float
// patches, two float u_t tiles (nt = TH * TW points each, 0 when u_t is not
// staged), the Laplacian ring, goff, then (float64 input) the raw buffer of
// the patch and, 16-byte aligned, the tile, then `extra` bytes of the
// kernel's own, 16-byte aligned.
struct PipeLayout {
  size_t su0, su1, st0, st1, sl, goff, raw, raw_tile, extra, total;
};

__host__ __device__ inline size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

__host__ __device__ inline PipeLayout pipe_layout(int TH, int TW, int nt, bool f64,
                                                  size_t extra) {
  const size_t np = (size_t)(TH + 4) * (TW + 4), nl = (size_t)(TH + 2) * (TW + 2);
  PipeLayout L;
  L.su0 = 0;
  L.su1 = align16(L.su0 + np * 4);
  L.st0 = align16(L.su1 + np * 4);
  L.st1 = align16(L.st0 + (size_t)nt * 4);
  L.sl = align16(L.st1 + (size_t)nt * 4);
  L.goff = align16(L.sl + nl * 4);
  L.raw = align16(L.goff + np * 4);
  L.raw_tile = align16(L.raw + (f64 ? np * 8 : 0));
  L.extra = align16(L.raw_tile + (f64 ? (size_t)nt * 8 : 0));
  L.total = L.extra + align16(extra);
  return L;
}

// The u_t tile a CTA stages: vh x vw valid points of a TH x TW tile whose
// origin is frame offset `base`, in frames of width W (vh = 0: u_t is not
// staged).
struct TileSpan {
  int TW, W, vh, vw, base;
};

template <typename In>
struct FramePipe {
  float* su0;       // the patch of even frames, float32
  float* su1;       // the patch of odd frames
  float* st0;       // the u_t tile of even frames, float32 (TH x TW)
  float* st1;       // the u_t tile of odd frames
  In* raw;          // float64 input's landing buffer for the patch
  In* raw_tile;     // ... and for the tile
  const int* goff;  // offset in the frame of each patch element
  int np;
  TileSpan tile_span;

  __device__ FramePipe(unsigned char* smem, const PipeLayout& L, int TH, TileSpan fs)
      : su0(reinterpret_cast<float*>(smem + L.su0)),
        su1(reinterpret_cast<float*>(smem + L.su1)),
        st0(reinterpret_cast<float*>(smem + L.st0)),
        st1(reinterpret_cast<float*>(smem + L.st1)),
        raw(reinterpret_cast<In*>(smem + L.raw)),
        raw_tile(reinterpret_cast<In*>(smem + L.raw_tile)),
        goff(reinterpret_cast<const int*>(smem + L.goff)),
        np((TH + 4) * (fs.TW + 4)),
        tile_span(fs) {}

  // Buffer b's patch and tile (selects, not indexing: the struct stays in registers).
  __device__ __forceinline__ float* patch(int b) const { return b ? su1 : su0; }
  __device__ __forceinline__ float* tile(int b) const { return b ? st1 : st0; }

  // Start the copies of frame t (u's patch from U_t, u_t's tile from Ut_t)
  // into buffers b; each thread copies its own elements: the patch value by
  // value (its rows wrap), the tile row by row in 16-byte pieces where both
  // ends are 16-byte aligned.
  __device__ __forceinline__ void issue(const In* __restrict__ U_t, const In* __restrict__ Ut_t,
                                        int b) const {
    constexpr int kVec = 16 / sizeof(In);
    In* du;
    In* dt;
    if constexpr (sizeof(In) == 4) {
      du = reinterpret_cast<In*>(patch(b));
      dt = reinterpret_cast<In*>(tile(b));
    } else {
      du = raw;
      dt = raw_tile;
    }
    for (int i = threadIdx.x; i < np; i += blockDim.x) cp_async(du + i, U_t + goff[i]);
    const TileSpan& fs = tile_span;
    if (fs.vh > 0) {
      const In* src0 = Ut_t + fs.base;
      for_my_cells(fs.vh, (fs.vw + kVec - 1) / kVec, [&](int r, int q) {
        const In* src = src0 + (long long)r * fs.W + q * kVec;
        In* dst = dt + r * fs.TW + q * kVec;
        const int n = min(kVec, fs.vw - q * kVec);
        const size_t ends = reinterpret_cast<size_t>(src) | __cvta_generic_to_shared(dst);
        if (n == kVec && (ends & 15) == 0) {
          cp_async16(dst, src);
        } else {
          for (int k = 0; k < n; ++k) cp_async(dst + k, src + k);
        }
      });
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  // Wait for this thread's copies; round float64 elements into buffers b.
  // A __syncthreads() must follow before other threads read buffers b.
  __device__ __forceinline__ void land(int b) const {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    if constexpr (sizeof(In) == 8) {
      constexpr int kVec = 2;
      float* su = patch(b);
      float* st = tile(b);
      for (int i = threadIdx.x; i < np; i += blockDim.x) su[i] = to_f32(raw[i]);
      const TileSpan& fs = tile_span;
      if (fs.vh > 0)  // the same cells as issue(): each thread rounds its own copies
        for_my_cells(fs.vh, (fs.vw + kVec - 1) / kVec, [&](int r, int q) {
          for (int k = q * kVec; k < min(fs.vw, q * kVec + kVec); ++k)
            st[r * fs.TW + k] = to_f32(raw_tile[r * fs.TW + k]);
        });
    }
  }
};

// goff for the patch around tile origin (x0, y0): the only `%` of the kernels.
__device__ __forceinline__ void build_offsets(int H, int W, int x0, int y0, int TH, int TW,
                                              int* __restrict__ goff) {
  const int PW = TW + 4;
  for_my_cells(TH + 4, PW, [&](int r, int c) {
    goff[r * PW + c] = wrap(x0 - 2 + r, H) * W + wrap(y0 - 2 + c, W);
  });
}

// ---------------------------------------------------------------------------
// Gram on the FP64 tensor cores. The kernels store, per sample, the fixed
// columns [u, u^2, u_x, u_y, lap, bih, |grad u|^2, u*lap, u_t, 1] (kStored;
// no per-term selection per sample; the last is 1 for a valid sample and 0
// past the valid ones) and each lane maps the X~ column it feeds to one of
// them once per CTA (column_of).
//
// mma.sync.m16n8k4.f64 (PTX ISA, "Matrix fragments for mma.m16n8k4 with
// .f64"; it runs at the H100's full FP64 tensor rate, m8n8k4 at half):
// lane l holds A[g][t], A[g+8][t], B[t][g] and C[g][2t+i], C[g+8][2t+i]
// (g = l>>2, t = l&3, i = 0, 1). With A = X~^T (16 padded columns) and B =
// X~'s columns 0-7, over a chunk of 4 samples, lane l's B element is its
// first A element: column g of sample t; its second is column g + 8. So a
// lane loads and converts two values a chunk, and D1 += A B gives every
// entry (a, b) with min(a, b) < 8. When C > 8 a second mma with B = X~'s
// columns 8-15 gives D2, whose rows 8-15 are the entries with a, b >= 8.
// A padding column (j >= C) may hold any finite value: it reaches only
// entries of padding rows and columns, which are never read.
// ---------------------------------------------------------------------------

constexpr int kStored = 10;  // the stored columns: 8 stencil fields, u_t and 1
constexpr int kUtColumn = 8, kOneColumn = 9;

// The stored column that X~ column j reads.
__device__ __forceinline__ int column_of(const TermSpec& spec, int j) {
  if (j < spec.p) return spec.code[j] == 0 ? kOneColumn : spec.code[j] - 1;
  if (j == spec.p) return kUtColumn;
  return j == spec.p + 1 ? kOneColumn : 0;  // the constant, or padding
}

// The stored columns of a valid point, in column order.
__device__ __forceinline__ void stored_values(const PointFields& f, float y,
                                              float (&v)[kStored]) {
  v[0] = f.u;
  v[1] = f.u * f.u;
  v[2] = f.ux;
  v[3] = f.uy;
  v[4] = f.lap;
  v[5] = f.bih;
  v[6] = f.ux * f.ux + f.uy * f.uy;
  v[7] = f.u * f.lap;
  v[8] = y;
  v[9] = 1.0f;
}

__device__ __forceinline__ void mma_f64(double (&d)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// Row stride (in elements) of a column-major sample buffer with n samples:
// a multiple of 4 that is 4 mod 16, so a chunk's (column, sample) reads
// spread over the banks for 8-byte and 4-byte elements alike.
__host__ __device__ inline int sample_stride(int n) {
  const int s = (n + 3) & ~3;
  return s + ((4 - s) & 15);
}

// This lane's two X~ columns (g and g + 8) as offsets into a column-major
// buffer with the given stride, sample t of chunk 0 included.
struct LaneColumns {
  int off0, off1;
};

__device__ __forceinline__ LaneColumns lane_columns(const TermSpec& spec, int stride) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  return {column_of(spec, g) * stride + t, column_of(spec, g + 8) * stride + t};
}

// Add chunk k (samples 4k .. 4k+3) of a column-major sample buffer to the
// warp's fragments D1 and, when kTwo (C > 8), D2. Each value is converted
// to float64 once. kTwo is a template parameter so that the unrolled chunk
// loops hold no branch around mma.sync. When C <= 8, D2 is free and kSlot
// = 1 adds to it as a second D1, to split the chain of dependent mma; the
// caller adds it into D1 at the end.
template <bool kTwo, int kSlot = 0, typename B>
__device__ __forceinline__ void gram_chunk(const B* __restrict__ buf, const LaneColumns& lc,
                                           int k, double (&acc)[2][4]) {
  const double a0 = (double)buf[lc.off0 + 4 * k];
  if constexpr (kTwo) {
    const double a1 = (double)buf[lc.off1 + 4 * k];
    mma_f64(acc[0], a0, a1, a0);
    mma_f64(acc[1], a0, a1, a1);
  } else {
    mma_f64(acc[kSlot], a0, a0, a0);  // rows 8-15 of D1 are padding
  }
}

// The fragments of a warp in shared memory (`red` + warp * 256: D1 then
// D2, each 16 x 8 row-major), for keeping them there between uses and for
// write_gram_row.
__device__ __forceinline__ void store_fragments(const double (&acc)[2][4],
                                                double* __restrict__ red) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  double* w = red + (threadIdx.x >> 5) * 256;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    w[m * 128 + g * 8 + 2 * t] = acc[m][0];
    w[m * 128 + g * 8 + 2 * t + 1] = acc[m][1];
    w[m * 128 + (g + 8) * 8 + 2 * t] = acc[m][2];
    w[m * 128 + (g + 8) * 8 + 2 * t + 1] = acc[m][3];
  }
}

__device__ __forceinline__ void load_fragments(const double* __restrict__ red,
                                               double (&acc)[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const double* w = red + (threadIdx.x >> 5) * 256;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    acc[m][0] = w[m * 128 + g * 8 + 2 * t];
    acc[m][1] = w[m * 128 + g * 8 + 2 * t + 1];
    acc[m][2] = w[m * 128 + (g + 8) * 8 + 2 * t];
    acc[m][3] = w[m * 128 + (g + 8) * 8 + 2 * t + 1];
  }
}

// Sum the stored fragments of warps [0, n_warps) in warp order and write
// the CTA's row of S statistics. A __syncthreads() must separate the last
// store_fragments from this.
__device__ __forceinline__ void write_gram_row(int n_warps, const TermSpec& spec,
                                               const double* __restrict__ red,
                                               double* __restrict__ row) {
  for (int k = threadIdx.x; k < spec.n_stats; k += blockDim.x) {
    const int a = spec.sa[k], b = spec.sb[k];  // a <= b
    const int off = b < 8 ? a * 8 + b : a < 8 ? b * 8 + a : 128 + a * 8 + (b - 8);
    double v = 0.0;
    for (int w = 0; w < n_warps; ++w) v += red[w * 256 + off];
    row[k] = v;
  }
}

// Registers a thread and resident CTAs per SM of a kernel at a launch shape.
template <typename K>
inline int kernel_occupancy(K* kernel, int threads, size_t smem, int* regs, int* ctas) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = a.numRegs;
  // raise the kernel's limit to the card's (never under what a launch set),
  // then ask how many CTAs of `smem` bytes fit
  int dev = 0, optin = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)a.sharedSizeBytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, threads, smem);
}

}  // namespace pdx
