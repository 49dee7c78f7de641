// The Farnebäck flow's windowed passes (register/farneback.py): the
// polynomial expansion (of a frame, or of a frame warped by the flow, as a
// re-warp pass takes it), the flow update and the window blur, each one
// launch.
//
// Replaces no TPU kernel: pdx runs these passes as XLA's shifted adds or
// banded matrix products (pdx/register/farneback.py), which the port first
// carried over as products of sliding windows (ops/filters.symmetric_windows:
// a gather pads the field, unfold makes K windows, a copy makes them
// contiguous, a gemv sums them). Those copy every window K times, and the
// copies and products took most of a float64 flow's device time.
//
// What bounds it on the card: memory. Every pass is separable with K <= ~25
// taps and needs each input plane read once and each output plane written
// once: an expansion reads 1 plane and writes 5 (the five the update reads;
// c is never read); an update reads frame 1's 5 planes, frame 2's 5 at
// x + d (a bilinear fetch of 4 neighbouring corners, which stay in L1/L2
// while the strip passes) and the 2-plane flow, and writes 2; a blur reads
// and writes each plane once. The arithmetic (~150-250 FMA a pixel in an
// update at K = 15, in float64 as often as not) stays below the card's
// ridge, but the K-tap sums read shared memory ~5K times a pixel.
//
// Design: one kernel of four kinds, one CTA per column strip of TW = kStrip
// output columns and segment of S rows of one plane. The CTA walks down its
// segment kRows virtual rows a step (the segment's rows with K / 2 rows of
// halo above and below, folded into the plane by scipy's "symmetric"
// border, again and again where the window outnumbers the rows). The blur
// and the update sum along the rows first:
//   1. front: the fields of each pixel of the kRows rows across the strip
//      and its K / 2 columns of halo each side (columns folded like rows):
//      the input itself (blur), or the update's five normal-equation fields
//      from frame 1's expansion, frame 2's fetched at x + d (reflect-101
//      corners, the lerp of ops/interp.sample_reflect_xy) and the flow;
//   2. row pass: the K-tap sums along the row, every field of a pixel in
//      one thread, into a ring of the last kRows + K - 1 rows in shared
//      memory;
//   3. column pass: the K-tap sums down the ring for each output row whose
//      window the ring holds, and the epilogue: write the blur, or solve the
//      update's 2x2 system (+ 1e-12 on the determinant).
// The expansions sum down the columns first, the plain version's order
// (in float32 its cancelling moments round so differently in the other
// order that a flow's frames move by ~1e-5):
//   1. front: the input (expansion) or the input fetched at x + d (warped
//      expansion) of the kRows rows across the strip and its halo, into a
//      ring of the last kRows + K - 1 input rows;
//   2. column pass: the three kernels g, g x, g x^2 down the ring, for
//      every column of the strip and its halo;
//   3. row pass: the (3K x 5) operator with the inverse normal matrix
//      folded in along the row, and the five coefficients written.
// Each input row is read once a segment and no pass is recomputed along
// the rows; the halo columns' fronts (and the expansions' column passes)
// are (TW + K - 1) / TW times the strip's, the segments' halo rows
// (S + K - 1) / S. Plain IEEE arithmetic in the input's type (float32 or
// float64), FMA contraction allowed; within a pass the taps are summed one
// by one, in their order. On an H100 the float64 expansion and update take
// 25-40% of their byte bound at 6 pairs of 1024x1280: a step's fetches are
// waited on between its barriers.
#include <cuda_runtime.h>

#include "sample_reflect.cuh"

namespace pdx {
namespace flow {

constexpr int kThreads = 256;  // threads of a CTA
constexpr int kRows = 8;       // virtual rows a step
// Output columns of a strip: at the cells' shapes (float64 batches of
// 1024x1280 and 256x320, float32 single pairs, K 5 to 25) widths of 16 to
// 128 came within ~10% of 32 or lost to it, so one width serves every
// dtype and tap count.
constexpr int kStrip = 32;

// kWarpedPoly: the expansion of the input warped by the flow, in(x + d(x))
enum Kind : int { kBlur = 0, kPoly = 1, kUpdate = 2, kWarpedPoly = 3 };

__host__ __device__ constexpr bool is_poly(int kind) { return kind == kPoly || kind == kWarpedPoly; }
// blur, update: fields a pixel in the front, and row-pass outputs (ring
// planes); expansions: 1 input field, 3 column-pass outputs
__host__ __device__ constexpr int front_fields(int kind) { return kind == kUpdate ? 5 : 1; }
__host__ __device__ constexpr int ring_fields(int kind) {
  return kind == kBlur ? 1 : (is_poly(kind) ? 3 : 5);
}
// blur, update: the K window taps; expansions: the 3 column kernels (3K),
// then the row operator (3K x 5, row-major) with the inverse normal matrix
__host__ __device__ constexpr int taps_count(int kind, int K) {
  return is_poly(kind) ? 18 * K : K;
}

template <typename T>
struct Args {
  const T* in;    // blur, expansions: (B, H, W); update: frame 1's expansion (5, B, H, W)
  const T* exp2;  // update: frame 2's expansion (5, B, H, W)
  const T* flow;  // update, warped expansion: (2, B, H, W), (d_row, d_col)
  const T* taps;
  T* out;         // blur: (B, H, W); expansions: (5, B, H, W); update: (2, B, H, W)
  int B, H, W, K, S, n_strips, n_segs;
};

// Byte offsets in shared memory; the taps come first. Blur, update: the
// front (fields x kRows x FW), then the ring of row-pass sums (fields x R x
// TW). Expansions: the ring of input rows (R x FW), then the column-pass
// sums (3 x kRows x FW).
struct Layout {
  size_t front, ring, total;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline Layout layout(int kind, int K, size_t item) {
  constexpr int TW = kStrip;
  const size_t FW = TW + K - 1, R = kRows + K - 1;
  Layout L;
  L.front = align16(taps_count(kind, K) * item);
  if (is_poly(kind)) {
    L.ring = L.front + align16(R * FW * item);
    L.total = L.ring + align16((size_t)ring_fields(kind) * kRows * FW * item);
  } else {
    L.ring = L.front + align16((size_t)front_fields(kind) * kRows * FW * item);
    L.total = L.ring + align16((size_t)ring_fields(kind) * R * TW * item);
  }
  return L;
}

// np.pad(mode="symmetric") index, folded as often as needed (period 2L)
__device__ __forceinline__ int fold_sym(int i, int L) {
  if (i >= 0 && i < L) return i;
  const int p = 2 * L;
  int j = i % p;
  if (j < 0) j += p;
  return j < L ? j : p - 1 - j;
}

// The update's five fields (a11, a22, a12, h1, h2) at pixel (r, c) of plane
// b: _flow_iteration's pointwise part in its operation order.
template <typename T>
__device__ __forceinline__ void update_front(const Args<T>& a, long long P, long long base, int r,
                                             int c, T* F, int fstride) {
  const long long idx = base + (long long)r * a.W + c;
  const T fr = a.flow[idx], fc = a.flow[P + idx];
  const Fetch<T> at(fr, fc, r, c, a.H, a.W);
  T f[5], e1[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    f[k] = at(a.exp2 + base + k * P);
    e1[k] = a.in[k * P + idx];
  }
  const T axx = T(0.5) * (e1[0] + f[0]), ayy = T(0.5) * (e1[1] + f[1]);
  const T half = T(0.5) * (T(0.5) * (e1[2] + f[2]));
  const T dbx = (axx * fr + half * fc) - T(0.5) * (f[3] - e1[3]);
  const T dby = (ayy * fc + half * fr) - T(0.5) * (f[4] - e1[4]);
  F[0] = axx * axx + half * half;
  F[fstride] = ayy * ayy + half * half;
  F[2 * fstride] = half * (axx + ayy);
  F[3 * fstride] = axx * dbx + half * dby;
  F[4 * fstride] = ayy * dby + half * dbx;
}

// grid.x = n_strips * n_segs * B; block = kThreads
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads) windowed_kernel(const Args<T> a) {
  constexpr int NR = ring_fields(KIND);
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int TW = kStrip;
  const int K = a.K, r = K / 2, FW = TW + K - 1, R = kRows + K - 1;
  const Layout L = layout(KIND, K, sizeof(T));
  T* taps = reinterpret_cast<T*>(smem);
  T* F = reinterpret_cast<T*>(smem + L.front);
  T* ring = reinterpret_cast<T*>(smem + L.ring);

  long long blk = blockIdx.x;
  const int strip = (int)(blk % a.n_strips);
  blk /= a.n_strips;
  const int seg = (int)(blk % a.n_segs);
  const int b = (int)(blk / a.n_segs);
  const int x0 = strip * TW, ys = seg * a.S, ye = min(a.H, ys + a.S);
  const long long plane = (long long)a.H * a.W, P = (long long)a.B * plane, base = b * plane;
  const int tid = threadIdx.x;
  for (int i = tid; i < taps_count(KIND, K); i += kThreads) taps[i] = a.taps[i];

  const int v0 = ys - r;  // the segment's first virtual row
  if constexpr (is_poly(KIND)) {
    T* C = ring;  // the column pass's three sums of the step's rows (3 x kRows x FW)
    T* in_ring = F;  // the last R input rows over the strip and its halo (R x FW)
    for (int vb = v0; vb - r < ye; vb += kRows) {
      // 1. input rows vb .. vb + kRows - 1 over the strip and its halo into the ring
      for (int i = tid; i < kRows * FW; i += kThreads) {
        const int row = i / FW, col = i - row * FW;
        const int ar = fold_sym(vb + row, a.H), ac = fold_sym(x0 - r + col, a.W);
        const long long idx = base + (long long)ar * a.W + ac;
        T v;
        if constexpr (KIND == kWarpedPoly) {
          v = Fetch<T>(a.flow[idx], a.flow[P + idx], ar, ac, a.H, a.W)(a.in + base);
        } else {
          v = a.in[idx];
        }
        in_ring[((vb + row - v0) % R) * FW + col] = v;
      }
      __syncthreads();  // the ring holds rows vb - 2r .. vb + kRows - 1 (and the taps are in)
      // 2. column pass for rows vb - r .. vb + kRows - 1 - r: the three kernels down the ring
      for (int i = tid; i < kRows * FW; i += kThreads) {
        const int row = i / FW, col = i - row * FW;
        const int y = vb - r + row;
        if (y < ys || y >= ye) continue;
        int slot = (y - r - v0) % R;
        T acc[3] = {T(0), T(0), T(0)};
        for (int t = 0; t < K; ++t) {
          const T v = in_ring[slot * FW + col];
#pragma unroll
          for (int h = 0; h < 3; ++h) acc[h] += taps[h * K + t] * v;
          slot = slot + 1 == R ? 0 : slot + 1;
        }
#pragma unroll
        for (int h = 0; h < 3; ++h) C[(h * kRows + row) * FW + col] = acc[h];
      }
      __syncthreads();  // the column sums complete
      // 3. row pass: the operator along the row, and the five coefficients
      for (int i = tid; i < kRows * TW; i += kThreads) {
        const int row = i / TW, col = i - row * TW;
        const int y = vb - r + row, x = x0 + col;
        if (y < ys || y >= ye || x >= a.W) continue;
        const T* M = taps + 3 * K;
        T acc[5] = {T(0), T(0), T(0), T(0), T(0)};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const T* src = C + (c * kRows + row) * FW + col;
          for (int t = 0; t < K; ++t) {
            const T v = src[t];
            const T* m = M + (c * K + t) * 5;
#pragma unroll
            for (int k = 0; k < 5; ++k) acc[k] += m[k] * v;
          }
        }
        const long long o = base + (long long)y * a.W + x;
#pragma unroll
        for (int k = 0; k < 5; ++k) a.out[k * P + o] = acc[k];
      }
      // the next step's front writes ring rows this step's column pass has finished with, and its
      // barrier comes before its column pass overwrites C
    }
  } else {
    for (int vb = v0; vb - r < ye; vb += kRows) {
      // 1. front of virtual rows vb .. vb + kRows - 1 over the strip and its halo
      for (int i = tid; i < kRows * FW; i += kThreads) {
        const int row = i / FW, col = i - row * FW;
        const int ar = fold_sym(vb + row, a.H), ac = fold_sym(x0 - r + col, a.W);
        if constexpr (KIND == kUpdate) {
          update_front(a, P, base, ar, ac, F + i, kRows * FW);
        } else {
          F[i] = a.in[base + (long long)ar * a.W + ac];
        }
      }
      __syncthreads();  // the front (and, on the first step, the taps) complete
      // 2. row pass into the ring, every ring field of a pixel at once
      for (int i = tid; i < kRows * TW; i += kThreads) {
        const int row = i / TW, col = i - row * TW;
        const T* src = F + row * FW + col;
        T acc[NR];
#pragma unroll
        for (int h = 0; h < NR; ++h) acc[h] = T(0);
        for (int t = 0; t < K; ++t) {
          const T k = taps[t];
#pragma unroll
          for (int h = 0; h < NR; ++h) acc[h] += k * src[h * kRows * FW + t];
        }
        const int slot = (vb + row - v0) % R;
#pragma unroll
        for (int h = 0; h < NR; ++h) ring[(h * R + slot) * TW + col] = acc[h];
      }
      __syncthreads();  // the ring holds rows vb - 2r .. vb + kRows - 1
      // 3. column pass and epilogue for rows vb - r .. vb + kRows - 1 - r
      for (int i = tid; i < kRows * TW; i += kThreads) {
        const int row = i / TW, col = i - row * TW;
        const int y = vb - r + row, x = x0 + col;
        if (y < ys || y >= ye || x >= a.W) continue;
        const long long o = base + (long long)y * a.W + x;
        T acc[NR];
#pragma unroll
        for (int h = 0; h < NR; ++h) acc[h] = T(0);
        int slot = (y - r - v0) % R;
        for (int s = 0; s < K; ++s) {
          const T k = taps[s];
#pragma unroll
          for (int h = 0; h < NR; ++h) acc[h] += k * ring[(h * R + slot) * TW + col];
          slot = slot + 1 == R ? 0 : slot + 1;
        }
        if constexpr (KIND == kBlur) {
          a.out[o] = acc[0];
        } else {
          // acc = (a11, a22, a12, h1, h2)
          const T det = acc[0] * acc[1] - acc[2] * acc[2] + T(1e-12);
          a.out[o] = (acc[1] * acc[3] - acc[2] * acc[4]) / det;
          a.out[P + o] = (acc[0] * acc[4] - acc[2] * acc[3]) / det;
        }
      }
    }
  }
}

// Launch an instance (T follows from its parameter) on `st`.
template <typename T>
int launch(void (*kernel)(const Args<T>), const void* in, const void* exp2, const void* flow,
           const void* taps, void* out, int B, int H, int W, int K, int S, int n_strips, int n_segs,
           cudaStream_t st, int kind) {
  Args<T> a{static_cast<const T*>(in), static_cast<const T*>(exp2), static_cast<const T*>(flow),
            static_cast<const T*>(taps), static_cast<T*>(out), B, H, W, K, S, n_strips, n_segs};
  const size_t smem = layout(kind, K, sizeof(T)).total;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (long long)n_strips * n_segs * B;
  kernel<<<(unsigned)grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// Call f with the kernel instance for (kind, f64), and its element type.
template <typename F>
auto with_instance(int kind, int f64, F&& f) {
  if (f64) {
    if (kind == kBlur) return f(windowed_kernel<double, kBlur>);
    if (kind == kPoly) return f(windowed_kernel<double, kPoly>);
    if (kind == kWarpedPoly) return f(windowed_kernel<double, kWarpedPoly>);
    return f(windowed_kernel<double, kUpdate>);
  }
  if (kind == kBlur) return f(windowed_kernel<float, kBlur>);
  if (kind == kPoly) return f(windowed_kernel<float, kPoly>);
  if (kind == kWarpedPoly) return f(windowed_kernel<float, kWarpedPoly>);
  return f(windowed_kernel<float, kUpdate>);
}

}  // namespace flow
}  // namespace pdx

// Shared memory of a CTA of `kind` (0 blur, 1 expansion, 2 update, 3 warped
// expansion) with K taps, float64 if f64 else float32.
extern "C" long long pdx_flow_windows_smem_bytes(int kind, int f64, int K) {
  return (long long)pdx::flow::layout(kind, K, f64 ? 8 : 4).total;
}

// Registers a thread and resident CTAs an SM of that instance.
extern "C" int pdx_flow_windows_occupancy(int kind, int f64, int K, int* regs, int* ctas) {
  if (kind < 0 || kind > 3 || K < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = pdx::flow::layout(kind, K, f64 ? 8 : 4).total;
  return pdx::flow::with_instance(kind, f64, [&](auto* kernel) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return (int)err;
    *regs = fa.numRegs;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, pdx::flow::kThreads,
                                                              smem);
  });
}

// C interface (bound with ctypes). kind 0 blur: in (B, H, W) -> out (B, H,
// W), taps K; kind 1 expansion: in (B, H, W) -> out (5, B, H, W) (axx, ayy,
// axy, bx, by), taps 18K; kind 2 update: in = frame 1's expansion, exp2 =
// frame 2's (5, B, H, W) each, flow (2, B, H, W) -> out (2, B, H, W), taps
// K; kind 3 warped expansion: the expansion of in (B, H, W) sampled at
// x + flow (2, B, H, W), as kind 1's. Every array contiguous, float64 if f64 else float32, out apart from
// the inputs. K odd; strips of kStrip columns (n_strips = ceil(W / kStrip)),
// segments of S rows (n_segs * S >= H). Launches on `stream`; returns a cudaError_t
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int pdx_flow_windows(int kind, int f64, const void* in, const void* exp2,
                                const void* flow, const void* taps, void* out, int B, int H,
                                int W, int K, int S, int n_strips, int n_segs, void* stream) {
  constexpr int TW = pdx::flow::kStrip;
  if (kind < 0 || kind > 3 || B < 1 || H < 1 || W < 1 || K < 1 || K % 2 == 0 || S < 1 ||
      (long long)n_strips * TW < W || (long long)(n_strips - 1) * TW >= W ||
      (long long)n_segs * S < H || (long long)(n_segs - 1) * S >= H ||
      (long long)n_strips * n_segs * B >= (1LL << 31) || !in || !taps || !out ||
      (kind == 2 && !exp2) || ((kind == 2 || kind == 3) && !flow))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return pdx::flow::with_instance(kind, f64, [&](auto* kernel) {
    return pdx::flow::launch(kernel, in, exp2, flow, taps, out, B, H, W, K, S, n_strips, n_segs, st,
                             kind);
  });
}
