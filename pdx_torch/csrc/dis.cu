// The DIS flow's per-level passes (register/dis.py): the inverse-
// compositional Lucas-Kanade search of every patch of the grid, and the
// densification of the patches' weighted displacements into a dense flow.
//
// Replaces no TPU kernel: pdx leaves DIS to XLA (pdx/register/dis.py), which
// the port first carried over as eager PyTorch (ops/kernels/dis_patches'
// *_reference passes). There each of a level's 9 sampling passes wrote
// coordinate, index and corner tensors of every patch's pixels to device
// memory (81,345 patches x 64 pixels, ~42 MB each in float64 at 1024x1280)
// and read them back, and a flow queued ~1,400 small operations.
//
// What bounds it on the card. The bytes a flow needs: each level reads ref,
// mov and the two initial flow planes and writes the two flow planes, 6
// planes over the pyramid's 1.33 x H x W pixels: ~84 MB in float64 at
// 1024x1280, 0.025 ms at 3.35 TB/s. The search reads each pixel of mov again
// as a bilinear corner ~4 (ps / st)^2 (iters + 1) times (144 at the
// defaults), and its iterations depend on each other, so the time goes to
// L1/L2 traffic and latency: mov is 10.5 MB at the finest level and stays in
// L2, and a CTA's patches are neighbours in a row of the grid, so that L1
// serves their overlapping windows. Nothing goes to device memory between
// the passes of a level.
//
// Design. The inverse search is three launches a level:
//   1. hessian: a fixed grid of kPartials CTAs; each warp walks patches and
//      sums h11 + h22 of each (the damping's reduction), warp by warp, CTA
//      by CTA, in a fixed order, into partial sums;
//   2. damping: one CTA adds the partial sums in a fixed tree order and
//      writes 0.05 mean(h11 + h22) + 1e-8 to device memory (the host reads
//      nothing);
//   3. search: one warp a patch. Each lane holds pixels lane, lane + 32, ...
//      of the patch (its corner comes from the patch index): the template
//      and its gradients (torch.gradient, edge_order=1) in registers.
//      Shuffle-xor sums (every lane ends with the same bits) give h11, h12,
//      h22, and in each iteration the products of the gradients with the
//      residual of mov's reflect-101 bilinear sample at the displaced pixels
//      (sample_reflect.cuh); the 2x2 solve runs on every lane. A last pass
//      gives the weight 1 / (mean |r| + 1e-3); lane 0 writes (w u, w v, w).
// The densification is one launch: one thread an output pixel adds the
// values of the <= ceil(ps / st)^2 patches covering it, rows of the grid
// first, divides, and keeps the initial flow where no patch covers it.
// No float atomics and every sum in a fixed order, so a flow repeats bit for
// bit. Plain IEEE arithmetic in the input's type (float32 or float64), FMA
// contraction allowed.
#include <cuda_runtime.h>

#include "sample_reflect.cuh"

namespace pdx {
namespace dis {

constexpr int kWarps = 8;  // warps (patches at a time) of a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kPartials = 1024;  // CTAs of the Hessian pass, threads of the damping pass
constexpr int kMaxPatch = 8;     // the largest patch side: 64 pixels, 2 a lane

enum Kind : int { kSearch = 0, kDensify = 1 };

template <typename T>
struct Args {
  const T* in;       // search: ref (H, W); densify: the patches' values (3, P)
  const T* mov;      // search: (H, W)
  const T* init_fx;  // (H, W)
  const T* init_fy;  // (H, W)
  T* scratch;        // search: kPartials partial sums, then the damping
  T* out;            // search: (3, P) = (w u, w v, w); densify: (2, H, W)
  int H, W, ps, st, iters, ny, nx;
  long long P;
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// torch.gradient with unit spacing and edge_order=1 at index k of n along an
// axis of step `step`
template <typename T>
__device__ __forceinline__ T gradient(const T* f, long long i, int k, int n, long long step) {
  if (k == 0) return f[i + step] - f[i];
  if (k == n - 1) return f[i] - f[i - step];
  return (f[i + step] - f[i - step]) * T(0.5);
}

// A patch's pixels in a warp: lane l holds pixels l, l + 32, ... (row-major
// in the patch), each with its template value and row and column gradients.
template <typename T, int PPL>
struct Patch {
  int y0, x0, n;
  int r[PPL], c[PPL];
  T t[PPL], gr[PPL], gc[PPL];

  __device__ __forceinline__ Patch(const Args<T>& a, long long p, int lane) {
    y0 = (int)(p / a.nx) * a.st;
    x0 = (int)(p % a.nx) * a.st;
    n = a.ps * a.ps;
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      const int q = lane + 32 * k;
      r[k] = y0 + q / a.ps;
      c[k] = x0 + q % a.ps;
      t[k] = gr[k] = gc[k] = T(0);
      if (q < n) {
        const long long i = (long long)r[k] * a.W + c[k];
        t[k] = a.in[i];
        gr[k] = gradient(a.in, i, r[k], a.H, (long long)a.W);
        gc[k] = gradient(a.in, i, c[k], a.W, 1LL);
      }
    }
  }
  __device__ __forceinline__ bool has(int k, int lane) const { return lane + 32 * k < n; }
};

// The patch's (h11, h12, h22): warp sums of gr gr, gr gc and gc gc.
template <typename T, int PPL>
__device__ __forceinline__ void hessian(const Patch<T, PPL>& q, T& h11, T& h12, T& h22) {
  h11 = h12 = h22 = T(0);
#pragma unroll
  for (int k = 0; k < PPL; ++k) {
    h11 += q.gr[k] * q.gr[k];
    h12 += q.gr[k] * q.gc[k];
    h22 += q.gc[k] * q.gc[k];
  }
  h11 = warp_sum(h11);
  h12 = warp_sum(h12);
  h22 = warp_sum(h22);
}

// grid kPartials, block kThreads: scratch[cta] = the CTA's sum of h11 + h22
template <typename T, int PPL>
__global__ void __launch_bounds__(kThreads) hessian_kernel(const Args<T> a) {
  __shared__ T warp_total[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T acc = T(0);
  for (long long p = (long long)blockIdx.x * kWarps + warp; p < a.P; p += (long long)gridDim.x * kWarps) {
    const Patch<T, PPL> q(a, p, lane);
    T h11, h12, h22;
    hessian(q, h11, h12, h22);
    acc += h11 + h22;
  }
  if (lane == 0) warp_total[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = T(0);
    for (int w = 0; w < kWarps; ++w) s += warp_total[w];
    a.scratch[blockIdx.x] = s;
  }
}

// one CTA of kPartials threads: scratch[kPartials] = 0.05 mean(h11 + h22) + 1e-8
template <typename T>
__global__ void __launch_bounds__(kPartials) damping_kernel(const Args<T> a) {
  __shared__ T s[kPartials];
  const int tid = threadIdx.x;
  s[tid] = a.scratch[tid];
  __syncthreads();
  for (int m = kPartials / 2; m > 0; m >>= 1) {
    if (tid < m) s[tid] += s[tid + m];
    __syncthreads();
  }
  if (tid == 0) a.scratch[kPartials] = T(0.05) * (s[0] / T(a.P)) + T(1e-8);
}

// grid ceil(P / kWarps), block kThreads: one warp a patch
template <typename T, int PPL>
__global__ void __launch_bounds__(kThreads) search_kernel(const Args<T> a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long p = (long long)blockIdx.x * kWarps + warp;
  if (p >= a.P) return;  // the whole warp
  const Patch<T, PPL> q(a, p, lane);
  T h11, h12, h22;
  hessian(q, h11, h12, h22);
  const T damp = a.scratch[kPartials];
  h11 += damp;
  h22 += damp;
  const T det = h11 * h22 - h12 * h12 + T(1e-8);
  // the patch starts from the initial flow at its centre
  const long long centre = (long long)(q.y0 + a.ps / 2) * a.W + (q.x0 + a.ps / 2);
  T u = a.init_fx[centre], v = a.init_fy[centre];
  for (int it = 0; it < a.iters; ++it) {
    T g1 = T(0), g2 = T(0);
#pragma unroll
    for (int k = 0; k < PPL; ++k) {
      if (!q.has(k, lane)) continue;
      const T res = Fetch<T>(u, v, q.r[k], q.c[k], a.H, a.W)(a.mov) - q.t[k];
      g1 += q.gr[k] * res;
      g2 += q.gc[k] * res;
    }
    g1 = warp_sum(g1);
    g2 = warp_sum(g2);
    const T du = (h22 * g1 - h12 * g2) / det;
    const T dv = (h11 * g2 - h12 * g1) / det;
    u = u - du;
    v = v - dv;
  }
  // the residual weight of the densification
  T s = T(0);
#pragma unroll
  for (int k = 0; k < PPL; ++k) {
    if (q.has(k, lane)) s += fabs(Fetch<T>(u, v, q.r[k], q.c[k], a.H, a.W)(a.mov) - q.t[k]);
  }
  s = warp_sum(s);
  if (lane == 0) {
    const T w = T(1) / (s / T(q.n) + T(1e-3));
    a.out[p] = w * u;
    a.out[a.P + p] = w * v;
    a.out[2 * a.P + p] = w;
  }
}

// grid ceil(H W / kThreads), block kThreads: one thread an output pixel
template <typename T>
__global__ void __launch_bounds__(kThreads) densify_kernel(const Args<T> a) {
  const long long HW = (long long)a.H * a.W;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= HW) return;
  const int y = (int)(i / a.W), x = (int)(i % a.W);
  // grid rows (columns) whose patches cover y (x): k st <= y <= k st + ps - 1
  const int ylo = y - a.ps + 1, xlo = x - a.ps + 1;
  const int a0 = ylo <= 0 ? 0 : (ylo + a.st - 1) / a.st, a1 = min(a.ny - 1, y / a.st);
  const int b0 = xlo <= 0 ? 0 : (xlo + a.st - 1) / a.st, b1 = min(a.nx - 1, x / a.st);
  T su = T(0), sv = T(0), sw = T(0);
  for (int ga = a0; ga <= a1; ++ga) {
    for (int gb = b0; gb <= b1; ++gb) {
      const long long p = (long long)ga * a.nx + gb;
      su += a.in[p];
      sv += a.in[a.P + p];
      sw += a.in[2 * a.P + p];
    }
  }
  if (sw > T(0)) {
    a.out[i] = su / (sw + T(1e-12));
    a.out[HW + i] = sv / (sw + T(1e-12));
  } else {  // no patch covers the pixel
    a.out[i] = a.init_fx[i];
    a.out[HW + i] = a.init_fy[i];
  }
}

template <typename T, int PPL>
int search(const Args<T>& a, cudaStream_t st) {
  hessian_kernel<T, PPL><<<kPartials, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  damping_kernel<T><<<1, kPartials, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  search_kernel<T, PPL><<<(unsigned)((a.P + kWarps - 1) / kWarps), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int kind, const void* in, const void* mov, const void* init_fx, const void* init_fy,
           void* scratch, void* out, int H, int W, int ps, int stride, int iters, cudaStream_t st) {
  const int ny = (H - ps) / stride + 1, nx = (W - ps) / stride + 1;
  Args<T> a{static_cast<const T*>(in), static_cast<const T*>(mov), static_cast<const T*>(init_fx),
            static_cast<const T*>(init_fy), static_cast<T*>(scratch), static_cast<T*>(out),
            H, W, ps, stride, iters, ny, nx, (long long)ny * nx};
  if (kind == kDensify) {
    densify_kernel<T><<<(unsigned)(((long long)H * W + kThreads - 1) / kThreads), kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  return search<T, 2>(a, st);
}

}  // namespace dis
}  // namespace pdx

// C interface (bound with ctypes). kind 0, the inverse search of a level:
// in = ref and mov (H, W), the initial flow (init_fx, init_fy) (H, W),
// scratch (kPartials + 1) -> out (3, P) = (w u, w v, w) of the
// patches of side ps at stride st from the corner (P = ny nx, ny = (H - ps)
// / st + 1, nx likewise), after `iters` iterations. kind 1, the
// densification: in = the patches' values (3, P), the initial flow -> out
// (2, H, W). Every array contiguous, float64 if f64 else float32, out apart
// from the inputs. Launches on `stream` (three kernels for kind 0, one for
// kind 1); returns a cudaError_t (cudaErrorInvalidValue for arguments the
// kernels do not take).
extern "C" int pdx_dis(int kind, int f64, const void* in, const void* mov, const void* init_fx,
                       const void* init_fy, void* scratch, void* out, int H, int W, int ps, int st,
                       int iters, void* stream) {
  using pdx::dis::kMaxPatch;
  if (kind < 0 || kind > 1 || H < 2 || W < 2 || ps < 1 || ps > kMaxPatch || ps > H || ps > W ||
      st < 1 || iters < 0 || (long long)H * W >= (1LL << 31) || !in || !init_fx || !init_fy ||
      !out || (kind == 0 && (!mov || !scratch)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? pdx::dis::launch<double>(kind, in, mov, init_fx, init_fy, scratch, out, H, W, ps, st, iters, s)
             : pdx::dis::launch<float>(kind, in, mov, init_fx, init_fy, scratch, out, H, W, ps, st, iters, s);
}
