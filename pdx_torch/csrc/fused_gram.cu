// K1 — fused KS dictionary + Gram statistics over the full field.
//
// Replaces the TPU kernel pdx/ops/pallas/fused_gram.py::fused_ks_gram
// (pallas_call at :320, kernel body _kernel at :72): the 14 sufficient
// statistics of the true KS library [lap, bih, |grad u|^2] against u_t over
// every (t, x, y) sample, n = T*H*W, without materialising the (3, T, H, W)
// term stack.
//
// What bounds it on the card: memory. It reads U and Ut once — at the main
// path's (1999, 100, 100) float32 shape ~160 MB, 0.048 ms at 3.35 TB/s;
// twice that for float64 input, which it reads directly — and does ~40
// float32 and 28 float64 operations per sample, below the card's ridge.
//
// Design (band_common.cuh). The TPU kernel owns whole frames; so does this
// one where a frame fits: a CTA owns a band of TH rows at full width (the
// wrapper takes TH = H when shared memory allows, so no halo is read twice)
// and a long run of consecutive frames, about one CTA a streaming
// multiprocessor. A frame's band, its wrapped halo rows and its u_t are a
// few contiguous runs, staged by bulk asynchronous copies that one thread
// issues for frame t+1 while all threads work on frame t (an element-wise
// cp.async route with the same layout takes the shapes and pointers that
// are not 16-byte aligned; float64 bands too large for shared memory are
// rounded to float32 in flight). Per frame: the Laplacian on the band's rows and
// one row above and below goes to shared memory (rounded to float32 before
// the second stencil, as in pdx); then every thread walks down a strip of one
// column with the rows of lap and u above and below in registers (six
// shared-memory loads a point and u_t), the stencil's divisions in three
// instructions each, and adds the sample's 14 products to float64
// registers; two __syncthreads() a frame. One shuffle-tree epilogue per
// CTA writes its row of 14 partial sums; reduce_rows_kernel sums the rows
// in an order fixed by the shape. No float atomics: two launches give the
// same bits.
#include "band_common.cuh"

namespace pdx {

// grid = (bands along H, frame chunks); block = `threads` of the launch.
template <typename In, int kRoute>
__global__ void __launch_bounds__(kBandMaxThreads)
fused_ks_gram_kernel(const In* __restrict__ U, const In* __restrict__ Ut, int T, int H, int W,
                     int TH, int frames_per_cta, Stencil s, double* __restrict__ partials) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int x0 = blockIdx.x * TH, th = min(TH, H - x0);
  using Pipe = BandPipe<In, kRoute>;
  const BandLayout L = band_layout(TH, W, Pipe::kStaged64, 0);
  const Pipe pipe(smem, L, H, W, x0, th);
  float* sl = reinterpret_cast<float*>(smem + L.sl);
  const int t_begin = blockIdx.y * frames_per_cta;
  const int t_end = min(T, t_begin + frames_per_cta);
  const long long frame = (long long)H * W;
  const Divisors d = make_divisors(s);

  double acc[kStats];
#pragma unroll
  for (int k = 0; k < kStats; ++k) acc[k] = 0.0;

  const int strip = strip_rows(th, W), n_strips = (th + strip - 1) / strip;
  for_band_frames(pipe, U, Ut, frame, t_begin, t_end, [&](const float* su, const In* ut, int) {
    band_laplacian(su, th, W, d, sl);
    __syncthreads();  // the ring is complete
    for_my_cells(n_strips, W, [&](int q, int c) {
      band_strip_terms(su, sl, W, q * strip, min(th, q * strip + strip), c, d,
                       [&](float lap, float bih, float gsq, int i) {
                         accumulate(acc, lap, bih, gsq, to_f32(ut[i]));
                       });
    });
    __syncthreads();  // the next frame overwrites the ring (and float64's patch)
  });
  const int cta = blockIdx.y * gridDim.x + blockIdx.x;
  write_block_row(acc, reinterpret_cast<double*>(smem + L.red),
                  partials + (long long)cta * kStats);
}

// Launch an instance (In follows from the kernel's own parameters; staged64:
// its stages hold float64), then the reduction of its rows.
template <typename In>
int launch_ks_gram(void (*kernel)(const In*, const In*, int, int, int, int, int, Stencil, double*),
                   bool staged64, const void* U, const void* Ut, int T, int H, int W, int TH,
                   int threads, int frames_per_cta, int n_bands, int n_chunks, Stencil s,
                   double* partials, double* out, cudaStream_t st) {
  const size_t smem = band_layout(TH, W, staged64, 0).total;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(n_bands, n_chunks), threads, smem, st>>>(
      static_cast<const In*>(U), static_cast<const In*>(Ut), T, H, W, TH, frames_per_cta, s,
      partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<kStats, kThreads, 0, st>>>(partials, n_bands * n_chunks, kStats, out);
  return (int)cudaGetLastError();
}

// Call f with the kernel instance for (f64, route).
template <typename F>
auto with_ks_gram_instance(int f64, int route, F&& f) {
  if (f64 && route == kRounded) return f(fused_ks_gram_kernel<double, kRounded>);
  if (f64)
    return route == kBulk ? f(fused_ks_gram_kernel<double, kBulk>)
                          : f(fused_ks_gram_kernel<double, kElementwise>);
  return route == kBulk ? f(fused_ks_gram_kernel<float, kBulk>)
                        : f(fused_ks_gram_kernel<float, kElementwise>);
}

}  // namespace pdx

// Shared memory a CTA of K1 needs for a band of TH rows of W columns whose
// stages hold float64 (staged64: float64 input on any route but the rounded
// one) or float32. The wrapper plans with the same formula and checks it
// against this.
extern "C" long long pdx_band_smem_bytes(int TH, int W, int staged64) {
  return (long long)pdx::band_layout(TH, W, staged64 != 0, 0).total;
}

// Registers a thread and resident CTAs per SM of the instance at this launch shape.
extern "C" int pdx_fused_ks_gram_occupancy(int TH, int W, int threads, int f64, int route,
                                           int* regs, int* ctas) {
  const size_t smem = pdx::band_layout(TH, W, f64 && route != pdx::kRounded, 0).total;
  return pdx::with_ks_gram_instance(f64, route, [&](auto* kernel) {
    return pdx::kernel_occupancy(kernel, threads, smem, regs, ctas);
  });
}

// C interface (bound with ctypes). U and Ut: contiguous (T, H, W), float64
// if f64 else float32. route: how frames are staged, 1 by bulk copies (both
// pointers and W * itemsize must be multiples of 16), 0 element by element,
// 2 (float64 only) rounded to float32 in flight. Bands of TH
// rows, n_bands * TH >= H; chunks of frames_per_cta frames, n_chunks *
// frames_per_cta >= T. partials holds n_bands * n_chunks rows of 14
// doubles; out receives the 14 statistics. Returns a cudaError_t
// (cudaErrorInvalidValue for a launch shape the kernel does not take).
extern "C" int pdx_fused_ks_gram(const void* U, const void* Ut, int f64, int route, int T, int H,
                                 int W, int TH, int threads, int frames_per_cta, int n_bands,
                                 int n_chunks, float dx2, float dy2, float two_dx, float two_dy,
                                 double* partials, double* out, void* stream) {
  const size_t item = f64 ? 8 : 4;
  if (threads < 32 || threads > pdx::kBandMaxThreads || threads % 32 || TH < 1 ||
      (long long)n_bands * TH < H || (long long)(n_bands - 1) * TH >= H ||
      (long long)n_chunks * frames_per_cta < T)
    return (int)cudaErrorInvalidValue;
  if (route < 0 || route > pdx::kRounded || (route == pdx::kRounded && !f64))
    return (int)cudaErrorInvalidValue;
  if (route == pdx::kBulk && (((size_t)U | (size_t)Ut) % 16 || (W * item) % 16))
    return (int)cudaErrorInvalidValue;
  const pdx::Stencil s{dx2, dy2, two_dx, two_dy};
  return pdx::with_ks_gram_instance(f64, route, [&](auto* kernel) {
    return pdx::launch_ks_gram(kernel, f64 && route != pdx::kRounded, U, Ut, T, H, W, TH, threads, frames_per_cta, n_bands,
                               n_chunks, s, partials, out, static_cast<cudaStream_t>(stream));
  });
}
