// Shared pieces of the true-library kernels K1 (fused_gram.cu) and K3
// (fused_blockwise.cu): row bands at full frame width, staged by bulk
// asynchronous copies.
//
// The TPU kernels own whole frames. Here a CTA owns a band of th rows and
// all W columns of a run of consecutive frames. The band plus its two halo
// rows above and below (rows wrapped mod H) is a few contiguous runs of
// device memory, at most kMaxRuns: the band's u_t is one more. So a frame
// is staged with no address per element:
//
//   kBulk     one thread arms the stage's mbarrier with the byte count and
//          issues one cp.async.bulk (the 1-D copy of Hopper's TMA unit) per
//          run; every thread waits on the barrier's phase parity. Needs
//          16-byte aligned pointers and rows (W * sizeof(In) % 16 == 0).
//   kElementwise  every thread copies its share of the same layout element
//          by element with cp.async (any W, any pointer), waits for its own
//          copies and meets the others at a __syncthreads().
//   kRounded  float64 input only: every thread loads its share of the patch
//          from device memory, rounds it to float32 in registers and stores
//          it, so the stages are float32 and take the shared memory of
//          float32 input; u_t is read where it lies. Nothing is
//          asynchronous: the route of bands too large for raw float64.
//
// The wrapper picks the route from the shape, the type and the pointers; none
// ever gives way to another at run time. Frame t+1 is copied into the other
// stage while the CTA works on frame t. The column wrap happens in shared
// memory: the stencils read columns -1 and W from the row's other end by a
// select. On the first two routes float64 input lands as it is and every
// thread rounds its share to float32 once (the value .to(torch.float32)
// gives) into a patch of its own; u_t is rounded where it is read, once.
#pragma once

#include <type_traits>

#include "terms_common.cuh"

namespace pdx {

constexpr int kBandMaxThreads = 768;  // most threads a band CTA takes
// Most contiguous runs of a wrapped patch: its th + 4 <= H + 4 consecutive
// rows wrap at most five times (H = 1), so there are never more than six.
constexpr int kMaxRuns = 8;

constexpr int kElementwise = 0, kBulk = 1, kRounded = 2;  // the copy routes

constexpr int kStages = 2;  // a third stage measured no faster (PERF.md)

// Shared-memory layout of a band CTA, in bytes from the start: kStages
// stages of (u patch, u_t band) in the staged type (f64: float64, the input
// as it is; else float32), `stage` bytes apart with u_t `ut` bytes into
// each; the float32 patch of staged float64, the
// Laplacian ring, the patch rows' frame offsets (or the run table), the
// epilogue's buffer, one barrier a stage, then `extra` bytes of the
// kernel's own.
struct BandLayout {
  size_t ut, stage, su, sl, rowoff, red, bar, extra, total;
};

__host__ __device__ inline BandLayout band_layout(int TH, int W, bool f64, size_t extra) {
  const size_t e = f64 ? 8 : 4;
  const size_t np = (size_t)(TH + 4) * W, nt = (size_t)TH * W, nl = (size_t)(TH + 2) * W;
  BandLayout L;
  L.ut = align16(np * e);
  L.stage = L.ut + align16(nt * e);
  L.su = kStages * L.stage;
  L.sl = align16(L.su + (f64 ? np * 4 : 0));
  L.rowoff = align16(L.sl + nl * 4);
  const size_t n_off = TH + 4 > 3 * kMaxRuns + 1 ? TH + 4 : 3 * kMaxRuns + 1;  // or the run table
  L.red = align16(L.rowoff + n_off * 4);
  L.bar = align16(L.red + (size_t)(kBandMaxThreads / 32) * kStats * 8);
  L.extra = align16(L.bar + 8 * kStages);
  L.total = L.extra + align16(extra);
  return L;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// One contiguous run of `bytes` bytes (a multiple of 16, both ends 16-byte
// aligned) from device to shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename In, int kRoute>
struct BandPipe {
  static_assert(kRoute != kRounded || sizeof(In) == 8, "only float64 input is rounded in flight");
  using Staged = std::conditional_t<kRoute == kRounded, float, In>;  // what a stage holds
  static constexpr bool kStaged64 = sizeof(Staged) == 8;

  unsigned char* stage0;  // stage b's patch (rows x0-2 .. x0+th+1, wrapped, x W) is
  size_t stage, ut_at;    // `stage` * b bytes on, its u_t band (th x W) `ut_at` more
  float* su;      // staged float64's rounded patch
  // The frame offset of each patch row; kBulk: the patch's
  // contiguous runs, [0] their number, then for each its offset in the
  // frame, its offset in the patch and its elements.
  int* rowoff;
  unsigned long long* bar;  // one barrier a stage
  int W, th, np, nt, ut_off;

  // Every thread of the CTA constructs it; ends with a __syncthreads().
  __device__ BandPipe(unsigned char* smem, const BandLayout& L, int H, int W_, int x0, int th_)
      : stage0(smem), stage(L.stage), ut_at(L.ut),
        su(reinterpret_cast<float*>(smem + L.su)),
        rowoff(reinterpret_cast<int*>(smem + L.rowoff)),
        bar(reinterpret_cast<unsigned long long*>(smem + L.bar)),
        W(W_), th(th_), np((th_ + 4) * W_), nt(th_ * W_), ut_off(x0 * W_) {
    if constexpr (kRoute == kBulk) {
      if (threadIdx.x == 0) {
        // the runs of the wrapped rows: the only `%` of the kernel, once a CTA
        int nruns = 0, prev = -2;
        for (int i = 0; i < th + 4; ++i) {
          const int row = wrap(x0 - 2 + i, H);
          if (nruns == 0 || row != prev + 1) {
            rowoff[3 * nruns + 1] = row * W;
            rowoff[3 * nruns + 2] = i * W;
            rowoff[3 * nruns + 3] = 0;
            ++nruns;
          }
          rowoff[3 * nruns] += W;
          prev = row;
        }
        rowoff[0] = nruns;
        for (int b = 0; b < kStages; ++b) mbar_init(bar + b, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      }
    } else {
      for (int i = threadIdx.x; i < th + 4; i += blockDim.x) rowoff[i] = wrap(x0 - 2 + i, H) * W;
    }
    __syncthreads();
  }

  // Stage b's patch and u_t band.
  __device__ __forceinline__ Staged* u(int b) const {
    return reinterpret_cast<Staged*>(stage0 + b * stage);
  }
  __device__ __forceinline__ Staged* ut(int b) const {
    return reinterpret_cast<Staged*>(stage0 + b * stage + ut_at);
  }
  // The u_t band of the frame in stage b (Ut_t: the frame's first element)
  // as the work reads it: staged, or (kRounded) where it lies in device
  // memory, since each value is read once.
  __device__ __forceinline__ const In* ut(int b, const In* __restrict__ Ut_t) const {
    if constexpr (kRoute == kRounded) {
      return Ut_t + ut_off;
    } else {
      return ut(b);
    }
  }

  // Start the copies of one frame (U_t, Ut_t: the frame's first elements)
  // into stage b. Every thread of the CTA calls it, after a __syncthreads()
  // that follows the last read of stage b: the one that ends a frame frees
  // that frame's stage, so a copy has a whole frame's work to hide behind.
  __device__ __forceinline__ void issue(const In* __restrict__ U_t, const In* __restrict__ Ut_t,
                                        int b) const {
    if constexpr (kRoute == kBulk) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(bar + b, (unsigned)((np + nt) * sizeof(In)));
        const int nruns = rowoff[0];
        for (int k = 0; k < nruns; ++k)
          bulk_copy(u(b) + rowoff[3 * k + 2], U_t + rowoff[3 * k + 1],
                    (unsigned)(rowoff[3 * k + 3] * sizeof(In)), bar + b);
        bulk_copy(ut(b), Ut_t + ut_off, (unsigned)(nt * sizeof(In)), bar + b);
      }
    } else if constexpr (kRoute == kElementwise) {
      In* du = u(b);
      for_my_cells(th + 4, W, [&](int r, int c) { cp_async(du + r * W + c, U_t + rowoff[r] + c); });
      In* dt = ut(b);
      const In* src = Ut_t + ut_off;
      for (int i = threadIdx.x; i < nt; i += blockDim.x) cp_async(dt + i, src + i);
      asm volatile("cp.async.commit_group;\n" ::);
    } else {
      // batches of loads in flight, then their stores: patch cell i is row
      // i / W, column i % W, stepped as for_my_cells does
      constexpr int kBatch = 8;
      float* __restrict__ du = u(b);
      const int step = blockDim.x, dr = step / W, dc = step - dr * W;
      int r = threadIdx.x / W, c = threadIdx.x - r * W;
      for (int i0 = threadIdx.x; i0 < np; i0 += kBatch * step) {
        In v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (i0 + k * step < np) v[k] = U_t[rowoff[r] + c];
          r += dr;
          c += dc;
          if (c >= W) { c -= W; ++r; }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (i0 + k * step < np) du[i0 + k * step] = to_f32(v[k]);
      }
    }
  }

  // Wait for stage b's frame (`parity`: how often the stage was used
  // before, mod 2; `later`: the next frame's copies have been started
  // already) and return its float32 patch. Every thread calls it.
  __device__ __forceinline__ const float* acquire(int b, unsigned parity, bool later) const {
    if constexpr (kRoute == kBulk) {
      mbar_wait(bar + b, parity);
    } else if constexpr (kRoute == kRounded) {
      __syncthreads();  // every thread's stores of the frame
    } else {
      if (later) {
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();
    }
    if constexpr (kStaged64) {
      const In* raw = u(b);
      for (int i = threadIdx.x; i < np; i += blockDim.x) su[i] = to_f32(raw[i]);
      __syncthreads();
      return su;
    } else {
      return reinterpret_cast<const float*>(u(b));
    }
  }
};

// Walk frames [t_begin, t_end) of this CTA's band through the pipeline:
// work(su, ut, t) is called for each frame with its float32 patch and its
// u_t band in shared memory, by every thread, after the copies of the next
// frame have been started; it must end with a __syncthreads().
template <typename In, int kRoute, typename F>
__device__ __forceinline__ void for_band_frames(const BandPipe<In, kRoute>& pipe,
                                                const In* __restrict__ U,
                                                const In* __restrict__ Ut, long long frame,
                                                int t_begin, int t_end, F&& work) {
  if (t_begin < t_end) pipe.issue(U + t_begin * frame, Ut + t_begin * frame, 0);
  for (int t = t_begin; t < t_end; ++t) {
    const int j = t - t_begin, cur = j & 1;
    const bool more = t + 1 < t_end;
    // the barrier that ended frame t-1 freed its stage, the other one
    if (more) pipe.issue(U + (t + 1) * frame, Ut + (t + 1) * frame, cur ^ 1);
    work(pipe.acquire(cur, (j >> 1) & 1, more), pipe.ut(cur, Ut + t * frame), t);
  }
}

// Rows of a vertical strip when `rows` rows of W columns are shared out to
// the CTA's threads, one strip (or more, where W exceeds the threads) each.
__device__ __forceinline__ int strip_rows(int rows, int W) {
  const int per_row = max(1, (int)blockDim.x / W);
  return (rows + per_row - 1) / per_row;
}

// 5-point Laplacian of the staged patch on band rows -1 .. th (sl row j is
// frame row x0 - 1 + j, patch row j + 1), rounded to float32 before the
// second stencil takes it, as the plain version does. A thread walks down
// a strip of one column with the three rows of u it needs in registers:
// three loads a cell, the column wrap selected once a strip.
__device__ __forceinline__ void band_laplacian(const float* __restrict__ su, int th, int W,
                                               const Divisors& d, float* __restrict__ sl) {
  const int rows = th + 2, L = strip_rows(rows, W);
  for_my_cells((rows + L - 1) / L, W, [&](int q, int c) {
    const int r0 = q * L, r1 = min(rows, r0 + L);
    const int cm = c == 0 ? W - 1 : c - 1, cp = c == W - 1 ? 0 : c + 1;
    const float* p = su + r0 * W;
    float up = p[c], ctr = p[W + c];
    p += W;  // the strip's current row of u
    float* o = sl + r0 * W + c;
    for (int r = r0; r < r1; ++r) {
      const float dn = p[W + c];
      *o = div_by(dn - 2.0f * ctr + up, d, 0) + div_by(p[cp] - 2.0f * ctr + p[cm], d, 1);
      up = ctr;
      ctr = dn;
      p += W;
      o += W;
    }
  });
}

// The three KS terms at band point (r, c).
__device__ __forceinline__ void band_terms(const float* __restrict__ su,
                                           const float* __restrict__ sl, int W, int r, int c,
                                           const Divisors& d, float& lap, float& bih,
                                           float& gsq) {
  const int cm = c == 0 ? W - 1 : c - 1, cp = c == W - 1 ? 0 : c + 1;
  const float* l = sl + (r + 1) * W;
  lap = l[c];
  bih = div_by(l[c + W] - 2.0f * lap + l[c - W], d, 0) + div_by(l[cp] - 2.0f * lap + l[cm], d, 1);
  const float* p = su + (r + 2) * W;
  const float gx = div_by(p[c + W] - p[c - W], d, 2);
  const float gy = div_by(p[cp] - p[cm], d, 3);
  gsq = gx * gx + gy * gy;
}

// Call f(lap, bih, gsq, i) for the points (r0 .. r1 - 1, c) of a band, i =
// r * W + c: a walk down one column with the rows of lap and u above and
// below in registers, six loads a point.
template <typename F>
__device__ __forceinline__ void band_strip_terms(const float* __restrict__ su,
                                                 const float* __restrict__ sl, int W, int r0,
                                                 int r1, int c, const Divisors& d, F&& f) {
  const int cm = c == 0 ? W - 1 : c - 1, cp = c == W - 1 ? 0 : c + 1;
  const float* l = sl + r0 * W;        // ring row r0 is band row r0 - 1
  const float* p = su + (r0 + 1) * W;  // patch row r0 + 1 is band row r0 - 1
  float lup = l[c], lct = l[W + c], uup = p[c], uct = p[W + c];
  l += W;
  p += W;
  int i = r0 * W + c;
  for (int r = r0; r < r1; ++r) {
    const float ldn = l[W + c], udn = p[W + c];
    const float bih =
        div_by(ldn - 2.0f * lct + lup, d, 0) + div_by(l[cp] - 2.0f * lct + l[cm], d, 1);
    const float gx = div_by(udn - uup, d, 2);
    const float gy = div_by(p[cp] - p[cm], d, 3);
    f(lct, bih, gx * gx + gy * gy, i);
    lup = lct;
    lct = ldn;
    uup = uct;
    uct = udn;
    l += W;
    p += W;
    i += W;
  }
}

// Sum every thread's acc[14] in a fixed order (a shuffle tree a warp, then
// the warps in order) and write the CTA's row. `red` holds
// (blockDim.x / 32) * 14 doubles.
__device__ __forceinline__ void write_block_row(const double* acc, double* __restrict__ red,
                                                double* __restrict__ row) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kStats; ++k) {
    double v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp * kStats + k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kStats) {
    double v = 0.0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) v += red[w * kStats + threadIdx.x];
    row[threadIdx.x] = v;
  }
}

}  // namespace pdx
