// FP64 tensor-core rate of each mma.sync .f64 shape on the card.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/fp64_mma_rate tools/fp64_mma_rate.cu
//   build/fp64_mma_rate
//
// Every warp of 132 x {1, 2, 4, 8} CTAs of 256 threads issues 4 independent
// chains of 4096 mma of one shape; the rate is the shape's flops over the
// CUDA-event time of the second of two launches. K2 and K4 use the shape
// this finds fastest per flop (m16n8k4 on the H100, where m8n8k4 runs at
// half the rate).
#include <cstdio>

#include <cuda_runtime.h>

__device__ __forceinline__ void m8n8k4(double (&d)[4], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}
__device__ __forceinline__ void m16n8k4(double (&d)[4], const double* a, const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
__device__ __forceinline__ void m16n8k8(double (&d)[4], const double* a, const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void m16n8k16(double (&d)[4], const double* a, const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
        "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

template <int kShape>
__global__ void rate_kernel(double* out, int iters) {
  double a[8], b[4];
  for (int i = 0; i < 8; ++i) a[i] = threadIdx.x * 1e-3 + i;
  for (int i = 0; i < 4; ++i) b[i] = threadIdx.x * 2e-3 + i;
  double d[4][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (kShape == 0) m8n8k4(d[c], a[c], b[c]);
      if (kShape == 1) m16n8k4(d[c], a + c, b + c % 4);
      if (kShape == 2) m16n8k8(d[c], a + c, b + c % 3);
      if (kShape == 3) m16n8k16(d[c], a, b);
    }
  }
  // every chain's first two sums (all that m8n8k4 writes), so none is dead code
  double sum = 0.0;
  for (int c = 0; c < 4; ++c) sum += d[c][0] + d[c][1];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

int main() {
  const char* names[] = {"m8n8k4", "m16n8k4", "m16n8k8", "m16n8k16"};
  const double flops[] = {8 * 8 * 4 * 2., 16 * 8 * 4 * 2., 16 * 8 * 8 * 2., 16 * 8 * 16 * 2.};
  void (*kernels[])(double*, int) = {rate_kernel<0>, rate_kernel<1>, rate_kernel<2>,
                                     rate_kernel<3>};
  const int iters = 4096;
  double* out = nullptr;
  if (cudaMalloc(&out, 132 * 8 * 256 * sizeof(double)) != cudaSuccess) return 1;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int k = 0; k < 4; ++k)
    for (int ctas : {132, 264, 528, 1056}) {
      kernels[k]<<<ctas, 256>>>(out, iters);
      cudaEventRecord(e0);
      kernels[k]<<<ctas, 256>>>(out, iters);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms = 0.0f;
      cudaEventElapsedTime(&ms, e0, e1);
      const double total = flops[k] * 4.0 * iters * (ctas * 8.0);
      const cudaError_t err = cudaGetLastError();
      printf("[fp64 mma] %s, %d CTAs: %.3f ms, %.1f TFLOP/s%s%s\n", names[k], ctas, ms,
             total / ms / 1e9, err == cudaSuccess ? "" : ", error: ",
             err == cudaSuccess ? "" : cudaGetErrorString(err));
      if (err != cudaSuccess) return 1;
    }
  cudaFree(out);
  return 0;
}
