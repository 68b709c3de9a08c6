// Mandelbrot escape-time counts on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mandelbrot.py
// (`mandelbrot`, body `_kernel`): for every c of an (M, N) float32 grid,
// the number of iterations z <- z^2 + c, z0 = 0, before |z|^2 > 4, at most
// max_iters.  The TPU kernel runs the full loop on (bm, bn) VMEM tiles and
// freezes escaped lanes with a select; here one thread owns one pixel and
// leaves its loop once the pixel escapes, which gives the same count.
//
// What bounds it: FP32 arithmetic.  It reads 8 B and writes 4 B per pixel,
// and does 9 FP32 operations per iteration (3 mul, 3 add/sub, 1 compare,
// 1 FMA counted as 2); the iterations a grid
// needs are the sum of its escape counts, so the work depends on the data.
// At the paper's 512 x 512 grid the whole image is microseconds of work,
// below a launch's own overhead.  The design does nothing clever about it:
// 16 x 16 blocks, 1024 of them at 512 x 512, enough to fill 132 SMs, and
// the ragged edge masked so that any (M, N) is taken.
//
// Rounding: every operation is an explicit round-to-nearest intrinsic, so
// nvcc contracts nothing, except the imaginary update, which is one fused
// multiply-add, 2*zr*zi + ci.  That is the rounding the JAX reference gets
// from XLA on the CPU; the plain PyTorch version in
// repro_torch/kernels/mandelbrot.py emulates the same FMA in float64.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 16;

__global__ void mandelbrot_kernel(const float* __restrict__ c_real,
                                  const float* __restrict__ c_imag,
                                  int* __restrict__ out, int m, int n,
                                  int max_iters) {
  const int x = blockIdx.x * kBlock + threadIdx.x;
  const int y = blockIdx.y * kBlock + threadIdx.y;
  if (x >= n || y >= m) return;
  const long long idx = static_cast<long long>(y) * n + x;
  const float cr = c_real[idx];
  const float ci = c_imag[idx];
  float zr = 0.f, zi = 0.f;
  int count = 0;
  for (; count < max_iters; ++count) {
    const float zr2 = __fmul_rn(zr, zr);
    const float zi2 = __fmul_rn(zi, zi);
    if (__fadd_rn(zr2, zi2) > 4.f) break;
    const float nzr = __fadd_rn(__fsub_rn(zr2, zi2), cr);
    const float nzi = __fmaf_rn(__fmul_rn(2.f, zr), zi, ci);
    zr = nzr;
    zi = nzi;
  }
  out[idx] = count;
}

}  // namespace

// c_real, c_imag: (m, n) float32, contiguous; out: (m, n) int32.
extern "C" int mandelbrot_launch(const float* c_real, const float* c_imag,
                                 int* out, int m, int n, int max_iters,
                                 cudaStream_t stream) {
  const dim3 block(kBlock, kBlock);
  const dim3 grid((n + kBlock - 1) / kBlock, (m + kBlock - 1) / kBlock);
  mandelbrot_kernel<<<grid, block, 0, stream>>>(c_real, c_imag, out, m, n,
                                                max_iters);
  return static_cast<int>(cudaGetLastError());
}
