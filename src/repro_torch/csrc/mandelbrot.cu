// Mandelbrot escape-time counts on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mandelbrot.py
// (`mandelbrot`, body `_kernel`): for every c of an (M, N) float32 grid,
// the number of iterations z <- z^2 + c, z0 = 0, before |z|^2 > 4, at most
// max_iters.  The TPU kernel runs the full loop on (bm, bn) VMEM tiles and
// freezes escaped lanes with a select; here one thread owns one pixel and
// leaves its loop once the pixel escapes, which gives the same count.
//
// Shapes.  The rDLB path launches the kernel once per task, on one 64 x 64
// tile, a strided view of the 512 x 512 grid (row stride `ld`); the app
// also renders the whole image at once for its task times.
//
// Design.  One warp takes a segment: 32 consecutive pixels of one row, so
// its loads coalesce; a CTA is kWarps such warps.  A 64 x 64 tile is 128
// segments, 32 CTAs on 32 SMs: one warp per scheduler, nothing to share
// issue slots with.  `stride` maps the warps of the grid onto segments
// (warp w takes segment w * stride mod n_seg); the launcher picks a stride
// near n_seg / phi, coprime to n_seg, so that the warps an SM holds at
// once come from rows all over the image and the interior-heavy rows are
// spread evenly over the SMs.
//
// The loop runs kGroup iterations between two escape tests: each
// iteration keeps the largest |z|^2 it saw (one fmaxf), and only at the
// end of the group is it compared with 4.  If the group escaped, its z is
// restored and the group replayed one iteration at a time with the exact
// test, so the count is the same as the plain loop's.  fmaxf ignores a
// NaN |z|^2 as the plain test does (NaN > 4 is false), and |z|^2 is +inf,
// not NaN, at the first overflow, so no escape is missed.
//
// What bounds it, per shape (H100 SXM: 67 TFLOP/s FP32, 1.98 GHz).
// * A 64 x 64 tile: the deepest pixel's dependent chain.  An iteration's
//   new zr needs zr*zr, then - zi*zi, then + cr: three FP32 operations of
//   about 4 cycles each, 12 cycles; 256 iterations are about 3,100 cycles,
//   1.55 us, against an operation bound of 0.14 us for the all-interior
//   tile.  With one warp per scheduler and 8 instructions an iteration
//   (3 mul, 3 add/sub, 1 fma, 1 max), the scheduler issues below the
//   chain's rate, so the chain sets the time.  The rounding cannot be
//   changed to shorten it (below).  Measured on an H100 (700 W), the
//   deepest tile takes about 2.5 us beyond what the lightest one takes
//   (the launch), 1.6x the chain floor: about 19 cycles an iteration.
// * The whole 512 x 512 image: the busiest scheduler.  Its 16.3 M pixel
//   iterations are 0.7 M warp iterations (a warp runs as long as its
//   deepest lane); spread evenly over 528 schedulers at 8 instructions
//   each they would take about 6 us, against the operation bound of
//   2.2 us (9 operations an iteration).  But the card holds the whole
//   grid at once, 16 warps a scheduler, and which warps a scheduler gets
//   is fixed at launch: the deep warps are 0.28 of all, so the busiest
//   scheduler gets well above the mean, which the stride evens out only
//   as far as chance allows.  Measured: about 15 us, 6.7x the bound.  A
//   work queue that warps claim segments from is the next step.
// Rounding: every operation is an explicit round-to-nearest intrinsic, so
// nvcc contracts nothing, except the imaginary update, which is one fused
// multiply-add, 2*zr*zi + ci.  That is the rounding the JAX reference gets
// from XLA on the CPU; the plain PyTorch version in
// repro_torch/kernels/mandelbrot.py emulates the same FMA in float64.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 4;            // warps per CTA
constexpr int kGroup = 8;            // iterations between escape tests

// One iteration: z <- z^2 + c; returns |z|^2 of the z it started from.
__device__ __forceinline__ float step(float& zr, float& zi, float cr,
                                      float ci) {
  const float zr2 = __fmul_rn(zr, zr);
  const float zi2 = __fmul_rn(zi, zi);
  const float r2 = __fadd_rn(zr2, zi2);
  const float nzr = __fadd_rn(__fsub_rn(zr2, zi2), cr);
  zi = __fmaf_rn(__fmul_rn(2.f, zr), zi, ci);
  zr = nzr;
  return r2;
}

// One iteration with the exact test: true if z has escaped (and is left
// as it was), else z <- z^2 + c.
__device__ __forceinline__ bool escaped(float& zr, float& zi, float cr,
                                        float ci) {
  const float zr2 = __fmul_rn(zr, zr);
  const float zi2 = __fmul_rn(zi, zi);
  if (__fadd_rn(zr2, zi2) > 4.f) return true;
  const float nzr = __fadd_rn(__fsub_rn(zr2, zi2), cr);
  zi = __fmaf_rn(__fmul_rn(2.f, zr), zi, ci);
  zr = nzr;
  return false;
}

__device__ __forceinline__ int escape_count(float cr, float ci,
                                            int max_iters) {
  float zr = 0.f, zi = 0.f;
  int count = 0;
  while (count <= max_iters - kGroup) {
    const float sr = zr, si = zi;
    float most = 0.f;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) most = fmaxf(most, step(zr, zi, cr, ci));
    if (most > 4.f) {                  // escaped inside the group: replay
      zr = sr;
      zi = si;
      break;
    }
    count += kGroup;
  }
  // the replay, or the last max_iters % kGroup iterations, one at a time
  for (; count < max_iters; ++count)
    if (escaped(zr, zi, cr, ci)) break;
  return count;
}

__global__ void __launch_bounds__(kWarp* kWarps)
    mandelbrot_kernel(const float* __restrict__ c_real,
                      const float* __restrict__ c_imag, long long ld,
                      int* __restrict__ out, int m, int n, int max_iters,
                      int seg_per_row, int n_seg, int stride) {
  const int w = blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (w >= n_seg) return;
  const int seg = static_cast<int>(static_cast<long long>(w) * stride % n_seg);
  const int y = seg / seg_per_row;
  const int x = (seg - y * seg_per_row) * kWarp + threadIdx.x % kWarp;
  if (x >= n) return;
  const long long at = static_cast<long long>(y) * ld + x;
  out[static_cast<long long>(y) * n + x] =
      escape_count(c_real[at], c_imag[at], max_iters);
}

long long gcd(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

}  // namespace

// c_real, c_imag: (m, n) float32 with unit column stride and row stride
// ld (elements, the same for both); out: (m, n) int32, contiguous.
extern "C" int mandelbrot_launch(const float* c_real, const float* c_imag,
                                 long long ld, int* out, int m, int n,
                                 int max_iters, cudaStream_t stream) {
  const int seg_per_row = (n + kWarp - 1) / kWarp;
  const int n_seg = m * seg_per_row;
  // the stride nearest n_seg / phi that is coprime to n_seg (1 if n_seg
  // is 1): a permutation of the segments
  long long stride = static_cast<long long>(n_seg * 0.6180339887498949);
  if (stride < 1) stride = 1;
  while (gcd(stride, n_seg) != 1) ++stride;
  const int blocks = (n_seg + kWarps - 1) / kWarps;
  mandelbrot_kernel<<<blocks, kWarp * kWarps, 0, stream>>>(
      c_real, c_imag, ld, out, m, n, max_iters, seg_per_row, n_seg,
      static_cast<int>(stride));
  return static_cast<int>(cudaGetLastError());
}
