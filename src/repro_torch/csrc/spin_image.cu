// PSIA spin images on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/spin_image.py
// (`spin_image`, body `_kernel`): for each oriented point (center c,
// normal n) and every cloud point x, beta = n.(x - c) and
// alpha = sqrt(max(|x - c|^2 - beta^2, 0)) are binned into an
// (n_beta, n_alpha) histogram; points outside it are dropped.  The TPU
// kernel turns the histogram into one-hot matrix products for the MXU,
// because a TPU has no fast scatter.  Hopper has fast shared-memory
// atomics, so here the histogram is a plain scatter-add.
//
// Design: one block per center, 256 threads striding over the cloud, an
// int32 histogram of n_beta * n_alpha bins in shared memory (16 KB at
// 64 x 64), written out as float32 at the end.  Integer counts make the
// result independent of the order in which the atomics land.
//
// What bounds it: at the paper's 20,000 centers x 16,384 points it is
// 3.3e8 point-center pairs of about 24 FP32 operations each, against
// 327.68 MB of histograms written; the two bounds are about equal on an
// H100.  The cloud (16,384 x 12 B = 196 KB) is read by every block and
// stays in L2, so device memory sees it once.
//
// Rounding: each operation is an explicit round-to-nearest intrinsic in
// the order of the plain PyTorch version (repro_torch/kernels/
// spin_image.py), so nvcc contracts nothing and the two agree bin for bin.
// The range test is done on the floored float values, before any
// conversion to int, so a huge or NaN coordinate cannot overflow it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void spin_image_kernel(const float* __restrict__ points,
                                  int n_points,
                                  const float* __restrict__ centers,
                                  const float* __restrict__ normals,
                                  float* __restrict__ out, int n_alpha,
                                  int n_beta, float alpha_max,
                                  float beta_max) {
  extern __shared__ int hist[];
  const int n_bins = n_alpha * n_beta;
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < n_bins; i += kThreads) hist[i] = 0;
  const float cx = centers[3 * b], cy = centers[3 * b + 1],
              cz = centers[3 * b + 2];
  const float nx = normals[3 * b], ny = normals[3 * b + 1],
              nz = normals[3 * b + 2];
  const float two_beta_max = __fmul_rn(2.f, beta_max);
  const float fa = static_cast<float>(n_alpha);
  const float fb = static_cast<float>(n_beta);
  __syncthreads();
  for (int p = threadIdx.x; p < n_points; p += kThreads) {
    const float dx = __fsub_rn(points[3 * p], cx);
    const float dy = __fsub_rn(points[3 * p + 1], cy);
    const float dz = __fsub_rn(points[3 * p + 2], cz);
    const float beta = __fadd_rn(
        __fadd_rn(__fmul_rn(dx, nx), __fmul_rn(dy, ny)), __fmul_rn(dz, nz));
    const float r2 = __fadd_rn(
        __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    const float alpha =
        __fsqrt_rn(fmaxf(__fsub_rn(r2, __fmul_rn(beta, beta)), 0.f));
    const float af = floorf(__fmul_rn(__fdiv_rn(alpha, alpha_max), fa));
    const float bf = floorf(
        __fmul_rn(__fdiv_rn(__fadd_rn(beta, beta_max), two_beta_max), fb));
    if (af >= 0.f && af < fa && bf >= 0.f && bf < fb) {
      atomicAdd(&hist[static_cast<int>(bf) * n_alpha + static_cast<int>(af)],
                1);
    }
  }
  __syncthreads();
  float* dst = out + static_cast<long long>(b) * n_bins;
  for (int i = threadIdx.x; i < n_bins; i += kThreads) {
    dst[i] = static_cast<float>(hist[i]);
  }
}

}  // namespace

// points: (n_points, 3) float32; centers, normals: (n_centers, 3) float32;
// out: (n_centers, n_beta, n_alpha) float32; all contiguous.
extern "C" int spin_image_launch(const float* points, int n_points,
                                 const float* centers, const float* normals,
                                 float* out, int n_centers, int n_alpha,
                                 int n_beta, float alpha_max, float beta_max,
                                 cudaStream_t stream) {
  const size_t smem = sizeof(int) * static_cast<size_t>(n_alpha) * n_beta;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        spin_image_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  spin_image_kernel<<<n_centers, kThreads, smem, stream>>>(
      points, n_points, centers, normals, out, n_alpha, n_beta, alpha_max,
      beta_max);
  return static_cast<int>(cudaGetLastError());
}
