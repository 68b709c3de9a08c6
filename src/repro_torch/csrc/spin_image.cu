// PSIA spin images on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/spin_image.py
// (`spin_image`, body `_kernel`): for each oriented point (center c,
// normal n) and every cloud point x, beta = n.(x - c) and
// alpha = sqrt(max(|x - c|^2 - beta^2, 0)) are binned into an
// (n_beta, n_alpha) histogram; points outside it are dropped.  The TPU
// kernel turns the histogram into one-hot matrix products for the MXU,
// because a TPU has no fast scatter.  That is not carried over: at 64 x 64
// bins a one-hot product costs 2 x 64 x 64 = 8,192 tensor-core operations
// a pair against about 24 scalar ones, 2.7e12 operations for the PSIA run
// (20,000 centers x 16,384 points), about 2.7 ms at bf16's 989 TFLOP/s,
// some 20x the scalar bound of about 0.12 ms.  Hopper has fast
// shared-memory atomics, so here the histogram is a scatter-add.
//
// Shapes.  The rDLB run hands the kernel FAC chunks of 2,500 down to 1
// centers (51 launches at P = 4, 31 of them of at most 132 centers), each
// over the same 16,384-point cloud.
//
// Design.  A center's cloud is split over `split` CTAs of one thread-block
// cluster (1 to 8, chosen in Python by `pt_split`, so that a chunk of few
// centers still fills the card).  Rank r bins the points of its range
// (ranges of a multiple of 4 points, the last one ragged) into its own
// int32 histogram in shared memory (16 KB at 64 x 64); after a cluster
// barrier, rank r sums its share of the bins over the cluster's CTAs
// through distributed shared memory and writes them as float32.  Integer
// counts make the result independent of which CTA or which atomic came
// first, so a second launch repeats the first bit for bit.  Each thread
// reads four cloud points as three float4 when the cloud is 16-byte
// aligned.  Measured and not kept (scripts/torch_spin_image_ablation.py,
// at 313 to 2,500 centers on the H100): warp-aggregated atomics
// (__match_any_sync), a larger split, two or four centers a CTA, and
// element loads where float4 ones are possible, each slower at every size.
//
// Binning.  beta, |x - c|^2 and alpha^2 are the same explicitly rounded
// operations as the plain version's.  The two bin coordinates
//   u = alpha / alpha_max * n_alpha,  v = (beta + beta_max) / 2 beta_max * n_beta
// are first formed cheaply: alpha as a2 * rsqrt(a2) and each division as
// a product with a reciprocal rounded once on the host.  floor(u) of the
// approximation equals floor(u) of the exact chain unless an integer lies
// between them, so the approximation is kept when
// floor(u (1 - kEps)) == floor(u (1 + kEps)): no integer lies within
// kEps |u| of it.  kEps bounds the relative gap between the two chains:
// the reciprocal square root is within 2 ulp, 2^-22 (rsqrtf's documented
// bound, CUDA Programming Guide, single-precision functions; rsqrtf is
// this same rsqrt.approx instruction on inputs >= FLT_MIN, which a2 is
// clamped to), and the products, the reciprocal and the exact chain's
// sqrt, division and product round 6 times, 2^-24 each: 10 x 2^-24 in
// all, and kEps = 2^-19 is more than twice that.  Otherwise (a coordinate
// within kEps of a bin edge or of a range end) the pair takes the
// correctly rounded chain, __fsqrt_rn and __fdiv_rn.  Either way the bin
// is the plain version's, bin for bin; about 2.3e-4 of the PSIA run's
// pairs take the exact chain.  The floors come from one round-down FMA
// each (floor_magic), not from conversion instructions, which issue at a
// quarter of the FP32 rate.
//
// What bounds it: at the paper's 20,000 centers x 16,384 points it is
// 3.3e8 point-center pairs of about 24 FP32 operations each (0.12 ms at
// 67 TFLOP/s), against 327.68 MB of histograms written (0.098 ms at
// 3.35 TB/s).  The cloud (196 KB) stays in L2.  What holds the kernel
// back at a large chunk is the instructions of each pair, measured by
// taking one part out at a time (scripts/torch_spin_image_ablation.py):
// at 2,500 centers the atomic add is about a quarter of the time and the
// guard's second floor and compare about a fifth; reading the cloud from
// L1 instead of L2, or adds without contention, save nothing.  PERF.md
// gives the measured times beside the bound at every chunk size.

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSplit = 8;                 // portable cluster size
constexpr float kEps = 0x1p-19f;

struct Bins {
  int n_alpha, n_beta;
  float fa, fb;                  // n_alpha, n_beta as floats
  float alpha_max, beta_max, two_beta_max;
  float ka, kb;                  // n_alpha / alpha_max, n_beta / 2 beta_max
  float top_a, top_b;            // n_alpha + 0.5, n_beta + 0.5
};

// M + floor(x y) for -2^22 <= x y < 2^22: the exact x y + M rounded
// down lands where floats are one apart, so the low mantissa bits of one
// FMA are floor(x y), with no conversion instruction (those issue at a
// quarter of the FP32 rate).
constexpr float kMagic = 0x1.8p23f;

__device__ __forceinline__ float floor_magic(float x, float y) {
  return __fmaf_rd(x, y, kMagic);
}

// The approximate coordinate x, clamped to [-0.5, n + 0.5], and whether
// no integer lies within kEps |x| of it: then floor_magic gives its bin
// (or a value outside [0, n), which drops the point).  A NaN x is
// clamped to -0.5, outside the histogram, as the exact chain's NaN is.
__device__ __forceinline__ bool coarse_bin(float x, float top, float& bin) {
  x = fminf(fmaxf(x, -0.5f), top);
  bin = floor_magic(x, 1.f - kEps);
  return bin == floor_magic(x, 1.f + kEps);
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void add(int* hist, int idx) {
  if (idx >= 0) atomicAdd(&hist[idx], 1);
}

// The bin of cloud point (px, py, pz) for center c and normal nrm, or -1
// when it falls outside the histogram.
__device__ __forceinline__ int bin_of(float px, float py, float pz,
                                      const float* c, const float* nrm,
                                      const Bins& s) {
  const float dx = __fsub_rn(px, c[0]);
  const float dy = __fsub_rn(py, c[1]);
  const float dz = __fsub_rn(pz, c[2]);
  const float beta = __fadd_rn(
      __fadd_rn(__fmul_rn(dx, nrm[0]), __fmul_rn(dy, nrm[1])),
      __fmul_rn(dz, nrm[2]));
  const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  const float a2 = fmaxf(__fsub_rn(r2, __fmul_rn(beta, beta)), 0.f);
  const float t = __fadd_rn(beta, s.beta_max);
  // alpha = a2 * rsqrt(a2), the rsqrt taken of a2 >= FLT_MIN (no
  // denormal input): a smaller a2 gives u below 1e-18, bin 0 either way
  const float alpha = __fmul_rn(a2, rsqrt_approx(fmaxf(a2, 1.17549435e-38f)));
  float fa, fb;
  if (coarse_bin(__fmul_rn(alpha, s.ka), s.top_a, fa) &&
      coarse_bin(__fmul_rn(t, s.kb), s.top_b, fb)) {
    const int ia = __float_as_int(fa) - __float_as_int(kMagic);
    const int ib = __float_as_int(fb) - __float_as_int(kMagic);
    if (static_cast<unsigned>(ia) < static_cast<unsigned>(s.n_alpha) &&
        static_cast<unsigned>(ib) < static_cast<unsigned>(s.n_beta))
      return ib * s.n_alpha + ia;
    return -1;
  }
  const float af =
      floorf(__fmul_rn(__fdiv_rn(__fsqrt_rn(a2), s.alpha_max), s.fa));
  const float bf = floorf(__fmul_rn(__fdiv_rn(t, s.two_beta_max), s.fb));
  // the range test on the floored floats, before any conversion to int,
  // so that a huge or NaN coordinate cannot overflow it
  if (af >= 0.f && af < s.fa && bf >= 0.f && bf < s.fb)
    return static_cast<int>(bf) * s.n_alpha + static_cast<int>(af);
  return -1;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    spin_image_kernel(const float* __restrict__ points, int n_points,
                      const float* __restrict__ centers,
                      const float* __restrict__ normals,
                      float* __restrict__ out, Bins s, int split) {
  extern __shared__ int hist[];
  const int n_bins = s.n_alpha * s.n_beta;
  const int b = blockIdx.x / split;          // the center
  const int rank = blockIdx.x % split;       // the CTA's cluster rank
  for (int i = threadIdx.x; i < n_bins; i += kThreads) hist[i] = 0;
  float c[3], nrm[3];
  for (int k = 0; k < 3; ++k) {
    c[k] = centers[3 * b + k];
    nrm[k] = normals[3 * b + k];
  }
  // this rank's points [p0, p1): ranges of a multiple of 4 points
  const int per = ((n_points + split - 1) / split + 3) / 4 * 4;
  const int p0 = min(n_points, rank * per);
  const int p1 = min(n_points, p0 + per);
  __syncthreads();
  int p = p0 + threadIdx.x;
  if (VEC) {
    // 4 points (three float4) a thread over [p0, pv); p0 is a multiple of
    // 4 (or the range is empty) and the cloud 16-byte aligned (checked by
    // the launcher)
    const float4* quads = reinterpret_cast<const float4*>(points);
    const int pv = p0 + (p1 - p0) / 4 * 4;
    for (int q = p0 / 4 + threadIdx.x; q < pv / 4; q += kThreads) {
      const float4 a = quads[3 * q], d = quads[3 * q + 1],
                   e = quads[3 * q + 2];
      add(hist, bin_of(a.x, a.y, a.z, c, nrm, s));
      add(hist, bin_of(a.w, d.x, d.y, c, nrm, s));
      add(hist, bin_of(d.z, d.w, e.x, c, nrm, s));
      add(hist, bin_of(e.y, e.z, e.w, c, nrm, s));
    }
    p = pv + threadIdx.x;                    // the ragged end
  }
  for (; p < p1; p += kThreads) {
    add(hist, bin_of(points[3 * p], points[3 * p + 1], points[3 * p + 2], c,
                     nrm, s));
  }
  float* dst = out + static_cast<long long>(b) * n_bins;
  if (split == 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_bins; i += kThreads)
      dst[i] = static_cast<float>(hist[i]);
    return;
  }
  // every rank's histogram is complete: rank r sums bins [i0, i1) over
  // the cluster, then waits until no rank reads its shared memory any more
  hopper::cluster_sync();
  const int share = (n_bins + split - 1) / split;
  const int i1 = min(n_bins, (rank + 1) * share);
  for (int i = rank * share + threadIdx.x; i < i1; i += kThreads) {
    int sum = 0;
    for (int r = 0; r < split; ++r) sum += hopper::ld_cluster_s32(&hist[i], r);
    dst[i] = static_cast<float>(sum);
  }
  hopper::cluster_sync();
}

template <bool VEC>
int launch(const float* points, int n_points, const float* centers,
           const float* normals, float* out, int n_centers, const Bins& s,
           int split, cudaStream_t stream) {
  const size_t smem = sizeof(int) * static_cast<size_t>(s.n_alpha) * s.n_beta;
  auto kernel = spin_image_kernel<VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_centers) * split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, points, n_points,
                                             centers, normals, out, s, split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// points: (n_points, 3) float32; centers, normals: (n_centers, 3) float32;
// out: (n_centers, n_beta, n_alpha) float32; all contiguous.  `split` CTAs
// (one cluster, 1 to 8, from Python's pt_split) share a center's cloud.
extern "C" int spin_image_launch(const float* points, int n_points,
                                 const float* centers, const float* normals,
                                 float* out, int n_centers, int n_alpha,
                                 int n_beta, float alpha_max, float beta_max,
                                 int split, cudaStream_t stream) {
  if (split < 1 || split > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  Bins s;
  s.n_alpha = n_alpha;
  s.n_beta = n_beta;
  s.fa = static_cast<float>(n_alpha);
  s.fb = static_cast<float>(n_beta);
  s.alpha_max = alpha_max;
  s.beta_max = beta_max;
  s.two_beta_max = 2.f * beta_max;           // exact, as __fmul_rn(2, bm)
  s.ka = static_cast<float>(static_cast<double>(s.fa) / alpha_max);
  s.kb = static_cast<float>(static_cast<double>(s.fb) / s.two_beta_max);
  s.top_a = s.fa + 0.5f;
  s.top_b = s.fb + 0.5f;
  // float4 reads of the cloud need it 16-byte aligned
  if (reinterpret_cast<uintptr_t>(points) % 16 == 0)
    return launch<true>(points, n_points, centers, normals, out, n_centers, s,
                        split, stream);
  return launch<false>(points, n_points, centers, normals, out, n_centers, s,
                       split, stream);
}
