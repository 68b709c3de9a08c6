// Single-query (decode) attention over a KV cache on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_decode`, body `_decode_kernel`): for each query row, softmax
// attention against the L slots of its cache row, where a shared (L,)
// validity mask says which slots take part.  Masked slots contribute
// nothing and a row with no valid slot returns zeros, as the TPU kernel's
// re-zeroed probabilities and its max(l, 1e-30) guard give.  Scores,
// running max m, running sum l and the accumulator are float32; the
// output is rounded once to the query's type.
//
// Layout: the query rows are (B*H, D), row b*H + h.  Keys and values are
// read through strides, so one entry point serves both the reference's
// folded (B*H, L, D) layout (H = 1) and the serving cache's own
// (B, L, KV, D) layout, where query head h reads KV head h / group: the
// caller then needs no repeat and no transpose of the cache.
//
// What bounds it: bytes.  Each valid slot's key and value rows are read
// once per query row (about 2 FLOP per byte in bf16), far below the
// card's balance point.  Design: one CTA of 256 threads per query row;
// the CTA's 32 groups of 8 lanes each own every 32nd slot, a group reads
// a key row 8 lanes wide, sums the dot product with three shuffles and
// keeps its own online-softmax state; at the end the 32 states are merged
// through shared memory in group order.  Every sum runs in a fixed order
// (no atomics), so a row's result does not depend on scheduling: rDLB
// duplicates of a request give the same tokens bit for bit.  A later PR
// can read each KV head once for its `group` query heads and split long
// caches across CTAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                       // lanes per slot group
constexpr int kGroups = kThreads / kLanes;      // 32 groups per CTA
constexpr int kMaxDim = 256;                    // largest D and Dv
constexpr int kPer = kMaxDim / kLanes;          // elements per lane
constexpr float kNegInf = -0.7f * 3.402823466e38f;  // the TPU kernel's

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const unsigned char* __restrict__ valid,
    T* __restrict__ out, int n_heads, int group, int L, int D, int Dv,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, float scale) {
  __shared__ float s_m[kGroups];
  __shared__ float s_l[kGroups];
  __shared__ float s_acc[kGroups][kMaxDim];

  const int row = blockIdx.x;
  const int b = row / n_heads;
  const int kvh = (row % n_heads) / group;
  const int lane = threadIdx.x % kLanes;
  const int gid = threadIdx.x / kLanes;
  // the 8 lanes of this group within its warp
  const unsigned mask = 0xffu << (threadIdx.x % 32 / kLanes * kLanes);

  const T* qrow = q + static_cast<long long>(row) * D;
  const T* kbase = k + b * k_sb + kvh * k_sh;
  const T* vbase = v + b * v_sb + kvh * v_sh;

  float qr[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int d = lane + p * kLanes;
    qr[p] = d < D ? to_f(qrow[d]) : 0.f;
  }
  float m = kNegInf, l = 0.f;
  float acc[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) acc[p] = 0.f;

  for (int j = gid; j < L; j += kGroups) {
    if (!valid[j]) continue;                    // uniform within a group
    const T* krow = kbase + j * k_sl;
    const T* vrow = vbase + j * v_sl;
    float dot = 0.f;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int d = lane + p * kLanes;
      if (d < D) dot = fmaf(qr[p], to_f(krow[d]), dot);
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off /= 2)
      dot += __shfl_xor_sync(mask, dot, off, kLanes);
    const float s = dot * scale;
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float pr = expf(s - m_new);
    l = l * corr + pr;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int d = lane + p * kLanes;
      if (d < Dv) acc[p] = acc[p] * corr + pr * to_f(vrow[d]);
    }
    m = m_new;
  }

  if (lane == 0) {
    s_m[gid] = m;
    s_l[gid] = l;
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int d = lane + p * kLanes;
    if (d < Dv) s_acc[gid][d] = acc[p];
  }
  __syncthreads();

  float mx = kNegInf;
  for (int g = 0; g < kGroups; ++g) mx = fmaxf(mx, s_m[g]);
  float lsum = 0.f;
  for (int g = 0; g < kGroups; ++g) lsum += s_l[g] * expf(s_m[g] - mx);
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  for (int d = threadIdx.x; d < Dv; d += kThreads) {
    float o = 0.f;
    for (int g = 0; g < kGroups; ++g) o += s_acc[g][d] * expf(s_m[g] - mx);
    out[static_cast<long long>(row) * Dv + d] = from_f<T>(o * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v,
           const unsigned char* valid, void* out, int rows, int n_heads,
           int group, int L, int D, int Dv, long long k_sb, long long k_sl,
           long long k_sh, long long v_sb, long long v_sl, long long v_sh,
           float scale, cudaStream_t stream) {
  flash_decode_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), valid, static_cast<T*>(out), n_heads,
      group, L, D, Dv, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (rows, D) contiguous, rows = B * n_heads; k, v: element strides
// (batch, slot, kv head) with unit stride along D / Dv; valid: (L,) uint8;
// out: (rows, Dv) contiguous.  dtype 0 = float32, 1 = bfloat16 (q, k, v
// and out alike).  D, Dv <= 256.
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const unsigned char* valid,
    void* out, int dtype, int rows, int n_heads, int group, int L, int D,
    int Dv, long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, float scale, cudaStream_t stream) {
  if (D > kMaxDim || Dv > kMaxDim || D < 1 || Dv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(q, k, v, valid, out, rows, n_heads, group, L, D, Dv,
                         k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, valid, out, rows, n_heads, group, L,
                                 D, Dv, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh,
                                 scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
