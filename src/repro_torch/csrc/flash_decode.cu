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
// card's balance point, so the design keeps many bytes in flight on
// every SM:
// * split L: a row's L slots are cut into n_split contiguous ranges, one
//   CTA each; n_split is a function of L alone (decode_splits in
//   kernels/flash_attention.py: 1 up to 128 slots, 8 from 897), so the
//   result does not depend on the card;
// * one thread-block cluster per row: its n_split CTAs keep their
//   partial (m, l, acc); after a cluster barrier rank 0 reads the others'
//   through distributed shared memory and merges them in rank order, so
//   a call stays one launch (decode is host-bound: a second pass per
//   layer and token would cost host time), with no atomics;
// * a split, or a slot group, whose slots are all masked has m = NEG_INF
//   and l = 0 and gets weight 0 in the merge (the TPU kernel re-zeroes
//   its probabilities for the same exp(NEG_INF - NEG_INF) = 1 hazard);
// * 16-byte loads: within a CTA of 128 threads, a slot's row is read by
//   a group of 16 lanes (a bf16 row of 128 is 16 lanes x 16 B), and each
//   of the 8 groups loads the K and V rows of 4 slots (2 for head dims
//   above 128) before it uses any, so a CTA has 16 KB in flight at
//   olmo-1b's shape; the online softmax then takes one rescale per 4
//   slots.  Rows whose head dims or strides do not allow vector loads
//   take element loads (same arithmetic).
// Every sum runs in a fixed order (slots in order within a group, groups
// in order within a CTA, CTAs in rank order), so a row's result does not
// depend on scheduling: rDLB duplicates of a request give the same
// tokens bit for bit.  A later PR can read each KV head once for its
// `group` query heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 16;                      // lanes per slot row
constexpr int kGroups = kThreads / kLanes;      // 8 slot groups per CTA
constexpr int kMaxSplit = 8;                    // portable cluster size
constexpr int kMaxDim = 256;                    // largest D and Dv
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

// A lane's PER elements of a row, kept as the raw bits of T in 32-bit
// words (loaded whole, converted at use).
template <typename T> struct Raw;
template <> struct Raw<float> {
  static __device__ __forceinline__ float get(const uint32_t* w, int e) {
    return __uint_as_float(w[e]);
  }
  static __device__ __forceinline__ void put(uint32_t* w, int e,
                                             const float* p, bool in) {
    w[e] = in ? __float_as_uint(*p) : 0u;
  }
};
template <> struct Raw<__nv_bfloat16> {
  static __device__ __forceinline__ float get(const uint32_t* w, int e) {
    const uint32_t x = w[e >> 1];
    return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
  }
  static __device__ __forceinline__ void put(uint32_t* w, int e,
                                             const __nv_bfloat16* p,
                                             bool in) {
    const uint32_t bits = in ? __bfloat16_as_ushort(*p) : 0u;
    if (e & 1)
      w[e >> 1] |= bits << 16;
    else
      w[e >> 1] = bits;
  }
};

// Elements lane * PER .. lane * PER + PER - 1 of `row` (n long): one to
// four 16-byte loads (or one 8-byte load) when VEC, else element loads
// with zeros past n.
template <typename T, int PER, bool VEC>
__device__ __forceinline__ void load_seg(uint32_t (&w)[PER * sizeof(T) / 4],
                                         const T* row, int lane, int n) {
  constexpr int W = PER * sizeof(T) / 4;
  const T* p = row + lane * PER;
  if constexpr (VEC && W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else if constexpr (VEC) {
    static_assert(W == 2, "an 8-byte segment");
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = x.x;
    w[1] = x.y;
  } else {
#pragma unroll
    for (int e = 0; e < PER; ++e)
      Raw<T>::put(w, e, p + e, lane * PER + e < n);
  }
}

template <typename T, int PER, bool VEC>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const unsigned char* __restrict__ valid,
    T* __restrict__ out, int n_heads, int group, int L, int D, int Dv,
    long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, float scale, int n_split) {
  constexpr int W = PER * sizeof(T) / 4;
  constexpr int U = PER <= 8 ? 4 : 2;            // slots per group in flight
  __shared__ float s_m[kGroups];
  __shared__ float s_l[kGroups];
  __shared__ float s_acc[kGroups][kMaxDim];
  // this CTA's merged state, which rank 0 reads through the cluster
  __shared__ float c_m, c_l;
  __shared__ float c_acc[kMaxDim];

  const int split = blockIdx.x % n_split;        // the CTA's cluster rank
  const int row = blockIdx.x / n_split;
  const int b = row / n_heads;
  const int kvh = (row % n_heads) / group;
  const int lane = threadIdx.x % kLanes;
  const int gid = threadIdx.x / kLanes;
  const int chunk = (L + n_split - 1) / n_split;
  const int j0 = split * chunk;
  const int j1 = j0 + chunk < L ? j0 + chunk : L;

  const T* qrow = q + static_cast<long long>(row) * D;
  const T* kbase = k + b * k_sb + kvh * k_sh;
  const T* vbase = v + b * v_sb + kvh * v_sh;

  float qr[PER], acc[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int d = lane * PER + e;
    qr[e] = d < D ? to_f(qrow[d]) : 0.f;
    acc[e] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // the same trip count for every group, so the shuffles stay converged
  const int per_iter = kGroups * U;
  const int n_iter = j1 > j0 ? (j1 - j0 + per_iter - 1) / per_iter : 0;
  for (int it = 0; it < n_iter; ++it) {
    uint32_t kw[U][W], vw[U][W];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + (it * U + u) * kGroups + gid;
      ok[u] = j < j1 && valid[j];
      if (ok[u]) {
        load_seg<T, PER, VEC>(kw[u], kbase + j * k_sl, lane, D);
        load_seg<T, PER, VEC>(vw[u], vbase + j * v_sl, lane, Dv);
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) kw[u][i] = vw[u][i] = 0u;
      }
    }
    float s[U];
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < PER; ++e)
        dot = fmaf(qr[e], Raw<T>::get(kw[u], e), dot);
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2)
        dot += __shfl_xor_sync(0xffffffffu, dot, off, kLanes);
      s[u] = ok[u] ? dot * scale : kNegInf;
      mx = fmaxf(mx, s[u]);
    }
    const float corr = expf(m - mx);
    float p[U];
    l *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      p[u] = ok[u] ? expf(s[u] - mx) : 0.f;
      l += p[u];
    }
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      float a = acc[e] * corr;
#pragma unroll
      for (int u = 0; u < U; ++u) a = fmaf(p[u], Raw<T>::get(vw[u], e), a);
      acc[e] = a;
    }
    m = mx;
  }

  // merge the groups in order into this CTA's state
  if (lane == 0) {
    s_m[gid] = m;
    s_l[gid] = l;
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int d = lane * PER + e;
    if (d < Dv) s_acc[gid][d] = acc[e];
  }
  __syncthreads();
  float gm = kNegInf;
  for (int g = 0; g < kGroups; ++g) gm = fmaxf(gm, s_m[g]);
  float wg[kGroups];
  float lsum = 0.f;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    wg[g] = s_l[g] > 0.f ? expf(s_m[g] - gm) : 0.f;   // empty: weight 0
    lsum += wg[g] * s_l[g];
  }
  for (int d = threadIdx.x; d < Dv; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) a += wg[g] * s_acc[g][d];
    c_acc[d] = a;
  }
  if (threadIdx.x == 0) {
    c_m = gm;
    c_l = lsum;
  }

  // rank 0 merges the cluster's CTAs in rank order and writes the row
  if (n_split > 1)
    hopper::cluster_sync();
  else
    __syncthreads();
  if (split == 0) {
    auto state = [&](const float* x, int r) {
      return n_split > 1 ? hopper::ld_cluster_f32(x, r) : *x;
    };
    // ranks past n_split keep weight 0 (unrolled: the arrays stay in
    // registers)
    float rm[kMaxSplit], rw[kMaxSplit];
    float M = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      rm[r] = r < n_split ? state(&c_m, r) : kNegInf;
      M = fmaxf(M, rm[r]);
    }
    float lt = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      const float lr = r < n_split ? state(&c_l, r) : 0.f;
      rw[r] = lr > 0.f ? expf(rm[r] - M) : 0.f;       // empty: weight 0
      lt += rw[r] * lr;
    }
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    for (int d = threadIdx.x; d < Dv; d += kThreads) {
      float o = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplit; ++r)
        if (r < n_split) o += rw[r] * state(&c_acc[d], r);
      out[static_cast<long long>(row) * Dv + d] = from_f<T>(o * inv);
    }
  }
  // no CTA leaves while rank 0 may still read its shared memory
  if (n_split > 1) hopper::cluster_sync();
}

template <typename T>
bool vec_ok(const void* p, const long long* st, int per) {
  const long long a = per * static_cast<long long>(sizeof(T)) < 16
                          ? per * static_cast<long long>(sizeof(T))
                          : 16;
  if (reinterpret_cast<uintptr_t>(p) % a != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (st[i] * static_cast<long long>(sizeof(T)) % a != 0) return false;
  return true;
}

template <typename T, int PER, bool VEC>
int launch(const void* q, const void* k, const void* v,
           const unsigned char* valid, void* out, int rows, int n_heads,
           int group, int L, int D, int Dv, const long long* st,
           float scale, int n_split, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = n_split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, flash_decode_kernel<T, PER, VEC>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), valid,
      static_cast<T*>(out), n_heads, group, L, D, Dv, st[0], st[1], st[2],
      st[3], st[4], st[5], scale, n_split);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PER>
int dispatch_vec(const void* q, const void* k, const void* v,
                 const unsigned char* valid, void* out, int rows,
                 int n_heads, int group, int L, int D, int Dv,
                 const long long* st, float scale, int n_split,
                 cudaStream_t stream) {
  if (D == kLanes * PER && Dv == kLanes * PER && vec_ok<T>(k, st, PER) &&
      vec_ok<T>(v, st + 3, PER))
    return launch<T, PER, true>(q, k, v, valid, out, rows, n_heads, group,
                                L, D, Dv, st, scale, n_split, stream);
  return launch<T, PER, false>(q, k, v, valid, out, rows, n_heads, group, L,
                               D, Dv, st, scale, n_split, stream);
}

template <typename T>
int dispatch_dim(const void* q, const void* k, const void* v,
                 const unsigned char* valid, void* out, int rows,
                 int n_heads, int group, int L, int D, int Dv,
                 const long long* st, float scale, int n_split,
                 cudaStream_t stream) {
  const int dim = D > Dv ? D : Dv;
  if (dim <= 4 * kLanes)
    return dispatch_vec<T, 4>(q, k, v, valid, out, rows, n_heads, group, L,
                              D, Dv, st, scale, n_split, stream);
  if (dim <= 8 * kLanes)
    return dispatch_vec<T, 8>(q, k, v, valid, out, rows, n_heads, group, L,
                              D, Dv, st, scale, n_split, stream);
  return dispatch_vec<T, 16>(q, k, v, valid, out, rows, n_heads, group, L, D,
                             Dv, st, scale, n_split, stream);
}

}  // namespace

// q: (rows, D) contiguous, rows = B * n_heads; k, v: element strides
// (batch, slot, kv head) with unit stride along D / Dv; valid: (L,) uint8;
// out: (rows, Dv) contiguous.  dtype 0 = float32, 1 = bfloat16 (q, k, v
// and out alike).  D, Dv <= 256; 1 <= n_split <= 8 CTAs per row (one
// cluster).
extern "C" int flash_decode_launch(
    const void* q, const void* k, const void* v, const unsigned char* valid,
    void* out, int dtype, int rows, int n_heads, int group, int L, int D,
    int Dv, long long k_sb, long long k_sl, long long k_sh, long long v_sb,
    long long v_sl, long long v_sh, float scale, int n_split,
    cudaStream_t stream) {
  if (D > kMaxDim || Dv > kMaxDim || D < 1 || Dv < 1 || n_split < 1 ||
      n_split > kMaxSplit || rows < 1 || L < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[6] = {k_sb, k_sl, k_sh, v_sb, v_sl, v_sh};
  if (dtype == 0)
    return dispatch_dim<float>(q, k, v, valid, out, rows, n_heads, group, L,
                               D, Dv, st, scale, n_split, stream);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(q, k, v, valid, out, rows, n_heads,
                                       group, L, D, Dv, st, scale, n_split,
                                       stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
