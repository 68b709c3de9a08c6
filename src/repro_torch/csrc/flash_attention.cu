// Full-sequence attention (training and prefill) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_kernel`): for every query row, softmax
// attention over the keys it may see (all of them, or keys 0..row when
// causal), with the scores, running max m, running sum l and the
// accumulator in float32 and the output rounded once to the inputs' type.
// Besides the output it writes each row's float32 log-sum-exp
// m + log(l), which the backward (PyTorch ops, kernels/flash_attention.py)
// needs to rebuild the probabilities.
//
// Layout: q (B, S, H, D), k (B, S, KV, D), v (B, S, KV, Dv), read through
// element strides (batch, position, head) with unit stride along the head
// dim, query head h reading KV head h / group: the model's own layout,
// with no repeat and no transpose of K and V.  The reference's per-head
// (B, S, D) layout is H = KV = 1.  out is (B, S, H, Dv) and lse (B, H, S),
// both contiguous.
//
// Tiling: one CTA of 256 threads per (batch, head, tile of 64 query rows).
// The CTA keeps its query tile in shared memory and walks the key tiles
// of 64 in order; K and then V of a tile are staged in one shared buffer
// (as float32).  Thread (ty, tx), ty = tid / 16, tx = tid % 16, owns query
// rows 4 ty .. 4 ty + 3; it computes their scores against keys tx + 16 j
// (j < 4), the 16 threads of a row group reduce max and sum with
// shuffles, the probabilities go through shared memory, and the thread
// accumulates output columns tx + 16 c (c < NV).  When causal, key tiles
// past the query tile's last row are skipped (the Pallas kernel's
// `pl.when`), and the query tiles with most work are scheduled first.
// Any S: rows and keys past S are masked (the reference asserts
// S % block == 0, a TPU block constraint).  Head dims up to 256, Dv may
// differ from D.  Masked probabilities are set to 0 and l is guarded by
// max(l, 1e-30), as in the TPU kernel, so a masked key adds nothing.
//
// What bounds it: operations.  At olmo-1b's shape (16 heads, S = 2048,
// D = 128, causal) the work is about 17 GFLOP against 34 MB of inputs and
// outputs.  This kernel runs the products on the CUDA cores in float32,
// reading both operands from shared memory; the tensor cores (wgmma, with
// TMA loads) are the way to the card's bf16 rate and are left to a later
// version.  Every sum runs in a fixed order in one thread or one shuffle
// tree (no atomics), so duplicated rDLB tasks give bit-identical output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                          // query rows per CTA
constexpr int kBK = 64;                          // keys per tile
constexpr int kRows = kBQ / 16;                  // rows per thread
constexpr int kCols = kBK / 16;                  // score columns per thread
constexpr int kMaxDim = 256;                     // largest D and Dv
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

// Sum or max over the 16 lanes of a row group (lanes 0-15 or 16-31).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Shared memory: query tile (kBQ x ld), K or V tile (kBK x ld), and the
// probabilities (kBQ x (kBK + 1)); ld = max(D, Dv) + 1 floats, the odd
// row pitch putting the 16 key rows a warp reads in distinct banks.
size_t smem_bytes(int D, int Dv) {
  const size_t ld = static_cast<size_t>(D > Dv ? D : Dv) + 1;
  return sizeof(float) * ((kBQ + kBK) * ld + kBQ * (kBK + 1));
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    int S, int H, int group, int D, int Dv, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh, float scale,
    int causal) {
  extern __shared__ float smem[];
  const int ld = (D > Dv ? D : Dv) + 1;
  float* qs = smem;                       // kBQ x ld
  float* kvs = qs + kBQ * ld;             // kBK x ld
  float* ps = kvs + kBK * ld;             // kBQ x (kBK + 1)
  constexpr int ldp = kBK + 1;

  const int n_qt = (S + kBQ - 1) / kBQ;
  // heavier (later) query tiles first when causal
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * kBQ;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / group;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const T* qbase = q + b * q_sb + h * q_sh;
  const T* kbase = k + b * k_sb + kvh * k_sh;
  const T* vbase = v + b * v_sb + kvh * v_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    qs[r * ld + d] = s < S ? to_f(qbase[s * q_ss + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][NV];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) acc[i][c] = 0.f;
  }
  bool col_ok[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) col_ok[c] = tx + 16 * c < Dv;

  const int q_last = (q0 + kBQ < S ? q0 + kBQ : S) - 1;
  const int n_kt_all = (S + kBK - 1) / kBK;
  const int n_kt = causal ? q_last / kBK + 1 : n_kt_all;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();                      // last tile's V reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int s = k0 + r;
      kvs[r * ld + d] = s < S ? to_f(kbase[s * k_ss + d]) : 0.f;
    }
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty * kRows + i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = kvs[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const int qpos = q0 + r;
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < S && (!causal || kpos <= qpos);
        sc[i][j] = ok[j] ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        ps[r * ldp + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * corr + group_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NV; ++c) acc[i][c] *= corr;
    }
    __syncthreads();                      // K reads done, ps complete

    for (int i = tid; i < kBK * Dv; i += kThreads) {
      const int r = i / Dv, d = i % Dv;
      const int s = k0 + r;
      kvs[r * ld + d] = s < S ? to_f(vbase[s * v_sl + d]) : 0.f;
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty * kRows + i) * ldp + kk];
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const float vv = col_ok[c] ? kvs[kk * ld + tx + 16 * c] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = q0 + ty * kRows + i;
    if (s >= S) continue;
    const float lg = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lg;
    T* orow = out + ((static_cast<long long>(b) * S + s) * H + h) * Dv;
#pragma unroll
    for (int c = 0; c < NV; ++c)
      if (col_ok[c]) orow[tx + 16 * c] = from_f<T>(acc[i][c] * inv);
    if (tx == 0)
      lse[(static_cast<long long>(b) * H + h) * S + s] = m[i] + logf(lg);
  }
}

// Above 48 KB a kernel needs an opt-in.  It is raised per (device,
// kernel), only when a size above the largest so far is reached (and so
// not again while a launch of a size already seen is captured into a CUDA
// graph), under a lock: rDLB worker threads call this launcher
// concurrently.
cudaError_t opt_in(const void* kernel, size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> allowed;
  if (smem <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  size_t& have = allowed[{device, kernel}];
  if (smem > have) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    have = smem;
  }
  return cudaSuccess;
}

template <typename T, int NV>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int H, int group, int D, int Dv,
           const long long* st, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D, Dv);
  auto kernel = flash_attention_kernel<T, NV>;
  cudaError_t err = opt_in(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, H, group, D,
      Dv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dv(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int S, int H, int group, int D, int Dv,
                const long long* st, float scale, int causal,
                cudaStream_t stream) {
  if (Dv <= 64)
    return launch<T, 4>(q, k, v, out, lse, B, S, H, group, D, Dv, st, scale,
                        causal, stream);
  if (Dv <= 128)
    return launch<T, 8>(q, k, v, out, lse, B, S, H, group, D, Dv, st, scale,
                        causal, stream);
  return launch<T, 16>(q, k, v, out, lse, B, S, H, group, D, Dv, st, scale,
                       causal, stream);
}

}  // namespace

// Dynamic shared memory (bytes) of one flash_attention CTA.
extern "C" size_t flash_attention_smem(int D, int Dv) {
  return smem_bytes(D, Dv);
}

// q: (B, S, H, D), k: (B, S, KV, D), v: (B, S, KV, Dv) with element
// strides (batch, position, head) and unit stride along the head dim,
// H = KV * group; out: (B, S, H, Dv) contiguous; lse: (B, H, S) float32
// contiguous.  dtype 0 = float32, 1 = bfloat16 (q, k, v and out alike).
// 1 <= D, Dv <= 256; causal 0 or 1.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int dtype, int B, int S, int H, int group, int D, int Dv, int causal,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, cudaStream_t stream) {
  if (D < 1 || Dv < 1 || D > kMaxDim || Dv > kMaxDim || group < 1 ||
      H % group != 0 || B < 1 || S < 1 || (S + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh};
  if (dtype == 0)
    return dispatch_dv<float>(q, k, v, out, lse, B, S, H, group, D, Dv, st,
                              scale, causal, stream);
  if (dtype == 1)
    return dispatch_dv<__nv_bfloat16>(q, k, v, out, lse, B, S, H, group, D,
                                      Dv, st, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
