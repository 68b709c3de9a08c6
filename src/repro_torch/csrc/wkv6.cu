// RWKV6 (WKV) recurrence on Hopper (sm_90a): one decode step, and the
// chunked prefill.
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//
// per (batch, head) row "bh", with a (dk, dv) float32 state.
//
// wkv6_decode_kernel replaces src/repro/kernels/rwkv6_scan.py
// (`wkv6_decode`, body `_decode_kernel`): one step.  One CTA per head;
// each thread owns columns j of the state, reads its column once, writes
// the new column (in place when the caller passes the same buffer) and
// sums y_j over i in order.  Bound by bytes: 16 KB of state read and
// 16 KB written per 64 x 64 head, against 7 FLOP per state element.
//
// wkv6_batched_kernel replaces `wkv6_batched` (body `_kernel`): T steps
// in chunks of C, the chunks in sequence inside one CTA per head with the
// state in shared memory.  Within a chunk, with la[t] the cumulative sum
// of log w over the chunk's rows 0..t (la[-1] = 0):
//   A[t][s] = sum_i r[t,i] k[s,i] exp(la[t-1,i] - la[s,i])     (s < t)
//   A[t][t] = sum_i r[t,i] u[i] k[t,i]
//   y[t]    = sum_{s<=t} A[t][s] v[s] + (r[t] * exp(la[t-1]))^T S
//   S'      = diag(exp(la[c-1])) S + sum_s (k[s] * exp(la[c-1] - la[s])) v[s]^T
// Every exponent is <= 0, so every factor is at most 1: unlike the TPU
// kernel's k * exp(-la), which overflows float32 under strong decay
// (w = 0.06 over a 32-row chunk already gives wrong outputs, 0.01 NaN),
// nothing here overflows.  The last chunk may be shorter than C, so any T
// is taken.  Bound by operations at small T: the pairwise A term costs
// C^2/2 * dk exponentials per chunk.  Every sum runs in a fixed order in
// one thread (no atomics): results do not depend on scheduling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>

extern "C" size_t wkv6_batched_smem(int dk, int dv, int chunk);

namespace {

constexpr int kDecodeThreads = 64;
constexpr int kBatchedThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kDecodeThreads) wkv6_decode_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ u, const float* state, float* __restrict__ y,
    float* state_out, int dk, int dv) {
  extern __shared__ float sm[];
  float* sr = sm;
  float* sk = sr + dk;
  float* sw = sk + dk;
  float* su = sw + dk;
  const long long bh = blockIdx.x;
  for (int i = threadIdx.x; i < dk; i += blockDim.x) {
    const long long g = bh * dk + i;
    sr[i] = to_f(r[g]);
    sk[i] = to_f(k[g]);
    sw[i] = to_f(w[g]);
    su[i] = to_f(u[g]);
  }
  __syncthreads();
  const float* S = state + bh * dk * dv;
  float* So = state_out + bh * dk * dv;
  for (int j = threadIdx.x; j < dv; j += blockDim.x) {
    const float vj = to_f(v[bh * dv + j]);
    float acc = 0.f;
    for (int i = 0; i < dk; ++i) {
      const float s = S[static_cast<long long>(i) * dv + j];
      const float kv = sk[i] * vj;
      acc += sr[i] * (s + su[i] * kv);
      So[static_cast<long long>(i) * dv + j] = sw[i] * s + kv;
    }
    y[bh * dv + j] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBatchedThreads) wkv6_batched_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ u, const float* state, float* __restrict__ y,
    float* state_out, int T_len, int dk, int dv, int chunk) {
  // rows of the (chunk, dk) arrays are padded to dk + 1 floats, so that a
  // warp reading one column of many rows hits distinct banks
  const int ld = dk + 1;
  extern __shared__ float sm[];
  float* sr = sm;                       // (chunk, ld) r, then r*exp(la[t-1])
  float* sk = sr + chunk * ld;          // (chunk, ld) k, then the k tail
  float* sla = sk + chunk * ld;         // (chunk, ld) log w, then la
  float* sv = sla + chunk * ld;         // (chunk, dv)
  float* sS = sv + chunk * dv;          // (dk, dv) the carried state
  float* sA = sS + dk * dv;             // (chunk, chunk)
  float* su = sA + chunk * chunk;       // (dk,)
  float* sdec = su + dk;                // (dk,) exp(la[c-1])
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long bh = blockIdx.x;

  for (int i = tid; i < dk; i += nt) su[i] = to_f(u[bh * dk + i]);
  for (int e = tid; e < dk * dv; e += nt) sS[e] = state[bh * dk * dv + e];

  for (int t0 = 0; t0 < T_len; t0 += chunk) {
    const int c = min(chunk, T_len - t0);
    const long long row0 = bh * T_len + t0;
    __syncthreads();
    for (int e = tid; e < c * dk; e += nt) {
      const long long g = row0 * dk + e;
      const int at = e / dk * ld + e % dk;
      sr[at] = to_f(r[g]);
      sk[at] = to_f(k[g]);
      sla[at] = logf(fmaxf(to_f(w[g]), 1e-38f));
    }
    for (int e = tid; e < c * dv; e += nt) sv[e] = to_f(v[row0 * dv + e]);
    __syncthreads();
    for (int i = tid; i < dk; i += nt) {        // la: cumulative log decay
      float a = 0.f;
      for (int t = 0; t < c; ++t) {
        a += sla[t * ld + i];
        sla[t * ld + i] = a;
      }
      sdec[i] = expf(a);
    }
    __syncthreads();
    for (int e = tid; e < c * c; e += nt) {     // A, lower triangle + diag
      const int t = e / c, s = e % c;
      if (s > t) continue;
      const float* rt = sr + t * ld;
      const float* ks = sk + s * ld;
      float acc = 0.f;
      if (s == t) {
        for (int i = 0; i < dk; ++i) acc += rt[i] * su[i] * ks[i];
      } else {
        const float* lt = sla + (t - 1) * ld;
        const float* ls = sla + s * ld;
        for (int i = 0; i < dk; ++i) acc += rt[i] * ks[i] * expf(lt[i] - ls[i]);
      }
      sA[t * chunk + s] = acc;
    }
    __syncthreads();
    for (int e = tid; e < c * dk; e += nt) {    // r and k under decay
      const int t = e / dk, i = e % dk, at = t * ld + i;
      if (t > 0) sr[at] *= expf(sla[at - ld]);
      sk[at] *= expf(sla[(c - 1) * ld + i] - sla[at]);
    }
    __syncthreads();
    for (int e = tid; e < c * dv; e += nt) {    // y
      const int t = e / dv, j = e % dv;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc += sA[t * chunk + s] * sv[s * dv + j];
      for (int i = 0; i < dk; ++i) acc += sr[t * ld + i] * sS[i * dv + j];
      y[(row0 + t) * dv + j] = acc;
    }
    __syncthreads();
    for (int e = tid; e < dk * dv; e += nt) {   // the state carried on
      const int i = e / dv, j = e % dv;
      float acc = sdec[i] * sS[e];
      for (int s = 0; s < c; ++s) acc += sk[s * ld + i] * sv[s * dv + j];
      sS[e] = acc;
    }
  }
  __syncthreads();
  for (int e = tid; e < dk * dv; e += nt) state_out[bh * dk * dv + e] = sS[e];
}

template <typename T>
int decode(const void* r, const void* k, const void* v, const void* w,
           const void* u, const float* state, float* y, float* state_out,
           int bh, int dk, int dv, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * dk;
  wkv6_decode_kernel<T><<<bh, kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), state, y, state_out, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int batched(const void* r, const void* k, const void* v, const void* w,
            const void* u, const float* state, float* y, float* state_out,
            int bh, int T_len, int dk, int dv, int chunk,
            cudaStream_t stream) {
  // Above 48 KB a kernel needs an opt-in.  It is raised per device, only
  // when a size above the largest so far is reached (and so not again
  // while a launch of a size already seen is captured into a CUDA graph),
  // under a lock: threaded replicas call this launcher concurrently.
  static std::mutex mu;
  static std::map<int, size_t> opted_in;  // device -> bytes allowed
  const size_t smem = wkv6_batched_smem(dk, dv, chunk);
  if (smem > 48 * 1024) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    std::lock_guard<std::mutex> lock(mu);
    size_t& allowed = opted_in[device];
    if (smem > allowed) {
      err = cudaFuncSetAttribute(wkv6_batched_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      allowed = smem;
    }
  }
  wkv6_batched_kernel<T><<<bh, kBatchedThreads, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), state, y, state_out, T_len, dk, dv, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory (bytes) of one wkv6_batched CTA.
extern "C" size_t wkv6_batched_smem(int dk, int dv, int chunk) {
  return sizeof(float) *
         (static_cast<size_t>(chunk) * (3 * (dk + 1) + dv) +
          static_cast<size_t>(dk) * dv + static_cast<size_t>(chunk) * chunk +
          2 * static_cast<size_t>(dk));
}

// r, k, w, u: (bh, dk); v: (bh, dv), all of one dtype (0 = float32,
// 1 = bfloat16), contiguous; state, state_out: (bh, dk, dv) float32 (may
// be the same buffer); y: (bh, dv) float32.
extern "C" int wkv6_decode_launch(const void* r, const void* k, const void* v,
                                  const void* w, const void* u,
                                  const float* state, float* y,
                                  float* state_out, int dtype, int bh, int dk,
                                  int dv, cudaStream_t stream) {
  if (dtype == 0)
    return decode<float>(r, k, v, w, u, state, y, state_out, bh, dk, dv,
                         stream);
  if (dtype == 1)
    return decode<__nv_bfloat16>(r, k, v, w, u, state, y, state_out, bh, dk,
                                 dv, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// r, k, w: (bh, T, dk); v: (bh, T, dv); u: (bh, dk), all of one dtype,
// contiguous; state, state_out: (bh, dk, dv) float32 (may be the same
// buffer); y: (bh, T, dv) float32.
extern "C" int wkv6_batched_launch(const void* r, const void* k,
                                   const void* v, const void* w,
                                   const void* u, const float* state,
                                   float* y, float* state_out, int dtype,
                                   int bh, int T_len, int dk, int dv,
                                   int chunk, cudaStream_t stream) {
  if (dtype == 0)
    return batched<float>(r, k, v, w, u, state, y, state_out, bh, T_len, dk,
                          dv, chunk, stream);
  if (dtype == 1)
    return batched<__nv_bfloat16>(r, k, v, w, u, state, y, state_out, bh,
                                  T_len, dk, dv, chunk, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
