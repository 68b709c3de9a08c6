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
// both contiguous.  When causal, key tiles past a query tile's last row
// are skipped (the Pallas kernel's `pl.when`) and the query tiles with
// most work are scheduled first.  Any S: rows and keys past S are masked
// (the reference asserts S % block == 0, a TPU block constraint).  Every
// sum runs in a fixed order in one thread, one shuffle tree or one wgmma
// (no atomics), so duplicated rDLB tasks give bit-identical output.
//
// What bounds it: operations.  At olmo-1b's shape (16 heads, S = 2048,
// D = 128, causal) the work is about 17 GFLOP against 34 MB of inputs and
// outputs.  Two variants.  The caller chooses one from the inputs
// (`attention_variant` in kernels/flash_attention.py: dtype, head dims and
// whether TMA can load the tensors, never because something failed) and
// passes it; the launcher checks that the inputs allow it:
//
// * "wgmma" -- bfloat16 with (D, Dv) in {(64, 64), (128, 128), (192, 128),
//   (256, 256)}, 16-byte aligned bases and strides (TMA's rule): the
//   products on the tensor cores.  One CTA per (batch, head, 64 WG query
//   rows): one producer warp starts TMA loads (128-byte swizzle) of the
//   query tile once and of each K and V tile of 64 keys into a ring of
//   two stages guarded by mbarriers (one warpgroup releases a stage's K a
//   tile before its V, so each has its own empty barrier there); WG
//   consumer warpgroups of 64 query rows each compute S = Q K^T with
//   wgmma from shared memory (float32 accumulators, D / 16 steps of 16
//   over D / 64 swizzled chunks), mask and run the online softmax in
//   registers in float32, add l from the float32 probabilities, round P
//   to bfloat16 in registers and add O += P V with wgmma of N = Dv (A
//   from registers, V MN-major from shared memory); O stays in float32
//   registers until the epilogue.  WG is 2 at D = 64 and 128, which go
//   tile by tile (S, softmax, P V), the two warpgroups overlapping each
//   other.  WG is 1 at D = 192 and 256, whose warpgroup runs its tiles as
//   FlashAttention-3's intra-warpgroup pipeline: the softmax of tile
//   kt + 1 runs on the CUDA cores while P V of tile kt runs on the tensor
//   cores.  At Dv = 256, O alone takes 128 float32 registers a thread:
//   with S and P that fits only the 255 of a 160-thread CTA (see
//   warpgroups() for the budgets).  Rounding P to bfloat16 is what the
//   reference did on its own chip: the TPU kernel's float32 dot_general
//   at default precision feeds the TPU's matrix unit bfloat16 operands.
//   Its effect is at most 2^-8 (Sum_j p_j |v_j|) / l per output element;
//   the plain helper `bf16_p_bound` gives twice that.  The ragged tail of
//   S arrives from TMA as zeros and is masked as above.
// * "fp32" -- float32 inputs (the float32 check copies need exact float32
//   products), and bfloat16 at any other (D, Dv) up to 256 (head dims
//   that are not multiples of 64, such as the smoke configs' 16 and 24,
//   or 96) or with strides TMA cannot take (it reads through any
//   strides):
//   one CTA of 256 threads per (batch, head, 64 query rows), K and then V
//   of a tile of 64 keys staged in shared memory as float32, products on
//   the CUDA cores.  Thread (ty, tx), ty = tid / 16, tx = tid % 16, owns
//   query rows 4 ty .. 4 ty + 3; it computes their scores against keys
//   tx + 16 j (j < 4), the 16 threads of a row group reduce max and sum
//   with shuffles, the probabilities go through shared memory, and the
//   thread accumulates output columns tx + 16 c (c < NV).  Masked
//   probabilities are set to 0 and l is guarded by max(l, 1e-30), as in
//   the TPU kernel, so a masked key adds nothing.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include "hopper.cuh"

namespace {

// ============================================================= fp32 variant
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

// ============================================================ wgmma variant
namespace wg {

using namespace hopper;

constexpr int kBK = 64;                         // keys per tile
constexpr int kStages = 2;                      // K/V ring
constexpr int kChunk = 64;      // head-dim elements per 128-byte smem row
constexpr int kRowBytes = 128;
constexpr float kLn2 = 0.6931471805599453f;

// One instance: head dims D (Q, K) and DV (V, out), WG consumer
// warpgroups of 64 query rows each and one producer warp.  Shared
// memory, from a 1024-byte aligned base: the query tile as NC chunks of
// kBQ rows x 128 bytes, then kStages K tiles (NC chunks of kBK rows x 128
// bytes) and kStages V tiles (NCV chunks), then the mbarriers: q_full,
// and per stage k_full, v_full, k_empty and v_empty (two warpgroups
// release K and V together, on k_empty).
template <int D, int DV, int WG>
struct Cfg {
  static constexpr int kBQ = 64 * WG;           // query rows per CTA
  static constexpr int kThreads = 128 * WG + 32;
  static constexpr int NC = D / kChunk;
  static constexpr int NCV = DV / kChunk;
  static constexpr int kQBytes = NC * kBQ * kRowBytes;
  static constexpr int kKBytes = NC * kBK * kRowBytes;
  static constexpr int kVBytes = NCV * kBK * kRowBytes;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kKBytes;
  static constexpr int kBar = kV + kStages * kVBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;
  // CTAs an SM can hold by shared memory (228 KB, 1 KB of it reserved a
  // CTA), at most 2: registers are budgeted for that many (launch
  // bounds).  Only a one-warpgroup instance asks for 2.
  static constexpr int kPerSm =
      WG == 1 && 2 * (kBytes + 1024) <= 228 * 1024 ? 2 : 1;
};

// Consumer warpgroups of the (D, DV) instance: 1 for the head dims above
// 128, 2 for 64 and 128.  One warpgroup runs its key tiles as a pipeline
// (S of the next tile in flight beside P V of this one), which needs
// registers for O, S, P and the next tile's S: at DV = 256 nearly all of
// the 255 a thread of a 160-thread CTA may have; at (192, 128) few enough
// for two CTAs an SM.  ptxas gives a thread of the 288-thread
// two-warpgroup CTA at most 168, enough for 64 and 128 tile by tile but
// not for the pipeline (it spilled).  One warpgroup also gives
// paligemma's 1000-token prefill (8 heads) 128 CTAs for the 132 SMs
// rather than 64.
constexpr int warpgroups(int D) { return D > 128 ? 1 : 2; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Issues S (64 x 64) = Q K^T for one consumer warpgroup: D / 16 wgmma
// steps of 16, step kk reading 32 bytes at (kk % 4) * 32 of chunk kk / 4
// of the warpgroup's query rows (qa, chunks kBQ rows apart) and of the
// key tile (kb, chunks kBK rows apart).
template <int D, int kBQ>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t qa,
                                         uint32_t kb) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_ss(
        sc, desc_b128(qa + (kk / 4) * kBQ * kRowBytes + (kk % 4) * 32, 16,
                      1024),
        desc_b128(kb + (kk / 4) * kBK * kRowBytes + (kk % 4) * 32, 16, 1024),
        kk > 0);
}

// Issues O (64 x DV) += P (64 x 64, registers) V (64 x DV, shared memory
// at vb) for one consumer warpgroup: 4 wgmma steps of 16 keys (16 smem
// rows) with N = DV; the next 64 columns of V are the next chunk, kBK
// rows further on (the leading byte offset).
template <int DV>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2],
                                         const uint32_t (&pa)[kBK / 16][4],
                                         uint32_t vb) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t desc =
        desc_b128(vb + kk * 16 * kRowBytes, kBK * kRowBytes, 1024);
    if constexpr (DV == 256)
      wgmma_m64n256k16_rs(o, pa[kk], desc, 1);
    else if constexpr (DV == 128)
      wgmma_m64n128k16_rs(o, pa[kk], desc, 1);
    else
      wgmma_m64n64k16_rs(o, pa[kk], desc, 1);
  }
}

// The online softmax of one score tile in registers, in place: turns the
// raw scores sc into the tile's float32 probabilities 2^(x - m), x the
// score in the log2 domain with keys past S and (causal) past the row
// masked, updates the running max m and sum l, and returns in corr the
// factors O's two rows must be scaled by.  Masked scores are kNegInf:
// 2^(kNegInf - m) is 0 once the row has a finite max; before that every
// score of the row is masked.
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float scale_log2, int k0,
                                             int r_lo, int row0, int col0,
                                             int S, int causal) {
  // the tile has keys past S or, causal, past the warpgroup's first row
  const bool need_mask = k0 + kBK > S || (causal && k0 + kBK - 1 > r_lo);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = sc[i] * scale_log2;
    if (need_mask) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int col = k0 + 8 * (i >> 2) + col0 + (i & 1);
      if (col >= S || (causal && col > row)) x = kNegInf;
    }
    sc[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float m_new[2], psum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_new[r] = fmaxf(m[r], quad_max(mx[r]));
    corr[r] = exp2f(m[r] - m_new[r]);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = m_new[r] > kNegInf ? exp2f(sc[i] - m_new[r]) : 0.f;
    psum[r] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l[r] * corr[r] + quad_sum(psum[r]);
    m[r] = m_new[r];
  }
}

// P rounded to bfloat16 and packed in pairs: the A fragments of P V (the
// accumulator layout's 16-column groups are the A layout of a k16 step).
__device__ __forceinline__ void pack_p(const float (&p)[32],
                                       uint32_t (&pa)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kk][j] = pack_bf16(p[8 * kk + 2 * j], p[8 * kk + 2 * j + 1]);
}

// O's rows scaled by corr.
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= corr[(i >> 1) & 1];
}

// P (A fragments) and O (accumulator) of a P V wgmma pinned in their
// registers: before it is issued, everything that defines them has run;
// until it has retired, nothing else takes their registers (ptxas would
// serialise every wgmma of the kernel if a non-wgmma instruction wrote an
// in-flight wgmma's registers).
template <int N>
__device__ __forceinline__ void fence_p_o(uint32_t (&pa)[kBK / 16][4],
                                          float (&o)[N]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) fence_regs(pa[kk]);
  fence_regs(o);
}

// Arrival of a consumer warp on a stage's empty barrier, once every lane
// is past its reads (never while a wgmma is in flight: ptxas serialises
// wgmma around divergent code).
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Thread t of a consumer warpgroup (warp w = t / 32, lane) holds, in the
// wgmma accumulator layout, rows 16 w + lane / 4 and that + 8 of the
// warpgroup's 64, and in each group of 8 columns the two at
// 2 (lane % 4): element i sits at row + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 (lane % 4) + (i & 1).  Scores are kept in the log2
// domain (x = q.k scale log2 e), so p = 2^(x - m).
//
// A warpgroup's key tiles run as a pipeline: while O += P V of tile kt is
// on the tensor cores, S of tile kt + 1 has been computed and its softmax
// runs on the CUDA cores; O is rescaled once the P V has retired.  K's
// stage is released as soon as its S is in registers, V's once its P V
// has retired, so the producer refills each without waiting on the other.
template <int D, int DV, int WG>
__global__ void __launch_bounds__(Cfg<D, DV, WG>::kThreads,
                                    Cfg<D, DV, WG>::kPerSm)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 __nv_bfloat16* __restrict__ out,
                                 float* __restrict__ lse, int S, int H,
                                 int group, float scale_log2, int causal) {
  using L = Cfg<D, DV, WG>;
  constexpr int NC = L::NC, NCV = L::NCV, kBQ = L::kBQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base, s_k = base + L::kK, s_v = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const int n_qt = (S + kBQ - 1) / kBQ;
  // heavier (later) query tiles first when causal
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * kBQ;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / group;
  const int q_last = (q0 + kBQ < S ? q0 + kBQ : S) - 1;
  const int n_kt = causal ? q_last / kBK + 1 : (S + kBK - 1) / kBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4 * WG);   // one arrival a consumer warp
      mbar_init(v_empty + 8 * s, 4 * WG);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 128 * WG) {
    // producer warp: one thread starts every load, each stage's K and V
    // once their previous use has been released (passes at once on the
    // stage's first use)
    if (tid == 128 * WG) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < NC; ++c)
        tma_load_4d(s_q + c * kBQ * kRowBytes, &tm_q, q_full, c * kChunk, h,
                    q0, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        const uint32_t phase = ((kt / kStages) & 1) ^ 1;
        const uint32_t kd = s_k + s * L::kKBytes;
        const uint32_t vd = s_v + s * L::kVBytes;
        mbar_wait(k_empty + 8 * s, phase);
        mbar_expect_tx(k_full + 8 * s, L::kKBytes);
        for (int c = 0; c < NC; ++c)
          tma_load_4d(kd + c * kBK * kRowBytes, &tm_k, k_full + 8 * s,
                      c * kChunk, kvh, kt * kBK, b);
        if constexpr (WG == 1) mbar_wait(v_empty + 8 * s, phase);
        mbar_expect_tx(v_full + 8 * s, L::kVBytes);
        for (int c = 0; c < NCV; ++c)
          tma_load_4d(vd + c * kBK * kRowBytes, &tm_v, v_full + 8 * s,
                      c * kChunk, kvh, kt * kBK, b);
      }
    }
    return;
  }

  // consumer warpgroups
  const int wg = tid / 128;
  const int warp = tid % 128 / 32;
  const int lane = tid % 32;
  const int r_lo = q0 + 64 * wg;                // warpgroup's first row
  const int row0 = r_lo + 16 * warp + lane / 4;  // rows row0, row0 + 8
  const int col0 = 2 * (lane % 4);
  const uint32_t qa = s_q + wg * 64 * kRowBytes;

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  mbar_wait(q_full, 0);

  if constexpr (WG == 1) {
    // One warpgroup holds every row of the tile, so every key tile is at
    // or below its last row.
    uint32_t pa[kBK / 16][4];
    {                                    // tile 0's S and softmax
      float sc[32];                      // the first step overwrites it
      mbar_wait(k_full, 0);
      wgmma_fence();
      issue_qk<D, kBQ>(sc, qa, s_k);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      release(k_empty, lane);
      softmax_tile(sc, m, l, corr, scale_log2, 0, r_lo, row0, col0, S,
                   causal);
      pack_p(sc, pa);
    }
    // tiles 0 .. n_kt - 2, as FlashAttention-3 orders them: S of tile
    // kt + 1 is issued, O rescaled for tile kt while it runs, then P V of
    // tile kt is issued and the softmax of tile kt + 1 runs beside it; P of
    // tile kt + 1 is packed into pa once that P V has retired.  While a
    // wgmma is in flight nothing writes its registers and nothing branches
    // (ptxas would serialise every wgmma of the kernel).
    for (int kt = 0; kt + 1 < n_kt; ++kt) {
      const int s = kt % kStages, s1 = (kt + 1) % kStages;
      const int k1 = (kt + 1) * kBK;
      float sc[32];
      mbar_wait(k_full + 8 * s1, ((kt + 1) / kStages) & 1);
      mbar_wait(v_full + 8 * s, (kt / kStages) & 1);
      wgmma_fence();
      issue_qk<D, kBQ>(sc, qa, s_k + s1 * L::kKBytes);
      wgmma_commit();
      rescale(o, corr);
      fence_p_o(pa, o);
      wgmma_fence();
      issue_pv<DV>(o, pa, s_v + s * L::kVBytes);
      wgmma_commit();
      wgmma_wait<1>();                   // S of tile kt + 1 is in registers
      fence_regs(sc);
      softmax_tile(sc, m, l, corr, scale_log2, k1, r_lo, row0, col0, S,
                   causal);
      wgmma_wait<0>();                   // P V of tile kt has retired
      fence_p_o(pa, o);
      release(k_empty + 8 * s1, lane);
      release(v_empty + 8 * s, lane);
      pack_p(sc, pa);
    }
    {                                    // P V of the last tile
      const int kt = n_kt - 1, s = kt % kStages;
      rescale(o, corr);
      mbar_wait(v_full + 8 * s, (kt / kStages) & 1);
      fence_p_o(pa, o);
      wgmma_fence();
      issue_pv<DV>(o, pa, s_v + s * L::kVBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_p_o(pa, o);
      release(v_empty + 8 * s, lane);
    }
  } else {
    // Two warpgroups: tile by tile, S, softmax and P V in turn, each
    // warpgroup's tensor-core work running beside the other's softmax.  A
    // warpgroup skips the causal tiles wholly above its rows, but waits
    // for their loads and releases their stages as the other does.
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages;
      const uint32_t par = (kt / kStages) & 1;
      const int k0 = kt * kBK;
      const bool skip = causal && k0 > r_lo + 63;
      uint32_t pa[kBK / 16][4];
      mbar_wait(k_full + 8 * s, par);
      if (!skip) {
        float sc[32] = {};
        wgmma_fence();
        issue_qk<D, kBQ>(sc, qa, s_k + s * L::kKBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        softmax_tile(sc, m, l, corr, scale_log2, k0, r_lo, row0, col0, S,
                     causal);
        pack_p(sc, pa);
        rescale(o, corr);
      }
      mbar_wait(v_full + 8 * s, par);
      if (!skip) {
        fence_regs(o);
        wgmma_fence();
        issue_pv<DV>(o, pa, s_v + s * L::kVBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
      release(k_empty + 8 * s, lane);   // the stage's K and V
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    const float lg = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / lg;
    __nv_bfloat16* orow =
        out + ((static_cast<long long>(b) * S + row) * H + h) * DV;
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + col0) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (lane % 4 == 0)
      lse[(static_cast<long long>(b) * H + h) * S + row] =
          m[r] * kLn2 + logf(lg);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a libcuda function, fetched through the runtime
// so that the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 (B, S, heads, D) tensor with element strides (sb, ss, sh) and
// unit stride along D, as 4-D tensor map {D, heads, S, B}; boxes of 64
// head-dim elements (128 bytes, swizzled) x `rows` positions.
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
                int D, long long sb, long long ss, long long sh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {kChunk, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA needs 16-byte aligned bases and strides.
bool aligned(const void* p, const long long* st) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (st[i] % 8 != 0 || st[i] <= 0) return false;
  return true;
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int H, int group, const long long* st,
           float scale, int causal, cudaStream_t stream) {
  constexpr int WG = warpgroups(D);
  using L = Cfg<D, DV, WG>;
  if (!aligned(q, st) || !aligned(k, st + 3) || !aligned(v, st + 6))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  const int KV = H / group;
  if (!tensor_map(&tq, q, B, S, H, D, st[0], st[1], st[2], L::kBQ) ||
      !tensor_map(&tk, k, B, S, KV, D, st[3], st[4], st[5], kBK) ||
      !tensor_map(&tv, v, B, S, KV, DV, st[6], st[7], st[8], kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_attention_wgmma_kernel<D, DV, WG>;
  cudaError_t err = opt_in(reinterpret_cast<const void*>(kernel), L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (S + L::kBQ - 1) / L::kBQ);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, S, H, group,
      scale * 1.4426950408889634f, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

// q: (B, S, H, D), k: (B, S, KV, D), v: (B, S, KV, Dv) with element
// strides (batch, position, head) and unit stride along the head dim,
// H = KV * group; out: (B, S, H, Dv) contiguous; lse: (B, H, S) float32
// contiguous.  dtype 0 = float32, 1 = bfloat16 (q, k, v and out alike).
// 1 <= D, Dv <= 256; causal 0 or 1.  variant 0 runs "fp32", 1 runs
// "wgmma", which needs bfloat16, (D, Dv) one of (64, 64), (128, 128),
// (192, 128) and (256, 256) (WGMMA_DIMS in kernels/flash_attention.py)
// and 16-byte aligned bases and strides (a multiple of 8 elements);
// other inputs for it return cudaErrorInvalidValue.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int dtype, int B, int S, int H, int group, int D, int Dv, int causal,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, int variant, cudaStream_t stream) {
  if (D < 1 || Dv < 1 || D > kMaxDim || Dv > kMaxDim || group < 1 ||
      H % group != 0 || B < 1 || S < 1 || (S + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh};
  if (variant == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    if (D == 64 && Dv == 64)
      return wg::launch<64, 64>(q, k, v, out, lse, B, S, H, group, st, scale,
                                causal, stream);
    if (D == 128 && Dv == 128)
      return wg::launch<128, 128>(q, k, v, out, lse, B, S, H, group, st,
                                  scale, causal, stream);
    if (D == 192 && Dv == 128)
      return wg::launch<192, 128>(q, k, v, out, lse, B, S, H, group, st,
                                  scale, causal, stream);
    if (D == 256 && Dv == 256)
      return wg::launch<256, 256>(q, k, v, out, lse, B, S, H, group, st,
                                  scale, causal, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_dv<float>(q, k, v, out, lse, B, S, H, group, D, Dv, st,
                              scale, causal, stream);
  if (dtype == 1)
    return dispatch_dv<__nv_bfloat16>(q, k, v, out, lse, B, S, H, group, D,
                                      Dv, st, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
