// RWKV6 (WKV) recurrence on Hopper (sm_90a): one decode step, and the
// chunked prefill.
//
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//
// per (batch, head) row "bh", with a (dk, dv) float32 state.  Column j of
// S' and y_j need only column j of S, so both kernels split a row's dv
// state columns over n_col CTAs that exchange nothing but (in the prefill)
// one shared matrix a chunk.  n_col is chosen in Python from (BH, dv)
// alone (col_split in kernels/rwkv6_scan.py: 8 CTAs a head at
// rwkv6-1.6b's BH = 32, the serving path's shape, 2 at BH = 256) and only
// checked here; the sums run in a fixed order that does not depend on
// n_col, and no atomics: results do not depend on the card or on
// scheduling, so rDLB duplicates decode bit for bit.
//
// wkv6_decode_kernel replaces src/repro/kernels/rwkv6_scan.py
// (`wkv6_decode`, body `_decode_kernel`): one step.  Bound by bytes: 16 KB
// of state read and 16 KB written per 64 x 64 head against 7 FLOP per
// state element, so the design keeps bytes in flight: each thread owns 4
// columns of a group of 4 rows and issues its four 16-byte loads of S
// before it computes or stores anything (in place stays safe: a thread
// writes only the elements it has read; state and state_out may be one
// buffer and are not __restrict__).  Each row group's partial y goes to
// shared memory, and one thread a column sums the partials in row-group
// order.  With one CTA a head and a thread a column (the first design) a
// thread had one 4-byte load in flight and BH = 32 used 32 of 132 SMs.
//
// wkv6_batched_kernel replaces `wkv6_batched` (body `_kernel`): T steps
// in chunks of C.  Within a chunk, with la[t] the cumulative sum of log w
// over the chunk's rows 0..t (la[-1] = 0):
//   A[t][s] = sum_i r[t,i] k[s,i] exp(la[t-1,i] - la[s,i])     (s < t)
//   A[t][t] = sum_i r[t,i] u[i] k[t,i]
//   y[t]    = sum_{s<=t} A[t][s] v[s] + (r[t] * exp(la[t-1]))^T S
//   S'      = diag(exp(la[c-1])) S + sum_s (k[s] * exp(la[c-1] - la[s])) v[s]^T
// Every exponent is <= 0, so every factor is at most 1: unlike the TPU
// kernel's k * exp(-la), which overflows float32 under strong decay
// (w = 0.06 over a 32-row chunk already gives wrong outputs, 0.01 NaN),
// nothing here overflows.  The last chunk may be shorter than C, so any T
// is taken.  Bound, at the serving path's BH = 32, by the serial chain of
// chunks (32 at T = 1000) on a few SMs; the design:
// * one thread-block cluster of n_col CTAs a head, each CTA keeping its
//   dv / n_col state columns in shared memory across the chunks;
// * A (C^2/2 * dk exponentials a chunk) is the same for every column
//   group, so it is computed once a head: each rank computes an equal
//   share of the pairs (t, s <= t) and stores each pair into every
//   rank's copy of A through distributed shared memory before one
//   cluster barrier; A is kept twice, by chunk parity, so that barrier is
//   the only one the cluster shares a chunk;
// * chunk c+1's r, k, w and v are copied (cp.async, 16 bytes a thread)
//   into a second stage while chunk c computes;
// * r, k, w are converted and the cumulative log decay summed (in log2
//   units) in one pass, several threads a column, each a block of rows;
//   a second pass adds the blocks above and forms r under decay and the
//   k tail; every decay is an exp2f of a difference (__log2f, whose
//   error is far inside the tolerance, holds at w = 0.01 on the card);
// * a thread a pair of A, so that a warp reads k[s] and la[s] of 32 rows
//   from distinct banks (rows of dk + 1 floats) and r[t], la[t-1] of one
//   row by broadcast (splitting a pair over four lanes measured slower:
//   bank conflicts); A's rows are chunk + 1 floats, so that y reading a
//   column of it hits distinct banks;
// * y and the carried state are computed in one pass (the new state goes
//   to a second buffer) and register-tiled over 4 columns: each
//   shared-memory operand feeds 4 FMAs;
// * shared-memory loops load a batch of elements into registers before
//   they store any (a load after a store the compiler cannot prove
//   disjoint would wait for it).
// A chunk costs four CTA barriers, one of them the cluster's (running
// chunk c+1's convert beside chunk c's y and state, one barrier fewer,
// measured slower); one more cluster barrier, arrived at on entry and
// waited for before chunk 0's pairs of A, makes sure every CTA of the
// cluster has started before any stores into it.
// Arithmetic stays float32 on the CUDA cores (TF32 would not hold the
// 1e-4 tolerance).  No wait here can be polled: cp.async groups complete
// or fault, and every CTA of a cluster reaches the same number of cluster
// barriers (the loop bounds are the same for the whole cluster), so a
// fault ends the launch with an error instead of hanging it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include "hopper.cuh"

extern "C" size_t wkv6_batched_smem(int dk, int dv, int chunk, int n_col,
                                    int itemsize);

namespace {

constexpr int kRowGroup = 4;           // decode: rows of one y partial
constexpr int kDecodeMaxThreads = 256;
constexpr int kBatchedThreads = 256;
constexpr int kMaxColSplit = 8;        // portable cluster size
constexpr int kBatch = 8;              // loads in flight before a store
constexpr size_t kMaxSmem = 232448;    // bytes a CTA may use

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Above 48 KB a kernel needs an opt-in.  It is raised per device and
// kernel, only when a size above the largest so far is reached (and so
// not again while a launch of a size already seen is captured into a CUDA
// graph), under a lock: threaded replicas call the launchers concurrently.
int allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> opted_in;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(mu);
  size_t& allowed = opted_in[{device, kernel}];
  if (smem > allowed) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  return 0;
}

// Columns j .. j + 3 of a float32 state row, of which the first n exist:
// one 16-byte access when VEC (n is then 4), else element accesses.
template <bool VEC>
__device__ __forceinline__ float4 ld4(const float* p, int n) {
  if constexpr (VEC) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    return make_float4(n > 0 ? p[0] : 0.f, n > 1 ? p[1] : 0.f,
                       n > 2 ? p[2] : 0.f, n > 3 ? p[3] : 0.f);
  }
}

template <bool VEC>
__device__ __forceinline__ void st4(float* p, float4 x, int n) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(p) = x;
  } else {
    if (n > 0) p[0] = x.x;
    if (n > 1) p[1] = x.y;
    if (n > 2) p[2] = x.z;
    if (n > 3) p[3] = x.w;
  }
}

// One decode step.  Grid: bh * n_col CTAs, CTA b taking row b / n_col and
// its columns [c0, c0 + cw).  Thread (group g, quad jq) takes rows
// 4g .. 4g + 3 and columns 4jq .. 4jq + 3 of the CTA's; sy holds the
// (groups, cw) partial y.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kDecodeMaxThreads) wkv6_decode_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ u, const float* state, float* __restrict__ y,
    float* state_out, int dk, int dv, int n_col) {
  extern __shared__ float sy[];
  const int cw = dv / n_col;
  const int quads = (cw + 3) / 4;
  const int groups = (dk + kRowGroup - 1) / kRowGroup;
  const long long bh = blockIdx.x / n_col;
  const int c0 = (blockIdx.x % n_col) * cw;
  const int j = 4 * (threadIdx.x % quads);
  const int nj = min(4, cw - j);
  const long long base = bh * dk * dv + c0 + j;
  float vj[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    vj[q] = q < nj ? to_f(v[bh * dv + c0 + j + q]) : 0.f;
  for (int g = threadIdx.x / quads; g < groups;
       g += blockDim.x / quads) {
    const int i0 = g * kRowGroup;
    float4 s4[kRowGroup];
#pragma unroll
    for (int m = 0; m < kRowGroup; ++m)   // every load before any store
      s4[m] = i0 + m < dk
                  ? ld4<VEC>(state + base + static_cast<long long>(i0 + m) * dv,
                             nj)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int m = 0; m < kRowGroup; ++m) {
      const int i = i0 + m;
      if (i >= dk) break;
      const long long gi = bh * dk + i;
      const float ri = to_f(r[gi]), ki = to_f(k[gi]), wi = to_f(w[gi]),
                  ui = to_f(u[gi]);
      const float s[4] = {s4[m].x, s4[m].y, s4[m].z, s4[m].w};
      float o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float kv = ki * vj[q];
        part[q] += ri * (s[q] + ui * kv);
        o[q] = wi * s[q] + kv;
      }
      st4<VEC>(state_out + base + static_cast<long long>(i) * dv,
               make_float4(o[0], o[1], o[2], o[3]), nj);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < nj) sy[g * cw + j + q] = part[q];
  }
  __syncthreads();
  for (int jj = threadIdx.x; jj < cw; jj += blockDim.x) {
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += sy[g * cw + jj];
    y[bh * dv + c0 + jj] = acc;
  }
}

// Row t of pair number p = t (t + 1) / 2 + s (s <= t).
__device__ __forceinline__ int pair_row(int p) {
  int t = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while (t * (t + 1) / 2 > p) --t;
  while ((t + 1) * (t + 2) / 2 <= p) ++t;
  return t;
}

__host__ __device__ __forceinline__ size_t round16(size_t x) {
  return (x + 15) / 16 * 16;
}

// The prefill.  Grid: bh * n_col CTAs in clusters of n_col, one cluster a
// row, rank = blockIdx.x % n_col taking state columns [c0, c0 + cw).
// Shared memory (wkv6_batched_smem): two stages of a chunk's raw r, k, w
// (chunk x dk) and v (chunk x cw); then float32: the state twice (dk x
// cwp; chunk n reads one and writes the other), v (chunk x cwp), cwp = cw
// rounded up to 4 (16-byte rows, zeros past cw); r, k, la, r under decay,
// k tail (chunk x ld each, ld = dk + 1 so that a warp reading a column of
// many rows hits distinct banks); A twice (chunk x (chunk + 1), by chunk
// parity); u; the chunk's decay 2^la[c-1]; the row blocks' totals of la
// (nb x dk).  la is kept in log2 units.  Four barriers a chunk: the stage
// has landed; r, k, v and each block's la are in place; la, r under decay
// and the k tail are complete; A is complete (the cluster barrier).
// DK > 0 fixes dk at compile time (rwkv6's head dim of 64), which turns
// the index arithmetic into shifts and unrolls the loops over dk; DK = 0
// takes dk from the call.
template <typename T, bool VEC, int DK>
__global__ void __launch_bounds__(kBatchedThreads) wkv6_batched_kernel(
    const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ w,
    const T* __restrict__ u, const float* state, float* __restrict__ y,
    float* state_out, int T_len, int dk_arg, int dv, int chunk, int n_col) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dk = DK > 0 ? DK : dk_arg;
  const int cw = dv / n_col;
  const int cwp = (cw + 3) & ~3;
  const int quads = cwp / 4;
  const int ld = dk + 1;
  const int lda = chunk + 1;    // A's rows: a column hits distinct banks
  const size_t stage_bytes =
      round16(sizeof(T) * (3 * static_cast<size_t>(chunk) * dk +
                           static_cast<size_t>(chunk) * cw));
  float* sS = reinterpret_cast<float*>(smem + 2 * stage_bytes);
  float* sv = sS + 2 * dk * cwp;
  float* sr = sv + chunk * cwp;
  float* sk = sr + chunk * ld;
  float* sla = sk + chunk * ld;
  float* srh = sla + chunk * ld;
  float* skt = srh + chunk * ld;
  float* sA = skt + chunk * ld;
  float* su = sA + 2 * chunk * lda;
  float* sdec = su + dk;
  float* stot = sdec + dk;
  const int tid = threadIdx.x;
  const int nt = kBatchedThreads;
  const int nb = dk < nt ? nt / dk : 1;  // threads (row blocks) a column
  const int rank = blockIdx.x % n_col;
  const long long bh = blockIdx.x / n_col;
  const int c0 = rank * cw;
  // A CTA may touch another's shared memory only once every CTA of the
  // cluster has started, which only a cluster barrier tells it (being
  // co-scheduled is not having started).  Arrive now, wait before chunk
  // 0's first store of A into the other ranks.
  if (n_col > 1) hopper::cluster_arrive_relaxed();

  for (int i = tid; i < dk; i += nt) su[i] = to_f(u[bh * dk + i]);
  for (int e = tid; e < dk * cwp; e += nt) {
    const int i = e / cwp, j = e % cwp;
    sS[e] = j < cw ? state[(bh * dk + i) * dv + c0 + j] : 0.f;
  }

  // chunk n's r, k, w and this CTA's columns of v into stage n & 1
  auto load = [&](int n) {
    const int t0 = n * chunk;
    const int c = min(chunk, T_len - t0);
    const long long row0 = bh * T_len + t0;
    T* st = reinterpret_cast<T*>(smem + (n & 1) * stage_bytes);
    if constexpr (VEC) {
      constexpr int per = 16 / sizeof(T);
      for (int e = tid * per; e < c * dk; e += nt * per) {
        hopper::cp_async16(st + e, r + row0 * dk + e);
        hopper::cp_async16(st + chunk * dk + e, k + row0 * dk + e);
        hopper::cp_async16(st + 2 * chunk * dk + e, w + row0 * dk + e);
      }
      for (int e = tid * per; e < c * cw; e += nt * per) {
        const int t = e / cw, j = e % cw;
        hopper::cp_async16(st + 3 * chunk * dk + e,
                           v + (row0 + t) * dv + c0 + j);
      }
    } else {
      for (int e = tid; e < c * dk; e += nt) {
        st[e] = r[row0 * dk + e];
        st[chunk * dk + e] = k[row0 * dk + e];
        st[2 * chunk * dk + e] = w[row0 * dk + e];
      }
      for (int e = tid; e < c * cw; e += nt)
        st[3 * chunk * dk + e] = v[(row0 + e / cw) * dv + c0 + e % cw];
    }
    hopper::cp_async_commit();
  };

  const int n_chunks = (T_len + chunk - 1) / chunk;
  if (n_chunks > 0) load(0);
  for (int n = 0; n < n_chunks; ++n) {
    const int c = min(chunk, T_len - n * chunk);
    const long long row0 = bh * T_len + n * chunk;
    if (n + 1 < n_chunks)
      load(n + 1);              // into the stage chunk n - 1 left
    else
      hopper::cp_async_commit();
    hopper::cp_async_wait<1>();  // chunk n's copies are done
    __syncthreads();

    // r, k and v to float32, and la = cumulative log2 decay down each
    // column: nb threads a column, each a block of rb rows summed in
    // order (stot: the blocks' totals).  Each loop loads kBatch rows into
    // registers before it stores any: the compiler cannot tell that the
    // shared-memory stores do not alias the next loads, so a load after a
    // store would wait for it.
    const T* st = reinterpret_cast<const T*>(smem + (n & 1) * stage_bytes);
    const int rb = (c + nb - 1) / nb;
    for (int col = tid; col < nb * dk; col += nt) {
      const int i = col % dk, t_end = min(c, (col / dk + 1) * rb);
      float acc = 0.f;
      for (int t0 = col / dk * rb; t0 < t_end; t0 += kBatch) {
        float xr[kBatch], xk[kBatch], xw[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int g = min(t0 + b, t_end - 1) * dk + i;
          xr[b] = to_f(st[g]);
          xk[b] = to_f(st[chunk * dk + g]);
          xw[b] = to_f(st[2 * chunk * dk + g]);
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (t0 + b < t_end) {
            const int at = (t0 + b) * ld + i;
            acc += __log2f(fmaxf(xw[b], 1e-38f));
            sla[at] = acc;
            sr[at] = xr[b];
            sk[at] = xk[b];
          }
        }
      }
      stot[col] = acc;
    }
    for (int e = tid; e < c * cwp; e += nt) {
      const int t = e / cwp, j = e % cwp;
      sv[e] = j < cw ? to_f(st[3 * chunk * dk + t * cw + j]) : 0.f;
    }
    __syncthreads();

    // each block adds the blocks above it (in order) and forms r under
    // decay, r^[t] = r[t] 2^la[t-1], and the k tail, k[t] 2^(la[c-1] - la[t])
    for (int col = tid; col < nb * dk; col += nt) {
      const int i = col % dk, blk = col / dk, t_end = min(c, (blk + 1) * rb);
      float off = 0.f, total = 0.f;
      for (int b = 0; b < nb; ++b) {
        if (b < blk) off += stot[b * dk + i];
        total += stot[b * dk + i];
      }
      if (blk == 0) sdec[i] = exp2f(total);
      float prev = off;
      for (int t0 = blk * rb; t0 < t_end; t0 += kBatch) {
        float xl[kBatch], xr[kBatch], xk[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int at = min(t0 + b, t_end - 1) * ld + i;
          xl[b] = sla[at] + off;
          xr[b] = sr[at];
          xk[b] = sk[at];
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (t0 + b < t_end) {
            const int at = (t0 + b) * ld + i;
            sla[at] = xl[b];
            srh[at] = xr[b] * exp2f(prev);
            skt[at] = xk[b] * exp2f(total - xl[b]);
            prev = xl[b];
          }
        }
      }
    }
    __syncthreads();

    // this rank's share of A's pairs, a thread a pair (a warp's pairs share
    // a row t, so r[t] and la[t-1] are broadcast and k[s], la[s] hit
    // distinct banks), each pair stored into every rank's A of this
    // chunk's parity
    const int Pc = c * (c + 1) / 2;
    const int per = (Pc + n_col - 1) / n_col;
    const int p1 = min(Pc, (rank + 1) * per);
    float* An = sA + (n & 1) * chunk * lda;
    if (n == 0 && n_col > 1) hopper::cluster_wait();   // all started
    for (int p = rank * per + tid; p < p1; p += nt) {
      const int t = pair_row(p);
      const int s = p - t * (t + 1) / 2;
      const float* rt = sr + t * ld;
      const float* ks = sk + s * ld;
      float acc = 0.f;
      if (s == t) {
#pragma unroll 8
        for (int i = 0; i < dk; ++i) acc += rt[i] * su[i] * ks[i];
      } else {
        const float* lt = sla + (t - 1) * ld;
        const float* ls = sla + s * ld;
#pragma unroll 8
        for (int i = 0; i < dk; ++i)
          acc += rt[i] * ks[i] * exp2f(lt[i] - ls[i]);
      }
      if (n_col > 1) {
        for (int to = 0; to < n_col; ++to)
          hopper::st_cluster_f32(An + t * lda + s, static_cast<uint32_t>(to),
                                 acc);
      } else {
        An[t * lda + s] = acc;
      }
    }
    // every rank's pairs are in every rank's A; chunk n + 2 writes this
    // parity again only after the next chunk's cluster barrier, which no
    // rank reaches before it has used this chunk's A
    if (n_col > 1)
      hopper::cluster_sync();
    else
      __syncthreads();

    // y (4 columns of one row a thread: A V and the cross term r^ S apart)
    // and the state carried on (4 columns of one state row a thread) into
    // the other state buffer
    const float* S = sS + (n & 1) * dk * cwp;
    float* Sn = sS + ((n + 1) & 1) * dk * cwp;
    const int ny = c * quads;
    for (int e = tid; e < ny + dk * quads; e += nt) {
      if (e < ny) {
        const int t = e / quads, j = 4 * (e % quads);
        float a[4] = {0.f, 0.f, 0.f, 0.f}, x[4] = {0.f, 0.f, 0.f, 0.f};
        const float* At = An + t * lda;
#pragma unroll 4
        for (int s = 0; s <= t; ++s) {
          const float as = At[s];
          const float4 vs =
              *reinterpret_cast<const float4*>(sv + s * cwp + j);
          a[0] += as * vs.x;
          a[1] += as * vs.y;
          a[2] += as * vs.z;
          a[3] += as * vs.w;
        }
        const float* rt = srh + t * ld;
#pragma unroll 8
        for (int i = 0; i < dk; ++i) {
          const float ri = rt[i];
          const float4 si = *reinterpret_cast<const float4*>(S + i * cwp + j);
          x[0] += ri * si.x;
          x[1] += ri * si.y;
          x[2] += ri * si.z;
          x[3] += ri * si.w;
        }
        float* yo = y + (row0 + t) * dv + c0 + j;
#pragma unroll
        for (int qq = 0; qq < 4; ++qq)
          if (j + qq < cw) yo[qq] = a[qq] + x[qq];
      } else {
        const int i = (e - ny) / quads, j = 4 * ((e - ny) % quads);
        const float d = sdec[i];
        const float4 s0 = *reinterpret_cast<const float4*>(S + i * cwp + j);
        float o[4] = {d * s0.x, d * s0.y, d * s0.z, d * s0.w};
#pragma unroll 4
        for (int s = 0; s < c; ++s) {
          const float kt = skt[s * ld + i];
          const float4 vs =
              *reinterpret_cast<const float4*>(sv + s * cwp + j);
          o[0] += kt * vs.x;
          o[1] += kt * vs.y;
          o[2] += kt * vs.z;
          o[3] += kt * vs.w;
        }
        *reinterpret_cast<float4*>(Sn + i * cwp + j) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  }
  if (n_chunks == 0 && n_col > 1) hopper::cluster_wait();
  __syncthreads();
  const float* S = sS + (n_chunks & 1) * dk * cwp;
  for (int e = tid; e < dk * cw; e += nt) {
    const int i = e / cw, j = e % cw;
    state_out[(bh * dk + i) * dv + c0 + j] = S[i * cwp + j];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int decode(const void* r, const void* k, const void* v, const void* w,
           const void* u, const float* state, float* y, float* state_out,
           int bh, int dk, int dv, int n_col, cudaStream_t stream) {
  const int cw = dv / n_col;
  const int quads = (cw + 3) / 4;
  const int groups = (dk + kRowGroup - 1) / kRowGroup;
  if (quads > kDecodeMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  int in_flight = kDecodeMaxThreads / quads;   // row groups at once
  if (in_flight > groups) in_flight = groups;
  const size_t smem = sizeof(float) * static_cast<size_t>(groups) * cw;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = cw % 4 == 0 && aligned16(state) && aligned16(state_out);
  auto kernel = vec ? wkv6_decode_kernel<T, true>
                    : wkv6_decode_kernel<T, false>;
  const int err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err) return err;
  kernel<<<bh * n_col, quads * in_flight, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), state, y, state_out, dk, dv, n_col);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int batched(const void* r, const void* k, const void* v, const void* w,
            const void* u, const float* state, float* y, float* state_out,
            int bh, int T_len, int dk, int dv, int chunk, int n_col,
            cudaStream_t stream) {
  const size_t smem = wkv6_batched_smem(dk, dv, chunk, n_col, sizeof(T));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int cw = dv / n_col;
  const bool vec = (dk * sizeof(T)) % 16 == 0 &&
                   (cw * sizeof(T)) % 16 == 0 &&
                   (dv * sizeof(T)) % 16 == 0 && aligned16(r) &&
                   aligned16(k) && aligned16(w) && aligned16(v);
  auto kernel = vec ? (dk == 64 ? wkv6_batched_kernel<T, true, 64>
                                 : wkv6_batched_kernel<T, true, 0>)
                    : (dk == 64 ? wkv6_batched_kernel<T, false, 64>
                                : wkv6_batched_kernel<T, false, 0>);
  const int err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(bh) * n_col);
  cfg.blockDim = dim3(kBatchedThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_col;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = n_col > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), state, y, state_out, T_len, dk, dv, chunk,
      n_col);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

bool split_ok(int dv, int n_col) {
  return n_col >= 1 && n_col <= kMaxColSplit && dv % n_col == 0;
}

}  // namespace

// Dynamic shared memory (bytes) of one wkv6_batched CTA (itemsize: bytes
// of one input element); the layout is wkv6_batched_kernel's.
extern "C" size_t wkv6_batched_smem(int dk, int dv, int chunk, int n_col,
                                    int itemsize) {
  const size_t c = chunk, d = dk;
  const size_t cw = dv / n_col;
  const size_t cwp = (cw + 3) / 4 * 4;
  const size_t stage = round16(itemsize * (3 * c * d + c * cw));
  const size_t blocks = d < kBatchedThreads ? kBatchedThreads / d * d : d;
  return 2 * stage + sizeof(float) * (2 * d * cwp + c * cwp +
                                      5 * c * (d + 1) + 2 * c * (c + 1) +
                                      2 * d + blocks);
}

// r, k, w, u: (bh, dk); v: (bh, dv), all of one dtype (0 = float32,
// 1 = bfloat16), contiguous; state, state_out: (bh, dk, dv) float32 (may
// be the same buffer); y: (bh, dv) float32.  n_col (1..8, dividing dv):
// CTAs a row's columns are split over.
extern "C" int wkv6_decode_launch(const void* r, const void* k, const void* v,
                                  const void* w, const void* u,
                                  const float* state, float* y,
                                  float* state_out, int dtype, int bh, int dk,
                                  int dv, int n_col, cudaStream_t stream) {
  if (!split_ok(dv, n_col) || bh < 1 || dk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return decode<float>(r, k, v, w, u, state, y, state_out, bh, dk, dv,
                         n_col, stream);
  if (dtype == 1)
    return decode<__nv_bfloat16>(r, k, v, w, u, state, y, state_out, bh, dk,
                                 dv, n_col, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// r, k, w: (bh, T, dk); v: (bh, T, dv); u: (bh, dk), all of one dtype,
// contiguous; state, state_out: (bh, dk, dv) float32 (may be the same
// buffer); y: (bh, T, dv) float32.  n_col (1..8, dividing dv): CTAs, one
// cluster, a row's columns are split over.
extern "C" int wkv6_batched_launch(const void* r, const void* k,
                                   const void* v, const void* w,
                                   const void* u, const float* state,
                                   float* y, float* state_out, int dtype,
                                   int bh, int T_len, int dk, int dv,
                                   int chunk, int n_col, cudaStream_t stream) {
  if (!split_ok(dv, n_col) || bh < 1 || dk < 1 || chunk < 1 || T_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return batched<float>(r, k, v, w, u, state, y, state_out, bh, T_len, dk,
                          dv, chunk, n_col, stream);
  if (dtype == 1)
    return batched<__nv_bfloat16>(r, k, v, w, u, state, y, state_out, bh,
                                  T_len, dk, dv, chunk, n_col, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
