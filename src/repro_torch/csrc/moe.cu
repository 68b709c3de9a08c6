// Dropless Mixture-of-Experts on Hopper (sm_90a): softmax top-k routing
// and the grouped expert products, which read only the experts some token
// was routed to.
//
// The JAX package has no kernel here (its MoE layer is GShard's capacity
// dispatch as einsums); these serve DeepSeek-V2's published routing
// (kernels/moe.py holds the wrappers and the plain versions).  What bounds
// them: at prefill sizes the bytes of the routed experts' weights
// (DeepSeek-V2-Lite: 64 experts x 3 x 2048 x 1408 x 2 B = 1.1 GB a layer);
// at a decode step those of the k experts a token picked.  So each tile of
// up to 64 WG rows of one expert streams that expert's weights once, and an
// expert no token picked is never read.
//
// Three launches a layer, none waiting for the host:
//
// * moe_route_kernel (one CTA of 256 threads, a thread a token in chunks
//   of 256): softmax of the router's float32 logits, greedy top-k (the
//   larger probability first, the lower expert on a tie), the gates
//   (renormalised with `norm`, times `scale`), each routed row's rank
//   within its expert in token-major order (warp ballots, then a scan
//   over the chunk's warps), the experts' counts and offsets, the tile map
//   (tile -> expert, first row, end row; -1, 0, 0 past the used tiles) and
//   the sorted order of the routed rows (slot: the flat (t, k) index of
//   each sorted row; sgate: its gate).  It adds the counts to an int64
//   counter of routed rows per expert (atomics: replica threads route on
//   their own streams), read only after a run.
// * moe_gemm_kernel<WG, true, NB> (gate-up): CTA (block of 64 NB columns,
//   tile): silu(x W_gate) * (x W_up) of the tile's rows, x's rows
//   gathered through the slots, into the sorted hidden rows (bfloat16).
// * moe_gemm_kernel<WG, false, NB> (down): CTA (block of 128 NB columns,
//   tile): the sorted hidden rows times W_down, each row times its gate,
//   written to its own (token, k) row (float32); the caller sums a
//   token's k rows.
//
// The grouped product: WG consumer warpgroups of 64 rows each, no
// producer warp; two variants, small_m (WG = 1, NB = 1: a decode step's
// few rows spread over more CTAs) and tile (WG = 2, NB = 2: up to 128 rows
// of one expert, each weight block read once for them and x's rows
// gathered once for 128 or 256 columns).  Each stage of a ring of kStages
// holds 2 NB TMA boxes of B (64 columns x 64 reduction rows, 128-byte
// swizzle: NB boxes of W_gate and NB of W_up, or 2 NB of W_down side by
// side) and the A rows (64 reduction elements a row, gathered with
// cp.async into rows padded to 144 bytes).  Thread 0 starts the TMA loads
// kStages - 1 steps ahead and each thread its A copies; every step, after
// a block barrier, each warp reads its 16 rows' A fragments with ldmatrix
// and its warpgroup issues two wgmma m64n(64 NB)k16 a 16-row slice, one
// into each of two float32 accumulators (A from registers, B MN-major
// from shared memory, its NB boxes one leading byte offset apart, as
// flash_attention's P V).  Rows past a tile's end read the tile's first
// row and are not stored; reduction elements past the width arrive as
// zeros (TMA's fill, and zeros stored for A); boxes past the width are
// not loaded and their columns not stored.  Every sum runs in a fixed
// order (no atomics on values), so a duplicated rDLB task gives
// bit-identical output.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ================================================================ routing
constexpr int kRouteThreads = 256;             // tokens a chunk
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kMaxE = 64;                       // experts (a uint64 mask)
constexpr int kMaxK = 8;                        // experts a token

__global__ void __launch_bounds__(kRouteThreads) moe_route_kernel(
    const float* __restrict__ logits, int* idx, int* rank, float* gate,
    int* offs, int* slot, float* sgate, int* tiles,
    unsigned long long* counter, int T, int E, int K, int bm, int n_tiles,
    int norm, float scale) {
  __shared__ int s_pre[kRouteWarps][kMaxE];   // a warp's count, then start
  __shared__ int s_cnt[kMaxE];                // rows so far, then counts
  __shared__ int s_off[kMaxE];
  __shared__ int s_tend[kMaxE];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid < kMaxE) s_cnt[tid] = 0;
  __syncthreads();

  for (int c0 = 0; c0 < T; c0 += kRouteThreads) {
    const int t = c0 + tid;
    const bool valid = t < T;
    float p[kMaxE];
    float mx = -3.402823466e38f;
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) {
      p[e] = valid && e < E ? logits[static_cast<long long>(t) * E + e]
                            : -3.402823466e38f;
      mx = fmaxf(mx, p[e]);
    }
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) {
      p[e] = e < E ? expf(p[e] - mx) : 0.f;
      sum += p[e];
    }
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) p[e] = e < E ? p[e] / sum : -1.f;

    uint64_t mask = 0;
    int pk[kMaxK];
    float pg[kMaxK];
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      pk[k] = -1;
      pg[k] = 0.f;
      if (k < K) {
        float best = -2.f;
        int bi = 0;
#pragma unroll
        for (int e = 0; e < kMaxE; ++e)
          if (!((mask >> e) & 1ull) && p[e] > best) {   // lower e on a tie
            best = p[e];
            bi = e;
          }
        mask |= 1ull << bi;
        pk[k] = bi;
        pg[k] = best;
        total += best;
      }
    }
    if (!valid) mask = 0;

    // rank within the expert: rows of earlier lanes of this warp, then of
    // earlier warps of the chunk, then of earlier chunks
    int lr[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) lr[k] = 0;
    const unsigned lt = (1u << lane) - 1u;
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) {
      const unsigned b = __ballot_sync(0xffffffffu, (mask >> e) & 1ull);
      if (lane == 0) s_pre[warp][e] = __popc(b);
      const int pre = __popc(b & lt);
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (pk[k] == e) lr[k] = pre;
    }
    __syncthreads();
    if (tid < kMaxE) {
      int run = s_cnt[tid];
      for (int w = 0; w < kRouteWarps; ++w) {
        const int c = s_pre[w][tid];
        s_pre[w][tid] = run;
        run += c;
      }
      s_cnt[tid] = run;
    }
    __syncthreads();
    if (valid) {
#pragma unroll
      for (int k = 0; k < kMaxK; ++k) {
        if (k >= K) break;
        const int j = t * K + k;
        idx[j] = pk[k];
        rank[j] = s_pre[warp][pk[k]] + lr[k];
        gate[j] = (norm ? pg[k] / total : pg[k]) * scale;
      }
    }
    __syncthreads();                  // s_pre is rewritten by the next chunk
  }

  if (tid == 0) {
    int off = 0, tend = 0;
    for (int e = 0; e < E; ++e) {
      s_off[e] = off;
      off += s_cnt[e];
      tend += (s_cnt[e] + bm - 1) / bm;
      s_tend[e] = tend;
    }
  }
  __syncthreads();
  if (tid < E) {
    offs[tid] = s_off[tid];
    if (s_cnt[tid] > 0)
      atomicAdd(counter + tid, static_cast<unsigned long long>(s_cnt[tid]));
  }
  for (int tl = tid; tl < n_tiles; tl += kRouteThreads) {
    int e = 0;
    while (e < E && s_tend[e] <= tl) ++e;
    int ex = -1, r0 = 0, r1 = 0;
    if (e < E) {
      const int cnt = s_cnt[e];
      const int ts = s_tend[e] - (cnt + bm - 1) / bm;
      ex = e;
      r0 = s_off[e] + (tl - ts) * bm;
      r1 = min(r0 + bm, s_off[e] + cnt);
    }
    tiles[3 * tl] = ex;
    tiles[3 * tl + 1] = r0;
    tiles[3 * tl + 2] = r1;
  }
  // idx, rank and gate were written by other threads of this block: the
  // barriers above make them visible here
  for (int j = tid; j < T * K; j += kRouteThreads) {
    const int pos = s_off[idx[j]] + rank[j];
    slot[pos] = j;
    sgate[pos] = gate[j];
  }
}

// ========================================================= grouped product
constexpr int kBK = 64;                   // reduction rows a stage
constexpr int kStages = 4;
constexpr int kBox = 64;                  // columns of a B box (128 bytes)
constexpr int kBoxBytes = kBK * 128;
constexpr int kAPitch = 144;              // bytes of an A row: 64 bf16 + 16

// Shared memory of one instance, from a 1024-byte aligned base: kStages
// stages of [2 NB B boxes][A: kBM rows x kAPitch], each a multiple of
// 1024 bytes (so every B box starts on a swizzle atom), then the stages'
// full barriers.
template <int WG, int NB>
struct GemmCfg {
  static constexpr int kBM = 64 * WG;
  static constexpr int kThreads = 128 * WG;
  static constexpr int kABytes = kBM * kAPitch;
  static constexpr int kBBytes = 2 * NB * kBoxBytes;
  static constexpr int kStageBytes = kBBytes + kABytes;
  static constexpr int kBar = kStages * kStageBytes;
  static constexpr int kBytes = kBar + 8 * kStages + 1024;
  static constexpr int kCopies = kBM * (kBK / 8) / kThreads;  // A's, a thread
  static_assert(kStageBytes % 1024 == 0, "stages on swizzle atoms");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float silu(float g) {
  return g / (1.f + __expf(-g));
}

// D (64 x 64 NB) += A (registers) B (NB boxes of 64 columns, kBoxBytes
// apart: the leading byte offset).
template <int NB>
__device__ __forceinline__ void mma(float (&d)[32 * NB],
                                    const uint32_t (&a)[4], uint32_t b) {
  const uint64_t desc = desc_b128(b, kBoxBytes, 1024);
  if constexpr (NB == 1)
    wgmma_m64n64k16_rs(d, a, desc, 1);
  else
    wgmma_m64n128k16_rs(d, a, desc, 1);
}

// Two accumulators of 64 NB columns a thread's warpgroup, acc0 fed by
// the stage's first NB boxes and acc1 by the next NB.  GATED: out = h
// (rows x N, bf16) = silu(A W0) * (A W1) over columns n0 .. n0 + 64 NB,
// A's rows the tokens of the tile's slots (a = x, T x Kdim); tm0 / tm1
// map W_gate and W_up (E x Kdim x N).  Else: out = y (T k x N, float32),
// row slot[r] = sgate[r] * (A W0)[r] over columns n0 .. n0 + 128 NB, A =
// the sorted hidden rows (a = h, rows x Kdim), tm0 maps W_down (acc1 the
// second 64 NB columns).
template <int WG, bool GATED, int NB>
__global__ void __launch_bounds__(128 * WG) moe_gemm_kernel(
    const __grid_constant__ CUtensorMap tm0,
    const __grid_constant__ CUtensorMap tm1,
    const __nv_bfloat16* __restrict__ a, void* __restrict__ out,
    const int* __restrict__ slot, const float* __restrict__ sgate,
    const int* __restrict__ tiles, int Kdim, int N, int k_top) {
  using L = GemmCfg<WG, NB>;
  constexpr int W = kBox * NB;            // an accumulator's columns
  const int tile = blockIdx.y;
  const int e = tiles[3 * tile];
  if (e < 0) return;                      // past the used tiles
  const int r0 = tiles[3 * tile + 1], r1 = tiles[3 * tile + 2];
  constexpr int BN = GATED ? W : 2 * W;
  const int n0 = blockIdx.x * BN;
  const int n1 = GATED ? n0 : n0 + W;     // acc1's first column
  const bool has1 = n1 < N;               // uniform over the CTA
  // boxes of the stage within the width (TMA loads only those)
  int n_box = 0;
#pragma unroll
  for (int b = 0; b < 2 * NB; ++b)
    n_box += (b < NB ? n0 : n1) + kBox * (b % NB) < N;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* const sp =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_addr(sp);
  const uint32_t full = base + L::kBar;
  const int tid = threadIdx.x;
  const int nk = (Kdim + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + 8 * s, 1);
    fence_mbar_init();
  }

  // this thread's A copies: row r = idx / 8, 16-byte chunk c = idx % 8
  const __nv_bfloat16* src[L::kCopies];
  int col[L::kCopies];
  uint32_t dst[L::kCopies];
#pragma unroll
  for (int q = 0; q < L::kCopies; ++q) {
    const int i = tid + q * L::kThreads;
    const int r = i / 8, c = i % 8;
    const int row = r0 + r < r1 ? r0 + r : r0;
    const long long arow = GATED ? slot[row] / k_top : row;
    src[q] = a + arow * Kdim + 8 * c;
    col[q] = 8 * c;
    dst[q] = L::kBBytes + r * kAPitch + 16 * c;
  }
  __syncthreads();

  const CUtensorMap* const map0 = &tm0;
  const CUtensorMap* const map1 = GATED ? &tm1 : &tm0;
  auto load_stage = [&](int s, int j) {
    const int k0 = j * kBK;
    const uint32_t sb = base + s * L::kStageBytes;
    if (tid == 0) {
      mbar_expect_tx(full + 8 * s, n_box * kBoxBytes);
#pragma unroll
      for (int b = 0; b < 2 * NB; ++b) {
        const int col = (b < NB ? n0 : n1) + kBox * (b % NB);
        if (col < N)
          tma_load_3d(sb + b * kBoxBytes, b < NB ? map0 : map1,
                      full + 8 * s, col, k0, e);
      }
    }
    uint8_t* const st = sp + s * L::kStageBytes;
#pragma unroll
    for (int q = 0; q < L::kCopies; ++q) {
      if (k0 + col[q] < Kdim)
        cp_async16(st + dst[q], src[q] + k0);
      else
        *reinterpret_cast<uint4*>(st + dst[q]) = make_uint4(0, 0, 0, 0);
    }
  };

  const int warp = tid / 32, lane = tid % 32;
  // ldmatrix: lane l reads row 16 warp + l % 16, columns 8 (l / 16) on
  const uint32_t a_lane =
      L::kBBytes + (16 * warp + lane % 16) * kAPitch + (lane / 16) * 16;

  float acc0[W / 2], acc1[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc0[i] = acc1[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < nk; ++i) {
    cp_async_wait<kStages - 2>();         // this thread's A of step i
    __syncthreads();                      // everyone's; step i - 1 retired
    {
      const int j = i + kStages - 1;      // refill step i - 1's stage
      if (j < nk) load_stage(j % kStages, j);
      cp_async_commit();
    }
    const int s = i % kStages;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    const uint32_t sb = base + s * L::kStageBytes;
    uint32_t af[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      ldmatrix_x4(af[kk], sb + a_lane + kk * 32);
    fence_regs(acc0);
    fence_regs(acc1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      mma<NB>(acc0, af[kk], sb + kk * 16 * 128);
      if (has1) mma<NB>(acc1, af[kk], sb + NB * kBoxBytes + kk * 16 * 128);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) fence_regs(af[kk]);
  }

  // accumulator i of a thread: row 16 warp + lane / 4 + 8 ((i / 2) % 2),
  // column 8 (i / 4) + 2 (lane % 4) + i % 2
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * warp + lane / 4 + 8 * h;
    if (row >= r1) continue;
    if constexpr (GATED) {
      __nv_bfloat16* const orow =
          static_cast<__nv_bfloat16*>(out) + static_cast<long long>(row) * N;
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const int cn = n0 + 8 * j + c0;
        if (cn < N)
          *reinterpret_cast<uint32_t*>(orow + cn) = pack_bf16(
              silu(acc0[4 * j + 2 * h]) * acc1[4 * j + 2 * h],
              silu(acc0[4 * j + 2 * h + 1]) * acc1[4 * j + 2 * h + 1]);
      }
    } else {
      const float g = sgate[row];
      float* const orow =
          static_cast<float*>(out) + static_cast<long long>(slot[row]) * N;
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const int cn = n0 + 8 * j + c0;
        if (cn < N)
          *reinterpret_cast<float2*>(orow + cn) = make_float2(
              acc0[4 * j + 2 * h] * g, acc0[4 * j + 2 * h + 1] * g);
        const int cm = n1 + 8 * j + c0;
        if (has1 && cm < N)
          *reinterpret_cast<float2*>(orow + cm) = make_float2(
              acc1[4 * j + 2 * h] * g, acc1[4 * j + 2 * h + 1] * g);
      }
    }
  }
}

cudaError_t opt_in(const void* kernel, size_t smem) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> allowed;
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

// A contiguous bf16 (E, Kdim, N) weight as the 3-D tensor map {N, Kdim,
// E}: boxes of 64 columns (128 bytes, swizzled) x kBK reduction rows.
bool weight_map(CUtensorMap* map, const void* w, int E, int Kdim, int N) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(Kdim),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N) * 2,
                                 static_cast<cuuint64_t>(Kdim) * N * 2};
  const cuuint32_t box[3] = {kBox, kBK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(w), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int WG, bool GATED, int NB>
int launch_gemm(const void* a, const void* w0, const void* w1, void* out,
                const int* slot, const float* sgate, const int* tiles,
                int n_tiles, int E, int Kdim, int N, int k_top,
                cudaStream_t stream) {
  using L = GemmCfg<WG, NB>;
  CUtensorMap t0, t1;
  if (!weight_map(&t0, w0, E, Kdim, N) ||
      !weight_map(&t1, GATED ? w1 : w0, E, Kdim, N))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = moe_gemm_kernel<WG, GATED, NB>;
  cudaError_t err = opt_in(reinterpret_cast<const void*>(kernel), L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int BN = (GATED ? 1 : 2) * kBox * NB;
  const dim3 grid((N + BN - 1) / BN, n_tiles);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(
      t0, t1, static_cast<const __nv_bfloat16*>(a), out, slot, sgate, tiles,
      Kdim, N, k_top);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// logits (T, E) float32; idx, rank, gate (T, K); offs (E,); slot, sgate
// (T K,); tiles (n_tiles, 3) int32; counter (E,) int64, added to.  E <= 64,
// 1 <= K <= min(E, 8), n_tiles >= ceil(T K / bm) + E.  All contiguous on
// the current device.
extern "C" int moe_route_launch(const float* logits, int* idx, int* rank,
                                float* gate, int* offs, int* slot,
                                float* sgate, int* tiles, long long* counter,
                                int T, int E, int K, int bm, int n_tiles,
                                int norm, float scale, cudaStream_t stream) {
  if (T < 1 || E < 1 || E > kMaxE || K < 1 || K > kMaxK || K > E ||
      bm < 1 || n_tiles < (T * K + bm - 1) / bm + E)
    return static_cast<int>(cudaErrorInvalidValue);
  moe_route_kernel<<<1, kRouteThreads, 0, stream>>>(
      logits, idx, rank, gate, offs, slot, sgate, tiles,
      reinterpret_cast<unsigned long long*>(counter), T, E, K, bm, n_tiles,
      norm, scale);
  return static_cast<int>(cudaGetLastError());
}

// which 0 (gate-up): a = x (T, Kdim), w0 / w1 = W_gate / W_up (E, Kdim, N),
// out = h (T k_top, N) bfloat16.  which 1 (down): a = h (T k_top, Kdim),
// w0 = W_down (E, Kdim, N), w1 unused, out = y (T k_top, N) float32.
// slot, sgate and tiles from moe_route_launch with bm = 64 wg; wg 1 or 2.
// bfloat16 a and weights, contiguous, 16-byte aligned, Kdim and N
// multiples of 8.
extern "C" int moe_gemm_launch(int which, const void* a, const void* w0,
                               const void* w1, void* out, const int* slot,
                               const float* sgate, const int* tiles,
                               int n_tiles, int E, int Kdim, int N,
                               int k_top, int wg, cudaStream_t stream) {
  if (n_tiles < 1 || n_tiles > 65535 || E < 1 || Kdim < 8 || N < 8 ||
      Kdim % 8 != 0 || N % 8 != 0 || k_top < 1 || !aligned16(a) ||
      !aligned16(w0) || !aligned16(out) || (which == 0 && !aligned16(w1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (which == 0 && wg == 1)
    return launch_gemm<1, true, 1>(a, w0, w1, out, slot, sgate, tiles,
                                   n_tiles, E, Kdim, N, k_top, stream);
  if (which == 0 && wg == 2)
    return launch_gemm<2, true, 2>(a, w0, w1, out, slot, sgate, tiles,
                                   n_tiles, E, Kdim, N, k_top, stream);
  if (which == 1 && wg == 1)
    return launch_gemm<1, false, 1>(a, w0, w1, out, slot, sgate, tiles,
                                    n_tiles, E, Kdim, N, k_top, stream);
  if (which == 1 && wg == 2)
    return launch_gemm<2, false, 2>(a, w0, w1, out, slot, sgate, tiles,
                                    n_tiles, E, Kdim, N, k_top, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
