// Greedy decode head for Hopper (sm_90a):
//   h   = LeakyReLU_0.1(x . W1^T + b1)            (B, H) f32
//   ids = argmax_v(cast(h, T) . W2^T)             (B,)   int32, first index on ties
// The (B, V) logits are never written to device memory.
//
// Replaces the TPU kernel consistent__style_transfer_tpu/kernels/decode_step.py::
// fused_decode_logits (body `_kernel`, pallas_call at decode_step.py:108). That
// kernel walks V in order, one grid step per 2048-column tile, carrying a running
// (max, argmax) in VMEM scratch; Hopper runs blocks in parallel and in no order,
// so here every block reduces its own columns and the blocks meet in a 64-bit
// atomicMin instead.
//
// Layouts are the port's nn.Linear ones, read in place: x (B, Din), W1 =
// fn_1.weight (H, Din), b1 (H,), W2 = fn_2.weight (V, H), all row-major, so both
// products are "TN": every operand is K-major. T is float or __nv_bfloat16;
// products accumulate in f32 either way.
//
// What bounds it (NVIDIA H100 SXM: 3.35 TB/s, 989 TFLOP/s dense bf16, 67 TFLOP/s
// f32 without tensor cores), at yelp shapes B=256, Din=1024, H=512, V=10000:
//   bytes, bf16: W2 10.24 MB + W1 1.05 MB + x 0.52 MB + h out 0.52 MB (+ b1, ids)
//                = 12.3 MB -> 3.7 us
//   operations:  2*B*Din*H + 2*B*H*V = 0.27 + 2.62 = 2.89 GFLOP -> 2.9 us in bf16
//   so in bf16 the call is memory-bound at about 3.7 us, and W2 is 83% of its
//   bytes: W2 must be read once, by blocks that keep their loads in flight. In
//   f32 without TF32 the 2.89 GFLOP take 43 us at the CUDA cores' rate: bound by
//   operations.
//
// Each call is two kernels and nothing else on the stream:
//   1. the FFN kernel: h (f32 out) and its bf16 copy (the vocab product's A
//      operand, rounded as decode_step.py:55 casts h to W2's dtype) in a
//      workspace; it also sets the per-row argmax keys to their start value.
//   2. the vocab kernel: logits tile by tile, reduced to one (max, first argmax)
//      per row in the epilogue, merged across blocks with a 64-bit atomicMin on
//      key = (~orderable f32 bits << 32) | col: a larger value gives a smaller
//      key and, for equal values, so does the smaller column. The low word of
//      a row's final key is its argmax, so the ids are the keys' low words
//      (an int32 view of the workspace) and need no pass of their own.
//
// bf16 (the serving dtype): tensor cores. Both kernels are one producer warp that
// keeps TMA loads (128-byte swizzle, 64 K-elements a stage) in flight into a ring
// of shared-memory stages, and consumer warpgroups that run wgmma m64nNk16 on
// them with f32 accumulators in registers.
//   FFN:   a 64 x 16 tile per block (one warpgroup, n16): 128 blocks at yelp
//          shapes, bias and LeakyReLU in the epilogue.
//   vocab: a strip of 80 vocab rows per block (125 blocks at V=10000, one wave on
//          132 SMs), so W2 is read once; the block walks all B rows in passes of
//          256 (two warpgroups x two m64 tiles, 80 accumulators a thread). Columns
//          >= V are masked before the argmax: TMA zero-fills W2's rows past V, so
//          a padded column would score 0 and beat an all-negative row. Each row's
//          80 columns sit in one quad of lanes, so the reduction is registers and
//          two shuffles, with no shared memory.
//   Measured on the card, both kernels are set by fixed latency (launch, first
//   loads, epilogue) more than by their bytes, so the vocab kernel is launched
//   as a programmatic dependent of the FFN kernel: its launch overlaps the
//   FFN's tail, and its blocks request their first W2 stages before they wait
//   for h.
// f32 (the parity path): CUDA cores, no TF32 (TF32 would change greedy ids
// against the CPU's f32). An SGEMM-style product: 256 threads, register
// micro-tiles strided by 16 rows and 16 columns, 16-byte cp.async loads along K
// into a ring of stages (3-4 deep, 32 of K each, so that enough bytes are in
// flight to cover L2's latency) whose rows are padded by 4 floats (a
// quarter-warp reading 8 consecutive rows hits 8 distinct 16-byte bank groups).
// Tiles: FFN 32 x 32 (128 blocks at yelp shapes), vocab 128 x 80 (250 blocks,
// two resident on an SM: one wave on 132 SMs).
//
// Each entry point returns cudaGetLastError() after its launches, or
// kEncodeError + the CUresult of a failed tensor-map encode.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <mutex>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kEncodeError = 100000;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ----------------------------------------------------------- argmax keys
constexpr unsigned long long kNoKey = ~0ull;  // above every real key

// Order-reversing map of (value, column) onto 64 unsigned bits: a larger value
// gives a smaller key and, for equal values, a smaller column does; the low
// word is the column.
__device__ __forceinline__ unsigned long long pack_key(float v, int col) {
  if (v == 0.f) v = 0.f;  // -0 and +0 tie, as they do for torch.argmax
  unsigned int u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // orderable: larger v, larger u
  return ((unsigned long long)~u << 32) | (unsigned int)col;
}

// A row's best (value, column) so far; column -1 is none.
struct Best {
  float v = -INFINITY;
  int c = -1;
  __device__ __forceinline__ void offer(float ov, int oc) {
    if (oc >= 0 && (c < 0 || ov > v || (ov == v && oc < c))) {
      v = ov;
      c = oc;
    }
  }
  __device__ __forceinline__ void merge_xor(int lane_mask) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, lane_mask);
    const int oc = __shfl_xor_sync(0xffffffffu, c, lane_mask);
    offer(ov, oc);
  }
  __device__ __forceinline__ void merge_into(unsigned long long* keys, int row) const {
    if (c >= 0) atomicMin(&keys[row], pack_key(v, c));
  }
};

// Workspace of one call: keys (B,) u64, then (bf16 only) h rounded to bf16,
// (B, H), from the next 256-byte boundary. kernels/decode_step.py sizes it and
// reads the ids as the keys' low words.
struct Workspace {
  unsigned long long* keys;
  bf16* hb;
};

Workspace split_workspace(void* ws, int B) {
  char* base = static_cast<char*>(ws);
  const size_t hb_offset = ((size_t)B * 8 + 255) / 256 * 256;
  return {reinterpret_cast<unsigned long long*>(base), reinterpret_cast<bf16*>(base + hb_offset)};
}

// Run by every thread of the FFN kernel, which precedes the vocab kernel on the
// stream: the keys start above every real key for each call.
__device__ __forceinline__ void reset_keys(unsigned long long* keys, int B) {
  const int stride = gridDim.x * gridDim.y * blockDim.x;
  for (int i = (blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x; i < B;
       i += stride)
    keys[i] = kNoKey;
}

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : 0.1f * v; }

// ====================================================== bf16: wgmma + TMA
constexpr int kKB = 64;  // K elements a stage: one 128-byte swizzled row of bf16

// A block: kWG consumer warpgroups, each owning kMT m64 tiles of a pass of MB
// rows, against BN columns, then one producer warp.
template <int kWG_, int kMT_, int BN_, int kStages_>
struct TcShape {
  static constexpr int kWG = kWG_, kMT = kMT_, BN = BN_, kStages = kStages_;
  static constexpr int MB = kWG * kMT * 64;
  static constexpr int kABytes = MB * kKB * 2, kBBytes = BN * kKB * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kConsumers = kWG * 128;
  static constexpr int kThreads = kConsumers + 32;
  // 1024 of slack to align the stages, then the full and empty barriers
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
  static_assert(kBBytes % 1024 == 0, "every tile starts 1024-byte aligned (the swizzle atom)");
};
// FFN: 64 x 16 tiles, an 80 KB ring. Vocab: 256 x 80 passes, a 168 KB ring.
using FfnShape = TcShape<1, 1, 16, 8>;
using VocabShape = TcShape<2, 2, 80, 4>;

template <class S>
struct TcSmem {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  __device__ explicit TcSmem(uint8_t* raw) {
    base = raw + ((1024 - (hopper::smem_addr(raw) & 1023)) & 1023);
    full = reinterpret_cast<uint64_t*>(base + S::kStages * S::kStageBytes);
    empty = full + S::kStages;
  }
  __device__ uint8_t* a(int s) const { return base + s * S::kStageBytes; }
  __device__ uint8_t* b(int s) const { return a(s) + S::kABytes; }

  // thread 0 initialises, then the whole block meets once before roles split
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S::kStages; ++s) {
        hopper::mbar_init(&full[s], 1);
        hopper::mbar_init(&empty[s], S::kConsumers);
      }
      hopper::mbar_fence_init();
    }
    __syncthreads();
  }
};

// Passes of MB rows this block makes: blockIdx.y, then every gridDim.y-th.
template <class S>
__device__ __forceinline__ int tc_passes(int M) {
  return cdiv(cdiv(M, S::MB) - (int)blockIdx.y, gridDim.y);
}

// The producer warp's one thread: for every pass and every 64-wide K chunk,
// wait for a free stage and load the pass's A rows and the block's BN rows of
// the B operand into it. With kAfterPrevGrid, A is written by the grid before
// this one on the stream: the first round of stages gets its B tiles at once
// and its A tiles only after that grid has completed.
template <class S, bool kAfterPrevGrid>
__device__ __forceinline__ void tc_produce(const TcSmem<S>& sm, const CUtensorMap* map_a,
                                           const CUtensorMap* map_b, int M, int K, int n0) {
  if (threadIdx.x != S::kConsumers) return;
  hopper::prefetch_tensormap(map_a);
  hopper::prefetch_tensormap(map_b);
  const int nk = cdiv(K, kKB), total = tc_passes<S>(M) * nk;
  auto row_a = [&](int it) { return ((int)blockIdx.y + it / nk * (int)gridDim.y) * S::MB; };
  int it = 0;
  if constexpr (kAfterPrevGrid) {
    const int first = min(S::kStages, total);
    for (; it < first; ++it) {
      hopper::mbar_arrive_expect_tx(&sm.full[it], S::kStageBytes);
      hopper::tma_load_2d(sm.b(it), map_b, it % nk * kKB, n0, &sm.full[it]);
    }
    hopper::grid_dependency_wait();
    for (int i = 0; i < first; ++i)
      hopper::tma_load_2d(sm.a(i), map_a, i % nk * kKB, row_a(i), &sm.full[i]);
  }
  for (; it < total; ++it) {
    const int s = it % S::kStages;
    hopper::mbar_wait(&sm.empty[s], ((it / S::kStages) & 1) ^ 1);
    hopper::mbar_arrive_expect_tx(&sm.full[s], S::kStageBytes);
    hopper::tma_load_2d(sm.a(s), map_a, it % nk * kKB, row_a(it), &sm.full[s]);
    hopper::tma_load_2d(sm.b(s), map_b, it % nk * kKB, n0, &sm.full[s]);
  }
}

// The consumer warpgroups: for every pass, accumulate the warpgroup's kMT m64
// tiles over all of K, then hand the accumulators and the pass's first row of
// this warpgroup to `epilogue`.
template <class S, class Epilogue>
__device__ __forceinline__ void tc_consume(const TcSmem<S>& sm, int M, int K, Epilogue&& epilogue) {
  const int wg = threadIdx.x / 128, nk = cdiv(K, kKB);
  float acc[S::kMT][S::BN / 2];
  int it = 0;
  for (int mt = blockIdx.y; mt * S::MB < M; mt += gridDim.y) {
#pragma unroll
    for (int t = 0; t < S::kMT; ++t)
#pragma unroll
      for (int i = 0; i < S::BN / 2; ++i) acc[t][i] = 0.f;
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % S::kStages;
      hopper::mbar_wait(&sm.full[s], (it / S::kStages) & 1);
      const uint64_t da = hopper::sw128_desc(sm.a(s) + wg * S::kMT * 64 * 128);
      const uint64_t db = hopper::sw128_desc(sm.b(s));
#pragma unroll
      for (int t = 0; t < S::kMT; ++t) hopper::fence_regs(acc[t]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKB / 16; ++kk)
#pragma unroll
        for (int t = 0; t < S::kMT; ++t)  // m64 tile t is 64 rows x 128 bytes further on
          hopper::Wgmma<S::BN>::mma(acc[t], da + t * (64 * 128 >> 4) + 2 * kk, db + 2 * kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int t = 0; t < S::kMT; ++t) hopper::fence_regs(acc[t]);
      hopper::mbar_arrive(&sm.empty[s]);
    }
    epilogue(acc, mt * S::MB + wg * S::kMT * 64);
  }
}

// (1) h = LeakyReLU_0.1(x . W1^T + b1): h in f32 and, rounded, in bf16.
__global__ void __launch_bounds__(FfnShape::kThreads, 1)
ffn_bf16_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w1,
                const bf16* __restrict__ b1, float* __restrict__ h, bf16* __restrict__ hb,
                unsigned long long* __restrict__ keys, int B, int Din, int H) {
  using S = FfnShape;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  hopper::launch_dependents();  // the vocab kernel may start its blocks now
  reset_keys(keys, B);
  const TcSmem<S> sm(smem_raw);
  sm.init();
  const int n0 = blockIdx.x * S::BN;
  if (threadIdx.x >= S::kConsumers) {
    tc_produce<S, false>(sm, &map_x, &map_w1, B, Din, n0);
    return;
  }
  const int w = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
  tc_consume(sm, B, Din, [&](float (&acc)[S::kMT][S::BN / 2], int row0) {
#pragma unroll
    for (int t = 0; t < S::kMT; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + t * 64 + 16 * w + l / 4 + 8 * half;
        if (row >= B) continue;
#pragma unroll
        for (int i = 0; i < S::BN / 8; ++i) {
          const int col = n0 + 8 * i + 2 * (l % 4);  // even, and H % 16 == 0: col + 1 < H too
          if (col >= H) break;
          const float v0 = leaky(acc[t][4 * i + 2 * half] + __bfloat162float(b1[col]));
          const float v1 = leaky(acc[t][4 * i + 2 * half + 1] + __bfloat162float(b1[col + 1]));
          *reinterpret_cast<float2*>(&h[(size_t)row * H + col]) = make_float2(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(&hb[(size_t)row * H + col]) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
  });
}

// (2) ids = argmax_v(hb . W2^T): each block owns vocab rows [n0, n0 + 80).
// Launched as a programmatic dependent of (1): nothing (1) writes is read
// before grid_dependency_wait.
__global__ void __launch_bounds__(VocabShape::kThreads, 1)
vocab_argmax_bf16_kernel(const __grid_constant__ CUtensorMap map_hb,
                         const __grid_constant__ CUtensorMap map_w2,
                         unsigned long long* __restrict__ keys, int B, int H, int V) {
  using S = VocabShape;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const TcSmem<S> sm(smem_raw);
  sm.init();
  const int n0 = blockIdx.x * S::BN;
  if (threadIdx.x >= S::kConsumers) {
    tc_produce<S, true>(sm, &map_hb, &map_w2, B, H, n0);
    return;
  }
  hopper::grid_dependency_wait();  // the keys were reset by (1)
  const int w = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
  // this thread's 20 columns of a row (t, half): the max, then the first
  // column that holds it; only the block at the ragged end of V masks columns
  auto row_best = [&](const float (&a)[S::BN / 2], int half, auto masked) {
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < S::BN / 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (!decltype(masked)::value || n0 + 8 * i + 2 * (l % 4) + c < V)
          m = fmaxf(m, a[4 * i + 2 * half + c]);
    Best best;
#pragma unroll
    for (int i = S::BN / 8 - 1; i >= 0; --i)
#pragma unroll
      for (int c = 1; c >= 0; --c) {
        const int col = n0 + 8 * i + 2 * (l % 4) + c;
        if ((!decltype(masked)::value || col < V) && a[4 * i + 2 * half + c] == m) best = {m, col};
      }
    return best;
  };
  const bool ragged = n0 + S::BN > V;
  tc_consume(sm, B, H, [&](float (&acc)[S::kMT][S::BN / 2], int row0) {
#pragma unroll
    for (int t = 0; t < S::kMT; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        Best best = ragged ? row_best(acc[t], half, std::true_type{})
                           : row_best(acc[t], half, std::false_type{});
        best.merge_xor(1);  // the quad of lanes that holds this row's columns
        best.merge_xor(2);
        const int row = row0 + t * 64 + 16 * w + l / 4 + 8 * half;
        if (l % 4 == 0 && row < B) best.merge_into(keys, row);
      }
  });
}

// ============================================= f32: CUDA-core SGEMM tiles
namespace f32k {

constexpr int kThreads = 256;  // 16 x 16: thread (tx, ty) = (tid % 16, tid / 16)
// 32 of K a stage, so that each SM keeps enough bytes in flight to cover L2's
// latency; rows padded by 4 floats, so a quarter-warp reading 8 consecutive
// rows at one k hits 8 distinct 16-byte bank groups.
constexpr int kBK = 32, kLd = kBK + 4;

// A stage holds kBK of K for BM rows of A and BN rows of B.
template <int BM, int BN, int kStages>
struct Tiles {
  float a[kStages][BM][kLd];
  float b[kStages][BN][kLd];
};

// Rows [m0, m0 + R) x K columns [k0, k0 + kBK) of a K-major (rows, K) matrix
// into dst, 16 bytes a copy; rows past `rows` and columns past K are zero-filled.
template <int R>
__device__ __forceinline__ void load_rows(float (*dst)[kLd], const float* __restrict__ src,
                                          int rows, int K, int m0, int k0) {
#pragma unroll
  for (int c = threadIdx.x; c < R * kBK / 4; c += kThreads) {
    const int r = c / (kBK / 4), k = k0 + 4 * (c % (kBK / 4)), m = m0 + r;
    const bool in = m < rows && k < K;  // K % 16 == 0: 4 columns are all in or all out
    hopper::cp_async16(&dst[r][k - k0], in ? src + (size_t)m * K + k : src, in);
  }
}

// acc[i][j] += sum_k A[m0 + ty + 16i, k] * Bm[n0 + tx + 16j, k]. A ring of
// kStages stages: kStages - 1 loads in flight while one is read.
template <int BM, int BN, int kStages>
__device__ __forceinline__ void sgemm_tn(const float* __restrict__ A, const float* __restrict__ Bm,
                                         int M, int N, int K, int m0, int n0,
                                         Tiles<BM, BN, kStages>& t,
                                         float (&acc)[BM / 16][BN / 16]) {
  constexpr int TM = BM / 16, TN = BN / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, nk = cdiv(K, kBK);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      load_rows<BM>(t.a[s], A, M, K, m0, s * kBK);
      load_rows<BN>(t.b[s], Bm, N, K, n0, s * kBK);
    }
    hopper::cp_async_commit();  // one group per stage, empty or not
  }
  for (int kt = 0; kt < nk; ++kt) {
    hopper::cp_async_wait<kStages - 2>();  // this thread's copies of stage kt landed
    __syncthreads();                       // everyone's did, and stage kt - 1 is read
    const int next = kt + kStages - 1;
    if (next < nk) {
      load_rows<BM>(t.a[next % kStages], A, M, K, m0, next * kBK);
      load_rows<BN>(t.b[next % kStages], Bm, N, K, n0, next * kBK);
    }
    hopper::cp_async_commit();
    const int s = kt % kStages;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(&t.a[s][ty + 16 * i][kk]);
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = *reinterpret_cast<const float4*>(&t.b[s][tx + 16 * j][kk]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
  }
  hopper::cp_async_wait<0>();
}

// FFN 32 x 32 tiles: 128 blocks at yelp shapes. Vocab 128 x 80 tiles: 250
// blocks at V=10000, all resident at two a SM (one wave on 132 SMs).
constexpr int kFfnBM = 32, kFfnBN = 32, kFfnStages = 4;
constexpr int kVocabBM = 128, kVocabBN = 80, kVocabStages = 3;
using FfnTiles = Tiles<kFfnBM, kFfnBN, kFfnStages>;            // 36 KB
using VocabTiles = Tiles<kVocabBM, kVocabBN, kVocabStages>;  // 88 KB
constexpr int kVocabSmem = sizeof(VocabTiles);  // dynamic shared memory

__global__ void __launch_bounds__(kThreads)
ffn_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, float* __restrict__ h,
               unsigned long long* __restrict__ keys, int B, int Din, int H) {
  __shared__ __align__(16) FfnTiles tiles;
  reset_keys(keys, B);
  float acc[kFfnBM / 16][kFfnBN / 16] = {};
  const int m0 = blockIdx.y * kFfnBM, n0 = blockIdx.x * kFfnBN;
  sgemm_tn(x, w1, B, H, Din, m0, n0, tiles, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kFfnBM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kFfnBN / 16; ++j) {
      const int row = m0 + ty + 16 * i, col = n0 + tx + 16 * j;
      if (row < B && col < H) h[(size_t)row * H + col] = leaky(acc[i][j] + b1[col]);
    }
}

__global__ void __launch_bounds__(kThreads, 2)
vocab_argmax_f32_kernel(const float* __restrict__ h, const float* __restrict__ w2,
                        unsigned long long* __restrict__ keys, int B, int H, int V) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  VocabTiles& tiles = *reinterpret_cast<VocabTiles*>(smem_raw);
  float acc[kVocabBM / 16][kVocabBN / 16] = {};
  const int m0 = blockIdx.y * kVocabBM, n0 = blockIdx.x * kVocabBN;
  sgemm_tn(h, w2, B, V, H, m0, n0, tiles, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < kVocabBM / 16; ++i) {
    Best best;
#pragma unroll
    for (int j = 0; j < kVocabBN / 16; ++j) {
      const int col = n0 + tx + 16 * j;  // increasing: first max kept
      if (col < V) best.offer(acc[i][j], col);
    }
    // the 16 threads of a row are one half-warp: xor offsets < 16 stay in it
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) best.merge_xor(off);
    const int row = m0 + ty + 16 * i;
    if (tx == 0 && row < B) best.merge_into(keys, row);
  }
}

}  // namespace f32k

// ================================================================== host
std::mutex g_host_mutex;  // guards the tensor-map cache and the attribute flags

struct MapEntry {
  const void* ptr;
  int rows, cols, box_rows;
  CUtensorMap map;
};
constexpr int kMapCache = 32;
MapEntry g_maps[kMapCache];
int g_maps_used = 0, g_maps_next = 0;

// A (rows, cols) row-major bf16 matrix as 2-d TMA boxes of 64 columns x box_rows
// rows, 128-byte swizzled, zero fill out of bounds. Encoded once per (pointer,
// shape, box): a decode step reuses its weights' maps and, since PyTorch's
// allocator hands back the same blocks, mostly its activations' too.
int tensor_map(CUtensorMap* out, const void* ptr, int rows, int cols, int box_rows) {
  std::lock_guard<std::mutex> lock(g_host_mutex);
  for (int i = 0; i < g_maps_used; ++i) {
    const MapEntry& e = g_maps[i];
    if (e.ptr == ptr && e.rows == rows && e.cols == cols && e.box_rows == box_rows) {
      *out = e.map;
      return 0;
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kKB, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  MapEntry& slot = g_maps[g_maps_next];
  slot = {ptr, rows, cols, box_rows, *out};
  g_maps_next = (g_maps_next + 1) % kMapCache;
  if (g_maps_used < kMapCache) ++g_maps_used;
  return 0;
}

// Dynamic shared memory above 48 KB must be allowed per kernel, once per device.
template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes) {
  static bool done[64] = {};  // one per kernel (template instance) and device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(g_host_mutex);
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

int decode_head_bf16_impl(const void* x, const void* w1, const void* b1, const void* w2,
                          void* h, void* workspace, int B, int Din, int H, int V, cudaStream_t s) {
  const Workspace ws = split_workspace(workspace, B);
  CUtensorMap map_x, map_w1, map_hb, map_w2;
  if (int e = tensor_map(&map_x, x, B, Din, FfnShape::MB)) return e;
  if (int e = tensor_map(&map_w1, w1, H, Din, FfnShape::BN)) return e;
  if (int e = tensor_map(&map_hb, ws.hb, B, H, VocabShape::MB)) return e;
  if (int e = tensor_map(&map_w2, w2, V, H, VocabShape::BN)) return e;
  cudaError_t err = allow_smem(ffn_bf16_kernel, FfnShape::kSmem);
  if (err == cudaSuccess) err = allow_smem(vocab_argmax_bf16_kernel, VocabShape::kSmem);
  if (err != cudaSuccess) return (int)err;
  ffn_bf16_kernel<<<dim3(cdiv(H, FfnShape::BN), cdiv(B, FfnShape::MB)), FfnShape::kThreads,
                    FfnShape::kSmem, s>>>(map_x, map_w1, static_cast<const bf16*>(b1),
                                          static_cast<float*>(h), ws.hb, ws.keys, B, Din, H);
  // a programmatic dependent of the FFN kernel (see vocab_argmax_bf16_kernel)
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cdiv(V, VocabShape::BN));
  cfg.blockDim = dim3(VocabShape::kThreads);
  cfg.dynamicSmemBytes = VocabShape::kSmem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, vocab_argmax_bf16_kernel, map_hb, map_w2, ws.keys, B, H, V);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int decode_head_f32_impl(const void* x, const void* w1, const void* b1, const void* w2, void* h,
                         void* workspace, int B, int Din, int H, int V, cudaStream_t s) {
  using namespace f32k;
  const Workspace ws = split_workspace(workspace, B);
  const cudaError_t err = allow_smem(vocab_argmax_f32_kernel, kVocabSmem);
  if (err != cudaSuccess) return (int)err;
  ffn_f32_kernel<<<dim3(cdiv(H, kFfnBN), cdiv(B, kFfnBM)), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<float*>(h), ws.keys, B, Din, H);
  vocab_argmax_f32_kernel<<<dim3(cdiv(V, kVocabBN), cdiv(B, kVocabBM)), kThreads, kVocabSmem, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(w2), ws.keys, B, H, V);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Pointers: x, w1, b1, w2 in the element type of the name, 16-byte aligned; h
// f32 (B, H); workspace as Workspace above (the ids are the low words of its
// keys). Requires B, V >= 1 and Din, H multiples of 16 (checked by the Python
// wrapper). Launches two kernels on `stream`, does not synchronise, returns
// cudaGetLastError() or kEncodeError + a CUresult.
int decode_head_f32(const void* x, const void* w1, const void* b1, const void* w2, void* h,
                    void* workspace, int B, int Din, int H, int V, void* stream) {
  return decode_head_f32_impl(x, w1, b1, w2, h, workspace, B, Din, H, V,
                              static_cast<cudaStream_t>(stream));
}

int decode_head_bf16(const void* x, const void* w1, const void* b1, const void* w2, void* h,
                     void* workspace, int B, int Din, int H, int V, void* stream) {
  return decode_head_bf16_impl(x, w1, b1, w2, h, workspace, B, Din, H, V,
                               static_cast<cudaStream_t>(stream));
}

const char* decode_step_error_string(int err) {
  if (err < kEncodeError) return cudaGetErrorString(static_cast<cudaError_t>(err));
  static thread_local char msg[160];
  const char* name = nullptr;
  cuGetErrorString(static_cast<CUresult>(err - kEncodeError), &name);
  snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed: CUresult %d (%s)", err - kEncodeError,
           name ? name : "unknown");
  return msg;
}

}  // extern "C"
