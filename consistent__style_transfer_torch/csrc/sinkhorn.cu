// Batched log-domain Sinkhorn optimal-transport cost for Hopper (sm_90a):
//   out[b] = <T_b, D_b>, T_b the entropic plan (epsilon) after n_iters updates
// of the row and column potentials, for p (B, N), q (B, M), D (B, N, M) f32.
// A zero mass masks an atom, wherever it sits, so padding never changes the
// result; a pair whose masks leave no (i, j) (one side empty, or both) gives
// exactly 0.
//
// Replaces the TPU kernels consistent__style_transfer_tpu/kernels/sinkhorn.py::
// sinkhorn_pallas (body `_kernel`, pallas_call at sinkhorn.py:210) and
// sinkhorn_pallas_cr (body `_kernel_cr`, pallas_call at sinkhorn.py:160). Both
// keep one pair's cost matrix and potentials in VMEM for all iterations; the
// first batches 8 pairs per program and pads atoms to 128 lanes, the second
// shapes the potentials as an (N, 1) column and a (1, M) row for Mosaic. Neither
// layout means anything on Hopper, so both names launch this one kernel.
//
// The arithmetic is that of ops/emd.py::sinkhorn_ot_cost: _NEG = -1e30; a
// masked logsumexp takes the max over the pair mask, clamps it to _NEG / 2 and
// adds log(sum exp(x - max)); masked atoms are reset to _NEG after each update;
// T = 0 off the pair mask. Here the masked atoms are dropped before the loop
// (they add exp(_NEG - max) = 0 to every sum and T = 0 at each of their terms),
// and everything runs in base 2: every log-domain quantity is scaled by
// log2(e) once, exp is ex2.approx and log is lg2.approx (both ~2 ulp; the
// results stay within rtol 1e-4 / atol 1e-5 of the plain version). Only those
// two instructions are approximate: no -use_fast_math.
//
// What bounds it, on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 FMA; 16
// special-function results per SM per clock, 132 SMs at 1.98 GHz = 4.2 T/s),
// at a real yelp WMD-label batch (B = 256 pairs of N = M = 27 slots, about 9
// valid atoms a side and 93 valid (i, j) terms a pair, 23.9k terms in all;
// chip_smoke.py::sinkhorn_bound counts them from the batch at each run), for
// the least work the function needs, which is the product form's below:
//   bytes: D 0.75 MB + p, q 0.06 MB read, 1 KB written -> 0.24 us;
//   FMA work: one multiply-add a valid term a half-iteration,
//     2 x 2 x 100 x 23.9k flop -> 0.14 us;
//   special functions: one ex2 and one lg2 a valid atom a half-iteration,
//     0.92M for 4.6k atoms, plus 2^K and the plan's exp a term and the
//     masses' logs: 0.97M -> 0.23 us.
// The bytes bind, just: 0.24 us (chip_smoke.py counts each batch anew).
// (The reference's own form, an exp a term and 5 operations a term a
// logsumexp, would count 1.3 us.) The real
// floor is elsewhere: the 200 half-iterations are a dependent chain (ex2,
// shuffle, FFMA, adds, lg2, subtract: about 100 clocks at the least, plus
// some 4 a term a lane, and the pair with the most atoms sets the batch's
// time), about 10-15 us at 1.98 GHz, and a launch, the prologue's two reads
// from memory and the epilogue add a few us more. 256 pairs fill fewer than
// half of the card's 528 warp schedulers, so each warp runs alone,
// latency-bound.
//
// Design: one warp per pair, no block barrier anywhere.
//   - A block holds kWarps = 2 independent pairs (one each; the grid covers
//     B); 1, 2 and 4 measured alike at the labeler's batches, 8 slower.
//   - Prologue: the warp reads p, q and ballots their masks (N, M <= 64: two
//     32-bit ballots a side), so an atom's compacted index is a popcount of the
//     mask below it. It copies the valid D_ij, read once and coalesced, into
//     shared memory as an n x m matrix and its transpose, rows padded with
//     -inf to an odd stride S, so that 32 lanes over rows, like 32 lanes over
//     columns, read 32 different banks; the compacted log2 masses sit there
//     too.
//   - Sides of at most 32 atoms (the labeler's batches; register_loop): lane
//     k owns atom k of the side a half-iteration updates and holds, in
//     registers, its row (or column) of E = 2^K and its atom's potential; the
//     other side's come by shuffles. A logsumexp is computed as
//     ref + log2(sum_j E_kj 2^(v_j - ref)), ref a warp-uniform value near the
//     potentials: one ex2 a lane, then one shuffle and one FFMA a term, and no
//     max to wait for. The warp keeps a flag of whether every sum stayed in
//     [2^-60, 2^100], where this form loses nothing to f32's range; if one
//     left it (or if the pair's K reach below -100, where an E could be
//     subnormal), the warp runs the pair in the exact form, lse_at_max over
//     the terms K + v (the reference's clamped max). The loop's length L is
//     fixed for the pair, so the whole loop is instantiated for each L and
//     picked once: a choice of length inside the loop (a tree of branches)
//     costs more than a half-iteration. (Splitting a short side's spare
//     lanes into groups over the other side, joined by xor-shuffles,
//     measured slower at the labeler's sizes and was dropped.)
//   - A side over 32 atoms (up to 64; shared_loop): one lane an atom, two
//     rounds, the exact form over terms and potentials in shared memory,
//     __syncwarp between the half-iterations; the length, in steps of 8, is
//     picked once as well.
//   - Epilogue: each lane sums its share of T_ij * D_ij over the valid terms,
//     a warp reduction adds them, lane 0 writes the pair's cost.
// N and M are at most kCap = 64 (book's 45 atoms fit); the wrapper checks.
// The entry points return the CUDA error of the launch (0 on success).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kCap = 64;                         // most atoms per side
constexpr int kRegAtoms = 32;                    // sides up to this many: registers and shuffles
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNeg2 = -1e30f * kLog2e;         // _NEG of ops/emd.py, in base 2
constexpr int kWarps = 2;                        // pairs (warps) per block
constexpr int kMaxSmem = 227 * 1024;             // shared memory a block may use
constexpr int kMaxDevices = 64;                  // devices whose shared-memory opt-in is kept
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__host__ __device__ __forceinline__ int round_up(int x, int to) { return (x + to - 1) / to * to; }

// The row stride of both compacted matrices: odd, and past the longest run of
// terms a lane reads (L <= 32 on the register path, round_up(n, 8) on the
// other).
__host__ __device__ __forceinline__ int stride(int N, int M) {
  return round_up(N > M ? N : M, 16) + 1;
}

// The masked logsumexp of ops/emd.py in base 2, over terms t (c * D plus the
// other side's potential; -inf past the pair's atoms: such a term adds 0):
// the max over the terms, clamped to _NEG / 2, plus log2 of the sum of
// 2^(t - max); four independent chains.
template <int kTerms>
__device__ __forceinline__ float lse_at_max(const float (&t)[kTerms]) {
  float mx4[4] = {kNeg2, kNeg2, kNeg2, kNeg2};
#pragma unroll
  for (int x = 0; x < kTerms; ++x) mx4[x & 3] = fmaxf(mx4[x & 3], t[x]);
  const float mx = fmaxf(fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3])), kNeg2 / 2);
  float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int x = 0; x < kTerms; ++x) s4[x & 3] += ex2(t[x] - mx);
  return mx + lg2((s4[0] + s4[1]) + (s4[2] + s4[3]));
}

// lse_at_max over the terms in(x) + k(x). Every in(x) is fetched before any
// is used, so the chain waits for its inputs once.
template <int kTerms, typename In, typename K>
__device__ __forceinline__ float lse(In in, K k) {
  float t[kTerms];
#pragma unroll
  for (int x = 0; x < kTerms; ++x) t[x] = in(x);
#pragma unroll
  for (int x = 0; x < kTerms; ++x) t[x] += k(x);
  return lse_at_max<kTerms>(t);
}

// f(integral_constant<kL>) for the least kL = kStep, 2 kStep, ..., kMax with
// kL >= len: a chain of compares run once a pair, before its loop.
template <int kStep, int kMax, int kL = kStep, typename F>
__device__ __forceinline__ void with_length(int len, F f) {
  if constexpr (kL >= kMax) {
    f(std::integral_constant<int, kMax>());
  } else {
    if (len <= kL) {
      f(std::integral_constant<int, kL>());
    } else {
      with_length<kStep, kMax, kL + kStep>(len, f);
    }
  }
}

// Where a pair's potentials and terms live in shared memory.
struct Pair {
  const float* kr;  // c * D, compacted, n rows of stride S (-inf past m)
  const float* kt;  // its transpose, m rows
  const float* lp;  // log2 p, compacted
  const float* lq;  // log2 q
  float* u;         // row potential (base 2), compacted; 0 past n
  float* v;         // column potential; 0 past m
  int S, n, m;
};

// n_iters row and column updates of a pair whose sides both fit in 32 lanes
// (see register_loop), from potentials 0 on the atoms and -inf on idle lanes.
// Exact (kExact): each logsumexp is lse_at_max over its terms, k (shared
// memory) plus the other side's potential, the reference's clamped max.
// Fast: the sum over x of E[x] * 2^(other_x - ref) (E = 2^k, in registers;
// ref a warp-uniform value near the other side's potentials: atom 0's of
// the iteration before) is 2^(lse - ref): one shuffle and one FFMA a term,
// one ex2 a lane, no max to wait for. It returns false where an atom's sum
// left [2^-60, 2^100] (a term could then have been lost below f32's range,
// or have overflowed), and its potentials are then not to be used.
template <int kL, bool kExact>
__device__ __forceinline__ bool iterate(const float (&e_row)[kL], const float (&e_col)[kL],
                                        const float* krow, const float* kcol, float lpk,
                                        float lqk, bool row_on, bool col_on, int n_iters,
                                        float& uk, float& vk) {
  uk = row_on ? 0.f : -CUDART_INF_F;
  vk = col_on ? 0.f : -CUDART_INF_F;
  float ru = 0.f, rv = 0.f;
  bool ok = true;
  // one logsumexp of the lane's terms (k, E) against the other potential
  const auto lse_of = [&](const float* k, const float (&E)[kL], float other, float& ref,
                          bool on) {
    if constexpr (kExact) {
      float t[kL];
#pragma unroll
      for (int x = 0; x < kL; ++x) t[x] = __shfl_sync(kAll, other, x) + k[x];
      return lse_at_max<kL>(t);
    } else {
      const float b = ex2(other - ref), r = ref;  // 0 on an idle lane
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int x = 0; x < kL; ++x) s4[x & 3] = fmaf(E[x], __shfl_sync(kAll, b, x), s4[x & 3]);
      const float s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
      ok &= !on || (s >= 0x1p-60f && s <= 0x1p100f);
      ref = __shfl_sync(kAll, other, 0);
      return r + lg2(s);
    }
  };
  for (int it = 0; it < n_iters; ++it) {
    // u = log p - lse(K + v), then v = log q - lse(K + u); -inf on idle lanes
    uk = lpk - lse_of(krow, e_row, vk, rv, row_on);
    vk = lqk - lse_of(kcol, e_col, uk, ru, col_on);
  }
  return ok;
}

// All the half-iterations of a pair whose sides both fit in 32 lanes: lane k
// takes atom k of the updated side, its kL terms (kL >= the other side's
// atoms) and its potential. The fast form runs first, unless the pair's K
// reach below -100 (an E could be subnormal); where it fails, the warp runs
// the exact form from the start. Returns the lane's share of the cost: its
// terms of row k of T * D.
template <int kL>
__device__ __forceinline__ float register_loop(const Pair& P, float inv_c, int n_iters, int k) {
  const float* krow = P.kr + min(k, P.n - 1) * P.S;  // the lane's terms of K
  const float* kcol = P.kt + min(k, P.m - 1) * P.S;  // and of its transpose
  float e_row[kL], e_col[kL], kmin = 0.f;
#pragma unroll
  for (int x = 0; x < kL; ++x) {
    e_row[x] = ex2(krow[x]);  // 0 past the pair's atoms
    e_col[x] = ex2(kcol[x]);
    kmin = fminf(kmin, fminf(krow[x] > -CUDART_INF_F ? krow[x] : 0.f,
                             kcol[x] > -CUDART_INF_F ? kcol[x] : 0.f));
  }
  const bool row_on = k < P.n, col_on = k < P.m;
  const float lpk = row_on ? P.lp[k] : -CUDART_INF_F, lqk = col_on ? P.lq[k] : -CUDART_INF_F;
  float uk, vk;  // this lane's atom's potentials
  const bool fast = !__any_sync(kAll, kmin < -100.f) &&
                    iterate<kL, false>(e_row, e_col, krow, kcol, lpk, lqk, row_on, col_on,
                                       n_iters, uk, vk);
  if (!__all_sync(kAll, fast))
    iterate<kL, true>(e_row, e_col, krow, kcol, lpk, lqk, row_on, col_on, n_iters, uk, vk);
  // T_kj * D_kj = 2^(u_k + K_kj + v_j) * K_kj / c over the lane's valid terms
  float cost = 0.f;
#pragma unroll
  for (int x = 0; x < kL; ++x) {
    const float vj = __shfl_sync(kAll, vk, x);
    const bool valid = row_on && krow[x] > -CUDART_INF_F;
    cost += valid ? ex2(uk + krow[x] + vj) * (krow[x] * inv_c) : 0.f;
  }
  return cost;
}

// All the half-iterations of a pair with a side over 32 atoms: lane a owns
// atoms a and a + 32 of the updated side, the other side's potential is read
// from shared memory as a broadcast, kL >= the other side's atoms.
template <int kL>
__device__ __forceinline__ void shared_loop(const Pair& P, int n_iters, int lane) {
  for (int it = 0; it < n_iters; ++it) {
    for (int a = lane; a - lane < P.n; a += 32) {
      const float* row = P.kr + min(a, P.n - 1) * P.S;
      const float lu = lse<kL>([&](int x) { return P.v[x]; }, [&](int x) { return row[x]; });
      if (a < P.n) P.u[a] = P.lp[a] - lu;
    }
    __syncwarp();
    for (int a = lane; a - lane < P.m; a += 32) {
      const float* row = P.kt + min(a, P.m - 1) * P.S;
      const float lv = lse<kL>([&](int x) { return P.u[x]; }, [&](int x) { return row[x]; });
      if (a < P.m) P.v[a] = P.lq[a] - lv;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(32 * kWarps)
sinkhorn_kernel(const float* __restrict__ p, const float* __restrict__ q,
                const float* __restrict__ D, float* __restrict__ out, int B, int N, int M,
                float epsilon, int n_iters) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // the block's last warps past the batch: nothing to wait for
  const int S = stride(N, M);
  const int mats = round_up((N + M) * S, 4);
  float* kr = smem + (size_t)warp * (mats + 4 * kCap);
  float* kt = kr + N * S;
  float* u = kr + mats;  // 16-byte aligned
  float* v = u + kCap;
  float* lp = v + kCap;
  float* lq = lp + kCap;
  int* rows_at = reinterpret_cast<int*>(u);  // the prologue's valid row indices

  // masks: two ballots a side; an atom's compacted index is the popcount below it
  const float* pb = p + (size_t)b * N;
  const float* qb = q + (size_t)b * M;
  const float p0 = lane < N ? pb[lane] : 0.f, p1 = lane + 32 < N ? pb[lane + 32] : 0.f;
  const float q0 = lane < M ? qb[lane] : 0.f, q1 = lane + 32 < M ? qb[lane + 32] : 0.f;
  const uint64_t rmask = __ballot_sync(kAll, p0 > 0.f) |
                         (uint64_t)__ballot_sync(kAll, p1 > 0.f) << 32;
  const uint64_t cmask = __ballot_sync(kAll, q0 > 0.f) |
                         (uint64_t)__ballot_sync(kAll, q1 > 0.f) << 32;
  const int n = __popcll(rmask), m = __popcll(cmask);
  if (n == 0 || m == 0) {  // no (i, j) on the pair mask: T = 0
    if (lane == 0) out[b] = 0.f;
    return;
  }
  const uint64_t below = (1ull << lane) - 1, below_hi = below << 32 | 0xffffffffull;
  const int r0 = __popcll(rmask & below), r1 = __popcll(rmask & below_hi);
  const int c0 = __popcll(cmask & below), c1 = __popcll(cmask & below_hi);
  if (p0 > 0.f) {
    lp[r0] = log2f(p0);
    rows_at[r0] = lane;
  }
  if (p1 > 0.f) {
    lp[r1] = log2f(p1);
    rows_at[r1] = lane + 32;
  }
  if (q0 > 0.f) lq[c0] = log2f(q0);
  if (q1 > 0.f) lq[c1] = log2f(q1);
  for (int i = lane; i < mats / 4; i += 32)
    reinterpret_cast<float4*>(kr)[i] = make_float4(-CUDART_INF_F, -CUDART_INF_F,
                                                   -CUDART_INF_F, -CUDART_INF_F);
  __syncwarp();
  // the valid rows of D, read once and coalesced (lane = column), scaled into
  // both compacted matrices; the row indices come by shuffles, so that no
  // shared-memory read orders the loads after the stores: 16 rows in flight
  const float c = -kLog2e / epsilon;
  const float* Db = D + (size_t)b * N * M;
  const int row_lo = rows_at[lane], row_hi = rows_at[lane + 32];
#pragma unroll 16
  for (int r = 0; r < n; ++r) {
    const float* drow = Db + (size_t)__shfl_sync(kAll, r < 32 ? row_lo : row_hi, r & 31) * M;
    const float d0 = q0 > 0.f ? drow[lane] : 0.f, d1 = q1 > 0.f ? drow[lane + 32] : 0.f;
    if (q0 > 0.f) kr[r * S + c0] = kt[c0 * S + r] = c * d0;
    if (q1 > 0.f) kr[r * S + c1] = kt[c1 * S + r] = c * d1;
  }
  __syncwarp();
  for (int i = lane; i < kCap; i += 32) {  // potentials start at 0 (log 1), padding too
    u[i] = 0.f;
    v[i] = 0.f;
  }
  __syncwarp();

  // cost = sum over the valid terms of 2^(u_i + K_ij + v_j) * D_ij, D = K / c
  const Pair P{kr, kt, lp, lq, u, v, S, n, m};
  const float inv_c = 1.f / c;
  float cost = 0.f;
  if (n <= kRegAtoms && m <= kRegAtoms) {
    // a lane's terms: the longer side, rounded up to even
    with_length<2, kRegAtoms>(max(n, m), [&](auto l) {
      cost = register_loop<decltype(l)::value>(P, inv_c, n_iters, lane);
    });
  } else {
    with_length<8, kCap>(max(n, m), [&](auto l) {
      shared_loop<decltype(l)::value>(P, n_iters, lane);
    });
    __syncwarp();
    for (int a = lane; a < n; a += 32) {
      const float* row = kr + a * S;
#pragma unroll 4
      for (int j = 0; j < m; ++j) cost += ex2(u[a] + row[j] + v[j]) * (row[j] * inv_c);
    }
  }
  for (int off = 16; off > 0; off >>= 1) cost += __shfl_xor_sync(kAll, cost, off);
  if (lane == 0) out[b] = cost;
}

}  // namespace

extern "C" {

// p (B, N), q (B, M), D (B, N, M), out (B,): contiguous f32 on the device.
// Requires B >= 1 and 1 <= N, M <= 64 (checked by the Python wrapper).
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
int sinkhorn_f32(const void* p, const void* q, const void* D, void* out, int B, int N, int M,
                 float epsilon, int n_iters, void* stream) {
  const size_t mats = round_up((N + M) * stride(N, M), 4);
  const size_t bytes = kWarps * (mats + 4 * kCap) * sizeof(float);  // 68.6 KB at 64 x 64
  if (bytes > 48 * 1024) {  // dynamic shared memory above 48 KB: an opt-in on each device
    static bool opted_in[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices || !opted_in[dev]) {
      err = cudaFuncSetAttribute(sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
      if (err != cudaSuccess) return (int)err;
      if (dev < kMaxDevices) opted_in[dev] = true;
    }
  }
  sinkhorn_kernel<<<(B + kWarps - 1) / kWarps, 32 * kWarps, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(q), static_cast<const float*>(D),
      static_cast<float*>(out), B, N, M, epsilon, n_iters);
  return (int)cudaGetLastError();
}

int sinkhorn_max_atoms() { return kCap; }

const char* sinkhorn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
