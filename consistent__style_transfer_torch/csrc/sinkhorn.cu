// Batched log-domain Sinkhorn optimal-transport cost for Hopper (sm_90a):
//   out[b] = <T_b, D_b>, T_b the entropic plan (epsilon) after n_iters updates
// of the row and column potentials, for p (B, N), q (B, M), D (B, N, M) f32.
// A zero mass masks an atom, so padding never changes the result, and a pair
// whose masks leave no (i, j) gives exactly 0.
//
// Replaces the TPU kernels consistent__style_transfer_tpu/kernels/sinkhorn.py::
// sinkhorn_pallas (body `_kernel`, pallas_call at sinkhorn.py:210) and
// sinkhorn_pallas_cr (body `_kernel_cr`, pallas_call at sinkhorn.py:160). Both
// keep one pair's cost matrix and potentials in VMEM for all iterations; the
// first batches 8 pairs per program and pads atoms to 128 lanes, the second
// shapes the potentials as an (N, 1) column and a (1, M) row for Mosaic. Neither
// layout means anything on Hopper, so both names launch this one kernel.
//
// The arithmetic is that of ops/emd.py::sinkhorn_ot_cost, constant for
// constant: _NEG = -1e30; a masked logsumexp takes the max over the pair mask,
// clamps it to max(m, _NEG / 2) and adds log(sum exp(x - m)), where masked
// entries add exp(_NEG - m) = 0 exactly; masked atoms are reset to _NEG after
// each update; T = 0 off the pair mask.
//
// What bounds it (NVIDIA H100 SXM: 3.35 TB/s, 67 TFLOP/s f32 on the CUDA
// cores), at the yelp WMD-label shape B=256, N=M=27, 100 iterations:
//   bytes: D 0.75 MB + p, q 0.06 MB read, 1 KB written = 0.8 MB -> 0.24 us;
//   operations: 2 updates x 100 x 256 x 729 = 37.3M masked exp-and-sum terms,
//     about 5 FLOP each (add, max, subtract, exp, add) = 187 MFLOP -> 2.8 us;
//   so it is bound by operations at about 2.8 us. The 37.3M exps alone need
//   about 9-10 us at the special-function units' rate (16 per SM per clock,
//   132 SMs, ~1.8 GHz): that, not the FMA peak, is the practical floor.
//
// Design, right before fast:
//   - one block of kWarps warps per pair; the grid is (B,);
//   - the block reads its pair's D, p and q from device memory once and builds
//     logK = -D / epsilon (and keeps D) in shared memory, rows padded to
//     kCap + 1 floats so that a warp reading a column hits 32 different banks;
//   - both potentials stay in shared memory for all iterations; a row update
//     gives each warp whole rows (lanes over columns), a column update whole
//     columns (lanes over rows), and the max and the sum of each logsumexp are
//     taken with warp shuffles; two __syncthreads per iteration;
//   - the cost is summed by each thread, then by warp shuffles, then across
//     warps in shared memory; thread 0 writes one float per pair.
// N and M are at most kCap = 64 (book's 45 atoms fit); the wrapper checks.
// The entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kCap = 64;                 // most atoms per side
constexpr int kStride = kCap + 1;        // padded shared-memory row
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -1e30f;           // _NEG of ops/emd.py

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
sinkhorn_kernel(const float* __restrict__ p, const float* __restrict__ q,
                const float* __restrict__ D, float* __restrict__ out, int N, int M,
                float epsilon, int n_iters) {
  __shared__ float logK[kCap * kStride];
  __shared__ float dist[kCap * kStride];
  __shared__ float logp[kCap], logq[kCap], logu[kCap], logv[kCap];
  __shared__ float partial[kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* Db = D + (size_t)b * N * M;

  // masses -> log masses (_NEG where the atom is absent); potentials start at 0
  for (int i = tid; i < N; i += kThreads) {
    float v = p[(size_t)b * N + i];
    logp[i] = v > 0.f ? logf(v) : kNeg;
    logu[i] = v > 0.f ? 0.f : kNeg;
  }
  for (int j = tid; j < M; j += kThreads) {
    float v = q[(size_t)b * M + j];
    logq[j] = v > 0.f ? logf(v) : kNeg;
    logv[j] = v > 0.f ? 0.f : kNeg;
  }
  __syncthreads();
  // D read once, coalesced; logK = -D / epsilon on the pair mask, else _NEG
  for (int k = tid; k < N * M; k += kThreads) {
    int i = k / M, j = k - i * M;
    float d = Db[k];
    dist[i * kStride + j] = d;
    logK[i * kStride + j] = (logp[i] > kNeg && logq[j] > kNeg) ? -d / epsilon : kNeg;
  }
  __syncthreads();

  for (int it = 0; it < n_iters; ++it) {
    // rows: logu_i = logp_i - lse_j(logK_ij + logv_j) over the pair mask
    for (int i = warp; i < N; i += kWarps) {
      const bool row_on = logp[i] > kNeg;
      float m = kNeg;
      for (int j = lane; j < M; j += 32)
        if (row_on && logq[j] > kNeg) m = fmaxf(m, logK[i * kStride + j] + logv[j]);
      m = fmaxf(warp_max(m), kNeg / 2);
      float s = 0.f;
      for (int j = lane; j < M; j += 32)
        if (row_on && logq[j] > kNeg) s += expf(logK[i * kStride + j] + logv[j] - m);
      s = warp_sum(s);
      if (lane == 0) logu[i] = row_on ? logp[i] - (m + logf(s)) : kNeg;
    }
    __syncthreads();
    // columns: logv_j = logq_j - lse_i(logK_ij + logu_i) over the pair mask
    for (int j = warp; j < M; j += kWarps) {
      const bool col_on = logq[j] > kNeg;
      float m = kNeg;
      for (int i = lane; i < N; i += 32)
        if (col_on && logp[i] > kNeg) m = fmaxf(m, logK[i * kStride + j] + logu[i]);
      m = fmaxf(warp_max(m), kNeg / 2);
      float s = 0.f;
      for (int i = lane; i < N; i += 32)
        if (col_on && logp[i] > kNeg) s += expf(logK[i * kStride + j] + logu[i] - m);
      s = warp_sum(s);
      if (lane == 0) logv[j] = col_on ? logq[j] - (m + logf(s)) : kNeg;
    }
    __syncthreads();
  }

  // cost = sum over the pair mask of exp(logu_i + logK_ij + logv_j) * D_ij
  float c = 0.f;
  for (int k = tid; k < N * M; k += kThreads) {
    int i = k / M, j = k - i * M;
    if (logp[i] > kNeg && logq[j] > kNeg)
      c += expf(logu[i] + logK[i * kStride + j] + logv[j]) * dist[i * kStride + j];
  }
  c = warp_sum(c);
  if (lane == 0) partial[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = lane < kWarps ? partial[lane] : 0.f;
    c = warp_sum(c);
    if (lane == 0) out[b] = c;
  }
}

}  // namespace

extern "C" {

// p (B, N), q (B, M), D (B, N, M), out (B,): contiguous f32 on the device.
// Requires B >= 1 and 1 <= N, M <= 64 (checked by the Python wrapper).
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
int sinkhorn_f32(const void* p, const void* q, const void* D, void* out, int B, int N, int M,
                 float epsilon, int n_iters, void* stream) {
  sinkhorn_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(q), static_cast<const float*>(D),
      static_cast<float*>(out), N, M, epsilon, n_iters);
  return (int)cudaGetLastError();
}

int sinkhorn_max_atoms() { return kCap; }

const char* sinkhorn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
