// Greedy decode head for Hopper (sm_90a):
//   h   = LeakyReLU_0.1(x . W1^T + b1)            (B, H) f32
//   ids = argmax_v(cast(h, T) . W2^T)             (B,)   int32, first index on ties
// The (B, V) logits are never written to device memory.
//
// Replaces the TPU kernel consistent__style_transfer_tpu/kernels/decode_step.py::
// fused_decode_logits (body `_kernel`, pallas_call at decode_step.py:108). That
// kernel walks V in order, one grid step per 2048-column tile, carrying a running
// (max, argmax) in VMEM scratch; Hopper runs blocks in parallel and in no order,
// so here every block reduces its own tile and the blocks meet in a 64-bit
// atomicMax instead.
//
// Layouts are the port's nn.Linear ones, read in place: x (B, Din), W1 =
// fn_1.weight (H, Din), b1 (H,), W2 = fn_2.weight (V, H), all row-major. T is
// float or __nv_bfloat16; products accumulate in f32 either way.
//
// What bounds it (NVIDIA H100 SXM: 3.35 TB/s, 989 TFLOP/s dense bf16, 67 TFLOP/s
// f32 without tensor cores), at yelp shapes B=256, Din=1024, H=512, V=10000:
//   bytes, bf16: W2 10.24 MB + W1 1.05 MB + x 0.52 MB + h out 0.52 MB (+ b1, ids)
//                = 12.3 MB -> 3.7 us
//   operations:  2*B*Din*H + 2*B*H*V = 0.27 + 2.62 = 2.89 GFLOP -> 2.9 us in bf16
//   so in bf16 the call is memory-bound at about 3.7 us. In f32 without TF32 the
//   bytes double (24.2 MB -> 7.2 us) and the 2.89 GFLOP take 43 us at the CUDA
//   cores' f32 rate: bound by operations.
//
// Design, right before fast (wgmma, TMA and persistent blocks are later work):
//   (a) ffn_hidden_kernel: h in f32 by a tiled CUDA-core product, bias and
//       LeakyReLU in the epilogue.
//   (b) vocab_argmax_kernel: a grid over (V tiles, B tiles); each block stages
//       its h rows (rounded to T, as decode_step.py:55 casts h to W2's dtype) and
//       its W2 rows in shared memory, accumulates logits in f32 registers and
//       drops columns >= V.
//   (c) each block reduces its rows to (max, first argmax) and merges across
//       blocks with atomicMax on key = (orderable f32 bits << 32) |
//       (0xFFFFFFFF - col): an equal max resolves to the smaller column, as the
//       TPU kernel's strict '>' across tiles and first-max within a tile do.
//   (d) unpack_ids_kernel turns the keys into int32 ids.
// Each entry point returns cudaGetLastError() after its launches.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads; each owns a (BM/16) x (BN/16) micro-tile
constexpr int kBK = 16;        // depth of one shared-memory stage
constexpr int kPad = 4;        // row padding of the staged tiles (keeps 16-byte alignment)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
struct AsF32 {
  __device__ __forceinline__ float operator()(T v) const { return to_f32(v); }
};

// h is rounded to W2's dtype before the vocab product (decode_step.py:55).
template <typename T>
struct RoundTo;
template <>
struct RoundTo<float> {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};
template <>
struct RoundTo<__nv_bfloat16> {
  __device__ __forceinline__ float operator()(float v) const {
    return __bfloat162float(__float2bfloat16(v));  // round to nearest even, as astype does
  }
};

template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const float* src) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x; dst[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

// acc[i][j] += sum_k A[m0 + ty*TM + i, k] * Bm[n0 + tx*TN + j, k]
// A is (M, K) and Bm is (N, K), both row-major; K % kBK == 0 (checked by the
// caller). Rows past M or N are staged as zeros.
template <int BM, int BN, typename TA, typename TB, typename ConvA>
__device__ __forceinline__ void gemm_nt_tile(const TA* __restrict__ A, const TB* __restrict__ Bm,
                                             int M, int N, int K, int m0, int n0, ConvA conv_a,
                                             float (&acc)[BM / 16][BN / 16]) {
  constexpr int TM = BM / 16, TN = BN / 16;
  static_assert((BM * kBK) % kThreads == 0 && (BN * kBK) % kThreads == 0, "tile / threads");
  __shared__ __align__(16) float As[kBK][BM + kPad];
  __shared__ __align__(16) float Bs[kBK][BN + kPad];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int it = 0; it < BM * kBK / kThreads; ++it) {
      const int e = tid + it * kThreads, r = e / kBK, kk = e % kBK, m = m0 + r;
      As[kk][r] = m < M ? conv_a(A[(size_t)m * K + k0 + kk]) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < BN * kBK / kThreads; ++it) {
      const int e = tid + it * kThreads, r = e / kBK, kk = e % kBK, n = n0 + r;
      Bs[kk][r] = n < N ? to_f32(Bm[(size_t)n * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[TN];
      load_row<TM>(a, &As[kk][ty * TM]);
      load_row<TN>(b, &Bs[kk][tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// (a) h = LeakyReLU_0.1(x . W1^T + b1), f32 out. Small tiles: at B=256, H=512
// this gives 128 blocks, about one per SM.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_hidden_kernel(const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1,
                  float* __restrict__ h, int B, int Din, int H) {
  constexpr int BM = 32, BN = 32, TM = BM / 16, TN = BN / 16;
  float acc[TM][TN] = {};
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  gemm_nt_tile<BM, BN>(x, w1, B, H, Din, m0, n0, AsF32<T>(), acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (row < B && col < H) {
        const float v = acc[i][j] + to_f32(b1[col]);
        h[(size_t)row * H + col] = v >= 0.f ? v : 0.1f * v;
      }
    }
  }
}

__device__ __forceinline__ unsigned long long key_max(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

// Order-preserving map of (value, column) onto 64 unsigned bits: a larger value
// gives a larger key and, for equal values, a smaller column does.
__device__ __forceinline__ unsigned long long pack_key(float v, int col) {
  if (v == 0.f) v = 0.f;  // -0 and +0 tie, as they do for torch.argmax
  unsigned int u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (unsigned int)col);
}

// (b) + (c): logits of one (64 rows x 64 columns) tile, reduced to one key per
// row and merged into keys[row]. A key of 0 is below every real key.
template <typename T>
__global__ void __launch_bounds__(kThreads)
vocab_argmax_kernel(const float* __restrict__ h, const T* __restrict__ w2,
                    unsigned long long* __restrict__ keys, int B, int H, int V) {
  constexpr int BM = 64, BN = 64, TM = BM / 16, TN = BN / 16;
  float acc[TM][TN] = {};
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  gemm_nt_tile<BM, BN>(h, w2, B, V, H, m0, n0, RoundTo<T>(), acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    unsigned long long best = 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx * TN + j;
      if (col < V) best = key_max(best, pack_key(acc[i][j], col));
    }
    // the 16 threads sharing a row are one half-warp: xor offsets < 16 stay in it
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) best = key_max(best, __shfl_xor_sync(0xffffffffu, best, off));
    const int row = m0 + ty * TM + i;
    if (tx == 0 && row < B && best != 0) atomicMax(&keys[row], best);
  }
}

// (d) keys -> int32 column ids.
__global__ void unpack_ids_kernel(const unsigned long long* __restrict__ keys, int* __restrict__ ids,
                                  int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B) ids[i] = (int)(0xFFFFFFFFu - (unsigned int)(keys[i] & 0xFFFFFFFFull));
}

template <typename T>
int decode_head(const void* x, const void* w1, const void* b1, const void* w2, void* h, void* keys,
                void* ids, int B, int Din, int H, int V, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* k = static_cast<unsigned long long*>(keys);
  cudaError_t err = cudaMemsetAsync(k, 0, sizeof(unsigned long long) * (size_t)B, s);
  if (err != cudaSuccess) return (int)err;
  ffn_hidden_kernel<T><<<dim3((H + 31) / 32, (B + 31) / 32), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<float*>(h), B, Din, H);
  vocab_argmax_kernel<T><<<dim3((V + 63) / 64, (B + 63) / 64), kThreads, 0, s>>>(
      static_cast<const float*>(h), static_cast<const T*>(w2), k, B, H, V);
  unpack_ids_kernel<<<(B + 255) / 256, 256, 0, s>>>(k, static_cast<int*>(ids), B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Pointers: x, w1, b1, w2 in the element type of the name; h f32 (B, H); keys
// 8-byte scratch (B,); ids int32 (B,). Requires B, V >= 1 and Din, H multiples
// of 16 (checked by the Python wrapper). Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
int decode_head_f32(const void* x, const void* w1, const void* b1, const void* w2, void* h,
                    void* keys, void* ids, int B, int Din, int H, int V, void* stream) {
  return decode_head<float>(x, w1, b1, w2, h, keys, ids, B, Din, H, V, stream);
}

int decode_head_bf16(const void* x, const void* w1, const void* b1, const void* w2, void* h,
                     void* keys, void* ids, int B, int Din, int H, int V, void* stream) {
  return decode_head<__nv_bfloat16>(x, w1, b1, w2, h, keys, ids, B, Din, H, V, stream);
}

const char* decode_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
