// The LSTM cell's pointwise work for Hopper (sm_90a), one kernel forward and
// one backward:
//   gates = a + b                         (B, 4H), gate order i, f, g, o
//   c'    = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h     = sigmoid(o) * tanh(c')
// with a = x W_ih^T + b_ih and b = h W_hh^T + b_hh, the two products that
// models/generator.py::LSTM.cell leaves to cuBLAS.
//
// Replaces no TPU kernel: the JAX package leaves the cell to XLA, which fuses
// its pointwise work into the products' epilogues. Eager PyTorch, and a CUDA
// graph captured from it, runs that work as about 10 kernels forward and 16
// backward (the gate add, three sigmoids and a tanh on strided chunk views,
// mixed-dtype products and sums, their backwards and the chunk's cat), each
// over 0.25-2 MB. The optimize step runs 162 cells a batch, 108 of them with a
// backward, so this is about 3,000 of its graph's nodes.
//
// Types: G is the gates' type (a, b, the saved gate sum, dgates), C the cell
// state's (c, c', h, their gradients): bf16 / f32 (the encoder under
// autocast), bf16 / bf16 (the decoder under autocast, bf16 serving), f32 / f32.
//
// Forward: each intermediate is rounded where eager PyTorch rounds it, to the
// type that its type promotion gives it, with the arithmetic of PyTorch's own
// kernels (sigmoid = 1 / (1 + expf(-x)) and tanhf, both in f32; products and
// sums in f32, rounded to nearest even): the gate sum to G; each activation to
// G; sigmoid(f) * c, the sum c' and tanh(c') and h to C; sigmoid(i) * tanh(g)
// to G. The IEEE intrinsics (__fadd_rn, __fmul_rn, __fdiv_rn) keep nvcc from
// contracting a product and a sum into one FMA, which eager does not do, so
// the forward is bit-identical to kernels/lstm_cell.py::lstm_cell_reference.
// The forward also writes the gate sum (G) for the backward when asked.
//
// Backward: from the saved gate sum, c and c', and dh, dc' (either may be
// absent: zero), in f32 throughout, rounded once at the end: dgates (G) and dc
// (C). The activations are recomputed in f32 from the gate sum, not read back
// rounded to G, so this rounds less often than autograd's chain over the eager
// ops, never more.
//
// What bounds it (H100 SXM, 3.35 TB/s): bytes. At yelp's decoder (B = 256,
// H = 512, bf16 / bf16) the forward reads a and b (1 MB each) and c (256 KB)
// and writes h, c' (512 KB) and the gate sum (1 MB): 3.8 MB, 1.1 us; the
// backward reads the gate sum, c, c', dh and dc' (2 MB) and writes dgates and
// dc (1.25 MB): 1.0 us. A handful of f32 operations and three
// special functions an element are far from the card's rates. Each thread
// takes 4 columns of one row in every gate (8- or 16-byte loads, neighbouring
// threads on neighbouring addresses) when H, the row strides and the pointers
// allow it, else 1.
//
// Every entry point launches on `stream`, does not synchronise and returns
// cudaGetLastError() after its launch.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 4;
// the dtype pairs (gates / cell state) the entry points take
enum Pair { kBf16F32 = 0, kBf16Bf16 = 1, kF32F32 = 2 };

struct F32 {
  using Raw = float;
  __device__ __forceinline__ static float load(Raw r) { return r; }
  __device__ __forceinline__ static Raw store(float x) { return x; }
};

struct Bf16 {
  using Raw = uint16_t;
  __device__ __forceinline__ static float load(Raw r) { return __uint_as_float(uint32_t(r) << 16); }
  __device__ __forceinline__ static Raw store(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

// x rounded to T and back to f32
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return T::load(T::store(x));
}

template <typename T, int V>
struct alignas(sizeof(typename T::Raw) * V) Pack {
  typename T::Raw v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const typename T::Raw* p, float (&out)[V]) {
  const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = T::load(pk.v[k]);
}

template <typename T, int V>
__device__ __forceinline__ void store(typename T::Raw* p, const float (&in)[V]) {
  Pack<T, V> pk;
#pragma unroll
  for (int k = 0; k < V; ++k) pk.v[k] = T::store(in[k]);
  *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

// PyTorch's sigmoid kernel in f32: one / (one + exp(-x)), IEEE division
__device__ __forceinline__ float sigmoid(float x) { return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x))); }

template <typename G, typename C, int V>
__global__ void __launch_bounds__(kThreads)
lstm_forward(const typename G::Raw* __restrict__ a, int64_t lda, const typename G::Raw* __restrict__ b,
             int64_t ldb, const typename C::Raw* __restrict__ c, int64_t ldc,
             typename C::Raw* __restrict__ h, typename C::Raw* __restrict__ c_new,
             typename G::Raw* __restrict__ gates, int B, int H) {
  const int groups = H / V;
  const int64_t idx = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= int64_t(B) * groups) return;
  const int64_t row = idx / groups;
  const int j = int(idx - row * groups) * V;
  float s[4][V];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float x[V], y[V];
    load<G, V>(a + row * lda + q * H + j, x);
    load<G, V>(b + row * ldb + q * H + j, y);
#pragma unroll
    for (int k = 0; k < V; ++k) s[q][k] = rnd<G>(__fadd_rn(x[k], y[k]));
    if (gates != nullptr) store<G, V>(gates + row * 4 * H + q * H + j, s[q]);
  }
  float cv[V], hv[V], cn[V];
  load<C, V>(c + row * ldc + j, cv);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float i = rnd<G>(sigmoid(s[0][k]));
    const float f = rnd<G>(sigmoid(s[1][k]));
    const float g = rnd<G>(tanhf(s[2][k]));
    const float o = rnd<G>(sigmoid(s[3][k]));
    const float keep = rnd<C>(__fmul_rn(f, cv[k]));
    const float add = rnd<G>(__fmul_rn(i, g));
    cn[k] = rnd<C>(__fadd_rn(keep, add));
    hv[k] = __fmul_rn(o, rnd<C>(tanhf(cn[k])));  // rounded to C by the store
  }
  store<C, V>(c_new + row * H + j, cn);
  store<C, V>(h + row * H + j, hv);
}

template <typename G, typename C, int V>
__global__ void __launch_bounds__(kThreads)
lstm_backward(const typename G::Raw* __restrict__ gates, const typename C::Raw* __restrict__ c,
              int64_t ldc, const typename C::Raw* __restrict__ c_new,
              const typename C::Raw* __restrict__ dh, int64_t ldh,
              const typename C::Raw* __restrict__ dc_new, int64_t lddc,
              typename G::Raw* __restrict__ dgates, typename C::Raw* __restrict__ dc, int B,
              int H) {
  const int groups = H / V;
  const int64_t idx = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= int64_t(B) * groups) return;
  const int64_t row = idx / groups;
  const int j = int(idx - row * groups) * V;
  float s[4][V], cv[V], cn[V], gh[V], gc[V];
#pragma unroll
  for (int q = 0; q < 4; ++q) load<G, V>(gates + row * 4 * H + q * H + j, s[q]);
  load<C, V>(c + row * ldc + j, cv);
  load<C, V>(c_new + row * H + j, cn);
#pragma unroll
  for (int k = 0; k < V; ++k) gh[k] = gc[k] = 0.0f;
  if (dh != nullptr) load<C, V>(dh + row * ldh + j, gh);
  if (dc_new != nullptr) load<C, V>(dc_new + row * lddc + j, gc);
  float d[4][V], dcv[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float i = sigmoid(s[0][k]), f = sigmoid(s[1][k]), g = tanhf(s[2][k]);
    const float o = sigmoid(s[3][k]), tc = tanhf(cn[k]);
    const float dct = gc[k] + gh[k] * o * (1.0f - tc * tc);  // through c' and h
    d[0][k] = dct * g * i * (1.0f - i);
    d[1][k] = dct * cv[k] * f * (1.0f - f);
    d[2][k] = dct * i * (1.0f - g * g);
    d[3][k] = gh[k] * tc * o * (1.0f - o);
    dcv[k] = dct * f;
  }
  if (dgates != nullptr) {
#pragma unroll
    for (int q = 0; q < 4; ++q) store<G, V>(dgates + row * 4 * H + q * H + j, d[q]);
  }
  if (dc != nullptr) store<C, V>(dc + row * H + j, dcv);
}

template <typename T>
bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % (sizeof(typename T::Raw) * kVec) == 0;
}

inline int blocks(int B, int H, int V) {
  return int((int64_t(B) * (H / V) + kThreads - 1) / kThreads);
}

template <typename G, typename C>
int forward(const void* a, int64_t lda, const void* b, int64_t ldb, const void* c, int64_t ldc,
            void* h, void* c_new, void* gates, int B, int H, cudaStream_t stream) {
  using GR = typename G::Raw;
  using CR = typename C::Raw;
  const bool vec = H % kVec == 0 && lda % kVec == 0 && ldb % kVec == 0 && ldc % kVec == 0 &&
                   aligned<G>(a) && aligned<G>(b) && aligned<C>(c) && aligned<C>(h) &&
                   aligned<C>(c_new) && (gates == nullptr || aligned<G>(gates));
  if (vec) {
    lstm_forward<G, C, kVec><<<blocks(B, H, kVec), kThreads, 0, stream>>>(
        static_cast<const GR*>(a), lda, static_cast<const GR*>(b), ldb,
        static_cast<const CR*>(c), ldc, static_cast<CR*>(h), static_cast<CR*>(c_new),
        static_cast<GR*>(gates), B, H);
  } else {
    lstm_forward<G, C, 1><<<blocks(B, H, 1), kThreads, 0, stream>>>(
        static_cast<const GR*>(a), lda, static_cast<const GR*>(b), ldb,
        static_cast<const CR*>(c), ldc, static_cast<CR*>(h), static_cast<CR*>(c_new),
        static_cast<GR*>(gates), B, H);
  }
  return (int)cudaGetLastError();
}

template <typename G, typename C>
int backward(const void* gates, const void* c, int64_t ldc, const void* c_new, const void* dh,
             int64_t ldh, const void* dc_new, int64_t lddc, void* dgates, void* dc, int B, int H,
             cudaStream_t stream) {
  using GR = typename G::Raw;
  using CR = typename C::Raw;
  const bool vec = H % kVec == 0 && ldc % kVec == 0 && ldh % kVec == 0 && lddc % kVec == 0 &&
                   aligned<G>(gates) && aligned<C>(c) && aligned<C>(c_new) && aligned<C>(dh) &&
                   aligned<C>(dc_new) && aligned<G>(dgates) && aligned<C>(dc);
  if (vec) {
    lstm_backward<G, C, kVec><<<blocks(B, H, kVec), kThreads, 0, stream>>>(
        static_cast<const GR*>(gates), static_cast<const CR*>(c), ldc,
        static_cast<const CR*>(c_new), static_cast<const CR*>(dh), ldh,
        static_cast<const CR*>(dc_new), lddc, static_cast<GR*>(dgates), static_cast<CR*>(dc), B,
        H);
  } else {
    lstm_backward<G, C, 1><<<blocks(B, H, 1), kThreads, 0, stream>>>(
        static_cast<const GR*>(gates), static_cast<const CR*>(c), ldc,
        static_cast<const CR*>(c_new), static_cast<const CR*>(dh), ldh,
        static_cast<const CR*>(dc_new), lddc, static_cast<GR*>(dgates), static_cast<CR*>(dc), B,
        H);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a, b (B, 4H) with row strides lda, ldb; c (B, H) with row stride ldc, all
// with unit column stride; h, c_new (B, H) and gates (B, 4H) contiguous, gates
// null where no backward follows. `pair` is a Pair. Requires B, H >= 1
// (checked by the Python wrapper).
int lstm_cell_forward(int pair, const void* a, int64_t lda, const void* b, int64_t ldb,
                      const void* c, int64_t ldc, void* h, void* c_new, void* gates, int B,
                      int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pair) {
    case kBf16F32: return forward<Bf16, F32>(a, lda, b, ldb, c, ldc, h, c_new, gates, B, H, s);
    case kBf16Bf16: return forward<Bf16, Bf16>(a, lda, b, ldb, c, ldc, h, c_new, gates, B, H, s);
    case kF32F32: return forward<F32, F32>(a, lda, b, ldb, c, ldc, h, c_new, gates, B, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// gates (B, 4H) and c_new (B, H) contiguous, as the forward wrote them; c, dh,
// dc_new (B, H) with row strides ldc, ldh, lddc and unit column stride, dh and
// dc_new null where absent (zero); dgates (B, 4H) and dc (B, H) contiguous,
// each null where not wanted.
int lstm_cell_backward(int pair, const void* gates, const void* c, int64_t ldc,
                       const void* c_new, const void* dh, int64_t ldh, const void* dc_new,
                       int64_t lddc, void* dgates, void* dc, int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pair) {
    case kBf16F32:
      return backward<Bf16, F32>(gates, c, ldc, c_new, dh, ldh, dc_new, lddc, dgates, dc, B, H, s);
    case kBf16Bf16:
      return backward<Bf16, Bf16>(gates, c, ldc, c_new, dh, ldh, dc_new, lddc, dgates, dc, B, H,
                                  s);
    case kF32F32:
      return backward<F32, F32>(gates, c, ldc, c_new, dh, ldh, dc_new, lddc, dgates, dc, B, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* lstm_cell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
