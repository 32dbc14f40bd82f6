// Fused gather + blockwise quantize of the CHANGED chunk rows of a float leaf,
// and the plain per-row int8 quantize / dequantize pair.
//
// Replaces src/repro/kernels/quantize.py: gather_quantize_pallas
// (_gather_quant_kernel, int8), gather_quantize4_pallas
// (_gather_quant4_kernel, int4 in the half-split nibble layout),
// quantize_pallas (_quant_kernel) and dequantize_pallas (_dequant_kernel).
//
// The leaf is read in place in its own dtype (f32, bf16 or f16), as the
// [G, W] row view of kernels/ops.py::_padded_float_blocks: element e of row r
// is flat element r*W + e, and elements at or past n read as zero. One block
// per changed row (idx[c]); frozen rows are never read. Per `block`-element
// sub-block: scale = max(absmax * fl(1/qmax), 1e-12), q = clip(rint(x /
// scale), -qmax, qmax) with qmax 127 (q8) or 7 (q4). The scale multiplies by
// the f32-rounded reciprocal because that is what the reference package
// stores (XLA folds its `absmax / 127.0` into that multiply); x / scale is a
// correctly rounded division and rint rounds half to even, so the bytes
// equal the plain version's (no fast math).
//
// Bound: bytes (one read of each changed row, a quarter or an eighth of it
// written). Design: the row's W/block scales are computed first, one warp
// per sub-block, into shared memory (64 floats at W=16384). The q4 layout
// needs that: byte j pairs element j with element j+W/2, which lie in
// different sub-blocks. Then every thread quantizes strided elements
// (q8) or element pairs (q4) with coalesced reads and writes.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16
template <int DT>
__device__ __forceinline__ float load_elem(const void* src, long long k) {
  if (DT == 0) return __ldg(static_cast<const float*>(src) + k);
  const unsigned short u = __ldg(static_cast<const unsigned short*>(src) + k);
  if (DT == 1) return __uint_as_float(static_cast<uint32_t>(u) << 16);
  return __half2float(__ushort_as_half(u));
}

// Elements outside [0, n) read as zero: the padding of the last row, and
// any row index past the leaf (or negative) never touches memory.
template <int DT>
__device__ __forceinline__ float elem(const void* src, long long n,
                                      long long k) {
  return static_cast<unsigned long long>(k) <
                 static_cast<unsigned long long>(n)
             ? load_elem<DT>(src, k)
             : 0.0f;
}

template <bool Q4>
__device__ __forceinline__ int quant(float x, float scale) {
  const float qmax = Q4 ? 7.0f : 127.0f;
  return static_cast<int>(fminf(fmaxf(rintf(x / scale), -qmax), qmax));
}

template <int DT, bool Q4>
__global__ void __launch_bounds__(THREADS)
gq_kernel(const void* __restrict__ src, long long n, int W, int block,
          const int32_t* __restrict__ idx, void* __restrict__ q_out,
          float* __restrict__ scales) {
  extern __shared__ float s_scale[];
  const int c = blockIdx.x;
  const long long base = static_cast<long long>(idx[c]) * W;
  const int n_sub = W / block;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_qmax = Q4 ? 1.0f / 7.0f : 1.0f / 127.0f;
  for (int s = warp; s < n_sub; s += WARPS) {
    const long long sb = base + static_cast<long long>(s) * block;
    float m = 0.0f;
    for (int e = lane; e < block; e += 32)
      m = fmaxf(m, fabsf(elem<DT>(src, n, sb + e)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) {
      const float scale = fmaxf(m * inv_qmax, 1e-12f);
      s_scale[s] = scale;
      scales[static_cast<long long>(c) * n_sub + s] = scale;
    }
  }
  __syncthreads();
  if (!Q4) {
    int8_t* q = static_cast<int8_t*>(q_out) + static_cast<long long>(c) * W;
    for (int e = threadIdx.x; e < W; e += THREADS)
      q[e] = static_cast<int8_t>(
          quant<false>(elem<DT>(src, n, base + e), s_scale[e / block]));
  } else {
    const int half = W / 2;
    uint8_t* p = static_cast<uint8_t*>(q_out) +
        static_cast<long long>(c) * half;
    for (int j = threadIdx.x; j < half; j += THREADS) {
      const int lo = quant<true>(elem<DT>(src, n, base + j),
                                 s_scale[j / block]);
      const int hi = quant<true>(elem<DT>(src, n, base + j + half),
                                 s_scale[(j + half) / block]);
      p[j] = static_cast<uint8_t>((lo & 0xF) | ((hi & 0xF) << 4));
    }
  }
}

// Per-row int8 quantize of the [G, B] row view of a flat leaf (elements at
// or past n read as zero, so the padding the reference builds with jnp.pad
// is never materialized): scale = max(absmax * fl(1/127), 1e-12), q =
// clip(rint(x / scale), -127, 127), as the gather kernels above.
// Bound: bytes (each element read once, 1 byte + 4 bytes a row written).
// Design: one warp per row; lanes stride the row for coalesced loads, the
// absmax reduces by shuffles, and the quantize pass re-reads the row (an L1
// hit at the rows' 256 elements).
template <int DT>
__global__ void __launch_bounds__(THREADS)
qr_kernel(const void* __restrict__ src, long long n, int G, int B,
          int8_t* __restrict__ q, float* __restrict__ scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (g >= G) return;
  const long long base = g * B;
  float m = 0.0f;
  for (int e = lane; e < B; e += 32)
    m = fmaxf(m, fabsf(elem<DT>(src, n, base + e)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float s = fmaxf(m * (1.0f / 127.0f), 1e-12f);
  if (lane == 0) scale[g] = s;
  for (int e = lane; e < B; e += 32)
    q[base + e] =
        static_cast<int8_t>(quant<false>(elem<DT>(src, n, base + e), s));
}

// out[k] = q[k] * scale[k / B] for the first n elements of the [G, B] rows,
// written in the leaf's dtype (OT 0/1/2 = f32/bf16/f16, round to nearest
// even, as torch's cast): the reference's trim and astype fused into the
// store. Bound: bytes (1 + 4/B read, 4 or 2 written per element). Design:
// one warp per row, lanes over the row, no division per element.
template <int OT>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
          int B, long long n, void* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * WARPS + warp;
  const long long base = g * B;
  if (base >= n) return;
  const float s = scale[g];
  const int cols = static_cast<int>(n - base < B ? n - base : B);
  for (int e = lane; e < cols; e += 32) {
    const float x = static_cast<float>(q[base + e]) * s;
    if (OT == 0)
      static_cast<float*>(out)[base + e] = x;
    else if (OT == 1)
      static_cast<__nv_bfloat16*>(out)[base + e] = __float2bfloat16_rn(x);
    else
      static_cast<__half*>(out)[base + e] = __float2half_rn(x);
  }
}

template <int DT>
void launch(const void* src, long long n, int W, int block,
            const int32_t* idx, int C, void* q_out, float* scales, bool q4,
            cudaStream_t s) {
  const size_t smem = sizeof(float) * static_cast<size_t>(W / block);
  if (q4)
    gq_kernel<DT, true><<<C, THREADS, smem, s>>>(src, n, W, block, idx, q_out,
                                                scales);
  else
    gq_kernel<DT, false><<<C, THREADS, smem, s>>>(src, n, W, block, idx,
                                                 q_out, scales);
}

}  // namespace

// src: the leaf's n elements (dtype code 0/1/2); idx: int32 [C] row indices;
// q_out: int8 [C, W] (q8) or uint8 [C, W/2] (q4); scales: f32 [C, W/block].
// Returns cudaGetLastError().
extern "C" int gq_launch(const void* src, long long n, int dtype, int W,
                         int block, const void* idx, int C, void* q_out,
                         void* scales, int q4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  float* sc = static_cast<float*>(scales);
  if (dtype == 0)
    launch<0>(src, n, W, block, ix, C, q_out, sc, q4 != 0, s);
  else if (dtype == 1)
    launch<1>(src, n, W, block, ix, C, q_out, sc, q4 != 0, s);
  else if (dtype == 2)
    launch<2>(src, n, W, block, ix, C, q_out, sc, q4 != 0, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// src: the leaf's n elements (dtype code 0/1/2); q: int8 [G, B]; scale: f32
// [G]. Returns cudaGetLastError().
extern "C" int qr_launch(const void* src, long long n, int dtype, int G,
                         int B, void* q, void* scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (G + WARPS - 1) / WARPS;
  int8_t* qq = static_cast<int8_t*>(q);
  float* sc = static_cast<float*>(scale);
  if (dtype == 0)
    qr_kernel<0><<<blocks, THREADS, 0, s>>>(src, n, G, B, qq, sc);
  else if (dtype == 1)
    qr_kernel<1><<<blocks, THREADS, 0, s>>>(src, n, G, B, qq, sc);
  else if (dtype == 2)
    qr_kernel<2><<<blocks, THREADS, 0, s>>>(src, n, G, B, qq, sc);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// q: int8 [G, B]; scale: f32 [G]; out: n elements (dtype code 0/1/2),
// n <= G * B. Returns cudaGetLastError().
extern "C" int dq_launch(const void* q, const void* scale, int G, int B,
                         long long n, int dtype, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (G + WARPS - 1) / WARPS;
  const int8_t* qq = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0)
    dq_kernel<0><<<blocks, THREADS, 0, s>>>(qq, sc, B, n, out);
  else if (dtype == 1)
    dq_kernel<1><<<blocks, THREADS, 0, s>>>(qq, sc, B, n, out);
  else if (dtype == 2)
    dq_kernel<2><<<blocks, THREADS, 0, s>>>(qq, sc, B, n, out);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
