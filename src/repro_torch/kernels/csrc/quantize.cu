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
// is flat element r*W + e, and elements at or past n read as zero. Only the
// changed rows (idx[c]) are read; frozen rows never are. Per `block`-element
// sub-block: scale = max(absmax * fl(1/qmax), 1e-12), q = clip(rint(x /
// scale), -qmax, qmax) with qmax 127 (q8) or 7 (q4). The scale multiplies by
// the f32-rounded reciprocal because that is what the reference package
// stores (XLA folds its `absmax / 127.0` into that multiply); x / scale is a
// correctly rounded division and rint rounds half to even, so the bytes
// equal the plain version's (no fast math).
//
// Bound: bytes (one read of each changed row, a quarter or an eighth of it
// written). Both gathers read each changed row from device memory once, in
// 16-byte loads, into registers, and write their output in 16-byte stores;
// a sub-block's absmax reduces by shuffles over the neighbouring lanes that
// hold it (block/16; W/32 for a q4 row of one sub-block). One thread per
// 16 bytes of output, 256 threads a CTA over a flat (row, segment) index;
// lanes past the last row join the shuffles with 0.
// q8 design (gq8_kernel): thread t of a row owns elements [16t, 16t + 16),
// which are its 16 output bytes: a 64 KiB f32 row is 1024 threads, 64 bytes
// of loads in flight each.
// q4 design (gq4_kernel): byte j pairs element j with element j + W/2, so a
// thread owns 16 consecutive bytes of the packed row: elements [16t, 16t +
// 16) of the low half and the same of the high half, 32 values kept in
// registers, both halves reduced at once (a row of one sub-block, W ==
// block, reduces both halves together). A 64 KiB f32 row is 512 threads.
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

// Two bf16 (DT 1) or f16 (DT 2) values of a 32-bit word as f32, the low
// half first.
template <int DT>
__device__ __forceinline__ void unpack2(uint32_t w, float& a, float& b) {
  const unsigned short lo = static_cast<unsigned short>(w & 0xFFFF);
  const unsigned short hi = static_cast<unsigned short>(w >> 16);
  if (DT == 1) {
    a = __uint_as_float(static_cast<uint32_t>(lo) << 16);
    b = __uint_as_float(static_cast<uint32_t>(hi) << 16);
  } else {
    a = __half2float(__ushort_as_half(lo));
    b = __half2float(__ushort_as_half(hi));
  }
}

// Elements k .. k + 15 (k a multiple of 16) as f32; one 16-byte load per 4
// (f32) or 8 (bf16 / f16) elements when all lie in [0, n), else element by
// element with zeros outside (a row index outside the leaf reads nothing).
template <int DT>
__device__ __forceinline__ void load16(const void* src, long long n,
                                       long long k, float (&x)[16]) {
  if (k >= 0 && k + 16 <= n) {
    if (DT == 0) {
      const float4* p =
          reinterpret_cast<const float4*>(static_cast<const float*>(src) + k);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float4 f = __ldg(p + v);
        x[4 * v] = f.x;
        x[4 * v + 1] = f.y;
        x[4 * v + 2] = f.z;
        x[4 * v + 3] = f.w;
      }
    } else {
      const uint4* p = reinterpret_cast<const uint4*>(
          static_cast<const unsigned short*>(src) + k);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const uint4 u = __ldg(p + v);
        unpack2<DT>(u.x, x[8 * v], x[8 * v + 1]);
        unpack2<DT>(u.y, x[8 * v + 2], x[8 * v + 3]);
        unpack2<DT>(u.z, x[8 * v + 4], x[8 * v + 5]);
        unpack2<DT>(u.w, x[8 * v + 6], x[8 * v + 7]);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) x[e] = elem<DT>(src, n, k + e);
  }
}

// q8 gather: thread gid -> row c = gid / segs, segment seg = gid % segs of
// the row (segs = W / 16). G = block / 16 lanes (a power of two <= 32)
// share a sub-block.
template <int DT>
__global__ void __launch_bounds__(THREADS)
gq8_kernel(const void* __restrict__ src, long long n, int W, int block,
           int G, const int32_t* __restrict__ idx, int C,
           int8_t* __restrict__ q, float* __restrict__ scales) {
  const int segs = W / 16, n_sub = W / block;
  const long long gid = static_cast<long long>(blockIdx.x) * THREADS +
                        threadIdx.x;
  const bool valid = gid < static_cast<long long>(C) * segs;
  const int c = valid ? static_cast<int>(gid / segs) : 0;
  const int seg = static_cast<int>(gid - static_cast<long long>(c) * segs);
  float x[16];
  float m = 0.0f;
  if (valid) {
    load16<DT>(src, n, static_cast<long long>(idx[c]) * W + 16LL * seg, x);
#pragma unroll
    for (int e = 0; e < 16; ++e) m = fmaxf(m, fabsf(x[e]));
  }
  for (int o = 1; o < G; o <<= 1)            // every lane takes part
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (!valid) return;
  const float s = fmaxf(m * (1.0f / 127.0f), 1e-12f);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    w[e / 4] |= static_cast<uint32_t>(quant<false>(x[e], s) & 0xFF)
                << (8 * (e % 4));
  reinterpret_cast<uint4*>(q + static_cast<long long>(c) * W)[seg] =
      make_uint4(w[0], w[1], w[2], w[3]);
  if ((seg & (G - 1)) == 0)
    scales[static_cast<long long>(c) * n_sub + 16 * seg / block] = s;
}

// q4 gather: thread gid -> row c = gid / segs, segment seg = gid % segs of
// the W/2 packed bytes (segs = W / 32). G lanes (a power of two <= 32
// dividing segs) share a sub-block in each half.
template <int DT>
__global__ void __launch_bounds__(THREADS)
gq4_kernel(const void* __restrict__ src, long long n, int W, int block,
           int G, const int32_t* __restrict__ idx, int C,
           uint8_t* __restrict__ q_out, float* __restrict__ scales) {
  const int half = W / 2, segs = W / 32, n_sub = W / block;
  const long long gid = static_cast<long long>(blockIdx.x) * THREADS +
                        threadIdx.x;
  const bool valid = gid < static_cast<long long>(C) * segs;
  const int c = valid ? static_cast<int>(gid / segs) : 0;
  const int seg = static_cast<int>(gid - static_cast<long long>(c) * segs);
  float lo[16], hi[16];
  float m_lo = 0.0f, m_hi = 0.0f;
  if (valid) {
    const long long base = static_cast<long long>(idx[c]) * W + 16LL * seg;
    load16<DT>(src, n, base, lo);
    load16<DT>(src, n, base + half, hi);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      m_lo = fmaxf(m_lo, fabsf(lo[e]));
      m_hi = fmaxf(m_hi, fabsf(hi[e]));
    }
  }
  if (n_sub == 1) m_lo = m_hi = fmaxf(m_lo, m_hi);
  for (int o = 1; o < G; o <<= 1) {          // every lane takes part
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
  }
  if (!valid) return;
  const float s_lo = fmaxf(m_lo * (1.0f / 7.0f), 1e-12f);
  const float s_hi = fmaxf(m_hi * (1.0f / 7.0f), 1e-12f);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int a = quant<true>(lo[e], s_lo), b = quant<true>(hi[e], s_hi);
    w[e / 4] |= static_cast<uint32_t>((a & 0xF) | ((b & 0xF) << 4))
                << (8 * (e % 4));
  }
  reinterpret_cast<uint4*>(q_out + static_cast<long long>(c) * half)[seg] =
      make_uint4(w[0], w[1], w[2], w[3]);
  if ((seg & (G - 1)) == 0) {
    float* sc = scales + static_cast<long long>(c) * n_sub;
    sc[16 * seg / block] = s_lo;
    if (n_sub > 1) sc[(16 * seg + half) / block] = s_hi;
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

}  // namespace

// src: the leaf's n elements (dtype code 0/1/2), 16-byte aligned; idx: int32
// [C]; q: int8 [C, W] (16-byte aligned); scales: f32 [C, W/block]. W % block
// == 0; G = block / 16, a power of two <= 32 (the wrapper checks). Returns
// cudaGetLastError().
extern "C" int gq8_launch(const void* src, long long n, int dtype, int W,
                          int block, int G, const void* idx, int C, void* q,
                          void* scales, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  int8_t* qq = static_cast<int8_t*>(q);
  float* sc = static_cast<float*>(scales);
  const long long threads = static_cast<long long>(C) * (W / 16);
  const unsigned blocks = static_cast<unsigned>((threads + THREADS - 1) /
                                                THREADS);
  if (dtype == 0)
    gq8_kernel<0><<<blocks, THREADS, 0, s>>>(src, n, W, block, G, ix, C, qq,
                                             sc);
  else if (dtype == 1)
    gq8_kernel<1><<<blocks, THREADS, 0, s>>>(src, n, W, block, G, ix, C, qq,
                                             sc);
  else if (dtype == 2)
    gq8_kernel<2><<<blocks, THREADS, 0, s>>>(src, n, W, block, G, ix, C, qq,
                                             sc);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// src: the leaf's n elements (dtype code 0/1/2), 16-byte aligned; idx: int32
// [C]; q_out: uint8 [C, W/2] (16-byte aligned); scales: f32 [C, W/block].
// W % 32 == 0; block % 16 == 0; G = block / 16 with W / block even, or G =
// W / 32 with W == block; G a power of two <= 32 (the wrapper checks).
// Returns cudaGetLastError().
extern "C" int gq4_launch(const void* src, long long n, int dtype, int W,
                          int block, int G, const void* idx, int C,
                          void* q_out, void* scales, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  uint8_t* qo = static_cast<uint8_t*>(q_out);
  float* sc = static_cast<float*>(scales);
  const long long threads = static_cast<long long>(C) * (W / 32);
  const unsigned blocks = static_cast<unsigned>((threads + THREADS - 1) /
                                                THREADS);
  if (dtype == 0)
    gq4_kernel<0><<<blocks, THREADS, 0, s>>>(src, n, W, block, G, ix, C, qo,
                                             sc);
  else if (dtype == 1)
    gq4_kernel<1><<<blocks, THREADS, 0, s>>>(src, n, W, block, G, ix, C, qo,
                                             sc);
  else if (dtype == 2)
    gq4_kernel<2><<<blocks, THREADS, 0, s>>>(src, n, W, block, G, ix, C, qo,
                                             sc);
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
