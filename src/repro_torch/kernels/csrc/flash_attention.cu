// Flash attention forward (GQA, optional causal mask), f32 accumulation.
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention_pallas
// (_flash_kernel).
//
// q [B, H, Sq, d], k/v [B, KV, Sk, d], contiguous, H % KV == 0; query head h
// reads KV head h / (H / KV). Output o [B, H, Sq, d] in q's dtype (f32, bf16
// or f16). Per query row, over the keys in tiles of 64: scores s = (q . k) *
// scale in f32; under the causal mask a key col > row + (Sk - Sq) scores
// -1e30, not -inf, as in the reference, so a row that sees no key at all
// (Sq > Sk) averages v uniformly; online softmax (m, l, acc) in f32 with
// expf (no fast math); o = acc / max(l, 1e-30). Keys past Sk (the ragged
// last tile) score -inf and weigh nothing.
//
// Bound: operations at the repo's attention shapes (4 * Sq * Sk * d flops a
// head against 2 * (Sq + Sk) * d elements moved). This first version runs on
// the CUDA cores in f32 (no tensor cores, no TF32), so for bf16 inputs it
// cannot approach the tensor-core bound; wgmma and TMA are later work.
// Design: one CTA of 256 threads per (64-row query tile, head, batch). The
// Q tile, each K and V tile and the 64 x 64 probabilities sit in shared
// memory as f32 rows padded by one word, so the column walks hit distinct
// banks. Thread (ty, tx) of a 16 x 16 grid owns query rows ty + 16i and key
// columns tx + 16j (i, j < 4) of the scores and rows ty + 16i x columns
// tx + 16jj of the output accumulator, in registers; the 16 threads of a
// half-warp share their rows and reduce max and sum by shuffles. Key tiles
// wholly above the causal diagonal are skipped (the same function), except
// in a query tile holding a row with no visible key, where every tile runs
// so that row averages all of v as the reference does.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;             // query rows per CTA
constexpr int BK = 64;             // keys per tile
constexpr int LDP = BK + 1;        // padded row of the probabilities
constexpr float MASKED = -1e30f;

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16
template <int DT>
__device__ __forceinline__ float load(const void* p, long long i) {
  if (DT == 0) return __ldg(static_cast<const float*>(p) + i);
  const unsigned short u = __ldg(static_cast<const unsigned short*>(p) + i);
  if (DT == 1) return __uint_as_float(static_cast<uint32_t>(u) << 16);
  return __half2float(__ushort_as_half(u));
}

template <int DT>
__device__ __forceinline__ void store(void* p, long long i, float x) {
  if (DT == 0)
    static_cast<float*>(p)[i] = x;
  else if (DT == 1)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else
    static_cast<__half*>(p)[i] = __float2half_rn(x);
}

// Rows [row0, row0 + 64) of one head's [S, d] slice at `base` -> shared f32
// [64][LD], zero past S and past d. Neighbouring threads read neighbouring
// elements of the (contiguous) tile.
template <int DT, int LD>
__device__ __forceinline__ void load_tile(const void* src, long long base,
                                          int row0, int S, int d,
                                          float* dst) {
  const int rows = min(BQ, S - row0);
  for (int e = threadIdx.x; e < BQ * LD; e += THREADS) {
    const int r = e / LD, c = e - r * LD;
    dst[e] = (r < rows && c < d)
                 ? load<DT>(src, base + static_cast<long long>(row0 + r) * d + c)
                 : 0.0f;
  }
}

template <int DT, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const void* __restrict__ q, const void* __restrict__ k,
             const void* __restrict__ v, void* __restrict__ o, int H, int KV,
             int Sq, int Sk, int d, float scale, int causal) {
  constexpr int LD = DMAX + 1;
  constexpr int NJ = DMAX / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_base = (static_cast<long long>(b) * H + h) * Sq * d;
  const long long k_base = (static_cast<long long>(b) * KV + kvh) * Sk * d;
  const int offset = Sk - Sq;

  load_tile<DT, LD>(q, q_base, row0, Sq, d, sQ);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = MASKED;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) acc[i][jj] = 0.0f;
  }

  const int n_kt = (Sk + BK - 1) / BK;
  int kt_end = n_kt;
  if (causal && row0 + offset >= 0) {
    // every row of the tile sees key 0: keys past the last row's diagonal
    // are masked for all of them
    const int last_row = min(row0 + BQ, Sq) - 1;
    kt_end = min(n_kt, (last_row + offset) / BK + 1);
  }

  for (int kt = 0; kt < kt_end; ++kt) {
    __syncthreads();              // the previous tile's readers are done
    load_tile<DT, LD>(k, k_base, kt * BK, Sk, d, sK);
    load_tile<DT, LD>(v, k_base, kt * BK, Sk, d, sV);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * BK + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= Sk)
          x = -INFINITY;
        else if (causal && col > row + offset)
          x = MASKED;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) acc[i][jj] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const float vv = sV[c * LD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(p[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int col = tx + 16 * jj;
      if (col < d)
        store<DT>(o, q_base + static_cast<long long>(row) * d + col,
                  acc[i][jj] / denom);
    }
  }
}

template <int DT, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int Sq, int Sk, int d, float scale, int causal,
           cudaStream_t s) {
  constexpr int LD = DMAX + 1;
  const int smem =
      static_cast<int>(sizeof(float) * (BQ * LD + 2 * BK * LD + BQ * LDP));
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<DT, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<DT, DMAX><<<grid, THREADS, smem, s>>>(q, k, v, o, H, KV, Sq,
                                                     Sk, d, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int DT>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KV, int Sq, int Sk, int d, float scale, int causal,
             cudaStream_t s) {
  if (d <= 32)
    return launch<DT, 32>(q, k, v, o, B, H, KV, Sq, Sk, d, scale, causal, s);
  if (d <= 64)
    return launch<DT, 64>(q, k, v, o, B, H, KV, Sq, Sk, d, scale, causal, s);
  if (d <= 128)
    return launch<DT, 128>(q, k, v, o, B, H, KV, Sq, Sk, d, scale, causal, s);
  if (d <= 256)
    return launch<DT, 256>(q, k, v, o, B, H, KV, Sq, Sk, d, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: [B, H, Sq, d]; k, v: [B, KV, Sk, d]; o: [B, H, Sq, d]; all contiguous
// and of one dtype (code 0/1/2); 1 <= d <= 256, Sq, Sk >= 1, H % KV == 0.
// Returns the cudaError_t of the launch.
extern "C" int fa_launch(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int KV, int Sq, int Sk, int d,
                         float scale, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<0>(q, k, v, o, B, H, KV, Sq, Sk, d, scale, causal, s);
  if (dtype == 1)
    return launch_d<1>(q, k, v, o, B, H, KV, Sq, Sk, d, scale, causal, s);
  if (dtype == 2)
    return launch_d<2>(q, k, v, o, B, H, KV, Sq, Sk, d, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
