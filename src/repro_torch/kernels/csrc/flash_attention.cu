// Flash attention forward (GQA, optional causal mask) on the CUDA cores, f32
// accumulation, and the kernel that combines key-split partials.
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention_pallas
// (_flash_kernel) for f32 inputs and for head dims the tensor-core kernel
// (flash_wgmma.cu: bf16 / f16, d 64 and 128) does not take.
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
// head against 2 * (Sq + Sk) * d elements moved), at 67 TFLOP/s in f32 on
// the CUDA cores (no TF32: the f32 tolerance is 2e-6).
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
// flash_split_kernel is the same loop with a key split: when the grid of
// query tiles is too small for the card, the wrapper (kernels/
// flash_attention.py) splits the key tiles into n_split ranges of `per`
// tiles; grid.x is then query tile x split, every split writes its
// unnormalised acc and (m, l) in f32, and combine_kernel merges them: o =
// sum_i w_i acc_i / sum_i w_i l_i, w_i = exp(m_i - max m), a split with
// l = 0 (no key tile in its range) weighing 0. With ALIAS its
// probabilities reuse the K tile's shared memory once the scores are in
// registers (one more barrier a tile): at head dim 64 four CTAs then fit on
// an SM instead of three, at 128 two instead of one. The launcher runs
// flash_split_kernel (aliased) at head dims up to 64, split or not, and at
// 128 / 256 with a split (aliased at 128, whose small grid gains from the
// second CTA); flash_kernel runs the full grids at 128 and 256. This f32
// loop is bound by shared-memory loads (8 per 16 FMAs) and its speed moves
// with small changes to its code, so the full-grid kernel is kept as it
// was measured.
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
// floats of the region that holds a K tile, then the probabilities
template <int DMAX>
constexpr int KP_SIZE = BK * (DMAX + 1) > BQ * LDP ? BK * (DMAX + 1)
                                                   : BQ * LDP;
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

template <int DT, int DMAX, bool ALIAS>
__global__ void __launch_bounds__(THREADS)
flash_split_kernel(const void* __restrict__ q, const void* __restrict__ k,
             const void* __restrict__ v, void* __restrict__ o,
             float* __restrict__ part_o, float* __restrict__ part_ml, int B,
             int H, int KV, int Sq, int Sk, int d, float scale, int causal,
             int n_split, int per) {
  constexpr int LD = DMAX + 1;
  constexpr int NJ = DMAX / 16;
  constexpr int KP = ALIAS ? KP_SIZE<DMAX> : BK * LD;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + KP;
  float* sP = ALIAS ? sK : sV + BK * LD;   // ALIAS: after the scores
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = (blockIdx.x / n_split) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int split = blockIdx.x % n_split;
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

  for (int kt = split * per; kt < min(kt_end, (split + 1) * per); ++kt) {
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
    if (ALIAS) __syncthreads();   // every thread is done with sK (= sP)

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
    if (n_split > 1) {
      const long long prow = (static_cast<long long>(split) * B * H +
                              static_cast<long long>(b) * H + h) * Sq + row;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int col = tx + 16 * jj;
        if (col < d) part_o[prow * d + col] = acc[i][jj];
      }
      if (tx == 0) {
        part_ml[2 * prow] = m[i];
        part_ml[2 * prow + 1] = l[i];
      }
      continue;
    }
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

// o[r, c] from the n_split partials of row r (rows = B * H * Sq); one
// thread per output element, the row's (m, l) read by all its threads.
template <int DT>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ part_o,
               const float* __restrict__ part_ml, void* __restrict__ o,
               float* __restrict__ lse, long long rows, int d, int n_split) {
  const long long e = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (e >= rows * d) return;
  const long long r = e / d;
  float m_max = -INFINITY;
  for (int s = 0; s < n_split; ++s)
    if (part_ml[2 * (s * rows + r) + 1] > 0.0f)
      m_max = fmaxf(m_max, part_ml[2 * (s * rows + r)]);
  float l = 0.0f, acc = 0.0f;
  for (int s = 0; s < n_split; ++s) {
    const float l_s = part_ml[2 * (s * rows + r) + 1];
    if (!(l_s > 0.0f)) continue;          // no key tile in this split
    const float w = expf(part_ml[2 * (s * rows + r)] - m_max);
    l += w * l_s;
    acc += w * part_o[s * rows * d + e];
  }
  store<DT>(o, e, acc / fmaxf(l, 1e-30f));
  if (lse != nullptr && e == r * d) lse[r] = m_max + logf(l);
}

template <int DT, int DMAX, bool ALIAS>
int launch_split(const void* q, const void* k, const void* v, void* o,
                 float* part_o, float* part_ml, int B, int H, int KV, int Sq,
                 int Sk, int d, float scale, int causal, int n_split, int per,
                 cudaStream_t s) {
  constexpr int LD = DMAX + 1;
  const int smem = static_cast<int>(
      sizeof(float) *
      (BQ * LD + (ALIAS ? KP_SIZE<DMAX> : BK * LD + BQ * LDP) + BK * LD));
  cudaError_t e = cudaFuncSetAttribute(
      flash_split_kernel<DT, DMAX, ALIAS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(((Sq + BQ - 1) / BQ) * n_split, H, B);
  flash_split_kernel<DT, DMAX, ALIAS><<<grid, THREADS, smem, s>>>(
      q, k, v, o, part_o, part_ml, B, H, KV, Sq, Sk, d, scale, causal,
      n_split, per);
  return static_cast<int>(cudaGetLastError());
}

template <int DT, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o,
           float* part_o, float* part_ml, int B, int H, int KV, int Sq,
           int Sk, int d, float scale, int causal, int n_split, int per,
           cudaStream_t s) {
  // d <= 64: flash_split_kernel with the aliased probabilities, split or
  // not; d 128 / 256: flash_kernel without a split, flash_split_kernel
  // (aliased at 128) with one
  if constexpr (DMAX <= 64) {
    return launch_split<DT, DMAX, true>(q, k, v, o, part_o, part_ml, B, H, KV,
                                        Sq, Sk, d, scale, causal, n_split,
                                        per, s);
  } else {
    if (n_split > 1)
      return launch_split<DT, DMAX, DMAX <= 128>(q, k, v, o, part_o, part_ml,
                                                 B, H, KV, Sq, Sk, d, scale,
                                                 causal, n_split, per, s);
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
}

template <int DT>
int launch_d(const void* q, const void* k, const void* v, void* o,
             float* po, float* pml, int B, int H, int KV, int Sq, int Sk,
             int d, float scale, int causal, int n_split, int per,
             cudaStream_t s) {
  if (d <= 32)
    return launch<DT, 32>(q, k, v, o, po, pml, B, H, KV, Sq, Sk, d, scale,
                          causal, n_split, per, s);
  if (d <= 64)
    return launch<DT, 64>(q, k, v, o, po, pml, B, H, KV, Sq, Sk, d, scale,
                          causal, n_split, per, s);
  if (d <= 128)
    return launch<DT, 128>(q, k, v, o, po, pml, B, H, KV, Sq, Sk, d, scale,
                           causal, n_split, per, s);
  if (d <= 256)
    return launch<DT, 256>(q, k, v, o, po, pml, B, H, KV, Sq, Sk, d, scale,
                           causal, n_split, per, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: [B, H, Sq, d]; k, v: [B, KV, Sk, d]; o: [B, H, Sq, d]; all contiguous
// and of one dtype (code 0/1/2); 1 <= d <= 256, Sq, Sk >= 1, H % KV == 0.
// With n_split 1 writes o; else split s covers key tiles [s per, (s + 1)
// per) and writes part_o [n_split, B, H, Sq, d] and part_ml [n_split, B, H,
// Sq, 2] (f32) for fa_combine_launch. Returns the cudaError_t of the launch.
extern "C" int fa_launch(const void* q, const void* k, const void* v, void* o,
                         void* part_o, void* part_ml, int B, int H, int KV,
                         int Sq, int Sk, int d, float scale, int causal,
                         int dtype, int n_split, int per, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  if (n_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_d<0>(q, k, v, o, po, pml, B, H, KV, Sq, Sk, d, scale,
                       causal, n_split, per, s);
  if (dtype == 1)
    return launch_d<1>(q, k, v, o, po, pml, B, H, KV, Sq, Sk, d, scale,
                       causal, n_split, per, s);
  if (dtype == 2)
    return launch_d<2>(q, k, v, o, po, pml, B, H, KV, Sq, Sk, d, scale,
                       causal, n_split, per, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// part_o [n_split, rows, d], part_ml [n_split, rows, 2] (f32) -> o [rows, d]
// in dtype (code 0/1/2) and, when lse is not null, each row's log-sum-exp
// max m + log(sum w l) into lse [rows] (f32). Returns cudaGetLastError().
extern "C" int fa_combine_launch(const void* part_o, const void* part_ml,
                                 void* o, void* lse, long long rows, int d,
                                 int n_split, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = rows * d;
  const unsigned blocks = static_cast<unsigned>((n + THREADS - 1) / THREADS);
  const float* po = static_cast<const float*>(part_o);
  const float* pml = static_cast<const float*>(part_ml);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0)
    combine_kernel<0><<<blocks, THREADS, 0, s>>>(po, pml, o, ls, rows, d,
                                                      n_split);
  else if (dtype == 1)
    combine_kernel<1><<<blocks, THREADS, 0, s>>>(po, pml, o, ls, rows, d,
                                                      n_split);
  else if (dtype == 2)
    combine_kernel<2><<<blocks, THREADS, 0, s>>>(po, pml, o, ls, rows, d,
                                                      n_split);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
