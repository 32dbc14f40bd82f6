// Flash attention forward on Hopper's tensor cores: bf16 / f16 inputs, head
// dim 64 or 128, GQA, optional causal mask, keys optionally split across CTAs.
//
// Replaces src/repro/kernels/flash_attention.py: flash_attention_pallas
// (_flash_kernel) for those dtypes and head dims; f32 and other head dims run
// on the CUDA-core kernel of flash_attention.cu, which also holds the kernel
// that combines split partials.
//
// Function (as flash_attention.cu and kernels/ref.py::flash_attention_ref):
// s = (q . k) * scale in f32; under the causal mask a key col > row + (Sk -
// Sq) scores -1e30 (a row that sees no key averages v), keys past Sk score
// -inf; online softmax in f32 with expf; o = acc / max(l, 1e-30).
//
// Bound: operations, 4 * d flops per visible (query, key) pair at 989
// TFLOP/s in bf16 / f16 (the qwen3-14b layer moves 42 MB for 43 GFLOP).
// Design, one CTA per (128-row query tile, head, batch[, key split]):
// - three warpgroups: two consumers own 64 query rows each; one thread of
//   the third is the producer. It brings the Q tile in once by TMA, then K
//   and V tiles of 64 keys through a 2-stage ring in shared memory, each
//   stage guarded by a "full" mbarrier (TMA transaction bytes) and an
//   "empty" one (every consumer thread arrives when done with the stage).
// - The tensor maps are 4-D ([batch][heads][rows][d] by the tensor's own
//   strides, so q, k, v and o may be the model's [B, S, H, d] seen through
//   a transpose) with 128-byte swizzle: a box is 64 elements (128 bytes)
//   by 64 or 128 rows of one head, so d 128 comes in two column panels.
//   Rows past Sq or Sk read as zeros, never another head's. The wgmma
//   descriptors use the same 128-byte swizzle (8-row atoms of 1024 bytes,
//   every panel 1024-aligned).
// - S = Q K^T: wgmma m64n64k16, A (Q) and B (K) both K-major in shared
//   memory, f32 accumulator in registers, d / 16 steps; a k-step advances
//   the descriptors by 32 bytes inside the swizzle atom, a panel by its
//   size.
// - Online softmax on the accumulator fragment: a thread holds 2 rows x 16
//   columns; row max is reduced by shuffles in the quad that owns the row,
//   the row sum stays per thread until the end.
// - O += P V: wgmma m64n64k16 per 64-column panel of V, P from registers
//   (the S fragment is the A fragment layout, so no shared-memory trip), V
//   from shared memory, transposed (tnspB: V is d-contiguous). P is split
//   as hi = fl16(p), lo = fl16(p - hi) and both products accumulate into the
//   same f32 accumulator: a single 16-bit rounding of p would cost up to
//   2^-9 * sum(p|v|), past atol 1e-4 on rows whose output cancels; the pair
//   keeps it near 2^-17 for 1.5x the tensor-core work. Q K^T products of
//   16-bit values are exact in f32: only the summation order differs from
//   the plain version.
// - Keys split across CTAs when the grid is small (the plan is computed in
//   kernels/flash_attention.py from the shapes): each split writes its
//   unnormalised acc and (m, l) in f32; a split with no key tile writes
//   m = -inf, l = 0, and the combine kernel weighs it 0. Key tiles wholly
//   above the diagonal are skipped only in query tiles whose every row
//   sees key 0, so rows that see no key still score every key at -1e30.
// - Query tiles are issued longest first (causal work grows with the row).
// - The training step's backward (flash_wgmma_bwd.cu) needs each row's
//   log-sum-exp: lse = m + log(l), written beside o when a pointer is
//   passed (by the combine kernel under a key split). A row that sees no
//   key reads lse = -1e30 (log(l) is lost below its ulp); the backward
//   knows such rows by their position.
// GQA heads are not packed into one CTA: each query head re-reads its KV
// head's tiles (from L2).
#include "flash_wgmma.cuh"

namespace {

constexpr int NWG = 2;                 // consumer warpgroups
constexpr int BQ = 64 * NWG;           // query rows per CTA
constexpr int BK = 64;                 // keys per tile
constexpr int STAGES = 2;              // K/V ring depth
constexpr int THREADS = 128 * (NWG + 1);

template <int D, int F16>
__global__ void __launch_bounds__(THREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, void* __restrict__ o,
                float* __restrict__ part_o, float* __restrict__ part_ml,
                float* __restrict__ lse, Layout lo, int B, int H, int KV,
                int Sq, int Sk, float scale, int causal, int n_split,
                int per) {
  constexpr int NP = D / PANEL;                   // column panels
  constexpr int Q_BYTES = BQ * D * 2;
  constexpr int TILE_BYTES = BK * D * 2;          // one K (or V) tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], qbar;

  // 128-byte swizzle wants 1024-byte aligned atoms
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sQ = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* sK = sQ + Q_BYTES;                     // [STAGES][TILE_BYTES]
  uint8_t* sV = sK + STAGES * TILE_BYTES;

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / n_split;
  const int split = static_cast<int>(blockIdx.x) % n_split;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int row0 = qt * BQ, off = Sk - Sq;
  const int n_kt = (Sk + BK - 1) / BK;
  int kt_end = n_kt;
  if (causal && row0 + off >= 0)     // every row sees key 0
    kt_end = min(n_kt, (min(row0 + BQ, Sq) - 1 + off) / BK + 1);
  const int kt0 = split * per;
  const int n_it = max(0, min(kt0 + per, kt_end) - kt0);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 128);
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // ---- producer: one thread issues every TMA copy
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(&qbar, Q_BYTES);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_load_4d(sQ + p * BQ * ROW_BYTES, &tq, &qbar, p * PANEL, row0, h,
                    b);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * TILE_BYTES);
        const int key = (kt0 + it) * BK;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load_4d(sK + s * TILE_BYTES + p * BK * ROW_BYTES, &tk, &full[s],
                      p * PANEL, key, kvh, b);
          tma_load_4d(sV + s * TILE_BYTES + p * BK * ROW_BYTES, &tv, &full[s],
                      p * PANEL, key, kvh, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows [row0 + 64 wg, +64)
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, cq = lane & 3;
  const int r_lo = row0 + wg * 64 + warp * 16 + g;   // and r_lo + 8
  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  const uint32_t q_addr = smem_u32(sQ) + wg * 64 * ROW_BYTES;

  mbar_wait(&qbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const uint32_t k_addr = smem_u32(sK + s * TILE_BYTES);
    const uint32_t v_addr = smem_u32(sV + s * TILE_BYTES);

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4, w = kk % 4;
      wgmma_ss<F16>(sc,
                    make_desc(q_addr + p * BQ * ROW_BYTES + w * 32, 16, 1024),
                    make_desc(k_addr + p * BK * ROW_BYTES + w * 32, 16, 1024),
                    kk > 0 ? 1 : 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(sc);

    // scale and mask: reg i holds row r_lo + 8 ((i >> 1) & 1), column
    // col0 + 8 (i >> 2) + 2 cq + (i & 1)
    const int col0 = (kt0 + it) * BK;
    const bool edge = col0 + BK > Sk || (causal && col0 + BK - 1 > r_lo + off);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale;
      if (edge) {
        const int row = r_lo + 8 * ((i >> 1) & 1);
        const int col = col0 + 8 * (i >> 2) + 2 * cq + (i & 1);
        if (col >= Sk)
          x = -INFINITY;
        else if (causal && col > row + off)
          x = MASKED;
      }
      sc[i] = x;
    }

    // online softmax; column col0 < Sk lies in every row's quad, so each
    // tile's row max is finite
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pr = expf(sc[4 * j + 2 * r + e] - m_new);
          sc[4 * j + 2 * r + e] = pr;
          sum += pr;
        }
      l[r] = l[r] * corr[r] + sum;
    }
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] *= corr[(i >> 1) & 1];

    // P as A fragments: k-step kk (16 keys) is sc[8 kk .. 8 kk + 8)
    uint32_t ph[16], pl[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_pair<F16>(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1],
                        ph[4 * kk + j], pl[4 * kk + j]);
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        // 16 keys of panel p: 2 atoms of 8 keys (SBO 1024); LBO = panel
        const uint64_t db = make_desc(
            v_addr + p * BK * ROW_BYTES + kk * 16 * ROW_BYTES,
            BK * ROW_BYTES, 1024);
        wgmma_rs<F16>(acc[p], &ph[4 * kk], db);
        wgmma_rs<F16>(acc[p], &pl[4 * kk], db);
      }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const long long bh = static_cast<long long>(b) * H + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    if (row >= Sq) continue;
    if (n_split == 1) {
      const float den = fmaxf(l[r], 1e-30f);
      if (lse != nullptr && cq == 0) lse[bh * Sq + row] = m[r] + logf(l[r]);
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          static_cast<uint16_t*>(o) + b * lo.b + h * lo.h + row * lo.s);
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[(p * PANEL + 8 * j + 2 * cq) / 2] = pack_out<F16>(
              acc[p][4 * j + 2 * r] / den, acc[p][4 * j + 2 * r + 1] / den);
    } else {
      const long long prow =
          (static_cast<long long>(split) * B * H + bh) * Sq + row;
      float2* dst = reinterpret_cast<float2*>(part_o + prow * D);
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[(p * PANEL + 8 * j + 2 * cq) / 2] =
              make_float2(acc[p][4 * j + 2 * r], acc[p][4 * j + 2 * r + 1]);
      if (cq == 0) {
        part_ml[2 * prow] = m[r];
        part_ml[2 * prow + 1] = l[r];
      }
    }
  }
}

template <int D, int F16>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, void* o, float* part_o, float* part_ml,
           float* lse, Layout lo, int B, int H, int KV, int Sq, int Sk,
           float scale, int causal, int n_split, int per, cudaStream_t s) {
  const int smem = BQ * D * 2 + 2 * STAGES * BK * D * 2 + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      fa_wgmma_kernel<D, F16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(((Sq + BQ - 1) / BQ) * n_split, H, B);
  fa_wgmma_kernel<D, F16><<<grid, THREADS, smem, s>>>(
      tq, tk, tv, o, part_o, part_ml, lse, lo, B, H, KV, Sq, Sk, scale,
      causal, n_split, per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o [B, H, Sq, d], k/v [B, KV, Sk, d], one 16-bit dtype (1 = bf16, 2 =
// f16), d 64 or 128, H % KV == 0; each laid out by its three element
// strides in lay (batch, head, row: q, k, v, o in turn), its head dim
// contiguous, every stride a multiple of 8 and every pointer of 16 bytes.
// With n_split 1 writes o and, when lse is not null, each row's f32
// log-sum-exp m + log(l) of the scaled scores into lse [B, H, Sq]
// (contiguous); else split s covers key tiles [s per, (s + 1) per) and
// writes part_o [n_split, B, H, Sq, d] and part_ml [n_split, B, H, Sq, 2]
// (f32) for fa_combine_launch (o contiguous), which writes lse.
// Returns the cudaError_t of the launch, or cudaErrorInvalidValue for a
// shape it does not take or a tensor map the encode call refuses.
extern "C" int fa_wgmma_launch(const void* q, const void* k, const void* v,
                               void* o, void* part_o, void* part_ml,
                               void* lse, const long long* lay, int B, int H,
                               int KV, int Sq, int Sk, int d, float scale,
                               int causal, int dtype, int n_split, int per,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 1 && dtype != 2) || (d != 64 && d != 128) || n_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int f16 = dtype == 2;
  const Layout lq{lay[0], lay[1], lay[2]}, lk{lay[3], lay[4], lay[5]},
      lv{lay[6], lay[7], lay[8]}, lo{lay[9], lay[10], lay[11]};
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, f16, d, Sq, H, B, lq, BQ) ||
      !make_map(&tk, k, f16, d, Sk, KV, B, lk, BK) ||
      !make_map(&tv, v, f16, d, Sk, KV, B, lv, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto run = d == 64 ? (f16 ? launch<64, 1> : launch<64, 0>)
                     : (f16 ? launch<128, 1> : launch<128, 0>);
  return run(tq, tk, tv, o, static_cast<float*>(part_o),
             static_cast<float*>(part_ml), static_cast<float*>(lse), lo, B, H,
             KV, Sq, Sk, scale, causal, n_split, per, s);
}
