// Flash attention backward on Hopper's tensor cores: bf16 / f16 inputs, head
// dim 64 or 128, GQA, optional causal mask (bottom right, as the forward).
//
// Replaces no TPU kernel: the reference package's flash_attention_pallas
// (src/repro/kernels/flash_attention.py) has no VJP, and its models train
// through plain chunked or naive attention. It was added because those
// paths, ported as plain tensor code, took 90.5% (4096-token rows) and
// 46.8% (512-token rows) of the card's time in a granite-3-2b train step:
// the forward (flash_wgmma.cu) cannot enter a train step without it.
//
// Function (as kernels/ref.py::flash_attention_bwd_ref): from q, k, v, the
// forward's o and lse = m + log(l) (per query row, f32) and dO,
//   D  = rowsum(dO * o)                      (f32, fa_bwd_dot_kernel)
//   P  = exp(s * scale - lse), s = q . k     (f32; 0 where masked)
//   dP = dO . v,  dS = P * (dP - D)          (f32; 0 where masked)
//   dV = sum over the query heads of the group of P^T dO
//   dK = scale * sum of dS^T q,  dQ = scale * dS k
// with f32 accumulators, written in q's dtype. A query row that sees no
// key (causal, Sq > Sk) had every score at -1e30 in the forward, so its P
// is 1/Sk for every key and its dS is 0; its lse (-1e30) cannot say so, so
// the kernels know such rows by position.
//
// Precision: P and dS enter their 16-bit products as the forward's hi + lo
// pair (split_pair: hi = fl16(x), lo = fl16(x - hi)), which keeps them near
// 2^-17 relative, the configuration's float32 probabilities (a bfloat16
// configuration gets the same, more precise, products). q, k, v and dO are
// 16-bit already, so S and dP are exact products summed in f32.
//
// Bound: operations. 10 d flops per visible (query, key) pair against the
// forward's 4 d: S and dP twice (once in each kernel), dV, dK and dQ once,
// 2 d each; the hi + lo pair adds 6 d of tensor-core work on top (the
// bound counts the 10). At the cells' shapes (d 64, 4 x 4096 and 32 x 512
// tokens) the bytes are 1-2% of the operations' time at 989 TFLOP/s.
//
// Design:
// - fa_bwd_dkdv_kernel, one CTA per (128-key tile, KV head, batch): K and
//   V of its keys come in once by TMA; two consumer warpgroups own 64 keys
//   each, and one producer warp streams Q, dO (by TMA), lse and D (by the
//   warp's 32 lanes) of 64-row query tiles through a 2-stage ring with
//   "full" and "empty" mbarriers. It walks the G query heads of its KV
//   head and, under the causal mask, only the query tiles at or below its
//   keys (all of them when some row sees no key). Per tile a warpgroup
//   computes S^T = K Q^T and dP^T = V dO^T by wgmma (both operands in
//   shared memory, two commit groups, so P^T's exponentials run while
//   dP^T is still on the tensor cores), P^T and dS^T in registers (the
//   accumulator fragment is the A fragment of the next products, as in
//   the forward), then dV += P^T dO and dK += dS^T Q with dO and Q read
//   transposed from the same stage; at d 64 dV is issued before dS^T is
//   formed. The G heads of a group sum into one accumulator inside the
//   CTA: no atomics and no reduction pass for GQA.
// - Registers: the launch gives each of its 384 threads 168; the producer
//   warpgroup gives its share back (setmaxnreg, 40) and the consumers take
//   232, which hold both f32 accumulators (64 a thread at d 64, 128 at
//   d 128), S^T, dP^T and their 16-bit halves without spilling (168 spilt
//   4 KB a thread at d 128 and ran 5x slower).
// - fa_bwd_dq_kernel, one CTA per (128-row query tile, head, batch), the
//   forward's layout, 288 threads (two consumer warpgroups, one producer
//   warp): Q and dO come in once, K and V tiles of 64 keys through the
//   ring; S = Q K^T and dP = dO V^T recomputed, dS formed, dQ += dS K. A
//   second kernel rather than f32 atomics into a dQ scratch: every sum runs
//   in a fixed order, so two calls give the same bits and a replay's
//   fingerprints see the same state.
// - exp(x) is ex2.approx of x log2(e) (the scale folded into one FMA):
//   its 2^-22 relative error is below the pair's 2^-16.
// - No key split: at the training shapes the grids hold 1 024 (dK / dV)
//   and 4 096 (dQ) CTAs.
#include "flash_wgmma.cuh"

namespace {

constexpr int THREADS = 288;           // dQ: 2 consumer warpgroups + 1 warp
constexpr int KV_THREADS = 384;        // dK / dV: 2 consumer + 1 producer WG
constexpr int PRODUCER_WARP = 8;
constexpr int CONSUMERS = 256;
constexpr int KT = 128;                // keys per dK/dV CTA
constexpr int QT = 64;                 // query rows per streamed tile
constexpr int QB = 128;                // query rows per dQ CTA
constexpr int KB = 64;                 // keys per streamed tile
constexpr int STAGES = 2;

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2^-22, below the
// hi + lo pair's 2^-16; results below f32's normal range flush to 0)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Hand registers from the producer warpgroup (down to 40 a thread) to the
// consumer warpgroups (up to 232): 128 x 40 + 256 x 232 = 64 512 of the SM's
// 65 536, where the launch gives every thread 168
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

template <int F16>
__device__ __forceinline__ float2 unpack2(uint32_t u) {
  if (F16) return __half22float2(*reinterpret_cast<const __half2*>(&u));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// D[r] = sum_c dO[r, c] o[r, c] in f32 for the rows r = (b H + h) Sq + row
// of dvec: one warp a row, lanes over column pairs, a fixed shuffle tree
template <int F16>
__global__ void __launch_bounds__(256)
fa_bwd_dot_kernel(const uint16_t* __restrict__ o,
                  const uint16_t* __restrict__ dout, float* __restrict__ dvec,
                  Layout lo, Layout ldo, int H, int Sq, long long rows,
                  int d) {
  const long long r = static_cast<long long>(blockIdx.x) * 8 + threadIdx.x / 32;
  if (r >= rows) return;
  const long long row = r % Sq, bh = r / Sq, h = bh % H, b = bh / H;
  const uint32_t* orow = reinterpret_cast<const uint32_t*>(
      o + b * lo.b + h * lo.h + row * lo.s);
  const uint32_t* grow = reinterpret_cast<const uint32_t*>(
      dout + b * ldo.b + h * ldo.h + row * ldo.s);
  const int lane = threadIdx.x & 31, w = d / 2;
  float acc = 0.0f;
  for (int i = lane; i < w; i += 32) {
    const float2 a = unpack2<F16>(orow[i]);
    const float2 g = unpack2<F16>(grow[i]);
    acc = fmaf(a.x, g.x, acc);
    acc = fmaf(a.y, g.y, acc);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) dvec[r] = acc;
}

// dV += P^T dO: 16 query rows of panel p of the dO stage a k-step, read
// transposed, hi and lo halves of P
template <int NP, int F16>
__device__ __forceinline__ void dv_products(float (&dva)[NP][32],
                                            const uint32_t (&ph)[16],
                                            const uint32_t (&pl)[16],
                                            uint32_t o_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const uint64_t bo = make_desc(
          o_addr + p * QT * ROW_BYTES + kk * 16 * ROW_BYTES, QT * ROW_BYTES,
          1024);
      wgmma_rs<F16>(dva[p], &ph[4 * kk], bo);
      wgmma_rs<F16>(dva[p], &pl[4 * kk], bo);
    }
}

template <int D, int F16>
__global__ void __launch_bounds__(KV_THREADS, 1)
fa_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ dvec, void* __restrict__ dk,
                   void* __restrict__ dv, Layout ldk, Layout ldv, int H,
                   int KV, int Sq, int Sk, float scale, int causal) {
  constexpr int NP = D / PANEL;
  constexpr bool EARLY_DV = D == 64;
  constexpr int KV_BYTES = KT * D * 2;            // the K (or V) tile
  constexpr int TILE_BYTES = QT * D * 2;          // one Q (or dO) tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], kvbar;
  __shared__ float s_lse[STAGES][QT], s_d[STAGES][QT];

  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sK = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* sV = sK + KV_BYTES;
  uint8_t* sQ = sV + KV_BYTES;                    // [STAGES][TILE_BYTES]
  uint8_t* sO = sQ + STAGES * TILE_BYTES;         // dO, the same

  const int key0 = blockIdx.x * KT, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, off = Sk - Sq;
  const int n_qt = (Sq + QT - 1) / QT;
  // under the causal mask rows below key0 - off see none of these keys;
  // with Sq > Sk rows that see no key weigh every key, so all tiles run
  const int qt0 = causal && off >= 0 ? min(n_qt, max(0, key0 - off) / QT) : 0;
  const int per_head = n_qt - qt0;
  const int n_it = G * per_head;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(&kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warp (the first of the third warpgroup, the others
    // leave): lane 0 issues the TMA copies, every lane brings two rows of
    // lse and D, then arrives on the stage's "full" barrier
    producer_regs();
    if (threadIdx.x / 32 != PRODUCER_WARP) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(&kvbar, 2 * KV_BYTES);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tma_load_4d(sK + p * KT * ROW_BYTES, &tk, &kvbar, p * PANEL, key0,
                    kvh, b);
        tma_load_4d(sV + p * KT * ROW_BYTES, &tv, &kvbar, p * PANEL, key0,
                    kvh, b);
      }
    }
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES;
      const int h = kvh * G + it / per_head;
      const int row0 = (qt0 + it % per_head) * QT;
      const long long bh = static_cast<long long>(b) * H + h;
      if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = row0 + lane + 32 * j;
        s_lse[s][lane + 32 * j] = r < Sq ? lse[bh * Sq + r] * LOG2E : 0.0f;
        s_d[s][lane + 32 * j] = r < Sq ? dvec[bh * Sq + r] : 0.0f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * TILE_BYTES);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load_4d(sQ + s * TILE_BYTES + p * QT * ROW_BYTES, &tq, &full[s],
                      p * PANEL, row0, h, b);
          tma_load_4d(sO + s * TILE_BYTES + p * QT * ROW_BYTES, &tdo,
                      &full[s], p * PANEL, row0, h, b);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys [key0 + 64 wg, +64)
  consumer_regs();
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, cq = lane & 3;
  const int k_lo = key0 + wg * 64 + warp * 16 + g;   // and k_lo + 8
  const float inv_sk = 1.0f / static_cast<float>(Sk);
  const float scale2 = scale * LOG2E;
  float dka[NP][32], dva[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[p][i] = dva[p][i] = 0.0f;
  const uint32_t k_addr = smem_u32(sK) + wg * 64 * ROW_BYTES;
  const uint32_t v_addr = smem_u32(sV) + wg * 64 * ROW_BYTES;

  mbar_wait(&kvbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % STAGES;
    const int row0 = (qt0 + it % per_head) * QT;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const uint32_t q_addr = smem_u32(sQ + s * TILE_BYTES);
    const uint32_t o_addr = smem_u32(sO + s * TILE_BYTES);

    // S^T = K Q^T and dP^T = V dO^T: keys are rows, queries columns
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
    fence_regs(sc);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4, w = kk % 4;
      wgmma_ss<F16>(sc,
                    make_desc(k_addr + p * KT * ROW_BYTES + w * 32, 16, 1024),
                    make_desc(q_addr + p * QT * ROW_BYTES + w * 32, 16, 1024),
                    kk > 0 ? 1 : 0);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4, w = kk % 4;
      wgmma_ss<F16>(dp,
                    make_desc(v_addr + p * KT * ROW_BYTES + w * 32, 16, 1024),
                    make_desc(o_addr + p * QT * ROW_BYTES + w * 32, 16, 1024),
                    kk > 0 ? 1 : 0);
    }
    wg_commit();
    wg_wait1();                        // S^T done, dP^T may still run
    fence_regs(sc);

    // reg i holds key k_lo + 8 ((i >> 1) & 1), query row0 + c(i),
    // c(i) = 8 (i >> 2) + 2 cq + (i & 1)
    const bool edge = row0 + QT > Sq || k_lo + 8 >= Sk ||
                      (causal && k_lo + 8 > row0 + off);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + 2 * cq + (i & 1);
      int kind = 0;                    // 0 seen, 1 hidden, 2 row sees no key
      if (edge) {
        const int key = k_lo + 8 * ((i >> 1) & 1), col = row0 + c;
        if (col >= Sq || key >= Sk)
          kind = 1;
        else if (causal && key > col + off)
          kind = col + off < 0 ? 2 : 1;
      }
      sc[i] = kind == 0 ? exp2_fast(fmaf(sc[i], scale2, -s_lse[s][c]))
                        : (kind == 2 ? inv_sk : 0.0f);
    }
    // P^T and dS^T as A fragments: k-step kk (16 queries) is regs
    // [8 kk, 8 kk + 8). At d 64 the registers hold both pairs at once, so
    // dV += P^T dO runs while dS^T is formed; at d 128 it waits for it.
    uint32_t ph[16], pl[16], dh[16], dl[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_pair<F16>(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1],
                        ph[4 * kk + j], pl[4 * kk + j]);
    if constexpr (EARLY_DV) {
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(dva[p]);
      wg_fence();
      dv_products<NP, F16>(dva, ph, pl, o_addr);
      wg_commit();
      wg_wait1();                      // dP^T done, dV may still run
    } else {
      wg_wait0();
    }
    fence_regs(dp);
    // dS^T: 0 where P is (hidden keys) and on rows that see no key
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i >> 2) + 2 * cq + (i & 1);
      float ds = sc[i] * (dp[i] - s_d[s][c]);
      if (edge && causal && row0 + c + off < 0) ds = 0.0f;
      dp[i] = ds;
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_pair<F16>(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1],
                        dh[4 * kk + j], dl[4 * kk + j]);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      fence_regs(dka[p]);
      if constexpr (!EARLY_DV) fence_regs(dva[p]);
    }
    wg_fence();
    if constexpr (!EARLY_DV) dv_products<NP, F16>(dva, ph, pl, o_addr);
    // dK += dS^T Q: 16 query rows of panel p of Q a k-step, read transposed
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const uint64_t bq = make_desc(
            q_addr + p * QT * ROW_BYTES + kk * 16 * ROW_BYTES,
            QT * ROW_BYTES, 1024);
        wgmma_rs<F16>(dka[p], &dh[4 * kk], bq);
        wgmma_rs<F16>(dka[p], &dl[4 * kk], bq);
      }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      fence_regs(dka[p]);
      fence_regs(dva[p]);
    }
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k_lo + 8 * r;
    if (key >= Sk) continue;
    uint32_t* dkp = reinterpret_cast<uint32_t*>(
        static_cast<uint16_t*>(dk) + b * ldk.b + kvh * ldk.h + key * ldk.s);
    uint32_t* dvp = reinterpret_cast<uint32_t*>(
        static_cast<uint16_t*>(dv) + b * ldv.b + kvh * ldv.h + key * ldv.s);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int idx = (p * PANEL + 8 * j + 2 * cq) / 2;
        dkp[idx] = pack_out<F16>(dka[p][4 * j + 2 * r] * scale,
                                 dka[p][4 * j + 2 * r + 1] * scale);
        dvp[idx] = pack_out<F16>(dva[p][4 * j + 2 * r],
                                 dva[p][4 * j + 2 * r + 1]);
      }
  }
}

template <int D, int F16>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse, const float* __restrict__ dvec,
                 void* __restrict__ dq, Layout ldq, int H, int KV, int Sq,
                 int Sk, float scale, int causal) {
  constexpr int NP = D / PANEL;
  constexpr int Q_BYTES = QB * D * 2;
  constexpr int TILE_BYTES = KB * D * 2;          // one K (or V) tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES], qbar;

  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* sQ = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint8_t* sO = sQ + Q_BYTES;
  uint8_t* sK = sO + Q_BYTES;                     // [STAGES][TILE_BYTES]
  uint8_t* sV = sK + STAGES * TILE_BYTES;

  const int n_qt = (Sq + QB - 1) / QB;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int row0 = qt * QB, off = Sk - Sq;
  const int n_kt = (Sk + KB - 1) / KB;
  int n_it = n_kt;
  if (causal && row0 + off >= 0)     // every row sees key 0
    n_it = min(n_kt, (min(row0 + QB, Sq) - 1 + off) / KB + 1);
  const long long bh = static_cast<long long>(b) * H + h;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(&qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 32 == PRODUCER_WARP) {
    if (threadIdx.x == PRODUCER_WARP * 32) {
      mbar_expect_tx(&qbar, 2 * Q_BYTES);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tma_load_4d(sQ + p * QB * ROW_BYTES, &tq, &qbar, p * PANEL, row0, h,
                    b);
        tma_load_4d(sO + p * QB * ROW_BYTES, &tdo, &qbar, p * PANEL, row0, h,
                    b);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * TILE_BYTES);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load_4d(sK + s * TILE_BYTES + p * KB * ROW_BYTES, &tk, &full[s],
                      p * PANEL, it * KB, kvh, b);
          tma_load_4d(sV + s * TILE_BYTES + p * KB * ROW_BYTES, &tv, &full[s],
                      p * PANEL, it * KB, kvh, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows [row0 + 64 wg, +64)
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, cq = lane & 3;
  const int r_lo = row0 + wg * 64 + warp * 16 + g;   // and r_lo + 8
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    lse_r[r] = row < Sq ? lse[bh * Sq + row] * LOG2E : 0.0f;
    d_r[r] = row < Sq ? dvec[bh * Sq + row] : 0.0f;
  }
  const float scale2 = scale * LOG2E;
  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
  const uint32_t q_addr = smem_u32(sQ) + wg * 64 * ROW_BYTES;
  const uint32_t o_addr = smem_u32(sO) + wg * 64 * ROW_BYTES;

  mbar_wait(&qbar, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const uint32_t k_addr = smem_u32(sK + s * TILE_BYTES);
    const uint32_t v_addr = smem_u32(sV + s * TILE_BYTES);

    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.0f;
    fence_regs(sc);
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4, w = kk % 4;
      wgmma_ss<F16>(sc,
                    make_desc(q_addr + p * QB * ROW_BYTES + w * 32, 16, 1024),
                    make_desc(k_addr + p * KB * ROW_BYTES + w * 32, 16, 1024),
                    kk > 0 ? 1 : 0);
    }
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4, w = kk % 4;
      wgmma_ss<F16>(dp,
                    make_desc(o_addr + p * QB * ROW_BYTES + w * 32, 16, 1024),
                    make_desc(v_addr + p * KB * ROW_BYTES + w * 32, 16, 1024),
                    kk > 0 ? 1 : 0);
    }
    wg_commit();
    wg_wait1();                        // S done, dP may still run
    fence_regs(sc);

    // reg i holds row r_lo + 8 ((i >> 1) & 1), key col0 + 8 (i >> 2) +
    // 2 cq + (i & 1); a masked key (and every key of a row that sees
    // none) has dS = 0
    const int col0 = it * KB;
    const bool edge = col0 + KB > Sk || (causal && col0 + KB - 1 > r_lo + off);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      bool seen = true;
      if (edge) {
        const int row = r_lo + 8 * r;
        const int col = col0 + 8 * (i >> 2) + 2 * cq + (i & 1);
        seen = col < Sk && !(causal && col > row + off);
      }
      sc[i] = seen ? exp2_fast(fmaf(sc[i], scale2, -lse_r[r])) : 0.0f;
    }
    wg_wait0();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - d_r[(i >> 1) & 1]);
    uint32_t dh[16], dl[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        split_pair<F16>(dp[8 * kk + 2 * j], dp[8 * kk + 2 * j + 1],
                        dh[4 * kk + j], dl[4 * kk + j]);
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        // 16 keys of panel p of K, read transposed
        const uint64_t db = make_desc(
            k_addr + p * KB * ROW_BYTES + kk * 16 * ROW_BYTES,
            KB * ROW_BYTES, 1024);
        wgmma_rs<F16>(acc[p], &dh[4 * kk], db);
        wgmma_rs<F16>(acc[p], &dl[4 * kk], db);
      }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r_lo + 8 * r;
    if (row >= Sq) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        static_cast<uint16_t*>(dq) + b * ldq.b + h * ldq.h + row * ldq.s);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[(p * PANEL + 8 * j + 2 * cq) / 2] = pack_out<F16>(
            acc[p][4 * j + 2 * r] * scale, acc[p][4 * j + 2 * r + 1] * scale);
  }
}

// lay: q, k, v, o, dout, dq, dk, dv
template <int D, int F16>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dvec, void* dq,
           void* dk, void* dv, const Layout* lay, int B, int H, int KV,
           int Sq, int Sk, float scale, int causal, cudaStream_t s) {
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  if (!make_map(&q64, q, F16, D, Sq, H, B, lay[0], QT) ||
      !make_map(&do64, dout, F16, D, Sq, H, B, lay[4], QT) ||
      !make_map(&k128, k, F16, D, Sk, KV, B, lay[1], KT) ||
      !make_map(&v128, v, F16, D, Sk, KV, B, lay[2], KT) ||
      !make_map(&q128, q, F16, D, Sq, H, B, lay[0], QB) ||
      !make_map(&do128, dout, F16, D, Sq, H, B, lay[4], QB) ||
      !make_map(&k64, k, F16, D, Sk, KV, B, lay[1], KB) ||
      !make_map(&v64, v, F16, D, Sk, KV, B, lay[2], KB))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * H * Sq;
  fa_bwd_dot_kernel<F16><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                           s>>>(static_cast<const uint16_t*>(o),
                                static_cast<const uint16_t*>(dout), dvec,
                                lay[3], lay[4], H, Sq, rows, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const int smem_kv = 2 * KT * D * 2 + 2 * STAGES * QT * D * 2 + 1024;
  e = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<D, F16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_kv);
  if (e != cudaSuccess) return static_cast<int>(e);
  fa_bwd_dkdv_kernel<D, F16><<<dim3((Sk + KT - 1) / KT, KV, B), KV_THREADS,
                               smem_kv, s>>>(q64, k128, v128, do64, lse, dvec,
                                             dk, dv, lay[6], lay[7], H, KV,
                                             Sq, Sk, scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  const int smem_q = 2 * QB * D * 2 + 2 * STAGES * KB * D * 2 + 1024;
  e = cudaFuncSetAttribute(fa_bwd_dq_kernel<D, F16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_q);
  if (e != cudaSuccess) return static_cast<int>(e);
  fa_bwd_dq_kernel<D, F16><<<dim3((Sq + QB - 1) / QB, H, B), THREADS, smem_q,
                             s>>>(q128, k64, v64, do128, lse, dvec, dq,
                                  lay[5], H, KV, Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq [B, H, Sq, d], k, v, dk, dv [B, KV, Sk, d], one 16-bit
// dtype (1 = bf16, 2 = f16), d 64 or 128, H % KV == 0; each laid out by its
// three element strides in lay (batch, head, row: q, k, v, o, dout, dq, dk,
// dv in turn), as fa_wgmma_launch takes them; lse [B, H, Sq] f32 from
// fa_wgmma_launch. Writes dvec [B, H, Sq] (f32 scratch: D), dq, dk and dv
// in the input dtype, by three launches on the stream (D, then dK / dV,
// then dQ). Returns the first nonzero
// cudaError_t, or cudaErrorInvalidValue for a shape it does not take or a
// tensor map the encode call refuses.
extern "C" int fa_wgmma_bwd_launch(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dvec, void* dq, void* dk, void* dv,
                                   const long long* lay, int B, int H, int KV,
                                   int Sq, int Sk, int d, float scale,
                                   int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 1 && dtype != 2) || (d != 64 && d != 128) || KV < 1 ||
      H % KV != 0 || Sq < 1 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout L[8];
  for (int i = 0; i < 8; ++i) L[i] = {lay[3 * i], lay[3 * i + 1], lay[3 * i + 2]};
  const int f16 = dtype == 2;
  auto run = d == 64 ? (f16 ? launch<64, 1> : launch<64, 0>)
                     : (f16 ? launch<128, 1> : launch<128, 0>);
  return run(q, k, v, o, dout, static_cast<const float*>(lse),
             static_cast<float*>(dvec), dq, dk, dv, L, B, H, KV, Sq, Sk,
             scale, causal, s);
}
