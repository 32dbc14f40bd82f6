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
// - The tensor maps are 3-D ([heads][rows][d]) with 128-byte swizzle: a
//   box is 64 elements (128 bytes) by 64 or 128 rows, so d 128 comes in two
//   column panels. Rows past Sq or Sk read as zeros, never another head's.
//   The wgmma descriptors use the same 128-byte swizzle (8-row atoms of
//   1024 bytes, every panel 1024-aligned).
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
// GQA heads are not packed into one CTA: each query head re-reads its KV
// head's tiles (from L2).
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>

namespace {

constexpr int NWG = 2;                 // consumer warpgroups
constexpr int BQ = 64 * NWG;           // query rows per CTA
constexpr int BK = 64;                 // keys per tile
constexpr int STAGES = 2;              // K/V ring depth
constexpr int THREADS = 128 * (NWG + 1);
constexpr int PANEL = 64;              // elements of one 128-byte row
constexpr int ROW_BYTES = 128;
constexpr float MASKED = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin accumulator registers around the asynchronous wgmma: the compiler
// must not move their reads or writes across the fence / wait.
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define ACC_REGS                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"
#define ACC_OPS(d)                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T: A and B K-major in shared
// memory (descriptors), no transpose. scale_d 0 overwrites d.
#define WGMMA_SS(NAME, TY)                                                    \
  __device__ __forceinline__ void NAME(float (&d)[32], uint64_t da,           \
                                       uint64_t db, int scale_d) {            \
    asm volatile("{\n"                                                        \
                 ".reg .pred p;\n"                                            \
                 "setp.ne.b32 p, %34, 0;\n"                                   \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
                 ACC_REGS ", %32, %33, p, 1, 1, 0, 0;\n"                      \
                 "}\n"                                                        \
                 : ACC_OPS(d)                                                 \
                 : "l"(da), "l"(db), "r"(scale_d));                           \
  }
// d += A B: A [64 x 16] from registers (4 x 32-bit a thread), B from shared
// memory through its descriptor, MN-major (transposed, tnspB = 1).
#define WGMMA_RS(NAME, TY)                                                    \
  __device__ __forceinline__ void NAME(float (&d)[32], const uint32_t* a,     \
                                       uint64_t db) {                         \
    asm volatile("{\n"                                                        \
                 ".reg .pred p;\n"                                            \
                 "setp.ne.b32 p, %37, 0;\n"                                   \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
                 ACC_REGS ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"        \
                 "}\n"                                                        \
                 : ACC_OPS(d)                                                 \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),       \
                   "r"(1));                                                   \
  }

WGMMA_SS(wgmma_ss_bf16, "bf16")
WGMMA_SS(wgmma_ss_f16, "f16")
WGMMA_RS(wgmma_rs_bf16, "bf16")
WGMMA_RS(wgmma_rs_f16, "f16")

template <int F16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  if (F16)
    wgmma_ss_f16(d, da, db, scale_d);
  else
    wgmma_ss_bf16(d, da, db, scale_d);
}

template <int F16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  if (F16)
    wgmma_rs_f16(d, a, db);
  else
    wgmma_rs_bf16(d, a, db);
}

// (x0, x1) -> packed 16-bit pairs hi = fl16(x), lo = fl16(x - hi); the low
// half of each word holds x0 (the lower column)
template <int F16>
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  if (F16) {
    const __half2 h = __floats2half2_rn(x0, x1);
    const float2 hf = __half22float2(h);
    const __half2 l = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

template <int F16>
__device__ __forceinline__ uint32_t pack_out(float x0, float x1) {
  if (F16) {
    const __half2 h = __floats2half2_rn(x0, x1);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D, int F16>
__global__ void __launch_bounds__(THREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, void* __restrict__ o,
                float* __restrict__ part_o, float* __restrict__ part_ml,
                int B, int H, int KV, int Sq, int Sk, float scale, int causal,
                int n_split, int per) {
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
        tma_load_3d(sQ + p * BQ * ROW_BYTES, &tq, &qbar, p * PANEL, row0,
                    b * H + h);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * TILE_BYTES);
        const int key = (kt0 + it) * BK;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load_3d(sK + s * TILE_BYTES + p * BK * ROW_BYTES, &tk, &full[s],
                      p * PANEL, key, b * KV + kvh);
          tma_load_3d(sV + s * TILE_BYTES + p * BK * ROW_BYTES, &tv, &full[s],
                      p * PANEL, key, b * KV + kvh);
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
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          static_cast<uint16_t*>(o) + (bh * Sq + row) * D);
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found in the libcuda.so.1 that the CUDA runtime
// has loaded: no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h) fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// [heads][rows][d] 16-bit tensor -> boxes of 64 columns x box_rows rows,
// 128-byte swizzle, zero fill out of bounds
bool make_map(CUtensorMap* map, const void* ptr, int f16, int d, int rows,
              int heads, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(PANEL),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map,
            f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int F16>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, void* o, float* part_o, float* part_ml,
           int B, int H, int KV, int Sq, int Sk, float scale, int causal,
           int n_split, int per, cudaStream_t s) {
  const int smem = BQ * D * 2 + 2 * STAGES * BK * D * 2 + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      fa_wgmma_kernel<D, F16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(((Sq + BQ - 1) / BQ) * n_split, H, B);
  fa_wgmma_kernel<D, F16><<<grid, THREADS, smem, s>>>(
      tq, tk, tv, o, part_o, part_ml, B, H, KV, Sq, Sk, scale, causal,
      n_split, per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, Sq, d], k/v [B, KV, Sk, d]: contiguous, 16-byte aligned, one
// 16-bit dtype (1 = bf16, 2 = f16), d 64 or 128, H % KV == 0. With n_split
// 1 writes o [B, H, Sq, d]; else split s covers key tiles [s per, (s + 1)
// per) and writes part_o [n_split, B, H, Sq, d] and part_ml [n_split, B, H,
// Sq, 2] (f32) for fa_combine_launch. Returns the cudaError_t of the launch,
// or cudaErrorInvalidValue for a shape it does not take or a tensor map the
// encode call refuses.
extern "C" int fa_wgmma_launch(const void* q, const void* k, const void* v,
                               void* o, void* part_o, void* part_ml, int B,
                               int H, int KV, int Sq, int Sk, int d,
                               float scale, int causal, int dtype,
                               int n_split, int per, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dtype != 1 && dtype != 2) || (d != 64 && d != 128) || n_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int f16 = dtype == 2;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, f16, d, Sq, B * H, BQ) ||
      !make_map(&tk, k, f16, d, Sk, B * KV, BK) ||
      !make_map(&tv, v, f16, d, Sk, B * KV, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  if (d == 64)
    return f16 ? launch<64, 1>(tq, tk, tv, o, po, pml, B, H, KV, Sq, Sk,
                               scale, causal, n_split, per, s)
               : launch<64, 0>(tq, tk, tv, o, po, pml, B, H, KV, Sq, Sk,
                               scale, causal, n_split, per, s);
  return f16 ? launch<128, 1>(tq, tk, tv, o, po, pml, B, H, KV, Sq, Sk, scale,
                              causal, n_split, per, s)
             : launch<128, 0>(tq, tk, tv, o, po, pml, B, H, KV, Sq, Sk, scale,
                              causal, n_split, per, s);
}
