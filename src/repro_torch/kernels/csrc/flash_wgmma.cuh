// Shared pieces of the Hopper flash-attention kernels (flash_wgmma.cu, the
// forward, and flash_wgmma_bwd.cu, the backward): mbarriers, TMA loads of
// [heads][rows][d] 16-bit tensors with 128-byte swizzle, wgmma m64n64k16
// with f32 accumulators (A and B from shared memory, or A from registers
// and B transposed), the hi + lo split of an f32 pair into 16-bit values,
// and the tensor maps. Each source that includes it is its own library.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>

namespace {

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

// element strides of a [B, H, rows, d] tensor whose head dim is contiguous:
// [B, H, rows, d] itself, or the model's [B, rows, H, d] seen through a
// transpose
struct Layout {
  long long b, h, s;
};

// one box (col, row, head, batch) of a tensor map from make_map
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row,
                                            int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(head), "r"(batch)
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
// wait until at most the last committed wgmma group is still running
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
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

// [B, H, rows, d] 16-bit tensor laid out by L -> boxes of 64 columns x
// box_rows rows of one (batch, head), 128-byte swizzle, zero fill out of
// bounds (rows past the end read as zeros, never another head's)
bool make_map(CUtensorMap* map, const void* ptr, int f16, int d, int rows,
              int heads, int batch, Layout L, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
      static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(L.s) * 2,
                                 static_cast<cuuint64_t>(L.h) * 2,
                                 static_cast<cuuint64_t>(L.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(PANEL),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map,
            f16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
