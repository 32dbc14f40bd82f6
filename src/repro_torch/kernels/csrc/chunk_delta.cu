// Chunk fingerprint (+ fused changed-mask) over a checkpoint leaf, and the
// stand-alone changed mask of two digest arrays.
//
// Replaces src/repro/kernels/chunk_delta.py: fingerprint_pallas
// (_fingerprint_kernel), fingerprint_changed_pallas (_fp_changed_kernel) and
// changed_mask_pallas (_changed_kernel).
//
// The leaf is read in place as a flat word stream: word k is the k-th
// 4-, 2- or 1-byte unit of its bytes (bpw), zero-extended to 32 bits, the
// same view kernels/ops.py::_as_u32_blocks builds for the plain version.
// Row g covers words [g*B, (g+1)*B); words at or past n_words are the zero
// padding of the last chunk and of the rows that round G up to a multiple of
// 8, folded in without ever being stored. Per row:
//     v_j = (w_j ^ j*P1) * P2,   d0 = xor_j v_j,   d1 = sum_j v_j*P3  (mod 2^32)
// and, for the fused variant, mask = (d0,d1) != prev.
//
// Bound: bytes. Every word is read once and costs a handful of integer ops,
// far below the card's integer rate, so the kernel can at best stream the
// leaf at memory bandwidth. Design: one block of 256 threads per row (G
// blocks: thousands for the large leaves, enough to fill 132 SMs); threads
// stride the row with coalesced loads (16-byte vector loads for aligned
// 4-byte rows fully in range); xor and add reduce by warp shuffles, then
// across the 8 warps in shared memory. Both reductions are associative mod
// 2^32, so the split-row order gives the exact digest of the serial loop.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t P1 = 2654435761u;
constexpr uint32_t P2 = 2246822519u;
constexpr uint32_t P3 = 3266489917u;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <int BPW>
__device__ __forceinline__ uint32_t load_word(const void* src, long long k) {
  if (BPW == 4) return __ldg(static_cast<const unsigned int*>(src) + k);
  if (BPW == 2) return __ldg(static_cast<const unsigned short*>(src) + k);
  return __ldg(static_cast<const unsigned char*>(src) + k);
}

__device__ __forceinline__ void mix(uint32_t w, uint32_t j, uint32_t& x0,
                                    uint32_t& x1) {
  const uint32_t v = (w ^ (j * P1)) * P2;
  x0 ^= v;
  x1 += v * P3;
}

template <int BPW, bool CMP>
__global__ void __launch_bounds__(THREADS)
fp_kernel(const void* __restrict__ src, long long n_words, int B,
          const int32_t* __restrict__ prev, int32_t* __restrict__ digest,
          int32_t* __restrict__ mask) {
  const int g = blockIdx.x;
  const long long base = static_cast<long long>(g) * B;
  uint32_t x0 = 0u, x1 = 0u;
  const bool full_row = base + B <= n_words;
  const bool vec = BPW == 4 && full_row && (B % 4) == 0 &&
      (reinterpret_cast<uintptr_t>(static_cast<const unsigned int*>(src) +
                                   base) % 16) == 0;
  if (vec) {
    const uint4* row = reinterpret_cast<const uint4*>(
        static_cast<const unsigned int*>(src) + base);
    for (int q = threadIdx.x; q < B / 4; q += THREADS) {
      const uint4 w = __ldg(row + q);
      const uint32_t j = 4u * q;
      mix(w.x, j, x0, x1);
      mix(w.y, j + 1u, x0, x1);
      mix(w.z, j + 2u, x0, x1);
      mix(w.w, j + 3u, x0, x1);
    }
  } else if (full_row) {
    for (int j = threadIdx.x; j < B; j += THREADS)
      mix(load_word<BPW>(src, base + j), j, x0, x1);
  } else {
    for (int j = threadIdx.x; j < B; j += THREADS) {
      const long long k = base + j;
      mix(k < n_words ? load_word<BPW>(src, k) : 0u, j, x0, x1);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x0 ^= __shfl_xor_sync(0xffffffffu, x0, o);
    x1 += __shfl_xor_sync(0xffffffffu, x1, o);
  }
  __shared__ uint32_t s0[WARPS], s1[WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    s0[warp] = x0;
    s1[warp] = x1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t d0 = 0u, d1 = 0u;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      d0 ^= s0[w];
      d1 += s1[w];
    }
    digest[2 * g] = static_cast<int32_t>(d0);
    digest[2 * g + 1] = static_cast<int32_t>(d1);
    if (CMP)
      mask[g] = (d0 != static_cast<uint32_t>(prev[2 * g]) ||
                 d1 != static_cast<uint32_t>(prev[2 * g + 1])) ? 1 : 0;
  }
}

// mask[g] = any(digest[g, :] != prev[g, :]) as int32, one thread per row.
// Bound: bytes (16 read and 4 written per row); the digests are int32 bit
// patterns, compared as the u32 words they are.
__global__ void changed_kernel(const int2* __restrict__ digest,
                               const int2* __restrict__ prev, int G,
                               int32_t* __restrict__ mask) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= G) return;
  const int2 d = digest[g], p = prev[g];
  mask[g] = (d.x != p.x || d.y != p.y) ? 1 : 0;
}

template <int BPW>
void launch(const void* src, long long n_words, int B, int G,
            const int32_t* prev, int32_t* digest, int32_t* mask,
            cudaStream_t s) {
  if (prev != nullptr)
    fp_kernel<BPW, true><<<G, THREADS, 0, s>>>(src, n_words, B, prev, digest,
                                              mask);
  else
    fp_kernel<BPW, false><<<G, THREADS, 0, s>>>(src, n_words, B, nullptr,
                                               digest, nullptr);
}

}  // namespace

// digest: int32 [G, 2]; prev/mask: int32 [G, 2] / [G] for the fused
// variant, both null for the plain fingerprint. Returns cudaGetLastError().
extern "C" int fp_launch(const void* src, long long n_words, int bpw, int B,
                         int G, const void* prev, void* digest, void* mask,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* p = static_cast<const int32_t*>(prev);
  int32_t* d = static_cast<int32_t*>(digest);
  int32_t* m = static_cast<int32_t*>(mask);
  if (bpw == 4)
    launch<4>(src, n_words, B, G, p, d, m, s);
  else if (bpw == 2)
    launch<2>(src, n_words, B, G, p, d, m, s);
  else if (bpw == 1)
    launch<1>(src, n_words, B, G, p, d, m, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// digest/prev: int32 [G, 2] (8-byte aligned rows); mask: int32 [G].
// Returns cudaGetLastError().
extern "C" int cm_launch(const void* digest, const void* prev, int G,
                         void* mask, void* stream) {
  if (G > 0)
    changed_kernel<<<(G + THREADS - 1) / THREADS, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int2*>(digest), static_cast<const int2*>(prev), G,
        static_cast<int32_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}
