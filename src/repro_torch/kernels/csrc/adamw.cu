// AdamW over every leaf of a train step in two multi-tensor passes, with
// the global-norm clip folded in.
//
// No TPU kernel: the reference package runs AdamW as XLA's fused
// elementwise ops (src/repro/train/optimizer.py). The plain version is
// train/optimizer.py's per-leaf chain of torch ops, which these kernels
// reproduce bit for bit given the same clip scale.
//
//   sq_kernel    sum of squares: each block reads one chunk of one gradient
//                leaf (f32 or bf16) and writes its f64 partial sum.
//   fin_kernel   one block sums the partials in a fixed order and writes the
//                norm gn = sqrt(sum) (f32) and the clip scale
//                min(max_norm / max(gn, 1e-9), 1), as clip_by_global_norm.
//   upd_kernel   one pass over every leaf's elements: reads g, p, m and v,
//                writes p', m' and v' into NEW buffers (the update is
//                functional: an old state's bytes stay as they were).
//
// Bound: bytes. Per parameter the norm reads the gradient once (4 B in
// f32) and the update reads g, p, m, v and writes p', m', v' (28 B): 32 B a
// parameter, where the per-leaf torch chain moves ~180 B.
//
// Design. Leaves go in by a table passed as a __grid_constant__ kernel
// parameter (at most SQ_MAX / UPD_MAX leaves a launch; no host-to-device
// copy of metadata, no sync). Each leaf is cut into CHUNK-element chunks,
// one block each; a block finds its leaf by binary search over the table's
// cumulative block counts. A leaf whose buffers are all 16-byte aligned is
// read in vector accesses (`seg`: a float4 of f32, 8 or 16 bytes of bf16),
// each warp's run of them at consecutive addresses: VEC elements a thread at
// a time in the update, SQ_VEC in the norm. What a chunk leaves past its
// last whole run (only a leaf's last chunk: CHUNK is a multiple of both
// runs), and an unaligned leaf, go element by element.
//
// Determinism: no float atomics. The split of leaves into blocks depends on
// the leaf sizes alone, each block reduces in a fixed order, and the finish
// kernel sums the partials in a fixed order, so two calls give the same
// bits. The norm accumulates squares in f64 (within ~1e-7 of an exact sum).
//
// Arithmetic of the update (f32, in the plain path's order, each product
// and sum rounded on its own: __fmul_rn / __fadd_rn are never contracted
// into an FMA, as the plain path's separate kernels are not):
//   gs  = scale ? round_P(g * scale) : g      (the clip; round to g's dtype)
//   m'  = b1 * m + (1 - b1) * gs
//   v'  = b2 * v + (1 - b2) * (gs * gs)
//   u   = (m' / c1) / (sqrt(v' / c2) + eps)   (c1, c2: bias corrections)
//   u  += wd * p                              (leaves with decay only)
//   p'  = p - lr * u
// p' is rounded to p's dtype and m', v' to the moments' dtype, bf16 by
// round-to-nearest-even as torch's .to() does. scale, lr, c1 and c2 are
// f32 device scalars: the host never reads them.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;                  // elements a thread updates at once
constexpr int SQ_VEC = 16;              // elements a thread squares at once
constexpr long long CHUNK = 16384;      // elements a block
constexpr int SQ_MAX = 128;             // leaves a sum-of-squares launch
constexpr int UPD_MAX = 48;             // leaves an update launch
constexpr int FIN_THREADS = 1024;

// flags of a leaf
constexpr int F_BF16 = 1;               // sum of squares: the leaf is bf16
constexpr int F_DECAY = 1;              // update: weight decay on the leaf
constexpr int F_ALIGNED = 2;            // every buffer 16-byte aligned

// Both tables stay under the 4 KiB of a kernel's parameters.
struct SqTable {
  const void* g[SQ_MAX];
  long long n[SQ_MAX];
  int block_end[SQ_MAX];                // blocks of leaves 0..i
  int flags[SQ_MAX];
  int count;
};

struct UpdTable {
  const void* g[UPD_MAX];
  const void* p[UPD_MAX];
  const void* m[UPD_MAX];
  const void* v[UPD_MAX];
  void* po[UPD_MAX];
  void* mo[UPD_MAX];
  void* vo[UPD_MAX];
  long long n[UPD_MAX];
  int block_end[UPD_MAX];
  int flags[UPD_MAX];
  int count;
};

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;    // omb = 1 - b, rounded from double
};

// The leaf that block b works on: the first i with b < block_end[i].
template <int MAX>
__device__ __forceinline__ int find_leaf(const int (&block_end)[MAX],
                                         int count, int b) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b < block_end[mid])
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

__device__ __forceinline__ float bf2f(uint32_t h) {
  return __uint_as_float(h << 16);
}

__device__ __forceinline__ uint32_t f2bf(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// Every global access of the kernels: read-only loads, plain stores.
template <typename T>
__device__ __forceinline__ T ld(const T* p) { return __ldg(p); }
template <typename T>
__device__ __forceinline__ void st(T* p, const T& x) { *p = x; }

// Loads and stores of f32 (F32) and bf16 (BF16) buffers, in f32: SEG
// consecutive elements at element i (aligned to SEG elements), by one vector
// access (f32: 4 a float4; bf16: 4 a uint2, 8 a uint4), or one element.
struct F32 {
  static constexpr int kBytes = 4;
  template <int SEG>
  static __device__ __forceinline__ void load(const void* base, long long i,
                                              float* x) {
    static_assert(SEG == 4, "f32 segments are one float4");
    const float4 a = ld(
        reinterpret_cast<const float4*>(static_cast<const float*>(base) + i));
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  }
  template <int SEG>
  static __device__ __forceinline__ void store(void* base, long long i,
                                               const float* x) {
    static_assert(SEG == 4, "f32 segments are one float4");
    st(reinterpret_cast<float4*>(static_cast<float*>(base) + i),
       make_float4(x[0], x[1], x[2], x[3]));
  }
  static __device__ __forceinline__ float load1(const void* base,
                                                long long i) {
    return ld(static_cast<const float*>(base) + i);
  }
  static __device__ __forceinline__ void store1(void* base, long long i,
                                                float x) {
    st(static_cast<float*>(base) + i, x);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

struct BF16 {
  static constexpr int kBytes = 2;
  template <int SEG>
  static __device__ __forceinline__ void load(const void* base, long long i,
                                              float* x) {
    static_assert(SEG == 4 || SEG == 8, "bf16 segments are 8 or 16 bytes");
    const uint16_t* q = static_cast<const uint16_t*>(base) + i;
    if (SEG == 8) {
      const uint4 w = ld(reinterpret_cast<const uint4*>(q));
      x[0] = bf2f(w.x & 0xFFFFu); x[1] = bf2f(w.x >> 16);
      x[2] = bf2f(w.y & 0xFFFFu); x[3] = bf2f(w.y >> 16);
      x[4] = bf2f(w.z & 0xFFFFu); x[5] = bf2f(w.z >> 16);
      x[6] = bf2f(w.w & 0xFFFFu); x[7] = bf2f(w.w >> 16);
    } else {
      const uint2 w = ld(reinterpret_cast<const uint2*>(q));
      x[0] = bf2f(w.x & 0xFFFFu); x[1] = bf2f(w.x >> 16);
      x[2] = bf2f(w.y & 0xFFFFu); x[3] = bf2f(w.y >> 16);
    }
  }
  template <int SEG>
  static __device__ __forceinline__ void store(void* base, long long i,
                                               const float* x) {
    static_assert(SEG == 4 || SEG == 8, "bf16 segments are 8 or 16 bytes");
    uint16_t* q = static_cast<uint16_t*>(base) + i;
    if (SEG == 8) {
      uint4 w;
      w.x = f2bf(x[0]) | (f2bf(x[1]) << 16);
      w.y = f2bf(x[2]) | (f2bf(x[3]) << 16);
      w.z = f2bf(x[4]) | (f2bf(x[5]) << 16);
      w.w = f2bf(x[6]) | (f2bf(x[7]) << 16);
      st(reinterpret_cast<uint4*>(q), w);
    } else {
      uint2 w;
      w.x = f2bf(x[0]) | (f2bf(x[1]) << 16);
      w.y = f2bf(x[2]) | (f2bf(x[3]) << 16);
      st(reinterpret_cast<uint2*>(q), w);
    }
  }
  static __device__ __forceinline__ float load1(const void* base,
                                                long long i) {
    return bf2f(ld(static_cast<const unsigned short*>(base) + i));
  }
  static __device__ __forceinline__ void store1(void* base, long long i,
                                                float x) {
    st(static_cast<unsigned short*>(base) + i,
       static_cast<unsigned short>(f2bf(x)));
  }
  static __device__ __forceinline__ float round(float x) {
    return bf2f(f2bf(x));
  }
};

// Elements of one vector access of every buffer of a leaf: 8 (16 bytes)
// where all are bf16, else 4 (a float4 of f32, 8 bytes of bf16). A warp's
// accesses are consecutive: lane l reads segment l of the warp's run.
template <typename A, typename B = A>
__host__ __device__ constexpr int seg() {
  return (A::kBytes == 2 && B::kBytes == 2) ? 8 : 4;
}

// Sum over a block of one double per thread, in a fixed order; the result
// is valid in thread 0.
template <int NT>
__device__ __forceinline__ double block_sum(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  __shared__ double part[NT / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += part[w];
  }
  return s;
}

// Sum of squares of elements [lo, hi) of one leaf in f64: SQ_VEC elements
// a thread at a time in warp-consecutive segments where the leaf is aligned,
// then the rest element by element.
template <typename G>
__device__ __forceinline__ double chunk_sumsq(const void* g, long long lo,
                                              long long hi, bool aligned) {
  constexpr int SEG = seg<G>();
  constexpr int STEP = SQ_VEC * THREADS;
  double acc = 0.0;
  long long e0 = lo;
  if (aligned) {
    for (; e0 + STEP <= hi; e0 += STEP) {
      float x[SQ_VEC];
#pragma unroll
      for (int s = 0; s < SQ_VEC / SEG; ++s)
        G::template load<SEG>(g, e0 + (s * THREADS + threadIdx.x) * SEG,
                              x + s * SEG);
#pragma unroll
      for (int j = 0; j < SQ_VEC; ++j) {
        const double d = static_cast<double>(x[j]);
        acc = fma(d, d, acc);
      }
    }
  }
  for (long long e = e0 + threadIdx.x; e < hi; e += THREADS) {
    const double d = static_cast<double>(G::load1(g, e));
    acc = fma(d, d, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
sq_kernel(const __grid_constant__ SqTable t, double* __restrict__ partial) {
  const int b = blockIdx.x;
  const int i = find_leaf(t.block_end, t.count, b);
  const int first = i ? t.block_end[i - 1] : 0;
  const long long lo = static_cast<long long>(b - first) * CHUNK;
  const long long hi = min(lo + CHUNK, t.n[i]);
  const bool aligned = (t.flags[i] & F_ALIGNED) != 0;
  const double acc = (t.flags[i] & F_BF16)
      ? chunk_sumsq<BF16>(t.g[i], lo, hi, aligned)
      : chunk_sumsq<F32>(t.g[i], lo, hi, aligned);
  const double s = block_sum<THREADS>(acc);
  if (threadIdx.x == 0) partial[b] = s;
}

__global__ void __launch_bounds__(FIN_THREADS)
fin_kernel(const double* __restrict__ partial, long long count,
           float max_norm, float* __restrict__ gn_out,
           float* __restrict__ scale_out) {
  double acc = 0.0;
  for (long long k = threadIdx.x; k < count; k += FIN_THREADS)
    acc += partial[k];
  const double s = block_sum<FIN_THREADS>(acc);
  if (threadIdx.x != 0) return;
  const float gn = static_cast<float>(sqrt(s));
  *gn_out = gn;
  if (scale_out != nullptr) {
    // torch: clamp(max_norm / clamp_min(gn, 1e-9), max=1), where a number
    // over a tensor is the tensor's reciprocal times the number; clamp
    // passes NaN through
    const float c = isnan(gn) ? gn : fmaxf(gn, 1e-9f);
    const float r = __fmul_rn(__fdiv_rn(1.0f, c), max_norm);
    *scale_out = isnan(r) ? r : fminf(r, 1.0f);
  }
}

// One element of the update; see the head of the file.
template <typename P>
__device__ __forceinline__ void adamw1(float g, float& p, float& m, float& v,
                                       bool decay, bool clip, float sc,
                                       float lr, float c1, float c2,
                                       const Hyper& h) {
  const float gs = clip ? P::round(__fmul_rn(g, sc)) : g;
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, gs));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(gs, gs)));
  float u = __fdiv_rn(__fdiv_rn(m, c1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), h.eps));
  if (decay) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, u));
}

template <typename P, typename M>
__global__ void __launch_bounds__(THREADS)
upd_kernel(const __grid_constant__ UpdTable t, const float* __restrict__ scale,
           const float* __restrict__ lr_p, const float* __restrict__ c1_p,
           const float* __restrict__ c2_p, const Hyper h) {
  const int b = blockIdx.x;
  const int i = find_leaf(t.block_end, t.count, b);
  const int first = i ? t.block_end[i - 1] : 0;
  const long long lo = static_cast<long long>(b - first) * CHUNK;
  const long long hi = min(lo + CHUNK, t.n[i]);
  const bool clip = scale != nullptr;
  const float sc = clip ? *scale : 1.0f;
  const float lr = *lr_p, c1 = *c1_p, c2 = *c2_p;
  const bool decay = (t.flags[i] & F_DECAY) != 0;
  const void *g = t.g[i], *p = t.p[i], *m = t.m[i], *v = t.v[i];
  void *po = t.po[i], *mo = t.mo[i], *vo = t.vo[i];
  constexpr int SEG = seg<P, M>();
  constexpr int STEP = VEC * THREADS;
  long long e0 = lo;
  if (t.flags[i] & F_ALIGNED) {
    for (; e0 + STEP <= hi; e0 += STEP) {
      float gg[VEC], pp[VEC], mm[VEC], vv[VEC];
#pragma unroll
      for (int s = 0; s < VEC / SEG; ++s) {
        const long long e = e0 + (s * THREADS + threadIdx.x) * SEG;
        P::template load<SEG>(g, e, gg + s * SEG);
        P::template load<SEG>(p, e, pp + s * SEG);
        M::template load<SEG>(m, e, mm + s * SEG);
        M::template load<SEG>(v, e, vv + s * SEG);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        adamw1<P>(gg[j], pp[j], mm[j], vv[j], decay, clip, sc, lr, c1, c2, h);
#pragma unroll
      for (int s = 0; s < VEC / SEG; ++s) {
        const long long e = e0 + (s * THREADS + threadIdx.x) * SEG;
        P::template store<SEG>(po, e, pp + s * SEG);
        M::template store<SEG>(mo, e, mm + s * SEG);
        M::template store<SEG>(vo, e, vv + s * SEG);
      }
    }
  }
  for (long long e = e0 + threadIdx.x; e < hi; e += THREADS) {
    float pp = P::load1(p, e), mm = M::load1(m, e), vv = M::load1(v, e);
    adamw1<P>(P::load1(g, e), pp, mm, vv, decay, clip, sc, lr, c1, c2, h);
    P::store1(po, e, pp);
    M::store1(mo, e, mm);
    M::store1(vo, e, vv);
  }
}

// Fills block_end from the sizes; returns the blocks of the launch, or -1
// when a leaf would overflow the int block index.
template <int MAX>
long long plan_blocks(int count, const long long* numels, int (&block_end)[MAX]) {
  long long total = 0;
  for (int i = 0; i < count; ++i) {
    total += (numels[i] + CHUNK - 1) / CHUNK;
    if (total > 0x7fffffffLL) return -1;
    block_end[i] = static_cast<int>(total);
  }
  return total;
}

template <typename P, typename M>
void launch_upd(const UpdTable& t, unsigned blocks, const float* scale,
                const float* lr, const float* c1, const float* c2,
                const Hyper& h, cudaStream_t s) {
  upd_kernel<P, M><<<blocks, THREADS, 0, s>>>(t, scale, lr, c1, c2, h);
}

}  // namespace

// Sums of squares of `count` (<= SQ_MAX) gradient leaves: ptrs / numels /
// flags (F_BF16, F_ALIGNED) one per leaf; partial: f64, one per block
// (ceil(numel / CHUNK) a leaf, in leaf order). Returns cudaGetLastError().
extern "C" int adamw_sumsq_launch(int count, const long long* ptrs,
                                  const long long* numels, const int* flags,
                                  void* partial, void* stream) {
  if (count < 1 || count > SQ_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  SqTable t;
  t.count = count;
  for (int i = 0; i < count; ++i) {
    t.g[i] = reinterpret_cast<const void*>(ptrs[i]);
    t.n[i] = numels[i];
    t.flags[i] = flags[i];
  }
  for (int i = count; i < SQ_MAX; ++i) {
    t.g[i] = nullptr;
    t.n[i] = 0;
    t.flags[i] = 0;
  }
  const long long blocks = plan_blocks(count, numels, t.block_end);
  for (int i = count; i < SQ_MAX; ++i) t.block_end[i] = 0;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  sq_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
              static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<double*>(partial));
  return static_cast<int>(cudaGetLastError());
}

// gn = sqrt(sum of `count` f64 partials) into gn (f32 scalar); with a
// non-null scale (f32 scalar), the clip scale for max_norm.
extern "C" int adamw_finish_launch(const void* partial, long long count,
                                   float max_norm, void* gn, void* scale,
                                   void* stream) {
  fin_kernel<<<1, FIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partial), count, max_norm,
      static_cast<float*>(gn), static_cast<float*>(scale));
  return static_cast<int>(cudaGetLastError());
}

// AdamW over `count` (<= UPD_MAX) leaves whose parameters are of dtype
// pcode and moments of mcode (0 f32, 1 bf16): ptrs holds 7 addresses a
// leaf (g, p, m, v, p', m', v'), numels and flags (F_DECAY, F_ALIGNED) one
// a leaf; scale (null: no clip), lr, c1, c2: f32 device scalars.
// Returns cudaGetLastError().
extern "C" int adamw_update_launch(int pcode, int mcode, int count,
                                   const long long* ptrs,
                                   const long long* numels, const int* flags,
                                   const void* scale, const void* lr,
                                   const void* c1, const void* c2, float b1,
                                   float omb1, float b2, float omb2,
                                   float eps, float wd, void* stream) {
  if (count < 1 || count > UPD_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  UpdTable t;
  t.count = count;
  for (int i = 0; i < UPD_MAX; ++i) {
    const bool live = i < count;
    t.g[i] = live ? reinterpret_cast<const void*>(ptrs[7 * i]) : nullptr;
    t.p[i] = live ? reinterpret_cast<const void*>(ptrs[7 * i + 1]) : nullptr;
    t.m[i] = live ? reinterpret_cast<const void*>(ptrs[7 * i + 2]) : nullptr;
    t.v[i] = live ? reinterpret_cast<const void*>(ptrs[7 * i + 3]) : nullptr;
    t.po[i] = live ? reinterpret_cast<void*>(ptrs[7 * i + 4]) : nullptr;
    t.mo[i] = live ? reinterpret_cast<void*>(ptrs[7 * i + 5]) : nullptr;
    t.vo[i] = live ? reinterpret_cast<void*>(ptrs[7 * i + 6]) : nullptr;
    t.n[i] = live ? numels[i] : 0;
    t.flags[i] = live ? flags[i] : 0;
    t.block_end[i] = 0;
  }
  const long long blocks = plan_blocks(count, numels, t.block_end);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  const float* sc = static_cast<const float*>(scale);
  const float* l = static_cast<const float*>(lr);
  const float* a = static_cast<const float*>(c1);
  const float* c = static_cast<const float*>(c2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  if (pcode == 0 && mcode == 0)
    launch_upd<F32, F32>(t, nb, sc, l, a, c, h, s);
  else if (pcode == 0 && mcode == 1)
    launch_upd<F32, BF16>(t, nb, sc, l, a, c, h, s);
  else if (pcode == 1 && mcode == 0)
    launch_upd<BF16, F32>(t, nb, sc, l, a, c, h, s);
  else if (pcode == 1 && mcode == 1)
    launch_upd<BF16, BF16>(t, nb, sc, l, a, c, h, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
