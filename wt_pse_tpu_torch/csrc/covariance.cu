// Per-sample feature covariance for the whitening losses, written by hand for
// Hopper (sm_90a). Built by ops/covariance_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C entry points at the end of this file).
//
// Input: the NCHW map the port's convs emit, viewed as z (B, C, HW), C <= 32,
// rows contiguous, of element type T: f32, or bf16 in the bf16 training mode
// (one template a kernel, instantiated for both). bf16 values are widened
// exactly to f32 as they are read (as _to_bkc widens them before the Pallas
// kernels, whitening_pallas.py:130-132). IEEE f32 FFMA throughout (no TF32, no
// tensor cores, no bf16 arithmetic, as the HIGHEST pins of the JAX kernels), and
// no floating-point atomics: every sum is taken in a fixed order, so two calls
// give bitwise equal results. A bf16 x bf16 product is exact in f32, so the bf16
// Gram differs from the f32 Gram of the same values only by summation order.
//
// The Gram (replaces _gram / _gram_kernel in wt_pse_tpu/ops/whitening_pallas.py:45-89,
// with _fwd_impl's scaling at 135-138):
//   cov[b] = z[b] z[b]^T / (HW - 1) + 1e-5 I
// It reads 37.7 MB at the main-path shape (B=9, C=16, HW=65536) and does 80 M
// FMA: 11.3 us of HBM at 3.35 TB/s against 2.4 us of f32 FMA at 67 TFLOP/s, so
// it is bound by bytes. The design keeps bytes in flight and everything else
// off the critical path. (A thread for each (c, d) pair, with two scalar shared
// loads an FMA, is bound by shared-memory loads instead.)
//  - Threads own pixels, not (c, d) pairs. For C = 16 (gram_tri_kernel) a
//    thread reads the 16 channel values of its pixel once from shared memory
//    and adds the 136 upper-triangle products into registers: 16 shared loads
//    per 136 FMA. Any other C (gram_rows_kernel) gives lane c of a warp row c
//    of the Gram; the warp reads each pixel's column as broadcasts.
//  - The tiles (16 channel rows x 256 pixels, 16 KB) arrive in a 4-stage ring
//    in dynamic shared memory by bulk copies (cp.async.bulk, the copy engine
//    behind TMA, without a tensor map): thread 0 starts one 1 KB copy a row,
//    and the stage's mbarrier counts the bytes in. Three tiles stay in flight
//    while the fourth is reduced, with no registers spent on the copies. The
//    tail tile is masked in the reduction. When HW % 4 != 0 or z is not 16-byte
//    aligned, the same kernel stages by 4-byte cp.async with zero fill instead.
//  - One wave: each sample is cut into as many chunks of whole tiles as the
//    card holds resident blocks / B (3 blocks of 128 threads an SM, 162
//    registers; 387 blocks at the main shape), one block a (chunk, sample).
//    (More, shorter chunks timed slower: more partials, a longer finish.) The
//    device's resident-block count is queried once and cached. A block
//    reduces its 136 sums across the warp by recursive halving (each step
//    sends half of the values: 155 shuffles instead of 5 x 136), then across
//    warps in shared memory in a fixed order, and writes one partial C x C.
//  - gram_finish_kernel adds a sample's partials in a fixed order and applies
//    / (HW - 1) + 1e-5 I. It is launched as a programmatic dependent launch,
//    so it is scheduled while the partials are made and waits for them
//    (griddepcontrol), which hides its launch. (A finish in the same launch,
//    by the last block of each sample to write its partial, was slower on an
//    H100 with the L2 full of dirty lines, as the training step leaves it;
//    PERF.md has the times.)
//  - What bounds it now is the rate at which the card streams z in: on an
//    H100 the call takes about as long as torch's own z.sum() on the same
//    bytes, below the 3.35 TB/s of the bound. With the L2 full of dirty lines,
//    as the training step leaves it, each line it reads in also writes one
//    back, and the call takes about 4 us more.
//  - bf16: the same kernels read half the bytes (18.9 MB, a 5.6 us bound) for
//    the same 80 M FMA (2.4 us at the f32 rate), so the bound stays bytes but
//    by less; the unpacking (a shift a value) adds to the FMA stream. The tile
//    keeps 256 pixels (8 KB a stage), so the chunk plan is the f32 one. A tile
//    row is 16 bytes a copy when HW % 8 == 0 (8 bf16 values); otherwise the
//    narrow variant stages with plain 2-byte loads (cp.async copies no fewer
//    than 4 bytes, and an odd bf16 index is not 4-byte aligned).
//
// dz (replaces _dz / _dz_kernel, whitening_pallas.py:92-120, called from _bwd at
// 145-149):
//   dz[b] = S[b] z[b],  S[b] = (g[b] + g[b]^T) / (HW - 1)
// It reads 37.7 MB and writes 37.7 MB: 22.5 us of HBM, against 1.2 us of FMA.
//  - A thread takes 4 consecutive pixels: one float4 load per channel row and
//    one float4 store per output row (16-byte accesses, C = 16 specialised by a
//    template; any other C is an instantiation of the same kernel).
//  - S is built once per block and sample from the 1 KB of g into shared
//    memory and read as float4 broadcasts: each S value serves 4 pixels.
//  - One item a thread and 256 threads a block: 576 short blocks at the main
//    shape, which the card schedules as others finish. (One wave of resident
//    blocks that loop over 2.2 items a thread timed slower: its last round
//    runs with a fifth of the threads.)
//    A scalar variant (one pixel a thread) of the same kernel takes HW % 4 != 0
//    or an unaligned z or dz.
//  - bf16 (18.9 MB read, 18.9 MB written: an 11.3 us bound): an item is the 16
//    bytes of 8 pixels. The loads stay packed in registers (4 words a channel
//    row, as the f32 float4) and are widened a value at a time; the 8 f32 sums
//    of an output row are rounded once to bf16 (nearest even) on the store, as
//    _bwd casts the f32 dz to z.dtype (whitening_pallas.py:149). HW % 8 != 0
//    or an unaligned z or dz takes the scalar variant.
//  - Stores are plain: autograd reads dz straight back, and it fits in L2.

#include <algorithm>
#include <atomic>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxC = 32;

// -- cp.async (sm_80+): asynchronous global -> shared copies ------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- bulk copies (sm_90): one thread asks the copy engine for a whole row
// segment; completion is counted in bytes on an mbarrier in shared memory --

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// Orders this thread's earlier shared-memory accesses before later bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Programmatic dependent launch (sm_90): a Gram kernel lets the finish kernel
// be scheduled while it runs; the finish kernel waits for its results.
__device__ __forceinline__ void allow_dependent_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_primary_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// -- element types: f32, or bf16 widened exactly on the read ------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// Values of T in 16 bytes: a 16-byte variant moves this many pixels at once.
template <typename T>
constexpr int kPer16 = 16 / sizeof(T);

// Value k of the 16 bytes held as four 32-bit words (little-endian: the lower
// half of a word is the lower address), widened to f32. k is a constant after
// unrolling, so this is one move (f32) or one shift or mask (bf16).
template <typename T>
__device__ __forceinline__ float unpack16(const unsigned (&w)[4], int k) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[k]);
  } else {
    const unsigned word = w[k >> 1];
    return __uint_as_float((k & 1) ? (word & 0xffff0000u) : (word << 16));
  }
}

// f32 values a[0..kPer16<T>) rounded to T and packed into 16 bytes.
template <typename T>
__device__ __forceinline__ uint4 pack16(const float* a) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      w[i] = __float_as_uint(a[i]);
    } else {
      const __nv_bfloat162 two = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&two);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Copies pixels [p0, p0 + TILE) of `rows` channel rows of one sample into
// dst[row * TILE + pixel]; pixels at or past HW are zero-filled (src-size 0).
template <int TILE, int THREADS, bool VEC, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* zb, int rows, int HW,
                                           int p0, int tid) {
  if constexpr (VEC) {  // HW % kPer16 == 0 and z 16-byte aligned: rows are too
    constexpr int kPer = kPer16<T>, kVecs = TILE / kPer;
    for (int i = tid; i < rows * kVecs; i += THREADS) {
      const int r = i / kVecs, p = p0 + kPer * (i % kVecs);
      const bool in = p < HW;
      cp_async16(dst + r * TILE + (p - p0), in ? zb + (size_t)r * HW + p : zb, in ? 16 : 0);
    }
  } else if constexpr (sizeof(T) == 4) {
    for (int i = tid; i < rows * TILE; i += THREADS) {
      const int r = i / TILE, p = p0 + i % TILE;
      const bool in = p < HW;
      cp_async4(dst + r * TILE + (p - p0), in ? zb + (size_t)r * HW + p : zb, in ? 4 : 0);
    }
  } else {  // 2-byte values: plain loads, made visible by the ring's __syncthreads
    for (int i = tid; i < rows * TILE; i += THREADS) {
      const int r = i / TILE, p = p0 + i % TILE;
      dst[r * TILE + (p - p0)] = p < HW ? zb[(size_t)r * HW + p] : from_f32<T>(0.f);
    }
  }
}

// -- the Gram, C = 16: a thread owns a pixel and 136 sums ---------------------

constexpr int kTriC = 16;
constexpr int kTriPairs = kTriC * (kTriC + 1) / 2;  // 136
constexpr int kTriThreads = 128;
constexpr int kTriTileP = 256;  // pixels a stage: 1 KB a channel row
constexpr int kTriStages = 4;   // 3 tiles (48 KB f32, 24 KB bf16) in flight a block
template <typename T>
constexpr int kTriSmem = kTriStages * kTriC * kTriTileP * sizeof(T);  // dynamic
constexpr int kTriPad = 160;    // 136 padded to 5 x 32 for the reduce-scatter

// One step of a reduce-scatter over the lanes of a warp: lanes l and l ^ M
// split a[0..2H); the lower keeps the first half, the upper the second, and
// each adds its partner's copy of the half it keeps into a[0..H).
template <int M, int H>
__device__ __forceinline__ void halve(float (&a)[kTriPairs], int lane, int& base) {
  const bool upper = lane & M;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = a[i];
    const float hi = (i + H < kTriPairs) ? a[i + H < kTriPairs ? i + H : 0] : 0.f;
    const float theirs = __shfl_xor_sync(0xffffffffu, upper ? lo : hi, M);
    a[i] = (upper ? hi : lo) + theirs;
  }
  base += upper ? H : 0;
}

// Sums a[0..kTriPairs) over the warp by recursive halving; lane l ends with
// the sums of entries base(l) + [0, 5) in a[0..5), and returns base(l).
__device__ __forceinline__ int warp_reduce_scatter(float (&a)[kTriPairs], int lane) {
  static_assert(kTriPad == 5 * 32 && kTriPad >= kTriPairs, "5 sums a lane");
  int base = 0;
  halve<16, 80>(a, lane, base);
  halve<8, 40>(a, lane, base);
  halve<4, 20>(a, lane, base);
  halve<2, 10>(a, lane, base);
  halve<1, 5>(a, lane, base);
  return base;
}

// VEC: the tiles come by bulk copies, one a channel row, started by thread 0
// onto the stage's mbarrier. Otherwise (HW % kPer16<T> != 0 or z unaligned):
// 4-byte cp.async (f32) or plain loads (bf16) by every thread.
template <bool VEC, typename T>
__global__ void __launch_bounds__(kTriThreads, 3)
gram_tri_kernel(const T* __restrict__ z, float* __restrict__ partial, int HW,
                int tiles_per_chunk) {
  extern __shared__ __align__(16) unsigned char tri_raw[];  // kTriStages tiles of C x kTriTileP
  __shared__ float red[kTriThreads / 32][kTriPairs];
  __shared__ __align__(8) uint64_t full[kTriStages];
  auto buf = reinterpret_cast<T(*)[kTriC * kTriTileP]>(tri_raw);
  const int chunk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const T* zb = z + (size_t)b * kTriC * HW;
  const int t0 = chunk * tiles_per_chunk;
  const int nt = min(tiles_per_chunk, (HW + kTriTileP - 1) / kTriTileP - t0);
  allow_dependent_launch();
  if constexpr (VEC) {
    if (tid == 0) {
      for (int s = 0; s < kTriStages; ++s) mbar_init(&full[s], 1);
      mbar_init_fence();
    }
    __syncthreads();
  }
  auto fetch = [&](int t) {  // tile t into slot t % kTriStages
    const int p0 = (t0 + t) * kTriTileP;
    if constexpr (VEC) {
      if (tid == 0) {
        const unsigned row = min(kTriTileP, HW - p0) * sizeof(T);  // a multiple of 16
        uint64_t* bar = &full[t % kTriStages];
        fence_proxy_async();
        mbar_expect_tx(bar, row * kTriC);
        for (int r = 0; r < kTriC; ++r)
          bulk_load(buf[t % kTriStages] + r * kTriTileP, zb + (size_t)r * HW + p0, row, bar);
      }
    } else {
      stage_tile<kTriTileP, kTriThreads, false, T>(buf[t % kTriStages], zb, kTriC, HW, p0, tid);
      cp_async_commit();
    }
  };

  float acc[kTriPairs];
#pragma unroll
  for (int k = 0; k < kTriPairs; ++k) acc[k] = 0.f;

  for (int t = 0; t < kTriStages - 1; ++t) {
    if (t < nt) fetch(t);
    else if constexpr (!VEC) cp_async_commit();  // keep the group count uniform
  }
  for (int t = 0; t < nt; ++t) {
    if constexpr (VEC) {
      __syncthreads();  // slot t-1 is read by everyone: refill it
      if (t + kTriStages - 1 < nt) fetch(t + kTriStages - 1);
      mbar_wait(&full[t % kTriStages], (t / kTriStages) & 1);
    } else {
      cp_async_wait<kTriStages - 2>();  // tile t has landed (this thread's copies)
      __syncthreads();                  // ... everyone's; and slot t-1 is free
      if (t + kTriStages - 1 < nt) fetch(t + kTriStages - 1);
      else cp_async_commit();
    }
    const T* tile = buf[t % kTriStages];
    const int valid = min(kTriTileP, HW - (t0 + t) * kTriTileP);  // bulk copies leave the rest
#pragma unroll 1
    for (int px = tid; px < valid; px += kTriThreads) {
      float v[kTriC];
#pragma unroll
      for (int c = 0; c < kTriC; ++c) v[c] = to_f32(tile[c * kTriTileP + px]);
#pragma unroll
      for (int c = 0; c < kTriC; ++c) {
#pragma unroll
        for (int d = c; d < kTriC; ++d) {
          const int k = c * kTriC - c * (c - 1) / 2 + (d - c);  // row-major upper triangle
          acc[k] = fmaf(v[c], v[d], acc[k]);
        }
      }
    }
  }
  if constexpr (!VEC) cp_async_wait<0>();

  const int lane = tid % 32, warp = tid / 32;
  const int base = warp_reduce_scatter(acc, lane);
#pragma unroll
  for (int i = 0; i < kTriPad / 32; ++i)
    if (base + i < kTriPairs) red[warp][base + i] = acc[i];
  __syncthreads();
  float* out = partial + ((size_t)b * gridDim.x + chunk) * kTriC * kTriC;
  for (int k = tid; k < kTriPairs; k += kTriThreads) {
    float s = red[0][k];
#pragma unroll
    for (int w = 1; w < kTriThreads / 32; ++w) s += red[w][k];
    int c = 0, d = k;  // k -> (c, d >= c), row-major upper triangle
    while (d >= kTriC) {
      d -= kTriC - c - 1;
      ++c;
    }
    out[c * kTriC + d] = s;
    out[d * kTriC + c] = s;
  }
}

// -- the Gram, any C <= 32: lane c of a warp owns row c -----------------------

constexpr int kRowsThreads = 256;
constexpr int kRowsTileP = 64;
constexpr int kRowsStages = 4;  // cp.async ring depth

template <bool VEC, typename T>
__global__ void __launch_bounds__(kRowsThreads)
gram_rows_kernel(const T* __restrict__ z, float* __restrict__ partial, int C, int HW,
                 int tiles_per_chunk) {
  constexpr int kWarps = kRowsThreads / 32;
  __shared__ __align__(16) T buf[kRowsStages][kMaxC * kRowsTileP];
  __shared__ float red[kMaxC][kMaxC + 1];
  const int chunk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const T* zb = z + (size_t)b * C * HW;
  const int t0 = chunk * tiles_per_chunk;
  const int nt = min(tiles_per_chunk, (HW + kRowsTileP - 1) / kRowsTileP - t0);
  allow_dependent_launch();

  float acc[kMaxC];
#pragma unroll
  for (int d = 0; d < kMaxC; ++d) acc[d] = 0.f;

#pragma unroll
  for (int s = 0; s < kRowsStages - 1; ++s) {
    if (s < nt)
      stage_tile<kRowsTileP, kRowsThreads, VEC, T>(buf[s], zb, C, HW, (t0 + s) * kRowsTileP,
                                                   tid);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kRowsStages - 2>();
    __syncthreads();
    const int next = t + kRowsStages - 1;
    if (next < nt)
      stage_tile<kRowsTileP, kRowsThreads, VEC, T>(buf[next % kRowsStages], zb, C, HW,
                                                   (t0 + next) * kRowsTileP, tid);
    cp_async_commit();
    const T* tile = buf[t % kRowsStages];
    for (int p = warp; p < kRowsTileP; p += kWarps) {
      float v[kMaxC], mine = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxC; ++d) {  // broadcasts: every lane reads (d, p)
        v[d] = d < C ? to_f32(tile[d * kRowsTileP + p]) : 0.f;
        mine = lane == d ? v[d] : mine;
      }
#pragma unroll
      for (int d = 0; d < kMaxC; ++d) acc[d] = fmaf(mine, v[d], acc[d]);
    }
  }
  cp_async_wait<0>();

  for (int w = 0; w < kWarps; ++w) {  // across warps in a fixed order
    if (warp == w) {
#pragma unroll
      for (int d = 0; d < kMaxC; ++d) red[lane][d] = (w == 0 ? 0.f : red[lane][d]) + acc[d];
    }
    __syncthreads();
  }
  float* out = partial + ((size_t)b * gridDim.x + chunk) * C * C;
  for (int i = tid; i < C * C; i += kRowsThreads) out[i] = red[i / C][i % C];
}

constexpr int kFinishThreads = 1024;
constexpr int kFinishParts = 4;  // threads a (sample, entry) at C <= 16

// cov[b] = sum over chunks of partial[b] / (HW - 1) + eps I. Part q of an
// entry adds chunks q, q + 4, ... in order; the parts are then added in order.
__global__ void __launch_bounds__(kFinishThreads)
gram_finish_kernel(const float* __restrict__ partial, float* __restrict__ out,
                   int C, int n_chunks, float n_minus_1, float eps) {
  constexpr int kSlots = kFinishThreads / kFinishParts;
  __shared__ float part[kFinishParts][kMaxC * kMaxC];
  wait_for_primary_grid();
  const int b = blockIdx.x, q = threadIdx.x / kSlots, pairs = C * C;
  const float* src = partial + (size_t)b * n_chunks * pairs;
  for (int e = threadIdx.x % kSlots; e < pairs; e += kSlots) {
    float s = 0.f;
#pragma unroll 16
    for (int k = q; k < n_chunks; k += kFinishParts) s += src[(size_t)k * pairs + e];
    part[q][e] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < pairs; e += kFinishThreads) {
    float s = part[0][e];
#pragma unroll
    for (int i = 1; i < kFinishParts; ++i) s += part[i][e];
    out[(size_t)b * pairs + e] = s / n_minus_1 + (e / C == e % C ? eps : 0.f);
  }
}

// -- dz = S z -------------------------------------------------------------------

constexpr int kDzThreads = 256;

// CFIX: the channel count when fixed at compile time (16 on the main path),
// 0 for any C <= 32 at run time. VEC: an item is the 16 bytes of kPer16<T>
// pixels (4 f32 or 8 bf16), moved as one uint4 a channel row; otherwise one
// pixel. A block takes an equal contiguous share of the items (of any grid)
// and builds S for each sample its share falls in. The sums are f32; a bf16
// dz is rounded once, on the store.
template <int CFIX, bool VEC, typename T>
__global__ void __launch_bounds__(kDzThreads)
dz_kernel(const T* __restrict__ z, const float* __restrict__ g, T* __restrict__ dz,
          int B, int C_, int HW, float n_minus_1) {
  constexpr int CM = CFIX ? CFIX : kMaxC;   // S is CM x CM, zero past C
  constexpr int W = VEC ? kPer16<T> : 1;    // pixels an item
  __shared__ __align__(16) float s[CM][CM];
  const int C = CFIX ? CFIX : C_;
  const long long per = HW / W, total = (long long)B * per;
  const long long lo = total * blockIdx.x / gridDim.x;
  const long long hi = total * (blockIdx.x + 1) / gridDim.x;
  for (long long b = lo / per; b * per < hi; ++b) {
    __syncthreads();  // the previous sample's S is no longer read
    const float* gb = g + b * C * C;
    for (int i = threadIdx.x; i < CM * CM; i += kDzThreads) {
      const int c = i / CM, d = i % CM;
      s[c][d] = (c < C && d < C) ? (gb[c * C + d] + gb[d * C + c]) / n_minus_1 : 0.f;
    }
    __syncthreads();
    const T* zb = z + (size_t)b * C * HW;
    T* ob = dz + (size_t)b * C * HW;
    const long long u1 = min(hi, (b + 1) * per) - b * per;
    for (long long u = max(lo, b * per) - b * per + threadIdx.x; u < u1; u += kDzThreads) {
      if constexpr (VEC) {
        unsigned v[CM][4];  // channel row d's 16 bytes, still packed
#pragma unroll
        for (int d = 0; d < CM; ++d) {
          const uint4 q = (CFIX || d < C) ? reinterpret_cast<const uint4*>(zb + (size_t)d * HW)[u]
                                          : make_uint4(0u, 0u, 0u, 0u);
          v[d][0] = q.x, v[d][1] = q.y, v[d][2] = q.z, v[d][3] = q.w;
        }
        for (int c = 0; c < C; ++c) {
          float a[W];
#pragma unroll
          for (int k = 0; k < W; ++k) a[k] = 0.f;
          const float4* srow = reinterpret_cast<const float4*>(s[c]);
#pragma unroll
          for (int d4 = 0; d4 < CM / 4; ++d4) {
            const float4 sv = srow[d4];  // a broadcast: one S value serves W pixels
            const float sd[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
              for (int k = 0; k < W; ++k) a[k] = fmaf(sd[j], unpack16<T>(v[4 * d4 + j], k), a[k]);
            }
          }
          reinterpret_cast<uint4*>(ob + (size_t)c * HW)[u] = pack16<T>(a);
        }
      } else {
        float v[CM];
#pragma unroll
        for (int d = 0; d < CM; ++d)
          v[d] = (CFIX || d < C) ? to_f32(zb[(size_t)d * HW + u]) : 0.f;
        for (int c = 0; c < C; ++c) {
          float a = 0.f;
          const float4* srow = reinterpret_cast<const float4*>(s[c]);
#pragma unroll
          for (int d4 = 0; d4 < CM / 4; ++d4) {
            const float4 sv = srow[d4];
            a = fmaf(sv.x, v[4 * d4], a);
            a = fmaf(sv.y, v[4 * d4 + 1], a);
            a = fmaf(sv.z, v[4 * d4 + 2], a);
            a = fmaf(sv.w, v[4 * d4 + 3], a);
          }
          ob[(size_t)c * HW + u] = from_f32<T>(a);
        }
      }
    }
  }
}

// -- launch planning -------------------------------------------------------------

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Blocks of `threads` threads of `kernel`, with `smem` bytes of dynamic shared
// memory, that device `dev` holds at once.
cudaError_t resident_blocks(int dev, const void* kernel, int threads, int smem, int* out) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *out = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

// The Gram kernel's resident blocks on device `dev`: [dev][0] for C = 16,
// [dev][1] for any other C; 0 until first asked. Queried (and, for C = 16,
// the shared-memory attribute set) once a device, so that a call costs only
// the plan's arithmetic on (B, C, HW).
constexpr int kMaxDevices = 64;
std::atomic<int> g_resident[kMaxDevices][2];

cudaError_t gram_resident(int C, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int kind = C == kTriC ? 0 : 1;
  std::atomic<int>* cached = dev < kMaxDevices ? &g_resident[dev][kind] : nullptr;
  if (cached && (*out = cached->load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  if (kind == 0) {  // above 48 KB, dynamic shared memory is allowed per kernel
    err = cudaFuncSetAttribute(gram_tri_kernel<true, float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kTriSmem<float>);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gram_tri_kernel<false, float>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kTriSmem<float>);
    if (err == cudaSuccess)
      err = resident_blocks(dev, reinterpret_cast<const void*>(gram_tri_kernel<true, float>),
                            kTriThreads, kTriSmem<float>, out);
  } else {
    err = resident_blocks(dev, reinterpret_cast<const void*>(gram_rows_kernel<true, float>),
                          kRowsThreads, 0, out);
  }
  if (err == cudaSuccess && cached) cached->store(*out, std::memory_order_relaxed);
  return err;
}

struct GramPlan {
  int tiles_per_chunk, n_chunks;
};

// Chunks of whole tiles, as many a sample as one wave of resident blocks
// allows over B samples (at least one), none of them empty. The f32 16-byte
// variant's occupancy sizes every variant of either element type (the bf16
// tiles hold as many pixels in half the shared memory), so the chunking (and
// the scratch) depends on (B, C, HW) alone.
cudaError_t gram_plan(int B, int C, int HW, GramPlan* plan) {
  int resident = 1;
  const cudaError_t err = gram_resident(C, &resident);
  const int tile = C == kTriC ? kTriTileP : kRowsTileP;
  const int tiles = (HW + tile - 1) / tile;
  const int want = std::max(1, std::min(resident / B, tiles));
  plan->tiles_per_chunk = (tiles + want - 1) / want;
  plan->n_chunks = (tiles + plan->tiles_per_chunk - 1) / plan->tiles_per_chunk;
  return err;
}

template <typename T>
int gram_launch(const T* z, float* partial, float* cov, int B, int C, int HW, float eps,
                void* stream) {
  const bool vec = HW % kPer16<T> == 0 && aligned16(z);
  GramPlan plan;
  cudaError_t err = gram_plan(B, C, HW, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(plan.n_chunks, B);
  const int tpc = plan.tiles_per_chunk;
  if (C == kTriC) {
    if (vec)
      gram_tri_kernel<true, T><<<grid, kTriThreads, kTriSmem<T>, st>>>(z, partial, HW, tpc);
    else
      gram_tri_kernel<false, T><<<grid, kTriThreads, kTriSmem<T>, st>>>(z, partial, HW, tpc);
  } else {
    if (vec) gram_rows_kernel<true, T><<<grid, kRowsThreads, 0, st>>>(z, partial, C, HW, tpc);
    else gram_rows_kernel<false, T><<<grid, kRowsThreads, 0, st>>>(z, partial, C, HW, tpc);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B);
  cfg.blockDim = dim3(kFinishThreads);
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gram_finish_kernel, static_cast<const float*>(partial), cov, C,
                           plan.n_chunks, static_cast<float>(HW - 1), eps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dz_launch(const T* z, const float* g, T* dz, int B, int C, int HW, void* stream) {
  constexpr int kPer = kPer16<T>;
  const bool vec = HW % kPer == 0 && aligned16(z) && aligned16(dz);
  // one item a thread: short blocks that the card schedules as others finish
  const long long items = (long long)B * (vec ? HW / kPer : HW);
  const int grid = static_cast<int>((items + kDzThreads - 1) / kDzThreads);
  const float n1 = static_cast<float>(HW - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == kTriC) {
    if (vec) dz_kernel<kTriC, true, T><<<grid, kDzThreads, 0, st>>>(z, g, dz, B, C, HW, n1);
    else dz_kernel<kTriC, false, T><<<grid, kDzThreads, 0, st>>>(z, g, dz, B, C, HW, n1);
  } else {
    if (vec) dz_kernel<0, true, T><<<grid, kDzThreads, 0, st>>>(z, g, dz, B, C, HW, n1);
    else dz_kernel<0, false, T><<<grid, kDzThreads, 0, st>>>(z, g, dz, B, C, HW, n1);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int wtpse_covariance_max_c(void) { return kMaxC; }

// Chunks a sample is cut into: the wrapper allocates the partials scratch as
// (B, chunks, C*C), for either element type. Returns -(cudaError_t) if the
// device cannot be queried.
int wtpse_covariance_gram_chunks(int B, int C, int HW) {
  GramPlan plan;
  const cudaError_t err = gram_plan(B, C, HW, &plan);
  return err == cudaSuccess ? plan.n_chunks : -static_cast<int>(err);
}

// cov (B, C, C) f32 = z z^T / (HW - 1) + eps I for an f32 or a bf16 z.
// partial: (B, chunks, C*C) f32 with chunks from wtpse_covariance_gram_chunks(B,
// C, HW) on the same device. Returns the cudaError_t of the launches (0 on success).
int wtpse_covariance_gram_f32(const float* z, float* partial, float* cov,
                              int B, int C, int HW, float eps, void* stream) {
  return gram_launch(z, partial, cov, B, C, HW, eps, stream);
}

int wtpse_covariance_gram_bf16(const void* z, float* partial, float* cov,
                               int B, int C, int HW, float eps, void* stream) {
  return gram_launch(static_cast<const bf16*>(z), partial, cov, B, C, HW, eps, stream);
}

// dz (B, C, HW) = S z with S = (g + g^T) / (HW - 1), g (B, C, C) f32; dz has
// z's element type.
int wtpse_covariance_dz_f32(const float* z, const float* g, float* dz,
                            int B, int C, int HW, void* stream) {
  return dz_launch(z, g, dz, B, C, HW, stream);
}

int wtpse_covariance_dz_bf16(const void* z, const float* g, void* dz,
                             int B, int C, int HW, void* stream) {
  return dz_launch(static_cast<const bf16*>(z), g, static_cast<bf16*>(dz), B, C, HW, stream);
}

}  // extern "C"
