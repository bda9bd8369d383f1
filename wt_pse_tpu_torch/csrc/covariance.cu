// Per-sample feature covariance for the whitening losses, written by hand for
// Hopper (sm_90a). Built by ops/covariance_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C entry points at the end of this file).
//
// Input: the NCHW map the port's convs emit, viewed as z (B, C, HW), C <= 32,
// f32, rows contiguous. IEEE f32 FFMA throughout (no TF32, no tensor cores, as
// the HIGHEST pins of the JAX kernels), and no floating-point atomics: every
// sum is taken in a fixed order, so two calls give bitwise equal results.
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
//  - Stores are plain: autograd reads dz straight back, and it fits in L2.

#include <algorithm>
#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxC = 32;

// -- cp.async (sm_80+): asynchronous global -> shared copies ------------------

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
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

__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
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

// Copies pixels [p0, p0 + TILE) of `rows` channel rows of one sample into
// dst[row * TILE + pixel]; pixels at or past HW are zero-filled (src-size 0).
template <int TILE, int THREADS, bool VEC>
__device__ __forceinline__ void stage_tile(float* dst, const float* zb, int rows, int HW,
                                           int p0, int tid) {
  if constexpr (VEC) {  // HW % 4 == 0 and z 16-byte aligned: rows are too
    constexpr int kQuads = TILE / 4;
    for (int i = tid; i < rows * kQuads; i += THREADS) {
      const int r = i / kQuads, p = p0 + 4 * (i % kQuads);
      const bool in = p < HW;
      cp_async16(dst + r * TILE + (p - p0), in ? zb + (size_t)r * HW + p : zb, in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < rows * TILE; i += THREADS) {
      const int r = i / TILE, p = p0 + i % TILE;
      const bool in = p < HW;
      cp_async4(dst + r * TILE + (p - p0), in ? zb + (size_t)r * HW + p : zb, in ? 4 : 0);
    }
  }
}

// -- the Gram, C = 16: a thread owns a pixel and 136 sums ---------------------

constexpr int kTriC = 16;
constexpr int kTriPairs = kTriC * (kTriC + 1) / 2;  // 136
constexpr int kTriThreads = 128;
constexpr int kTriTileP = 256;  // pixels a stage: 1 KB a channel row
constexpr int kTriStages = 4;   // 3 tiles (48 KB) in flight a block
constexpr int kTriSmem = kTriStages * kTriC * kTriTileP * sizeof(float);  // dynamic
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
// onto the stage's mbarrier. Otherwise (HW % 4 != 0 or z unaligned): 4-byte
// cp.async by every thread.
template <bool VEC>
__global__ void __launch_bounds__(kTriThreads, 3)
gram_tri_kernel(const float* __restrict__ z, float* __restrict__ partial, int HW,
                int tiles_per_chunk) {
  extern __shared__ __align__(16) float tri_buf[];  // kTriStages tiles of C x kTriTileP
  __shared__ float red[kTriThreads / 32][kTriPairs];
  __shared__ __align__(8) uint64_t full[kTriStages];
  auto buf = reinterpret_cast<float(*)[kTriC * kTriTileP]>(tri_buf);
  const int chunk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float* zb = z + (size_t)b * kTriC * HW;
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
        const unsigned row = min(kTriTileP, HW - p0) * sizeof(float);  // a multiple of 16
        uint64_t* bar = &full[t % kTriStages];
        fence_proxy_async();
        mbar_expect_tx(bar, row * kTriC);
        for (int r = 0; r < kTriC; ++r)
          bulk_load(buf[t % kTriStages] + r * kTriTileP, zb + (size_t)r * HW + p0, row, bar);
      }
    } else {
      stage_tile<kTriTileP, kTriThreads, false>(buf[t % kTriStages], zb, kTriC, HW, p0, tid);
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
    const float* tile = buf[t % kTriStages];
    const int valid = min(kTriTileP, HW - (t0 + t) * kTriTileP);  // bulk copies leave the rest
#pragma unroll 1
    for (int px = tid; px < valid; px += kTriThreads) {
      float v[kTriC];
#pragma unroll
      for (int c = 0; c < kTriC; ++c) v[c] = tile[c * kTriTileP + px];
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

template <bool VEC>
__global__ void __launch_bounds__(kRowsThreads)
gram_rows_kernel(const float* __restrict__ z, float* __restrict__ partial, int C, int HW,
                 int tiles_per_chunk) {
  constexpr int kWarps = kRowsThreads / 32;
  __shared__ __align__(16) float buf[kRowsStages][kMaxC * kRowsTileP];
  __shared__ float red[kMaxC][kMaxC + 1];
  const int chunk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const float* zb = z + (size_t)b * C * HW;
  const int t0 = chunk * tiles_per_chunk;
  const int nt = min(tiles_per_chunk, (HW + kRowsTileP - 1) / kRowsTileP - t0);
  allow_dependent_launch();

  float acc[kMaxC];
#pragma unroll
  for (int d = 0; d < kMaxC; ++d) acc[d] = 0.f;

#pragma unroll
  for (int s = 0; s < kRowsStages - 1; ++s) {
    if (s < nt)
      stage_tile<kRowsTileP, kRowsThreads, VEC>(buf[s], zb, C, HW, (t0 + s) * kRowsTileP, tid);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kRowsStages - 2>();
    __syncthreads();
    const int next = t + kRowsStages - 1;
    if (next < nt)
      stage_tile<kRowsTileP, kRowsThreads, VEC>(buf[next % kRowsStages], zb, C, HW,
                                                (t0 + next) * kRowsTileP, tid);
    cp_async_commit();
    const float* tile = buf[t % kRowsStages];
    for (int p = warp; p < kRowsTileP; p += kWarps) {
      float v[kMaxC], mine = 0.f;
#pragma unroll
      for (int d = 0; d < kMaxC; ++d) {  // broadcasts: every lane reads (d, p)
        v[d] = d < C ? tile[d * kRowsTileP + p] : 0.f;
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
// 0 for any C <= 32 at run time. VEC: an item is 4 pixels, moved by float4;
// otherwise one pixel. A block takes an equal contiguous share of the items
// (of any grid) and builds S for each sample its share falls in.
template <int CFIX, bool VEC>
__global__ void __launch_bounds__(kDzThreads)
dz_kernel(const float* __restrict__ z, const float* __restrict__ g, float* __restrict__ dz,
          int B, int C_, int HW, float n_minus_1) {
  constexpr int CM = CFIX ? CFIX : kMaxC;  // S is CM x CM, zero past C
  constexpr int W = VEC ? 4 : 1;           // pixels an item
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
    const float* zb = z + (size_t)b * C * HW;
    float* ob = dz + (size_t)b * C * HW;
    const long long u1 = min(hi, (b + 1) * per) - b * per;
    for (long long u = max(lo, b * per) - b * per + threadIdx.x; u < u1; u += kDzThreads) {
      if constexpr (VEC) {
        float4 v[CM];
#pragma unroll
        for (int d = 0; d < CM; ++d)
          v[d] = (CFIX || d < C) ? reinterpret_cast<const float4*>(zb + (size_t)d * HW)[u]
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c = 0; c < C; ++c) {
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
          const float4* srow = reinterpret_cast<const float4*>(s[c]);
#pragma unroll
          for (int d4 = 0; d4 < CM / 4; ++d4) {
            const float4 sv = srow[d4];  // a broadcast: one S value serves 4 pixels
            const float sd[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 x = v[4 * d4 + j];
              a.x = fmaf(sd[j], x.x, a.x);
              a.y = fmaf(sd[j], x.y, a.y);
              a.z = fmaf(sd[j], x.z, a.z);
              a.w = fmaf(sd[j], x.w, a.w);
            }
          }
          reinterpret_cast<float4*>(ob + (size_t)c * HW)[u] = a;
        }
      } else {
        float v[CM];
#pragma unroll
        for (int d = 0; d < CM; ++d) v[d] = (CFIX || d < C) ? zb[(size_t)d * HW + u] : 0.f;
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
          ob[(size_t)c * HW + u] = a;
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
    err = cudaFuncSetAttribute(gram_tri_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kTriSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gram_tri_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kTriSmem);
    if (err == cudaSuccess)
      err = resident_blocks(dev, reinterpret_cast<const void*>(gram_tri_kernel<true>),
                            kTriThreads, kTriSmem, out);
  } else {
    err = resident_blocks(dev, reinterpret_cast<const void*>(gram_rows_kernel<true>),
                          kRowsThreads, 0, out);
  }
  if (err == cudaSuccess && cached) cached->store(*out, std::memory_order_relaxed);
  return err;
}

struct GramPlan {
  int tiles_per_chunk, n_chunks;
};

// Chunks of whole tiles, as many a sample as one wave of resident blocks
// allows over B samples (at least one), none of them empty. The 16-byte
// variant's occupancy sizes both variants, so the chunking (and the scratch)
// depends on (B, C, HW) alone.
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

}  // namespace

extern "C" {

int wtpse_covariance_max_c(void) { return kMaxC; }

// Chunks a sample is cut into: the wrapper allocates the partials scratch as
// (B, chunks, C*C). Returns -(cudaError_t) if the device cannot be queried.
int wtpse_covariance_gram_chunks(int B, int C, int HW) {
  GramPlan plan;
  const cudaError_t err = gram_plan(B, C, HW, &plan);
  return err == cudaSuccess ? plan.n_chunks : -static_cast<int>(err);
}

// cov (B, C, C) = z z^T / (HW - 1) + eps I. partial: (B, chunks, C*C) with
// chunks from wtpse_covariance_gram_chunks(B, C, HW) on the same device.
// Returns the cudaError_t of the launches (0 on success).
int wtpse_covariance_gram_f32(const float* z, float* partial, float* cov,
                              int B, int C, int HW, float eps, void* stream) {
  const bool vec = HW % 4 == 0 && aligned16(z);
  GramPlan plan;
  cudaError_t err = gram_plan(B, C, HW, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(plan.n_chunks, B);
  if (C == kTriC) {
    if (vec)
      gram_tri_kernel<true><<<grid, kTriThreads, kTriSmem, st>>>(z, partial, HW,
                                                                 plan.tiles_per_chunk);
    else
      gram_tri_kernel<false><<<grid, kTriThreads, kTriSmem, st>>>(z, partial, HW,
                                                                  plan.tiles_per_chunk);
  } else {
    if (vec)
      gram_rows_kernel<true><<<grid, kRowsThreads, 0, st>>>(z, partial, C, HW,
                                                            plan.tiles_per_chunk);
    else
      gram_rows_kernel<false><<<grid, kRowsThreads, 0, st>>>(z, partial, C, HW,
                                                             plan.tiles_per_chunk);
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

// dz (B, C, HW) = S z with S = (g + g^T) / (HW - 1), g (B, C, C).
int wtpse_covariance_dz_f32(const float* z, const float* g, float* dz,
                            int B, int C, int HW, void* stream) {
  const bool vec = HW % 4 == 0 && aligned16(z) && aligned16(dz);
  // one item a thread: short blocks that the card schedules as others finish
  const long long items = (long long)B * (vec ? HW / 4 : HW);
  const int grid = static_cast<int>((items + kDzThreads - 1) / kDzThreads);
  const float n1 = static_cast<float>(HW - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == kTriC) {
    if (vec) dz_kernel<kTriC, true><<<grid, kDzThreads, 0, st>>>(z, g, dz, B, C, HW, n1);
    else dz_kernel<kTriC, false><<<grid, kDzThreads, 0, st>>>(z, g, dz, B, C, HW, n1);
  } else {
    if (vec) dz_kernel<0, true><<<grid, kDzThreads, 0, st>>>(z, g, dz, B, C, HW, n1);
    else dz_kernel<0, false><<<grid, kDzThreads, 0, st>>>(z, g, dz, B, C, HW, n1);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
