// Training-mode BatchNorm with the ReLU that follows it fused in, forward and
// backward, written by hand for Hopper (sm_90a). Built by ops/batchnorm_cuda.py
// (through ops/cuda_lib.py::build) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C entry points at the end of this file).
//
// It replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses it on the TPU. On the card PyTorch's NCHW BatchNorm backward reduces
// each channel in one block (batch_norm_backward_reduce_kernel), so the 16-
// and 32-channel layers at 256x256 and 128x128, which hold most of the bytes,
// ran on 16-64 of 132 SMs, and the ReLU's backward before it was one more
// pass that read its saved output and wrote a gradient. cuDNN's f32 forward
// (bn_fw_tr_1C11_*) was followed by the ReLU as a pass of its own over y.
//
// Same arithmetic as nn.BatchNorm2d (training) + F.relu, in f32: the forward
// gives y, the saved mean and invstd (biased variance) and updates the
// running statistics (unbiased variance, momentum) and num_batches_tracked;
// the backward takes the saved mean and invstd. x, dy, y and dx are f32, or
// bf16 in the bf16 training mode with f32 statistics, parameters and sums
// (the forward's entry point is f32 alone: bf16's output check holds the
// forward to the library's rounding). The map is NCHW with rows of HW
// values; dy may have any batch stride (the gradient of a channel slice of a
// concat).
//
// The ReLU: the pre-activation is fmaf(x - mean, invstd w, b), and y = 0
// where it is <= 0 (a NaN passes, as in torch). The backward recomputes its
// mask from x by the same expression: g = dy where it is not <= 0, else 0.
// The output is not kept for it: kept, it stays live through the backward
// beside x, dy and dx, and the f32 step's CUDA graph pool grew from 5.0 to
// 7.2 GB. After this forward the two sides of the kink agree bit for bit;
// after another forward (ATen's, in bf16), where y lies within a rounding of
// 0 the recomputed sign can differ from the forward's.
//
// What bounds it: bytes. The forward reads x twice and writes y, the backward
// reads x and dy twice and writes dx: at the main path's layers (N = 9,
// C = 16-256, HW = 256^2 down to 16^2) 3 and 5 passes over a map. The design
// fills the card at every layer and keeps the second read in L2:
//  - every channel's N x HW values are cut into S chunks (S from the shape, in
//    the wrapper, so that C x S blocks cover the card several times over); one
//    block a chunk, 256 threads, 16-byte loads (4 f32 or 8 bf16; one value a
//    load where HW is not a multiple of that or a pointer is not 16-byte
//    aligned), two in flight a thread;
//  - bn_fw_reduce_kernel: the moments of its chunk about the channel's first
//    value (its shift): sums of d = x - shift and d^2, added across the block
//    by warp shuffles and across warps in a fixed order, one partial a block:
//    the chunk's mean of d and M2 (squared deviations from that mean);
//  - bn_fw_apply_kernel: each block merges its channel's S partials by Chan's
//    formula in one fixed order, so every block of a channel has the same
//    mean and invstd, bit for bit; block s = 0 writes the saved statistics
//    and the running ones (and block 0 num_batches_tracked); every block
//    writes y for its chunk;
//  - bn_bw_reduce_kernel: partial sums of g and g (x - mean) over its chunk,
//    added as the forward's, one partial a block;
//  - bn_bw_apply_kernel: each block adds its channel's S partials in one
//    fixed order, so every block of a channel has the same sums, bit for bit;
//    block s = 0 writes dweight = sum g x^ and dbias = sum g; every block
//    writes dx = w invstd (g - sum g / M - x^ sum g x^ / M) for its chunk.
// Each apply kernel walks the chunks in the reverse order of its reduction,
// so its first blocks read what that pass read last, still in the 50 MB L2,
// and is a programmatic dependent launch: scheduled while the reduction runs,
// it waits for it (griddepcontrol), which hides its launch. No atomics: two
// calls give bitwise equal results. The forward's statistics round each
// operation on its own (the __f*_rn intrinsics: no contraction into fmas),
// in an order that ops/batchnorm_cuda.py::batch_norm_forward_plain repeats.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// blocks an SM the forward's apply kernel is held to (32 registers a thread):
// the wrapper's WAVE_BLOCKS, so that the C x S blocks are resident at once
constexpr int kBlocksPerSM = 8;

template <typename T>
constexpr int kPer16 = 16 / static_cast<int>(sizeof(T));  // values in 16 bytes

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_primary_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// -- V values at vector index `off` (units of V values), widened to f32 -------

template <typename T, int V>
__device__ __forceinline__ void load_vals(const T* __restrict__ p, int off, float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 4) v[0] = p[off];
    else v[0] = __bfloat162float(p[off]);
  } else if constexpr (sizeof(T) == 4) {
    const float4 q = reinterpret_cast<const float4*>(p)[off];
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const uint4 q = reinterpret_cast<const uint4*>(p)[off];
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <typename T, int V>
__device__ __forceinline__ void store_vals(T* __restrict__ p, int off, const float (&v)[V]) {
  if constexpr (V == 1) {
    if constexpr (sizeof(T) == 4) p[off] = v[0];
    else p[off] = __float2bfloat16_rn(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(p)[off] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    reinterpret_cast<uint4*>(p)[off] =
        make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]), pack2(v[6], v[7]));
  }
}

// -- the chunks ---------------------------------------------------------------

// Chunk k of C * S: channel k / S, part k % S of its N * R vectors (R a row,
// rows n * C + c), as [j0, j1).
struct Chunk {
  int c, s, j0, j1;
};

__device__ __forceinline__ Chunk chunk_of(int k, int S, int per_channel) {
  Chunk ch;
  ch.c = k / S;
  ch.s = k - ch.c * S;
  ch.j0 = static_cast<int>(static_cast<long long>(ch.s) * per_channel / S);
  ch.j1 = static_cast<int>(static_cast<long long>(ch.s + 1) * per_channel / S);
  return ch;
}

// Calls f(n, r) for vector r of row n, for each vector j of [j0, j1) that is
// this thread's (j = j0 + threadIdx.x + i * kThreads), two at a time so that
// two loads are in flight.
template <class F>
__device__ __forceinline__ void walk(int j0, int j1, int R, F&& f) {
  int j = j0 + static_cast<int>(threadIdx.x);
  if (j >= j1) return;
  const int dn = kThreads / R, dr = kThreads - dn * R;
  int n = j / R, r = j - n * R;
  auto next = [&] {
    r += dr;
    n += dn;
    if (r >= R) { r -= R; ++n; }
  };
  for (; j + kThreads < j1; j += 2 * kThreads) {
    const int n0 = n, r0 = r;
    next();
    const int n1 = n, r1 = r;
    next();
    f(n0, r0);
    f(n1, r1);
  }
  if (j < j1) f(n, r);
}

// -- sums -------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sums of the block, in thread 0, added in a fixed order.
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sh[2][kWarps];
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) {
    sh[0][w] = a;
    sh[1][w] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kWarps; ++i) {
      a += sh[0][i];
      b += sh[1][i];
    }
  }
}

// -- forward ------------------------------------------------------------------

// The moments of a part of a channel: its count, its mean less the channel's
// shift, and its M2, the sum of squared deviations from that mean.
struct Moments {
  float n, m, m2;
};

// Chan's pairwise update: a becomes a and b together (b empty: a stays).
__device__ __forceinline__ void merge(Moments& a, const Moments& b) {
  if (b.n == 0.f) return;
  const float n = __fadd_rn(a.n, b.n);
  const float delta = __fsub_rn(b.m, a.m);
  const float f = __fdiv_rn(b.n, n);
  a.m = __fadd_rn(a.m, __fmul_rn(delta, f));
  a.m2 = __fadd_rn(__fadd_rn(a.m2, b.m2),
                   __fmul_rn(__fmul_rn(__fmul_rn(delta, delta), a.n), f));
  a.n = n;
}

// partial[k] = (mean of d, M2) over chunk k, d = x - x[0, c, 0].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_fw_reduce_kernel(const T* __restrict__ x, float* __restrict__ partial, int N, int C, int R,
                    int S) {
  launch_dependents();
  const Chunk ch = chunk_of(blockIdx.x, S, N * R);
  const int cR = ch.c * R, CR = C * R;
  float shift[1];
  load_vals<T, 1>(x, cR * V, shift);
  float s1 = 0.f, s2 = 0.f;
  walk(ch.j0, ch.j1, R, [&](int row, int r) {
    float v[V];
    load_vals<T, V>(x, row * CR + cR + r, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = __fsub_rn(v[i], shift[0]);
      s1 = __fadd_rn(s1, d);
      s2 = __fadd_rn(s2, __fmul_rn(d, d));
    }
  });
  block_sum2(s1, s2);
  if (threadIdx.x == 0) {
    const float n = static_cast<float>((ch.j1 - ch.j0) * V);
    const float m = __fdiv_rn(s1, n);
    partial[2 * static_cast<size_t>(blockIdx.x)] = m;
    partial[2 * static_cast<size_t>(blockIdx.x) + 1] = __fsub_rn(s2, __fmul_rn(s1, m));
  }
}

// y = fmaf(x - mean, invstd w, b) over chunk C S - 1 - blockIdx.x (0 where
// that is <= 0, with the ReLU), after the channel's moments from its
// partials (warp 0: lane-strided, then by shuffles); block s = 0 writes the
// saved mean and invstd and updates the running statistics, block 0
// num_batches_tracked.
template <typename T, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
bn_fw_apply_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ partial,
                   const float* __restrict__ weight, const float* __restrict__ bias,
                   float* __restrict__ save_mean, float* __restrict__ save_invstd,
                   float* __restrict__ running_mean, float* __restrict__ running_var,
                   long long* __restrict__ num_batches_tracked, int N, int C, int R, int S,
                   float momentum, float eps) {
  __shared__ float stats[2];
  const int per_channel = N * R;
  const Chunk ch = chunk_of(gridDim.x - 1 - blockIdx.x, S, per_channel);
  const int cR = ch.c * R, CR = C * R;
  float shift[1];
  load_vals<T, 1>(x, cR * V, shift);
  const float w = weight[ch.c], b = bias[ch.c];
  wait_for_primary_grid();
  if (threadIdx.x < 32) {
    const float* p = partial + 2 * static_cast<size_t>(ch.c) * S;
    // chunk i holds floor((i + 1) P / S) - floor(i P / S) loads, P = q S + rem
    const int q = per_channel / S, rem = per_channel - q * S;
    Moments a = {0.f, 0.f, 0.f};
    for (int i = threadIdx.x; i < S; i += 32) {
      const int loads = q + (i + 1) * rem / S - i * rem / S;
      merge(a, {static_cast<float>(loads * V), p[2 * i], p[2 * i + 1]});
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const Moments other = {__shfl_down_sync(0xffffffffu, a.n, o),
                             __shfl_down_sync(0xffffffffu, a.m, o),
                             __shfl_down_sync(0xffffffffu, a.m2, o)};
      merge(a, other);
    }
    if (threadIdx.x == 0) {
      const long long count = static_cast<long long>(per_channel) * V;
      const float m2 = a.m2 < 0.f ? 0.f : a.m2;  // a rounding below 0; a NaN stays
      const float mean = __fadd_rn(shift[0], a.m);
      const float var = __fdiv_rn(m2, static_cast<float>(count));
      const float invstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
      stats[0] = mean;
      stats[1] = invstd;
      if (ch.s == 0) {
        save_mean[ch.c] = mean;
        save_invstd[ch.c] = invstd;
        const float keep = __fsub_rn(1.f, momentum);
        const float unbiased = __fdiv_rn(m2, static_cast<float>(count - 1));
        running_mean[ch.c] = __fadd_rn(__fmul_rn(keep, running_mean[ch.c]),
                                       __fmul_rn(momentum, mean));
        running_var[ch.c] = __fadd_rn(__fmul_rn(keep, running_var[ch.c]),
                                      __fmul_rn(momentum, unbiased));
        if (ch.c == 0) *num_batches_tracked += 1;
      }
    }
  }
  __syncthreads();
  // the backward's expression for its mask (masked): the same bits
  const float mean = stats[0], scale = stats[1] * w;
  walk(ch.j0, ch.j1, R, [&](int row, int r) {
    const int off = row * CR + cR + r;
    float v[V];
    load_vals<T, V>(x, off, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float pre = fmaf(v[i] - mean, scale, b);
      v[i] = kRelu && pre <= 0.f ? 0.f : pre;
    }
    store_vals<T, V>(y, off, v);
  });
}

// -- backward -----------------------------------------------------------------

// g at one value with x - mean = xm: dy, and with the ReLU 0 where the
// recomputed pre-activation fmaf(xm, invstd w, b) is <= 0 (threshold_backward's
// test, so a NaN passes its gradient).
template <bool kRelu>
__device__ __forceinline__ float masked(float dy, float xm, float scale, float shift) {
  if constexpr (kRelu) return fmaf(xm, scale, shift) <= 0.f ? 0.f : dy;
  else return dy;
}

// partial[k] = (sum g, sum g (x - mean)) over chunk k. dy's rows n * dyN + c R.
template <typename T, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_bw_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    const float* __restrict__ save_mean, const float* __restrict__ save_invstd,
                    const float* __restrict__ weight, const float* __restrict__ bias,
                    float* __restrict__ partial, int N, int C, int R, int S, int dyN) {
  launch_dependents();
  const Chunk ch = chunk_of(blockIdx.x, S, N * R);
  const float mean = save_mean[ch.c], scale = save_invstd[ch.c] * weight[ch.c];
  const float shift = bias[ch.c];
  const int cR = ch.c * R, CR = C * R;
  float sg = 0.f, sgx = 0.f;
  walk(ch.j0, ch.j1, R, [&](int row, int r) {
    float v[V], g[V];
    load_vals<T, V>(x, row * CR + cR + r, v);
    load_vals<T, V>(dy, row * dyN + cR + r, g);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xm = v[i] - mean;
      const float gi = masked<kRelu>(g[i], xm, scale, shift);
      sg += gi;
      sgx = fmaf(gi, xm, sgx);
    }
  });
  block_sum2(sg, sgx);
  if (threadIdx.x == 0) {
    partial[2 * static_cast<size_t>(blockIdx.x)] = sg;
    partial[2 * static_cast<size_t>(blockIdx.x) + 1] = sgx;
  }
}

// dx = w invstd (g - sum g / M - (x - mean) invstd^2 sum g (x - mean) / M)
// over chunk C S - 1 - blockIdx.x, after the channel's sums from its
// partials (warp 0, lane-strided then by shuffles: the same bits in every
// block of the channel); block s = 0 writes dweight and dbias.
template <typename T, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
bn_bw_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy, T* __restrict__ dx,
                   const float* __restrict__ partial, const float* __restrict__ save_mean,
                   const float* __restrict__ save_invstd, const float* __restrict__ weight,
                   const float* __restrict__ bias, float* __restrict__ dweight,
                   float* __restrict__ dbias, int N, int C, int R, int S, int dyN) {
  __shared__ float sums[2];
  const Chunk ch = chunk_of(gridDim.x - 1 - blockIdx.x, S, N * R);
  const float mean = save_mean[ch.c], invstd = save_invstd[ch.c];
  const float scale = invstd * weight[ch.c], shift = bias[ch.c];
  wait_for_primary_grid();
  if (threadIdx.x < 32) {
    const float* p = partial + 2 * static_cast<size_t>(ch.c) * S;
    float sg = 0.f, sgx = 0.f;
    for (int i = threadIdx.x; i < S; i += 32) {
      sg += p[2 * i];
      sgx += p[2 * i + 1];
    }
    sg = warp_sum(sg);
    sgx = warp_sum(sgx);
    if (threadIdx.x == 0) {
      sums[0] = sg;
      sums[1] = sgx;
      if (ch.s == 0) {
        dweight[ch.c] = sgx * invstd;
        dbias[ch.c] = sg;
      }
    }
  }
  __syncthreads();
  const float m = static_cast<float>(N) * static_cast<float>(R) * static_cast<float>(V);
  const float mean_g = sums[0] / m, k = sums[1] * invstd * invstd / m;
  const int cR = ch.c * R, CR = C * R;
  walk(ch.j0, ch.j1, R, [&](int row, int r) {
    const int off = row * CR + cR + r;
    float v[V], g[V];
    load_vals<T, V>(x, off, v);
    load_vals<T, V>(dy, row * dyN + cR + r, g);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xm = v[i] - mean;
      v[i] = (masked<kRelu>(g[i], xm, scale, shift) - mean_g - xm * k) * scale;
    }
    store_vals<T, V>(dx, off, v);
  });
}

// -- launches -----------------------------------------------------------------

// A launch of `kernel` that may start while the kernel before it on `st` runs
// (it waits for it with griddepcontrol.wait).
template <typename... KArgs, typename... Args>
cudaError_t launch_dependent(void (*kernel)(KArgs...), int blocks, cudaStream_t st,
                             Args... args) {
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int V, bool kRelu>
int forward_launch(const T* x, T* y, float* partial, const float* weight, const float* bias,
                   float* save_mean, float* save_invstd, float* running_mean, float* running_var,
                   long long* num_batches_tracked, int N, int C, int HW, int S, float momentum,
                   float eps, cudaStream_t st) {
  const int R = HW / V, blocks = C * S;
  bn_fw_reduce_kernel<T, V><<<blocks, kThreads, 0, st>>>(x, partial, N, C, R, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dependent(&bn_fw_apply_kernel<T, V, kRelu>, blocks, st, x, y, partial, weight,
                         bias, save_mean, save_invstd, running_mean, running_var,
                         num_batches_tracked, N, C, R, S, momentum, eps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The 16-byte variant where HW is a multiple of the values in 16 bytes and x
// and y are 16-byte aligned, else one value a load.
template <typename T>
int forward(const void* x, void* y, void* partial, const void* weight, const void* bias,
            void* save_mean, void* save_invstd, void* running_mean, void* running_var,
            void* num_batches_tracked, int N, int C, int HW, int S, float momentum, float eps,
            int relu, void* stream) {
  constexpr int kPer = kPer16<T>;
  const bool vec = HW % kPer == 0 && aligned16(x) && aligned16(y);
  auto run = [&](auto v, auto with) {
    constexpr int V = decltype(v)::value;
    constexpr bool kRelu = decltype(with)::value;
    return forward_launch<T, V, kRelu>(
        static_cast<const T*>(x), static_cast<T*>(y), static_cast<float*>(partial),
        static_cast<const float*>(weight), static_cast<const float*>(bias),
        static_cast<float*>(save_mean), static_cast<float*>(save_invstd),
        static_cast<float*>(running_mean), static_cast<float*>(running_var),
        static_cast<long long*>(num_batches_tracked), N, C, HW, S, momentum, eps,
        static_cast<cudaStream_t>(stream));
  };
  auto with_relu = [&](auto v) {
    return relu != 0 ? run(v, std::true_type{}) : run(v, std::false_type{});
  };
  return vec ? with_relu(std::integral_constant<int, kPer>{})
             : with_relu(std::integral_constant<int, 1>{});
}

template <typename T, int V, bool kRelu>
int backward_launch(const T* x, const T* dy, T* dx, float* partial, const float* save_mean,
                    const float* save_invstd, const float* weight, const float* bias,
                    float* dweight, float* dbias, int N, int C, int HW, int dy_batch_stride,
                    int S, cudaStream_t st) {
  const int R = HW / V, dyN = dy_batch_stride / V, blocks = C * S;
  bn_bw_reduce_kernel<T, V, kRelu><<<blocks, kThreads, 0, st>>>(
      x, dy, save_mean, save_invstd, weight, bias, partial, N, C, R, S, dyN);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dependent(&bn_bw_apply_kernel<T, V, kRelu>, blocks, st, x, dy, dx, partial,
                         save_mean, save_invstd, weight, bias, dweight, dbias, N, C, R, S, dyN);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The 16-byte variant where HW and dy's batch stride are multiples of the
// values in 16 bytes and every map is 16-byte aligned, else one value a load.
template <typename T>
int backward(const void* x, const void* dy, void* dx, void* partial, const void* save_mean,
             const void* save_invstd, const void* weight, const void* bias, void* dweight,
             void* dbias, int N, int C, int HW, int dy_batch_stride, int S, int relu,
             void* stream) {
  constexpr int kPer = kPer16<T>;
  const bool vec = HW % kPer == 0 && dy_batch_stride % kPer == 0 && aligned16(x) &&
                   aligned16(dy) && aligned16(dx);
  auto run = [&](auto v, auto with) {
    constexpr int V = decltype(v)::value;
    constexpr bool kRelu = decltype(with)::value;
    return backward_launch<T, V, kRelu>(
        static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<T*>(dx),
        static_cast<float*>(partial), static_cast<const float*>(save_mean),
        static_cast<const float*>(save_invstd), static_cast<const float*>(weight),
        static_cast<const float*>(bias), static_cast<float*>(dweight),
        static_cast<float*>(dbias), N, C, HW, dy_batch_stride, S,
        static_cast<cudaStream_t>(stream));
  };
  auto with_relu = [&](auto v) {
    return relu != 0 ? run(v, std::true_type{}) : run(v, std::false_type{});
  };
  return vec ? with_relu(std::integral_constant<int, kPer>{})
             : with_relu(std::integral_constant<int, 1>{});
}

}  // namespace

extern "C" {

// y (contiguous, x's type), save_mean and save_invstd ((C,) f32) of x (N, C,
// HW) f32, contiguous, with the ReLU when relu; running_mean and running_var
// ((C,) f32) updated at momentum, num_batches_tracked (one int64) incremented.
// partial: 2 C S f32 of scratch, S chunks a channel (1 <= S <= N HW). Returns
// the cudaError_t of the launches (0 on success).
int wtpse_bn_forward_f32(const void* x, void* y, void* partial, const void* weight,
                         const void* bias, void* save_mean, void* save_invstd,
                         void* running_mean, void* running_var, void* num_batches_tracked,
                         int N, int C, int HW, int S, float momentum, float eps, int relu,
                         void* stream) {
  return forward<float>(x, y, partial, weight, bias, save_mean, save_invstd, running_mean,
                        running_var, num_batches_tracked, N, C, HW, S, momentum, eps, relu,
                        stream);
}

// dx (contiguous, x's type), dweight and dbias ((C,) f32) for x (N, C, HW) f32
// or bf16, contiguous, and the forward's saved save_mean and save_invstd;
// with relu, dy passes where the recomputed pre-activation is positive. dy
// has x's type and shape, rows of HW values at channel stride HW and batch
// stride dy_batch_stride (values). partial: 2 C S f32 of scratch, S chunks a
// channel (1 <= S <= N HW). Returns the cudaError_t of the launches (0 on
// success).
int wtpse_bn_backward_f32(const void* x, const void* dy, void* dx, void* partial,
                          const void* save_mean, const void* save_invstd, const void* weight,
                          const void* bias, void* dweight, void* dbias, int N, int C, int HW,
                          int dy_batch_stride, int S, int relu, void* stream) {
  return backward<float>(x, dy, dx, partial, save_mean, save_invstd, weight, bias, dweight,
                         dbias, N, C, HW, dy_batch_stride, S, relu, stream);
}

int wtpse_bn_backward_bf16(const void* x, const void* dy, void* dx, void* partial,
                           const void* save_mean, const void* save_invstd, const void* weight,
                           const void* bias, void* dweight, void* dbias, int N, int C, int HW,
                           int dy_batch_stride, int S, int relu, void* stream) {
  return backward<bf16>(x, dy, dx, partial, save_mean, save_invstd, weight, bias, dweight,
                        dbias, N, C, HW, dy_batch_stride, S, relu, stream);
}

}  // extern "C"
