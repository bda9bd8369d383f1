// The 2x bilinear upsample of the U-Net decoders (align_corners=False), forward
// and backward, written by hand for Hopper (sm_90a). Built by
// ops/upsample_cuda.py (through ops/cuda_lib.py::build) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C entry points at the end of this file).
//
// It replaces no TPU kernel: the JAX package leaves the resize to XLA. On the
// card PyTorch's NCHW bilinear forward gives one thread to each output pixel
// and loops it over every image and channel, and its backward zero-fills the
// gradient and scatters into it with atomic adds (in bf16, bf16 adds in an
// order that changes from run to run). The bf16 training mode also resizes in
// two passes, rows then columns, with a bf16 round between them (the JAX
// package's order), so each pass wrote a full intermediate.
//
// Forward (upsample2x_fwd_kernel): one thread a group of V input columns of
// one input row i (V = 4 where W is a multiple of 4 and the maps are 16-byte
// aligned, else 1). It reads input rows i - 1, i, i + 1 and columns j0 - 1 ..
// j0 + V + 1 (clamped at the edges) into registers, and writes output rows
// 2i and 2i + 1, columns 2 j0 .. 2 j0 + 2V - 1. The weights, the clamped source
// indices and the expression are ATen's (UpSampleBilinear2d.cu,
// upsample_bilinear2d_out_frame, scale 2 along an axis, 1 along the other):
//   h0 (w0 x00 + w1 x01) + h1 (w0 x10 + w1 x11)
// with (h0, h1), (w0, w1) in {(1, 0), (0.25, 0.75), (0.75, 0.25)}: source row 0
// at weight 1 for output row 0, the last row twice at the bottom. Terms at
// weight 0 are kept, as ATen computes them, so that an inf or NaN beside a
// pixel reaches it as it does there.
//  - bf16: the row pass, then the column pass, each in f32 and rounded to
//    bf16, as F.interpolate(scale_factor=(2, 1)) then (1, 2) compute them.
//    The row pass runs at the 3 x (V + 2) points the column pass reads; both
//    stay in registers. Every product of a weight and a bf16 value is exact
//    in f32, so each pass rounds once whatever the contraction: the output is
//    that pair of calls', bit for bit.
//  - f32: both axes in one pass, with ATen's expression contracted into
//    fused multiply-adds as nvcc contracts it there,
//    fma(h0, fma(w0, x00, w1 x01), h1 fma(w0, x10, w1 x11)).
//
// Backward (upsample2x_bwd_kernel): a gather with no atomics and no zero-fill.
// Each input pixel (i, j) reads its 4 x 4 neighbourhood of dy, rows 2i - 1 ..
// 2i + 2 and columns 2j - 1 .. 2j + 2, at weights (0.25, 0.75, 0.75, 0.25)
// along each axis; row (column) 0 takes output 0 at weight 1 and nothing from
// row -1, the last row (column) takes output 2n - 1 at weight 1 and nothing
// from 2n. One thread a group of V input columns: the columns' vertical sums
// first (2V + 2 of them), then the horizontal ones, every product and sum
// rounded to f32 on its own (no contraction), and dx written once in x's
// type. In bf16 that is the exact gradient of the two-pass forward (the
// rounding's backward is the identity) rounded once. Two calls give the
// same bits; the plain PyTorch version (ops/upsample_cuda.py) gives them too.
//
// What bounds it: bytes. The forward reads x once and writes y (4x x); the
// backward reads dy and writes dx. Neighbouring threads share rows and
// columns of their tiles through L1 and L2.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

// -- loads and stores, widened to and narrowed from f32 ------------------------

__device__ __forceinline__ float ld(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float ld(const bf16* p, int i) { return __bfloat162float(p[i]); }

// V consecutive values from p + i (16-byte aligned f32, 8-byte aligned bf16
// where V = 4)
template <int V>
__device__ __forceinline__ void ld_vec(const float* p, int i, float* v) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p + i);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = p[i + k];
  }
}

template <int V>
__device__ __forceinline__ void ld_vec(const bf16* p, int i, float* v) {
  if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p + i);
    v[0] = __uint_as_float(q.x << 16); v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16); v[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __bfloat162float(p[i + k]);
  }
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// N consecutive values to p + i (where kVec: N a multiple of 4, p + i 16
// bytes aligned for f32 and for bf16 with N a multiple of 8, else 8 bytes)
template <int N, bool kVec>
__device__ __forceinline__ void st_vec(float* p, int i, const float* v) {
  if constexpr (kVec) {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *reinterpret_cast<float4*>(p + i + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[i + k] = v[k];
  }
}

template <int N, bool kVec>
__device__ __forceinline__ void st_vec(bf16* p, int i, const float* v) {
  if constexpr (kVec && N % 8 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 8)
      *reinterpret_cast<uint4*>(p + i + k) =
          make_uint4(pack2(v[k], v[k + 1]), pack2(v[k + 2], v[k + 3]),
                     pack2(v[k + 4], v[k + 5]), pack2(v[k + 6], v[k + 7]));
  } else if constexpr (kVec) {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *reinterpret_cast<uint2*>(p + i + k) =
          make_uint2(pack2(v[k], v[k + 1]), pack2(v[k + 2], v[k + 3]));
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) p[i + k] = __float2bfloat16_rn(v[k]);
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// Input row i (a map of W values a row) at columns j0 - 1 .. j0 + V + 1,
// clamped to [0, W - 1], into t[0 .. V + 2].
template <typename T, int V>
__device__ __forceinline__ void ld_tile_row(const T* row, int j0, int W, float* t) {
  t[0] = ld(row, max(j0 - 1, 0));
  ld_vec<V>(row, j0, t + 1);
  t[V + 1] = ld(row, min(j0 + V, W - 1));
  t[V + 2] = ld(row, min(j0 + V + 1, W - 1));
}

// ATen's two-tap linear resize of a value from its four neighbours, every
// term kept: h0 (w0 a + w1 b) + h1 (w0 c + w1 d), as written in
// upsample_bilinear2d_out_frame. In bf16 every product is exact, so the
// contraction nvcc picks cannot change the sum.
__device__ __forceinline__ float lerp2(float h0, float h1, float w0, float w1, float a, float b,
                                       float c, float d) {
  return h0 * (w0 * a + w1 * b) + h1 * (w0 * c + w1 * d);
}

// The same expression contracted as nvcc contracts ATen's f32 kernel.
__device__ __forceinline__ float lerp2_f32(float h0, float h1, float w0, float w1, float a,
                                           float b, float c, float d) {
  return __fmaf_rn(h0, __fmaf_rn(w0, a, __fmul_rn(w1, b)),
                   __fmul_rn(h1, __fmaf_rn(w0, c, __fmul_rn(w1, d))));
}

// -- forward ------------------------------------------------------------------

// Output columns 2 j0 .. 2 j0 + 2V - 1 of one output row from the two source
// rows ra, rb (tile columns q: clamp(j0 - 1 + q)) at row weights (h0, h1).
// Output column 2j reads source columns (j - 1, j) at (0.25, 0.75), column 0
// reads (0, 1) at (1, 0), column 2j + 1 reads (j, j + 1) at (0.75, 0.25);
// the clamped tile repeats the last column at the right edge, as ATen does.
// kF32: lerp2_f32, else lerp2.
template <int V, int N, bool kF32>
__device__ __forceinline__ void resize_cols(const float (&ra)[N], const float (&rb)[N], float h0,
                                            float h1, int j0, float (&out)[2 * V]) {
#pragma unroll
  for (int m = 0; m < 2 * V; ++m) {
    const bool first = (m == 0) && (j0 == 0);
    const int q0 = (m & 1) ? (m - 1) / 2 + 1 : m / 2;
    const float w0 = first ? 1.f : ((m & 1) ? 0.75f : 0.25f);
    const float w1 = first ? 0.f : ((m & 1) ? 0.25f : 0.75f);
    const float a = first ? ra[1] : ra[q0], b = first ? ra[2] : ra[q0 + 1];
    const float c = first ? rb[1] : rb[q0], d = first ? rb[2] : rb[q0 + 1];
    out[m] = kF32 ? lerp2_f32(h0, h1, w0, w1, a, b, c, d) : lerp2(h0, h1, w0, w1, a, b, c, d);
  }
}

// The row pass alone (scale (2, 1)) at input columns clamp(j0 - 1 + q), q =
// 0 .. V + 1, from source rows ra, rb at (h0, h1), rounded to bf16. Its column
// taps are the identity's, (q, q + 1) at (1, 0), q + 1 clamped as ATen's.
template <int V>
__device__ __forceinline__ void resize_rows_bf16(const float (&ra)[V + 3],
                                                 const float (&rb)[V + 3], float h0, float h1,
                                                 float (&p)[V + 2]) {
#pragma unroll
  for (int q = 0; q < V + 2; ++q)
    p[q] = round_bf16(lerp2(h0, h1, 1.f, 0.f, ra[q], ra[q + 1], rb[q], rb[q + 1]));
}

// Output rows 2i, 2i + 1 and columns 2 j0 .. 2 j0 + 2V - 1 of y (NC x 2H x 2W)
// from x (NC x H x W). Tile row k holds input row clamp(i - 1 + k), tile
// column q input column clamp(j0 - 1 + q). Output row 2i reads source rows
// (i - 1, i) at (0.25, 0.75), row 0 reads (0, 1) at (1, 0); row 2i + 1 reads
// (i, i + 1) at (0.75, 0.25), the last row twice.
template <typename T, int V, bool kVec>
__global__ void __launch_bounds__(kThreads)
upsample2x_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, int NC, int H, int W) {
  const int G = W / V;
  const int idx = static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x);
  if (idx >= NC * H * G) return;
  const int g = idx % G, row = idx / G;
  const int i = row % H, nc = row / H;
  const int j0 = g * V;
  const T* xp = x + nc * H * W;
  float X[3][V + 3];
#pragma unroll
  for (int k = 0; k < 3; ++k) ld_tile_row<T, V>(xp + clampi(i - 1 + k, 0, H - 1) * W, j0, W, X[k]);
  const bool top = i == 0, bottom = i == H - 1;
  float A[V + 3], B[V + 3];  // the source rows of output row 2i
#pragma unroll
  for (int q = 0; q < V + 3; ++q) {
    A[q] = top ? X[1][q] : X[0][q];
    B[q] = top ? X[2][q] : X[1][q];
  }
  const float h0 = top ? 1.f : 0.25f, h1 = top ? 0.f : 0.75f;
  float out[2][2 * V];
  if constexpr (std::is_same_v<T, bf16>) {
    // the row pass at pass rows 2i, 2i + 1 and 2i + 2 (read at weight 0 by
    // output row 2i + 1; at the bottom that reads row 2i + 1 again), then the
    // column pass (scale (1, 2)), whose row taps are the identity's: output
    // row r reads pass rows r and r + 1 at (1, 0)
    float P[3][V + 2], Q[V + 2];
    resize_rows_bf16<V>(A, B, h0, h1, P[0]);
    resize_rows_bf16<V>(X[1], X[2], 0.75f, 0.25f, P[1]);
    resize_rows_bf16<V>(X[1], X[2], 0.25f, 0.75f, P[2]);
#pragma unroll
    for (int q = 0; q < V + 2; ++q) Q[q] = bottom ? P[1][q] : P[2][q];
    resize_cols<V, V + 2, false>(P[0], P[1], 1.f, 0.f, j0, out[0]);
    resize_cols<V, V + 2, false>(P[1], Q, 1.f, 0.f, j0, out[1]);
  } else {
    resize_cols<V, V + 3, true>(A, B, h0, h1, j0, out[0]);
    resize_cols<V, V + 3, true>(X[1], X[2], 0.75f, 0.25f, j0, out[1]);
  }
  T* yp = y + nc * 4 * H * W;
#pragma unroll
  for (int a = 0; a < 2; ++a) st_vec<2 * V, kVec>(yp, (2 * i + a) * 2 * W + 2 * j0, out[a]);
}

// -- backward -----------------------------------------------------------------

// The weights of one input index i of n along an axis for output indices
// 2i - 1 .. 2i + 2 (0 where that index lies outside [0, 2n)).
__device__ __forceinline__ void taps4(int i, int n, float* w) {
  const bool lo = i >= 1, hi = i <= n - 2;
  w[0] = lo ? 0.25f : 0.f;
  w[1] = lo ? 0.75f : 1.f;
  w[2] = hi ? 0.75f : 1.f;
  w[3] = hi ? 0.25f : 0.f;
}

// ((w0 a + w1 b) + w2 c) + w3 d, each product and sum rounded on its own.
__device__ __forceinline__ float dot4(const float* w, float a, float b, float c, float d) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(w[0], a), __fmul_rn(w[1], b)),
                             __fmul_rn(w[2], c)),
                   __fmul_rn(w[3], d));
}

// dx at input row i, columns j0 .. j0 + V - 1, from dy (NC x 2H x 2W).
template <typename T, int V, bool kVec>
__global__ void __launch_bounds__(kThreads)
upsample2x_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dx, int NC, int H, int W) {
  const int G = W / V;
  const int idx = static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x);
  if (idx >= NC * H * G) return;
  const int g = idx % G, row = idx / G;
  const int i = row % H, nc = row / H;
  const int j0 = g * V, H2 = 2 * H, W2 = 2 * W;
  const T* dp = dy + nc * H2 * W2;
  float wy[4];
  taps4(i, H, wy);
  // dy rows 2i - 1 .. 2i + 2 at columns 2 j0 - 1 .. 2 j0 + 2V (0 outside)
  float D[4][2 * V + 2];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int r = 2 * i - 1 + t;
    if (r < 0 || r >= H2) {
#pragma unroll
      for (int c = 0; c < 2 * V + 2; ++c) D[t][c] = 0.f;
      continue;
    }
    const T* rp = dp + r * W2;
    D[t][0] = j0 > 0 ? ld(rp, 2 * j0 - 1) : 0.f;
    if constexpr (kVec) {
#pragma unroll
      for (int c = 0; c < 2 * V; c += 4) ld_vec<4>(rp, 2 * j0 + c, D[t] + 1 + c);
    } else {
#pragma unroll
      for (int c = 0; c < 2 * V; ++c) D[t][1 + c] = ld(rp, 2 * j0 + c);
    }
    D[t][2 * V + 1] = 2 * j0 + 2 * V < W2 ? ld(rp, 2 * j0 + 2 * V) : 0.f;
  }
  float v[2 * V + 2];
#pragma unroll
  for (int c = 0; c < 2 * V + 2; ++c) v[c] = dot4(wy, D[0][c], D[1][c], D[2][c], D[3][c]);
  float out[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float wx[4];
    taps4(j0 + k, W, wx);
    out[k] = dot4(wx, v[2 * k], v[2 * k + 1], v[2 * k + 2], v[2 * k + 3]);
  }
  st_vec<V, kVec>(dx, nc * H * W + i * W + j0, out);
}

// -- launches -----------------------------------------------------------------

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int forward(const void* x, void* y, int NC, int H, int W, void* stream) {
  const bool vec = W % 4 == 0 && aligned16(x) && aligned16(y);
  const int groups = NC * H * (vec ? W / 4 : W);
  const int blocks = (groups + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xs = static_cast<const T*>(x);
  T* ys = static_cast<T*>(y);
  if (vec) upsample2x_fwd_kernel<T, 4, true><<<blocks, kThreads, 0, st>>>(xs, ys, NC, H, W);
  else upsample2x_fwd_kernel<T, 1, false><<<blocks, kThreads, 0, st>>>(xs, ys, NC, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* dy, void* dx, int NC, int H, int W, void* stream) {
  const bool vec = W % 4 == 0 && aligned16(dy) && aligned16(dx);
  const int groups = NC * H * (vec ? W / 4 : W);
  const int blocks = (groups + kThreads - 1) / kThreads;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* ds = static_cast<const T*>(dy);
  T* xs = static_cast<T*>(dx);
  if (vec) upsample2x_bwd_kernel<T, 4, true><<<blocks, kThreads, 0, st>>>(ds, xs, NC, H, W);
  else upsample2x_bwd_kernel<T, 1, false><<<blocks, kThreads, 0, st>>>(ds, xs, NC, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (NC x 2H x 2W, contiguous) = the 2x bilinear upsample of x (NC x H x W,
// contiguous), f32 or bf16; NC x 4 H W < 2^31. Returns the cudaError_t of
// the launch (0 on success).
int wtpse_upsample2x_forward_f32(const void* x, void* y, int NC, int H, int W, void* stream) {
  return forward<float>(x, y, NC, H, W, stream);
}

int wtpse_upsample2x_forward_bf16(const void* x, void* y, int NC, int H, int W, void* stream) {
  return forward<bf16>(x, y, NC, H, W, stream);
}

// dx (NC x H x W, contiguous) = the upsample's input gradient from dy
// (NC x 2H x 2W, contiguous), both of one type, f32 or bf16.
int wtpse_upsample2x_backward_f32(const void* dy, void* dx, int NC, int H, int W, void* stream) {
  return backward<float>(dy, dx, NC, H, W, stream);
}

int wtpse_upsample2x_backward_bf16(const void* dy, void* dx, int NC, int H, int W,
                                   void* stream) {
  return backward<bf16>(dy, dx, NC, H, W, stream);
}

}  // extern "C"
