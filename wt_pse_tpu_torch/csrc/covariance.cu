// Per-sample feature covariance for the whitening losses, written by hand for
// Hopper (sm_90a). Built by ops/covariance_cuda.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C entry points below).
//
// Input: the NCHW map the port's convs emit, viewed as z (B, C, HW), C <= 32,
// f32, rows contiguous.
//
// Kernel 1, the Gram (replaces _gram / _gram_kernel in
// wt_pse_tpu/ops/whitening_pallas.py:45-89, with _fwd_impl's scaling at 135-138):
//   cov[b] = z[b] z[b]^T / (HW - 1) + 1e-5 I
// Kernel 2, the backward (replaces _dz / _dz_kernel, whitening_pallas.py:92-120,
// called from _bwd at 145-149):
//   dz[b] = S[b] z[b],  S[b] = (g[b] + g[b]^T) / (HW - 1)
//
// Bounds. Both are bound by memory traffic: at the main-path shape
// (B=9, C=16, HW=65536, f32) the Gram reads 37.7 MB and does 2*B*C*C*HW =
// 302 MFLOP, so 3.35 TB/s gives ~11 us and 67 TFLOP/s (f32, no tensor cores)
// ~4.5 us; dz reads 37.7 MB and writes 37.7 MB, ~23 us.
//
// Design. The Pallas kernel carries a VMEM accumulator from one HW tile to the
// next along a sequential grid axis; GPU blocks run in no order, so the Gram is
// two passes. Pass 1: a grid over (HW chunk, b); each block stages a (C x 256)
// tile of z in shared memory (coalesced rows, masked ragged tail instead of
// the TPU's padded copy), and each of 256 threads accumulates up to four (c, d)
// products over the chunk in f32 FMA, writing one partial C x C per block to
// scratch the wrapper allocates. Pass 2 sums the partials of a sample in a
// fixed order and applies the scaling. No atomics, so the result is
// deterministic; no TF32 or tensor cores, so f32 stays IEEE f32 like the
// HIGHEST pin of the JAX kernel. dz runs one thread per pixel: the C inputs of
// a pixel sit in registers, S in shared memory, and every load and store is
// coalesced along HW, so the kernel reads and writes each byte of z and dz
// once. What it does not do yet: vectorised (16-byte) loads, TMA, and a
// register-tiled Gram that reads fewer shared-memory words per FMA.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxC = 32;
constexpr int kThreads = 256;
constexpr int kTileP = 256;   // pixels staged in shared memory per step
constexpr int kChunkP = 1024; // pixels one block of pass 1 reduces
constexpr int kPairsPerThread = kMaxC * kMaxC / kThreads;

__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const float* __restrict__ z, float* __restrict__ partial,
                    int C, int HW, int n_chunks) {
  // +1 column: threads of a warp read rows d = 0..C-1 at one pixel, which
  // then fall in distinct banks
  __shared__ float tile[kMaxC][kTileP + 1];
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int tid = threadIdx.x;
  const int pairs = C * C;
  const float* zb = z + (size_t)b * C * HW;
  const int p_begin = chunk * kChunkP;
  const int p_end = min(p_begin + kChunkP, HW);

  float acc[kPairsPerThread];
  int row_c[kPairsPerThread], row_d[kPairsPerThread];
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) {
    const int pair = tid + k * kThreads;
    acc[k] = 0.f;
    row_c[k] = pair < pairs ? pair / C : 0;
    row_d[k] = pair < pairs ? pair % C : 0;
  }

  for (int p0 = p_begin; p0 < p_end; p0 += kTileP) {
    const int p = p0 + tid;
    for (int c = 0; c < C; ++c)
      tile[c][tid] = p < p_end ? zb[(size_t)c * HW + p] : 0.f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPairsPerThread; ++k) {
      if (tid + k * kThreads < pairs) {
        const float* rc = tile[row_c[k]];
        const float* rd = tile[row_d[k]];
        float a = acc[k];
#pragma unroll 8
        for (int j = 0; j < kTileP; ++j) a = fmaf(rc[j], rd[j], a);
        acc[k] = a;
      }
    }
    __syncthreads();
  }

  float* out = partial + ((size_t)b * n_chunks + chunk) * pairs;
#pragma unroll
  for (int k = 0; k < kPairsPerThread; ++k) {
    const int pair = tid + k * kThreads;
    if (pair < pairs) out[pair] = acc[k];
  }
}

__global__ void __launch_bounds__(kThreads)
gram_finish_kernel(const float* __restrict__ partial, float* __restrict__ out,
                   int C, int n_chunks, float n_minus_1, float eps) {
  const int b = blockIdx.x;
  const int pairs = C * C;
  for (int pair = threadIdx.x; pair < pairs; pair += blockDim.x) {
    const float* src = partial + (size_t)b * n_chunks * pairs + pair;
    float s = 0.f;
    for (int k = 0; k < n_chunks; ++k) s += src[(size_t)k * pairs];
    const int c = pair / C, d = pair % C;
    out[(size_t)b * pairs + pair] = s / n_minus_1 + (c == d ? eps : 0.f);
  }
}

__global__ void __launch_bounds__(kThreads)
dz_kernel(const float* __restrict__ z, const float* __restrict__ g,
          float* __restrict__ dz, int C, int HW, float n_minus_1) {
  __shared__ float s[kMaxC][kMaxC + 1];
  const int b = blockIdx.y;
  const float* gb = g + (size_t)b * C * C;
  for (int i = threadIdx.x; i < C * C; i += blockDim.x) {
    const int c = i / C, d = i % C;
    s[c][d] = (gb[c * C + d] + gb[d * C + c]) / n_minus_1;
  }
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= HW) return;
  const float* zb = z + (size_t)b * C * HW + p;
  float* ob = dz + (size_t)b * C * HW + p;
  float zr[kMaxC];
#pragma unroll
  for (int d = 0; d < kMaxC; ++d) zr[d] = d < C ? zb[(size_t)d * HW] : 0.f;
  for (int c = 0; c < C; ++c) {
    float a = 0.f;
#pragma unroll
    for (int d = 0; d < kMaxC; ++d)
      if (d < C) a = fmaf(s[c][d], zr[d], a);
    ob[(size_t)c * HW] = a;
  }
}

}  // namespace

extern "C" {

// Pixels per pass-1 block: the wrapper sizes the partials scratch with it.
int wtpse_covariance_chunk(void) { return kChunkP; }

int wtpse_covariance_max_c(void) { return kMaxC; }

// cov (B, C, C) = z z^T / (HW - 1) + eps I. partial: (B, ceil(HW / chunk), C*C).
// Returns the cudaError_t of the launches (0 on success).
int wtpse_covariance_gram_f32(const float* z, float* partial, float* cov,
                              int B, int C, int HW, float eps, void* stream) {
  const int n_chunks = (HW + kChunkP - 1) / kChunkP;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gram_partial_kernel<<<dim3(n_chunks, B), kThreads, 0, st>>>(z, partial, C, HW,
                                                             n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_finish_kernel<<<B, kThreads, 0, st>>>(partial, cov, C, n_chunks,
                                             static_cast<float>(HW - 1), eps);
  return static_cast<int>(cudaGetLastError());
}

// dz (B, C, HW) = S z with S = (g + g^T) / (HW - 1), g (B, C, C).
int wtpse_covariance_dz_f32(const float* z, const float* g, float* dz,
                            int B, int C, int HW, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dz_kernel<<<dim3((HW + kThreads - 1) / kThreads, B), kThreads, 0, st>>>(
      z, g, dz, C, HW, static_cast<float>(HW - 1));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
