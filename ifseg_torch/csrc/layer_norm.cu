// One-pass LayerNorm over the last axis, for Hopper (sm_90a).
//
// Replaces ifseg_tpu/ops/layer_norm.py::_ln_kernel (the TPU Pallas kernel
// behind fused_layer_norm).  For every row of x (N, D):
//
//     mu  = mean(x),  var = mean(x²) − mu²          (fp32, the fast variance)
//     y   = (x − mu) · rsqrt(var + eps) · scale + bias
//
// x is bf16 or fp32 and is widened to fp32 in registers; scale and bias are
// fp32 (D,); y is written once, in bf16 or fp32.  It is what an fp32
// LayerNorm between two dtype casts computes, in one pass over the memory.
//
// What bounds it on this card.  Two flops per byte at most: the kernel is
// bound by device memory (H100 SXM: 3.35 TB/s).  The least work is x read
// once and y written once, 104 MB at the model's largest site of width 768
// (33,792 rows, bf16 in and out), 415 MB at width 3,072, and 173 MB at one
// ffn_layernorm site of SegOFA-Huge served at batch 8 (8,448 rows x 5,120).
//
// Design.
//   * One warp owns one row and keeps all of it in registers: each lane
//     loads CPL groups of 8 consecutive elements with 16-byte loads (one
//     uint4 for bf16, two float4 for fp32), lane l taking groups l, l + 32,
//     ..., so a warp's loads are contiguous.  All loads of a row are started
//     before the first use.  768 columns are 3 groups a lane, 3,072 are 12.
//   * The two row sums are reduced with warp shuffles; no shared memory, no
//     block synchronisation, nothing carried between rows.
//   * The row is normalised from the registers and stored with 16-byte
//     stores; scale and bias are read per group and stay in L1/L2.
//   * CPL is a template parameter (1, 2, 3, 4, 6, 8, 12, 16); the entry picks
//     the smallest one that covers D / 8 groups, so every multiple of 8 up
//     to 4,096 is supported and the tail groups are predicated off.
//   * The TPU kernel's row block (sized for VMEM) has no counterpart: four
//     warps of a block are four independent rows.
//   * Rows wider than 4,096 (SegOFA-Huge's ffn_layernorm is 5,120) no longer
//     fit one warp's registers.  There one CTA of WIDE_THREADS threads owns a
//     row: thread t holds groups t, t + 256, ... (CPT of them, a template
//     parameter: 3, 4, 6 or 8, up to MAX_WIDE_WIDTH = 16,384), loaded and
//     stored with the same 16-byte accesses; the two sums go through warp
//     shuffles, then through shared memory across the eight warps, which
//     every thread reads in the same order, so all hold the same mu and r.
//     The same fast variance and one rounding of y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // rows per block
constexpr int MAX_WIDTH = 4096;  // of the warp-per-row kernel
constexpr int WIDE_THREADS = 256;  // a row of the CTA-per-row kernel
constexpr int WIDE_WARPS = WIDE_THREADS / 32;
constexpr int MAX_WIDE_WIDTH = 16384;  // 8 groups of 8 a thread

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename TIn, typename TOut, int CPL>
__global__ void __launch_bounds__(WARPS * 32)
layer_norm_kernel(const TIn* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, TOut* __restrict__ y,
                  long long n, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps leave together: the shuffles below stay full
  const int groups = d >> 3;
  const TIn* xr = x + row * d;
  TOut* yr = y + row * d;

  float v[CPL][8];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int g = lane + 32 * c;
    if (g < groups) {
      load8(xr + 8 * g, v[c]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[c][i] = 0.f;
    }
  }

  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += v[c][i];
      ss += v[c][i] * v[c][i];
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float inv_d = 1.f / (float)d;
  const float mu = s * inv_d;
  const float var = ss * inv_d - mu * mu;
  const float r = rsqrtf(var + eps);

#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int g = lane + 32 * c;
    if (g < groups) {
      float w[8], b[8], out[8];
      load8(scale + 8 * g, w);
      load8(bias + 8 * g, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = (v[c][i] - mu) * r * w[i] + b[i];
      store8(yr + 8 * g, out);
    }
  }
}

// One CTA per row (rows wider than MAX_WIDTH): CPT groups of 8 a thread.
template <typename TIn, typename TOut, int CPT>
__global__ void __launch_bounds__(WIDE_THREADS)
layer_norm_wide_kernel(const TIn* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, TOut* __restrict__ y, int d, float eps) {
  __shared__ float partial[2][WIDE_WARPS];
  const int tid = threadIdx.x;
  const int groups = d >> 3;
  const TIn* xr = x + (long long)blockIdx.x * d;
  TOut* yr = y + (long long)blockIdx.x * d;

  float v[CPT][8];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int g = tid + WIDE_THREADS * c;
    if (g < groups) {
      load8(xr + 8 * g, v[c]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[c][i] = 0.f;
    }
  }

  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s += v[c][i];
      ss += v[c][i] * v[c][i];
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if ((tid & 31) == 0) {
    partial[0][tid >> 5] = s;
    partial[1][tid >> 5] = ss;
  }
  __syncthreads();
  s = ss = 0.f;
#pragma unroll
  for (int w = 0; w < WIDE_WARPS; ++w) {
    s += partial[0][w];
    ss += partial[1][w];
  }
  const float inv_d = 1.f / (float)d;
  const float mu = s * inv_d;
  const float var = ss * inv_d - mu * mu;
  const float r = rsqrtf(var + eps);

#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int g = tid + WIDE_THREADS * c;
    if (g < groups) {
      float w[8], b[8], out[8];
      load8(scale + 8 * g, w);
      load8(bias + 8 * g, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = (v[c][i] - mu) * r * w[i] + b[i];
      store8(yr + 8 * g, out);
    }
  }
}

template <typename TIn, typename TOut, int CPT>
cudaError_t launch_wide(const void* x, const void* scale, const void* bias, void* y,
                        long long n, int d, float eps, cudaStream_t stream) {
  layer_norm_wide_kernel<TIn, TOut, CPT><<<(unsigned)n, WIDE_THREADS, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<TOut*>(y), d, eps);
  return cudaGetLastError();
}

template <typename TIn, typename TOut, int CPL>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* y,
                   long long n, int d, float eps, cudaStream_t stream) {
  const long long blocks = (n + WARPS - 1) / WARPS;
  layer_norm_kernel<TIn, TOut, CPL><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<TOut*>(y), n, d, eps);
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t dispatch(const void* x, const void* scale, const void* bias, void* y,
                     long long n, int d, float eps, cudaStream_t stream) {
  if (d <= MAX_WIDTH) {
    const int per_lane = (d / 8 + 31) / 32;  // 8-element groups a lane must hold
#define LN_CASE(C) \
  if (per_lane <= C) return launch<TIn, TOut, C>(x, scale, bias, y, n, d, eps, stream);
    LN_CASE(1) LN_CASE(2) LN_CASE(3) LN_CASE(4) LN_CASE(6) LN_CASE(8) LN_CASE(12) LN_CASE(16)
#undef LN_CASE
  }
  const int per_thread = (d / 8 + WIDE_THREADS - 1) / WIDE_THREADS;  // above 4,096: 3 or more
#define LN_WIDE_CASE(C) \
  if (per_thread <= C) return launch_wide<TIn, TOut, C>(x, scale, bias, y, n, d, eps, stream);
  LN_WIDE_CASE(3) LN_WIDE_CASE(4) LN_WIDE_CASE(6) LN_WIDE_CASE(8)
#undef LN_WIDE_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// y = LayerNorm(x) over rows of width d; x and y bf16 (flag 0) or fp32 (flag
// 1), scale and bias fp32.  Every pointer 16-byte aligned, d a multiple of 8
// up to 16,384 (a warp a row up to 4,096, a CTA a row above), rows dense.
// Returns the cudaError of the launch (0 = ok).
extern "C" int layer_norm_fwd(const void* x, const void* scale, const void* bias, void* y,
                              long long n, int d, float eps, int in_fp32, int out_fp32,
                              void* stream) {
  if (n < 1 || d < 8 || d % 8 != 0 || d > MAX_WIDE_WIDTH) return (int)cudaErrorInvalidValue;
  if ((d <= MAX_WIDTH ? (n + WARPS - 1) / WARPS : n) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_fp32) {
    err = out_fp32 ? dispatch<float, float>(x, scale, bias, y, n, d, eps, s)
                   : dispatch<float, __nv_bfloat16>(x, scale, bias, y, n, d, eps, s);
  } else {
    err = out_fp32 ? dispatch<__nv_bfloat16, float>(x, scale, bias, y, n, d, eps, s)
                   : dispatch<__nv_bfloat16, __nv_bfloat16>(x, scale, bias, y, n, d, eps, s);
  }
  return (int)err;
}
