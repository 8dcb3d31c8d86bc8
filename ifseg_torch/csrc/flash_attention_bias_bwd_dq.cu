// Attention backward, dq and dbias, for Hopper (sm_90a).
//
// Replaces ifseg_tpu/ops/flash_attention.py::_bwd_dq_dbias_kernel (the TPU
// Pallas kernel behind the custom_vjp of flash_attention_bias_packed_stats).
// Per batch row b and head h it rebuilds the probabilities from the row
// logsumexp that the forward saved,
//
//     p  = exp(q·kᵀ + bias[h] + mask_row[b] (causal, offset lk-lq) − lse)
//     dp = do·vᵀ,   ds = p ∘ (dp − di),   di = rowsum(do ∘ out)
//     dq = ds·k,    dbias[h] = Σ_b ds
//
// in the packed layout: q/do/dq (B, Lq, H·64), k/v (B, Lk, H·64) bf16; bias
// (H, Lq, Lk) bf16 or fp32; lse/di (B, H, Lq) fp32.  The probabilities and ds
// never reach device memory.  This file also holds the small pre-pass that
// computes di from do and the saved output (the JAX package computes it
// outside its kernels too).
//
// What bounds it on this card.  At the training shapes (B=16, H=12, D=64,
// Lq/Lk about 1025-1056) one call does three 64-deep products over every
// visible (q, k) pair, 39-82 GFLOP, over about 180 MB of operands and
// results: bound by the tensor cores (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s).
//
// Design.
//   * One CTA owns a 64-row query tile of one (b, h): grid (B, q-tiles, H),
//     batch fastest-varying, as the forward.  Its q and do fragments stay in
//     registers; K/V stream in 64-key tiles through a two-stage cp.async ring;
//     dq accumulates in registers and is written once.
//   * dbias is a sum over the batch, which the TPU kernel gets from its
//     sequential grid and a VMEM scratch.  Here the B CTAs of one (h, q-tile)
//     run concurrently, so each adds its ds tile with fp32 vector atomics
//     (atomicAdd on float2) into an fp32 workspace (H, LqP, LkP) with both
//     lengths padded to the tile, which keeps every atomic 8-byte aligned and
//     in bounds without a mask.  The wrapper zeroes the workspace and rounds
//     it once to the bias dtype: the sum is in fp32 and rounded once, as on
//     the TPU, but its order, and so its last bits, change from run to run.
//     The batch-fastest grid makes the 16 adds to one address meet in L2.
//     The alternative, a CTA per (h, q-tile, k-tile) that loops over the
//     batch, keeps dbias in registers but then needs the same number of
//     atomics for dq, and reloads Q, dO, K and V per step instead of K and V.
//   * Without a bias gradient (bias absent, or not requiring one) the DBIAS
//     instantiation is not used and no workspace is touched.
//   * Ragged edges are masked here: rows past Lq are zero-filled and get
//     lse = +inf (p = 0), keys past Lk get −inf; nothing is padded outside.
//   * Under causal masking the loop ends at the last key tile any row sees.

#include "attn_mma.cuh"

namespace {

using namespace attn;

constexpr int LDB = BN + 8;  // fp32 pitch of the bias tile: conflict-free float2 reads
constexpr size_t SMEM_BYTES =
    (size_t)(2 * BM * LDS + 4 * BN * LDS) * sizeof(bf16) + (size_t)(BM * LDB + BN) * sizeof(float);

// addr is 8-byte aligned: the workspace pitch and the column are even
__device__ __forceinline__ void red_add_v2(float* addr, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(addr), make_float2(a, b));
}

template <typename BiasT, bool DBIAS>
__global__ void __launch_bounds__(NTHREADS)
attn_bias_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const BiasT* __restrict__ bias,
                        const uint8_t* __restrict__ mask, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        bf16* __restrict__ dq, float* __restrict__ dbias_ws,
                        int H, int Lq, int Lk, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + BM * LDS;
  bf16* k_s = do_s + BM * LDS;     // two stages of BN * LDS
  bf16* v_s = k_s + 2 * BN * LDS;  // two stages of BN * LDS
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * BN * LDS);
  float* keymask_s = bias_s + BM * LDB;

  const int b = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int h = blockIdx.z;
  const int ld = H * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r_lo = warp * 16 + g;

  const bf16* kg = k + (size_t)b * Lk * ld + h * D;
  const bf16* vg = v + (size_t)b * Lk * ld + h * D;
  const BiasT* bias_h = bias == nullptr ? nullptr : bias + ((size_t)h * Lq + m0) * Lk;

  const int off = Lk - Lq;
  int n_tiles = (Lk + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (m0 + BM - 1 + off) / BN + 1);

  auto load_kv = [&](int j) {
    const int n0 = j * BN;
    const int valid = min(BN, Lk - n0);
    copy_tile_async(k_s + (j & 1) * BN * LDS, kg + (size_t)n0 * ld, ld, valid);
    copy_tile_async(v_s + (j & 1) * BN * LDS, vg + (size_t)n0 * ld, ld, valid);
    cp_async_commit();
  };

  {
    const int valid = min(BM, Lq - m0);
    copy_tile_async(q_s, q + ((size_t)b * Lq + m0) * ld + h * D, ld, valid);
    copy_tile_async(do_s, dout + ((size_t)b * Lq + m0) * ld + h * D, ld, valid);
    cp_async_commit();
  }
  load_kv(0);
  cp_async_wait<1>();  // q and do have landed
  __syncthreads();

  uint32_t qf[D / 16][4], dof[D / 16][4];
  load_a_frags(qf, q_s, r_lo, t);
  load_a_frags(dof, do_s, r_lo, t);

  // this thread's two rows: lse in log2 units (+inf past Lq, so p = 0) and di
  float lse2[2], di_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + r_lo + 8 * i;
    const size_t idx = ((size_t)b * H + h) * Lq + row;
    lse2[i] = row < Lq ? lse[idx] * LOG2E : INFINITY;
    di_r[i] = row < Lq ? di[idx] : 0.f;
  }

  // this CTA's rows of the padded dbias workspace (H, LqP, LkP)
  const int LkP = ((Lk + BN - 1) / BN) * BN;
  const int LqP = ((Lq + BM - 1) / BM) * BM;
  float* ws_tile = DBIAS ? dbias_ws + ((size_t)h * LqP + m0) * LkP : nullptr;

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BN;
    // bias tile and key mask of tile j -> shared memory (coalesced along keys)
    if (bias_h != nullptr) {
#pragma unroll 8
      for (int i = threadIdx.x; i < BM * BN; i += NTHREADS) {
        const int r = i / BN, c = i % BN;
        float x = 0.f;
        if (m0 + r < Lq && n0 + c < Lk) x = to_float(bias_h[(size_t)r * Lk + n0 + c]);
        bias_s[r * LDB + c] = x;
      }
    }
    if (threadIdx.x < BN) {
      const int key = n0 + threadIdx.x;
      float km = -INFINITY;
      if (key < Lk) km = (mask != nullptr && mask[(size_t)b * Lk + key]) ? NEG_INF : 0.f;
      keymask_s[threadIdx.x] = km;
    }
    if (j + 1 < n_tiles) {
      load_kv(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = k_s + (j & 1) * BN * LDS;
    const bf16* vs = v_s + (j & 1) * BN * LDS;

    float s[BN / 8][4], dp[BN / 8][4];
    mma_a_bt(s, qf, ks, lane);    // q·kᵀ
    mma_a_bt(dp, dof, vs, lane);  // do·vᵀ

#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = r_lo + half * 8;
        const int cl = nt * 8 + 2 * t;
        float x0 = s[nt][2 * half], x1 = s[nt][2 * half + 1];
        if (bias_h != nullptr) {
          const float2 bb = *reinterpret_cast<const float2*>(bias_s + rl * LDB + cl);
          x0 += bb.x;
          x1 += bb.y;
        }
        if (causal) {
          if (n0 + cl > m0 + rl + off) x0 = NEG_INF;
          if (n0 + cl + 1 > m0 + rl + off) x1 = NEG_INF;
        }
        x0 += keymask_s[cl];
        x1 += keymask_s[cl + 1];
        const float p0 = exp2f(fmaf(x0, LOG2E, -lse2[half]));
        const float p1 = exp2f(fmaf(x1, LOG2E, -lse2[half]));
        const float d0 = p0 * (dp[nt][2 * half] - di_r[half]);
        const float d1 = p1 * (dp[nt][2 * half + 1] - di_r[half]);
        s[nt][2 * half] = d0;
        s[nt][2 * half + 1] = d1;
        if constexpr (DBIAS) red_add_v2(ws_tile + (size_t)rl * LkP + n0 + cl, d0, d1);
      }
    }

    mma_p_b(acc, s, ks, lane);  // dq += ds·k
    __syncthreads();
  }

  const int row0 = m0 + r_lo;
  const int row1 = row0 + 8;
  bf16* dqg = dq + (size_t)b * Lq * ld + h * D + 2 * t;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    if (row0 < Lq)
      *reinterpret_cast<uint32_t*>(dqg + (size_t)row0 * ld + nt * 8) =
          pack_f32(acc[nt][0], acc[nt][1]);
    if (row1 < Lq)
      *reinterpret_cast<uint32_t*>(dqg + (size_t)row1 * ld + nt * 8) =
          pack_f32(acc[nt][2], acc[nt][3]);
  }
}

// di[b, h, i] = Σ_d do[b, i, h·64 + d] · out[b, i, h·64 + d], in fp32: one
// warp per (b, i, h), one bf16 pair per lane.
__global__ void attn_bwd_di_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ out,
                                   float* __restrict__ di, int H, int Lq) {
  const int h = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row = blockIdx.x;  // b * Lq + i
  const size_t o = row * H * D + h * D + 2 * lane;
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + o));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(out + o));
  float sum = a.x * c.x + a.y * c.y;
#pragma unroll
  for (int sft = 16; sft > 0; sft >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, sft);
  if (lane == 0) {
    const size_t bi = row / Lq, i = row % Lq;
    di[(bi * H + h) * Lq + i] = sum;
  }
}

template <typename BiasT, bool DBIAS>
int launch(const bf16* q, const bf16* k, const bf16* v, const void* bias, const uint8_t* mask,
           const bf16* dout, const float* lse, const float* di, bf16* dq, float* ws, int B,
           int H, int Lq, int Lk, int causal, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      attn_bias_bwd_dq_kernel<BiasT, DBIAS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B, (Lq + BM - 1) / BM, H);
  attn_bias_bwd_dq_kernel<BiasT, DBIAS><<<grid, NTHREADS, SMEM_BYTES, st>>>(
      q, k, v, static_cast<const BiasT*>(bias), mask, dout, lse, di, dq, ws, H, Lq, Lk, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dq (and, when dbias_ws is not null, Σ_b ds added into the zeroed fp32
// workspace (H, ceil64(Lq), ceil64(Lk))).  Launches on `stream`; returns
// cudaGetLastError() (0 = launched).  bias and mask may be null.
extern "C" int flash_attention_bias_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* bias, int bias_fp32, const void* mask,
                                           const void* dout, const void* lse, const void* di,
                                           void* dq, void* dbias_ws, int B, int H, int Lq,
                                           int Lk, int causal, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  const bf16* gp = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(di);
  bf16* dqp = static_cast<bf16*>(dq);
  float* ws = static_cast<float*>(dbias_ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ws != nullptr && bias == nullptr) return static_cast<int>(cudaErrorInvalidValue);
#define ATTN_BWD_DQ(T, DB) \
  launch<T, DB>(qp, kp, vp, bias, mp, gp, lp, dp, dqp, ws, B, H, Lq, Lk, causal, st)
  if (ws != nullptr) return bias_fp32 ? ATTN_BWD_DQ(float, true) : ATTN_BWD_DQ(bf16, true);
  return bias_fp32 ? ATTN_BWD_DQ(float, false) : ATTN_BWD_DQ(bf16, false);
#undef ATTN_BWD_DQ
}

// di (B, H, Lq) fp32 from do and out (B, Lq, H·64) bf16.
extern "C" int flash_attention_bwd_di(const void* dout, const void* out, void* di, int B, int H,
                                      int Lq, void* stream) {
  if (H < 1 || H > 32) return static_cast<int>(cudaErrorInvalidValue);
  attn_bwd_di_kernel<<<(unsigned)(B * Lq), H * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(dout), static_cast<const bf16*>(out), static_cast<float*>(di), H,
      Lq);
  return static_cast<int>(cudaGetLastError());
}
