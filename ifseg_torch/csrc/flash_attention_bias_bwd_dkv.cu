// Attention backward, dk and dv, for Hopper (sm_90a).
//
// Replaces ifseg_tpu/ops/flash_attention.py::_bwd_dkv_kernel (the TPU Pallas
// kernel behind the custom_vjp of flash_attention_bias_packed_stats).  With
// the same recompute as the dq kernel,
//
//     p  = exp(q·kᵀ + bias[h] + mask_row[b] (causal, offset lk-lq) − lse)
//     dp = do·vᵀ,   ds = p ∘ (dp − di)
//     dv = pᵀ·do,   dk = dsᵀ·q      (summed over all query rows)
//
// in the packed layout: q/do (B, Lq, H·64), k/v/dk/dv (B, Lk, H·64) bf16;
// bias (H, Lq, Lk) bf16 or fp32; lse/di (B, H, Lq) fp32.
//
// What bounds it on this card.  Four 64-deep products over every visible
// (q, k) pair, 52-110 GFLOP at the training shapes (B=16, H=12, Lq/Lk about
// 1025-1056) over about 180 MB of operands and results: bound by the tensor cores
// (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s).
//
// Design.
//   * One CTA owns a 64-key tile of one (b, h) and loops over the query
//     tiles, so dk and dv accumulate in registers and are written once, with
//     no atomics: the loop takes the place of the TPU grid (h, b, i) with the
//     query block innermost.  Grid (B, k-tiles, H), batch fastest-varying, so
//     the CTAs that read one bias tile run together and find it in L2.
//   * Everything is computed transposed, keys as the M dimension: each warp
//     holds the K and V fragments of its 16 keys in registers for the whole
//     kernel and computes sᵀ = k·qᵀ and dpᵀ = v·doᵀ against the streamed Q and
//     dO tiles.  The pᵀ and dsᵀ accumulators are then already laid out as the
//     A operand of pᵀ·do and dsᵀ·q, with no transpose through shared memory.
//   * Q and dO stream in 64-row tiles through a two-stage cp.async ring; the
//     bias tile is staged in shared memory as fp32 with a pitch (68) that
//     makes the transposed reads conflict-free; lse and di of the tile's rows
//     sit beside it.
//   * Ragged edges are masked here: query rows past Lq are zero-filled and
//     get lse = +inf (p = 0); keys past Lk get −inf and are never stored.
//   * Under causal masking the loop starts at the first query tile that sees
//     any key of the tile.

#include "attn_mma.cuh"

namespace {

using namespace attn;

constexpr int LDB = BN + 4;  // fp32 pitch of the bias tile: conflict-free transposed reads
constexpr size_t SMEM_BYTES =
    (size_t)(2 * BN * LDS + 4 * BM * LDS) * sizeof(bf16) + (size_t)(BM * LDB + 2 * BM) * sizeof(float);

template <typename BiasT>
__global__ void __launch_bounds__(NTHREADS)
attn_bias_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const BiasT* __restrict__ bias,
                         const uint8_t* __restrict__ mask, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         int H, int Lq, int Lk, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + BN * LDS;
  bf16* q_s = v_s + BN * LDS;       // two stages of BM * LDS
  bf16* do_s = q_s + 2 * BM * LDS;  // two stages of BM * LDS
  float* bias_s = reinterpret_cast<float*>(do_s + 2 * BM * LDS);
  float* lse_s = bias_s + BM * LDB;  // log2 units; +inf past Lq
  float* di_s = lse_s + BM;

  const int b = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int h = blockIdx.z;
  const int ld = H * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r_lo = warp * 16 + g;  // tile key of accumulator elements 0/1; +8 for 2/3

  const bf16* qg = q + (size_t)b * Lq * ld + h * D;
  const bf16* dog = dout + (size_t)b * Lq * ld + h * D;
  const float* lse_bh = lse + ((size_t)b * H + h) * Lq;
  const float* di_bh = di + ((size_t)b * H + h) * Lq;
  const BiasT* bias_h = bias == nullptr ? nullptr : bias + (size_t)h * Lq * Lk + n0;

  const int off = Lk - Lq;  // causal: key j is visible to row i iff j <= i + off
  const int m_tiles = (Lq + BM - 1) / BM;
  int j0 = 0;
  if (causal) j0 = max(0, n0 - off) / BM;

  auto load_q = [&](int j) {
    const int m0 = j * BM;
    const int valid = min(BM, Lq - m0);
    copy_tile_async(q_s + (j & 1) * BM * LDS, qg + (size_t)m0 * ld, ld, valid);
    copy_tile_async(do_s + (j & 1) * BM * LDS, dog + (size_t)m0 * ld, ld, valid);
    cp_async_commit();
  };

  {
    const int valid = min(BN, Lk - n0);
    copy_tile_async(k_s, k + ((size_t)b * Lk + n0) * ld + h * D, ld, valid);
    copy_tile_async(v_s, v + ((size_t)b * Lk + n0) * ld + h * D, ld, valid);
    cp_async_commit();
  }
  if (j0 < m_tiles) load_q(j0);
  else cp_async_commit();
  cp_async_wait<1>();  // k and v have landed
  __syncthreads();

  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_frags(kf, k_s, r_lo, t);
  load_a_frags(vf, v_s, r_lo, t);

  // this thread's two keys: 0, -1e9 (padding) or -inf (past Lk)
  float km[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = n0 + r_lo + 8 * i;
    km[i] = -INFINITY;
    if (key < Lk) km[i] = (mask != nullptr && mask[(size_t)b * Lk + key]) ? NEG_INF : 0.f;
  }

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    dk_acc[nt][0] = dk_acc[nt][1] = dk_acc[nt][2] = dk_acc[nt][3] = 0.f;
    dv_acc[nt][0] = dv_acc[nt][1] = dv_acc[nt][2] = dv_acc[nt][3] = 0.f;
  }

  for (int j = j0; j < m_tiles; ++j) {
    const int m0 = j * BM;
    // bias tile (query rows x this CTA's keys), lse and di of tile j -> shared memory
    if (bias_h != nullptr) {
#pragma unroll 8
      for (int i = threadIdx.x; i < BM * BN; i += NTHREADS) {
        const int r = i / BN, c = i % BN;
        float x = 0.f;
        if (m0 + r < Lq && n0 + c < Lk) x = to_float(bias_h[(size_t)(m0 + r) * Lk + c]);
        bias_s[r * LDB + c] = x;
      }
    }
    if (threadIdx.x < BM) {
      const int row = m0 + threadIdx.x;
      lse_s[threadIdx.x] = row < Lq ? lse_bh[row] * LOG2E : INFINITY;
      di_s[threadIdx.x] = row < Lq ? di_bh[row] : 0.f;
    }
    if (j + 1 < m_tiles) {
      load_q(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = q_s + (j & 1) * BM * LDS;
    const bf16* dos = do_s + (j & 1) * BM * LDS;

    // transposed tiles: element [nt][e] is key r_lo + 8*(e>>1), query row nt*8 + 2t + (e&1)
    float st[BM / 8][4], dpt[BM / 8][4];
    mma_a_bt(st, kf, qs, lane);    // k·qᵀ
    mma_a_bt(dpt, vf, dos, lane);  // v·doᵀ

#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = r_lo + 8 * (e >> 1);
        const int ql = nt * 8 + 2 * t + (e & 1);
        float x = st[nt][e];
        if (bias_h != nullptr) x += bias_s[ql * LDB + kl];
        if (causal && n0 + kl > m0 + ql + off) x = NEG_INF;
        x += km[e >> 1];
        const float p = exp2f(fmaf(x, LOG2E, -lse_s[ql]));
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - di_s[ql]);
      }
    }

    mma_p_b(dv_acc, st, dos, lane);  // dv += pᵀ·do
    mma_p_b(dk_acc, dpt, qs, lane);  // dk += dsᵀ·q
    __syncthreads();
  }

  const int key0 = n0 + r_lo;
  const int key1 = key0 + 8;
  const size_t base = (size_t)b * Lk * ld + h * D + 2 * t;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    if (key0 < Lk) {
      const size_t o = base + (size_t)key0 * ld + nt * 8;
      *reinterpret_cast<uint32_t*>(dk + o) = pack_f32(dk_acc[nt][0], dk_acc[nt][1]);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_f32(dv_acc[nt][0], dv_acc[nt][1]);
    }
    if (key1 < Lk) {
      const size_t o = base + (size_t)key1 * ld + nt * 8;
      *reinterpret_cast<uint32_t*>(dk + o) = pack_f32(dk_acc[nt][2], dk_acc[nt][3]);
      *reinterpret_cast<uint32_t*>(dv + o) = pack_f32(dv_acc[nt][2], dv_acc[nt][3]);
    }
  }
}

template <typename BiasT>
int launch(const bf16* q, const bf16* k, const bf16* v, const void* bias, const uint8_t* mask,
           const bf16* dout, const float* lse, const float* di, bf16* dk, bf16* dv, int B, int H,
           int Lq, int Lk, int causal, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      attn_bias_bwd_dkv_kernel<BiasT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B, (Lk + BN - 1) / BN, H);
  attn_bias_bwd_dkv_kernel<BiasT><<<grid, NTHREADS, SMEM_BYTES, st>>>(
      q, k, v, static_cast<const BiasT*>(bias), mask, dout, lse, di, dk, dv, H, Lq, Lk, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// bias may be null (no bias); mask may be null (no key padding).
extern "C" int flash_attention_bias_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* bias, int bias_fp32, const void* mask,
                                            const void* dout, const void* lse, const void* di,
                                            void* dk, void* dv, int B, int H, int Lq, int Lk,
                                            int causal, void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  const bf16* gp = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(di);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bias_fp32)
    return launch<float>(qp, kp, vp, bias, mp, gp, lp, dp, dkp, dvp, B, H, Lq, Lk, causal, st);
  return launch<bf16>(qp, kp, vp, bias, mp, gp, lp, dp, dkp, dvp, B, H, Lq, Lk, causal, st);
}
