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
// bias (H, Lq, Lk) bf16 or fp32, its rows `bias_pitch` elements apart (a
// multiple of 16 bytes); lse/di (B, H, Lq) fp32.
//
// What bounds it on this card (NVIDIA H100 SXM, 700 W).  Four 64-deep
// products over every visible (q, k) pair, 52-110 GFLOP at the training
// shapes (B=16, H=12, Lq/Lk about 1025-1056), over about 180 MB of operands
// and results: 0.05-0.11 ms of tensor-core time at the data-sheet peak; one
// exponential a pair and the L2 -> SM traffic (Q, dO and a bias tile per
// query tile, for every 128 keys) sit above that, as in the forward.
//
// Design.  The forward's skeleton, keys in the place of query rows:
//   * one CTA of three warpgroups per 128 keys of one (b, h): grid (B,
//     k-tiles, H) with the batch fastest, so the CTAs that read one bias tile
//     run together and meet in L2.  Warpgroup 0 produces, 1 and 2 consume 64
//     keys each, and loop over the query tiles, so dk and dv accumulate in
//     registers and are written once, with no atomics: the loop takes the
//     place of the TPU grid (h, b, i) with the query block innermost.  A last
//     key tile of at most 64 keys runs one consumer.
//   * K and V arrive once and stay; Q, dO and the 64 x 128 bias tile arrive
//     by TMA (zero-filled past L, 128-byte swizzle) through a ring of three
//     stages, lse (log2 units, +inf past Lq) and di of the stage's
//     rows written by the producer's threads beside them.
//   * Everything is computed transposed, keys as the M dimension:
//     Sᵀ = bias + K·Qᵀ and dPᵀ = V·dOᵀ are wgmma m64n64k16 from shared
//     memory (K and V K-major as A, Q and dO K-major as B).  Their
//     accumulators are already laid out as the A operand of the next
//     products: Pᵀ and dSᵀ, rounded to bf16 in registers, give dV += Pᵀ·dO
//     and dK += dSᵀ·Q by m64n64k16 with dO and Q as MN-major B operands.  No
//     transpose goes through shared memory; the four accumulators take 128
//     registers and the two A operands 32 a buffer, within the consumers'
//     232, with no spill (the kernel it replaces, on mma.sync, took 255
//     registers and spilled).
//   * the bias is read transposed out of the tile TMA wrote: a warp's 32
//     loads of one instruction hit 4 rows (query rows 2t + e) x 8 keys (16
//     or 32 bytes), and the 128-byte swizzle puts those rows' chunks in
//     distinct banks, so the reads are free of conflicts without a padded
//     copy.  The consumer loads it into the Sᵀ accumulator, which the
//     product adds to.
//   * a consumer issues tile j's Sᵀ and dPᵀ with tile j-1's dV and dK
//     products and computes tile j's Pᵀ and dSᵀ under them (two register
//     buffers for the A operands).
//   * under causal masking the loop starts at the first query tile that sees
//     any key of the CTA.  Rows past Lq are zero with lse = +inf (p = 0);
//     keys past Lk are computed on zeros and never stored.
// The tensor maps are encoded on the host in every call and passed as
// __grid_constant__ parameters.

#include <math.h>
#include <string.h>

#include "attn_wgmma.cuh"

namespace {

using namespace wg;

constexpr int D = 64;      // head dim (the model's; the wrapper checks): one 128-byte row
constexpr int BN = 128;    // keys per CTA, 64 per consumer warpgroup
constexpr int BM = 64;     // query rows per stage
constexpr int STAGES = 3;  // of the Q + dO + bias ring
constexpr int WG_THREADS = 128;
constexpr int NTHREADS = 3 * WG_THREADS;
// 3 x 168 registers a thread at launch; 40 + 2 x 232 after setmaxnreg
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

constexpr int ROW_BYTES = D * 2;          // one head row of bf16
constexpr int KV_BYTES = BN * ROW_BYTES;  // 16 KiB, each of K and V
constexpr int QS_BYTES = BM * ROW_BYTES;  // 8 KiB a stage, each of Q and dO
constexpr int BIAS_SUB_BYTES = BM * SWIZZLE_ROW_BYTES;  // 64 rows x 128 bytes
static_assert(BM <= WG_THREADS, "the producer writes one row's lse and di a thread");

template <typename BiasT>
struct Smem {
  static constexpr int COLS_PER_SUB = SWIZZLE_ROW_BYTES / (int)sizeof(BiasT);  // 64 or 32
  static constexpr int SUBS = BN / COLS_PER_SUB;                              // 2 or 4
  static constexpr int BIAS_BYTES = SUBS * BIAS_SUB_BYTES;  // a stage: 16 or 32 KiB
  static constexpr int K = 0;
  static constexpr int V = K + KV_BYTES;
  static constexpr int Q = V + KV_BYTES;
  static constexpr int DO = Q + STAGES * QS_BYTES;
  static constexpr int BIAS = DO + STAGES * QS_BYTES;
  static constexpr int STATS = BIAS + STAGES * BIAS_BYTES;  // lse (log2 units), di
  static constexpr int BARRIERS = STATS + STAGES * 2 * BM * (int)sizeof(float);
  static constexpr int N_BARRIERS = 1 + 3 * STAGES;
  // + 1024: the tiles start at the first multiple of 1024 bytes
  static constexpr int TOTAL = BARRIERS + N_BARRIERS * 8 + SWIZZLE_ATOM_BYTES;
};

template <typename BiasT, int COLS_PER_SUB>
__device__ __forceinline__ float bias_at(const unsigned char* bias_stage, int r, int key) {
  const int col_byte = (key % COLS_PER_SUB) * (int)sizeof(BiasT);
  return to_float(*reinterpret_cast<const BiasT*>(
      bias_stage + (key / COLS_PER_SUB) * BIAS_SUB_BYTES + r * SWIZZLE_ROW_BYTES +
      swizzle128(r, col_byte)));
}

template <typename BiasT>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_bias_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_do,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_bias,
                         const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                         const float* __restrict__ di, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int H, int Lq, int Lk, int causal,
                         int has_bias) {
  typedef Smem<BiasT> L;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((SWIZZLE_ATOM_BYTES - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* k_s = smem + L::K;
  unsigned char* v_s = smem + L::V;
  unsigned char* q_s = smem + L::Q;
  unsigned char* do_s = smem + L::DO;
  unsigned char* bias_s = smem + L::BIAS;
  float* stats_s = reinterpret_cast<float*>(smem + L::STATS);  // a stage: BM lse, BM di
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(smem + L::BARRIERS);  // K and V have landed
  uint64_t* full = full_kv + 1;         // Q, dO and the bias boxes of a stage have landed
  uint64_t* full_aux = full + STAGES;   // the stage's lse and di are written
  uint64_t* empty = full_aux + STAGES;  // every consumer warp is done with the stage

  const int b = blockIdx.x;  // fastest-varying: bias tile reuse across the batch
  const int n0 = blockIdx.y * BN;
  const int h = blockIdx.z;
  const int role = threadIdx.x / WG_THREADS;  // 0 producer, 1 and 2 consumers
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int off = Lk - Lq;  // causal: key j is visible to row i iff j <= i + off
  const int m_tiles = (Lq + BM - 1) / BM;
  const int j0 = causal ? max(0, n0 - off) / BM : 0;  // the first query tile that sees a key
  const int n_consumers = (Lk - n0 > BN / 2) ? 2 : 1;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(full_aux + s, WG_THREADS);
      mbar_init(empty + s, 4 * n_consumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (role == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      tma_prefetch_descriptor(&map_q);
      tma_prefetch_descriptor(&map_do);
      tma_prefetch_descriptor(&map_k);
      tma_prefetch_descriptor(&map_v);
      if (has_bias) tma_prefetch_descriptor(&map_bias);
      mbar_arrive_expect_tx(full_kv, 2 * KV_BYTES);
      tma_load_3d(k_s, &map_k, full_kv, h * D, n0, b);
      tma_load_3d(v_s, &map_v, full_kv, h * D, n0, b);
    }
    const float* lse_bh = lse + ((size_t)b * H + h) * Lq;
    const float* di_bh = di + ((size_t)b * H + h) * Lq;
    const uint32_t stage_bytes = 2 * QS_BYTES + (has_bias ? L::BIAS_BYTES : 0);
    for (int j = j0; j < m_tiles; ++j) {
      const int i = j - j0;
      const int s = i % STAGES;
      const int m0 = j * BM;
      mbar_wait(empty + s, ((i / STAGES) & 1) ^ 1);  // passes at once on the first round
      if (tid == 0) {
        mbar_arrive_expect_tx(full + s, stage_bytes);
        tma_load_3d(q_s + s * QS_BYTES, &map_q, full + s, h * D, m0, b);
        tma_load_3d(do_s + s * QS_BYTES, &map_do, full + s, h * D, m0, b);
        if (has_bias) {
#pragma unroll
          for (int sub = 0; sub < L::SUBS; ++sub)
            tma_load_3d(bias_s + s * L::BIAS_BYTES + sub * BIAS_SUB_BYTES, &map_bias, full + s,
                        n0 + sub * L::COLS_PER_SUB, m0, h);
        }
      }
      if (tid < BM) {
        const int row = m0 + tid;
        stats_s[s * 2 * BM + tid] = row < Lq ? lse_bh[row] * LOG2E : INFINITY;
        stats_s[s * 2 * BM + BM + tid] = row < Lq ? di_bh[row] : 0.f;
      }
      mbar_arrive(full_aux + s);
    }
  } else {
    // ----------------------------------------------------------- consumers
    const int c = role - 1;
    if (c >= n_consumers) return;  // no key of this half tile exists
    setmaxnreg_inc<CONSUMER_REGS>();
    const int g = lane >> 2;  // fragment row group
    const int t = lane & 3;   // thread in group
    const int r_lo = c * (BN / 2) + warp * 16 + g;  // tile key of elements 0/1; +8 for 2/3
    const int key_first = n0 + c * (BN / 2);        // first key of this warpgroup

    // this thread's two keys: 0, -1e9 (padding) or -inf (past Lk)
    float km[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = n0 + r_lo + 8 * i;
      km[i] = key >= Lk ? -INFINITY : (mask != nullptr && mask[(size_t)b * Lk + key]) ? NEG_INF : 0.f;
    }

    float dk_acc[D / 2], dv_acc[D / 2];  // 64 keys x 64
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    float sacc[BM / 2];   // Sᵀ of the current tile, then Pᵀ
    float dpacc[BM / 2];  // dPᵀ of the current tile, then dSᵀ
    // Pᵀ and dSᵀ of the last two tiles, bf16: the A operands of the dV and dK products
    uint32_t pa0[BM / 16][4], pa1[BM / 16][4], da0[BM / 16][4], da1[BM / 16][4];

    const uint64_t desc_k = smem_desc_sw128(k_s + c * (BN / 2) * ROW_BYTES);
    const uint64_t desc_v = smem_desc_sw128(v_s + c * (BN / 2) * ROW_BYTES);
    // Sᵀ = k·qᵀ (on the bias) and dPᵀ = v·doᵀ of stage s, one commit group
    auto issue_sdp = [&](int s) {
      const uint64_t desc_q = smem_desc_sw128(q_s + s * QS_BYTES);
      const uint64_t desc_do = smem_desc_sw128(do_s + s * QS_BYTES);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss(sacc, desc_advance(desc_k, kk * KSTEP_KMAJOR_BYTES),
                           desc_advance(desc_q, kk * KSTEP_KMAJOR_BYTES), has_bias || kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss(dpacc, desc_advance(desc_v, kk * KSTEP_KMAJOR_BYTES),
                           desc_advance(desc_do, kk * KSTEP_KMAJOR_BYTES), kk > 0);
      wgmma_commit();
    };
    // dV += Pᵀ·do and dK += dSᵀ·q of stage s, one commit group
    auto issue_dkv = [&](int s, const uint32_t(&pa)[BM / 16][4],
                         const uint32_t(&da)[BM / 16][4]) {
      const uint64_t desc_q = smem_desc_sw128(q_s + s * QS_BYTES);
      const uint64_t desc_do = smem_desc_sw128(do_s + s * QS_BYTES);
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        wgmma_m64n64k16_rs_bt(dv_acc, pa[kk], desc_advance(desc_do, kk * KSTEP_MNMAJOR_BYTES), 1);
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
        wgmma_m64n64k16_rs_bt(dk_acc, da[kk], desc_advance(desc_q, kk * KSTEP_MNMAJOR_BYTES), 1);
      wgmma_commit();
    };
    // sacc = the bias tile of stage s, transposed: element [4nt + e] is key
    // r_lo + 8(e >> 1), query row 8nt + 2t + (e & 1) of the stage
    auto load_bias = [&](int s) {
      if (!has_bias) return;
      const unsigned char* bias_stage = bias_s + s * L::BIAS_BYTES;
#pragma unroll
      for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sacc[4 * nt + e] = bias_at<BiasT, L::COLS_PER_SUB>(
              bias_stage, nt * 8 + 2 * t + (e & 1), r_lo + 8 * (e >> 1));
      }
    };
    // sacc (bias + k·qᵀ): causal, + key mask; Pᵀ = exp(sacc − lse) into pa,
    // dSᵀ = Pᵀ (dPᵀ − di) into da, both rounded to bf16
    auto p_ds_tile = [&](int j, int s, uint32_t(&pa)[BM / 16][4], uint32_t(&da)[BM / 16][4]) {
      const int m0 = j * BM;
      const int i = j - j0;
      mbar_wait(full_aux + s, (i / STAGES) & 1);
      if (causal && key_first + BN / 2 - 1 > m0 + off) {  // a tile on the diagonal
#pragma unroll
        for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = m0 + nt * 8 + 2 * t + (e & 1);
            const int key = n0 + r_lo + 8 * (e >> 1);
            if (key > row + off) sacc[4 * nt + e] = NEG_INF;
          }
        }
      }
      const float* lse_s = stats_s + s * 2 * BM + 2 * t;
      const float* di_s = lse_s + BM;
#pragma unroll
      for (int nt = 0; nt < BM / 8; ++nt) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + nt * 8);
        const float2 dd = *reinterpret_cast<const float2*>(di_s + nt * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sacc[4 * nt + e] + km[e >> 1];
          const float p = exp2_approx(fmaf(x, LOG2E, -((e & 1) ? l2.y : l2.x)));
          sacc[4 * nt + e] = p;
          dpacc[4 * nt + e] = p * (dpacc[4 * nt + e] - ((e & 1) ? dd.y : dd.x));
        }
      }
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        pa[kk][0] = pack_f32(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pa[kk][1] = pack_f32(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_f32(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_f32(sacc[8 * kk + 6], sacc[8 * kk + 7]);
        da[kk][0] = pack_f32(dpacc[8 * kk + 0], dpacc[8 * kk + 1]);
        da[kk][1] = pack_f32(dpacc[8 * kk + 2], dpacc[8 * kk + 3]);
        da[kk][2] = pack_f32(dpacc[8 * kk + 4], dpacc[8 * kk + 5]);
        da[kk][3] = pack_f32(dpacc[8 * kk + 6], dpacc[8 * kk + 7]);
      }
    };
    auto fence_operands = [&]() {  // registers written by ordinary arithmetic -> wgmma
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        fence_registers(pa0[kk]);
        fence_registers(pa1[kk]);
        fence_registers(da0[kk]);
        fence_registers(da1[kk]);
      }
      fence_registers(dk_acc);
      fence_registers(dv_acc);
      fence_registers(sacc);
      fence_registers(dpacc);
      wgmma_fence();
    };
    auto release = [&](int s) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    };

    mbar_wait(full_kv, 0);
    if (j0 < m_tiles) {
      // Tile j's Sᵀ and dPᵀ are computed together with tile j-1's dV and dK
      // products, and tile j's Pᵀ and dSᵀ under those.
      mbar_wait(full, 0);
      load_bias(0);
      fence_operands();
      issue_sdp(0);
      wgmma_wait<0>();
      fence_registers(sacc);
      fence_registers(dpacc);
      p_ds_tile(j0, 0, pa0, da0);
      for (int j = j0 + 1; j < m_tiles; ++j) {
        const int i = j - j0;
        const int s = i % STAGES;
        const int s_prev = (i - 1) % STAGES;
        mbar_wait(full + s, (i / STAGES) & 1);
        load_bias(s);
        fence_operands();
        issue_sdp(s);
        if (i & 1) issue_dkv(s_prev, pa0, da0);
        else issue_dkv(s_prev, pa1, da1);
        wgmma_wait<1>();  // Sᵀ and dPᵀ of tile j are there
        fence_registers(sacc);
        fence_registers(dpacc);
        if (i & 1) p_ds_tile(j, s, pa1, da1);
        else p_ds_tile(j, s, pa0, da0);
        wgmma_wait<0>();  // tile j-1's products are done: its stage is free
        fence_registers(dk_acc);
        fence_registers(dv_acc);
        release(s_prev);
      }
      const int last = m_tiles - 1 - j0;
      fence_operands();
      if (last & 1) issue_dkv(last % STAGES, pa1, da1);
      else issue_dkv(last % STAGES, pa0, da0);
      wgmma_wait<0>();
      fence_registers(dk_acc);
      fence_registers(dv_acc);
    }

    const int key0 = n0 + r_lo;
    const int key1 = key0 + 8;
    const int ld = H * D;
    const size_t base = (size_t)b * Lk * ld + h * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      if (key0 < Lk) {
        const size_t o = base + (size_t)key0 * ld + nt * 8;
        *reinterpret_cast<uint32_t*>(dk + o) = pack_f32(dk_acc[4 * nt], dk_acc[4 * nt + 1]);
        *reinterpret_cast<uint32_t*>(dv + o) = pack_f32(dv_acc[4 * nt], dv_acc[4 * nt + 1]);
      }
      if (key1 < Lk) {
        const size_t o = base + (size_t)key1 * ld + nt * 8;
        *reinterpret_cast<uint32_t*>(dk + o) = pack_f32(dk_acc[4 * nt + 2], dk_acc[4 * nt + 3]);
        *reinterpret_cast<uint32_t*>(dv + o) = pack_f32(dv_acc[4 * nt + 2], dv_acc[4 * nt + 3]);
      }
    }
  }
}

// The tensor maps of one call: q and do (H·64, Lq, B) in boxes of one head
// row x BM rows, k and v (H·64, Lk, B) in boxes of BN rows (zero-filled past
// L, never reading the next batch row); the bias (Lk, Lq, H), its rows
// bias_pitch elements apart, in boxes of 128 bytes x BM rows.
struct Maps {
  CUtensorMap q, dout, k, v, bias;
};

template <typename BiasT>
int encode_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout,
                const void* bias, int bias_pitch, int B, int H, int Lq, int Lk) {
  const uint64_t row = (uint64_t)H * ROW_BYTES;
  const uint32_t box_q[3] = {D, BM, 1}, box_kv[3] = {D, BN, 1};
  const uint64_t dims_q[3] = {(uint64_t)H * D, (uint64_t)Lq, (uint64_t)B};
  const uint64_t dims_kv[3] = {(uint64_t)H * D, (uint64_t)Lk, (uint64_t)B};
  const uint64_t strides_q[2] = {row, (uint64_t)Lq * row};
  const uint64_t strides_kv[2] = {row, (uint64_t)Lk * row};
  int rc = encode_map(&m->q, q, false, 3, dims_q, strides_q, box_q);
  if (rc == 0) rc = encode_map(&m->dout, dout, false, 3, dims_q, strides_q, box_q);
  if (rc == 0) rc = encode_map(&m->k, k, false, 3, dims_kv, strides_kv, box_kv);
  if (rc == 0) rc = encode_map(&m->v, v, false, 3, dims_kv, strides_kv, box_kv);
  if (rc == 0 && bias != nullptr) {
    const uint64_t bias_row = (uint64_t)bias_pitch * sizeof(BiasT);
    const uint64_t dims[3] = {(uint64_t)Lk, (uint64_t)Lq, (uint64_t)H};
    const uint64_t strides[2] = {bias_row, (uint64_t)Lq * bias_row};
    const uint32_t box[3] = {(uint32_t)Smem<BiasT>::COLS_PER_SUB, BM, 1};
    rc = encode_map(&m->bias, bias, sizeof(BiasT) == 4, 3, dims, strides, box);
  }
  return rc;
}

template <typename BiasT>
int launch(const void* q, const void* k, const void* v, const void* bias, int bias_pitch,
           const uint8_t* mask, const void* dout, const float* lse, const float* di, bf16* dk,
           bf16* dv, int B, int H, int Lq, int Lk, int causal, cudaStream_t st) {
  Maps m;
  memset(&m, 0, sizeof(m));
  const int rc = encode_maps<BiasT>(&m, q, k, v, dout, bias, bias_pitch, B, H, Lq, Lk);
  if (rc != 0) return 100000 + rc;  // a tensor map was refused (CUresult rc)
  const cudaError_t e = cudaFuncSetAttribute(attn_bias_bwd_dkv_kernel<BiasT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             Smem<BiasT>::TOTAL);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B, (Lk + BN - 1) / BN, H);
  attn_bias_bwd_dkv_kernel<BiasT><<<grid, NTHREADS, Smem<BiasT>::TOTAL, st>>>(
      m.q, m.dout, m.k, m.v, m.bias, mask, lse, di, dk, dv, H, Lq, Lk, causal, bias != nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched), or 100000 +
// the CUresult when a tensor map could not be encoded.  bias may be null (no
// bias); its rows are bias_pitch >= Lk elements apart, a multiple of 16 bytes,
// and it starts on a 16-byte boundary.  mask may be null (no key padding).
extern "C" int flash_attention_bias_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* bias, int bias_fp32, int bias_pitch,
                                            const void* mask, const void* dout, const void* lse,
                                            const void* di, void* dk, void* dv, int B, int H,
                                            int Lq, int Lk, int causal, void* stream) {
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(di);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bias != nullptr && ((uintptr_t)bias % 16 != 0 ||
                          ((size_t)bias_pitch * (bias_fp32 ? 4 : 2)) % 16 != 0 || bias_pitch < Lk))
    return static_cast<int>(cudaErrorInvalidValue);  // TMA cannot fetch these rows
  if (bias_fp32)
    return launch<float>(q, k, v, bias, bias_pitch, mp, dout, lp, dp, dkp, dvp, B, H, Lq, Lk,
                         causal, st);
  return launch<bf16>(q, k, v, bias, bias_pitch, mp, dout, lp, dp, dkp, dvp, B, H, Lq, Lk, causal,
                      st);
}

// Dynamic shared memory one CTA of the dk + dv kernel takes, in bytes.
extern "C" int flash_attention_bias_bwd_dkv_smem_bytes(int bias_fp32) {
  return bias_fp32 ? Smem<float>::TOTAL : Smem<bf16>::TOTAL;
}
