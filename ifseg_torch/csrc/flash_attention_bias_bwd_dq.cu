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
// (H, Lq, Lk) bf16 or fp32, its rows `bias_pitch` elements apart (a multiple
// of 16 bytes: the wrapper row-pads a bias that is not); lse/di (B, H, Lq)
// fp32.  The probabilities and ds never reach device memory.  This file also
// holds the small pre-pass that computes di from do and the saved output (the
// JAX package computes it outside its kernels too).
//
// What bounds it on this card (NVIDIA H100 SXM, 700 W).  At the training
// shapes (B=16, H=12, D=64, Lq/Lk about 1025-1056) one call does three
// 64-deep products over every visible (q, k) pair, 39-82 GFLOP, over about
// 180 MB of operands and results: 0.04-0.08 ms of tensor-core time at the
// data-sheet peak.  As in the forward, one exponential a pair (2.1e8 at a
// full site, 0.06 ms at 16 a clock on 132 SMs) and the L2 -> SM traffic (every
// CTA streams K, V and a bias tile per key tile) sit above that, and so does
// the dbias sum: 2.1e8 fp32 additions a full site into a workspace that other
// CTAs add to at the same time.
//
// Design.  The forward's skeleton (flash_attention_bias_fwd.cu):
//   * one CTA of three warpgroups per 128 query rows of one (b, h): grid
//     (B, q-tiles, H) with the batch fastest, so the CTAs that read the same
//     bias tile and add into the same dbias rows run together and meet in
//     L2.  Warpgroup 0 produces, 1 and 2 consume 64 rows each; setmaxnreg
//     moves registers from the producer to the consumers.  A last query tile
//     of at most 64 rows (Lq = 1025 leaves one) runs one consumer.
//   * Q and dO arrive once and stay; K, V and the 128 x 64 bias tile arrive
//     by TMA (3-D maps, zero-filled past L, under the 128-byte swizzle)
//     through a ring of three stages, one mbarrier for the bytes, one for
//     the stage's key-mask row, which the producer's threads write (0, -1e9
//     for a padded key, -inf past Lk) with a flag for "any key masked".
//   * S = bias + Q·Kᵀ and dP = dO·Vᵀ are wgmma m64n64k16 from shared memory,
//     S accumulating on the bias tile that the consumer loads into the
//     accumulator; dS = P∘(dP − di) stays in registers; dq += dS·K is
//     m64n64k16 with dS rounded to bf16 as the register A operand and K as
//     the MN-major ("transposed") B operand.  A consumer issues tile j's S and
//     dP with tile j-1's dq product and computes tile j's dS under that
//     product (two register buffers for the A operand).
//   * 64 keys a stage, not the forward's 128: S, dP, dq and two A buffers are
//     128 of the consumer's 232 registers; at 128 keys S and dP alone would
//     be 128, and the consumers would spill.
//   * dbias.  The B CTAs of one (h, q-tile) run at the same time, so their
//     ds tiles are summed in an fp32 workspace (H, LqP, LkP), both lengths
//     padded to the tiles so every box is in bounds, which the wrapper
//     zeroes and rounds once to the bias dtype: the sum is in fp32 and
//     rounded once, as on the TPU, but its order, and so its last bits,
//     change from run to run.  Each consumer writes its fp32 ds tile into
//     one of two staging buffers in the layout a TMA box has and one thread
//     adds it into the workspace with two bulk reduce-adds
//     (cp.reduce.async.bulk.tensor), done in L2; that thread waits for the
//     TMA unit to have read the other buffer before the one named barrier of
//     the tile, so the buffer is free when it comes round again.  It is the
//     largest single cost of the kernel: 2.1e8 additions, 857 MB of fp32, a
//     full site.  (Two buffers leave room for two ring stages only with an
//     fp32 bias, which no model path hands over.)
//   * the loop ends, under causal masking, at the last key tile any row of
//     the CTA sees; rows past Lq are computed on zeros with lse = +inf (p = 0)
//     and never stored.
// The tensor maps are encoded on the host in every call and passed as
// __grid_constant__ parameters.
//
// Measured (H100 SXM, 700 W; B = 16, encoder self-attention site, 1056 x
// 1056, bf16 bias; ifseg_torch/tools/time_attention_backward.py).  The
// mma.sync kernel this replaced: 1.37 ms; 1.19 without dbias (its float2
// atomics: 0.17) and 0.48 without a bias (staging the bias by threads: 0.71).
// This kernel: 0.48 ms, 0.25 without dbias, 0.22 without a bias: the sum
// costs 0.23 ms, of which staging the tiles takes 0.11 (timed with the
// reduce-adds left out) and a plain bulk store instead of the reduce-add
// 0.17.  Dead ends:
//   * ds added from registers by vector atomics (atomicAdd on float4, lanes
//     t and t^1 swapping half their values to make four neighbouring
//     columns): 0.64 ms; the atomics cost 0.39, the bulk reduce-adds 0.24.
//   * a cluster of two CTAs (neighbouring batch rows) summing their tiles in
//     distributed shared memory before one bulk reduce-add of half the rows
//     each, so L2 adds half the bytes: 0.67 ms; the handshakes between the
//     two SMs at every key tile (a remote mbarrier arrival and wait each
//     way) cost more than the halved L2 traffic saves.
//   * one staging buffer a consumer, with a named barrier before and after
//     writing it: 0.49 ms.

#include <math.h>
#include <string.h>

#include "attn_wgmma.cuh"

namespace {

using namespace wg;

constexpr int D = 64;      // head dim (the model's; the wrapper checks): one 128-byte row
constexpr int BM = 128;    // query rows per CTA, 64 per consumer warpgroup
constexpr int BN = 64;     // keys per stage
constexpr int WG_THREADS = 128;
constexpr int NTHREADS = 3 * WG_THREADS;
// 3 x 168 registers a thread at launch; 40 + 2 x 232 after setmaxnreg
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

constexpr int ROW_BYTES = D * 2;          // one head row of bf16
constexpr int Q_BYTES = BM * ROW_BYTES;   // 16 KiB, and as much for dO
constexpr int KV_BYTES = BN * ROW_BYTES;  // 8 KiB a stage, each of K and V
constexpr int BIAS_SUB_BYTES = BM * SWIZZLE_ROW_BYTES;  // 128 rows x 128 bytes
// a consumer's ds tile, 64 rows x BN keys in fp32, staged for the dbias sum in
// boxes of 128 bytes (32 keys) x 64 rows, as TMA reads them
constexpr int DS_COLS_PER_SUB = SWIZZLE_ROW_BYTES / 4;
constexpr int DS_SUB_BYTES = (BM / 2) * SWIZZLE_ROW_BYTES;  // 8 KiB
constexpr int DS_BYTES = (BN / DS_COLS_PER_SUB) * DS_SUB_BYTES;  // 16 KiB
static_assert(BN <= WG_THREADS && BN % 32 == 0, "the producer writes one key-mask entry a thread");

template <typename BiasT>
struct Smem {
  static constexpr int STAGES = sizeof(BiasT) == 4 ? 2 : 3;  // of the K + V + bias ring
  static constexpr int COLS_PER_SUB = SWIZZLE_ROW_BYTES / (int)sizeof(BiasT);  // 64 or 32
  static constexpr int SUBS = BN / COLS_PER_SUB;                              // 1 or 2
  static constexpr int BIAS_BYTES = SUBS * BIAS_SUB_BYTES;  // a stage: 16 or 32 KiB
  static constexpr int Q = 0;
  static constexpr int DO = Q + Q_BYTES;
  static constexpr int K = DO + Q_BYTES;
  static constexpr int V = K + STAGES * KV_BYTES;
  static constexpr int BIAS = V + STAGES * KV_BYTES;
  static constexpr int DS = BIAS + STAGES * BIAS_BYTES;  // two ds tiles a consumer
  static constexpr int KEYMASK = DS + 2 * 2 * DS_BYTES;
  static constexpr int FLAGS = KEYMASK + STAGES * BN * (int)sizeof(float);
  static constexpr int BARRIERS = FLAGS + STAGES * (BN / 32) * (int)sizeof(uint32_t);
  static constexpr int N_BARRIERS = 1 + 3 * STAGES;
  // + 1024: the tiles start at the first multiple of 1024 bytes
  static constexpr int TOTAL = BARRIERS + N_BARRIERS * 8 + SWIZZLE_ATOM_BYTES;
  static_assert(BARRIERS % 8 == 0, "mbarriers are 8-byte aligned");
};

// byte offset, in a stage's bias tile, of the element at tile row r whose
// column lies `col_byte` bytes into 128-byte group `sub`
__device__ __forceinline__ uint32_t bias_offset(int r, int sub, int col_byte) {
  return sub * BIAS_SUB_BYTES + r * SWIZZLE_ROW_BYTES + swizzle128(r, col_byte);
}

// Writes this thread's ds values (rows rl and rl+8 of the consumer's 64, keys
// 8nt + 2t, +1 of the tile) into the consumer's staging tile, laid out as
// TMA reads a box of 32 fp32 x 64 rows under the 128-byte swizzle: the eight
// rows a warp writes together fall into eight swizzle phases, so the float2
// stores are free of bank conflicts.
__device__ __forceinline__ void stage_ds(unsigned char* ds_stage, const float (&ds)[BN / 2], int rl,
                                         int t) {
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    const int cl = nt * 8 + 2 * t;
    const int col_byte = (cl % DS_COLS_PER_SUB) * 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = rl + 8 * half;
      *reinterpret_cast<float2*>(ds_stage + (cl / DS_COLS_PER_SUB) * DS_SUB_BYTES +
                                 r * SWIZZLE_ROW_BYTES + swizzle128(r, col_byte)) =
          make_float2(ds[4 * nt + 2 * half], ds[4 * nt + 2 * half + 1]);
    }
  }
}

template <typename BiasT, bool DBIAS>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_bias_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_do,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_bias,
                        const __grid_constant__ CUtensorMap map_ws,
                        const uint8_t* __restrict__ mask, const float* __restrict__ lse,
                        const float* __restrict__ di, bf16* __restrict__ dq, int H, int Lq,
                        int Lk, int causal, int has_bias) {
  typedef Smem<BiasT> L;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((SWIZZLE_ATOM_BYTES - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* q_s = smem + L::Q;
  unsigned char* do_s = smem + L::DO;
  unsigned char* k_s = smem + L::K;
  unsigned char* v_s = smem + L::V;
  unsigned char* bias_s = smem + L::BIAS;
  unsigned char* ds_s = smem + L::DS;
  float* keymask_s = reinterpret_cast<float*>(smem + L::KEYMASK);
  uint32_t* flags_s = reinterpret_cast<uint32_t*>(smem + L::FLAGS);  // keys with a mask entry
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::BARRIERS);  // Q and dO have landed
  uint64_t* full = full_q + 1;          // K, V and the bias boxes of a stage have landed
  uint64_t* full_aux = full + STAGES;   // the stage's key-mask row is written
  uint64_t* empty = full_aux + STAGES;  // every consumer warp is done with the stage

  const int b = blockIdx.x;  // fastest-varying: bias tiles and dbias rows shared across the batch
  const int m0 = blockIdx.y * BM;
  const int h = blockIdx.z;
  const int role = threadIdx.x / WG_THREADS;  // 0 producer, 1 and 2 consumers
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int off = Lk - Lq;  // causal: key j is visible to row i iff j <= i + off
  int n_tiles = (Lk + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (min(m0 + BM, Lq) - 1 + off) / BN + 1);
  const int n_consumers = (Lq - m0 > BM / 2) ? 2 : 1;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
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
      if (DBIAS) tma_prefetch_descriptor(&map_ws);
      mbar_arrive_expect_tx(full_q, 2 * Q_BYTES);
      tma_load_3d(q_s, &map_q, full_q, h * D, m0, b);
      tma_load_3d(do_s, &map_do, full_q, h * D, m0, b);
    }
    const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * Lk;
    const uint32_t stage_bytes = 2 * KV_BYTES + (has_bias ? L::BIAS_BYTES : 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const int n0 = j * BN;
      const uint32_t parity = (j / STAGES) & 1;
      mbar_wait(empty + s, parity ^ 1);  // passes at once on the first round
      if (tid == 0) {
        mbar_arrive_expect_tx(full + s, stage_bytes);
        tma_load_3d(k_s + s * KV_BYTES, &map_k, full + s, h * D, n0, b);
        tma_load_3d(v_s + s * KV_BYTES, &map_v, full + s, h * D, n0, b);
        if (has_bias) {
#pragma unroll
          for (int sub = 0; sub < L::SUBS; ++sub)
            tma_load_3d(bias_s + s * L::BIAS_BYTES + sub * BIAS_SUB_BYTES, &map_bias, full + s,
                        n0 + sub * L::COLS_PER_SUB, m0, h);
        }
      }
      if (tid < BN) {  // the stage's key-mask row, one key a thread, and whether any is set
        const int key = n0 + tid;
        const float km =
            key >= Lk ? -INFINITY : (mask_b != nullptr && mask_b[key]) ? NEG_INF : 0.f;
        keymask_s[s * BN + tid] = km;
        const uint32_t any = __ballot_sync(0xffffffffu, km != 0.f);
        if (lane == 0) flags_s[s * (BN / 32) + warp] = any;
      }
      mbar_arrive(full_aux + s);
    }
  } else {
    // ----------------------------------------------------------- consumers
    const int c = role - 1;
    if (c >= n_consumers) return;  // no row of this half tile exists
    setmaxnreg_inc<CONSUMER_REGS>();
    const int g = lane >> 2;  // fragment row group
    const int t = lane & 3;   // thread in group
    const int r_lo = c * (BM / 2) + warp * 16 + g;  // tile row of elements 0/1; +8 for 2/3
    const int row_first = m0 + c * (BM / 2);        // first query row of this warpgroup

    // this thread's two rows: lse in log2 units (+inf past Lq, so p = 0) and di
    float lse2[2], di_r[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + r_lo + 8 * i;
      const size_t idx = ((size_t)b * H + h) * Lq + row;
      lse2[i] = row < Lq ? lse[idx] * LOG2E : INFINITY;
      di_r[i] = row < Lq ? di[idx] : 0.f;
    }

    float acc[D / 2];        // dq: 64 rows x 64
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sacc[BN / 2];      // S of the current tile, then ds
    float dpacc[BN / 2];     // dP of the current tile
    uint32_t pa0[BN / 16][4], pa1[BN / 16][4];  // ds of the last two tiles, bf16: A of ds·K

    const uint64_t desc_q = smem_desc_sw128(q_s + c * (BM / 2) * ROW_BYTES);
    const uint64_t desc_do = smem_desc_sw128(do_s + c * (BM / 2) * ROW_BYTES);
    // S = q·kᵀ (on the bias) and dP = do·vᵀ of tile j, one commit group
    auto issue_sdp = [&](int j) {
      const int s = j % STAGES;
      const uint64_t desc_k = smem_desc_sw128(k_s + s * KV_BYTES);
      const uint64_t desc_v = smem_desc_sw128(v_s + s * KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss(sacc, desc_advance(desc_q, kk * KSTEP_KMAJOR_BYTES),
                           desc_advance(desc_k, kk * KSTEP_KMAJOR_BYTES), has_bias || kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss(dpacc, desc_advance(desc_do, kk * KSTEP_KMAJOR_BYTES),
                           desc_advance(desc_v, kk * KSTEP_KMAJOR_BYTES), kk > 0);
      wgmma_commit();
    };
    // dq += ds·k of tile j: pa (ds of n-tiles 2kk, 2kk+1) is the A operand
    auto issue_dq = [&](int j, const uint32_t(&pa)[BN / 16][4]) {
      const uint64_t desc_k = smem_desc_sw128(k_s + (j % STAGES) * KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_m64n64k16_rs_bt(acc, pa[kk], desc_advance(desc_k, kk * KSTEP_MNMAJOR_BYTES), 1);
      wgmma_commit();
    };
    // sacc = the bias tile of stage j: the product then accumulates on it
    auto load_bias = [&](int j) {
      if (!has_bias) return;
      const unsigned char* bias_stage = bias_s + (j % STAGES) * L::BIAS_BYTES;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int cl = nt * 8 + 2 * t;
        const int sub = cl / L::COLS_PER_SUB;
        const int col_byte = (cl % L::COLS_PER_SUB) * (int)sizeof(BiasT);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 bb = to_float2(*reinterpret_cast<const typename Pair<BiasT>::type*>(
              bias_stage + bias_offset(r_lo + half * 8, sub, col_byte)));
          sacc[4 * nt + 2 * half] = bb.x;
          sacc[4 * nt + 2 * half + 1] = bb.y;
        }
      }
    };
    // sacc (bias + q·kᵀ): causal, + key mask; p = exp(sacc − lse); ds = p (dp − di)
    // into sacc, added into the dbias workspace, rounded into pa
    auto ds_tile = [&](int j, uint32_t(&pa)[BN / 16][4]) {
      const int s = j % STAGES;
      const int n0 = j * BN;
      mbar_wait(full_aux + s, (j / STAGES) & 1);
      if (causal && n0 + BN - 1 > row_first + off) {  // a tile on the diagonal
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n0 + nt * 8 + 2 * t + (e & 1);
            const int row = m0 + r_lo + (e >> 1) * 8;
            if (col > row + off) sacc[4 * nt + e] = NEG_INF;
          }
        }
      }
      const uint2 fl = *reinterpret_cast<const uint2*>(flags_s + s * (BN / 32));
      if ((fl.x | fl.y) != 0u) {  // padded keys, or keys past Lk
        const float* km_s = keymask_s + s * BN + 2 * t;
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
          const float2 km = *reinterpret_cast<const float2*>(km_s + nt * 8);
          sacc[4 * nt] += km.x;
          sacc[4 * nt + 1] += km.y;
          sacc[4 * nt + 2] += km.x;
          sacc[4 * nt + 3] += km.y;
        }
      }
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int i = (e >> 1) & 1;
        const float p = exp2_approx(fmaf(sacc[e], LOG2E, -lse2[i]));
        sacc[e] = p * (dpacc[e] - di_r[i]);
      }
      if constexpr (DBIAS) {  // Σ_b ds: this tile's ds added into the workspace by TMA
        // two buffers a consumer: tile j-2's reduction, which read this one,
        // was waited for before the barrier of tile j-1
        unsigned char* ds_stage = ds_s + (2 * c + (j & 1)) * DS_BYTES;
        stage_ds(ds_stage, sacc, warp * 16 + g, t);
        fence_async_shared();
        if (tid == 0) bulk_wait_read<0>();  // tile j-1's reduction has read its buffer
        named_barrier_sync(1 + c, WG_THREADS);
        if (tid == 0) {
#pragma unroll
          for (int sub = 0; sub < BN / DS_COLS_PER_SUB; ++sub)
            tma_reduce_add_3d(&map_ws, ds_stage + sub * DS_SUB_BYTES,
                              n0 + sub * DS_COLS_PER_SUB, row_first, h);
          bulk_commit();
        }
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_f32(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pa[kk][1] = pack_f32(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_f32(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_f32(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
    };
    auto fence_operands = [&]() {  // registers written by ordinary arithmetic -> wgmma
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        fence_registers(pa0[kk]);
        fence_registers(pa1[kk]);
      }
      fence_registers(acc);
      fence_registers(sacc);
      fence_registers(dpacc);
      wgmma_fence();
    };
    auto release = [&](int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + j % STAGES);
    };

    // Tile j's S and dP are computed together with tile j-1's dq product, and
    // tile j's ds under that product.
    mbar_wait(full_q, 0);
    mbar_wait(full, 0);
    load_bias(0);
    fence_operands();
    issue_sdp(0);
    wgmma_wait<0>();
    fence_registers(sacc);
    fence_registers(dpacc);
    ds_tile(0, pa0);
    for (int j = 1; j < n_tiles; ++j) {
      mbar_wait(full + j % STAGES, (j / STAGES) & 1);
      load_bias(j);
      fence_operands();
      issue_sdp(j);
      if (j & 1) issue_dq(j - 1, pa0);
      else issue_dq(j - 1, pa1);
      wgmma_wait<1>();  // S and dP of tile j are there
      fence_registers(sacc);
      fence_registers(dpacc);
      if (j & 1) ds_tile(j, pa1);
      else ds_tile(j, pa0);
      wgmma_wait<0>();  // tile j-1's dq product is done: its stage is free
      fence_registers(acc);
      release(j - 1);
    }
    fence_operands();
    if ((n_tiles - 1) & 1) issue_dq(n_tiles - 1, pa1);
    else issue_dq(n_tiles - 1, pa0);
    wgmma_wait<0>();
    fence_registers(acc);
    if (DBIAS && tid == 0) bulk_wait<0>();  // the stage stays until the last reduction is done

    const int row0 = m0 + r_lo;
    const int row1 = row0 + 8;
    const int ld = H * D;
    bf16* dqg = dq + (size_t)b * Lq * ld + h * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      if (row0 < Lq)
        *reinterpret_cast<uint32_t*>(dqg + (size_t)row0 * ld + nt * 8) =
            pack_f32(acc[4 * nt], acc[4 * nt + 1]);
      if (row1 < Lq)
        *reinterpret_cast<uint32_t*>(dqg + (size_t)row1 * ld + nt * 8) =
            pack_f32(acc[4 * nt + 2], acc[4 * nt + 3]);
    }
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

// The tensor maps of one call: q and do (H·64, Lq, B) in boxes of one head
// row x BM rows, k and v (H·64, Lk, B) in boxes of BN rows, so a box past L
// is zero-filled and never reads the next batch row; the bias (Lk, Lq, H),
// its rows bias_pitch elements apart, in boxes of 128 bytes x BM rows; the
// fp32 dbias workspace (LkP, LqP, H) in boxes of 128 bytes x 64 rows.
struct Maps {
  CUtensorMap q, dout, k, v, bias, ws;
};

template <typename BiasT>
int encode_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout,
                const void* bias, int bias_pitch, const void* ws, int B, int H, int Lq, int Lk) {
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
  if (rc == 0 && ws != nullptr) {
    const uint64_t lqp = (uint64_t)((Lq + BM - 1) / BM) * BM, lkp = (uint64_t)((Lk + BN - 1) / BN) * BN;
    const uint64_t dims[3] = {lkp, lqp, (uint64_t)H};
    const uint64_t strides[2] = {lkp * 4, lqp * lkp * 4};
    const uint32_t box[3] = {DS_COLS_PER_SUB, BM / 2, 1};
    rc = encode_map(&m->ws, ws, true, 3, dims, strides, box);
  }
  return rc;
}

template <typename BiasT, bool DBIAS>
int launch(const void* q, const void* k, const void* v, const void* bias, int bias_pitch,
           const uint8_t* mask, const void* dout, const float* lse, const float* di, bf16* dq,
           float* ws, int B, int H, int Lq, int Lk, int causal, cudaStream_t st) {
  Maps m;
  memset(&m, 0, sizeof(m));
  const int rc = encode_maps<BiasT>(&m, q, k, v, dout, bias, bias_pitch, ws, B, H, Lq, Lk);
  if (rc != 0) return 100000 + rc;  // a tensor map was refused (CUresult rc)
  const cudaError_t e = cudaFuncSetAttribute(attn_bias_bwd_dq_kernel<BiasT, DBIAS>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             Smem<BiasT>::TOTAL);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B, (Lq + BM - 1) / BM, H);
  attn_bias_bwd_dq_kernel<BiasT, DBIAS><<<grid, NTHREADS, Smem<BiasT>::TOTAL, st>>>(
      m.q, m.dout, m.k, m.v, m.bias, m.ws, mask, lse, di, dq, H, Lq, Lk, causal,
      bias != nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dq (and, when dbias_ws is not null, Σ_b ds added into the zeroed fp32
// workspace (H, ceil128(Lq), ceil64(Lk))).  Launches on `stream`; returns
// cudaGetLastError() (0 = launched), or 100000 + the CUresult when a tensor
// map could not be encoded.  bias may be null (no bias); its rows are
// bias_pitch >= Lk elements apart, a multiple of 16 bytes, and it starts on a
// 16-byte boundary.  mask may be null (no key padding).
extern "C" int flash_attention_bias_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* bias, int bias_fp32, int bias_pitch,
                                           const void* mask, const void* dout, const void* lse,
                                           const void* di, void* dq, void* dbias_ws, int B,
                                           int H, int Lq, int Lk, int causal, void* stream) {
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(di);
  bf16* dqp = static_cast<bf16*>(dq);
  float* ws = static_cast<float*>(dbias_ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ws != nullptr && bias == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (bias != nullptr && ((uintptr_t)bias % 16 != 0 ||
                          ((size_t)bias_pitch * (bias_fp32 ? 4 : 2)) % 16 != 0 || bias_pitch < Lk))
    return static_cast<int>(cudaErrorInvalidValue);  // TMA cannot fetch these rows
#define ATTN_BWD_DQ(T, DB) \
  launch<T, DB>(q, k, v, bias, bias_pitch, mp, dout, lp, dp, dqp, ws, B, H, Lq, Lk, causal, st)
  if (ws != nullptr) return bias_fp32 ? ATTN_BWD_DQ(float, true) : ATTN_BWD_DQ(bf16, true);
  return bias_fp32 ? ATTN_BWD_DQ(float, false) : ATTN_BWD_DQ(bf16, false);
#undef ATTN_BWD_DQ
}

// Dynamic shared memory one CTA of the dq kernel takes, in bytes.
extern "C" int flash_attention_bias_bwd_dq_smem_bytes(int bias_fp32) {
  return bias_fp32 ? Smem<float>::TOTAL : Smem<bf16>::TOTAL;
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
