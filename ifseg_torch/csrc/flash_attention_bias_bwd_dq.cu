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
// in the packed layout: q/do/dq (B, Lq, H·D), k/v (B, Lk, H·D) bf16, the head
// dim D 64 or 80 (one instantiation each; the head tiles as in
// attn_wgmma.cuh's HeadTile); bias (H, Lq, Lk) bf16 or fp32, its rows
// `bias_pitch` elements apart (a multiple of 16 bytes: the wrapper row-pads a
// bias that is not); lse/di (B, H, Lq) fp32.  The probabilities and ds never
// reach device memory.  This file also holds the pre-pass that computes di
// from do and the saved output (the JAX package computes it outside its
// kernels too), a pass over memory of its own design (attn_bwd_di_kernel).
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
//     m64n64k16 (m64n80k16 at D = 80) with dS rounded to bf16 as the register
//     A operand and K as the MN-major ("transposed") B operand.  A consumer
//     issues tile j's S and dP with tile j-1's dq product and computes tile
//     j's dS under that product (two register buffers for the A operand).
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

constexpr int BM = 128;    // query rows per CTA, 64 per consumer warpgroup
constexpr int BN = 64;     // keys per stage
constexpr int WG_THREADS = 128;
constexpr int NTHREADS = 3 * WG_THREADS;
// 3 x 168 registers a thread at launch; 40 + 2 x 232 after setmaxnreg
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

constexpr int BIAS_SUB_BYTES = BM * SWIZZLE_ROW_BYTES;  // 128 rows x 128 bytes
// a consumer's ds tile, 64 rows x BN keys in fp32, staged for the dbias sum in
// boxes of 128 bytes (32 keys) x 64 rows, as TMA reads them
constexpr int DS_COLS_PER_SUB = SWIZZLE_ROW_BYTES / 4;
constexpr int DS_SUB_BYTES = (BM / 2) * SWIZZLE_ROW_BYTES;  // 8 KiB
constexpr int DS_BYTES = (BN / DS_COLS_PER_SUB) * DS_SUB_BYTES;  // 16 KiB
static_assert(BN <= WG_THREADS && BN % 32 == 0, "the producer writes one key-mask entry a thread");

template <typename BiasT, int D>
struct Smem {
  static constexpr int Q_BYTES = BM * D * 2;   // 16 or 20 KiB, and as much for dO
  static constexpr int KV_BYTES = BN * D * 2;  // a stage, each of K and V: 8 or 10 KiB
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
  static_assert(TOTAL <= 232448, "one CTA's shared memory");
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

template <typename BiasT, bool DBIAS, int D>
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
  typedef Smem<BiasT, D> L;
  typedef HeadTile<D> HT;
  constexpr int STAGES = L::STAGES;
  constexpr int KV_BYTES = L::KV_BYTES;
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
      mbar_arrive_expect_tx(full_q, 2 * L::Q_BYTES);
      tma_load_head<D>(q_s, &map_q, full_q, h, m0, b, BM);
      tma_load_head<D>(do_s, &map_do, full_q, h, m0, b, BM);
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
        tma_load_head<D>(k_s + s * KV_BYTES, &map_k, full + s, h, n0, b, BN);
        tma_load_head<D>(v_s + s * KV_BYTES, &map_v, full + s, h, n0, b, BN);
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

    float acc[D / 2];        // dq: 64 rows x D
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sacc[BN / 2];      // S of the current tile, then ds
    float dpacc[BN / 2];     // dP of the current tile
    uint32_t pa0[BN / 16][4], pa1[BN / 16][4];  // ds of the last two tiles, bf16: A of ds·K

    const uint64_t desc_q = HT::desc_k(q_s + HT::row_offset(c * (BM / 2)));
    const uint64_t desc_do = HT::desc_k(do_s + HT::row_offset(c * (BM / 2)));
    // S = q·kᵀ (on the bias) and dP = do·vᵀ of tile j, one commit group
    auto issue_sdp = [&](int j) {
      const int s = j % STAGES;
      const uint64_t desc_k = HT::desc_k(k_s + s * KV_BYTES);
      const uint64_t desc_v = HT::desc_k(v_s + s * KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss(sacc, desc_advance(desc_q, HT::kstep_k(kk, BM)),
                           desc_advance(desc_k, HT::kstep_k(kk, BN)), has_bias || kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss(dpacc, desc_advance(desc_do, HT::kstep_k(kk, BM)),
                           desc_advance(desc_v, HT::kstep_k(kk, BN)), kk > 0);
      wgmma_commit();
    };
    // dq += ds·k of tile j: pa (ds of n-tiles 2kk, 2kk+1) is the A operand
    auto issue_dq = [&](int j, const uint32_t(&pa)[BN / 16][4]) {
      const uint64_t desc_k = HT::desc_mn(k_s + (j % STAGES) * KV_BYTES, BN);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs_bt<D>(acc, pa[kk], desc_advance(desc_k, kk * HT::KSTEP_MN), 1);
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

// ------------------------------------------------------------ di pre-pass
//
// di[b, h, i] = Σ_d do[b, i, h·D + d] · out[b, i, h·D + d], in fp32.  A pass
// over memory: 2·B·Lq·H·D bf16 read, B·H·Lq fp32 written, two flops a byte
// read at most, so device memory bounds it (52 MB, 0.016 ms at 3.35 TB/s at
// an OFA-Base training site).
//
// Design.  A CTA of DI_THREADS threads takes DI_ROWS consecutive rows of the
// flattened (B·Lq) row axis: one contiguous span of the packed operands.  The
// span is cut into 16-byte chunks, D/8 a (row, head), and a warp takes
// 32 / (D/8) whole (row, head) pairs at a time, neighbouring lanes on
// neighbouring chunks (D = 64: 4 pairs a warp, every lane busy; D = 80: 3
// pairs, 30 lanes), so every load instruction reads a dense, sector-aligned
// run.  Each lane starts DI_UNROLL such steps (2·DI_UNROLL 16-byte loads,
// marked streaming: read once, they should not displace what L2 holds)
// before it uses the first; its 8-element partial dot product is summed over
// the lanes of its pair by shuffles, and the pair's lead lane writes the sum
// into a (heads x rows) tile in shared memory.  The tile is then stored with
// neighbouring threads on neighbouring rows of one head: runs of DI_ROWS
// contiguous floats of di, split only where the span crosses into the next
// batch row.  No limit on the number of heads but the tile's shared memory
// (H·DI_ROWS·4 bytes).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; ifseg_torch/tools/time_di.py, B =
// 16, share of the bound at the three OFA-Base training sites, then at
// Huge's, each variant an edited copy of this file timed in turns with it):
// this shape 0.75-0.76 and 0.76-0.77; without the streaming hint 0.71 and
// 0.73; 8 steps in flight 0.68-0.70 and 0.75-0.76, 12 steps 0.68-0.71 and
// 0.73-0.75 (more registers, fewer warps); 64 rows a CTA 0.68-0.70 and
// 0.76-0.77; 16 rows and 128 threads 0.74-0.76 and 0.77-0.78; 128 rows and
// 512 threads 0.68-0.70 and 0.67-0.68.  The pre-pass this one replaced (a
// warp per (row, head), one 4-byte load a lane and operand, H lone 4-byte
// stores a row) 0.47-0.50 at the OFA-Base sites.
constexpr int DI_THREADS = 256;
constexpr int DI_WARPS = DI_THREADS / 32;
constexpr int DI_ROWS = 32;
constexpr int DI_UNROLL = 4;

__device__ __forceinline__ float dot8(const uint4& a, const uint4& c) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&c);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
  }
  return s;
}

// the sum of `v` over the CPH lanes of this lane's pair, at the pair's lead
// lane (the first of the CPH); every lane of the warp takes part
template <int CPH>
__device__ __forceinline__ float pair_sum(float v, int lane) {
  if constexpr (CPH == 8) {  // aligned groups of eight lanes
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v;
  } else {  // groups of ten lanes: neighbours first, then the lead gathers the pairs
    static_assert(CPH == 10, "8 or 10 chunks a head");
    v += __shfl_down_sync(0xffffffffu, v, 1);
    const int lead = lane - lane % 10;
    float s = v;
#pragma unroll
    for (int k = 2; k < 10; k += 2) s += __shfl_sync(0xffffffffu, v, min(lead + k, 31));
    return s;
  }
}

template <int D>
__global__ void __launch_bounds__(DI_THREADS)
attn_bwd_di_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ out,
                   float* __restrict__ di, int H, int Lq, long long n_rows) {
  constexpr int CPH = D / 8;     // 16-byte chunks a (row, head)
  constexpr int PPW = 32 / CPH;  // pairs a warp step
  constexpr int PPS = DI_WARPS * PPW;  // pairs a CTA step
  extern __shared__ float tile[];  // [H][DI_ROWS]
  const long long row0 = (long long)blockIdx.x * DI_ROWS;
  const int rows = (int)min((long long)DI_ROWS, n_rows - row0);
  const int pairs = rows * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = lane / CPH, chunk = lane % CPH;  // slot == PPW: an idle lane (D = 80)
  const uint4* dp = reinterpret_cast<const uint4*>(dout + row0 * H * D) + chunk;
  const uint4* op = reinterpret_cast<const uint4*>(out + row0 * H * D) + chunk;
  for (int p0 = warp * PPW + slot; p0 - slot < pairs; p0 += DI_UNROLL * PPS) {
    uint4 a[DI_UNROLL], c[DI_UNROLL];
#pragma unroll
    for (int u = 0; u < DI_UNROLL; ++u) {
      const int p = p0 + u * PPS;
      a[u] = c[u] = make_uint4(0u, 0u, 0u, 0u);
      if (slot < PPW && p < pairs) {
        a[u] = __ldcs(dp + (size_t)p * CPH);
        c[u] = __ldcs(op + (size_t)p * CPH);
      }
    }
#pragma unroll
    for (int u = 0; u < DI_UNROLL; ++u) {
      const int p = p0 + u * PPS;
      const float s = pair_sum<CPH>(dot8(a[u], c[u]), lane);
      if (slot < PPW && chunk == 0 && p < pairs) tile[(p % H) * DI_ROWS + p / H] = s;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < H * DI_ROWS; e += DI_THREADS) {
    const int h = e / DI_ROWS, r = e % DI_ROWS;
    if (r < rows) {
      const long long g = row0 + r;
      const long long bi = g / Lq, i = g % Lq;
      di[(bi * H + h) * Lq + i] = tile[e];
    }
  }
}

// The tensor maps of one call: q and do (H·D, Lq, B) in boxes of one head's
// HeadTile<D> block x BM rows, k and v (H·D, Lk, B) in boxes of BN rows, so a
// box past L is zero-filled and never reads the next batch row; the bias (Lk, Lq, H),
// its rows bias_pitch elements apart, in boxes of 128 bytes x BM rows; the
// fp32 dbias workspace (LkP, LqP, H) in boxes of 128 bytes x 64 rows.
struct Maps {
  CUtensorMap q, dout, k, v, bias, ws;
};

template <typename BiasT, int D>
int encode_maps(Maps* m, const void* q, const void* k, const void* v, const void* dout,
                const void* bias, int bias_pitch, const void* ws, int B, int H, int Lq, int Lk) {
  int rc = encode_head_map<D>(&m->q, q, B, H, Lq, BM);
  if (rc == 0) rc = encode_head_map<D>(&m->dout, dout, B, H, Lq, BM);
  if (rc == 0) rc = encode_head_map<D>(&m->k, k, B, H, Lk, BN);
  if (rc == 0) rc = encode_head_map<D>(&m->v, v, B, H, Lk, BN);
  if (rc == 0 && bias != nullptr) {
    const uint64_t bias_row = (uint64_t)bias_pitch * sizeof(BiasT);
    const uint64_t dims[3] = {(uint64_t)Lk, (uint64_t)Lq, (uint64_t)H};
    const uint64_t strides[2] = {bias_row, (uint64_t)Lq * bias_row};
    const uint32_t box[3] = {(uint32_t)Smem<BiasT, D>::COLS_PER_SUB, BM, 1};
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

template <typename BiasT, bool DBIAS, int D>
int launch(const void* q, const void* k, const void* v, const void* bias, int bias_pitch,
           const uint8_t* mask, const void* dout, const float* lse, const float* di, bf16* dq,
           float* ws, int B, int H, int Lq, int Lk, int causal, cudaStream_t st) {
  Maps m;
  memset(&m, 0, sizeof(m));
  const int rc = encode_maps<BiasT, D>(&m, q, k, v, dout, bias, bias_pitch, ws, B, H, Lq, Lk);
  if (rc != 0) return 100000 + rc;  // a tensor map was refused (CUresult rc)
  const cudaError_t e = cudaFuncSetAttribute(attn_bias_bwd_dq_kernel<BiasT, DBIAS, D>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             Smem<BiasT, D>::TOTAL);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B, (Lq + BM - 1) / BM, H);
  attn_bias_bwd_dq_kernel<BiasT, DBIAS, D><<<grid, NTHREADS, Smem<BiasT, D>::TOTAL, st>>>(
      m.q, m.dout, m.k, m.v, m.bias, m.ws, mask, lse, di, dq, H, Lq, Lk, causal,
      bias != nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dq (and, when dbias_ws is not null, Σ_b ds added into the zeroed fp32
// workspace (H, ceil128(Lq), ceil64(Lk))).  Launches on `stream`; returns
// cudaGetLastError() (0 = launched), or 100000 + the CUresult when a tensor
// map could not be encoded.  D, the head dim, is 64 or 80.  bias may be null (no bias); its rows are
// bias_pitch >= Lk elements apart, a multiple of 16 bytes, and it starts on a
// 16-byte boundary.  mask may be null (no key padding).
extern "C" int flash_attention_bias_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* bias, int bias_fp32, int bias_pitch,
                                           const void* mask, const void* dout, const void* lse,
                                           const void* di, void* dq, void* dbias_ws, int B,
                                           int H, int D, int Lq, int Lk, int causal,
                                           void* stream) {
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
#define ATTN_BWD_DQ(T, DB, HD) \
  launch<T, DB, HD>(q, k, v, bias, bias_pitch, mp, dout, lp, dp, dqp, ws, B, H, Lq, Lk, causal, st)
#define ATTN_BWD_DQ_D(HD)                                                                     \
  if (D == HD) {                                                                              \
    if (ws != nullptr)                                                                        \
      return bias_fp32 ? ATTN_BWD_DQ(float, true, HD) : ATTN_BWD_DQ(bf16, true, HD);          \
    return bias_fp32 ? ATTN_BWD_DQ(float, false, HD) : ATTN_BWD_DQ(bf16, false, HD);          \
  }
  ATTN_BWD_DQ_D(64)
  ATTN_BWD_DQ_D(80)
#undef ATTN_BWD_DQ_D
#undef ATTN_BWD_DQ
  return static_cast<int>(cudaErrorInvalidValue);  // no instantiation for this head dim
}

// Dynamic shared memory one CTA of the dq kernel takes at head dim D, in bytes.
extern "C" int flash_attention_bias_bwd_dq_smem_bytes(int bias_fp32, int D) {
  if (D == 80) return bias_fp32 ? Smem<float, 80>::TOTAL : Smem<bf16, 80>::TOTAL;
  return bias_fp32 ? Smem<float, 64>::TOTAL : Smem<bf16, 64>::TOTAL;
}

// The most heads the di pre-pass takes: its (heads x rows) tile fills at most
// the 48 KiB of static shared memory.
constexpr int DI_MAX_HEADS = 48 * 1024 / (DI_ROWS * 4);

// di (B, H, Lq) fp32 from do and out (B, Lq, H·D) bf16, D 64 or 80, both
// 16-byte aligned.
extern "C" int flash_attention_bwd_di(const void* dout, const void* out, void* di, int B, int H,
                                      int D, int Lq, void* stream) {
  if (H < 1 || H > DI_MAX_HEADS || B < 1 || Lq < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_rows = (long long)B * Lq;
  const unsigned grid = (unsigned)((n_rows + DI_ROWS - 1) / DI_ROWS);
  const size_t smem = (size_t)H * DI_ROWS * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* dp = static_cast<const bf16*>(dout);
  const bf16* op = static_cast<const bf16*>(out);
  float* dip = static_cast<float*>(di);
  if (D == 64) attn_bwd_di_kernel<64><<<grid, DI_THREADS, smem, st>>>(dp, op, dip, H, Lq, n_rows);
  else if (D == 80) attn_bwd_di_kernel<80><<<grid, DI_THREADS, smem, st>>>(dp, op, dip, H, Lq, n_rows);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
