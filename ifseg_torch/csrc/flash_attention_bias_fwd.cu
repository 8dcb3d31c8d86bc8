// Fused attention forward with an additive per-head bias, for Hopper (sm_90a).
//
// Replaces ifseg_tpu/ops/flash_attention.py::_attn_kernel (the TPU Pallas
// kernel behind flash_attention_bias_packed_infer and, with its row
// logsumexp output, flash_attention_bias_packed_stats).  It computes, per
// batch row b and head h,
//
//     out = softmax(q·kᵀ + bias[h] + mask_row[b], causal with offset lk-lq) · v
//
// with logits and softmax in fp32, the probabilities rounded to bf16 for the
// P·V product and the output divided by the row sum after it.  The STATS
// instantiation also writes the row logsumexp lse = m + log(sum) as
// (B, H, Lq) fp32, which the backward kernels rebuild the probabilities from;
// the inference instantiation is compiled without that store.  Operands use
// the packed projection layout: q (B, Lq, H·64), k/v (B, Lk, H·64) and out
// (B, Lq, H·64) in bf16, so no head transpose is ever materialised.  bias is
// (H, Lq, Lk) in bf16 or fp32, shared across the batch, its rows `pitch` >= Lk
// elements apart; the key-padding mask is (B, Lk) bytes (non-zero = pad) and
// adds -1e9 to the logits of padded keys, as the TPU kernel does.
//
// What bounds it on this card (NVIDIA H100 SXM, 700 W).  At the serving
// shapes (B=32, H=12, D=64, Lq/Lk = 1056/1056, 1025/1025 causal, 1025/1056)
// one call does 52-110 GFLOP of bf16 products over 227-234 MB of operands: by
// the data-sheet peaks (989 TFLOP/s, 3.35 TB/s) 0.11 ms of tensor-core time at
// the two full sites and 0.07 ms of memory time at the causal one.  Two
// limits sit above those and are the ones that bind.  One exponential per
// logit, 4.3e8 a site at 16 a clock on each of 132 SMs, is 0.12 ms: as long
// as the products, so it has to run under them.  And every CTA reads, for
// each pair of 128 x 128 x 64 products (4.2 MFLOP), 32 KiB of K/V and 32 KiB
// of bias out of L2: 2.1 GB a site, 1.1 GB without a bias.  The kernel
// streams that at 4.9 TB/s (0.42 ms); its products alone, the softmax cut
// out, reached 6.8 TB/s (0.31 ms), so L2 bandwidth is near but not the wall:
// fetching the bias costs 0.06-0.07 ms either way, and the rest is the
// consumers' softmax and the latency that two consumer warps a scheduler
// cannot hide (the same call without a bias takes 0.36 ms).
//
// Design.  The TPU kernel keeps all of K/V for one (b, h) resident in VMEM.
// Here K/V stream through shared memory, and the three kinds of work that one
// instruction stream used to share (copies, bias staging, arithmetic) have
// their own warps:
//   * one CTA of three warpgroups per 128 query rows of one (b, h): grid
//     (B, q-tiles, H) with the batch fastest, so the CTAs that read the same
//     bias tile run together and meet in L2.  Warpgroup 0 produces, 1 and 2
//     consume 64 query rows each; setmaxnreg moves registers from the
//     producer to the consumers.  When the last query tile holds at most 64
//     rows (Lq = 1025 leaves one), the second consumer exits at once, so the
//     tile costs half a tile.
//   * Q once, and K and V per 128-key stage, arrive by TMA (3-D maps over the
//     packed operands, (H·64, L, B), so a box past L is zero-filled and never
//     reads the next batch row) under the 128-byte swizzle.  Two rings of two
//     stages, each stage with its own mbarriers: K + bias + key-mask row
//     (full_k, full_b, full_aux / empty_kb) and V (full_v / empty_v), because
//     a tile's K and bias are done with one product earlier than its V.
//   * S = bias + Q·Kᵀ is wgmma m64n128k16 from shared memory, accumulating on
//     the bias tile that the consumer has loaded into the accumulator (one
//     addition a logit less than adding it afterwards); O += P·V is wgmma
//     m64n64k16 with P as the register A operand, re-packed from the S
//     accumulators, and V as the MN-major ("transposed") B operand.  A
//     consumer issues tile j's S together with tile j-1's P·V and runs tile
//     j's softmax under that P·V; only the rescaling of O and the rounding
//     of P wait for it.  The two consumers run free of each other.
//   * the producer stages each 128 x 128 bias tile in the bias's own dtype.
//     Where the rows are 16-byte aligned (a pitch of a multiple of 8 bf16:
//     Lk = 1056, 1568, or row-padded storage, which is how the served biases
//     are allocated) it goes by TMA, under the same swizzle, which keeps
//     the consumers' reads free of bank conflicts.  Else (Lk = 1025 or 1537 in dense storage, or a bias that starts off a
//     16-byte boundary) the producer's threads read aligned 16-byte chunks,
//     shift them by the rows' misalignment and write the same layout.  It
//     also writes the stage's key-mask row (0 or -1e9) and whether any key of
//     it is masked, so the consumers add the mask only to tiles that have
//     one; only tiles on the causal diagonal pay for the comparison, only the
//     last key tile for the keys past Lk, and the loop stops at the last tile
//     any row can see.
//   * rows past Lq are computed on zeros and never stored.
// The tensor maps are encoded on the host in every call (under a microsecond),
// from the pointers the call is given, and passed as __grid_constant__
// parameters.
//
// Measured dead ends (same card; encoder self-attention site, B = 32, unless
// said otherwise; this design: 0.42 ms).
//   * No overlap inside a consumer (S, wait, softmax, P·V, wait, one ring):
//     0.50 ms; its products alone, no softmax: 0.23 ms, and 0.31 ms when the
//     bias is fetched but not used: the bias's L2 traffic alone costs 0.07 ms.
//   * Overlap, the bias added after the product: 0.43 ms.  A call without a
//     bias that zero-fills the accumulator to use the same path: 0.36 ms
//     against 0.34 ms, so only calls with a bias accumulate on it.
//   * The consumers issuing their products in turns (named barriers, the
//     "ping-pong" of other Hopper attention kernels): 0.44 ms against 0.43 ms.
//   * TMA for rows that are not 16-byte aligned (a map over groups of eight
//     rows, which are always a multiple of 16 bytes apart, with boxes that
//     start at the element where a row starts): the card faults (illegal
//     instruction); a box must start at a multiple of 16 bytes.
//   * Thread-staged bias (decoder self-attention site, 0.28 ms by TMA from
//     padded storage): 2-byte loads, 32 in flight a thread, 0.47 ms without
//     and 0.68 ms with the overlap above (the producer is then the
//     bottleneck); the same loop without zero-filling what it does not load,
//     4.7 ms (the loads no longer overlap); 16-byte chunks, 4 pairs in
//     flight, 0.47 ms; 8 pairs in flight at 104 + 2 x 200 registers: the
//     consumers spill (648 bytes), 0.74 ms, and every site is a fifth slower.
//
// A fully masked row cannot occur on the serving path: image keys are never
// padded and the causal decoder rows always see key 0.  The wrapper refuses a
// causal call with Lk < Lq, where such rows would exist.

#include <chrono>
#include <math.h>
#include <string.h>

#include "attn_wgmma.cuh"

namespace {

using namespace wg;

constexpr int D = 64;    // head dim (the model's; the wrapper checks): one 128-byte row
constexpr int BM = 128;  // query rows per CTA, 64 per consumer warpgroup
constexpr int BN = 128;  // keys per stage
constexpr int STAGES = 2;  // of the K + bias ring and of the V ring
constexpr int WG_THREADS = 128;
constexpr int NTHREADS = 3 * WG_THREADS;
// 3 x 168 registers a thread at launch; 120 + 2 x 192 after setmaxnreg
constexpr int PRODUCER_REGS = 120;
constexpr int CONSUMER_REGS = 192;

constexpr int ROW_BYTES = D * 2;          // one head row of bf16
constexpr int Q_BYTES = BM * ROW_BYTES;   // 16 KiB
constexpr int KV_BYTES = BN * ROW_BYTES;  // 16 KiB a stage, each of K and V
constexpr int STAGE_BATCH = 4;  // 16-byte loads a producer thread has in flight, in pairs
static_assert(BN == WG_THREADS, "the producer writes one key-mask entry a thread");

// The bias tile of a stage lies in shared memory as TMA writes it under the
// 128-byte swizzle: one sub-tile of BM rows x 128 bytes for each 128 bytes of
// the tile's width (64 bf16 or 32 fp32 keys), so the eight consecutive rows a
// warp reads together fall into eight swizzle phases: no bank conflicts.
constexpr int BIAS_SUB_BYTES = BM * SWIZZLE_ROW_BYTES;  // 16 KiB

template <typename BiasT>
struct Smem {
  static constexpr int COLS_PER_SUB = SWIZZLE_ROW_BYTES / (int)sizeof(BiasT);  // 64 or 32
  static constexpr int SUBS = BN / COLS_PER_SUB;
  static constexpr int BIAS_BYTES = SUBS * BIAS_SUB_BYTES;  // a stage: 32 or 64 KiB
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;
  static constexpr int V = K + STAGES * KV_BYTES;
  static constexpr int BIAS = V + STAGES * KV_BYTES;
  static constexpr int KEYMASK = BIAS + STAGES * BIAS_BYTES;
  static constexpr int FLAGS = KEYMASK + STAGES * BN * (int)sizeof(float);
  static constexpr int BARRIERS = FLAGS + STAGES * 4 * (int)sizeof(uint32_t);
  static constexpr int N_BARRIERS = 1 + 6 * STAGES;
  // + 1024: the tiles start at the first multiple of 1024 bytes
  static constexpr int TOTAL = BARRIERS + N_BARRIERS * 8 + SWIZZLE_ATOM_BYTES;
};

// byte offset, in a stage's bias tile, of the element at tile row r whose
// column lies `col_byte` bytes into 128-byte group `sub`
__device__ __forceinline__ uint32_t bias_offset(int r, int sub, int col_byte) {
  return sub * BIAS_SUB_BYTES + r * SWIZZLE_ROW_BYTES + swizzle128(r, col_byte);
}

// Bytes [M + 4i, M + 4i + 4) of the 32 bytes w[0..7].
template <int M>
__device__ __forceinline__ uint32_t realigned_word(const uint32_t (&w)[8], int i) {
  constexpr int first = M / 4, shift = (M % 4) * 8;
  return shift == 0 ? w[i + first] : __funnelshift_r(w[i + first], w[i + first + 1], shift);
}

// One warp stages the tile rows k, k+8, ..., k+8(n_rows-1) of a bias whose
// rows TMA cannot take.  Eight rows are a multiple of 16 bytes apart, so these
// rows all start M bytes behind a multiple of 16: each lane reads the two
// aligned 16-byte chunks around one chunk of output, shifts them by M and
// writes 16 bytes, STAGE_BATCH such pairs in flight.  `first` points at the
// first key of row k in this tile, `end` behind the bias's last element.
template <typename BiasT, int M>
__device__ __forceinline__ void stage_bias_rows_at(unsigned char* bias_stage,
                                                   const unsigned char* first,
                                                   size_t pitch8_bytes, int k, int n_rows,
                                                   const unsigned char* end, int lane) {
  constexpr int CHUNKS = BN * (int)sizeof(BiasT) / 16;  // of a row's width: 16 or 32
  constexpr int ROWS = 32 / CHUNKS;                     // rows a warp takes at once
  const int q = lane % CHUNKS;
  const unsigned char* src0 = first - M + 16 * q;
  for (int u0 = lane / CHUNKS; u0 < BM / 8; u0 += ROWS * STAGE_BATCH) {
    uint4 lo[STAGE_BATCH], hi[STAGE_BATCH];
#pragma unroll
    for (int i = 0; i < STAGE_BATCH; ++i) {
      const int u = u0 + i * ROWS;
      const unsigned char* src = src0 + (size_t)u * pitch8_bytes;
      lo[i] = hi[i] = make_uint4(0u, 0u, 0u, 0u);
      if (u < n_rows && src < end) lo[i] = __ldg(reinterpret_cast<const uint4*>(src));
      if (M != 0 && u < n_rows && src + 16 < end)
        hi[i] = __ldg(reinterpret_cast<const uint4*>(src + 16));
    }
#pragma unroll
    for (int i = 0; i < STAGE_BATCH; ++i) {
      const int u = u0 + i * ROWS;
      const uint32_t w[8] = {lo[i].x, lo[i].y, lo[i].z, lo[i].w,
                             hi[i].x, hi[i].y, hi[i].z, hi[i].w};
      const uint4 val = make_uint4(realigned_word<M>(w, 0), realigned_word<M>(w, 1),
                                   realigned_word<M>(w, 2), realigned_word<M>(w, 3));
      *reinterpret_cast<uint4*>(bias_stage + bias_offset(k + 8 * u, (16 * q) / SWIZZLE_ROW_BYTES,
                                                         (16 * q) % SWIZZLE_ROW_BYTES)) = val;
    }
  }
}

template <typename BiasT>
__device__ __forceinline__ void stage_bias_rows(unsigned char* bias_stage,
                                                const unsigned char* first, size_t pitch8_bytes,
                                                int k, int n_rows, const unsigned char* end,
                                                int lane) {
  switch (reinterpret_cast<uintptr_t>(first) & 15) {  // the same for the whole warp
#define STAGE_CASE(M)                                                                         \
  case M:                                                                                     \
    stage_bias_rows_at<BiasT, M>(bias_stage, first, pitch8_bytes, k, n_rows, end, lane);      \
    break;
    STAGE_CASE(0) STAGE_CASE(2) STAGE_CASE(4) STAGE_CASE(6)
    STAGE_CASE(8) STAGE_CASE(10) STAGE_CASE(12) STAGE_CASE(14)
#undef STAGE_CASE
  }
}

template <typename BiasT, bool STATS>
__global__ void __launch_bounds__(NTHREADS, 1)
attn_bias_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_bias,
                     const BiasT* __restrict__ bias, const uint8_t* __restrict__ mask,
                     bf16* __restrict__ out, float* __restrict__ lse, int H, int Lq, int Lk,
                     int causal, int bias_pitch, int bias_by_tma) {
  typedef Smem<BiasT> L;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((SWIZZLE_ATOM_BYTES - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* q_s = smem + L::Q;
  unsigned char* k_s = smem + L::K;
  unsigned char* v_s = smem + L::V;
  unsigned char* bias_s = smem + L::BIAS;
  float* keymask_s = reinterpret_cast<float*>(smem + L::KEYMASK);
  uint32_t* flags_s = reinterpret_cast<uint32_t*>(smem + L::FLAGS);  // keys with a non-zero mask
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::BARRIERS);
  uint64_t* full_k = full_q + 1;           // K of a stage has landed
  uint64_t* full_b = full_k + STAGES;      // the bias boxes have landed
  uint64_t* full_aux = full_b + STAGES;    // key-mask row written, bias staged by threads
  uint64_t* full_v = full_aux + STAGES;    // V has landed
  uint64_t* empty_kb = full_v + STAGES;    // every consumer warp is done with K, bias, key mask
  uint64_t* empty_v = empty_kb + STAGES;   // ... with V

  const int b = blockIdx.x;  // fastest-varying: bias tile reuse across the batch
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
      mbar_init(full_k + s, 1);
      mbar_init(full_b + s, 1);
      mbar_init(full_aux + s, WG_THREADS);
      mbar_init(full_v + s, 1);
      mbar_init(empty_kb + s, 4 * n_consumers);
      mbar_init(empty_v + s, 4 * n_consumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (role == 0) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      tma_prefetch_descriptor(&map_q);
      tma_prefetch_descriptor(&map_k);
      tma_prefetch_descriptor(&map_v);
      if (bias_by_tma) tma_prefetch_descriptor(&map_bias);
      mbar_arrive_expect_tx(full_q, Q_BYTES);
      tma_load_3d(q_s, &map_q, full_q, h * D, m0, b);
    }
    const uint8_t* mask_b = mask == nullptr ? nullptr : mask + (size_t)b * Lk;
    const bool bias_by_threads = bias != nullptr && !bias_by_tma;
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const int n0 = j * BN;
      const uint32_t parity = (j / STAGES) & 1;
      unsigned char* bias_stage = bias_s + s * L::BIAS_BYTES;
      mbar_wait(empty_kb + s, parity ^ 1);  // passes at once on the first round
      if (tid == 0) {
        mbar_arrive_expect_tx(full_k + s, KV_BYTES);
        tma_load_3d(k_s + s * KV_BYTES, &map_k, full_k + s, h * D, n0, b);
        if (bias_by_tma) {
          mbar_arrive_expect_tx(full_b + s, L::BIAS_BYTES);
#pragma unroll
          for (int sub = 0; sub < L::SUBS; ++sub)
            tma_load_3d(bias_stage + sub * BIAS_SUB_BYTES, &map_bias, full_b + s,
                        n0 + sub * L::COLS_PER_SUB, m0, h);
        }
      }
      {  // the stage's key-mask row, one key a thread, and whether any is set
        const int key = n0 + tid;
        const float km = (key < Lk && mask_b != nullptr && mask_b[key]) ? NEG_INF : 0.f;
        keymask_s[s * BN + tid] = km;
        const uint32_t any = __ballot_sync(0xffffffffu, km != 0.f);
        if (lane == 0) flags_s[s * 4 + warp] = any;
      }
      if (bias_by_threads) {
        // Warp w takes the rows k, k+8, ... for k = w and w+4.  Rows past Lq
        // and keys past Lk are not the bias's: those rows are never stored,
        // those keys are overridden whatever the tile holds.
        const size_t pitch_bytes = (size_t)bias_pitch * sizeof(BiasT);
        const unsigned char* base = reinterpret_cast<const unsigned char*>(bias);
        const unsigned char* end =
            base + ((size_t)(H * Lq - 1) * bias_pitch + Lk) * sizeof(BiasT);
        const unsigned char* tile =
            base + (size_t)(h * Lq + m0) * pitch_bytes + (size_t)n0 * sizeof(BiasT);
        for (int k = warp; k < 8; k += 4)
          stage_bias_rows<BiasT>(bias_stage, tile + k * pitch_bytes, 8 * pitch_bytes, k,
                                 (min(BM, Lq - m0) - k + 7) / 8, end, lane);
      }
      mbar_arrive(full_aux + s);
      mbar_wait(empty_v + s, parity ^ 1);
      if (tid == 0) {
        mbar_arrive_expect_tx(full_v + s, KV_BYTES);
        tma_load_3d(v_s + s * KV_BYTES, &map_v, full_v + s, h * D, n0, b);
      }
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

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float sacc[BN / 2];    // S of the current tile, then its probabilities
    uint32_t pa[BN / 16][4];  // the probabilities of the previous tile, bf16: A of P·V
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end
    float alpha[2];

    // S = q·kᵀ of tile j: this warpgroup's 64 rows x 128 keys (asynchronous)
    const uint64_t desc_q = smem_desc_sw128(q_s + c * (BM / 2) * ROW_BYTES);
    auto issue_qk = [&](int j) {
      const uint64_t desc_k = smem_desc_sw128(k_s + (j % STAGES) * KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n128k16_ss(sacc, desc_advance(desc_q, kk * KSTEP_KMAJOR_BYTES),
                            desc_advance(desc_k, kk * KSTEP_KMAJOR_BYTES),
                            bias != nullptr || kk > 0);
      wgmma_commit();
    };
    // O += P·V of tile j: pa (the S accumulators of n-tiles 2kk, 2kk+1) is the A operand
    auto issue_pv = [&](int j) {
      const uint64_t desc_v = smem_desc_sw128(v_s + (j % STAGES) * KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_m64n64k16_rs_bt(o, pa[kk], desc_advance(desc_v, kk * KSTEP_MNMAJOR_BYTES), 1);
      wgmma_commit();
    };
    // sacc = the bias tile of stage j: the product then accumulates on it,
    // which saves the consumers one addition a logit
    auto load_bias = [&](int j) {
      if (bias == nullptr) return;
      const int s = j % STAGES;
      const uint32_t parity = (j / STAGES) & 1;
      mbar_wait(full_aux + s, parity);
      if (bias_by_tma) mbar_wait(full_b + s, parity);
      const unsigned char* bias_stage = bias_s + s * L::BIAS_BYTES;
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
    // sacc (bias + q·kᵀ): causal, + key mask; new row max; sacc = exp(sacc - max);
    // alpha = the factor the earlier tiles' sums and outputs shrink by
    auto softmax = [&](int j) {
      const int s = j % STAGES;
      const int n0 = j * BN;
      const uint32_t parity = (j / STAGES) & 1;
      mbar_wait(full_aux + s, parity);
      float mx[2] = {-INFINITY, -INFINITY};
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
      if (n0 + BN > Lk) {  // the last tile: whatever lies past Lk counts for nothing
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n0 + nt * 8 + 2 * t + (e & 1) >= Lk) sacc[4 * nt + e] = -INFINITY;
        }
      }
      const uint4 fl = *reinterpret_cast<const uint4*>(flags_s + s * 4);
      if ((fl.x | fl.y | fl.z | fl.w) != 0u) {  // the tile holds padded keys
        const float* km_s = keymask_s + s * BN + 2 * t;
#pragma unroll
        for (int nt = 0; nt < BN / 8; ++nt) {
          const float2 km = *reinterpret_cast<const float2*>(km_s + nt * 8);  // 0 or -1e9
          sacc[4 * nt] += km.x;
          sacc[4 * nt + 1] += km.y;
          sacc[4 * nt + 2] += km.x;
          sacc[4 * nt + 3] += km.y;
        }
      }
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sacc[e]);
      float mbase[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);
        const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
        alpha[i] = exp2_approx((m_run[i] - m_use) * LOG2E);  // 0 on the first tile
        m_run[i] = m_new;
        l_run[i] *= alpha[i];
        mbase[i] = m_use * LOG2E;
      }
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const float p = exp2_approx(fmaf(sacc[e], LOG2E, -mbase[(e >> 1) & 1]));
        sacc[e] = p;
        l_run[(e >> 1) & 1] += p;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_kb + s);  // this warp has read the stage's bias and mask
    };
    // the earlier tiles' output shrinks by alpha; the probabilities become A of P·V
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        o[4 * nt] *= alpha[0];
        o[4 * nt + 1] *= alpha[0];
        o[4 * nt + 2] *= alpha[1];
        o[4 * nt + 3] *= alpha[1];
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
      for (int kk = 0; kk < BN / 16; ++kk) fence_registers(pa[kk]);
      fence_registers(o);
      fence_registers(sacc);
      wgmma_fence();
    };
    auto release_v = [&](int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_v + j % STAGES);
    };

    // Tile j's S is computed while tile j-1's P·V runs, and tile j's softmax
    // runs under that P·V: only the rescaling of O and the rounding of P wait
    // for it.
    mbar_wait(full_q, 0);
    mbar_wait(full_k, 0);
    load_bias(0);
    fence_operands();
    issue_qk(0);
    wgmma_wait<0>();
    fence_registers(sacc);
    softmax(0);
    rescale_and_pack();
    for (int j = 1; j < n_tiles; ++j) {
      mbar_wait(full_k + j % STAGES, (j / STAGES) & 1);
      mbar_wait(full_v + (j - 1) % STAGES, ((j - 1) / STAGES) & 1);
      load_bias(j);
      fence_operands();
      issue_qk(j);
      issue_pv(j - 1);
      wgmma_wait<1>();  // S of tile j is there
      fence_registers(sacc);
      softmax(j);
      wgmma_wait<0>();  // P·V of tile j-1 is done: O and pa are free
      fence_registers(o);
      release_v(j - 1);
      rescale_and_pack();
    }
    mbar_wait(full_v + (n_tiles - 1) % STAGES, ((n_tiles - 1) / STAGES) & 1);
    fence_operands();
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_registers(o);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
      l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    }
    const float inv0 = 1.f / l_run[0];
    const float inv1 = 1.f / l_run[1];
    const int row0 = m0 + r_lo;
    const int row1 = row0 + 8;
    const int ld = H * D;
    bf16* og = out + (size_t)b * Lq * ld + h * D + 2 * t;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      if (row0 < Lq)
        *reinterpret_cast<uint32_t*>(og + (size_t)row0 * ld + nt * 8) =
            pack_f32(o[4 * nt] * inv0, o[4 * nt + 1] * inv0);
      if (row1 < Lq)
        *reinterpret_cast<uint32_t*>(og + (size_t)row1 * ld + nt * 8) =
            pack_f32(o[4 * nt + 2] * inv1, o[4 * nt + 3] * inv1);
    }
    if constexpr (STATS) {
      if (t == 0) {
        float* lse_bh = lse + ((size_t)b * H + h) * Lq;
        if (row0 < Lq) lse_bh[row0] = m_run[0] + logf(l_run[0]);
        if (row1 < Lq) lse_bh[row1] = m_run[1] + logf(l_run[1]);
      }
    }
  }
}

// The tensor maps of one call.  q, k, v are seen as (H·64, L, B) with boxes of
// one head row x BM or BN rows, so a box past L is zero-filled and never
// reads the next batch row.  The bias (H, Lq, Lk), its rows `bias_pitch`
// elements apart, goes by TMA where its rows are 16-byte aligned, in boxes of
// 128 bytes x BM rows; else the map stays unset and threads stage it.
struct Maps {
  CUtensorMap q, k, v, bias;
  int bias_by_tma;
};

template <typename BiasT>
int encode_maps(Maps* m, const void* q, const void* k, const void* v, const void* bias,
                int bias_pitch, int B, int H, int Lq, int Lk) {
  const uint64_t row = (uint64_t)H * ROW_BYTES;
  const uint32_t box_q[3] = {D, BM, 1}, box_kv[3] = {D, BN, 1};
  const uint64_t dims_q[3] = {(uint64_t)H * D, (uint64_t)Lq, (uint64_t)B};
  const uint64_t dims_kv[3] = {(uint64_t)H * D, (uint64_t)Lk, (uint64_t)B};
  const uint64_t strides_q[2] = {row, (uint64_t)Lq * row};
  const uint64_t strides_kv[2] = {row, (uint64_t)Lk * row};
  int rc = encode_map(&m->q, q, false, 3, dims_q, strides_q, box_q);
  if (rc == 0) rc = encode_map(&m->k, k, false, 3, dims_kv, strides_kv, box_kv);
  if (rc == 0) rc = encode_map(&m->v, v, false, 3, dims_kv, strides_kv, box_kv);
  const uint64_t bias_row = (uint64_t)bias_pitch * sizeof(BiasT);
  m->bias_by_tma = bias != nullptr && bias_row % 16 == 0 && (uintptr_t)bias % 16 == 0;
  if (rc == 0 && m->bias_by_tma) {
    const uint64_t dims[3] = {(uint64_t)Lk, (uint64_t)Lq, (uint64_t)H};
    const uint64_t strides[2] = {bias_row, (uint64_t)Lq * bias_row};
    const uint32_t box[3] = {(uint32_t)Smem<BiasT>::COLS_PER_SUB, BM, 1};
    rc = encode_map(&m->bias, bias, sizeof(BiasT) == 4, 3, dims, strides, box);
  }
  return rc;
}

template <typename BiasT, bool STATS>
int launch(const void* q, const void* k, const void* v, const void* bias, int bias_pitch,
           const uint8_t* mask, bf16* out, float* lse, int B, int H, int Lq, int Lk, int causal,
           cudaStream_t st) {
  Maps m;
  memset(&m, 0, sizeof(m));
  const int rc = encode_maps<BiasT>(&m, q, k, v, bias, bias_pitch, B, H, Lq, Lk);
  if (rc != 0) return 100000 + rc;  // a tensor map was refused (CUresult rc)
  const cudaError_t e = cudaFuncSetAttribute(
      attn_bias_fwd_kernel<BiasT, STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<BiasT>::TOTAL);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B, (Lq + BM - 1) / BM, H);
  attn_bias_fwd_kernel<BiasT, STATS><<<grid, NTHREADS, Smem<BiasT>::TOTAL, st>>>(
      m.q, m.k, m.v, m.bias, static_cast<const BiasT*>(bias), mask, out, lse, H, Lq, Lk, causal,
      bias_pitch, m.bias_by_tma);
  return static_cast<int>(cudaGetLastError());
}

template <bool STATS>
int dispatch(const void* q, const void* k, const void* v, const void* bias, int bias_fp32,
             int bias_pitch, const void* mask, void* out, void* lse, int B, int H, int Lq, int Lk,
             int causal, void* stream) {
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  bf16* op = static_cast<bf16*>(out);
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bias_fp32)
    return launch<float, STATS>(q, k, v, bias, bias_pitch, mp, op, lp, B, H, Lq, Lk, causal, st);
  return launch<bf16, STATS>(q, k, v, bias, bias_pitch, mp, op, lp, B, H, Lq, Lk, causal, st);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched), or 100000 +
// the CUresult when a tensor map could not be encoded.
// bias may be null (no bias), its rows are bias_pitch >= Lk elements apart;
// mask may be null (no key padding).
extern "C" int flash_attention_bias_fwd(const void* q, const void* k, const void* v,
                                        const void* bias, int bias_fp32, int bias_pitch,
                                        const void* mask, void* out, int B, int H, int Lq,
                                        int Lk, int causal, void* stream) {
  return dispatch<false>(q, k, v, bias, bias_fp32, bias_pitch, mask, out, nullptr, B, H, Lq, Lk,
                         causal, stream);
}

// The same forward, also writing the row logsumexp lse (B, H, Lq) fp32.
extern "C" int flash_attention_bias_fwd_stats(const void* q, const void* k, const void* v,
                                              const void* bias, int bias_fp32, int bias_pitch,
                                              const void* mask, void* out, void* lse, int B,
                                              int H, int Lq, int Lk, int causal, void* stream) {
  return dispatch<true>(q, k, v, bias, bias_fp32, bias_pitch, mask, out, lse, B, H, Lq, Lk,
                        causal, stream);
}

// Dynamic shared memory one CTA of the kernel takes, in bytes.
extern "C" int flash_attention_bias_fwd_smem_bytes(int bias_fp32) {
  return bias_fp32 ? Smem<float>::TOTAL : Smem<bf16>::TOTAL;
}

// Host time of one call's tensor-map encodes in microseconds, the mean of
// `iters` repetitions; negative when a map is refused.  Launches
// nothing.
extern "C" double flash_attention_bias_fwd_encode_us(const void* q, const void* k, const void* v,
                                                     const void* bias, int bias_fp32,
                                                     int bias_pitch, int B, int H, int Lq,
                                                     int Lk, int iters) {
  Maps m;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    const int rc = bias_fp32 ? encode_maps<float>(&m, q, k, v, bias, bias_pitch, B, H, Lq, Lk)
                             : encode_maps<bf16>(&m, q, k, v, bias, bias_pitch, B, H, Lq, Lk);
    if (rc != 0) return -1.0;
  }
  const std::chrono::duration<double, std::micro> dt = std::chrono::steady_clock::now() - t0;
  return dt.count() / iters;
}
