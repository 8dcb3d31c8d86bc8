// Fused attention forward with an additive per-head bias, for Hopper (sm_90a).
//
// Replaces ifseg_tpu/ops/flash_attention.py::_attn_kernel (the TPU Pallas
// kernel behind flash_attention_bias_packed_infer).  It computes, per batch
// row b and head h,
//
//     out = softmax(q·kᵀ + bias[h] + mask_row[b], causal with offset lk-lq) · v
//
// with logits and softmax in fp32 and the output divided by the row sum after
// the P·V product.  Operands use the packed projection layout: q (B, Lq, H·64),
// k/v (B, Lk, H·64) and out (B, Lq, H·64) in bf16, addressed by strides, so no
// head transpose is ever materialised.  bias is (H, Lq, Lk) in bf16 or fp32,
// shared across the batch; the key-padding mask is (B, Lk) bytes (non-zero =
// pad) and adds -1e9 to the logits of padded keys, as the TPU kernel does.
//
// What bounds it on this card.  At the serving shapes (B=32, H=12, D=64,
// Lq/Lk = 1056/1056, 1025/1025 causal, 1025/1056) one call does 52-110 GFLOP
// of bf16 products over 227-234 MB of operands.  Against the H100 SXM
// data-sheet peaks (989 TFLOP/s bf16, 3.35 TB/s) the two full sites are bound
// by the tensor cores (~0.11 ms) and the causal site, with half the products,
// by memory (~0.07 ms).  The logits, (B, H, Lq, Lk) fp32, are ~1.7 GB per
// site: keeping them out of device memory is the whole point of the kernel.
//
// Design.  The TPU kernel keeps all of K/V for one (b, h) resident in VMEM.
// On Hopper that does not fit: bf16 K+V at Lk=1056 is 264 KiB, above the
// 227 KB of shared memory one block can use.  So this kernel
//   * gives each CTA one 64-row query tile of one (b, h): grid (B, q-tiles, H)
//     with the batch fastest-varying, so the CTAs that read the same
//     (h, q-tile) bias rows run together and read them from L2, the GPU
//     counterpart of the TPU grid order (h, i, b);
//   * streams K/V in 64-key tiles through a two-stage shared-memory ring
//     filled by cp.async, so the next tile's copy overlaps this tile's
//     products, and keeps an online softmax (running row max and sum in
//     fp32, accumulator rescaled);
//   * loads each tile's bias with plain coalesced reads, all of a thread's
//     32 in flight before its first store, and stages it in shared memory
//     as fp32, before the next K/V copy is issued (the bias rows of
//     Lk = 1025 are only 2-byte aligned, which rules out cp.async for them).
//     This part is fragile.  On the H100, three rewrites of it were slower
//     at the serving shapes: storing each value right after its load (1.4x),
//     converting each value to fp32 as it is loaded, with the reads issued
//     after the K/V copy (1.9x, 241 registers) or before it (2.3x, 178
//     registers; this version uses 246);
//   * computes q·kᵀ and p·v on the tensor cores with mma.sync m16n8k16
//     (bf16 in, fp32 accumulate), four warps of 16 query rows each, with the
//     K and V fragments read by ldmatrix (V transposed on the way); the
//     probabilities are re-packed from the S accumulators straight into the
//     A operand of p·v without a trip through shared memory;
//   * masks the ragged edges (Lq = 1025, Lk = 1025/1056) itself: rows past Lq
//     are computed on zeros and never stored, keys past Lk get -inf;
//   * under causal masking stops at the last key tile that any row of the
//     query tile can see (offset lk - lq).
// Not done yet, and the next speed work: wgmma with TMA loads and a
// producer warp, 128-row query tiles, and the exp2 work that then limits.
//
// A fully masked row cannot occur on the serving path: image keys are never
// padded and the causal decoder rows always see key 0.  The wrapper refuses a
// causal call with Lk < Lq, where such rows would exist.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;             // head dim (the model's; the wrapper checks)
constexpr int BM = 64;            // query rows per CTA, 16 per warp
constexpr int BN = 64;            // keys per streamed tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = D + 8;        // bf16 pitch of Q/K/V tiles: 144 B rows, conflict-free ldmatrix
constexpr int LDB = BN + 8;       // fp32 pitch of the bias tile: conflict-free float2 reads
constexpr int BIAS_PER_THREAD = BM * BN / NTHREADS;
constexpr float NEG_INF = -1e9f;  // the JAX package's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// dynamic shared memory: Q tile, two K and two V tiles (bf16), bias tile and
// key-mask row (fp32)
constexpr size_t SMEM_BYTES =
    (size_t)(BM * LDS + 4 * BN * LDS) * sizeof(bf16) + (size_t)(BM * LDB + BN) * sizeof(float);

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16-byte global -> shared copy; copies nothing and zero-fills when !full
__device__ __forceinline__ void cp_async16(bf16* s, const bf16* g, bool full) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(g),
               "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void set_zero(float& x) { x = 0.f; }
__device__ __forceinline__ void set_zero(bf16& x) { x = __ushort_as_bfloat16((unsigned short)0); }

template <typename BiasT>
__global__ void __launch_bounds__(NTHREADS)
attn_bias_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const BiasT* __restrict__ bias,
                     const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                     int H, int Lq, int Lk, int causal) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + BM * LDS;      // two stages of BN * LDS
  bf16* v_s = k_s + 2 * BN * LDS;  // two stages of BN * LDS
  float* bias_s = reinterpret_cast<float*>(v_s + 2 * BN * LDS);
  float* keymask_s = bias_s + BM * LDB;

  const int b = blockIdx.x;  // fastest-varying: bias tile reuse across the batch
  const int m0 = blockIdx.y * BM;
  const int h = blockIdx.z;
  const int ld = H * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int r_lo = warp * 16 + g;  // tile row of accumulator elements 0/1; +8 for 2/3

  const bf16* qg = q + ((size_t)b * Lq + m0) * ld + h * D;
  const bf16* kg = k + (size_t)b * Lk * ld + h * D;
  const bf16* vg = v + (size_t)b * Lk * ld + h * D;
  const BiasT* bias_h = bias == nullptr ? nullptr : bias + ((size_t)h * Lq + m0) * Lk;

  const int off = Lk - Lq;  // causal: key j is visible to row i iff j <= i + off
  int n_tiles = (Lk + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (m0 + BM - 1 + off) / BN + 1);

  // K/V tile j -> stage j & 1, as one cp.async group; rows past Lk zero-filled
  auto issue_kv = [&](int j) {
    const int n0 = j * BN;
    const int valid = min(BN, Lk - n0);
    bf16* ks = k_s + (j & 1) * BN * LDS;
    bf16* vs = v_s + (j & 1) * BN * LDS;
    for (int c = threadIdx.x; c < BN * (D / 8); c += NTHREADS) {
      const int r = c / (D / 8);
      const int col = (c % (D / 8)) * 8;
      const bool full = r < valid;
      const size_t go = (size_t)(n0 + (full ? r : 0)) * ld + col;
      cp_async16(ks + r * LDS + col, kg + go, full);
      cp_async16(vs + r * LDS + col, vg + go, full);
    }
    cp_async_commit();
  };

  // bias and key-mask of tile j -> registers (consecutive threads read
  // consecutive keys of one row: coalesced), all loads before any store;
  // staged in shared memory by store_bias
  BiasT breg[BIAS_PER_THREAD];
  float kmreg = 0.f;
  auto fetch_bias = [&](int j) {
    const int n0 = j * BN;
    if (bias_h != nullptr) {
#pragma unroll
      for (int it = 0; it < BIAS_PER_THREAD; ++it) {
        const int i = threadIdx.x + it * NTHREADS;
        const int r = i / BN, c = i % BN;
        if (m0 + r < Lq && n0 + c < Lk) breg[it] = bias_h[(size_t)r * Lk + n0 + c];
        else set_zero(breg[it]);
      }
    }
    if (threadIdx.x < BN) {
      const int key = n0 + threadIdx.x;
      if (key >= Lk) kmreg = -INFINITY;
      else kmreg = (mask != nullptr && mask[(size_t)b * Lk + key]) ? NEG_INF : 0.f;
    }
  };
  auto store_bias = [&]() {
    if (bias_h != nullptr) {
#pragma unroll
      for (int it = 0; it < BIAS_PER_THREAD; ++it) {
        const int i = threadIdx.x + it * NTHREADS;
        bias_s[(i / BN) * LDB + i % BN] = to_float(breg[it]);
      }
    }
    if (threadIdx.x < BN) keymask_s[threadIdx.x] = kmreg;
  };

  issue_kv(0);
  {
    const int valid = min(BM, Lq - m0);
    for (int c = threadIdx.x; c < BM * (D / 8); c += NTHREADS) {
      const int r = c / (D / 8);
      const int col = (c % (D / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid) val = *reinterpret_cast<const uint4*>(qg + (size_t)r * ld + col);
      *reinterpret_cast<uint4*>(q_s + r * LDS + col) = val;
    }
  }
  __syncthreads();

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* p = q_s + r_lo * LDS + kk * 16 + 2 * t;
    qf[kk][0] = ld_u32(p);
    qf[kk][1] = ld_u32(p + 8 * LDS);
    qf[kk][2] = ld_u32(p + 8);
    qf[kk][3] = ld_u32(p + 8 * LDS + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // per-thread partial row sums, reduced at the end

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BN;
    fetch_bias(j);
    store_bias();  // the previous tile's readers passed the barrier below
    if (j + 1 < n_tiles) {
      issue_kv(j + 1);    // into the stage tile j-1 used
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j's K/V, bias and key mask are in shared memory
    const bf16* ks = k_s + (j & 1) * BN * LDS;
    const bf16* vs = v_s + (j & 1) * BN * LDS;

    // S = q·kᵀ for this warp's 16 rows x 64 keys
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        uint32_t kb[4];  // b0/b1 of k-steps kk and kk+1 for keys nt*8..+7
        ldsm_x4(kb, ks + (nt * 8 + (lane & 7)) * LDS + kk * 16 + (lane >> 3) * 8);
        mma_bf16_16816(s[nt], qf[kk], kb[0], kb[1]);
        mma_bf16_16816(s[nt], qf[kk + 1], kb[2], kb[3]);
      }
    }

    // + bias, causal, + key mask; running row max
    float mx[2] = {-INFINITY, -INFINITY};
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
        x0 += keymask_s[cl];  // 0, -1e9 (padding) or -inf (past Lk)
        x1 += keymask_s[cl + 1];
        s[nt][2 * half] = x0;
        s[nt][2 * half + 1] = x1;
        mx[half] = fmaxf(mx[half], fmaxf(x0, x1));
      }
    }
    float mbase[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = exp2f((m_run[i] - m_use) * LOG2E);  // 0 on the first tile
      m_run[i] = m_new;
      l_run[i] *= alpha;
      mbase[i] = m_use * LOG2E;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        o[nt][2 * i] *= alpha;
        o[nt][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(fmaf(s[nt][e], LOG2E, -mbase[e >> 1]));
        s[nt][e] = p;
        l_run[e >> 1] += p;
      }
    }

    // O += P·V: the S accumulators of key tiles 2kk, 2kk+1 are the A operand
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]), pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < D / 8; nt += 2) {
        uint32_t vb[4];  // b0/b1 of head-dim tiles nt and nt+1, transposed by ldmatrix
        ldsm_x4_trans(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                              (nt + (lane >> 4)) * 8);
        mma_bf16_16816(o[nt], a, vb[0], vb[1]);
        mma_bf16_16816(o[nt + 1], a, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage and the bias tile
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  const float inv0 = 1.f / l_run[0];
  const float inv1 = 1.f / l_run[1];
  const int row0 = m0 + r_lo;
  const int row1 = row0 + 8;
  bf16* og = out + (size_t)b * Lq * ld + h * D + 2 * t;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    if (row0 < Lq)
      *reinterpret_cast<uint32_t*>(og + (size_t)row0 * ld + nt * 8) =
          pack_f32(o[nt][0] * inv0, o[nt][1] * inv0);
    if (row1 < Lq)
      *reinterpret_cast<uint32_t*>(og + (size_t)row1 * ld + nt * 8) =
          pack_f32(o[nt][2] * inv1, o[nt][3] * inv1);
  }
}

template <typename BiasT>
int launch(const bf16* q, const bf16* k, const bf16* v, const void* bias, const uint8_t* mask,
           bf16* out, int B, int H, int Lq, int Lk, int causal, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      attn_bias_fwd_kernel<BiasT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B, (Lq + BM - 1) / BM, H);
  attn_bias_fwd_kernel<BiasT><<<grid, NTHREADS, SMEM_BYTES, st>>>(
      q, k, v, static_cast<const BiasT*>(bias), mask, out, H, Lq, Lk, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// bias may be null (no bias); mask may be null (no key padding).
extern "C" int flash_attention_bias_fwd(const void* q, const void* k, const void* v,
                                        const void* bias, int bias_fp32, const void* mask,
                                        void* out, int B, int H, int Lq, int Lk, int causal,
                                        void* stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  bf16* op = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bias_fp32) return launch<float>(qp, kp, vp, bias, mp, op, B, H, Lq, Lk, causal, st);
  return launch<bf16>(qp, kp, vp, bias, mp, op, B, H, Lq, Lk, causal, st);
}
