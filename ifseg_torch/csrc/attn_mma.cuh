// Shared device helpers of the attention backward kernels (sm_90a): the
// mma.sync / ldmatrix / cp.async wrappers and the tile geometry.  The forward
// kernel keeps its own copies, so its code stays exactly what was measured.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int D = 64;        // head dim (the model's; the wrapper checks)
constexpr int BM = 64;       // query rows per tile
constexpr int BN = 64;       // keys per tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = D + 8;   // bf16 pitch of Q/K/V/dO tiles: 144 B rows, conflict-free ldmatrix
constexpr float NEG_INF = -1e9f;  // the JAX package's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

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

// One BM- or BN-row tile of a packed (rows, H*D) operand -> shared memory by
// cp.async (no commit); rows at or past `valid` are zero-filled.
__device__ __forceinline__ void copy_tile_async(bf16* dst, const bf16* src, int ld, int valid) {
  for (int c = threadIdx.x; c < BM * (D / 8); c += NTHREADS) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    const bool full = r < valid;
    cp_async16(dst + r * LDS + col, src + (size_t)(full ? r : 0) * ld + col, full);
  }
}

// The A-operand fragments (16 rows x 64 of this warp) of a tile in shared memory.
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4], const bf16* tile,
                                             int r_lo, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* p = tile + r_lo * LDS + kk * 16 + 2 * t;
    f[kk][0] = ld_u32(p);
    f[kk][1] = ld_u32(p + 8 * LDS);
    f[kk][2] = ld_u32(p + 8);
    f[kk][3] = ld_u32(p + 8 * LDS + 8);
  }
}

// acc (16 x 64) = A (16 x 64, fragments) · Bᵀ, with B a 64-row tile in shared
// memory read as [n][k] (row n of the tile is column n of the product).
__device__ __forceinline__ void mma_a_bt(float (&acc)[8][4], const uint32_t (&a)[D / 16][4],
                                         const bf16* tile, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t bb[4];
      ldsm_x4(bb, tile + (nt * 8 + (lane & 7)) * LDS + kk * 16 + (lane >> 3) * 8);
      mma_bf16_16816(acc[nt], a[kk], bb[0], bb[1]);
      mma_bf16_16816(acc[nt], a[kk + 1], bb[2], bb[3]);
    }
  }
}

// acc (16 x 64) += P (16 x 64, fp32 accumulator layout, rounded to bf16) · B,
// with B a 64-row tile in shared memory read as [k][n] (transposed by ldmatrix).
__device__ __forceinline__ void mma_p_b(float (&acc)[8][4], const float (&p)[8][4],
                                        const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {
        pack_f32(p[2 * kk][0], p[2 * kk][1]), pack_f32(p[2 * kk][2], p[2 * kk][3]),
        pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int nt = 0; nt < 8; nt += 2) {
      uint32_t bb[4];
      ldsm_x4_trans(bb, tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                            (nt + (lane >> 4)) * 8);
      mma_bf16_16816(acc[nt], a, bb[0], bb[1]);
      mma_bf16_16816(acc[nt + 1], a, bb[2], bb[3]);
    }
  }
}

}  // namespace attn
