// Device helpers for attention kernels built on Hopper's asynchronous units
// (sm_90a only): mbarriers, TMA tile loads through a tensor map, the 128-byte
// shared-memory swizzle, wgmma shared-memory descriptors, the wgmma fences and
// the m64nNk16 bf16 products with fp32 accumulation, and setmaxnreg.  The
// three attention kernels use them, at head dim 64 and 80 (HeadTile).
//
// Conventions.  A tile whose rows are 128 bytes (64 bf16 of one head) lies in
// shared memory as TMA writes it under CU_TENSOR_MAP_SWIZZLE_128B: row r at
// byte r*128, its 16-byte chunk c at chunk position c ^ (r % 8).  Such a tile
// must start at a multiple of 1024 bytes.  (A head of 80 bf16 is 160 bytes,
// which no swizzle span holds: HeadTile below lays it out as five blocks of
// 16 columns under the 32-byte swizzle.)  wgmma reads it through a
// descriptor with the same swizzle:
//   * as a K-major operand (the contraction runs along the 128-byte row: Q
//     and K in S = Q·Kᵀ), 16 contraction elements further is +32 bytes;
//   * as an MN-major B operand (the contraction runs down the rows: V in
//     O += P·V, "transposed B"), 16 contraction elements further is 16 rows,
//     +2048 bytes.
// In both cases 8 rows are 1024 bytes apart (the descriptor's stride offset).
// The fp32 accumulator of a 64 x N product is spread over the warpgroup as
// mma.sync spreads a 16 x 8 tile: warp w holds rows 16w..16w+15, lane = 4g+t
// holds, of n-tile j (8 columns), d[4j+0..1] = row g, columns 8j+2t, +1 and
// d[4j+2..3] = row g+8, same columns.  The register A operand of m64nNk16
// (16 contraction elements) is the mma.sync m16n8k16 A fragment, so the
// accumulators of two neighbouring n-tiles, rounded to bf16, are the A operand
// of the next product without a trip through shared memory.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

typedef __nv_bfloat16 bf16;

constexpr int SWIZZLE_ROW_BYTES = 128;   // one swizzled row: 64 bf16 or 32 fp32
constexpr int SWIZZLE_ATOM_BYTES = 1024;  // 8 rows: the period of the pattern

constexpr float NEG_INF = -1e9f;  // the JAX package's NEG_INF: a masked logit
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte `col_byte` of a 128-byte row as the swizzle places it: `row128` is the
// row's shared-memory offset / 128 from any multiple of 1024 bytes
__device__ __forceinline__ uint32_t swizzle128(uint32_t row128, uint32_t col_byte) {
  return (((col_byte >> 4) ^ (row128 & 7u)) << 4) + (col_byte & 15u);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {  // 2^x; 0 for -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float2 to_float2(float2 x) { return x; }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 x) { return __bfloat1622float2(x); }

// two neighbouring elements of a bias row, as one load
template <typename BiasT>
struct Pair;
template <>
struct Pair<float> { typedef float2 type; };
template <>
struct Pair<bf16> { typedef __nv_bfloat162 type; };

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// after the inits, before any other thread or the TMA unit uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival; releases this thread's earlier shared-memory writes to waiters
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` of TMA traffic to wait for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// spin until the barrier's phase differs from `parity` (a fresh barrier is in
// phase 0: waiting on parity 1 passes at once, on parity 0 waits for the first
// completion)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ----------------------------------------------------------------------- TMA

// One box of a 3-D tensor map -> shared memory; completion is counted in
// bytes on `bar`.  Elements of the box outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One box of shared memory (laid out as tma_load_3d writes it) added, fp32,
// into a 3-D tensor through its map: the additions are done in L2.  The
// issuing thread tracks it in its bulk group (bulk_commit, bulk_wait*);
// elements of the box outside the tensor are dropped.
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// until at most N of this thread's bulk groups are still in flight
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory writes -> visible to the TMA unit
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15; 0 is __syncthreads') of `threads` threads
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_prefetch_descriptor(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// --------------------------------------------------------------------- wgmma

// Descriptor of a 128-byte-swizzled tile at `p` (a multiple of 1024 bytes,
// plus the k-step offset): start address, leading offset (unused by these
// shapes, 1 as CUTLASS sets it), stride offset 1024 bytes, swizzle mode 1.
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* p) {
  uint64_t desc = (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4);
  desc |= (uint64_t)1 << 16;
  desc |= (uint64_t)(SWIZZLE_ATOM_BYTES >> 4) << 32;
  desc |= (uint64_t)1 << 62;
  return desc;
}

// the descriptor `bytes` further on (bytes a multiple of 16)
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc, int bytes) {
  return desc + (uint64_t)(bytes >> 4);
}

// Descriptor of a tile of 32-byte rows (16 bf16) under the 32-byte swizzle at
// `p` (a multiple of 256 bytes): 8 rows are 256 bytes apart (stride offset),
// and `lbo` bytes separate two such blocks of 16 columns along N when the tile
// is an MN-major B operand wider than 16 (the leading offset; a K-major
// operand reads one block a k-step and ignores it); swizzle mode 3.
__device__ __forceinline__ uint64_t smem_desc_sw32(const void* p, int lbo) {
  uint64_t desc = (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4);
  desc |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  desc |= (uint64_t)(256 >> 4) << 32;
  desc |= (uint64_t)3 << 62;
  return desc;
}

// before the first wgmma that reads registers or shared memory written by
// ordinary arithmetic of this warpgroup
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving uses of accumulator or A-operand registers
// across the asynchronous product's fence, issue or wait
template <int N>
__device__ __forceinline__ void fence_registers(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_registers(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define WG_F8(d, o)                                                                          \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),            \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d (64 x 128, fp32) = or += A (64 x 16, shared, K-major) · B (128 x 16,
// shared, K-major)ᵀ; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24), WG_F8(d, 32), WG_F8(d, 40),
        WG_F8(d, 48), WG_F8(d, 56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, fp32) = or += A (64 x 16, shared, K-major) · B (64 x 16, shared,
// K-major)ᵀ
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, fp32) = or += A (64 x 16, registers: the m16n8k16 A fragment of
// this warp's 16 rows) · B (16 x 64, shared, MN-major: 16 rows of 64 bf16)
__device__ __forceinline__ void wgmma_m64n64k16_rs_bt(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// d (64 x 80, fp32) = or += A (64 x 16, registers) · B (16 x 80, shared,
// MN-major: five blocks of 16 columns, `lbo` bytes apart in the descriptor)
__device__ __forceinline__ void wgmma_m64n80k16_rs_bt(float (&d)[40], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n"
      "}\n"
      : WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24), WG_F8(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

#undef WG_F8

// ------------------------------------------------------------- head tiles

// How a tile of `rows` rows of one head (D bf16 a row, D = 64 or 80) lies in
// shared memory, and how TMA and wgmma reach it.
//   * D = 64: one block under the 128-byte swizzle, a row 128 bytes (one TMA
//     box of 64 columns).  This is the layout every kernel had before D = 80.
//   * D = 80: five blocks of 16 columns, each `rows` x 32 bytes under the
//     32-byte swizzle (five TMA boxes of 16 columns, each starting at a
//     multiple of 32 bytes of the head, so none reads the next head's
//     columns).  A K-major operand takes one block a k-step; an MN-major B
//     operand spans the five blocks through the descriptor's leading offset,
//     so O += P·V and its kin are one m64n80k16 a k-step.
template <int D>
struct HeadTile {
  static_assert(D == 64 || D == 80, "head dim 64 or 80");
  static constexpr int BOX_COLS = D == 64 ? 64 : 16;    // columns of one TMA box
  static constexpr int BOXES = D / BOX_COLS;            // 1 or 5
  static constexpr int BOX_ROW_BYTES = BOX_COLS * 2;    // 128 or 32
  static constexpr int KSTEP_MN = 16 * BOX_ROW_BYTES;   // 16 rows: 2048 or 512 bytes

  // byte offset of row r's first box in a tile (row r of every box is at the
  // same offset in it)
  __host__ __device__ static constexpr int row_offset(int r) { return r * BOX_ROW_BYTES; }
  // bytes from the start of a tile of `rows` rows to k-step kk (16 columns)
  __host__ __device__ static constexpr int kstep_k(int kk, int rows) {
    return (kk * 32) % BOX_ROW_BYTES + (kk * 32) / BOX_ROW_BYTES * rows * BOX_ROW_BYTES;
  }
  // descriptor of a K-major operand starting at p (a row of a tile)
  static __device__ uint64_t desc_k(const void* p) {
    if constexpr (D == 64) return smem_desc_sw128(p);
    else return smem_desc_sw32(p, 16);
  }
  // descriptor of an MN-major B operand at p, in a tile of `rows` rows
  static __device__ uint64_t desc_mn(const void* p, int rows) {
    if constexpr (D == 64) return smem_desc_sw128(p);
    else return smem_desc_sw32(p, rows * BOX_ROW_BYTES);
  }
};

// One tile of `rows` rows of head h, from row `row` of batch row b of a map
// made by encode_head_map, into dst; completion counted on bar.
template <int D>
__device__ __forceinline__ void tma_load_head(unsigned char* dst, const CUtensorMap* map,
                                              uint64_t* bar, int h, int row, int b, int rows) {
  typedef HeadTile<D> HT;
#pragma unroll
  for (int c = 0; c < HT::BOXES; ++c)
    tma_load_3d(dst + c * rows * HT::BOX_ROW_BYTES, map, bar, h * D + c * HT::BOX_COLS, row, b);
}

// d += A (registers) · B (MN-major head tile), N = D
template <int D>
__device__ __forceinline__ void wgmma_rs_bt(float (&d)[D / 2], const uint32_t (&a)[4],
                                            uint64_t desc_b, int accumulate) {
  if constexpr (D == 64) wgmma_m64n64k16_rs_bt(d, a, desc_b, accumulate);
  else wgmma_m64n80k16_rs_bt(d, a, desc_b, accumulate);
}

// ---------------------------------------------------- registers between roles

// A warpgroup gives registers up (producer) or takes them (consumer); all four
// warps execute it, in a branch that never rejoins the other role's.
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// ------------------------------------------------------------ host: tensor maps

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda.
typedef CUresult (*TensorMapEncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                           const cuuint64_t*, const cuuint64_t*,
                                           const cuuint32_t*, const cuuint32_t*,
                                           CUtensorMapInterleave, CUtensorMapSwizzle,
                                           CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline TensorMapEncodeTiledFn tensor_map_encoder() {
  static TensorMapEncodeTiledFn fn = []() -> TensorMapEncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &status);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (e != cudaSuccess || status != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<TensorMapEncodeTiledFn>(p);
  }();
  return fn;
}

// Map over an array of `rank` (2 or 3) dimensions, innermost first: dims[0]
// contiguous elements (bf16, or fp32) a row, dimension i > 0 strides[i - 1]
// bytes apart (multiples of 16; the base 16-byte aligned).  A box is box[0] x
// box[1] (x 1) elements with box[0] spanning 128 bytes, written to shared
// memory under the 128-byte swizzle (the pattern is anchored at multiples of
// 1024 bytes of the shared address), or 32 bytes under the 32-byte swizzle.
// A box must start at a multiple of 16 bytes of the array; what it holds past
// the array's edges is filled with zeros.  Returns 0 or
// cuTensorMapEncodeTiled's error.
inline int encode_map(CUtensorMap* map, const void* base, bool fp32, int rank,
                      const uint64_t* dims, const uint64_t* strides, const uint32_t* box,
                      CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const TensorMapEncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return -1;
  cuuint64_t d[3], st[2];
  cuuint32_t bx[3], elem_strides[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    if (i > 0) st[i - 1] = strides[i - 1];
  }
  return static_cast<int>(encode(
      map, fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
      const_cast<void*>(base), d, st, bx, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// Map over a packed operand (B, L, H·D) bf16 seen as (H·D, L, B), in boxes of
// one head's HeadTile<D> block x `rows` rows: a box past L is zero-filled and
// never reads the next batch row.
template <int D>
inline int encode_head_map(CUtensorMap* map, const void* base, int B, int H, int L, int rows) {
  typedef HeadTile<D> HT;
  const uint64_t row = (uint64_t)H * D * 2;
  const uint64_t dims[3] = {(uint64_t)H * D, (uint64_t)L, (uint64_t)B};
  const uint64_t strides[2] = {row, (uint64_t)L * row};
  const uint32_t box[3] = {(uint32_t)HT::BOX_COLS, (uint32_t)rows, 1};
  return encode_map(map, base, false, 3, dims, strides, box,
                    D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B);
}

}  // namespace wg
