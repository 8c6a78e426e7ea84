// Hopper (sm_90a) primitives shared by the kernels that run on wgmma, TMA,
// bulk copies or warp-level tensor-core products: K1
// (flash_attention_fwd.cu), K3 (decode_attention.cu), K4 (sampler.cu), K5
// and K6 (linear_ce.cu), K7 and K8 (flash_attention_bwd.cu), K10
// (paged_attention.cu). Each source is its own library, so each gets its
// own copy of these inline functions; none defines them again.
//
//  * mbarriers: init, arrive, arrive with an expected byte count, and a
//    wait on the phase parity (the wait passes once the phase of parity
//    `parity` has completed).
//  * TMA: 2-D and 3-D tiled loads from a CUtensorMap into shared memory,
//    their bytes counted on an mbarrier; tensor maps in bf16 with the
//    128-byte swizzle, encoded through the driver entry point that the
//    runtime hands out (no -lcuda), among them the 3-D map of a
//    [B, S, heads, HD] attention operand; and the 1-D bulk copy of a
//    contiguous run of bytes, counted on an mbarrier the same way.
//  * the attention operands' masks (a key's or a query's position, INT_MAX
//    or INT_MIN where it takes no part) and warp reductions of positions;
//    a named barrier of one warpgroup.
//  * mma.sync m16n8k16 bf16 with f32 sums, and movmatrix.trans (the B
//    fragments of P V from rows of V).
//  * wgmma: the shared-memory descriptor of a tile in the 128-byte swizzle,
//    m64nNk16 bf16 products with f32 sums, both operands in shared memory
//    (SS) or A from registers (RS), with the transpose bit of B as a
//    template argument (TB = 1: B is N-contiguous), and the fences that
//    keep the compiler from moving register work across them; the
//    descriptors of tiles stored as TMA boxes of 64 columns (K-major and
//    MN-major) with their steps.
#pragma once

#include "common.cuh"

#include <cuda.h>

// Bytes of a 64-row x 64-column bf16 TMA box (128-byte rows).
constexpr int GMMA_BOX = 64 * 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(RLINF_FULL_MASK, x, o));
  return x;
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(RLINF_FULL_MASK, x, o));
  return x;
}

// Named barrier 1 + c over the 128 threads of consumer warpgroup c.
__device__ __forceinline__ void wg_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Position of key s of batch row b for the attention mask: INT_MAX where
// the key is invalid or past Sk, so that no query sees it.
__device__ __forceinline__ int key_pos(const int* __restrict__ pos_kv,
                                       const uint8_t* __restrict__ valid, int b, int s, int Sk) {
  if (s >= Sk) return INT_MAX;
  const size_t at = (size_t)b * Sk + s;
  return valid[at] ? pos_kv[at] : INT_MAX;
}

// Position of query s of batch row b: INT_MIN past Sq, so that it sees no key.
__device__ __forceinline__ int query_pos(const int* __restrict__ pos_q, int b, int s, int Sq) {
  return s < Sq ? pos_q[(size_t)b * Sq + s] : INT_MIN;
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA); a block
// barrier follows before any thread uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// One 2-D TMA box at coordinates (c0 inner, c1 outer) into shared memory;
// the bytes are counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// One 3-D TMA box at coordinates (c0 innermost, c1, c2 outermost).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// One 1-D bulk copy of `bytes` contiguous bytes (a multiple of 16, both
// addresses 16-byte aligned) from device memory into shared memory; the
// bytes are counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: reached through the
// runtime's entry-point query, so the library links no libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor of `rank` dimensions (dims innermost first, byte strides of
// every dimension but the innermost), read in boxes of `box` elements with
// the 128-byte swizzle (box[0] = 64: 128 bytes); out-of-bounds reads give
// zeros. Strides must be multiples of 16 bytes.
inline bool make_map_nd(CUtensorMap* m, const void* ptr, int rank, const cuuint64_t* dims,
                        const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 matrix of `outer` rows of `inner` elements (row stride `ld`
// elements) read in boxes of 64 x box_outer.
inline bool make_map(CUtensorMap* m, const void* ptr, int inner, int outer, int ld, int box_outer) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)};
  return make_map_nd(m, ptr, 2, dims, strides, box);
}

// x [B, S, heads, HD] bf16 as a 3-D tensor (head columns, S, B), read in
// boxes of 64 columns x `rows` rows of one batch row: a ragged last box
// reads zeros, never the next batch row.
inline bool head_map(CUtensorMap* m, const void* x, int B, int S, int heads, int HD, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(heads) * HD, static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(heads) * HD * 2,
                                 static_cast<cuuint64_t>(S) * heads * HD * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  return make_map_nd(m, x, 3, dims, strides, box);
}

// ---------------------------------------------------------------------------
// Warp-level tensor-core products (K3, K10)
// ---------------------------------------------------------------------------

// c += A B for one mma.sync m16n8k16 bf16 tile with f32 sums: a the A
// fragment (rows g and g + 8, g = lane / 4), b0 and b1 the B fragment.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 8 x 8 b16 matrix held one row pair a lane (row lane / 4, columns
// 2 (lane % 4), + 1), transposed across the warp.
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// wgmma matrix descriptor of a tile in the 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, each in 16-byte units.
// K-major: 128-byte rows, 8-row groups `sbo` = 1024 bytes apart (lbo unused).
// MN-major: 64-element column blocks `lbo` bytes apart, 8-deep k groups
// `sbo` = 1024 bytes apart.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Descriptors of tiles stored as TMA boxes of 64 columns: one base per tile
// plus an immediate step (the start address is the descriptor's low field,
// in 16-byte units).
//
// K-major base descriptor of 64 rows from `row0` of a tile stored as boxes
// of 64 columns, and the step to its 16-deep slice kk when the boxes have
// `rows` rows.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int row0) {
  return gmma_desc(tile + row0 * 128, 16, 1024);
}

__device__ __forceinline__ uint64_t kstep(int rows, int kk) {
  return static_cast<uint64_t>(((kk / 4) * rows * 128 + (kk % 4) * 32) >> 4);
}

// MN-major base descriptor of a tile of 64 rows stored as boxes of 64 x 64
// (the depth of the product runs along the rows); rows 16 u.. are u * 2048
// bytes on.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile) {
  return gmma_desc(tile, GMMA_BOX, 1024);
}

__device__ __forceinline__ uint64_t mnstep(int u) { return static_cast<uint64_t>(u * 2048 >> 4); }

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

// Keeps the compiler from moving or reusing registers that an asynchronous
// wgmma reads or writes across a fence or wait.
template <int K>
__device__ __forceinline__ void fence_regs(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&f)[K][4]) {
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[j][i])::"memory");
}

#define RLINF_ACC8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A B for one m64nNk16 step, A and B in shared memory. The
// accumulator layout: d[4 j + 2 r + e] holds row 16 warp + lane / 4 + 8 r,
// column 8 j + 2 (lane % 4) + e of the warpgroup's 64 x N tile.
template <int N, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         uint32_t accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : RLINF_ACC8(0), RLINF_ACC8(8), RLINF_ACC8(16), RLINF_ACC8(24)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : RLINF_ACC8(0), RLINF_ACC8(8), RLINF_ACC8(16), RLINF_ACC8(24), RLINF_ACC8(32),
          RLINF_ACC8(40), RLINF_ACC8(48), RLINF_ACC8(56)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
  }
}

// d (+)= A B for one m64nNk16 step, A (64 rows x 16 depths, bf16 pairs in
// the accumulator's row layout: a[0] row g, depths 2t..; a[1] row g + 8;
// a[2], a[3] the same 8 depths on) from registers, B from shared memory.
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         uint32_t accumulate) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma_rs: N is 16, 32, 64 or 128");
  if constexpr (N == 16) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : RLINF_ACC8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : RLINF_ACC8(0), RLINF_ACC8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : RLINF_ACC8(0), RLINF_ACC8(8), RLINF_ACC8(16), RLINF_ACC8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : RLINF_ACC8(0), RLINF_ACC8(8), RLINF_ACC8(16), RLINF_ACC8(24), RLINF_ACC8(32),
          RLINF_ACC8(40), RLINF_ACC8(48), RLINF_ACC8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
  }
}

#undef RLINF_ACC8
