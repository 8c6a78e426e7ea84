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

// A bf16 (or f16: `type`) tensor of `rank` dimensions (dims innermost
// first, byte strides of every dimension but the innermost), read in boxes
// of `box` elements with the 128-byte swizzle (box[0] = 64: 128 bytes);
// out-of-bounds reads give zeros. Strides must be multiples of 16 bytes.
inline bool make_map_nd(CUtensorMap* m, const void* ptr, int rank, const cuuint64_t* dims,
                        const cuuint64_t* strides, const cuuint32_t* box,
                        CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(m, type, rank, const_cast<void*>(ptr), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 (or f16: `type`) matrix of `outer` rows of `inner` elements (row
// stride `ld` elements) read in boxes of 64 x box_outer.
inline bool make_map(CUtensorMap* m, const void* ptr, int inner, int outer, int ld, int box_outer,
                     CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)};
  return make_map_nd(m, ptr, 2, dims, strides, box, type);
}

// x [B, S, heads, HD] bf16 (or f16: `type`) as a 3-D tensor (head columns,
// S, B), read in boxes of 64 columns x `rows` rows of one batch row: a
// ragged last box reads zeros, never the next batch row.
inline bool head_map(CUtensorMap* m, const void* x, int B, int S, int heads, int HD, int rows,
                     CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(heads) * HD, static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(heads) * HD * 2,
                                 static_cast<cuuint64_t>(S) * heads * HD * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  return make_map_nd(m, x, 3, dims, strides, box, type);
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

// The wgmma instructions of the products below, for operands of type TY
// ("bf16" or "f16": the same fragment layouts), d and the operands named
// as in the functions.
#define RLINF_WGMMA_SS64(TY) \
  asm volatile( \
  "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
  "}, %32, %33, p, 1, 1, 0, %35;\n}\n" \
  : RLINF_ACC8(0), RLINF_ACC8(8), RLINF_ACC8(16), RLINF_ACC8(24) \
  : "l"(da), "l"(db), "r"(accumulate), "n"(TB));

#define RLINF_WGMMA_SS128(TY) \
  asm volatile( \
  "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
  "}, %64, %65, p, 1, 1, 0, %67;\n}\n" \
  : RLINF_ACC8(0), RLINF_ACC8(8), RLINF_ACC8(16), RLINF_ACC8(24), RLINF_ACC8(32), \
  RLINF_ACC8(40), RLINF_ACC8(48), RLINF_ACC8(56) \
  : "l"(da), "l"(db), "r"(accumulate), "n"(TB));

#define RLINF_WGMMA_RS16(TY) \
  asm volatile( \
  "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7" \
  "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n" \
  : RLINF_ACC8(0) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));

#define RLINF_WGMMA_RS32(TY) \
  asm volatile( \
  "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15" \
  "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n" \
  : RLINF_ACC8(0), RLINF_ACC8(8) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));

#define RLINF_WGMMA_RS64(TY) \
  asm volatile( \
  "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
  "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
  : RLINF_ACC8(0), RLINF_ACC8(8), RLINF_ACC8(16), RLINF_ACC8(24) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));

#define RLINF_WGMMA_RS128(TY) \
  asm volatile( \
  "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
  "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
  : RLINF_ACC8(0), RLINF_ACC8(8), RLINF_ACC8(16), RLINF_ACC8(24), RLINF_ACC8(32), \
  RLINF_ACC8(40), RLINF_ACC8(48), RLINF_ACC8(56) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));

// d (+)= A B for one m64nNk16 step, A and B in shared memory (F16: f16
// operands, else bf16). The accumulator layout: d[4 j + 2 r + e] holds row
// 16 warp + lane / 4 + 8 r, column 8 j + 2 (lane % 4) + e of the
// warpgroup's 64 x N tile.
template <int N, int TB, bool F16 = false>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         uint32_t accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64) {
    if constexpr (F16) {
      RLINF_WGMMA_SS64("f16");
    } else {
      RLINF_WGMMA_SS64("bf16");
    }
  } else {
    if constexpr (F16) {
      RLINF_WGMMA_SS128("f16");
    } else {
      RLINF_WGMMA_SS128("bf16");
    }
  }
}

// d (+)= A B for one m64nNk16 step, A (64 rows x 16 depths, bf16 or, with
// F16, f16 pairs in the accumulator's row layout: a[0] row g, depths 2t..; a[1] row g + 8;
// a[2], a[3] the same 8 depths on) from registers, B from shared memory.
template <int N, int TB, bool F16 = false>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         uint32_t accumulate) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma_rs: N is 16, 32, 64 or 128");
  if constexpr (N == 16) {
    if constexpr (F16) {
      RLINF_WGMMA_RS16("f16");
    } else {
      RLINF_WGMMA_RS16("bf16");
    }
  } else if constexpr (N == 32) {
    if constexpr (F16) {
      RLINF_WGMMA_RS32("f16");
    } else {
      RLINF_WGMMA_RS32("bf16");
    }
  } else if constexpr (N == 64) {
    if constexpr (F16) {
      RLINF_WGMMA_RS64("f16");
    } else {
      RLINF_WGMMA_RS64("bf16");
    }
  } else {
    if constexpr (F16) {
      RLINF_WGMMA_RS128("f16");
    } else {
      RLINF_WGMMA_RS128("bf16");
    }
  }
}

#undef RLINF_ACC8
#undef RLINF_WGMMA_SS64
#undef RLINF_WGMMA_SS128
#undef RLINF_WGMMA_RS16
#undef RLINF_WGMMA_RS32
#undef RLINF_WGMMA_RS64
#undef RLINF_WGMMA_RS128

// ---------------------------------------------------------------------------
// mma.sync tiles of any element type: the attention kernels' forms for head
// dims 16 and 32, and for f16 and f32 operands (K1, K2, K3, K7, K8, K10)
// ---------------------------------------------------------------------------
//
// The operands are staged in shared memory as they are stored (bf16, f16,
// f32, or K3's int8) and turned into mma.sync m16n8k16 fragments as they are
// read. bf16 and f16 run on their own forms of the instruction. An f32
// operand x runs as two bf16 parts, hi = bf16(x) and lo = bf16(x - hi), and
// a product of two f32 operands as hi hi + hi lo + lo hi: three products,
// the dropped lo lo term is about 2^-16 of the product (tf32 would keep
// 2^-11). int8 widens exactly into either form. Values formed in f32 inside
// a kernel (the probabilities, the score gradients) enter their product as
// hi and lo parts of the operand form, so that they keep f32 accuracy.

// c += A B for one mma.sync m16n8k16 f16 tile with f32 sums (mma_bf16's layout).
__device__ __forceinline__ void mma_f16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

// The element type T of a kernel's operands and outputs: the form of its
// products (bf16 for bf16 and for the parts of f32, f16 for f16), how a pair
// of values becomes a fragment register (hi, and lo for f32), and how a
// value is stored; for bf16 and f16 also a pair packed into one register
// and the tensor maps' data type (the wgmma kernels' two forms). dtype codes as the wrappers pass them: 0 bf16, 1 f16, 2 f32.
template <class T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr bool SPLIT = false;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ static __nv_bfloat16 put(float x) { return __float2bfloat16(x); }
  __device__ static uint32_t pack(float a, float b) { return pack_bf16(a, b); }
  __device__ static void frag(float a, float b, uint32_t& hi, uint32_t& lo) {
    hi = pack_bf16(a, b);
    lo = 0u;
  }
  __device__ static void parts(float a, float b, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = pack_bf16(a - hf.x, b - hf.y);
  }
  __device__ static void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    mma_bf16(c, a, b0, b1);
  }
};

template <>
struct Elem<__half> {
  static constexpr bool SPLIT = false;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ static __half put(float x) { return __float2half(x); }
  __device__ static uint32_t pack(float a, float b) { return pack_f16(a, b); }
  __device__ static void frag(float a, float b, uint32_t& hi, uint32_t& lo) {
    hi = pack_f16(a, b);
    lo = 0u;
  }
  __device__ static void parts(float a, float b, uint32_t& hi, uint32_t& lo) {
    const __half2 h = __floats2half2_rn(a, b);
    const float2 hf = __half22float2(h);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = pack_f16(a - hf.x, b - hf.y);
  }
  __device__ static void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    mma_f16(c, a, b0, b1);
  }
};

template <>
struct Elem<float> {
  static constexpr bool SPLIT = true;
  __device__ static float put(float x) { return x; }
  __device__ static void frag(float a, float b, uint32_t& hi, uint32_t& lo) {
    Elem<__nv_bfloat16>::parts(a, b, hi, lo);
  }
  __device__ static void parts(float a, float b, uint32_t& hi, uint32_t& lo) {
    Elem<__nv_bfloat16>::parts(a, b, hi, lo);
  }
  __device__ static void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    mma_bf16(c, a, b0, b1);
  }
};

// A fragment (rows g, g + 8; depths 2t, 2t + 1, 2t + 8, 2t + 9) and B
// fragment (column g; depths 2t, 2t + 1 and 2t + 8, 2t + 9), hi and lo parts.
struct FragA {
  uint32_t h[4], l[4];
};
struct FragB {
  uint32_t h[2], l[2];
};

// c += A B in T's form: one product, three for f32 operands.
template <class T>
__device__ __forceinline__ void mma_ab(float (&c)[4], const FragA& a, const FragB& b) {
  Elem<T>::mma(c, a.h, b.h[0], b.h[1]);
  if constexpr (Elem<T>::SPLIT) {
    Elem<T>::mma(c, a.h, b.l[0], b.l[1]);
    Elem<T>::mma(c, a.l, b.h[0], b.h[1]);
  }
}

// c += P B, P an f32 value held as hi and lo parts of T's form (parts()).
template <class T>
__device__ __forceinline__ void mma_pb(float (&c)[4], const FragA& p, const FragB& b) {
  Elem<T>::mma(c, p.h, b.h[0], b.h[1]);
  Elem<T>::mma(c, p.l, b.h[0], b.h[1]);
  if constexpr (Elem<T>::SPLIT) Elem<T>::mma(c, p.h, b.l[0], b.l[1]);
}

// The A fragment of rows r0.., depths k0.. of a row-major tile x (row
// stride ld elements), in T's form.
template <class T, class X>
__device__ __forceinline__ FragA frag_a(const X* x, int ld, int r0, int k0, int lane) {
  const int g = lane / 4, t = lane % 4;
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const X* p = x + (size_t)(r0 + g + 8 * (i % 2)) * ld + k0 + 2 * t + 8 * (i / 2);
    Elem<T>::frag(to_f32(p[0]), to_f32(p[1]), f.h[i], f.l[i]);
  }
  return f;
}

// The B fragment of columns n0.. and depths k0.. where B[k][n] = x[n][k]
// (x's rows are B's columns: K in S = Q K^T).
template <class T, class X>
__device__ __forceinline__ FragB frag_bt(const X* x, int ld, int n0, int k0, int lane) {
  const int g = lane / 4, t = lane % 4;
  FragB f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const X* p = x + (size_t)(n0 + g) * ld + k0 + 2 * t + 8 * i;
    Elem<T>::frag(to_f32(p[0]), to_f32(p[1]), f.h[i], f.l[i]);
  }
  return f;
}

// The B fragment of depths k0.. and columns n0.. where B[k][n] = x[k][n]
// (V in P V).
template <class T, class X>
__device__ __forceinline__ FragB frag_b(const X* x, int ld, int k0, int n0, int lane) {
  const int g = lane / 4, t = lane % 4;
  FragB f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const X* p = x + (size_t)(k0 + 2 * t + 8 * i) * ld + n0 + g;
    Elem<T>::frag(to_f32(p[0]), to_f32(p[ld]), f.h[i], f.l[i]);
  }
  return f;
}

// The A fragment of an f32 m16 x k16 block held as two accumulator tiles
// (c0: depths 0-7, c1: depths 8-15, each in mma's C layout), as hi and lo
// parts: P in P V, dS in dS K.
template <class T>
__device__ __forceinline__ FragA frag_acc(const float (&c0)[4], const float (&c1)[4]) {
  FragA f;
  Elem<T>::parts(c0[0], c0[1], f.h[0], f.l[0]);
  Elem<T>::parts(c0[2], c0[3], f.h[1], f.l[1]);
  Elem<T>::parts(c1[0], c1[1], f.h[2], f.l[2]);
  Elem<T>::parts(c1[2], c1[3], f.h[3], f.l[3]);
  return f;
}

// Copies rows [0, rows) of `cols` elements each from src (row stride lds
// elements) into a shared tile (row stride ldd), 16 bytes a copy, by
// `nthreads` threads from thread `tid`; rows where row_ptr gives nullptr are
// zero. cols * sizeof(X) and both strides' bytes are multiples of 16.
template <class X, class RowPtr>
__device__ __forceinline__ void stage_rows(X* dst, int ldd, int rows, int cols, RowPtr row_ptr,
                                           int tid, int nthreads) {
  constexpr int PER = 16 / sizeof(X);
  const int vpr = cols / PER;
  for (int i = tid; i < rows * vpr; i += nthreads) {
    const int r = i / vpr, c = (i % vpr) * PER;
    const X* src = row_ptr(r);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr) v = *reinterpret_cast<const uint4*>(src + c);
    *reinterpret_cast<uint4*>(dst + (size_t)r * ldd + c) = v;
  }
}

// Row stride of a staged tile of HD columns: 16 bytes of padding, so that
// the eight rows a fragment reads fall in different banks.
template <class X, int HD>
__host__ __device__ constexpr int tile_ld() {
  return HD + 16 / (int)sizeof(X);
}

// One split of one-token decode attention on mma.sync, for every element
// type and head dim (K2, K3: the packed cache; K10: pages): the G <= 16
// query heads of kv head `kvh` of row b are the rows of the products (heads
// g and g + 8 in a lane's rows), over the keys [lo, hi) in blocks of 16, of
// which [vlo, vhi) take part. Four warps take blocks w, w + 4, ...; each
// stages its block's K and V rows (key_row(key) -> pointer, or nullptr past
// the cache) in shared memory and multiplies them there. The per-slot
// scales (scales(key) -> (k scale, v scale): K3's, 1 elsewhere) fold into
// the score and the probability. The four warps' states merge through shared memory, and the
// split writes its state as the merge kernels read it: o at part_o
// [G][HD], (m in log2 units, l) at part_ml [G][2].
constexpr int ANY_NW = 4;
template <class C, int HD>
__host__ __device__ constexpr int any_decode_smem() {
  return ANY_NW * 2 * 16 * tile_ld<C, HD>() * (int)sizeof(C) > ANY_NW * 16 * (HD + 2) * 4
             ? ANY_NW * 2 * 16 * tile_ld<C, HD>() * (int)sizeof(C)
             : ANY_NW * 16 * (HD + 2) * 4;
}

template <class T, class C, int HD, class KeyRow, class Scales>
__device__ __forceinline__ void any_decode_split(const T* __restrict__ q, int G, int lo, int hi,
                                                 int vlo, int vhi, KeyRow k_row, KeyRow v_row,
                                                 Scales scales, float scale,
                                                 float* __restrict__ part_o,
                                                 float* __restrict__ part_ml,
                                                 unsigned char* smem) {
  constexpr int LD = tile_ld<C, HD>();
  constexpr float L2E = 1.4426950408889634f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  C* ks_t = reinterpret_cast<C*>(smem) + warp * 2 * 16 * LD;
  C* vs_t = ks_t + 16 * LD;
  // the query heads' fragments (heads past G read head 0; their rows are
  // never stored)
  FragA qf[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int hh = g + 8 * (i % 2);
      const T* p = q + (size_t)(hh < G ? hh : 0) * HD + 16 * kk + 2 * t + 8 * (i / 2);
      Elem<T>::frag(to_f32(p[0]), to_f32(p[1]), qf[kk].h[i], qf[kk].l[i]);
    }
  }
  const float scale2 = scale * L2E;
  float m[2] = {RLINF_NEG_INF, RLINF_NEG_INF}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const int nblk = (hi - lo + 15) / 16;
  for (int blk = warp; blk < nblk; blk += ANY_NW) {
    const int key0 = lo + 16 * blk;
    __syncwarp();  // the previous block is read
    stage_rows<C>(ks_t, LD, 16, HD, [&](int r) { return key0 + r < hi ? k_row(key0 + r) : nullptr; },
                  lane, 32);
    stage_rows<C>(vs_t, LD, 16, HD, [&](int r) { return key0 + r < hi ? v_row(key0 + r) : nullptr; },
                  lane, 32);
    __syncwarp();
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) mma_ab<T>(s[nt], qf[kk], frag_bt<T>(ks_t, LD, 8 * nt, 16 * kk, lane));
    // s[nt][2 r + e]: head g + 8 r, key key0 + 8 nt + 2 t + e
    bool ok[2][2];
    float kscale[2][2], vscale[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * nt + 2 * t + e;
        ok[nt][e] = key >= vlo && key < vhi && key < hi;
        const float2 sc = ok[nt][e] ? scales(key) : make_float2(0.f, 0.f);
        kscale[nt][e] = sc.x;
        vscale[nt][e] = sc.y;
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * r + e];
          x = ok[nt][e] ? x * scale2 * kscale[nt][e] : RLINF_NEG_INF;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(RLINF_FULL_MASK, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(RLINF_FULL_MASK, mx, 2));
      alpha[r] = exp2f(m[r] - mx);
      m[r] = mx;
      l[r] *= alpha[r];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * r + e];
          const float p = ok[nt][e] ? exp2f(x - mx) : 0.f;
          l[r] += p;
          x = p * vscale[nt][e];
        }
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    const FragA pf = frag_acc<T>(s[0], s[1]);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) mma_pb<T>(o[n], pf, frag_b<T>(vs_t, LD, 0, 8 * n, lane));
  }
  // merge the four warps' states through shared memory
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(RLINF_FULL_MASK, l[r], 1);
    l[r] += __shfl_xor_sync(RLINF_FULL_MASK, l[r], 2);
  }
  __syncthreads();
  float* mo = reinterpret_cast<float*>(smem);  // [NW][16][HD]
  float* mm = mo + ANY_NW * 16 * HD;           // [NW][16]
  float* ml = mm + ANY_NW * 16;                // [NW][16]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int hh = g + 8 * r;
    float* row = mo + (warp * 16 + hh) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
    if (t == 0) {
      mm[warp * 16 + hh] = m[r];
      ml[warp * 16 + hh] = l[r];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += ANY_NW * 32) {
    const int gg = idx / HD, d = idx % HD;
    float M = RLINF_NEG_INF;
#pragma unroll
    for (int w = 0; w < ANY_NW; ++w) M = fmaxf(M, mm[w * 16 + gg]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < ANY_NW; ++w) {
      const float e = exp2f(mm[w * 16 + gg] - M);
      L = fmaf(ml[w * 16 + gg], e, L);
      A = fmaf(mo[(w * 16 + gg) * HD + d], e, A);
    }
    part_o[gg * HD + d] = A;
    if (d == 0) *reinterpret_cast<float2*>(part_ml + gg * 2) = make_float2(M, L);
  }
}
