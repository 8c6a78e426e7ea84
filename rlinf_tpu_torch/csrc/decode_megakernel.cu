// Kernel K9: one whole decode step over all layers in a single launch.
//
// Replaces the Pallas TPU kernel _mega_kernel of
// rlinf_tpu/ops/pallas/decode_megakernel.py (decode_step_mega). Same
// function, per layer: rms-norm, int8 qkv product + bias, rope on the packed
// [B, H*Hd] layout, int8 quantization of the new k/v from the f32 rope
// output, attention over the int8 cache on [starts, write_pos) plus the
// current token exactly in f32 (seeded as m = s_cur, l = 1, acc = v),
// o-projection + residual, rms-norm, gate/up + SiLU, down + residual. The
// residual stream is f32 from the first layer to the last; the normed
// activations, the attention output and the gate/up activations are rounded
// to bf16 where the Pallas body rounds them; every product accumulates in
// f32 and is scaled per output channel after its sum. Slot write_pos[row]
// of the four cache arrays is written in place (past-key reads exclude it).
//
// What bounds it on an H100: bytes. One step reads every int8 weight once
// (1.31 GB at Qwen2-1.5B, 6.5 GB at Qwen2-7B) and the valid part of the
// int8 cache, for 2*B flops a weight byte (B <= 64 rows), far left of the
// ridge point.
//
// Design. A persistent cooperative grid, one CTA on every SM, walks the
// layers together; a grid-wide barrier (one atomic counter) closes each of
// the nine phases of a layer:
//
//   qkv          qkv partials = bf16(rms_norm(x)) @ Wqkv, K-sliced
//   qkv_sum      qkv = their sum * scale + bias, rope on q and k; each
//                row's max |k| and |v| over each half of a kv head
//   attention    split-KV over the int8 cache, the splits merged into att
//   o_proj       o partials = att @ Wo
//   o_sum        x += their sum * scale; the rows' sums of squares
//   gate_up      gate and up partials = bf16(rms_norm(x)) @ [Wg | Wu]
//   gate_up_sum  gu = bf16(silu(bf16(gate)) * up)
//   down         down partials = gu @ Wdown
//   down_sum     x += their sum * scale; the rows' sums of squares
//
//  * The weight stream never stops. Which weight tiles a CTA multiplies,
//    and in which order, is fixed at launch for the whole step, so one
//    producer warp walks that order once and keeps a ring of RING 4 KB
//    shared-memory stages filled by 1-D bulk copies (cp.async.bulk) that
//    complete on mbarriers, under an evict-first L2 policy (the partial
//    sums and activations that the next phase reads stay in the L2). It
//    never waits for a grid barrier: while the consumers wait at one, run
//    attention or stage activations, the next phase's tiles (and the next
//    layer's) land. Only activations wait for the barriers.
//  * Products on wgmma with the operands swapped, z^T = W^T h^T, as K4
//    (csrc/sampler.cu): a tile is 64 output columns x 64 depths, packed so
//    that thread i of a warpgroup finds its A fragments of the four k16
//    steps as two 16-byte words at i * 16 and 2048 + i * 16; they are
//    widened to bf16 in registers (exactly) and multiply the staged
//    activations (64 batch rows, bf16, 128-byte swizzle) as B from shared
//    memory. A CTA's two warpgroups take the two 64-column units of a work
//    item; the item's tiles alternate in the ring. (ptxas serialises the
//    wgmma: the SASS has one wait a product.)
//  * Every product is K-sliced: a CTA works on one slice of the depth
//    (ops/cuda/decode_megakernel.py plans the slices per product) and
//    stages only that slice of the activations, so the hidden size is
//    bounded by the partials workspace, not by shared memory. A warpgroup
//    writes its raw f32 sums in fragment order (coalesced); after a
//    barrier every warp of the grid adds a share of them up, in slice
//    order, and finishes it (reduce_phase, qkv_sum_phase). A single CTA
//    finishing each unit once its slices were in (an atomic count per
//    unit) was tried first: its serial reads of KS partial tiles were the
//    slowest part of the phase, the more so the more slices. The next
//    product stages bf16(rms_norm(x)) from x and the sums of squares: no
//    norm phase. The order of every sum is fixed, so a step gives the same
//    bits each run.
//  * Attention is K3's split-KV (csrc/decode_attention.cu): items (row, kv
//    head, split) over every consumer warp, the cache staged by per-lane
//    cp.async rings, scores on mma.sync with the f32 query in bf16 hi and
//    lo parts (hi in rows 0-7 of the product, lo in rows 8-15: one mma for
//    both), and the output as o^T = V^T P^T (depths as rows: no row wasted
//    on the G <= 8 heads) with P in hi and lo parts. A row's last split
//    (its fewest blocks) also holds the current token, exactly in f32, and
//    writes the cache slot. The splits of a (row, kv head) wait for each
//    other (an atomic count) and merge its output together, a share each.
//  * Registers: nine warps an SM cap a thread at 168 (one SM sub-partition
//    holds three warps). Every phase is inlined (a call's saved registers
//    spilled in the caller), so each keeps its peak down: o as V^T P^T, the
//    query's fragments in shared memory, 16 float4 loads in flight in the
//    sums.

#include "hopper.cuh"

#include <atomic>

namespace {

constexpr int NCW = 8;                    // consumer warps: two warpgroups
constexpr int NCT = NCW * 32;             // consumer threads
constexpr int NTHREADS = NCT + 32;        // and one producer warp
constexpr int MAXG = 8;                   // most query heads per kv head
constexpr int KBLK = 64;                  // depth of a weight tile and of a staged activation block
constexpr int UNIT = 64;                  // output columns of a weight tile: the M of a wgmma
constexpr int ROWS = 64;                  // batch rows of a row block: the N of a wgmma
constexpr int TILE = UNIT * KBLK;         // bytes of an int8 weight tile
constexpr int RING = 16;                  // weight tiles of the shared-memory ring
constexpr int ACT_BLK = ROWS * KBLK * 2;  // bytes of a staged bf16 activation k-block
constexpr int KBS_MAX = 16;               // most k-blocks of a K-slice
constexpr int SMEM_CAP = 232448;          // shared memory a CTA can have on sm_90
constexpr int KEYS = 16;                  // keys of an attention block
constexpr int ATT_RING = 3;               // stages of a warp's attention ring
constexpr int CHUNK = 32 * 16;            // one 16-byte chunk of each lane
constexpr float LOG2E = 1.4426950408889634f;

enum Gemm { QKV = 0, OPROJ = 1, GATE_UP = 2, DOWN = 3 };

// 64-depth chunks of a head row in attention: a head of 16 or 32 depths
// takes one chunk whose lanes past the head (16 t >= HD) load zeros and
// are never stored, so no cache row is copied or padded
__host__ __device__ constexpr int att_nc(int HD) { return HD < 64 ? 1 : HD / 64; }
__host__ __device__ constexpr int att_chunks(int HD) { return 4 * att_nc(HD) + 2; }
__host__ __device__ constexpr int att_stage(int HD) { return att_chunks(HD) * CHUNK; }
// a warp's attention: its ring, then its query fragments ([cc][j][lane],
// 16 bytes each: the hi and lo parts of k-step j of chunk cc)
__host__ __device__ constexpr int att_warp(int HD) { return ATT_RING * att_stage(HD) + 32 * 4 * att_nc(HD) * 16; }
__host__ __device__ constexpr int union_bytes(int HD) {
  return KBS_MAX * ACT_BLK > NCW * att_warp(HD) ? KBS_MAX * ACT_BLK : NCW * att_warp(HD);
}
// From the first 1024-aligned byte: full, empty mbarriers and rstd [ROWS]
// in the first KB, the ring, then the staged activations or attention;
// 1 KB of slack for the alignment (the swizzle needs it). Nothing but the
// total depends on HD, so every phase finds its buffers alone (smem_of).
constexpr int MISC_BYTES = 1024;
static_assert(RING * 16 + ROWS * 4 <= MISC_BYTES, "barriers and rstd");
__host__ __device__ constexpr int smem_bytes(int HD) {
  return 1024 + MISC_BYTES + RING * TILE + union_bytes(HD);
}

struct MegaArgs {
  const int8_t* stream;        // [L, layer_bytes]: wqkv | wo | wgu | down, each [N/64][K/64][TILE]
  const float* scales;         // [L, W + D + 2F + D], gate/up in the units' interleaved order
  const float* norms;          // [L, 2, D]
  const float* bias;           // [L, W]
  const __nv_bfloat16* x0;     // [B, D]
  const float* cos_tab;        // [S_rope, HD]
  const float* sin_tab;
  int8_t* kc;                  // [L, B, S, KVD]
  int8_t* vc;
  float* ks;                   // [L, B, S]
  float* vs;
  const int* wps;              // [B]
  const int* positions;        // [B]
  const int* starts;           // [B]
  __nv_bfloat16* out;          // [B, D]
  float* x;                    // [B, D] residual stream
  float* qkv;                  // [B, W] finished qkv rows: bias added, rope on q and k
  float* kvmax;                // [B, KV, 2, 2] max |k|, max |v| of each row's kv head, by half
  __nv_bfloat16* att;          // [B, D]
  __nv_bfloat16* gu;           // [B, F]
  float* ssq;                  // [D / 64, B] sums of squares of x, by 64-column unit
  float* part;                 // [row blocks, KS, units, 8, 128 threads, 4] raw f32 sums
  float* apart;                // [B * KV, NS, G, HD + 4] attention splits: o, m, l, 2 unused
  unsigned* sync;              // [1 + B * KV], 0 at launch: grid barrier, attention counts
  unsigned long long* clock;   // [L * 9 + 2] %globaltimer at every phase edge, or null
  int B, S, L, D, H, KV, HD, F, S_rope;
  int slices[4];               // K-slices of qkv, o_proj, gate/up, down
  int bps, ns;                 // attention: 16-key blocks a split, splits a row
  float eps, scale;
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The 256 consumer threads (the producer warp never joins a block barrier);
// named barrier 3: wg_sync holds 1 and 2.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// Phase edge `edge` as CTA 0 sees it (only where the caller asked for it).
__device__ __forceinline__ void stamp(unsigned long long* clock, int edge) {
  if (clock != nullptr && blockIdx.x == 0 && threadIdx.x == 0) clock[edge] = global_ns();
}

// Every CTA's consumers arrive; `target` counts arrivals.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned& target) {
  target += gridDim.x;
  consumer_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    while (ld_acquire(bar) < target) {
    }
    __threadfence();
  }
  consumer_sync();
}

// Four int8 (k, k+1, k+2, k+3 in ascending bytes) -> two bf16x2 registers,
// exactly: byte b + 128 dropped into the mantissa of 2^23 gives the float
// 2^23 + 128 + b; the subtraction leaves b.
__device__ __forceinline__ void cvt_i8x4(uint32_t w, uint32_t (&b)[2]) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  b[0] = pack_bf16(f0, f1);
  b[1] = pack_bf16(f2, f3);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Bytes 2 w, 2 w + 1 of c (int8) as a bf16 pair, exactly: byte x becomes
// the float with bits 0x4B000000 | (x ^ 0x80), that is 2^23 + 128 + x, less
// 2^23 + 128. The attention loops widen a word where they use it, so that
// no 16-byte row waits widened in registers.
__device__ __forceinline__ uint32_t widen2(const uint4& c, int w) {
  const uint32_t u = word(c, w / 2) ^ 0x80808080u;
  const uint32_t sel = 0x5440u | (uint32_t)((w % 2) * 2);
  return pack_bf16(__uint_as_float(__byte_perm(u, 0x4B00u, sel)) - 8388736.f,
                   __uint_as_float(__byte_perm(u, 0x4B00u, sel + 1)) - 8388736.f);
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// An L2 policy for data read once a step (the weights, the cache): its
// lines go first, so that what the next phase reads (partial sums,
// activations) stays in the L2.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// bulk_load with the L2 policy `policy`.
__device__ __forceinline__ void bulk_load_once(uint32_t dst, const void* src, uint32_t bytes,
                                               uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// cp.async of `bytes` (16 or 4) from src, or zeros where !ok (src is not read).
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool ok) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(ok ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// The schedule of the products: shared by the producer and the consumers
// ---------------------------------------------------------------------------

// One product of a layer: its packed tiles, per-column scales, depth in
// k-blocks, 64-column units and K-slices.
struct Product {
  const int8_t* w;
  const float* sc;
  int KB, units, KS;
};

__device__ __forceinline__ Product product(const MegaArgs& a, int layer, int p) {
  const int D = a.D, F = a.F, W = (a.H + 2 * a.KV) * a.HD;
  const size_t layer_bytes = (size_t)D * W + (size_t)D * D + 2 * (size_t)D * F + (size_t)F * D;
  const int8_t* w = a.stream + (size_t)layer * layer_bytes;
  const float* sc = a.scales + (size_t)layer * (W + 2 * D + 2 * F);
  switch (p) {
    case QKV: return Product{w, sc, D / KBLK, W / UNIT, a.slices[QKV]};
    case OPROJ: return Product{w + (size_t)D * W, sc + W, D / KBLK, D / UNIT, a.slices[OPROJ]};
    case GATE_UP:
      return Product{w + (size_t)D * W + (size_t)D * D, sc + W + D, D / KBLK, 2 * F / UNIT,
                     a.slices[GATE_UP]};
    default:
      return Product{w + (size_t)D * W + (size_t)D * D + 2 * (size_t)D * F, sc + W + D + 2 * F,
                     F / KBLK, D / UNIT, a.slices[DOWN]};
  }
}

// This CTA's K-slice of a product: slice s = CTA % KS, k-blocks [kb0, kb0 +
// kbs); the pairs of units rank, rank + peers, ... (peers: the CTAs on s).
struct Slice {
  int s, rank, peers, kb0, kbs;
};

__device__ __forceinline__ Slice slice_of(const Product& p) {
  Slice v;
  v.s = blockIdx.x % p.KS;
  v.rank = blockIdx.x / p.KS;
  v.peers = (gridDim.x - v.s + p.KS - 1) / p.KS;
  v.kb0 = v.s * p.KB / p.KS;
  v.kbs = (v.s + 1) * p.KB / p.KS - v.kb0;
  return v;
}

// The producer: lane 0 of the last warp walks every tile this CTA will
// multiply, in the consumers' order, through the ring.
__device__ __forceinline__ void producer(const MegaArgs& a, uint32_t ring, uint32_t full, uint32_t empty) {
  const int nrb = (a.B + ROWS - 1) / ROWS;
  const uint64_t policy = evict_first();
  uint32_t T = 0;
  for (int layer = 0; layer < a.L; ++layer)
    for (int p = 0; p < 4; ++p) {
      const Product pr = product(a, layer, p);
      const Slice sl = slice_of(pr);
      const int pairs = (pr.units + 1) / 2;
      for (int rb = 0; rb < nrb; ++rb)
        for (int pair = sl.rank; pair < pairs; pair += sl.peers) {
          const int nu = min(2, pr.units - 2 * pair);
          for (int kb = 0; kb < sl.kbs; ++kb)
            for (int w = 0; w < nu; ++w, ++T) {
              const uint32_t st = T % RING, use = T / RING;
              mbar_wait(empty + 8 * st, (use & 1) ^ 1);
              mbar_expect_tx(full + 8 * st, TILE);
              bulk_load_once(ring + st * TILE,
                             pr.w + ((size_t)(2 * pair + w) * pr.KB + sl.kb0 + kb) * TILE, TILE,
                             full + 8 * st, policy);
            }
        }
    }
}

struct Smem {
  uint32_t ring, act, full, empty;  // shared addresses
  unsigned char* uni;               // staged activations, or the attention rings
  float* rstd;                      // [ROWS]
};

extern __shared__ __align__(16) unsigned char smem_raw[];

__device__ __forceinline__ Smem smem_of() {
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* bp = smem_raw + (base - raw);
  Smem sm;
  sm.full = base;
  sm.empty = base + 8 * RING;
  sm.rstd = reinterpret_cast<float*>(bp + 16 * RING);
  sm.ring = base + MISC_BYTES;
  sm.act = sm.ring + RING * TILE;
  sm.uni = bp + MISC_BYTES + RING * TILE;
  return sm;
}

// ---------------------------------------------------------------------------
// Staging: a K-slice of one row block's activations, bf16, in the 128-byte
// swizzle (k-block kb, row n, 16-byte chunk c at kb*8K + n*128 + (c^n%8)*16)
// ---------------------------------------------------------------------------

template <int P>
__device__ void stage(const MegaArgs& a, int layer, const Slice& sl, int r0, int rows,
                      const Smem& sm) {
  const int tid = threadIdx.x;
  if constexpr (P == QKV || P == GATE_UP) {
    if (tid < ROWS) {
      float s = 0.f;
      if (tid < rows) {
#pragma unroll 8
        for (int u = 0; u < a.D / UNIT; ++u) s += __ldcg(a.ssq + (size_t)u * a.B + r0 + tid);
      }
      sm.rstd[tid] = rsqrtf(s / static_cast<float>(a.D) + a.eps);
    }
    consumer_sync();
  }
  const float* nw = a.norms + ((size_t)layer * 2 + (P == GATE_UP ? 1 : 0)) * a.D;
  // chunk idx: k-block idx / 512, row (idx / 8) % 64, 16-byte chunk idx % 8;
  // four chunks a thread at a time, their loads before their stores
  auto load = [&](int idx) {
    const int kb = idx >> 9, n = (idx >> 3) & (ROWS - 1), c = idx & 7;
    const int col = (sl.kb0 + kb) * KBLK + c * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < rows) {
      const size_t row = (size_t)(r0 + n);
      if constexpr (P == QKV || P == GATE_UP) {
        const float4 x0 = __ldcg(reinterpret_cast<const float4*>(a.x + row * a.D + col));
        const float4 x1 = __ldcg(reinterpret_cast<const float4*>(a.x + row * a.D + col + 4));
        const float4 w0 = __ldg(reinterpret_cast<const float4*>(nw + col));
        const float4 w1 = __ldg(reinterpret_cast<const float4*>(nw + col + 4));
        const float rs = sm.rstd[n];
        v.x = pack_bf16((x0.x * rs) * w0.x, (x0.y * rs) * w0.y);
        v.y = pack_bf16((x0.z * rs) * w0.z, (x0.w * rs) * w0.w);
        v.z = pack_bf16((x1.x * rs) * w1.x, (x1.y * rs) * w1.y);
        v.w = pack_bf16((x1.z * rs) * w1.z, (x1.w * rs) * w1.w);
      } else if constexpr (P == OPROJ) {
        v = __ldcg(reinterpret_cast<const uint4*>(a.att + row * a.D + col));
      } else {
        v = __ldcg(reinterpret_cast<const uint4*>(a.gu + row * a.F + col));
      }
    }
    return v;
  };
  const int n_chunks = sl.kbs * ROWS * 8;
  for (int i0 = tid; i0 < n_chunks; i0 += 4 * NCT) {
    uint4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = i0 + k * NCT < n_chunks ? load(i0 + k * NCT) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int idx = i0 + k * NCT;
      if (idx < n_chunks) {
        const int kb = idx >> 9, n = (idx >> 3) & (ROWS - 1), c = idx & 7;
        const uint32_t dst = sm.act + kb * ACT_BLK + n * 128 + ((c ^ (n & 7)) << 4);
        asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v[k].x),
                     "r"(v[k].y), "r"(v[k].z), "r"(v[k].w)
                     : "memory");
      }
    }
  }
  // written by ordinary stores, read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumer_sync();
}

// The sums over a product's KS slices of units u, u + du, ... (NU of them)
// of float4s kk[0..NK) of an item (i4: rows 8 i4 .. 8 i4 + 7), the loads
// of several slices in flight together.
template <int NU, int NK>
__device__ __forceinline__ void slice_sums(const MegaArgs& a, const Product& pr, int rb, int u,
                                           int du, int i4, int lane, const int (&kk)[NK],
                                           float4 (&v)[NU][NK]) {
  constexpr int IN_FLIGHT = 16 / (NU * NK);  // slices whose loads go out together: 16 float4s
#pragma unroll
  for (int n = 0; n < NU; ++n)
#pragma unroll
    for (int k = 0; k < NK; ++k) v[n][k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll IN_FLIGHT
  for (int s = 0; s < pr.KS; ++s)
#pragma unroll
    for (int n = 0; n < NU; ++n) {
      const float* src = a.part + (((size_t)rb * pr.KS + s) * pr.units + u + n * du) * 4096 + i4 * 512;
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const float4 q = __ldcg(reinterpret_cast<const float4*>(src + (lane + 32 * kk[k]) * 4));
        v[n][k].x += q.x;
        v[n][k].y += q.y;
        v[n][k].z += q.z;
        v[n][k].w += q.w;
      }
    }
}

// The sums of one product: after a grid barrier every consumer warp takes
// items (row block, unit, i4): rows 8 i4 .. 8 i4 + 7 of the row block and
// the unit's 64 columns, which are fragment elements 4 i4 .. 4 i4 + 3 of
// the warpgroup's 128 threads (lane l holds those of threads l + 32 k).
// It adds the KS slices in slice order, scales each column and finishes:
// the residual add and the rows' sums of squares over the unit (o_proj,
// down), gu = bf16(silu(bf16(gate)) * up) (gate/up: the item is a unit
// pair, gate and up of the same columns). qkv_sum_phase does qkv's.
template <int P>
__device__ __forceinline__ void reduce_phase(const MegaArgs& a, int layer) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const Product pr = product(a, layer, P);
  const int nrb = (a.B + ROWS - 1) / ROWS;
  const int cols = P == GATE_UP ? pr.units / 2 : pr.units;  // output units
  const int items = nrb * cols * 8;
  const bool last_layer = P == DOWN && layer == a.L - 1;
  // items spread over the CTAs first: item i goes to warp i / grid of CTA i % grid
  for (int item = warp * gridDim.x + blockIdx.x; item < items; item += gridDim.x * NCW) {
    const int i4 = item % 8, c = (item / 8) % cols, rb = item / (8 * cols);
    // element j of float4 k: column 16 k + g + 8 (j / 2), row 8 i4 + 2 t + j % 2
    const int row0 = rb * ROWS + 8 * i4 + 2 * t;
    if constexpr (P == GATE_UP) {
      float4 gu[2][4];  // gate, up
      const int all4[4] = {0, 1, 2, 3};
      slice_sums<2, 4>(a, pr, rb, 2 * c, 1, i4, lane, all4, gu);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float gv[4] = {gu[0][k].x, gu[0][k].y, gu[0][k].z, gu[0][k].w};
        const float uv[4] = {gu[1][k].x, gu[1][k].y, gu[1][k].z, gu[1][k].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 16 * k + g + 8 * (j / 2), row = row0 + j % 2;
          if (row < a.B) {
            const float gate = __bfloat162float(
                __float2bfloat16(gv[j] * __ldg(pr.sc + (2 * c) * UNIT + col)));
            const float up = uv[j] * __ldg(pr.sc + (2 * c + 1) * UNIT + col);
            a.gu[(size_t)row * a.F + c * UNIT + col] =
                __float2bfloat16(gate * (1.f / (1.f + expf(-gate))) * up);
          }
        }
      }
    } else {
      // the residual rows' loads go out with the partials'
      float xo[4][4];
      {
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = c * UNIT + 16 * k + g + 8 * (j / 2), row = row0 + j % 2;
            xo[k][j] = row < a.B ? __ldcg(a.x + (size_t)row * a.D + col) : 0.f;
          }
      }
      float4 sv[1][4];
      const int all4[4] = {0, 1, 2, 3};
      slice_sums<1, 4>(a, pr, rb, c, 0, i4, lane, all4, sv);
      const float4(&vs)[4] = sv[0];
      {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float v[4] = {vs[k].x, vs[k].y, vs[k].z, vs[k].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = c * UNIT + 16 * k + g + 8 * (j / 2), row = row0 + j % 2;
            if (row < a.B) xo[k][j] += v[j] * __ldg(pr.sc + col);
          }
        }
        float sq[2] = {0.f, 0.f};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = c * UNIT + 16 * k + g + 8 * (j / 2), row = row0 + j % 2;
            if (row < a.B) {
              a.x[(size_t)row * a.D + col] = xo[k][j];
              if (last_layer) a.out[(size_t)row * a.D + col] = __float2bfloat16(xo[k][j]);
            }
            sq[j % 2] = fmaf(xo[k][j], xo[k][j], sq[j % 2]);
          }
        // rows row0, row0 + 1: add over g (lanes 4 apart)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sq[e] += __shfl_xor_sync(RLINF_FULL_MASK, sq[e], 4);
          sq[e] += __shfl_xor_sync(RLINF_FULL_MASK, sq[e], 8);
          sq[e] += __shfl_xor_sync(RLINF_FULL_MASK, sq[e], 16);
          if (!last_layer && g == 0 && row0 + e < a.B) a.ssq[(size_t)c * a.B + row0 + e] = sq[e];
        }
      }
    }
  }
}

// qkv's sums: items (row block, i4, head, half) over the H + 2 KV heads of
// the packed row, a head's Hd / 64 units each, half of an item's float4s
// (two of four) to each of two warps. It adds the slices, scales, adds the
// bias, applies rope to the q and k heads (a depth's partner d +- Hd/2 sits
// in the same thread: the other unit of the head, or float4 k ^ 2 of one
// unit at Hd = 64, which is why that half is {kh, kh + 2}) and writes the
// row; for the k and v heads also max |value| of each row over the half
// head, from which attention takes the cache slot's scales.
template <int NU>
__device__ __forceinline__ void qkv_head(const MegaArgs& a, const Product& pr, int layer, int rb,
                                         int h, int i4, int kh, int lane) {
  const int g = lane / 4, t = lane % 4, HD = NU * UNIT, half = HD / 2;
  const int W = (a.H + 2 * a.KV) * HD, row0 = rb * ROWS + 8 * i4 + 2 * t;
  const int kk[2] = {NU == 2 ? 2 * kh : kh, NU == 2 ? 2 * kh + 1 : kh + 2};
  float4 v[NU][2];
  slice_sums<NU, 2>(a, pr, rb, h * NU, 1, i4, lane, kk, v);
  const float* bias = a.bias + (size_t)layer * W;
  float x[NU][2][4];
#pragma unroll
  for (int n = 0; n < NU; ++n)
#pragma unroll
    for (int ki = 0; ki < 2; ++ki) {
      const float vv[4] = {v[n][ki].x, v[n][ki].y, v[n][ki].z, v[n][ki].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = h * HD + n * UNIT + 16 * kk[ki] + g + 8 * (j / 2);
        x[n][ki][j] = vv[j] * __ldg(pr.sc + col) + __ldg(bias + col);
      }
    }
  const bool rope = h < a.H + a.KV;
  int pos[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    pos[e] = min(max(row0 + e < a.B ? a.positions[row0 + e] : 0, 0), a.S_rope - 1);
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NU; ++n)
#pragma unroll
    for (int ki = 0; ki < 2; ++ki)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = n * UNIT + 16 * kk[ki] + g + 8 * (j / 2), e = j % 2;
        float y = x[n][ki][j];
        if (rope) {
          const float xp = NU == 2 ? x[1 - n][ki][j] : x[0][ki ^ 1][j];
          const float c = __ldg(a.cos_tab + (size_t)pos[e] * HD + d);
          const float sn = __ldg(a.sin_tab + (size_t)pos[e] * HD + d);
          y = d < half ? y * c + (-xp) * sn : y * c + xp * sn;
        }
        mx[e] = fmaxf(mx[e], fabsf(y));
        if (row0 + e < a.B) a.qkv[(size_t)(row0 + e) * W + h * HD + d] = y;
      }
  if (h >= a.H) {  // a k or v head: the rows' max over this half of it
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(RLINF_FULL_MASK, mx[e], 4));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(RLINF_FULL_MASK, mx[e], 8));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(RLINF_FULL_MASK, mx[e], 16));
      const int kvh = (h - a.H) % a.KV, is_v = h >= a.H + a.KV;
      if (g == 0 && row0 + e < a.B)
        a.kvmax[(((size_t)(row0 + e) * a.KV + kvh) * 2 + is_v) * 2 + kh] = mx[e];
    }
  }
}

// qkv_head for heads of 16 or 32 depths, several to a 64-column unit: an
// item is unit u's float4s {2 kh, 2 kh + 1}, columns 32 kh .. 32 kh + 31 of
// the unit, which is one whole head at Hd = 32 (a depth's partner d +- 16 is
// the other float4) and two at Hd = 16 (one a float4; the partner d +- 8 is
// fragment element j ^ 2 of the same float4). Each k and v head's maximum
// goes to both halves' slots of kvmax.
template <int HD>
__device__ __forceinline__ void qkv_unit_small(const MegaArgs& a, const Product& pr, int layer,
                                               int rb, int u, int i4, int kh, int lane) {
  constexpr int half = HD / 2;
  const int g = lane / 4, t = lane % 4;
  const int W = (a.H + 2 * a.KV) * HD, row0 = rb * ROWS + 8 * i4 + 2 * t;
  const int kk[2] = {2 * kh, 2 * kh + 1};
  float4 v[1][2];
  slice_sums<1, 2>(a, pr, rb, u, 1, i4, lane, kk, v);
  const float* bias = a.bias + (size_t)layer * W;
  float x[2][4];
#pragma unroll
  for (int ki = 0; ki < 2; ++ki) {
    const float vv[4] = {v[0][ki].x, v[0][ki].y, v[0][ki].z, v[0][ki].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = u * UNIT + 16 * kk[ki] + g + 8 * (j / 2);
      x[ki][j] = vv[j] * __ldg(pr.sc + col) + __ldg(bias + col);
    }
  }
  int pos[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    pos[e] = min(max(row0 + e < a.B ? a.positions[row0 + e] : 0, 0), a.S_rope - 1);
  float mx[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [ki][e]
#pragma unroll
  for (int ki = 0; ki < 2; ++ki)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = u * UNIT + 16 * kk[ki] + g + 8 * (j / 2), e = j % 2;
      const int h = col / HD, d = col % HD;
      float y = x[ki][j];
      if (h < a.H + a.KV) {  // rope on q and k heads
        const float xp = HD == 32 ? x[ki ^ 1][j] : x[ki][j ^ 2];
        const float c = __ldg(a.cos_tab + (size_t)pos[e] * HD + d);
        const float sn = __ldg(a.sin_tab + (size_t)pos[e] * HD + d);
        y = d < half ? y * c + (-xp) * sn : y * c + xp * sn;
      }
      mx[ki][e] = fmaxf(mx[ki][e], fabsf(y));
      if (row0 + e < a.B) a.qkv[(size_t)(row0 + e) * W + col] = y;
    }
#pragma unroll
  for (int ki = 0; ki < 2; ++ki) {
    const int h = (u * UNIT + 16 * kk[ki]) / HD;
    if (h < a.H) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float m = HD == 32 ? fmaxf(mx[0][e], mx[1][e]) : mx[ki][e];
      m = fmaxf(m, __shfl_xor_sync(RLINF_FULL_MASK, m, 4));
      m = fmaxf(m, __shfl_xor_sync(RLINF_FULL_MASK, m, 8));
      m = fmaxf(m, __shfl_xor_sync(RLINF_FULL_MASK, m, 16));
      const int kvh = (h - a.H) % a.KV, is_v = h >= a.H + a.KV;
      if (g == 0 && row0 + e < a.B) {
        float* slot = a.kvmax + (((size_t)(row0 + e) * a.KV + kvh) * 2 + is_v) * 2;
        slot[0] = m;
        slot[1] = m;
      }
    }
    if (HD == 32) break;  // one head: both float4s are its
  }
}

template <int HD>
__device__ __forceinline__ void qkv_sum_phase(const MegaArgs& a, int layer) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Product pr = product(a, layer, QKV);
  const int nrb = (a.B + ROWS - 1) / ROWS;
  // heads of 64 or 128 depths: items per head; of 16 or 32: per 64-column unit
  const int heads = HD >= 64 ? a.H + 2 * a.KV : (a.H + 2 * a.KV) * HD / UNIT;
  const int items = nrb * heads * 16;
  for (int item = warp * gridDim.x + blockIdx.x; item < items; item += gridDim.x * NCW) {
    const int kh = item % 2, i4 = (item / 2) % 8, h = (item / 16) % heads, rb = item / (16 * heads);
    if constexpr (HD >= 64)
      qkv_head<HD / 64>(a, pr, layer, rb, h, i4, kh, lane);
    else
      qkv_unit_small<HD>(a, pr, layer, rb, h, i4, kh, lane);
  }
}

// One product of one layer: its items' raw sums (consumers).
template <int P>
__device__ __forceinline__ uint32_t product_phase(const MegaArgs& a, int layer, uint32_t T) {
  const Smem sm = smem_of();
  const int tid = threadIdx.x, wg = tid / 128, tw = tid % 128, lane = tid % 32;
  const Product pr = product(a, layer, P);
  const Slice sl = slice_of(pr);
  const int pairs = (pr.units + 1) / 2;
  const int nrb = (a.B + ROWS - 1) / ROWS;
  for (int rb = 0; rb < nrb; ++rb) {
    const int r0 = rb * ROWS, rows = min(ROWS, a.B - r0);
    if (sl.rank >= pairs) break;  // no work for this CTA in this product
    stage<P>(a, layer, sl, r0, rows, sm);
    for (int pair = sl.rank; pair < pairs; pair += sl.peers) {
      const int nu = min(2, pr.units - 2 * pair);
      if (wg < nu) {
        const int u = 2 * pair + wg;
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        // two fragment buffers with compile-time names (a runtime index puts
        // them in local memory, whose copies the compiler reuses while a
        // wgmma still reads them): step kb fills `f` while the products of
        // kb - 1 run on `g`, then waits for those and frees `g`
        uint32_t af0[4][4], af1[4][4];
        auto step = [&](int kb, uint32_t(&f)[4][4], uint32_t(&g)[4][4]) {
          const uint32_t Tt = T + kb * nu + wg, st = Tt % RING;
          mbar_wait(sm.full + 8 * st, (Tt / RING) & 1);
          const uint4 w0 = ld_shared16(sm.ring + st * TILE + tw * 16);
          const uint4 w1 = ld_shared16(sm.ring + st * TILE + 2048 + tw * 16);
          __syncwarp();
          if (lane == 0) mbar_arrive(sm.empty + 8 * st);
          const uint4 wv[2] = {w0, w1};
          // word 2 j + r holds depths 16 j + 2 t + {0, 1, 8, 9} of column
          // 16 warp + g + 8 r of the unit: the A fragment of k16 step j
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t r0w[2], r1w[2];
            cvt_i8x4(word(wv[j / 2], 2 * (j % 2)), r0w);
            cvt_i8x4(word(wv[j / 2], 2 * (j % 2) + 1), r1w);
            f[j][0] = r0w[0];
            f[j][1] = r1w[0];
            f[j][2] = r0w[1];
            f[j][3] = r1w[1];
          }
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wgmma_rs<64, 0>(acc, f[j], gmma_desc(sm.act + kb * ACT_BLK + j * 32, 16, 1024), 1u);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(g);
        };
        for (int kb = 0; kb < sl.kbs; kb += 2) {
          step(kb, af0, af1);
          if (kb + 1 < sl.kbs) step(kb + 1, af1, af0);
        }
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(af0);
        fence_regs(af1);
        // fragment elements 4 i4 .. 4 i4 + 3 of thread tw at (i4 * 128 + tw) * 4
        float* dst = a.part + (((size_t)rb * pr.KS + sl.s) * pr.units + u) * 4096 + tw * 4;
#pragma unroll
        for (int i = 0; i < 32; i += 4)
          __stcg(reinterpret_cast<float4*>(dst + i * 128),
                 make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]));
      }
      T += sl.kbs * nu;
    }
    consumer_sync();  // the staged slice is read: the next row block restages it
  }
  return T;
}

// Before layer 0: x = x0 and the sums of squares of its units.
__device__ __forceinline__ void prologue(const MegaArgs& a) {
  const int tid = threadIdx.x, units = a.D / UNIT, nrb = (a.B + ROWS - 1) / ROWS;
  for (int item = blockIdx.x; item < nrb * units; item += gridDim.x) {
    const int rb = item / units, u = item % units;
    const int row = rb * ROWS + tid / 4;
    float s = 0.f;
    if (row < a.B) {
      const size_t at = (size_t)row * a.D + u * UNIT + (tid % 4) * 16;
      const uint4 h0 = *reinterpret_cast<const uint4*>(a.x0 + at);
      const uint4 h1 = *reinterpret_cast<const uint4*>(a.x0 + at + 8);
      const uint32_t w[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
      float v[16];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
        s = fmaf(f.x, f.x, s);
        s = fmaf(f.y, f.y, s);
      }
#pragma unroll
      for (int i = 0; i < 16; i += 4)
        *reinterpret_cast<float4*>(a.x + at + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
    s += __shfl_xor_sync(RLINF_FULL_MASK, s, 1);
    s += __shfl_xor_sync(RLINF_FULL_MASK, s, 2);
    if (tid % 4 == 0 && row < a.B) a.ssq[(size_t)u * a.B + row] = s;
  }
}

// ---------------------------------------------------------------------------
// Attention: split-KV, one warp an item (row, kv head, split)
// ---------------------------------------------------------------------------

// Depth of row r of m-tile (cc, pw) of o^T: the transposed words 2 pw and
// 2 pw + 1 of the lanes' 16-depth runs (16 t .. 16 t + 15 of 64-chunk cc).
__device__ __forceinline__ int vdepth(int cc, int pw, int r) {
  return cc * 64 + 16 * ((r % 8) / 2) + 4 * pw + 2 * (r / 8) + r % 2;
}

template <int HD>
__device__ __forceinline__ void attn_phase(const MegaArgs& a, int layer) {
  const Smem sm = smem_of();
  constexpr int NC = att_nc(HD);  // 64-depth chunks of a row: 16 bytes of each a lane
  constexpr int STAGE = att_stage(HD);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int B = a.B, S = a.S, KV = a.KV, G = a.H / a.KV;
  const int KVD = KV * HD, QD = a.H * HD, W = QD + 2 * KVD;
  const unsigned char* ring = sm.uni + warp * att_warp(HD) + lane * 16;
  uint4* qfs = reinterpret_cast<uint4*>(sm.uni + warp * att_warp(HD) + ATT_RING * STAGE) + lane;
  const uint32_t ring_s = smem_u32(ring);
  const size_t lay = (size_t)layer * B * S;
  const float scale2 = a.scale * LOG2E;
  unsigned* cnt = a.sync + 1;
  const int items = B * KV * a.ns;

  for (int item = warp * gridDim.x + blockIdx.x; item < items; item += gridDim.x * NCW) {
    const int sp = item / (B * KV), bk = item % (B * KV), b = bk / KV, kvh = bk % KV;
    const int start = max(a.starts[b], 0), wp_raw = a.wps[b], end = min(wp_raw, S);
    const int blk0 = start / KEYS;
    const int nblk = end > start ? (end + KEYS - 1) / KEYS - blk0 : 0;
    const int s0 = sp * a.bps;
    if (sp > 0 && s0 >= nblk) continue;  // past the row's last block: no partial
    const int n_mine = max(0, min(s0 + a.bps, nblk) - s0);
    const int used = max(1, (nblk + a.bps - 1) / a.bps);
    auto key0_of = [&](int i) { return (blk0 + s0 + i) * KEYS; };
    auto fetch = [&](int i) {  // block i of this split into stage i % ATT_RING
      const int key0 = key0_of(i);
      const uint32_t dst = ring_s + (i % ATT_RING) * STAGE;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int key = key0 + g + 8 * rr;
        const bool ok = key < S && (HD >= 64 || 16 * t < HD);  // lanes past a short head load zeros
        const size_t at = ok ? (((size_t)b * S + key) * KV + kvh) * HD + 16 * t : 0;
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          cp_async<16>(dst + (rr * NC + cc) * CHUNK, a.kc + lay * KVD + at + cc * 64, ok);
          cp_async<16>(dst + ((2 + rr) * NC + cc) * CHUNK, a.vc + lay * KVD + at + cc * 64, ok);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = key0 + 8 * (j / 2) + 2 * t + j % 2;
        const bool ok = key < S;
        const size_t at = (size_t)b * S + (ok ? key : 0);
        cp_async<4>(dst + 4 * NC * CHUNK + 4 * j, a.ks + lay + at, ok);
        cp_async<4>(dst + (4 * NC + 1) * CHUNK + 4 * j, a.vs + lay + at, ok);
      }
    };
#pragma unroll
    for (int i = 0; i < ATT_RING; ++i) {
      if (i < n_mine) fetch(i);
      cp_async_commit();
    }

    const float* qrow = a.qkv + (size_t)b * W;  // q and k with rope already
    // Q fragments of head g: chunk cc, words w = depths cc * 64 + 16 t + 2 w,
    // + 1 (k-step j of the chunk takes words 2 j and 2 j + 1), hi and lo parts
    const bool head = g < G;
    const float* qh_row = qrow + (kvh * G + (head ? g : 0)) * HD;
    const float* k_row = qrow + QD + kvh * HD;
    const float* v_row = qrow + QD + KVD + kvh * HD;
    float dot = 0.f;
#pragma unroll 1
    for (int cc = 0; cc < NC; ++cc)  // one chunk's loads at a time: the registers go to o
#pragma unroll
      for (int k4 = 0; k4 < 4; ++k4) {
        const int d = cc * 64 + 16 * t + 4 * k4;
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (head && (HD >= 64 || d < HD)) {
          q = __ldcg(reinterpret_cast<const float4*>(qh_row + d));
          if (sp == used - 1) {
            const float4 k = __ldcg(reinterpret_cast<const float4*>(k_row + d));
            dot = fmaf(q.x, k.x, fmaf(q.y, k.y, fmaf(q.z, k.z, fmaf(q.w, k.w, dot))));
          }
        }
        // k-step k4 of chunk cc: A fragment {hi, lo} of depths 4 k4, + 1, then of + 2, + 3
        const float qv[4] = {q.x, q.y, q.z, q.w};
        uint32_t fr[4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const __nv_bfloat162 hv = __floats2bfloat162_rn(qv[2 * h2], qv[2 * h2 + 1]);
          const float2 hf = __bfloat1622float2(hv);
          fr[2 * h2] = *reinterpret_cast<const uint32_t*>(&hv);
          fr[2 * h2 + 1] = pack_bf16(qv[2 * h2] - hf.x, qv[2 * h2 + 1] - hf.y);
        }
        qfs[(cc * 4 + k4) * 32] = make_uint4(fr[0], fr[1], fr[2], fr[3]);
      }
    // the softmax state of head g (m, l); the output as o^T = V^T P^T:
    // o[cc][pw][e] holds head 2 t + e % 2 at depth vdepth(cc, pw, g + 8 (e / 2))
    float m = RLINF_NEG_INF, l = 0.f;
    float o[NC][4][4];
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int pw = 0; pw < 4; ++pw)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[cc][pw][e] = 0.f;
    if (sp == used - 1) {
      // the current token, exactly in f32: the state every block then rescales
      dot += __shfl_xor_sync(RLINF_FULL_MASK, dot, 1);
      dot += __shfl_xor_sync(RLINF_FULL_MASK, dot, 2);
      if (head) {
        m = dot * scale2;
        l = t == 0 ? 1.f : 0.f;
      }
      // p = 1 for the current token of every head: o = v
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
#pragma unroll
        for (int pw = 0; pw < 4; ++pw)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[cc][pw][e] = 2 * t + e % 2 < G && (HD >= 64 || vdepth(cc, pw, g + 8 * (e / 2)) < HD)
                               ? __ldcg(v_row + vdepth(cc, pw, g + 8 * (e / 2)))
                               : 0.f;
      // quantize the new k/v (scales over the whole packed rows: the max
      // over the kv heads' maxima) into slot wp
      float kmax = 0.f, vmax = 0.f;
      for (int i = lane; i < KV; i += 32) {
        const float4 mk = __ldcg(reinterpret_cast<const float4*>(a.kvmax + ((size_t)b * KV + i) * 4));
        kmax = fmaxf(kmax, fmaxf(mk.x, mk.y));
        vmax = fmaxf(vmax, fmaxf(mk.z, mk.w));
      }
      const float ksv = fmaxf(rlinf_warp_max(kmax) / 127.f, 1e-8f);
      const float vsv = fmaxf(rlinf_warp_max(vmax) / 127.f, 1e-8f);
      const int wp = min(max(wp_raw, 0), S - 1);
      const size_t slot = (size_t)b * S + wp;
      auto q8 = [](float x, float s) {
        return static_cast<uint32_t>(static_cast<uint8_t>(
            static_cast<int8_t>(fminf(fmaxf(rintf(x / s), -127.f), 127.f))));
      };
      if (4 * lane < HD) {
        const int d = 4 * lane;
        const float4 k = __ldcg(reinterpret_cast<const float4*>(k_row + d));
        const float4 v = __ldcg(reinterpret_cast<const float4*>(v_row + d));
        const size_t at = (lay + slot) * KVD + kvh * HD + d;
        *reinterpret_cast<uint32_t*>(a.kc + at) =
            q8(k.x, ksv) | q8(k.y, ksv) << 8 | q8(k.z, ksv) << 16 | q8(k.w, ksv) << 24;
        *reinterpret_cast<uint32_t*>(a.vc + at) =
            q8(v.x, vsv) | q8(v.y, vsv) << 8 | q8(v.z, vsv) << 16 | q8(v.w, vsv) << 24;
      }
      if (kvh == 0 && lane == 0) {
        a.ks[lay + slot] = ksv;
        a.vs[lay + slot] = vsv;
      }
    }

    for (int i = 0; i < n_mine; ++i) {
      cp_async_wait<ATT_RING - 1>();  // this lane's copies of block i have landed
      const unsigned char* st = ring + (i % ATT_RING) * STAGE;
      auto chunk = [&](int c) { return *reinterpret_cast<const uint4*>(st + c * CHUNK); };
      const int key0 = key0_of(i);
      // S = Q K^T: s[nt][e] + s[nt][2 + e] is head g, key key0 + 8 nt + 2 t + e
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const uint4 kr = chunk(nt * NC + cc);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint4 q4 = qfs[(cc * 4 + j) * 32];
            const uint32_t af[4] = {q4.x, q4.y, q4.z, q4.w};
            mma_bf16(s[nt], af, widen2(kr, 2 * j), widen2(kr, 2 * j + 1));
          }
        }
      const float4 ksc4 = *reinterpret_cast<const float4*>(st + 4 * NC * CHUNK);
      const float kscale[4] = {ksc4.x, ksc4.y, ksc4.z, ksc4.w};
      float mx = m, sc[2][2];
      bool ok[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = key0 + 8 * nt + 2 * t + e;
          ok[nt][e] = head && key >= start && key < end;
          sc[nt][e] = ok[nt][e] ? (s[nt][e] + s[nt][2 + e]) * scale2 * kscale[2 * nt + e] : RLINF_NEG_INF;
          mx = fmaxf(mx, sc[nt][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(RLINF_FULL_MASK, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(RLINF_FULL_MASK, mx, 2));
      const float alpha = exp2f(m - mx);
      m = mx;
      l *= alpha;
      const float4 vsc4 = *reinterpret_cast<const float4*>(st + (4 * NC + 1) * CHUNK);
      const float vscale[4] = {vsc4.x, vsc4.y, vsc4.z, vsc4.w};
      float pv[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ok[nt][e] ? exp2f(sc[nt][e] - m) : 0.f;
          l += p;
          pv[nt][e] = ok[nt][e] ? p * vscale[2 * nt + e] : 0.f;
        }
      // o's columns are heads 2 t, 2 t + 1: their rescale factors from the
      // lanes of those heads' rows
      const float al0 = __shfl_sync(RLINF_FULL_MASK, alpha, 8 * t);
      const float al1 = __shfl_sync(RLINF_FULL_MASK, alpha, 8 * t + 4);
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
#pragma unroll
        for (int pw = 0; pw < 4; ++pw) {
          o[cc][pw][0] *= al0;
          o[cc][pw][1] *= al1;
          o[cc][pw][2] *= al0;
          o[cc][pw][3] *= al1;
        }
      // (P v_scale)^T as the B fragment (head g, keys 2 t, + 1 then 8 + 2 t,
      // + 1), in hi and lo bf16 parts
      uint32_t ph[2], pl[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const __nv_bfloat162 hv = __floats2bfloat162_rn(pv[nt][0], pv[nt][1]);
        const float2 hf = __bfloat1622float2(hv);
        ph[nt] = *reinterpret_cast<const uint32_t*>(&hv);
        pl[nt] = pack_bf16(pv[nt][0] - hf.x, pv[nt][1] - hf.y);
      }
      // V^T as the A fragments: word w of the lane's widened 16 bytes of key
      // rows g and g + 8 is an 8 x 8 matrix (rows keys, columns depth
      // pairs); transposed, rows of depths, columns of keys. Words 2 pw and
      // 2 pw + 1 give the m-tile's rows 0-7 and 8-15 (vdepth)
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const uint4 v0 = chunk(2 * NC + cc), v1 = chunk(3 * NC + cc);
#pragma unroll
        for (int pw = 0; pw < 4; ++pw) {
          const uint32_t af[4] = {movmatrix_t(widen2(v0, 2 * pw)), movmatrix_t(widen2(v0, 2 * pw + 1)),
                                  movmatrix_t(widen2(v1, 2 * pw)), movmatrix_t(widen2(v1, 2 * pw + 1))};
          mma_bf16(o[cc][pw], af, ph[0], ph[1]);
          mma_bf16(o[cc][pw], af, pl[0], pl[1]);
        }
      }
      if (i + ATT_RING < n_mine) fetch(i + ATT_RING);
      cp_async_commit();
    }
    cp_async_wait<0>();

    // this split's state of head g: m (log2 units), l, the unnormalised o
    l += __shfl_xor_sync(RLINF_FULL_MASK, l, 1);
    l += __shfl_xor_sync(RLINF_FULL_MASK, l, 2);
    const size_t part = (size_t)bk * a.ns + sp;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = 2 * t + e % 2;
      if (hh < G) {
        float* dst = a.apart + (part * G + hh) * (HD + 4);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
#pragma unroll
          for (int pw = 0; pw < 4; ++pw)
            if (HD >= 64 || vdepth(cc, pw, g + 8 * (e / 2)) < HD)
              __stcg(dst + vdepth(cc, pw, g + 8 * (e / 2)), o[cc][pw][e]);
      }
    }
    if (head && t == 0)
      __stcg(reinterpret_cast<float2*>(a.apart + (part * G + g) * (HD + 4) + HD), make_float2(m, l));
    // every split of the (row, kv head) counts itself in, and once all
    // `used` have (the count reaches used * (layer + 1): counts only rise),
    // split sp merges the output rounds sp, sp + used, ... of 32 float4s.
    // The splits of a row are all resident at once (the schedule keeps the
    // items within one a consumer warp when a row has several splits), so
    // the wait ends.
    __threadfence();
    __syncwarp();
    if (lane == 0) {
      atomicAdd(cnt + bk, 1u);
      while (ld_acquire(cnt + bk) < (unsigned)used * (layer + 1)) {
      }
    }
    __syncwarp();
    __threadfence();
    // split q's weight e^(m_q - M) of head gg at wsm[gg * 32 + q], and the
    // head's L at wsm[256 + gg], in the warp's query-fragment area (done)
    float* wsm = reinterpret_cast<float*>(sm.uni + warp * att_warp(HD) + ATT_RING * STAGE);
    const float* base = a.apart + (size_t)bk * a.ns * G * (HD + 4);
#pragma unroll 1
    for (int gg = 0; gg < G; ++gg) {
      float mq = RLINF_NEG_INF, lq = 0.f;
      if (lane < used) {
        const float2 ml =
            __ldcg(reinterpret_cast<const float2*>(base + ((size_t)lane * G + gg) * (HD + 4) + HD));
        mq = ml.x;
        lq = ml.y;
      }
      const float M = rlinf_warp_max(mq);
      const float w = lane < used ? exp2f(mq - M) : 0.f;
      wsm[gg * 32 + lane] = w;
      const float L = rlinf_warp_sum(lq * w);
      if (lane == 0) wsm[256 + gg] = L;
    }
    __syncwarp();
    // outputs: head gg, depths 4 c .. 4 c + 3 for c = c0 + lane
    const int n4 = G * HD / 4;
    for (int c0 = 32 * sp; c0 < n4; c0 += 32 * used) {
      if (c0 + lane < n4) {
        const int c = c0 + lane, gg = 4 * c / HD, d = 4 * c % HD;
        float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q0 = 0; q0 < used; q0 += 4) {  // four splits' loads in flight
          float4 o4[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            o4[k] = __ldcg(reinterpret_cast<const float4*>(
                base + ((size_t)min(q0 + k, used - 1) * G + gg) * (HD + 4) + d));
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (q0 + k < used) {
              const float wgt = wsm[gg * 32 + q0 + k];
              A.x = fmaf(o4[k].x, wgt, A.x);
              A.y = fmaf(o4[k].y, wgt, A.y);
              A.z = fmaf(o4[k].z, wgt, A.z);
              A.w = fmaf(o4[k].w, wgt, A.w);
            }
        }
        const float inv = 1.f / fmaxf(wsm[256 + gg], 1e-30f);
        __nv_bfloat16* dst = a.att + (size_t)b * a.D + (kvh * G + gg) * HD + d;
        *reinterpret_cast<uint2*>(dst) =
            make_uint2(pack_bf16(A.x * inv, A.y * inv), pack_bf16(A.z * inv, A.w * inv));
      }
    }
    __syncwarp();  // the scratch is read: the next item's query fragments overwrite it
  }
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS, 1) mega_kernel(const __grid_constant__ MegaArgs a) {
  const Smem sm = smem_of();
  if (threadIdx.x == 0) {
    for (int i = 0; i < RING; ++i) {
      mbar_init(sm.full + 8 * i, 1);
      mbar_init(sm.empty + 8 * i, 4);  // one arrival per warp of the consuming warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();  // the last block barrier of all the threads
  if (threadIdx.x >= NCT) {
    if (threadIdx.x == NCT) producer(a, sm.ring, sm.full, sm.empty);
    return;
  }

  unsigned target = 0;
  uint32_t T = 0;
  stamp(a.clock, 0);
  prologue(a);
  grid_barrier(a.sync, target);
  stamp(a.clock, 1);
  for (int layer = 0; layer < a.L; ++layer) {
    const int e = 2 + layer * 9;
    T = product_phase<QKV>(a, layer, T);
    grid_barrier(a.sync, target);
    stamp(a.clock, e);
    qkv_sum_phase<HD>(a, layer);
    grid_barrier(a.sync, target);
    stamp(a.clock, e + 1);
    attn_phase<HD>(a, layer);
    grid_barrier(a.sync, target);
    stamp(a.clock, e + 2);
    T = product_phase<OPROJ>(a, layer, T);
    grid_barrier(a.sync, target);
    stamp(a.clock, e + 3);
    reduce_phase<OPROJ>(a, layer);
    grid_barrier(a.sync, target);
    stamp(a.clock, e + 4);
    T = product_phase<GATE_UP>(a, layer, T);
    grid_barrier(a.sync, target);
    stamp(a.clock, e + 5);
    reduce_phase<GATE_UP>(a, layer);
    grid_barrier(a.sync, target);
    stamp(a.clock, e + 6);
    T = product_phase<DOWN>(a, layer, T);
    grid_barrier(a.sync, target);
    stamp(a.clock, e + 7);
    reduce_phase<DOWN>(a, layer);
    grid_barrier(a.sync, target);
    stamp(a.clock, e + 8);
  }
}

// The kernel's shared-memory limit, raised once for each device.
template <int HD>
cudaError_t raise_smem(int device) {
  static std::atomic<unsigned long long> raised{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (bit & raised.load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      mega_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(HD));
  if (err == cudaSuccess) raised.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int HD>
int launch(MegaArgs& a, int device, int grid, size_t sync_words, cudaStream_t st) {
  static_assert(smem_bytes(HD) <= SMEM_CAP, "shared memory");
  cudaError_t err;
  int coop = 0, sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if (grid < 1 || grid > sms) return cudaErrorInvalidValue;
  if ((err = raise_smem<HD>(device)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mega_kernel<HD>, NTHREADS,
                                                      smem_bytes(HD));
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  if ((err = cudaMemsetAsync(a.sync, 0, sync_words * sizeof(unsigned), st)) != cudaSuccess) return err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(mega_kernel<HD>), dim3(grid),
                                    dim3(NTHREADS), params, smem_bytes(HD), st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The whole decode step. Weights as packed by ops/cuda/decode_megakernel.py
// (stream, scales, norms, bias); x0 [B, D] bf16; the caches [L, B, S, KVD]
// int8 and [L, B, S] f32, slot wps[row] written in place; out [B, D] bf16.
// Workspaces: x [B, D] f32, qkv [B, W] f32, kvmax [B, KV, 4] f32, att [B, D]
// and gu [B, F] bf16, ssq [D / 64, B] f32, part [row blocks * max over
// products of KS * units * 4096] f32, apart [B * KV * ns * (H / KV) *
// (HD + 4)] f32, sync [1 + B * KV] u32. ks_*: the products' K-slices, each
// at most the grid and with slices of at most KBS_MAX k-blocks; bps, ns:
// attention's 16-key blocks a split and splits a row (bps * ns >=
// ceil(S / 16), ns <= 32: a lane of a merging warp for each split; with
// more than one split, at most one item (row, kv head, split) a consumer
// warp of the grid). grid: CTAs, at most one an SM.
extern "C" int decode_megakernel(
    int device, const void* stream_w, const void* scales, const void* norms, const void* bias,
    const void* x0, const void* cos_tab, const void* sin_tab, void* kc, void* vc, void* ks,
    void* vs, const void* wps, const void* positions, const void* starts, void* out, void* x,
    void* qkv, void* kvmax, void* att, void* gu, void* ssq, void* part, void* apart, void* sync,
    void* clock,
    int B, int S, int L, int D, int H, int KV, int HD, int F, int S_rope, int ks_qkv, int ks_o,
    int ks_gu, int ks_down, int bps, int ns, int grid, float eps, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int W = (H + 2 * KV) * HD;
  const int kb_d = D / KBLK, kb_f = F / KBLK;
  auto slices_ok = [&](int ks, int kb) {
    return ks >= 1 && ks <= grid && ks <= kb && (kb + ks - 1) / ks <= KBS_MAX;
  };
  if (B <= 0 || S <= 0 || L <= 0 || KV <= 0 || H % KV != 0 || H / KV > MAXG || H * HD != D ||
      D % UNIT != 0 || F % UNIT != 0 || W % UNIT != 0 || !slices_ok(ks_qkv, kb_d) ||
      !slices_ok(ks_o, kb_d) || !slices_ok(ks_gu, kb_d) || !slices_ok(ks_down, kb_f) || bps < 1 ||
      (long long)bps * ns < (S + KEYS - 1) / KEYS || ns > 32 ||
      (ns > 1 && (long long)B * KV * ns > (long long)grid * NCW) || !aligned16(stream_w) || !aligned16(x) ||
      !aligned16(part) || !aligned16(apart) || !aligned16(kc) || !aligned16(vc))
    return cudaErrorInvalidValue;
  MegaArgs a;
  a.stream = static_cast<const int8_t*>(stream_w);
  a.scales = static_cast<const float*>(scales);
  a.norms = static_cast<const float*>(norms);
  a.bias = static_cast<const float*>(bias);
  a.x0 = static_cast<const __nv_bfloat16*>(x0);
  a.cos_tab = static_cast<const float*>(cos_tab);
  a.sin_tab = static_cast<const float*>(sin_tab);
  a.kc = static_cast<int8_t*>(kc);
  a.vc = static_cast<int8_t*>(vc);
  a.ks = static_cast<float*>(ks);
  a.vs = static_cast<float*>(vs);
  a.wps = static_cast<const int*>(wps);
  a.positions = static_cast<const int*>(positions);
  a.starts = static_cast<const int*>(starts);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.x = static_cast<float*>(x);
  a.qkv = static_cast<float*>(qkv);
  a.kvmax = static_cast<float*>(kvmax);
  a.att = static_cast<__nv_bfloat16*>(att);
  a.gu = static_cast<__nv_bfloat16*>(gu);
  a.ssq = static_cast<float*>(ssq);
  a.part = static_cast<float*>(part);
  a.apart = static_cast<float*>(apart);
  a.sync = static_cast<unsigned*>(sync);
  a.clock = static_cast<unsigned long long*>(clock);
  a.B = B; a.S = S; a.L = L; a.D = D; a.H = H; a.KV = KV; a.HD = HD; a.F = F;
  a.S_rope = S_rope;
  a.slices[QKV] = ks_qkv;
  a.slices[OPROJ] = ks_o;
  a.slices[GATE_UP] = ks_gu;
  a.slices[DOWN] = ks_down;
  a.bps = bps;
  a.ns = ns;
  a.eps = eps;
  a.scale = scale;
  const size_t sync_words = 1 + (size_t)B * KV;
  const auto st = static_cast<cudaStream_t>(stream);
  if (HD == 128) return launch<128>(a, device, grid, sync_words, st);
  if (HD == 64) return launch<64>(a, device, grid, sync_words, st);
  if (HD == 32) return launch<32>(a, device, grid, sync_words, st);
  if (HD == 16) return launch<16>(a, device, grid, sync_words, st);
  return cudaErrorInvalidValue;
}
