// Kernels K7 and K8: causal grouped-query flash-attention backward.
//
// K7 replaces the Pallas TPU kernel _bwd_dq_kernel and K8 _bwd_dkv_kernel
// of rlinf_tpu/ops/pallas/flash_attention.py (pallas_calls in _flash_bwd).
// Same function: with s = q k^T * scale under the mask (pos_kv <= pos_q)
// AND kv_valid, p = exp(s - lse) where unmasked and 0 elsewhere (lse is
// what K1 wrote), dp = do v^T, ds = p (dp - delta) * scale with
// delta = rowsum(o * do) (computed by the wrapper, as the JAX package
// does outside its kernels):
//   K7: dq = ds k                      (written in q's dtype)
//   K8: dk = ds^T q, dv = p^T do       (f32, summed over the query heads of
//                                       each kv head, cast to k's dtype)
//
// What bounds them on an H100: operations. At the training shapes (B=16,
// T=768, H=12, Kv=2, Hd=128) K7 does three and K8 four T x T x Hd products
// per (row, head), halved by causality: 43 and 58 GFLOP against ~0.2 GB of
// operands. The products run on the tensor cores as warp-level mma.sync
// m16n8k16 bf16 tiles with f32 accumulation. As in flash-attention 2, p
// and ds are rounded to bf16 before they enter the second products (dq,
// dk, dv); s, dp, p and ds themselves are formed in f32.
//
// Design. The TPU kernels loop over key (dq) or query (dk/dv) blocks
// inside a program, with _block_bounds scalar-prefetched to skip blocks.
// Here K7 gives one CTA of 8 warps one (batch row, query head, 64-row
// query tile) and loops over 64-key tiles; K8 gives one CTA one (batch
// row, kv head, 64-key tile) and loops over the G query heads of the group
// and over 64-row query tiles, so the GQA group sum happens in registers
// and needs no [B, H, Sk, Hd] f32 intermediate. Both skip a pair of tiles
// when the key tile's least valid position exceeds the query tile's
// greatest position, the rule K1 uses. K8 writes p and ds transposed into
// shared memory, so both of its second products read a row-major A.

#include "common.cuh"

namespace {

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // keys per tile
constexpr int NT = 256;      // 8 warps: 2 along M x 4 along N
constexpr int LDP = BK + 8;  // bf16 per row of the p / ds tiles (distinct banks)

template <int HD>
struct Tile {
  static constexpr int LD = HD + 8;  // bf16 per row of a [64][HD] tile
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// A fragment (rows r0.. r0+15, k k0.. k0+15) of a row-major [m][k] tile.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const __nv_bfloat16* x, int r0, int k0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const __nv_bfloat16* p = x + (r0 + g) * LD + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// B fragment (k k0.. k0+15, n n0.. n0+7) of a tile stored [n][k].
template <int LD>
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[2], const __nv_bfloat16* y, int n0, int k0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const __nv_bfloat16* p = y + (n0 + g) * LD + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B fragment of a tile stored [k][n] (n contiguous): two 16-bit loads each.
template <int LD>
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[2], const __nv_bfloat16* z, int n0, int k0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const __nv_bfloat16* p = z + (k0 + 2 * t) * LD + n0 + g;
  b[0] = pack2(p[0], p[LD]);
  b[1] = pack2(p[8 * LD], p[9 * LD]);
}

// 64 rows of x [B, S, NH, HD] at head hh into a [64][LD] tile; rows past S are 0.
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ x,
                                          int b, int s0, int S, int NH, int hh) {
  constexpr int LD = Tile<HD>::LD, CH = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CH; i += NT) {
    const int r = i / CH, c = i % CH, s = s0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (s < S) v = *reinterpret_cast<const uint4*>(x + ((size_t)(b * S + s) * NH + hh) * HD + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = v;
  }
}

// Per-row inputs of a query tile: positions, lse, delta; tracks the max position.
__device__ __forceinline__ void load_query_meta(float* lse_s, float* delta_s, int* pos_s,
                                                int* qmax, const int* __restrict__ pos_q,
                                                const float* __restrict__ lse,
                                                const float* __restrict__ delta, int b, int h,
                                                int q0, int Sq, int H) {
  const int tid = threadIdx.x;
  if (tid < BQ) {
    const int s = q0 + tid;
    const bool in = s < Sq;
    const size_t at = ((size_t)b * H + h) * Sq + s;
    pos_s[tid] = in ? pos_q[(size_t)b * Sq + s] : INT_MIN;
    lse_s[tid] = in ? lse[at] : 0.f;
    delta_s[tid] = in ? delta[at] : 0.f;
    if (in) atomicMax(qmax, pos_s[tid]);
  }
}

__device__ __forceinline__ void load_key_meta(int* pos_s, int* valid_s, int* kmin,
                                              const int* __restrict__ pos_kv,
                                              const uint8_t* __restrict__ valid, int b, int k0,
                                              int Sk) {
  const int tid = threadIdx.x;
  if (tid < BK) {
    const int s = k0 + tid;
    const int ok = s < Sk && valid[(size_t)b * Sk + s] != 0;
    const int pk = s < Sk ? pos_kv[(size_t)b * Sk + s] : 0;
    pos_s[tid] = pk;
    valid_s[tid] = ok;
    if (ok) atomicMin(kmin, pk);
  }
}

// s = q k^T and dp = do v^T for the 64 x 64 (query, key) tile: warp (wm, wn)
// owns queries wm*32 + [0, 32) and keys wn*16 + [0, 16).
template <int HD>
__device__ __forceinline__ void scores(const __nv_bfloat16* q, const __nv_bfloat16* dO,
                                       const __nv_bfloat16* k, const __nv_bfloat16* v,
                                       float (&s)[2][2][4], float (&dp)[2][2][4]) {
  constexpr int LD = Tile<HD>::LD;
  const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][j][e] = dp[i][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t aq[2][4], ad[2][4], bk[2][2], bv[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      frag_a<LD>(aq[mi], q, wm * 32 + mi * 16, kk);
      frag_a<LD>(ad[mi], dO, wm * 32 + mi * 16, kk);
    }
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      frag_b_nk<LD>(bk[ni], k, wn * 16 + ni * 8, kk);
      frag_b_nk<LD>(bv[ni], v, wn * 16 + ni * 8, kk);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        mma_bf16(s[mi][ni], aq[mi], bk[ni]);
        mma_bf16(dp[mi][ni], ad[mi], bv[ni]);
      }
  }
}

// (query row, key column) of element e of fragment (mi, ni) of scores().
__device__ __forceinline__ int score_row(int mi, int e) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / 4) * 32 + mi * 16 + lane / 4 + 8 * (e / 2);
}

__device__ __forceinline__ int score_col(int ni, int e) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp % 4) * 16 + ni * 8 + 2 * (lane % 4) + e % 2;
}

template <int HD>
struct DqSmem {
  __nv_bfloat16 q[BQ * Tile<HD>::LD];
  __nv_bfloat16 dO[BQ * Tile<HD>::LD];
  __nv_bfloat16 k[BK * Tile<HD>::LD];
  __nv_bfloat16 v[BK * Tile<HD>::LD];
  __nv_bfloat16 ds[BQ * LDP];
  float lse[BQ], delta[BQ];
  int pos_q[BQ], pos_kv[BK], valid[BK];
  int qmax, kmin;
};

template <int HD>
struct DkvSmem {
  __nv_bfloat16 k[BK * Tile<HD>::LD];
  __nv_bfloat16 v[BK * Tile<HD>::LD];
  __nv_bfloat16 q[BQ * Tile<HD>::LD];
  __nv_bfloat16 dO[BQ * Tile<HD>::LD];
  __nv_bfloat16 pT[BK * LDP];   // [key][query]
  __nv_bfloat16 dsT[BK * LDP];  // [key][query]
  float lse[BQ], delta[BQ];
  int pos_q[BQ], pos_kv[BK], valid[BK];
  int qmax, kmin;
};

template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ pos_q,
    const int* __restrict__ pos_kv, const uint8_t* __restrict__ valid,
    const __nv_bfloat16* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H,
    int KV, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem<HD>& sm = *reinterpret_cast<DqSmem<HD>*>(smem_raw);
  constexpr int LD = Tile<HD>::LD;
  constexpr int NI = HD / 32;  // 8-column fragments per warp in the dS.K product
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, wm = warp / 4, wn = warp % 4;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;

  if (tid == 0) sm.qmax = INT_MIN;
  __syncthreads();
  load_rows<HD>(sm.q, q, b, q0, Sq, H, h);
  load_rows<HD>(sm.dO, dO, b, q0, Sq, H, h);
  load_query_meta(sm.lse, sm.delta, sm.pos_q, &sm.qmax, pos_q, lse, delta, b, h, q0, Sq, H);

  float acc[2][NI][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_kt = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's ds and k are consumed
    if (tid == 0) sm.kmin = INT_MAX;
    __syncthreads();
    load_key_meta(sm.pos_kv, sm.valid, &sm.kmin, pos_kv, valid, b, k0, Sk);
    __syncthreads();
    if (sm.kmin > sm.qmax) continue;  // no (query, key) pair of the tiles is unmasked
    load_rows<HD>(sm.k, k, b, k0, Sk, KV, kvh);
    load_rows<HD>(sm.v, v, b, k0, Sk, KV, kvh);
    __syncthreads();

    float s[2][2][4], dp[2][2][4];
    scores<HD>(sm.q, sm.dO, sm.k, sm.v, s, dp);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = score_row(mi, 2 * hh);
          float d[2];
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            const int e = 2 * hh + c2, c = score_col(ni, e);
            const bool ok = sm.valid[c] && sm.pos_kv[c] <= sm.pos_q[r];
            const float p = ok ? expf(s[mi][ni][e] * scale - sm.lse[r]) : 0.f;
            d[c2] = p * (dp[mi][ni][e] - sm.delta[r]) * scale;
          }
          *reinterpret_cast<__nv_bfloat162*>(&sm.ds[r * LDP + score_col(ni, 2 * hh)]) =
              __floats2bfloat162_rn(d[0], d[1]);
        }
    __syncthreads();

    // dq += dS K: warp (wm, wn) owns queries wm*32 + [0, 32), columns wn*HD/4 + [0, HD/4)
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) frag_a<LDP>(a[mi], sm.ds, wm * 32 + mi * 16, kk);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        uint32_t bb[2];
        frag_b_kn<LD>(bb, sm.k, wn * (HD / 4) + ni * 8, kk);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], bb);
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s = q0 + wm * 32 + mi * 16 + g + 8 * hh;
      if (s >= Sq) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = wn * (HD / 4) + ni * 8 + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(&dq[((size_t)(b * Sq + s) * H + h) * HD + col]) =
            __floats2bfloat162_rn(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
      }
    }
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ pos_q,
    const int* __restrict__ pos_kv, const uint8_t* __restrict__ valid,
    const __nv_bfloat16* __restrict__ dO, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int H, int KV, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem<HD>& sm = *reinterpret_cast<DkvSmem<HD>*>(smem_raw);
  constexpr int LD = Tile<HD>::LD;
  constexpr int NI = HD / 32;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid / 32, wm = warp / 4, wn = warp % 4;
  const int lane = tid % 32, g = lane / 4, t = lane % 4;

  if (tid == 0) sm.kmin = INT_MAX;
  __syncthreads();
  load_key_meta(sm.pos_kv, sm.valid, &sm.kmin, pos_kv, valid, b, k0, Sk);
  load_rows<HD>(sm.k, k, b, k0, Sk, KV, kvh);
  load_rows<HD>(sm.v, v, b, k0, Sk, KV, kvh);

  // warp (wm, wn) owns keys wm*32 + [0, 32), columns wn*HD/4 + [0, HD/4)
  float dk_acc[2][NI][4], dv_acc[2][NI][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[i][j][e] = dv_acc[i][j][e] = 0.f;

  const int n_qt = (Sq + BQ - 1) / BQ;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's p, ds, q and do are consumed
      if (tid == 0) sm.qmax = INT_MIN;
      __syncthreads();
      load_query_meta(sm.lse, sm.delta, sm.pos_q, &sm.qmax, pos_q, lse, delta, b, h, q0, Sq,
                      H);
      __syncthreads();
      if (sm.kmin > sm.qmax) continue;
      load_rows<HD>(sm.q, q, b, q0, Sq, H, h);
      load_rows<HD>(sm.dO, dO, b, q0, Sq, H, h);
      __syncthreads();

      float s[2][2][4], dp[2][2][4];
      scores<HD>(sm.q, sm.dO, sm.k, sm.v, s, dp);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = score_row(mi, e), c = score_col(ni, e);
            const bool ok = sm.valid[c] && sm.pos_kv[c] <= sm.pos_q[r];
            const float p = ok ? expf(s[mi][ni][e] * scale - sm.lse[r]) : 0.f;
            sm.pT[c * LDP + r] = __float2bfloat16(p);
            sm.dsT[c * LDP + r] = __float2bfloat16(p * (dp[mi][ni][e] - sm.delta[r]) * scale);
          }
      __syncthreads();

      // dv += P^T dO, dk += dS^T Q over the 64 queries of the tile
#pragma unroll
      for (int kk = 0; kk < BQ; kk += 16) {
        uint32_t ap[2][4], ad[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          frag_a<LDP>(ap[mi], sm.pT, wm * 32 + mi * 16, kk);
          frag_a<LDP>(ad[mi], sm.dsT, wm * 32 + mi * 16, kk);
        }
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          uint32_t bd[2], bq[2];
          frag_b_kn<LD>(bd, sm.dO, wn * (HD / 4) + ni * 8, kk);
          frag_b_kn<LD>(bq, sm.q, wn * (HD / 4) + ni * 8, kk);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(dv_acc[mi][ni], ap[mi], bd);
            mma_bf16(dk_acc[mi][ni], ad[mi], bq);
          }
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s = k0 + wm * 32 + mi * 16 + g + 8 * hh;
      if (s >= Sk) continue;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = wn * (HD / 4) + ni * 8 + 2 * t;
        const size_t at = ((size_t)(b * Sk + s) * KV + kvh) * HD + col;
        *reinterpret_cast<__nv_bfloat162*>(&dk[at]) =
            __floats2bfloat162_rn(dk_acc[mi][ni][2 * hh], dk_acc[mi][ni][2 * hh + 1]);
        *reinterpret_cast<__nv_bfloat162*>(&dv[at]) =
            __floats2bfloat162_rn(dv_acc[mi][ni][2 * hh], dv_acc[mi][ni][2 * hh + 1]);
      }
    }
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* pos_q,
              const void* pos_kv, const void* valid, const void* dO, const void* lse,
              const void* delta, void* dq, int B, int Sq, int Sk, int H, int KV, float scale,
              cudaStream_t stream) {
  const size_t smem = sizeof(DqSmem<HD>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(pos_q),
      static_cast<const int*>(pos_kv), static_cast<const uint8_t*>(valid),
      static_cast<const __nv_bfloat16*>(dO), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), Sq, Sk, H, KV, scale);
  return cudaGetLastError();
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* pos_q,
               const void* pos_kv, const void* valid, const void* dO, const void* lse,
               const void* delta, void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
               float scale, cudaStream_t stream) {
  const size_t smem = sizeof(DkvSmem<HD>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + BK - 1) / BK, KV, B);
  flash_bwd_dkv_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(pos_q),
      static_cast<const int*>(pos_kv), static_cast<const uint8_t*>(valid),
      static_cast<const __nv_bfloat16*>(dO), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), Sq, Sk, H, KV, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool args_ok(int H, int KV, const void* q, const void* k, const void* v, const void* dO) {
  return KV > 0 && H % KV == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
         aligned16(dO);
}

}  // namespace

// K7. q, dO [B, Sq, H, HD] bf16; k, v [B, Sk, KV, HD] bf16; pos_q [B, Sq],
// pos_kv [B, Sk] int32; valid [B, Sk] uint8; lse, delta [B, H, Sq] f32;
// dq [B, Sq, H, HD] bf16. HD is 64 or 128; tensors 16-byte aligned.
extern "C" int flash_attention_bwd_dq(int device, const void* q, const void* k, const void* v,
                                      const void* pos_q, const void* pos_kv, const void* valid,
                                      const void* dO, const void* lse, const void* delta,
                                      void* dq, int B, int Sq, int Sk, int H, int KV, int HD,
                                      float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!args_ok(H, KV, q, k, v, dO)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128)
    return launch_dq<128>(q, k, v, pos_q, pos_kv, valid, dO, lse, delta, dq, B, Sq, Sk, H, KV,
                          scale, st);
  if (HD == 64)
    return launch_dq<64>(q, k, v, pos_q, pos_kv, valid, dO, lse, delta, dq, B, Sq, Sk, H, KV,
                         scale, st);
  return cudaErrorInvalidValue;
}

// K8. As K7; dk, dv [B, Sk, KV, HD] bf16.
extern "C" int flash_attention_bwd_dkv(int device, const void* q, const void* k, const void* v,
                                       const void* pos_q, const void* pos_kv,
                                       const void* valid, const void* dO, const void* lse,
                                       const void* delta, void* dk, void* dv, int B, int Sq,
                                       int Sk, int H, int KV, int HD, float scale,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!args_ok(H, KV, q, k, v, dO)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128)
    return launch_dkv<128>(q, k, v, pos_q, pos_kv, valid, dO, lse, delta, dk, dv, B, Sq, Sk, H,
                           KV, scale, st);
  if (HD == 64)
    return launch_dkv<64>(q, k, v, pos_q, pos_kv, valid, dO, lse, delta, dk, dv, B, Sq, Sk, H,
                          KV, scale, st);
  return cudaErrorInvalidValue;
}
