// Kernel K1: causal grouped-query flash-attention forward (prefill and the
// forward of training).
//
// Replaces the Pallas TPU kernel _fwd_kernel of
// rlinf_tpu/ops/pallas/flash_attention.py (pallas_call in _fwd_call), the
// forward of flash_attention(). Same function: out = softmax(q k^T * scale)
// v under the mask (pos_kv <= pos_q) AND kv_valid, online softmax in fp32,
// and the log-sum-exp of every query row (the backward, K7/K8, reads it).
//
// What bounds it on an H100: operations. At the prefill shapes (B=64,
// S=512, H=12, Kv=2, Hd=128) the two products are ~50 GFLOP after causal
// skipping against ~0.2 GB of bf16 operands, far right of the ridge point.
// The products run on the tensor cores as warp-level mma.sync m16n8k16
// bf16 tiles with f32 accumulation. The probabilities stay in registers
// between the two products (the C fragment of q k^T is the A fragment of
// P.V); unlike flash-attention 2 they enter P.V as two bf16 parts, high and
// low, so the forward keeps the accuracy of an fp32 P (measured on an
// H100: rounding P to bf16 alone doubled the error against the plain
// version and moved a small whole train step's update by 9% of its norm).
// wgmma and TMA are later work.
//
// Design. The TPU kernel walks a sequential grid with 512-row tiles in
// VMEM; here one CTA of 4 warps owns one (batch row, query head, 64-row
// query tile), each warp 16 query rows, so a row's running max and sum
// live in the 4 lanes of one warp and need no shared memory. The CTA loops
// over 64-key tiles staged in shared memory; the kv head is h / (H / Kv):
// GQA shares k/v tiles through the cache, no replication. A key tile whose
// least valid position exceeds the tile's greatest query position is
// skipped (the _block_bounds rule, evaluated per tile). Unlike the Pallas
// kernel, masked keys get probability 0 explicitly, so a query row with no
// valid key gives 0; rows with a valid key agree. Positions are arbitrary
// [B, S] int32: left-padded prompts give pad slots position 0.

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per CTA
constexpr int BK = 64;   // keys per shared-memory tile
constexpr int NT = 128;  // 4 warps, 16 query rows each

template <int HD>
struct Smem {
  static constexpr int LD = HD + 8;  // bf16 per row: fragment loads hit distinct banks
  __nv_bfloat16 q[BQ * LD];
  __nv_bfloat16 k[BK * LD];
  __nv_bfloat16 v[BK * LD];
  int pos_q[BQ];
  int pos_kv[BK];
  int valid[BK];
  int qmax, kmin;
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

// (x0, x1) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split_f2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  hi = pack2(h0, h1);
  lo = pack2(__float2bfloat16(x0 - __bfloat162float(h0)),
             __float2bfloat16(x1 - __bfloat162float(h1)));
}

// 64 rows of x [B, S, NH, HD] at head hh into a [64][LD] tile; rows past S are 0.
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ x,
                                          int b, int s0, int S, int NH, int hh) {
  constexpr int LD = Smem<HD>::LD, CH = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CH; i += NT) {
    const int r = i / CH, c = i % CH, s = s0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (s < S) val = *reinterpret_cast<const uint4*>(x + ((size_t)(b * S + s) * NH + hh) * HD + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q,   // [B, Sq, H, HD]
    const __nv_bfloat16* __restrict__ k,   // [B, Sk, KV, HD]
    const __nv_bfloat16* __restrict__ v,   // [B, Sk, KV, HD]
    const int* __restrict__ pos_q,         // [B, Sq]
    const int* __restrict__ pos_kv,        // [B, Sk]
    const uint8_t* __restrict__ valid,     // [B, Sk]
    __nv_bfloat16* __restrict__ out,       // [B, Sq, H, HD]
    float* __restrict__ lse,               // [B, H, Sq]
    int Sq, int Sk, int H, int KV, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  constexpr int LD = Smem<HD>::LD;
  constexpr int NO = HD / 8;  // 8-column output fragments per warp

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;  // this warp's first query row in the tile

  if (tid == 0) sm.qmax = INT_MIN;
  __syncthreads();
  load_rows<HD>(sm.q, q, b, q0, Sq, H, h);
  if (tid < BQ) {
    const int s = q0 + tid;
    const int pq = s < Sq ? pos_q[(size_t)b * Sq + s] : INT_MIN;
    sm.pos_q[tid] = pq;
    if (s < Sq) atomicMax(&sm.qmax, pq);
  }

  // rows r0 + g (index 0) and r0 + g + 8 (index 1) of this lane
  float m[2] = {RLINF_NEG_INF, RLINF_NEG_INF}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  const int n_kt = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's k and v are consumed
    if (tid == 0) sm.kmin = INT_MAX;
    __syncthreads();
    if (tid < BK) {
      const int s = k0 + tid;
      const int ok = s < Sk && valid[(size_t)b * Sk + s] != 0;
      const int pk = s < Sk ? pos_kv[(size_t)b * Sk + s] : 0;
      sm.pos_kv[tid] = pk;
      sm.valid[tid] = ok;
      if (ok) atomicMin(&sm.kmin, pk);
    }
    __syncthreads();
    if (sm.kmin > sm.qmax) continue;  // no (query, key) pair of the tiles is unmasked
    load_rows<HD>(sm.k, k, b, k0, Sk, KV, kvh);
    load_rows<HD>(sm.v, v, b, k0, Sk, KV, kvh);
    __syncthreads();

    // s = q k^T for 16 rows x 64 keys: 8 fragments of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4];
      const __nv_bfloat16* pa = sm.q + (r0 + g) * LD + kk + 2 * t;
      a[0] = ld32(pa);
      a[1] = ld32(pa + 8 * LD);
      a[2] = ld32(pa + 8);
      a[3] = ld32(pa + 8 * LD + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t bb[2];
        const __nv_bfloat16* pb = sm.k + (j * 8 + g) * LD + kk + 2 * t;
        bb[0] = ld32(pb);
        bb[1] = ld32(pb + 8);
        mma_bf16(s[j], a, bb);
      }
    }

    // mask, online softmax over the 4 lanes that share a row
    const int pq[2] = {sm.pos_q[r0 + g], sm.pos_q[r0 + g + 8]};
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1), i = e >> 1;
        const bool ok = sm.valid[c] && sm.pos_kv[c] <= pq[i];
        s[j][e] = ok ? s[j][e] * scale : RLINF_NEG_INF;
        mx[i] = fmaxf(mx[i], s[j][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(RLINF_FULL_MASK, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(RLINF_FULL_MASK, mx[i], 2));
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1), i = e >> 1;
        const bool ok = sm.valid[c] && sm.pos_kv[c] <= pq[i];
        const float p = ok ? expf(s[j][e] - m[i]) : 0.f;
        s[j][e] = p;
        sum[i] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(RLINF_FULL_MASK, sum[i], 1);
      sum[i] += __shfl_xor_sync(RLINF_FULL_MASK, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // o += P V: the C fragments of s are the A fragments of P, split into
    // a bf16 high part and a bf16 low part (p - hi), so P keeps ~16
    // mantissa bits and the product stays as close to the fp32 version as
    // the scalar kernel was
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t hi[4], lo[4];
      split_f2(s[2 * kc][0], s[2 * kc][1], hi[0], lo[0]);
      split_f2(s[2 * kc][2], s[2 * kc][3], hi[1], lo[1]);
      split_f2(s[2 * kc + 1][0], s[2 * kc + 1][1], hi[2], lo[2]);
      split_f2(s[2 * kc + 1][2], s[2 * kc + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        // B(k = key, n = d) from v [key][d]: two 16-bit loads per register
        const __nv_bfloat16* pb = sm.v + (kc * 16 + 2 * t) * LD + j * 8 + g;
        uint32_t bb[2];
        bb[0] = pack2(pb[0], pb[LD]);
        bb[1] = pack2(pb[8 * LD], pb[9 * LD]);
        mma_bf16(o[j], hi, bb);
        mma_bf16(o[j], lo, bb);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = q0 + r0 + g + 8 * i;
    if (s >= Sq) continue;
    const float ls = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(&out[((size_t)(b * Sq + s) * H + h) * HD + j * 8 + 2 * t]) =
          __floats2bfloat162_rn(o[j][2 * i] / ls, o[j][2 * i + 1] / ls);
    if (t == 0) lse[((size_t)b * H + h) * Sq + s] = m[i] + logf(ls);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* pos_q,
           const void* pos_kv, const void* valid, void* out, void* lse, int B,
           int Sq, int Sk, int H, int KV, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(Smem<HD>);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(pos_q),
      static_cast<const int*>(pos_kv), static_cast<const uint8_t*>(valid),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), Sq, Sk, H, KV, scale);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// q [B, Sq, H, HD], k/v [B, Sk, KV, HD] bf16 (16-byte aligned); HD 64 or 128.
extern "C" int flash_attention_fwd(int device, const void* q, const void* k,
                                   const void* v, const void* pos_q,
                                   const void* pos_kv, const void* valid,
                                   void* out, void* lse, int B, int Sq, int Sk,
                                   int H, int KV, int HD, float scale,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (KV <= 0 || H % KV != 0 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(out))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 128) return launch<128>(q, k, v, pos_q, pos_kv, valid, out, lse, B, Sq, Sk, H, KV, scale, st);
  if (HD == 64) return launch<64>(q, k, v, pos_q, pos_kv, valid, out, lse, B, Sq, Sk, H, KV, scale, st);
  return cudaErrorInvalidValue;
}
