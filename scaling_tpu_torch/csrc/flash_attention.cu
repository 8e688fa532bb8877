// Flash attention forward (K4) and backward (K5), for Hopper (sm_90a).
//
// Replaces the TPU kernels behind `flash_attention_fused` in
// scaling_tpu/ops/flash_attention.py: jax's splash attention (its forward
// and its dq / dkv backward passes). Same contract: q (b, s, n, d) already
// multiplied by the softmax scale, k and v (b, s, n_kv, d) UNREPEATED,
// query head h reads kv head h / n_rep. Query q may attend key k iff
// k <= q, segment_ids[q] == segment_ids[k] and, for the trailing
// num_local_heads heads, q - k <= local_window. The softmax is f32; the
// forward writes O in q's dtype and the log-sum-exp (b, n, s) in f32.
//
// What bounds it on an H100: operations. At the training shape (b 4,
// s 2048, 16 / 4 heads, d 128) the forward needs 2*b*n*d*s^2 = 69 GFLOP
// of products for 2*b*s*(n + 2*n_kv)*d*2 = 50 MB of operands, far right
// of the card's ridge (~295 FLOP a byte), so the products must run on the
// tensor cores. The design:
//   * the products QK^T, PV (and in the backward the four others) use
//     bf16 tensor-core fragments (WMMA 16x16x16, f32 accumulate);
//   * one thread block of 4 warps per 64-row tile; each warp owns a
//     16-row strip of the tile, so the online softmax of a row, and its
//     rescale, stay inside one warp (no block barrier between the
//     products and the softmax);
//   * causal skipping at tile granularity: a query tile walks kv tiles
//     only up to the diagonal (and, for a local head, only from the tile
//     that holds q - window), so a tile that causality rules out is never
//     loaded; element masks apply on the diagonal, for segments and for
//     the window;
//   * the (b, s, n, d) layout is read through its strides, 16 bytes a
//     thread, with no transposing copies;
//   * the backward is FA2's: a pass for D = rowsum(dO * O); a dK/dV
//     kernel with one block per (batch, KV head, 64-row kv tile) that walks
//     the group's n_rep query heads and the query tiles on or after the
//     diagonal, so the GQA sum happens inside the block; a dQ kernel with
//     one block per (batch, query head, query tile). Every output element
//     is written by one block, in a fixed order: no atomics, and the
//     gradients are bitwise identical from run to run.
// The softmax probabilities P and dS enter the products as bf16 (FA2
// does the same); O, dK, dV and dQ accumulate in f32.
//
// Still a simple version: WMMA fragments (mma.sync underneath) staged
// through shared memory, no wgmma, no TMA, no warp specialisation, one
// pass per query tile with a block barrier per kv tile. Causal work is
// triangular: the first query tiles are nearly empty and the last full;
// the heavy tiles are launched first, and nothing else balances them.
// Limits (the wrapper checks): bf16, head dim 64 or 128, s % 64 == 0,
// unit last stride, 16-byte aligned rows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// Bound from Python through ctypes (scaling_tpu_torch/ops/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;   // rows of a query tile and of a kv tile
constexpr int kWarps = 4;   // each owns a 16-row strip of the tile
constexpr int kThreads = kWarps * 32;
constexpr int kFrag = 16;   // WMMA m = n = k

typedef wmma::fragment<wmma::matrix_a, kFrag, kFrag, kFrag, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, kFrag, kFrag, kFrag, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, kFrag, kFrag, kFrag, float> FragC;

// Shared-memory row strides (elements). Padded so rows start on different
// banks; every 16-row block offset stays a multiple of 32 bytes, as WMMA
// loads require.
template <int D>
struct Ld {
  static constexpr int kH = D + 8;       // bf16 tiles of d columns: Q, K, V, dO
  static constexpr int kS = kTile + 4;   // f32 score tiles: S, dP
  static constexpr int kP = kTile + 8;   // bf16 probability tiles: P, dS
  static constexpr int kO = D + 4;       // f32 d-column tiles: O, staged dQ/dK/dV
};

// strides (elements) of one (b, s, heads, d) tensor: batch, sequence, head
struct Strides {
  long long b, s, h;
};

struct FwdParams {
  const bf16 *q, *k, *v;
  const int32_t* seg;  // (b, s)
  bf16* o;
  float* lse;  // (b, n, s)
  Strides sq, sk, sv, so;
  int b, s, n, n_kv, n_rep, num_local, window;
};

struct BwdParams {
  const bf16 *q, *k, *v, *o, *dout;
  const int32_t* seg;
  const float* lse;  // (b, n, s)
  float* delta;      // (b, n, s): rowsum(dO * O)
  bf16 *dq, *dk, *dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int b, s, n, n_kv, n_rep, num_local, window;
};

__device__ __forceinline__ bool allowed(int qi, int ki, int seg_q, int seg_k, bool local,
                                        int window) {
  return ki <= qi && seg_q == seg_k && (!local || qi - ki <= window);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// a (kTile, D) bf16 tile of rows row0.. of one head into shared memory, 16 bytes a thread
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride) {
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x; i < kTile * kVecs; i += kThreads) {
    const int r = i / kVecs, c = (i % kVecs) * 8;
    *reinterpret_cast<uint4*>(dst + r * Ld<D>::kH + c) =
        *reinterpret_cast<const uint4*>(src + r * row_stride + c);
  }
}

// one warp's 16 rows of a (16, D) f32 strip in shared memory -> bf16 rows in device memory
template <int D>
__device__ __forceinline__ void store_strip(bf16* dst, long long row_stride, const float* src,
                                            int lane) {
  for (int r = 0; r < kFrag; ++r)
    for (int c = lane; c < D; c += 32) dst[r * row_stride + c] = __float2bfloat16(src[r * Ld<D>::kO + c]);
}

// acc[j] = A_strip (16 x D, row-major) times B^T, where B is a (kTile, D)
// row-major tile: the (16 x kTile) product of a warp's rows with every row of B
template <int D>
__device__ __forceinline__ void strip_times_tile_t(FragC (&acc)[kTile / kFrag], const bf16* a,
                                                   const bf16* b) {
#pragma unroll
  for (int j = 0; j < kTile / kFrag; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D; kk += kFrag) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, Ld<D>::kH);
#pragma unroll
    for (int j = 0; j < kTile / kFrag; ++j) {
      FragBCol fb;
      wmma::load_matrix_sync(fb, b + j * kFrag * Ld<D>::kH + kk, Ld<D>::kH);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// acc[j] += P_strip (16 x kTile bf16, row stride Ld::kP) times B (kTile x D row-major tile)
template <int D>
__device__ __forceinline__ void strip_times_tile(FragC (&acc)[D / kFrag], const bf16* p,
                                                 const bf16* b) {
  FragA fa[kTile / kFrag];
#pragma unroll
  for (int kk = 0; kk < kTile / kFrag; ++kk)
    wmma::load_matrix_sync(fa[kk], p + kk * kFrag, Ld<D>::kP);
#pragma unroll
  for (int j = 0; j < D / kFrag; ++j) {
#pragma unroll
    for (int kk = 0; kk < kTile / kFrag; ++kk) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, b + kk * kFrag * Ld<D>::kH + j * kFrag, Ld<D>::kH);
      wmma::mma_sync(acc[j], fa[kk], fb, acc[j]);
    }
  }
}

template <int D>
__device__ __forceinline__ void store_scores(float* dst, FragC (&acc)[kTile / kFrag]) {
#pragma unroll
  for (int j = 0; j < kTile / kFrag; ++j)
    wmma::store_matrix_sync(dst + j * kFrag, acc[j], Ld<D>::kS, wmma::mem_row_major);
}

template <int D>
__device__ __forceinline__ void store_acc(float* dst, FragC (&acc)[D / kFrag]) {
#pragma unroll
  for (int j = 0; j < D / kFrag; ++j)
    wmma::store_matrix_sync(dst + j * kFrag, acc[j], Ld<D>::kO, wmma::mem_row_major);
}

// first kv tile a query tile starting at q0 can see (local heads start late)
__device__ __forceinline__ int first_kv_tile(int q0, bool local, int window) {
  if (!local || q0 - window <= 0) return 0;
  return (q0 - window) / kTile;
}

template <int D>
constexpr int fwd_smem_bytes() {
  return 3 * kTile * Ld<D>::kH * 2 + kTile * Ld<D>::kS * 4 + kTile * Ld<D>::kP * 2 +
         kTile * Ld<D>::kO * 4 + 2 * kTile * 4 + 2 * kTile * 4;
}

// ---------------------------------------------------------------- forward
// grid (s / kTile, n, b); block kThreads. Query tile qt = the heavy tiles first.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kTile * Ld<D>::kH;
  bf16* sV = sK + kTile * Ld<D>::kH;
  float* sS = reinterpret_cast<float*>(sV + kTile * Ld<D>::kH);
  bf16* sP = reinterpret_cast<bf16*>(sS + kTile * Ld<D>::kS);
  float* sO = reinterpret_cast<float*>(sP + kTile * Ld<D>::kP);
  float* sM = sO + kTile * Ld<D>::kO;
  float* sL = sM + kTile;
  int* sSegQ = reinterpret_cast<int*>(sL + kTile);
  int* sSegK = sSegQ + kTile;

  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int kvh = h / p.n_rep;
  const bool local = h >= p.n - p.num_local;
  const int q0 = qt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<D>(sQ, p.q + bb * p.sq.b + q0 * p.sq.s + h * p.sq.h, p.sq.s);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    sSegQ[i] = p.seg[(long long)bb * p.s + q0 + i];
    sM[i] = -INFINITY;
    sL[i] = 0.0f;
  }
  for (int i = threadIdx.x; i < kTile * Ld<D>::kO; i += kThreads) sO[i] = 0.0f;
  __syncthreads();

  const bf16* q_strip = sQ + warp * kFrag * Ld<D>::kH;
  float* s_strip = sS + warp * kFrag * Ld<D>::kS;
  bf16* p_strip = sP + warp * kFrag * Ld<D>::kP;
  float* o_strip = sO + warp * kFrag * Ld<D>::kO;

  for (int kt = first_kv_tile(q0, local, p.window); kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    load_tile<D>(sK, p.k + bb * p.sk.b + k0 * p.sk.s + kvh * p.sk.h, p.sk.s);
    load_tile<D>(sV, p.v + bb * p.sv.b + k0 * p.sv.s + kvh * p.sv.h, p.sv.s);
    for (int i = threadIdx.x; i < kTile; i += kThreads)
      sSegK[i] = p.seg[(long long)bb * p.s + k0 + i];
    __syncthreads();

    FragC acc[kTile / kFrag];
    strip_times_tile_t<D>(acc, q_strip, sK);
    store_scores<D>(s_strip, acc);
    __syncwarp();

    // online softmax of the warp's 16 rows: each lane takes 2 of the 64 columns
    for (int r = 0; r < kFrag; ++r) {
      const int row = warp * kFrag + r, qi = q0 + row;
      const float m_old = sM[row];
      float x[2], e[2];
      bool ok[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        ok[c] = allowed(qi, k0 + col, sSegQ[row], sSegK[col], local, p.window);
        x[c] = ok[c] ? s_strip[r * Ld<D>::kS + col] : -INFINITY;
      }
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x[0], x[1])));
      const float shift = m_new == -INFINITY ? 0.0f : m_new;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        e[c] = ok[c] ? expf(x[c] - shift) : 0.0f;
        p_strip[r * Ld<D>::kP + lane + 32 * c] = __float2bfloat16(e[c]);
      }
      const float sum = warp_sum(e[0] + e[1]);
      const float alpha = m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
      for (int c = lane; c < D; c += 32) o_strip[r * Ld<D>::kO + c] *= alpha;
      if (lane == 0) {
        sM[row] = m_new;
        sL[row] = sL[row] * alpha + sum;
      }
    }
    __syncwarp();

    // O_strip += P_strip V
    FragC o[D / kFrag];
#pragma unroll
    for (int j = 0; j < D / kFrag; ++j)
      wmma::load_matrix_sync(o[j], o_strip + j * kFrag, Ld<D>::kO, wmma::mem_row_major);
    strip_times_tile<D>(o, p_strip, sV);
    store_acc<D>(o_strip, o);
    __syncthreads();  // the next kv tile overwrites sK, sV and sSegK
  }

  for (int r = 0; r < kFrag; ++r) {
    const int row = warp * kFrag + r;
    const float l = sL[row];
    bf16* dst = p.o + bb * p.so.b + (long long)(q0 + row) * p.so.s + h * p.so.h;
    for (int c = lane; c < D; c += 32) dst[c] = __float2bfloat16(o_strip[r * Ld<D>::kO + c] / l);
    if (lane == 0) p.lse[((long long)bb * p.n + h) * p.s + q0 + row] = sM[row] + logf(l);
  }
}

// ---------------------------------------------------------------- backward
// D = rowsum(dO * O) in f32: one warp per (batch, position, head) row.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(BwdParams p) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.b * p.s * p.n) return;
  const int h = row % p.n;
  const long long t = row / p.n;
  const int qi = t % p.s, bb = t / p.s;
  const bf16* o = p.o + bb * p.so.b + (long long)qi * p.so.s + h * p.so.h;
  const bf16* d = p.dout + bb * p.sdo.b + (long long)qi * p.sdo.s + h * p.sdo.h;
  float acc = 0.0f;
  for (int c = lane; c < D; c += 32) acc += __bfloat162float(o[c]) * __bfloat162float(d[c]);
  acc = warp_sum(acc);
  if (lane == 0) p.delta[((long long)bb * p.n + h) * p.s + qi] = acc;
}

template <int D>
constexpr int bwd_smem_bytes() {
  return 4 * kTile * Ld<D>::kH * 2 + 2 * kTile * Ld<D>::kS * 4 + 2 * kTile * Ld<D>::kP * 2 +
         4 * kTile * 4;
}

// dK, dV of one 64-row kv tile of one kv head: grid (s / kTile, n_kv, b).
// Each warp owns 16 kv rows and works on transposed strips: S^T = K Q^T,
// dP^T = V dO^T, P^T = exp(S^T - lse), dS^T = P^T (dP^T - D),
// dV += P^T dO and dK += dS^T Q, for every query head of the group and
// every query tile on or after the diagonal.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kTile * Ld<D>::kH;
  bf16* sQ = sV + kTile * Ld<D>::kH;
  bf16* sdO = sQ + kTile * Ld<D>::kH;
  float* sS = reinterpret_cast<float*>(sdO + kTile * Ld<D>::kH);
  float* sdP = sS + kTile * Ld<D>::kS;
  bf16* sP = reinterpret_cast<bf16*>(sdP + kTile * Ld<D>::kS);
  bf16* sdS = sP + kTile * Ld<D>::kP;
  float* sLse = reinterpret_cast<float*>(sdS + kTile * Ld<D>::kP);
  float* sDelta = sLse + kTile;
  int* sSegQ = reinterpret_cast<int*>(sDelta + kTile);
  int* sSegK = sSegQ + kTile;

  const int kt = blockIdx.x, kvh = blockIdx.y, bb = blockIdx.z;
  const int k0 = kt * kTile, n_tiles = p.s / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<D>(sK, p.k + bb * p.sk.b + k0 * p.sk.s + kvh * p.sk.h, p.sk.s);
  load_tile<D>(sV, p.v + bb * p.sv.b + k0 * p.sv.s + kvh * p.sv.h, p.sv.s);
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    sSegK[i] = p.seg[(long long)bb * p.s + k0 + i];

  const bf16* k_strip = sK + warp * kFrag * Ld<D>::kH;
  const bf16* v_strip = sV + warp * kFrag * Ld<D>::kH;
  float* s_strip = sS + warp * kFrag * Ld<D>::kS;
  float* dp_strip = sdP + warp * kFrag * Ld<D>::kS;
  bf16* p_strip = sP + warp * kFrag * Ld<D>::kP;
  bf16* ds_strip = sdS + warp * kFrag * Ld<D>::kP;

  FragC dk[D / kFrag], dv[D / kFrag];
#pragma unroll
  for (int j = 0; j < D / kFrag; ++j) {
    wmma::fill_fragment(dk[j], 0.0f);
    wmma::fill_fragment(dv[j], 0.0f);
  }

  for (int rep = 0; rep < p.n_rep; ++rep) {
    const int h = kvh * p.n_rep + rep;
    const bool local = h >= p.n - p.num_local;
    int qt_end = n_tiles - 1;
    if (local) qt_end = min(qt_end, (k0 + kTile - 1 + p.window) / kTile);
    for (int qt = kt; qt <= qt_end; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's products are done with sQ, sdO
      load_tile<D>(sQ, p.q + bb * p.sq.b + q0 * p.sq.s + h * p.sq.h, p.sq.s);
      load_tile<D>(sdO, p.dout + bb * p.sdo.b + q0 * p.sdo.s + h * p.sdo.h, p.sdo.s);
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        const long long idx = ((long long)bb * p.n + h) * p.s + q0 + i;
        sLse[i] = p.lse[idx];
        sDelta[i] = p.delta[idx];
        sSegQ[i] = p.seg[(long long)bb * p.s + q0 + i];
      }
      __syncthreads();

      FragC acc[kTile / kFrag];
      strip_times_tile_t<D>(acc, k_strip, sQ);
      store_scores<D>(s_strip, acc);
      strip_times_tile_t<D>(acc, v_strip, sdO);
      store_scores<D>(dp_strip, acc);
      __syncwarp();
      for (int r = 0; r < kFrag; ++r) {
        const int krow = warp * kFrag + r;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = lane + 32 * c;
          const bool ok = allowed(q0 + col, k0 + krow, sSegQ[col], sSegK[krow], local, p.window);
          const float pt = ok ? expf(s_strip[r * Ld<D>::kS + col] - sLse[col]) : 0.0f;
          const float dst = pt * (dp_strip[r * Ld<D>::kS + col] - sDelta[col]);
          p_strip[r * Ld<D>::kP + col] = __float2bfloat16(pt);
          ds_strip[r * Ld<D>::kP + col] = __float2bfloat16(dst);
        }
      }
      __syncwarp();
      strip_times_tile<D>(dv, p_strip, sdO);
      strip_times_tile<D>(dk, ds_strip, sQ);
    }
  }

  // stage each accumulator through shared memory (the score tiles are free now)
  __syncthreads();
  float* stage = sS + warp * kFrag * Ld<D>::kO;  // sS and sdP hold kTile * Ld::kO floats
  store_acc<D>(stage, dv);
  __syncwarp();
  store_strip<D>(p.dv + bb * p.sdv.b + (long long)(k0 + warp * kFrag) * p.sdv.s + kvh * p.sdv.h,
                 p.sdv.s, stage, lane);
  __syncwarp();
  store_acc<D>(stage, dk);
  __syncwarp();
  store_strip<D>(p.dk + bb * p.sdk.b + (long long)(k0 + warp * kFrag) * p.sdk.s + kvh * p.sdk.h,
                 p.sdk.s, stage, lane);
}

// dQ of one 64-row query tile of one query head: grid (s / kTile, n, b).
// Each warp owns 16 query rows: S = Q K^T, dP = dO V^T, P = exp(S - lse),
// dS = P (dP - D), dQ += dS K over the kv tiles up to the diagonal.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + kTile * Ld<D>::kH;
  bf16* sK = sdO + kTile * Ld<D>::kH;
  bf16* sV = sK + kTile * Ld<D>::kH;
  float* sS = reinterpret_cast<float*>(sV + kTile * Ld<D>::kH);
  float* sdP = sS + kTile * Ld<D>::kS;
  bf16* sdS = reinterpret_cast<bf16*>(sdP + kTile * Ld<D>::kS);
  float* sLse = reinterpret_cast<float*>(sdS + kTile * Ld<D>::kP);
  float* sDelta = sLse + kTile;
  int* sSegQ = reinterpret_cast<int*>(sDelta + kTile);
  int* sSegK = sSegQ + kTile;

  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int kvh = h / p.n_rep;
  const bool local = h >= p.n - p.num_local;
  const int q0 = qt * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<D>(sQ, p.q + bb * p.sq.b + q0 * p.sq.s + h * p.sq.h, p.sq.s);
  load_tile<D>(sdO, p.dout + bb * p.sdo.b + q0 * p.sdo.s + h * p.sdo.h, p.sdo.s);
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long idx = ((long long)bb * p.n + h) * p.s + q0 + i;
    sLse[i] = p.lse[idx];
    sDelta[i] = p.delta[idx];
    sSegQ[i] = p.seg[(long long)bb * p.s + q0 + i];
  }

  const bf16* q_strip = sQ + warp * kFrag * Ld<D>::kH;
  const bf16* do_strip = sdO + warp * kFrag * Ld<D>::kH;
  float* s_strip = sS + warp * kFrag * Ld<D>::kS;
  float* dp_strip = sdP + warp * kFrag * Ld<D>::kS;
  bf16* ds_strip = sdS + warp * kFrag * Ld<D>::kP;

  FragC dq[D / kFrag];
#pragma unroll
  for (int j = 0; j < D / kFrag; ++j) wmma::fill_fragment(dq[j], 0.0f);

  for (int kt = first_kv_tile(q0, local, p.window); kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's products are done with sK, sV
    load_tile<D>(sK, p.k + bb * p.sk.b + k0 * p.sk.s + kvh * p.sk.h, p.sk.s);
    load_tile<D>(sV, p.v + bb * p.sv.b + k0 * p.sv.s + kvh * p.sv.h, p.sv.s);
    for (int i = threadIdx.x; i < kTile; i += kThreads)
      sSegK[i] = p.seg[(long long)bb * p.s + k0 + i];
    __syncthreads();

    FragC acc[kTile / kFrag];
    strip_times_tile_t<D>(acc, q_strip, sK);
    store_scores<D>(s_strip, acc);
    strip_times_tile_t<D>(acc, do_strip, sV);
    store_scores<D>(dp_strip, acc);
    __syncwarp();
    for (int r = 0; r < kFrag; ++r) {
      const int row = warp * kFrag + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        const bool ok = allowed(q0 + row, k0 + col, sSegQ[row], sSegK[col], local, p.window);
        const float pr = ok ? expf(s_strip[r * Ld<D>::kS + col] - sLse[row]) : 0.0f;
        ds_strip[r * Ld<D>::kP + col] =
            __float2bfloat16(pr * (dp_strip[r * Ld<D>::kS + col] - sDelta[row]));
      }
    }
    __syncwarp();
    strip_times_tile<D>(dq, ds_strip, sK);
  }

  __syncthreads();
  float* stage = sS + warp * kFrag * Ld<D>::kO;
  store_acc<D>(stage, dq);
  __syncwarp();
  store_strip<D>(p.dq + bb * p.sdq.b + (long long)(q0 + warp * kFrag) * p.sdq.s + h * p.sdq.h,
                 p.sdq.s, stage, lane);
}

template <int D>
constexpr int dq_smem_bytes() {
  return 4 * kTile * Ld<D>::kH * 2 + 2 * kTile * Ld<D>::kS * 4 + kTile * Ld<D>::kP * 2 +
         4 * kTile * 4;
}

// The staged accumulators (kTile x Ld::kO floats) reuse the two f32 score tiles.
static_assert(kTile * Ld<128>::kO <= 2 * kTile * Ld<128>::kS, "staging does not fit");
static_assert(kTile * Ld<64>::kO <= 2 * kTile * Ld<64>::kS, "staging does not fit");

Strides strides_at(const long long* st, int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_fwd(const FwdParams& p, cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.s / kTile, p.n, p.b);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  const long long rows = (long long)p.b * p.s * p.n;
  flash_bwd_delta_kernel<D><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem_kv = bwd_smem_bytes<D>();
  if ((err = allow_smem(flash_bwd_dkdv_kernel<D>, smem_kv)) != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<D><<<dim3(p.s / kTile, p.n_kv, p.b), kThreads, smem_kv, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr int smem_q = dq_smem_bytes<D>();
  if ((err = allow_smem(flash_bwd_dq_kernel<D>, smem_q)) != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<dim3(p.s / kTile, p.n, p.b), kThreads, smem_q, stream>>>(p);
  return cudaGetLastError();
}

bool shape_ok(int head_dim, int b, int s, int n, int n_kv, int num_local, int window) {
  return (head_dim == 64 || head_dim == 128) && b > 0 && s > 0 && s % kTile == 0 && n_kv > 0 &&
         n % n_kv == 0 && num_local >= 0 && num_local <= n && window >= 0;
}

}  // namespace

extern "C" {

// strides: (batch, sequence, head) element strides of q, k, v, out. Returns a
// cudaError_t; 0 on a clean launch.
int flash_attention_fwd_launch(int head_dim, const void* q, const void* k, const void* v,
                               const void* seg, void* out, void* lse, int b, int s, int n,
                               int n_kv, const long long* strides, int num_local, int window,
                               void* stream) {
  if (!shape_ok(head_dim, b, s, n, n_kv, num_local, window))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.seg = static_cast<const int32_t*>(seg);
  p.o = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.so = strides_at(strides, 3);
  p.b = b, p.s = s, p.n = n, p.n_kv = n_kv, p.n_rep = n / n_kv;
  p.num_local = num_local, p.window = window;
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(head_dim == 128 ? launch_fwd<128>(p, st) : launch_fwd<64>(p, st));
}

// strides: (batch, sequence, head) element strides of q, k, v, out, dout,
// dq, dk, dv. delta is (b, n, s) f32 scratch. Returns a cudaError_t.
int flash_attention_bwd_launch(int head_dim, const void* q, const void* k, const void* v,
                               const void* seg, const void* out, const void* lse,
                               const void* dout, void* delta, void* dq, void* dk, void* dv,
                               int b, int s, int n, int n_kv, const long long* strides,
                               int num_local, int window, void* stream) {
  if (!shape_ok(head_dim, b, s, n, n_kv, num_local, window))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<const bf16*>(out);
  p.dout = static_cast<const bf16*>(dout);
  p.seg = static_cast<const int32_t*>(seg);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.sq = strides_at(strides, 0);
  p.sk = strides_at(strides, 1);
  p.sv = strides_at(strides, 2);
  p.so = strides_at(strides, 3);
  p.sdo = strides_at(strides, 4);
  p.sdq = strides_at(strides, 5);
  p.sdk = strides_at(strides, 6);
  p.sdv = strides_at(strides, 7);
  p.b = b, p.s = s, p.n = n, p.n_kv = n_kv, p.n_rep = n / n_kv;
  p.num_local = num_local, p.window = window;
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(head_dim == 128 ? launch_bwd<128>(p, st) : launch_bwd<64>(p, st));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
