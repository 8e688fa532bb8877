// Paged attention over a block-paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_attention` in
// scaling_tpu/nn/paged_attention.py (body `_paged_attention_kernel`).
// Same contract: query token i of a row sits at logical slot
// q_slot_base[row] + i; pool slot k of the row is visible iff
// k < valid_len[row] and k <= that slot. The row's slots live in pool
// blocks addressed through block_table[row, :]. GQA: query head hh reads
// kv head hh / n_rep. The int8 pool is dequantised in shared memory with
// the per-slot-per-head scales the pool writer produced.
//
// What bounds it on an H100: bytes. Every visible K/V byte must come from
// device memory once; the arithmetic (two dot products per visible slot
// and query head) is far below the tensor cores' rate. So the design
// reads each K/V byte once per row:
//   * one thread block per (row, kv head, tile of kMaxQ = 32 query
//     vectors): the query heads that share a kv head share its K/V loads,
//     and the tiles of one (row, kv head) run side by side, so a K/V
//     block comes from device memory once and from L2 for the other
//     tiles (a mixed tick's 32 tokens x 4 query heads per kv head make 4
//     tiles, which spreads a row's work over 4 SMs);
//   * the block walks only j < ceil(valid_len / block_size): pool blocks
//     past the row's context are never loaded (the TPU grid DMAs them and
//     skips the FLOPs);
//   * K/V tiles are staged in shared memory as f32 (int8 dequantised on
//     the way in); the next pool block's K/V is loaded into registers
//     while the current one is computed, so its latency is hidden;
//   * the dot products read q and K rows as float4 and P.V gives each
//     thread 4 head dims of several queries, so shared memory serves one
//     vector load per 4-16 FMAs; running max, normaliser and accumulator
//     are f32 (accumulator in registers).
// A row with valid_len == 0 writes zeros: the same safe shift and l == 0
// guard as the TPU kernel. Query positions past a row's real tokens are
// computed like any other; the host discards them.
//
// Still a simple version: CUDA cores only, no wgmma, no TMA, no split
// over the KV axis (a long row is walked by one block per query tile).
// Limits: head dim 64 or 128, block_size * head_dim <= 4096, 16-byte
// aligned tensors (the wrapper checks).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpaged_attention.so paged_attention.cu
// Bound from Python through ctypes (scaling_tpu_torch/ops/paged_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 32;   // query vectors (s * n_rep) per thread block
constexpr int kVec = 8;     // K/V elements one thread loads at once
constexpr int kChunks = 2;  // such loads a thread keeps in flight: block_size * H <= 4096
constexpr int kPad = 4;     // q/k row padding (floats): 16-byte rows, conflict-free float4 reads

// 8 consecutive elements of a pool or q row, loaded with one vector load
template <typename T>
struct Vec8;

template <>
struct Vec8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ float get(int e) const { return e < 4 ? (&a.x)[e] : (&b.x)[e - 4]; }
};

template <>
struct Vec8<__nv_bfloat16> {
  uint4 raw;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    raw = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float get(int e) const {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&raw)[e]);
  }
};

template <>
struct Vec8<int8_t> {
  uint2 raw;
  __device__ __forceinline__ void load(const int8_t* p) { raw = *reinterpret_cast<const uint2*>(p); }
  __device__ __forceinline__ float get(int e) const {
    return static_cast<float>(reinterpret_cast<const int8_t*>(&raw)[e]);
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int H>
__host__ __device__ constexpr size_t smem_floats(int block_size, int max_blocks) {
  return static_cast<size_t>(kMaxQ) * (H + kPad)         // q tile
         + static_cast<size_t>(block_size) * (H + kPad)  // k tile
         + static_cast<size_t>(block_size) * H           // v tile
         + static_cast<size_t>(kMaxQ) * (block_size + 1)  // scores / probs
         + 3 * static_cast<size_t>(kMaxQ)                 // m, l, alpha
         + static_cast<size_t>(max_blocks);               // the row's block table
}

template <typename TQ, typename TKV, bool QUANT, int H>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q,          // (rows, s, n, H)
                       const TKV* __restrict__ pool_k,    // (num_blocks, bs, n_kv, H)
                       const TKV* __restrict__ pool_v,
                       const float* __restrict__ scale_k,  // (num_blocks, bs, n_kv) or null
                       const float* __restrict__ scale_v,
                       const int32_t* __restrict__ table,        // (rows, max_blocks)
                       const int32_t* __restrict__ valid_len,    // (rows,)
                       const int32_t* __restrict__ q_slot_base,  // (rows,)
                       TQ* __restrict__ out,                     // (rows, s, n, H)
                       int s, int n, int n_kv, int block_size, int max_blocks,
                       float sm_scale) {
  constexpr int kLd = H + kPad;
  constexpr int kDq = 4;                          // head dims per thread in P.V
  constexpr int kColThreads = H / kDq;            // threads across one V row
  constexpr int kLanes = kThreads / kColThreads;  // query lanes
  constexpr int kPerThread = kMaxQ / kLanes;      // query vectors per thread in P.V
  static_assert(kThreads % kColThreads == 0 && kMaxQ % kLanes == 0, "tile shape");
  static_assert(H % kVec == 0 && H % 4 == 0, "head dim");

  const int n_rep = n / n_kv;
  const int row = blockIdx.x;
  const int kvh = blockIdx.y;
  const int q0 = blockIdx.z * kMaxQ;
  const int q_count = min(kMaxQ, s * n_rep - q0);
  const int tid = threadIdx.x;
  const int d4 = (tid % kColThreads) * kDq;
  const int lane_q = tid / kColThreads;
  const int n_chunks = block_size * (H / kVec);

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);    // [kMaxQ][kLd]
  float* ks = qs + kMaxQ * kLd;                   // [block_size][kLd]
  float* vs = ks + block_size * kLd;              // [block_size][H]
  float* ss = vs + block_size * H;                // [kMaxQ][block_size + 1]
  float* m_s = ss + kMaxQ * (block_size + 1);     // running max
  float* l_s = m_s + kMaxQ;                       // normaliser
  float* a_s = l_s + kMaxQ;                       // this block's rescale
  int32_t* tab_s = reinterpret_cast<int32_t*>(a_s + kMaxQ);  // the row's table

  // query vector qi of the tile is (token qg / n_rep, head kvh * n_rep + qg % n_rep)
  for (int i = tid; i < q_count * H; i += kThreads) {
    const int qi = i / H, d = i % H;
    const int qg = q0 + qi;
    const int head = kvh * n_rep + qg % n_rep;
    qs[qi * kLd + d] =
        to_f32(q[((static_cast<size_t>(row) * s + qg / n_rep) * n + head) * H + d]);
  }
  for (int i = tid; i < kMaxQ; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }

  float acc[kPerThread][kDq];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i)
#pragma unroll
    for (int e = 0; e < kDq; ++e) acc[i][e] = 0.f;

  const int vlen = valid_len[row];
  const int base = q_slot_base[row];
  int nblk = vlen > 0 ? (vlen + block_size - 1) / block_size : 0;
  if (nblk > max_blocks) nblk = max_blocks;
  // the row's table once into shared memory: the walk then needs no
  // dependent device-memory read before each pool block
  for (int i = tid; i < nblk; i += kThreads)
    tab_s[i] = table[static_cast<size_t>(row) * max_blocks + i];
  __syncthreads();

  // the next pool block's K/V (and scales) ride in registers while the
  // current one is computed, so its device-memory latency is hidden
  Vec8<TKV> rk[kChunks], rv[kChunks];
  float rsk[kChunks], rsv[kChunks];
  auto fetch = [&](int j) {
    const size_t blk = static_cast<size_t>(tab_s[j]);
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int c = tid + ch * kThreads;
      if (c < n_chunks) {
        const int t = c / (H / kVec), d0 = (c % (H / kVec)) * kVec;
        const size_t slot = (blk * block_size + t) * n_kv + kvh;
        rk[ch].load(pool_k + slot * H + d0);
        rv[ch].load(pool_v + slot * H + d0);
        if (QUANT) {
          rsk[ch] = scale_k[slot];
          rsv[ch] = scale_v[slot];
        }
      }
    }
  };
  if (nblk > 0) fetch(0);
  __syncthreads();

  for (int j = 0; j < nblk; ++j) {
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int c = tid + ch * kThreads;
      if (c < n_chunks) {
        const int t = c / (H / kVec), d0 = (c % (H / kVec)) * kVec;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          ks[t * kLd + d0 + e] = QUANT ? rk[ch].get(e) * rsk[ch] : rk[ch].get(e);
          vs[t * H + d0 + e] = QUANT ? rv[ch].get(e) * rsv[ch] : rv[ch].get(e);
        }
      }
    }
    __syncthreads();
    if (j + 1 < nblk) fetch(j + 1);

    // scores: masked entries are -inf
    for (int p = tid; p < q_count * block_size; p += kThreads) {
      const int qi = p / block_size, t = p % block_size;
      const int slot = j * block_size + t;
      const int q_slot = base + (q0 + qi) / n_rep;
      float sc = -INFINITY;
      if (slot < vlen && slot <= q_slot) {
        const float4* qr = reinterpret_cast<const float4*>(qs + qi * kLd);
        const float4* kr = reinterpret_cast<const float4*>(ks + t * kLd);
        float sx = 0.f, sy = 0.f, sz = 0.f, sw = 0.f;
#pragma unroll 8
        for (int d = 0; d < H / 4; ++d) {
          const float4 a = qr[d], b = kr[d];
          sx = fmaf(a.x, b.x, sx);
          sy = fmaf(a.y, b.y, sy);
          sz = fmaf(a.z, b.z, sz);
          sw = fmaf(a.w, b.w, sw);
        }
        sc = ((sx + sy) + (sz + sw)) * sm_scale;
      }
      ss[qi * (block_size + 1) + t] = sc;
    }
    __syncthreads();

    // online softmax; an all-masked block keeps m at -inf and the safe
    // shift avoids exp(-inf - -inf)
    for (int qi = tid; qi < q_count; qi += kThreads) {
      float* sr = ss + qi * (block_size + 1);
      float mx = -INFINITY;
      for (int t = 0; t < block_size; ++t) mx = fmaxf(mx, sr[t]);
      const float m_old = m_s[qi];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      float sum = 0.f;
      for (int t = 0; t < block_size; ++t) {
        const float pv = expf(sr[t] - m_safe);  // masked: exp(-inf) = 0
        sr[t] = pv;
        sum += pv;
      }
      const float alpha = (m_old == -INFINITY) ? 0.f : expf(m_old - m_safe);
      l_s[qi] = alpha * l_s[qi] + sum;
      a_s[qi] = alpha;
      m_s[qi] = m_new;
    }
    __syncthreads();

    // P.V: each thread owns kDq consecutive head dims of kPerThread queries
    float pv[kPerThread][kDq];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
#pragma unroll
      for (int e = 0; e < kDq; ++e) pv[i][e] = 0.f;
    for (int t = 0; t < block_size; ++t) {
      const float4 v = *reinterpret_cast<const float4*>(vs + t * H + d4);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const float p = ss[(lane_q + i * kLanes) * (block_size + 1) + t];
        pv[i][0] = fmaf(p, v.x, pv[i][0]);
        pv[i][1] = fmaf(p, v.y, pv[i][1]);
        pv[i][2] = fmaf(p, v.z, pv[i][2]);
        pv[i][3] = fmaf(p, v.w, pv[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int qi = lane_q + i * kLanes;
      if (qi < q_count) {
        const float a = a_s[qi];
#pragma unroll
        for (int e = 0; e < kDq; ++e) acc[i][e] = a * acc[i][e] + pv[i][e];
      }
    }
    __syncthreads();
  }

  // rows with no visible slot emit zeros, not nan
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int qi = lane_q + i * kLanes;
    if (qi < q_count) {
      const float l = l_s[qi];
      const int qg = q0 + qi;
      const int head = kvh * n_rep + qg % n_rep;
      TQ* o = out + ((static_cast<size_t>(row) * s + qg / n_rep) * n + head) * H + d4;
#pragma unroll
      for (int e = 0; e < kDq; ++e) store_out(o + e, acc[i][e] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename TQ, typename TKV, bool QUANT, int H>
cudaError_t launch(const void* q, const void* pool_k, const void* pool_v,
                   const float* scale_k, const float* scale_v,
                   const int32_t* table, const int32_t* valid_len,
                   const int32_t* q_slot_base, void* out, int rows, int s, int n,
                   int n_kv, int block_size, int max_blocks, float sm_scale,
                   cudaStream_t stream) {
  auto kernel = paged_attention_kernel<TQ, TKV, QUANT, H>;
  const size_t smem = smem_floats<H>(block_size, max_blocks) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int q_total = s * (n / n_kv);
  const dim3 grid(rows, n_kv, (q_total + kMaxQ - 1) / kMaxQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(pool_k),
      static_cast<const TKV*>(pool_v), scale_k, scale_v, table, valid_len,
      q_slot_base, static_cast<TQ*>(out), s, n, n_kv, block_size, max_blocks,
      sm_scale);
  return cudaGetLastError();
}

template <int H>
cudaError_t dispatch_dtype(int dtype, int quantized, const void* q,
                           const void* pool_k, const void* pool_v,
                           const float* scale_k, const float* scale_v,
                           const int32_t* table, const int32_t* valid_len,
                           const int32_t* q_slot_base, void* out, int rows, int s,
                           int n, int n_kv, int block_size, int max_blocks,
                           float sm_scale, cudaStream_t stream) {
#define PA_ARGS q, pool_k, pool_v, scale_k, scale_v, table, valid_len, q_slot_base, \
                out, rows, s, n, n_kv, block_size, max_blocks, sm_scale, stream
  if (dtype == 0 && !quantized) return launch<float, float, false, H>(PA_ARGS);
  if (dtype == 0 && quantized) return launch<float, int8_t, true, H>(PA_ARGS);
  if (dtype == 1 && !quantized) return launch<__nv_bfloat16, __nv_bfloat16, false, H>(PA_ARGS);
  if (dtype == 1 && quantized) return launch<__nv_bfloat16, int8_t, true, H>(PA_ARGS);
#undef PA_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, out and a native pool share it).
// Returns a cudaError_t; 0 on a clean launch.
int paged_attention_launch(int dtype, int quantized, int head_dim,
                           const void* q, const void* pool_k, const void* pool_v,
                           const void* scale_k, const void* scale_v,
                           const void* table, const void* valid_len,
                           const void* q_slot_base, void* out, int rows, int s,
                           int n, int n_kv, int block_size, int max_blocks,
                           float sm_scale, void* stream) {
  if (rows <= 0 || s <= 0 || n_kv <= 0 || n % n_kv != 0 || block_size <= 0 ||
      max_blocks <= 0 || block_size * head_dim > kThreads * kVec * kChunks)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* sk = static_cast<const float*>(scale_k);
  const auto* sv = static_cast<const float*>(scale_v);
  const auto* tab = static_cast<const int32_t*>(table);
  const auto* vl = static_cast<const int32_t*>(valid_len);
  const auto* qb = static_cast<const int32_t*>(q_slot_base);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim == 128)
    err = dispatch_dtype<128>(dtype, quantized, q, pool_k, pool_v, sk, sv, tab, vl, qb,
                              out, rows, s, n, n_kv, block_size, max_blocks, sm_scale, st);
  else if (head_dim == 64)
    err = dispatch_dtype<64>(dtype, quantized, q, pool_k, pool_v, sk, sv, tab, vl, qb,
                             out, rows, s, n, n_kv, block_size, max_blocks, sm_scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
