// Paged attention over a block-paged KV pool (K1), for Hopper (sm_90a).
//
// Replaces the TPU kernel `paged_decode_attention` in
// scaling_tpu/nn/paged_attention.py (body `_paged_attention_kernel`).
// Same contract: query token i of a row sits at logical slot
// q_slot_base[row] + i; pool slot k of the row is visible iff
// k < valid_len[row] and k <= that slot. The row's slots live in pool
// blocks addressed through block_table[row, :] (max_blocks * block_size
// slots at most). GQA: query head hh reads kv head hh / n_rep. An int8
// pool carries per-slot-per-head f32 scales. A row with valid_len == 0
// gives zeros; query positions past a row's real tokens are computed like
// any other (the host discards them).
//
// What bounds it on an H100: bytes. Every visible K/V byte has to come
// from device memory once. The products (two of head_dim per visible slot
// and query vector) are far below the tensor cores' rate, but not below
// the CUDA cores': at a serving tick's shape (16 rows x 32 tokens x 16/4
// heads, d 128, contexts up to 2048) they are ~4.3 GFLOP, 5.6x the byte
// bound at the 67 TFLOP/s of f32 FMA. So they run on tensor cores.
//
// The design (bf16 q; bf16 or int8 pools):
//   * products on tensor cores by `wgmma.mma_async` m64nNk16, bf16 in, f32
//     accumulate, A (Q for Q.K^T, P for P.V) from registers and B (K
//     K-major, V MN-major through the transpose flag) from shared memory.
//     Not `mma.sync` with `ldmatrix`: there each of the 8 warps reads the
//     whole K/V tile from shared memory into its own registers (8 reads of
//     each byte a block), where a warpgroup's wgmma reads each B byte once
//     (2 a block) and needs fewer registers; a version with mma.sync was
//     ~10 % slower on the card (PERF.md);
//   * one block owns every query vector of a (row, kv head): 2 warpgroups x
//     64 vectors = 128 (a serving tick's 32 tokens x 4 query heads), so
//     each K/V byte is read from device memory once per row and kv head (a
//     third grid axis tiles wider groups; a warpgroup with no vector only
//     loads). Query vector i is (token i / n_rep, head kvh * n_rep +
//     i % n_rep). Q sits in registers as A fragments; scores, running max,
//     normaliser and the output accumulator are f32 in registers. The
//     online softmax runs there, rows reduced across the 4 threads that
//     share them by 2 shuffles, exp2 (ex2.approx) with sm_scale * log2(e)
//     folded into one multiply; P enters P.V as bf16 A fragments;
//   * KV tiles of 64 slots, gathered across pool blocks: each slot's row
//     comes from the row's table, staged in shared memory. Tiles arrive by
//     `cp.async` (16 bytes a thread, zero-filled past the row's context;
//     not TMA, whose boxes cannot follow a table) into a ring of 3 stages,
//     written in the 128-byte swizzle the wgmma descriptors read, so two
//     tiles load under the current one's products, with one block barrier
//     a tile;
//   * the context is split across SMs (flash-decoding): the grid's first
//     axis cuts the host-known window (max_blocks * block_size) into splits
//     of `split_slots` (512 from the launcher; 8 tiles); a split that starts
//     at or past valid_len exits at once. A row whose context fits in one
//     split writes its output directly. Otherwise each split writes f32
//     partials (max and normaliser a query vector, the unnormalised
//     accumulator), and a second kernel merges a row's splits by
//     log-sum-exp in split order: no atomics, so the output repeats
//     bitwise. A partial is 128 x (d + 2) x 4 bytes (66 KB at d 128)
//     against the 256 KB of bf16 K/V a full split reads;
//   * masks only where needed: a tile entirely below valid_len and at or
//     before every query's slot runs without them;
//   * int8 without an f32 window: the int8 tiles load as they are (half
//     the bytes) and are widened to bf16 in shared memory, exactly (|x| <=
//     127 fits bf16's significand); scale_k[slot] multiplies the score
//     column after Q.K^T, and scale_v[slot] is folded into P's column
//     before P.V, which is the JAX kernel's k * scale, v * scale with a
//     rounding only where P is rounded anyway.
// f32 q (the toy engine, f32 tests) keeps exact f32 products on CUDA
// cores in the first design's kernel (`paged_attention_exact_kernel`): one
// block per (row, kv head, 32 query vectors) walking the row's pool blocks,
// K/V staged in shared memory as f32, the next block prefetched into
// registers; it admits block_size * head_dim <= 4096.
//
// Still undone: a long row's splits run on few SMs (a 2048-slot row on
// 16 blocks), each walking its 8 tiles at a rate far under the SM's share
// of the card's bytes; ~200 registers a thread allow one block an SM; the
// block barrier each tile keeps both warpgroups in step (no producer
// warp, P.V not overlapped with the next Q.K^T); the widening of int8
// tiles costs a second barrier a tile; the split size is fixed, not
// fitted to the batch; and the merge is a second launch.
// Limits (the wrapper checks): head dim 64 or 128, 16-byte aligned pools.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpaged_attention.so paged_attention.cu
// Bound from Python through ctypes (scaling_tpu_torch/ops/paged_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

// ------------------------------------------------ tensor-core kernel (bf16 q)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;  // two warpgroups
constexpr int kQRows = 16 * kWarps;    // query vectors a block owns: 64 a warpgroup
constexpr int kKvTile = 64;            // slots a KV tile
constexpr int kStages = 3;             // tiles in the cp.async ring
constexpr int kMaxSplitSlots = 8192;
constexpr int kBlockBytes = kKvTile * 128;  // a swizzled (64 rows, 64 bf16 columns) block
constexpr float kLog2e = 1.4426950408889634f;

// shared memory (bytes from a 1024-aligned base): the bf16 tiles the
// products read come first (a bf16 pool loads straight into its ring of
// kStages K and V tiles; an int8 one widens into one K, V pair), then
// int8's ring as loaded with its scales, then the split's table
template <int H, bool QUANT>
struct Smem {
  static constexpr int kTileBytes = kKvTile * H * 2;                  // a bf16 (64, H) tile
  static constexpr int kRawBytes = QUANT ? kKvTile * H : kTileBytes;  // a tile as loaded
  static constexpr int kWide = 0;
  static constexpr int kK = QUANT ? 2 * kTileBytes : 0, kV = kK + kStages * kRawBytes;
  static constexpr int kScales = kV + kStages * kRawBytes;  // int8: a stage's 64 k, 64 v scales
  static constexpr int kTable = kScales + (QUANT ? kStages * 2 * kKvTile * 4 : 0);
  static constexpr int bytes(int split_slots) { return kTable + (split_slots + 2) * 4 + 1024; }
};

// byte offset of 16-byte chunk `chunk` of row `row` in a bf16 (64, H)
// tile, in the 128-byte swizzle the wgmma descriptors read: H / 64 column
// blocks of (64 rows, 128 bytes), chunk c of row r at c ^ (r % 8)
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (chunk >> 3) * kBlockBytes + row * 128 + (((chunk & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zeros where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's shared-memory writes, before a barrier, made visible to
// the products (wgmma reads through the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------ wgmma
// A shared-memory matrix descriptor for a 128-byte swizzled operand:
// start address, leading byte offset, stride byte offset 1024 (8 rows of
// 128 bytes), layout type 1 (128B swizzle)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
// K read K-major (Q.K^T contracts over a tile row's d columns): k-step ks
// is columns 16ks..16ks+15, 32 bytes into a column block's swizzle atom
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  return make_desc(tile + (ks / 4) * kBlockBytes + (ks % 4) * 32, 16);
}
// V read MN-major (P.V contracts over the tile's rows): k-step kk is rows
// 16kk..16kk+15; the column blocks of d sit kBlockBytes apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 16 * 128, kBlockBytes);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64) += A (64 x 16, bf16 fragments in registers) B (16 x 64 from
// shared memory; TRANS_B 0: K-major, 1: MN-major)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TRANS_B));
}

// d (64 x 128) += A (64 x 16, registers) B (16 x 128, shared memory, MN-major)
__device__ __forceinline__ void wgmma_n128_mn(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the special-function unit (2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 16 int8 -> 16 bf16, exactly and without conversion instructions: a byte
// b (offset by 128) becomes the f32 2^23 + b + 128, one subtraction gives
// b itself, and b's bf16 is the top half of that f32 (|b| <= 128 needs 8
// significant bits, which bf16 has)
__device__ __forceinline__ void widen16(const uint4& raw, uint4 (&dst)[2]) {
  const uint32_t* in = reinterpret_cast<const uint32_t*>(&raw);
  uint32_t* w = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = in[i] ^ 0x80808080u;  // two's complement -> offset binary
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + b)) - 8388736.0f;
    w[2 * i] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    w[2 * i + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  }
}

struct Params {
  const bf16* q;        // (rows, s, n, H)
  const void* pool_k;   // (num_blocks, bs, n_kv, H) bf16 or int8
  const void* pool_v;
  const float* scale_k;  // (num_blocks, bs, n_kv) or null
  const float* scale_v;
  const int32_t* table;        // (rows, max_blocks)
  const int32_t* valid_len;    // (rows,)
  const int32_t* q_slot_base;  // (rows,)
  bf16* out;                   // (rows, s, n, H)
  float* part_o;   // (units, kQRows, H): a split's unnormalised accumulator
  float* part_ml;  // (units, kQRows, 2): its running max (log2 units) and normaliser
  int s, n, n_kv, block_size, max_blocks, split_slots, n_splits;
  float scale_log2;  // sm_scale * log2(e)
};

// grid (n_splits, n_kv * q_tiles, rows). Unit ((row * n_kv + kvh) * q_tiles
// + qt) * n_splits + split owns the partials of one split. Element i of a
// thread's m64nN accumulator (S: N 64, O: N H) is row 16 (warp % 4) + g +
// 8 ((i >> 1) & 1) of its warpgroup's 64, column 8 (i >> 2) + c2 + (i & 1).
template <int H, bool QUANT>
__global__ void __launch_bounds__(kThreads, 1) paged_attention_mma_kernel(const Params p) {
  typedef Smem<H, QUANT> L;
  typedef typename std::conditional<QUANT, int8_t, bf16>::type TKV;
  constexpr int kChunks = H * static_cast<int>(sizeof(TKV)) / 16;  // 16-byte chunks a slot row
  constexpr int kRowsPerPass = kThreads / kChunks;
  static_assert(kThreads % kChunks == 0 && kKvTile % kRowsPerPass == 0, "tile shape");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base_addr = smem_addr(smem);
  int32_t* tab_s = reinterpret_cast<int32_t*>(smem + L::kTable);

  const int split = blockIdx.x, row = blockIdx.z;
  const int q_tiles = gridDim.y / p.n_kv;
  const int kvh = blockIdx.y / q_tiles, qt = blockIdx.y % q_tiles;
  const int n_rep = p.n / p.n_kv, q_total = p.s * n_rep;
  const int bs = p.block_size;
  const int window = p.max_blocks * bs;
  const int vl = min(p.valid_len[row], window);
  const int qbase = p.q_slot_base[row];
  const int s0 = split * p.split_slots;
  if (split > 0 && s0 >= vl) return;  // nothing of this row's context here
  const int s_end = min(vl, s0 + p.split_slots);
  const int n_tiles = s_end > s0 ? (s_end - s0 + kKvTile - 1) / kKvTile : 0;
  const int active = max(1, (vl + p.split_slots - 1) / p.split_slots);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the split's share of the row's table
  const int blk0 = s0 / bs;
  const int nblk = n_tiles ? (s_end - 1) / bs - blk0 + 1 : 0;
  for (int i = tid; i < nblk; i += kThreads)
    tab_s[i] = p.table[static_cast<size_t>(row) * p.max_blocks + blk0 + i];
  __syncthreads();

  const TKV* pool_k = static_cast<const TKV*>(p.pool_k);
  const TKV* pool_v = static_cast<const TKV*>(p.pool_v);
  // tile j of the split into stage st: thread tid copies chunk tid % kChunks
  // of rows tid / kChunks + kRowsPerPass * i
  auto load_tile = [&](int j, int st) {
    const int t0 = s0 + j * kKvTile, ch = tid % kChunks;
#pragma unroll
    for (int i = 0; i < kKvTile / kRowsPerPass; ++i) {
      const int r = tid / kChunks + i * kRowsPerPass, slot = t0 + r;
      const bool ok = slot < s_end;
      const size_t src =
          ok ? (static_cast<size_t>(tab_s[slot / bs - blk0]) * bs + slot % bs) * p.n_kv + kvh : 0;
      const uint32_t off = QUANT ? r * H + ch * 16 : swz(r, ch);
      cp_async16(base_addr + L::kK + st * L::kRawBytes + off, pool_k + src * H + ch * (16 / sizeof(TKV)), ok);
      cp_async16(base_addr + L::kV + st * L::kRawBytes + off, pool_v + src * H + ch * (16 / sizeof(TKV)), ok);
    }
    if (QUANT && tid < 2 * kKvTile) {  // the tile's scales: k then v
      const int r = tid % kKvTile, slot = t0 + r;
      const bool ok = slot < s_end;
      const size_t src =
          ok ? (static_cast<size_t>(tab_s[slot / bs - blk0]) * bs + slot % bs) * p.n_kv + kvh : 0;
      cp_async4(base_addr + L::kScales + (st * 2 * kKvTile + tid) * 4,
                (tid < kKvTile ? p.scale_k : p.scale_v) + src, ok);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  // this warp's 16 query vectors as A fragments: rows g and g + 8 of the
  // warp's strip, columns 16 ks + 2 (lane % 4) (+1, +8, +9)
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int wq0 = qt * kQRows + warp * 16;
  const bool wg_active = qt * kQRows + (warp / 4) * 64 < q_total;  // the warpgroup has rows
  int qvec[2], qslot[2];
  const bf16* qrow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qvec[h] = wq0 + g + 8 * h;
    const int t = qvec[h] / n_rep, rep = qvec[h] % n_rep;
    qslot[h] = qbase + t;
    qrow[h] = p.q + ((static_cast<size_t>(row) * p.s + t) * p.n + kvh * n_rep + rep) * H;
  }
  uint32_t qf[H / 16][4];
#pragma unroll
  for (int ks = 0; ks < H / 16; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e & 1, d = 16 * ks + c2 + 8 * (e >> 1);
      qf[ks][e] = qvec[h] < q_total ? *reinterpret_cast<const uint32_t*>(qrow[h] + d) : 0u;
    }

  float o[H / 2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of tile j have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have, and everyone is done with tile j - 1
    if (j + kStages - 1 < n_tiles) load_tile(j + kStages - 1, (j + kStages - 1) % kStages);
    cp_async_commit();
    uint32_t tile_k = base_addr + L::kK + st * L::kRawBytes;
    uint32_t tile_v = base_addr + L::kV + st * L::kRawBytes;
    const float* s_sc = reinterpret_cast<const float*>(smem + L::kScales) + st * 2 * kKvTile;
    if (QUANT) {  // widen the int8 tile pair to bf16, exactly
      for (int c = tid; c < 2 * kKvTile * (H / 16); c += kThreads) {
        const int which = c / (kKvTile * (H / 16)), cc = c % (kKvTile * (H / 16));
        const int r = cc / (H / 16), ch = cc % (H / 16);
        const unsigned char* raw = smem + (which ? L::kV : L::kK) + st * L::kRawBytes + r * H + ch * 16;
        uint4 wide[2];
        widen16(*reinterpret_cast<const uint4*>(raw), wide);
        unsigned char* dst = smem + L::kWide + which * L::kTileBytes;
        *reinterpret_cast<uint4*>(dst + swz(r, 2 * ch)) = wide[0];
        *reinterpret_cast<uint4*>(dst + swz(r, 2 * ch + 1)) = wide[1];
      }
      fence_proxy_async();
      __syncthreads();
      tile_k = base_addr + L::kWide;
      tile_v = base_addr + L::kWide + L::kTileBytes;
    }
    if (!wg_active) continue;  // no query vector in this warpgroup: it only loads

    // S = Q K^T over the tile's 64 slots, one m64n64 product a warpgroup
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < H / 16; ++ks) wgmma_n64<0>(sc, qf[ks], desc_k(tile_k, ks));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // to log2 units (times the slot's k scale); masks only where needed
    const int t0 = s0 + j * kKvTile;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float f0 = p.scale_log2, f1 = p.scale_log2;
      if (QUANT) {
        const float2 sk = *reinterpret_cast<const float2*>(s_sc + 8 * nt + c2);
        f0 *= sk.x;
        f1 *= sk.y;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[4 * nt + e] *= (e & 1) ? f1 : f0;
    }
    if (!(t0 + kKvTile <= vl && t0 + kKvTile - 1 <= qbase)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int slot = t0 + 8 * (i >> 2) + c2 + (i & 1);
        if (!(slot < vl && slot <= qslot[(i >> 1) & 1])) sc[i] = -INFINITY;
      }
    }

    // online softmax in registers; an all-masked row keeps m at -inf and
    // the safe shift keeps 2^(-inf - -inf) out
    float shift[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(sc[4 * nt + 2 * h], sc[4 * nt + 2 * h + 1]));
      mx = quad_max(mx);
      shift[h] = mx == -INFINITY ? 0.0f : mx;
      alpha[h] = exp2_approx(m[h] - shift[h]);
      m[h] = mx;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = exp2_approx(sc[i] - shift[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < H / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V: P (times the slot's v scale) as bf16 A fragments, 16 slots
    // a k-step; V read MN-major
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float v0 = 1.0f, v1 = 1.0f, v2 = 1.0f, v3 = 1.0f;
      if (QUANT) {
        const float2 a = *reinterpret_cast<const float2*>(s_sc + kKvTile + 16 * kk + c2);
        const float2 b = *reinterpret_cast<const float2*>(s_sc + kKvTile + 16 * kk + 8 + c2);
        v0 = a.x, v1 = a.y, v2 = b.x, v3 = b.y;
      }
      const float* x = sc + 8 * kk;
      pf[kk][0] = pack_bf16(x[0] * v0, x[1] * v1);
      pf[kk][1] = pack_bf16(x[2] * v0, x[3] * v1);
      pf[kk][2] = pack_bf16(x[4] * v2, x[5] * v3);
      pf[kk][3] = pack_bf16(x[6] * v2, x[7] * v3);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (H == 128)
        wgmma_n128_mn(o, pf[kk], desc_mn(tile_v, kk));
      else
        wgmma_n64<1>(o, pf[kk], desc_mn(tile_v, kk));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }
  cp_async_wait<0>();
  if (!wg_active) return;

#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
  if (active == 1) {  // the whole context was this split's: the output itself
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (qvec[h] >= q_total) continue;
      const float inv = l[h] == 0.0f ? 0.0f : 1.0f / l[h];  // nothing visible: zeros
      bf16* dst = p.out + (qrow[h] - p.q);
#pragma unroll
      for (int dt = 0; dt < H / 8; ++dt)
        *reinterpret_cast<uint32_t*>(dst + 8 * dt + c2) =
            pack_bf16(o[4 * dt + 2 * h] * inv, o[4 * dt + 2 * h + 1] * inv);
    }
    return;
  }
  const size_t unit = (static_cast<size_t>(row * p.n_kv + kvh) * q_tiles + qt) * p.n_splits + split;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qvec[h] >= q_total) continue;
    const size_t r = unit * kQRows + warp * 16 + g + 8 * h;
    float* dst = p.part_o + r * H;
#pragma unroll
    for (int dt = 0; dt < H / 8; ++dt)
      *reinterpret_cast<float2*>(dst + 8 * dt + c2) = make_float2(o[4 * dt + 2 * h], o[4 * dt + 2 * h + 1]);
    if (lane % 4 == 0) *reinterpret_cast<float2*>(p.part_ml + 2 * r) = make_float2(m[h], l[h]);
  }
}

// A row's splits merged by log-sum-exp, in split order: grid
// (q_rows / kWarps, n_kv * q_tiles, rows), a warp a query vector, 4
// columns a lane. Each pass over the splits issues its loads together, so
// a query vector costs two memory latencies, not two a split.
template <int H>
__global__ void __launch_bounds__(kThreads) paged_attention_merge_kernel(const Params p) {
  const int row = blockIdx.z;
  const int q_tiles = gridDim.y / p.n_kv;
  const int kvh = blockIdx.y / q_tiles, qt = blockIdx.y % q_tiles;
  const int vl = min(p.valid_len[row], p.max_blocks * p.block_size);
  const int active = (vl + p.split_slots - 1) / p.split_slots;
  const int n_rep = p.n / p.n_kv, q_total = p.s * n_rep;
  const int qr = blockIdx.x * kWarps + threadIdx.x / 32, d = 4 * (threadIdx.x % 32);
  // a row within one split was written by the split kernel itself
  if (active <= 1 || qr >= min(kQRows, q_total - qt * kQRows) || d >= H) return;
  const size_t r0 = (static_cast<size_t>(row * p.n_kv + kvh) * q_tiles + qt) * p.n_splits * kQRows + qr;
  float mx = -INFINITY;
#pragma unroll 4
  for (int i = 0; i < active; ++i) mx = fmaxf(mx, p.part_ml[2 * (r0 + static_cast<size_t>(i) * kQRows)]);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float denom = 0.0f;
  if (mx != -INFINITY) {  // else nothing was visible: zeros
#pragma unroll 4
    for (int i = 0; i < active; ++i) {
      const size_t r = r0 + static_cast<size_t>(i) * kQRows;
      const float2 ml = *reinterpret_cast<const float2*>(p.part_ml + 2 * r);
      const float4 v = *reinterpret_cast<const float4*>(p.part_o + r * H + d);
      const float w = exp2_approx(ml.x - mx);
      denom = fmaf(w, ml.y, denom);
      acc.x = fmaf(w, v.x, acc.x);
      acc.y = fmaf(w, v.y, acc.y);
      acc.z = fmaf(w, v.z, acc.z);
      acc.w = fmaf(w, v.w, acc.w);
    }
  }
  const float inv = denom == 0.0f ? 0.0f : 1.0f / denom;
  const int qv = qt * kQRows + qr, t = qv / n_rep, rep = qv % n_rep;
  bf16* dst = p.out + ((static_cast<size_t>(row) * p.s + t) * p.n + kvh * n_rep + rep) * H + d;
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(acc.x * inv, acc.y * inv), pack_bf16(acc.z * inv, acc.w * inv));
}

template <int H, bool QUANT>
cudaError_t launch_mma(const Params& p, int rows, cudaStream_t stream) {
  const int q_tiles = (p.s * (p.n / p.n_kv) + kQRows - 1) / kQRows;
  const int smem = Smem<H, QUANT>::bytes(p.split_slots);
  auto kernel = paged_attention_mma_kernel<H, QUANT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.n_splits, p.n_kv * q_tiles, rows), kThreads, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess || p.n_splits == 1) return err;
  paged_attention_merge_kernel<H><<<dim3(kQRows / kWarps, p.n_kv * q_tiles, rows), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------ exact f32 kernel (f32 q), CUDA cores
constexpr int kExactThreads = 256;
constexpr int kMaxQ = 32;   // query vectors (s * n_rep) per thread block
constexpr int kVec = 8;     // K/V elements one thread loads at once
constexpr int kChunks = 2;  // such loads a thread keeps in flight: block_size * H <= 4096
constexpr int kPad = 4;     // q/k row padding (floats): 16-byte rows, conflict-free float4 reads

// 8 consecutive elements of a pool row, loaded with one vector load
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
struct Vec8<int8_t> {
  uint2 raw;
  __device__ __forceinline__ void load(const int8_t* p) { raw = *reinterpret_cast<const uint2*>(p); }
  __device__ __forceinline__ float get(int e) const {
    return static_cast<float>(reinterpret_cast<const int8_t*>(&raw)[e]);
  }
};

template <int H>
__host__ __device__ constexpr size_t exact_smem_floats(int block_size, int max_blocks) {
  return static_cast<size_t>(kMaxQ) * (H + kPad)         // q tile
         + static_cast<size_t>(block_size) * (H + kPad)  // k tile
         + static_cast<size_t>(block_size) * H           // v tile
         + static_cast<size_t>(kMaxQ) * (block_size + 1)  // scores / probs
         + 3 * static_cast<size_t>(kMaxQ)                 // m, l, alpha
         + static_cast<size_t>(max_blocks);               // the row's block table
}

// one block per (row, kv head, tile of kMaxQ query vectors) walks the row's
// pool blocks up to its context; K/V staged in shared memory as f32 (int8
// dequantised on the way in), the next block prefetched into registers
template <typename TKV, bool QUANT, int H>
__global__ void __launch_bounds__(kExactThreads)
paged_attention_exact_kernel(const float* __restrict__ q,      // (rows, s, n, H)
                             const TKV* __restrict__ pool_k,   // (num_blocks, bs, n_kv, H)
                             const TKV* __restrict__ pool_v,
                             const float* __restrict__ scale_k,  // (num_blocks, bs, n_kv) or null
                             const float* __restrict__ scale_v,
                             const int32_t* __restrict__ table,        // (rows, max_blocks)
                             const int32_t* __restrict__ valid_len,    // (rows,)
                             const int32_t* __restrict__ q_slot_base,  // (rows,)
                             float* __restrict__ out,                  // (rows, s, n, H)
                             int s, int n, int n_kv, int block_size, int max_blocks,
                             float sm_scale) {
  constexpr int kLd = H + kPad;
  constexpr int kDq = 4;                               // head dims per thread in P.V
  constexpr int kColThreads = H / kDq;                 // threads across one V row
  constexpr int kLanes = kExactThreads / kColThreads;  // query lanes
  constexpr int kPerThread = kMaxQ / kLanes;           // query vectors per thread in P.V
  static_assert(kExactThreads % kColThreads == 0 && kMaxQ % kLanes == 0, "tile shape");
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
  for (int i = tid; i < q_count * H; i += kExactThreads) {
    const int qi = i / H, d = i % H;
    const int qg = q0 + qi;
    const int head = kvh * n_rep + qg % n_rep;
    qs[qi * kLd + d] = q[((static_cast<size_t>(row) * s + qg / n_rep) * n + head) * H + d];
  }
  for (int i = tid; i < kMaxQ; i += kExactThreads) {
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
  for (int i = tid; i < nblk; i += kExactThreads)
    tab_s[i] = table[static_cast<size_t>(row) * max_blocks + i];
  __syncthreads();

  Vec8<TKV> rk[kChunks], rv[kChunks];
  float rsk[kChunks], rsv[kChunks];
  auto fetch = [&](int j) {
    const size_t blk = static_cast<size_t>(tab_s[j]);
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int c = tid + ch * kExactThreads;
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
      const int c = tid + ch * kExactThreads;
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

    for (int pp = tid; pp < q_count * block_size; pp += kExactThreads) {
      const int qi = pp / block_size, t = pp % block_size;
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

    for (int qi = tid; qi < q_count; qi += kExactThreads) {
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

    float pv[kPerThread][kDq];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
#pragma unroll
      for (int e = 0; e < kDq; ++e) pv[i][e] = 0.f;
    for (int t = 0; t < block_size; ++t) {
      const float4 v = *reinterpret_cast<const float4*>(vs + t * H + d4);
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const float pr = ss[(lane_q + i * kLanes) * (block_size + 1) + t];
        pv[i][0] = fmaf(pr, v.x, pv[i][0]);
        pv[i][1] = fmaf(pr, v.y, pv[i][1]);
        pv[i][2] = fmaf(pr, v.z, pv[i][2]);
        pv[i][3] = fmaf(pr, v.w, pv[i][3]);
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

#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int qi = lane_q + i * kLanes;
    if (qi < q_count) {
      const float l = l_s[qi];
      const int qg = q0 + qi;
      const int head = kvh * n_rep + qg % n_rep;
      float* o = out + ((static_cast<size_t>(row) * s + qg / n_rep) * n + head) * H + d4;
#pragma unroll
      for (int e = 0; e < kDq; ++e) o[e] = acc[i][e] / (l == 0.f ? 1.f : l);
    }
  }
}

template <typename TKV, bool QUANT, int H>
cudaError_t launch_exact(const Params& p, const float* q, float* out, int rows, float sm_scale,
                         cudaStream_t stream) {
  auto kernel = paged_attention_exact_kernel<TKV, QUANT, H>;
  const size_t smem = exact_smem_floats<H>(p.block_size, p.max_blocks) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int q_total = p.s * (p.n / p.n_kv);
  const dim3 grid(rows, p.n_kv, (q_total + kMaxQ - 1) / kMaxQ);
  kernel<<<grid, kExactThreads, smem, stream>>>(
      q, static_cast<const TKV*>(p.pool_k), static_cast<const TKV*>(p.pool_v), p.scale_k,
      p.scale_v, p.table, p.valid_len, p.q_slot_base, out, p.s, p.n, p.n_kv, p.block_size,
      p.max_blocks, sm_scale);
  return cudaGetLastError();
}

template <int H>
cudaError_t dispatch(int dtype, bool quantized, const Params& p, const void* q, void* out,
                     int rows, float sm_scale, cudaStream_t stream) {
  if (dtype == 1) return quantized ? launch_mma<H, true>(p, rows, stream) : launch_mma<H, false>(p, rows, stream);
  if (p.block_size * H > kExactThreads * kVec * kChunks) return cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  float* of = static_cast<float*>(out);
  return quantized ? launch_exact<int8_t, true, H>(p, qf, of, rows, sm_scale, stream)
                   : launch_exact<float, false, H>(p, qf, of, rows, sm_scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (q, out and a native pool; the exact kernel), 1 =
// bfloat16 (the tensor-core kernel). part_o / part_ml: the bf16 kernel's
// f32 partials, (rows * n_kv * q_tiles * n_splits, 128, head_dim) and
// (..., 128, 2); null when n_splits == 1. Returns a cudaError_t; 0 on a
// clean launch.
int paged_attention_launch(int dtype, int quantized, int head_dim,
                           const void* q, const void* pool_k, const void* pool_v,
                           const void* scale_k, const void* scale_v,
                           const void* table, const void* valid_len,
                           const void* q_slot_base, void* out, void* part_o, void* part_ml,
                           int rows, int s, int n, int n_kv, int block_size, int max_blocks,
                           int split_slots, int n_splits, float sm_scale, void* stream) {
  if (rows <= 0 || s <= 0 || n_kv <= 0 || n % n_kv != 0 || block_size <= 0 ||
      max_blocks <= 0 || (dtype != 0 && dtype != 1) || (head_dim != 64 && head_dim != 128) ||
      split_slots <= 0 || split_slots % kKvTile != 0 || split_slots > kMaxSplitSlots ||
      n_splits != (max_blocks * block_size + split_slots - 1) / split_slots ||
      (dtype == 1 && n_splits > 1 && (part_o == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.pool_k = pool_k;
  p.pool_v = pool_v;
  p.scale_k = static_cast<const float*>(scale_k);
  p.scale_v = static_cast<const float*>(scale_v);
  p.table = static_cast<const int32_t*>(table);
  p.valid_len = static_cast<const int32_t*>(valid_len);
  p.q_slot_base = static_cast<const int32_t*>(q_slot_base);
  p.out = static_cast<bf16*>(out);
  p.part_o = static_cast<float*>(part_o);
  p.part_ml = static_cast<float*>(part_ml);
  p.s = s, p.n = n, p.n_kv = n_kv, p.block_size = block_size, p.max_blocks = max_blocks;
  p.split_slots = split_slots, p.n_splits = n_splits;
  p.scale_log2 = sm_scale * kLog2e;
  const bool quant = quantized != 0;
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = head_dim == 128 ? dispatch<128>(dtype, quant, p, q, out, rows, sm_scale, st)
                                          : dispatch<64>(dtype, quant, p, q, out, rows, sm_scale, st);
  return static_cast<int>(err);
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
