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
// of products for 50 MB of operands, far right of the card's ridge (~295
// FLOP a byte): 0.069 ms at 989 TFLOP/s. Only `wgmma` reaches that rate.
//
// The layout (FA3's, without its warp specialisation):
//   * one warpgroup (4 warps, 128 threads) per block owns a 64-row tile;
//     every product is a `wgmma.mma_async` m64nNk16, bf16 in, f32
//     accumulate, issued by the whole warpgroup. 64 rows, not FA3's 128 in
//     two warpgroups: each block then owns whole rows and whole tiles, any
//     s % 64 == 0 needs no ragged-tile masks, and two blocks share an SM
//     (registers and shared memory allow two), which hides one block's
//     softmax behind the other's products;
//   * tiles live in shared memory in the 128-byte swizzled layout that
//     `wgmma` reads through matrix descriptors: a (64, d) bf16 tile is d/64
//     column blocks of (64 rows, 128 bytes); row r's 16-byte chunk c sits at
//     chunk c ^ (r % 8). Q K^T-type products read both operands K-major; the
//     P V-type products read their B operand (V, dO, Q or K, rows along the
//     contraction) MN-major through the transpose flag;
//   * the tiles arrive by TMA (`cp.async.bulk.tensor`), which writes that
//     swizzled layout itself: the launcher encodes a tensor map of each
//     (b, s, heads, d) operand through its strides, thread 0 issues a tile's
//     copies, and the warpgroup waits on an mbarrier. Tiles go into rings of
//     2 stages, so the next tiles are in flight while the products of the
//     current ones run; the per-tile lse, D and segment ids come the same
//     way (`cp.async.bulk`);
//   * the score accumulator S stays in registers. The online softmax runs
//     there: a row's max and sum across the 4 threads that share it (2
//     shuffles each), O rescaled in its registers, P converted to bf16
//     straight into the A-operand fragment layout (the m64nN accumulator's
//     layout is the k16 A fragment's, 16 columns at a time), and P V issued
//     with A from registers. No score, probability or output tile touches
//     shared memory;
//   * inside the forward's warpgroup, P_{j-1} V_{j-1} runs while the
//     softmax of S_j is computed (FA3's intra-warpgroup overlap); in the
//     backward, dP (or dP^T) runs while P is exponentiated;
//   * masks only where needed: a tile whose rows all lie below the
//     diagonal, inside the window and in one segment skips the element
//     masks (a block-wide vote on the segment ids rides on the barrier each
//     tile needs anyway). Causal and window skipping at tile granularity:
//     a query tile walks kv tiles only from the window's first tile to the
//     diagonal; the heavy tiles are launched first;
//   * the backward is FA2's split, which keeps the gradients deterministic:
//     a pass for D = rowsum(dO * O); a dK/dV kernel with one block per
//     (batch, kv head, 64-row kv tile) that walks the group's n_rep query
//     heads and the query tiles on or after the diagonal, with dK and dV
//     accumulating in registers over the whole walk (S^T = K Q^T and
//     dP^T = V dO^T by wgmma, P^T and dS^T formed in registers and fed as A
//     operands to dV += P^T dO and dK += dS^T Q); and a dQ kernel with one
//     block per (batch, query head, query tile) that recomputes S and dP
//     (dQ += dS K). Every output element is written by one block in a fixed
//     order: no atomics, bitwise repeats. The price: the dQ kernel repeats
//     two products, so the backward does 7 products where the bound counts
//     5, and its best is ~1.4x the bound.
// P and dS enter their products as bf16 (FA2 and FA3 do the same); the
// exponentials use the special-function unit's ex2.approx, and the element
// masks run only on the tiles that need them, without branches.
//
// Still undone: a producer warp with `setmaxnreg` (thread 0 of the
// consumer warpgroup issues the copies between its products), FA3's
// ping-pong between two warpgroups of a block, issuing S_{j+1} ahead of the
// softmax of S_j (it needs a third K stage), 128-row kv tiles (wider, more
// efficient products), a persistent scheduler, and causal load balancing
// beyond launching the heavy tiles first. At d 128 the dK/dV kernel's dK,
// dV, S^T and dP^T fill nearly all of the 255 registers a thread may have:
// any of these that costs registers there has to find them first.
// Limits (the wrapper checks): bf16, head dim 64 or 128, s % 64 == 0,
// unit last stride, strides multiples of 8 elements (16 bytes, as TMA
// needs), 16-byte aligned bases.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// Bound from Python through ctypes (scaling_tpu_torch/ops/flash_attention.py).

#include <cuda.h>  // CUtensorMap; the driver's encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;      // rows of every tile: a warpgroup's wgmma M
constexpr int kThreads = 128;  // one warpgroup a block
constexpr int kBlockBytes = kTile * 128;  // one swizzled (64, 64) bf16 column block
constexpr float kLog2e = 1.4426950408889634f;

// strides (elements) of one (b, s, heads, d) tensor: batch, sequence, head
struct Strides {
  long long b, s, h;
};

struct FwdParams {
  CUtensorMap tq, tk, tv;  // TMA maps of q, k, v: (64 columns, 1 head, kTile rows) boxes
  const bf16 *q, *k, *v;
  const int32_t* seg;  // (b, s)
  bf16* o;
  float* lse;  // (b, n, s)
  Strides sq, sk, sv, so;
  int b, s, n, n_kv, n_rep, num_local, window;
};

struct BwdParams {
  CUtensorMap tq, tk, tv, tdo;  // TMA maps of q, k, v, dout
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
  return (ki <= qi) & (seg_q == seg_k) & (!local | (qi - ki <= window));  // no branches
}

// ------------------------------------------------ asynchronous tile loads
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies by the tensor memory accelerator (TMA), completing on mbarriers.
// Two barriers take turns: copy group g completes on barrier g % 2, in that
// barrier's phase (g / 2) % 2. Thread 0 arms a group (the bytes it brings)
// and issues its copies; every thread waits for it before reading.
struct CopyGroups {
  uint32_t bar;  // barrier 0; barrier 1 is the next 8 bytes

  __device__ uint32_t at(int g) const { return bar + 8 * (g & 1); }

  __device__ void init() const {  // thread 0, before a block barrier
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar + 8 * i) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  __device__ void arm(int g, uint32_t bytes) const {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(at(g)), "r"(bytes)
                 : "memory");
  }

  // then, before the block barrier that releases the stages the next
  // copies overwrite, order this thread's reads of them before those copies
  __device__ void wait(int g) const {
    asm volatile(
        "{\n.reg .pred done;\nLAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra LAB_WAIT;\n}\n" ::"r"(at(g)),
        "r"((g >> 1) & 1)
        : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
};

// a (kTile, D) bf16 tile, rows row.. of head `head` in batch `batch`, into
// the 128-byte swizzled layout at dst: one box a 64-column block
template <int D>
__device__ __forceinline__ void copy_tile(uint32_t dst, const CUtensorMap& map, int head, int row,
                                          int batch, uint32_t bar) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst + cb * kBlockBytes),
        "l"(reinterpret_cast<uint64_t>(&map)), "r"(cb * 64), "r"(head), "r"(row), "r"(batch), "r"(bar)
        : "memory");
}

// kTile 32-bit words (lse, D or segment ids of a tile)
constexpr int kWordsBytes = kTile * 4;
__device__ __forceinline__ void copy_words(uint32_t dst, const void* src, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(kWordsBytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------------ wgmma
// A shared-memory matrix descriptor for a 128-byte swizzled operand:
// start address, leading byte offset, stride byte offset 1024 (8 rows of
// 128 bytes), layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// K-major operand (the contraction runs along a tile's d columns): k-step
// ks is columns 16ks..16ks+15, 32 bytes into a column block's swizzle atom
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  return make_desc(tile + (ks / 4) * kBlockBytes + (ks % 4) * 32, 16);
}

// MN-major operand (the contraction runs along a tile's rows): k-step ks
// is rows 16ks..16ks+15; the column blocks of d sit kBlockBytes apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int ks) {
  return make_desc(tile + ks * 16 * 128, kBlockBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N of this warpgroup's committed product groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The three wgmma shapes the kernels use, bf16 in, f32 accumulate. ss: A
// and B from shared memory, both K-major; scale_d 0 overwrites the
// accumulator, 1 adds to it. rs: A from registers, B from shared memory
// MN-major (the transpose flag), adding to the accumulator.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128_mn(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The products are issued as one committed group each and run while the
// warpgroup goes on; the caller waits (wgmma_wait) before it reads the
// accumulator, then fences it (fence_regs). P's fragments stay untouched
// until their product has been waited for.

// issue acc (64 x 64) = A B^T, A and B (64, D) tiles read K-major
template <int D>
__device__ __forceinline__ void issue_abt(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;  // a fresh live range each tile
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) wgmma_ss_n64(acc, desc_k(a, ks), desc_k(b, ks), ks > 0);
  wgmma_commit();
}

// issue acc (64 x D) += P B, P (64 x 64) bf16 A fragments in registers, B
// a (64, D) tile read MN-major
template <int D>
__device__ __forceinline__ void issue_pb(float (&acc)[D / 2], const uint32_t (&p)[4][4],
                                         uint32_t b) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if constexpr (D == 128)
      wgmma_rs_n128_mn(acc, p[ks], desc_mn(b, ks));
    else
      wgmma_rs_n64_mn(acc, p[ks], desc_mn(b, ks));
  }
  wgmma_commit();
}

// Element i of a thread's m64nN accumulator: row (of the 64) and column.
// Thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 and 8
// more; columns 8j + 2 (t % 4) and the next, for j < N / 8.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * (threadIdx.x / 32) + (threadIdx.x % 32) / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) { return 8 * (i >> 2) + 2 * (threadIdx.x % 4) + (i & 1); }

// a per-column vector's values at a thread's columns 8j + 2 (t % 4) and the
// next (accumulator elements 4j..4j+3), in one shared-memory load
template <typename T2, typename T>
__device__ __forceinline__ T2 col_pair(const T* v, int j) {
  return *reinterpret_cast<const T2*>(v + acc_col(4 * j));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a (64 x 64) f32 accumulator as bf16 A fragments of 4 k-steps: the k16 A
// fragment of columns 16kk.. is accumulator elements 8kk..8kk+7 in order
__device__ __forceinline__ void to_frags(const float (&x)[32], uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) f[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// a thread's rows of a (64 x D) accumulator, times scale[row half], as bf16
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, long long row_stride,
                                          const float (&acc)[D / 2], const float (&scale)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const float sc = scale[(i >> 1) & 1];
    *reinterpret_cast<uint32_t*>(dst + acc_row(i) * row_stride + acc_col(i)) =
        pack_bf16(acc[i] * sc, acc[i + 1] * sc);
  }
}

// 2^x by the special-function unit (ex2.approx; denormal results flush to
// 0, 2^-inf = 0), without exp2f's slower exact path
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

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// first kv tile a query tile starting at q0 can see (local heads start late)
__device__ __forceinline__ int first_kv_tile(int q0, bool local, int window) {
  if (!local || q0 - window <= 0) return 0;
  return (q0 - window) / kTile;
}

// every element of the tile pair is allowed: below the diagonal, inside
// the window, one segment (the caller's vote)
__device__ __forceinline__ bool tile_unmasked(bool one_segment, int q0, int k0, bool local,
                                              int window) {
  return one_segment && k0 + kTile - 1 <= q0 && (!local || q0 + kTile - 1 - k0 <= window);
}

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return kTile * D * 2;
}

// ---------------------------------------------------------------- forward
// shared memory (bytes from a 1024-aligned base): Q, K[2], V[2], seg_k[2],
// the copy barriers
template <int D>
struct FwdSmem {
  static constexpr int kQ = 0, kK = tile_bytes<D>(), kV = 3 * tile_bytes<D>();
  static constexpr int kSegK = 5 * tile_bytes<D>(), kBar = kSegK + 2 * kWordsBytes;
  static constexpr int kBytes = kBar + 16 + 1024;  // + alignment slack
};

// grid (s / kTile, n, b): query tile qt = the heavy tiles first.
// Step j of the walk issues S_j = Q K_j^T and, behind it, O += P_{j-1} V_{j-1},
// then runs the softmax of S_j while that product is in flight (FA3's
// intra-warpgroup overlap); O is rescaled once the product is in. K_{j+1}
// and V_j load during step j, into the stages S_{j-1} and P_{j-2} V_{j-2}
// have released.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  typedef FwdSmem<D> L;
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  const int* s_segk = reinterpret_cast<const int*>(smem + L::kSegK);
  const CopyGroups groups{base + L::kBar};
  if (threadIdx.x == 0) groups.init();

  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int kvh = h / p.n_rep;
  const bool local = h >= p.n - p.num_local;
  const int q0 = qt * kTile, tid = threadIdx.x;
  const int32_t* seg = p.seg + static_cast<long long>(bb) * p.s;
  const int seg_row[2] = {seg[q0 + acc_row(0)], seg[q0 + acc_row(2)]};
  const int seg_first = seg[q0];
  const bool q_one_segment = __syncthreads_and(tid >= kTile || seg[q0 + tid] == seg_first);

  auto copy_k = [&](int kt, int st, int g) {  // K and its segment ids (thread 0)
    copy_tile<D>(base + L::kK + st * tile_bytes<D>(), p.tk, kvh, kt * kTile, bb, groups.at(g));
    copy_words(base + L::kSegK + st * kWordsBytes, seg + kt * kTile, groups.at(g));
  };
  auto tile_v = [&](int st) { return base + L::kV + st * tile_bytes<D>(); };
  const int kt_begin = first_kv_tile(q0, local, p.window), steps = qt - kt_begin + 1;
  if (tid == 0) {  // group 0: Q, K_0
    groups.arm(0, 2 * tile_bytes<D>() + kWordsBytes);
    copy_tile<D>(base + L::kQ, p.tq, h, q0, bb, groups.at(0));
    copy_k(kt_begin, 0, 0);
  }

  float o[D / 2], s[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, alpha[2];
  uint32_t pf[4][4];  // P_{j-1}: A fragments, untouched while its product runs

  // Group j (K_j, V_{j-1}) has landed, and every thread is done with S_{j-1}
  // and P_{j-2} V_{j-2}, whose stages group j + 1 (K_{j+1}, V_j) reuses.
  // Returns whether tile j's kv rows are in q's one segment.
  auto begin_step = [&](int j) {
    const int kt = kt_begin + j, st = j & 1;
    groups.wait(j);
    const bool one = __syncthreads_and(tid >= kTile || s_segk[st * kTile + tid] == seg_first);
    if (tid == 0) {
      const bool more = j + 1 < steps;
      groups.arm(j + 1, (more ? tile_bytes<D>() + kWordsBytes : 0) + tile_bytes<D>());
      if (more) copy_k(kt + 1, st ^ 1, j + 1);
      copy_tile<D>(tile_v(st), p.tv, kvh, kt * kTile, bb, groups.at(j + 1));
    }
    return one && q_one_segment;
  };
  // mask, online max and exponentials of S_j in s; l and m updated, O's
  // rescale factor in alpha
  auto softmax = [&](int j, bool one_segment) {
    const int k0 = (kt_begin + j) * kTile;
    const int* segk = s_segk + (j & 1) * kTile;
    if (!tile_unmasked(one_segment, q0, k0, local, p.window)) {
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int2 seg_col = col_pair<int2>(segk, g);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * g + e;
          if (!allowed(q0 + acc_row(i), k0 + acc_col(i), seg_row[e >> 1],
                       e & 1 ? seg_col.y : seg_col.x, local, p.window))
            s[i] = -INFINITY;
        }
      }
    }
    float mx[2] = {m[0], m[1]}, shift[2];  // shift: the max in log2 units
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      shift[r] = mx[r] == -INFINITY ? 0.0f : mx[r] * kLog2e;
      alpha[r] = exp2_approx(m[r] * kLog2e - shift[r]);
      l[r] *= alpha[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2_approx(fmaf(s[i], kLog2e, -shift[(i >> 1) & 1]));
      l[(i >> 1) & 1] += s[i];
    }
  };

  bool one_segment = begin_step(0);
  issue_abt<D>(s, base + L::kQ, base + L::kK);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0, one_segment);
  to_frags(s, pf);
  for (int j = 1; j < steps; ++j) {
    const int st = j & 1;
    one_segment = begin_step(j);
    issue_abt<D>(s, base + L::kQ, base + L::kK + st * tile_bytes<D>());
    issue_pb<D>(o, pf, tile_v(st ^ 1));
    wgmma_wait<1>();  // S_j is in; P_{j-1} V_{j-1} runs on under the softmax
    fence_regs(s);
    softmax(j, one_segment);
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    to_frags(s, pf);
  }
  groups.wait(steps);  // the last V
  issue_pb<D>(o, pf, tile_v((steps - 1) & 1));
  wgmma_wait<0>();
  fence_regs(o);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);  // the diagonal is always allowed: l > 0
    inv[r] = 1.0f / l[r];
  }
  store_acc<D>(p.o + bb * p.so.b + static_cast<long long>(q0) * p.so.s + h * p.so.h, p.so.s, o, inv);
  if (tid % 4 == 0) {
    float* lse = p.lse + (static_cast<long long>(bb) * p.n + h) * p.s + q0;
    lse[acc_row(0)] = m[0] + logf(l[0]);
    lse[acc_row(2)] = m[1] + logf(l[1]);
  }
}

// ---------------------------------------------------------------- backward
// D = rowsum(dO * O) in f32: one warp per (batch, position, head) row.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta_kernel(BwdParams p) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(p.b) * p.s * p.n) return;
  const int h = row % p.n;
  const long long t = row / p.n;
  const int qi = t % p.s, bb = t / p.s;
  const bf16* o = p.o + bb * p.so.b + static_cast<long long>(qi) * p.so.s + h * p.so.h;
  const bf16* d = p.dout + bb * p.sdo.b + static_cast<long long>(qi) * p.sdo.s + h * p.sdo.h;
  float acc = 0.0f;
  for (int c = lane; c < D; c += 32) acc += __bfloat162float(o[c]) * __bfloat162float(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[(static_cast<long long>(bb) * p.n + h) * p.s + qi] = acc;
}

// shared memory: K, V, then 2 stages of Q, dO, lse, D and seg_q; the copy
// barriers
template <int D>
struct DkdvSmem {
  static constexpr int kK = 0, kV = tile_bytes<D>(), kQ = 2 * tile_bytes<D>();
  static constexpr int kDo = 4 * tile_bytes<D>(), kLse = 6 * tile_bytes<D>();
  static constexpr int kDelta = kLse + 2 * kWordsBytes, kSegQ = kDelta + 2 * kWordsBytes;
  static constexpr int kBar = kSegQ + 2 * kWordsBytes, kBytes = kBar + 16 + 1024;
};

// dK, dV of one 64-row kv tile of one kv head: grid (s / kTile, n_kv, b),
// the heavy (early) kv tiles first. Rows are kv positions, columns query
// positions: S^T = K Q^T, dP^T = V dO^T, P^T = exp(S^T - lse),
// dS^T = P^T (dP^T - D), dV += P^T dO, dK += dS^T Q, for every query head
// of the group and every query tile on or after the diagonal.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  typedef DkdvSmem<D> L;
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  const CopyGroups groups{base + L::kBar};
  if (threadIdx.x == 0) groups.init();

  const int kt = blockIdx.x, kvh = blockIdx.y, bb = blockIdx.z;
  const int k0 = kt * kTile, n_tiles = p.s / kTile, tid = threadIdx.x;
  const int32_t* seg = p.seg + static_cast<long long>(bb) * p.s;
  const int seg_row[2] = {seg[k0 + acc_row(0)], seg[k0 + acc_row(2)]};
  const int seg_first = seg[k0];
  const bool k_one_segment = __syncthreads_and(tid >= kTile || seg[k0 + tid] == seg_first);

  // the walk: query heads kvh * n_rep + rep, and for each its query tiles
  // from the diagonal to the last one the window lets see this kv tile
  auto last_q_tile = [&](int rep) {
    const bool local = kvh * p.n_rep + rep >= p.n - p.num_local;
    return local ? min(n_tiles - 1, (k0 + kTile - 1 + p.window) / kTile) : n_tiles - 1;
  };
  constexpr uint32_t kStepBytes = 2 * tile_bytes<D>() + 3 * kWordsBytes;
  auto issue = [&](int rep, int qt, int st, int g) {  // thread 0
    const int h = kvh * p.n_rep + rep, q0 = qt * kTile;
    const long long row = (static_cast<long long>(bb) * p.n + h) * p.s + q0;
    const uint32_t bar = groups.at(g);
    copy_tile<D>(base + L::kQ + st * tile_bytes<D>(), p.tq, h, q0, bb, bar);
    copy_tile<D>(base + L::kDo + st * tile_bytes<D>(), p.tdo, h, q0, bb, bar);
    copy_words(base + L::kLse + st * kWordsBytes, p.lse + row, bar);
    copy_words(base + L::kDelta + st * kWordsBytes, p.delta + row, bar);
    copy_words(base + L::kSegQ + st * kWordsBytes, seg + q0, bar);
  };
  if (tid == 0) {  // group 0: K, V and the first query tile
    groups.arm(0, 2 * tile_bytes<D>() + kStepBytes);
    copy_tile<D>(base + L::kK, p.tk, kvh, k0, bb, groups.at(0));
    copy_tile<D>(base + L::kV, p.tv, kvh, k0, bb, groups.at(0));
    issue(0, kt, 0, 0);
  }

  float dk[D / 2], dv[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;

  int rep = 0, qt = kt, st = 0;
  for (int step = 0; rep < p.n_rep; ++step) {
    int next_rep = rep, next_qt = qt + 1;
    if (next_qt > last_q_tile(rep)) ++next_rep, next_qt = kt;
    const float* s_lse = reinterpret_cast<const float*>(smem + L::kLse) + st * kTile;
    const float* s_delta = reinterpret_cast<const float*>(smem + L::kDelta) + st * kTile;
    const int* s_segq = reinterpret_cast<const int*>(smem + L::kSegQ) + st * kTile;
    groups.wait(step);
    const bool one_segment = __syncthreads_and(tid >= kTile || s_segq[tid] == seg_first) && k_one_segment;
    if (tid == 0 && next_rep < p.n_rep) {
      groups.arm(step + 1, kStepBytes);
      issue(next_rep, next_qt, st ^ 1, step + 1);
    }
    const bool local = kvh * p.n_rep + rep >= p.n - p.num_local;
    const int q0 = qt * kTile;
    const uint32_t tile_q = base + L::kQ + st * tile_bytes<D>();
    const uint32_t tile_do = base + L::kDo + st * tile_bytes<D>();

    issue_abt<D>(s, base + L::kK, tile_q);
    issue_abt<D>(dp, base + L::kV, tile_do);
    wgmma_wait<1>();  // S^T is in; dP^T runs on under the exponentials
    fence_regs(s);
    const bool unmasked = tile_unmasked(one_segment, q0, k0, local, p.window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lse = col_pair<float2>(s_lse, j);
      const float lse2[2] = {lse.x * kLog2e, lse.y * kLog2e};
#pragma unroll
      for (int e = 0; e < 4; ++e) s[4 * j + e] = exp2_approx(fmaf(s[4 * j + e], kLog2e, -lse2[e & 1]));
    }
    if (!unmasked) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int2 seg_col = col_pair<int2>(s_segq, j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          if (!allowed(q0 + acc_col(i), k0 + acc_row(i), e & 1 ? seg_col.y : seg_col.x,
                       seg_row[e >> 1], local, p.window))
            s[i] = 0.0f;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 delta = col_pair<float2>(s_delta, j);
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - (e & 1 ? delta.y : delta.x));
    }
    uint32_t fp[4][4], fds[4][4];
    to_frags(s, fp);
    to_frags(dp, fds);
    issue_pb<D>(dv, fp, tile_do);
    issue_pb<D>(dk, fds, tile_q);
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    rep = next_rep, qt = next_qt, st ^= 1;
  }

  const float one[2] = {1.0f, 1.0f};
  store_acc<D>(p.dk + bb * p.sdk.b + static_cast<long long>(k0) * p.sdk.s + kvh * p.sdk.h, p.sdk.s, dk, one);
  store_acc<D>(p.dv + bb * p.sdv.b + static_cast<long long>(k0) * p.sdv.s + kvh * p.sdv.h, p.sdv.s, dv, one);
}

// shared memory: Q, dO, then 2 stages of K, V and seg_k; the copy barriers
template <int D>
struct DqSmem {
  static constexpr int kQ = 0, kDo = tile_bytes<D>(), kK = 2 * tile_bytes<D>();
  static constexpr int kV = 4 * tile_bytes<D>(), kSegK = 6 * tile_bytes<D>();
  static constexpr int kBar = kSegK + 2 * kWordsBytes, kBytes = kBar + 16 + 1024;
};

// dQ of one 64-row query tile of one query head: grid (s / kTile, n, b).
// S = Q K^T, dP = dO V^T, P = exp(S - lse), dS = P (dP - D), dQ += dS K
// over the kv tiles up to the diagonal.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  typedef DqSmem<D> L;
  unsigned char* smem = align_1024(smem_raw);
  const uint32_t base = smem_addr(smem);
  const int* s_segk = reinterpret_cast<const int*>(smem + L::kSegK);
  const CopyGroups groups{base + L::kBar};
  if (threadIdx.x == 0) groups.init();

  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int kvh = h / p.n_rep;
  const bool local = h >= p.n - p.num_local;
  const int q0 = qt * kTile, tid = threadIdx.x;
  const int32_t* seg = p.seg + static_cast<long long>(bb) * p.s;
  const int seg_row[2] = {seg[q0 + acc_row(0)], seg[q0 + acc_row(2)]};
  const int seg_first = seg[q0];
  const bool q_one_segment = __syncthreads_and(tid >= kTile || seg[q0 + tid] == seg_first);
  const long long row = (static_cast<long long>(bb) * p.n + h) * p.s + q0;
  const float lse2[2] = {p.lse[row + acc_row(0)] * kLog2e, p.lse[row + acc_row(2)] * kLog2e};
  const float delta[2] = {p.delta[row + acc_row(0)], p.delta[row + acc_row(2)]};

  constexpr uint32_t kStepBytes = 2 * tile_bytes<D>() + kWordsBytes;
  auto issue = [&](int kt, int st, int g) {  // thread 0
    const uint32_t bar = groups.at(g);
    copy_tile<D>(base + L::kK + st * tile_bytes<D>(), p.tk, kvh, kt * kTile, bb, bar);
    copy_tile<D>(base + L::kV + st * tile_bytes<D>(), p.tv, kvh, kt * kTile, bb, bar);
    copy_words(base + L::kSegK + st * kWordsBytes, seg + kt * kTile, bar);
  };
  const int kt_begin = first_kv_tile(q0, local, p.window);
  if (tid == 0) {  // group 0: Q, dO and the first kv tile
    groups.arm(0, 2 * tile_bytes<D>() + kStepBytes);
    copy_tile<D>(base + L::kQ, p.tq, h, q0, bb, groups.at(0));
    copy_tile<D>(base + L::kDo, p.tdo, h, q0, bb, groups.at(0));
    issue(kt_begin, 0, 0);
  }

  float dq[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;

  for (int kt = kt_begin; kt <= qt; ++kt) {
    const int st = (kt - kt_begin) & 1;
    const int* segk = s_segk + st * kTile;
    groups.wait(kt - kt_begin);
    const bool one_segment = __syncthreads_and(tid >= kTile || segk[tid] == seg_first) && q_one_segment;
    if (tid == 0 && kt < qt) {
      groups.arm(kt - kt_begin + 1, kStepBytes);
      issue(kt + 1, st ^ 1, kt - kt_begin + 1);
    }
    const int k0 = kt * kTile;
    const uint32_t tile_k = base + L::kK + st * tile_bytes<D>();

    issue_abt<D>(s, base + L::kQ, tile_k);
    issue_abt<D>(dp, base + L::kDo, base + L::kV + st * tile_bytes<D>());
    wgmma_wait<1>();  // S is in; dP runs on under the exponentials
    fence_regs(s);
    const bool unmasked = tile_unmasked(one_segment, q0, k0, local, p.window);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = exp2_approx(fmaf(s[i], kLog2e, -lse2[(i >> 1) & 1]));
    if (!unmasked) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int2 seg_col = col_pair<int2>(segk, j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          if (!allowed(q0 + acc_row(i), k0 + acc_col(i), seg_row[e >> 1],
                       e & 1 ? seg_col.y : seg_col.x, local, p.window))
            s[i] = 0.0f;
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - delta[(i >> 1) & 1]);
    uint32_t f[4][4];
    to_frags(dp, f);
    issue_pb<D>(dq, f, tile_k);
    wgmma_wait<0>();
    fence_regs(dq);
  }

  const float one[2] = {1.0f, 1.0f};
  store_acc<D>(p.dq + bb * p.sdq.b + static_cast<long long>(q0) * p.sdq.s + h * p.sdq.h, p.sdq.s, dq, one);
}

Strides strides_at(const long long* st, int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the driver the runtime has loaded (nothing links
// against libcuda); null where the driver has none
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &entry, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(entry)
               : nullptr;
  }();
  return fn;
}

// the TMA map of a (b, s, heads, d) bf16 tensor read through its strides
// (multiples of 16 bytes, the wrapper checks): boxes of (64 columns, 1 head,
// kTile rows, 1 batch), 128-byte swizzled as the wgmma descriptors expect
cudaError_t tile_map(CUtensorMap* map, const void* data, int d, int heads, int s, int b,
                     const Strides& st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(heads), cuuint64_t(s), cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(st.h) * 2, cuuint64_t(st.s) * 2, cuuint64_t(st.b) * 2};
  const cuuint32_t box[4] = {64, 1, kTile, 1}, unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(data), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_fwd(FwdParams& p, cudaStream_t stream) {
  constexpr int smem = FwdSmem<D>::kBytes;
  cudaError_t err;
  if ((err = tile_map(&p.tq, p.q, D, p.n, p.s, p.b, p.sq)) != cudaSuccess ||
      (err = tile_map(&p.tk, p.k, D, p.n_kv, p.s, p.b, p.sk)) != cudaSuccess ||
      (err = tile_map(&p.tv, p.v, D, p.n_kv, p.s, p.b, p.sv)) != cudaSuccess ||
      (err = allow_smem(flash_fwd_kernel<D>, smem)) != cudaSuccess)
    return err;
  flash_fwd_kernel<D><<<dim3(p.s / kTile, p.n, p.b), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(BwdParams& p, cudaStream_t stream) {
  cudaError_t err;
  if ((err = tile_map(&p.tq, p.q, D, p.n, p.s, p.b, p.sq)) != cudaSuccess ||
      (err = tile_map(&p.tk, p.k, D, p.n_kv, p.s, p.b, p.sk)) != cudaSuccess ||
      (err = tile_map(&p.tv, p.v, D, p.n_kv, p.s, p.b, p.sv)) != cudaSuccess ||
      (err = tile_map(&p.tdo, p.dout, D, p.n, p.s, p.b, p.sdo)) != cudaSuccess)
    return err;
  const long long rows = static_cast<long long>(p.b) * p.s * p.n;
  constexpr int kWarps = kThreads / 32;
  flash_bwd_delta_kernel<D><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kThreads, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr int smem_kv = DkdvSmem<D>::kBytes;
  if ((err = allow_smem(flash_bwd_dkdv_kernel<D>, smem_kv)) != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<D><<<dim3(p.s / kTile, p.n_kv, p.b), kThreads, smem_kv, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  constexpr int smem_q = DqSmem<D>::kBytes;
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

// dynamic shared memory (bytes) of kernel 0 (forward), 1 (dK/dV) or 2 (dQ)
// at head_dim; -1 for anything else
int flash_attention_smem_bytes(int head_dim, int kernel) {
  if (head_dim != 64 && head_dim != 128) return -1;
  const bool wide = head_dim == 128;
  switch (kernel) {
    case 0: return wide ? FwdSmem<128>::kBytes : FwdSmem<64>::kBytes;
    case 1: return wide ? DkdvSmem<128>::kBytes : DkdvSmem<64>::kBytes;
    case 2: return wide ? DqSmem<128>::kBytes : DqSmem<64>::kBytes;
    default: return -1;
  }
}

}  // extern "C"
