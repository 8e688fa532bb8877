// RMSNorm backward (K3), for Hopper (sm_90a).
//
// Replaces the TPU kernel of `rms_norm_fused`'s backward in
// scaling_tpu/ops/rms_norm.py (`_rms_bwd`, Pallas body `_bwd_kernel`).
// Same function, with r = rsqrt(mean(x^2) + eps) recomputed and gw = g * w:
//
//     dx = r * gw - x * r^3 * mean(gw * x)     in x's dtype
//     dw = sum over rows of g * x * r          summed in f32, written in w's dtype
//
// over rows of width d (a multiple of 128); x, g and w each f32, bf16 or
// f16.
//
// What bounds it on an H100: bytes. x and g are read once and dx written
// once (at (8192, 2048) bf16, 100.7 MB: 0.0301 ms at 3.35 TB/s); the
// arithmetic is ~12 instructions an element. So the design keeps bytes in
// flight on every SM and keeps the lanes' arithmetic off the critical path:
//   * a persistent grid: one block of 8 warps an SM (`plan_bwd` in
//     ops/rms_norm.py picks grid and shapes), each block one contiguous
//     band of rows;
//   * a ring of `stages` stages in shared memory (~128 KB), each
//     `rows_per_stage` whole rows of x and g (at most 64 KB), filled by two
//     bulk asynchronous copies a stage (`cp.async.bulk`, 1-D TMA: the rows
//     of a band are contiguous) that complete on the stage's mbarrier.
//     Thread 0 starts the first stages before anything else; after that the
//     last warp done with a stage (a counter in shared memory) refills it,
//     so no warp waits on another and no warp is spent on the copies;
//   * a row belongs to `warps_per_row` warps (1 up to d = 2048 in bf16),
//     each owning a fixed slice of columns, 8 elements a lane a chunk and at
//     most 256 bytes of x and g a lane. A lane issues the shared-memory loads
//     of half its chunks (a quarter beside dw's registers; x, g and w, which
//     waits in shared memory as f32) before it uses any, keeps 8 partial sums for each of the two row sums
//     (x^2 and gw * x), and reduces them by shuffles; only a row shared by
//     several warps meets a named barrier of those warps. The second pass
//     loads the row again from shared memory, writes dx with 16-byte stores
//     and adds g * x * r into the lane's f32 registers: a lane keeps its
//     columns' dw over the whole band (255 registers with dw, no spills);
//   * dw: the block adds its warps' registers once (through the drained
//     ring) into one f32 row of partials (132 x 2048 x 4 B = 1.1 MB at the
//     training rows). Each block then takes an atomic ticket after a
//     __threadfence; the last `finishers` to arrive (grid / 2, at most 64)
//     wait for the others, each adds every block's row over its slice of the
//     columns in a fixed order, and writes dw. No atomics on values, so dw
//     repeats bitwise; the last finisher puts the tickets back to 0, so the
//     next launch needs no memset.
//   * rows that do not fit the ring (more than 64 KB of x and g: d > 16384
//     in bf16) take a chunked walk along d in the same kernel: the whole
//     block on one row, a first pass of 16-byte loads from device memory
//     that reduces, a block barrier, a second pass that reads the row again
//     (from L2) and writes dx; dw accumulates in the block's own f32 row of
//     partials.
// `dx_only` (a frozen gain) drops the dw registers, the partials and the
// finish.
//
// What still holds it back (PERF.md §6): the lanes' arithmetic of each
// band's last stage, which no later rows hide, and the finish (a fence, the
// ticket, the wait, one round trip to L2) after the last block's rows.
//
// Launch: 256 threads. The wrapper (`_launch_bwd`) allocates dx, dw, the
// partials and, once per device and stream, the zeroed tickets.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librms_norm_bwd.so rms_norm_bwd.cu

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kConsumerWarps = 8;    // warps that take rows (all of the block)
constexpr int kThreads = kConsumerWarps * 32;
constexpr int kSliceBytes = 8192;   // most bytes of x and g a warp takes of a row (256 a lane)
constexpr int kMaxStages = 8;
constexpr int kMaxFinishers = 64;
constexpr int kHeaderBytes = 1024;  // mbarriers and the row sums, before the ring
constexpr int kStaticBytes = 6144;  // the static arrays (finish_dw, wide_rows)
constexpr int kSmemLimit = 232448 - kStaticBytes;  // 227 KB a block can use

// dtype codes of the C interface
enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <int Code> struct Elem;
template <> struct Elem<kF32> { using T = float; };
template <> struct Elem<kBF16> { using T = __nv_bfloat16; };
template <> struct Elem<kF16> { using T = __half; };

// ---------------------------------------------------- 8 elements <-> f32
__device__ __forceinline__ void to_f32(const uint4& u, const __nv_bfloat16*, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x, f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void to_f32(const uint4& u, const __half*, float* f) {
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __half22float2(h[i]);
    f[2 * i] = v.x, f[2 * i + 1] = v.y;
  }
}

// 8 consecutive elements at p (16-byte aligned) as f32
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* f) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  } else {
    to_f32(*reinterpret_cast<const uint4*>(p), p, f);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float* f) {
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  } else {
    uint4 u;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    } else {
      __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// a lane's 8 elements of a row as raw 16-byte words: 1 of a 16-bit type, 2 of f32
template <typename T> constexpr int kWords = sizeof(T) / 2;

// ceil(32 / (bytes of an x and a g element)): the most 8-element chunks a
// lane takes of a row, at kSliceBytes a warp
template <typename TX, typename TG>
constexpr int kChunks = (32 + sizeof(TX) + sizeof(TG) - 1) / (sizeof(TX) + sizeof(TG));

template <typename T>
__device__ __forceinline__ void lds_chunk(uint32_t addr, uint4 (&v)[kWords<T>]) {
#pragma unroll
  for (int i = 0; i < kWords<T>; ++i)
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v[i].x), "=r"(v[i].y), "=r"(v[i].z), "=r"(v[i].w)
                 : "r"(addr + 16 * i));
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4 (&v)[kWords<T>], float* f) {
  if constexpr (sizeof(T) == 4) {
    f[0] = __uint_as_float(v[0].x), f[1] = __uint_as_float(v[0].y);
    f[2] = __uint_as_float(v[0].z), f[3] = __uint_as_float(v[0].w);
    f[4] = __uint_as_float(v[1].x), f[5] = __uint_as_float(v[1].y);
    f[6] = __uint_as_float(v[1].z), f[7] = __uint_as_float(v[1].w);
  } else {
    to_f32(v[0], static_cast<const T*>(nullptr), f);
  }
}

__device__ __forceinline__ float4 add4(float4 a, const float4& b) {
  a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
  return a;
}

// one element of w or dw, whose dtype is a launch argument
__device__ __forceinline__ float load_scalar(const void* p, int dtype, size_t i) {
  if (dtype == kF32) return static_cast<const float*>(p)[i];
  if (dtype == kBF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return __half2float(static_cast<const __half*>(p)[i]);
}
__device__ __forceinline__ void store_scalar(void* p, int dtype, size_t i, float v) {
  if (dtype == kF32) static_cast<float*>(p)[i] = v;
  else if (dtype == kBF16) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else static_cast<__half*>(p)[i] = __float2half_rn(v);
}

// --------------------------------------------------------- mbarriers, TMA
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arm(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// the warps of one row (ids 1..4; 0 is __syncthreads)
__device__ __forceinline__ void row_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Params {
  const void* x;
  const void* w;
  const void* g;
  void* dx;
  void* dw;
  float* part;        // (grid, d) f32: each block's column sums
  int* tickets;       // 2 counters (blocks arrived, finishers done), zero between launches
  long long n;
  int d;
  float eps;
  int w_dtype;
  int rows_per_stage, warps_per_row, stages;  // stages 0: the chunked walk
  int finishers;                              // blocks that add the partials
};

// ------------------------------------------------------------ the finish
// After every thread of the block stored its share of part[block]: each
// block takes a ticket; the last `finishers` to arrive wait until every
// block has (they wait only on blocks that hold or will get an SM: at most
// finishers - 1 are still out, and the grid is at least 2 * finishers - 1),
// then each adds the rows of part over its slice of the columns, in a fixed
// order (row group by row group, then the groups in order), and writes dw.
// The last finisher puts both tickets back to 0.
__device__ void finish_dw(const Params& p) {
  __shared__ int ticket;
  __shared__ float4 red[kThreads];
  const int grid = gridDim.x, fin = p.finishers;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(&p.tickets[0], 1);
  __syncthreads();
  const int f = ticket - (grid - fin);
  if (f < 0) return;
  if (threadIdx.x == 0) {
    int seen;
    do {
      asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(seen) : "l"(p.tickets) : "memory");
      if (seen < grid) __nanosleep(64);
    } while (seen < grid);
  }
  __syncthreads();
  __threadfence();
  const int c4 = p.d / 4, lo = c4 * f / fin, hi = c4 * (f + 1) / fin;
  const int width = min(hi - lo, kThreads), groups = kThreads / width;
  const int col = threadIdx.x % width, rg = threadIdx.x / width;
  const float4* part = reinterpret_cast<const float4*>(p.part);
  for (int c0 = lo; c0 < hi; c0 += width) {
    const int c = c0 + col;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rg < groups && c < hi) {
      for (int b0 = rg; b0 < grid; b0 += 16 * groups) {  // 16 loads in flight
        float4 v[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (b0 + i * groups < grid) v[i] = __ldcg(part + static_cast<size_t>(b0 + i * groups) * c4 + c);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (b0 + i * groups < grid) s = add4(s, v[i]);
      }
    }
    red[threadIdx.x] = s;
    __syncthreads();
    if (rg == 0 && c < hi) {
      float4 t = red[col];
      for (int i = 1; i < groups; ++i) t = add4(t, red[i * width + col]);
      store_scalar(p.dw, p.w_dtype, 4 * c, t.x), store_scalar(p.dw, p.w_dtype, 4 * c + 1, t.y);
      store_scalar(p.dw, p.w_dtype, 4 * c + 2, t.z), store_scalar(p.dw, p.w_dtype, 4 * c + 3, t.w);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0 && atomicAdd(&p.tickets[1], 1) == fin - 1) p.tickets[0] = 0, p.tickets[1] = 0;
}

// ---------------------------------------------------- rows through the ring
// 8 elements of w at column col as f32 (w's dtype a launch argument; w 16-byte aligned)
__device__ __forceinline__ void load_w8(const void* w, int dtype, int col, float* f) {
  if (dtype == kF32) load8(static_cast<const float*>(w) + col, f);
  else if (dtype == kBF16) load8(static_cast<const __nv_bfloat16*>(w) + col, f);
  else load8(static_cast<const __half*>(w) + col, f);
}

// shared memory of the ring path: the header, w as f32, the ring
__host__ __device__ constexpr int w_bytes(int d) { return (4 * d + 127) / 128 * 128; }

template <typename TX, typename TG, bool kDw>
__device__ void ring_rows(const Params& p, unsigned char* smem, long long row0, long long row1) {
  // chunks a lane, loaded kB at a time: half of them, a quarter beside dw's registers
  constexpr int kC = kChunks<TX, TG>, kB = kDw ? (kC + 3) / 4 : (kC + 1) / 2;
  const int d = p.d, R = p.rows_per_stage, S = p.stages, wpr = p.warps_per_row;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  int* done = reinterpret_cast<int*>(full + kMaxStages);             // warps done with a stage
  float* sums = reinterpret_cast<float*>(done + kMaxStages);         // [2][kConsumerWarps][2]
  float* ws = reinterpret_cast<float*>(smem + kHeaderBytes);         // w as f32
  unsigned char* ring = smem + kHeaderBytes + w_bytes(d);
  const uint32_t x_bytes = R * d * sizeof(TX), stage_bytes = x_bytes + R * d * sizeof(TG);
  const int tiles = static_cast<int>((row1 - row0 + R - 1) / R);
  // tile t into stage s: two bulk copies, completing on full[s]
  auto fill = [&](int t, int s) {
    const long long r = row0 + static_cast<long long>(t) * R;
    const int rows = static_cast<int>(min(static_cast<long long>(R), row1 - r));
    const uint32_t bx = rows * d * sizeof(TX), bg = rows * d * sizeof(TG);
    const uint32_t bar = smem_addr(full + s), stage = smem_addr(ring + s * stage_bytes);
    bar_arm(bar, bx + bg);
    bulk_copy(stage, static_cast<const TX*>(p.x) + r * d, bx, bar);
    bulk_copy(stage + x_bytes, static_cast<const TG*>(p.g) + r * d, bg, bar);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) bar_init(smem_addr(full + s), 1), done[s] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)  // the first stages, before w is read
    for (int t = 0; t < min(S, tiles); ++t) fill(t, t);
  for (int c = threadIdx.x; c < d / 8; c += blockDim.x) {
    float f[8];
    load_w8(p.w, p.w_dtype, 8 * c, f);
    reinterpret_cast<float4*>(ws + 8 * c)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(ws + 8 * c)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  __syncthreads();

  float acc[kC][8];  // a lane's columns of dw, over the band
  const int rit = warp / wpr, slice = warp % wpr;
  const int cols = d / wpr, chunks = cols / 8, col0 = slice * cols;
  {
#pragma unroll
    for (int k = 0; k < kC; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;
    const uint32_t wa = smem_addr(ws + col0);
    const float inv_d = 1.f / static_cast<float>(d);
    // one row: a lane's chunks in batches of kB, every load of a batch
    // issued before its first use; 8 partial sums a lane for each row sum.
    // kFull: every lane has kC chunks, so no chunk needs a test.
    auto row = [&](auto full_row, uint32_t xa, uint32_t ga, TX* dxr, int t) {
      constexpr bool kFull = decltype(full_row)::value;
      float ss[8], gwx[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) ss[j] = 0.f, gwx[j] = 0.f;
#pragma unroll
      for (int b = 0; b < kC; b += kB) {
        uint4 xr[kB][kWords<TX>], gr[kB][kWords<TG>], wr[kB][2];
#pragma unroll
        for (int i = 0; i < kB && b + i < kC; ++i) {
          const int c = lane + 32 * (b + i);
          if (kFull || c < chunks) {
            lds_chunk<TX>(xa + 8 * c * sizeof(TX), xr[i]), lds_chunk<TG>(ga + 8 * c * sizeof(TG), gr[i]);
            lds_chunk<float>(wa + 32 * c, wr[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < kB && b + i < kC; ++i) {
          const int c = lane + 32 * (b + i);
          if (kFull || c < chunks) {
            float xv[8], gv[8], wv[8];
            unpack<TX>(xr[i], xv);
            unpack<TG>(gr[i], gv);
            unpack<float>(wr[i], wv);
#pragma unroll
            for (int j = 0; j < 8; ++j) ss[j] += xv[j] * xv[j], gwx[j] += gv[j] * wv[j] * xv[j];
          }
        }
      }
      float sx = ((ss[0] + ss[1]) + (ss[2] + ss[3])) + ((ss[4] + ss[5]) + (ss[6] + ss[7]));
      float sg = ((gwx[0] + gwx[1]) + (gwx[2] + gwx[3])) + ((gwx[4] + gwx[5]) + (gwx[6] + gwx[7]));
      sx = warp_sum(sx), sg = warp_sum(sg);
      if (wpr > 1) {  // the row's warps add their slices' sums in slice order
        float* buf = sums + (t & 1) * kConsumerWarps * 2;
        if (lane == 0) buf[2 * warp] = sx, buf[2 * warp + 1] = sg;
        row_barrier(1 + rit, wpr * 32);
        sx = 0.f, sg = 0.f;
        for (int i = 0; i < wpr; ++i) sx += buf[2 * (rit * wpr + i)], sg += buf[2 * (rit * wpr + i) + 1];
      }
      const float rr = rsqrtf(sx * inv_d + p.eps);
      const float c2 = rr * rr * rr * (sg * inv_d);
#pragma unroll
      for (int b = 0; b < kC; b += kB) {
        uint4 xr[kB][kWords<TX>], gr[kB][kWords<TG>], wr[kB][2];
#pragma unroll
        for (int i = 0; i < kB && b + i < kC; ++i) {
          const int c = lane + 32 * (b + i);
          if (kFull || c < chunks) {
            lds_chunk<TX>(xa + 8 * c * sizeof(TX), xr[i]), lds_chunk<TG>(ga + 8 * c * sizeof(TG), gr[i]);
            lds_chunk<float>(wa + 32 * c, wr[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < kB && b + i < kC; ++i) {
          const int c = lane + 32 * (b + i);
          if (kFull || c < chunks) {
            float xv[8], gv[8], wv[8], out[8];
            unpack<TX>(xr[i], xv);
            unpack<TG>(gr[i], gv);
            unpack<float>(wr[i], wv);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              out[j] = rr * (gv[j] * wv[j]) - xv[j] * c2;
              if (kDw) acc[b + i][j] += gv[j] * xv[j] * rr;
            }
            store8(dxr + 8 * c, out);
          }
        }
      }
    };
    const bool full_rows = chunks == 32 * kC;
    for (int t = 0, s = 0, phase = 0; t < tiles; ++t) {
      bar_wait(smem_addr(full + s), phase);
      const long long r = row0 + static_cast<long long>(t) * R + rit;
      if (r < row1) {
        const uint32_t xa = smem_addr(ring + s * stage_bytes) + (rit * d + col0) * sizeof(TX);
        const uint32_t ga = smem_addr(ring + s * stage_bytes + x_bytes) + (rit * d + col0) * sizeof(TG);
        TX* dxr = static_cast<TX*>(p.dx) + r * d + col0;
        if (full_rows) row(std::true_type{}, xa, ga, dxr, t);
        else row(std::false_type{}, xa, ga, dxr, t);
      }
      __syncwarp();  // the warp's reads of the stage are done
      if (lane == 0) {  // the last warp done with the stage refills it
        __threadfence_block();
        if (atomicAdd(done + s, 1) == kConsumerWarps - 1) {
          done[s] = 0;
          __threadfence_block();
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          if (t + S < tiles) fill(t + S, s);
        }
      }
      if (++s == S) s = 0, phase ^= 1;
    }
  }
  if (!kDw) return;
  __syncthreads();  // every stage consumed: the ring is free
  float* scratch = reinterpret_cast<float*>(ring);  // (rows_per_stage, d) f32
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    const int c = lane + 32 * k;
    if (c < chunks) {
      float4* o = reinterpret_cast<float4*>(scratch + static_cast<size_t>(rit) * d + col0 + 8 * c);
      o[0] = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
      o[1] = make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
    }
  }
  __syncthreads();
  // the stage's rows added in row order: the block's one f32 row of partials
  float4* out = reinterpret_cast<float4*>(p.part + static_cast<size_t>(blockIdx.x) * d);
  for (int c = threadIdx.x; c < d / 4; c += blockDim.x) {
    float4 s = reinterpret_cast<const float4*>(scratch)[c];
    for (int i = 1; i < R; ++i) s = add4(s, reinterpret_cast<const float4*>(scratch + static_cast<size_t>(i) * d)[c]);
    out[c] = s;
  }
}

// --------------------------------------------- rows too wide for the ring
template <typename TX, typename TG, bool kDw>
__device__ void wide_rows(const Params& p, long long row0, long long row1) {
  __shared__ float sums[2][kThreads / 32][2];
  const int d = p.d, chunks = d / 8, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float inv_d = 1.f / static_cast<float>(d);
  float* part = p.part + static_cast<size_t>(blockIdx.x) * d;  // this block's own row
  if (kDw) {
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      float4* o = reinterpret_cast<float4*>(part + 8 * c);
      o[0] = o[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  for (long long r = row0; r < row1; ++r) {
    const TX* xr = static_cast<const TX*>(p.x) + r * d;
    const TG* gr = static_cast<const TG*>(p.g) + r * d;
    float ss = 0.f, gwx = 0.f;
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      float xv[8], gv[8];
      load8(xr + 8 * c, xv);
      load8(gr + 8 * c, gv);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        ss += xv[j] * xv[j], gwx += gv[j] * load_scalar(p.w, p.w_dtype, 8 * c + j) * xv[j];
    }
    ss = warp_sum(ss), gwx = warp_sum(gwx);
    const int b = static_cast<int>((r - row0) & 1);
    if (lane == 0) sums[b][warp][0] = ss, sums[b][warp][1] = gwx;
    __syncthreads();
    ss = 0.f, gwx = 0.f;
    for (int i = 0; i < kThreads / 32; ++i) ss += sums[b][i][0], gwx += sums[b][i][1];
    const float rr = rsqrtf(ss * inv_d + p.eps);
    const float c2 = rr * rr * rr * (gwx * inv_d);
    TX* dxr = static_cast<TX*>(p.dx) + r * d;
    for (int c = threadIdx.x; c < chunks; c += kThreads) {
      float xv[8], gv[8], out[8];
      load8(xr + 8 * c, xv);
      load8(gr + 8 * c, gv);
#pragma unroll
      for (int j = 0; j < 8; ++j) out[j] = rr * (gv[j] * load_scalar(p.w, p.w_dtype, 8 * c + j)) - xv[j] * c2;
      store8(dxr + 8 * c, out);
      if (kDw) {
        float4* o = reinterpret_cast<float4*>(part + 8 * c);
        float4 a = o[0], b2 = o[1];
        a.x += gv[0] * xv[0] * rr, a.y += gv[1] * xv[1] * rr, a.z += gv[2] * xv[2] * rr, a.w += gv[3] * xv[3] * rr;
        b2.x += gv[4] * xv[4] * rr, b2.y += gv[5] * xv[5] * rr, b2.z += gv[6] * xv[6] * rr, b2.w += gv[7] * xv[7] * rr;
        o[0] = a, o[1] = b2;
      }
    }
  }
}

template <int XCode, int GCode, bool kDw>
__global__ void __launch_bounds__(kThreads, 1) rms_norm_bwd_kernel(const Params p) {
  using TX = typename Elem<XCode>::T;
  using TG = typename Elem<GCode>::T;
  extern __shared__ __align__(128) unsigned char smem[];
  const long long row0 = p.n * blockIdx.x / gridDim.x, row1 = p.n * (blockIdx.x + 1) / gridDim.x;
  if (p.stages > 0) ring_rows<TX, TG, kDw>(p, smem, row0, row1);
  else wide_rows<TX, TG, kDw>(p, row0, row1);
  if (kDw) finish_dw(p);
}

int element_bytes(int code) { return code == kF32 ? 4 : 2; }

int smem_bytes(const Params& p, int x_dtype, int g_dtype) {
  if (p.stages == 0) return 0;
  return kHeaderBytes + w_bytes(p.d) +
         p.stages * p.rows_per_stage * p.d * (element_bytes(x_dtype) + element_bytes(g_dtype));
}

template <int XCode, int GCode, bool kDw>
cudaError_t launch(const Params& p, int grid, int smem, cudaStream_t stream) {
  auto kernel = rms_norm_bwd_kernel<XCode, GCode, kDw>;
  static int allowed = -1;  // the dynamic shared memory this instantiation may take
  if (smem > 48 * 1024 && smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int XCode, bool kDw>
cudaError_t dispatch_g(int g_dtype, const Params& p, int grid, int smem, cudaStream_t st) {
  if (g_dtype == kF32) return launch<XCode, kF32, kDw>(p, grid, smem, st);
  if (g_dtype == kBF16) return launch<XCode, kBF16, kDw>(p, grid, smem, st);
  return launch<XCode, kF16, kDw>(p, grid, smem, st);
}

template <bool kDw>
cudaError_t dispatch(int x_dtype, int g_dtype, const Params& p, int grid, int smem, cudaStream_t st) {
  if (x_dtype == kF32) return dispatch_g<kF32, kDw>(g_dtype, p, grid, smem, st);
  if (x_dtype == kBF16) return dispatch_g<kBF16, kDw>(g_dtype, p, grid, smem, st);
  return dispatch_g<kF16, kDw>(g_dtype, p, grid, smem, st);
}

bool dtype_ok(int code) { return code == kF32 || code == kBF16 || code == kF16; }

}  // namespace

extern "C" {

// dtype codes: 0 float32, 1 bfloat16, 2 float16. The plan (grid,
// rows_per_stage, warps_per_row, stages, finishers) is `plan_bwd`'s in
// ops/rms_norm.py; stages 0 takes the chunked walk. With with_dw 0, dw,
// part and tickets may be null. x, w, g and dx 16-byte aligned. Returns a
// cudaError_t; 0 on a clean launch.
int rms_norm_bwd_launch(int x_dtype, int g_dtype, int w_dtype, int with_dw, const void* x,
                        const void* w, const void* g, void* dx, void* dw, void* part,
                        void* tickets, long long n, int d, float eps, int grid, int rows_per_stage,
                        int warps_per_row, int stages, int finishers, void* stream) {
  Params p;
  p.x = x, p.w = w, p.g = g, p.dx = dx, p.dw = dw;
  p.part = static_cast<float*>(part);
  p.tickets = static_cast<int*>(tickets);
  p.n = n, p.d = d, p.eps = eps, p.w_dtype = w_dtype;
  p.rows_per_stage = rows_per_stage, p.warps_per_row = warps_per_row, p.stages = stages;
  p.finishers = finishers;
  const int smem = smem_bytes(p, x_dtype, g_dtype);
  const int pair = dtype_ok(x_dtype) && dtype_ok(g_dtype) ? element_bytes(x_dtype) + element_bytes(g_dtype) : 0;
  const bool ring_ok = stages == 0 || (stages >= 2 && stages <= kMaxStages && warps_per_row >= 1 &&
                                       rows_per_stage * warps_per_row == kConsumerWarps &&
                                       d % warps_per_row == 0 && d / warps_per_row * pair <= kSliceBytes &&
                                       smem <= kSmemLimit);
  if (n < 0 || d <= 0 || d % 128 != 0 || grid < 1 || pair == 0 || !ring_ok || !dtype_ok(w_dtype) ||
      (with_dw && (finishers < 1 || finishers > kMaxFinishers || 2 * finishers - 1 > grid ||
                   dw == nullptr || part == nullptr || tickets == nullptr)) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(dx) |
       reinterpret_cast<uintptr_t>(w)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_dw ? dispatch<true>(x_dtype, g_dtype, p, grid, smem, st)
                                  : dispatch<false>(x_dtype, g_dtype, p, grid, smem, st);
  return static_cast<int>(err);
}

const char* rms_norm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
