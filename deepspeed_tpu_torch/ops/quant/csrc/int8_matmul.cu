// Weight-only int8 dequant-matmul for Hopper (sm_90a):
//   out[m, n] = sum over groups g of (x[:, g] @ float(q[g, :])) * scale[g, :]
// with x [m, k] float32, bfloat16 or float16, q [k, n] int8 (n contiguous), scale
// [k / G, n] float32, fp32 accumulation, out in x's dtype.
//
// Replaces the TPU kernel of deepspeed_tpu/ops/quant/kernels.py:
//   int8_matmul_fwd <- _kernel (:36) via int8_matmul (pallas_call :122).
// As there, the product of each group is UNSCALED (the int8 -> float
// convert is exact) and the group's fp32 scale row multiplies the
// [m, n] partial product once per group, not the weights.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 on the tensor cores,
// 67 TFLOP/s fp32 outside them): at decode and prefill-chunk m (up to a
// few dozen rows) each weight byte feeds 2m flops, below the bf16 ridge
// (~295 flop/byte), so the floor is the bytes the call must move: k*n
// int8 + 4*k*n/G scale bytes + x and out, over 3.35 TB/s (at m = 4,
// k = n = 4096: 5.3 us).  fp32 FMAs bound the fp32 instantiation from m
// of about 40.
//
// What the design does about that bound:
//  * weight bytes in flight: a block is 4 consumer warps and 1 producer
//    warp and owns 128 output columns and up to 64 rows of x.  The
//    producer keeps a ring of 2-8 shared-memory stages full (as many as
//    64 KB hold: 5 at m <= 8, so 40 KB of weights in flight a block and
//    two or three blocks an SM): a stage is a 64 x 128 box of q, the x
//    rows' matching 64 columns and the scale rows of the groups that end
//    in the stage, one TMA load each through a tensor map
//    (cp.async.bulk.tensor.2d; 128-byte swizzle on the int8 and bf16
//    boxes; zeros past n, m and k), counted in bytes on the stage's
//    mbarrier; the consumers release a stage on a second mbarrier.  (A
//    cp.async.bulk a 128-byte row, 70 a stage from the one producer warp,
//    ran at a tenth of an H100's memory rate: the copies, not the bytes,
//    set the pace.)  The weight is read as int8 and converted in
//    registers; a dequantized weight never exists in memory.
//  * all SMs busy: k is split by whole groups over the blocks of a thread
//    block cluster (1-8 blocks, from (k, n, G) alone, never from m; the
//    host's ops/quant/kernels.py k_splits: none where the column tiles
//    already give every SM one, else about two blocks an SM), so n = 4096
//    runs 32 column tiles x 8 splits = 256 blocks.  After its walk each
//    block leaves its fp32 [rows, 128] partial in its own shared memory;
//    over distributed shared memory block s then loads slice s of every
//    split's partial at once, sums them in split order (0, 1, ...) and
//    writes the slice.  No atomics, no workspace.
//  * bf16 on the tensor cores: mma.sync.m16n8k16 with the weights as A
//    ("swap AB": the 128 columns are M, so m pads to 8, not 16) and x as
//    B.  A thread builds its A fragments from four 32-bit shared-memory
//    words (4 weight rows x its 4 columns; the swizzle leaves two lanes a
//    bank at most): each byte becomes an exact fp32 (a byte permute into
//    the mantissa of 2^23 and one subtract) and two of them one bf16x2
//    register (the fp32's upper halves, exact for |v| <= 128).  fp16 x
//    runs the same body with the .f16 mma and __floats2half2_rn for the
//    pair (exact too: an int8 value has at most 8 significant bits).  Inside a
//    16-row k-step the physical rows 4t..4t+3 are the fragment's k slots
//    2t, 2t+1, 2t+8, 2t+9, so x's B fragment is one 8-byte load of row g.
//    A stage's words are all loaded before its first product (a group's
//    end may branch after any k-step).  Each group's product accumulates
//    in its own fp32 fragment; at the group's end (counted in k-steps, no
//    division) acc += part * scale[g].  One staged weight tile serves
//    every x row of the block (a 64-row prefill chunk reads the weight
//    once).  What holds it back (clock64 stamps of a copy on an H100,
//    PERF.md): the consumers, ~1300 cycles a 64-row stage with one warp a
//    scheduler, and ~2 us each of first-load latency and cluster merge.
//  * fp32 stays off the tensor cores (the serving oracle; TF32 would
//    round x): the same ring and split feed FMAs, a thread a column, over
//    a stage's rows in segments that end where a group does (the scale
//    step once a segment, no test a row).  A 16-bit call whose group is not
//    a multiple of 16 (the mma's depth) runs the same FMA body.
//  * ragged shapes: a tensor map needs 16-byte row strides, so a call with
//    n % 16 != 0 (or G % 16 != 0) has its producer fill the same ring, in
//    the same layout, with ordinary bound-checked loads (zeros past n and
//    m); the arithmetic is the same.
// Batch invariance holds by construction: for an output element the order
// of its k-sum (the k-steps of a group in order, the groups of a split in
// order, the splits in order) is fixed by (k, n, G) - not by m, by the
// row's place among the block's rows or by the grid - and every m runs the
// same per-element instruction sequence.  A row of an m = 1 call equals
// that row of an m = 64 call bit for bit, and a run repeats bit for bit.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // + the producer warp
constexpr int kBN = 128;        // output columns of a block
constexpr int kBK = 64;         // weight rows of a stage (groups >= 16)
constexpr int kMaxRows = 64;    // x rows of a block
constexpr int kMaxEnds = 4;     // group ends in a stage
constexpr int kMaxSplits = 8;   // blocks of a cluster
constexpr int kMaxStages = 8;
constexpr int kRingBudget = 64 * 1024;
static_assert(kConsumerWarps * 32 == kBN,
              "a consumer thread a column (FMA), a warp 32 columns (mma)");

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

__host__ __device__ constexpr size_t round1k(size_t b) {
  return (b + 1023) / 1024 * 1024;
}

// The shared-memory carve-up of one instantiation, the same on the host
// (size) and the card.  A stage, each part 1024-byte aligned: the weight
// box [kBK][kBN] int8 and the x box [rows][kBK] (both 128-byte rows,
// 128-byte swizzled; fp32 x: 256-byte rows, plain), then the scale rows
// [kMaxEnds][kBN] fp32.  After the walk the ring holds the block's fp32
// partial [rows][kBN].
template <typename T>
struct Layout {
  static constexpr int kXRow = kBK * (int)sizeof(T);  // bytes an x row
  int stages;
  size_t x_off, s_off, stage_bytes, bars, total;
  // rows: x rows staged a stage
  __host__ __device__ explicit Layout(int rows) {
    x_off = (size_t)kBK * kBN;
    s_off = x_off + round1k((size_t)rows * kXRow);
    stage_bytes = round1k(s_off + (size_t)kMaxEnds * kBN * 4);
    const int st = (int)(kRingBudget / stage_bytes);
    stages = st < 2 ? 2 : st > kMaxStages ? kMaxStages : st;
    size_t ring = (size_t)stages * stage_bytes;
    const size_t partial = (size_t)rows * kBN * 4;
    if (ring < partial) ring = partial;
    bars = ring;
    total = bars + 2 * kMaxStages * 8 + 1024;   // + the base's alignment
  }
};

struct Params {
  const void* x;          // [m, k]
  const int8_t* q;        // [k, n]
  const float* scale;     // [k / G, n]
  void* out;              // [m, n]
  int m, k, n, group;
  int groups_per_split;   // whole groups a split walks
  int splits;             // blocks of a cluster (grid x)
  int ends;               // scale rows a stage's box holds (tensor maps)
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// byte `b` of row `r` of a tile of 128-byte rows as a 128-byte-swizzling
// TMA load leaves it: 16-byte chunk c of row r at chunk c ^ (r % 8)
__device__ __forceinline__ int swz(int r, int b) {
  return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::
               "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::
               "r"(smem_addr(bar)) : "memory");
}

// one arrival that also expects `bytes` more of TMA loads this phase
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
      "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// wait for the phase of parity `parity` to complete; a barrier that
// stays open for ~10 s of clocks traps (a launch error) instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  const long long t0 = clock64();
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// a box of a 2D tensor map at (c0 along the contiguous dim, c1) ->
// shared memory, counted on `bar` in bytes
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
      "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// order this thread's generic-proxy shared-memory accesses before later
// TMA loads into the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the consumer warps' own barrier (the producer does not take part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumerWarps * 32) : "memory");
}

// the cluster barrier: arrive (release) and wait (acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// c += a (16x16 T, row) * b (16x8 T, col), fp32 accumulate; T is bf16
// or fp16
template <typename T>
__device__ __forceinline__ void mma16(float* c, const unsigned* a,
                                      unsigned b0, unsigned b1) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte c of a word of four int8 -> float(value), exactly: byte c of
// (w ^ 0x80808080) is the value plus 128; placed in the low mantissa byte
// of 2^23 it reads as 2^23 + value + 128
__device__ __forceinline__ float byte_to_float(uint32_t biased, int c) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + c)) -
         8388736.f;
}

// two exact floats of at most 8 significant bits (int8 values) -> one
// register of two T (lo in the low half), exactly: for bf16 the floats'
// upper halves; for fp16 the round-to-nearest conversion, exact for
// integers of at most 11 bits
template <typename T>
__device__ __forceinline__ unsigned pack_w(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  } else {
    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
  }
}

// The split and the stage geometry of a block, the same in the producer
// and the consumers.  Positions are relative to the split's first row.
struct Walk {
  int k_begin, k_range, bk, n_stages, g_first;
  __device__ Walk(const Params& p, int split) {
    const int g0 = split * p.groups_per_split;
    const int g1 = min(p.k / p.group, g0 + p.groups_per_split);
    g_first = g0;
    k_begin = g0 * p.group;
    k_range = (g1 - g0) * p.group;
    bk = p.group >= 16 ? kBK : 4 * p.group;  // at most kMaxEnds ends a stage
    n_stages = (k_range + bk - 1) / bk;
  }
  // stage `it`: its first row and its rows, relative to the split
  __device__ int first(int it) const { return it * bk; }
  __device__ int rows(int it) const { return min(bk, k_range - it * bk); }
};

// T: x's and the output's type; kMma: bf16 or fp16 on the tensor cores
// (G % 16 == 0), else FMAs; kTma: the ring is filled by TMA through the tensor
// maps (n % 16 == 0, G % 16 == 0), else by ordinary loads; kRows: x rows
// staged (mma: 8, 16 or 64; FMA: 4 or 64) - the block's row count mt is
// at most kRows
template <typename T, bool kMma, bool kTma, int kRows>
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_s, const Params p) {
  static_assert(!kMma || sizeof(T) == 2,
                "the tensor-core path is bf16 or fp16");
  constexpr bool kSwizzledX = sizeof(T) == 2;   // 16-bit x: 128-byte rows
  const Layout<T> L(kRows);
  // the ring's base at the next 1024-byte boundary (the swizzle's
  // period), as an offset from the shared array so that the compiler keeps
  // shared-memory loads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) &
                                    1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kMaxStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x;
  const int n0 = blockIdx.y * kBN, m0 = blockIdx.z * kMaxRows;
  const int mt = min(kRows, p.m - m0);       // the block's x rows
  const int wcols = min(kBN, p.n - n0);      // its weight columns
  const int G = p.group;
  const Walk W(p, split);
  const int S = L.stages;

  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(&full[st], kTma ? 1 : 32);
      mbar_init(&empty[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- the producer warp: fill stage it % S once the consumers
    // released it
    const T* x = static_cast<const T*>(p.x);
    for (int it = 0; it < W.n_stages; ++it) {
      const int st = it % S;
      if (it >= S) mbar_wait(&empty[st], (it / S - 1) & 1);
      unsigned char* base = smem + (size_t)st * L.stage_bytes;
      const int rows = W.rows(it);
      const int k0 = W.k_begin + W.first(it);
      // the groups that end in the stage: g0, g0 + 1, ... (n_ends of them)
      const int e0 = (W.first(it) / G + 1) * G;   // the first end
      const int n_ends = e0 > W.first(it) + rows
                             ? 0 : (W.first(it) + rows - e0) / G + 1;
      const int g0 = W.g_first + e0 / G - 1;
      unsigned char* xs = base + L.x_off;
      float* ss = reinterpret_cast<float*>(base + L.s_off);
      if constexpr (kTma) {
        if (lane == 0) {
          mbar_arrive_expect(&full[st], kBK * kBN + kRows * L.kXRow +
                                            (n_ends ? p.ends * kBN * 4 : 0));
          tma_load_2d(base, &map_q, &full[st], n0, k0);
          tma_load_2d(xs, &map_x, &full[st], k0, m0);
          if (n_ends) tma_load_2d(ss, &map_s, &full[st], n0, g0);
        }
      } else {
        // the same layout by ordinary loads: zeros past n and past m
        for (int i = lane; i < rows * kBN; i += 32) {
          const int r = i / kBN, c = i - r * kBN;
          base[swz(r, c)] = c < wcols
              ? (unsigned char)p.q[(size_t)(k0 + r) * p.n + n0 + c] : 0;
        }
        for (int i = lane; i < kRows * kBK; i += 32) {
          const int r = i / kBK, c = i - r * kBK;
          const T v = r < mt && c < rows
              ? x[(size_t)(m0 + r) * p.k + k0 + c] : from_float<T>(0.f);
          if constexpr (kSwizzledX)
            *reinterpret_cast<T*>(xs + swz(r, 2 * c)) = v;
          else
            reinterpret_cast<T*>(xs)[r * kBK + c] = v;
        }
        for (int i = lane; i < n_ends * kBN; i += 32) {
          const int e = i / kBN, c = i - e * kBN;
          ss[e * kBN + c] =
              c < wcols ? p.scale[(size_t)(g0 + e) * p.n + n0 + c] : 0.f;
        }
        mbar_arrive(&full[st]);
      }
    }
  } else if constexpr (kMma) {
    // ---- bf16 / fp16 consumers: warp w owns columns [32 w, 32 w + 32); thread
    // (g, t) the columns 32 w + 4 g + {0..3}, which are the rows g, g + 8
    // of its two 16-row M blocks (col 4g+2b: block b row g; 4g+2b+1: block
    // b row g + 8), and x rows nb * 8 + 2t, +1 of each 8-row N block
    constexpr int kNB = kRows / 8;
    constexpr int kSteps = kBK / 16;
    constexpr bool kEarlyB = kNB <= 2;
    const int w = warp;
    const int g = lane >> 2, t = lane & 3;
    // byte offsets in a stage: the A words (rows 4t + r of k-step 0; a
    // k-step is 16 rows further, 2048 bytes, and leaves the swizzle's row
    // bits alone) and the B words of k-step s (x row g; an N block is 8
    // rows, 1024 bytes, further)
    int a_off[4], b_off[kSteps];
#pragma unroll
    for (int r = 0; r < 4; ++r) a_off[r] = swz(4 * t + r, 32 * w + 4 * g);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) b_off[s] = swz(g, 32 * s + 8 * t);
    // k-steps left in the group under way (G % 16 == 0 on this path)
    const int steps_per_group = G / 16;
    int to_end = steps_per_group;
    float acc[2][kNB][4], part[2][kNB][4];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[b][nb][i] = part[b][nb][i] = 0.f;
    for (int it = 0; it < W.n_stages; ++it) {
      const int st = it % S;
      mbar_wait(&full[st], (it / S) & 1);
      const unsigned char* wt = smem + (size_t)st * L.stage_bytes;
      const unsigned char* xt = wt + L.x_off;
      const float* sc = reinterpret_cast<const float*>(wt + L.s_off) +
                        32 * w + 4 * g;
      const int steps = W.rows(it) / 16;
      int e = 0;                  // the stage's next staged scale row
      // the stage's A words (and for up to 16 x rows its B words) are
      // loaded before any product: a group's end may branch after each
      // k-step, and loads are not moved across it
      uint32_t wv[kSteps][4];
      uint2 bx[kEarlyB ? kSteps : 1][kNB];
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        if (s < steps) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            wv[s][r] = *reinterpret_cast<const uint32_t*>(
                wt + a_off[r] + 2048 * s);
          if constexpr (kEarlyB) {
#pragma unroll
            for (int nb = 0; nb < kNB; ++nb)
              bx[s][nb] = *reinterpret_cast<const uint2*>(
                  xt + b_off[s] + 1024 * nb);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        if (s < steps) {
          unsigned af[2][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) wv[s][r] ^= 0x80808080u;
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int h = 0; h < 2; ++h) {      // h: row g or g + 8
              const int c = 2 * b + h;
              af[b][h] = pack_w<T>(byte_to_float(wv[s][0], c),
                                   byte_to_float(wv[s][1], c));
              af[b][h + 2] = pack_w<T>(byte_to_float(wv[s][2], c),
                                       byte_to_float(wv[s][3], c));
            }
#pragma unroll
          for (int nb = 0; nb < kNB; ++nb) {
            const uint2 bf = kEarlyB ? bx[kEarlyB ? s : 0][nb]
                : *reinterpret_cast<const uint2*>(xt + b_off[s] + 1024 * nb);
            mma16<T>(part[0][nb], af[0], bf.x, bf.y);
            mma16<T>(part[1][nb], af[1], bf.x, bf.y);
          }
          if (--to_end == 0) {                // the group's end
            to_end = steps_per_group;
            const float4 s4 =
                *reinterpret_cast<const float4*>(sc + (e++) * kBN);
            const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
            for (int b = 0; b < 2; ++b)
#pragma unroll
              for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  acc[b][nb][i] = fmaf(part[b][nb][i], sv[2 * b + (i >> 1)],
                                       acc[b][nb][i]);
                  part[b][nb][i] = 0.f;
                }
          }
        }
      }
      if constexpr (kTma) fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    consumers_sync();                         // the ring is free
    float* partial = reinterpret_cast<float*>(smem);   // [kRows][kBN]
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = nb * 8 + 2 * t + (i & 1);
          const int col = 32 * w + 4 * g + 2 * b + (i >> 1);
          partial[row * kBN + col] = acc[b][nb][i];
        }
  } else {
    // ---- FMA consumers (fp32, and 16 bits with G % 16 != 0): thread c owns
    // column c and every x row of the block
    const int c = tid;
    int to_end = G;                           // rows left in the group
    float acc[kRows], part[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = part[i] = 0.f;
    for (int it = 0; it < W.n_stages; ++it) {
      const int st = it % S;
      mbar_wait(&full[st], (it / S) & 1);
      const unsigned char* wt = smem + (size_t)st * L.stage_bytes;
      const unsigned char* xt = wt + L.x_off;
      const float* sc = reinterpret_cast<const float*>(wt + L.s_off) + c;
      const int rows = W.rows(it);
      int e = 0;                  // the stage's next staged scale row
      // x row i's value at stage row r
      auto xv = [&](int i, int r) {
        if constexpr (kSwizzledX)
          return to_float(*reinterpret_cast<const T*>(xt + swz(i, 2 * r)));
        else
          return reinterpret_cast<const float*>(xt)[i * kBK + r];
      };
      // the stage in segments that end at a group's end or the stage's;
      // FMAs over a segment's rows in order, then (at a group's end) the
      // scale, once
      for (int r = 0; r < rows;) {
        const int seg = min(rows - r, to_end);
        if (((r | seg) & 3) == 0) {           // whole quads of rows
          for (int r4 = r; r4 < r + seg; r4 += 4) {
            float wf[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              wf[j] = (float)(int8_t)wt[swz(r4 + j, c)];
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              if (i < mt) {
                float x4[4];
                if constexpr (kSwizzledX) {
#pragma unroll
                  for (int j = 0; j < 4; ++j) x4[j] = xv(i, r4 + j);
                } else {
                  const float4 v = *reinterpret_cast<const float4*>(
                      reinterpret_cast<const float*>(xt) + i * kBK + r4);
                  x4[0] = v.x; x4[1] = v.y; x4[2] = v.z; x4[3] = v.w;
                }
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  part[i] = fmaf(x4[j], wf[j], part[i]);
              }
            }
          }
        } else {
          for (int r1 = r; r1 < r + seg; ++r1) {
            const float w1 = (float)(int8_t)wt[swz(r1, c)];
#pragma unroll
            for (int i = 0; i < kRows; ++i)
              if (i < mt) part[i] = fmaf(xv(i, r1), w1, part[i]);
          }
        }
        r += seg;
        to_end -= seg;
        if (to_end == 0) {                    // the group's end
          to_end = G;
          const float sv = sc[(e++) * kBN];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            acc[i] = fmaf(part[i], sv, acc[i]);
            part[i] = 0.f;
          }
        }
      }
      if constexpr (kTma) fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    consumers_sync();                         // the ring is free
    float* partial = reinterpret_cast<float*>(smem);   // [kRows][kBN]
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (i < mt) partial[i * kBN + c] = acc[i];
  }

  // every block's partial is in its shared memory; block `split` sums
  // slice `split` of the tile over the splits, in split order
  if (p.splits > 1) cluster_sync(); else __syncthreads();
  const float* own = reinterpret_cast<const float*>(smem);
  auto cluster = cooperative_groups::this_cluster();
  const int n_el = mt * wcols;
  const int e_lo = (int)((long long)n_el * split / p.splits);
  const int e_hi = (int)((long long)n_el * (split + 1) / p.splits);
  T* out = static_cast<T*>(p.out);
  for (int e = e_lo + tid; e < e_hi; e += kThreads) {
    const int row = e / wcols, col = e - row * wcols;
    const int at = row * kBN + col;
    float v;
    if (p.splits == 1) {
      v = own[at];
    } else {
      // every split's value in flight at once, then summed in split order
      float vals[kMaxSplits];
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r)
        if (r < p.splits) vals[r] = cluster.map_shared_rank(own, r)[at];
      v = vals[0];
#pragma unroll
      for (int r = 1; r < kMaxSplits; ++r)
        if (r < p.splits) v += vals[r];
    }
    out[(size_t)(m0 + row) * p.n + n0 + col] = from_float<T>(v);
  }
  // no block leaves while another may still read its shared memory
  if (p.splits > 1) cluster_sync();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime, so the library
// links no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a row-major [rows, cols] tensor (cols contiguous, 16-byte row stride)
// as a tensor map with a box of [box_rows, box_cols]; zeros past its ends
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elt,
               const void* ptr, int rows, int cols, int box_rows,
               int box_cols, bool swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elt};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, bool kMma, bool kTma, int kRows>
cudaError_t launch_k(const Params& p, cudaStream_t stream) {
  const Layout<T> layout(kRows);
  auto kernel = int8_matmul_kernel<T, kMma, kTma, kRows>;
  // the maps travel by value in the launch (built on the host, no stream
  // operation: safe while a CUDA graph is captured)
  CUtensorMap map_q = {}, map_x = {}, map_s = {};
  if constexpr (kTma) {
    constexpr bool k16 = sizeof(T) == 2;
    const CUtensorMapDataType xt =
        std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
        : k16                          ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    if (!encode_2d(&map_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, p.q, p.k, p.n,
                   kBK, kBN, true) ||
        !encode_2d(&map_x, xt, (int)sizeof(T), p.x, p.m, p.k, kRows, kBK,
                   k16) ||
        !encode_2d(&map_s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.scale,
                   p.k / p.group, p.n, p.ends, kBN, false))
      return cudaErrorInvalidValue;
  }
  if (layout.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)layout.total);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, (p.n + kBN - 1) / kBN,
                     (p.m + kMaxRows - 1) / kMaxRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = layout.total;
  cfg.stream = stream;
  cudaLaunchAttribute cluster = {};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = p.splits;       // the splits of a tile
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, map_q, map_x, map_s,
                                           p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// the rows staged follow min(m, 64); an output element's arithmetic does
// not depend on them
template <typename T, bool kMma, bool kTma>
cudaError_t launch_rows(const Params& p, cudaStream_t stream) {
  const int rows = min(p.m, kMaxRows);
  if constexpr (kMma) {
    if (rows <= 8) return launch_k<T, true, kTma, 8>(p, stream);
    if (rows <= 16) return launch_k<T, true, kTma, 16>(p, stream);
    return launch_k<T, true, kTma, 64>(p, stream);
  } else {
    if (rows <= 4) return launch_k<T, false, kTma, 4>(p, stream);
    return launch_k<T, false, kTma, 64>(p, stream);
  }
}

// a 16-bit x: the tensor cores where G % 16 == 0, else FMAs
template <typename T>
cudaError_t launch16(const Params& p, bool tma, cudaStream_t stream) {
  if (p.group % 16 != 0) return launch_rows<T, false, false>(p, stream);
  return tma ? launch_rows<T, true, true>(p, stream)
             : launch_rows<T, true, false>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x and out).  k must be a whole number
// of groups; splits (1-8, ops/quant/kernels.py k_splits) blocks share
// each column tile's k by whole groups, none of them empty.  x, q and
// scale 16-byte aligned.  Returns a cudaError_t (0 = launched).
extern "C" int int8_matmul_fwd(const void* x, const void* q,
                               const void* scale, void* out, int m, int k,
                               int n, int group, int splits, int dtype,
                               void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || group <= 0 || k % group != 0 ||
      dtype < 0 || dtype > 2 || splits < 1 || splits > kMaxSplits ||
      (n + kBN - 1) / kBN > 65535 || (m + kMaxRows - 1) / kMaxRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = k / group;
  // the most group ends a 64-row stage can hold (stages start at
  // multiples of 64 past a group boundary)
  const int ends = group >= 64 ? 1 : 64 / group + (64 % group ? 1 : 0);
  Params p = {x, static_cast<const int8_t*>(q),
              static_cast<const float*>(scale), out, m, k, n, group,
              (groups + splits - 1) / splits, splits,
              ends < kMaxEnds ? ends : kMaxEnds};
  if ((long long)(splits - 1) * p.groups_per_split >= groups)
    return static_cast<int>(cudaErrorInvalidValue);   // an empty split
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tma = n % 16 == 0 && group % 16 == 0;
  cudaError_t e;
  if (dtype == 0)
    e = tma ? launch_rows<float, false, true>(p, s)
            : launch_rows<float, false, false>(p, s);
  else if (dtype == 1)
    e = launch16<__nv_bfloat16>(p, tma, s);
  else
    e = launch16<__half>(p, tma, s);
  return static_cast<int>(e);
}
