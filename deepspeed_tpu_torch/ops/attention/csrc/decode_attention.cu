// Decode attention for Hopper (sm_90a): one query token per sequence
// against a KV cache, online softmax with fp32 statistics.  One kernel
// body (decode_kernel) under two walks of the cache.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/attention/decode.py:
//   paged_decode_fwd  <- _paged_decode_kernel (:233) via _paged_decode_pallas
//                        (pallas_call :471), and _paged_decode_kernel_gqa
//                        (:293) via _paged_decode_pallas_gqa (pallas_call
//                        :411): the paged walk, every group = heads /
//                        kv_heads (group 1 is MHA, kv_heads 1 is MQA);
//   paged_decode_quant_fwd <- _paged_decode_kernel_quant (:171, pallas_call
//                        :471) and the quantized=True branch of
//                        _paged_decode_kernel_gqa (:310-338, pallas_call
//                        :411): the paged walk over int8 or fp8-e4m3
//                        payload pools with one fp32 scale per token row
//                        per kv head ([pages, page_size, kv_heads, 1]),
//                        the storage type being a template parameter;
//   decode_fwd        <- _decode_kernel (:36) via _decode_pallas
//                        (pallas_call :104): the dense walk, a
//                        [b, max_len, kv_heads, d] cache with an additive
//                        fp32 bias taken by strides.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): each K/V element
// read feeds ~2 flops per query head of its group, far below the ~295
// flop/byte ridge, so the floor is the K/V bytes the kernel must read
// divided by 3.35 TB/s: the live prefix (keys <= position) of every slot
// for the paged walk, the whole [b, max_len] cache plus the fp32 bias for
// the dense walk.  A quantized pool costs head_dim + 4 bytes per row per
// kv head (payload and scale) where a bf16 pool costs 2 * head_dim.  At
// decode sizes the bytes are few and the time is latency, and one SM
// pulls only about 1/132 of the card's rate, so what counts is how many
// SMs share a sequence's bytes and how many dependent steps each block
// takes.
//
// What the kernel does about it:
//  * split keys (flash-decoding): the grid is (split, kv head x group
//    tile, sequence).  A split is a whole number of 64-key tiles, picked
//    by the host from the cache's shape alone (paged: whole pages, at
//    least 64 keys, from the page size and the table's width; dense: from
//    max_len), never from the batch, the bias or the positions, and a
//    sequence has at most 4 splits.  A paged block whose split starts
//    past its slot's position has nothing to do, so the host never reads
//    the positions and the call is CUDA-graph safe.  A sequence's splits
//    are one thread block cluster: with one live split that block writes
//    the output; with several, each live split pushes its fp32 partial
//    (rows, m, l) into split 0's shared memory over the cluster (no
//    workspace, no atomics) and split 0 merges them in split order.  The
//    order is fixed, so the output is deterministic and does not depend
//    on the batch.
//  * the walk (a template parameter) gives a key's row and which keys are
//    live.  Paged: the split's page ids are read once with the position;
//    keys past the position are never read, so unallocated table entries
//    (0) are never touched.  Dense: row (b, t) of the cache at the same
//    per-row stride (kv_heads * head_dim), every key below max_len, and
//    beside each K tile the tile's fp32 bias (one row when the bias does
//    not vary over heads, else the block's head rows) staged by 4-byte
//    cp.async through its strides; scores add it before the clamp.
//  * a bulk-copy pipeline: each K and V row of the block's kv head
//    (head_dim contiguous elements at stride kv_heads * head_dim) is one
//    cp.async.bulk (TMA, no tensor map) into a two-stage shared-memory
//    ring, completion counted in bytes on an mbarrier per stage; the next
//    tile's copies are in flight during this tile's math.  Keys past the
//    last live key of a tile are scored NEG_INF and their V rows zeroed.
//  * the group as one product: the block's query heads (a tile of up to
//    16 of its kv head's group; larger groups take more tiles, MQA
//    included) are the rows of S = Q K^T and acc += P V.  bf16 and fp16
//    run mma.sync.m16n8k16 (fp32 accumulate; the .bf16 or .f16 form, one
//    template over the element type) with ldmatrix from the staged
//    tiles, rows padded to 16 and head_dim to the mma depth with zeros.
//    Each warp owns 16 keys of a 64-key tile and keeps its own online
//    softmax in registers (P goes from the S fragments straight into the
//    A fragments of P V, rounded to the value type as the reference
//    does); the four
//    warps merge once at the end.  The fp32 instantiation (the serving
//    oracle) runs fp32 FMAs over the same staged tiles: no TF32.  No
//    register array grows with the group, so every group runs.
//  * quantized pools stage the 1-byte payload (half a bf16 pool's bytes)
//    and the row scales (4-byte cp.async) through the same page index,
//    then dequantize a tile to the compute type (float(payload) * scale,
//    rounded) in shared memory before the same product.
//
// Numerics follow the TPU kernels: fp32 scores = (q . k) * scale (+ bias),
// clamped at NEG_INF = -1e30 (ops/attention/flash.py:42); a row whose
// running max is still NEG_INF is dead (its probabilities are 0 and a
// fully masked row writes zeros); probabilities are cast to the value
// dtype before the PV product; the output is acc / l in fp32 (l == 0 ->
// 1), then cast.  A quantized element is float(payload) * scale in fp32,
// rounded to the compute dtype (q's) before the dot, as decode.py:196-199.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxHeadDim = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) {
  return __half2float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
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

// the 16-bit compute types, which run the tensor-core product
template <typename T>
constexpr bool kIs16 = std::is_same<T, __nv_bfloat16>::value ||
                       std::is_same<T, __half>::value;

// ========================== decode_kernel: the paged and the dense walk

// The walks of the cache (decode_kernel's Walk parameter): the paged pools
// through a page table up to each slot's position (paged_decode_fwd,
// paged_decode_quant_fwd), or a dense cache with an additive bias
// (decode_fwd)
struct PagedWalk {};
struct DenseWalk {};

constexpr int kPThreads = 128;
constexpr int kPWarps = kPThreads / 32;
constexpr int kRows = 16;      // query heads per block: one mma M tile
constexpr int kMaxFmaRows = 8; // rows a thread owns in the fp32 PV phase
constexpr int kMaxSplits = 4;  // splits of a slot: one thread block cluster
static_assert(kRows * 8 == kPThreads, "8 threads a query row");
static_assert(kRows <= 2 * kMaxFmaRows, "fp32 PV: head_dim <= 256 leaves two "
              "row groups, so a thread owns at most kMaxFmaRows rows");

struct DecodeParams {
  const void* q;              // [seqs, 1, kv_heads * group, head_dim]
  const void* k;              // paged: [pages, page_size, kv_heads,
  const void* v;              //   head_dim]; dense: [seqs, max_len, ...]
  void* out;                  // like q
  const int* page_table;      // paged: [slots, max_pages]
  const int* positions;       // paged: [slots]
  const float* k_scale;       // quantized pools: [pages, page_size,
  const float* v_scale;       //   kv_heads, 1]
  const float* bias;          // dense: element (b, h, 0, t) at
  long long bias_sb, bias_sh, bias_sk;   // b*sb + h*sh + t*sk
  // dense: page_size is max_len and max_pages 1 (one page a sequence)
  int kv_heads, group, head_dim, page_size, max_pages;
  int pages_per_split;        // paged: page ids a block reads
  int split_keys, n_splits, n_gtiles;
  float scale;
};

// Tile sizes and the shared-memory carve-up of one instantiation, the same
// on the host (size) and the card.
template <typename T, typename S>
struct DecodeLayout {
  static constexpr bool kQuant = !std::is_same<T, S>::value;
  static constexpr bool kMma = kIs16<T>;
  // bf16 / fp16: 64 keys a stage; fp32 (FMA, 4 threads a key): 32; two
  // stages
  static constexpr int kKeys = kMma ? 64 : 32;
  static constexpr int kStages = 2;
  static constexpr int kSStride = kKeys + 4;   // fp32 score rows
  int dk;          // head_dim padded to the mma depth (16) for 16 bits
  int ring_stride; // bytes per staged K/V row
  int t_stride;    // bytes per row of a compute-type tile (Q, dequantized)
  size_t ring, scales, deq, bias, q, s, stats, bars, pages, recv, total;
  int recv_stride;  // floats a split's pushed rows and (m, l) take

  // d: head_dim; pps: pages per split (paged walk); dense: the walk
  // stages a bias tile a stage
  __host__ __device__ DecodeLayout(int d, int pps, bool dense) {
    dk = kMma ? (d + 15) / 16 * 16 : d;
    // 16 bytes of padding per row: ldmatrix's eight rows then fall on
    // distinct banks
    ring_stride = (kQuant ? d : dk) * (int)sizeof(S) + 16;
    t_stride = dk * (int)sizeof(T) + 16;
    size_t o = 0;
    ring = o;   o += (size_t)kStages * 2 * kKeys * ring_stride;
    scales = o; o += kQuant ? (size_t)kStages * 2 * kKeys * 4 : 0;
    deq = o;    o += kQuant ? (size_t)2 * kKeys * t_stride : 0;
    bias = o;   o += dense ? (size_t)kStages * kRows * kKeys * 4 : 0;
    // after the loop the space from 0 holds the output rows (fp32
    // [kRows][d]) and, for bf16, the four warps' rows ([4][kRows][dk + 8])
    const size_t out_rows =
        (size_t)kRows * dk * 4 + (kMma ? (size_t)4 * kRows * (dk + 8) * 4 : 0);
    o = o > out_rows ? o : out_rows;
    q = o;      o += (size_t)kRows * t_stride;
    s = o;      o += (size_t)kRows * kSStride * 4;
    stats = o;  o += (size_t)3 * kRows * 4;   // m, l, alpha
    bars = o;   o += (size_t)kStages * 8 + 8;  // one mbarrier a stage
    o = (o + 15) / 16 * 16;
    pages = o;  o += ((size_t)pps * 4 + 15) / 16 * 16;
    // split 0 receives the other splits' rows and statistics here
    recv_stride = kRows * dk + 2 * kRows;
    recv = o;   o += (size_t)(kMaxSplits - 1) * recv_stride * 4;
    total = o;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the bulk copy engine (TMA, no tensor map): `bytes` (a multiple of 16,
// both addresses 16-byte aligned) global -> shared, completion counted on
// the mbarrier `bar` in bytes
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::
      "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::
               "r"(smem_addr(bar)), "r"(count) : "memory");
}

// one arrival that also expects `bytes` more of bulk copies this phase
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
      "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// order this thread's generic-proxy shared-memory accesses before later
// bulk copies into the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the cluster barrier, split into its arrive (release: this thread's
// earlier writes, shared memory of other blocks included, are visible to
// whoever waits) and its wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 4 bytes global -> shared (a quantized row's scale)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
               "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

// two floats rounded to T (bf16 or fp16, round to nearest even), packed
// into one 32-bit word, the first in the low half
template <typename T>
__device__ __forceinline__ unsigned pack2(float a, float b) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const unsigned*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned*>(&h);
  }
}

// 16 one-byte payload elements of a quantized row -> float(x) * scale
// rounded to T (zeros where the row is past the live keys), stored as
// 16-byte words
template <typename T>
__device__ __forceinline__ std::enable_if_t<kIs16<T>> pack16(const float* v,
                                                             T* dst) {
  unsigned w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = pack2<T>(v[2 * i], v[2 * i + 1]);
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(w[0], w[1], w[2], w[3]);
  d[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

__device__ __forceinline__ void pack16(const float* v, float* dst) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    d[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

template <typename T, typename S>
__device__ __forceinline__ void dequant16(const uint4& raw, float scale,
                                          bool live, T* dst) {
  static_assert(sizeof(S) == 1, "a 16-byte chunk of a 1-byte payload");
  const S* e = reinterpret_cast<const S*>(&raw);
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = live ? to_float(e[i]) * scale : 0.f;
  pack16(v, dst);
}

// T: the compute type (q's and the output's); S: the pools' storage type,
// T itself for a float cache, int8_t or __nv_fp8_e4m3 for a quantized one;
// kMaxD: the largest head_dim the instantiation takes (registers scale
// with it); Walk: PagedWalk or DenseWalk (float caches only)
// (one block an SM at least: ptxas then keeps every instantiation's
// registers, up to 214, without spilling)
template <typename T, typename S, int kMaxD, typename Walk>
__global__ void __launch_bounds__(kPThreads, 1) decode_kernel(
    const DecodeParams p) {
  using Layout = DecodeLayout<T, S>;
  constexpr bool kDense = std::is_same<Walk, DenseWalk>::value;
  constexpr bool kQuant = Layout::kQuant;
  static_assert(!(kDense && kQuant), "the dense walk reads a float cache");
  constexpr bool kMma = Layout::kMma;
  constexpr int kKeys = Layout::kKeys, kStages = Layout::kStages;
  constexpr int kSStride = Layout::kSStride;
  constexpr int kChunk = 16 / (int)sizeof(S);   // elements per 16 bytes
  constexpr int kVec = 16 / (int)sizeof(T);     // q elements per 16 bytes
  static_assert(!kMma || kKeys == 16 * kPWarps, "a warp owns 16 keys");
  static_assert(kMma || kKeys * 4 == kPThreads, "fp32: 4 threads a key");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / p.n_gtiles, gt = blockIdx.y % p.n_gtiles;
  const int slot = blockIdx.z;
  const int D = p.head_dim, G = p.group, H = p.kv_heads * G;
  const int ps = p.page_size;
  const int split_keys = p.split_keys;
  const int k0 = split * split_keys;
  const int rows = min(kRows, G - gt * kRows);   // real query heads
  const int head0 = kvh * G + gt * kRows;
  // thread (row, column): 8 threads a query row
  const int my_row = tid >> 3, col0 = tid & 7;

  const Layout L(D, p.pages_per_split, kDense);
  extern __shared__ __align__(16) unsigned char psmem[];
  unsigned char* ring = psmem + L.ring;
  float* scales_s = reinterpret_cast<float*>(psmem + L.scales);
  T* q_s = reinterpret_cast<T*>(psmem + L.q);
  float* s_s = reinterpret_cast<float*>(psmem + L.s);
  float* m_s = reinterpret_cast<float*>(psmem + L.stats);
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;
  uint64_t* bars = reinterpret_cast<uint64_t*>(psmem + L.bars);
  int* pages_s = reinterpret_cast<int*>(psmem + L.pages);
  float* bias_s = reinterpret_cast<float*>(psmem + L.bias);
  const int qst = L.t_stride / (int)sizeof(T);  // elements per tile row

  // paged: three loads in flight together: the query rows (16 bytes a
  // load; rows past the group and columns past head_dim are zero), the
  // slot's position and the split's page ids (read before the position is
  // known: a table entry is a valid int even where unallocated, and its
  // page is only touched below the position)
  constexpr int kQLoads = kMaxHeadDim / kVec / 8;
  const T* q = static_cast<const T*>(p.q) + ((size_t)slot * H + head0) * D;
  uint4 qv[kQLoads];
#pragma unroll
  for (int j = 0; j < kQLoads; ++j) {
    const int c = col0 + 8 * j;
    qv[j] = make_uint4(0, 0, 0, 0);
    if (my_row < rows && c * kVec < D)
      qv[j] = *reinterpret_cast<const uint4*>(q + (size_t)my_row * D +
                                              c * kVec);
  }
  // keys [0, n_keys) are live: paged, up to the position (clamped to the
  // table's reach); dense, every key below max_len (the bias masks).
  // This block walks [k0, k1) of them
  int n_keys;
  if constexpr (kDense) {
    n_keys = ps;
  } else {
    const int position = p.positions[slot];
    const int first_page = k0 / ps;
    const int n_pages = max(0, min(p.pages_per_split,
                                   p.max_pages - first_page));
    for (int i = tid; i < n_pages; i += kPThreads)
      pages_s[i] = p.page_table[(size_t)slot * p.max_pages + first_page + i];
    n_keys = max(0, min(position + 1, ps * p.max_pages));
  }
  const int n_live = max(1, (n_keys + split_keys - 1) / split_keys);
  // The splits of a (slot, head tile) are one thread block cluster.  One
  // live split: it writes the output and the others leave.  Several:
  // every block arrives once to say it has started (a dead split then
  // leaves), the live ones other than split 0 push their rows into split
  // 0's shared memory and arrive again, and split 0 merges.
  const bool merge = n_live > 1;
  if (!merge && split > 0) return;
  if (merge) {
    cluster_arrive();
    if (split >= n_live) return;
  }
  const int k1 = min(n_keys, k0 + split_keys);
  const int n_tiles = (k1 - k0 + kKeys - 1) / kKeys;

#pragma unroll
  for (int j = 0; j < kQLoads; ++j) {
    const int c = col0 + 8 * j;
    if (c < L.dk / kVec)
      *reinterpret_cast<uint4*>(q_s + my_row * qst + c * kVec) = qv[j];
  }
  // the zero padding of the staged rows up to the mma depth (the copies
  // never write it)
  if constexpr (kMma && !kQuant) {
    if (L.dk > D) {
      const int pad = L.dk - D;
      for (int i = tid; i < kStages * 2 * kKeys * pad; i += kPThreads) {
        T* row = reinterpret_cast<T*>(ring + (size_t)(i / pad) *
                                      L.ring_stride);
        row[D + i % pad] = from_float<T>(0.f);
      }
    }
  }
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(&bars[st], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();

  const S* k_pool = static_cast<const S*>(p.k);
  const S* v_pool = static_cast<const S*>(p.v);
  const unsigned row_bytes = D * (unsigned)sizeof(S);
  // thread (K or V, row) of a stage: one bulk copy of its row, and for a
  // quantized pool a 4-byte copy of the row's scale
  const int my_kv = tid / kKeys, my_r = tid % kKeys;
  // dense: the bias rows a stage holds (one when it is the same for every
  // head) and the row query head r reads
  const int bias_rows = kDense && p.bias_sh != 0 ? rows : 1;
  auto bias_row = [&](int r) { return bias_rows == 1 ? 0 : min(r, rows - 1); };
  auto issue = [&](int it) {
    const int st = it % kStages;
    const int t = it * kKeys + my_r;          // key offset in the split
    const int valid = min(kKeys, k1 - k0 - it * kKeys);
    if (my_kv < 2 && my_r < valid) {
      size_t row;
      if constexpr (kDense)
        row = ((size_t)slot * ps + k0 + t) * p.kv_heads + kvh;
      else
        row = ((size_t)pages_s[t / ps] * ps + t % ps) * p.kv_heads + kvh;
      bulk_copy(ring + ((size_t)st * 2 * kKeys + tid) * L.ring_stride,
                (my_kv ? v_pool : k_pool) + row * D, row_bytes, &bars[st]);
      if constexpr (kQuant)
        cp_async4(scales_s + st * 2 * kKeys + tid,
                  (my_kv ? p.v_scale : p.k_scale) + row);
    }
    if constexpr (kDense) {
      const float* src = p.bias + slot * p.bias_sb +
                         (long long)head0 * p.bias_sh +
                         (long long)(k0 + it * kKeys) * p.bias_sk;
      for (int i = tid; i < bias_rows * kKeys; i += kPThreads) {
        const int r = i / kKeys, c = i - r * kKeys;
        if (c < valid)
          cp_async4(bias_s + (st * kRows + r) * kKeys + c,
                    src + r * p.bias_sh + c * p.bias_sk);
      }
    }
    if (tid == 0) mbar_arrive_expect(&bars[st], 2 * valid * row_bytes);
  };
  // the K and V rows of tile `it` in the compute type (stride qst): the
  // staged rows of a float pool, the dequantized copy of a quantized one
  const T* deq_t = reinterpret_cast<const T*>(psmem + L.deq);
  auto k_tile = [&](int it) {
    return kQuant ? deq_t
                  : reinterpret_cast<const T*>(
                        ring + (size_t)(it % kStages * 2) * kKeys *
                                   L.ring_stride);
  };
  auto v_tile = [&](int it) { return k_tile(it) + kKeys * qst; };
  // wait for tile `it` and dequantize it if the pool is quantized; V
  // rows past the live keys are zero (their probabilities are 0)
  auto ready = [&](int it) {
    const int st = it % kStages;
    const int valid = min(kKeys, k1 - k0 - it * kKeys);
    mbar_wait(&bars[st], (it / kStages) & 1);
    if constexpr (kQuant) {
      cp_async_wait<kStages - 1>();
      __syncthreads();
      unsigned char* deq = psmem + L.deq;
      const int cpr = D / kChunk;             // 16-byte chunks a row
      for (int i = tid; i < 2 * kKeys * cpr; i += kPThreads) {
        const int r = i / cpr, c = i - r * cpr;
        const bool live = (r % kKeys) < valid;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            ring + ((size_t)st * 2 * kKeys + r) * L.ring_stride + c * 16);
        dequant16<T, S>(raw, live ? scales_s[st * 2 * kKeys + r] : 0.f, live,
                        reinterpret_cast<T*>(deq + (size_t)r * L.t_stride) +
                            c * kChunk);
      }
    } else {
      if constexpr (kDense) cp_async_wait<kStages - 1>();   // the bias
      if (valid < kKeys) {
        T* vt = const_cast<T*>(v_tile(it));
        const int cpr = D / kVec;
        for (int i = tid; i < (kKeys - valid) * cpr; i += kPThreads) {
          const int r = valid + i / cpr, c = i % cpr;
          *reinterpret_cast<uint4*>(vt + r * qst + c * kVec) =
              make_uint4(0, 0, 0, 0);
        }
      }
    }
    __syncthreads();
  };

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < n_tiles) issue(it);
    cp_async_commit();
  }

  // the block's unnormalised output rows land in o_s (over the ring) with
  // their statistics in m_s / l_s
  float* o_s = reinterpret_cast<float*>(ring);       // [kRows][D]
  if constexpr (kMma) {
    // Each warp owns keys [16 w, 16 w + 16) of every tile and keeps its
    // own online softmax over them in registers (rows g and g + 8 of the
    // mma fragments); the four warps' states are merged once, at the end.
    constexpr int kD16 = kMaxD / 16;
    const int g_row = lane >> 2, tig = lane & 3;
    const int dk16 = L.dk / 16;
    // Q's A fragments: in registers, once, up to head_dim 128; read
    // again from shared memory each tile above that (registers)
    constexpr bool kQRegs = kMaxD <= 128;
    const T* qrow = q_s + (lane & 15) * qst + (lane >> 4) * 8;
    unsigned qa[kQRegs ? kD16 : 1][4];
    if constexpr (kQRegs) {
#pragma unroll
      for (int kc = 0; kc < kD16; ++kc)
        if (kc < dk16) ldmatrix_x4(qa[kc], qrow + kc * 16);
    }
    float acc[2 * kD16][4];                     // [n-block of 8 columns]
#pragma unroll
    for (int j = 0; j < 2 * kD16; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
    const int kw = warp * 16;                   // the warp's keys
    for (int it = 0; it < n_tiles; ++it) {
      if (it + kStages - 1 < n_tiles) issue(it + kStages - 1);
      cp_async_commit();
      ready(it);
      const T* kt = k_tile(it);
      const T* vt = v_tile(it);
      const int valid = min(kKeys, k1 - k0 - it * kKeys);

      // S = Q K^T over the warp's 16 keys (two n-blocks of 8)
      float c[2][4] = {}, c2[2][4] = {};     // even / odd depth chunks
      const T* krow = kt + (kw + (lane & 7) + ((lane >> 4) << 3)) * qst +
                      ((lane >> 3) & 1) * 8;
#pragma unroll (kQRegs ? kD16 : 2)
      for (int kc = 0; kc < kD16; ++kc) {
        if (kc < dk16) {
          unsigned b[4];
          ldmatrix_x4(b, krow + kc * 16);
          float (&cc)[2][4] = kc & 1 ? c2 : c;
          if constexpr (kQRegs) {
            mma16<T>(cc[0], qa[kc], b[0], b[1]);
            mma16<T>(cc[1], qa[kc], b[2], b[3]);
          } else {
            unsigned qf[4];
            ldmatrix_x4(qf, qrow + kc * 16);
            mma16<T>(cc[0], qf, b[0], b[1]);
            mma16<T>(cc[1], qf, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[nb][i] += c2[nb][i];
      // scale (dense: add the bias), mask, clamp; the tile's row max over
      // the quad's lanes
      float mx[2] = {kNegInf, kNegInf};
      const float* bt = bias_s + (it % kStages) * kRows * kKeys;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = kw + nb * 8 + tig * 2 + (i & 1);
          float sv = c[nb][i] * p.scale;
          if constexpr (kDense)
            sv = __fadd_rn(__fmul_rn(c[nb][i], p.scale),
                           bt[bias_row(g_row + 8 * (i >> 1)) * kKeys + key]);
          c[nb][i] = key < valid ? fmaxf(sv, kNegInf) : kNegInf;
          mx[i >> 1] = fmaxf(mx[i >> 1], c[nb][i]);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        const bool live = m_new > 0.5f * kNegInf;
        alpha[h] = live ? __expf(m_run[h] - m_new) : 0.f;
        mx[h] = live ? m_new : kNegInf;      // exp(s - m) is 0 when dead
        m_run[h] = m_new;
        l_run[h] *= alpha[h];
      }
      // P, rounded to the value dtype, as the A fragment of P V: the S
      // fragments of n-blocks 0 and 1 are the 16-key chunk's columns
      unsigned pa[4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool live = mx[h] > 0.5f * kNegInf;
          const float e0 = live ? __expf(c[nb][2 * h] - mx[h]) : 0.f;
          const float e1 = live ? __expf(c[nb][2 * h + 1] - mx[h]) : 0.f;
          l_run[h] += e0 + e1;
          pa[2 * nb + h] = pack2<T>(e0, e1);
        }
      // acc = alpha * acc + P V over the warp's 16 keys, two n-blocks a
      // transposed load
      const T* vrow = vt + (kw + (lane & 15)) * qst + (lane >> 4) * 8;
#pragma unroll
      for (int j = 0; j < kD16; ++j) {
        if (j < dk16) {
          unsigned b[4];
          ldmatrix_x4_trans(b, vrow + j * 16);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            float* a = acc[2 * j + x];
            a[0] *= alpha[0];
            a[1] *= alpha[0];
            a[2] *= alpha[1];
            a[3] *= alpha[1];
            mma16<T>(a, pa, b[2 * x], b[2 * x + 1]);
          }
        }
      }
      fence_proxy_async();  // the stage's reads before its next copies
      __syncthreads();      // every warp is done with the stage
    }
    cp_async_wait<0>();
    // the four warps' states: row sums over the quad, then (m, l) per
    // warp and row into shared memory, unnormalised rows into o_w[warp]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
      l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    }
    float* ml_w = s_s;                          // [warp][m | l][kRows]
    if (tig == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ml_w[(warp * 2) * kRows + g_row + 8 * h] = m_run[h];
        ml_w[(warp * 2 + 1) * kRows + g_row + 8 * h] = l_run[h];
      }
    }
    __syncthreads();                            // the ring is free now
    const int ow_stride = L.dk + 8;             // rows 8 banks apart
    float* o_w = o_s + kRows * L.dk + warp * kRows * ow_stride;
#pragma unroll
    for (int j = 0; j < 2 * kD16; ++j) {
      if (j < 2 * dk16) {
        const int col = j * 8 + tig * 2;
        *reinterpret_cast<float2*>(o_w + g_row * ow_stride + col) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(o_w + (g_row + 8) * ow_stride + col) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
    // per row: M = max_w m_w, the warps' weights exp(m_w - M) and L
    if (tid < kRows) {
      float mw = kNegInf;
#pragma unroll
      for (int w = 0; w < kPWarps; ++w)
        mw = fmaxf(mw, ml_w[2 * w * kRows + tid]);
      float l = 0.f;
#pragma unroll
      for (int w = 0; w < kPWarps; ++w) {
        const float e = expf(ml_w[2 * w * kRows + tid] - mw);
        ml_w[2 * w * kRows + tid] = e;          // m_w -> its weight
        l += ml_w[(2 * w + 1) * kRows + tid] * e;
      }
      m_s[tid] = mw;
      l_s[tid] = l;
    }
    __syncthreads();
    // o = sum_w weight_w * o_w in warp order: the output itself when this
    // is the only split, else the split's rows
    const float* o_all = o_s + kRows * L.dk;
    T* out = static_cast<T*>(p.out) + ((size_t)slot * H + head0) * D;
    for (int e = tid; e < rows * D; e += kPThreads) {
      const int r = e / D, d = e - r * D;
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kPWarps; ++w)
        o += ml_w[2 * w * kRows + r] *
             o_all[(w * kRows + r) * ow_stride + d];
      if (merge) {
        o_s[e] = o;
      } else {
        const float l = l_s[r];
        out[e] = from_float<T>(o / (l == 0.f ? 1.f : l));
      }
    }
    if (!merge) return;
    __syncthreads();
  } else {
    // fp32: one online softmax per row over the whole block, scores and
    // probabilities through shared memory
    float acc[kMaxFmaRows][4];
#pragma unroll
    for (int j = 0; j < kMaxFmaRows; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    const int n_chunk4 = D / 4;
    const int my_c4 = tid % n_chunk4, my_rg = tid / n_chunk4;
    const int n_rg = kPThreads / n_chunk4;
    for (int it = 0; it < n_tiles; ++it) {
      if (it + kStages - 1 < n_tiles) issue(it + kStages - 1);
      cp_async_commit();
      ready(it);
      const T* kt = k_tile(it);
      const T* vt = v_tile(it);
      const int valid = min(kKeys, k1 - k0 - it * kKeys);

      // (1) scores: thread (key, quarter) takes a quarter of the head
      // dim's float4 chunks for every row, then a sum over the quarters
      {
        const int key = tid >> 2, qtr = tid & 3;
        float dot[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) dot[r] = 0.f;
        for (int c4 = qtr; c4 < n_chunk4; c4 += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(
              kt + key * qst + c4 * 4);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            if (r < rows) {
              const float4 q4 = *reinterpret_cast<const float4*>(
                  q_s + r * qst + c4 * 4);
              dot[r] += to_float(q4.x) * to_float(k4.x) +
                        to_float(q4.y) * to_float(k4.y) +
                        to_float(q4.z) * to_float(k4.z) +
                        to_float(q4.w) * to_float(k4.w);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r < rows) {                     // uniform over the block
            float v = dot[r];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            float sv = v * p.scale;
            if constexpr (kDense)
              sv = __fadd_rn(__fmul_rn(v, p.scale),
                             bias_s[((it % kStages) * kRows + bias_row(r)) *
                                    kKeys + key]);
            if (qtr == 0)
              s_s[r * kSStride + key] =
                  key < valid ? fmaxf(sv, kNegInf) : kNegInf;
          }
        }
      }
      __syncthreads();

      // (2) online softmax: 8 threads a row, 4 keys each
      {
        constexpr int kPer = kKeys / 8;
        const int r = my_row, j = col0 * kPer;
        float sv[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          sv[i] = r < rows ? s_s[r * kSStride + j + i] : kNegInf;
        float mx = sv[0];
#pragma unroll
        for (int i = 1; i < kPer; ++i) mx = fmaxf(mx, sv[i]);
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        const bool live = m_new > 0.5f * kNegInf;
        const float alpha = live ? expf(m_prev - m_new) : 0.f;
        float e[kPer], sum = 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          e[i] = live ? expf(sv[i] - m_new) : 0.f;
          sum += e[i];
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
        for (int i = 0; i < kPer; ++i) s_s[r * kSStride + j + i] = e[i];
        if (col0 == 0) {
          m_s[r] = m_new;
          l_s[r] = alpha * l_s[r] + sum;
          a_s[r] = alpha;
        }
      }
      __syncthreads();

      // (3) acc = alpha * acc + P V: thread (row group, 4 columns)
      if (my_rg < n_rg) {
#pragma unroll
        for (int j = 0; j < kMaxFmaRows; ++j) {
          const int r = my_rg + j * n_rg;
          if (r < rows) {
            const float al = a_s[r];
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][i] *= al;
          }
        }
        for (int key = 0; key < valid; ++key) {
          const float4 v4 = *reinterpret_cast<const float4*>(
              vt + key * qst + my_c4 * 4);
#pragma unroll
          for (int j = 0; j < kMaxFmaRows; ++j) {
            const int r = my_rg + j * n_rg;
            if (r < rows) {
              const float pr = s_s[r * kSStride + key];
              acc[j][0] += pr * to_float(v4.x);
              acc[j][1] += pr * to_float(v4.y);
              acc[j][2] += pr * to_float(v4.z);
              acc[j][3] += pr * to_float(v4.w);
            }
          }
        }
      }
      fence_proxy_async();  // the stage's reads before its next copies
      __syncthreads();      // the stage and the score tile are reused
    }
    cp_async_wait<0>();
    __syncthreads();
    if (my_rg < n_rg) {
#pragma unroll
      for (int j = 0; j < kMaxFmaRows; ++j) {
        const int r = my_rg + j * n_rg;
        if (r < rows)
#pragma unroll
          for (int i = 0; i < 4; ++i) o_s[r * D + my_c4 * 4 + i] = acc[j][i];
      }
    }
    __syncthreads();
  }

  T* out = static_cast<T*>(p.out) + ((size_t)slot * H + head0) * D;
  if (!merge) {                      // the only split: out = acc / l
    for (int e = tid; e < rows * D; e += kPThreads) {
      const int r = e / D;
      const float l = l_s[r] == 0.f ? 1.f : l_s[r];
      out[e] = from_float<T>(o_s[e] / l);
    }
    return;
  }

  // several live splits: every block of the cluster has started (the
  // first arrival), so split 0's shared memory may be written
  float* recv = reinterpret_cast<float*>(psmem + L.recv);
  const int rs = L.recv_stride, stats_at = kRows * L.dk;
  cluster_wait();
  if (split > 0) {
    float* dst = cooperative_groups::this_cluster().map_shared_rank(recv, 0) +
                 (split - 1) * rs;
    for (int e = tid; e < rows * D; e += kPThreads) dst[e] = o_s[e];
    if (tid < rows) {
      dst[stats_at + tid] = m_s[tid];
      dst[stats_at + kRows + tid] = l_s[tid];
    }
    cluster_arrive();                // the rows are in split 0's memory
    return;
  }
  cluster_arrive();
  cluster_wait();                    // every live split's rows are here
  // per row: M = max_s m_s, the weights exp(m_s - M) and L = sum_s l_s
  // exp(m_s - M); then out = sum_s acc_s exp(m_s - M) / L, in split order
  float* w_s = s_s;                  // [kRows][kMaxSplits]
  if (tid < rows) {
    float mx = m_s[tid];
    for (int s = 1; s < n_live; ++s)
      mx = fmaxf(mx, recv[(s - 1) * rs + stats_at + tid]);
    float l = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float* st = s ? recv + (s - 1) * rs + stats_at : nullptr;
      const float e = expf((s ? st[tid] : m_s[tid]) - mx);
      w_s[tid * kMaxSplits + s] = e;
      l += (s ? st[kRows + tid] : l_s[tid]) * e;
    }
    a_s[tid] = l == 0.f ? 1.f : l;
  }
  __syncthreads();
  for (int e = tid; e < rows * D; e += kPThreads) {
    const int r = e / D;
    const float* w = w_s + r * kMaxSplits;
    float v = o_s[e] * w[0];
    for (int s = 1; s < n_live; ++s) v += recv[(s - 1) * rs + e] * w[s];
    out[e] = from_float<T>(v / a_s[r]);
  }
}

template <typename T, typename S, typename Walk, int kMaxD>
cudaError_t launch_d(const DecodeParams& p, int n_seq, cudaStream_t stream) {
  const DecodeLayout<T, S> layout(p.head_dim, p.pages_per_split,
                                  std::is_same<Walk, DenseWalk>::value);
  auto kernel = decode_kernel<T, S, kMaxD, Walk>;
  if (layout.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)layout.total);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_splits, p.kv_heads * p.n_gtiles, n_seq);
  cfg.blockDim = dim3(kPThreads);
  cfg.dynamicSmemBytes = layout.total;
  cfg.stream = stream;
  cudaLaunchAttribute cluster = {};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = p.n_splits;       // a sequence's splits
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// bf16 and fp16 keep a head_dim's accumulators in registers: head_dim <=
// 128 takes the instantiation with half the registers of the 256 one
template <typename T, typename S, typename Walk>
cudaError_t launch(const DecodeParams& p, int n_seq, cudaStream_t stream) {
  constexpr int kChunk = 16 / (int)sizeof(S);
  if (p.head_dim % kChunk != 0 || p.head_dim % 8 != 0)
    return cudaErrorInvalidValue;
  if constexpr (kIs16<T>)
    if (p.head_dim <= 128) return launch_d<T, S, Walk, 128>(p, n_seq, stream);
  return launch_d<T, S, Walk, kMaxHeadDim>(p, n_seq, stream);
}

// the grid: (split, kv head x group tile, sequence); a sequence's splits
// are one cluster (at most kMaxSplits blocks)
bool fill_grid(DecodeParams& p, int n_seq, int kv_heads, int group,
               int head_dim, int dtype, int n_keys, int split_keys,
               float scale) {
  if (n_seq <= 0 || n_seq > 65535 || kv_heads <= 0 || group < 1 ||
      head_dim <= 0 || head_dim > kMaxHeadDim ||
      dtype < 0 || dtype > 2 || n_keys <= 0 || split_keys <= 0)
    return false;
  p.kv_heads = kv_heads;
  p.group = group;
  p.head_dim = head_dim;
  p.split_keys = split_keys;
  p.n_splits = (n_keys + split_keys - 1) / split_keys;
  p.n_gtiles = (group + kRows - 1) / kRows;
  p.scale = scale;
  return (long long)kv_heads * p.n_gtiles <= 65535 &&
         p.n_splits <= kMaxSplits;
}

// the paged walk: a split is pages_per_split pages
bool fill_paged(DecodeParams& p, int slots, int kv_heads, int group,
                int head_dim, int page_size, int max_pages,
                int pages_per_split, float scale, int dtype) {
  if (page_size <= 0 || max_pages <= 0 || pages_per_split <= 0 ||
      (long long)pages_per_split * page_size > (1 << 30))
    return false;
  p.page_size = page_size;
  p.max_pages = max_pages;
  p.pages_per_split = pages_per_split;
  return fill_grid(p, slots, kv_heads, group, head_dim, dtype,
                   page_size * max_pages, pages_per_split * page_size,
                   scale);
}

// float pools: the storage type is the compute type
template <typename Walk>
int dispatch_float(const DecodeParams& p, int n_seq, int dtype,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0   ? launch<float, float, Walk>(p, n_seq, s)
      : dtype == 1 ? launch<__nv_bfloat16, __nv_bfloat16, Walk>(p, n_seq, s)
                   : launch<__half, __half, Walk>(p, n_seq, s));
}

// quantized pools: S = int8_t or __nv_fp8_e4m3
template <typename S>
int dispatch_quant(const DecodeParams& p, int slots, int dtype,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0   ? launch<float, S, PagedWalk>(p, slots, s)
      : dtype == 1 ? launch<__nv_bfloat16, S, PagedWalk>(p, slots, s)
                   : launch<__half, S, PagedWalk>(p, slots, s));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. A split is pages_per_split pages;
// ceil(max_pages / pages_per_split) must be at most 4 (one cluster).
// Returns a cudaError_t (0 = launched).
extern "C" int paged_decode_fwd(const void* q, const void* k_pages,
                                const void* v_pages, void* out,
                                const void* page_table, const void* positions,
                                int slots, int kv_heads, int group,
                                int head_dim,
                                int page_size, int max_pages,
                                int pages_per_split, float scale, int dtype,
                                void* stream) {
  DecodeParams p = {};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.out = out;
  p.page_table = static_cast<const int*>(page_table);
  p.positions = static_cast<const int*>(positions);
  if (!fill_paged(p, slots, kv_heads, group, head_dim, page_size, max_pages,
                  pages_per_split, scale, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_float<PagedWalk>(p, slots, dtype, stream);
}

// The same over quantized pools: k_pages / v_pages hold int8 (storage 1) or
// fp8 e4m3 (storage 2) payload, k_scale / v_scale one float32 per row per
// kv head; dtype is q's and the output's.
extern "C" int paged_decode_quant_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, void* out,
    const void* page_table, const void* positions, int slots, int kv_heads,
    int group, int head_dim, int page_size, int max_pages,
    int pages_per_split, float scale, int dtype, int storage,
    void* stream) {
  DecodeParams p = {};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.out = out;
  p.page_table = static_cast<const int*>(page_table);
  p.positions = static_cast<const int*>(positions);
  if (!fill_paged(p, slots, kv_heads, group, head_dim, page_size, max_pages,
                  pages_per_split, scale, dtype) ||
      (storage != 1 && storage != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  return storage == 1 ? dispatch_quant<int8_t>(p, slots, dtype, stream)
                      : dispatch_quant<__nv_fp8_e4m3>(p, slots, dtype, stream);
}

// The dense walk: k_cache / v_cache [batch, max_len, kv_heads, head_dim]
// of q's dtype, every key below max_len read, the fp32 bias element
// (b, h, 0, t) at bias + b*sb + h*sh + t*sk.  A split is split_keys keys
// (a multiple of 64); ceil(max_len / split_keys) must be at most 4.
extern "C" int decode_fwd(const void* q, const void* k_cache,
                          const void* v_cache, void* out, const void* bias,
                          long long bias_sb, long long bias_sh,
                          long long bias_sk, int batch, int max_len,
                          int kv_heads, int group, int head_dim,
                          int split_keys, float scale, int dtype,
                          void* stream) {
  DecodeParams p = {};
  p.q = q;
  p.k = k_cache;
  p.v = v_cache;
  p.out = out;
  p.bias = static_cast<const float*>(bias);
  p.bias_sb = bias_sb;
  p.bias_sh = bias_sh;
  p.bias_sk = bias_sk;
  p.page_size = max_len;
  p.max_pages = 1;
  if (split_keys % 64 != 0 ||
      !fill_grid(p, batch, kv_heads, group, head_dim, dtype, max_len,
                 split_keys, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_float<DenseWalk>(p, batch, dtype, stream);
}
