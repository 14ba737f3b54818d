// Block-sparse flash attention forward and backward for Hopper (sm_90a):
// the flash tile kernels of flash_kernels.cuh driven by a layout's active
// blocks instead of the whole causal square.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/attention/block_sparse.py:
//   sparse_fwd      <- _fwd_kernel (:131, pallas_call :203): o and the row
//                      logsumexp;
//   sparse_bwd_dq   <- _bwd_dq_kernel (:228, pallas_call :338);
//   sparse_bwd_dkv  <- _bwd_dkv_kernel (:263, pallas_call :365), over the
//                      transposed layout.
//
// Bound on an H100 SXM: 4*d flops per attended (query, key) pair in the
// forward (10*d for the backward pair) against q/k/v/o read or written
// once. At the layouts' densities (a few percent at 16k tokens) a query
// row still meets hundreds of keys, so the floor is again the operations
// over the peak rate (989 TFLOP/s bf16, 67 TFLOP/s fp32), and the time
// scales with the active blocks, not with the square.
//
// Design. The TPU walk is one grid step per active (row, col) block with
// first/last flags (build_csr); here a block owns a 64-row tile and loops
// over its layout row itself (SparseWalk below):
//   - the index is CSR per layout head at a tile granularity T = max(64,
//     block * factor): row_ptr [H * n_rows + 1], cols and fine bits
//     [nnz]; a layout block is (T/64)^2 tiles of 64 x 64, and when the
//     layout's block is finer than T (block 16 or 32, or the caller's
//     factor > 1), fmask packs the fine cells of a T x T cell row-major
//     (bit r * (T / block) + c, as build_csr's coarse tiles do) and the
//     kernel masks by it per entry, skipping 64 x 64 sub-tiles that hold
//     no active fine cell;
//   - dk / dv walk the index of the transposed layout (rows are key
//     blocks, bits packed in (key, query) order), so they stay a
//     FlashAttention-2 split with no atomics, deterministic;
//   - causal: the element mask of the tile kernels applies everywhere (the
//     layout is already lower-triangular), and sub-tiles wholly above the
//     diagonal are skipped;
//   - per-head layouts: layout head h when the layout has one per head, 0
//     when it has one;
//   - rows differ widely in their active blocks (a global row of BigBird
//     at 16k meets all 128 blocks, an ordinary row about 6), so the grid is
//     (b * h, tiles) and tile rank y of a head is its y-th heaviest (a host
//     built order): every head's heavy rows start first and the light ones
//     fill in behind them. A row that is empty writes o = 0, lse = NEG_INF,
//     and a key tile no query reaches writes zero dk / dv, in the kernel.
// The bf16 kernels are the dense ones' Hopper kernels (TMA ring, wgmma,
// softmax or p / ds in registers) under this walk; SparseWalk::full tells
// them which tiles carry fine bits to mask. Not yet: splitting heavy rows
// (and columns) across blocks.

#include "flash_kernels.cuh"

namespace {

struct SparseWalk {
  static constexpr bool kIndexed = true;
  int own0, bh;
  const int* cols;
  const int* fmask;
  int e, e_end;        // the own layout row's entries still to visit
  int j, nsub;         // the next 64-row sub-tile of the current entry
  int base, bits;      // the current entry's first row and its fine bits
  int own_base, tile, fine, kf, len;
  bool causal, keys_own;

  __device__ SparseWalk(const Params& p, bool keys_own_)
      : bh(blockIdx.x), cols(p.cols), fmask(p.fmask), j(0), nsub(0),
        base(0), bits(0), tile(p.tile), fine(p.fine),
        kf(p.tile / p.fine), len(p.lq), causal(p.causal != 0),
        keys_own(keys_own_) {
    const int lh = p.layout_heads == 1 ? 0 : bh % p.heads;
    own0 = p.order[lh * p.n_tiles + blockIdx.y] * kBQ;
    const int r = own0 / tile;
    own_base = r * tile;
    e = p.row_ptr[lh * p.n_rows + r];
    e_end = p.row_ptr[lh * p.n_rows + r + 1];
  }

  // whether the current entry has an active fine cell in both the own
  // tile's rows and the sub-tile's rows starting at o0
  __device__ bool live(int o0) const {
    if (kf == 1) return true;
    const int r1 = min(kf - 1, (own0 + kBQ - 1 - own_base) / fine);
    const int c1 = min(kf - 1, (o0 + kBQ - 1 - base) / fine);
    for (int r = (own0 - own_base) / fine; r <= r1; ++r)
      for (int c = (o0 - base) / fine; c <= c1; ++c)
        if ((bits >> (r * kf + c)) & 1) return true;
    return false;
  }

  __device__ bool next(int& o0) {
    for (;;) {
      if (j == nsub) {
        if (e == e_end) return false;
        base = cols[e] * tile;
        bits = fmask[e];
        ++e;
        j = 0;
        nsub = tile / kBQ;
      }
      const int o = base + kBQ * j++;
      if (o >= len) {          // padding of the last layout block
        j = nsub;
        continue;
      }
      // columns ascend: past the diagonal nothing more is visible
      if (causal && !keys_own && o > own0 + kBQ - 1) return false;
      if (causal && keys_own && o + kBQ - 1 < own0) continue;
      if (!live(o)) continue;
      o0 = o;
      return true;
    }
  }

  __device__ bool ok(int own, int other) const {
    if (kf == 1) return true;
    return (bits >> (((own - own_base) / fine) * kf + (other - base) / fine))
           & 1;
  }

  // no fine bits: the walk's mask is the whole tile
  __device__ bool full(int, int) const { return kf == 1; }

  // the current entry (its first row and fine bits), which ok() reads
  __device__ int2 entry() const { return make_int2(base, bits); }
  __device__ void enter(int2 x) {
    base = x.x;
    bits = x.y;
  }

  static dim3 grid(const Params& p, int batch, bool) {
    return dim3(batch * p.heads, p.n_tiles);
  }
};

// Params of a square block-sparse call, or an invalid geometry (checked
// by run()/the caller: *ok = false)
Params sparse_params(const void* q, const void* k, const void* v,
                     const long long* strides, const int* row_ptr,
                     const int* cols, const int* fmask, const int* order,
                     int heads, int len, int layout_heads, int n_rows,
                     int tile, int fine, int causal, float scale, bool* ok) {
  Params p = make_params(q, k, v, strides, heads, len, len, causal, scale);
  p.row_ptr = row_ptr;
  p.cols = cols;
  p.fmask = fmask;
  p.order = order;
  p.layout_heads = layout_heads;
  p.n_rows = n_rows;
  p.n_tiles = (len + kBQ - 1) / kBQ;
  p.tile = tile;
  p.fine = fine;
  const int kf = fine > 0 ? tile / fine : 0;
  *ok = tile > 0 && tile % kBQ == 0 && fine > 0 && tile % fine == 0 &&
        kf * kf <= 31 && (layout_heads == 1 || layout_heads == heads) &&
        (long long)n_rows * tile >= len;
  return p;
}

}  // namespace

// The walk's index (built by ops/attention/block_sparse.py): row_ptr
// [layout_heads * n_rows + 1], cols and fmask [nnz], order [layout_heads,
// ceil(len / 64)] (tile ranks, heaviest first); tile = the index's row
// granularity, fine = the layout's block. q, k, v, do: [b, len, heads, d]
// through 12 element strides as in flash_attention.cu. dtype: 0 =
// float32, 1 = bfloat16, 2 = float16. Each returns a cudaError_t (0 = launched).
extern "C" int sparse_fwd(const void* q, const void* k, const void* v,
                          void* o, void* lse, const long long* strides,
                          const int* row_ptr, const int* cols,
                          const int* fmask, const int* order, int batch,
                          int heads, int len, int head_dim, int layout_heads,
                          int n_rows, int tile, int fine, int causal,
                          float scale, int dtype, void* stream) {
  bool ok;
  Params p = sparse_params(q, k, v, strides, row_ptr, cols, fmask, order,
                           heads, len, layout_heads, n_rows, tile, fine,
                           causal, scale, &ok);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  return run<SparseWalk>(kFwd, p, batch, head_dim, dtype, stream);
}

extern "C" int sparse_bwd_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq,
                             const long long* strides, const int* row_ptr,
                             const int* cols, const int* fmask,
                             const int* order, int batch, int heads, int len,
                             int head_dim, int layout_heads, int n_rows,
                             int tile, int fine, int causal, float scale,
                             int dtype, void* stream) {
  bool ok;
  Params p = sparse_params(q, k, v, strides, row_ptr, cols, fmask, order,
                           heads, len, layout_heads, n_rows, tile, fine,
                           causal, scale, &ok);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  p.dout = dout;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  return run<SparseWalk>(kDq, p, batch, head_dim, dtype, stream);
}

// the index here is the TRANSPOSED layout's (rows are key blocks)
extern "C" int sparse_bwd_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv,
                              const long long* strides, const int* row_ptr,
                              const int* cols, const int* fmask,
                              const int* order, int batch, int heads,
                              int len, int head_dim, int layout_heads,
                              int n_rows, int tile, int fine, int causal,
                              float scale, int dtype, void* stream) {
  bool ok;
  Params p = sparse_params(q, k, v, strides, row_ptr, cols, fmask, order,
                           heads, len, layout_heads, n_rows, tile, fine,
                           causal, scale, &ok);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  p.dout = dout;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  return run<SparseWalk>(kDkv, p, batch, head_dim, dtype, stream);
}
