// Flash-attention tile kernels shared by the dense and the block-sparse
// sources (flash_attention.cu, block_sparse.cu): online softmax with fp32
// statistics, the score tile never leaves the SM.
//
// Each kernel is a template over a Walk, the set of 64-row tiles one block
// visits. A block owns 64 rows (queries in the forward and dq kernels, keys
// in the dkv kernel) and visits tiles of the other side in order:
//   Walk walk(p, keys_own);   walk.own0, walk.bh: the block's own rows and
//                             (batch, head);
//   walk.next(o0)             the first row of the next tile to visit, false
//                             when done (uniform across the block);
//   walk.ok(own, other)       the walk's own mask of one entry, on top of
//                             the kernel's bounds and causal masks;
//   Walk::grid(p, batch, keys_own)  the launch grid.
// DenseWalk (flash_attention.cu) visits every tile the causal mask leaves;
// SparseWalk (block_sparse.cu) visits the tiles of a layout's active blocks
// and masks inside them by fine-cell bits.
//
// Design, per dtype: bf16 and fp16 run Hopper kernels (namespace hw
// below, templates over the element type T: the wgmma type, the pack to
// the operand type and the TMA map's data type follow it; a
// producer warp keeping a TMA ring of tiles in flight, a consumer
// warpgroup running every product as wgmma, the softmax of the forward
// and the p / ds of the backward pair in the accumulator registers); fp32
// runs scalar FMAs on tiles of fp32 in shared memory (rows padded by one
// float so the strided reads of a 16 x 8 thread grid hit distinct banks)
// with a 4 x 8 register tile of scores per thread, since the tensor cores
// would round fp32 to TF32.
//
// A Walk also says whether a tile needs its own mask:
//   walk.full(own0, o0)       true when walk.ok holds on the whole tile
//                             (the bf16 kernels then skip the mask
//                             arithmetic where no causal or length edge
//                             crosses the tile either);
//   walk.entry(), walk.enter(e)  what walk.ok reads of the current tile
//                             (SparseWalk: its entry's first row and fine
//                             bits), so that a walk which never calls next()
//                             can take it from one that does (the bf16
//                             backward's producer publishes it per stage);
//   Walk::kIndexed            whether walk.ok reads an index (fine bits):
//                             the bf16 backward gives that arithmetic the
//                             registers of one block fewer an SM at d 64.

// Numerics follow the TPU kernels: scores = (q . k) * scale in fp32,
// masked to NEG_INF = -1e30 (flash.py:42); a row whose running max is
// still NEG_INF is dead (p = 0, o = 0, lse = NEG_INF); p is rounded to
// the value dtype before P.V; the backward recomputes p = exp(s - lse)
// (0 where lse is NEG_INF), ds = p * (dp - delta) * scale with delta =
// sum(do * o) - dlse from the caller, and rounds p / ds to the operand
// dtype before the dV / dK / dQ products. Causal: query i sees keys
// j <= i + (k_len - q_len). The bf16 kernels take exp(x) as 2^(x log2 e)
// on the special-function unit (ex2.approx).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kTy = 16, kTx = 8;             // thread grid over a tile
constexpr int kBQ = 64, kBK = 64;            // queries x keys per tile
constexpr int kTM = kBQ / kTy;               // rows per thread (4)
constexpr int kTN = kBK / kTx;               // columns per thread (8)
constexpr int kLP = kBK + 1;                 // padded row of a score tile
static_assert(kTy * kTx == kThreads, "thread grid");
static_assert(kBQ == kBK, "the dkv kernel swaps the two roles");

// max / sum over the 8 lanes (tx = 0..7) that share one tile row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < kTx; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < kTx; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Params {
  const void *q, *k, *v, *dout;   // [b, len, heads, d] through the strides
  void *o, *dq, *dk, *dv;         // contiguous [b, len, heads, d]
  float* lse;                     // [b, heads, q_len] (written by the fwd)
  const float* delta;             // [b, heads, q_len]
  long long q_sb, q_sl, q_sh;     // element strides (head_dim stride is 1)
  long long k_sb, k_sl, k_sh;
  long long v_sb, v_sl, v_sh;
  long long do_sb, do_sl, do_sh;
  int heads, lq, lk, causal;
  float scale;
  int head_group;   // DenseWalk: heads whose tiles are launched together
  // the block-sparse walk's index (SparseWalk, block_sparse.cu; unused by
  // DenseWalk): per layout head, CSR rows of the layout's active blocks at
  // the tile granularity with their fine-cell bits, and the order in which
  // the own tiles are launched
  const int *row_ptr, *cols, *fmask, *order;
  int layout_heads, n_rows, n_tiles, tile, fine;
};

// rows [row0, row0 + kRows) of one (batch, head) slice -> fp32 shared tile
// [kRows][D + 1]; rows past n_valid are zero
template <int D, int kRows>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long row_stride, int row0,
                                          int n_valid) {
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        r < n_valid ? base[(long long)(row0 + r) * row_stride + c] : 0.f;
  }
}

// acc[i][j] += sum_c A[(ty + 16 i) * lda + c] * B[(tx + 8 j) * ldb + c]
// over c < n: a 4 x kN register tile of a product whose operands are both
// row-major in shared memory
template <int kN>
__device__ __forceinline__ void mma_rows(float (&acc)[kTM][kN],
                                         const float* A, int lda,
                                         const float* B, int ldb, int n,
                                         int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < n; ++c) {
    float a[kTM], b[kN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) a[i] = A[(ty + kTy * i) * lda + c];
#pragma unroll
    for (int j = 0; j < kN; ++j) b[j] = B[(tx + kTx * j) * ldb + c];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c A[(ty + 16 i) * lda + c] * B[c * ldb + tx + 8 j]
// over c < n: the second operand is k-major (P.V, dS.K, P^T.dO, ...)
template <int kN>
__device__ __forceinline__ void mma_cols(float (&acc)[kTM][kN],
                                         const float* A, int lda,
                                         const float* B, int ldb, int n,
                                         int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < n; ++c) {
    float a[kTM], b[kN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) a[i] = A[(ty + kTy * i) * lda + c];
#pragma unroll
    for (int j = 0; j < kN; ++j) b[j] = B[c * ldb + tx + kTx * j];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int kR, int kC>
__device__ __forceinline__ void zero(float (&x)[kR][kC]) {
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kC; ++j) x[i][j] = 0.f;
}

// ------------------------------------------------------------------ forward

template <int D, class Walk>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int LD = D + 1, TD = D / kTx;
  extern __shared__ float smem[];
  float* q_s = smem;                 // [kBQ][LD]
  float* k_s = q_s + kBQ * LD;       // [kBK][LD]
  float* v_s = k_s + kBK * LD;       // [kBK][LD]
  float* p_s = v_s + kBK * LD;       // [kBQ][kLP] probabilities

  Walk walk(p, false);
  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int q0 = walk.own0, bh = walk.bh;
  const int b = bh / p.heads, h = bh % p.heads;
  const int offset = p.lk - p.lq;
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  load_tile<D, kBQ>(q_s, qb, p.q_sl, q0, p.lq - q0);

  float m[kTM], l[kTM], acc[kTM][TD];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  zero(acc);

  int k0 = 0;
  while (walk.next(k0)) {
    __syncthreads();                 // the last tile's reads are done
    load_tile<D, kBK>(k_s, kb, p.k_sl, k0, p.lk - k0);
    load_tile<D, kBK>(v_s, vb, p.v_sl, k0, p.lk - k0);
    __syncthreads();

    float s[kTM][kTN];
    zero(s);
    mma_rows(s, q_s, LD, k_s, LD, D, ty, tx);

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = q0 + ty + kTy * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int col = k0 + tx + kTx * j;
        const bool ok = col < p.lk &&
                        (!p.causal || col <= row + offset) &&
                        walk.ok(row, col);
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const bool live = m_new > 0.5f * kNegInf;
      const float alpha = live ? expf(m[i] - m_new) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float e = live ? expf(s[i][j] - m_new) : 0.f;
        sum += e;
        p_s[(ty + kTy * i) * kLP + tx + kTx * j] = e;
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    mma_cols(acc, p_s, kLP, v_s, LD, kBK, ty, tx);
  }

  float* o = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = q0 + ty + kTy * i;
    if (row < p.lq) {
      const float ll = l[i] == 0.f ? 1.f : l[i];   // dead row -> zeros
      float* orow = o + (((long long)b * p.lq + row) * p.heads + h) * D;
#pragma unroll
      for (int j = 0; j < TD; ++j)
        orow[tx + kTx * j] = acc[i][j] / ll;
      if (tx == 0) p.lse[(long long)bh * p.lq + row] = m[i] + logf(ll);
    }
  }
}

// ------------------------------------------------------------- backward dq

template <int D, class Walk>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const Params p) {
  constexpr int LD = D + 1, TD = D / kTx;
  extern __shared__ float smem[];
  float* q_s = smem;                 // [kBQ][LD]
  float* do_s = q_s + kBQ * LD;      // [kBQ][LD]
  float* k_s = do_s + kBQ * LD;      // [kBK][LD]
  float* v_s = k_s + kBK * LD;       // [kBK][LD]
  float* ds_s = v_s + kBK * LD;      // [kBQ][kLP]

  Walk walk(p, false);
  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int q0 = walk.own0, bh = walk.bh;
  const int b = bh / p.heads, h = bh % p.heads;
  const int offset = p.lk - p.lq;
  load_tile<D, kBQ>(
      q_s, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh,
      p.q_sl, q0, p.lq - q0);
  load_tile<D, kBQ>(
      do_s, static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh,
      p.do_sl, q0, p.lq - q0);
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;

  float lse[kTM], delta[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = q0 + ty + kTy * i;
    const long long at = (long long)bh * p.lq + row;
    lse[i] = row < p.lq ? p.lse[at] : kNegInf;
    delta[i] = row < p.lq ? p.delta[at] : 0.f;
  }
  float dq[kTM][TD];
  zero(dq);

  int k0 = 0;
  while (walk.next(k0)) {
    __syncthreads();
    load_tile<D, kBK>(k_s, kb, p.k_sl, k0, p.lk - k0);
    load_tile<D, kBK>(v_s, vb, p.v_sl, k0, p.lk - k0);
    __syncthreads();

    float s[kTM][kTN], dp[kTM][kTN];
    zero(s);
    zero(dp);
    mma_rows(s, q_s, LD, k_s, LD, D, ty, tx);
    mma_rows(dp, do_s, LD, v_s, LD, D, ty, tx);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = q0 + ty + kTy * i;
      const bool live = lse[i] > 0.5f * kNegInf;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int col = k0 + tx + kTx * j;
        const bool ok = live && col < p.lk &&
                        (!p.causal || col <= row + offset) &&
                        walk.ok(row, col);
        const float pr = ok ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
        ds_s[(ty + kTy * i) * kLP + tx + kTx * j] =
            pr * (dp[i][j] - delta[i]) * p.scale;
      }
    }
    __syncthreads();
    mma_cols(dq, ds_s, kLP, k_s, LD, kBK, ty, tx);
  }

  float* out = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = q0 + ty + kTy * i;
    if (row < p.lq) {
      float* r = out + (((long long)b * p.lq + row) * p.heads + h) * D;
#pragma unroll
      for (int j = 0; j < TD; ++j) r[tx + kTx * j] = dq[i][j];
    }
  }
}

// ------------------------------------------------------------ backward dkv
// The tile's rows are keys and its columns queries: S^T = K.Q^T,
// dP^T = V.dO^T, then dV += P^T.dO and dK += dS^T.Q over every query tile.

template <int D, class Walk>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const Params p) {
  constexpr int LD = D + 1, TD = D / kTx;
  extern __shared__ float smem[];
  float* k_s = smem;                 // [kBK][LD]
  float* v_s = k_s + kBK * LD;       // [kBK][LD]
  float* q_s = v_s + kBK * LD;       // [kBQ][LD]
  float* do_s = q_s + kBQ * LD;      // [kBQ][LD]
  float* p_s = do_s + kBQ * LD;      // [kBK][kLP] p^T in the value dtype
  float* ds_s = p_s + kBK * kLP;     // [kBK][kLP] fp32 p^T, then ds^T
  float* lse_s = ds_s + kBK * kLP;   // [kBQ]
  float* delta_s = lse_s + kBQ;      // [kBQ]

  Walk walk(p, true);
  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const int k0 = walk.own0, bh = walk.bh;
  const int b = bh / p.heads, h = bh % p.heads;
  const int offset = p.lk - p.lq;
  load_tile<D, kBK>(
      k_s, static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh,
      p.k_sl, k0, p.lk - k0);
  load_tile<D, kBK>(
      v_s, static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh,
      p.v_sl, k0, p.lk - k0);
  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dob =
      static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;

  float dk[kTM][TD], dv[kTM][TD];
  zero(dk);
  zero(dv);

  int q0 = 0;
  while (walk.next(q0)) {
    __syncthreads();
    load_tile<D, kBQ>(q_s, qb, p.q_sl, q0, p.lq - q0);
    load_tile<D, kBQ>(do_s, dob, p.do_sl, q0, p.lq - q0);
    for (int i = tid; i < kBQ; i += kThreads) {
      const bool in = q0 + i < p.lq;
      const long long at = (long long)bh * p.lq + q0 + i;
      lse_s[i] = in ? p.lse[at] : kNegInf;
      delta_s[i] = in ? p.delta[at] : 0.f;
    }
    __syncthreads();

    {  // p^T, kept in fp32 in ds_s until dp^T is ready
      float st[kTM][kTN];
      zero(st);
      mma_rows(st, k_s, LD, q_s, LD, D, ty, tx);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int key = k0 + ty + kTy * i;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int qc = tx + kTx * j, row = q0 + qc;
          const float lse = lse_s[qc];
          const bool ok = lse > 0.5f * kNegInf && key < p.lk && row < p.lq &&
                          (!p.causal || key <= row + offset) &&
                          walk.ok(key, row);
          const float pr = ok ? expf(st[i][j] * p.scale - lse) : 0.f;
          const int at = (ty + kTy * i) * kLP + qc;
          ds_s[at] = pr;
          p_s[at] = pr;
        }
      }
    }
    {  // ds^T = p^T * (dp^T - delta) * scale (each thread its own entries)
      float dpt[kTM][kTN];
      zero(dpt);
      mma_rows(dpt, v_s, LD, do_s, LD, D, ty, tx);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          const int qc = tx + kTx * j, at = (ty + kTy * i) * kLP + qc;
          ds_s[at] = ds_s[at] * (dpt[i][j] - delta_s[qc]) * p.scale;
        }
    }
    __syncthreads();
    mma_cols(dv, p_s, kLP, do_s, LD, kBQ, ty, tx);
    mma_cols(dk, ds_s, kLP, q_s, LD, kBQ, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int key = k0 + ty + kTy * i;
    if (key < p.lk) {
      const long long at = (((long long)b * p.lk + key) * p.heads + h) * D;
      float* rk = static_cast<float*>(p.dk) + at;
      float* rv = static_cast<float*>(p.dv) + at;
#pragma unroll
      for (int j = 0; j < TD; ++j) {
        rk[tx + kTx * j] = dk[i][j];
        rv[tx + kTx * j] = dv[i][j];
      }
    }
  }
}

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

// ------------------------------ bf16 / fp16 forward for Hopper (hw)
// flash_fwd_wgmma_kernel: one block of a consumer warpgroup and a
// producer warp owns 64 query rows.
//   - one thread of the producer warp loads the block's Q tile once, then
//     keeps kStages stages of K and V tiles in flight by TMA
//     (cp.async.bulk.tensor through host-built tensor maps, 128-byte
//     swizzle; 64-byte at d 32; the hardware zero-fills rows past the
//     length), each stage with a full barrier and an empty barrier for
//     K and for V: K is released once its scores are done and loaded a
//     tile ahead of V;
//   - the consumer warpgroup runs S = Q.K^T as wgmma m64n64k16 (both
//     operands K-major in shared memory), the online softmax on S in
//     registers (a row's 16 entries of a thread sit in a quad of lanes,
//     so a row max is two shuffles; the row sum stays per thread until
//     the end; exp is one ex2 each), rescales the O accumulator in
//     registers by alpha (skipped where no row of the warp moved its
//     max, since alpha is then exactly 1), packs P to bf16 straight
//     from the accumulator layout into the A operand of O += P.V (wgmma
//     m64nDk16, P from registers, V MN-major through the transpose
//     flag), and releases the stage. It is software
//     pipelined: tile t's S is issued with tile t-1's P.V, and tile t's
//     softmax runs while P.V is on the tensor cores;
//   - the mask arithmetic runs only on tiles that cross the causal
//     diagonal or the ragged edge of the keys, or whose walk says that
//     not all of the tile is live (Walk::full);
//   - two blocks fit an SM at every head dim (registers: 147 a thread at
//     d 128 under a 168 ceiling; shared memory: 81 KB at d 128, 57 KB at
//     d 64). A producer warpgroup that hands its registers to the
//     consumers (setmaxnreg) was measured and dropped: ptxas still held
//     the consumers to the launch ceiling of a 256-thread block (128 at
//     two blocks an SM), so d 128 spilled, and the 160-thread block ran
//     faster at every shape; so did Q in shared memory against Q held in
//     registers as the scores' A operand, and one block per query tile
//     against a persistent grid of resident blocks that walk several
//     (PERF.md).
namespace hw {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kHwThreads = 160;    // consumer warpgroup + producer warp

template <int D>
struct FwdCfg {
  static constexpr int kBox = D < 64 ? D : 64;     // columns of a TMA box
  static constexpr int kRowBytes = kBox * 2;       // the swizzle span
  static constexpr int kBoxBytes = 64 * kRowBytes; // one 64-row box
  static constexpr int kTileBytes = 64 * D * 2;    // a 64-row Q / K / V tile
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kMinBlocks = 2;             // per SM
  static constexpr uint32_t kSwizzle = D < 64 ? 2 : 1;  // 64 B : 128 B
  // the 1024-byte alignment slack, Q, the K / V ring, 1 + 4 x kStages
  // barriers
  static constexpr int kSmem =
      1024 + kTileBytes * (1 + 2 * kStages) + 8 * (1 + 4 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::
               "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::
               "r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` of TMA copies this phase
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
      "r"(smem_u32(bar)), "r"(bytes) : "memory");
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
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// a 64-row box of a [batch, len, heads, d] operand (tensor map dims d,
// head, position, batch) -> shared memory, counted on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int h,
                                         int row0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
      "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(d0), "r"(h), "r"(row0), "r"(b)
      : "memory");
}

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle mode
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t mode) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)mode << 62);
}

// K-major tile (Q or K: 64 rows of D, boxes of kBox columns): k-step kk
// covers columns [16 kk, 16 kk + 16); 8-row groups are 8 swizzled rows
// apart
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int kk) {
  using C = FwdCfg<D>;
  const int col = 16 * kk;
  return make_desc(tile + (col / C::kBox) * C::kBoxBytes +
                       (col % C::kBox) * 2,
                   16, 8 * C::kRowBytes, C::kSwizzle);
}

// MN-major tile (V: 64 keys of D, the product's N = D): k-step kk covers
// keys [16 kk, 16 kk + 16); the boxes are the MN atoms (LBO), 8-key
// groups are 8 rows apart (SBO)
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int kk) {
  using C = FwdCfg<D>;
  return make_desc(tile + 16 * kk * C::kRowBytes, C::kBoxBytes,
                   8 * C::kRowBytes, C::kSwizzle);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence / wait that bounds it
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i]) :: "memory");
}

// d[32] (+)= A . B^T, m64n64k16: A and B from shared memory, both
// K-major; scale_d = 0 overwrites d
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(
    float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
#define HW_ASM(TY) \
  asm volatile( \
      "{\n .reg .pred p;\n" \
      " setp.ne.b32 p, %34, 0;\n" \
      " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7," \
      " %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(a), "l"(b), "r"(scale_d))
  if constexpr (std::is_same<T, __half>::value) HW_ASM("f16");
  else HW_ASM("bf16");
#undef HW_ASM
}

// d[32] = A . B^T, m64n64k16, both K-major: the first k-step of a
// product, which overwrites d; d is an output only, so its old values
// need not stay live in registers up to the issue
template <typename T>
__device__ __forceinline__ void wgmma_ss_n64_first(
    float (&d)[32], uint64_t a, uint64_t b) {
#define HW_ASM(TY) \
  asm volatile( \
      "{\n .reg .pred p;\n" \
      " setp.ne.b32 p, %34, 0;\n" \
      " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7," \
      " %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), \
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), \
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), \
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), \
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), \
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), \
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), \
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]) \
      : "l"(a), "l"(b), "r"(0))
  if constexpr (std::is_same<T, __half>::value) HW_ASM("f16");
  else HW_ASM("bf16");
#undef HW_ASM
}

// d[16] += A . B, m64n32k16: A (bf16 pairs) from registers, B from
// shared memory, MN-major (the transpose flag)
template <typename T>
__device__ __forceinline__ void wgmma_rs_n32(
    float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
#define HW_ASM(TY) \
  asm volatile( \
      "{\n .reg .pred p;\n" \
      " setp.ne.b32 p, %21, 0;\n" \
      " wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7," \
      " %8, %9, %10, %11, %12, %13, %14, %15}, " \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
  if constexpr (std::is_same<T, __half>::value) HW_ASM("f16");
  else HW_ASM("bf16");
#undef HW_ASM
}

// d[32] += A . B, m64n64k16: A (bf16 pairs) from registers, B from
// shared memory, MN-major (the transpose flag)
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
#define HW_ASM(TY) \
  asm volatile( \
      "{\n .reg .pred p;\n" \
      " setp.ne.b32 p, %37, 0;\n" \
      " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7," \
      " %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
  if constexpr (std::is_same<T, __half>::value) HW_ASM("f16");
  else HW_ASM("bf16");
#undef HW_ASM
}

// d[64] += A . B, m64n128k16: A (bf16 pairs) from registers, B from
// shared memory, MN-major (the transpose flag)
template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(
    float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
#define HW_ASM(TY) \
  asm volatile( \
      "{\n .reg .pred p;\n" \
      " setp.ne.b32 p, %69, 0;\n" \
      " wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7," \
      " %8, %9, %10, %11, %12, %13, %14, %15," \
      " %16, %17, %18, %19, %20, %21, %22, %23," \
      " %24, %25, %26, %27, %28, %29, %30, %31," \
      " %32, %33, %34, %35, %36, %37, %38, %39," \
      " %40, %41, %42, %43, %44, %45, %46, %47," \
      " %48, %49, %50, %51, %52, %53, %54, %55," \
      " %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
  if constexpr (std::is_same<T, __half>::value) HW_ASM("f16");
  else HW_ASM("bf16");
#undef HW_ASM
}

template <typename T, int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (D == 32) wgmma_rs_n32<T>(d, a, b);
  else if constexpr (D == 64) wgmma_rs_n64<T>(d, a, b);
  else wgmma_rs_n128<T>(d, a, b);
}

// 2^x on the special-function unit, one instruction (ex2.approx.ftz:
// relative error ~2^-22, a result below 2^-126 flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to T (bf16 or fp16, to nearest even) in one
// register, lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 x = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&x);
  } else {
    const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&x);
  }
}

template <typename T, int D, class Walk>
__global__ void __launch_bounds__(kHwThreads, FwdCfg<D>::kMinBlocks)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           const Params p) {
  using C = FwdCfg<D>;
  constexpr int S = C::kStages;
  extern __shared__ __align__(1024) unsigned char fwd_smem[];
  // the 128-byte swizzle pattern repeats every 1024 bytes: align to it
  unsigned char* base =
      fwd_smem + ((1024 - (smem_u32(fwd_smem) & 1023)) & 1023);
  unsigned char* q_s = base;                          // [64][D], boxed
  unsigned char* ring = base + C::kTileBytes;         // stage: K, then V
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(ring + 2 * S * C::kTileBytes);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* k_empty = v_full + S;      // K's scores done: reload the stage
  uint64_t* v_empty = k_empty + S;     // V's P.V done

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&k_empty[st], 128);      // every consumer thread
      mbar_init(&v_empty[st], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  Walk walk(p, false);
  const int q0 = walk.own0, bh = walk.bh;
  const int b = bh / p.heads, h = bh % p.heads;

  if (tid >= 128) {                     // ---- producer warp
    if (tid == 128) {
      mbar_arrive_expect(q_full, C::kTileBytes);
#pragma unroll
      for (int x = 0; x < D / C::kBox; ++x)
        tma_load(q_s + x * C::kBoxBytes, &map_q, q_full, x * C::kBox, h,
                 q0, b);
      // K runs a tile ahead of V (K0, K1, V0, K2, V1, ...): a stage's K
      // is free once its scores are done, its V only after P.V, so the
      // next K goes out while the consumers still multiply by this V
      auto load = [&](const CUtensorMap* map, uint64_t* bar, int st,
                      int row0, int off) {
        unsigned char* dst = ring + (2 * st + off) * C::kTileBytes;
        mbar_arrive_expect(bar, C::kTileBytes);
#pragma unroll
        for (int x = 0; x < D / C::kBox; ++x)
          tma_load(dst + x * C::kBoxBytes, map, bar, x * C::kBox, h, row0,
                   b);
      };
      int k0 = 0, st = 0, round = 0;
      int v_k0 = -1, v_st = 0, v_round = 0;     // the V still to load
      while (walk.next(k0)) {
        if (round > 0) mbar_wait(&k_empty[st], (round - 1) & 1);
        load(&map_k, &k_full[st], st, k0, 0);
        if (v_k0 >= 0) {
          if (v_round > 0) mbar_wait(&v_empty[v_st], (v_round - 1) & 1);
          load(&map_v, &v_full[v_st], v_st, v_k0, 1);
        }
        v_k0 = k0;
        v_st = st;
        v_round = round;
        if (++st == S) {
          st = 0;
          ++round;
        }
      }
      if (v_k0 >= 0) {
        if (v_round > 0) mbar_wait(&v_empty[v_st], (v_round - 1) & 1);
        load(&map_v, &v_full[v_st], v_st, v_k0, 1);
      }
    }
    return;
  }

  // ---- consumer warpgroup: rows r and r + 8 of the tile, columns
  // 8 j + c and 8 j + c + 1 of every 8-column group j
  const int warp = tid / 32, lane = tid % 32;
  const int r = 16 * warp + lane / 4, c = 2 * (lane % 4);
  const int offset = p.lk - p.lq;
  const int rows[2] = {q0 + r, q0 + r + 8};
  const uint32_t q_addr = smem_u32(q_s);
  float o[D / 2], s[32];
  uint32_t pk[16];                     // P in the A layout of P.V
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // l: this thread's
  mbar_wait(q_full, 0);

  // S = Q.K^T of the tile in stage st, issued (not waited for)
  auto issue_scores = [&](int st) {
    const uint32_t k_addr = smem_u32(ring + 2 * st * C::kTileBytes);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64<T>(s, desc_kmajor<D>(q_addr, kk), desc_kmajor<D>(k_addr, kk),
                   kk > 0);
    wg_commit();
  };
  // O += P.V of the tile in stage st, P from the packed registers
  auto issue_pv = [&](int st) {
    const uint32_t v_addr =
        smem_u32(ring + (2 * st + 1) * C::kTileBytes);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                             pk[4 * kk + 3]};
      wgmma_rs<T, D>(o, a, desc_mnmajor<D>(v_addr, kk));
    }
    wg_commit();
  };
  // the online softmax of the scores of key tile k0, in place: s becomes
  // p (fp32), m and l move on, alpha rescales what O holds so far
  auto softmax = [&](int k0, float (&alpha)[2]) {
    // s[4 j + 2 i + e]: row rows[i], column k0 + 8 j + c + e
    const bool masked = k0 + kBK > p.lk ||
                        (p.causal && k0 + kBK - 1 > q0 + offset) ||
                        !walk.full(q0, k0);
    if (masked) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = rows[i], col = k0 + 8 * j + c + e;
            const bool ok = col < p.lk &&
                            (!p.causal || col <= row + offset) &&
                            walk.ok(row, col);
            float& x = s[4 * j + 2 * i + e];
            x = ok ? x * p.scale : kNegInf;
          }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= p.scale;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the row max over the thread's 16 entries as a tree, then the quad
      float mj[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mj[j] = fmaxf(fmaxf(s[8 * j + 2 * i], s[8 * j + 2 * i + 1]),
                      fmaxf(s[8 * j + 4 + 2 * i], s[8 * j + 5 + 2 * i]));
      float mx = fmaxf(fmaxf(mj[0], mj[1]), fmaxf(mj[2], mj[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      // a dead row (max still NEG_INF) subtracts 0, so every exp2 of
      // NEG_INF * log2e is 0: p = 0, and alpha = 0 once the row lives
      const float ms = m_new > 0.5f * kNegInf ? m_new * kLog2e : 0.f;
      alpha[i] = ex2(m[i] * kLog2e - ms);
      float sum[2] = {0.f, 0.f};       // two chains of adds, not one
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * i + e];
          x = ex2(fmaf(x, kLog2e, -ms));
          sum[e] += x;
        }
      l[i] = alpha[i] * l[i] + (sum[0] + sum[1]);
      m[i] = m_new;
    }
  };
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
    // alpha is exactly 1 where a row's max did not move: skip the
    // products when that holds for every row of the warp (x * 1 = x)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          o[4 * j + 2 * i] *= alpha[i];
          o[4 * j + 2 * i + 1] *= alpha[i];
        }
    }
#pragma unroll
    for (int t = 0; t < 16; ++t) pk[t] = pack<T>(s[2 * t], s[2 * t + 1]);
  };

  // Software pipeline over the walk: tile t's scores are issued together
  // with tile t-1's P.V, and tile t's softmax runs while P.V is still on
  // the tensor cores; O is rescaled once P.V has landed. The arithmetic
  // and its order are those of a serial loop.
  int k0 = 0, st = 0;
  unsigned phase = 0;
  if (walk.next(k0)) {
    float alpha[2];
    mbar_wait(&k_full[st], phase);
    fence_regs(s);
    wg_fence();
    issue_scores(st);
    wg_wait<0>();
    fence_regs(s);
    mbar_arrive(&k_empty[st]);
    softmax(k0, alpha);
    rescale_and_pack(alpha);
    int prev = st;
    unsigned prev_phase = phase;
    if (++st == S) {
      st = 0;
      phase ^= 1;
    }
    while (walk.next(k0)) {
      mbar_wait(&k_full[st], phase);
      fence_regs(s);
      fence_regs(o);
      fence_regs(pk);
      wg_fence();
      issue_scores(st);
      mbar_wait(&v_full[prev], prev_phase);
      issue_pv(prev);
      wg_wait<1>();                    // the scores; P.V may still run
      fence_regs(s);
      mbar_arrive(&k_empty[st]);
      softmax(k0, alpha);
      wg_wait<0>();
      fence_regs(o);
      fence_regs(pk);
      mbar_arrive(&v_empty[prev]);
      rescale_and_pack(alpha);
      prev = st;
      prev_phase = phase;
      if (++st == S) {
        st = 0;
        phase ^= 1;
      }
    }
    mbar_wait(&v_full[prev], prev_phase);
    fence_regs(o);
    fence_regs(pk);
    wg_fence();
    issue_pv(prev);
    wg_wait<0>();
    fence_regs(o);
    fence_regs(pk);
    mbar_arrive(&v_empty[prev]);
  }

  T* out = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float ll = li == 0.f ? 1.f : li;   // dead row -> zeros
    const float inv = 1.f / ll;
    const int row = rows[i];
    if (row < p.lq) {
      T* dst = out + (((long long)b * p.lq + row) * p.heads + h) * D + c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack<T>(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      if (c == 0) p.lse[(long long)bh * p.lq + row] = m[i] + logf(ll);
    }
  }
}

// ----------------------------- bf16 / fp16 backward for Hopper (hw)
// flash_bwd_dq_wgmma_kernel (a block owns 64 query rows and walks key
// tiles) and flash_bwd_dkv_wgmma_kernel (64 key rows, walks query tiles)
// share one body, flash_bwd_wgmma, and the forward's block: a consumer
// warpgroup and a producer warp.
//   - the producer warp loads the block's own pair of tiles once (Q and
//     dO, or K and V), then keeps kStages stages of the walked pair in
//     flight by TMA (K and V, or Q and dO), one full and one empty
//     barrier a stage: a stage is free once the products that read it are
//     done. For dkv its 32 lanes also load the query tile's lse and delta
//     with ordinary loads and store them to the stage as the consumer
//     uses them: lse times log2 e (+1e30 for a dead row or one past
//     q_len, so that its p is 2^-1e30 = 0) and delta times scale;
//   - the consumer warpgroup runs the two score-side products as wgmma
//     m64n64k16, both operands K-major in shared memory (dq: S = Q.K^T
//     and dP = dO.V^T; dkv: S^T = K.Q^T and dP^T = V.dO^T), makes p and ds
//     from their accumulator registers (p = 2^(s scale log2 e -
//     lse log2 e), ds = p (dp scale - delta scale): one ex2 and three
//     FMA-pipe operations an entry), packs them to bf16 straight into A
//     operand registers and runs the accumulating products from registers
//     with the walked tile MN-major (the transpose flag): dQ += dS.K, or
//     dV += P^T.dO and dK += dS^T.Q; the sums stay in registers to the end;
//   - each block runs its tiles in order (scores, p / ds, products) and
//     the blocks sharing an SM overlap one another: three an SM for dq at
//     d <= 64 (128 registers a thread), two for dq at d 128 and dkv at
//     d <= 64 (168: two 160-thread blocks put three warps on one of the
//     SM's four 16K-register files), one for dkv at d 128 (dK and dV
//     alone take 128 registers); at d 64 an indexed walk (SparseWalk,
//     whose mask reads fine bits) takes one block fewer, since its mask
//     arithmetic tipped both kernels over those ceilings. Issuing tile
//     t's score-side products with tile t-1's accumulating ones, as the
//     forward does, needs S, dP and the packed p / ds live at once: 32 to
//     64 registers more, which spilled at two blocks an SM or ran slower
//     at one (PERF.md);
//   - the mask arithmetic runs only on tiles that cross the causal
//     diagonal or the ragged edge of the keys, or that the walk does not
//     fully admit; query rows past q_len need no mask: TMA zero-fills
//     their Q and dO, and their lse marks them dead;
//   - no atomics: a block writes only its own rows, each sum is taken in
//     the walk's fixed order, so two runs give the same bits.
template <int D, bool kKeysOwn, bool kIndexed>
struct BwdCfg {
  static constexpr int kTileBytes = FwdCfg<D>::kTileBytes;
  static constexpr int kFewer = D == 128 || (kIndexed && D == 64) ? 1 : 0;
  static constexpr int kMinBlocks = (kKeysOwn ? 2 : 3) - kFewer;  // per SM
  static constexpr int kStages = D == 128 && !kKeysOwn ? 2 : 3;
  static constexpr int kStatBytes = kKeysOwn ? 2 * kBQ * 4 : 0;  // lse, delta
  // the 1024-byte alignment slack, the own pair, the ring of walked pairs,
  // their lse / delta, their tiles' int4, 1 + 2 x kStages barriers
  static constexpr int kSmem = 1024 + kTileBytes * (2 + 2 * kStages) +
                               (kStatBytes + 16) * kStages +
                               8 * (1 + 2 * kStages);
};

// the tx-count of the phase grows by `bytes` of TMA copies (no arrival)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

template <typename T, int D, bool kKeysOwn, class Walk>
__device__ __forceinline__ void flash_bwd_wgmma(const CUtensorMap& map_q,
                                                const CUtensorMap& map_k,
                                                const CUtensorMap& map_v,
                                                const CUtensorMap& map_do,
                                                const Params& p) {
  using C = BwdCfg<D, kKeysOwn, Walk::kIndexed>;
  using F = FwdCfg<D>;
  constexpr int S = C::kStages;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  unsigned char* base =
      bwd_smem + ((1024 - (smem_u32(bwd_smem) & 1023)) & 1023);
  unsigned char* own = base;                     // 2 tiles, boxed
  unsigned char* ring = own + 2 * C::kTileBytes; // stage st: 2 st, 2 st + 1
  float* stats =                                 // stage st: lse, delta
      reinterpret_cast<float*>(ring + 2 * S * C::kTileBytes);
  // stage st's tile: its first row (-1: the walk is done) and
  // walk.entry(), published by the producer so that the consumer's walk
  // keeps no state of its own through the loop
  int4* tiles = reinterpret_cast<int4*>(
      reinterpret_cast<unsigned char*>(stats) + S * C::kStatBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(tiles + S);
  uint64_t* own_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + S;          // the stage's products are done

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(own_full, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(&full[st], 32);        // every producer lane
      mbar_init(&empty[st], 128);      // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  Walk walk(p, kKeysOwn);
  const int own0 = walk.own0, bh = walk.bh;

  if (tid >= 128) {                     // ---- producer warp
    const int lane = tid - 128;
    const int b = bh / p.heads, h = bh % p.heads;
    auto load = [&](unsigned char* dst, const CUtensorMap* map,
                    uint64_t* bar, int row0) {
#pragma unroll
      for (int x = 0; x < D / F::kBox; ++x)
        tma_load(dst + x * F::kBoxBytes, map, bar, x * F::kBox, h, row0, b);
    };
    if (lane == 0) {
      mbar_arrive_expect(own_full, 2 * C::kTileBytes);
      load(own, kKeysOwn ? &map_k : &map_q, own_full, own0);
      load(own + C::kTileBytes, kKeysOwn ? &map_v : &map_do, own_full,
           own0);
    }
    int o0 = 0, st = 0, round = 0;
    for (;;) {
      const bool more = walk.next(o0);
      if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
      if (lane == 0) {
        const int2 entry = walk.entry();
        tiles[st] = make_int4(more ? o0 : -1, entry.x, entry.y, 0);
        if (more) {
          unsigned char* dst = ring + 2 * st * C::kTileBytes;
          mbar_expect_tx(&full[st], 2 * C::kTileBytes);
          load(dst, kKeysOwn ? &map_q : &map_k, &full[st], o0);
          load(dst + C::kTileBytes, kKeysOwn ? &map_do : &map_v,
               &full[st], o0);
        }
      }
      if constexpr (kKeysOwn) {        // rows o0 + 2 lane, + 1
        if (more) {
          float l[2], d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = o0 + 2 * lane + e;
            const bool in = row < p.lq;
            const long long at = (long long)bh * p.lq + row;
            const float x = in ? p.lse[at] : kNegInf;
            l[e] = x > 0.5f * kNegInf ? x * kLog2e : -kNegInf;
            d[e] = in ? p.delta[at] * p.scale : 0.f;
          }
          float* dst = stats + 2 * kBQ * st + 2 * lane;
          *reinterpret_cast<float2*>(dst) = make_float2(l[0], l[1]);
          *reinterpret_cast<float2*>(dst + kBQ) = make_float2(d[0], d[1]);
        }
      }
      mbar_arrive(&full[st]);          // release: the stores above
      if (!more) break;
      if (++st == S) {
        st = 0;
        ++round;
      }
    }
    return;
  }

  // ---- consumer warpgroup: own rows row0 and row0 + 8 (i = 0, 1), walked
  // columns 8 j + c and 8 j + c + 1 of every 8-column group j; what the
  // epilogue alone needs is computed there, so it holds no register
  // through the loop
  const int lane = tid % 32;
  const int row0 = own0 + 16 * (tid / 32) + lane / 4, c = 2 * (lane % 4);
  const float scale_log2 = p.scale * kLog2e;
  // dq: the rows' lse and delta as the producer stages them for dkv (lse
  // times log2 e, +1e30 for a dead row; delta times scale)
  float lse2[2] = {0.f, 0.f}, dls[2] = {0.f, 0.f};
  if constexpr (!kKeysOwn) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long at = (long long)bh * p.lq + row0 + 8 * i;
      const bool in = row0 + 8 * i < p.lq;
      const float l = in ? p.lse[at] : kNegInf;
      lse2[i] = l > 0.5f * kNegInf ? l * kLog2e : -kNegInf;
      dls[i] = in ? p.delta[at] * p.scale : 0.f;
    }
  }
  // dx: dQ or dK; dv: dV (dkv only); s, dp: the score-side products;
  // pds, pp: ds and p as bf16 A operands
  float dx[D / 2], dv[kKeysOwn ? D / 2 : 1], s[32], dp[32];
  uint32_t pds[16], pp[kKeysOwn ? 16 : 1];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dx[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kKeysOwn ? D / 2 : 1); ++i) dv[i] = 0.f;
  const uint32_t own_addr = smem_u32(own);
  mbar_wait(own_full, 0);

  // dq: S = Q.K^T and dP = dO.V^T; dkv: S^T = K.Q^T and dP^T = V.dO^T,
  // of the walked pair in stage st, issued (not waited for)
  auto issue_scores = [&](int st) {
    const uint32_t w = smem_u32(ring + 2 * st * C::kTileBytes);
    wgmma_ss_n64_first<T>(s, desc_kmajor<D>(own_addr, 0), desc_kmajor<D>(w, 0));
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      wgmma_ss_n64<T>(s, desc_kmajor<D>(own_addr, kk), desc_kmajor<D>(w, kk),
                   1);
    const uint32_t a1 = own_addr + C::kTileBytes, w1 = w + C::kTileBytes;
    wgmma_ss_n64_first<T>(dp, desc_kmajor<D>(a1, 0), desc_kmajor<D>(w1, 0));
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      wgmma_ss_n64<T>(dp, desc_kmajor<D>(a1, kk), desc_kmajor<D>(w1, kk), 1);
    wg_commit();
  };
  // dq: dQ += dS.K; dkv: dV += P^T.dO and dK += dS^T.Q; the walked tile is
  // the MN-major B
  auto issue_grads = [&](int st) {
    const uint32_t w = smem_u32(ring + 2 * st * C::kTileBytes);
    if constexpr (kKeysOwn) {
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk) {
        const uint32_t a[4] = {pp[4 * kk], pp[4 * kk + 1], pp[4 * kk + 2],
                               pp[4 * kk + 3]};
        wgmma_rs<T, D>(dv, a, desc_mnmajor<D>(w + C::kTileBytes, kk));
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pds[4 * kk], pds[4 * kk + 1], pds[4 * kk + 2],
                             pds[4 * kk + 3]};
      wgmma_rs<T, D>(dx, a, desc_mnmajor<D>(w, kk));
    }
    wg_commit();
  };
  // p and ds of the walked tile at o0 (stage st) from s and dp, packed
  // to bf16 A operands, one 8-column group at a time (dkv reads the
  // group's lse and delta there); the mask arithmetic is compiled into a
  // second copy of the loop that only masked tiles run. s[4 j + 2 i + e],
  // dp[...]: row row0 + 8 i, column o0 + 8 j + c + e; pds[2 j + i] packs its
  // e = 0, 1. dkv packs p and ds as they are made, which frees s and dp
  // early (it also holds dK and dV); dq keeps ds in dp and packs it after
  // the loop, which ptxas fits in the 128 registers of three blocks an SM
  // (packing as made spilled there)
  auto make_p_ds = [&](int o0, int st) {
    auto run = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float l2[2] = {lse2[0], lse2[1]}, dl[2] = {dls[0], dls[1]};
        if constexpr (kKeysOwn) {      // by column e, not by row
          const float* col = stats + 2 * kBQ * st + 8 * j + c;
          const float2 l = *reinterpret_cast<const float2*>(col);
          const float2 d = *reinterpret_cast<const float2*>(col + kBQ);
          l2[0] = l.x;
          l2[1] = l.y;
          dl[0] = d.x;
          dl[1] = d.y;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float pr[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int at = 4 * j + 2 * i + e, k = kKeysOwn ? e : i;
            pr[e] = ex2(fmaf(s[at], scale_log2, -l2[k]));
            if constexpr (decltype(masked)::value) {
              const int row = row0 + 8 * i, col = o0 + 8 * j + c + e;
              const int offset = p.lk - p.lq;
              const bool ok =
                  kKeysOwn ? (!p.causal || row <= col + offset) &&
                                 walk.ok(row, col)
                           : col < p.lk &&
                                 (!p.causal || col <= row + offset) &&
                                 walk.ok(row, col);
              if (!ok) pr[e] = 0.f;
            }
            ds[e] = pr[e] * fmaf(dp[at], p.scale, -dl[k]);
          }
          if constexpr (kKeysOwn) {
            pds[2 * j + i] = pack<T>(ds[0], ds[1]);
            pp[2 * j + i] = pack<T>(pr[0], pr[1]);
          } else {
            dp[4 * j + 2 * i] = ds[0];
            dp[4 * j + 2 * i + 1] = ds[1];
          }
        }
      }
    };
    const int offset = p.lk - p.lq;
    const bool masked =
        kKeysOwn ? (p.causal && own0 + kBQ - 1 > o0 + offset) ||
                       !walk.full(own0, o0)
                 : o0 + kBK > p.lk ||
                       (p.causal && o0 + kBK - 1 > own0 + offset) ||
                       !walk.full(own0, o0);
    if (masked)
      run(std::true_type{});
    else
      run(std::false_type{});
    if constexpr (!kKeysOwn) {
#pragma unroll
      for (int t = 0; t < 16; ++t) pds[t] = pack<T>(dp[2 * t], dp[2 * t + 1]);
    }
  };

  // tiles in order, as the producer publishes them; the fences pin the
  // registers an asynchronous wgmma owns at the fence / wait that bounds it
  int st = 0;
  unsigned phase = 0;
  for (;;) {
    mbar_wait(&full[st], phase);
    const int4 tile = tiles[st];
    const int o0 = tile.x;
    if (o0 < 0) break;
    walk.enter(make_int2(tile.y, tile.z));
    wg_fence();
    issue_scores(st);
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    make_p_ds(o0, st);
    fence_regs(dx);
    fence_regs(dv);
    fence_regs(pds);
    fence_regs(pp);
    wg_fence();
    issue_grads(st);
    wg_wait<0>();
    fence_regs(dx);
    fence_regs(dv);
    fence_regs(pds);
    fence_regs(pp);
    mbar_arrive(&empty[st]);
    if (++st == S) {
      st = 0;
      phase ^= 1;
    }
  }

  const int len = kKeysOwn ? p.lk : p.lq;
  const int b = bh / p.heads, h = bh % p.heads;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row < len) {
      const long long at =
          (((long long)b * len + row) * p.heads + h) * D + c;
      T* gx = static_cast<T*>(kKeysOwn ? p.dk : p.dq) + at;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(gx + 8 * j) =
            pack<T>(dx[4 * j + 2 * i], dx[4 * j + 2 * i + 1]);
      if constexpr (kKeysOwn) {
        T* gv = static_cast<T*>(p.dv) + at;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(gv + 8 * j) =
              pack<T>(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
      }
    }
  }
}

template <typename T, int D, class Walk>
__global__ void __launch_bounds__(
    kHwThreads, BwdCfg<D, false, Walk::kIndexed>::kMinBlocks)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              const __grid_constant__ CUtensorMap map_do,
                              const Params p) {
  flash_bwd_wgmma<T, D, false, Walk>(map_q, map_k, map_v, map_do, p);
}

template <typename T, int D, class Walk>
__global__ void __launch_bounds__(
    kHwThreads, BwdCfg<D, true, Walk::kIndexed>::kMinBlocks)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               const __grid_constant__ CUtensorMap map_do,
                               const Params p) {
  flash_bwd_wgmma<T, D, true, Walk>(map_q, map_k, map_v, map_do, p);
}

// the tensor map of one [batch, len, heads, D] bf16 or fp16 operand (T):
// dims (d,
// head, position, batch), strides rising, box (kBox, 1, 64, 1); a dim of
// extent 1 takes the stride a contiguous tensor would give it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime, so the library
// links no -lcuda
inline EncodeTiled encode_tiled() {
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

template <typename T, int D>
bool encode_map(CUtensorMap* map, const void* ptr, int batch, int len,
                int heads, long long sb, long long sl, long long sh) {
  using C = FwdCfg<D>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)batch};
  long long st[3] = {sh, sl, sb};
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] == 1) st[i] = i == 0 ? D : st[i - 1] * dims[i];
  const cuuint64_t strides[3] = {(cuuint64_t)st[0] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[2] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::kBox, 1, 64, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map,
            std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            D < 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a kernel's dynamic shared memory above 48 KB and the largest carveout,
// once per instantiation (not a stream operation, so it is also safe
// while a CUDA graph is captured)
template <class Kernel>
cudaError_t opt_in(Kernel kern, int smem, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  done = e == cudaSuccess;
  return e;
}

// builds the maps on the host (no stream operation: safe while a CUDA
// graph is captured; the maps travel by value in the launch)
template <typename T, int D, class Walk>
cudaError_t launch_fwd(const Params& p, int batch, cudaStream_t stream) {
  using C = FwdCfg<D>;
  if (p.lk <= 0) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!encode_map<T, D>(&mq, p.q, batch, p.lq, p.heads, p.q_sb, p.q_sl,
                     p.q_sh) ||
      !encode_map<T, D>(&mk, p.k, batch, p.lk, p.heads, p.k_sb, p.k_sl,
                     p.k_sh) ||
      !encode_map<T, D>(&mv, p.v, batch, p.lk, p.heads, p.v_sb, p.v_sl,
                     p.v_sh))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma_kernel<T, D, Walk>;
  static bool opted_in = false;
  const cudaError_t e = opt_in(kern, C::kSmem, opted_in);
  if (e != cudaSuccess) return e;
  const dim3 grid = Walk::grid(p, batch, false);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kern<<<grid, kHwThreads, C::kSmem, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

// the dq (kind kDq) or dkv kernel
template <typename T, int D, class Walk>
cudaError_t launch_bwd(Kind kind, const Params& p, int batch,
                       cudaStream_t stream) {
  if (p.lk <= 0) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  if (!encode_map<T, D>(&mq, p.q, batch, p.lq, p.heads, p.q_sb, p.q_sl,
                     p.q_sh) ||
      !encode_map<T, D>(&mk, p.k, batch, p.lk, p.heads, p.k_sb, p.k_sl,
                     p.k_sh) ||
      !encode_map<T, D>(&mv, p.v, batch, p.lk, p.heads, p.v_sb, p.v_sl,
                     p.v_sh) ||
      !encode_map<T, D>(&mdo, p.dout, batch, p.lq, p.heads, p.do_sb, p.do_sl,
                     p.do_sh))
    return cudaErrorInvalidValue;
  const dim3 grid = Walk::grid(p, batch, kind == kDkv);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaError_t e;
  if (kind == kDq) {
    constexpr int smem = BwdCfg<D, false, Walk::kIndexed>::kSmem;
    auto kern = flash_bwd_dq_wgmma_kernel<T, D, Walk>;
    static bool opted_in = false;
    if ((e = opt_in(kern, smem, opted_in)) != cudaSuccess) return e;
    kern<<<grid, kHwThreads, smem, stream>>>(mq, mk, mv, mdo, p);
  } else {
    constexpr int smem = BwdCfg<D, true, Walk::kIndexed>::kSmem;
    auto kern = flash_bwd_dkv_wgmma_kernel<T, D, Walk>;
    static bool opted_in = false;
    if ((e = opt_in(kern, smem, opted_in)) != cudaSuccess) return e;
    kern<<<grid, kHwThreads, smem, stream>>>(mq, mk, mv, mdo, p);
  }
  return cudaGetLastError();
}

}  // namespace hw

// ------------------------------------------------------------------ launch

template <int D>
size_t smem_bytes(Kind kind) {
  const size_t tile = (size_t)kBQ * (D + 1), scores = (size_t)kBQ * kLP;
  if (kind == kFwd) return sizeof(float) * (3 * tile + scores);
  if (kind == kDq) return sizeof(float) * (4 * tile + scores);
  return sizeof(float) * (4 * tile + 2 * scores + 2 * kBQ);
}

// bf16 and fp16 on the Hopper kernels (hw::); fp32 on the scalar kernels
template <typename T, int D, class Walk>
cudaError_t launch(Kind kind, const Params& p, int batch,
                   cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return kind == kFwd ? hw::launch_fwd<T, D, Walk>(p, batch, stream)
                        : hw::launch_bwd<T, D, Walk>(kind, p, batch, stream);
  } else {
    void (*kern)(const Params) =
        kind == kFwd  ? flash_fwd_kernel<D, Walk>
        : kind == kDq ? flash_bwd_dq_kernel<D, Walk>
                      : flash_bwd_dkv_kernel<D, Walk>;
    const size_t smem = smem_bytes<D>(kind);
    // above 48 KB a kernel must opt in; done once per instantiation (not
    // a stream operation, so it is also safe while a CUDA graph is
    // captured)
    static bool opted_in[3] = {false, false, false};
    if (!opted_in[kind]) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      opted_in[kind] = true;
    }
    const dim3 grid = Walk::grid(p, batch, kind == kDkv);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    kern<<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
}

template <typename T, class Walk>
cudaError_t launch_d(Kind kind, const Params& p, int batch, int head_dim,
                     cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32, Walk>(kind, p, batch, stream);
    case 64: return launch<T, 64, Walk>(kind, p, batch, stream);
    case 128: return launch<T, 128, Walk>(kind, p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <class Walk>
int run(Kind kind, const Params& p, int batch, int head_dim, int dtype,
        void* stream) {
  const int rows = kind == kDkv ? p.lk : p.lq;
  if (batch <= 0 || p.heads <= 0 || (long long)batch * p.heads > 65535 ||
      rows <= 0 || p.lq < 0 || p.lk < 0 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0   ? launch_d<float, Walk>(kind, p, batch, head_dim, s)
      : dtype == 1 ? launch_d<__nv_bfloat16, Walk>(kind, p, batch, head_dim, s)
                   : launch_d<__half, Walk>(kind, p, batch, head_dim, s));
}

// strides: 12 element strides (batch, seq, head) of q, k, v, do, in that
// order (do's are unused by the forward)
Params make_params(const void* q, const void* k, const void* v,
                   const long long* st, int heads, int lq, int lk,
                   int causal, float scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_sb = st[0]; p.q_sl = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_sl = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_sl = st[7]; p.v_sh = st[8];
  p.do_sb = st[9]; p.do_sl = st[10]; p.do_sh = st[11];
  p.heads = heads;
  p.lq = lq;
  p.lk = lk;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace
