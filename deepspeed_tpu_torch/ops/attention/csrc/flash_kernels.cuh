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
// Design, per dtype: bf16 runs its products on the tensor cores with WMMA
// (namespace tc below); fp32 runs scalar FMAs on tiles of fp32 in shared
// memory (rows padded by one float so the strided reads of a 16 x 8 thread
// grid hit distinct banks) with a 4 x 8 register tile of scores per thread,
// since the tensor cores would round fp32 to TF32. Not yet: wgmma, TMA,
// cp.async double buffering, warp specialisation (PERF.md).
//
// Numerics follow the TPU kernels: scores = (q . k) * scale in fp32,
// masked to NEG_INF = -1e30 (flash.py:42); a row whose running max is
// still NEG_INF is dead (p = 0, o = 0, lse = NEG_INF); p is rounded to
// the value dtype before P.V; the backward recomputes p = exp(s - lse)
// (0 where lse is NEG_INF), ds = p * (dp - delta) * scale with delta =
// sum(do * o) - dlse from the caller, and rounds p / ds to the operand
// dtype before the dV / dK / dQ products. Causal: query i sees keys
// j <= i + (k_len - q_len).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

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

// ---------------------------------------------------- bf16 tensor cores
// The bf16 kernels run their products on the tensor cores through WMMA
// (16x16x16 bf16 fragments, fp32 accumulators): 4 warps, each owning 16
// rows of a 64 x 64 tile. Operand tiles stay bf16 in shared memory (rows
// padded by 8 elements); each warp stores its fp32 scores to a private
// shared slice, where two lanes per row (even and odd columns) run the
// masking, the online softmax or ds in fp32 and write p / ds rounded to
// bf16 for the next product. The forward's output accumulator lives in
// shared memory (its rows are rescaled by alpha between tiles); the
// backward's dq, dk and dv accumulate in fragments across the whole loop.
namespace tc {

using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                                wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                                wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kLS = kBK + 4;     // fp32 score row
constexpr int kLB = kBK + 8;     // bf16 p / ds row
static_assert(kThreads == 4 * 32 && kBQ == 4 * 16, "4 warps x 16 rows");

// row strides: bf16 operand tiles, fp32 output staging
template <int D> __host__ __device__ constexpr int ld() { return D + 8; }
template <int D> __host__ __device__ constexpr int lo() { return D + 4; }

// rows [row0, row0 + 64) of one (batch, head) slice -> bf16 shared tile
// [64][ld]; rows past n_valid are zero. 16-byte loads when the slice's
// base and row stride allow them (every layout the models pass does)
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base,
                                          long long row_stride, int row0,
                                          int n_valid) {
  constexpr int kChunks = D / 8;           // 16-byte chunks per row
  if (((reinterpret_cast<uintptr_t>(base) |
        static_cast<uintptr_t>(row_stride * sizeof(bf16))) & 15) == 0) {
    for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r < n_valid)
        x = *reinterpret_cast<const uint4*>(
            base + (long long)(row0 + r) * row_stride + c);
      *reinterpret_cast<uint4*>(dst + r * ld<D>() + c) = x;
    }
    return;
  }
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * ld<D>() + c] = r < n_valid
        ? base[(long long)(row0 + r) * row_stride + c]
        : __float2bfloat16(0.f);
  }
}

// out[16][64] (fp32, row stride kLS) = A[16][D] . B[64][D]^T: the warp's
// 16 rows of A against the 64 rows of B, both bf16 row-major
template <int D>
__device__ __forceinline__ void scores(float* out, const bf16* a,
                                       const bf16* b) {
#pragma unroll
  for (int n = 0; n < kBK / 16; ++n) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a + kk * 16, ld<D>());
      wmma::load_matrix_sync(fb, b + n * 16 * ld<D>() + kk * 16, ld<D>());
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(out + n * 16, c, kLS, wmma::mem_row_major);
  }
}

// acc[n] += A[16][64] . B[64][D] (A bf16 with row stride kLB, B bf16
// row-major): the k-major products dS.K, P^T.dO, dS^T.Q
template <int D>
__device__ __forceinline__ void accumulate(FragC (&acc)[D / 16],
                                           const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, kLB);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * ld<D>() + n * 16, ld<D>());
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// the warp's accumulators -> bf16 rows [row0, row0 + 16) of a contiguous
// [b, len, heads, D] output, through the warp's fp32 staging rows
template <int D>
__device__ __forceinline__ void store_rows(FragC (&acc)[D / 16],
                                           float* stage, bf16* out,
                                           const Params& p, int b, int h,
                                           int len, int row0, int lane) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(stage + n * 16, acc[n], lo<D>(),
                            wmma::mem_row_major);
  __syncwarp();
  const int r = lane / 2, half = lane % 2;   // columns 2j + half
  if (row0 + r < len) {
    bf16* dst = out + (((long long)b * len + row0 + r) * p.heads + h) * D;
    for (int j = 0; j < D / 2; ++j)
      dst[2 * j + half] =
          __float2bfloat16(stage[r * lo<D>() + 2 * j + half]);
  }
  __syncwarp();
}

template <int D>
size_t smem_bytes(Kind kind) {
  const size_t tile = 64 * ld<D>() * sizeof(bf16);
  const size_t prob = 64 * kLB * sizeof(bf16), score = 64 * kLS * 4;
  if (kind == kFwd) return 3 * tile + prob + score + 64 * lo<D>() * 4;
  if (kind == kDq) return 4 * tile + prob + 2 * score;
  return 4 * tile + 2 * prob + 2 * score + 2 * 64 * 4;
}

template <int D, class Walk>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);     // [64][ld]
  bf16* k_s = q_s + 64 * ld<D>();
  bf16* v_s = k_s + 64 * ld<D>();
  bf16* p_s = v_s + 64 * ld<D>();                    // [64][kLB]
  float* s_s = reinterpret_cast<float*>(p_s + 64 * kLB);   // [64][kLS]
  float* o_s = s_s + 64 * kLS;                       // [64][lo]

  Walk walk(p, false);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16, rl = r0 + lane / 2, half = lane % 2;
  const int q0 = walk.own0, bh = walk.bh;
  const int b = bh / p.heads, h = bh % p.heads;
  const int offset = p.lk - p.lq, row = q0 + rl;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  load_tile<D>(q_s, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh,
               p.q_sl, q0, p.lq - q0);
  for (int i = tid; i < 64 * lo<D>(); i += kThreads) o_s[i] = 0.f;
  __syncthreads();
  float m = kNegInf, l = 0.f;              // this lane's row statistics
  float* srow = s_s + rl * kLS + half;     // columns 2j + half
  bf16* prow = p_s + rl * kLB + half;
  float* orow = o_s + rl * lo<D>() + half;

  int k0 = 0;
  while (walk.next(k0)) {
    __syncthreads();
    load_tile<D>(k_s, kb, p.k_sl, k0, p.lk - k0);
    load_tile<D>(v_s, vb, p.v_sl, k0, p.lk - k0);
    __syncthreads();
    scores<D>(s_s + r0 * kLS, q_s + r0 * ld<D>(), k_s);
    __syncwarp();

    float mx = kNegInf;
    for (int j = 0; j < 32; ++j) {
      const int col = k0 + 2 * j + half;
      const bool ok = col < p.lk && (!p.causal || col <= row + offset) &&
                      walk.ok(row, col);
      srow[2 * j] = ok ? srow[2 * j] * p.scale : kNegInf;
      mx = fmaxf(mx, srow[2 * j]);
    }
    const float m_new = fmaxf(m, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx,
                                                           1)));
    const bool live = m_new > 0.5f * kNegInf;
    const float alpha = live ? expf(m - m_new) : 0.f;
    float sum = 0.f;
    for (int j = 0; j < 32; ++j) {
      const float e = live ? expf(srow[2 * j] - m_new) : 0.f;
      sum += e;
      prow[2 * j] = __float2bfloat16(e);
    }
    l = alpha * l + sum + __shfl_xor_sync(0xffffffffu, sum, 1);
    m = m_new;
    for (int j = 0; j < D / 2; ++j) orow[2 * j] *= alpha;
    __syncwarp();

#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragC c;
      float* o_tile = o_s + r0 * lo<D>() + n * 16;
      wmma::load_matrix_sync(c, o_tile, lo<D>(), wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        FragA fa;
        FragBRow fb;
        wmma::load_matrix_sync(fa, p_s + r0 * kLB + kk * 16, kLB);
        wmma::load_matrix_sync(fb, v_s + kk * 16 * ld<D>() + n * 16,
                               ld<D>());
        wmma::mma_sync(c, fa, fb, c);
      }
      wmma::store_matrix_sync(o_tile, c, lo<D>(), wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (row < p.lq) {
    const float ll = l == 0.f ? 1.f : l;   // dead row -> zeros
    bf16* dst = static_cast<bf16*>(p.o) +
                (((long long)b * p.lq + row) * p.heads + h) * D + half;
    for (int j = 0; j < D / 2; ++j)
      dst[2 * j] = __float2bfloat16(orow[2 * j] / ll);
    if (half == 0) p.lse[(long long)bh * p.lq + row] = m + logf(ll);
  }
}

template <int D, class Walk>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);     // [64][ld]
  bf16* do_s = q_s + 64 * ld<D>();
  bf16* k_s = do_s + 64 * ld<D>();
  bf16* v_s = k_s + 64 * ld<D>();
  bf16* ds_s = v_s + 64 * ld<D>();                   // [64][kLB]
  float* s_s = reinterpret_cast<float*>(ds_s + 64 * kLB);  // [64][kLS]
  float* dp_s = s_s + 64 * kLS;                      // [64][kLS]

  Walk walk(p, false);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16, rl = r0 + lane / 2, half = lane % 2;
  const int q0 = walk.own0, bh = walk.bh;
  const int b = bh / p.heads, h = bh % p.heads;
  const int offset = p.lk - p.lq, row = q0 + rl;
  load_tile<D>(q_s, static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh,
               p.q_sl, q0, p.lq - q0);
  load_tile<D>(do_s,
               static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh,
               p.do_sl, q0, p.lq - q0);
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const long long at = (long long)bh * p.lq + row;
  const float lse = row < p.lq ? p.lse[at] : kNegInf;
  const float delta = row < p.lq ? p.delta[at] : 0.f;
  const bool live = lse > 0.5f * kNegInf;
  FragC dq[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq[n], 0.f);

  int k0 = 0;
  while (walk.next(k0)) {
    __syncthreads();
    load_tile<D>(k_s, kb, p.k_sl, k0, p.lk - k0);
    load_tile<D>(v_s, vb, p.v_sl, k0, p.lk - k0);
    __syncthreads();
    scores<D>(s_s + r0 * kLS, q_s + r0 * ld<D>(), k_s);
    scores<D>(dp_s + r0 * kLS, do_s + r0 * ld<D>(), v_s);
    __syncwarp();
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + half, col = k0 + c;
      const bool ok = live && col < p.lk &&
                      (!p.causal || col <= row + offset) &&
                      walk.ok(row, col);
      const float pr = ok ? expf(s_s[rl * kLS + c] * p.scale - lse) : 0.f;
      ds_s[rl * kLB + c] = __float2bfloat16(
          pr * (dp_s[rl * kLS + c] - delta) * p.scale);
    }
    __syncwarp();
    accumulate<D>(dq, ds_s + r0 * kLB, k_s);
  }
  __syncthreads();                     // the staging rows reuse s_s/dp_s
  store_rows<D>(dq, s_s + r0 * lo<D>(), static_cast<bf16*>(p.dq), p, b, h,
                p.lq, q0 + r0, lane);
}

// rows are keys, columns queries: S^T = K.Q^T and dP^T = V.dO^T, then
// dV += P^T.dO and dK += dS^T.Q over every query tile
template <int D, class Walk>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);     // [64][ld]
  bf16* v_s = k_s + 64 * ld<D>();
  bf16* q_s = v_s + 64 * ld<D>();
  bf16* do_s = q_s + 64 * ld<D>();
  bf16* pt_s = do_s + 64 * ld<D>();                  // [64][kLB]
  bf16* dst_s = pt_s + 64 * kLB;                     // [64][kLB]
  float* st_s = reinterpret_cast<float*>(dst_s + 64 * kLB);  // [64][kLS]
  float* dpt_s = st_s + 64 * kLS;                    // [64][kLS]
  float* lse_s = dpt_s + 64 * kLS;                   // [64]
  float* delta_s = lse_s + 64;                       // [64]

  Walk walk(p, true);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = warp * 16, rl = r0 + lane / 2, half = lane % 2;
  const int k0 = walk.own0, bh = walk.bh;
  const int b = bh / p.heads, h = bh % p.heads;
  const int offset = p.lk - p.lq, key = k0 + rl;
  load_tile<D>(k_s, static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh,
               p.k_sl, k0, p.lk - k0);
  load_tile<D>(v_s, static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh,
               p.v_sl, k0, p.lk - k0);
  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* dob =
      static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  FragC dk[D / 16], dv[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk[n], 0.f);
    wmma::fill_fragment(dv[n], 0.f);
  }

  int q0 = 0;
  while (walk.next(q0)) {
    __syncthreads();
    load_tile<D>(q_s, qb, p.q_sl, q0, p.lq - q0);
    load_tile<D>(do_s, dob, p.do_sl, q0, p.lq - q0);
    for (int i = tid; i < kBQ; i += kThreads) {
      const bool in = q0 + i < p.lq;
      const long long at = (long long)bh * p.lq + q0 + i;
      lse_s[i] = in ? p.lse[at] : kNegInf;
      delta_s[i] = in ? p.delta[at] : 0.f;
    }
    __syncthreads();
    scores<D>(st_s + r0 * kLS, k_s + r0 * ld<D>(), q_s);
    scores<D>(dpt_s + r0 * kLS, v_s + r0 * ld<D>(), do_s);
    __syncwarp();
    for (int j = 0; j < 32; ++j) {
      const int c = 2 * j + half, row = q0 + c;
      const float lse = lse_s[c];
      const bool ok = lse > 0.5f * kNegInf && key < p.lk && row < p.lq &&
                      (!p.causal || key <= row + offset) &&
                      walk.ok(key, row);
      const float pr = ok ? expf(st_s[rl * kLS + c] * p.scale - lse) : 0.f;
      pt_s[rl * kLB + c] = __float2bfloat16(pr);
      dst_s[rl * kLB + c] = __float2bfloat16(
          pr * (dpt_s[rl * kLS + c] - delta_s[c]) * p.scale);
    }
    __syncwarp();
    accumulate<D>(dv, pt_s + r0 * kLB, do_s);
    accumulate<D>(dk, dst_s + r0 * kLB, q_s);
  }
  __syncthreads();                     // the staging rows reuse st_s/dpt_s
  float* stage = st_s + r0 * lo<D>();
  store_rows<D>(dk, stage, static_cast<bf16*>(p.dk), p, b, h, p.lk,
                k0 + r0, lane);
  store_rows<D>(dv, stage, static_cast<bf16*>(p.dv), p, b, h, p.lk,
                k0 + r0, lane);
}

}  // namespace tc

// ------------------------------------------------------------------ launch

template <int D>
size_t smem_bytes(Kind kind) {
  const size_t tile = (size_t)kBQ * (D + 1), scores = (size_t)kBQ * kLP;
  if (kind == kFwd) return sizeof(float) * (3 * tile + scores);
  if (kind == kDq) return sizeof(float) * (4 * tile + scores);
  return sizeof(float) * (4 * tile + 2 * scores + 2 * kBQ);
}

// bf16 runs on the tensor cores (tc::), fp32 on the scalar kernels
template <typename T, int D, class Walk>
cudaError_t launch(Kind kind, const Params& p, int batch,
                   cudaStream_t stream) {
  void (*kern)(const Params);
  size_t smem;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    kern = kind == kFwd  ? tc::flash_fwd_kernel<D, Walk>
           : kind == kDq ? tc::flash_bwd_dq_kernel<D, Walk>
                         : tc::flash_bwd_dkv_kernel<D, Walk>;
    smem = tc::smem_bytes<D>(kind);
  } else {
    kern = kind == kFwd  ? flash_fwd_kernel<D, Walk>
           : kind == kDq ? flash_bwd_dq_kernel<D, Walk>
                         : flash_bwd_dkv_kernel<D, Walk>;
    smem = smem_bytes<D>(kind);
  }
  // above 48 KB a kernel must opt in; done once per instantiation (not a
  // stream operation, so it is also safe while a CUDA graph is captured)
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
      rows <= 0 || p.lq < 0 || p.lk < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? launch_d<float, Walk>(kind, p, batch, head_dim, s)
                 : launch_d<__nv_bfloat16, Walk>(kind, p, batch, head_dim,
                                                 s));
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
