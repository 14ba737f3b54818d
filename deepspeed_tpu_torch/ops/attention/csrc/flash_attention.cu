// Flash attention forward and backward for Hopper (sm_90a): online
// softmax with fp32 statistics, the [q_len, k_len] score matrix never
// leaves the SM.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/attention/flash.py:
//   flash_fwd      <- _fwd_kernel_1blk_causal (:153, pallas_call :242) and
//                     _fwd_kernel (:197, pallas_call :260): one kernel for
//                     every causal / offset / length case, returning o and
//                     the row logsumexp;
//   flash_bwd_dq   <- _bwd_dq_kernel (:354, pallas_call :463);
//   flash_bwd_dkv  <- _bwd_dkv_kernel (:384, pallas_call :479).
//   The pair also computes what _bwd_fused_kernel (:289, pallas_call :442)
//   computes: fusing dq with dk/dv saves grid steps on the TPU; here the
//   FlashAttention-2 split keeps both kernels deterministic (no atomics:
//   a fused pass would add dQ across key blocks with float atomics, in an
//   order that changes from run to run), at 7 products instead of 5.
//
// Bound on an H100 SXM: the forward does 4*lq*lk*d flops per (batch, head)
// (about half of it when causal) over 2*(lq+lk)*d elements read and
// written once. At l 4096 (b 1 h 12 d 64) and at Llama-2-7B heads (b 1
// h 32 l 2048 d 128) that is hundreds of flops per byte, so the floor is
// the operations over the peak rate (989 TFLOP/s bf16 on the tensor
// cores, 67 TFLOP/s fp32 outside them); at GPT-2's training shape (b 8
// h 12 l 1024 d 64, causal) the bytes over 3.35 TB/s are the larger. The
// backward does 2.5x the forward's products.
//
// What the bf16 forward does about it (flash_fwd_wgmma_kernel in
// flash_kernels.cuh, namespace hw): products at the tensor cores' full
// rate need wgmma, and wgmma needs its operands in shared memory ahead
// of it, so a producer warp keeps 2-3 stages of K / V tiles in
// flight by TMA (tensor maps built on the host at launch, 128-byte swizzle,
// the hardware zero-filling the ragged edge) while a consumer warpgroup
// of 64 query rows runs both products as wgmma, the online softmax on
// the accumulator registers (no score or probability tile in shared
// memory, P fed to P.V from registers, the softmax of one tile under
// the P.V of the one before) and keeps O in registers; the producer is
// one warp, so two blocks fit an SM at every head dim. The bf16 backward
// pair (flash_bwd_dq_wgmma_kernel, flash_bwd_dkv_wgmma_kernel) is built
// the same way: the block's own pair of tiles loaded once, the walked
// pair (with the query tile's lse and delta in dkv) in a TMA ring, the
// score-side products S and dP as wgmma, p and ds made and packed to
// bf16 in registers as the A operand of dQ += dS.K (or dV += P^T.dO and
// dK += dS^T.Q), one tile's p / ds under the last tile's products. Causal
// tiles that are fully masked are never visited (DenseWalk below), the
// heaviest tiles launch first, so they do not set the tail, and the
// blocks in flight cover few enough heads that what they walk stays in
// L2. The fp32 kernels (scalar FMAs) are the serving and training
// oracle. The numerics are stated in flash_kernels.cuh.

#include "flash_kernels.cuh"

namespace {

// Every key tile for a query tile (up to the causal edge), or every query
// tile from the causal edge on for a key tile. The grid is (b * h, own
// tiles), read in launch order as groups of p.head_group heads: within a
// group, tile rank r of every head goes before rank r + 1, and rank r of
// a head is its r-th heaviest (a causal query tile sees more keys the
// later it starts, a causal key tile more queries the earlier it
// starts). So the heavy tiles start first and the light ones fill in
// behind them, while the blocks in flight read the K / V (or Q / dO) of
// few enough heads to stay in L2 (dense_head_group below).
struct DenseWalk {
  static constexpr bool kIndexed = false;
  int own0, bh, next_row, end;

  __device__ DenseWalk(const Params& p, bool keys_own) {
    const long long n = gridDim.y, n_bh = gridDim.x;
    const long long lin = (long long)blockIdx.y * n_bh + blockIdx.x;
    const long long per_group = (long long)p.head_group * n;
    const long long group = lin / per_group, rem = lin - group * per_group;
    const long long heads = min((long long)p.head_group,
                                n_bh - group * p.head_group);
    const int rank = (int)(rem / heads);
    bh = (int)(group * p.head_group + rem % heads);
    own0 = (p.causal && !keys_own ? (int)n - 1 - rank : rank) * kBQ;
    const int offset = p.lk - p.lq;
    if (!keys_own) {          // keys [0, end) that a query of the tile sees
      next_row = 0;
      end = p.causal ? max(0, min(p.lk, own0 + kBQ + offset)) : p.lk;
    } else {                  // query i sees key j iff i >= j - offset
      const int q_first = p.causal ? max(0, own0 - offset) : 0;
      next_row = (q_first / kBQ) * kBQ;
      end = p.lq;
    }
  }
  __device__ bool next(int& row0) {
    if (next_row >= end) return false;
    row0 = next_row;
    next_row += kBQ;
    return true;
  }
  __device__ bool ok(int, int) const { return true; }
  __device__ bool full(int, int) const { return true; }
  __device__ int2 entry() const { return make_int2(0, 0); }
  __device__ void enter(int2) {}
  static dim3 grid(const Params& p, int batch, bool keys_own) {
    const int rows = keys_own ? p.lk : p.lq;
    return dim3(batch * p.heads, (rows + kBQ - 1) / kBQ);
  }
};

// Heads per DenseWalk group: as many as keep the operands a block walks
// (K and V, or Q and dO, of one head) within 16 MB, a third of the H100's
// L2, so the blocks in flight share what they read; at least one.
int dense_head_group(int batch, int heads, int lq, int lk, int head_dim,
                     int dtype) {
  const long long per_head =
      2LL * (lq > lk ? lq : lk) * head_dim * (dtype == 0 ? 4 : 2);
  const long long fit = (16LL << 20) / (per_head > 0 ? per_head : 1);
  const long long all = (long long)batch * heads;
  return (int)(fit < 1 ? 1 : fit > all ? all : fit);
}

Params dense_params(const void* q, const void* k, const void* v,
                    const long long* strides, int batch, int heads, int lq,
                    int lk, int head_dim, int causal, float scale,
                    int dtype) {
  Params p = make_params(q, k, v, strides, heads, lq, lk, causal, scale);
  p.head_group = dense_head_group(batch, heads, lq, lk, head_dim, dtype);
  return p;
}

}  // namespace

// strides: 12 element strides (batch, seq, head) of q, k, v, do, in that
// order (do's are unused by the forward). dtype: 0 = float32, 1 =
// bfloat16, 2 = float16. Each returns a cudaError_t (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, const long long* strides,
                         int batch, int heads, int lq, int lk, int head_dim,
                         int causal, float scale, int dtype, void* stream) {
  Params p = dense_params(q, k, v, strides, batch, heads, lq, lk, head_dim,
                         causal, scale, dtype);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  return run<DenseWalk>(kFwd, p, batch, head_dim, dtype, stream);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq,
                            const long long* strides, int batch, int heads,
                            int lq, int lk, int head_dim, int causal,
                            float scale, int dtype, void* stream) {
  Params p = dense_params(q, k, v, strides, batch, heads, lq, lk, head_dim,
                         causal, scale, dtype);
  p.dout = dout;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  return run<DenseWalk>(kDq, p, batch, head_dim, dtype, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             const long long* strides, int batch, int heads,
                             int lq, int lk, int head_dim, int causal,
                             float scale, int dtype, void* stream) {
  Params p = dense_params(q, k, v, strides, batch, heads, lq, lk, head_dim,
                         causal, scale, dtype);
  p.dout = dout;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  return run<DenseWalk>(kDkv, p, batch, head_dim, dtype, stream);
}
