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
//   FlashAttention-2 split keeps both kernels deterministic (no atomics).
//
// Bound on an H100 SXM: the forward does 4*lq*lk*d flops per (batch, head)
// (half of it when causal) over 2*(lq+lk)*d elements, hundreds of flops
// per byte, so the floor is the operations over the peak rate (989
// TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 outside them); the
// backward does 2.5x the forward's products.
//
// What this design does about that bound: 64 queries x 64 keys per tile
// (the tile kernels of flash_kernels.cuh, bf16 on the tensor cores through
// WMMA, fp32 on scalar FMAs), causal tiles that are fully masked are never
// visited (DenseWalk below), and the scores stay on the SM. The numerics
// are stated in flash_kernels.cuh.

#include "flash_kernels.cuh"

namespace {

// Every key tile for a query tile (up to the causal edge), or every query
// tile from the causal edge on for a key tile; grid (own tiles, b * h)
struct DenseWalk {
  int own0, bh, next_row, end;

  __device__ DenseWalk(const Params& p, bool keys_own)
      : own0(blockIdx.x * kBQ), bh(blockIdx.y) {
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
  static dim3 grid(const Params& p, int batch, bool keys_own) {
    const int rows = keys_own ? p.lk : p.lq;
    return dim3((rows + kBQ - 1) / kBQ, batch * p.heads);
  }
};

}  // namespace

// strides: 12 element strides (batch, seq, head) of q, k, v, do, in that
// order (do's are unused by the forward). dtype: 0 = float32, 1 =
// bfloat16. Each returns a cudaError_t (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, const long long* strides,
                         int batch, int heads, int lq, int lk, int head_dim,
                         int causal, float scale, int dtype, void* stream) {
  Params p = make_params(q, k, v, strides, heads, lq, lk, causal, scale);
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
  Params p = make_params(q, k, v, strides, heads, lq, lk, causal, scale);
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
  Params p = make_params(q, k, v, strides, heads, lq, lk, causal, scale);
  p.dout = dout;
  p.lse = const_cast<float*>(static_cast<const float*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  return run<DenseWalk>(kDkv, p, batch, head_dim, dtype, stream);
}
