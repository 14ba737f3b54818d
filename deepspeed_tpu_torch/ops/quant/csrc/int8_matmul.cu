// Weight-only int8 dequant-matmul for Hopper (sm_90a):
//   out[m, n] = sum over groups g of (x[:, g] @ float(q[g, :])) * scale[g, :]
// with x [m, k] float32 or bfloat16, q [k, n] int8 (n contiguous), scale
// [k / G, n] float32, fp32 accumulation, out in x's dtype.
//
// Replaces the TPU kernel of deepspeed_tpu/ops/quant/kernels.py:
//   int8_matmul_fwd <- _kernel (:36) via int8_matmul (pallas_call :122).
// As there, the products of a group are UNSCALED (the int8 -> float convert
// is exact) and the group's scale row multiplies the [m, n] partial product
// once per group, not the weights.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at decode (m = slots, a handful of rows) each weight byte feeds
// 2m flops, far below the ridge, so the floor is the bytes the call must
// move: k*n int8 + 4*k*n/G scale bytes + x and out, over 3.35 TB/s.  From
// m of about 40 (fp32) the scalar FMAs bound it instead.
//
// What the design does about that bound:
//  * the weight is read as int8 and converted in registers (a byte permute
//    into the mantissa of 2^23 and one subtract, both full-rate
//    instructions); a dequantized weight never exists in memory;
//  * a block owns 64 output columns and all of k; a warp's lanes are 4 row
//    lanes x 8 column lanes, a lane loads 8 bytes (8 columns) of one weight
//    row, eight rows in flight per lane, so a warp has 2 KB in flight and
//    the grid is n / 64 blocks (64 for n = 4096) - narrower than the
//    512-column TPU tiles, to put more blocks on the 132 SMs.  Bytes in
//    flight are what limits it at n = 4096: eight rows in flight read 20%
//    faster than four, and 32-column blocks another 25% at m <= 4 but 35%
//    slower at m = 64 and at n = 32000
//    (profiling/int8_matmul_variants.py), so one width stays;
//  * the 8 warps of a block split k by whole groups (contiguous slices) and
//    are reduced through shared memory in warp order: no atomics;
//  * x rows reach the FMAs from shared memory (staged per warp and group as
//    fp32), one broadcast read per row lane.
// Batch invariance holds by construction: for an output element the order
// in which its k-products are summed (lane r takes rows r, r+4, ... of a
// group in order, fused multiply-adds throughout), the groups of a warp's
// slice, the 4 row lanes (xor butterfly) and the 8 warps (w = 0..7) is
// fixed by (k, G) alone - not by m, by the row's place in a tile, by the
// m-tile height or by the grid.  A row of an m = 1 call equals the same row
// of an m = 64 call bit for bit, and a run repeats bit for bit.
// Not yet: tensor cores for bf16 (WMMA / wgmma on the converted tile), so
// prefill-sized m is bound by scalar FMAs; splitting k across blocks for
// narrow n; TMA.  With m > 8 the weight is re-read once per 8 rows (from
// L2 when the matrix fits there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockN = 64;                  // output columns per block
constexpr int kCols = 8;                     // columns (bytes) per lane
constexpr int kColLanes = kBlockN / kCols;   // lanes across columns
constexpr int kRowLanes = 32 / kColLanes;    // lanes across weight rows
constexpr int kChunk = 128;                  // x rows of a group staged at once
constexpr int kUnroll = 8;                   // weight rows in flight per lane

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four int8 in a word -> four floats, exactly: byte b of (w ^ 0x80808080)
// is the value plus 128; placed in the low mantissa byte of 2^23 it reads
// as 2^23 + value + 128
__device__ __forceinline__ void unpack4(uint32_t w, float* dst) {
  const uint32_t v = w ^ 0x80808080u;
  dst[0] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540)) - 8388736.f;
  dst[1] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7541)) - 8388736.f;
  dst[2] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7542)) - 8388736.f;
  dst[3] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7543)) - 8388736.f;
}

// kVec: n % 8 == 0, so a lane's 8 columns are one aligned 8-byte load and
// lie wholly inside or outside the matrix; otherwise bytes are read one by
// one with a bound check (any n works, slowly)
template <bool kVec>
__device__ __forceinline__ uint2 load_cols(const int8_t* row, int col0,
                                           int n) {
  if (kVec) return __ldg(reinterpret_cast<const uint2*>(row + col0));
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (col0 + c < n)
      w[c >> 2] |= (uint32_t)(uint8_t)row[col0 + c] << (8 * (c & 3));
  return make_uint2(w[0], w[1]);
}

template <typename T, int kMT, bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, T* __restrict__ out,
                   int m, int k, int n, int group) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = lane / kColLanes;            // row lane
  const int col0 = blockIdx.x * kBlockN + (lane % kColLanes) * kCols;
  const int row0 = blockIdx.y * kMT;
  const bool in_range = col0 < n;
  const int groups = k / group;
  const int per_warp = (groups + kWarps - 1) / kWarps;
  const int g_begin = warp * per_warp;
  const int g_end = min(groups, g_begin + per_warp);

  // per warp: [kMT][kChunk] staged x, reused for the warp's partial sums
  __shared__ float smem[kWarps][8 * kChunk];
  float* xs = smem[warp];

  float acc[kMT][kCols], part[kMT][kCols];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int g = g_begin; g < g_end; ++g) {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) part[i][c] = 0.f;

    for (int c0 = 0; c0 < group; c0 += kChunk) {
      const int chunk = min(kChunk, group - c0);
      const int k0 = g * group + c0;
      __syncwarp();
      for (int idx = lane; idx < kMT * chunk; idx += 32) {
        const int i = idx / chunk, kk = idx - i * chunk;
        xs[i * kChunk + kk] = row0 + i < m
            ? to_float(x[(size_t)(row0 + i) * k + k0 + kk]) : 0.f;
      }
      __syncwarp();

      for (int j0 = r; j0 < chunk; j0 += kRowLanes * kUnroll) {
        uint2 w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int kk = j0 + u * kRowLanes;
          w[u] = make_uint2(0u, 0u);       // eight zeros
          if (kk < chunk && in_range)
            w[u] = load_cols<kVec>(q + (size_t)(k0 + kk) * n, col0, n);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int kk = j0 + u * kRowLanes;
          if (kk < chunk) {
            float wf[kCols];
            unpack4(w[u].x, wf);
            unpack4(w[u].y, wf + 4);
#pragma unroll
            for (int i = 0; i < kMT; ++i) {
              const float xv = xs[i * kChunk + kk];
#pragma unroll
              for (int c = 0; c < kCols; ++c)
                part[i][c] = fmaf(xv, wf[c], part[i][c]);
            }
          }
        }
      }
    }

    // the group's scale row, once, on the partial product
    float s[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[c] = 0.f;
    if (in_range) {
      const float* srow = scale + (size_t)g * n + col0;
      if (kVec) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(srow));
        const float4 b = __ldg(reinterpret_cast<const float4*>(srow) + 1);
        s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
        s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (col0 + c < n) s[c] = srow[c];
      }
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        acc[i][c] = fmaf(part[i][c], s[c], acc[i][c]);
  }

  // the 4 row lanes of a warp, then the 8 warps in order
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float v = acc[i][c];
#pragma unroll
      for (int o = kColLanes; o < 32; o <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (r == 0) xs[i * kBlockN + (lane % kColLanes) * kCols + c] = v;
    }
  __syncthreads();
  for (int e = tid; e < kMT * kBlockN; e += kThreads) {
    const int i = e / kBlockN, c = e - i * kBlockN;
    const int row = row0 + i, col = blockIdx.x * kBlockN + c;
    if (row < m && col < n) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += smem[w][e];
      out[(size_t)row * n + col] = from_float<T>(sum);
    }
  }
}

template <typename T, int kMT>
cudaError_t launch_mt(const T* x, const int8_t* q, const float* scale, T* out,
                      int m, int k, int n, int group, cudaStream_t stream) {
  const dim3 grid((n + kBlockN - 1) / kBlockN, (m + kMT - 1) / kMT);
  if (n % kCols == 0)
    int8_matmul_kernel<T, kMT, true><<<grid, kThreads, 0, stream>>>(
        x, q, scale, out, m, k, n, group);
  else
    int8_matmul_kernel<T, kMT, false><<<grid, kThreads, 0, stream>>>(
        x, q, scale, out, m, k, n, group);
  return cudaGetLastError();
}

// the m-tile height follows m; an output element's arithmetic does not
// depend on it
template <typename T>
cudaError_t launch(const void* x, const void* q, const void* scale, void* out,
                   int m, int k, int n, int group, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  T* op = static_cast<T*>(out);
  if (m == 1) return launch_mt<T, 1>(xp, qp, sp, op, m, k, n, group, stream);
  if (m <= 4) return launch_mt<T, 4>(xp, qp, sp, op, m, k, n, group, stream);
  return launch_mt<T, 8>(xp, qp, sp, op, m, k, n, group, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out).  k must be a whole number
// of groups.  Returns a cudaError_t (0 = launched).
extern "C" int int8_matmul_fwd(const void* x, const void* q,
                               const void* scale, void* out, int m, int k,
                               int n, int group, int dtype, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || group <= 0 || k % group != 0 ||
      (m + 7) / 8 > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? launch<float>(x, q, scale, out, m, k, n, group, s)
                 : launch<__nv_bfloat16>(x, q, scale, out, m, k, n, group, s));
}
