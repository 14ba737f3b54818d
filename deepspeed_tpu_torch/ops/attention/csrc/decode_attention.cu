// Decode attention for Hopper (sm_90a): one query token per sequence
// against a KV cache, online softmax with fp32 statistics.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/attention/decode.py:
//   paged_decode_fwd  <- _paged_decode_kernel (:233) via _paged_decode_pallas
//                        (pallas_call :471), and _paged_decode_kernel_gqa
//                        (:293) via _paged_decode_pallas_gqa (pallas_call
//                        :411): one kernel, `group` = heads / kv_heads
//                        (group 1 is MHA);
//   paged_decode_quant_fwd <- _paged_decode_kernel_quant (:171, pallas_call
//                        :471) and the quantized=True branch of
//                        _paged_decode_kernel_gqa (:310-338, pallas_call
//                        :411): the same kernel over int8 or fp8-e4m3
//                        payload pools with one fp32 scale per token row
//                        per kv head ([pages, page_size, kv_heads, 1]),
//                        the storage type being a template parameter;
//   decode_fwd        <- _decode_kernel (:36) via _decode_pallas
//                        (pallas_call :104), over a dense cache with an
//                        additive bias.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): each K/V element
// read feeds ~2 flops per query head of its group, far below the ~295
// flop/byte ridge, so the floor is the K/V bytes the kernel must read
// divided by 3.35 TB/s: the live prefix (keys <= position) of every slot
// for the paged kernel, the whole [b, max_len] cache (plus the fp32 bias)
// for the dense one.  A quantized pool costs head_dim + 4 bytes per row
// per kv head (payload and scale) where a bf16 pool costs 2 * head_dim.
//
// What the design does about that bound:
//  * grid (sequence, kv head): a block reads its kv head's K/V rows once
//    and serves the whole group of query heads that share them, so a
//    grouped cache is read natively and never expanded to num_heads;
//  * every load is 16 bytes per thread, neighbouring lanes on
//    neighbouring head-dim elements of a row (rows are contiguous in the
//    storage layout [pages|batch, page_size|max_len, kv_heads, head_dim]),
//    and each warp keeps four rows in flight;
//  * the paged kernel reads the page table itself and walks only keys
//    t <= positions[slot]: pages past the position (and unallocated
//    table entries, which are 0) are never touched;
//  * scores, probabilities and the online-softmax state stay in shared
//    memory and registers; only the [group, head_dim] output is written;
//  * a quantized row is loaded as 16 bytes = 16 elements per thread and
//    dequantized in registers; the 64 K scales and 64 V scales of a round
//    are fetched once per block into shared memory through the same
//    (page, offset, kv head) index as the payload, not once per lane;
//    loads in flight stay packed (4 registers per 16 bytes) until used.
// Not yet: splitting long contexts across blocks (flash-decoding), TMA,
// wgmma. With few sequences the grid does not fill the 132 SMs, which
// caps the bandwidth it reaches.  With 16 elements per thread a
// head_dim-128 row occupies 8 of a warp's 32 lanes in the score phase,
// and the accumulators (16 floats per query head of the group) limit a
// quantized pool to groups of at most 8.
//
// Numerics follow the TPU kernels: fp32 scores = (q . k) * scale (+ bias),
// clamped at NEG_INF = -1e30 (ops/attention/flash.py:42); a row whose
// running max is still NEG_INF is dead (its probabilities are 0 and a
// fully masked row writes zeros); probabilities are cast to the value
// dtype before the PV product; the output is acc / l in fp32, then cast.
// A quantized element is float(payload) * scale in fp32, rounded to the
// compute dtype (q's) before the dot, as decode.py:196-199 does.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                    // keys per round (2 per lane)
constexpr int kKeysPerWarp = kTile / kWarps;
constexpr int kUnroll = 4;                   // rows in flight per warp
constexpr int kMaxHeadDim = 256;
static_assert(kThreads == 2 * kTile, "the scale fetch maps one thread to "
              "each K and each V row of a round");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// 16 bytes of a K/V row, kept packed while the load is in flight
template <typename S>
__device__ __forceinline__ uint4 load16(const S* src) {
  return __ldg(reinterpret_cast<const uint4*>(src));
}

// the 16 / sizeof(S) elements of a packed load as floats: a float pool's
// values as they are; a quantized pool's times the row's scale, rounded
// to the compute type T
template <typename T, typename S>
__device__ __forceinline__ void unpack16(const uint4& raw, float s,
                                         float* dst) {
  const S* e = reinterpret_cast<const S*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(S); ++i) {
    if (std::is_same<T, S>::value)
      dst[i] = to_float(e[i]);
    else
      dst[i] = to_float(from_float<T>(to_float(e[i]) * s));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Params {
  const void* q;              // [n_seq, 1, kv_heads * group, head_dim]
  const void* k;              // paged: [pages, page_size, kv_heads, d]
  const void* v;              // dense: [n_seq, max_len, kv_heads, d]
  void* out;                  // like q
  const int* page_table;      // paged: [n_seq, max_pages]
  const int* positions;       // paged: [n_seq]
  const float* k_scale;       // quantized pools: [pages, page_size,
  const float* v_scale;       //   kv_heads, 1]
  const float* bias;          // dense: element (b, h, 0, t) at
  long long bias_sb, bias_sh, bias_sk;   // b*sb + h*sh + t*sk
  int kv_heads, group, head_dim;
  int page_size, max_pages;   // paged
  int max_len;                // dense
  float scale;
};

// index of key t's row for sequence b, kv head kvh: its scale's offset in
// a scale pool, and times head_dim its first element's in a payload pool
template <bool kPaged>
__device__ __forceinline__ size_t row_index(const Params& p, int b, int t,
                                            int kvh) {
  if (kPaged) {
    const int page = p.page_table[(size_t)b * p.max_pages + t / p.page_size];
    return ((size_t)page * p.page_size + t % p.page_size) * p.kv_heads + kvh;
  }
  return ((size_t)b * p.max_len + t) * p.kv_heads + kvh;
}

template <bool kPaged>
__device__ __forceinline__ size_t row_offset(const Params& p, int b, int t,
                                             int kvh) {
  return row_index<kPaged>(p, b, t, kvh) * p.head_dim;
}

// T: the compute type (q's and the output's); S: the pools' storage type,
// T itself for a float cache, int8_t or __nv_fp8_e4m3 for a quantized one
template <typename T, typename S, int kMaxGroup, bool kPaged>
__global__ void __launch_bounds__(kThreads) decode_kernel(const Params p) {
  constexpr bool kQuant = !std::is_same<T, S>::value;
  constexpr int N = 16 / (int)sizeof(S);     // elements in 16 bytes
  constexpr int kChunksPerLane = (kMaxHeadDim / N + 31) / 32;
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int G = p.group, D = p.head_dim, H = p.kv_heads * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_chunks = D / N;                // 16-byte chunks in a row
  const int n_slices = kThreads / n_chunks;  // key slices of the PV phase
  const int my_chunk = tid % n_chunks, my_slice = tid / n_chunks;
  const bool pv_thread = my_slice < n_slices;

  extern __shared__ float smem[];
  float* q_s = smem;                  // [G][D] query rows
  float* p_s = q_s + G * D;           // [G][kTile] scores -> probabilities
  float* m_s = p_s + G * kTile;       // [G] running max
  float* l_s = m_s + G;               // [G] running sum
  float* a_s = l_s + G;               // [G] this round's rescale factor
  float* ks_s = a_s + G;              // [kTile] this round's K scales
  float* vs_s = ks_s + kTile;         // [kTile] and V scales (quantized)
  float* red_s = vs_s + kTile;        // [n_slices][D] final reduction

  const T* q = static_cast<const T*>(p.q) +
               ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_float(q[i]);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  // keys [0, n_keys) are read; the paged kernel stops at the position
  const int n_keys = kPaged ? max(0, min(p.positions[b] + 1,
                                         p.page_size * p.max_pages))
                            : p.max_len;
  const S* kp = static_cast<const S*>(p.k);
  const S* vp = static_cast<const S*>(p.v);

  float acc[kMaxGroup][N];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int i = 0; i < N; ++i) acc[g][i] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < n_keys; t0 += kTile) {
    const int tn = min(kTile, n_keys - t0);

    // (0) quantized pools: the round's scales, once per block (the first
    // 64 threads take K's, the other 64 V's)
    if (kQuant) {
      const int tt = tid & (kTile - 1);
      if (tt < tn) {
        const size_t row = row_index<kPaged>(p, b, t0 + tt, kvh);
        if (tid < kTile) ks_s[tt] = p.k_scale[row];
        else vs_s[tt] = p.v_scale[row];
      }
      __syncthreads();
    }

    // (1) scores: warp w owns keys [w*16, w*16+16) of the round, four at
    // a time; a lane holds 16-byte chunks of each key row
    for (int u0 = 0; u0 < kKeysPerWarp; u0 += kUnroll) {
      uint4 raw[kUnroll][kChunksPerLane];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int tt = warp * kKeysPerWarp + u0 + u;
        if (tt < tn) {
          const S* row = kp + row_offset<kPaged>(p, b, t0 + tt, kvh);
#pragma unroll
          for (int j = 0; j < kChunksPerLane; ++j) {
            const int c = lane + 32 * j;
            if (c < n_chunks) raw[u][j] = load16(row + c * N);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int tt = warp * kKeysPerWarp + u0 + u;
        float kv[kChunksPerLane][N];
        if (tt < tn) {
          const float ks = kQuant ? ks_s[tt] : 1.f;
#pragma unroll
          for (int j = 0; j < kChunksPerLane; ++j)
            if (lane + 32 * j < n_chunks) unpack16<T, S>(raw[u][j], ks, kv[j]);
        }
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < G) {
            float s = kNegInf;
            if (tt < tn) {
              float dot = 0.f;
#pragma unroll
              for (int j = 0; j < kChunksPerLane; ++j) {
                const int c = lane + 32 * j;
                if (c < n_chunks) {
                  const float* qq = q_s + g * D + c * N;
#pragma unroll
                  for (int i = 0; i < N; ++i) dot += kv[j][i] * qq[i];
                }
              }
              s = warp_sum(dot) * p.scale;
              if (!kPaged)
                s += p.bias[b * p.bias_sb + (long long)(kvh * G + g) *
                            p.bias_sh + (long long)(t0 + tt) * p.bias_sk];
              s = fmaxf(s, kNegInf);
            }
            if (lane == 0) p_s[g * kTile + tt] = s;
          }
        }
      }
    }
    __syncthreads();

    // (2) online softmax, one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* row = p_s + g * kTile;
      const float s0 = row[lane], s1 = row[lane + 32];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const bool live = m_new > 0.5f * kNegInf;
      const float alpha = live ? expf(m_prev - m_new) : 0.f;
      const float e0 = live ? expf(s0 - m_new) : 0.f;
      const float e1 = live ? expf(s1 - m_new) : 0.f;
      const float sum = warp_sum(e0 + e1);
      row[lane] = to_float(from_float<T>(e0));   // p in the value dtype
      row[lane + 32] = to_float(from_float<T>(e1));
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = alpha * l_s[g] + sum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // (3) acc = alpha * acc + p @ V: thread (slice, chunk) owns 16 bytes
    // of the head dim for every key of its slice
    if (pv_thread) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < G) {
          const float a = a_s[g];
#pragma unroll
          for (int i = 0; i < N; ++i) acc[g][i] *= a;
        }
      }
      for (int tt0 = my_slice; tt0 < tn; tt0 += n_slices * kUnroll) {
        uint4 raw[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int tt = tt0 + u * n_slices;
          if (tt < tn)
            raw[u] = load16(vp + row_offset<kPaged>(p, b, t0 + tt, kvh) +
                            my_chunk * N);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int tt = tt0 + u * n_slices;
          if (tt < tn) {
            float vv[N];
            unpack16<T, S>(raw[u], kQuant ? vs_s[tt] : 1.f, vv);
#pragma unroll
            for (int g = 0; g < kMaxGroup; ++g) {
              if (g < G) {
                const float pg = p_s[g * kTile + tt];
#pragma unroll
                for (int i = 0; i < N; ++i) acc[g][i] += pg * vv[i];
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // reduce the key slices, one query row at a time; out = acc / l
  T* out = static_cast<T*>(p.out) + ((size_t)b * H + (size_t)kvh * G) * D;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < G) {
      if (pv_thread) {
#pragma unroll
        for (int i = 0; i < N; ++i)
          red_s[my_slice * D + my_chunk * N + i] = acc[g][i];
      }
      __syncthreads();
      const float l = l_s[g] == 0.f ? 1.f : l_s[g];
      for (int e = tid; e < D; e += kThreads) {
        float sum = 0.f;
        for (int s = 0; s < n_slices; ++s) sum += red_s[s * D + e];
        out[g * D + e] = from_float<T>(sum / l);
      }
      __syncthreads();
    }
  }
}

template <typename T, typename S, bool kPaged>
cudaError_t launch(const Params& p, int n_seq, cudaStream_t stream) {
  constexpr int N = 16 / (int)sizeof(S);
  if (p.head_dim % N != 0) return cudaErrorInvalidValue;
  const int n_slices = kThreads / (p.head_dim / N);
  const size_t smem = sizeof(float) *
      ((size_t)p.group * (p.head_dim + kTile + 3) + 2 * kTile +
       (size_t)n_slices * p.head_dim);
  const dim3 grid(n_seq, p.kv_heads);
  if (p.group == 1)
    decode_kernel<T, S, 1, kPaged><<<grid, kThreads, smem, stream>>>(p);
  else if (p.group == 2)
    decode_kernel<T, S, 2, kPaged><<<grid, kThreads, smem, stream>>>(p);
  else if (p.group <= 4)
    decode_kernel<T, S, 4, kPaged><<<grid, kThreads, smem, stream>>>(p);
  else if (p.group <= 8)
    decode_kernel<T, S, 8, kPaged><<<grid, kThreads, smem, stream>>>(p);
  else if (std::is_same<T, S>::value)
    decode_kernel<T, T, 16, kPaged><<<grid, kThreads, smem, stream>>>(p);
  else                        // 16 accumulators per head: groups <= 8
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

bool shapes_ok(int n_seq, int kv_heads, int group, int head_dim, int dtype) {
  return n_seq > 0 && kv_heads > 0 && kv_heads <= 65535 && group >= 1 &&
         group <= 16 && head_dim > 0 && head_dim <= kMaxHeadDim &&
         (dtype == 0 || dtype == 1);
}

template <bool kPaged>
int dispatch(const Params& p, int n_seq, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? launch<float, float, kPaged>(p, n_seq, s)
                 : launch<__nv_bfloat16, __nv_bfloat16, kPaged>(p, n_seq, s));
}

// storage: 1 = int8, 2 = fp8 e4m3
template <typename S>
int dispatch_quant(const Params& p, int n_seq, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? launch<float, S, true>(p, n_seq, s)
                 : launch<__nv_bfloat16, S, true>(p, n_seq, s));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int paged_decode_fwd(const void* q, const void* k_pages,
                                const void* v_pages, void* out,
                                const void* page_table, const void* positions,
                                int slots, int kv_heads, int group,
                                int head_dim, int page_size, int max_pages,
                                float scale, int dtype, void* stream) {
  if (!shapes_ok(slots, kv_heads, group, head_dim, dtype) || page_size <= 0 ||
      max_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.out = out;
  p.page_table = static_cast<const int*>(page_table);
  p.positions = static_cast<const int*>(positions);
  p.kv_heads = kv_heads;
  p.group = group;
  p.head_dim = head_dim;
  p.page_size = page_size;
  p.max_pages = max_pages;
  p.scale = scale;
  return dispatch<true>(p, slots, dtype, stream);
}

// The same over quantized pools: k_pages / v_pages hold int8 (storage 1) or
// fp8 e4m3 (storage 2) payload, k_scale / v_scale one float32 per row per
// kv head; dtype is q's and the output's.
extern "C" int paged_decode_quant_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, void* out,
    const void* page_table, const void* positions, int slots, int kv_heads,
    int group, int head_dim, int page_size, int max_pages, float scale,
    int dtype, int storage, void* stream) {
  if (!shapes_ok(slots, kv_heads, group, head_dim, dtype) || page_size <= 0 ||
      max_pages <= 0 || (storage != 1 && storage != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.out = out;
  p.page_table = static_cast<const int*>(page_table);
  p.positions = static_cast<const int*>(positions);
  p.kv_heads = kv_heads;
  p.group = group;
  p.head_dim = head_dim;
  p.page_size = page_size;
  p.max_pages = max_pages;
  p.scale = scale;
  return storage == 1 ? dispatch_quant<int8_t>(p, slots, dtype, stream)
                      : dispatch_quant<__nv_fp8_e4m3>(p, slots, dtype, stream);
}

extern "C" int decode_fwd(const void* q, const void* k_cache,
                          const void* v_cache, void* out, const void* bias,
                          long long bias_sb, long long bias_sh,
                          long long bias_sk, int batch, int max_len,
                          int kv_heads, int group, int head_dim, float scale,
                          int dtype, void* stream) {
  if (!shapes_ok(batch, kv_heads, group, head_dim, dtype) || max_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.q = q;
  p.k = k_cache;
  p.v = v_cache;
  p.out = out;
  p.bias = static_cast<const float*>(bias);
  p.bias_sb = bias_sb;
  p.bias_sh = bias_sh;
  p.bias_sk = bias_sk;
  p.kv_heads = kv_heads;
  p.group = group;
  p.head_dim = head_dim;
  p.max_len = max_len;
  p.scale = scale;
  return dispatch<false>(p, batch, dtype, stream);
}
