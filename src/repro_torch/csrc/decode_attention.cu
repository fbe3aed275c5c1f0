// One query step of GQA attention over a contiguous KV cache for Hopper
// (sm_90a), plain C interface for ctypes.
//
// Replaces: repro/kernels/decode_attention.py::decode_attention_pallas (the
// pl.pallas_call at decode_attention.py:81).  Same function: q (B, H, D)
// against caches (B, S, KV, D); row b attends cache positions
// [0, lengths[b]), all S of them when lengths[b] >= S; softmax online in
// float32; a row that sees no key (lengths[b] <= 0) returns 0, as the Pallas
// kernel's l = 0 guard.  It runs on every T = 1 window of the contiguous
// layout: draft steps, the hybrid target's per-token steps and the plain
// ServingEngine's decode step.
//
// Bound on the H100: bytes.  Every key below min(lengths[b], S) is read once
// per kv head and each of its bytes feeds 2 * G multiply-adds (G = H / KV
// query heads share a kv head: 8 at TinyLlama, 1 at Llama-2-7B), far below
// the ~295 flop/byte the tensor cores need.
//
// Design, bfloat16 (every full-width serving path): the tensor-core body of
// window_attention_bf16.cuh that B1, B3 and B6 run, with B6's contiguous key
// locator (``ContiguousKeys``) and B1's horizon mask (``CausalRows``) at a
// window of T = 1: the 16-row tile holds the G <= 16 query heads of one kv
// head, each row's horizon is lengths[b] (clipped at S by the locator), and
// the key axis is cut in runs of 64-key chunks across blocks when the grid
// (B x KV blocks: 32 at the TinyLlama draft step) has fewer blocks than SMs,
// by the plan of kernels/paged_attention.py::window_split_plan over S keys,
// merged by the last block of each tile in the same launch.  The same keys
// through B6 with a one-row window and mask [[1]] at lengths[b] - 1 are cut
// and walked alike, so the two agree bit for bit.  Its own dispatch adds the
// head dims 80 (Zamba2) and 96 without instantiating them for B1/B3/B6.
//
// float32 inputs (the configs' default dtype, run at smoke size) stay on the
// first kernel: one block per (kv head, batch row) holds that head's G query
// rows and walks tiles of 64 keys up to min(lengths[b], S): the Pallas
// kernel's sequential S-tile grid axis becomes the loop inside the block,
// and the walk stops at the row's length, as its pl.when does.  Per tile the
// 128 threads stage K and V as float32 in shared memory (rows padded to
// D + 4 floats: 16-byte aligned, float4 reads free of bank conflicts),
// compute the G x 64 scores one key per thread, update m / l per row (a warp
// per row) and accumulate P V with each thread owning four output columns of
// a few rows.  About 80 KB of dynamic shared memory at D = 128, 151 KB at
// D = 256.
//
// B9, decode_attention_q8_launch, replaces
// decode_attention.py::decode_attention_q8_pallas (the pl.pallas_call at
// decode_attention.py:168): caches (B, S, KV, D) int8 with float32 scales
// (B, KV), one per (batch row, kv head).  An int8 row is D bytes (16 to 256,
// always a multiple of 16), so a key costs half its bfloat16 bytes and the
// bound halves; the int8 tensor cores are no help while q is floating point.
// With a bfloat16 q it is bf16 B7 over int8 rows: the same window body,
// mask, head dims and split plan, with the ``ContiguousCodes`` locator,
// whose rows are staged as codes by 16-byte cp.async copies and turned into
// bf16 in shared memory; k_scale joins the score scale and v_scale
// multiplies the output, so at unit scales B9 equals bf16 B7 on the codes
// bit for bit.  With a float32 q it runs the first kernel instantiated on
// the int8 cache type, the dequant fused into the tile load as the Pallas
// kernel fuses it on its VMEM tiles: each thread reads four codes (one
// char4) of K and of V, converts them to float32 and multiplies them by the
// block's k_scale / v_scale before staging them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "window_attention_bf16.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int KT = 64;       // keys per tile (the softmax warp reads two per lane)
constexpr int G_MAX = 16;    // query heads per kv head
constexpr unsigned FULL = 0xffffffffu;

template <typename T> struct Vec4;   // four consecutive elements <-> float4
template <> struct Vec4<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <> struct Vec4<int8_t> {   // four int8 codes: one 4-byte load
  static __device__ __forceinline__ float4 load(const int8_t* p) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
  }
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)G_MAX * (D + 4) + 2 * (size_t)KT * (D + 4) +
         (size_t)G_MAX * (KT + 1) + 3 * (size_t)G_MAX;
}

// T: q and out (float); TC: the caches, T itself (B7) or int8_t (B9,
// dequantized on the load with the block's k_scale / v_scale).
template <typename T, typename TC, int D>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const TC* __restrict__ k_cache,
                        const TC* __restrict__ v_cache,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int H, int KV, int S, float scale) {
  static_assert(D % 4 == 0 && D / 4 <= THREADS, "head dim");
  constexpr bool Q8 = std::is_same<TC, int8_t>::value;
  static_assert(KT == 64, "the softmax warp reads keys lane and lane + 32");
  constexpr int DP = D + 4;                 // padded shared row
  constexpr int C4 = D / 4;                 // float4 columns of a row
  constexpr int PS = KT + 1;                // padded score row
  constexpr int SG = THREADS / KT;          // score phase: row groups
  constexpr int SR = G_MAX / SG;            //   rows per group (r = sg + SG i)
  constexpr int PG = THREADS / C4;          // P V phase: row groups
  constexpr int PR = (G_MAX + PG - 1) / PG; //   rows per group (r = pg + PG i)
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // G_MAX x DP, pre-scaled
  float* k_s = q_s + G_MAX * DP;                  // KT x DP
  float* v_s = k_s + KT * DP;                     // KT x DP
  float* p_s = v_s + KT * DP;                     // G_MAX x PS: scores, then p
  float* m_s = p_s + G_MAX * PS;                  // running max per row
  float* l_s = m_s + G_MAX;                       // running sum per row
  float* c_s = l_s + G_MAX;                       // this tile's rescale per row

  const int kv = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int key_end = max(0, min(lengths[b], S));
  const T* qb = q + ((size_t)b * H + (size_t)kv * G) * D;
  float ks = 1.f, vs = 1.f;
  if constexpr (Q8) {
    ks = k_scale[b * KV + kv];
    vs = v_scale[b * KV + kv];
  }

  for (int i = tid; i < G * C4; i += THREADS) {
    const int r = i / C4, c = i % C4;
    float4 x = Vec4<T>::load(qb + (size_t)r * D + c * 4);
    x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    Vec4<float>::store(q_s + r * DP + c * 4, x);
  }
  if (tid < G_MAX) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int sj = tid % KT, sg = tid / KT;
  const int pc = tid % C4, pg = tid / C4;
  float4 acc[PR];
#pragma unroll
  for (int i = 0; i < PR; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = 0; k0 < key_end; k0 += KT) {
    const int n = min(KT, key_end - k0);
    __syncthreads();  // q_s and the row state are set; the last tile is consumed
    for (int i = tid; i < n * C4; i += THREADS) {
      const int j = i / C4, c = i % C4;
      const size_t off = (((size_t)b * S + k0 + j) * KV + kv) * D + c * 4;
      float4 kx = Vec4<TC>::load(k_cache + off);
      float4 vx = Vec4<TC>::load(v_cache + off);
      if constexpr (Q8) {
        kx.x *= ks; kx.y *= ks; kx.z *= ks; kx.w *= ks;
        vx.x *= vs; vx.y *= vs; vx.z *= vs; vx.w *= vs;
      }
      Vec4<float>::store(k_s + j * DP + c * 4, kx);
      Vec4<float>::store(v_s + j * DP + c * 4, vx);
    }
    __syncthreads();

    // scores: thread (sj, sg) takes key sj against rows sg, sg + SG, ...
    float s[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) s[i] = 0.f;
    if (sj < n) {
      const float* kr = k_s + sj * DP;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        const float4 k4 = lds4(kr + d);
#pragma unroll
        for (int i = 0; i < SR; ++i) {
          if (sg + SG * i < G) {
            const float4 q4 = lds4(q_s + (sg + SG * i) * DP + d);
            s[i] = fmaf(q4.x, k4.x, s[i]);
            s[i] = fmaf(q4.y, k4.y, s[i]);
            s[i] = fmaf(q4.z, k4.z, s[i]);
            s[i] = fmaf(q4.w, k4.w, s[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int r = sg + SG * i;
      if (r < G) p_s[r * PS + sj] = sj < n ? s[i] : -INFINITY;
    }
    __syncthreads();

    // online softmax over the tile, one warp per row
    for (int r = warp; r < G; r += THREADS / 32) {
      const float x0 = p_s[r * PS + lane];
      const float x1 = p_s[r * PS + lane + 32];
      float mt = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mt);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float p0 = (x0 == -INFINITY) ? 0.f : expf(x0 - m_use);
      const float p1 = (x1 == -INFINITY) ? 0.f : expf(x1 - m_use);
      p_s[r * PS + lane] = p0;
      p_s[r * PS + lane + 32] = p1;
      float ps = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(FULL, ps, o);
      if (lane == 0) {
        const float corr = expf(m_old - m_use);   // 0 while nothing was seen
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + ps;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // P V: thread (pc, pg) owns columns 4 pc .. 4 pc + 3 of rows pg, pg + PG, ...
    if (pg < PG) {
#pragma unroll
      for (int i = 0; i < PR; ++i) {
        const int r = pg + PG * i;
        if (r < G) {
          const float corr = c_s[r];
          acc[i].x *= corr; acc[i].y *= corr; acc[i].z *= corr; acc[i].w *= corr;
        }
      }
      for (int j = 0; j < n; ++j) {
        const float4 v4 = lds4(v_s + j * DP + pc * 4);
#pragma unroll
        for (int i = 0; i < PR; ++i) {
          const int r = pg + PG * i;
          if (r < G) {
            const float p = p_s[r * PS + j];
            acc[i].x = fmaf(p, v4.x, acc[i].x);
            acc[i].y = fmaf(p, v4.y, acc[i].y);
            acc[i].z = fmaf(p, v4.z, acc[i].z);
            acc[i].w = fmaf(p, v4.w, acc[i].w);
          }
        }
      }
    }
  }
  __syncthreads();  // l_s is final (and set, when no tile ran)

  if (pg < PG) {
    T* ob = out + ((size_t)b * H + (size_t)kv * G) * D;
#pragma unroll
    for (int i = 0; i < PR; ++i) {
      const int r = pg + PG * i;
      if (r < G) {
        const float inv = 1.f / fmaxf(l_s[r], 1e-30f);   // l == 0 -> acc == 0 -> 0
        const float4 o = make_float4(acc[i].x * inv, acc[i].y * inv,
                                     acc[i].z * inv, acc[i].w * inv);
        Vec4<T>::store(ob + (size_t)r * D + pc * 4, o);
      }
    }
  }
}

template <typename T, typename TC, int D>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache,
                   const float* k_scale, const float* v_scale,
                   const int* lengths, void* out, int B, int H, int KV, int S,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  static bool sized = false;   // the attribute is set once per instantiation
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T, TC, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid(KV, B);
  decode_attention_kernel<T, TC, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TC*>(k_cache),
      static_cast<const TC*>(v_cache), k_scale, v_scale, lengths,
      static_cast<T*>(out), H, KV, S, scale);
  return cudaGetLastError();
}

template <typename T, typename TC>
cudaError_t dispatch_d(int D, const void* q, const void* k_cache,
                       const void* v_cache, const float* k_scale,
                       const float* v_scale, const int* lengths, void* out,
                       int B, int H, int KV, int S, float scale,
                       cudaStream_t stream) {
#define DECODE_CASE(DIM)                                                     \
  case DIM:                                                                  \
    return launch<T, TC, DIM>(q, k_cache, v_cache, k_scale, v_scale, lengths, \
                              out, B, H, KV, S, scale, stream);
  switch (D) {
    DECODE_CASE(16)
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(80)
    DECODE_CASE(96)
    DECODE_CASE(128)
    DECODE_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef DECODE_CASE
}

// The bfloat16 route: window_bf16::launch of a 16-row tile over contiguous
// keys (bf16 rows for B7, int8 codes for B9) with per-row horizons, at every
// head dim B7 takes.
template <int D, class Keys>
cudaError_t launch_bf16(const void* q, const void* k_cache, const void* v_cache,
                        Keys keys, const int* lengths, void* out, float* part,
                        int* tickets, int B, int H, int KV, int n_split,
                        int split_keys, float scale, cudaStream_t stream) {
  return window_bf16::launch<D, 1>(
      q, k_cache, v_cache, keys, window_bf16::CausalRows{}, lengths, out,
      part, tickets, B, 1, H, KV, n_split, split_keys, scale, stream);
}

template <class Keys>
cudaError_t dispatch_bf16(int D, const void* q, const void* k_cache,
                          const void* v_cache, Keys keys, const int* lengths,
                          void* out, float* part, int* tickets, int B, int H,
                          int KV, int n_split, int split_keys, float scale,
                          cudaStream_t stream) {
  if (n_split < 1 || split_keys < 1 ||
      (n_split > 1 && (part == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
#define DECODE_BF16_CASE(DIM)                                                 \
  case DIM:                                                                   \
    return launch_bf16<DIM>(q, k_cache, v_cache, keys, lengths, out, part,     \
                            tickets, B, H, KV, n_split, split_keys, scale,     \
                            stream);
  switch (D) {
    DECODE_BF16_CASE(16)
    DECODE_BF16_CASE(32)
    DECODE_BF16_CASE(64)
    DECODE_BF16_CASE(80)
    DECODE_BF16_CASE(96)
    DECODE_BF16_CASE(128)
    DECODE_BF16_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef DECODE_BF16_CASE
}

}  // namespace

// q (B, H, D); caches (B, S, KV, D); lengths (B,) int32; out (B, H, D).  All
// contiguous and 16-byte aligned, q/caches/out of one dtype: 0 = float32,
// 1 = bfloat16; H / KV <= 16.  For bfloat16, ``n_split`` and ``split_keys``
// come from the host's split plan (window_split_plan over S keys); with
// n_split > 1, ``part`` holds B * KV * n_split * 16 * (D + 2) floats and
// ``tickets`` B * KV zeros (left zero); float32 ignores the four.  Returns
// the cudaError_t of the launch.
extern "C" int decode_attention_launch(const void* q, const void* k_cache,
                                       const void* v_cache, const void* lengths,
                                       void* out, void* part, void* tickets,
                                       int B, int H, int KV, int D, int S,
                                       int n_split, int split_keys, int dtype,
                                       float scale, void* stream) {
  if (KV < 1 || H % KV != 0 || H / KV > G_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lengths);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float, float>(D, q, k_cache, v_cache, nullptr, nullptr,
                                   ln, out, B, H, KV, S, scale, st);
  } else if (dtype == 1) {
    err = dispatch_bf16(D, q, k_cache, v_cache, window_bf16::ContiguousKeys{S, 0},
                        ln, out, static_cast<float*>(part),
                        static_cast<int*>(tickets), B, H, KV, n_split,
                        split_keys, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// B9: q (B, H, D) and out (B, H, D) of one dtype (0 = float32, 1 =
// bfloat16); caches (B, S, KV, D) int8; k_scale / v_scale (B, KV) float32;
// lengths (B,) int32.  All contiguous and 16-byte aligned; H / KV <= 16.
// ``part``, ``tickets``, ``n_split`` and ``split_keys`` as for
// decode_attention_launch (bfloat16 only).  Returns the cudaError_t of the
// launch.
extern "C" int decode_attention_q8_launch(const void* q, const void* k_cache,
                                          const void* v_cache,
                                          const void* k_scale,
                                          const void* v_scale,
                                          const void* lengths, void* out,
                                          void* part, void* tickets, int B,
                                          int H, int KV, int D, int S,
                                          int n_split, int split_keys,
                                          int dtype, float scale,
                                          void* stream) {
  if (KV < 1 || H % KV != 0 || H / KV > G_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lengths);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float, int8_t>(D, q, k_cache, v_cache, ks, vs, ln, out, B,
                                    H, KV, S, scale, st);
  } else if (dtype == 1) {
    err = dispatch_bf16(D, q, k_cache, v_cache,
                        window_bf16::ContiguousCodes{{S, 0}, ks, vs}, ln, out,
                        static_cast<float*>(part), static_cast<int*>(tickets),
                        B, H, KV, n_split, split_keys, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
