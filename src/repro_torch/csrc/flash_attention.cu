// Causal (or full) GQA attention of a query block over its keys for Hopper
// (sm_90a), plain C interface for ctypes: the prefill.
//
// Replaces: repro/kernels/flash_attention.py::flash_attention_pallas (the
// pl.pallas_call at flash_attention.py:95).  Same function: q (B, Sq, H, D)
// against k, v (B, Skv, KV, D); query head h reads kv head h / (H / KV);
// with causal set, query i attends keys j <= i + (Skv - Sq) (the queries are
// the last Sq positions), else all Skv keys; softmax online in float32.  It
// runs on the contiguous prefill at offset 0 (Sq = Skv, the window's own
// keys) of the dense models and of the hybrid's shared attention block.
//
// Bound on the H100: bytes at the serving path's prefill (8 x 127 tokens:
// q, k, v and the output once are ~33 MB at Llama-2-7B against ~1 GFLOP of
// causal products), operations only for prompts of many hundreds of tokens.
//
// Design.  One block per (query tile, query head, batch row) holds a tile of
// 64 query rows (16 when Sq < 64) and walks tiles of 64 keys up to the
// causal diagonal of its last row: the Pallas kernel's sequential kv-grid
// axis becomes the loop inside the block, and the tiles above the diagonal
// are skipped whole, as its `run` predicate does (flash_attention.py:35-38).
// Per tile the 256 threads stage K and V as float32 in shared memory (rows
// padded to D + 4 floats: 16-byte aligned, float4 reads free of bank
// conflicts), compute the scores with one key and a group of rows per
// thread (each K value loaded once for 16 rows), mask them by position,
// update m / l per row (a warp per row) and accumulate P V with each thread
// owning four output columns of a few rows.  Head dims are template
// parameters, so 80 (Zamba2) works like the powers of two.  About 119 KB of
// dynamic shared memory at D = 128.  Simple and right first: plain FMA
// loops on the CUDA cores; wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int KT = 64;       // keys per tile (the softmax warp reads two per lane)
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
template <> struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float4 v) {
    // round to nearest even, as torch's .to(bfloat16)
    __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&a);
    raw.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D, int BQ>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 4) + 2 * (size_t)KT * (D + 4) +
         (size_t)BQ * (KT + 1) + 3 * (size_t)BQ;
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Skv, int H, int KV, int causal, float scale) {
  static_assert(D % 4 == 0 && D / 4 <= THREADS, "head dim");
  static_assert(KT == 64, "the softmax warp reads keys lane and lane + 32");
  constexpr int DP = D + 4;                 // padded shared row
  constexpr int C4 = D / 4;                 // float4 columns of a row
  constexpr int PS = KT + 1;                // padded score row
  constexpr int SG = THREADS / KT;          // score phase: row groups
  constexpr int SR = BQ / SG;               //   rows per group (r = sg + SG i)
  constexpr int PG = THREADS / C4;          // P V phase: row groups
  constexpr int PR = (BQ + PG - 1) / PG;    //   rows per group (r = pg + PG i)
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);   // BQ x DP, pre-scaled
  float* k_s = q_s + BQ * DP;                     // KT x DP
  float* v_s = k_s + KT * DP;                     // KT x DP
  float* p_s = v_s + KT * DP;                     // BQ x PS: scores, then p
  float* m_s = p_s + BQ * PS;                     // running max per row
  float* l_s = m_s + BQ;                          // running sum per row
  float* c_s = l_s + BQ;                          // this tile's rescale per row

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int R = min(BQ, Sq - q0);           // live rows of this tile
  const int off = Skv - Sq;                 // query i attends keys <= i + off
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // keys past the last row's diagonal are never read: whole tiles skipped
  const int key_end = causal ? max(0, min(q0 + R + off, Skv)) : Skv;

  for (int i = tid; i < R * C4; i += THREADS) {
    const int r = i / C4, c = i % C4;
    float4 x = Vec4<T>::load(q + (((size_t)b * Sq + q0 + r) * H + h) * D + c * 4);
    x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    Vec4<float>::store(q_s + r * DP + c * 4, x);
  }
  if (tid < BQ) {
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
      const size_t o = (((size_t)b * Skv + k0 + j) * KV + kvh) * D + c * 4;
      Vec4<float>::store(k_s + j * DP + c * 4, Vec4<T>::load(k + o));
      Vec4<float>::store(v_s + j * DP + c * 4, Vec4<T>::load(v + o));
    }
    __syncthreads();

    // scores: thread (sj, sg) takes key sj against rows sg, sg + SG, ...
    float s[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) s[i] = 0.f;
    if (sj < n) {
      const float* kr = k_s + sj * DP;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        const float4 k4 = lds4(kr + d);
#pragma unroll
        for (int i = 0; i < SR; ++i) {
          if (sg + SG * i < R) {
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
      if (r < R) {
        const int kpos = k0 + sj;
        const bool seen = sj < n && (!causal || kpos <= q0 + r + off);
        p_s[r * PS + sj] = seen ? s[i] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax over the tile, one warp per row
    for (int r = warp; r < R; r += THREADS / 32) {
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
        if (r < R) {
          const float corr = c_s[r];
          acc[i].x *= corr; acc[i].y *= corr; acc[i].z *= corr; acc[i].w *= corr;
        }
      }
      for (int j = 0; j < n; ++j) {
        const float4 v4 = lds4(v_s + j * DP + pc * 4);
#pragma unroll
        for (int i = 0; i < PR; ++i) {
          const int r = pg + PG * i;
          if (r < R) {
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
#pragma unroll
    for (int i = 0; i < PR; ++i) {
      const int r = pg + PG * i;
      if (r < R) {
        const float inv = 1.f / fmaxf(l_s[r], 1e-30f);   // l == 0 -> acc == 0 -> 0
        const float4 o = make_float4(acc[i].x * inv, acc[i].y * inv,
                                     acc[i].z * inv, acc[i].w * inv);
        Vec4<T>::store(out + (((size_t)b * Sq + q0 + r) * H + h) * D + pc * 4, o);
      }
    }
  }
}

template <typename T, int D, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int H, int KV, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D, BQ>();
  static bool sized = false;   // the attribute is set once per instantiation
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D, BQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, D, BQ><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, KV, causal,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_bq(const void* q, const void* k, const void* v, void* out,
                        int B, int Sq, int Skv, int H, int KV, int causal,
                        float scale, cudaStream_t stream) {
  if (Sq >= 64)
    return launch<T, D, 64>(q, k, v, out, B, Sq, Skv, H, KV, causal, scale, stream);
  return launch<T, D, 16>(q, k, v, out, B, Sq, Skv, H, KV, causal, scale, stream);
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* out, int B, int Sq, int Skv, int H, int KV,
                       int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return dispatch_bq<T, 16>(q, k, v, out, B, Sq, Skv, H, KV, causal, scale, stream);
    case 32: return dispatch_bq<T, 32>(q, k, v, out, B, Sq, Skv, H, KV, causal, scale, stream);
    case 64: return dispatch_bq<T, 64>(q, k, v, out, B, Sq, Skv, H, KV, causal, scale, stream);
    case 80: return dispatch_bq<T, 80>(q, k, v, out, B, Sq, Skv, H, KV, causal, scale, stream);
    case 96: return dispatch_bq<T, 96>(q, k, v, out, B, Sq, Skv, H, KV, causal, scale, stream);
    case 128: return dispatch_bq<T, 128>(q, k, v, out, B, Sq, Skv, H, KV, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, H, D); k, v (B, Skv, KV, D); out (B, Sq, H, D).  All contiguous
// and 16-byte aligned, of one dtype: 0 = float32, 1 = bfloat16; causal 0/1
// (with causal, Sq <= Skv).  Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Skv, int H, int KV, int D, int causal,
                                      int dtype, float scale, void* stream) {
  if (KV < 1 || H % KV != 0 || (causal && Sq > Skv))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float>(D, q, k, v, out, B, Sq, Skv, H, KV, causal, scale, st);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(D, q, k, v, out, B, Sq, Skv, H, KV, causal, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
