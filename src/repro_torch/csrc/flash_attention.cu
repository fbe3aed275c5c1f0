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
// Design, bfloat16 (every serving path): the tensor cores.  One block of
// four warps per (64-row query tile, query head, batch row); warp w owns
// rows 16w .. 16w + 15 of the tile, held as mma A fragments in registers
// for the whole walk (D / 4 registers).  Tiles of 64 keys are staged in
// shared memory as bf16 (rows padded to D + 8: ldmatrix reads are free of
// bank conflicts) by 16-byte cp.async copies into a two-stage ring, so
// tile k + 1 loads while tile k computes.  Per tile each warp forms its
// 16 x 64 scores with mma.sync.m16n8k16 (K fragments by ldmatrix), masks
// them on the fragment (the key tail past Skv, and the causal diagonal on
// the tiles that cross it), updates the online softmax in f32 registers
// (the max and the rescale reduced within the quad of lanes that holds a
// row; the row sums are kept per lane and reduced once at the end), splits
// P into two bf16 parts (hi + lo, ~16 significant bits) in the A-fragment
// layout and accumulates P V with mma.sync (V fragments by ldmatrix.trans,
// each used for both parts) into f32 registers (D / 2 per lane).  One
// bf16 rounding of P would move a row that sees few keys of opposite signs
// by up to 2^-9 of |V|, past the f32 plain version's band; the split costs
// twice the P V products, which are not what bounds the kernel.  Tiles above
// the diagonal of the tile's last row are never loaded; 16-key steps above
// a warp's own last row are skipped.  mma.sync, not wgmma: at the serving
// shapes (Sq = 127, two 64-row tiles per head) a block's work is one or
// two 64-key tiles, latency rather than tensor-core rate bounds it, and
// mma.sync keeps every fragment in registers with no descriptor or
// warpgroup fence; wgmma is the step when prompts reach thousands of
// tokens.  A 128-row block of eight warps (each K/V tile read once per
// head at Sq = 127, the Llama-2-7B prefill's 256 blocks in one wave) read
// slower at four of the five phase-3 shapes.  ~87 KB of dynamic shared
// memory at D = 128: two blocks an SM.  At D = 256 (gemma-7b, paligemma-3b)
// the output accumulator alone is 128 f32 registers a thread, so Q stays
// in shared memory and each k-step of Q K^T loads its one A fragment there
// (the k-step loop outside the 16-key loop: one load a k-step a tile; D <=
// 128 keeps Q in registers and the key loop outside); the tiles are
// unchanged, 168,960 bytes of shared memory, one block an SM.
//
// float32 inputs (the configs' default dtype, run at smoke size; the
// full-width serving paths run bf16) stay on the first kernel, unchanged:
// one block per (query tile, head, row) holds 64 query rows (16 when
// Sq < 64) and walks tiles of 64 keys staged as f32 in shared memory
// (rows padded to D + 4), scores with one key and a group of rows per
// thread, one warp per row for the softmax, P V with four output columns
// a thread; plain FMA on the CUDA cores, ~119 KB of shared memory at D = 128
// and ~212 KB at D = 256 with 64-row tiles (under the 227 KB opt-in).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int KT = 64;       // keys per tile (the softmax warp reads two per lane)
using mma_bf16::SMEM_OPT_IN;
constexpr unsigned FULL = 0xffffffffu;

template <typename T> struct Vec4;   // four consecutive elements <-> float4 (f32)
template <> struct Vec4<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
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
  constexpr size_t smem = sizeof(float) * smem_floats<D, BQ>();
  static_assert(smem <= SMEM_OPT_IN, "shared memory of the tile");
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

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int B, int Sq, int Skv, int H, int KV, int causal,
                       float scale, cudaStream_t stream) {
  if (Sq >= 64)
    return launch<float, D, 64>(q, k, v, out, B, Sq, Skv, H, KV, causal, scale, stream);
  return launch<float, D, 16>(q, k, v, out, B, Sq, Skv, H, KV, causal, scale, stream);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core tiles
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC_THREADS = 128;   // four warps, 16 query rows each
constexpr int TC_BQ = 64;         // query rows of a block
constexpr int TC_KT = 64;         // keys of a staged tile

template <int D>
constexpr size_t tc_smem_bytes() {   // q tile + two stages of K and V
  return sizeof(bf16) * (size_t)(TC_BQ + 4 * TC_KT) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out,
                            int Sq, int Skv, int H, int KV, int causal,
                            float scale_log2) {
  using namespace mma_bf16;
  static_assert(D % 16 == 0 && D <= 256, "head dim");
  constexpr int DP = D + 8;        // padded shared row (bf16)
  constexpr int C8 = D / 8;        // 16-byte chunks of a row
  constexpr int KS = D / 16;       // k-steps of Q K^T
  constexpr int NB = D / 8;        // 8-column blocks of the output
  constexpr bool Q_REGS = D <= 128;  // Q as A fragments for the whole walk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // TC_BQ x DP
  bf16* k_s = q_s + TC_BQ * DP;                    // 2 x TC_KT x DP
  bf16* v_s = k_s + 2 * TC_KT * DP;                // 2 x TC_KT x DP

  const int q0 = blockIdx.x * TC_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int R = min(TC_BQ, Sq - q0);        // live rows of this tile
  const int off = Skv - Sq;                 // query i attends keys <= i + off
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tq = lane & 3;
  // keys past the last row's diagonal are never read: whole tiles skipped
  const int key_end = causal ? max(0, min(q0 + R + off, Skv)) : Skv;
  const int n_tiles = (key_end + TC_KT - 1) / TC_KT;
  // the last key any row of this warp may see (causal), else past them all
  const int warp_kmax = causal ? q0 + warp * 16 + 15 + off : Skv;

  for (int i = tid; i < TC_BQ * C8; i += TC_THREADS) {
    const int r = i / C8, c = i % C8;
    const bool ok = r < R;
    const bf16* src = ok ? q + (((size_t)b * Sq + q0 + r) * H + h) * D + c * 8 : q;
    cp_async16(q_s + r * DP + c * 8, src, ok);
  }
  auto load_tile = [&](int t, int stage) {
    const int k0 = t * TC_KT;
    for (int i = tid; i < TC_KT * C8; i += TC_THREADS) {
      const int j = i / C8, c = i % C8;
      const bool ok = k0 + j < Skv;
      const size_t o = (((size_t)b * Skv + k0 + j) * KV + kvh) * D + c * 8;
      const int d = (stage * TC_KT + j) * DP + c * 8;
      cp_async16(k_s + d, ok ? k + o : k, ok);   // zeros past Skv: P V
      cp_async16(v_s + d, ok ? v + o : v, ok);   // never meets a NaN
    }
  };
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  uint32_t qf[Q_REGS ? KS : 1][4];
  float o[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max of rows gid, gid + 8
  float l[2] = {0.f, 0.f};               // this lane's share of the row sums
  const int qrow = q0 + warp * 16 + gid; // query index of row gid

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();            // tile t (and the q tile) have landed
    __syncthreads();
    if constexpr (Q_REGS) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldsm_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * DP + kk * 16 +
                              (lane >> 4) * 8);
      }
    }
    const int k0 = t * TC_KT;
    const bf16* ks = k_s + (t & 1) * TC_KT * DP;
    const bf16* vs = v_s + (t & 1) * TC_KT * DP;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (Q_REGS) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {          // 16 keys: two 8-key blocks
        if (k0 + np * 16 > warp_kmax) continue; // above every row of the warp
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t kb[4];
          ldsm_x4(kb, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * DP +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma16816(s[2 * np], qf[kk], kb[0], kb[1]);
          mma16816(s[2 * np + 1], qf[kk], kb[2], kb[3]);
        }
      }
    } else {
      // the k-step loop outside the keys: each Q fragment is loaded once a
      // tile, and each score still sums its k-steps in order
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        ldsm_x4(qf[0], q_s + (warp * 16 + (lane & 15)) * DP + kk * 16 +
                           (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (k0 + np * 16 > warp_kmax) continue;
          uint32_t kb[4];
          ldsm_x4(kb, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * DP +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma16816(s[2 * np], qf[0], kb[0], kb[1]);
          mma16816(s[2 * np + 1], qf[0], kb[2], kb[3]);
        }
      }
    }

    // mask on the fragment, scale into the exp2 domain, row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + tq * 2 + (e & 1);
        const int row = qrow + (e >> 1) * 8;
        const bool seen = key < Skv && (!causal || key <= row + off);
        s[n][e] = seen ? s[n][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float corr[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      corr[i] = exp2f(m[i] - m_use[i]);   // 0 while nothing was seen
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      o[n][0] *= corr[0]; o[n][1] *= corr[0];
      o[n][2] *= corr[1]; o[n][3] *= corr[1];
    }

    // P (bf16 hi + lo) V on the tensor cores, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (k0 + kk * 16 > warp_kmax) continue;     // P is 0 there
      float p[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[2 * kk][e] - m_use[e >> 1]);
        p[4 + e] = exp2f(s[2 * kk + 1][e] - m_use[e >> 1]);
      }
      uint32_t ah[4], al[4];           // P = hi + lo, each in bf16
      split2(p[0], p[1], ah[0], al[0]);   // row gid, keys 2tq..+1
      split2(p[2], p[3], ah[1], al[1]);   // row gid + 8
      split2(p[4], p[5], ah[2], al[2]);   // row gid, keys 8 + 2tq..+1
      split2(p[6], p[7], ah[3], al[3]);   // row gid + 8
      l[0] += p[0] + p[1] + p[4] + p[5];
      l[1] += p[2] + p[3] + p[6] + p[7];
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DP +
                          dp * 16 + (lane >> 4) * 8);
        mma16816(o[2 * dp], ah, vb[0], vb[1]);
        mma16816(o[2 * dp], al, vb[0], vb[1]);
        mma16816(o[2 * dp + 1], ah, vb[2], vb[3]);
        mma16816(o[2 * dp + 1], al, vb[2], vb[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before its reload
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + gid + half * 8;
    if (r >= R) continue;
    const float inv = l[half] > 0.f ? 1.f / l[half] : 0.f;   // no key: 0
    bf16* orow = out + (((size_t)b * Sq + q0 + r) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + tq * 2) =
          pack(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out,
                        int B, int Sq, int Skv, int H, int KV, int causal,
                        float scale, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D>();
  static_assert(smem <= SMEM_OPT_IN, "shared memory of the tile");
  static bool sized = false;   // the attribute is set once per instantiation
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid((Sq + TC_BQ - 1) / TC_BQ, H, B);
  flash_attention_bf16_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Skv, H, KV,
      causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Skv, int H, int KV,
                         int causal, float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, out, B, Sq, Skv, H, KV, causal, scale, stream);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, out, B, Sq, Skv, H, KV, causal, scale, stream);
  return cudaErrorInvalidValue;
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
  switch (D) {
    case 16: err = launch_dtype<16>(dtype, q, k, v, out, B, Sq, Skv, H, KV, causal, scale, st); break;
    case 32: err = launch_dtype<32>(dtype, q, k, v, out, B, Sq, Skv, H, KV, causal, scale, st); break;
    case 64: err = launch_dtype<64>(dtype, q, k, v, out, B, Sq, Skv, H, KV, causal, scale, st); break;
    case 80: err = launch_dtype<80>(dtype, q, k, v, out, B, Sq, Skv, H, KV, causal, scale, st); break;
    case 96: err = launch_dtype<96>(dtype, q, k, v, out, B, Sq, Skv, H, KV, causal, scale, st); break;
    case 128: err = launch_dtype<128>(dtype, q, k, v, out, B, Sq, Skv, H, KV, causal, scale, st); break;
    case 256: err = launch_dtype<256>(dtype, q, k, v, out, B, Sq, Skv, H, KV, causal, scale, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
