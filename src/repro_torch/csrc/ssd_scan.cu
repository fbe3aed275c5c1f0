// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: repro/kernels/ssd_scan.py::ssd_scan_pallas (the pl.pallas_call at
// ssd_scan.py:93).  Same function: for each (batch row b, head h), over the
// sequence in chunks of Lc steps,
//   acum_i = sum_{k<=i} A_h dt_k                       (within the chunk)
//   scores[i, j] = (C_i . B_j) exp(acum_i - acum_j)     (j <= i, else 0)
//   y_i = sum_j scores[i, j] (x_j dt_j) + exp(acum_i) (state C_i)
//   state <- exp(acum_last) state + sum_j exp(acum_last - acum_j) (x_j dt_j) B_j^T
// with B and C shared by the H/G heads of a group, an optional initial
// state, y written in x's dtype and the final (P, N) state in float32.  The
// wrapper pads the sequence to a chunk multiple with dt = 0, which is exact.
//
// Bound on the H100: bytes at these widths (x, B, C and y once, the state
// once each way; ~2 (Lc (n + p) + 4 p n) flop per step and head), far from
// the tensor cores' rate.
//
// Design, bfloat16 (the full-width hybrid prefill): the Pallas kernel's two
// MXU products per (b, h, chunk) become four mma.sync.m16n8k16 products per
// chunk, with dt folded so that one operand of each is exact bf16 input:
//   CB^T (Lc x Lc, k = n)          C and B as they are;
//   scores' = CB^T exp(acum_i - acum_j) dt_j, causal, on the fragment;
//   y = exp(acum_i) (C state^T) + scores' x   (k = n, then k = j);
//   state <- exp(acum_last) state + x^T B',  B'[j] = exp(acum_last - acum_j) dt_j B[j].
// Each float32 operand (scores', the state, B') enters the tensor cores as
// bf16 hi + lo parts (mma_bf16.cuh's split2), so each product keeps ~16
// significant bits of it and the final state the float32 band.  One block
// of four warps per (h, b, slice of P columns) walks the chunks in order and
// carries its (P-slice, N) state in f32 accumulator fragments, the role of
// the Pallas kernel's VMEM scratch; since column p of y and row p of the
// state depend only on x[:, p], a grid of fewer blocks than SMs is cut
// along P (the host's plan, from shapes alone; each slice recomputes CB^T).
// A chunk's x, B and C tiles (rows padded to width + 8 bf16, conflict-free
// ldmatrix) and its dt are staged by cp.async into a two-stage ring, the
// next chunk loading while this one computes; rows past Lc (chunk 8 or 16)
// are zero-filled and masked.  Warp w owns chunk rows 16w..16w+15 of CB^T
// and y (the causal part only: j-tiles <= w) and a 16-row group of the
// state; warp 0 takes the chunk's prefix sums with a warp scan.  Head dim p
// a multiple of 16, state width n in {16, 32, 64, 128}, Lc <= 64.
//
// float32 inputs (the configs' default dtype, run at smoke size) stay on
// the first kernel: one block per (h, b), 640 blocks at Zamba2-2.7B's
// prefill (b=8, h=80), walking its chunks in order with the (P, N) float32
// state in shared memory.  Per chunk the block stages x*dt, B and C of the
// chunk in shared memory as float32 (about 80 KB with the state at p = n =
// Lc = 64, so the kernel runs on dynamic shared memory above the 48 KB
// static limit), computes the prefix sums, then the three products as plain
// FMA loops, one output entry per thread in turn.  Rows of the state and of
// B are padded by one float against bank conflicts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

size_t smem_floats(int P, int N, int Lc) {
  return (size_t)P * (N + 1)      // state, rows padded
         + (size_t)Lc * P         // x * dt
         + (size_t)Lc * (N + 1)   // B, rows padded
         + (size_t)Lc * N         // C
         + (size_t)Lc * Lc        // scores
         + 4 * (size_t)Lc;        // dt, acum, exp(acum), exp(acum_last - acum)
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ init,
                T* __restrict__ y, float* __restrict__ final_state, int S,
                int H, int P, int G, int N, int Lc) {
  extern __shared__ float smem[];
  float* st = smem;                        // P x (N + 1)
  float* xw = st + P * (N + 1);            // Lc x P
  float* bs = xw + Lc * P;                 // Lc x (N + 1)
  float* cs = bs + Lc * (N + 1);           // Lc x N
  float* sc = cs + Lc * N;                 // Lc x Lc
  float* dts = sc + Lc * Lc;               // Lc
  float* acum = dts + Lc;                  // Lc
  float* e_in = acum + Lc;                 // exp(acum_i)
  float* e_out = e_in + Lc;                // exp(acum_last - acum_j)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const float a = A[h];
  const size_t state_off = ((size_t)b * H + h) * P * N;

  for (int i = tid; i < P * N; i += THREADS) {
    st[(i / N) * (N + 1) + i % N] = init != nullptr ? init[state_off + i] : 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += Lc) {
    __syncthreads();  // the previous chunk is fully consumed
    for (int i = tid; i < Lc; i += THREADS) dts[i] = dt[((size_t)b * S + s0 + i) * H + h];
    __syncthreads();
    for (int i = tid; i < Lc * P; i += THREADS) {
      const int l = i / P, j = i % P;
      xw[i] = to_f(x[(((size_t)b * S + s0 + l) * H + h) * P + j]) * dts[l];
    }
    for (int i = tid; i < Lc * N; i += THREADS) {
      const int l = i / N, k = i % N;
      const size_t off = (((size_t)b * S + s0 + l) * G + g) * N + k;
      bs[l * (N + 1) + k] = to_f(Bm[off]);
      cs[i] = to_f(Cm[off]);
    }
    if (tid == 0) {
      float run = 0.f;
      for (int l = 0; l < Lc; ++l) {
        run += a * dts[l];
        acum[l] = run;
      }
    }
    __syncthreads();
    const float last = acum[Lc - 1];
    for (int i = tid; i < Lc; i += THREADS) {
      e_in[i] = expf(acum[i]);
      e_out[i] = expf(last - acum[i]);
    }
    // intra-chunk scores, causal within the chunk
    for (int i = tid; i < Lc * Lc; i += THREADS) {
      const int r = i / Lc, c = i % Lc;
      float v = 0.f;
      if (c <= r) {
        const float* crow = cs + r * N;
        const float* brow = bs + c * (N + 1);
        float dot = 0.f;
        for (int k = 0; k < N; ++k) dot = fmaf(crow[k], brow[k], dot);
        v = dot * expf(acum[r] - acum[c]);
      }
      sc[i] = v;
    }
    __syncthreads();
    // y = scores (x dt) + exp(acum) (C state^T)
    for (int i = tid; i < Lc * P; i += THREADS) {
      const int l = i / P, j = i % P;
      float acc = 0.f;
      for (int m = 0; m <= l; ++m) acc = fmaf(sc[l * Lc + m], xw[m * P + j], acc);
      const float* crow = cs + l * N;
      const float* srow = st + j * (N + 1);
      float cst = 0.f;
      for (int k = 0; k < N; ++k) cst = fmaf(crow[k], srow[k], cst);
      acc = fmaf(e_in[l], cst, acc);
      y[(((size_t)b * S + s0 + l) * H + h) * P + j] = from_f<T>(acc);
    }
    __syncthreads();  // every read of the old state is done
    const float e_last = expf(last);
    for (int i = tid; i < P * N; i += THREADS) {
      const int j = i / N, k = i % N;
      float acc = 0.f;
      for (int m = 0; m < Lc; ++m)
        acc = fmaf(e_out[m] * xw[m * P + j], bs[m * (N + 1) + k], acc);
      float* sp = st + j * (N + 1) + k;
      *sp = fmaf(e_last, *sp, acc);
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += THREADS) {
    final_state[state_off + i] = st[(i / N) * (N + 1) + i % N];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* init, void* y, float* fs, int Bsz,
                   int S, int H, int P, int G, int N, int Lc, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(P, N, Lc);
  static size_t sized = 0;   // set once per instantiation and larger size
  if (smem > sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    sized = smem;
  }
  const dim3 grid(H, Bsz);
  ssd_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), init, static_cast<T*>(y), fs, S, H, P, G, N, Lc);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: the chunk products on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 128;   // four warps
constexpr int LT = 64;         // chunk rows a stage holds (Lc <= 64)
constexpr unsigned FULL = 0xffffffffu;

// 4 bytes from global to shared (zero-filled when !valid): a chunk's dt
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   mma_bf16::smem_addr(dst)),
               "l"(src), "r"(n));
}

// Shared memory of a block for a P-slice of PB columns and state width N:
// two stages of (x LT x XP, B and C LT x NP), B' hi and lo (LT x NP), the
// state at the chunk start hi and lo (PB x NP), then floats: two stages of
// dt, acum, exp(acum), the update weights w and acum_last.
template <int PB, int N>
struct Layout {
  static constexpr int XP = PB + 8;   // padded rows (bf16): 16 bytes over a
  static constexpr int NP = N + 8;    // multiple of 32, conflict-free ldmatrix
  static constexpr int STAGE = LT * XP + 2 * LT * NP;
  static constexpr size_t BYTES =
      sizeof(bf16) * ((size_t)2 * STAGE + 2 * LT * NP + 2 * PB * NP) +
      sizeof(float) * (5 * LT + 4);
};

template <int PB, int N>
__global__ void __launch_bounds__(THREADS)
ssd_scan_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const bf16* __restrict__ Bm,
                   const bf16* __restrict__ Cm, const float* __restrict__ init,
                   bf16* __restrict__ y, float* __restrict__ final_state,
                   int S, int H, int P, int G, int Lc) {
  using namespace mma_bf16;
  using L = Layout<PB, N>;
  static_assert(PB % 16 == 0 && PB <= 64 && N % 16 == 0 && N <= 128, "shape");
  constexpr int XP = L::XP, NP = L::NP;
  constexpr int RG = PB / 16;                  // 16-row groups of the state slice
  constexpr int WPG = 4 / RG;                  // warps sharing a row group
  constexpr int NB16 = N / 16;                 // 16-column pairs of the state
  constexpr int NBW = (NB16 + WPG - 1) / WPG;  // pairs a warp owns
  constexpr int KN = N / 16;                   // k-steps over the state width
  constexpr int PN = PB / 16;                  // 16-column pairs of y
  constexpr int XC = PB / 8, NC = N / 8;       // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stages = reinterpret_cast<bf16*>(smem_raw);   // 2 x (x, B, C)
  bf16* bp_hi = stages + 2 * L::STAGE;                // B' = w_j B[j], hi
  bf16* bp_lo = bp_hi + LT * NP;                      //                lo
  bf16* st_hi = bp_lo + LT * NP;    // the state at the chunk start, hi
  bf16* st_lo = st_hi + PB * NP;    //                                lo
  float* dt_s = reinterpret_cast<float*>(st_lo + PB * NP);   // 2 x LT
  float* acum_s = dt_s + 2 * LT;
  float* ein_s = acum_s + LT;       // exp(acum_i)
  float* w_s = ein_s + LT;          // exp(acum_last - acum_j) dt_j, 0 past Lc
  float* last_s = w_s + LT;         // acum_last

  const int n_ps = P / PB;
  const int h = blockIdx.x / n_ps;
  const int p0 = (blockIdx.x % n_ps) * PB;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tq = lane & 3;
  const float a = A[h];
  const int NT = (Lc + 15) / 16;    // 16-row tiles of a chunk
  const int n_chunks = S / Lc;
  const size_t state_off = ((size_t)b * H + h) * P * N + (size_t)p0 * N;
  // this warp's share of the state slice: rows rg*16.., pairs wc*NBW..
  const int rg = warp / WPG;
  const int wc = warp % WPG;

  float sf[2 * NBW][4];   // the carried state, f32 fragments
#pragma unroll
  for (int i = 0; i < NBW; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = (wc * NBW + i) * 16 + half * 8 + 2 * tq;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float2 v = make_float2(0.f, 0.f);
        if (init != nullptr && wc * NBW + i < NB16)
          v = *reinterpret_cast<const float2*>(
              init + state_off + (size_t)(rg * 16 + gid + rr * 8) * N + col);
        sf[2 * i + half][2 * rr] = v.x;
        sf[2 * i + half][2 * rr + 1] = v.y;
      }
    }
  }
  auto store_state = [&]() {   // the fragments as bf16 hi + lo rows
#pragma unroll
    for (int i = 0; i < NBW; ++i) {
      if (wc * NBW + i >= NB16) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = (wc * NBW + i) * 16 + half * 8 + 2 * tq;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = rg * 16 + gid + rr * 8;
          uint32_t hi, lo;
          split2(sf[2 * i + half][2 * rr], sf[2 * i + half][2 * rr + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(st_hi + row * NP + col) = hi;
          *reinterpret_cast<uint32_t*>(st_lo + row * NP + col) = lo;
        }
      }
    }
  };

  auto load_chunk = [&](int c, int stg) {
    bf16* xs = stages + stg * L::STAGE;
    bf16* bs = xs + LT * XP;
    bf16* cs = bs + LT * NP;
    const int rows = NT * 16;
    for (int i = tid; i < rows * (XC + 2 * NC); i += THREADS) {
      const int r = i / (XC + 2 * NC);
      const int u = i % (XC + 2 * NC);
      const bool ok = r < Lc;
      const size_t srow = (size_t)b * S + (size_t)c * Lc + r;
      if (u < XC) {
        cp_async16(xs + r * XP + u * 8,
                   ok ? x + (srow * H + h) * P + p0 + u * 8 : x, ok);
      } else {
        const bool is_b = u < XC + NC;
        const int cc = is_b ? u - XC : u - XC - NC;
        const bf16* src = is_b ? Bm : Cm;
        cp_async16((is_b ? bs : cs) + r * NP + cc * 8,
                   ok ? src + (srow * G + g) * N + cc * 8 : src, ok);
      }
    }
    if (tid < rows) {
      const bool ok = tid < Lc;
      cp_async4(dt_s + stg * LT + tid,
                ok ? dt + ((size_t)b * S + (size_t)c * Lc + tid) * H + h : dt,
                ok);
    }
  };

  if (n_chunks > 0) load_chunk(0, 0);
  cp_async_commit();
  store_state();   // read after the first barrier

  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) load_chunk(c + 1, (c + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();   // chunk c has landed
    __syncthreads();
    const int stg = c & 1;
    const bf16* xs = stages + stg * L::STAGE;
    const bf16* bs = xs + LT * XP;
    const bf16* cs = bs + LT * NP;
    const float* dts = dt_s + stg * LT;

    if (warp == 0) {   // acum: an inclusive warp scan of A_h dt, two rows a lane
      float v0 = lane < Lc ? a * dts[lane] : 0.f;
      float v1 = lane + 32 < Lc ? a * dts[lane + 32] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(FULL, v0, o);
        const float u1 = __shfl_up_sync(FULL, v1, o);
        if (lane >= o) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(FULL, v0, 31);
      const float last = __shfl_sync(FULL, Lc > 32 ? v1 : v0, (Lc - 1) & 31);
      acum_s[lane] = v0;
      acum_s[lane + 32] = v1;
      ein_s[lane] = expf(v0);
      ein_s[lane + 32] = expf(v1);
      w_s[lane] = lane < Lc ? expf(last - v0) * dts[lane] : 0.f;
      w_s[lane + 32] = lane + 32 < Lc ? expf(last - v1) * dts[lane + 32] : 0.f;
      if (lane == 0) *last_s = last;
    }

    // C B^T for this warp's 16 rows, the causal j-tiles only
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if (warp < NT) {
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        uint32_t cf[4];
        ldsm_x4(cf, cs + (warp * 16 + (lane & 15)) * NP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np > warp) continue;
          uint32_t kb[4];
          ldsm_x4(kb, bs + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * NP +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma16816(s[2 * np], cf, kb[0], kb[1]);
          mma16816(s[2 * np + 1], cf, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();   // acum, exp(acum), w

    // B' = w_j B[j] as bf16 hi + lo rows (zero past Lc: w = 0, B = 0)
    for (int i = tid; i < NT * 16 * (N / 2); i += THREADS) {
      const int j = i / (N / 2), k = (i % (N / 2)) * 2;
      const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(bs + j * NP + k);
      const float wj = w_s[j];
      uint32_t hi, lo;
      split2(wj * __low2float(bv), wj * __high2float(bv), hi, lo);
      *reinterpret_cast<uint32_t*>(bp_hi + j * NP + k) = hi;
      *reinterpret_cast<uint32_t*>(bp_lo + j * NP + k) = lo;
    }

    if (warp < NT) {
      const int i0 = warp * 16 + gid;   // this lane's rows i0 and i0 + 8
      float acc[2 * PN][4];
#pragma unroll
      for (int n = 0; n < 2 * PN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      // the carried state: C (exact) times the state's hi and lo parts
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        uint32_t cf[4];
        ldsm_x4(cf, cs + (warp * 16 + (lane & 15)) * NP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int pp = 0; pp < PN; ++pp) {
          const int o = (pp * 16 + (lane & 7) + ((lane >> 4) << 3)) * NP +
                        kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t sh[4], sl[4];
          ldsm_x4(sh, st_hi + o);
          ldsm_x4(sl, st_lo + o);
          mma16816(acc[2 * pp], cf, sh[0], sh[1]);
          mma16816(acc[2 * pp], cf, sl[0], sl[1]);
          mma16816(acc[2 * pp + 1], cf, sh[2], sh[3]);
          mma16816(acc[2 * pp + 1], cf, sl[2], sl[3]);
        }
      }
      const float e0 = ein_s[i0], e1 = ein_s[i0 + 8];
#pragma unroll
      for (int n = 0; n < 2 * PN; ++n) {
        acc[n][0] *= e0; acc[n][1] *= e0;
        acc[n][2] *= e1; acc[n][3] *= e1;
      }
      // scores' = C B^T exp(acum_i - acum_j) dt_j where j <= i < Lc, else 0
      const float a0 = acum_s[i0], a1 = acum_s[i0 + 8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n / 2 > warp) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = n * 8 + 2 * tq + (e & 1);
          const int i = i0 + (e >> 1) * 8;
          const float ai = (e >> 1) ? a1 : a0;
          s[n][e] = (j <= i && j < Lc) ? s[n][e] * expf(ai - acum_s[j]) * dts[j]
                                       : 0.f;
        }
      }
      // + scores' (hi + lo) times x (exact), over the causal j-tiles
#pragma unroll
      for (int kj = 0; kj < 4; ++kj) {
        if (kj > warp) continue;
        uint32_t ah[4], al[4];
        split2(s[2 * kj][0], s[2 * kj][1], ah[0], al[0]);          // row i0
        split2(s[2 * kj][2], s[2 * kj][3], ah[1], al[1]);          // row i0 + 8
        split2(s[2 * kj + 1][0], s[2 * kj + 1][1], ah[2], al[2]);  // j + 8
        split2(s[2 * kj + 1][2], s[2 * kj + 1][3], ah[3], al[3]);
#pragma unroll
        for (int pp = 0; pp < PN; ++pp) {
          uint32_t xb[4];
          ldsm_x4_t(xb, xs + (kj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * XP +
                            pp * 16 + (lane >> 4) * 8);
          mma16816(acc[2 * pp], ah, xb[0], xb[1]);
          mma16816(acc[2 * pp], al, xb[0], xb[1]);
          mma16816(acc[2 * pp + 1], ah, xb[2], xb[3]);
          mma16816(acc[2 * pp + 1], al, xb[2], xb[3]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = i0 + rr * 8;
        if (i >= Lc) continue;
        bf16* yr = y + (((size_t)b * S + (size_t)c * Lc + i) * H + h) * P + p0;
#pragma unroll
        for (int n = 0; n < 2 * PN; ++n)
          *reinterpret_cast<uint32_t*>(yr + n * 8 + 2 * tq) =
              pack(acc[n][2 * rr], acc[n][2 * rr + 1]);
      }
    }
    __syncthreads();   // B' is written; every read of the old state is done

    // state <- exp(acum_last) state + x^T (B' hi + lo): this warp's share
    const float e_last = expf(*last_s);
#pragma unroll
    for (int i = 0; i < 2 * NBW; ++i) {
      sf[i][0] *= e_last; sf[i][1] *= e_last;
      sf[i][2] *= e_last; sf[i][3] *= e_last;
    }
    for (int kj = 0; kj < NT; ++kj) {
      uint32_t xa[4];   // x^T rows rg*16.. (p), k = j: x read transposed
      ldsm_x4_t(xa, xs + (kj * 16 + (lane & 7) + ((lane >> 4) << 3)) * XP +
                        rg * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int i = 0; i < NBW; ++i) {
        const int c16 = wc * NBW + i;
        if (c16 >= NB16) continue;
        const int o = (kj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * NP +
                      c16 * 16 + (lane >> 4) * 8;
        uint32_t bh[4], bl[4];
        ldsm_x4_t(bh, bp_hi + o);
        ldsm_x4_t(bl, bp_lo + o);
        mma16816(sf[2 * i], xa, bh[0], bh[1]);
        mma16816(sf[2 * i], xa, bl[0], bl[1]);
        mma16816(sf[2 * i + 1], xa, bh[2], bh[3]);
        mma16816(sf[2 * i + 1], xa, bl[2], bl[3]);
      }
    }
    store_state();
    __syncthreads();   // the new state is written; stage c is free for reloading
  }

#pragma unroll
  for (int i = 0; i < NBW; ++i) {
    if (wc * NBW + i >= NB16) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = (wc * NBW + i) * 16 + half * 8 + 2 * tq;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        *reinterpret_cast<float2*>(
            final_state + state_off + (size_t)(rg * 16 + gid + rr * 8) * N + col) =
            make_float2(sf[2 * i + half][2 * rr], sf[2 * i + half][2 * rr + 1]);
    }
  }
}

template <int PB, int N>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* init, void* y,
                   float* fs, int Bsz, int S, int H, int P, int G, int Lc,
                   cudaStream_t stream) {
  constexpr size_t smem = Layout<PB, N>::BYTES;
  static bool sized = false;   // the attribute is set once per instantiation
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_tc_kernel<PB, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 grid(H * (P / PB), Bsz);
  ssd_scan_tc_kernel<PB, N><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), init, static_cast<bf16*>(y), fs, S, H, P,
      G, Lc);
  return cudaGetLastError();
}

template <int PB>
cudaError_t dispatch_n(int N, const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, const float* init,
                       void* y, float* fs, int Bsz, int S, int H, int P, int G,
                       int Lc, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<PB, 16>(x, dt, A, Bm, Cm, init, y, fs, Bsz, S, H, P, G, Lc, stream);
    case 32: return launch<PB, 32>(x, dt, A, Bm, Cm, init, y, fs, Bsz, S, H, P, G, Lc, stream);
    case 64: return launch<PB, 64>(x, dt, A, Bm, Cm, init, y, fs, Bsz, S, H, P, G, Lc, stream);
    case 128: return launch<PB, 128>(x, dt, A, Bm, Cm, init, y, fs, Bsz, S, H, P, G, Lc, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int p_block, int N, const void* x, const float* dt,
                     const float* A, const void* Bm, const void* Cm,
                     const float* init, void* y, float* fs, int Bsz, int S,
                     int H, int P, int G, int Lc, cudaStream_t stream) {
  if (Lc > LT || p_block < 1 || P % p_block != 0)
    return cudaErrorInvalidValue;
  switch (p_block) {
    case 16: return dispatch_n<16>(N, x, dt, A, Bm, Cm, init, y, fs, Bsz, S, H, P, G, Lc, stream);
    case 32: return dispatch_n<32>(N, x, dt, A, Bm, Cm, init, y, fs, Bsz, S, H, P, G, Lc, stream);
    case 64: return dispatch_n<64>(N, x, dt, A, Bm, Cm, init, y, fs, Bsz, S, H, P, G, Lc, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// Dynamic shared memory, in bytes, the float32 kernel needs at these widths
// (the wrapper refuses widths above the card's 227 KB per block).
extern "C" long long ssd_scan_smem_bytes(int P, int N, int Lc) {
  return (long long)(sizeof(float) * smem_floats(P, N, Lc));
}

// x (Bsz, S, H, P); dt (Bsz, S, H) float32; A (H,) float32; B, C (Bsz, S, G, N)
// of x's dtype; init (Bsz, H, P, N) float32 or null; y like x; fs (Bsz, H, P, N)
// float32.  All contiguous; dtype 0 = float32, 1 = bfloat16; S a multiple of
// Lc; G divides H.  For bfloat16 (16-byte aligned x, B, C), ``p_block`` (16,
// 32 or 64, dividing P) is the P-slice of a block from the host's plan, N is
// 16, 32, 64 or 128 and Lc at most 64; float32 ignores ``p_block``.  Returns
// the cudaError_t of the launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* init,
                               void* y, void* fs, int Bsz, int S, int H, int P,
                               int G, int N, int Lc, int p_block, int dtype,
                               void* stream) {
  if (Lc < 1 || S % Lc != 0 || G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A);
  const float* ip = static_cast<const float*>(init);
  float* fsp = static_cast<float*>(fs);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, dtp, Ap, Bm, Cm, ip, y, fsp, Bsz, S, H, P, G, N, Lc, st);
  } else if (dtype == 1) {
    err = tc::dispatch(p_block, N, x, dtp, Ap, Bm, Cm, ip, y, fsp, Bsz, S, H, P,
                       G, Lc, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
