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
// Design.  One block per (h, b), 640 blocks at Zamba2-2.7B's prefill (b=8,
// h=80).  The block walks its chunks in order and carries the (P, N) float32
// state in shared memory between them: the role of the Pallas kernel's VMEM
// scratch, since blocks cannot carry anything to one another.  Per chunk the
// block stages x*dt, B and C of the chunk in shared memory as float32 (about
// 80 KB with the state at p = n = Lc = 64, so the kernel runs on dynamic
// shared memory above the 48 KB static limit), computes the prefix sums,
// then the three products as plain FMA loops, one output entry per thread
// in turn.  Rows of the state and of B are padded by one float against bank
// conflicts.  Simple and right first: this is the layout that later moves
// onto tensor cores (wgmma).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

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
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, Bsz);
  ssd_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), init, static_cast<T*>(y), fs, S, H, P, G, N, Lc);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory, in bytes, the kernel needs at these widths (the
// wrapper refuses widths above the card's 227 KB per block).
extern "C" long long ssd_scan_smem_bytes(int P, int N, int Lc) {
  return (long long)(sizeof(float) * smem_floats(P, N, Lc));
}

// x (Bsz, S, H, P); dt (Bsz, S, H) float32; A (H,) float32; B, C (Bsz, S, G, N)
// of x's dtype; init (Bsz, H, P, N) float32 or null; y like x; fs (Bsz, H, P, N)
// float32.  All contiguous; dtype 0 = float32, 1 = bfloat16; S a multiple of
// Lc; G divides H.  Returns the cudaError_t of the launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* init,
                               void* y, void* fs, int Bsz, int S, int H, int P,
                               int G, int N, int Lc, int dtype, void* stream) {
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
    err = launch<__nv_bfloat16>(x, dtp, Ap, Bm, Cm, ip, y, fsp, Bsz, S, H, P, G, N, Lc, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
