// Residual-distribution inverse-CDF sampler for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces: repro/kernels/residual_sample.py::residual_sample_pallas (the
// pl.pallas_call at residual_sample.py:91).  Same function: the calibrated
// token of paper eq. 5, a sample from normalize(max(p - q, 0)) by inverse
// CDF with the caller's uniform u: the first index whose running residual
// sum exceeds u * Z, Z = sum max(p - q, 0); argmax(p) when Z <= 0.  Two
// choices follow the JAX oracle (ref.py::residual_sample_ref) where the
// Pallas kernel differs: argmax(p) takes the FIRST index on ties (the
// Pallas kernel takes the last in a tile), and when rounding leaves u * Z
// at or past the last CDF value (nothing crosses) the token is V - 1 (the
// Pallas kernel returns argmax(p)).
//
// Bound on the H100: bytes.  p and q are read once each (2 * N * V * 4
// bytes: 2 MB at N = 8, V = 32000) for a subtract, a max and an add; the
// second sweep stops at the crossing and mostly hits L2.
//
// Design.  One block of 1024 threads per row, two sweeps: (1) Z and the
// (value, index) argmax of p by strided loads and block reductions; (2) an
// ordered inverse-CDF scan over tiles of 4096 entries (4 consecutive per
// thread, block exclusive scan of the thread sums) that stops at the first
// tile that crosses u * Z -- the scan of fused_verify_sample.cu.  The TPU
// kernel carries Z, the running sum and the found token across its
// sequential (phase, tile) grid in VMEM.  The sums run in another order
// than torch's, so the token can differ from the plain version only where
// u * Z lies within rounding of a CDF step.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;        // threads per block
constexpr int ITEMS = 4;        // consecutive vocab entries per thread in sweep 2
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ int warp_min_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Block reductions: every thread gets the result.  `red` holds 32 slots.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  v = lane < (blockDim.x >> 5) ? red[lane] : 0.f;
  return warp_sum(v);
}
__device__ int block_min_i(int v, int* red) {
  v = warp_min_i(v);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  v = lane < (blockDim.x >> 5) ? red[lane] : INT_MAX;
  return warp_min_i(v);
}
// (value, index) argmax: larger value wins, ties go to the smaller index.
__device__ void block_argmax(float& v, int& i, float* redf, int* redi) {
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(FULL, v, o);
    const int i2 = __shfl_xor_sync(FULL, i, o);
    if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) { redf[w] = v; redi[w] = i; }
  __syncthreads();
  const bool ok = lane < (blockDim.x >> 5);
  v = ok ? redf[lane] : -INFINITY;
  i = ok ? redi[lane] : INT_MAX;
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(FULL, v, o);
    const int i2 = __shfl_xor_sync(FULL, i, o);
    if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
  }
}
// Exclusive prefix sum over the block; `total` receives the block sum.
__device__ float block_exclusive_scan(float v, float* red, float& total) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += n;
  }
  __syncthreads();
  if (lane == 31) red[w] = inc;
  __syncthreads();
  if (w == 0) {
    float s = lane < (blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += n;
    }
    red[lane] = s;  // inclusive scan of the warp totals
  }
  __syncthreads();
  total = red[(blockDim.x >> 5) - 1];
  const float warp_off = w > 0 ? red[w - 1] : 0.f;
  return warp_off + inc - v;
}

__global__ void __launch_bounds__(NT)
residual_sample_kernel(const float* __restrict__ p, const float* __restrict__ q,
                       const float* __restrict__ u, int* __restrict__ out, int V) {
  __shared__ float redf[32];
  __shared__ int redi[32];
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const float* prow = p + (size_t)n * V;
  const float* qrow = q + (size_t)n * V;

  // ---- sweep 1: residual mass Z and argmax(p) ----
  float z = 0.f, best = -INFINITY;
  int best_i = INT_MAX;
  for (int v = tid; v < V; v += NT) {
    const float pv = prow[v];
    z += fmaxf(pv - qrow[v], 0.f);
    if (pv > best) { best = pv; best_i = v; }  // strided: first index per thread
  }
  z = block_sum(z, redf);
  block_argmax(best, best_i, redf, redi);

  // ---- sweep 2: inverse-CDF crossing of u * Z ----
  int token;
  if (z <= 0.f) {
    token = best_i;
  } else {
    const float target = u[n] * z;
    float running = 0.f;
    int found = INT_MAX;
    for (int base = 0; base < V; base += NT * ITEMS) {
      const int v0 = base + tid * ITEMS;
      float loc[ITEMS];
      float tsum = 0.f;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int v = v0 + i;
        const float r = v < V ? fmaxf(prow[v] - qrow[v], 0.f) : 0.f;
        loc[i] = r;
        tsum += r;
      }
      float total;
      float c = running + block_exclusive_scan(tsum, redf, total);
      int hit = INT_MAX;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        c += loc[i];
        if (hit == INT_MAX && c > target && v0 + i < V) hit = v0 + i;
      }
      hit = block_min_i(hit, redi);
      running += total;
      if (hit != INT_MAX) { found = hit; break; }  // uniform: every thread has hit
    }
    token = found != INT_MAX ? found : V - 1;
  }
  if (tid == 0) out[n] = token;
}

}  // namespace

// p, q (N, V) f32; u (N,) f32; out (N,) int32.  All contiguous.  Returns the
// cudaError_t of the launch.
extern "C" int residual_sample_launch(const void* p, const void* q, const void* u,
                                      void* out, int N, int V, void* stream) {
  if (N < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  residual_sample_kernel<<<N, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(q),
      static_cast<const float*>(u), static_cast<int*>(out), V);
  return static_cast<int>(cudaGetLastError());
}
