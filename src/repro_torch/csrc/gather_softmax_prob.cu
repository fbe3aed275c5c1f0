// Fused softmax normalizer + token gather for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces: repro/kernels/gather_softmax_prob.py::gather_softmax_prob_pallas
// (the pl.pallas_call at gather_softmax_prob.py:75).  Same function:
// p[n] = softmax(logits[n])[ids[n]] in f32, without writing the (N, V)
// softmax to device memory.
//
// Bound on the H100: bytes.  Each logit is read once (N * V * 4 bytes:
// 12.3 MB at N = 96 tree nodes, V = 32000) for a max, an exp and an add.
//
// Design.  One block per row and one pass over V: each thread keeps an
// online (max, sum of exp) pair over a strided share of the row, the block
// merges the pairs (two warp-shuffle levels), and thread 0 reads the picked
// logit and writes exp(pick - m) / l.  The TPU kernel carries the same
// running pair across its sequential vocab grid axis in VMEM; here the V
// loop runs inside the block.  V need not be a multiple of anything.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;  // threads per block
constexpr unsigned FULL = 0xffffffffu;

// merge (m2, s2) into (m, s): both are online-softmax pairs, s = sum exp(x - m)
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) { m = m2; s = s2; return; }
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__device__ __forceinline__ void warp_merge(float& m, float& s) {
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(FULL, m, o);
    const float s2 = __shfl_xor_sync(FULL, s, o);
    merge(m, s, m2, s2);
  }
}

__global__ void __launch_bounds__(NT)
gather_softmax_prob_kernel(const float* __restrict__ logits,
                           const int* __restrict__ ids, float* __restrict__ out,
                           int V) {
  __shared__ float red_m[NT / 32], red_s[NT / 32];
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  const float* row = logits + (size_t)n * V;

  float m = -INFINITY, s = 0.f;
  for (int v = tid; v < V; v += NT) {
    const float x = row[v];
    if (x > m) {
      s = (m == -INFINITY ? 0.f : s * expf(m - x)) + 1.f;
      m = x;
    } else if (m != -INFINITY) {  // -inf logits add nothing
      s += expf(x - m);
    }
  }
  warp_merge(m, s);
  const int w = tid >> 5, lane = tid & 31;
  if (lane == 0) { red_m[w] = m; red_s[w] = s; }
  __syncthreads();
  if (w == 0) {
    m = lane < NT / 32 ? red_m[lane] : -INFINITY;
    s = lane < NT / 32 ? red_s[lane] : 0.f;
    warp_merge(m, s);
    if (lane == 0) {
      const int id = min(max(ids[n], 0), V - 1);
      out[n] = expf(row[id] - m) / s;
    }
  }
}

}  // namespace

// logits (N, V) f32; ids (N,) int32; out (N,) f32.  All contiguous.
// Returns the cudaError_t of the launch.
extern "C" int gather_softmax_prob_launch(const void* logits, const void* ids,
                                          void* out, int N, int V, void* stream) {
  if (N < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  gather_softmax_prob_kernel<<<N, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(ids),
      static_cast<float*>(out), V);
  return static_cast<int>(cudaGetLastError());
}
