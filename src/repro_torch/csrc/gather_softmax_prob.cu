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
// Design.  A block a row with one 4-byte load a thread in flight behind a
// data-dependent exp keeps too few bytes in flight.  Here each thread keeps
// UV 16-byte loads in flight before any exp, and each row's V entries are
// cut into C contiguous chunks (kernels/fused_verify_sample.py::
// row_split_plan, from the shapes and the SM count alone: ~2 blocks a SM,
// C = 1 once the rows outnumber the SMs), so that few rows with a long
// vocabulary still fill the card; one block of 256 threads per (row, chunk):
//   1. the block sweeps its chunk with 16-byte loads, UV of them in flight a
//      thread before any exp (scalar loads for the unaligned head and tail,
//      at most 3 entries each), and keeps an online (max, sum of exp) pair a
//      thread, rescaled once a batch: the batch's max first, then its sum;
//   2. it merges the pairs over the block by a fixed tree (the max first,
//      then each sum rescaled to it once, then plain sums);
//   3. with C = 1 it writes exp(pick - m) / s itself.  Else it writes its
//      partial (m, s), fences, and takes the row's ticket; the last block of
//      the row to arrive merges the C partials in a fixed order (max first,
//      each lane its chunks in order, then the warp's tree, so no bit
//      depends on which block finished first) and writes exp(pick - M) / S,
//      pick = logits[n, clamp(ids[n])] (read by every block's thread 0
//      while it merges, so no load waits at the end); the ticket is reset to
//      0 as the last block arrives: one ordinary launch, no block waits for
//      another.
// The TPU kernel carries the running pair across its sequential vocab grid
// axis in VMEM.  V need not be a multiple of anything.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int NW = NT / 32;    // warps per block
constexpr int UV = 4;          // 16-byte loads a thread keeps in flight
constexpr unsigned FULL = 0xffffffffu;

// add K values (-inf for none) to a thread's online pair: the batch's max
// first, the running sum rescaled to it once, then the K exps
template <int K>
__device__ __forceinline__ void add_batch(float& m, float& s, const float (&x)[K]) {
  float mx = x[0];
#pragma unroll
  for (int k = 1; k < K; ++k) mx = fmaxf(mx, x[k]);
  if (mx > m) {
    s *= expf(m - mx);           // 0 while nothing was seen
    m = mx;
  }
  if (m != -INFINITY) {
#pragma unroll
    for (int k = 0; k < K; ++k) s += expf(x[k] - m);
  }
}

// (m, s) merged over the warp, every lane gets it: the max first, each
// lane's sum rescaled to it once, then a butterfly of plain sums
__device__ __forceinline__ void warp_merge(float& m, float& s) {
  float M = m;
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, o));
  s = m == -INFINITY ? 0.f : s * expf(m - M);
  m = M;
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
}

__global__ void __launch_bounds__(NT)
gather_softmax_prob_kernel(const float* __restrict__ logits,
                           const int* __restrict__ ids, float* __restrict__ out,
                           int V, int C, int chunk, float2* part, int* tickets) {
  __shared__ float wm[NW], ws[NW];
  const int n = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const float* row = logits + (size_t)n * V;
  const int c0 = c * chunk;
  const float* base = row + c0;
  const int len = min(chunk, V - c0);
  // the 16-byte-aligned body [head, tail) of the chunk, scalars around it
  const int head = min(len, (int)((16 - (reinterpret_cast<uintptr_t>(base) & 15)) & 15) >> 2);
  const int nvec = (len - head) >> 2;
  const int tail = head + 4 * nvec;
  const float4* body = reinterpret_cast<const float4*>(base + head);
  const int id = ids[n];           // read early, used by thread 0 only

  float m = -INFINITY, s = 0.f;
  {
    float x[2];
    x[0] = tid < head ? base[tid] : -INFINITY;
    x[1] = tail + tid < len ? base[tail + tid] : -INFINITY;
    add_batch(m, s, x);
  }
  for (int i = tid; i < nvec; i += UV * NT) {
    float x[4 * UV];
#pragma unroll
    for (int u = 0; u < UV; ++u) {   // UV loads in flight before any exp
      const float4 v = i + u * NT < nvec
                           ? body[i + u * NT]
                           : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      x[4 * u] = v.x;
      x[4 * u + 1] = v.y;
      x[4 * u + 2] = v.z;
      x[4 * u + 3] = v.w;
    }
    add_batch(m, s, x);
  }

  // the picked logit: in flight while the block merges
  const float pick = tid == 0 ? row[min(max(id, 0), V - 1)] : 0.f;

  // the block's pair: each warp, then warp 0 over the warps
  warp_merge(m, s);
  if (lane == 0) {
    wm[w] = m;
    ws[w] = s;
  }
  __syncthreads();
  if (w != 0) return;
  m = lane < NW ? wm[lane] : -INFINITY;
  s = lane < NW ? ws[lane] : 0.f;
  warp_merge(m, s);
  if (C == 1) {
    if (lane == 0) out[n] = expf(pick - m) / s;
    return;
  }

  // the last block of the row to finish merges the C partials
  int last = 0;
  if (lane == 0) {
    part[(size_t)n * C + c] = make_float2(m, s);
    __threadfence();               // the partial is visible before the ticket
    last = atomicAdd(tickets + n, 1) == C - 1;
    if (last) tickets[n] = 0;      // every block of the row has arrived
  }
  if (!__shfl_sync(FULL, last, 0)) return;
  __threadfence();
  const float2* pp = part + (size_t)n * C;
  float M = -INFINITY;
  for (int x = lane; x < C; x += 32) M = fmaxf(M, __ldcg(pp + x).x);
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, o));
  float S = 0.f;
  for (int x = lane; x < C; x += 32) {   // each lane its chunks, in order
    const float2 ms = __ldcg(pp + x);
    if (ms.x != -INFINITY) S += ms.y * expf(ms.x - M);
  }
  for (int o = 16; o > 0; o >>= 1) S += __shfl_xor_sync(FULL, S, o);
  if (lane == 0) out[n] = expf(pick - M) / S;
}

}  // namespace

// logits (N, V) f32; ids (N,) int32; out (N,) f32.  All contiguous.  ``C``
// chunks of ``chunk`` vocab entries a row (the host's row_split_plan;
// C * chunk >= V > (C - 1) * chunk); with C > 1, ``part`` holds 2 * N * C
// floats and ``tickets`` N zeros (left zero), else both may be null.
// Returns the cudaError_t of the launch.
extern "C" int gather_softmax_prob_launch(const void* logits, const void* ids,
                                          void* out, int N, int V, int C,
                                          int chunk, void* part, void* tickets,
                                          void* stream) {
  if (N < 1 || V < 1 || C < 1 || C > 65535 || chunk < 1 ||
      (long long)C * chunk < V || (long long)(C - 1) * chunk >= V ||
      (C > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  gather_softmax_prob_kernel<<<dim3(N, C), NT, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(ids),
      static_cast<float*>(out), V, C, chunk, static_cast<float2*>(part),
      static_cast<int*>(tickets));
  return static_cast<int>(cudaGetLastError());
}
