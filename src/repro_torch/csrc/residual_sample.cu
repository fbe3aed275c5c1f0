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
// crossing chunk is read again from L2.
//
// Design.  With one block a row, N = 8 rows keep 8 of the 132 SMs busy,
// each with a few loads in flight a thread.  So each row's V entries are cut
// into C contiguous chunks (kernels/fused_verify_sample.py::row_split_plan,
// from the shapes and the SM count alone: ~2 blocks a SM, at N = 8 33
// chunks of 972; C = 1 once the rows outnumber the SMs), one block of 256
// threads per (row, chunk):
//   1. the block sweeps its chunk of p and q with 16-byte loads, UV of each
//      in flight a thread (scalar loads for the unaligned head and tail, or
//      for the whole chunk when p and q differ in alignment), and reduces
//      the chunk's residual mass sum max(p - q, 0) and the (value, index)
//      argmax of p, first index on ties, by fixed trees;
//   2. it writes the partials and takes the row's ticket (C > 1); the last
//      block of the row to arrive, or the only one, does the rest:
//   3. one warp takes the prefix sums of the C masses in chunk order, 32 at
//      a time (Z the last); Z <= 0 gives the argmax merged over the chunks,
//      ties to the smaller index; else the chunk k whose prefix first
//      exceeds u * Z runs the ordered inverse-CDF scan of its entries,
//      reading them back from L2, over tiles of 1024 (4 consecutive a
//      thread, block exclusive scan of the thread sums), from the masses
//      of the chunks before it.  Should rounding leave chunk k's own sums
//      short of u * Z, the token is its last entry with a positive residual
//      (the CDF step u * Z lies at); no chunk crossing gives V - 1.  The
//      ticket is reset to 0 as the last block arrives.
// One ordinary launch: no block waits for another, no memset, no second
// pass.  The TPU kernel carries Z, the running sum and the found token
// across its sequential (phase, tile) grid in VMEM.  The sums run in
// another order than torch's, so the token can differ from the plain
// version only where u * Z lies within rounding of a CDF step; a second
// call gives the same bits.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int NW = NT / 32;    // warps per block
constexpr int UV = 4;          // 16-byte loads of p (and of q) in flight a thread
constexpr int ITEMS = 4;       // consecutive entries a thread in the scan
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ int warp_min_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
// (value, index) argmax over the warp: larger value wins, ties go to the
// smaller index
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(FULL, v, o);
    const int i2 = __shfl_xor_sync(FULL, i, o);
    if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
  }
}

// Block reductions: every thread gets the result.  `red` holds NW slots.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  return warp_sum(lane < NW ? red[lane] : 0.f);
}
__device__ int block_min_i(int v, int* red) {
  v = warp_min_i(v);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  return warp_min_i(lane < NW ? red[lane] : INT_MAX);
}
__device__ void block_argmax(float& v, int& i, float* redf, int* redi) {
  warp_argmax(v, i);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) { redf[w] = v; redi[w] = i; }
  __syncthreads();
  const bool ok = lane < NW;
  v = ok ? redf[lane] : -INFINITY;
  i = ok ? redi[lane] : INT_MAX;
  warp_argmax(v, i);
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
    float s = lane < NW ? red[lane] : 0.f;
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += n;
    }
    red[lane] = s;  // inclusive scan of the warp totals
  }
  __syncthreads();
  total = red[NW - 1];
  const float warp_off = w > 0 ? red[w - 1] : 0.f;
  return warp_off + inc - v;
}

// one entry of the sweep, in index order within a thread
__device__ __forceinline__ void take(float pv, float qv, int v, float& z,
                                     float& best, int& bi) {
  z += fmaxf(pv - qv, 0.f);
  if (pv > best) { best = pv; bi = v; }
}

// Scratch per call with C > 1: mass, best_p, best_i (N, C) each.
__global__ void __launch_bounds__(NT)
residual_sample_kernel(const float* __restrict__ p, const float* __restrict__ q,
                       const float* __restrict__ u, int* __restrict__ out, int V,
                       int C, int chunk, float* mass, float* best_p, int* best_i,
                       int* tickets) {
  __shared__ float redf[32];
  __shared__ int redi[32];
  __shared__ int last_s, cross_s;
  __shared__ float start_s, target_s, zc_s, bp_s;
  __shared__ int bi_s;
  const int n = blockIdx.x;
  const int c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* prow = p + (size_t)n * V;
  const float* qrow = q + (size_t)n * V;

  // ---- 1. this chunk's residual mass and argmax(p) ----
  {
    const int c0 = c * chunk;
    const int len = min(chunk, V - c0);
    const float* pb = prow + c0;
    const float* qb = qrow + c0;
    const uintptr_t pa = reinterpret_cast<uintptr_t>(pb);
    // the 16-byte-aligned body [head, tail) of both rows, scalars around it
    // (all scalars when p and q differ in alignment)
    const int head = ((pa ^ reinterpret_cast<uintptr_t>(qb)) & 15)
                         ? len : min(len, (int)((16 - (pa & 15)) & 15) >> 2);
    const int nvec = (len - head) >> 2;
    const int tail = head + 4 * nvec;
    const float4* pv4 = reinterpret_cast<const float4*>(pb + head);
    const float4* qv4 = reinterpret_cast<const float4*>(qb + head);
    float z = 0.f, best = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < head; i += NT) take(pb[i], qb[i], c0 + i, z, best, bi);
    for (int i = tid; i < nvec; i += UV * NT) {
      float4 a[UV], b[UV];
#pragma unroll
      for (int k = 0; k < UV; ++k) {   // 2 x UV loads in flight
        const bool ok = i + k * NT < nvec;
        a[k] = ok ? pv4[i + k * NT] : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        b[k] = ok ? qv4[i + k * NT] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < UV; ++k) {
        const int v = c0 + head + 4 * (i + k * NT);
        take(a[k].x, b[k].x, v, z, best, bi);
        take(a[k].y, b[k].y, v + 1, z, best, bi);
        take(a[k].z, b[k].z, v + 2, z, best, bi);
        take(a[k].w, b[k].w, v + 3, z, best, bi);
      }
    }
    for (int i = tail + tid; i < len; i += NT) take(pb[i], qb[i], c0 + i, z, best, bi);
    z = block_sum(z, redf);
    block_argmax(best, bi, redf, redi);
    if (C == 1) {
      if (tid == 0) { zc_s = z; bp_s = best; bi_s = bi; }
    } else if (tid == 0) {
      mass[(size_t)n * C + c] = z;
      best_p[(size_t)n * C + c] = best;
      best_i[(size_t)n * C + c] = bi;
      __threadfence();             // the partials are visible before the ticket
      const int last = atomicAdd(tickets + n, 1) == C - 1;
      if (last) tickets[n] = 0;    // every block of the row has arrived
      last_s = last;
    }
    __syncthreads();
    if (C > 1 && !last_s) return;  // block-uniform
  }

  // ---- 2. the last block of the row: Z, then the crossing chunk ----
  if (C > 1) __threadfence();
  if (warp == 0) {
    const size_t r0 = (size_t)n * C;
    auto mass_at = [&](int x) {
      return x < C ? (C == 1 ? zc_s : __ldcg(mass + r0 + x)) : 0.f;
    };
    auto prefix = [&](int x0, float before) {   // lane's inclusive prefix
      float inc = mass_at(x0 + lane);
      for (int o = 1; o < 32; o <<= 1) {
        const float nb = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += nb;
      }
      return before + inc;
    };
    const float inc0 = prefix(0, 0.f);   // the first 32, kept for the search
    float Z = __shfl_sync(FULL, inc0, 31);
    for (int x0 = 32; x0 < C; x0 += 32) Z = __shfl_sync(FULL, prefix(x0, Z), 31);
    const float target = u[n] * Z;
    int cross = Z > 0.f ? C : -1;   // -1: Z <= 0; C: nothing crosses
    float start = 0.f;              // the masses before chunk `cross`
    for (int x0 = 0; cross == C && x0 < C; x0 += 32) {   // the same sums again
      const float inc = x0 == 0 ? inc0 : prefix(x0, start);
      const unsigned hit = __ballot_sync(FULL, x0 + lane < C && inc > target);
      const float excl = __shfl_up_sync(FULL, inc, 1);
      if (hit) {
        const int k = __ffs(hit) - 1;
        cross = x0 + k;
        start = k == 0 ? start : __shfl_sync(FULL, excl, k);
      } else {
        start = __shfl_sync(FULL, inc, 31);
      }
    }
    if (cross == -1) {   // argmax(p) over the chunks, ties to the smaller index
      float bp = -INFINITY;
      int bt = INT_MAX;
      if (C == 1) {
        bp = bp_s;
        bt = bi_s;
      } else {
        for (int x = lane; x < C; x += 32) {
          const float v = __ldcg(best_p + r0 + x);
          const int i = __ldcg(best_i + r0 + x);
          if (v > bp || (v == bp && i < bt)) { bp = v; bt = i; }
        }
        warp_argmax(bp, bt);
      }
      if (lane == 0) out[n] = bt;
    }
    if (lane == 0) {
      if (cross == C) out[n] = V - 1;
      cross_s = cross;
      start_s = start;
      target_s = target;
    }
  }
  __syncthreads();
  const int k = cross_s;
  if (k < 0 || k >= C) return;     // block-uniform

  // the ordered inverse-CDF scan of chunk k, from the masses before it
  const int k0 = k * chunk, k1 = min(k0 + chunk, V);
  const float target = target_s;
  float running = start_s;
  int found = INT_MAX;
  int last = INT_MAX;              // minus the last entry with a positive residual
  for (int base = k0; base < k1; base += NT * ITEMS) {
    const int v0 = base + tid * ITEMS;
    float loc[ITEMS];
    float tsum = 0.f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int v = v0 + i;
      const float r = v < k1 ? fmaxf(prow[v] - qrow[v], 0.f) : 0.f;
      if (r > 0.f) last = -v;
      loc[i] = r;
      tsum += r;
    }
    float total;
    float cum = running + block_exclusive_scan(tsum, redf, total);
    int hit = INT_MAX;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      cum += loc[i];
      if (hit == INT_MAX && cum > target && v0 + i < k1) hit = v0 + i;
    }
    hit = block_min_i(hit, redi);
    running += total;
    if (hit != INT_MAX) { found = hit; break; }  // uniform: every thread has hit
  }
  // The masses put the crossing in this chunk, but the scan's own sums (in
  // another order) fell short of u * Z: u * Z lies within rounding of the
  // chunk's last CDF step, which is its last entry with a positive residual.
  if (found == INT_MAX) found = -block_min_i(last, redi);
  if (tid == 0) out[n] = found;
}

}  // namespace

// p, q (N, V) f32; u (N,) f32; out (N,) int32.  All contiguous.  ``C``
// chunks of ``chunk`` vocab entries a row (the host's row_split_plan;
// C * chunk >= V > (C - 1) * chunk); with C > 1, ``scratch`` holds
// 3 * N * C floats and ``tickets`` N zeros (left zero), else both may be
// null.  Returns the cudaError_t of the launch.
extern "C" int residual_sample_launch(const void* p, const void* q, const void* u,
                                      void* out, int N, int V, int C, int chunk,
                                      void* scratch, void* tickets, void* stream) {
  if (N < 1 || V < 1 || C < 1 || C > 65535 || chunk < 1 ||
      (long long)C * chunk < V || (long long)(C - 1) * chunk >= V ||
      (C > 1 && (scratch == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* mass = static_cast<float*>(scratch);
  float* best_p = mass ? mass + (size_t)N * C : nullptr;
  int* best_i = mass ? reinterpret_cast<int*>(best_p + (size_t)N * C) : nullptr;
  residual_sample_kernel<<<dim3(N, C), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(q),
      static_cast<const float*>(u), static_cast<int*>(out), V, C, chunk, mass,
      best_p, best_i, static_cast<int*>(tickets));
  return static_cast<int>(cudaGetLastError());
}
