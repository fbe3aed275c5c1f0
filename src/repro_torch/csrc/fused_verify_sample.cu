// Fused draft verification + calibrated residual sampling for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces: repro/kernels/fused_verify_sample.py::fused_verify_sample_pallas
// (the pl.pallas_call at fused_verify_sample.py:181).  Same function: the
// softmax probability p_L of every drafted token, the accept test
// u < min(1, p_L / p_S) masked to draft_len, the prefix-acceptance count
// n_acc, and the calibrated token drawn by inverse CDF from
// normalize(max(p_sel - q_sel, 0)) at sel = min(n_acc, L - 1), with the
// sparse SLM row (q_idx, q_val) rebuilt on the fly; argmax(p) when that
// residual is all zero.  When rounding leaves u * Z at or past the last CDF
// value nothing crosses and the token is V - 1, as in the JAX oracle
// (ref.py::residual_sample_ref); the Pallas kernel returns argmax(p) there.
//
// Bound on the H100: bytes.  The kernel must read the L drafted logit rows
// of each batch row once (B * L * V * 4 bytes: 8.2 MB at B = L = 8,
// V = 32000); the exp/compare work per byte is tiny.
//
// Design.  One block of 1024 threads per batch row; B is at most a few
// dozen, so the V sweep is the work and V is not split across blocks yet.
//   phase 0  for each drafted position: a block max, then a block sum of
//            exp(x - max) (two sweeps, the second mostly from L2); thread 0
//            then runs the accept test and the prefix count.
//   phase 1  over row sel: residual mass Z = sum max(p - q, 0) and argmax(p).
//            The V-hat sparse pairs sit sorted in shared memory; each vocab
//            entry finds its q by binary search.
//   phase 2  ordered inverse-CDF scan of the same residual over tiles of
//            4096 entries (4 consecutive per thread, block exclusive scan of
//            the thread sums), stopping at the first tile that crosses u * Z.
// The sums run in another order than torch's, so `calibrated` can differ
// from the plain version only where u * Z lies within rounding of a CDF step.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;        // threads per block
constexpr int ITEMS = 4;        // consecutive vocab entries per thread in phase 2
constexpr int L_MAX = 64;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ int warp_min_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Block reductions: every thread gets the result.  `red` holds 32 slots.
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  v = lane < (blockDim.x >> 5) ? red[lane] : -INFINITY;
  return warp_max(v);
}
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

// q of vocab entry v from the sorted sparse row (duplicates add up, as the
// reference's scatter-add does).
__device__ __forceinline__ float sparse_q(int v, const int* sidx, const float* sval,
                                          int n) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sidx[mid] < v) lo = mid + 1; else hi = mid;
  }
  float q = 0.f;
  for (int k = lo; k < n && sidx[k] == v; ++k) q += sval[k];
  return q;
}

__global__ void __launch_bounds__(NT)
fused_verify_sample_kernel(const float* __restrict__ logits, int Lp1, int V,
                           const int* __restrict__ tokens,
                           const float* __restrict__ probs,
                           const int* __restrict__ q_idx,
                           const float* __restrict__ q_val, int vhat,
                           const float* __restrict__ u_accept,
                           const float* __restrict__ u_resid,
                           const int* __restrict__ draft_len, int L,
                           uint8_t* __restrict__ accept_out,
                           int* __restrict__ n_acc_out,
                           int* __restrict__ calibrated_out) {
  __shared__ float redf[32];
  __shared__ int redi[32];
  __shared__ float m_s[L_MAX], z_s[L_MAX];
  __shared__ int sel_s;
  extern __shared__ unsigned char dyn[];
  int* sidx = reinterpret_cast<int*>(dyn);
  float* sval = reinterpret_cast<float*>(sidx + vhat);

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* rows = logits + (size_t)b * Lp1 * V;

  // ---- phase 0: softmax stats of every drafted position ----
  for (int l = 0; l < L; ++l) {
    const float* row = rows + (size_t)l * V;
    float mx = -INFINITY;
    for (int v = tid; v < V; v += NT) mx = fmaxf(mx, row[v]);
    mx = block_max(mx, redf);
    float s = 0.f;
    for (int v = tid; v < V; v += NT) s += expf(row[v] - mx);
    s = block_sum(s, redf);
    if (tid == 0) { m_s[l] = mx; z_s[l] = s; }
  }
  __syncthreads();
  if (tid == 0) {
    const int dl = draft_len[b];
    int n = 0;
    bool prefix = true;
    for (int l = 0; l < L; ++l) {
      const float* row = rows + (size_t)l * V;
      const float p_t = expf(row[tokens[b * L + l]] - m_s[l]) / z_s[l];
      const float ratio = p_t / fmaxf(probs[b * L + l], 1e-30f);
      const bool acc = (u_accept[b * L + l] < fminf(ratio, 1.f)) && (l < dl);
      accept_out[b * L + l] = acc ? 1 : 0;
      prefix = prefix && acc;
      n += prefix ? 1 : 0;
    }
    n_acc_out[b] = n;
    sel_s = min(n, L - 1);
  }
  __syncthreads();
  const int sel = sel_s;
  const float m = m_s[sel];
  const float z = z_s[sel];
  const float* row = rows + (size_t)sel * V;

  // sparse SLM row of position sel, sorted by vocab id (rank sort)
  const int* qi = q_idx + ((size_t)b * L + sel) * vhat;
  const float* qv = q_val + ((size_t)b * L + sel) * vhat;
  for (int i = tid; i < vhat; i += NT) {
    const int key = qi[i];
    int rank = 0;
    for (int j = 0; j < vhat; ++j) {
      const int o = qi[j];
      rank += (o < key || (o == key && j < i)) ? 1 : 0;
    }
    sidx[rank] = key;
    sval[rank] = qv[i];
  }
  __syncthreads();

  // ---- phase 1: residual mass + argmax(p) ----
  float zr = 0.f, best = -INFINITY;
  int best_i = INT_MAX;
  for (int v = tid; v < V; v += NT) {
    const float p = expf(row[v] - m) / z;
    zr += fmaxf(p - sparse_q(v, sidx, sval, vhat), 0.f);
    if (p > best) { best = p; best_i = v; }
  }
  zr = block_sum(zr, redf);
  block_argmax(best, best_i, redf, redi);

  // ---- phase 2: inverse-CDF crossing of u * Z ----
  int token;
  if (zr <= 0.f) {
    token = best_i;
  } else {
    const float target = u_resid[b] * zr;
    float running = 0.f;
    int found = INT_MAX;
    for (int base = 0; base < V; base += NT * ITEMS) {
      const int v0 = base + tid * ITEMS;
      float loc[ITEMS];
      float tsum = 0.f;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        const int v = v0 + i;
        float r = 0.f;
        if (v < V) r = fmaxf(expf(row[v] - m) / z - sparse_q(v, sidx, sval, vhat), 0.f);
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
  if (tid == 0) calibrated_out[b] = token;
}

}  // namespace

// logits (B, Lp1, V) f32 with Lp1 >= L; tokens / u_accept / probs (B, L);
// q_idx / q_val (B, L, vhat) int32 / f32; u_resid (B,) f32; draft_len (B,)
// int32.  Outputs: accept (B, L) uint8 (0/1), n_acc (B,) int32,
// calibrated (B,) int32.  All contiguous.  Returns the cudaError_t of the
// launch.
extern "C" int fused_verify_sample_launch(const void* logits, int B, int Lp1, int V,
                                          const void* tokens, const void* probs,
                                          const void* q_idx, const void* q_val,
                                          int vhat, const void* u_accept,
                                          const void* u_resid, const void* draft_len,
                                          int L, void* accept, void* n_acc,
                                          void* calibrated, void* stream) {
  if (L < 1 || L > L_MAX || Lp1 < L || vhat < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the sorted sparse row is dynamic shared memory; with the kernel's
  // static arrays it must fit the 48 KB a launch gets without opting in
  static size_t static_smem = SIZE_MAX;
  if (static_smem == SIZE_MAX) {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, fused_verify_sample_kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    static_smem = attr.sharedSizeBytes;
  }
  const size_t smem = (size_t)vhat * (sizeof(int) + sizeof(float));
  if (smem + static_smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  fused_verify_sample_kernel<<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), Lp1, V, static_cast<const int*>(tokens),
      static_cast<const float*>(probs), static_cast<const int*>(q_idx),
      static_cast<const float*>(q_val), vhat, static_cast<const float*>(u_accept),
      static_cast<const float*>(u_resid), static_cast<const int*>(draft_len), L,
      static_cast<uint8_t*>(accept), static_cast<int*>(n_acc),
      static_cast<int*>(calibrated));
  return static_cast<int>(cudaGetLastError());
}
