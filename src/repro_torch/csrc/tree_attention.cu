// Token-tree window attention over a contiguous KV cache for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces: repro/kernels/tree_attention.py::tree_attention_pallas (the
// pl.pallas_call at tree_attention.py:145).  Same function: GQA attention of
// a T-row token-tree window over (B, S, KV, D) caches.  The window's K/V sit
// at positions [lengths[b], lengths[b] + T); query row t of batch b attends
// every committed position kpos < lengths[b] plus window position
// lengths[b] + t' where win_mask[b, t, t'] is set (the tree's
// ancestor-or-self matrix).  Keys at or past min(lengths[b] + T, S) are never
// read, as the Pallas kernel's tile_live skips tiles past the window, so the
// work follows the context, not max_len.  A lower-triangular mask is the
// sequential causal window.
//
// Bound on the H100: bytes.  Every key below the window end is read once per
// kv head and each byte feeds 2*T*G multiply-adds (T*G <= 16 query rows per
// tile on the tree windows of the serving path, T = J*L + 1 <= 64), far
// below the ~295 flop/byte the tensor cores need.
//
// Design, bfloat16 (every full-width serving path): paged_tree_attention.cu's
// kernel, the tensor-core body of window_attention_bf16.cuh with the
// contiguous locator (``ContiguousKeys``: key pos of row b is cache row
// (b, pos)) in place of the page table, and the same tree mask
// (``TreeRows``: one 64-bit ancestor word per window row, shifted per 64-key
// chunk into the visibility of the keys a lane scores).  The key axis (S
// keys) is split only when the grid has fewer blocks than SMs, by the plan
// paged_tree_attention.cu's wrapper uses over n_slots * ps keys
// (kernels/paged_attention.py::window_split_plan): the same keys laid out in
// pages (n_slots * ps == S) are cut at the same positions and walked in the
// same chunks, so a chain mask gives that kernel's answer bit for bit.
//
// float32 inputs (the configs' default dtype, run at smoke size) stay on
// the first kernel, unchanged: a walk of 32-key tiles, grid (B, KV, row
// tiles), one block per (batch row, kv head, tile of up to 16 of the T*G
// query rows that share the kv head), online softmax with m / l / acc in
// f32, a half-warp per query row, 16 keys per step, FMA dot products on the
// CUDA cores, the mask words in shared memory as above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_attention_bf16.cuh"

namespace {

using window_bf16::T_MAX;    // one 64-bit mask word per window row
constexpr int KTILE = 32;    // keys staged in shared memory per step

template <typename T> __device__ __forceinline__ float to_f(T x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x) { return x; }

constexpr unsigned FULL = 0xffffffffu;

template <typename T, int D>
__global__ void tree_attention_kernel(const T* __restrict__ q,
                                      const T* __restrict__ k_cache,
                                      const T* __restrict__ v_cache,
                                      const int* __restrict__ lengths,
                                      const uint8_t* __restrict__ win_mask,
                                      T* __restrict__ out, int n_t, int H,
                                      int KV, int S, float scale) {
  constexpr int DPL = D / 16;  // output dims per lane (16 lanes per row)
  extern __shared__ float smem[];
  __shared__ unsigned long long mask_s[T_MAX];
  const int rows_per_block = blockDim.x / 16;
  float* k_s = smem;                          // KTILE x (D + 1), padded vs bank conflicts
  float* v_s = k_s + KTILE * (D + 1);         // KTILE x D
  float* q_s = v_s + KTILE * D;               // rows_per_block x D, pre-scaled

  const int b = blockIdx.x;
  const int kv = blockIdx.y;
  const int G = H / KV;
  const int R = n_t * G;
  const int r0 = blockIdx.z * rows_per_block;
  const int lane = threadIdx.x & 31;
  const int l16 = lane & 15;
  const int local_row = threadIdx.x >> 4;     // (warp * 2 + half)
  const int r = r0 + local_row;
  const bool row_ok = r < R;
  const int t = row_ok ? r / G : 0;
  const int base = lengths[b];                // committed keys: kpos < base
  const int key_end = min(base + n_t, S);     // no key at or past this is seen

  for (int i = threadIdx.x; i < rows_per_block * D; i += blockDim.x) {
    const int rr = r0 + i / D;
    float val = 0.f;
    if (rr < R) {
      const int tt = rr / G, gg = rr % G;
      val = to_f(q[((size_t)(b * n_t + tt) * H + kv * G + gg) * D + i % D]) * scale;
    }
    q_s[i] = val;
  }
  for (int tt = threadIdx.x; tt < n_t; tt += blockDim.x) {
    const uint8_t* mrow = win_mask + ((size_t)b * n_t + tt) * n_t;
    unsigned long long bits = 0ull;
    for (int u = 0; u < n_t; ++u) bits |= (mrow[u] ? 1ull : 0ull) << u;
    mask_s[tt] = bits;
  }
  __syncthreads();
  const unsigned long long mrow = mask_s[t];

  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;
  const float* qrow = q_s + local_row * D;

  for (int k0 = 0; k0 < key_end; k0 += KTILE) {
    const int n_tile = min(KTILE, key_end - k0);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < n_tile * D; i += blockDim.x) {
      const int j = i / D, d = i % D;
      const size_t off = (((size_t)b * S + k0 + j) * KV + kv) * D + d;
      k_s[j * (D + 1) + d] = to_f(k_cache[off]);
      v_s[j * D + d] = to_f(v_cache[off]);
    }
    __syncthreads();
    for (int c = 0; c < n_tile; c += 16) {
      const int j = c + l16;
      const int kpos = k0 + j;
      const int w = kpos - base;              // window slot when 0 <= w < n_t
      const bool seen = kpos < base || (w < n_t && ((mrow >> w) & 1ull));
      const bool valid = row_ok && j < n_tile && seen;
      float sc = -INFINITY;
      if (valid) {
        const float* krow = k_s + j * (D + 1);
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qrow[d], krow[d], dot);
        sc = dot;
      }
      float mt = sc;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, o, 16));
      const float m_new = fmaxf(m, mt);
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr = expf(m - m_use);            // 0 while nothing was seen
      const float p = valid ? expf(sc - m_use) : 0.f;
      float psum = p;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) psum += __shfl_xor_sync(FULL, psum, o, 16);
      l = l * corr + psum;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] *= corr;
      const int n_keys = min(16, n_tile - c);
      for (int jj = 0; jj < n_keys; ++jj) {
        const float pj = __shfl_sync(FULL, p, jj, 16);
        const float* vrow = v_s + (c + jj) * D;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] = fmaf(pj, vrow[l16 + 16 * i], acc[i]);
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, 1e-30f);  // l == 0 -> acc == 0 -> 0
    const int head = kv * G + (r % G);
    T* orow = out + ((size_t)(b * n_t + t) * H + head) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) orow[l16 + 16 * i] = from_f<T>(acc[i] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_cache, const void* v_cache,
                   const int* lengths, const uint8_t* win_mask, void* out, int B,
                   int n_t, int H, int KV, int S, float scale,
                   cudaStream_t stream) {
  const int R = n_t * (H / KV);
  const int warps = (R + 1) / 2 < 8 ? (R + 1) / 2 : 8;
  const int rows_per_block = 2 * warps;
  const dim3 grid(B, KV, (R + rows_per_block - 1) / rows_per_block);
  const size_t smem = sizeof(float) * ((size_t)KTILE * (D + 1) + (size_t)KTILE * D +
                                       (size_t)rows_per_block * D);
  // D = 256 passes the 48 KB default: the limit is raised once per
  // instantiation and size
  static size_t sized = 48 * 1024;
  if (smem > sized) {
    if (smem > mma_bf16::SMEM_OPT_IN) return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        tree_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    sized = smem;
  }
  tree_attention_kernel<T, D><<<grid, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), lengths, win_mask, static_cast<T*>(out),
      n_t, H, KV, S, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, T, H, D); caches (B, S, KV, D); lengths (B,) int32 committed counts;
// win_mask (B, T, T) bytes (0 / 1, a torch.bool tensor); out (B, T, H, D).
// All contiguous, q/caches/out of one dtype: 0 = float32, 1 = bfloat16, the
// bfloat16 ones 16-byte aligned; T <= 64.  For bfloat16, ``row_tile``,
// ``n_split``, ``split_keys``, ``part`` and ``tickets`` as in
// paged_tree_attention_launch; float32 ignores them.  Returns the
// cudaError_t of the launch.
extern "C" int tree_attention_launch(const void* q, const void* k_cache,
                                     const void* v_cache, const void* lengths,
                                     const void* win_mask, void* out, void* part,
                                     void* tickets, int B, int n_t, int H,
                                     int KV, int D, int S, int row_tile,
                                     int n_split, int split_keys, int dtype,
                                     float scale, void* stream) {
  if (n_t < 1 || n_t > T_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ln = static_cast<const int*>(lengths);
  const uint8_t* wm = static_cast<const uint8_t*>(win_mask);
  if (dtype == 0) {
    switch (D) {
      case 16: return static_cast<int>(launch<float, 16>(q, k_cache, v_cache, ln, wm, out, B, n_t, H, KV, S, scale, st));
      case 32: return static_cast<int>(launch<float, 32>(q, k_cache, v_cache, ln, wm, out, B, n_t, H, KV, S, scale, st));
      case 64: return static_cast<int>(launch<float, 64>(q, k_cache, v_cache, ln, wm, out, B, n_t, H, KV, S, scale, st));
      case 128: return static_cast<int>(launch<float, 128>(q, k_cache, v_cache, ln, wm, out, B, n_t, H, KV, S, scale, st));
      case 256: return static_cast<int>(launch<float, 256>(q, k_cache, v_cache, ln, wm, out, B, n_t, H, KV, S, scale, st));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const window_bf16::ContiguousKeys keys{S, 0};
  const window_bf16::TreeRows mask{wm};
  return static_cast<int>(window_bf16::dispatch(
      D, row_tile, q, k_cache, v_cache, keys, mask, ln, out,
      static_cast<float*>(part), static_cast<int*>(tickets), B, n_t, H, KV,
      n_split, split_keys, scale, st));
}
