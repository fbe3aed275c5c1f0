// Paged window attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: repro/kernels/paged_attention.py::paged_attention_pallas (the
// pl.pallas_call at paged_attention.py:114).  Same function: GQA attention
// of a T-row query window through a page table; row t of batch b attends
// logical positions [0, lengths[b] + t); unmapped (-1) slots and slots past
// the tile's horizon are skipped whole; a row that sees no key returns 0.
// With ``window`` > 0 (a sliding-window layer) row t attends only the last
// ``window`` of them, [lengths[b] + t - window, lengths[b] + t): the walk
// starts at the slot of the tile's lowest visible key, so slots wholly below
// every row's window are never read and may be -1 (the engine frees them).
//
// Bound on the H100: bytes.  Every visible K/V page is read once per kv head
// and each byte feeds 2*T*G multiply-adds (T*G <= 16 query rows per tile on
// the draft and verify windows), far below the ~295 flop/byte the tensor
// cores need.  Prefill (T ~ 127) is the one shape with reuse, and it is
// small next to the decode/verify traffic of a serving round.
//
// Design, bfloat16 (every full-width serving path): a split slot axis and
// the tensor cores, the kernel body of window_attention_bf16.cuh with the
// page-table locator (``PagedKeys<true>``: a split holds whole slots) and the
// per-row horizon (``CausalRows``).  The TPU kernel walks the page-table
// slots as its sequential grid axis and carries the online-softmax state in
// VMEM; at the draft step (B * KV = 32 row blocks) that walk, kept whole in
// one block, leaves most of the 132 SMs idle.  Here the slots are cut into
// n_split contiguous ranges of ``split_slots`` (the host picks both from
// shapes alone, never from ``lengths``: kernels/paged_attention.py::
// split_plan; it splits only a grid of fewer blocks than SMs, since the
// verify window's 256 blocks, bound by the bytes they read, only lost time
// to a split), each block walks one range in 64-key chunks on mma.sync
// tiles, and the last block of each row tile merges the partials in the
// same launch.
//
// float32 inputs (the configs' default dtype, run at smoke size) stay on
// the first kernel, unchanged: grid (B, KV, row tiles), one block per (batch
// row, kv head, tile of up to 16 query rows) walking every slot; each live
// page staged as f32 in shared memory, a half-warp per query row (lane j
// scores key j against the row's pre-scaled q, shuffles for max and sum,
// D/16 output accumulators a lane), plain FMA on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "window_attention_bf16.cuh"

namespace {

template <typename T> __device__ __forceinline__ float to_f(T x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x) { return x; }

constexpr unsigned FULL = 0xffffffffu;

template <typename T, int D>
__global__ void paged_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k_pool,
                                       const T* __restrict__ v_pool,
                                       const int* __restrict__ page_table,
                                       const int* __restrict__ lengths,
                                       T* __restrict__ out, int n_t, int H,
                                       int KV, int ps, int n_slots, int window,
                                       float scale) {
  constexpr int DPL = D / 16;  // output dims per lane (16 lanes per row)
  extern __shared__ float smem[];
  const int rows_per_block = blockDim.x / 16;
  float* k_s = smem;                         // ps x (D + 1), padded vs bank conflicts
  float* v_s = k_s + ps * (D + 1);           // ps x D
  float* q_s = v_s + ps * D;                 // rows_per_block x D, pre-scaled

  const int b = blockIdx.x;
  const int kv = blockIdx.y;
  const int G = H / KV;
  const int R = n_t * G;
  const int r0 = blockIdx.z * rows_per_block;
  const int lane = threadIdx.x & 31;
  const int l16 = lane & 15;
  const int local_row = threadIdx.x >> 4;    // (warp * 2 + half)
  const int r = r0 + local_row;
  const bool row_ok = r < R;
  const int t = row_ok ? r / G : 0;
  const int base = lengths[b];
  const int horizon = base + t;              // this row attends kpos < horizon
  const int r_last = min(r0 + rows_per_block, R) - 1;
  const int tile_horizon = base + r_last / G;  // the tile's last row sees most
  // the tile's first row sees the lowest key (0 without a window)
  const int tile_floor = window > 0 ? max(0, base + r0 / G - window) : 0;
  const int lo = window > 0 ? horizon - window : 0;

  for (int i = threadIdx.x; i < rows_per_block * D; i += blockDim.x) {
    const int rr = r0 + i / D;
    float val = 0.f;
    if (rr < R) {
      const int tt = rr / G, gg = rr % G;
      val = to_f(q[((size_t)(b * n_t + tt) * H + kv * G + gg) * D + i % D]) * scale;
    }
    q_s[i] = val;
  }

  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  float m = -INFINITY;
  float l = 0.f;
  const float* qrow = q_s + local_row * D;

  for (int s = 0; s < n_slots; ++s) {
    const int page = page_table[b * n_slots + s];
    if (page < 0 || s * ps >= tile_horizon || (s + 1) * ps <= tile_floor)
      continue;  // uniform over the block
    __syncthreads();  // the previous page (and the q tile) are fully staged/consumed
    for (int i = threadIdx.x; i < ps * D; i += blockDim.x) {
      const int j = i / D, d = i % D;
      const size_t off = ((size_t)(page * ps + j) * KV + kv) * D + d;
      k_s[j * (D + 1) + d] = to_f(k_pool[off]);
      v_s[j * D + d] = to_f(v_pool[off]);
    }
    __syncthreads();
    for (int c = 0; c < ps; c += 16) {
      const int j = c + l16;
      const bool valid =
          row_ok && j < ps && (s * ps + j) < horizon && (s * ps + j) >= lo;
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
      const int n_keys = min(16, ps - c);
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
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* page_table, const int* lengths, void* out, int B,
                   int n_t, int H, int KV, int ps, int n_slots, int window,
                   float scale, cudaStream_t stream) {
  const int R = n_t * (H / KV);
  const int warps = (R + 1) / 2 < 8 ? (R + 1) / 2 : 8;
  const int rows_per_block = 2 * warps;
  const dim3 grid(B, KV, (R + rows_per_block - 1) / rows_per_block);
  const size_t smem = sizeof(float) * ((size_t)ps * (D + 1) + (size_t)ps * D +
                                       (size_t)rows_per_block * D);
  // D = 256 passes the 48 KB default: the limit is raised once per
  // instantiation and size
  static size_t sized = 48 * 1024;
  if (smem > sized) {
    if (smem > mma_bf16::SMEM_OPT_IN) return cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    sized = smem;
  }
  paged_attention_kernel<T, D><<<grid, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), page_table, lengths, static_cast<T*>(out),
      n_t, H, KV, ps, n_slots, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, T, H, D); pools (P, ps, KV, D); page_table (B, n_slots) int32;
// lengths (B,) int32; out (B, T, H, D).  All contiguous, q/pools/out of one
// dtype: 0 = float32, 1 = bfloat16, the bfloat16 ones 16-byte aligned.
// ``window`` > 0: each row sees only its last ``window`` keys.  For
// bfloat16, ``row_tile`` (16 or 64), ``n_split`` and ``split_slots`` come from
// the host's split plan (a window's: slots counted from the tile's lowest
// key); with n_split > 1, ``part`` holds
// B * KV * row_tiles * n_split * row_tile * (D + 2) floats and ``tickets``
// B * KV * row_tiles zeros (left zero by the kernel).  float32 ignores all
// five.  Returns the cudaError_t of the launch.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* page_table,
                                      const void* lengths, void* out, void* part,
                                      void* tickets, int B, int n_t, int H,
                                      int KV, int D, int ps, int n_slots,
                                      int row_tile, int n_split, int split_slots,
                                      int window, int dtype, float scale,
                                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* ln = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  if (dtype == 0) {
    switch (D) {
      case 16: return static_cast<int>(launch<float, 16>(q, k_pool, v_pool, pt, ln, out, B, n_t, H, KV, ps, n_slots, window, scale, st));
      case 32: return static_cast<int>(launch<float, 32>(q, k_pool, v_pool, pt, ln, out, B, n_t, H, KV, ps, n_slots, window, scale, st));
      case 64: return static_cast<int>(launch<float, 64>(q, k_pool, v_pool, pt, ln, out, B, n_t, H, KV, ps, n_slots, window, scale, st));
      case 128: return static_cast<int>(launch<float, 128>(q, k_pool, v_pool, pt, ln, out, B, n_t, H, KV, ps, n_slots, window, scale, st));
      case 256: return static_cast<int>(launch<float, 256>(q, k_pool, v_pool, pt, ln, out, B, n_t, H, KV, ps, n_slots, window, scale, st));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const window_bf16::PagedKeys<true> keys{pt, ps, n_slots, nullptr};
  if (window > 0) {
    const window_bf16::CausalRowsInWindow mask{{}, window};
    return static_cast<int>(window_bf16::dispatch(
        D, row_tile, q, k_pool, v_pool, keys, mask, ln, out, pa, tk, B, n_t,
        H, KV, n_split, split_slots, scale, st));
  }
  return static_cast<int>(window_bf16::dispatch(
      D, row_tile, q, k_pool, v_pool, keys, window_bf16::CausalRows{}, ln, out,
      pa, tk, B, n_t, H, KV, n_split, split_slots, scale, st));
}
