// Paged window attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: repro/kernels/paged_attention.py::paged_attention_pallas (the
// pl.pallas_call at paged_attention.py:114).  Same function: GQA attention
// of a T-row query window through a page table; row t of batch b attends
// logical positions [0, lengths[b] + t); unmapped (-1) slots and slots past
// the tile's horizon are skipped whole; a row that sees no key returns 0.
//
// Bound on the H100: bytes.  Every visible K/V page is read once per kv head
// and each byte feeds 2*T*G multiply-adds (T*G <= 16 query rows per tile on
// the draft and verify windows), far below the ~295 flop/byte the tensor
// cores need.  Prefill (T ~ 127) is the one shape with reuse, and it is
// small next to the decode/verify traffic of a serving round.
//
// Design.  The TPU kernel walks the page-table slots as its sequential grid
// axis and carries the online-softmax state in VMEM.  Here the slot loop
// runs inside the block: grid (B, KV, row tiles), one block per (batch row,
// kv head, tile of up to 16 query rows).  The T*G rows that share a kv head
// are flattened (r = t*G + g) and tiled, so a 128-token prefill with G=8
// (~1000 rows) spreads over many blocks instead of one oversized tile.  Each
// block stages one K/V page (ps x D, converted to f32) in shared memory per
// live slot; a half-warp owns one query row: lane j scores key j of the page
// against the row's pre-scaled q (held in shared memory), the half-warp
// reduces max and sum by shuffles, and each lane keeps D/16 output
// accumulators in registers.  All arithmetic is f32 for f32 and bf16 inputs.
// Simple and right first: no wgmma/TMA, no split over the slot axis.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

constexpr unsigned FULL = 0xffffffffu;

template <typename T, int D>
__global__ void paged_attention_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k_pool,
                                       const T* __restrict__ v_pool,
                                       const int* __restrict__ page_table,
                                       const int* __restrict__ lengths,
                                       T* __restrict__ out, int n_t, int H,
                                       int KV, int ps, int n_slots, float scale) {
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
    if (page < 0 || s * ps >= tile_horizon) continue;  // uniform over the block
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
      const bool valid = row_ok && j < ps && (s * ps + j) < horizon;
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
                   int n_t, int H, int KV, int ps, int n_slots, float scale,
                   cudaStream_t stream) {
  const int R = n_t * (H / KV);
  const int warps = (R + 1) / 2 < 8 ? (R + 1) / 2 : 8;
  const int rows_per_block = 2 * warps;
  const dim3 grid(B, KV, (R + rows_per_block - 1) / rows_per_block);
  const size_t smem = sizeof(float) * ((size_t)ps * (D + 1) + (size_t)ps * D +
                                       (size_t)rows_per_block * D);
  paged_attention_kernel<T, D><<<grid, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), page_table, lengths, static_cast<T*>(out),
      n_t, H, KV, ps, n_slots, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k_pool, const void* v_pool,
                       const int* page_table, const int* lengths, void* out, int B,
                       int n_t, int H, int KV, int ps, int n_slots, float scale,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k_pool, v_pool, page_table, lengths, out, B, n_t, H, KV, ps, n_slots, scale, stream);
    case 32: return launch<T, 32>(q, k_pool, v_pool, page_table, lengths, out, B, n_t, H, KV, ps, n_slots, scale, stream);
    case 64: return launch<T, 64>(q, k_pool, v_pool, page_table, lengths, out, B, n_t, H, KV, ps, n_slots, scale, stream);
    case 128: return launch<T, 128>(q, k_pool, v_pool, page_table, lengths, out, B, n_t, H, KV, ps, n_slots, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, T, H, D); pools (P, ps, KV, D); page_table (B, n_slots) int32;
// lengths (B,) int32; out (B, T, H, D).  All contiguous, q/pools/out of one
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* page_table,
                                      const void* lengths, void* out, int B, int n_t,
                                      int H, int KV, int D, int ps, int n_slots,
                                      int dtype, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* ln = static_cast<const int*>(lengths);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float>(D, q, k_pool, v_pool, pt, ln, out, B, n_t, H, KV, ps, n_slots, scale, st);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(D, q, k_pool, v_pool, pt, ln, out, B, n_t, H, KV, ps, n_slots, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
