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
// Design, bfloat16 (every full-width serving path): a split slot axis and
// the tensor cores.  The TPU kernel walks the page-table slots as its
// sequential grid axis and carries the online-softmax state in VMEM; at the
// draft step (B * KV = 32 row blocks) that walk, kept whole in one block,
// leaves most of the 132 SMs idle.  Here the grid is (B, KV, row tiles x
// n_split): the slots are cut into n_split contiguous ranges of
// ``split_slots`` (the host picks both from shapes alone, never from
// ``lengths``: kernels/paged_attention.py::split_plan; it splits only a grid
// of fewer blocks than SMs, since the verify window's 256 blocks, bound by
// the bytes they read, only lost time to a split), and each block walks
// one range, clipped to the tile's horizon.  The T*G query rows that share a
// kv head are flattened (r = t*G + g) and tiled by 16 (T*G <= 16: the draft
// and verify windows, one tile) or by 64 (the prefill).  Keys are walked in
// chunks of 64 logical positions, any page size: each key row (D bf16) is
// found through the page table and staged by 16-byte cp.async copies into a
// two-stage ring (chunk c + 1 loads while chunk c computes), zero-filled
// where unmapped.  With 16-row tiles the four warps share the rows and
// split each chunk's 64 keys (16 each); with 64-row tiles each warp owns 16
// rows and walks all 64 keys.  Scores and P V run on mma.sync.m16n8k16,
// masked on the fragment (unmapped, past the row's horizon), with the
// online softmax in f32 registers and P split into bf16 hi + lo parts as in
// flash_attention.cu.  The warps' states are merged in shared
// memory; with one split the block writes the output, else it writes its
// f32 partial (m, l, acc[D]) per row to a scratch buffer, and the last
// block of each (b, kv, row tile) to finish, found by an atomic ticket taken
// after __threadfence(), merges the partials in split order (so the result
// does not depend on which block came last), writes the output and resets
// the ticket to 0: one launch, and the scratch needs no clearing between
// calls.  A block whose range lies past the tile's horizon or holds only -1
// slots writes an empty partial (m = -inf, l = 0), skipped by the merge; a
// row that sees no key returns 0.
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

#include "mma_bf16.cuh"

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

// ---------------------------------------------------------------------------
// bfloat16: split slot axis, tensor-core tiles
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC_THREADS = 128;   // four warps
constexpr int KC = 64;            // logical key positions of a staged chunk

template <int D, int WR>
constexpr size_t tc_smem_bytes() {   // q tile + two stages of K and V
  return sizeof(bf16) * (size_t)(16 * WR + 4 * KC) * (D + 8);
}

// WR = 1: a 16-row tile, the four warps split each chunk's keys;
// WR = 4: a 64-row tile, warp w owns rows 16w .. 16w + 15 and every key.
template <int D, int WR>
__global__ void __launch_bounds__(TC_THREADS)
paged_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k_pool,
                            const bf16* __restrict__ v_pool,
                            const int* __restrict__ page_table,
                            const int* __restrict__ lengths,
                            bf16* __restrict__ out, float* __restrict__ part_acc,
                            float2* __restrict__ part_ml, int* __restrict__ tickets,
                            int n_t, int H, int KV, int ps, int n_slots,
                            int n_split, int split_slots, float scale_log2) {
  using namespace mma_bf16;
  static_assert(D % 16 == 0 && D <= 128 && (WR == 1 || WR == 4), "shape");
  constexpr int ROWS = 16 * WR;    // query rows of the tile
  constexpr int WK = 4 / WR;       // warps sharing one 16-row group
  constexpr int KW = KC / WK;      // keys of a chunk each warp scores
  constexpr int NP = KW / 16;      // its 16-key steps
  constexpr int DP = D + 8;        // padded shared row (bf16)
  constexpr int C8 = D / 8;        // 16-byte chunks of a row
  constexpr int KS = D / 16;       // k-steps of Q K^T
  constexpr int NB = D / 8;        // 8-column blocks of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // ROWS x DP
  bf16* k_s = q_s + ROWS * DP;                     // 2 x KC x DP
  bf16* v_s = k_s + 2 * KC * DP;                   // 2 x KC x DP
  // after the walk, over the K/V stages: WK x ROWS states (acc[D], m, l)
  float* acc_s = reinterpret_cast<float*>(k_s);    // WK x ROWS x D
  float* m_s = acc_s + WK * ROWS * D;              // WK x ROWS
  float* l_s = m_s + WK * ROWS;                    // WK x ROWS
  __shared__ signed char mapped_s[2][KC];          // per staged key
  __shared__ int last_s;

  const int b = blockIdx.x;
  const int kv = blockIdx.y;
  const int rt = blockIdx.z / n_split;
  const int sp = blockIdx.z % n_split;
  const int n_rt = gridDim.z / n_split;
  const int tile = (b * KV + kv) * n_rt + rt;
  const int G = H / KV;
  const int R = n_t * G;
  const int r0 = rt * ROWS;
  const int live = min(ROWS, R - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tq = lane & 3;
  const int wr = warp / WK;        // this warp's 16-row group
  const int kw0 = (warp % WK) * KW;  // its first key of a chunk
  const int base = lengths[b];
  const int* pt = page_table + (size_t)b * n_slots;

  // keys [k_begin, k_end): this split's slots, clipped to the tile's horizon
  const int tile_h = min(base + (r0 + live - 1) / G, n_slots * ps);
  const int k_begin = sp * split_slots * ps;
  const int k_end = min(min(sp * split_slots + split_slots, n_slots) * ps, tile_h);
  bool any = false;
  if (k_begin < k_end)
    for (int s = k_begin / ps + tid; s <= (k_end - 1) / ps; s += TC_THREADS)
      any |= pt[s] >= 0;
  const int n_chunks = __syncthreads_or(any) ? (k_end - k_begin + KC - 1) / KC : 0;

  // the exclusive key horizons of this lane's two rows (0: a padding row)
  int horizon[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = wr * 16 + gid + half * 8;
    horizon[half] = i < live ? base + (r0 + i) / G : 0;
  }

  auto load_chunk = [&](int c, int stage) {
    const int kc0 = k_begin + c * KC;
    for (int i = tid; i < KC * C8; i += TC_THREADS) {
      const int j = i / C8, cc = i % C8;
      const int pos = kc0 + j;
      const int page = pos < k_end ? pt[pos / ps] : -1;
      const bool ok = page >= 0;
      const size_t o = (((size_t)page * ps + pos % ps) * KV + kv) * D + cc * 8;
      const int d = (stage * KC + j) * DP + cc * 8;
      cp_async16(k_s + d, ok ? k_pool + o : k_pool, ok);   // zeros where
      cp_async16(v_s + d, ok ? v_pool + o : v_pool, ok);   // unmapped
      if (cc == 0) mapped_s[stage][j] = ok;
    }
  };
  if (n_chunks > 0) {
    for (int i = tid; i < ROWS * C8; i += TC_THREADS) {
      const int li = i / C8, c = i % C8;
      const int r = r0 + li;
      const bool ok = li < live;
      const bf16* src =
          ok ? q + (((size_t)b * n_t + r / G) * H + kv * G + r % G) * D + c * 8 : q;
      cp_async16(q_s + li * DP + c * 8, src, ok);
    }
    load_chunk(0, 0);
  }
  cp_async_commit();

  uint32_t qf[KS][4];
  float o[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};   // running max of rows gid, gid + 8
  float l[2] = {0.f, 0.f};               // this lane's share of the row sums

  for (int c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) load_chunk(c + 1, (c + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();            // chunk c (and the q tile) have landed
    __syncthreads();
    if (c == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], q_s + (wr * 16 + (lane & 15)) * DP + kk * 16 +
                            (lane >> 4) * 8);
    }
    const int st = c & 1;
    const int kc0 = k_begin + c * KC;
    const bf16* ks = k_s + (st * KC + kw0) * DP;
    const bf16* vs = v_s + (st * KC + kw0) * DP;

    float s[2 * NP][4];
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int np = 0; np < NP; ++np) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * DP +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[2 * np], qf[kk], kb[0], kb[1]);
        mma16816(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // mask on the fragment (unmapped, past the row's horizon), row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = kw0 + n * 8 + tq * 2 + (e & 1);
        const bool seen = mapped_s[st][j] && kc0 + j < horizon[e >> 1];
        s[n][e] = seen ? s[n][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float corr[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      corr[i] = exp2f(m[i] - m_use[i]);   // 0 while nothing was seen
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      o[n][0] *= corr[0]; o[n][1] *= corr[0];
      o[n][2] *= corr[1]; o[n][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) {
      float p[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[2 * kk][e] - m_use[e >> 1]);
        p[4 + e] = exp2f(s[2 * kk + 1][e] - m_use[e >> 1]);
      }
      uint32_t ah[4], al[4];           // P = hi + lo, each in bf16
      split2(p[0], p[1], ah[0], al[0]);   // row gid, keys 2tq..+1
      split2(p[2], p[3], ah[1], al[1]);   // row gid + 8
      split2(p[4], p[5], ah[2], al[2]);   // row gid, keys 8 + 2tq..+1
      split2(p[6], p[7], ah[3], al[3]);   // row gid + 8
      l[0] += p[0] + p[1] + p[4] + p[5];
      l[1] += p[2] + p[3] + p[6] + p[7];
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * DP +
                          dp * 16 + (lane >> 4) * 8);
        mma16816(o[2 * dp], ah, vb[0], vb[1]);
        mma16816(o[2 * dp], al, vb[0], vb[1]);
        mma16816(o[2 * dp + 1], ah, vb[2], vb[3]);
        mma16816(o[2 * dp + 1], al, vb[2], vb[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before its reload
  }
  cp_async_wait<0>();
  __syncthreads();     // the stages are free: the states go over them

  // each warp's state to shared memory: slot (warp % WK, row)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const int wk = warp % WK;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = wr * 16 + gid + half * 8;
    float* arow = acc_s + (wk * ROWS + i) * D;
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<float2*>(arow + n * 8 + tq * 2) =
          make_float2(o[n][2 * half], o[n][2 * half + 1]);
    if (tq == 0) {
      m_s[wk * ROWS + i] = m[half];
      l_s[wk * ROWS + i] = l[half];
    }
  }
  __syncthreads();

  // merge the WK states of each live row: 8 columns a thread
  for (int u = tid; u < live * C8; u += TC_THREADS) {
    const int i = u / C8, c8 = (u % C8) * 8;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WK; ++w) M = fmaxf(M, m_s[w * ROWS + i]);
    float L = 0.f, A[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < WK; ++w) {
      const float mw = m_s[w * ROWS + i];
      if (mw == -INFINITY) continue;     // saw nothing: weight 0
      const float e = exp2f(mw - M);
      L += e * l_s[w * ROWS + i];
      const float* arow = acc_s + (w * ROWS + i) * D + c8;
#pragma unroll
      for (int x = 0; x < 8; ++x) A[x] += e * arow[x];
    }
    const int r = r0 + i;
    if (n_split == 1) {
      const float inv = L > 0.f ? 1.f / L : 0.f;   // no key: 0
      uint4 pk;
      pk.x = pack(A[0] * inv, A[1] * inv);
      pk.y = pack(A[2] * inv, A[3] * inv);
      pk.z = pack(A[4] * inv, A[5] * inv);
      pk.w = pack(A[6] * inv, A[7] * inv);
      *reinterpret_cast<uint4*>(
          out + (((size_t)b * n_t + r / G) * H + kv * G + r % G) * D + c8) = pk;
    } else {
      const size_t prow = ((size_t)tile * n_split + sp) * ROWS + i;
      float4* dst = reinterpret_cast<float4*>(part_acc + prow * D + c8);
      dst[0] = make_float4(A[0], A[1], A[2], A[3]);
      dst[1] = make_float4(A[4], A[5], A[6], A[7]);
      if (c8 == 0) part_ml[prow] = make_float2(M, L);
    }
  }
  if (n_split == 1) return;

  // the last block of this tile to finish merges the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(tickets + tile, 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  for (int u = tid; u < live * C8; u += TC_THREADS) {
    const int i = u / C8, c8 = (u % C8) * 8;
    const size_t prow0 = (size_t)tile * n_split * ROWS + i;
    float M = -INFINITY;
    for (int x = 0; x < n_split; ++x)
      M = fmaxf(M, __ldcg(part_ml + prow0 + (size_t)x * ROWS).x);
    float L = 0.f, A[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int x = 0; x < n_split; ++x) {
      const size_t prow = prow0 + (size_t)x * ROWS;
      const float2 ml = __ldcg(part_ml + prow);
      if (ml.x == -INFINITY) continue;   // an empty split
      const float e = exp2f(ml.x - M);
      L += e * ml.y;
      const float4* src = reinterpret_cast<const float4*>(part_acc + prow * D + c8);
      const float4 a0 = __ldcg(src), a1 = __ldcg(src + 1);
      A[0] += e * a0.x; A[1] += e * a0.y; A[2] += e * a0.z; A[3] += e * a0.w;
      A[4] += e * a1.x; A[5] += e * a1.y; A[6] += e * a1.z; A[7] += e * a1.w;
    }
    const float inv = L > 0.f ? 1.f / L : 0.f;   // no key: 0
    uint4 pk;
    pk.x = pack(A[0] * inv, A[1] * inv);
    pk.y = pack(A[2] * inv, A[3] * inv);
    pk.z = pack(A[4] * inv, A[5] * inv);
    pk.w = pack(A[6] * inv, A[7] * inv);
    const int r = r0 + i;
    *reinterpret_cast<uint4*>(
        out + (((size_t)b * n_t + r / G) * H + kv * G + r % G) * D + c8) = pk;
  }
  if (tid == 0) tickets[tile] = 0;   // ready for the next call
}

template <int D, int WR>
cudaError_t launch_bf16(const void* q, const void* k_pool, const void* v_pool,
                        const int* page_table, const int* lengths, void* out,
                        float* part, int* tickets, int B, int n_t, int H, int KV,
                        int ps, int n_slots, int n_split, int split_slots,
                        float scale, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D, WR>();
  static bool sized = false;   // the attribute is set once per instantiation
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_bf16_kernel<D, WR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const int rows = 16 * WR;
  const int n_rt = (n_t * (H / KV) + rows - 1) / rows;
  // partials: acc (tiles x n_split x rows x D floats), then (m, l) pairs
  const size_t n_part = (size_t)B * KV * n_rt * n_split * rows;
  const dim3 grid(B, KV, n_rt * n_split);
  paged_attention_bf16_kernel<D, WR><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), page_table, lengths,
      static_cast<bf16*>(out), part,
      part ? reinterpret_cast<float2*>(part + n_part * D) : nullptr,
      tickets, n_t, H, KV, ps, n_slots, n_split, split_slots,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_bf16(int row_tile, const void* q, const void* k_pool,
                          const void* v_pool, const int* page_table,
                          const int* lengths, void* out, float* part, int* tickets,
                          int B, int n_t, int H, int KV, int ps, int n_slots,
                          int n_split, int split_slots, float scale,
                          cudaStream_t stream) {
  if (row_tile == 16)
    return launch_bf16<D, 1>(q, k_pool, v_pool, page_table, lengths, out, part,
                             tickets, B, n_t, H, KV, ps, n_slots, n_split,
                             split_slots, scale, stream);
  if (row_tile == 64)
    return launch_bf16<D, 4>(q, k_pool, v_pool, page_table, lengths, out, part,
                             tickets, B, n_t, H, KV, ps, n_slots, n_split,
                             split_slots, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, T, H, D); pools (P, ps, KV, D); page_table (B, n_slots) int32;
// lengths (B,) int32; out (B, T, H, D).  All contiguous, q/pools/out of one
// dtype: 0 = float32, 1 = bfloat16, the bfloat16 ones 16-byte aligned.  For
// bfloat16, ``row_tile`` (16 or 64), ``n_split`` and ``split_slots`` come from
// the host's split plan; with n_split > 1, ``part`` holds
// B * KV * row_tiles * n_split * row_tile * (D + 2) floats and ``tickets``
// B * KV * row_tiles zeros (left zero by the kernel).  float32 ignores all
// five.  Returns the cudaError_t of the launch.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* page_table,
                                      const void* lengths, void* out, void* part,
                                      void* tickets, int B, int n_t, int H,
                                      int KV, int D, int ps, int n_slots,
                                      int row_tile, int n_split, int split_slots,
                                      int dtype, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* ln = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  if (dtype == 0) {
    switch (D) {
      case 16: return static_cast<int>(launch<float, 16>(q, k_pool, v_pool, pt, ln, out, B, n_t, H, KV, ps, n_slots, scale, st));
      case 32: return static_cast<int>(launch<float, 32>(q, k_pool, v_pool, pt, ln, out, B, n_t, H, KV, ps, n_slots, scale, st));
      case 64: return static_cast<int>(launch<float, 64>(q, k_pool, v_pool, pt, ln, out, B, n_t, H, KV, ps, n_slots, scale, st));
      case 128: return static_cast<int>(launch<float, 128>(q, k_pool, v_pool, pt, ln, out, B, n_t, H, KV, ps, n_slots, scale, st));
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype != 1 || n_split < 1 || split_slots < 1 ||
      (n_split > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (D) {
    case 16: err = dispatch_bf16<16>(row_tile, q, k_pool, v_pool, pt, ln, out, pa, tk, B, n_t, H, KV, ps, n_slots, n_split, split_slots, scale, st); break;
    case 32: err = dispatch_bf16<32>(row_tile, q, k_pool, v_pool, pt, ln, out, pa, tk, B, n_t, H, KV, ps, n_slots, n_split, split_slots, scale, st); break;
    case 64: err = dispatch_bf16<64>(row_tile, q, k_pool, v_pool, pt, ln, out, pa, tk, B, n_t, H, KV, ps, n_slots, n_split, split_slots, scale, st); break;
    case 128: err = dispatch_bf16<128>(row_tile, q, k_pool, v_pool, pt, ln, out, pa, tk, B, n_t, H, KV, ps, n_slots, n_split, split_slots, scale, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
