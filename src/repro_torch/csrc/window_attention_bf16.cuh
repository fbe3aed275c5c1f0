// Window attention at bfloat16 on Hopper's tensor cores (sm_90a): the one
// kernel body of paged_attention.cu (B1), paged_tree_attention.cu (B3),
// tree_attention.cu (B6) and decode_attention.cu (B7 and, with a bf16 q, B9:
// a one-row window over contiguous keys with B1's horizon, through their
// own dispatch of head dims).
//
// A window of T query rows of batch row b attends keys of logical positions
// [0, n_keys).  Two template parameters make the kernels:
//   - a key locator finds key ``pos`` of row b: through a page table whose
//     unmapped (-1) slots read as zeros and are masked (``PagedKeys``), or in
//     a contiguous (B, S, KV, D) cache (``ContiguousKeys``), of bf16 rows or
//     of int8 codes with one k and one v scale per (b, kv head)
//     (``ContiguousCodes``, B9: its ``elem`` is int8_t);
//   - a mask policy says which keys a query row sees: B1's per-row horizon,
//     row t sees kpos < lengths[b] + t (``CausalRows``), the same within a
//     sliding window of the last ``window`` keys (``CausalRowsInWindow``,
//     whose tiles start their walk at their first row's lowest key), or a
//     token tree's,
//     row t sees kpos < lengths[b] and window key lengths[b] + u where bit u
//     of its 64-bit ancestor word is set (``TreeRows``, T <= 64).
//
// Design.  Grid (B, KV, row tiles x n_split).  The T*G query rows that share
// a kv head are flattened (r = t*G + g) and tiled by 16 (T*G <= 16: the
// draft, verify and tree windows of the serving paths) or by 64.  The key
// axis is cut into n_split contiguous ranges (the host picks them from
// shapes alone, never from ``lengths``) and each block walks its range,
// clipped to the tile's horizon (the last row's horizon for B1, lengths[b]
// + T for a tree), in chunks of 64 logical positions: each key row (D bf16)
// is located and staged by 16-byte cp.async copies into a two-stage ring
// (chunk c + 1 loads while chunk c computes), zero-filled where unmapped or
// past the range.  With 16-row tiles the four warps share the rows and split
// each chunk's 64 keys (16 each); with 64-row tiles each warp owns 16 rows
// and walks all 64 keys.  Scores and P V run on mma.sync.m16n8k16, masked on
// the fragment, with the online softmax in f32 registers and P split into
// bf16 hi + lo parts (mma_bf16.cuh).  A tree row's visibility over the keys
// a lane scores in one chunk is one 64-bit word, built per chunk from the
// committed count and the ancestor word shifted to the chunk: a chunk below
// lengths[b] is all ones, and each fragment element tests one bit.  The
// warps' states are merged in shared memory; with one split the block writes
// the output, else its f32 partial (m, l, acc[D]) per row goes to a scratch
// buffer, and the last block of each (b, kv, row tile) to finish, found by an
// atomic ticket taken after __threadfence(), merges the partials in split
// order (the result does not depend on which block came last), writes the
// output and resets the ticket to 0: one launch, and the scratch needs no
// clearing between calls.  A block whose range lies past the tile's horizon
// or holds only unmapped slots writes an empty partial (m = -inf, l = 0),
// skipped by the merge; a row that sees no key returns 0.
//
// Head dim 256 (gemma-7b, paligemma-3b).  A warp's 16-row output
// accumulator is then D / 8 = 32 fragments, 128 f32 registers a thread, and
// Q as A fragments would add 64 more: so for D > 128 the Q tile stays in
// shared memory (q_s) and each k-step of Q K^T loads its one fragment there
// (the k-step loop is outside the 16-key loop, so one load serves all of a
// warp's keys of the chunk); D <= 128 keeps Q in registers for the walk,
// with the key loop outside.
// A 16-row tile then needs 168-252 registers and no spill; a 64-row tile
// (each warp scores all 64 keys of a chunk: 32 more registers) uses 255
// and spills 4-16 bytes.  Walking its chunks in two key groups of 32, each
// with its own softmax step, spilled 32-152 bytes instead, and the row
// tile (16 or 64, from the host's split plans) cannot hand half of the
// columns to a second warp.  The shared memory of a 64-row tile is
// (64 + 4 * 64) * 264 * 2 = 168,960 bytes, under the 227 KB opt-in.
//
// Int8 codes (B9).  A code row is D bytes (16 to 256, a multiple of 16), so
// it is staged by D / 16 16-byte cp.async copies into a two-stage ring of
// codes beside the bf16 one; once chunk c has landed, one pass over shared
// memory turns its codes into the bf16 rows of stage c & 1 (exact: |code|
// <= 127), and the body runs on them unchanged.  The block's k_scale joins
// the score scale, its v_scale multiplies the finished output: at unit
// scales the arithmetic is B7's on codes.to(bfloat16), bit for bit.  The
// kernel's k_src / v_src are the caches' base pointers, read as the
// locator's ``elem``; the bf16 locators compile as they did before.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace window_bf16 {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 128;   // four warps
constexpr int KC = 64;         // logical key positions of a staged chunk
constexpr int T_MAX = 64;      // a tree window: one 64-bit word per row

using mma_bf16::SMEM_OPT_IN;

// q tile + two stages of K and V (+ two stages of their codes)
template <int D, int WR, class Keys>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (size_t)(16 * WR + 4 * KC) * (D + 8) +
         (std::is_same<typename Keys::elem, bf16>::value ? 0 : 4 * (size_t)KC * D);
}

// ---------------------------------------------------------------------------
// key locators
// ---------------------------------------------------------------------------

// Pools (P, ps, KV, D) through a (B, n_slots) page table.  SLOT_SPLIT: a
// split holds ``split`` whole slots (B1's plan), else ``split`` keys.
template <bool SLOT_SPLIT>
struct PagedKeys {
  using elem = bf16;
  const int* page_table;
  int ps, n_slots;
  const int* pt;   // row b's slots, set by row()

  __device__ void row(int b) { pt = page_table + (size_t)b * n_slots; }
  __device__ int n_keys() const { return n_slots * ps; }
  // ``tile_lo``: the lowest key the tile sees (0 but in a key window); a
  // slot split counts its slots from the slot that holds it
  __device__ void range(int sp, int split, int tile_lo, int tile_h,
                        int& k_begin, int& k_end) const {
    if (SLOT_SPLIT) {
      const int s0 = tile_lo / ps + sp * split;
      k_begin = s0 * ps;
      k_end = min(min(s0 + split, n_slots) * ps, tile_h);
    } else {
      k_begin = sp * split;
      k_end = min(min(k_begin + split, n_slots * ps), tile_h);
    }
  }
  // some slot of [k_begin, k_end) is mapped (this thread's share of them)
  __device__ bool any_key(int k_begin, int k_end, int tid) const {
    bool any = false;
    if (k_begin < k_end)
      for (int s = k_begin / ps + tid; s <= (k_end - 1) / ps; s += THREADS)
        any |= pt[s] >= 0;
    return any;
  }
  // element offset of key ``pos`` (kv head kv) in the pools; ``ok`` when it
  // lies before k_end on a mapped slot
  __device__ size_t offset(int pos, int k_end, int KV, int kv, int D,
                           bool& ok) const {
    const int page = pos < k_end ? pt[pos / ps] : -1;
    ok = page >= 0;
    return (((size_t)page * ps + pos % ps) * KV + kv) * D;
  }
};

// Caches (B, S, KV, D): key ``pos`` of row b is row pos of b's slab.
struct ContiguousKeys {
  using elem = bf16;
  int S;
  int b;   // set by row()

  __device__ void row(int b_) { b = b_; }
  __device__ int n_keys() const { return S; }
  __device__ void range(int sp, int split, int, int tile_h, int& k_begin,
                        int& k_end) const {
    k_begin = sp * split;
    k_end = min(min(k_begin + split, S), tile_h);
  }
  __device__ bool any_key(int k_begin, int k_end, int) const {
    return k_begin < k_end;
  }
  __device__ size_t offset(int pos, int k_end, int KV, int kv, int D,
                           bool& ok) const {
    ok = pos < k_end;
    return (((size_t)b * S + pos) * KV + kv) * D;
  }
};

// Caches (B, S, KV, D) of int8 codes with float32 scales (B, KV), one k and
// one v scale per (batch row, kv head): B9.
struct ContiguousCodes : ContiguousKeys {
  using elem = int8_t;
  const float* k_scale;
  const float* v_scale;
};

// ---------------------------------------------------------------------------
// mask policies: a lane holds the state of its two fragment rows (half 0:
// row gid of its warp's 16, half 1: row gid + 8)
// ---------------------------------------------------------------------------

// B1: row t sees kpos < lengths[b] + t.
struct CausalRows {
  int horizon[2];   // exclusive key horizon of each row (0: a padding row)

  __device__ int tile_horizon(int base, int t_last, int) const {
    return base + t_last;
  }
  __device__ int tile_floor(int, int) const { return 0; }
  __device__ void stage(int, int, int, int, int) {}
  __device__ void row(int half, bool live, int base, int t) {
    horizon[half] = live ? base + t : 0;
  }
  __device__ void chunk(int, int) {}
  __device__ bool sees(int kpos, int, int half) const {
    return kpos < horizon[half];
  }
};

// B1 of a sliding-window layer: row t sees the last ``window`` keys below
// its horizon, lengths[b] + t - window <= kpos < lengths[b] + t.  The tile
// starts its walk at the slot of its first row's lowest key, so slots
// below every row's window are never read (they may be -1).
struct CausalRowsInWindow : CausalRows {
  int window;

  __device__ int tile_floor(int base, int t_first) const {
    return max(0, base + t_first - window);
  }
  __device__ bool sees(int kpos, int, int half) const {
    return kpos < horizon[half] && kpos >= horizon[half] - window;
  }
};

// B3, B6: row t sees kpos < lengths[b] and window key lengths[b] + u where
// win_mask[b, t, u] is set.
struct TreeRows {
  const uint8_t* win_mask;   // (B, T, T) bytes
  const unsigned long long* words;   // shared: bit u of words[t] = mask[b, t, u]
  unsigned long long word[2];   // each row's ancestor word (0: a padding row)
  int lo[2];                    // each row's committed count (0: padding)
  unsigned long long vis[2];    // bit jc: the lane's key jc of this chunk

  __device__ int tile_horizon(int base, int, int n_t) const {
    return base + n_t;
  }
  __device__ int tile_floor(int, int) const { return 0; }
  // the words of window rows t0..t1 to shared memory, one warp per row
  __device__ void stage(int b, int n_t, int t0, int t1, int tid) {
    __shared__ unsigned long long words_s[T_MAX];
    const int lane = tid & 31;
    for (int t = t0 + (tid >> 5); t <= t1; t += THREADS / 32) {
      const uint8_t* m = win_mask + ((size_t)b * n_t + t) * n_t;
      const unsigned lo32 = __ballot_sync(0xffffffffu, lane < n_t && m[lane]);
      const unsigned hi32 =
          __ballot_sync(0xffffffffu, lane + 32 < n_t && m[lane + 32]);
      if (lane == 0) words_s[t] = lo32 | (unsigned long long)hi32 << 32;
    }
    __syncthreads();
    words = words_s;
  }
  __device__ void row(int half, bool live, int base, int t) {
    word[half] = 0ull;
    if (live) word[half] = words[t];   // t of a padding row may pass T_MAX
    lo[half] = live ? base : 0;
  }
  // ``base``: lengths[b]; ``first``: the position of the lane's key jc = 0
  __device__ void chunk(int base, int first) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nc = lo[half] - first;   // committed keys from ``first``
      const unsigned long long c =
          nc <= 0 ? 0ull : nc >= 64 ? ~0ull : (1ull << nc) - 1ull;
      const int d = base - first;        // jc of window key 0
      const unsigned long long w =
          (d >= 64 || d <= -64) ? 0ull
          : d >= 0              ? word[half] << d
                                : word[half] >> -d;
      vis[half] = c | w;
    }
  }
  __device__ bool sees(int, int jc, int half) const {
    return (vis[half] >> jc) & 1ull;
  }
};

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// WR = 1: a 16-row tile, the four warps split each chunk's keys;
// WR = 4: a 64-row tile, warp w owns rows 16w .. 16w + 15 and every key.
template <int D, int WR, class Keys, class Mask>
__global__ void __launch_bounds__(THREADS)
window_attention_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k_src,
                        const bf16* __restrict__ v_src, Keys keys, Mask mask,
                        const int* __restrict__ lengths,
                        bf16* __restrict__ out, float* __restrict__ part_acc,
                        float2* __restrict__ part_ml, int* __restrict__ tickets,
                        int n_t, int H, int KV, int n_split, int split,
                        float scale_log2) {
  using namespace mma_bf16;
  static_assert(D % 16 == 0 && D <= 256 && (WR == 1 || WR == 4), "shape");
  using elem = typename Keys::elem;
  constexpr bool CODES = !std::is_same<elem, bf16>::value;   // int8 rows (B9)
  constexpr int ROWS = 16 * WR;    // query rows of the tile
  constexpr int WK = 4 / WR;       // warps sharing one 16-row group
  constexpr int KW = KC / WK;      // keys of a chunk each warp scores
  constexpr int NP = KW / 16;      // its 16-key steps
  constexpr int DP = D + 8;        // padded shared row (bf16)
  constexpr int C8 = D / 8;        // 16-byte chunks of a row
  constexpr int KS = D / 16;       // k-steps of Q K^T
  constexpr int NB = D / 8;        // 8-column blocks of the output
  constexpr int C16 = D / 16;      // 16-byte chunks of a code row
  constexpr bool Q_REGS = D <= 128;  // Q as A fragments for the whole walk
  // the warps' merged states fit over the K/V stages
  static_assert((size_t)(4 / WR) * 16 * WR * (D + 2) * sizeof(float) <=
                    4 * (size_t)KC * (D + 8) * sizeof(bf16), "merge space");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // ROWS x DP
  bf16* k_s = q_s + ROWS * DP;                     // 2 x KC x DP
  bf16* v_s = k_s + 2 * KC * DP;                   // 2 x KC x DP
  // codes only: 2 x KC x D of K, then of V
  int8_t* kc_s = reinterpret_cast<int8_t*>(v_s + 2 * KC * DP);
  int8_t* vc_s = kc_s + 2 * KC * D;
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
  keys.row(b);
  float scale_s = scale_log2;   // of the scores (log2 units)
  float out_s = 1.f;            // of the output (codes only)
  if constexpr (CODES) {
    scale_s *= keys.k_scale[b * KV + kv];
    out_s = keys.v_scale[b * KV + kv];
  }

  // keys [k_begin, k_end): this split's range, clipped to the tile's horizon
  const int tile_h =
      min(mask.tile_horizon(base, (r0 + live - 1) / G, n_t), keys.n_keys());
  int k_begin, k_end;
  keys.range(sp, split, mask.tile_floor(base, r0 / G), tile_h, k_begin,
             k_end);
  const int n_chunks = __syncthreads_or(keys.any_key(k_begin, k_end, tid))
                           ? (k_end - k_begin + KC - 1) / KC
                           : 0;

  mask.stage(b, n_t, r0 / G, (r0 + live - 1) / G, tid);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = wr * 16 + gid + half * 8;
    mask.row(half, i < live, base, (r0 + i) / G);
  }

  auto load_chunk = [&](int c, int stage) {
    const int kc0 = k_begin + c * KC;
    if constexpr (CODES) {
      const elem* k8 = reinterpret_cast<const elem*>(k_src);
      const elem* v8 = reinterpret_cast<const elem*>(v_src);
      for (int i = tid; i < KC * C16; i += THREADS) {
        const int j = i / C16, cc = i % C16;
        bool ok;
        const size_t o = keys.offset(kc0 + j, k_end, KV, kv, D, ok) + cc * 16;
        const int d = (stage * KC + j) * D + cc * 16;
        cp_async16(kc_s + d, ok ? k8 + o : k8, ok);   // zeros past the range
        cp_async16(vc_s + d, ok ? v8 + o : v8, ok);
        if (cc == 0) mapped_s[stage][j] = ok;
      }
    } else {
      for (int i = tid; i < KC * C8; i += THREADS) {
        const int j = i / C8, cc = i % C8;
        bool ok;
        const size_t o = keys.offset(kc0 + j, k_end, KV, kv, D, ok) + cc * 8;
        const int d = (stage * KC + j) * DP + cc * 8;
        cp_async16(k_s + d, ok ? k_src + o : k_src, ok);   // zeros where
        cp_async16(v_s + d, ok ? v_src + o : v_src, ok);   // unmapped
        if (cc == 0) mapped_s[stage][j] = ok;
      }
    }
  };
  if (n_chunks > 0) {
    for (int i = tid; i < ROWS * C8; i += THREADS) {
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

  uint32_t qf[Q_REGS ? KS : 1][4];
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
    if constexpr (CODES) {         // chunk c's codes to the bf16 rows of c & 1
      const int st = c & 1;
      for (int i = tid; i < 2 * KC * C16; i += THREADS) {
        const int kv_half = i / (KC * C16);
        const int j = (i / C16) % KC, cc = i % C16;
        const int8_t* src = (kv_half ? vc_s : kc_s) + (st * KC + j) * D + cc * 16;
        bf16* dst = (kv_half ? v_s : k_s) + (st * KC + j) * DP + cc * 16;
        const int4 raw = *reinterpret_cast<const int4*>(src);
        const int w[4] = {raw.x, raw.y, raw.z, raw.w};
        uint32_t h[8];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          h[2 * x] = pack((float)(int8_t)(w[x] & 0xff),
                          (float)(int8_t)((w[x] >> 8) & 0xff));
          h[2 * x + 1] = pack((float)(int8_t)((w[x] >> 16) & 0xff),
                              (float)(int8_t)((w[x] >> 24) & 0xff));
        }
        reinterpret_cast<uint4*>(dst)[0] = make_uint4(h[0], h[1], h[2], h[3]);
        reinterpret_cast<uint4*>(dst)[1] = make_uint4(h[4], h[5], h[6], h[7]);
      }
      __syncthreads();
    }
    if constexpr (Q_REGS) {
      if (c == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldsm_x4(qf[kk], q_s + (wr * 16 + (lane & 15)) * DP + kk * 16 +
                              (lane >> 4) * 8);
      }
    }
    const int st = c & 1;
    const int kc0 = k_begin + c * KC;
    const bf16* ks = k_s + (st * KC + kw0) * DP;
    const bf16* vs = v_s + (st * KC + kw0) * DP;

    float s[2 * NP][4];
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (Q_REGS) {
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
    } else {
      // the k-step loop outside the keys: each Q fragment is loaded once a
      // chunk, and each score still sums its k-steps in order
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        ldsm_x4(qf[0], q_s + (wr * 16 + (lane & 15)) * DP + kk * 16 +
                           (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          uint32_t kb[4];
          ldsm_x4(kb, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * DP +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma16816(s[2 * np], qf[0], kb[0], kb[1]);
          mma16816(s[2 * np + 1], qf[0], kb[2], kb[3]);
        }
      }
    }

    // mask on the fragment (unmapped, not seen by the row), row max
    mask.chunk(base, kc0 + kw0 + tq * 2);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2 * NP; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = kw0 + n * 8 + tq * 2 + (e & 1);
        const bool seen =
            mapped_s[st][j] && mask.sees(kc0 + j, n * 8 + (e & 1), e >> 1);
        s[n][e] = seen ? s[n][e] * scale_s : -INFINITY;
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
  for (int u = tid; u < live * C8; u += THREADS) {
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
      float inv = L > 0.f ? 1.f / L : 0.f;   // no key: 0
      if constexpr (CODES) inv *= out_s;
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
  for (int u = tid; u < live * C8; u += THREADS) {
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
    float inv = L > 0.f ? 1.f / L : 0.f;   // no key: 0
    if constexpr (CODES) inv *= out_s;
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

template <int D, int WR, class Keys, class Mask>
cudaError_t launch(const void* q, const void* k_src, const void* v_src,
                   Keys keys, Mask mask, const int* lengths, void* out,
                   float* part, int* tickets, int B, int n_t, int H, int KV,
                   int n_split, int split, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, WR, Keys>();
  // int8 codes at D = 256 fit a 16-row tile only (B9's G <= 16 gives no
  // other): a 64-row tile would need 234,496 bytes
  static_assert(smem <= SMEM_OPT_IN, "shared memory of the tile");
  static bool sized = false;   // the attribute is set once per instantiation
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_attention_kernel<D, WR, Keys, Mask>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const int rows = 16 * WR;
  const int n_rt = (n_t * (H / KV) + rows - 1) / rows;
  // partials: acc (tiles x n_split x rows x D floats), then (m, l) pairs
  const size_t n_part = (size_t)B * KV * n_rt * n_split * rows;
  const dim3 grid(B, KV, n_rt * n_split);
  window_attention_kernel<D, WR, Keys, Mask><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_src),
      static_cast<const bf16*>(v_src), keys, mask, lengths,
      static_cast<bf16*>(out), part,
      part ? reinterpret_cast<float2*>(part + n_part * D) : nullptr, tickets,
      n_t, H, KV, n_split, split, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// The bfloat16 launch of every head dim and row tile: ``row_tile`` (16 or
// 64), ``n_split`` and ``split`` from the host's split plan; with
// n_split > 1, ``part`` holds B * KV * row_tiles * n_split * row_tile *
// (D + 2) floats and ``tickets`` B * KV * row_tiles zeros (left zero).
template <class Keys, class Mask>
cudaError_t dispatch(int D, int row_tile, const void* q, const void* k_src,
                     const void* v_src, Keys keys, Mask mask,
                     const int* lengths, void* out, float* part, int* tickets,
                     int B, int n_t, int H, int KV, int n_split, int split,
                     float scale, cudaStream_t stream) {
  if (n_split < 1 || split < 1 ||
      (n_split > 1 && (part == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
#define WINDOW_BF16_CASE(DD)                                                  \
  case DD:                                                                    \
    if (row_tile == 16)                                                       \
      return launch<DD, 1>(q, k_src, v_src, keys, mask, lengths, out, part,   \
                           tickets, B, n_t, H, KV, n_split, split, scale,     \
                           stream);                                           \
    if (row_tile == 64)                                                       \
      return launch<DD, 4>(q, k_src, v_src, keys, mask, lengths, out, part,   \
                           tickets, B, n_t, H, KV, n_split, split, scale,     \
                           stream);                                           \
    return cudaErrorInvalidValue;
  switch (D) {
    WINDOW_BF16_CASE(16)
    WINDOW_BF16_CASE(32)
    WINDOW_BF16_CASE(64)
    WINDOW_BF16_CASE(128)
    WINDOW_BF16_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef WINDOW_BF16_CASE
}

}  // namespace window_bf16
