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
// Design.  The vocabulary axis of each batch row is cut into C contiguous
// chunks (kernels/fused_verify_sample.py::vocab_split_plan, from the shapes
// and the SM count alone), one block of 512 threads per (chunk, batch row),
// so that B x C blocks fill the card (B = 8 on 132 SMs: 16 chunks of 2000).
//   phase 0  each block sweeps its chunk of all L drafted rows once, eight
//            rows at a time (32 loads in flight a thread), with an online max
//            and sum per thread, the eight merged over the block together by
//            a fixed tree (the max first, then the sums rescaled to it once);
//            it writes the partial (m, s) of each (b, l, chunk) and picks the
//            drafted token's logit where the token falls in its chunk.
//   --- the row's blocks wait for each other ---
//   phase 1  every block of row b merges the C partials of each position in
//            chunk order (so no result depends on which block finished
//            first), one thread a position, runs the L accept tests side by
//            side and the prefix count (block 0 writes them), and over its
//            chunk of row sel computes the residual mass sum max(p - q, 0)
//            and argmax(p).  The sparse row contributes only its entries that
//            fall in the chunk, rank-sorted into shared memory; each vocab
//            entry finds its q by binary search.
//   --- the row's blocks wait for each other ---
//   phase 2  every block of row b takes the prefix sums of the C masses in
//            chunk order (one warp, 32 at a time; Z the last); Z <= 0 gives
//            the merged argmax; else the one chunk whose prefix crosses
//            u * Z runs the ordered inverse-CDF scan of its entries over
//            tiles of 2048 (4 consecutive a thread, block exclusive scan of
//            the thread sums), from the masses of the chunks before it;
//            should rounding leave its own sum short of u * Z, the token is
//            its last entry with a positive residual (the CDF step u * Z
//            lies at); no crossing gives V - 1.
// The waits need every block resident at once, which only a cooperative
// launch (cudaLaunchCooperativeKernel) guarantees: the plan caps B x C at the
// resident-block count cudaOccupancyMaxActiveBlocksPerMultiprocessor gives
// (fused_verify_sample_blocks_per_sm).  Each is a barrier of the row's C
// blocks alone, on a ticket per row (arrivals counted by atomicAdd after
// __threadfence, the last of a third round resetting it to 0), not of the
// whole grid: cooperative_groups' grid sync, which counts all B x C arrivals
// on one counter, released the grid 1.5-2.0 us after the last arrival at
// B x C = 128 on an H100, the row's wait 1.0-1.3 us.  When B alone fills the
// card the plan gives C = 1: one block owns its row, the launch is an
// ordinary one and the waits are __syncthreads.  The sums run in another
// order than torch's, so `calibrated` can differ from the plain version only
// where u * Z lies within rounding of a CDF step; a second call gives the
// same bits.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;         // threads per block
constexpr int NW = NT / 32;     // warps per block
constexpr int ITEMS = 4;        // consecutive vocab entries per thread in phase 2
constexpr int RG = 8;           // drafted rows a thread sweeps at once in phase 0
constexpr int UV = 4;           // vocab entries of each row a thread loads at once
constexpr int L_MAX = 64;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
__device__ __forceinline__ int warp_min_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// (m, s) of a softmax over two disjoint parts: max and the sum rescaled to it
__device__ __forceinline__ void merge_ms(float& m, float& s, float m2, float s2) {
  const float M = fmaxf(m, m2);
  if (M == -INFINITY) return;    // both empty
  s = s * expf(m - M) + s2 * expf(m2 - M);
  m = M;
}

// (m, s) of RG rows merged over the warp, lane 0 (and every lane) gets them:
// the max first, then each lane's sum rescaled to it once, then plain sums.
__device__ __forceinline__ void warp_merge_rows(float (&m)[RG], float (&s)[RG]) {
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    float M = m[i];
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, o));
    s[i] = m[i] == -INFINITY ? 0.f : s[i] * expf(m[i] - M);
    m[i] = M;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < RG; ++i) s[i] += __shfl_xor_sync(FULL, s[i], o);
}

// Block reductions: every thread gets the result.  `red` holds 32 slots.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  v = lane < NW ? red[lane] : 0.f;
  return warp_sum(v);
}
__device__ int block_min_i(int v, int* red) {
  v = warp_min_i(v);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  v = lane < NW ? red[lane] : INT_MAX;
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
  const bool ok = lane < NW;
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

// q of vocab entry v from the sorted sparse entries of this chunk
// (duplicates add up in their order in the row, as the reference's
// scatter-add does).
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

// The C blocks of batch row b wait for each other (C > 1: every block is
// resident, by the cooperative launch): arrival ``round`` (1 or 2) of each
// takes the row's ticket to round * C.  With C = 1 the block is alone.
__device__ __forceinline__ void row_barrier(int* ticket, int C, int round) {
  __syncthreads();
  if (C > 1 && threadIdx.x == 0) {
    __threadfence();                 // this block's partials are visible
    atomicAdd(ticket, 1);
    while (*reinterpret_cast<volatile int*>(ticket) < round * C) {
    }
    __threadfence();
  }
  __syncthreads();
}
// The block's third arrival, on its way out: the last of the row's C leaves
// the ticket at 0 for the next launch (every block has left the second wait).
__device__ __forceinline__ void row_done(int* ticket, int C) {
  if (C > 1 && threadIdx.x == 0 && atomicAdd(ticket, 1) == 3 * C - 1)
    atomicExch(ticket, 0);
}

// Scratch per call (floats): part (B, L, C) x (m, s); tok_x (B, L); mass,
// best_p, best_i (B, C) each.  Dynamic shared memory: the sparse entries of
// the chunk (vhat ints, then vhat floats), and before them, in phase 0, the
// warps' partials of a row group (2 x RG x NW floats).
__global__ void __launch_bounds__(NT)
fused_verify_sample_kernel(const float* __restrict__ logits, int Lp1, int V,
                           const int* __restrict__ tokens,
                           const float* __restrict__ probs,
                           const int* __restrict__ q_idx,
                           const float* __restrict__ q_val, int vhat,
                           const float* __restrict__ u_accept,
                           const float* __restrict__ u_resid,
                           const int* __restrict__ draft_len, int L, int C,
                           int chunk, float2* part, float* tok_x, float* mass,
                           float* best_p, int* best_i, int* tickets,
                           uint8_t* __restrict__ accept_out,
                           int* __restrict__ n_acc_out,
                           int* __restrict__ calibrated_out) {
  __shared__ float redf[32];
  __shared__ int redi[32];
  __shared__ float m_s[L_MAX], z_s[L_MAX];
  __shared__ unsigned char acc_s[L_MAX];
  __shared__ int sel_s, n_in_s, cross_s;
  __shared__ float start_s, target_s;
  extern __shared__ __align__(16) unsigned char dyn[];
  int* sidx = reinterpret_cast<int*>(dyn);
  float* sval = reinterpret_cast<float*>(sidx + vhat);
  float* wm_s = reinterpret_cast<float*>(dyn);   // phase 0: RG x NW
  float* ws_s = wm_s + RG * NW;                  //          RG x NW

  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int c0 = c * chunk;
  const int c1 = min(c0 + chunk, V);
  const float* rows = logits + (size_t)b * Lp1 * V;

  // ---- phase 0: softmax partials of this chunk of every drafted row ----
  for (int l0 = 0; l0 < L; l0 += RG) {
    float m[RG], s[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) { m[i] = -INFINITY; s[i] = 0.f; }
    for (int v = c0 + tid; v < c1; v += UV * NT) {   // UV x RG loads in flight
      float x[UV][RG];
#pragma unroll
      for (int h = 0; h < UV; ++h)
#pragma unroll
        for (int i = 0; i < RG; ++i)
          x[h][i] = l0 + i < L && v + h * NT < c1
                        ? rows[(size_t)(l0 + i) * V + v + h * NT] : -INFINITY;
#pragma unroll
      for (int i = 0; i < RG; ++i) {   // the max of the UV values first
        float mx = x[0][i];
#pragma unroll
        for (int h = 1; h < UV; ++h) mx = fmaxf(mx, x[h][i]);
        if (mx > m[i]) {
          s[i] *= expf(m[i] - mx);   // 0 while nothing was seen
          m[i] = mx;
        }
        if (m[i] != -INFINITY) {
#pragma unroll
          for (int h = 0; h < UV; ++h) s[i] += expf(x[h][i] - m[i]);
        }
      }
    }
    // the RG rows over the block at once: each warp, then warp 0 over them
    warp_merge_rows(m, s);
    __syncthreads();               // the last group's partials are read
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        wm_s[i * NW + warp] = m[i];
        ws_s[i * NW + warp] = s[i];
      }
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        m[i] = lane < NW ? wm_s[i * NW + lane] : -INFINITY;
        s[i] = lane < NW ? ws_s[i * NW + lane] : 0.f;
      }
      warp_merge_rows(m, s);
      if (lane < RG && l0 + lane < L) {
        float mi = m[0], si = s[0];
#pragma unroll
        for (int i = 1; i < RG; ++i)
          if (lane == i) { mi = m[i]; si = s[i]; }
        part[((size_t)b * L + l0 + lane) * C + c] = make_float2(mi, si);
      }
    }
  }
  if (tid < L) {
    const int t = tokens[b * L + tid];
    if (t >= c0 && t < c1) tok_x[b * L + tid] = rows[(size_t)tid * V + t];
  }
  row_barrier(tickets + b, C, 1);

  // ---- phase 1: the accept test, then this chunk of the residual ----
  if (tid < L) {   // position tid: its partials merged in chunk order, its test
    const float2* pp = part + ((size_t)b * L + tid) * C;
    float M = -INFINITY, Z = 0.f;
#pragma unroll 8
    for (int x = 0; x < C; ++x) {
      const float2 ms = __ldcg(pp + x);
      merge_ms(M, Z, ms.x, ms.y);
    }
    m_s[tid] = M;
    z_s[tid] = Z;
    const float p_t = expf(__ldcg(tok_x + b * L + tid) - M) / Z;
    const float ratio = p_t / fmaxf(probs[b * L + tid], 1e-30f);
    const bool acc = (u_accept[b * L + tid] < fminf(ratio, 1.f)) && (tid < draft_len[b]);
    acc_s[tid] = acc;
    if (c == 0) accept_out[b * L + tid] = acc ? 1 : 0;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    while (n < L && acc_s[n]) ++n;
    if (c == 0) n_acc_out[b] = n;
    sel_s = min(n, L - 1);
    n_in_s = 0;
  }
  __syncthreads();
  const int sel = sel_s;
  const float m = m_s[sel];
  const float z = z_s[sel];
  const float* row = rows + (size_t)sel * V;

  // the sparse entries of row sel that fall in [c0, c1), sorted by vocab id
  // (rank among them; ties by their position in the row)
  const int* qi = q_idx + ((size_t)b * L + sel) * vhat;
  const float* qv = q_val + ((size_t)b * L + sel) * vhat;
  for (int i = tid; i < vhat; i += NT) {
    const int key = qi[i];
    if (key < c0 || key >= c1) continue;
    int rank = 0;
    for (int j0 = 0; j0 < vhat; j0 += 8) {   // 8 loads in flight
      int o[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) o[u] = j0 + u < vhat ? qi[j0 + u] : INT_MAX;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        rank += (o[u] >= c0 && o[u] < c1 &&
                 (o[u] < key || (o[u] == key && j0 + u < i))) ? 1 : 0;
    }
    sidx[rank] = key;
    sval[rank] = qv[i];
    atomicAdd(&n_in_s, 1);
  }
  __syncthreads();
  const int n_in = n_in_s;

  float zr = 0.f, best = -INFINITY;
  int bi = INT_MAX;
  for (int v = c0 + tid; v < c1; v += NT) {
    const float p = expf(row[v] - m) / z;
    zr += fmaxf(p - sparse_q(v, sidx, sval, n_in), 0.f);
    if (p > best) { best = p; bi = v; }
  }
  zr = block_sum(zr, redf);
  block_argmax(best, bi, redf, redi);
  if (tid == 0) {
    mass[b * C + c] = zr;
    best_p[b * C + c] = best;
    best_i[b * C + c] = bi;
  }
  row_barrier(tickets + b, C, 2);

  // ---- phase 2: the chunk masses in chunk order, then the crossing ----
  if (warp == 0) {   // the masses' prefix sums in chunk order, 32 at a time
    const float* mb = mass + b * C;
    auto prefix = [&](int x0, float before) {   // lane's inclusive prefix
      float inc = x0 + lane < C ? __ldcg(mb + x0 + lane) : 0.f;
      for (int o = 1; o < 32; o <<= 1) {
        const float n = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += n;
      }
      return before + inc;
    };
    const float inc0 = prefix(0, 0.f);   // the first 32, kept for the search
    float Z = __shfl_sync(FULL, inc0, 31);
    for (int x0 = 32; x0 < C; x0 += 32) Z = __shfl_sync(FULL, prefix(x0, Z), 31);
    const float target = u_resid[b] * Z;
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
    if (lane == 0) {
      if (c == 0 && cross == -1) {   // argmax(p) over the chunks, in order
        float bp = -INFINITY;
        int bt = INT_MAX;
        for (int x = 0; x < C; ++x) {
          const float p = __ldcg(best_p + b * C + x);
          if (p > bp) { bp = p; bt = __ldcg(best_i + b * C + x); }
        }
        calibrated_out[b] = bt;
      }
      if (c == 0 && cross == C) calibrated_out[b] = V - 1;
      cross_s = cross;
      start_s = start;
      target_s = target;
    }
  }
  __syncthreads();
  row_done(tickets + b, C);
  if (cross_s != c) return;        // block-uniform

  // the ordered inverse-CDF scan of this chunk, from the masses before it
  const float target = target_s;
  float running = start_s;
  int found = INT_MAX;
  int last = INT_MAX;              // minus the last entry with a positive residual
  for (int base = c0; base < c1; base += NT * ITEMS) {
    const int v0 = base + tid * ITEMS;
    float loc[ITEMS];
    float tsum = 0.f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int v = v0 + i;
      float r = 0.f;
      if (v < c1) r = fmaxf(expf(row[v] - m) / z - sparse_q(v, sidx, sval, n_in), 0.f);
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
      if (hit == INT_MAX && cum > target && v0 + i < c1) hit = v0 + i;
    }
    hit = block_min_i(hit, redi);
    running += total;
    if (hit != INT_MAX) { found = hit; break; }  // uniform: every thread has hit
  }
  // The masses put the crossing in this chunk, but the scan's own sums (in
  // another order) fell short of u * Z: u * Z lies within rounding of the
  // chunk's last CDF step, which is its last entry with a positive residual.
  if (found == INT_MAX) found = -block_min_i(last, redi);
  if (tid == 0) calibrated_out[b] = found;
}

// dynamic shared memory: the sparse entries, or phase 0's partials
size_t dyn_smem(int vhat) {
  const size_t row = (size_t)vhat * (sizeof(int) + sizeof(float));
  const size_t parts = 2 * RG * NW * sizeof(float);
  return row > parts ? row : parts;
}

}  // namespace

// Resident blocks of the kernel per SM with ``vhat`` sparse entries a row;
// returns the cudaError_t of the query.
extern "C" int fused_verify_sample_blocks_per_sm(int vhat, int* blocks) {
  const size_t smem = dyn_smem(vhat);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fused_verify_sample_kernel, NT, smem));
}

// logits (B, Lp1, V) f32 with Lp1 >= L; tokens / u_accept / probs (B, L);
// q_idx / q_val (B, L, vhat) int32 / f32; u_resid (B,) f32; draft_len (B,)
// int32.  ``C`` chunks of ``chunk`` vocab entries per row (the host's
// vocab_split_plan; C * chunk >= V > (C - 1) * chunk); ``scratch`` holds
// B * (L * (2 * C + 1) + 3 * C) floats and ``tickets`` B zeros (left zero).  Outputs: accept (B, L) uint8 (0/1),
// n_acc (B,) int32, calibrated (B,) int32.  All contiguous.  Returns the
// cudaError_t of the launch.
extern "C" int fused_verify_sample_launch(const void* logits, int B, int Lp1, int V,
                                          const void* tokens, const void* probs,
                                          const void* q_idx, const void* q_val,
                                          int vhat, const void* u_accept,
                                          const void* u_resid, const void* draft_len,
                                          int L, int C, int chunk, void* scratch,
                                          void* tickets, void* accept, void* n_acc,
                                          void* calibrated, void* stream) {
  if (L < 1 || L > L_MAX || Lp1 < L || vhat < 1 || C < 1 || chunk < 1 ||
      (long long)C * chunk < V || (long long)(C - 1) * chunk >= V)
    return static_cast<int>(cudaErrorInvalidValue);
  // the sorted sparse row is dynamic shared memory; with the kernel's
  // static arrays it must fit the 48 KB a launch gets without opting in
  static size_t static_smem = SIZE_MAX;
  if (static_smem == SIZE_MAX) {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, fused_verify_sample_kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    static_smem = attr.sharedSizeBytes;
  }
  const size_t smem = dyn_smem(vhat);
  if (smem + static_smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const float* lg = static_cast<const float*>(logits);
  const int* tk = static_cast<const int*>(tokens);
  const float* pr = static_cast<const float*>(probs);
  const int* qi = static_cast<const int*>(q_idx);
  const float* qv = static_cast<const float*>(q_val);
  const float* ua = static_cast<const float*>(u_accept);
  const float* ur = static_cast<const float*>(u_resid);
  const int* dl = static_cast<const int*>(draft_len);
  float* sc = static_cast<float*>(scratch);
  float2* part = reinterpret_cast<float2*>(sc);
  float* tok_x = sc + (size_t)2 * B * L * C;
  float* mass = tok_x + (size_t)B * L;
  float* best_p = mass + (size_t)B * C;
  int* best_i = reinterpret_cast<int*>(best_p + (size_t)B * C);
  int* tk_row = static_cast<int*>(tickets);
  uint8_t* acc = static_cast<uint8_t*>(accept);
  int* na = static_cast<int*>(n_acc);
  int* cal = static_cast<int*>(calibrated);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(C, B);
  if (C == 1) {
    fused_verify_sample_kernel<<<grid, NT, smem, st>>>(
        lg, Lp1, V, tk, pr, qi, qv, vhat, ua, ur, dl, L, C, chunk, part, tok_x,
        mass, best_p, best_i, tk_row, acc, na, cal);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&lg, &Lp1, &V, &tk, &pr, &qi, &qv, &vhat, &ua, &ur, &dl, &L,
                  &C, &chunk, &part, &tok_x, &mass, &best_p, &best_i, &tk_row,
                  &acc, &na, &cal};
  // refused (cudaErrorCooperativeLaunchTooLarge) unless every block fits at once
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_verify_sample_kernel), grid, dim3(NT),
      args, smem, st));
}
