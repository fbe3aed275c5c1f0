// Tensor-core building blocks shared by the bf16 attention kernels
// (flash_attention.cu, paged_attention.cu) for Hopper (sm_90a).
//
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) with its operands brought
// from shared memory by ldmatrix, and 16-byte cp.async copies from device
// memory into shared memory.  Fragment layouts (PTX ISA, "Matrix Fragments
// for mma.m16n8k16"), for lane = 4 * gid + tq:
//   A (16 x 16, row-major)  a0 (gid, 2tq..+1)  a1 (gid+8, 2tq..)
//                           a2 (gid, 2tq+8..)  a3 (gid+8, 2tq+8..)
//   B (16 x 8, k x n)       b0 (k 2tq..+1, n gid)  b1 (k 2tq+8..+9, n gid)
//   C (16 x 8, f32)         c0, c1 (gid, 2tq..+1)  c2, c3 (gid+8, 2tq..+1)
// So the C fragments of two adjacent 8-key blocks of scores are, packed to
// bf16 pairs, the A fragment of the same 16 keys for the P V product.
// P is passed as two such fragments (``split2``), so P V is exact to ~2^-16
// of each weight: the one bf16 rounding left is the output's.
//
// Shared tiles hold rows of D bf16 padded to D + 8: the row stride is then
// 16 bytes more than a multiple of 32, so the eight 16-byte rows an
// ldmatrix phase reads fall in eight different bank groups (no conflicts),
// and every row stays 16-byte aligned for cp.async.

#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace mma_bf16 {

// a block's dynamic shared memory past the 48 KB default, after opt-in
// (sm_90: 227 KB)
constexpr size_t SMEM_OPT_IN = 232448;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, through L2 only; zero-filled when !valid
// (no byte of ``src`` is read then, but it must still be a device pointer)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, of matrix i, elements (l / 4, 2 (l % 4) .. + 1) in r[i]
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, transposed: of matrix i, elements (2 (l % 4) .. + 1, l / 4)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b: a 16 x 16 bf16 (4 regs), b 16 x 8 bf16 (2 regs), c 16 x 8 f32
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi) (lo
// element in the low half): hi + lo carries ~16 significant bits, so a
// product with P split this way loses what one bf16 rounding of P would
// (up to 2^-9 of each weight) only at the 2^-17 level
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace mma_bf16
