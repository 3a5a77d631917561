// Tensor-core building blocks shared by the bf16 kernels of
// conv3d_k3.cu (wide_tc_kernel), pooled_attention.cu (the *_tc kernels)
// and probe_ladder.cu (gram27, wide_fwd), for sm_90a: ldmatrix loads of
// 8x8 b16 tiles from shared memory, the m16n8k16 bf16 product with f32
// sums, zero-filling cp.async, a swizzle that keeps ldmatrix free of bank
// conflicts, and the fixed-order sum of split-K partials (the last two
// also for the f32 *_tf32x3 kernels of pooled_attention.cu, conv3d_k3.cu
// and conv3d_toeplitz.cu).
//
// Fragments (PTX ISA, mma.m16n8k16 .row.col), with g = lane / 4 and
// q = lane % 4; a 32-bit register holds two bf16, the lower index in its
// low half:
//   A (16 x 16, row-major) a0: (g, 2q..2q+1)  a1: (g+8, 2q..)
//                          a2: (g, 2q+8..)    a3: (g+8, 2q+8..)
//   B (16 x 8, k x n)      b0: (k 2q..2q+1, n g)  b1: (k 2q+8.., n g)
//   C (16 x 8, f32)        c0: (g, 2q)  c1: (g, 2q+1)
//                          c2: (g+8, 2q)  c3: (g+8, 2q+1)
// ldmatrix (no .trans) hands lane (g, q) elements 2q, 2q+1 of row g of
// each 8x8 tile, so a tile whose rows are the m (or n) index and whose 8
// contiguous elements are k gives an A (or B) register directly; with
// .trans it hands elements (rows 2q, 2q+1; column g), so a tile stored with
// rows = k gives a B register. Lanes 8i .. 8i+7 pass the row addresses of
// tile i. Two adjacent C tiles (n 0-7, 8-15) of one m16 row block, packed
// to bf16, are the A fragment of a product over those 16 n as k:
//   a0 = pack(C0.c0, C0.c1), a1 = pack(C0.c2, C0.c3),
//   a2 = pack(C1.c0, C1.c1), a3 = pack(C1.c2, C1.c3).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Rows of NC 16-byte chunks (8 bf16 each): the chunk index XOR the row's
// position within a 128-byte span (rows of 128 bytes or more: the row
// index mod 8), so the 8 rows an ldmatrix tile reads (consecutive rows,
// same chunk) fall in 8 different bank groups. Returns the 16-byte unit of
// (row, chunk).
template <int NC>
__device__ __forceinline__ int swz(int row, int chunk) {
  static_assert(NC == 2 || NC == 4 || NC == 8 || NC == 16,
                "2, 4, 8 or 16 chunks a row");
  constexpr int kSpan = NC < 8 ? 8 / NC : 1;  // rows a 128-byte span
  constexpr int kMod = NC < 8 ? NC : 8;
  return row * NC + (chunk ^ ((row / kSpan) % kMod));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b on a 16x8x16 tile, bf16 in, f32 sums.
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two f32 rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// 2^x on the special-function unit (one MUFU op; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Asynchronous copies global -> shared of 16, 8 or 4 bytes; `bytes` of
// them are read and the rest zero-filled (0: a zero fill, src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint32_t bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// out[j] = T(sum_{p = 0 .. P-1} part[p * M + j]), in that order; T is
// bf16 (rounded to nearest even) or f32.
template <typename T>
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    T* __restrict__ out, int P, long long M) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < M;
       j += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += part[(long long)p * M + j];
    if constexpr (std::is_same<T, float>::value) {
      out[j] = s;
    } else {
      out[j] = __float2bfloat16_rn(s);
    }
  }
}

template <typename T>
inline cudaError_t sum_partials(const float* part, T* out, int P,
                                long long M, cudaStream_t st) {
  const long long blocks = (M + 255) / 256;
  sum_partials_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                           st>>>(part, out, P, M);
  return cudaGetLastError();
}

}  // namespace tc
