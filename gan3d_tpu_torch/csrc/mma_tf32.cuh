// 3xTF32 building blocks for the f32 kernels of pooled_attention.cu,
// conv3d_k3.cu and conv3d_toeplitz.cu (the *_tf32x3 kernels), for sm_90a:
// the split of an f32 value into two TF32
// halves, the m16n8k8 TF32 product with f32 sums, the three products that
// give an f32-accurate a b, and a swizzle of f32 tiles in shared memory
// that keeps their fragment reads free of bank conflicts.
//
// 3xTF32. TF32 keeps 10 stored mantissa bits (11 significant), so one
// TF32 product is good to about 2^-11, outside the f32 route's 1e-4. Each
// f32 operand x is split as hi = rna(x), lo = rna(x - hi), where rna
// rounds to TF32 to nearest, ties away from zero (cvt.rna.tf32.f32's
// rounding); x - hi is exact in f32, and |x - (hi + lo)| <= 2^-21 |x|.
// Then
//   a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi
// (the a_lo b_lo term, ~2^-22 of a b, is dropped), each product exact in
// the tensor core and every sum f32: about 21 significant bits a product,
// the f32 contract of the route (utils/platform.py turns plain TF32 off).
//
// Fragments (PTX ISA, mma.m16n8k8 .row.col .tf32), g = lane / 4, q = lane
// % 4, one 32-bit value a register:
//   A (16 x 8)  a0: (g, q)  a1: (g+8, q)  a2: (g, q+4)  a3: (g+8, q+4)
//   B (8 x 8)   b0: (k q, n g)  b1: (k q+4, n g)
//   C (16 x 8)  c0: (g, 2q)  c1: (g, 2q+1)  c2: (g+8, 2q)  c3: (g+8, 2q+1)
// A product sums over k, so the kernels are free to permute k as long as
// A and B agree: they map k index q to column 2q and q + 4 to 2q + 1 of
// each 8-wide k step. Then a lane's two A values of a row are adjacent in
// memory (one 64-bit read), and a C tile (columns 2q, 2q+1 of rows g, g+8)
// is, unchanged, the A fragment of a product over its 8 columns as k:
//   a0 = c0, a1 = c2, a2 = c1, a3 = c3.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// x rounded to TF32 to nearest, ties away from zero, its 13 low bits zero:
// the rounding of cvt.rna.tf32.f32, bit for bit on every non-NaN x, done
// on the bit pattern in two integer ops (add half a TF32 ulp to the
// magnitude, clear the 13 low bits; a carry moves into the exponent as
// rounding up should, and infinity stays infinity) rather than on the
// conversion unit.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x ~ hi + lo, both TF32 (header).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// x ~ hi + lo with hi x truncated to TF32 (its 13 low bits cleared: one
// logic op where rounding takes two) and lo = rna(x - hi), x - hi exact:
// |x - (hi + lo)| <= 2^-21 |x| as for split_tf32, though |lo| reaches
// 2^-10 |x| (split_tf32: 2^-11), so the dropped a_lo b_lo term is up to 4x
// split_tf32's. For the kernels that split every streamed value of both
// operands where a warp reads it (dw_tf32x3).
__device__ __forceinline__ void split_tf32_trunc(uint32_t x, uint32_t& hi,
                                                 uint32_t& lo) {
  hi = x & 0xffffe000u;
  lo = tf32_rna(__uint_as_float(x) - __uint_as_float(hi));
}

// d += a b on a 16x8x8 tile, TF32 in, f32 sums.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32 (header): the two small terms first.
__device__ __forceinline__ void mma3(float* d, const uint32_t* ah,
                                     const uint32_t* al, const uint32_t* bh,
                                     const uint32_t* bl) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// An f32 tile of rows of NC 32-byte chunks (8 floats each) in shared
// memory: the 32-byte unit that holds chunk `chunk` of row `row`. Two
// reads must be free of bank conflicts (4 units of 32 bytes cover the 32
// banks): a row-major fragment read, rows r..r+3 (r a multiple of 4) at
// one chunk, and a column read, rows r, r+2, r+4, r+6 (r even) at one
// chunk. Every 128-byte line has its 4 units permuted by XOR so that each
// of those row sets lands on 4 different units of the line.
template <int NC>
__device__ __forceinline__ int swz32(int row, int chunk) {
  static_assert(NC == 1 || NC == 2 || NC == 4 || NC == 8 || NC == 16,
                "1, 2, 4, 8 or 16 chunks a row");
  if constexpr (NC == 1) {  // 4 rows a line
    return (row & ~3) | ((row & 3) ^ ((row >> 2) & 1));
  } else if constexpr (NC == 2) {  // 2 rows a line
    const int line = row >> 1;
    return line * 4 + ((((row & 1) << 1) | chunk) ^ (line & 3));
  } else {  // a row spans whole lines
    return row * NC + (chunk ^ ((row ^ (row >> 2)) & 3));
  }
}

// Offset (floats) of element (row, col) of a swizzled [rows][C] f32 tile.
template <int C>
__device__ __forceinline__ int f32_at(int row, int col) {
  return swz32<C / 8>(row, col >> 3) * 8 + (col & 7);
}

}  // namespace tc
