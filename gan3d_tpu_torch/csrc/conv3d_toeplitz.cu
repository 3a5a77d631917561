// The direct k3/s1/p1 convolution in the JAX op's channels-last layout,
// for Hopper (sm_90a): x [N, D, H, W, Ci], w [3, 3, 3, Ci, Co] (DHWIO),
//
//   out[n, d, h, w, co] = sum_{a, b, c, ci} w[a, b, c, ci, co]
//                                          x[n, d+a-1, h+b-1, w+c-1, ci]
//
// (positions outside the volume read as zero), out [N, D, H, W, Co].
// Replaces the TPU kernel _kernel, gan3d_tpu/ops/pallas_conv.py:77
// (pallas_call :127), the W-Toeplitz direct conv; its custom VJP uses it for
// the forward and, with w flipped in space and Ci/Co swapped, for dx
// (pallas_conv.py:172-176).
//
// What bounds it on this card. 2*N*D*H*W*Ci*Co*27 operations on
// N*D*H*W*(Ci+Co) activations: at 32ch@64^3, N=16, 232 GFLOP, 0.235 ms of
// bf16 tensor-core work (989 TF) or 1.41 ms of f32-accurate products
// (3xTF32's 165 TF), against 0.080 ms for the bf16 bytes at 3.35 TB/s
// (0.16 ms in f32). The arithmetic bounds it.
//
// What the TPU kernel did and what this one does instead. The TPU kernel
// read a pre-tiled, pre-padded copy of x in HBM (tile_input, ~1.5x the
// input's bytes) and a Toeplitz weight B that is (T+2)/3 times larger than
// w and mostly zeros, so that each of its 9 per-slab matmuls fed all 128
// MXU lanes; it double-buffered a 3-row slab by manual DMA. On Hopper none
// of that is needed: both routes are implicit GEMMs on the tensor cores
// that read x as it is, staging a halo box of it (masked to zero at the
// volume's edge: no padded copy) with the weights in a repacked layout,
// so a tap's shift is a row offset into the box; see their comments:
// - bf16: toeplitz_tc_kernel, mma.sync m16n8k16, bf16 operands, f32 sums
//   (the TPU kernel's rounding, pallas_conv.py:105-112).
// - f32: toeplitz_tf32x3_kernel, mma.sync m16n8k8 in 3xTF32 (mma_tf32.cuh):
//   each f32 operand split into two TF32 halves and three products a term,
//   ~21 significant bits a product, so the route keeps its f32 contract
//   (1e-4 of the largest value; plain TF32 would not), at 165 TF of
//   f32-accurate products where the FMA pipes give 67.
// W is tiled by the kernels' own rule; the TPU's tile T only has to divide
// W and is checked by the caller.
//
// Inputs are f32 (toeplitz_tf32x3) or bf16 (toeplitz_tc), the same for x
// and w; accumulation is f32; out takes x's dtype. Any N, D, H, W, Ci,
// Co >= 1; ragged tiles are masked. The tilings are chosen by the caller
// (gan3d_tpu_torch/ops/cuda_conv.py: toeplitz_x3_plan, toeplitz_tc_plan).
// Each entry point returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kMaxSmem = 227 * 1024;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// toeplitz_tc: the bf16 route, an implicit GEMM on the tensor cores. Per
// (n, d) out[pos, co] = sum_{tap, ci} x[pos + shift(tap), ci] w[tap, ci, co]
// is a GEMM with M = positions, N = Co, K = 27 * Ci.
//
// grid (N * D * row tiles * column tiles, Co tiles of BN = 32 * WN), 8
// warps. A block owns bh rows x bw columns of one (n, d) (at most
// 64 * (8 / WN) positions, numbered w fastest) and BN output channels;
// warp (wp, wn) computes 64 positions x 32 channels (4 x 4 m16n8 tiles,
// 64 f32 sums a thread). Per stage of 16 input channels:
// - xs [3][bh+2][bw+2][16] bf16: the halo box of the three input planes
//   d-1 .. d+1, channels innermost as x already is in NDHWC: each row's
//   two 16-byte chunks arrive by cp.async, zero-filled outside the volume
//   (no padded copy). An A fragment (16 positions x 16 channels) is one
//   ldmatrix.x4 of halo rows, each lane passing its own position's row,
//   so a tap's shift is a row offset: no im2col.
// - ws [27][BN][16] bf16: the stage's weights, copied from wp
//   [Ci/16][27][Cop][16] (toeplitz_repack_kernel, once a call; zero where
//   ci >= Ci or co >= Co); a B fragment pair is one ldmatrix.x4.
// Rows are 32 bytes, swizzled (tc::swz<2>) so every ldmatrix is free of
// bank conflicts. Where Ci is not a multiple of 8 (or x is not 16-byte
// aligned) the chunks are not whole 16-byte units, and xs is filled by
// two-byte loads instead (kVec false). A block waits for each stage's
// copies before its products; two blocks share an SM (one buffer each,
// under 113 KB, and at most 128 registers a thread), so one block's copies
// overlap the other's products (two buffers in one block would leave room
// for one block an SM). The C fragments' rows are positions and their
// columns channels, so they store straight into NDHWC out.
constexpr int kTcThreads = 256;
constexpr int kTcCi = 16;      // input channels per stage: one k-step a tap
constexpr int kTcCoPad = 64;   // wp's Co is padded to a multiple of this

struct TcGeom {
  int N, D, H, W, Ci, Co;
  int bh, bw, nbh, nbw;
};

// n / d for small non-negative n (< 2^22), exactly, as a float product
// with d's reciprocal (a run-time integer division takes ~20 instructions).
__device__ __forceinline__ int fdiv(int n, float inv) {
  return __float2int_rz(__fmul_rn(__fadd_rn((float)n, 0.5f), inv));
}

template <int WN, bool kVec>
__global__ void __launch_bounds__(kTcThreads, 2)
toeplitz_tc_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ wp,
                   __nv_bfloat16* __restrict__ out, TcGeom g) {
  constexpr int BN = 32 * WN;
  extern __shared__ uint4 smem_tc[];
  const int HB = g.bh + 2, WB = g.bw + 2;
  const int R = 3 * HB * WB;           // halo rows
  uint4* xs = smem_tc;             // [R] rows of 2 chunks
  uint4* ws = smem_tc + 2 * R;     // [27 * BN] rows of 2 chunks
  const float inv_WB = 1.f / WB, inv_HB = 1.f / HB, inv_bw = 1.f / g.bw;

  int b = blockIdx.x;
  const int bwi = b % g.nbw; b /= g.nbw;
  const int bhi = b % g.nbh; b /= g.nbh;
  const int d = b % g.D;
  const int n = b / g.D;
  const int h0 = bhi * g.bh, w0 = bwi * g.bw;
  const int co0 = blockIdx.y * BN;
  const int box = g.bh * g.bw;
  const int nstage = cdiv(g.Ci, kTcCi);
  const int Cop = cdiv(g.Co, kTcCoPad) * kTcCoPad;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int wn = warp % WN, wpos = (warp / WN) * 64;
  const bool active = wpos < box;   // warp has positions in the block

  // halo row (tap (0, 0, 0)) of the position each lane addresses in m
  // tile mt; positions past the block read row 0 and are not stored
  int hb[4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int pos = wpos + mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
    const int hl = fdiv(pos, inv_bw), wl = pos - hl * g.bw;
    hb[mt] = pos < box ? hl * WB + wl : 0;
  }

  const uint16_t* xu = reinterpret_cast<const uint16_t*>(x);
  auto load = [&](int c) {
    for (int i = t; i < 27 * BN * 2; i += kTcThreads) {
      const int half = i & 1, row = i >> 1;   // row = tap * BN + co
      const int tap = row / BN, co = row % BN;
      tc::cp_async16(ws + tc::swz<2>(row, half),
                     wp + ((((long long)c * 27 + tap) * Cop + co0 + co) *
                               kTcCi + half * 8));
    }
    for (int i = t; i < (kVec ? 2 * R : R); i += kTcThreads) {
      const int half = kVec ? (i & 1) : 0, hp = kVec ? i >> 1 : i;
      const int r = fdiv(hp, inv_WB), ww = hp - r * WB;
      const int a = fdiv(r, inv_HB), hh = r - a * HB;
      const int gd = d + a - 1, gh = h0 + hh - 1, gw = w0 + ww - 1;
      const bool in = gd >= 0 && gd < g.D && gh >= 0 && gh < g.H &&
                      gw >= 0 && gw < g.W;
      const long long pos =
          in ? ((((long long)n * g.D + gd) * g.H + gh) * g.W + gw) : 0;
      const int ci = c * kTcCi + half * 8;
      if (kVec) {
        tc::cp_async16(xs + tc::swz<2>(hp, half), x + pos * g.Ci + ci,
                       in && ci < g.Ci ? 16 : 0);
      } else {
        uint16_t h[kTcCi];
#pragma unroll
        for (int cl = 0; cl < kTcCi; ++cl)
          h[cl] = in && ci + cl < g.Ci ? xu[pos * g.Ci + ci + cl] : 0;
#pragma unroll
        for (int ch = 0; ch < 2; ++ch)
          xs[tc::swz<2>(hp, ch)] = make_uint4(
              tc::pack_raw(h[8 * ch], h[8 * ch + 1]),
              tc::pack_raw(h[8 * ch + 2], h[8 * ch + 3]),
              tc::pack_raw(h[8 * ch + 4], h[8 * ch + 5]),
              tc::pack_raw(h[8 * ch + 6], h[8 * ch + 7]));
      }
    }
    tc::cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int c = 0; c < nstage; ++c) {
    __syncthreads();   // the previous stage's products are done
    load(c);
    tc::cp_async_wait<0>();
    __syncthreads();   // stage c landed
    if (!active) continue;
#pragma unroll 1
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int k9 = 0; k9 < 9; ++k9) {
        const int kh = k9 / 3, kw = k9 % 3;
        const int tap = a * 9 + k9;
        const int toff = (a * HB + kh) * WB + kw;
        uint32_t bf[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          tc::ldsm_x4(bf[j], ws + tc::swz<2>(tap * BN + wn * 32 + j * 16 +
                                                 (lane >> 4) * 8 + (lane & 7),
                                             (lane >> 3) & 1));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t af[4];
          tc::ldsm_x4(af, xs + tc::swz<2>(hb[mt] + toff, lane >> 4));
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            tc::mma(acc[mt][2 * j], af, bf[j]);
            tc::mma(acc[mt][2 * j + 1], af, bf[j] + 2);
          }
        }
      }
    }
  }
  if (!active) return;

  const bool pair = g.Co % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int pos = wpos + mt * 16 + (lane >> 2) + e2 * 8;
      const int hl = fdiv(pos, inv_bw), wl = pos - hl * g.bw;
      const int h = h0 + hl, w = w0 + wl;
      if (pos >= box || h >= g.H || w >= g.W) continue;
      __nv_bfloat16* op =
          out + ((((long long)n * g.D + d) * g.H + h) * g.W + w) * g.Co;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = co0 + wn * 32 + nt * 8 + (lane & 3) * 2;
        const float v0 = acc[mt][nt][e2 * 2], v1 = acc[mt][nt][e2 * 2 + 1];
        if (pair && co + 1 < g.Co) {
          *reinterpret_cast<__nv_bfloat162*>(op + co) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (co < g.Co) op[co] = __float2bfloat16_rn(v0);
          if (co + 1 < g.Co) op[co + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// wp [Ci/16][27][Cop][16] from w [27, Ci, Co] (DHWIO, bf16), zero where
// ci >= Ci or co >= Co: the layout toeplitz_tc_kernel's weight stages copy
// from (ops/cuda_conv.py:repack_toeplitz_weight is its plain version).
__global__ void toeplitz_repack_kernel(const __nv_bfloat16* __restrict__ w,
                                       __nv_bfloat16* __restrict__ wp, int Ci,
                                       int Co, int Cop, long long total) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < total; j += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(j % kTcCi);
    long long r = j / kTcCi;
    const int co = (int)(r % Cop);
    r /= Cop;
    const int tap = (int)(r % 27), ci = (int)(r / 27) * kTcCi + i;
    wp[j] = co < Co && ci < Ci ? w[((long long)tap * Ci + ci) * Co + co]
                               : __float2bfloat16_rn(0.f);
  }
}

// ---------------------------------------------------------------------------
// toeplitz_tf32x3: the f32 route, the same implicit GEMM (M = positions,
// N = Co, K = 27 * Ci) in 3xTF32 on the tensor cores (mma.sync m16n8k8,
// mma_tf32.cuh: each product a_lo b_hi + a_hi b_lo + a_hi b_hi of TF32
// halves, f32 sums).
//
// grid (N * D * row tiles * column tiles, Co tiles of BN = 32 * WN, P
// split-K parts), 8 warps, toeplitz_tc's tiling: a block owns bh rows x
// bw columns of one (n, d) (at most 64 * (8 / WN) positions, w fastest)
// and BN output channels; warp (wp, wn) computes 64 positions x 32
// channels (4 x 4 m16n8 tiles, 64 f32 sums a thread). The part's chunks of
// 8 input channels are walked one input plane a (d - 1 .. d + 1) at a
// time; a step (chunk, a) stages, in f32:
// - xs [bh+2][bw+2][8]: the halo box of plane d + a - 1, channels
//   innermost as x already is in NDHWC: 16-byte cp.async units where Ci is
//   a multiple of 4 (kVec), else 4-byte ones, zero-filled outside the
//   volume (no padded copy). A lane's A values (its position, channels 2q
//   and 2q + 1: mma_tf32.cuh's k order) are one 64-bit read of the
//   position's row plus the tap's offset: no im2col.
// - ws [2][9][BN][8]: the hi and lo TF32 halves of the step's 9 taps'
//   weights, copied from wpx [2][Ci/8][27][Cop][8]
//   (toeplitz_repack_x3_kernel splits w once a call, so no warp splits B).
// 32-byte rows, read 4 rows a half-warp: free of bank conflicts. Both are
// double-buffered: step s + 1's copies are requested before step s's
// products run. The activations are split where a warp reads them (split
// once a step into shared memory, they came out 20% slower: PERF.md,
// section 6).
// Sum length: as in conv3d_k3.cu's wide_tf32x3, a part sums at most
// kX3Chunks chunks (1944 terms) in the tensor cores; longer sums are split
// into P parts whose f32 partials tc::sum_partials adds in a fixed order.
// The C fragments' rows are positions and their columns channels, so they
// store straight into NDHWC out (or the part's partials).
constexpr int kX3Threads = 256;  // 8 warps
constexpr int kX3Ci = 8;         // input channels a chunk: one k8 step a tap
constexpr int kX3CoPad = 64;     // wpx's Co is padded to a multiple of this
constexpr int kX3Chunks = 9;     // most chunks a part sums: 9 * 8 * 27 terms

template <int WN, bool kVec>
__global__ void __launch_bounds__(kX3Threads)
toeplitz_tf32x3_kernel(const float* __restrict__ x,
                       const float* __restrict__ wp, float* __restrict__ part,
                       float* __restrict__ out, TcGeom g, int P) {
  constexpr int BN = 32 * WN;
  constexpr int kWs = 2 * 9 * BN * kX3Ci;  // floats of one weight stage
  extern __shared__ float4 smem_x3[];
  const int HB = g.bh + 2, WB = g.bw + 2;
  const int R = HB * WB;                          // halo rows of one plane
  float* xs0 = reinterpret_cast<float*>(smem_x3);  // [2][R][8]
  float* ws0 = xs0 + 2 * R * kX3Ci;                // [2][kWs]
  const float inv_WB = 1.f / WB, inv_bw = 1.f / g.bw;

  int b = blockIdx.x;
  const int bwi = b % g.nbw; b /= g.nbw;
  const int bhi = b % g.nbh; b /= g.nbh;
  const int d = b % g.D;
  const int n = b / g.D;
  const int h0 = bhi * g.bh, w0 = bwi * g.bw;
  const int co0 = blockIdx.y * BN;
  const int p = blockIdx.z;
  const int box = g.bh * g.bw;
  const int nchunk = cdiv(g.Ci, kX3Ci);
  const int c_begin = nchunk * p / P, c_end = nchunk * (p + 1) / P;
  const int Cop = cdiv(g.Co, kX3CoPad) * kX3CoPad;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int wn = warp % WN, wpos = (warp / WN) * 64;
  const int gq = lane >> 2, q = lane & 3;
  const bool active = wpos < box;   // warp has positions in the block

  // halo row (tap (0, 0, 0)) of positions gq and gq + 8 of each m tile;
  // positions past the block read row 0 and are not stored
  int hb[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int pos = wpos + mt * 16 + gq + 8 * e2;
      const int hl = fdiv(pos, inv_bw), wl = pos - hl * g.bw;
      hb[mt][e2] = pos < box ? hl * WB + wl : 0;
    }

  // step s: chunk c_begin + s / 3, input plane d + s % 3 - 1
  auto load = [&](int s, int buf) {
    const int c = c_begin + s / 3, a = s % 3;
    float* xs = xs0 + buf * R * kX3Ci;
    float* ws = ws0 + buf * kWs;
    for (int i = t; i < 2 * 9 * BN * 2; i += kX3Threads) {
      const int half = i & 1, row = i >> 1;  // row = (plane * 9 + tap) * BN + co
      const int pt = row / BN, co = row % BN;
      const int pl = pt / 9, tap = pt - pl * 9;
      tc::cp_async16(ws + row * kX3Ci + half * 4,
                     wp + ((((long long)pl * nchunk + c) * 27 + a * 9 + tap) *
                               Cop + co0 + co) * kX3Ci + half * 4);
    }
    const int gd = d + a - 1;
    // an item: one 16-byte unit (kVec) or one value of a halo row
    constexpr int kPer = kVec ? 2 : kX3Ci;
    for (int i = t; i < R * kPer; i += kX3Threads) {
      const int hp = i / kPer, k = i % kPer;
      const int r = fdiv(hp, inv_WB), ww = hp - r * WB;
      const int gh = h0 + r - 1, gw = w0 + ww - 1;
      const int ci = c * kX3Ci + (kVec ? 4 * k : k);
      const bool ok = ci < g.Ci && gd >= 0 && gd < g.D && gh >= 0 &&
                      gh < g.H && gw >= 0 && gw < g.W;
      const float* src =
          ok ? x + ((((long long)n * g.D + gd) * g.H + gh) * g.W + gw) * g.Ci +
                   ci
             : x;
      float* dst = xs + hp * kX3Ci + (kVec ? 4 * k : k);
      if (kVec)
        tc::cp_async16(dst, src, ok ? 16 : 0);
      else
        tc::cp_async4(dst, src, ok ? 4 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int steps = 3 * (c_end - c_begin);
  load(0, 0);
  tc::cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    tc::cp_async_wait<0>();
    __syncthreads();  // step s landed; step s - 1's buffers are free
    if (s + 1 < steps) {
      load(s + 1, (s + 1) & 1);  // in flight during this step's products
      tc::cp_async_commit();
    }
    const float* xs = xs0 + (s & 1) * R * kX3Ci;
    const float* ws = ws0 + (s & 1) * kWs;
    if (!active) continue;
    const float* wl = ws + 9 * BN * kX3Ci;
#pragma unroll 1
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int tap = kh * 3 + kw, toff = kh * WB + kw;
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int r = (tap * BN + wn * 32 + nt * 8 + gq) * kX3Ci + 2 * q;
          const uint2 h = *reinterpret_cast<const uint2*>(ws + r);
          const uint2 l = *reinterpret_cast<const uint2*>(wl + r);
          bh[nt][0] = h.x; bh[nt][1] = h.y;
          bl[nt][0] = l.x; bl[nt][1] = l.y;
        }
        // x split where read; then the products in three passes over the
        // 16 tiles (each tile's sums in mma3's order), so 16 independent
        // sums are in flight rather than mma3's chain of three on one
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int e0 = (hb[mt][0] + toff) * kX3Ci + 2 * q;
          const int e1 = (hb[mt][1] + toff) * kX3Ci + 2 * q;
          const float2 x0 = *reinterpret_cast<const float2*>(xs + e0);
          const float2 x1 = *reinterpret_cast<const float2*>(xs + e1);
          tc::split_tf32(x0.x, ah[mt][0], al[mt][0]);
          tc::split_tf32(x1.x, ah[mt][1], al[mt][1]);
          tc::split_tf32(x0.y, ah[mt][2], al[mt][2]);
          tc::split_tf32(x1.y, ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            tc::mma_tf32(acc[mt][nt], al[mt], bh[nt]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            tc::mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            tc::mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
      }
    }
  }
  if (!active) return;

  const bool pair = g.Co % 2 == 0;
  float* dst = P == 1 ? out
                      : part + p * ((long long)g.N * g.D * g.H * g.W * g.Co);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int pos = wpos + mt * 16 + gq + e2 * 8;
      const int hl = fdiv(pos, inv_bw), wl = pos - hl * g.bw;
      const int h = h0 + hl, w = w0 + wl;
      if (pos >= box || h >= g.H || w >= g.W) continue;
      float* op = dst + ((((long long)n * g.D + d) * g.H + h) * g.W + w) * g.Co;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = co0 + wn * 32 + nt * 8 + 2 * q;
        const float v0 = acc[mt][nt][e2 * 2], v1 = acc[mt][nt][e2 * 2 + 1];
        if (pair && co + 1 < g.Co) {
          *reinterpret_cast<float2*>(op + co) = make_float2(v0, v1);
        } else {
          if (co < g.Co) op[co] = v0;
          if (co + 1 < g.Co) op[co + 1] = v1;
        }
      }
    }
  }
}

// wpx [2][Ci/8][27][Cop][8] from w [27, Ci, Co] (DHWIO, f32): plane 0 the
// hi TF32 halves, plane 1 the lo (tc::split_tf32), zero where ci >= Ci or
// co >= Co: the layout toeplitz_tf32x3_kernel's weight stages copy from
// (ops/cuda_conv.py:repack_toeplitz_weight_x3 is its plain version).
__global__ void toeplitz_repack_x3_kernel(const float* __restrict__ w,
                                          float* __restrict__ wp, int Ci,
                                          int Co, int Cop, long long total) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < total; j += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(j % kX3Ci);
    long long r = j / kX3Ci;
    const int co = (int)(r % Cop);
    r /= Cop;
    const int tap = (int)(r % 27), ci = (int)(r / 27) * kX3Ci + i;
    const float v =
        co < Co && ci < Ci ? w[((long long)tap * Ci + ci) * Co + co] : 0.f;
    uint32_t hi, lo;
    tc::split_tf32(v, hi, lo);
    wp[j] = __uint_as_float(hi);
    wp[total + j] = __uint_as_float(lo);
  }
}

int launch_x3(const void* x, const void* wp, void* part, void* out,
              const TcGeom& g, int wn, int P, cudaStream_t st) {
  const int nchunk = cdiv(g.Ci, kX3Ci);
  const long long blocks = (long long)g.N * g.D * g.nbh * g.nbw;
  const int co_tiles = cdiv(g.Co, 32 * wn);
  // P within the chunks, and no part summing more than kX3Chunks of them
  if ((wn != 1 && wn != 2) || g.bh * g.bw > 64 * (8 / wn) || P > nchunk ||
      P < cdiv(nchunk, kX3Chunks) || P > 65535 || blocks > 0x7fffffffLL ||
      co_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t rows = (size_t)(g.bh + 2) * (g.bw + 2);
  const size_t smem =
      sizeof(float) * kX3Ci * (2 * rows + (size_t)2 * 2 * 9 * 32 * wn);
  const bool vec = g.Ci % 4 == 0 && (uintptr_t)x % 16 == 0;
  const dim3 grid((unsigned)blocks, co_tiles, P);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(wp);
  auto* of = static_cast<float*>(out);
  float* pf = static_cast<float*>(part);
  auto run = [&](auto kernel) {
    if (smem > (size_t)kMaxSmem) return false;
    if (smem > 48 * 1024 &&
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess)
      return false;
    kernel<<<grid, kX3Threads, smem, st>>>(xf, wf, pf, of, g, P);
    return true;
  };
  auto by_wn = [&](auto k1, auto k2) { return wn == 1 ? run(k1) : run(k2); };
  const bool ok = vec ? by_wn(toeplitz_tf32x3_kernel<1, true>,
                              toeplitz_tf32x3_kernel<2, true>)
                      : by_wn(toeplitz_tf32x3_kernel<1, false>,
                              toeplitz_tf32x3_kernel<2, false>);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || P == 1) return (int)err;
  return (int)tc::sum_partials(
      pf, of, P, (long long)g.N * g.D * g.H * g.W * g.Co, st);
}

int launch_tc(const void* x, const void* wp, void* out, const TcGeom& g,
              int wn, cudaStream_t st) {
  if ((wn != 1 && wn != 2) || g.bh * g.bw > 64 * (8 / wn))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)g.N * g.D * g.nbh * g.nbw;
  const int co_tiles = cdiv(g.Co, 32 * wn);
  if (blocks > 0x7fffffffLL || co_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const int rows = 3 * (g.bh + 2) * (g.bw + 2);
  const size_t smem = 32 * ((size_t)rows + 27 * 32 * wn);
  const bool vec = g.Ci % 8 == 0 && (uintptr_t)x % 16 == 0;
  const dim3 grid((unsigned)blocks, co_tiles);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(wp);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto run = [&](auto kernel) {
    if (smem > (size_t)kMaxSmem) return false;
    if (smem > 48 * 1024 &&
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess)
      return false;
    kernel<<<grid, kTcThreads, smem, st>>>(xb, wb, ob, g);
    return true;
  };
  const bool ok = wn == 1 ? (vec ? run(toeplitz_tc_kernel<1, true>)
                                 : run(toeplitz_tc_kernel<1, false>))
                          : (vec ? run(toeplitz_tc_kernel<2, true>)
                                 : run(toeplitz_tc_kernel<2, false>));
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// wpx [2][Ci/8][27][Cop][8] f32 (Cop = Co rounded up to 64) from w
// [3, 3, 3, Ci, Co] f32: the f32 route's weight layout, split into its hi
// and lo TF32 halves.
int k3_toeplitz_repack_x3(const void* w, void* wp, int Ci, int Co,
                          void* stream) {
  if (Ci < 1 || Co < 1) return (int)cudaErrorInvalidValue;
  const int Cop = cdiv(Co, kX3CoPad) * kX3CoPad;
  const long long total = (long long)cdiv(Ci, kX3Ci) * 27 * Cop * kX3Ci;
  const long long blocks = (total + 255) / 256;
  toeplitz_repack_x3_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256,
                              0, (cudaStream_t)stream>>>(
      static_cast<const float*>(w), static_cast<float*>(wp), Ci, Co, Cop,
      total);
  return (int)cudaGetLastError();
}

// The f32 route: out [N, D, H, W, Co] f32 from x [N, D, H, W, Ci] f32 and
// wpx [2][Ci/8][27][Cop][8] (the split weight); part [P, N, D, H, W, Co]
// f32 is scratch when P > 1. Tiling (bh, bw, wn, P) as chosen by
// ops/cuda_conv.py:toeplitz_x3_plan.
int k3_toeplitz_x3(const void* x, const void* wp, void* part, void* out,
                   int N, int D, int H, int W, int Ci, int Co, int bh, int bw,
                   int wn, int P, void* stream) {
  if (N < 1 || D < 1 || H < 1 || W < 1 || Ci < 1 || Co < 1 || bh < 1 ||
      bw < 1)
    return (int)cudaErrorInvalidValue;
  const TcGeom g{N, D, H, W, Ci, Co, bh, bw, cdiv(H, bh), cdiv(W, bw)};
  return launch_x3(x, wp, part, out, g, wn, P, (cudaStream_t)stream);
}

// wp [Ci/16][27][Cop][16] bf16 (Cop = Co rounded up to 64) from w
// [3, 3, 3, Ci, Co] bf16: the bf16 route's weight layout.
int k3_toeplitz_repack(const void* w, void* wp, int Ci, int Co,
                       void* stream) {
  if (Ci < 1 || Co < 1) return (int)cudaErrorInvalidValue;
  const int Cop = cdiv(Co, kTcCoPad) * kTcCoPad;
  const long long total = (long long)cdiv(Ci, kTcCi) * 27 * Cop * kTcCi;
  const long long blocks = (total + 255) / 256;
  toeplitz_repack_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                           (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wp),
      Ci, Co, Cop, total);
  return (int)cudaGetLastError();
}

// The bf16 route: out [N, D, H, W, Co] bf16 from x [N, D, H, W, Ci] bf16
// and wp [Ci/16][27][Cop][16] bf16 (the repacked weight); tiling (bh, bw,
// wn) as chosen by ops/cuda_conv.py:toeplitz_tc_plan.
int k3_toeplitz_tc(const void* x, const void* wp, void* out, int N, int D,
                   int H, int W, int Ci, int Co, int bh, int bw, int wn,
                   void* stream) {
  if (N < 1 || D < 1 || H < 1 || W < 1 || Ci < 1 || Co < 1 || bh < 1 ||
      bw < 1)
    return (int)cudaErrorInvalidValue;
  const TcGeom g{N, D, H, W, Ci, Co, bh, bw, cdiv(H, bh), cdiv(W, bw)};
  return launch_tc(x, wp, out, g, wn, (cudaStream_t)stream);
}

}  // extern "C"
