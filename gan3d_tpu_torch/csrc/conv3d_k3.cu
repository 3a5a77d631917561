// The k3/s1/p1 convolution of the BigGAN-Deep bottleneck, forward/dx and
// weight gradient, for Hopper (sm_90a). NCDHW activations, weights in
// torch's [Co, Ci, 3, 3, 3] layout, tap = kd*9 + kh*3 + kw.
//
//   wide:  out[n, co, s] = sum_{ci, tap} w[co, ci, tap] x[n, ci, s + tap - 1]
//   dW:    dw[co, ci, tap] = sum_{n, s} g[n, co, s] x[n, ci, s + tap - 1]
//
// (positions outside the volume read as zero). Replaces the TPU kernels
//   wide -> _wide_kernel, gan3d_tpu/ops/wide_conv.py:102 (pallas_call :152),
//           used for the forward and, with w flipped in space and in/out
//           swapped, for dx (wide_conv.py:200-205);
//   dW   -> _dw_kernel, gan3d_tpu/ops/dw_conv.py:133 (pallas_call :181).
//
// What bounds them on this card. Both do 2*N*S*Ci*27*Co operations on
// N*S*(Ci+Co) activations: 54*Ci*Co/(Ci+Co) operations per element, ~860
// per byte for bf16 at 32 channels, ~3.5k at 128. That is far above the
// H100's ~295 operations per byte of bf16 tensor-core work per HBM byte,
// so the arithmetic bounds them, not memory (0.235 ms of bf16 tensor-core
// work at 32ch@64^3, N=16, against 0.16 ms of bytes; in f32, 1.41 ms of
// f32-accurate products at 3xTF32's 165 TF against 0.32 ms of bytes).
//
// What the designs do about it. The wide conv has two routes, picked by
// dtype in ops/cuda_conv.py, one implicit GEMM on the tensor cores:
// - wide_tc (bf16): mma.sync m16n8k16, bf16 operands, f32 sums: the TPU
//   kernel's rounding, wide_conv.py:140-141,186; see its comment below.
// - wide_tf32x3 (f32): mma.sync m16n8k8 in 3xTF32 (mma_tf32.cuh): each f32
//   operand split into two TF32 halves and three products a term, ~21
//   significant bits a product against TF32's 11, so the route keeps its
//   f32 contract (1e-4 of the largest value; plain TF32 would not), at
//   165 TF of f32-accurate products where the FMA pipes give 67; see its
//   comment below.
// dW has two routes the same way, one implicit GEMM with the positions as
// its k:
// - dw_tc (bf16): bf16 operands, f32 sums (the TPU kernel's rounding,
//   dw_conv.py:157-158); see its comment below.
// - dw_tf32x3 (f32): the same GEMM in 3xTF32, both operands split where a
//   warp reads them; see its comment below.
// Neither the wide conv nor dW pads or transposes x in device memory, as
// the TPU path's jnp.pad and transposes did (wide_conv.py:183-187): a
// block stages a box of x with its 1-voxel halo, masked to zero at the
// volume's edge.
// - dW: the TPU accumulated dW in one f32 block revisited across its
//   sequential (N, D/dD) grid (dw_conv.py:161-167); on CUDA that is a
//   race. Here the (n, box) list is split into P chunks (split-K): a block
//   reduces one chunk for 32 output x 16 input channels x 27 taps and
//   writes f32 partials; a second kernel sums the P partials in a fixed
//   order. No atomics, so a repeated dW is bit-identical.
//
// Inputs: wide_tf32x3 and dw_tf32x3 f32, wide_tc and dw_tc bf16, the same for
// both operands; every accumulation is f32; the wide output takes the input's
// dtype, dW is f32 on both routes.
// Any N, Ci, Co, D, H, W >= 1; ragged channel and spatial tiles are masked.
// The tiling is chosen by the caller (gan3d_tpu_torch/ops/cuda_conv.py).
// Each entry point returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kDwCo = 32;    // dW f32: output channels per block
constexpr int kDwCi = 16;    // dW f32: input channels per block
constexpr int kReduceThreads = 256;
constexpr int kMaxSmem = 227 * 1024;

// A box of td x th x tw positions of one sample; boxes are numbered
// (n, bd, bh, bw), bw fastest.
struct Geom {
  int N, Ci, Co, D, H, W;
  int td, th, tw;
  int nbd, nbh, nbw;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// wide_tc: the bf16 route of the wide conv, an implicit GEMM on the tensor
// cores. Per sample out[co, s] = sum_{tap, ci} W[co, ci, tap] x[ci, s+tap-1]
// is a GEMM with M = Co, N = positions, K = 27 * Ci.
//
// grid (boxes, Co tiles of BM, P split-K parts), 4 warps. A block owns a
// td x th x tw box of one sample (at most BN positions, numbered w
// fastest) and BM = 32 * WM output channels; warp (wm, wn) computes 32
// channels x 64 positions (2 x 8 m16n8 tiles, 64 f32 sums a thread).
// Per stage of 16 input channels (the part's share of the Ci/16 chunks):
// - xs [halo rows][16] bf16: the box's input plus its masked 1-voxel halo,
//   channels innermost. A B fragment (8 positions x 16 channels) is one
//   ldmatrix of 8 halo rows, each lane passing its own position's row, so
//   a tap's shift is only a row offset: no im2col, nothing padded or
//   transposed in device memory.
// - ws [27][BM][16] bf16: the stage's weights, copied with cp.async from
//   the repacked wp [Ci/16][27][Cop][16] (repack_kernel, once a call;
//   zero where ci >= Ci or co >= Co), one ldmatrix.x4 per A fragment.
// Rows are 32 bytes, swizzled (tc::swz<2>) so every ldmatrix is free of
// bank conflicts. xs is filled one of two ways:
// - staged (kVec; needs W and tw multiples of 4): the stage's raw NCDHW
//   rows (w0-4 .. w0+tw+3, 16 channels) arrive by 8-byte cp.async,
//   zero-filled outside the volume, in a staging buffer; after they land
//   they are transposed shared-to-shared into xs, and the next stage's
//   rows are requested before this stage's products run, so their latency
//   hides behind the tensor cores (at the cost of the buffer's shared
//   memory: 2 blocks an SM instead of 3).
// - direct: 16 two-byte loads a halo position, coalesced along w,
//   transposed through registers.
// The staging's index work is done once per halo row or position, for all
// 16 channels, with float-reciprocal divisions (fdiv).
// With P > 1 each part writes f32 partials [P, N, Co, S] summed in a fixed
// order by tc::sum_partials (no atomics); else the block writes bf16
// directly. Positions past the box or the volume are computed on clamped
// rows and not stored.
constexpr int kTcThreads = 128;
constexpr int kTcCi = 16;      // input channels per stage: one k-step a tap
constexpr int kTcCoPad = 64;   // wp's Co is padded to a multiple of this

// n / d for the small block-local indices here (n + d < 2^22), as a float
// product with d's reciprocal: 3 instructions where an integer division by
// a value known only at run time takes ~20 (the index work of the staging
// loops rivals the products otherwise). Exact: (n + 0.5) / d is at least
// 0.5 / d from an integer, far above the product's rounding error;
// __fadd_rn / __fmul_rn keep the compiler from fusing it into an FMA.
__device__ __forceinline__ int fdiv(int n, float inv) {
  return __float2int_rz(__fmul_rn(__fadd_rn((float)n, 0.5f), inv));
}

// Shape of a block's staging: halo rows (dd, hh, ww), raw rows of the
// staged path ((tw + 8) values from w0 - 4), and reciprocals for fdiv.
struct TcBox {
  int HB, WB, plane, R;  // halo: (td+2) x HB x WB = R rows
  int RW, cs, U;         // raw: values a row; values a channel; 8-byte units
  float inv_WB, inv_HB, inv_U, inv_tw, inv_th;
};

__device__ __forceinline__ TcBox tc_box(const Geom& g) {
  TcBox b;
  b.HB = g.th + 2;
  b.WB = g.tw + 2;
  b.plane = b.HB * b.WB;
  b.R = (g.td + 2) * b.plane;
  b.RW = g.tw + 8;
  b.cs = (g.td + 2) * b.HB * b.RW;
  b.U = b.RW / 4;
  b.inv_WB = 1.f / b.WB;
  b.inv_HB = 1.f / b.HB;
  b.inv_U = 1.f / b.U;
  b.inv_tw = 1.f / g.tw;
  b.inv_th = 1.f / g.th;
  return b;
}

// Box position p (w fastest) -> (dl, hl, wl).
__device__ __forceinline__ void box_pos(int p, const Geom& g, const TcBox& b,
                                        int* dl, int* hl, int* wl) {
  const int r = fdiv(p, b.inv_tw);
  *wl = p - r * g.tw;
  *dl = fdiv(r, b.inv_th);
  *hl = r - *dl * g.th;
}

// The 27 taps of one stage: acc += ws (this warp's 32 channels) x xs (its
// 64 positions, halo rows hb + the tap's offset).
template <int WM>
__device__ __forceinline__ void wide_tc_stage(float (*acc)[8][4],
                                              const uint4* xs,
                                              const uint4* ws, const int* hb,
                                              const TcBox& bx, int wm,
                                              int lane) {
  constexpr int BM = 32 * WM;
#pragma unroll 1
  for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
    for (int k9 = 0; k9 < 9; ++k9) {
      const int kh = k9 / 3, kw = k9 % 3;
      const int tap = kd * 9 + k9;
      const int toff = (kd * bx.HB + kh) * bx.WB + kw;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row =
            tap * BM + wm * 32 + mt * 16 + (lane % 8) + ((lane >> 3) & 1) * 8;
        tc::ldsm_x4(a[mt], ws + tc::swz<2>(row, lane >> 4));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bf[4];
        tc::ldsm_x4(bf, xs + tc::swz<2>(hb[j] + toff, (lane >> 3) & 1));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          tc::mma(acc[mt][2 * j], a[mt], bf);
          tc::mma(acc[mt][2 * j + 1], a[mt], bf + 2);
        }
      }
    }
  }
}

template <int WM, bool kVec>
__global__ void __launch_bounds__(kTcThreads, kVec ? 2 : 3)
wide_tc_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ wp, float* __restrict__ part,
               __nv_bfloat16* __restrict__ out, Geom g, int P) {
  constexpr int BM = 32 * WM;
  extern __shared__ uint4 smem_tc[];
  const TcBox bx = tc_box(g);
  uint4* xs = smem_tc;               // [R] rows of 2 chunks
  uint4* ws = smem_tc + 2 * bx.R;    // [27 * BM] rows of 2 chunks
  uint16_t* raw = reinterpret_cast<uint16_t*>(ws + 2 * 27 * BM);  // kVec

  int b = blockIdx.x;
  const int bw = b % g.nbw; b /= g.nbw;
  const int bh = b % g.nbh; b /= g.nbh;
  const int bd = b % g.nbd;
  const int n = b / g.nbd;
  const int d0 = bd * g.td, h0 = bh * g.th, w0 = bw * g.tw;
  const int co0 = blockIdx.y * BM;
  const int p = blockIdx.z;
  const int nchunk = cdiv(g.Ci, kTcCi);
  const int c_begin = nchunk * p / P, c_end = nchunk * (p + 1) / P;
  const int Cop = cdiv(g.Co, kTcCoPad) * kTcCoPad;
  const int box = g.td * g.th * g.tw;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int wm = warp % WM, wn = warp / WM;
  const bool active = wn * 64 < box;   // warp has positions in the box

  // halo row of the position each lane addresses in B tile pair j
  int hb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int pos = wn * 64 + (2 * j + lane / 16) * 8 + lane % 8;
    int dl, hl, wl;
    box_pos(pos, g, bx, &dl, &hl, &wl);
    hb[j] = pos < box ? (dl * bx.HB + hl) * bx.WB + wl : 0;
  }

  const long long HW = (long long)g.H * g.W;
  const long long DHW = HW * g.D;
  const uint16_t* xn =
      reinterpret_cast<const uint16_t*>(x) + (long long)n * g.Ci * DHW;

  // weights of stage c: 27 x BM rows of 32 bytes, contiguous per tap in wp
  auto load_weights = [&](int c) {
    for (int i = t; i < 27 * BM * 2; i += kTcThreads) {
      const int half = i & 1, row = i >> 1;  // row = tap * BM + co
      const int tap = row / BM, co = row % BM;
      tc::cp_async16(ws + tc::swz<2>(row, half),
                     wp + ((((long long)c * 27 + tap) * Cop + co0 + co) *
                               kTcCi + half * 8));
    }
  };
  // kVec: raw rows [ci 16][td+2][HB][RW] of stage c, zero outside; an
  // item is one 8-byte unit of one (dd, hh) row, for all 16 channels
  auto load_raw = [&](int c) {
    const int items = (g.td + 2) * bx.HB * bx.U;
    for (int i = t; i < items; i += kTcThreads) {
      const int r = fdiv(i, bx.inv_U), u = i - r * bx.U;
      const int dd = fdiv(r, bx.inv_HB), hh = r - dd * bx.HB;
      const int gd = d0 + dd - 1, gh = h0 + hh - 1, gw = w0 - 4 + 4 * u;
      const bool in = gd >= 0 && gd < g.D && gh >= 0 && gh < g.H &&
                      gw >= 0 && gw < g.W;
      const uint16_t* src =
          xn + c * kTcCi * DHW + (in ? gd * HW + (long long)gh * g.W + gw : 0);
      uint16_t* dst = raw + r * bx.RW + 4 * u;
#pragma unroll
      for (int cl = 0; cl < kTcCi; ++cl) {
        const bool ok = in && c * kTcCi + cl < g.Ci;
        tc::cp_async8(dst + cl * bx.cs, ok ? src + cl * DHW : xn, ok ? 8 : 0);
      }
    }
  };
  // xs row hp (both 8-channel chunks) from the raw rows (kVec) or straight
  // from x; an item is one halo position
  auto fill_xs = [&](int c) {
    for (int hp = t; hp < bx.R; hp += kTcThreads) {
      const int r = fdiv(hp, bx.inv_WB), ww = hp - r * bx.WB;  // r: (dd, hh)
      uint32_t v[8];
      if (kVec) {
        const uint16_t* src = raw + r * bx.RW + ww + 3;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = tc::pack_raw(src[2 * e * bx.cs], src[(2 * e + 1) * bx.cs]);
      } else {
        const int dd = fdiv(r, bx.inv_HB), hh = r - dd * bx.HB;
        const int gd = d0 + dd - 1, gh = h0 + hh - 1, gw = w0 + ww - 1;
        const bool in = gd >= 0 && gd < g.D && gh >= 0 && gh < g.H &&
                        gw >= 0 && gw < g.W;
        const uint16_t* src = xn + c * kTcCi * DHW +
                              (in ? gd * HW + (long long)gh * g.W + gw : 0);
        uint16_t h[kTcCi];
#pragma unroll
        for (int cl = 0; cl < kTcCi; ++cl)
          h[cl] = in && c * kTcCi + cl < g.Ci ? src[cl * DHW] : 0;
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = tc::pack_raw(h[2 * e], h[2 * e + 1]);
      }
      xs[tc::swz<2>(hp, 0)] = make_uint4(v[0], v[1], v[2], v[3]);
      xs[tc::swz<2>(hp, 1)] = make_uint4(v[4], v[5], v[6], v[7]);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  if (kVec) {
    load_raw(c_begin);
    load_weights(c_begin);
    tc::cp_async_commit();
    for (int c = c_begin; c < c_end; ++c) {
      tc::cp_async_wait<0>();
      __syncthreads();     // raw(c), ws(c) landed; xs free
      fill_xs(c);
      __syncthreads();     // xs ready; raw free
      if (c + 1 < c_end) {
        load_raw(c + 1);   // in flight during this stage's products
        tc::cp_async_commit();
      }
      if (active) wide_tc_stage<WM>(acc, xs, ws, hb, bx, wm, lane);
      if (c + 1 < c_end) {
        __syncthreads();   // ws and xs free
        load_weights(c + 1);
        tc::cp_async_commit();
      }
    }
  } else {
    for (int c = c_begin; c < c_end; ++c) {
      __syncthreads();
      load_weights(c);
      tc::cp_async_commit();
      fill_xs(c);
      tc::cp_async_wait<0>();
      __syncthreads();
      if (active) wide_tc_stage<WM>(acc, xs, ws, hb, bx, wm, lane);
    }
  }
  if (!active) return;

  const long long plane_out = (long long)g.N * g.Co * DHW;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      const int pos = wn * 64 + nt * 8 + (lane & 3) * 2 + e1;
      int dl, hl, wl;
      box_pos(pos, g, bx, &dl, &hl, &wl);
      const int d = d0 + dl, h = h0 + hl, w = w0 + wl;
      if (pos >= box || d >= g.D || h >= g.H || w >= g.W) continue;
      const long long sp = d * HW + (long long)h * g.W + w;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int co = co0 + wm * 32 + mt * 16 + (lane >> 2) + e2 * 8;
          if (co >= g.Co) continue;
          const long long idx = ((long long)n * g.Co + co) * DHW + sp;
          const float v = acc[mt][nt][e2 * 2 + e1];
          if (P == 1)
            out[idx] = __float2bfloat16_rn(v);
          else
            part[p * plane_out + idx] = v;
        }
      }
    }
  }
}

// wp [Ci/16][27][Cop][16] from w [Co, Ci, 27] (bf16), zero where ci >= Ci
// or co >= Co: the layout wide_tc_kernel's weight stages copy from
// (ops/cuda_conv.py:repack_weight is its plain version).
__global__ void repack_kernel(const __nv_bfloat16* __restrict__ w,
                              __nv_bfloat16* __restrict__ wp, int Co, int Ci,
                              int Cop, long long total) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < total; j += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(j % kTcCi);
    long long r = j / kTcCi;
    const int co = (int)(r % Cop);
    r /= Cop;
    const int tap = (int)(r % 27), ci = (int)(r / 27) * kTcCi + i;
    wp[j] = co < Co && ci < Ci ? w[((long long)co * Ci + ci) * 27 + tap]
                               : __float2bfloat16_rn(0.f);
  }
}

// ---------------------------------------------------------------------------
// wide_tf32x3: the f32 route of the wide conv, the same implicit GEMM (M =
// Co, N = positions, K = 27 * Ci) in 3xTF32 on the tensor cores
// (mma.sync m16n8k8, mma_tf32.cuh: each product a_lo b_hi + a_hi b_lo +
// a_hi b_hi of TF32 halves, f32 sums).
//
// grid (boxes, Co tiles of BM = 32 * WM, P split-K parts), 8 warps. A
// block owns a td x th x tw box of one sample (at most 64 * (8 / WM)
// positions, w fastest) and BM output channels; warp (wm, wn) computes 32
// channels x 64 positions (2 x 8 m16n8 tiles, 64 f32 sums a thread), as
// wide_tc's warps do. The part's chunks of 8 input channels are walked
// one input plane kd at a time; a step (chunk, kd) stages, in f32:
// - xs [8][CS]: planes d0 + kd - 1 .. d0 + kd + td - 2 of the chunk's
//   channels over the box's rows and their 1-voxel halo, each row tw + 8
//   values from w0 - 4, as NCDHW holds them: whole 16-byte cp.async units
//   where W and tw are multiples of 4 (kVec), else 4-byte ones, zero-filled
//   outside the volume (nothing padded in device memory). The B value
//   (channel, position) of a tap is xs[channel][the position's row + the
//   tap's offset], so a tap's shift is an offset: no im2col, no transpose.
//   A channel's CS floats are 4 mod 8, so a fragment read (8 positions x 4
//   channels) touches 32 banks.
// - ws [2][9][BM][8]: the hi and lo TF32 halves of the step's 9 taps'
//   weights, copied from wpx [2][Ci/8][27][Cop][8] (repack_x3_kernel
//   splits w once a call, so no warp splits A); rows of 32 bytes, read
//   4 rows a half-warp, free of bank conflicts.
// Both are double-buffered: step s + 1's copies are requested before step
// s's products run, and one barrier a step orders them. The activations
// are split where a warp reads them: split once a step into hi and lo
// planes in shared memory, they cost an extra pass, a barrier and twice
// the B reads, and came out no faster (PERF.md, section 6). At ~190
// registers a thread one 8-warp block runs on an SM; held to 128 (two
// blocks) ptxas spills.
// Sum length: the tensor cores' f32 sums are not rounded to nearest, so a
// chain of many terms drifts (over 32768, past 1e-4 of the largest value:
// ops/cuda_attention.py dkdv_split). A part sums at most kX3Chunks chunks
// (1944 terms); the plan splits longer sums into P parts, whose f32
// partials [P, N, Co, S] tc::sum_partials adds in a fixed order (no
// atomics: a repeat is bit-identical). Parts rather than a second,
// running sum: that would be 64 more registers a thread, and the parts
// also fill the card at small volumes, as wide_tc's do. Positions past
// the box or the volume are computed on clamped rows and not stored.
constexpr int kX3Threads = 256;  // 8 warps
constexpr int kX3Ci = 8;         // input channels a chunk: one k8 step a tap
constexpr int kX3CoPad = 128;    // wpx's Co is padded to a multiple of this
constexpr int kX3Chunks = 9;     // most chunks a part sums: 9 * 8 * 27 terms

// Floats a channel of a wide_tf32x3 x stage: td planes of th + 2 rows of
// tw + 8, rounded up to 4 mod 8.
__host__ __device__ inline int x3_cs(int td, int th, int tw) {
  return ((td * (th + 2) * (tw + 8) + 7) & ~7) + 4;
}

// Shape of a wide_tf32x3 x stage and reciprocals for fdiv.
struct X3Box {
  int HB, RW, WB, CS, U;  // rows a plane; floats a row; halo columns; a
                          // channel's floats; 16-byte units a row
  float inv_U, inv_WB, inv_HB, inv_td, inv_tw, inv_th;
};

__device__ __forceinline__ X3Box x3_box(const Geom& g) {
  X3Box b;
  b.HB = g.th + 2;
  b.RW = g.tw + 8;
  b.WB = g.tw + 2;
  b.CS = x3_cs(g.td, g.th, g.tw);
  b.U = b.RW / 4;
  b.inv_U = 1.f / b.U;
  b.inv_WB = 1.f / b.WB;
  b.inv_HB = 1.f / b.HB;
  b.inv_td = 1.f / g.td;
  b.inv_tw = 1.f / g.tw;
  b.inv_th = 1.f / g.th;
  return b;
}

// The 9 taps (kh, kw) of one step: acc += ws (this warp's 32 channels) x
// xs (its 64 positions, rows hb + the tap's offset), in 3xTF32. k runs in
// mma_tf32.cuh's order: k index q is channel 2q, q + 4 is 2q + 1, so a
// lane's two A values of a row are one 64-bit read. A tap's products run
// in three passes over the 16 tiles (a_lo b_hi, then a_hi b_lo, then a_hi
// b_hi: each tile's sums in mma3's order), so 16 independent sums are in
// flight rather than mma3's chain of three on one: 16% faster at
// 32ch@64^3 (PERF.md, section 6).
template <int WM>
__device__ __forceinline__ void wide_x3_step(float (*acc)[8][4],
                                             const float* xs,
                                             const float* ws, const int* hb,
                                             int RW, int CS, int wm, int gq,
                                             int q) {
  constexpr int BM = 32 * WM;
  const float* wl = ws + 9 * BM * kX3Ci;
  const float* x0 = xs + 2 * q * CS;  // channel 2q; 2q + 1 at + CS
#pragma unroll 1
  for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const int tap = kh * 3 + kw, toff = kh * RW + kw;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = (tap * BM + wm * 32 + mt * 16 + gq) * kX3Ci + 2 * q;
        const uint2 h0 = *reinterpret_cast<const uint2*>(ws + r);
        const uint2 h1 = *reinterpret_cast<const uint2*>(ws + r + 8 * kX3Ci);
        const uint2 v0 = *reinterpret_cast<const uint2*>(wl + r);
        const uint2 v1 = *reinterpret_cast<const uint2*>(wl + r + 8 * kX3Ci);
        ah[mt][0] = h0.x; ah[mt][1] = h1.x; ah[mt][2] = h0.y; ah[mt][3] = h1.y;
        al[mt][0] = v0.x; al[mt][1] = v1.x; al[mt][2] = v0.y; al[mt][3] = v1.y;
      }
      uint32_t bh[8][2], bl[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {  // x split where read
        const int e = hb[nt] + toff;
        tc::split_tf32(x0[e], bh[nt][0], bl[nt][0]);
        tc::split_tf32(x0[e + CS], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          tc::mma_tf32(acc[mt][nt], al[mt], bh[nt]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          tc::mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          tc::mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
    }
  }
}

template <int WM, bool kVec>
__global__ void __launch_bounds__(kX3Threads)
wide_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                   float* __restrict__ part, float* __restrict__ out, Geom g,
                   int P) {
  constexpr int BM = 32 * WM;
  constexpr int kWs = 2 * 9 * BM * kX3Ci;  // floats of one weight stage
  extern __shared__ float4 smem_x3[];
  const X3Box bx = x3_box(g);
  float* xs0 = reinterpret_cast<float*>(smem_x3);  // [2][8][CS]
  float* ws0 = xs0 + 2 * kX3Ci * bx.CS;            // [2][kWs]

  int b = blockIdx.x;
  const int bw = b % g.nbw; b /= g.nbw;
  const int bh = b % g.nbh; b /= g.nbh;
  const int bd = b % g.nbd;
  const int n = b / g.nbd;
  const int d0 = bd * g.td, h0 = bh * g.th, w0 = bw * g.tw;
  const int co0 = blockIdx.y * BM;
  const int p = blockIdx.z;
  const int nchunk = cdiv(g.Ci, kX3Ci);
  const int c_begin = nchunk * p / P, c_end = nchunk * (p + 1) / P;
  const int Cop = cdiv(g.Co, kX3CoPad) * kX3CoPad;
  const int box = g.td * g.th * g.tw;

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int wm = warp % WM, wn = warp / WM;
  const int gq = lane >> 2, q = lane & 3;
  const bool active = wn * 64 < box;  // warp has positions in the box

  // x row (tap (0, 0, 0), plane dl of the stage) of position gq of each
  // of the warp's n8 tiles
  int hb[8];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int pos = wn * 64 + nt * 8 + gq;
    const int r = fdiv(pos, bx.inv_tw), wl = pos - r * g.tw;
    const int dl = fdiv(r, bx.inv_th), hl = r - dl * g.th;
    hb[nt] = pos < box ? (dl * bx.HB + hl) * bx.RW + wl + 3 : 0;
  }

  const long long HW = (long long)g.H * g.W;
  const long long DHW = HW * g.D;
  const float* xn = x + (long long)n * g.Ci * DHW;

  // step s: chunk c_begin + s / 3, input planes from d0 + kd - 1
  auto load = [&](int s, int buf) {
    const int c = c_begin + s / 3, kd = s % 3;
    float* xs = xs0 + buf * kX3Ci * bx.CS;
    float* ws = ws0 + buf * kWs;
    for (int i = t; i < 2 * 9 * BM * 2; i += kX3Threads) {
      const int half = i & 1, row = i >> 1;  // row = (plane * 9 + tap) * BM + co
      const int pt = row / BM, co = row % BM;
      const int pl = pt / 9, tap = pt - pl * 9;
      tc::cp_async16(ws + row * kX3Ci + half * 4,
                     wp + ((((long long)pl * nchunk + c) * 27 + kd * 9 + tap) *
                               Cop + co0 + co) * kX3Ci + half * 4);
    }
    const int ci0 = c * kX3Ci, gd0 = d0 + kd - 1;
    // an item: one 16-byte unit (kVec) or one value of a (channel, plane,
    // row) of the stage
    const int per_row = kVec ? bx.U : bx.WB;
    const float inv_row = kVec ? bx.inv_U : bx.inv_WB;
    const int items = kX3Ci * g.td * bx.HB * per_row;
    for (int i = t; i < items; i += kX3Threads) {
      const int r = fdiv(i, inv_row), u = i - r * per_row;
      const int r2 = fdiv(r, bx.inv_HB), hh = r - r2 * bx.HB;
      const int ch = fdiv(r2, bx.inv_td), dl = r2 - ch * g.td;
      const int gd = gd0 + dl, gh = h0 + hh - 1;
      const int gw = kVec ? w0 - 4 + 4 * u : w0 - 1 + u;
      const bool ok = ci0 + ch < g.Ci && gd >= 0 && gd < g.D && gh >= 0 &&
                      gh < g.H && gw >= 0 && gw < g.W;
      const float* src =
          ok ? xn + (ci0 + ch) * DHW + gd * HW + (long long)gh * g.W + gw : xn;
      float* dst = xs + ch * bx.CS + (dl * bx.HB + hh) * bx.RW;
      if (kVec)
        tc::cp_async16(dst + 4 * u, src, ok ? 16 : 0);
      else
        tc::cp_async4(dst + u + 3, src, ok ? 4 : 0);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
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
    if (active)
      wide_x3_step<WM>(acc, xs0 + (s & 1) * kX3Ci * bx.CS,
                       ws0 + (s & 1) * kWs, hb, bx.RW, bx.CS, wm, gq, q);
  }
  if (!active) return;

  const long long plane_out = (long long)g.N * g.Co * DHW;
  float* dst = P == 1 ? out : part + p * plane_out;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e1 = 0; e1 < 2; ++e1) {
      const int pos = wn * 64 + nt * 8 + 2 * q + e1;
      const int r = fdiv(pos, bx.inv_tw), wl = pos - r * g.tw;
      const int dl = fdiv(r, bx.inv_th), hl = r - dl * g.th;
      const int d = d0 + dl, h = h0 + hl, w = w0 + wl;
      if (pos >= box || d >= g.D || h >= g.H || w >= g.W) continue;
      const long long sp = d * HW + (long long)h * g.W + w;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int co = co0 + wm * 32 + mt * 16 + gq + e2 * 8;
          if (co < g.Co)
            dst[((long long)n * g.Co + co) * DHW + sp] = acc[mt][nt][e2 * 2 + e1];
        }
      }
    }
  }
}

// wpx [2][Ci/8][27][Cop][8] from w [Co, Ci, 27] (f32): plane 0 the hi TF32
// halves, plane 1 the lo (tc::split_tf32), zero where ci >= Ci or co >= Co:
// the layout wide_tf32x3_kernel's weight stages copy from
// (ops/cuda_conv.py:repack_weight_x3 is its plain version).
__global__ void repack_x3_kernel(const float* __restrict__ w,
                                 float* __restrict__ wp, int Co, int Ci,
                                 int Cop, long long total) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < total; j += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(j % kX3Ci);
    long long r = j / kX3Ci;
    const int co = (int)(r % Cop);
    r /= Cop;
    const int tap = (int)(r % 27), ci = (int)(r / 27) * kX3Ci + i;
    const float v =
        co < Co && ci < Ci ? w[((long long)co * Ci + ci) * 27 + tap] : 0.f;
    uint32_t hi, lo;
    tc::split_tf32(v, hi, lo);
    wp[j] = __uint_as_float(hi);
    wp[total + j] = __uint_as_float(lo);
  }
}

// ---------------------------------------------------------------------------
// dw_tc: the bf16 route of dW, an implicit GEMM on the tensor cores. Per
// tap dW[co][ci] = sum_pos g[pos][co] x[pos + shift(tap)][ci] is a GEMM
// with M = Co, N = 27 taps x Ci, K = positions.
//
// grid (P split-K parts, Ci tiles of 16, Co tiles of 32), 9 warps.
// Block p walks the boxes [nboxes*p/P, nboxes*(p+1)/P) of the (n, box)
// list (td x th x tw positions of one sample, w fastest) in order; warp
// w owns taps 3w .. 3w+2 (kd = w / 3, kh = w % 3, kw = 0..2) for all the
// block's 32 x 16 channels: 3 x 2 x 2 m16n8 tiles, 48 f32 sums a thread.
// Per box it stages, bf16 and channels innermost:
// - gs [kpad][32 co]: the box's output gradient, kpad = the box rounded
//   up to 16 positions (rows past the box or the volume are zero, so they
//   add nothing);
// - xs [halo rows][16 ci]: the box's input plus its 1-voxel halo,
//   zero outside the volume.
// Both are stored with rows = positions (the GEMM's k), so both the A
// (g) and the B (x) fragments come from ldmatrix.trans, and a tap's shift
// is a row offset into xs (hrow, the halo row of each box position, is
// computed once a block): no im2col. Rows are swizzled (tc::swz) so each
// ldmatrix is free of bank conflicts. Staging reads NCDHW with one
// two-byte load a channel, coalesced along w, 8 channels at a time, and
// transposes through registers, with the per-position index work done
// once for all channels (fdiv). The 8-at-a-time loads keep a thread under
// 113 registers, so two blocks (18 warps) share an SM and one block's
// staging overlaps the other's products. Each block writes f32 partials
// part[p][co][tap][ci] (ci innermost, so a warp's stores fill whole
// 32-byte sectors);
// dw_reduce_kernel sums them in a fixed order, so a repeat is
// bit-identical.
constexpr int kDwTcThreads = 288;  // 9 warps x 3 taps
constexpr int kDwTcCo = 32;        // output channels per block
constexpr int kDwTcCi = 16;        // input channels per block

__global__ void __launch_bounds__(kDwTcThreads, 2)
dw_tc_kernel(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ gr, float* __restrict__ part,
             Geom g, int P) {
  extern __shared__ uint4 smem_tc[];
  const TcBox bx = tc_box(g);
  const int box = g.td * g.th * g.tw;
  const int kpad = cdiv(box, 16) * 16;
  uint4* xs = smem_tc;                                   // [R][2]
  uint4* gs = xs + 2 * bx.R;                             // [kpad][4]
  int* hrow = reinterpret_cast<int*>(gs + 4 * kpad);     // [kpad]

  const int p = blockIdx.x;
  const int ci0 = blockIdx.y * kDwTcCi, co0 = blockIdx.z * kDwTcCo;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int kd = warp / 3, kh = warp % 3;

  for (int i = t; i < kpad; i += kDwTcThreads) {
    int dl, hl, wl;
    box_pos(i, g, bx, &dl, &hl, &wl);
    hrow[i] = i < box ? (dl * bx.HB + hl) * bx.WB + wl : 0;
  }

  const long long HW = (long long)g.H * g.W;
  const long long DHW = HW * g.D;
  const long long nboxes = (long long)g.N * g.nbd * g.nbh * g.nbw;
  const long long b_begin = nboxes * p / P, b_end = nboxes * (p + 1) / P;
  const uint16_t* xu = reinterpret_cast<const uint16_t*>(x);
  const uint16_t* gu = reinterpret_cast<const uint16_t*>(gr);

  float acc[3][2][2][4];
#pragma unroll
  for (int tt = 0; tt < 3; ++tt)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[tt][mt][nt][e] = 0.f;

  for (long long b = b_begin; b < b_end; ++b) {
    long long q = b;
    const int bw = (int)(q % g.nbw); q /= g.nbw;
    const int bh = (int)(q % g.nbh); q /= g.nbh;
    const int bd = (int)(q % g.nbd);
    const int n = (int)(q / g.nbd);
    const int d0 = bd * g.td, h0 = bh * g.th, w0 = bw * g.tw;
    const uint16_t* xn = xu + ((long long)n * g.Ci + ci0) * DHW;
    const uint16_t* gn = gu + ((long long)n * g.Co + co0) * DHW;
    __syncthreads();  // the previous box's products are done
    for (int hp = t; hp < bx.R; hp += kDwTcThreads) {
      const int r = fdiv(hp, bx.inv_WB), ww = hp - r * bx.WB;
      const int dd = fdiv(r, bx.inv_HB), hh = r - dd * bx.HB;
      const int gd = d0 + dd - 1, gh = h0 + hh - 1, gw = w0 + ww - 1;
      const bool in = gd >= 0 && gd < g.D && gh >= 0 && gh < g.H &&
                      gw >= 0 && gw < g.W;
      const uint16_t* src = xn + (in ? gd * HW + (long long)gh * g.W + gw : 0);
#pragma unroll 1
      for (int c = 0; c < 2; ++c) {
        uint16_t h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = in && ci0 + 8 * c + e < g.Ci ? src[(8 * c + e) * DHW] : 0;
        xs[tc::swz<2>(hp, c)] = make_uint4(
            tc::pack_raw(h[0], h[1]), tc::pack_raw(h[2], h[3]),
            tc::pack_raw(h[4], h[5]), tc::pack_raw(h[6], h[7]));
      }
    }
    for (int s = t; s < kpad; s += kDwTcThreads) {
      int dl, hl, wl;
      box_pos(s, g, bx, &dl, &hl, &wl);
      const int gd = d0 + dl, gh = h0 + hl, gw = w0 + wl;
      const bool in = s < box && gd < g.D && gh < g.H && gw < g.W;
      const uint16_t* src = gn + (in ? gd * HW + (long long)gh * g.W + gw : 0);
#pragma unroll 1
      for (int c = 0; c < 4; ++c) {
        uint16_t h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = in && co0 + 8 * c + e < g.Co ? src[(8 * c + e) * DHW] : 0;
        gs[tc::swz<4>(s, c)] = make_uint4(
            tc::pack_raw(h[0], h[1]), tc::pack_raw(h[2], h[3]),
            tc::pack_raw(h[4], h[5]), tc::pack_raw(h[6], h[7]));
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int k0 = 0; k0 < kpad; k0 += 16) {
      // A (g, 16 co x 16 positions) of each m16 tile; B (x) rows: this
      // lane's position of the k-step, shifted by each tap
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        tc::ldsm_x4_trans(a[mt], gs + tc::swz<4>(k0 + ((lane >> 4) & 1) * 8 +
                                                     (lane & 7),
                                                 mt * 2 + ((lane >> 3) & 1)));
      const int hr = hrow[k0 + ((lane >> 3) & 1) * 8 + (lane & 7)] +
                     (kd * bx.HB + kh) * bx.WB;
#pragma unroll
      for (int tt = 0; tt < 3; ++tt) {
        uint32_t bf[4];
        tc::ldsm_x4_trans(bf, xs + tc::swz<2>(hr + tt, lane >> 4));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          tc::mma(acc[tt][mt][0], a[mt], bf);
          tc::mma(acc[tt][mt][1], a[mt], bf + 2);
        }
      }
    }
  }

#pragma unroll
  for (int tt = 0; tt < 3; ++tt) {
    const int tap = warp * 3 + tt;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = co0 + mt * 16 + (lane >> 2) + (e >> 1) * 8;
          const int ci = ci0 + nt * 8 + (lane & 3) * 2 + (e & 1);
          if (co < g.Co && ci < g.Ci)
            part[(((long long)p * g.Co + co) * 27 + tap) * g.Ci + ci] =
                acc[tt][mt][nt][e];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dw_tf32x3: the f32 route of dW, the GEMM of dw_tc (M = Co, N = 27 taps x
// Ci, K = positions) in 3xTF32 on the tensor cores (mma.sync m16n8k8,
// mma_tf32.cuh: each product a_lo b_hi + a_hi b_lo + a_hi b_hi of TF32
// halves, f32 sums).
//
// grid (P split-K parts, Ci tiles of kDwCi, Co tiles of kDwCo), 9 warps.
// Block p walks the boxes [nboxes*p/P, nboxes*(p+1)/P) of the (n, box)
// list (td x th x tw positions of one sample, tw a multiple of 4, w
// fastest) in order; warp w owns taps 3w .. 3w+2 (kd = w / 3, kh = w % 3,
// kw = 0..2) for all the block's 32 x 16 channels: 3 x 2 x 2 m16n8 tiles,
// 48 f32 sums a thread. NCDHW holds the positions, the GEMM's k,
// contiguous along w in both operands, so a box is staged as it lies, in
// f32, by cp.async (16-byte units where W is a multiple of 4 and x and g
// are 16-byte aligned, else 4-byte ones; zero-filled outside the volume),
// with no transpose:
// - gs [32 co][GS]: the box's output gradient, position (dl, hl, wl) at
//   column (dl * th + hl) * tw + wl, KP = the box rounded up to 8
//   positions (the pad is zero);
// - xs [16 ci][CS]: the box's input and its 1-voxel halo, (td + 2) x
//   (th + 2) rows of tw + 8 floats from w0 - 4; hrow[k], computed once a
//   block, is the row and column of box position k, so tap (kd, kh, kw)
//   reads xs[ci][hrow[k] + (kd * HB + kh) * RW + kw]: a shift is an offset.
// Both are double-buffered: box b + 1's copies are requested before box
// b's products run, and one barrier a box orders them.
// k order. A lane holds k index q and q + 4 of each k8 step (the PTX
// fragments' own order), positions k0 + q and k0 + q + 4. mma_tf32.cuh's
// order (q -> 2q, q + 4 -> 2q + 1) would make A's pair one 64-bit read,
// but a tap with odd kw shifts B's pair by one position, off the 8-byte
// grid, and 32-bit reads of pairs at one parity reach only 16 of the 32
// banks: 2-way conflicts on 2 of every 3 taps. In the PTX order a fragment
// is four 8 x 4 f32 matrices whose rows are 16 contiguous bytes (the k8
// step's positions come in groups of 4 along w of one row: tw is a
// multiple of 4), so each m16 tile of A is one ldmatrix.x4 of g, and B at
// kw = 1 one ldmatrix.x4 of x for both n8 tiles (hrow is 3 mod 4 at a
// group's start, so those rows start on 16-byte boundaries); B at kw = 0
// and 2 is two 32-bit reads a lane. A row or channel stride of 4 mod 8
// floats (GS, CS) keeps all of them free of bank conflicts: an ldmatrix
// phase's 8 rows of 16 bytes fall on 8 distinct 16-byte bank groups, and
// a 32-bit read puts lane (g, q) at bank 4 (g * odd mod 8) + q + const.
// Split: both operands are activations, so nothing is split once a call
// as K4's weights are; a warp splits each value where it reads it, hi
// truncated (tc::split_tf32_trunc, one logic op fewer than rounding, the
// same 2^-21 bound). Split once a box into hi and lo stages in shared
// memory instead (the lo halves in a third stage, after the box lands; a
// pass and a barrier a box), g alone came out 0-4% slower and g and x
// 7-20% slower (with 128-position boxes, for the third stage's room); the
// ldmatrix reads and the truncating split together gained 2-8% over
// 32-bit reads and tc::split_tf32: PERF.md, section 6.
// Sum length: the tensor cores' f32 sums are not rounded to nearest (an f32
// chain sums at most 2048 terms), so a chain sums at most kDwX3Chain / KP
// boxes, then is added into a running f32 sum (48 more registers) by
// ordinary rounded adds. The parts' f32 partials [P, Co, Ci, 27] (dw's own
// layout) are added in a fixed order by tc::sum_partials; with P = 1 the
// block writes dw. No atomics, so a repeat is bit-identical. The block's
// 32 x 16 x 27 sums leave through shared memory, as 32 rows of 16 * 27
// contiguous floats of dw's layout, so the stores are coalesced.
constexpr int kDwX3Threads = 288;         // 9 warps x 3 taps
constexpr int kDwX3Chain = 2048;          // most positions an MMA chain sums
constexpr int kDwX3Out = kDwCi * 27 + 1;  // floats a row of the output tile

// Positions a dw_tf32x3 box holds, rounded up to a whole k8 step.
__host__ __device__ inline int dw_x3_kp(int td, int th, int tw) {
  return cdiv(td * th * tw, 8) * 8;
}

// Floats a channel of a dw_tf32x3 x stage: (td + 2) x (th + 2) rows of
// tw + 8, rounded up to 4 mod 8.
__host__ __device__ inline int dw_x3_cs(int td, int th, int tw) {
  return (((td + 2) * (th + 2) * (tw + 8) + 7) & ~7) + 4;
}

// Shared-memory bytes of a dw_tf32x3 block: two stages (x, then g: rows of
// KP + 4 floats), the halo-row table, and at least the epilogue's output
// tile.
inline size_t dw_x3_smem(int td, int th, int tw) {
  const size_t kp = dw_x3_kp(td, th, tw);
  const size_t stage = kDwCi * (size_t)dw_x3_cs(td, th, tw) + kDwCo * (kp + 4);
  const size_t bytes = 4 * (2 * stage + kp);
  const size_t out = 4 * (size_t)kDwCo * kDwX3Out;
  return bytes > out ? bytes : out;
}

template <bool kVec>
__global__ void __launch_bounds__(kDwX3Threads, 1)
dw_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ gr,
                 float* __restrict__ out, Geom g, int P) {
  extern __shared__ float4 smem_dw[];
  const int box = g.td * g.th * g.tw;
  const int KP = dw_x3_kp(g.td, g.th, g.tw), GS = KP + 4;
  const int CS = dw_x3_cs(g.td, g.th, g.tw);
  const int HB = g.th + 2, RW = g.tw + 8, TD2 = g.td + 2;
  const int stage = kDwCi * CS + kDwCo * GS;  // floats: xs, then gs
  float* st0 = reinterpret_cast<float*>(smem_dw);  // [2][stage]
  int* hrow = reinterpret_cast<int*>(st0 + 2 * stage);  // [KP]

  const int p = blockIdx.x;
  const int ci0 = blockIdx.y * kDwCi, co0 = blockIdx.z * kDwCo;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int kd = warp / 3, kh = warp - kd * 3;

  const float inv_tw = 1.f / g.tw, inv_th = 1.f / g.th, inv_td = 1.f / g.td;
  // pad positions read a staged column (position 0's), times a zero g
  for (int k = t; k < KP; k += kDwX3Threads) {
    const int r = fdiv(k, inv_tw), wl = k - r * g.tw;
    const int dl = fdiv(r, inv_th), hl = r - dl * g.th;
    hrow[k] = k < box ? (dl * HB + hl) * RW + wl + 3 : 3;
  }
  const int pad = KP - box;  // 0 or 4
  for (int i = t; i < 2 * kDwCo * pad; i += kDwX3Threads)
    st0[(i / (kDwCo * pad)) * stage + kDwCi * CS +
        (i / pad % kDwCo) * GS + box + i % pad] = 0.f;

  const long long HW = (long long)g.H * g.W;
  const long long DHW = HW * g.D;
  const long long nboxes = (long long)g.N * g.nbd * g.nbh * g.nbw;
  const long long b_begin = nboxes * p / P;
  const int nb = (int)(nboxes * (p + 1) / P - b_begin);
  const int chain = kDwX3Chain / KP;  // boxes an MMA chain sums
  const int xrow = kVec ? RW / 4 : g.tw + 2;  // copies a halo row
  const int grow = kVec ? g.tw / 4 : g.tw;    // copies a g row
  const float inv_xrow = 1.f / xrow, inv_grow = 1.f / grow;
  const float inv_HB = 1.f / HB, inv_TD2 = 1.f / TD2;

  // box b's x halo and g into stage buf
  auto load = [&](long long b, int buf) {
    const int bw = (int)(b % g.nbw); b /= g.nbw;
    const int bh = (int)(b % g.nbh); b /= g.nbh;
    const int bd = (int)(b % g.nbd);
    const int n = (int)(b / g.nbd);
    const int d0 = bd * g.td, h0 = bh * g.th, w0 = bw * g.tw;
    float* xs = st0 + buf * stage;
    float* gs = xs + kDwCi * CS;
    const float* xn = x + ((long long)n * g.Ci + ci0) * DHW;
    const float* gn = gr + ((long long)n * g.Co + co0) * DHW;
    for (int i = t; i < kDwCi * TD2 * HB * xrow; i += kDwX3Threads) {
      const int r = fdiv(i, inv_xrow), u = i - r * xrow;
      const int r2 = fdiv(r, inv_HB), hh = r - r2 * HB;
      const int ch = fdiv(r2, inv_TD2), dd = r2 - ch * TD2;
      const int gd = d0 + dd - 1, gh = h0 + hh - 1;
      const int gw = kVec ? w0 - 4 + 4 * u : w0 - 1 + u;
      const bool ok = ci0 + ch < g.Ci && gd >= 0 && gd < g.D && gh >= 0 &&
                      gh < g.H && gw >= 0 && gw < g.W;
      const float* src =
          ok ? xn + ch * DHW + gd * HW + (long long)gh * g.W + gw : x;
      float* dst = xs + ch * CS + (dd * HB + hh) * RW;
      if (kVec)
        tc::cp_async16(dst + 4 * u, src, ok ? 16 : 0);
      else
        tc::cp_async4(dst + u + 3, src, ok ? 4 : 0);
    }
    for (int i = t; i < kDwCo * g.td * g.th * grow; i += kDwX3Threads) {
      const int r = fdiv(i, inv_grow), u = i - r * grow;
      const int r2 = fdiv(r, inv_th), hl = r - r2 * g.th;
      const int co = fdiv(r2, inv_td), dl = r2 - co * g.td;
      const int wl = kVec ? 4 * u : u;
      const int gd = d0 + dl, gh = h0 + hl, gw = w0 + wl;
      const bool ok = co0 + co < g.Co && gd < g.D && gh < g.H && gw < g.W;
      const float* src =
          ok ? gn + co * DHW + gd * HW + (long long)gh * g.W + gw : gr;
      float* dst = gs + co * GS + (dl * g.th + hl) * g.tw + wl;
      if (kVec)
        tc::cp_async16(dst, src, ok ? 16 : 0);
      else
        tc::cp_async4(dst, src, ok ? 4 : 0);
    }
  };

  float acc[3][2][2][4], run[3][2][2][4];
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[kw][mt][nt][e] = run[kw][mt][nt][e] = 0.f;

  // The products of the box in stage buf: per k8 step this lane's A values
  // (rows gq, gq + 8 of each m16 tile at positions k0 + q, k0 + q + 4) and
  // B values (channel gq of each n8 tile at those positions, shifted by
  // each tap), fetched one step ahead; three passes over the 12 tiles (a_lo
  // b_hi, a_hi b_lo, a_hi b_hi) keep 12 independent sums in flight.
  auto products = [&](int buf) {
    const float* xs = st0 + buf * stage + (kd * HB + kh) * RW;
    const float* xh = xs + gq * CS;
    // ldmatrix rows: matrix j = lane / 8 takes row lane % 8 of A's rows
    // (j & 1) * 8 .. + 7 at k (j >> 1) * 4 .. + 3, and of B's (kw = 1)
    // channels (j >> 1) * 8 .. + 7 at the k8 step's group j & 1
    const int jm = lane >> 3, lr = lane & 7;
    const float* a_ld = st0 + buf * stage + kDwCi * CS +
                        ((jm & 1) * 8 + lr) * GS + (jm >> 1) * 4;
    const float* b_ld = xs + ((jm >> 1) * 8 + lr) * CS + 1;
    uint32_t va[2][4], vb[3][2][2];
    auto fetch = [&](int k0) {
      const int r0 = hrow[k0 + q], r1 = hrow[k0 + q + 4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        tc::ldsm_x4(va[mt], a_ld + mt * 16 * GS + k0);
      uint32_t b1[4];
      tc::ldsm_x4(b1, b_ld + hrow[k0 + (jm & 1) * 4]);
      vb[1][0][0] = b1[0];
      vb[1][0][1] = b1[1];
      vb[1][1][0] = b1[2];
      vb[1][1][1] = b1[3];
#pragma unroll
      for (int kw = 0; kw < 3; kw += 2)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          vb[kw][nt][0] = __float_as_uint(xh[nt * 8 * CS + r0 + kw]);
          vb[kw][nt][1] = __float_as_uint(xh[nt * 8 * CS + r1 + kw]);
        }
    };
    fetch(0);
#pragma unroll 1
    for (int k0 = 0; k0 < KP; k0 += 8) {
      uint32_t ah[2][4], al[2][4], bh[3][2][2], bl[3][2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tc::split_tf32_trunc(va[mt][e], ah[mt][e], al[mt][e]);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            tc::split_tf32_trunc(vb[kw][nt][e], bh[kw][nt][e],
                                 bl[kw][nt][e]);
      if (k0 + 8 < KP) fetch(k0 + 8);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            tc::mma_tf32(acc[kw][mt][nt], al[mt], bh[kw][nt]);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            tc::mma_tf32(acc[kw][mt][nt], ah[mt], bl[kw][nt]);
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            tc::mma_tf32(acc[kw][mt][nt], ah[mt], bh[kw][nt]);
    }
  };

  load(b_begin, 0);
  tc::cp_async_commit();
  for (int i = 0; i < nb; ++i) {
    tc::cp_async_wait<0>();
    __syncthreads();  // box i landed; box i - 1's stage is free
    if (i + 1 < nb) {
      load(b_begin + i + 1, (i + 1) & 1);  // in flight during the products
      tc::cp_async_commit();
    }
    products(i & 1);
    if ((i + 1) % chain == 0 || i + 1 == nb) {  // the chain into the sum
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              run[kw][mt][nt][e] += acc[kw][mt][nt][e];
              acc[kw][mt][nt][e] = 0.f;
            }
    }
  }

  // the block's sums as [co][ci * 27 + tap] rows, then out in dw's layout
  __syncthreads();  // every warp's products are done: the stages are free
#pragma unroll
  for (int kw = 0; kw < 3; ++kw)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          st0[(mt * 16 + gq + (e >> 1) * 8) * kDwX3Out +
              (nt * 8 + 2 * q + (e & 1)) * 27 + warp * 3 + kw] =
              run[kw][mt][nt][e];
  __syncthreads();
  const int cols = 27 * min(kDwCi, g.Ci - ci0);
  const int rows = min(kDwCo, g.Co - co0);
  float* dst = out + (((long long)p * g.Co + co0) * g.Ci + ci0) * 27;
  for (int i = t; i < rows * cols; i += kDwX3Threads) {
    const int r = i / cols, c = i - r * cols;
    dst[(long long)r * g.Ci * 27 + c] = st0[r * kDwX3Out + c];
  }
}

// dw[co][ci][tap] = sum_{p = 0 .. P-1} part[p][co][tap][ci], in that
// order (reads coalesced along ci; M = Co * 27 * Ci).
__global__ void dw_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ dw, int P, int Ci,
                                 long long M) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < M;
       j += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += part[(long long)p * M + j];
    const long long r = j / Ci;   // co * 27 + tap
    dw[(r / 27 * Ci + j % Ci) * 27 + r % 27] = s;
  }
}

int reduce_partials(const float* part, float* dw, int P, const Geom& g,
                    cudaStream_t st) {
  const long long M = (long long)g.Co * 27 * g.Ci;
  const long long blocks = (M + kReduceThreads - 1) / kReduceThreads;
  dw_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096),
                     kReduceThreads, 0, st>>>(part, dw, P, g.Ci, M);
  return (int)cudaGetLastError();
}

bool make_geom(Geom* g, int N, int Ci, int Co, int D, int H, int W, int td,
               int th, int tw) {
  if (N < 1 || Ci < 1 || Co < 1 || D < 1 || H < 1 || W < 1 || td < 1 ||
      th < 1 || tw < 1)
    return false;
  *g = Geom{N, Ci, Co, D, H, W, td, th, tw, cdiv(D, td), cdiv(H, th),
            cdiv(W, tw)};
  return true;
}

template <typename K>
bool set_smem(K kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return false;
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes) == cudaSuccess;
  return true;
}

int launch_wide_x3(const void* x, const void* wp, void* part, void* out,
                   const Geom& g, int wm, int P, cudaStream_t st) {
  const long long boxes = (long long)g.N * g.nbd * g.nbh * g.nbw;
  const int co_tiles = cdiv(g.Co, 32 * wm);
  const int nchunk = cdiv(g.Ci, kX3Ci);
  // P within the chunks, and no part summing more than kX3Chunks of them
  if ((wm != 1 && wm != 2 && wm != 4) || g.td * g.th * g.tw > 64 * (8 / wm) ||
      P > nchunk || P < cdiv(nchunk, kX3Chunks) || P > 65535 ||
      co_tiles > 65535 || boxes > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const bool vec =
      g.W % 4 == 0 && g.tw % 4 == 0 && (uintptr_t)x % 16 == 0;
  const size_t cs = x3_cs(g.td, g.th, g.tw);
  const size_t smem = sizeof(float) * (2 * kX3Ci * cs +
                                       (size_t)2 * 2 * 9 * 32 * wm * kX3Ci);
  const dim3 grid((unsigned)boxes, co_tiles, P);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(wp);
  auto* of = static_cast<float*>(out);
  float* pf = static_cast<float*>(part);
  auto launch = [&](auto kernel) {
    if (!set_smem(kernel, smem)) return false;
    kernel<<<grid, kX3Threads, smem, st>>>(xf, wf, pf, of, g, P);
    return true;
  };
  auto by_wm = [&](auto k1, auto k2, auto k4) {
    return wm == 1 ? launch(k1) : wm == 2 ? launch(k2) : launch(k4);
  };
  const bool ok = vec ? by_wm(wide_tf32x3_kernel<1, true>,
                              wide_tf32x3_kernel<2, true>,
                              wide_tf32x3_kernel<4, true>)
                      : by_wm(wide_tf32x3_kernel<1, false>,
                              wide_tf32x3_kernel<2, false>,
                              wide_tf32x3_kernel<4, false>);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || P == 1) return (int)err;
  return (int)tc::sum_partials(pf, of, P,
                               (long long)g.N * g.Co * g.D * g.H * g.W, st);
}

int launch_wide_tc(const void* x, const void* wp, void* part, void* out,
                   const Geom& g, int wm, int P, cudaStream_t st) {
  const long long boxes = (long long)g.N * g.nbd * g.nbh * g.nbw;
  const int bm = 32 * wm;
  const int co_tiles = cdiv(g.Co, bm);
  if ((wm != 1 && wm != 2) || g.td * g.th * g.tw > 64 * (4 / wm) || P < 1 ||
      P > cdiv(g.Ci, kTcCi) || P > 65535 || co_tiles > 65535 ||
      boxes > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int rows = (g.td + 2) * (g.th + 2) * (g.tw + 2);
  // staged where every raw row is whole 8-byte units; else direct loads
  const bool vec = g.W % 4 == 0 && g.tw % 4 == 0;
  const size_t smem = 32 * ((size_t)rows + 27 * bm) +
                      (vec ? (size_t)2 * kTcCi * (g.td + 2) * (g.th + 2) *
                                 (g.tw + 8)
                           : 0);
  const dim3 grid((unsigned)boxes, co_tiles, P);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(wp);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  float* pf = static_cast<float*>(part);
  auto launch = [&](auto kernel) {
    if (!set_smem(kernel, smem)) return false;
    kernel<<<grid, kTcThreads, smem, st>>>(xb, wb, pf, ob, g, P);
    return true;
  };
  const bool ok = wm == 1 ? (vec ? launch(wide_tc_kernel<1, true>)
                                 : launch(wide_tc_kernel<1, false>))
                          : (vec ? launch(wide_tc_kernel<2, true>)
                                 : launch(wide_tc_kernel<2, false>));
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || P == 1) return (int)err;
  return (int)tc::sum_partials(pf, ob, P,
                               (long long)g.N * g.Co * g.D * g.H * g.W, st);
}

int launch_dw_x3(const void* x, const void* gr, void* part, void* dw,
                 const Geom& g, int P, cudaStream_t st) {
  const long long boxes = (long long)g.N * g.nbd * g.nbh * g.nbw;
  if (P < 1 || P > boxes || g.tw % 4 != 0 ||
      dw_x3_kp(g.td, g.th, g.tw) > kDwX3Chain ||
      cdiv(g.Ci, kDwCi) > 65535 || cdiv(g.Co, kDwCo) > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = g.W % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)gr % 16 == 0;
  const size_t smem = dw_x3_smem(g.td, g.th, g.tw);
  const auto* xf = static_cast<const float*>(x);
  const auto* gf = static_cast<const float*>(gr);
  float* pf = static_cast<float*>(part);
  float* df = static_cast<float*>(dw);
  const dim3 grid((unsigned)P, cdiv(g.Ci, kDwCi), cdiv(g.Co, kDwCo));
  auto launch = [&](auto kernel) {
    if (!set_smem(kernel, smem)) return false;
    kernel<<<grid, kDwX3Threads, smem, st>>>(xf, gf, P == 1 ? df : pf, g, P);
    return true;
  };
  const bool ok = vec ? launch(dw_tf32x3_kernel<true>)
                      : launch(dw_tf32x3_kernel<false>);
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || P == 1) return (int)err;
  return (int)tc::sum_partials(pf, df, P, (long long)g.Co * g.Ci * 27, st);
}

int launch_dw_tc(const void* x, const void* gr, void* part, void* dw,
                 const Geom& g, int P, cudaStream_t st) {
  const long long boxes = (long long)g.N * g.nbd * g.nbh * g.nbw;
  if (P < 1 || P > boxes || cdiv(g.Ci, kDwTcCi) > 65535 ||
      cdiv(g.Co, kDwTcCo) > 65535)
    return (int)cudaErrorInvalidValue;
  const int rows = (g.td + 2) * (g.th + 2) * (g.tw + 2);
  const int kpad = cdiv(g.td * g.th * g.tw, 16) * 16;
  const size_t smem = (size_t)32 * rows + (size_t)(64 + 4) * kpad;
  if (!set_smem(dw_tc_kernel, smem)) return (int)cudaErrorInvalidValue;
  float* pf = static_cast<float*>(part);
  dw_tc_kernel<<<dim3(P, cdiv(g.Ci, kDwTcCi), cdiv(g.Co, kDwTcCo)),
                 kDwTcThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(gr), pf, g, P);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce_partials(pf, static_cast<float*>(dw), P, g, st);
}

}  // namespace

extern "C" {

// wpx [2][Ci/8][27][Cop][8] f32 (Cop = Co rounded up to 128) from w
// [Co, Ci, 3, 3, 3] f32: the f32 route's weight layout, split into its hi
// and lo TF32 halves.
int k3_repack_x3(const void* w, void* wp, int Co, int Ci, void* stream) {
  if (Co < 1 || Ci < 1) return (int)cudaErrorInvalidValue;
  const int Cop = cdiv(Co, kX3CoPad) * kX3CoPad;
  const long long total = (long long)cdiv(Ci, kX3Ci) * 27 * Cop * kX3Ci;
  const long long blocks = (total + 255) / 256;
  repack_x3_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                     (cudaStream_t)stream>>>(static_cast<const float*>(w),
                                             static_cast<float*>(wp), Co, Ci,
                                             Cop, total);
  return (int)cudaGetLastError();
}

// The f32 route: out [N, Co, D, H, W] f32 from x [N, Ci, D, H, W] f32 and
// wpx [2][Ci/8][27][Cop][8] (the split weight); part [P, N, Co, D*H*W] f32
// is scratch when P > 1. Tiling (td, th, tw, wm, P) as chosen by
// ops/cuda_conv.py:wide_x3_plan.
int k3_wide_x3(const void* x, const void* wp, void* part, void* out, int N,
               int Ci, int Co, int D, int H, int W, int td, int th, int tw,
               int wm, int P, void* stream) {
  Geom g;
  if (!make_geom(&g, N, Ci, Co, D, H, W, td, th, tw))
    return (int)cudaErrorInvalidValue;
  return launch_wide_x3(x, wp, part, out, g, wm, P, (cudaStream_t)stream);
}

// wp [Ci/16][27][Cop][16] bf16 (Cop = Co rounded up to 64) from w
// [Co, Ci, 3, 3, 3] bf16: the bf16 route's weight layout.
int k3_repack(const void* w, void* wp, int Co, int Ci, void* stream) {
  if (Co < 1 || Ci < 1) return (int)cudaErrorInvalidValue;
  const int Cop = cdiv(Co, kTcCoPad) * kTcCoPad;
  const long long total = (long long)cdiv(Ci, kTcCi) * 27 * Cop * kTcCi;
  const long long blocks = (total + 255) / 256;
  repack_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0,
                  (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wp),
      Co, Ci, Cop, total);
  return (int)cudaGetLastError();
}

// The bf16 route: out [N, Co, D, H, W] bf16 from x [N, Ci, D, H, W] bf16
// and wp [Ci/16][27][Cop][16] bf16 (the repacked weight); part
// [P, N, Co, D*H*W] f32 is scratch when P > 1. Tiling (td, th, tw, wm, P)
// as chosen by ops/cuda_conv.py:wide_tc_plan.
int k3_wide_tc(const void* x, const void* wp, void* part, void* out, int N,
               int Ci, int Co, int D, int H, int W, int td, int th, int tw,
               int wm, int P, void* stream) {
  Geom g;
  if (!make_geom(&g, N, Ci, Co, D, H, W, td, th, tw))
    return (int)cudaErrorInvalidValue;
  return launch_wide_tc(x, wp, part, out, g, wm, P, (cudaStream_t)stream);
}

// The f32 route of dW: dw [Co, Ci, 3, 3, 3] from x [N, Ci, D, H, W] and
// g [N, Co, D, H, W], all f32; part [P, Co, Ci, 27] (f32) is scratch when
// P > 1. Tiling (td, th, tw, P) as chosen by ops/cuda_conv.py:dw_x3_plan.
int k3_dw_x3(const void* x, const void* gr, void* part, void* dw, int N,
             int Ci, int Co, int D, int H, int W, int td, int th, int tw,
             int P, void* stream) {
  Geom g;
  if (!make_geom(&g, N, Ci, Co, D, H, W, td, th, tw))
    return (int)cudaErrorInvalidValue;
  return launch_dw_x3(x, gr, part, dw, g, P, (cudaStream_t)stream);
}

// The bf16 route of dW: dw [Co, Ci, 3, 3, 3] (f32) from x [N, Ci, D, H, W]
// and g [N, Co, D, H, W] (bf16); part [P, Co, 27, Ci] (f32) is scratch.
// Tiling (td, th, tw, P) as chosen by ops/cuda_conv.py:dw_tc_plan.
int k3_dw_tc(const void* x, const void* gr, void* part, void* dw, int N,
             int Ci, int Co, int D, int H, int W, int td, int th, int tw,
             int P, void* stream) {
  Geom g;
  if (!make_geom(&g, N, Ci, Co, D, H, W, td, th, tw))
    return (int)cudaErrorInvalidValue;
  return launch_dw_tc(x, gr, part, dw, g, P, (cudaStream_t)stream);
}

}  // extern "C"
