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
// bf16 tensor-core work (989 TF) or 3.46 ms of f32 (67 TF), against 0.080 ms
// for the bf16 bytes at 3.35 TB/s. The arithmetic bounds it.
//
// What the TPU kernel did and what this one does instead. The TPU kernel
// read a pre-tiled, pre-padded copy of x in HBM (tile_input, ~1.5x the
// input's bytes) and a Toeplitz weight B that is (T+2)/3 times larger than
// w and mostly zeros, so that each of its 9 per-slab matmuls fed all 128
// MXU lanes; it double-buffered a 3-row slab by manual DMA. On Hopper none
// of that is needed: this kernel reads x and w as they are.
// - A block owns one (n, d), bh rows of H, a run of BW = wg*4 columns of W
//   and cg*8 output channels. Per chunk of kCi input channels it stages the
//   3-row slab x[n, d-1..d+1, h0-1..h0+bh, w0-1..w0+BW] (the halo masked to
//   zero at the volume's edge: no padded copy) and the chunk's weights
//   [kCi][27][cg*8] in shared memory, as f32.
// - Each thread keeps 4 consecutive W outputs x 8 output channels in
//   registers (32 f32 accumulators). Per (ci, a, b) it reads the 6 inputs
//   its 4 outputs need (a float4 and a float2) and 3 x 8 weights (broadcast
//   float4s) and does 96 FMAs: 6 input loads serve 3 taps of 4 outputs,
//   the reuse the Toeplitz weight bought on the TPU.
// - This is the f32 route: f32 FMAs on the CUDA cores (ceiling 67 TF;
//   tensor cores would run f32 as TF32, outside the f32 tolerance).
// - The bf16 route, toeplitz_tc_kernel below, is an implicit GEMM on the
//   tensor cores (mma.sync m16n8k16, bf16 operands, f32 sums: the TPU
//   kernel's rounding, pallas_conv.py:105-112); see its comment.
// W is tiled by the kernels' own rule; the TPU's tile T only has to divide
// W and is checked by the caller.
//
// Inputs are f32 (toeplitz) or bf16 (toeplitz_tc), the same for x and w;
// accumulation is f32; out takes x's dtype. Any N, D, H, W, Ci, Co >= 1;
// ragged tiles are masked. The tilings are chosen by the caller
// (gan3d_tpu_torch/ops/cuda_conv.py: toeplitz_plan, toeplitz_tc_plan).
// Each entry point returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kRW = 4;        // output columns (w) per thread
constexpr int kRC = 8;        // output channels per thread
constexpr int kCi = 8;        // input channels per shared-memory stage
constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 227 * 1024;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Geom {
  int N, D, H, W, Ci, Co;
  int bh, wg, cg;   // rows, column groups (of kRW), channel groups (of kRC)
  int nbh, nbw;     // row and column tiles per (n, d)
};

// Shared-memory row of the staged slab: BW + 2 halo columns, rounded up to
// a multiple of 4 so that each thread's float4 is aligned.
__host__ __device__ inline int row_stride(int bw) { return (bw + 2 + 3) & ~3; }

// grid (N*D*nbh*nbw, Co tiles of cg*8), block cg * wg * bh threads.
// Shared memory: xs [kCi][3][bh+2][row_stride], then ws [kCi][27][cg*8].
__global__ void __launch_bounds__(kMaxThreads)
toeplitz_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, Geom g) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int bw = g.wg * kRW;
  const int rs = row_stride(bw);
  const int HB = g.bh + 2;
  const int slab = 3 * HB * rs;            // floats per staged channel
  float* ws = xs + kCi * slab;
  const int tco = g.cg * kRC;

  int b = blockIdx.x;
  const int bwi = b % g.nbw; b /= g.nbw;
  const int bhi = b % g.nbh; b /= g.nbh;
  const int d = b % g.D;
  const int n = b / g.D;
  const int h0 = bhi * g.bh, w0 = bwi * bw;
  const int co0 = blockIdx.y * tco;

  const int t = threadIdx.x;
  const int cog = t % g.cg;
  const int wgi = (t / g.cg) % g.wg;
  const int hl = t / (g.cg * g.wg);

  float acc[kRC][kRW];
#pragma unroll
  for (int o = 0; o < kRC; ++o)
#pragma unroll
    for (int j = 0; j < kRW; ++j) acc[o][j] = 0.f;

  const int nstage = 3 * HB * (bw + 2);
  for (int ci0 = 0; ci0 < g.Ci; ci0 += kCi) {
    __syncthreads();
    // the slab, input channels fastest across threads (coalesced reads)
    for (int i = t; i < kCi * nstage; i += blockDim.x) {
      const int c = i % kCi;
      int q = i / kCi;
      const int ww = q % (bw + 2); q /= bw + 2;
      const int hh = q % HB;
      const int a = q / HB;
      const int gd = d + a - 1, gh = h0 + hh - 1, gw = w0 + ww - 1;
      float v = 0.f;
      if (ci0 + c < g.Ci && gd >= 0 && gd < g.D && gh >= 0 && gh < g.H &&
          gw >= 0 && gw < g.W) {
        const long long pos =
            (((long long)n * g.D + gd) * g.H + gh) * g.W + gw;
        v = x[pos * g.Ci + ci0 + c];
      }
      xs[c * slab + (a * HB + hh) * rs + ww] = v;
    }
    // the chunk's weights, output channels fastest
    for (int i = t; i < kCi * 27 * tco; i += blockDim.x) {
      const int col = i % tco;
      const int tap = (i / tco) % 27;
      const int c = i / (tco * 27);
      const int co = co0 + col, ci = ci0 + c;
      float v = 0.f;
      if (co < g.Co && ci < g.Ci)
        v = w[((long long)tap * g.Ci + ci) * g.Co + co];
      ws[(c * 27 + tap) * tco + col] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < kCi; ++c) {
      const float* xc = xs + c * slab + hl * rs + wgi * kRW;
      const float* wc = ws + c * 27 * tco + cog * kRC;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int bb = 0; bb < 3; ++bb) {
          const float* xr = xc + (a * HB + bb) * rs;
          const float4 p = *reinterpret_cast<const float4*>(xr);
          const float2 q = *reinterpret_cast<const float2*>(xr + 4);
          const float xv[kRW + 2] = {p.x, p.y, p.z, p.w, q.x, q.y};
#pragma unroll
          for (int cc = 0; cc < 3; ++cc) {
            const float4* wp = reinterpret_cast<const float4*>(
                wc + (a * 9 + bb * 3 + cc) * tco);
            const float4 wa = wp[0], wb = wp[1];
            const float wv[kRC] = {wa.x, wa.y, wa.z, wa.w,
                                   wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int o = 0; o < kRC; ++o)
#pragma unroll
              for (int j = 0; j < kRW; ++j)
                acc[o][j] = fmaf(wv[o], xv[j + cc], acc[o][j]);
          }
        }
      }
    }
  }

  const int h = h0 + hl;
  if (h >= g.H) return;
  const long long row = (((long long)n * g.D + d) * g.H + h) * g.W;
#pragma unroll
  for (int j = 0; j < kRW; ++j) {
    const int wq = w0 + wgi * kRW + j;
    if (wq >= g.W) break;
    float* op = out + (row + wq) * g.Co;
#pragma unroll
    for (int o = 0; o < kRC; ++o) {
      const int co = co0 + cog * kRC + o;
      if (co < g.Co) op[co] = acc[o][j];
    }
  }
}

int launch(const void* x, const void* w, void* out, const Geom& g,
           cudaStream_t st) {
  const int threads = g.cg * g.wg * g.bh;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const int bw = g.wg * kRW;
  const size_t smem = sizeof(float) * ((size_t)kCi * 3 * (g.bh + 2) *
                                           row_stride(bw) +
                                       (size_t)kCi * 27 * g.cg * kRC);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(toeplitz_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)g.N * g.D * g.nbh * g.nbw;
  const int co_tiles = cdiv(g.Co, g.cg * kRC);
  if (blocks > 0x7fffffffLL || co_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  toeplitz_kernel<<<dim3((unsigned)blocks, co_tiles), threads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

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

// The f32 route: out [N, D, H, W, Co] from x [N, D, H, W, Ci] and w
// [3, 3, 3, Ci, Co], all f32; tiling (bh, wg, cg) as chosen by
// ops/cuda_conv.py:toeplitz_plan.
int k3_toeplitz(const void* x, const void* w, void* out, int N, int D, int H,
                int W, int Ci, int Co, int bh, int wg, int cg, void* stream) {
  if (N < 1 || D < 1 || H < 1 || W < 1 || Ci < 1 || Co < 1 || bh < 1 ||
      wg < 1 || cg < 1)
    return (int)cudaErrorInvalidValue;
  const Geom g{N, D, H, W, Ci, Co, bh, wg, cg, cdiv(H, bh), cdiv(W, wg * kRW)};
  return launch(x, w, out, g, (cudaStream_t)stream);
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
