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
// - Simple first: f32 FMAs on the CUDA cores (ceiling 67 TF), no tensor
//   cores. W is tiled by the kernel's own rule; the TPU's tile T only has to
//   divide W and is checked by the caller.
//
// Inputs are f32 or bf16 (dtype 0 / 1), the same for x and w; accumulation
// is f32; out takes x's dtype. Any N, D, H, W, Ci, Co >= 1; ragged tiles
// are masked. The tiling (bh, wg, cg) is chosen by the caller
// (gan3d_tpu_torch/ops/cuda_conv.py:toeplitz_plan). The entry point returns
// cudaGetLastError() after its launch, or cudaErrorInvalidValue for
// arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRW = 4;        // output columns (w) per thread
constexpr int kRC = 8;        // output channels per thread
constexpr int kCi = 8;        // input channels per shared-memory stage
constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
toeplitz_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, Geom g) {
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
        v = to_f32(x[pos * g.Ci + ci0 + c]);
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
        v = to_f32(w[((long long)tap * g.Ci + ci) * g.Co + co]);
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
    T* op = out + (row + wq) * g.Co;
#pragma unroll
    for (int o = 0; o < kRC; ++o) {
      const int co = co0 + cog * kRC + o;
      if (co < g.Co) op[co] = from_f32<T>(acc[o][j]);
    }
  }
}

template <typename T>
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
      cudaFuncSetAttribute(toeplitz_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)g.N * g.D * g.nbh * g.nbw;
  const int co_tiles = cdiv(g.Co, g.cg * kRC);
  if (blocks > 0x7fffffffLL || co_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  toeplitz_kernel<T><<<dim3((unsigned)blocks, co_tiles), threads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out [N, D, H, W, Co] from x [N, D, H, W, Ci] and w [3, 3, 3, Ci, Co];
// tiling (bh, wg, cg) as chosen by ops/cuda_conv.py:toeplitz_plan.
int k3_toeplitz(const void* x, const void* w, void* out, int N, int D, int H,
                int W, int Ci, int Co, int bh, int wg, int cg, int dtype,
                void* stream) {
  if (N < 1 || D < 1 || H < 1 || W < 1 || Ci < 1 || Co < 1 || bh < 1 ||
      wg < 1 || cg < 1)
    return (int)cudaErrorInvalidValue;
  const Geom g{N, D, H, W, Ci, Co, bh, wg, cg, cdiv(H, bh), cdiv(W, wg * kRW)};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, w, out, g, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, g, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
