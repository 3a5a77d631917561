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
// work at 32ch@64^3, N=16, against 0.16 ms of bytes).
//
// What this design does about it. This is the first, simple version: f32
// FMAs on the CUDA cores, no tensor cores, so its ceiling is the 67 TF f32
// line, not the 989 TF bf16 one (wgmma tiles are later work). Within that:
// - wide: a block owns a box of output positions of one sample (td x th x
//   tw) and up to 32 output channels; it stages the box's input plus its
//   1-voxel halo, 4 input channels at a time, and those channels' weights
//   in shared memory as f32. The halo is masked (zero) at the volume's
//   edge, so nothing is padded or transposed in memory, unlike the TPU
//   path's jnp.pad and transposes (wide_conv.py:183-187). Each thread
//   keeps 8 channels x 4 rows of one column in registers (32 f32
//   accumulators): per (ci, kd, kw) it reads 6 inputs and 3 x 8 weights
//   (broadcast float4s) and does 96 FMAs. Small volumes halve the channel
//   groups per block until the grid has a block per SM (4^3, N=16 still
//   gets 128-256 blocks).
// - dW: the TPU accumulated dW in one f32 block revisited across its
//   sequential (N, D/dD) grid (dw_conv.py:161-167); on CUDA that is a
//   race. Here the (n, box) list is split into P chunks (split-K): a block
//   reduces one chunk for 32 output x 16 input channels x 27 taps into
//   registers (8 x 4 per thread, one tap) and writes f32 partials
//   [P, Co, Ci*27]; a second kernel sums the P partials in a fixed order.
//   No atomics, so a repeated dW is bit-identical. Per position a thread
//   reads 8 gradients and 4 inputs as three float4s and does 32 FMAs.
//
// Inputs are f32 or bf16 (dtype 0 / 1), the same for both operands; every
// accumulation is f32; the wide output takes the input's dtype, dW is f32.
// Any N, Ci, Co, D, H, W >= 1; ragged channel and spatial tiles are masked.
// The tiling is chosen by the caller (gan3d_tpu_torch/ops/cuda_conv.py).
// Each entry point returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRC = 8;       // wide: output channels per thread
constexpr int kRH = 4;       // wide: output rows (h) per thread
constexpr int kCiT = 4;      // wide: input channels per shared-memory stage
constexpr int kWideMaxThreads = 256;
constexpr int kDwCo = 32;    // dW: output channels per block
constexpr int kDwCi = 16;    // dW: input channels per block
constexpr int kDwThreads = 27 * (kDwCo / 8) * (kDwCi / 4);  // 432
constexpr int kGStride = kDwCo + 4;  // floats per position, g tile
constexpr int kXStride = kDwCi + 4;  // floats per position, x tile
constexpr int kReduceThreads = 256;
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

// A box of td x th x tw positions of one sample; boxes are numbered
// (n, bd, bh, bw), bw fastest.
struct Geom {
  int N, Ci, Co, D, H, W;
  int td, th, tw;
  int nbd, nbh, nbw;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// wide: grid (boxes, Co tiles of cg*8), block cg * td * (th/4) * tw threads.
// Shared memory: xs [kCiT][td+2][th+2][tw+2], then ws [kCiT][27][cg*8].
template <typename T>
__global__ void __launch_bounds__(kWideMaxThreads)
wide_kernel(const T* __restrict__ x, const T* __restrict__ w,
            T* __restrict__ out, Geom g, int cg) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int tco = cg * kRC;
  const int DB = g.td + 2, HB = g.th + 2, WB = g.tw + 2;
  const int plane = HB * WB;
  const int halo = DB * plane;
  float* ws = xs + ((kCiT * halo + 3) & ~3);

  int b = blockIdx.x;
  const int bw = b % g.nbw; b /= g.nbw;
  const int bh = b % g.nbh; b /= g.nbh;
  const int bd = b % g.nbd;
  const int n = b / g.nbd;
  const int d0 = bd * g.td, h0 = bh * g.th, w0 = bw * g.tw;
  const int co0 = blockIdx.y * tco;

  const int hgs = g.th / kRH;
  const int per_cg = g.td * hgs * g.tw;
  const int t = threadIdx.x;
  const int cgi = t / per_cg;
  int r = t - cgi * per_cg;
  const int wl = r % g.tw; r /= g.tw;
  const int hg = r % hgs;
  const int dl = r / hgs;

  const long long HW = (long long)g.H * g.W;
  const long long DHW = HW * g.D;
  const T* xn = x + (long long)n * g.Ci * DHW;

  float acc[kRC][kRH];
#pragma unroll
  for (int o = 0; o < kRC; ++o)
#pragma unroll
    for (int j = 0; j < kRH; ++j) acc[o][j] = 0.f;

  for (int ci0 = 0; ci0 < g.Ci; ci0 += kCiT) {
    __syncthreads();
    for (int i = t; i < kCiT * halo; i += blockDim.x) {
      int q = i;
      const int ww = q % WB; q /= WB;
      const int hh = q % HB; q /= HB;
      const int dd = q % DB;
      const int c = q / DB;
      const int gd = d0 + dd - 1, gh = h0 + hh - 1, gw = w0 + ww - 1;
      float v = 0.f;
      if (ci0 + c < g.Ci && gd >= 0 && gd < g.D && gh >= 0 && gh < g.H &&
          gw >= 0 && gw < g.W)
        v = to_f32(xn[(ci0 + c) * DHW + gd * HW + (long long)gh * g.W + gw]);
      xs[i] = v;
    }
    for (int i = t; i < tco * kCiT * 27; i += blockDim.x) {
      const int tap = i % 27;
      const int c = (i / 27) % kCiT;
      const int col = i / (27 * kCiT);
      const int co = co0 + col, ci = ci0 + c;
      float v = 0.f;
      if (co < g.Co && ci < g.Ci)
        v = to_f32(w[((long long)co * g.Ci + ci) * 27 + tap]);
      ws[(c * 27 + tap) * tco + col] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int c = 0; c < kCiT; ++c) {
      const float* xc = xs + c * halo + dl * plane + hg * kRH * WB + wl;
      const float* wc = ws + c * 27 * tco + cgi * kRC;
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          float xv[kRH + 2];
#pragma unroll
          for (int q = 0; q < kRH + 2; ++q)
            xv[q] = xc[kd * plane + q * WB + kw];
#pragma unroll
          for (int kh = 0; kh < 3; ++kh) {
            const float4* wp = reinterpret_cast<const float4*>(
                wc + (kd * 9 + kh * 3 + kw) * tco);
            const float4 wa = wp[0], wb = wp[1];
            const float wv[kRC] = {wa.x, wa.y, wa.z, wa.w,
                                   wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int o = 0; o < kRC; ++o)
#pragma unroll
              for (int j = 0; j < kRH; ++j)
                acc[o][j] = fmaf(wv[o], xv[j + kh], acc[o][j]);
          }
        }
      }
    }
  }

  const int d = d0 + dl, wq = w0 + wl;
  if (d >= g.D || wq >= g.W) return;
#pragma unroll
  for (int o = 0; o < kRC; ++o) {
    const int co = co0 + cgi * kRC + o;
    if (co >= g.Co) break;
    T* on = out + ((long long)n * g.Co + co) * DHW + d * HW + wq;
#pragma unroll
    for (int j = 0; j < kRH; ++j) {
      const int h = h0 + hg * kRH + j;
      if (h < g.H) on[(long long)h * g.W] = from_f32<T>(acc[o][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// dW partials: grid (P, Ci tiles of 16, Co tiles of 32), kDwThreads threads.
// Block p reduces boxes [nboxes*p/P, nboxes*(p+1)/P) into
// part[p][co][ci*27 + tap]. Shared memory: gs [box][kGStride], then
// xs [td+2][th+2][tw+2][kXStride].
template <typename T>
__global__ void __launch_bounds__(kDwThreads)
dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                  float* __restrict__ part, Geom g, int P) {
  extern __shared__ float4 smem4[];
  float* gs = reinterpret_cast<float*>(smem4);
  const int box = g.td * g.th * g.tw;
  float* xs = gs + box * kGStride;
  const int HB = g.th + 2, WB = g.tw + 2;
  const int halo = (g.td + 2) * HB * WB;

  const int p = blockIdx.x;
  const int ci0 = blockIdx.y * kDwCi, co0 = blockIdx.z * kDwCo;
  const int t = threadIdx.x;
  const int cig = t % (kDwCi / 4);
  const int cog = (t / (kDwCi / 4)) % (kDwCo / 8);
  const int tap = t / ((kDwCi / 4) * (kDwCo / 8));
  const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
  const int toff = (kd * HB + kh) * WB + kw;

  const long long HW = (long long)g.H * g.W;
  const long long DHW = HW * g.D;
  const long long nboxes = (long long)g.N * g.nbd * g.nbh * g.nbw;
  const long long b_begin = nboxes * p / P, b_end = nboxes * (p + 1) / P;

  float acc[8][4];
#pragma unroll
  for (int o = 0; o < 8; ++o)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[o][i] = 0.f;

  for (long long b = b_begin; b < b_end; ++b) {
    long long q = b;
    const int bw = (int)(q % g.nbw); q /= g.nbw;
    const int bh = (int)(q % g.nbh); q /= g.nbh;
    const int bd = (int)(q % g.nbd);
    const int n = (int)(q / g.nbd);
    const int d0 = bd * g.td, h0 = bh * g.th, w0 = bw * g.tw;
    __syncthreads();
    // g tile, positions fastest across threads: coalesced reads, and a
    // 36-float row stride keeps the float4 stores free of bank conflicts
    const T* gn = gr + (long long)n * g.Co * DHW;
    for (int i = t; i < box * (kDwCo / 4); i += blockDim.x) {
      const int s = i % box, c4 = i / box;
      const int wl = s % g.tw, hl = (s / g.tw) % g.th, dl = s / (g.tw * g.th);
      const int gd = d0 + dl, gh = h0 + hl, gw = w0 + wl;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (gd < g.D && gh < g.H && gw < g.W) {
        const T* src = gn + gd * HW + (long long)gh * g.W + gw;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int co = co0 + c4 * 4 + j;
          if (co < g.Co) v[j] = to_f32(src[co * DHW]);
        }
      }
      *reinterpret_cast<float4*>(gs + s * kGStride + c4 * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    // x tile with its halo, masked to zero outside the volume
    const T* xn = x + (long long)n * g.Ci * DHW;
    for (int i = t; i < halo * (kDwCi / 4); i += blockDim.x) {
      const int hp = i % halo, c4 = i / halo;
      const int ww = hp % WB, hh = (hp / WB) % HB, dd = hp / (WB * HB);
      const int gd = d0 + dd - 1, gh = h0 + hh - 1, gw = w0 + ww - 1;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (gd >= 0 && gd < g.D && gh >= 0 && gh < g.H && gw >= 0 &&
          gw < g.W) {
        const T* src = xn + gd * HW + (long long)gh * g.W + gw;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ci = ci0 + c4 * 4 + j;
          if (ci < g.Ci) v[j] = to_f32(src[ci * DHW]);
        }
      }
      *reinterpret_cast<float4*>(xs + hp * kXStride + c4 * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    int s = 0;
    for (int dl = 0; dl < g.td; ++dl) {
      for (int hl = 0; hl < g.th; ++hl, s += g.tw) {
        const float* xrow =
            xs + ((dl * HB + hl) * WB + toff) * kXStride + cig * 4;
        const float* grow = gs + s * kGStride + cog * 8;
#pragma unroll 4
        for (int wl = 0; wl < g.tw; ++wl) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xrow + wl * kXStride);
          const float4 ga =
              *reinterpret_cast<const float4*>(grow + wl * kGStride);
          const float4 gb =
              *reinterpret_cast<const float4*>(grow + wl * kGStride + 4);
          const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
          const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int o = 0; o < 8; ++o)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[o][i] = fmaf(gv[o], xa[i], acc[o][i]);
        }
      }
    }
  }

  const long long row = (long long)g.Ci * 27;
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const int co = co0 + cog * 8 + o;
    if (co >= g.Co) break;
    float* dst = part + ((long long)p * g.Co + co) * row + tap;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ci = ci0 + cig * 4 + i;
      if (ci < g.Ci) dst[(long long)ci * 27] = acc[o][i];
    }
  }
}

// dw[j] = sum_{p = 0 .. P-1} part[p][j], in that order.
__global__ void dw_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ dw, int P, long long M) {
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < M;
       j += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += part[(long long)p * M + j];
    dw[j] = s;
  }
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

template <typename T>
int launch_wide(const void* x, const void* w, void* out, const Geom& g,
                int cg, cudaStream_t st) {
  const int threads = cg * g.td * (g.th / kRH) * g.tw;
  if (cg < 1 || g.th % kRH != 0 || threads > kWideMaxThreads)
    return (int)cudaErrorInvalidValue;
  const int halo = (g.td + 2) * (g.th + 2) * (g.tw + 2);
  const size_t smem =
      sizeof(float) * (((kCiT * halo + 3) & ~3) + kCiT * 27 * cg * kRC);
  if (!set_smem(wide_kernel<T>, smem)) return (int)cudaErrorInvalidValue;
  const long long boxes = (long long)g.N * g.nbd * g.nbh * g.nbw;
  const int co_tiles = cdiv(g.Co, cg * kRC);
  if (boxes > 0x7fffffffLL || co_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  wide_kernel<T><<<dim3((unsigned)boxes, co_tiles), threads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), g, cg);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw(const void* x, const void* gr, void* part, void* dw,
              const Geom& g, int P, cudaStream_t st) {
  const long long boxes = (long long)g.N * g.nbd * g.nbh * g.nbw;
  const int ci_tiles = cdiv(g.Ci, kDwCi), co_tiles = cdiv(g.Co, kDwCo);
  if (P < 1 || P > boxes || ci_tiles > 65535 || co_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const int box = g.td * g.th * g.tw;
  const int halo = (g.td + 2) * (g.th + 2) * (g.tw + 2);
  const size_t smem = sizeof(float) * (box * kGStride + halo * kXStride);
  if (!set_smem(dw_partial_kernel<T>, smem)) return (int)cudaErrorInvalidValue;
  dw_partial_kernel<T><<<dim3(P, ci_tiles, co_tiles), kDwThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(gr),
      static_cast<float*>(part), g, P);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)g.Co * g.Ci * 27;
  const long long blocks = (M + kReduceThreads - 1) / kReduceThreads;
  dw_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096),
                     kReduceThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), P, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out [N, Co, D, H, W] from x [N, Ci, D, H, W] and w [Co, Ci, 3, 3, 3];
// tiling (td, th, tw, cg) as chosen by ops/cuda_conv.py:wide_plan.
int k3_wide(const void* x, const void* w, void* out, int N, int Ci, int Co,
            int D, int H, int W, int td, int th, int tw, int cg, int dtype,
            void* stream) {
  Geom g;
  if (!make_geom(&g, N, Ci, Co, D, H, W, td, th, tw))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_wide<float>(x, w, out, g, cg, st);
  if (dtype == 1) return launch_wide<__nv_bfloat16>(x, w, out, g, cg, st);
  return (int)cudaErrorInvalidValue;
}

// dw [Co, Ci, 3, 3, 3] (f32) from x [N, Ci, D, H, W] and g [N, Co, D, H, W];
// part [P, Co, Ci*27] (f32) is scratch. Tiling (td, th, tw, P) as chosen
// by ops/cuda_conv.py:dw_plan.
int k3_dw(const void* x, const void* gr, void* part, void* dw, int N, int Ci,
          int Co, int D, int H, int W, int td, int th, int tw, int P,
          int dtype, void* stream) {
  Geom g;
  if (!make_geom(&g, N, Ci, Co, D, H, W, td, th, tw))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch_dw<float>(x, gr, part, dw, g, P, st);
  if (dtype == 1) return launch_dw<__nv_bfloat16>(x, gr, part, dw, g, P, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
