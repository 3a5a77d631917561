// Pooled-KV attention, forward and backward, for Hopper (sm_90a).
//
//   o = softmax(q k^T) v        q [N, L, C], k/v [N, M, C], unscaled scores
//
// Replaces the TPU kernels of gan3d_tpu/ops/pallas_attention.py:
//   forward  -> _fwd_kernel (line 28, pallas_call at line 50)
//   backward -> _bwd_kernel (line 67, pallas_call at line 135)
//
// What bounds it on this card. C is small (ch/8: 16 in the 64^3 BigGAN G,
// 32 in its D), so each score costs 2C multiply-adds in the product and one
// exponential in the softmax. At the G placement (N=16, L=32768, M=4096) a
// forward is 2.1 G exponentials, 137 GFLOP of products and ~38 MB of
// traffic: the special-function unit (one exp per score) is the ceiling,
// then the products; memory is far below both. The TPU kernel was
// softmax-bound for the same reason.
//
// What this design does about it. This is the first, simple version: one
// thread owns one query row (forward, dq) or one key row (dk/dv) and keeps
// its C-wide operand and accumulators in registers in f32; the other side
// streams through shared memory in tiles that every thread of the block
// reads by broadcast. Exponentials are exp2 of log2-scaled scores (one
// MUFU op each). Products run on the f32 FMA pipes, not the tensor cores,
// so the kernel sits well above the exp bound; tensor-core tiles (mma.sync
// or wgmma) are the next step.
//
// Differences from the TPU kernel:
// - The TPU kept all M keys of a sample resident in VMEM and did one
//   softmax pass. K and V at M=4096 do not fit beside a useful query tile
//   in 227 KB of shared memory, so the forward streams K/V tiles with a
//   running max and sum (online softmax) and writes the row's logsumexp
//   lse [N, L] (natural log, f32) for the backward.
// - The TPU backward accumulated dk/dv across query blocks into one
//   revisited output block, which relies on its sequential grid. Here the
//   backward is the FlashAttention-2 split, with no atomics and a fixed
//   summation order: a dq kernel (one thread per query; its prologue also
//   writes delta_i = sum_c dO_i * O_i, the JAX kernel's `dsum`), then a
//   dk/dv kernel (one thread per key) that loops over every query of its
//   sample. Both get p from the saved lse instead of a second softmax pass.
//
// Inputs are f32 or bf16 (dtype 0 / 1); every accumulation is f32; outputs
// take the inputs' dtype. C is one of 8, 16, 32, 64. Ragged L and M tails
// are masked. Each entry point returns cudaGetLastError() after its
// launches, or cudaErrorInvalidValue for a C or dtype it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

constexpr int kFwdThreads = 128;  // query rows per forward block
constexpr int kKvTile = 64;       // keys per shared-memory tile
constexpr int kChunk = 16;        // keys per online-softmax rescale
constexpr int kDqThreads = 128;   // query rows per dq block
constexpr int kDkvThreads = 64;   // key rows per dk/dv block
constexpr int kQTile = 64;        // queries per shared-memory tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy rows [row0, row0 + nrows) of a [rows, C] matrix into a [tile, C]
// f32 shared-memory tile, zero-filling the rows past nrows.
template <typename T, int C, int TILE>
__device__ __forceinline__ void load_tile(float (*dst)[C], const T* src,
                                          int row0, int nrows) {
  for (int idx = threadIdx.x; idx < TILE * C; idx += blockDim.x) {
    const int r = idx / C;
    dst[r][idx % C] =
        r < nrows ? to_f32(src[(size_t)(row0 + r) * C + idx % C]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// forward: one thread per query row; K/V tiles streamed, online softmax.
// grid (ceil(L / kFwdThreads), N)
// ---------------------------------------------------------------------------
template <typename T, int C>
__global__ void __launch_bounds__(kFwdThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int L, int M) {
  __shared__ __align__(16) float ks[kKvTile][C];
  __shared__ __align__(16) float vs[kKvTile][C];
  const int n = blockIdx.y;
  const int i = blockIdx.x * kFwdThreads + threadIdx.x;
  const bool active = i < L;
  const T* kn = k + (size_t)n * M * C;
  const T* vn = v + (size_t)n * M * C;

  float qr[C], acc[C];
  const T* qi = q + ((size_t)n * L + (active ? i : 0)) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    qr[c] = to_f32(qi[c]) * kLog2e;  // scores in log2 units
    acc[c] = 0.f;
  }
  float mx = -INFINITY;  // running max (log2 units)
  float den = 0.f;       // running sum of exp2(s - mx)

  for (int j0 = 0; j0 < M; j0 += kKvTile) {
    const int nt = min(kKvTile, M - j0);
    __syncthreads();
    load_tile<T, C, kKvTile>(ks, kn, j0, nt);
    load_tile<T, C, kKvTile>(vs, vn, j0, nt);
    __syncthreads();
    for (int jc = 0; jc < nt; jc += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) d = fmaf(qr[c], ks[jc + jj][c], d);
        s[jj] = (jc + jj < nt) ? d : -INFINITY;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float mnew = fmaxf(mx, cmax);  // finite: every chunk has a key
      const float scale = exp2f(mx - mnew);
      den *= scale;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] *= scale;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = exp2f(s[jj] - mnew);
        den += p;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = fmaf(p, vs[jc + jj][c], acc[c]);
      }
      mx = mnew;
    }
  }
  if (active) {
    const float inv = 1.f / den;
    T* oi = o + ((size_t)n * L + i) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) oi[c] = from_f32<T>(acc[c] * inv);
    lse[(size_t)n * L + i] = (mx + log2f(den)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// backward, dq: one thread per query row. Prologue writes delta_i.
//   p = exp(s - lse);  dp = dO . v;  ds = p (dp - delta);  dq = sum ds k
// grid (ceil(L / kDqThreads), N)
// ---------------------------------------------------------------------------
template <typename T, int C>
__global__ void __launch_bounds__(kDqThreads)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  T* __restrict__ dq, float* __restrict__ delta, int L,
                  int M) {
  __shared__ __align__(16) float ks[kKvTile][C];
  __shared__ __align__(16) float vs[kKvTile][C];
  const int n = blockIdx.y;
  const int i = blockIdx.x * kDqThreads + threadIdx.x;
  const bool active = i < L;
  const size_t row = (size_t)n * L + (active ? i : 0);
  const T* kn = k + (size_t)n * M * C;
  const T* vn = v + (size_t)n * M * C;

  float qr[C], dor[C], acc[C];
  float dlt = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    qr[c] = to_f32(q[row * C + c]) * kLog2e;
    dor[c] = to_f32(dout[row * C + c]);
    dlt = fmaf(dor[c], to_f32(o[row * C + c]), dlt);
    acc[c] = 0.f;
  }
  const float lse2 = lse[row] * kLog2e;
  if (active) delta[row] = dlt;

  for (int j0 = 0; j0 < M; j0 += kKvTile) {
    const int nt = min(kKvTile, M - j0);
    __syncthreads();
    load_tile<T, C, kKvTile>(ks, kn, j0, nt);
    load_tile<T, C, kKvTile>(vs, vn, j0, nt);
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s = fmaf(qr[c], ks[j][c], s);
        dp = fmaf(dor[c], vs[j][c], dp);
      }
      const float ds = exp2f(s - lse2) * (dp - dlt);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = fmaf(ds, ks[j][c], acc[c]);
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < C; ++c) dq[row * C + c] = from_f32<T>(acc[c]);
  }
}

// ---------------------------------------------------------------------------
// backward, dk/dv: one thread per key row, looping over every query.
//   dv = sum p dO;  dk = sum ds q
// grid (ceil(M / kDkvThreads), N)
// ---------------------------------------------------------------------------
template <typename T, int C>
__global__ void __launch_bounds__(kDkvThreads)
    bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int L, int M) {
  __shared__ __align__(16) float qs[kQTile][C];
  __shared__ __align__(16) float dos[kQTile][C];
  __shared__ float lse2s[kQTile];
  __shared__ float dlts[kQTile];
  const int n = blockIdx.y;
  const int j = blockIdx.x * kDkvThreads + threadIdx.x;
  const bool active = j < M;
  const size_t row = (size_t)n * M + (active ? j : 0);
  const T* qn = q + (size_t)n * L * C;
  const T* dn = dout + (size_t)n * L * C;

  float kr[C], vr[C], dka[C], dva[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    kr[c] = to_f32(k[row * C + c]) * kLog2e;
    vr[c] = to_f32(v[row * C + c]);
    dka[c] = 0.f;
    dva[c] = 0.f;
  }

  for (int i0 = 0; i0 < L; i0 += kQTile) {
    const int nt = min(kQTile, L - i0);
    __syncthreads();
    load_tile<T, C, kQTile>(qs, qn, i0, nt);
    load_tile<T, C, kQTile>(dos, dn, i0, nt);
    for (int r = threadIdx.x; r < kQTile; r += blockDim.x) {
      lse2s[r] = r < nt ? lse[(size_t)n * L + i0 + r] * kLog2e : 0.f;
      dlts[r] = r < nt ? delta[(size_t)n * L + i0 + r] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < nt; ++r) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s = fmaf(qs[r][c], kr[c], s);
        dp = fmaf(dos[r][c], vr[c], dp);
      }
      const float p = exp2f(s - lse2s[r]);
      const float ds = p * (dp - dlts[r]);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dva[c] = fmaf(p, dos[r][c], dva[c]);
        dka[c] = fmaf(ds, qs[r][c], dka[c]);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[row * C + c] = from_f32<T>(dka[c]);
      dv[row * C + c] = from_f32<T>(dva[c]);
    }
  }
}

template <typename T, int C>
void launch_fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int N, int L, int M, cudaStream_t st) {
  dim3 grid((L + kFwdThreads - 1) / kFwdThreads, N);
  fwd_kernel<T, C><<<grid, kFwdThreads, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, L, M);
}

template <typename T, int C>
void launch_bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* dq, void* dk,
                void* dv, void* delta, int N, int L, int M, cudaStream_t st) {
  dim3 gq((L + kDqThreads - 1) / kDqThreads, N);
  bwd_dq_kernel<T, C><<<gq, kDqThreads, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
      (const float*)lse, (T*)dq, (float*)delta, L, M);
  dim3 gk((M + kDkvThreads - 1) / kDkvThreads, N);
  bwd_dkdv_kernel<T, C><<<gk, kDkvThreads, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, L, M);
}

// Instantiate F<T, C> for the supported (dtype, C) pairs; false otherwise.
#define PA_DISPATCH(DTYPE, C, CALL)                          \
  [&]() -> bool {                                            \
    switch ((DTYPE) * 1000 + (C)) {                          \
      case 8: { using T = float; constexpr int CC = 8; CALL; return true; }      \
      case 16: { using T = float; constexpr int CC = 16; CALL; return true; }    \
      case 32: { using T = float; constexpr int CC = 32; CALL; return true; }    \
      case 64: { using T = float; constexpr int CC = 64; CALL; return true; }    \
      case 1008: { using T = __nv_bfloat16; constexpr int CC = 8; CALL; return true; }  \
      case 1016: { using T = __nv_bfloat16; constexpr int CC = 16; CALL; return true; } \
      case 1032: { using T = __nv_bfloat16; constexpr int CC = 32; CALL; return true; } \
      case 1064: { using T = __nv_bfloat16; constexpr int CC = 64; CALL; return true; } \
      default: return false;                                 \
    }                                                        \
  }()

}  // namespace

extern "C" {

// o [N, L, C] and lse [N, L] (f32) from q [N, L, C], k/v [N, M, C].
int pa_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
           int N, int L, int M, int C, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!PA_DISPATCH(dtype, C, (launch_fwd<T, CC>(q, k, v, o, lse, N, L, M, st))))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dq, dk, dv from the forward's inputs, o, lse and dO. delta [N, L] (f32)
// is scratch written by the dq kernel and read by the dk/dv kernel.
int pa_bwd(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* delta, int N, int L, int M, int C, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!PA_DISPATCH(dtype, C, (launch_bwd<T, CC>(q, k, v, o, dout, lse, dq, dk,
                                                dv, delta, N, L, M, st))))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
