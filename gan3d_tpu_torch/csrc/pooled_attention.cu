// Pooled-KV attention, forward and backward, for Hopper (sm_90a).
//
//   o = softmax(q k^T) v        q [N, L, C], k/v [N, M, C], unscaled scores
//
// Replaces the TPU kernels of gan3d_tpu/ops/pallas_attention.py:
//   forward  -> _fwd_kernel (line 28, pallas_call at line 50)
//   backward -> _bwd_kernel (line 67, pallas_call at line 135)
//
// What bounds it on this card. C is small (ch/8: 16 in the 64^3 BigGAN G,
// 32 in its D, 64 and 128 in the 128^3 model's), so each score costs 2C
// multiply-adds in each product and one exponential in the softmax. At
// the G placement (N=16, L=32768, M=4096) a forward is 2.1 G
// exponentials, 137 GFLOP of products and ~38 MB of traffic: the
// special-function unit (one exp per score) and the products are the
// ceilings; memory is far below both. The TPU kernel was softmax-bound
// for the same reason.
//
// What the designs do about it. Exponentials are exp2 of log2-scaled
// scores (one MUFU op each). Both products run on the tensor cores, and
// the forward (K1) and the backward (K2) each have two routes, picked by
// dtype in ops/cuda_attention.py, one design for both:
// - bf16: the *_tc kernels, mma.sync m16n8k16 (16 rows a warp), so the
//   exponentials are the ceiling.
// - f32: the *_tf32x3 kernels, mma.sync m16n8k8 in 3xTF32 (mma_tf32.cuh):
//   each f32 operand split into two TF32 halves, three products a term,
//   about 21 significant bits a product against TF32's 11, so the route
//   keeps its f32 contract (1e-4 of the largest value; plain TF32 would
//   not). What bounds them: the split (two roundings and a subtraction a
//   value, redone by every warp that reads it) and the three products
//   (165 TF of f32-accurate products against the FMA pipes' 67); the
//   exponentials come third at c >= 16. Operands are staged in f32 and
//   split where they are read, so no tile is held twice.
// The forward is the FlashAttention-2 forward (fwd_tc_kernel,
// fwd_tf32x3_kernel, below); the dk/dv pass of the backward splits L into
// P parts where M alone gives too few blocks (the D placements: at the
// 128^3 D, 16 x 4 key blocks of the f32 route against 132 SMs, so 5
// parts), summing f32 partials in a fixed order; at C = 128 the bf16
// route also splits the columns of dk and dv over two blocks. On the f32
// route the split also bounds the queries a part sums in the tensor cores,
// whose f32 sums are not rounded to nearest (ops/cuda_attention.py
// dkdv_split: over 32768 queries dk and dv drift past 1e-4; 2048 a part
// hold it).
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
//   summation order: a dq kernel (its prologue also writes delta_i =
//   sum_c dO_i * O_i, the JAX kernel's `dsum`), then a dk/dv kernel that
//   loops over the queries of its sample (or of its part of them). Both
//   get p from the saved lse instead of a second softmax pass.
//
// Inputs: f32 (pa_fwd, pa_bwd) or bf16 (pa_fwd_tc, pa_bwd_tc); every
// accumulation is f32; outputs take the inputs' dtype.
// C is one of 8, 16, 32, 64, 128. Ragged L and M tails are masked. Each
// entry point returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for a C or a size it does not take.
//
// C = 128 (the D attention of the 128^3 BigGAN-Deep at filters 128: 1024
// channels at 16^3). A 64-row bf16 tile is then 16 KB, an f32 tile 32 KB,
// so every kernel stages its tiles in dynamic shared memory (up to 227 KB
// a block on Hopper; cudaFuncSetAttribute lifts the 48 KB default where a
// kernel needs more). Registers: the tc backward kernels walk each staged
// 64-row tile in two 32-row halves at C = 128 (the s and dp fragments
// halve), and the tc dk/dv kernel splits the C columns of its dk and dv
// accumulators over two blocks, each recomputing S^T and dP^T for its half
// (2 x 16 x 64 f32 a warp would otherwise be 128 registers a thread for
// the sums alone). The tf32x3 kernels stage their own rows in shared
// memory too, walk a streamed tile in parts of 16 NJ rows and, at C = 128,
// run 8 warps a block, since one block fills a SM's shared memory there;
// their dk/dv kernel keeps all C columns (X3Shape, below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// ---------------------------------------------------------------------------
// The bf16 route of the backward: the same FA2 split on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 sums). P and dS enter the
// products as bf16 and every sum is f32: the TPU kernel's own rounding
// (pallas_attention.py:93-105, t and e cast to the caller's dtype).
// c = 8 runs as c = 16 with zero columns. Shared tiles hold kTcTile rows of
// CK = max(C, 16) bf16, swizzled (tc::swz) so ldmatrix is conflict-free.
constexpr int kTcThreads = 128;  // 4 warps x 16 rows (queries or keys)
constexpr int kTcRows = 64;      // rows per block
constexpr int kTcTile = 64;      // keys (dq, and both forwards) or queries
                                 // (dk/dv) per tile

template <int C>
struct TcShape {
  static constexpr int CK = C < 16 ? 16 : C;
  static constexpr int NC = CK / 8;   // 16-byte chunks a row
  static constexpr int KS = CK / 16;  // k-steps over c
  static constexpr int NT = C / 8;    // n8 tiles over c
  // the backward's registers at C = 128 (header): a staged tile is walked
  // in halves of 16 NJ rows, and dk/dv's columns split over CS blocks of
  // NTO n8 tiles each
  static constexpr int NJ = C > 64 ? 2 : 4;
  static constexpr int CS = C > 64 ? 2 : 1;
  static constexpr int NTO = NT / CS;
  // bytes of one staged [kTcTile][NC] tile
  static constexpr int TILE_BYTES = kTcTile * NC * 16;
};

// Dynamic shared memory of a block: lift the 48 KB default for `kernel`
// where it needs more.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// Request rows [row0, row0 + nrows) of a [rows, C] bf16 matrix into a
// swizzled [kTcTile][NC] tile by cp.async; rows past nrows and columns past
// C are zero-filled.
template <int C>
__device__ __forceinline__ void load_tile_tc(uint4* dst,
                                             const __nv_bfloat16* src,
                                             int row0, int nrows) {
  constexpr int NC = TcShape<C>::NC;
  for (int i = threadIdx.x; i < kTcTile * NC; i += blockDim.x) {
    const int r = i / NC, ch = i % NC;
    const bool ok = r < nrows && ch * 8 < C;
    tc::cp_async16(dst + tc::swz<NC>(r, ch),
                   ok ? src + (size_t)(row0 + r) * C + ch * 8 : src,
                   ok ? 16 : 0);
  }
}

// The A fragments (rows r0 = 16-row base + g and r0 + 8, all k-steps over
// c) of a [rows, C] bf16 matrix, read from global memory; invalid rows and
// columns past C are zero.
template <int C>
__device__ __forceinline__ void load_a_frags(
    uint32_t (*a)[4], const __nv_bfloat16* base, int r0, bool ok0, bool ok1,
    int qd) {
#pragma unroll
  for (int kk = 0; kk < TcShape<C>::KS; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e & 1) * 8;
      const int col = kk * 16 + 2 * qd + (e >> 1) * 8;
      const bool ok = (e & 1) ? ok1 : ok0;
      a[kk][e] = ok && col < C ? *reinterpret_cast<const uint32_t*>(
                                     base + (size_t)row * C + col)
                               : 0u;
    }
}

// s[2 NJ][4] += A (16 rows) x tile^T over c: rows [row0, row0 + 16 NJ)
// of a staged tile as the n index (2 NJ n8 tiles), its columns as k.
template <int C, int NJ>
__device__ __forceinline__ void rows_times_tile(float (*s)[4],
                                                const uint32_t (*a)[4],
                                                const uint4* tile, int lane,
                                                int row0) {
  constexpr int NC = TcShape<C>::NC;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int kk = 0; kk < TcShape<C>::KS; ++kk) {
      uint32_t b[4];
      tc::ldsm_x4(b, tile + tc::swz<NC>(
                             row0 + j * 16 + (lane >> 4) * 8 + (lane & 7),
                             2 * kk + ((lane >> 3) & 1)));
      tc::mma(s[2 * j], a[kk], b);
      tc::mma(s[2 * j + 1], a[kk], b + 2);
    }
}

// acc[NTO][4] += X (16 rows x 16 NK, as the C fragments x[2 NK][4]) @ tile
// (rows [row0, row0 + 16 NK) as k; the NTO n8 tiles of columns from 16 cp0
// as n), with X rounded to bf16.
template <int C, int NK, int NTO>
__device__ __forceinline__ void frags_times_tile(float (*acc)[4],
                                                 const float (*x)[4],
                                                 const uint4* tile, int lane,
                                                 int row0, int cp0) {
  constexpr int NC = TcShape<C>::NC;
#pragma unroll
  for (int k2 = 0; k2 < NK; ++k2) {
    const uint32_t a[4] = {tc::pack(x[2 * k2][0], x[2 * k2][1]),
                           tc::pack(x[2 * k2][2], x[2 * k2][3]),
                           tc::pack(x[2 * k2 + 1][0], x[2 * k2 + 1][1]),
                           tc::pack(x[2 * k2 + 1][2], x[2 * k2 + 1][3])};
#pragma unroll
    for (int cp = 0; cp < (NTO + 1) / 2; ++cp) {
      uint32_t b[4];
      tc::ldsm_x4_trans(
          b, tile + tc::swz<NC>(
                        row0 + k2 * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),
                        2 * (cp0 + cp) + (lane >> 4)));
      tc::mma(acc[2 * cp], a, b);
      if (2 * cp + 1 < NTO) tc::mma(acc[2 * cp + 1], a, b + 2);
    }
  }
}

// K1 bf16, the FlashAttention-2 forward: grid (ceil(L / kFwdTcRows), N),
// kFwdTcWarps warps of 16 query rows; Q's A fragments stay in registers,
// K and V stream in 64-key tiles, double-buffered by cp.async (the
// staging of bwd_dq_tc_kernel). Per tile: S = Q K^T on mma; keys past M get score
// -inf before the row max; the row max (log2 units) is reduced over the
// quad that shares a row (shfl_xor 1, 2); the running output and row sum
// are rescaled by 2^(m_old - m_new); p = 2^(s log2e - m) in f32, added to
// the row sum in f32 (the TPU kernel's denom) and rounded to bf16 for
// O += P V (pallas_attention.py:40, p.astype(v.dtype); frags_times_tile
// packs it). Each lane sums its own columns; the quad's sums meet once,
// after the last tile. o = acc / den, rounded to bf16 once; lse =
// (m + log2 den) ln2 in f32, for K2.
//
// What bounds it: each score costs one MUFU ex2 against about four f32-pipe
// operations (the scaling FFMA, the max, the sum, half a bf16 pack); the
// f32 pipe does 128 a clock per SM, the MUFU 16, so the exponentials are
// the ceiling (0.514 ms at the G placement). The two products are 64 FLOP
// a score, a few percent of the tensor cores' peak. 8 warps, not 4: with 4,
// ptxas spilled the c = 32 instance (72 registers, 8 bytes), and 8 ran 8%
// faster at the G placement and 5% at the D placement (H100, one run).
constexpr int kFwdTcWarps = 8;
constexpr int kFwdTcThreads = 32 * kFwdTcWarps;
constexpr int kFwdTcRows = 16 * kFwdTcWarps;  // query rows per block

template <int C>
__global__ void __launch_bounds__(kFwdTcThreads)
    fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int L, int M) {
  using S = TcShape<C>;
  // stage st of K at ks + st kT, of V at vs + st kT
  constexpr int kT = kTcTile * S::NC;
  extern __shared__ uint4 smem[];
  uint4* const ks = smem;
  uint4* const vs = smem + 2 * kT;
  const int n = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, qd = lane & 3;
  const int r0 = blockIdx.x * kFwdTcRows + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < L, ok1 = r1 < L;
  const size_t nl = (size_t)n * L;
  const __nv_bfloat16* kn = k + (size_t)n * M * C;
  const __nv_bfloat16* vn = v + (size_t)n * M * C;

  uint32_t qa[S::KS][4];
  load_a_frags<C>(qa, q + nl * C, r0, ok0, ok1, qd);

  float acc[S::NT][4];
#pragma unroll
  for (int t = 0; t < S::NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  float mx[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
  float den[2] = {0.f, 0.f};             // this lane's share of the row sum

  // two stages: tile j + 1 is in flight while tile j's products run
  auto request = [&](int j0, int st) {
    load_tile_tc<C>(ks + st * kT, kn, j0, min(kTcTile, M - j0));
    load_tile_tc<C>(vs + st * kT, vn, j0, min(kTcTile, M - j0));
    tc::cp_async_commit();
  };
  request(0, 0);
  for (int j0 = 0, st = 0; j0 < M; j0 += kTcTile, st ^= 1) {
    const int nt = min(kTcTile, M - j0);
    if (j0 + kTcTile < M) {
      request(j0 + kTcTile, st ^ 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
    rows_times_tile<C, 4>(s, qa, ks + st * kT, lane, 0);
    if (nt < kTcTile) {  // the ragged last tile: keys past M
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t * 8 + 2 * qd + (e & 1) >= nt) s[t][e] = -INFINITY;
    }
    float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      tm[0] = fmaxf(tm[0], fmaxf(s[t][0], s[t][1]));
      tm[1] = fmaxf(tm[1], fmaxf(s[t][2], s[t][3]));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 1));
      tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 2));
      // finite: every tile holds at least one key
      const float mnew = fmaxf(mx[h], tm[h] * kLog2e);
      const float scale = tc::exp2_approx(mx[h] - mnew);
      mx[h] = mnew;
      den[h] *= scale;
#pragma unroll
      for (int t = 0; t < S::NT; ++t) {
        acc[t][2 * h] *= scale;
        acc[t][2 * h + 1] *= scale;
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = tc::exp2_approx(fmaf(s[t][e], kLog2e, -mx[e >> 1]));
        den[e >> 1] += p;
        s[t][e] = p;
      }
    frags_times_tile<C, 4, S::NT>(acc, s, vs + st * kT, lane, 0, 0);
    __syncthreads();  // stage st is refilled two tiles on
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
  }
#pragma unroll
  for (int t = 0; t < S::NT; ++t) {
    const int col = t * 8 + 2 * qd;
    if (ok0)
      *reinterpret_cast<uint32_t*>(o + (nl + r0) * C + col) =
          tc::pack(acc[t][0] / den[0], acc[t][1] / den[0]);
    if (ok1)
      *reinterpret_cast<uint32_t*>(o + (nl + r1) * C + col) =
          tc::pack(acc[t][2] / den[1], acc[t][3] / den[1]);
  }
  if (qd == 0) {
    if (ok0) lse[nl + r0] = (mx[0] + log2f(den[0])) * kLn2;
    if (ok1) lse[nl + r1] = (mx[1] + log2f(den[1])) * kLn2;
  }
}

// dq: grid (ceil(L / 64), N), 4 warps of 16 query rows. The prologue
// writes delta_i = sum_c dO_i O_i (4 lanes a row, fixed order). Per 64-key
// tile (in 32-key halves at C = 128): S = Q K^T and dP = dO V^T on mma;
// P = 2^(S log2e - lse log2e) in f32 registers; dS = P (dP - delta); dQ +=
// dS K, dS packed to bf16 from the C fragments straight into A fragments,
// K's B fragments by ldmatrix.trans.
template <int C>
__global__ void __launch_bounds__(kTcThreads)
    bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ o,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     __nv_bfloat16* __restrict__ dq,
                     float* __restrict__ delta, int L, int M) {
  using S = TcShape<C>;
  // stage st of K at ks + st kT, of V at vs + st kT
  constexpr int kT = kTcTile * S::NC;
  extern __shared__ uint4 smem[];
  uint4* const ks = smem;
  uint4* const vs = smem + 2 * kT;
  const int n = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, qd = lane & 3;
  const int r0 = blockIdx.x * kTcRows + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < L, ok1 = r1 < L;
  const size_t nl = (size_t)n * L;
  const __nv_bfloat16* kn = k + (size_t)n * M * C;
  const __nv_bfloat16* vn = v + (size_t)n * M * C;

  uint32_t qa[S::KS][4], da[S::KS][4];
  load_a_frags<C>(qa, q + nl * C, r0, ok0, ok1, qd);
  load_a_frags<C>(da, dout + nl * C, r0, ok0, ok1, qd);

  float dl[2], l2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r1 : r0;
    const bool ok = h ? ok1 : ok0;
    float part = 0.f;
    if (ok)
      for (int c = qd * (C / 4); c < (qd + 1) * (C / 4); ++c)
        part = fmaf(to_f32(dout[(nl + r) * C + c]), to_f32(o[(nl + r) * C + c]),
                    part);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    dl[h] = part;
    l2[h] = ok ? lse[nl + r] * kLog2e : INFINITY;
    if (ok && qd == 0) delta[nl + r] = part;
  }

  float acc[S::NT][4];
#pragma unroll
  for (int t = 0; t < S::NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  // two stages: tile j + 1 is in flight while tile j's products run
  auto request = [&](int j0, int st) {
    load_tile_tc<C>(ks + st * kT, kn, j0, min(kTcTile, M - j0));
    load_tile_tc<C>(vs + st * kT, vn, j0, min(kTcTile, M - j0));
    tc::cp_async_commit();
  };
  request(0, 0);
  for (int j0 = 0, st = 0; j0 < M; j0 += kTcTile, st ^= 1) {
    const int nt = min(kTcTile, M - j0);
    if (j0 + kTcTile < M) {
      request(j0 + kTcTile, st ^ 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int row0 = 0; row0 < kTcTile; row0 += 16 * S::NJ) {
      float s[2 * S::NJ][4], dp[2 * S::NJ][4];
#pragma unroll
      for (int t = 0; t < 2 * S::NJ; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
      rows_times_tile<C, S::NJ>(s, qa, ks + st * kT, lane, row0);
      rows_times_tile<C, S::NJ>(dp, da, vs + st * kT, lane, row0);
#pragma unroll
      for (int t = 0; t < 2 * S::NJ; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pv = tc::exp2_approx(fmaf(s[t][e], kLog2e, -l2[e >> 1]));
          if (row0 + t * 8 + 2 * qd + (e & 1) >= nt) pv = 0.f;  // past M
          s[t][e] = pv * (dp[t][e] - dl[e >> 1]);              // dS
        }
      frags_times_tile<C, S::NJ, S::NT>(acc, s, ks + st * kT, lane, row0,
                                        0);
    }
    __syncthreads();  // stage st is refilled two tiles on
  }
#pragma unroll
  for (int t = 0; t < S::NT; ++t) {
    const int col = t * 8 + 2 * qd;
    if (ok0)
      *reinterpret_cast<uint32_t*>(dq + (nl + r0) * C + col) =
          tc::pack(acc[t][0], acc[t][1]);
    if (ok1)
      *reinterpret_cast<uint32_t*>(dq + (nl + r1) * C + col) =
          tc::pack(acc[t][2], acc[t][3]);
  }
}

// dk/dv: grid (ceil(M / 64), N, P CS), 4 warps of 16 key rows; z = p CS +
// h: part p walks query tiles [T p / P, T (p + 1) / P) of the T = ceil(L /
// 64), and writes columns [h C / CS, (h + 1) C / CS) of dk and dv (CS = 2
// at C = 128, else 1). Per tile (in 32-query halves at C = 128): S^T = K
// Q^T and dP^T = V dO^T on mma over all of C; P^T from the stored lse; dV
// += P^T dO and dK += dS^T Q with dS^T = P^T (dP^T - delta), both packed
// to bf16 from the C fragments. P = 1 writes bf16 dk/dv; P > 1 writes f32
// partials [P, N, M, C], summed in order by tc::sum_partials.
template <int C>
__global__ void __launch_bounds__(kTcThreads)
    bwd_dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv, float* __restrict__ dkp,
                       float* __restrict__ dvp, int L, int M, int P) {
  using S = TcShape<C>;
  // qs [2][kTcTile * NC], dos [2][kTcTile * NC], lses [2][kTcTile], dls
  // (stage st at qs + st kT, ..., lses + st kTcTile, ...)
  constexpr int kT = kTcTile * S::NC;
  extern __shared__ uint4 smem[];
  uint4* const qs = smem;
  uint4* const dos = smem + 2 * kT;
  float* const lses = reinterpret_cast<float*>(smem + 4 * kT);
  float* const dls = lses + 2 * kTcTile;
  const int n = blockIdx.y, p = blockIdx.z / S::CS, h = blockIdx.z % S::CS;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, qd = lane & 3;
  const int r0 = blockIdx.x * kTcRows + warp * 16 + g, r1 = r0 + 8;
  const bool ok0 = r0 < M, ok1 = r1 < M;
  const size_t nl = (size_t)n * L, nm = (size_t)n * M;

  uint32_t ka[S::KS][4], va[S::KS][4];
  load_a_frags<C>(ka, k + nm * C, r0, ok0, ok1, qd);
  load_a_frags<C>(va, v + nm * C, r0, ok0, ok1, qd);

  float dka[S::NTO][4], dva[S::NTO][4];
#pragma unroll
  for (int t = 0; t < S::NTO; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[t][e] = dva[t][e] = 0.f;

  // two stages: tile i + 1 is in flight while tile i's products run.
  // Query rows past L arrive as zeros (q, dO, lse, delta): their S^T and
  // dP^T are 0, so their dS^T is 0 and their dO adds nothing to dV.
  auto request = [&](int i0, int st) {
    const int nt = min(kTcTile, L - i0);
    load_tile_tc<C>(qs + st * kT, q + nl * C, i0, nt);
    load_tile_tc<C>(dos + st * kT, dout + nl * C, i0, nt);
    for (int r = threadIdx.x; r < kTcTile; r += blockDim.x) {
      const bool ok = r < nt;
      const size_t at = nl + (ok ? i0 + r : 0);
      tc::cp_async4(lses + st * kTcTile + r, lse + at, ok ? 4 : 0);
      tc::cp_async4(dls + st * kTcTile + r, delta + at, ok ? 4 : 0);
    }
    tc::cp_async_commit();
  };
  const int tiles = (L + kTcTile - 1) / kTcTile;
  const int t_begin = (int)((long long)tiles * p / P);
  const int t_end = (int)((long long)tiles * (p + 1) / P);
  request(t_begin * kTcTile, 0);
  for (int ti = t_begin, st = 0; ti < t_end; ++ti, st ^= 1) {
    if (ti + 1 < t_end) {
      request((ti + 1) * kTcTile, st ^ 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int row0 = 0; row0 < kTcTile; row0 += 16 * S::NJ) {
      float s[2 * S::NJ][4], dp[2 * S::NJ][4];
#pragma unroll
      for (int t = 0; t < 2 * S::NJ; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
      rows_times_tile<C, S::NJ>(s, ka, qs + st * kT, lane, row0);
      rows_times_tile<C, S::NJ>(dp, va, dos + st * kT, lane, row0);
#pragma unroll
      for (int t = 0; t < 2 * S::NJ; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = row0 + t * 8 + 2 * qd + (e & 1);
          const int at = st * kTcTile + col;
          const float pv = tc::exp2_approx((s[t][e] - lses[at]) * kLog2e);
          s[t][e] = pv;                             // P^T
          dp[t][e] = pv * (dp[t][e] - dls[at]);     // dS^T
        }
      const int cp0 = h * S::NTO / 2;
      frags_times_tile<C, S::NJ, S::NTO>(dva, s, dos + st * kT, lane, row0,
                                         cp0);
      frags_times_tile<C, S::NJ, S::NTO>(dka, dp, qs + st * kT, lane, row0,
                                         cp0);
    }
    __syncthreads();  // stage st is refilled two tiles on
  }
#pragma unroll
  for (int t = 0; t < S::NTO; ++t) {
    const int col = h * 8 * S::NTO + t * 8 + 2 * qd;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!(r ? ok1 : ok0)) continue;
      const size_t at = (nm + (r ? r1 : r0)) * C + col;
      if (P == 1) {
        *reinterpret_cast<uint32_t*>(dk + at) =
            tc::pack(dka[t][2 * r], dka[t][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + at) =
            tc::pack(dva[t][2 * r], dva[t][2 * r + 1]);
      } else {
        const size_t pat = (size_t)p * gridDim.y * M * C + at;
        *reinterpret_cast<float2*>(dkp + pat) =
            make_float2(dka[t][2 * r], dka[t][2 * r + 1]);
        *reinterpret_cast<float2*>(dvp + pat) =
            make_float2(dva[t][2 * r], dva[t][2 * r + 1]);
      }
    }
  }
}

template <int C>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, const void* lse,
                          void* dq, void* dk, void* dv, void* delta, void* dkp,
                          void* dvp, int N, int L, int M, int P,
                          cudaStream_t st) {
  using B = __nv_bfloat16;
  using S = TcShape<C>;
  const int dq_smem = 4 * S::TILE_BYTES;
  const int dkdv_smem = 4 * S::TILE_BYTES + 4 * kTcTile * (int)sizeof(float);
  cudaError_t err = allow_smem(bwd_dq_tc_kernel<C>, dq_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(bwd_dkdv_tc_kernel<C>, dkdv_smem);
  if (err != cudaSuccess) return err;
  dim3 gq((L + kTcRows - 1) / kTcRows, N);
  bwd_dq_tc_kernel<C><<<gq, kTcThreads, dq_smem, st>>>(
      (const B*)q, (const B*)k, (const B*)v, (const B*)o, (const B*)dout,
      (const float*)lse, (B*)dq, (float*)delta, L, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gk((M + kTcRows - 1) / kTcRows, N, P * S::CS);
  bwd_dkdv_tc_kernel<C><<<gk, kTcThreads, dkdv_smem, st>>>(
      (const B*)q, (const B*)k, (const B*)v, (const B*)dout,
      (const float*)lse, (const float*)delta, (B*)dk, (B*)dv, (float*)dkp,
      (float*)dvp, L, M, P);
  err = cudaGetLastError();
  if (err != cudaSuccess || P == 1) return err;
  const long long count = (long long)N * M * C;
  err = tc::sum_partials((const float*)dkp, (B*)dk, P, count, st);
  if (err != cudaSuccess) return err;
  return tc::sum_partials((const float*)dvp, (B*)dv, P, count, st);
}

template <int C>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          void* o, void* lse, int N, int L, int M,
                          cudaStream_t st) {
  using B = __nv_bfloat16;
  const int smem = 4 * TcShape<C>::TILE_BYTES;
  const cudaError_t err = allow_smem(fwd_tc_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + kFwdTcRows - 1) / kFwdTcRows, N);
  fwd_tc_kernel<C><<<grid, kFwdTcThreads, smem, st>>>(
      (const B*)q, (const B*)k, (const B*)v, (B*)o, (float*)lse, L, M);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The f32 route: the same FA2 kernels in 3xTF32 (mma_tf32.cuh) on the
// tensor cores, mma.sync m16n8k8. A block is WARPS warps of 16 rows
// (queries in the forward and dq, keys in dk/dv); its own rows and the
// streamed tiles are staged by cp.async as f32 in dynamic shared memory,
// swizzled (tc::f32_at), and every fragment is split into its TF32 halves
// where it is read. Products take the channels (or the keys) as k in the
// order of mma_tf32.cuh, so the S and dP C fragments are the A fragments
// of the P V, dS K, P^T dO and dS^T Q products as they stand.
//
// Sizes. 4 warps (64 rows) a block, and 64-row streamed tiles, as the
// bf16 backward; at C = 128 an f32 row is 512 bytes and shared memory
// holds one block a SM, so there the block is 8 warps (128 rows: two
// warps a scheduler to hide the latencies) and the backward streams
// 32-row tiles (its own rows take 128 KB). The backward walks a streamed
// tile in parts of 16 NJ rows: its S and dP fragments are 2 x 8 NJ floats
// a lane, beside C / 2 (dq) or C (dk/dv) of sums; at C = 128, 16-row
// parts keep dk/dv from spilling (ptxas hoists the reads and splits of the
// unrolled products; 32-row parts spilled there). dk/dv keeps all C
// columns in one block (247 registers at C = 128, no spill): split over
// two column halves as the tc kernel is, each half redid S^T and dP^T,
// and the K2 f32 pass was slower at the 128^3 D (PERF.md, section 6).
template <int C>
struct X3Shape {
  static constexpr int KS = C / 8;  // k-steps over c
  static constexpr int NT = C / 8;  // n8 tiles over c
  static constexpr int WARPS = C > 64 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int ROWS = 16 * WARPS;     // own rows a block
  static constexpr int TR = C > 64 ? 32 : 64;  // rows a backward tile
  static constexpr int NJ = C > 64 ? 1 : C >= 32 ? 2 : 4;
  // dynamic shared memory (floats): the forward's Q rows and two stages
  // of 64-key K and V tiles; dq's Q and dO rows and two stages of K and V;
  // dk/dv's K and V rows and two stages of Q, dO, lse and delta
  static constexpr int FWD = ROWS * C + 4 * kTcTile * C;
  static constexpr int DQ = 2 * ROWS * C + 4 * TR * C;
  static constexpr int DKDV = 2 * ROWS * C + 4 * TR * C + 4 * TR;
};

// Request rows [row0, row0 + nrows) of a [rows, C] f32 matrix into a
// swizzled [R][C] tile by cp.async, zero-filling rows past nrows.
template <int C, int R>
__device__ __forceinline__ void load_tile_x3(float* dst, const float* src,
                                             int row0, int nrows) {
  constexpr int NP = C / 4;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < R * NP; i += blockDim.x) {
    const int r = i / NP, p = i % NP;
    const bool ok = r < nrows;
    tc::cp_async16(dst + tc::f32_at<C>(r, 4 * p),
                   ok ? src + (size_t)(row0 + r) * C + 4 * p : src,
                   ok ? 16 : 0);
  }
}

// s[2 NJ][4] += A B^T over c: A is rows [a_row, a_row + 16) of the
// staged tile `a`, B rows [row0, row0 + 16 NJ) of the staged tile `b`
// (2 NJ n8 tiles).
template <int C, int NJ>
__device__ __forceinline__ void rows_times_tile_x3(float (*s)[4],
                                                   const float* a, int a_row,
                                                   const float* b, int row0,
                                                   int g, int qd) {
#pragma unroll
  for (int kk = 0; kk < X3Shape<C>::KS; ++kk) {
    const int col = 8 * kk + 2 * qd;
    const float2 x0 =
        *reinterpret_cast<const float2*>(a + tc::f32_at<C>(a_row + g, col));
    const float2 x1 = *reinterpret_cast<const float2*>(
        a + tc::f32_at<C>(a_row + g + 8, col));
    uint32_t ah[4], al[4];
    tc::split_tf32(x0.x, ah[0], al[0]);
    tc::split_tf32(x1.x, ah[1], al[1]);
    tc::split_tf32(x0.y, ah[2], al[2]);
    tc::split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
    for (int t = 0; t < 2 * NJ; ++t) {
      const float2 y = *reinterpret_cast<const float2*>(
          b + tc::f32_at<C>(row0 + 8 * t + g, col));
      uint32_t bh[2], bl[2];
      tc::split_tf32(y.x, bh[0], bl[0]);
      tc::split_tf32(y.y, bh[1], bl[1]);
      tc::mma3(s[t], ah, al, bh, bl);
    }
  }
}

// acc[C / 8][4] += X @ B: X is 16 rows x 16 NJ as the C fragments x[2
// NJ][4] (its columns as k), B rows [row0, row0 + 16 NJ) of the staged
// tile `b` (as k; its C / 8 n8 tiles of columns as n).
template <int C, int NJ>
__device__ __forceinline__ void frags_times_tile_x3(float (*acc)[4],
                                                    const float (*x)[4],
                                                    const float* b, int row0,
                                                    int g, int qd) {
#pragma unroll
  for (int t = 0; t < 2 * NJ; ++t) {
    uint32_t ah[4], al[4];
    tc::split_tf32(x[t][0], ah[0], al[0]);
    tc::split_tf32(x[t][2], ah[1], al[1]);
    tc::split_tf32(x[t][1], ah[2], al[2]);
    tc::split_tf32(x[t][3], ah[3], al[3]);
    const int r = row0 + 8 * t + 2 * qd;
#pragma unroll
    for (int nt = 0; nt < X3Shape<C>::NT; ++nt) {
      const int col = 8 * nt + g;
      uint32_t bh[2], bl[2];
      tc::split_tf32(b[tc::f32_at<C>(r, col)], bh[0], bl[0]);
      tc::split_tf32(b[tc::f32_at<C>(r + 1, col)], bh[1], bl[1]);
      tc::mma3(acc[nt], ah, al, bh, bl);
    }
  }
}

// K1 f32: grid (ceil(L / ROWS), N), WARPS warps of 16 query rows. The
// block's Q rows are staged once; K and V stream in 64-key tiles,
// double-buffered by cp.async. Per tile: S = Q K^T in 3xTF32; keys past M
// get score -inf before the row max; the row max (log2 units) over the
// quad that shares a row; the running output and row sum rescaled by
// 2^(m_old - m_new); p = 2^(s log2e - m) in f32, summed into the row sum
// and, split, into O += P V in 3xTF32. o = acc / den; lse = (m + log2
// den) ln2 (natural log).
template <int C>
__global__ void __launch_bounds__(X3Shape<C>::THREADS)
    fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int L, int M) {
  using S = X3Shape<C>;
  // qs [ROWS][C], then stage st of K at ks + st kT, of V at vs + st kT
  constexpr int kT = kTcTile * C;
  extern __shared__ float4 smem_x3[];
  float* const qs = reinterpret_cast<float*>(smem_x3);
  float* const ks = qs + S::ROWS * C;
  float* const vs = ks + 2 * kT;
  const int n = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, qd = lane & 3;
  const int row0 = blockIdx.x * S::ROWS;
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  const size_t nl = (size_t)n * L;
  const float* kn = k + (size_t)n * M * C;
  const float* vn = v + (size_t)n * M * C;

  float acc[S::NT][4];
#pragma unroll
  for (int t = 0; t < S::NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  float mx[2] = {-INFINITY, -INFINITY};  // running row max, log2 units
  float den[2] = {0.f, 0.f};             // this lane's share of the row sum

  // two stages: tile j + 1 is in flight while tile j's products run; Q
  // rides with the first
  load_tile_x3<C, S::ROWS>(qs, q + nl * C, row0, min(S::ROWS, L - row0));
  auto request = [&](int j0, int st) {
    load_tile_x3<C, kTcTile>(ks + st * kT, kn, j0, min(kTcTile, M - j0));
    load_tile_x3<C, kTcTile>(vs + st * kT, vn, j0, min(kTcTile, M - j0));
    tc::cp_async_commit();
  };
  request(0, 0);
  for (int j0 = 0, st = 0; j0 < M; j0 += kTcTile, st ^= 1) {
    const int nt = min(kTcTile, M - j0);
    if (j0 + kTcTile < M) {
      request(j0 + kTcTile, st ^ 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
    rows_times_tile_x3<C, 4>(s, qs, warp * 16, ks + st * kT, 0, g, qd);
    if (nt < kTcTile) {  // the ragged last tile: keys past M
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t * 8 + 2 * qd + (e & 1) >= nt) s[t][e] = -INFINITY;
    }
    float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      tm[0] = fmaxf(tm[0], fmaxf(s[t][0], s[t][1]));
      tm[1] = fmaxf(tm[1], fmaxf(s[t][2], s[t][3]));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 1));
      tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 2));
      // finite: every tile holds at least one key
      const float mnew = fmaxf(mx[h], tm[h] * kLog2e);
      const float scale = tc::exp2_approx(mx[h] - mnew);
      mx[h] = mnew;
      den[h] *= scale;
#pragma unroll
      for (int t = 0; t < S::NT; ++t) {
        acc[t][2 * h] *= scale;
        acc[t][2 * h + 1] *= scale;
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = tc::exp2_approx(fmaf(s[t][e], kLog2e, -mx[e >> 1]));
        den[e >> 1] += p;
        s[t][e] = p;
      }
    frags_times_tile_x3<C, 4>(acc, s, vs + st * kT, 0, g, qd);
    __syncthreads();  // stage st is refilled two tiles on
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
  }
#pragma unroll
  for (int t = 0; t < S::NT; ++t) {
    const int col = t * 8 + 2 * qd;
    if (r0 < L)
      *reinterpret_cast<float2*>(o + (nl + r0) * C + col) =
          make_float2(acc[t][0] / den[0], acc[t][1] / den[0]);
    if (r1 < L)
      *reinterpret_cast<float2*>(o + (nl + r1) * C + col) =
          make_float2(acc[t][2] / den[1], acc[t][3] / den[1]);
  }
  if (qd == 0) {
    if (r0 < L) lse[nl + r0] = (mx[0] + log2f(den[0])) * kLn2;
    if (r1 < L) lse[nl + r1] = (mx[1] + log2f(den[1])) * kLn2;
  }
}

// K2 f32, dq: grid (ceil(L / ROWS), N), WARPS warps of 16 query rows; the
// block's Q and dO rows staged once, K and V streamed in TR-key tiles. The
// prologue writes delta_i = sum_c dO_i O_i (4 lanes a row, fixed order).
// Per tile (in parts of 16 NJ keys): S = Q K^T and dP = dO V^T; P = 2^(S
// log2e - lse log2e); dS = P (dP - delta); dQ += dS K; every product in
// 3xTF32.
template <int C>
__global__ void __launch_bounds__(X3Shape<C>::THREADS)
    bwd_dq_tf32x3_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ o,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ dq, float* __restrict__ delta,
                         int L, int M) {
  using S = X3Shape<C>;
  // qs, dos [ROWS][C]; stage st of K at ks + st kT, of V at vs + st kT
  constexpr int kT = S::TR * C;
  extern __shared__ float4 smem_x3[];
  float* const qs = reinterpret_cast<float*>(smem_x3);
  float* const dos = qs + S::ROWS * C;
  float* const ks = dos + S::ROWS * C;
  float* const vs = ks + 2 * kT;
  const int n = blockIdx.y;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, qd = lane & 3;
  const int row0 = blockIdx.x * S::ROWS;
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  const size_t nl = (size_t)n * L;
  const float* kn = k + (size_t)n * M * C;
  const float* vn = v + (size_t)n * M * C;

  load_tile_x3<C, S::ROWS>(qs, q + nl * C, row0, min(S::ROWS, L - row0));
  load_tile_x3<C, S::ROWS>(dos, dout + nl * C, row0, min(S::ROWS, L - row0));
  auto request = [&](int j0, int st) {
    load_tile_x3<C, S::TR>(ks + st * kT, kn, j0, min(S::TR, M - j0));
    load_tile_x3<C, S::TR>(vs + st * kT, vn, j0, min(S::TR, M - j0));
    tc::cp_async_commit();
  };
  request(0, 0);

  float dl[2], l2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h ? r1 : r0;
    const bool ok = r < L;
    float part = 0.f;
    if (ok)
      for (int c = qd * (C / 4); c < (qd + 1) * (C / 4); ++c)
        part = fmaf(dout[(nl + r) * C + c], o[(nl + r) * C + c], part);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    dl[h] = part;
    l2[h] = ok ? lse[nl + r] * kLog2e : INFINITY;
    if (ok && qd == 0) delta[nl + r] = part;
  }

  float acc[S::NT][4];
#pragma unroll
  for (int t = 0; t < S::NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

  for (int j0 = 0, st = 0; j0 < M; j0 += S::TR, st ^= 1) {
    const int nt = min(S::TR, M - j0);
    if (j0 + S::TR < M) {
      request(j0 + S::TR, st ^ 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + st * kT;
#pragma unroll 1
    for (int j = 0; j < S::TR; j += 16 * S::NJ) {
      float s[2 * S::NJ][4], dp[2 * S::NJ][4];
#pragma unroll
      for (int t = 0; t < 2 * S::NJ; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
      rows_times_tile_x3<C, S::NJ>(s, qs, warp * 16, kt, j, g, qd);
      rows_times_tile_x3<C, S::NJ>(dp, dos, warp * 16, vs + st * kT, j, g,
                                   qd);
#pragma unroll
      for (int t = 0; t < 2 * S::NJ; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pv = tc::exp2_approx(fmaf(s[t][e], kLog2e, -l2[e >> 1]));
          if (j + t * 8 + 2 * qd + (e & 1) >= nt) pv = 0.f;  // past M
          s[t][e] = pv * (dp[t][e] - dl[e >> 1]);            // dS
        }
      frags_times_tile_x3<C, S::NJ>(acc, s, kt, j, g, qd);
    }
    __syncthreads();  // stage st is refilled two tiles on
  }
#pragma unroll
  for (int t = 0; t < S::NT; ++t) {
    const int col = t * 8 + 2 * qd;
    if (r0 < L)
      *reinterpret_cast<float2*>(dq + (nl + r0) * C + col) =
          make_float2(acc[t][0], acc[t][1]);
    if (r1 < L)
      *reinterpret_cast<float2*>(dq + (nl + r1) * C + col) =
          make_float2(acc[t][2], acc[t][3]);
  }
}

// K2 f32, dk/dv: grid (ceil(M / ROWS), N, P), WARPS warps of 16 key
// rows; part p = z walks query tiles [T p / P, T (p + 1) / P) of the T =
// ceil(L / TR), and writes all C columns of dk and dv. The block's K and V
// rows are staged once; Q, dO, lse and delta stream in TR-query tiles. Per
// tile (in parts of 16 NJ queries): S^T = K Q^T and dP^T = V dO^T; P^T
// from the stored lse; dV += P^T dO and dK += dS^T Q with dS^T = P^T (dP^T
// - delta); every product in 3xTF32. P = 1 writes dk/dv; P > 1 writes f32
// partials [P, N, M, C], summed in order by tc::sum_partials.
template <int C>
__global__ void __launch_bounds__(X3Shape<C>::THREADS)
    bwd_dkdv_tf32x3_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           float* __restrict__ dkp, float* __restrict__ dvp,
                           int L, int M, int P) {
  using S = X3Shape<C>;
  // kts, vts [ROWS][C]; stage st of Q at qs + st kT, of dO at dos + st kT,
  // of lse at lses + st TR, of delta at dls + st TR
  constexpr int kT = S::TR * C;
  extern __shared__ float4 smem_x3[];
  float* const kts = reinterpret_cast<float*>(smem_x3);
  float* const vts = kts + S::ROWS * C;
  float* const qs = vts + S::ROWS * C;
  float* const dos = qs + 2 * kT;
  float* const lses = dos + 2 * kT;
  float* const dls = lses + 2 * S::TR;
  const int n = blockIdx.y, p = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane >> 2, qd = lane & 3;
  const int row0 = blockIdx.x * S::ROWS;
  const int r0 = row0 + warp * 16 + g, r1 = r0 + 8;
  const size_t nl = (size_t)n * L, nm = (size_t)n * M;

  float dka[S::NT][4], dva[S::NT][4];
#pragma unroll
  for (int t = 0; t < S::NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[t][e] = dva[t][e] = 0.f;

  // two stages: tile i + 1 is in flight while tile i's products run; K and
  // V ride with the first. Query rows past L arrive as zeros (q, dO, lse,
  // delta): their S^T and dP^T are 0, so their dS^T is 0 and their dO adds
  // nothing to dV.
  load_tile_x3<C, S::ROWS>(kts, k + nm * C, row0, min(S::ROWS, M - row0));
  load_tile_x3<C, S::ROWS>(vts, v + nm * C, row0, min(S::ROWS, M - row0));
  auto request = [&](int i0, int st) {
    const int nt = min(S::TR, L - i0);
    load_tile_x3<C, S::TR>(qs + st * kT, q + nl * C, i0, nt);
    load_tile_x3<C, S::TR>(dos + st * kT, dout + nl * C, i0, nt);
    for (int r = threadIdx.x; r < S::TR; r += blockDim.x) {
      const bool ok = r < nt;
      const size_t at = nl + (ok ? i0 + r : 0);
      tc::cp_async4(lses + st * S::TR + r, lse + at, ok ? 4 : 0);
      tc::cp_async4(dls + st * S::TR + r, delta + at, ok ? 4 : 0);
    }
    tc::cp_async_commit();
  };
  const int tiles = (L + S::TR - 1) / S::TR;
  const int t_begin = (int)((long long)tiles * p / P);
  const int t_end = (int)((long long)tiles * (p + 1) / P);
  request(t_begin * S::TR, 0);
  for (int ti = t_begin, st = 0; ti < t_end; ++ti, st ^= 1) {
    if (ti + 1 < t_end) {
      request((ti + 1) * S::TR, st ^ 1);
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const float* qt = qs + st * kT;
    const float* dot = dos + st * kT;
#pragma unroll 1
    for (int i = 0; i < S::TR; i += 16 * S::NJ) {
      float s[2 * S::NJ][4], dp[2 * S::NJ][4];
#pragma unroll
      for (int t = 0; t < 2 * S::NJ; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
      rows_times_tile_x3<C, S::NJ>(s, kts, warp * 16, qt, i, g, qd);
      rows_times_tile_x3<C, S::NJ>(dp, vts, warp * 16, dot, i, g, qd);
#pragma unroll
      for (int t = 0; t < 2 * S::NJ; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = st * S::TR + i + t * 8 + 2 * qd + (e & 1);
          const float pv = tc::exp2_approx((s[t][e] - lses[at]) * kLog2e);
          s[t][e] = pv;                          // P^T
          dp[t][e] = pv * (dp[t][e] - dls[at]);  // dS^T
        }
      frags_times_tile_x3<C, S::NJ>(dva, s, dot, i, g, qd);
      frags_times_tile_x3<C, S::NJ>(dka, dp, qt, i, g, qd);
    }
    __syncthreads();  // stage st is refilled two tiles on
  }
#pragma unroll
  for (int t = 0; t < S::NT; ++t) {
    const int col = t * 8 + 2 * qd;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? r1 : r0;
      if (row >= M) continue;
      const size_t at = (nm + row) * C + col;
      const size_t pat = P == 1 ? at : (size_t)p * gridDim.y * M * C + at;
      *reinterpret_cast<float2*>((P == 1 ? dk : dkp) + pat) =
          make_float2(dka[t][2 * r], dka[t][2 * r + 1]);
      *reinterpret_cast<float2*>((P == 1 ? dv : dvp) + pat) =
          make_float2(dva[t][2 * r], dva[t][2 * r + 1]);
    }
  }
}

template <int C>
cudaError_t launch_fwd_x3(const void* q, const void* k, const void* v,
                          void* o, void* lse, int N, int L, int M,
                          cudaStream_t st) {
  using S = X3Shape<C>;
  const int smem = S::FWD * (int)sizeof(float);
  const cudaError_t err = allow_smem(fwd_tf32x3_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + S::ROWS - 1) / S::ROWS, N);
  fwd_tf32x3_kernel<C><<<grid, S::THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o,
      (float*)lse, L, M);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_bwd_x3(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, const void* lse,
                          void* dq, void* dk, void* dv, void* delta, void* dkp,
                          void* dvp, int N, int L, int M, int P,
                          cudaStream_t st) {
  using F = float;
  using S = X3Shape<C>;
  if (P > (L + S::TR - 1) / S::TR) return cudaErrorInvalidValue;
  const int dq_smem = S::DQ * (int)sizeof(F);
  const int dkdv_smem = S::DKDV * (int)sizeof(F);
  cudaError_t err = allow_smem(bwd_dq_tf32x3_kernel<C>, dq_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(bwd_dkdv_tf32x3_kernel<C>, dkdv_smem);
  if (err != cudaSuccess) return err;
  dim3 gq((L + S::ROWS - 1) / S::ROWS, N);
  bwd_dq_tf32x3_kernel<C><<<gq, S::THREADS, dq_smem, st>>>(
      (const F*)q, (const F*)k, (const F*)v, (const F*)o, (const F*)dout,
      (const F*)lse, (F*)dq, (F*)delta, L, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gk((M + S::ROWS - 1) / S::ROWS, N, P);
  bwd_dkdv_tf32x3_kernel<C><<<gk, S::THREADS, dkdv_smem, st>>>(
      (const F*)q, (const F*)k, (const F*)v, (const F*)dout, (const F*)lse,
      (const F*)delta, (F*)dk, (F*)dv, (F*)dkp, (F*)dvp, L, M, P);
  err = cudaGetLastError();
  if (err != cudaSuccess || P == 1) return err;
  const long long count = (long long)N * M * C;
  err = tc::sum_partials((const F*)dkp, (F*)dk, P, count, st);
  if (err != cudaSuccess) return err;
  return tc::sum_partials((const F*)dvp, (F*)dv, P, count, st);
}

// f(std::integral_constant<int, C>) for a supported C; false otherwise.
template <typename F>
bool dispatch_c(int C, F&& f) {
  switch (C) {
    case 8: f(std::integral_constant<int, 8>()); return true;
    case 16: f(std::integral_constant<int, 16>()); return true;
    case 32: f(std::integral_constant<int, 32>()); return true;
    case 64: f(std::integral_constant<int, 64>()); return true;
    case 128: f(std::integral_constant<int, 128>()); return true;
    default: return false;
  }
}

}  // namespace

extern "C" {

// The dk/dv grid of a route at C, as the launches above set it: grid[0]
// key rows a block, grid[1] queries a staged tile, grid[2] column halves
// (blocks a key block's columns split over). The caller chooses the parts
// P from it (ops/cuda_attention.py dkdv_split, which checks its own copy
// against this at load).
int pa_bwd_grid(int C, int f32, int* grid) {
  const bool ok = dispatch_c(C, [&](auto c) {
    constexpr int K = decltype(c)::value;
    if (f32) {
      grid[0] = X3Shape<K>::ROWS;
      grid[1] = X3Shape<K>::TR;
      grid[2] = 1;
    } else {
      grid[0] = kTcRows;
      grid[1] = kTcTile;
      grid[2] = TcShape<K>::CS;
    }
  });
  return ok ? 0 : (int)cudaErrorInvalidValue;
}

// The f32 route of the forward (3xTF32): o [N, L, C] and lse [N, L]
// (f32) from q [N, L, C], k/v [N, M, C], all f32.
int pa_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
           int N, int L, int M, int C, void* stream) {
  if (N < 1 || L < 1 || M < 1 || N > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  dispatch_c(C, [&](auto c) {
    err = launch_fwd_x3<decltype(c)::value>(q, k, v, o, lse, N, L, M, st);
  });
  return (int)err;
}

// The bf16 route of the forward (q, k, v, o bf16; lse f32).
int pa_fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse,
              int N, int L, int M, int C, void* stream) {
  if (N < 1 || L < 1 || M < 1 || N > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
  dispatch_c(C, [&](auto c) {
    err = launch_fwd_tc<decltype(c)::value>(q, k, v, o, lse, N, L, M, st);
  });
  return (int)err;
}

// The f32 route of the backward (3xTF32; all f32): dq, dk, dv from the
// forward's inputs, o, lse and dO. delta [N, L] (f32) is scratch written by
// the dq kernel and read by the dk/dv kernel; with P > 1 the dk/dv kernel
// splits L into P parts and dkp / dvp [P, N, M, C] f32 are scratch
// (ignored for P = 1).
int pa_bwd(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* delta, void* dkp, void* dvp, int N, int L, int M, int C,
           int P, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || L < 1 || M < 1 || N > 65535 || P < 1 || P > 32767)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  dispatch_c(C, [&](auto c) {  // P at most one part a tile: checked there
    err = launch_bwd_x3<decltype(c)::value>(q, k, v, o, dout, lse, dq, dk, dv,
                                            delta, dkp, dvp, N, L, M, P, st);
  });
  return (int)err;
}

// The bf16 route of the backward (all of q, k, v, o, dO bf16; lse f32).
// delta [N, L] f32 is scratch; with P > 1 the dk/dv kernel splits L into
// P parts and dkp / dvp [P, N, M, C] f32 are scratch (ignored for P = 1).
// At C = 128 the dk/dv grid is P x 2 deep in z (its column halves).
int pa_bwd_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* dq, void* dk, void* dv,
              void* delta, void* dkp, void* dvp, int N, int L, int M, int C,
              int P, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || L < 1 || M < 1 || N > 65535 || P < 1 || P > 32767 ||
      P > (L + kTcTile - 1) / kTcTile)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  dispatch_c(C, [&](auto c) {
    err = launch_bwd_tc<decltype(c)::value>(q, k, v, o, dout, lse, dq, dk, dv,
                                            delta, dkp, dvp, N, L, M, P, st);
  });
  return (int)err;
}

}  // extern "C"
