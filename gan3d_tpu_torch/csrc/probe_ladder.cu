// The Mosaic probe ladders as a Hopper probe ladder (sm_90a): the kernels
// behind gan3d_tpu_torch/probes/mosaic_ladder.py. Each rung of
// scripts/probe_mosaic.py and scripts/probe_mosaic2.py was a tiny Pallas
// kernel adding one TPU construct (manual DMA, a computed slot, a guarded
// start, partial and offset source slices, double buffering, the 27-view
// concat, the wide dot); here each computes exactly what its Pallas kernel
// computes, with the Hopper construct that plays the TPU construct's part.
// Every operand is bf16 (raw 16-bit values for the copies).
//
// Kernels, and the pallas_call sites they replace:
// - box_copy_kernel: a copy of a box of rows (contiguous in the source) of
//   a tensor into a contiguous output. Direct mode: 16-byte loads where
//   the rows allow it, else 2-byte ones (copy :48, cost_estimate :301;
//   lane_value_slice probe_mosaic2.py:38, minor_slice_reshape :56). Bulk
//   mode: one thread (the pl.when guard) arms an mbarrier with the box's
//   bytes and issues one cp.async.bulk global->shared copy per row into a
//   1- or 2-slot ring; the block waits on the barrier's phase, then
//   writes the slot out (manual_dma :66, dma_dyn_slot :220, dma_when_guard
//   :246, dma_pds_src :267, dma_pds_src_offset :289, dma_double_buffer
//   :99, the last with one block walking both samples and the next
//   sample's copy in flight while the current one is written).
// - im2col27_kernel: the 27 shifted 6^3 views of one staged 8^3 x 32
//   sample concatenated along the lanes into [216, 864] (lane_concat27
//   :121).
// - gram27_kernel: views[0]^T @ X27 summed over the samples, f32 [32, 864],
//   on the tensor cores (mma.sync m16n8k16 bf16, f32 accumulation); a tap
//   is a constant row offset into the staged sample, so its fragments come
//   by ldmatrix.trans through one table of view 0's rows; the sum over the
//   TPU's sequential grid is a loop inside the block and a fixed-order sum
//   of the warps' partials, so the result does not depend on block order
//   (wide_dot_accum :153 with the samples staged by plain loads;
//   dw_skeleton :199 through the double-buffered bulk-copy ring).
// - wide_fwd_kernel: per sample W2 [8, 432] @ X27 [432, 128] -> bf16
//   [8, 128], the same tensor-core product (wide_fwd_skeleton
//   probe_mosaic2.py:83).
//
// What bounds them: nothing at these sizes; a few microseconds of launch
// each (the largest moves 373 KB, the largest product is 12 MFLOP). They
// exist to hold each construct against a plain PyTorch version.
// Each entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

// probe_mosaic.py's X: [2, 8, 8, 8, 32]; its 27 views are 6^3 boxes.
constexpr int kS = 8, kC = 32, kV = 6;
constexpr int kSample = kS * kS * kS * kC;          // 16384 values
constexpr int kRows = kV * kV * kV;                  // 216
constexpr int kCols = 27 * kC;                       // 864
constexpr int kK = (kRows + 15) / 16 * 16;           // 224: K padded to 16
// probe_mosaic2.py's XT [2, 16, 2, 10, 10] and W2 [8, 432].
constexpr int kCi = 16, kDD = 2, kH = 8, kW = 8;
constexpr int kXT = kCi * kDD * (kH + 2) * (kW + 2); // 3200 values
constexpr int kM2 = 8, kK2 = 27 * kCi, kN2 = kDD * kH * kW;  // 8, 432, 128
constexpr int kMaxSmem = 227 * 1024;

struct Box {          // rows of `len` values at off + i*sn + j*sa + k*sb
  long long off, sn, sa, sb;
  int n, a, b, len;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                   tc::smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   tc::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(tc::smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One bulk copy global -> shared, completing `bytes` on the barrier.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(tc::smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(tc::smem_addr(bar))
      : "memory");
}

// Barriers initialised by thread 0, made visible to the async proxy.
__device__ __forceinline__ void init_barriers(uint64_t* bar, int count) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < count; ++s) mbar_init(bar + s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Generic-proxy reads of a slot are done before the async proxy refills it.
__device__ __forceinline__ void release_slot() {
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Thread 0: arm slot `slot` for sample `s` of the box and issue its rows.
__device__ void issue_box(const uint16_t* src, const Box& bx, int s,
                          unsigned char* ring, uint32_t slot_bytes,
                          uint64_t* bar, int slot) {
  const uint32_t row_bytes = (uint32_t)bx.len * 2;
  const int rows = bx.a * bx.b;
  mbar_expect_tx(bar + slot, row_bytes * rows);
  unsigned char* dst = ring + (size_t)slot * slot_bytes;
  for (int r = 0; r < rows; ++r) {
    const long long at = bx.off + s * bx.sn + (long long)(r / bx.b) * bx.sa +
                         (long long)(r % bx.b) * bx.sb;
    bulk_copy(dst + (size_t)r * row_bytes, src + at, row_bytes, bar + slot);
  }
}

// Copy `bytes` (a multiple of 16) from shared to global memory.
__device__ __forceinline__ void store16(const unsigned char* from, void* to,
                                        uint32_t bytes) {
  const uint4* f = reinterpret_cast<const uint4*>(from);
  uint4* o = reinterpret_cast<uint4*>(to);
  for (uint32_t i = threadIdx.x; i < bytes / 16; i += blockDim.x) o[i] = f[i];
}

// ---------------------------------------------------------------------------
// box copy: grid bx.n / walk blocks, block b handles samples
// [b*walk, (b+1)*walk). Output [n][a][b][len], contiguous.
template <bool kBulk>
__global__ void box_copy_kernel(const uint16_t* __restrict__ src,
                                uint16_t* __restrict__ out, Box bx, int walk,
                                int slots, int vec) {
  const int rows = bx.a * bx.b;
  const long long box = (long long)rows * bx.len;
  const int s0 = blockIdx.x * walk;
  if (!kBulk) {
    for (int j = 0; j < walk; ++j) {
      const int s = s0 + j;
      uint16_t* o = out + s * box;
      if (vec) {  // rows and offsets in whole 16-byte units
        const int per_row = bx.len / 8;
        for (long long i = threadIdx.x; i < box / 8; i += blockDim.x) {
          const int r = (int)(i / per_row), e = (int)(i % per_row) * 8;
          const long long at = bx.off + s * bx.sn +
                               (long long)(r / bx.b) * bx.sa +
                               (long long)(r % bx.b) * bx.sb + e;
          reinterpret_cast<uint4*>(o)[i] =
              *reinterpret_cast<const uint4*>(src + at);
        }
      } else {
        for (long long i = threadIdx.x; i < box; i += blockDim.x) {
          const int r = (int)(i / bx.len), e = (int)(i % bx.len);
          o[i] = src[bx.off + s * bx.sn + (long long)(r / bx.b) * bx.sa +
                     (long long)(r % bx.b) * bx.sb + e];
        }
      }
    }
    return;
  }
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + 128;
  const uint32_t box_bytes = (uint32_t)box * 2;
  const uint32_t slot_bytes = (box_bytes + 127) & ~127u;
  init_barriers(bar, slots);
  if (threadIdx.x == 0)
    issue_box(src, bx, s0, ring, slot_bytes, bar, s0 % slots);
  for (int j = 0; j < walk; ++j) {
    const int s = s0 + j, slot = s % slots;
    // double buffering: the next sample's copy goes into the other slot
    // before this one is waited for
    if (slots == 2 && j + 1 < walk && threadIdx.x == 0)
      issue_box(src, bx, s + 1, ring, slot_bytes, bar, (s + 1) % slots);
    mbar_wait(bar + slot, (uint32_t)(j / slots) & 1);
    store16(ring + (size_t)slot * slot_bytes, out + s * box, box_bytes);
    release_slot();
    if (slots == 1 && j + 1 < walk && threadIdx.x == 0)
      issue_box(src, bx, s + 1, ring, slot_bytes, bar, 0);
  }
}

// ---------------------------------------------------------------------------
// im2col27: grid 27 (one tap each), out[r, tap*32 + c] =
// x[sample, kd + r/36, kh + (r/6)%6, kw + r%6, c]. The sample is staged in
// shared memory with 16-byte loads; each thread writes 8 channels at once.
__global__ void im2col27_kernel(const uint16_t* __restrict__ x,
                                uint16_t* __restrict__ out, int sample) {
  __shared__ uint4 xs[kSample / 8];
  const uint4* xn = reinterpret_cast<const uint4*>(x + (long long)sample *
                                                           kSample);
  for (int i = threadIdx.x; i < kSample / 8; i += blockDim.x) xs[i] = xn[i];
  __syncthreads();
  const int tap = blockIdx.x;
  const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
  for (int i = threadIdx.x; i < kRows * (kC / 8); i += blockDim.x) {
    const int r = i / (kC / 8), c8 = i % (kC / 8);
    const int pos = ((kd + r / 36) * kS + kh + (r / 6) % 6) * kS + kw + r % 6;
    reinterpret_cast<uint4*>(out + (long long)r * kCols + tap * kC)[c8] =
        xs[pos * (kC / 8) + c8];
  }
}

// ---------------------------------------------------------------------------
// Tensor-core products: tc::mma (mma_bf16.cuh, which gives the fragment
// layouts) on fragments packed by tc::pack_raw.

// Position (d, h, w) = (r / 36, (r / 6) % 6, r % 6) of row r of view 0 (the
// 6^3 box at the origin), as a row index into an 8^3 sample; rows past the
// last give the zero row. The view at shift (kd, kh, kw) is view 0 plus the
// constant (kd * 8 + kh) * 8 + kw.
constexpr int kZeroRow = kS * kS * kS;                 // 512
__device__ __forceinline__ int base_pos(int r) {
  if (r >= kRows) return kZeroRow;
  return ((r / 36) * kS + (r / 6) % 6) * kS + r % 6;
}

// gram27's staged sample: [513 rows][32 channels] bf16 in 16-byte units,
// row 512 zero. An ldmatrix tile reads one chunk of 8 consecutive rows of
// a view: the tail of one 6-row run of the volume and the head of the next
// (h + 1, or d + 1 and h = 0). With f = (w + 6 h + 4 d) mod 8 those 8 rows
// take 8 consecutive values of f (a run's 6, then the next run's from +6),
// for view 0 and every shift of it. So unit (4 p + c) XOR mu(p), mu(p) = f
// of p's even partner / 2, puts them in 8 different bank groups (bit 2 of
// the group is w's parity, bits 0-1 c XOR mu): no conflicts. 128 bytes (two
// rows) stay together, so the rows' 16-byte stores are conflict-free too.
constexpr int kRowUnits = kC / 8;                      // 4
constexpr int kBufUnits = (kZeroRow + 1) * kRowUnits;  // 2052
constexpr int kGroupWarps = 4;                 // warps of one sample group
constexpr int kGroupThreads = kGroupWarps * 32;
constexpr int kGramThreads = 2 * kGroupThreads;        // two groups
constexpr int kKSteps = kK / 16;                       // 14
constexpr int kUnitsPerThread = kSample / 8 / kGroupThreads;  // 16

__device__ __forceinline__ int gram_swz(int p, int c) {
  const int f = (p & 6) + 6 * ((p >> 3) & 7) + 4 * (p >> 6);
  return (p * kRowUnits + c) ^ ((f & 7) >> 1);
}

// Barrier over the threads of one sample group (ids 1 and 2).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(kGroupThreads)
               : "memory");
}

// ---------------------------------------------------------------------------
// gram27: out[m, tap*32 + c] = sum_s sum_r x[s, base(r), m] x[s, base(r) +
// off(tap), c], the 216 rows r of view 0 as the k of the product, padded to
// 224 with the zero row. grid 27 (one tap a block), two groups of 4 warps;
// group g takes samples g, g + 2, ... in order, each staged into the
// group's own copy. Tables of the padded rows for A (view 0) and B (the
// tap's view: base + off) are built once a block; every fragment then
// comes by ldmatrix.trans from the staged sample, whose rows are
// positions: A[m, k] (channels m of row k) and B[k, n] alike. Warp w of a
// group takes k-steps [14 w / 4, 14 (w + 1) / 4) and all 32 x 32 outputs of
// the tap (2 m16 x 4 n8 tiles); the 8 warps' partial sums meet in shared
// memory and are added in order (group 0's warps, then group 1's), so
// repeats are bit-identical and blocks independent. Staging: plain 16-byte
// loads into the swizzled copy, the group's next sample's loads in
// registers while this one is multiplied; or (kBulk) one bulk copy a sample
// into a 2-slot ring on mbarriers (slot g for group g), the next sample in
// flight, each sample re-staged from its slot into the swizzled copy (the
// ring's raw 64-byte rows would put 8 positions in 2 bank groups: 4-way
// conflicts). What bounds it: latency, not a rate. At 12 MFLOP and 64 KB
// each of the 27 blocks waits on its staging, its products and its
// partials in turn (PERF.md section 6 times each on an H100).
template <bool kBulk>
__global__ void __launch_bounds__(kGramThreads)
gram27_kernel(const uint16_t* __restrict__ x, float* __restrict__ out,
              int nsamples) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int tab_a[kK], tab_b[kK];
  constexpr uint32_t kBytes = kSample * 2;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + 128;
  uint4* bufs = reinterpret_cast<uint4*>(ring + (kBulk ? 2 * kBytes : 0));
  const int tap = blockIdx.x;
  const int off = ((tap / 9) * kS + (tap / 3) % 3) * kS + tap % 3;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int group = threadIdx.x / kGroupThreads;
  const int gt = threadIdx.x % kGroupThreads;
  uint4* buf = bufs + group * kBufUnits;
  const uint4* xg = reinterpret_cast<const uint4*>(x);

  for (int r = threadIdx.x; r < kK; r += blockDim.x) {
    const int p = base_pos(r);
    tab_a[r] = p;
    tab_b[r] = p == kZeroRow ? p : p + off;
  }
  if (threadIdx.x < 2 * kRowUnits)
    bufs[(threadIdx.x / kRowUnits) * kBufUnits + kZeroRow * kRowUnits +
         threadIdx.x % kRowUnits] = make_uint4(0u, 0u, 0u, 0u);
  uint4 pre[kUnitsPerThread];
  if (kBulk) {
    init_barriers(bar, 2);
    if (threadIdx.x == 0)
      for (int s = 0; s < 2 && s < nsamples; ++s) {
        mbar_expect_tx(bar + s, kBytes);
        bulk_copy(ring + (size_t)s * kBytes, x + (long long)s * kSample,
                  kBytes, bar + s);
      }
  } else {
    __syncthreads();
    if (group < nsamples) {
#pragma unroll
      for (int i = 0; i < kUnitsPerThread; ++i)
        pre[i] = xg[(long long)group * (kSample / 8) + gt +
                    i * kGroupThreads];
    }
  }

  // this lane's table rows at its warp's k-steps, read while the samples
  // are on their way. ldmatrix.x4.trans: lanes 8i .. 8i+7 give the rows of
  // tile i. A (m16 x k16 of view 0^T): tiles (k 0-7 | 8-15) x (m 0-7 |
  // 8-15) as a0..a3; B (k16 x two n8): tiles (k 0-7 | 8-15) x (n 0-7 |
  // 8-15) as b0, b1 of the first n8 tile and b0, b1 of the second.
  constexpr int kMaxSteps = (kKSteps + kGroupWarps - 1) / kGroupWarps;
  const int wg = warp % kGroupWarps;
  const int kbeg = kKSteps * wg / kGroupWarps;
  const int steps = kKSteps * (wg + 1) / kGroupWarps - kbeg;
  int ra[kMaxSteps], rb[kMaxSteps];
#pragma unroll
  for (int j = 0; j < kMaxSteps; ++j) {
    const int k0 = min(kbeg + j, kKSteps - 1) * 16 + (lane & 7);
    ra[j] = tab_a[k0 + ((lane >> 4) & 1) * 8];
    rb[j] = tab_b[k0 + ((lane >> 3) & 1) * 8];
  }
  float acc[2][4][4] = {};
  const uint4* raw = reinterpret_cast<const uint4*>(ring + group * kBytes);
  for (int s = group; s < nsamples; s += 2) {
    if (kBulk) mbar_wait(bar + group, (uint32_t)(s / 2) & 1);
    if (s >= 2) group_sync(group);  // the group is done with its last one
#pragma unroll
    for (int i = 0; i < kUnitsPerThread; ++i) {
      const int u = gt + i * kGroupThreads;
      buf[gram_swz(u / kRowUnits, u % kRowUnits)] = kBulk ? raw[u] : pre[i];
    }
    if (kBulk) {
      // the slot is read: refill it (the async proxy after the reads)
      group_sync(group);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      if (s + 2 < nsamples && gt == 0) {
        mbar_expect_tx(bar + group, kBytes);
        bulk_copy(ring + (size_t)group * kBytes,
                  x + (long long)(s + 2) * kSample, kBytes, bar + group);
      }
    } else {
      if (s + 2 < nsamples) {
#pragma unroll
        for (int i = 0; i < kUnitsPerThread; ++i)
          pre[i] = xg[(long long)(s + 2) * (kSample / 8) + gt +
                      i * kGroupThreads];
      }
      group_sync(group);
    }
#pragma unroll
    for (int j = 0; j < kMaxSteps; ++j) {
      if (j >= steps) break;
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        tc::ldsm_x4_trans(a[mt],
                          buf + gram_swz(ra[j], 2 * mt + ((lane >> 3) & 1)));
#pragma unroll
      for (int np = 0; np < 2; ++np)
        tc::ldsm_x4_trans(b[np],
                          buf + gram_swz(rb[j], 2 * np + ((lane >> 4) & 1)));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
          tc::mma(acc[mt][nj], a[mt], b[nj >> 1] + (nj & 1) * 2);
    }
  }

  // the warps' partials, [warp][8 tiles (mt, nj)][32 lanes] float4s (a
  // lane's C fragment) over the staged copies, added in warp order; warp
  // t / 32 sums tile t / 32 of lane t % 32: rows g and g + 8, columns 2q and
  // 2q + 1
  __syncthreads();
  float4* part = reinterpret_cast<float4*>(bufs);
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const float* f = acc[t >> 2][t & 3];
    part[(warp * 8 + t) * 32 + lane] = make_float4(f[0], f[1], f[2], f[3]);
  }
  __syncthreads();
  float4 sum = part[warp * 32 + lane];
#pragma unroll
  for (int w = 1; w < 2 * kGroupWarps; ++w) {
    const float4 v = part[(w * 8 + warp) * 32 + lane];
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  const int g = lane / 4, q = lane % 4;
  const int m = (warp >> 2) * 16 + g, c = tap * kC + (warp & 3) * 8 + 2 * q;
  *reinterpret_cast<float2*>(out + m * kCols + c) = make_float2(sum.x, sum.y);
  *reinterpret_cast<float2*>(out + (m + 8) * kCols + c) =
      make_float2(sum.z, sum.w);
}

// ---------------------------------------------------------------------------
// wide_fwd: grid nsamples, 4 warps; warp w computes columns w*32 .. +32
// (4 n8 tiles) of out[s] = W2 [8, 432] @ X27 [432, 128], X27[tap*16 + ci,
// (dd*8 + h)*8 + w] = xt[s, ci, dd, kh + h, kw + w]; K steps of 16 are the
// 27 taps. A's rows 8..15 are zero; out is bf16 [nsamples, 8, 128].
__global__ void __launch_bounds__(128)
wide_fwd_kernel(const uint16_t* __restrict__ w2,
                const uint16_t* __restrict__ xt, uint16_t* __restrict__ out) {
  __shared__ uint16_t ws[kM2 * kK2];
  __shared__ uint16_t xs[kXT];
  const int s = blockIdx.x;
  for (int i = threadIdx.x; i < kM2 * kK2; i += blockDim.x) ws[i] = w2[i];
  for (int i = threadIdx.x; i < kXT; i += blockDim.x)
    xs[i] = xt[(long long)s * kXT + i];
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4;
  float acc[4][4] = {};
  for (int tap = 0; tap < 27; ++tap) {
    const int kh = (tap / 3) % 3, kw = tap % 3;
    const int k0 = tap * kCi;
    // A: row g of W2 (rows 8..15 are zero)
    const uint32_t a[4] = {
        tc::pack_raw(ws[g * kK2 + k0 + 2 * q], ws[g * kK2 + k0 + 2 * q + 1]),
        0u,
        tc::pack_raw(ws[g * kK2 + k0 + 2 * q + 8],
                     ws[g * kK2 + k0 + 2 * q + 9]),
        0u};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = warp * 32 + nt * 8 + g;
      const int dd = n / (kH * kW), h = (n / kW) % kH, w = n % kW;
      uint16_t bv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = 2 * q + (e & 1) + (e >> 1) * 8;
        bv[e] = xs[((ci * kDD + dd) * (kH + 2) + kh + h) * (kW + 2) + kw + w];
      }
      const uint32_t b[2] = {tc::pack_raw(bv[0], bv[1]),
                             tc::pack_raw(bv[2], bv[3])};
      tc::mma(acc[nt], a, b);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {  // rows g (< 8); rows g + 8 are padding
      const int n = warp * 32 + nt * 8 + 2 * q + e;
      out[((long long)s * kM2 + g) * kN2 + n] =
          __bfloat16_as_ushort(__float2bfloat16_rn(acc[nt][e]));
    }
  }
}

bool smem_ok(const void* kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return false;
  if (bytes <= 48 * 1024) return true;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes) == cudaSuccess;
}

}  // namespace

extern "C" {

// out [n, a, b, len] = the box of src (bf16 values); mode 0: direct loads
// (vec 1: 16-byte ones), mode 1: bulk copies into a ring of `slots` (1 or
// 2) slots, each block walking `walk` samples.
int ladder_box(const void* src, void* out, long long off, long long sn,
               long long sa, long long sb, int n, int a, int b, int len,
               int walk, int slots, int mode, int vec, void* stream) {
  if (n < 1 || a < 1 || b < 1 || len < 1 || walk < 1 || n % walk ||
      slots < 1 || slots > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Box bx{off, sn, sa, sb, n, a, b, len};
  const uint16_t* s = static_cast<const uint16_t*>(src);
  uint16_t* o = static_cast<uint16_t*>(out);
  if (mode == 0) {
    if (vec && (len % 8 || off % 8 || sn % 8 || sa % 8 || sb % 8))
      return (int)cudaErrorInvalidValue;
    box_copy_kernel<false><<<n / walk, 256, 0, st>>>(s, o, bx, walk, slots,
                                                      vec);
    return (int)cudaGetLastError();
  }
  if (mode != 1 || (len * 2) % 16 || (off * 2) % 16 || (sn * 2) % 16 ||
      (sa * 2) % 16 || (sb * 2) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t slot_bytes = ((size_t)a * b * len * 2 + 127) & ~(size_t)127;
  const size_t smem = 128 + slots * slot_bytes;
  if (!smem_ok((const void*)box_copy_kernel<true>, smem))
    return (int)cudaErrorInvalidValue;
  box_copy_kernel<true><<<n / walk, 256, smem, st>>>(s, o, bx, walk, slots, 0);
  return (int)cudaGetLastError();
}

// out [216, 864] = the 27 views of x[sample] ([2, 8, 8, 8, 32] bf16).
int ladder_im2col(const void* x, void* out, int sample, void* stream) {
  if (sample < 0) return (int)cudaErrorInvalidValue;
  im2col27_kernel<<<27, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), sample);
  return (int)cudaGetLastError();
}

// out [32, 864] f32 = sum over the nsamples samples of x ([n, 8, 8, 8, 32]
// bf16) of views[0]^T @ X27; mode 0: plain staging, 1: bulk-copy ring.
int ladder_gram(const void* x, void* out, int nsamples, int mode,
                void* stream) {
  if (nsamples < 1 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      128 + (mode ? 2 : 0) * (size_t)kSample * 2 + 2 * (size_t)kBufUnits * 16;
  cudaStream_t st = (cudaStream_t)stream;
  const uint16_t* xs = static_cast<const uint16_t*>(x);
  float* o = static_cast<float*>(out);
  if (mode == 0) {
    if (!smem_ok((const void*)gram27_kernel<false>, smem))
      return (int)cudaErrorInvalidValue;
    gram27_kernel<false><<<27, kGramThreads, smem, st>>>(xs, o, nsamples);
  } else {
    if (!smem_ok((const void*)gram27_kernel<true>, smem))
      return (int)cudaErrorInvalidValue;
    gram27_kernel<true><<<27, kGramThreads, smem, st>>>(xs, o, nsamples);
  }
  return (int)cudaGetLastError();
}

// out [nsamples, 8, 128] bf16 = W2 [8, 432] @ X27 of each xt sample
// ([n, 16, 2, 10, 10] bf16).
int ladder_wide_fwd(const void* w2, const void* xt, void* out, int nsamples,
                    void* stream) {
  if (nsamples < 1) return (int)cudaErrorInvalidValue;
  wide_fwd_kernel<<<nsamples, 128, 0, (cudaStream_t)stream>>>(
      static_cast<const uint16_t*>(w2), static_cast<const uint16_t*>(xt),
      static_cast<uint16_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
