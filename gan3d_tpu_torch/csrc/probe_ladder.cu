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
//   a tensor into a contiguous output, on a launch plan computed by the
//   host (probes/mosaic_ladder.py box_plan: the source-contiguous rows
//   merged, the grid, the box as a tensor for the copy unit). Direct mode:
//   a grid over (unit chunk, row chunk, sample); each thread decomposes
//   its one row once, in 32 bits, and issues all of its one or two 16-byte
//   loads before its first store; rows that start off 16 bytes are read as
//   aligned 4-byte words and shifted (copy :48, cost_estimate :301;
//   lane_value_slice probe_mosaic2.py:38, minor_slice_reshape :56). Bulk
//   mode: one thread (the pl.when guard) arms an mbarrier with a sample's
//   bytes and issues one bulk tensor copy (cp.async.bulk.tensor, the map
//   encoded by the launcher) into a 1- or 2-slot ring, the slot of sample
//   i being i % slots; the block waits on the barrier's phase and the
//   thread writes the slot out with one bulk shared->global copy
//   (manual_dma :66, dma_dyn_slot :220, dma_when_guard :246, dma_pds_src
//   :267, dma_pds_src_offset :289: a sample split over blocks of >= 2 KB,
//   each with its own ring and barrier; dma_double_buffer :99: one block
//   walks both samples, the next sample's copy in flight while the
//   current one is written out).
// - im2col27_kernel: the 27 shifted 6^3 views of one 8^3 x 32 sample
//   concatenated along the lanes into [216, 864] (lane_concat27 :121). A
//   block owns 3 whole output rows (one contiguous span of the output)
//   and a thread one 16-byte column unit of each: 3 direct 16-byte loads
//   from the sample (L2-resident, 32 KB), all issued before the first
//   store; no shared memory, no barrier.
// - gram27_kernel: views[0]^T @ X27 summed over the samples, f32 [32, 864],
//   on the tensor cores (mma.sync m16n8k16 bf16, f32 accumulation); a tap
//   is a constant row offset into the staged sample, so its fragments come
//   by ldmatrix.trans through one table of view 0's rows; the sum over the
//   TPU's sequential grid is a loop inside the block and a fixed-order sum
//   of the warps' partials, so the result does not depend on block order
//   (wide_dot_accum :153 with the samples staged by plain loads;
//   dw_skeleton :199 through the double-buffered bulk-copy ring).
// - wide_fwd_kernel: per sample W2 [8, 432] @ X27 [432, 128] -> bf16
//   [8, 128] as the swapped product out^T = X27^T W2^T on the tensor cores:
//   the 128 positions are m (one m16 tile a warp), the 8 rows of W2 one n8
//   tile; the sample restaged channels-innermost, so a tap is a constant
//   row offset and both operands come by ldmatrix (wide_fwd_skeleton
//   probe_mosaic2.py:83).
//
// What bounds them: nothing at these sizes; a few microseconds of launch
// and latency each (the largest moves 64 KB, the largest product is 12
// MFLOP). They exist to hold each construct against a plain PyTorch
// version.
// Each entry point returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>  // CUtensorMap, the encoder's type
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

// A box copy's launch plan, field for field probes/mosaic_ladder.py's
// Plan (built there by box_plan): row (j, k) of sample s of the box,
// source-contiguous rows already merged, holds `len` values from element
// off + s sn + j sa + k sb; out is [n][rows][len], contiguous. Direct mode
// (bulk 0): threads a block, 2^tx_log2 of them along a row and the rest
// over rows, each moving `items` 16-byte units of its row. Bulk mode: the
// box as a tensor of `rank` dims from element off (innermost first, the
// last the samples; extents `dims`, element strides `strides` of dims
// 1.., padded to 5 dims), a block's share of a sample the sub-box `box`,
// the sample split over `parts` blocks along its outermost dim (rank - 2),
// each block
// walking `walk` samples through its ring of `slots` slots. grid_* is the
// launch grid. `stop` (bulk mode, for measurement; 0 otherwise) ends the
// kernel early: 1 at entry (the launch alone), 2 after the barrier init,
// 3 with the copy landed but not written out.
struct Plan {
  int n, off, sn, sa, sb, b, rows, len;
  int bulk, threads, tx_log2, items;
  int rank, parts, walk, slots;
  int dims[5], strides[4], box[5];
  int grid_x, grid_y, grid_z, stop;
};
constexpr int kMaxItems = 2;

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

// A copy that never lands (a fault of the async unit) traps after 2^22
// tries, far past any real wait, instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (int tries = 0; !mbar_try_wait(bar, parity);)
    if (++tries == 1 << 22) __trap();
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

// Sample s's share of block `part` (the sub-box at coordinate part * box[d]
// of its outermost dim d) by one tensor copy into `slot`, completing on
// `bar`, which the calling thread arms with its bytes first.
__device__ __forceinline__ void issue_box(const CUtensorMap* tmap,
                                          const Plan& p, int s, int part,
                                          uint32_t bytes, unsigned char* slot,
                                          uint64_t* bar) {
  int c[5] = {0, 0, 0, 0, 0};
  c[p.rank - 2] = part * p.box[p.rank - 2];
  c[p.rank - 1] = s;
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];" ::"r"(
          tc::smem_addr(slot)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c[0]), "r"(c[1]), "r"(c[2]),
      "r"(c[3]), "r"(c[4]), "r"(tc::smem_addr(bar))
      : "memory");
}

// One bulk copy shared -> global of `bytes` (a multiple of 16), in this
// thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "fence.proxy.async.shared::cta;\n"
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;" ::"l"(dst),
      "r"(tc::smem_addr(src)), "r"(bytes)
      : "memory");
}

// This thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Eight bf16 values that start `half` (0 or 1) values into word w[0].
__device__ __forceinline__ uint4 shifted(const uint32_t* w, bool half) {
  if (!half) return make_uint4(w[0], w[1], w[2], w[3]);
  return make_uint4(__funnelshift_r(w[0], w[1], 16),
                    __funnelshift_r(w[1], w[2], 16),
                    __funnelshift_r(w[2], w[3], 16),
                    __funnelshift_r(w[3], w[4], 16));
}

// ---------------------------------------------------------------------------
// box copy on plan p. Direct: block (unit chunk, row chunk, sample); a
// thread takes one row and `items` of its 16-byte units, 2^tx_log2 apart.
// Bulk: block (part, group of `walk` samples), one warp; thread 0 (the
// guard) issues each sample's tensor copy (tmap: the box as a tensor) and
// its one bulk write-out; every thread waits on the barrier's phase.
template <bool kBulk>
__global__ void box_copy_kernel(const uint16_t* __restrict__ src,
                                uint16_t* __restrict__ out, const Plan p,
                                const __grid_constant__ CUtensorMap tmap) {
  if (!kBulk) {
    const int r = blockIdx.y * (p.threads >> p.tx_log2) +
                  (threadIdx.x >> p.tx_log2);
    if (r >= p.rows) return;
    const int s = blockIdx.z, units = p.len / 8;
    const int j = r / p.b;  // the row's one decomposition
    const int at = p.off + s * p.sn + j * p.sa + (r - j * p.b) * p.sb;
    const int e0 = (blockIdx.x * p.items << p.tx_log2) +
                   (threadIdx.x & ((1 << p.tx_log2) - 1));
    uint4 v[kMaxItems];
    // every load of the thread goes out before its first store
    if (at % 8 == 0) {  // a 16-byte aligned row
      const uint4* g = reinterpret_cast<const uint4*>(src + at);
#pragma unroll
      for (int m = 0; m < kMaxItems; ++m) {
        const int e = e0 + (m << p.tx_log2);
        if (m < p.items && e < units) v[m] = __ldg(g + e);
      }
    } else {  // aligned 4-byte words, shifted by the row's odd value
      const uint32_t* g = reinterpret_cast<const uint32_t*>(src + (at & ~1));
      const bool half = at & 1;
#pragma unroll
      for (int m = 0; m < kMaxItems; ++m) {
        const int e = e0 + (m << p.tx_log2);
        if (m < p.items && e < units) {
          uint32_t w[5];
#pragma unroll
          for (int i = 0; i < 4; ++i) w[i] = __ldg(g + 4 * e + i);
          w[4] = half ? __ldg(g + 4 * e + 4) : 0u;
          v[m] = shifted(w, half);
        }
      }
    }
    uint4* o = reinterpret_cast<uint4*>(out + (s * p.rows + r) * p.len);
#pragma unroll
    for (int m = 0; m < kMaxItems; ++m) {
      const int e = e0 + (m << p.tx_log2);
      if (m < p.items && e < units) o[e] = v[m];
    }
    return;
  }
  if (p.stop == 1) return;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + 128;
  const int part = blockIdx.x, s0 = blockIdx.y * p.walk;
  const int vals = p.box[0] * p.box[1] * p.box[2] * p.box[3] * p.box[4];
  const uint32_t bytes = (uint32_t)vals * 2;
  const uint32_t slot_bytes = (bytes + 127) & ~127u;
  init_barriers(bar, p.slots);
  if (p.stop == 2) return;
  if (threadIdx.x == 0)
    issue_box(&tmap, p, s0, part, bytes, ring + (s0 % p.slots) * slot_bytes,
              bar + s0 % p.slots);
  for (int j = 0; j < p.walk; ++j) {
    const int s = s0 + j, slot = s % p.slots;
    // every thread is past its last wait, so a barrier may be re-armed
    __syncthreads();
    if (threadIdx.x == 0) {
      // one slot: this sample's copy once the last write-out has read it
      if (p.slots == 1 && j > 0) {
        bulk_wait_read();
        issue_box(&tmap, p, s, part, bytes, ring, bar);
      }
      // double buffering: the next sample's copy goes into the other slot
      // (its last write-out has read it) before this one is waited for
      if (p.slots == 2 && j + 1 < p.walk) {
        bulk_wait_read();
        issue_box(&tmap, p, s + 1, part, bytes,
                  ring + (1 - slot) * slot_bytes, bar + 1 - slot);
      }
    }
    mbar_wait(bar + slot, (uint32_t)(j / p.slots) & 1);
    if (threadIdx.x == 0 && p.stop != 3)
      bulk_store(out + ((size_t)s * p.rows * p.len + (size_t)part * vals),
                 ring + slot * slot_bytes, bytes);
  }
  // the shared memory lives until the write-outs have read it
  if (threadIdx.x == 0) bulk_wait_read();
}

// ---------------------------------------------------------------------------
// im2col27: out[r, tap*32 + c] = x[sample, kd + r/36, kh + (r/6)%6,
// kw + r%6, c]. Block b owns the R = 3 rows r0 = 3b .. 3b + 2 (R divides
// 6, so they share (d, h) = (r0/36, (r0/6)%6) and w runs from r0%6: one
// decomposition a block); thread t stores 16-byte column unit t of each
// row (tap t/4, channels 8(t%4) .. +8; divisors known at compile time), so
// a warp's stores are 512 contiguous bytes and the block's 3 x 1,728.
// Row i + 1 of the block reads one position (32 values) past row i. The
// grid is 72 blocks of 108 threads.
constexpr int kUnits = kCols / 8;                    // 108 units a row
constexpr int kIm2colRows = 3;                       // R
__global__ void __launch_bounds__(kUnits)
    im2col27_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                    int sample) {
  constexpr int R = kIm2colRows;
  static_assert(kV % R == 0, "a block's rows share (d, h)");
  const int r0 = blockIdx.x * R;
  const int d = r0 / (kV * kV), h = (r0 / kV) % kV, w = r0 % kV;
  const int t = threadIdx.x, tap = t / 4;
  const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
  const uint4* src = x + (long long)sample * (kSample / 8) +
                     (((d + kd) * kS + h + kh) * kS + w + kw) * (kC / 8) +
                     t % 4;
  uint4 v[R];
#pragma unroll
  for (int i = 0; i < R; ++i) v[i] = __ldg(src + i * (kC / 8));
  uint4* dst = out + (long long)r0 * kUnits + t;
#pragma unroll
  for (int i = 0; i < R; ++i) dst[i * kUnits] = v[i];
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
// wide_fwd: out[s] = W2 [8, 432] @ X27 [432, 128], X27[tap*16 + ci,
// (dd*8 + h)*8 + w] = xt[s, ci, dd, kh + h, kw + w] (every kd reads the same
// xt), computed swapped: out[s]^T [128, 8] = X27^T W2^T, m = the 128
// positions (8 m16 tiles), n = the 8 rows of W2 (one n8 tile), k = 27
// taps x 16 ci. Grid nsamples, 8 warps; warp w takes m tile w (dd = w / 4,
// h = 2 (w % 4) + 0..1, w 0..7).
// - Staging: W2 and the sample by 16-byte cp.async, all in flight at once;
//   W2's rows 55 units apart (rows 7 bank groups apart: B's ldmatrix reads
//   8 rows conflict-free); the sample then restaged channels-innermost,
//   [dd][h+2][w+2][16 ci] (32 bytes a position) from pairs of positions
//   read as 4-byte words and split by byte permutes.
// - A tap (kh, kw) is the constant row offset kh*10 + kw of the staged
//   sample, so A (16 positions x 16 ci) comes by ldmatrix from rows of
//   consecutive positions; chunk c of row r is unit 2r + (c ^ (r/4 & 1)),
//   which puts any 8 consecutive rows in 8 bank groups.
// - The taps kd*9 + t share A: one ldmatrix, three mma, each kd into its own
//   f32 accumulator (chains of 9); the three are added in kd order and
//   rounded once to bf16. B (W2's 27 k-steps, 54 registers) is loaded
//   once by ldmatrix before the products.
// - Out: the bf16 [8][128] tile through shared memory (rows 136 values
//   apart), written with 16-byte stores.
constexpr int kPos = kDD * (kH + 2) * (kW + 2);  // 200 padded positions
constexpr int kW2Units = kK2 / 8;                // 54 units a row of W2
constexpr int kW2Stride = kW2Units + 1;          // 55
constexpr int kOutStride = kN2 + 8;              // 136 values
constexpr int kFwdThreads = 256;

__device__ __forceinline__ int fwd_swz(int r, int c) {
  return 2 * r + (c ^ ((r >> 2) & 1));
}

__device__ __forceinline__ void ldsm_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(tc::smem_addr(p))
               : "memory");
}

__global__ void __launch_bounds__(kFwdThreads)
wide_fwd_kernel(const uint16_t* __restrict__ w2,
                const uint16_t* __restrict__ xt, uint16_t* __restrict__ out) {
  __shared__ uint4 ws[kM2 * kW2Stride];
  __shared__ uint4 raw[kXT / 8];
  __shared__ uint4 xs[2 * kPos];
  __shared__ uint4 os[kM2 * kOutStride / 8];
  const int s = blockIdx.x, t = threadIdx.x;
  const uint4* wg = reinterpret_cast<const uint4*>(w2);
  const uint4* xg = reinterpret_cast<const uint4*>(xt) + s * (kXT / 8);
#pragma unroll
  for (int u = t; u < kM2 * kW2Units; u += kFwdThreads)
    tc::cp_async16(ws + (u / kW2Units) * kW2Stride + u % kW2Units, wg + u);
#pragma unroll
  for (int u = t; u < kXT / 8; u += kFwdThreads)
    tc::cp_async16(raw + u, xg + u);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  // restage: thread t < 200 takes positions p, p + 1 (p even) and ci
  // half*8 .. +8: eight words of two positions each, one ci a word
  if (t < kPos) {
    const int p = 2 * (t % (kPos / 2)), half = t / (kPos / 2);
    const uint32_t* r32 = reinterpret_cast<const uint32_t*>(raw);
    uint32_t v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = r32[((half * 8 + i) * kPos + p) / 2];
    xs[fwd_swz(p, half)] =
        make_uint4(__byte_perm(v[0], v[1], 0x5410),
                   __byte_perm(v[2], v[3], 0x5410),
                   __byte_perm(v[4], v[5], 0x5410),
                   __byte_perm(v[6], v[7], 0x5410));
    xs[fwd_swz(p + 1, half)] =
        make_uint4(__byte_perm(v[0], v[1], 0x7632),
                   __byte_perm(v[2], v[3], 0x7632),
                   __byte_perm(v[4], v[5], 0x7632),
                   __byte_perm(v[6], v[7], 0x7632));
  }
  __syncthreads();

  const int lane = t % 32, warp = t / 32;
  // B: ldmatrix tile i of a pair of k-steps is (W2 row lane % 8, step
  // k + i / 2, half i % 2), so the registers are b0, b1 of step k, then of
  // step k + 1
  uint32_t b[27][2];
  const uint4* wrow = ws + (lane % 8) * kW2Stride + (lane >> 3);
#pragma unroll
  for (int k = 0; k + 1 < 27; k += 2) tc::ldsm_x4(b[k], wrow + 2 * k);
  ldsm_x2(b[26], wrow + 2 * 26);
  // A: tile i = (positions 8 (i & 1) + lane % 8, ci half i >> 1)
  const int tile = lane >> 3;
  const int r0 = ((warp >> 2) * (kH + 2) + (warp & 3) * 2 + (tile & 1)) *
                     (kW + 2) + (lane & 7);
  float acc[3][4] = {};
#pragma unroll
  for (int t9 = 0; t9 < 9; ++t9) {
    uint32_t a[4];
    tc::ldsm_x4(a, xs + fwd_swz(r0 + (t9 / 3) * (kW + 2) + t9 % 3, tile >> 1));
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) tc::mma(acc[kd], a, b[kd * 9 + t9]);
  }

  // C: (position g (+8), W2 row 2q (+1)) -> os[row][position], bf16
  uint16_t* o16 = reinterpret_cast<uint16_t*>(os);
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float v = (acc[0][e] + acc[1][e]) + acc[2][e];
    o16[(2 * q + (e & 1)) * kOutStride + warp * 16 + g + (e >> 1) * 8] =
        __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __syncthreads();
  if (t < kM2 * kN2 / 8)
    reinterpret_cast<uint4*>(out)[s * (kM2 * kN2 / 8) + t] =
        os[(t / (kN2 / 8)) * (kOutStride / 8) + t % (kN2 / 8)];
}

bool smem_ok(const void* kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSmem) return false;
  if (bytes <= 48 * 1024) return true;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes) == cudaSuccess;
}

// cuTensorMapEncodeTiled, looked up once through the runtime's
// cudaGetDriverEntryPoint (so nothing links against libcuda), or null.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  return encode;
}

// The box of plan p in src as a tensor map, 5 dims of 16-bit values.
bool encode_box(const uint16_t* src, const Plan& p, CUtensorMap* tmap) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return false;
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5], step[5];
  for (int d = 0; d < 5; ++d) {
    dims[d] = (cuuint64_t)p.dims[d];
    box[d] = (cuuint32_t)p.box[d];
    step[d] = 1;
    if (d < 4) strides[d] = (cuuint64_t)p.strides[d] * 2;
  }
  return encode(tmap, CU_TENSOR_MAP_DATA_TYPE_UINT16, 5,
                const_cast<uint16_t*>(src + p.off), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// out [n, rows, len] = the box of src (bf16 values) on `plan` (a Plan: a
// void pointer, since a type of the unnamed namespace in the signature
// would make the entry point internal).
int ladder_box(const void* src, void* out, const void* plan, void* stream) {
  const Plan p = *static_cast<const Plan*>(plan);
  if (p.n < 1 || p.rows < 1 || p.len < 8 || p.len % 8 || p.b < 1 ||
      p.off < 0 || p.sn < 0 || p.sa < 0 || p.sb < 0 || p.threads < 32 ||
      p.threads > 1024 || p.threads % 32 || p.grid_x < 1 || p.grid_y < 1 ||
      p.grid_z < 1 || p.stop < 0 || p.stop > 3 || (!p.bulk && p.stop) ||
      (long long)p.n * p.rows * p.len > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(p.grid_x, p.grid_y, p.grid_z);
  cudaStream_t st = (cudaStream_t)stream;
  const uint16_t* s = static_cast<const uint16_t*>(src);
  uint16_t* o = static_cast<uint16_t*>(out);
  CUtensorMap tmap{};
  if (!p.bulk) {
    if (p.tx_log2 < 0 || (1 << p.tx_log2) > p.threads || p.items < 1 ||
        p.items > kMaxItems || p.grid_z != p.n)
      return (int)cudaErrorInvalidValue;
    box_copy_kernel<false><<<grid, p.threads, 0, st>>>(s, o, p, tmap);
    return (int)cudaGetLastError();
  }
  // the tensor: 16-byte aligned base, strides and inner box rows; the box
  // a sample's, split over `parts` blocks along its outermost dim, one
  // sample deep
  long long vals = 1;
  bool ok = p.rank >= 2 && p.rank <= 5 && p.parts >= 1 && p.walk >= 1 &&
            p.n % p.walk == 0 && p.slots >= 1 && p.slots <= 2 &&
            p.off % 8 == 0 && p.box[0] % 8 == 0 && p.grid_x == p.parts &&
            p.grid_y == p.n / p.walk && p.grid_z == 1 &&
            p.dims[p.rank - 1] == p.n && p.box[p.rank - 1] == 1;
  for (int d = 0; d < 5 && ok; ++d) {
    ok = p.box[d] >= 1 && p.box[d] <= 256 &&
         (d >= 4 || p.strides[d] % 8 == 0) &&
         (d == p.rank - 1 ||
          p.dims[d] == p.box[d] * (d == p.rank - 2 ? p.parts : 1));
    vals *= p.box[d];
  }
  if (!ok || vals * p.parts != (long long)p.rows * p.len)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      128 + p.slots * ((size_t)(vals * 2 + 127) & ~(size_t)127);
  if (!encode_box(s, p, &tmap) ||
      !smem_ok((const void*)box_copy_kernel<true>, smem))
    return (int)cudaErrorInvalidValue;
  box_copy_kernel<true><<<grid, p.threads, smem, st>>>(s, o, p, tmap);
  return (int)cudaGetLastError();
}

// out [216, 864] = the 27 views of x[sample] ([n, 8, 8, 8, 32] bf16).
int ladder_im2col(const void* x, void* out, int sample, void* stream) {
  if (sample < 0) return (int)cudaErrorInvalidValue;
  im2col27_kernel<<<kRows / kIm2colRows, kUnits, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), sample);
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
  wide_fwd_kernel<<<nsamples, kFwdThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint16_t*>(w2), static_cast<const uint16_t*>(xt),
      static_cast<uint16_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
