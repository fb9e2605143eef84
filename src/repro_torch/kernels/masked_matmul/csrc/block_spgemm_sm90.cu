// Masked BCSR x BCSR block product for Hopper (sm_90a) at block size 128:
// TMA loads behind mbarriers, a producer warpgroup, two consumer
// warpgroups on wgmma.mma_async; optionally the structural counting replay
// in the same launch.
//
// Replaces the TPU kernel
//   repro/kernels/masked_matmul/kernel.py::block_spgemm_kernel
// (and, fused, repro/kernels/masked_matmul/ops.py::block_spgemm_with_structure,
// which runs it twice) for bs = 128 (kernel.py's dispatch predicate; every
// other block size runs block_spgemm.cu's mma.sync kernel).  It computes
// what block_spgemm.cu computes: for each worklist entry w (sorted by
// output rank), flag bit 1 zeroes the f32 accumulator, bit 2 adds
// A[pa[w]] @ B[pb[w]], bit 4 writes the accumulator to out[rank[w]] (a
// write may come mid-segment); an entry with bit 2 off adds nothing (a
// zero-fill entry, flags 5, comes out as exact zeros), an all-flags-off
// entry (the distributed ring's padding) is inert, a pa or pb out of range
// is skipped, and a rank that no entry writes comes out as zeros.  One CTA
// per (output rank, kind) walks that rank's segment seg_ptr[rank] ..
// seg_ptr[rank + 1] in order with no atomics, so results are
// deterministic; the values CTAs and (fused launch) the counting CTAs
// share one grid.
//
// Numerics, as block_spgemm.cu's: values are 3xTF32, a_lo b_hi + a_hi b_lo
// + a_hi b_hi with hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi); the
// tensor cores' own f32 sums truncate, so each consumer starts a partial
// sum from zero per 32-deep stage (FLUSH k8 steps: 12 truncating wgmma),
// waits for it and adds it to its f32 accumulator with IEEE rounding
// (tests/test_torch_block_spgemm_sm90.py emulates the interval: 3.0e-7
// normwise of float64 at 6 pairs of bs 128, against 7.1e-6 for one partial
// over the whole segment; the gate is 2e-6).  Counts are sums of 0/1
// products, exact in one bf16 pass accumulated in the tensor cores.
//
// Bound on an H100 SXM at the main-path shape (W = 14,434 real entries,
// bs = 128): 2 * W * bs^3 = 60.5 GFLOP per replay; three TF32 passes at
// 495 TFLOP/s take 0.367 ms, the counting replay's one bf16 pass at 989
// TFLOP/s 0.061 ms more, so the fused call's bound is 0.428 ms, by
// operations (its 560 MB of bytes take 0.17 ms at 3.35 TB/s).
// block_spgemm.cu reached 22 % of that bound (NVIDIA H100 80GB HBM3 at
// 700 W, as every time below): mma.sync, a cp.async ring in
// which every thread computed addresses with a __syncthreads per chunk,
// every operand element split in registers by each warp that read it.
//
// The layout problem.  tf32 wgmma reads a shared-memory operand only
// K-major (CUTLASS lists tf32 atoms as ..._F32TF32TF32_SS_TN and _RS_TN
// only).  An A block (row-major, k contiguous) is K-major; a B block (k
// rows, n contiguous) is not.  So each CTA computes its output tile
// transposed, C^T = B^T A^T:
//   - the register operand is B^T: consumer warpgroup wg owns output
//     columns 64 wg .. 64 wg + 63, loads them from the staged B tile per
//     k8 step and splits them into hi and lo itself (no element is split
//     twice).  The accumulator's row order is permuted (sm90::ct_col) so
//     that a thread's two fragment rows are adjacent columns: each k8
//     fragment is two conflict-free 64-bit shared loads, and each
//     accumulator pair is one 8-byte store of the transposed result;
//   - the shared-memory operand is the A tile, K-major as stored, read by
//     both warpgroups as m64n128k8's B.  Its hi and lo both sit in shared
//     memory: the producer warpgroup's three otherwise idle warps read each
//     word once after the tile lands, write hi in place and lo into a
//     second buffer of the same swizzled layout (elementwise at the same
//     offsets, so no swizzle arithmetic), fence the async proxy and arrive
//     on the stage's ready barrier;
//   - the results leave straight from the accumulators, transposed, in
//     8-byte stores (a write may come mid-segment while the ring is busy).
// The counting CTAs run C^T the same way in bf16 (the transpose bit reads
// the B pattern's 64 columns MN-major as the A operand, the A pattern
// K-major as B), accumulating in the tensor cores; they skip the split.
//
// Pipeline.  One producer thread walks the segment's real entries (the
// same `real` predicate as every other role, so the barriers' phases stay
// aligned) and, per 32-deep stage of a pair (64-deep for the bf16
// patterns), issues TMA loads of the A tile (128 rows x 128 B) and the B
// tile (32 k-rows x 128 columns as four 32-column boxes, so that the
// 128-byte swizzle applies) into a ring of STAGES stages guarded by full
// (TMA bytes landed), ready (A split) and empty (both consumers done)
// mbarriers.  Registers: the launch gives 168 a thread; the producer
// warpgroup drops to 56 and the consumers rise to 224 (setmaxnreg).  A
// consumer holds the accumulator and partial sum (128) and a stage's k8
// fragments (32): a second fragment set, to load the next stage's while
// this one's wgmma run, spilled 646 bytes and lost 13 %.  The split of A
// is what the tensor passes wait on most (at tile-8192 it cost 0.17-0.20
// of about 0.72 ms, by ablation); each splitter loads four of its eleven
// 16-byte words of a tile before splitting any, which with 56 registers
// beat one word at 40 / 232, eleven at 88 / 208 and no setmaxnreg by 3-8
// % at tile-8192.  Shared memory: 48 KB a stage, so one CTA an SM
// (tools/block_spgemm_sm90_variants.py times these and the stage count,
// the flush interval and the CTA order).
// The C entry builds the tensor maps on every call (sm90::map_2d) and
// passes them as __grid_constant__ parameters; with an empty A or B no
// entry is real and no map is encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BS = 128;                  // the block size this kernel takes
constexpr int KC = 32;                   // values: k-depth of a stage (f32)
constexpr int KCP = 64;                  // counts: k-depth of a stage (bf16)
constexpr int TILE_BYTES = BS * 128;     // 128 rows of 128 bytes
constexpr int STAGE_TX = 2 * TILE_BYTES; // TMA bytes a stage, either kind
// stage layout: values A (hi after the split) | A lo | B; counts A | B
constexpr int A_OFF = 0, LO_OFF = TILE_BYTES, B_OFF = 2 * TILE_BYTES;
constexpr int STAGE_BYTES = 3 * TILE_BYTES;
// ring depth, k8 steps per IEEE flush (1, 2 or 4; 4: one per stage) and
// whether the counting CTAs come first in the grid
constexpr int STAGES = 4;
constexpr int FLUSH = 4;
constexpr bool COUNTS_FIRST = false;
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
// + 1024 bytes to align the base to the swizzle's 1024 bytes
constexpr int SMEM = BAR_OFF + 8 * 3 * STAGES + 1024;

constexpr int THREADS = 384;             // consumers 0-255, producer 256-383
constexpr int CONSUMERS = 256;
constexpr int SPLITTERS = 96;            // the producer's warps 9-11
// 16-byte words of A a splitter thread loads before it splits any (its
// share of a tile is ceil(1024 / 96) = 11)
constexpr int SPLIT_BATCH = 4;
// registers a thread of each role holds after setmaxnreg
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;

// whether entry w adds a product that the kernel can read
__device__ __forceinline__ bool real(const int* flags, const int* pa,
                                     const int* pb, int w, int nnzb_a,
                                     int nnzb_b) {
  const int ia = pa[w], ib = pb[w];
  return (flags[w] & 2) && ia >= 0 && ia < nnzb_a && ib >= 0 && ib < nnzb_b;
}

__device__ __forceinline__ void zero(float (&d)[64]) {
#pragma unroll
  for (int x = 0; x < 64; ++x) d[x] = 0.0f;
}

// values: accumulator row pair (g, g + 8) is columns (j, j + 1), column n
// is output row n: out[n][j .. j + 1] in one 8-byte store per pair
__device__ __forceinline__ void store_values(const float (&acc)[64],
                                             float* O, int j, int t) {
#pragma unroll
  for (int jn = 0; jn < 16; ++jn)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      *reinterpret_cast<float2*>(O + (8 * jn + 2 * t + b) * BS + j) =
          make_float2(acc[4 * jn + b], acc[4 * jn + 2 + b]);
}

// counts: accumulator row r is column 64 wg + r in natural order
__device__ __forceinline__ void store_counts(const float (&acc)[64],
                                             float* O, int j0, int t) {
#pragma unroll
  for (int jn = 0; jn < 16; ++jn)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      O[(8 * jn + 2 * t + (x & 1)) * BS + j0 + 8 * (x >> 1)] = acc[4 * jn + x];
}

// blockIdx.x: output rank; blockIdx.y: the CTA's kind (gridDim.y == 2:
// values and counts; 1: values only)
__global__ void __launch_bounds__(THREADS, 1)
block_spgemm_sm90_kernel(const __grid_constant__ CUtensorMap a_map,
                         const __grid_constant__ CUtensorMap b_map,
                         const __grid_constant__ CUtensorMap ap_map,
                         const __grid_constant__ CUtensorMap bp_map,
                         const int* __restrict__ pa,
                         const int* __restrict__ pb,
                         const int* __restrict__ flags,
                         const int* __restrict__ seg_ptr,
                         float* __restrict__ out, float* __restrict__ counts,
                         int nnzb_a, int nnzb_b) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t bars = base + BAR_OFF;
  auto full = [&](int st) { return bars + 8u * st; };
  auto ready = [&](int st) { return bars + 8u * (STAGES + st); };
  auto empty = [&](int st) { return bars + 8u * (2 * STAGES + st); };

  const int rank = blockIdx.x;
  const bool count =
      gridDim.y == 2 && blockIdx.y == (COUNTS_FIRST ? 0u : 1u);
  const int w0 = seg_ptr[rank], w1 = seg_ptr[rank + 1];
  const int nk = count ? BS / KCP : BS / KC;     // stages per pair
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(full(st), 1);
      sm90::mbar_init(ready(st), SPLITTERS);
      sm90::mbar_init(empty(st), CONSUMERS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // ---- producer warpgroup: warp 8's first thread issues every copy,
    // warps 9-11 split the values' A tiles ----
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS / 32) {
      if (lane != 0) return;
      int it = 0;
      for (int w = w0; w < w1; ++w) {
        if (!real(flags, pa, pb, w, nnzb_a, nnzb_b)) continue;
        const int ra = pa[w] * BS, rb = pb[w] * BS;
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int st = it % STAGES;
          sm90::mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);
          const uint32_t s = base + st * STAGE_BYTES;
          sm90::mbar_arrive_expect_tx(full(st), STAGE_TX);
          if (count) {
            sm90::tma_load_2d(s + A_OFF, &ap_map, full(st), kc * KCP, ra);
#pragma unroll
            for (int q = 0; q < 2; ++q)
              sm90::tma_load_2d(s + B_OFF + q * 8192, &bp_map, full(st),
                                64 * q, rb + kc * KCP);
          } else {
            sm90::tma_load_2d(s + A_OFF, &a_map, full(st), kc * KC, ra);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              sm90::tma_load_2d(s + B_OFF + q * 4096, &b_map, full(st),
                                32 * q, rb + kc * KC);
          }
        }
      }
    } else if (!count) {
      const int e0 = tid - CONSUMERS - 32;        // 0 .. SPLITTERS - 1
      int it = 0;
      for (int w = w0; w < w1; ++w) {
        if (!real(flags, pa, pb, w, nnzb_a, nnzb_b)) continue;
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int st = it % STAGES;
          sm90::mbar_wait(full(st), (it / STAGES) & 1);
          float4* hi = reinterpret_cast<float4*>(sbase + st * STAGE_BYTES +
                                                 A_OFF);
          float4* lo = reinterpret_cast<float4*>(sbase + st * STAGE_BYTES +
                                                 LO_OFF);
          for (int e1 = e0; e1 < TILE_BYTES / 16;
               e1 += SPLIT_BATCH * SPLITTERS) {
            // every load of the batch in flight before the first split
            float4 x[SPLIT_BATCH];
#pragma unroll
            for (int i = 0; i < SPLIT_BATCH; ++i)
              if (e1 + i * SPLITTERS < TILE_BYTES / 16)
                x[i] = hi[e1 + i * SPLITTERS];
#pragma unroll
            for (int i = 0; i < SPLIT_BATCH; ++i) {
              const int e = e1 + i * SPLITTERS;
              if (e >= TILE_BYTES / 16) break;
              uint32_t h[4], l[4];
              tc::split_tf32(x[i].x, h[0], l[0]);
              tc::split_tf32(x[i].y, h[1], l[1]);
              tc::split_tf32(x[i].z, h[2], l[2]);
              tc::split_tf32(x[i].w, h[3], l[3]);
              hi[e] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                                  __uint_as_float(h[2]),
                                  __uint_as_float(h[3]));
              lo[e] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                                  __uint_as_float(l[2]),
                                  __uint_as_float(l[3]));
            }
          }
          sm90::fence_proxy_async();      // the wgmma reads them next
          sm90::mbar_arrive(ready(st));
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns output columns 64 wg .. 64 wg + 63,
  // all 128 output rows ----
  sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  float* const O = (count ? counts : out) + (size_t)rank * BS * BS;
  float acc[64];
  zero(acc);
  bool written = false;
  int it = 0;

  if (count) {
    const int j0 = wg * 64 + wq * 16 + g;
    for (int w = w0; w < w1; ++w) {
      const int f = flags[w];                   // uniform across the CTA
      if (f & 1) zero(acc);
      if (real(flags, pa, pb, w, nnzb_a, nnzb_b)) {
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int st = it % STAGES;
          sm90::mbar_wait(full(st), (it / STAGES) & 1);
          const uint32_t s = base + st * STAGE_BYTES;
          sm90::fence_operand(acc);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KCP / 16; ++kk)
            sm90::wgmma_ss_at_n128(
                acc,
                sm90::desc_sw128(s + B_OFF + wg * 8192 + kk * 2048, 8192,
                                 1024),
                sm90::desc_sw128(s + A_OFF + kk * 32, 16, 1024), 1);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_operand(acc);
          sm90::mbar_arrive(empty(st));
        }
      }
      if (f & 4) {
        store_counts(acc, O, j0, t);
        written = true;
      }
    }
    if (!written) {            // a rank no entry writes comes out as zeros
      zero(acc);
      store_counts(acc, O, j0, t);
    }
    return;
  }

  const int j = sm90::ct_col(wg, wq, g);
  float part[64];
  zero(part);
  for (int w = w0; w < w1; ++w) {
    const int f = flags[w];                     // uniform across the CTA
    if (f & 1) zero(acc);
    if (real(flags, pa, pb, w, nnzb_a, nnzb_b)) {
      for (int kc = 0; kc < nk; ++kc, ++it) {
        const int st = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        sm90::mbar_wait(full(st), ph);          // B landed
        sm90::mbar_wait(ready(st), ph);         // A split
        const unsigned char* bs = sbase + st * STAGE_BYTES + B_OFF;
        const uint32_t ahi = base + st * STAGE_BYTES + A_OFF;
        const uint32_t alo = base + st * STAGE_BYTES + LO_OFF;
        // this thread's B^T fragments of the stage's four k8 steps:
        // registers 0, 1 at k = 8s + t, 2, 3 at k + 4; columns j, j + 1
        uint32_t bhi[KC / 8][4], blo[KC / 8][4];
#pragma unroll
        for (int s = 0; s < KC / 8; ++s)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 v = *reinterpret_cast<const float2*>(
                bs + sm90::ct_b_offset(8 * s + t + 4 * h, j));
            tc::split_tf32(v.x, bhi[s][2 * h], blo[s][2 * h]);
            tc::split_tf32(v.y, bhi[s][2 * h + 1], blo[s][2 * h + 1]);
          }
#pragma unroll
        for (int s = 0; s < KC / 8; ++s) {
          sm90::fence_operand(bhi[s]);
          sm90::fence_operand(blo[s]);
        }
#pragma unroll
        for (int s0 = 0; s0 < KC / 8; s0 += FLUSH) {
          sm90::fence_operand(part);
          sm90::wgmma_fence();
#pragma unroll
          for (int s = s0; s < s0 + FLUSH; ++s) {
            // small terms first: a_lo b_hi, a_hi b_lo, a_hi b_hi
            sm90::wgmma_rs_tf32_n128(
                part, bhi[s], sm90::desc_sw128(alo + 32 * s, 16, 1024),
                s > s0);
            sm90::wgmma_rs_tf32_n128(
                part, blo[s], sm90::desc_sw128(ahi + 32 * s, 16, 1024), 1);
            sm90::wgmma_rs_tf32_n128(
                part, bhi[s], sm90::desc_sw128(ahi + 32 * s, 16, 1024), 1);
          }
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_operand(part);
          if (s0 + FLUSH >= KC / 8)
            sm90::mbar_arrive(empty(st));       // stage st may be refilled
#pragma unroll
          for (int x = 0; x < 64; ++x) acc[x] += part[x];
        }
      }
    }
    if (f & 4) {
      store_values(acc, O, j, t);
      written = true;
    }
  }
  if (!written) {              // a rank no entry writes comes out as zeros
    zero(acc);
    store_values(acc, O, j, t);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
  const float *a, *b;
  const bf16 *a_pat, *b_pat;
  const int *pa, *pb, *flags, *seg_ptr;
  float *out, *counts;
  int nnzb_out, nnzb_a, nnzb_b;
  cudaStream_t stream;
};

// Set the kernel's dynamic shared memory and check that setmaxnreg can
// move its registers: the registers the CTA launches with (numRegs a
// thread) must cover the consumers' raise from what the producer
// warpgroup gives up, or setmaxnreg.inc would wait forever.  Done once
// per device: both calls cost host time on every launch.
cudaError_t prepare() {
  static std::atomic<uint32_t> done{0};            // bit d: device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = dev < 32 ? 1u << dev : 0u;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(block_spgemm_sm90_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, block_spgemm_sm90_kernel);
  if (err != cudaSuccess) return err;
  const int r = attr.numRegs;
  if (r < PRODUCER_REGS || r > CONSUMER_REGS ||
      (r - PRODUCER_REGS) * (THREADS - CONSUMERS) <
          (CONSUMER_REGS - r) * CONSUMERS)
    return cudaErrorLaunchOutOfResources;
  done.fetch_or(bit);
  return cudaSuccess;
}

cudaError_t launch(const Args& x) {
  cudaError_t err = prepare();
  if (err != cudaSuccess) return err;
  // with an empty A or B no entry is real: the maps are never read
  CUtensorMap am{}, bm{}, apm{}, bpm{};
  if (x.nnzb_a > 0 && x.nnzb_b > 0) {
    const uint64_t ra = (uint64_t)x.nnzb_a * BS, rb = (uint64_t)x.nnzb_b * BS;
    if ((err = sm90::map_2d(&am, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x.a, ra,
                            BS, 32, BS)) ||
        (err = sm90::map_2d(&bm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x.b, rb,
                            BS, 32, 32)))
      return err;
    if (x.counts &&
        ((err = sm90::map_2d(&apm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                             x.a_pat, ra, BS, 64, BS)) ||
         (err = sm90::map_2d(&bpm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                             x.b_pat, rb, BS, 64, 64))))
      return err;
  }
  block_spgemm_sm90_kernel<<<dim3(x.nnzb_out, x.counts ? 2 : 1), THREADS,
                             SMEM, x.stream>>>(
      am, bm, apm, bpm, x.pa, x.pb, x.flags, x.seg_ptr, x.out, x.counts,
      x.nnzb_a, x.nnzb_b);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// C interface (bound with ctypes), the signatures of block_spgemm.cu's
// entry points.  Pointers are device pointers of contiguous tensors with
// 16-byte aligned bases: a (nnzb_a, 128, 128) f32, b (nnzb_b, 128, 128)
// f32, pa/pb/flags (W,) int32, seg_ptr (nnzb_out + 1,) int32 segment
// offsets of the rank-sorted worklist, out (nnzb_out, 128, 128) f32, every
// block of which the kernel writes.  Returns the cudaError_t of the launch
// (0 on success); a block size other than 128 or a misaligned pointer
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int block_spgemm_sm90_f32(const float* a, const float* b,
                                     const int* pa, const int* pb,
                                     const int* flags, const int* seg_ptr,
                                     float* out, int nnzb_out, int bs,
                                     int nnzb_a, int nnzb_b, void* stream) {
  if (bs != BS || !aligned16(a) || !aligned16(b) || !aligned16(out))
    return cudaErrorInvalidValue;
  if (nnzb_out <= 0) return 0;
  return launch({a, b, nullptr, nullptr, pa, pb, flags, seg_ptr, out,
                 nullptr, nnzb_out, nnzb_a, nnzb_b,
                 static_cast<cudaStream_t>(stream)});
}

// The values and the structural counts in one launch: as
// block_spgemm_sm90_f32, plus a_pat (nnzb_a, 128, 128) and b_pat (nnzb_b,
// 128, 128) bf16 0/1 patterns of the operands' stored entries, and counts
// (nnzb_out, 128, 128) f32, which receives the same replay over the
// patterns.
extern "C" int block_spgemm_sm90_with_structure(
    const float* a, const float* b, const void* a_pat, const void* b_pat,
    const int* pa, const int* pb, const int* flags, const int* seg_ptr,
    float* out, float* counts, int nnzb_out, int bs, int nnzb_a, int nnzb_b,
    void* stream) {
  if (bs != BS || !aligned16(a) || !aligned16(b) || !aligned16(a_pat) ||
      !aligned16(b_pat) || !aligned16(out) || !aligned16(counts))
    return cudaErrorInvalidValue;
  if (nnzb_out <= 0) return 0;
  return launch({a, b, static_cast<const bf16*>(a_pat),
                 static_cast<const bf16*>(b_pat), pa, pb, flags, seg_ptr, out,
                 counts, nnzb_out, nnzb_a, nnzb_b,
                 static_cast<cudaStream_t>(stream)});
}

// The kernel both entry points run: info receives threads per CTA,
// dynamic shared memory bytes, registers per thread at launch, local
// (spill) bytes per thread and resident CTAs per SM on the current device.
// Returns a cudaError_t.
extern "C" int block_spgemm_sm90_info(int* info) {
  cudaError_t err = prepare();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, block_spgemm_sm90_kernel);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, block_spgemm_sm90_kernel, THREADS, SMEM);
  info[0] = THREADS;
  info[1] = SMEM;
  info[2] = attr.numRegs;
  info[3] = (int)attr.localSizeBytes;
  info[4] = ctas;
  return err;
}
