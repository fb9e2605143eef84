// Tile SDDMM for Hopper (sm_90a) at 128 x 128 blocks: TMA loads behind
// mbarriers, a producer warpgroup, two consumer warpgroups on
// wgmma.mma_async, TMA stores, one persistent CTA an SM.
//
// Replaces the TPU kernel
//   repro/kernels/masked_matmul/kernel.py::masked_matmul_kernel
// for bm = bn = 128 with f32 or bf16 operands, contiguous, 16-byte aligned,
// with rows of a multiple of 16 bytes (kernel.py's dispatch predicate,
// masked_matmul_sm90_takes); every other shape runs masked_matmul.cu's
// mma.sync kernel.  It computes what that kernel computes: for every mask
// tile r,
//   out[r] = A[bi[r]*128 : +128, :] @ B[:, bj[r]*128 : +128]
// in f32, from f32 operands (3xTF32, f32 accuracy) or bf16 operands (one
// pass); a tile whose block coordinates fall outside A or B comes out as
// zeros.  Each tile is summed by one CTA over all of K in one fixed order,
// with no atomics: results are deterministic.
//
// Numerics.  f32: a_lo b_hi + a_hi b_lo + a_hi b_hi on tf32 wgmma, hi = rna(x)
// and lo = rna(x - hi) for both operands (RAW_HI_A, RAW_HI_B).  The tensor
// cores' f32 sums truncate, so each consumer sums FLUSH = 2 k8 steps (six
// wgmma) in a partial from zero and adds it to its f32 accumulator with IEEE
// rounding.  That keeps masked_matmul.cu's accuracy
// (tools/masked_matmul_sm90_variants.py, NVIDIA H100 80GB HBM3, 700 W): at
// sddmm-8192 1.55e-7 normwise of float64 (mma.sync 1.37e-7) and no output
// beyond rtol = atol = 1e-5 of float64, like mma.sync, where the raw f32 word
// as hi (which tf32 wgmma reads truncated, as in flash_mask_f32_sm90.cu) with a
// flush per 32-deep stage read 3.46e-7 and 539 such outputs, and 5 at the GPU
// tests' K = 384 case, which holds every output to that limit.
// tests/test_torch_masked_matmul_sm90.py emulates the scheme with FLUSH and the
// hi schemes read from here.  Integers below 2^11 have lo = 0 and stay exact.
// bf16: one pass, products exact, sums accumulated in the tensor cores, as
// masked_matmul.cu's bf16 instance (2e-2 of plain).
//
// Bound on an H100 SXM at the path's shape, sddmm-8192 (M = N = 8192,
// K = 256, 2,432 mask tiles of the tile-8192 mask): 2 * 2,432 * 128^2 *
// 256 = 20.4 GFLOP.  f32: three TF32 passes at 495 TFLOP/s take 0.124 ms,
// its 176 MB (A and B once, 159 MB of output) 0.053 ms at 3.35 TB/s: bound
// by operations.  bf16: one pass at 989 TFLOP/s takes 0.021 ms, its 168 MB
// 0.050 ms: bound by bytes.  masked_matmul.cu reached 23-25 % of the f32
// bound, held back by (1) instruction issue: each k-step issued about 200
// instructions per warp beside its 48 mma.sync (fragment loads, every warp
// splitting every operand element it read, the flush's adds), and (2) a
// cp.async ring that filled and drained once per 128 x 128 tile (K = 256
// is 8 chunks of 32).  This kernel:
//   - (1) the products are warpgroup wgmma: per 32-deep stage a consumer
//     warpgroup issues 12 tf32 m64n128k8 (three per k8 step), each A
//     element is split once per tile by the producer's three idle warps
//     (hi in place, lo beside it), each B element once per tile by the
//     one consumer thread that holds it;
//   - (2) persistent CTAs: one CTA an SM walks tiles r, r + grid, ... in
//     the mask's (CSR) order, so neighbouring CTAs read the same A panel
//     from L2, and its producer thread runs on into the next tile's stages
//     while the consumers store this one: the ring never drains between
//     tiles (one CTA a tile took 26 % more time in f32, 53 % in bf16);
//   - the layout: tf32 wgmma reads a shared-memory operand only K-major
//     (sm90.cuh), and B is N-contiguous.  So an f32 tile is computed
//     transposed, C^T = B^T A^T (block_spgemm_sm90.cu's mainloop): B^T's
//     64 columns per consumer warpgroup are the register A operand (rows
//     permuted by sm90::ct_col so that a thread holds adjacent output
//     columns),
//     A's row panel, K-major as stored, the shared-memory B operand of
//     m64n128k8 read by both warpgroups.  bf16 needs no transpose: C = A B
//     from shared memory, A K-major, B read MN-major through the transpose
//     bit, as two m64n64k16 a k16 step, one per 64-column panel of B, 64
//     output rows per consumer warpgroup;
//   - the output (159 MB, a third of what the kernel moves): each consumer
//     warpgroup writes its 64 x 128 share of the tile into a staging tile
//     in shared memory (the 128-byte swizzle, conflict-free) and one thread
//     stores it with TMA; 8-byte stores straight from the accumulators,
//     with a ring a stage deeper, took 4 % more time in f32, 28 % in bf16;
//   - the ring: one producer thread issues the TMA loads of A's 128-row
//     panel (the hardware's zero fill covers K past its end) and B's
//     128-column panel per 128-byte-deep stage (32 f32 or 64 bf16 of K)
//     into STAGES (f32) or STAGES_BF16 stages guarded by full (TMA bytes
//     landed), ready (f32: A split) and empty (both consumer warpgroups
//     done) mbarriers.  Registers (f32): the launch gives 168 a thread, the
//     producer warpgroup drops to PRODUCER_REGS and the consumers rise to
//     CONSUMER_REGS (setmaxnreg); a consumer holds the accumulator, the
//     partial sum and a stage's B^T fragments.
// Shared memory: a stage holds f32 A (hi after the split), A lo and B, 16
// KiB each, or bf16 A and B; the staging tiles 64 KiB.
// What holds f32 now: one tf32 pass instead of three saves only 17 %, so
// the tensor cores are not the limit; the suspects (stall reasons are not
// measured) are the 256 KB of A and B panels a tile moves from L2 (623 MB
// a call) and their splits.  The flush every 2 k8 steps costs 4 % against
// one per stage, rna hi for A (stored) 4 % against the raw word.
// tools/masked_matmul_sm90_variants.py times the stage counts, the flush
// interval, the hi schemes, the persistent grid against one CTA a tile, the
// store path, A's split by a pre-pass kernel into scratch memory (0.6 %
// faster) and the register split against the adopted build and the
// mma.sync kernel, and reports each one's f32 accuracy (the figures here:
// its run on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md).  The C entry
// builds the tensor maps on every call (sm90::map_2d) and passes them as
// __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BT = 128;                  // bm = bn: the blocks it takes
constexpr int TILE_BYTES = BT * 128;     // 128 rows of 128 bytes
// f32: ring depth, k8 steps per IEEE flush (1, 2 or 4; 4: one per stage)
// and the hi scheme of A's split (in shared memory) and of B^T's (in
// registers): true, the raw word, which tf32 wgmma reads truncated, lo =
// rna(x - trunc x); false, hi = rna(x), lo = rna(x - hi) (A's hi stored)
constexpr int STAGES = 3;
constexpr int FLUSH = 2;
constexpr bool RAW_HI_A = false;
constexpr bool RAW_HI_B = false;
// bf16: ring depth
constexpr int STAGES_BF16 = 4;

constexpr int THREADS = 384;             // consumers 0-255, producer 256-383
constexpr int CONSUMERS = 256;
constexpr int SPLITTERS = 96;            // the producer's warps 9-11 (f32)
// 16-byte words of A a splitter loads before it splits any (its share of
// a tile is ceil(1024 / 96) = 11)
constexpr int SPLIT_BATCH = 4;
// registers a thread of each role holds after setmaxnreg (f32)
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;

template <typename E>
struct Cfg {
  static constexpr bool F32 = sizeof(E) == 4;
  static constexpr int KC = 128 / (int)sizeof(E);   // K a stage
  static constexpr int NSTAGE = F32 ? STAGES : STAGES_BF16;
  // stage layout: A | B | (f32) A lo
  static constexpr int A_OFF = 0, B_OFF = TILE_BYTES, LO_OFF = 2 * TILE_BYTES;
  static constexpr int STAGE_TX = 2 * TILE_BYTES;      // TMA bytes a stage
  static constexpr int STAGE_BYTES = (F32 ? 3 : 2) * TILE_BYTES;
  // the staging tiles (64 KiB, so the rings are a stage shorter than they
  // could be): a consumer warpgroup's 64 x 128 share of the output tile as
  // 32-column boxes (f32: two of 128 rows, the tile transposed; bf16: four
  // of 64 rows), each in the 128-byte swizzle
  static constexpr int OUT_BOX_ROWS = F32 ? 128 : 64;
  static constexpr int STAGING_OFF = NSTAGE * STAGE_BYTES;
  static constexpr int BAR_OFF = STAGING_OFF + 2 * 32768;
  // + 1024 bytes to align the base to the swizzle's 1024 bytes
  static constexpr int SMEM = BAR_OFF + 8 * 3 * NSTAGE + 1024;
  static_assert(SMEM <= 232448, "more shared memory than a CTA may have");
  // B's columns a TMA box (128 bytes) and the bytes between boxes
  static constexpr int B_BOX = KC, B_BOX_BYTES = KC * 128;
};

// whether tile (ib, jb) lies inside A's mt row panels and B's nt column
// panels; every role evaluates it, so the barriers' phases stay aligned
__device__ __forceinline__ bool inside(int ib, int jb, int mt, int nt) {
  return ib >= 0 && ib < mt && jb >= 0 && jb < nt;
}

// rna to tf32 in integer arithmetic: adding 2^12 to the bit pattern and
// clearing its low 13 bits rounds to 10 mantissa bits, to nearest with
// ties away from zero (cvt.rna.tf32.f32's result for every finite x)
__device__ __forceinline__ uint32_t rna_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-21 |x|): hi the raw word (RAW) or rna(x), lo =
// rna(x - the tf32 that wgmma reads of hi)
template <bool RAW>
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = RAW ? __float_as_uint(x) : rna_bits(x);
  lo = rna_bits(x - __uint_as_float(hi & 0xffffe000u));
}

// byte offset of element (row i, column c) of a staging tile of 32-column
// boxes of `rows` rows x 128 bytes, 16-byte chunks swizzled by the row
__device__ __forceinline__ int staged(int i, int c, int rows) {
  return (c >> 5) * rows * 128 + i * 128 + ((((c & 31) >> 2) ^ (i & 7)) << 4) +
         ((c & 3) << 2);
}

__device__ __forceinline__ void zero(float (&d)[64]) {
#pragma unroll
  for (int x = 0; x < 64; ++x) d[x] = 0.0f;
}

// a consumer warpgroup's share of the tile into its staging tile at stg
// (generic proxy), one 8-byte store a pair.  f32: the accumulator of C^T,
// rows g and g + 8 output columns c and c + 1 (sm90::ct_col) of every
// output row
__device__ __forceinline__ void stage_transposed(const float (&acc)[64],
                                                 unsigned char* stg, int c,
                                                 int t) {
#pragma unroll
  for (int jn = 0; jn < 16; ++jn)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      *reinterpret_cast<float2*>(stg + staged(8 * jn + 2 * t + b, c, 128)) =
          make_float2(acc[4 * jn + b], acc[4 * jn + 2 + b]);
}

// bf16: accumulator row 16 wq + g + 8 h is output row i + 8 h, columns
// 8 jn + 2 t and the next
__device__ __forceinline__ void stage_rows(const float (&acc)[64],
                                           unsigned char* stg, int i,
                                           int t) {
#pragma unroll
  for (int jn = 0; jn < 16; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(stg + staged(i + 8 * h, 8 * jn + 2 * t, 64)) =
          make_float2(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
}

// out_map: the output as (nnzb * 128) x 128 f32; mt, nt: A's row panels
// and B's column panels of 128; nk: stages a tile.
template <typename E>
__global__ void __launch_bounds__(THREADS, 1)
masked_matmul_sm90_kernel(const __grid_constant__ CUtensorMap a_map,
                          const __grid_constant__ CUtensorMap b_map,
                          const __grid_constant__ CUtensorMap out_map,
                          const int* __restrict__ bi,
                          const int* __restrict__ bj, int nnzb, int mt,
                          int nt, int nk) {
  using C = Cfg<E>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t bars = base + C::BAR_OFF;
  auto full = [&](int st) { return bars + 8u * st; };
  auto ready = [&](int st) { return bars + 8u * (C::NSTAGE + st); };
  auto empty = [&](int st) { return bars + 8u * (2 * C::NSTAGE + st); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int st = 0; st < C::NSTAGE; ++st) {
      sm90::mbar_init(full(st), 1);
      sm90::mbar_init(ready(st), SPLITTERS);
      sm90::mbar_init(empty(st), CONSUMERS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // ---- producer warpgroup: warp 8's first thread issues every copy,
    // warps 9-11 write A's lo (f32) ----
    if constexpr (C::F32) sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS / 32) {
      if (lane != 0) return;
      int it = 0;
      for (int r = blockIdx.x; r < nnzb; r += gridDim.x) {
        const int ib = bi[r], jb = bj[r];
        if (!inside(ib, jb, mt, nt)) continue;
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int st = it % C::NSTAGE;
          sm90::mbar_wait(empty(st), ((it / C::NSTAGE) & 1) ^ 1);
          const uint32_t s = base + st * C::STAGE_BYTES;
          sm90::mbar_arrive_expect_tx(full(st), C::STAGE_TX);
          sm90::tma_load_2d(s + C::A_OFF, &a_map, full(st), kc * C::KC,
                            ib * BT);
#pragma unroll
          for (int q = 0; q < BT / C::B_BOX; ++q)
            sm90::tma_load_2d(s + C::B_OFF + q * C::B_BOX_BYTES, &b_map,
                              full(st), jb * BT + q * C::B_BOX, kc * C::KC);
        }
      }
    } else if constexpr (C::F32) {
      const int e0 = tid - CONSUMERS - 32;        // 0 .. SPLITTERS - 1
      int it = 0;
      for (int r = blockIdx.x; r < nnzb; r += gridDim.x) {
        if (!inside(bi[r], bj[r], mt, nt)) continue;
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int st = it % C::NSTAGE;
          sm90::mbar_wait(full(st), (it / C::NSTAGE) & 1);
          float4* hi = reinterpret_cast<float4*>(
              sbase + st * C::STAGE_BYTES + C::A_OFF);
          float4* lo = reinterpret_cast<float4*>(
              sbase + st * C::STAGE_BYTES + C::LO_OFF);
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
              split_tf32<RAW_HI_A>(x[i].x, h[0], l[0]);
              split_tf32<RAW_HI_A>(x[i].y, h[1], l[1]);
              split_tf32<RAW_HI_A>(x[i].z, h[2], l[2]);
              split_tf32<RAW_HI_A>(x[i].w, h[3], l[3]);
              if (!RAW_HI_A)      // the raw word is its own hi
                hi[e] = make_float4(__uint_as_float(h[0]),
                                    __uint_as_float(h[1]),
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

  // ---- consumers ----
  if constexpr (C::F32) sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  float acc[64];
  int it = 0;
  // the warpgroup's staging tile, written by all of its threads (named
  // barrier 1 + wg), stored by its first
  unsigned char* const stg = sbase + C::STAGING_OFF + wg * 32768;
  const uint32_t stg_addr = base + C::STAGING_OFF + wg * 32768;
  const bool storer = (tid & 127) == 0;
  auto staging_free = [&]() {      // the previous tile's store read it
    if (storer) sm90::bulk_wait_read<0>();
    sm90::named_sync(1 + wg, 128);
  };
  auto store_staged = [&](int row0, int col0) {
    sm90::fence_proxy_async();     // the TMA store reads it next
    sm90::named_sync(1 + wg, 128);
    if (storer) {
#pragma unroll
      for (int q = 0; q < (C::F32 ? 2 : 4); ++q)
        sm90::tma_store_2d(&out_map, stg_addr + q * C::OUT_BOX_ROWS * 128,
                           col0 + 32 * q, row0);
      sm90::bulk_commit();
    }
  };

  if constexpr (!C::F32) {
    // warpgroup wg owns output rows 64 wg .. 64 wg + 63, all 128 columns
    for (int r = blockIdx.x; r < nnzb; r += gridDim.x) {
      const int ib = bi[r], jb = bj[r];
      zero(acc);
      if (inside(ib, jb, mt, nt)) {
        int prev = 0;
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int st = it % C::NSTAGE;
          sm90::mbar_wait(full(st), (it / C::NSTAGE) & 1);
          const uint32_t s = base + st * C::STAGE_BYTES;
          sm90::fence_operand(acc);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < C::KC / 16; ++kk) {
            const uint64_t da = sm90::desc_sw128(
                s + C::A_OFF + wg * 8192 + kk * 32, 16, 1024);
#pragma unroll
            for (int q = 0; q < 2; ++q)
              sm90::wgmma_ss_bt_n64(
                  acc + 32 * q, da,
                  sm90::desc_sw128(s + C::B_OFF + q * 8192 + kk * 2048, 8192,
                                   1024),
                  1);
          }
          sm90::wgmma_commit();
          // the previous stage's products are done: free its slot while
          // this one's run
          sm90::wgmma_wait<1>();
          sm90::fence_operand(acc);
          if (kc > 0) sm90::mbar_arrive(empty(prev));
          prev = st;
        }
        sm90::wgmma_wait<0>();
        sm90::fence_operand(acc);
        if (nk > 0) sm90::mbar_arrive(empty(prev));
      }
      staging_free();
      stage_rows(acc, stg, wq * 16 + g, t);
      store_staged(r * BT + wg * 64, 0);
    }
  } else {
    // f32: warpgroup wg owns output columns 64 wg .. 64 wg + 63 (rows of
    // C^T), all 128 output rows
    const int j = sm90::ct_col(wg, wq, g);
    float part[64];
    zero(part);
    for (int r = blockIdx.x; r < nnzb; r += gridDim.x) {
      const int ib = bi[r], jb = bj[r];
      zero(acc);
      if (inside(ib, jb, mt, nt)) {
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int st = it % C::NSTAGE;
          const uint32_t ph = (it / C::NSTAGE) & 1;
          sm90::mbar_wait(full(st), ph);          // B landed
          sm90::mbar_wait(ready(st), ph);         // A's lo written
          const unsigned char* bs = sbase + st * C::STAGE_BYTES + C::B_OFF;
          const uint32_t ahi = base + st * C::STAGE_BYTES + C::A_OFF;
          const uint32_t alo = base + st * C::STAGE_BYTES + C::LO_OFF;
          // this thread's B^T fragments of the stage's four k8 steps:
          // registers 0, 1 at k = 8s + t, 2, 3 at k + 4; columns j, j + 1
          uint32_t bhi[C::KC / 8][4], blo[C::KC / 8][4];
#pragma unroll
          for (int s = 0; s < C::KC / 8; ++s)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 v = *reinterpret_cast<const float2*>(
                  bs + sm90::ct_b_offset(8 * s + t + 4 * h, j));
              split_tf32<RAW_HI_B>(v.x, bhi[s][2 * h], blo[s][2 * h]);
              split_tf32<RAW_HI_B>(v.y, bhi[s][2 * h + 1],
                                   blo[s][2 * h + 1]);
            }
#pragma unroll
          for (int s = 0; s < C::KC / 8; ++s) {
            sm90::fence_operand(bhi[s]);
            sm90::fence_operand(blo[s]);
          }
#pragma unroll
          for (int s0 = 0; s0 < C::KC / 8; s0 += FLUSH) {
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
            if (s0 + FLUSH >= C::KC / 8)
              sm90::mbar_arrive(empty(st));       // stage st may be refilled
#pragma unroll
            for (int x = 0; x < 64; ++x) acc[x] += part[x];
          }
        }
      }
      staging_free();
      stage_transposed(acc, stg, j - wg * 64, t);
      store_staged(r * BT, wg * 64);
    }
  }
  if (storer) sm90::bulk_wait<0>();      // every store written
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
  const void *a, *b;
  const int *bi, *bj;
  float* out;
  int nnzb, M, K, N;
  cudaStream_t stream;
};

// Set the instance's dynamic shared memory, check (f32) that setmaxnreg
// can move its registers: the registers the CTA launches with (numRegs a
// thread) must cover the consumers' raise from what the producer
// warpgroup gives up, or setmaxnreg.inc would wait forever; and read the
// device's SM count (the persistent grid).  Done once per device: these
// calls cost host time on every launch.
template <typename E>
cudaError_t prepare(int* sms) {
  static std::atomic<uint32_t> done{0};            // bit d: device d
  static int sm_count[32];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = dev < 32 ? 1u << dev : 0u;
  if (done.load() & bit) {
    *sms = sm_count[dev];
    return cudaSuccess;
  }
  auto* fn = masked_matmul_sm90_kernel<E>;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<E>::SMEM);
  if (err != cudaSuccess) return err;
  if (Cfg<E>::F32) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return err;
    const int r = attr.numRegs;
    if (r < PRODUCER_REGS || r > CONSUMER_REGS ||
        (r - PRODUCER_REGS) * (THREADS - CONSUMERS) <
            (CONSUMER_REGS - r) * CONSUMERS)
      return cudaErrorLaunchOutOfResources;
  }
  int n = 0;
  err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *sms = n;
  if (bit) {
    sm_count[dev] = n;
    done.fetch_or(bit);
  }
  return cudaSuccess;
}

template <typename E>
cudaError_t launch(const Args& x) {
  using C = Cfg<E>;
  int sms = 0;
  cudaError_t err = prepare<E>(&sms);
  if (err != cudaSuccess) return err;
  const CUtensorMapDataType type = C::F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // with an empty A, B or K no tile is read: the maps are never used
  const bool reads = x.M > 0 && x.N > 0 && x.K > 0;
  CUtensorMap am{}, bm{}, om{};
  if (reads &&
      ((err = sm90::map_2d(&am, type, sizeof(E), x.a, x.M, x.K, C::KC,
                           BT)) ||
       (err = sm90::map_2d(&bm, type, sizeof(E), x.b, x.K, x.N, C::B_BOX,
                           C::KC))))
    return err;
  if ((err = sm90::map_2d(&om, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x.out,
                          (uint64_t)x.nnzb * BT, BT, 32, C::OUT_BOX_ROWS)))
    return err;
  const int grid = sms < x.nnzb ? sms : x.nnzb;       // persistent
  masked_matmul_sm90_kernel<E><<<grid, THREADS, C::SMEM, x.stream>>>(
      am, bm, om, x.bi, x.bj, x.nnzb, x.M / BT, x.N / BT,
      (x.K + C::KC - 1) / C::KC);
  return cudaGetLastError();
}

template <typename E>
cudaError_t instance_info(int* out) {
  int sms = 0;
  cudaError_t err = prepare<E>(&sms);
  if (err != cudaSuccess) return err;
  auto* fn = masked_matmul_sm90_kernel<E>;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, THREADS,
                                                      Cfg<E>::SMEM);
  out[0] = THREADS;
  out[1] = Cfg<E>::SMEM;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = ctas;
  return err;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// C interface (bound with ctypes): masked_matmul.cu's signature.
// Pointers are device pointers of contiguous tensors with 16-byte aligned
// bases: a (M, K) and b (K, N), both f32 (dtype 0) or both bf16 (dtype 1),
// rows of a multiple of 16 bytes; bi, bj (nnzb,) int32 mask tile
// coordinates; out (nnzb, 128, 128) f32, every tile of which the kernel
// writes.  Returns the cudaError_t of the launch (0 on success); blocks
// other than 128 x 128, another dtype, or a misaligned pointer or row
// stride return cudaErrorInvalidValue and launch nothing.
extern "C" int masked_matmul_sm90(const void* a, const void* b,
                                  const int* bi, const int* bj, float* out,
                                  int nnzb, int M, int K, int N, int bm,
                                  int bn, int dtype, void* stream) {
  const long long eb = dtype == 0 ? 4 : 2;
  if (bm != BT || bn != BT || (dtype != 0 && dtype != 1) || !aligned16(a) ||
      !aligned16(b) || !aligned16(out) || (K * eb) % 16 || (N * eb) % 16 ||
      M < 0 || K < 0 || N < 0)
    return cudaErrorInvalidValue;
  if (nnzb <= 0) return 0;
  const Args x{a, b, bi, bj, out, nnzb, M, K, N,
               static_cast<cudaStream_t>(stream)};
  return dtype == 0 ? launch<float>(x) : launch<bf16>(x);
}

// The instance masked_matmul_sm90 runs for dtype (0 f32, 1 bf16): info
// receives threads per CTA, dynamic shared memory bytes, registers per
// thread at launch, local (spill) bytes per thread and resident CTAs per
// SM on the current device.  Returns a cudaError_t.
extern "C" int masked_matmul_sm90_info(int dtype, int* info) {
  if (dtype == 0) return instance_info<float>(info);
  if (dtype == 1) return instance_info<bf16>(info);
  return cudaErrorInvalidValue;
}
