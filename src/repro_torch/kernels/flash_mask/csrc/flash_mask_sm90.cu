// Block-masked flash attention in bf16, designed for Hopper (sm_90a): TMA
// loads behind mbarriers, one producer warp, consumer warpgroups on
// wgmma.mma_async.
//
// Replaces the TPU kernel
//   repro/kernels/flash_mask/kernel.py::flash_mask_kernel
// together with the batch/head vmap of repro/kernels/flash_mask/ops.py, for
// bf16 inputs with q and kv blocks of 64 or 128 and a head dim that is a
// multiple of 16 up to 128 (kernel.py's dispatch predicate; every other
// bf16 shape runs flash_mask.cu's mma.sync kernel).  It computes what
// flash_mask.cu computes: one CTA per (q-block, batch * head) walks its
// segment seg_ptr[qb] .. seg_ptr[qb + 1] of the qi-sorted worklist
// (ki, flags) in order, with no atomics, so results are deterministic; flag
// bit 1 resets the running max m, normaliser l and accumulator, bit 2
// writes acc / l (rows with l == 0 as 0); the element mask (causal: k <= q;
// window: q - k < window or k < prefix) applies at q + q_offset, masked
// scores are NEG_INF = -1e30 and their p zeroed; an out-of-range kv-block
// is fully masked; a never-visited q-block stays zero; query head h of
// batch b reads kv head (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv); p.v takes
// p in two bf16 terms, p = hi + lo (one term exceeds the layer's 2e-3
// normwise limit: tests/test_torch_tc_numerics.py).  Longest q-blocks
// launch first.
//
// Bound on an H100 SXM at the full-width llama3.2-1b layer (B 4, Hq 32,
// Hkv 8, S 2048, D 64, 128-blocks, causal): 68.75 GFLOP at the allowed
// elements, 0.0695 ms at 989 TFLOP/s of bf16 tensor cores; 84 MB of q, k, v
// and output, 0.025 ms at 3.35 TB/s: bound by operations.  The tiles issue
// 109.5 GFLOP with p.v twice, so at most about 63 % of that bound is
// reachable.  flash_mask.cu's mma.sync kernel reached 11 % of it: mma.sync
// runs at a fraction of the rate of wgmma, every thread computed cp.async
// addresses, each tile had two __syncthreads, and registers were capped at
// 128 with spills.  This kernel:
//   - one producer warp issues one TMA load of q per CTA and, per worklist
//     entry, of the k and v tiles into a ring of STAGES stages, each
//     guarded by a full and an empty mbarrier; an out-of-range kv-block
//     arrives on its full barrier with no bytes, so the phases of every
//     stage stay aligned.  Its warpgroup lowers its registers to 24
//     (setmaxnreg); its other three warps exit at once and exist only for
//     that: ptxas starts the kernel at 168 registers a thread (128 at
//     bq = 64) whatever the launch bounds, and what one warp alone gives
//     up would not fund the consumers' raise;
//   - consumer warpgroups of 64 query rows (two at bq = 128, one at
//     bq = 64; setmaxnreg raised to 232) run S = q.k^T as wgmma
//     m64nBKk16 with both operands in shared memory, in the 128-byte
//     swizzle TMA writes (head dim cut into 64-column panels: one at D 64,
//     two at D 112 and 128; at D 112 the tensor map's width is 112 and TMA
//     fills columns 112-127 with zeros);
//   - the element mask is applied only where a warpgroup's 64 rows
//     straddle the causal diagonal, the window edge or the prefix end; the
//     online softmax stays in registers (quad shuffles), over partial
//     maxima and sums, with ex2.approx and (scale > 0) the scale folded
//     into the exponential's fma;
//   - p.v repacks the S accumulator into bf16 hi and lo A operands in
//     registers (the accumulator's n8 blocks are mma.sync C fragments, two
//     of them one k16 A operand) and runs wgmma's register-A form against
//     v in shared memory read transposed, lo then hi into one accumulator,
//     in PV_BATCHES batches of keys: with S, O and all of p's hi and lo
//     live at once, ptxas serialised every wgmma for want of registers at
//     D 128; the stage's empty barrier is released after the last batch's
//     wait;
//   - the output leaves through a shared-memory staging tile per warpgroup
//     in 16-byte stores; columns >= D are never written.  Rows no flush
//     reaches are written as zeros, so the wrapper does not clear the
//     output first (a 34 MB memset at the llama layer).
// What holds it back (tools/flash_sm90_variants.py; PERF.md): each
// warpgroup runs q.k^T, softmax and p.v in turn, and the tensor cores
// idle for about two thirds of a tile; dropping the exponentials or the lo
// product moved the llama layer by 1-4 %.  FlashAttention-3's overlap of
// one tile's p.v with the next tile's q.k^T needs S, p's two terms and O
// in registers together, which spilled and serialised here.
// The C entry builds the tensor maps of q, k and v on every call
// (sm90::map_2d: cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so
// the library needs no -lcuda) and passes them as __grid_constant__
// parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "mma.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// registers a thread of each role holds after setmaxnreg (ptxas starts
// the kernel at 168 a thread with two consumer warpgroups, 128 with one)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 232;
// k/v ring depth (at 128-blocks and D 128 shared memory holds two stages;
// a third gained nothing at D 64) and p.v's batches of keys, each split
// while the one before it multiplies; tools/flash_sm90_variants.py times
// the alternatives on the card
constexpr int STAGES = 2;
constexpr int PV_BATCHES = 4;
// 2^x; results below 2^-126 flush to zero, which no sum of probabilities
// (each row's largest is 1) can see
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the parametric element mask of kernel.py (no prefix-LM rule)
__device__ __forceinline__ bool allowed(int qg, int kg, int causal,
                                        int window, int prefix) {
  bool ok = true;
  if (causal) ok = ok && kg <= qg;
  if (window > 0) ok = ok && ((qg - kg) < window || kg < prefix);
  return ok;
}

// BQ, BK: q and kv block rows (64 or 128); DP: head dim padded to 64 or
// 128 (one or two 64-column panels)
template <int BQ, int BK, int DP>
struct Cfg {
  static constexpr int NC = BQ / 64;              // consumer warpgroups
  static constexpr int THREADS = (NC + 1) * 128;  // + the producer's
  static constexpr int MIN_CTAS = NC == 1 ? 2 : 1;
  static constexpr int NP = DP / 64;              // 64-column panels
  static constexpr int Q_BYTES = NP * BQ * 128;
  static constexpr int KV_BYTES = NP * BK * 128;  // one k or v tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int LDO = DP + 8;              // output staging row
  static constexpr int KV_OFF = Q_BYTES;
  static constexpr int O_OFF = KV_OFF + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = O_OFF + NC * 64 * LDO * 2;
  // + 1024 bytes to align the base to the swizzle's 1024 bytes
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 1) + 1024;
};

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

template <int N>
struct Scores;
template <>
struct Scores<64> {
  static __device__ __forceinline__ void mma(float (&s)[32], uint64_t da,
                                             uint64_t db, int acc) {
    sm90::wgmma_ss_n64(s, da, db, acc);
  }
};
template <>
struct Scores<128> {
  static __device__ __forceinline__ void mma(float (&s)[64], uint64_t da,
                                             uint64_t db, int acc) {
    sm90::wgmma_ss_n128(s, da, db, acc);
  }
};

template <int BQ, int BK, int DP>
__global__ void __launch_bounds__(Cfg<BQ, BK, DP>::THREADS,
                                  Cfg<BQ, BK, DP>::MIN_CTAS)
flash_mask_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const int* __restrict__ ki,
                       const int* __restrict__ flags,
                       const int* __restrict__ seg_ptr,
                       bf16* __restrict__ out, int Hq, int Hkv, int S,
                       int Tk, int D, float scale, int causal, int window,
                       int prefix, int q_offset) {
  using C = Cfg<BQ, BK, DP>;
  constexpr int NP = C::NP;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;                       // q: NP panels of BQ rows
  const uint32_t kv_s = base + C::KV_OFF;          // stage s: k, then v
  bf16* o_s = reinterpret_cast<bf16*>(smem_raw + (base - raw) + C::O_OFF);
  const uint32_t bars = base + C::BAR_OFF;
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (STAGES + st); };
  const uint32_t q_bar = bars + 8u * (2 * STAGES);

  const int qb = gridDim.y - 1 - blockIdx.y;       // longest segments first
  const int bh = blockIdx.x;                       // b * Hq + h
  const int w_beg = seg_ptr[qb], w_end = seg_ptr[qb + 1];
  if (w_beg >= w_end) {     // never visited: zeros (out is not cleared first)
    bf16* og = out + ((size_t)bh * S + (size_t)qb * BQ) * D;
    for (int e = threadIdx.x; e < BQ * D / 8; e += blockDim.x)
      reinterpret_cast<uint4*>(og)[e] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int nkb = Tk / BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(full(st), 1);
      sm90::mbar_init(empty(st), C::NC * 128);
    }
    sm90::mbar_init(q_bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= C::NC * 4) {
    // ---- producer warpgroup: one thread of its first warp issues every
    // copy; the other warps only give up their registers ----
    sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == C::NC * 4 && lane == 0) {
      const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
      sm90::mbar_arrive_expect_tx(q_bar, C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        sm90::tma_load_2d(q_s + p * BQ * 128, &q_map, q_bar, 64 * p,
                          bh * S + qb * BQ);
      for (int w = w_beg, it = 0; w < w_end; ++w, ++it) {
        const int st = it % STAGES;
        sm90::mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);
        const int kb = ki[w];
        if (kb >= 0 && kb < nkb) {
          sm90::mbar_arrive_expect_tx(full(st), C::STAGE_BYTES);
          const uint32_t ks = kv_s + st * C::STAGE_BYTES;
          const int row = kvh * Tk + kb * BK;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            sm90::tma_load_2d(ks + p * BK * 128, &k_map, full(st), 64 * p,
                              row);
            sm90::tma_load_2d(ks + C::KV_BYTES + p * BK * 128, &v_map,
                              full(st), 64 * p, row);
          }
        } else {
          // fully masked: no bytes, but the stage's phase still turns
          sm90::mbar_arrive(full(st));
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows wg * 64 .. wg * 64 + 63 ----
    sm90::setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp >> 2, wq = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    const int q_lo = qb * BQ + q_offset + wg * 64;  // first absolute query
    const int r0 = q_lo + wq * 16 + g;              // rows r0 and r0 + 8
    const uint32_t qa = q_s + wg * 64 * 128;
    const float scale_log2 = scale * LOG2E;

    float o[NP][32];                 // the accumulator, rows r0, r0 + 8
    float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.0f, 0.0f};
    bool flushed = false;            // did any entry write the rows?
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int x = 0; x < 32; ++x) o[p][x] = 0.0f;

    sm90::mbar_wait(q_bar, 0);
    for (int w = w_beg, it = 0; w < w_end; ++w, ++it) {
      const int st = it % STAGES;
      const int f = flags[w];                      // uniform across the CTA
      const int kb = ki[w];
      if (f & 1) {
        m_r[0] = m_r[1] = NEG_INF;
        l_r[0] = l_r[1] = 0.0f;
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int x = 0; x < 32; ++x) o[p][x] = 0.0f;
      }
      sm90::mbar_wait(full(st), (it / STAGES) & 1);
      // an out-of-range kv-block is fully masked: m, l and acc keep their
      // values (alpha = 1, p = 0), so only the flags act
      if (kb >= 0 && kb < nkb) {
        const uint32_t ks = kv_s + st * C::STAGE_BYTES;
        const uint32_t vs = ks + C::KV_BYTES;

        // S = q . k^T for the warpgroup's 64 rows x BK keys (every k-step
        // of the padded head dim: past D the tiles hold TMA's zeros, and a
        // branch between the steps cost more than the D 112 instance's
        // eighth step)
        float s[BK / 2];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const int pan = kk / 4, off = (kk % 4) * 32;
          Scores<BK>::mma(
              s, sm90::desc_sw128(qa + pan * BQ * 128 + off, 16, 1024),
              sm90::desc_sw128(ks + pan * BK * 128 + off, 16, 1024), kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_operand(s);

        // mask only where the warpgroup's rows straddle an edge, then the
        // online softmax of rows r0 (h = 0) and r0 + 8 (h = 1) in log2
        // units (scale * log2 e), both rows at once and over four partial
        // maxima and sums each: with two consumer warps an SMSP, one chain
        // of dependent adds would leave its issue slots idle.  With
        // scale > 0 the max runs over the raw scores and the scale enters
        // the exponential's fma (FOLD); else the scores are scaled first.
        const int k_lo = kb * BK, k_hi = k_lo + BK - 1;
        const bool full_tile =
            (!causal || k_hi <= q_lo) &&
            (window <= 0 || q_lo + 63 - k_lo < window || k_hi < prefix);
        float alpha[2];
        auto softmax = [&](auto fold) {
          constexpr bool FOLD = decltype(fold)::value;
          const float c = FOLD ? scale_log2 : 1.0f;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              float& e = s[4 * j + x];
              if (!FOLD) e *= scale_log2;
              if (!full_tile &&
                  !allowed(r0 + 8 * (x >> 1),
                           k_lo + 8 * j + 2 * t + (x & 1), causal, window,
                           prefix))
                e = NEG_INF;
            }
          float part[2][4], mc[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int u = 0; u < 4; ++u) part[h][u] = NEG_INF;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              part[h][j % 4] = fmaxf(part[h][j % 4],
                                     fmaxf(s[4 * j + 2 * h],
                                           s[4 * j + 2 * h + 1]));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float mx = fmaxf(fmaxf(part[h][0], part[h][1]),
                             fmaxf(part[h][2], part[h][3]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m_r[h], mx);
            // 1 where both are NEG_INF (nothing allowed yet)
            alpha[h] = exp2_ftz((m_r[h] - m_new) * c);
            // a masked score is NEG_INF, so its p = 2^(NEG_INF c - mc) is
            // 0; a row with nothing allowed yet has m_new = NEG_INF, and
            // mc = 0 keeps its p at 0 too
            mc[h] = m_new == NEG_INF ? 0.0f : m_new * c;
            m_r[h] = m_new;
#pragma unroll
            for (int u = 0; u < 4; ++u) part[h][u] = 0.0f;
          }
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const int h = x >> 1;
              const float p = exp2_ftz(fmaf(s[4 * j + x], c, -mc[h]));
              s[4 * j + x] = p;
              part[h][(2 * j + (x & 1)) % 4] += p;
            }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float sum = (part[h][0] + part[h][1]) + (part[h][2] + part[h][3]);
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            l_r[h] = l_r[h] * alpha[h] + sum;
          }
        };
        if (scale_log2 > 0.0f)
          softmax(Flag<true>());
        else
          softmax(Flag<false>());
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[p][4 * j] *= alpha[0];
            o[p][4 * j + 1] *= alpha[0];
            o[p][4 * j + 2] *= alpha[1];
            o[p][4 * j + 3] *= alpha[1];
          }

        // acc += p . v with p = hi + lo: A from registers, v read
        // transposed, in PV_BATCHES batches of keys, so that a batch's
        // split runs while the batch before it is on the tensor cores.
        // Every operand register is written before the fence ahead of its
        // product.
        constexpr int KB = BK / 16 / PV_BATCHES;   // k-steps of a batch
#pragma unroll
        for (int p = 0; p < NP; ++p) sm90::fence_operand(o[p]);
#pragma unroll
        for (int b = 0; b < PV_BATCHES; ++b) {
          uint32_t hi[KB][4], lo[KB][4];
#pragma unroll
          for (int kk = 0; kk < KB; ++kk)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              tc::split_bf16x2(s[8 * (b * KB + kk) + 2 * r],
                               s[8 * (b * KB + kk) + 2 * r + 1], hi[kk][r],
                               lo[kk][r]);
#pragma unroll
          for (int kk = 0; kk < KB; ++kk) {
            sm90::fence_operand(hi[kk]);
            sm90::fence_operand(lo[kk]);
          }
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KB; ++kk)
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              const uint64_t dv = sm90::desc_sw128(
                  vs + p * BK * 128 + (b * KB + kk) * 2048, BK * 128, 1024);
              sm90::wgmma_rs_tn_n64(o[p], lo[kk], dv);
              sm90::wgmma_rs_tn_n64(o[p], hi[kk], dv);
            }
          sm90::wgmma_commit();
        }
        sm90::wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < NP; ++p) sm90::fence_operand(o[p]);
      }
      sm90::mbar_arrive(empty(st));             // stage st may be refilled

      if (f & 2) {   // flush: acc / l (0 where l == 0), staged per warpgroup
        flushed = true;
        bf16* os = o_s + wg * 64 * C::LDO;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float l = l_r[h];
          const int row = wq * 16 + g + 8 * h;
#pragma unroll
          for (int p = 0; p < NP; ++p)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float x0 =
                  l > 0.0f ? o[p][4 * j + 2 * h] / fmaxf(l, 1e-30f) : 0.0f;
              const float x1 =
                  l > 0.0f ? o[p][4 * j + 2 * h + 1] / fmaxf(l, 1e-30f)
                           : 0.0f;
              *reinterpret_cast<__nv_bfloat162*>(
                  os + row * C::LDO + 64 * p + 8 * j + 2 * t) =
                  __floats2bfloat162_rn(x0, x1);
            }
        }
        sm90::named_sync(1 + wg, 128);
        bf16* og = out + ((size_t)bh * S + (size_t)qb * BQ + wg * 64) * D;
        for (int e = tid & 127; e < 64 * (DP / 8); e += 128) {
          const int r = e / (DP / 8), c = (e % (DP / 8)) * 8;
          if (c < D)
            *reinterpret_cast<uint4*>(og + (size_t)r * D + c) =
                *reinterpret_cast<const uint4*>(os + r * C::LDO + c);
        }
        sm90::named_sync(1 + wg, 128);           // staging tile reusable
      }
    }
    if (!flushed) {  // no entry wrote the rows: zeros, as out was not cleared
      bf16* og = out + ((size_t)bh * S + (size_t)qb * BQ + wg * 64) * D;
      for (int e = tid & 127; e < 64 * D / 8; e += 128)
        reinterpret_cast<uint4*>(og)[e] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// the (rows, D) bf16 row-major matrix at ptr, read in boxes of 64 columns
// x box_rows rows in the 128-byte swizzle; columns >= D read as zeros
cudaError_t make_map(CUtensorMap* map, const void* ptr, uint64_t rows, int D,
                     int box_rows) {
  return sm90::map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16),
                      ptr, rows, D, 64, box_rows);
}

struct Args {
  const void *q, *k, *v;
  const int *ki, *flags, *seg_ptr;
  void* out;
  int BH, Hq, Hkv, S, Tk, D;
  float scale;
  int causal, window, prefix, q_offset;
  cudaStream_t stream;
};

// Set the kernel's dynamic shared memory and check that setmaxnreg can
// move its registers: the registers the CTA launches with (numRegs a
// thread) must cover the consumers' raise from what the producer
// warpgroup gives up, or setmaxnreg.inc would wait forever.  Done once
// per instance and device: both calls cost host time on every launch.
template <int BQ, int BK, int DP>
cudaError_t prepare() {
  using C = Cfg<BQ, BK, DP>;
  static std::atomic<uint32_t> done{0};            // bit d: device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = dev < 32 ? 1u << dev : 0u;
  if (done.load() & bit) return cudaSuccess;
  auto* fn = flash_mask_sm90_kernel<BQ, BK, DP>;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  const int r = attr.numRegs;
  if (r < PRODUCER_REGS || r > CONSUMER_REGS ||
      (r - PRODUCER_REGS) * 128 < (CONSUMER_REGS - r) * C::NC * 128)
    return cudaErrorLaunchOutOfResources;
  done.fetch_or(bit);
  return cudaSuccess;
}

template <int BQ, int BK, int DP>
struct Kernel {
  using C = Cfg<BQ, BK, DP>;

  static cudaError_t launch(const Args& a) {
    cudaError_t err = prepare<BQ, BK, DP>();
    if (err != cudaSuccess) return err;
    const int B = a.BH / a.Hq;
    CUtensorMap qm, km, vm;
    if ((err = make_map(&qm, a.q, (uint64_t)a.BH * a.S, a.D, BQ)) ||
        (err = make_map(&km, a.k, (uint64_t)B * a.Hkv * a.Tk, a.D, BK)) ||
        (err = make_map(&vm, a.v, (uint64_t)B * a.Hkv * a.Tk, a.D, BK)))
      return err;
    flash_mask_sm90_kernel<BQ, BK, DP>
        <<<dim3(a.BH, a.S / BQ), C::THREADS, C::SMEM, a.stream>>>(
            qm, km, vm, a.ki, a.flags, a.seg_ptr, static_cast<bf16*>(a.out),
            a.Hq, a.Hkv, a.S, a.Tk, a.D, a.scale, a.causal, a.window,
            a.prefix, a.q_offset);
    return cudaGetLastError();
  }

  static cudaError_t info(int* out) {
    cudaError_t err = prepare<BQ, BK, DP>();
    if (err != cudaSuccess) return err;
    auto* fn = flash_mask_sm90_kernel<BQ, BK, DP>;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return err;
    int ctas = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, C::THREADS,
                                                        C::SMEM);
    out[0] = C::THREADS;
    out[1] = C::SMEM;
    out[2] = attr.numRegs;
    out[3] = (int)attr.localSizeBytes;
    out[4] = ctas;
    return err;
  }
};

// the shapes this kernel takes: blocks of 64 or 128, a head dim that is a
// multiple of 16 in [16, 128]
bool takes(int bq, int bk, int D) {
  return (bq == 64 || bq == 128) && (bk == 64 || bk == 128) && D >= 16 &&
         D <= 128 && D % 16 == 0;
}

template <class Op>
cudaError_t by_shape(int bq, int bk, int D, const Op& op) {
  if (!takes(bq, bk, D)) return cudaErrorInvalidValue;
  const bool wide = D > 64;
  if (bq == 128 && bk == 128)
    return wide ? op(Kernel<128, 128, 128>()) : op(Kernel<128, 128, 64>());
  if (bq == 128)
    return wide ? op(Kernel<128, 64, 128>()) : op(Kernel<128, 64, 64>());
  if (bk == 128)
    return wide ? op(Kernel<64, 128, 128>()) : op(Kernel<64, 128, 64>());
  return wide ? op(Kernel<64, 64, 128>()) : op(Kernel<64, 64, 64>());
}

}  // namespace

// C interface (bound with ctypes).  Device pointers of contiguous bf16
// tensors with 16-byte aligned bases: q (B, Hq, S, D), k and v (B, Hkv, Tk,
// D), out (B, Hq, S, D), every element of which the kernel writes (zeros
// where no flush reaches: it need not be cleared); ki and flags (P,) int32
// worklist entries sorted by q-block, seg_ptr (S / bq + 1,) int32 segment
// offsets of each q-block.  BH = B * Hq.  Returns the cudaError_t of the launch (0 on
// success); a shape this kernel does not take (bq or bk not 64 or 128, D
// not a multiple of 16 in [16, 128], S % bq, Tk % bk or Hq % Hkv not 0, a
// misaligned pointer) returns cudaErrorInvalidValue and launches nothing.
extern "C" int flash_mask_sm90(const void* q, const void* k, const void* v,
                               const int* ki, const int* flags,
                               const int* seg_ptr, void* out, int BH, int Hq,
                               int Hkv, int S, int Tk, int D, int bq, int bk,
                               float scale, int causal, int window,
                               int prefix, int q_offset, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(out);
  if (!takes(bq, bk, D) || (ptrs & 15) || Hq <= 0 || Hkv <= 0 ||
      Hq % Hkv || BH % Hq || S % bq || Tk % bk)
    return cudaErrorInvalidValue;
  if (BH <= 0 || S <= 0) return 0;
  const Args a{q,  k,  v,  ki,    flags,  seg_ptr, out,    BH,
               Hq, Hkv, S, Tk,    D,      scale,   causal, window,
               prefix, q_offset, static_cast<cudaStream_t>(stream)};
  return by_shape(bq, bk, D, [&](auto kern) { return kern.launch(a); });
}

// The kernel instance flash_mask_sm90 runs for blocks (bq, bk) and head dim
// D: info receives threads per CTA, dynamic shared memory bytes, registers
// per thread at launch, local (spill) bytes per thread and resident CTAs
// per SM on the current device.  Returns a cudaError_t.
extern "C" int flash_mask_sm90_info(int bq, int bk, int D, int* info) {
  return by_shape(bq, bk, D, [&](auto kern) { return kern.info(info); });
}
