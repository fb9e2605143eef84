// Block-masked flash attention over a qi-sorted (qi, ki, flags) worklist,
// every (batch, head) in one launch, GQA-aware.
//
// Replaces the TPU kernel
//   repro/kernels/flash_mask/kernel.py::flash_mask_kernel
// together with the batch/head vmap of repro/kernels/flash_mask/ops.py, and
// computes what they compute: for query head h of batch b (kv head
// h / (Hq / Hkv)), each q-block walks the kv-blocks its worklist segment
// lists.  Scores are q.k^T * scale with f32 accumulation; the element mask
// (causal: k <= q; window: q - k < window or k < prefix) applies at the
// absolute query position q + q_offset; masked scores are NEG_INF = -1e30
// and their probabilities are zeroed after the exp, so a fully masked tile
// leaves alpha = exp(m_prev - m_new) = 1 and no NaN.  p.v is f32 p times v
// upcast.  Flag bit 1 resets the running max m, normaliser l and
// accumulator; bit 2 writes acc / l (rows with l == 0 come out as 0) in the
// input dtype.  A kv-block index out of range reads as fully masked.
//
// Both kernels keep the TPU kernel's state across one q-block's grid steps
// in one CTA per (q-block, batch * head), which walks that q-block's
// contiguous segment seg_ptr[qb] .. seg_ptr[qb + 1] of the worklist: no
// atomics, one sum order, deterministic results.  The C entry point picks
// the kernel by dtype; both run on tensor cores.
//
// bf16: tensor cores (flash_mask_tc_kernel), for the bf16 shapes that
// flash_mask_sm90.cu (wgmma + TMA, blocks of 64 or 128, head dims a
// multiple of 16) does not take, and when asked for by name (kernel.py's
// variant="mma_sync").  Warps of 16 query rows each (8
// warps at bq = 128).  The q tile is loaded once into shared memory and read
// as mma A-fragments (ldmatrix) at every tile: kept in registers it spilled
// more of the 128-register budget and ran slower on an NVIDIA H100 80GB HBM3
// at 700 W (PERF.md).  k and v tiles stay bf16 in shared memory in a 2-stage
// cp.async ring: the next worklist entry's ki is read ahead and its k/v copy
// overlaps this tile's math.  S = q.k^T runs on m16n8k16 bf16 mma (exact
// products, f32 sums, as in the reference).  The element mask is applied in
// registers, and only where a warp's rows straddle the causal diagonal, the
// window edge or the block's end; interior tiles skip it.  The online softmax
// stays in registers: each row's max and sum reduce over its quad of four
// threads, with no shared-memory score tile and no barrier.  p.v keeps the
// reference's f32 p: p = hi + lo, hi = bf16(p), lo = bf16(p - hi), both
// re-packed from the C-fragment into the A-fragment layout in registers, each
// an mma against v's fragments (ldmatrix.trans).  That costs 1.5x the tile's
// operations and holds the layer to 9e-5 normwise from f32 p on that card
// (chip_smoke.py), where one bf16 term exceeds its 2e-3 limit
// (tests/test_torch_tc_numerics.py).  Longest q-blocks launch first
// (qb = nq - 1 - blockIdx.y) to shorten the causal tail.  The output leaves
// through shared memory in 16 B stores.  Registers are held to 128 per thread
// so that two CTAs (16 warps, 2 x 90 KB of shared memory at 128/128/64) share
// an SM; one CTA of 223 spill-free registers ran slower (PERF.md).  Blocks
// below 16 and head dims below the mma depth are zero-padded in shared memory,
// the padding masked.
//
// f32: tensor cores in 3xTF32 (flash_mask_f32_tc_kernel), for the f32 shapes
// that flash_mask_f32_sm90.cu (tf32 wgmma + TMA, blocks of 64 or 128 and head
// dims 64, 112 and 128: every f32 prefill at full width) does not take (the
// reference's small-block sweep, the reduced configs' 16-blocks, single-query
// decode, other head dims), and when asked for by name (kernel.py's
// variant="mma_sync").  The bf16 kernel's structure on f32 data: warps of 16
// query rows, the q tile in shared memory, k and v in a 2-stage cp.async ring
// of 64-key chunks (two chunks per 128-key tile; f32 tiles are twice the bf16
// size, and 64-key chunks keep two CTAs on an SM at bq = 128, D = 64), the
// online softmax in registers once per chunk, longest q-blocks first.  Both
// products run on m16n8k8 tf32 mma with each operand split into hi = tf32(x)
// and lo = tf32(x - hi): a_lo b_hi + a_hi b_lo + a_hi b_hi per k-step of 8,
// started from zero and added to the f32 accumulator with IEEE rounding,
// because the mma's own f32 sums truncate; one TF32 pass would not keep f32
// accuracy (tests/test_torch_tc_numerics.py).  The m16n8 C fragment holds keys
// 2t, 2t + 1 where the m16k8 A fragment wants k slots t, t + 4; rather than
// move p between threads, p.v assigns keys 2t, 2t + 1 to slots t, t + 4 and
// reads v's rows in that order, and q.k^T does the same with head dims, so
// every operand pair of q and k is one 8-byte shared-memory load.  The splits
// are most of the kernel's non-mma instructions, so they round in integer
// arithmetic (the same bits as cvt.rna.tf32.f32), and the exponentials use
// ex2.approx.ftz directly; together these cut its time by 18-21 % on an NVIDIA
// H100 80GB HBM3 at 700 W (tools/flash_f32_variants.py, which also holds the
// chunk size and the register budget against their alternatives).
//
// Bound on an H100 SXM at the full-width llama3.2-1b layer (B = 4,
// Hq = 32, Hkv = 8, S = 2048, D = 64, bq = bk = 128, causal): the allowed
// (q, k) elements need 4 * B * Hq * D * S (S + 1) / 2 = 68.75 GFLOP, 0.0695
// ms at 989 TFLOP/s of bf16 tensor cores; q, k, v read once and the output
// written once are 84 MB, 0.025 ms at 3.35 TB/s, so it is bound by
// operations.  The bf16 kernel issues whole tiles with p.v twice, about
// 109.5 GFLOP, so it can reach at most about 63 % of that bound.  What
// holds it back further: mma.sync reaches only part of the rate that
// wgmma does, the exp and the hi/lo split of every score run on the
// CUDA cores between the two products, two barriers per tile, and a few
// registers spilled at 128 per thread.  The f32
// instance's bound is three TF32 passes, 3 * 68.75 GFLOP at 495 TFLOP/s =
// 0.417 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// the parametric element mask of kernel.py:55-60 (no prefix-LM rule)
__device__ __forceinline__ bool allowed(int qg, int kg, int causal,
                                        int window, int prefix) {
  bool ok = true;
  if (causal) ok = ok && kg <= qg;
  if (window > 0) ok = ok && ((qg - kg) < window || kg < prefix);
  return ok;
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores
// ---------------------------------------------------------------------------

// BT: q and kv tile rows (16 .. 128), DM: padded head dim (16, 64, 128)
template <int BT, int DM>
struct TcCfg {
  static constexpr int NT = BT * 2;           // BT / 16 warps
  static constexpr int LD = DM + 8;           // padded row: no bank conflicts
  static constexpr int TILE = BT * LD;        // elements of one tile
  // q, then 2 stages of (k, v)
  static constexpr size_t SMEM = sizeof(bf16) * (size_t)TILE * 5;
};

// rows [0, rows) x cols [0, D) of a row-major (., D) tile into a BT x DM
// shared tile, zero-filled beyond; 16 B cp.async when `vec`, else plain
// element copies (done when the caller's barrier passes)
template <int BT, int DM>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int rows,
                                          int D, bool vec, int tid) {
  using C = TcCfg<BT, DM>;
  if (vec) {
    for (int e = tid; e < BT * (DM / 8); e += C::NT) {
      const int r = e / (DM / 8), c = (e % (DM / 8)) * 8;
      const bool in = r < rows && c < D;
      tc::cp_async16(s + r * C::LD + c, in ? g + (size_t)r * D + c : g, in);
    }
  } else {
    for (int e = tid; e < BT * DM; e += C::NT) {
      const int r = e / DM, c = e % DM;
      s[r * C::LD + c] = (r < rows && c < D) ? g[(size_t)r * D + c]
                                             : __float2bfloat16(0.0f);
    }
  }
}

template <int BT, int DM>
__global__ void __launch_bounds__(BT * 2, (DM <= 64 ? 2 : 1))
flash_mask_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ ki,
                     const int* __restrict__ flags,
                     const int* __restrict__ seg_ptr, bf16* __restrict__ out,
                     int Hq, int Hkv, int S, int Tk, int D, int bq, int bk,
                     float scale, int causal, int window, int prefix,
                     int q_offset, int vec) {
  using C = TcCfg<BT, DM>;
  constexpr int NB = BT / 8;                  // n8 score tiles per row block
  constexpr int ND = DM / 8;                  // n8 output tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KV = Qs + C::TILE;                    // stage s: k at 2s, v at 2s+1

  const int qb = gridDim.y - 1 - blockIdx.y;  // longest segments first
  const int bh = blockIdx.x;                  // b * Hq + h
  const int w_beg = seg_ptr[qb], w_end = seg_ptr[qb + 1];
  if (w_beg >= w_end) return;                 // never visited: stays zero
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const bf16* Qg = q + ((size_t)bh * S + (size_t)qb * bq) * D;
  const bf16* Kg = k + (size_t)kvh * Tk * D;
  const bf16* Vg = v + (size_t)kvh * Tk * D;
  bf16* Og = out + ((size_t)bh * S + (size_t)qb * bq) * D;
  const int nkb = Tk / bk;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;                 // this warp's rows in the tile
  const int q_lo = qb * bq + q_offset + row0;  // its first absolute query

  auto stage = [&](int w, int st) {           // k, v of entry w into st
    const int kb = ki[w];
    if (kb < 0 || kb >= nkb) return;          // fully masked: no data
    load_tile<BT, DM>(KV + (2 * st) * C::TILE, Kg + (size_t)kb * bk * D, bk,
                      D, vec, tid);
    load_tile<BT, DM>(KV + (2 * st + 1) * C::TILE, Vg + (size_t)kb * bk * D,
                      bk, D, vec, tid);
  };
  load_tile<BT, DM>(Qs, Qg, bq, D, vec, tid);
  stage(w_beg, 0);
  tc::cp_async_commit();

  float o[ND][4];                             // rows g, g + 8 of the warp
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[n][x] = 0.0f;

  for (int w = w_beg, it = 0; w < w_end; ++w, ++it) {
    const int st = it & 1;
    if (w + 1 < w_end) stage(w + 1, st ^ 1);  // read ahead: overlaps below
    tc::cp_async_commit();
    tc::cp_async_wait<1>();                   // entry w (and q) landed
    __syncthreads();
    const int f = flags[w];                   // uniform across the CTA
    const int kb = ki[w];
    if (f & 1) {
      m_r[0] = m_r[1] = NEG_INF;
      l_r[0] = l_r[1] = 0.0f;
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) o[n][x] = 0.0f;
    }
    // an out-of-range kv-block is fully masked: m, l and acc keep their
    // values (alpha = 1, p = 0), so only the flags act
    if (kb >= 0 && kb < nkb) {
      const bf16* Ks = KV + (2 * st) * C::TILE;
      const bf16* Vs = KV + (2 * st + 1) * C::TILE;

      // S = q . k^T for the warp's 16 rows x BT keys
      float s[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) s[n][x] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DM / 16; ++kk) {
        uint32_t qf[4];                       // q's A-fragment, this k-step
        tc::ldmatrix_x4(qf, Qs + (row0 + (lane & 15)) * C::LD + kk * 16 +
                                (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < NB / 2; ++j) {
          uint32_t kf[4];
          const int key = 16 * j + (lane & 7) + (lane >> 4) * 8;
          tc::ldmatrix_x4(kf, Ks + key * C::LD + kk * 16 +
                                  ((lane >> 3) & 1) * 8);
          tc::mma_bf16(s[2 * j], qf, kf[0], kf[1]);
          tc::mma_bf16(s[2 * j + 1], qf, kf[2], kf[3]);
        }
      }

      // scale; mask only where the warp's rows straddle an edge
      const int k_lo = kb * bk, k_hi = k_lo + bk - 1;
      const int q_hi = q_lo + 15;
      const bool full =
          bk == BT && (!causal || k_hi <= q_lo) &&
          (window <= 0 || q_hi - k_lo < window || k_hi < prefix);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          s[n][x] *= scale;
          if (!full) {
            const int col = 8 * n + 2 * t + (x & 1);
            const int qg = q_lo + g + (x >> 1) * 8;
            if (col >= bk || !allowed(qg, k_lo + col, causal, window, prefix))
              s[n][x] = NEG_INF;
          }
        }

      // online softmax, rows g (h = 0) and g + 8 (h = 1)
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < NB; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[h], mx);
        const float mc = m_new * LOG2E;
        alpha[h] = exp2f((m_r[h] - m_new) * LOG2E);
        float sum = 0.0f;
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int x = 2 * h; x < 2 * h + 2; ++x) {
            // masked here means set to NEG_INF above (no real score of a
            // finite q, k reaches -1e30 after scaling in practice)
            const bool ok = full || s[n][x] != NEG_INF;
            const float p = ok ? exp2f(fmaf(s[n][x], LOG2E, -mc)) : 0.0f;
            s[n][x] = p;
            sum += p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_r[h] = l_r[h] * alpha[h] + sum;
        m_r[h] = m_new;
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // acc += p . v with p = hi + lo, each a bf16 A-fragment
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        uint32_t hi[4], lo[4];
        tc::split_bf16x2(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
        tc::split_bf16x2(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
        tc::split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
        tc::split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int j = 0; j < ND / 2; ++j) {
          uint32_t vf[4];
          tc::ldmatrix_x4_trans(
              vf, Vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * C::LD +
                      16 * j + (lane >> 4) * 8);
          tc::mma_bf16(o[2 * j], lo, vf[0], vf[1]);
          tc::mma_bf16(o[2 * j], hi, vf[0], vf[1]);
          tc::mma_bf16(o[2 * j + 1], lo, vf[2], vf[3]);
          tc::mma_bf16(o[2 * j + 1], hi, vf[2], vf[3]);
        }
      }
    }

    if (f & 2) {   // flush: acc / l (0 where l == 0), staged in shared
      __syncthreads();                        // memory where k was
      bf16* Os = KV + (2 * st) * C::TILE + row0 * C::LD;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float l = l_r[h];
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const float x0 = l > 0.0f ? o[n][2 * h] / fmaxf(l, 1e-30f) : 0.0f;
          const float x1 =
              l > 0.0f ? o[n][2 * h + 1] / fmaxf(l, 1e-30f) : 0.0f;
          *reinterpret_cast<__nv_bfloat162*>(
              Os + (g + 8 * h) * C::LD + 8 * n + 2 * t) =
              __floats2bfloat162_rn(x0, x1);
        }
      }
      __syncwarp();
      const int rows = min(16, bq - row0);
      if (vec) {
        for (int e = lane; e < 16 * (DM / 8); e += 32) {
          const int r = e / (DM / 8), c = (e % (DM / 8)) * 8;
          if (r < rows && c < D)
            *reinterpret_cast<uint4*>(Og + (size_t)(row0 + r) * D + c) =
                *reinterpret_cast<const uint4*>(Os + r * C::LD + c);
        }
      } else {
        for (int e = lane; e < 16 * DM; e += 32) {
          const int r = e / DM, c = e % DM;
          if (r < rows && c < D)
            Og[(size_t)(row0 + r) * D + c] = Os[r * C::LD + c];
        }
      }
      __syncwarp();
    }
    __syncthreads();          // stage st is consumed before it is refilled
  }
}

// ---------------------------------------------------------------------------
// f32 on tensor cores: 3xTF32
// ---------------------------------------------------------------------------

// BT: q tile rows (16 .. 128), DM: padded head dim (16, 64, 128).  The kv
// tile streams through a ring of STAGES chunks of KC keys, so that two
// CTAs of f32 tiles fit an SM at BT = 128, DM = 64.  Row strides: q and k
// are read as 8-byte pairs (d 2t, 2t + 1) by the four threads of a quad and
// eight rows, so their stride is 8 words past a multiple of 32 banks; v is
// read as single words at rows 2t, 2t + 1 and eight columns, so its stride
// is 4 words past one.  Both layouts are free of bank conflicts.
template <int BT, int DM>
struct F32Cfg {
  static constexpr int NT = BT * 2;           // BT / 16 warps
  static constexpr int KC = BT < 64 ? BT : 64;
  static constexpr int STAGES = 2;
  static constexpr int LDQ = DM + 8;          // q and k rows
  static constexpr int LDV = DM + 4;          // v rows
  static constexpr int STAGE = KC * (LDQ + LDV);
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)BT * LDQ + STAGES * (size_t)STAGE);
};

// rows [0, rows) x cols [0, D) of a row-major (., D) f32 tile into an
// (R, ld) shared tile zero-filled to DM columns; 16 B cp.async when `vec`,
// else plain element copies (done when the caller's barrier passes)
template <int R, int DM, int NT>
__device__ __forceinline__ void load_f32(float* s, const float* g, int rows,
                                         int D, int ld, bool vec, int tid) {
  if (vec) {
    for (int e = tid; e < R * (DM / 4); e += NT) {
      const int r = e / (DM / 4), c = (e % (DM / 4)) * 4;
      const bool in = r < rows && c < D;
      tc::cp_async16(s + r * ld + c, in ? g + (size_t)r * D + c : g, in);
    }
  } else {
    for (int e = tid; e < R * DM; e += NT) {
      const int r = e / DM, c = e % DM;
      s[r * ld + c] = (r < rows && c < D) ? g[(size_t)r * D + c] : 0.0f;
    }
  }
}

// tc::split_tf32 in integer arithmetic.  Adding 2^12 to the bit pattern and
// clearing its low 13 bits rounds the magnitude to 10 mantissa bits, to
// nearest with ties away from zero: cvt.rna.tf32.f32's result for every
// finite x (the CPU tests emulate the same rounding), in fewer
// instructions than the cvt takes on sm_90a.
__device__ __forceinline__ uint32_t rna_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_rna(float x, uint32_t& hi,
                                          uint32_t& lo) {
  hi = rna_bits(x);
  lo = rna_bits(x - __uint_as_float(hi));
}

// 2^x; results below 2^-126 flush to zero, which no sum of probabilities
// (each row's largest is 1) can see
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the 3xTF32 product of one k-step of 8, started from zero:
// a_lo b_hi + a_hi b_lo + a_hi b_hi, each an m16n8k8 mma
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
#pragma unroll
  for (int x = 0; x < 4; ++x) d[x] = 0.0f;
  tc::mma_tf32(d, al, bh0, bh1);
  tc::mma_tf32(d, ah, bl0, bl1);
  tc::mma_tf32(d, ah, bh0, bh1);
}

template <int BT, int DM>
__global__ void __launch_bounds__(BT * 2, (DM <= 64 ? 2 : 1))
flash_mask_f32_tc_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ ki,
                         const int* __restrict__ flags,
                         const int* __restrict__ seg_ptr,
                         float* __restrict__ out, int Hq, int Hkv, int S,
                         int Tk, int D, int bq, int bk, float scale,
                         int causal, int window, int prefix, int q_offset,
                         int vec) {
  using C = F32Cfg<BT, DM>;
  constexpr int KC = C::KC;
  constexpr int NB = KC / 8;                  // n8 score tiles per chunk
  constexpr int ND = DM / 8;                  // n8 output tiles
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* KV = Qs + BT * C::LDQ;               // stage s at s * STAGE: k, v

  const int qb = gridDim.y - 1 - blockIdx.y;  // longest segments first
  const int bh = blockIdx.x;                  // b * Hq + h
  const int w_beg = seg_ptr[qb], w_end = seg_ptr[qb + 1];
  if (w_beg >= w_end) return;                 // never visited: stays zero
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const float* Qg = q + ((size_t)bh * S + (size_t)qb * bq) * D;
  const float* Kg = k + (size_t)kvh * Tk * D;
  const float* Vg = v + (size_t)kvh * Tk * D;
  float* Og = out + ((size_t)bh * S + (size_t)qb * bq) * D;
  const int nkb = Tk / bk;
  const int nc = (bk + KC - 1) / KC;          // chunks per kv-block
  const int n_it = (w_end - w_beg) * nc;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;                 // this warp's rows in the tile
  const int q_lo = qb * bq + q_offset + row0;  // its first absolute query

  auto stage = [&](int it, int st) {          // chunk it of the stream
    const int kb = ki[w_beg + it / nc], c0 = (it % nc) * KC;
    if (kb < 0 || kb >= nkb) return;          // fully masked: no data
    const size_t at = ((size_t)kb * bk + c0) * D;
    const int rows = min(KC, bk - c0);
    float* Ks = KV + st * C::STAGE;
    load_f32<KC, DM, C::NT>(Ks, Kg + at, rows, D, C::LDQ, vec, tid);
    load_f32<KC, DM, C::NT>(Ks + KC * C::LDQ, Vg + at, rows, D, C::LDV, vec,
                            tid);
  };
  load_f32<BT, DM, C::NT>(Qs, Qg, bq, D, C::LDQ, vec, tid);
#pragma unroll
  for (int i = 0; i < C::STAGES - 1; ++i) {   // one group per chunk, q in
    if (i < n_it) stage(i, i);                // the first
    tc::cp_async_commit();
  }

  float o[ND][4];                             // rows g, g + 8 of the warp
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[n][x] = 0.0f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % C::STAGES;
    const int ahead = it + C::STAGES - 1;     // read ahead: overlaps below
    if (ahead < n_it) stage(ahead, ahead % C::STAGES);
    tc::cp_async_commit();
    tc::cp_async_wait<C::STAGES - 1>();       // chunk it (and q) landed
    __syncthreads();
    const int w = w_beg + it / nc, c0 = (it % nc) * KC;
    const int f = flags[w];                   // uniform across the CTA
    const int kb = ki[w];
    if ((f & 1) && c0 == 0) {
      m_r[0] = m_r[1] = NEG_INF;
      l_r[0] = l_r[1] = 0.0f;
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) o[n][x] = 0.0f;
    }
    // an out-of-range kv-block is fully masked: m, l and acc keep their
    // values (alpha = 1, p = 0), so only the flags act
    if (kb >= 0 && kb < nkb) {
      const float* Ks = KV + st * C::STAGE;
      const float* Vs = Ks + KC * C::LDQ;
      const int keys = min(KC, bk - c0);

      // S = q . k^T for the warp's 16 rows x KC keys.  The mma's k slots
      // t and t + 4 carry head dims 2t and 2t + 1 of each k-step of 8, in
      // both operands, so each operand pair is one 8-byte load.
      float s[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) s[n][x] = 0.0f;
#pragma unroll 2
      for (int kk = 0; kk < DM / 8; ++kk) {
        uint32_t ah[4], al[4];
        {
          const float2 r0 = *reinterpret_cast<const float2*>(
              Qs + (row0 + g) * C::LDQ + 8 * kk + 2 * t);
          const float2 r1 = *reinterpret_cast<const float2*>(
              Qs + (row0 + g + 8) * C::LDQ + 8 * kk + 2 * t);
          split_rna(r0.x, ah[0], al[0]);
          split_rna(r1.x, ah[1], al[1]);
          split_rna(r0.y, ah[2], al[2]);
          split_rna(r1.y, ah[3], al[3]);
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(
              Ks + (8 * j + g) * C::LDQ + 8 * kk + 2 * t);
          uint32_t bh0, bl0, bh1, bl1;
          split_rna(kv.x, bh0, bl0);
          split_rna(kv.y, bh1, bl1);
          float d[4];
          mma_3xtf32(d, ah, al, bh0, bh1, bl0, bl1);
#pragma unroll
          for (int x = 0; x < 4; ++x) s[j][x] += d[x];   // IEEE k-step add
        }
      }

      // scale; mask only where the warp's rows straddle an edge
      const int k_lo = kb * bk + c0, k_hi = k_lo + keys - 1;
      const int q_hi = q_lo + 15;
      const bool full =
          keys == KC && (!causal || k_hi <= q_lo) &&
          (window <= 0 || q_hi - k_lo < window || k_hi < prefix);
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int x = 0; x < 4; ++x) s[n][x] *= scale;
      if (!full) {
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int col = 8 * n + 2 * t + (x & 1);
            const int qg = q_lo + g + (x >> 1) * 8;
            if (col >= keys ||
                !allowed(qg, k_lo + col, causal, window, prefix))
              s[n][x] = NEG_INF;
          }
      }

      // online softmax, rows g (h = 0) and g + 8 (h = 1)
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < NB; ++n)
          mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_r[h], mx);
        const float mc = m_new * LOG2E;
        alpha[h] = exp2_ftz((m_r[h] - m_new) * LOG2E);
        float sum = 0.0f;
#pragma unroll
        for (int n = 0; n < NB; ++n)
#pragma unroll
          for (int x = 2 * h; x < 2 * h + 2; ++x) {
            const bool ok = full || s[n][x] != NEG_INF;
            const float p = ok ? exp2_ftz(fmaf(s[n][x], LOG2E, -mc)) : 0.0f;
            s[n][x] = p;
            sum += p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_r[h] = l_r[h] * alpha[h] + sum;
        m_r[h] = m_new;
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // acc += p . v in 3xTF32.  The C fragment of score tile kk holds
      // keys 2t and 2t + 1 of rows g and g + 8; they go to the A
      // fragment's k slots t and t + 4 as they lie, and v's B fragment
      // reads rows 2t and 2t + 1 to match, so p never moves between
      // threads.
#pragma unroll
      for (int kk = 0; kk < NB; ++kk) {
        uint32_t ph[4], pl[4];
        split_rna(s[kk][0], ph[0], pl[0]);
        split_rna(s[kk][2], ph[1], pl[1]);
        split_rna(s[kk][1], ph[2], pl[2]);
        split_rna(s[kk][3], ph[3], pl[3]);
        const float* V0 = Vs + (8 * kk + 2 * t) * C::LDV + g;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          split_rna(V0[8 * j], bh0, bl0);
          split_rna(V0[C::LDV + 8 * j], bh1, bl1);
          float d[4];
          mma_3xtf32(d, ph, pl, bh0, bh1, bl0, bl1);
#pragma unroll
          for (int x = 0; x < 4; ++x) o[j][x] += d[x];   // IEEE k-step add
        }
      }
    }

    if ((f & 2) && c0 + KC >= bk) {   // flush: acc / l, 0 where l == 0
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + g + 8 * h;
        const float l = l_r[h];
        if (row < bq) {
          float* Or = Og + (size_t)row * D;
#pragma unroll
          for (int n = 0; n < ND; ++n) {
            const int col = 8 * n + 2 * t;
            const float x0 = l > 0.0f ? o[n][2 * h] / fmaxf(l, 1e-30f) : 0.0f;
            const float x1 =
                l > 0.0f ? o[n][2 * h + 1] / fmaxf(l, 1e-30f) : 0.0f;
            if (vec) {
              if (col < D) *reinterpret_cast<float2*>(Or + col) =
                  make_float2(x0, x1);
            } else {
              if (col < D) Or[col] = x0;
              if (col + 1 < D) Or[col + 1] = x1;
            }
          }
        }
      }
    }
    __syncthreads();          // stage st is consumed before it is refilled
  }
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const int *ki, *flags, *seg_ptr;
  void* out;
  int BH, Hq, Hkv, S, Tk, D, bq, bk;
  float scale;
  int causal, window, prefix, q_offset;
  cudaStream_t stream;
};

// CTA shape, dynamic shared memory, registers, local memory per thread and
// resident CTAs per SM of `fn` on the current device
template <typename Fn>
cudaError_t query(Fn* fn, int threads, size_t smem, int* info) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads,
                                                      smem);
  info[0] = threads;
  info[1] = (int)smem;
  info[2] = attr.numRegs;
  info[3] = (int)attr.localSizeBytes;
  info[4] = ctas;
  return err;
}

// the tensor-core kernel for tiles of BT rows and head dim padded to DM
struct TcLaunch {
  const Args& a;
  template <int BT, int DM>
  cudaError_t run() const {
    constexpr size_t smem = TcCfg<BT, DM>::SMEM;
    auto* fn = flash_mask_tc_kernel<BT, DM>;
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const bool aligned = ((reinterpret_cast<uintptr_t>(a.q) |
                           reinterpret_cast<uintptr_t>(a.k) |
                           reinterpret_cast<uintptr_t>(a.v) |
                           reinterpret_cast<uintptr_t>(a.out)) & 15) == 0;
    fn<<<dim3(a.BH, a.S / a.bq), TcCfg<BT, DM>::NT, smem, a.stream>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), a.ki, a.flags, a.seg_ptr,
        static_cast<bf16*>(a.out), a.Hq, a.Hkv, a.S, a.Tk, a.D, a.bq, a.bk,
        a.scale, a.causal, a.window, a.prefix, a.q_offset,
        aligned && a.D % 8 == 0);
    return cudaGetLastError();
  }
};

struct TcInfo {
  int* info;
  template <int BT, int DM>
  cudaError_t run() const {
    return query(flash_mask_tc_kernel<BT, DM>, TcCfg<BT, DM>::NT,
                 TcCfg<BT, DM>::SMEM, info);
  }
};

// the f32 tensor-core kernel for tiles of BT rows and head dim padded to DM
struct F32Launch {
  const Args& a;
  template <int BT, int DM>
  cudaError_t run() const {
    constexpr size_t smem = F32Cfg<BT, DM>::SMEM;
    auto* fn = flash_mask_f32_tc_kernel<BT, DM>;
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const bool aligned = ((reinterpret_cast<uintptr_t>(a.q) |
                           reinterpret_cast<uintptr_t>(a.k) |
                           reinterpret_cast<uintptr_t>(a.v) |
                           reinterpret_cast<uintptr_t>(a.out)) & 15) == 0;
    fn<<<dim3(a.BH, a.S / a.bq), F32Cfg<BT, DM>::NT, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), a.ki, a.flags, a.seg_ptr,
        static_cast<float*>(a.out), a.Hq, a.Hkv, a.S, a.Tk, a.D, a.bq, a.bk,
        a.scale, a.causal, a.window, a.prefix, a.q_offset,
        aligned && a.D % 4 == 0);
    return cudaGetLastError();
  }
};

struct F32Info {
  int* info;
  template <int BT, int DM>
  cudaError_t run() const {
    return query(flash_mask_f32_tc_kernel<BT, DM>, F32Cfg<BT, DM>::NT,
                 F32Cfg<BT, DM>::SMEM, info);
  }
};

// op.run<BT, DM>() with BT = max(bq, bk) and DM = D rounded up to the
// instantiated tiles
template <int BT, class Op>
cudaError_t by_dim(int D, const Op& op) {
  if (D <= 16) return op.template run<BT, 16>();
  if (D <= 64) return op.template run<BT, 64>();
  return op.template run<BT, 128>();
}

template <class Op>
cudaError_t by_tile(int bq, int bk, int D, const Op& op) {
  const int big = bq > bk ? bq : bk;
  if (big <= 16) return by_dim<16>(D, op);
  if (big <= 32) return by_dim<32>(D, op);
  if (big <= 64) return by_dim<64>(D, op);
  return by_dim<128>(D, op);
}

}  // namespace

// C interface (bound with ctypes).  Pointers are device pointers of
// contiguous tensors of one dtype (0 = f32, 1 = bf16): q (B, Hq, S, D),
// k and v (B, Hkv, Tk, D), out (B, Hq, S, D) zero-initialised; ki and flags
// (P,) int32 worklist entries sorted by q-block, seg_ptr (S / bq + 1,)
// int32 segment offsets of each q-block.  BH = B * Hq.  Requires
// S % bq == Tk % bk == Hq % Hkv == 0, 1 <= bq, bk <= 128, D <= 128 and
// BH, S / bq <= 65535 (the wrapper checks).  dtype 1 runs the bf16
// tensor-core kernel, dtype 0 the f32 (3xTF32) one.  Returns the
// cudaError_t of the launch (0 on success); an unknown dtype returns
// cudaErrorInvalidValue.
extern "C" int flash_mask(const void* q, const void* k, const void* v,
                          const int* ki, const int* flags,
                          const int* seg_ptr, void* out, int BH, int Hq,
                          int Hkv, int S, int Tk, int D, int bq, int bk,
                          float scale, int causal, int window, int prefix,
                          int q_offset, int dtype, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  const Args a{q,  k,   v,  ki, flags, seg_ptr, out,    BH,     Hq,
               Hkv, S,  Tk, D,  bq,    bk,      scale,  causal, window,
               prefix, q_offset, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0:
      return by_tile(bq, bk, D, F32Launch{a});
    case 1:
      return by_tile(bq, bk, D, TcLaunch{a});
    default:
      return cudaErrorInvalidValue;
  }
}

// The tensor-core kernel that flash_mask runs for bf16 blocks (bq, bk) and
// head dim D: info receives threads per CTA, dynamic shared memory bytes,
// registers per thread, local (spill) bytes per thread and resident CTAs
// per SM on the current device.  Returns a cudaError_t.
extern "C" int flash_mask_tc_info(int bq, int bk, int D, int* info) {
  return by_tile(bq, bk, D, TcInfo{info});
}

// The same for the f32 (3xTF32) tensor-core kernel.
extern "C" int flash_mask_f32_info(int bq, int bk, int D, int* info) {
  return by_tile(bq, bk, D, F32Info{info});
}
