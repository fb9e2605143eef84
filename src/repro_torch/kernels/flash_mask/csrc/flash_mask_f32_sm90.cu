// Block-masked flash attention in f32 (3xTF32), designed for Hopper
// (sm_90a): TMA loads behind mbarriers, a producer warpgroup whose idle
// warps split k and v into tf32 hi and lo once per tile, consumer
// warpgroups on tf32 wgmma.mma_async.
//
// Replaces the TPU kernel
//   repro/kernels/flash_mask/kernel.py::flash_mask_kernel
// together with the batch/head vmap of repro/kernels/flash_mask/ops.py, for
// f32 inputs with q and kv blocks of 64 or 128 and a head dim of 64, 112
// or 128 (kernel.py's dispatch predicate: llama3.2-1b's and seamless's 64,
// zamba2-7b's 112, moonshot's 128); every other f32 shape runs
// flash_mask.cu's mma.sync kernel (flash_mask_f32_tc_kernel).  It computes
// what that kernel and flash_mask_plain compute: one CTA per (row block,
// batch * head) walks its q-block's segment seg_ptr[qb] .. seg_ptr[qb + 1]
// of the qi-sorted worklist (ki, flags) in order, with no atomics; flag bit
// 1 resets the running max m, normaliser l and accumulator, bit 2 writes
// acc / l (rows with l == 0 as 0); the element mask (causal: k <= q;
// window: q - k < window or k < prefix) applies at q + q_offset, masked
// scores are NEG_INF = -1e30 and their p zeroed; an out-of-range kv-block
// is fully masked; a never-visited q-block comes out as zeros (the kernel
// writes them: the output is not cleared first); query head h of batch b
// reads kv head (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv); the longest
// q-blocks launch first.
//
// Numerics: both products in 3xTF32, a_lo b_hi + a_hi b_lo + a_hi b_hi.  The
// hi of a split is the raw f32 word (RAW_HI): tf32 wgmma reads only its upper
// 19 bits, so the tensor cores see trunc(x), and lo = rna(x - trunc(x)).  That
// leaves up to 2^-21 |x| out where rna hi leaves 2^-22, and saves work: k's
// and q's hi are the tiles as TMA landed them, p's hi is one AND (rna hi,
// stored, took 3-5 % more time at the path's shapes:
// tools/flash_f32_sm90_variants.py).  The tensor cores' f32 sums truncate, so
// no sum is left in them for long: q.k^T sums FLUSH_QK k8 steps (three wgmma
// each) in a partial that is then added to the scores with IEEE rounding, and
// p.v sums FLUSH_PV (FLUSH_PV_WIDE at D 112 and 128) k8 steps of keys in a
// partial that is added to O with IEEE rounding after O = O * alpha: the plain
// version's acc * alpha + p.v, with O never accumulating in the tensor cores.
// tests/test_torch_flash_f32_sm90.py emulates the scheme with the intervals
// and the hi scheme read from here: 2.24e-7 normwise of float64 at S 256, D 64
// (the gate 2e-6 / 5; rna hi 1.7-1.8e-7, a truncated lo as well 3.8e-7), where
// O accumulated in the tensor cores reads 7.6-8.0e-7 and one tf32 pass 7e-4.
// A tensor core that rounded the raw word instead of truncating it would leave
// up to 2^-11 of x out, about 1e-4 normwise: chip_smoke.py's 2e-6 against
// float64 would fail (on an H100 80GB HBM3 the layer reads 2.4e-7).
//
// Bound on an H100 SXM at the full-width llama3.2-1b layer (B 4, Hq 32,
// Hkv 8, S 2048, D 64, 128-blocks, causal): 68.75 GFLOP at the allowed
// elements, three TF32 passes at 495 TFLOP/s: 0.417 ms (B 1: 0.104); 168
// MB of q, k, v and output take 0.05 ms at 3.35 TB/s: bound by operations.
// flash_mask_f32_tc_kernel reached 21-23 % of it: mma.sync m16n8k8, each
// of the 8 warps of a CTA split every k and v element it read (each
// element 8 times) and q's fragments on every chunk, and every k8 step's
// add rounded in IEEE; a cp.async ring with a __syncthreads per chunk;
// registers capped at 128.  This kernel:
//   - the layouts: tf32 wgmma reads a shared-memory operand only K-major
//     (sm90.cuh).  q.k^T is K-major on both sides (q and k are head-dim
//     contiguous): m64nKCk8 with q and k from shared memory.  p.v is not:
//     v is head-dim contiguous and the reduction runs over keys.  So the
//     producer warpgroup's three idle warps write v^T (keys contiguous)
//     into shared memory, split into hi and lo, with the keys of each
//     group of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7: the S accumulator's
//     m16n8 C fragment holds keys 2t and 2t + 1 of a thread, which are the
//     m16k8 tf32 A fragment's k slots t and t + 4 in that order, so p
//     becomes the register A operand of m64nDk8 without moving between
//     threads;
//   - every element is split once: q by its consumer warpgroup when it
//     lands (lo beside hi), k and v by the splitting warps when a chunk
//     lands (k's lo beside hi; v^T's hi and lo into two tiles), then
//     fence.proxy.async and an mbarrier (k and v each their own, so that
//     q.k^T starts while v is transposed); p by its consumer in
//     registers, per k8 step, into words of their own: when p's raw
//     register (the S accumulator's) served as hi, ptxas serialised every
//     wgmma and the llama layer took 2.1x as long.  Splitting k and v is
//     much of what the tensor cores wait on (tools/flash_f32_sm90_variants
//     .py, llama B 4: without it 19 % less time, with one tf32 pass for
//     each product 24 % less);
//   - one thread of the producer warpgroup issues TMA loads of q once and
//     of k and v in chunks of KC keys into a ring of STAGES stages, each
//     with full (TMA bytes), k-ready, v-ready (split) and empty (consumed)
//     mbarriers; an out-of-range kv-block arrives with no bytes, so the
//     phases of every stage stay aligned for every role;
//   - consumer warpgroups of 64 query rows hold S, O and two p.v partials
//     in registers; p.v's partials alternate, so that one is added to O
//     while the next runs on the tensor cores (a flush every k8 step beat
//     every 2 and 4 by 2-11 % at D 64: fewer partial registers, no
//     spills); two warpgroups take turns to issue q.k^T (named barriers),
//     so that one's softmax overlaps the other's products (1-2 %).
// Shared memory a CTA (the 227 KB limit is 232,448 bytes): q hi and lo
// R * DP * 8 bytes; a stage holds k hi, k lo, the landing v, v^T hi and
// v^T lo, 5 * KC * DP * 4 bytes:
//   <128, 64>  (bq 128, D 64; KC 64): 64 KiB + 2 x 80 KiB = 224 KiB, one
//              CTA an SM, two consumer warpgroups (setmaxnreg 72 / 216);
//   <64, 64>   (bq 64, D 64; KC 64): 32 KiB + 2 x 80 KiB = 192 KiB;
//   <64, 128>  (D 112 and 128; KC 32): 64 KiB + 2 x 80 KiB = 224 KiB.
// At D 128 a 128-row CTA needs 128 KiB of q and 160 KiB a 64-key stage, so
// a q-block of 128 rows runs as two CTAs of 64 rows, each walking the same
// worklist segment (k and v are read twice), with chunks
// of 32 keys; at D 112 TMA fills head dims 112-127 with zeros.  With one
// consumer warpgroup a CTA keeps every register (no setmaxnreg).
// tools/flash_f32_sm90_variants.py times these choices (the flush
// intervals, the chunk keys, the stages, the turns, the register split,
// the splitters' batches and the hi scheme) against the adopted build.
// The C entry builds the tensor maps of q, k and v on every call
// (sm90::map_2d) and passes them as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// k8 steps summed in the tensor cores before an IEEE add: q.k^T, and p.v
// at D 64 (KC 64) and at D 112 and 128 (KC 32)
constexpr int FLUSH_QK = 8;
constexpr int FLUSH_PV = 1;
constexpr int FLUSH_PV_WIDE = 4;
// the hi term of a split is the raw f32 word (tf32 wgmma reads its upper
// 19 bits: the word truncated) and lo = rna(x - trunc(x)); false: hi =
// rna(x), lo = rna(x - hi), with hi stored
constexpr bool RAW_HI = true;
// k/v ring depth
constexpr int STAGES = 2;
// with two consumer warpgroups, whether they take turns issuing q.k^T
// (named barriers PING + wg), so that one's softmax runs while the
// other's products are on the tensor cores
constexpr bool PINGPONG = true;
constexpr int PING = 3;
// registers a thread of each role holds after setmaxnreg (two consumer
// warpgroups: ptxas starts the kernel at 168 a thread)
constexpr int PRODUCER_REGS = 72;
constexpr int CONSUMER_REGS = 216;
// the producer warpgroup's warps 1-3 split k and v
constexpr int SPLITTERS = 96;
// 16-byte words of k a splitter loads before it splits any
constexpr int SPLIT_BATCH = 4;

// tc::split_tf32 in integer arithmetic: adding 2^12 to the bit pattern and
// clearing its low 13 bits rounds to 10 mantissa bits, to nearest with
// ties away from zero (cvt.rna.tf32.f32's result for every finite x)
__device__ __forceinline__ uint32_t rna_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-21 |x|): with RAW_HI, hi = trunc(x) (what tf32 wgmma
// reads of x's own word, which therefore serves as hi in shared memory),
// else rna(x).  hi is a word of its own: an A operand of p.v that was
// x's register itself (the S accumulator's) made ptxas serialise the
// wgmma (tools/flash_f32_sm90_variants.py)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = RAW_HI ? __float_as_uint(x) & 0xffffe000u : rna_bits(x);
  lo = rna_bits(x - __uint_as_float(hi));
}

// x's four hi words in place, their lo words returned
__device__ __forceinline__ float4 split4(float4& x) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  x = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                  __uint_as_float(h[2]), __uint_as_float(h[3]));
  return make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                     __uint_as_float(l[2]), __uint_as_float(l[3]));
}

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

// R: query rows a CTA (64 or 128: one or two consumer warpgroups); DP:
// head dim padded to 64 or 128 (two or four 32-column panels)
template <int R, int DP>
struct Cfg {
  static constexpr int NC = R / 64;               // consumer warpgroups
  static constexpr int THREADS = (NC + 1) * 128;  // + the producer's
  static constexpr bool SPLIT_REGS = NC == 2;     // setmaxnreg
  static constexpr int KC = DP == 64 ? 64 : 32;   // keys a chunk
  static constexpr int FPV = DP == 64 ? FLUSH_PV : FLUSH_PV_WIDE;
  static constexpr int NP = DP / 32;              // 32-column panels
  static constexpr int Q_BYTES = R * DP * 4;      // q hi (or lo)
  static constexpr int T_BYTES = KC * DP * 4;     // one k, v or v^T tile
  // a stage: k (hi after the split) | k lo | v as landed | v^T hi | lo
  static constexpr int K_HI = 0, K_LO = T_BYTES, V_IN = 2 * T_BYTES,
                       VT_HI = 3 * T_BYTES, VT_LO = 4 * T_BYTES;
  static constexpr int STAGE_BYTES = 5 * T_BYTES;
  static constexpr int Q_LO = Q_BYTES;
  static constexpr int ST_OFF = 2 * Q_BYTES;
  static constexpr int BAR_OFF = ST_OFF + STAGES * STAGE_BYTES;
  // + 1024 bytes to align the base to the swizzle's 1024 bytes
  static constexpr int SMEM = BAR_OFF + 8 * (4 * STAGES + 1) + 1024;
  static_assert(SMEM <= 232448, "shared memory of one CTA");
  static_assert((DP / 8) % FLUSH_QK == 0 && (KC / 8) % FPV == 0,
                "flush intervals divide the k8 steps");
};

template <int N>
struct Scores;
template <>
struct Scores<32> {
  static __device__ __forceinline__ void mma(float (&s)[16], uint64_t da,
                                             uint64_t db, int acc) {
    sm90::wgmma_ss_tf32_n32(s, da, db, acc);
  }
};
template <>
struct Scores<64> {
  static __device__ __forceinline__ void mma(float (&s)[32], uint64_t da,
                                             uint64_t db, int acc) {
    sm90::wgmma_ss_tf32_n64(s, da, db, acc);
  }
};

template <int N>
struct Values;
template <>
struct Values<64> {
  static __device__ __forceinline__ void mma(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    sm90::wgmma_rs_tf32_n64(o, a, db, acc);
  }
};
template <>
struct Values<128> {
  static __device__ __forceinline__ void mma(float (&o)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int acc) {
    sm90::wgmma_rs_tf32_n128(o, a, db, acc);
  }
};

// the v^T slot of key k of a chunk: keys 2t and 2t + 1 of each group of 8
// at slots t and t + 4 (the order of the S fragment's k slots)
__device__ __forceinline__ int slot_of(int k) {
  return (k & ~7) | ((k & 1) << 2) | ((k >> 1) & 3);
}

template <int R, int DP>
__global__ void __launch_bounds__(Cfg<R, DP>::THREADS, 1)
flash_mask_f32_sm90_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const int* __restrict__ ki,
                           const int* __restrict__ flags,
                           const int* __restrict__ seg_ptr,
                           float* __restrict__ out, int Hq, int Hkv, int S,
                           int Tk, int D, int bq, int bk, float scale,
                           int causal, int window, int prefix,
                           int q_offset) {
  using C = Cfg<R, DP>;
  constexpr int NC = C::NC, KC = C::KC, NP = C::NP;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sbase = smem_raw + (base - raw);
  const uint32_t bars = base + C::BAR_OFF;
  auto full = [&](int st) { return bars + 8u * st; };
  auto ready_k = [&](int st) { return bars + 8u * (STAGES + st); };
  auto ready_v = [&](int st) { return bars + 8u * (2 * STAGES + st); };
  auto empty = [&](int st) { return bars + 8u * (3 * STAGES + st); };
  const uint32_t q_bar = bars + 8u * (4 * STAGES);

  const int row0 = (gridDim.y - 1 - blockIdx.y) * R;  // longest first
  const int bh = blockIdx.x;                          // b * Hq + h
  const int qb = row0 / bq;
  const int w_beg = seg_ptr[qb], w_end = seg_ptr[qb + 1];
  float* const og = out + ((size_t)bh * S + row0) * D;
  if (w_beg >= w_end) {     // never visited: zeros (out is not cleared first)
    for (int e = threadIdx.x; e < R * D / 4; e += blockDim.x)
      reinterpret_cast<float4*>(og)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int nkb = Tk / bk, nch = bk / KC;           // chunks an entry
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      sm90::mbar_init(full(st), 1);
      sm90::mbar_init(ready_k(st), SPLITTERS);
      sm90::mbar_init(ready_v(st), SPLITTERS);
      sm90::mbar_init(empty(st), NC * 128);
    }
    sm90::mbar_init(q_bar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= NC * 4) {
    // ---- producer warpgroup: its first warp's lane 0 issues every copy,
    // warps 1-3 split k and transpose v ----
    if constexpr (C::SPLIT_REGS) sm90::setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == NC * 4) {
      if (lane != 0) return;
      const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
      sm90::mbar_arrive_expect_tx(q_bar, C::Q_BYTES);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        sm90::tma_load_2d(base + p * R * 128, &q_map, q_bar, 32 * p,
                          bh * S + row0);
      int it = 0;
      for (int w = w_beg; w < w_end; ++w) {
        const int kb = ki[w];
        const bool in = kb >= 0 && kb < nkb;
        for (int c = 0; c < nch; ++c, ++it) {
          const int st = it % STAGES;
          sm90::mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);
          if (in) {
            sm90::mbar_arrive_expect_tx(full(st), 2 * C::T_BYTES);
            const uint32_t s = base + C::ST_OFF + st * C::STAGE_BYTES;
            const int row = kvh * Tk + kb * bk + c * KC;
#pragma unroll
            for (int p = 0; p < NP; ++p) {
              sm90::tma_load_2d(s + C::K_HI + p * KC * 128, &k_map, full(st),
                                32 * p, row);
              sm90::tma_load_2d(s + C::V_IN + p * KC * 128, &v_map, full(st),
                                32 * p, row);
            }
          } else {
            // fully masked: no bytes, but the stage's phase still turns
            sm90::mbar_arrive(full(st));
          }
        }
      }
      return;
    }
    const int e0 = tid - NC * 128 - 32;             // 0 .. SPLITTERS - 1
    const int sw = e0 >> 5;                         // splitting warp 0 .. 2
    int it = 0;
    for (int w = w_beg; w < w_end; ++w) {
      const int kb = ki[w];
      const bool in = kb >= 0 && kb < nkb;
      for (int c = 0; c < nch; ++c, ++it) {
        const int st = it % STAGES;
        sm90::mbar_wait(full(st), (it / STAGES) & 1);
        unsigned char* const s = sbase + C::ST_OFF + st * C::STAGE_BYTES;
        if (in) {
          // k: lo beside, at the same swizzled offsets, and hi in place
          // (unless it is the raw word as landed)
          float4* hi = reinterpret_cast<float4*>(s + C::K_HI);
          float4* lo = reinterpret_cast<float4*>(s + C::K_LO);
          for (int e1 = e0; e1 < C::T_BYTES / 16;
               e1 += SPLIT_BATCH * SPLITTERS) {
            float4 x[SPLIT_BATCH];
#pragma unroll
            for (int i = 0; i < SPLIT_BATCH; ++i)
              if (e1 + i * SPLITTERS < C::T_BYTES / 16)
                x[i] = hi[e1 + i * SPLITTERS];
#pragma unroll
            for (int i = 0; i < SPLIT_BATCH; ++i) {
              const int e = e1 + i * SPLITTERS;
              if (e >= C::T_BYTES / 16) break;
              lo[e] = split4(x[i]);
              if (!RAW_HI) hi[e] = x[i];
            }
          }
        }
        sm90::fence_proxy_async();        // the wgmma read them next
        sm90::mbar_arrive(ready_k(st));
        if (in) {
          // v^T: lane l of a warp takes key 32 h + l of 16-byte column cc
          // of head-dim panel p (four head dims) and writes them to v^T
          // rows d .. d + 3 at its slot: the reads cover one row each
          // (their swizzled columns differ in every 8 lanes) and each
          // write's 32 slots fall in 32 banks
          constexpr int ITEMS = (KC / 32) * NP * 8;
          for (int i = sw; i < ITEMS; i += SPLITTERS / 32) {
            const int cc = i & 7, p = (i >> 3) % NP, h = i / (8 * NP);
            const int key = 32 * h + lane;
            float4 x = *reinterpret_cast<const float4*>(
                s + C::V_IN + p * KC * 128 + key * 128 +
                ((cc ^ (key & 7)) << 4));
            const float4 l = split4(x);
            const int sl = slot_of(key) & 31;
            const float xh[4] = {x.x, x.y, x.z, x.w};
            const float xl[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int d = 32 * p + 4 * cc + j;
              const int off = h * DP * 128 + d * 128 +
                              ((((sl >> 2) ^ (d & 7)) << 4) | ((sl & 3) << 2));
              *reinterpret_cast<float*>(s + C::VT_HI + off) = xh[j];
              *reinterpret_cast<float*>(s + C::VT_LO + off) = xl[j];
            }
          }
        }
        sm90::fence_proxy_async();
        sm90::mbar_arrive(ready_v(st));
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns the CTA's rows 64 wg .. 64 wg + 63
  if constexpr (C::SPLIT_REGS) sm90::setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int q_lo = row0 + wg * 64 + q_offset;     // first absolute query
  const int r0 = q_lo + wq * 16 + g;              // rows r0 and r0 + 8
  const uint32_t qh = base + wg * 64 * 128, ql = qh + C::Q_LO;

  // q's lo (and hi, unless it is the raw word), once: this warpgroup's
  // 64 rows of every panel
  sm90::mbar_wait(q_bar, 0);
  for (int e = tid & 127; e < 64 * DP / 4; e += 128) {
    const int p = e / 512, r = e % 512;           // 512 words a panel
    float4* x = reinterpret_cast<float4*>(sbase + p * R * 128 +
                                          wg * 64 * 128) + r;
    float4 v = *x;
    const float4 l = split4(v);
    if (!RAW_HI) *x = v;
    *reinterpret_cast<float4*>(reinterpret_cast<unsigned char*>(x) +
                               C::Q_LO) = l;
  }
  sm90::fence_proxy_async();
  sm90::named_sync(1 + wg, 128);
  constexpr bool TURNS = PINGPONG && NC == 2;
  if (TURNS && wg == 1) sm90::named_arrive(PING, 256);   // warpgroup 0 first

  constexpr int NS = KC / 2;         // score registers (64 rows x KC keys)
  constexpr int NO = DP / 2;         // output registers (64 rows x DP)
  constexpr int NGQ = DP / 8 / FLUSH_QK;
  constexpr int FPV = C::FPV, NGV = KC / 8 / FPV;
  float o[NO];                       // rows r0, r0 + 8
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.0f, 0.0f};
  bool flushed = false;              // did any entry write the rows?
#pragma unroll
  for (int x = 0; x < NO; ++x) o[x] = 0.0f;

  int it = 0;
  for (int w = w_beg; w < w_end; ++w) {
    const int f = flags[w];                        // uniform across the CTA
    const int kb = ki[w];
    const bool in = kb >= 0 && kb < nkb;
    if (f & 1) {
      m_r[0] = m_r[1] = NEG_INF;
      l_r[0] = l_r[1] = 0.0f;
#pragma unroll
      for (int x = 0; x < NO; ++x) o[x] = 0.0f;
    }
    for (int c = 0; c < nch; ++c, ++it) {
      const int st = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      const uint32_t s = base + C::ST_OFF + st * C::STAGE_BYTES;
      float sc[NS];
      sm90::mbar_wait(ready_k(st), ph);
      // an out-of-range kv-block is fully masked: m, l and acc keep their
      // values (alpha = 1, p = 0), so only the flags act
      if (in) {
        // S = q . k^T: per k8 step q_lo k_hi, q_hi k_lo, q_hi k_hi (small
        // terms first); the first FLUSH_QK steps straight into S, each
        // later group into a partial added with IEEE rounding
        auto qk_group = [&](float (&d)[NS], int g0) {
#pragma unroll
          for (int kk = g0; kk < g0 + FLUSH_QK; ++kk) {
            const int pan = kk / 4, off = (kk % 4) * 32;
            const uint64_t dqh = sm90::desc_sw128(qh + pan * R * 128 + off,
                                                  16, 1024);
            const uint64_t dql = sm90::desc_sw128(ql + pan * R * 128 + off,
                                                  16, 1024);
            const uint64_t dkh = sm90::desc_sw128(
                s + C::K_HI + pan * KC * 128 + off, 16, 1024);
            const uint64_t dkl = sm90::desc_sw128(
                s + C::K_LO + pan * KC * 128 + off, 16, 1024);
            Scores<KC>::mma(d, dql, dkh, kk > g0);
            Scores<KC>::mma(d, dqh, dkl, 1);
            Scores<KC>::mma(d, dqh, dkh, 1);
          }
        };
        if (TURNS) sm90::named_sync(PING + wg, 256);     // this one's turn
        sm90::wgmma_fence();
        qk_group(sc, 0);
        sm90::wgmma_commit();
        if (TURNS) sm90::named_arrive(PING + (wg ^ 1), 256);  // the other's
#pragma unroll
        for (int gq = 1; gq < NGQ; ++gq) {
          float part[NS];
          sm90::wgmma_fence();
          qk_group(part, gq * FLUSH_QK);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_operand(part);
          sm90::fence_operand(sc);
#pragma unroll
          for (int x = 0; x < NS; ++x) sc[x] += part[x];
        }
        sm90::wgmma_wait<0>();
        sm90::fence_operand(sc);

        // scale; mask only where the warpgroup's rows straddle an edge;
        // the online softmax of rows r0 (h = 0) and r0 + 8 (h = 1), as
        // flash_mask_f32_tc_kernel's
        const int k_lo = kb * bk + c * KC, k_hi = k_lo + KC - 1;
        const bool full_tile =
            (!causal || k_hi <= q_lo) &&
            (window <= 0 || q_lo + 63 - k_lo < window || k_hi < prefix);
#pragma unroll
        for (int x = 0; x < NS; ++x) sc[x] *= scale;
        if (!full_tile) {
#pragma unroll
          for (int j = 0; j < KC / 8; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x)
              if (!allowed(r0 + 8 * (x >> 1), k_lo + 8 * j + 2 * t + (x & 1),
                           causal, window, prefix))
                sc[4 * j + x] = NEG_INF;
        }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = NEG_INF;
#pragma unroll
          for (int j = 0; j < KC / 8; ++j)
            mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_r[h], mx);
          const float mc = m_new * LOG2E;
          alpha[h] = exp2_ftz((m_r[h] - m_new) * LOG2E);
          float sum = 0.0f;
#pragma unroll
          for (int j = 0; j < KC / 8; ++j)
#pragma unroll
            for (int x = 2 * h; x < 2 * h + 2; ++x) {
              const bool ok = full_tile || sc[4 * j + x] != NEG_INF;
              const float p =
                  ok ? exp2_ftz(fmaf(sc[4 * j + x], LOG2E, -mc)) : 0.0f;
              sc[4 * j + x] = p;
              sum += p;
            }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          l_r[h] = l_r[h] * alpha[h] + sum;
          m_r[h] = m_new;
        }
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
      }
      sm90::mbar_wait(ready_v(st), ph);
      if (in) {
        // O += p . v: per k8 step of keys j, p's hi and lo as register A
        // operands (S fragment registers 4j, 4j + 2, 4j + 1, 4j + 3 are
        // the A fragment's a0 .. a3), v^T from shared memory; p_lo v_hi,
        // p_hi v_lo, p_hi v_hi into a partial of FPV steps, the partials
        // alternating between two register sets, each added to O with
        // IEEE rounding once its wgmma are done
        float pa[NO], pb[NO];
        auto pv_group = [&](float (&part)[NO], int gv) {
          uint32_t hi[FPV][4], lo[FPV][4];
#pragma unroll
          for (int i = 0; i < FPV; ++i) {
            const int j = gv * FPV + i;
            split_tf32(sc[4 * j], hi[i][0], lo[i][0]);
            split_tf32(sc[4 * j + 2], hi[i][1], lo[i][1]);
            split_tf32(sc[4 * j + 1], hi[i][2], lo[i][2]);
            split_tf32(sc[4 * j + 3], hi[i][3], lo[i][3]);
          }
#pragma unroll
          for (int i = 0; i < FPV; ++i) {
            sm90::fence_operand(hi[i]);
            sm90::fence_operand(lo[i]);
          }
          sm90::fence_operand(part);
          sm90::wgmma_fence();
#pragma unroll
          for (int i = 0; i < FPV; ++i) {
            const int j = gv * FPV + i;
            const uint32_t off = (j / 4) * DP * 128 + (j % 4) * 32;
            const uint64_t dvh = sm90::desc_sw128(s + C::VT_HI + off, 16,
                                                  1024);
            const uint64_t dvl = sm90::desc_sw128(s + C::VT_LO + off, 16,
                                                  1024);
            Values<DP>::mma(part, lo[i], dvh, i > 0);
            Values<DP>::mma(part, hi[i], dvl, 1);
            Values<DP>::mma(part, hi[i], dvh, 1);
          }
          sm90::wgmma_commit();
        };
        auto add = [&](float (&part)[NO]) {
          sm90::fence_operand(part);
#pragma unroll
          for (int x = 0; x < NO; ++x) o[x] += part[x];
        };
#pragma unroll
        for (int gv = 0; gv < NGV; ++gv) {
          if (gv % 2 == 0)
            pv_group(pa, gv);
          else
            pv_group(pb, gv);
          if (gv > 0) {                 // the group before this one is done
            sm90::wgmma_wait<1>();
            if (gv % 2 == 1)
              add(pa);
            else
              add(pb);
          }
        }
        sm90::wgmma_wait<0>();
        if ((NGV - 1) % 2 == 0)
          add(pa);
        else
          add(pb);
      }
      sm90::mbar_arrive(empty(st));               // stage st may be refilled
    }

    if (f & 2) {          // flush: acc / l, 0 where l == 0
      flushed = true;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float l = l_r[h];
        float* orow = og + (size_t)(wg * 64 + wq * 16 + g + 8 * h) * D;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = 8 * j + 2 * t;
          const float x0 = l > 0.0f ? o[4 * j + 2 * h] / fmaxf(l, 1e-30f)
                                    : 0.0f;
          const float x1 = l > 0.0f ? o[4 * j + 2 * h + 1] / fmaxf(l, 1e-30f)
                                    : 0.0f;
          if (col < D)
            *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
        }
      }
    }
  }
  // warpgroup 1 arrived once more on warpgroup 0's turn than it waited
  if (TURNS && wg == 0) sm90::named_sync(PING, 256);
  if (!flushed) {  // no entry wrote the rows: zeros, as out was not cleared
    float* ow = og + (size_t)wg * 64 * D;
    for (int e = tid & 127; e < 64 * D / 4; e += 128)
      reinterpret_cast<float4*>(ow)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// ---------------------------------------------------------------------------
// host side
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

// Set the kernel's dynamic shared memory and, with a producer and two
// consumer warpgroups, check that setmaxnreg can move its registers: the
// registers the CTA launches with must cover the consumers' raise from
// what the producer warpgroup gives up, or setmaxnreg.inc would wait
// forever.  Done once per instance and device.
template <int R, int DP>
cudaError_t prepare() {
  using C = Cfg<R, DP>;
  static std::atomic<uint32_t> done{0};            // bit d: device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = dev < 32 ? 1u << dev : 0u;
  if (done.load() & bit) return cudaSuccess;
  auto* fn = flash_mask_f32_sm90_kernel<R, DP>;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  const int r = attr.numRegs;
  if (C::SPLIT_REGS &&
      (r < PRODUCER_REGS || r > CONSUMER_REGS ||
       (r - PRODUCER_REGS) * 128 < (CONSUMER_REGS - r) * C::NC * 128))
    return cudaErrorLaunchOutOfResources;
  done.fetch_or(bit);
  return cudaSuccess;
}

// the (rows, D) f32 row-major matrix at ptr in boxes of 32 columns x
// box_rows rows in the 128-byte swizzle; columns >= D read as zeros
cudaError_t make_map(CUtensorMap* map, const void* ptr, uint64_t rows, int D,
                     int box_rows) {
  return sm90::map_2d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, rows, D,
                      32, box_rows);
}

template <int R, int DP>
struct Kernel {
  using C = Cfg<R, DP>;

  static cudaError_t launch(const Args& a) {
    cudaError_t err = prepare<R, DP>();
    if (err != cudaSuccess) return err;
    const int B = a.BH / a.Hq;
    CUtensorMap qm, km, vm;
    if ((err = make_map(&qm, a.q, (uint64_t)a.BH * a.S, a.D, R)) ||
        (err = make_map(&km, a.k, (uint64_t)B * a.Hkv * a.Tk, a.D, C::KC)) ||
        (err = make_map(&vm, a.v, (uint64_t)B * a.Hkv * a.Tk, a.D, C::KC)))
      return err;
    flash_mask_f32_sm90_kernel<R, DP>
        <<<dim3(a.BH, a.S / R), C::THREADS, C::SMEM, a.stream>>>(
            qm, km, vm, a.ki, a.flags, a.seg_ptr, static_cast<float*>(a.out),
            a.Hq, a.Hkv, a.S, a.Tk, a.D, a.bq, a.bk, a.scale, a.causal,
            a.window, a.prefix, a.q_offset);
    return cudaGetLastError();
  }

  static cudaError_t info(int* out) {
    cudaError_t err = prepare<R, DP>();
    if (err != cudaSuccess) return err;
    auto* fn = flash_mask_f32_sm90_kernel<R, DP>;
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

// the shapes this kernel takes: blocks of 64 or 128, head dim 64, 112 or
// 128
bool takes(int bq, int bk, int D) {
  return (bq == 64 || bq == 128) && (bk == 64 || bk == 128) &&
         (D == 64 || D == 112 || D == 128);
}

// D 64: CTAs of the q-block's rows; D 112 and 128: CTAs of 64 rows
template <class Op>
cudaError_t by_shape(int bq, int bk, int D, const Op& op) {
  if (!takes(bq, bk, D)) return cudaErrorInvalidValue;
  if (D > 64) return op(Kernel<64, 128>());
  return bq == 128 ? op(Kernel<128, 64>()) : op(Kernel<64, 64>());
}

}  // namespace

// C interface (bound with ctypes), flash_mask_sm90's signature.  Device
// pointers of contiguous f32 tensors with 16-byte aligned bases: q (B, Hq,
// S, D), k and v (B, Hkv, Tk, D), out (B, Hq, S, D), every element of which
// the kernel writes (zeros where no flush reaches: it need not be
// cleared); ki and flags (P,) int32 worklist entries sorted by q-block,
// seg_ptr (S / bq + 1,) int32 segment offsets of each q-block.  BH = B *
// Hq.  Returns the cudaError_t of the launch (0 on success); a shape this
// kernel does not take (bq or bk not 64 or 128, D not 64, 112 or 128,
// S % bq, Tk % bk or Hq % Hkv not 0, S / 64 over 65535, a misaligned
// pointer) returns
// cudaErrorInvalidValue and launches nothing; a register count that cannot
// fund setmaxnreg returns cudaErrorLaunchOutOfResources.
extern "C" int flash_mask_f32_sm90(const void* q, const void* k,
                                   const void* v, const int* ki,
                                   const int* flags, const int* seg_ptr,
                                   void* out, int BH, int Hq, int Hkv, int S,
                                   int Tk, int D, int bq, int bk, float scale,
                                   int causal, int window, int prefix,
                                   int q_offset, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(out);
  if (!takes(bq, bk, D) || (ptrs & 15) || Hq <= 0 || Hkv <= 0 ||
      Hq % Hkv || BH % Hq || S % bq || Tk % bk || S / 64 > 65535)
    return cudaErrorInvalidValue;
  if (BH <= 0 || S <= 0) return 0;
  const Args a{q,  k,   v,  ki, flags, seg_ptr, out,    BH,     Hq,
               Hkv, S,  Tk, D,  bq,    bk,      scale,  causal, window,
               prefix, q_offset, static_cast<cudaStream_t>(stream)};
  return by_shape(bq, bk, D, [&](auto kern) { return kern.launch(a); });
}

// The kernel instance flash_mask_f32_sm90 runs for blocks (bq, bk) and head
// dim D: info receives threads per CTA, dynamic shared memory bytes,
// registers per thread at launch, local (spill) bytes per thread and
// resident CTAs per SM on the current device.  Returns a cudaError_t.
extern "C" int flash_mask_f32_sm90_info(int bq, int bk, int D, int* info) {
  return by_shape(bq, bk, D, [&](auto kern) { return kern.info(info); });
}
