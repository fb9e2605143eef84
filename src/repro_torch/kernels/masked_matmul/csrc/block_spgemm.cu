// Masked BCSR x BCSR block product on tensor cores, replaying a rank-sorted
// worklist; optionally the structural counting replay in the same launch.
//
// Replaces the TPU kernel
//   repro/kernels/masked_matmul/kernel.py::block_spgemm_kernel
// and computes what it computes: for each worklist entry w (sorted by
// output rank), flag bit 1 zeroes the f32 accumulator, bit 2 adds
// A[pa[w]] @ B[pb[w]], and bit 4 writes the accumulator to out[rank[w]].
// An entry with bit 2 off adds nothing (a zero-fill entry, flags 5, comes
// out as an exact zero block); an entry with all flags off neither adds
// nor writes (the distributed ring's padding).  A rank that no entry
// writes comes out as zeros.  The fused entry point replays the same
// worklist a second time over 0/1 pattern blocks into `counts`
// (repro/kernels/masked_matmul/ops.py::block_spgemm_with_structure runs
// the TPU kernel twice for that).
//
// Design.  The TPU kernel runs a sequential grid that revisits one output
// block across consecutive steps.  Here one CTA owns one (output rank,
// output sub-tile of at most 128 x 128) pair and walks that rank's segment
// of the worklist, seg_ptr[rank] .. seg_ptr[rank + 1], its accumulators in
// registers: no atomics, and the sum order is the worklist order, so
// results are deterministic.  The block product is the tile SDDMM of
// masked_matmul.cu with another address stream: its K is the concatenation
// of the segment's real pairs, bs values of k from each.  The (pair,
// k-chunk) stream is flattened into one 3-stage cp.async ring of 32-deep K
// chunks (16 B per thread, zero-filled past the block's edge), so the
// copies of the next pair's first chunks overlap the current pair's last
// products.  A producer cursor walks the segment's real entries ahead of
// the consumer; both visit the chunks in the same order, so the ring needs
// no bookkeeping beyond a count.  Results leave straight from the
// accumulator fragments (a write may come mid-segment, while the ring is
// busy); each quad of lanes stores 32 contiguous bytes of a row.
//
// Two kinds of CTA share one grid: blockIdx.y below tiles^2 computes values,
// the rest (fused launch only) counts structure.  A grid of both kinds keeps
// the values CTAs at two per SM; one CTA holding both accumulators would
// need 64 more registers per thread at 128 x 128, past the 128 that two
// CTAs per SM allow.
// - Values: 3xTF32, as the SDDMM computes them.  Each operand is split in
//   registers into hi = tf32(x) and lo = tf32(x - hi); per k-step of 8,
//   d = a_lo b_hi + a_hi b_lo + a_hi b_hi in three m16n8k8 tf32 mma from
//   zero, then added to the f32 accumulator with IEEE round-to-nearest,
//   because the mma truncates its own sums (the SDDMM, accumulating in the
//   mma, drifted to 1.8e-6 normwise on an NVIDIA H100 80GB HBM3 at 700 W).  Only a_lo b_lo (2^-22 relative) is dropped; integers below
//   2^11 have lo = 0, so integer data with partial sums below 2^24 comes
//   out exact.  This is not the single-pass TF32 the port's rules forbid.
//   A's fragments come from shared memory by ldmatrix, B's by 32-bit loads.
// - Structure: the counts are sums of 0/1 products, exact integers, so one
//   bf16 m16n8k16 pass accumulating in the mma is exact below 2^24 (0/1 is
//   exact in bf16, and an exact sum survives truncation).  The patterns
//   are bf16 blocks, half the bytes of f32: the counting CTAs are bound by
//   the bytes they stage (with f32 patterns they took clearly longer on
//   that card).  They run through a bf16 ring of the same chunks,
//   fragments by ldmatrix (B transposed), as the SDDMM's bf16 path.
// Block sizes: the CTA tile is the smallest of 16, 32, 64 and 128 that
// holds bs (sub-tiles of 128 beyond), zero-padded and masked at the edges;
// blocks whose rows are not 16 B aligned (bs % 4 != 0 for f32, bs % 8 != 0
// for bf16) are staged with element copies instead of cp.async.
//
// Bound on an H100 SXM at the main-path shape (W = 14,434 real entries,
// bs = 128): 2 * W * bs^3 = 60.5 GFLOP per replay.  An f32-accurate product
// is three TF32 passes at 495 TFLOP/s: 0.367 ms; the counting replay's one
// bf16 pass at 989 TFLOP/s adds 0.061 ms, so the fused call's bound is
// 0.428 ms.  The bytes it must move (A, B and the bf16 patterns once,
// values and counts written once: 560 MB) take 0.17 ms at 3.35 TB/s, so it
// is bound by operations.  Read naively, every pair re-reads its two blocks
// (1.9 GB per replay), which L2 has to absorb: ranks are in mask-row
// order, so the CTAs in flight share A's block rows but touch most of B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int STAGES = 3;   // cp.async ring depth

// CTA tile T x T of elements E, warps WM x WN, each warp (T / WM) x (T / WN)
template <typename E, int T, int WM, int WN>
struct Cfg {
  static constexpr int NT = WM * WN * 32;
  static constexpr int WTM = T / WM, WTN = T / WN;
  static constexpr int MI = WTM / 16, NI = WTN / 8;   // m16 / n8 tiles
  static constexpr int KC = T < 32 ? T : 32;          // K chunk per stage
  static constexpr int V = 16 / sizeof(E);            // elements per 16 B
  static constexpr int LDA = KC + V;                  // padded strides
  static constexpr int LDB = T + 8;
  static constexpr int A_ELEMS = T * LDA, B_ELEMS = KC * LDB;
  static constexpr size_t RING =
      sizeof(E) * (size_t)STAGES * (A_ELEMS + B_ELEMS);
};

// the f32 values' ring is the larger: it sets the launch's shared memory
template <int T, int WM, int WN>
constexpr size_t smem_bytes() {
  return Cfg<float, T, WM, WN>::RING;
}

template <int T, int WM, int WN>
using Acc = float[Cfg<float, T, WM, WN>::MI][Cfg<float, T, WM, WN>::NI][4];

// whether entry w adds a product that the kernel can read
__device__ __forceinline__ bool real(const int* flags, const int* pa,
                                     const int* pb, int w, int nnzb_a,
                                     int nnzb_b) {
  const int ia = pa[w], ib = pb[w];
  return (flags[w] & 2) && ia >= 0 && ia < nnzb_a && ib >= 0 && ib < nnzb_b;
}

// stage chunk k0 .. k0 + KC of the sub-tile's rows of A and columns of B
template <typename E, int T, int WM, int WN>
__device__ __forceinline__ void load_chunk(E* As, E* Bs, const E* A,
                                           const E* B, int r0, int c0,
                                           int rows, int cols, int k0,
                                           int bs, bool vec, int tid) {
  using C = Cfg<E, T, WM, WN>;
  constexpr int KC = C::KC, V = C::V;
  if (vec) {
    for (int e = tid; e < T * (KC / V); e += C::NT) {
      const int i = e / (KC / V), c = e % (KC / V);
      const int k = k0 + c * V;
      const bool in = i < rows && k < bs;
      tc::cp_async16(As + i * C::LDA + c * V,
                     in ? A + (size_t)(r0 + i) * bs + k : A, in);
    }
    for (int e = tid; e < KC * (T / V); e += C::NT) {
      const int kk = e / (T / V), c = e % (T / V);
      const int k = k0 + kk;
      const bool in = k < bs && c * V < cols;
      tc::cp_async16(Bs + kk * C::LDB + c * V,
                     in ? B + (size_t)k * bs + c0 + c * V : B, in);
    }
  } else {   // rows not 16 B aligned: plain element copies
    const E zero = E(0.0f);
    for (int e = tid; e < T * KC; e += C::NT) {
      const int i = e / KC, kk = e % KC;
      const int k = k0 + kk;
      As[i * C::LDA + kk] =
          (i < rows && k < bs) ? A[(size_t)(r0 + i) * bs + k] : zero;
    }
    for (int e = tid; e < KC * T; e += C::NT) {
      const int kk = e / T, j = e % T;
      const int k = k0 + kk;
      Bs[kk * C::LDB + j] =
          (k < bs && j < cols) ? B[(size_t)k * bs + c0 + j] : zero;
    }
  }
}

// acc += A chunk @ B chunk for this warp's fragments: values, 3xTF32
template <int T, int WM, int WN>
__device__ __forceinline__ void chunk_mma(Acc<T, WM, WN>& acc,
                                          const float* As, const float* Bs,
                                          int wm0, int wn0, int lane) {
  using C = Cfg<float, T, WM, WN>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int ks = 0; ks < C::KC; ks += 8) {
    uint32_t bhi[C::NI][2], blo[C::NI][2];
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni) {
      const float* p = Bs + (ks + t) * C::LDB + wn0 + ni * 8 + g;
      tc::split_tf32(p[0], bhi[ni][0], blo[ni][0]);
      tc::split_tf32(p[4 * C::LDB], bhi[ni][1], blo[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi) {
      // an 8x8 b16 matrix of ldmatrix is 8 rows of 4 floats, so one x4
      // load gives the m16k8 tf32 fragment: (g, t), (g+8, t), (g, t+4),
      // (g+8, t+4)
      uint32_t r[4], ahi[4], alo[4];
      tc::ldmatrix_x4(r, As + (wm0 + mi * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * C::LDA + ks +
                             (lane >> 4) * 4);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        tc::split_tf32(__uint_as_float(r[x]), ahi[x], alo[x]);
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        // the mma's own f32 sums truncate, so each k-step starts from
        // zero and is added to acc with IEEE rounding; small terms first
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        tc::mma_tf32(d, alo, bhi[ni][0], bhi[ni][1]);
        tc::mma_tf32(d, ahi, blo[ni][0], blo[ni][1]);
        tc::mma_tf32(d, ahi, bhi[ni][0], bhi[ni][1]);
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[mi][ni][x] += d[x];
      }
    }
  }
}

// acc += A chunk @ B chunk for this warp's fragments: counts, one bf16
// pass over 0/1 patterns, summed in the mma (exact integers)
template <int T, int WM, int WN>
__device__ __forceinline__ void chunk_mma(Acc<T, WM, WN>& acc,
                                          const bf16* As, const bf16* Bs,
                                          int wm0, int wn0, int lane) {
  using C = Cfg<bf16, T, WM, WN>;
#pragma unroll
  for (int ks = 0; ks < C::KC; ks += 16) {
    uint32_t bf[C::NI / 2][4];
#pragma unroll
    for (int np = 0; np < C::NI / 2; ++np)
      tc::ldmatrix_x4_trans(
          bf[np], Bs + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * C::LDB +
                      wn0 + np * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi) {
      uint32_t af[4];
      tc::ldmatrix_x4(af, As + (wm0 + mi * 16 + (lane & 15)) * C::LDA + ks +
                              (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < C::NI / 2; ++np) {
        tc::mma_bf16(acc[mi][2 * np], af, bf[np][0], bf[np][1]);
        tc::mma_bf16(acc[mi][2 * np + 1], af, bf[np][2], bf[np][3]);
      }
    }
  }
}

template <int T, int WM, int WN>
__device__ __forceinline__ void zero(Acc<T, WM, WN>& acc) {
  using C = Cfg<float, T, WM, WN>;
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mi][ni][x] = 0.0f;
}

// the accumulator fragments into the (bs, bs) output block O
template <int T, int WM, int WN>
__device__ __forceinline__ void store(const Acc<T, WM, WN>& acc, float* O,
                                      int bs, int r0, int c0, int wm0,
                                      int wn0, int lane) {
  using C = Cfg<float, T, WM, WN>;
  const int g = lane >> 2, t = lane & 3;
  const bool pairs = (bs & 1) == 0;     // float2 stores stay 8 B aligned
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + wm0 + mi * 16 + g + 8 * h;
        const int c = c0 + wn0 + ni * 8 + 2 * t;
        if (r >= bs || c >= bs) continue;
        float* dst = O + (size_t)r * bs + c;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (c + 1 < bs) dst[1] = v1;
        }
      }
}

// one CTA's replay of its rank's worklist segment w0 .. w1 over the
// operands A0, B0 (values: f32, counts: bf16 patterns) into O
template <typename E, int T, int WM, int WN>
__device__ __forceinline__ void replay(
    Acc<T, WM, WN>& acc, unsigned char* smem, const E* A0, const E* B0,
    float* O, const int* pa, const int* pb, const int* flags, int w0, int w1,
    int bs, int nnzb_a, int nnzb_b, bool vec, int r0, int c0) {
  using C = Cfg<E, T, WM, WN>;
  E* ring = reinterpret_cast<E*>(smem);
  const int rows = min(T, bs - r0), cols = min(T, bs - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / WN) * C::WTM, wn0 = (warp % WN) * C::WTN;
  const size_t bsz = (size_t)bs * bs;
  const int nk = (bs + C::KC - 1) / C::KC;      // chunks per pair
  auto As = [&](int s) { return ring + s * (C::A_ELEMS + C::B_ELEMS); };
  auto Bs = [&](int s) { return As(s) + C::A_ELEMS; };

  // producer cursor: entry lw, chunk lk, and the chunks loaded so far
  auto next_real = [&](int w) {
    while (w < w1 && !real(flags, pa, pb, w, nnzb_a, nnzb_b)) ++w;
    return w;
  };
  int lw = next_real(w0), lk = 0, loaded = 0;
  auto produce = [&]() {
    if (lw < w1) {
      load_chunk<E, T, WM, WN>(As(loaded % STAGES), Bs(loaded % STAGES),
                               A0 + (size_t)pa[lw] * bsz,
                               B0 + (size_t)pb[lw] * bsz, r0, c0, rows, cols,
                               lk * C::KC, bs, vec, tid);
      ++loaded;
      if (++lk == nk) {
        lk = 0;
        lw = next_real(lw + 1);
      }
    }
    tc::cp_async_commit();     // an empty group keeps the count in step
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) produce();

  zero<T, WM, WN>(acc);
  bool written = false;
  int used = 0;                // chunks consumed
  for (int w = w0; w < w1; ++w) {
    const int f = flags[w];    // uniform across the CTA
    if (f & 1) zero<T, WM, WN>(acc);
    if (real(flags, pa, pb, w, nnzb_a, nnzb_b)) {
      for (int kc = 0; kc < nk; ++kc, ++used) {
        tc::cp_async_wait<STAGES - 2>();   // chunk `used` has landed
        __syncthreads();                   // ... for every thread, and
        produce();                         // chunk used - 1 is consumed
        chunk_mma<T, WM, WN>(acc, As(used % STAGES), Bs(used % STAGES),
                             wm0, wn0, lane);
      }
    }
    if (f & 4) {
      store<T, WM, WN>(acc, O, bs, r0, c0, wm0, wn0, lane);
      written = true;
    }
  }
  tc::cp_async_wait<0>();
  if (!written) {              // a rank no entry writes comes out as zeros
    zero<T, WM, WN>(acc);
    store<T, WM, WN>(acc, O, bs, r0, c0, wm0, wn0, lane);
  }
}

// blockIdx.x: output rank; blockIdx.y: sub-tile, values CTAs first, then
// (counts != nullptr) the counting CTAs.  vec: bit 0, the f32 operands'
// rows are 16 B aligned; bit 1, the bf16 patterns' rows are.
template <int T, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32, 2)
block_spgemm_tc_kernel(const float* __restrict__ a,
                       const float* __restrict__ b,
                       const bf16* __restrict__ a_pat,
                       const bf16* __restrict__ b_pat,
                       const int* __restrict__ pa, const int* __restrict__ pb,
                       const int* __restrict__ flags,
                       const int* __restrict__ seg_ptr,
                       float* __restrict__ out, float* __restrict__ counts,
                       int bs, int nnzb_a, int nnzb_b, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = blockIdx.x;
  const int tiles = (bs + T - 1) / T;
  const bool count = blockIdx.y >= tiles * tiles;   // uniform per CTA
  const int sub = blockIdx.y - (count ? tiles * tiles : 0);
  const int r0 = (sub / tiles) * T, c0 = (sub % tiles) * T;
  const int w0 = seg_ptr[rank], w1 = seg_ptr[rank + 1];
  const size_t o = (size_t)rank * bs * bs;
  float acc[Cfg<float, T, WM, WN>::MI][Cfg<float, T, WM, WN>::NI][4];
  if (count)
    replay<bf16, T, WM, WN>(acc, smem, a_pat, b_pat, counts + o, pa, pb,
                            flags, w0, w1, bs, nnzb_a, nnzb_b, vec & 2, r0,
                            c0);
  else
    replay<float, T, WM, WN>(acc, smem, a, b, out + o, pa, pb, flags, w0,
                             w1, bs, nnzb_a, nnzb_b, vec & 1, r0, c0);
}

struct Args {
  const float *a, *b;
  const bf16 *a_pat, *b_pat;
  const int *pa, *pb, *flags, *seg_ptr;
  float *out, *counts;
  int nnzb_out, bs, nnzb_a, nnzb_b;
  cudaStream_t stream;
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int T, int WM, int WN>
cudaError_t launch(const Args& x) {
  constexpr size_t SMEM = smem_bytes<T, WM, WN>();
  auto* fn = block_spgemm_tc_kernel<T, WM, WN>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  const int vec =
      (aligned16(x.a) && aligned16(x.b) && x.bs % 4 == 0 ? 1 : 0) |
      (aligned16(x.a_pat) && aligned16(x.b_pat) && x.bs % 8 == 0 ? 2 : 0);
  const int tiles = (x.bs + T - 1) / T;
  const int kinds = x.counts ? 2 : 1;
  fn<<<dim3(x.nnzb_out, kinds * tiles * tiles), Cfg<float, T, WM, WN>::NT,
       SMEM, x.stream>>>(x.a, x.b, x.a_pat, x.b_pat, x.pa, x.pb, x.flags,
                         x.seg_ptr, x.out, x.counts, x.bs, x.nnzb_a,
                         x.nnzb_b, vec);
  return cudaGetLastError();
}

// CTA shape, dynamic shared memory, registers, local memory per thread and
// resident CTAs per SM on the current device
template <int T, int WM, int WN>
cudaError_t info(int* out) {
  constexpr size_t SMEM = smem_bytes<T, WM, WN>();
  constexpr int NT = Cfg<float, T, WM, WN>::NT;
  auto* fn = block_spgemm_tc_kernel<T, WM, WN>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, NT, SMEM);
  out[0] = NT;
  out[1] = (int)SMEM;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = ctas;
  return err;
}

// the CTA tile for block size bs: the smallest of 16, 32, 64, 128 that
// holds it, sub-tiles of 128 beyond
cudaError_t dispatch(const Args& x, int* out_info) {
  if (x.bs <= 16)
    return out_info ? info<16, 1, 1>(out_info) : launch<16, 1, 1>(x);
  if (x.bs <= 32)
    return out_info ? info<32, 2, 1>(out_info) : launch<32, 2, 1>(x);
  if (x.bs <= 64)
    return out_info ? info<64, 2, 2>(out_info) : launch<64, 2, 2>(x);
  return out_info ? info<128, 2, 4>(out_info) : launch<128, 2, 4>(x);
}

}  // namespace

// C interface (bound with ctypes).  Pointers are device pointers of
// contiguous tensors: a (nnzb_a, bs, bs) f32, b (nnzb_b, bs, bs) f32,
// pa/pb/flags (W,) int32, seg_ptr (nnzb_out + 1,) int32 segment offsets of
// the rank-sorted worklist, out (nnzb_out, bs, bs) f32, every block of
// which the kernel writes.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int block_spgemm_f32(const float* a, const float* b,
                                const int* pa, const int* pb,
                                const int* flags, const int* seg_ptr,
                                float* out, int nnzb_out, int bs, int nnzb_a,
                                int nnzb_b, void* stream) {
  if (nnzb_out <= 0) return 0;
  return dispatch({a, b, nullptr, nullptr, pa, pb, flags, seg_ptr, out,
                   nullptr, nnzb_out, bs, nnzb_a, nnzb_b,
                   static_cast<cudaStream_t>(stream)},
                  nullptr);
}

// The values and the structural counts in one launch: as block_spgemm_f32,
// plus a_pat (nnzb_a, bs, bs) and b_pat (nnzb_b, bs, bs) bf16 0/1 patterns
// of the operands' stored entries, and counts (nnzb_out, bs, bs) f32, which
// receives the same replay over the patterns.
extern "C" int block_spgemm_with_structure(
    const float* a, const float* b, const void* a_pat, const void* b_pat,
    const int* pa, const int* pb, const int* flags, const int* seg_ptr,
    float* out, float* counts, int nnzb_out, int bs, int nnzb_a, int nnzb_b,
    void* stream) {
  if (nnzb_out <= 0) return 0;
  return dispatch({a, b, static_cast<const bf16*>(a_pat),
                   static_cast<const bf16*>(b_pat), pa, pb, flags, seg_ptr,
                   out, counts, nnzb_out, bs, nnzb_a, nnzb_b,
                   static_cast<cudaStream_t>(stream)},
                  nullptr);
}

// The kernel instance both entry points run for block size bs: info
// receives threads per CTA, dynamic shared memory bytes, registers per
// thread, local (spill) bytes per thread and resident CTAs per SM on the
// current device.  Returns a cudaError_t.
extern "C" int block_spgemm_info(int bs, int* info) {
  Args x{};
  x.bs = bs;
  return dispatch(x, info);
}
