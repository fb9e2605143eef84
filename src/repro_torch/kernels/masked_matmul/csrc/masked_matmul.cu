// Tile SDDMM on tensor cores: only the mask-allowed output tiles of A @ B
// are computed.
//
// Replaces the TPU kernel
//   repro/kernels/masked_matmul/kernel.py::masked_matmul_kernel
// and computes what it computes: for every mask tile r,
//   out[r] = A[bi[r]*bm : (bi[r]+1)*bm, :] @ B[:, bj[r]*bn : (bj[r]+1)*bn]
// in f32, from f32 or bf16 operands.  Tiles the mask does not allow are
// never scheduled; a tile whose block coordinates fall outside A or B comes
// out as zeros.
//
// Since masked_matmul_sm90.cu (TMA + wgmma) took 128 x 128 blocks with f32
// or bf16 operands, contiguous, 16-byte aligned, with rows of a multiple of
// 16 bytes (kernel.py's masked_matmul_sm90_takes: sddmm-8192, the path's
// shape), this kernel runs every other shape (blocks of 8 to 64, 256,
// unequal bm and bn, rows not 16-byte multiples) and what variant=
// "mma_sync" asks for.
//
// Design.  The TPU kernel carries its accumulator across a sequential K
// grid dimension.  Here one CTA owns one (mask tile r, output sub-tile of
// at most 128 x 128) pair and loops over all of K itself, the accumulators
// in registers: no atomics, one sum order, deterministic results.  A's row
// panel and B's column panel stream through shared memory in K chunks of
// 32, in their input dtype, through a 3-stage cp.async ring (16 B per
// thread, zero-filled past the tile's edge), so the next two chunks' copies
// overlap the current chunk's products.  The warps split the sub-tile (8
// warps of 64 x 32 at 128) and run mma.sync from fragments read out of
// shared memory (padded rows: no bank conflicts):
// - bf16 operands: one m16n8k16 bf16 mma per fragment; products are exact
//   and sums f32, as in the reference.
// - f32 operands: 3xTF32.  Each operand is split in registers into
//   hi = tf32(x) and lo = tf32(x - hi) (round to nearest), and
//   d = a_lo b_hi + a_hi b_lo + a_hi b_hi with three m16n8k8 tf32 mma per
//   k-step of 8.  Only a_lo b_lo (2^-22 relative) is dropped.  The mma
//   truncates its f32 sums instead of rounding them: 96 mma into one
//   accumulator over K = 256 drifted to 1.8e-6 normwise on an NVIDIA
//   H100 80GB HBM3 at 700 W.  So
//   each k-step's d starts from zero and is added to the accumulator with
//   IEEE round-to-nearest, which keeps f32 accuracy: 1.4e-7 normwise from
//   f64 at K = 256 on that card (chip_smoke.py), 3.2e-7 from the IEEE f32
//   bmm; one TF32 pass misses the 2e-6 limit by over 10x
//   (tests/test_torch_tc_numerics.py).  Integers below 2^11 have lo = 0
//   and stay exact.  This is not the single-pass TF32 that the port's
//   rules forbid.
// The tile leaves through shared memory in coalesced 16 B stores.
//
// Bound on an H100 SXM at the path's shape (M = N = 8192, K = 256,
// bm = bn = 128, nnzb = 2,432 tiles of the tile-8192 mask):
// 2 * nnzb * bm * bn * K = 20.4 GFLOP.  An f32-accurate product costs three
// TF32 passes at 495 TFLOP/s: 0.124 ms (0.30 ms at 67 TFLOP/s of f32 on
// CUDA cores, where the previous design ran at 28 %); the bytes it must
// move (A and B once, 159 MB of output) take 0.053 ms at 3.35 TB/s, so it
// is bound by operations.  What holds it back: each k-step issues, beside
// its 48 mma per warp, about 200 other instructions (fragment loads, the
// hi/lo splits, the IEEE adds of the flush), so the warps are bound by
// issue and latency rather than by the tensor cores; K = 256 is only 8
// chunks, so each CTA's ring fills and drains once per tile; and 128
// registers per thread (two CTAs per SM) spill a little.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int KC = 32;      // K chunk per ring stage
constexpr int STAGES = 3;   // cp.async ring depth

// CTA tile T x T, warps WM x WN, each warp (T / WM) x (T / WN)
template <typename E, int T, int WM, int WN>
struct Cfg {
  static constexpr int NT = WM * WN * 32;
  static constexpr int WTM = T / WM, WTN = T / WN;
  static constexpr int MI = WTM / 16, NI = WTN / 8;   // m16 / n8 tiles
  static constexpr int V = 16 / sizeof(E);            // elements per 16 B
  static constexpr int LDA = KC + V;                  // padded strides
  static constexpr int LDB = T + 8;
  static constexpr int LDC = T + 4;
  static constexpr int A_ELEMS = T * LDA, B_ELEMS = KC * LDB;
  static constexpr size_t RING =
      sizeof(E) * (size_t)STAGES * (A_ELEMS + B_ELEMS);
  static constexpr size_t OUT = sizeof(float) * (size_t)T * LDC;
  static constexpr size_t SMEM = RING > OUT ? RING : OUT;
};

// stage one K chunk of A's rows and B's columns of the sub-tile
template <typename E, int T, int WM, int WN>
__device__ __forceinline__ void load_chunk(E* As, E* Bs, const E* a,
                                           const E* b, size_t row0,
                                           size_t col0, int rows, int cols,
                                           int k0, int K, int N, bool vec,
                                           int tid) {
  using C = Cfg<E, T, WM, WN>;
  constexpr int V = C::V;
  if (vec) {
    for (int e = tid; e < T * (KC / V); e += C::NT) {
      const int i = e / (KC / V), c = e % (KC / V);
      const int k = k0 + c * V;
      const bool in = i < rows && k < K;
      tc::cp_async16(As + i * C::LDA + c * V,
                     in ? a + (row0 + i) * K + k : a, in);
    }
    for (int e = tid; e < KC * (T / V); e += C::NT) {
      const int kk = e / (T / V), c = e % (T / V);
      const int k = k0 + kk;
      const bool in = k < K && c * V < cols;
      tc::cp_async16(Bs + kk * C::LDB + c * V,
                     in ? b + (size_t)k * N + col0 + c * V : b, in);
    }
  } else {   // rows or columns not 16 B aligned: plain element copies
    const E zero = E(0.0f);
    for (int e = tid; e < T * KC; e += C::NT) {
      const int i = e / KC, kk = e % KC;
      const int k = k0 + kk;
      As[i * C::LDA + kk] = (i < rows && k < K) ? a[(row0 + i) * K + k]
                                                : zero;
    }
    for (int e = tid; e < KC * T; e += C::NT) {
      const int kk = e / T, j = e % T;
      const int k = k0 + kk;
      Bs[kk * C::LDB + j] = (k < K && j < cols) ? b[(size_t)k * N + col0 + j]
                                                : zero;
    }
  }
}

// acc += A chunk @ B chunk for this warp's fragments: 3xTF32 for f32
template <int T, int WM, int WN>
__device__ __forceinline__ void chunk_mma(
    float (&acc)[Cfg<float, T, WM, WN>::MI][Cfg<float, T, WM, WN>::NI][4],
    const float* As, const float* Bs, int wm0, int wn0, int lane) {
  using C = Cfg<float, T, WM, WN>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1   // unrolled, the k-steps spilled more and ran slower
  for (int ks = 0; ks < KC; ks += 8) {
    uint32_t bhi[C::NI][2], blo[C::NI][2];
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni) {
      const float* p = Bs + (ks + t) * C::LDB + wn0 + ni * 8 + g;
      tc::split_tf32(p[0], bhi[ni][0], blo[ni][0]);
      tc::split_tf32(p[4 * C::LDB], bhi[ni][1], blo[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < C::MI; ++mi) {
      const float* p = As + (wm0 + mi * 16 + g) * C::LDA + ks + t;
      uint32_t ahi[4], alo[4];
      tc::split_tf32(p[0], ahi[0], alo[0]);
      tc::split_tf32(p[8 * C::LDA], ahi[1], alo[1]);
      tc::split_tf32(p[4], ahi[2], alo[2]);
      tc::split_tf32(p[8 * C::LDA + 4], ahi[3], alo[3]);
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

// acc += A chunk @ B chunk for this warp's fragments: one bf16 pass
template <int T, int WM, int WN>
__device__ __forceinline__ void chunk_mma(
    float (&acc)[Cfg<bf16, T, WM, WN>::MI][Cfg<bf16, T, WM, WN>::NI][4],
    const bf16* As, const bf16* Bs, int wm0, int wn0, int lane) {
  using C = Cfg<bf16, T, WM, WN>;
#pragma unroll
  for (int ks = 0; ks < KC; ks += 16) {
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

template <typename E, int T, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32, 2)
masked_matmul_tc_kernel(const E* __restrict__ a, const E* __restrict__ b,
                        const int* __restrict__ bi,
                        const int* __restrict__ bj, float* __restrict__ out,
                        int M, int K, int N, int bm, int bn, int vec) {
  using C = Cfg<E, T, WM, WN>;
  extern __shared__ __align__(16) unsigned char smem[];
  E* ring = reinterpret_cast<E*>(smem);

  const int r = blockIdx.x;
  const int tiles_n = (bn + T - 1) / T;
  const int r0 = (blockIdx.y / tiles_n) * T;   // sub-tile origin in the
  const int c0 = (blockIdx.y % tiles_n) * T;   // (bm, bn) output tile
  const int rows = min(T, bm - r0), cols = min(T, bn - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / WN) * C::WTM, wn0 = (warp % WN) * C::WTN;
  const int ib = bi[r], jb = bj[r];
  const bool inside = ib >= 0 && (size_t)(ib + 1) * bm <= (size_t)M &&
                      jb >= 0 && (size_t)(jb + 1) * bn <= (size_t)N;
  const size_t row0 = (size_t)ib * bm + r0;     // first A row
  const size_t col0 = (size_t)jb * bn + c0;     // first B column

  float acc[C::MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mi][ni][x] = 0.0f;

  if (inside) {                                 // uniform across the CTA
    const int nk = (K + KC - 1) / KC;
    auto As = [&](int s) { return ring + s * (C::A_ELEMS + C::B_ELEMS); };
    auto Bs = [&](int s) { return As(s) + C::A_ELEMS; };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk)
        load_chunk<E, T, WM, WN>(As(s), Bs(s), a, b, row0, col0, rows, cols,
                                 s * KC, K, N, vec, tid);
      tc::cp_async_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {
      tc::cp_async_wait<STAGES - 2>();          // chunk kc has landed
      __syncthreads();                          // ... for every thread, and
      const int nxt = kc + STAGES - 1;          // chunk kc - 1 is consumed
      if (nxt < nk)
        load_chunk<E, T, WM, WN>(As(nxt % STAGES), Bs(nxt % STAGES), a, b,
                                 row0, col0, rows, cols, nxt * KC, K, N, vec,
                                 tid);
      tc::cp_async_commit();
      chunk_mma<T, WM, WN>(acc, As(kc % STAGES), Bs(kc % STAGES), wm0, wn0,
                           lane);
    }
    tc::cp_async_wait<0>();
  }
  __syncthreads();                              // the ring is free

  // stage the tile in shared memory, then 16 B stores of whole rows
  float* Cs = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni) {
      float* p = Cs + (wm0 + mi * 16 + g) * C::LDC + wn0 + ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(p) =
          make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(p + 8 * C::LDC) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  __syncthreads();
  float* O = out + (size_t)r * bm * bn + (size_t)r0 * bn + c0;
  const bool vec_out = (bn & 3) == 0;
  for (int e = tid; e < T * (T / 4); e += C::NT) {
    const int i = e / (T / 4), j = (e % (T / 4)) * 4;
    if (i >= rows || j >= cols) continue;
    const float4 v = *reinterpret_cast<const float4*>(Cs + i * C::LDC + j);
    float* dst = O + (size_t)i * bn + j;
    if (vec_out) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
      for (int x = 0; x < 4 && j + x < cols; ++x) dst[x] = vs[x];
    }
  }
}

struct Args {
  const void *a, *b;
  const int *bi, *bj;
  float* out;
  int nnzb, M, K, N, bm, bn;
  cudaStream_t stream;
};

template <typename E, int T, int WM, int WN>
cudaError_t launch(const Args& x) {
  using C = Cfg<E, T, WM, WN>;
  auto* fn = masked_matmul_tc_kernel<E, T, WM, WN>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  constexpr int V = C::V;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x.a) |
                         reinterpret_cast<uintptr_t>(x.b)) & 15) == 0;
  const int vec = aligned && x.K % V == 0 && x.bn % V == 0 && x.N % V == 0;
  const int tiles = ((x.bm + T - 1) / T) * ((x.bn + T - 1) / T);
  fn<<<dim3(x.nnzb, tiles), C::NT, C::SMEM, x.stream>>>(
      static_cast<const E*>(x.a), static_cast<const E*>(x.b), x.bi, x.bj,
      x.out, x.M, x.K, x.N, x.bm, x.bn, vec);
  return cudaGetLastError();
}

// CTA shape, dynamic shared memory, registers, local memory per thread and
// resident CTAs per SM on the current device
template <typename E, int T, int WM, int WN>
cudaError_t info(int* out) {
  using C = Cfg<E, T, WM, WN>;
  auto* fn = masked_matmul_tc_kernel<E, T, WM, WN>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, C::NT,
                                                      C::SMEM);
  out[0] = C::NT;
  out[1] = (int)C::SMEM;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  out[4] = ctas;
  return err;
}

// the CTA tile for blocks (bm, bn): the smallest of 16, 32, 64, 128 that
// holds max(bm, bn), sub-tiles of 128 beyond
template <typename E>
cudaError_t dispatch(const Args& x, int* out_info) {
  const int big = x.bm > x.bn ? x.bm : x.bn;
  if (big <= 16)
    return out_info ? info<E, 16, 1, 1>(out_info) : launch<E, 16, 1, 1>(x);
  if (big <= 32)
    return out_info ? info<E, 32, 2, 1>(out_info) : launch<E, 32, 2, 1>(x);
  if (big <= 64)
    return out_info ? info<E, 64, 2, 2>(out_info) : launch<E, 64, 2, 2>(x);
  return out_info ? info<E, 128, 2, 4>(out_info) : launch<E, 128, 2, 4>(x);
}

cudaError_t by_dtype(const Args& x, int dtype, int* out_info) {
  if (dtype == 0) return dispatch<float>(x, out_info);
  if (dtype == 1) return dispatch<bf16>(x, out_info);
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes).  Pointers are device pointers of
// contiguous tensors: a (M, K) and b (K, N), both f32 (dtype 0) or both
// bf16 (dtype 1); bi, bj (nnzb,) int32 mask tile coordinates; out
// (nnzb, bm, bn) f32.  Returns the cudaError_t of the launch (0 on
// success); an unknown dtype returns cudaErrorInvalidValue.
extern "C" int masked_matmul(const void* a, const void* b, const int* bi,
                             const int* bj, float* out, int nnzb, int M,
                             int K, int N, int bm, int bn, int dtype,
                             void* stream) {
  if (nnzb <= 0) return 0;
  return by_dtype({a, b, bi, bj, out, nnzb, M, K, N, bm, bn,
                   static_cast<cudaStream_t>(stream)},
                  dtype, nullptr);
}

// The kernel that masked_matmul runs for blocks (bm, bn) and dtype: info
// receives threads per CTA, dynamic shared memory bytes, registers per
// thread, local (spill) bytes per thread and resident CTAs per SM on the
// current device.  Returns a cudaError_t.
extern "C" int masked_matmul_info(int bm, int bn, int dtype, int* info) {
  return by_dtype({nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0,
                   bm, bn, nullptr},
                  dtype, info);
}
