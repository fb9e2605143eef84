// Tile SDDMM: only the mask-allowed output tiles of A @ B are computed.
//
// Replaces the TPU kernel
//   repro/kernels/masked_matmul/kernel.py::masked_matmul_kernel
// and computes what it computes: for every mask tile r,
//   out[r] = A[bi[r]*bm : (bi[r]+1)*bm, :] @ B[:, bj[r]*bn : (bj[r]+1)*bn]
// in f32, from f32 or bf16 operands.  Tiles the mask does not allow are
// never scheduled.
//
// Design.  The TPU kernel carries its accumulator across a sequential K
// grid dimension that revisits one output tile.  Here one CTA owns one
// (mask tile r, output sub-tile) pair and loops over the whole K extent
// itself, with the accumulator in registers: no atomics, and the sum order
// is ascending k, so results are deterministic.  Each K chunk of the A rows
// and B columns of the sub-tile is staged through shared memory (converted
// to f32 on the way in); every thread keeps R x R outputs and adds with
// IEEE fmaf (no TF32: on integer data the result is exact).  Tiles below a
// sub-tile (bm, bn of 8 or 16) run with as many threads as outputs; sizes
// that do not divide the sub-tile are guarded.  A mask tile whose block
// coordinates fall outside A or B comes out as zeros instead of faulting.
//
// Bound on an H100 SXM at the path's shape (M = N = 8192, K = 256,
// bm = bn = 128, nnzb = 2,432 tiles of the tile-8192 mask):
// 2 * nnzb * bm * bn * K = 20.4 GFLOP against 67 TFLOP/s of f32 on CUDA
// cores is 0.30 ms; the bytes it must move (A and B once, 159 MB of
// output) take about 0.05 ms at 3.35 TB/s, so it is bound by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int TILE, int R>
__global__ void masked_matmul_kernel(const T* __restrict__ a,
                                     const T* __restrict__ b,
                                     const int* __restrict__ bi,
                                     const int* __restrict__ bj,
                                     float* __restrict__ out, int M, int K,
                                     int N, int bm, int bn) {
  constexpr int S = TILE / R;              // threads per tile edge
  constexpr int NT = S * S;                // threads per CTA
  constexpr int KC = TILE < 16 ? TILE : 16;  // K chunk staged per step
  __shared__ float As[KC][TILE + 1];       // As[k][row], padded vs conflicts
  __shared__ float Bs[KC][TILE];           // Bs[k][col]

  const int r = blockIdx.x;
  const int tiles_n = (bn + TILE - 1) / TILE;
  const int r0 = (blockIdx.y / tiles_n) * TILE;   // sub-tile origin in the
  const int c0 = (blockIdx.y % tiles_n) * TILE;   // (bm, bn) output tile
  const int tid = threadIdx.x;
  const int ty = tid / S;
  const int tx = tid % S;
  const int ib = bi[r];
  const int jb = bj[r];
  const bool inside = ib >= 0 && (size_t)(ib + 1) * bm <= (size_t)M &&
                      jb >= 0 && (size_t)(jb + 1) * bn <= (size_t)N;
  const size_t row0 = (size_t)ib * bm + r0;        // first A row
  const size_t col0 = (size_t)jb * bn + c0;        // first B column

  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.0f;

  if (inside) {                            // uniform across the CTA
    for (int k0 = 0; k0 < K; k0 += KC) {
      for (int e = tid; e < KC * TILE; e += NT) {
        // A: consecutive threads read consecutive k of one row
        const int kk = e % KC, ii = e / KC;
        const int k = k0 + kk;
        As[kk][ii] = (r0 + ii < bm && k < K)
                         ? to_f32(a[(row0 + ii) * K + k]) : 0.0f;
        // B: consecutive threads read consecutive columns of one k
        const int jj = e % TILE, kb = e / TILE;
        const int k2 = k0 + kb;
        Bs[kb][jj] = (c0 + jj < bn && k2 < K)
                         ? to_f32(b[(size_t)k2 * N + col0 + jj]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        float av[R], bv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) av[i] = As[kk][ty + S * i];
#pragma unroll
        for (int j = 0; j < R; ++j) bv[j] = Bs[kk][tx + S * j];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* O = out + (size_t)r * bm * bn;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int rr = r0 + ty + S * i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int cc = c0 + tx + S * j;
      if (rr < bm && cc < bn) O[(size_t)rr * bn + cc] = acc[i][j];
    }
  }
}

template <typename T, int TILE, int R>
cudaError_t launch(const void* a, const void* b, const int* bi, const int* bj,
                   float* out, int nnzb, int M, int K, int N, int bm, int bn,
                   cudaStream_t stream) {
  const int tiles = ((bm + TILE - 1) / TILE) * ((bn + TILE - 1) / TILE);
  dim3 grid(nnzb, tiles);
  dim3 block((TILE / R) * (TILE / R));
  masked_matmul_kernel<T, TILE, R><<<grid, block, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), bi, bj, out, M, K,
      N, bm, bn);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* a, const void* b, const int* bi,
                     const int* bj, float* out, int nnzb, int M, int K, int N,
                     int bm, int bn, cudaStream_t s) {
  const int big = bm > bn ? bm : bn;
  if (big <= 8)
    return launch<T, 8, 1>(a, b, bi, bj, out, nnzb, M, K, N, bm, bn, s);
  if (big <= 16)
    return launch<T, 16, 1>(a, b, bi, bj, out, nnzb, M, K, N, bm, bn, s);
  if (big <= 32)
    return launch<T, 32, 2>(a, b, bi, bj, out, nnzb, M, K, N, bm, bn, s);
  return launch<T, 64, 4>(a, b, bi, bj, out, nnzb, M, K, N, bm, bn, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(a, b, bi, bj, out, nnzb, M, K, N, bm, bn, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(a, b, bi, bj, out, nnzb, M, K, N, bm, bn,
                                   s);
  return cudaErrorInvalidValue;
}
