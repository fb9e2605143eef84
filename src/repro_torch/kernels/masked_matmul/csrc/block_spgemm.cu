// Masked BCSR x BCSR block product replaying a rank-sorted worklist.
//
// Replaces the TPU kernel
//   repro/kernels/masked_matmul/kernel.py::block_spgemm_kernel
// and computes what it computes: for each worklist entry w (sorted by
// output rank), flag bit 1 zeroes the f32 accumulator, bit 2 adds
// A[pa[w]] @ B[pb[w]], and bit 4 writes the accumulator to out[rank[w]].
// An entry with bit 2 off adds nothing (a zero-fill entry, flags 5, comes
// out as an exact zero block); an entry with all flags off neither adds
// nor writes (the distributed ring's padding).
//
// Design.  The TPU kernel runs a sequential grid that revisits one output
// block across consecutive steps.  Here one CTA owns one (output rank,
// output sub-tile) pair and walks that rank's segment of the worklist,
// seg_ptr[rank] .. seg_ptr[rank + 1], with the accumulator in registers:
// no atomics, and the sum order is the worklist order, so results are
// deterministic.  Each K chunk of the A rows and B columns of the sub-tile
// is staged through shared memory; every thread keeps R x R outputs and
// adds with IEEE fmaf (no TF32: the tile route must stay bitwise equal to
// the row kernels on integer data).  Block sizes below a tile (4, 8) run
// with as many threads as outputs; sizes that do not divide the tile are
// guarded.
//
// Bound on an H100 SXM at the main-path shape (W = 14,434 real entries,
// bs = 128): 2 * W * bs^3 = 60.5 GFLOP per replay.  The least time of an
// f32-accurate product is three TF32 passes at 495 TFLOP/s (3xTF32, as the
// tile SDDMM computes it): 0.367 ms; on f32 CUDA cores, the units this
// kernel uses, 0.90 ms at 67 TFLOP/s.  The bytes it must move (A and B
// blocks once, 159 MB of output) take about 0.1 ms at 3.35 TB/s, so it is
// bound by operations.  Read naively, every pair re-reads its two blocks
// (>= 1.9 GB), which L2 and the shared-memory staging are there to absorb.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int TILE, int R>
__global__ void block_spgemm_kernel(const float* __restrict__ a,
                                    const float* __restrict__ b,
                                    const int* __restrict__ pa,
                                    const int* __restrict__ pb,
                                    const int* __restrict__ flags,
                                    const int* __restrict__ seg_ptr,
                                    float* __restrict__ out,
                                    int bs, int nnzb_a, int nnzb_b) {
  constexpr int S = TILE / R;              // threads per tile edge
  constexpr int NT = S * S;                // threads per CTA
  constexpr int KC = TILE < 16 ? TILE : 16;  // K chunk staged per step
  __shared__ float As[KC][TILE + 1];       // As[k][row], padded vs conflicts
  __shared__ float Bs[KC][TILE];           // Bs[k][col]

  const int rank = blockIdx.x;
  const int tiles = (bs + TILE - 1) / TILE;
  const int r0 = (blockIdx.y / tiles) * TILE;
  const int c0 = (blockIdx.y % tiles) * TILE;
  const int tid = threadIdx.x;
  const int ty = tid / S;
  const int tx = tid % S;
  const size_t bsz = (size_t)bs * bs;

  float acc[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.0f;

  const int w_end = seg_ptr[rank + 1];
  for (int w = seg_ptr[rank]; w < w_end; ++w) {
    const int f = flags[w];                // uniform across the CTA
    if (f & 1) {
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[i][j] = 0.0f;
    }
    const int ia = pa[w];
    const int ib = pb[w];
    if ((f & 2) && ia >= 0 && ia < nnzb_a && ib >= 0 && ib < nnzb_b) {
      const float* A = a + (size_t)ia * bsz;
      const float* B = b + (size_t)ib * bsz;
      for (int k0 = 0; k0 < bs; k0 += KC) {
        for (int e = tid; e < KC * TILE; e += NT) {
          // A: consecutive threads read consecutive k of one row
          const int kk = e % KC, ii = e / KC;
          const int r = r0 + ii, k = k0 + kk;
          As[kk][ii] = (r < bs && k < bs) ? A[(size_t)r * bs + k] : 0.0f;
          // B: consecutive threads read consecutive columns of one k
          const int jj = e % TILE, kb = e / TILE;
          const int c = c0 + jj, k2 = k0 + kb;
          Bs[kb][jj] = (c < bs && k2 < bs) ? B[(size_t)k2 * bs + c] : 0.0f;
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
    if (f & 4) {
      float* O = out + (size_t)rank * bsz;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = r0 + ty + S * i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int c = c0 + tx + S * j;
          if (r < bs && c < bs) O[(size_t)r * bs + c] = acc[i][j];
        }
      }
    }
  }
}

template <int TILE, int R>
cudaError_t launch(const float* a, const float* b, const int* pa,
                   const int* pb, const int* flags, const int* seg_ptr,
                   float* out, int nnzb_out, int bs, int nnzb_a, int nnzb_b,
                   cudaStream_t stream) {
  const int tiles = (bs + TILE - 1) / TILE;
  dim3 grid(nnzb_out, tiles * tiles);
  dim3 block((TILE / R) * (TILE / R));
  block_spgemm_kernel<TILE, R><<<grid, block, 0, stream>>>(
      a, b, pa, pb, flags, seg_ptr, out, bs, nnzb_a, nnzb_b);
  return cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes).  Pointers are device pointers of
// contiguous tensors: a (nnzb_a, bs, bs) f32, b (nnzb_b, bs, bs) f32,
// pa/pb/flags (W,) int32, seg_ptr (nnzb_out + 1,) int32 segment offsets of
// the rank-sorted worklist, out (nnzb_out, bs, bs) f32 zero-initialised.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int block_spgemm_f32(const float* a, const float* b,
                                const int* pa, const int* pb,
                                const int* flags, const int* seg_ptr,
                                float* out, int nnzb_out, int bs, int nnzb_a,
                                int nnzb_b, void* stream) {
  if (nnzb_out <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bs <= 4)
    return launch<4, 1>(a, b, pa, pb, flags, seg_ptr, out, nnzb_out, bs,
                        nnzb_a, nnzb_b, s);
  if (bs <= 8)
    return launch<8, 1>(a, b, pa, pb, flags, seg_ptr, out, nnzb_out, bs,
                        nnzb_a, nnzb_b, s);
  if (bs <= 16)
    return launch<16, 1>(a, b, pa, pb, flags, seg_ptr, out, nnzb_out, bs,
                         nnzb_a, nnzb_b, s);
  if (bs <= 32)
    return launch<32, 2>(a, b, pa, pb, flags, seg_ptr, out, nnzb_out, bs,
                         nnzb_a, nnzb_b, s);
  return launch<64, 4>(a, b, pa, pb, flags, seg_ptr, out, nnzb_out, bs,
                       nnzb_a, nnzb_b, s);
}
