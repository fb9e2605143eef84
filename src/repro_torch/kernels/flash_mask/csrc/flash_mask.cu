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
// leaves alpha = exp(m_prev - m_new) = 1 and no NaN.  p.v runs in f32 with
// v upcast.  Flag bit 1 resets the running max m, normaliser l and
// accumulator; bit 2 writes acc / l (rows with l == 0 come out as 0) in the
// input dtype.
//
// Design.  The TPU kernel keeps m, l and acc in VMEM across consecutive
// grid steps of one q-block.  Here one CTA of 256 threads owns one
// (q-block, batch * head) pair and walks that q-block's contiguous segment
// seg_ptr[qb] .. seg_ptr[qb + 1] of the worklist: no atomics, one sum
// order, deterministic results.  The q tile stays in shared memory (as
// f32); each step stages the k tile, computes the scores into registers
// (a 16 x 16 thread grid, RQ x RK scores per thread, IEEE fmaf, no TF32),
// stores them masked to shared memory, lets each warp take rows for the
// online softmax while the v tile is staged into the buffer k used, and
// then adds p.v into an accumulator held in registers (RQ x RD per thread).
// Tiles are chosen per call from {16, 32, 64, 128} for max(bq, bk) and
// {16, 64, 128} for D; smaller sizes are guarded.
//
// Bound on an H100 SXM at the full-width llama3.2-1b layer (B = 4,
// Hq = 32, Hkv = 8, S = 2048, D = 64, bq = bk = 128, causal: 136 pairs per
// (batch, head)): 4 * 128 * 136 * 128 * 128 * 64 = 73 GFLOP per launch,
// 0.074 ms at 989 TFLOP/s on bf16 tensor cores (1.09 ms at 67 TFLOP/s of
// f32 on CUDA cores, the units this kernel uses); q, k, v read once and
// the output written once are 84 MB, 0.025 ms at 3.35 TB/s.  It is bound
// by operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TS = 16;          // thread grid edge
constexpr int NT = TS * TS;     // threads per CTA

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the parametric element mask of kernel.py:55-60 (no prefix-LM rule)
__device__ __forceinline__ bool allowed(int qg, int kg, int causal,
                                        int window, int prefix) {
  bool ok = true;
  if (causal) ok = ok && kg <= qg;
  if (window > 0) ok = ok && ((qg - kg) < window || kg < prefix);
  return ok;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int RQ, int RD>
constexpr size_t smem_bytes() {
  // Qs [BQ][DM + 1], KVs [BK][DM + 1], Ss [BQ][BK + 1], m, l, alpha [BQ];
  // BK == BQ == TS * RQ, DM == TS * RD
  return sizeof(float) * ((size_t)TS * RQ * (TS * RD + 1) * 2 +
                          (size_t)TS * RQ * (TS * RQ + 1) + 3 * TS * RQ);
}

template <typename T, int RQ, int RD>
__global__ void __launch_bounds__(NT)
flash_mask_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ ki,
                  const int* __restrict__ flags,
                  const int* __restrict__ seg_ptr, T* __restrict__ out,
                  int Hq, int Hkv, int S, int Tk, int D, int bq, int bk,
                  float scale, int causal, int window, int prefix,
                  int q_offset) {
  constexpr int RK = RQ;
  constexpr int BQ = TS * RQ, BK = TS * RK, DM = TS * RD;
  constexpr int QLD = DM + 1, SLD = BK + 1;    // padded row strides
  extern __shared__ float smem[];
  float* Qs = smem;                      // [BQ][QLD]
  float* KVs = Qs + BQ * QLD;            // [BK][QLD]: k tile, then v tile
  float* Ss = KVs + BK * QLD;            // [BQ][SLD]: scores, then p
  float* m_s = Ss + BQ * SLD;            // running max per row
  float* l_s = m_s + BQ;                 // running normaliser per row
  float* a_s = l_s + BQ;                 // this step's alpha per row

  const int qb = blockIdx.x;
  const int bh = blockIdx.y;             // b * Hq + h
  const int kvh = (bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
  const T* Qg = q + ((size_t)bh * S + (size_t)qb * bq) * D;
  const T* Kg = k + (size_t)kvh * Tk * D;
  const T* Vg = v + (size_t)kvh * Tk * D;
  T* Og = out + ((size_t)bh * S + (size_t)qb * bq) * D;
  const int nkb = Tk / bk;

  const int tid = threadIdx.x;
  const int ty = tid / TS, tx = tid % TS;
  const int warp = tid / 32, lane = tid % 32;

  for (int e = tid; e < BQ * DM; e += NT) {
    const int i = e / DM, d = e % DM;
    Qs[i * QLD + d] = (i < bq && d < D) ? to_f32(Qg[(size_t)i * D + d])
                                         : 0.0f;
  }
  for (int i = tid; i < BQ; i += NT) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.0f;
  }

  float acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[i][c] = 0.0f;

  const int w_end = seg_ptr[qb + 1];
  for (int w = seg_ptr[qb]; w < w_end; ++w) {
    const int f = flags[w];              // uniform across the CTA
    const bool first = f & 1;
    const int kb = ki[w];
    const bool kb_ok = kb >= 0 && kb < nkb;
    if (first) {
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < RD; ++c) acc[i][c] = 0.0f;
    }
    const T* Kt = Kg + (size_t)kb * bk * D;
    const T* Vt = Vg + (size_t)kb * bk * D;

    __syncthreads();                     // last step's reads of KVs, Ss done
    for (int e = tid; e < BK * DM; e += NT) {
      const int j = e / DM, d = e % DM;
      KVs[j * QLD + d] = (kb_ok && j < bk && d < D)
                             ? to_f32(Kt[(size_t)j * D + d]) : 0.0f;
    }
    __syncthreads();

    // scores: s = q . k^T over the tile, masked, into Ss
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DM; ++d) {
      float qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + TS * i) * QLD + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = KVs[(tx + TS * j) * QLD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = ty + TS * i;
      const int qg = qb * bq + row + q_offset;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int col = tx + TS * j;
        const bool ok = kb_ok && row < bq && col < bk &&
                        allowed(qg, kb * bk + col, causal, window, prefix);
        Ss[row * SLD + col] = ok ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // stage the v tile where the k tile was
    for (int e = tid; e < BK * DM; e += NT) {
      const int j = e / DM, d = e % DM;
      KVs[j * QLD + d] = (kb_ok && j < bk && d < D)
                             ? to_f32(Vt[(size_t)j * D + d]) : 0.0f;
    }
    // online softmax: one warp per row
    for (int row = warp; row < bq; row += NT / 32) {
      float* Sr = Ss + row * SLD;
      const int qg = qb * bq + row + q_offset;
      const float m_prev = first ? NEG_INF : m_s[row];
      const float l_prev = first ? 0.0f : l_s[row];
      float m_cur = NEG_INF;
      for (int c = lane; c < bk; c += 32) m_cur = fmaxf(m_cur, Sr[c]);
      const float m_new = fmaxf(m_prev, warp_max(m_cur));
      float sum = 0.0f;
      for (int c = lane; c < bk; c += 32) {
        const bool ok = kb_ok &&
                        allowed(qg, kb * bk + c, causal, window, prefix);
        const float p = ok ? expf(Sr[c] - m_new) : 0.0f;
        Sr[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[row] = m_new;
        l_s[row] = l_prev * alpha + sum;
        a_s[row] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const float alpha = a_s[ty + TS * i];
#pragma unroll
      for (int c = 0; c < RD; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < bk; ++j) {
      float pv[RQ], vv[RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ss[(ty + TS * i) * SLD + j];
#pragma unroll
      for (int c = 0; c < RD; ++c) vv[c] = KVs[j * QLD + tx + TS * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < RD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }

    if (f & 2) {                         // flush: acc / l, 0 where l == 0
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int row = ty + TS * i;
        if (row >= bq) continue;
        const float l = l_s[row];
#pragma unroll
        for (int c = 0; c < RD; ++c) {
          const int col = tx + TS * c;
          if (col < D)
            Og[(size_t)row * D + col] =
                from_f32<T>(l > 0.0f ? acc[i][c] / fmaxf(l, 1e-30f) : 0.0f);
        }
      }
    }
  }
}

template <typename T, int RQ, int RD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* ki, const int* flags, const int* seg_ptr,
                   void* out, int BH, int Hq, int Hkv, int S, int Tk, int D,
                   int bq, int bk, float scale, int causal, int window,
                   int prefix, int q_offset, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<RQ, RD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mask_kernel<T, RQ, RD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(S / bq, BH);
  flash_mask_kernel<T, RQ, RD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ki, flags, seg_ptr, static_cast<T*>(out), Hq,
      Hkv, S, Tk, D, bq, bk, scale, causal, window, prefix, q_offset);
  return cudaGetLastError();
}

template <typename T, int RQ>
cudaError_t by_dim(const void* q, const void* k, const void* v,
                   const int* ki, const int* flags, const int* seg_ptr,
                   void* out, int BH, int Hq, int Hkv, int S, int Tk, int D,
                   int bq, int bk, float scale, int causal, int window,
                   int prefix, int q_offset, cudaStream_t s) {
  if (D <= 16)
    return launch<T, RQ, 1>(q, k, v, ki, flags, seg_ptr, out, BH, Hq, Hkv, S,
                            Tk, D, bq, bk, scale, causal, window, prefix,
                            q_offset, s);
  if (D <= 64)
    return launch<T, RQ, 4>(q, k, v, ki, flags, seg_ptr, out, BH, Hq, Hkv, S,
                            Tk, D, bq, bk, scale, causal, window, prefix,
                            q_offset, s);
  return launch<T, RQ, 8>(q, k, v, ki, flags, seg_ptr, out, BH, Hq, Hkv, S,
                          Tk, D, bq, bk, scale, causal, window, prefix,
                          q_offset, s);
}

template <typename T>
cudaError_t by_block(const void* q, const void* k, const void* v,
                     const int* ki, const int* flags, const int* seg_ptr,
                     void* out, int BH, int Hq, int Hkv, int S, int Tk, int D,
                     int bq, int bk, float scale, int causal, int window,
                     int prefix, int q_offset, cudaStream_t s) {
  const int big = bq > bk ? bq : bk;
  if (big <= 16)
    return by_dim<T, 1>(q, k, v, ki, flags, seg_ptr, out, BH, Hq, Hkv, S, Tk,
                        D, bq, bk, scale, causal, window, prefix, q_offset,
                        s);
  if (big <= 32)
    return by_dim<T, 2>(q, k, v, ki, flags, seg_ptr, out, BH, Hq, Hkv, S, Tk,
                        D, bq, bk, scale, causal, window, prefix, q_offset,
                        s);
  if (big <= 64)
    return by_dim<T, 4>(q, k, v, ki, flags, seg_ptr, out, BH, Hq, Hkv, S, Tk,
                        D, bq, bk, scale, causal, window, prefix, q_offset,
                        s);
  return by_dim<T, 8>(q, k, v, ki, flags, seg_ptr, out, BH, Hq, Hkv, S, Tk,
                      D, bq, bk, scale, causal, window, prefix, q_offset, s);
}

}  // namespace

// C interface (bound with ctypes).  Pointers are device pointers of
// contiguous tensors of one dtype (0 = f32, 1 = bf16): q (B, Hq, S, D),
// k and v (B, Hkv, Tk, D), out (B, Hq, S, D) zero-initialised; ki and flags
// (P,) int32 worklist entries sorted by q-block, seg_ptr (S / bq + 1,)
// int32 segment offsets of each q-block.  BH = B * Hq.  Requires
// S % bq == Tk % bk == Hq % Hkv == 0, 1 <= bq, bk <= 128 and D <= 128 (the
// wrapper checks).  Returns the cudaError_t of the launch (0 on success);
// an unknown dtype returns cudaErrorInvalidValue.
extern "C" int flash_mask(const void* q, const void* k, const void* v,
                          const int* ki, const int* flags,
                          const int* seg_ptr, void* out, int BH, int Hq,
                          int Hkv, int S, int Tk, int D, int bq, int bk,
                          float scale, int causal, int window, int prefix,
                          int q_offset, int dtype, void* stream) {
  if (BH <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_block<float>(q, k, v, ki, flags, seg_ptr, out, BH, Hq, Hkv, S,
                           Tk, D, bq, bk, scale, causal, window, prefix,
                           q_offset, s);
  if (dtype == 1)
    return by_block<__nv_bfloat16>(q, k, v, ki, flags, seg_ptr, out, BH, Hq,
                                   Hkv, S, Tk, D, bq, bk, scale, causal,
                                   window, prefix, q_offset, s);
  return cudaErrorInvalidValue;
}
