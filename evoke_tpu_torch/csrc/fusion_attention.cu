// Masked cross-view fusion attention (kernel K3).
//
// Replaces the TPU kernel evoke_tpu/ops/fusion_attention.py
// masked_cross_view_attention (:86, body _kernel :36). Anchor q attends all
// B*T batch key rows under a per-(anchor, sample) mask: key row r belongs to
// sample r / t_tokens and is kept where mask[q, sample] != 0. Scores are
// float32 from the input dtype, multiplied by 1/sqrt(dk); an online softmax in
// float32 with the probabilities kept in float32 and V upcast to float32 for
// p.v; out = acc / max(l, 1e-30), rounded to q's dtype (the TPU kernel's
// numerics, not dot_attention's, which rounds the probabilities to V's dtype).
//
// What bounds it on the H100: at the fusion module's shapes (dk 2048 with
// wide qkv, T 50, 8 heads) an anchor attends 1-4 samples of the 64-128 in the
// batch. The least work is the bytes of q, the output and the attended K/V
// rows (3.35 TB/s) against 4 * T * T * dk operations per (anchor, head,
// attended sample) (989 TFLOP/s bf16, 67 TFLOP/s float32); bytes bound it.
//
// Design (simple and right first):
// - The [T, dk] float32 accumulator of one (anchor, head) is 400 KB at dk
//   2048, more than an SM holds, where the TPU kept it whole in VMEM. So the
//   grid is (anchor, head, dk chunk of 256 output columns x 64-row query
//   tile); each block keeps its [64, 256] accumulator in registers (64 a
//   thread) and recomputes the [64, 64] score tile over the full dk, streamed
//   through shared memory in 64-wide slices. Cost: the q.k^T work and the
//   q/k reads repeat once per dk chunk (8x at dk 2048; the re-reads hit L2).
// - Samples the mask excludes are skipped: the block walks the B samples and
//   runs only the attended ones, each sample's key rows as 64-row tiles.
//   Skipping is exact: on the TPU a masked key's -1e9 score adds exp(-1e9 - m)
//   = 0 once a kept key has set m, and before that the dummy sums are wiped by
//   a correction of exactly 0. The caller guarantees every anchor attends at
//   least one sample (its self slot); the kernel assumes it.
// - q, k and v are read in place through element strides (the module passes
//   views of its projection outputs); the last dimension must be contiguous.
// - bf16: q.k^T on the tensor cores (WMMA 16x16x16, float32 accumulation);
//   float32: FMA. p.v is FMA in float32 for both, as the TPU kernel keeps p
//   in float32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kRows = 64;      // query rows per block
constexpr int kKeys = 64;      // key rows per tile
constexpr int kDS = 64;        // dk slice of the score product
constexpr int kCols = 256;     // output columns per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;  // 8
constexpr int kColsPerLane = kCols / 32;      // 8
constexpr int kLdS = kKeys + 4;               // score tile row stride (floats)
constexpr float kNegInf = -1e9f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// q/k slice row stride in shared memory: a multiple of 8 bf16 (WMMA) with a
// 16-byte skew; float32 rows get one float of skew against bank conflicts.
template <typename T> struct Slice { static constexpr int ld = kDS + 1; };
template <> struct Slice<__nv_bfloat16> { static constexpr int ld = kDS + 8; };

template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)kRows * kLdS * 4          // scores / probabilities
         + (size_t)kKeys * kCols * 4       // V tile, float32
         + (size_t)3 * kRows * 4           // m, l, correction
         + (size_t)2 * kRows * Slice<T>::ld * sizeof(T);  // q, k slices
}

// S[64][kLdS] = scale * Qs . Ks^T over one dk slice, accumulated across slices.
// bf16: each warp owns two 16x16 output tiles held in WMMA fragments.
struct TensorScores {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  __device__ void zero() {
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
  }
  __device__ void step(const __nv_bfloat16* Qs, const __nv_bfloat16* Ks, int warp) {
    constexpr int ld = Slice<__nv_bfloat16>::ld;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int tile = warp + t * kWarps, ti = tile >> 2, tj = tile & 3;
#pragma unroll
      for (int kk = 0; kk < kDS; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + ti * 16 * ld + kk, ld);
        wmma::load_matrix_sync(b, Ks + tj * 16 * ld + kk, ld);
        wmma::mma_sync(acc[t], a, b, acc[t]);
      }
    }
  }
  __device__ void store(float* S, float scale, int warp) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int tile = warp + t * kWarps, ti = tile >> 2, tj = tile & 3;
#pragma unroll
      for (int i = 0; i < acc[t].num_elements; ++i) acc[t].x[i] *= scale;
      wmma::store_matrix_sync(S + ti * 16 * kLdS + tj * 16, acc[t], kLdS,
                              wmma::mem_row_major);
    }
  }
};

// float32: thread (ty, tx) owns the 4x4 block rows ty*4.., keys tx*4..
struct FmaScores {
  float acc[4][4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  __device__ void step(const float* Qs, const float* Ks, int) {
    constexpr int ld = Slice<float>::ld;
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 8
    for (int d = 0; d < kDS; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx * 4 + j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __device__ void store(float* S, float scale, int) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) S[(ty * 4 + i) * kLdS + tx * 4 + j] = acc[i][j] * scale;
  }
};

template <typename T> struct ScoresFor { using type = FmaScores; };
template <> struct ScoresFor<__nv_bfloat16> { using type = TensorScores; };

// grid (Q, heads, n_chunks * n_row_tiles), block kThreads
template <typename T>
__global__ void __launch_bounds__(kThreads)
fusion_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const unsigned char* __restrict__ mask, T* __restrict__ out,
              int H, int TQ, int dk, int B, int tt,
              long long sq0, long long sq1, long long sq2,
              long long sk0, long long sk1, long long sv0, long long sv1,
              float scale, int n_chunks) {
  constexpr int ldq = Slice<T>::ld;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* S = reinterpret_cast<float*>(smem_raw);          // [kRows][kLdS]
  float* Vs = S + kRows * kLdS;                           // [kKeys][kCols]
  float* mrow = Vs + kKeys * kCols;                       // [kRows]
  float* lrow = mrow + kRows;
  float* crow = lrow + kRows;
  T* Qs = reinterpret_cast<T*>(crow + kRows);             // [kRows][ldq]
  T* Ks = Qs + kRows * ldq;                               // [kKeys][ldq]

  const int qi = blockIdx.x, hh = blockIdx.y;
  const int chunk = blockIdx.z % n_chunks, rt = blockIdx.z / n_chunks;
  const int c0 = chunk * kCols, r0 = rt * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + (long long)qi * sq0 + (long long)hh * sq1;
  const T* kb = k + (long long)hh * sk0;
  const T* vb = v + (long long)hh * sv0;

  for (int r = tid; r < kRows; r += kThreads) {
    mrow[r] = kNegInf;
    lrow[r] = 0.f;
  }
  float acc[kRowsPerWarp][kColsPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int e = 0; e < kColsPerLane; ++e) acc[rr][e] = 0.f;
  typename ScoresFor<T>::type sc;

  for (int j = 0; j < B; ++j) {
    if (!mask[(long long)qi * B + j]) continue;          // uniform across the block
    for (int k0 = 0; k0 < tt; k0 += kKeys) {
      const int nk = min(kKeys, tt - k0);
      const long long key0 = (long long)j * tt + k0;
      // ---- scores over the full dk, in kDS-wide slices ----
      sc.zero();
      for (int d0 = 0; d0 < dk; d0 += kDS) {
        for (int i = tid; i < kRows * kDS; i += kThreads) {
          const int r = i / kDS, d = i - r * kDS;
          const int row = r0 + r, col = d0 + d;
          Qs[r * ldq + d] = (row < TQ && col < dk) ? qb[(long long)row * sq2 + col]
                                                   : zero_of<T>();
          Ks[r * ldq + d] = (r < nk && col < dk) ? kb[(key0 + r) * sk1 + col]
                                                 : zero_of<T>();
        }
        __syncthreads();
        sc.step(Qs, Ks, warp);
        __syncthreads();
      }
      sc.store(S, scale, warp);
      // ---- V tile (float32) for this block's columns ----
      for (int i = tid; i < kKeys * kCols; i += kThreads) {
        const int kk = i / kCols, c = i - kk * kCols;
        Vs[i] = (kk < nk && c0 + c < dk) ? to_f(vb[(key0 + kk) * sv1 + c0 + c]) : 0.f;
      }
      __syncthreads();
      // ---- online softmax: warp w owns rows w*8 .. w*8+7 ----
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr;
        float* sr = S + r * kLdS;
        const bool v0 = lane < nk, v1 = lane + 32 < nk;
        const float s0 = v0 ? sr[lane] : -INFINITY;
        const float s1 = v1 ? sr[lane + 32] : -INFINITY;
        const float m_old = mrow[r];
        const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
        const float p0 = v0 ? expf(s0 - m_new) : 0.f;
        const float p1 = v1 ? expf(s1 - m_new) : 0.f;
        const float psum = warp_sum(p0 + p1);
        sr[lane] = p0;
        sr[lane + 32] = p1;
        __syncwarp();
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          crow[r] = corr;
          lrow[r] = lrow[r] * corr + psum;
          mrow[r] = m_new;
        }
      }
      __syncwarp();
      // ---- acc = acc * corr + p . v (rows of this warp, lane's columns) ----
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float corr = crow[warp * kRowsPerWarp + rr];
#pragma unroll
        for (int e = 0; e < kColsPerLane; ++e) acc[rr][e] *= corr;
      }
      for (int kk = 0; kk < nk; ++kk) {
        float vv[kColsPerLane];
#pragma unroll
        for (int e = 0; e < kColsPerLane; ++e) vv[e] = Vs[kk * kCols + lane + 32 * e];
#pragma unroll
        for (int rr = 0; rr < kRowsPerWarp; ++rr) {
          const float p = S[(warp * kRowsPerWarp + rr) * kLdS + kk];
#pragma unroll
          for (int e = 0; e < kColsPerLane; ++e) acc[rr][e] = fmaf(p, vv[e], acc[rr][e]);
        }
      }
      __syncthreads();   // S and Vs are rewritten by the next tile
    }
  }

  T* ob = out + ((long long)qi * H + hh) * (long long)TQ * dk;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr, row = r0 + r;
    if (row >= TQ) continue;
    const float den = fmaxf(lrow[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < kColsPerLane; ++e) {
      const int col = c0 + lane + 32 * e;
      if (col < dk) ob[(long long)row * dk + col] = from_f<T>(acc[rr][e] / den);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out,
           int Q, int H, int TQ, int dk, int B, int tt, long long sq0, long long sq1,
           long long sq2, long long sk0, long long sk1, long long sv0, long long sv1,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>();
  auto kern = fusion_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_chunks = (dk + kCols - 1) / kCols;
  const int n_rows = (TQ + kRows - 1) / kRows;
  kern<<<dim3(Q, H, n_chunks * n_rows), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(mask), static_cast<T*>(out), H, TQ, dk, B, tt,
      sq0, sq1, sq2, sk0, sk1, sv0, sv1, scale, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// q [Q, H, TQ, dk] (strides sq0..sq2, last 1); k, v [H, B*tt, dk] (strides
// sk0/sk1, sv0/sv1, last 1); mask [Q, B] uint8 contiguous; out [Q, H, TQ, dk]
// contiguous. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError()
// after the launch (0 = success).
extern "C" int fusion_attention_launch(const void* q, const void* k, const void* v,
                                       const void* mask, void* out, int Q, int H, int TQ,
                                       int dk, int B, int tt, long long sq0, long long sq1,
                                       long long sq2, long long sk0, long long sk1,
                                       long long sv0, long long sv1, float scale,
                                       int dtype, void* stream) {
  if (Q < 1 || H < 1 || H > 65535 || TQ < 1 || dk < 1 || B < 1 || tt < 1)
    return (int)cudaErrorInvalidValue;
  const long long z = (long long)((dk + kCols - 1) / kCols) * ((TQ + kRows - 1) / kRows);
  if (z > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, mask, out, Q, H, TQ, dk, B, tt, sq0, sq1, sq2, sk0, sk1,
                         sv0, sv1, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, mask, out, Q, H, TQ, dk, B, tt, sq0, sq1, sq2,
                                 sk0, sk1, sv0, sv1, scale, st);
  return (int)cudaErrorInvalidValue;
}
