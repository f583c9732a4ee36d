// Fused logit projection + stage-1 top-k + logsumexp (kernel K2).
//
// Replaces the TPU kernel evoke_tpu/ops/fused_logit_topk.py:_kernel (launched
// by _pallas_topk). For h [N, D], the logit head W [V, D] (the port's Linear
// layout) and bias [V], all in one dtype T (bfloat16 or float32):
//   logits = T(T(f32 sum_d h[n,d] * W[v,d]) + b[v])   (nn.Dense(dtype): two roundings)
//   lse[n] = logsumexp over v of the PRE-suppression logits (float32)
//   at suppressed ids: logits += T(-1000)   (added in T, rounded)
//   (vals, idx)[n] = top-k of the suppressed logits, ties to the lowest index
// The [N, V] logits never reach device memory.
//
// What bounds it on the H100: at the serving shape (N 192, D 512, V 30001,
// bf16) reading W is 30.7 MB (~9.2 us at 3.35 TB/s) and the product is
// 5.9 GFLOP (~6 us at 989 TFLOP/s): bytes, with the operations close behind.
//
// Design:
// - kernel 1 splits V into tiles of TV = 32 columns, one block per tile, each
//   block holding ALL rows (up to 256 per pass), so W is read from device
//   memory once per step. bf16 products run on the tensor cores (WMMA
//   16x16x16, float32 accumulation); float32 runs plain FMA. Each block writes
//   per row a partial (max, sum of exp) of the pre-suppression logits and a
//   partial top-k of the suppressed ones, selected by warp argmax rounds that
//   break ties to the lowest index;
// - kernel 2, one block per row, merges the partials: a tree over tiles with
//   lse = M + log(sum_i s_i * exp(m_i - M)) and the (value desc, index asc)
//   order for the top-k, so ties still go to the lowest index.
// Simple first: scalar staging loads and a per-tile h re-read from L2; the
// fast version (TMA + wgmma, a persistent grid) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <limits.h>
#include <math.h>

namespace {

using namespace nvcuda;

constexpr int TV = 32;         // vocab columns per block; one per lane in the epilogue
constexpr int RG = 256;        // rows per pass
constexpr int DK = 32;         // depth chunk staged in shared memory
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;
constexpr int kNoIdx = INT_MAX;
// staging (f32: RG*DK + TV*(DK+1) floats) and the C tile (RG*TV floats) alias
constexpr int kSmemBytes = (RG * DK + TV * (DK + 1)) * 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// round a float32 value to T and back
__device__ __forceinline__ float round_t(float x, float) { return x; }
__device__ __forceinline__ float round_t(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
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

__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// C[r][c] = sum_d h[r][d] * W[v0 + c][d] for r < nrows (bf16, tensor cores)
__device__ void mainloop(const __nv_bfloat16* __restrict__ h,
                         const __nv_bfloat16* __restrict__ w, int D, int V, int nrows,
                         int v0, unsigned char* sbuf, float* C) {
  __nv_bfloat16* Hs = reinterpret_cast<__nv_bfloat16*>(sbuf);  // [RG][DK]
  __nv_bfloat16* Ws = Hs + RG * DK;                             // [TV][DK]
  const int warp = threadIdx.x >> 5;
  const int nrf = (nrows + 15) / 16;  // row fragments in use (warp-uniform)
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int d0 = 0; d0 < D; d0 += DK) {
    for (int e = threadIdx.x; e < RG * DK; e += kThreads) {
      const int r = e / DK, d = d0 + (e - r * DK);
      Hs[e] = (r < nrows && d < D) ? h[(size_t)r * D + d] : zero;
    }
    for (int e = threadIdx.x; e < TV * DK; e += kThreads) {
      const int c = e / DK, d = d0 + (e - c * DK), col = v0 + c;
      Ws[e] = (col < V && d < D) ? w[(size_t)col * D + d] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DK; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf0, bf1;
      wmma::load_matrix_sync(bf0, Ws + kk, DK);
      wmma::load_matrix_sync(bf1, Ws + 16 * DK + kk, DK);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rf = warp + kWarps * i;
        if (rf < nrf) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
          wmma::load_matrix_sync(af, Hs + rf * 16 * DK + kk, DK);
          wmma::mma_sync(acc[i][0], af, bf0, acc[i][0]);
          wmma::mma_sync(acc[i][1], af, bf1, acc[i][1]);
        }
      }
    }
    __syncthreads();
  }
  // C aliases the staging buffer: every warp passed the barrier after its last read
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rf = warp + kWarps * i;
    if (rf < nrf) {
      wmma::store_matrix_sync(C + rf * 16 * TV, acc[i][0], TV, wmma::mem_row_major);
      wmma::store_matrix_sync(C + rf * 16 * TV + 16, acc[i][1], TV, wmma::mem_row_major);
    }
  }
  __syncthreads();
}

// the same product in float32 on the FMA units
__device__ void mainloop(const float* __restrict__ h, const float* __restrict__ w,
                         int D, int V, int nrows, int v0, unsigned char* sbuf, float* C) {
  float* Hs = reinterpret_cast<float*>(sbuf);  // [RG][DK]
  float* Ws = Hs + RG * DK;                    // [TV][DK + 1] (padded: no bank conflicts)
  const int c = threadIdx.x & 31;
  const int rbase = threadIdx.x >> 5;          // rows rbase + kWarps * i
  constexpr int RPT = RG / kWarps;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  for (int d0 = 0; d0 < D; d0 += DK) {
    for (int e = threadIdx.x; e < RG * DK; e += kThreads) {
      const int r = e / DK, d = d0 + (e - r * DK);
      Hs[e] = (r < nrows && d < D) ? h[(size_t)r * D + d] : 0.f;
    }
    for (int e = threadIdx.x; e < TV * DK; e += kThreads) {
      const int cc = e / DK, k = e - cc * DK, d = d0 + k, col = v0 + cc;
      Ws[cc * (DK + 1) + k] = (col < V && d < D) ? w[(size_t)col * D + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < DK; ++k) {
      const float wv = Ws[c * (DK + 1) + k];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(Hs[(rbase + kWarps * i) * DK + k], wv, acc[i]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) C[(rbase + kWarps * i) * TV + c] = acc[i];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const T* __restrict__ h, const T* __restrict__ w, const T* __restrict__ bias,
            int N, int D, int V, int k, int n_sup, int s0, int s1, int s2, int s3,
            float* __restrict__ part_m, float* __restrict__ part_s,
            float* __restrict__ part_v, int* __restrict__ part_i) {
  __shared__ __align__(128) unsigned char sbuf[kSmemBytes];
  float* C = reinterpret_cast<float*>(sbuf);
  const int tile = blockIdx.x;
  const int v0 = tile * TV;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = v0 + lane;
  const bool valid = col < V;
  const bool sup = valid && ((n_sup > 0 && col == s0) || (n_sup > 1 && col == s1) ||
                             (n_sup > 2 && col == s2) || (n_sup > 3 && col == s3));
  const float bcol = valid ? to_f(bias[col]) : 0.f;
  const T tag{};  // selects the rounding of T

  for (int r0 = 0; r0 < N; r0 += RG) {
    const int nrows = min(RG, N - r0);
    mainloop(h + (size_t)r0 * D, w, D, V, nrows, v0, sbuf, C);
    for (int r = warp; r < nrows; r += kWarps) {
      // nn.Dense(dtype): round the f32 product to T, add the bias in T
      float x = round_t(round_t(C[r * TV + lane], tag) + bcol, tag);
      float xs = sup ? round_t(x + (-1000.f), tag) : x;
      if (!valid) x = xs = -INFINITY;
      const float m = warp_max(x);
      const float ssum = warp_sum(valid ? expf(x - m) : 0.f);
      const size_t o = (size_t)tile * N + r0 + r;
      if (lane == 0) {
        part_m[o] = m;
        part_s[o] = ssum;
      }
      bool taken = !valid;
      for (int kk = 0; kk < k; ++kk) {
        float bv = taken ? -INFINITY : xs;
        int bi = taken ? kNoIdx : col;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (better(ov, oi, bv, bi)) {
            bv = ov;
            bi = oi;
          }
        }
        if (lane == 0) {
          part_v[o * k + kk] = bv;
          part_i[o * k + kk] = bi;
        }
        if (col == bi) taken = true;
      }
    }
    __syncthreads();  // C is the next pass's staging buffer
  }
}

__device__ __forceinline__ void merge_ms(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float M = fmaxf(m, m2);
  s = s * expf(m - M) + s2 * expf(m2 - M);
  m = M;
}

__device__ __forceinline__ void insert(float* tv, int* ti, int k, float v, int i) {
  if (i == kNoIdx || !better(v, i, tv[k - 1], ti[k - 1])) return;
  int p = k - 1;
  while (p > 0 && better(v, i, tv[p - 1], ti[p - 1])) {
    tv[p] = tv[p - 1];
    ti[p] = ti[p - 1];
    --p;
  }
  tv[p] = v;
  ti[p] = i;
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_s,
             const float* __restrict__ part_v, const int* __restrict__ part_i,
             int N, int NT, int k, float* __restrict__ vals, int* __restrict__ idx,
             float* __restrict__ lse) {
  __shared__ float sm[kThreads], ss[kThreads], sv[kThreads * kMaxK];
  __shared__ int si[kThreads * kMaxK];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  float m = -INFINITY, s = 0.f;
  float tv[kMaxK];
  int ti[kMaxK];
  for (int kk = 0; kk < kMaxK; ++kk) {
    tv[kk] = -INFINITY;
    ti[kk] = kNoIdx;
  }
  for (int t = tid; t < NT; t += kThreads) {  // ascending tiles
    const size_t o = (size_t)t * N + row;
    merge_ms(m, s, part_m[o], part_s[o]);
    for (int kk = 0; kk < k; ++kk) insert(tv, ti, k, part_v[o * k + kk], part_i[o * k + kk]);
  }
  sm[tid] = m;
  ss[tid] = s;
  for (int kk = 0; kk < k; ++kk) {
    sv[tid * kMaxK + kk] = tv[kk];
    si[tid * kMaxK + kk] = ti[kk];
  }
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      const int o = tid + stride;
      merge_ms(m, s, sm[o], ss[o]);
      for (int kk = 0; kk < k; ++kk) insert(tv, ti, k, sv[o * kMaxK + kk], si[o * kMaxK + kk]);
      sm[tid] = m;
      ss[tid] = s;
      for (int kk = 0; kk < k; ++kk) {
        sv[tid * kMaxK + kk] = tv[kk];
        si[tid * kMaxK + kk] = ti[kk];
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    for (int kk = 0; kk < k; ++kk) {
      vals[(size_t)row * k + kk] = tv[kk];
      idx[(size_t)row * k + kk] = ti[kk];
    }
    lse[row] = m + logf(s);
  }
}

template <typename T>
int launch(const void* h, const void* w, const void* bias, void* pm, void* ps, void* pv,
           void* pi, void* vals, void* idx, void* lse, int N, int D, int V, int k,
           int n_sup, int s0, int s1, int s2, int s3, cudaStream_t st) {
  const int NT = (V + TV - 1) / TV;
  tile_kernel<T><<<NT, kThreads, 0, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), static_cast<const T*>(bias), N, D,
      V, k, n_sup, s0, s1, s2, s3, static_cast<float*>(pm), static_cast<float*>(ps),
      static_cast<float*>(pv), static_cast<int*>(pi));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_kernel<<<N, kThreads, 0, st>>>(
      static_cast<const float*>(pm), static_cast<const float*>(ps),
      static_cast<const float*>(pv), static_cast<const int*>(pi), N, NT, k,
      static_cast<float*>(vals), static_cast<int*>(idx), static_cast<float*>(lse));
  return (int)cudaGetLastError();
}

}  // namespace

// Vocab columns per tile: the wrapper sizes the partials as ceil(V / TV) * N.
extern "C" int fused_logit_topk_tile() { return TV; }

// dtype: 0 = float32, 1 = bfloat16. Up to 4 suppressed ids (s0..s3, n_sup used).
// Returns cudaGetLastError() after the launches (0 = success).
extern "C" int fused_logit_topk_launch(const void* h, const void* w, const void* bias,
                                       void* part_m, void* part_s, void* part_v,
                                       void* part_i, void* vals, void* idx, void* lse,
                                       int N, int D, int V, int k, int n_sup, int s0,
                                       int s1, int s2, int s3, int dtype, void* stream) {
  if (k < 1 || k > kMaxK || N < 1 || D < 1 || V < k || n_sup < 0 || n_sup > 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(h, w, bias, part_m, part_s, part_v, part_i, vals, idx, lse, N, D, V,
                         k, n_sup, s0, s1, s2, s3, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h, w, bias, part_m, part_s, part_v, part_i, vals, idx, lse,
                                 N, D, V, k, n_sup, s0, s1, s2, s3, st);
  return (int)cudaErrorInvalidValue;
}
