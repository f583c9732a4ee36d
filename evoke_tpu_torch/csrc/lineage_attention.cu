// Beam-lineage self-attention over un-permuted KV caches (kernel K1).
//
// Replaces the TPU kernel evoke_tpu/ops/lineage_attention.py:_kernel (and its
// _kernel_fused_heads variant, launched by _lineage_call). One decode step:
// query row (s, b) attends physical beam row j of its own sample at slot t iff
// anc[s, b, t] == j and 0 < (pos - t) mod L <= age, plus its own row at slot
// pos. Scores and softmax in float32, probabilities rounded to the V dtype
// before the weighted sum (as the TPU kernel's p.astype(v.dtype)), float32
// accumulation, output rounded to the cache dtype. Output is pre-`wo`.
//
// What bounds it on the H100: bytes. Per step each sample's K and V rows are
// read once (2 * 192 * 100 * 512 * 2 B = 39.3 MB at L = 100, ~11.7 us at
// 3.35 TB/s); the FLOPs (4 * kbeam * N * L * D) are negligible.
//
// Design against that bound:
// - one block per (sample, head) reads that head's dh-lane slice of all
//   kbeam * L K and V rows of the sample ONCE for all kbeam queries, keeping
//   the TPU kernel's property that each cache byte is read once per step;
// - the lineage mask is built in the block from anc/pos/age (the
//   _ring_masks math, the mod as a conditional add), and a key row that no
//   query of the sample attends is never read at all (slots beyond pos, and
//   beams whose history every lineage has left);
// - the softmax is two-pass over at most kbeam * kbeam * L float32 scores in
//   shared memory and normalises BEFORE rounding the probs to the V dtype, as
//   the TPU kernel does (an online softmax normalising at the end would round
//   differently at bf16).
// The fused-heads / per-head split of the TPU kernel (_kernel_for) was a
// Mosaic workaround and has no counterpart here.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxBeam = 4;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e9f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

// grid (B, num_heads), block kThreads, dynamic smem kbeam*R floats + R bytes
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
lineage_kernel(const T* __restrict__ q, const T* __restrict__ ck,
               const T* __restrict__ cv, const int* __restrict__ anc,
               const int* __restrict__ age, T* __restrict__ out,
               int kbeam, int L, int D, int pos, float scale) {
  constexpr int EPL = DH / 32;           // q/k elements per lane
  constexpr int GROUPS = kThreads / DH;  // row groups in the P.V pass
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int R = kbeam * L;               // key rows of this sample
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;

  extern __shared__ float smem[];
  float* s = smem;                                                    // [kbeam][R]
  unsigned char* need = reinterpret_cast<unsigned char*>(s + kbeam * R);  // [R]
  __shared__ float qs[kMaxBeam][DH];
  __shared__ float part[GROUPS][kMaxBeam][DH];

  const int a = age ? age[b] : pos;
  const size_t row0 = (size_t)b * kbeam;  // first physical row of the sample

  for (int i = tid; i < kbeam * DH; i += kThreads) {
    const int qi = i / DH, c = i - qi * DH;
    qs[qi][c] = to_f(q[(row0 + qi) * D + (size_t)h * DH + c]);
  }
  // lineage mask: bit qi of need[j*L + t] set iff query qi attends (j, t)
  for (int r = tid; r < R; r += kThreads) {
    const int j = r / L, t = r - j * L;
    int delta = pos - t;
    if (delta < 0) delta += L;
    const bool hist = delta > 0 && delta <= a;
    const bool now = delta == 0;
    unsigned m = 0;
    for (int qi = 0; qi < kbeam; ++qi) {
      const bool att = (hist && anc[(row0 + qi) * L + t] == j) || (now && qi == j);
      m |= (att ? 1u : 0u) << qi;
    }
    need[r] = (unsigned char)m;
  }
  __syncthreads();

  // scores: one warp per key row, the row read once for all kbeam queries
  for (int r = warp; r < R; r += kWarps) {
    const unsigned m = need[r];
    if (m == 0) {
      if (lane < kbeam) s[lane * R + r] = kNegInf;
      continue;
    }
    const int j = r / L, t = r - j * L;
    const T* krow = ck + ((row0 + j) * L + t) * D + (size_t)h * DH;
    float kv[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) kv[e] = to_f(krow[lane + 32 * e]);
    for (int qi = 0; qi < kbeam; ++qi) {
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc = fmaf(qs[qi][lane + 32 * e], kv[e], acc);
      acc = warp_sum(acc);
      if (lane == 0) s[qi * R + r] = ((m >> qi) & 1u) ? acc * scale : kNegInf;
    }
  }
  __syncthreads();

  // softmax per query (one warp each), normalised before the V-dtype rounding
  if (warp < kbeam) {
    float* sq = s + warp * R;
    float mx = -INFINITY;
    for (int r = lane; r < R; r += 32) mx = fmaxf(mx, sq[r]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int r = lane; r < R; r += 32) {
      const float e = expf(sq[r] - mx);
      sq[r] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int r = lane; r < R; r += 32) sq[r] = to_f(from_f<T>(sq[r] / sum));
  }
  __syncthreads();

  // P.V: thread (group g, lane-column c) sums rows g, g+GROUPS, ... that any
  // query attends (the others have probability exactly 0 for every query)
  const int c = tid % DH, g = tid / DH;
  float acc[kMaxBeam];
#pragma unroll
  for (int qi = 0; qi < kMaxBeam; ++qi) acc[qi] = 0.f;
  for (int r = g; r < R; r += GROUPS) {
    if (need[r] == 0) continue;
    const int j = r / L, t = r - j * L;
    const float v = to_f(cv[((row0 + j) * L + t) * D + (size_t)h * DH + c]);
#pragma unroll
    for (int qi = 0; qi < kMaxBeam; ++qi)
      if (qi < kbeam) acc[qi] = fmaf(s[qi * R + r], v, acc[qi]);
  }
#pragma unroll
  for (int qi = 0; qi < kMaxBeam; ++qi) part[g][qi][c] = acc[qi];
  __syncthreads();
  for (int i = tid; i < kbeam * DH; i += kThreads) {
    const int qi = i / DH, cc = i - qi * DH;
    float tot = 0.f;
#pragma unroll
    for (int gg = 0; gg < GROUPS; ++gg) tot += part[gg][qi][cc];
    out[(row0 + qi) * D + (size_t)h * DH + cc] = from_f<T>(tot);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* ck, const void* cv, const void* anc,
           const void* age, void* out, int B, int kbeam, int L, int D, int heads,
           int pos, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)kbeam * kbeam * L * sizeof(float) + (size_t)kbeam * L;
  auto kern = lineage_kernel<T, DH>;
  if (smem > 40 * 1024) {  // 48 KB default, less the static arrays
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(B, heads), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ck), static_cast<const T*>(cv),
      static_cast<const int*>(anc), static_cast<const int*>(age), static_cast<T*>(out),
      kbeam, L, D, pos, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* ck, const void* cv, const void* anc,
              const void* age, void* out, int B, int kbeam, int L, int D, int heads,
              int pos, float scale, cudaStream_t stream) {
  switch (D / heads) {
    case 32: return launch<T, 32>(q, ck, cv, anc, age, out, B, kbeam, L, D, heads, pos, scale, stream);
    case 64: return launch<T, 64>(q, ck, cv, anc, age, out, B, kbeam, L, D, heads, pos, scale, stream);
    case 128: return launch<T, 128>(q, ck, cv, anc, age, out, B, kbeam, L, D, heads, pos, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. age may be NULL (batch mode: age = pos).
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int lineage_attention_launch(const void* q, const void* ck, const void* cv,
                                        const void* anc, const void* age, void* out,
                                        int B, int kbeam, int L, int D, int heads,
                                        int pos, float scale, int dtype, void* stream) {
  if (kbeam < 1 || kbeam > kMaxBeam || L < 1 || heads < 1 || D % heads != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(q, ck, cv, anc, age, out, B, kbeam, L, D, heads, pos, scale, st);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, ck, cv, anc, age, out, B, kbeam, L, D, heads, pos,
                                    scale, st);
  return (int)cudaErrorInvalidValue;
}
