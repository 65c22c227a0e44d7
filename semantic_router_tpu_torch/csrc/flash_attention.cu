// Flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel semantic_router_tpu/ops/flash_attention.py::
// flash_attention_pallas (body _flash_kernel): softmax(q.k^T * scale +
// key_padding_bias) . v with an optional sliding window (|i-j| <= window/2,
// scores outside REPLACED by -1e9) or a causal mask; padding keys ADD
// (1 - mask) * -1e9.  Online softmax with m/l/acc in float32, l clamped at
// 1e-20, output in q's dtype.
//
// What bounds it on the H100: at the ModernBERT shapes (D = 64, S <= 2048)
// the work is small matrix products over 64x64 tiles; this first version
// runs them as scalar float32 FMAs out of shared memory, so it is bound by
// shared-memory bandwidth and FMA issue, far above the bytes it must move.
// What the design does about it:
//   - One block per (b*h, 64-row Q tile); K/V stream through shared memory
//     in 64-row tiles (the Pallas kernel held a whole (b, h) K/V in VMEM,
//     which does not fit a block's shared memory at S = 2048).
//   - The loop over K tiles is clipped to [q_start - window/2,
//     q_end + window/2] on local layers: two of every three ModernBERT
//     layers touch about 3 tiles instead of S/64.
//   - Scores, probabilities and the output accumulator stay on chip; only
//     q, k, v, the [B, S] mask and the output touch device memory.
//   - Rows are padded by one float in shared memory so the 8 query rows a
//     warp reads at once fall in distinct banks.
//   - The ragged edge (S not a multiple of 64) is masked in the kernel, so
//     no padded copies of q/k/v are made.
// Full float32 FMA (no TF32) keeps 1e-5 parity with the plain version.
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key rows per tile
constexpr int THREADS = 256;
constexpr int LANES = THREADS / BQ;  // threads per query row (4)
constexpr float NEG_INF = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* mask;  // [B, S] contiguous, 1 = real key; may be null
  void* o;
  long long q_sb, q_sh, q_ss;  // element strides (last dim contiguous)
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int H, S, window, causal;
  float scale;
};

template <int D>
constexpr size_t smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd(FlashArgs a) {
  static_assert(D % LANES == 0, "head dim must divide across lanes");
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][D+1], pre-scaled
  float* Ks = Qs + BQ * (D + 1);     // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);     // [BK][D]
  float* Ps = Vs + BK * D;           // [BQ][BK+1]
  float* kbias = Ps + BQ * (BK + 1); // [BK]

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid / LANES;   // this thread's query row in the tile
  const int c = tid % LANES;   // its lane within the row
  const int qi = q0 + r;       // absolute query position

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int row = i / D, d = i % D, s = q0 + row;
    Qs[row * (D + 1) + d] = s < a.S ? to_f32(q[s * a.q_ss + d]) * a.scale
                                    : 0.f;
  }

  // K tiles this Q tile can see
  const int q_last = min(q0 + BQ, a.S) - 1;
  int k_lo = 0, k_hi = a.S - 1;
  const int half = a.window / 2;
  if (a.window > 0) {
    k_lo = max(q0 - half, 0);
    k_hi = min(q_last + half, a.S - 1);
  }
  if (a.causal) k_hi = min(k_hi, q_last);
  const int t_lo = k_lo / BK, t_hi = k_hi / BK;

  constexpr int NJ = BK / LANES;   // keys per thread per tile
  constexpr int ND = D / LANES;    // output dims per thread
  float m = -INFINITY, l = 0.f;
  float acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's reads of Ks/Vs are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int row = i / D, d = i % D, s = k0 + row;
      const bool ok = s < a.S;
      Ks[row * (D + 1) + d] = ok ? to_f32(k[s * a.k_ss + d]) : 0.f;
      Vs[row * D + d] = ok ? to_f32(v[s * a.v_ss + d]) : 0.f;
    }
    if (tid < BK) {
      const int s = k0 + tid;
      kbias[tid] = (a.mask != nullptr && s < a.S)
                       ? (1.f - (float)a.mask[(long long)b * a.S + s]) * NEG_INF
                       : 0.f;
    }
    __syncthreads();

    float sc[NJ];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) sc[jj] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qv = Qs[r * (D + 1) + d];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
        sc[jj] = fmaf(qv, Ks[(c + jj * LANES) * (D + 1) + d], sc[jj]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int jl = c + jj * LANES;
      const int j = k0 + jl;
      float s = sc[jj] + kbias[jl];
      if (j >= a.S) s = NEG_INF;
      if (a.window > 0 && abs(qi - j) > half) s = NEG_INF;
      if (a.causal && j > qi) s = NEG_INF;
      sc[jj] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const float p = expf(sc[jj] - m_new);
      Ps[r * (BK + 1) + c + jj * LANES] = p;
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] *= corr;
    __syncwarp();  // a row's 4 lanes share one warp: its Ps row is visible
    for (int j = 0; j < BK; ++j) {
      const float p = Ps[r * (BK + 1) + j];
#pragma unroll
      for (int i = 0; i < ND; ++i)
        acc[i] = fmaf(p, Vs[j * D + c + i * LANES], acc[i]);
    }
  }

  if (qi < a.S) {
    const float lc = fmaxf(l, 1e-20f);  // fully-masked rows stay finite
    T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh + qi * a.o_ss;
#pragma unroll
    for (int i = 0; i < ND; ++i) o[c + i * LANES] = from_f32<T>(acc[i] / lc);
  }
}

template <typename T, int D>
cudaError_t launch(const FlashArgs& a, int B, cudaStream_t stream) {
  const int smem = (int)(smem_floats<D>() * sizeof(float));
  static bool attr_set = false;  // idempotent; a race only repeats the call
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  dim3 grid((a.S + BQ - 1) / BQ, B * a.H);
  flash_fwd<T, D><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const FlashArgs& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, s);
    case 32: return launch<T, 32>(a, B, s);
    case 64: return launch<T, 64>(a, B, s);
    case 128: return launch<T, 128>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/o: [B, H, S, D] with the given element strides (D contiguous).
// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int srt_flash_attention(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int B, int H, int S, int D, int window, int causal, float scale,
    int dtype, void* stream) {
  FlashArgs a;
  a.q = q; a.k = k; a.v = v;
  a.mask = static_cast<const int32_t*>(mask);
  a.o = o;
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.o_sb = o_sb; a.o_sh = o_sh; a.o_ss = o_ss;
  a.H = H; a.S = S; a.window = window; a.causal = causal; a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = dtype == 1 ? dispatch_d<__nv_bfloat16>(a, B, D, st)
                             : dispatch_d<float>(a, B, D, st);
  return (int)e;
}
