// Head-bank epilogue for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel semantic_router_tpu/ops/epilogue.py::
// head_epilogue_pallas (body _epilogue_kernel):
//     out[r, t, :] = act(x[r, :] @ W[t] + b[t] + delta[r, t, :])
// for x [rows, D], W [T, D, H], optional b [T, H], optional delta
// [rows, T, H]; act is an int enum over the head activations (identity,
// exact-erf GELU, tanh GELU, relu, silu).
//
// What bounds it on the H100: the token-head call (rows = B*S up to 8192,
// D = H = 768) is a float32 matrix product of ~9.7 GFLOP over ~30 MB, so
// it is bound by operations; the sequence-head call (rows = padded batch)
// is tiny and bound by launch latency and by reading W (T * 2.4 MB).
// What the design does about it:
//   - A grouped GEMM over T: one 64x64 output tile per block, blockIdx.z
//     selects the task, so every task of the bank runs in one launch.
//   - x and W stream through shared memory in 16-deep K slices; each of
//     the 256 threads accumulates a 4x4 register tile in float32 FMAs.
//   - Bias add, delta add and the activation are applied to the register
//     tile before its one store: the [rows, T, H] pre-activation never
//     round-trips through device memory.
// Full float32 FMA (no TF32) keeps 1e-4 parity with the plain version.
// Tensor cores (wgmma, bf16/TF32 operands) and TMA pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;   // rows per block
constexpr int TN = 64;   // output columns per block
constexpr int TK = 16;   // K slice
constexpr int THREADS = 256;

enum Act { ACT_IDENTITY = 0, ACT_GELU = 1, ACT_GELU_TANH = 2, ACT_RELU = 3,
           ACT_SILU = 4 };

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

__device__ __forceinline__ float activate(float h, int act) {
  switch (act) {
    case ACT_GELU:
      return 0.5f * h * (1.f + erff(h * 0.70710678118654752440f));
    case ACT_GELU_TANH: {
      const float u = 0.79788456080286535588f * (h + 0.044715f * h * h * h);
      return 0.5f * h * (1.f + tanhf(u));
    }
    case ACT_RELU:
      return fmaxf(h, 0.f);
    case ACT_SILU:
      return h / (1.f + expf(-h));
    default:
      return h;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
head_epilogue_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ bias, const T* __restrict__ delta,
                     T* __restrict__ out, int rows, int D, int H, int nT,
                     int act) {
  __shared__ float As[TK][TM + 4];  // x slice, k-major
  __shared__ float Bs[TK][TN + 4];  // W slice
  const int t = blockIdx.z;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;
  const int tx = threadIdx.x % 16;  // 4 output columns each
  const int ty = threadIdx.x / 16;  // 4 output rows each
  const T* W = w + (long long)t * D * H;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += TK) {
    for (int i = threadIdx.x; i < TM * TK; i += THREADS) {
      const int rr = i / TK, kk = i % TK;
      const int gr = row0 + rr, gk = k0 + kk;
      As[kk][rr] = (gr < rows && gk < D) ? to_f32(x[(long long)gr * D + gk])
                                         : 0.f;
    }
    for (int i = threadIdx.x; i < TK * TN; i += THREADS) {
      const int kk = i / TN, cc = i % TN;
      const int gk = k0 + kk, gc = col0 + cc;
      Bs[kk][cc] = (gk < D && gc < H) ? to_f32(W[(long long)gk * H + gc])
                                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty * 4 + i;
    if (gr >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx * 4 + j;
      if (gc >= H) continue;
      const long long o = ((long long)gr * nT + t) * H + gc;
      float h = acc[i][j];
      if (bias != nullptr) h += to_f32(bias[(long long)t * H + gc]);
      if (delta != nullptr) h += to_f32(delta[o]);
      out[o] = from_f32<T>(activate(h, act));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias,
                   const void* delta, void* out, int rows, int D, int H,
                   int nT, int act, cudaStream_t stream) {
  dim3 grid((H + TN - 1) / TN, (rows + TM - 1) / TM, nT);
  head_epilogue_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<const T*>(delta),
      static_cast<T*>(out), rows, D, H, nT, act);
  return cudaGetLastError();
}

}  // namespace

// x [rows, D], w [T, D, H], bias [T, H] or null, delta [rows, T, H] or
// null, out [rows, T, H]; all contiguous, one dtype (0 = float32,
// 1 = bfloat16).  Returns cudaGetLastError().
extern "C" int srt_head_epilogue(const void* x, const void* w,
                                 const void* bias, const void* delta,
                                 void* out, int rows, int D, int H, int nT,
                                 int act, int dtype, void* stream) {
  if (rows <= 0 || D <= 0 || H <= 0 || nT <= 0 || nT > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      dtype == 1 ? launch<__nv_bfloat16>(x, w, bias, delta, out, rows, D, H,
                                         nT, act, st)
                 : launch<float>(x, w, bias, delta, out, rows, D, H, nT, act,
                                 st);
  return (int)e;
}
