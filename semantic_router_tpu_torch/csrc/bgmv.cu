// BGMV (batched gather matrix-vector) for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the TPU kernel semantic_router_tpu/ops/bgmv.py::bgmv_pallas
// (body _bgmv_kernel):
//     out[p, :] = x[p, :] @ W[idx[p], :, :]
// for x [P, D], W [T, D, H], idx [P] int32; accumulated in float32 and
// stored in x's dtype.  The Pallas kernel runs one program per pair and
// gathers the pair's [D, H] slab through a scalar-prefetched BlockSpec
// index map; here a block reads its own indices.
//
// What bounds it on the H100: the work is far below the card's ridge
// (2 FLOPs per weight element read once per pair), so the bytes are the
// weights.  The least the card can read is each DISTINCT task's slab once
// (at D = H = 768 f32, 2.36 MB a task); a kernel that reads the slab once
// per pair reads P * 2.36 MB, which only L2 (50 MB) can absorb.
// What this first design does about it (simple and right; no TMA, no
// wgmma):
//   - A block of 512 threads owns TP consecutive pairs x TN output
//     columns.  Each of the TN threads of a row owns one output column and
//     reads W[idx, d, col]: H is the contiguous axis of [T, D, H], so a
//     warp's reads coalesce.
//   - The block's x rows sit in shared memory as float32.
//   - Consecutive pairs with the same index form a run: one read of
//     W[t, d, col] feeds every pair of the run.
//   - KS = 512 / TN thread rows split D into KS chunks, which puts KS
//     times more loads in flight; their partial sums meet in shared
//     memory.  TN shrinks to H rounded up to a warp (the classifier call
//     has H = 8), so a narrow H buys a finer D split instead of idle
//     threads.
//   - TP is the largest of 8, 4, 2, 1 that still gives two blocks per SM:
//     a long run reuses its slab over up to 8 pairs, a short pair axis
//     still fills the card.
//   - Ragged H, D and P edges are masked.
//   - An index outside [0, T) is never dereferenced: its row comes back
//     NaN.
// The task-grouped segmented GEMM (Punica SGMV: pairs sorted by task, one
// weight tile read per task) is the redesign for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;  // TN columns x KS D-chunks
constexpr int MAX_TP = 8;     // pairs per block, at most
constexpr int MAX_D = 4096;   // (TP*D + THREADS*TP) floats <= 144 KB

constexpr int NO_PAIR = -1;      // slot past the last pair
constexpr int BAD_INDEX = -2;    // idx outside [0, T)

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

// blockDim = (TN, KS) with TN * KS == THREADS
template <typename T, int TP>
__global__ void __launch_bounds__(THREADS)
bgmv_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const int* __restrict__ idx, T* __restrict__ out, int P, int D,
            int H, int nT) {
  extern __shared__ float smem[];
  float* xs = smem;              // [TP][D]
  float* red = smem + TP * D;    // [KS][TP][TN]
  __shared__ int ts[TP];

  const int TN = blockDim.x, KS = blockDim.y;
  const int tid = threadIdx.y * TN + threadIdx.x;
  const int p0 = blockIdx.y * TP;
  const int col = blockIdx.x * TN + threadIdx.x;

  if (tid < TP) {
    const int p = p0 + tid;
    int t = NO_PAIR;
    if (p < P) {
      t = idx[p];
      if (t < 0 || t >= nT) t = BAD_INDEX;
    }
    ts[tid] = t;
  }
  for (int i = tid; i < TP * D; i += THREADS) {
    const int p = p0 + i / D;
    xs[i] = p < P ? to_f32(x[(long long)p0 * D + i]) : 0.f;
  }
  __syncthreads();

  float acc[TP];
#pragma unroll
  for (int j = 0; j < TP; ++j) acc[j] = 0.f;

  const int chunk = (D + KS - 1) / KS;
  const int d0 = threadIdx.y * chunk;
  const int d1 = min(D, d0 + chunk);
  if (col < H) {
    int j0 = 0;
    while (j0 < TP) {
      const int t = ts[j0];
      int j1 = j0 + 1;
      while (j1 < TP && ts[j1] == t) ++j1;
      if (t >= 0) {
        const T* wp = w + (long long)t * D * H + col;
#pragma unroll 4
        for (int d = d0; d < d1; ++d) {
          const float wv = to_f32(wp[(long long)d * H]);
#pragma unroll
          for (int j = 0; j < TP; ++j)
            if (j >= j0 && j < j1) acc[j] = fmaf(xs[j * D + d], wv, acc[j]);
        }
      }
      j0 = j1;
    }
  }

#pragma unroll
  for (int j = 0; j < TP; ++j)
    red[(threadIdx.y * TP + j) * TN + threadIdx.x] = acc[j];
  __syncthreads();
  if (threadIdx.y != 0 || col >= H) return;
#pragma unroll
  for (int j = 0; j < TP; ++j) {
    const int p = p0 + j;
    if (p >= P) break;
    float s = 0.f;
    for (int k = 0; k < KS; ++k) s += red[(k * TP + j) * TN + threadIdx.x];
    out[(long long)p * H + col] =
        from_f32<T>(ts[j] == BAD_INDEX ? __int_as_float(0x7fc00000) : s);
  }
}

template <typename T, int TP>
cudaError_t launch_tp(const void* x, const void* w, const int* idx,
                      void* out, int P, int D, int H, int nT, int tn,
                      cudaStream_t stream) {
  dim3 grid((H + tn - 1) / tn, (P + TP - 1) / TP);
  dim3 block(tn, THREADS / tn);
  const size_t smem = sizeof(float) * ((size_t)TP * D + THREADS * TP);
  // static + dynamic shared memory past 48 KB needs the opt-in
  if (smem + sizeof(int) * TP > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bgmv_kernel<T, TP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  bgmv_kernel<T, TP><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), idx,
      static_cast<T*>(out), P, D, H, nT);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const int* idx, void* out,
                   int P, int D, int H, int nT, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // TN: H rounded up to a warp, at most 128 columns a block
  const int tn = H >= 128 ? 128 : ((H + 31) / 32) * 32;
  const long long col_blocks = (H + tn - 1) / tn;
  int tp = MAX_TP;
  while (tp > 1 && col_blocks * ((P + tp - 1) / tp) < 2LL * sms) tp /= 2;
  switch (tp) {
    case 8: return launch_tp<T, 8>(x, w, idx, out, P, D, H, nT, tn, stream);
    case 4: return launch_tp<T, 4>(x, w, idx, out, P, D, H, nT, tn, stream);
    case 2: return launch_tp<T, 2>(x, w, idx, out, P, D, H, nT, tn, stream);
    default:
      return launch_tp<T, 1>(x, w, idx, out, P, D, H, nT, tn, stream);
  }
}

}  // namespace

// x [P, D], w [T, D, H], idx [P] int32, out [P, H]; all contiguous, x, w
// and out of one dtype (0 = float32, 1 = bfloat16).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernel
// does not take (D > 4096, P > 65535).
extern "C" int srt_bgmv(const void* x, const void* w, const void* idx,
                        void* out, int P, int D, int H, int nT, int dtype,
                        void* stream) {
  if (P <= 0 || D <= 0 || H <= 0 || nT <= 0 || D > MAX_D || P > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  cudaError_t e =
      dtype == 1 ? launch<__nv_bfloat16>(x, w, ix, out, P, D, H, nT, st)
                 : launch<float>(x, w, ix, out, P, D, H, nT, st);
  return (int)e;
}
