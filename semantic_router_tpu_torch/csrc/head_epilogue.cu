// Head-bank epilogue for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel semantic_router_tpu/ops/epilogue.py::
// head_epilogue_pallas (body _epilogue_kernel):
//     out[r, t, :] = act(x[r, :] @ W[t] + b[t] + delta[r, t, :])
// for x [rows, D], W [T, D, H], optional b [T, H], optional delta
// [rows, T, H]; act is an int enum over the head activations (identity,
// exact-erf GELU, tanh GELU, relu, silu).
//
// The one entry point, srt_head_epilogue, picks one of two designs by
// shape inside the launcher:
//
// Small rows (rows <= 64: the pooled sequence bank, 16 rows x T 3 at
// 768x768 on the main path).  The work is 2*rows*D*H*T flops over
// T*D*H weights, so it is bound by reading W once (7 MB at T = 3: ~2 us
// at 3.35 TB/s) and by how much of the card the launch fills.  Design:
//   - W streams through registers in 16-byte loads: each block owns 16
//     output columns (64 contiguous bytes of every W row, 4 lanes a row)
//     of one task, so a 768-wide bank of 3 tasks is 48 x 3 = 144 blocks
//     on the 132 SMs; the 64 d-lanes of a block (8 per warp) split D.
//   - x (16 rows at a time) sits in shared memory as float32; every lane
//     of a warp reads the same row, so the reads broadcast.
//   - The D split is reduced inside the block in a fixed order (warp
//     butterfly, then 8 warp partials summed by one thread per output):
//     no atomics, the same bits from launch to launch.
//   - Full float32 FMA: at 16 rows the tensor cores would idle on the
//     zero rows of a 64-row tile, and the bytes bound the call anyway.
//
// Large rows (the token bank, rows = B*S up to 8192): 2*rows*D*H flops
// (9.7 GFLOP at 8192 x 768 x 768) over ~30 MB, bound by operations.
// Design:
//   - A grouped GEMM over T (blockIdx.z = task), 128x128 output tiles,
//     8 warps of 64x32, K in 32-deep slices.
//   - Products run on the tensor cores as 3xTF32 (tf32x3.cuh): float32
//     accuracy at the TF32 MMA rate; bf16 inputs take one TF32 pass.
//   - x and W slices arrive by cp.async into a 3-stage shared-memory ring,
//     so two slices are in flight while the warps multiply the third;
//     W [D, H] is N-major, which mma.sync takes from shared memory as it
//     is (wgmma would need TF32 operands K-major).
//   - Shared-memory rows are padded (x by 4 floats, W by 8) so each
//     warp's fragment reads hit 32 distinct banks.
//   - Two blocks an SM (the launch bounds cap registers at 128; 105 KB
//     of shared memory each), so one block's fragment loads and splits
//     hide the other's MMA latency; at 133 registers only one fit.
// Both designs apply bias add, delta add and the activation to the
// register result before its one store: the [rows, T, H] pre-activation
// never round-trips through device memory.  Shapes whose rows or
// pointers are not 16-byte aligned take element-wise loads in the same
// kernels.

#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using srt::from_f32;
using srt::to_f32;

enum Act { ACT_IDENTITY = 0, ACT_GELU = 1, ACT_GELU_TANH = 2, ACT_RELU = 3,
           ACT_SILU = 4 };

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

struct Args {
  const void* x;
  const void* w;
  const void* bias;   // may be null
  const void* delta;  // may be null
  void* out;
  int rows, D, H, nT, act;
  int vec;  // 1: rows of x and W and both base pointers are 16-byte aligned
};

// the fused epilogue on one output element (row r, task t, column c)
template <typename T>
__device__ __forceinline__ void store_out(const Args& a, float h, int r,
                                          int t, int c) {
  const long long o = ((long long)r * a.nT + t) * a.H + c;
  if (a.bias != nullptr)
    h += to_f32(static_cast<const T*>(a.bias)[(long long)t * a.H + c]);
  if (a.delta != nullptr) h += to_f32(static_cast<const T*>(a.delta)[o]);
  static_cast<T*>(a.out)[o] = from_f32<T>(activate(h, a.act));
}

// ---- small rows: weight streaming -----------------------------------------

constexpr int SMALL_THREADS = 256;
constexpr int SMALL_MAX_ROWS = 64;
constexpr int SMALL_WARPS = SMALL_THREADS / 32;

template <typename T> struct Small {
  static constexpr int VEC = srt::vec_elems<T>();   // columns per lane
  static constexpr int COLS = 4 * VEC;               // columns per block
  static constexpr int DLANES = SMALL_THREADS / 4;   // D split per block
  static constexpr int RC = SMALL_THREADS / COLS;    // rows per pass
  static size_t smem(int D) {
    return sizeof(float) * ((size_t)RC * D + SMALL_WARPS * RC * COLS);
  }
};

// VEC consecutive columns of one W row, as float32
template <typename T, int VEC>
__device__ __forceinline__ void load_w(const T* row, int c, int H, bool vec,
                                       float (&v)[VEC]) {
  if (vec) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + c));
    const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
    if constexpr (VEC == 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __uint_as_float(u[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u[k]));
        v[2 * k] = f.x;
        v[2 * k + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      v[k] = c + k < H ? to_f32(row[c + k]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(SMALL_THREADS)
head_epilogue_small(Args a) {
  using C = Small<T>;
  extern __shared__ float smem[];
  float* xs = smem;                  // [RC][D]: this pass's x rows
  float* red = xs + C::RC * a.D;     // [warps][RC][COLS]: warp partials
  const int t = blockIdx.y;
  const int col0 = blockIdx.x * C::COLS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int dl = warp * 8 + lane / 4;          // this lane's d-lane
  const int c = col0 + (lane % 4) * C::VEC;    // its first column
  const int D = a.D, H = a.H;
  const T* x = static_cast<const T*>(a.x);
  const T* W = static_cast<const T*>(a.w) + (long long)t * D * H;

  for (int r0 = 0; r0 < a.rows; r0 += C::RC) {
    const int nr = min(C::RC, a.rows - r0);
    __syncthreads();  // the previous pass is done with xs and red
    for (int r = 0; r < C::RC; ++r)
      for (int d = threadIdx.x; d < D; d += SMALL_THREADS)
        xs[r * D + d] = r < nr ? to_f32(x[(long long)(r0 + r) * D + d])
                               : 0.f;
    __syncthreads();

    float acc[C::RC][C::VEC];
#pragma unroll
    for (int r = 0; r < C::RC; ++r)
#pragma unroll
      for (int k = 0; k < C::VEC; ++k) acc[r][k] = 0.f;
    if (c < H) {
#pragma unroll 4
      for (int d = dl; d < D; d += C::DLANES) {
        float wv[C::VEC];
        load_w<T, C::VEC>(W + (long long)d * H, c, H, a.vec, wv);
#pragma unroll
        for (int r = 0; r < C::RC; ++r) {
          const float xv = xs[r * D + d];
#pragma unroll
          for (int k = 0; k < C::VEC; ++k)
            acc[r][k] = fmaf(xv, wv[k], acc[r][k]);
        }
      }
    }
    // the 8 d-lanes of a warp that share a column group: lanes l, l^4,
    // l^8, l^16 -- a fixed butterfly
#pragma unroll
    for (int r = 0; r < C::RC; ++r)
#pragma unroll
      for (int k = 0; k < C::VEC; ++k) {
        float v = acc[r][k];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[r][k] = v;
      }
    if (lane < 4) {
#pragma unroll
      for (int r = 0; r < C::RC; ++r)
#pragma unroll
        for (int k = 0; k < C::VEC; ++k)
          red[(warp * C::RC + r) * C::COLS + lane * C::VEC + k] = acc[r][k];
    }
    __syncthreads();
    // one output per thread (RC * COLS == threads), warps summed in order
    const int r = threadIdx.x / C::COLS, cc = threadIdx.x % C::COLS;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < SMALL_WARPS; ++w)
      s += red[(w * C::RC + r) * C::COLS + cc];
    if (r < nr && col0 + cc < H) store_out<T>(a, s, r0 + r, t, col0 + cc);
  }
}

// ---- large rows: 3xTF32 tensor-core GEMM -----------------------------------

constexpr int GEMM_THREADS = 256;  // 8 warps, 2 x 4 over the tile

template <typename T> struct Gemm {
  static constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3;
  static constexpr int VEC = srt::vec_elems<T>();
  static constexpr bool SPLIT = srt::needs_split<T>();
  // padded shared-memory row strides, in elements (conflict-free reads)
  static constexpr int SA = BK + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int SB = BN + 8;
  static constexpr int A_ELEMS = BM * SA, B_ELEMS = BK * SB;
  static constexpr size_t SMEM = sizeof(T) * STAGES * (A_ELEMS + B_ELEMS);
};

// x[bm:bm+BM, k0:k0+BK] -> As, W[k0:k0+BK, bn:bn+BN] -> Bs, zero-filled
// past the edges
template <typename T>
__device__ __forceinline__ void gemm_load(const Args& a, const T* W, T* As,
                                          T* Bs, int bm, int bn, int k0) {
  using C = Gemm<T>;
  const T* x = static_cast<const T*>(a.x);
  constexpr int ACH = C::BK / C::VEC, BCH = C::BN / C::VEC;
  const T zero = from_f32<T>(0.f);
  for (int i = threadIdx.x; i < C::BM * ACH; i += GEMM_THREADS) {
    const int r = i / ACH, kc = (i % ACH) * C::VEC;
    const int gr = bm + r, gk = k0 + kc;
    T* dst = As + r * C::SA + kc;
    const T* src = x + (long long)gr * a.D + gk;
    if (a.vec) {
      const bool ok = gr < a.rows && gk < a.D;
      srt::cp_async16(dst, ok ? src : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < C::VEC; ++e)
        dst[e] = gr < a.rows && gk + e < a.D ? src[e] : zero;
    }
  }
  for (int i = threadIdx.x; i < C::BK * BCH; i += GEMM_THREADS) {
    const int r = i / BCH, cc = (i % BCH) * C::VEC;
    const int gk = k0 + r, gc = bn + cc;
    T* dst = Bs + r * C::SB + cc;
    const T* src = W + (long long)gk * a.H + gc;
    if (a.vec) {
      const bool ok = gk < a.D && gc < a.H;
      srt::cp_async16(dst, ok ? src : W, ok);
    } else {
#pragma unroll
      for (int e = 0; e < C::VEC; ++e)
        dst[e] = gk < a.D && gc + e < a.H ? src[e] : zero;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
head_epilogue_gemm(Args a) {
  using C = Gemm<T>;
  constexpr bool SPLIT = C::SPLIT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);        // [STAGES][BM][SA]
  T* Bs = As + C::STAGES * C::A_ELEMS;           // [STAGES][BK][SB]
  const int t = blockIdx.z;
  const int bm = blockIdx.y * C::BM, bn = blockIdx.x * C::BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const T* W = static_cast<const T*>(a.w) + (long long)t * a.D * a.H;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int KT = (a.D + C::BK - 1) / C::BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < KT)
      gemm_load<T>(a, W, As + s * C::A_ELEMS, Bs + s * C::B_ELEMS, bm, bn,
                   s * C::BK);
    srt::cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    srt::cp_async_wait<C::STAGES - 2>();  // slice kt has landed
    __syncthreads();  // ... for every thread; slice kt-1's stage is free
    const int nk = kt + C::STAGES - 1;
    if (nk < KT) {
      const int s = nk % C::STAGES;
      gemm_load<T>(a, W, As + s * C::A_ELEMS, Bs + s * C::B_ELEMS, bm, bn,
                   nk * C::BK);
    }
    srt::cp_async_commit();

    const T* At = As + (kt % C::STAGES) * C::A_ELEMS;
    const T* Bt = Bs + (kt % C::STAGES) * C::B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 8) {
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn + j * 8 + g;
        srt::split_tf32<SPLIT>(to_f32(Bt[(kk + c4) * C::SB + n]), bb[j][0],
                               bs[j][0]);
        srt::split_tf32<SPLIT>(to_f32(Bt[(kk + c4 + 4) * C::SB + n]),
                               bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const T* ar = At + (wm + i * 16 + g) * C::SA + kk + c4;
        uint32_t ab[4], as[4];
        srt::split_tf32<SPLIT>(to_f32(ar[0]), ab[0], as[0]);
        srt::split_tf32<SPLIT>(to_f32(ar[8 * C::SA]), ab[1], as[1]);
        srt::split_tf32<SPLIT>(to_f32(ar[4]), ab[2], as[2]);
        srt::split_tf32<SPLIT>(to_f32(ar[8 * C::SA + 4]), ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          srt::mma_f32<SPLIT>(acc[i][j], ab, as, bb[j], bs[j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = bm + wm + i * 16 + g + (e >= 2 ? 8 : 0);
        const int c = bn + wn + j * 8 + 2 * c4 + (e & 1);
        if (r < a.rows && c < a.H) store_out<T>(a, acc[i][j][e], r, t, c);
      }
}

// ---- launch ------------------------------------------------------------------

// raise a kernel's dynamic shared-memory limit to `bytes` once it needs it
template <typename K>
cudaError_t reserve_smem(K kernel, size_t bytes, size_t& reserved) {
  if (bytes <= 48 * 1024 || bytes <= reserved) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) reserved = bytes;  // a race only repeats the call
  return e;
}

constexpr size_t MAX_SMEM = 227 * 1024;

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t small_smem = Small<T>::smem(a.D);
  if (a.rows <= SMALL_MAX_ROWS && small_smem <= MAX_SMEM) {
    static size_t reserved = 0;
    cudaError_t e = reserve_smem(head_epilogue_small<T>, small_smem,
                                 reserved);
    if (e != cudaSuccess) return e;
    dim3 grid((a.H + Small<T>::COLS - 1) / Small<T>::COLS, a.nT);
    head_epilogue_small<T><<<grid, SMALL_THREADS, small_smem, stream>>>(a);
    return cudaGetLastError();
  }
  using C = Gemm<T>;
  static size_t reserved = 0;
  cudaError_t e = reserve_smem(head_epilogue_gemm<T>, C::SMEM, reserved);
  if (e != cudaSuccess) return e;
  dim3 grid((a.H + C::BN - 1) / C::BN, (a.rows + C::BM - 1) / C::BM, a.nT);
  head_epilogue_gemm<T><<<grid, GEMM_THREADS, C::SMEM, stream>>>(a);
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
  if (rows <= 0 || D <= 0 || H <= 0 || nT <= 0 || nT > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a{x, w, bias, delta, out, rows, D, H, nT, act, 0};
  const int vec = dtype == 1 ? srt::vec_elems<__nv_bfloat16>()
                             : srt::vec_elems<float>();
  a.vec = D % vec == 0 && H % vec == 0 && srt::aligned16(x) &&
          srt::aligned16(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 1 ? launch<__nv_bfloat16>(a, st)
                             : launch<float>(a, st);
  return (int)e;
}
