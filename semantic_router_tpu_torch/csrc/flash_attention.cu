// Flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel semantic_router_tpu/ops/flash_attention.py::
// flash_attention_pallas (body _flash_kernel): softmax(q.k^T * scale +
// key_padding_bias) . v with an optional sliding window (|i-j| <= window/2,
// scores outside REPLACED by -1e9) or a causal mask; padding keys ADD
// (1 - mask) * -1e9.  Online softmax with m/l/acc in float32, l clamped at
// 1e-20, output in q's dtype.
//
// What bounds it on the H100: per (query, key) pair 4*D flops over q, k,
// v and the output read or written once; at the ModernBERT shapes (D = 64,
// S = 512, 12 heads) a global layer is ~20 flops per byte, so the bound is
// the tensor cores' float32-accurate rate (495 TFLOP/s TF32 / 3 passes),
// and a local layer (window 128) sits near the bytes bound.  In practice
// the kernel is bound by instruction issue and latency: every MMA operand
// is split into two TF32 halves in registers.  What the design does
// (FlashAttention-2 forward):
//   - One block of 4 warps per (b*h, 64-row Q tile); each warp owns 16
//     query rows against a whole 32-key tile, so the row max and row sum
//     of the online softmax stay within the 4 lanes that share a row.
//   - Q.K^T and P.V run on the tensor cores (mma.sync m16n8k8 TF32) as
//     3xTF32 (tf32x3.cuh): float32 accuracy at the TF32 rate, with the
//     split done by integer rounding instead of cvt; bf16 inputs take one
//     pass.  Scores, probabilities and the output accumulator live in
//     registers; P feeds P.V straight from the score fragments by
//     ordering each 8-key group's K dimension as (0,2,4,6,1,3,5,7) and
//     reading V's rows in the same order, so no shuffle or shared-memory
//     round trip is needed.
//   - Occupancy: Q stays in shared memory and is split at each use, and
//     K tiles are 32 keys, so a block needs ~122 registers a thread and
//     54 KB of shared memory (D = 64, f32): four blocks, 16 warps, an SM.
//   - K/V tiles arrive by cp.async into a double-buffered ring, straight
//     from the strided q/k/v views of the [B, S, 3, H, D] projection (no
//     copy); tile i+1 is in flight while the warps work on tile i.
//     Shared-memory rows are padded (D+4 floats, D+8 bf16) so every
//     fragment read of a warp hits 32 distinct banks.
//   - The loop over K tiles is clipped to [q_start - window/2,
//     q_end + window/2] on local layers, as before.
//   - Masked tiles are skipped: the block reads its [B, S] mask row once
//     into shared memory (as the additive key bias), flags the K tiles
//     that hold a real key, and visits only those.  This is exact for
//     every real query row: its own key is real and inside its window, so
//     the row max is a real score and a masked key adds exp(-1e9 + ...)
//     = 0 in float32.  A Q tile with no real query writes zeros and
//     returns (padding rows may differ from the plain version; zeros keep
//     NaN out of the next layer).
//   - Scores move to the log2 domain (scale * log2 e) so each probability
//     is one exp2f.
// No atomics: the same inputs give the same bits from launch to launch.

#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

using srt::from_f32;
using srt::to_f32;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per tile
constexpr int THREADS = 128;  // 4 warps x 16 query rows
constexpr int NT = BK / 8;    // 8-key groups per tile
constexpr float NEG_INF = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;

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
  int vec;  // 1: every q/k/v row is 16-byte aligned (cp.async)
};

template <typename T, int D> struct Cfg {
  static constexpr int VEC = srt::vec_elems<T>();
  static constexpr bool SPLIT = srt::needs_split<T>();
  static constexpr int SK = D + (sizeof(T) == 4 ? 4 : 8);  // row stride
  static constexpr int TILE = BK * SK;                      // elements
  static size_t smem(int S) {
    const int nt = (S + BK - 1) / BK;
    return sizeof(T) * (size_t)(BQ * SK + 4 * TILE) +
           sizeof(float) * (size_t)nt * BK + sizeof(int) * (size_t)nt;
  }
};

// rows [s0, s0 + n) of a [S, D] view with row stride ss -> dst [n][SK],
// zero past S
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          long long ss, int s0, int n, int S,
                                          bool vec) {
  using C = Cfg<T, D>;
  constexpr int CH = D / C::VEC;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < n * CH; i += THREADS) {
    const int r = i / CH, dc = (i % CH) * C::VEC, s = s0 + r;
    T* d = dst + r * C::SK + dc;
    const bool ok = s < S;
    if (vec) {
      srt::cp_async16(d, ok ? src + s * ss + dc : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < C::VEC; ++e)
        d[e] = ok ? src[s * ss + dc + e] : from_f32<T>(0.f);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd(FlashArgs a) {
  using C = Cfg<T, D>;
  constexpr bool SPLIT = C::SPLIT;
  constexpr int KS = D / 8;  // k-steps of Q.K^T, n-tiles of P.V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BQ][SK]
  T* Ks = Qs + BQ * C::SK;                 // [2][BK][SK]
  T* Vs = Ks + 2 * C::TILE;                // [2][BK][SK]
  float* kbias = reinterpret_cast<float*>(Vs + 2 * C::TILE);  // visible keys
  __shared__ int s_any_q, s_ntiles;

  const int bh = blockIdx.y;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c4 = lane & 3;
  const int S = a.S;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  // K tiles this Q tile can see (window / causal clip)
  const int q_last = min(q0 + BQ, S) - 1;
  int k_lo = 0, k_hi = S - 1;
  const int half = a.window / 2;
  if (a.window > 0) {
    k_lo = max(q0 - half, 0);
    k_hi = min(q_last + half, S - 1);
  }
  if (a.causal) k_hi = min(k_hi, q_last);
  const int t_lo = k_lo / BK, t_hi = k_hi / BK;
  const int nvis = t_hi - t_lo + 1;
  const int key0 = t_lo * BK;  // first key of the visible range
  int* tiles = reinterpret_cast<int*>(kbias + nvis * BK);  // flags, list

  // the mask row, read once: additive key bias (log2 domain) and flags
  for (int i = tid; i < nvis; i += THREADS) tiles[i] = a.mask == nullptr;
  if (tid == 0) s_any_q = a.mask == nullptr;
  __syncthreads();
  if (a.mask != nullptr) {
    const int32_t* m = a.mask + (long long)b * S;
    for (int j = key0 + tid; j < key0 + nvis * BK; j += THREADS) {
      const int real = j < S ? m[j] != 0 : 0;
      kbias[j - key0] = real ? 0.f : NEG_INF * LOG2E;
      if (real) {
        tiles[j / BK - t_lo] = 1;  // benign race: every writer stores 1
        if (j >= q0 && j <= q_last) s_any_q = 1;
      }
    }
  } else {
    for (int j = tid; j < nvis * BK; j += THREADS) kbias[j] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {  // compact the flagged tiles into a visit list, in order
    int n = 0;
    for (int i = 0; i < nvis; ++i)
      if (tiles[i]) tiles[n++] = t_lo + i;
    s_ntiles = n;
  }
  __syncthreads();
  const int ntiles = s_ntiles;

  if (!s_any_q || ntiles == 0) {  // no real query here: finite zeros
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int r = i / D, d = i % D;
      if (q0 + r < S) o[(q0 + r) * a.o_ss + d] = from_f32<T>(0.f);
    }
    return;
  }

  // Q and the first K/V tile form the first cp.async group
  const bool vec = a.vec;
  load_rows<T, D>(Qs, q, a.q_ss, q0, BQ, S, vec);
  load_rows<T, D>(Ks, k, a.k_ss, tiles[0] * BK, BK, S, vec);
  load_rows<T, D>(Vs, v, a.v_ss, tiles[0] * BK, BK, S, vec);
  srt::cp_async_commit();

  // this warp's 16 query rows (g and g + 8 of its fragments); Q stays in
  // shared memory and is split at each use, which leaves registers for
  // four blocks an SM
  const T* qw = Qs + (warp * 16 + g) * C::SK + c4;

  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const float sl2 = a.scale * LOG2E;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1;
    if (it + 1 < ntiles) {  // the other stage was freed at the end of it-1
      const int s1 = tiles[it + 1] * BK;
      load_rows<T, D>(Ks + (st ^ 1) * C::TILE, k, a.k_ss, s1, BK, S, vec);
      load_rows<T, D>(Vs + (st ^ 1) * C::TILE, v, a.v_ss, s1, BK, S, vec);
    }
    srt::cp_async_commit();
    srt::cp_async_wait<1>();  // tile it has landed
    __syncthreads();

    const int k0 = tiles[it] * BK;
    const T* Kt = Ks + st * C::TILE;
    const T* Vt = Vs + st * C::TILE;

    // S = Q . K^T for 16 rows x BK keys: NT n-tiles of 8 keys
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ab[4], as[4];
      const T* p = qw + ks * 8;
      srt::split_tf32<SPLIT>(to_f32(p[0]), ab[0], as[0]);
      srt::split_tf32<SPLIT>(to_f32(p[8 * C::SK]), ab[1], as[1]);
      srt::split_tf32<SPLIT>(to_f32(p[4]), ab[2], as[2]);
      srt::split_tf32<SPLIT>(to_f32(p[8 * C::SK + 4]), ab[3], as[3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T* kr = Kt + (n * 8 + g) * C::SK + ks * 8 + c4;
        uint32_t bb[2], bs[2];
        srt::split_tf32<SPLIT>(to_f32(kr[0]), bb[0], bs[0]);
        srt::split_tf32<SPLIT>(to_f32(kr[4]), bb[1], bs[1]);
        srt::mma_f32<SPLIT>(sc[n], ab, as, bb, bs);
      }
    }

    // scale, key bias, window / causal / ragged-edge replacement; row max
    const float* kb = kbias + (k0 - key0);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = n * 8 + 2 * c4 + (e & 1), j = k0 + jl;
        const int i = e < 2 ? row_a : row_b;
        float s = fmaf(sc[n][e], sl2, kb[jl]);
        if (j >= S || (a.window > 0 && abs(i - j) > half) ||
            (a.causal && j > i))
          s = NEG_INF * LOG2E;
        sc[n][e] = s;
        if (e < 2) mx_a = fmaxf(mx_a, s);
        else mx_b = fmaxf(mx_b, s);
      }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = exp2f(m_a - mn_a), corr_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[n][e] - (e < 2 ? mn_a : mn_b));
        sc[n][e] = p;
        if (e < 2) sum_a += p;
        else sum_b += p;
      }
    l_a = l_a * corr_a + sum_a;  // this lane's share; summed at the end
    l_b = l_b * corr_b + sum_b;
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      acc[n][0] *= corr_a;
      acc[n][1] *= corr_a;
      acc[n][2] *= corr_b;
      acc[n][3] *= corr_b;
    }

    // O += P . V: key group n's K order (2c, 2c+1) -> fragment (c, c+4)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t pb[4], ps[4];
      srt::split_tf32<SPLIT>(sc[n][0], pb[0], ps[0]);
      srt::split_tf32<SPLIT>(sc[n][2], pb[1], ps[1]);
      srt::split_tf32<SPLIT>(sc[n][1], pb[2], ps[2]);
      srt::split_tf32<SPLIT>(sc[n][3], pb[3], ps[3]);
      const T* vr = Vt + (n * 8 + 2 * c4) * C::SK + g;
#pragma unroll
      for (int nd = 0; nd < KS; ++nd) {
        uint32_t bb[2], bs[2];
        srt::split_tf32<SPLIT>(to_f32(vr[nd * 8]), bb[0], bs[0]);
        srt::split_tf32<SPLIT>(to_f32(vr[C::SK + nd * 8]), bb[1], bs[1]);
        srt::mma_f32<SPLIT>(acc[nd], pb, ps, bb, bs);
      }
    }
    __syncthreads();  // every warp is done with stage st
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.f / fmaxf(l_a, 1e-20f);  // fully-masked rows
  const float inv_b = 1.f / fmaxf(l_b, 1e-20f);  // stay finite
#pragma unroll
  for (int nd = 0; nd < KS; ++nd) {
    const int d = nd * 8 + 2 * c4;
    if (row_a < S) {
      T* orow = o + row_a * a.o_ss + d;
      orow[0] = from_f32<T>(acc[nd][0] * inv_a);
      orow[1] = from_f32<T>(acc[nd][1] * inv_a);
    }
    if (row_b < S) {
      T* orow = o + row_b * a.o_ss + d;
      orow[0] = from_f32<T>(acc[nd][2] * inv_b);
      orow[1] = from_f32<T>(acc[nd][3] * inv_b);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const FlashArgs& a, int B, cudaStream_t stream) {
  const size_t smem = Cfg<T, D>::smem(a.S);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  static size_t reserved = 0;  // a race only repeats the call
  if (smem > 48 * 1024 && smem > reserved) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
    reserved = smem;
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
  if (S <= 0 || B <= 0 || H <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long vec = dtype == 1 ? srt::vec_elems<__nv_bfloat16>()
                                   : srt::vec_elems<float>();
  const long long strides[] = {q_sb, q_sh, q_ss, k_sb, k_sh,
                               k_ss, v_sb, v_sh, v_ss};
  a.vec = srt::aligned16(q) && srt::aligned16(k) && srt::aligned16(v);
  for (long long s : strides) a.vec = a.vec && s % vec == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 1 ? dispatch_d<__nv_bfloat16>(a, B, D, st)
                             : dispatch_d<float>(a, B, D, st);
  return (int)e;
}
