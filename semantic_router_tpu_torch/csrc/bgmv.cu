// BGMV (batched gather matrix-vector) for Hopper (sm_90a), hand-written
// CUDA C++, as a task-grouped segmented GEMM (the SGMV shape of Punica).
//
// Replaces the TPU kernel semantic_router_tpu/ops/bgmv.py::bgmv_pallas
// (body _bgmv_kernel):
//     out[p, :] = x[p, :] @ W[idx[p], :, :]
// for x [P, D], W [T, D, H], idx [P] int32; accumulated in float32 and
// stored in x's dtype.  The Pallas kernel runs one program per pair and
// gathers that pair's [D, H] slab through a scalar-prefetched BlockSpec
// index map: one slab read per pair.
//
// What bounds it on the H100: 2 FLOPs per weight element and pair, far
// below the card's ridge, so the bytes are the weights, and the least the
// card can read is each DISTINCT task's slab once (D = H = 768 f32: 2.36
// MB a task).  The engine sends pairs row-major (row 0: tasks 0..k, row 1:
// tasks 0..k, ...) padded to a power of two with dummies on task 0, so
// neighbouring pairs almost never share a task: a kernel that walks pairs
// in order reads a slab per pair.
// What this design does about it:
//   - Grouping on the device, inside the one launch and without scratch
//     or a host sync: every block reads idx once into shared memory (a
//     key per pair) and counts each task's pairs; a scan of the counts
//     writes the table of work units, CHUNK = 16 pairs of one task in pair
//     order (ranks [first, first + n) of its task).  Each consumer warp
//     finds its unit's pairs with a ballot scan over the keys, so a
//     segment's pairs are summed in a fixed order; a one-warp stable
//     scatter of all pairs, the alternative, is a long serial chain.
//   - A work item is (unit, column tile), a tile being one 128-byte band
//     of W's columns (32 f32 or 64 bf16).  A persistent grid of C blocks
//     (as many as the card holds at once, or fewer when the pairs can form
//     fewer items) takes items b, b + C, ...  The item's W band is read
//     once over all of D and applied to all its pairs, so a task with <= 16
//     pairs reads its slab from device memory once, dummy pairs on task 0
//     cost FLOPs and not bytes, and tasks with no pair make no item.  A
//     longer segment splits into units on separate blocks (a hot task
//     still fills the card), which share its slab through L2.  Narrow
//     bands give 24 items per unit at H = 768 f32: 192 busy blocks at the
//     router mix (5 tasks, 8 units).
//   - Warp specialisation: one producer warp streams the W band through a
//     ring of STAGES 128-row boxes by the Tensor Memory Accelerator (a
//     [T, D, H] tensor map: rows past D and columns past H land as zeros;
//     one box a stage, completing on an mbarrier), starting as soon as the
//     unit table exists.  Eight consumer warps split each stage's k steps;
//     each loads the x columns of its own steps by cp.async into its own
//     ring, STAGES - 1 stages ahead.  On this card the issue, not the
//     bytes, limits the other ways to move these tiles: W by 16-byte
//     cp.async stalls under load, a bulk copy per 512-byte row is slow to
//     issue, and one warp gathering x for all eight starves them.
//   - No cross-block reduction: an item's partial sums (one per consumer
//     warp) meet in shared memory and are added in warp order.  No
//     atomics: two launches give the same bits.  (Splitting D over a
//     thread block cluster would cost a cluster barrier per item, which
//     the ranks' skew makes long.)
//   - Tensor cores: the unit's 16 pairs are the M of mma.sync: m16n8k8
//     with the 3xTF32 split of csrc/tf32x3.cuh for f32 (float32 accuracy,
//     the small terms in their own accumulator), m16n8k16 for bf16.  A
//     branch around mma.sync makes the compiler wrap every MMA in a
//     convergence sequence, so all four n-tiles always run.  W boxes are
//     128-byte swizzled: a warp's fragment reads hit at most 2 ways of a
//     bank (f32) or none (bf16).
//   - Ragged P, D and H edges are masked; a misaligned or odd-width
//     operand takes element copies into the same layouts.
//   - An index outside [0, T) is never dereferenced: those pairs form
//     units of their own that read no weight and write NaN rows.
//   - One launch groups up to 2048 pairs over 1024 tasks (its tables live
//     in shared memory); larger calls loop over pair slices and task
//     windows on the host, on the same stream.
// What bounds it now (PERF.md has the times): the bytes at the tenant mix
// and the full fan-out; at the router mix and the classifier call, the
// fixed chain of one launch (count, scan, pair search, first tiles) and,
// per item, the six 128-row stages of one block.

#include <atomic>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int CHUNK = 16;              // pairs per work unit: the MMA's M
constexpr int KT = 128;                // D rows per pipeline stage
constexpr int BAND = 128;              // bytes of a W row per TMA box
constexpr int BOX = KT * BAND;         // bytes of one box in shared memory
constexpr int PAIRS_PER_LAUNCH = 2048; // pairs one launch sorts
constexpr int TASKS_PER_LAUNCH = 1024; // tasks one launch counts
// units one launch can form: sum over bins of ceil(count / CHUNK)
constexpr int MAX_UNITS =
    (PAIRS_PER_LAUNCH + (CHUNK - 1) * (TASKS_PER_LAUNCH + 1)) / CHUNK;
constexpr int MAX_D = 4096;
constexpr int MAX_P = 65535;

template <typename T> struct Tile;
template <> struct Tile<float> {
  static constexpr int KSTEP = 8;      // m16n8k8
};
template <> struct Tile<__nv_bfloat16> {
  static constexpr int KSTEP = 16;     // m16n8k16
};

// The block: NCW consumer warps and one producer warp; a column tile is
// one 128-byte band of W (32 float32 or 64 bfloat16 columns).  Consumer
// warp cw owns the 32 columns of group cw % NCG and, of every stage, the
// k steps with step % KSPLIT == cw / NCG, and loads the x columns of those
// steps itself.  Shared memory: the W ring (1024-byte aligned boxes), the
// warps' x rings, the warps' partial sums (the count before the first
// item), the pairs' keys, the unit table.
template <typename T> struct Plan {
  static constexpr int ES = (int)sizeof(T);
  static constexpr int TN = BAND / ES;  // columns per tile: one box
  static constexpr int NCW = 8;
  static constexpr int NCG = TN / 32;
  static constexpr int KSPLIT = NCW / NCG;
  static constexpr int NT = (NCW + 1) * 32;
  static constexpr int STAGES = 3;
  static constexpr int STEPS = KT / Tile<T>::KSTEP;  // k steps a stage
  // a warp's x columns of a stage: STEPS / KSPLIT steps of KSTEP, padded
  // to 80-byte rows (bank 20g + c for a fragment's 32 reads)
  static constexpr int XW = STEPS / KSPLIT * Tile<T>::KSTEP;
  static constexpr int XS = XW + 16 / ES;
  static constexpr int XSLOT = CHUNK * XS * ES;        // bytes, one warp
  static constexpr int RS = TN + 4;    // partial-sum row stride (floats)
  static constexpr int WRING = STAGES * BOX;
  static constexpr int XRING = (STAGES * NCW * XSLOT + 127) / 128 * 128;
  static constexpr int COUNT = (TASKS_PER_LAUNCH + 1) * (int)sizeof(int);
  static constexpr int SUMS = KSPLIT * CHUNK * RS * (int)sizeof(float);
  static constexpr int RED = ((SUMS > COUNT ? SUMS : COUNT) + 15) / 16 * 16;
  static constexpr int KEYS = PAIRS_PER_LAUNCH * (int)sizeof(short);
  static constexpr int UTAB = MAX_UNITS * (int)sizeof(unsigned);
  static constexpr int BYTES = WRING + XRING + RED + KEYS + UTAB;
  static constexpr int ALLOC = BYTES + 1024;  // room to align the base
  static_assert(NCW % NCG == 0 && STEPS % KSPLIT == 0, "even splits");
};

// the byte of element (r, c) of a W box: 128-byte row r, its 16-byte
// chunk swizzled by r % 8 (the TMA's SWIZZLE_128B layout)
template <typename T>
__device__ __forceinline__ int wbyte(int r, int c) {
  const int b = c * (int)sizeof(T);
  return r * BAND + (((b >> 4) ^ (r & 7)) << 4) + (b & 15);
}

// a unit: its bin (task - t_lo, or nbins for out-of-range indices), its
// pair count and the rank of its first pair in the bin, in one word
__device__ __forceinline__ unsigned pack_unit(int bin, int n, int first) {
  return ((unsigned)bin << 21) | ((unsigned)n << 16) | (unsigned)first;
}

// -- Hopper's tensor memory accelerator and mbarriers ------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// the one arrival of a stage, announcing the bytes its copies will land
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// waits for the phase of `bar` with this parity; a stage that never lands
// (a byte count that does not match its copies) traps instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 24)) __trap();
  }
}

// one box of the 3-d tensor map at (column, row, task) into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// a barrier among the consumer warps alone (the producer keeps streaming)
template <int THREADS> __device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// d += a * b, bf16 operands, float32 accumulator (m16n8k16; fragment
// layout as m16n8k8's in tf32x3.cuh with two k values per register)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack2(const unsigned char* lo,
                                          const unsigned char* hi) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(lo) |
         ((uint32_t)*reinterpret_cast<const uint16_t*>(hi) << 16);
}

// A persistent grid of C blocks; block b takes items b, b + C, ...  idx,
// x and out start at this launch's pair slice; tasks [t_lo, t_lo + nbins)
// are this launch's; with `bad` set, pairs outside [0, nT) are counted in
// one more bin, whose units write NaN.  VEC: x and W are 16-byte aligned
// with rows of 16-byte multiples, W tiles arrive by TMA through `wmap` and
// x rows by cp.async; otherwise the producer warp copies elements (wmap
// unused).
template <typename T, bool VEC>
__global__ void __launch_bounds__(Plan<T>::NT)
bgmv_sgmv_kernel(const __grid_constant__ CUtensorMap wmap,
                 const T* __restrict__ x, const T* __restrict__ w,
                 const int* __restrict__ idx, T* __restrict__ out, int P,
                 int D, int H, int nT, int t_lo, int nbins, int bad) {
  using PL = Plan<T>;
  constexpr int NT = PL::NT, NCW = PL::NCW, NCG = PL::NCG, TN = PL::TN;
  constexpr int KSPLIT = PL::KSPLIT, STAGES = PL::STAGES, ES = PL::ES;
  constexpr int XS = PL::XS, RS = PL::RS;
  extern __shared__ __align__(1024) unsigned char smem_base[];
  // the swizzled boxes need 1024-byte alignment
  unsigned char* smem =
      smem_base + ((1024u - (smem_u32(smem_base) & 1023u)) & 1023u);
  unsigned char* wring = smem;
  T* xring = reinterpret_cast<T*>(smem + PL::WRING);
  float* red = reinterpret_cast<float*>(smem + PL::WRING + PL::XRING);
  short* keys =
      reinterpret_cast<short*>(smem + PL::WRING + PL::XRING + PL::RED);
  unsigned* utab = reinterpret_cast<unsigned*>(
      smem + PL::WRING + PL::XRING + PL::RED + PL::KEYS);
  int* hist = reinterpret_cast<int*>(red);  // before the first item
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // each consumer warp's pair lists of the items it has in flight (the x
  // loads run up to STAGES - 1 stages, so up to 2 items, ahead)
  __shared__ int pairs_of[NCW][4][CHUNK];
  __shared__ int s_units;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = nbins + (bad ? 1 : 0);
  const int ncol = (H + TN - 1) / TN;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);  // the producer's arrival with the bytes
      mbar_init(&empty[i], NCW);
    }
    fence_barrier_init();
  }

  // -- the count: a key per pair, pairs per bin ------------------------------
  for (int b = tid; b < nb; b += NT) hist[b] = 0;
  __syncthreads();
  for (int base = 0; base < P; base += 8 * NT) {
    int t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // eight loads in flight per thread
      const int p = base + j * NT + tid;
      t[j] = p < P ? idx[p] : 0;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = base + j * NT + tid;
      if (p >= P) break;
      int key = -1;
      if (t[j] >= t_lo && t[j] - t_lo < nbins)
        key = t[j] - t_lo;
      else if (bad && (t[j] < 0 || t[j] >= nT))
        key = nbins;
      keys[p] = (short)key;
      if (key >= 0) atomicAdd(&hist[key], 1);
    }
  }
  __syncthreads();

  // -- scan: the unit table --------------------------------------------------
  if (warp == 0) {
    int unit_base = 0;
    for (int b0 = 0; b0 < nb; b0 += 32) {
      const int b = b0 + lane;
      const int cnt = b < nb ? hist[b] : 0;
      const int nu = (cnt + CHUNK - 1) / CHUNK;
      int iu = nu;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, iu, o);
        if (lane >= o) iu += v;
      }
      const int ub = unit_base + iu - nu;
      for (int c = 0; c < nu; ++c)
        utab[ub + c] = pack_unit(b, min(CHUNK, cnt - c * CHUNK), c * CHUNK);
      unit_base += __shfl_sync(0xffffffffu, iu, 31);
    }
    if (lane == 0) s_units = unit_base;
  }
  __syncthreads();

  const int items = s_units * ncol;
  const int mine = (int)blockIdx.x < items
                       ? (items - (int)blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;
  const int nk = (D + KT - 1) / KT;  // k-tiles of an item
  const int total = mine * nk;
  if (total == 0) return;

  struct Item {
    int n0, bin, n, first;
  };
  auto item = [&](int j) {
    const int i = blockIdx.x + j * gridDim.x;
    const int unit = i / ncol;
    const unsigned u = utab[unit];
    return Item{(i - unit * ncol) * TN, (int)(u >> 21), (int)((u >> 16) & 31),
                (int)(u & 0xffff)};
  };

  // The producer warp's stage q (k-tile kt of item `it`): its W tile,
  // arriving on full[q % STAGES] with the tile's bytes.  Rows past D and
  // columns past H come back as zeros.
  auto fill_w = [&](int q, const Item& it, int kt) {
    const bool live = it.bin < nbins;  // NaN units read nothing
    const int k0 = kt * KT;
    unsigned char* ws = wring + (q % STAGES) * BOX;
    uint64_t* bar = &full[q % STAGES];
    if constexpr (VEC) {
      if (lane == 0) {
        mbar_arrive_tx(bar, live ? BOX : 0);
        if (live) tma_load(ws, &wmap, it.n0, k0, t_lo + it.bin, bar);
      }
    } else {
      const T zero = srt::from_f32<T>(0.f);
      const T* wt = w + ((long long)t_lo + (live ? it.bin : 0)) * D * H;
      for (int i = lane; i < KT * TN; i += 32) {
        const int r = i / TN, c = i % TN, d = k0 + r, n = it.n0 + c;
        *reinterpret_cast<T*>(ws + wbyte<T>(r, c)) =
            live && d < D && n < H ? wt[(long long)d * H + n] : zero;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive_tx(bar, 0);
    }
  };

  if (warp == NCW) {  // the producer: stages in order, a slot refilled
    // once every consumer warp is done with it (it needs only the units)
    Item it = item(0);
    for (int q = 0, j = 0, kt = 0; q < total; ++q) {
      if (q >= STAGES)
        mbar_wait(&empty[q % STAGES], (uint32_t)(q / STAGES - 1) & 1u);
      fill_w(q, it, kt);
      if (++kt == nk && ++j < mine) {
        kt = 0;
        it = item(j);
      }
    }
    return;
  }

  // -- the consumer warps -----------------------------------------------------
  const int g = lane >> 2, c4 = lane & 3;
  const int wn = (warp % NCG) * 32, kw = warp / NCG;
  constexpr int V = srt::vec_elems<T>(), KSTEP = Tile<T>::KSTEP;
  static_assert(PL::XW / V == 4, "four 16-byte pieces per x row");
  static_assert(STAGES - 1 <= 3, "the pair lists hold 4 items");

  // Item j's pairs, in row order, into pairs_of[warp][j % 4]: the ranks
  // [first, first + n) of its bin's pairs, found by a ballot scan over the
  // keys in pair order (-1 past the unit's pairs).
  auto find_pairs = [&](int j) {
    const Item it = item(j);
    int* list = pairs_of[warp][j & 3];
    if (lane < CHUNK) list[lane] = -1;
    __syncwarp();
    const int hi = it.first + it.n;
    for (int p0 = 0, run = 0; p0 < P && run < hi; p0 += 32) {
      const int p = p0 + lane;
      const bool mine_p = p < P && keys[p] == it.bin;
      const unsigned bal = __ballot_sync(0xffffffffu, mine_p);
      const int r = run + __popc(bal & ((1u << lane) - 1u));
      if (mine_p && r >= it.first && r < hi) list[r - it.first] = p;
      run += __popc(bal);
    }
    __syncwarp();
    return it;
  };

  // This warp's x columns of stage q, issued STAGES - 1 stages ahead into
  // its own ring: lane l copies 16 bytes of rows l / 4 and l / 4 + 8, at
  // piece l % 4 (two pieces per k step).  Columns past D and rows past the
  // unit's pairs are zeros.
  int xq = 0, xj = 0, xkt = 0;
  const T* xrow[2];
  auto x_rows = [&](int j) {
    const Item it = find_pairs(j);
    for (int h = 0; h < 2; ++h) {
      const int p = pairs_of[warp][j & 3][g + 8 * h];
      xrow[h] = it.bin < nbins && p >= 0 ? x + (long long)p * D : nullptr;
    }
  };
  auto issue_x = [&]() {
    T* xs = xring + ((xq % STAGES) * NCW + warp) * (CHUNK * XS);
    const int e = c4 >> 1, half = c4 & 1;
    const int k = xkt * KT + (kw + e * KSPLIT) * KSTEP + half * V;
    const int col = e * KSTEP + half * V;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      T* dst = xs + (g + 8 * h) * XS + col;
      if constexpr (VEC) {
        const bool ok = xrow[h] != nullptr && k < D;
        srt::cp_async16(dst, ok ? xrow[h] + k : x, ok);
      } else {
        for (int v = 0; v < V; ++v)
          dst[v] = xrow[h] != nullptr && k + v < D ? xrow[h][k + v]
                                                   : srt::from_f32<T>(0.f);
      }
    }
    srt::cp_async_commit();
    ++xq;
    if (++xkt == nk && ++xj < mine) {
      xkt = 0;
      x_rows(xj);
    }
  };
  x_rows(0);
  for (int q = 0; q < STAGES - 1; ++q) {
    if (q < total)
      issue_x();
    else
      srt::cp_async_commit();
  }

  float acc[4][4], acs[4][4];  // big*big, and the small terms of 3xTF32
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = acs[j][e] = 0.f;
  // this lane's B-fragment bytes in a W box: rows c4 (+4) for f32, 2 c4
  // (+1) for bf16, past a k step's first row (a multiple of 8, so a row's
  // swizzle r % 8 is fixed per lane)
  int boff[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      boff[j][e] = ES == 4 ? wbyte<T>(c4 + 4 * e, wn + 8 * j + g)
                           : wbyte<T>(2 * c4 + e, wn + 8 * j + g);

  // every warp runs all four n-tiles: mma.sync is warp-collective, and a
  // branch around it (even a warp-uniform one the compiler cannot prove)
  // wraps each MMA in a convergence sequence; columns past H are zeros
  auto compute = [&](int slot) {
    const unsigned char* ws = wring + slot * BOX;
    const T* xs = xring + (slot * NCW + warp) * (CHUNK * XS);
#pragma unroll
    for (int e = 0; e < PL::STEPS / KSPLIT; ++e) {
      const unsigned char* wk = ws + (kw + e * KSPLIT) * KSTEP * BAND;
      const int kk = e * KSTEP;  // in this warp's x columns
      if constexpr (ES == 4) {
        uint32_t ab[4], as[4];
        srt::split_tf32<true>(xs[g * XS + kk + c4], ab[0], as[0]);
        srt::split_tf32<true>(xs[(g + 8) * XS + kk + c4], ab[1], as[1]);
        srt::split_tf32<true>(xs[g * XS + kk + c4 + 4], ab[2], as[2]);
        srt::split_tf32<true>(xs[(g + 8) * XS + kk + c4 + 4], ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bb[2], bs[2];
          srt::split_tf32<true>(
              *reinterpret_cast<const float*>(wk + boff[j][0]), bb[0], bs[0]);
          srt::split_tf32<true>(
              *reinterpret_cast<const float*>(wk + boff[j][1]), bb[1], bs[1]);
          srt::mma_tf32(acs[j], as, bb);
          srt::mma_tf32(acs[j], ab, bs);
          srt::mma_tf32(acc[j], ab, bb);
        }
      } else {
        const int k = kk + 2 * c4;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(xs + g * XS + k);
        a[1] = *reinterpret_cast<const uint32_t*>(xs + (g + 8) * XS + k);
        a[2] = *reinterpret_cast<const uint32_t*>(xs + g * XS + k + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(xs + (g + 8) * XS + k + 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b[2];
          b[0] = pack2(wk + boff[j][0], wk + boff[j][1]);
          b[1] = pack2(wk + 8 * BAND + boff[j][0], wk + 8 * BAND + boff[j][1]);
          mma_bf16(acc[j], a, b);
        }
      }
    }
  };

  for (int s = 0; s < total; ++s) {
    if (s + STAGES - 1 < total)  // its slot held stage s - 1, done above
      issue_x();
    else
      srt::cp_async_commit();
    srt::cp_async_wait<STAGES - 1>();  // this warp's x of stage s is in
    __syncwarp();
    mbar_wait(&full[s % STAGES], (uint32_t)(s / STAGES) & 1u);
    compute(s % STAGES);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s % STAGES]);
    const int j = s / nk;
    if (s - j * nk != nk - 1) continue;

    // the item's last k-tile: the warps' partial sums meet in shared
    // memory and are added in warp order; the producer keeps loading the
    // next item's tiles meanwhile
    const Item it = item(j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* dst = red + (kw * CHUNK + g + 8 * h) * RS + wn + 2 * c4;
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        *reinterpret_cast<float2*>(dst + q4 * 8) =
            make_float2(acc[q4][2 * h] + acs[q4][2 * h],
                        acc[q4][2 * h + 1] + acs[q4][2 * h + 1]);
        acc[q4][2 * h] = acc[q4][2 * h + 1] = 0.f;
        acs[q4][2 * h] = acs[q4][2 * h + 1] = 0.f;
      }
    }
    consumers_sync<NCW * 32>();
    const bool nan_unit = it.bin == nbins;
    for (int i = tid; i < CHUNK * (TN / 4); i += NCW * 32) {
      const int r = i / (TN / 4), c = (i % (TN / 4)) * 4;
      const int p = pairs_of[warp][j & 3][r], n = it.n0 + c;
      if (p < 0 || n >= H) continue;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q4 = 0; q4 < KSPLIT; ++q4) {
        const float4 u =
            *reinterpret_cast<const float4*>(red + (q4 * CHUNK + r) * RS + c);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      if (nan_unit) v.x = v.y = v.z = v.w = __int_as_float(0x7fc00000);
      T* o = out + (long long)p * H + n;
      o[0] = srt::from_f32<T>(v.x);
      if (n + 1 < H) o[1] = srt::from_f32<T>(v.y);
      if (n + 2 < H) o[2] = srt::from_f32<T>(v.z);
      if (n + 3 < H) o[3] = srt::from_f32<T>(v.w);
    }
    consumers_sync<NCW * 32>();  // the partial sums are read
  }
}

// -- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's tensor-map encoder, through the runtime (no link to libcuda)
EncodeTiled encoder() {
  static std::atomic<void*> fn{nullptr};
  void* f = fn.load();
  if (f == nullptr) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn.store(f);
  }
  return reinterpret_cast<EncodeTiled>(f);
}

// W [T, D, H] as a 3-d tensor map of 32-row x 128-byte boxes, swizzled
template <typename T>
cudaError_t weight_map(CUtensorMap* map, const T* w, int nT, int D, int H) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)H, (cuuint64_t)D, (cuuint64_t)nT};
  const cuuint64_t strides[2] = {(cuuint64_t)H * sizeof(T),
                                 (cuuint64_t)D * H * sizeof(T)};
  const cuuint32_t box[3] = {BAND / sizeof(T), KT, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<T*>(w), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// blocks of one kernel instance the card holds at once, by device (the
// occupancy query, asked once)
constexpr int MAX_DEVICES = 16;

template <typename T, bool VEC>
cudaError_t launch_cfg(const CUtensorMap& map, const T* x, const T* w,
                       const int* idx, T* out, int P, int D, int H, int nT,
                       int t_lo, int nbins, int bad, int units,
                       cudaStream_t stream) {
  static std::atomic<int> resident[MAX_DEVICES];
  auto kernel = bgmv_sgmv_kernel<T, VEC>;
  constexpr int smem = Plan<T>::ALLOC;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int held = dev < MAX_DEVICES ? resident[dev].load() : 0;
  if (held <= 0) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      Plan<T>::NT, smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    held = per_sm * sms;
    if (held <= 0) return cudaErrorInvalidConfiguration;
    if (dev < MAX_DEVICES) resident[dev].store(held);
  }
  const long long items = (long long)units * ((H + Plan<T>::TN - 1) /
                                              Plan<T>::TN);
  kernel<<<(unsigned)(items < held ? items : held), Plan<T>::NT, smem,
           stream>>>(map, x, w, idx, out, P, D, H, nT, t_lo, nbins, bad);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* xv, const void* wv, const int* idx, void* ov,
                   int P, int D, int H, int nT, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  T* out = static_cast<T*>(ov);
  constexpr int V = srt::vec_elems<T>();
  const bool vec = D % V == 0 && H % V == 0 && srt::aligned16(x) &&
                   srt::aligned16(w);
  CUtensorMap map = {};
  if (vec) {
    cudaError_t e = weight_map<T>(&map, w, nT, D, H);
    if (e != cudaSuccess) return e;
  }
  for (int p0 = 0; p0 < P; p0 += PAIRS_PER_LAUNCH) {
    const int np = P - p0 < PAIRS_PER_LAUNCH ? P - p0 : PAIRS_PER_LAUNCH;
    for (int t_lo = 0; t_lo < nT; t_lo += TASKS_PER_LAUNCH) {
      const int nbins =
          nT - t_lo < TASKS_PER_LAUNCH ? nT - t_lo : TASKS_PER_LAUNCH;
      const int bad = t_lo == 0;
      // sum over bins of ceil(count / CHUNK) <= (np + (CHUNK - 1) * bins
      // holding a pair) / CHUNK
      const int held = nbins + bad < np ? nbins + bad : np;
      const int units = (np + (CHUNK - 1) * held) / CHUNK;
      const T* xs = x + (long long)p0 * D;
      T* os = out + (long long)p0 * H;
      const int* is = idx + p0;
      const cudaError_t e =
          vec ? launch_cfg<T, true>(map, xs, w, is, os, np, D, H, nT, t_lo,
                                    nbins, bad, units, stream)
              : launch_cfg<T, false>(map, xs, w, is, os, np, D, H, nT, t_lo,
                                     nbins, bad, units, stream);
      if (e != cudaSuccess) return e;
    }
  }
  return cudaSuccess;
}

}  // namespace

// x [P, D], w [T, D, H], idx [P] int32, out [P, H]; all contiguous, x, w
// and out of one dtype (0 = float32, 1 = bfloat16).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernel
// does not take (D > 4096, P > 65535).
extern "C" int srt_bgmv(const void* x, const void* w, const void* idx,
                        void* out, int P, int D, int H, int nT, int dtype,
                        void* stream) {
  if (P <= 0 || D <= 0 || H <= 0 || nT <= 0 || D > MAX_D || P > MAX_P)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  cudaError_t e =
      dtype == 1 ? launch<__nv_bfloat16>(x, w, ix, out, P, D, H, nT, st)
                 : launch<float>(x, w, ix, out, P, D, H, nT, st);
  return (int)e;
}
