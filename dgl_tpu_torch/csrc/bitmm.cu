// Bit-packed dense SpMM on Hopper: out = A @ x with the whole boolean
// adjacency A stored at 1 bit per entry.
//
// Packing (plane-major, shared with dgl_tpu/ops/pallas/bitmm.py:19-27):
// with n32 = N_pad / 32 words per row,
//
//     packed[k][j] bit b   <->   column b * n32 + j   of row k.
//
// Bit 31 is the int32 sign bit, so every word is read as uint32_t and
// every shift is unsigned.
//
// Two kernels, each behind a plain C function that launches on the
// caller's stream, allocates nothing and returns cudaGetLastError():
//
// K1  bit_matmul_t_kernel<W, VEC, CPL>  replaces dgl_tpu/ops/pallas/bitmm.py
//     _bit_matmul_t :298 (body _bit_kernel_t :264).  Input: packed_t, the
//     bits of A^T (rows = src, bit planes = dst), and x (rows, F) f32 with
//     F <= 96.  A bit walk on an asynchronous word stream.  A block is one
//     producer warp and 16 consumer warps, one block an SM, persistent: the
//     (slab, row) units, a slab being W words of each row (the 32 W dst
//     nodes {b * n32 + j} of its words j), are cut into one equal run a
//     block, slab-major, so a block walks one or two slabs' row ranges.  The
//     producer keeps a ring of 4 stages of 128 rows x W words in flight,
//     each one TMA box (a W-word swizzle of the same width; rows and words
//     past the array read as zeros; loads marked evict-first), on an
//     mbarrier.  Each consumer warp takes an 8-byte pair of words of the
//     slab's rows and a range of their bit planes (all 32 at W = 32), the
//     next warp's part at the next stage, so that the words a graph's hubs
//     load pass through every warp in turn: a lane takes the pair of 4
//     rows of a stage into registers (the stage is
//     released at once), a warp prefix sum of popcounts gives each lane its
//     place, and the lane lists its set bits (the row, the dst) in the
//     warp's list in shared memory.  When the list holds 128 entries, or
//     the block's work ends, the whole warp gathers the listed x rows, 16
//     bytes a lane (F / 4 lanes an entry: 8 entries a step at F = 16), four
//     steps requested before the steps before them are added, and adds
//     each into out with a vector reduction in L2 (red.global.add.v4.f32):
//     no float shared atomics, and no owner, so the warps share the bits
//     evenly whatever the dst nodes' degrees.  A list that would
//     overflow (dense words) is drained first and the stage's bits listed
//     in pieces.  The sums meet in L2 in no fixed order.  The port's first
//     K1 gave a block a slab of 16 words read 64 bytes a row by 16 lanes,
//     added every set bit's x row with a float shared atomic per column,
//     and streamed its words at about 0.7 TB/s.  A design between the two
//     (each dst's sums in shared memory owned by one lane group, no
//     atomics) lost to both on the Reddit-statistics graph: its
//     communities and hubs put several times a slab's mean of bits on a
//     few word columns (chip_smoke.py's phase 7 logs the spread), and the
//     busiest group set the block's pace.
//
// K2  bit_matmul_kernel<VEC, CPL>  replaces dgl_tpu/ops/pallas/bitmm.py
//     _bit_matmul :371 (body _bit_kernel), the route for F > 96.  Input:
//     packed, the bits of A (rows = dst), and x (num_src, F) f32.
//     Gather form: one warp per dst row reads the row's words coalesced
//     (8 a lane a step, the next step's requested before this one's
//     work), turns their set bits into a list of src ids in shared memory
//     (a warp prefix sum of popcounts gives each lane its offset), then
//     gathers the listed rows U at a time, every load issued before any
//     add, with VEC-float loads (16 bytes where F allows; CPL vectors a
//     lane, up to 512 columns a warp) into registers, and writes its
//     columns once.  The port's first K2 loaded a row after each set bit
//     in turn, so each of a row's ~490 bits waited one L2 round trip.
//
// Bound on an H100 SXM (3.35 TB/s): both kernels must stream the whole
// bitmask, K_pad * n32 * 4 bytes; the arithmetic (nnz * F adds) is far
// below the card's rate.  chip_smoke.py prints the bound for the Reddit
// graph (6,933,184,512 bytes of bits: 2.08 ms for K1 at F = 16, 2.14 ms
// for K2 at F = 128, H100 80GB HBM3 at 700 W).  Design against that bound:
// bit words are read once, K1's by TMA in 128-byte runs (W = 32) with four
// 16 KB stages in flight a block, K2's coalesced with 8 words in flight a
// lane.  At Reddit density (0.21%) a word holds ~0.07 set bits, so the
// work per bit (a gather of the source row from L2, and an add into the
// dst's sum: K1 a reduction in L2, K2 in registers) is the other cost, and
// K1 keeps its words in flight while its lanes work on listed bits; it
// takes 8.46 ms at F = 16 on the Reddit graph (H100 80GB HBM3 at 700 W),
// its gathers and reductions (64 bytes each a set bit, 7.4 GB each) and
// its listing above the stream.  Neither kernel uses the tensor cores,
// since a 0/1 matrix at this density gives them nothing dense to do.
// The C function and launch parameters are chosen by
// dgl_tpu_torch/ops/kernels/bitmm.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;        // warps per block of K2
constexpr int kTConsumers = 16;  // K1: consumer warps a block
constexpr int kTThreads = (kTConsumers + 1) * 32;  // and the producer
constexpr int kTRows = 128;      // K1: rows of a stage
constexpr int kTWords = kTRows / 16;  // K1: words a lane takes of a stage
constexpr int kTStages = 4;      // K1: stages in the ring
constexpr int kTList = 256;      // K1: entries a warp's list holds
constexpr int kTDrainAt = 128;   // K1: a list this long is drained
constexpr int kStepWords = 8;    // K2: words a lane loads a step
constexpr int kBitList = 256;    // K2: src ids a warp lists at once

// A block's segment: rows r0 .. r1 - 1 of slab `slab`.
struct TSegment {
  int64_t slab, r0, r1;
};

// The next segment of the block's run of (slab, row) units [u, hi).
__device__ __forceinline__ TSegment next_segment(int64_t& u, int64_t hi,
                                                 int64_t rows) {
  TSegment s;
  s.slab = u / rows;
  s.r0 = u - s.slab * rows;
  s.r1 = min(rows, s.r0 + (hi - u));
  u += s.r1 - s.r0;
  return s;
}

// out[d, v VEC .. + VEC - 1] += the VEC floats of `val`, as one reduction
// in L2 (the address aligned to VEC floats).
template <int VEC>
__device__ __forceinline__ void red_add(float* a, const float (&val)[VEC]) {
  if constexpr (VEC == 4) {
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(a),
                 "f"(val[0]), "f"(val[1]), "f"(val[2]), "f"(val[3])
                 : "memory");
  } else if constexpr (VEC == 2) {
    asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(a),
                 "f"(val[0]), "f"(val[1])
                 : "memory");
  } else {
    asm volatile("red.global.add.f32 [%0], %1;" ::"l"(a), "f"(val[0])
                 : "memory");
  }
}

// Adds x's rows for a warp's `n` listed entries (s, d) into out: `lpe`
// lanes an entry (32 / lpe entries a step), each lane CPL vectors of VEC
// floats; U steps' rows are requested before the reductions of the U
// steps before them.
template <int VEC, int CPL>
__device__ __noinline__ void t_drain(const float* __restrict__ x, int f,
                                     float* __restrict__ out,
                                     int64_t num_dst, const int* list_s,
                                     const int64_t* list_d, int n, int lpe,
                                     int lane) {
  constexpr int U = 4;
  const int eps = 32 / lpe;  // entries a step
  const int le = lane / lpe, lv = lane % lpe;
  const int nv = f / VEC;
  float cur[U][CPL][VEC], nxt[U][CPL][VEC];
  int64_t dcur[U], dnxt[U];
  auto gather = [&](float (&v)[U][CPL][VEC], int64_t (&d)[U], int i0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = i0 + u * eps + le;
      const bool live = e < n;
      const int s = live ? list_s[e] : 0;
      const int64_t dd = live ? list_d[e] : num_dst;
      d[u] = dd < num_dst ? dd : -1;
      const float* xr = x + static_cast<int64_t>(s) * f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int vi = lv + lpe * c;
        const bool ok = d[u] >= 0 && vi < nv;
        if constexpr (VEC == 4) {
          const float4 t = ok ? __ldg(reinterpret_cast<const float4*>(xr) + vi)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
          v[u][c][0] = t.x; v[u][c][1] = t.y; v[u][c][2] = t.z;
          v[u][c][3] = t.w;
        } else if constexpr (VEC == 2) {
          const float2 t = ok ? __ldg(reinterpret_cast<const float2*>(xr) + vi)
                              : make_float2(0.f, 0.f);
          v[u][c][0] = t.x; v[u][c][1] = t.y;
        } else {
          v[u][c][0] = ok ? __ldg(xr + vi) : 0.f;
        }
      }
    }
  };
  const int step = U * eps;
  gather(cur, dcur, 0);
  for (int i0 = 0; i0 < n; i0 += step) {
    if (i0 + step < n) gather(nxt, dnxt, i0 + step);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (dcur[u] < 0) continue;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int vi = lv + lpe * c;
        if (vi < nv) red_add<VEC>(out + dcur[u] * f + vi * VEC, cur[u][c]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      dcur[u] = dnxt[u];
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int k = 0; k < VEC; ++k) cur[u][c][k] = nxt[u][c][k];
    }
  }
}

// K1 with a slab of W words, x read VEC floats at a time, CPL vectors a
// lane.  At a stage, each of the 16 consumers reads one 8-byte pair of each
// row (words 2 p, 2 p + 1 of the slab) and takes a range of their bit
// planes (all 32 when W = 32, else W of them), a part that passes to the
// next warp at the next stage.
template <int W, int VEC, int CPL>
__global__ void __launch_bounds__(kTThreads, 1)
bit_matmul_t_kernel(const __grid_constant__ CUtensorMap bits, int64_t n32,
                    const float* __restrict__ x, int64_t rows, int f,
                    float* __restrict__ out, int64_t num_dst, int lpe) {
  constexpr int kPairs = W / 2;                  // 8-byte pairs a row
  constexpr int kPlanes = 32 / (kTConsumers / kPairs);  // planes a warp
  constexpr int kTile = kTRows * W * 4;          // bytes of a stage
  extern __shared__ uint8_t t_smem[];
  __shared__ uint64_t full[kTStages], empty[kTStages];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(t_smem) + 1023) & ~uintptr_t(1023));
  int64_t* list_d = reinterpret_cast<int64_t*>(ring + kTStages * kTile);
  int* list_s = reinterpret_cast<int*>(list_d + kTConsumers * kTList);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTStages; ++s) {
      tma::bar_init(&full[s], 1);
      tma::bar_init(&empty[s], kTConsumers);
    }
    tma::fence_init();
  }
  __syncthreads();
  const int64_t slabs = (n32 + W - 1) / W;
  const int64_t total = slabs * rows;  // (slab, row) units, slab-major
  int64_t u = static_cast<int64_t>(blockIdx.x) * total / gridDim.x;
  const int64_t hi = (static_cast<int64_t>(blockIdx.x) + 1) * total /
                     gridDim.x;
  uint32_t it = 0;  // stages walked so far

  if (warp == kTConsumers) {  // the producer
    if (lane != 0) return;
    const uint64_t policy = tma::evict_first();
    while (u < hi) {
      const TSegment sg = next_segment(u, hi, rows);
      for (int64_t t0 = sg.r0; t0 < sg.r1; t0 += kTRows, ++it) {
        const int slot = it % kTStages;
        tma::wait(&empty[slot], ((it / kTStages) & 1) ^ 1);
        tma::arrive_expect(&full[slot], kTile);
        tma::load_2d(ring + slot * kTile, &bits,
                     static_cast<int>(sg.slab * W), static_cast<int>(t0),
                     &full[slot], policy);
      }
    }
    return;
  }

  int* my_s = list_s + warp * kTList;
  int64_t* my_d = list_d + warp * kTList;
  int len = 0;  // entries listed (warp-uniform)
  auto drain = [&]() {
    __syncwarp();
    t_drain<VEC, CPL>(x, f, out, num_dst, my_s, my_d, len, lpe, lane);
    len = 0;
    __syncwarp();
  };

  while (u < hi) {
    const TSegment sg = next_segment(u, hi, rows);
    for (int64_t t0 = sg.r0; t0 < sg.r1; t0 += kTRows, ++it) {
      const int slot = it % kTStages;
      // the warps take the (pair, planes) parts of the slab in turn, one
      // more a stage, so that no warp keeps the busiest words
      const int part = (warp + static_cast<int>(it % kTConsumers)) %
                       kTConsumers;
      const int pair = part % kPairs;
      const int plane0 = (part / kPairs) * kPlanes;
      const uint32_t wmask =
          kPlanes == 32 ? 0xffffffffu : ((1u << kPlanes) - 1u) << plane0;
      const int64_t j0 = sg.slab * W + pair * 2;  // the pair's first word
      tma::wait(&full[slot], (it / kTStages) & 1);
      const uint8_t* tile = ring + slot * kTile;
      const int valid = static_cast<int>(min(sg.r1 - t0, int64_t(kTRows)));
      // the lane's pair of words of rows lane, 32 + lane, ... of the tile
      uint32_t b[kTWords];
#pragma unroll
      for (int q = 0; q < kTRows / 32; ++q) {
        const int r = q * 32 + lane;
        uint2 v = make_uint2(0u, 0u);
        if (r < valid)
          v = *reinterpret_cast<const uint2*>(
              tile + tma::swizzled<W * 4>(r * W * 4 + pair * 8));
        b[2 * q] = v.x & wmask;
        b[2 * q + 1] = v.y & wmask;
      }
      __syncwarp();
      if (lane == 0) tma::arrive(&empty[slot]);  // the words are in hand
      int mine = 0;
#pragma unroll
      for (int i = 0; i < kTWords; ++i) mine += __popc(b[i]);
      int incl = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      const int tot = __shfl_sync(kFull, incl, 31);
      if (tot == 0) continue;
      // list them, in the order of lanes, rows, words and planes from the
      // lane's place; if the list would overflow (dense words), it is
      // drained first and the tile listed in pieces of a list, drained
      // between them, each lane going on from its first bit not yet listed
      if (len + tot > kTList) drain();
      uint32_t a[kTWords];
      unsigned live = 0;
#pragma unroll
      for (int i = 0; i < kTWords; ++i) {
        a[i] = b[i];
        live |= (a[i] != 0u ? 1u : 0u) << i;
      }
      int j = incl - mine;  // the lane's next index in the tile's entries
      for (int done = 0;;) {
        const int end = done + kTList - len;
        while (live && j < end) {
          const int i = __ffs(live) - 1;
          uint32_t w = 0;
#pragma unroll
          for (int k = 0; k < kTWords; ++k)
            if (k == i) w = a[k];
          const int p = __ffs(w) - 1;
          w &= w - 1u;
#pragma unroll
          for (int k = 0; k < kTWords; ++k)
            if (k == i) a[k] = w;
          if (w == 0u) live &= live - 1u;
          const int at = len + (j - done);
          my_s[at] = static_cast<int>(t0) + (i >> 1) * 32 + lane;
          my_d[at] = static_cast<int64_t>(p) * n32 + j0 + (i & 1);
          ++j;
        }
        const int listed = min(tot - done, kTList - len);
        len += listed;
        done += listed;
        if (done == tot) break;
        drain();
      }
      if (len >= kTDrainAt) drain();
    }
  }
  drain();
}

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static void add(float* a, T v) { a[0] += v; }
  __device__ static void store(float* p, const float* a) { p[0] = a[0]; }
};
template <>
struct Vec<2> {
  using T = float2;
  __device__ static T zero() { return make_float2(0.f, 0.f); }
  __device__ static void add(float* a, T v) {
    a[0] += v.x;
    a[1] += v.y;
  }
  __device__ static void store(float* p, const float* a) {
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
  }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void add(float* a, T v) {
    a[0] += v.x;
    a[1] += v.y;
    a[2] += v.z;
    a[3] += v.w;
  }
  __device__ static void store(float* p, const float* a) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
};

// K2 with VEC floats a load and CPL column vectors a lane: the warp's
// columns are vectors [blockIdx.y * 32 * CPL, (blockIdx.y + 1) * 32 * CPL)
// of the row.  A step takes the 32 * kStepWords words of the row that the
// lanes loaded in the step before (the next step's are requested first),
// lists the src ids of their set bits in the warp's shared buffer (each
// lane at its offset from a warp prefix sum of popcounts), then gathers
// the listed rows U at a time: U rows' loads are issued before any add.
// The walk waits on memory, not on issue: at most 64 registers a thread
// (4 blocks an SM) keep more warps in flight.
template <int VEC, int CPL>
__global__ void __launch_bounds__(kWarps * 32, 4)
bit_matmul_kernel(const uint32_t* __restrict__ packed, int64_t n32,
                  const float* __restrict__ x, int64_t num_src, int f,
                  float* __restrict__ out, int64_t num_dst) {
  using V = typename Vec<VEC>::T;
  constexpr int U = VEC * CPL <= 4 ? 8 : VEC * CPL <= 8 ? 4 : 2;
  __shared__ int lists[kWarps][kBitList];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (d >= num_dst) return;  // warp-uniform; no block-wide barrier below
  int* list = lists[warp];
  const int nv = f / VEC;
  int cv[CPL];
  bool ok[CPL];
  float acc[CPL][VEC];
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    cv[q] = (static_cast<int>(blockIdx.y) * CPL + q) * 32 + lane;
    ok[q] = cv[q] < nv;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[q][i] = 0.f;
  }

  const uint32_t* prow = packed + d * n32;
  uint32_t next[kStepWords];
#pragma unroll
  for (int u = 0; u < kStepWords; ++u) {
    const int64_t j = u * 32 + lane;
    next[u] = j < n32 ? __ldg(prow + j) : 0u;
  }
  for (int64_t j0 = 0; j0 < n32; j0 += 32 * kStepWords) {
    uint32_t word[kStepWords];
    int c = 0;  // this lane's set bits in the step
#pragma unroll
    for (int u = 0; u < kStepWords; ++u) {
      word[u] = next[u];
      c += __popc(word[u]);
      const int64_t j = j0 + 32 * kStepWords + u * 32 + lane;
      next[u] = j < n32 ? __ldg(prow + j) : 0u;
    }
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    const int first = incl - c;  // this lane's offset in the step's list
    // a row denser than kBitList bits a step is listed in pieces
    for (int p0 = 0; p0 < total; p0 += kBitList) {
      const int lim = p0 + kBitList;
      int idx = first;
#pragma unroll
      for (int u = 0; u < kStepWords; ++u) {
        uint32_t bits = word[u];
        const int pc = __popc(bits);
        if (idx + pc <= p0 || idx >= lim) {  // none of this word's bits
          idx += pc;
          continue;
        }
        const int64_t j = j0 + u * 32 + lane;
        while (bits) {
          const int b = __ffs(static_cast<int>(bits)) - 1;
          bits &= bits - 1u;
          if (idx >= p0 && idx < lim) {
            const int64_t s = static_cast<int64_t>(b) * n32 + j;
            list[idx - p0] = s < num_src ? static_cast<int>(s) : -1;
          }
          ++idx;
        }
      }
      __syncwarp();
      const int n = min(kBitList, total - p0);
      for (int i0 = 0; i0 < n; i0 += U) {
        V xv[U][CPL];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int s = i0 + u < n ? list[i0 + u] : -1;
          const V* xr = reinterpret_cast<const V*>(
              x + static_cast<int64_t>(s < 0 ? 0 : s) * f);
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            xv[u][q] = s >= 0 && ok[q] ? __ldg(xr + cv[q]) : Vec<VEC>::zero();
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int q = 0; q < CPL; ++q) Vec<VEC>::add(acc[q], xv[u][q]);
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    if (ok[q]) Vec<VEC>::store(out + d * f + cv[q] * VEC, acc[q]);
  }
}

template <int VEC, int CPL>
cudaError_t launch_k2(const void* packed, int64_t n32, const void* x,
                      int64_t num_src, int64_t f, void* out, int64_t num_dst,
                      cudaStream_t stream) {
  const int64_t per_block = 32 * CPL;  // column vectors a warp
  const dim3 grid(static_cast<unsigned>((num_dst + kWarps - 1) / kWarps),
                  static_cast<unsigned>((f / VEC + per_block - 1) /
                                        per_block));
  bit_matmul_kernel<VEC, CPL><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const uint32_t*>(packed), n32,
      static_cast<const float*>(x), num_src, static_cast<int>(f),
      static_cast<float*>(out), num_dst);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t k2_by_cpl(int64_t cpl, const void* packed, int64_t n32,
                      const void* x, int64_t num_src, int64_t f, void* out,
                      int64_t num_dst, cudaStream_t s) {
  switch (cpl) {
    case 1:
      return launch_k2<VEC, 1>(packed, n32, x, num_src, f, out, num_dst, s);
    case 2:
      return launch_k2<VEC, 2>(packed, n32, x, num_src, f, out, num_dst, s);
    case 4:
      return launch_k2<VEC, 4>(packed, n32, x, num_src, f, out, num_dst, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of K1 at slab width W: the ring, aligned, and 16
// warps' lists of 12-byte entries.
size_t t_smem_bytes(int64_t w) {
  return static_cast<size_t>(kTStages) * kTRows * w * 4 + 1024 +
         static_cast<size_t>(kTConsumers) * kTList * 12;
}

// K1: out (num_dst, f) += A @ x from packed_t (rows, n32) words, f <= 96;
// out must be zeroed by the caller.  `blocks` persistent blocks.
template <int W, int VEC, int CPL>
cudaError_t launch_t(const void* packed_t, int64_t n32, const void* x,
                     int64_t rows, int64_t f, void* out, int64_t num_dst,
                     int64_t blocks, int lpe, cudaStream_t stream) {
  CUtensorMap map;
  const CUtensorMapSwizzle swizzle =
      W == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
              : W == 16 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  cudaError_t err = tma::encode_2d(&map, CU_TENSOR_MAP_DATA_TYPE_UINT32,
                                   packed_t, n32, rows, n32 * 4, W, kTRows,
                                   swizzle);
  if (err != cudaSuccess) return err;
  const size_t smem = t_smem_bytes(W);
  err = cudaFuncSetAttribute(bit_matmul_t_kernel<W, VEC, CPL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bit_matmul_t_kernel<W, VEC, CPL>
      <<<static_cast<unsigned>(blocks), kTThreads, smem, stream>>>(
          map, n32, static_cast<const float*>(x), rows, static_cast<int>(f),
          static_cast<float*>(out), num_dst, lpe);
  return cudaGetLastError();
}

// x read `vec` floats at a time (4, 2 or 1: the widest dividing f and x's
// and out's alignment), nv = f / vec vectors a row over lpe lanes (the
// smallest power of two >= nv, at most 32; for single floats >= nv / 3,
// so that a step takes more entries), cpl = ceil(nv / lpe) a lane.
template <int W>
cudaError_t t_by_layout(const void* packed_t, int64_t n32, const void* x,
                        int64_t rows, int64_t f, void* out, int64_t num_dst,
                        int64_t blocks, int64_t vec, cudaStream_t s) {
  const int64_t nv = f / vec;
  const int64_t spread = vec == 1 ? (nv + 2) / 3 : nv;
  int lpe = 1;
  while (lpe < 32 && lpe < spread) lpe *= 2;
  const int64_t cpl = (nv + lpe - 1) / lpe;
  if (vec == 4 && cpl == 1)
    return launch_t<W, 4, 1>(packed_t, n32, x, rows, f, out, num_dst, blocks,
                             lpe, s);
  if (vec == 2 && cpl == 1)
    return launch_t<W, 2, 1>(packed_t, n32, x, rows, f, out, num_dst, blocks,
                             lpe, s);
  if (vec == 2 && cpl == 2)
    return launch_t<W, 2, 2>(packed_t, n32, x, rows, f, out, num_dst, blocks,
                             lpe, s);
  if (vec == 1 && cpl == 1)
    return launch_t<W, 1, 1>(packed_t, n32, x, rows, f, out, num_dst, blocks,
                             lpe, s);
  if (vec == 1 && cpl == 2)
    return launch_t<W, 1, 2>(packed_t, n32, x, rows, f, out, num_dst, blocks,
                             lpe, s);
  if (vec == 1 && cpl == 3)
    return launch_t<W, 1, 3>(packed_t, n32, x, rows, f, out, num_dst, blocks,
                             lpe, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K1: out (num_dst, f) += A @ x from packed_t's first `rows` rows of n32
// words (a multiple of 4, 16-byte aligned), f <= 96, slabs of w = 8, 16
// or 32 words, x and out read and added `vec` floats at a time (vec
// dividing f, both aligned to it), `blocks` persistent blocks (one an SM);
// out must be zeroed.
int dgl_bit_matmul_t(const void* packed_t, int64_t n32, const void* x,
                     int64_t rows, int64_t f, void* out, int64_t num_dst,
                     int64_t w, int64_t vec, int64_t blocks, int64_t device,
                     void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (rows <= 0 || f <= 0 || f > 96 || n32 <= 0 || n32 % 4 || blocks <= 0 ||
      rows > INT32_MAX || n32 > INT32_MAX || vec < 1 || f % vec)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 8:
      return t_by_layout<8>(packed_t, n32, x, rows, f, out, num_dst, blocks,
                            vec, s);
    case 16:
      return t_by_layout<16>(packed_t, n32, x, rows, f, out, num_dst, blocks,
                             vec, s);
    case 32:
      return t_by_layout<32>(packed_t, n32, x, rows, f, out, num_dst, blocks,
                             vec, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// K2: out (num_dst, f) = A @ x from packed (>= num_dst rows, n32) words;
// every element of out is written.  vec (1, 2 or 4) floats a load,
// dividing f, with x and out aligned to it; cpl (1, 2 or 4) vectors a
// lane.  Grid: (ceil(num_dst / 8), ceil(f / vec / (32 * cpl))) blocks of
// 8 warps, a warp a dst row.
int dgl_bit_matmul(const void* packed, int64_t n32, const void* x,
                   int64_t num_src, int64_t f, void* out, int64_t num_dst,
                   int64_t vec, int64_t cpl, int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (vec < 1 || f % vec != 0 || num_src > INT32_MAX)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 1:
      return k2_by_cpl<1>(cpl, packed, n32, x, num_src, f, out, num_dst, s);
    case 2:
      return k2_by_cpl<2>(cpl, packed, n32, x, num_src, f, out, num_dst, s);
    case 4:
      return k2_by_cpl<4>(cpl, packed, n32, x, num_src, f, out, num_dst, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
