// Bit-masked GAT attention on Hopper (K5): softmax aggregation over the
// whole boolean adjacency stored at 1 bit per entry, and its gradient.
//
// Packing (plane-major, shared with dgl_tpu/ops/pallas/bitmm.py:19-27):
// with n32 words per row, packed[r][j] bit b <-> column b * n32 + j of
// row r.  Bit 31 is the int32 sign bit, so words are read as uint32_t.
// Node ids are the global ids b * n32 + j, which the dropout hash needs.
//
// For every edge s -> d and head h (el, er clipped to +-20 by the caller):
//   raw = el[s,h] + er[d,h],  p = exp(max(raw, slope * raw))
//   l[d,h] = sum_s p,  out[d,h,:] = sum_s p keep z[s,h,:] / (max(l,1e-20) kp)
//   keep(s,d,h) = ((x0 * M_h) >> 17) < thresh,
//   x0 = (s * C1) ^ seed ^ (d * C2), all uint32_t, kp = thresh / 2^15
// (dgl_tpu/ops/pallas/bitgat.py:144-178, :186-241).  The backward, given
// g = dL/dout, linv = 1 / (max(l,1e-20) kp) and rho = kp sum_c g out:
//   alpha = p linv[d],  u = g[d,h,:] . z[s,h,:],  alpha_m = keep ? alpha : 0,
//   de = alpha_m u - alpha rho[d],  draw = raw > 0 ? de : slope de,
//   dz[s] += alpha_m g[d],  del[s] += draw,  der[d] += draw   (:353-382).
//
// Both directions are listed-bit walks.  The TPU kernels scored every bit
// densely, since its lanes have no cheap way to skip; at 0.21% density a
// word holds ~0.07 set bits.  Here persistent warps claim rows of a
// packing from a global counter in a claim order built once a format (hub
// rows, over 4x the mean count of set bits, first, largest first; then the
// rest by id), so that no hub starts late and holds up the end.  A warp
// lists its row's set bits (list_bits of bitlist.cuh, which K7's dz walk
// in bitdot.cu shares: the row's words 8 a lane a step,
// the next step's requested first, each lane's set bits placed in the
// warp's list in shared memory by a warp prefix sum of popcounts) and
// drains the list (when full, at 128 entries after a step, at the row's
// end): a group of lpe lanes owns an entry, 16-byte loads of the entry's
// row (heads padded to whole vectors, 41 columns to 44), CPL vectors a
// lane (16 lanes and 2 vectors at (4, 32), 4 and 3 at (1, 41)), and every
// group issues the loads of U entries before their arithmetic.  The row's
// own sums stay in each group's registers and are combined across the
// groups by shuffles in a fixed order at the row's end, so they keep one
// order of sums from run to run.  The dropout hash is the same bit for bit
// in both directions.  Sums and operands are f32.  At most 128 registers
// a thread (16 warps an SM).  Each kernel is behind a plain C function
// that launches on the caller's stream, allocates nothing and returns
// cudaGetLastError():
//
// bitgat_fwd_list_kernel<CPL, kOneHead, kDrop>  replaces
//     dgl_tpu/ops/pallas/bitgat.py _fwd_call (body _fwd_kernel), in gather
//     form over packed (rows = dst, entries = src s): per entry each lane
//     gathers its vectors of z[s] and el[s] of its heads, forms p from er[d]
//     (kept in registers for the row) and adds p into l and p keep z[s] into
//     registers; out and l are written once, with no atomics.  The
//     mesh-sharded GAT (dgl_tpu/parallel/bitgat_spmd.py:193-205, over a
//     device's column shard of the A^T packing) launches it too, without
//     dropout, on the shard's dst-major view (bitgat.py bitgat_fwd_t).  It
//     replaced a warp walk a dst row a bit at a time (each bit's gathers
//     waiting on the previous bit's arithmetic) and, for the shard, a
//     scatter walk a src row a bit at a time that added 128 floats into L2
//     a set bit, with a divide pass after it; both are built by
//     dgl_tpu_torch/tools/perf_fwd_walks.py from tools/fwd_probe.cu and
//     timed beside it (PERF.md, K5).
//
// bitgat_bwd_list_kernel<CPL, kOneHead, kDrop>  replaces _bwd_call (body
//     _bwd_kernel), and serves K13 (below), src-major over packed_rev
//     (rows = src s, entries = dst d): per entry 16-byte loads of g[d] and
//     the (3, H) row [er, linv, rho]; a head's dot reduces over its lanes of
//     the group (3 shuffle levels at (4, 32), a lane's heads' chains side by
//     side); dz[s] and del[s] stay in registers.  der[d] takes one scalar
//     reduction in L2 an (edge, head) from the first lane of the head's
//     block (4 an edge from two lanes at (4, 32)); its order changes from
//     run to run.  Gathering an edge's 4 heads into one lane for a
//     red.global.add.v4.f32 (2 shuffles an edge) ran slower.  The walk
//     replaced one that gave a warp a src row and took its set bits one at
//     a time, each bit's gathers waiting on the previous bit's shuffles and
//     atomics; dgl_tpu_torch/tools/perf_bwd_walks.py times the two, the
//     vector der and a cap of 80 registers side by side (PERF.md, K5).
//
// The backward of the mesh-sharded GAT (JAX _bwd_src_call, K13) is
// bitgat_bwd_list_kernel<CPL, kOneHead, false> launched on the shard, its
// rows claimed in the shard's own order: rows = kp src rows of the
// gathered el and z, k32 = the shard's W words, num_dst = the device's
// npp dst nodes; every offset it forms from a row and k32 is 64-bit, and
// it takes no square packing.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): each kernel must
// stream the whole bitmask, K_pad * n32 * 4 bytes (6,933,184,512 B at
// Reddit scale: 2.07 ms), plus z, out, g and the node vectors once (about
// 0.1 ms more at H * D = 128); the arithmetic, 2 (forward) or 4
// (backward) flops per edge and feature column plus 5 to 12 per edge and
// head, is below 1 ms at that scale.  chip_smoke.py prints the bound of
// each call.  The design reads the bit words once, coalesced; the
// per-set-bit work (a gather of a 512-byte row of z or g at H * D = 128
// from L2 or memory, the exps, the shuffles, the atomics) is the other
// cost, as in K2 (csrc/bitmm.cu), and the lists keep U entries a group in
// flight.  The C functions and launch shapes are chosen by
// dgl_tpu_torch/ops/kernels/bitgat.py (list_layout: dp, lpe and CPL).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitlist.cuh"
#include "persistent.cuh"

namespace {

constexpr int kWarps = 8;        // warps per block
constexpr uint32_t kC1 = 0x9E3779B1u;
constexpr uint32_t kC2 = 0x85EBCA6Bu;
__constant__ uint32_t kHeadMults[8] = {
    0xC2B2AE35u, 0x27D4EB2Fu, 0x165667B1u, 0x9E3779B9u,
    0x85EBCA77u, 0xC2B2AE3Du, 0x2545F491u, 0x94D049BBu};

__device__ __forceinline__ float lrelu_exp(float raw, float slope) {
  return expf(fmaxf(raw, slope * raw));
}

__device__ __forceinline__ bool keep_bit(uint32_t x0, uint32_t mult,
                                         uint32_t thresh) {
  return ((x0 * mult) >> 17) < thresh;
}

// The lanes of a listed walk.  Each row of z and g (and of out) is padded
// to nv 16-byte vectors: heads of dp = 4 vph columns (vph a power of two
// when H > 1), so that no vector straddles two heads.  A group of lpe lanes
// owns an entry; lane li of the group holds vectors vq = li + lpe q (q <
// CPL) of the row.  With one head (kOneHead) the lane's vectors all belong
// to it (one scalar chain); with several, lpe is a multiple of vph and
// vector q of lane li lies in head (li + lpe q) / vph, a head's vectors an
// aligned block of vph lanes of the group, and chain q of the scalar work
// is head hq[q].
template <int CPL>
struct ListUnroll {  // entries a group keeps in flight
  static constexpr int value =
      CPL == 1 ? 8 : CPL == 2 ? 4 : CPL == 3 ? 3 : 2;
};

template <int CPL, int NH>
__device__ __forceinline__ void entry_lanes(int li, int lpe, int nv, int vph,
                                            bool one_head, bool drop,
                                            int (&vq)[CPL], bool (&ok)[CPL],
                                            int (&hq)[NH], bool (&chain)[NH],
                                            uint32_t (&mult)[NH]) {
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    vq[q] = li + lpe * q;
    ok[q] = vq[q] < nv;
  }
#pragma unroll
  for (int t = 0; t < NH; ++t) {
    hq[t] = one_head ? 0 : vq[t] / vph;
    chain[t] = one_head || ok[t];
    mult[t] = drop && chain[t] ? kHeadMults[hq[t] & 7] : 0u;
  }
}

template <int CPL, bool kOneHead, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32, 2)
bitgat_fwd_list_kernel(const uint32_t* __restrict__ packed, int64_t k32,
                       const int* __restrict__ order, int rows,
                       int64_t num_src, const float* __restrict__ el,
                       const float* __restrict__ er,
                       const float4* __restrict__ z, int heads, int dim,
                       int nv, int vph, int lpe, float slope, uint32_t thresh,
                       const int64_t* __restrict__ seed,
                       float* __restrict__ out, float* __restrict__ l,
                       int* __restrict__ counter) {
  constexpr int U = ListUnroll<CPL>::value;
  constexpr int NH = kOneHead ? 1 : CPL;  // scalar chains a lane
  __shared__ int lists[kWarps][kList];
  const int lane = threadIdx.x & 31;
  int* list = lists[threadIdx.x >> 5];
  const int groups = 32 / lpe;
  const int grp = lane / lpe;
  const int li = lane - grp * lpe;
  int vq[CPL];
  bool ok[CPL];
  int hq[NH];
  bool chain[NH];   // the chain is a head of the row
  uint32_t mult[NH];
  entry_lanes<CPL, NH>(li, lpe, nv, vph, kOneHead, kDrop, vq, ok, hq, chain,
                       mult);
  // l is written by the first lane of each head's block
  const bool head_lane = kOneHead ? li == 0 : li % vph == 0;
  const float kp = kDrop ? static_cast<float>(thresh) / 32768.f : 1.f;

  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(counter, 1);
    item = __shfl_sync(kFull, item, 0);
    if (item >= rows) break;  // warp-uniform
    const int64_t d = order[item];
    float4 acc[CPL];
    float erq[NH], lsum[NH];
#pragma unroll
    for (int q = 0; q < CPL; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      erq[t] = chain[t] ? __ldg(er + d * heads + hq[t]) : 0.f;
      lsum[t] = 0.f;
    }
    const uint32_t dpart =
        kDrop ? (static_cast<uint32_t>(d) * kC2) ^ static_cast<uint32_t>(*seed)
              : 0u;

    const uint32_t* prow = packed + d * k32;
    uint32_t word[kStepWords], next[kStepWords];
    list_start(word, next, prow, k32, lane);
    int64_t j0 = -32 * kStepWords;  // the step in hand
    int total = 0, first = 0, p0 = 0;  // its entries, the lane's, listed
    int len = 0;                       // entries in the list
    bool row_done = false;             // all warp-uniform
    while (!row_done) {
      list_bits(list, len, row_done, word, next, j0, total, first, p0, prow,
                k32, num_src, lane);
      // the drain: groups take consecutive entries, U each in flight,
      // every load of a batch issued before its arithmetic
      __syncwarp();
      for (int i0 = 0; i0 < len; i0 += groups * U) {
        int ss[U];
        float4 zv[U][CPL];
        float elv[U][NH];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = i0 + u * groups + grp;
          ss[u] = e < len ? list[e] : -1;
          const int64_t s = ss[u] < 0 ? 0 : ss[u];
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            zv[u][q] = ss[u] >= 0 && ok[q] ? __ldg(z + s * nv + vq[q])
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int t = 0; t < NH; ++t) {
            elv[u][t] = ss[u] >= 0 && chain[t] ? __ldg(el + s * heads + hq[t])
                                               : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (ss[u] < 0) continue;
          const uint32_t x0 =
              kDrop ? (static_cast<uint32_t>(ss[u]) * kC1) ^ dpart : 0u;
          float pm[NH];
#pragma unroll
          for (int t = 0; t < NH; ++t) {
            const float p = lrelu_exp(elv[u][t] + erq[t], slope);
            lsum[t] += p;
            pm[t] = (!kDrop || keep_bit(x0, mult[t], thresh)) ? p : 0.f;
          }
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            const float a = pm[kOneHead ? 0 : q];
            acc[q].x = fmaf(a, zv[u][q].x, acc[q].x);
            acc[q].y = fmaf(a, zv[u][q].y, acc[q].y);
            acc[q].z = fmaf(a, zv[u][q].z, acc[q].z);
            acc[q].w = fmaf(a, zv[u][q].w, acc[q].w);
          }
        }
      }
      __syncwarp();
      len = 0;
    }

    // the groups' sums, combined in a fixed order, then written once
    for (int off = lpe; off < 32; off <<= 1) {  // warp-uniform
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        acc[q].x += __shfl_xor_sync(kFull, acc[q].x, off);
        acc[q].y += __shfl_xor_sync(kFull, acc[q].y, off);
        acc[q].z += __shfl_xor_sync(kFull, acc[q].z, off);
        acc[q].w += __shfl_xor_sync(kFull, acc[q].w, off);
      }
#pragma unroll
      for (int t = 0; t < NH; ++t)
        lsum[t] += __shfl_xor_sync(kFull, lsum[t], off);
    }
    if (grp != 0) continue;
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      if (!ok[q]) continue;
      const float den = fmaxf(lsum[kOneHead ? 0 : q], 1e-20f) * kp;
      const float4 o = make_float4(acc[q].x / den, acc[q].y / den,
                                   acc[q].z / den, acc[q].w / den);
      if (dim == 4 * vph) {  // no padding: the row's vectors are out's
        reinterpret_cast<float4*>(out)[d * nv + vq[q]] = o;
        continue;
      }
      const int h = vq[q] / vph, c0 = 4 * (vq[q] - h * vph);
      float* orow = out + (d * heads + h) * dim;
      if (c0 < dim) orow[c0] = o.x;
      if (c0 + 1 < dim) orow[c0 + 1] = o.y;
      if (c0 + 2 < dim) orow[c0 + 2] = o.z;
      if (c0 + 3 < dim) orow[c0 + 3] = o.w;
    }
    if (!head_lane) continue;
#pragma unroll
    for (int t = 0; t < NH; ++t)
      if (chain[t]) l[d * heads + hq[t]] = lsum[t];
  }
}

template <int CPL, bool kOneHead, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32, 2)
bitgat_bwd_list_kernel(const uint32_t* __restrict__ packed_rev, int64_t k32,
                       const int* __restrict__ order, int rows,
                       int64_t num_dst, const float* __restrict__ el,
                       const float* __restrict__ nvec,  // (num_dst, 3, H)
                       const float4* __restrict__ z,
                       const float4* __restrict__ g, int heads, int nv,
                       int vph, int lpe, float slope, uint32_t thresh,
                       const int64_t* __restrict__ seed,
                       float4* __restrict__ dz, float* __restrict__ del,
                       float* __restrict__ der, int* __restrict__ counter) {
  constexpr int U = ListUnroll<CPL>::value;
  constexpr int NH = kOneHead ? 1 : CPL;  // scalar chains a lane
  __shared__ int lists[kWarps][kList];
  const int lane = threadIdx.x & 31;
  int* list = lists[threadIdx.x >> 5];
  const int groups = 32 / lpe;
  const int grp = lane / lpe;
  const int li = lane - grp * lpe;
  const int red = kOneHead ? lpe : vph;  // lanes that share a head's sum
  int vq[CPL];
  bool ok[CPL];
  int hq[NH];
  bool chain[NH];   // the chain is a head of the row
  uint32_t mult[NH];
  entry_lanes<CPL, NH>(li, lpe, nv, vph, kOneHead, kDrop, vq, ok, hq, chain,
                       mult);
  // der: one reduction in L2 an (entry, head), from the first lane of the
  // head's block
  const bool der_lane = kOneHead ? li == 0 : li % vph == 0;

  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(counter, 1);
    item = __shfl_sync(kFull, item, 0);
    if (item >= rows) break;  // warp-uniform
    const int64_t s = order[item];
    float4 zq[CPL], dzq[CPL];
    float elq[NH], delq[NH];
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      zq[q] = ok[q] ? __ldg(z + s * nv + vq[q]) : make_float4(0.f, 0.f, 0.f,
                                                              0.f);
      dzq[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      elq[t] = chain[t] ? __ldg(el + s * heads + hq[t]) : 0.f;
      delq[t] = 0.f;
    }
    const uint32_t spart =
        kDrop ? (static_cast<uint32_t>(s) * kC1) ^ static_cast<uint32_t>(*seed)
              : 0u;

    const uint32_t* prow = packed_rev + s * k32;
    uint32_t word[kStepWords], next[kStepWords];
    list_start(word, next, prow, k32, lane);
    int64_t j0 = -32 * kStepWords;  // the step in hand
    int total = 0, first = 0, p0 = 0;  // its entries, the lane's, listed
    int len = 0;                       // entries in the list
    bool row_done = false;             // all warp-uniform
    while (!row_done) {
      list_bits(list, len, row_done, word, next, j0, total, first, p0, prow,
                k32, num_dst, lane);
      // the drain: groups take consecutive entries, U each in flight,
      // every load of a batch issued before its arithmetic
      __syncwarp();
      for (int i0 = 0; i0 < len; i0 += groups * U) {
        int dd[U];
        float4 gv[U][CPL];
        float erv[U][NH], liv[U][NH], rhv[U][NH];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = i0 + u * groups + grp;
          dd[u] = e < len ? list[e] : -1;
          const int64_t d = dd[u] < 0 ? 0 : dd[u];
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            gv[u][q] = dd[u] >= 0 && ok[q] ? __ldg(g + d * nv + vq[q])
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
          }
          const float* nr = nvec + d * 3 * heads;
#pragma unroll
          for (int t = 0; t < NH; ++t) {
            const bool on = dd[u] >= 0 && chain[t];
            erv[u][t] = on ? __ldg(nr + hq[t]) : 0.f;
            liv[u][t] = on ? __ldg(nr + heads + hq[t]) : 0.f;
            rhv[u][t] = on ? __ldg(nr + 2 * heads + hq[t]) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float dot[NH];
#pragma unroll
          for (int t = 0; t < NH; ++t) dot[t] = 0.f;
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            const int t = kOneHead ? 0 : q;
            dot[t] = fmaf(gv[u][q].x, zq[q].x, dot[t]);
            dot[t] = fmaf(gv[u][q].y, zq[q].y, dot[t]);
            dot[t] = fmaf(gv[u][q].z, zq[q].z, dot[t]);
            dot[t] = fmaf(gv[u][q].w, zq[q].w, dot[t]);
          }
          for (int off = red >> 1; off > 0; off >>= 1) {  // warp-uniform
#pragma unroll
            for (int t = 0; t < NH; ++t)
              dot[t] += __shfl_xor_sync(kFull, dot[t], off);
          }
          if (dd[u] < 0) continue;
          const int64_t d = dd[u];
          const uint32_t x0 =
              kDrop ? spart ^ (static_cast<uint32_t>(d) * kC2) : 0u;
          float am[NH], dr[NH];
#pragma unroll
          for (int t = 0; t < NH; ++t) {
            const float raw = elq[t] + erv[u][t];
            const float alpha = lrelu_exp(raw, slope) * liv[u][t];
            am[t] = (!kDrop || keep_bit(x0, mult[t], thresh)) ? alpha : 0.f;
            const float de = am[t] * dot[t] - alpha * rhv[u][t];
            dr[t] = raw > 0.f ? de : slope * de;
            if (chain[t]) delq[t] += dr[t];
          }
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            const float a = am[kOneHead ? 0 : q];
            dzq[q].x = fmaf(a, gv[u][q].x, dzq[q].x);
            dzq[q].y = fmaf(a, gv[u][q].y, dzq[q].y);
            dzq[q].z = fmaf(a, gv[u][q].z, dzq[q].z);
            dzq[q].w = fmaf(a, gv[u][q].w, dzq[q].w);
          }
          if (!der_lane) continue;
#pragma unroll
          for (int t = 0; t < NH; ++t)
            if (chain[t]) atomicAdd(der + d * heads + hq[t], dr[t]);
        }
      }
      __syncwarp();
      len = 0;
    }

    // the groups' sums, combined in a fixed order, then written once
    for (int off = lpe; off < 32; off <<= 1) {  // warp-uniform
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        dzq[q].x += __shfl_xor_sync(kFull, dzq[q].x, off);
        dzq[q].y += __shfl_xor_sync(kFull, dzq[q].y, off);
        dzq[q].z += __shfl_xor_sync(kFull, dzq[q].z, off);
        dzq[q].w += __shfl_xor_sync(kFull, dzq[q].w, off);
      }
#pragma unroll
      for (int t = 0; t < NH; ++t)
        delq[t] += __shfl_xor_sync(kFull, delq[t], off);
    }
    if (grp != 0) continue;
#pragma unroll
    for (int q = 0; q < CPL; ++q)
      if (ok[q]) dz[s * nv + vq[q]] = dzq[q];
    if (!der_lane) continue;
#pragma unroll
    for (int t = 0; t < NH; ++t)
      if (chain[t]) del[s * heads + hq[t]] = delq[t];
  }
}

struct FwdListArgs {
  const uint32_t* packed;
  int64_t k32;
  const int* order;
  int rows;
  int64_t num_src;
  const float* el;
  const float* er;
  const float4* z;
  int heads, dim, nv, vph, lpe;
  float slope;
  uint32_t thresh;
  const int64_t* seed;
  float* out;
  float* l;
  int* counter;
};

struct BwdListArgs {
  const uint32_t* packed_rev;
  int64_t k32;
  const int* order;
  int rows;
  int64_t num_dst;
  const float* el;
  const float* nvec;
  const float4* z;
  const float4* g;
  int heads, nv, vph, lpe;
  float slope;
  uint32_t thresh;
  const int64_t* seed;
  float4* dz;
  float* del;
  float* der;
  int* counter;
};

template <int CPL, bool kOneHead, bool kDrop>
cudaError_t launch_fwd_list(const FwdListArgs& a, cudaStream_t stream) {
  unsigned blocks = 0;
  const cudaError_t err = persistent_blocks(
      bitgat_fwd_list_kernel<CPL, kOneHead, kDrop>, kWarps * 32,
      (a.rows + kWarps - 1) / kWarps, &blocks);
  if (err != cudaSuccess) return err;
  bitgat_fwd_list_kernel<CPL, kOneHead, kDrop><<<blocks, kWarps * 32, 0,
                                                 stream>>>(
      a.packed, a.k32, a.order, a.rows, a.num_src, a.el, a.er, a.z, a.heads,
      a.dim, a.nv, a.vph, a.lpe, a.slope, a.thresh, a.seed, a.out, a.l,
      a.counter);
  return cudaGetLastError();
}

template <int CPL, bool kOneHead, bool kDrop>
cudaError_t launch_bwd_list(const BwdListArgs& a, cudaStream_t stream) {
  unsigned blocks = 0;
  const cudaError_t err = persistent_blocks(
      bitgat_bwd_list_kernel<CPL, kOneHead, kDrop>, kWarps * 32,
      (a.rows + kWarps - 1) / kWarps, &blocks);
  if (err != cudaSuccess) return err;
  bitgat_bwd_list_kernel<CPL, kOneHead, kDrop><<<blocks, kWarps * 32, 0,
                                                 stream>>>(
      a.packed_rev, a.k32, a.order, a.rows, a.num_dst, a.el, a.nvec, a.z,
      a.g, a.heads, a.nv, a.vph, a.lpe, a.slope, a.thresh, a.seed, a.dz,
      a.del, a.der, a.counter);
  return cudaGetLastError();
}

// The registers a thread and the blocks an SM of a kernel.
template <typename K>
cudaError_t kernel_attrs(K kernel, int* regs, int* per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                       kWarps * 32, 0);
}

}  // namespace

extern "C" {

// Forward, as a listed-bit walk by dst: out (num_dst, H, D) and l
// (num_dst, H) f32, every row of `order` written (a row with no set bit
// gives 0), from packed (rows = dst, k32 words a row; bit b of word j <->
// src b * k32 + j, bits at or past num_src skipped), order (rows,) int32,
// the dst rows in the order warps claim them (each once), el (num_src, H),
// er (num_dst, H) f32 and z (num_src rows of nv = H dp / 4 16-byte
// vectors, each head's dp >= D columns padded with zeros, 16-byte
// aligned); out 16-byte aligned where D = dp.  The seed is one int64 on the
// card (low 32 bits used); thresh 0 means no dropout, else 1..32768 and H
// <= 8.  lpe and cpl as the backward's; num_src < 2^31.  counter is one
// int, zeroed by the caller.  Persistent blocks of 8 warps.
int dgl_bitgat_fwd_list(const void* packed, int64_t k32, const void* order,
                        int64_t rows, int64_t num_src, const void* el,
                        const void* er, const void* z, int64_t heads,
                        int64_t dim, int64_t dp, int64_t lpe, int64_t cpl,
                        float slope, int64_t thresh, const void* seed,
                        void* out, void* l, void* counter, int64_t device,
                        void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const int64_t vph = dp / 4, nv = heads * vph;
  if (!list_layout_ok(heads, dp, lpe, cpl) || dim < 1 || dim > dp ||
      num_src > INT32_MAX || rows > INT32_MAX ||
      reinterpret_cast<uintptr_t>(z) % 16 != 0 ||
      (dim == dp && reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return cudaErrorInvalidValue;
  const FwdListArgs a{static_cast<const uint32_t*>(packed), k32,
                      static_cast<const int*>(order), static_cast<int>(rows),
                      num_src, static_cast<const float*>(el),
                      static_cast<const float*>(er),
                      static_cast<const float4*>(z), static_cast<int>(heads),
                      static_cast<int>(dim), static_cast<int>(nv),
                      static_cast<int>(vph), static_cast<int>(lpe), slope,
                      static_cast<uint32_t>(thresh),
                      static_cast<const int64_t*>(seed),
                      static_cast<float*>(out), static_cast<float*>(l),
                      static_cast<int*>(counter)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool one = heads == 1, drop = thresh != 0;
#define DGL_FWD_LIST(C)                                                     \
  case C:                                                                   \
    if (one) return drop ? launch_fwd_list<C, true, true>(a, st)            \
                         : launch_fwd_list<C, true, false>(a, st);          \
    return drop ? launch_fwd_list<C, false, true>(a, st)                    \
                : launch_fwd_list<C, false, false>(a, st);
  switch (cpl) {
    DGL_FWD_LIST(1)
    DGL_FWD_LIST(2)
    DGL_FWD_LIST(3)
    DGL_FWD_LIST(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef DGL_FWD_LIST
}

// Backward, as a listed-bit walk: dz (num_src, H, dp) and del (num_src,
// H) f32, every row of `order` written, and der (num_dst, H) f32, zeroed
// by the caller and summed with reductions in L2, from packed_rev (k32
// words a row), order (rows,) int32, the src rows in the order warps
// claim them (each row once), el (num_src, H), nvec (num_dst, 3, H) = [er, linv, rho], z and g (num_src
// and num_dst rows of nv = H dp / 4 16-byte vectors, each head's dp
// columns padded with zeros, 16-byte aligned).  lpe lanes an entry (a
// power of two up to 32), cpl = ceil(nv / lpe) <= 4 vectors a lane; with
// H > 1, vph = dp / 4 is a power of two dividing lpe.  num_dst < 2^31.
// counter is one int, zeroed by the caller.  Persistent blocks of 8 warps.
int dgl_bitgat_bwd_list(const void* packed_rev, int64_t k32,
                        const void* order, int64_t rows, int64_t num_dst,
                        const void* el, const void* nvec, const void* z,
                        const void* g, int64_t heads, int64_t dp,
                        int64_t lpe, int64_t cpl, float slope,
                        int64_t thresh, const void* seed, void* dz,
                        void* del, void* der, void* counter, int64_t device,
                        void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const int64_t vph = dp / 4, nv = heads * vph;
  if (!list_layout_ok(heads, dp, lpe, cpl) || num_dst > INT32_MAX ||
      rows > INT32_MAX ||
      reinterpret_cast<uintptr_t>(z) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dz) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(der) % 16 != 0)
    return cudaErrorInvalidValue;
  const BwdListArgs a{static_cast<const uint32_t*>(packed_rev), k32,
                      static_cast<const int*>(order), static_cast<int>(rows),
                      num_dst, static_cast<const float*>(el),
                      static_cast<const float*>(nvec),
                      static_cast<const float4*>(z),
                      static_cast<const float4*>(g), static_cast<int>(heads),
                      static_cast<int>(nv), static_cast<int>(vph),
                      static_cast<int>(lpe), slope,
                      static_cast<uint32_t>(thresh),
                      static_cast<const int64_t*>(seed),
                      static_cast<float4*>(dz), static_cast<float*>(del),
                      static_cast<float*>(der), static_cast<int*>(counter)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool one = heads == 1, drop = thresh != 0;
#define DGL_BWD_LIST(C)                                                     \
  case C:                                                                   \
    if (one) return drop ? launch_bwd_list<C, true, true>(a, st)            \
                         : launch_bwd_list<C, true, false>(a, st);          \
    return drop ? launch_bwd_list<C, false, true>(a, st)                    \
                : launch_bwd_list<C, false, false>(a, st);
  switch (cpl) {
    DGL_BWD_LIST(1)
    DGL_BWD_LIST(2)
    DGL_BWD_LIST(3)
    DGL_BWD_LIST(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef DGL_BWD_LIST
}

// regs_blocks (two host ints): the registers a thread of a listed walk's
// instance (the forward's when fwd, else the backward's) for (cpl, one
// head, dropout) and its resident blocks an SM.
int dgl_bitgat_list_attrs(int64_t fwd, int64_t cpl, int64_t one_head,
                          int64_t drop, int64_t device, void* regs_blocks) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  int* out = static_cast<int*>(regs_blocks);
#define DGL_ATTRS(K, C, O, D) return kernel_attrs(K<C, O, D>, out, out + 1)
#define DGL_LIST_ATTRS(C)                                                   \
  case C:                                                                   \
    if (fwd) {                                                              \
      if (one_head) {                                                       \
        if (drop) DGL_ATTRS(bitgat_fwd_list_kernel, C, true, true);         \
        DGL_ATTRS(bitgat_fwd_list_kernel, C, true, false);                  \
      }                                                                     \
      if (drop) DGL_ATTRS(bitgat_fwd_list_kernel, C, false, true);          \
      DGL_ATTRS(bitgat_fwd_list_kernel, C, false, false);                   \
    }                                                                       \
    if (one_head) {                                                         \
      if (drop) DGL_ATTRS(bitgat_bwd_list_kernel, C, true, true);           \
      DGL_ATTRS(bitgat_bwd_list_kernel, C, true, false);                    \
    }                                                                       \
    if (drop) DGL_ATTRS(bitgat_bwd_list_kernel, C, false, true);            \
    DGL_ATTRS(bitgat_bwd_list_kernel, C, false, false);
  switch (cpl) {
    DGL_LIST_ATTRS(1)
    DGL_LIST_ATTRS(2)
    DGL_LIST_ATTRS(3)
    DGL_LIST_ATTRS(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef DGL_LIST_ATTRS
#undef DGL_ATTRS
}

}  // extern "C"
