// Bit-masked dot-product attention on Hopper (K7): DotGat's softmax
// aggregation over the whole boolean adjacency stored at 1 bit per entry,
// and its gradient.
//
// Packing (plane-major, shared with dgl_tpu/ops/pallas/bitmm.py:19-27):
// with n32 words per row, packed[r][j] bit b <-> column b * n32 + j of
// row r.  Bit 31 is the int32 sign bit, so words are read as uint32_t.
//
// For every edge s -> d and head h, with q (num_dst, H, D), z (num_src, H,
// D) serving as both key and value, and isd = 1 / sqrt(D):
//   e = (z[s,h,:] . q[d,h,:]) isd,  p = exp(clip(e, -40, 40))
//   l[d,h] = sum_s p,  out[d,h,:] = sum_s p z[s,h,:] / max(l, 1e-20)
// (dgl_tpu/ops/pallas/bitdot.py:12-40, :97-152).  The backward, given
// g = dL/dout, linv = 1 / max(l, 1e-20) and rho = sum_c g out:
//   alpha = p linv[d],  u = g[d,h,:] . z[s,h,:],  de = alpha (u - rho[d]),
//   draw = -40 < e < 40 ? isd de : 0   (the clip's gradient),
//   dz[s] += draw q[d] + alpha g[d]    (k == v: dK and dV in one sum),
//   dq[d] += draw z[s]                 (:200-268, :315-364).
//
// The TPU kernels score every bit densely, one matrix-unit contraction
// per tile; at Reddit's 0.2% density a word holds ~0.07 set bits, so here
// each kernel walks the set bits: all three are the listed walks of K5
// (csrc/bitgat.cu, its listing shared in csrc/bitlist.cuh), the forward
// and dq by dst and dz by src.  Every row's sums stay in registers and are
// written once: no atomics, and a fixed order of sums.  Operands and sums
// are f32.
// Each kernel is behind a plain C function that launches on the caller's
// stream, allocates nothing and returns cudaGetLastError():
//
// bitdot_fwd_list_kernel<CPL, kOneHead>  replaces
//     dgl_tpu/ops/pallas/bitdot.py _fwd_call (:156, body _fwd_kernel :97).
//     The dq walk's lanes, layout and rows over packed (below): the row's
//     q[d] stays in registers, a group of lpe lanes gathers an entry's
//     z[s] in 16-byte loads, forms z . q per head over the head's lanes,
//     takes p = exp(clip(e, +-40)) and adds p into l's sum and p z[s] into
//     out's, U entries in flight (FwdUnroll: the forward holds neither g
//     nor [linv, rho], so more than DqUnroll where the registers allow);
//     at the row's end the groups' sums meet by shuffles in a fixed order
//     and out = acc / max(l, 1e-20) and l are written once.  It replaced a
//     warp a dst row taking its set bits one at a time, each bit's gather
//     waiting on the previous bit's shuffles and exp, its lanes owning
//     columns lane + 32 k with scalar loads (built by
//     dgl_tpu_torch/tools/perf_fwd_scores.py from tools/fwd_scores_probe.cu
//     and timed beside it, PERF.md).
// bitdot_dz_list_kernel<CPL, kOneHead>  replaces _bwdA_call (:272, body
//     _bwdA_kernel :200), which runs dst blocks over packed into per-src
//     lanes.  A listed-bit walk by src over packed_rev: persistent warps
//     claim its rows from a global counter in the backward's claim order
//     (hub rows first, bitgat.py bwd_claim_order), list a row's set bits
//     (list_bits) and drain the list; a group of lpe lanes owns an entry d
//     and gathers q[d] and g[d] in 16-byte loads (heads padded to whole
//     vectors, bitdot.py dz_layout, K5's: 16 lanes and 2 vectors a lane
//     at (2, 64) and (4, 32), 8 and 4 at (1, 128)) and d's [linv, rho];
//     z . q and g . z per
//     head reduce over the lanes of the head's block; draw q[d] + alpha
//     g[d] adds into dz[s]'s registers; every group issues the loads of U
//     entries (DzUnroll) before their arithmetic, and the groups' sums meet
//     by shuffles in a fixed order at the row's end.  It replaced a warp a
//     src row taking its set bits one at a time, each bit's gathers waiting
//     on the previous bit's shuffles and exp (bitdot_dz_kernel, built by
//     dgl_tpu_torch/tools/perf_dz_slot_grad.py from
//     tools/dz_slot_grad_probe.cu and timed beside it, PERF.md).
// bitdot_dq_list_kernel<CPL, kOneHead>  replaces _bwdB_call (:368, body
//     _bwdB_kernel :315).  The dz walk's lanes and layout by dst over
//     packed: persistent warps claim its rows in the forward's claim order
//     (bitgat.py fwd_claim_order), the row's q[d], g[d] and [linv, rho]
//     stay in registers, a group of lpe lanes gathers an entry's z[s] in
//     16-byte loads, forms z . q and g . z per head over the head's lanes,
//     takes draw and adds draw z[s] into the row's registers, U entries
//     in flight (DqUnroll, K5's forward's count: one row gathered an
//     entry); the groups' sums meet by shuffles in a fixed order at the
//     row's end.  It replaced a warp a dst row taking its set bits one at
//     a time, each bit's gather waiting on the previous bit's shuffles and
//     exp (bitdot_dq_kernel, built by
//     dgl_tpu_torch/tools/perf_dq_node_grad.py from
//     tools/dq_node_grad_probe.cu and timed beside it, PERF.md).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): each kernel must
// stream the whole bitmask, K_pad * n32 * 4 bytes (6.93 GB at Reddit
// scale: 2.07 ms), plus each node-sized input and output once; the
// arithmetic, about E H (4 D + 5) operations forward, E H (8 D + 12) for
// dz and E H (6 D + 12) for dq, is 0.9-1.8 ms at (H, D) = (2, 64) on
// Reddit's 114.8M edges.  chip_smoke.py prints the bound of each call.
// The per-set-bit work (a 512-byte row gathered from L2 or memory at H * D
// = 128, the shuffles, the exp) is the cost: the three walks keep U
// entries a group in flight.  The C functions and launch shapes are chosen by
// dgl_tpu_torch/ops/kernels/bitdot.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitlist.cuh"
#include "persistent.cuh"

namespace {

constexpr int kWarps = 8;   // warps per block
constexpr float kClip = 40.f;
constexpr float kDenEps = 1e-20f;

__device__ __forceinline__ float clip_exp(float e) {
  return expf(fminf(fmaxf(e, -kClip), kClip));
}

// One edge's backward terms for one head: alpha and draw from its summed
// dots z . q and u = g . z and the dst's linv and rho.
__device__ __forceinline__ void edge_grad(float zq, float u, float linv,
                                          float rho, float isd, float& alpha,
                                          float& draw) {
  const float e = zq * isd;
  alpha = clip_exp(e) * linv;
  const float de = alpha * (u - rho);
  draw = (e > -kClip && e < kClip) ? de * isd : 0.f;
}

// The entries a group of the dz walk keeps in flight: each brings two of
// the group's rows, q[d] and g[d], CPL vectors a lane each, so fewer than
// K5's backward keeps (bitgat.cu ListUnroll): at most 128 registers a
// thread with no local memory at the layouts of DotGatConv's gate (D >=
// 64: CPL 2 with several heads, 4 with one); with several heads CPL 4
// spills a few words even at 1.
template <int CPL>
struct DzUnroll {
  static constexpr int value = CPL == 1 ? 4 : CPL == 2 ? 2 : 1;
};

// dz by the listed walk by src.  Rows of q, z, g and dz are nv 16-byte
// vectors, each head's columns padded with zeros to dp = 4 vph; a group of
// lpe lanes owns an entry, lane li holding vectors vq = li + lpe q (q <
// CPL); with one head the lane's vectors are one scalar chain, with
// several, vector q of the lane lies in head vq / vph (a head's vectors an
// aligned block of vph lanes of the group) and is chain q.
template <int CPL, bool kOneHead>
__global__ void __launch_bounds__(kWarps * 32, 2)
bitdot_dz_list_kernel(const uint32_t* __restrict__ packed_rev, int64_t k32,
                      const int* __restrict__ order, int rows,
                      int64_t num_dst, const float4* __restrict__ q,
                      const float4* __restrict__ z,
                      const float4* __restrict__ g,
                      const float* __restrict__ nvec,  // (num_dst, 2, H)
                      int heads, int nv, int vph, int lpe, float isd,
                      float4* __restrict__ dz, int* __restrict__ counter) {
  constexpr int U = DzUnroll<CPL>::value;
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
  bool chain[NH];  // the chain is a head of the row
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    vq[c] = li + lpe * c;
    ok[c] = vq[c] < nv;
  }
#pragma unroll
  for (int t = 0; t < NH; ++t) {
    hq[t] = kOneHead || !ok[t] ? 0 : vq[t] / vph;
    chain[t] = kOneHead || ok[t];
  }

  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(counter, 1);
    item = __shfl_sync(kFull, item, 0);
    if (item >= rows) break;  // warp-uniform
    const int64_t s = order[item];
    float4 zq[CPL], dzq[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      zq[c] = ok[c] ? __ldg(z + s * nv + vq[c])
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      dzq[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

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
        float4 qv[U][CPL], gv[U][CPL];
        float liv[U][NH], rhv[U][NH];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = i0 + u * groups + grp;
          dd[u] = e < len ? list[e] : -1;
          const int64_t d = dd[u] < 0 ? 0 : dd[u];
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const bool on = dd[u] >= 0 && ok[c];
            qv[u][c] = on ? __ldg(q + d * nv + vq[c])
                          : make_float4(0.f, 0.f, 0.f, 0.f);
            gv[u][c] = on ? __ldg(g + d * nv + vq[c])
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          }
          const float* nr = nvec + d * 2 * heads;
#pragma unroll
          for (int t = 0; t < NH; ++t) {
            const bool on = dd[u] >= 0 && chain[t];
            liv[u][t] = on ? __ldg(nr + hq[t]) : 0.f;
            rhv[u][t] = on ? __ldg(nr + heads + hq[t]) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float zd[NH], ud[NH];  // z . q and g . z of the chain's head
#pragma unroll
          for (int t = 0; t < NH; ++t) zd[t] = ud[t] = 0.f;
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const int t = kOneHead ? 0 : c;
            zd[t] = fmaf(zq[c].x, qv[u][c].x, zd[t]);
            zd[t] = fmaf(zq[c].y, qv[u][c].y, zd[t]);
            zd[t] = fmaf(zq[c].z, qv[u][c].z, zd[t]);
            zd[t] = fmaf(zq[c].w, qv[u][c].w, zd[t]);
            ud[t] = fmaf(gv[u][c].x, zq[c].x, ud[t]);
            ud[t] = fmaf(gv[u][c].y, zq[c].y, ud[t]);
            ud[t] = fmaf(gv[u][c].z, zq[c].z, ud[t]);
            ud[t] = fmaf(gv[u][c].w, zq[c].w, ud[t]);
          }
          for (int off = red >> 1; off > 0; off >>= 1) {  // warp-uniform
#pragma unroll
            for (int t = 0; t < NH; ++t) {
              zd[t] += __shfl_xor_sync(kFull, zd[t], off);
              ud[t] += __shfl_xor_sync(kFull, ud[t], off);
            }
          }
          if (dd[u] < 0) continue;
          float al[NH], dr[NH];  // alpha and draw of the chain's head
#pragma unroll
          for (int t = 0; t < NH; ++t)
            edge_grad(zd[t], ud[t], liv[u][t], rhv[u][t], isd, al[t], dr[t]);
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const float a = al[kOneHead ? 0 : c];
            const float r = dr[kOneHead ? 0 : c];
            dzq[c].x += fmaf(r, qv[u][c].x, a * gv[u][c].x);
            dzq[c].y += fmaf(r, qv[u][c].y, a * gv[u][c].y);
            dzq[c].z += fmaf(r, qv[u][c].z, a * gv[u][c].z);
            dzq[c].w += fmaf(r, qv[u][c].w, a * gv[u][c].w);
          }
        }
      }
      __syncwarp();
      len = 0;
    }

    // the groups' sums, combined in a fixed order, then written once
    for (int off = lpe; off < 32; off <<= 1) {  // warp-uniform
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        dzq[c].x += __shfl_xor_sync(kFull, dzq[c].x, off);
        dzq[c].y += __shfl_xor_sync(kFull, dzq[c].y, off);
        dzq[c].z += __shfl_xor_sync(kFull, dzq[c].z, off);
        dzq[c].w += __shfl_xor_sync(kFull, dzq[c].w, off);
      }
    }
    if (grp != 0) continue;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (ok[c]) dz[s * nv + vq[c]] = dzq[c];
  }
}

// The entries a group of the dq walk keeps in flight: each brings one row,
// z[s], CPL vectors a lane, so K5's forward's count (bitgat.cu ListUnroll)
// at 1 and 2 vectors a lane; at 3 and 4 the row's q, g, [linv, rho] and
// sums beside them take dz's (DzUnroll: 1), where the forward's spilled
// (4 bytes a thread at (1, 128) on an H100, more with several heads).
template <int CPL>
struct DqUnroll {
  static constexpr int value = CPL == 1 ? 8 : CPL == 2 ? 4 : 1;
};

// dq by the listed walk by dst, the dz walk's lanes and layout on the
// other packing: rows d of packed, entries s.  The row's q[d], g[d] and
// [linv, rho] stay in registers; per entry the group gathers z[s], forms
// z . q and g . z per head over the head's lanes and adds draw z[s] into
// the row's sums.  The loop is the one K7's forward would take (the same
// rows, entries and gathers).
template <int CPL, bool kOneHead>
__global__ void __launch_bounds__(kWarps * 32, 2)
bitdot_dq_list_kernel(const uint32_t* __restrict__ packed, int64_t n32,
                      const int* __restrict__ order, int rows,
                      int64_t num_src, const float4* __restrict__ q,
                      const float4* __restrict__ z,
                      const float4* __restrict__ g,
                      const float* __restrict__ nvec,  // (rows, 2, H)
                      int heads, int nv, int vph, int lpe, float isd,
                      float4* __restrict__ dq, int* __restrict__ counter) {
  constexpr int U = DqUnroll<CPL>::value;
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
  bool chain[NH];  // the chain is a head of the row
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    vq[c] = li + lpe * c;
    ok[c] = vq[c] < nv;
  }
#pragma unroll
  for (int t = 0; t < NH; ++t) {
    hq[t] = kOneHead || !ok[t] ? 0 : vq[t] / vph;
    chain[t] = kOneHead || ok[t];
  }

  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(counter, 1);
    item = __shfl_sync(kFull, item, 0);
    if (item >= rows) break;  // warp-uniform
    const int64_t d = order[item];
    float4 qd[CPL], gd[CPL], acc[CPL];
    float liv[NH], rhv[NH];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      qd[c] = ok[c] ? __ldg(q + d * nv + vq[c])
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      gd[c] = ok[c] ? __ldg(g + d * nv + vq[c])
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const float* nr = nvec + d * 2 * heads;
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      liv[t] = chain[t] ? __ldg(nr + hq[t]) : 0.f;
      rhv[t] = chain[t] ? __ldg(nr + heads + hq[t]) : 0.f;
    }

    const uint32_t* prow = packed + d * n32;
    uint32_t word[kStepWords], next[kStepWords];
    list_start(word, next, prow, n32, lane);
    int64_t j0 = -32 * kStepWords;  // the step in hand
    int total = 0, first = 0, p0 = 0;  // its entries, the lane's, listed
    int len = 0;                       // entries in the list
    bool row_done = false;             // all warp-uniform
    while (!row_done) {
      list_bits(list, len, row_done, word, next, j0, total, first, p0, prow,
                n32, num_src, lane);
      // the drain: groups take consecutive entries, U each in flight,
      // every load of a batch issued before its arithmetic
      __syncwarp();
      for (int i0 = 0; i0 < len; i0 += groups * U) {
        int ss[U];
        float4 zv[U][CPL];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = i0 + u * groups + grp;
          ss[u] = e < len ? list[e] : -1;
          const int64_t s = ss[u] < 0 ? 0 : ss[u];
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            zv[u][c] = ss[u] >= 0 && ok[c]
                           ? __ldg(z + s * nv + vq[c])
                           : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float zd[NH], ud[NH];  // z . q and g . z of the chain's head
#pragma unroll
          for (int t = 0; t < NH; ++t) zd[t] = ud[t] = 0.f;
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const int t = kOneHead ? 0 : c;
            zd[t] = fmaf(zv[u][c].x, qd[c].x, zd[t]);
            zd[t] = fmaf(zv[u][c].y, qd[c].y, zd[t]);
            zd[t] = fmaf(zv[u][c].z, qd[c].z, zd[t]);
            zd[t] = fmaf(zv[u][c].w, qd[c].w, zd[t]);
            ud[t] = fmaf(gd[c].x, zv[u][c].x, ud[t]);
            ud[t] = fmaf(gd[c].y, zv[u][c].y, ud[t]);
            ud[t] = fmaf(gd[c].z, zv[u][c].z, ud[t]);
            ud[t] = fmaf(gd[c].w, zv[u][c].w, ud[t]);
          }
          for (int off = red >> 1; off > 0; off >>= 1) {  // warp-uniform
#pragma unroll
            for (int t = 0; t < NH; ++t) {
              zd[t] += __shfl_xor_sync(kFull, zd[t], off);
              ud[t] += __shfl_xor_sync(kFull, ud[t], off);
            }
          }
          if (ss[u] < 0) continue;
          float al[NH], dr[NH];  // alpha and draw of the chain's head
#pragma unroll
          for (int t = 0; t < NH; ++t)
            edge_grad(zd[t], ud[t], liv[t], rhv[t], isd, al[t], dr[t]);
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const float r = dr[kOneHead ? 0 : c];
            acc[c].x = fmaf(r, zv[u][c].x, acc[c].x);
            acc[c].y = fmaf(r, zv[u][c].y, acc[c].y);
            acc[c].z = fmaf(r, zv[u][c].z, acc[c].z);
            acc[c].w = fmaf(r, zv[u][c].w, acc[c].w);
          }
        }
      }
      __syncwarp();
      len = 0;
    }

    // the groups' sums, combined in a fixed order, then written once
    for (int off = lpe; off < 32; off <<= 1) {  // warp-uniform
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        acc[c].x += __shfl_xor_sync(kFull, acc[c].x, off);
        acc[c].y += __shfl_xor_sync(kFull, acc[c].y, off);
        acc[c].z += __shfl_xor_sync(kFull, acc[c].z, off);
        acc[c].w += __shfl_xor_sync(kFull, acc[c].w, off);
      }
    }
    if (grp != 0) continue;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (ok[c]) dq[d * nv + vq[c]] = acc[c];
  }
}

// The entries a group of the forward keeps in flight: each brings one row,
// z[s], CPL vectors a lane, as the dq walk's do, but the forward holds
// neither g nor [linv, rho], so it keeps more of them where ptxas still
// fits the walk in 128 registers with no local memory at the layouts of
// DotGatConv's gate (D >= 64: CPL 2 with several heads, 3 and 4 with
// one): 2 at 3 and 4 vectors a lane where the dq walk keeps 1.  At CPL 2
// 8 entries took 128 registers and 24 bytes of local memory a thread on
// an H100 (the probe's edit u2x), and 4 entries 107 registers and none
template <int CPL>
struct FwdUnroll {
  static constexpr int value = CPL == 1 ? 8 : CPL == 2 ? 4 : 2;
};

// The forward by the listed walk by dst, the dq walk's lanes, layout and
// rows: rows d of packed, entries s.  The row's q[d] stays in registers;
// per entry the group gathers z[s], forms z . q per head over the head's
// lanes, takes p = exp(clip(e, +-40)) and adds p into l's sum and p z[s]
// into out's.  At the row's end out = acc / max(l, 1e-20) is written once
// and l once a head, by the lane that holds the head's first vector.
template <int CPL, bool kOneHead>
__global__ void __launch_bounds__(kWarps * 32, 2)
bitdot_fwd_list_kernel(const uint32_t* __restrict__ packed, int64_t n32,
                       const int* __restrict__ order, int rows,
                       int64_t num_src, const float4* __restrict__ q,
                       const float4* __restrict__ z, int heads, int nv,
                       int vph, int lpe, float isd, float4* __restrict__ out,
                       float* __restrict__ l, int* __restrict__ counter) {
  constexpr int U = FwdUnroll<CPL>::value;
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
  bool lead[NH];  // the lane writes l of the chain's head
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    vq[c] = li + lpe * c;
    ok[c] = vq[c] < nv;
  }
#pragma unroll
  for (int t = 0; t < NH; ++t) {
    hq[t] = kOneHead || !ok[t] ? 0 : vq[t] / vph;
    lead[t] = grp == 0 && (kOneHead ? li == 0 : ok[t] && li % vph == 0);
  }

  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(counter, 1);
    item = __shfl_sync(kFull, item, 0);
    if (item >= rows) break;  // warp-uniform
    const int64_t d = order[item];
    float4 qd[CPL], acc[CPL];
    float lsum[NH];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      qd[c] = ok[c] ? __ldg(q + d * nv + vq[c])
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int t = 0; t < NH; ++t) lsum[t] = 0.f;

    const uint32_t* prow = packed + d * n32;
    uint32_t word[kStepWords], next[kStepWords];
    list_start(word, next, prow, n32, lane);
    int64_t j0 = -32 * kStepWords;  // the step in hand
    int total = 0, first = 0, p0 = 0;  // its entries, the lane's, listed
    int len = 0;                       // entries in the list
    bool row_done = false;             // all warp-uniform
    while (!row_done) {
      list_bits(list, len, row_done, word, next, j0, total, first, p0, prow,
                n32, num_src, lane);
      // the drain: groups take consecutive entries, U each in flight,
      // every load of a batch issued before its arithmetic
      __syncwarp();
      for (int i0 = 0; i0 < len; i0 += groups * U) {
        int ss[U];
        float4 zv[U][CPL];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = i0 + u * groups + grp;
          ss[u] = e < len ? list[e] : -1;
          const int64_t s = ss[u] < 0 ? 0 : ss[u];
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            zv[u][c] = ss[u] >= 0 && ok[c]
                           ? __ldg(z + s * nv + vq[c])
                           : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float zd[NH];  // z . q of the chain's head
#pragma unroll
          for (int t = 0; t < NH; ++t) zd[t] = 0.f;
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const int t = kOneHead ? 0 : c;
            zd[t] = fmaf(zv[u][c].x, qd[c].x, zd[t]);
            zd[t] = fmaf(zv[u][c].y, qd[c].y, zd[t]);
            zd[t] = fmaf(zv[u][c].z, qd[c].z, zd[t]);
            zd[t] = fmaf(zv[u][c].w, qd[c].w, zd[t]);
          }
          for (int off = red >> 1; off > 0; off >>= 1) {  // warp-uniform
#pragma unroll
            for (int t = 0; t < NH; ++t)
              zd[t] += __shfl_xor_sync(kFull, zd[t], off);
          }
          if (ss[u] < 0) continue;
          float pt[NH];  // p of the chain's head
#pragma unroll
          for (int t = 0; t < NH; ++t) {
            pt[t] = clip_exp(zd[t] * isd);
            lsum[t] += pt[t];
          }
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const float p = pt[kOneHead ? 0 : c];
            acc[c].x = fmaf(p, zv[u][c].x, acc[c].x);
            acc[c].y = fmaf(p, zv[u][c].y, acc[c].y);
            acc[c].z = fmaf(p, zv[u][c].z, acc[c].z);
            acc[c].w = fmaf(p, zv[u][c].w, acc[c].w);
          }
        }
      }
      __syncwarp();
      len = 0;
    }

    // the groups' sums, combined in a fixed order, then written once
    for (int off = lpe; off < 32; off <<= 1) {  // warp-uniform
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        acc[c].x += __shfl_xor_sync(kFull, acc[c].x, off);
        acc[c].y += __shfl_xor_sync(kFull, acc[c].y, off);
        acc[c].z += __shfl_xor_sync(kFull, acc[c].z, off);
        acc[c].w += __shfl_xor_sync(kFull, acc[c].w, off);
      }
#pragma unroll
      for (int t = 0; t < NH; ++t)
        lsum[t] += __shfl_xor_sync(kFull, lsum[t], off);
    }
    if (grp != 0) continue;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (!ok[c]) continue;
      const float den = fmaxf(lsum[kOneHead ? 0 : c], kDenEps);
      out[d * nv + vq[c]] = make_float4(acc[c].x / den, acc[c].y / den,
                                        acc[c].z / den, acc[c].w / den);
    }
#pragma unroll
    for (int t = 0; t < NH; ++t)
      if (lead[t]) l[d * heads + hq[t]] = lsum[t];
  }
}

// The listed walks (dz by src, dq by dst) take one argument list.
typedef void (*ListWalk)(const uint32_t*, int64_t, const int*, int, int64_t,
                         const float4*, const float4*, const float4*,
                         const float*, int, int, int, int, float, float4*,
                         int*);

// The walk's instance for (cpl, one head), null past 4 vectors a lane.
#define DGL_LIST_INSTANCE(KERNEL)                                           \
  switch (cpl) {                                                            \
    case 1: return one ? &KERNEL<1, true> : &KERNEL<1, false>;              \
    case 2: return one ? &KERNEL<2, true> : &KERNEL<2, false>;              \
    case 3: return one ? &KERNEL<3, true> : &KERNEL<3, false>;              \
    case 4: return one ? &KERNEL<4, true> : &KERNEL<4, false>;              \
    default: return nullptr;                                                \
  }
ListWalk dz_walk(int64_t cpl, bool one) {
  DGL_LIST_INSTANCE(bitdot_dz_list_kernel)
}
ListWalk dq_walk(int64_t cpl, bool one) {
  DGL_LIST_INSTANCE(bitdot_dq_list_kernel)
}

// The forward's argument list: two outputs, out and l, and no g or nvec
typedef void (*FwdWalk)(const uint32_t*, int64_t, const int*, int, int64_t,
                        const float4*, const float4*, int, int, int, int,
                        float, float4*, float*, int*);
FwdWalk fwd_walk(int64_t cpl, bool one) {
  DGL_LIST_INSTANCE(bitdot_fwd_list_kernel)
}
#undef DGL_LIST_INSTANCE

int launch_list_walk(ListWalk walk, const void* packed, int64_t words,
                     const void* order, int64_t rows, int64_t num_cols,
                     const void* q, const void* z, const void* g,
                     const void* nvec, int64_t heads, int64_t dp,
                     int64_t lpe, int64_t cpl, float isd, void* out,
                     void* counter, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const int64_t vph = dp / 4, nv = heads * vph;
  if (walk == nullptr || !list_layout_ok(heads, dp, lpe, cpl) ||
      num_cols > INT32_MAX || rows > INT32_MAX ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(z) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  unsigned blocks = 0;
  err = persistent_blocks(walk, kWarps * 32, (rows + kWarps - 1) / kWarps,
                          &blocks);
  if (err != cudaSuccess) return err;
  walk<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), words,
      static_cast<const int*>(order), static_cast<int>(rows), num_cols,
      static_cast<const float4*>(q), static_cast<const float4*>(z),
      static_cast<const float4*>(g), static_cast<const float*>(nvec),
      static_cast<int>(heads), static_cast<int>(nv), static_cast<int>(vph),
      static_cast<int>(lpe), isd, static_cast<float4*>(out),
      static_cast<int*>(counter));
  return cudaGetLastError();
}

int launch_fwd_walk(const void* packed, int64_t n32, const void* order,
                    int64_t rows, int64_t num_src, const void* q,
                    const void* z, int64_t heads, int64_t dp, int64_t lpe,
                    int64_t cpl, float isd, void* out, void* l,
                    void* counter, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const FwdWalk walk = fwd_walk(cpl, heads == 1);
  const int64_t vph = dp / 4, nv = heads * vph;
  if (walk == nullptr || !list_layout_ok(heads, dp, lpe, cpl) ||
      num_src > INT32_MAX || rows > INT32_MAX ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(z) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  unsigned blocks = 0;
  err = persistent_blocks(walk, kWarps * 32, (rows + kWarps - 1) / kWarps,
                          &blocks);
  if (err != cudaSuccess) return err;
  walk<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), n32,
      static_cast<const int*>(order), static_cast<int>(rows), num_src,
      static_cast<const float4*>(q), static_cast<const float4*>(z),
      static_cast<int>(heads), static_cast<int>(nv), static_cast<int>(vph),
      static_cast<int>(lpe), isd, static_cast<float4*>(out),
      static_cast<float*>(l), static_cast<int*>(counter));
  return cudaGetLastError();
}

// attrs (three host ints): the registers a thread, the local memory bytes
// a thread and the resident blocks an SM of a walk's instance
template <typename Walk>
int list_walk_attrs(Walk walk, int64_t device, void* attrs) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (walk == nullptr) return cudaErrorInvalidValue;
  int* out = static_cast<int*>(attrs);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, walk);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, walk,
                                                       kWarps * 32, 0);
}

}  // namespace

extern "C" {

// The forward by the listed walk by dst: out (rows of packed, H, dp) and l
// (rows of packed, H) f32, every row of `order` written (a row with no set
// bit gives 0 and 0), from packed (n32 words a row; bit b of word j <-> src
// b * n32 + j, bits at or past num_src skipped), order (rows,) int32, the
// dst rows in the order warps claim them (each once), q (rows of the dst)
// and z (num_src rows) of nv = H dp / 4 16-byte vectors, each head's dp
// columns padded with zeros, 16-byte aligned.  The layout (lpe, cpl, vph)
// as dgl_bitdot_bwd_dz_list's; num_src < 2^31.  counter is one int, zeroed
// by the caller.  Persistent blocks of 8 warps.
int dgl_bitdot_fwd_list(const void* packed, int64_t n32, const void* order,
                        int64_t rows, int64_t num_src, const void* q,
                        const void* z, int64_t heads, int64_t dp,
                        int64_t lpe, int64_t cpl, float isd, void* out,
                        void* l, void* counter, int64_t device,
                        void* stream) {
  return launch_fwd_walk(packed, n32, order, rows, num_src, q, z, heads, dp,
                         lpe, cpl, isd, out, l, counter, device, stream);
}

// dz by the listed walk by src: dz (rows of packed_rev, H, dp) f32, every
// row of `order` written (a row with no set bit gives 0), from packed_rev
// (k32 words a row; bit b of word j <-> dst b * k32 + j, bits at or past
// num_dst skipped), order (rows,) int32, the src rows in the order warps
// claim them (each once), q, g (num_dst rows) and z (rows of the src) of
// nv = H dp / 4 16-byte vectors, each head's dp columns padded with zeros,
// 16-byte aligned, and nvec (num_dst, 2, H) = [linv, rho].  lpe lanes an
// entry (a power of two up to 32), cpl = ceil(nv / lpe) <= 4 vectors a
// lane; with H > 1, vph = dp / 4 is a power of two dividing lpe.  num_dst <
// 2^31.  counter is one int, zeroed by the caller.  Persistent blocks of
// 8 warps.
int dgl_bitdot_bwd_dz_list(const void* packed_rev, int64_t k32,
                           const void* order, int64_t rows, int64_t num_dst,
                           const void* q, const void* z, const void* g,
                           const void* nvec, int64_t heads, int64_t dp,
                           int64_t lpe, int64_t cpl, float isd, void* dz,
                           void* counter, int64_t device, void* stream) {
  return launch_list_walk(dz_walk(cpl, heads == 1), packed_rev, k32, order,
                          rows, num_dst, q, z, g, nvec, heads, dp, lpe, cpl,
                          isd, dz, counter, device, stream);
}

// dq by the listed walk by dst: dq (rows of packed, H, dp) f32, every row
// of `order` written (a row with no set bit gives 0), from packed (n32
// words a row; bit b of word j <-> src b * n32 + j, bits at or past
// num_src skipped), order (rows,) int32, the dst rows in the order warps
// claim them (each once), q, g (rows of the dst) and z (num_src rows), and
// nvec (rows of the dst, 2, H) = [linv, rho]; the layout and the rest as
// dgl_bitdot_bwd_dz_list's.  num_src < 2^31.
int dgl_bitdot_bwd_dq_list(const void* packed, int64_t n32,
                           const void* order, int64_t rows, int64_t num_src,
                           const void* q, const void* z, const void* g,
                           const void* nvec, int64_t heads, int64_t dp,
                           int64_t lpe, int64_t cpl, float isd, void* dq,
                           void* counter, int64_t device, void* stream) {
  return launch_list_walk(dq_walk(cpl, heads == 1), packed, n32, order,
                          rows, num_src, q, z, g, nvec, heads, dp, lpe, cpl,
                          isd, dq, counter, device, stream);
}

// attrs (three host ints): the registers a thread, the local memory bytes
// a thread and the resident blocks an SM of the dz walk's instance for
// (cpl, one head).
int dgl_bitdot_dz_attrs(int64_t cpl, int64_t one_head, int64_t device,
                        void* attrs) {
  return list_walk_attrs(dz_walk(cpl, one_head != 0), device, attrs);
}

// The same of the dq walk's instance for (cpl, one head).
int dgl_bitdot_dq_attrs(int64_t cpl, int64_t one_head, int64_t device,
                        void* attrs) {
  return list_walk_attrs(dq_walk(cpl, one_head != 0), device, attrs);
}

// The same of the forward's instance for (cpl, one head).
int dgl_bitdot_fwd_attrs(int64_t cpl, int64_t one_head, int64_t device,
                         void* attrs) {
  return list_walk_attrs(fwd_walk(cpl, one_head != 0), device, attrs);
}

}  // extern "C"
