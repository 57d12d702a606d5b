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
// The forward gives one warp one row of a packing: the warp streams the
// row's words coalesced (one per lane, 8 in flight), skips zero words and
// walks the set bits with __ffs, one after another.  The TPU kernels
// scored every bit densely, since its lanes have no cheap way to skip; at
// 0.21% density a word holds ~0.07 set bits.  There a lane owns the
// feature columns f = lane + 32 k (k < 4, so H * D <= 128) and the heads
// of those columns.  Sums and operands are f32.  Each kernel is
// behind a plain C function that launches on the caller's stream,
// allocates nothing and returns cudaGetLastError():
//
// bitgat_fwd_kernel  replaces dgl_tpu/ops/pallas/bitgat.py _fwd_call
//     (body _fwd_kernel).  Gather form over packed (rows = dst): for each
//     set bit s the warp adds p keep z[s, :] into registers; out and l
//     are written once, with no atomics and no sum across blocks.
//
// bitgat_bwd_list_kernel<CPL, kOneHead, kDrop>  replaces _bwd_call (body
//     _bwd_kernel), and serves K13 (below).  A listed-bit walk, src-major
//     over packed_rev (rows = src).  Persistent warps claim src rows from
//     a global counter in a claim order built once a format (hub rows,
//     over 4x the mean count of set bits, first, largest first; then the
//     rest by id), so that no hub starts late and holds up the end.  A
//     warp streams its row's words (8 a lane a step, the next step's
//     requested first), places each lane's set bits in its list in shared
//     memory by a warp prefix sum of popcounts, and drains the list (when
//     full, at 128 entries after a step, at the row's end): a group of
//     lpe lanes owns an entry, 16-byte loads of g[d] (heads padded to
//     whole vectors, 41 columns to 44), CPL vectors a lane (16 lanes and 2
//     vectors at (4, 32), 4 and 3 at (1, 41)), and every group issues the
//     loads of U entries (g and the (3, H) row [er, linv, rho]) before
//     their arithmetic.  A head's dot reduces over its lanes of the group
//     (3 shuffle levels at (4, 32), a lane's heads' chains side by side);
//     dz[s] and del[s] stay in each group's registers and are
//     combined across the groups by shuffles in a fixed order at the row's
//     end, so they keep one order of sums from run to run.  der[d] takes
//     one scalar reduction in L2 an (edge, head) from the first lane of
//     the head's block (4 an edge from two lanes at (4, 32)); its order
//     changes from run to run.  Gathering an edge's 4 heads into one
//     lane for a red.global.add.v4.f32 (2 shuffles an edge) ran slower.
//     The dropout hash is the forward's, bit for bit.  At most 128
//     registers a thread (16 warps an SM).  The walk replaced one that
//     gave a warp a src row and took its set bits one at a time, each
//     bit's gathers waiting on the previous bit's shuffles and atomics;
//     dgl_tpu_torch/tools/perf_bwd_walks.py times the two, the vector der
//     and a cap of 80 registers side by side (PERF.md, K5).
//
// bitgat_fwd_t_kernel  replaces _fwd_call in its own orientation, over
//     the bits of A^T (rows = src, bit columns = dst), without dropout:
//     the mesh-sharded GAT (dgl_tpu/parallel/bitgat_spmd.py:193-205) runs
//     the forward on a device's column shard of the A^T packing, which
//     bitgat_fwd_kernel cannot walk.  Scatter form, src-major as the
//     backward: one warp per src row streams the row's words (one per
//     lane, 8 in flight) and keeps z[s] and el[s] in registers, a lane
//     the four columns 4 lane .. 4 lane + 3 of the flattened (H, D) row.
//     Per set bit d each lane reads er[d] of its columns' heads, forms p
//     and adds p z[s] into row d of a sum buffer with one 16-byte
//     red.global.add.v4.f32 (the buffer's rows are padded to a multiple
//     of 4 floats, so that every row is 16-byte aligned); the lane that
//     starts a head adds p into l[d].  The adds are native reductions in
//     L2, in an order that changes from run to run.
//     bitgat_fwd_t_finish_kernel then writes out = sum / max(l, 1e-20).
//     A first version took 4.9x as long on the H100 (189.5 against
//     38.6 ms at (4, 32) on the Reddit graph's one-part shard,
//     chip_smoke.py; PERF.md, the sharded GAT): K1's slab walk with the
//     slab's sums in shared memory, whose float atomicAdd compiles to
//     compare-and-swap loops (ATOMS.CAST.SPIN), 128 a set bit.  An owner
//     warp for each of a slab's dst nodes, its sums in registers and
//     every warp scanning every row, was slower still.
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
// cost, as in K2 (csrc/bitmm.cu); the forward does it one bit after
// another, the listed walk keeps U entries a group in flight.  The C
// functions and launch shapes are chosen by
// dgl_tpu_torch/ops/kernels/bitgat.py (bwd_layout: dp, lpe and CPL).

#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;   // warps per block
constexpr int kUnroll = 8;  // words each lane keeps in flight
constexpr int kStepWords = 8;    // listed walk: words a lane loads a step
constexpr int kBwdList = 256;    // listed walk: entries a warp's list holds
constexpr int kBwdDrainAt = 128; // listed walk: a list this long is drained
constexpr uint32_t kC1 = 0x9E3779B1u;
constexpr uint32_t kC2 = 0x85EBCA6Bu;
__constant__ uint32_t kHeadMults[8] = {
    0xC2B2AE35u, 0x27D4EB2Fu, 0x165667B1u, 0x9E3779B9u,
    0x85EBCA77u, 0xC2B2AE3Du, 0x2545F491u, 0x94D049BBu};

// The feature columns a lane owns: column f = lane + 32 k of the
// flattened (H, D) row, its head f / dim, and whether it starts its head
// (the one lane that writes the head's scalars).
template <int kCols>
struct Columns {
  int f[kCols];
  int head[kCols];  // -1 past H * D
  bool first[kCols];
  uint32_t mult[kCols];

  __device__ Columns(int lane, int heads, int dim, bool drop) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      f[k] = lane + 32 * k;
      const bool valid = f[k] < heads * dim;
      head[k] = valid ? f[k] / dim : -1;
      first[k] = valid && f[k] % dim == 0;
      mult[k] = (drop && valid) ? kHeadMults[head[k] & 7] : 0u;
    }
  }
};

__device__ __forceinline__ float lrelu_exp(float raw, float slope) {
  return expf(fmaxf(raw, slope * raw));
}

__device__ __forceinline__ bool keep_bit(uint32_t x0, uint32_t mult,
                                         uint32_t thresh) {
  return ((x0 * mult) >> 17) < thresh;
}

__device__ __forceinline__ void red_add_v4(float* a, float x, float y,
                                           float z, float w) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(a),
               "f"(x), "f"(y), "f"(z), "f"(w)
               : "memory");
}

template <int kCols, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
bitgat_fwd_kernel(const uint32_t* __restrict__ packed, int64_t n32,
                  int64_t num_src, int64_t num_dst,
                  const float* __restrict__ el, const float* __restrict__ er,
                  const float* __restrict__ z, int heads, int dim,
                  float slope, uint32_t thresh,
                  const int64_t* __restrict__ seed,
                  float* __restrict__ out, float* __restrict__ l) {
  const int lane = threadIdx.x & 31;
  const int64_t d =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (d >= num_dst) return;  // warp-uniform
  const int hd = heads * dim;
  const Columns<kCols> c(lane, heads, dim, kDrop);
  float erv[kCols], acc[kCols], lsum[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    erv[k] = c.head[k] >= 0 ? __ldg(er + d * heads + c.head[k]) : 0.f;
    acc[k] = 0.f;
    lsum[k] = 0.f;
  }
  const uint32_t dpart =
      kDrop ? (static_cast<uint32_t>(d) * kC2) ^ static_cast<uint32_t>(*seed)
            : 0u;

  const uint32_t* prow = packed + d * n32;
  for (int64_t j0 = 0; j0 < n32; j0 += 32 * kUnroll) {
    uint32_t word[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u * 32 + lane;
      word[u] = j < n32 ? __ldg(prow + j) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      unsigned live = __ballot_sync(kFull, word[u] != 0u);
      while (live) {  // warp-uniform
        const int src_lane = __ffs(live) - 1;
        live &= live - 1;
        uint32_t bits = __shfl_sync(kFull, word[u], src_lane);
        const int64_t j = j0 + u * 32 + src_lane;
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          const int64_t s = static_cast<int64_t>(b) * n32 + j;
          if (s >= num_src) continue;  // warp-uniform; padding bits are 0
          const uint32_t x0 =
              kDrop ? (static_cast<uint32_t>(s) * kC1) ^ dpart : 0u;
          float zv[kCols], elv[kCols];
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const bool valid = c.head[k] >= 0;
            zv[k] = valid ? __ldg(z + s * hd + c.f[k]) : 0.f;
            elv[k] = valid ? __ldg(el + s * heads + c.head[k]) : 0.f;
          }
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            // this branch, though never taken at H * D = 128, made the
            // kernel 25% faster there on the H100 (PERF.md, K5)
            if (c.head[k] < 0) continue;
            const float p = lrelu_exp(elv[k] + erv[k], slope);
            lsum[k] += p;
            if (!kDrop || keep_bit(x0, c.mult[k], thresh))
              acc[k] += p * zv[k];
          }
        }
      }
    }
  }
  const float kp = kDrop ? static_cast<float>(thresh) / 32768.f : 1.f;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (c.head[k] < 0) continue;
    out[d * hd + c.f[k]] = acc[k] / (fmaxf(lsum[k], 1e-20f) * kp);
    if (c.first[k]) l[d * heads + c.head[k]] = lsum[k];
  }
}

// The listed-bit walk (K5's backward and K13).  Each row's z and g are
// padded to nv 16-byte vectors: heads of dp = 4 vph columns (vph a power of
// two when H > 1), so that no vector straddles two heads.  A group of lpe
// lanes owns an entry (a set bit, i.e. a dst d); lane li of the group holds
// vectors vq = li + lpe q (q < CPL) of the row.  With one head (kOneHead)
// the lane's vectors all belong to it and a dot reduces over the group's
// lpe lanes; with several, lpe is a multiple of vph and vector q of lane
// li lies in head (li + lpe q) / vph, reduced over that head's vph lanes
// (an aligned block of the group): every lane then holds its heads' sums,
// and chain q of the scalar work is head hq[q].
template <int CPL>
struct BwdUnroll {  // entries a group keeps in flight
  static constexpr int value =
      CPL == 1 ? 8 : CPL == 2 ? 4 : CPL == 3 ? 3 : 2;
};

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
  constexpr int U = BwdUnroll<CPL>::value;
  constexpr int NH = kOneHead ? 1 : CPL;  // scalar chains a lane
  __shared__ int lists[kWarps][kBwdList];
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
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    vq[q] = li + lpe * q;
    ok[q] = vq[q] < nv;
  }
#pragma unroll
  for (int t = 0; t < NH; ++t) {
    hq[t] = kOneHead ? 0 : vq[t] / vph;
    chain[t] = kOneHead || ok[t];
    mult[t] = kDrop && chain[t] ? kHeadMults[hq[t] & 7] : 0u;
  }
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

    // The row's words, kStepWords a lane a step, the next step's requested
    // before this one is listed.  A warp prefix sum of popcounts gives each
    // lane its place in the warp's list; the list is drained (below, the one
    // place that does) when it is full, when it holds kBwdDrainAt entries
    // at the end of a step, and at the end of the row.
    const uint32_t* prow = packed_rev + s * k32;
    uint32_t word[kStepWords], next[kStepWords];
#pragma unroll
    for (int u = 0; u < kStepWords; ++u) {
      const int64_t j = u * 32 + lane;
      next[u] = j < k32 ? __ldg(prow + j) : 0u;
      word[u] = 0u;
    }
    int64_t j0 = -32 * kStepWords;  // the step in hand
    int total = 0, first = 0, p0 = 0;  // its entries, the lane's, listed
    int len = 0;                       // entries in the list
    bool row_done = false;             // all warp-uniform
    while (!row_done) {
      for (;;) {
        if (p0 == total) {  // the step in hand is listed
          if (len >= kBwdDrainAt) break;
          j0 += 32 * kStepWords;
          if (j0 >= k32) {
            row_done = true;
            break;
          }
          int c = 0;
#pragma unroll
          for (int u = 0; u < kStepWords; ++u) {
            word[u] = next[u];
            c += __popc(word[u]);
            const int64_t j = j0 + 32 * kStepWords + u * 32 + lane;
            next[u] = j < k32 ? __ldg(prow + j) : 0u;
          }
          int incl = c;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += y;
          }
          total = __shfl_sync(kFull, incl, 31);
          first = incl - c;
          p0 = 0;
          continue;
        }
        if (len == kBwdList) break;
        // entries p0 .. p0 + take - 1 of the step, at list[len ..]
        const int take = min(kBwdList - len, total - p0);
        int idx = first;
#pragma unroll
        for (int u = 0; u < kStepWords; ++u) {
          uint32_t bits = word[u];
          const int pc = __popc(bits);
          if (idx + pc <= p0 || idx >= p0 + take) {  // none listed now
            idx += pc;
            continue;
          }
          const int64_t j = j0 + u * 32 + lane;
          while (bits) {
            const int b = __ffs(static_cast<int>(bits)) - 1;
            bits &= bits - 1u;
            if (idx >= p0 && idx < p0 + take) {
              const int64_t d = static_cast<int64_t>(b) * k32 + j;
              list[len + idx - p0] = d < num_dst ? static_cast<int>(d) : -1;
            }
            ++idx;
          }
        }
        len += take;
        p0 += take;
      }

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

// bitgat_fwd_t's sums: acc (zeroed, rows of ostride floats, ostride a
// multiple of 4) += p z[s], l (zeroed) += p for every set bit.
__global__ void __launch_bounds__(kWarps * 32)
bitgat_fwd_t_kernel(const uint32_t* __restrict__ packed_t, int64_t n32,
                    int64_t num_src, int64_t num_dst,
                    const float* __restrict__ el, const float* __restrict__ er,
                    const float* __restrict__ z, int heads, int dim,
                    float slope, int ostride, float* __restrict__ acc,
                    float* __restrict__ l) {
  const int lane = threadIdx.x & 31;
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (s >= num_src) return;  // warp-uniform
  const int hd = heads * dim;
  const bool lane_adds = 4 * lane < hd;
  float zv[4], elv[4];
  int head[4];
  bool valid[4], first[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int f = 4 * lane + k;
    valid[k] = f < hd;
    head[k] = valid[k] ? f / dim : 0;
    first[k] = valid[k] && f % dim == 0;
    zv[k] = valid[k] ? __ldg(z + s * hd + f) : 0.f;
    elv[k] = valid[k] ? __ldg(el + s * heads + head[k]) : 0.f;
  }

  const uint32_t* prow = packed_t + s * n32;
  for (int64_t j0 = 0; j0 < n32; j0 += 32 * kUnroll) {
    uint32_t word[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u * 32 + lane;
      word[u] = j < n32 ? __ldg(prow + j) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      unsigned live = __ballot_sync(kFull, word[u] != 0u);
      while (live) {  // warp-uniform
        const int src_lane = __ffs(live) - 1;
        live &= live - 1;
        uint32_t bits = __shfl_sync(kFull, word[u], src_lane);
        const int64_t j = j0 + u * 32 + src_lane;
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          const int64_t d = static_cast<int64_t>(b) * n32 + j;
          if (d >= num_dst) continue;  // warp-uniform; padding bits are 0
          float p[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            p[k] = valid[k]
                       ? lrelu_exp(elv[k] + __ldg(er + d * heads + head[k]),
                                   slope)
                       : 0.f;
          if (lane_adds)
            red_add_v4(acc + d * ostride + 4 * lane, p[0] * zv[0],
                       p[1] * zv[1], p[2] * zv[2], p[3] * zv[3]);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (first[k]) atomicAdd(l + d * heads + head[k], p[k]);
        }
      }
    }
  }
}

// out[d, f] = acc[d, f] / max(l[d, f / dim], 1e-20) for the num_dst x hd
// outputs, acc's rows ostride floats apart.
__global__ void bitgat_fwd_t_finish_kernel(const float* __restrict__ acc,
                                           const float* __restrict__ l,
                                           float* __restrict__ out,
                                           int64_t n, int hd, int dim,
                                           int ostride) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int64_t d = i / hd;
  const int f = static_cast<int>(i - d * hd);
  out[i] = __ldg(acc + d * ostride + f) /
           fmaxf(__ldg(l + i / dim), 1e-20f);
}

dim3 rows_grid(int64_t rows) {
  return dim3(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
}

template <int kCols, bool kDrop>
cudaError_t launch_fwd(const void* packed, int64_t n32, int64_t num_src,
                       int64_t num_dst, const void* el, const void* er,
                       const void* z, int64_t heads, int64_t dim, float slope,
                       int64_t thresh, const void* seed, void* out, void* l,
                       cudaStream_t stream) {
  bitgat_fwd_kernel<kCols, kDrop><<<rows_grid(num_dst), kWarps * 32, 0,
                                    stream>>>(
      static_cast<const uint32_t*>(packed), n32, num_src, num_dst,
      static_cast<const float*>(el), static_cast<const float*>(er),
      static_cast<const float*>(z), static_cast<int>(heads),
      static_cast<int>(dim), slope, static_cast<uint32_t>(thresh),
      static_cast<const int64_t*>(seed), static_cast<float*>(out),
      static_cast<float*>(l));
  return cudaGetLastError();
}

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

// The registers a thread and the blocks an SM of the instance.
template <int CPL, bool kOneHead, bool kDrop>
cudaError_t bwd_list_attrs(int* regs, int* per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(
      &attr, bitgat_bwd_list_kernel<CPL, kOneHead, kDrop>);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, bitgat_bwd_list_kernel<CPL, kOneHead, kDrop>, kWarps * 32, 0);
}

cudaError_t launch_fwd_t(const void* packed_t, int64_t n32, int64_t num_src,
                         int64_t num_dst, const void* el, const void* er,
                         const void* z, int64_t heads, int64_t dim,
                         float slope, int64_t ostride, void* acc, void* out,
                         void* l, cudaStream_t stream) {
  bitgat_fwd_t_kernel<<<rows_grid(num_src), kWarps * 32, 0, stream>>>(
      static_cast<const uint32_t*>(packed_t), n32, num_src, num_dst,
      static_cast<const float*>(el), static_cast<const float*>(er),
      static_cast<const float*>(z), static_cast<int>(heads),
      static_cast<int>(dim), slope, static_cast<int>(ostride),
      static_cast<float*>(acc), static_cast<float*>(l));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = num_dst * heads * dim;
  bitgat_fwd_t_finish_kernel<<<static_cast<unsigned>((n + 255) / 256), 256,
                               0, stream>>>(
      static_cast<const float*>(acc), static_cast<const float*>(l),
      static_cast<float*>(out), n, static_cast<int>(heads * dim),
      static_cast<int>(dim), static_cast<int>(ostride));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward: out (num_dst, H, D) and l (num_dst, H) f32, every element
// written, from packed (>= num_dst rows, n32 words), el (num_src, H), er
// (num_dst, H), z (num_src, H, D) f32 and the seed (one int64 on the card,
// low 32 bits used); thresh 0 means no dropout, else 1..32768 and H <= 8.
// Grid: ceil(num_dst / 8) blocks of 8 warps.
int dgl_bitgat_fwd(const void* packed, int64_t n32, int64_t num_src,
                   int64_t num_dst, const void* el, const void* er,
                   const void* z, int64_t heads, int64_t dim, float slope,
                   int64_t thresh, const void* seed, void* out, void* l,
                   int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool drop = thresh != 0;
#define DGL_FWD(C, D)                                                       \
  return launch_fwd<C, D>(packed, n32, num_src, num_dst, el, er, z, heads, \
                          dim, slope, thresh, seed, out, l, st)
  switch ((heads * dim + 31) / 32) {
    case 1: if (drop) DGL_FWD(1, true); else DGL_FWD(1, false);
    case 2: if (drop) DGL_FWD(2, true); else DGL_FWD(2, false);
    case 3: if (drop) DGL_FWD(3, true); else DGL_FWD(3, false);
    case 4: if (drop) DGL_FWD(4, true); else DGL_FWD(4, false);
    default: return cudaErrorInvalidValue;
  }
#undef DGL_FWD
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
  if (heads < 1 || dp < 4 || dp % 4 != 0 || lpe < 1 || lpe > 32 ||
      (lpe & (lpe - 1)) != 0 || cpl < 1 || cpl > 4 ||
      (nv + lpe - 1) / lpe != cpl || num_dst > INT32_MAX ||
      rows > INT32_MAX ||
      (heads > 1 && ((vph & (vph - 1)) != 0 || lpe % vph != 0)) ||
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

// regs_blocks (two host ints): the registers a thread of the listed walk's
// instance for (cpl, one head, dropout) and its resident blocks an SM.
int dgl_bitgat_bwd_list_attrs(int64_t cpl, int64_t one_head, int64_t drop,
                              int64_t device, void* regs_blocks) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  int* out = static_cast<int*>(regs_blocks);
#define DGL_BWD_ATTRS(C)                                                    \
  case C:                                                                   \
    if (one_head) return drop ? bwd_list_attrs<C, true, true>(out, out + 1) \
                              : bwd_list_attrs<C, true, false>(out, out + 1); \
    return drop ? bwd_list_attrs<C, false, true>(out, out + 1)              \
                : bwd_list_attrs<C, false, false>(out, out + 1);
  switch (cpl) {
    DGL_BWD_ATTRS(1)
    DGL_BWD_ATTRS(2)
    DGL_BWD_ATTRS(3)
    DGL_BWD_ATTRS(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef DGL_BWD_ATTRS
}

// Forward over the bits of A^T: out (num_dst, H, D) f32, every element
// written, and l (num_dst, H) f32, zeroed by the caller, from packed_t
// (>= num_src rows, n32 words; bit b of word j <-> dst b * n32 + j), el
// (num_src, H), er (num_dst, H) and z (num_src, H, D) f32, H D <= 128,
// without dropout; acc is a zeroed (num_dst, ostride) f32 sum buffer,
// ostride >= H D a multiple of 4 (16-byte aligned rows).  Grid:
// ceil(num_src / 8) blocks of 8 warps, then a divide pass.
int dgl_bitgat_fwd_t(const void* packed_t, int64_t n32, int64_t num_src,
                     int64_t num_dst, const void* el, const void* er,
                     const void* z, int64_t heads, int64_t dim, float slope,
                     int64_t ostride, void* acc, void* out, void* l,
                     int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (heads * dim > 128 || ostride < heads * dim || ostride % 4 != 0 ||
      reinterpret_cast<uintptr_t>(acc) % 16 != 0)
    return cudaErrorInvalidValue;
  return launch_fwd_t(packed_t, n32, num_src, num_dst, el, er, z, heads, dim,
                      slope, ostride, acc, out, l,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
