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
// Both kernels give one warp one row of a packing: the warp streams the
// row's words coalesced (one per lane, 8 in flight), skips zero words and
// walks the set bits with __ffs.  The TPU kernels scored every bit
// densely, since its lanes have no cheap way to skip; at 0.21% density a
// word holds ~0.07 set bits.  A lane owns the feature columns
// f = lane + 32 k (k < 4, so H * D <= 128) and the heads of those
// columns.  Sums and operands are f32.  Each kernel is behind a plain C
// function that launches on the caller's stream, allocates nothing and
// returns cudaGetLastError():
//
// bitgat_fwd_kernel  replaces dgl_tpu/ops/pallas/bitgat.py _fwd_call
//     (body _fwd_kernel).  Gather form over packed (rows = dst): for each
//     set bit s the warp adds p keep z[s, :] into registers; out and l
//     are written once, with no atomics and no sum across blocks.
//
// bitgat_bwd_kernel  replaces _bwd_call (body _bwd_kernel).  Src-major
//     over packed_rev (rows = src): the warp keeps z[s], dz[s] and del[s]
//     in registers, gathers g[d] and the (3, H) row [er, linv, rho] of d
//     for each set bit, and takes u by a warp-shuffle sum per head.
//     der[d] is a sum across src rows, taken with one global atomicAdd
//     per (edge, head) from the lane that starts the head (a native
//     red.global.add.f32; no shared-memory float atomics, which compile
//     to compare-and-swap loops), so its order of sums changes from run
//     to run.  Two variants measured slower on the H100 (PERF.md, K5):
//     a dst-major second pass over packed for der without atomics, and
//     one coalesced atomic per bit with a float4 node row.
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
// bitgat_bwd_kernel<C, false> launched on the shard: rows = kp src rows
// of the gathered el and z, k32 = the shard's W words, num_dst = the
// device's npp dst nodes; every offset it forms from a row and k32 is
// 64-bit, and it takes no square packing.
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
// cost, as in K2 (csrc/bitmm.cu), and each warp does it one bit after
// another.  The C functions and launch shapes are chosen by
// dgl_tpu_torch/ops/kernels/bitgat.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;   // warps per block
constexpr int kUnroll = 8;  // words each lane keeps in flight
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

// v[k] := the sum of v over the columns of head[k], across the warp.
template <int kCols>
__device__ __forceinline__ void head_sums(float (&v)[kCols],
                                          const Columns<kCols>& c, int heads,
                                          int dim) {
  if (32 % dim == 0) {
    // a head is an aligned group of dim lanes within one register
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      for (int off = dim >> 1; off > 0; off >>= 1)
        v[k] += __shfl_xor_sync(kFull, v[k], off);
    return;
  }
  float sum[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) sum[k] = 0.f;
  for (int h = 0; h < heads; ++h) {
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < kCols; ++k) part += c.head[k] == h ? v[k] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(kFull, part, off);
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (c.head[k] == h) sum[k] = part;
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) v[k] = sum[k];
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

template <int kCols, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
bitgat_bwd_kernel(const uint32_t* __restrict__ packed_rev, int64_t k32,
                  int64_t num_src, int64_t num_dst,
                  const float* __restrict__ el,
                  const float* __restrict__ nvec,  // (num_dst, 3, H)
                  const float* __restrict__ z, const float* __restrict__ g,
                  int heads, int dim, float slope, uint32_t thresh,
                  const int64_t* __restrict__ seed, float* __restrict__ dz,
                  float* __restrict__ del, float* __restrict__ der) {
  const int lane = threadIdx.x & 31;
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (s >= num_src) return;  // warp-uniform
  const int hd = heads * dim;
  const Columns<kCols> c(lane, heads, dim, kDrop);
  float elv[kCols], zv[kCols], dzacc[kCols], delacc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const bool valid = c.head[k] >= 0;
    elv[k] = valid ? __ldg(el + s * heads + c.head[k]) : 0.f;
    zv[k] = valid ? __ldg(z + s * hd + c.f[k]) : 0.f;
    dzacc[k] = 0.f;
    delacc[k] = 0.f;
  }
  const uint32_t spart =
      kDrop ? (static_cast<uint32_t>(s) * kC1) ^ static_cast<uint32_t>(*seed)
            : 0u;

  const uint32_t* prow = packed_rev + s * k32;
  for (int64_t j0 = 0; j0 < k32; j0 += 32 * kUnroll) {
    uint32_t word[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u * 32 + lane;
      word[u] = j < k32 ? __ldg(prow + j) : 0u;
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
          const int64_t d = static_cast<int64_t>(b) * k32 + j;
          if (d >= num_dst) continue;  // warp-uniform; padding bits are 0
          const float* nv = nvec + d * 3 * heads;
          float gv[kCols], dot[kCols], erv[kCols], linv[kCols], rho[kCols];
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const bool valid = c.head[k] >= 0;
            const int h = valid ? c.head[k] : 0;
            gv[k] = valid ? __ldg(g + d * hd + c.f[k]) : 0.f;
            erv[k] = __ldg(nv + h);
            linv[k] = __ldg(nv + heads + h);
            rho[k] = __ldg(nv + 2 * heads + h);
            dot[k] = gv[k] * zv[k];
          }
          head_sums<kCols>(dot, c, heads, dim);
          const uint32_t x0 =
              kDrop ? spart ^ (static_cast<uint32_t>(d) * kC2) : 0u;
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            if (c.head[k] < 0) continue;
            const float raw = elv[k] + erv[k];
            const float alpha = lrelu_exp(raw, slope) * linv[k];
            const float alpha_m =
                (!kDrop || keep_bit(x0, c.mult[k], thresh)) ? alpha : 0.f;
            const float de = alpha_m * dot[k] - alpha * rho[k];
            const float draw = raw > 0.f ? de : slope * de;
            dzacc[k] += alpha_m * gv[k];
            delacc[k] += draw;
            if (c.first[k]) atomicAdd(der + d * heads + c.head[k], draw);
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (c.head[k] < 0) continue;
    dz[s * hd + c.f[k]] = dzacc[k];
    if (c.first[k]) del[s * heads + c.head[k]] = delacc[k];
  }
}

__device__ __forceinline__ void red_add_v4(float* a, float x, float y,
                                           float z, float w) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(a),
               "f"(x), "f"(y), "f"(z), "f"(w)
               : "memory");
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

template <int kCols, bool kDrop>
cudaError_t launch_bwd(const void* packed_rev, int64_t k32, int64_t num_src,
                       int64_t num_dst, const void* el, const void* nvec,
                       const void* z, const void* g, int64_t heads,
                       int64_t dim, float slope, int64_t thresh,
                       const void* seed, void* dz, void* del, void* der,
                       cudaStream_t stream) {
  bitgat_bwd_kernel<kCols, kDrop><<<rows_grid(num_src), kWarps * 32, 0,
                                    stream>>>(
      static_cast<const uint32_t*>(packed_rev), k32, num_src, num_dst,
      static_cast<const float*>(el), static_cast<const float*>(nvec),
      static_cast<const float*>(z), static_cast<const float*>(g),
      static_cast<int>(heads), static_cast<int>(dim), slope,
      static_cast<uint32_t>(thresh), static_cast<const int64_t*>(seed),
      static_cast<float*>(dz), static_cast<float*>(del),
      static_cast<float*>(der));
  return cudaGetLastError();
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

// Backward: dz (num_src, H, D) and del (num_src, H) f32, every element
// written, and der (num_dst, H) f32, zeroed by the caller and summed with
// atomics, from packed_rev (>= num_src rows, k32 words), el (num_src, H),
// nvec (num_dst, 3, H) = [er, linv, rho], z (num_src, H, D) and g
// (num_dst, H, D) f32.  Grid: ceil(num_src / 8) blocks of 8 warps.
int dgl_bitgat_bwd(const void* packed_rev, int64_t k32, int64_t num_src,
                   int64_t num_dst, const void* el, const void* nvec,
                   const void* z, const void* g, int64_t heads, int64_t dim,
                   float slope, int64_t thresh, const void* seed, void* dz,
                   void* del, void* der, int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool drop = thresh != 0;
#define DGL_BWD(C, D)                                                        \
  return launch_bwd<C, D>(packed_rev, k32, num_src, num_dst, el, nvec, z, g, \
                          heads, dim, slope, thresh, seed, dz, del, der, st)
  switch ((heads * dim + 31) / 32) {
    case 1: if (drop) DGL_BWD(1, true); else DGL_BWD(1, false);
    case 2: if (drop) DGL_BWD(2, true); else DGL_BWD(2, false);
    case 3: if (drop) DGL_BWD(3, true); else DGL_BWD(3, false);
    case 4: if (drop) DGL_BWD(4, true); else DGL_BWD(4, false);
    default: return cudaErrorInvalidValue;
  }
#undef DGL_BWD
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
