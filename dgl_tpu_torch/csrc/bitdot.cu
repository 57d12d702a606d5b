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
// each kernel walks the set bits as K5 does (csrc/bitgat.cu): one warp
// owns one row of a packing, streams its words coalesced (one per lane, 8
// in flight), skips zero words and walks the set bits with __ffs.  A lane
// owns the feature columns f = lane + 32 k (k < 4, so H * D <= 128) and
// the heads of those columns; the dot products per head are warp-shuffle
// sums, segmented where a head spans part of a warp.  A row's sums stay in
// registers and are written once: no atomics, and a fixed order of sums.
// Operands and sums are f32.  Each kernel is behind a plain C function
// that launches on the caller's stream, allocates nothing and returns
// cudaGetLastError():
//
// bitdot_fwd_kernel  replaces dgl_tpu/ops/pallas/bitdot.py _fwd_call
//     (:156, body _fwd_kernel :97).  Over packed (rows = dst): q[d] in
//     registers; per set bit s the warp gathers z[s], takes e per head,
//     and adds p z[s] and p into out's and l's sums.
// bitdot_dz_kernel  replaces _bwdA_call (:272, body _bwdA_kernel :200),
//     which runs dst blocks over packed into per-src lanes.  Over
//     packed_rev (rows = src): z[s] and dz[s] in registers; per set bit d
//     the warp gathers q[d], g[d] and the (2, H) row [linv, rho] of d, and
//     takes e and u per head.
// bitdot_dq_kernel  replaces _bwdB_call (:368, body _bwdB_kernel :315).
//     Over packed (rows = dst): q[d], g[d], linv[d], rho[d] and dq[d] in
//     registers; per set bit s the warp gathers z[s] and takes e and u per
//     head.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): each kernel must
// stream the whole bitmask, K_pad * n32 * 4 bytes (6.93 GB at Reddit
// scale: 2.07 ms), plus each node-sized input and output once; the
// arithmetic, about E H (4 D + 5) operations forward, E H (8 D + 12) for
// dz and E H (6 D + 12) for dq, is 0.9-1.8 ms at (H, D) = (2, 64) on
// Reddit's 114.8M edges.  chip_smoke.py prints the bound of each call.
// As in K5, the per-set-bit work (a 512-byte row gathered from L2 or
// memory at H * D = 128, the shuffles, the exp) done one bit after another
// by each warp is the cost the design does not yet hide.  The C functions
// and launch shapes are chosen by dgl_tpu_torch/ops/kernels/bitdot.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;   // warps per block
constexpr int kUnroll = 8;  // words each lane keeps in flight
constexpr float kClip = 40.f;
constexpr float kDenEps = 1e-20f;

// The feature columns a lane owns: column f = lane + 32 k of the
// flattened (H, D) row, its head f / dim, and whether it starts its head
// (the one lane that writes the head's scalars).
template <int kCols>
struct Columns {
  int f[kCols];
  int head[kCols];  // -1 past H * D
  bool first[kCols];

  __device__ Columns(int lane, int heads, int dim) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      f[k] = lane + 32 * k;
      const bool valid = f[k] < heads * dim;
      head[k] = valid ? f[k] / dim : -1;
      first[k] = valid && f[k] % dim == 0;
    }
  }
};

// v[n][k] := the sum of v[n] over the columns of head[k], across the warp,
// for each of the kN arrays at once.
template <int kN, int kCols>
__device__ __forceinline__ void head_sums(float (&v)[kN][kCols],
                                          const Columns<kCols>& c, int heads,
                                          int dim) {
  if (32 % dim == 0) {
    // a head is an aligned group of dim lanes within one register
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      for (int off = dim >> 1; off > 0; off >>= 1)
#pragma unroll
        for (int n = 0; n < kN; ++n)
          v[n][k] += __shfl_xor_sync(kFull, v[n][k], off);
    return;
  }
  float sum[kN][kCols];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int k = 0; k < kCols; ++k) sum[n][k] = 0.f;
  for (int h = 0; h < heads; ++h) {
    float part[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      part[n] = 0.f;
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        part[n] += c.head[k] == h ? v[n][k] : 0.f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int n = 0; n < kN; ++n)
        part[n] += __shfl_xor_sync(kFull, part[n], off);
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (c.head[k] == h)
#pragma unroll
        for (int n = 0; n < kN; ++n) sum[n][k] = part[n];
  }
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int k = 0; k < kCols; ++k) v[n][k] = sum[n][k];
}

__device__ __forceinline__ float clip_exp(float e) {
  return expf(fminf(fmaxf(e, -kClip), kClip));
}

// The set bits of row `row` of a packing of `words` words a row, in
// order: calls visit(col) for each, col = b * words + j, on every lane of
// the warp (the loop is warp-uniform).  Columns at or past num_cols are
// padding, whose bits are 0.
template <typename Visit>
__device__ __forceinline__ void walk_row(const uint32_t* __restrict__ packed,
                                         int64_t words, int64_t row,
                                         int64_t num_cols, int lane,
                                         Visit visit) {
  const uint32_t* prow = packed + row * words;
  for (int64_t j0 = 0; j0 < words; j0 += 32 * kUnroll) {
    uint32_t word[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u * 32 + lane;
      word[u] = j < words ? __ldg(prow + j) : 0u;
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
          const int64_t col = static_cast<int64_t>(b) * words + j;
          if (col < num_cols) visit(col);
        }
      }
    }
  }
}

template <int kCols>
__global__ void __launch_bounds__(kWarps * 32)
bitdot_fwd_kernel(const uint32_t* __restrict__ packed, int64_t n32,
                  int64_t num_src, int64_t num_dst,
                  const float* __restrict__ q, const float* __restrict__ z,
                  int heads, int dim, float isd, float* __restrict__ out,
                  float* __restrict__ l) {
  const int lane = threadIdx.x & 31;
  const int64_t d =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (d >= num_dst) return;  // warp-uniform
  const int hd = heads * dim;
  const Columns<kCols> c(lane, heads, dim);
  float qv[kCols], acc[kCols], lsum[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    qv[k] = c.head[k] >= 0 ? __ldg(q + d * hd + c.f[k]) : 0.f;
    acc[k] = 0.f;
    lsum[k] = 0.f;
  }
  walk_row(packed, n32, d, num_src, lane, [&](int64_t s) {
    float zv[kCols], dot[1][kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      zv[k] = c.head[k] >= 0 ? __ldg(z + s * hd + c.f[k]) : 0.f;
      dot[0][k] = zv[k] * qv[k];
    }
    head_sums<1, kCols>(dot, c, heads, dim);
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      if (c.head[k] < 0) continue;  // as in K5's forward (csrc/bitgat.cu)
      const float p = clip_exp(dot[0][k] * isd);
      lsum[k] += p;
      acc[k] += p * zv[k];
    }
  });
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (c.head[k] < 0) continue;
    out[d * hd + c.f[k]] = acc[k] / fmaxf(lsum[k], kDenEps);
    if (c.first[k]) l[d * heads + c.head[k]] = lsum[k];
  }
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

template <int kCols>
__global__ void __launch_bounds__(kWarps * 32)
bitdot_dz_kernel(const uint32_t* __restrict__ packed_rev, int64_t k32,
                 int64_t num_src, int64_t num_dst,
                 const float* __restrict__ q, const float* __restrict__ z,
                 const float* __restrict__ g,
                 const float* __restrict__ nvec,  // (num_dst, 2, H)
                 int heads, int dim, float isd, float* __restrict__ dz) {
  const int lane = threadIdx.x & 31;
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (s >= num_src) return;  // warp-uniform
  const int hd = heads * dim;
  const Columns<kCols> c(lane, heads, dim);
  float zv[kCols], acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    zv[k] = c.head[k] >= 0 ? __ldg(z + s * hd + c.f[k]) : 0.f;
    acc[k] = 0.f;
  }
  walk_row(packed_rev, k32, s, num_dst, lane, [&](int64_t d) {
    const float* nv = nvec + d * 2 * heads;
    float qv[kCols], gv[kCols], linv[kCols], rho[kCols], dot[2][kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const bool valid = c.head[k] >= 0;
      const int h = valid ? c.head[k] : 0;
      qv[k] = valid ? __ldg(q + d * hd + c.f[k]) : 0.f;
      gv[k] = valid ? __ldg(g + d * hd + c.f[k]) : 0.f;
      linv[k] = __ldg(nv + h);
      rho[k] = __ldg(nv + heads + h);
      dot[0][k] = zv[k] * qv[k];
      dot[1][k] = gv[k] * zv[k];
    }
    head_sums<2, kCols>(dot, c, heads, dim);
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      if (c.head[k] < 0) continue;
      float alpha, draw;
      edge_grad(dot[0][k], dot[1][k], linv[k], rho[k], isd, alpha, draw);
      acc[k] += draw * qv[k] + alpha * gv[k];
    }
  });
#pragma unroll
  for (int k = 0; k < kCols; ++k)
    if (c.head[k] >= 0) dz[s * hd + c.f[k]] = acc[k];
}

template <int kCols>
__global__ void __launch_bounds__(kWarps * 32)
bitdot_dq_kernel(const uint32_t* __restrict__ packed, int64_t n32,
                 int64_t num_src, int64_t num_dst,
                 const float* __restrict__ q, const float* __restrict__ z,
                 const float* __restrict__ g,
                 const float* __restrict__ nvec,  // (num_dst, 2, H)
                 int heads, int dim, float isd, float* __restrict__ dq) {
  const int lane = threadIdx.x & 31;
  const int64_t d =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (d >= num_dst) return;  // warp-uniform
  const int hd = heads * dim;
  const Columns<kCols> c(lane, heads, dim);
  const float* nv = nvec + d * 2 * heads;
  float qv[kCols], gv[kCols], linv[kCols], rho[kCols], acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const bool valid = c.head[k] >= 0;
    const int h = valid ? c.head[k] : 0;
    qv[k] = valid ? __ldg(q + d * hd + c.f[k]) : 0.f;
    gv[k] = valid ? __ldg(g + d * hd + c.f[k]) : 0.f;
    linv[k] = __ldg(nv + h);
    rho[k] = __ldg(nv + heads + h);
    acc[k] = 0.f;
  }
  walk_row(packed, n32, d, num_src, lane, [&](int64_t s) {
    float zv[kCols], dot[2][kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      zv[k] = c.head[k] >= 0 ? __ldg(z + s * hd + c.f[k]) : 0.f;
      dot[0][k] = zv[k] * qv[k];
      dot[1][k] = gv[k] * zv[k];
    }
    head_sums<2, kCols>(dot, c, heads, dim);
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      if (c.head[k] < 0) continue;
      float alpha, draw;
      edge_grad(dot[0][k], dot[1][k], linv[k], rho[k], isd, alpha, draw);
      acc[k] += draw * zv[k];
    }
  });
#pragma unroll
  for (int k = 0; k < kCols; ++k)
    if (c.head[k] >= 0) dq[d * hd + c.f[k]] = acc[k];
}

dim3 rows_grid(int64_t rows) {
  return dim3(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
}

}  // namespace

// Every function takes the packing's row width (`words`), the src and dst
// counts, q (num_dst, H, D), z (num_src, H, D) and, in the backward, g
// (num_dst, H, D) and nvec (num_dst, 2, H) = [linv, rho], all f32 and
// contiguous, with H * D <= 128, and writes every element of its outputs.
// Grid: ceil(rows / 8) blocks of 8 warps, one warp a row.
#define DGL_BITDOT_SWITCH(LAUNCH)                \
  switch ((heads * dim + 31) / 32) {             \
    case 1: LAUNCH(1); break;                    \
    case 2: LAUNCH(2); break;                    \
    case 3: LAUNCH(3); break;                    \
    case 4: LAUNCH(4); break;                    \
    default: return cudaErrorInvalidValue;       \
  }                                              \
  return cudaGetLastError()

extern "C" {

// Forward over packed (rows = dst, n32 words): out (num_dst, H, D) and l
// (num_dst, H).
int dgl_bitdot_fwd(const void* packed, int64_t n32, int64_t num_src,
                   int64_t num_dst, const void* q, const void* z,
                   int64_t heads, int64_t dim, float isd, void* out, void* l,
                   int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DGL_FWD(C)                                                          \
  bitdot_fwd_kernel<C><<<rows_grid(num_dst), kWarps * 32, 0, st>>>(        \
      static_cast<const uint32_t*>(packed), n32, num_src, num_dst,          \
      static_cast<const float*>(q), static_cast<const float*>(z),           \
      static_cast<int>(heads), static_cast<int>(dim), isd,                  \
      static_cast<float*>(out), static_cast<float*>(l))
  DGL_BITDOT_SWITCH(DGL_FWD);
#undef DGL_FWD
}

// dz over packed_rev (rows = src, k32 words): dz (num_src, H, D).
int dgl_bitdot_bwd_dz(const void* packed_rev, int64_t k32, int64_t num_src,
                      int64_t num_dst, const void* q, const void* z,
                      const void* g, const void* nvec, int64_t heads,
                      int64_t dim, float isd, void* dz, int64_t device,
                      void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DGL_DZ(C)                                                           \
  bitdot_dz_kernel<C><<<rows_grid(num_src), kWarps * 32, 0, st>>>(         \
      static_cast<const uint32_t*>(packed_rev), k32, num_src, num_dst,      \
      static_cast<const float*>(q), static_cast<const float*>(z),           \
      static_cast<const float*>(g), static_cast<const float*>(nvec),        \
      static_cast<int>(heads), static_cast<int>(dim), isd,                  \
      static_cast<float*>(dz))
  DGL_BITDOT_SWITCH(DGL_DZ);
#undef DGL_DZ
}

// dq over packed (rows = dst, n32 words): dq (num_dst, H, D).
int dgl_bitdot_bwd_dq(const void* packed, int64_t n32, int64_t num_src,
                      int64_t num_dst, const void* q, const void* z,
                      const void* g, const void* nvec, int64_t heads,
                      int64_t dim, float isd, void* dq, int64_t device,
                      void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DGL_DQ(C)                                                           \
  bitdot_dq_kernel<C><<<rows_grid(num_dst), kWarps * 32, 0, st>>>(         \
      static_cast<const uint32_t*>(packed), n32, num_src, num_dst,          \
      static_cast<const float*>(q), static_cast<const float*>(z),           \
      static_cast<const float*>(g), static_cast<const float*>(nvec),        \
      static_cast<int>(heads), static_cast<int>(dim), isd,                  \
      static_cast<float*>(dq))
  DGL_BITDOT_SWITCH(DGL_DQ);
#undef DGL_DQ
}

}  // extern "C"
