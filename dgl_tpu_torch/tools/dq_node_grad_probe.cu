// The two kernels that K7's dq and K11 v2's node gradient left, built by
// dgl_tpu_torch/tools/perf_dq_node_grad.py with the package's nvcc flags
// and timed beside the kernels that replaced them; they are not on any
// main path.  Each is the package's code as it stood before the redesign:
//
// bitdot_dq_kernel<kCols>  (csrc/bitdot.cu; replaces
//     dgl_tpu/ops/pallas/bitdot.py _bwdB_call :368): one warp a dst row of
//     packed, its set bits walked one at a time (walk_row: the row's words
//     one a lane, 8 in flight, zero words skipped, bits by __ffs); q[d],
//     g[d], linv[d], rho[d] and dq[d] in registers, per bit the warp
//     gathers z[s] with scalar loads, takes z . q and g . z per head by
//     warp shuffles (head_sums), then the exp; rows launched in id order.
//     Replaced by the listed walk by dst, bitdot_dq_list_kernel.
// vattn_node_grad_kernel<G, kSrc, kFe>  (csrc/gatv2.cu; with kFe > 0 the
//     dv part of dgl_tpu/ops/pallas/gat_fused.py _egatc2_dv_da_kernel
//     :1975 and _egatc2_du_kernel :2024): one block per (dst or src tile,
//     chunk of G columns, split of the tile's buckets), the tile's (tile,
//     G) sums in shared memory; G lanes a slot form raw (fe from up to kFe
//     rows of wf a lane) and dW for their column and add dW at the slot's
//     row with a float shared atomicAdd (a compare-and-swap loop on this
//     card); the splits meet with global atomics.  Replaced by the row
//     walk's edge-term form, csrc/row_agg.cu row_fe_grad_kernel.  Its kFe
//     = 0 instances (K9's node gradient, which the row walk replaced
//     first) are built by tools/perf_bwd_walks.py from an edit of this
//     file (TILED_K9).
//
// Each is behind a plain C function that launches on the caller's stream
// and returns cudaGetLastError(), with the argument list it had in the
// package (dgl_probe_dq_warp is dgl_bitdot_bwd_dq's).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;   // warps per block
constexpr int kUnroll = 8;  // words each lane keeps in flight
constexpr float kClip = 40.f;
constexpr int kNodeWarps = 16;    // warps per node-grad block

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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct Slots {
  const int* src_local;
  const int* dst_local;
  const float* valid;
  const int* src_tile;
  const int* dst_tile;
};

struct Operands {
  const float* u;
  const float* v;
  const float* attn;
  const float* ef;
  const float* wf;
  int fe, fe_rows, heads, dim;
  float slope;
};

template <int G, bool kSrc, int kFe>
__global__ void __launch_bounds__(kNodeWarps * 32)
vattn_node_grad_kernel(const int* __restrict__ src_local,
                       const int* __restrict__ dst_local,
                       const float* __restrict__ valid,
                       const int* __restrict__ src_tile,
                       const int* __restrict__ dst_tile,
                       const int* __restrict__ order,
                       const int* __restrict__ ptr, int tile, int cap,
                       const float* __restrict__ u,
                       const float* __restrict__ v,
                       const float* __restrict__ attn,
                       const float* __restrict__ ds,
                       const float* __restrict__ ef,
                       const float* __restrict__ wf, int fe, int has_bias,
                       int heads, int dim, float slope,
                       float* __restrict__ out, int num_rows, int splits) {
  constexpr bool kEdge = kFe > 0;
  constexpr int kF = kEdge ? kFe : 1;
  constexpr int kSlots = 32 / G;  // slots a warp serves per step
  extern __shared__ float acc[];  // [tile][G]
  const int hd = heads * dim;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / G;
  const int gcol = lane % G;
  const int t = blockIdx.x;
  const int col = blockIdx.y * G + gcol;
  const bool col_ok = col < hd;
  for (int i = threadIdx.x; i < tile * G; i += blockDim.x) acc[i] = 0.f;
  const int h = col_ok ? col / dim : 0;
  const float a_c = col_ok ? attn[col] : 0.f;
  float wf_r[kF];   // this lane's column of wf
  float bias_c = 0.f;
#pragma unroll
  for (int r = 0; r < kF; ++r) {
    wf_r[r] = (kEdge && col_ok && r < fe) ? wf[r * hd + col] : 0.f;
  }
  if (kEdge && col_ok && has_bias) bias_c = wf[fe * hd + col];
  __syncthreads();

  const int k_lo = ptr[t];
  const int nb = ptr[t + 1] - k_lo;
  const int k0 = k_lo + static_cast<int>(
      static_cast<long long>(nb) * blockIdx.z / splits);
  const int k1 = k_lo + static_cast<int>(
      static_cast<long long>(nb) * (blockIdx.z + 1) / splits);
  const int per_bucket = cap / 32;
  const int n_chunks = (k1 - k0) * per_bucket;
  for (int k = warp; k < n_chunks; k += kNodeWarps) {
    const int kb = k0 + k / per_bucket;
    const int b = kSrc ? order[kb] : kb;
    const int c0 = (k % per_bucket) * 32;
    const int s0 = b * cap + c0;
    const float vld = valid[s0 + lane];
    if (__ballot_sync(kFull, vld != 0.f) == 0u) continue;  // padded tail
    const int sl = src_local[s0 + lane];
    const int dl = dst_local[s0 + lane];
    const float* ut = u + static_cast<long long>(src_tile[b]) * tile * hd
                      + col;
    const float* vt = v + static_cast<long long>(dst_tile[b]) * tile * hd
                      + col;
    const float* dsb = ds + b * heads * cap + h * cap + c0;
#pragma unroll 4
    for (int i = 0; i < G; ++i) {
      const int j = i * kSlots + sub;  // the chunk's slot at step i
      const int slj = __shfl_sync(kFull, sl, j);
      const int dlj = __shfl_sync(kFull, dl, j);
      const bool live = __shfl_sync(kFull, vld, j) != 0.f && col_ok;
      if (!live) continue;
      float raw = __ldg(ut + slj * hd) + __ldg(vt + dlj * hd);
      if (kEdge) {
        const float* e = ef + static_cast<long long>(s0 + j) * fe;
        raw += bias_c;
#pragma unroll
        for (int r = 0; r < kF; ++r) {
          if (r < fe) raw += __ldg(e + r) * wf_r[r];
        }
      }
      const float dw = __ldg(dsb + j) * a_c * (raw >= 0.f ? 1.f : slope);
      atomicAdd(acc + (kSrc ? slj : dlj) * G + gcol, dw);
    }
  }
  __syncthreads();

  const int r0 = t * tile;
  for (int i = threadIdx.x; i < tile * G; i += blockDim.x) {
    const int row = r0 + i / G;
    const int c = blockIdx.y * G + i % G;
    if (row >= num_rows || c >= hd) continue;
    if (splits == 1) {
      out[static_cast<long long>(row) * hd + c] = acc[i];
    } else if (acc[i] != 0.f) {
      atomicAdd(out + static_cast<long long>(row) * hd + c, acc[i]);
    }
  }
}

template <int G, bool kSrc, int kFe>
cudaError_t launch_node_grad(Slots sl, const int* order, const int* ptr,
                             int num_tiles, int tile, int cap, Operands op,
                             const float* ds, int has_bias, float* out,
                             int num_rows, int splits, cudaStream_t stream) {
  const size_t smem = sizeof(float) * tile * G;
  const cudaError_t err = allow_smem(vattn_node_grad_kernel<G, kSrc, kFe>,
                                     smem);
  if (err != cudaSuccess) return err;
  const int hd = op.heads * op.dim;
  const dim3 grid(static_cast<unsigned>(num_tiles),
                  static_cast<unsigned>((hd + G - 1) / G),
                  static_cast<unsigned>(splits));
  vattn_node_grad_kernel<G, kSrc, kFe><<<grid, kNodeWarps * 32, smem,
                                         stream>>>(
      sl.src_local, sl.dst_local, sl.valid, sl.src_tile, sl.dst_tile, order,
      ptr, tile, cap, op.u, op.v, op.attn, ds, op.ef, op.wf, op.fe, has_bias,
      op.heads, op.dim, op.slope, out, num_rows, splits);
  return cudaGetLastError();
}

template <int G, bool kSrc>
cudaError_t node_grad_fe(int fe_cap, Slots sl, const int* order,
                         const int* ptr, int num_tiles, int tile, int cap,
                         Operands op, const float* ds, int has_bias,
                         float* out, int num_rows, int splits,
                         cudaStream_t stream) {
  switch (fe_cap) {
    case 8:
      return launch_node_grad<G, kSrc, 8>(sl, order, ptr, num_tiles, tile,
                                          cap, op, ds, has_bias, out,
                                          num_rows, splits, stream);
    case 16:
      return launch_node_grad<G, kSrc, 16>(sl, order, ptr, num_tiles, tile,
                                           cap, op, ds, has_bias, out,
                                           num_rows, splits, stream);
    case 32:
      return launch_node_grad<G, kSrc, 32>(sl, order, ptr, num_tiles, tile,
                                           cap, op, ds, has_bias, out,
                                           num_rows, splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kSrc>
cudaError_t node_grad_group(int group, int fe_cap, Slots sl,
                            const int* order, const int* ptr, int num_tiles,
                            int tile, int cap, Operands op, const float* ds,
                            int has_bias, float* out, int num_rows,
                            int splits, cudaStream_t stream) {
  switch (group) {
    case 8:
      return node_grad_fe<8, kSrc>(fe_cap, sl, order, ptr, num_tiles, tile,
                                   cap, op, ds, has_bias, out, num_rows,
                                   splits, stream);
    case 16:
      return node_grad_fe<16, kSrc>(fe_cap, sl, order, ptr, num_tiles, tile,
                                    cap, op, ds, has_bias, out, num_rows,
                                    splits, stream);
    case 32:
      return node_grad_fe<32, kSrc>(fe_cap, sl, order, ptr, num_tiles, tile,
                                    cap, op, ds, has_bias, out, num_rows,
                                    splits, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

Slots slots(const void* src_local, const void* dst_local, const void* valid,
            const void* src_tile, const void* dst_tile) {
  return Slots{static_cast<const int*>(src_local),
               static_cast<const int*>(dst_local),
               static_cast<const float*>(valid),
               static_cast<const int*>(src_tile),
               static_cast<const int*>(dst_tile)};
}

Operands operands(const void* u, const void* v, const void* attn,
                  const void* ef, const void* wf, int64_t fe,
                  int64_t fe_rows, int64_t heads, int64_t dim, double slope) {
  return Operands{static_cast<const float*>(u),
                  static_cast<const float*>(v),
                  static_cast<const float*>(attn),
                  static_cast<const float*>(ef),
                  static_cast<const float*>(wf),
                  static_cast<int>(fe),
                  static_cast<int>(fe_rows),
                  static_cast<int>(heads),
                  static_cast<int>(dim),
                  static_cast<float>(slope)};
}

}  // namespace

extern "C" {

// dq over packed (rows = dst, n32 words): dq (num_dst, H, D).
int dgl_probe_dq_warp(const void* packed, int64_t n32, int64_t num_src,
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
  switch ((heads * dim + 31) / 32) {
    case 1: DGL_DQ(1); break;
    case 2: DGL_DQ(2); break;
    case 3: DGL_DQ(3); break;
    case 4: DGL_DQ(4); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
#undef DGL_DQ
}

// out (num_rows, heads * dim): the sum of dW over the valid slots of each
// dst row (src_side = 0: ptr is dst_ptr, order unused) or src row
// (src_side = 1: order is src_order, ptr is src_ptr), with the edge term
// from ef (num_buckets * cap, fe) and wf (fe + has_bias, heads * dim),
// fe_cap 8, 16 or 32 >= fe (K11 v2; K9's node gradient, with no edge
// term, is csrc/row_agg.cu's).  group (8, 16 or 32) is G; with splits > 1,
// out must be zeroed by the caller.  Grid: (num_tiles, ceil(heads * dim /
// G), splits).
int dgl_vattn_node_grad(const void* src_local, const void* dst_local,
                        const void* valid, const void* src_tile,
                        const void* dst_tile, const void* order,
                        const void* ptr, int64_t num_tiles, int64_t tile,
                        int64_t cap, const void* u, const void* v,
                        const void* attn, const void* ds, const void* ef,
                        const void* wf, int64_t fe, int64_t has_bias,
                        int64_t fe_cap, int64_t heads, int64_t dim,
                        double slope, void* out, int64_t num_rows,
                        int64_t group, int64_t splits, int64_t src_side,
                        int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Slots sl = slots(src_local, dst_local, valid, src_tile, dst_tile);
  const Operands op = operands(u, v, attn, ef, wf, fe, fe + has_bias, heads,
                               dim, slope);
  const int cap_fe = ef == nullptr ? 0 : static_cast<int>(fe_cap);
  if (src_side != 0) {
    return node_grad_group<true>(
        static_cast<int>(group), cap_fe, sl, static_cast<const int*>(order),
        static_cast<const int*>(ptr), static_cast<int>(num_tiles),
        static_cast<int>(tile), static_cast<int>(cap), op,
        static_cast<const float*>(ds), static_cast<int>(has_bias),
        static_cast<float*>(out), static_cast<int>(num_rows),
        static_cast<int>(splits), s);
  }
  return node_grad_group<false>(
      static_cast<int>(group), cap_fe, sl, static_cast<const int*>(order),
      static_cast<const int*>(ptr), static_cast<int>(num_tiles),
      static_cast<int>(tile), static_cast<int>(cap), op,
      static_cast<const float*>(ds), static_cast<int>(has_bias),
      static_cast<float*>(out), static_cast<int>(num_rows),
      static_cast<int>(splits), s);
}


// regs_local (two ints): the registers a thread and local-memory bytes a
// thread of the tiled walk's edge instance <group, src side, fe_cap>.
int dgl_probe_node_grad_attrs(int64_t group, int64_t src_side,
                              int64_t fe_cap, int64_t device,
                              void* regs_local) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
#define DGL_NG_ATTRS(G_, S_, F_)                                          \
  if (group == G_ && (src_side != 0) == S_ && fe_cap == F_)               \
    err = cudaFuncGetAttributes(&attr, vattn_node_grad_kernel<G_, S_, F_>);
#define DGL_NG_ATTRS_G(G_, S_) \
  DGL_NG_ATTRS(G_, S_, 8) DGL_NG_ATTRS(G_, S_, 16) DGL_NG_ATTRS(G_, S_, 32)
  attr.numRegs = -1;
  DGL_NG_ATTRS_G(8, false) DGL_NG_ATTRS_G(16, false) DGL_NG_ATTRS_G(32, false)
  DGL_NG_ATTRS_G(8, true) DGL_NG_ATTRS_G(16, true) DGL_NG_ATTRS_G(32, true)
#undef DGL_NG_ATTRS_G
#undef DGL_NG_ATTRS
  if (err != cudaSuccess) return err;
  if (attr.numRegs < 0) return cudaErrorInvalidValue;
  int* o = static_cast<int*>(regs_local);
  o[0] = attr.numRegs;
  o[1] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

}  // extern "C"
