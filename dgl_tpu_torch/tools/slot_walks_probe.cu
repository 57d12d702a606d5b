// The two kernels that K10's and K11 v1's slot walks and edge ds left,
// built by dgl_tpu_torch/tools/perf_slot_walks.py with the package's nvcc
// flags and timed beside the walks that replaced them; they are not on
// any main path.  Each is the package's code as it stood in
// csrc/gat_fused.cu before the redesign:
//
// src_agg_kernel<G, kMode, T>  (dgl_slot_agg, dgl_slot_feat_reduce): one
//     block per (tile, chunk of G columns, split of the tile's buckets, in
//     src_order for a walk by src tile); the tile's rows for the chunk in
//     shared memory, (tile, G) f32, 128 KB at tile 1024 and G = 32; G
//     lanes per slot gather a row's columns, scale them by the slot's
//     weight of the column's head and add them at the slot's local row
//     with a float shared atomicAdd (a compare-and-swap loop on this card);
//     every slot walked once per chunk of G columns, splits met with global
//     atomics.  Its modes (AggMode): kAggFeat, K10 v2's slot-feature reduce
//     (dgl_tpu/ops/pallas/gat_fused.py _eg2_agg_kernel :1582's edge term, the
//     dWe and d(attn_e) sums of _eg2_ds_kernel :1605 and
//     _eg2_dx_def_kernel :1639); kAggFe, K10 v1's numerator
//     (_agg_fe_kernel :1276); kAggDxDfe, K10 v1's dx with dfe
//     (_dx_dfe_kernel :1320); kAggVecDst and kAggVecSrc, K11 v1's dFNJ and
//     dFNI (_egatc_dv_da_dfe_kernel :979, _dw_src_kernel :1020).  Replaced
//     by the slot walk, csrc/row_agg.cu row_slot_kernel.
// gat_ds_kernel<L, kEdge, kDef, T, kStore>  (dgl_gat_ds): one warp a
//     32-slot chunk of a bucket, L lanes a head, x[src] and zn[dst]
//     gathered with scalar loads at every slot, padded ones included, 4
//     slots in flight, xor-shuffle sums and the epilogue (- rp, * g) per
//     slot.  Its modes: 1 and 2, K10 v2's ds with the edge term ef[s] .
//     Zp[dst, h] (Zp[dst] re-read at every slot) and with d(ef) written by
//     the warp after its chunk (_eg2_ds_kernel :1605, the d(ef) part of
//     _eg2_dx_def_kernel :1639); 3 and 4, K10 v1's ds with its stored f32
//     or bf16 message term added to x[src] (_ds_fe_kernel :1299).
//     Replaced by the dot-product walk by dst (csrc/row_agg.cu
//     row_sddmm_kernel; for modes 3 and 4 with the stored row added,
//     <CPL, false, true, T>) and its finishing pass ds_finish_kernel (for
//     modes 1 and 2 with the edge dot and d(ef), <1, SM, kDef, true>).
//     Its mode 0 (K6's ds, which the dot-product walk replaced first) is
//     built by dgl_tpu_torch/tools/perf_ds_fold.py from an edit of this
//     file (BUCKET_DS).
//
// Each is behind the plain C function it had in the package, which
// launches on the caller's stream and returns cudaGetLastError().
//
// Layout (dgl_tpu_torch/ops/kernels/tiled_spmm.py): edges bucketed by (dst
// tile, src tile) pairs of `tile` nodes, `cap` slots per bucket; for flat
// slot s = b * cap + c, src_local[s] / dst_local[s] are ids within tiles
// src_tile[b] / dst_tile[b], and valid[s] is 1 for a real edge.  dst tile
// t owns the buckets [dst_ptr[t], dst_ptr[t + 1]); src tile t owns the
// buckets src_order[src_ptr[t] .. src_ptr[t + 1]).  Slot tensors are (B, H,
// C) f32; the stored slot tensors (B * C, F) f32 or bf16 (T), read and
// written at 64-bit offsets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A stored slot tensor's element as f32, and back: T is float or
// __nv_bfloat16.
__device__ __forceinline__ float ld_slot(const float* t, long long i) {
  return __ldg(t + i);
}
__device__ __forceinline__ float ld_slot(const __nv_bfloat16* t,
                                         long long i) {
  return __bfloat162float(__ldg(t + i));
}
__device__ __forceinline__ void st_slot(float* t, long long i, float v) {
  t[i] = v;
}
__device__ __forceinline__ void st_slot(__nv_bfloat16* t, long long i,
                                        float v) {
  t[i] = __float2bfloat16(v);
}

// What src_agg_kernel adds at a slot's row for column j of head h = j /
// head_cols (w is a (B, H, C) slot tensor, t a (B * C, F) one of type T)
enum AggMode : int {
  kAggFeat = 1,    // by dst tile: w[h] * ef[s, j % head_cols]    (S, Q)
  kAggFe = 2,      // by dst tile: w[h] * (x[src, j] + t[s, j])   (K10 v1 num)
  kAggDxDfe = 3,   // by src tile: w[h] * z[dst, j], also t[s, j] = that
  kAggVecDst = 4,  // by dst tile: t[s, j]                        (dFNJ)
  kAggVecSrc = 5,  // by src tile: t[s, j]                        (dFNI)
};

constexpr unsigned kFull = 0xffffffffu;
constexpr int kDsWarps = 8;       // warps per ds block
constexpr int kDsUnroll = 4;      // ds slots in flight per warp
constexpr int kDsCols = 4;        // ds columns a lane loads per slot at once
constexpr int kAggWarps = 16;     // warps per src_agg block

// T: the type of fe_s, K10 v1's stored (B * C, H * Fh) message term added
// to x[src] (kStore); float and unused otherwise.
template <int L, bool kEdge, bool kDef, typename T = float,
          bool kStore = false>
__global__ void __launch_bounds__(kDsWarps * 32)
gat_ds_kernel(const int* __restrict__ src_local,
              const int* __restrict__ dst_local,
              const float* __restrict__ valid,
              const int* __restrict__ src_tile,
              const int* __restrict__ dst_tile, int num_buckets, int tile,
              int cap, const float* __restrict__ x,
              const float* __restrict__ zn, const float* __restrict__ rp,
              const float* __restrict__ g, int heads, int fh,
              const float* __restrict__ ef, const float* __restrict__ zp,
              int fe, const float* __restrict__ p,
              const float* __restrict__ m, float* __restrict__ d_ef,
              const T* __restrict__ fe_s, float* ds) {
  constexpr int kHeadsPerPass = 32 / L;
  const int lane = threadIdx.x & 31;
  const int hl = lane / L;  // head of this lane within a pass
  const int fl = lane % L;  // first column of this lane within its head
  const int hf = heads * fh;
  const int per_bucket = cap / 32;
  const int n_chunks = num_buckets * per_bucket;
  for (int k = blockIdx.x * kDsWarps + (threadIdx.x >> 5); k < n_chunks;
       k += gridDim.x * kDsWarps) {
    const int b = k / per_bucket;
    const int c0 = (k % per_bucket) * 32;  // the chunk's first slot in b
    const int s0 = b * cap + c0;
    const float v = valid[s0 + lane];
    const int sl = src_local[s0 + lane];
    const int dl = dst_local[s0 + lane];
    const int d0 = dst_tile[b] * tile;    // the dst tile's first row
    const float* xt = x + src_tile[b] * tile * hf;
    const float* zt = zn + d0 * hf;
    const int ob = b * heads * cap + c0;  // ds[b, h, c0 + j] = ds[ob+h*cap+j]
    if (__ballot_sync(kFull, v != 0.f) == 0u) {  // a padded tail: all 0
      for (int h = 0; h < heads; ++h) ds[ob + h * cap + lane] = 0.f;
      if (kDef) {
        for (int i = lane; i < 32 * fe; i += 32) d_ef[s0 * fe + i] = 0.f;
      }
      continue;
    }
    for (int j0 = 0; j0 < 32; j0 += kDsUnroll) {
      const float* xr[kDsUnroll];
      const float* zr[kDsUnroll];
      const float* er[kDsUnroll];  // kEdge: the slot's features
      const float* pr[kDsUnroll];  // kEdge: Zp[dst]
      long long fo[kDsUnroll];     // kStore: the slot's row of fe_s
      int dr[kDsUnroll];
      bool live[kDsUnroll];
#pragma unroll
      for (int u = 0; u < kDsUnroll; ++u) {
        live[u] = __shfl_sync(kFull, v, j0 + u) != 0.f;  // warp-uniform
        const int dlj = __shfl_sync(kFull, dl, j0 + u);
        dr[u] = d0 + dlj;
        xr[u] = xt + __shfl_sync(kFull, sl, j0 + u) * hf;
        zr[u] = zt + dlj * hf;
        er[u] = kEdge ? ef + (s0 + j0 + u) * fe : nullptr;
        pr[u] = kEdge ? zp + dr[u] * heads * fe : nullptr;
        fo[u] = static_cast<long long>(s0 + j0 + u) * hf;
      }
      for (int h0 = 0; h0 < heads; h0 += kHeadsPerPass) {
        const int h = h0 + hl;
        const int c_end = h < heads ? (h + 1) * fh : 0;  // this head's end
        float s[kDsUnroll];
#pragma unroll
        for (int u = 0; u < kDsUnroll; ++u) s[u] = 0.f;
        for (int cb = h * fh + fl; cb < c_end; cb += L * kDsCols) {
          float xv[kDsUnroll][kDsCols];
          float zv[kDsUnroll][kDsCols];
#pragma unroll
          for (int u = 0; u < kDsUnroll; ++u) {
#pragma unroll
            for (int i = 0; i < kDsCols; ++i) {
              const int c = cb + i * L;
              const bool ok = live[u] && c < c_end;
              xv[u][i] = ok ? __ldg(xr[u] + c) : 0.f;
              if (kStore && ok) xv[u][i] += ld_slot(fe_s, fo[u] + c);
              zv[u][i] = ok ? __ldg(zr[u] + c) : 0.f;
            }
          }
#pragma unroll
          for (int u = 0; u < kDsUnroll; ++u) {
#pragma unroll
            for (int i = 0; i < kDsCols; ++i) s[u] += xv[u][i] * zv[u][i];
          }
        }
        if (kEdge) {  // + ef[s, :] . Zp[dst, h, :], Fe strided by L
          const int f_end = h < heads ? fe : 0;
          for (int f = fl; f < f_end; f += L) {
#pragma unroll
            for (int u = 0; u < kDsUnroll; ++u) {
              if (live[u]) {
                s[u] += __ldg(er[u] + f) * __ldg(pr[u] + h * fe + f);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kDsUnroll; ++u) {
#pragma unroll
          for (int o = L / 2; o > 0; o >>= 1) {
            s[u] += __shfl_xor_sync(kFull, s[u], o);
          }
          if (fl == 0 && h < heads) {
            const int e = ob + h * cap + j0 + u;
            ds[e] = live[u] ? (s[u] - __ldg(rp + dr[u] * heads + h)) * g[e]
                            : 0.f;
          }
        }
      }
    }
    if (kDef) {
      // d(ef)[s, f] = sum_h p[h] Zp[dst, h, f] + ds[h] M[f, h] for the
      // chunk's 32 x fe values, one per lane and step; the warp's ds
      // stores above are visible after the barrier
      __syncwarp();
      for (int i = lane; i < 32 * fe; i += 32) {
        const int j = i / fe;
        const int f = i - j * fe;
        const int dlj = __shfl_sync(kFull, dl, j);
        float acc = 0.f;
        if (__shfl_sync(kFull, v, j) != 0.f) {
          const float* zq = zp + (d0 + dlj) * heads * fe + f;
          for (int h = 0; h < heads; ++h) {
            const int e = ob + h * cap + j;
            acc += __ldg(p + e) * __ldg(zq + h * fe) +
                   ds[e] * __ldg(m + f * heads + h);
          }
        }
        d_ef[s0 * fe + i] = acc;
      }
    }
  }
}

template <int G, int kMode, typename T = float>
__global__ void __launch_bounds__(kAggWarps * 32)
src_agg_kernel(const int* __restrict__ src_local,
               const int* __restrict__ dst_local,
               const float* __restrict__ valid, const float* __restrict__ w,
               int heads, int head_cols, const int* __restrict__ src_tile,
               const int* __restrict__ dst_tile,
               const int* __restrict__ order, const int* __restrict__ ptr,
               int tile, int cap, const float* __restrict__ z, T* t, int f,
               float* __restrict__ out, int num_rows, int splits) {
  // The walk is by src tile through order (kAggDxDfe, kAggVecSrc) or by
  // dst tile (ptr is dst_ptr, order unused); the f columns are head_cols a
  // head.  z is the node operand (z[dst] for kAggDxDfe, x[src] for
  // kAggFe), or for kAggFeat ef (B * C, head_cols) in slot order, whose
  // column j % head_cols every head reads; t is the stored (B * C, f) slot
  // tensor, read or (kAggDxDfe) written.
  constexpr bool kSrcWalk = kMode == kAggDxDfe || kMode == kAggVecSrc;
  constexpr bool kWeighted = kMode <= kAggDxDfe;
  constexpr bool kNodeRow = kMode == kAggFe || kMode == kAggDxDfe;
  constexpr bool kReadsT =
      kMode == kAggFe || kMode == kAggVecDst || kMode == kAggVecSrc;
  extern __shared__ float acc[];  // [tile][G]
  constexpr int kSlots = 32 / G;  // slots a warp serves per step
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / G;
  const int gcol = lane % G;
  const int tl = blockIdx.x;
  const int col = blockIdx.y * G + gcol;
  const bool col_ok = col < f;
  for (int i = threadIdx.x; i < tile * G; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int k_lo = ptr[tl];
  const int nb = ptr[tl + 1] - k_lo;
  const int k0 = k_lo + static_cast<int>(
      static_cast<long long>(nb) * blockIdx.z / splits);
  const int k1 = k_lo + static_cast<int>(
      static_cast<long long>(nb) * (blockIdx.z + 1) / splits);
  const int per_bucket = cap / 32;
  const int n_chunks = (k1 - k0) * per_bucket;
  // the head of this lane's column, as an offset in a bucket's w rows,
  // and (kAggFeat) the feature it reads of each slot's row
  const int col_head = col_ok ? col / head_cols : 0;
  const int w_head = col_head * cap;
  const int e_col = col - col_head * head_cols;

  for (int k = warp; k < n_chunks; k += kAggWarps) {
    const int b = kSrcWalk ? order[k0 + k / per_bucket] : k0 + k / per_bucket;
    const int c0 = (k % per_bucket) * 32;
    const int s0 = b * cap + c0;
    const float v = valid[s0 + lane];
    if (__ballot_sync(kFull, v != 0.f) == 0u) {  // a padded tail
      if (kMode == kAggDxDfe && col_ok) {
        for (int i = 0; i < G; ++i) {
          st_slot(t, static_cast<long long>(s0 + i * kSlots + sub) * f + col,
                  0.f);
        }
      }
      continue;
    }
    // the row each slot adds at, and the node row it reads
    const int rl = kSrcWalk ? src_local[s0 + lane] : dst_local[s0 + lane];
    const int nl = kMode == kAggFe ? src_local[s0 + lane]
                   : kNodeRow      ? dst_local[s0 + lane]
                                   : 0;
    const float* zt =
        kMode == kAggFeat ? z + s0 * head_cols + e_col
        : kMode == kAggFe ? z + src_tile[b] * tile * f + col
        : kNodeRow        ? z + dst_tile[b] * tile * f + col
                          : nullptr;
    const float* wb = kWeighted ? w + b * heads * cap + w_head + c0 : nullptr;
    float xv[G];
    int sv[G];
    unsigned on = 0u;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int j = i * kSlots + sub;  // the chunk's slot at step i
      const int nlj = __shfl_sync(kFull, nl, j);
      sv[i] = __shfl_sync(kFull, rl, j);
      const bool live = __shfl_sync(kFull, v, j) != 0.f && col_ok;
      const long long ts = static_cast<long long>(s0 + j) * f + col;
      float val = 0.f;
      if (live) {
        if (kMode == kAggFeat) val = __ldg(zt + j * head_cols);
        if (kNodeRow) val = __ldg(zt + nlj * f);
        if (kReadsT) val += ld_slot(t, ts);
        if (kWeighted) val *= __ldg(wb + j);
      }
      if (kMode == kAggDxDfe && col_ok) st_slot(t, ts, val);
      xv[i] = val;
      on |= static_cast<unsigned>(live) << i;
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (on & (1u << i)) atomicAdd(acc + sv[i] * G + gcol, xv[i]);
    }
  }
  __syncthreads();

  const int r0 = tl * tile;
  for (int i = threadIdx.x; i < tile * G; i += blockDim.x) {
    const int row = r0 + i / G;
    const int c = blockIdx.y * G + i % G;
    if (row >= num_rows || c >= f) continue;
    if (splits == 1) {
      out[row * f + c] = acc[i];
    } else if (acc[i] != 0.f) {
      atomicAdd(out + row * f + c, acc[i]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int L, bool kEdge, bool kDef, typename T, bool kStore>
cudaError_t launch_ds(const void* src_local, const void* dst_local,
                      const void* valid, const void* src_tile,
                      const void* dst_tile, int64_t num_buckets, int64_t tile,
                      int64_t cap, const void* x, const void* zn,
                      const void* rp, const void* g, int64_t heads,
                      int64_t fh, const void* ef, const void* zp, int64_t fe,
                      const void* p, const void* m, void* d_ef,
                      const void* fe_s, void* ds, int64_t blocks,
                      cudaStream_t stream) {
  gat_ds_kernel<L, kEdge, kDef, T, kStore><<<static_cast<unsigned>(blocks),
                                             kDsWarps * 32, 0, stream>>>(
      static_cast<const int*>(src_local), static_cast<const int*>(dst_local),
      static_cast<const float*>(valid), static_cast<const int*>(src_tile),
      static_cast<const int*>(dst_tile), static_cast<int>(num_buckets),
      static_cast<int>(tile), static_cast<int>(cap),
      static_cast<const float*>(x), static_cast<const float*>(zn),
      static_cast<const float*>(rp), static_cast<const float*>(g),
      static_cast<int>(heads), static_cast<int>(fh),
      static_cast<const float*>(ef), static_cast<const float*>(zp),
      static_cast<int>(fe), static_cast<const float*>(p),
      static_cast<const float*>(m), static_cast<float*>(d_ef),
      static_cast<const T*>(fe_s), static_cast<float*>(ds));
  return cudaGetLastError();
}

// mode: 1 K10 v2's ds with its edge term, 2 with its d(ef) too, 3 and 4
// with K10 v1's stored f32 or bf16 fe; K6's ds without either (mode 0) is
// csrc/row_agg.cu's
template <int L>
cudaError_t launch_ds_mode(int mode, const void* src_local,
                           const void* dst_local, const void* valid,
                           const void* src_tile, const void* dst_tile,
                           int64_t num_buckets, int64_t tile, int64_t cap,
                           const void* x, const void* zn, const void* rp,
                           const void* g, int64_t heads, int64_t fh,
                           const void* ef, const void* zp, int64_t fe,
                           const void* p, const void* m, void* d_ef,
                           const void* fe_s, void* ds, int64_t blocks,
                           cudaStream_t stream) {
#define DGL_DS_ARGS                                                          \
  src_local, dst_local, valid, src_tile, dst_tile, num_buckets, tile, cap,   \
      x, zn, rp, g, heads, fh, ef, zp, fe, p, m, d_ef, fe_s, ds, blocks,     \
      stream
  switch (mode) {
    case 1:
      return launch_ds<L, true, false, float, false>(DGL_DS_ARGS);
    case 2:
      return launch_ds<L, true, true, float, false>(DGL_DS_ARGS);
    case 3:
      return launch_ds<L, false, false, float, true>(DGL_DS_ARGS);
    case 4:
      return launch_ds<L, false, false, __nv_bfloat16, true>(DGL_DS_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
#undef DGL_DS_ARGS
}

struct AggArgs {
  const int* src_local;
  const int* dst_local;
  const float* valid;
  const float* w;
  int heads, head_cols;
  const int* src_tile;
  const int* dst_tile;
  const int* order;
  const int* ptr;
  int num_tiles, tile, cap;
  const float* z;
  void* t;
  int f;
  float* out;
  int num_rows, splits;
};

template <int G, int kMode, typename T>
cudaError_t launch_src_agg(const AggArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * a.tile * G;
  const cudaError_t err = allow_smem(src_agg_kernel<G, kMode, T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(a.num_tiles),
                  static_cast<unsigned>((a.f + G - 1) / G),
                  static_cast<unsigned>(a.splits));
  src_agg_kernel<G, kMode, T><<<grid, kAggWarps * 32, smem, stream>>>(
      a.src_local, a.dst_local, a.valid, a.w, a.heads, a.head_cols,
      a.src_tile, a.dst_tile, a.order, a.ptr, a.tile, a.cap, a.z,
      static_cast<T*>(a.t), a.f, a.out, a.num_rows, a.splits);
  return cudaGetLastError();
}

template <int kMode, typename T>
cudaError_t launch_src_agg_group(int64_t group, const AggArgs& a,
                                 cudaStream_t stream) {
  switch (group) {
    case 8:
      return launch_src_agg<8, kMode, T>(a, stream);
    case 16:
      return launch_src_agg<16, kMode, T>(a, stream);
    case 32:
      return launch_src_agg<32, kMode, T>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// K10 v1's and K11 v1's modes over a stored slot tensor of type T
template <typename T>
cudaError_t launch_slot_agg(int64_t mode, int64_t group, const AggArgs& a,
                            cudaStream_t stream) {
  switch (mode) {
    case kAggFe:
      return launch_src_agg_group<kAggFe, T>(group, a, stream);
    case kAggDxDfe:
      return launch_src_agg_group<kAggDxDfe, T>(group, a, stream);
    case kAggVecDst:
      return launch_src_agg_group<kAggVecDst, T>(group, a, stream);
    case kAggVecSrc:
      return launch_src_agg_group<kAggVecSrc, T>(group, a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// ds (num_buckets, heads, cap), every element written, from x (num_src,
// heads, fh), zn (num_dst, heads, fh), rp (num_dst, heads) and g (the
// shape of ds), with an edge term: with ef (B * cap, fe) and zp
// (num_dst, heads, fe) not null, ds adds ef[s, :] . zp[dst, h, :] inside
// the bracket (without ef and fe_s the call is refused); with p (the
// shape of ds), m (fe, heads) and d_ef (B * cap, fe) also not null, d_ef
// is written too, 0 at padded slots.  With fe_s (B * cap, heads * fh) not
// null (and ef null), fe_s[s] is added to x[src] in the dot, read as f32
// (store 1) or bf16 (store 2).  lanes is L, the lanes per head (32 over
// heads rounded up to a power of two, at least 1).  Grid: `blocks` blocks
// of 8 warps, grid-stride over 32-slot chunks.
int dgl_gat_ds(const void* src_local, const void* dst_local,
               const void* valid, const void* src_tile, const void* dst_tile,
               int64_t num_buckets, int64_t tile, int64_t cap, const void* x,
               const void* zn, const void* rp, const void* g, int64_t heads,
               int64_t fh, const void* ef, const void* zp, int64_t fe,
               const void* p, const void* m, void* d_ef, const void* fe_s,
               int64_t store, void* ds, int64_t lanes, int64_t blocks,
               int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fe_s != nullptr && (ef != nullptr || (store != 1 && store != 2))) {
    return cudaErrorInvalidValue;
  }
  const int mode = fe_s != nullptr  ? 2 + static_cast<int>(store)
                   : ef == nullptr  ? 0
                   : d_ef == nullptr ? 1
                                     : 2;
#define DGL_DS_CASE(L_)                                                      \
  case L_:                                                                   \
    return launch_ds_mode<L_>(mode, src_local, dst_local, valid, src_tile,   \
                              dst_tile, num_buckets, tile, cap, x, zn, rp,   \
                              g, heads, fh, ef, zp, fe, p, m, d_ef, fe_s,    \
                              ds, blocks, s);
  switch (lanes) {
    DGL_DS_CASE(1)
    DGL_DS_CASE(2)
    DGL_DS_CASE(4)
    DGL_DS_CASE(8)
    DGL_DS_CASE(16)
    DGL_DS_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef DGL_DS_CASE
}

// out (num_dst, heads, fe): out[v, h, k] = sum over the valid slots s with
// dst v of w[b, h, c] * ef[s, k], ef (B * cap, fe) and w (B, heads, cap).
// group (8, 16 or 32) is G over the heads * fe columns; with splits > 1,
// out must be zeroed by the caller.  Grid: (num_dst_tiles, ceil(heads * fe
// / G), splits).
int dgl_slot_feat_reduce(const void* dst_local, const void* valid,
                         const void* w, int64_t heads, int64_t fe,
                         const void* dst_ptr, int64_t num_dst_tiles,
                         int64_t tile, int64_t cap, const void* ef,
                         void* out, int64_t num_dst, int64_t group,
                         int64_t splits, int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const AggArgs a{nullptr, static_cast<const int*>(dst_local),
                  static_cast<const float*>(valid),
                  static_cast<const float*>(w), static_cast<int>(heads),
                  static_cast<int>(fe), nullptr, nullptr, nullptr,
                  static_cast<const int*>(dst_ptr),
                  static_cast<int>(num_dst_tiles), static_cast<int>(tile),
                  static_cast<int>(cap), static_cast<const float*>(ef),
                  nullptr, static_cast<int>(heads * fe),
                  static_cast<float*>(out), static_cast<int>(num_dst),
                  static_cast<int>(splits)};
  return launch_src_agg_group<kAggFeat, float>(
      group, a, static_cast<cudaStream_t>(stream));
}

// out (num_rows, f) over a stored slot tensor t (B * cap, f), f32 (dtype
// 1) or bf16 (dtype 2), with f = heads * head_cols and w (B, heads, cap):
//   mode 2 (by dst tile; ptr dst_ptr): out[v, j] = sum w[b, h, c] (z[src,
//     j] + t[s, j]), z = x (num_src, f);
//   mode 3 (by src tile; order src_order, ptr src_ptr): out[u, j] = sum
//     w[b, h, c] z[dst, j], z (num_dst, f), and t[s, j] = w[b, h, c] z[dst,
//     j] at every slot, 0 at padded ones;
//   mode 4 / 5 (by dst / src tile): out[row, j] = sum t[s, j].
// h = j / head_cols.  group (8, 16 or 32) is G; with splits > 1, out must
// be zeroed by the caller.  Grid: (num_tiles, ceil(f / G), splits).
int dgl_slot_agg(const void* src_local, const void* dst_local,
                 const void* valid, const void* w, int64_t heads,
                 int64_t head_cols, const void* src_tile,
                 const void* dst_tile, const void* order, const void* ptr,
                 int64_t num_tiles, int64_t tile, int64_t cap, const void* z,
                 void* t, int64_t dtype, int64_t f, void* out,
                 int64_t num_rows, int64_t group, int64_t splits,
                 int64_t mode, int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const AggArgs a{static_cast<const int*>(src_local),
                  static_cast<const int*>(dst_local),
                  static_cast<const float*>(valid),
                  static_cast<const float*>(w), static_cast<int>(heads),
                  static_cast<int>(head_cols),
                  static_cast<const int*>(src_tile),
                  static_cast<const int*>(dst_tile),
                  static_cast<const int*>(order),
                  static_cast<const int*>(ptr), static_cast<int>(num_tiles),
                  static_cast<int>(tile), static_cast<int>(cap),
                  static_cast<const float*>(z), t, static_cast<int>(f),
                  static_cast<float*>(out), static_cast<int>(num_rows),
                  static_cast<int>(splits)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_slot_agg<float>(mode, group, a, s);
  if (dtype == 2) return launch_slot_agg<__nv_bfloat16>(mode, group, a, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
