// Vector attention on Hopper (K9: GATv2, K11 v2: EGATConv) over the tiled
// format.
//
// Format (dgl_tpu_torch/ops/kernels/tiled_spmm.py):
// edges bucketed by (dst tile, src tile) pairs of `tile` nodes, `cap`
// slots per bucket; for flat slot s = b * cap + c, src_local[s] /
// dst_local[s] are ids within tiles src_tile[b] / dst_tile[b], and
// valid[s] is 1 for a real edge.  Padded slots alias row 0 of their tiles;
// every kernel here skips or zeroes a slot whose valid is 0.  dst tile t
// owns the buckets [dst_ptr[t], dst_ptr[t + 1]); src tile t owns the
// buckets src_order[src_ptr[t] .. src_ptr[t + 1]).  Slot tensors p and ds
// are (B, H, C) f32.
//
// The functions of dgl_tpu/ops/pallas/gat_fused.py:663-668 and :1946-1952:
// for every valid slot of an edge src -> dst, head h and column c = h * D
// + d of the H * D columns,
//   raw[c] = u[src, c] + v[dst, c] (+ fe[c]),  fe = ef[s, :] . wf[:fe, c]
//            (+ wf[fe, c], the bias row, when wf has fe + 1 rows)
//   p[h]   = exp(clip(sum_d attn[c] * lrelu(raw[c]), +-40))
//   dW[c]  = ds[h] * attn[c] * lrelu'(raw[c])
//   da[c]  = sum_slots ds[h] * lrelu(raw[c])
//   def[s, k] = sum_c wf[k, c] * dW[c],  dwf[k, c] = sum_slots ef[s, k] dW[c]
//   dv[dst] = sum dW,  du[src] = sum dW
// u, v: (num_src, H * D), (num_dst, H * D); attn (H * D); ef (B * C, fe)
// in slot order, 0 at padded slots; wf (fe_rows, H * D).  The softmax's
// den, numerator, ds and dx are K6's and K4's kernels (csrc/gat_fused.cu,
// csrc/row_agg.cu).
//
// Three kernels serve K11 v2's pallas_calls and K11 v1's (K9's scores,
// node gradient and da are the walks of csrc/row_agg.cu); each is behind
// a plain C function that launches on the caller's stream, allocates
// nothing and returns cudaGetLastError():
//
// vattn_scores_kernel<true>  replaces _egatc2_scores_kernel (:1955,
//     egatc2_forward :2075), K11 v2's scores.  K9's scores
//     (_gatv2_scores_kernel :670, gatv2_forward :783), which the
//     <false, float, false> instance computed, are the dot-product walk
//     by dst of csrc/row_agg.cu in its scores mode (row_sddmm_kernel<CPL,
//     true> and slot_finish_kernel<VEC, true>); dgl_vattn_scores refuses
//     that case, and dgl_tpu_torch/tools/perf_scores_rows.py builds it
//     again from an edit of this file to time the two side by side.  The
//     walk is K6's ds walk (csrc/gat_fused.cu
//     gat_ds_kernel): one warp per 32-slot chunk, L lanes per head (32 over
//     the heads rounded up to a power of two), each lane striding its
//     head's columns by L, 4 slots in flight, an xor-shuffle sum over the L
//     lanes.  A head's columns need not line up with a warp (D = 41) and a
//     lane's head changes inside a warp (D = 8): a lane only ever touches
//     its own head's columns.  With kEdge the block holds wf in shared
//     memory and each warp its chunk's 32 edge-feature rows, so fe is
//     computed per slot and column and never stored.
// vattn_slot_grad_kernel<kCols, kFe, kDef>, kFe > 0, replaces the da,
//     d(ef) and dWf parts of _egatc2_dv_da_kernel (:1975, egatc2_backward
//     :2167).  K9's da (the da part of _gatv2_dv_da_kernel :689,
//     _gatv2_bwd :878), which its kFe = 0 instances summed, is folded into
//     K9's node-gradient walk by dst (csrc/row_agg.cu row_agg_kernel<VEC,
//     CPL, true, true>); dgl_tpu_torch/tools/perf_ds_fold.py builds those
//     instances again to time the two side by side.  The same walk, but
//     each lane owns a fixed set of kCols columns of its head (a group; a
//     wide head takes several groups, each a walk of the block's chunks),
//     so da and dWf sum in registers; d(ef) of a slot (with kDef, when
//     autograd asks for it)
//     is a sum over all columns, taken by a reduce-scatter across the warp
//     (kFe - 1 + log2(32 / kFe) shuffles) that leaves row k's total in
//     lane k.  At the end the block adds its
//     lanes' sums in shared memory and then into da and dwf with global
//     atomics.
// vattn_node_grad_kernel<G, kSrc, kFe>  replaces, with kFe > 0, the dv
//     part of _egatc2_dv_da_kernel and, with kSrc, _egatc2_du_kernel
//     (:2024, egatc2_backward :2196): K11 v2's node gradient.  K6's
//     src-side aggregation walk (src_agg_kernel): one block per (dst or
//     src tile, chunk of G columns, split of the tile's buckets); the
//     tile's (tile, G) sums in shared memory, 128 KB at tile 1024 and G =
//     32, since a (1024, H * D) tile does not fit the 227 KB of an SM at
//     H * D = 64.  G lanes per slot recompute raw and dW for their column
//     and add dW at the slot's row with a float shared atomicAdd (a
//     compare-and-swap loop on this card); nothing (B, C, H * D)-sized is
//     stored.  K9's node gradient (the dv part of _gatv2_dv_da_kernel,
//     _gatv2_du_kernel :731) left it for the row walk (csrc/row_agg.cu
//     row_agg_kernel<VEC, CPL, true>); dgl_tpu_torch/tools/
//     perf_bwd_walks.py builds the kFe = 0 instances it ran on to time
//     the two side by side.
//
// EGATConv v1 (K11 v1, gat_fused.py:946-1261) stores its edge term FE per
// slot, (B * C, H * D) of type T (float or __nv_bfloat16), instead of
// forming it from ef and wf (kStore, read and written at 64-bit offsets:
// at 23M edges and H * D = 128 the tensor has 3.4e9 elements):
// vattn_scores_kernel<false, T, true>  replaces _egatc_scores_kernel
//     (:959, egatc_forward :1093): raw adds FE[s, c].
// vattn_slot_grad_kernel<kCols, 0, false, T, true>  replaces the da and
//     dFE parts of _egatc_dv_da_dfe_kernel (:979, _egatc_bwd :1193): it
//     also writes dW per slot and column as dFE, in T, every slot of every
//     bucket (0 at padded ones).  dFNJ and dFNI, the sums of dFE per dst
//     and src (the dv term of :979 and _dw_src_kernel :1020), are
//     csrc/gat_fused.cu's slot vector sums.
//
// The TPU kernels contract one-hot matrices on the matrix unit, embed attn
// in a head-block-diagonal matrix Ra and lane-pad each head; here a lane
// reads attn and its columns directly.  Sums are f32; the TPU kernels cast
// operands to bf16.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): each kernel streams
// the slot arrays (12 B a slot), 4 B a slot and head of p or ds, and with
// the edge term 4 B a slot and edge feature; the node rows it gathers are
// mostly L2 hits.  Operations: about 4 per slot and column (plus 2 per
// edge feature for fe, and 4 more for d(ef) and dWf), so the kernels
// without the edge term are bound by bytes and those with it come close to
// the f32 rate.  chip_smoke.py prints each bound at the main path's
// shapes.  Indices are int32: the wrappers check that every flat size
// fits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A stored slot tensor's element as f32, and back (csrc/gat_fused.cu has
// the same pair)
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

constexpr unsigned kFull = 0xffffffffu;
constexpr float kClip = 40.f;     // gat_fused.py CLIP
constexpr int kWarps = 8;         // warps per scores / slot-grad block
constexpr int kUnroll = 4;        // scores: slots in flight per warp
constexpr int kNodeWarps = 16;    // warps per node-grad block

__device__ __forceinline__ float lrelu(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

// The 32 edge-feature rows of the chunk starting at slot s0 into
// ef_s[32][fe_rows]; column fe holds the bias row's implicit 1 when
// fe_rows > fe.
__device__ __forceinline__ void load_ef_chunk(const float* __restrict__ ef,
                                              int s0, int fe, int fe_rows,
                                              float* ef_s, int lane) {
  const float* src = ef + static_cast<long long>(s0) * fe;
  for (int i = lane; i < 32 * fe_rows; i += 32) {
    const int j = i / fe_rows;
    const int k = i - j * fe_rows;
    ef_s[i] = k < fe ? __ldg(src + j * fe + k) : 1.f;
  }
  __syncwarp();
}

// v[F] of each lane summed over the warp, index by index: returns the
// total of index lane % F.  F - 1 shuffles halve the indices a lane keeps,
// then log2(32 / F) shuffles sum across the lanes that kept the same one.
template <int F>
__device__ __forceinline__ float reduce_scatter(float (&v)[F], int lane) {
#pragma unroll
  for (int s = F / 2; s >= 1; s >>= 1) {
    const bool up = (lane & s) != 0;
#pragma unroll
    for (int i = 0; i < s; ++i) {
      const float send = up ? v[i] : v[i + s];
      const float keep = up ? v[i + s] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, s);
    }
  }
  float r = v[0];
#pragma unroll
  for (int s = F; s < 32; s <<= 1) r += __shfl_xor_sync(kFull, r, s);
  return r;
}

template <bool kEdge, typename T = float, bool kStore = false>
__global__ void __launch_bounds__(kWarps * 32)
vattn_scores_kernel(const int* __restrict__ src_local,
                    const int* __restrict__ dst_local,
                    const float* __restrict__ valid,
                    const int* __restrict__ src_tile,
                    const int* __restrict__ dst_tile, int num_buckets,
                    int tile, int cap, const float* __restrict__ u,
                    const float* __restrict__ v,
                    const float* __restrict__ attn,
                    const float* __restrict__ ef,
                    const float* __restrict__ wf, int fe, int fe_rows,
                    int heads, int dim, int lanes, float slope,
                    const T* __restrict__ fe_s, float* __restrict__ p) {
  extern __shared__ float smem[];
  const int hd = heads * dim;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* attn_s = smem;                           // [hd]
  float* wf_s = attn_s + hd;                      // [fe_rows][hd]
  float* ef_s = wf_s + (kEdge ? fe_rows * hd : 0)
                + warp * 32 * fe_rows;            // this warp's [32][fe_rows]
  for (int i = threadIdx.x; i < hd; i += blockDim.x) attn_s[i] = attn[i];
  if (kEdge) {
    for (int i = threadIdx.x; i < fe_rows * hd; i += blockDim.x) {
      wf_s[i] = wf[i];
    }
  }
  __syncthreads();

  const int heads_per_pass = 32 / lanes;
  const int hl = lane / lanes;  // head of this lane within a pass
  const int fl = lane % lanes;  // first column of this lane in its head
  const int per_bucket = cap / 32;
  const int n_chunks = num_buckets * per_bucket;
  for (int k = blockIdx.x * kWarps + warp; k < n_chunks;
       k += gridDim.x * kWarps) {
    const int b = k / per_bucket;
    const int c0 = (k % per_bucket) * 32;  // the chunk's first slot in b
    const int s0 = b * cap + c0;
    const float vld = valid[s0 + lane];
    const int sl = src_local[s0 + lane];
    const int dl = dst_local[s0 + lane];
    const int ob = b * heads * cap + c0;  // p[b, h, c0 + j] = p[ob+h*cap+j]
    if (__ballot_sync(kFull, vld != 0.f) == 0u) {  // a padded tail: all 0
      for (int h = 0; h < heads; ++h) p[ob + h * cap + lane] = 0.f;
      continue;
    }
    if (kEdge) load_ef_chunk(ef, s0, fe, fe_rows, ef_s, lane);
    const float* ut = u + static_cast<long long>(src_tile[b]) * tile * hd;
    const float* vt = v + static_cast<long long>(dst_tile[b]) * tile * hd;
    for (int j0 = 0; j0 < 32; j0 += kUnroll) {
      const float* ur[kUnroll];
      const float* vr[kUnroll];
      bool live[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        live[q] = __shfl_sync(kFull, vld, j0 + q) != 0.f;  // warp-uniform
        ur[q] = ut + __shfl_sync(kFull, sl, j0 + q) * hd;
        vr[q] = vt + __shfl_sync(kFull, dl, j0 + q) * hd;
      }
      for (int h0 = 0; h0 < heads; h0 += heads_per_pass) {
        const int h = h0 + hl;
        const int c_end = h < heads ? (h + 1) * dim : 0;  // this head's end
        float s[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) s[q] = 0.f;
        for (int c = h * dim + fl; c < c_end; c += lanes) {
          const float a = attn_s[c];
#pragma unroll
          for (int q = 0; q < kUnroll; ++q) {
            if (!live[q]) continue;
            float raw = __ldg(ur[q] + c) + __ldg(vr[q] + c);
            if (kEdge) {
              const float* e = ef_s + (j0 + q) * fe_rows;
              for (int r = 0; r < fe_rows; ++r) raw += e[r] * wf_s[r * hd + c];
            }
            if (kStore) {
              raw += ld_slot(fe_s,
                             static_cast<long long>(s0 + j0 + q) * hd + c);
            }
            s[q] += a * lrelu(raw, slope);
          }
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          for (int o = lanes / 2; o > 0; o >>= 1) {
            s[q] += __shfl_xor_sync(kFull, s[q], o);
          }
          if (fl == 0 && h < heads) {
            p[ob + h * cap + j0 + q] =
                live[q] ? expf(fminf(fmaxf(s[q], -kClip), kClip)) : 0.f;
          }
        }
      }
    }
    if (kEdge) __syncwarp();  // ef_s is rewritten by the next chunk
  }
}

template <int kCols, int kFe, bool kDef, typename T = float,
          bool kStore = false>
__global__ void __launch_bounds__(kWarps * 32)
vattn_slot_grad_kernel(const int* __restrict__ src_local,
                       const int* __restrict__ dst_local,
                       const float* __restrict__ valid,
                       const int* __restrict__ src_tile,
                       const int* __restrict__ dst_tile, int num_buckets,
                       int tile, int cap, const float* __restrict__ u,
                       const float* __restrict__ v,
                       const float* __restrict__ attn,
                       const float* __restrict__ ds,
                       const float* __restrict__ ef,
                       const float* __restrict__ wf, int fe, int fe_rows,
                       int heads, int dim, int lanes, float slope,
                       float* __restrict__ da, float* __restrict__ def,
                       float* __restrict__ dwf, const T* __restrict__ fe_s,
                       T* __restrict__ dfe_s) {
  constexpr bool kEdge = kFe > 0;
  constexpr int kF = kEdge ? kFe : 1;
  constexpr int kP = kDef ? kFe : 1;  // d(ef) partial sums of a slot
  extern __shared__ float smem[];
  const int hd = heads * dim;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = kEdge ? fe_rows : 0;
  float* attn_s = smem;                 // [hd]
  float* da_s = attn_s + hd;            // [hd]: the block's sums
  float* wf_s = da_s + hd;              // [fe_rows][hd]
  float* dwf_s = wf_s + rows * hd;      // [fe_rows][hd]: the block's sums
  float* ef_s = dwf_s + rows * hd + warp * 32 * rows;  // [32][fe_rows]
  for (int i = threadIdx.x; i < hd; i += blockDim.x) {
    attn_s[i] = attn[i];
    da_s[i] = 0.f;
  }
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    wf_s[i] = wf[i];
    dwf_s[i] = 0.f;
  }
  __syncthreads();

  const int heads_per_pass = 32 / lanes;
  const int hl = lane / lanes;
  const int fl = lane % lanes;
  const int span = lanes * kCols;  // columns of a head one group covers
  const int per_bucket = cap / 32;
  const int n_chunks = num_buckets * per_bucket;
  bool first = true;  // the first group writes d(ef), later ones add to it
  for (int h0 = 0; h0 < heads; h0 += heads_per_pass) {
    const int h = h0 + hl;
    for (int g0 = 0; g0 < dim; g0 += span) {
      int col[kCols];
      bool ok[kCols];
      float acc_a[kCols];
      float acc_w[kF][kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int d = g0 + fl + i * lanes;
        ok[i] = h < heads && d < dim;
        col[i] = ok[i] ? h * dim + d : 0;
        acc_a[i] = 0.f;
#pragma unroll
        for (int r = 0; r < kF; ++r) acc_w[r][i] = 0.f;
      }
      for (int k = blockIdx.x * kWarps + warp; k < n_chunks;
           k += gridDim.x * kWarps) {
        const int b = k / per_bucket;
        const int c0 = (k % per_bucket) * 32;
        const int s0 = b * cap + c0;
        const float vld = valid[s0 + lane];
        if (__ballot_sync(kFull, vld != 0.f) == 0u) {  // a padded tail
          if (kDef && first) {
            for (int i = lane; i < 32 * fe; i += 32) {
              def[static_cast<long long>(s0) * fe + i] = 0.f;
            }
          }
          if (kStore) {
            for (int j = 0; j < 32; ++j) {
#pragma unroll
              for (int i = 0; i < kCols; ++i) {
                if (ok[i]) {
                  st_slot(dfe_s, static_cast<long long>(s0 + j) * hd + col[i],
                          0.f);
                }
              }
            }
          }
          continue;
        }
        const int sl = src_local[s0 + lane];
        const int dl = dst_local[s0 + lane];
        const float* dsb = ds + b * heads * cap + c0;
        if (kEdge) load_ef_chunk(ef, s0, fe, fe_rows, ef_s, lane);
        const float* ut = u + static_cast<long long>(src_tile[b]) * tile * hd;
        const float* vt = v + static_cast<long long>(dst_tile[b]) * tile * hd;
        for (int j = 0; j < 32; ++j) {
          const bool live = __shfl_sync(kFull, vld, j) != 0.f;  // uniform
          const float* ur = ut + __shfl_sync(kFull, sl, j) * hd;
          const float* vr = vt + __shfl_sync(kFull, dl, j) * hd;
          float part[kP];
#pragma unroll
          for (int r = 0; r < kP; ++r) part[r] = 0.f;
          if (live) {
            const float dsh = h < heads ? __ldg(dsb + h * cap + j) : 0.f;
            const float* e = ef_s + j * rows;
#pragma unroll
            for (int i = 0; i < kCols; ++i) {
              if (!ok[i]) continue;
              const int c = col[i];
              const long long fo = static_cast<long long>(s0 + j) * hd + c;
              float raw = __ldg(ur + c) + __ldg(vr + c);
              if (kEdge) {
#pragma unroll
                for (int r = 0; r < kF; ++r) {
                  if (r < fe_rows) raw += e[r] * wf_s[r * hd + c];
                }
              }
              if (kStore) raw += ld_slot(fe_s, fo);
              const bool pos = raw >= 0.f;
              acc_a[i] += dsh * (pos ? raw : slope * raw);
              if (kStore) {
                st_slot(dfe_s, fo, dsh * attn_s[c] * (pos ? 1.f : slope));
              }
              if (kEdge) {
                const float dw = dsh * attn_s[c] * (pos ? 1.f : slope);
#pragma unroll
                for (int r = 0; r < kF; ++r) {
                  if (r < fe_rows) {
                    acc_w[r][i] += e[r] * dw;
                    if (kDef) part[kDef ? r : 0] += wf_s[r * hd + c] * dw;
                  }
                }
              }
            }
          }
          if (kStore && !live) {
#pragma unroll
            for (int i = 0; i < kCols; ++i) {
              if (ok[i]) {
                st_slot(dfe_s, static_cast<long long>(s0 + j) * hd + col[i],
                        0.f);
              }
            }
          }
          if (kDef) {
            const float tot = reduce_scatter<kP>(part, lane);
            if (lane < fe) {
              float* d = def + static_cast<long long>(s0 + j) * fe + lane;
              *d = first ? tot : *d + tot;
            }
          }
        }
        if (kEdge) __syncwarp();  // ef_s is rewritten by the next chunk
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        if (!ok[i]) continue;
        atomicAdd(da_s + col[i], acc_a[i]);
#pragma unroll
        for (int r = 0; r < kF; ++r) {
          if (kEdge && r < fe_rows) {
            atomicAdd(dwf_s + r * hd + col[i], acc_w[r][i]);
          }
        }
      }
      first = false;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < hd; i += blockDim.x) {
    if (da_s[i] != 0.f) atomicAdd(da + i, da_s[i]);
  }
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    if (dwf_s[i] != 0.f) atomicAdd(dwf + i, dwf_s[i]);
  }
}

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

template <int kCols, int kFe, bool kDef, typename T = float,
          bool kStore = false>
cudaError_t launch_slot_grad(Slots sl, int num_buckets, int tile, int cap,
                             Operands op, const float* ds, int lanes,
                             float* da, float* def, float* dwf,
                             const void* fe_s, void* dfe_s, int blocks,
                             cudaStream_t stream) {
  const int hd = op.heads * op.dim;
  const int rows = kFe > 0 ? op.fe_rows : 0;
  const size_t smem =
      sizeof(float) * (2 * hd + 2 * rows * hd + kWarps * 32 * rows);
  const cudaError_t err =
      allow_smem(vattn_slot_grad_kernel<kCols, kFe, kDef, T, kStore>, smem);
  if (err != cudaSuccess) return err;
  vattn_slot_grad_kernel<kCols, kFe, kDef, T, kStore><<<blocks, kWarps * 32,
                                                        smem, stream>>>(
      sl.src_local, sl.dst_local, sl.valid, sl.src_tile, sl.dst_tile,
      num_buckets, tile, cap, op.u, op.v, op.attn, ds, op.ef, op.wf, op.fe,
      op.fe_rows, op.heads, op.dim, lanes, op.slope, da, def, dwf,
      static_cast<const T*>(fe_s), static_cast<T*>(dfe_s));
  return cudaGetLastError();
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

// p (num_buckets, heads, cap), every element written, from u (num_src,
// heads * dim), v (num_dst, heads * dim) and attn (heads * dim); with ef
// not null, the edge term from ef (num_buckets * cap, fe) and wf (fe_rows,
// heads * dim); with fe_s not null (and ef null), the stored term fe_s
// (num_buckets * cap, heads * dim), f32 (store 1) or bf16 (store 2).
// One of the two terms is needed: without either (K9's scores) the call
// returns cudaErrorInvalidValue (csrc/row_agg.cu dgl_row_vattn serves it).
// lanes: 32 over the heads rounded up to a power of two, at least 1.
// Grid: `blocks` blocks of 8 warps, grid-stride over 32-slot chunks.
int dgl_vattn_scores(const void* src_local, const void* dst_local,
                     const void* valid, const void* src_tile,
                     const void* dst_tile, int64_t num_buckets, int64_t tile,
                     int64_t cap, const void* u, const void* v,
                     const void* attn, const void* ef, const void* wf,
                     int64_t fe, int64_t fe_rows, int64_t heads, int64_t dim,
                     int64_t lanes, double slope, const void* fe_s,
                     int64_t store, void* p, int64_t blocks, int64_t device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Slots sl = slots(src_local, dst_local, valid, src_tile, dst_tile);
  const int hd = static_cast<int>(heads * dim);
  const bool edge = ef != nullptr;
  if (fe_s != nullptr && (edge || (store != 1 && store != 2))) {
    return cudaErrorInvalidValue;
  }
  const int rows = edge ? static_cast<int>(fe_rows) : 0;
  const size_t smem = sizeof(float) * (hd + rows * hd + kWarps * 32 * rows);
#define DGL_SCORES_LAUNCH(EDGE_, T_, STORE_)                                 \
  err = allow_smem(vattn_scores_kernel<EDGE_, T_, STORE_>, smem);            \
  if (err != cudaSuccess) return err;                                        \
  vattn_scores_kernel<EDGE_, T_, STORE_><<<static_cast<unsigned>(blocks),    \
                                           kWarps * 32, smem, s>>>(          \
      sl.src_local, sl.dst_local, sl.valid, sl.src_tile, sl.dst_tile,        \
      static_cast<int>(num_buckets), static_cast<int>(tile),                 \
      static_cast<int>(cap), static_cast<const float*>(u),                   \
      static_cast<const float*>(v), static_cast<const float*>(attn),         \
      static_cast<const float*>(ef), static_cast<const float*>(wf),          \
      static_cast<int>(fe), rows, static_cast<int>(heads),                   \
      static_cast<int>(dim), static_cast<int>(lanes),                        \
      static_cast<float>(slope), static_cast<const T_*>(fe_s),               \
      static_cast<float*>(p));
  if (edge) {
    DGL_SCORES_LAUNCH(true, float, false)
  } else if (fe_s == nullptr) {
    return cudaErrorInvalidValue;  // K9's scores: csrc/row_agg.cu's walk
  } else if (store == 1) {
    DGL_SCORES_LAUNCH(false, float, true)
  } else {
    DGL_SCORES_LAUNCH(false, __nv_bfloat16, true)
  }
#undef DGL_SCORES_LAUNCH
  return cudaGetLastError();
}

// da (heads * dim) += the block sums of ds[h] * lrelu(raw); with ef not
// null also dwf (fe_rows, heads * dim) += sum ef[s, k] dW and, with def
// not null, def (num_buckets * cap, fe) = sum_c wf[k, c] dW, every element
// written.  da and dwf must be zeroed by the caller.  cols (1, 2 or 4;
// at most 2 with fe_cap 32 and def): the columns of its head a lane keeps
// at once; fe_cap (8, 16 or 32 >= fe_rows) with the edge term, which the
// call needs unless it takes a stored term (K9's da, with neither, is
// csrc/row_agg.cu's).  With fe_s and dfe_s not null (and ef and def
// null), the stored term
// fe_s (num_buckets * cap, heads * dim) is read and dW written to dfe_s at
// every slot (0 at padded ones), both f32 (store 1) or bf16 (store 2).
// Grid: `blocks` blocks of 8 warps.
int dgl_vattn_slot_grad(const void* src_local, const void* dst_local,
                        const void* valid, const void* src_tile,
                        const void* dst_tile, int64_t num_buckets,
                        int64_t tile, int64_t cap, const void* u,
                        const void* v, const void* attn, const void* ds,
                        const void* ef, const void* wf, int64_t fe,
                        int64_t fe_rows, int64_t heads, int64_t dim,
                        int64_t lanes, int64_t cols, int64_t fe_cap,
                        double slope, void* da, void* def, void* dwf,
                        const void* fe_s, void* dfe_s, int64_t store,
                        int64_t blocks, int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Slots sl = slots(src_local, dst_local, valid, src_tile, dst_tile);
  const Operands op = operands(u, v, attn, ef, wf, fe, fe_rows, heads, dim,
                               slope);
  const bool with_def = def != nullptr;
#define DGL_GRAD_ARGS                                                        \
  sl, static_cast<int>(num_buckets), static_cast<int>(tile),                 \
      static_cast<int>(cap), op, static_cast<const float*>(ds),              \
      static_cast<int>(lanes), static_cast<float*>(da),                      \
      static_cast<float*>(def), static_cast<float*>(dwf), fe_s, dfe_s,       \
      static_cast<int>(blocks), s
  if (fe_s != nullptr || dfe_s != nullptr) {
    if (fe_s == nullptr || dfe_s == nullptr || ef != nullptr || with_def) {
      return cudaErrorInvalidValue;
    }
#define DGL_STORE_CASE(COLS_, T_, STORE_)                                    \
    if (cols == COLS_ && store == STORE_) {                                  \
      return launch_slot_grad<COLS_, 0, false, T_, true>(DGL_GRAD_ARGS);     \
    }
    DGL_STORE_CASE(1, float, 1)
    DGL_STORE_CASE(2, float, 1)
    DGL_STORE_CASE(4, float, 1)
    DGL_STORE_CASE(1, __nv_bfloat16, 2)
    DGL_STORE_CASE(2, __nv_bfloat16, 2)
    DGL_STORE_CASE(4, __nv_bfloat16, 2)
#undef DGL_STORE_CASE
    return cudaErrorInvalidValue;
  }
#define DGL_GRAD_CASE(COLS_, FE_, DEF_)                                      \
  if (cols == COLS_ && fe_cap == FE_ && with_def == DEF_) {                  \
    return launch_slot_grad<COLS_, FE_, DEF_>(DGL_GRAD_ARGS);                \
  }
  DGL_GRAD_CASE(1, 8, false)
  DGL_GRAD_CASE(2, 8, false)
  DGL_GRAD_CASE(4, 8, false)
  DGL_GRAD_CASE(1, 16, false)
  DGL_GRAD_CASE(2, 16, false)
  DGL_GRAD_CASE(4, 16, false)
  DGL_GRAD_CASE(1, 32, false)
  DGL_GRAD_CASE(2, 32, false)
  DGL_GRAD_CASE(4, 32, false)
  DGL_GRAD_CASE(1, 8, true)
  DGL_GRAD_CASE(2, 8, true)
  DGL_GRAD_CASE(4, 8, true)
  DGL_GRAD_CASE(1, 16, true)
  DGL_GRAD_CASE(2, 16, true)
  DGL_GRAD_CASE(4, 16, true)
  DGL_GRAD_CASE(1, 32, true)
  DGL_GRAD_CASE(2, 32, true)
#undef DGL_GRAD_CASE
#undef DGL_GRAD_ARGS
  return cudaErrorInvalidValue;
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

}  // extern "C"
