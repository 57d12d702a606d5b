// Slot-space GAT and EdgeGAT scores on Hopper (K6, K10 v2) over the
// tiled format.
//
// Format (dgl_tpu_torch/ops/kernels/tiled_spmm.py):
// edges bucketed by (dst tile, src tile) pairs of `tile` nodes, `cap`
// slots per bucket; for flat slot s = b * cap + c, src_local[s] /
// dst_local[s] are ids within tiles src_tile[b] / dst_tile[b], and
// valid[s] is 1 for a real edge.  Padded slots alias row 0 of their tiles;
// the kernel here zeroes a slot whose valid is 0.  Slot tensors are
// (B, H, C) f32: slot (b, c) of head h is element (b * H + h) * cap + c.
//
// The functions of dgl_tpu/ops/pallas/gat_fused.py (gat_fused.py:10-21):
//   raw = el[src, h] + er[dst, h] (+ ee[b, h, c]),
//   p = exp(clip(lrelu(raw), +-40)) * valid,  g = p * (raw >= 0 ? 1 : slope)
//   den[d, h] = sum p,  out = (sum p x[src]) / max(den, 1e-20)
//   ds = (<x[src, h, :], zn[dst, h, :]> - rp[dst, h]) * g
//   der = sum_dst ds,  del = sum_src ds,  dx[src] = sum p zn[dst]
// There is no max subtraction: the clip at +-40 is the numerics contract.
// DotGat (K8) takes p = exp(clip(<k[src], q[dst]> / sqrt(D), +-40)) from
// K4's SDDMM and uses g = p.
//
// EdgeGAT v2 (K10 v2, gat_fused.py:1536-1901) adds an edge message fe =
// ef[s, :] . We_h to every slot, inside its logit (ee = <attn_e[h], fe>)
// and its message (out = sum p (x[src] + fe) / den).  The port never forms
// fe: with M = We contracted with attn_e per head, an (Fe, H) matrix, ee =
// ef[s, :] . M[:, h].
//
// Two kernels are left here, behind one plain C function that launches on
// the caller's stream, allocates nothing and returns cudaGetLastError():
//
// gat_scores_kernel<kBias>  replaces gat_fused.py gat_forward's first
//     pallas_call (:300, bodies _scores_kernel :59 and, with kBias,
//     _scores_bias_kernel :81).  One thread per slot, grid-stride: it
//     gathers the (H,) rows el[src] and er[dst] and writes p and g for
//     every head, coalesced along c.
// edge_scores_kernel<KF>  replaces edgegat_v2_forward's (:1723, body
//     _eg2_scores_kernel :1558, helper _fe_in_kernel :1550): the same
//     scores with ee = ef[s, :] . M[:, h] added to raw.  A thread a slot,
//     grid-stride, with the block's M in shared memory (one address across
//     a warp); a lane loads its own slot's Fe-wide row once, 16 bytes at a
//     time into registers where Fe is a template width (KF: 4, 8, 16 or
//     32, ef 16-byte aligned), else 4 bytes at a time in a runtime loop,
//     and reads its valid an iteration ahead.  t = sum_f ef[f] M[f, h] is
//     summed from f = 0 upward with FMAs and added to el + er, as the
//     kernel it replaced summed it, so p and g keep its bits.  Padded
//     slots are not read.  It replaced gat_scores_kernel<false, true>, a
//     thread a slot that read its slot's Fe features with scalar loads
//     once per head, now in dgl_tpu_torch/tools/slot_grad_scores_probe.cu
//     beside the design that lost to this one on the card (a warp's 32
//     rows staged in shared memory by cp.async), both built and timed
//     beside it by dgl_tpu_torch/tools/perf_slot_grad_scores.py.
//
// The rest of K6's, K8's and K10's kernels are the row walks of
// csrc/row_agg.cu: K6's slot reduce (_den_kernel :103, _der_kernel :167,
// _del_kernel :183) is its row reduce, K6's ds (_ds_kernel :146) and
// K10's edge ds (v2: _eg2_ds_kernel :1605 and the d(ef) part of
// _eg2_dx_def_kernel :1639; v1: _ds_fe_kernel :1299) its dot-product walk
// by dst with the edge terms and the finishing pass, K6's dx (_dx_kernel
// :202) its row walk by src, and K10 v2's slot-feature reduce, K10 v1's
// numerator and dx with dfe (_agg_fe_kernel :1276, _dx_dfe_kernel :1320)
// and K11 v1's node sums (_egatc_dv_da_dfe_kernel :979, _dw_src_kernel
// :1020) its slot walk (row_slot_kernel).  _agg_kernel :120 (gat_forward
// :328, dot_gat_forward :547, and dq in _dot_gat_bwd :614) and the node
// part of _eg2_agg_kernel compute exactly tiled_spmm_multihead's function,
// so the port serves them with K4's SpMM (the same file), and K8's scores
// with K4's SDDMM.  The bucket walks these replaced (slot_reduce_kernel,
// src_agg_kernel, gat_ds_kernel) live in dgl_tpu_torch/tools/, built by
// the probes that time them beside their replacements.
//
// The TPU kernels contract one-hot matrices of each bucket on the matrix
// unit; here the work per slot is a gather and a few operations.  Sums are
// f32; the TPU kernels cast their operands to bf16.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the scores stream the
// slot arrays (12 B a slot for src_local, dst_local and valid) and 4 B a
// slot and head of p and g, K10 v2's 4 B an edge and feature (a padded
// slot's row is not read); el and er are mostly L2 hits, since a bucket
// reads one src tile and one dst tile.  The f32 arithmetic is a few
// operations per slot and head, far below the rate, so the kernel is bound
// by bytes.  chip_smoke.py prints the bound at the main path's shapes.
// Indices are int32: the wrappers check every flat size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kClip = 40.f;     // gat_fused.py CLIP
constexpr int kScoresThreads = 256;

template <bool kBias>
__global__ void __launch_bounds__(kScoresThreads)
gat_scores_kernel(const int* __restrict__ src_local,
                  const int* __restrict__ dst_local,
                  const float* __restrict__ valid,
                  const int* __restrict__ src_tile,
                  const int* __restrict__ dst_tile, int num_slots, int tile,
                  int cap, const float* __restrict__ el,
                  const float* __restrict__ er, const float* __restrict__ ee,
                  int heads, float slope, float* __restrict__ p,
                  float* __restrict__ g) {
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < num_slots;
       s += gridDim.x * blockDim.x) {
    const int b = s / cap;
    const int o = b * heads * cap + (s - b * cap);  // (b, 0, c) of (B, H, C)
    const float v = valid[s];
    if (v == 0.f) {
      for (int h = 0; h < heads; ++h) {
        p[o + h * cap] = 0.f;
        g[o + h * cap] = 0.f;
      }
      continue;
    }
    const float* elr = el + (src_tile[b] * tile + src_local[s]) * heads;
    const float* err = er + (dst_tile[b] * tile + dst_local[s]) * heads;
    for (int h = 0; h < heads; ++h) {
      float raw = __ldg(elr + h) + __ldg(err + h);
      if (kBias) raw += ee[o + h * cap];
      const bool pos = raw >= 0.f;
      const float lrelu = pos ? raw : slope * raw;
      const float pv = expf(fminf(fmaxf(lrelu, -kClip), kClip)) * v;
      p[o + h * cap] = pv;
      g[o + h * cap] = pv * (pos ? 1.f : slope);
    }
  }
}

// K10 v2's scores: a thread a slot (grid-stride), valid read an iteration
// ahead; at a live slot raw = (el[src, h] + er[dst, h]) + sum_f ef[s, f]
// M[f, h], p and g as gat_scores_kernel writes them.  KF: Fe, where it is
// a template width (the lane's row in registers, 16-byte loads: ef
// 16-byte aligned), or 0 (a runtime loop over fe).
template <int KF>
__global__ void __launch_bounds__(kScoresThreads)
edge_scores_kernel(const int* __restrict__ src_local,
                   const int* __restrict__ dst_local,
                   const float* __restrict__ valid,
                   const int* __restrict__ src_tile,
                   const int* __restrict__ dst_tile, int num_slots, int tile,
                   int cap, const float* __restrict__ el,
                   const float* __restrict__ er,
                   const float* __restrict__ ef, const float* __restrict__ m,
                   int fe, int heads, float slope, float* __restrict__ p,
                   float* __restrict__ g) {
  extern __shared__ float m_s[];  // M, [fe][heads]
  for (int i = threadIdx.x; i < fe * heads; i += blockDim.x) m_s[i] = m[i];
  __syncthreads();
  const int stride = gridDim.x * blockDim.x;
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  float v = s < num_slots ? valid[s] : 0.f;
  for (; s < num_slots; s += stride) {
    const float vn = s + stride < num_slots ? valid[s + stride] : 0.f;
    const int b = s / cap;
    const int o = b * heads * cap + (s - b * cap);  // (b, 0, c) of (B, H, C)
    if (v == 0.f) {
      for (int h = 0; h < heads; ++h) {
        p[o + h * cap] = 0.f;
        g[o + h * cap] = 0.f;
      }
    } else {
      const float* elr = el + (src_tile[b] * tile + src_local[s]) * heads;
      const float* err = er + (dst_tile[b] * tile + dst_local[s]) * heads;
      const float* own = ef + static_cast<long long>(s) * fe;  // its row
      float x[KF > 0 ? KF : 1];
      if constexpr (KF > 0) {
#pragma unroll
        for (int q = 0; q < KF / 4; ++q) {
          const float4 t4 = __ldg(reinterpret_cast<const float4*>(own) + q);
          x[4 * q] = t4.x;
          x[4 * q + 1] = t4.y;
          x[4 * q + 2] = t4.z;
          x[4 * q + 3] = t4.w;
        }
      }
      for (int h = 0; h < heads; ++h) {
        float raw = __ldg(elr + h) + __ldg(err + h);
        float t = 0.f;
        if constexpr (KF > 0) {
#pragma unroll
          for (int f = 0; f < KF; ++f) t = fmaf(x[f], m_s[f * heads + h], t);
        } else {
          for (int f = 0; f < fe; ++f) {
            t = fmaf(__ldg(own + f), m_s[f * heads + h], t);
          }
        }
        raw += t;
        const bool pos = raw >= 0.f;
        const float lrelu = pos ? raw : slope * raw;
        const float pv = expf(fminf(fmaxf(lrelu, -kClip), kClip)) * v;
        p[o + h * cap] = pv;
        g[o + h * cap] = pv * (pos ? 1.f : slope);
      }
    }
    v = vn;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// the template width of edge_scores_kernel for fe features in ef: fe
// where it is 4, 8, 16 or 32 and ef is 16-byte aligned, else 0
int edge_kf(int64_t fe, const void* ef) {
  const bool vec = reinterpret_cast<uintptr_t>(ef) % 16 == 0;
  return vec && (fe == 4 || fe == 8 || fe == 16 || fe == 32)
             ? static_cast<int>(fe)
             : 0;
}

template <int KF>
cudaError_t launch_edge(const void* src_local, const void* dst_local,
                        const void* valid, const void* src_tile,
                        const void* dst_tile, int64_t num_slots, int64_t tile,
                        int64_t cap, const void* el, const void* er,
                        const void* ef, const void* m, int64_t fe,
                        int64_t heads, double slope, void* p, void* g,
                        int64_t blocks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * fe * heads;
  const cudaError_t err = allow_smem(edge_scores_kernel<KF>, smem);
  if (err != cudaSuccess) return err;
  edge_scores_kernel<KF><<<static_cast<unsigned>(blocks), kScoresThreads,
                           smem, stream>>>(
      static_cast<const int*>(src_local), static_cast<const int*>(dst_local),
      static_cast<const float*>(valid), static_cast<const int*>(src_tile),
      static_cast<const int*>(dst_tile), static_cast<int>(num_slots),
      static_cast<int>(tile), static_cast<int>(cap),
      static_cast<const float*>(el), static_cast<const float*>(er),
      static_cast<const float*>(ef), static_cast<const float*>(m),
      static_cast<int>(fe), static_cast<int>(heads),
      static_cast<float>(slope), static_cast<float*>(p),
      static_cast<float*>(g));
  return cudaGetLastError();
}

template <bool kBias>
cudaError_t launch_scores(const void* src_local, const void* dst_local,
                          const void* valid, const void* src_tile,
                          const void* dst_tile, int64_t num_slots,
                          int64_t tile, int64_t cap, const void* el,
                          const void* er, const void* ee, int64_t heads,
                          double slope, void* p, void* g, int64_t blocks,
                          cudaStream_t stream) {
  gat_scores_kernel<kBias><<<static_cast<unsigned>(blocks), kScoresThreads,
                             0, stream>>>(
      static_cast<const int*>(src_local), static_cast<const int*>(dst_local),
      static_cast<const float*>(valid), static_cast<const int*>(src_tile),
      static_cast<const int*>(dst_tile), static_cast<int>(num_slots),
      static_cast<int>(tile), static_cast<int>(cap),
      static_cast<const float*>(el), static_cast<const float*>(er),
      static_cast<const float*>(ee), static_cast<int>(heads),
      static_cast<float>(slope), static_cast<float*>(p),
      static_cast<float*>(g));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// p and g (num_slots / cap, heads, cap) from el (num_src, heads) and er
// (num_dst, heads); ee (the same shape as p) is added to raw when it is
// not null, or with ef (num_slots, fe) and m (fe, heads) not null, ef[s, :]
// . m[:, h] (edge_scores_kernel, M in shared memory: fe * heads floats).
// Every element of p and g is written.  Grid: `blocks` blocks of 256
// threads, grid-stride over slots.
int dgl_gat_scores(const void* src_local, const void* dst_local,
                   const void* valid, const void* src_tile,
                   const void* dst_tile, int64_t num_slots, int64_t tile,
                   int64_t cap, const void* el, const void* er,
                   const void* ee, const void* ef, const void* m, int64_t fe,
                   int64_t heads, double slope, void* p, void* g,
                   int64_t blocks, int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ef != nullptr) {
    if (ee != nullptr || m == nullptr || fe < 0) return cudaErrorInvalidValue;
#define DGL_EDGE_ARGS                                                      \
  src_local, dst_local, valid, src_tile, dst_tile, num_slots, tile, cap,   \
      el, er, ef, m, fe, heads, slope, p, g, blocks, s
    switch (edge_kf(fe, ef)) {
      case 4: return launch_edge<4>(DGL_EDGE_ARGS);
      case 8: return launch_edge<8>(DGL_EDGE_ARGS);
      case 16: return launch_edge<16>(DGL_EDGE_ARGS);
      case 32: return launch_edge<32>(DGL_EDGE_ARGS);
      default: return launch_edge<0>(DGL_EDGE_ARGS);
    }
#undef DGL_EDGE_ARGS
  }
#define DGL_SCORES_ARGS                                                      \
  src_local, dst_local, valid, src_tile, dst_tile, num_slots, tile, cap, el, \
      er, ee, heads, slope, p, g, blocks, s
  if (ee != nullptr) return launch_scores<true>(DGL_SCORES_ARGS);
  return launch_scores<false>(DGL_SCORES_ARGS);
#undef DGL_SCORES_ARGS
}

// attrs (three host ints): the registers a thread, the local memory bytes
// a thread and the resident blocks an SM of the edge scores' instance for
// fe features in a 16-byte aligned ef, with its shared memory for `heads`
// heads
int dgl_edge_scores_attrs(int64_t fe, int64_t heads, int64_t device,
                          void* attrs) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const int kf = edge_kf(fe, nullptr);
  const void* kernel =
      kf == 4    ? reinterpret_cast<const void*>(edge_scores_kernel<4>)
      : kf == 8  ? reinterpret_cast<const void*>(edge_scores_kernel<8>)
      : kf == 16 ? reinterpret_cast<const void*>(edge_scores_kernel<16>)
      : kf == 32 ? reinterpret_cast<const void*>(edge_scores_kernel<32>)
                 : reinterpret_cast<const void*>(edge_scores_kernel<0>);
  const size_t smem = sizeof(float) * fe * heads;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int* o = static_cast<int*>(attrs);
  o[0] = attr.numRegs;
  o[1] = static_cast<int>(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(o + 2, kernel,
                                                       kScoresThreads, smem);
}

}  // extern "C"
