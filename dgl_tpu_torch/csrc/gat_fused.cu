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
// One kernel is left here, behind a plain C function that launches on the
// caller's stream, allocates nothing and returns cudaGetLastError():
//
// gat_scores_kernel<kBias, kEdge>  replaces gat_fused.py gat_forward's
//     first pallas_call (:300, bodies _scores_kernel :59 and, with kBias,
//     _scores_bias_kernel :81) and, with kEdge, edgegat_v2_forward's
//     (:1723, body _eg2_scores_kernel :1558).  One thread per slot,
//     grid-stride: it gathers the (H,) rows el[src] and er[dst] and writes
//     p and g for every head, coalesced along c.  With kEdge the block
//     holds M in shared memory and a thread adds ef[s, :] . M[:, h], its
//     slot's Fe-wide row read once per head (L1 hits after the first).
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
// slot and head of p and g, K10 v2's 4 B a slot and edge feature; el and
// er are mostly L2 hits, since a bucket reads one src tile and one dst
// tile.  The f32 arithmetic is a few operations per slot and head, far
// below the rate, so the kernel is bound by bytes.  chip_smoke.py prints
// the bound at the main path's shapes.  Indices are int32: the wrappers
// check every flat size.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kClip = 40.f;     // gat_fused.py CLIP
constexpr int kScoresThreads = 256;

template <bool kBias, bool kEdge>
__global__ void __launch_bounds__(kScoresThreads)
gat_scores_kernel(const int* __restrict__ src_local,
                  const int* __restrict__ dst_local,
                  const float* __restrict__ valid,
                  const int* __restrict__ src_tile,
                  const int* __restrict__ dst_tile, int num_slots, int tile,
                  int cap, const float* __restrict__ el,
                  const float* __restrict__ er, const float* __restrict__ ee,
                  const float* __restrict__ ef, const float* __restrict__ m,
                  int fe, int heads, float slope, float* __restrict__ p,
                  float* __restrict__ g) {
  extern __shared__ float m_s[];  // kEdge: M, [fe][heads]
  if (kEdge) {
    for (int i = threadIdx.x; i < fe * heads; i += blockDim.x) m_s[i] = m[i];
    __syncthreads();
  }
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
    const float* efr = kEdge ? ef + s * fe : nullptr;  // the slot's features
    for (int h = 0; h < heads; ++h) {
      float raw = __ldg(elr + h) + __ldg(err + h);
      if (kBias) raw += ee[o + h * cap];
      if (kEdge) {
        float t = 0.f;
        for (int f = 0; f < fe; ++f) t += __ldg(efr + f) * m_s[f * heads + h];
        raw += t;
      }
      const bool pos = raw >= 0.f;
      const float lrelu = pos ? raw : slope * raw;
      const float pv = expf(fminf(fmaxf(lrelu, -kClip), kClip)) * v;
      p[o + h * cap] = pv;
      g[o + h * cap] = pv * (pos ? 1.f : slope);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kBias, bool kEdge>
cudaError_t launch_scores(const void* src_local, const void* dst_local,
                          const void* valid, const void* src_tile,
                          const void* dst_tile, int64_t num_slots,
                          int64_t tile, int64_t cap, const void* el,
                          const void* er, const void* ee, const void* ef,
                          const void* m, int64_t fe, int64_t heads,
                          double slope, void* p, void* g, int64_t blocks,
                          cudaStream_t stream) {
  const size_t smem = kEdge ? sizeof(float) * fe * heads : 0;
  if (kEdge) {
    const cudaError_t err = allow_smem(gat_scores_kernel<kBias, kEdge>, smem);
    if (err != cudaSuccess) return err;
  }
  gat_scores_kernel<kBias, kEdge><<<static_cast<unsigned>(blocks),
                                    kScoresThreads, smem, stream>>>(
      static_cast<const int*>(src_local), static_cast<const int*>(dst_local),
      static_cast<const float*>(valid), static_cast<const int*>(src_tile),
      static_cast<const int*>(dst_tile), static_cast<int>(num_slots),
      static_cast<int>(tile), static_cast<int>(cap),
      static_cast<const float*>(el), static_cast<const float*>(er),
      static_cast<const float*>(ee), static_cast<const float*>(ef),
      static_cast<const float*>(m), static_cast<int>(fe),
      static_cast<int>(heads), static_cast<float>(slope),
      static_cast<float*>(p), static_cast<float*>(g));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// p and g (num_slots / cap, heads, cap) from el (num_src, heads) and er
// (num_dst, heads); ee (the same shape as p) is added to raw when it is
// not null, or with ef (num_slots, fe) and m (fe, heads) not null, ef[s, :]
// . m[:, h] (M in shared memory: fe * heads floats).  Every element of p
// and g is written.  Grid: `blocks` blocks of 256 threads, grid-stride
// over slots.
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
#define DGL_SCORES_ARGS                                                      \
  src_local, dst_local, valid, src_tile, dst_tile, num_slots, tile, cap, el, \
      er, ee, ef, m, fe, heads, slope, p, g, blocks, s
  if (ef != nullptr) {
    if (ee != nullptr) return cudaErrorInvalidValue;
    return launch_scores<false, true>(DGL_SCORES_ARGS);
  }
  if (ee != nullptr) return launch_scores<true, false>(DGL_SCORES_ARGS);
  return launch_scores<false, false>(DGL_SCORES_ARGS);
#undef DGL_SCORES_ARGS
}

}  // extern "C"
