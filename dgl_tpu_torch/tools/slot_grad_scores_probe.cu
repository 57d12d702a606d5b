// The two kernels that K11 v1's slot gradient and K10 v2's scores left,
// and the design of K10 v2's scores that lost to the package's on the
// card, kept to be timed beside their replacements (not part of the
// package; built by dgl_tpu_torch/tools/perf_slot_grad_scores.py with the
// package's nvcc flags):
//
// vattn_slot_grad_kernel<kCols, T, kStore>  (csrc/gatv2.cu until the slot
//     walk by dst took K11 v1's slot gradient): one warp per 32-slot chunk
//     of the buckets, L lanes per head (32 over the heads rounded up to a
//     power of two); each lane owns a fixed set of kCols columns of its
//     head, walks the chunk's slots one at a time, gathering U[src],
//     V[dst] and (kStore) the stored FE with scalar loads, and sums da in
//     registers; at the end the block adds its lanes' sums in shared
//     memory and then into da with global atomics.  kStore writes dW per
//     slot and column as dFE in T (float or __nv_bfloat16), every slot of
//     every bucket, 0 at padded ones; dFNJ was then slot_vec_reduce's
//     walk by dst.  Its instances without a stored term (K9's da, now
//     folded into csrc/row_agg.cu's node-gradient walk) are instantiated
//     again by the edit TILED_DA of dgl_tpu_torch/tools/perf_ds_fold.py.
//     C function: dgl_vattn_slot_grad.
// gat_scores_kernel<kBias, kEdge>  (csrc/gat_fused.cu until
//     edge_scores_kernel took K10 v2's scores): one thread per slot,
//     grid-stride; it gathers the (H,) rows el[src] and er[dst] and writes
//     p and g for every head, coalesced along c; with kEdge the block
//     holds M in shared memory and a thread adds ef[s, :] . M[:, h], its
//     slot's Fe-wide row read once per head with scalar loads (L1 hits
//     after the first).  Its K6 and K10 v1 instances (<false, false>,
//     <true, false>) are the package's gat_scores_kernel<kBias> as it was.
//     C function: dgl_gat_scores_thread.
// edge_scores_staged_kernel<KF>  (K10 v2's scores as first redesigned: a
//     warp's 32 slots' ef rows staged in shared memory by cp.async; the
//     package's edge_scores_kernel, each lane loading its own row, took
//     its place).  C functions: dgl_edge_scores_staged,
//     dgl_edge_scores_staged_attrs.

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
constexpr int kWarps = 8;         // warps per slot-grad block
constexpr int kScoresThreads = 256;
constexpr int kEdgeWarps = 8;     // warps a block of the staged scores, at most

__device__ __forceinline__ float lrelu(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

// At most 64 registers a thread, 4 blocks an SM: cut to these branches,
// the f32 instance at 4 columns took 69 registers and 3 blocks an SM.
template <int kCols, typename T, bool kStore>
__global__ void __launch_bounds__(kWarps * 32, 4)
vattn_slot_grad_kernel(const int* __restrict__ src_local,
                       const int* __restrict__ dst_local,
                       const float* __restrict__ valid,
                       const int* __restrict__ src_tile,
                       const int* __restrict__ dst_tile, int num_buckets,
                       int tile, int cap, const float* __restrict__ u,
                       const float* __restrict__ v,
                       const float* __restrict__ attn,
                       const float* __restrict__ ds, int heads, int dim,
                       int lanes, float slope, float* __restrict__ da,
                       const T* __restrict__ fe_s, T* __restrict__ dfe_s) {
  extern __shared__ float smem[];
  const int hd = heads * dim;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* attn_s = smem;                 // [hd]
  float* da_s = attn_s + hd;            // [hd]: the block's sums
  for (int i = threadIdx.x; i < hd; i += blockDim.x) {
    attn_s[i] = attn[i];
    da_s[i] = 0.f;
  }
  __syncthreads();

  const int heads_per_pass = 32 / lanes;
  const int hl = lane / lanes;
  const int fl = lane % lanes;
  const int span = lanes * kCols;  // columns of a head one group covers
  const int per_bucket = cap / 32;
  const int n_chunks = num_buckets * per_bucket;
  for (int h0 = 0; h0 < heads; h0 += heads_per_pass) {
    const int h = h0 + hl;
    for (int g0 = 0; g0 < dim; g0 += span) {
      int col[kCols];
      bool ok[kCols];
      float acc_a[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int d = g0 + fl + i * lanes;
        ok[i] = h < heads && d < dim;
        col[i] = ok[i] ? h * dim + d : 0;
        acc_a[i] = 0.f;
      }
      for (int k = blockIdx.x * kWarps + warp; k < n_chunks;
           k += gridDim.x * kWarps) {
        const int b = k / per_bucket;
        const int c0 = (k % per_bucket) * 32;
        const int s0 = b * cap + c0;
        const float vld = valid[s0 + lane];
        if (__ballot_sync(kFull, vld != 0.f) == 0u) {  // a padded tail
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
        const float* ut = u + static_cast<long long>(src_tile[b]) * tile * hd;
        const float* vt = v + static_cast<long long>(dst_tile[b]) * tile * hd;
        for (int j = 0; j < 32; ++j) {
          const bool live = __shfl_sync(kFull, vld, j) != 0.f;  // uniform
          const float* ur = ut + __shfl_sync(kFull, sl, j) * hd;
          const float* vr = vt + __shfl_sync(kFull, dl, j) * hd;
          if (live) {
            const float dsh = h < heads ? __ldg(dsb + h * cap + j) : 0.f;
#pragma unroll
            for (int i = 0; i < kCols; ++i) {
              if (!ok[i]) continue;
              const int c = col[i];
              const long long fo = static_cast<long long>(s0 + j) * hd + c;
              float raw = __ldg(ur + c) + __ldg(vr + c);
              if (kStore) raw += ld_slot(fe_s, fo);
              const bool pos = raw >= 0.f;
              acc_a[i] += dsh * (pos ? raw : slope * raw);
              if (kStore) {
                st_slot(dfe_s, fo, dsh * attn_s[c] * (pos ? 1.f : slope));
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
        }
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        if (ok[i]) atomicAdd(da_s + col[i], acc_a[i]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < hd; i += blockDim.x) {
    if (da_s[i] != 0.f) atomicAdd(da + i, da_s[i]);
  }
}

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

// K10 v2's scores as the slot-gradient and scores slice first wrote them
// (edge_scores_staged_kernel<KF>; csrc/gat_fused.cu's edge_scores_kernel,
// each lane's own row in 16-byte loads, ran faster on the card and took
// its place): a warp a chunk of 32 slots (grid-stride), its live slots'
// ef rows copied into the warp's part of shared memory by cp.async, 16
// bytes a copy where vec16 (Fe a multiple of 4, ef 16-byte aligned) else
// 4, each row padded (edge_row_floats) so that the lanes' reads of their
// own rows meet no bank conflict; the slots' node ids, and the next
// chunk's valid, read before the wait; then a lane a slot: raw = (el[src,
// h] + er[dst, h]) + sum_f ef[s, f] M[f, h] by FMAs from f = 0, p and g as
// gat_scores_kernel writes them.  KF: Fe, where it is a template width
// (the lane's row in registers), or 0 (a runtime loop over fe).

// 16 or 4 bytes from device memory into shared memory, and the wait for
// this thread's copies
__device__ __forceinline__ void cp_async16(float* smem, const float* g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// the floats a staged ef row takes in shared memory: Fe, padded so that
// the lanes' reads of their own rows (16 bytes at a time where Fe is a
// multiple of 4, else 4) fall in distinct banks
// (perf_slot_grad_scores.edge_row_floats)
__host__ __device__ __forceinline__ int edge_row_floats(int fe, bool vec16) {
  return vec16 ? ((fe / 4) % 2 == 1 ? fe : fe + 4) : (fe | 1);
}

// a warp's copies of the ef rows of chunk k's live slots (bit r of live:
// slot 32 k + r) into rows, a row every ld floats
__device__ __forceinline__ void stage_rows(float* rows, const float* ef,
                                           int k, int fe, int ld, bool vec16,
                                           unsigned live, int lane) {
  const float* block = ef + static_cast<long long>(k) * 32 * fe;
  if (vec16) {
    const int nq = fe / 4;
    for (int j = lane; j < 32 * nq; j += 32) {
      const int r = j / nq;
      if ((live >> r) & 1u) {
        cp_async16(rows + r * ld + (j - r * nq) * 4, block + j * 4);
      }
    }
  } else {
    for (int j = lane; j < 32 * fe; j += 32) {
      const int r = j / fe;
      if ((live >> r) & 1u) cp_async4(rows + r * ld + (j - r * fe), block + j);
    }
  }
}

template <int KF>
__global__ void __launch_bounds__(kEdgeWarps * 32)
edge_scores_staged_kernel(const int* __restrict__ src_local,
                          const int* __restrict__ dst_local,
                          const float* __restrict__ valid,
                          const int* __restrict__ src_tile,
                          const int* __restrict__ dst_tile, int num_chunks,
                          int tile, int cap, const float* __restrict__ el,
                          const float* __restrict__ er,
                          const float* __restrict__ ef,
                          const float* __restrict__ m, int fe, int vec16,
                          int heads, float slope, float* __restrict__ p,
                          float* __restrict__ g) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int ld = edge_row_floats(fe, vec16 != 0);
  float* m_s = smem;  // M, [fe][heads]
  float* rows = smem + ((fe * heads + 3) & ~3) + warp * 32 * ld;
  for (int i = threadIdx.x; i < fe * heads; i += blockDim.x) m_s[i] = m[i];
  __syncthreads();
  const int stride = gridDim.x * warps;
  int k = blockIdx.x * warps + warp;
  // valid of this chunk, read an iteration ahead
  float v = k < num_chunks ? valid[k * 32 + lane] : 0.f;
  for (; k < num_chunks; k += stride) {
    const int kn = k + stride;
    const float vn = kn < num_chunks ? valid[kn * 32 + lane] : 0.f;
    const int s = k * 32 + lane;
    const int b = (k * 32) / cap;  // cap is a multiple of 32: one bucket
    const int o = b * heads * cap + (s - b * cap);
    // the slot's node rows, their ids read before the stage's wait
    const float* elr = el;
    const float* err = er;
    if (v != 0.f) {
      elr += (src_tile[b] * tile + src_local[s]) * heads;
      err += (dst_tile[b] * tile + dst_local[s]) * heads;
    }
    __syncwarp();  // the last chunk's rows are read
    stage_rows(rows, ef, k, fe, ld, vec16 != 0,
               __ballot_sync(kFull, v != 0.f), lane);
    cp_async_wait_all();
    __syncwarp();
    if (v == 0.f) {
      for (int h = 0; h < heads; ++h) {
        p[o + h * cap] = 0.f;
        g[o + h * cap] = 0.f;
      }
    } else {
      const float* mine = rows + lane * ld;  // this lane's staged row
      float x[KF > 0 ? KF : 1];
      if constexpr (KF > 0) {
#pragma unroll
        for (int q = 0; q < KF / 4; ++q) {
          const float4 t4 = *reinterpret_cast<const float4*>(mine + 4 * q);
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
        } else if (vec16) {  // 16 bytes of the row at a time
          for (int q = 0; q < fe / 4; ++q) {
            const float4 t4 = *reinterpret_cast<const float4*>(mine + 4 * q);
            const float* mq = m_s + 4 * q * heads + h;
            t = fmaf(t4.x, mq[0], t);
            t = fmaf(t4.y, mq[heads], t);
            t = fmaf(t4.z, mq[2 * heads], t);
            t = fmaf(t4.w, mq[3 * heads], t);
          }
        } else {
          for (int f = 0; f < fe; ++f) {
            t = fmaf(mine[f], m_s[f * heads + h], t);
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

template <int kCols, typename T, bool kStore>
cudaError_t launch_slot_grad(Slots sl, int num_buckets, int tile, int cap,
                             Operands op, const float* ds, int lanes,
                             float* da, const void* fe_s, void* dfe_s,
                             int blocks, cudaStream_t stream) {
  const int hd = op.heads * op.dim;
  const size_t smem = sizeof(float) * 2 * hd;
  const cudaError_t err =
      allow_smem(vattn_slot_grad_kernel<kCols, T, kStore>, smem);
  if (err != cudaSuccess) return err;
  vattn_slot_grad_kernel<kCols, T, kStore><<<blocks, kWarps * 32, smem,
                                             stream>>>(
      sl.src_local, sl.dst_local, sl.valid, sl.src_tile, sl.dst_tile,
      num_buckets, tile, cap, op.u, op.v, op.attn, ds, op.heads, op.dim,
      lanes, op.slope, da, static_cast<const T*>(fe_s),
      static_cast<T*>(dfe_s));
  return cudaGetLastError();
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

// the dynamic shared memory of edge_scores_staged_kernel at `warps` warps
// a block: M, then 32 staged rows a warp
// (perf_slot_grad_scores.staged_scores_smem)
size_t edge_smem(int64_t fe, int64_t heads, int64_t warps, bool vec16) {
  return sizeof(float) *
         (((fe * heads + 3) & ~int64_t{3}) +
          warps * 32 * edge_row_floats(static_cast<int>(fe), vec16));
}

template <int KF>
const void* staged_kernel() {
  return reinterpret_cast<const void*>(edge_scores_staged_kernel<KF>);
}

// the staged kernel's instance for fe features
const void* staged_instance(int64_t fe, bool vec16) {
  return !vec16      ? staged_kernel<0>()
         : fe == 4   ? staged_kernel<4>()
         : fe == 8   ? staged_kernel<8>()
         : fe == 16  ? staged_kernel<16>()
         : fe == 32  ? staged_kernel<32>()
                     : staged_kernel<0>();
}

template <int KF>
cudaError_t launch_staged(const void* src_local, const void* dst_local,
                          const void* valid, const void* src_tile,
                          const void* dst_tile, int64_t num_slots,
                          int64_t tile, int64_t cap, const void* el,
                          const void* er, const void* ef, const void* m,
                          int64_t fe, int64_t heads, double slope, void* p,
                          void* g, int64_t blocks, int64_t warps, bool vec16,
                          cudaStream_t stream) {
  const size_t smem = edge_smem(fe, heads, warps, vec16);
  const cudaError_t err = allow_smem(edge_scores_staged_kernel<KF>, smem);
  if (err != cudaSuccess) return err;
  edge_scores_staged_kernel<KF><<<static_cast<unsigned>(blocks),
                                  static_cast<unsigned>(warps * 32), smem,
                                  stream>>>(
      static_cast<const int*>(src_local), static_cast<const int*>(dst_local),
      static_cast<const float*>(valid), static_cast<const int*>(src_tile),
      static_cast<const int*>(dst_tile), static_cast<int>(num_slots / 32),
      static_cast<int>(tile), static_cast<int>(cap),
      static_cast<const float*>(el), static_cast<const float*>(er),
      static_cast<const float*>(ef), static_cast<const float*>(m),
      static_cast<int>(fe), vec16 ? 1 : 0, static_cast<int>(heads),
      static_cast<float>(slope), static_cast<float*>(p),
      static_cast<float*>(g));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K11 v1's slot gradient: da (heads * dim) += the block sums of ds[h] *
// lrelu(raw), raw with the stored term fe_s (num_buckets * cap, heads *
// dim), and dW written to dfe_s at every slot (0 at padded ones), both f32
// (store 1) or bf16 (store 2).  da must be zeroed by the caller.  cols (1,
// 2 or 4): the columns of its head a lane keeps at once.  Without a stored
// term (K9's da, csrc/row_agg.cu's fold) the call returns
// cudaErrorInvalidValue; K11 v2's, with the edge term, is
// dgl_vattn_slot_grad_mma.  Grid: `blocks` blocks of 8 warps.
int dgl_vattn_slot_grad(const void* src_local, const void* dst_local,
                        const void* valid, const void* src_tile,
                        const void* dst_tile, int64_t num_buckets,
                        int64_t tile, int64_t cap, const void* u,
                        const void* v, const void* attn, const void* ds,
                        int64_t heads, int64_t dim, int64_t lanes,
                        int64_t cols, double slope, void* da,
                        const void* fe_s, void* dfe_s, int64_t store,
                        int64_t blocks, int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Slots sl = slots(src_local, dst_local, valid, src_tile, dst_tile);
  const Operands op = operands(u, v, attn, nullptr, nullptr, 0, 0, heads,
                               dim, slope);
#define DGL_GRAD_ARGS                                                        \
  sl, static_cast<int>(num_buckets), static_cast<int>(tile),                 \
      static_cast<int>(cap), op, static_cast<const float*>(ds),              \
      static_cast<int>(lanes), static_cast<float*>(da), fe_s, dfe_s,         \
      static_cast<int>(blocks), s
  if (fe_s == nullptr || dfe_s == nullptr) {
    return cudaErrorInvalidValue;  // K9's da: csrc/row_agg.cu's fold
  }
#define DGL_STORE_CASE(COLS_, T_, STORE_)                                    \
  if (cols == COLS_ && store == STORE_) {                                    \
    return launch_slot_grad<COLS_, T_, true>(DGL_GRAD_ARGS);                 \
  }
  DGL_STORE_CASE(1, float, 1)
  DGL_STORE_CASE(2, float, 1)
  DGL_STORE_CASE(4, float, 1)
  DGL_STORE_CASE(1, __nv_bfloat16, 2)
  DGL_STORE_CASE(2, __nv_bfloat16, 2)
  DGL_STORE_CASE(4, __nv_bfloat16, 2)
#undef DGL_STORE_CASE
#undef DGL_GRAD_ARGS
  return cudaErrorInvalidValue;
}

// p and g (num_slots / cap, heads, cap) from el (num_src, heads) and er
// (num_dst, heads); ee (the same shape as p) is added to raw when it is
// not null, or with ef (num_slots, fe) and m (fe, heads) not null, ef[s, :]
// . m[:, h] (M in shared memory: fe * heads floats).  Every element of p
// and g is written.  Grid: `blocks` blocks of 256 threads, grid-stride
// over slots.
int dgl_gat_scores_thread(const void* src_local, const void* dst_local,
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

// K10 v2's p and g (num_slots / cap, heads, cap) by the staged kernel, from
// el (num_src, heads), er (num_dst, heads), ef (num_slots, fe) and m (fe,
// heads).  Grid: `blocks` blocks of `warps` warps (1 to 8) over 32-slot
// chunks (cap a multiple of 32), each warp staging 32 rows of
// edge_row_floats(fe, vec16) floats in shared memory beside M; vec16: fe a
// multiple of 4 and ef 16-byte aligned.
int dgl_edge_scores_staged(const void* src_local, const void* dst_local,
                           const void* valid, const void* src_tile,
                           const void* dst_tile, int64_t num_slots,
                           int64_t tile, int64_t cap, const void* el,
                           const void* er, const void* ef, const void* m,
                           int64_t fe, int64_t heads, double slope, void* p,
                           void* g, int64_t blocks, int64_t warps,
                           int64_t vec16, int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ef == nullptr || m == nullptr || fe < 0 || cap % 32 != 0 ||
      warps < 1 || warps > kEdgeWarps ||
      (vec16 && (fe % 4 != 0 || reinterpret_cast<uintptr_t>(ef) % 16 != 0)))
    return cudaErrorInvalidValue;
#define DGL_EDGE_ARGS                                                      \
  src_local, dst_local, valid, src_tile, dst_tile, num_slots, tile, cap,   \
      el, er, ef, m, fe, heads, slope, p, g, blocks, warps, vec16 != 0, s
  if (vec16 && fe == 4) return launch_staged<4>(DGL_EDGE_ARGS);
  if (vec16 && fe == 8) return launch_staged<8>(DGL_EDGE_ARGS);
  if (vec16 && fe == 16) return launch_staged<16>(DGL_EDGE_ARGS);
  if (vec16 && fe == 32) return launch_staged<32>(DGL_EDGE_ARGS);
  return launch_staged<0>(DGL_EDGE_ARGS);
#undef DGL_EDGE_ARGS
}

// attrs (three host ints): the registers a thread, the local memory bytes
// a thread and the resident blocks an SM of the staged kernel's instance
// for fe features (vec16 as dgl_edge_scores_staged takes it) at `warps`
// warps a block with its shared memory for `heads` heads
int dgl_edge_scores_staged_attrs(int64_t fe, int64_t heads, int64_t warps,
                                 int64_t vec16, int64_t device,
                                 void* attrs) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const void* kernel = staged_instance(fe, vec16 != 0);
  const size_t smem = edge_smem(fe, heads, warps, vec16 != 0);
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
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      o + 2, kernel, static_cast<int>(warps * 32), smem);
}

}  // extern "C"
