// The two kernels that K3 and K6's slot reduce left, kept to be timed
// beside the row walks that replaced them (dgl_tpu_torch/tools/
// perf_reduce_k3.py builds this file with the package's nvcc flags).
// Neither is on a main path.
//
// Format (dgl_tpu_torch/ops/kernels/tiled_spmm.py): edges bucketed by (dst
// tile, src tile) pairs of `tile` nodes, `cap` slots per bucket; for flat
// slot s = b * cap + c, src_local[s] / dst_local[s] are ids within tiles
// src_tile[b] / dst_tile[b], and valid[s] is 1 for a real edge.  Padded
// slots alias row 0 of their tiles: both kernels skip a slot whose valid
// is 0.  dst tile t owns the buckets [dst_ptr[t], dst_ptr[t + 1]); src
// tile t owns the buckets src_order[src_ptr[t] .. src_ptr[t + 1]).
//
// tiled_spmm_kernel<G, kCopy>, K3 (dgl_tpu/ops/pallas/tiled_spmm.py
// tiled_spmm -> _spmm_one_call, body _spmm_kernel): out[d] = sum over
// slots of w * x[src].  One block per (dst tile, column chunk of G
// columns, split of the tile's buckets); the tile's output rows for the
// chunk in shared memory, tile x G f32; the block walks its buckets'
// slots in 32-slot chunks, one chunk per warp in turn, G lanes a slot, a
// lane a column, all G steps' x gathers issued before their adds, which
// are shared-memory atomics at [dst_local][column]; at the end the block
// writes its rows once, or with several splits adds them into `out`
// (zeroed by the caller) with global atomics.  A tile with no bucket
// writes zeros.
//
// slot_reduce_kernel<kSrc>, K6's slot reduce (gat_fused.py _den_kernel,
// _der_kernel and, with kSrc, _del_kernel): one block per dst tile (or
// src tile, walking src_order) and split of its buckets; the tile's
// (tile, hg) sums of a group of hg heads in shared memory; the block reads
// each bucket's hg * cap values coalesced and adds them at [local][h] with
// a float atomicAdd.  Heads beyond what a block's shared memory holds take
// further launches, each with its head offset; with several splits the
// caller zeroes `out` and the blocks add their rows with global atomics.
//
// A float atomicAdd is a compare-and-swap loop on this card: that, and
// the reduce's bank conflicts at [local * hg + h] (8-way at hg = 8), is
// what the row walks took away.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSpmmWarps = 16;   // warps per SpMM block

template <int G, bool kCopy>
__global__ void __launch_bounds__(kSpmmWarps * 32)
tiled_spmm_kernel(const int* __restrict__ src_local,
                  const int* __restrict__ dst_local,
                  const float* __restrict__ valid,
                  const float* __restrict__ w,
                  const int* __restrict__ src_tile,
                  const int* __restrict__ dst_ptr, int tile, int cap,
                  const float* __restrict__ x, int f,
                  float* __restrict__ out, int num_dst, int splits) {
  extern __shared__ float acc[];  // [tile][G]
  constexpr int kSlots = 32 / G;  // slots a warp serves per step
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / G;
  const int gcol = lane % G;
  const int t = blockIdx.x;
  const int col = blockIdx.y * G + gcol;
  const bool col_ok = col < f;
  for (int i = threadIdx.x; i < tile * G; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int b_lo = dst_ptr[t];
  const int nb = dst_ptr[t + 1] - b_lo;
  const int b0 = b_lo + static_cast<int>(
      static_cast<long long>(nb) * blockIdx.z / splits);
  const int b1 = b_lo + static_cast<int>(
      static_cast<long long>(nb) * (blockIdx.z + 1) / splits);
  const int per_bucket = cap / 32;
  const int n_chunks = (b1 - b0) * per_bucket;

  for (int k = warp; k < n_chunks; k += kSpmmWarps) {
    const int b = b0 + k / per_bucket;
    const int s0 = b * cap + (k % per_bucket) * 32;  // the chunk's slot 0
    const float v = valid[s0 + lane];
    if (__ballot_sync(kFull, v != 0.f) == 0u) continue;  // padded tail
    const int sl = src_local[s0 + lane];
    const int dl = dst_local[s0 + lane];
    float wl = 1.f;
    if (!kCopy) wl = v != 0.f ? w[s0 + lane] : 0.f;
    const float* xt = x + src_tile[b] * tile * f + col;
    float xv[G];
    int dv[G];
    unsigned on = 0u;
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int j = i * kSlots + sub;  // the chunk's slot at step i
      const int slj = __shfl_sync(kFull, sl, j);
      dv[i] = __shfl_sync(kFull, dl, j);
      const bool live = __shfl_sync(kFull, v, j) != 0.f && col_ok;
      float wj = 1.f;
      if (!kCopy) wj = __shfl_sync(kFull, wl, j);
      xv[i] = live ? __ldg(xt + slj * f) * wj : 0.f;
      on |= static_cast<unsigned>(live) << i;
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (on & (1u << i)) atomicAdd(acc + dv[i] * G + gcol, xv[i]);
    }
  }
  __syncthreads();

  const int r0 = t * tile;
  for (int i = threadIdx.x; i < tile * G; i += blockDim.x) {
    const int row = r0 + i / G;
    const int c = blockIdx.y * G + i % G;
    if (row >= num_dst || c >= f) continue;
    if (splits == 1) {
      out[row * f + c] = acc[i];
    } else if (acc[i] != 0.f) {
      atomicAdd(out + row * f + c, acc[i]);
    }
  }
}

template <int G, bool kCopy>
cudaError_t launch_spmm(const void* src_local, const void* dst_local,
                        const void* valid, const void* w,
                        const void* src_tile, const void* dst_ptr,
                        int64_t num_dst_tiles, int64_t tile, int64_t cap,
                        const void* x, int64_t f, void* out, int64_t num_dst,
                        int64_t splits, cudaStream_t stream) {
  const size_t smem = sizeof(float) * tile * G;
  cudaError_t err = cudaFuncSetAttribute(
      tiled_spmm_kernel<G, kCopy>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(num_dst_tiles),
                  static_cast<unsigned>((f + G - 1) / G),
                  static_cast<unsigned>(splits));
  tiled_spmm_kernel<G, kCopy><<<grid, kSpmmWarps * 32, smem, stream>>>(
      static_cast<const int*>(src_local), static_cast<const int*>(dst_local),
      static_cast<const float*>(valid), static_cast<const float*>(w),
      static_cast<const int*>(src_tile), static_cast<const int*>(dst_ptr),
      static_cast<int>(tile), static_cast<int>(cap),
      static_cast<const float*>(x), static_cast<int>(f),
      static_cast<float*>(out), static_cast<int>(num_dst),
      static_cast<int>(splits));
  return cudaGetLastError();
}

template <int G>
cudaError_t spmm_by_kind(const void* src_local, const void* dst_local,
                         const void* valid, const void* w,
                         const void* src_tile, const void* dst_ptr,
                         int64_t num_dst_tiles, int64_t tile, int64_t cap,
                         const void* x, int64_t f, void* out, int64_t num_dst,
                         int64_t splits, cudaStream_t stream) {
  if (w == nullptr) {
    return launch_spmm<G, true>(src_local, dst_local, valid, w, src_tile,
                                dst_ptr, num_dst_tiles, tile, cap, x, f, out,
                                num_dst, splits, stream);
  }
  return launch_spmm<G, false>(src_local, dst_local, valid, w, src_tile,
                               dst_ptr, num_dst_tiles, tile, cap, x, f, out,
                               num_dst, splits, stream);
}


constexpr int kReduceThreads = 512;

template <bool kSrc>
__global__ void __launch_bounds__(kReduceThreads)
slot_reduce_kernel(const int* __restrict__ local,
                   const float* __restrict__ valid,
                   const float* __restrict__ vals,
                   const int* __restrict__ order,
                   const int* __restrict__ ptr, int tile, int cap, int heads,
                   int h0, int hg, float* __restrict__ out, int num_rows,
                   int splits) {
  extern __shared__ float acc[];  // [tile][hg]: heads h0 .. h0 + hg - 1
  const int t = blockIdx.x;
  const int n_acc = tile * hg;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const int k_lo = ptr[t];
  const int nb = ptr[t + 1] - k_lo;
  const int k0 = k_lo + static_cast<int>(
      static_cast<long long>(nb) * blockIdx.y / splits);
  const int k1 = k_lo + static_cast<int>(
      static_cast<long long>(nb) * (blockIdx.y + 1) / splits);
  const int per_bucket = hg * cap;  // the group's heads, contiguous
  for (int k = k0; k < k1; ++k) {
    const int b = kSrc ? order[k] : k;
    const int* lb = local + b * cap;
    const float* vb = valid + b * cap;
    const float* xb = vals + (b * heads + h0) * cap;
    for (int j = threadIdx.x; j < per_bucket; j += blockDim.x) {
      const int h = j / cap;
      const int c = j - h * cap;
      if (vb[c] != 0.f) atomicAdd(acc + lb[c] * hg + h, xb[j]);
    }
  }
  __syncthreads();

  const int r0 = t * tile;
  const int n_out = min(tile, num_rows - r0) * hg;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    const int o = (r0 + i / hg) * heads + h0 + i % hg;
    if (splits == 1) {
      out[o] = acc[i];
    } else if (acc[i] != 0.f) {
      atomicAdd(out + o, acc[i]);
    }
  }
}

}  // namespace

extern "C" {

// K3: out (num_dst, f) from x (num_src, f).  w is null for a plain sum;
// otherwise the weight of slot s = b * cap + c is w[s].  group (8, 16 or
// 32) is G; with splits > 1, out must be zeroed by the caller.  Grid:
// (num_dst_tiles, ceil(f / G), splits).
int dgl_probe_tiled_spmm(const void* src_local, const void* dst_local,
                         const void* valid, const void* w,
                         const void* src_tile, const void* dst_ptr,
                         int64_t num_dst_tiles, int64_t tile, int64_t cap,
                         const void* x, int64_t f, void* out,
                         int64_t num_dst, int64_t group, int64_t splits,
                         int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DGL_SPMM_CASE(G_)                                                   \
  case G_:                                                                  \
    return spmm_by_kind<G_>(src_local, dst_local, valid, w, src_tile,       \
                            dst_ptr, num_dst_tiles, tile, cap, x, f, out,   \
                            num_dst, splits, s);
  switch (group) {
    DGL_SPMM_CASE(8)
    DGL_SPMM_CASE(16)
    DGL_SPMM_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef DGL_SPMM_CASE
}

// out (num_rows, heads), columns h0 .. h0 + hg - 1: the sum of vals (B,
// heads, cap) over the valid slots of each dst row (src_side = 0: local is
// dst_local, ptr is dst_ptr, order is unused) or src row (src_side = 1:
// local is src_local, order is src_order, ptr is src_ptr).  With splits >
// 1, out must be zeroed by the caller.  Grid: (num_tiles, splits), tile *
// hg floats of shared memory.
int dgl_probe_slot_reduce(const void* local, const void* valid,
                          const void* vals, const void* order,
                          const void* ptr, int64_t num_tiles, int64_t tile,
                          int64_t cap, int64_t heads, int64_t h0, int64_t hg,
                          void* out, int64_t num_rows, int64_t splits,
                          int64_t src_side, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * tile * hg;
  const dim3 grid(static_cast<unsigned>(num_tiles),
                  static_cast<unsigned>(splits));
#define DGL_REDUCE_LAUNCH(SRC_)                                              \
  err = cudaFuncSetAttribute(slot_reduce_kernel<SRC_>,                      \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                             static_cast<int>(smem));                       \
  if (err != cudaSuccess) return err;                                        \
  slot_reduce_kernel<SRC_><<<grid, kReduceThreads, smem, s>>>(               \
      static_cast<const int*>(local), static_cast<const float*>(valid),      \
      static_cast<const float*>(vals), static_cast<const int*>(order),       \
      static_cast<const int*>(ptr), static_cast<int>(tile),                  \
      static_cast<int>(cap), static_cast<int>(heads), static_cast<int>(h0),  \
      static_cast<int>(hg), static_cast<float*>(out),                        \
      static_cast<int>(num_rows), static_cast<int>(splits));
  if (src_side != 0) {
    DGL_REDUCE_LAUNCH(true)
  } else {
    DGL_REDUCE_LAUNCH(false)
  }
#undef DGL_REDUCE_LAUNCH
  return cudaGetLastError();
}

}  // extern "C"
