// Tile-bucketed SpMM (K3) on Hopper over the tiled format.
//
// Format (dgl_tpu_torch/ops/kernels/tiled_spmm.py, the JAX package's
// dgl_tpu/ops/pallas/tiled_spmm.py:49-88): edges bucketed by (dst tile,
// src tile) pairs of `tile` nodes, `cap` slots per bucket; for flat slot
// s = b * cap + c, src_local[s] / dst_local[s] are ids within tiles
// src_tile[b] / dst_tile[b], and valid[s] is 1 for a real edge.  Padded
// slots hold src_local = dst_local = 0, i.e. they alias row 0 of their
// tiles: every kernel here skips a slot whose valid is 0.  dst_tile never
// decreases, so dst tile t owns the buckets [dst_ptr[t], dst_ptr[t + 1]).
//
// K3, behind a plain C entry point that launches on the caller's stream,
// allocates nothing and returns cudaGetLastError():
//
// K3  tiled_spmm_kernel<G, kCopy=true/false>  replaces
//     dgl_tpu/ops/pallas/tiled_spmm.py tiled_spmm -> _spmm_one_call
//     (body _spmm_kernel).  out[d] = sum over slots of w * x[src].
// K4's SpMM (tiled_spmm_multihead) and SDDMM (tiled_sddmm_dot_multihead)
// are the row walks of csrc/row_agg.cu.
//
// The TPU kernel builds one-hot matrices of each bucket and contracts them
// on the matrix unit, bucket after bucket, carrying the output tile in
// VMEM from one grid step to the next.  None of that carries over: here
// the work per slot is a gather and an add.
//
// SpMM design.  One block per (dst tile, column chunk of G columns, split
// of the tile's buckets).  The block keeps its tile's output rows for the
// chunk in shared memory, tile x G f32 (128 KB at tile 1024, G = 32), and
// walks its buckets' slots in 32-slot chunks, one chunk per warp in turn:
// the lanes load the chunk's src_local, dst_local and valid coalesced,
// then G lanes serve one slot at a time (32 / G slots per warp step), each
// lane one column.  All G steps' x gathers are issued before their adds,
// so a lane keeps G loads in flight.  The adds are shared-memory atomics
// at [dst_local][column].  At the end the block writes its rows once;
// with several splits per tile the blocks add their rows into `out`
// (zeroed by the caller) with global atomics instead.  A tile with no
// bucket writes zeros, the JAX format's covered_mask.
//
// Bound on an H100 SXM (3.35 TB/s): it streams the slot arrays (12 B a
// slot: src_local, dst_local, valid) and gathers x rows that mostly hit
// L2, since a bucket reads one src tile; the f32 arithmetic (2 operations
// per slot and column) is far below the card's 67 TFLOP/s.  chip_smoke.py
// prints the bound at the Reddit graph's shapes.  Indices are int32: the
// wrapper checks that every flat size fits.

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

}  // namespace

extern "C" {

// K3: out (num_dst, f) from x (num_src, f).  w is null for a plain sum;
// otherwise the weight of slot s = b * cap + c is w[s].  group (8, 16 or
// 32) is G; with splits > 1, out must be zeroed by the caller.  Grid:
// (num_dst_tiles, ceil(f / G), splits).
int dgl_tiled_spmm(const void* src_local, const void* dst_local,
                   const void* valid, const void* w, const void* src_tile,
                   const void* dst_ptr, int64_t num_dst_tiles, int64_t tile,
                   int64_t cap, const void* x, int64_t f, void* out,
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

}  // extern "C"
