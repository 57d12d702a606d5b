// Tile-bucketed SpMM and SDDMM on Hopper over the tiled format.
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
// Three functions, behind two plain C entry points that launch on the
// caller's stream, allocate nothing and return cudaGetLastError():
//
// K3  tiled_spmm_kernel<G, kCopy=true/false, kMH=false>  replaces
//     dgl_tpu/ops/pallas/tiled_spmm.py tiled_spmm -> _spmm_one_call
//     (body _spmm_kernel).  out[d] = sum over slots of w * x[src].
// K4  tiled_spmm_kernel<G, false, kMH=true>  replaces tiled_spmm_multihead
//     (body _spmm_mh_kernel): the same walk over the H * Fh columns of x
//     viewed as (N, H * Fh), with the weight of column j at slot (b, c)
//     read from w_slot[b, j / Fh, c].
// K4  tiled_sddmm_mh_kernel<L>  replaces tiled_sddmm_dot_multihead (body
//     _sddmm_mh_kernel): e[b, h, c] = <x[src, h, :], z[dst, h, :]>, and 0
//     at padded slots, where the TPU kernel writes the product of row 0
//     of each tile.
//
// The TPU kernels build one-hot matrices of each bucket and contract them
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
// SDDMM design.  One warp per 32-slot chunk, grid-stride.  L lanes share
// one head (L = 32 / heads rounded up to a power of two), each lane takes
// every L-th column of that head, and the L partial dots are summed with
// xor shuffles.  4 slots are in flight together, and a lane loads 4 of
// its columns of each before it adds any; a chunk of padding only writes
// zeros.
//
// Bound on an H100 SXM (3.35 TB/s): all three stream the slot arrays
// (12 B a slot for K3: src_local, dst_local, valid; K4 adds 4 B a slot and
// head of w or of e) and gather x rows (and z rows) that mostly hit L2,
// since a bucket reads one src tile; the f32 arithmetic (2 operations per
// slot and column) is far below the card's 67 TFLOP/s.  chip_smoke.py
// prints each bound at the Reddit graph's shapes.  Indices are int32: the
// wrappers check that every flat size fits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSpmmWarps = 16;   // warps per SpMM block
constexpr int kSddmmWarps = 8;   // warps per SDDMM block
constexpr int kSddmmUnroll = 4;  // SDDMM slots in flight per warp
constexpr int kSddmmCols = 4;    // SDDMM columns a lane loads per slot at once

template <int G, bool kCopy, bool kMH>
__global__ void __launch_bounds__(kSpmmWarps * 32)
tiled_spmm_kernel(const int* __restrict__ src_local,
                  const int* __restrict__ dst_local,
                  const float* __restrict__ valid,
                  const float* __restrict__ w, int w_bucket_stride,
                  int w_head_stride, int head_cols,
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
  // K4: the head of this lane's column, and its offset in w_slot
  const int w_head = kMH && col_ok ? (col / head_cols) * w_head_stride : 0;

  for (int k = warp; k < n_chunks; k += kSpmmWarps) {
    const int b = b0 + k / per_bucket;
    const int s0 = b * cap + (k % per_bucket) * 32;  // the chunk's slot 0
    const float v = valid[s0 + lane];
    if (__ballot_sync(kFull, v != 0.f) == 0u) continue;  // padded tail
    const int sl = src_local[s0 + lane];
    const int dl = dst_local[s0 + lane];
    float wl = 1.f;
    if (!kCopy && !kMH) wl = v != 0.f ? w[b * w_bucket_stride + s0 - b * cap
                                          + lane] : 0.f;
    const float* xt = x + src_tile[b] * tile * f + col;
    const float* wb =
        kMH ? w + b * w_bucket_stride + w_head + s0 - b * cap : nullptr;
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
      if (!kCopy && !kMH) wj = __shfl_sync(kFull, wl, j);
      if (kMH) wj = live ? __ldg(wb + j) : 0.f;
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

template <int L>
__global__ void __launch_bounds__(kSddmmWarps * 32)
tiled_sddmm_mh_kernel(const int* __restrict__ src_local,
                      const int* __restrict__ dst_local,
                      const float* __restrict__ valid,
                      const int* __restrict__ src_tile,
                      const int* __restrict__ dst_tile, int num_buckets,
                      int tile, int cap, const float* __restrict__ x,
                      const float* __restrict__ z, int heads, int fh,
                      float* __restrict__ out) {
  constexpr int kHeadsPerPass = 32 / L;
  const int lane = threadIdx.x & 31;
  const int hl = lane / L;  // head of this lane within a pass
  const int fl = lane % L;  // first column of this lane within its head
  const int hf = heads * fh;
  const int per_bucket = cap / 32;
  const int n_chunks = num_buckets * per_bucket;
  for (int k = blockIdx.x * kSddmmWarps + (threadIdx.x >> 5); k < n_chunks;
       k += gridDim.x * kSddmmWarps) {
    const int b = k / per_bucket;
    const int c0 = (k % per_bucket) * 32;  // the chunk's first slot in b
    const int s0 = b * cap + c0;
    const float v = valid[s0 + lane];
    const int sl = src_local[s0 + lane];
    const int dl = dst_local[s0 + lane];
    const float* xt = x + src_tile[b] * tile * hf;
    const float* zt = z + dst_tile[b] * tile * hf;
    float* ob = out + b * heads * cap + c0;  // e[b, h, c0 + j] = ob[h*cap+j]
    if (__ballot_sync(kFull, v != 0.f) == 0u) {  // a padded tail: all 0
      for (int h = 0; h < heads; ++h) ob[h * cap + lane] = 0.f;
      continue;
    }
    for (int j0 = 0; j0 < 32; j0 += kSddmmUnroll) {
      const float* xr[kSddmmUnroll];
      const float* zr[kSddmmUnroll];
      bool live[kSddmmUnroll];
#pragma unroll
      for (int u = 0; u < kSddmmUnroll; ++u) {
        live[u] = __shfl_sync(kFull, v, j0 + u) != 0.f;  // warp-uniform
        xr[u] = xt + __shfl_sync(kFull, sl, j0 + u) * hf;
        zr[u] = zt + __shfl_sync(kFull, dl, j0 + u) * hf;
      }
      for (int h0 = 0; h0 < heads; h0 += kHeadsPerPass) {
        const int h = h0 + hl;
        const int c_end = h < heads ? (h + 1) * fh : 0;  // this head's end
        float s[kSddmmUnroll];
#pragma unroll
        for (int u = 0; u < kSddmmUnroll; ++u) s[u] = 0.f;
        // kSddmmCols columns of every slot are loaded before any is added,
        // so a lane has 2 * kSddmmUnroll * kSddmmCols loads in flight
        for (int cb = h * fh + fl; cb < c_end; cb += L * kSddmmCols) {
          float xv[kSddmmUnroll][kSddmmCols];
          float zv[kSddmmUnroll][kSddmmCols];
#pragma unroll
          for (int u = 0; u < kSddmmUnroll; ++u) {
#pragma unroll
            for (int i = 0; i < kSddmmCols; ++i) {
              const int c = cb + i * L;
              const bool ok = live[u] && c < c_end;
              xv[u][i] = ok ? __ldg(xr[u] + c) : 0.f;
              zv[u][i] = ok ? __ldg(zr[u] + c) : 0.f;
            }
          }
#pragma unroll
          for (int u = 0; u < kSddmmUnroll; ++u) {
#pragma unroll
            for (int i = 0; i < kSddmmCols; ++i) s[u] += xv[u][i] * zv[u][i];
          }
        }
#pragma unroll
        for (int u = 0; u < kSddmmUnroll; ++u) {
#pragma unroll
          for (int o = L / 2; o > 0; o >>= 1) {
            s[u] += __shfl_xor_sync(kFull, s[u], o);
          }
          if (fl == 0 && h < heads) ob[h * cap + j0 + u] = s[u];
        }
      }
    }
  }
}

template <int G, bool kCopy, bool kMH>
cudaError_t launch_spmm(const void* src_local, const void* dst_local,
                        const void* valid, const void* w,
                        int64_t w_bucket_stride, int64_t w_head_stride,
                        int64_t head_cols, const void* src_tile,
                        const void* dst_ptr, int64_t num_dst_tiles,
                        int64_t tile, int64_t cap, const void* x, int64_t f,
                        void* out, int64_t num_dst, int64_t splits,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * tile * G;
  cudaError_t err = cudaFuncSetAttribute(
      tiled_spmm_kernel<G, kCopy, kMH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(num_dst_tiles),
                  static_cast<unsigned>((f + G - 1) / G),
                  static_cast<unsigned>(splits));
  tiled_spmm_kernel<G, kCopy, kMH><<<grid, kSpmmWarps * 32, smem, stream>>>(
      static_cast<const int*>(src_local), static_cast<const int*>(dst_local),
      static_cast<const float*>(valid), static_cast<const float*>(w),
      static_cast<int>(w_bucket_stride), static_cast<int>(w_head_stride),
      static_cast<int>(head_cols), static_cast<const int*>(src_tile),
      static_cast<const int*>(dst_ptr), static_cast<int>(tile),
      static_cast<int>(cap), static_cast<const float*>(x),
      static_cast<int>(f), static_cast<float*>(out),
      static_cast<int>(num_dst), static_cast<int>(splits));
  return cudaGetLastError();
}

template <int G>
cudaError_t spmm_by_kind(const void* src_local, const void* dst_local,
                         const void* valid, const void* w,
                         int64_t w_bucket_stride, int64_t w_head_stride,
                         int64_t head_cols, const void* src_tile,
                         const void* dst_ptr, int64_t num_dst_tiles,
                         int64_t tile, int64_t cap, const void* x, int64_t f,
                         void* out, int64_t num_dst, int64_t splits,
                         bool multihead, cudaStream_t stream) {
  if (multihead) {
    return launch_spmm<G, false, true>(
        src_local, dst_local, valid, w, w_bucket_stride, w_head_stride,
        head_cols, src_tile, dst_ptr, num_dst_tiles, tile, cap, x, f, out,
        num_dst, splits, stream);
  }
  if (w == nullptr) {
    return launch_spmm<G, true, false>(
        src_local, dst_local, valid, w, w_bucket_stride, w_head_stride,
        head_cols, src_tile, dst_ptr, num_dst_tiles, tile, cap, x, f, out,
        num_dst, splits, stream);
  }
  return launch_spmm<G, false, false>(
      src_local, dst_local, valid, w, w_bucket_stride, w_head_stride,
      head_cols, src_tile, dst_ptr, num_dst_tiles, tile, cap, x, f, out,
      num_dst, splits, stream);
}

template <int L>
cudaError_t launch_sddmm(const void* src_local, const void* dst_local,
                         const void* valid, const void* src_tile,
                         const void* dst_tile, int64_t num_buckets,
                         int64_t tile, int64_t cap, const void* x,
                         const void* z, int64_t heads, int64_t fh, void* out,
                         int64_t blocks, cudaStream_t stream) {
  tiled_sddmm_mh_kernel<L><<<static_cast<unsigned>(blocks),
                             kSddmmWarps * 32, 0, stream>>>(
      static_cast<const int*>(src_local), static_cast<const int*>(dst_local),
      static_cast<const float*>(valid), static_cast<const int*>(src_tile),
      static_cast<const int*>(dst_tile), static_cast<int>(num_buckets),
      static_cast<int>(tile), static_cast<int>(cap),
      static_cast<const float*>(x), static_cast<const float*>(z),
      static_cast<int>(heads), static_cast<int>(fh),
      static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3 (multihead = 0) or K4 SpMM (multihead = 1): out (num_dst, f) from x
// (num_src, f).  w is null for a plain sum; otherwise the weight of
// column j at slot (b, c) is w[b * w_bucket_stride + (j / head_cols) *
// w_head_stride + c].  group (8, 16 or 32) is G; with splits > 1, out must
// be zeroed by the caller.  Grid: (num_dst_tiles, ceil(f / G), splits).
int dgl_tiled_spmm(const void* src_local, const void* dst_local,
                   const void* valid, const void* w, int64_t w_bucket_stride,
                   int64_t w_head_stride, int64_t head_cols,
                   const void* src_tile, const void* dst_ptr,
                   int64_t num_dst_tiles, int64_t tile, int64_t cap,
                   const void* x, int64_t f, void* out, int64_t num_dst,
                   int64_t group, int64_t splits, int64_t multihead,
                   int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mh = multihead != 0;
  switch (group) {
    case 8:
      return spmm_by_kind<8>(src_local, dst_local, valid, w, w_bucket_stride,
                             w_head_stride, head_cols, src_tile, dst_ptr,
                             num_dst_tiles, tile, cap, x, f, out, num_dst,
                             splits, mh, s);
    case 16:
      return spmm_by_kind<16>(src_local, dst_local, valid, w,
                              w_bucket_stride, w_head_stride, head_cols,
                              src_tile, dst_ptr, num_dst_tiles, tile, cap, x,
                              f, out, num_dst, splits, mh, s);
    case 32:
      return spmm_by_kind<32>(src_local, dst_local, valid, w,
                              w_bucket_stride, w_head_stride, head_cols,
                              src_tile, dst_ptr, num_dst_tiles, tile, cap, x,
                              f, out, num_dst, splits, mh, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// K4 SDDMM: out (num_buckets, heads, cap), every element written, from x
// (num_src, heads, fh) and z (num_dst, heads, fh).  lanes is L, the lanes
// per head (32 over heads rounded up to a power of two, at least 1).
// Grid: `blocks` blocks of 8 warps, grid-stride over 32-slot chunks.
int dgl_tiled_sddmm_mh(const void* src_local, const void* dst_local,
                       const void* valid, const void* src_tile,
                       const void* dst_tile, int64_t num_buckets,
                       int64_t tile, int64_t cap, const void* x,
                       const void* z, int64_t heads, int64_t fh, void* out,
                       int64_t lanes, int64_t blocks, int64_t device,
                       void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DGL_SDDMM_CASE(L_)                                                  \
  case L_:                                                                  \
    return launch_sddmm<L_>(src_local, dst_local, valid, src_tile,          \
                            dst_tile, num_buckets, tile, cap, x, z, heads,  \
                            fh, out, blocks, s);
  switch (lanes) {
    DGL_SDDMM_CASE(1)
    DGL_SDDMM_CASE(2)
    DGL_SDDMM_CASE(4)
    DGL_SDDMM_CASE(8)
    DGL_SDDMM_CASE(16)
    DGL_SDDMM_CASE(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef DGL_SDDMM_CASE
}

}  // extern "C"
