// The row walk on Hopper: a weighted multi-head aggregation over the row
// view of the tiled format, one pass over a row's slots for all columns,
// each sum in registers.
//
//   out[r, h, :] = sum over the valid slots s of row r of
//                  w[b(s), h, c(s)] * y[nbr(s), h, :]
//
// row_agg_kernel<VEC, CPL> replaces two TPU kernels of the JAX package:
// - K4's SpMM, dgl_tpu/ops/pallas/tiled_spmm.py tiled_spmm_multihead
//   :455 (body _spmm_mh_kernel :423), and with it
//   gat_fused.py _agg_kernel :120, the same function: the rows are the dst
//   nodes, the neighbours the srcs, y = x (gat_forward :328,
//   dot_gat_forward :547 and dq :614, gatv2_forward's num :811,
//   egatc_forward's num :1121, edgegat_v2_forward's node term);
// - K6's dx, gat_fused.py _dx_kernel :202, the src-side aggregation:
//   the rows are the src nodes, the neighbours the dsts, y = z
//   (gat_backward :428, _dot_gat_bwd's _dx_call :623/:636, _gatv2_bwd's
//   dx :925, _egatc_bwd's dx :1236, and the dx part of
//   _eg2_dx_def_kernel :1639).
//
// The row view (dgl_tpu_torch/ops/kernels/tiled_spmm.py RowView), one per
// side of a format: ptr (rows + 1,), and for the E valid slots grouped by
// row, ascending slot id within a row, slot (the flat slot s = b * cap +
// c) and nbr (the global id of the neighbour), all int32; order (rows,)
// is the order in which rows are claimed.  w is the (B, H, cap) slot
// tensor, read through its strides; the wrapper hands it slot-major (a
// slot's H weights in one 32-byte sector), copied once a call unless the
// caller's tensor is already so laid out.
//
// Design.  The TPU kernels contract one-hot matrices of a bucket on the
// matrix unit and carry an output tile across the grid; the port's first
// CUDA walk (a block per tile, a shared-memory accumulator) paid a float
// shared atomicAdd, a compare-and-swap loop on this card, per slot and
// column, and walked every slot once per 32-column chunk.  Here:
// - a group of `lpr` lanes (32, or fewer for narrow rows, several rows a
//   warp) owns a row; its lanes take the row's column vectors (VEC
//   floats, 16-byte loads where the head width is a multiple of 4; CPL
//   vectors a lane), so one pass over the row's slots serves all columns
//   and every sum lives in registers: no shared memory, no atomics on
//   out, every output written once, 0 on a row with no slot;
// - the group loads `lpr` slot ids and neighbour ids coalesced, then for
//   U slots at a time (4-8 in flight a lane) reads each slot's weight of
//   each head once (lane k of a round holds slot k / H, head k % H),
//   broadcasts it to that head's lanes with a shuffle, issues the U
//   gathers of y's rows, then the adds;
// - w read in place, (B, H, cap), puts a slot's H weights in H sectors:
//   at H > 1 the walk then took longer than the slot-major copy and the
//   walk on it together (dgl_tpu_torch/tools/perf_row_walk.py);
// - a head width that is not a multiple of 4 takes scalar loads (a
//   164-byte row at 41 columns is not 16-byte aligned); the wrapper pads
//   such rows to a multiple of 4 where that adds at most an eighth;
// - degree skew (Reddit's largest degree is 10,674 with self-loops, its
//   mean about 490): persistent warps claim rows from a global counter
//   in `order`: the hub rows (over 4x the mean degree) first, largest
//   first, so that none starts late and holds up the end; then the rest
//   by id, so that the rows in flight share buckets (the weights'
//   sectors) and, on a graph with communities, neighbours in L2.  No row
//   is split: each row's sum is taken by one group in slot order, so the
//   result is the same from run to run at every row.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the view it reads
// (slot and nbr, 8 B an edge; ptr and order, 8 B a row), 4H B an edge of
// w, y read once and out written once; 2 f32 operations an edge and
// column.  chip_smoke.py prints it at the main
// path's shapes.  The risk: the walk is by row, so a row's neighbours
// are gathered from all of y, where the tiled walk read one src tile a
// bucket; at (4, 32) on Reddit y is 233k x 512 B = 119 MB, more than the
// 50 MB L2, so gathers that miss L2 may set the time (at (1, 41) and
// (8, 8) y fits).  Indices are int32: the wrapper checks every flat size.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps per block

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

__device__ __forceinline__ void fma_into(float* acc, float w, float v) {
  acc[0] = fmaf(w, v, acc[0]);
}
__device__ __forceinline__ void fma_into(float* acc, float w, float2 v) {
  acc[0] = fmaf(w, v.x, acc[0]);
  acc[1] = fmaf(w, v.y, acc[1]);
}
__device__ __forceinline__ void fma_into(float* acc, float w, float4 v) {
  acc[0] = fmaf(w, v.x, acc[0]);
  acc[1] = fmaf(w, v.y, acc[1]);
  acc[2] = fmaf(w, v.z, acc[2]);
  acc[3] = fmaf(w, v.w, acc[3]);
}

template <typename V>
__device__ __forceinline__ V zero_vec();
template <>
__device__ __forceinline__ float zero_vec<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ float2 zero_vec<float2>() {
  return make_float2(0.f, 0.f);
}
template <>
__device__ __forceinline__ float4 zero_vec<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void store_vec(float* p, const float* a,
                                          Vec<1>) {
  p[0] = a[0];
}
__device__ __forceinline__ void store_vec(float* p, const float* a,
                                          Vec<2>) {
  *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
}
__device__ __forceinline__ void store_vec(float* p, const float* a,
                                          Vec<4>) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}

// slots in flight a lane: 8, fewer where a lane keeps many columns
template <int VEC, int CPL>
struct Unroll {
  static constexpr int kCols = VEC * CPL;
  static constexpr int value = kCols <= 4 ? 8 : kCols <= 8 ? 4 : 2;
};

template <int VEC, int CPL>
__global__ void __launch_bounds__(kWarps * 32)
row_agg_kernel(const int* __restrict__ ptr, const int* __restrict__ slot,
               const int* __restrict__ nbr, const int* __restrict__ order,
               int rows, const float* __restrict__ w, int cap, int w_bs,
               int w_hs, int w_cs, int heads, int head_cols,
               const float* __restrict__ y, int f, int lpr, int n_chunks,
               float* __restrict__ out, int* __restrict__ counter) {
  using V = typename Vec<VEC>::T;
  constexpr int U = Unroll<VEC, CPL>::value;
  const int lane = threadIdx.x & 31;
  const int groups = 32 / lpr;  // rows a warp takes at once
  const int grp = lane / lpr;
  const int li = lane - grp * lpr;
  const unsigned gmask =
      lpr == 32 ? kFull : ((1u << lpr) - 1u) << (grp * lpr);
  const int nv = f / VEC;  // column vectors a row
  const int n_items = rows * n_chunks;

  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, groups);
    base = __shfl_sync(kFull, base, 0);
    if (base >= n_items) break;
    const int item = base + grp;
    const bool has = item < n_items;
    const int r = has ? order[item / n_chunks] : 0;
    const int chunk = has ? item - (item / n_chunks) * n_chunks : 0;

    int cv[CPL];    // this lane's column vectors
    bool ok[CPL];
    int hq[CPL];    // and their heads
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      cv[q] = (chunk * CPL + q) * lpr + li;
      ok[q] = has && cv[q] < nv;
      hq[q] = ok[q] ? cv[q] * VEC / head_cols : 0;
    }
    float acc[CPL][VEC];
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[q][i] = 0.f;
    }

    const int p0 = has ? ptr[r] : 0;
    const int p1 = has ? ptr[r + 1] : 0;
    for (int pb = p0; pb < p1; pb += lpr) {  // uniform in the group
      const int n = min(lpr, p1 - pb);
      int my_nbr = 0, my_wb = 0;  // this lane's slot: neighbour, w offset
      if (li < n) {
        my_nbr = nbr[pb + li];
        const int s = slot[pb + li];
        const int b = s / cap;
        my_wb = b * w_bs + (s - b * cap) * w_cs;
      }
      for (int u0 = 0; u0 < n; u0 += U) {
        // the weights of slots u0 .. u0 + U - 1, each (slot, head) read
        // once: in the round at k0, lane li holds slot (k0 + li) / heads
        // of this step, head (k0 + li) % heads, and a slot's weights are
        // shuffled in the rounds that hold them (a test uniform in the
        // group)
        float wq[U][CPL];
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int q = 0; q < CPL; ++q) wq[u][q] = 0.f;
        }
        for (int k0 = 0; k0 < U * heads; k0 += lpr) {
          const int k = k0 + li;
          const int u = k / heads;
          const int wb = __shfl_sync(gmask, my_wb, u0 + u, lpr);
          const float wv = k < U * heads && u0 + u < n
                               ? __ldg(w + wb + (k - u * heads) * w_hs)
                               : 0.f;
#pragma unroll
          for (int uu = 0; uu < U; ++uu) {
            if (uu * heads >= k0 + lpr || uu * heads + heads <= k0) continue;
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
              const int src = uu * heads + hq[q] - k0;
              const float t = __shfl_sync(gmask, wv, src, lpr);
              if (src >= 0 && src < lpr) wq[uu][q] = t;
            }
          }
        }
        V xv[U][CPL];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int nb = __shfl_sync(gmask, my_nbr, u0 + u, lpr);
          const bool live = u0 + u < n;
          const V* yr = reinterpret_cast<const V*>(y + nb * f);
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            xv[u][q] = live && ok[q] ? __ldg(yr + cv[q]) : zero_vec<V>();
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int q = 0; q < CPL; ++q) fma_into(acc[q], wq[u][q], xv[u][q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      if (ok[q]) store_vec(out + r * f + cv[q] * VEC, acc[q], Vec<VEC>());
    }
  }
}

template <int VEC, int CPL>
cudaError_t launch_row_agg(const int* ptr, const int* slot, const int* nbr,
                           const int* order, int rows, const float* w,
                           int cap, int w_bs, int w_hs, int w_cs, int heads,
                           int head_cols, const float* y, int f, int lpr,
                           int n_chunks, float* out, int* counter, int device,
                           cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, row_agg_kernel<VEC, CPL>, kWarps * 32, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // persistent warps: as many as fit the card at once, no more than the
  // work needs
  const long long groups_needed = static_cast<long long>(rows) * n_chunks;
  const long long warps_needed = (groups_needed * lpr + 31) / 32;
  const long long blocks = std::max(1LL, std::min(
      static_cast<long long>(sms) * std::max(per_sm, 1),
      (warps_needed + kWarps - 1) / kWarps));
  row_agg_kernel<VEC, CPL><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                             stream>>>(ptr, slot, nbr, order, rows, w, cap,
                                       w_bs, w_hs, w_cs, heads, head_cols, y,
                                       f, lpr, n_chunks, out, counter);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t row_agg_by_cpl(int64_t cpl, const int* ptr, const int* slot,
                           const int* nbr, const int* order, int rows,
                           const float* w, int cap, int w_bs, int w_hs,
                           int w_cs, int heads, int head_cols,
                           const float* y, int f, int lpr, int n_chunks,
                           float* out, int* counter, int device,
                           cudaStream_t s) {
#define DGL_ROW_AGG_CASE(C_)                                                 \
  case C_:                                                                   \
    return launch_row_agg<VEC, C_>(ptr, slot, nbr, order, rows, w, cap,      \
                                   w_bs, w_hs, w_cs, heads, head_cols, y, f, \
                                   lpr, n_chunks, out, counter, device, s);
  switch (cpl) {
    DGL_ROW_AGG_CASE(1)
    DGL_ROW_AGG_CASE(2)
    DGL_ROW_AGG_CASE(4)
    DGL_ROW_AGG_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef DGL_ROW_AGG_CASE
}

}  // namespace

extern "C" {

// out (rows, f), every element written: out[r, j] = sum over slots k in
// [ptr[r], ptr[r + 1]) of w[b * w_bs + (j / head_cols) * w_hs + c * w_cs]
// * y[nbr[k], j], slot[k] = b * cap + c, summed in slot order; y
// (num_nbr, f).  vec (1, 2 or 4) floats a load,
// dividing head_cols; cpl (1, 2, 4 or 8) vectors a lane; lpr (a power of
// two up to 32) lanes a row; the f / vec column vectors in n_chunks
// chunks of lpr * cpl.  counter is one int, zeroed by the caller.
int dgl_row_agg(const void* ptr, const void* slot, const void* nbr,
                const void* order, int64_t rows, const void* w, int64_t cap,
                int64_t w_bs, int64_t w_hs, int64_t w_cs, int64_t heads,
                int64_t head_cols, const void* y,
                int64_t f, void* out, void* counter, int64_t vec,
                int64_t cpl, int64_t lpr, int64_t n_chunks, int64_t device,
                void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) != 0 ||
      head_cols % vec != 0 || cap < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DGL_ROW_AGG_ARGS                                                    \
  cpl, static_cast<const int*>(ptr), static_cast<const int*>(slot),         \
      static_cast<const int*>(nbr), static_cast<const int*>(order),         \
      static_cast<int>(rows), static_cast<const float*>(w),                 \
      static_cast<int>(cap), static_cast<int>(w_bs),                        \
      static_cast<int>(w_hs), static_cast<int>(w_cs),                       \
      static_cast<int>(heads), static_cast<int>(head_cols),                 \
      static_cast<const float*>(y),                                         \
      static_cast<int>(f), static_cast<int>(lpr),                           \
      static_cast<int>(n_chunks), static_cast<float*>(out),                 \
      static_cast<int*>(counter), static_cast<int>(device), s
  switch (vec) {
    case 1:
      return row_agg_by_cpl<1>(DGL_ROW_AGG_ARGS);
    case 2:
      return row_agg_by_cpl<2>(DGL_ROW_AGG_ARGS);
    case 4:
      return row_agg_by_cpl<4>(DGL_ROW_AGG_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
#undef DGL_ROW_AGG_ARGS
}

}  // extern "C"
