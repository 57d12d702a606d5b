// Bit-packed dense SpMM on Hopper: out = A @ x with the whole boolean
// adjacency A stored at 1 bit per entry.
//
// Packing (plane-major, shared with dgl_tpu/ops/pallas/bitmm.py:19-27):
// with n32 = N_pad / 32 words per row,
//
//     packed[k][j] bit b   <->   column b * n32 + j   of row k.
//
// Bit 31 is the int32 sign bit, so every word is read as uint32_t and
// every shift is unsigned.
//
// Two kernels, each behind a plain C function that launches on the
// caller's stream, allocates nothing and returns cudaGetLastError():
//
// K1  bit_matmul_t_kernel  replaces dgl_tpu/ops/pallas/bitmm.py
//     _bit_matmul_t (body _bit_kernel_t).  Input: packed_t, the bits of
//     A^T (rows = src, bit planes = dst), and x (rows, F) f32 with
//     F <= 96.  Scatter form.  A block owns a slab of w words, i.e. the
//     32 * w dst nodes {b * n32 + j0 + jj}, and keeps their f32 sums in
//     shared memory ([32][w][F]); its warps walk a chunk of src rows,
//     one row per warp step, one word per lane, and for each set bit
//     the whole warp adds x[src, :] into the slab (lane = feature
//     column).  At the end the slab is added into out with atomicAdd,
//     so chunks of rows may run in parallel.
//
// K2  bit_matmul_kernel  replaces dgl_tpu/ops/pallas/bitmm.py
//     _bit_matmul (body _bit_kernel), the route for F > 96.  Input:
//     packed, the bits of A (rows = dst), and x (num_src, F) f32.
//     Gather form: one warp per dst row reads the row's words coalesced
//     (one per lane); for each set bit the warp adds x[src, c0:c0+128]
//     into registers (4 columns per lane) and writes its columns once.
//
// Bound on an H100 SXM (3.35 TB/s): both kernels must stream the whole
// bitmask, K_pad * n32 * 4 bytes; the arithmetic (nnz * F adds) is far
// below the card's rate.  chip_smoke.py prints the bound for the Reddit
// graph (6,933,184,512 bytes of bits: 2.08 ms for K1 at F = 16, 2.14 ms
// for K2 at F = 128, H100 80GB HBM3 at 700 W).  Design
// against that bound: bit words are read once, coalesced, with 8 rows
// (K1, plus the next step's 8 prefetched) or 8 words (K2) in flight per
// lane.  At Reddit density (0.21%) a
// word holds ~0.07 set bits, so the work per bit (K1: one shared-memory
// atomic per feature column; K2: a gather of the source row from L2 or
// memory) is the other cost; neither kernel uses the tensor cores,
// since a 0/1 matrix at this density gives them nothing dense to do.
// The C function and launch parameters are chosen by
// dgl_tpu_torch/ops/kernels/bitmm.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;        // warps per block (both kernels)
constexpr int kUnroll = 8;       // loads each lane keeps in flight
constexpr int kColsPerLane = 4;  // K2: 128-column tile per warp

// K1 with kCols = ceil(f / 32) feature columns per lane (1..3).  Each warp
// step takes kUnroll rows: their words were loaded during the previous
// step, the next step's words are requested before this step's work, and
// the x rows of all live rows are requested together, so a step waits on
// one memory round trip instead of one per row.
template <int kCols>
__global__ void __launch_bounds__(kWarps * 32)
bit_matmul_t_kernel(const uint32_t* __restrict__ packed_t, int64_t n32,
                    const float* __restrict__ x, int64_t rows, int f,
                    float* __restrict__ out, int64_t num_dst, int w,
                    int64_t rows_per_chunk) {
  extern __shared__ float acc[];  // [32 planes][w words][f columns]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * w;
  const int64_t r_lo = static_cast<int64_t>(blockIdx.y) * rows_per_chunk;
  const int64_t r_end = r_lo + rows_per_chunk;
  const int64_t r_hi = r_end < rows ? r_end : rows;
  const int n_acc = 32 * w * f;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();

  const bool lane_reads = lane < w && j0 + lane < n32;
  constexpr int64_t kStep = kWarps * kUnroll;
  uint32_t next[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t s = r_lo + warp + static_cast<int64_t>(u) * kWarps;
    next[u] = (lane_reads && s < r_hi) ? __ldg(packed_t + s * n32 + j0 + lane)
                                       : 0u;
  }
  for (int64_t s0 = r_lo + warp; s0 < r_hi; s0 += kStep) {
    uint32_t word[kUnroll];
    unsigned live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      word[u] = next[u];
      const int64_t s = s0 + kStep + static_cast<int64_t>(u) * kWarps;
      next[u] = (lane_reads && s < r_hi) ? __ldg(packed_t + s * n32 + j0 + lane)
                                         : 0u;
    }
    float xv[kUnroll][kCols];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      live[u] = __ballot_sync(kFull, word[u] != 0u);
      // a live row lies below r_hi: its word was read
      const float* xr = x + (s0 + static_cast<int64_t>(u) * kWarps) * f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        xv[u][c] = (live[u] != 0u && col < f) ? __ldg(xr + col) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      while (live[u]) {  // warp-uniform
        const int l = __ffs(live[u]) - 1;
        live[u] &= live[u] - 1;
        uint32_t bits = __shfl_sync(kFull, word[u], l);
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          float* a = acc + (b * w + l) * f;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int col = lane + 32 * c;
            if (col < f) atomicAdd(a + col, xv[u][c]);
          }
        }
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
    const float v = acc[i];
    if (v == 0.f) continue;
    const int b = i / (w * f);
    const int rem = i - b * w * f;
    const int jj = rem / f;
    const int col = rem - jj * f;
    const int64_t d = static_cast<int64_t>(b) * n32 + j0 + jj;
    if (d < num_dst) atomicAdd(out + d * f + col, v);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
bit_matmul_kernel(const uint32_t* __restrict__ packed, int64_t n32,
                  const float* __restrict__ x, int64_t num_src, int f,
                  float* __restrict__ out, int64_t num_dst) {
  const int lane = threadIdx.x & 31;
  const int64_t d =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (d >= num_dst) return;  // warp-uniform
  const int c0 = blockIdx.y * 32 * kColsPerLane;
  float acc[kColsPerLane];
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) acc[c] = 0.f;

  const uint32_t* prow = packed + d * n32;
  for (int64_t j0 = 0; j0 < n32; j0 += 32 * kUnroll) {
    uint32_t word[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u * 32 + lane;
      word[u] = j < n32 ? __ldg(prow + j) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      unsigned live = __ballot_sync(kFull, word[u] != 0u);
      while (live) {
        const int l = __ffs(live) - 1;
        live &= live - 1;
        uint32_t bits = __shfl_sync(kFull, word[u], l);
        const int64_t j = j0 + u * 32 + l;
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          const int64_t s = static_cast<int64_t>(b) * n32 + j;
          if (s >= num_src) continue;  // warp-uniform; padding bits are 0
          const float* xr = x + s * f;
#pragma unroll
          for (int c = 0; c < kColsPerLane; ++c) {
            const int col = c0 + lane + 32 * c;
            if (col < f) acc[c] += __ldg(xr + col);
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kColsPerLane; ++c) {
    const int col = c0 + lane + 32 * c;
    if (col < f) out[d * f + col] = acc[c];
  }
}

// K1: out (num_dst, f) += A @ x from packed_t (rows, n32) words, f <= 96;
// out must be zeroed by the caller.  Grid: (ceil(n32 / w), chunks) blocks.
template <int kCols>
cudaError_t launch_t(const void* packed_t, int64_t n32, const void* x,
                     int64_t rows, int64_t f, void* out, int64_t num_dst,
                     int64_t w, int64_t rows_per_chunk, int64_t chunks,
                     cudaStream_t stream) {
  const size_t smem = sizeof(float) * 32 * w * f;
  cudaError_t err = cudaFuncSetAttribute(
      bit_matmul_t_kernel<kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((n32 + w - 1) / w),
                  static_cast<unsigned>(chunks));
  bit_matmul_t_kernel<kCols><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const uint32_t*>(packed_t), n32,
      static_cast<const float*>(x), rows, static_cast<int>(f),
      static_cast<float*>(out), num_dst, static_cast<int>(w),
      rows_per_chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int dgl_bit_matmul_t(const void* packed_t, int64_t n32, const void* x,
                     int64_t rows, int64_t f, void* out, int64_t num_dst,
                     int64_t w, int64_t rows_per_chunk, int64_t chunks,
                     int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((f + 31) / 32) {
    case 1:
      return launch_t<1>(packed_t, n32, x, rows, f, out, num_dst, w,
                         rows_per_chunk, chunks, s);
    case 2:
      return launch_t<2>(packed_t, n32, x, rows, f, out, num_dst, w,
                         rows_per_chunk, chunks, s);
    case 3:
      return launch_t<3>(packed_t, n32, x, rows, f, out, num_dst, w,
                         rows_per_chunk, chunks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// K2: out (num_dst, f) = A @ x from packed (>= num_dst rows, n32) words;
// every element of out is written.  Grid: (ceil(num_dst / 8),
// ceil(f / 128)) blocks of 8 warps.
int dgl_bit_matmul(const void* packed, int64_t n32, const void* x,
                   int64_t num_src, int64_t f, void* out, int64_t num_dst,
                   int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const int tile = 32 * kColsPerLane;
  const dim3 grid(static_cast<unsigned>((num_dst + kWarps - 1) / kWarps),
                  static_cast<unsigned>((f + tile - 1) / tile));
  bit_matmul_kernel<<<grid, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(packed), n32,
      static_cast<const float*>(x), num_src, static_cast<int>(f),
      static_cast<float*>(out), num_dst);
  return cudaGetLastError();
}

}  // extern "C"
