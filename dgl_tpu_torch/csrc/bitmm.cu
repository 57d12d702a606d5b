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
// K2  bit_matmul_kernel<VEC, CPL>  replaces dgl_tpu/ops/pallas/bitmm.py
//     _bit_matmul :371 (body _bit_kernel), the route for F > 96.  Input:
//     packed, the bits of A (rows = dst), and x (num_src, F) f32.
//     Gather form: one warp per dst row reads the row's words coalesced
//     (8 a lane a step, the next step's requested before this one's
//     work), turns their set bits into a list of src ids in shared memory
//     (a warp prefix sum of popcounts gives each lane its offset), then
//     gathers the listed rows U at a time, every load issued before any
//     add, with VEC-float loads (16 bytes where F allows; CPL vectors a
//     lane, up to 512 columns a warp) into registers, and writes its
//     columns once.  The port's first K2 loaded a row after each set bit
//     in turn, so each of a row's ~490 bits waited one L2 round trip.
//
// Bound on an H100 SXM (3.35 TB/s): both kernels must stream the whole
// bitmask, K_pad * n32 * 4 bytes; the arithmetic (nnz * F adds) is far
// below the card's rate.  chip_smoke.py prints the bound for the Reddit
// graph (6,933,184,512 bytes of bits: 2.08 ms for K1 at F = 16, 2.14 ms
// for K2 at F = 128, H100 80GB HBM3 at 700 W).  Design
// against that bound: bit words are read once, coalesced, with 8 rows
// (K1) or 8 words (K2) in flight per lane, plus the next step's 8
// prefetched.  At Reddit density (0.21%) a
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
constexpr int kUnroll = 8;       // K1: rows a lane loads a step
constexpr int kStepWords = 8;    // K2: words a lane loads a step
constexpr int kBitList = 256;    // K2: src ids a warp lists at once

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

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static void add(float* a, T v) { a[0] += v; }
  __device__ static void store(float* p, const float* a) { p[0] = a[0]; }
};
template <>
struct Vec<2> {
  using T = float2;
  __device__ static T zero() { return make_float2(0.f, 0.f); }
  __device__ static void add(float* a, T v) {
    a[0] += v.x;
    a[1] += v.y;
  }
  __device__ static void store(float* p, const float* a) {
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
  }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void add(float* a, T v) {
    a[0] += v.x;
    a[1] += v.y;
    a[2] += v.z;
    a[3] += v.w;
  }
  __device__ static void store(float* p, const float* a) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  }
};

// K2 with VEC floats a load and CPL column vectors a lane: the warp's
// columns are vectors [blockIdx.y * 32 * CPL, (blockIdx.y + 1) * 32 * CPL)
// of the row.  A step takes the 32 * kStepWords words of the row that the
// lanes loaded in the step before (the next step's are requested first),
// lists the src ids of their set bits in the warp's shared buffer (each
// lane at its offset from a warp prefix sum of popcounts), then gathers
// the listed rows U at a time: U rows' loads are issued before any add.
// The walk waits on memory, not on issue: at most 64 registers a thread
// (4 blocks an SM) keep more warps in flight.
template <int VEC, int CPL>
__global__ void __launch_bounds__(kWarps * 32, 4)
bit_matmul_kernel(const uint32_t* __restrict__ packed, int64_t n32,
                  const float* __restrict__ x, int64_t num_src, int f,
                  float* __restrict__ out, int64_t num_dst) {
  using V = typename Vec<VEC>::T;
  constexpr int U = VEC * CPL <= 4 ? 8 : VEC * CPL <= 8 ? 4 : 2;
  __shared__ int lists[kWarps][kBitList];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (d >= num_dst) return;  // warp-uniform; no block-wide barrier below
  int* list = lists[warp];
  const int nv = f / VEC;
  int cv[CPL];
  bool ok[CPL];
  float acc[CPL][VEC];
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    cv[q] = (static_cast<int>(blockIdx.y) * CPL + q) * 32 + lane;
    ok[q] = cv[q] < nv;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[q][i] = 0.f;
  }

  const uint32_t* prow = packed + d * n32;
  uint32_t next[kStepWords];
#pragma unroll
  for (int u = 0; u < kStepWords; ++u) {
    const int64_t j = u * 32 + lane;
    next[u] = j < n32 ? __ldg(prow + j) : 0u;
  }
  for (int64_t j0 = 0; j0 < n32; j0 += 32 * kStepWords) {
    uint32_t word[kStepWords];
    int c = 0;  // this lane's set bits in the step
#pragma unroll
    for (int u = 0; u < kStepWords; ++u) {
      word[u] = next[u];
      c += __popc(word[u]);
      const int64_t j = j0 + 32 * kStepWords + u * 32 + lane;
      next[u] = j < n32 ? __ldg(prow + j) : 0u;
    }
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    const int first = incl - c;  // this lane's offset in the step's list
    // a row denser than kBitList bits a step is listed in pieces
    for (int p0 = 0; p0 < total; p0 += kBitList) {
      const int lim = p0 + kBitList;
      int idx = first;
#pragma unroll
      for (int u = 0; u < kStepWords; ++u) {
        uint32_t bits = word[u];
        const int pc = __popc(bits);
        if (idx + pc <= p0 || idx >= lim) {  // none of this word's bits
          idx += pc;
          continue;
        }
        const int64_t j = j0 + u * 32 + lane;
        while (bits) {
          const int b = __ffs(static_cast<int>(bits)) - 1;
          bits &= bits - 1u;
          if (idx >= p0 && idx < lim) {
            const int64_t s = static_cast<int64_t>(b) * n32 + j;
            list[idx - p0] = s < num_src ? static_cast<int>(s) : -1;
          }
          ++idx;
        }
      }
      __syncwarp();
      const int n = min(kBitList, total - p0);
      for (int i0 = 0; i0 < n; i0 += U) {
        V xv[U][CPL];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int s = i0 + u < n ? list[i0 + u] : -1;
          const V* xr = reinterpret_cast<const V*>(
              x + static_cast<int64_t>(s < 0 ? 0 : s) * f);
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            xv[u][q] = s >= 0 && ok[q] ? __ldg(xr + cv[q]) : Vec<VEC>::zero();
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int q = 0; q < CPL; ++q) Vec<VEC>::add(acc[q], xv[u][q]);
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    if (ok[q]) Vec<VEC>::store(out + d * f + cv[q] * VEC, acc[q]);
  }
}

template <int VEC, int CPL>
cudaError_t launch_k2(const void* packed, int64_t n32, const void* x,
                      int64_t num_src, int64_t f, void* out, int64_t num_dst,
                      cudaStream_t stream) {
  const int64_t per_block = 32 * CPL;  // column vectors a warp
  const dim3 grid(static_cast<unsigned>((num_dst + kWarps - 1) / kWarps),
                  static_cast<unsigned>((f / VEC + per_block - 1) /
                                        per_block));
  bit_matmul_kernel<VEC, CPL><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const uint32_t*>(packed), n32,
      static_cast<const float*>(x), num_src, static_cast<int>(f),
      static_cast<float*>(out), num_dst);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t k2_by_cpl(int64_t cpl, const void* packed, int64_t n32,
                      const void* x, int64_t num_src, int64_t f, void* out,
                      int64_t num_dst, cudaStream_t s) {
  switch (cpl) {
    case 1:
      return launch_k2<VEC, 1>(packed, n32, x, num_src, f, out, num_dst, s);
    case 2:
      return launch_k2<VEC, 2>(packed, n32, x, num_src, f, out, num_dst, s);
    case 4:
      return launch_k2<VEC, 4>(packed, n32, x, num_src, f, out, num_dst, s);
    default:
      return cudaErrorInvalidValue;
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
// every element of out is written.  vec (1, 2 or 4) floats a load,
// dividing f, with x and out aligned to it; cpl (1, 2 or 4) vectors a
// lane.  Grid: (ceil(num_dst / 8), ceil(f / vec / (32 * cpl))) blocks of
// 8 warps, a warp a dst row.
int dgl_bit_matmul(const void* packed, int64_t n32, const void* x,
                   int64_t num_src, int64_t f, void* out, int64_t num_dst,
                   int64_t vec, int64_t cpl, int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (vec < 1 || f % vec != 0 || num_src > INT32_MAX)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 1:
      return k2_by_cpl<1>(cpl, packed, n32, x, num_src, f, out, num_dst, s);
    case 2:
      return k2_by_cpl<2>(cpl, packed, n32, x, num_src, f, out, num_dst, s);
    case 4:
      return k2_by_cpl<4>(cpl, packed, n32, x, num_src, f, out, num_dst, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
