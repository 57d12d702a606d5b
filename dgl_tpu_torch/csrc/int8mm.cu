// Int8 hub-block matmul on Hopper (K12): the dense half of the hybrid
// SpMM (dgl_tpu_torch/ops/kernels/hybrid.py).
//
// A is the hybrid format's (k, n_pad) int8 block, row-major: row i holds
// the edge multiplicities (0..127) from every src node into hub dst i, and
// n_pad is a multiple of 16.  Two kernels, each behind a plain C function
// that launches on the caller's stream, allocates nothing and returns
// cudaGetLastError():
//
// K12  int8_rows_kernel  replaces dgl_tpu/ops/pallas/int8mm.py int8_matmul
//      (body _mm_kernel):  out[i, f] = sum_n A[i, n] * x[n, f], x (n_x, F)
//      f32 with n_x <= n_pad (rows past n_x count as 0), out (k, F) f32.
// K12  int8_cols_kernel  replaces int8_matmul(contract_rows=True) (body
//      _mm_t_kernel):  out[n, f] = sum_i A[i, n] * z[i, f], z (k, F) f32,
//      out (n_pad, F) f32.
//
// The TPU kernel pads A to (1024, 2048) blocks and F to 128 lanes, turns
// each int8 block into bf16 in VMEM and feeds the matrix unit, carrying
// the output block across the sequential contraction axis of its grid.
// None of that carries over.  Here a block owns its outputs outright and
// loops over the contraction axis itself, so no atomics are used and each
// output element is summed in one fixed order: the result is the same in
// every run, and exact when every partial sum is (dyadic inputs).  A is
// not padded; the ragged edges are masked.  x and z are taken in f32 (the
// TPU kernel rounds them to bf16).
//
// int8_rows_kernel.  A block of 16 warps owns 4 rows of A per warp and FG
// columns of the output (8 or 16: F = 16 is one group; a wider F takes
// ceil(F / 16) groups over blockIdx.y, each streaming A again).  It walks
// n in chunks of 512 columns: each lane loads the 16 bytes n0 + 16 lane
// .. + 15 of each of its warp's rows with one 16-byte load (a warp reads
// 512 contiguous bytes of a row), and the next chunk's bytes are
// requested before this chunk's arithmetic.  The chunk's x rows (512 x FG
// f32) are staged in shared memory in the order in which the lanes read
// them: row n0 + 16 lane + j at slot 32 j + lane, with a row stride of
// FG + 4 floats, so the 8 lanes of a quarter warp reading float4s hit
// distinct banks.  Each byte is turned into an f32 with a byte permute and
// one subtract (exact for every int8), and each lane keeps 4 x FG f32
// partial sums in registers: one float4 of x from shared memory feeds 16
// FMAs, so shared memory and the FMA pipe run at about the same rate
// (groups of 32 columns at 2 rows a warp halve that ratio, and ran slower
// per column).  At the end the 32 lanes' sums are added by an xor-shuffle
// tree, the same order on every lane, and written once.
//
// int8_cols_kernel.  A block of 4 warps owns 512 columns of A (a lane owns
// 4 adjacent columns, read as one 4-byte word, so a warp reads 128
// contiguous bytes of a row) and FG columns of z.  It walks all k rows: z's
// rows are staged in shared memory 256 at a time, every lane of a warp
// reads the same z row (a broadcast), and a lane requests the next 16
// rows' words before it works on the current 16.  F over 32 takes
// ceil(F / 32) groups of 32 columns over blockIdx.y.  Each lane keeps
// 4 x FG sums in registers and writes them once.
//
// Bound on an H100 SXM: both stream A once (k * n_pad bytes: 7.64 GB for
// the Reddit graph's 32,768 hub rows, 2.28 ms at 3.35 TB/s), and that
// stream is the card's bound: the tensor cores could do the products at
// f32 accuracy (A is exact in bf16; x split into three bf16 parts, 7.3e11
// operations at F = 16, 0.74 ms at 989 TFLOP/s).  This version does the
// 2 * k * n_pad * F products as f32 FMAs instead, which alone take
// 3.65 ms at F = 16 (2.44e11 at the 67 TFLOP/s of f32 outside the tensor
// cores), so it cannot come nearer than 1.6x the bound.  Loads of A are
// marked streaming (evict first) so that x and z, which every block
// reads, stay in L2.  The tensor-core version (int8 -> bf16 mma, as the
// TPU kernel feeds its matrix unit) is work for a later version.  Offsets
// into A, x, z and out are 64-bit: k * n_pad is 7.64e9 at Reddit scale.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 16;    // warps per block of int8_rows_kernel
constexpr int kRowsPerWarp = 4;  // rows of A a warp of it owns
constexpr int kChunk = 512;      // columns of A per step: 16 bytes a lane
constexpr int kColWarps = 4;     // warps per block of int8_cols_kernel
constexpr int kColSpan = 128;    // columns of A per warp: 4 bytes a lane
constexpr int kStage = 256;      // rows of z staged at a time
constexpr int kColUnroll = 16;   // rows of A a lane keeps in flight

// Byte b of w as a signed int8, in f32: the bits 0x4B0000uu with
// uu = byte + 128 are the float 2^23 + uu, and subtracting 2^23 + 128
// leaves the byte's value, exactly.
__device__ __forceinline__ float s8_to_f32(uint32_t w, int b) {
  const uint32_t bits =
      __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540u | b);
  return __uint_as_float(bits) - 8388736.f;
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The 16 bytes at column n of rows row0 .. row0 + R - 1 (0 past the
// block's edges).
template <int R>
__device__ __forceinline__ void load_rows(const int8_t* __restrict__ a,
                                          int64_t k, int64_t n_pad,
                                          int64_t row0, int64_t n,
                                          uint4 (&w)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    w[r] = row0 + r < k && n < n_pad
               ? __ldcs(reinterpret_cast<const uint4*>(
                     a + (row0 + r) * n_pad + n))
               : make_uint4(0u, 0u, 0u, 0u);
}

template <int FG>
__global__ void __launch_bounds__(kRowWarps * 32, 1)
int8_rows_kernel(const int8_t* __restrict__ a, int64_t k, int64_t n_pad,
                 const float* __restrict__ x, int64_t n_x, int64_t f,
                 float* __restrict__ out) {
  constexpr int R = kRowsPerWarp;
  constexpr int kStride = FG + 4;   // an odd count of float4s
  extern __shared__ float4 smem_rows[];
  float* xs = reinterpret_cast<float*>(smem_rows);   // [kChunk][kStride]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 =
      (static_cast<int64_t>(blockIdx.x) * kRowWarps + warp) * R;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * FG;

  float acc[R][FG];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < FG; ++c) acc[r][c] = 0.f;

  uint4 cur[R];
  load_rows<R>(a, k, n_pad, row0, 16 * lane, cur);
  for (int64_t n0 = 0; n0 < n_pad; n0 += kChunk) {
    __syncthreads();   // every warp is done with the previous chunk
    for (int i = threadIdx.x; i < kChunk * FG; i += kRowWarps * 32) {
      const int nl = i / FG, c = i % FG;
      const int64_t n = n0 + nl, col = col0 + c;
      xs[((nl & 15) * 32 + (nl >> 4)) * kStride + c] =
          n < n_x && col < f ? x[n * f + col] : 0.f;
    }
    __syncthreads();
    uint4 nxt[R];
    load_rows<R>(a, k, n_pad, row0, n0 + kChunk + 16 * lane, nxt);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float av[R];
#pragma unroll
      for (int r = 0; r < R; ++r) av[r] = s8_to_f32(word_of(cur[r], j >> 2),
                                                    j & 3);
      const float4* xr =
          reinterpret_cast<const float4*>(xs + (j * 32 + lane) * kStride);
#pragma unroll
      for (int c4 = 0; c4 < FG / 4; ++c4) {
        const float4 v = xr[c4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          acc[r][4 * c4 + 0] = fmaf(av[r], v.x, acc[r][4 * c4 + 0]);
          acc[r][4 * c4 + 1] = fmaf(av[r], v.y, acc[r][4 * c4 + 1]);
          acc[r][4 * c4 + 2] = fmaf(av[r], v.z, acc[r][4 * c4 + 2]);
          acc[r][4 * c4 + 3] = fmaf(av[r], v.w, acc[r][4 * c4 + 3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) cur[r] = nxt[r];
  }

  // add the lanes' sums; the xor tree leaves the same sum on every lane
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < FG; ++c) {
      float v = acc[r][c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(kFull, v, off);
      acc[r][c] = v;
    }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row0 + r >= k) continue;
#pragma unroll
    for (int c = 0; c < FG; ++c)
      if (c == lane && col0 + c < f) out[(row0 + r) * f + col0 + c] =
          acc[r][c];
  }
}

// The 4 bytes at column n of rows k0 + kk .. + kColUnroll - 1 of the
// stage (0 past its `rows` rows, or for a lane past the block's columns).
__device__ __forceinline__ void load_words(const int8_t* __restrict__ a,
                                           int64_t n_pad, int64_t k0, int kk,
                                           int rows, int64_t n, bool live,
                                           uint32_t (&w)[kColUnroll]) {
#pragma unroll
  for (int u = 0; u < kColUnroll; ++u)
    w[u] = live && kk + u < rows
               ? __ldcs(reinterpret_cast<const unsigned int*>(
                     a + (k0 + kk + u) * n_pad + n))
               : 0u;
}

template <int FG>
__global__ void __launch_bounds__(kColWarps * 32)
int8_cols_kernel(const int8_t* __restrict__ a, int64_t k, int64_t n_pad,
                 const float* __restrict__ z, int64_t f,
                 float* __restrict__ out) {
  __shared__ float4 zs4[kStage * FG / 4];
  float* zs = reinterpret_cast<float*>(zs4);   // [kStage][FG]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t n =
      (static_cast<int64_t>(blockIdx.x) * kColWarps + warp) * kColSpan +
      4 * lane;
  const bool live = n < n_pad;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * FG;

  float acc[4][FG];
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int c = 0; c < FG; ++c) acc[b][c] = 0.f;

  for (int64_t k0 = 0; k0 < k; k0 += kStage) {
    __syncthreads();   // every warp is done with the previous stage
    for (int i = threadIdx.x; i < kStage * FG; i += kColWarps * 32) {
      const int64_t row = k0 + i / FG, col = col0 + i % FG;
      zs[i] = row < k && col < f ? z[row * f + col] : 0.f;
    }
    __syncthreads();
    const int rows = static_cast<int>(k - k0 < kStage ? k - k0 : kStage);
    uint32_t w[kColUnroll];
    load_words(a, n_pad, k0, 0, rows, n, live, w);
    for (int kk = 0; kk < rows; kk += kColUnroll) {
      uint32_t nxt[kColUnroll];
      load_words(a, n_pad, k0, kk + kColUnroll, rows, n, live, nxt);
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u) {
        float av[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) av[b] = s8_to_f32(w[u], b);
        // rows past `rows` are staged as 0 and their words are 0
        const float4* zr =
            reinterpret_cast<const float4*>(zs + (kk + u) * FG);
#pragma unroll
        for (int c4 = 0; c4 < FG / 4; ++c4) {
          const float4 v = zr[c4];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            acc[b][4 * c4 + 0] = fmaf(av[b], v.x, acc[b][4 * c4 + 0]);
            acc[b][4 * c4 + 1] = fmaf(av[b], v.y, acc[b][4 * c4 + 1]);
            acc[b][4 * c4 + 2] = fmaf(av[b], v.z, acc[b][4 * c4 + 2]);
            acc[b][4 * c4 + 3] = fmaf(av[b], v.w, acc[b][4 * c4 + 3]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kColUnroll; ++u) w[u] = nxt[u];
    }
  }
  if (!live) return;
#pragma unroll
  for (int b = 0; b < 4; ++b)
#pragma unroll
    for (int c = 0; c < FG; ++c)
      if (col0 + c < f) out[(n + b) * f + col0 + c] = acc[b][c];
}

// Columns of the output a block handles: the narrowest of 8, 16 (and 32
// for the columns kernel) that covers f; a wider f takes several groups
// over blockIdx.y.
int group_of(int64_t f) { return f <= 8 ? 8 : f <= 16 ? 16 : 32; }

template <int FG>
cudaError_t launch_rows(const void* a, int64_t k, int64_t n_pad,
                        const void* x, int64_t n_x, int64_t f, void* out,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * kChunk * (FG + 4);
  cudaError_t err = cudaFuncSetAttribute(
      int8_rows_kernel<FG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int rows = kRowWarps * kRowsPerWarp;
  const dim3 grid(static_cast<unsigned>((k + rows - 1) / rows),
                  static_cast<unsigned>((f + FG - 1) / FG));
  int8_rows_kernel<FG><<<grid, kRowWarps * 32, smem, stream>>>(
      static_cast<const int8_t*>(a), k, n_pad, static_cast<const float*>(x),
      n_x, f, static_cast<float*>(out));
  return cudaGetLastError();
}

template <int FG>
cudaError_t launch_cols(const void* a, int64_t k, int64_t n_pad,
                        const void* z, int64_t f, void* out,
                        cudaStream_t stream) {
  const int64_t span = kColWarps * kColSpan;
  const dim3 grid(static_cast<unsigned>((n_pad + span - 1) / span),
                  static_cast<unsigned>((f + FG - 1) / FG));
  int8_cols_kernel<FG><<<grid, kColWarps * 32, 0, stream>>>(
      static_cast<const int8_t*>(a), k, n_pad, static_cast<const float*>(z),
      f, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (k, f) = A @ x for A (k, n_pad) int8 and x (n_x, f) f32, n_x <=
// n_pad; every element of out is written.  A's rows must be 16-byte
// aligned (n_pad a multiple of 16, the base aligned).
int dgl_int8_rows(const void* a, int64_t k, int64_t n_pad, const void* x,
                  int64_t n_x, int64_t f, void* out, int64_t device,
                  void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (k <= 0 || f <= 0 || n_pad % 16) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f <= 8 ? launch_rows<8>(a, k, n_pad, x, n_x, f, out, s)
                : launch_rows<16>(a, k, n_pad, x, n_x, f, out, s);
}

// out (n_pad, f) = A^T @ z for A (k, n_pad) int8 and z (k, f) f32; every
// element of out is written.
int dgl_int8_cols(const void* a, int64_t k, int64_t n_pad, const void* z,
                  int64_t f, void* out, int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (n_pad <= 0 || f <= 0 || n_pad % 16) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group_of(f)) {
    case 8:
      return launch_cols<8>(a, k, n_pad, z, f, out, s);
    case 16:
      return launch_cols<16>(a, k, n_pad, z, f, out, s);
    default:
      return launch_cols<32>(a, k, n_pad, z, f, out, s);
  }
}

}  // extern "C"
