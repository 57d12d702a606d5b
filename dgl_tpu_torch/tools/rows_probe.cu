// The scores-and-rows probe's own kernel (dgl_tpu_torch/tools/
// perf_scores_rows.py), built by the probe alone: K12's row product as the
// port ran it before the tensor-core product of csrc/int8mm.cu
// (int8_rows_mma_kernel), kept so that the two can be timed side by side
// on one card.  The function is the same: out (k, F) = A x for the int8
// block A (k, n_pad) and x (n_x, F) f32, rows of x past n_x counting as 0.
//
// int8_rows_kernel<FG>.  A block of 16 warps owns 4 rows of A per warp and
// FG columns of the output (8 or 16: F = 16 is one group; a wider F takes
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
// FMAs.  At the end the 32 lanes' sums are added by an xor-shuffle tree,
// the same order on every lane, and written once.  The 2 k n_pad F
// products are f32 FMAs: 3.65 ms at Reddit scale, F = 16, at the f32 rate
// alone, 1.6x the 2.28 ms stream of A.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 16;    // warps per block of int8_rows_kernel
constexpr int kRowsPerWarp = 4;  // rows of A a warp of it owns
constexpr int kChunk = 512;      // columns of A per step: 16 bytes a lane

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

// Output columns a rows block handles: the narrowest of 8 and 16 that
// covers f; a wider f takes several groups over blockIdx.y.
int group_of(int64_t f) { return f <= 8 ? 8 : 16; }

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

}  // namespace

extern "C" {

// out (k, f) = A @ x for A (k, n_pad) int8 and x (n_x, f) f32, n_x <=
// n_pad, by the f32-FMA walk; every element of out is written.  A's rows
// must be 16-byte aligned (n_pad a multiple of 16, the base aligned).
int dgl_probe_int8_rows_fma(const void* a, int64_t k, int64_t n_pad,
                            const void* x, int64_t n_x, int64_t f, void* out,
                            int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (k <= 0 || f <= 0 || n_pad % 16) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return group_of(f) == 8 ? launch_rows<8>(a, k, n_pad, x, n_x, f, out, s)
                          : launch_rows<16>(a, k, n_pad, x, n_x, f, out, s);
}

}  // extern "C"
