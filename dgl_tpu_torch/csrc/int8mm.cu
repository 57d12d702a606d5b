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
//      _mm_t_kernel :50):  out[n, f] = sum_i A[i, n] * z[i, f], z (k, F)
//      f32, out (n_pad, F) f32, with split_z_kernel before it.
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
// int8_cols_kernel, on the tensor cores (it replaces a walk that did the
// products as f32 FMAs, as the rows kernel does: 9.93 ms at Reddit scale,
// F = 16, against cuBLAS's bf16 product's 5.07).  Two launches:
//
//   split_z_kernel cuts z into three bf16 parts, hi + mid + lo = z
//   exactly (each part the top 16 bits of what is left, so the sum is
//   exact for every normal f32 of magnitude at least 2^-110; zero and
//   values exact in bf16 leave mid = lo = 0), and writes them in the order
//   in which mma.sync's B fragments read them: for each group of 8 NT
//   columns, each 16 rows of z (zero past k) and each 8 columns, a lane's
//   two 32-bit registers for each part (3 MB at Reddit scale, F = 16).
//
//   int8_cols_kernel<NT>: out (n_pad, F) = A^T z as an m16n8k16 bf16
//   product with f32 sums: M = the columns of A, K = its rows, N = F in
//   groups of 8 NT columns.  A block is one producer warp and four consumer
//   warps, about two blocks an SM (ctas, from the wrapper), persistent: the
//   n_pad / 16 x groups units of 16 output rows are cut into one equal run
//   a block, walked in passes of up to 512 rows of out (one group), each
//   pass over the whole of k.  The producer keeps a ring of 2 stages in
//   flight: a stage is 64 rows of A as four TMA boxes of 128 columns
//   (128-byte swizzle; rows and columns past the block read as zeros; loads
//   marked evict-first) and the stage's part fragments by one bulk copy, on
//   an mbarrier; the consumers release it on another.  A consumer warp owns
//   128 columns of A: lane (g, t) reads the 16 bytes at columns 16 g .. + 15
//   of rows 2t, 2t+1, 2t+8, 2t+9 of a 16-row step (conflict-free under the
//   swizzle) and turns each pair of bytes of two rows into one bf16x2
//   register: a byte permute puts byte b of the two rows into the low bytes
//   of the two halves; x = 0x43 << 8 | (low 7 bits) is 128 + low7 exactly,
//   y = -(128 + 128 sign) from the sign bit, and x + y is the byte's value,
//   exact in bf16 (two logic ops and one bf16x2 fma for two bytes).  Row g
//   of m-tile j is column 16 g + 2 j, row g + 8 column 16 g + 2 j + 1, so
//   one 16-byte load feeds eight m-tiles.  Each step takes 8 x NT x 3
//   mma.sync (hi, then mid, then lo into one accumulator): every output is
//   summed in one fixed order, no split of k, no atomics, so two runs give
//   the same bits.  A block writes its rows of out once.
//
// Bound on an H100 SXM: both stream A once (k * n_pad bytes: 7.64 GB for
// the Reddit graph's 32,768 hub rows, 2.28 ms at 3.35 TB/s), and that
// stream is the card's bound: the tensor cores do the products at f32
// accuracy (A is exact in bf16; x or z split into three bf16 parts, 7.3e11
// operations at F = 16, 0.74 ms at 989 TFLOP/s).  The rows kernel does the
// 2 * k * n_pad * F products as f32 FMAs instead, which alone take 3.65 ms
// at F = 16 (2.44e11 at the 67 TFLOP/s of f32 outside the tensor cores), so
// it cannot come nearer than 1.6x the bound; its loads of A are marked
// streaming (evict first) so that x, which every block reads, stays in L2.
// The columns kernel issues its mma.sync (about 60% of the tensor cores'
// wgmma rate: 1.2 ms at F = 16), its byte conversions (2 integer ops a
// byte: 0.7 ms of the integer pipes) and its shared loads under the
// stream, from 8 consumer warps an SM; it takes 3.53 ms at Reddit scale,
// F = 16 (H100 80GB HBM3 at 700 W): the stream of A, at 2.2 TB/s, sets
// it.  Offsets into A, x, z and out are 64-bit: k * n_pad is 7.64e9 at
// Reddit scale.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

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

constexpr int kColConsumers = 4;  // consumer warps of int8_cols_kernel
constexpr int kColThreads = (kColConsumers + 1) * 32;  // and the producer
constexpr int kColSpan = 128;     // columns of A a consumer warp owns
constexpr int kColRows = 64;      // rows of A a stage holds: four 16-row steps
constexpr int kColStages = 2;     // stages in the ring (two blocks an SM)
constexpr int kColUnit = 16;      // output rows a unit of a block's share
constexpr int kColPassUnits = kColConsumers * kColSpan / kColUnit;
constexpr int kBoxBytes = kColSpan * kColRows;  // one warp's box of A

// Bytes of a stage: four boxes of A, then the three parts of z for its two
// steps, rounded up so that every stage starts on 1,024 bytes (the
// swizzle's period).
template <int NT>
__host__ __device__ constexpr int col_stage_bytes() {
  return (kColConsumers * kBoxBytes + kColRows * NT * 48 + 1023) / 1024 *
         1024;
}

// Byte b of lo (low half) and of hi (high half), each an int8, as a bf16x2:
// x = 0x43 << 8 | low 7 bits is 128 + low7, y is -128 or, with the sign
// bit, -256, and x + y is the byte's value; every step is exact.
__device__ __forceinline__ uint32_t s8x2_bf16x2(uint32_t lo, uint32_t hi,
                                                int b) {
  const uint32_t t = __byte_perm(lo, hi, b | ((b + 4) << 8));
  const uint32_t x = (t & 0x007F007Fu) | 0x43004300u;
  const uint32_t y = (t & 0x00800080u) | 0xC300C300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(0x3F803F80u),
      "r"(y));
  return d;
}

// d += a b for the m16n8k16 fragments of bf16 a and b, f32 d.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The bits of v's three bf16 parts, hi + mid + lo = v: each part is the top
// 16 bits of what the parts before it leave, so each subtraction is exact.
__device__ __forceinline__ void split3(float v, uint32_t (&p)[3]) {
  const uint32_t hi = __float_as_uint(v) & 0xFFFF0000u;
  const float r1 = v - __uint_as_float(hi);
  const uint32_t mid = __float_as_uint(r1) & 0xFFFF0000u;
  const float r2 = r1 - __uint_as_float(mid);
  p[0] = hi >> 16;
  p[1] = mid >> 16;
  p[2] = __float_as_uint(r2) >> 16;
}

// zf[((grp * ksteps + s) * nt + q) * 3 + part][lane]: the two B-fragment
// registers of lane for z's rows 16 s .. + 15 and columns 8 (grp nt + q) ..
// + 7, one thread each; rows past k and columns past f are 0.
__global__ void split_z_kernel(const float* __restrict__ z, int64_t k,
                               int64_t f, int64_t ksteps, int nt,
                               int64_t total, uint2* __restrict__ zf) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= total) return;
  const int lane = static_cast<int>(i & 31);
  const int64_t frag = i >> 5;  // (grp * ksteps + s) * nt + q
  const int64_t q = frag % nt;
  const int64_t s = (frag / nt) % ksteps;
  const int64_t grp = frag / nt / ksteps;
  const int64_t col = (grp * nt + q) * 8 + (lane >> 2);
  const int64_t r0 = s * 16 + 2 * (lane & 3);
  const int64_t rows[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
  uint32_t parts[4][3];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    split3(rows[e] < k && col < f ? z[rows[e] * f + col] : 0.f, parts[e]);
  uint2* dst = zf + frag * 3 * 32 + lane;
#pragma unroll
  for (int p = 0; p < 3; ++p)
    dst[p * 32] = make_uint2(parts[0][p] | parts[1][p] << 16,
                             parts[2][p] | parts[3][p] << 16);
}


// One pass of a block: output rows c0 .. c0 + cols - 1 of group grp.
struct ColPass {
  int64_t grp, c0;
  int cols;
};

// The next pass of the block's run of units [u, hi): at most 512 rows of
// out, within one group.
__device__ __forceinline__ ColPass next_pass(int64_t& u, int64_t hi,
                                             int64_t units) {
  ColPass p;
  p.grp = u / units;
  const int64_t end = min(hi, (p.grp + 1) * units);
  const int64_t n = min(end - u, static_cast<int64_t>(kColPassUnits));
  p.c0 = (u - p.grp * units) * kColUnit;
  p.cols = static_cast<int>(n) * kColUnit;
  u += n;
  return p;
}

template <int NT>
__global__ void __launch_bounds__(kColThreads, 2)
int8_cols_kernel(const __grid_constant__ CUtensorMap amap, int64_t k,
                 int64_t n_pad, const uint2* __restrict__ zf, int64_t ksteps,
                 int64_t groups, int64_t f, float* __restrict__ out) {
  constexpr int kZBytes = kColRows * NT * 48;
  constexpr int kStage = col_stage_bytes<NT>();
  extern __shared__ uint8_t col_smem[];
  __shared__ uint64_t full[kColStages], empty[kColStages];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(col_smem) + 1023) & ~uintptr_t(1023));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kColStages; ++s) {
      tma::bar_init(&full[s], 1);
      tma::bar_init(&empty[s], kColConsumers);
    }
    tma::fence_init();
  }
  __syncthreads();
  const int64_t units = n_pad / kColUnit;
  const int64_t total = units * groups;
  int64_t u = static_cast<int64_t>(blockIdx.x) * total / gridDim.x;
  const int64_t hi = (static_cast<int64_t>(blockIdx.x) + 1) * total /
                     gridDim.x;
  uint32_t it = 0;  // stages walked so far

  if (warp == kColConsumers) {  // the producer
    if (lane != 0) return;
    const uint64_t policy = tma::evict_first();
    while (u < hi) {
      const ColPass p = next_pass(u, hi, units);
      const int boxes = (p.cols + kColSpan - 1) / kColSpan;
      for (int64_t k0 = 0; k0 < k; k0 += kColRows, ++it) {
        const int slot = it % kColStages;
        tma::wait(&empty[slot], ((it / kColStages) & 1) ^ 1);
        uint8_t* stage = ring + slot * kStage;
        tma::arrive_expect(&full[slot], boxes * kBoxBytes + kZBytes);
        for (int b = 0; b < boxes; ++b)
          tma::load_2d(stage + b * kBoxBytes, &amap,
                       static_cast<int>(p.c0 + b * kColSpan),
                       static_cast<int>(k0), &full[slot], policy);
        tma::load_1d(stage + kColConsumers * kBoxBytes,
                     zf + (p.grp * ksteps + k0 / 16) * NT * 3 * 32, kZBytes,
                     &full[slot]);
      }
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  while (u < hi) {
    const ColPass p = next_pass(u, hi, units);
    const bool live = warp * kColSpan < p.cols;
    float acc[8][NT][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < NT; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][q][e] = 0.f;
    for (int64_t k0 = 0; k0 < k; k0 += kColRows, ++it) {
      const int slot = it % kColStages;
      tma::wait(&full[slot], (it / kColStages) & 1);
      const uint8_t* stage = ring + slot * kStage;
      if (live) {
        const uint8_t* box = stage + warp * kBoxBytes;
        const uint2* zs =
            reinterpret_cast<const uint2*>(stage + kColConsumers * kBoxBytes);
#pragma unroll
        for (int ks = 0; ks < kColRows / 16; ++ks) {
          const int r0 = ks * 16 + 2 * t;
          const int rr[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
          uint4 w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[e] = *reinterpret_cast<const uint4*>(
                box + tma::swizzled<kColSpan>(rr[e] * kColSpan + g * 16));
          // m-tile j: row g is column 16 g + 2 j, row g + 8 the next one
          uint32_t a[8][4];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int b = (2 * j) & 3;
            a[j][0] = s8x2_bf16x2(word_of(w[0], j >> 1),
                                  word_of(w[1], j >> 1), b);
            a[j][1] = s8x2_bf16x2(word_of(w[0], j >> 1),
                                  word_of(w[1], j >> 1), b + 1);
            a[j][2] = s8x2_bf16x2(word_of(w[2], j >> 1),
                                  word_of(w[3], j >> 1), b);
            a[j][3] = s8x2_bf16x2(word_of(w[2], j >> 1),
                                  word_of(w[3], j >> 1), b + 1);
          }
#pragma unroll
          for (int q = 0; q < NT; ++q)
#pragma unroll
            for (int part = 0; part < 3; ++part) {
              const uint2 bq = zs[((ks * NT + q) * 3 + part) * 32 + lane];
#pragma unroll
              for (int j = 0; j < 8; ++j) mma_bf16(acc[j][q], a[j], bq);
            }
        }
      }
      __syncwarp();
      if (lane == 0) tma::arrive(&empty[slot]);
    }
    if (!live || warp * kColSpan + 16 * g >= p.cols) continue;
    const int64_t n0 = p.c0 + warp * kColSpan + 16 * g;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < NT; ++q) {
        const int64_t c = (p.grp * NT + q) * 8 + 2 * t;
        float* o = out + (n0 + 2 * j) * f + c;
        if (c < f) {
          o[0] = acc[j][q][0];
          o[f] = acc[j][q][2];
        }
        if (c + 1 < f) {
          o[1] = acc[j][q][1];
          o[f + 1] = acc[j][q][3];
        }
      }
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

template <int NT>
cudaError_t launch_cols(const void* a, int64_t k, int64_t n_pad,
                        const void* z, int64_t f, void* out, void* zf,
                        int64_t ctas, cudaStream_t stream) {
  const int64_t ksteps = (k + kColRows - 1) / kColRows * (kColRows / 16);
  const int64_t groups = (f + 8 * NT - 1) / (8 * NT);
  const int64_t total = groups * ksteps * NT * 32;
  split_z_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                   stream>>>(static_cast<const float*>(z), k, f, ksteps, NT,
                             total, static_cast<uint2*>(zf));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap amap;
  err = tma::encode_2d(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, n_pad, k,
                       n_pad, kColSpan, kColRows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const size_t smem = kColStages * col_stage_bytes<NT>() + 1024;
  err = cudaFuncSetAttribute(int8_cols_kernel<NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int8_cols_kernel<NT>
      <<<static_cast<unsigned>(ctas), kColThreads, smem, stream>>>(
          amap, k, n_pad, static_cast<const uint2*>(zf), ksteps, groups, f,
          static_cast<float*>(out));
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
  return group_of(f) == 8 ? launch_rows<8>(a, k, n_pad, x, n_x, f, out, s)
                          : launch_rows<16>(a, k, n_pad, x, n_x, f, out, s);
}

// out (n_pad, f) = A^T @ z for A (k, n_pad) int8 and z (k, f) f32; every
// element of out is written.  zf is the parts' scratch, 16-byte aligned:
// ceil(f / (8 nt)) * ceil(k / 64) * 4 * nt * 3 * 32 8-byte words, nt = 1
// for f <= 8, else 2.  ctas blocks (about two an SM) walk the output.
// A's rows must be 16-byte aligned.
int dgl_int8_cols(const void* a, int64_t k, int64_t n_pad, const void* z,
                  int64_t f, void* out, void* zf, int64_t ctas,
                  int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (k <= 0 || f <= 0 || n_pad <= 0 || n_pad % 16 || ctas <= 0 ||
      k > INT32_MAX || n_pad > INT32_MAX)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f <= 8 ? launch_cols<1>(a, k, n_pad, z, f, out, zf, ctas, s)
                : launch_cols<2>(a, k, n_pad, z, f, out, zf, ctas, s);
}

}  // extern "C"
