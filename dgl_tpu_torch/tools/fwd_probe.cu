// The forward walks' probe's own kernels (dgl_tpu_torch/tools/
// perf_fwd_walks.py), built by the probe alone: K5's two forwards as the
// port ran them before the listed walk by dst of csrc/bitgat.cu
// (bitgat_fwd_list_kernel), kept so that the three can be timed side by
// side on one card.  The function each computes is the listed walk's (see
// the head of csrc/bitgat.cu).
//
// bitgat_fwd_warp_kernel: one warp a dst row of packed (rows = dst).  The
// warp streams the row's words coalesced (one per lane, 8 in flight), skips
// zero words and walks the set bits with __ffs, one after another; a lane
// owns the feature columns f = lane + 32 k (k < 4, so H * D <= 128) and
// the heads of those columns.  For each set bit s it gathers z[s] and
// el[s] and adds p keep z[s, :] into registers; each bit's gathers wait on
// the previous bit's arithmetic.  out and l are written once.
//
// bitgat_fwd_t_kernel: the same serial walk over the bits of A^T (rows =
// src, bit columns = dst), without dropout, in scatter form: one warp per
// src row keeps z[s] and el[s] in registers, a lane the four columns
// 4 lane .. 4 lane + 3 of the flattened (H, D) row.  Per set bit d each
// lane reads er[d] of its columns' heads, forms p and adds p z[s] into row
// d of a zeroed sum buffer with one 16-byte red.global.add.v4.f32 (rows
// padded to a multiple of 4 floats); the lane that starts a head adds p
// into l[d].  The adds are reductions in L2, in an order that changes from
// run to run.  bitgat_fwd_t_finish_kernel then writes
// out = sum / max(l, 1e-20).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;   // warps per block
constexpr int kUnroll = 8;  // words each lane keeps in flight
constexpr uint32_t kC1 = 0x9E3779B1u;
constexpr uint32_t kC2 = 0x85EBCA6Bu;
__constant__ uint32_t kHeadMults[8] = {
    0xC2B2AE35u, 0x27D4EB2Fu, 0x165667B1u, 0x9E3779B9u,
    0x85EBCA77u, 0xC2B2AE3Du, 0x2545F491u, 0x94D049BBu};

// The feature columns a lane owns: column f = lane + 32 k of the
// flattened (H, D) row, its head f / dim, and whether it starts its head
// (the one lane that writes the head's scalars).
template <int kCols>
struct Columns {
  int f[kCols];
  int head[kCols];  // -1 past H * D
  bool first[kCols];
  uint32_t mult[kCols];

  __device__ Columns(int lane, int heads, int dim, bool drop) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      f[k] = lane + 32 * k;
      const bool valid = f[k] < heads * dim;
      head[k] = valid ? f[k] / dim : -1;
      first[k] = valid && f[k] % dim == 0;
      mult[k] = (drop && valid) ? kHeadMults[head[k] & 7] : 0u;
    }
  }
};

__device__ __forceinline__ float lrelu_exp(float raw, float slope) {
  return expf(fmaxf(raw, slope * raw));
}

__device__ __forceinline__ bool keep_bit(uint32_t x0, uint32_t mult,
                                         uint32_t thresh) {
  return ((x0 * mult) >> 17) < thresh;
}

__device__ __forceinline__ void red_add_v4(float* a, float x, float y,
                                           float z, float w) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(a),
               "f"(x), "f"(y), "f"(z), "f"(w)
               : "memory");
}

template <int kCols, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
bitgat_fwd_warp_kernel(const uint32_t* __restrict__ packed, int64_t n32,
                       int64_t num_src, int64_t num_dst,
                       const float* __restrict__ el,
                       const float* __restrict__ er,
                       const float* __restrict__ z, int heads, int dim,
                       float slope, uint32_t thresh,
                       const int64_t* __restrict__ seed,
                       float* __restrict__ out, float* __restrict__ l) {
  const int lane = threadIdx.x & 31;
  const int64_t d =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (d >= num_dst) return;  // warp-uniform
  const int hd = heads * dim;
  const Columns<kCols> c(lane, heads, dim, kDrop);
  float erv[kCols], acc[kCols], lsum[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    erv[k] = c.head[k] >= 0 ? __ldg(er + d * heads + c.head[k]) : 0.f;
    acc[k] = 0.f;
    lsum[k] = 0.f;
  }
  const uint32_t dpart =
      kDrop ? (static_cast<uint32_t>(d) * kC2) ^ static_cast<uint32_t>(*seed)
            : 0u;

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
      while (live) {  // warp-uniform
        const int src_lane = __ffs(live) - 1;
        live &= live - 1;
        uint32_t bits = __shfl_sync(kFull, word[u], src_lane);
        const int64_t j = j0 + u * 32 + src_lane;
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          const int64_t s = static_cast<int64_t>(b) * n32 + j;
          if (s >= num_src) continue;  // warp-uniform; padding bits are 0
          const uint32_t x0 =
              kDrop ? (static_cast<uint32_t>(s) * kC1) ^ dpart : 0u;
          float zv[kCols], elv[kCols];
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const bool valid = c.head[k] >= 0;
            zv[k] = valid ? __ldg(z + s * hd + c.f[k]) : 0.f;
            elv[k] = valid ? __ldg(el + s * heads + c.head[k]) : 0.f;
          }
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            // this branch, though never taken at H * D = 128, made the
            // kernel 25% faster there on the H100 (PERF.md, K5)
            if (c.head[k] < 0) continue;
            const float p = lrelu_exp(elv[k] + erv[k], slope);
            lsum[k] += p;
            if (!kDrop || keep_bit(x0, c.mult[k], thresh))
              acc[k] += p * zv[k];
          }
        }
      }
    }
  }
  const float kp = kDrop ? static_cast<float>(thresh) / 32768.f : 1.f;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (c.head[k] < 0) continue;
    out[d * hd + c.f[k]] = acc[k] / (fmaxf(lsum[k], 1e-20f) * kp);
    if (c.first[k]) l[d * heads + c.head[k]] = lsum[k];
  }
}

// bitgat_fwd_t's sums: acc (zeroed, rows of ostride floats, ostride a
// multiple of 4) += p z[s], l (zeroed) += p for every set bit.
__global__ void __launch_bounds__(kWarps * 32)
bitgat_fwd_t_kernel(const uint32_t* __restrict__ packed_t, int64_t n32,
                    int64_t num_src, int64_t num_dst,
                    const float* __restrict__ el, const float* __restrict__ er,
                    const float* __restrict__ z, int heads, int dim,
                    float slope, int ostride, float* __restrict__ acc,
                    float* __restrict__ l) {
  const int lane = threadIdx.x & 31;
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (s >= num_src) return;  // warp-uniform
  const int hd = heads * dim;
  const bool lane_adds = 4 * lane < hd;
  float zv[4], elv[4];
  int head[4];
  bool valid[4], first[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int f = 4 * lane + k;
    valid[k] = f < hd;
    head[k] = valid[k] ? f / dim : 0;
    first[k] = valid[k] && f % dim == 0;
    zv[k] = valid[k] ? __ldg(z + s * hd + f) : 0.f;
    elv[k] = valid[k] ? __ldg(el + s * heads + head[k]) : 0.f;
  }

  const uint32_t* prow = packed_t + s * n32;
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
      while (live) {  // warp-uniform
        const int src_lane = __ffs(live) - 1;
        live &= live - 1;
        uint32_t bits = __shfl_sync(kFull, word[u], src_lane);
        const int64_t j = j0 + u * 32 + src_lane;
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          const int64_t d = static_cast<int64_t>(b) * n32 + j;
          if (d >= num_dst) continue;  // warp-uniform; padding bits are 0
          float p[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            p[k] = valid[k]
                       ? lrelu_exp(elv[k] + __ldg(er + d * heads + head[k]),
                                   slope)
                       : 0.f;
          if (lane_adds)
            red_add_v4(acc + d * ostride + 4 * lane, p[0] * zv[0],
                       p[1] * zv[1], p[2] * zv[2], p[3] * zv[3]);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (first[k]) atomicAdd(l + d * heads + head[k], p[k]);
        }
      }
    }
  }
}

// out[d, f] = acc[d, f] / max(l[d, f / dim], 1e-20) for the num_dst x hd
// outputs, acc's rows ostride floats apart.
__global__ void bitgat_fwd_t_finish_kernel(const float* __restrict__ acc,
                                           const float* __restrict__ l,
                                           float* __restrict__ out,
                                           int64_t n, int hd, int dim,
                                           int ostride) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= n) return;
  const int64_t d = i / hd;
  const int f = static_cast<int>(i - d * hd);
  out[i] = __ldg(acc + d * ostride + f) /
           fmaxf(__ldg(l + i / dim), 1e-20f);
}

dim3 rows_grid(int64_t rows) {
  return dim3(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
}

template <int kCols, bool kDrop>
cudaError_t launch_fwd(const void* packed, int64_t n32, int64_t num_src,
                       int64_t num_dst, const void* el, const void* er,
                       const void* z, int64_t heads, int64_t dim, float slope,
                       int64_t thresh, const void* seed, void* out, void* l,
                       cudaStream_t stream) {
  bitgat_fwd_warp_kernel<kCols, kDrop><<<rows_grid(num_dst), kWarps * 32, 0,
                                         stream>>>(
      static_cast<const uint32_t*>(packed), n32, num_src, num_dst,
      static_cast<const float*>(el), static_cast<const float*>(er),
      static_cast<const float*>(z), static_cast<int>(heads),
      static_cast<int>(dim), slope, static_cast<uint32_t>(thresh),
      static_cast<const int64_t*>(seed), static_cast<float*>(out),
      static_cast<float*>(l));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The warp walk: out (num_dst, H, D) and l (num_dst, H) f32, every element
// written, from packed (>= num_dst rows, n32 words), el (num_src, H), er
// (num_dst, H), z (num_src, H, D) f32 and the seed (one int64 on the card,
// low 32 bits used); thresh 0 means no dropout, else 1..32768 and H <= 8.
// Grid: ceil(num_dst / 8) blocks of 8 warps.
int dgl_probe_fwd_warp(const void* packed, int64_t n32, int64_t num_src,
                       int64_t num_dst, const void* el, const void* er,
                       const void* z, int64_t heads, int64_t dim, float slope,
                       int64_t thresh, const void* seed, void* out, void* l,
                       int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool drop = thresh != 0;
#define DGL_FWD(C, D)                                                       \
  return launch_fwd<C, D>(packed, n32, num_src, num_dst, el, er, z, heads, \
                          dim, slope, thresh, seed, out, l, st)
  switch ((heads * dim + 31) / 32) {
    case 1: if (drop) DGL_FWD(1, true); else DGL_FWD(1, false);
    case 2: if (drop) DGL_FWD(2, true); else DGL_FWD(2, false);
    case 3: if (drop) DGL_FWD(3, true); else DGL_FWD(3, false);
    case 4: if (drop) DGL_FWD(4, true); else DGL_FWD(4, false);
    default: return cudaErrorInvalidValue;
  }
#undef DGL_FWD
}

// The scatter walk over the bits of A^T: out (num_dst, H, D) f32, every
// element written, and l (num_dst, H) f32, zeroed by the caller, from
// packed_t (>= num_src rows, n32 words; bit b of word j <-> dst b * n32 +
// j), el (num_src, H), er (num_dst, H) and z (num_src, H, D) f32, H D <=
// 128, without dropout; acc is a zeroed (num_dst, ostride) f32 sum buffer,
// ostride >= H D a multiple of 4 (16-byte aligned rows).  Grid:
// ceil(num_src / 8) blocks of 8 warps, then a divide pass.
int dgl_probe_fwd_t(const void* packed_t, int64_t n32, int64_t num_src,
                    int64_t num_dst, const void* el, const void* er,
                    const void* z, int64_t heads, int64_t dim, float slope,
                    int64_t ostride, void* acc, void* out, void* l,
                    int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (heads * dim > 128 || ostride < heads * dim || ostride % 4 != 0 ||
      reinterpret_cast<uintptr_t>(acc) % 16 != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bitgat_fwd_t_kernel<<<rows_grid(num_src), kWarps * 32, 0, st>>>(
      static_cast<const uint32_t*>(packed_t), n32, num_src, num_dst,
      static_cast<const float*>(el), static_cast<const float*>(er),
      static_cast<const float*>(z), static_cast<int>(heads),
      static_cast<int>(dim), slope, static_cast<int>(ostride),
      static_cast<float*>(acc), static_cast<float*>(l));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t n = num_dst * heads * dim;
  bitgat_fwd_t_finish_kernel<<<static_cast<unsigned>((n + 255) / 256), 256,
                               0, st>>>(
      static_cast<const float*>(acc), static_cast<const float*>(l),
      static_cast<float*>(out), n, static_cast<int>(heads * dim),
      static_cast<int>(dim), static_cast<int>(ostride));
  return cudaGetLastError();
}

}  // extern "C"
