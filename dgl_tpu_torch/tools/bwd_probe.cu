// The backward walks' probe's own kernel (dgl_tpu_torch/tools/
// perf_bwd_walks.py), built by the probe alone: K5's backward as the
// port ran it before the listed walk of csrc/bitgat.cu
// (bitgat_bwd_list_kernel), kept so that the two can be timed side by
// side on one card.
//
// bitgat_bwd_warp_kernel: one warp a src row of packed_rev.  The warp
// streams the row's words coalesced (one a lane, 8 in flight), keeps z[s],
// dz[s] and del[s] in registers (column f = lane + 32 k of the (H, D) row,
// k < 4) and walks the set bits one after another: for each, a gather of
// g[d] and of the (3, H) row [er, linv, rho], the head dot by a
// warp-shuffle sum over all 32 lanes (5 levels), the exp and the dropout
// hash, and one atomicAdd an (edge, head) into der from the lane that
// starts the head.  Each bit's gather waits on the previous bit's
// arithmetic.  The outputs are the listed walk's (dz, del, der), with
// dz and del in the warp's own order of sums.

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

// v[k] := the sum of v over the columns of head[k], across the warp.
template <int kCols>
__device__ __forceinline__ void head_sums(float (&v)[kCols],
                                          const Columns<kCols>& c, int heads,
                                          int dim) {
  if (32 % dim == 0) {
    // a head is an aligned group of dim lanes within one register
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      for (int off = dim >> 1; off > 0; off >>= 1)
        v[k] += __shfl_xor_sync(kFull, v[k], off);
    return;
  }
  float sum[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) sum[k] = 0.f;
  for (int h = 0; h < heads; ++h) {
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < kCols; ++k) part += c.head[k] == h ? v[k] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(kFull, part, off);
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (c.head[k] == h) sum[k] = part;
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) v[k] = sum[k];
}

template <int kCols, bool kDrop>
__global__ void __launch_bounds__(kWarps * 32)
bitgat_bwd_warp_kernel(const uint32_t* __restrict__ packed_rev, int64_t k32,
                  int64_t num_src, int64_t num_dst,
                  const float* __restrict__ el,
                  const float* __restrict__ nvec,  // (num_dst, 3, H)
                  const float* __restrict__ z, const float* __restrict__ g,
                  int heads, int dim, float slope, uint32_t thresh,
                  const int64_t* __restrict__ seed, float* __restrict__ dz,
                  float* __restrict__ del, float* __restrict__ der) {
  const int lane = threadIdx.x & 31;
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (s >= num_src) return;  // warp-uniform
  const int hd = heads * dim;
  const Columns<kCols> c(lane, heads, dim, kDrop);
  float elv[kCols], zv[kCols], dzacc[kCols], delacc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const bool valid = c.head[k] >= 0;
    elv[k] = valid ? __ldg(el + s * heads + c.head[k]) : 0.f;
    zv[k] = valid ? __ldg(z + s * hd + c.f[k]) : 0.f;
    dzacc[k] = 0.f;
    delacc[k] = 0.f;
  }
  const uint32_t spart =
      kDrop ? (static_cast<uint32_t>(s) * kC1) ^ static_cast<uint32_t>(*seed)
            : 0u;

  const uint32_t* prow = packed_rev + s * k32;
  for (int64_t j0 = 0; j0 < k32; j0 += 32 * kUnroll) {
    uint32_t word[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u * 32 + lane;
      word[u] = j < k32 ? __ldg(prow + j) : 0u;
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
          const int64_t d = static_cast<int64_t>(b) * k32 + j;
          if (d >= num_dst) continue;  // warp-uniform; padding bits are 0
          const float* nv = nvec + d * 3 * heads;
          float gv[kCols], dot[kCols], erv[kCols], linv[kCols], rho[kCols];
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const bool valid = c.head[k] >= 0;
            const int h = valid ? c.head[k] : 0;
            gv[k] = valid ? __ldg(g + d * hd + c.f[k]) : 0.f;
            erv[k] = __ldg(nv + h);
            linv[k] = __ldg(nv + heads + h);
            rho[k] = __ldg(nv + 2 * heads + h);
            dot[k] = gv[k] * zv[k];
          }
          head_sums<kCols>(dot, c, heads, dim);
          const uint32_t x0 =
              kDrop ? spart ^ (static_cast<uint32_t>(d) * kC2) : 0u;
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            if (c.head[k] < 0) continue;
            const float raw = elv[k] + erv[k];
            const float alpha = lrelu_exp(raw, slope) * linv[k];
            const float alpha_m =
                (!kDrop || keep_bit(x0, c.mult[k], thresh)) ? alpha : 0.f;
            const float de = alpha_m * dot[k] - alpha * rho[k];
            const float draw = raw > 0.f ? de : slope * de;
            dzacc[k] += alpha_m * gv[k];
            delacc[k] += draw;
            if (c.first[k]) atomicAdd(der + d * heads + c.head[k], draw);
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (c.head[k] < 0) continue;
    dz[s * hd + c.f[k]] = dzacc[k];
    if (c.first[k]) del[s * heads + c.head[k]] = delacc[k];
  }
}

}  // namespace

extern "C" {

// dz (num_src, H, D) and del (num_src, H) f32, every element written, and
// der (num_dst, H) f32, zeroed by the caller and summed with atomics, from
// packed_rev (>= num_src rows, k32 words), el (num_src, H), nvec (num_dst,
// 3, H) = [er, linv, rho], z (num_src, H, D) and g (num_dst, H, D) f32;
// thresh 0 means no dropout, else H <= 8.  H * D <= 128.  Grid:
// ceil(num_src / 8) blocks of 8 warps.
int dgl_probe_bwd_warp(const void* packed_rev, int64_t k32, int64_t num_src,
                       int64_t num_dst, const void* el, const void* nvec,
                       const void* z, const void* g, int64_t heads,
                       int64_t dim, float slope, int64_t thresh,
                       const void* seed, void* dz, void* del, void* der,
                       int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((num_src + kWarps - 1) / kWarps));
#define DGL_BWD(C, D)                                                       \
  bitgat_bwd_warp_kernel<C, D><<<grid, kWarps * 32, 0, st>>>(               \
      static_cast<const uint32_t*>(packed_rev), k32, num_src, num_dst,      \
      static_cast<const float*>(el), static_cast<const float*>(nvec),       \
      static_cast<const float*>(z), static_cast<const float*>(g),           \
      static_cast<int>(heads), static_cast<int>(dim), slope,                \
      static_cast<uint32_t>(thresh), static_cast<const int64_t*>(seed),     \
      static_cast<float*>(dz), static_cast<float*>(del),                    \
      static_cast<float*>(der));                                            \
  return cudaGetLastError()
  const bool drop = thresh != 0;
  switch ((heads * dim + 31) / 32) {
    case 1: if (drop) { DGL_BWD(1, true); } else { DGL_BWD(1, false); }
    case 2: if (drop) { DGL_BWD(2, true); } else { DGL_BWD(2, false); }
    case 3: if (drop) { DGL_BWD(3, true); } else { DGL_BWD(3, false); }
    case 4: if (drop) { DGL_BWD(4, true); } else { DGL_BWD(4, false); }
    default: return cudaErrorInvalidValue;
  }
#undef DGL_BWD
}

}  // extern "C"
