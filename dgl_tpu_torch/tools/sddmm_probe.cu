// The SDDMM probe's own kernels (dgl_tpu_torch/tools/perf_sddmm_walk.py),
// built by the probe alone; the walks of its direct and slot-major write
// layouts are edits of csrc/row_agg.cu's row_sddmm_kernel.
//
// bucket_sddmm_kernel: K4's SDDMM walked in bucket order, the layout of
// the port's first SDDMM kernel, with the row walk's 16-byte loads: the
// probe's third write layout.  e[b, h, c] = <x[src, h, :], z[dst, h, :]>
// at every slot, 0 at a padded one, written into (B, H, cap).  A warp
// takes 32 slots of one bucket (grid-stride); its lanes load the slots'
// src_local, dst_local and valid coalesced.  Groups of lpr lanes then
// take a slot each (32 / lpr slots a pass, U passes in flight), gather
// both x[src] and z[dst] rows in 16-byte vectors (a bucket reads one src
// tile and one dst tile, so both mostly hit L2) and reduce each head's
// dot over its lph lanes with xor shuffles, in the lane layout of
// row_sddmm_kernel.  A head's writes of one pass and the next land in the
// same sectors, 32 slots apart from other warps'.
//
// probe_finish_kernel: the finishing passes of the direct and slot-major
// layouts: 0 at the padded slots of (B, H, cap), or the transpose of a
// slot-major (B, cap, H) scratch with 0 at the padded slots.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

template <int CPL>
__global__ void __launch_bounds__(kWarps * 32)
bucket_sddmm_kernel(const int* __restrict__ src_local,
                    const int* __restrict__ dst_local,
                    const float* __restrict__ valid,
                    const int* __restrict__ src_tile,
                    const int* __restrict__ dst_tile, int num_buckets,
                    int tile, int cap, const float* __restrict__ x,
                    const float* __restrict__ z, int f, int heads, int hv,
                    int lph, int cph, int lpr, float* __restrict__ out) {
  constexpr int U = CPL == 1 ? 4 : CPL == 2 ? 2 : 1;
  const int lane = threadIdx.x & 31;
  const int groups = 32 / lpr;
  const int grp = lane / lpr;
  const int li = lane - grp * lpr;
  const unsigned gmask =
      lpr == 32 ? kFull : ((1u << lpr) - 1u) << (grp * lpr);
  const int hl = li / lph;
  const int fl = li - hl * lph;
  const int hpp = lpr / lph;
  int vq[CPL];
  int hq[CPL];
  bool ok[CPL];
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    const int k = q / cph;
    const int v = fl + (q - k * cph) * lph;
    hq[q] = hl + k * hpp;
    ok[q] = hq[q] < heads && v < hv;
    vq[q] = ok[q] ? hq[q] * hv + v : 0;
  }
  const int per_bucket = cap / 32;
  const int n_chunks = num_buckets * per_bucket;
  for (int k = blockIdx.x * kWarps + (threadIdx.x >> 5); k < n_chunks;
       k += gridDim.x * kWarps) {
    const int b = k / per_bucket;
    const int c0 = (k - b * per_bucket) * 32;
    const int s0 = b * cap + c0;
    const float v = valid[s0 + lane];
    const int sl = src_local[s0 + lane];
    const int dl = dst_local[s0 + lane];
    float* ob = out + b * heads * cap + c0;  // e[b, h, c0 + j] = ob[h*cap+j]
    if (__ballot_sync(kFull, v != 0.f) == 0u) {  // a padded tail
      for (int h = 0; h < heads; ++h) ob[h * cap + lane] = 0.f;
      continue;
    }
    const float* xt = x + src_tile[b] * tile * f;
    const float* zt = z + dst_tile[b] * tile * f;
    for (int j0 = 0; j0 < 32; j0 += groups * U) {  // uniform in the warp
      float4 xv[U][CPL];
      float4 zv[U][CPL];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * groups + grp;
        const int jl = j & 31;
        const float vj = __shfl_sync(kFull, v, jl);
        const int sj = __shfl_sync(kFull, sl, jl);
        const int dj = __shfl_sync(kFull, dl, jl);
        live[u] = j < 32 && vj != 0.f;
        const float4* xr = reinterpret_cast<const float4*>(xt + sj * f);
        const float4* zr = reinterpret_cast<const float4*>(zt + dj * f);
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const bool on = live[u] && ok[q];
          xv[u][q] = on ? __ldg(xr + vq[q]) : make_float4(0.f, 0.f, 0.f, 0.f);
          zv[u][q] = on ? __ldg(zr + vq[q]) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * groups + grp;
        float d[CPL];
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          d[q] = dot4(xv[u][q], zv[u][q]);
          for (int o = lph / 2; o > 0; o >>= 1) {
            d[q] += __shfl_xor_sync(gmask, d[q], o, lpr);
          }
        }
        if (j < 32 && fl == 0) {
          float sum = 0.f;
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            sum += d[q];
            if ((q + 1) % cph == 0) {
              if (hq[q] < heads) ob[hq[q] * cap + j] = live[u] ? sum : 0.f;
              sum = 0.f;
            }
          }
        }
      }
    }
  }
}

// out (B, heads, cap), a thread a slot s = b * cap + c: with sm (slots *
// heads, slot-major) out[b, h, c] = sm[s * heads + h] at a valid slot and
// 0 at a padded one (valid 0); with sm null only the padded slots are
// written, 0.
__global__ void __launch_bounds__(256)
probe_finish_kernel(const float* __restrict__ valid,
                    const float* __restrict__ sm, long long slots, int heads,
                    int cap, float* __restrict__ out) {
  for (long long s = blockIdx.x * 256LL + threadIdx.x; s < slots;
       s += static_cast<long long>(gridDim.x) * 256) {
    const long long b = s / cap;
    float* o = out + b * heads * cap + (s - b * cap);
    const bool v = valid[s] != 0.f;
    if (sm != nullptr) {
      const float* p = sm + s * heads;
      for (int h = 0; h < heads; ++h) o[h * cap] = v ? p[h] : 0.f;
    } else if (!v) {
      for (int h = 0; h < heads; ++h) o[h * cap] = 0.f;
    }
  }
}

template <int CPL>
cudaError_t launch(const void* src_local, const void* dst_local,
                   const void* valid, const void* src_tile,
                   const void* dst_tile, int64_t num_buckets, int64_t tile,
                   int64_t cap, const void* x, const void* z, int64_t f,
                   int64_t heads, int64_t hv, int64_t lph, int64_t cph,
                   int64_t lpr, void* out, int64_t blocks,
                   cudaStream_t stream) {
  bucket_sddmm_kernel<CPL><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                             stream>>>(
      static_cast<const int*>(src_local), static_cast<const int*>(dst_local),
      static_cast<const float*>(valid), static_cast<const int*>(src_tile),
      static_cast<const int*>(dst_tile), static_cast<int>(num_buckets),
      static_cast<int>(tile), static_cast<int>(cap),
      static_cast<const float*>(x), static_cast<const float*>(z),
      static_cast<int>(f), static_cast<int>(heads), static_cast<int>(hv),
      static_cast<int>(lph), static_cast<int>(cph), static_cast<int>(lpr),
      static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (num_buckets, heads, cap), every element written, from x (num_src,
// f) and z (num_dst, f), f = heads * hv * 4, 16-byte aligned; lph, cph,
// lpr and cpl as dgl_row_sddmm takes them.  Grid: `blocks` blocks of 8
// warps, grid-stride over 32-slot chunks.
int dgl_bucket_sddmm(const void* src_local, const void* dst_local,
                     const void* valid, const void* src_tile,
                     const void* dst_tile, int64_t num_buckets, int64_t tile,
                     int64_t cap, const void* x, const void* z, int64_t f,
                     int64_t heads, int64_t hv, int64_t lph, int64_t cph,
                     int64_t lpr, void* out, int64_t cpl, int64_t blocks,
                     int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (cap % 32 != 0 || f != heads * hv * 4 || lpr < 1 || lpr > 32 ||
      lpr % lph != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DGL_BUCKET_CASE(C_)                                                 \
  case C_:                                                                  \
    return launch<C_>(src_local, dst_local, valid, src_tile, dst_tile,      \
                      num_buckets, tile, cap, x, z, f, heads, hv, lph, cph, \
                      lpr, out, blocks, s);
  switch (cpl) {
    DGL_BUCKET_CASE(1)
    DGL_BUCKET_CASE(2)
    DGL_BUCKET_CASE(4)
    DGL_BUCKET_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef DGL_BUCKET_CASE
}

// probe_finish_kernel over out (slots / cap, heads, cap); valid (slots,)
// f32, sm (slots * heads,) or null.
int dgl_probe_finish(const void* valid, const void* sm, int64_t slots,
                     int64_t heads, int64_t cap, void* out, int64_t blocks,
                     int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (cap < 1 || heads < 1 || blocks < 1) return cudaErrorInvalidValue;
  probe_finish_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(valid), static_cast<const float*>(sm), slots,
      static_cast<int>(heads), static_cast<int>(cap),
      static_cast<float*>(out));
  return cudaGetLastError();
}

}  // extern "C"
