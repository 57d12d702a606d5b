// The two kernels that K7's forward and K11's scores left, built by
// dgl_tpu_torch/tools/perf_fwd_scores.py with the package's nvcc flags
// and timed beside the kernels that replaced them; they are not on any
// main path.  Each is the package's code as it stood before the redesign:
//
// bitdot_fwd_kernel<kCols>  (csrc/bitdot.cu; replaces
//     dgl_tpu/ops/pallas/bitdot.py _fwd_call :156): one warp a dst row of
//     packed, its set bits walked one at a time (walk_row: the row's words
//     one a lane, 8 in flight, zero words skipped, bits by __ffs); q[d] in
//     registers, per bit the warp gathers z[s] with scalar loads, takes
//     z . q per head by warp shuffles (head_sums), then the exp, and adds
//     p z[s] and p into out's and l's sums; rows launched in id order.
//     Replaced by the listed walk by dst, bitdot_fwd_list_kernel.
// vattn_scores_kernel<kEdge, T, kStore>  (csrc/gatv2.cu; <true> replaces
//     dgl_tpu/ops/pallas/gat_fused.py _egatc2_scores_kernel :1955, K11
//     v2's scores, and <false, T, true> _egatc_scores_kernel :959, K11
//     v1's): one warp a 32-slot chunk of the buckets, U[src] and V[dst]
//     gathered with scalar loads at every slot, padded ones included; with
//     kEdge wf in the block's shared memory and the chunk's edge-feature
//     rows in the warp's (load_ef_chunk), read once an FMA; with kStore the
//     stored row added to raw.  Replaced by the dot-product walk by dst in
//     its scores mode (csrc/row_agg.cu row_vattn_fe_kernel, and
//     row_sddmm_kernel<CPL, true, true, T>), then slot_finish_kernel's exp.
//     Its <false, float, false> instance, K9's scores, which that walk
//     replaced first, is built by tools/perf_scores_rows.py from an edit
//     of this file (BUCKET_SCORES).
//
// Each is behind a plain C function that launches on the caller's stream
// and returns cudaGetLastError(), with the name and the argument list it
// had in the package.  The scores' part lives in a namespace of its own:
// its kUnroll (slots a warp keeps in flight) is not the forward's (words a
// lane keeps in flight).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;   // warps per block
constexpr int kUnroll = 8;  // words each lane keeps in flight
constexpr float kClip = 40.f;
constexpr float kDenEps = 1e-20f;

// The feature columns a lane owns: column f = lane + 32 k of the
// flattened (H, D) row, its head f / dim, and whether it starts its head
// (the one lane that writes the head's scalars).
template <int kCols>
struct Columns {
  int f[kCols];
  int head[kCols];  // -1 past H * D
  bool first[kCols];

  __device__ Columns(int lane, int heads, int dim) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      f[k] = lane + 32 * k;
      const bool valid = f[k] < heads * dim;
      head[k] = valid ? f[k] / dim : -1;
      first[k] = valid && f[k] % dim == 0;
    }
  }
};

// v[n][k] := the sum of v[n] over the columns of head[k], across the warp,
// for each of the kN arrays at once.
template <int kN, int kCols>
__device__ __forceinline__ void head_sums(float (&v)[kN][kCols],
                                          const Columns<kCols>& c, int heads,
                                          int dim) {
  if (32 % dim == 0) {
    // a head is an aligned group of dim lanes within one register
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      for (int off = dim >> 1; off > 0; off >>= 1)
#pragma unroll
        for (int n = 0; n < kN; ++n)
          v[n][k] += __shfl_xor_sync(kFull, v[n][k], off);
    return;
  }
  float sum[kN][kCols];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int k = 0; k < kCols; ++k) sum[n][k] = 0.f;
  for (int h = 0; h < heads; ++h) {
    float part[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      part[n] = 0.f;
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        part[n] += c.head[k] == h ? v[n][k] : 0.f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int n = 0; n < kN; ++n)
        part[n] += __shfl_xor_sync(kFull, part[n], off);
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      if (c.head[k] == h)
#pragma unroll
        for (int n = 0; n < kN; ++n) sum[n][k] = part[n];
  }
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int k = 0; k < kCols; ++k) v[n][k] = sum[n][k];
}

__device__ __forceinline__ float clip_exp(float e) {
  return expf(fminf(fmaxf(e, -kClip), kClip));
}

// The set bits of row `row` of a packing of `words` words a row, in
// order: calls visit(col) for each, col = b * words + j, on every lane of
// the warp (the loop is warp-uniform).  Columns at or past num_cols are
// padding, whose bits are 0.
template <typename Visit>
__device__ __forceinline__ void walk_row(const uint32_t* __restrict__ packed,
                                         int64_t words, int64_t row,
                                         int64_t num_cols, int lane,
                                         Visit visit) {
  const uint32_t* prow = packed + row * words;
  for (int64_t j0 = 0; j0 < words; j0 += 32 * kUnroll) {
    uint32_t word[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u * 32 + lane;
      word[u] = j < words ? __ldg(prow + j) : 0u;
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
          const int64_t col = static_cast<int64_t>(b) * words + j;
          if (col < num_cols) visit(col);
        }
      }
    }
  }
}

template <int kCols>
__global__ void __launch_bounds__(kWarps * 32)
bitdot_fwd_kernel(const uint32_t* __restrict__ packed, int64_t n32,
                  int64_t num_src, int64_t num_dst,
                  const float* __restrict__ q, const float* __restrict__ z,
                  int heads, int dim, float isd, float* __restrict__ out,
                  float* __restrict__ l) {
  const int lane = threadIdx.x & 31;
  const int64_t d =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (d >= num_dst) return;  // warp-uniform
  const int hd = heads * dim;
  const Columns<kCols> c(lane, heads, dim);
  float qv[kCols], acc[kCols], lsum[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    qv[k] = c.head[k] >= 0 ? __ldg(q + d * hd + c.f[k]) : 0.f;
    acc[k] = 0.f;
    lsum[k] = 0.f;
  }
  walk_row(packed, n32, d, num_src, lane, [&](int64_t s) {
    float zv[kCols], dot[1][kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      zv[k] = c.head[k] >= 0 ? __ldg(z + s * hd + c.f[k]) : 0.f;
      dot[0][k] = zv[k] * qv[k];
    }
    head_sums<1, kCols>(dot, c, heads, dim);
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      if (c.head[k] < 0) continue;  // as in K5's forward (csrc/bitgat.cu)
      const float p = clip_exp(dot[0][k] * isd);
      lsum[k] += p;
      acc[k] += p * zv[k];
    }
  });
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    if (c.head[k] < 0) continue;
    out[d * hd + c.f[k]] = acc[k] / fmaxf(lsum[k], kDenEps);
    if (c.first[k]) l[d * heads + c.head[k]] = lsum[k];
  }
}

dim3 rows_grid(int64_t rows) {
  return dim3(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
}

// K11's scores, in a namespace of their own: their kUnroll is not the
// forward's
namespace scores {

// A stored slot tensor's element as f32, and back (csrc/gat_fused.cu has
// the same pair)
__device__ __forceinline__ float ld_slot(const float* t, long long i) {
  return __ldg(t + i);
}
__device__ __forceinline__ float ld_slot(const __nv_bfloat16* t,
                                         long long i) {
  return __bfloat162float(__ldg(t + i));
}
__device__ __forceinline__ void st_slot(float* t, long long i, float v) {
  t[i] = v;
}
__device__ __forceinline__ void st_slot(__nv_bfloat16* t, long long i,
                                        float v) {
  t[i] = __float2bfloat16(v);
}

constexpr unsigned kFull = 0xffffffffu;
constexpr float kClip = 40.f;     // gat_fused.py CLIP
constexpr int kWarps = 8;         // warps per scores / slot-grad block
constexpr int kUnroll = 4;        // scores: slots in flight per warp

__device__ __forceinline__ float lrelu(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

// The 32 edge-feature rows of the chunk starting at slot s0 into
// ef_s[32][fe_rows]; column fe holds the bias row's implicit 1 when
// fe_rows > fe.
__device__ __forceinline__ void load_ef_chunk(const float* __restrict__ ef,
                                              int s0, int fe, int fe_rows,
                                              float* ef_s, int lane) {
  const float* src = ef + static_cast<long long>(s0) * fe;
  for (int i = lane; i < 32 * fe_rows; i += 32) {
    const int j = i / fe_rows;
    const int k = i - j * fe_rows;
    ef_s[i] = k < fe ? __ldg(src + j * fe + k) : 1.f;
  }
  __syncwarp();
}

template <bool kEdge, typename T = float, bool kStore = false>
__global__ void __launch_bounds__(kWarps * 32)
vattn_scores_kernel(const int* __restrict__ src_local,
                    const int* __restrict__ dst_local,
                    const float* __restrict__ valid,
                    const int* __restrict__ src_tile,
                    const int* __restrict__ dst_tile, int num_buckets,
                    int tile, int cap, const float* __restrict__ u,
                    const float* __restrict__ v,
                    const float* __restrict__ attn,
                    const float* __restrict__ ef,
                    const float* __restrict__ wf, int fe, int fe_rows,
                    int heads, int dim, int lanes, float slope,
                    const T* __restrict__ fe_s, float* __restrict__ p) {
  extern __shared__ float smem[];
  const int hd = heads * dim;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* attn_s = smem;                           // [hd]
  float* wf_s = attn_s + hd;                      // [fe_rows][hd]
  float* ef_s = wf_s + (kEdge ? fe_rows * hd : 0)
                + warp * 32 * fe_rows;            // this warp's [32][fe_rows]
  for (int i = threadIdx.x; i < hd; i += blockDim.x) attn_s[i] = attn[i];
  if (kEdge) {
    for (int i = threadIdx.x; i < fe_rows * hd; i += blockDim.x) {
      wf_s[i] = wf[i];
    }
  }
  __syncthreads();

  const int heads_per_pass = 32 / lanes;
  const int hl = lane / lanes;  // head of this lane within a pass
  const int fl = lane % lanes;  // first column of this lane in its head
  const int per_bucket = cap / 32;
  const int n_chunks = num_buckets * per_bucket;
  for (int k = blockIdx.x * kWarps + warp; k < n_chunks;
       k += gridDim.x * kWarps) {
    const int b = k / per_bucket;
    const int c0 = (k % per_bucket) * 32;  // the chunk's first slot in b
    const int s0 = b * cap + c0;
    const float vld = valid[s0 + lane];
    const int sl = src_local[s0 + lane];
    const int dl = dst_local[s0 + lane];
    const int ob = b * heads * cap + c0;  // p[b, h, c0 + j] = p[ob+h*cap+j]
    if (__ballot_sync(kFull, vld != 0.f) == 0u) {  // a padded tail: all 0
      for (int h = 0; h < heads; ++h) p[ob + h * cap + lane] = 0.f;
      continue;
    }
    if (kEdge) load_ef_chunk(ef, s0, fe, fe_rows, ef_s, lane);
    const float* ut = u + static_cast<long long>(src_tile[b]) * tile * hd;
    const float* vt = v + static_cast<long long>(dst_tile[b]) * tile * hd;
    for (int j0 = 0; j0 < 32; j0 += kUnroll) {
      const float* ur[kUnroll];
      const float* vr[kUnroll];
      bool live[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        live[q] = __shfl_sync(kFull, vld, j0 + q) != 0.f;  // warp-uniform
        ur[q] = ut + __shfl_sync(kFull, sl, j0 + q) * hd;
        vr[q] = vt + __shfl_sync(kFull, dl, j0 + q) * hd;
      }
      for (int h0 = 0; h0 < heads; h0 += heads_per_pass) {
        const int h = h0 + hl;
        const int c_end = h < heads ? (h + 1) * dim : 0;  // this head's end
        float s[kUnroll];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) s[q] = 0.f;
        for (int c = h * dim + fl; c < c_end; c += lanes) {
          const float a = attn_s[c];
#pragma unroll
          for (int q = 0; q < kUnroll; ++q) {
            if (!live[q]) continue;
            float raw = __ldg(ur[q] + c) + __ldg(vr[q] + c);
            if (kEdge) {
              const float* e = ef_s + (j0 + q) * fe_rows;
              for (int r = 0; r < fe_rows; ++r) raw += e[r] * wf_s[r * hd + c];
            }
            if (kStore) {
              raw += ld_slot(fe_s,
                             static_cast<long long>(s0 + j0 + q) * hd + c);
            }
            s[q] += a * lrelu(raw, slope);
          }
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          for (int o = lanes / 2; o > 0; o >>= 1) {
            s[q] += __shfl_xor_sync(kFull, s[q], o);
          }
          if (fl == 0 && h < heads) {
            p[ob + h * cap + j0 + q] =
                live[q] ? expf(fminf(fmaxf(s[q], -kClip), kClip)) : 0.f;
          }
        }
      }
    }
    if (kEdge) __syncwarp();  // ef_s is rewritten by the next chunk
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

struct Slots {
  const int* src_local;
  const int* dst_local;
  const float* valid;
  const int* src_tile;
  const int* dst_tile;
};

Slots slots(const void* src_local, const void* dst_local, const void* valid,
            const void* src_tile, const void* dst_tile) {
  return Slots{static_cast<const int*>(src_local),
               static_cast<const int*>(dst_local),
               static_cast<const float*>(valid),
               static_cast<const int*>(src_tile),
               static_cast<const int*>(dst_tile)};
}

}  // namespace scores

}  // namespace

using scores::allow_smem;
using scores::slots;
using scores::Slots;
using scores::vattn_scores_kernel;

// The forward takes the packing's row width (n32), the src and dst
// counts, q (num_dst, H, D) and z (num_src, H, D), f32 and contiguous,
// with H * D <= 128, and writes every element of its outputs.  Grid:
// ceil(rows / 8) blocks of 8 warps, one warp a row.
#define DGL_BITDOT_SWITCH(LAUNCH)                \
  switch ((heads * dim + 31) / 32) {             \
    case 1: LAUNCH(1); break;                    \
    case 2: LAUNCH(2); break;                    \
    case 3: LAUNCH(3); break;                    \
    case 4: LAUNCH(4); break;                    \
    default: return cudaErrorInvalidValue;       \
  }                                              \
  return cudaGetLastError()

extern "C" {

// Forward over packed (rows = dst, n32 words): out (num_dst, H, D) and l
// (num_dst, H).
int dgl_bitdot_fwd(const void* packed, int64_t n32, int64_t num_src,
                   int64_t num_dst, const void* q, const void* z,
                   int64_t heads, int64_t dim, float isd, void* out, void* l,
                   int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DGL_FWD(C)                                                          \
  bitdot_fwd_kernel<C><<<rows_grid(num_dst), kWarps * 32, 0, st>>>(        \
      static_cast<const uint32_t*>(packed), n32, num_src, num_dst,          \
      static_cast<const float*>(q), static_cast<const float*>(z),           \
      static_cast<int>(heads), static_cast<int>(dim), isd,                  \
      static_cast<float*>(out), static_cast<float*>(l))
  DGL_BITDOT_SWITCH(DGL_FWD);
#undef DGL_FWD
}

// p (num_buckets, heads, cap), every element written, from u (num_src,
// heads * dim), v (num_dst, heads * dim) and attn (heads * dim); with ef
// not null, the edge term from ef (num_buckets * cap, fe) and wf (fe_rows,
// heads * dim); with fe_s not null (and ef null), the stored term fe_s
// (num_buckets * cap, heads * dim), f32 (store 1) or bf16 (store 2).
// One of the two terms is needed: without either (K9's scores) the call
// returns cudaErrorInvalidValue (csrc/row_agg.cu dgl_row_vattn serves it).
// lanes: 32 over the heads rounded up to a power of two, at least 1.
// Grid: `blocks` blocks of 8 warps, grid-stride over 32-slot chunks.
int dgl_vattn_scores(const void* src_local, const void* dst_local,
                     const void* valid, const void* src_tile,
                     const void* dst_tile, int64_t num_buckets, int64_t tile,
                     int64_t cap, const void* u, const void* v,
                     const void* attn, const void* ef, const void* wf,
                     int64_t fe, int64_t fe_rows, int64_t heads, int64_t dim,
                     int64_t lanes, double slope, const void* fe_s,
                     int64_t store, void* p, int64_t blocks, int64_t device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Slots sl = slots(src_local, dst_local, valid, src_tile, dst_tile);
  const int hd = static_cast<int>(heads * dim);
  const bool edge = ef != nullptr;
  if (fe_s != nullptr && (edge || (store != 1 && store != 2))) {
    return cudaErrorInvalidValue;
  }
  const int rows = edge ? static_cast<int>(fe_rows) : 0;
  const size_t smem = sizeof(float) * (hd + rows * hd + kWarps * 32 * rows);
#define DGL_SCORES_LAUNCH(EDGE_, T_, STORE_)                                 \
  err = allow_smem(vattn_scores_kernel<EDGE_, T_, STORE_>, smem);            \
  if (err != cudaSuccess) return err;                                        \
  vattn_scores_kernel<EDGE_, T_, STORE_><<<static_cast<unsigned>(blocks),    \
                                           kWarps * 32, smem, s>>>(          \
      sl.src_local, sl.dst_local, sl.valid, sl.src_tile, sl.dst_tile,        \
      static_cast<int>(num_buckets), static_cast<int>(tile),                 \
      static_cast<int>(cap), static_cast<const float*>(u),                   \
      static_cast<const float*>(v), static_cast<const float*>(attn),         \
      static_cast<const float*>(ef), static_cast<const float*>(wf),          \
      static_cast<int>(fe), rows, static_cast<int>(heads),                   \
      static_cast<int>(dim), static_cast<int>(lanes),                        \
      static_cast<float>(slope), static_cast<const T_*>(fe_s),               \
      static_cast<float*>(p));
  if (edge) {
    DGL_SCORES_LAUNCH(true, float, false)
  } else if (fe_s == nullptr) {
    return cudaErrorInvalidValue;  // K9's scores: csrc/row_agg.cu's walk
  } else if (store == 1) {
    DGL_SCORES_LAUNCH(false, float, true)
  } else {
    DGL_SCORES_LAUNCH(false, __nv_bfloat16, true)
  }
#undef DGL_SCORES_LAUNCH
  return cudaGetLastError();
}

}  // extern "C"
