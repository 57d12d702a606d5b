// The two kernels that K7's dz and K11 v2's slot gradient left, built by
// dgl_tpu_torch/tools/perf_dz_slot_grad.py with the package's nvcc flags
// and timed beside the kernels that replaced them; they are not on any
// main path.  Each is the package's code as it stood before the redesign:
//
// bitdot_dz_kernel<kCols>  (csrc/bitdot.cu; replaces
//     dgl_tpu/ops/pallas/bitdot.py _bwdA_call :272): one warp a src row of
//     packed_rev, its set bits walked one at a time (walk_row: the row's
//     words one a lane, 8 in flight, zero words skipped, bits by __ffs);
//     per bit the warp gathers q[d], g[d] and [linv, rho] of d with scalar
//     loads, takes z . q and g . z per head by warp shuffles (head_sums),
//     then the exp; rows launched in id order.  Replaced by the listed walk
//     by src, bitdot_dz_list_kernel.
// vattn_slot_grad_kernel<kCols, kFe, kDef>, kFe > 0  (csrc/gatv2.cu; the
//     da, d(ef) and dWf parts of dgl_tpu/ops/pallas/gat_fused.py
//     _egatc2_dv_da_kernel :1975): a warp a 32-slot chunk, a lane kCols
//     columns of its head; fe formed per slot and column from wf and the
//     chunk's edge features in shared memory (kFe FMAs), dWf summed in kFe
//     x kCols registers a lane (kFe FMAs more), d(ef) a reduce-scatter
//     across the warp; at the end shared and then global atomics.
//     Replaced by vattn_slot_grad_mma_kernel's tensor-core products.
//
// Each is behind a plain C function that launches on the caller's stream
// and returns cudaGetLastError(), with the argument list it had in the
// package (the slot gradient's without the stored term, which stays in
// the package for K11 v1).

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

// One edge's backward terms for one head: alpha and draw from its summed
// dots z . q and u = g . z and the dst's linv and rho.
__device__ __forceinline__ void edge_grad(float zq, float u, float linv,
                                          float rho, float isd, float& alpha,
                                          float& draw) {
  const float e = zq * isd;
  alpha = clip_exp(e) * linv;
  const float de = alpha * (u - rho);
  draw = (e > -kClip && e < kClip) ? de * isd : 0.f;
}

template <int kCols>
__global__ void __launch_bounds__(kWarps * 32)
bitdot_dz_kernel(const uint32_t* __restrict__ packed_rev, int64_t k32,
                 int64_t num_src, int64_t num_dst,
                 const float* __restrict__ q, const float* __restrict__ z,
                 const float* __restrict__ g,
                 const float* __restrict__ nvec,  // (num_dst, 2, H)
                 int heads, int dim, float isd, float* __restrict__ dz) {
  const int lane = threadIdx.x & 31;
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (s >= num_src) return;  // warp-uniform
  const int hd = heads * dim;
  const Columns<kCols> c(lane, heads, dim);
  float zv[kCols], acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    zv[k] = c.head[k] >= 0 ? __ldg(z + s * hd + c.f[k]) : 0.f;
    acc[k] = 0.f;
  }
  walk_row(packed_rev, k32, s, num_dst, lane, [&](int64_t d) {
    const float* nv = nvec + d * 2 * heads;
    float qv[kCols], gv[kCols], linv[kCols], rho[kCols], dot[2][kCols];
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const bool valid = c.head[k] >= 0;
      const int h = valid ? c.head[k] : 0;
      qv[k] = valid ? __ldg(q + d * hd + c.f[k]) : 0.f;
      gv[k] = valid ? __ldg(g + d * hd + c.f[k]) : 0.f;
      linv[k] = __ldg(nv + h);
      rho[k] = __ldg(nv + heads + h);
      dot[0][k] = zv[k] * qv[k];
      dot[1][k] = gv[k] * zv[k];
    }
    head_sums<2, kCols>(dot, c, heads, dim);
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      if (c.head[k] < 0) continue;
      float alpha, draw;
      edge_grad(dot[0][k], dot[1][k], linv[k], rho[k], isd, alpha, draw);
      acc[k] += draw * qv[k] + alpha * gv[k];
    }
  });
#pragma unroll
  for (int k = 0; k < kCols; ++k)
    if (c.head[k] >= 0) dz[s * hd + c.f[k]] = acc[k];
}

dim3 rows_grid(int64_t rows) {
  return dim3(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
}

// -- K11 v2's slot gradient, the edge instances ---------------------------

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

// v[F] of each lane summed over the warp, index by index: returns the
// total of index lane % F.  F - 1 shuffles halve the indices a lane keeps,
// then log2(32 / F) shuffles sum across the lanes that kept the same one.
template <int F>
__device__ __forceinline__ float reduce_scatter(float (&v)[F], int lane) {
#pragma unroll
  for (int s = F / 2; s >= 1; s >>= 1) {
    const bool up = (lane & s) != 0;
#pragma unroll
    for (int i = 0; i < s; ++i) {
      const float send = up ? v[i] : v[i + s];
      const float keep = up ? v[i + s] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, s);
    }
  }
  float r = v[0];
#pragma unroll
  for (int s = F; s < 32; s <<= 1) r += __shfl_xor_sync(kFull, r, s);
  return r;
}

template <int kCols, int kFe, bool kDef, typename T = float,
          bool kStore = false>
__global__ void __launch_bounds__(kWarps * 32)
vattn_slot_grad_kernel(const int* __restrict__ src_local,
                       const int* __restrict__ dst_local,
                       const float* __restrict__ valid,
                       const int* __restrict__ src_tile,
                       const int* __restrict__ dst_tile, int num_buckets,
                       int tile, int cap, const float* __restrict__ u,
                       const float* __restrict__ v,
                       const float* __restrict__ attn,
                       const float* __restrict__ ds,
                       const float* __restrict__ ef,
                       const float* __restrict__ wf, int fe, int fe_rows,
                       int heads, int dim, int lanes, float slope,
                       float* __restrict__ da, float* __restrict__ def,
                       float* __restrict__ dwf, const T* __restrict__ fe_s,
                       T* __restrict__ dfe_s) {
  constexpr bool kEdge = kFe > 0;
  constexpr int kF = kEdge ? kFe : 1;
  constexpr int kP = kDef ? kFe : 1;  // d(ef) partial sums of a slot
  extern __shared__ float smem[];
  const int hd = heads * dim;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = kEdge ? fe_rows : 0;
  float* attn_s = smem;                 // [hd]
  float* da_s = attn_s + hd;            // [hd]: the block's sums
  float* wf_s = da_s + hd;              // [fe_rows][hd]
  float* dwf_s = wf_s + rows * hd;      // [fe_rows][hd]: the block's sums
  float* ef_s = dwf_s + rows * hd + warp * 32 * rows;  // [32][fe_rows]
  for (int i = threadIdx.x; i < hd; i += blockDim.x) {
    attn_s[i] = attn[i];
    da_s[i] = 0.f;
  }
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    wf_s[i] = wf[i];
    dwf_s[i] = 0.f;
  }
  __syncthreads();

  const int heads_per_pass = 32 / lanes;
  const int hl = lane / lanes;
  const int fl = lane % lanes;
  const int span = lanes * kCols;  // columns of a head one group covers
  const int per_bucket = cap / 32;
  const int n_chunks = num_buckets * per_bucket;
  bool first = true;  // the first group writes d(ef), later ones add to it
  for (int h0 = 0; h0 < heads; h0 += heads_per_pass) {
    const int h = h0 + hl;
    for (int g0 = 0; g0 < dim; g0 += span) {
      int col[kCols];
      bool ok[kCols];
      float acc_a[kCols];
      float acc_w[kF][kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int d = g0 + fl + i * lanes;
        ok[i] = h < heads && d < dim;
        col[i] = ok[i] ? h * dim + d : 0;
        acc_a[i] = 0.f;
#pragma unroll
        for (int r = 0; r < kF; ++r) acc_w[r][i] = 0.f;
      }
      for (int k = blockIdx.x * kWarps + warp; k < n_chunks;
           k += gridDim.x * kWarps) {
        const int b = k / per_bucket;
        const int c0 = (k % per_bucket) * 32;
        const int s0 = b * cap + c0;
        const float vld = valid[s0 + lane];
        if (__ballot_sync(kFull, vld != 0.f) == 0u) {  // a padded tail
          if (kDef && first) {
            for (int i = lane; i < 32 * fe; i += 32) {
              def[static_cast<long long>(s0) * fe + i] = 0.f;
            }
          }
          if (kStore) {
            for (int j = 0; j < 32; ++j) {
#pragma unroll
              for (int i = 0; i < kCols; ++i) {
                if (ok[i]) {
                  st_slot(dfe_s, static_cast<long long>(s0 + j) * hd + col[i],
                          0.f);
                }
              }
            }
          }
          continue;
        }
        const int sl = src_local[s0 + lane];
        const int dl = dst_local[s0 + lane];
        const float* dsb = ds + b * heads * cap + c0;
        if (kEdge) load_ef_chunk(ef, s0, fe, fe_rows, ef_s, lane);
        const float* ut = u + static_cast<long long>(src_tile[b]) * tile * hd;
        const float* vt = v + static_cast<long long>(dst_tile[b]) * tile * hd;
        for (int j = 0; j < 32; ++j) {
          const bool live = __shfl_sync(kFull, vld, j) != 0.f;  // uniform
          const float* ur = ut + __shfl_sync(kFull, sl, j) * hd;
          const float* vr = vt + __shfl_sync(kFull, dl, j) * hd;
          float part[kP];
#pragma unroll
          for (int r = 0; r < kP; ++r) part[r] = 0.f;
          if (live) {
            const float dsh = h < heads ? __ldg(dsb + h * cap + j) : 0.f;
            const float* e = ef_s + j * rows;
#pragma unroll
            for (int i = 0; i < kCols; ++i) {
              if (!ok[i]) continue;
              const int c = col[i];
              const long long fo = static_cast<long long>(s0 + j) * hd + c;
              float raw = __ldg(ur + c) + __ldg(vr + c);
              if (kEdge) {
#pragma unroll
                for (int r = 0; r < kF; ++r) {
                  if (r < fe_rows) raw += e[r] * wf_s[r * hd + c];
                }
              }
              if (kStore) raw += ld_slot(fe_s, fo);
              const bool pos = raw >= 0.f;
              acc_a[i] += dsh * (pos ? raw : slope * raw);
              if (kStore) {
                st_slot(dfe_s, fo, dsh * attn_s[c] * (pos ? 1.f : slope));
              }
              if (kEdge) {
                const float dw = dsh * attn_s[c] * (pos ? 1.f : slope);
#pragma unroll
                for (int r = 0; r < kF; ++r) {
                  if (r < fe_rows) {
                    acc_w[r][i] += e[r] * dw;
                    if (kDef) part[kDef ? r : 0] += wf_s[r * hd + c] * dw;
                  }
                }
              }
            }
          }
          if (kStore && !live) {
#pragma unroll
            for (int i = 0; i < kCols; ++i) {
              if (ok[i]) {
                st_slot(dfe_s, static_cast<long long>(s0 + j) * hd + col[i],
                        0.f);
              }
            }
          }
          if (kDef) {
            const float tot = reduce_scatter<kP>(part, lane);
            if (lane < fe) {
              float* d = def + static_cast<long long>(s0 + j) * fe + lane;
              *d = first ? tot : *d + tot;
            }
          }
        }
        if (kEdge) __syncwarp();  // ef_s is rewritten by the next chunk
      }
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        if (!ok[i]) continue;
        atomicAdd(da_s + col[i], acc_a[i]);
#pragma unroll
        for (int r = 0; r < kF; ++r) {
          if (kEdge && r < fe_rows) {
            atomicAdd(dwf_s + r * hd + col[i], acc_w[r][i]);
          }
        }
      }
      first = false;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < hd; i += blockDim.x) {
    if (da_s[i] != 0.f) atomicAdd(da + i, da_s[i]);
  }
  for (int i = threadIdx.x; i < rows * hd; i += blockDim.x) {
    if (dwf_s[i] != 0.f) atomicAdd(dwf + i, dwf_s[i]);
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

struct Operands {
  const float* u;
  const float* v;
  const float* attn;
  const float* ef;
  const float* wf;
  int fe, fe_rows, heads, dim;
  float slope;
};

template <int kCols, int kFe, bool kDef, typename T = float,
          bool kStore = false>
cudaError_t launch_slot_grad(Slots sl, int num_buckets, int tile, int cap,
                             Operands op, const float* ds, int lanes,
                             float* da, float* def, float* dwf,
                             const void* fe_s, void* dfe_s, int blocks,
                             cudaStream_t stream) {
  const int hd = op.heads * op.dim;
  const int rows = kFe > 0 ? op.fe_rows : 0;
  const size_t smem =
      sizeof(float) * (2 * hd + 2 * rows * hd + kWarps * 32 * rows);
  const cudaError_t err =
      allow_smem(vattn_slot_grad_kernel<kCols, kFe, kDef, T, kStore>, smem);
  if (err != cudaSuccess) return err;
  vattn_slot_grad_kernel<kCols, kFe, kDef, T, kStore><<<blocks, kWarps * 32,
                                                        smem, stream>>>(
      sl.src_local, sl.dst_local, sl.valid, sl.src_tile, sl.dst_tile,
      num_buckets, tile, cap, op.u, op.v, op.attn, ds, op.ef, op.wf, op.fe,
      op.fe_rows, op.heads, op.dim, lanes, op.slope, da, def, dwf,
      static_cast<const T*>(fe_s), static_cast<T*>(dfe_s));
  return cudaGetLastError();
}

Slots slots(const void* src_local, const void* dst_local, const void* valid,
            const void* src_tile, const void* dst_tile) {
  return Slots{static_cast<const int*>(src_local),
               static_cast<const int*>(dst_local),
               static_cast<const float*>(valid),
               static_cast<const int*>(src_tile),
               static_cast<const int*>(dst_tile)};
}

Operands operands(const void* u, const void* v, const void* attn,
                  const void* ef, const void* wf, int64_t fe,
                  int64_t fe_rows, int64_t heads, int64_t dim, double slope) {
  return Operands{static_cast<const float*>(u),
                  static_cast<const float*>(v),
                  static_cast<const float*>(attn),
                  static_cast<const float*>(ef),
                  static_cast<const float*>(wf),
                  static_cast<int>(fe),
                  static_cast<int>(fe_rows),
                  static_cast<int>(heads),
                  static_cast<int>(dim),
                  static_cast<float>(slope)};
}

}  // namespace

extern "C" {

// bitdot_dz_kernel: dz (num_src, H, D) over packed_rev (rows = src, k32
// words), q, z, g (H * D <= 128) and nvec (num_dst, 2, H) = [linv, rho],
// f32 and contiguous.  Grid: ceil(num_src / 8) blocks of 8 warps.
int dgl_probe_dz_warp(const void* packed_rev, int64_t k32, int64_t num_src,
                      int64_t num_dst, const void* q, const void* z,
                      const void* g, const void* nvec, int64_t heads,
                      int64_t dim, float isd, void* dz, int64_t device,
                      void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DGL_DZ(C)                                                           \
  bitdot_dz_kernel<C><<<rows_grid(num_src), kWarps * 32, 0, st>>>(         \
      static_cast<const uint32_t*>(packed_rev), k32, num_src, num_dst,      \
      static_cast<const float*>(q), static_cast<const float*>(z),           \
      static_cast<const float*>(g), static_cast<const float*>(nvec),        \
      static_cast<int>(heads), static_cast<int>(dim), isd,                  \
      static_cast<float*>(dz))
  switch ((heads * dim + 31) / 32) {
    case 1: DGL_DZ(1); break;
    case 2: DGL_DZ(2); break;
    case 3: DGL_DZ(3); break;
    case 4: DGL_DZ(4); break;
    default: return cudaErrorInvalidValue;
  }
#undef DGL_DZ
  return cudaGetLastError();
}

// vattn_slot_grad_kernel's edge instances: da (heads * dim) += the block
// sums of ds[h] * lrelu(raw), dwf (fe_rows, heads * dim) += sum ef[s, k]
// dW and, with def not null, def (num_buckets * cap, fe) = sum_c wf[k, c]
// dW, every element written.  da and dwf must be zeroed by the caller.
// cols (1, 2 or 4; at most 2 with fe_cap 32 and def): the columns of its
// head a lane keeps at once; fe_cap (8, 16 or 32 >= fe_rows).  Grid:
// `blocks` blocks of 8 warps.
int dgl_probe_slot_grad_tiled(const void* src_local, const void* dst_local,
                              const void* valid, const void* src_tile,
                              const void* dst_tile, int64_t num_buckets,
                              int64_t tile, int64_t cap, const void* u,
                              const void* v, const void* attn,
                              const void* ds, const void* ef, const void* wf,
                              int64_t fe, int64_t fe_rows, int64_t heads,
                              int64_t dim, int64_t lanes, int64_t cols,
                              int64_t fe_cap, double slope, void* da,
                              void* def, void* dwf, int64_t blocks,
                              int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Slots sl = slots(src_local, dst_local, valid, src_tile, dst_tile);
  const Operands op = operands(u, v, attn, ef, wf, fe, fe_rows, heads, dim,
                               slope);
  const bool with_def = def != nullptr;
#define DGL_GRAD_CASE(COLS_, FE_, DEF_)                                      \
  if (cols == COLS_ && fe_cap == FE_ && with_def == DEF_) {                  \
    return launch_slot_grad<COLS_, FE_, DEF_>(                               \
        sl, static_cast<int>(num_buckets), static_cast<int>(tile),           \
        static_cast<int>(cap), op, static_cast<const float*>(ds),            \
        static_cast<int>(lanes), static_cast<float*>(da),                    \
        static_cast<float*>(def), static_cast<float*>(dwf), nullptr,         \
        nullptr, static_cast<int>(blocks), s);                               \
  }
  DGL_GRAD_CASE(1, 8, false)
  DGL_GRAD_CASE(2, 8, false)
  DGL_GRAD_CASE(4, 8, false)
  DGL_GRAD_CASE(1, 16, false)
  DGL_GRAD_CASE(2, 16, false)
  DGL_GRAD_CASE(4, 16, false)
  DGL_GRAD_CASE(1, 32, false)
  DGL_GRAD_CASE(2, 32, false)
  DGL_GRAD_CASE(4, 32, false)
  DGL_GRAD_CASE(1, 8, true)
  DGL_GRAD_CASE(2, 8, true)
  DGL_GRAD_CASE(4, 8, true)
  DGL_GRAD_CASE(1, 16, true)
  DGL_GRAD_CASE(2, 16, true)
  DGL_GRAD_CASE(4, 16, true)
  DGL_GRAD_CASE(1, 32, true)
  DGL_GRAD_CASE(2, 32, true)
#undef DGL_GRAD_CASE
  return cudaErrorInvalidValue;
}

// The registers a thread and the local memory bytes a thread of
// vattn_slot_grad_kernel<cols, fe_cap, with_def> (two host ints).
int dgl_probe_slot_grad_attrs(int64_t cols, int64_t fe_cap, int64_t with_def,
                              int64_t device, void* attrs) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  int* out = static_cast<int*>(attrs);
  cudaFuncAttributes attr;
#define DGL_ATTRS_CASE(COLS_, FE_, DEF_)                                     \
  if (cols == COLS_ && fe_cap == FE_ && (with_def != 0) == DEF_) {           \
    const cudaError_t e = cudaFuncGetAttributes(                             \
        &attr, vattn_slot_grad_kernel<COLS_, FE_, DEF_>);                    \
    out[0] = attr.numRegs;                                                   \
    out[1] = static_cast<int>(attr.localSizeBytes);                          \
    return e;                                                                \
  }
  DGL_ATTRS_CASE(1, 16, false)
  DGL_ATTRS_CASE(2, 16, false)
  DGL_ATTRS_CASE(4, 16, false)
  DGL_ATTRS_CASE(1, 32, false)
  DGL_ATTRS_CASE(2, 32, false)
  DGL_ATTRS_CASE(4, 32, false)
  DGL_ATTRS_CASE(1, 32, true)
  DGL_ATTRS_CASE(2, 32, true)
#undef DGL_ATTRS_CASE
  return cudaErrorInvalidValue;
}

}  // extern "C"
