// Vector attention on Hopper (K9: GATv2, K11 v2: EGATConv) over the tiled
// format.
//
// Format (dgl_tpu_torch/ops/kernels/tiled_spmm.py):
// edges bucketed by (dst tile, src tile) pairs of `tile` nodes, `cap`
// slots per bucket; for flat slot s = b * cap + c, src_local[s] /
// dst_local[s] are ids within tiles src_tile[b] / dst_tile[b], and
// valid[s] is 1 for a real edge.  Padded slots alias row 0 of their tiles;
// every kernel here skips or zeroes a slot whose valid is 0.  dst tile t
// owns the buckets [dst_ptr[t], dst_ptr[t + 1]); src tile t owns the
// buckets src_order[src_ptr[t] .. src_ptr[t + 1]).  Slot tensors p and ds
// are (B, H, C) f32.
//
// The functions of dgl_tpu/ops/pallas/gat_fused.py:663-668 and :1946-1952:
// for every valid slot of an edge src -> dst, head h and column c = h * D
// + d of the H * D columns,
//   raw[c] = u[src, c] + v[dst, c] (+ fe[c]),  fe = ef[s, :] . wf[:fe, c]
//            (+ wf[fe, c], the bias row, when wf has fe + 1 rows)
//   p[h]   = exp(clip(sum_d attn[c] * lrelu(raw[c]), +-40))
//   dW[c]  = ds[h] * attn[c] * lrelu'(raw[c])
//   da[c]  = sum_slots ds[h] * lrelu(raw[c])
//   def[s, k] = sum_c wf[k, c] * dW[c],  dwf[k, c] = sum_slots ef[s, k] dW[c]
//   dv[dst] = sum dW,  du[src] = sum dW
// u, v: (num_src, H * D), (num_dst, H * D); attn (H * D); ef (B * C, fe)
// in slot order, 0 at padded slots; wf (fe_rows, H * D).  The softmax's
// den, numerator, ds and dx are K6's and K4's kernels (csrc/gat_fused.cu,
// csrc/row_agg.cu).
//
// One kernel, with its finishing pass, serves K11 v2's slot gradient (K9's
// scores, node gradient and da, K11 v2's node gradient, both K11's scores
// and K11 v1's slot gradient are the walks of csrc/row_agg.cu: K11 v2's
// node gradient, the dv part of _egatc2_dv_da_kernel :1975 and
// _egatc2_du_kernel :2024, is its row_fe_grad_kernel; the tiled walk it
// replaced, vattn_node_grad_kernel, a block per (tile, column chunk,
// split) adding each slot's dW into shared memory with a float atomicAdd,
// is built by dgl_tpu_torch/tools/perf_dq_node_grad.py from
// tools/dq_node_grad_probe.cu and timed beside it; the scores,
// _egatc2_scores_kernel :1955 and _egatc_scores_kernel :959, are its
// dot-product walk by dst in the scores mode, row_vattn_fe_kernel with the
// edge term formed per entry and row_sddmm_kernel<CPL, true, true, T> with
// the stored one, and the bucket walk they replaced, a warp a 32-slot
// chunk gathering U[src] and V[dst] with scalar loads at every slot, is
// built by dgl_tpu_torch/tools/perf_fwd_scores.py from
// tools/fwd_scores_probe.cu; K11 v1's slot gradient, the da, dFE and dv
// parts of _egatc_dv_da_dfe_kernel :979, is its slot walk's sibling by dst,
// row_slot_grad_kernel, and the bucket walk it replaced,
// vattn_slot_grad_kernel<C, T, true>, is built by
// dgl_tpu_torch/tools/perf_slot_grad_scores.py from
// tools/slot_grad_scores_probe.cu); it is behind a plain C function that
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError():
//
// vattn_slot_grad_mma_kernel<KS, kDef>  replaces the da, d(ef) and dWf
//     parts of _egatc2_dv_da_kernel (:1975, egatc2_backward :2167), which
//     contract fe = ef wf (:2014's operand), d(ef) = wf dW^T (:2014) and
//     dWf += ef^T dW (:2018) on the matrix unit.  Here they are m16n8k16
//     bf16 mma.sync products with f32 sums over chunks of 32 slots: a
//     block takes a static range of chunks and stages each chunk's slot
//     arrays, ds and edge features in shared memory with cp.async, the next
//     chunk in flight while this one is contracted; a warp owns a 32-column
//     slice of the H * D columns, gathers its slice of u[src] and v[dst] in
//     16-byte loads straight into the accumulator of FE^T = WF^T EF^T
//     (its rows permuted so that a lane's four columns are contiguous),
//     forms raw, da's partial and dW there, and adds dWf^T += dW^T EF with
//     dW's fragments as they stand (the accumulator's layout is mma's A
//     layout) and EF's by ldmatrix.trans; d(ef) (kDef) is WF dW^T, dW^T's
//     fragments transposed by movmatrix, the warps' partials summed in warp
//     order in shared memory.  Operands are cut into three bf16 parts
//     (int8mm.cu's split), keeping the 6 of 9 products whose part indices
//     sum below 3: about f32's accuracy, and exact on dyadic inputs of few
//     bits.  The bias row is added to raw and summed in f32.  Each block
//     writes its da and dWf partials once to a scratch and
//     vattn_grad_finish_kernel adds them in block order: no atomics, the
//     same bits every run.  It replaced the edge instances of
//     vattn_slot_grad_kernel (a lane a few columns, 17 FMAs for fe and 17
//     for dWf a slot and column on the f32 pipes, shared and global atomics
//     at the end), built by dgl_tpu_torch/tools/perf_dz_slot_grad.py from
//     tools/dz_slot_grad_probe.cu and timed beside it (PERF.md).
//
// The TPU kernels contract one-hot matrices on the matrix unit, embed attn
// in a head-block-diagonal matrix Ra and lane-pad each head; here a lane
// reads attn and its columns directly.  Sums are f32; the TPU kernels cast
// operands to bf16.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32, 989 TFLOP/s bf16 on the
// tensor cores): each kernel streams the slot arrays (12 B a slot), 4 B a
// slot and head of p or ds, and with the edge term 4 B a slot and edge
// feature; the node rows it gathers are mostly L2 hits.  Operations: about
// 4 per slot and column (plus 2 per edge feature for fe, and 4 more for
// d(ef) and dWf), so the kernels without the edge term are bound by bytes
// and those with it come close to the f32 rate on the f32 pipes; the slot
// gradient's contractions go to the tensor cores at 6 bf16 products each.  chip_smoke.py prints each bound at the main path's
// shapes.  Indices are int32: the wrappers check that every flat size
// fits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// -- K11 v2's slot gradient on the tensor cores --------------------------------

constexpr int kChunk = 32;      // slots a chunk
constexpr int kSliceWarps = 4;  // warps a block, a 32-column slice each
constexpr int kSplit = 3;       // bf16 parts of each operand of a product

// The bits of v's three bf16 parts, hi + mid + lo = v: each part is the top
// 16 bits of what the parts before it leave, so each subtraction is exact
// (csrc/int8mm.cu's split, which K12 takes).
__device__ __forceinline__ void split3(float v, uint32_t (&p)[3]) {
  const uint32_t hi = __float_as_uint(v) & 0xFFFF0000u;
  const float r1 = v - __uint_as_float(hi);
  const uint32_t mid = __float_as_uint(r1) & 0xFFFF0000u;
  const float r2 = r1 - __uint_as_float(mid);
  p[0] = hi >> 16;
  p[1] = mid >> 16;
  p[2] = __float_as_uint(r2) >> 16;
}

// d += a b for the m16n8k16 fragments of bf16 a and b, f32 d.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Four 8 x 8 b16 matrices from shared memory, lane L giving the address of
// row L % 8 of matrix L / 8; with kTrans each lane gets the transpose's.
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (kTrans) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a)
        : "memory");
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a)
        : "memory");
  }
}

// The transpose of an 8 x 8 b16 matrix held a 32-bit register a lane.
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;"
               : "=r"(y)
               : "r"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One chunk's stage in shared memory: its slot ids and valid, ds of the
// pass's heads and the f32 edge-feature rows, 128 (3 + nh + fe) bytes.
struct GradStage {
  int* sl;
  int* dl;
  float* vld;
  float* ds;  // [nh][kChunk]
  float* ef;  // [kChunk][fe]
};

__device__ __forceinline__ GradStage grad_stage(unsigned char* base, int nh) {
  GradStage g;
  g.sl = reinterpret_cast<int*>(base);
  g.dl = g.sl + kChunk;
  g.vld = reinterpret_cast<float*>(g.dl + kChunk);
  g.ds = g.vld + kChunk;
  g.ef = g.ds + nh * kChunk;
  return g;
}

// The block's asynchronous copies of chunk k (slots 32 k .. 32 k + 31):
// 16 bytes a copy, every source 16-byte aligned (the wrapper checks the
// bases; cap is a multiple of 32).
__device__ __forceinline__ void stage_chunk(
    const GradStage& st, int k, int per_bucket, int cap, int heads, int h_lo,
    int nh, int fe, const int* __restrict__ src_local,
    const int* __restrict__ dst_local, const float* __restrict__ valid,
    const float* __restrict__ ds, const float* __restrict__ ef) {
  const long long s0 = static_cast<long long>(k) * kChunk;
  const int b = k / per_bucket;
  const int c0 = (k - b * per_bucket) * kChunk;
  const int n = 24 + 8 * nh + 8 * fe;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (i < 8) {
      cp_async16(st.sl + 4 * i, src_local + s0 + 4 * i);
    } else if (i < 16) {
      cp_async16(st.dl + 4 * (i - 8), dst_local + s0 + 4 * (i - 8));
    } else if (i < 24) {
      cp_async16(st.vld + 4 * (i - 16), valid + s0 + 4 * (i - 16));
    } else if (i < 24 + 8 * nh) {
      const int r = (i - 24) >> 3, q = (i - 24) & 7;
      cp_async16(st.ds + r * kChunk + 4 * q,
                 ds + (static_cast<long long>(b) * heads + h_lo + r) * cap +
                     c0 + 4 * q);
    } else {
      const int q = i - 24 - 8 * nh;
      cp_async16(st.ef + 4 * q, ef + s0 * fe + 4 * q);
    }
  }
}

// K11 v2's slot gradient: a block takes a static range of 32-slot chunks
// and each warp a 32-column slice of the H * D columns (passes of up to
// kSliceWarps slices, the chunks staged again for each pass).  Lane (g, t)
// of a warp owns the slice's columns 4 g .. 4 g + 3 (one 16-byte load of a
// node row) and, per 16-slot step, slots 8 ni + 2 t + e (ni, e < 2): the
// m16n8k16 accumulator of FE^T = WF^T EF^T with its rows (the columns)
// permuted so that row g + 8 hi of m-tile mi is column 4 g + 2 mi + hi.
// KS k-steps of 16 edge features (KP = 16 KS, zero past fe); the bias row
// of wf is added in f32, not contracted.  Sums are f32, the operands of the
// products cut into kSplit bf16 parts, keeping the products whose part
// indices sum below kSplit (6 of 9 at 3 parts).
template <int KS, bool kDef>
__global__ void __launch_bounds__(kSliceWarps * 32)
vattn_slot_grad_mma_kernel(
    const int* __restrict__ src_local, const int* __restrict__ dst_local,
    const float* __restrict__ valid, const int* __restrict__ src_tile,
    const int* __restrict__ dst_tile, int num_buckets, int tile, int cap,
    const float* __restrict__ u, const float* __restrict__ v, int ld,
    const float* __restrict__ attn, const float* __restrict__ ds,
    const float* __restrict__ ef, const float* __restrict__ wf, int fe,
    int has_bias, int heads, int dim, float slope, int nh_max,
    float* __restrict__ def, float* __restrict__ part) {
  constexpr int KP = 16 * KS;
  constexpr int RS = KP + 8;  // a parts row, bf16: 16-byte rows, no bank
                              // conflict for ldmatrix
  constexpr int NJ = 2 * KS;  // n-tiles of dWf^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hd = heads * dim;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nsl = (hd + 31) / 32;
  const int per_bucket = cap / kChunk;
  const int n_chunks = num_buckets * per_bucket;
  const int k_lo = static_cast<int>(static_cast<long long>(n_chunks) *
                                    blockIdx.x / gridDim.x);
  const int k_hi = static_cast<int>(static_cast<long long>(n_chunks) *
                                    (blockIdx.x + 1) / gridDim.x);
  const int stage_bytes = 128 * (3 + nh_max + fe);
  uint16_t* efp = reinterpret_cast<uint16_t*>(smem_raw + 2 * stage_bytes);
  float* defp = reinterpret_cast<float*>(efp + kSplit * kChunk * RS);
  const int rows = fe + has_bias;
  float* my_part = part + static_cast<long long>(blockIdx.x) * (rows + 1) *
                             hd;

  for (int c_lo = 0; c_lo < hd; c_lo += nwarps * 32) {  // passes
    const int slice = c_lo / 32 + warp;
    const bool active = slice < nsl;  // warp-uniform
    const int pass_warps = min(nwarps, nsl - c_lo / 32);
    const int col0 = slice * 32;
    const int h_lo = c_lo / dim;
    const int nh = (min(hd, c_lo + nwarps * 32) - 1) / dim + 1 - h_lo;
    // the lane's columns: attn, the bias row and the stage's ds row
    bool cok[4];
    float at[4], bias[4];
    int hr[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + 4 * g + j;
      cok[j] = active && c < hd;
      at[j] = cok[j] ? __ldg(attn + c) : 0.f;
      bias[j] = cok[j] && has_bias ? __ldg(wf + fe * hd + c) : 0.f;
      hr[j] = cok[j] ? c / dim - h_lo : 0;
    }
    // WF^T's A fragments: reg i holds (row g + 8 (i & 1), k 2t + 8 (i >> 1)
    // + half) of m-tile mi, k-step ks
    uint32_t wa[kSplit][2][KS][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = col0 + 4 * g + 2 * mi + (i & 1);
          const int k0 = 16 * ks + 2 * t + 8 * (i >> 1);
          const bool on = active && c < hd;
          uint32_t p0[3], p1[3];
          split3(on && k0 < fe ? __ldg(wf + k0 * hd + c) : 0.f, p0);
          split3(on && k0 + 1 < fe ? __ldg(wf + (k0 + 1) * hd + c) : 0.f, p1);
#pragma unroll
          for (int p = 0; p < kSplit; ++p)
            wa[p][mi][ks][i] = p0[p] | p1[p] << 16;
        }
    float dwacc[2][NJ][4];  // dWf^T: (column, feature) of the slice
    float da_acc[4], db_acc[4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
        for (int c = 0; c < 4; ++c) dwacc[mi][nj][c] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) da_acc[j] = db_acc[j] = 0.f;

    if (k_lo < k_hi) {
      stage_chunk(grad_stage(smem_raw, nh_max), k_lo, per_bucket, cap, heads,
                  h_lo, nh, fe, src_local, dst_local, valid, ds, ef);
    }
    cp_async_commit();
    for (int k = k_lo; k < k_hi; ++k) {  // double-buffered stages
      const GradStage cur =
          grad_stage(smem_raw + ((k - k_lo) & 1) * stage_bytes, nh_max);
      if (k + 1 < k_hi) {
        stage_chunk(
            grad_stage(smem_raw + ((k + 1 - k_lo) & 1) * stage_bytes, nh_max),
            k + 1, per_bucket, cap, heads, h_lo, nh, fe, src_local, dst_local,
            valid, ds, ef);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this chunk's copies have landed
      __syncthreads();
      const long long s0 = static_cast<long long>(k) * kChunk;
      // the same for every warp of the block
      if (__ballot_sync(kFull, cur.vld[lane] != 0.f) == 0u) {  // padded
        if (kDef && c_lo == 0) {
          for (int i = threadIdx.x; i < kChunk * fe; i += blockDim.x)
            def[s0 * fe + i] = 0.f;
        }
        __syncthreads();
        continue;
      }
      // the edge features' bf16 parts, [part][slot][feature]
      for (int i = threadIdx.x; i < kChunk * KP; i += blockDim.x) {
        const int m = i / KP, kk = i - m * KP;
        uint32_t pp[3];
        split3(kk < fe ? cur.ef[m * fe + kk] : 0.f, pp);
#pragma unroll
        for (int p = 0; p < kSplit; ++p)
          efp[(p * kChunk + m) * RS + kk] = static_cast<uint16_t>(pp[p]);
      }
      __syncthreads();
      if (active) {
        const int b = k / per_bucket;
        const float* ut =
            u + static_cast<long long>(src_tile[b]) * tile * ld + col0 + 4 * g;
        const float* vt =
            v + static_cast<long long>(dst_tile[b]) * tile * ld + col0 + 4 * g;
        const bool load = col0 + 4 * g < hd;
#pragma unroll
        for (int step = 0; step < 2; ++step) {
          // raw's start, U + V + the bias row, in the accumulator
          float acc[2][2][4];
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int m = 16 * step + 8 * ni + 2 * t + e;
              const bool on = load && cur.vld[m] != 0.f;
              const float4 a =
                  on ? __ldg(reinterpret_cast<const float4*>(
                           ut + static_cast<long long>(cur.sl[m]) * ld))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
              const float4 c =
                  on ? __ldg(reinterpret_cast<const float4*>(
                           vt + static_cast<long long>(cur.dl[m]) * ld))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
              const float w[4] = {__fadd_rn(a.x, c.x), __fadd_rn(a.y, c.y),
                                  __fadd_rn(a.z, c.z), __fadd_rn(a.w, c.w)};
#pragma unroll
              for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int hi = 0; hi < 2; ++hi)
                  acc[mi][ni][2 * hi + e] =
                      __fadd_rn(w[2 * mi + hi], bias[2 * mi + hi]);
            }
          // FE^T += WF^T EF^T: EF^T's B fragments by ldmatrix of the
          // [slot][feature] parts (matrix i: slots 8 (i / 2), features 8
          // (i % 2) of the k-step)
          uint32_t be[kSplit][KS][4];
#pragma unroll
          for (int p = 0; p < kSplit; ++p)
#pragma unroll
            for (int ks = 0; ks < KS; ++ks)
              ldsm_x4<false>(be[p][ks],
                             efp + (p * kChunk + 16 * step + 8 * (lane >> 4) +
                                    (lane & 7)) * RS +
                                 16 * ks + 8 * ((lane >> 3) & 1));
#pragma unroll
          for (int sum = kSplit - 1; sum >= 0; --sum)  // the smallest first
#pragma unroll
            for (int pa = 0; pa <= sum; ++pa)
#pragma unroll
              for (int ks = 0; ks < KS; ++ks)
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                  for (int ni = 0; ni < 2; ++ni)
                    mma_bf16(acc[mi][ni], wa[pa][mi][ks],
                             make_uint2(be[sum - pa][ks][2 * ni],
                                        be[sum - pa][ks][2 * ni + 1]));
          // the elementwise step: da, the bias row's sum and dW in place,
          // each product and sum rounded as the plain version rounds it
          // (never fused, so every instance sums the same bits)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int hi = 0; hi < 2; ++hi)
#pragma unroll
              for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int j = 2 * mi + hi;
                  const int m = 16 * step + 8 * ni + 2 * t + e;
                  const bool live = cok[j] && cur.vld[m] != 0.f;
                  const float raw = acc[mi][ni][2 * hi + e];
                  const float dsv = live ? cur.ds[hr[j] * kChunk + m] : 0.f;
                  const bool pos = raw >= 0.f;
                  if (live) {
                    da_acc[j] = __fadd_rn(
                        da_acc[j],
                        __fmul_rn(dsv, pos ? raw : __fmul_rn(slope, raw)));
                  }
                  const float dw =
                      live ? __fmul_rn(__fmul_rn(dsv, at[j]),
                                       pos ? 1.f : slope)
                           : 0.f;
                  db_acc[j] = __fadd_rn(db_acc[j], dw);
                  acc[mi][ni][2 * hi + e] = dw;
                }
          // dW^T's parts as A fragments (the accumulator's layout is
          // mma's A layout: rows the columns, k the step's slots)
          uint32_t adw[kSplit][2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              uint32_t p0[3], p1[3];
              split3(acc[mi][i >> 1][2 * (i & 1)], p0);
              split3(acc[mi][i >> 1][2 * (i & 1) + 1], p1);
#pragma unroll
              for (int p = 0; p < kSplit; ++p)
                adw[p][mi][i] = p0[p] | p1[p] << 16;
            }
          // dWf^T += dW^T EF: EF's B fragments by ldmatrix.trans (matrix
          // i: slots 8 (i % 2), features 8 (2 jp + i / 2))
#pragma unroll
          for (int jp = 0; jp < KS; ++jp) {
            uint32_t bt[kSplit][4];
#pragma unroll
            for (int p = 0; p < kSplit; ++p)
              ldsm_x4<true>(bt[p],
                            efp + (p * kChunk + 16 * step +
                                   8 * ((lane >> 3) & 1) + (lane & 7)) * RS +
                                8 * (2 * jp + (lane >> 4)));
#pragma unroll
            for (int sum = kSplit - 1; sum >= 0; --sum)
#pragma unroll
              for (int pa = 0; pa <= sum; ++pa)
#pragma unroll
                for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                  for (int q = 0; q < 2; ++q)
                    mma_bf16(dwacc[mi][2 * jp + q], adw[pa][mi],
                             make_uint2(bt[sum - pa][2 * q],
                                        bt[sum - pa][2 * q + 1]));
          }
          if (kDef) {
            // d(ef)^T (features x the step's slots) = WF dW^T: dW^T's B
            // fragments are the transposes of its A fragments' 8 x 8 blocks
            float dacc[KS][2][4];
#pragma unroll
            for (int mk = 0; mk < KS; ++mk)
#pragma unroll
              for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                for (int c = 0; c < 4; ++c) dacc[mk][ni][c] = 0.f;
            // WF's A fragments (rows the features, k the slice's columns in
            // the accumulator's row order) are the transposes of WF^T's
            // 8 x 8 blocks: block i of (mk, kc) is block (i % 2) 2 + i / 2
            // of WF^T's (m-tile kc, k-step mk); one k-step kc at a time
#pragma unroll
            for (int kc = 0; kc < 2; ++kc) {
              uint32_t bd[kSplit][4];
#pragma unroll
              for (int p = 0; p < kSplit; ++p)
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  bd[p][i] = transpose8(adw[p][kc][i]);
#pragma unroll
              for (int sum = kSplit - 1; sum >= 0; --sum)
#pragma unroll
                for (int pa = 0; pa <= sum; ++pa)
#pragma unroll
                  for (int mk = 0; mk < KS; ++mk) {
                    uint32_t wd[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                      wd[((i & 1) << 1) | (i >> 1)] =
                          transpose8(wa[pa][kc][mk][i]);
#pragma unroll
                    for (int ni = 0; ni < 2; ++ni)
                      mma_bf16(dacc[mk][ni], wd,
                               make_uint2(bd[sum - pa][2 * ni],
                                          bd[sum - pa][2 * ni + 1]));
                  }
            }
#pragma unroll
            for (int mk = 0; mk < KS; ++mk)
#pragma unroll
              for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  defp[(warp * kChunk + 16 * step + 8 * ni + 2 * t +
                        (c & 1)) * KP + 16 * mk + g + 8 * (c >> 1)] =
                      dacc[mk][ni][c];
          }
        }
      }
      if (kDef) {  // the warps' partials summed in warp order
        __syncthreads();
        for (int i = threadIdx.x; i < kChunk * fe; i += blockDim.x) {
          const int m = i / fe, kk = i - m * fe;
          float sum = 0.f;
          for (int w = 0; w < pass_warps; ++w)
            sum += defp[(w * kChunk + m) * KP + kk];
          float* d = def + s0 * fe + i;
          *d = c_lo == 0 ? sum : *d + sum;
        }
      }
      __syncthreads();  // the stage and the parts are rewritten next
    }
    cp_async_wait<0>();
    // da and the bias row summed over the lanes t of each g, in a fixed
    // order; the block's partials written once
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      da_acc[j] += __shfl_xor_sync(kFull, da_acc[j], 1);
      da_acc[j] += __shfl_xor_sync(kFull, da_acc[j], 2);
      db_acc[j] += __shfl_xor_sync(kFull, db_acc[j], 1);
      db_acc[j] += __shfl_xor_sync(kFull, db_acc[j], 2);
    }
    if (active) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = col0 + 4 * g + j;
        if (t != 0 || !cok[j]) continue;
        my_part[rows * hd + c] = da_acc[j];
        if (has_bias) my_part[fe * hd + c] = db_acc[j];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int col = col0 + 4 * g + 2 * mi + (c >> 1);
            const int kk = 8 * nj + 2 * t + (c & 1);
            if (col < hd && kk < fe)
              my_part[kk * hd + col] = dwacc[mi][nj][c];
          }
    }
  }
}

// dwf (rows, hd) and da (hd): the blocks' partials (blocks, rows + 1, hd)
// added in block order, every element written.
__global__ void vattn_grad_finish_kernel(const float* __restrict__ part,
                                         int blocks, int rows, int hd,
                                         float* __restrict__ dwf,
                                         float* __restrict__ da) {
  const long long n = static_cast<long long>(rows + 1) * hd;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[b * n + i];
  if (i < static_cast<long long>(rows) * hd) {
    dwf[i] = s;
  } else {
    da[i - static_cast<long long>(rows) * hd] = s;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The dynamic shared memory of vattn_slot_grad_mma_kernel.
size_t slot_grad_mma_smem(int ks, bool with_def, int warps, int nh_max,
                          int fe) {
  const size_t kp = 16 * ks;
  return 2 * 128 * static_cast<size_t>(3 + nh_max + fe) +
         2 * kSplit * kChunk * (kp + 8) +
         (with_def ? sizeof(float) * warps * kChunk * kp : 0);
}

template <typename Kernel>
cudaError_t kernel_regs(Kernel kernel, size_t smem, int warps, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, kernel,
                                                       warps * 32, smem);
}

}  // namespace

extern "C" {

// K11 v2's slot gradient on the tensor cores: da (heads * dim) and dwf
// (fe + has_bias, heads * dim), every element written, and with def not
// null def (num_buckets * cap, fe), every element written (0 at padded
// slots), from u (num_src rows) and v (num_dst rows) of ld >= heads * dim
// f32 columns (ld a multiple of 4, u and v 16-byte aligned), attn (heads *
// dim), ds (num_buckets, heads, cap), ef (num_buckets * cap, fe) in slot
// order and wf (fe + has_bias, heads * dim, the bias row last), all f32;
// fe + has_bias <= 32, cap a multiple of 32, the slot arrays, ds and ef
// 16-byte aligned.  part: scratch of blocks (fe + has_bias + 1) heads dim
// floats, each block's partials, added in block order by the finishing
// launch.  warps (1 to 4) a block, each a 32-column slice; nh_max: the
// most heads that a pass of warps * 32 columns spans.  Grid: `blocks`
// blocks, each a static range of the 32-slot chunks.
int dgl_vattn_slot_grad_mma(const void* src_local, const void* dst_local,
                            const void* valid, const void* src_tile,
                            const void* dst_tile, int64_t num_buckets,
                            int64_t tile, int64_t cap, const void* u,
                            const void* v, int64_t ld, const void* attn,
                            const void* ds, const void* ef, const void* wf,
                            int64_t fe, int64_t has_bias, int64_t heads,
                            int64_t dim, double slope, int64_t warps,
                            int64_t nh_max, int64_t blocks, void* part,
                            void* da, void* dwf, void* def, int64_t device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t hd = heads * dim;
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (fe < 0 || fe + has_bias > 32 || has_bias < 0 || has_bias > 1 ||
      warps < 1 || warps > kSliceWarps || cap % kChunk != 0 || ld < hd ||
      ld % 4 != 0 || hd < 1 || blocks < 1 || nh_max < 1 || !aligned(u) ||
      !aligned(v) || !aligned(src_local) || !aligned(dst_local) ||
      !aligned(valid) || !aligned(ds) || !aligned(ef))
    return cudaErrorInvalidValue;
  const int ks = fe > 16 ? 2 : 1;
  const bool with_def = def != nullptr;
  const size_t smem = slot_grad_mma_smem(ks, with_def, static_cast<int>(warps),
                                         static_cast<int>(nh_max),
                                         static_cast<int>(fe));
#define DGL_MMA_LAUNCH(KS_, DEF_)                                            \
  {                                                                          \
    err = allow_smem(vattn_slot_grad_mma_kernel<KS_, DEF_>, smem);           \
    if (err != cudaSuccess) return err;                                      \
    vattn_slot_grad_mma_kernel<KS_, DEF_><<<static_cast<unsigned>(blocks),   \
                                            static_cast<unsigned>(warps * 32),\
                                            smem, s>>>(                      \
        static_cast<const int*>(src_local),                                  \
        static_cast<const int*>(dst_local), static_cast<const float*>(valid),\
        static_cast<const int*>(src_tile), static_cast<const int*>(dst_tile),\
        static_cast<int>(num_buckets), static_cast<int>(tile),               \
        static_cast<int>(cap), static_cast<const float*>(u),                 \
        static_cast<const float*>(v), static_cast<int>(ld),                  \
        static_cast<const float*>(attn), static_cast<const float*>(ds),      \
        static_cast<const float*>(ef), static_cast<const float*>(wf),        \
        static_cast<int>(fe), static_cast<int>(has_bias),                    \
        static_cast<int>(heads), static_cast<int>(dim),                      \
        static_cast<float>(slope), static_cast<int>(nh_max),                 \
        static_cast<float*>(def), static_cast<float*>(part));                \
  }
  if (ks == 1) {
    if (with_def) DGL_MMA_LAUNCH(1, true) else DGL_MMA_LAUNCH(1, false)
  } else {
    if (with_def) DGL_MMA_LAUNCH(2, true) else DGL_MMA_LAUNCH(2, false)
  }
#undef DGL_MMA_LAUNCH
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t rows = fe + has_bias;
  const int64_t n = (rows + 1) * hd;
  vattn_grad_finish_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                             s>>>(static_cast<const float*>(part),
                                  static_cast<int>(blocks),
                                  static_cast<int>(rows),
                                  static_cast<int>(hd),
                                  static_cast<float*>(dwf),
                                  static_cast<float*>(da));
  return cudaGetLastError();
}

// attrs (four host ints): the registers a thread, the local memory bytes a
// thread and the resident blocks an SM of the instance of
// vattn_slot_grad_mma_kernel for fe features (with d(ef) when with_def)
// at `warps` warps a block, and its dynamic shared memory bytes.
int dgl_vattn_slot_grad_mma_attrs(int64_t fe, int64_t with_def,
                                  int64_t warps, int64_t nh_max,
                                  int64_t device, void* attrs) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (fe < 0 || fe > 32 || warps < 1 || warps > kSliceWarps || nh_max < 1)
    return cudaErrorInvalidValue;
  int* out = static_cast<int*>(attrs);
  const int ks = fe > 16 ? 2 : 1;
  const size_t smem = slot_grad_mma_smem(ks, with_def != 0,
                                         static_cast<int>(warps),
                                         static_cast<int>(nh_max),
                                         static_cast<int>(fe));
  out[3] = static_cast<int>(smem);
  const int w = static_cast<int>(warps);
  if (ks == 1) {
    return with_def
               ? kernel_regs(vattn_slot_grad_mma_kernel<1, true>, smem, w, out)
               : kernel_regs(vattn_slot_grad_mma_kernel<1, false>, smem, w,
                             out);
  }
  return with_def
             ? kernel_regs(vattn_slot_grad_mma_kernel<2, true>, smem, w, out)
             : kernel_regs(vattn_slot_grad_mma_kernel<2, false>, smem, w, out);
}

}  // extern "C"
