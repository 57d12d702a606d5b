// The row walk on Hopper: a weighted multi-head aggregation over the row
// view of the tiled format, one pass over a row's slots for all columns,
// each sum in registers.
//
//   out[r, h, :] = sum over the valid slots s of row r of
//                  w[b(s), h, c(s)] * y[nbr(s), h, :]
//
// and its dot-product sibling, K4's SDDMM by dst rows:
//
//   e[b(s), h, c(s)] = <x[nbr(s), h, :], z[r, h, :]> at each valid slot s
//                      of row r, 0 at every padded slot
//
// and, in its node-gradient form (kGrad), K9's node gradient:
//
//   out[r, h, :] = attn[h, :] * sum over the valid slots s of row r of
//                  ds[b(s), h, c(s)] * (own[r, h, :] + y[nbr(s), h, :] >= 0
//                                       ? 1 : slope)
//
// row_agg_kernel<VEC, CPL, false, false> replaces two TPU kernels of the JAX
// package:
// - K4's SpMM, dgl_tpu/ops/pallas/tiled_spmm.py tiled_spmm_multihead
//   :455 (body _spmm_mh_kernel :423), and with it
//   gat_fused.py _agg_kernel :120, the same function: the rows are the dst
//   nodes, the neighbours the srcs, y = x (gat_forward :328,
//   dot_gat_forward :547 and dq :614, gatv2_forward's num :811,
//   egatc_forward's num :1121, edgegat_v2_forward's node term);
// - K6's dx, gat_fused.py _dx_kernel :202, the src-side aggregation:
//   the rows are the src nodes, the neighbours the dsts, y = z
//   (gat_backward :428, _dot_gat_bwd's _dx_call :623/:636, _gatv2_bwd's
//   dx :925, _egatc_bwd's dx :1236, and the dx part of
//   _eg2_dx_def_kernel :1639).
// row_agg_kernel<VEC, CPL, true, false> replaces the dv part of gat_fused.py
// _gatv2_dv_da_kernel :689 (rows = dst, own = V, y = U) and
// _gatv2_du_kernel :731 (rows = src, own = U, y = V), K9's node gradient
// (_gatv2_bwd :878, :903).  The same walk: the row's own operand stays in
// registers beside its sums, the neighbour's row is gathered (16-byte
// loads, 41 columns padded to 44), each slot's weight is its ds, and attn
// scales the sums once at the end; no atomics and no split row, so each
// sum is taken in slot order, the same bits every run.  The tiled walk it
// replaced (vattn_node_grad_kernel, once csrc/gatv2.cu's, now built by
// dgl_tpu_torch/tools/perf_dq_node_grad.py from
// tools/dq_node_grad_probe.cu) added every slot's dW into shared memory
// with a float atomicAdd, a compare-and-swap loop on this card, and
// walked every slot once per column chunk.  Bound: the view, 4H B an edge
// of ds (slot-major, as K6's ds writes it for both sides), the rows' own
// operand and the neighbours' once, out once.
// row_fe_grad_kernel<VEC, CPL, KF> is the same node-gradient walk with
// K11 v2's edge term, raw = own + y[nbr] + fe, fe = ef[slot] . wf[:fe] (+
// the bias row), formed per entry and never stored.  It replaces the dv
// part of gat_fused.py _egatc2_dv_da_kernel :1975 (egatc2_backward :2167)
// and _egatc2_du_kernel :2024 (:2196), which the tiled walk served too.
// A lane holds its columns of wf (KF rows: 8, 16 or 32, at most 4 columns
// a lane, so 128 registers at most) and of the bias in registers; each
// step of FeUnroll entries copies their edge-feature rows (ef in slot
// order, (B, C, Fe) padded to whole 16-byte vectors, read at the view's
// slot) into the group's shared memory with cp.async, beside the weights
// and gathers, and every lane reads an entry's features there at one
// address across the group.  fe costs 2 Fe operations an entry and column
// (with the bias row, 2 x 17 at EGAT's 16 features): on the f32 pipes
// that arithmetic is the kernel's bound (operations), where the walk
// without it is bound by its gathers.  Sums in slot order, no atomics, the
// same bits every run.
// row_agg_kernel<VEC, CPL, true, true>, the walk by dst with da folded
// in, replaces _gatv2_dv_da_kernel :689 whole, dv and da together, as
// the JAX kernel computes them:
//
//   da[c] = sum over the valid slots s of ds[b(s), h, c(s)] *
//           lrelu(own[r, c] + y[nbr(s), c]),  c in head h
//
// one FMA and a select a slot and column on values the walk holds.  A
// lane's da sums carry across the rows its group claims while its
// columns stay; where a row is walked in column chunks (n_chunks > 1,
// and then a group is the whole warp) a new chunk flushes them.  At the
// end the warp's groups combine theirs by shuffles in a fixed order and
// the first group's lanes add them into da in L2 (red.global.add, 16
// bytes at a time where VEC is 4): under 100 reductions a warp at the
// main path's widths.  da therefore meets in no fixed order; dv's sums
// are the unfolded walk's, bit for bit.  The kernel it replaced
// (csrc/gatv2.cu vattn_slot_grad_kernel<C, 0, false>, a warp a 32-slot
// chunk of the buckets, both node rows of every slot gathered with
// scalar loads, da met in shared-memory atomics) is built by
// dgl_tpu_torch/tools/perf_ds_fold.py to be timed beside it.
// row_sddmm_kernel<CPL, false> (with slot_finish_kernel<VEC, false>) replaces
// K4's SDDMM, dgl_tpu/ops/pallas/tiled_spmm.py tiled_sddmm_dot_multihead
// :521 (body _sddmm_mh_kernel :494): edgeflat's dW (_SpmmMultihead) and
// dot_gat_forward's scores :520 (dgl_tpu/ops/pallas/gat_fused.py).
// row_sddmm_kernel<CPL, false> with ds_finish_kernel replaces K6's ds,
// dgl_tpu/ops/pallas/gat_fused.py _ds_kernel :146 (gat_backward :368,
// _dot_gat_bwd :597, _gatv2_bwd :859, _egatc_bwd :1170, egatc2_backward):
//
//   ds[b, h, c] = (<x[src], zn[dst]>_h - rp[dst, h]) * g[b, h, c]
//
// at valid slots, 0 at padded ones.  The dot is K4's SDDMM by dst rows
// (x = x, z = zn) into the entry-major scratch; the finishing pass, a
// thread a slot in slot order, adds the scratch's parts in order, then
// subtracts rp[dst] once and multiplies by g, read coalesced, and
// writes (B, H, C) or the slot-major layout ((B, C, H): a slot's H values
// in one sector) that the row walks read, so that no caller copies ds.
// The kernel it replaced (csrc/gat_fused.cu gat_ds_kernel's mode 0, a
// warp a 32-slot chunk gathering x[src] and zn[dst] with scalar loads) is
// built by dgl_tpu_torch/tools/perf_ds_fold.py to be timed beside it.
// Bound: the view, x and zn once, rp once, g at the edges (4H B an
// edge), ds at every slot (4H B a slot).
//
// row_agg_kernel at H = 1 replaces K3, dgl_tpu/ops/pallas/tiled_spmm.py
// tiled_spmm :347 -> _spmm_one_call :302 (body _spmm_kernel :239):
// out[d] = sum over d's slots of w * x[src], the walk by dst with x as
// (N, 1, F) and the slot weights as (B, 1, C), or, for a plain sum, its
// weightless instance (kOnes: w null, weight 1; neither w nor the view's
// slot is read).  At F = 16 a row is 4 lanes of 16-byte loads, and a step
// of 4 entries keeps 4 gathers in flight a lane: taking U = 8 entries a
// step (the probe's edit "narrow") ran slower on an H100 at Reddit's
// size, and spilled in K9's fold.  One head's weights are read by every
// lane itself, so that no shuffle waits on the load before the gathers
// issue (the edit "rounds" shuffles them as several heads' are).  The
// kernel it replaced
// (csrc/tiled_spmm.cu tiled_spmm_kernel<G, kCopy>: a block a dst tile, the
// tile's rows in shared memory, a float atomicAdd a slot and column, a
// compare-and-swap loop on this card) is built by
// dgl_tpu_torch/tools/perf_reduce_k3.py to be timed beside it.  Bound: the
// view's ptr, order and nbr (4 B an edge; slot too, 4 B, with weights),
// the weights at the edges, x read once, out written once.
//
// row_reduce_kernel<VEC, CPL> replaces K6's slot reduce,
// dgl_tpu/ops/pallas/gat_fused.py _den_kernel :103, _der_kernel :167 and
// _del_kernel :183 (gat_forward :314, gat_backward :387/:407,
// dot_gat_forward :533 and the EdgeGAT/EGAT functions):
//
//   out[r, h] = sum over the valid slots s of row r of vals[b(s), h, c(s)]
//
// on the dst view (den, der) or the src view (del).  It is the row walk
// without the gather: a group of lanes owns a row, its lanes read a slot's
// H values (16-byte loads where vals is slot-major, (B, C, H) memory, and
// H a multiple of 4; one value a lane in the (B, H, C) layout read in
// place), keep kU slots in flight and sum in registers; the lanes of one
// head combine by shuffles in a fixed order and one writes.  The kernel it
// replaced (csrc/gat_fused.cu slot_reduce_kernel<kSrc>: a block a tile and
// split, the tile's (tile, H) sums in shared memory, a float atomicAdd at
// [local][h] for every slot and head, 8-way bank conflicts at H = 8, splits
// met with global atomics) is built by dgl_tpu_torch/tools/
// perf_reduce_k3.py.  No shared memory, no atomics, no split row; valid,
// dst_local and the view's nbr are not read.  One row a warp (the rows of
// a warp would differ in length), 4 blocks an SM (kReduceBlocksPerSm:
// fewer tiles' values in flight, so more of them in L2).  Bound: the
// view's slot, ptr and order, 4H B an edge of vals, out once.  At H = 1
// the values are 4 B at scattered slots, a 32-byte sector each from L2,
// where the tiled reduce streamed its slots: there it is the slower.
//
// The row view (dgl_tpu_torch/ops/kernels/tiled_spmm.py RowView), one per
// side of a format: ptr (rows + 1,), and for the E valid slots grouped by
// row, ascending slot id within a row, slot (the flat slot s = b * cap +
// c) and nbr (the global id of the neighbour), all int32; order (rows,)
// is the order in which rows are claimed.  w is the (B, H, cap) slot
// tensor, read through its strides; the wrapper hands it slot-major (a
// slot's H weights in one 32-byte sector), copied once a call unless the
// caller's tensor is already so laid out.
//
// Design.  The TPU kernels contract one-hot matrices of a bucket on the
// matrix unit and carry an output tile across the grid; the port's first
// CUDA walk (a block per tile, a shared-memory accumulator) paid a float
// shared atomicAdd, a compare-and-swap loop on this card, per slot and
// column, and walked every slot once per 32-column chunk.  Here:
// - a group of `lpr` lanes (32, or fewer for narrow rows, several rows a
//   warp) owns a row; its lanes take the row's column vectors (VEC
//   floats, 16-byte loads where the head width is a multiple of 4; CPL
//   vectors a lane), so one pass over the row's slots serves all columns
//   and every sum lives in registers: no shared memory, no atomics on
//   out, every output written once, 0 on a row with no slot;
// - the group loads `lpr` slot ids and neighbour ids coalesced, then for
//   U slots at a time (4-8 in flight a lane) reads each slot's weight of
//   each head once (lane k of a round holds slot k / H, head k % H),
//   broadcasts it to that head's lanes with a shuffle, issues the U
//   gathers of y's rows, then the adds;
// - w read in place, (B, H, cap), puts a slot's H weights in H sectors:
//   at H > 1 the walk then took longer than the slot-major copy and the
//   walk on it together (dgl_tpu_torch/tools/perf_row_walk.py);
// - a head width that is not a multiple of 4 takes scalar loads (a
//   164-byte row at 41 columns is not 16-byte aligned); the wrapper pads
//   such rows to a multiple of 4 where that adds at most an eighth;
// - degree skew (Reddit's largest degree is 10,674 with self-loops, its
//   mean about 490): persistent warps claim rows from a global counter
//   in `order`: the hub rows (over 4x the mean degree) first, largest
//   first, so that none starts late and holds up the end; then the rest
//   by id, so that the rows in flight share buckets (the weights'
//   sectors) and, on a graph with communities, neighbours in L2.  No row
//   is split: each row's sum is taken by one group in slot order, so the
//   result is the same from run to run at every row.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32): the view it reads
// (slot and nbr, 8 B an edge; ptr and order, 8 B a row), 4H B an edge of
// w, y read once and out written once; 2 f32 operations an edge and
// column.  chip_smoke.py prints it at the main
// path's shapes.  The risk: the walk is by row, so a row's neighbours
// are gathered from all of y, where the tiled walk read one src tile a
// bucket; at (4, 32) on Reddit y is 233k x 512 B = 119 MB, more than the
// 50 MB L2, so gathers that miss L2 may set the time (at (1, 41) and
// (8, 8) y fits).  Indices are int32: the wrapper checks every flat size.
//
// SDDMM design.  The port's first SDDMM kernel walked the buckets, a warp
// a 32-slot chunk, and gathered both x[src] and z[dst] for every slot
// with scalar loads.  The walk by dst keeps the row's z[r] in registers
// (its lanes' 16-byte vectors, the head width padded to a multiple of 4
// floats by the wrapper: zeros leave every dot as it is), so only x[nbr]
// is gathered, U slots in flight a lane.  A head's lph lanes reduce the
// U slots of a round together in a butterfly (below), which leaves each
// lane some of the slots, so that U slots cost U - 1 shuffles and one
// store instruction rather than U log2(lph) shuffles and U stores.  No
// row is split and each dot is summed in one lane order: the same bits
// from run to run.  The risk is the writes: a row's slots lie in many
// buckets, in canonical edge order within each, so a slot's H outputs
// land in H sectors of a (B, H, C) tensor far larger than L2: direct
// stores there took twice the walk's time at (4, 32), and one 16-byte
// store a slot into a (B, C, H) scratch still cost more than the gathers
// (dgl_tpu_torch/tools/perf_sddmm_walk.py sets the layouts side by side).
// So the walk writes at the slot's entry in the view (an (E, H) scratch),
// where the butterfly's one store instruction a round fills whole
// sectors, with st.global.cs (evict first: the walk reads x again, not
// its outputs); then slot_finish_kernel gathers the scratch into (B, H,
// C) through the view's slot -> entry map (4 B a slot, built once a
// format) and writes the padded slots' zeros (about 39% of Reddit's
// slots).  A row of more than 1,024 floats takes several launches, each
// a group of heads (into its columns of the scratch) or a chunk of a
// head's columns (into a scratch part of its own; the pass adds the
// parts in order), so any width runs and every dot is summed in one
// order.  The probe builds the other layouts from this source with edits.
// Bound: the view, x and z read once, e written at every slot (4H B a
// slot); chip_smoke.py prints it.
//
// K9's scores on the same walk.  row_sddmm_kernel<CPL, true> with
// slot_finish_kernel<VEC, true> replaces K9's scores,
// dgl_tpu/ops/pallas/gat_fused.py _gatv2_scores_kernel :670
// (gatv2_forward :783):
//
//   p[b, h, c] = exp(clip(sum_d attn[h, d] lrelu(U[src, h, d] +
//                V[dst, h, d]), +-40)) at valid slots, 0 at padded ones
//
// The same sampled product with attn . lrelu(x + z) in place of x . z:
// the row's registers hold V[r] and attn (both padded to a multiple of 4
// columns with zeros: a padded column gives attn lrelu(0) = 0), U[nbr] is
// gathered with 16-byte loads as x[nbr] is, and a lane's partial of a
// vector is sum attn lrelu(U + V) over its four floats, with the slope a
// kernel argument.  The walk writes the raw sum into the entry-major
// scratch (a row over 1,024 floats in several launches, into parts: the
// sum over columns adds across chunks); the finishing pass adds the parts
// in order, then takes exp(clip(s, +-40)) once, where only it sees the
// whole sum, and writes 0 at the padded slots.  The kernel it replaced (a
// warp a 32-slot chunk of the buckets, both U[src] and V[dst] gathered
// with scalar loads at every slot, padded slots visited) is built by
// dgl_tpu_torch/tools/perf_scores_rows.py from an edit of
// tools/fwd_scores_probe.cu to be timed beside it.  Bound: the view, U and
// V read once, attn, p written at every slot (4H B a slot).
//
// K11's scores on the same walk and pass, which replace that bucket walk's
// two other instances.  K11 v1's (dgl_tpu/ops/pallas/gat_fused.py
// _egatc_scores_kernel :959, egatc_forward :1093), where raw gains the
// stored FE[s] (B C, H D) f32 or bf16, are row_sddmm_kernel<CPL, true,
// true, T>: the scores mode and kStore at once, FE's row read at the
// entry's slot (64-bit offsets, unpadded heads at DsTerm's offsets) and
// added to U[nbr] before lrelu.  K11 v2's (_egatc2_scores_kernel :1955,
// egatc2_forward :2075), where raw gains fe = ef[s] . wf[:Fe] (+ the bias
// row) formed per entry, are row_vattn_fe_kernel<KF>, a sibling of the
// walk at one 16-byte vector a lane, as row_fe_grad_kernel forms fe: the
// lane's KF rows of wf in registers (KF 8, 16 or 32, tiled_spmm.fe_kf), the
// entries' edge-feature rows staged in the group's shared memory by
// cp.async beside the gathers, the bias added to V[r] once a row; a head
// wider than 32 vectors, or more heads than a launch's lanes hold, takes
// several launches (the wrapper's plan).  The bucket walk they replaced
// (a block's wf in shared memory, read once an FMA; scalar gathers at
// every slot) is built by dgl_tpu_torch/tools/perf_fwd_scores.py from
// tools/fwd_scores_probe.cu.  Bound: K9's, with FE at the edges (v1), or
// ef at the edges and wf once and 2 (Fe + 1) operations an edge and
// column (v2).
//
// K10's edge ds on the same walk, with its finishing pass: it replaces
// the edge modes of the bucket walk gat_ds_kernel, csrc/gat_fused.cu's
// until this walk took them.  K10 v2's ds, dgl_tpu/ops/pallas/
// gat_fused.py _eg2_ds_kernel :1605 (edgegat_v2_backward :1785), where ds
// gains ef[s, :] . Zp[dst, h] inside the bracket, is K6's walk
// (row_sddmm_kernel<CPL, false>) and ds_finish_kernel<1, SM, kDef, true>:
// the pass adds the edge dot to the walk's sum before rp, a head at a
// time, ef's row read in slot order (coalesced across the pass's
// threads) and Zp[dst] a row of the bucket's dst tile; with kDef it
// writes d(ef)[s, :] = sum_h p[s, h] Zp[dst, h] + ds[s, h] M[:, h] at
// every slot (0 at padded ones) in the same loop, the d(ef) part of
// _eg2_dx_def_kernel :1639.  Gathering ef at each entry's slot inside the
// walk instead (Zp[r] in registers as more vectors of each head) took
// longer on an H100 at EdgeGATConv's widths: the slots of a row lie in
// many buckets, so every entry's 64 bytes of ef were a random read, and
// the wider head halved the entries in flight.  K10 v1's ds,
// _ds_fe_kernel :1299 (edgegat_backward :1432), is
// row_sddmm_kernel<CPL, false, true, T> (kStore): the stored message
// fe_s (f32 or bf16 T, read at the entry's slot, 64-bit offsets) added to
// x[nbr] before the product, its epilogue in the pass.  The bucket walk
// (a warp a 32-slot chunk, x[src], zn[dst] and Zp[dst] gathered with
// scalar loads at every slot, padded ones included) is built by
// dgl_tpu_torch/tools/perf_slot_walks.py from tools/slot_walks_probe.cu
// to be timed beside them.  Bound: K6's ds's, with ef at the edges (4 Fe
// B an edge) and Zp once (K10 v2; with d(ef) p at the edges, M and d(ef)
// at every slot), or fe_s at the edges (K10 v1).
//
// The slot walk.  row_slot_kernel<VEC, CPL, kMode, T> is the row walk
// whose operand may come from the entry's slot, summed in registers in
// slot order:
//
//   out[r, j] = sum over row r's entries k (slot s, neighbour n) of
//               w[s, h(j)] * (node[n, j] + t[s, j])
//
// each mode keeping some of the terms (SlotMode): kSlotFe, K10 v1's
// numerator (node = x, t = the stored fe_s; gat_fused.py _agg_fe_kernel
// :1276, edgegat_forward :1393, dst view); kSlotDxDfe, K10 v1's dx (node
// = zn, no t in the sum; _dx_dfe_kernel :1320, edgegat_backward :1491, src
// view), which writes t[s] = w zn[n] as dfe on the way, its padded slots'
// zeros written by slot_zero_kernel, a pass over the slots alone;
// kSlotVec, K11 v1's dFNI (t = dFE, no weight, no node; _dw_src_kernel
// :1020, src view) and the same sum by dst (dFNJ's function, which
// K11 v1's slot gradient takes on its own walk); kSlotFeat, K10 v2's slot-feature reduce (no node, t = ef,
// Fe wide, read by every head's columns; the edge-message term of
// _eg2_agg_kernel :1582 and the dWe and d(attn_e) sums of _eg2_ds_kernel
// and _eg2_dx_def_kernel, dst view).  The stored tensors are (slots, F)
// rows, 512 B at F = 128 in f32, read once with evict-first loads (the
// node rows the walk gathers stay in L2) or, for dfe, written with
// evict-first stores, at 64-bit offsets; the weights are read at the
// entry's slot through their strides (one sector for a slot's H weights
// where slot-major: the forwards' one copy of p).  The tiled walk it
// replaced (src_agg_kernel, once csrc/gat_fused.cu's: a block a (tile,
// column chunk, split), the tile's rows in shared memory, a float
// atomicAdd a slot and column, every slot walked once per chunk of 32
// columns, splits met in global atomics) is built by
// dgl_tpu_torch/tools/perf_slot_walks.py.  No shared memory, no atomics,
// every output written once: the same bits every run.  Bound: the view
// it reads (slot, and nbr where it gathers; ptr and order), w at the
// edges (4H B), node read once, t at the edges (dfe: written at every
// slot, with valid read by the zero pass), out once.
//
// K11 v1's slot gradient, the da, dFE and dv parts of
// _egatc_dv_da_dfe_kernel :979 (_egatc_bwd :1193), is the slot walk's
// sibling row_slot_grad_kernel<VEC, CPL, T> by dst: per entry it reads
// FE at the entry's slot, gathers U[src], takes V[r] and attn from
// registers and ds through its strides, writes dW at dFE[slot] and adds
// it, as stored, into the row's dFNJ in slot order (kSlotVec's sum, the
// same bits); da sums per lane over static ranges of the claim order,
// each range's partial written once and added in range order by
// range_sum_kernel, so no output meets in an atomic.  slot_zero_kernel
// writes the padded slots' dFE.  A template flag of row_slot_kernel would
// have given every mode ds, V and attn, and the probes edit its text; the
// sibling leaves it as it was.  The bucket walk it replaced
// (vattn_slot_grad_kernel<C, T, true>, once csrc/gatv2.cu's: a warp a
// 32-slot chunk, U[src], V[dst] and FE read with scalar loads a slot at a
// time, da met in shared and global atomics, dFNJ then summed by
// kSlotVec) is built by dgl_tpu_torch/tools/perf_slot_grad_scores.py.
// Bound: the dst view (slot, nbr, ptr, order), U and V once, attn, ds and
// FE at the edges, dFE at every slot, dFNJ and da once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "persistent.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps per block
// blocks of the row reduce an SM (32 warps): with every block that fits,
// more rows' values are in flight than L2 keeps, and the reduce ran 2-15%
// slower on an H100 at Reddit's size (the edit "nocap" of
// dgl_tpu_torch/tools/perf_reduce_k3.py)
constexpr int kReduceBlocksPerSm = 4;
constexpr float kClip = 40.f;  // K9's logit clip (gat_fused.py CLIP)

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

__device__ __forceinline__ void fma_into(float* acc, float w, float v) {
  acc[0] = fmaf(w, v, acc[0]);
}
__device__ __forceinline__ void fma_into(float* acc, float w, float2 v) {
  acc[0] = fmaf(w, v.x, acc[0]);
  acc[1] = fmaf(w, v.y, acc[1]);
}
__device__ __forceinline__ void fma_into(float* acc, float w, float4 v) {
  acc[0] = fmaf(w, v.x, acc[0]);
  acc[1] = fmaf(w, v.y, acc[1]);
  acc[2] = fmaf(w, v.z, acc[2]);
  acc[3] = fmaf(w, v.w, acc[3]);
}

template <typename V>
__device__ __forceinline__ V zero_vec();
template <>
__device__ __forceinline__ float zero_vec<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ float2 zero_vec<float2>() {
  return make_float2(0.f, 0.f);
}
template <>
__device__ __forceinline__ float4 zero_vec<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void store_vec(float* p, const float* a,
                                          Vec<1>) {
  p[0] = a[0];
}
__device__ __forceinline__ void store_vec(float* p, const float* a,
                                          Vec<2>) {
  *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
}
__device__ __forceinline__ void store_vec(float* p, const float* a,
                                          Vec<4>) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}

template <int N>
struct Log2 {
  static constexpr int value = 1 + Log2<N / 2>::value;
};
template <>
struct Log2<1> {
  static constexpr int value = 0;
};

// slots in flight a lane: 8, fewer where a lane keeps many columns
template <int VEC, int CPL>
struct Unroll {
  static constexpr int kCols = VEC * CPL;
  static constexpr int value = kCols <= 4 ? 8 : kCols <= 8 ? 4 : 2;
};

// K9's node gradient (kGrad): acc += w * (own[r] + y[nbr] >= 0 ? 1 :
// slope) per column, scaled by attn once at the end.
__device__ __forceinline__ void grad_into(float* acc, float w, float o,
                                          float v, float slope) {
  acc[0] = fmaf(w, o + v >= 0.f ? 1.f : slope, acc[0]);
}
__device__ __forceinline__ void grad_into(float* acc, float w, float2 o,
                                          float2 v, float slope) {
  grad_into(acc, w, o.x, v.x, slope);
  grad_into(acc + 1, w, o.y, v.y, slope);
}
__device__ __forceinline__ void grad_into(float* acc, float w, float4 o,
                                          float4 v, float slope) {
  grad_into(acc, w, o.x, v.x, slope);
  grad_into(acc + 1, w, o.y, v.y, slope);
  grad_into(acc + 2, w, o.z, v.z, slope);
  grad_into(acc + 3, w, o.w, v.w, slope);
}

__device__ __forceinline__ float lrelu(float t, float slope) {
  return t >= 0.f ? t : slope * t;
}

// K9's scores (kVattn): sum over the four floats of attn * lrelu(u + v)
__device__ __forceinline__ float vattn_dot(float4 a, float4 u, float4 v,
                                          float slope) {
  float d = a.x * lrelu(u.x + v.x, slope);
  d = fmaf(a.y, lrelu(u.y + v.y, slope), d);
  d = fmaf(a.z, lrelu(u.z + v.z, slope), d);
  return fmaf(a.w, lrelu(u.w + v.w, slope), d);
}

// K9's da (kDa): acc += w * lrelu(own[r] + y[nbr]) per column
__device__ __forceinline__ void lrelu_into(float* acc, float w, float o,
                                           float v, float slope) {
  const float t = o + v;
  acc[0] = fmaf(w, t >= 0.f ? t : slope * t, acc[0]);
}
__device__ __forceinline__ void lrelu_into(float* acc, float w, float2 o,
                                           float2 v, float slope) {
  lrelu_into(acc, w, o.x, v.x, slope);
  lrelu_into(acc + 1, w, o.y, v.y, slope);
}
__device__ __forceinline__ void lrelu_into(float* acc, float w, float4 o,
                                           float4 v, float slope) {
  lrelu_into(acc, w, o.x, v.x, slope);
  lrelu_into(acc + 1, w, o.y, v.y, slope);
  lrelu_into(acc + 2, w, o.z, v.z, slope);
  lrelu_into(acc + 3, w, o.w, v.w, slope);
}

__device__ __forceinline__ void red_add(float* a, const float* v, Vec<1>) {
  atomicAdd(a, v[0]);
}
__device__ __forceinline__ void red_add(float* a, const float* v, Vec<2>) {
  atomicAdd(a, v[0]);
  atomicAdd(a + 1, v[1]);
}
__device__ __forceinline__ void red_add(float* a, const float* v, Vec<4>) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(a),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

// a lane's da sums of column chunk `chunk` added into da in L2, and zeroed
template <int VEC, int CPL>
__device__ __forceinline__ void flush_da(float* da, float (&sums)[CPL][VEC],
                                         int chunk, int lpr, int li,
                                         int nv) {
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    const int cv = (chunk * CPL + q) * lpr + li;
    if (cv < nv) red_add(da + cv * VEC, sums[q], Vec<VEC>());
#pragma unroll
    for (int i = 0; i < VEC; ++i) sums[q][i] = 0.f;
  }
}

// kOnes: every weight is 1 and w is not read (K3's plain sum); the view's
// slot is then not read either
template <int VEC, int CPL, bool kGrad, bool kDa, bool kOnes>
__global__ void __launch_bounds__(kWarps * 32)
row_agg_kernel(const int* __restrict__ ptr, const int* __restrict__ slot,
               const int* __restrict__ nbr, const int* __restrict__ order,
               int rows, const float* __restrict__ w, int cap, int w_bs,
               int w_hs, int w_cs, int heads, int head_cols,
               const float* __restrict__ y, int f, int lpr, int n_chunks,
               float* __restrict__ out, int* __restrict__ counter,
               const float* __restrict__ own,
               const float* __restrict__ attn, float slope,
               float* __restrict__ da) {
  using V = typename Vec<VEC>::T;
  constexpr int U = Unroll<VEC, CPL>::value;
  const int lane = threadIdx.x & 31;
  const int groups = 32 / lpr;  // rows a warp takes at once
  const int grp = lane / lpr;
  const int li = lane - grp * lpr;
  const unsigned gmask =
      lpr == 32 ? kFull : ((1u << lpr) - 1u) << (grp * lpr);
  const int nv = f / VEC;  // column vectors a row
  const int n_items = rows * n_chunks;
  static_assert(kGrad || !kDa, "da is folded into the node gradient");
  static_assert(!(kGrad && kOnes), "the node gradient weighs by ds");
  // kDa: this lane's da sums over the rows its group claims, of the
  // columns of chunk da_chunk
  float da_sums[CPL][VEC];
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) da_sums[q][i] = 0.f;
  }
  int da_chunk = 0;

  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, groups);
    base = __shfl_sync(kFull, base, 0);
    if (base >= n_items) break;
    const int item = base + grp;
    const bool has = item < n_items;
    const int r = has ? order[item / n_chunks] : 0;
    const int chunk = has ? item - (item / n_chunks) * n_chunks : 0;
    // a new column chunk flushes the sums: only where n_chunks > 1, and
    // then lpr is 32 (the wrapper's layout, checked by the C function),
    // one group a warp, so the test is uniform in the warp
    if (kDa && chunk != da_chunk) {
      flush_da<VEC, CPL>(da, da_sums, da_chunk, lpr, li, nv);
      da_chunk = chunk;
    }

    int cv[CPL];    // this lane's column vectors
    bool ok[CPL];
    int hq[CPL];    // and their heads
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      cv[q] = (chunk * CPL + q) * lpr + li;
      ok[q] = has && cv[q] < nv;
      hq[q] = ok[q] ? cv[q] * VEC / head_cols : 0;
    }
    float acc[CPL][VEC];
    V oq[CPL];  // kGrad: the row's own operand
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[q][i] = 0.f;
      oq[q] = kGrad && ok[q]
                  ? __ldg(reinterpret_cast<const V*>(own + r * f) + cv[q])
                  : zero_vec<V>();
    }

    const int p0 = has ? ptr[r] : 0;
    const int p1 = has ? ptr[r + 1] : 0;
    for (int pb = p0; pb < p1; pb += lpr) {  // uniform in the group
      const int n = min(lpr, p1 - pb);
      int my_nbr = 0, my_wb = 0;  // this lane's slot: neighbour, w offset
      if (li < n) {
        my_nbr = nbr[pb + li];
        const int s = slot[pb + li];
        const int b = s / cap;
        my_wb = b * w_bs + (s - b * cap) * w_cs;
      }
      for (int u0 = 0; u0 < n; u0 += U) {
        // the weights of slots u0 .. u0 + U - 1, each (slot, head) read
        // once: in the round at k0, lane li holds slot (k0 + li) / heads
        // of this step, head (k0 + li) % heads, and a slot's weights are
        // shuffled in the rounds that hold them (a test uniform in the
        // group); all 1 in the weightless instance
        float wq[U][CPL];
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int q = 0; q < CPL; ++q) wq[u][q] = kOnes ? 1.f : 0.f;
        }
        if (!kOnes && heads == 1) {
          // one head: every lane reads each slot's weight itself (one
          // address across the group), so that no shuffle waits for the
          // load and the gathers below issue at once
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int wb = __shfl_sync(gmask, my_wb, u0 + u, lpr);
            const float wv = u0 + u < n ? __ldg(w + wb) : 0.f;
#pragma unroll
            for (int q = 0; q < CPL; ++q) wq[u][q] = wv;
          }
        }
        for (int k0 = 0; !kOnes && heads > 1 && k0 < U * heads; k0 += lpr) {
          const int k = k0 + li;
          const int u = k / heads;
          const int wb = __shfl_sync(gmask, my_wb, u0 + u, lpr);
          const float wv = k < U * heads && u0 + u < n
                               ? __ldg(w + wb + (k - u * heads) * w_hs)
                               : 0.f;
#pragma unroll
          for (int uu = 0; uu < U; ++uu) {
            if (uu * heads >= k0 + lpr || uu * heads + heads <= k0) continue;
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
              const int src = uu * heads + hq[q] - k0;
              const float t = __shfl_sync(gmask, wv, src, lpr);
              if (src >= 0 && src < lpr) wq[uu][q] = t;
            }
          }
        }
        V xv[U][CPL];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int nb = __shfl_sync(gmask, my_nbr, u0 + u, lpr);
          const bool live = u0 + u < n;
          const V* yr = reinterpret_cast<const V*>(y + nb * f);
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            xv[u][q] = live && ok[q] ? __ldg(yr + cv[q]) : zero_vec<V>();
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            if constexpr (kGrad) {
              grad_into(acc[q], wq[u][q], oq[q], xv[u][q], slope);
              if constexpr (kDa) {
                lrelu_into(da_sums[q], wq[u][q], oq[q], xv[u][q], slope);
              }
            } else {
              fma_into(acc[q], wq[u][q], xv[u][q]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      if (!ok[q]) continue;
      if constexpr (kGrad) {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[q][i] *= __ldg(attn + cv[q] * VEC + i);
      }
      store_vec(out + r * f + cv[q] * VEC, acc[q], Vec<VEC>());
    }
  }
  if constexpr (kDa) {
    // the groups' sums of one column combined by a butterfly over the
    // group bits, in the same order in every lane (a no-op at lpr 32);
    // the first group's lanes add them into da
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        for (int o = lpr; o < 32; o *= 2)
          da_sums[q][i] += __shfl_xor_sync(kFull, da_sums[q][i], o);
      }
    }
    if (grp == 0) flush_da<VEC, CPL>(da, da_sums, da_chunk, lpr, li, nv);
  }
}

// K11 v2's node gradient (the edge term): the fewest lanes a row, so that a
// warp's groups hold at most kFeGroups rows' edge features in shared memory
// at once, and the entries a group keeps in flight: 4, or 2 where a lane's
// columns of wf (VEC CPL KF registers) and the entries' operands (CPL (VEC
// + 1) each) take more.  At (4, 32) with 16 features 4 entries ran faster
// than 2 on an H100 but ptxas kept them in 128 registers with 16 bytes of
// local memory a thread (dgl_tpu_torch/tools/perf_dq_node_grad.py, PERF.md)
#define DGL_FE_UNROLL(VEC, CPL, KF) \
  ((VEC) * (CPL) * (KF) + 4 * (CPL) * ((VEC) + 1) <= 60 ? 4 : 2)
constexpr int kFeMinLanes = 8;
constexpr int kFeGroups = 32 / kFeMinLanes;
template <int VEC, int CPL, int KF>
struct FeUnroll {
  static constexpr int value = DGL_FE_UNROLL(VEC, CPL, KF);
};

__device__ __forceinline__ float add_vec(float a, float b) { return a + b; }
__device__ __forceinline__ float2 add_vec(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float4 add_vec(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// element i of a vector (i known at compile time after unrolling)
__device__ __forceinline__ float elem(float v, int) { return v; }
__device__ __forceinline__ float elem(float2 v, int i) {
  return i == 0 ? v.x : v.y;
}
__device__ __forceinline__ float elem(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 16 bytes from device memory into shared memory, not through L1 or the
// registers, and the wait for this thread's copies
__device__ __forceinline__ void cp_async16(float4* smem, const float4* g) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// K11 v2's node gradient by the row walk, the edge term formed per entry:
// out[r, j] = attn[j] * the sum over row r's entries k (slot s, neighbour
// n) of w[s, head(j)] * (raw >= 0 ? 1 : slope), raw = (own[r, j] +
// bias[j]) + y[n, j] + sum_i ef[s, i] wf[i, j], in entry order.  The row
// walk's lanes (a group of lpr lanes a row, VEC floats a load, CPL vectors
// a lane, at most 4 columns a lane); the lane holds its columns of wf (KF
// rows, zero past fe) in registers, reloaded only where its column chunk
// changes, and adds the bias row to the row's own operand once.  A step of U entries: the group copies their
// edge features (fq 16-byte vectors a row of ef, in slot order) into its
// part of the warp's shared memory with cp.async, and each lane reads its
// own head's weight and gathers its vectors of y[n], all before the
// arithmetic; each lane then reads an entry's features from shared memory
// (one address across the group) and forms fe for its columns.
template <int VEC, int CPL, int KF>
__global__ void __launch_bounds__(kWarps * 32)
row_fe_grad_kernel(const int* __restrict__ ptr, const int* __restrict__ slot,
                   const int* __restrict__ nbr, const int* __restrict__ order,
                   int rows, const float* __restrict__ w, int cap, int w_bs,
                   int w_hs, int w_cs, int head_cols,
                   const float* __restrict__ y, int f, int lpr,
                   int n_chunks, float* __restrict__ out,
                   int* __restrict__ counter, const float* __restrict__ own,
                   const float* __restrict__ attn, float slope,
                   const float4* __restrict__ ef, int fq,
                   const float* __restrict__ wf, int fe,
                   const float* __restrict__ bias) {
  using V = typename Vec<VEC>::T;
  constexpr int U = FeUnroll<VEC, CPL, KF>::value;
  constexpr int KQ = KF / 4;     // 16-byte vectors of an entry's features
  constexpr int NC = VEC * CPL;  // the lane's columns
  static_assert(NC <= 4, "wf's columns in registers: at most 4 a lane");
  __shared__ float4 efs[kWarps][kFeGroups * U * KQ];
  const int lane = threadIdx.x & 31;
  const int groups = 32 / lpr;  // rows a warp takes at once
  const int grp = lane / lpr;
  const int li = lane - grp * lpr;
  const unsigned gmask =
      lpr == 32 ? kFull : ((1u << lpr) - 1u) << (grp * lpr);
  float4* es = efs[threadIdx.x >> 5] + grp * U * KQ;  // the group's part
  const int nv = f / VEC;  // column vectors a row
  const int n_items = rows * n_chunks;
  float wfr[NC][KF];  // the lane's columns of wf, by feature
  int wf_chunk = -1;  // the chunk they belong to

  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, groups);
    base = __shfl_sync(kFull, base, 0);
    if (base >= n_items) break;
    const int item = base + grp;
    const bool has = item < n_items;
    const int r = has ? order[item / n_chunks] : 0;
    const int chunk = has ? item - (item / n_chunks) * n_chunks : 0;
    int cv[CPL];    // this lane's column vectors
    bool ok[CPL];
    int hq[CPL];    // and their heads
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      cv[q] = (chunk * CPL + q) * lpr + li;
      ok[q] = has && cv[q] < nv;
      hq[q] = ok[q] ? cv[q] * VEC / head_cols : 0;
    }
    if (chunk != wf_chunk) {
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const bool col_ok = cv[q] < nv;
          const int col = cv[q] * VEC + i;
#pragma unroll
          for (int k = 0; k < KF; ++k)
            wfr[q * VEC + i][k] =
                col_ok && k < fe ? __ldg(wf + k * f + col) : 0.f;
        }
      }
      wf_chunk = chunk;
    }
    float acc[CPL][VEC];
    V oq[CPL];  // the row's own operand, the bias row added
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[q][i] = 0.f;
      oq[q] = ok[q] ? __ldg(reinterpret_cast<const V*>(own + r * f) + cv[q])
                    : zero_vec<V>();
      if (ok[q] && bias != nullptr)
        oq[q] = add_vec(oq[q],
                        __ldg(reinterpret_cast<const V*>(bias) + cv[q]));
    }

    const int p_lo = has ? ptr[r] : 0;
    const int p_hi = has ? ptr[r + 1] : p_lo;
    for (int pb = p_lo; pb < p_hi; pb += lpr) {  // uniform in the group
      const int n = min(lpr, p_hi - pb);
      // this lane's entry: its neighbour, slot and weight offset
      int my_nbr = 0, my_slot = 0, my_wb = 0;
      if (li < n) {
        my_nbr = nbr[pb + li];
        my_slot = slot[pb + li];
        const int b = my_slot / cap;
        my_wb = b * w_bs + (my_slot - b * cap) * w_cs;
      }
      for (int u0 = 0; u0 < n; u0 += U) {
        // the edge features of entries u0 .. u0 + U - 1: vector j of
        // entry u at es[u * KQ + j]
        for (int k0 = 0; k0 < U * KQ; k0 += lpr) {  // uniform in the group
          const int k = k0 + li;
          const int u = k / KQ;
          const int j = k - u * KQ;
          const int s = __shfl_sync(gmask, my_slot, u0 + u, lpr);
          if (k < U * KQ && u0 + u < n && j < fq)
            cp_async16(es + k, ef + static_cast<long long>(s) * fq + j);
        }
        float wq[U][CPL];
        V xv[U][CPL];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bool live = u0 + u < n;
          const int wb = __shfl_sync(gmask, my_wb, u0 + u, lpr);
          const V* yr = reinterpret_cast<const V*>(
              y + __shfl_sync(gmask, my_nbr, u0 + u, lpr) * f);
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            const bool on = live && ok[q];
            wq[u][q] = on ? __ldg(w + wb + hq[q] * w_hs) : 0.f;
            xv[u][q] = on ? __ldg(yr + cv[q]) : zero_vec<V>();
          }
        }
        cp_async_wait_all();
        __syncwarp(gmask);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u0 + u >= n) break;  // uniform in the group
          float fv[NC];  // fe of the lane's columns
#pragma unroll
          for (int c = 0; c < NC; ++c) fv[c] = 0.f;
#pragma unroll
          for (int j = 0; j < KQ; ++j) {
            if (j >= fq) break;  // uniform
            const float4 e = es[u * KQ + j];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              fv[c] = fmaf(e.x, wfr[c][4 * j], fv[c]);
              fv[c] = fmaf(e.y, wfr[c][4 * j + 1], fv[c]);
              fv[c] = fmaf(e.z, wfr[c][4 * j + 2], fv[c]);
              fv[c] = fmaf(e.w, wfr[c][4 * j + 3], fv[c]);
            }
          }
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              const float raw = (elem(oq[q], i) + elem(xv[u][q], i)) +
                                fv[q * VEC + i];
              acc[q][i] = fmaf(wq[u][q], raw >= 0.f ? 1.f : slope,
                               acc[q][i]);
            }
          }
        }
        __syncwarp(gmask);  // the group's reads before the next copies
      }
    }
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      if (!ok[q]) continue;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[q][i] *= __ldg(attn + cv[q] * VEC + i);
      store_vec(out + r * f + cv[q] * VEC, acc[q], Vec<VEC>());
    }
  }
}

// The stored slot tensors' elements (T float or __nv_bfloat16) as f32
// vectors of VEC, read once by a walk (evict first: the node rows it
// gathers stay in L2), and written so
template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T ld_stored(const float* p) {
  return __ldcs(reinterpret_cast<const typename Vec<VEC>::T*>(p));
}
template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T ld_stored(
    const __nv_bfloat16* p);
template <>
__device__ __forceinline__ float ld_stored<1>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <>
__device__ __forceinline__ float4 ld_stored<4>(const __nv_bfloat16* p) {
  const uint2 raw = __ldcs(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st_stored(float* p, const float* a, Vec<1>) {
  __stcs(p, a[0]);
}
__device__ __forceinline__ void st_stored(float* p, const float* a, Vec<4>) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
}
__device__ __forceinline__ void st_stored(__nv_bfloat16* p, const float* a,
                                          Vec<1>) {
  *p = __float2bfloat16(a[0]);
}
__device__ __forceinline__ void st_stored(__nv_bfloat16* p, const float* a,
                                          Vec<4>) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  __stcs(reinterpret_cast<uint2*>(p), raw);
}

// What the slot walk sums at row r for column j (head h(j) = j /
// head_cols) over the row's entries k (slot s, neighbour n): the C API's
// mode codes, kSlotVec serving both of its sides (4, 5)
enum SlotMode : int {
  kSlotFeat = 1,   // w[s, h(j)] * t[s, j % t_cols]       (K10 v2's S, Q)
  kSlotFe = 2,     // w[s, h(j)] * (node[n, j] + t[s, j])  (K10 v1's num)
  kSlotDxDfe = 3,  // w[s, h(j)] * node[n, j], also stored at t[s, j]
  kSlotVec = 4,    // t[s, j]                              (dFNJ, dFNI)
};

// entries a lane of the slot walk keeps in flight: 8, or 4 where it keeps
// more than 4 columns (each entry holds a weight and two vectors)
template <int VEC, int CPL>
struct SlotUnroll {
  static constexpr int value = VEC * CPL <= 4 ? 8 : 4;
};

// The slot walk: out[r, j] = the sum over row r's entries k, in entry
// (slot) order, of the mode's term.  The row walk's lanes (a group of lpr
// lanes a row, VEC floats a load, CPL vectors a lane, the f / VEC vectors
// in n_chunks chunks); each lane reads its own head's weight of an entry
// (w through its strides: one sector for a slot's H weights where it is
// slot-major), gathers its vectors of node[n] and reads its vectors of
// the stored row t[s] (64-bit offsets), U entries in flight, all before
// the arithmetic; kSlotDxDfe writes w * node[n] at t[s] on the way.  No
// shared memory, no atomics on out, every output written once (0 on a row
// with no entry): the same bits every run.
template <int VEC, int CPL, int kMode, typename T>
__global__ void __launch_bounds__(kWarps * 32)
row_slot_kernel(const int* __restrict__ ptr, const int* __restrict__ slot,
                const int* __restrict__ nbr, const int* __restrict__ order,
                int rows, const float* __restrict__ w, int cap, int w_bs,
                int w_hs, int w_cs, int head_cols,
                const float* __restrict__ node, T* t, int t_cols, int f,
                int lpr, int n_chunks, float* __restrict__ out,
                int* __restrict__ counter) {
  using V = typename Vec<VEC>::T;
  constexpr int U = SlotUnroll<VEC, CPL>::value;
  constexpr bool kWeighted = kMode != kSlotVec;
  constexpr bool kNode = kMode == kSlotFe || kMode == kSlotDxDfe;
  constexpr bool kReadsT = kMode != kSlotDxDfe;
  const int lane = threadIdx.x & 31;
  const int groups = 32 / lpr;  // rows a warp takes at once
  const int grp = lane / lpr;
  const int li = lane - grp * lpr;
  const unsigned gmask =
      lpr == 32 ? kFull : ((1u << lpr) - 1u) << (grp * lpr);
  const int nv = f / VEC;  // column vectors a row
  const int n_items = rows * n_chunks;

  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, groups);
    base = __shfl_sync(kFull, base, 0);
    if (base >= n_items) break;
    const int item = base + grp;
    const bool has = item < n_items;
    const int r = has ? order[item / n_chunks] : 0;
    const int chunk = has ? item - (item / n_chunks) * n_chunks : 0;
    int cv[CPL];    // this lane's column vectors
    bool ok[CPL];
    int hw[CPL];    // their head's offset in a slot's weights
    int tc[CPL];    // their first column of a stored row
    float acc[CPL][VEC];
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      cv[q] = (chunk * CPL + q) * lpr + li;
      ok[q] = has && cv[q] < nv;
      const int col = ok[q] ? cv[q] * VEC : 0;
      hw[q] = col / head_cols * w_hs;
      tc[q] = col - col / t_cols * t_cols;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[q][i] = 0.f;
    }

    const int p_lo = has ? ptr[r] : 0;
    const int p_hi = has ? ptr[r + 1] : p_lo;
    for (int pb = p_lo; pb < p_hi; pb += lpr) {  // uniform in the group
      const int n = min(lpr, p_hi - pb);
      // this lane's entry: its slot, neighbour and weight offset
      int my_slot = 0, my_node = 0, my_wb = 0;
      if (li < n) {
        my_slot = slot[pb + li];
        if (kNode) my_node = nbr[pb + li];
        const int b = my_slot / cap;
        my_wb = b * w_bs + (my_slot - b * cap) * w_cs;
      }
      for (int u0 = 0; u0 < n; u0 += U) {
        float wq[U][CPL];
        V nq[U][CPL];
        V tq[U][CPL];
        long long to[U];  // the entries' stored rows
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bool in_row = u0 + u < n;
          to[u] = static_cast<long long>(
                      __shfl_sync(gmask, my_slot, u0 + u, lpr)) * t_cols;
          const int wb = __shfl_sync(gmask, my_wb, u0 + u, lpr);
          const V* node_row = reinterpret_cast<const V*>(
              node + __shfl_sync(gmask, my_node, u0 + u, lpr) * f);
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            const bool on = in_row && ok[q];
            wq[u][q] = kWeighted && on ? __ldg(w + wb + hw[q]) : 0.f;
            nq[u][q] = kNode && on ? __ldg(node_row + cv[q]) : zero_vec<V>();
            tq[u][q] = kReadsT && on ? ld_stored<VEC>(t + to[u] + tc[q])
                                     : zero_vec<V>();
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (u0 + u >= n) break;  // uniform in the group
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            if constexpr (kMode == kSlotFe) {
              fma_into(acc[q], wq[u][q], add_vec(nq[u][q], tq[u][q]));
            } else if constexpr (kMode == kSlotFeat) {
              fma_into(acc[q], wq[u][q], tq[u][q]);
            } else if constexpr (kMode == kSlotVec) {
              fma_into(acc[q], 1.f, tq[u][q]);
            } else {  // kSlotDxDfe: the product is dfe and dx's term
              float prod[VEC];
#pragma unroll
              for (int i = 0; i < VEC; ++i) {
                prod[i] = wq[u][q] * elem(nq[u][q], i);
                acc[q][i] += prod[i];
              }
              if (ok[q]) st_stored(t + to[u] + tc[q], prod, Vec<VEC>());
            }
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      if (ok[q]) store_vec(out + r * f + cv[q] * VEC, acc[q], Vec<VEC>());
    }
  }
}

// kSlotDxDfe's zeros: the rows of t (slots, f) at the slots whose valid is
// 0 (the walk writes every listed slot's).  A warp reads 32 slots' valid
// flags, then writes each padded slot's row, its lanes a column apart.
template <typename T>
__global__ void __launch_bounds__(256)
slot_zero_kernel(const float* __restrict__ valid, long long slots, T* t,
                 int f) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * 8;
  for (long long s0 = (blockIdx.x * 8LL + (threadIdx.x >> 5)) * 32;
       s0 < slots; s0 += warps * 32) {
    const bool pad = s0 + lane < slots && valid[s0 + lane] == 0.f;
    for (unsigned m = __ballot_sync(kFull, pad); m != 0u; m &= m - 1u) {
      T* row = t + (s0 + __ffs(m) - 1) * f;
      for (int j = lane; j < f; j += 32) row[j] = T(0.f);
    }
  }
}

// entries a lane of K11 v1's slot-gradient walk keeps in flight: each
// holds an FE vector, a U vector and a ds value a column vector.  One at
// one float a load: with 4 the <1, 2, float> instance spilled 28 bytes at
// 80 registers and ran 6% slower at (1, 41) on an H100 (the probe edits
// vec1_unroll4 and vec1_unroll2 of tools/perf_slot_grad_scores.py)
template <int VEC, int CPL>
struct SlotGradUnroll {
  static constexpr int value = VEC == 1 ? 1 : VEC * CPL <= 4 ? 4 : 2;
};
// dFNJ summed on the walk; without it the walk writes only dFE and da
// (the probe's edit "unfolded", which slot_vec_reduce by dst then follows)
constexpr bool kSlotGradFold = true;
constexpr int kRangeSubs = 8;  // warps of a range-sum block

// an f32 value as a stored slot tensor of T holds it, read back as f32
__device__ __forceinline__ float as_stored(float v, const float*) {
  return v;
}
__device__ __forceinline__ float as_stored(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// K11 v1's slot gradient by the slot walk by dst: for each entry (slot s,
// neighbour n = src) of row r and column j of head h,
//
//   raw = (u[n, j] + v[r, j]) + fe[s, j]
//   dfe[s, j] = ds[s, h] * attn[j] * (raw >= 0 ? 1 : slope)   (in T)
//   dfnj[r, j] = sum over the row's entries of dfe[s, j] as stored
//   da[j] += ds[s, h] * lrelu(raw)
//
// The slot walk's lanes (a group of lpr lanes a row, VEC floats a load,
// CPL vectors a lane, the f / VEC vectors in n_chunks chunks); each lane
// keeps v[r] and attn for its columns in registers and, for U entries at
// once, reads its head's ds (through its strides: one sector a slot where
// slot-major), gathers its vectors of u[n] and reads those of fe[s]
// (64-bit offsets, evict first), all before the arithmetic; it writes dW
// at dfe[s] (evict first) and adds it, rounded to T, into the row's sum in
// entry order, kSlotVec's order.  The rows of the claim order are taken in
// static ranges of range_rows, a warp a range claimed from the counter
// (the warp's groups take its rows in turn); each lane sums da over its
// range in registers, the groups combine theirs by shuffles in a fixed
// order, and the range's partial row is written to part[k] once: the
// range-sum passes add the partials in range order, so da, like dfe and
// dfnj, has the same bits every run.  No atomics on any output.
template <int VEC, int CPL, typename T>
__global__ void __launch_bounds__(kWarps * 32)
row_slot_grad_kernel(const int* __restrict__ ptr,
                     const int* __restrict__ slot,
                     const int* __restrict__ nbr,
                     const int* __restrict__ order, int rows, int range_rows,
                     int n_ranges, const float* __restrict__ ds, int cap,
                     int d_bs, int d_hs, int d_cs, int head_cols,
                     const float* __restrict__ u,
                     const float* __restrict__ v,
                     const float* __restrict__ attn, float slope,
                     const T* __restrict__ fe, T* __restrict__ dfe, int f,
                     int lpr, int n_chunks, float* __restrict__ dfnj,
                     float* __restrict__ part, int* __restrict__ counter) {
  using V = typename Vec<VEC>::T;
  constexpr int U = SlotGradUnroll<VEC, CPL>::value;
  const int lane = threadIdx.x & 31;
  const int groups = 32 / lpr;  // rows a warp takes at once
  const int grp = lane / lpr;
  const int li = lane - grp * lpr;
  const unsigned gmask =
      lpr == 32 ? kFull : ((1u << lpr) - 1u) << (grp * lpr);
  const int nv = f / VEC;  // column vectors a row

  for (;;) {
    int k = 0;
    if (lane == 0) k = atomicAdd(counter, 1);
    k = __shfl_sync(kFull, k, 0);
    if (k >= n_ranges) break;
    const int first = k * range_rows;
    const int last = min(first + range_rows, rows);
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      int cv[CPL];   // this lane's column vectors
      bool ok[CPL];
      int hd[CPL];   // their head's offset in a slot's ds
      V a[CPL];
      float da[CPL][VEC];
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        cv[q] = (chunk * CPL + q) * lpr + li;
        ok[q] = cv[q] < nv;
        const int col = ok[q] ? cv[q] * VEC : 0;
        hd[q] = col / head_cols * d_hs;
        a[q] = ok[q] ? __ldg(reinterpret_cast<const V*>(attn) + cv[q])
                     : zero_vec<V>();
#pragma unroll
        for (int i = 0; i < VEC; ++i) da[q][i] = 0.f;
      }
      for (int item = first + grp; item < last; item += groups) {
        const int r = order[item];
        const V* v_row = reinterpret_cast<const V*>(v + r * f);
        V vr[CPL];
        float acc[CPL][VEC];
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          vr[q] = ok[q] ? __ldg(v_row + cv[q]) : zero_vec<V>();
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[q][i] = 0.f;
        }
        const int p_lo = ptr[r];
        const int p_hi = ptr[r + 1];
        for (int pb = p_lo; pb < p_hi; pb += lpr) {  // uniform in the group
          const int n = min(lpr, p_hi - pb);
          // this lane's entry: its slot, neighbour and ds offset
          int my_slot = 0, my_node = 0, my_db = 0;
          if (li < n) {
            my_slot = slot[pb + li];
            my_node = nbr[pb + li];
            const int b = my_slot / cap;
            my_db = b * d_bs + (my_slot - b * cap) * d_cs;
          }
          for (int u0 = 0; u0 < n; u0 += U) {
            float dq[U][CPL];
            V uq[U][CPL];
            V fq[U][CPL];
            long long so[U];  // the entries' stored rows
#pragma unroll
            for (int e = 0; e < U; ++e) {
              const bool in_row = u0 + e < n;
              so[e] = static_cast<long long>(
                          __shfl_sync(gmask, my_slot, u0 + e, lpr)) * f;
              const int db = __shfl_sync(gmask, my_db, u0 + e, lpr);
              const V* u_row = reinterpret_cast<const V*>(
                  u + __shfl_sync(gmask, my_node, u0 + e, lpr) * f);
#pragma unroll
              for (int q = 0; q < CPL; ++q) {
                const bool on = in_row && ok[q];
                dq[e][q] = on ? __ldg(ds + db + hd[q]) : 0.f;
                uq[e][q] = on ? __ldg(u_row + cv[q]) : zero_vec<V>();
                fq[e][q] = on ? ld_stored<VEC>(fe + so[e] + cv[q] * VEC)
                              : zero_vec<V>();
              }
            }
#pragma unroll
            for (int e = 0; e < U; ++e) {
              if (u0 + e >= n) break;  // uniform in the group
#pragma unroll
              for (int q = 0; q < CPL; ++q) {
                float dw[VEC];
#pragma unroll
                for (int i = 0; i < VEC; ++i) {
                  const float raw = (elem(uq[e][q], i) + elem(vr[q], i)) +
                                    elem(fq[e][q], i);
                  const bool pos = raw >= 0.f;
                  da[q][i] = fmaf(dq[e][q], pos ? raw : slope * raw,
                                  da[q][i]);
                  dw[i] = dq[e][q] * elem(a[q], i) * (pos ? 1.f : slope);
                  if (kSlotGradFold) acc[q][i] += as_stored(dw[i], dfe);
                }
                if (ok[q]) st_stored(dfe + so[e] + cv[q] * VEC, dw, Vec<VEC>());
              }
            }
          }
        }
        if (kSlotGradFold) {
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            if (ok[q]) store_vec(dfnj + r * f + cv[q] * VEC, acc[q],
                                 Vec<VEC>());
          }
        }
      }
      // the groups' da of this range, combined in a fixed order in every
      // lane, written once by the first group
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          for (int off = lpr; off < 32; off <<= 1) {
            da[q][i] += __shfl_xor_sync(kFull, da[q][i], off);
          }
        }
        if (grp == 0 && ok[q]) {
          store_vec(part + static_cast<long long>(k) * f + cv[q] * VEC,
                    da[q], Vec<VEC>());
        }
      }
    }
  }
}

// out[s, j] = the sum of in[i, j] over the rows i in [s * seg, min(n, (s +
// 1) * seg)), in a fixed order: warp w of the block sums the rows w, w +
// kRangeSubs, ... of the segment, and the first warp adds the warps' sums
// in warp order.  Block (x, s) takes columns 32 x .. 32 x + 31 of segment
// s.  Twice over the slot-gradient walk's range partials: the segments'
// sums, then their sum, da.
__global__ void __launch_bounds__(32 * kRangeSubs)
range_sum_kernel(const float* __restrict__ in, int n, int f, int seg,
                 float* __restrict__ out) {
  __shared__ float sums[kRangeSubs][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  const int lo = blockIdx.y * seg;
  const int hi = min(n, lo + seg);
  float s = 0.f;
  if (j < f) {
    for (int i = lo + w; i < hi; i += kRangeSubs) {
      s += in[static_cast<long long>(i) * f + j];
    }
  }
  sums[w][lane] = s;
  __syncthreads();
  if (w == 0 && j < f) {
    float t = sums[0][lane];
#pragma unroll
    for (int i = 1; i < kRangeSubs; ++i) t += sums[i][lane];
    out[static_cast<long long>(blockIdx.y) * f + j] = t;
  }
}

// K6's slot reduce by rows: out[r, h] = the sum over row r's entries k of
// vals[b, h, c], slot[k] = b * cap + c, vals read through its strides
// (v_bs, v_hs, v_cs).  A group of lpr lanes owns a row: lps lanes take a
// slot's heads (VEC at a time: 16-byte loads where the layout is
// slot-major and H is a multiple of 4; CPL vectors a lane; a row of more
// heads than lps * CPL * VEC in n_chunks column chunks, each claimed as
// an item of its own), and the group's lpr / lps slot lanes take the
// row's entries in turn, kU of each lane's in flight: its slot ids first,
// then their values.  Each lane sums its entries in entry order in
// registers; the slot lanes of one head then combine their sums by an xor
// butterfly, in the same order in every lane, and the first writes the
// sum: every output written once, 0 on a row with no entry, the same
// bits from run to run.
template <int VEC, int CPL>
__global__ void __launch_bounds__(kWarps * 32)
row_reduce_kernel(const int* __restrict__ ptr, const int* __restrict__ slot,
                  const int* __restrict__ order, int rows,
                  const float* __restrict__ vals, int cap, int v_bs,
                  int v_hs, int v_cs, int heads, int lps, int lpr,
                  int n_chunks, float* __restrict__ out,
                  int* __restrict__ counter) {
  using V = typename Vec<VEC>::T;
  constexpr int kU = Unroll<VEC, CPL>::value;
  const int lane = threadIdx.x & 31;
  const int groups = 32 / lpr;  // rows a warp takes at once
  const int grp = lane / lpr;
  const int li = lane - grp * lpr;
  const unsigned gmask =
      lpr == 32 ? kFull : ((1u << lpr) - 1u) << (grp * lpr);
  const int sl = li / lps;      // this lane's slot lane
  const int vl = li - sl * lps;  // and its vector lane
  const int spr = lpr / lps;    // slots a round
  const int nv = heads / VEC;   // head vectors a slot
  const int n_items = rows * n_chunks;
  // slot-major and contiguous: slot s's values at s * v_cs, no division
  const bool flat = v_bs == cap * v_cs;

  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, groups);
    base = __shfl_sync(kFull, base, 0);
    if (base >= n_items) break;
    const int item = base + grp;
    const bool has = item < n_items;
    const int r = has ? order[item / n_chunks] : 0;
    const int chunk = has ? item - (item / n_chunks) * n_chunks : 0;
    int cv[CPL];    // this lane's head vectors
    bool ok[CPL];
    float acc[CPL][VEC];
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      cv[q] = (chunk * CPL + q) * lps + vl;
      ok[q] = has && cv[q] < nv;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[q][i] = 0.f;
    }
    const int p0 = has ? ptr[r] : 0;
    const int p1 = has ? ptr[r + 1] : p0;  // no entry past the last row
    for (int pb = p0; pb < p1; pb += spr * kU) {  // uniform in the group
      int off[kU];   // the values' offsets of this lane's kU entries
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int k = pb + u * spr + sl;
        off[u] = -1;
        if (k < p1) {
          const int s = __ldg(slot + k);
          if (flat) {
            off[u] = s * v_cs;
          } else {
            const int b = s / cap;
            off[u] = b * v_bs + (s - b * cap) * v_cs;
          }
        }
      }
      V xv[kU][CPL];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          // VEC > 1 only where v_hs is 1 (the wrapper's layout)
          xv[u][q] = off[u] >= 0 && ok[q]
                         ? __ldg(reinterpret_cast<const V*>(
                               vals + off[u] + cv[q] * VEC * v_hs))
                         : zero_vec<V>();
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int q = 0; q < CPL; ++q) fma_into(acc[q], 1.f, xv[u][q]);
      }
    }
    // the slot lanes' sums of one head combined, in a fixed order
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        for (int o = lps; o < lpr; o *= 2)
          acc[q][i] += __shfl_xor_sync(gmask, acc[q][i], o, lpr);
      }
    }
    if (sl != 0) continue;
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      if (ok[q]) store_vec(out + r * heads + cv[q] * VEC, acc[q], Vec<VEC>());
    }
  }
}

// K10 v1's stored message in the ds walk (row_sddmm_kernel's kStore):
// fe_s (slots, F) of type T at the launch's first head and column, fs_row
// elements a slot, fs_head between heads, fs_cols columns of a head from
// the launch's first (past them the padded vector holds 0), read 4 at a
// time where fs_vec, else one a load; slot, the view's slot of each entry
struct DsTerm {
  const int* slot;
  const void* fs;
  long long fs_row;
  int fs_head, fs_cols, fs_vec;
};

// fe_s's 4 columns from c of a head's row at fs as f32, 0 at columns past
// fs_cols (read once: evict first)
template <typename T>
__device__ __forceinline__ float4 ld_term(const T* fs, int c,
                                          const DsTerm& term) {
  if (term.fs_vec) return ld_stored<4>(fs);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = c + i < term.fs_cols ? ld_stored<1>(fs + i) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The dot-product row walk (K4's SDDMM).  A group of lpr lanes owns row r
// (a dst node) and keeps z[r] of the launch's heads and columns in
// registers; for U slots of the row at a time it gathers x[nbr] (16-byte
// loads, the head width a multiple of 4 floats), forms each head's dot
// with an xor-shuffle reduction over that head's lph lanes and writes it
// for entry k of the view at out[k * ostride + h]; slot_finish_kernel
// turns that scratch into (B, H, C).
//
// A launch walks `heads` heads of `hv` vectors each: x, z and out come
// offset to the launch's first head and column, a row of x and z is f
// floats and its heads hstride vectors apart.  A row wider than the
// registers hold (cpl <= 8: 1,024 floats) takes several launches, each a
// group of heads or a chunk of a head's columns (the wrapper's plan).
//
// Lane layout: lane li of the group holds head hl + k * (lpr / lph) and
// vector fl + j * lph of that head (hl = li / lph, fl = li % lph) for
// q = k * cph + j < CPL; cph is a power of two, so that the tree that sums
// a head's cph vectors in the lane stays within the head.
//
// Reduction: a lane first sums its cph vectors of a head, then a head's
// lph lanes reduce the U slots of a round together in a butterfly that
// halves the values a lane holds at each step: at offset o a lane keeps
// the upper half of its slots if bit o of fl is set, the lower half
// otherwise, and adds its partner's half of the same slots.  U slots cost
// U - 1 shuffles (and log2(lph / U) more where lph > U) where a
// reduction a slot costs U log2(lph), and at the end the lanes hold
// different slots, so one store instruction writes up to U slots.  Each
// output is stored by one lane (`writer`), at an entry of the group's own
// row: no two lanes store to one address.
//
// kVattn (K9's scores): x is U, z is V, and attn (one row laid out as z's,
// offset to the launch's first head and column) stays in registers beside
// V[r]; a lane's partial is attn . lrelu(U + V) over its four floats.
//
// kStore (K10 v1's ds, DsTerm): the walk also reads each entry's slot and
// adds the entry's stored fe_s columns (of type T, at the slot) to x's
// vector before the product.
template <int CPL, bool kVattn, bool kStore = false, typename T = float>
__global__ void __launch_bounds__(kWarps * 32)
row_sddmm_kernel(const int* __restrict__ ptr, const int* __restrict__ nbr,
                 const int* __restrict__ order, int rows,
                 const float* __restrict__ x, const float* __restrict__ z,
                 int f, int hstride, int heads, int hv, int lph, int cph,
                 int lpr, float* __restrict__ out, int ostride,
                 int* __restrict__ counter, const float* __restrict__ attn,
                 float slope, const DsTerm term) {
  constexpr int U = Unroll<4, CPL>::value;
  constexpr int kLogU = Log2<U>::value;
  const int lane = threadIdx.x & 31;
  const int groups = 32 / lpr;
  const int grp = lane / lpr;
  const int li = lane - grp * lpr;
  const unsigned gmask =
      lpr == 32 ? kFull : ((1u << lpr) - 1u) << (grp * lpr);
  const int hl = li / lph;
  const int fl = li - hl * lph;
  const int hpp = lpr / lph;   // heads a pass
  int vq[CPL];    // this lane's vectors within a row, and their heads
  int hq[CPL];
  bool ok[CPL];
  bool first[CPL];   // q is its head's first vector in the lane
  int fc[CPL];       // kStore: q's first column of its head in fe_s
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    const int k = q / cph;
    const int v = fl + (q - k * cph) * lph;
    hq[q] = hl + k * hpp;
    ok[q] = hq[q] < heads && v < hv;
    fc[q] = 4 * v;
    vq[q] = ok[q] ? hq[q] * hstride + v : 0;
    first[q] = q == k * cph;
  }
  // the butterfly: `steps` halving steps leave a lane m of the U slots,
  // from slot `bu` on; `rest` lanes then share each slot, and the first
  // of them writes it
  const int lg_lph = __ffs(lph) - 1;
  const int steps = min(kLogU, lg_lph);
  const int m = U >> steps;
  const int rest = lph >> steps;
  int bu = 0;
  for (int t = 0; t < steps; ++t) {
    if ((fl >> (lg_lph - 1 - t)) & 1) bu += U >> (t + 1);
  }
  const bool writer = (fl & (rest - 1)) == 0;
  float4 aq[kVattn ? CPL : 1];   // attn of this lane's vectors
  if constexpr (kVattn) {
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      aq[q] = ok[q] ? __ldg(reinterpret_cast<const float4*>(attn) + vq[q])
                    : zero_vec<float4>();
    }
  }

  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, groups);
    base = __shfl_sync(kFull, base, 0);
    if (base >= rows) break;
    const int item = base + grp;
    const bool has = item < rows;
    const int r = has ? order[item] : 0;

    float4 zq[CPL];
    const float4* zr = reinterpret_cast<const float4*>(z + r * f);
#pragma unroll
    for (int q = 0; q < CPL; ++q) {
      zq[q] = has && ok[q] ? __ldg(zr + vq[q]) : zero_vec<float4>();
    }
    const int p0 = has ? ptr[r] : 0;
    const int p1 = has ? ptr[r + 1] : p0;  // no slot past the last row
    for (int pb = p0; pb < p1; pb += lpr) {  // uniform in the group
      const int n = min(lpr, p1 - pb);
      int my_nbr = 0, my_out = 0;  // this lane's slot: neighbour, out offset
      if (li < n) {
        my_nbr = nbr[pb + li];
        my_out = (pb + li) * ostride;
      }
      int my_slot = 0;  // kStore: the entry's slot
      if (kStore && li < n) my_slot = term.slot[pb + li];
      for (int u0 = 0; u0 < n; u0 += U) {
        float4 xv[U][CPL];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int nb = __shfl_sync(gmask, my_nbr, u0 + u, lpr);
          const bool live = u0 + u < n;
          const float4* xr = reinterpret_cast<const float4*>(x + nb * f);
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            xv[u][q] = live && ok[q] ? __ldg(xr + vq[q]) : zero_vec<float4>();
          }
          if constexpr (kStore) {
            const long long s = __shfl_sync(gmask, my_slot, u0 + u, lpr);
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
              if (live && ok[q]) {
                const T* fs = static_cast<const T*>(term.fs) +
                              s * term.fs_row + hq[q] * term.fs_head + fc[q];
                xv[u][q] = add_vec(xv[u][q], ld_term(fs, fc[q], term));
              }
            }
          }
        }
        float d[CPL][U];   // this lane's partial dots, vector q, slot u
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if constexpr (kVattn) {
              d[q][u] = vattn_dot(aq[q], xv[u][q], zq[q], slope);
            } else {
              d[q][u] = xv[u][q].x * zq[q].x;
              d[q][u] = fmaf(xv[u][q].y, zq[q].y, d[q][u]);
              d[q][u] = fmaf(xv[u][q].z, zq[q].z, d[q][u]);
              d[q][u] = fmaf(xv[u][q].w, zq[q].w, d[q][u]);
            }
          }
        }
        // a head's cph vectors (q = k * cph ..) summed into its first
#pragma unroll
        for (int sp = 1; sp < CPL; sp *= 2) {
          if (sp >= cph) break;
#pragma unroll
          for (int q = 0; q + sp < CPL; q += 2 * sp) {
#pragma unroll
            for (int u = 0; u < U; ++u) d[q][u] += d[q + sp][u];
          }
        }
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          if (!first[q]) continue;  // uniform in the group
          int o = lph >> 1;
#pragma unroll
          for (int half = U / 2; half >= 1; half /= 2) {
            if (o == 0) break;
            const bool up = (fl & o) != 0;
#pragma unroll
            for (int i = 0; i < half; ++i) {
              const float send = up ? d[q][i] : d[q][i + half];
              const float keep = up ? d[q][i + half] : d[q][i];
              d[q][i] = keep + __shfl_xor_sync(gmask, send, o, lpr);
            }
            o >>= 1;
          }
          for (; o > 0; o >>= 1) {
            d[q][0] += __shfl_xor_sync(gmask, d[q][0], o, lpr);
          }
#pragma unroll
          for (int i = 0; i < U; ++i) {
            if (i >= m) break;  // uniform in the group
            const int u = u0 + bu + i;
            const int ob = __shfl_sync(gmask, my_out, u, lpr);
            if (writer && u < n && hq[q] < heads) {
              __stcs(out + ob + hq[q], d[q][i]);
            }
          }
        }
      }
    }
  }
}

// K11 v2's scores (row_vattn_fe_kernel): the entries a group keeps in
// flight, fewer where the lane's KF rows of wf (4 KF registers) take more.
// At KF 16 (EGAT's 16 features) ptxas keeps 4 entries in 128 registers
// with 16 bytes of local memory a thread, 2 blocks an SM; that ran faster
// on an H100 than 8 entries in more registers at 1 block an SM (the edit
// u2x of dgl_tpu_torch/tools/perf_fwd_scores.py, PERF.md)
template <int KF>
struct FeScoreUnroll {
  static constexpr int value = KF <= 16 ? 4 : 2;
};

// K11 v2's scores on the dot-product walk, the edge term formed per entry:
// row_sddmm_kernel's scores mode at one vector a lane (lph >= hv, a head a
// lane, at least kFeMinLanes lanes a row, so that a warp's groups stage at
// most kFeGroups rows' edge features at once).  The lane holds its four
// columns of wf (KF rows, zero past fe) and of attn, and adds the bias
// row's to V[r] once a row; a step of U entries copies their
// edge-feature rows (ef in slot order, fq 16-byte vectors a row, read at
// the view's slot) into the group's shared memory with cp.async beside
// the gathers of U[nbr], then forms fe = ef[slot] . wf[:fe] for the lane's
// columns and the partial attn . lrelu((V[r] + bias) + U[nbr] + fe); the
// U partials of a head meet in row_sddmm_kernel's butterfly and go to the
// entry-major scratch, a head's dot at entry k at out[k * ostride + h].
template <int KF>
__global__ void __launch_bounds__(kWarps * 32)
row_vattn_fe_kernel(const int* __restrict__ ptr, const int* __restrict__ nbr,
                    const int* __restrict__ order, int rows,
                    const float* __restrict__ u, const float* __restrict__ v,
                    int f, int hstride, int heads, int hv, int lph, int lpr,
                    float* __restrict__ out, int ostride,
                    int* __restrict__ counter, const float* __restrict__ attn,
                    float slope, const int* __restrict__ slot,
                    const float4* __restrict__ ef, int fq,
                    const float* __restrict__ wf, int fe,
                    const float* __restrict__ bias) {
  constexpr int U = FeScoreUnroll<KF>::value;
  constexpr int kLogU = Log2<U>::value;
  constexpr int KQ = KF / 4;  // 16-byte vectors of an entry's features
  __shared__ float4 efs[kWarps][kFeGroups * U * KQ];
  const int lane = threadIdx.x & 31;
  const int groups = 32 / lpr;
  const int grp = lane / lpr;
  const int li = lane - grp * lpr;
  const unsigned gmask =
      lpr == 32 ? kFull : ((1u << lpr) - 1u) << (grp * lpr);
  float4* es = efs[threadIdx.x >> 5] + grp * U * KQ;  // the group's part
  const int hl = li / lph;         // the lane's head
  const int fl = li - hl * lph;    // and its vector of the head
  const bool ok = hl < heads && fl < hv;
  const int vc = ok ? hl * hstride + fl : 0;  // the vector within a row
  // the butterfly of row_sddmm_kernel over the head's lph lanes
  const int lg_lph = __ffs(lph) - 1;
  const int steps = min(kLogU, lg_lph);
  const int m = U >> steps;
  const int rest = lph >> steps;
  int bu = 0;
  for (int t = 0; t < steps; ++t) {
    if ((fl >> (lg_lph - 1 - t)) & 1) bu += U >> (t + 1);
  }
  const bool writer = (fl & (rest - 1)) == 0;
  const float4 av =
      ok ? __ldg(reinterpret_cast<const float4*>(attn) + vc)
         : zero_vec<float4>();
  float wfr[4][KF];  // the lane's columns of wf, by feature
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < KF; ++k)
      wfr[i][k] = ok && k < fe ? __ldg(wf + k * f + 4 * vc + i) : 0.f;
  }

  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, groups);
    base = __shfl_sync(kFull, base, 0);
    if (base >= rows) break;
    const int item = base + grp;
    const bool has = item < rows;
    const int r = has ? order[item] : 0;
    // V[r] and the bias row, added once a row (the bias read again a row:
    // held beside wf's columns it cost ptxas registers)
    const float4 vb = add_vec(
        has && ok ? __ldg(reinterpret_cast<const float4*>(v + r * f) + vc)
                  : zero_vec<float4>(),
        ok && bias != nullptr
            ? __ldg(reinterpret_cast<const float4*>(bias) + vc)
            : zero_vec<float4>());
    const int e0 = has ? ptr[r] : 0;
    const int e1 = has ? ptr[r + 1] : e0;
    for (int eb = e0; eb < e1; eb += lpr) {  // uniform in the group
      const int n = min(lpr, e1 - eb);
      // this lane's entry: its neighbour, scratch offset and slot
      int my_nb = 0, my_at = 0, my_sl = 0;
      if (li < n) {
        my_nb = nbr[eb + li];
        my_at = (eb + li) * ostride;
        my_sl = slot[eb + li];
      }
      for (int u0 = 0; u0 < n; u0 += U) {
        // the edge features of entries u0 .. u0 + U - 1: vector j of
        // entry k at es[k * KQ + j]
        for (int c0 = 0; c0 < U * KQ; c0 += lpr) {  // uniform in the group
          const int c = c0 + li;
          const int k = c / KQ;
          const int j = c - k * KQ;
          const int s = __shfl_sync(gmask, my_sl, u0 + k, lpr);
          if (c < U * KQ && u0 + k < n && j < fq)
            cp_async16(es + c, ef + static_cast<long long>(s) * fq + j);
        }
        float4 xv[U];
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int nb = __shfl_sync(gmask, my_nb, u0 + k, lpr);
          xv[k] = u0 + k < n && ok
                      ? __ldg(reinterpret_cast<const float4*>(u + nb * f) +
                              vc)
                      : zero_vec<float4>();
        }
        cp_async_wait_all();
        __syncwarp(gmask);
        float d[U];  // this lane's partials, slot k
#pragma unroll
        for (int k = 0; k < U; ++k) {
          float fv[4] = {0.f, 0.f, 0.f, 0.f};  // fe of the lane's columns
#pragma unroll
          for (int j = 0; j < KQ; ++j) {
            if (j >= fq) break;  // uniform
            const float4 e = es[k * KQ + j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              fv[i] = fmaf(e.x, wfr[i][4 * j], fv[i]);
              fv[i] = fmaf(e.y, wfr[i][4 * j + 1], fv[i]);
              fv[i] = fmaf(e.z, wfr[i][4 * j + 2], fv[i]);
              fv[i] = fmaf(e.w, wfr[i][4 * j + 3], fv[i]);
            }
          }
          d[k] = u0 + k < n ? vattn_dot(av, add_vec(vb, xv[k]),
                                        make_float4(fv[0], fv[1], fv[2],
                                                    fv[3]),
                                        slope)
                            : 0.f;
        }
        __syncwarp(gmask);  // the group's reads before the next copies
        int o = lph >> 1;
#pragma unroll
        for (int half = U / 2; half >= 1; half /= 2) {
          if (o == 0) break;
          const bool up = (fl & o) != 0;
#pragma unroll
          for (int i = 0; i < half; ++i) {
            const float send = up ? d[i] : d[i + half];
            const float keep = up ? d[i + half] : d[i];
            d[i] = keep + __shfl_xor_sync(gmask, send, o, lpr);
          }
          o >>= 1;
        }
        for (; o > 0; o >>= 1) {
          d[0] += __shfl_xor_sync(gmask, d[0], o, lpr);
        }
#pragma unroll
        for (int i = 0; i < U; ++i) {
          if (i >= m) break;  // uniform in the group
          const int k = u0 + bu + i;
          const int at = __shfl_sync(gmask, my_at, k, lpr);
          if (writer && k < n && hl < heads) __stcs(out + at + hl, d[i]);
        }
      }
    }
  }
}

// out (B, heads, cap) from the walk's scratch, a thread a slot s = b * cap
// + c, its heads VEC at a time (VEC = 4 where H is a multiple of 4: the
// scratch in 16-byte vectors): out[b, h, c] = the sum over the parts p, in
// order, of sm[p * part_stride + entry[s] * heads + h] (entry: the view's
// slot -> entry map), 0 where entry is -1 (a padded slot).  kExp (K9's
// scores): exp(clip(sum, +-40)) at a listed slot instead, still 0 at a
// padded one.
template <int VEC, bool kExp>
__global__ void __launch_bounds__(256)
slot_finish_kernel(const float* __restrict__ sm,
                   const int* __restrict__ entry, long long slots,
                   int heads, int parts, long long part_stride, int cap,
                   float* __restrict__ out) {
  using V = typename Vec<VEC>::T;
  for (long long s = blockIdx.x * 256LL + threadIdx.x; s < slots;
       s += static_cast<long long>(gridDim.x) * 256) {
    const long long b = s / cap;
    float* o = out + b * heads * cap + (s - b * cap);
    const int k = entry[s];
    const float* p = sm + static_cast<long long>(k) * heads;
    for (int h0 = 0; h0 < heads; h0 += VEC) {
      float v[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
      if (k >= 0) {
        V t = *reinterpret_cast<const V*>(p + h0);
        const float* tv = reinterpret_cast<const float*>(&t);
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = tv[i];
        for (int j = 1; j < parts; ++j) {
          t = *reinterpret_cast<const V*>(p + j * part_stride + h0);
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[i] += tv[i];
        }
        if constexpr (kExp) {
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            v[i] = expf(fminf(fmaxf(v[i], -kClip), kClip));
        }
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[(h0 + i) * cap] = v[i];
    }
  }
}

// acc + the dot of two 4-float vectors, one fma at a time
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// d(ef)'s 4 values from column f0 of a slot's row o, fe columns wide: one
// 16-byte store where fe is a multiple of 4, else those below fe
__device__ __forceinline__ void store_def(float* o, int f0, float4 a,
                                          int fe) {
  if (fe % 4 == 0) {
    *reinterpret_cast<float4*>(o + f0) = a;
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (f0 + i < fe) o[f0 + i] = elem(a, i);
  }
}

// K10 v2's terms in the ds pass: the edge dot (kDot: ef (slots, efq) and
// Zp (num_dst, H, efq) in 16-byte vectors zero past Fe) and d(ef) (kDef:
// p (B, H, C) through its strides, Zp, M^T (H, efq) as Zp, d(ef) (slots,
// fe))
struct DefArgs {
  const float* p;
  long long p_bs, p_hs, p_cs;
  const float4* zp;
  const float4* mt;
  int efq, fe;
  float* d_ef;
  const float4* ef;
};
// d(ef)'s vectors a thread sums at once; with kDot, the most edge-feature
// vectors a thread keeps in registers (KQ: 4 or 8, Fe <= 16 or 32), so
// that the dot and d(ef) share one read of Zp[dst]
constexpr int kDefVecs = 8;

// K6's ds from the walk's scratch, a thread a slot s = b * cap + c, its
// heads VEC at a time (VEC = 4 where H is a multiple of 4: the scratch,
// rp and a slot-major out in 16-byte vectors): ds[b, h, c] = ((the sum
// over the parts, in order, of the scratch at entry[s]) - rp[dst(s), h])
// * g[b, h, c] * scale, dst(s) = dst_tile[b] * tile + dst_local[s]; 0
// where entry is -1 (a padded slot: neither rp nor g is read).  Written
// at out[(b * H + h) * cap + c], or at out[s * H + h] (kSlotMajor).
// K10 v2's terms, a head at a time (VEC 1): with kDot the edge dot
// ef[s] . Zp[dst, h] joins the parts' sum before rp is subtracted (ef's
// row read in slot order, coalesced; Zp[dst] a row of the bucket's dst
// tile); with kDef the thread also writes the slot's d(ef)[s, f] = sum
// over h of p[s, h] Zp[dst, h, f] + ds[s, h] M[f, h], its Fe values in
// vectors of 4, 0 at a padded slot: where Fe <= 4 KQ in the same loop as
// the dot (ef and the sums in registers, Zp[dst, h] read once), else up
// to kDefVecs vectors at once after the heads (ds read back from this
// thread's stores).
template <int VEC, bool kSlotMajor, bool kDef = false, bool kDot = false,
          int KQ = kDefVecs>
__global__ void __launch_bounds__(256)
ds_finish_kernel(const float* __restrict__ sm,
                 const int* __restrict__ entry,
                 const int* __restrict__ dst_local,
                 const int* __restrict__ dst_tile, int tile,
                 long long slots, int heads, int parts,
                 long long part_stride, int cap,
                 const float* __restrict__ rp, const float* __restrict__ g,
                 float scale, float* __restrict__ out, const DefArgs def) {
  using V = typename Vec<VEC>::T;
  for (long long s = blockIdx.x * 256LL + threadIdx.x; s < slots;
       s += static_cast<long long>(gridDim.x) * 256) {
    const long long b = s / cap;
    const long long at = b * heads * cap + (s - b * cap);  // (b, 0, c)
    const int k = entry[s];
    const long long dst =
        k >= 0 ? static_cast<long long>(dst_tile[b]) * tile + dst_local[s]
               : 0;
    const float* p = sm + static_cast<long long>(k) * heads;
    const long long c = s - b * cap;
    // kDot and Fe <= 32: d(ef) summed beside the dot (uniform in the grid)
    const bool fused = kDot && def.efq <= KQ;
    if constexpr (kDot) {
      float4 er[KQ], acc[KQ];
#pragma unroll
      for (int j = 0; j < KQ; ++j) {
        er[j] = k >= 0 && fused && j < def.efq
                    ? __ldg(def.ef + s * def.efq + j)
                    : zero_vec<float4>();
        acc[j] = zero_vec<float4>();
      }
      for (int h = 0; h < heads; ++h) {
        float v = 0.f;
        if (k >= 0) {
          v = p[h];
          for (int j = 1; j < parts; ++j) v += p[j * part_stride + h];
          const float4* zr = def.zp + (dst * heads + h) * def.efq;
          float4 zv[KQ];
          float e = 0.f;
          if (fused) {
#pragma unroll
            for (int j = 0; j < KQ; ++j) {
              if (j >= def.efq) break;
              zv[j] = __ldg(zr + j);
              e = dot4(er[j], zv[j], e);
            }
          } else {
            for (int j = 0; j < def.efq; ++j)
              e = dot4(__ldg(def.ef + s * def.efq + j), __ldg(zr + j), e);
          }
          v = (v + e - __ldg(rp + dst * heads + h)) *
              __ldg(g + at + h * static_cast<long long>(cap));
          v *= scale;
          if (kDef && fused) {
            const float pv =
                __ldg(def.p + b * def.p_bs + h * def.p_hs + c * def.p_cs);
            const float4* mr = def.mt + h * def.efq;
#pragma unroll
            for (int j = 0; j < KQ; ++j) {
              if (j >= def.efq) break;
              fma_into(reinterpret_cast<float*>(acc + j), pv, zv[j]);
              fma_into(reinterpret_cast<float*>(acc + j), v, __ldg(mr + j));
            }
          }
        }
        if constexpr (kSlotMajor) {
          out[s * heads + h] = v;
        } else {
          out[at + h * static_cast<long long>(cap)] = v;
        }
      }
      if (kDef && fused) {
        float* o = def.d_ef + s * def.fe;
#pragma unroll
        for (int j = 0; j < KQ; ++j) {
          if (j >= def.efq) break;
          store_def(o, 4 * j, acc[j], def.fe);
        }
      }
    }
    for (int h0 = 0; !kDot && h0 < heads; h0 += VEC) {
      float v[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
      if (k >= 0) {
        V t = *reinterpret_cast<const V*>(p + h0);
        const float* tv = reinterpret_cast<const float*>(&t);
#pragma unroll
        for (int i = 0; i < VEC; ++i) v[i] = tv[i];
        for (int j = 1; j < parts; ++j) {
          t = *reinterpret_cast<const V*>(p + j * part_stride + h0);
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[i] += tv[i];
        }
        const V r = __ldg(reinterpret_cast<const V*>(rp + dst * heads + h0));
        const float* rv = reinterpret_cast<const float*>(&r);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          v[i] = (v[i] - rv[i]) *
                 __ldg(g + at + (h0 + i) * static_cast<long long>(cap));
          v[i] *= scale;
        }
      }
      if constexpr (kSlotMajor) {
        store_vec(out + s * heads + h0, v, Vec<VEC>());
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          out[at + (h0 + i) * static_cast<long long>(cap)] = v[i];
      }
    }
    if (kDef && !fused) {
      float* o = def.d_ef + s * def.fe;
      for (int j0 = 0; j0 < def.efq; j0 += kDefVecs) {
        float4 acc[kDefVecs];
#pragma unroll
        for (int j = 0; j < kDefVecs; ++j) acc[j] = zero_vec<float4>();
        for (int h = 0; k >= 0 && h < heads; ++h) {
          const float pv =
              __ldg(def.p + b * def.p_bs + h * def.p_hs + c * def.p_cs);
          const float dv =
              kSlotMajor ? out[s * heads + h]
                         : out[at + h * static_cast<long long>(cap)];
          const float4* zr = def.zp + (dst * heads + h) * def.efq + j0;
          const float4* mr = def.mt + h * def.efq + j0;
#pragma unroll
          for (int j = 0; j < kDefVecs; ++j) {
            if (j0 + j >= def.efq) break;
            fma_into(reinterpret_cast<float*>(acc + j), pv, __ldg(zr + j));
            fma_into(reinterpret_cast<float*>(acc + j), dv, __ldg(mr + j));
          }
        }
#pragma unroll
        for (int j = 0; j < kDefVecs; ++j) {
          if (j0 + j >= def.efq) break;
          store_def(o, 4 * (j0 + j), acc[j], def.fe);
        }
      }
    }
  }
}

template <int CPL, bool kVattn, bool kStore = false, typename T = float>
cudaError_t launch_row_sddmm(const int* ptr, const int* nbr, const int* order,
                             int rows, const float* x, const float* z, int f,
                             int hstride, int heads, int hv, int lph, int cph,
                             int lpr, float* out, int ostride, int* counter,
                             const float* attn, float slope,
                             cudaStream_t stream,
                             const DsTerm& term = DsTerm{}) {
  unsigned blocks = 0;
  const cudaError_t err = persistent_blocks(
      row_sddmm_kernel<CPL, kVattn, kStore, T>, kWarps * 32,
      ((static_cast<long long>(rows) * lpr + 31) / 32 + kWarps - 1) / kWarps,
      &blocks);
  if (err != cudaSuccess) return err;
  row_sddmm_kernel<CPL, kVattn, kStore, T><<<blocks, kWarps * 32, 0, stream>>>(
      ptr, nbr, order, rows, x, z, f, hstride, heads, hv, lph, cph, lpr, out,
      ostride, counter, attn, slope, term);
  return cudaGetLastError();
}

// dgl_row_sddmm and dgl_row_vattn (attn not null: kVattn)
cudaError_t row_sddmm_launch(const void* ptr, const void* nbr,
                             const void* order, int64_t rows, const void* x,
                             const void* z, int64_t f, int64_t hstride,
                             int64_t heads, int64_t hv, int64_t lph,
                             int64_t cph, int64_t lpr, void* out,
                             int64_t ostride, void* counter, int64_t cpl,
                             const void* attn, float slope, int64_t device,
                             void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) != 0 || lph < 1 ||
      lpr % lph != 0 || (lph & (lph - 1)) != 0 || cph < 1 ||
      (cph & (cph - 1)) != 0 || hv < 1 ||
      hv > hstride || heads < 1 || (heads - 1) * hstride * 4 + hv * 4 > f ||
      ostride < heads || cpl < cph * ((heads + lpr / lph - 1) / (lpr / lph)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DGL_ROW_SDDMM_CASE(C_)                                              \
  case C_:                                                                  \
    return attn == nullptr                                                  \
               ? launch_row_sddmm<C_, false>(DGL_ROW_SDDMM_ARGS)             \
               : launch_row_sddmm<C_, true>(DGL_ROW_SDDMM_ARGS);
#define DGL_ROW_SDDMM_ARGS                                                  \
  static_cast<const int*>(ptr), static_cast<const int*>(nbr),               \
      static_cast<const int*>(order), static_cast<int>(rows),               \
      static_cast<const float*>(x), static_cast<const float*>(z),           \
      static_cast<int>(f), static_cast<int>(hstride),                       \
      static_cast<int>(heads), static_cast<int>(hv),                        \
      static_cast<int>(lph), static_cast<int>(cph), static_cast<int>(lpr),  \
      static_cast<float*>(out), static_cast<int>(ostride),                  \
      static_cast<int*>(counter),                                           \
      static_cast<const float*>(attn), slope, s
  switch (cpl) {
    DGL_ROW_SDDMM_CASE(1)
    DGL_ROW_SDDMM_CASE(2)
    DGL_ROW_SDDMM_CASE(4)
    DGL_ROW_SDDMM_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef DGL_ROW_SDDMM_ARGS
#undef DGL_ROW_SDDMM_CASE
}

template <int VEC, bool kExp>
cudaError_t launch_slot_finish(const void* sm, const void* entry,
                               int64_t slots, int64_t heads, int64_t parts,
                               int64_t part_stride, int64_t cap, void* out,
                               int64_t blocks, cudaStream_t stream) {
  slot_finish_kernel<VEC, kExp><<<static_cast<unsigned>(blocks), 256, 0,
                                  stream>>>(
      static_cast<const float*>(sm), static_cast<const int*>(entry), slots,
      static_cast<int>(heads), static_cast<int>(parts), part_stride,
      static_cast<int>(cap), static_cast<float*>(out));
  return cudaGetLastError();
}

// The row walk's operands beside the view; own and attn only for K9's node
// gradient, da only for its dst side with da folded in
struct RowAggArgs {
  const int *ptr, *slot, *nbr, *order;
  int rows;
  const float* w;
  int cap, w_bs, w_hs, w_cs, heads, head_cols;
  const float* y;
  int f, lpr, n_chunks;
  float* out;
  int* counter;
  const float *own, *attn;
  float slope;
  float* da;
};

template <int VEC, int CPL, bool kGrad, bool kDa, bool kOnes>
cudaError_t launch_row_agg(const RowAggArgs& a, cudaStream_t stream) {
  unsigned blocks = 0;
  const cudaError_t err = persistent_blocks(
      row_agg_kernel<VEC, CPL, kGrad, kDa, kOnes>, kWarps * 32,
      ((static_cast<long long>(a.rows) * a.n_chunks * a.lpr + 31) / 32 +
       kWarps - 1) / kWarps,
      &blocks);
  if (err != cudaSuccess) return err;
  row_agg_kernel<VEC, CPL, kGrad, kDa, kOnes>
      <<<blocks, kWarps * 32, 0, stream>>>(
      a.ptr, a.slot, a.nbr, a.order, a.rows, a.w, a.cap, a.w_bs, a.w_hs,
      a.w_cs, a.heads, a.head_cols, a.y, a.f, a.lpr, a.n_chunks, a.out,
      a.counter, a.own, a.attn, a.slope, a.da);
  return cudaGetLastError();
}

// the fold (kDa) keeps at most 4 vectors a lane, so that its da sums
// beside dv's spill nothing
template <int VEC, bool kGrad, bool kDa, bool kOnes>
cudaError_t row_agg_by_cpl(int64_t cpl, const RowAggArgs& a,
                           cudaStream_t s) {
#define DGL_ROW_AGG_CASE(C_) \
  case C_:                   \
    return launch_row_agg<VEC, C_, kGrad, kDa, kOnes>(a, s);
  switch (cpl) {
    DGL_ROW_AGG_CASE(1)
    DGL_ROW_AGG_CASE(2)
    DGL_ROW_AGG_CASE(4)
    case 8:
      if constexpr (!kDa) {
        return launch_row_agg<VEC, 8, kGrad, false, kOnes>(a, s);
      }
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
#undef DGL_ROW_AGG_CASE
}

// w null: every weight 1 (kOnes), the plain sum; not with own (kGrad)
template <int VEC>
cudaError_t row_agg_by_mode(int64_t cpl, const RowAggArgs& a,
                            cudaStream_t s) {
  if (a.w == nullptr) {
    if (a.own != nullptr) return cudaErrorInvalidValue;
    return row_agg_by_cpl<VEC, false, false, true>(cpl, a, s);
  }
  if (a.da != nullptr) {
    return row_agg_by_cpl<VEC, true, true, false>(cpl, a, s);
  }
  if (a.own != nullptr) {
    return row_agg_by_cpl<VEC, true, false, false>(cpl, a, s);
  }
  return row_agg_by_cpl<VEC, false, false, false>(cpl, a, s);
}

// dgl_row_agg and dgl_row_node_grad (own and attn not null: kGrad; da not
// null as well: kDa).
cudaError_t row_walk_launch(const void* ptr, const void* slot,
                            const void* nbr, const void* order, int64_t rows,
                            const void* w, int64_t cap, int64_t w_bs,
                            int64_t w_hs, int64_t w_cs, int64_t heads,
                            int64_t head_cols, const void* y, int64_t f,
                            void* out, void* counter, int64_t vec,
                            int64_t cpl, int64_t lpr, int64_t n_chunks,
                            const void* own, const void* attn, float slope,
                            void* da, int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) != 0 ||
      head_cols % vec != 0 || cap < 1 ||
      (da != nullptr && n_chunks > 1 && lpr != 32))
    return cudaErrorInvalidValue;
  const RowAggArgs a{static_cast<const int*>(ptr),
                     static_cast<const int*>(slot),
                     static_cast<const int*>(nbr),
                     static_cast<const int*>(order),
                     static_cast<int>(rows),
                     static_cast<const float*>(w),
                     static_cast<int>(cap),
                     static_cast<int>(w_bs),
                     static_cast<int>(w_hs),
                     static_cast<int>(w_cs),
                     static_cast<int>(heads),
                     static_cast<int>(head_cols),
                     static_cast<const float*>(y),
                     static_cast<int>(f),
                     static_cast<int>(lpr),
                     static_cast<int>(n_chunks),
                     static_cast<float*>(out),
                     static_cast<int*>(counter),
                     static_cast<const float*>(own),
                     static_cast<const float*>(attn),
                     slope,
                     static_cast<float*>(da)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 1:
      return row_agg_by_mode<1>(cpl, a, s);
    case 2:
      return row_agg_by_mode<2>(cpl, a, s);
    case 4:
      return row_agg_by_mode<4>(cpl, a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int VEC, int CPL, bool kDa>
cudaError_t node_grad_attrs(int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr,
                            row_agg_kernel<VEC, CPL, true, kDa, false>);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

template <int VEC, bool kSlotMajor, bool kDef, bool kDot, int KQ = kDefVecs>
cudaError_t launch_ds_finish(const void* sm, const void* entry,
                             const void* dst_local, const void* dst_tile,
                             int64_t tile, int64_t slots, int64_t heads,
                             int64_t parts, int64_t part_stride, int64_t cap,
                             const void* rp, const void* g, float scale,
                             void* out, int64_t blocks, cudaStream_t stream,
                             const DefArgs& def) {
  ds_finish_kernel<VEC, kSlotMajor, kDef, kDot, KQ>
      <<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      static_cast<const float*>(sm), static_cast<const int*>(entry),
      static_cast<const int*>(dst_local), static_cast<const int*>(dst_tile),
      static_cast<int>(tile), slots, static_cast<int>(heads),
      static_cast<int>(parts), part_stride, static_cast<int>(cap),
      static_cast<const float*>(rp), static_cast<const float*>(g), scale,
      static_cast<float*>(out), def);
  return cudaGetLastError();
}

// dgl_ds_finish's launch, with K10 v2's edge term where def.ef is not
// null (and its d(ef) where def.d_ef is not)
cudaError_t ds_finish_launch(const void* sm, const void* entry,
                             const void* dst_local, const void* dst_tile,
                             int64_t tile, int64_t slots, int64_t heads,
                             int64_t parts, int64_t part_stride, int64_t cap,
                             const void* rp, const void* g, double scale,
                             void* out, int64_t slot_major, int64_t vec,
                             int64_t blocks, const DefArgs& def,
                             int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (cap < 1 || heads < 1 || parts < 1 || blocks < 1 || !sm || !entry ||
      (vec != 1 && vec != 4) || heads % vec != 0 || part_stride % vec != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DGL_DS_FINISH(V_, SM_, DEF_, DOT_, KQ_)                            \
  return launch_ds_finish<V_, SM_, DEF_, DOT_, KQ_>(                       \
      sm, entry, dst_local, dst_tile, tile, slots, heads, parts,           \
      part_stride, cap, rp, g, static_cast<float>(scale), out, blocks, s,  \
      def);
#define DGL_DS_EDGE(SM_, DEF_)                                             \
  {                                                                        \
    if (def.efq <= 4) DGL_DS_FINISH(1, SM_, DEF_, true, 4)                 \
    DGL_DS_FINISH(1, SM_, DEF_, true, kDefVecs)                            \
  }
  if (def.ef != nullptr) {  // K10 v2: a head at a time
    if (def.d_ef != nullptr) {
      if (slot_major) DGL_DS_EDGE(true, true)
      DGL_DS_EDGE(false, true)
    }
    if (slot_major) DGL_DS_EDGE(true, false)
    DGL_DS_EDGE(false, false)
  }
  if (vec == 4) {
    if (slot_major) DGL_DS_FINISH(4, true, false, false, kDefVecs)
    DGL_DS_FINISH(4, false, false, false, kDefVecs)
  }
  if (slot_major) DGL_DS_FINISH(1, true, false, false, kDefVecs)
  DGL_DS_FINISH(1, false, false, false, kDefVecs)
#undef DGL_DS_EDGE
#undef DGL_DS_FINISH
}

template <int VEC, int CPL>
cudaError_t launch_row_reduce(const int* ptr, const int* slot,
                              const int* order, int rows, const float* vals,
                              int cap, int v_bs, int v_hs, int v_cs,
                              int heads, int lps, int lpr, int n_chunks,
                              float* out, int* counter, cudaStream_t stream) {
  unsigned blocks = 0;
  const cudaError_t err = persistent_blocks(
      row_reduce_kernel<VEC, CPL>, kWarps * 32,
      ((static_cast<long long>(rows) * n_chunks * lpr + 31) / 32 + kWarps -
       1) / kWarps,
      &blocks, kReduceBlocksPerSm);
  if (err != cudaSuccess) return err;
  row_reduce_kernel<VEC, CPL><<<blocks, kWarps * 32, 0, stream>>>(
      ptr, slot, order, rows, vals, cap, v_bs, v_hs, v_cs, heads, lps, lpr,
      n_chunks, out, counter);
  return cudaGetLastError();
}

template <int VEC, int CPL>
cudaError_t row_reduce_attrs(int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, row_reduce_kernel<VEC, CPL>);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

// K11 v2's node-gradient walk: one argument list for every instance
typedef void (*FeGrad)(const int*, const int*, const int*, const int*, int,
                       const float*, int, int, int, int, int, const float*,
                       int, int, int, float*, int*, const float*,
                       const float*, float, const float4*, int, const float*,
                       int, const float*);

// the instance for (vec, cpl, kf): at most 4 columns a lane; null where
// there is none
template <int KF>
FeGrad fe_grad_kf(int64_t vec, int64_t cpl) {
  if (vec == 4 && cpl == 1) return &row_fe_grad_kernel<4, 1, KF>;
  if (vec == 2 && cpl == 1) return &row_fe_grad_kernel<2, 1, KF>;
  if (vec == 2 && cpl == 2) return &row_fe_grad_kernel<2, 2, KF>;
  if (vec == 1 && cpl == 1) return &row_fe_grad_kernel<1, 1, KF>;
  if (vec == 1 && cpl == 2) return &row_fe_grad_kernel<1, 2, KF>;
  if (vec == 1 && cpl == 4) return &row_fe_grad_kernel<1, 4, KF>;
  return nullptr;
}
FeGrad fe_grad_instance(int64_t vec, int64_t cpl, int64_t kf) {
  switch (kf) {
    case 8:
      return fe_grad_kf<8>(vec, cpl);
    case 16:
      return fe_grad_kf<16>(vec, cpl);
    case 32:
      return fe_grad_kf<32>(vec, cpl);
    default:
      return nullptr;
  }
}

// K10 v1's ds walk (kStore) and K11 v1's scores (kVattn with kStore), one
// launch of the wrapper's plan
template <typename T, bool kVattn>
cudaError_t row_sddmm_store_by_cpl(int64_t cpl, const int* ptr, const int* nbr,
                                  const int* order, int rows, const float* x,
                                  const float* z, int f, int hstride,
                                  int heads, int hv, int lph, int cph,
                                  int lpr, float* out, int ostride,
                                  int* counter, const DsTerm& term,
                                  const float* attn, float slope,
                                  cudaStream_t stream) {
#define DGL_TERM_CASE(C_)                                                  \
  case C_:                                                                 \
    return launch_row_sddmm<C_, kVattn, true, T>(                          \
        ptr, nbr, order, rows, x, z, f, hstride, heads, hv, lph, cph, lpr, \
        out, ostride, counter, attn, slope, stream, term);
  switch (cpl) {
    DGL_TERM_CASE(1)
    DGL_TERM_CASE(2)
    DGL_TERM_CASE(4)
    DGL_TERM_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef DGL_TERM_CASE
}

// the instance of the walk with a stored row at (cpl, dtype, kVattn),
// null where there is none
template <typename T, bool kVattn>
const void* store_instance(int64_t cpl) {
  switch (cpl) {
    case 1: return reinterpret_cast<const void*>(
        &row_sddmm_kernel<1, kVattn, true, T>);
    case 2: return reinterpret_cast<const void*>(
        &row_sddmm_kernel<2, kVattn, true, T>);
    case 4: return reinterpret_cast<const void*>(
        &row_sddmm_kernel<4, kVattn, true, T>);
    case 8: return reinterpret_cast<const void*>(
        &row_sddmm_kernel<8, kVattn, true, T>);
    default: return nullptr;
  }
}

// dgl_row_sddmm_store and dgl_row_vattn_store (attn not null: kVattn)
cudaError_t row_sddmm_store_launch(
    const void* ptr, const void* nbr, const void* order, int64_t rows,
    const void* x, const void* z, int64_t f, int64_t hstride, int64_t heads,
    int64_t hv, int64_t lph, int64_t cph, int64_t lpr, void* out,
    int64_t ostride, void* counter, int64_t cpl, const void* slot,
    const void* fs, int64_t fs_dtype, int64_t fs_row, int64_t fs_head,
    int64_t fs_cols, int64_t fs_vec, const void* attn, float slope,
    int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) != 0 || lph < 1 ||
      lpr % lph != 0 || (lph & (lph - 1)) != 0 || cph < 1 ||
      (cph & (cph - 1)) != 0 || hv < 1 || hv > hstride || heads < 1 ||
      (heads - 1) * hstride * 4 + hv * 4 > f || ostride < heads ||
      cpl < cph * ((heads + lpr / lph - 1) / (lpr / lph)) || !slot || !fs ||
      (fs_dtype != 1 && fs_dtype != 2))
    return cudaErrorInvalidValue;
  const DsTerm term{static_cast<const int*>(slot), fs, fs_row,
                    static_cast<int>(fs_head), static_cast<int>(fs_cols),
                    static_cast<int>(fs_vec)};
#define DGL_STORE_ARGS                                                      \
  cpl, static_cast<const int*>(ptr), static_cast<const int*>(nbr),          \
      static_cast<const int*>(order), static_cast<int>(rows),               \
      static_cast<const float*>(x), static_cast<const float*>(z),           \
      static_cast<int>(f), static_cast<int>(hstride),                       \
      static_cast<int>(heads), static_cast<int>(hv),                        \
      static_cast<int>(lph), static_cast<int>(cph), static_cast<int>(lpr),  \
      static_cast<float*>(out), static_cast<int>(ostride),                  \
      static_cast<int*>(counter), term, static_cast<const float*>(attn),    \
      slope, static_cast<cudaStream_t>(stream)
  if (attn == nullptr) {
    if (fs_dtype == 1)
      return row_sddmm_store_by_cpl<float, false>(DGL_STORE_ARGS);
    return row_sddmm_store_by_cpl<__nv_bfloat16, false>(DGL_STORE_ARGS);
  }
  if (fs_dtype == 1)
    return row_sddmm_store_by_cpl<float, true>(DGL_STORE_ARGS);
  return row_sddmm_store_by_cpl<__nv_bfloat16, true>(DGL_STORE_ARGS);
#undef DGL_STORE_ARGS
}

// K11 v2's scores walk's instance for kf rows of wf, null where none
const void* vattn_fe_instance(int64_t kf) {
  switch (kf) {
    case 8: return reinterpret_cast<const void*>(&row_vattn_fe_kernel<8>);
    case 16: return reinterpret_cast<const void*>(&row_vattn_fe_kernel<16>);
    case 32: return reinterpret_cast<const void*>(&row_vattn_fe_kernel<32>);
    default: return nullptr;
  }
}

// registers, local-memory bytes and resident blocks an SM of a kernel
// instance of 8 warps a block with no dynamic shared memory: three ints
cudaError_t instance_attrs(const void* kernel, int64_t device, int* o) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  o[0] = attr.numRegs;
  o[1] = static_cast<int>(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(o + 2, kernel,
                                                       kWarps * 32, 0);
}

// The slot walk's operands beside the view
struct SlotArgs {
  const int *ptr, *slot, *nbr, *order;
  int rows;
  const float* w;
  int cap, w_bs, w_hs, w_cs, head_cols;
  const float* node;
  void* t;
  int t_cols, f, lpr, n_chunks;
  float* out;
  int* counter;
};

// the slot walk's instance at (VEC, CPL, kMode, T): launched with a, or
// (a null) its registers, local bytes and resident blocks an SM in attrs
template <int VEC, int CPL, int kMode, typename T>
cudaError_t row_slot_call(const SlotArgs* a, int* attrs,
                          cudaStream_t stream) {
  const auto kernel = row_slot_kernel<VEC, CPL, kMode, T>;
  if (a == nullptr) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    attrs[0] = attr.numRegs;
    attrs[1] = static_cast<int>(attr.localSizeBytes);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(attrs + 2, kernel,
                                                         kWarps * 32, 0);
  }
  unsigned blocks = 0;
  const cudaError_t err = persistent_blocks(
      kernel, kWarps * 32,
      ((static_cast<long long>(a->rows) * a->n_chunks * a->lpr + 31) / 32 +
       kWarps - 1) / kWarps,
      &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kWarps * 32, 0, stream>>>(
      a->ptr, a->slot, a->nbr, a->order, a->rows, a->w, a->cap, a->w_bs,
      a->w_hs, a->w_cs, a->head_cols, a->node, static_cast<T*>(a->t),
      a->t_cols, a->f, a->lpr, a->n_chunks, a->out, a->counter);
  return cudaGetLastError();
}

// the layouts the slot walk takes: 4 floats a load with 1 or 2 vectors a
// lane, or 1 with 1, 2 or 4 (at most 8 columns a lane)
template <int kMode, typename T>
cudaError_t row_slot_layout(int64_t vec, int64_t cpl, const SlotArgs* a,
                            int* attrs, cudaStream_t s) {
  if (vec == 4 && cpl == 1) return row_slot_call<4, 1, kMode, T>(a, attrs, s);
  if (vec == 4 && cpl == 2) return row_slot_call<4, 2, kMode, T>(a, attrs, s);
  if (vec == 1 && cpl == 1) return row_slot_call<1, 1, kMode, T>(a, attrs, s);
  if (vec == 1 && cpl == 2) return row_slot_call<1, 2, kMode, T>(a, attrs, s);
  if (vec == 1 && cpl == 4) return row_slot_call<1, 4, kMode, T>(a, attrs, s);
  return cudaErrorInvalidValue;
}

// mode 1-5 (the C API's codes) and the stored tensor's dtype (1 f32, 2
// bf16; K10 v2's edge features are f32)
cudaError_t row_slot_mode(int64_t mode, int64_t dtype, int64_t vec,
                          int64_t cpl, const SlotArgs* a, int* attrs,
                          cudaStream_t s) {
  const bool bf = dtype == 2;
  if (dtype != 1 && dtype != 2) return cudaErrorInvalidValue;
  switch (mode) {
    case kSlotFeat:
      if (bf) return cudaErrorInvalidValue;
      return row_slot_layout<kSlotFeat, float>(vec, cpl, a, attrs, s);
    case kSlotFe:
      return bf ? row_slot_layout<kSlotFe, __nv_bfloat16>(vec, cpl, a, attrs,
                                                          s)
                : row_slot_layout<kSlotFe, float>(vec, cpl, a, attrs, s);
    case kSlotDxDfe:
      return bf ? row_slot_layout<kSlotDxDfe, __nv_bfloat16>(vec, cpl, a,
                                                             attrs, s)
                : row_slot_layout<kSlotDxDfe, float>(vec, cpl, a, attrs, s);
    case 4:
    case 5:
      return bf ? row_slot_layout<kSlotVec, __nv_bfloat16>(vec, cpl, a, attrs,
                                                           s)
                : row_slot_layout<kSlotVec, float>(vec, cpl, a, attrs, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// K11 v1's slot-gradient walk's operands beside the view
struct SlotGradArgs {
  const int *ptr, *slot, *nbr, *order;
  int rows, range_rows, n_ranges;
  const float* ds;
  int cap, d_bs, d_hs, d_cs, head_cols;
  const float *u, *v, *attn;
  float slope;
  const void* fe;
  void* dfe;
  int f, lpr, n_chunks;
  float *dfnj, *part;
  int* counter;
};

// the slot-gradient walk's instance at (VEC, CPL, T): launched with a, a
// warp a range at once at most, or (a null) its registers, local bytes
// and resident blocks an SM in attrs
template <int VEC, int CPL, typename T>
cudaError_t row_slot_grad_call(const SlotGradArgs* a, int* attrs,
                               cudaStream_t stream) {
  const auto kernel = row_slot_grad_kernel<VEC, CPL, T>;
  if (a == nullptr) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    attrs[0] = attr.numRegs;
    attrs[1] = static_cast<int>(attr.localSizeBytes);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(attrs + 2, kernel,
                                                         kWarps * 32, 0);
  }
  unsigned blocks = 0;
  const cudaError_t err = persistent_blocks(
      kernel, kWarps * 32, (a->n_ranges + kWarps - 1) / kWarps, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kWarps * 32, 0, stream>>>(
      a->ptr, a->slot, a->nbr, a->order, a->rows, a->range_rows,
      a->n_ranges, a->ds, a->cap, a->d_bs, a->d_hs, a->d_cs, a->head_cols,
      a->u, a->v, a->attn, a->slope, static_cast<const T*>(a->fe),
      static_cast<T*>(a->dfe), a->f, a->lpr, a->n_chunks, a->dfnj, a->part,
      a->counter);
  return cudaGetLastError();
}

// the slot walk's layouts (row_slot_layout's) for the stored dtype (1 f32,
// 2 bf16)
template <typename T>
cudaError_t row_slot_grad_layout(int64_t vec, int64_t cpl,
                                 const SlotGradArgs* a, int* attrs,
                                 cudaStream_t s) {
  if (vec == 4 && cpl == 1) return row_slot_grad_call<4, 1, T>(a, attrs, s);
  if (vec == 4 && cpl == 2) return row_slot_grad_call<4, 2, T>(a, attrs, s);
  if (vec == 1 && cpl == 1) return row_slot_grad_call<1, 1, T>(a, attrs, s);
  if (vec == 1 && cpl == 2) return row_slot_grad_call<1, 2, T>(a, attrs, s);
  if (vec == 1 && cpl == 4) return row_slot_grad_call<1, 4, T>(a, attrs, s);
  return cudaErrorInvalidValue;
}

cudaError_t row_slot_grad_dtype(int64_t dtype, int64_t vec, int64_t cpl,
                                const SlotGradArgs* a, int* attrs,
                                cudaStream_t s) {
  if (dtype == 1) return row_slot_grad_layout<float>(vec, cpl, a, attrs, s);
  if (dtype == 2) {
    return row_slot_grad_layout<__nv_bfloat16>(vec, cpl, a, attrs, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// out (rows, f), every element written: out[r, j] = sum over slots k in
// [ptr[r], ptr[r + 1]) of w[b * w_bs + (j / head_cols) * w_hs + c * w_cs]
// * y[nbr[k], j], slot[k] = b * cap + c, summed in slot order; y
// (num_nbr, f).  vec (1, 2 or 4) floats a load,
// dividing head_cols; cpl (1, 2, 4 or 8) vectors a lane; lpr (a power of
// two up to 32) lanes a row; the f / vec column vectors in n_chunks
// chunks of lpr * cpl.  counter is one int, zeroed by the caller.  w
// null: every weight 1, and neither w nor slot is read (K3's plain sum).
int dgl_row_agg(const void* ptr, const void* slot, const void* nbr,
                const void* order, int64_t rows, const void* w, int64_t cap,
                int64_t w_bs, int64_t w_hs, int64_t w_cs, int64_t heads,
                int64_t head_cols, const void* y,
                int64_t f, void* out, void* counter, int64_t vec,
                int64_t cpl, int64_t lpr, int64_t n_chunks, int64_t device,
                void* stream) {
  return row_walk_launch(ptr, slot, nbr, order, rows, w, cap, w_bs, w_hs,
                         w_cs, heads, head_cols, y, f, out, counter, vec, cpl,
                         lpr, n_chunks, nullptr, nullptr, 0.f, nullptr,
                         device, stream);
}

// K9's node gradient by the same walk: out (rows, f), every element
// written, out[r, j] = attn[j] * sum over the slots k of row r of w[...]
// * (own[r, j] + y[nbr[k], j] >= 0 ? 1 : slope), in slot order; own
// (rows, f) and attn (f,) f32; the rest as dgl_row_agg's.  With da (f,)
// f32 not null (the walk by dst: own = V, y = U), also da[j] += the sum
// over every row's slots of w[...] * lrelu(own[r, j] + y[nbr[k], j]),
// added in L2 in no fixed order (da zeroed by the caller, 16-byte
// aligned where vec is 4); then cpl is at most 4, and lpr is 32 where
// n_chunks > 1.
int dgl_row_node_grad(const void* ptr, const void* slot, const void* nbr,
                      const void* order, int64_t rows, const void* w,
                      int64_t cap, int64_t w_bs, int64_t w_hs, int64_t w_cs,
                      int64_t heads, int64_t head_cols, const void* y,
                      int64_t f, void* out, void* counter, int64_t vec,
                      int64_t cpl, int64_t lpr, int64_t n_chunks,
                      const void* own, const void* attn, float slope,
                      void* da, int64_t device, void* stream) {
  if (own == nullptr || attn == nullptr) return cudaErrorInvalidValue;
  return row_walk_launch(ptr, slot, nbr, order, rows, w, cap, w_bs, w_hs,
                         w_cs, heads, head_cols, y, f, out, counter, vec, cpl,
                         lpr, n_chunks, own, attn, slope, da, device, stream);
}

// registers a thread and local-memory bytes (the stack frame and spills)
// a thread of the node-gradient walk's instance at vec and cpl, with da
// folded in (fold 1) or not: regs_local, two ints.
int dgl_row_node_grad_attrs(int64_t vec, int64_t cpl, int64_t fold,
                            int64_t device, void* regs_local) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  int* o = static_cast<int*>(regs_local);
#define DGL_ATTRS_CASE(V_, C_)                                      \
  if (vec == V_ && cpl == C_)                                       \
    return fold ? node_grad_attrs<V_, C_, true>(o, o + 1)           \
                : node_grad_attrs<V_, C_, false>(o, o + 1);
  DGL_ATTRS_CASE(1, 1)
  DGL_ATTRS_CASE(1, 2)
  DGL_ATTRS_CASE(1, 4)
  DGL_ATTRS_CASE(2, 1)
  DGL_ATTRS_CASE(2, 2)
  DGL_ATTRS_CASE(2, 4)
  DGL_ATTRS_CASE(4, 1)
  DGL_ATTRS_CASE(4, 2)
  DGL_ATTRS_CASE(4, 4)
#undef DGL_ATTRS_CASE
  return cudaErrorInvalidValue;
}

// K11 v2's node gradient by the same walk, the edge term formed per
// entry: out (rows, f), every element written, out[r, j] = attn[j] * the
// sum over the slots k of row r of w[...] * (raw >= 0 ? 1 : slope), raw =
// (own[r, j] + bias[j]) + y[nbr[k], j] + sum_{i < fe} ef[slot[k], i] wf[i,
// j], in slot order; ef (slots, fq * 4) f32 in slot order, 16-byte
// aligned, zero past fe; wf (fe, f) f32; bias (f,) f32 aligned as own, or
// null; kf (8, 16 or 32) at least fq * 4; lpr at least 8; vec * cpl at
// most 4; the rest as dgl_row_node_grad's without da.
int dgl_row_fe_grad(const void* ptr, const void* slot, const void* nbr,
                    const void* order, int64_t rows, const void* w,
                    int64_t cap, int64_t w_bs, int64_t w_hs, int64_t w_cs,
                    int64_t head_cols, const void* y, int64_t f, void* out,
                    void* counter, int64_t vec, int64_t cpl, int64_t lpr,
                    int64_t n_chunks, const void* own, const void* attn,
                    float slope, const void* ef, int64_t fq, const void* wf,
                    int64_t fe, const void* bias, int64_t kf,
                    int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const FeGrad kernel = fe_grad_instance(vec, cpl, kf);
  if (kernel == nullptr || lpr < kFeMinLanes || lpr > 32 ||
      (lpr & (lpr - 1)) != 0 || head_cols % vec != 0 || cap < 1 ||
      fq < 0 || fq * 4 > kf || fe > fq * 4 || n_chunks < 1 ||
      reinterpret_cast<uintptr_t>(ef) % 16 != 0)
    return cudaErrorInvalidValue;
  unsigned blocks = 0;
  err = persistent_blocks(
      kernel, kWarps * 32,
      ((rows * n_chunks * lpr + 31) / 32 + kWarps - 1) / kWarps, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ptr), static_cast<const int*>(slot),
      static_cast<const int*>(nbr), static_cast<const int*>(order),
      static_cast<int>(rows), static_cast<const float*>(w),
      static_cast<int>(cap), static_cast<int>(w_bs), static_cast<int>(w_hs),
      static_cast<int>(w_cs), static_cast<int>(head_cols),
      static_cast<const float*>(y), static_cast<int>(f),
      static_cast<int>(lpr), static_cast<int>(n_chunks),
      static_cast<float*>(out), static_cast<int*>(counter),
      static_cast<const float*>(own), static_cast<const float*>(attn), slope,
      static_cast<const float4*>(ef), static_cast<int>(fq),
      static_cast<const float*>(wf), static_cast<int>(fe),
      static_cast<const float*>(bias));
  return cudaGetLastError();
}

// registers a thread, local-memory bytes a thread and resident blocks an
// SM of the instance at (vec, cpl, kf): three ints.
int dgl_row_fe_grad_attrs(int64_t vec, int64_t cpl, int64_t kf,
                          int64_t device, void* attrs) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const FeGrad kernel = fe_grad_instance(vec, cpl, kf);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  int* o = static_cast<int*>(attrs);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  o[0] = attr.numRegs;
  o[1] = static_cast<int>(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(o + 2, kernel,
                                                       kWarps * 32, 0);
}

// K10 v1's ds by the dot-product walk, one launch of the wrapper's plan
// (dgl_row_sddmm's arguments, x = x, z = zn), the walk also reading slot
// (the view's slot of each entry): x[nbr]'s 4 columns from c of head h
// gain fs[slot * fs_row + h * fs_head + c] (fs at the launch's first head
// and column, dtype 1 f32 or 2 bf16; 0 past fs_cols columns of a head),
// read 4 at a time where fs_vec (then 16- or 8-byte aligned).
int dgl_row_sddmm_store(const void* ptr, const void* nbr, const void* order,
                        int64_t rows, const void* x, const void* z, int64_t f,
                        int64_t hstride, int64_t heads, int64_t hv,
                        int64_t lph, int64_t cph, int64_t lpr, void* out,
                        int64_t ostride, void* counter, int64_t cpl,
                        const void* slot, const void* fs, int64_t fs_dtype,
                        int64_t fs_row, int64_t fs_head, int64_t fs_cols,
                        int64_t fs_vec, int64_t device, void* stream) {
  return row_sddmm_store_launch(ptr, nbr, order, rows, x, z, f, hstride,
                                heads, hv, lph, cph, lpr, out, ostride,
                                counter, cpl, slot, fs, fs_dtype, fs_row,
                                fs_head, fs_cols, fs_vec, nullptr, 0.f,
                                device, stream);
}

// K11 v1's scores by the same walk, one launch of the wrapper's plan:
// dgl_row_vattn's sums (u, v and attn as it takes them) with the stored
// edge term added to u[nbr] before lrelu, as dgl_row_sddmm_store adds fs
// to x; the arguments are dgl_row_sddmm_store's and attn and slope.
// dgl_slot_finish with exp_clip then takes exp(clip(., +-40)).
int dgl_row_vattn_store(const void* ptr, const void* nbr, const void* order,
                        int64_t rows, const void* u, const void* v, int64_t f,
                        int64_t hstride, int64_t heads, int64_t hv,
                        int64_t lph, int64_t cph, int64_t lpr, void* out,
                        int64_t ostride, void* counter, int64_t cpl,
                        const void* slot, const void* fs, int64_t fs_dtype,
                        int64_t fs_row, int64_t fs_head, int64_t fs_cols,
                        int64_t fs_vec, const void* attn, float slope,
                        int64_t device, void* stream) {
  if (attn == nullptr) return cudaErrorInvalidValue;
  return row_sddmm_store_launch(ptr, nbr, order, rows, u, v, f, hstride,
                                heads, hv, lph, cph, lpr, out, ostride,
                                counter, cpl, slot, fs, fs_dtype, fs_row,
                                fs_head, fs_cols, fs_vec, attn, slope,
                                device, stream);
}

// registers a thread, local-memory bytes a thread and resident blocks an
// SM (three ints) of the walk's instance with a stored row at cpl (1, 2, 4
// or 8) and dtype (1 f32, 2 bf16), in its scores mode (K11 v1) where
// vattn is 1, else K10 v1's ds.
int dgl_row_sddmm_store_attrs(int64_t cpl, int64_t dtype, int64_t vattn,
                              int64_t device, void* attrs) {
  const void* kernel =
      dtype == 1 ? (vattn ? store_instance<float, true>(cpl)
                          : store_instance<float, false>(cpl))
      : dtype == 2 ? (vattn ? store_instance<__nv_bfloat16, true>(cpl)
                            : store_instance<__nv_bfloat16, false>(cpl))
                   : nullptr;
  return instance_attrs(kernel, device, static_cast<int*>(attrs));
}

// K11 v2's scores by the walk, the edge term formed per entry, one launch
// of the wrapper's plan: for every entry k of row r (slot[k] its slot),
// the sum over the launch's columns c of head h of attn[c] * lrelu((v[r,
// c] + bias[c]) + u[nbr[k], c] + sum_{i < fe} ef[slot[k], i] wf[i, c]) at
// out[k * ostride + h]; u, v, attn as dgl_row_vattn's, wf (fe rows of f
// floats) and bias (f floats, or null) at the launch's first head and
// column as u is; ef (slots, fq * 4) f32 in slot order, 16-byte aligned,
// zero past fe; kf (8, 16 or 32) at least fq * 4.  One vector a lane:
// lph (a power of two) at least hv, lpr (a power of two, 8 to 32) at
// least heads * lph.  counter is one int, zeroed by the caller.
// dgl_slot_finish with exp_clip then takes exp(clip(., +-40)).
int dgl_row_vattn_fe(const void* ptr, const void* nbr, const void* order,
                     int64_t rows, const void* u, const void* v, int64_t f,
                     int64_t hstride, int64_t heads, int64_t hv, int64_t lph,
                     int64_t lpr, void* out, int64_t ostride, void* counter,
                     const void* attn, float slope, const void* slot,
                     const void* ef, int64_t fq, const void* wf, int64_t fe,
                     const void* bias, int64_t kf, int64_t device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const void* kernel = vattn_fe_instance(kf);
  if (kernel == nullptr || lpr < kFeMinLanes || lpr > 32 ||
      (lpr & (lpr - 1)) != 0 || lph < 1 || (lph & (lph - 1)) != 0 ||
      hv < 1 || hv > lph || hv > hstride || heads < 1 || heads * lph > lpr ||
      (heads - 1) * hstride * 4 + hv * 4 > f || ostride < heads || !attn ||
      !slot || fq < 0 || fq * 4 > kf || fe < 0 || fe > fq * 4 ||
      reinterpret_cast<uintptr_t>(ef) % 16 != 0)
    return cudaErrorInvalidValue;
  unsigned blocks = 0;
  err = persistent_blocks(
      kernel, kWarps * 32,
      ((static_cast<long long>(rows) * lpr + 31) / 32 + kWarps - 1) / kWarps,
      &blocks);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DGL_VATTN_FE(KF_)                                                   \
  row_vattn_fe_kernel<KF_><<<blocks, kWarps * 32, 0, s>>>(                  \
      static_cast<const int*>(ptr), static_cast<const int*>(nbr),           \
      static_cast<const int*>(order), static_cast<int>(rows),               \
      static_cast<const float*>(u), static_cast<const float*>(v),           \
      static_cast<int>(f), static_cast<int>(hstride),                       \
      static_cast<int>(heads), static_cast<int>(hv), static_cast<int>(lph), \
      static_cast<int>(lpr), static_cast<float*>(out),                      \
      static_cast<int>(ostride), static_cast<int*>(counter),                \
      static_cast<const float*>(attn), slope,                               \
      static_cast<const int*>(slot), static_cast<const float4*>(ef),        \
      static_cast<int>(fq), static_cast<const float*>(wf),                  \
      static_cast<int>(fe), static_cast<const float*>(bias))
  if (kf == 8) {
    DGL_VATTN_FE(8);
  } else if (kf == 16) {
    DGL_VATTN_FE(16);
  } else {
    DGL_VATTN_FE(32);
  }
#undef DGL_VATTN_FE
  return cudaGetLastError();
}

// registers a thread, local-memory bytes a thread and resident blocks an
// SM (three ints) of the instance for kf rows of wf.
int dgl_row_vattn_fe_attrs(int64_t kf, int64_t device, void* attrs) {
  return instance_attrs(vattn_fe_instance(kf), device,
                        static_cast<int*>(attrs));
}

// K4's SDDMM by dst rows, one launch of the wrapper's plan: for every
// entry k of row r, <x[nbr[k], h, :hv * 4], z[r, h, :hv * 4]> at out[k *
// ostride + h], h < heads; x (num_nbr rows) and z (rows) f32, 16-byte
// aligned, rows f floats apart, heads hstride * 4 floats apart, hv <=
// hstride.  lph lanes a head (a power of two), cph vectors a lane and
// head (a power of two), lpr lanes a row (a power of two, a multiple of lph, up to 32), cpl
// (1, 2, 4 or 8) at least cph * ceil(heads / (lpr / lph)).  counter is
// one int, zeroed by the caller.
int dgl_row_sddmm(const void* ptr, const void* nbr, const void* order,
                  int64_t rows, const void* x, const void* z, int64_t f,
                  int64_t hstride, int64_t heads, int64_t hv, int64_t lph,
                  int64_t cph, int64_t lpr, void* out, int64_t ostride,
                  void* counter, int64_t cpl, int64_t device, void* stream) {
  return row_sddmm_launch(ptr, nbr, order, rows, x, z, f, hstride, heads, hv,
                          lph, cph, lpr, out, ostride, counter, cpl, nullptr,
                          0.f, device, stream);
}

// K9's scores by the same walk, one launch of the wrapper's plan: for
// every entry k of row r, sum over the launch's columns d of head h of
// attn[h, d] * lrelu(u[nbr[k], h, d] + v[r, h, d]) at out[k * ostride +
// h]: u, v and attn as dgl_row_sddmm's x and z (attn one row, at the
// launch's first head and column, 16-byte aligned), slope the leaky
// ReLU's; the rest as dgl_row_sddmm's.  dgl_slot_finish with exp_clip
// then takes exp(clip(., +-40)).
int dgl_row_vattn(const void* ptr, const void* nbr, const void* order,
                  int64_t rows, const void* u, const void* v, int64_t f,
                  int64_t hstride, int64_t heads, int64_t hv, int64_t lph,
                  int64_t cph, int64_t lpr, void* out, int64_t ostride,
                  void* counter, int64_t cpl, const void* attn, float slope,
                  int64_t device, void* stream) {
  if (attn == nullptr) return cudaErrorInvalidValue;
  return row_sddmm_launch(ptr, nbr, order, rows, u, v, f, hstride, heads, hv,
                          lph, cph, lpr, out, ostride, counter, cpl, attn,
                          slope, device, stream);
}

// out (slots / cap, heads, cap) from the walk's scratch sm (parts of
// part_stride floats, each entry-major: entry k, head h at k * heads +
// h), every element written: at slot s the sum over the parts, in order,
// at entry[s] (exp_clip 1: exp(clip(that sum, +-40)), K9's scores from
// dgl_row_vattn's scratch), and 0 where entry is -1.  vec 4 (heads and
// part_stride multiples of 4, sm 16-byte aligned) or 1.  entry (slots,)
// int32.
int dgl_slot_finish(const void* sm, const void* entry, int64_t slots,
                    int64_t heads, int64_t parts, int64_t part_stride,
                    int64_t cap, void* out, int64_t vec, int64_t exp_clip,
                    int64_t blocks, int64_t device, void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (cap < 1 || heads < 1 || parts < 1 || blocks < 1 || !sm || !entry ||
      (vec != 1 && vec != 4) || heads % vec != 0 || part_stride % vec != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DGL_SLOT_FINISH(V_, E_)                                            \
  return launch_slot_finish<V_, E_>(sm, entry, slots, heads, parts,        \
                                    part_stride, cap, out, blocks, s);
  if (vec == 4) {
    if (exp_clip) DGL_SLOT_FINISH(4, true)
    DGL_SLOT_FINISH(4, false)
  }
  if (exp_clip) DGL_SLOT_FINISH(1, true)
  DGL_SLOT_FINISH(1, false)
#undef DGL_SLOT_FINISH
}

// K6's ds from the walk's scratch sm (parts of part_stride floats, each
// entry-major as dgl_slot_finish takes it): ds (slots / cap, heads, cap),
// or its slot-major layout (slot_major 1: slot s, head h at s * heads +
// h), every element written: at slot s ((the sum over the parts, in
// order, at entry[s]) - rp[dst, h]) * g[b, h, c] * scale with dst =
// dst_tile[s / cap] * tile + dst_local[s], 0 where entry is -1.  rp
// (num_dst, heads) and g (slots / cap, heads, cap) f32.  vec 4 (heads a
// multiple of 4; sm, rp and out 16-byte aligned) or 1.  entry, dst_local
// (slots,) and dst_tile (slots / cap,) int32.
int dgl_ds_finish(const void* sm, const void* entry, const void* dst_local,
                  const void* dst_tile, int64_t tile, int64_t slots,
                  int64_t heads, int64_t parts, int64_t part_stride,
                  int64_t cap, const void* rp, const void* g, double scale,
                  void* out, int64_t slot_major, int64_t vec, int64_t blocks,
                  int64_t device, void* stream) {
  return ds_finish_launch(sm, entry, dst_local, dst_tile, tile, slots, heads,
                          parts, part_stride, cap, rp, g, scale, out,
                          slot_major, vec, blocks, DefArgs{}, device, stream);
}

// K10 v2's ds pass: dgl_ds_finish with the edge term, a head at a time:
// ds[b, h, c] = ((the sum over the parts at entry[s]) + ef[s] . zp[dst,
// h] - rp[dst, h]) * g[b, h, c] * scale, and with d_ef not null at every
// slot s d_ef[s, f] (slots, fe) f32 = the sum over h of p[s, h] zp[dst,
// h, f] + ds[s, h] mt[h, f]; both 0 where entry is -1.  ef (slots, 4 efq)
// in slot order, zp (num_dst, heads, 4 efq) and mt (heads, 4 efq) f32,
// 16-byte aligned, zero past fe; p (slots / cap, heads, cap) f32 read at
// b * p_bs + h * p_hs + c * p_cs; d_ef 16-byte aligned.  vec is 1.
int dgl_ds_finish_edge(const void* sm, const void* entry,
                      const void* dst_local, const void* dst_tile,
                      int64_t tile, int64_t slots, int64_t heads,
                      int64_t parts, int64_t part_stride, int64_t cap,
                      const void* rp, const void* g, double scale, void* out,
                      int64_t slot_major, int64_t vec, const void* p,
                      int64_t p_bs, int64_t p_hs, int64_t p_cs,
                      const void* zp, const void* mt, int64_t efq,
                      int64_t fe, void* d_ef, const void* ef,
                      int64_t blocks, int64_t device, void* stream) {
  if (!zp || !ef || efq < 1 || fe > 4 * efq || fe < 1 || vec != 1 ||
      (d_ef && (!p || !mt || reinterpret_cast<uintptr_t>(d_ef) % 16 != 0)))
    return cudaErrorInvalidValue;
  const DefArgs def{static_cast<const float*>(p), p_bs, p_hs, p_cs,
                    static_cast<const float4*>(zp),
                    static_cast<const float4*>(mt), static_cast<int>(efq),
                    static_cast<int>(fe), static_cast<float*>(d_ef),
                    static_cast<const float4*>(ef)};
  return ds_finish_launch(sm, entry, dst_local, dst_tile, tile, slots, heads,
                          parts, part_stride, cap, rp, g, scale, out,
                          slot_major, vec, blocks, def, device, stream);
}

// The slot walk over the rows of a view (K10 v1's numerator and dx with
// dfe, K11 v1's node sums, K10 v2's slot-feature reduce): out (rows, f)
// f32, every element written, out[r, j] = the sum over row r's entries k
// (slot s = slot[k] = b * cap + c, neighbour n = nbr[k]), in entry order,
// of the mode's term, with w[b * w_bs + (j / head_cols) * w_hs + c * w_cs]
// the weight of j's head and t (slots, t_cols) the stored slot tensor of
// dtype 1 (f32) or 2 (bf16), read and written at 64-bit offsets:
//   mode 1: w * t[s, j % t_cols] (K10 v2's S and Q, t = ef, f32);
//   mode 2: w * (node[n, j] + t[s, j]) (K10 v1's numerator, node = x);
//   mode 3: w * node[n, j], also written at t[s, j] (K10 v1's dx and dfe,
//     node = zn), and then t's rows at the slots whose valid is 0 (of the
//     slots slots) set to 0 by a second launch, zero_blocks blocks of 256
//     threads;
//   mode 4, 5: t[s, j] (K11 v1's dFNJ by dst and dFNI by src; w and node
//     null).
// node (num_nbr, f) f32.  vec (4: 16-byte loads; cpl 1 or 2 — or 1: cpl
// 1, 2 or 4) divides head_cols, t_cols and f; lpr (a power of two up to
// 32) lanes a row; the f / vec vectors in n_chunks chunks of lpr * cpl.
// counter is one int, zeroed by the caller.
int dgl_row_slot(const void* ptr, const void* slot, const void* nbr,
                 const void* order, int64_t rows, const void* w, int64_t cap,
                 int64_t w_bs, int64_t w_hs, int64_t w_cs, int64_t head_cols,
                 const void* node, void* t, int64_t dtype, int64_t t_cols,
                 int64_t f, void* out, void* counter, int64_t vec,
                 int64_t cpl, int64_t lpr, int64_t n_chunks, int64_t mode,
                 const void* valid, int64_t slots, int64_t zero_blocks,
                 int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const bool weighted = mode >= 1 && mode <= 3;
  const bool reads_node = mode == 2 || mode == 3;
  const int64_t es = dtype == 2 ? 2 : 4;
  if (lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) != 0 || cap < 1 ||
      n_chunks < 1 || t_cols < 1 || f < 1 || head_cols < 1 ||
      head_cols % vec != 0 || t_cols % vec != 0 || f % vec != 0 || !t ||
      (w != nullptr) != weighted || (node != nullptr) != reads_node ||
      (mode == 3 && (!valid || zero_blocks < 1)) ||
      (mode != 1 && t_cols != f) ||
      reinterpret_cast<uintptr_t>(t) % (es * vec) != 0 ||
      (node && reinterpret_cast<uintptr_t>(node) % (4 * vec) != 0))
    return cudaErrorInvalidValue;
  const SlotArgs a{static_cast<const int*>(ptr),
                   static_cast<const int*>(slot),
                   static_cast<const int*>(nbr),
                   static_cast<const int*>(order),
                   static_cast<int>(rows),
                   static_cast<const float*>(w),
                   static_cast<int>(cap),
                   static_cast<int>(w_bs),
                   static_cast<int>(w_hs),
                   static_cast<int>(w_cs),
                   static_cast<int>(head_cols),
                   static_cast<const float*>(node),
                   t,
                   static_cast<int>(t_cols),
                   static_cast<int>(f),
                   static_cast<int>(lpr),
                   static_cast<int>(n_chunks),
                   static_cast<float*>(out),
                   static_cast<int*>(counter)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = row_slot_mode(mode, dtype, vec, cpl, &a, nullptr, s);
  if (err != cudaSuccess || mode != 3) return err;
  const unsigned blocks = static_cast<unsigned>(zero_blocks);
  if (dtype == 2) {
    slot_zero_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(valid), slots,
        static_cast<__nv_bfloat16*>(t), static_cast<int>(f));
  } else {
    slot_zero_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(valid), slots, static_cast<float*>(t),
        static_cast<int>(f));
  }
  return cudaGetLastError();
}

// registers a thread, local-memory bytes a thread and resident blocks an
// SM of the slot walk's instance at (mode, dtype, vec, cpl): three ints.
int dgl_row_slot_attrs(int64_t mode, int64_t dtype, int64_t vec, int64_t cpl,
                       int64_t device, void* attrs) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  return row_slot_mode(mode, dtype, vec, cpl, nullptr,
                       static_cast<int*>(attrs), nullptr);
}

// K11 v1's slot gradient by the slot walk by dst, four launches on the
// stream: the walk, the zero pass and the two range sums.  Writes dfe
// (slots, f) of the stored dtype (1 f32, 2 bf16), every row (0 at the
// padded slots, whose valid is 0), dfnj (rows, f) f32, every element (0 on
// a row with no entry), and da (f,) f32: with raw = (u[n, j] + v[r, j]) +
// fe[s, j] for each entry (slot s = b * cap + c, neighbour n) of dst row
// r, dfe[s, j] = ds[b * d_bs + (j / head_cols) * d_hs + c * d_cs] *
// attn[j] * (raw >= 0 ? 1 : slope), dfnj[r] = the sum of its entries' dfe
// rows as stored, in entry order, and da[j] = the sum of ds * lrelu(raw)
// over every entry, taken per range of range_rows rows of the claim
// order (n_ranges of them, partials in part (n_ranges, f)), then in segs
// segments of the ranges (part2 (segs, f)), then over the segments.  u
// (num_src, f), v (rows, f), attn (f,) f32, fe (slots, f); vec 4 or 1
// floats a load (dividing head_cols; u, v, attn, fe, dfe, dfnj and part
// aligned to it), cpl vectors a lane, lpr lanes a row, the f / vec
// vectors in n_chunks chunks of lpr * cpl (n_chunks 1 unless lpr is 32).
// counter is one int, zeroed by the caller.
int dgl_row_slot_grad(const void* ptr, const void* slot, const void* nbr,
                      const void* order, int64_t rows, int64_t range_rows,
                      int64_t n_ranges, const void* ds, int64_t cap,
                      int64_t d_bs, int64_t d_hs, int64_t d_cs,
                      int64_t head_cols, const void* u, const void* v,
                      const void* attn, float slope, const void* fe,
                      void* dfe, int64_t dtype, int64_t f, void* dfnj,
                      void* part, int64_t segs, void* part2, void* da,
                      void* counter, int64_t vec, int64_t cpl, int64_t lpr,
                      int64_t n_chunks, const void* valid, int64_t slots,
                      int64_t zero_blocks, int64_t device, void* stream) {
  cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  const int64_t es = dtype == 2 ? 2 : 4;
  const int64_t al = 4 * vec;
  auto aligned = [al](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % al == 0;
  };
  if (lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) != 0 || cap < 1 ||
      n_chunks < 1 || (n_chunks > 1 && lpr != 32) || f < 1 ||
      head_cols < 1 || head_cols % vec != 0 || f % vec != 0 ||
      range_rows < 1 || n_ranges < 1 || segs < 1 || zero_blocks < 1 ||
      n_ranges != (rows + range_rows - 1) / range_rows || !fe || !dfe ||
      !dfnj || !part || !part2 || !da || !valid ||
      reinterpret_cast<uintptr_t>(fe) % (es * vec) != 0 ||
      reinterpret_cast<uintptr_t>(dfe) % (es * vec) != 0 || !aligned(u) ||
      !aligned(v) || !aligned(attn) || !aligned(dfnj) || !aligned(part))
    return cudaErrorInvalidValue;
  const SlotGradArgs a{static_cast<const int*>(ptr),
                       static_cast<const int*>(slot),
                       static_cast<const int*>(nbr),
                       static_cast<const int*>(order),
                       static_cast<int>(rows),
                       static_cast<int>(range_rows),
                       static_cast<int>(n_ranges),
                       static_cast<const float*>(ds),
                       static_cast<int>(cap),
                       static_cast<int>(d_bs),
                       static_cast<int>(d_hs),
                       static_cast<int>(d_cs),
                       static_cast<int>(head_cols),
                       static_cast<const float*>(u),
                       static_cast<const float*>(v),
                       static_cast<const float*>(attn),
                       slope,
                       fe,
                       dfe,
                       static_cast<int>(f),
                       static_cast<int>(lpr),
                       static_cast<int>(n_chunks),
                       static_cast<float*>(dfnj),
                       static_cast<float*>(part),
                       static_cast<int*>(counter)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = row_slot_grad_dtype(dtype, vec, cpl, &a, nullptr, s);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(zero_blocks);
  if (dtype == 2) {
    slot_zero_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(valid), slots,
        static_cast<__nv_bfloat16*>(dfe), static_cast<int>(f));
  } else {
    slot_zero_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(valid), slots, static_cast<float*>(dfe),
        static_cast<int>(f));
  }
  const unsigned cols = static_cast<unsigned>((f + 31) / 32);
  const int seg = static_cast<int>((n_ranges + segs - 1) / segs);
  range_sum_kernel<<<dim3(cols, static_cast<unsigned>(segs)),
                     32 * kRangeSubs, 0, s>>>(
      static_cast<const float*>(part), static_cast<int>(n_ranges),
      static_cast<int>(f), seg, static_cast<float*>(part2));
  range_sum_kernel<<<dim3(cols, 1), 32 * kRangeSubs, 0, s>>>(
      static_cast<const float*>(part2), static_cast<int>(segs),
      static_cast<int>(f), static_cast<int>(segs), static_cast<float*>(da));
  return cudaGetLastError();
}

// registers a thread, local-memory bytes a thread and resident blocks an
// SM of the slot-gradient walk's instance at (dtype, vec, cpl): three
// ints.
int dgl_row_slot_grad_attrs(int64_t dtype, int64_t vec, int64_t cpl,
                            int64_t device, void* attrs) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  return row_slot_grad_dtype(dtype, vec, cpl, nullptr,
                             static_cast<int*>(attrs), nullptr);
}

// K6's slot reduce by rows: out (rows, heads), every element written,
// out[r, h] = the sum over the entries k in [ptr[r], ptr[r + 1]) of
// vals[b * v_bs + h * v_hs + c * v_cs], slot[k] = b * cap + c, in entry
// order (a lane's share) and then a fixed butterfly; order (rows,) the
// claim order.  vec 4 (heads a multiple of 4, v_hs 1, v_bs and v_cs
// multiples of 4, vals and out 16-byte aligned) or 1 floats a load; cpl
// (1, 2, 4 or 8) vectors a lane; lps (a power of two) lanes a slot, lpr
// (a power of two up to 32, a multiple of lps) lanes a row; the heads /
// vec vectors in n_chunks chunks of lps * cpl.  counter is one int,
// zeroed by the caller.
int dgl_row_reduce(const void* ptr, const void* slot, const void* order,
                   int64_t rows, const void* vals, int64_t cap, int64_t v_bs,
                   int64_t v_hs, int64_t v_cs, int64_t heads, void* out,
                   void* counter, int64_t vec, int64_t cpl, int64_t lps,
                   int64_t lpr, int64_t n_chunks, int64_t device,
                   void* stream) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  if (lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) != 0 || lps < 1 ||
      (lps & (lps - 1)) != 0 || lpr % lps != 0 || cap < 1 || heads < 1 ||
      n_chunks < 1 || (vec != 1 && vec != 4) || heads % vec != 0 ||
      (vec == 4 && (v_hs != 1 || v_bs % 4 != 0 || v_cs % 4 != 0)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DGL_ROW_REDUCE(V_, C_)                                               \
  if (vec == V_ && cpl == C_)                                                \
    return launch_row_reduce<V_, C_>(                                        \
        static_cast<const int*>(ptr), static_cast<const int*>(slot),         \
        static_cast<const int*>(order), static_cast<int>(rows),              \
        static_cast<const float*>(vals), static_cast<int>(cap),              \
        static_cast<int>(v_bs), static_cast<int>(v_hs),                      \
        static_cast<int>(v_cs), static_cast<int>(heads),                     \
        static_cast<int>(lps), static_cast<int>(lpr),                        \
        static_cast<int>(n_chunks), static_cast<float*>(out),                \
        static_cast<int*>(counter), s);
  DGL_ROW_REDUCE(1, 1)
  DGL_ROW_REDUCE(1, 2)
  DGL_ROW_REDUCE(1, 4)
  DGL_ROW_REDUCE(1, 8)
  DGL_ROW_REDUCE(4, 1)
  DGL_ROW_REDUCE(4, 2)
  DGL_ROW_REDUCE(4, 4)
  DGL_ROW_REDUCE(4, 8)
#undef DGL_ROW_REDUCE
  return cudaErrorInvalidValue;
}

// registers a thread and local-memory bytes (the stack frame and spills)
// a thread of the row reduce's instance at vec and cpl: regs_local, two
// ints.
int dgl_row_reduce_attrs(int64_t vec, int64_t cpl, int64_t device,
                         void* regs_local) {
  const cudaError_t err = cudaSetDevice(static_cast<int>(device));
  if (err != cudaSuccess) return err;
  int* o = static_cast<int*>(regs_local);
#define DGL_REDUCE_ATTRS(V_, C_) \
  if (vec == V_ && cpl == C_) return row_reduce_attrs<V_, C_>(o, o + 1);
  DGL_REDUCE_ATTRS(1, 1)
  DGL_REDUCE_ATTRS(1, 2)
  DGL_REDUCE_ATTRS(1, 4)
  DGL_REDUCE_ATTRS(1, 8)
  DGL_REDUCE_ATTRS(4, 1)
  DGL_REDUCE_ATTRS(4, 2)
  DGL_REDUCE_ATTRS(4, 4)
  DGL_REDUCE_ATTRS(4, 8)
#undef DGL_REDUCE_ATTRS
  return cudaErrorInvalidValue;
}

}  // extern "C"
