"""The dot-product row walk (``csrc/row_agg.cu`` ``row_sddmm_kernel``)
rendered lane by lane in numpy, shared by the walk's tests
(``test_torch_sddmm_walk.py``, ``test_torch_ds_fold.py``,
``test_torch_scores_rows.py``, ``test_torch_slot_walks.py``,
``test_torch_fwd_scores.py``, which also renders its sibling
``row_vattn_fe_kernel`` at its layout); no JAX."""
import numpy as np

import dgl_tpu_torch.ops.kernels.tiled_spmm as tts


U_BY_CPL = {1: 8, 2: 4, 4: 2, 8: 2}     # csrc/row_agg.cu Unroll<4, CPL>


def _launch_rendered(v, x, z, nh, nv, rows, partial=None, layout=None,
                     u_n=None, with_entries=False):
    """One launch of ``row_sddmm_kernel`` over view ``v``, lane by lane:
    x, z (n, nh * nv, 4), the launch's heads and vectors; each row's
    slots in rounds of U (lpr slots a step, U at a time), each lane's
    partial dots of its vectors, a head's vectors summed in the lane, the
    butterfly over the head's lanes (halving steps, then plain xor steps),
    the writer lanes' stores.  ``partial(xs, zs, vq)``: a lane's partial
    of vector vq from the gathered rows xs (m, 4) and the rows' own zs (m,
    4) in place of the dot (K9's scores mode); with ``with_entries``,
    ``partial(xs, zs, vq, e)``, e the entries.  ``layout`` (lph, cph, lpr,
    cpl) and ``u_n`` (slots a round) in place of the walk's (K11 v2's
    scores walk: one vector a lane, at least 8 lanes a row).  Returns
    [(entries, head, dots)], one for each store instruction of the
    writers."""
    lph, cph, lpr, cpl = (tts._sddmm_layout(nh, nv) if layout is None
                          else layout)
    u_n = U_BY_CPL[cpl] if u_n is None else u_n
    hpp = lpr // lph
    ptr = v.ptr.numpy().astype(np.int64)
    nbr = v.nbr.numpy()
    n_e = len(nbr)
    pos = np.arange(n_e) - ptr[rows]             # the entry's place in its row
    size = min(lpr, u_n)                          # slots of a round
    key = rows * (n_e + 1) + pos // size
    _, rnd = np.unique(key, return_inverse=True)  # each entry's round
    u_of = pos % size
    n_r = rnd.max() + 1 if n_e else 0
    entry = np.full((n_r, u_n), -1)               # the entry at (round, u)
    entry[rnd, u_of] = np.arange(n_e)
    lanes = np.arange(lpr)
    hl, fl = lanes // lph, lanes % lph
    # d[round, lane, q, u]: lane's partial dot of vector q at slot u
    d = np.zeros((n_r, lpr, cpl, u_n), np.float32)
    hq = np.zeros((lpr, cpl), np.int64)
    for q in range(cpl):
        k, j = divmod(q, cph)
        vi = fl + j * lph
        hq[:, q] = hl + k * hpp
        for li in np.nonzero((hq[:, q] < nh) & (vi < nv))[0]:
            vq = hq[li, q] * nv + vi[li]
            live = entry >= 0
            e = entry[live]
            xs, zs = x[nbr[e], vq], z[rows[e], vq]
            d[live.nonzero()[0], li, q, live.nonzero()[1]] = (
                (xs * zs).sum(-1) if partial is None
                else partial(xs, zs, vq, e) if with_entries
                else partial(xs, zs, vq))
    sp = 1
    while sp < cpl and sp < cph:     # a head's vectors into its first
        for q in range(0, cpl - sp, 2 * sp):
            d[:, :, q] += d[:, :, q + sp]
        sp *= 2
    lg = int(np.log2(lph))
    steps = min(int(np.log2(u_n)), lg)
    m, rest = u_n >> steps, lph >> steps
    bu = np.zeros(lpr, np.int64)      # each lane's first slot of a round
    for t in range(steps):
        bu += ((fl >> (lg - 1 - t)) & 1) * (u_n >> (t + 1))
    o, half = lph >> 1, u_n >> 1
    while o and half:                 # the halving steps
        up = ((fl & o) != 0)[None, :, None, None]
        lo, hi = d[..., :half], d[..., half:2 * half]
        send, keep = np.where(up, lo, hi), np.where(up, hi, lo)
        d = d.copy()
        d[..., :half] = keep + send[:, lanes ^ o]
        o, half = o >> 1, half >> 1
    while o:                          # the plain xor steps
        d[..., 0] = d[..., 0] + d[:, lanes ^ o][..., 0]
        o >>= 1
    stores = []
    for li in np.nonzero((fl & (rest - 1)) == 0)[0]:      # the writers
        for q in range(0, cpl, cph):
            if hq[li, q] >= nh:
                continue
            for i in range(m):
                e = entry[:, bu[li] + i]
                r_live = np.nonzero(e >= 0)[0]
                stores.append((e[r_live], hq[li, q], d[r_live, li, q, i]))
    return stores
