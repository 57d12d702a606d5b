"""Reddit-statistics synthetic graph (the port's own copy).

Counterpart of ``dgl_tpu/data/synth_reddit.py:91-202``: the same
generator, so the same seed gives the same arrays.  Real Reddit has
232,965 nodes and 114.6M directed edges (57.3M undirected pairs stored
both ways), heavy-tailed degrees and 41 communities
(``python/dgl/data/reddit.py``); this graph matches those statistics.
Generation is vectorized numpy, chunked to bound peak memory.
"""
from __future__ import annotations

import numpy as np

from ..utils import unique_counts


def reddit_like_graph_sym(num_nodes: int = 232_965,
                          num_edges: int = 114_615_892,
                          num_communities: int = 41,
                          p_intra: float = 0.8,
                          zipf_a: float = 0.85,
                          max_degree: int = 21_656,
                          seed: int = 0,
                          chunk: int = 8_000_000):
    """SYMMETRIC Reddit-statistics graph (degree-corrected SBM).

    Real Reddit is an undirected graph stored with both edge directions
    (``python/dgl/data/reddit.py``: 114,615,892 directed = 57.3M
    undirected x 2; in-degree == out-degree, both heavy-tailed).  A
    directed generator would give only the dst side a Zipf tail; this
    one draws BOTH endpoints degree-weighted (endpoint B within the
    community of A w.p. ``p_intra``) and emits both directions, so
    A == A^T exactly — which the symmetric bitmask format exploits (one
    packed matrix serves the forward and the backward).

    Real Reddit is a SIMPLE graph (no multi-edges, no self-loops); the
    degree-weighted pair draws collide heavily on hub-hub pairs (~10%
    duplicates at Reddit scale), so pairs are deduplicated on the
    unordered key and topped up with fresh weighted draws until exactly
    ``num_edges // 2`` distinct undirected pairs exist.

    Returns (src, dst) int32 with ``2 * (num_edges // 2)`` edges.
    """
    rng = np.random.default_rng(seed)
    n = num_nodes
    half = num_edges // 2

    w = 1.0 / np.arange(1, n + 1) ** zipf_a
    rng.shuffle(w)
    # cap w so EXPECTED total degree (2*half*w/sum_w) <= max_degree —
    # role-B picks are weight-proportional, so the cap must live on w
    for _ in range(6):
        w = np.minimum(w, max_degree * w.sum() / (2.0 * half))
    # endpoint-A counts: exact degree-weighted multiset via repeat
    deg = w * (half / w.sum())
    cap = max_degree / 2
    for _ in range(4):
        deg = np.clip(deg, 0.5, cap)
        deg = deg * (half / deg.sum())
    deg_int = np.floor(np.clip(deg, 0.0, cap)).astype(np.int64)
    short = half - int(deg_int.sum())
    if short > 0:
        frac = np.maximum(deg - deg_int, 1e-12)
        extra = rng.choice(n, size=short, p=frac / frac.sum())
        np.add.at(deg_int, extra, 1)
    elif short < 0:
        drop = rng.choice(np.repeat(np.arange(n), np.minimum(deg_int, 1)),
                          size=-short, replace=False)
        np.add.at(deg_int, drop, -1)

    comm_of = (np.arange(n) * num_communities // n).astype(np.int32)
    comm_start = np.searchsorted(comm_of, np.arange(num_communities))
    comm_end = np.append(comm_start[1:], n)

    a_end = np.repeat(np.arange(n, dtype=np.int32), deg_int)
    rng.shuffle(a_end)

    # endpoint-B: degree-weighted inverse-CDF, community-restricted
    cumw = np.cumsum(w)
    total = cumw[-1]
    lo_mass = np.where(comm_start > 0, cumw[comm_start - 1], 0.0)
    hi_mass = cumw[comm_end - 1]
    b_end = np.empty(half, np.int32)
    for lo in range(0, half, chunk):
        hi = min(lo + chunk, half)
        a = a_end[lo:hi]
        c = comm_of[a]
        intra = rng.uniform(size=hi - lo) < p_intra
        u = rng.uniform(size=hi - lo)
        target = np.where(intra,
                          lo_mass[c] + u * (hi_mass[c] - lo_mass[c]),
                          u * total)
        b_end[lo:hi] = np.searchsorted(cumw, target).astype(np.int32)
    b_end = np.minimum(b_end, n - 1)

    # ---- simple-graph repair: dedupe unordered pairs, top up ----------
    def _ukey(a, b):
        lo2 = np.minimum(a, b).astype(np.int64)
        hi2 = np.maximum(a, b).astype(np.int64)
        return lo2 * n + hi2

    keep = a_end != b_end
    keys = unique_counts(_ukey(a_end[keep], b_end[keep]))[0]
    for _ in range(64):
        need = half - len(keys)
        if need <= 0:
            break
        m = int(need * 1.6) + 1024
        ua = rng.uniform(size=m) * total
        a2 = np.minimum(np.searchsorted(cumw, ua), n - 1).astype(np.int32)
        c2 = comm_of[a2]
        intra2 = rng.uniform(size=m) < p_intra
        u2 = rng.uniform(size=m)
        t2 = np.where(intra2,
                      lo_mass[c2] + u2 * (hi_mass[c2] - lo_mass[c2]),
                      u2 * total)
        b2 = np.minimum(np.searchsorted(cumw, t2), n - 1).astype(np.int32)
        ok = a2 != b2
        keys = unique_counts(np.concatenate([keys,
                                             _ukey(a2[ok], b2[ok])]))[0]
    if len(keys) > half:
        keys = rng.choice(keys, size=half, replace=False)
    lo_n = (keys // n).astype(np.int32)
    hi_n = (keys % n).astype(np.int32)
    src = np.concatenate([lo_n, hi_n])
    dst = np.concatenate([hi_n, lo_n])
    perm = rng.permutation(len(src))
    return src[perm], dst[perm]
