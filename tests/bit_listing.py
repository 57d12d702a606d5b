"""The listed-bit walks' listing (``csrc/bitlist.cuh``: ``list_start``,
``list_bits``) rendered lane by lane in numpy, shared by the tests that
render the walks on the CPU: K5's two walks (``test_torch_bwd_walks.py``,
``test_torch_fwd_walk.py``) and K7's dz and dq walks
(``test_torch_dz_slot_grad.py``, ``test_torch_dq_node_grad.py``).  It
imports no JAX."""
import numpy as np

# csrc/bitlist.cuh kStepWords, kList, kListDrainAt
STEP_WORDS, LIST, DRAIN_AT = 8, 256, 128
LANE = np.arange(32)


def _popcount(words):
    """Set bits of each uint32 of ``words``."""
    w = words.astype(np.uint64)
    return np.array([bin(int(x)).count("1") for x in w.reshape(-1)],
                    np.int64).reshape(w.shape)


def _listed_steps(words, k32, num_dst):
    """The entries the walk lists from one row's words, step by step: at
    a step each lane holds STEP_WORDS words (lane L word u is j = j0 +
    32 u + L), a warp prefix sum of the lanes' popcounts gives each lane
    its first index, and the lane lists its bits word by word, lowest bit
    first, d = b * k32 + j (-1 past num_dst).  Yields each step's entries
    in index order."""
    for j0 in range(0, k32, 32 * STEP_WORDS):
        j = j0 + 32 * np.arange(STEP_WORDS)[:, None] + LANE   # (u, lane)
        w = np.where(j < k32, words[np.minimum(j, k32 - 1)], 0)
        pc = _popcount(w)
        c = pc.sum(0)
        incl = np.cumsum(c)                                  # the prefix sum
        first, total = incl - c, int(incl[-1])
        seq = np.full(total, -2, np.int64)
        for lane in range(32):
            idx = first[lane]
            for u in range(STEP_WORDS):
                bits = int(w[u, lane])
                while bits:
                    b = (bits & -bits).bit_length() - 1
                    bits &= bits - 1
                    d = b * k32 + int(j[u, lane])
                    seq[idx] = d if d < num_dst else -1
                    idx += 1
        assert (seq != -2).all()
        yield seq


def _drains(words, k32, num_dst):
    """The lists the walk drains for one row: the list (LIST entries) is
    drained when full, in the middle of a step (the rest of the step is
    listed after), when it holds DRAIN_AT entries at the end of a step,
    and at the end of the row."""
    out, cur = [], []
    for seq in _listed_steps(words, k32, num_dst):
        p0 = 0
        while p0 < len(seq):
            if len(cur) == LIST:
                out.append(cur)
                cur = []
            take = min(LIST - len(cur), len(seq) - p0)
            cur = cur + list(seq[p0:p0 + take])
            p0 += take
        if len(cur) >= DRAIN_AT:
            out.append(cur)
            cur = []
    out.append(cur)
    return out
