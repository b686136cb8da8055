"""The HQC attack's masked decode, worked out again from the checks.

A decode of the attack sees the checks measured so far: check ``i`` is row
``bit_i`` of the circulant of plaintext block ``block_i``, with its measured
value ``c_i`` and the oracle's certainty.  The code is ``[[C_1]; ...; [C_P]] |
I``: a measured row has syndrome ``c_i`` and an identity prior from its
certainty, an unmeasured row the prior LLR 0 (it carries no information); the
shared variables (the support of ``y``) have the prior of ``|y| / N`` ones.
:func:`decision_stats` are the attack's statistics of a decode (hqc.py
709-758): flips on and off the support of ``y``, and the checks the decode
marks as measured wrong.
"""

import numpy as np
import torch

from .bp import decode


def _llr(p):
    p = min(max(float(p), 1e-9), 1.0 - 1e-9)
    return float(np.log((1.0 - p) / p))


def masked_inputs(rows, checks, n, y_weight, blocks, device):
    """(prior_c [1, N], prior_i [1, P, N], syndrome [1, P, N]) of one decode:
    ``rows`` [(block, bit)] and ``checks`` [(value, certainty)] of its checks,
    ``blocks`` the number of circulant blocks."""
    syn = np.zeros((blocks, n), np.int32)
    prior_i = np.zeros((blocks, n), np.float32)
    for (blk, bit), (c, certainty) in zip(rows, checks):
        syn[blk, bit] = int(c)
        prior_i[blk, bit] = _llr(1.0 - certainty)
    prior_c = np.full((1, n), _llr(y_weight / n), np.float32)
    return tuple(torch.as_tensor(a, device=device) for a in (prior_c, prior_i[None], syn[None]))


def decision_stats(e_c, e_i, rows, checks, y_support):
    """(good flips, bad flips, suspected errors on satisfied checks, on
    unsatisfied checks, success) of one decode's decisions."""
    y = set(int(v) for v in y_support)
    flips = set(np.flatnonzero(e_c).tolist())
    good = len(flips & y)
    bad_sat = bad_unsat = 0
    for (blk, bit), (c, _p) in zip(rows, checks):
        corrected = int(c) ^ int(e_i[blk, bit])
        if c and not corrected:
            bad_unsat += 1
        elif not c and corrected:
            bad_sat += 1
    return good, len(flips) - good, bad_sat, bad_unsat, flips == y


def reference_stats(decodes, block_shifts, n, y_support, max_iter, device, store=None):
    """(statistics, iterations) of each decode in ``decodes`` (a list of
    (rows, checks)) of one attack whose blocks have the support offsets
    ``block_shifts``.  Decodes with the same number of blocks run as one
    batch."""
    out = [None] * len(decodes)
    by_blocks = {}
    for i, (rows, _checks) in enumerate(decodes):
        by_blocks.setdefault(1 + max(blk for blk, _bit in rows), []).append(i)
    for blocks, idx in by_blocks.items():
        parts = [masked_inputs(*decodes[i], n, len(y_support), blocks, device) for i in idx]
        prior_c, prior_i, syn = (torch.cat(x) for x in zip(*parts))
        e_c, e_i, _conv, it = decode(prior_c, prior_i, syn, block_shifts[:blocks], max_iter, store)
        e_c, e_i, it = e_c.cpu().numpy(), e_i.cpu().numpy(), it.cpu().numpy()
        for j, i in enumerate(idx):
            out[i] = (decision_stats(e_c[j], e_i[j], *decodes[i], y_support), int(it[j]))
    return out
