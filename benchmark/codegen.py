"""The first row of a configuration's circulant, drawn by the benchmark.

A frozen copy of the draw the HQC attack code uses (the SCA-LDPC artifact's
``simulate/distance_spectrum.py``, through ``make_code.random_circulant_first_row``):
walk a random permutation of the positions, drawn with
``RandomState(seed).choice(n, n, replace=False)``, and keep each position that
leaves every circular distance between kept positions at multiplicity at most
1, until ``weight`` positions are kept.  Any two columns of the code then share
at most one check.  Kept here so that the code a configuration names does not
move when the program changes.
"""

import numpy as np


def first_row(n, weight, seed):
    """0/1 int array of length ``n`` with ``weight`` ones whose circular
    distance spectrum has multiplicity at most 1."""
    rng = np.random.RandomState(seed)
    order = rng.choice(n, size=n, replace=False)
    kept = [int(order[0])]
    seen = np.zeros(n // 2 + 1, dtype=bool)
    for cand in order[1:]:
        d = np.abs(int(cand) - np.asarray(kept))
        d = np.minimum(d, n - d)
        if seen[d].any() or len(np.unique(d)) < len(d):
            continue
        seen[d] = True
        kept.append(int(cand))
        if len(kept) >= weight:
            row = np.zeros(n, dtype=int)
            row[kept] = 1
            return row
    raise RuntimeError(f"no first row of weight {weight} under multiplicity 1 at n={n}")

