"""Distance-spectrum-constrained first-row generation for circulant codes.

The HQC attack builds its check-generation matrix as a circulant whose first
row has a distance-spectrum multiplicity of at most 1, guaranteeing any two
columns of H share at most one check (reference: simulate/distance_spectrum.py,
used from simulate/hqc.py:1056 via make_code.py:220-244).

Host-side NumPy: this runs once per attack instance; the RNG draw sequence is
kept identical to the reference so fixed seeds reproduce the same codes.
"""

import numpy as np


def calc_ds(bits: np.ndarray) -> np.ndarray:
    """Circular distance spectrum of a 0/1 array.

    ``out[d]`` counts pairs of set positions at circular distance ``d``
    (distances folded to ``min(d, n-d)``).
    """
    n = len(bits)
    out = np.zeros(n // 2 + 1, dtype=int)
    ones = np.flatnonzero(bits)
    if len(ones) >= 2:
        diffs = ones[None, :] - ones[:, None]
        diffs = diffs[np.triu_indices(len(ones), k=1)]
        folded = np.minimum(diffs, n - diffs)
        np.add.at(out, folded, 1)
    return out


def check_ds_addition_limit(bits: np.ndarray, ds: np.ndarray, add: int, limit: int):
    """Distance spectrum after setting position ``add``, or ``False`` if any
    multiplicity would exceed ``limit``."""
    n = len(bits)
    ones = np.flatnonzero(bits)
    new_ds = ds.copy()
    if len(ones):
        d = np.abs(add - ones)
        d = np.minimum(d, n - d)
        np.add.at(new_ds, d, 1)
    if np.any(new_ds > limit):
        return False
    return new_ds


def gen_array_ds_multiplicity(length: int, weight: int, max_multiplicity: int, rng):
    """Random 0/1 array with ``weight`` set positions whose distance-spectrum
    multiplicity never exceeds ``max_multiplicity``.

    Greedy: walk a random permutation of positions, keeping each candidate only
    if the spectrum constraint still holds.  The permutation is drawn with
    ``rng.choice(length, size=length, replace=False)`` exactly as the reference
    (distance_spectrum.py:67) so seeds reproduce identical arrays.
    """
    out = np.zeros(length, dtype=int)
    order = rng.choice(length, size=length, replace=False)
    out[order[0]] = 1
    ds = calc_ds(out)
    w = 1
    for cand in order[1:]:
        new_ds = check_ds_addition_limit(out, ds, cand, max_multiplicity)
        if isinstance(new_ds, np.ndarray):
            ds = new_ds
            out[cand] = 1
            w += 1
        if w >= weight:
            return out
    raise RuntimeError(
        f"Failed to reach weight {weight} under multiplicity {max_multiplicity}; got {w}"
    )
