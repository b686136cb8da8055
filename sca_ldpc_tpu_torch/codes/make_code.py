"""Parity-check matrix construction (host-side NumPy).

The regular Gallager-style codes (with and without the appended identity),
the binary and q-ary quasi-cyclic codes, and the first row of the random
circulant of the HQC attack code (distance-spectrum multiplicity at most 1).
References: make_code.py:12-273.  The RNG draw sequences match the
reference, so fixed seeds give the same matrices in this package and in
``sca_ldpc_tpu``.
"""

from math import ceil

import numpy as np
from scipy.linalg import circulant

from . import distance_spectrum
from ..utils import make_random_state


def fixed_weight_vec(size, weight, rng):
    """Random 0/1 vector of fixed weight.

    Rejection-sampled one index at a time with ``rng.randint(0, size-1)``
    (reference: make_code.py:12-29; the reference's off-by-one range is kept
    for seed parity — index ``size-1`` is never drawn).
    """
    a = np.zeros(size, dtype=int)
    cur = 0
    while cur < weight:
        i = rng.randint(0, size - 1)
        if a[i] == 0:
            a[i] = 1
            cur += 1
    return a


def flatten_matrix_parts(parts):
    """Horizontally concatenate matrix blocks."""
    return np.concatenate(parts, axis=1)


def circular_qary_parity_check_block(block_len, column_weight, rng):
    """One signed-circulant block for q-ary QC codes.

    Entries are +/-1; a diagonal flips sign each time it wraps around the block
    boundary (reference: make_code.py:50-68).  Indices are drawn with the
    reference's ``randint(0, block_len-1)``.
    """
    block = np.zeros((block_len, block_len), dtype=np.int8)
    nonzero_idx = []
    while len(nonzero_idx) < column_weight:
        i = rng.randint(0, block_len - 1)
        if i not in nonzero_idx:
            nonzero_idx.append(i)
    val = [1 if i == 0 else -1 for i in nonzero_idx]
    idx = list(nonzero_idx)
    for row in range(block_len):
        for j in range(column_weight):
            block[row, idx[j]] = val[j]
            idx[j] += 1
            if idx[j] == block_len:
                idx[j] = 0
                val[j] = -val[j]
    return block


def make_qary_qc_parity_check_matrix(block_len, sum_weight, num_blocks, rng, check_blocks=1):
    """Q-ary quasi-cyclic ``[H'|I]``: ``check_blocks`` rows of ``num_blocks``
    signed circulants, identity appended (reference: make_code.py:72-94)."""
    column_weight = ceil(sum_weight / num_blocks)
    if sum_weight % num_blocks != 0:
        raise NotImplementedError("sum_weight must be a multiple of num_blocks")
    parts = [
        [circular_qary_parity_check_block(block_len, column_weight, rng) for _ in range(num_blocks)]
        for _ in range(check_blocks)
    ]
    m = np.block(parts)
    return np.concatenate((m, np.identity(block_len * check_blocks, dtype=int)), axis=1)


def make_qc_parity_check_matrix(block_len, column_weight, num_blocks, rng):
    """Binary quasi-cyclic ``[H_0|...|H_i|I]`` (reference: make_code.py:97-123)."""
    parts = [
        circulant(fixed_weight_vec(block_len, column_weight, rng)) for _ in range(num_blocks)
    ]
    parts.append(np.identity(block_len, dtype=int))
    return flatten_matrix_parts(parts)


def make_regular_ldpc_parity_check_matrix(k, r, column_weight, row_weight, rng):
    """Regular Gallager-style LDPC parity-check matrix ``H_(r x k)``.

    First band is consecutive ones; the remaining ``column_weight - 1`` bands
    are column permutations of it (reference: make_code.py:126-188).
    """
    if column_weight <= 1:
        raise ValueError("column_weight must be at least 2.")
    if row_weight < column_weight:
        raise ValueError("row_weight must be greater than or equal column_weight.")
    if k % row_weight:
        raise ValueError("row_weight must divide n for a regular LDPC matrix H.")
    if r != (k * column_weight) // row_weight:
        raise ValueError(
            "r must follow '(k * column_weight) // row_weight' for the parity check matrix to be regular"
        )

    rng = make_random_state(rng)
    block_size = r // column_weight
    block = np.zeros((block_size, k), dtype=int)
    for i in range(block_size):
        block[i, i * row_weight : (i + 1) * row_weight] = 1

    H = np.zeros((r, k))
    H[:block_size] = block
    for i in range(1, column_weight):
        H[i * block_size : (i + 1) * block_size] = rng.permutation(block.T).T
    return H.astype(int)


def make_regular_ldpc_parity_check_matrix_identity(k, r, column_weight, row_weight, seed=None):
    """Regular LDPC matrix with identity appended: ``[H_(r x k) | I_r]``
    (reference: make_code.py:191-217)."""
    return flatten_matrix_parts(
        [
            make_regular_ldpc_parity_check_matrix(k, r, column_weight, row_weight, seed),
            np.identity(r, dtype=int),
        ]
    )


def make_random_ldpc_parity_check_matrix(n, weight, seed=None):
    """Square circulant ``H_(n x n)`` whose first row has distance-spectrum
    multiplicity <= 1 (reference: make_code.py:220-244)."""
    first_row = distance_spectrum.gen_array_ds_multiplicity(n, weight, 1, make_random_state(seed))
    return circulant(first_row)


def make_random_ldpc_parity_check_matrix_with_identity(n, weight, seed=None):
    """``[H_(n x n) | I_n]`` with H as in
    :func:`make_random_ldpc_parity_check_matrix` (reference: make_code.py:248-273)."""
    H0 = make_random_ldpc_parity_check_matrix(n, weight, seed)
    return flatten_matrix_parts([H0, np.identity(n, dtype=int)])


def random_circulant_first_row(n, weight, seed=None):
    """First row only of the DS-constrained random circulant — the memory-lean
    entry point for large N (HQC-256: N=57637), paired with
    :class:`~sca_ldpc_tpu_torch.codes.layout.CirculantLayout` instead of a
    dense H."""
    return distance_spectrum.gen_array_ds_multiplicity(n, weight, 1, make_random_state(seed))
