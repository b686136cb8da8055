"""Small code-analysis utilities (stand-ins for ldpc.code_util /
ldpc.codes used by the reference); the JAX package's ``codes/util.py``."""

import numpy as np


def rep_code(n):
    """Repetition-code parity-check matrix (ldpc.codes.rep_code)."""
    H = np.zeros((n - 1, n), dtype=int)
    for i in range(n - 1):
        H[i, i] = 1
        H[i, i + 1] = 1
    return H


def gf2_rank(H):
    """Rank of a binary matrix over GF(2)."""
    M = (np.asarray(H) % 2).astype(np.uint8).copy()
    rows, cols = M.shape
    rank = 0
    for c in range(cols):
        pivot = None
        for r in range(rank, rows):
            if M[r, c]:
                pivot = r
                break
        if pivot is None:
            continue
        M[[rank, pivot]] = M[[pivot, rank]]
        mask = M[:, c].astype(bool)
        mask[rank] = False
        M[mask] ^= M[rank]
        rank += 1
        if rank == rows:
            break
    return rank


def code_parameters(H):
    """(n, k, rank) of the code with parity-check matrix H
    (ldpc.code_util.get_code_parameters analogue, used for debug output at
    hqc.py:1267-1270)."""
    H = np.asarray(H)
    n = H.shape[1]
    r = gf2_rank(H)
    return n, n - r, r
