"""Kyber secret sampling and check-sum computation.

Reference: simulate/kyber.py:35-105.  The centered-binomial sampler keeps the
reference's os.urandom source (secret generation is seed-independent there
too); a vectorized NumPy path replaces the per-coefficient bit loop.  A copy
of the JAX package's ``models/kyber/secrets.py``, over the port's ``codes``
and ``utils``.
"""

from math import comb as binomial
from os import urandom

import numpy as np

from ...codes import make_qary_qc_parity_check_matrix
from ...utils import make_random_state
from .params import BLOCK_LEN, ETA, NUM_BLOCKS, to_zq_range


def sample_secret_coefs(n, eta=ETA, rng=None):
    """n centered-binomial(eta) coefficients in [-eta, eta]."""
    if rng is not None:
        raw = rng.randint(0, 256, size=n).astype(np.uint8)
    else:
        raw = np.frombuffer(urandom(n), dtype=np.uint8)
    acc = np.zeros(n, dtype=np.int64)
    for i in range(eta):
        acc += (raw >> i) & 1
    for i in range(eta, 2 * eta):
        acc -= (raw >> i) & 1
    return acc.tolist()


def secret_distribution(sum_weight=1, eta=ETA):
    """Prior of a sum of ``sum_weight`` centered-binomial coefficients
    (kyber.py:60-64)."""
    B = sum_weight * eta
    n = 2 * B
    den = 2**n
    return {s: binomial(n, s + B) / den for s in range(-B, B + 1)}


def gen_ldpc_matrix(sum_weight, rng_state, check_blocks):
    """Signed q-ary QC [H'|I] for the Kyber attack (kyber.py:67-74)."""
    return make_qary_qc_parity_check_matrix(
        BLOCK_LEN, sum_weight, NUM_BLOCKS, make_random_state(rng_state), check_blocks
    )


def compute_ssum(s, H, check_blocks):
    """ssum = H' * s over the centered Z_q representatives (kyber.py:85-92)."""
    n_rows = BLOCK_LEN * check_blocks
    n_cols = BLOCK_LEN * NUM_BLOCKS
    s_flat = np.array(
        [to_zq_range(s[j // BLOCK_LEN][j % BLOCK_LEN]) for j in range(n_cols)],
        dtype=np.int64,
    )
    Hp = np.asarray(H)[:n_rows, :n_cols].astype(np.int64)
    return (Hp @ s_flat).tolist()


def generate_secret(rng=None):
    return [sample_secret_coefs(BLOCK_LEN, rng=rng) for _ in range(NUM_BLOCKS)]


def generate_secret_for_H(need_ssum, H, check_blocks, rng=None):
    s = generate_secret(rng=rng)
    if need_ssum is False:
        return s, None
    return s, compute_ssum(s, H, check_blocks)
