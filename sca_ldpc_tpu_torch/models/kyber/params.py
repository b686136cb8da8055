"""Kyber parameterization (reference: simulate/kyber.py:8-33).

The reference pins Kyber-768; the other sets are kept selectable here.
A copy of the JAX package's ``models/kyber/params.py``.
"""

Q = 3329
ETA = 2
BLOCK_LEN = 256
NUM_BLOCKS = 3  # Kyber-768

PARAM_SETS = {
    # name: (eta, num_blocks)
    "512": (3, 2),
    "768": (2, 3),
    "1024": (2, 4),
}


def secret_range(sum_weight, eta=ETA):
    """Symbol range of a sum of ``sum_weight`` secret coefficients."""
    return range(-sum_weight * eta, sum_weight * eta + 1)


def secret_range_len(sum_weight, eta=ETA):
    return 2 * sum_weight * eta + 1


def to_zq_range(x, q=Q):
    """Map to the centered representative in (-q/2, q/2]."""
    x = x % q
    return x - q if x > q / 2 else x
