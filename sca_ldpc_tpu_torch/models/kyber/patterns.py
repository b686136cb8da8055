"""Optimal measurement-pattern databases for the Kyber attack.

The attack encodes each secret coefficient (or coefficient sum) into a small
set of binary oracle measurements; the pattern tables below — the per-symbol
codewords and their expected information content — are experimentally
optimized constants carried over from the reference / paper
(simulate/kyber.py:108-283).  Accessors mirror kyber.py:286-359.  A copy of
the JAX package's ``models/kyber/patterns.py``, databases unchanged.
"""

import numpy as np

from .params import ETA


def pattern_four_consecutive(l, idx):
    """Alternating 4-run pattern (kyber.py:108-112)."""
    return tuple(1 - (((i - idx) // 4) % 2) for i in range(l))


def coding_from_patterns(pattern, sum_weight=1, eta=ETA):
    """Map symbol s in [-B..B] -> its measurement codeword (kyber.py:50-57)."""
    B = sum_weight * eta
    if len(pattern) != 2 * B + 1:
        raise ValueError("len of pattern doesn't match sum weight")
    if isinstance(pattern[0], tuple):
        return {s: p for s, p in zip(range(-B, B + 1), pattern)}
    return {s: (p,) for s, p in zip(range(-B, B + 1), pattern)}


# -- single-coefficient patterns, eta=2 (symbols -2..2), keyed by oracle
#    accuracy then number of measurements per coefficient.  Value: (per-symbol
#    codewords, expected information in bits; -1 where not recorded).
SINGLE_PATTERNS = {
    1: {
        2: (((0, 0), (1, 0), (0, 1), (1, 1), (0, 0)), -1),
        3: (((0, 0, 0), (1, 0, 1), (0, 1, 1), (1, 1, 0), (1, 0, 0)), -1),
    },
    0.995: {
        1: ((0, 1, 0, 1, 0), 0.954585307666206),
        2: (((0, 0), (1, 0), (0, 1), (1, 1), (0, 0)), 1.81774258488288),
        3: (((0, 0, 0), (1, 0, 1), (0, 1, 1), (1, 1, 0), (1, 0, 0)), 1.98362204455267),
    },
    0.95: {
        1: ((0, 1, 0, 1, 0), 0.713603042884044),
        2: (((0, 0), (1, 0), (0, 1), (1, 1), (0, 0)), 1.35893734442610),
        3: (((0, 0, 0), (1, 0, 1), (0, 1, 1), (1, 1, 0), (1, 0, 0)), 1.65239388561346),
        4: (
            ((0, 0, 0, 0), (1, 0, 0, 1), (0, 1, 1, 1), (1, 1, 0, 0), (1, 0, 1, 0)),
            1.81879316207406,
        ),
        5: (
            (
                (0, 0, 0, 0, 0),
                (1, 0, 0, 1, 1),
                (0, 1, 1, 1, 0),
                (0, 1, 0, 0, 1),
                (1, 0, 1, 0, 0),
            ),
            1.90087902706089,
        ),
    },
    0.9: {
        1: ((0, 1, 0, 1, 0), 0.531004406410719),
        2: (((0, 0), (1, 0), (0, 1), (1, 1), (0, 0)), 1.01362230968129),
        3: (((0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 0), (0, 0, 0)), 1.32785802304240),
        4: (
            ((0, 0, 0, 0), (1, 0, 1, 0), (0, 1, 1, 1), (1, 1, 0, 0), (1, 0, 0, 1)),
            1.53326842875671,
        ),
        5: (
            (
                (0, 0, 0, 0, 0),
                (1, 0, 1, 0, 1),
                (0, 1, 1, 1, 0),
                (0, 0, 0, 1, 1),
                (1, 1, 0, 0, 0),
            ),
            1.66523603579579,
        ),
    },
}

# -- coefficient-sum patterns, keyed by sum_weight then measurements per sum.
#    Value: (expected information in bits, per-symbol codewords for -B..B).
SUM_PATTERNS = {
    6: {
        1: (
            0.4087005109032,
            (0, 1, 0, 1, 0, 1, 0, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1),
        ),
        2: (
            0.67694657225044,
            (
                (0, 0), (0, 1), (0, 0), (1, 1), (1, 0),
                (0, 0), (0, 1), (0, 0), (1, 1), (1, 0),
                (1, 1), (0, 1), (0, 0), (0, 1), (1, 0),
                (1, 1), (1, 0), (0, 0), (0, 1), (0, 0),
                (1, 1), (1, 0), (0, 1), (0, 1), (0, 0),
            ),
        ),
        3: (
            0.869634646374502,
            (
                (0, 0, 0), (1, 1, 1), (0, 0, 0), (1, 0, 1), (0, 1, 0),
                (0, 0, 1), (1, 1, 1), (0, 0, 0), (1, 0, 1), (0, 1, 0),
                (0, 0, 1), (1, 1, 0), (0, 1, 1), (1, 0, 0), (1, 1, 1),
                (0, 0, 0), (1, 0, 1), (0, 1, 0), (1, 0, 1), (1, 1, 0),
                (0, 0, 1), (1, 0, 0), (0, 1, 1), (0, 0, 0), (1, 1, 0),
            ),
        ),
        4: (
            0.962966212067453,
            (
                (0, 0, 0, 0), (0, 1, 1, 1), (1, 0, 1, 1), (0, 1, 1, 0), (1, 0, 0, 1),
                (1, 1, 0, 0), (0, 0, 0, 1), (1, 1, 0, 1), (0, 0, 1, 0), (0, 1, 1, 1),
                (1, 0, 1, 0), (0, 1, 1, 0), (1, 0, 0, 1), (1, 1, 0, 0), (0, 0, 0, 1),
                (1, 1, 1, 1), (0, 0, 1, 0), (0, 1, 1, 1), (1, 0, 1, 0), (0, 1, 0, 1),
                (1, 1, 0, 1), (1, 0, 0, 0), (0, 1, 0, 1), (1, 0, 1, 0), (0, 1, 1, 0),
            ),
        ),
    },
}

# -- adaptive (tree-coded) single-coefficient patterns for eta=3, keyed by
#    accuracy then expected number of measurements.
ADAPTIVE_SINGLE_PATTERNS_ETA3 = {
    0.995: {
        2.5625: (
            (
                (1, 1, 1),
                (1, 1, 0),
                (1, 0),
                (0, 1),
                (0, 0, 1),
                (0, 0, 0, 1),
                (0, 0, 0, 0),
            ),
            2.33336203477099,
        ),
    }
}


def get_closest_accuracy(accuracy, accuracy_values):
    arr = np.fromiter(accuracy_values, dtype=float)
    return arr[np.abs(arr - accuracy).argmin()]


def _lookup(db, key, use_closest, what):
    if key not in db:
        if use_closest:
            key2 = get_closest_accuracy(key, db.keys())
            print(f"input {what} = {key}, closest = {key2}")
            key = key2
        else:
            raise ValueError(f"given {what} ({key}) is not supported, use {list(db.keys())}")
    return db[key]


def get_single_patterns(eta, accuracy, num_patterns, use_closest_accuracy=False):
    assert eta == 2
    per_acc = _lookup(SINGLE_PATTERNS, accuracy, use_closest_accuracy, "accuracy")
    if num_patterns not in per_acc:
        raise ValueError(
            f"given num_patterns ({num_patterns}) is not supported, use {list(per_acc.keys())}"
        )
    return per_acc[num_patterns][0]


def get_sum_patterns(eta, num_patterns_sum, sum_weight):
    assert eta == 2
    if sum_weight not in SUM_PATTERNS:
        raise ValueError(
            f"given sum_weight ({sum_weight}) is not supported, use {list(SUM_PATTERNS.keys())}"
        )
    per_sw = SUM_PATTERNS[sum_weight]
    if num_patterns_sum not in per_sw:
        raise ValueError(
            f"given num_patterns_sum ({num_patterns_sum}) is not supported, "
            f"use {list(per_sw.keys())}"
        )
    return per_sw[num_patterns_sum][1]


def get_restricted_single_patterns(eta, accuracy, num_patterns, use_closest_accuracy=False):
    assert eta == 3
    per_acc = _lookup(
        ADAPTIVE_SINGLE_PATTERNS_ETA3, accuracy, use_closest_accuracy, "accuracy"
    )
    if num_patterns not in per_acc:
        raise ValueError(
            f"given num_patterns ({num_patterns}) is not supported, use {list(per_acc.keys())}"
        )
    return per_acc[num_patterns][0]


def get_patterns(eta, accuracy, num_patterns, num_patterns_sum, sum_weight, use_closest_accuracy=False):
    return {
        "pattern": get_single_patterns(eta, accuracy, num_patterns, use_closest_accuracy),
        "pattern_sum": get_sum_patterns(eta, num_patterns_sum, sum_weight),
    }
