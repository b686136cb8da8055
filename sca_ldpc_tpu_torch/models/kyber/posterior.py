"""Bayesian posterior computation from oracle measurements.

Reference: simulate/max_likelihood.py.  The scalar API is kept for parity;
:func:`posteriors_from_hard` is the vectorized path that converts a whole
measurement matrix into per-coefficient symbol distributions in one shot —
these are the soft inputs to the q-ary decoders.  A copy of the JAX
package's ``models/kyber/posterior.py`` (host NumPy).
"""

import itertools as it

import numpy as np


class SimpleOracle:
    """Uniform-accuracy oracle (max_likelihood.py:9-18)."""

    def __init__(self, p):
        self.p = p

    def prob_of(self, expected, actual, pos):
        return self.p if actual == expected else 1 - self.p


class FalsePositiveNegativePositionalOracle:
    """Per-position (false-positive, false-negative) rates
    (max_likelihood.py:21-38)."""

    def __init__(self, p_arr):
        self.p_arr = p_arr

    def prob_of(self, expected, actual, pos):
        pr_fp, pr_fn = self.p_arr[pos]
        if expected == 0:
            return pr_fp if actual == 1 else 1 - pr_fp
        return pr_fn if actual == 0 else 1 - pr_fn


def pr_cond_yx(y, x, pr_oracle):
    """Pr[Y = y | X = x] for a measurement vector (max_likelihood.py:41-47)."""
    res = 1.0
    for i in range(len(x)):
        res *= pr_oracle.prob_of(x[i], y[i], i)
    return res


def pr_y(y, pr_oracle, secret_range_func, coding, distrib_secret, sum_weight):
    res = 0.0
    for s in secret_range_func(sum_weight):
        res += distrib_secret[s] * pr_cond_yx(y, coding[s], pr_oracle)
    return res


def pr_cond_xy(s, y, pr_oracle, secret_range_func, coding, distrib_secret, sum_weight, pr_y_saved=None):
    if pr_y_saved is None:
        pr_y_saved = pr_y(y, pr_oracle, secret_range_func, coding, distrib_secret, sum_weight)
    return pr_cond_yx(y, coding[s], pr_oracle) * distrib_secret[s] / pr_y_saved


def pr_of_y_from_prediction(pred_y, y):
    res = 1.0
    for p, yval in zip(pred_y, y):
        res *= p if yval else 1 - p
    return res


def s_distribution_from_hard_y(y, pr_oracle, secret_range_func, coding, distrib_secret, sum_weight):
    """Posterior over symbols given one hard measurement vector
    (max_likelihood.py:87-105)."""
    pr_y_saved = pr_y(y, pr_oracle, secret_range_func, coding, distrib_secret, sum_weight)
    return [
        pr_cond_xy(s, y, pr_oracle, secret_range_func, coding, distrib_secret, sum_weight, pr_y_saved)
        for s in secret_range_func(sum_weight)
    ]


def s_distribution_from_prediction_y(pred_y, pr_oracle, secret_range_func, coding, distrib_secret, sum_weight):
    """Posterior given soft per-measurement predictions
    (max_likelihood.py:178-197)."""
    symbols = list(secret_range_func(sum_weight))
    distr = [0.0] * len(symbols)
    for y in it.product(range(2), repeat=len(coding[symbols[0]])):
        pr_y_saved = pr_y(y, pr_oracle, secret_range_func, coding, distrib_secret, sum_weight)
        w = pr_of_y_from_prediction(pred_y, y)
        for i, s in enumerate(symbols):
            distr[i] += (
                pr_cond_xy(s, y, pr_oracle, secret_range_func, coding, distrib_secret, sum_weight, pr_y_saved)
                * w
            )
    return distr


# -- adaptive (tree-coded) variants (max_likelihood.py:109-175) --------------


def pr_cond_yx_adaptive(y, s, p, coding_tree):
    res = 1.0
    node = coding_tree
    for y_val in y:
        if s < node.value:
            res *= p if y_val == 1 else 1 - p
            node = node.left if y_val == 1 else node.right
        else:
            res *= 1 - p if y_val == 1 else p
            node = node.left if y_val == 1 else node.right
    return res


def pr_y_adaptive(y, p, secret_range_func, coding_tree, distrib_secret, sum_weight):
    res = 0.0
    for s in secret_range_func(sum_weight):
        res += distrib_secret[s] * pr_cond_yx_adaptive(y, s, p, coding_tree)
    return res


def pr_cond_xy_adaptive(s, y, p, secret_range_func, coding_tree, distrib_secret, sum_weight, pr_y_saved=None):
    if pr_y_saved is None:
        pr_y_saved = pr_y_adaptive(y, p, secret_range_func, coding_tree, distrib_secret, sum_weight)
    return pr_cond_yx_adaptive(y, s, p, coding_tree) * distrib_secret[s] / pr_y_saved


def s_distribution_from_hard_y_adaptive(y, p, secret_range_func, coding_tree, distrib_secret, sum_weight):
    return [
        pr_cond_xy_adaptive(s, y, p, secret_range_func, coding_tree, distrib_secret, sum_weight, None)
        for s in secret_range_func(sum_weight)
    ]


# -- vectorized batch path ---------------------------------------------------


def normalize_fp_fn(fp, fn, m):
    """Broadcast scalar-or-sequence false-positive / false-negative rates
    to a [m, 2] per-position array (the FalsePositiveNegativePositionalOracle
    layout, max_likelihood.py:21-38)."""
    fp = np.broadcast_to(np.asarray(fp, np.float64), (m,))
    fn = np.broadcast_to(np.asarray(fn, np.float64), (m,))
    return np.stack([fp, fn], axis=1)


def posteriors_from_hard_fpfn(measurements, coding, distrib_secret, p_arr):
    """Vectorized posterior under per-position asymmetric oracle noise.

    ``p_arr``: [m, 2] per-position (false-positive, false-negative) rates —
    the vectorized counterpart of FalsePositiveNegativePositionalOracle
    (the reference defines that oracle, max_likelihood.py:21-38, but its
    kyber pipeline only ever instantiates the uniform SimpleOracle).
    Positionally exact vs the scalar path: agrees with
    s_distribution_from_hard_y(FalsePositiveNegativePositionalOracle(p_arr))
    (tests/test_kyber.py).
    """
    Y = np.asarray(measurements)
    symbols = sorted(coding.keys())
    C = np.array([coding[s] for s in symbols])  # [S, m]
    prior = np.array([distrib_secret[s] for s in symbols])  # [S]
    p_arr = np.asarray(p_arr, np.float64)
    fp, fn = p_arr[:, 0], p_arr[:, 1]
    # P(measure 1 | codeword bit): bit 0 -> fp, bit 1 -> 1 - fn
    p1 = np.where(C == 1, 1.0 - fn[None, :], fp[None, :])  # [S, m]
    lik = np.where(Y[:, None, :] == 1, p1[None], 1.0 - p1[None]).prod(axis=2)
    post = lik * prior[None, :]
    return post / post.sum(axis=1, keepdims=True)


def posteriors_from_hard(measurements, coding, distrib_secret, accuracy):
    """Vectorized posterior for a whole measurement matrix.

    ``measurements``: [n, m] 0/1 array (m oracle answers per coefficient);
    ``coding``: symbol -> length-m codeword dict; ``distrib_secret``: symbol
    -> prior; ``accuracy``: uniform oracle accuracy p.

    Returns [n, n_symbols] posteriors ordered by ascending symbol.
    """
    Y = np.asarray(measurements)
    n, m = Y.shape
    symbols = sorted(coding.keys())
    C = np.array([coding[s] for s in symbols])  # [S, m]
    prior = np.array([distrib_secret[s] for s in symbols])  # [S]
    # matches[i, s] = number of agreeing measurement bits
    agree = (Y[:, None, :] == C[None, :, :]).sum(axis=2)  # [n, S]
    lik = (accuracy**agree) * ((1 - accuracy) ** (m - agree))
    post = lik * prior[None, :]
    return post / post.sum(axis=1, keepdims=True)
