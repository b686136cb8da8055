"""Helpers the drivers share."""

import numpy as np


def pick(seed, population, k, salt):
    """``k`` distinct items of ``population`` (all of them if fewer), drawn
    from the run's seed: the sample of the window's answers that the
    reference re-computes."""
    population = list(population)
    if len(population) <= k:
        return population
    rng = np.random.RandomState([salt, seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF])
    idx = sorted(rng.choice(len(population), size=k, replace=False).tolist())
    return [population[i] for i in idx]


def check(value, limit):
    """A number compared with its limit, as the result line carries it."""
    return {"value": value, "limit": limit}
