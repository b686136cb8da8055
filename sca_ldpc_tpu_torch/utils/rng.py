"""Deterministic randomness plumbing.

Host-side code construction keeps a ``numpy.random.RandomState`` so that fixed
seeds reproduce the reference's golden matrices exactly (reference:
simulate/utils.py:14-42).  Device-side sampling uses a ``torch.Generator``
seeded from the same host state via :func:`rng_to_torch_generator`.
"""

import numbers

import numpy as np
import torch


def make_random_state(seed) -> np.random.RandomState:
    """Turn a seed into a ``np.random.RandomState`` instance.

    - ``None`` (or the ``np.random`` module): the global singleton state.
    - ``int``: a fresh deterministic state.
    - an existing ``RandomState``: passed through unchanged.

    >>> rng = make_random_state(0)
    >>> rng.randint(0, 100)
    44
    >>> rng = make_random_state(rng)
    >>> rng.randint(0, 100)
    47
    """
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"{seed!r} cannot be used to seed a numpy.random.RandomState instance")


def rng_to_torch_generator(rng, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded deterministically from a
    host RNG/seed.

    The host RandomState stream is advanced by exactly one ``randint`` draw
    (the same draw ``rng_to_jax_key`` makes), so repeated derivations from
    the same state give independent generators.
    """
    rng = make_random_state(rng)
    seed = int(rng.randint(0, 2**31 - 1))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
