"""PyTorch port conformance: host-side code construction and seeding.

The same seeds go to the JAX package and the port; every array must be
identical (the draw sequences are copied, not approximated)."""

import numpy as np
import pytest
import torch

from sca_ldpc_tpu.codes import distance_spectrum as jax_ds
from sca_ldpc_tpu.codes.layout import CirculantLayout as JaxCirculantLayout
from sca_ldpc_tpu.codes.make_code import random_circulant_first_row as jax_first_row
from sca_ldpc_tpu.utils import make_random_state as jax_make_random_state
from sca_ldpc_tpu.utils import rng_to_jax_key
from sca_ldpc_tpu_torch.codes import (
    CirculantLayout,
    calc_ds,
    check_ds_addition_limit,
    gen_array_ds_multiplicity,
    random_circulant_first_row,
)
from sca_ldpc_tpu_torch.utils import make_random_state, rng_to_torch_generator

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1, 5, 9])
@pytest.mark.parametrize("n,w", [(128, 4), (150, 4), (499, 10)])
def test_random_circulant_first_row_matches_jax(seed, n, w):
    row = random_circulant_first_row(n, w, seed)
    ref = jax_first_row(n, w, seed)
    assert row.dtype == ref.dtype
    np.testing.assert_array_equal(row, ref)
    assert row.sum() == w


@pytest.mark.parametrize("max_mult", [1, 2])
def test_gen_array_ds_multiplicity_same_stream(max_mult):
    """Two draws from one RandomState: the port consumes the host stream
    exactly as the JAX package does."""
    rng, ref_rng = make_random_state(3), jax_make_random_state(3)
    for _ in range(2):
        a = gen_array_ds_multiplicity(200, 8, max_mult, rng)
        b = jax_ds.gen_array_ds_multiplicity(200, 8, max_mult, ref_rng)
        np.testing.assert_array_equal(a, b)
    assert rng.randint(0, 2**31 - 1) == ref_rng.randint(0, 2**31 - 1)


def test_distance_spectrum_helpers_match_jax():
    rng = np.random.RandomState(11)
    for n in (64, 101):
        bits = (rng.rand(n) < 0.1).astype(int)
        ds = calc_ds(bits)
        np.testing.assert_array_equal(ds, jax_ds.calc_ds(bits))
        for add in (0, n // 3, n - 1):
            for limit in (1, 2):
                got = check_ds_addition_limit(bits, ds, add, limit)
                ref = jax_ds.check_ds_addition_limit(bits, ds, add, limit)
                if ref is False:
                    assert got is False
                else:
                    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("with_identity", [True, False])
@pytest.mark.parametrize("n", [128, 150])
def test_circulant_layout_matches_jax(n, with_identity):
    row = random_circulant_first_row(n, 4, 5)
    lay = CirculantLayout.from_first_row(row, with_identity=with_identity)
    ref = JaxCirculantLayout.from_first_row(row, with_identity=with_identity)
    assert (lay.n, lay.shifts, lay.with_identity) == (ref.n, ref.shifts, ref.with_identity)
    assert (lay.weight, lay.n_vars) == (ref.weight, ref.n_vars)
    np.testing.assert_array_equal(lay.to_dense(), ref.to_dense())
    assert CirculantLayout.from_reference(ref) == lay


def test_make_random_state_matches_jax():
    assert make_random_state(0).randint(0, 100) == 44
    rng = make_random_state(7)
    assert make_random_state(rng) is rng
    assert make_random_state(None) is np.random.mtrand._rand
    with pytest.raises(ValueError):
        make_random_state("seed")
    a, b = make_random_state(7), jax_make_random_state(7)
    np.testing.assert_array_equal(a.randint(0, 1000, 20), b.randint(0, 1000, 20))


def test_rng_to_torch_generator_draws_like_jax_key():
    """One host draw per derived generator, as for ``rng_to_jax_key``; the
    same host state gives the same generator."""
    rng, ref_rng = make_random_state(4), jax_make_random_state(4)
    gen = rng_to_torch_generator(rng, "cpu")
    rng_to_jax_key(ref_rng)
    assert rng.randint(0, 2**31 - 1) == ref_rng.randint(0, 2**31 - 1)
    again = rng_to_torch_generator(make_random_state(4), "cpu")
    assert torch.equal(torch.rand(16, generator=gen), torch.rand(16, generator=again))
