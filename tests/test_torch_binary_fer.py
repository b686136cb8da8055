"""PyTorch port conformance: the binary FER path and the host code it
stands on, against the JAX package, on the CPU.

- ``channels.ErrorsProvider``: the host path draws the reference's exact
  ``rng.rand()`` stream (equal symbols, seed for seed); ``sample_batch``
  draws on the device from a ``torch.Generator`` and is held to
  ``tests/test_channels.py``'s frequency bounds (0.03 absolute).
- ``codes.util`` (``rep_code``, ``gf2_rank``, ``code_parameters``) and the
  random LDPC constructors: exactly equal, with ``tests/test_codes.py``'s
  golden matrices.
- ``sim.simulate_frame_error_rate``: the frame-error rate within 3 binomial
  sigma of the JAX run on the same code (the two draw different frames from
  the same seed: ``torch.Generator`` against ``jax.random``).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from sca_ldpc_tpu.channels import ErrorsProvider as JaxErrorsProvider
from sca_ldpc_tpu.codes import make_random_ldpc_parity_check_matrix as jax_random_ldpc
from sca_ldpc_tpu.codes import make_random_ldpc_parity_check_matrix_with_identity as jax_random_ldpc_identity
from sca_ldpc_tpu.codes import make_regular_ldpc_parity_check_matrix as jax_regular
from sca_ldpc_tpu.codes import util as jax_util
from sca_ldpc_tpu.sim import simulate_frame_error_rate as jax_fer
from sca_ldpc_tpu.utils import make_random_state as jax_random_state
from sca_ldpc_tpu_torch.channels import ErrorsProvider
from sca_ldpc_tpu_torch.codes import (
    make_random_ldpc_parity_check_matrix,
    make_random_ldpc_parity_check_matrix_with_identity,
    make_regular_ldpc_parity_check_matrix,
)
from sca_ldpc_tpu_torch.codes import util
from sca_ldpc_tpu_torch.ops import BinaryBPDecoder
from sca_ldpc_tpu_torch.sim import simulate_frame_error_rate
from sca_ldpc_tpu_torch.utils import make_random_state, rng_to_torch_generator

torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent.parent / "fixtures"
BINARY_FILE = str(FIXTURES / "binary_distr.txt")
QARY_FILE = str(FIXTURES / "qary_distr.txt")


@pytest.mark.parametrize("rate,error_file", [(0.05, None), (0.05, BINARY_FILE), (0.05, QARY_FILE)])
def test_host_stream_equals_jax(rate, error_file):
    ours = ErrorsProvider(rate, error_file, make_random_state(7))
    theirs = JaxErrorsProvider(rate, error_file, jax_random_state(7))
    got = [ours.get_error(i) for i in range(3000)]
    assert got == [theirs.get_error(i) for i in range(3000)]
    assert ours.rng.get_state()[2] == theirs.rng.get_state()[2]  # the same number of draws
    assert ours.get_error_rate() == theirs.get_error_rate()
    assert ours.is_qary() == theirs.is_qary() and ours.num_symbols() == theirs.num_symbols()
    np.testing.assert_array_equal(ours.position_probs(9), theirs.position_probs(9))
    if error_file != QARY_FILE:
        assert ours.get_binary_channel_probs(6) == theirs.get_binary_channel_probs(6)
    else:
        with pytest.raises(ValueError):
            ours.get_binary_channel_probs()


def test_host_frequencies():
    """tests/test_channels.py's host bounds, on the port."""
    ep = ErrorsProvider(0.05, BINARY_FILE, make_random_state(0))
    for i, expect in enumerate([0.1, 0.3, 0.05, 0.14, 0.1]):
        assert abs(sum(ep.get_error(i) for _ in range(10000)) / 10000 - expect) < 0.009


def test_sample_batch_binary_stats():
    ep = ErrorsProvider(0.05, BINARY_FILE, make_random_state(0))
    x = ep.sample_batch(rng_to_torch_generator(make_random_state(0), "cpu"), 4000, 4)
    assert x.shape == (4000, 4) and x.dtype == torch.int32
    assert set(torch.unique(x).tolist()) <= {0, 1}
    for f, expect in zip(x.double().mean(dim=0).tolist(), [0.1, 0.3, 0.05, 0.14]):
        assert abs(f - expect) < 0.03


def test_sample_batch_qary_stats():
    ep = ErrorsProvider(0.05, QARY_FILE, make_random_state(0))
    x = ep.sample_batch(rng_to_torch_generator(make_random_state(1), "cpu"), 6000, 2)
    assert set(torch.unique(x).tolist()) <= {-1, 0, 1}
    assert abs(float((x[:, 0] == -1).double().mean()) - 0.2) < 0.03
    assert abs(float((x[:, 1] == 0).double().mean()) - 0.6) < 0.03
    assert abs(float((x[:, 1] == 1).double().mean()) - 0.3) < 0.03


def test_sample_batch_uniform_rate():
    ep = ErrorsProvider(0.02, None, make_random_state(0))
    x = ep.sample_batch(rng_to_torch_generator(make_random_state(2), "cpu"), 500, 300)
    assert abs(float(x.double().mean()) - 0.02) < 0.003  # 150,000 draws: 6 sigma


def test_util_equals_jax():
    for n in (2, 5, 9):
        np.testing.assert_array_equal(util.rep_code(n), jax_util.rep_code(n))
    rng = np.random.RandomState(3)
    for shape in ((6, 10), (12, 12), (20, 9)):
        H = rng.randint(0, 2, shape)
        assert util.gf2_rank(H) == jax_util.gf2_rank(H)
        assert util.code_parameters(H) == jax_util.code_parameters(H)
    H = make_regular_ldpc_parity_check_matrix(300, 150, 3, 6, make_random_state(0))
    assert util.code_parameters(H) == jax_util.code_parameters(H)
    assert util.code_parameters(util.rep_code(7)) == (7, 1, 6)


def test_random_ldpc_golden_and_equal_to_jax():
    """tests/test_codes.py's golden matrices, and the JAX package's for more seeds."""
    got = make_random_ldpc_parity_check_matrix(10, 3, make_random_state(0))
    assert got[0].tolist() == [0, 1, 1, 0, 0, 0, 0, 0, 1, 0]
    assert got[1].tolist() == [0, 0, 1, 1, 0, 0, 0, 0, 0, 1]
    assert got[9].tolist() == [1, 1, 0, 0, 0, 0, 0, 1, 0, 0]
    got = make_random_ldpc_parity_check_matrix_with_identity(10, 3, make_random_state(0))
    assert got.shape == (10, 20)
    assert got[0].tolist() == [0, 1, 1, 0, 0, 0, 0, 0, 1, 0] + [1] + [0] * 9
    assert (got[:, 10:] == np.identity(10, dtype=int)).all()
    for seed in (1, 2, 5):
        np.testing.assert_array_equal(make_random_ldpc_parity_check_matrix(40, 4, seed), jax_random_ldpc(40, 4, seed))
        np.testing.assert_array_equal(make_random_ldpc_parity_check_matrix_with_identity(40, 4, seed),
                                      jax_random_ldpc_identity(40, 4, seed))


def test_rep_code_decodes():
    """tests/test_binary_bp.py's repetition code: 100 of 100 at 0.05."""
    H = util.rep_code(20)
    dec = BinaryBPDecoder(H, max_iter=20, error_rate=0.05, device="cpu")
    ep = ErrorsProvider(0.05, None, make_random_state(4))
    errors = torch.stack([torch.tensor([ep.get_error(j) for j in range(20)]) for _ in range(100)])
    errors[errors.sum(dim=1) > 9] = 0  # a rep code corrects fewer than half flipped
    syn = (torch.as_tensor(H) @ errors.T).T % 2
    assert bool((dec.decode_syndrome(syn) == errors).all())


@pytest.mark.parametrize("rate,runs", [(0.02, 300), (0.07, 300)])  # FER 0 and about 0.25
def test_fer_within_three_sigma_of_jax(rate, runs):
    """The reference's regular_ldpc_code drive: a (3, 6)-regular code of
    300 columns, the same seeds through both packages."""
    H = make_regular_ldpc_parity_check_matrix(300, 150, 3, 6, make_random_state(0))
    np.testing.assert_array_equal(H, jax_regular(300, 150, 3, 6, jax_random_state(0)))
    rng = make_random_state(1)
    ok = simulate_frame_error_rate(H, ErrorsProvider(rate, None, rng), runs, rng, max_iter=50, batch_size=150,
                                   device="cpu")
    jrng = jax_random_state(1)
    ok_j = jax_fer(H, JaxErrorsProvider(rate, None, jrng), runs, jrng, max_iter=50, batch_size=150)
    fer, fer_j = 1 - ok / runs, 1 - ok_j / runs
    pooled = max((fer + fer_j) / 2, 1.0 / runs)
    sigma = np.sqrt(pooled * (1 - pooled) * 2 / runs)
    assert abs(fer - fer_j) <= 3 * sigma, (fer, fer_j, sigma)
    assert 0 <= ok <= runs


def test_fer_defaults_and_device():
    """max_iter defaults to n and the batch to min(runs, 1024); the default
    device needs a card and raises without one."""
    H = make_regular_ldpc_parity_check_matrix(60, 30, 3, 6, make_random_state(0))
    rng = make_random_state(3)
    assert simulate_frame_error_rate(H, ErrorsProvider(0.0, None, rng), 7, rng, device="cpu") == 7
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            simulate_frame_error_rate(H, ErrorsProvider(0.01, None, rng), 4, rng)
