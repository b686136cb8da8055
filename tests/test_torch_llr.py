"""PyTorch port conformance: ``channels.probs_to_llr(probs, axis, validate)``
against the JAX package's function on the CPU: any axis, and the row-sum
check (``ValueError`` unless every sum along ``axis`` is 1 +- 0.001)."""

import numpy as np
import pytest
import torch

from sca_ldpc_tpu.channels import probs_to_llr as jax_probs_to_llr
from sca_ldpc_tpu_torch.channels import probs_to_llr


def _probs(axis, shape=(4, 5, 3), zero=True):
    rng = np.random.RandomState(7)
    p = rng.dirichlet(np.ones(shape[axis]), size=[s for i, s in enumerate(shape) if i != axis % len(shape)])
    p = np.moveaxis(p, -1, axis).astype(np.float32)
    if zero:  # a zero-probability symbol maps to +inf (its row no longer sums to 1)
        p[(0,) * len(shape)] = 0.0
    return p


@pytest.mark.parametrize("axis", [-1, 0, 1, -2])
def test_probs_to_llr_axis_equals_jax(axis):
    p = _probs(axis)
    ref = np.asarray(jax_probs_to_llr(p, axis=axis))
    out = probs_to_llr(torch.from_numpy(p), axis=axis).numpy()
    assert np.isinf(out).sum() >= 1
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    assert (np.isinf(out) == np.isinf(ref)).all()
    if axis in (-1, 1):  # the default axis is the last
        q = p[:, 0] if axis == 1 else p
        np.testing.assert_allclose(probs_to_llr(q).numpy(), np.asarray(jax_probs_to_llr(q)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("axis", [-1, 0])
def test_probs_to_llr_validate_equals_jax(axis):
    p = _probs(axis, (3, 3), zero=False)
    # rows that sum to 1 pass both, with validate on
    np.testing.assert_allclose(probs_to_llr(p, axis=axis, validate=True).numpy(),
                               np.asarray(jax_probs_to_llr(p, axis=axis, validate=True)), rtol=1e-6, atol=1e-6)
    bad = p.copy()
    idx = (1, 2) if axis == -1 else (2, 1)
    bad[idx] += 0.01  # one row (column, along axis 0) sums to 1.01
    for fn in (jax_probs_to_llr, probs_to_llr):
        with pytest.raises(ValueError, match=r"must sum to 1 \(\+-0.001\)"):
            fn(bad, axis=axis, validate=True)
    # without validation neither checks
    np.testing.assert_allclose(probs_to_llr(bad, axis=axis).numpy(), np.asarray(jax_probs_to_llr(bad, axis=axis)),
                               rtol=1e-6, atol=1e-6)
    # within the tolerance both accept
    near = p.copy()
    near[idx] += 0.0005
    probs_to_llr(near, axis=axis, validate=True)
    jax_probs_to_llr(near, axis=axis, validate=True)
