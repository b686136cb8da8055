"""PyTorch port conformance: the general binary BP decoder
(``sca_ldpc_tpu_torch.ops.binary_bp``) against the JAX package's, on the
same numpy inputs, on the CPU.  Decisions, convergence flags and the
iteration count must be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sca_ldpc_tpu.codes import make_regular_ldpc_parity_check_matrix
from sca_ldpc_tpu.codes.layout import CirculantLayout as JaxCirculantLayout
from sca_ldpc_tpu.codes.layout import CodeLayout as JaxCodeLayout
from sca_ldpc_tpu.codes.util import rep_code
from sca_ldpc_tpu.ops.binary_bp import BinaryBPDecoder as JaxBinaryBPDecoder
from sca_ldpc_tpu.ops.binary_bp import _bp_decode_syndrome as jax_bp_decode_syndrome
from sca_ldpc_tpu_torch.codes import CirculantLayout, CodeLayout, random_circulant_first_row
from sca_ldpc_tpu_torch.ops import CirculantBPDecoder
from sca_ldpc_tpu_torch.ops.binary_bp import BinaryBPDecoder, _bp_decode_syndrome
from sca_ldpc_tpu_torch.utils import make_random_state

torch.set_num_threads(1)

METHODS = ["product_sum", "min_sum"]


def _circulant_h(n, w=4, seed=5):
    return JaxCirculantLayout.from_first_row(random_circulant_first_row(n, w, seed), with_identity=True).to_dense()


def _regular_h():
    return make_regular_ldpc_parity_check_matrix(300, 150, 3, 6, make_random_state(0))


def _frames(n, b, seed, max_weight=3):
    rng = np.random.RandomState(seed)
    err = np.zeros((b, n), np.int32)
    for i in range(b):
        err[i, rng.choice(n, 1 + i % max_weight, replace=False)] = 1
    return err


def _both(h, syn, prior, max_iter, method):
    lay = CodeLayout.from_h(h)
    jlay = JaxCodeLayout.from_h(h)
    for name in ("chk_var", "chk_mask", "var_flat", "var_mask"):
        np.testing.assert_array_equal(getattr(lay, name), getattr(jlay, name))
    out = _bp_decode_syndrome(torch.as_tensor(lay.chk_var), torch.as_tensor(lay.chk_mask),
                              torch.as_tensor(lay.var_flat), torch.as_tensor(lay.var_mask),
                              torch.as_tensor(prior), torch.as_tensor(syn), max_iter, method, lay.dc)
    ref = jax_bp_decode_syndrome(jnp.asarray(jlay.chk_var), jnp.asarray(jlay.chk_mask), jnp.asarray(jlay.var_flat),
                                 jnp.asarray(jlay.var_mask), jnp.asarray(prior), jnp.asarray(syn), max_iter, method,
                                 jlay.dc)
    return out, ref


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("code", ["circulant128", "circulant150", "regular300"])
def test_bp_decode_syndrome_matches_jax(code, method):
    """Random layouts at the small shapes of the JAX kernel tests; per-frame
    priors (a [B, N] prior) with a few noisier positions."""
    h = {"circulant128": lambda: _circulant_h(128), "circulant150": lambda: _circulant_h(150, seed=6),
         "regular300": _regular_h}[code]()
    b, n = 8, h.shape[1]
    err = _frames(n, b, 3)
    syn = (err @ h.T) % 2
    rng = np.random.RandomState(4)
    p = np.clip(rng.uniform(0.005, 0.03, (b, n)), 1e-6, 0.5).astype(np.float32)
    prior = np.log((1 - p) / p).astype(np.float32)
    (e, conv, it), (ej, cj, ij) = _both(h, syn, prior, 40, method)
    np.testing.assert_array_equal(e.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(cj))
    assert int(it) == int(ij)
    assert conv.all() and (e.numpy() == err).all()
    assert e.dtype == torch.int32 and conv.dtype == torch.bool


@pytest.mark.parametrize("method", METHODS)
def test_unconverged_frames_match_jax(method):
    """Frames with too many errors run every iteration and keep their last
    estimate; equal to the JAX decode, its it == max_iter."""
    h = _circulant_h(128)
    n = h.shape[1]
    rng = np.random.RandomState(8)
    err = (rng.rand(6, n) < 0.08).astype(np.int32)
    syn = (err @ h.T) % 2
    prior = np.full(n, np.log(0.99 / 0.01), np.float32)
    (e, conv, it), (ej, cj, ij) = _both(h, syn, prior, 12, method)
    np.testing.assert_array_equal(e.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(cj))
    assert int(it) == int(ij) == 12
    assert not conv.all()


@pytest.mark.parametrize("max_iter", [0, 1])
def test_zero_and_one_iteration(max_iter):
    h = _regular_h()
    n = h.shape[1]
    err = _frames(n, 4, 9)
    prior = np.full(n, np.log(0.99 / 0.01), np.float32)
    prior[:5] = -1.0  # a few positions the prior already calls errors
    (e, conv, it), (ej, cj, ij) = _both(h, (err @ h.T) % 2, prior, max_iter, "product_sum")
    np.testing.assert_array_equal(e.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(cj))
    assert int(it) == int(ij) == max_iter


@pytest.mark.parametrize("method", METHODS)
def test_rep_code_100_of_100(method):
    """The reference's doctest configuration (decode.py:139-149): the
    length-13 repetition code at error rate 0.05 decodes 100 of 100 frames,
    and every decision equals the JAX decoder's."""
    h = rep_code(13)
    rng = np.random.RandomState(0)
    err = (rng.rand(100, 13) < 0.05).astype(np.int32)
    syn = (err @ h.T) % 2
    dec = BinaryBPDecoder(h, max_iter=13, method=method, error_rate=0.05, device="cpu")
    e, conv, it = dec.decode_syndrome(syn, return_aux=True)
    ej, cj, ij = JaxBinaryBPDecoder(h, max_iter=13, method=method, error_rate=0.05).decode_syndrome(
        syn, return_aux=True)
    np.testing.assert_array_equal(e.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(cj))
    assert int(it) == int(ij)
    assert int((e.numpy() == err).all(axis=-1).sum()) == 100


@pytest.mark.parametrize("method", METHODS)
def test_general_equals_circulant(method):
    """test_binary_bp.py's check in the port: the general decoder and the
    circulant decoder agree on the same [circulant | I] code."""
    rng = make_random_state(7)
    n, w = 64, 5
    lay = CirculantLayout.from_first_row(random_circulant_first_row(n, w, rng), with_identity=True)
    h = lay.to_dense()
    errors = np.zeros((8, 2 * n), dtype=np.int32)
    for i in range(8):
        errors[i, rng.choice(2 * n, 2, replace=False)] = 1
    syn = (errors @ h.T) % 2
    probs = np.full(2 * n, 0.02, np.float32)
    out_g = BinaryBPDecoder(h, 40, method, channel_probs=probs, device="cpu").decode_syndrome(syn)
    out_f = CirculantBPDecoder(lay, 40, method, device="cpu").decode_syndrome(syn, probs)
    np.testing.assert_array_equal(out_g.numpy(), errors)
    np.testing.assert_array_equal(out_f.numpy(), errors)


def test_decode_received_and_channel_probs_match_jax():
    """Received-vector mode, a call-time channel_probs (float64, converted
    as the JAX decoder converts it) and a single squeezed frame."""
    h = _regular_h()
    n = h.shape[1]
    rng = np.random.RandomState(11)
    z = (rng.rand(5, n) < 0.01).astype(np.int32)
    probs = rng.uniform(0.005, 0.02, n)
    dec = BinaryBPDecoder(h, 30, device="cpu")
    jdec = JaxBinaryBPDecoder(h, 30)
    with pytest.raises(ValueError, match="channel probabilities"):
        dec.decode_syndrome(np.zeros(h.shape[0], np.int32))
    out = dec.decode_received(z, probs)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jdec.decode_received(z, probs)))
    one = dec.decode_received(z[0], probs)
    assert one.shape == (n,)
    np.testing.assert_array_equal(one.numpy(), out.numpy()[0])
    e, conv, it = dec.decode_syndrome((z[1] @ h.T) % 2, probs, return_aux=True)
    assert e.shape == (n,) and conv.shape == ()


def test_decoder_defaults_to_the_card():
    dec = BinaryBPDecoder(rep_code(5), error_rate=0.1, device="cpu")
    assert dec.device.type == "cpu"
    import inspect

    assert inspect.signature(BinaryBPDecoder).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            BinaryBPDecoder(rep_code(5), error_rate=0.1)
