"""PyTorch port conformance: the slice as a user calls it — the decoder API
and the FER loop on the CPU — against the JAX package, and the port's
independence from JAX at run time."""

import inspect
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from sca_ldpc_tpu.codes.layout import CirculantLayout as JaxCirculantLayout
from sca_ldpc_tpu.ops.circulant_bp import CirculantBPDecoder as JaxDecoder
from sca_ldpc_tpu_torch.codes import CirculantLayout, random_circulant_first_row
from sca_ldpc_tpu_torch.ops import CirculantBPDecoder
from sca_ldpc_tpu_torch.parallel import fer_simulation, make_fer_step
from sca_ldpc_tpu_torch.utils import make_random_state, rng_to_torch_generator

torch.set_num_threads(1)

METHODS = ["product_sum", "min_sum"]
ROOT = Path(__file__).resolve().parent.parent


def _layouts(n, seed=5):
    row = random_circulant_first_row(n, 4, seed)
    jax_lay = JaxCirculantLayout.from_first_row(row, with_identity=True)
    return CirculantLayout.from_reference(jax_lay), jax_lay


def _received(n, seed, b=8, rate=0.01):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, 2 * n) < rate).astype(np.int32)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", [128, 150])
def test_decode_syndrome_matches_jax_decoder(n, method):
    """Per-frame channel probabilities, some at 1e-31 (clipped to 1e-30, an
    LLR of about 69, above the +-60 message clip) and some at 0.5."""
    lay, jax_lay = _layouts(n)
    rng = np.random.RandomState(3)
    err = _received(n, 4, b=16, rate=0.02)
    syn = (err @ lay.to_dense().T) % 2
    probs = np.full((16, 2 * n), 0.02, np.float32)
    probs[:, :8] = 1e-31
    probs[:, 8:12] = 0.5
    probs[:, n:] *= rng.uniform(0.5, 1.5, (16, n)).astype(np.float32)
    e, conv, it = CirculantBPDecoder(lay, 20, method, device="cpu").decode_syndrome(syn, probs, return_aux=True)
    ej, cj, ij = JaxDecoder(jax_lay, 20, method).decode_syndrome(syn, probs, return_aux=True)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(e.numpy(), np.asarray(ej))
    assert int(it) == int(ij)
    assert e.dtype == torch.int32 and conv.dtype == torch.bool


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", [128, 150])
def test_decode_received_matches_jax_decoder(n, method):
    lay, jax_lay = _layouts(n)
    z = _received(n, 6)
    probs = np.full(2 * n, 0.01, np.float32)
    out = CirculantBPDecoder(lay, 20, method, device="cpu").decode_received(z, probs)
    ref = JaxDecoder(jax_lay, 20, method).decode_received(z, probs)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    one = CirculantBPDecoder(lay, 20, method, device="cpu").decode_received(z[0], probs)
    np.testing.assert_array_equal(one.numpy(), np.asarray(ref)[0])


def test_decode_syndrome_single_frame_squeezes():
    lay, jax_lay = _layouts(128)
    err = _received(128, 9, b=1)[0]
    syn = (lay.to_dense() @ err) % 2
    probs = np.full(256, 0.01, np.float32)
    e, conv, it = CirculantBPDecoder(lay, 20, device="cpu").decode_syndrome(syn, probs, return_aux=True)
    ej, cj, ij = JaxDecoder(jax_lay, 20).decode_syndrome(syn, probs, return_aux=True)
    assert e.shape == (256,) and conv.shape == ()
    np.testing.assert_array_equal(e.numpy(), np.asarray(ej))
    assert bool(conv) == bool(cj) and int(it) == int(ij)


def test_fer_simulation_counts_frames_on_cpu():
    lay, _ = _layouts(150)
    probs = np.full(lay.n_vars, 0.002, np.float32)
    gen = rng_to_torch_generator(make_random_state(0), "cpu")
    successes, frames = fer_simulation(lay, probs, 20, gen, "cpu", batch=8, max_iter=20)
    assert frames == 20
    assert 18 <= successes <= 20
    again = fer_simulation(lay, probs, 20, rng_to_torch_generator(make_random_state(0), "cpu"), "cpu",
                           batch=8, max_iter=20)
    assert again == (successes, frames)


def test_fer_step_matches_jax_decode_of_the_same_errors():
    """The step's errors, decoded by the JAX package: the same number of
    successes and converged frames."""
    lay, jax_lay = _layouts(128)
    probs = np.full(lay.n_vars, 0.03, np.float32)
    step = make_fer_step(lay, probs, "cpu", max_iter=20)
    gen = rng_to_torch_generator(make_random_state(1), "cpu")
    state = gen.get_state()
    ok, conv, _ = step(gen, 32)
    gen.set_state(state)
    errors = (torch.rand((32, lay.n_vars), generator=gen) < float(probs[0])).numpy().astype(np.int32)
    syn = (errors @ lay.to_dense().T) % 2
    e, cj, _ = JaxDecoder(jax_lay, 20).decode_syndrome(syn, probs, return_aux=True)
    assert int(ok) == int((np.asarray(e) == errors).all(axis=-1).sum())
    assert int(conv) == int(np.asarray(cj).sum())


@pytest.mark.parametrize("backend", ["fused", "lean"])
def test_fer_step_returns_the_jax_steps_three_values(backend):
    """The JAX step (its XLA branch on a one-device mesh: the kernel branch
    has no interpret switch) and the port's step on the same small code both
    return (successes, converged, iters), scalars of integer kinds; the
    port's iters is the -1 that the JAX step's kernel branch returns."""
    import jax

    from sca_ldpc_tpu.parallel import make_mesh
    from sca_ldpc_tpu.parallel.fer import make_sharded_fer_step

    lay, jax_lay = _layouts(128)
    probs = np.full(lay.n_vars, 0.01, np.float32)
    mesh = make_mesh(data=1, model=1, devices=[jax.devices()[0]])
    ref = make_sharded_fer_step(jax_lay, probs, mesh, max_iter=20)(jax.random.PRNGKey(0), 16)
    gen = rng_to_torch_generator(make_random_state(1), "cpu")
    out = make_fer_step(lay, probs, "cpu", max_iter=20, backend=backend)(gen, 16)
    assert len(ref) == len(out) == 3
    for r, o in zip(ref, out):
        assert np.asarray(r).shape == () and isinstance(o, torch.Tensor) and o.shape == () and o.device.type == "cpu"
        assert np.issubdtype(np.asarray(r).dtype, np.integer) and not o.dtype.is_floating_point
    successes, converged, iters = out
    assert 14 <= int(successes) <= 16 and int(successes) <= int(converged) <= 16
    assert 14 <= int(ref[0]) <= 16 and 1 <= int(ref[2]) <= 20
    assert iters.dtype == torch.int32 and int(iters) == -1 and np.asarray(ref[2]).dtype == np.int32


def test_fer_step_rejects_unsupported_inputs():
    lay, _ = _layouts(128)
    probs = np.full(lay.n_vars, 0.01, np.float32)
    probs[0] = 0.02
    with pytest.raises(ValueError):
        make_fer_step(lay, probs, "cpu")
    no_identity = CirculantLayout(n=lay.n, shifts=lay.shifts, with_identity=False)
    with pytest.raises(ValueError):
        make_fer_step(no_identity, np.full(lay.n, 0.01, np.float32), "cpu")


ENTRY_POINTS = [
    "ops.circulant_bp:CirculantBPDecoder",
    "ops.qary:QaryDecoder",
    "ops.qary_special:QarySpecialDecoder",
    "sim.fer:simulate_frame_error_rate_qary",
    "models.kyber.pipeline:get_decoder",
    "models.kyber.pipeline:simulate_kyber_attack",
    "models.kyber.pipeline:simulate_kyber_attack_adaptive",
    "ops.binary_bp:BinaryBPDecoder",
    "models.hqc.attack:simulate_hqc_idealized_oracle",
    "models.hqc.attack:MaskedCirculantCheckDecoder",
]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_points_default_to_the_card(entry):
    """The port runs on the card unless the caller asks for the CPU."""
    import importlib

    module, name = entry.split(":")
    fn = getattr(importlib.import_module(f"sca_ldpc_tpu_torch.{module}"), name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_never_falls_back_to_the_cpu():
    """With no device given the decoder puts its tensors on the card: without
    one it raises there instead of decoding on the CPU."""
    lay, _ = _layouts(128)
    z = _received(128, 6)
    probs = np.full(256, 0.01, np.float32)
    dec = CirculantBPDecoder(lay, 20)
    assert dec.device.type == "cuda"
    if torch.cuda.is_available():
        assert dec.decode_received(z, probs).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            dec.decode_received(z, probs)


def test_port_runs_without_jax():
    """A process where ``import jax`` fails imports every module of the port
    and decodes on the CPU."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import sca_ldpc_tpu_torch
        from sca_ldpc_tpu_torch.codes import CirculantLayout, random_circulant_first_row
        from sca_ldpc_tpu_torch.ops import CirculantBPDecoder
        from sca_ldpc_tpu_torch.ops.kernels import _build, circulant_cuda
        from sca_ldpc_tpu_torch.parallel import fer_simulation
        from sca_ldpc_tpu_torch.utils import make_random_state, rng_to_torch_generator
        lay = CirculantLayout.from_first_row(random_circulant_first_row(128, 4, 5), True)
        err = np.zeros((2, 256), np.int32)
        err[0, 3] = err[1, 200] = 1
        e = CirculantBPDecoder(lay, 20, device="cpu").decode_syndrome((err @ lay.to_dense().T) % 2,
                                                       np.full(256, 0.01, np.float32))
        assert (e.numpy() == err).all()
        gen = rng_to_torch_generator(make_random_state(0), "cpu")
        assert fer_simulation(lay, np.full(256, 0.001, np.float32), 4, gen, "cpu")[1] == 4
        leaked = [m for m in sys.modules if m == "sca_ldpc_tpu" or m.startswith("sca_ldpc_tpu.")
                  or (m.startswith("jax") and sys.modules[m] is not None)]
        assert not leaked, leaked
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_hqc_modules_run_without_jax_or_pandas():
    """A process where ``import jax`` and ``import pandas`` fail imports the
    port's HQC attack and its decoders and decodes on the CPU; neither the
    JAX package nor pandas is loaded."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["pandas"] = None
        import numpy as np
        import torch
        import sca_ldpc_tpu_torch.models.hqc
        from sca_ldpc_tpu_torch.models.hqc import Hqc128, HqcSimulationParams, HqcSimulationTracking
        from sca_ldpc_tpu_torch.models.hqc.attack import MaskedCirculantCheckDecoder, add_check
        from sca_ldpc_tpu_torch.models.hqc.oracle_fast import FastCiphertextState
        from sca_ldpc_tpu_torch.ops.binary_bp import BinaryBPDecoder
        from sca_ldpc_tpu_torch.ops.kernels import multi_circulant_bp_cuda
        params = HqcSimulationParams(Hqc128, None, None, None, WEIGHT=3, N_OVERRIDE=20)
        dec = MaskedCirculantCheckDecoder(params, device="cpu")
        checks = []
        for bit in range(20):
            add_check(dec, [0, 3, 7], checks, None, bit, bit in (4, 11), 1.0)
        dec.decode(HqcSimulationTracking(params), checks, [4])
        h = np.eye(4, 5, dtype=int) + np.eye(4, 5, 1, dtype=int)
        assert BinaryBPDecoder(h, 5, error_rate=0.1, device="cpu").decode_syndrome(np.zeros(4, int)).sum() == 0
        leaked = [m for m in sys.modules if m == "sca_ldpc_tpu" or m.startswith("sca_ldpc_tpu.")
                  or (m.split(".")[0] in ("jax", "pandas") and sys.modules[m] is not None)]
        assert not leaked, leaked
        print("ok")
        """
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
