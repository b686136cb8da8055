"""PyTorch port conformance: the Kyber two-alphabet decoder and the Kyber-768
attack pipeline on the CPU, against the JAX package.

Inputs are made with numpy from a seed and handed to both packages.  The
host modules (secrets, pattern databases, posteriors, the adaptive tree) are
held exactly; decoders are held on hard decisions with no tolerance (the
plain version sums a B-variable's DV slots in the JAX package's order, which
``test_xla_sums_dv_slots_left_to_right`` records); attack results are held
key for key.  The Pallas kernels run in interpret mode, as
tests/test_pallas_kernel.py runs them.
"""

import functools
from dataclasses import asdict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from qary_reference import ref_special_min_sum
from sca_ldpc_tpu.channels import llr as jllr
from sca_ldpc_tpu.models import kyber as jkyber
from sca_ldpc_tpu.models.kyber import adaptive as jadaptive
from sca_ldpc_tpu.models.kyber import patterns as jpatterns
from sca_ldpc_tpu.models.kyber import pipeline as jpipeline
from sca_ldpc_tpu.models.kyber import posterior as jposterior
from sca_ldpc_tpu.ops import QarySpecialDecoder as JaxQarySpecialDecoder
from sca_ldpc_tpu.ops import minplus as jminplus
from sca_ldpc_tpu.ops.kernels.qary_pallas import qary_special_min_sum_fused
from sca_ldpc_tpu_torch.models import kyber
from sca_ldpc_tpu_torch.models.kyber import adaptive, patterns, pipeline, posterior
from sca_ldpc_tpu_torch.ops import QarySpecialDecoder, get_decoder_by_name
from sca_ldpc_tpu_torch.ops.kernels.qary_cuda import qary_special_min_sum_fused_cuda
from sca_ldpc_tpu_torch.ops.qary_special import special_index_arrays
from sca_ldpc_tpu_torch.utils import make_random_state

torch.set_num_threads(1)


# ---------------------------------------------------------------- host modules


@pytest.mark.parametrize("eta", [2, 3])
def test_secrets_match_jax(eta):
    for sw in (1, 6):
        assert kyber.secret_distribution(sw, eta=eta) == jkyber.secret_distribution(sw, eta=eta)
    ours = kyber.sample_secret_coefs(5000, eta=eta, rng=make_random_state(3))
    assert ours == jkyber.sample_secret_coefs(5000, eta=eta, rng=make_random_state(3))
    assert min(ours) == -eta and max(ours) == eta
    urandom = kyber.sample_secret_coefs(64, eta=eta)  # the os.urandom path
    assert len(urandom) == 64 and all(-eta <= v <= eta for v in urandom)
    for v in (0, 1664, 1665, 3328, -5, 7000):
        assert kyber.to_zq_range(v) == jkyber.to_zq_range(v)
    assert list(kyber.secret_range(6)) == list(jkyber.secret_range(6))
    assert kyber.secret_range_len(6, eta) == jkyber.secret_range_len(6, eta)


@pytest.mark.parametrize("check_blocks", [1, 2])
def test_matrix_and_check_sums_match_jax(check_blocks):
    H = kyber.gen_ldpc_matrix(6, make_random_state(2), check_blocks)
    np.testing.assert_array_equal(H, jkyber.gen_ldpc_matrix(6, make_random_state(2), check_blocks))
    ours = kyber.generate_secret_for_H(True, H, check_blocks, rng=make_random_state(4))
    theirs = jkyber.generate_secret_for_H(True, H, check_blocks, rng=make_random_state(4))
    assert ours == theirs
    assert kyber.compute_ssum(ours[0], H, check_blocks) == jkyber.compute_ssum(ours[0], H, check_blocks)
    assert kyber.generate_secret_for_H(False, H, check_blocks, rng=make_random_state(4))[1] is None


def test_pattern_databases_match_jax():
    for name in ("SINGLE_PATTERNS", "SUM_PATTERNS", "ADAPTIVE_SINGLE_PATTERNS_ETA3"):
        assert getattr(patterns, name) == getattr(jpatterns, name), name
    for acc, per in patterns.SINGLE_PATTERNS.items():
        for m in per:
            assert kyber.get_single_patterns(2, acc, m) == jkyber.get_single_patterns(2, acc, m)
    for m in patterns.SUM_PATTERNS[6]:
        assert kyber.get_patterns(2, 0.95, 3, m, 6) == jkyber.get_patterns(2, 0.95, 3, m, 6)
        pat = kyber.get_sum_patterns(2, m, 6)
        assert kyber.coding_from_patterns(pat, 6) == jkyber.coding_from_patterns(pat, 6)
    assert kyber.get_single_patterns(2, 0.94, 3, use_closest_accuracy=True) == kyber.get_single_patterns(2, 0.95, 3)
    assert (kyber.get_restricted_single_patterns(3, 0.995, 2.5625)
            == jkyber.get_restricted_single_patterns(3, 0.995, 2.5625))
    assert kyber.pattern_four_consecutive(11, 2) == jkyber.pattern_four_consecutive(11, 2)
    for bad in (lambda k: k.get_single_patterns(2, 0.42, 3), lambda k: k.get_sum_patterns(2, 9, 6),
                lambda k: k.coding_from_patterns((0, 1, 0), 1)):
        with pytest.raises(ValueError):
            bad(kyber)


def test_posteriors_match_jax():
    rng = np.random.RandomState(1)
    coding = kyber.coding_from_patterns(kyber.get_single_patterns(2, 0.95, 3), 1)
    coding_sum = kyber.coding_from_patterns(kyber.get_sum_patterns(2, 3, 6), 6)
    for cod, sw in ((coding, 1), (coding_sum, 6)):
        prior = kyber.secret_distribution(sw)
        Y = rng.randint(0, 2, size=(40, 3))
        np.testing.assert_array_equal(posterior.posteriors_from_hard(Y, cod, prior, 0.95),
                                      jposterior.posteriors_from_hard(Y, cod, prior, 0.95))
        p_arr = posterior.normalize_fp_fn([0.02, 0.1, 0.05], 0.03, 3)
        np.testing.assert_array_equal(p_arr, jposterior.normalize_fp_fn([0.02, 0.1, 0.05], 0.03, 3))
        np.testing.assert_array_equal(posterior.posteriors_from_hard_fpfn(Y, cod, prior, p_arr),
                                      jposterior.posteriors_from_hard_fpfn(Y, cod, prior, p_arr))
        oracle = posterior.SimpleOracle(0.9)
        assert (posterior.s_distribution_from_hard_y(tuple(Y[0]), oracle, kyber.secret_range, cod, prior, sw)
                == jposterior.s_distribution_from_hard_y(tuple(Y[0]), jposterior.SimpleOracle(0.9),
                                                         jkyber.secret_range, cod, prior, sw))
    pred = [0.9, 0.2, 0.6]
    assert (posterior.s_distribution_from_prediction_y(pred, posterior.SimpleOracle(0.95), kyber.secret_range,
                                                       coding, kyber.secret_distribution(1), 1)
            == jposterior.s_distribution_from_prediction_y(pred, jposterior.SimpleOracle(0.95), jkyber.secret_range,
                                                           coding, kyber.secret_distribution(1), 1))


def test_adaptive_tree_walk_matches_jax():
    pattern = kyber.get_restricted_single_patterns(3, 0.995, 2.5625)
    tree = adaptive.tree_from_adaptive_pattern(pattern, eta=3)
    jtree = jadaptive.tree_from_adaptive_pattern(pattern, eta=3)
    assert asdict(tree) == asdict(jtree)
    s_flat = np.asarray(kyber.sample_secret_coefs(300, eta=3, rng=make_random_state(8)))
    ours = pipeline.simulate_adaptive_measurements(s_flat, tree, 0.9, make_random_state(6))
    assert ours == jpipeline.simulate_adaptive_measurements(s_flat, jtree, 0.9, make_random_state(6))
    prior = kyber.secret_distribution(1, eta=3)
    for seq in set(ours[0][:50]):
        assert (posterior.s_distribution_from_hard_y_adaptive(list(seq), 0.9, lambda sw: range(-3, 4), tree, prior, 1)
                == jposterior.s_distribution_from_hard_y_adaptive(list(seq), 0.9, lambda sw: range(-3, 4), jtree,
                                                                  prior, 1))
    assert pipeline.binary_sum_coding(18) == jpipeline.binary_sum_coding(18)
    with pytest.raises(ValueError):
        adaptive.tree_from_adaptive_pattern(pattern[:-1], eta=3)


def test_measurement_simulators_match_jax():
    s_flat = np.asarray(kyber.sample_secret_coefs(200, rng=make_random_state(1)))
    pat = kyber.get_patterns(2, 0.95, 3, 3, 6)
    for name, args in (("simulate_measurements", (s_flat, pat["pattern"], 0.95)),
                       ("simulate_sum_measurements", (s_flat * 3, pat["pattern_sum"], 0.95))):
        extra = (6,) if name == "simulate_sum_measurements" else ()
        np.testing.assert_array_equal(getattr(pipeline, name)(*args, make_random_state(2), *extra),
                                      getattr(jpipeline, name)(*args, make_random_state(2), *extra))
    true_bits = make_random_state(3).randint(0, 2, size=(50, 3))
    p_arr = posterior.normalize_fp_fn(0.1, [0.2, 0.05, 0.3], 3)
    np.testing.assert_array_equal(pipeline.simulate_measurements_fpfn(true_bits, p_arr, make_random_state(4)),
                                  jpipeline.simulate_measurements_fpfn(true_bits, p_arr, make_random_state(4)))
    cod = pipeline.binary_sum_coding(18)
    np.testing.assert_array_equal(pipeline.simulate_sum_measurements_coding(s_flat * 4, cod, 0.9, make_random_state(5)),
                                  jpipeline.simulate_sum_measurements_coding(s_flat * 4, cod, 0.9, make_random_state(5)))
    s_distr = [np.tile(np.arange(5, dtype=np.float32), (256, 1)) for _ in range(3)]
    ssum = np.tile(np.arange(25, dtype=np.float32), (512, 1))
    for a, b in zip(pipeline.get_channel_probabilities(s_distr, ssum, 6, 2),
                    jpipeline.get_channel_probabilities(s_distr, ssum, 6, 2)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- codes


def _irregular(seed=17, n_b=12, r=6, sw=3, deg0=2):
    """test_qary.py's enumeration-reference code: row 0 of degree ``deg0``
    (irregular when below SW), +-1 entries; here also a permuted, signed
    identity block."""
    rng = make_random_state(seed)
    H = np.zeros((r, n_b + r), np.int8)
    for i in range(r):
        deg = deg0 if i == 0 else sw
        cols = rng.choice(n_b, deg, replace=False)
        H[i, cols] = rng.choice([-1, 1], deg)
    H[np.arange(r), n_b + rng.permutation(r)] = rng.choice([-1, 1], r)
    return H


@functools.cache
def _h(name):
    if name == "irregular":
        return _irregular()
    if name == "block16":  # test_qary.py:149, DV = 2
        return _block16(1)
    if name == "block16x2":  # two check blocks: DV = 4
        return _block16(2)
    return kyber.gen_ldpc_matrix(6, 0, check_blocks=1).astype(np.int8)  # "kyber768": 768 + 256


def _block16(check_blocks):
    from sca_ldpc_tpu_torch.codes import make_qary_qc_parity_check_matrix

    return make_qary_qc_parity_check_matrix(16, 6, 3, make_random_state(5), check_blocks=check_blocks).astype(np.int8)


SW_OF = {"irregular": 3, "block16": 6, "block16x2": 6, "kyber768": 6}


@pytest.mark.parametrize("name", ["irregular", "block16", "block16x2", "kyber768"])
def test_index_arrays_match_jax_args(name):
    H = _h(name)
    b = 2
    ours = QarySpecialDecoder(H, b, b * SW_OF[name], 1, device="cpu")
    theirs = JaxQarySpecialDecoder(H, b, b * SW_OF[name], 1)
    assert (ours.n, ours.r, ours.n_b, ours.sw) == (theirs.n, theirs.r, theirs.n_b, theirs.sw)
    fields = ("bvar_idx", "bvar_sign", "bvar_mask", "var_flat", "var_sign", "var_mask", "sum_sign", "row_of_sum")
    for f, a, j in zip(fields, ours._args, theirs._args):
        assert a.dtype == torch.int32, f
        np.testing.assert_array_equal(a.numpy(), np.asarray(j).astype(np.int32), err_msg=f)
    np.testing.assert_array_equal(ours._sum_var.numpy(), theirs._sum_var)
    arrays, _ = special_index_arrays(H)
    for f, a, j in zip(fields, arrays, theirs._args):
        assert a.dtype == np.asarray(j).dtype, f
    if name == "block16x2":
        assert ours._args[3].shape[1] == 4  # DV = 4


def test_decoder_rejects_what_jax_rejects():
    H = _h("irregular")
    for kw in (dict(b=2, bsum=7), dict(b=2, bsum=8), dict(b=2, bsum=6, backend="xla"),
               dict(b=2, bsum=6, backend="fused", early_exit=True)):
        with pytest.raises(ValueError):
            QarySpecialDecoder(H, max_iter=3, device="cpu", **kw)
    two_sums = H.copy()
    two_sums[0, -1] = two_sums[0, -2] = 1
    for bad in (two_sums, H[:, :-1]):
        with pytest.raises(ValueError):
            QarySpecialDecoder(bad, 2, 6, 3, device="cpu")
    dec = QarySpecialDecoder(H, 2, 6, 3, device="cpu")
    assert dec.backend == "plain"
    with pytest.raises(ValueError):
        dec.min_sum(np.full((12, 4), 0.25, np.float32), np.full((6, 13), 1 / 13, np.float32))


# ---------------------------------------------------------------- summation order


def test_xla_sums_dv_slots_left_to_right():
    """The XLA path's B-variable totals ``channel + jnp.sum(u, axis=2)`` on
    the CPU add the DV = 4 slots left to right, ((u0 + u1) + u2) + u3 — not
    pairwise — and the port's plain loop and K7 use that order."""
    rng = np.random.RandomState(0)
    shape = (3, 768, 4, 5)
    u = (rng.randn(*shape) * 10.0 ** rng.uniform(-3, 3, size=shape)).astype(np.float32)
    ch = (rng.randn(3, 768, 5) * 5).astype(np.float32)
    xla = np.asarray(jax.jit(lambda c, x: c + jnp.sum(x, axis=2))(ch, u))
    seq = ch + (((u[:, :, 0] + u[:, :, 1]) + u[:, :, 2]) + u[:, :, 3])
    pairwise = ch + ((u[:, :, 0] + u[:, :, 1]) + (u[:, :, 2] + u[:, :, 3]))
    assert np.array_equal(xla.view(np.uint32), seq.view(np.uint32))
    assert not np.array_equal(xla.view(np.uint32), pairwise.view(np.uint32))


# ---------------------------------------------------------------- decoder


def _dirichlet(name, frames=3, seed=11, b=2):
    H = _h(name)
    r, n = H.shape
    rng = np.random.RandomState(seed)
    ch_b = rng.dirichlet(np.ones(2 * b + 1), size=(frames, n - r)).astype(np.float32)
    ch_s = rng.dirichlet(np.ones(2 * b * SW_OF[name] + 1), size=(frames, r)).astype(np.float32)
    return ch_b, ch_s


def _nonzero_secret_frames(frames=4):
    """test_qary.py:257-290: true secrets, exact sums, mild noise."""
    H = _h("kyber768").astype(np.int64)
    b, bsum = 2, 12
    n_b, r = 768, 256
    rng = np.random.RandomState(5)
    ch_b = np.full((frames, n_b, 2 * b + 1), 0.01, np.float32)
    ch_s = np.full((frames, r, 2 * bsum + 1), 1e-4, np.float32)
    words = np.zeros((frames, n_b + r), np.int64)
    for f in range(frames):
        s = rng.randint(-b, b + 1, size=n_b)
        hs = H[:, :n_b] @ s
        x = np.zeros(r, np.int64)
        for row in range(r):
            col = np.nonzero(H[row, n_b:])[0][0]
            x[col] = -hs[row] // H[row, n_b + col]
        words[f] = np.concatenate([s, x])
        ch_b[f, np.arange(n_b), s + b] = 0.9
        ch_s[f, np.arange(r), x + bsum] = 0.99
    return ch_b, ch_s, words


@functools.cache
def _frames(case):
    if case == "nonzero":
        return _nonzero_secret_frames()[:2]
    name = case.split(":")[0]
    return _dirichlet(name, b=3 if case.endswith("eta3") else 2)


def _case(case):
    name = case.split(":")[0]
    b = 3 if case.endswith("eta3") else 2
    return name if case != "nonzero" else "kyber768", b


@functools.cache
def _jax_hard(case, iters, early_exit=False):
    name, b = _case(case)
    dec = JaxQarySpecialDecoder(_h(name), b, b * SW_OF[name], iters, early_exit=early_exit)
    return np.asarray(dec.min_sum(*_frames(case)))


CASES = ["irregular", "irregular:eta3", "block16", "block16x2", "kyber768", "nonzero"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("backend", ["plain", "chain", "fused"])
def test_decoder_matches_jax_xla_path(case, backend):
    name, b = _case(case)
    for iters in (1, 4) if name != "kyber768" else (3,):
        ours = QarySpecialDecoder(_h(name), b, b * SW_OF[name], iters, backend=backend, device="cpu").min_sum(*_frames(case))
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), _jax_hard(case, iters))


@pytest.mark.parametrize("case", ["irregular", "block16x2", "kyber768", "nonzero"])
@pytest.mark.parametrize("backend", ["plain", "chain"])
def test_decoder_early_exit_matches_jax(case, backend):
    name, b = _case(case)
    iters = 6 if case == "nonzero" else 4
    ours = QarySpecialDecoder(_h(name), b, b * SW_OF[name], iters, backend=backend, early_exit=True, device="cpu")
    got = ours.min_sum(*_frames(case)).numpy()
    np.testing.assert_array_equal(got, _jax_hard(case, iters, early_exit=True))
    if case == "nonzero":
        np.testing.assert_array_equal(got, _nonzero_secret_frames()[2])
        np.testing.assert_array_equal(got, _jax_hard(case, iters))


def test_fused_matches_jax_fused_in_interpret_mode():
    """The JAX fused Pallas kernel (interpret mode) and the port's fused
    backend give the same hard decisions on the Kyber-768 geometry."""
    H = _h("kyber768")
    ch_b, ch_s = _frames("kyber768")
    jdec = JaxQarySpecialDecoder(H, 2, 12, max_iter=3, backend="fused")
    with pltpu.force_tpu_interpret_mode():
        theirs = np.asarray(jdec.min_sum(ch_b, ch_s))
    ours = QarySpecialDecoder(H, 2, 12, 3, backend="fused", device="cpu").min_sum(ch_b, ch_s)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    # the kernel itself, on the JAX decoder's row-ordered inputs
    llr_b = jminplus.clip_inf(jllr.probs_to_llr(ch_b))
    llr_s = jminplus.clip_inf(jllr.probs_to_llr(ch_s))[:, jdec._sum_var]
    sign = np.asarray(jdec._args[6]).astype(np.int32)
    vsum = jnp.where(sign[None, :, None] < 0, llr_s[..., ::-1], llr_s)
    with pltpu.force_tpu_interpret_mode():
        hb, hs = qary_special_min_sum_fused(llr_b, llr_s, vsum, *jdec._fused_args(), 2, 12, 3)
    dec = QarySpecialDecoder(H, 2, 12, 3, backend="fused", device="cpu")
    args = tuple(torch.from_numpy(np.array(x)) for x in (llr_b, llr_s, vsum))
    kb, ks = qary_special_min_sum_fused_cuda(*args, *dec._args[:4], dec._args[6], 2, 12, 3)
    np.testing.assert_array_equal(kb.numpy(), np.asarray(hb))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(hs))


@pytest.mark.parametrize("iters", [1, 4])
def test_decoder_matches_enumeration_reference(iters):
    """test_qary.py's conformance against the enumeration model of the Rust
    DecoderSpecial (decoder_special.rs:471-617), for every backend: at 1
    iteration on arbitrary posteriors with an irregular row, at 4 on
    consistent posteriors and a regular code; both with signed identity
    entries in a permuted order."""
    rng = make_random_state(17)
    n_b, r, sw, b = 12, 6, 3, 2
    bsum = sw * b
    H = _irregular(17) if iters == 1 else _irregular(18, deg0=sw)
    decs = [QarySpecialDecoder(H, b, bsum, iters, sw=sw, backend=be, device="cpu") for be in ("plain", "chain", "fused")]
    sum_col = np.array([np.flatnonzero(H[i, n_b:])[0] for i in range(r)])
    for _ in range(3):
        if iters == 1:
            p_b = rng.dirichlet(np.full(2 * b + 1, 2.0), size=n_b).astype(np.float32)
            p_s = rng.dirichlet(np.full(2 * bsum + 1, 2.0), size=r).astype(np.float32)
        else:
            s = rng.randint(-b, b + 1, size=n_b)
            ssum = -(H[:, :n_b].astype(np.int64) @ s)
            p_b = np.full((n_b, 2 * b + 1), 0.04, np.float32)
            p_b[np.arange(n_b), s + b] = 1.0 - 0.04 * (2 * b)
            p_s = np.full((r, 2 * bsum + 1), 0.004, np.float32)
            p_s[sum_col, ssum * H[np.arange(r), n_b + sum_col] + bsum] = 1.0 - 0.004 * (2 * bsum)
        ref = ref_special_min_sum(H, b, bsum, iters, p_b, p_s, clip=jminplus.BIG)
        for dec in decs:
            np.testing.assert_array_equal(dec.min_sum(p_b, p_s).numpy(), ref)


def test_batched_and_zero_iterations():
    H = _h("block16")
    ch_b, ch_s = _frames("block16")
    dec = QarySpecialDecoder(H, 2, 12, 3, backend="fused", device="cpu")
    batched = dec.min_sum(ch_b, ch_s)
    for f in range(ch_b.shape[0]):
        np.testing.assert_array_equal(dec.min_sum(ch_b[f], ch_s[f]).numpy(), batched[f].numpy())
    for backend in ("plain", "fused"):
        zero = QarySpecialDecoder(H, 2, 12, 0, backend=backend, device="cpu").min_sum(ch_b, ch_s).numpy()
        np.testing.assert_array_equal(zero, np.asarray(JaxQarySpecialDecoder(H, 2, 12, 0).min_sum(ch_b, ch_s)))


def test_fused_wrapper_checks_inputs_on_cpu():
    dec = QarySpecialDecoder(_h("irregular"), 2, 6, 3, device="cpu")
    args = (torch.zeros((2, 12, 5)), torch.zeros((2, 6, 13)), torch.zeros((2, 6, 13)), *dec._args[:4], dec._args[6])
    before = qary_special_min_sum_fused_cuda.launches
    hb, hs = qary_special_min_sum_fused_cuda(*args, 2, 6, 3)
    assert hb.shape == (2, 12) and hs.shape == (2, 6)
    assert qary_special_min_sum_fused_cuda.launches == before  # the CPU path launches nothing
    with pytest.raises(ValueError):  # 2b+1 != 5
        qary_special_min_sum_fused_cuda(*args, 3, 6, 3)
    with pytest.raises(ValueError):  # 2bsum+1 != 13
        qary_special_min_sum_fused_cuda(*args, 2, 5, 3)
    with pytest.raises(ValueError):
        qary_special_min_sum_fused_cuda(*args, 2, 6, -1)
    with pytest.raises(TypeError):
        qary_special_min_sum_fused_cuda(args[0].double(), *args[1:], 2, 6, 3)
    with pytest.raises(TypeError):
        qary_special_min_sum_fused_cuda(*args[:3], args[3].long(), *args[4:], 2, 6, 3)
    with pytest.raises(ValueError):
        qary_special_min_sum_fused_cuda(args[0], args[1][:, :5], *args[2:], 2, 6, 3)


def test_registry_resolves_the_kyber_decoder():
    H = kyber.gen_ldpc_matrix(6, 0, check_blocks=2)
    dec = get_decoder_by_name("DecoderN1280R512SW6", H, iterations=3, device="cpu")
    assert isinstance(dec, QarySpecialDecoder)
    assert (dec.n, dec.r, dec.sw, dec.b, dec.bsum, dec.max_iter, dec.backend) == (1280, 512, 6, 2, 12, 3, "plain")
    assert get_decoder_by_name("DecoderN1280R512SW6", H, 3, eta=3, backend="chain", device="cpu").bsum == 18
    with pytest.raises(ValueError):
        get_decoder_by_name("DecoderN1280R512SW6", H[:, :-1], iterations=3, device="cpu")
    dk = pipeline.get_decoder(6, H, 2, iterations=3, device="cpu")
    assert (dk.sw, dk.b, dk.bsum, dk.backend) == (6, 2, 12, "plain")
    with pytest.raises(ValueError):
        pipeline.get_decoder(6, H[:, :-1], 2, iterations=3, device="cpu")


# ---------------------------------------------------------------- attack pipeline


def test_kyber_attack_matches_jax():
    """test_kyber.py:169 (seed 7): the same result dicts, recovery > 95%."""
    kw = dict(accuracy=0.995, num_patterns=3, num_patterns_sum=3, sum_weight=6, check_blocks=2, iterations=10,
              runs=1)
    ours = kyber.simulate_kyber_attack(make_random_state(7), device="cpu", **kw)
    assert ours == jkyber.simulate_kyber_attack(make_random_state(7), **kw)
    assert ours[0]["correct_coefficients"] / ours[0]["total_coefficients"] > 0.95


def test_kyber_attack_fpfn_matches_jax():
    """test_kyber.py:134 (seed 9): asymmetric per-position oracle noise."""
    kw = dict(accuracy=0.995, num_patterns=3, num_patterns_sum=3, sum_weight=6, check_blocks=2, iterations=10,
              runs=1, fp=[0.002, 0.01, 0.005], fn=0.008)
    ours = kyber.simulate_kyber_attack(make_random_state(9), device="cpu", **kw)
    assert ours == jkyber.simulate_kyber_attack(make_random_state(9), **kw)
    assert ours[0]["correct_coefficients"] / ours[0]["total_coefficients"] > 0.95


def test_kyber_adaptive_attack_matches_jax():
    """test_kyber_adaptive.py:67 (seed 0): eta = 3 tree-coded measurements,
    full recovery; the same result dict."""
    ours = kyber.simulate_kyber_attack_adaptive(make_random_state(0), accuracy=0.995, runs=1, device="cpu")
    assert ours == jkyber.simulate_kyber_attack_adaptive(make_random_state(0), accuracy=0.995, runs=1)
    assert ours[0]["recovered"] and ours[0]["correct_coefficients"] == 768
