"""The batched Kyber attack step (``sca_ldpc_tpu_torch/parallel/kyber.py``) on the CPU.

Its channels against the host pipeline's posteriors, its decode against the
benchmark's plain reference (``benchmark/reference/kyber.py``) at the
published Kyber-768 sizes, the reference against the enumeration model of the
Rust ``DecoderSpecial`` (``tests/qary_reference.py``), its counts against a
recount of its decisions, its draw, and its spans and counters.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import kyber as reference
from qary_reference import ref_special_min_sum
from sca_ldpc_tpu_torch import parallel
from sca_ldpc_tpu_torch.channels.llr import probs_to_llr
from sca_ldpc_tpu_torch.codes import make_qary_qc_parity_check_matrix
from sca_ldpc_tpu_torch.models import kyber
from sca_ldpc_tpu_torch.models.kyber import patterns, pipeline, posterior
from sca_ldpc_tpu_torch.ops import QarySpecialDecoder
from sca_ldpc_tpu_torch.utils import make_random_state, spans

torch.set_num_threads(1)

ACCURACIES = (0.9, 0.95, 0.995)
SEED = 2**40 + 1234567


def _kyber768():
    return kyber.gen_ldpc_matrix(6, 0, check_blocks=2).astype(np.int8)  # 768 + 512, SW 6


def _small():
    return make_qary_qc_parity_check_matrix(16, 6, 3, make_random_state(5), check_blocks=2).astype(np.int8)  # 48 + 32


def _generator(seed=SEED):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _codings(accuracy):
    pat = patterns.get_patterns(2, accuracy, 3, 3, 6)
    return patterns.coding_from_patterns(pat["pattern"], 1), patterns.coding_from_patterns(pat["pattern_sum"], 6)


def _codewords(coding):
    return np.array([c for _s, c in sorted(coding.items())])


@pytest.fixture
def clean_spans():
    spans.reset()
    yield
    spans.reset()


@pytest.mark.parametrize("accuracy", ACCURACIES)
def test_channels_equal_host_pipeline(accuracy):
    """For the answers drawn, the step's channels are the LLRs of
    ``get_channel_probabilities(posteriors_from_hard(...))``, bit for bit."""
    H = _kyber768()
    dec = QarySpecialDecoder(H, 2, 12, 10, device="cpu")
    tables = parallel.kyber_tables(dec, H, accuracy)
    draw = parallel.kyber_draw(_generator(), 3, tables)
    llr, llr_sum = parallel.kyber_channels(draw, tables)
    coding, coding_sum = _codings(accuracy)
    prior, prior_sum = kyber.secret_distribution(1), kyber.secret_distribution(6)
    for f in range(3):
        post = posterior.posteriors_from_hard(draw.answers[f].numpy(), coding, prior, accuracy)
        post_sum = posterior.posteriors_from_hard(draw.answers_sum[f].numpy(), coding_sum, prior_sum, accuracy)
        s_distr = [post[j * 256 : (j + 1) * 256] for j in range(3)]
        channel, channel_sum = pipeline.get_channel_probabilities(s_distr, post_sum, 6, 2)
        assert torch.equal(llr[f], probs_to_llr(torch.from_numpy(channel)))
        assert torch.equal(llr_sum[f], probs_to_llr(torch.from_numpy(channel_sum)))


@pytest.mark.parametrize("accuracy", ACCURACIES)
def test_decode_equals_reference_at_published_sizes(accuracy):
    """Kyber-768, batch 8, 10 iterations: the reference's own channels equal
    the step's, and the port's plain decode gives the reference's decisions,
    secret and sum, every one."""
    H = _kyber768()
    dec = QarySpecialDecoder(H, 2, 12, 10, device="cpu")
    tables = parallel.kyber_tables(dec, H, accuracy)
    draw = parallel.kyber_draw(_generator(SEED + int(accuracy * 1000)), 8, tables)
    llr, llr_sum = parallel.kyber_channels(draw, tables)
    coding, coding_sum = _codings(accuracy)
    ref_llr = reference.channels(draw.answers, _codewords(coding), reference.cbd_prior(1, 2), accuracy)
    ref_llr_sum = reference.channels(draw.answers_sum, _codewords(coding_sum), reference.cbd_prior(6, 2), accuracy,
                                     reverse=True)
    assert torch.equal(ref_llr, llr) and torch.equal(ref_llr_sum, llr_sum)
    theirs = reference.min_sum(H, ref_llr, ref_llr_sum, 10, block=3)
    ours = dec.min_sum_llr(ref_llr, ref_llr_sum)
    assert ours.shape == theirs.shape == (8, 1280)
    assert torch.equal(ours, theirs)


def _signed_permuted(seed):
    """A regular [H'|I] (N_b 12, R 4, SW 3) whose identity columns are
    permuted and carry -1 on some rows."""
    H = make_qary_qc_parity_check_matrix(4, 3, 3, make_random_state(seed), check_blocks=1).astype(np.int8)
    rng = np.random.RandomState(seed)
    ident = np.diag(rng.choice([-1, 1], size=4)).astype(np.int8)[:, rng.permutation(4)]
    return np.concatenate([H[:, :12], ident], axis=1)


@pytest.mark.parametrize("iters", [1, 4])
def test_reference_matches_enumeration(iters):
    """The reference's decisions are the exact model's of the Rust
    ``DecoderSpecial`` (every configuration of a check enumerated): at 1
    iteration on arbitrary posteriors, at 4 on consistent ones."""
    rng = np.random.RandomState(23 + iters)
    b, bsum, n_b, r = 2, 6, 12, 4
    for trial in range(3):
        H = _signed_permuted(40 + trial)
        sum_col = np.array([np.flatnonzero(H[i, n_b:])[0] for i in range(r)])
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
        exact = ref_special_min_sum(H, b, bsum, iters, p_b, p_s)
        llr = probs_to_llr(torch.from_numpy(p_b))[None]
        llr_sum = probs_to_llr(torch.from_numpy(p_s))[None]
        np.testing.assert_array_equal(reference.min_sum(H, llr, llr_sum, iters)[0].numpy(), exact)


def test_reference_rejects_codes_it_does_not_model():
    H = _signed_permuted(40)
    llr, llr_sum = torch.zeros((1, 12, 5)), torch.zeros((1, 4, 13))
    irregular = H.copy()
    irregular[0, np.flatnonzero(irregular[0, :12])[0]] = 0
    with pytest.raises(ValueError):
        reference.min_sum(irregular, llr, llr_sum, 1)
    no_identity = H.copy()
    no_identity[:, 12:] = 0
    with pytest.raises(ValueError):
        reference.min_sum(no_identity, llr, llr_sum, 1)
    with pytest.raises(ValueError):
        reference.min_sum(H, llr, llr_sum, 0)


@pytest.mark.parametrize("accuracy", ACCURACIES)
def test_step_counts_equal_recount(accuracy):
    """The step's counts are those of its decisions: the same draw again from
    the generator's state, its channels decoded and compared with its
    secrets, count the same recovered attacks and wrong coefficients."""
    H = _small()
    dec = QarySpecialDecoder(H, 2, 12, 10, backend="fused", device="cpu")
    step = parallel.make_kyber_attack_step(dec, H, accuracy)
    g = _generator(SEED + 7)
    for _ in range(2):
        state = g.get_state()
        ok, wrong, frames = (int(x) for x in step(g, 24))
        again = _generator()
        again.set_state(state)
        draw = parallel.kyber_draw(again, 24, step.tables)
        per_frame = (dec.min_sum_llr(*parallel.kyber_channels(draw, step.tables))[:, :48] != draw.s).sum(dim=-1)
        assert (ok, wrong, frames) == (int((per_frame == 0).sum()), int(per_frame.sum()), 24)


def test_draw_repeats_from_one_state():
    H = _small()
    tables = parallel.kyber_tables(QarySpecialDecoder(H, 2, 12, 10, device="cpu"), H, 0.95)
    g = _generator()
    state = g.get_state()
    first = parallel.kyber_draw(g, 16, tables)
    after = parallel.kyber_draw(g, 16, tables)
    g.set_state(state)
    again = parallel.kyber_draw(g, 16, tables)
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert not torch.equal(first.answers, after.answers)


def test_draw_follows_the_attack():
    """The secrets are centered binomial, the sums are ``compute_ssum``'s,
    and about 1 - accuracy of the answers differ from the true codeword bits."""
    H = _kyber768()
    accuracy = 0.9
    tables = parallel.kyber_tables(QarySpecialDecoder(H, 2, 12, 10, device="cpu"), H, accuracy)
    draw = parallel.kyber_draw(_generator(SEED + 99), 16, tables)
    s = draw.s.numpy()
    assert s.dtype == np.int8 and draw.ssum.shape == (16, 512)
    freq = np.bincount(s.reshape(-1) + 2, minlength=5) / s.size
    np.testing.assert_allclose(freq, [1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16], atol=0.01)
    for f in range(2):
        ssum = kyber.compute_ssum([s[f, j * 256 : (j + 1) * 256].tolist() for j in range(3)], H, 2)
        np.testing.assert_array_equal(draw.ssum[f].numpy(), ssum)
    coding, coding_sum = _codings(accuracy)
    true = _codewords(coding)[s + 2]
    true_sum = _codewords(coding_sum)[draw.ssum.numpy() + 12]
    for answers, truth in ((draw.answers.numpy(), true), (draw.answers_sum.numpy(), true_sum)):
        share = float((answers != truth).mean())
        sigma = np.sqrt(0.09 / answers.size)
        assert abs(share - 0.1) < 6 * sigma


def test_step_rejects_what_it_cannot_run():
    H = _small()
    with pytest.raises(ValueError):  # iterations that end early
        parallel.make_kyber_attack_step(QarySpecialDecoder(H, 2, 12, 10, early_exit=True, device="cpu"), H, 0.95)
    dec = QarySpecialDecoder(H, 2, 12, 10, device="cpu")
    with pytest.raises(ValueError):  # another code's shape
        parallel.make_kyber_attack_step(dec, H[:, :-1], 0.95)
    with pytest.raises(ValueError):  # not the identity in the last R columns
        parallel.make_kyber_attack_step(dec, np.concatenate([H[:, :48], -H[:, 48:]], axis=1), 0.95)
    with pytest.raises(ValueError):  # no pattern database at this accuracy
        parallel.make_kyber_attack_step(dec, H, 0.5)


def test_simulation_runs_in_batches():
    H = _small()
    dec = QarySpecialDecoder(H, 2, 12, 10, device="cpu")
    recovered, wrong, frames = parallel.kyber_attack_simulation(dec, H, 0.995, 20, _generator(), batch=8)
    assert frames == 20 and 0 <= recovered <= 20 and 0 <= wrong <= 20 * 48
    assert all(isinstance(x, int) for x in (recovered, wrong, frames))


def test_spans_and_counters_only_while_collecting(clean_spans):
    H = _small()
    dec = QarySpecialDecoder(H, 2, 12, 10, device="cpu")
    parallel.kyber_attack_simulation(dec, H, 0.95, 16, _generator(), batch=8)
    assert spans.snapshot() == {"spans": {}, "counters": {}}
    with spans.collect():
        recovered, wrong, frames = parallel.kyber_attack_simulation(dec, H, 0.95, 20, _generator(), batch=8)
    recorded = spans.snapshot()
    names = ("kyber.simulation", "kyber.draw", "kyber.channel", "kyber.decode", "kyber.count")
    assert set(recorded["spans"]) == set(names)
    assert [recorded["spans"][n]["calls"] for n in names] == [1, 3, 3, 3, 3]
    assert recorded["counters"] == {"kyber.frames": 20, "kyber.frame_iterations": 200,
                                    "kyber.wrong_coefficients": wrong}
    parallel.kyber_attack_simulation(dec, H, 0.95, 8, _generator(), batch=8)
    assert spans.snapshot() == recorded
