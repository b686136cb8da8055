"""PyTorch port conformance: the timing-channel oracle
(``models/hqc/oracle_timing.py`` and the timing branch of ``HqcOracle``)
against the JAX package, on the CPU.

The scripts of ``tests/test_timing_oracle.py`` (a scripted mock channel for
the amplification, the differential decision margin, recalibration, the
calibration guards, ``CERTAINTY_CAP``) run through both packages with the
same key, ciphertexts and RNG seeds; every observed value (decisions,
probes measured, certainties, EPSILON, offsets, counters) must be exactly
equal, and the port's must be what the JAX test expects.
"""

import inspect
from types import SimpleNamespace

import pytest
import torch

from sca_ldpc_tpu.models.hqc import Hqc128 as JaxHqc128
from sca_ldpc_tpu.models.hqc import attack as jattack
from sca_ldpc_tpu.models.hqc import oracle_timing as jot
from sca_ldpc_tpu.models.hqc.tracking import HqcSimulationParams as JaxParams
from sca_ldpc_tpu.models.hqc.tracking import HqcSimulationTracking as JaxTracking
from sca_ldpc_tpu_torch.models.hqc import Hqc128, attack, oracle_timing
from sca_ldpc_tpu_torch.models.hqc.tracking import HqcSimulationParams, HqcSimulationTracking
from sca_ldpc_tpu_torch.tools.attack_cells import ModelledClock
from sca_ldpc_tpu_torch.utils import make_random_state

torch.set_num_threads(1)

KEY = "fixtures/test-hqc128.key"
PORT = SimpleNamespace(attack=attack, ot=oracle_timing, Params=HqcSimulationParams, Tracking=HqcSimulationTracking,
                       HQC=Hqc128)
JAX = SimpleNamespace(attack=jattack, ot=jot, Params=JaxParams, Tracking=JaxTracking, HQC=JaxHqc128)


class MockChannel:
    """Stands in for TimingChannel: answers from a scripted table keyed by
    the exact ciphertext bytes measured, recording every probe."""

    def __init__(self, answers):
        self.answers = answers  # ct bytes -> list of answers (popped)
        self.measured = []  # every ct measured, in order
        self.num_measurements = 0
        self.num_decaps = 0
        self.truth_agree = [0, 0]
        self.truth_total = [0, 0]

    def measure_success(self, ct):
        ct = bytes(ct)
        self.measured.append(ct)
        self.num_measurements += 1
        return self.answers[ct].pop(0)

    def record_truth(self, reported, true_answer):
        t = int(bool(true_answer))
        self.truth_total[t] += 1
        if bool(reported) == bool(true_answer):
            self.truth_agree[t] += 1


def _keys(pkg):
    pub, priv = pkg.attack.read_or_generate_keypair(pkg.HQC(), KEY)
    return pkg.HQC(), pub, priv


def _oracle(pkg):
    params = pkg.Params(pkg.HQC, OUTER_DECODING_LIMIT=15, EPSILON=(0.9, 0.8), DECODE_EVERY=10, WEIGHT=3)
    tracking = pkg.Tracking(params)
    HQC, pub, priv = _keys(pkg)
    pt = bytes(HQC.new_plaintext())
    ct, _ = HQC.encaps_with_plaintext_and_r1(pub, pt, [])
    oracle = pkg.attack.HqcOracle(params, tracking, priv, pt, make_random_state(0), ct, backend="native",
                                  timing_channel=MockChannel({}))
    return oracle, params, tracking, bytes(ct)


def _both(scenario, *args):
    """The scenario's observations through the port and the JAX package,
    which must be equal; returns the port's."""
    ours, theirs = scenario(PORT, *args), scenario(JAX, *args)
    assert ours == theirs
    return ours


def _bayes_post_true(k_t, k_f, acc_f, acc_t):
    lik_t = acc_t**k_t * (1 - acc_t) ** k_f
    lik_f = (1 - acc_f) ** k_t * acc_f**k_f
    return lik_t / (lik_t + lik_f)


def _amplify_same_probe(pkg):
    oracle, params, tracking, base_ct = _oracle(pkg)
    vbit = 12345
    probe_ct = bytes(pkg.attack.toggle_bits_in_v(base_ct, [vbit], params.N))
    channel = MockChannel({probe_ct: [True, True]})
    oracle.timing = channel
    meta = {}
    result = oracle._amplify(raw=True, require=(0.95, 0.95), result_meta=meta, debug=False, vbit=vbit)
    return (result, channel.measured == [probe_ct, probe_ct], meta["certainty"], tracking.num_oracle_calls,
            channel.truth_total, channel.truth_agree)


def test_amplification_remeasures_same_probe():
    result, same_probe, certainty, calls, total, agree = _both(_amplify_same_probe)
    assert result is True and same_probe
    assert certainty == pytest.approx(_bayes_post_true(2, 0, 0.9, 0.8))
    assert calls == 2 and total[1] == 2 and agree[1] == 2


def _mixed_answers(pkg):
    oracle, _params, _tracking, base_ct = _oracle(pkg)
    channel = MockChannel({base_ct: [True] + [False] * 7})
    oracle.timing = channel
    meta = {}
    result = oracle._amplify(raw=False, require=(0.97, 0.97), result_meta=meta, debug=False, vbit=None)
    return result, len(channel.measured), meta["certainty"]


def test_mixed_answers_weighed_by_posterior():
    result, measured, certainty = _both(_mixed_answers)
    assert result is False and measured == 5
    assert certainty == pytest.approx(1 - _bayes_post_true(1, 4, 0.9, 0.8))


def _margin(pkg, monkeypatch):
    samples = {b"base": 100000.0, b"fail": 100000.0 - 3600.0, b"succ": 100000.0 - 900.0}
    monkeypatch.setattr(pkg.ot, "_measure_interleaved", lambda HQC, priv, cts, m, chunk: [samples[bytes(c)] for c in cts])
    ch = pkg.ot.TimingChannel(object(), b"", b"base", gap=9000, margin=1800, measure=8)
    ch2 = pkg.ot.TimingChannel(object(), b"", b"base", gap=9000, measure=8)
    return (ch.measure_success(b"fail"), ch.measure_success(b"succ"), ch2.margin, ch2.measure_success(b"fail"),
            ch.num_measurements, ch.num_decaps)


def test_timing_channel_decision_margin(monkeypatch):
    fail, succ, margin2, fail2, measurements, decaps = _both(_margin, monkeypatch)
    assert (fail, succ, margin2, fail2) == (False, True, 4500, True)
    assert (measurements, decaps) == (2, 32)


def _recal(pkg, monkeypatch):
    HQC, pub, priv = _keys(pkg)
    base_ct, _ = HQC.encaps_with_plaintext_and_r1(pub, bytes(HQC.new_plaintext()), [])
    calls = {"n": 0}

    def fake_measure(HQC_, priv_, cts, measurements, chunk):
        # one success probe, recalibrate()'s 4 fail probes and 4 success
        # probes, one success probe; the success class drifted to -2000
        i = calls["n"]
        calls["n"] += 1
        return [100000.0 + (-12000.0 if 1 <= i <= 4 else -2000.0), 100000.0]

    monkeypatch.setattr(pkg.ot, "_measure_interleaved", fake_measure)
    updates = []
    ch = pkg.ot.TimingChannel(HQC, priv, base_ct, gap=9000, margin=1800, measure=8, rng=make_random_state(3),
                              recal_every=50, recal_trials=4, recal_decay=0.65, epsilon=(0.96, 0.99),
                              calibration_counts=(96, 100, 99, 100), on_update=updates.append)
    probe = b"\x00" * len(bytes(base_ct))
    before = ch.measure_success(probe)
    ch.recalibrate()
    history = {k: v for k, v in ch.recal_history[0].items() if k not in ("loadavg", "unix_time")}
    return (before, ch.offset, ch.measure_success(probe), ch.epsilon, updates, ch.num_recals, history,
            ch.num_recal_decaps, ch.rng.get_state()[2], ch.state_dict()["_tallies"])


def test_recalibration_recenters_and_refreshes_epsilon(monkeypatch):
    before, offset, after, eps, updates, recals, history, recal_decaps, _draws, _t = _both(_recal, monkeypatch)
    assert before is False and after is True
    assert offset == pytest.approx(-2000.0)
    exp_f = (0.65 * 96 + 4) / (0.65 * 100 + 4)
    exp_s = (0.65 * 99 + 4) / (0.65 * 100 + 4)
    assert eps == pytest.approx((exp_f, min(exp_s, 0.995)))
    assert updates == [eps] and recals == 1
    assert history["window_acc_fail"] == 1.0 and history["window_acc_success"] == 1.0
    assert recal_decaps == 8 * 2 * 8


def _auto_recal(pkg, monkeypatch):
    HQC, pub, priv = _keys(pkg)
    base_ct, _ = HQC.encaps_with_plaintext_and_r1(pub, bytes(HQC.new_plaintext()), [])
    monkeypatch.setattr(pkg.ot, "_measure_interleaved", lambda *a, **k: [100000.0 - 12000.0, 100000.0])
    params = pkg.Params(pkg.HQC, OUTER_DECODING_LIMIT=15, EPSILON=(0.9, 0.9), DECODE_EVERY=10, WEIGHT=3)

    def adopt(eps):
        params.EPSILON = eps

    ch = pkg.ot.TimingChannel(HQC, priv, base_ct, gap=9000, margin=1800, measure=8, rng=make_random_state(4),
                              recal_every=3, recal_trials=2, calibration_counts=(9, 10, 9, 10), on_update=adopt)
    recals = []
    for _ in range(4):
        ch.measure_success(base_ct)
        recals.append(ch.num_recals)
    return recals, params.EPSILON, ch.epsilon


def test_recalibration_auto_triggers_and_updates_attack_epsilon(monkeypatch):
    recals, attack_eps, eps = _both(_auto_recal, monkeypatch)
    assert recals == [0, 0, 0, 1]
    assert attack_eps == eps and eps[0] > 0.9 and eps[1] < 0.8


def _mock_profiling(pkg, monkeypatch, gap, cost):
    monkeypatch.setattr(pkg.ot, "profiling_oracle", lambda *a, **k: 0.0)
    monkeypatch.setattr(pkg.ot, "profiling_oracle_interleaved", lambda *a, **k: (100000.0, 100000.0 - gap, gap))
    monkeypatch.setattr(pkg.ot, "profile_expansion_cost", lambda *a, **k: (cost, 0, 0))
    monkeypatch.setattr(pkg.ot, "measure_garbage_expansion_distribution",
                        lambda *a, **k: {0: 0.9, 1: 0.08, 2: 0.015, 3: 0.005})


def _broken(pkg, monkeypatch):
    _mock_profiling(pkg, monkeypatch, 1000.0, 500.0)
    monkeypatch.setattr(pkg.ot.TimingChannel, "measure_success", lambda self, ct: True)  # acc_fail == 0
    HQC, pub, priv = _keys(pkg)
    with pytest.raises(RuntimeError, match="calibration failed") as err:
        pkg.ot.calibrate_timing_channel(HQC, make_random_state(1), pub, priv, measure=4, profile_measurements=2**4,
                                        calibration_trials=5, max_calibration_attempts=2)
    return str(err.value)


def test_calibration_rejects_broken_channel(monkeypatch):
    _both(_broken, monkeypatch)


def _healthy(pkg, monkeypatch):
    _mock_profiling(pkg, monkeypatch, 7200.0, 3600.0)
    base, probes = {}, {"identical": 0, "modified": 0}

    def fake_measure(self, ct):
        if bytes(ct) == base["ct"]:
            probes["identical"] += 1
            return True
        probes["modified"] += 1
        return probes["modified"] > 10  # calibration measures the 10 fail probes first

    orig_init = pkg.ot.TimingChannel.__init__

    def spy_init(self, HQC_, priv_, base_ct, gap, **kw):
        base["ct"] = bytes(base_ct)
        return orig_init(self, HQC_, priv_, base_ct, gap, **kw)

    monkeypatch.setattr(pkg.ot.TimingChannel, "measure_success", fake_measure)
    monkeypatch.setattr(pkg.ot.TimingChannel, "__init__", spy_init)
    HQC, pub, priv = _keys(pkg)
    rng = make_random_state(2)
    params, acc_fail, acc_success, ctnmod = pkg.ot.calibrate_timing_channel(
        HQC, rng, pub, priv, measure=4, profile_measurements=2**4, calibration_trials=10)
    params.pop("loadavg_at_calibration")
    return params, acc_fail, acc_success, bytes(ctnmod), probes, rng.get_state()[2]


def test_calibration_success_path(monkeypatch):
    params, acc_fail, acc_success, _ct, probes, _draws = _both(_healthy, monkeypatch)
    assert params["margin"] == pytest.approx(0.4 * 3600.0) and params["cost"] == pytest.approx(3600.0)
    assert params["fail_ceiling"] == pytest.approx(0.995)
    assert acc_fail == 1.0 and acc_success == 1.0
    assert probes == {"identical": 0, "modified": 20}  # the success class on modified probes


def _cap(pkg):
    oracle, params, _tracking, base_ct = _oracle(pkg)
    params.CERTAINTY_CAP = (0.9995, 0.9954)
    channel = MockChannel({base_ct: [True] * 10})
    oracle.timing = channel
    meta = {}
    result = oracle._amplify(raw=True, require=(0.9999, 0.9999), result_meta=meta, debug=False, vbit=None)
    del params.CERTAINTY_CAP
    channel2 = MockChannel({base_ct: [True] * 10})
    oracle.timing = channel2
    meta2 = {}
    oracle._amplify(raw=True, require=(0.9999, 0.9999), result_meta=meta2, debug=False, vbit=None)
    return result, len(channel.measured), meta["certainty"], len(channel2.measured), meta2["certainty"]


def test_certainty_cap_bounds_amplification():
    result, measured, certainty, measured2, certainty2 = _both(_cap)
    assert result is True and measured == 3 and certainty == pytest.approx(0.9954)
    assert measured2 == 5 and certainty2 > 0.9999


def _idealized(pkg):
    """Without a channel the one-sided product and no cap: the idealized
    backends' semantics."""
    oracle, _params, tracking, _ct = _oracle(pkg)
    oracle.timing = None
    metas = [{} for _ in range(20)]
    results = [oracle._amplify(raw=bool(i % 2), require=(0.999, 0.999), result_meta=m, debug=False)
               for i, m in enumerate(metas)]
    return results, [m["certainty"] for m in metas], tracking.num_oracle_calls


def test_idealized_amplification_unchanged():
    results, _certainties, calls = _both(_idealized)
    assert len(results) == 20 and calls >= 40


def test_state_dict_round_trip_and_helpers():
    ch = oracle_timing.TimingChannel(object(), b"", b"base", gap=9000, margin=1800, measure=64, recal_every=5)
    ch.num_decaps, ch.offset, ch.recal_history = 12, -300.0, [{"x": 1}]
    other = oracle_timing.TimingChannel(object(), b"", b"other", gap=1, measure=8)
    other.load_state_dict(ch.state_dict())
    assert other.state_dict() == ch.state_dict()
    assert sorted(ch.state_dict()) == sorted(jot.TimingChannel._STATE_FIELDS)
    other.rebase(b"new")
    assert other.base_ct == b"new"
    ch.record_truth(True, True)
    ch.record_truth(True, False)
    assert ch.empirical_accuracy() == (0.0, 1.0)
    assert oracle_timing.warn_if_host_busy(threshold=1e9) >= 0.0
    HQC, pub, priv = _keys(PORT)
    ct, _ = HQC.encaps_with_plaintext_and_r1(pub, bytes(HQC.new_plaintext()), [])
    probe = oracle_timing._success_probe_ct(HQC, make_random_state(5), ct)
    assert probe == jot._success_probe_ct(JaxHqc128(), make_random_state(5), ct) and probe != bytes(ct)
    pt2, *_ = HQC.decode_intermediates(probe, priv)
    assert bytes(pt2) == bytes(HQC.new_plaintext())  # within the correction radius: still decodes


def test_attack_takes_the_timing_arguments():
    ours = inspect.signature(attack.simulate_hqc_idealized_oracle).parameters
    theirs = inspect.signature(jattack.simulate_hqc_idealized_oracle).parameters
    timing = [k for k in theirs if k.startswith("timing_")]
    assert len(timing) == 7 and all(ours[k].default == theirs[k].default for k in timing)


def _modelled_calibration(pkg):
    """calibrate_timing_channel over the modelled cycle counter that
    chip_smoke.py's timing phase uses, on the fixture key."""
    HQC, pub, priv = _keys(pkg)
    with ModelledClock(type(HQC), seed=1) as clock:
        params, acc_fail, acc_success, ct = pkg.ot.calibrate_timing_channel(
            HQC, make_random_state(1), pub, priv, measure=64, profile_measurements=2**10, calibration_trials=40)
    return ({k: params[k] for k in ("gap", "cost", "margin", "fail_ceiling")}, acc_fail, acc_success, bytes(ct),
            clock.decapsulations)


def test_modelled_clock_calibration_equals_jax():
    """Exactly equal through both packages; the modelled channel separates
    the classes (each reads at least the guard's 0.85)."""
    params, acc_fail, acc_success, _ct, decaps = _both(_modelled_calibration)
    assert params["gap"] > 0 and params["margin"] == pytest.approx(0.4 * params["cost"])
    assert min(acc_fail, acc_success) >= 0.85 and decaps > 0


def _modelled_attack(pkg):
    """The seed-0 timing attack over the modelled counter, "general"
    decodes on the CPU, to just past 800 decisions."""
    kw = {"device": "cpu"} if pkg is PORT else {}
    with ModelledClock(pkg.HQC, seed=0):
        ok, tracking = pkg.attack.simulate_hqc_idealized_oracle(
            make_random_state(0), 50, 20, keyfile=KEY, max_oracle_calls=800, oracle_backend="timing",
            decode_backend="general", timing_profile_measurements=2**10, timing_calibration_trials=40,
            timing_recal_every=300, **kw)
    ch = tracking.timing_channel
    return (ok, tracking.num_oracle_calls, [d["success"] for d in tracking.decoder_stats], ch.num_decaps,
            ch.num_recals, ch.truth_total, ch.truth_agree, tuple(tracking.timing_calibration["initial_epsilon"]))


def test_modelled_timing_attack_equals_jax():
    """The timing branch end to end (calibration, differential decisions,
    recalibration, the Bayesian amplification with CERTAINTY_CAP, decodes):
    every decision, decode outcome and counter equal to the JAX package's."""
    ok, calls, successes, _decaps, recals, _total, _agree, _eps = _both(_modelled_attack)
    assert not ok and calls > 800 and successes and recals >= 1
