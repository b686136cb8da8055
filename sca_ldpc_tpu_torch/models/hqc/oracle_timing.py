"""Real timing-channel oracle backend for the HQC key-recovery attack.

Counterpart of the JAX package's ``models/hqc/oracle_timing.py``: host code
only (cycle counts around the native ``decaps``), the same decisions and
calibration.  The reference stops at *evaluating* its rejection-sampling timing oracle
(simulate/hqc_eval_oracle.py measures an accuracy-vs-measurements curve) and
runs the actual attack only against the idealized oracle with simulated
epsilon noise (simulate/hqc.py:809-871).  This module wires the measured
channel into the attack itself: with ``oracle_backend="timing"`` every
oracle decision comes from cycle-timed decapsulations of the native HQC
implementation (csrc/hqc_core.cpp), not from ground truth plus simulated
noise.

The channel is the one the reference characterizes (hqc.rs:175-200): decaps
re-encrypts with the decoded plaintext's randomness, and the attack plaintext
is chosen to need >=3 extra seed-expander expansions
(search_distinguishable_plaintext, hqc.py:96-124).  A decoding failure
re-encrypts a *different* (garbage) plaintext whose extra-expansion count is
that of a random plaintext — usually 0 or 1 — so failing decapsulations are
measurably faster.

Each oracle decision is a **drift-robust differential measurement** (see
eval_oracle.py): the probe ciphertext and the attack's known-good base
ciphertext are cycle-timed in interleaved chunks and the first-percentile
difference is compared against a decision margin of 0.4x ONE PROFILED
SEED-EXPANSION COST below the reference level (between the success
class and the nearest one-expansion-faster fail class).  With that boundary a failing
probe is misclassified only when its garbage re-encryption draws >= 3 extra
expansions (probability = the intrinsic channel ceiling, measured by
eval_oracle.measure_garbage_expansion_distribution), rather than >= 2 as
under a midpoint-of-class-gap rule.  Per-decision accuracy is
calibrated in-run; the attack absorbs the residual error exactly like
idealized epsilon noise — certainty amplification repeats measurements until
the required confidence, and the LDPC decode weighs each check by its
accumulated certainty.
"""

import logging
import time

from .eval_oracle import (
    _loadavg,
    _measure_interleaved,
    measure_garbage_expansion_distribution,
    modify_beyond_correction_limit,
    profile_expansion_cost,
    profiling_oracle,
    profiling_oracle_interleaved,
)

logger = logging.getLogger(__name__)


class TimingChannel:
    """Measured decryption-failure oracle.

    ``measure_success(ct)`` classifies one ciphertext by differential
    interleaved cycle timing against the known-success base ciphertext:
    True = "decapsulation re-encrypted the distinguishable plaintext"
    (decode success), False = decode failure.

    ``margin`` is the decision boundary in cycles: the probe is declared a
    failure when its first-percentile estimate is more than ``margin``
    cycles *below* the reference's.  The expansion-aware calibration sets it
    to 0.4x the per-seed-expansion cost; ``gap`` (the profiled class
    separation, positive: failures are faster) is kept for logging.

    **Mid-attack recalibration** (``recal_every`` > 0, needs ``rng``): the
    margin sits only 0.4 expansion-costs below the success level but 2.6
    below the fail level, so ambient-noise growth flips success probes ~6x
    more readily than fail probes (live success-class accuracy has been
    measured 0.03-0.10 below the start-of-attack calibration while the fail
    class held).  Every ``recal_every``
    decisions the channel re-measures ``recal_trials`` known-fail probes
    (``modify_beyond_correction_limit`` of the base — guaranteed decode
    failure, no key needed) and ``recal_trials`` known-success probes
    (``_success_probe_ct`` — within the correction radius of the unmodified
    base), then (a) re-centers the decision boundary on the measured
    success-class median (``offset``, clamped to +-0.5 expansion costs) and
    (b) refreshes ``epsilon`` from exponentially-decayed rolling per-class
    tallies seeded by the initial calibration.  ``on_update`` propagates the
    fresh EPSILON into the attack's Bayesian amplification, so per-check
    certainties track current conditions instead of a minutes-stale
    calibration window.
    """

    def __init__(self, HQC, priv, base_ct, gap, margin=None, measure=64,
                 chunk_cap=None, max_retries=8, rng=None, recal_every=0,
                 recal_trials=20, recal_decay=0.65, epsilon=None,
                 calibration_counts=None, on_update=None):
        self.HQC = HQC
        self.priv = priv
        self.base_ct = bytes(base_ct)
        self.gap = gap
        self.margin = gap / 2 if margin is None else margin
        self.measure = int(measure)
        self.chunk_cap = chunk_cap
        self.max_retries = max_retries
        # accounting / live ground-truth agreement stats
        self.num_measurements = 0
        self.num_decaps = 0
        self.truth_agree = [0, 0]  # indexed by true answer
        self.truth_total = [0, 0]
        # drift tracking
        self.offset = 0.0  # measured success-class level (cycles)
        self.rng = rng
        self.recal_every = int(recal_every)
        self.recal_trials = int(recal_trials)
        self.recal_decay = float(recal_decay)
        self.on_update = on_update
        self.epsilon = tuple(epsilon) if epsilon is not None else None
        if calibration_counts is not None:
            cf, nf, cs, ns = calibration_counts
        else:
            cf = nf = cs = ns = 0.0
        self._tallies = [float(cf), float(nf), float(cs), float(ns)]
        self._decisions_since_recal = 0
        self._in_recal = False
        self.num_recals = 0
        self.num_recal_decaps = 0
        self.recal_history = []

    #: Fields that fully capture the channel's mutable state (everything a
    #: mid-attack checkpoint must carry; the constructor arguments HQC/priv
    #: and the rng are re-supplied on resume).
    _STATE_FIELDS = (
        "base_ct", "gap", "margin", "measure", "chunk_cap", "max_retries",
        "num_measurements", "num_decaps", "truth_agree", "truth_total",
        "offset", "recal_every", "recal_trials", "recal_decay", "epsilon",
        "_tallies", "_decisions_since_recal", "num_recals",
        "num_recal_decaps", "recal_history",
    )

    def state_dict(self):
        """Picklable snapshot of the channel's mutable state (checkpoint
        support — see attack.simulate_hqc_idealized_oracle's
        ``checkpoint_path``)."""
        return {k: getattr(self, k) for k in self._STATE_FIELDS}

    def load_state_dict(self, state):
        """Restore a :meth:`state_dict` snapshot.  The absolute timing
        levels will have drifted across the checkpoint gap, so resuming
        callers should follow with :meth:`recalibrate` before trusting any
        decision (measurements are differential, but the success-level
        ``offset`` and rolling EPSILON are stale)."""
        for k in self._STATE_FIELDS:
            setattr(self, k, state[k])

    def rebase(self, base_ct):
        """Point the differential reference at a new attack ciphertext
        (called when the attack restarts with a fresh plaintext)."""
        self.base_ct = bytes(base_ct)

    def _chunk(self):
        chunk = max(16, self.measure // 8)
        if self.chunk_cap is not None:
            chunk = min(chunk, int(self.chunk_cap))
        return chunk

    def _measure_diff(self, ct):
        """Differential first-percentile estimate (probe minus reference),
        interleaved chunks, retried when no samples survive."""
        for _ in range(self.max_retries):
            t_probe, t_ref = _measure_interleaved(
                self.HQC, self.priv, [bytes(ct), self.base_ct],
                self.measure, self._chunk(),
            )
            self.num_measurements += 1
            self.num_decaps += 2 * self.measure
            if self._in_recal:
                self.num_recal_decaps += 2 * self.measure
            if t_probe is not None and t_ref is not None:
                return t_probe - t_ref
        raise RuntimeError(
            "timing channel: no usable samples after "
            f"{self.max_retries} measurement attempts (all discarded?)"
        )

    def _classify(self, diff):
        return (diff - self.offset) > -self.margin

    def measure_success(self, ct):
        if (self.recal_every and self.rng is not None and not self._in_recal
                and self._decisions_since_recal >= self.recal_every):
            self.recalibrate()
        self._decisions_since_recal += 1
        return self._classify(self._measure_diff(ct))

    def recalibrate(self, trials=None):
        """Mid-attack drift correction: measure known-class probes built
        from the current base ciphertext, re-center the decision boundary
        on the success class, and refresh the rolling per-class EPSILON.

        Both probe classes are attack-legitimate (no private key):
        ``modify_beyond_correction_limit`` guarantees a decode failure,
        ``_success_probe_ct`` stays within the correction radius of the
        unmodified base.  Cost: ``2 * trials`` decisions' worth of decaps
        per invocation (~3% overhead at the defaults)."""
        trials = int(trials if trials is not None else self.recal_trials)
        self._in_recal = True
        try:
            fail_diffs = [
                self._measure_diff(
                    modify_beyond_correction_limit(self.HQC, self.rng,
                                                   self.base_ct))
                for _ in range(trials)
            ]
            succ_diffs = [
                self._measure_diff(
                    _success_probe_ct(self.HQC, self.rng, self.base_ct))
                for _ in range(trials)
            ]
        finally:
            self._in_recal = False
            self._decisions_since_recal = 0
        med = sorted(succ_diffs)[len(succ_diffs) // 2]
        # The boundary tracks the measured success level, but only within
        # +-0.5 expansion costs (margin = 0.4 costs): a larger excursion
        # means the channel needs re-profiling, not re-centering, and the
        # clamp preserves >= 2 expansion costs of fail-class headroom.
        limit = 1.25 * self.margin
        self.offset = max(-limit, min(limit, med))
        correct_f = sum(1 for d in fail_diffs if not self._classify(d))
        correct_s = sum(1 for d in succ_diffs if self._classify(d))
        d = self.recal_decay
        t = self._tallies
        self._tallies = [d * t[0] + correct_f, d * t[1] + trials,
                         d * t[2] + correct_s, d * t[3] + trials]
        acc_f = self._tallies[0] / self._tallies[1]
        acc_s = self._tallies[2] / self._tallies[3]
        self.epsilon = (min(acc_f, 0.995), min(acc_s, 0.995))
        self.num_recals += 1
        self.recal_history.append({
            "window_acc_fail": correct_f / trials,
            "window_acc_success": correct_s / trials,
            "offset": self.offset,
            "epsilon": list(self.epsilon),
            # Ambient-condition covariate: the
            # attack process itself contributes ~1.0 to the 1-min load
            # average mid-run, so ambient co-tenant load ~= loadavg - 1.
            "loadavg": round(_loadavg(), 3),
            "unix_time": int(time.time()),
        })
        logger.info(
            f"Timing recalibration #{self.num_recals}: window acc "
            f"({correct_f / trials:.3f}, {correct_s / trials:.3f}), "
            f"success-level offset {med:.0f} -> {self.offset:.0f} cycles, "
            f"rolling EPSILON {self.epsilon}"
        )
        if min(acc_f, acc_s) < 0.55:
            logger.warning(
                "timing channel degraded below usable accuracy "
                f"({acc_f:.3f}, {acc_s:.3f}) — ambient noise likely "
                "exceeds the channel signal"
            )
        if self.on_update is not None:
            self.on_update(self.epsilon)

    def record_truth(self, reported, true_answer):
        """Track live agreement with the (cheating) ground-truth oracle —
        the attack's empirical per-class accuracy measurement."""
        t = int(bool(true_answer))
        self.truth_total[t] += 1
        if bool(reported) == bool(true_answer):
            self.truth_agree[t] += 1

    def empirical_accuracy(self):
        """(acc_when_true_is_failure, acc_when_true_is_success), None where
        unobserved."""
        return tuple(
            (self.truth_agree[i] / self.truth_total[i])
            if self.truth_total[i] else None
            for i in (0, 1)
        )


def warn_if_host_busy(threshold=0.6, context="timing measurement"):
    """Quiet-host guard (a concurrent test run has been seen to degrade a
    live attack's success class from ~0.85 to ~0.70).  Called before profiling /
    calibration starts, i.e. before this process itself drives the load
    average up.  Returns the load average so callers can record it."""
    load = _loadavg()
    if load > threshold:
        logger.warning(
            f"host load average is {load:.2f} at {context} start — "
            "concurrent compute corrupts cycle timing; expect degraded "
            "per-class accuracy"
        )
    return load


def _success_probe_ct(HQC, rng, base_ct):
    """A within-correction-limit modification of ``base_ct``: flips a few
    whole RM blocks (well inside the outer RS correction radius DELTA) plus
    a handful of stray bits, so decoding still succeeds.  This is what real
    attack success-probes look like — calibrating the success class on the
    byte-identical base ciphertext would hide any residual data-dependence
    of decode time."""
    from .attack import toggle_bits_in_v, toggle_outer_block

    N = HQC.params("N")
    N2 = HQC.params("N2")
    N1 = HQC.params("N1")
    DELTA = HQC.params("DELTA")
    nblocks = max(1, DELTA - 2)
    ct = bytes(base_ct)
    for block in rng.choice(N1, nblocks, replace=False):
        ct = toggle_outer_block(ct, int(block), N, N2)
    # stray bit indices live in the v part's N1*N2-bit space
    stray = [int(b) for b in rng.choice(N1 * N2, 4, replace=False)]
    return toggle_bits_in_v(ct, stray, N)


def calibrate_timing_channel(
    HQC,
    rng,
    pub,
    priv,
    measure=64,
    profile_measurements=2**14,
    calibration_trials=100,
    chunk_cap=None,
    max_profile_attempts=10,
    min_accuracy=0.85,
    max_calibration_attempts=4,
    pt_target=3,
):
    """Profile the timing channel and measure its per-class accuracy.

    Returns ``(channel_params, acc_fail, acc_success, calib_ct)`` where
    ``channel_params`` is a dict with the profiled ``gap``, per-expansion
    ``cost`` and decision ``margin``; ``acc_fail``/``acc_success`` are the
    empirical probabilities of correctly classifying a failing / succeeding
    ciphertext at ``measure`` measurements per decision (the attack's
    per-measurement EPSILON), and ``calib_ct`` is the unmodified ciphertext
    used.

    Profiling uses the interleaved drift-robust methodology
    (eval_oracle.profiling_oracle_interleaved); a non-positive gap (profile
    corrupted by ambient load) is retried.  The success class is calibrated
    against within-correction-limit *modified* ciphertexts (realistic
    attack probes), not the byte-identical base.  If either class accuracy
    comes out below ``min_accuracy`` the channel is re-profiled and
    re-calibrated — a broken or inverted channel must not silently feed
    the attack, and on this shared host a calibration window hit by an
    ambient-load burst reads 0.7-0.8 where quiet windows read 0.95-1.0,
    so retrying buys a representative EPSILON; after
    ``max_calibration_attempts`` failures this raises.
    """
    from .attack import search_distinguishable_plaintext

    start_load = warn_if_host_busy(context="channel profiling")
    logger.info(f"Host load average at profiling start: {start_load:.2f}")

    # Warm the caches / branch predictors like the reference's warmup phase.
    profiling_oracle(HQC, rng, pub, priv, "warmup", False, num_profiles=1,
                     measurements=min(profile_measurements, 2**13))

    garbage = measure_garbage_expansion_distribution(HQC, rng,
                                                     samples=2**15)
    ceiling = sum(p for k, p in garbage.items() if k < pt_target)
    logger.info(
        f"Garbage-expansion distribution: {garbage}; intrinsic fail-class "
        f"ceiling P(extra < {pt_target}) = {ceiling:.5f}"
    )

    last_err = None
    for calib_attempt in range(max_calibration_attempts):
        gap = None
        for attempt in range(max_profile_attempts):
            t_nmod, t_ymod, gap = profiling_oracle_interleaved(
                HQC, rng, pub, priv, measurements=profile_measurements
            )
            logger.info(
                f"Timing profile attempt {attempt}: nmod={t_nmod} "
                f"ymod={t_ymod} gap={gap}"
            )
            if gap is not None and gap > 0:
                break
        else:
            raise RuntimeError(
                f"timing channel profiling failed: no positive gap in "
                f"{max_profile_attempts} attempts (host too noisy?)"
            )

        for attempt in range(max_profile_attempts):
            cost, t_lo, t_hi = profile_expansion_cost(
                HQC, rng, pub, priv,
                measurements=min(profile_measurements, 2**14),
            )
            logger.info(f"Per-seedexpansion cost: {cost} cycles "
                        f"(lo {t_lo}, hi {t_hi})")
            if cost is not None and cost > 0:
                break
        else:
            raise RuntimeError(
                f"expansion-cost profiling failed: no positive cost in "
                f"{max_profile_attempts} attempts (host too noisy?)"
            )
        margin = 0.4 * cost  # see eval_oracle: between the success class and
        # the nearest (one-expansion-faster) fail class

        pt = search_distinguishable_plaintext(
            HQC, rng, target_additional_seedexpansions=pt_target
        )
        ctnmod, _ = HQC.encaps_with_plaintext_and_r1(pub, pt, [])
        channel = TimingChannel(HQC, priv, ctnmod, gap, margin=margin,
                                measure=measure, chunk_cap=chunk_cap)

        correct_fail = 0
        for _ in range(calibration_trials):
            ctymod = modify_beyond_correction_limit(HQC, rng, ctnmod)
            if not channel.measure_success(ctymod):
                correct_fail += 1
        correct_succ = 0
        for _ in range(calibration_trials):
            ctok = _success_probe_ct(HQC, rng, ctnmod)
            if channel.measure_success(ctok):
                correct_succ += 1

        acc_fail = correct_fail / calibration_trials
        acc_success = correct_succ / calibration_trials
        logger.info(
            f"Timing channel calibration at {measure} measurements/decision: "
            f"acc_fail={acc_fail:.3f} acc_success={acc_success:.3f} "
            f"(gap {gap}, expansion cost {cost}, margin {margin})"
        )
        if acc_fail >= min_accuracy and acc_success >= min_accuracy:
            params = {"gap": gap, "cost": cost, "margin": margin,
                      "garbage_distribution": garbage,
                      "fail_ceiling": ceiling,
                      "acc_fail": acc_fail, "acc_success": acc_success,
                      "calibration_trials": calibration_trials,
                      "loadavg_at_calibration": round(start_load, 3)}
            return params, acc_fail, acc_success, ctnmod
        last_err = (
            f"calibrated accuracy below {min_accuracy} (acc_fail={acc_fail}, "
            f"acc_success={acc_success}) — channel broken or host too noisy"
        )
        logger.warning(last_err + "; re-profiling")

    raise RuntimeError(f"timing channel calibration failed: {last_err}")
