"""Real timing-oracle evaluation against the native HQC implementation.

Counterpart of the JAX package's ``models/hqc/eval_oracle.py`` (host code
only), except that the load covariate counts only trials with an outcome.
Reference: simulate/hqc_eval_oracle.py.  Measures the rejection-sampling
timing side channel of decapsulation (the native decaps re-encrypts with the
decoded plaintext's randomness, csrc/hqc_core.cpp hqc_decaps): profiles
modified vs unmodified ciphertexts, derives a threshold, then sweeps oracle
accuracy against the number of measurements.

Two measurement-methodology improvements over the reference (both opt-out),
needed because this framework also targets shared/virtualized hosts where
ambient load drifts by more than the timing signal between measurement
epochs (the reference measured on an otherwise-idle laptop):

- **Interleaved profiling** (``profile_mode="interleaved"``): the modified
  and unmodified profile ciphertexts are measured in round-robin chunks
  instead of back-to-back phases (hqc_eval_oracle.py:39-56), so slow drift
  affects both classes equally and cancels in the threshold difference.
- **Differential trials** (``trial_mode="differential"``): each accuracy
  trial measures the probe ciphertext AND a known-unmodified reference
  ciphertext in interleaved chunks and classifies by their difference,
  cancelling epoch-scale drift between profiling and the (hours-long)
  trial sweep.  ``trial_mode="threshold"`` is the reference's absolute
  comparison (hqc_eval_oracle.py:94-112).
"""

import json
import logging
import os
import threading

from .attack import (
    read_or_generate_keypair,
    search_distinguishable_plaintext,
    toggle_bits_in_v,
)
from .model import Hqc128

logger = logging.getLogger(__name__)


def _loadavg():
    """1-minute load average, 0.0 where unsupported.  During a measurement
    run the measuring process itself contributes ~1.0, so ambient
    co-tenant load ~= loadavg - 1."""
    try:
        return os.getloadavg()[0]
    except (OSError, AttributeError):
        return 0.0


def modify_beyond_correction_limit(HQC, rng, ct):
    """Flip 3/4 of the bits in each of DELTA+1 RM blocks — beyond both the
    duplicated-RM(1,7) radius per block and the RS block-correction
    capacity, guaranteeing decoding failure.

    The reference's constants (hqc_eval_oracle.py:15-32: 288 bits in 16 of
    46 384-bit blocks) are HQC-128's geometry hardcoded — they decompose as
    NOISE = 3*n2/4, BLOCKS = delta+1 — and at HQC-192/256 they are NOT
    beyond the correction limit: the 288-bit flip windows land misaligned
    over 640-bit RM blocks, leaving most touched blocks within the
    duplicated-RM radius and the rest within the RS capacity (delta=16),
    so ~94% of "garbage" probes decode back to the original plaintext and
    time exactly like the reference.
    With the reference's constants HQC-192 calibrated at acc_fail 0.06-0.33
    (median fail-class differential ~+100 cycles ~= 0; the JAX package's
    scripts/hqc192_diagnostics.py, artifacts/hqc192_channel_diagnostics.json).
    At HQC-128 the derived values reproduce the reference's constants —
    and its RNG draw sequence — exactly."""
    BLOCK_SIZE = int(HQC.params("N2"))
    BLOCK_NUM = int(HQC.params("N1"))
    NOISE_PER_BLOCK = 3 * BLOCK_SIZE // 4
    BLOCKS_WITH_NOISE = int(HQC.params("DELTA")) + 1
    N = HQC.params("N")
    for block in rng.choice(BLOCK_NUM, BLOCKS_WITH_NOISE, replace=False):
        bits = [
            int(b) + BLOCK_SIZE * int(block)
            for b in rng.choice(BLOCK_SIZE, NOISE_PER_BLOCK, replace=False)
        ]
        ct = toggle_bits_in_v(ct, bits, N)
    return ct


def _percentile(samples, measure):
    """First-percentile estimator of the reference (hqc_eval_oracle.py:34-37):
    index ``measure // 100`` of the sorted cycle counts."""
    if not samples:
        return None
    return sorted(samples)[min(measure // 100, len(samples) - 1)]


def oracle(HQC, ct, priv, measure):
    """First-percentile of cycle-timed decapsulations (hqc_eval_oracle.py:34-37)."""
    with MEASUREMENT_LOCK:
        samples = HQC.decode_oracle(ct, priv, measure)
    return _percentile(samples, measure)


# Cycle-timed measurements are a host-global resource: two threads timing
# decapsulations concurrently corrupt each other's samples (cache/SMT/core
# contention).  Batched multi-instance timing attacks (batched.py with
# oracle_backend="timing") serialize every measurement block on this lock;
# single-instance runs pay one uncontended acquire per block.
MEASUREMENT_LOCK = threading.RLock()


def _measure_interleaved(HQC, priv, cts, measurements, chunk,
                         cycle_stats=False):
    """Measure every ciphertext in ``cts`` with ``measurements`` cycle-timed
    decapsulations each, in round-robin chunks (drift-cancelling), and return
    the per-ciphertext first-percentile estimates.

    With ``cycle_stats`` also returns the per-round-robin-cycle percentile
    estimates ``[n_cycles][n_cts]`` — paired within-cycle statistics whose
    differences are immune to drift slower than one cycle.

    The whole interleaved block holds MEASUREMENT_LOCK: the probe/reference
    chunks must be contiguous in time for drift cancellation, and
    measurements from concurrent attack instances must not interleave."""
    with MEASUREMENT_LOCK:
        return _measure_interleaved_locked(HQC, priv, cts, measurements,
                                           chunk, cycle_stats)


def _measure_interleaved_locked(HQC, priv, cts, measurements, chunk,
                                cycle_stats):
    samples = [[] for _ in cts]
    cycles = []
    done = 0
    while done < measurements:
        step = min(chunk, measurements - done)
        cyc = []
        for i, ct in enumerate(cts):
            s = HQC.decode_oracle(ct, priv, step)
            samples[i].extend(s)
            cyc.append(_percentile(s, step))
        cycles.append(cyc)
        done += step
    totals = [_percentile(s, measurements) for s in samples]
    if cycle_stats:
        return totals, cycles
    return totals


def _make_profile_ct(HQC, rng, pub, mod):
    pt = search_distinguishable_plaintext(
        HQC, rng, target_additional_seedexpansions=2 if mod else 3
    )
    ct, _ = HQC.encaps_with_plaintext_and_r1(pub, pt, [])
    if mod:
        ct = modify_beyond_correction_limit(HQC, rng, ct)
    return ct


def _make_expansion_ct(HQC, rng, pub, extra):
    """Unmodified ciphertext whose re-encryption needs EXACTLY ``extra``
    additional seed expansions (decodes successfully, so decaps re-encrypts
    that same plaintext).  Exactness matters: the >=-target search the
    attack uses would overshoot ~20% of the time and bias the per-expansion
    cost estimate."""
    ptlen = len(HQC.new_plaintext())
    while True:
        pt = rng.bytes(ptlen)
        if (HQC.num_rejections(pt) // 1000) - 3 == extra:
            ct, _ = HQC.encaps_with_plaintext_and_r1(pub, pt, [])
            return ct


def profile_expansion_cost(HQC, rng, pub, priv, measurements=2**14,
                           lo_extra=0, hi_extra=3, num_profiles=2,
                           chunk=2**10):
    """Measure the decapsulation-cycle cost of ONE extra seed expansion.

    ``num_profiles`` unmodified ciphertexts per class with EXACTLY
    ``lo_extra`` / ``hi_extra`` extra seed expansions are cycle-timed
    interleaved; the per-expansion cost is the median over round-robin
    cycles of the within-cycle class-mean first-percentile difference,
    divided by the expansion-count span.  The wide default span (0 vs 3)
    divides the measurement noise by 3 — single-expansion spans estimated
    the ~1.5-2k-cycle cost with +-1k-cycle run-to-run scatter on this host.
    This is the unit the expansion-aware decision rule
    (``decision_rule="expansion"``) needs: the timing floor of a
    decapsulation is ``base + extra * cost``.

    Returns ``(cost, t_lo, t_hi)`` (cost None if no usable samples).
    """
    cts = [_make_expansion_ct(HQC, rng, pub, lo_extra)
           for _ in range(num_profiles)]
    cts += [_make_expansion_ct(HQC, rng, pub, hi_extra)
            for _ in range(num_profiles)]
    totals, cycles = _measure_interleaved(
        HQC, priv, cts, measurements, chunk, cycle_stats=True
    )
    lo_ts = [t for t in totals[:num_profiles] if t is not None]
    hi_ts = [t for t in totals[num_profiles:] if t is not None]
    t_lo = sum(lo_ts) / len(lo_ts) if lo_ts else None
    t_hi = sum(hi_ts) / len(hi_ts) if hi_ts else None
    diffs = []
    for cyc in cycles:
        cl = [t for t in cyc[:num_profiles] if t is not None]
        ch = [t for t in cyc[num_profiles:] if t is not None]
        if cl and ch:
            diffs.append(sum(ch) / len(ch) - sum(cl) / len(cl))
    if not diffs:
        return None, t_lo, t_hi
    diffs.sort()
    cost = diffs[len(diffs) // 2] / (hi_extra - lo_extra)
    return cost, t_lo, t_hi


def measure_garbage_expansion_distribution(HQC, rng, samples=4096):
    """Empirical distribution of extra seed expansions for a *random*
    plaintext — the re-encryption a failing decapsulation performs.

    This is the intrinsic ceiling of the timing oracle: a failing probe
    whose garbage re-encryption happens to draw >= T extra expansions
    (T = the attack plaintext's count, normally 3) is indistinguishable
    from a success.  Returns ``{extra: probability}``.
    """
    ptlen = len(HQC.new_plaintext())
    counts = {}
    for _ in range(samples):
        extra = (HQC.num_rejections(rng.bytes(ptlen)) // 1000) - 3
        counts[extra] = counts.get(extra, 0) + 1
    return {k: v / samples for k, v in sorted(counts.items())}


def profiling_oracle(HQC, rng, pub, priv, why, mod, num_profiles=4,
                     measurements=2**16):
    """Sequential (reference-exact) profiling of one ciphertext class:
    average first-percentile over ``num_profiles`` fresh ciphertexts
    (hqc_eval_oracle.py:39-56)."""
    while True:
        logger.info(
            f"Doing {measurements * num_profiles} decapsulations for {why}. "
            f"Ciphertext modified: {mod}"
        )
        profs = []
        for _ in range(num_profiles):
            t = oracle(HQC, _make_profile_ct(HQC, rng, pub, mod), priv,
                       measurements)
            if t:
                profs.append(t)
        if profs:
            return sum(profs) / len(profs)


def profiling_oracle_interleaved(HQC, rng, pub, priv, num_profiles=4,
                                 measurements=2**16, chunk=2**11):
    """Drift-robust profiling: the modified and unmodified profile
    ciphertexts are measured in interleaved chunks.  Returns
    ``(t_nmod, t_ymod, gap)`` where t_* are class averages of the overall
    percentiles (the threshold level) and ``gap`` is the MEDIAN over
    round-robin cycles of the within-cycle class difference — drift slower
    than one cycle (~chunk x 2 x num_profiles decapsulations) cancels in
    each paired difference, and the median rejects burst-corrupted cycles."""
    logger.info(
        f"Interleaved profiling: {measurements} measurements x "
        f"{num_profiles} ciphertexts x 2 classes (chunk {chunk})"
    )
    cts = [_make_profile_ct(HQC, rng, pub, False) for _ in range(num_profiles)]
    cts += [_make_profile_ct(HQC, rng, pub, True) for _ in range(num_profiles)]
    ts, cycles = _measure_interleaved(HQC, priv, cts, measurements, chunk,
                                      cycle_stats=True)
    nmod = [t for t in ts[:num_profiles] if t is not None]
    ymod = [t for t in ts[num_profiles:] if t is not None]
    if not nmod or not ymod:
        return None, None, None
    diffs = []
    for cyc in cycles:
        cn = [t for t in cyc[:num_profiles] if t is not None]
        cy = [t for t in cyc[num_profiles:] if t is not None]
        if cn and cy:
            diffs.append(sum(cn) / len(cn) - sum(cy) / len(cy))
    diffs.sort()
    gap = diffs[len(diffs) // 2] if diffs else None
    return sum(nmod) / len(nmod), sum(ymod) / len(ymod), gap


def _load_state(state_file):
    if state_file and os.path.exists(state_file):
        with open(state_file) as f:
            return json.load(f)
    return {}


def _save_state(state_file, state):
    if not state_file:
        return
    tmp = state_file + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, state_file)


def _write_csv(csv_output, state, trial_mode):
    """Write the accuracy curve of every level with data so far.  Called at
    each checkpoint so long sweeps always leave a (partial) curve artifact,
    not only on completion."""
    if not csv_output:
        return
    per_decision = 2 if trial_mode == "differential" else 1
    rows = sorted(
        (int(m), lev) for m, lev in state.get("levels", {}).items()
        if lev.get("counted")
    )
    tmp = csv_output + ".tmp"
    with open(tmp, "w") as f:
        # quiet_* columns decompose by the per-trial ambient-condition
        # covariate (quiet-window and degraded measurements summed into one
        # number understate the channel and cannot be compared across
        # levels).  Empty for levels measured before the covariate existed.
        f.write("measurements,accuracy,trials,decaps_per_decision,"
                "quiet_accuracy,quiet_trials,mean_loadavg\n")
        for m, lev in rows:
            acc = lev["correct"] / lev["counted"]
            qc, qn = lev.get("quiet_correct"), lev.get("quiet_counted")
            q_acc = "" if not qn else f"{qc / qn}"
            q_n = "" if qn is None else f"{qn}"
            ls, ln = lev.get("load_sum"), lev.get("load_counted")
            mload = "" if not ln else f"{ls / ln:.3f}"
            f.write(f"{m},{acc},{lev['counted']},{per_decision * m},"
                    f"{q_acc},{q_n},{mload}\n")
    os.replace(tmp, csv_output)


def hqc_eval_oracle(
    rng,
    keyfile=None,
    num_trials=1000,
    max_log2_measurements=18,
    profile_measurements=2**16,
    reduced_trials=None,
    reduced_from_log2=13,
    state_file=None,
    checkpoint_every=50,
    profile_mode="interleaved",
    trial_mode="differential",
    csv_output=None,
    chunk_cap=None,
    decision_rule="expansion",
    only_levels=None,
    quiet_load_threshold=1.35,
):
    """Full oracle-accuracy evaluation; returns {measurements: accuracy}.

    ``only_levels``: optional collection of measurement counts — other
    levels are left untouched in the state/CSV (used to re-measure
    specific contested levels to a higher trial target without first
    topping up every smaller level).

    ``quiet_load_threshold``: per-trial ambient-condition covariate cutoff
    (1-min load average; this process contributes ~1.0 while measuring).
    Trials at or above it still count toward the overall accuracy but are
    excluded from the CSV's quiet_* columns, so quiet-window channel
    quality and shared-host weather stop being summed into one number
    (an accuracy curve that inverts between levels can be exactly such a
    conflation).  The covariate (``load_sum``/``load_counted``) counts only
    trials with an outcome, as the quiet columns do.

    Long runs (the reference sweeps to 2^17 measurements x 1000 trials,
    hqc_eval_oracle.py:94-112) are made practical by:

    - ``reduced_trials``/``reduced_from_log2``: measurement counts at or
      above 2**reduced_from_log2 use the (smaller) reduced trial count —
      accuracy there saturates near 1, so fewer trials lose little precision.
    - ``state_file``: JSON checkpoint holding the profiling threshold and
      per-level partial tallies; a restarted run resumes mid-level.  The
      threshold is only reusable with the same ``keyfile`` keypair.

    ``profile_mode``/``trial_mode`` select the drift-robust methodology
    (module docstring); ``("sequential", "threshold")`` reproduces the
    reference exactly.

    ``decision_rule`` (differential mode only):

    - ``"expansion"`` (default): classify by whether the probe's timing
      floor is within half an *expansion cost* of the reference's — the
      boundary sits 0.5 seed-expansions below the reference level, so a
      failing probe is misread only when its garbage re-encryption draws
      >= 3 extra expansions (the attack plaintext's own count).  The
      per-expansion cost is profiled directly (profile_expansion_cost).
    - ``"midpoint"``: boundary at half the profiled
      *class gap* (~1.2 expansions below reference, since the failing
      class averages ~1 extra expansion).  That misreads every garbage
      re-encryption with >= 2 extra expansions (~10%), and those probes
      converge to the wrong side as measurements grow: the cause of the
      non-monotone accuracy tail that rule gives.
    """
    import hashlib

    from .model import lib_fingerprint

    HQC = Hqc128()
    measurements_list = [2**x for x in range(max_log2_measurements)]
    if only_levels is not None:
        only_levels = {int(m) for m in only_levels}
        unknown = only_levels - set(measurements_list)
        if unknown:
            # A typo'd level (e.g. 1000) would otherwise silently no-op
            # and return an empty results dict.
            raise ValueError(
                f"only_levels entries {sorted(unknown)} match no sweep "
                f"level; levels are powers of two up to "
                f"2^{max_log2_measurements - 1}: {measurements_list}"
            )

    pub, priv = read_or_generate_keypair(HQC, keyfile)
    key_fp = hashlib.sha256(bytes(pub) + bytes(priv)).hexdigest()
    lib_fp = lib_fingerprint()

    state = _load_state(state_file)
    if state and "threshold" in state:
        # Refuse to resume tallies whose decision rule or environment no
        # longer matches: mixed rules corrupt every resumed level.
        if "trial_mode" not in state or "gap" not in state:
            raise ValueError(
                f"state file {state_file} predates trial-mode/gap recording; "
                "its tallies cannot be safely resumed — delete it to restart"
            )
        if state["trial_mode"] != trial_mode:
            raise ValueError(
                f"state file {state_file} was recorded with trial_mode="
                f"{state['trial_mode']!r}; refusing to mix with {trial_mode!r}"
            )
        if state.setdefault("decision_rule", "midpoint") != decision_rule:
            raise ValueError(
                f"state file {state_file} was recorded with decision_rule="
                f"{state['decision_rule']!r}; refusing to mix with "
                f"{decision_rule!r}"
            )
        if state.setdefault("chunk_cap", None) != chunk_cap:
            raise ValueError(
                f"state file {state_file} was recorded with chunk_cap="
                f"{state['chunk_cap']!r}; refusing to mix with {chunk_cap!r}"
            )
        if state.get("key_fingerprint") not in (None, key_fp):
            raise ValueError(
                f"state file {state_file} was profiled with a different "
                "keypair (the key file was regenerated?); delete it to restart"
            )
        if state.get("lib_fingerprint") not in (None, lib_fp):
            # Absolute thresholds are binary-specific; differential gaps
            # survive uniform timing shifts.
            msg = (f"state file {state_file} was profiled with a different "
                   "libhqc_core.so build")
            if trial_mode == "threshold":
                raise ValueError(msg + "; its absolute threshold is stale — "
                                 "delete it to restart")
            logger.warning(msg + "; continuing (differential decisions are "
                           "level-shift immune)")
        for fp_key, fp in (("key_fingerprint", key_fp),
                           ("lib_fingerprint", lib_fp)):
            if state.get(fp_key) is None:
                logger.warning(f"state file predates {fp_key}; adopting the "
                               "current value")
                state[fp_key] = fp
    if decision_rule not in ("expansion", "midpoint"):
        raise ValueError(f"unknown decision_rule: {decision_rule!r}")
    if trial_mode != "differential":
        # The expansion boundary is relative to the reference ciphertext's
        # level; threshold mode uses the reference's absolute rule.
        decision_rule = "midpoint"

    if "threshold" in state:
        threshold = state["threshold"]
        gap = state["gap"]
        margin = state.get("margin", gap / 2)
        logger.info(
            f"Resuming with checkpointed threshold {threshold}, gap {gap}, "
            f"margin {margin}"
        )
    else:
        profiling_oracle(HQC, rng, pub, priv, "warmup", False, num_profiles=1,
                         measurements=min(profile_measurements, 2**14))

        gap = 0
        while gap is None or gap <= 0:
            if profile_mode == "interleaved":
                t_nmod, t_ymod, gap = profiling_oracle_interleaved(
                    HQC, rng, pub, priv, measurements=profile_measurements
                )
                if t_nmod is None:
                    continue
            else:
                t_nmod = profiling_oracle(HQC, rng, pub, priv,
                                          "profile phase 1", False,
                                          measurements=profile_measurements)
                t_ymod = profiling_oracle(HQC, rng, pub, priv,
                                          "profile phase 2", True,
                                          measurements=profile_measurements)
                gap = t_nmod - t_ymod
            logger.info(f"Profiling result (nmod): {t_nmod}")
            logger.info(f"Profiling result (ymod): {t_ymod}")
            logger.info(f"Profiling gap nmod - ymod: {gap} "
                        f"(levels diff {t_nmod - t_ymod})")

        threshold = t_nmod - gap / 2
        logger.info(f"Profiling threshold: {threshold}")

        margin = gap / 2
        expansion_cost = None
        if decision_rule == "expansion":
            for _ in range(10):
                expansion_cost, t_lo, t_hi = profile_expansion_cost(
                    HQC, rng, pub, priv,
                    measurements=min(profile_measurements, 2**14),
                )
                logger.info(
                    f"Per-seedexpansion cost: {expansion_cost} cycles "
                    f"(lo {t_lo}, hi {t_hi})"
                )
                if expansion_cost is not None and expansion_cost > 0:
                    break
            else:
                raise RuntimeError(
                    "expansion-cost profiling failed (no positive cost); "
                    "host too noisy — retry or use decision_rule='midpoint'"
                )
            # 0.4x: midway between the success class (probe-position offset
            # +~300 cycles, sigma a few hundred) and the nearest fail class
            # (one block-aligned expansion = 2 Keccak permutations below);
            # robust to the +-30% run-to-run scatter of the cost estimate.
            margin = 0.4 * expansion_cost
            garbage = measure_garbage_expansion_distribution(HQC, rng)
            ceiling = sum(p for k, p in garbage.items() if k < 3)
            logger.info(
                f"Garbage-expansion distribution: {garbage}; predicted "
                f"fail-class accuracy ceiling P(extra < 3) = {ceiling:.4f}"
            )

        state = {"threshold": threshold, "t_nmod": t_nmod, "t_ymod": t_ymod,
                 "gap": gap, "trial_mode": trial_mode, "chunk_cap": chunk_cap,
                 "decision_rule": decision_rule, "margin": margin,
                 "expansion_cost": expansion_cost,
                 "key_fingerprint": key_fp, "lib_fingerprint": lib_fp,
                 "profile_measurements": profile_measurements, "levels": {}}
        _save_state(state_file, state)

    levels = state.setdefault("levels", {})

    pt = search_distinguishable_plaintext(HQC, rng)
    ctnmod, _ = HQC.encaps_with_plaintext_and_r1(pub, pt, [])

    def trial(measure):
        """One accuracy trial: classify a fresh beyond-correction-limit
        ciphertext from ``measure`` measurements of it.  Returns 1.0 on a
        correct 'modified' call, 0.0 otherwise, None if no samples survived.

        NOTE: differential mode additionally spends ``measure``
        decapsulations on the reference ciphertext, so one decision costs
        2x measure decaps (the CSV records decaps_per_decision)."""
        ctymod = modify_beyond_correction_limit(HQC, rng, ctnmod)
        if trial_mode == "differential":
            # Drift cancels only across probe/ref chunk pairs; at high
            # measurement counts measure//8 chunks span seconds, longer
            # than ambient-load epochs.  chunk_cap bounds the interleave
            # granularity (None = the original measure//8 behavior).
            chunk = max(16, measure // 8)
            if chunk_cap is not None:
                chunk = min(chunk, int(chunk_cap))
            t_probe, t_ref = _measure_interleaved(
                HQC, priv, [ctymod, ctnmod], measure, chunk
            )
            if t_probe is None or t_ref is None:
                return None
            decision_unmodified = (t_probe - t_ref) > -margin
        else:
            t = oracle(HQC, ctymod, priv, measure)
            if t is None:
                return None
            decision_unmodified = t >= threshold
        return float(decision_unmodified == False)  # noqa: E712

    results = {}
    for log2m, measure in enumerate(measurements_list):
        if only_levels is not None and measure not in only_levels:
            continue
        target = num_trials
        if reduced_trials is not None and log2m >= reduced_from_log2:
            target = reduced_trials
        lev = levels.setdefault(str(measure), {"done": 0, "correct": 0.0,
                                               "counted": 0})
        # Checkpoint roughly every ~2^17 decapsulations, at least every
        # `checkpoint_every` trials.
        ckpt = max(1, min(checkpoint_every, 2**17 // measure))
        while lev["done"] < target:
            outcome = trial(measure)
            lev["done"] += 1
            # Ambient-condition covariate: sampled after the trial, so the
            # 1-min load average has had the trial's own span to absorb
            # any co-tenant burst.  "quiet" = ambient below
            # quiet_load_threshold - 1 (this process contributes ~1.0).
            if outcome is not None:  # a discarded trial adds to no tally
                load = _loadavg()
                lev["load_sum"] = lev.get("load_sum", 0.0) + load
                lev["load_counted"] = lev.get("load_counted", 0) + 1
                lev["correct"] += outcome
                lev["counted"] += 1
                if load < quiet_load_threshold:
                    lev["quiet_correct"] = lev.get("quiet_correct", 0.0) + outcome
                    lev["quiet_counted"] = lev.get("quiet_counted", 0) + 1
            if lev["done"] % ckpt == 0:
                _save_state(state_file, state)
                _write_csv(csv_output, state, trial_mode)
        acc = lev["correct"] / lev["counted"] if lev["counted"] else 0.0
        results[measure] = acc
        _save_state(state_file, state)
        logger.info(f"Oracle with {measure} measurements: accuracy {acc} "
                    f"({lev['counted']} trials)")
    _write_csv(csv_output, state, trial_mode)
    return results
