"""HQC key-recovery attack with an idealized or a measured decoding oracle.

Counterpart of the JAX package's ``models/hqc/attack.py`` (the reference's
flagship workload, simulate/hqc.py:987-1167 and its helpers).  The adaptive
chosen-ciphertext search (block/bit flipping against the decoding-failure
edge) is sequential and stays on the host; the periodic LDPC decode of the
accumulated parity checks runs on ``device``:

- ``decode_backend="general"``: :class:`CheckDecoder`, a checks-only
  ``[H-rows | I]`` through :class:`~sca_ldpc_tpu_torch.ops.binary_bp.BinaryBPDecoder`
  (plain PyTorch);
- ``"padded"``: :class:`PaddedCheckDecoder`, the same decode at a fixed check
  capacity with inert padding rows;
- ``"circulant"``: :class:`MaskedCirculantCheckDecoder`, the full circulant
  of every plaintext with a measured-row mask, through
  ``ops.circulant_bp._multi_circulant_bp`` (the CUDA kernel K8 on the card).

Design deviations from the reference (behavior-preserving unless noted):

- The oracle owns the evolving ciphertext; probes and flips go through it.
  Two backends: ``native`` decapsulates via csrc/hqc_core.cpp per query
  (reference semantics, hqc.py:809-871); ``fast`` (default) answers via
  incremental Walsh-spectrum updates (oracle_fast.py) — one decapsulation
  per plaintext instead of one per probe — with optional continuous
  cross-checking against the native path.  The third, ``timing``, answers
  from cycle-timed decapsulations (oracle_timing.py).
- The decode matrix ``[Hgen-rows | I]`` is never materialized densely: check
  rows are rows of a circulant, so the layout is built directly from (bit
  index, circulant support) pairs (hqc.py:680 builds a dense vstack).
- The reference's epsilon tuple carries a trailing-comma bug
  (hqc.py:1005-1008 assigns ``((a, b),)``); we implement the evident intent
  ``(a, b)``.

Unlike the JAX package, the general decode pads no check rows (XLA compiled
once per 256-row bucket; PyTorch has no per-shape compile, and inert rows
leave the decisions unchanged), and a checkpoint also records ``error_rate``
and ``crosscheck_every``, so a resume under another noise level is refused.
"""

import logging
import os
import pickle
import time
from math import isnan, prod

import numpy as np
import torch

from ...codes.layout import CodeLayout
from ...codes.make_code import random_circulant_first_row
from ...ops.binary_bp import BinaryBPDecoder
from ...ops.circulant_bp import _multi_circulant_bp
from ...utils import make_random_state
from .model import Hqc128, Hqc192, Hqc256
from .tracking import (
    FlipStatus,
    HqcSimulationParams,
    HqcSimulationTracking,
    IfFlipResult,
    NoMoreUntestedRmBlocks,
)

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Sparse GF(2)[x]/(x^N - 1) helpers (reference: hqc.py:924-950, 1172-1198)
# ---------------------------------------------------------------------------


def sparse_times_sparse(A, B, N, mod=2):
    """Cyclic product of two sparse vectors (index lists).

    >>> sparse_times_sparse([3, 5, 9], [0, 2], N=10, mod=None)
    [1, 3, 5, 5, 7, 9]
    >>> sparse_times_sparse([3, 5, 9], [0, 2], N=10, mod=2)
    [1, 3, 7, 9]
    """
    out = []
    for b in B:
        out.extend((a + b) % N for a in A)
    if mod:
        from collections import Counter

        counts = Counter(out)
        out = [k for k, v in counts.items() for _ in range(v % mod)]
    out.sort()
    return out


def shift_and_add_mod_2_sparse(y, j, n):
    """y + (y <<rot j) over GF(2), sparse form.

    >>> shift_and_add_mod_2_sparse([1, 5, 8, 12], 3, 15)
    [0, 1, 4, 5, 11, 12]
    """
    merged = sorted(y + [(yi + j) % n for yi in y])
    out = []
    i = 0
    while i < len(merged):
        if i + 1 < len(merged) and merged[i] == merged[i + 1]:
            i += 2
        else:
            out.append(merged[i])
            i += 1
    return out


# ---------------------------------------------------------------------------
# Ciphertext bit manipulation (reference: hqc.py:127-158, 373-377)
# ---------------------------------------------------------------------------


def toggle_bits_in_v(ciphertext, bits, u_size):
    """Flip bits of the v part (bit indexing skips the byte-aligned u part).

    >>> toggle_bits_in_v(bytearray((0xff, 0xff, 0xff)), [0, 6], 9).hex()
    'ffffbe'
    """
    ct = bytearray(ciphertext)
    startat = u_size + (8 - (u_size % 8))
    for bit in bits:
        pos = bit + startat
        ct[pos // 8] ^= 1 << (bit % 8)
    return ct


def toggle_outer_block(ciphertext, block, u_size, block_size):
    """Flip one whole N2-bit outer (RM) block of v.

    >>> toggle_outer_block(bytearray((0xff, 0xff, 0xfe, 0xfe)), 0, 9, 10).hex()
    'ffff01fd'
    """
    return toggle_bits_in_v(
        ciphertext, range(block_size * block, block_size * (block + 1)), u_size
    )


def flip_single_bit(ct, block, bit, N, N2):
    return toggle_bits_in_v(ct, [block * N2 + bit], N)



# ---------------------------------------------------------------------------
# Keys and plaintexts (reference: hqc.py:74-124)
# ---------------------------------------------------------------------------


def read_or_generate_keypair(HQC, filename=None):
    if filename:
        if os.path.exists(filename):
            # An existing but unreadable/corrupt key file is an error, not a
            # cue to silently regenerate: an attack-vs-artifact comparison
            # would otherwise silently target the wrong key.
            with open(filename, "rb") as f:
                key = pickle.load(f)
            if (
                not isinstance(key, tuple)
                or len(key) != 2
                or not all(isinstance(k, (bytes, bytearray)) for k in key)
            ):
                raise ValueError(
                    f"key file {filename} does not contain an HQC "
                    "(public, private) byte pair"
                )
            logger.info(f"Loaded existing key from {filename}")
            return key
        key = HQC.keypair()  # randomness independent of --seed, like reference
        with open(filename, "wb") as f:
            pickle.dump(key, f)
        logger.info(f"Created random HQC keypair in {filename}")
        return key
    logger.info("Generating random HQC keypair (independent of provided seed)")
    return HQC.keypair()


def search_distinguishable_plaintext(HQC, rng, target_additional_seedexpansions=3,
                                     max_attempts=10**6):
    """Random-search a plaintext whose encryption randomness needs
    ``target`` extra seed expansions — the timing-distinguishable class.

    Matches hqc.py:96-124 (including the 3-expansion baseline).

    NOTE: in this implementation each of the three sampled vectors
    (r1, r2, e) overflows its rejection-sampling buffer AT MOST ONCE, so
    the extra-expansion count is Binomial(3, ~0.18) — measured frequencies
    {0: .548, 1: .367, 2: .079, 3: .0055} fit it exactly — and targets
    above 3 are unsatisfiable.  ``max_attempts`` turns that (or an
    astronomically rare target) into an error instead of an infinite loop.
    """
    ptlen = len(HQC.new_plaintext())
    distr = {}
    for attempt in range(max_attempts):
        pt = rng.bytes(ptlen)
        extra = (HQC.num_rejections(pt) // 1000) - 3
        distr[extra] = distr.get(extra, 0) + 1
        if extra >= target_additional_seedexpansions:
            logger.debug(f"Seedexpansion distribution: {distr}")
            logger.debug(f"Found distinguishable plaintext at attempt {attempt}")
            return pt
    raise RuntimeError(
        f"no plaintext with >= {target_additional_seedexpansions} extra "
        f"seed expansions in {max_attempts} attempts (observed "
        f"distribution: {distr}); the sampler's per-vector overflow cap "
        "makes targets > 3 unsatisfiable"
    )



# ---------------------------------------------------------------------------
# The oracle (reference: hqc.py:782-871)
# ---------------------------------------------------------------------------


class HqcOracle:
    """Idealized decoding oracle with epsilon false-positive/negative noise
    and certainty-amplified querying.  Owns the evolving attack ciphertext.

    ``epsilon = (p_keep_false, p_keep_true)``: probability the raw answer is
    NOT inverted, conditioned on the true answer (hqc.py:830-831, 859-864).

    With ``timing_channel`` set (oracle_timing.TimingChannel), answers come
    from **measured decapsulation timing** instead of ground-truth-plus-
    simulated-noise: every amplification repeat performs a fresh differential
    timing measurement, and EPSILON carries the channel's calibrated
    per-measurement accuracy.  The ground-truth backend keeps running
    underneath purely for live agreement statistics.
    """

    def __init__(self, params: HqcSimulationParams, tracking, priv, pt, rng, base_ct, backend="fast",
                 crosscheck_every=0, timing_channel=None):
        self.params = params
        self.tracking = tracking
        self.priv = priv
        self.pt = bytes(pt)
        self.rng = rng
        self.assert_raises = True
        self.ct = bytearray(base_ct)
        self.backend = backend
        self.crosscheck_every = crosscheck_every
        self.timing = timing_channel
        self._raw_count = 0
        self.state = None
        if backend == "fast":
            from .oracle_fast import FastCiphertextState

            self.state = FastCiphertextState.from_ciphertext(params, base_ct, priv, pt)

    # -- ciphertext mutations ------------------------------------------------

    def flip_block(self, block):
        self.ct = toggle_outer_block(self.ct, block, self.params.N, self.params.N2)
        if self.state is not None:
            self.state.toggle_block(block)

    def flip_bit(self, block, bit):
        self.ct = flip_single_bit(self.ct, block, bit, self.params.N, self.params.N2)
        if self.state is not None:
            self.state.toggle_bits([block * self.params.N2 + bit])

    # -- raw (noise-free) answers -------------------------------------------

    def _native_success(self, ct):
        pt_prime, *_ = self.params.HQC.decode_intermediates(ct, self.priv)
        return self.pt == bytes(pt_prime)

    def _raw(self, flipped_vbit=None):
        """True decoding result for the current ct, optionally with one
        additional (hypothetical) v-bit flipped."""
        self._raw_count += 1
        if self.state is not None:
            if flipped_vbit is None:
                result = self.state.decode_success()
            else:
                result = self.state.probe_bit(flipped_vbit)
            if self.crosscheck_every and self._raw_count % self.crosscheck_every == 0:
                ct = self.ct
                if flipped_vbit is not None:
                    ct = toggle_bits_in_v(ct, [flipped_vbit], self.params.N)
                native = self._native_success(ct)
                assert native == result, "fast oracle diverged from native decode"
            return result
        ct = self.ct
        if flipped_vbit is not None:
            ct = toggle_bits_in_v(ct, [flipped_vbit], self.params.N)
        return self._native_success(ct)

    # -- noisy, certainty-amplified queries ---------------------------------

    def _noisy(self, raw, debug, vbit=None):
        if self.timing is not None:
            ct = self.ct
            if vbit is not None:
                ct = toggle_bits_in_v(ct, [vbit], self.params.N)
            result = bool(self.timing.measure_success(ct))
            if not debug:
                self.tracking.num_oracle_calls += 1
            if raw is not None:
                self.timing.record_truth(result, raw)
            return result, self.params.EPSILON[int(result)]
        keep_rate = self.params.EPSILON[int(raw)]
        invert = self.rng.rand() > keep_rate
        result = raw
        if not debug:
            self.tracking.num_oracle_calls += 1
            if invert:
                logger.debug(f"Inverting oracle decision (originally {raw}), keep rate {keep_rate}")
                result = not result
        return result, keep_rate

    def _amplify(self, raw, require, result_meta, debug, vbit=None):
        """Certainty amplification of one raw answer under epsilon noise:
        repeat until 1 - prod(1 - p_i) of the winning side crosses its
        threshold (hqc.py:782-807).  Under a timing channel every repeat is
        a fresh measurement of the (ct, vbit) probe.

        Physical channels (timing backend) get two corrections the
        reference's iid heuristic lacks:

        - **Bayesian posterior instead of the one-sided product.**  The
          reference scores each side by 1 - prod(1 - p) over its own
          readings only, ignoring the other side's evidence; with
          disagreeing readings (True, False, True) it claims 0.99995 for
          True where the likelihood-ratio posterior over both classes is
          ~0.7.  Overconfident wrong checks poison the BP decode, so the
          timing path computes P(truth | k_true, k_false) from the
          calibrated per-class accuracies (noise IS conditionally iid
          given the truth; the heuristic stays for the idealized backends
          whose semantics it defines).
        - **CERTAINTY_CAP.**  Per-ciphertext systematic error: a failing
          probe whose garbage re-encryption draws >= 3 extra seed
          expansions reads "success" on every repeat (the calibrated fail
          ceiling, ~0.005).  Repeats of the SAME probe are correlated, so
          no amount of re-measurement supports certainty beyond the
          ceiling: the cap bounds both the amplification target and the
          reported certainty per result class."""
        cap = getattr(self.params, "CERTAINTY_CAP", None)
        bayesian = self.timing is not None
        acc_f, acc_t = self.params.EPSILON
        counts = [0, 0]
        collected = ([], [])
        while True:
            result, certainty = self._noisy(raw, debug, vbit=vbit)
            counts[result] += 1
            collected[result].append(certainty)
            if bayesian:
                k_t, k_f = counts[1], counts[0]
                lik_true = acc_t**k_t * (1.0 - acc_t) ** k_f
                lik_false = (1.0 - acc_f) ** k_t * acc_f**k_f
                post_true = lik_true / (lik_true + lik_false)
                result = post_true >= 0.5
                acc = post_true if result else 1.0 - post_true
            else:
                acc = 1.0 - prod(1.0 - p for p in collected[result])
            threshold = require[result]
            if cap is not None:
                acc = min(acc, cap[result])
                threshold = min(threshold, cap[result])
            if acc >= threshold:
                if isinstance(result_meta, dict):
                    result_meta["certainty"] = acc
                return result

    def query(self, require_false=0.5, require_true=0.5, result_meta=None, debug=False, flipped_bit=None):
        """Certainty-amplified query.  ``flipped_bit=(block, bit)`` probes a
        hypothetical single-bit modification without mutating the
        ciphertext."""
        vbit = None
        if flipped_bit is not None:
            block, bit = flipped_bit
            vbit = block * self.params.N2 + bit
        raw = self._raw(vbit)
        return self._amplify(raw, (require_false, require_true), result_meta, debug, vbit=vbit)

    def query_candidates(self, block, bits, require_false, require_true, metas):
        """Batch-probe single-bit flips of ``bits`` within ``block``: raw
        answers come from one vectorized spectrum update (fast backend);
        noise amplification runs per bit.  Returns [len(bits)] bools."""
        vbits = [block * self.params.N2 + b for b in bits]
        if self.state is not None:
            raws = self.state.probe_bits(vbits)
            prev = self._raw_count
            self._raw_count += len(vbits)
            ce = self.crosscheck_every
            if ce and vbits and prev // ce != self._raw_count // ce:
                # the batch crossed a checkpoint: native-verify one candidate
                ct = toggle_bits_in_v(self.ct, [vbits[0]], self.params.N)
                assert self._native_success(ct) == bool(raws[0]), (
                    "fast oracle diverged from native decode (batched probe)"
                )
        else:
            raws = [self._raw(v) for v in vbits]
        require = (require_false, require_true)
        return [self._amplify(bool(raw), require, meta, debug=False, vbit=v)
                for raw, meta, v in zip(raws, metas, vbits)]

    def assert_success(self, expect):
        """Validate the assumed oracle state at very high certainty;
        downgraded to a warning under epsilon noise (hqc.py:56-71).

        Returns True when the oracle agrees with the assumed state.  The
        search routines use a False return to RETRACT the decision that
        led here instead of continuing: one wrong high-certainty "failure"
        decision otherwise puts the state machine in a success-state
        ciphertext it believes is failing, and the whole block's probe
        harvest (hundreds of checks) comes out systematically wrong."""
        result = self.query(require_false=0.9999, require_true=0.9999, debug=True)
        if self.assert_raises:
            assert result == expect, f"oracle state assertion failed (expected {expect})"
        elif result != expect:
            logger.warning(f'Failed assertion "decoding success = {expect}"')
        return result == expect


# ---------------------------------------------------------------------------
# Block / bit search (reference: hqc.py:267-658)
# ---------------------------------------------------------------------------


def next_failure_block(params, tracking, oracle, rng):
    """Flip blocks up to OUTER_DECODING_LIMIT, then find one more whose flip
    tips decoding into failure (hqc.py:267-339)."""
    limit = params.OUTER_DECODING_LIMIT
    oracle.assert_success(True)

    evaluated = [
        i
        for i in range(params.N1)
        if tracking.block_status[i]["status"] == FlipStatus.UNFLIPPED
        and tracking.block_status[i]["result"] != IfFlipResult.UNKNOWN
    ]
    flipped = 0
    for block in rng.choice(evaluated, min(len(evaluated), limit), replace=False):
        flipped += 1
        logger.info(f"Flipping outer block {block} (evaluated)")
        oracle.flip_block(int(block))
        tracking.block_status[block]["status"] = FlipStatus.FLIPPED

    unknown = [
        i
        for i in range(params.N1)
        if tracking.block_status[i]["status"] == FlipStatus.UNFLIPPED
        and tracking.block_status[i]["result"] == IfFlipResult.UNKNOWN
    ]
    for block in rng.choice(unknown, len(unknown), replace=False):
        flipped += 1
        logger.info(f"Flipping outer block {block} (unknown)")
        oracle.flip_block(int(block))
        tracking.block_status[block]["status"] = FlipStatus.FLIPPED
        if flipped == limit:
            if not oracle.assert_success(True):
                # failing before the edge: an earlier block evaluation was
                # wrong — abandon this plaintext round rather than harvest
                # checks from an inconsistent state
                return None
        elif flipped == limit + 1:
            if not oracle.assert_success(False):
                # this flip did not actually tip decoding into failure:
                # retract it and keep searching
                logger.warning(
                    f"Retracting failure decision for block {block} "
                    "(state assertion contradicted)"
                )
                oracle.flip_block(int(block))
                tracking.block_status[block]["status"] = FlipStatus.UNFLIPPED
                flipped -= 1
                continue
            oracle.flip_block(int(block))
            tracking.block_status[block]["status"] = FlipStatus.UNFLIPPED
            tracking.block_status[block]["result"] = IfFlipResult.FAILURE
            logger.info(f"Decoding failure by flipping block {block}")
            return int(block)
    return None


def reset_full_block_flips(params, tracking, oracle):
    for block, bs in enumerate(tracking.block_status):
        if bs["status"] == FlipStatus.FLIPPED:
            oracle.flip_block(block)
            bs["status"] = FlipStatus.UNFLIPPED


def reset_current_block(params, tracking, oracle):
    for bit, b in enumerate(tracking.current_bits_status()):
        if b["status"] == FlipStatus.FLIPPED:
            oracle.flip_bit(tracking.current_block_nr, bit)
            b["status"] = FlipStatus.UNFLIPPED


def next_failure_bit(params, tracking, oracle, rng):
    """Flip unflipped bits of the current block until decoding fails
    (hqc.py:458-531).  Flipped-but-inconclusive bits stay flipped."""
    oracle.assert_success(True)
    bits = tracking.current_bits_status()
    available = [
        i
        for i, b in enumerate(bits)
        if b["result"] == IfFlipResult.UNKNOWN and b["status"] == FlipStatus.UNFLIPPED
    ]
    for bit in rng.choice(available, len(available), replace=False):
        bit = int(bit)
        oracle.flip_bit(tracking.current_block_nr, bit)
        bits[bit]["status"] = FlipStatus.FLIPPED
        if not oracle.query(require_false=0.99999, result_meta=bits[bit]):
            if not oracle.assert_success(False):
                # the failure reading was wrong (state still succeeds):
                # retract and keep searching — proceeding would harvest the
                # whole block's checks from a success-state ciphertext
                logger.warning(
                    f"Retracting failure decision for bit {bit} in block "
                    f"{tracking.current_block_nr} (state assertion "
                    "contradicted)"
                )
                continue
            bits[bit]["result"] = IfFlipResult.FAILURE
            logger.info(
                f"Decoding failure by flipping bit {bit} in block {tracking.current_block_nr}"
            )
            return bit
    return None


def find_minimal_failure_flips(params, tracking, oracle, save_results=True):
    """Strip the failure pattern to a minimal one; bits whose unflip restores
    success are check-value-0 information (hqc.py:534-605)."""
    if not oracle.assert_success(False):
        logger.warning(
            "Skipping minimal-failure-flip harvest: state assertion "
            "contradicted (not in a failure state)"
        )
        return []
    bits = tracking.current_bits_status()
    available = [
        i
        for i, b in enumerate(bits)
        if b["result"] == IfFlipResult.UNKNOWN and b["status"] == FlipStatus.FLIPPED
    ]
    successes = []
    for bit in available:
        if oracle.query(
            require_false=0.9999,
            require_true=0.99,
            result_meta=bits[bit],
            flipped_bit=(tracking.current_block_nr, bit),
        ):
            if save_results:
                bits[bit]["result"] = IfFlipResult.SUCCESS
                logger.info(
                    f"Decoding success if unflipping bit {bit} in block "
                    f"{tracking.current_block_nr} check = 0"
                )
                successes.append((bit, bits[bit]["certainty"]))
        else:
            # commit the unflip: fewer flips, still failing
            oracle.flip_bit(tracking.current_block_nr, bit)
            bits[bit]["status"] = FlipStatus.UNFLIPPED
    return successes


def find_successes_by_flipping(params, tracking, oracle):
    """From the minimal failure pattern, bits whose flip restores success are
    check-value-1 information (hqc.py:608-658)."""
    if not oracle.assert_success(False):
        logger.warning(
            "Skipping success-by-flipping harvest: state assertion "
            "contradicted (not in a failure state)"
        )
        return [], []
    bits = tracking.current_bits_status()
    available = [
        i
        for i, b in enumerate(bits)
        if b["result"] == IfFlipResult.UNKNOWN and b["status"] == FlipStatus.UNFLIPPED
    ]
    successes, failures = [], []
    answers = oracle.query_candidates(
        tracking.current_block_nr, available, 0.99, 0.999,
        [bits[b] for b in available],
    )
    for bit, ans in zip(available, answers):
        if ans:
            bits[bit]["result"] = IfFlipResult.SUCCESS
            logger.info(
                f"Decoding success if flipping bit {bit} in block "
                f"{tracking.current_block_nr} check = 1"
            )
            successes.append((bit, bits[bit]["certainty"]))
        else:
            bits[bit]["result"] = IfFlipResult.FAILURE
            failures.append((bit, bits[bit]["certainty"]))
    return successes, failures




# ---------------------------------------------------------------------------
# Check accumulation and the device decode (reference: hqc.py:661-759, 885-984)
# ---------------------------------------------------------------------------


class CheckDecoder:
    """Accumulates parity checks (rows of circulant generation matrices) and
    decodes ``[H-rows | I]`` with per-position priors on ``device``.

    Checks can originate from different plaintexts' circulants (the attack
    draws a fresh Hgen per plaintext while the check set persists,
    hqc.py:1039-1056), so each check stores its own support row.  H is never
    densified: the layout is built straight from the support lists, with one
    row a check (no padding rows unless a caller asks for them).
    """

    def __init__(self, params, device="cuda"):
        self.params = params
        self.device = torch.device(device)
        self.row_supports = []  # per check: sorted np.ndarray of column indices

    # -- checkpoint support (mid-attack resume) ------------------------------

    def state_dict(self):
        return {"row_supports": [np.asarray(s) for s in self.row_supports]}

    def load_state_dict(self, state):
        self.row_supports = [np.asarray(s) for s in state["row_supports"]]

    def add_row(self, shifts, bit_n):
        """Record the support of circulant row ``bit_n``:
        {(bit_n - k) mod N : k in shifts}."""
        sup = np.sort((int(bit_n) - np.asarray(shifts, dtype=np.int64)) % self.params.N)
        self.row_supports.append(sup)

    def needed_dv(self):
        """Max variable degree of the accumulated check rows."""
        if not self.row_supports:
            return 1
        counts = np.bincount(np.concatenate(self.row_supports), minlength=self.params.N)
        return max(1, int(counts.max()))

    def build_arrays(self, checks, y_sparse, r_pad=None, dv=None):
        """(layout, channel, msg) for the current check set; ``r_pad`` pads
        the check count with inert identity-only rows and ``dv`` fixes the
        variable degree (both for a fixed capacity)."""
        params = self.params
        N = params.N
        R = len(checks)
        assert R == len(self.row_supports)
        w = max(len(s) for s in self.row_supports)
        assert all(len(s) == w for s in self.row_supports), "mixed weights unsupported"
        R_pad = R if r_pad is None else r_pad

        cols_h = np.stack(self.row_supports)  # [R, w], already sorted
        rows = np.concatenate([np.repeat(np.arange(R), w + 1), np.arange(R, R_pad)])
        cols = np.concatenate(
            [
                np.concatenate([cols_h, (N + np.arange(R))[:, None]], axis=1).reshape(-1),
                N + np.arange(R, R_pad),
            ]
        )
        layout = CodeLayout.from_edges(R_pad, N + R_pad, rows, cols, dc=w + 1, dv=dv)

        prob_one = len(y_sparse) / N
        channel = np.empty(N + R_pad, dtype=np.float32)
        channel[:N] = prob_one
        channel[N : N + R] = [1.0 - p for (_c, p) in checks]
        channel[N + R :] = 1e-9  # inert padding rows: error prob ~ 0
        np.clip(channel, 1e-9, 1 - 1e-9, out=channel)

        msg = np.zeros(N + R_pad, dtype=np.int32)
        msg[N : N + R] = [c for (c, _p) in checks]
        return layout, channel, msg

    def stats_from_decoded(self, tracking, decoded, checks, y_sparse):
        """Statistics identical to hqc.py:709-758; returns success."""
        params = self.params
        N = params.N
        R = len(checks)
        good_flips = bad_flips = 0
        unsatisfied = 0
        found_bad_sat = found_bad_unsat = 0
        y_set = set(int(v) for v in y_sparse)
        decoded_y = decoded[:N]
        for i in np.flatnonzero(decoded_y):
            if int(i) in y_set:
                good_flips += 1
            else:
                bad_flips += 1
        for i, (c, _p) in enumerate(checks):
            x = decoded[N + i]
            if c:
                unsatisfied += 1
                if not x:
                    found_bad_unsat += 1
            elif x:
                found_bad_sat += 1

        success = set(np.flatnonzero(decoded_y).tolist()) == y_set
        logger.info(
            f"Decoded with {R} checks: {good_flips} good / {bad_flips} bad flips, "
            f"{found_bad_sat + found_bad_unsat} suspected measurement errors, "
            f"success={success}"
        )
        tracking.add_decoder_stats(R, unsatisfied, good_flips, bad_flips, found_bad_sat, found_bad_unsat, success)
        return success

    def _decode_general(self, tracking, checks, y_sparse, max_iter, method, r_pad=None, dv=None):
        layout, channel, msg = self.build_arrays(checks, y_sparse, r_pad=r_pad, dv=dv)
        dec = BinaryBPDecoder(layout, max_iter=max_iter, method=method, channel_probs=channel, device=self.device)
        decoded = dec.decode_received(msg).cpu().numpy()
        return self.stats_from_decoded(tracking, decoded, checks, y_sparse)

    def decode(self, tracking, checks, y_sparse, executor=None):
        if executor is not None:
            return executor.decode(self, tracking, checks, y_sparse)
        logger.info(f"Attempting decode with {len(checks)} checks.")
        return self._decode_general(tracking, checks, y_sparse, 100, "product_sum")


class PaddedCheckDecoder(CheckDecoder):
    """The general decode at a fixed check capacity (and a fixed cap on the
    variable degree) chosen at construction, the extra rows inert; capacities
    double when exceeded.  Gives the general decoder's results (the padding
    rows leave the decisions unchanged)."""

    def __init__(self, params, max_iter=100, method="product_sum", r_cap=4096, dv_cap=16, device="cuda"):
        super().__init__(params, device)
        self.max_iter = int(max_iter)
        self.method = method
        self.r_cap = int(r_cap)
        self.dv_cap = int(dv_cap)

    def state_dict(self):
        state = super().state_dict()
        state.update(r_cap=self.r_cap, dv_cap=self.dv_cap)
        return state

    def load_state_dict(self, state):
        super().load_state_dict(state)
        self.r_cap = int(state["r_cap"])
        self.dv_cap = int(state["dv_cap"])

    def decode(self, tracking, checks, y_sparse, executor=None):
        if executor is not None:
            return executor.decode(self, tracking, checks, y_sparse)
        while len(checks) > self.r_cap:
            self.r_cap *= 2
        dv = self.needed_dv()
        while dv > self.dv_cap:
            self.dv_cap *= 2
        logger.info(f"Attempting decode with {len(checks)} checks (fixed capacity {self.r_cap}, dv {self.dv_cap}).")
        return self._decode_general(tracking, checks, y_sparse, self.max_iter, self.method, self.r_cap, self.dv_cap)


class MaskedCirculantCheckDecoder(CheckDecoder):
    """Decodes the FULL circulant of every plaintext with a measured-row mask
    instead of rebuilding a checks-only H per decode.

    ``H = [[C_1];...;[C_P]] | I_{P*N}``: measured rows carry their check
    value (syndrome) and certainty (identity prior); unmeasured rows are
    inert (identity-prior LLR exactly 0).  Adding checks changes only array
    values (hqc.py:661-759 semantics otherwise).  The decode is
    ``_multi_circulant_bp``: the CUDA kernel K8 on a CUDA ``device``.
    """

    def __init__(self, params, max_iter=100, method="product_sum", device="cuda"):
        super().__init__(params, device)
        self.max_iter = int(max_iter)
        self.method = method
        self._blocks = {}  # shifts tuple -> block index
        self._block_shifts = []  # block index -> shifts tuple
        self._rows = []  # per check: (block index, bit_n)

    def state_dict(self):
        state = super().state_dict()
        state.update(block_shifts=list(self._block_shifts), rows=list(self._rows))
        return state

    def load_state_dict(self, state):
        super().load_state_dict(state)
        self._block_shifts = [tuple(s) for s in state["block_shifts"]]
        self._blocks = {s: i for i, s in enumerate(self._block_shifts)}
        self._rows = [(int(b), int(n)) for b, n in state["rows"]]

    def add_row(self, shifts, bit_n):
        super().add_row(shifts, bit_n)  # keep supports for an executor's general decode
        key = tuple(int(k) for k in np.asarray(shifts))
        if key not in self._blocks:
            if self._block_shifts:
                assert len(key) == len(self._block_shifts[0]), "mixed weights"
            self._blocks[key] = len(self._block_shifts)
            self._block_shifts.append(key)
        self._rows.append((self._blocks[key], int(bit_n)))

    def build_masked_arrays(self, checks, y_sparse, p_pad=None):
        """(prior_c [N], prior_i [P,N], syn [P,N], shifts [P,W]) for the
        current check set.  ``p_pad`` pads with all-inert extra blocks so
        independent instances can share one (N, P, W) shape."""
        params = self.params
        N = params.N
        R = len(checks)
        assert R == len(self._rows)
        P = p_pad if p_pad is not None else len(self._block_shifts)
        assert P >= len(self._block_shifts)
        W = len(self._block_shifts[0])

        syn = np.zeros((P, N), np.int32)
        prior_i = np.zeros((P, N), np.float32)  # LLR 0 == inert row
        seen = set()
        for (blk, bit), (c, certainty) in zip(self._rows, checks):
            assert (blk, bit) not in seen, "duplicate measured row"
            seen.add((blk, bit))
            syn[blk, bit] = int(c)
            p_err = min(max(1.0 - certainty, 1e-9), 1.0 - 1e-9)
            prior_i[blk, bit] = np.log((1.0 - p_err) / p_err)

        shifts = np.zeros((P, W), np.int32)
        shifts[: len(self._block_shifts)] = np.asarray(self._block_shifts, np.int32)

        prob_one = min(max(len(y_sparse) / N, 1e-9), 1.0 - 1e-9)
        prior_c = np.full(N, np.log((1.0 - prob_one) / prob_one), np.float32)
        return prior_c, prior_i, syn, shifts

    def stats_from_masked(self, tracking, e_c, e_i, checks, y_sparse):
        """Reassemble the [y | per-check indicator] vector stats expect.

        The general path's decoded[N+i] is the CORRECTED check word
        ``c_i XOR e_i`` (BinaryBPDecoder.decode_received returns (z+e)%2),
        so the identity-error bit must be xored with the measured value."""
        N = self.params.N
        R = len(checks)
        decoded = np.zeros(N + R, np.int32)
        decoded[:N] = e_c
        for i, ((blk, bit), (c, _p)) in enumerate(zip(self._rows, checks)):
            decoded[N + i] = int(c) ^ int(e_i[blk, bit])
        return self.stats_from_decoded(tracking, decoded, checks, y_sparse)

    def decode(self, tracking, checks, y_sparse, executor=None):
        if executor is not None:  # cross-instance batching
            return executor.decode(self, tracking, checks, y_sparse)
        prior_c, prior_i, syn, shifts = self.build_masked_arrays(checks, y_sparse)
        logger.info(
            f"Attempting masked-circulant decode with {len(checks)} checks "
            f"over {len(self._block_shifts)} plaintext block(s)."
        )
        dev = self.device
        e_c, e_i, _conv, _it = _multi_circulant_bp(
            torch.as_tensor(prior_c[None], device=dev),
            torch.as_tensor(prior_i[None], device=dev),
            torch.as_tensor(syn[None], device=dev),
            torch.as_tensor(shifts, device=dev),
            self.max_iter,
            self.method,
        )
        return self.stats_from_masked(tracking, e_c[0].cpu().numpy(), e_i[0].cpu().numpy(), checks, y_sparse)


def add_check(decoder, shifts, checks, y_times_r1, bit_n, check, certainty):
    """Record one measured parity check; warn on cheating-validated errors
    (hqc.py:885-908)."""
    if y_times_r1 is not None:
        bit_set = bit_n in y_times_r1
        if check != bit_set:
            lvl = logger.error if certainty == 1.0 else logger.warning
            lvl(f"Certainty {certainty} gave a false result for bit {bit_n}: check={check}, true value={bit_set}")
    logger.info(f"Adding to H the check={check} corresponding to bit {bit_n}.")
    decoder.add_row(shifts, bit_n)
    checks.append((check, certainty))


def add_checks(params, tracking, decoder: CheckDecoder, shifts, check_value, bits, checks, y_sparse, y_times_r1,
               executor=None):
    """Add measured bits as checks; attempt a decode every DECODE_EVERY
    (hqc.py:953-984), its wall time added to ``tracking.decode_seconds``.
    Returns True on key recovery."""
    previous_decoding = 0
    for b, certainty in bits:
        bit_n = tracking.current_block_nr * params.N2 + b
        add_check(decoder, shifts, checks, y_times_r1, bit_n, check_value, certainty)
        R = len(checks)
        if R % params.DECODE_EVERY == 0 and R != 0 and previous_decoding != R:
            previous_decoding = R
            unsatisfied = sum(c for (c, _p) in checks)
            timing = tracking.timing_channel
            # in timing mode each oracle call is one channel decision costing 2 x timing_measure decapsulations
            decaps_note = f" ({timing.num_decaps} timed decapsulations)" if timing is not None else ""
            logger.info(f"{tracking.num_oracle_calls} oracle calls so far{decaps_note}, {unsatisfied} unsatisfied "
                        f"checks out of {R}.")
            t0 = time.perf_counter()
            ok = decoder.decode(tracking, checks, y_sparse, executor=executor)
            tracking.decode_seconds += time.perf_counter() - t0
            if ok:
                logger.info("Successfully decoded y")
                return True
    return False


# ---------------------------------------------------------------------------
# Mid-attack checkpoint/resume
# ---------------------------------------------------------------------------
#
# The full attack state is host-side and picklable; checkpoints are taken at
# the "clean point" at the top of each inner block-search iteration, where
# the ciphertext equals the plaintext-round base (all block/bit flips
# reset), so resume only needs the round base ct plus the persistent state
# (rng stream, tracking state machine, accumulated checks/decoder rows).

CHECKPOINT_VERSION = 1


def save_attack_checkpoint(path, state):
    """Atomically pickle a checkpoint next to its final destination."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f)
    os.replace(tmp, path)


def _same(a, b):
    """Equal configuration values, NaN equal to NaN (``error_rate``)."""
    return a == b or (isinstance(a, float) and isinstance(b, float) and isnan(a) and isnan(b))


def load_attack_checkpoint(path, expect_config=None):
    """Load a checkpoint (this module's own pickle: unpickling runs code, so
    only load files this program wrote); verify it matches the resuming
    run's configuration (resuming under different attack parameters would be
    silently wrong)."""
    with open(path, "rb") as f:
        state = pickle.load(f)
    if state.get("version") != CHECKPOINT_VERSION:
        raise ValueError(f"checkpoint {path} has version {state.get('version')}, expected {CHECKPOINT_VERSION}")
    if expect_config is not None:
        mismatches = {
            k: (state["config"].get(k), v) for k, v in expect_config.items() if not _same(state["config"].get(k), v)
        }
        if mismatches:
            raise ValueError(f"checkpoint {path} was written under different attack parameters: {mismatches}")
    return state


# ---------------------------------------------------------------------------
# The attack (reference: hqc.py:987-1167)
# ---------------------------------------------------------------------------

PARAM_SETS = {
    "128": (Hqc128, 15),
    "192": (Hqc192, 16),
    "256": (Hqc256, 29),
}

DECODE_BACKENDS = {
    "general": CheckDecoder,
    "padded": PaddedCheckDecoder,
    "circulant": MaskedCirculantCheckDecoder,
}


def make_params(param_set, decode_every, weight, error_rate=0.0):
    noise = 1.0 - (0.0 if isnan(error_rate) else error_rate)
    if isnan(error_rate):
        epsilon = (1.0, 1.0)
    else:
        # Idealized-oracle accuracies from the CHES2022 characterization,
        # scaled by measurement noise (hqc.py:1002-1008 — minus its
        # trailing-comma tuple bug).
        epsilon = (0.9942 * noise, 1.0 * noise)
    HQC, limit = PARAM_SETS[str(param_set)]
    return HqcSimulationParams(
        HQC=HQC,
        OUTER_DECODING_LIMIT=limit,
        EPSILON=epsilon,
        DECODE_EVERY=decode_every,
        WEIGHT=weight,
    )


def simulate_hqc_idealized_oracle(
    rng,
    decode_every: int,
    weight: int,
    keyfile=None,
    error_rate=0.0,
    param_set="128",
    max_oracle_calls=None,
    oracle_backend="fast",
    crosscheck_every=1000,
    decode_executor=None,
    keypair=None,
    decode_backend="general",
    checkpoint_path=None,
    checkpoint_every_decisions=0,
    resume=False,
    timing_measure=64,
    timing_profile_measurements=2**14,
    timing_calibration_trials=100,
    timing_chunk_cap=None,
    timing_pt_target=3,
    timing_recal_every=1200,
    timing_recal_trials=20,
    device="cuda",
):
    """Full key-recovery attack.  Returns (success, tracking).

    ``oracle_backend``: "fast" answers probes via incremental Walsh-spectrum
    updates (one native decapsulation per plaintext), cross-checked against
    the native path every ``crosscheck_every`` raw queries; "native"
    decapsulates on every query like the reference; "timing" answers every
    query from **measured decapsulation timing** of the native implementation
    (oracle_timing.TimingChannel), the physical side channel the reference
    only characterizes (hqc_eval_oracle.py) but never attacks with.  EPSILON
    is then set from in-run calibration at ``timing_measure`` measurements
    per decision, and the fast ground-truth oracle runs underneath solely
    for live accuracy accounting (``tracking.timing_channel``).  In timing
    mode each oracle call costs ``2 * timing_measure`` real decapsulations
    (differential measurement); ``tracking.timing_channel.num_decaps``
    carries the physical-measurement count, while ``num_oracle_calls``
    (and the ``max_oracle_calls`` budget) keeps counting *decisions*.
    ``max_oracle_calls`` bounds the run (None = run to recovery).
    ``decode_executor`` lets an orchestrator batch decode calls across
    independent attack instances.  ``keypair`` supplies a pre-generated
    (pub, priv) pair, overriding ``keyfile``.  ``decode_backend``: "general"
    builds a checks-only [H|I] per decode (reference semantics); "padded" is
    the same decode at a fixed check capacity (PaddedCheckDecoder);
    "circulant" decodes the full circulant with a measured-row mask
    (MaskedCirculantCheckDecoder; the CUDA kernel K8 on the card).
    ``device``: where the decodes run; the default needs a CUDA device and
    raises without one.

    ``timing_pt_target``: extra seed expansions required of the attack
    plaintext in timing mode (default 3, like the reference, hqc.py:96-124:
    each of the three sampled vectors overflows its buffer at most once, so
    extras are Binomial(3, ~0.18) and P(garbage >= 3) ~ 0.0055 is the
    channel's intrinsic fail-class floor).  ``timing_recal_every`` /
    ``timing_recal_trials``: mid-attack drift recalibration cadence
    (decisions between recalibrations / known-class probes per class; 0
    disables; TimingChannel.recalibrate).  The other ``timing_*`` arguments
    go to oracle_timing.calibrate_timing_channel.

    ``checkpoint_path``: pickle the full attack state there at every clean
    point (top of each inner block-search iteration, where the ciphertext
    equals the plaintext-round base); ``checkpoint_every_decisions`` > 0
    rate-limits writes to once per that many oracle decisions.  With
    ``resume=True`` an existing checkpoint is loaded and the attack
    continues mid-round from it: the rng stream, tracking state machine,
    accumulated checks, decoder rows and timing-channel tallies are
    restored, the (pickled) keypair overrides ``keyfile``/``keypair``, and
    in timing mode the start-of-attack profiling is skipped in favor of the
    stored channel parameters plus one immediate recalibration (the channel
    has drifted across the gap).  A checkpoint written under other attack
    parameters (``error_rate`` and ``crosscheck_every`` included) is
    refused."""
    if oracle_backend not in ("fast", "native", "timing"):
        raise ValueError(f"unknown oracle_backend: {oracle_backend}")
    if decode_backend not in DECODE_BACKENDS:
        raise ValueError(f"unknown decode_backend: {decode_backend}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch.cuda.is_available() is False; "
                           'pass device="cpu" to decode on the CPU')
    rng = make_random_state(rng)
    params = make_params(param_set, decode_every, weight, error_rate)
    logger.info(f"Params {params}")
    tracking = HqcSimulationTracking(params)

    checkpoint_config = {
        "param_set": str(param_set), "decode_every": decode_every, "weight": weight,
        "oracle_backend": oracle_backend, "decode_backend": decode_backend,
        "error_rate": float(error_rate), "crosscheck_every": crosscheck_every,
        "timing_measure": timing_measure, "timing_pt_target": timing_pt_target,
    }
    ckpt = None
    if resume:
        if not (checkpoint_path and os.path.exists(checkpoint_path)):
            raise FileNotFoundError(f"resume requested but no checkpoint at {checkpoint_path}")
        ckpt = load_attack_checkpoint(checkpoint_path, checkpoint_config)
        logger.info(
            f"Resuming attack from {checkpoint_path}: {ckpt['tracking']['num_oracle_calls']} oracle decisions, "
            f"{len(ckpt['checks'])} checks accumulated"
        )

    if ckpt is not None:
        pub, priv = ckpt["keypair"]
        rng.set_state(ckpt["rng_state"])
    else:
        pub, priv = keypair if keypair is not None else read_or_generate_keypair(params.HQC, keyfile)

    timing_channel = None
    timing_params = None
    if oracle_backend == "timing" and ckpt is not None:
        timing_params = ckpt["timing_params"]
        params.EPSILON = tuple(ckpt["epsilon"])
        if ckpt["certainty_cap"] is not None:
            params.CERTAINTY_CAP = tuple(ckpt["certainty_cap"])
        tracking.timing_calibration = ckpt["tracking"]["timing_calibration"]
    elif oracle_backend == "timing":
        from .oracle_timing import calibrate_timing_channel

        # calibrate_timing_channel re-profiles and ultimately raises if either
        # class accuracy stays below its floor: a broken or inverted channel
        # must not feed the attack.
        timing_params, acc_fail, acc_success, _ = calibrate_timing_channel(
            params.HQC, rng, pub, priv, measure=timing_measure,
            profile_measurements=timing_profile_measurements,
            calibration_trials=timing_calibration_trials,
            chunk_cap=timing_chunk_cap,
            pt_target=timing_pt_target,
        )
        # Cap the upper end only: certainty 1.0 would mark wrong checks as
        # impossible (add_check escalates certainty-1.0 errors).
        params.EPSILON = (min(acc_fail, 0.995), min(acc_success, 0.995))
        # Physical certainty ceilings (see HqcOracle._amplify): a "success"
        # reading can never be more certain than P(garbage re-encryption
        # draws < 3 extra expansions) no matter how often it is repeated;
        # a "failure" reading's systematic risk is drift-only (smaller).
        fail_ceiling = timing_params["fail_ceiling"]
        params.CERTAINTY_CAP = (
            0.9995,  # result=False readings
            max(0.9, min(0.998, fail_ceiling)),  # result=True readings
        )
        logger.info(f"Timing-oracle calibrated EPSILON: {params.EPSILON}, certainty cap {params.CERTAINTY_CAP}")
        # params.EPSILON is live-updated by mid-attack recalibration, so the
        # start-of-attack calibration is kept apart
        tracking.timing_calibration = {
            "acc_fail": acc_fail, "acc_success": acc_success,
            "initial_epsilon": tuple(params.EPSILON),
        }

    _x, y_sparse = params.HQC.secrets_from_key(priv)
    y_sparse = sorted(y_sparse)
    logger.info(f"y weight: {len(y_sparse)}, y bits: {y_sparse}")

    checks = []  # (value, certainty) per check; supports live in the decoder
    decoder = DECODE_BACKENDS[decode_backend](params, device=device)

    if ckpt is not None:
        checks = list(ckpt["checks"])
        decoder.load_state_dict(ckpt["decoder"])
        tracking.num_oracle_calls = ckpt["tracking"]["num_oracle_calls"]
        tracking.decoder_stats = list(ckpt["tracking"]["decoder_stats"])

    last_checkpoint_decisions = [tracking.num_oracle_calls]

    def write_checkpoint(pt, shifts, round_base_ct, oracle):
        """Snapshot the full attack state (only valid at a clean point:
        the oracle ciphertext must equal the plaintext-round base)."""
        if bytes(oracle.ct) != bytes(round_base_ct):
            logger.warning("skipping checkpoint: ciphertext differs from the round base (not at a clean point)")
            return
        save_attack_checkpoint(checkpoint_path, {
            "version": CHECKPOINT_VERSION,
            "config": dict(checkpoint_config),
            "keypair": (bytes(pub), bytes(priv)),
            "rng_state": rng.get_state(),
            "tracking": {
                "num_oracle_calls": tracking.num_oracle_calls,
                "decoder_stats": list(tracking.decoder_stats),
                "block_status": tracking.block_status,
                "timing_calibration": tracking.timing_calibration,
            },
            "checks": list(checks),
            "decoder": decoder.state_dict(),
            "pt": bytes(pt),
            "shifts": [int(s) for s in shifts],
            "ct": bytes(round_base_ct),
            "epsilon": tuple(params.EPSILON),
            "certainty_cap": getattr(params, "CERTAINTY_CAP", None),
            "timing_params": timing_params,
            "channel": timing_channel.state_dict() if timing_channel is not None else None,
        })
        last_checkpoint_decisions[0] = tracking.num_oracle_calls

    while True:
        resuming_round = ckpt is not None
        if resuming_round:
            pt = bytes(ckpt["pt"])
            shifts = np.asarray(ckpt["shifts"], dtype=np.int64)
            r1_sparse = sorted(int(i) for i in shifts)
            ct = bytearray(ckpt["ct"])
        else:
            pt = search_distinguishable_plaintext(
                params.HQC, rng, target_additional_seedexpansions=timing_pt_target if oracle_backend == "timing" else 3)

            logger.info(f"Create random (L/M)DPC parity check of size {params.N}")
            first_row = random_circulant_first_row(params.N, weight, rng)
            shifts = np.flatnonzero(first_row)

            r1_sparse = sorted(int(i) for i in np.flatnonzero(first_row))
            assert weight == len(r1_sparse)
            ct, _ss = params.HQC.encaps_with_plaintext_and_r1(pub, pt, r1_sparse)

        y_times_r1 = sparse_times_sparse(y_sparse, r1_sparse, params.N)
        if oracle_backend == "timing":
            if timing_channel is None:
                from .oracle_timing import TimingChannel

                def _adopt_epsilon(eps):
                    # recalibrated per-class accuracy flows straight into the
                    # Bayesian amplification (which reads params.EPSILON on
                    # every repeat)
                    params.EPSILON = (min(eps[0], 0.995), min(eps[1], 0.995))

                ct_trials = timing_params["calibration_trials"]
                timing_channel = TimingChannel(
                    params.HQC, priv, ct, timing_params["gap"],
                    margin=timing_params["margin"],
                    measure=timing_measure, chunk_cap=timing_chunk_cap,
                    rng=rng, recal_every=timing_recal_every,
                    recal_trials=timing_recal_trials,
                    epsilon=params.EPSILON,
                    calibration_counts=(
                        timing_params["acc_fail"] * ct_trials, ct_trials,
                        timing_params["acc_success"] * ct_trials, ct_trials,
                    ),
                    on_update=_adopt_epsilon,
                )
                if resuming_round and ckpt["channel"] is not None:
                    timing_channel.load_state_dict(ckpt["channel"])
                    timing_channel.rebase(ct)
                # live counters (decaps, measurements, per-class empirical
                # accuracy) stay reachable from the returned tracking
                tracking.timing_channel = timing_channel
                if resuming_round and ckpt["channel"] is not None:
                    # the channel drifted across the checkpoint gap: re-center
                    # the decision boundary and refresh the rolling EPSILON
                    # before trusting any decision
                    logger.info("Post-resume channel recalibration")
                    timing_channel.recalibrate(trials=max(timing_recal_trials, 30))
            else:
                timing_channel.rebase(ct)
        oracle = HqcOracle(params, tracking, priv, pt, rng, ct,
                           backend="fast" if oracle_backend == "timing" else oracle_backend,
                           crosscheck_every=crosscheck_every, timing_channel=timing_channel)
        if oracle_backend == "timing" or (not isnan(error_rate) and error_rate > 0.0):
            oracle.assert_raises = False

        if resuming_round:
            tracking.block_status = ckpt["tracking"]["block_status"]
            tracking.current_block_nr = None
            ckpt = None  # later rounds sample fresh plaintexts
        else:
            tracking.reset_block_status()
        round_base_ct = bytes(ct)
        try:
            while True:
                if checkpoint_path and (
                    tracking.num_oracle_calls - last_checkpoint_decisions[0] >= checkpoint_every_decisions
                ):
                    write_checkpoint(pt, shifts, round_base_ct, oracle)
                if max_oracle_calls and tracking.num_oracle_calls > max_oracle_calls:
                    logger.warning("Oracle-call budget exhausted; stopping")
                    return False, tracking
                current_block = next_failure_block(params, tracking, oracle, rng)
                if current_block is None:
                    raise NoMoreUntestedRmBlocks
                tracking.set_current_block_nr(current_block)

                bit = next_failure_bit(params, tracking, oracle, rng)
                if bit is None:
                    tracking.current_block()["status"] = FlipStatus.UNFLIPPED
                    oracle.assert_success(True)
                    break

                successes = find_minimal_failure_flips(params, tracking, oracle, save_results=True)
                if add_checks(params, tracking, decoder, shifts, 0, successes, checks, y_sparse, y_times_r1,
                              executor=decode_executor):
                    return True, tracking

                successes, _failures = find_successes_by_flipping(params, tracking, oracle)
                if add_checks(params, tracking, decoder, shifts, 1, successes, checks, y_sparse, y_times_r1,
                              executor=decode_executor):
                    return True, tracking

                reset_current_block(params, tracking, oracle)
                reset_full_block_flips(params, tracking, oracle)
        except NoMoreUntestedRmBlocks:
            continue
