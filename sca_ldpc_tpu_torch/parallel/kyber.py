"""Kyber attack simulation in batches on one device: the recovery sweep's step.

One step simulates ``batch`` whole attacks on the Kyber ``[H'|I]`` attack code
(Kyber-768 with ``DecoderN1280R512SW6``: 768 secret coefficients, 512 check
sums of 6 of them) at one oracle accuracy, all on the decoder's device:

- :func:`kyber_draw`: from a ``torch.Generator``, each attack's secret ``s``
  (centered binomial, eta = the decoder's B), its check sums ``ssum = H'·s``,
  and the oracle's answers to every coefficient's and every sum's measurement
  pattern: the pattern codeword bit of the true symbol, flipped where a
  uniform exceeds the accuracy (as the host pipeline's
  ``simulate_measurements`` and ``simulate_sum_measurements``);
- :func:`kyber_channels`: each coefficient's and each sum's channel, looked
  up by its answer sequence in tables built once on the host with the port's
  ``posteriors_from_hard`` over every possible sequence (the sum tables
  reversed, as ``get_channel_probabilities`` reverses them), as min-sum LLRs;
- the decode, :meth:`~sca_ldpc_tpu_torch.ops.QarySpecialDecoder.min_sum_llr`
  (K7 with the ``"fused"`` backend on a CUDA device, one launch a step);
- the comparison with ``s``: the attacks recovered (every coefficient right)
  and the coefficients decoded wrongly, as 0-d device tensors.

:func:`kyber_attack_simulation` runs ``runs`` attacks in such steps, with one
count on the host a step, as :func:`~sca_ldpc_tpu_torch.parallel.fer_simulation`
does for the FER.  The host pipeline (``models/kyber/pipeline.py``
``simulate_kyber_attack``) keeps its own NumPy draws, seed for seed with the
JAX package; this step draws on the device and follows no host seed.

Spans and counters (``utils/spans.py``; recorded only while something reads
them): ``kyber.simulation`` around one :func:`kyber_attack_simulation` call,
inside it ``kyber.draw``, ``kyber.channel`` (the table lookups),
``kyber.decode`` (in ``QarySpecialDecoder._decode_llr``, so around every K7
call) and ``kyber.count`` (the counts on the host, which wait for the
device).  The step counts ``kyber.frames``, ``kyber.frame_iterations``
(frames times the decoder's iterations: it runs them all, without early exit)
and ``kyber.wrong_coefficients`` (a device sum).
"""

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..channels.llr import probs_to_llr
from ..models.kyber.patterns import coding_from_patterns, get_patterns
from ..models.kyber.posterior import posteriors_from_hard
from ..models.kyber.secrets import secret_distribution
from ..ops import minplus
from ..utils import spans


class KyberTables(NamedTuple):
    """What a step draws and looks up with; the tensors on the decoder's device."""

    accuracy: float  # the oracle's accuracy
    eta: int  # B: the secrets lie in [-B, B]
    n_b: int  # secret coefficients
    h_idx: torch.Tensor  # [R, SW] int64: each check's coefficients (a short row's pads: coefficient 0 ...)
    h_sign: torch.Tensor  # [R, SW] int8: ... their entries of H' (0 on the pads)
    cbd: torch.Tensor  # [2^(2B)] int8: the secret coefficient of each 2B-bit draw
    draw_codewords: torch.Tensor  # [2^(2B), m] uint8: its codeword under the coefficient pattern
    codewords_sum: torch.Tensor  # [2BSUM+1, m_sum] uint8: the sum pattern's codeword of each symbol
    weights: torch.Tensor  # [m] uint8: 2^k, answer k's bit in the row of ``llr``
    weights_sum: torch.Tensor  # [m_sum] uint8: the same for ``llr_sum``
    llr: torch.Tensor  # [2^m, 2B+1] f32: the channel of each answer sequence
    llr_sum: torch.Tensor  # [2^m_sum, 2BSUM+1] f32: the same for the sums, reversed


class KyberDraw(NamedTuple):
    """A batch of drawn attacks, on the device."""

    s: torch.Tensor  # [batch, N_b] int8: the secrets
    ssum: torch.Tensor  # [batch, R] int32: H'·s
    answers: torch.Tensor  # [batch, N_b, m] uint8: the oracle's answers for each coefficient
    answers_sum: torch.Tensor  # [batch, R, m_sum] uint8: for each check sum


def _llr_table(coding, prior, accuracy, reverse):
    """The min-sum LLRs of every answer sequence under ``coding`` (row t:
    answer k is bit k of t), as the host pipeline turns a posterior into the
    decoder's input (f64 posterior, f32 probabilities, ``probs_to_llr``),
    clipped as the decoder clips."""
    m = len(next(iter(coding.values())))
    sequences = (np.arange(2**m)[:, None] >> np.arange(m)[None, :]) & 1
    post = posteriors_from_hard(sequences, coding, prior, accuracy)
    probs = np.ascontiguousarray(post[:, ::-1] if reverse else post, np.float32)
    return minplus.clip_inf(probs_to_llr(torch.from_numpy(probs)))


@functools.lru_cache(maxsize=64)
def _channel_tables(eta, sum_weight, accuracy, num_patterns, num_patterns_sum, device):
    """The fields of :class:`KyberTables` from ``cbd`` on, on ``device``: a
    function of its arguments alone, built once a process (a sweep's every
    step asks for the same few), so a step copies nothing from the host.
    Read-only.  ``cbd[t]`` is the secret coefficient of the uniform bits
    ``t``, as ``sample_secret_coefs`` forms it: the low eta bits count up,
    the next eta down."""
    patterns = get_patterns(eta, accuracy, num_patterns, num_patterns_sum, sum_weight)
    coding = coding_from_patterns(patterns["pattern"], 1, eta)
    coding_sum = coding_from_patterns(patterns["pattern_sum"], sum_weight, eta)
    t = np.arange(2 ** (2 * eta))
    cbd = sum((t >> i) & 1 for i in range(eta)) - sum((t >> i) & 1 for i in range(eta, 2 * eta))

    def tensor(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype).to(device)

    def weights(c):
        return tensor(2 ** np.arange(len(next(iter(c.values())))), torch.uint8)

    return (tensor(cbd, torch.int8), tensor([coding[v] for v in cbd], torch.uint8),
            tensor([coding_sum[v] for v in sorted(coding_sum)], torch.uint8), weights(coding), weights(coding_sum),
            _llr_table(coding, secret_distribution(1, eta), accuracy, reverse=False).to(device),
            _llr_table(coding_sum, secret_distribution(sum_weight, eta), accuracy, reverse=True).to(device))


def kyber_tables(decoder, H, accuracy, num_patterns=3, num_patterns_sum=3):
    """The tables of a step at one accuracy, on the decoder's device.  ``H``:
    the decoder's ``[H'|I]`` ([R, N_b + R] integers, the identity in its last
    R columns, so that check sum i is sum variable i); the measurement
    patterns are the database's for the decoder's B and SW and ``accuracy``
    (``models/kyber/patterns.py``)."""
    H = np.asarray(H)
    r, n_b = decoder.r, decoder.n_b
    if H.shape != (r, decoder.n) or not np.array_equal(H[:, n_b:], np.eye(r, dtype=H.dtype)):
        raise ValueError(f"H must be the decoder's [H'|I], shape ({r}, {decoder.n}) with the identity in its last "
                         f"{r} columns; got shape {H.shape}")
    # each check's coefficients and signs, as the decoder holds them
    bvar_idx, bvar_sign, bvar_mask = decoder._args[:3]
    tables = _channel_tables(decoder.b, decoder.sw, float(accuracy), num_patterns, num_patterns_sum, decoder.device)
    return KyberTables(float(accuracy), decoder.b, n_b, (bvar_idx * bvar_mask).long(),
                       (bvar_sign * bvar_mask).to(torch.int8), *tables)


def kyber_draw(generator, batch, tables):
    """``batch`` attacks drawn from ``generator`` (on the tables' device), in
    a fixed order: each coefficient's 2·eta uniform bits (its secret is their
    centered binomial, ``tables.cbd``), a uniform for each of the
    coefficients' answers, then for each of the sums'.  An answer is the
    codeword bit of the true symbol, flipped where its uniform exceeds the
    accuracy.  The same generator state gives the same draw."""
    with spans.span("kyber.draw"):
        dev, n_b = tables.llr.device, tables.n_b
        t = torch.randint(0, tables.cbd.numel(), (batch, n_b), generator=generator, device=dev)
        s = tables.cbd[t]
        ssum = (s[:, tables.h_idx] * tables.h_sign).sum(dim=-1, dtype=torch.int32)
        m, m_sum = tables.weights.numel(), tables.weights_sum.numel()
        answers = tables.draw_codewords[t] ^ (
            torch.rand((batch, n_b, m), generator=generator, device=dev) > tables.accuracy)
        bsum = (tables.codewords_sum.shape[0] - 1) // 2
        answers_sum = tables.codewords_sum[ssum + bsum] ^ (
            torch.rand((batch, ssum.shape[1], m_sum), generator=generator, device=dev) > tables.accuracy)
        return KyberDraw(s, ssum, answers, answers_sum)


def kyber_channels(draw, tables):
    """The draw's channels, as the decoder takes them: ``(llr [batch, N_b,
    2B+1], llr_sum [batch, R, 2BSUM+1])`` f32 min-sum LLRs, the sum variables
    in column order."""
    with spans.span("kyber.channel"):
        return (tables.llr[(draw.answers * tables.weights).sum(dim=-1)],
                tables.llr_sum[(draw.answers_sum * tables.weights_sum).sum(dim=-1)])


def make_kyber_attack_step(decoder, H, accuracy, num_patterns=3, num_patterns_sum=3):
    """Build a step: ``(generator, batch) -> (recovered, wrong_coefficients,
    frames)``, 0-d int64 tensors on the decoder's device: the attacks whose
    every secret coefficient was decoded right, the coefficients decoded
    wrongly over the batch, and the attacks run.

    ``decoder``: a :class:`~sca_ldpc_tpu_torch.ops.QarySpecialDecoder` of
    ``H`` without early exit (on a CUDA device, ``backend="fused"`` decodes
    with K7); ``generator`` must live on its device.  The tables
    (:func:`kyber_tables`) are built here, once, and kept as ``step.tables``
    for a caller that draws again (:func:`kyber_draw`)."""
    if decoder.early_exit:
        raise ValueError("the Kyber attack step runs the decoder's iterations in full: build it without early_exit")
    tables = kyber_tables(decoder, H, accuracy, num_patterns, num_patterns_sum)

    def step(generator, batch):
        draw = kyber_draw(generator, batch, tables)
        llr, llr_sum = kyber_channels(draw, tables)
        hard = decoder.min_sum_llr(llr, llr_sum)
        wrong = (hard[:, : tables.n_b] != draw.s).sum(dim=-1)
        wrong_total = wrong.sum()
        spans.count("kyber.frames", batch)
        spans.count("kyber.frame_iterations", batch * decoder.max_iter)
        spans.count("kyber.wrong_coefficients", wrong_total)
        return (wrong == 0).sum(), wrong_total, torch.full((), batch, dtype=torch.int64, device=decoder.device)

    step.tables = tables
    return step


def kyber_attack_simulation(decoder, H, accuracy, runs, generator, batch=None, num_patterns=3, num_patterns_sum=3):
    """Run ``runs`` simulated attacks at ``accuracy`` in batches of at most
    ``batch`` (default ``min(runs, 256)``); returns ``(recovered,
    wrong_coefficients, frames)`` as Python ints.  Arguments as
    :func:`make_kyber_attack_step`."""
    with spans.span("kyber.simulation"):
        if batch is None:
            batch = min(max(runs, 1), 256)
        batch = max(1, int(batch))
        step = make_kyber_attack_step(decoder, H, accuracy, num_patterns, num_patterns_sum)
        recovered = wrong = frames = done = 0
        while done < runs:
            cur = min(batch, runs - done)
            counts = torch.stack(step(generator, cur))
            with spans.span("kyber.count"):
                ok, bad, ran = counts.tolist()
            recovered, wrong, frames, done = recovered + ok, wrong + bad, frames + ran, done + cur
        return recovered, wrong, frames
