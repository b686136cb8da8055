"""Kyber traffic: the Kyber attack's recovery sweep, a batch of simulated attacks a step.

Each step of the window is one call of the port's public entry named by the
mix (``kyber_attack_simulation``) on ``batch`` attacks of the configuration's
``[H'|I]`` attack code at one oracle accuracy; the steps take the mix's
``accuracies`` in turn, as a recovery curve does.  The secrets, their check
sums and the oracle's answers are drawn on the device from a generator the
benchmark seeds with ``--seed``, decoded by two-alphabet min-sum
(``max_iter`` iterations, ``backend``), and each attack compared with its
secret.  Every step ends with its counts on the host: the attacks recovered,
the coefficients decoded wrongly and the attacks run.

The counts: ``attempted`` is the attacks the window's steps asked the entry
for (``batch`` a step), and ``failed`` those it gave no usable answer for: a
step's missing attacks when it says it ran fewer than ``batch``, and all of
its attacks when its attack count is not an integer in ``[0, batch]``, its
recovered count not one in ``[0, attacks]`` or its wrong-coefficient count
not one in ``[0, attacks * N_b]``.  An attack decoded to another secret is an
answer: the sweep's recovery share, printed with the mean wrong coefficients
at each accuracy on standard error, and not a count of failures.

Correctness: the generator's state before each step is kept.  After the
window, ``check_steps[r]`` steps at the ``r``-th accuracy, drawn from the
seed, are drawn again from those states with the port's public draw
(``kyber_draw``, so the check depends on the port's draw), and:

- ``kyber.count_gap``: |the step's recovered count - the attacks the port's
  decode recovers on the redraw's channels (``kyber_channels``)| plus the same
  for its wrong-coefficient count, summed over the steps;
- ``kyber.flip_z``: the largest |z| of the share of answers that differ from
  the codeword bit of the true symbol, against ``1 - accuracy``, over each
  accuracy and kind (coefficients, sums); the true symbols are the redraw's
  secrets and the reference's own ``H'·s`` (``benchmark/reference/kyber.py``);
- ``kyber.channel_gap``: the largest |difference| between the port's channels
  (min-sum LLRs) and the reference's, which the reference builds from the
  answers with its own Bayes rule, over ``check_frames[r]`` attacks of each
  such step drawn from the seed;
- ``kyber.decision_gap``: decisions, secret and sum, that differ between the
  port's decode and the reference's on the reference's channels, over the
  same attacks.

A run of ``benchmark/controls.py`` sets ``ctx.decode_override``; the port's
decode in these checks is then the reference's with its messages rounded to
bf16 where stored.

Parameters (the mix's keys): ``entry``, ``batch``, ``accuracies``,
``max_iter`` (the configuration's ``iterations``), ``backend``,
``check_steps`` and ``check_frames`` (one count an accuracy),
``reference_block`` (attacks the reference decodes at a time) and ``limits``
{check: limit}.
"""

import gc
import math
import numbers
import sys
import time
from types import SimpleNamespace

import numpy as np

from ..common import check, pick
from ..reference import kyber as reference
from ..reference.bp import round_bf16
from ..trace import Tracer


def _usable(value, high):
    """Whether ``value`` is an integer in ``[0, high]``."""
    return isinstance(value, numbers.Real) and float(value).is_integer() and 0 <= value <= high


def _unanswered(counts, batch, n_b):
    """The attacks of one step of ``batch`` that the entry gave no usable
    answer for (``counts``: recovered, wrong coefficients, attacks run)."""
    ok, wrong, frames = counts
    if not _usable(frames, batch) or not _usable(ok, frames) or not _usable(wrong, frames * n_b):
        return batch
    return batch - int(frames)


def _scalar(x):
    return x.item() if hasattr(x, "item") else x


def run(ctx):
    import torch

    from sca_ldpc_tpu_torch import parallel

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    entry = getattr(parallel, tr["entry"])  # a program without the step fails here, before any work
    from sca_ldpc_tpu_torch.codes import make_qary_qc_parity_check_matrix
    from sca_ldpc_tpu_torch.models.kyber.patterns import coding_from_patterns, get_patterns
    from sca_ldpc_tpu_torch.ops import QarySpecialDecoder

    if ctx.world != 1:
        raise ValueError("the Kyber cells run on one chip")
    max_iter, batch = int(tr["max_iter"]), int(tr["batch"])
    if max_iter != int(cfg["iterations"]):
        raise ValueError(f"the mix's max_iter {max_iter} is not the configuration's iterations {cfg['iterations']}")
    eta, sw, bsum = int(cfg["eta"]), int(cfg["sum_weight"]), int(cfg["bsum"])
    H = make_qary_qc_parity_check_matrix(int(cfg["n"]), sw, int(cfg["k"]), np.random.RandomState(int(cfg["h_seed"])),
                                         int(cfg["check_blocks"])).astype(np.int8)
    n_b, r = int(cfg["n_b"]), int(cfg["r"])
    if H.shape != (r, n_b + r):
        raise ValueError(f"the code has shape {H.shape}, the configuration states ({r}, {n_b + r})")
    patterns = (int(cfg["num_patterns"]), int(cfg["num_patterns_sum"]))
    accuracies = [float(a) for a in tr["accuracies"]]
    cuda = dev.type == "cuda"
    decoder = QarySpecialDecoder(H, eta, bsum, max_iter, sw=sw, backend=tr["backend"], device=dev)

    def step(gen, i):
        return entry(decoder, H, accuracies[i % len(accuracies)], batch, gen, batch=batch, num_patterns=patterns[0],
                     num_patterns_sum=patterns[1])

    gen = torch.Generator(device=dev)
    gen.manual_seed(ctx.seed % (1 << 63))
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    for i in range(len(accuracies)):  # each accuracy once: builds and loads the kernel in a new checkout
        step(gen, i)
    if cuda:
        torch.cuda.synchronize(dev)

    states, counts = [], []
    tracer = Tracer(ctx.trace)
    with tracer:
        ctx.start_window()
        t0 = time.perf_counter()
        while True:
            states.append(gen.get_state())
            with tracer.span("bench.step"):
                counts.append(tuple(_scalar(x) for x in step(gen, len(counts))))
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = tracer.summary()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # a sample of the window's steps drawn again: the port's decode, the answers' noise and the reference
    block = int(tr["reference_block"])
    if getattr(ctx, "decode_override", None) is None:
        decode = decoder.min_sum_llr
    else:  # the control: the reference with bf16 messages in the place of the port's decode
        def decode(llr, llr_sum):
            return reference.min_sum(H, llr, llr_sum, max_iter, store=round_bf16, block=block)
    t_ref = time.perf_counter()
    count_gap, decision_gap, channel_gap, flip_z, checked = 0, 0, 0.0, 0.0, 0
    for a, acc in enumerate(accuracies):
        tables = parallel.kyber_tables(decoder, H, acc, *patterns)
        pat = get_patterns(eta, acc, *patterns, sw)
        cw = np.array([c for _s, c in sorted(coding_from_patterns(pat["pattern"], 1, eta).items())])
        cw_sum = np.array([c for _s, c in sorted(coding_from_patterns(pat["pattern_sum"], sw, eta).items())])
        flips, bits = [0, 0], [0, 0]
        for i in pick(ctx.seed, range(a, len(states), len(accuracies)), int(tr["check_steps"][a]), salt=1 + a):
            g = torch.Generator(device=dev)
            g.set_state(states[i])
            draw = parallel.kyber_draw(g, batch, tables)
            llr, llr_sum = parallel.kyber_channels(draw, tables)
            wrong = (decode(llr, llr_sum)[:, :n_b] != draw.s).sum(dim=-1)
            count_gap += abs(counts[i][0] - int((wrong == 0).sum())) + abs(counts[i][1] - int(wrong.sum()))

            truth = (torch.as_tensor(cw, device=dev)[draw.s.long() + eta],
                     torch.as_tensor(cw_sum, device=dev)[reference.check_sums(H, draw.s) + bsum])
            for k, (answers, true) in enumerate(zip((draw.answers, draw.answers_sum), truth)):
                flips[k] += int((answers != true).sum())
                bits[k] += answers.numel()

            frames = torch.as_tensor(pick(ctx.seed + i, range(batch), int(tr["check_frames"][a]), salt=101 + a),
                                     device=dev)
            ref_llr = reference.channels(draw.answers[frames], cw, reference.cbd_prior(1, eta), acc)
            ref_llr_sum = reference.channels(draw.answers_sum[frames], cw_sum, reference.cbd_prior(sw, eta), acc,
                                             reverse=True)
            channel_gap = max(channel_gap, float((ref_llr - llr[frames]).abs().max()),
                              float((ref_llr_sum - llr_sum[frames]).abs().max()))
            ours = decode(ref_llr, ref_llr_sum)
            theirs = reference.min_sum(H, ref_llr, ref_llr_sum, max_iter, block=block)
            decision_gap += int((ours != theirs).sum())
            checked += len(frames)
            del draw, llr, llr_sum, wrong, truth, ref_llr, ref_llr_sum, ours, theirs
        p = 1.0 - acc
        for f, n in zip(flips, bits):
            if n:
                flip_z = max(flip_z, abs(f / n - p) / math.sqrt(p * (1.0 - p) / n))
    ref_s = time.perf_counter() - t_ref

    frames = sum(f for _ok, _w, f in counts)
    failed = sum(_unanswered(c, batch, n_b) for c in counts)
    usable = [[c for c in counts[a::len(accuracies)] if _unanswered(c, batch, n_b) < batch]
              for a in range(len(accuracies))]
    print(f"kyber: {len(counts)} steps, {frames} attacks in {window_s:.3f} s; reference on {checked} attacks in "
          f"{ref_s:.3f} s; {failed} of {len(counts) * batch} attacks asked for not answered", file=sys.stderr)
    print("kyber: by accuracy (recovered share, mean wrong coefficients; answers, not failures): "
          + ", ".join(f"{acc:g} {100 * sum(c[0] for c in u) / max(sum(c[2] for c in u), 1):.3f}% "
                      f"{sum(c[1] for c in u) / max(sum(c[2] for c in u), 1):.3f}"
                      for acc, u in zip(accuracies, usable)), file=sys.stderr)
    limits = tr["limits"]
    run_data = SimpleNamespace(
        kind="kyber", window_s=summary["window_s"] if summary else window_s, traces=[summary] if summary else None,
        frames=frames, steps=len(counts), config=cfg, traffic=tr,
    )
    return {
        "end_to_end": {"frames_per_s": frames / window_s, "setup_s": ctx.setup_s},
        "attempted": len(counts) * batch,
        "failed": failed,
        "memory_peak_bytes": peak,
        "checks": {"kyber.count_gap": check(count_gap, limits["kyber.count_gap"]),
                   "kyber.flip_z": check(flip_z, limits["kyber.flip_z"]),
                   "kyber.channel_gap": check(channel_gap, limits["kyber.channel_gap"]),
                   "kyber.decision_gap": check(decision_gap, limits["kyber.decision_gap"])},
        "run": run_data,
    }
