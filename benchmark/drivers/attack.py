"""Attack traffic: HQC key-recovery attacks of the port, run back to back.

Each attack of the window is the port's ``simulate_hqc_idealized_oracle`` on
the configuration's key, which the benchmark reads from its own copy of the key
file and hands over as ``keypair``.  The window is a fixed number of attacks
sized from ``--seconds``: ``round(seconds / seconds_per_attack)`` attacks back
to back, attack ``j`` drawing its plaintexts, codes and oracle noise from a
``RandomState`` seeded with ``j`` and ``--seed`` (:func:`attack_rng`), so that
each seed sends its own inputs; the window ends when the last attack has
recovered its key (or spent ``max_oracle_calls``).

Every decode the attack makes goes through the benchmark's executor (the
attack's ``decode_executor`` seam): it calls the decoder's own ``decode`` and
times the call, which ends with the decision on the host.

Correctness, after the window:

- ``attack.secret_mismatch``: attacks whose target ``y`` differs from the
  secret that the benchmark's own binding of the victim library reads from the
  key (``benchmark/reference/hqc_secret.py``);
- ``attack.wrong_keys``: attacks that reported the key recovered although the
  reference, decoding the same checks, does not find the secret;
- ``attack.decode_stats_gap``: the largest gap, over the decodes of
  ``check_attacks`` attacks drawn from the seed, between the statistics of the
  port's decisions (flips on and off ``y``, checks marked wrong, success) and
  those of the reference's decisions on the checks that decode saw.

The reference works the decode's inputs out again from the attack's checks
(row, value, certainty) and the blocks' circulant offsets, which it reads from
the decoder's state: the attack chooses its queries from its earlier answers,
so the reference follows the attack step by step from the attack's own rows.

Parameters: ``seconds_per_attack``, ``param_set``, ``decode_every``,
``max_oracle_calls``, ``oracle_backend``, ``decode_backend``, ``max_iter`` (the
masked decode's, for the reference), ``check_attacks``,
``warmup_oracle_calls`` and ``limits``.
"""

import gc
import os
import resource
import sys
import time
from types import SimpleNamespace

import numpy as np

from ..common import check, pick
from ..reference.attack import reference_stats
from ..reference.hqc_secret import read_keypair, secret_y
from ..trace import Tracer

_STAT_KEYS = ("good_flips", "bad_flips", "found_bad_satisfied_checks", "found_bad_unsatisfied_checks")


class TimingExecutor:
    """The attack's ``decode_executor``: calls the decoder's own decode,
    times it, and keeps what the reference needs to decode the same checks."""

    def __init__(self, tracer, decode=None):
        self.tracer = tracer
        self.decode_fn = decode  # None: the decoder's own decode
        self.spans = []  # seconds of every decode in the window
        self.attacks = []  # per attack: {"decoder", "checks", "y", "decodes": [(R, stats)]}

    def begin_attack(self):
        self.attacks.append({"decoder": None, "checks": None, "y": None, "decodes": []})

    def decode(self, decoder, tracking, checks, y_sparse):
        t0 = time.perf_counter()
        with self.tracer.span("bench.decode"):
            if self.decode_fn is None:
                ok = decoder.decode(tracking, checks, y_sparse)
            else:
                ok = self.decode_fn(decoder, tracking, checks, y_sparse)
        self.spans.append(time.perf_counter() - t0)
        att = self.attacks[-1]
        att["decoder"], att["checks"], att["y"] = decoder, checks, y_sparse
        st = tracking.decoder_stats[-1]
        att["decodes"].append((len(checks), tuple(int(st[k]) for k in _STAT_KEYS) + (bool(ok),),
                               len(self.spans) - 1))
        return ok


def host_counters():
    """The host's share of the window, as the machine accounts it: this
    process's user and system CPU seconds, page faults and involuntary context
    switches, and the machine's steal seconds (time its virtual CPUs stood
    still)."""
    use = resource.getrusage(resource.RUSAGE_SELF)
    steal = 0.0
    with open("/proc/stat") as f:
        fields = f.readline().split()
    if len(fields) > 8:
        steal = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    return {"user_s": use.ru_utime, "sys_s": use.ru_stime, "faults": use.ru_minflt + use.ru_majflt,
            "preempted": use.ru_nivcsw, "steal_s": steal}


def attack_rng(seed, j):
    """The random state of the run's ``j``-th attack, from ``j`` and the run's
    seed."""
    return np.random.RandomState([j, seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF])


def run(ctx):
    import torch

    from sca_ldpc_tpu_torch.models.hqc import simulate_hqc_idealized_oracle

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    root = ctx.cell.root
    keypair = read_keypair(os.path.join(root, cfg["keyfile"]))
    secret = secret_y(os.path.join(root, "csrc", "libhqc_core.so"), tr["param_set"], keypair[1])
    n = int(cfg["n"])

    def attack(rng, executor, max_calls):
        return simulate_hqc_idealized_oracle(
            rng, decode_every=int(tr["decode_every"]), weight=int(cfg["code_weight"]), param_set=tr["param_set"],
            max_oracle_calls=max_calls, oracle_backend=tr["oracle_backend"], decode_executor=executor,
            keypair=keypair, decode_backend=tr["decode_backend"], device=dev)

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    # the decode's shape, the oracle and the victim library once (builds the kernel in a new checkout)
    warm = TimingExecutor(Tracer(False))
    warm.begin_attack()
    attacks = max(1, round(ctx.seconds / float(tr["seconds_per_attack"])))
    attack(np.random.RandomState(attacks), warm, int(tr["warmup_oracle_calls"]))
    if cuda:
        torch.cuda.synchronize(dev)

    tracer = Tracer(ctx.trace)
    executor = TimingExecutor(tracer, getattr(ctx, "decode_override", None))
    outcomes, attack_s = [], []
    with tracer:
        ctx.start_window()
        host0 = host_counters()
        t0 = time.perf_counter()
        for j in range(attacks):
            executor.begin_attack()
            t_attack = time.perf_counter()
            with tracer.span("bench.attack"):
                ok, tracking = attack(attack_rng(ctx.seed, j), executor, int(tr["max_oracle_calls"]))
            attack_s.append(time.perf_counter() - t_attack)
            outcomes.append((bool(ok), int(tracking.num_oracle_calls), float(tracking.decode_seconds)))
    window_s = time.perf_counter() - t0
    host = {k: v - host0[k] for k, v in host_counters().items()}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = tracer.summary()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference on the checks of a sample of the window's attacks
    t_ref = time.perf_counter()
    limits = tr["limits"]
    mismatch = sum(1 for a in executor.attacks if a["y"] is not None and sorted(a["y"]) != secret)
    wrong, gap, compared, ref_iters = 0, 0, 0, []
    sample = set(pick(ctx.seed, range(len(executor.attacks)), int(tr["check_attacks"]), salt=2))
    for i, att in enumerate(executor.attacks):
        recovered = outcomes[i][0]
        if not att["decodes"] or (i not in sample and not recovered):
            continue
        state = att["decoder"].state_dict()
        rows, checks = state["rows"], list(att["checks"])
        todo = list(range(len(att["decodes"]))) if i in sample else [len(att["decodes"]) - 1]
        decodes = [(rows[:att["decodes"][j][0]], checks[:att["decodes"][j][0]]) for j in todo]
        ref = reference_stats(decodes, state["block_shifts"], n, secret, int(tr["max_iter"]), dev)
        for j, (stats, iters) in zip(todo, ref):
            mine = att["decodes"][j][1]
            gap = max(gap, sum(abs(a - b) for a, b in zip(mine[:4], stats[:4])) + int(mine[4] != stats[4]))
            compared += 1
            blocks = 1 + max(b for b, _bit in rows[:att["decodes"][j][0]])
            ref_iters.append((att["decodes"][j][2], iters, blocks))
        if recovered and not ref[-1][0][4]:
            wrong += 1
    ref_s = time.perf_counter() - t_ref

    keys = sum(ok for ok, _c, _d in outcomes)
    spans_ms = np.asarray(executor.spans) * 1e3
    print(f"attack: {len(outcomes)} attacks, {keys} keys, {len(spans_ms)} decodes in {window_s:.3f} s "
          f"(decode_seconds {sum(d for *_x, d in outcomes):.4f}, spans {spans_ms.sum() / 1e3:.4f} s, 95th "
          f"percentile {np.percentile(spans_ms, 95) if len(spans_ms) else 0:.4f} ms); reference on "
          f"{compared} decodes in {ref_s:.3f} s", file=sys.stderr)
    print(f"attack host: cpu {host['user_s']:.3f} s user, {host['sys_s']:.3f} s system of {window_s:.3f}, "
          f"{host['faults']} page faults, {host['preempted']} involuntary switches, "
          f"machine steal {host['steal_s']:.2f} s over {os.cpu_count()} CPUs, affinity "
          f"{sorted(os.sched_getaffinity(0))}, oracle calls {sum(c for _o, c, _d in outcomes)}; seconds an attack "
          + " ".join(f"{s:.3f}" for s in attack_s), file=sys.stderr)
    run_data = SimpleNamespace(
        kind="attack", window_s=summary["window_s"] if summary else window_s, traces=[summary] if summary else None,
        host_window_s=window_s, keys=keys, decode_spans_s=executor.spans, config=cfg, traffic=tr,
        reference_iterations=ref_iters,
    )
    return {
        "end_to_end": {
            "key_s": window_s / keys if keys else float("inf"),
            "setup_s": ctx.setup_s,
        },
        "attempted": len(outcomes),
        "failed": len(outcomes) - keys,
        "memory_peak_bytes": peak,
        "checks": {
            "attack.secret_mismatch": check(mismatch, limits["attack.secret_mismatch"]),
            "attack.wrong_keys": check(wrong, limits["attack.wrong_keys"]),
            "attack.decode_stats_gap": check(gap, limits["attack.decode_stats_gap"]),
        },
        "run": run_data,
    }
