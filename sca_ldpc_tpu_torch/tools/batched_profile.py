"""Where the batched HQC attack's host time goes, setting by setting.

Runs ``simulate_hqc_attacks_batched`` (``--seeds``, ``"circulant"``, every
instance on the fixture key, the attack settings of ``attack_cells.ATTACK``)
under each host setting of ``--settings`` and prints one JSON line a run:
wall s, the rounds' own s (``executor.seconds``), the rounds, each worker
thread's CPU s (``time.thread_time``), user and system s and voluntary
context switches (``getrusage(RUSAGE_THREAD)``), the process's CPU s (every
thread, the numerical libraries' pools included) and whether every instance
recovered its key.  First it runs the same instances one after another
through ``simulate_hqc_idealized_oracle`` (``"serial"``), the baseline.
A setting joins these with ``+``:

- ``default``: as a user runs it (the instances take turns,
  ``BatchedDecodeExecutor.turn``);
- ``threads``: the instances' threads side by side, not taking turns (the
  batcher's turn replaced by a null context here);
- ``switch=<s>``: ``sys.setswitchinterval(s)`` (the interval after which a
  thread that wants the GIL asks its holder to drop it; 0.005 by default);
- ``torch1``: ``torch.set_num_threads(1)`` in each worker thread;
- ``blas1``: the run in a child process with ``OMP_NUM_THREADS``,
  ``OPENBLAS_NUM_THREADS`` and ``MKL_NUM_THREADS`` set to 1;
- ``sample``: a sampling thread reads every worker's stack each
  ``--interval`` s and counts where it is: waiting (for its round or its
  turn), or the innermost frame of this package (file and function) and
  the innermost frame of all.

Runs on the card (the decodes run K8); the host work is what it measures.
``--device cpu`` and ``--max-oracle-calls`` make a short check of the tool
itself on the CPU.

    python3 -m sca_ldpc_tpu_torch.tools.batched_profile --settings default threads threads+switch=0.0005 \\
        threads+blas1 sample threads+sample --out build/batched_profile.json
"""

import argparse
import collections
import contextlib
import json
import os
import resource
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

from ..models.hqc import batched, simulate_hqc_attacks_batched, simulate_hqc_idealized_oracle
from ..utils import make_random_state
from .attack_cells import ATTACK, fixture_keys

KW = {k: v for k, v in ATTACK.items() if k not in ("keyfile", "error_rate", "param_set")}
PACKAGE = str(Path(__file__).resolve().parents[1])


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def serial(seeds, device):
    """The instances one after another: wall s, process CPU s, recovered."""
    with fixture_keys() as keypair:
        _sync(device)
        t0, c0 = time.perf_counter(), time.process_time()
        oks = [simulate_hqc_idealized_oracle(make_random_state(s), keypair=keypair, decode_backend="circulant",
                                             device=device, **KW)[0] for s in seeds]
        _sync(device)
        return {"setting": "serial", "wall_s": time.perf_counter() - t0, "process_cpu_s": time.process_time() - c0,
                "recovered": oks}


class Sampler(threading.Thread):
    """Counts, each ``interval`` s, where every thread of ``idents`` is."""

    def __init__(self, interval):
        super().__init__(daemon=True)
        self.interval, self.idents, self.stop = interval, set(), threading.Event()
        self.samples, self.waiting = 0, 0
        self.ours, self.innermost = collections.Counter(), collections.Counter()

    def run(self):
        while not self.stop.wait(self.interval):
            frames = sys._current_frames()
            for ident in list(self.idents):
                frame = frames.get(ident)
                if frame is None:
                    continue
                self.samples += 1
                self.innermost[f"{Path(frame.f_code.co_filename).name}:{frame.f_code.co_name}"] += 1
                stack = []
                while frame is not None:
                    stack.append(frame)
                    frame = frame.f_back
                waiting_round = any(f.f_code.co_name == "decode" and f.f_code.co_filename == batched.__file__
                                    for f in stack) and any(f.f_code.co_name in ("wait", "wait_for") for f in stack)
                waiting_turn = stack[0].f_code.co_name == "run" and stack[0].f_code.co_filename == batched.__file__
                if waiting_round or waiting_turn:
                    self.waiting += 1
                    continue
                ours = next((f for f in stack if f.f_code.co_filename.startswith(PACKAGE)), None)
                if ours is not None:
                    self.ours[f"{Path(ours.f_code.co_filename).name}:{ours.f_code.co_name}"] += 1

    def summary(self, top=12):
        n = max(self.samples, 1)
        return {"samples": self.samples, "waiting_share": self.waiting / n,
                "ours": [(k, v / n) for k, v in self.ours.most_common(top)],
                "innermost": [(k, v / n) for k, v in self.innermost.most_common(top)]}


def batched_run(seeds, device, setting, interval):
    """One batched run under ``setting`` (not ``blas1``), in this process."""
    tokens = setting.split("+")
    workers = {}
    sampler = Sampler(interval) if "sample" in tokens else None
    switch = [float(t.split("=", 1)[1]) for t in tokens if t.startswith("switch=")]
    old_switch = sys.getswitchinterval()
    if switch:
        sys.setswitchinterval(switch[0])

    def worker(*args, **kwargs):
        if "torch1" in tokens:
            torch.set_num_threads(1)
        if sampler is not None:
            sampler.idents.add(threading.get_ident())
        c0, r0 = time.thread_time(), resource.getrusage(resource.RUSAGE_THREAD)
        try:
            return simulate_hqc_idealized_oracle(*args, **kwargs)
        finally:
            r1 = resource.getrusage(resource.RUSAGE_THREAD)
            workers[threading.get_ident()] = (time.thread_time() - c0, r1.ru_utime - r0.ru_utime,
                                              r1.ru_stime - r0.ru_stime, r1.ru_nvcsw - r0.ru_nvcsw)

    original = batched.simulate_hqc_idealized_oracle
    batched.simulate_hqc_idealized_oracle = worker
    try:
        with fixture_keys():
            executor = batched.BatchedCirculantDecodeExecutor(len(seeds), device=device)
            if "threads" in tokens:
                executor.turn = contextlib.nullcontext
            if sampler is not None:
                sampler.start()
            _sync(device)
            t0, c0 = time.perf_counter(), time.process_time()
            results, rounds = simulate_hqc_attacks_batched(seeds, decode_backend="circulant", executor=executor,
                                                           device=device, **KW)
            _sync(device)
            wall, cpu = time.perf_counter() - t0, time.process_time() - c0
    finally:
        batched.simulate_hqc_idealized_oracle = original
        sys.setswitchinterval(old_switch)
        if sampler is not None:
            sampler.stop.set()
            sampler.join()
    per = sorted(workers.values())
    row = {"setting": setting, "wall_s": wall, "rounds_s": executor.seconds, "rounds": rounds,
           "worker_cpu_s": [w[0] for w in per], "worker_user_s": [w[1] for w in per],
           "worker_sys_s": [w[2] for w in per], "worker_voluntary_switches": [w[3] for w in per],
           "process_cpu_s": cpu, "recovered": [ok for ok, _t in results]}
    if sampler is not None:
        row["profile"] = sampler.summary()
    return row


def child(seeds, device, setting):
    """``blas1``: a batched run in a child process with one thread a numerical library."""
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1")
    rest = "+".join(t for t in setting.split("+") if t != "blas1") or "default"
    out = subprocess.run([sys.executable, "-m", __spec__.name, "--seeds", *map(str, seeds), "--settings",
                          rest, "--no-serial", "--device", str(device), "--max-oracle-calls",
                          str(KW["max_oracle_calls"])], env=env, capture_output=True, text=True, check=True)
    row = json.loads(out.stdout.strip().splitlines()[-1])
    row["setting"] = setting
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--settings", nargs="+", default=["default", "threads", "threads+switch=0.0005",
                                                      "threads+torch1", "threads+blas1", "sample", "threads+sample"])
    ap.add_argument("--interval", type=float, default=0.002, help="the sampler's period, s")
    ap.add_argument("--no-serial", action="store_true", help="skip the serial baseline")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-oracle-calls", type=int, default=KW["max_oracle_calls"])
    ap.add_argument("--out", help="also write the rows there as a JSON list")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("batched_profile: no CUDA device (--device cpu runs the plain decode)")
    KW["max_oracle_calls"] = args.max_oracle_calls
    rows = [] if args.no_serial else [serial(args.seeds, device)]
    if rows:
        print(json.dumps(rows[-1]), flush=True)
    for setting in args.settings:
        rows.append(child(args.seeds, device, setting) if "blas1" in setting.split("+") else
                    batched_run(args.seeds, device, setting, args.interval))
        print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
