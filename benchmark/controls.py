"""The controls of the cells' comparisons: runs that must come out not correct.

    python3 benchmark/controls.py --workload <name> --seeds <n> [<n> ...] --seconds <s>

Each run drives the cell as ``run.py`` does, with the decode put at the next
precision below the configuration's float32 messages:

- FER cells: the port's own ``"lean"`` backend (bf16 message planes, K4) in the
  place of the cell's backend;
- attack cells: the benchmark's reference decode with its v2c and c2v messages
  rounded to bf16 where they are stored, in the place of the port's decode
  (its decisions feed the attack through the decoder's own statistics).

Prints one JSON line a run: the workload, the seed, which run, and every
number compared.  Needs the card, like the cell; a several-chip cell runs its
ranks as ``run.py`` does.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import run as bench  # noqa: E402


def bf16_reference_decode(ctx):
    """A decode for the attack's executor: the reference in bf16 messages."""
    import torch

    from benchmark.reference.attack import masked_inputs
    from benchmark.reference.bp import decode, round_bf16

    n, max_iter = int(ctx.config["n"]), int(ctx.traffic["max_iter"])

    def run(decoder, tracking, checks, y_sparse):
        state = decoder.state_dict()
        shifts = state["block_shifts"]
        prior_c, prior_i, syn = masked_inputs(state["rows"], checks, n, len(y_sparse), len(shifts), ctx.device)
        e_c, e_i, _conv, _it = decode(prior_c, prior_i, syn, shifts, max_iter, store=round_bf16)
        torch.cuda.synchronize(ctx.device)
        return decoder.stats_from_masked(tracking, e_c[0].cpu().numpy(), e_i[0].cpu().numpy(), checks, y_sparse)

    return run


def control_run(workload, seed, seconds, rank=0, rendezvous=None):
    """One control run of a cell on this process's rank; rank 0 returns the
    reading, the other ranks None."""
    import torch

    cell = bench.Cell(workload)
    torch.cuda.set_device(rank)
    ctx = bench.Context(cell, seed, seconds, 0, rank, cell.chips, torch.device("cuda", rank), rendezvous)
    if cell.traffic["driver"] == "fer":
        cell.traffic = {**cell.traffic, "backend": "lean"}
        ctx.traffic = cell.traffic
    else:
        ctx.decode_override = bf16_reference_decode(ctx)
    result = bench.driver_module(cell.traffic).run(ctx)
    if rank != 0:
        return None
    return {"workload": workload, "seed": seed, "run": "control",
            "checks": result["checks"], "attempted": result["attempted"], "failed": result["failed"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    chips = bench.Cell(args.workload).chips
    for seed in args.seeds:
        if args.rank:  # a rank of a several-chip cell, started by rank 0 for one seed
            control_run(args.workload, seed, args.seconds, args.rank, args.rendezvous)
            continue
        procs, rdir, rendezvous = [], None, None
        if chips > 1:
            rdir = tempfile.mkdtemp(prefix="bench-rdzv-")
            rendezvous = os.path.join(rdir, "init")
            cmd = [sys.executable, os.path.abspath(__file__), "--workload", args.workload, "--seeds", str(seed),
                   "--seconds", str(args.seconds), "--rendezvous", rendezvous]
            procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=sys.stderr) for r in range(1, chips)]
        try:
            reading = control_run(args.workload, seed, args.seconds, 0, rendezvous)
        finally:
            for p in procs:
                p.wait()
            if rdir is not None:
                shutil.rmtree(rdir, ignore_errors=True)
        print(json.dumps(reading), flush=True)


if __name__ == "__main__":
    main()
