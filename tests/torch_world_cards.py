"""Several cards over NCCL: the world worker (``tests/torch_world_worker.py``)
on N ranks, rank r on ``cuda:r``, against a world of one rank on ``cuda:0``;
then ``multihost_fer`` at the HQC-128 FER cell at rate 0.05 over N ranks
started by hand with ``torchrun``'s variables, and under ``torchrun`` at the
script's default code, each against one process.  With ``cpu`` the same runs
as gloo processes at small sizes (a rehearsal).  Keeps the ranks' results
under ``build/world_cards``; the last line is ``{"ok": ...}``, the exit code 0
when every run equals its one-rank run.

    python tests/torch_world_cards.py cuda 4              # on a host with 4 cards
    python tests/torch_world_cards.py cuda 4 --fer-only   # the multihost_fer part alone
    python tests/torch_world_cards.py cpu 4
"""

import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "world_cards")
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "NCCL_SOCKET_IFNAME": "lo"}  # one host: bootstrap over loopback
SCRIPT = [sys.executable, "-m", "sca_ldpc_tpu_torch.scripts.multihost_fer"]


def _last_json(text):
    return json.loads([ln for ln in text.strip().splitlines() if ln.startswith("{")][-1])


def world(kind, ranks, tag):
    """The world worker on ``ranks`` ranks; returns their results."""
    d = os.path.join(OUT, tag)
    os.makedirs(d, exist_ok=True)
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "torch_world_worker.py"), str(r),
                               str(ranks), f"{d}/rdv", f"{OUT}/inputs.npz", d,
                               f"cuda:{r}" if kind == "cuda" else "cpu"],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV, cwd=ROOT)
             for r in range(ranks)]
    outs = [p.communicate(timeout=240) for p in procs]
    rcs = [p.returncode for p in procs]
    print(f"world {tag}: rcs {rcs} in {time.time() - t0:.1f} s", flush=True)
    if any(rcs):
        raise SystemExit(str([o[1][-3000:] for o in outs]))
    results = []
    for r in range(ranks):
        with open(f"{d}/rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def worlds_equal(kind, n):
    """Every sharded function on ``n`` ranks against the world of one."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_world_worker as w

    os.makedirs(OUT, exist_ok=True)
    pc, pi, syn, shifts = w.attack_instances(48, 2, 3, 4, 11, 3)
    H, p_b, p_s = w.special_inputs()
    np.savez(f"{OUT}/inputs.npz", pc=pc, pi=pi, syn=syn, shifts=shifts, H_special=H, p_b=p_b, p_s=p_s)
    many, one = world(kind, n, f"w{n}"), world(kind, 1, "w1")
    same = {key: all(r[key] == one[0][key] for r in many)
            for key in ("decode-circulant", "fused", "decode-general", "qary", "attack")}
    same["masked"] = all(all(np.array_equal(x, y) for x, y in zip(r["masked"], one[0]["masked"])) for r in many)
    same["special"] = all(np.array_equal(r["special"], one[0]["special"]) for r in many)
    same["mismatch_raised"] = all("disagree on the round" in r.get("attack_mismatch", "") for r in many)
    print("shapes", [r["shape"] for r in many])
    print("values", {k: one[0][k] for k in ("decode-circulant", "fused", "decode-general", "qary")},
          "attack rounds", one[0]["attack"][1])
    print("equal to the world of one", same, flush=True)
    return all(same.values())


def ranks_by_hand(argv, n):
    """``n`` processes of ``multihost_fer argv`` with ``torchrun``'s variables
    set by hand; returns rank 0's JSON line."""
    procs = [subprocess.Popen([*SCRIPT, *argv], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
                              env={**ENV, "RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(n),
                                   "MASTER_ADDR": "localhost", "MASTER_PORT": "29555"}) for r in range(n)]
    outs = [p.communicate(timeout=240) for p in procs]
    if any(p.returncode for p in procs):
        raise SystemExit(str([o[1][-3000:] for o in outs]))
    return _last_json(outs[0][0])


def one_process(argv):
    out = subprocess.run([*SCRIPT, *argv], capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=240)
    if out.returncode:
        raise SystemExit(out.stderr[-3000:])
    return _last_json(out.stdout)


def fer_equal(kind, n):
    """``multihost_fer`` on ``n`` ranks against one process."""
    size = (["--n", "17669", "--code-weight", "20", "--runs", "8192", "--batch", "4096"] if kind == "cuda" else
            ["--n", "127", "--code-weight", "3", "--runs", "256", "--batch", "128"])
    args = [*size, "--error-rate", "0.05", "--max-iter", "30", "--seed", "0", "--device", kind]
    runs = {}
    for backend in ("fused", "decode"):
        runs[backend] = (one_process([*args, "--backend", backend]), ranks_by_hand([*args, "--backend", backend], n))
        print(f"multihost_fer {backend} at 0.05: 1 process {runs[backend][0]}; {n} ranks {runs[backend][1]}",
              flush=True)
    # torchrun itself, at the script's default code (torchrun of torch 2.11 takes --n for its own options)
    small = ["--runs", "8192", "--batch", "4096", "--error-rate", "0.05", "--device", kind, "--backend", "fused"]
    several = subprocess.run(["torchrun", "--nproc-per-node", str(n), "-m",
                              "sca_ldpc_tpu_torch.scripts.multihost_fer", *small],
                             capture_output=True, text=True, env=ENV, cwd=ROOT, timeout=240)
    if several.returncode:
        raise SystemExit(several.stderr[-3000:])
    runs["torchrun"] = (one_process(small), _last_json(several.stdout))
    print(f"torchrun multihost_fer fused, n 257: 1 process {runs['torchrun'][0]}; {n} ranks {runs['torchrun'][1]}",
          flush=True)
    return all((a["successes"], a["frames"]) == (b["successes"], b["frames"]) and b["process_count"] == n
               for a, b in runs.values())


def main():
    kind, n = sys.argv[1], int(sys.argv[2])
    ok = ("--fer-only" in sys.argv or worlds_equal(kind, n)) and fer_equal(kind, n)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
