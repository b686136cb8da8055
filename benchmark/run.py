"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json`` at the root of the checkout:
its configuration file (``configs``), its traffic mix
(``benchmark/traffic/<traffic>.json``), whose ``driver`` names the module of
``benchmark/drivers/`` that drives the program, and, with ``--trace 1``, the
reader of each per-layer metric (``benchmark/metrics/<metric>.py``).  Nothing
here lists a cell, a mix or a metric: each is a file found by its name.

With ``--trace 0`` the last line of standard output carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics read from the
profiler's trace and the benchmark's own spans.  ``correct`` is decided by the
driver's comparison with the plain reference (``benchmark/reference/``); every
number compared is printed beside its limit, last on standard error and last
in the result line.  A cell on several chips runs one process a chip: this
process is rank 0 and prints; it starts the others and waits for them.

The run fails (exit code 3, no result) without CUDA or with fewer cards than
the cell asks for, and (exit code 4) if JAX or the JAX package was loaded.
"""

import os
import sys
import time

_T0 = time.perf_counter()


def _since_process_start():
    """Seconds since this process started, from /proc (10 ms resolution)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


_STARTED = _since_process_start()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")
# one thread a library: the load comes from one process; caches at fixed paths inside the checkout
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sca_ldpc_tpu")


def elapsed():
    """Seconds since this process started."""
    return _STARTED + time.perf_counter() - _T0


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic mix
    and metric entries.

    A cell taken out of ``BENCHMARK.json`` may be parked in
    ``benchmark/parked/<name>.json`` with its workload and metric entries as
    they stood there: it stays runnable by name, for its tests and controls,
    and the driver's checks never run it."""

    def __init__(self, name, root=ROOT):
        self.root = root
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        parked = os.path.join(root, "benchmark", "parked", name + ".json")
        self.parked = {}
        if name in cells:
            self.workload = cells[name]
        elif os.path.isfile(parked):
            self.parked = load_json(parked)
            self.workload = self.parked["workload"]
        else:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
        self.name = name
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config = load_json(os.path.join(root, configs[self.workload["config"]]["file"]))
        self.traffic = load_json(os.path.join(root, "benchmark", "traffic", self.workload["traffic"] + ".json"))
        self.chips = int(self.workload["chips"])

    def metrics(self, kind):
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        entries = self.bench[kind] + self.parked.get(kind, [])
        return [m for m in entries if "workloads" not in m or self.name in m["workloads"]]


def driver_module(traffic):
    return importlib.import_module(f"benchmark.drivers.{traffic['driver']}")


def metric_reader(name, root=ROOT):
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What a driver gets: the cell, the run's arguments, this rank, its
    device and the rendezvous file of a several-chip cell."""

    def __init__(self, cell, seed, seconds, trace, rank, world, device, rendezvous=None):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.rank, self.world, self.device = rank, world, device
        self.rendezvous = rendezvous
        self.setup_s = None

    def start_window(self):
        """Called at the first timed operation: records the set-up time."""
        self.setup_s = elapsed()


def read_per_layer(cell, run):
    """{metric: {"value", "unit"}} of the per-layer metrics whose readers find
    something to read in ``run``."""
    out = {}
    for m in cell.metrics("per_layer"):
        value = metric_reader(m["name"], cell.root)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(cell, result, trace, kind):
    """The result line of a run: ``correct``, ``attempted``, ``failed``,
    ``metrics`` (end-to-end with ``trace`` 0, per-layer with 1), ``device``
    (``kind``: the card's name), with ``trace`` ``breakdown``, and last the
    numbers compared, each with its limit."""
    if trace:
        metrics = read_per_layer(cell, result["run"])
    else:
        metrics = {m["name"]: {"value": float(result["end_to_end"][m["name"]]), "unit": m["unit"]}
                   for m in cell.metrics("end_to_end")}
    checks = result["checks"]
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(result["memory_peak_bytes"])}
    line = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": int(result["attempted"]), "failed": int(result["failed"]),
            "metrics": metrics, "device": device}
    if trace:
        summaries = result["run"].traces
        device["busy_s"] = sum(s["busy_s"] for s in summaries) / len(summaries)
        device["window_s"] = result["run"].window_s
        line["breakdown"] = {"device_ops": [[n, t] for n, t in summaries[0]["device_ops"][:10]],
                             "idle_gaps": [[n, t] for n, t in summaries[0]["idle_gaps"][:10]]}
    line["checks"] = checks
    return line


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _start_ranks(args, world, rendezvous):
    """Start ranks 1 .. world-1 of a several-chip cell; their standard output
    goes to this process's standard error."""
    procs = []
    for r in range(1, world):
        cmd = [sys.executable, os.path.abspath(__file__), "--workload", args.workload, "--seed", str(args.seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace), "--rank", str(r),
               "--rendezvous", rendezvous]
        procs.append(subprocess.Popen(cmd, stdout=sys.stderr, cwd=ROOT))
    return procs


def _stop_ranks(procs, timeout):
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell {cell.name} needs {cell.chips} CUDA device(s), found {found}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)

    procs, rdir = [], None
    rendezvous = args.rendezvous
    if cell.chips > 1 and args.rank == 0:
        rdir = tempfile.mkdtemp(prefix="bench-rdzv-")  # under TMPDIR
        rendezvous = os.path.join(rdir, "init")
        procs = _start_ranks(args, cell.chips, rendezvous)
    ctx = Context(cell, args.seed, args.seconds, args.trace, args.rank, cell.chips,
                  torch.device("cuda", args.rank), rendezvous)
    torch.cuda.set_device(ctx.device)
    try:
        result = driver_module(cell.traffic).run(ctx)
    finally:
        codes = _stop_ranks(procs, timeout=120)
        if rdir is not None:
            shutil.rmtree(rdir, ignore_errors=True)
    if args.rank != 0:
        return 0
    if any(codes):
        print(f"benchmark: rank processes exited with {codes}", file=sys.stderr)
        return 5
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {found}, which the port must not use", file=sys.stderr)
        return 4

    line = result_line(cell, result, args.trace, torch.cuda.get_device_name(0))
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
