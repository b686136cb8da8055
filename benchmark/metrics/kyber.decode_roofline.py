"""K7's share of its least time in the Kyber window (%), moves ``frames_per_s``.

The least time by ``benchmark/roofline_kyber.py``: R check updates a frame and
iteration, each a min-plus chain over SW coefficient messages with the sum
variable's channel as extra operand, 2 FP32 instructions an add+min pair; or
the channels, decisions and adjacency moved once.  The iterations are the
program's counter ``kyber.frame_iterations`` (frames times the iterations K7
ran; it runs them all), the frames ``kyber.frames`` and the launches the calls
of the span ``kyber.decode`` (``sca_ldpc_tpu_torch/utils/spans.py``, recorded
while the profiler is on, which is the window alone).  Over the device time
of the window.  None outside a Kyber run or where the program records no such
counters.
"""

from benchmark.roofline_kyber import special_bound_ms


def read(run):
    if getattr(run, "kind", None) != "kyber" or not run.traces:
        return None
    try:
        from sca_ldpc_tpu_torch.utils import spans
    except ImportError:
        return None
    recorded = spans.snapshot()
    counters = recorded["counters"]
    iterations, frames = counters.get("kyber.frame_iterations", 0), counters.get("kyber.frames", 0)
    if iterations <= 0 or frames <= 0:
        return None
    calls = recorded["spans"].get("kyber.decode", {}).get("calls", 0)
    cfg = run.config
    least_ms = special_bound_ms(iterations, frames, calls, int(cfg["n_b"]), int(cfg["r"]), int(cfg["sum_weight"]),
                                int(cfg["eta"]), int(cfg["bsum"]))
    busy = sum(t["busy_s"] for t in run.traces)
    return 100.0 * least_ms * 1e-3 / busy if busy > 0 else None
