"""FER step's share of its least time (%), moves ``frames_per_s``.

The least time of the window's steps by ``benchmark/roofline.py``: 4
transcendentals a message on the SFU, or the error bits written once and read
once, whichever is larger.  The messages are (w + 1) x N a frame and
iteration after the first, for the iterations the frames need: at each error
rate of the sweep, the window's frames at that rate times the mean the
benchmark's reference needs on the sampled steps' frames (under one constant
prior the first iteration needs no phi a message).  Over the device time of
the window (summed over the ranks), in which only the steps run.
"""

from benchmark.roofline import circulant_bound_ms


def read(run):
    if getattr(run, "kind", None) != "fer" or not run.traces or run.later_iterations <= 0:
        return None
    n, w = int(run.config["n"]), int(run.config["code_weight"])
    least_ms, _binds = circulant_bound_ms(run.later_iterations, w, n, run.frames * 4 * n)
    busy = sum(t["busy_s"] for t in run.traces)
    return 100.0 * least_ms * 1e-3 / busy if busy > 0 else None
