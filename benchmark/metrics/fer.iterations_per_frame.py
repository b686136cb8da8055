"""Iterations a frame that the FER step's kernel ran, over the traced window:
the program's counters ``fer.frame_iterations`` (each frame's count, written
by K1 or K4 through ``iters_out``) over ``fer.frames``
(``sca_ldpc_tpu_torch/utils/spans.py``, recorded while the profiler is on,
which is the window alone); moves ``frames_per_s``.  None outside a FER run
or where the program records no such counters."""


def read(run):
    if getattr(run, "kind", None) != "fer":
        return None
    try:
        from sca_ldpc_tpu_torch.utils import spans
    except ImportError:
        return None
    counters = spans.snapshot()["counters"]
    frames = counters.get("fer.frames", 0)
    if frames <= 0:
        return None
    return counters.get("fer.frame_iterations", 0) / frames
