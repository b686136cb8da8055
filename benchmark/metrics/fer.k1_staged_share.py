"""Share of the traced window's frames that K1 decoded in its staged form
(%): the program's counter ``fer.k1_staged_frames`` (the FER step counts a
step's frames there when K1's launch configuration stages the c2v planes
through shared memory, else 0) over ``fer.frames``
(``sca_ldpc_tpu_torch/utils/spans.py``, recorded while the profiler is on,
which is the window alone); moves ``frames_per_s``.  None outside a FER run,
where the program records no frames, or where it keeps no such counter."""


def read(run):
    if getattr(run, "kind", None) != "fer":
        return None
    try:
        from sca_ldpc_tpu_torch.utils import spans
    except ImportError:
        return None
    counters = spans.snapshot()["counters"]
    frames = counters.get("fer.frames", 0)
    if frames <= 0 or "fer.k1_staged_frames" not in counters:
        return None
    return 100.0 * counters["fer.k1_staged_frames"] / frames
