"""The program's host milliseconds a FER step outside its wait for the device:
the span ``fer.simulation`` less ``fer.count`` (the count that waits for the
device), over the ``fer.decode`` calls, from
``sca_ldpc_tpu_torch/utils/spans.py`` (recorded while the profiler is on,
which is the window alone); moves ``frames_per_s``.  None outside a FER run
or where the program records no such spans."""


def read(run):
    if getattr(run, "kind", None) != "fer":
        return None
    try:
        from sca_ldpc_tpu_torch.utils import spans
    except ImportError:
        return None
    recorded = spans.snapshot()["spans"]
    if not all(n in recorded for n in ("fer.simulation", "fer.count", "fer.decode")):
        return None
    host_s = recorded["fer.simulation"]["host_s"] - recorded["fer.count"]["host_s"]
    return 1000.0 * host_s / recorded["fer.decode"]["calls"]
