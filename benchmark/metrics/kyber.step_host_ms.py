"""The program's host milliseconds a Kyber step outside its wait for the
device: the span ``kyber.simulation`` less ``kyber.count`` (the counts that
wait for the device), over the ``kyber.decode`` calls, from
``sca_ldpc_tpu_torch/utils/spans.py`` (recorded while the profiler is on,
which is the window alone); moves ``frames_per_s``.  None outside a Kyber run
or where the program records no such spans."""


def read(run):
    if getattr(run, "kind", None) != "kyber":
        return None
    try:
        from sca_ldpc_tpu_torch.utils import spans
    except ImportError:
        return None
    recorded = spans.snapshot()["spans"]
    if not all(n in recorded for n in ("kyber.simulation", "kyber.count", "kyber.decode")):
        return None
    host_s = recorded["kyber.simulation"]["host_s"] - recorded["kyber.count"]["host_s"]
    return 1000.0 * host_s / recorded["kyber.decode"]["calls"]
