"""Share of the Kyber window in which no operation runs on the device (%);
moves ``frames_per_s``."""


def read(run):
    if getattr(run, "kind", None) != "kyber" or not run.traces:
        return None
    t = run.traces[0]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
