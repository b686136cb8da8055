"""Share of the FER window in which no operation runs on the device (%),
the largest over the ranks; moves ``frames_per_s``."""


def read(run):
    if getattr(run, "kind", None) != "fer" or not run.traces:
        return None
    return max(100.0 * (1.0 - t["busy_s"] / t["window_s"]) for t in run.traces)
