"""Share of the attack window in which no operation runs on the device (%);
moves ``key_s``."""


def read(run):
    if getattr(run, "kind", None) != "attack" or not run.traces:
        return None
    t = run.traces[0]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
