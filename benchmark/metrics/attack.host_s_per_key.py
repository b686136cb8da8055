"""Host seconds a recovered key (s): the attack window less the benchmark's
decode spans, over the keys recovered; moves ``key_s``."""


def read(run):
    if getattr(run, "kind", None) != "attack" or not run.keys:
        return None
    return (run.host_window_s - sum(run.decode_spans_s)) / run.keys
