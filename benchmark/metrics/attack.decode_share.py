"""Share of the attack window inside the decodes (%): the benchmark's decode
spans (the attack's call into the decoder until the decision is on the host)
over the window; moves ``key_s``."""


def read(run):
    if getattr(run, "kind", None) != "attack" or not run.decode_spans_s:
        return None
    return 100.0 * sum(run.decode_spans_s) / run.host_window_s
