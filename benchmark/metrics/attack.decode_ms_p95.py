"""95th percentile of the attack window's decodes (ms), each timed by the
benchmark from the attack's call into the decoder until the decision is on
the host (the masked arrays, K8 and the statistics); moves ``key_s``."""

import numpy as np


def read(run):
    if getattr(run, "kind", None) != "attack" or not run.decode_spans_s:
        return None
    return float(np.percentile(np.asarray(run.decode_spans_s) * 1e3, 95))
