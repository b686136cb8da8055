"""Masked multi-circulant decode's share of its least time (%), moves
``decode_ms_p95``.

Over the decodes the reference re-computed: the least time of each by
``benchmark/roofline.py``'s ``multi_circulant_bound_ms`` (4 transcendentals a
message on the SFU, P x (w + 1) x N messages an iteration, for the iterations
the reference needed on the same checks; or the decode's inputs and decisions
moved once), over the device time inside that decode's span in the trace.
"""

from benchmark.roofline import multi_circulant_bound_ms


def read(run):
    if getattr(run, "kind", None) != "attack" or not run.traces:
        return None
    spans = run.traces[0]["spans"].get("bench.decode", [])
    n, w = int(run.config["n"]), int(run.config["code_weight"])
    least = device = 0.0
    for idx, iters, blocks in run.reference_iterations:
        if idx >= len(spans) or spans[idx][1] <= 0:
            continue
        nbytes = 4 * n * (2 + 3 * blocks) + 4 * blocks * w
        least += multi_circulant_bound_ms(iters, blocks, w, n, nbytes)[0] * 1e-3
        device += spans[idx][1]
    return 100.0 * least / device if device > 0 else None
