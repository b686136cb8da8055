#!/usr/bin/env python
"""Capture a ``torch.profiler`` trace of the HQC-128 FER step.

The step of ``parallel.fer.make_fer_step`` with backend ``"fused"`` (the
CUDA kernel K1: syndrome, BP decode and comparison in one launch) on
``[circulant(17669, 20) | I]`` (``random_circulant_first_row`` seed 0, as
the JAX benchmark's ``build_code``), error rate 0.01, up to 30 product-sum
iterations.  The kernel is built and the step run once outside the trace;
the trace then holds ``--steps`` steps.  Writes a Chrome trace (open it in
``chrome://tracing`` or Perfetto) and prints K1's share of the device time
(kernels and copies) and the device's idle share over the traced steps'
span, as one JSON line.

    python -m sca_ldpc_tpu_torch.scripts.profile_trace --out profile_trace.json
"""

import argparse
import json
import os


def build_code(seed=0, n=17669, weight=20):
    """The HQC-128 attack code (the JAX benchmark's ``build_code``)."""
    from sca_ldpc_tpu_torch.codes import CirculantLayout, random_circulant_first_row
    from sca_ldpc_tpu_torch.utils import make_random_state

    first_row = random_circulant_first_row(n, weight, make_random_state(seed))
    return CirculantLayout.from_first_row(first_row, with_identity=True)


def device_split(events, kernel="circulant_bp_kernel"):
    """From a profile's events: (device seconds of ``kernel``, device seconds
    of all device activity, the device's busy span in seconds, idle share of
    that span).  Device activity is every event timed on the device
    (kernels, copies, sets); overlapping intervals are merged."""
    import torch

    spans, kernel_us, total_us = [], 0.0, 0.0
    for evt in events:
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        total_us += end - start
        if kernel in evt.name:
            kernel_us += end - start
    if not spans:
        raise RuntimeError("the profile holds no device activity")
    spans.sort()
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _s, e in spans) - spans[0][0]
    return kernel_us / 1e6, total_us / 1e6, span / 1e6, 1.0 - busy / span


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_trace.json", help="Chrome trace file")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--error-rate", type=float, default=0.01)
    ap.add_argument("--device", default="cuda", help="a CUDA device (the trace reads the card's time)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sca_ldpc_tpu_torch.parallel import make_fer_step
    from sca_ldpc_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if device.type != "cuda":
        raise RuntimeError(f"profile_trace traces the card's FER kernel; device {device} is not a CUDA device")
    lay = build_code()
    step = make_fer_step(lay, np.full(lay.n_vars, args.error_rate, np.float32), device, max_iter=30,
                         backend="fused")
    gen = torch.Generator(device).manual_seed(0)
    step(gen, args.batch)  # builds and loads the kernel outside the trace
    torch.cuda.synchronize()

    successes = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            ok, _conv, _iters = step(gen, args.batch)
            successes += int(ok)
        torch.cuda.synchronize()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    prof.export_chrome_trace(args.out)
    k1_s, device_s, span_s, idle = device_split(prof.events())
    summary = {"trace": args.out, "batch": args.batch, "steps": args.steps, "error_rate": args.error_rate,
               "success_rate": successes / (args.batch * args.steps), "k1_seconds": k1_s,
               "device_seconds": device_s, "device_span_seconds": span_s, "k1_share": k1_s / device_s,
               "idle_share": idle}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
