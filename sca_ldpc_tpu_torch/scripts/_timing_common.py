"""Shared plumbing for the timing-attack artifact scripts (the port's copy of
the JAX package's ``scripts/_timing_common.py``).

Every script (a) records the start-of-attack calibration separately from
the live (recalibrated) EPSILON, and (b) writes a partial artifact every
``interval`` seconds from a daemon thread, so a killed run still leaves its
decision/decap counters and recalibration history behind.
"""

import json
import os
import threading
import time


def channel_fields(tracking):
    """Timing-channel counters + drift-recalibration evidence for one
    attack's ``tracking`` (fields are None-safe before the channel
    exists)."""
    channel = getattr(tracking, "timing_channel", None)
    calib = getattr(tracking, "timing_calibration", None)
    fields = {
        "oracle_decisions": tracking.num_oracle_calls,
        "initial_calibration": calib,
    }
    if channel is None:
        return fields
    acc_f, acc_s = channel.empirical_accuracy()
    fields.update({
        "timed_decapsulations": channel.num_decaps,
        "channel_measurements": channel.num_measurements,
        "live_accuracy_fail": acc_f,
        "live_accuracy_success": acc_s,
        "final_epsilon": list(channel.epsilon) if channel.epsilon else None,
        "num_recalibrations": channel.num_recals,
        "recalibration_decaps": channel.num_recal_decaps,
        "recalibration_history": channel.recal_history,
    })
    return fields


def write_json(path, artifact):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(artifact, f, indent=1)
    os.replace(tmp, path)


def start_partial_writer(path, snapshot_fn, interval=60):
    """Write ``snapshot_fn()`` (tagged ``"partial": True``) to ``path``
    every ``interval`` seconds until ``stop()`` is called.  Returns the
    stop function."""
    stop_evt = threading.Event()

    def loop():
        while not stop_evt.wait(interval):
            try:
                artifact = snapshot_fn()
                artifact["partial"] = True
                artifact["snapshot_unix_time"] = int(time.time())
                write_json(path, artifact)
            except Exception:
                pass  # a failed snapshot must never kill the attack

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return stop_evt.set


def spy_trackings(on_new):
    """Call ``on_new(tracking)`` for every ``HqcSimulationTracking`` made
    until the returned function is called (it restores the class)."""
    from ..models.hqc.tracking import HqcSimulationTracking

    orig_init = HqcSimulationTracking.__init__

    def spy_init(self, *a, **kw):
        orig_init(self, *a, **kw)
        on_new(self)

    HqcSimulationTracking.__init__ = spy_init

    def restore():
        HqcSimulationTracking.__init__ = orig_init

    return restore


def stats_fields(tracking, ok):
    """The finished run's calibrated EPSILON, success and last decoder
    stats."""
    stats = tracking.decoder_stats[-1] if tracking.decoder_stats else {}
    calib = getattr(tracking, "timing_calibration", None)
    return {
        "calibrated_epsilon": (
            list(calib["initial_epsilon"]) if calib
            else list(tracking.params.EPSILON)
        ),
        "success": bool(ok),
        "decoder_stats_last": {k: (bool(v) if isinstance(v, bool) else v)
                               for k, v in stats.items()},
    }
