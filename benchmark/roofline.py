"""Least times of the benchmark's kernels on one NVIDIA H100 SXM, frozen.

A copy of the arithmetic of the program's ``ops/kernels/bounds.py``, kept under
the benchmark so that the yardstick does not move when the program changes. A
kernel's least time is the larger of two: the bytes it must move (each input
read once, each output written once) over the device-memory rate, and the
operations its inputs need over the card's peak rate for their kind.  The work
of a BP decode depends on the data (frames stop early), so the count is of the
iterations the given inputs need, as the benchmark's reference decodes them.

Binary product-sum BP computes 2 phi = -log(tanh(x/2)) per message (a check's
edge) and iteration: 4 transcendentals on the special function units (SFU).
The rates are the published peaks at the full 700 W power limit and the
1.98 GHz boost clock: 16 SFU results a clock on each of 132 SMs, and 3.35 TB/s
of HBM3.
"""

HBM_BYTES_S = 3.35e12
SFU_OPS_S = 132 * 16 * 1.98e9


def bound_ms(ops, ops_rate, nbytes):
    """(least time in ms, "operations" or "bytes", whichever binds)."""
    t_ops = 1e3 * ops / ops_rate
    t_bytes = 1e3 * nbytes / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def circulant_messages(iterations, w, n, with_identity=True):
    """Messages of a circulant decode: ``iterations`` (summed over frames)
    times (w + 1) planes (w without the identity) times N checks."""
    return int(iterations) * (w + int(bool(with_identity))) * int(n)


def circulant_bound_ms(iterations, w, n, nbytes, with_identity=True):
    """The circulant decode's (K1-K4's) least time."""
    return bound_ms(4 * circulant_messages(iterations, w, n, with_identity), SFU_OPS_S, nbytes)


def multi_circulant_messages(iterations, p, w, n):
    """Messages of the masked decode over P stacked circulants (K8):
    ``iterations`` times P blocks times (w + 1) planes times N checks; an
    unmeasured row counts like any other, since the decode computes it."""
    return int(iterations) * int(p) * (int(w) + 1) * int(n)


def multi_circulant_bound_ms(iterations, p, w, n, nbytes):
    """The masked decode's least time."""
    return bound_ms(4 * multi_circulant_messages(iterations, p, w, n), SFU_OPS_S, nbytes)
