"""Least times of the port's kernels on one NVIDIA H100 SXM (the bound).

A kernel's bound is the larger of two times: the bytes its function must move
(each input read once, each output written once) over the device-memory
rate, and the operations its inputs need over the card's peak rate for their
kind.  Where the work depends on the data (BP iterations that end early),
the count is what the given inputs needed.  The rates are the published
peaks at the full 700 W power limit.

- K1–K4 and K8 (binary BP, product-sum): 2 phi = -log(tanh(x/2)) per
  message (check, plane) and iteration, so 4 transcendentals a message, on
  the special function units (SFU);
- K5–K7 (q-ary min-sum): the add+min pairs of the min-plus chain
  (``minplus.chain_exclusive``) whose operands' indices are in range, 2 FP32
  instructions a pair (an add and a min; the 67 TFLOP/s peak counts an FMA
  as 2 operations, which this work cannot use).
"""

HBM_BYTES_S = 3.35e12  # HBM3, bytes a second
FP32_INSTR_S = 132 * 128 * 1.98e9  # FP32 instructions a second: 128 a clock on each of 132 SMs at 1.98 GHz
SFU_OPS_S = 132 * 16 * 1.98e9  # transcendentals a second: 16 a clock on each of 132 SMs at 1.98 GHz


def bound_ms(ops, ops_rate, nbytes):
    """(bound in ms, "operations" or "bytes", whichever binds)."""
    t_ops = 1e3 * ops / ops_rate
    t_bytes = 1e3 * nbytes / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def circulant_messages(iterations, w, n, with_identity=True):
    """Messages a circulant BP decode computes: ``iterations`` (the sum of
    each frame's iteration count) times (w + 1) planes (w without the
    identity) times N checks."""
    return int(iterations) * (w + int(bool(with_identity))) * int(n)


def circulant_bound_ms(iterations, w, n, nbytes, with_identity=True):
    """K1–K4's bound: 4 transcendentals a message on the SFU, or ``nbytes``."""
    return bound_ms(4 * circulant_messages(iterations, w, n, with_identity), SFU_OPS_S, nbytes)


def multi_circulant_messages(iterations, p, w, n):
    """Messages K8's masked decode computes: ``iterations`` (the sum of each
    frame's iteration count) times P blocks times (w + 1) planes (the
    identity member with them) times N checks.  An inert row counts like any
    other: the decode computes it."""
    return int(iterations) * int(p) * (int(w) + 1) * int(n)


def multi_circulant_bound_ms(iterations, p, w, n, nbytes):
    """K8's bound: 4 transcendentals a message on the SFU (as K1–K4), or
    ``nbytes``."""
    return bound_ms(4 * multi_circulant_messages(iterations, p, w, n), SFU_OPS_S, nbytes)


def chain_pairs(d, b_sup, s_mid, s_out=None, se=0):
    """Add+min pairs of one ``chain_exclusive`` over ``d`` operands of
    support ``b_sup`` (an extra operand of support ``se`` if not 0): of the
    loop passes of its prefix, suffix, combine and extra convolutions, those
    whose b-index falls inside b's support.  A pass outside it adds BIG (a
    kernel reads it from a BIG guard or skips it) and changes no output: every
    output has an in-range term, and a finite term below 3.4e7 plus BIG
    rounds to BIG."""
    s_out = s_mid if s_out is None else s_out
    s_pre = s_out + se

    def cap(count):
        return min(count * b_sup, s_pre + (d - 1 - count) * b_sup, s_mid)

    def conv(sa, sb, out, ha=None, hb=None):
        # minplus.conv's loop: i over a's declared window, the swap when b's is
        # narrower, out[k] from b[off - i + k]; count the k whose index is in b
        ha = sa if ha is None else min(ha, sa)
        hb = sb if hb is None else min(hb, sb)
        if hb < ha:
            sa, sb, ha, hb = sb, sa, hb, ha
        off = sa + sb - out
        return sum(max(0, min(2 * out, 2 * sb + i - off) - max(0, i - off) + 1) for i in range(sa - ha, sa + ha + 1))

    pairs, prefix, suffix = 0, [0], [0]
    for j in range(d - 1):
        pairs += conv(b_sup, prefix[-1], cap(j + 1), hb=j * b_sup)
        prefix.append(cap(j + 1))
    for count in range(1, d):
        pairs += conv(b_sup, suffix[-1], cap(count), hb=(count - 1) * b_sup)
        suffix.append(cap(count))
    suffix = suffix[::-1]
    for j in range(d):
        pairs += conv(prefix[j], suffix[j], s_pre, ha=j * b_sup, hb=(d - 1 - j) * b_sup)
        if se:
            pairs += conv(se, s_pre, s_out, ha=se, hb=s_pre)
    return pairs


def chain_bound_ms(chains, d, b_sup, s_mid, s_out, se, nbytes):
    """K5–K7's bound: ``chains`` chain updates of :func:`chain_pairs` pairs,
    2 FP32 instructions a pair, or ``nbytes``."""
    return bound_ms(2 * chains * chain_pairs(d, b_sup, s_mid, s_out, se), FP32_INSTR_S, nbytes)
