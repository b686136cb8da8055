"""K7's least time on one NVIDIA H100 SXM, frozen.

A copy of the arithmetic of the program's ``ops/kernels/bounds.py``
``chain_pairs`` and ``chain_bound_ms`` (the q-ary min-sum kernels K5-K7), kept
under the benchmark so that the yardstick does not move when the program
changes; the rates and :func:`~benchmark.roofline.bound_ms` are
``benchmark/roofline.py``'s.  A check update of the two-alphabet decode is one
``chain_exclusive`` over its SW coefficient messages (support B) with the sum
variable's channel (support BSUM) as the extra operand: the add+min pairs
whose operands' indices are in range, 2 FP32 instructions a pair (an add and a
min; the 67 TFLOP/s peak counts an FMA as 2 operations, which this work cannot
use).  K7 runs every iteration (no early exit), so a frame is R check updates
an iteration.  The FP32 rate is the published peak at the full 700 W power
limit and the 1.98 GHz boost clock: 128 FP32 instructions a clock on each of
132 SMs.
"""

from benchmark.roofline import bound_ms

FP32_INSTR_S = 132 * 128 * 1.98e9


def chain_pairs(d, b_sup, s_mid, s_out=None, se=0):
    """Add+min pairs of one ``chain_exclusive`` over ``d`` operands of
    support ``b_sup`` (an extra operand of support ``se`` if not 0): of the
    loop passes of its prefix, suffix, combine and extra convolutions, those
    whose b-index falls inside b's support."""
    s_out = s_mid if s_out is None else s_out
    s_pre = s_out + se

    def cap(count):
        return min(count * b_sup, s_pre + (d - 1 - count) * b_sup, s_mid)

    def conv(sa, sb, out, ha=None, hb=None):
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
    """(least time in ms, what binds) of ``chains`` chain updates of
    :func:`chain_pairs` pairs, 2 FP32 instructions a pair, or ``nbytes``."""
    return bound_ms(2 * chains * chain_pairs(d, b_sup, s_mid, s_out, se), FP32_INSTR_S, nbytes)


def special_bytes(frames, calls, n_b, r, sw, b, bsum):
    """Bytes K7 must move: each frame's channels read once (the coefficients'
    [N_b, 2B+1], the sums' [R, 2BSUM+1] in row order and their signed copy,
    f32) and its decisions written once (int32); each launch's adjacency read
    once (``bvar_idx``, ``bvar_sign``, ``bvar_mask`` [R, SW], ``var_flat``
    [N_b, DV], ``sum_sign`` [R], int32)."""
    dv = -(-r * sw // n_b)
    per_frame = 4 * (n_b * (2 * b + 1) + 2 * r * (2 * bsum + 1)) + 4 * (n_b + r)
    return frames * per_frame + calls * 4 * (3 * r * sw + n_b * dv + r)


def special_bound_ms(frame_iterations, frames, calls, n_b, r, sw, b, bsum):
    """K7's least time in ms for ``frame_iterations`` (frames times the
    iterations each ran) over ``frames`` frames in ``calls`` launches."""
    nbytes = special_bytes(frames, calls, n_b, r, sw, b, bsum)
    return chain_bound_ms(frame_iterations * r, sw, b, (2 * sw - 1) * b, b, bsum, nbytes)[0]
