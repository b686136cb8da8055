"""Min-plus (tropical) convolution primitives for q-ary check-node updates.

The reference's q-ary check update enumerates every zero-sum configuration of
symbol values along a check and takes a running min (decoder.rs:281-401,
585-631) — up to ``(2B+1)^(DC-1)`` configurations per check.  The identical
quantity is computed here as a chain of min-plus convolutions:

    beta_j[d] = min over {d_l} with sum_l d_l = 0 and d_j = d
                of sum_{l != j} alpha_l[d_l]
              = (min-plus conv of all alpha_l, l != j) evaluated at -d

which costs ``O(DC * W * Q)`` per check with the prefix/suffix trick.
Infinite LLRs are carried as a large finite constant so min-plus arithmetic
never produces NaNs.

Supports are tracked tightly: every intermediate is stored at (and computed
over) exactly the symbol window that can influence the final ``s_out``-wide
outputs.  The supports, caps and half-support loops are those of the JAX
package's ``minplus.py``, so the set of terms behind every output is the
same; each term is one f32 add and the rest are mins, so the outputs are
bitwise equal to it.  :func:`chain_exclusive` is also the plain version of
the CUDA kernel ``chain_exclusive_cuda`` (``kernels/qary_cuda.py``).
"""

import torch
import torch.nn.functional as F

# "Infinity" for min-plus arithmetic.  Large enough to dominate any real LLR
# sum, small enough that summing DC of them stays far below float32 max.
BIG = 1e15


def clip_inf(x):
    """Replace +inf by the min-plus BIG constant (and clip above it)."""
    return torch.clamp_max(torch.nan_to_num(x, posinf=BIG), BIG)


def identity(width, device=None):
    """The min-plus convolution identity: delta at the center symbol 0."""
    v = torch.full((width,), BIG, dtype=torch.float32, device=device)
    v[width // 2] = 0.0
    return v


def conv(a, b, s_out, a_half_support=None, b_half_support=None):
    """Centered min-plus convolution.

    ``a``: [..., 2*Sa+1] supported on symbols [-Sa..Sa]; ``b``: [..., 2*Sb+1];
    output: [..., 2*s_out+1] with ``out[k] = min_i a[i] + b[(k - s_out) - (i - Sa) + Sb]``
    (terms whose b-index falls outside b's support contribute BIG).

    ``a_half_support`` / ``b_half_support`` declare that symbols outside
    [-h..h] of that operand are BIG; the loop runs over whichever operand has
    the narrower declared window (min-plus conv commutes).
    """
    sa = (a.shape[-1] - 1) // 2
    sb = (b.shape[-1] - 1) // 2
    ha = sa if a_half_support is None else min(int(a_half_support), sa)
    hb = sb if b_half_support is None else min(int(b_half_support), sb)
    if hb < ha:
        a, b = b, a
        sa, sb = sb, sa
        ha, hb = hb, ha

    w_out = 2 * s_out + 1
    off = sa + sb - s_out
    pad = max(0, sa + s_out - sb)
    b_pad = F.pad(b, (pad, pad), value=BIG)

    out = None
    for i in range(sa - ha, sa + ha + 1):
        start = off - i + pad
        term = a[..., i : i + 1] + b_pad[..., start : start + w_out]
        out = term if out is None else torch.minimum(out, term)
    return torch.clamp_max(out, BIG)


def chain_exclusive(alphas, s_mid, extra=None, s_out=None):
    """For a stack of operands along an axis, the min-plus conv of all-but-one.

    ``alphas``: [..., D, Q] (D operands of width Q each).  Returns
    ``ext``: [..., D, 2*s_out+1] where ``ext[..., j, :]`` is the conv of all
    operands except j (optionally also convolved with ``extra`` [..., We]),
    restricted to output symbols [-s_out..s_out].  ``s_out`` defaults to
    ``s_mid``, which must cover the support of any (D-1)-operand partial conv
    (plus extra's support if given).
    """
    d = alphas.shape[-2]
    b_sup = (alphas.shape[-1] - 1) // 2
    if s_out is None:
        s_out = s_mid
    se = 0 if extra is None else (extra.shape[-1] - 1) // 2
    s_pre = s_out + se  # combine-stage output support (before extra)

    def cap(count):
        """Stored support of a partial conv of ``count`` operands."""
        return min(count * b_sup, s_pre + (d - 1 - count) * b_sup, s_mid)

    ident = torch.zeros(alphas.shape[:-2] + (1,), dtype=alphas.dtype, device=alphas.device)
    prefix = [ident]  # support 0
    for j in range(d - 1):
        prefix.append(conv(alphas[..., j, :], prefix[-1], cap(j + 1), b_half_support=j * b_sup))
    suffix = [ident]
    for j in range(d - 1, 0, -1):
        count = d - j
        suffix.append(
            conv(alphas[..., j, :], suffix[-1], cap(count), b_half_support=(count - 1) * b_sup)
        )
    suffix = suffix[::-1]

    outs = []
    for j in range(d):
        # prefix[j] combines j operands, suffix[j] combines d-1-j.
        e = conv(
            prefix[j],
            suffix[j],
            s_pre,
            a_half_support=j * b_sup,
            b_half_support=(d - 1 - j) * b_sup,
        )
        if extra is not None:
            e = conv(extra, e, s_out, a_half_support=se, b_half_support=s_pre)
        outs.append(e)
    return torch.stack(outs, dim=-2)
