"""Plain PyTorch reference of product-sum syndrome BP on stacked circulant codes.

The code is ``H = [[C_1]; ...; [C_P]] | I_{P*N}``: P circulants of size N over
the same N variables, each check row with an identity column of its own.
``circulant(c)[i, j] = c[(i - j) mod N]``, so check ``i`` of block ``p``
touches the variables ``(i - k) mod N`` for each support offset ``k`` of the
block's first row.  One ``[N]`` message plane per offset; aligning a plane
with its checks is a cyclic shift (``torch.roll``).  The FER code
``[circulant | I]`` is the case P = 1 with the identity priors equal to the
circulant's.

Semantics (the HQC attack's decoder, ``ldpc``'s product-sum with early exit):
the first iteration sees the rolled priors; phi(x) = -log(tanh(x/2)) with x
clipped to [1e-9, 60]; a check's extrinsic phi-sum is clamped at 1e-9 from
below; v2c messages are clipped to [-60, 60].  After every iteration each frame
decides hard on its totals, and a frame whose decisions meet the syndrome stops
with those decisions (its iteration count is that iteration); a frame that never
does keeps the last iteration's decisions.

``store`` (optional) rounds the v2c and c2v messages where they are stored: the
lower-precision control passes :func:`round_bf16`.  Runs on any device; it
imports nothing of the program under test.
"""

import torch

BIG = 60.0


def _phi_(x):
    """phi(x) = -log(tanh(x / 2)) of ``x`` clipped to [1e-9, 60], in place."""
    return x.clamp_(1e-9, BIG).mul_(0.5).tanh_().log_().neg_()


def round_bf16(x):
    """Round float32 messages to bfloat16 (nearest even) and back."""
    return x.to(torch.bfloat16).to(torch.float32)


def _planes(x, shifts):
    """[B, N] -> [B, P, W, N]: plane (p, t) is ``x`` rolled by ``shifts[p][t]``."""
    return torch.stack([torch.stack([torch.roll(x, k, dims=-1) for k in kp], dim=1) for kp in shifts], dim=1)


def _decode_block(prior_c, prior_i, syndrome, shifts, max_iter, store):
    b, p, n = syndrome.shape
    w = len(shifts[0])
    syn8 = syndrome.to(torch.int8)
    dev = syndrome.device

    e_c_out = (prior_c < 0).to(torch.int8)
    e_i_out = (prior_i < 0).to(torch.int8)
    conv = torch.zeros(b, dtype=torch.bool, device=dev)
    iters = torch.zeros(b, dtype=torch.int32, device=dev)

    active = torch.arange(b, device=dev)
    pc, pi, s8 = prior_c, prior_i, syn8
    v2c = _planes(pc, shifts)
    for it in range(max_iter):
        if active.numel() == 0:
            break
        planes = torch.cat([v2c, pi[:, :, None, :]], dim=2)  # [A, P, W+1, N]
        neg = planes < 0  # a message's sign; the check's is the parity of its planes' and the syndrome's
        ext_neg = neg ^ ((neg.sum(dim=2, keepdim=True, dtype=torch.int32) + s8[:, :, None, :]) % 2).bool()
        pm = _phi_(planes.abs_())
        del planes, neg
        ext = _phi_(torch.sub(torch.sum(pm, dim=2, keepdim=True), pm).clamp_(min=1e-9))
        del pm
        c2v = torch.where(ext_neg, -ext, ext)
        del ext, ext_neg
        if store is not None:
            c2v = store(c2v)
        # variable totals: the planes realigned at their variables, summed in (block, plane) order, then the prior
        tot_c = pc + sum(torch.roll(c2v[:, bi, t], -k, dims=-1)
                         for bi, kp in enumerate(shifts) for t, k in enumerate(kp))
        tot_i = pi + c2v[:, :, w]
        v2c = torch.clamp(_planes(tot_c, shifts) - c2v[:, :, :w], -BIG, BIG)
        del c2v
        if store is not None:
            v2c = store(v2c)
        e_c = (tot_c < 0).to(torch.int8)
        e_i = (tot_i < 0).to(torch.int8)
        s = torch.stack([sum(torch.roll(e_c, k, dims=-1) for k in kp) for kp in shifts], dim=1)
        ok = torch.all(((s + e_i) % 2 == s8).reshape(len(active), -1), dim=-1)
        e_c_out[active] = e_c
        e_i_out[active] = e_i
        iters[active] = it + 1
        conv[active] = ok
        if bool(ok.any()):
            keep = ~ok
            active, pc, pi, s8, v2c = (x[keep] for x in (active, pc, pi, s8, v2c))
    return e_c_out, e_i_out, conv, iters


def decode(prior_c, prior_i, syndrome, shifts, max_iter, store=None, block=None):
    """Decode ``B`` frames of one code.

    prior_c [B, N] float32 LLRs of the shared variables; prior_i [B, P, N]
    float32 LLRs of the identity columns (0 for an unmeasured row); syndrome
    [B, P, N] 0/1; shifts: P sequences of W support offsets.  Frames are
    decoded ``block`` at a time (all at once by default).  Returns (e_c [B, N]
    int8, e_i [B, P, N] int8, conv [B] bool, iters [B] int32)."""
    shifts = [[int(k) % syndrome.shape[-1] for k in kp] for kp in shifts]
    b = syndrome.shape[0]
    block = b if block is None else max(1, int(block))
    outs = [_decode_block(prior_c[s:s + block], prior_i[s:s + block], syndrome[s:s + block], shifts, max_iter, store)
            for s in range(0, b, block)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def fer_decode(errors, shifts, error_rate, max_iter, store=None, block=None):
    """The FER frame of ``[circulant | I]``: [B, 2N] 0/1 error bits in, their
    syndrome decoded under the uniform prior ``log((1 - p) / p)``.  Returns
    (success [B] bool: the decisions equal the error bits, converged [B] bool:
    they meet the syndrome, iters [B] int32)."""
    b, n2 = errors.shape
    n = n2 // 2
    e = errors.to(torch.int32)
    syn = (sum(torch.roll(e[:, :n], int(k), dims=-1) for k in shifts) + e[:, n:]) % 2
    llr = torch.log(torch.tensor((1.0 - error_rate) / error_rate, dtype=torch.float64)).item()
    prior = torch.full((b, n), llr, dtype=torch.float32, device=errors.device)
    block = b if block is None else max(1, int(block))
    ok, conv, iters = [], [], []
    for s in range(0, b, block):
        e_c, e_i, cv, it = _decode_block(prior[s:s + block], prior[s:s + block, None, :],
                                            syn[s:s + block, None, :], [[int(k) % n for k in shifts]],
                                            max_iter, store)
        ok.append(torch.all(torch.cat([e_c, e_i[:, 0]], dim=-1).to(torch.int32) == e[s:s + block], dim=-1))
        conv.append(cv)
        iters.append(it)
    return torch.cat(ok), torch.cat(conv), torch.cat(iters)
