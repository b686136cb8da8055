"""Binary BP on circulant codes via rolled message planes.

For ``H = [circulant(c) | I]`` (the HQC attack code family, make_code.py:220-273)
every nonzero diagonal of the circulant is one ``[batch, N]`` message plane;
check/variable alignment is a ``torch.roll`` per plane.

Two implementations of the same decode:

- :func:`_circulant_bp` is the plain PyTorch version, a line-by-line
  counterpart of the JAX package's ``_circulant_bp``.  It runs on any device
  and is the reference the CUDA kernel is held against.
- on a CUDA device :class:`CirculantBPDecoder` calls the hand-written kernel
  (``ops/kernels/circulant_cuda.py``), which keeps each frame's iterations
  inside one thread block and exits per frame.  Both give the same outputs:
  a frame's latched estimate does not depend on when the others converge.

The identity block's variables have degree 1, so their v2c messages equal
their channel priors, constant across iterations.
"""

import numpy as np
import torch

from ..codes.layout import CirculantLayout

_BIG = 60.0  # LLR clip: tanh saturates at float32 well below this
MIN_SUM_ALPHA = 0.75  # normalized min-sum scale (standard 0.7-0.8 range)


def _phi(x):
    """Gallager phi(x) = -log(tanh(x/2)), a self-inverse on (0, inf)."""
    x = torch.clamp(x, 1e-9, _BIG)
    return -torch.log(torch.tanh(0.5 * x))


def _plane_check_update(planes, sign_syn, method):
    """Extrinsic check->variable messages, reducing across axis 1 (planes).

    planes: [B, P, N] incoming LLRs (check-aligned); sign_syn: [B, N] +-1.
    """
    sgn = torch.where(planes >= 0, 1.0, -1.0)
    mag = torch.abs(planes)
    tot_sign = torch.prod(sgn, dim=1, keepdim=True) * sign_syn[:, None, :]
    ext_sign = tot_sign * sgn

    if method == "product_sum":
        pm = _phi(mag)
        tot = torch.sum(pm, dim=1, keepdim=True)
        ext_mag = _phi(torch.clamp(tot - pm, min=1e-9))
    elif method == "min_sum":
        min1 = torch.amin(mag, dim=1, keepdim=True)
        is1 = mag == min1
        min2 = torch.amin(torch.where(is1, torch.inf, mag), dim=1, keepdim=True)
        cnt = torch.sum(is1, dim=1, keepdim=True)
        ext_mag = torch.where(is1 & (cnt == 1), min2, min1)
        ext_mag = MIN_SUM_ALPHA * torch.clamp(ext_mag, max=_BIG)
    else:
        raise ValueError(f"unknown bp method: {method}")
    return ext_sign * ext_mag


def _circulant_bp_frames(prior_c, prior_i, syndrome, shifts, with_identity, max_iter, method):
    """Plain decode with per-frame iteration counts.

    prior_c, prior_i: [B, N] float32 LLRs (prior_i ignored without identity);
    syndrome: [B, N] 0/1.  Returns (e [B, 2N or N] int32, conv [B] bool,
    iters [B] int32): the iteration at which each frame first converged, or
    the number run if it never did.
    """
    b, n = syndrome.shape
    w = len(shifts)
    syndrome8 = syndrome.to(torch.int8)
    sign_syn = (1 - 2 * syndrome8).to(torch.float32)

    # v2c planes, check-major: plane t, position i = msg from var (i - k_t).
    # The first iteration sees the unclipped rolled priors.
    v2c = torch.stack([torch.roll(prior_c, k, dims=-1) for k in shifts], dim=1)

    def iterate(v2c):
        if with_identity:
            planes = torch.cat([v2c, prior_i[:, None, :]], dim=1)
        else:
            planes = v2c
        c2v = _plane_check_update(planes, sign_syn, method)  # [B, P, N]
        c2v_c = c2v[:, :w, :]
        # Variable totals: align each plane at its variable index and sum.
        tot_c = prior_c + sum(torch.roll(c2v_c[:, t, :], -k, dims=-1) for t, k in enumerate(shifts))
        # Extrinsic + realign in one roll of the totals plane.
        v2c_new = torch.stack([torch.roll(tot_c, k, dims=-1) for k in shifts], dim=1) - c2v_c
        v2c_new = torch.clamp(v2c_new, -_BIG, _BIG)
        tot_i = prior_i + c2v[:, w, :] if with_identity else None
        return v2c_new, tot_c, tot_i

    def syndrome_of(e_c, e_i):
        s = sum(torch.roll(e_c, k, dims=-1) for k in shifts)
        if with_identity:
            s = s + e_i
        return s % 2

    e_out_c = (prior_c < 0).to(torch.int8)
    e_out_i = (prior_i < 0).to(torch.int8)
    conv = torch.zeros((b,), dtype=torch.bool, device=syndrome.device)
    iters = torch.zeros((b,), dtype=torch.int32, device=syndrome.device)
    it = 0
    while it < max_iter and not bool(torch.all(conv)):
        v2c, tot_c, tot_i = iterate(v2c)
        e_c = (tot_c < 0).to(torch.int8)
        e_i = (tot_i < 0).to(torch.int8) if with_identity else torch.zeros_like(e_c)
        ok = torch.all(syndrome_of(e_c, e_i) == syndrome8, dim=-1)
        # latch each frame's first converged estimate (ldpc semantics)
        e_out_c = torch.where(conv[:, None], e_out_c, e_c)
        e_out_i = torch.where(conv[:, None], e_out_i, e_i)
        iters = torch.where(conv, iters, it + 1)
        conv = conv | ok
        it += 1
    e = torch.cat([e_out_c, e_out_i], dim=-1) if with_identity else e_out_c
    return e.to(torch.int32), conv, iters


def _circulant_bp(prior_c, prior_i, syndrome, shifts, with_identity, max_iter, method):
    """The JAX package's ``_circulant_bp`` in plain PyTorch: returns
    (e int32, conv [B] bool, it), where ``it`` (0-d int32) is the number of
    batch-wide iterations — the largest per-frame count."""
    e, conv, iters = _circulant_bp_frames(
        prior_c, prior_i, syndrome, shifts, with_identity, max_iter, method
    )
    return e, conv, _batch_iterations(iters)


def _batch_iterations(iters):
    """Batch-wide iteration count from per-frame counts: the largest."""
    return iters.max() if iters.numel() else torch.zeros((), dtype=torch.int32, device=iters.device)


class CirculantBPDecoder:
    """Batched syndrome BP decoder over a :class:`CirculantLayout`.

    Inputs (numpy arrays or tensors) are placed on ``device``.  On a CUDA
    device the layout, with or without the identity block, decodes with the
    CUDA kernel; on the CPU the plain PyTorch version runs.
    """

    def __init__(self, layout: CirculantLayout, max_iter=50, method="product_sum", device="cuda"):
        self.layout = layout
        self.max_iter = int(max_iter)
        self.method = method
        self.device = torch.device(device)

    @staticmethod
    def _to_llr(p_error, n, b):
        p = torch.clamp(p_error.to(torch.float32), 1e-30, 1 - 1e-12)
        llr = torch.log((1.0 - p) / p)
        return torch.broadcast_to(llr, (b, n))

    def decode_syndrome(self, syndrome, channel_probs, return_aux=False):
        """channel_probs: [n_vars] or [B, n_vars] per-position error probability."""
        squeeze = np.ndim(syndrome) == 1
        syn = torch.atleast_2d(torch.as_tensor(syndrome, device=self.device).to(torch.int32))
        b = syn.shape[0]
        lay = self.layout
        cp = torch.atleast_2d(torch.as_tensor(channel_probs, dtype=torch.float32, device=self.device))
        prior_c = self._to_llr(cp[..., : lay.n], lay.n, b).contiguous()
        if lay.with_identity:
            prior_i = self._to_llr(cp[..., lay.n :], lay.n, b).contiguous()
        else:
            prior_i = torch.zeros((b, lay.n), dtype=torch.float32, device=self.device)
        if self.device.type == "cuda":
            from .kernels.circulant_cuda import circulant_bp_cuda

            e, conv, iters = circulant_bp_cuda(
                prior_c, prior_i, syn, lay.shifts, self.max_iter, self.method, lay.with_identity
            )
            it = _batch_iterations(iters)
        else:
            e, conv, it = _circulant_bp(
                prior_c, prior_i, syn, lay.shifts, lay.with_identity, self.max_iter, self.method
            )
        if squeeze:
            e, conv = e[0], conv[0]
        return (e, conv, it) if return_aux else e

    def decode_received(self, z, channel_probs):
        squeeze = np.ndim(z) == 1
        z = torch.atleast_2d(torch.as_tensor(z, device=self.device).to(torch.int32))
        lay = self.layout
        z_c = z[..., : lay.n]
        syn = sum(torch.roll(z_c, k, dims=-1) for k in lay.shifts)
        if lay.with_identity:
            syn = syn + z[..., lay.n :]
        e = self.decode_syndrome(syn % 2, channel_probs)
        out = (z + e) % 2
        return out[0] if squeeze else out
