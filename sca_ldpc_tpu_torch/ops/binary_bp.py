"""Batched binary belief-propagation syndrome decoding over a general layout.

Counterpart of the JAX package's ``ops/binary_bp.py`` (the reference's CPU
``ldpc.bp_decoder``, decode.py:155-171, hqc.py:694-708), in plain PyTorch:

- the frame dimension is a leading batch axis;
- messages live check-major as ``[batch, R, DC]`` with a flat sentinel slot
  for padding, so irregular codes are masked lanes, not branches;
- flooding schedule with per-frame convergence latching: each frame's output
  is frozen at its first syndrome-satisfying iteration, and the loop exits
  once every frame has converged.

Both directions of message passing are gathers (``CodeLayout.chk_var`` into
the padded totals, ``var_flat`` into the flattened c2v plus one zero slot),
never a scatter-add, so the sums run in a fixed order.  The JAX package has
no Pallas kernel for this decoder; it is the HQC attack's default
(``decode_backend="general"``) decode.
"""

import numpy as np
import torch

from ..codes.layout import CodeLayout

_BIG = 60.0  # LLR clip: tanh saturates at float32 well below this
MIN_SUM_ALPHA = 0.75  # normalized min-sum scale (standard 0.7-0.8 range)


def _phi(x):
    """Gallager phi(x) = -log(tanh(x/2)), a self-inverse on (0, inf)."""
    x = torch.clamp(x, 1e-9, _BIG)
    return -torch.log(torch.tanh(0.5 * x))


def _check_update(v2c, sign_flip, mask, method):
    """Extrinsic check-to-variable messages.

    v2c: [..., R, DC] incoming LLRs; sign_flip: [..., R] +-1 from the syndrome
    bit; mask: [R, DC] valid-slot mask.  Returns c2v of the same shape.  The
    min-sum tie rule is the JAX package's: the first minimal slot (``argmin``)
    gets the second minimum, every slot equal to the minimum too."""
    sgn = torch.where(v2c >= 0, 1.0, -1.0)
    sgn = torch.where(mask, sgn, 1.0)
    mag = torch.where(mask, torch.abs(v2c), torch.inf)

    total_sign = torch.prod(sgn, dim=-1, keepdim=True) * sign_flip[..., None]
    ext_sign = total_sign * sgn  # divide == multiply for +-1

    if method == "product_sum":
        pm = torch.where(mask, _phi(mag), 0.0)
        total = torch.sum(pm, dim=-1, keepdim=True)
        ext_mag = _phi(torch.clamp(total - pm, min=1e-9))
    elif method == "min_sum":
        min1 = torch.amin(mag, dim=-1, keepdim=True)
        arg1 = torch.argmin(mag, dim=-1, keepdim=True)
        mag2 = mag.scatter(-1, arg1, torch.inf)
        min2 = torch.amin(mag2, dim=-1, keepdim=True)
        ext_mag = torch.where(mag == min1, min2, min1)
        # normalized min-sum: plain min-sum overestimates extrinsics badly on
        # high-degree checks (FER collapse at moderate noise)
        ext_mag = MIN_SUM_ALPHA * torch.clamp(ext_mag, max=_BIG)
    else:
        raise ValueError(f"unknown bp method: {method}")

    return torch.where(mask, ext_sign * ext_mag, 0.0)


def _pad1(x):
    """``x`` [B, M] with one zero column appended (the sentinel slot)."""
    return torch.cat([x, torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)], dim=-1)


def _bp_decode_syndrome(chk_var, chk_mask, var_flat, var_mask, prior_llr, syndrome, max_iter, method, dc):
    """The JAX package's ``_bp_decode_syndrome`` in plain PyTorch.

    chk_var [R, DC] (pad == N), chk_mask [R, DC] bool, var_flat [N, DV] into
    the flattened [R*DC + 1] c2v, var_mask [N, DV] bool, prior_llr [N] or
    [B, N] float32 (ln(p0/p1) of the error bit), syndrome [B, R] 0/1, all on
    one device.  Returns (e [B, N] int32, conv [B] bool, it 0-d int32: the
    number of iterations the batch ran)."""
    r = chk_var.shape[0]
    n = var_flat.shape[0]
    b = syndrome.shape[0]
    if method not in ("product_sum", "min_sum"):
        raise ValueError(f"unknown bp method: {method}")
    dev = syndrome.device
    chk_idx = chk_var.reshape(-1).long()
    var_idx = var_flat.reshape(-1).long()

    prior = torch.broadcast_to(torch.as_tensor(prior_llr, dtype=torch.float32, device=dev), (b, n))
    syndrome = syndrome.to(torch.int32)
    sign_flip = 1.0 - 2.0 * syndrome.to(torch.float32)  # [B, R]

    v2c = _pad1(prior).index_select(-1, chk_idx).reshape(b, r, dc)

    def hard_and_syndrome(total):  # total: [B, N] posterior LLR
        e_hat = (total < 0).to(torch.int32)
        bits = _pad1(e_hat).index_select(-1, chk_idx).reshape(b, r, dc)
        syn = torch.sum(torch.where(chk_mask, bits, 0), dim=-1) % 2
        return e_hat, torch.all(syn == syndrome, dim=-1)

    # iteration 0 output (in case max_iter rounds never converge)
    e_out = (prior < 0).to(torch.int32)
    conv = torch.zeros((b,), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iter and not bool(torch.all(conv)):
        c2v = _check_update(v2c, sign_flip, chk_mask, method)
        c2v_var = _pad1(c2v.reshape(b, -1)).index_select(-1, var_idx).reshape(b, n, -1)
        c2v_var = torch.where(var_mask, c2v_var, 0.0)
        total = prior + torch.sum(c2v_var, dim=-1)
        # check-side extrinsic: v2c[r, j] = total[chk_var[r, j]] - c2v[r, j],
        # a gather instead of a scatter
        tot_chk = _pad1(total).index_select(-1, chk_idx).reshape(b, r, dc)
        v2c = torch.clamp(tot_chk - c2v, -_BIG, _BIG)

        e_hat, ok = hard_and_syndrome(total)
        e_out = torch.where(conv[:, None], e_out, e_hat)  # latch the first converged estimate
        conv = conv | ok
        it += 1
    return e_out, conv, torch.tensor(it, dtype=torch.int32)


def _bp_decode_instances(chk_var, chk_mask, var_flat, var_mask, prior_llr, syndrome, max_iter, method):
    """:func:`_bp_decode_syndrome` over an instance axis: instance i decodes
    its one frame ``syndrome[i]`` on its own layout, all in one loop (the
    JAX package's ``jax.vmap`` of ``_bp_decode_syndrome`` in the batched HQC
    attack, ``models/hqc/batched.py:_batched_decode_received``).

    chk_var [I, R, DC] (pad == N), chk_mask [I, R, DC] bool, var_flat
    [I, N, DV] into each instance's flattened [R*DC + 1] c2v, var_mask
    [I, N, DV] bool, prior_llr [I, N] float32, syndrome [I, R] 0/1, every
    instance padded to the round's shared (R, N, DC, DV).  Each instance's
    first converged estimate is latched, so its decisions are those of its
    own decode.  Returns (e [I, N] int32, conv [I] bool, it 0-d int32: the
    iterations the round ran)."""
    i_n, r, dc = chk_var.shape
    n = var_flat.shape[1]
    if method not in ("product_sum", "min_sum"):
        raise ValueError(f"unknown bp method: {method}")
    dev = syndrome.device
    chk_idx = chk_var.reshape(i_n, -1).long()
    var_idx = var_flat.reshape(i_n, -1).long()

    def take(x, idx):  # x [I, M] with the sentinel slot appended, gathered per instance
        return torch.gather(_pad1(x), 1, idx)

    prior = torch.as_tensor(prior_llr, dtype=torch.float32, device=dev)
    syndrome = syndrome.to(torch.int32)
    sign_flip = 1.0 - 2.0 * syndrome.to(torch.float32)  # [I, R]
    v2c = take(prior, chk_idx).reshape(i_n, r, dc)

    e_out = (prior < 0).to(torch.int32)
    conv = torch.zeros((i_n,), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iter and not bool(torch.all(conv)):
        c2v = _check_update(v2c, sign_flip, chk_mask, method)
        c2v_var = take(c2v.reshape(i_n, -1), var_idx).reshape(i_n, n, -1)
        c2v_var = torch.where(var_mask, c2v_var, 0.0)
        total = prior + torch.sum(c2v_var, dim=-1)
        v2c = torch.clamp(take(total, chk_idx).reshape(i_n, r, dc) - c2v, -_BIG, _BIG)

        e_hat = (total < 0).to(torch.int32)
        bits = take(e_hat, chk_idx).reshape(i_n, r, dc)
        ok = torch.all(torch.sum(torch.where(chk_mask, bits, 0), dim=-1) % 2 == syndrome, dim=-1)
        e_out = torch.where(conv[:, None], e_out, e_hat)  # latch each instance's first converged estimate
        conv = conv | ok
        it += 1
    return e_out, conv, torch.tensor(it, dtype=torch.int32)


def decode_received_instances(layouts, channels, msgs, max_iter=100, method="product_sum", device="cuda"):
    """Received-vector decode of one word an instance, each on its own
    :class:`CodeLayout` (all of one shape (R, N, DC, DV)) with its own
    per-position error probabilities: the corrected words ``(z + e_hat) % 2``
    as a numpy [I, N] array, read back in one copy.  The batched HQC attack's
    ``"general"`` and ``"padded"`` rounds (the JAX package's
    ``_batched_decode_received``); plain PyTorch on ``device``."""
    device = torch.device(device)

    def stack(arrays, dtype=None):
        return torch.as_tensor(np.stack(arrays), dtype=dtype, device=device)

    chk_var = stack([lay.chk_var for lay in layouts])
    chk_mask = stack([lay.chk_mask for lay in layouts])
    var_flat = stack([lay.var_flat for lay in layouts])
    var_mask = stack([lay.var_mask for lay in layouts])
    prior = stack([np.log((1 - np.asarray(c)) / np.asarray(c)) for c in channels], torch.float32)
    z = stack([np.asarray(m) for m in msgs], torch.int32)
    i_n, r, dc = chk_var.shape
    bits = torch.gather(_pad1(z), 1, chk_var.reshape(i_n, -1).long()).reshape(i_n, r, dc)
    syn = torch.sum(torch.where(chk_mask, bits, 0), dim=-1) % 2
    e, _conv, _it = _bp_decode_instances(chk_var, chk_mask, var_flat, var_mask, prior, syn, max_iter, method)
    return ((z + e) % 2).cpu().numpy()


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


class BinaryBPDecoder:
    """Batched syndrome BP decoder over a :class:`CodeLayout`.

    ``channel_probs`` follows the reference's convention: per-position
    probability that the error bit is 1 (ldpc bp_decoder channel_probs /
    error_rate, decode.py:155-161).  Inputs (numpy arrays or tensors) are
    placed on ``device``; the decode is plain PyTorch on any device.
    """

    def __init__(self, H_or_layout, max_iter=50, method="product_sum", channel_probs=None, error_rate=None,
                 device="cuda"):
        if isinstance(H_or_layout, CodeLayout):
            self.layout = H_or_layout
        else:
            self.layout = CodeLayout.from_h(np.asarray(H_or_layout))
        lay = self.layout
        self.max_iter = int(max_iter)
        self.method = method
        self.device = torch.device(device)
        self._chk_var = torch.as_tensor(lay.chk_var, device=self.device)
        self._chk_mask = torch.as_tensor(lay.chk_mask, device=self.device)
        self._var_flat = torch.as_tensor(lay.var_flat, device=self.device)
        self._var_mask = torch.as_tensor(lay.var_mask, device=self.device)
        self.default_prior = None
        if channel_probs is not None:
            self.default_prior = self._to_llr(np.asarray(_host(channel_probs), dtype=np.float32))
        elif error_rate is not None:
            self.default_prior = self._to_llr(np.full(lay.n, float(error_rate), dtype=np.float32))

    def _to_llr(self, p_error):
        p = np.clip(np.asarray(_host(p_error), np.float64), 1e-30, 1 - 1e-12)
        return torch.as_tensor(np.log((1 - p) / p), dtype=torch.float32, device=self.device)

    def decode_syndrome(self, syndrome, channel_probs=None, return_aux=False):
        """Decode [B, R] (or [R]) syndromes to [B, N] error estimates."""
        squeeze = np.ndim(syndrome) == 1
        syn = torch.atleast_2d(torch.as_tensor(syndrome, device=self.device).to(torch.int32))
        prior = self._to_llr(channel_probs) if channel_probs is not None else self.default_prior
        if prior is None:
            raise ValueError("channel probabilities required (ctor or call)")
        e, conv, it = _bp_decode_syndrome(
            self._chk_var, self._chk_mask, self._var_flat, self._var_mask, prior, syn,
            self.max_iter, self.method, self.layout.dc,
        )
        if squeeze:
            e, conv = e[0], conv[0]
        return (e, conv, it) if return_aux else e

    def decode_received(self, z, channel_probs=None):
        """ldpc-package "received vector" mode: returns the corrected word
        ``(z + e_hat) % 2`` (used by the HQC attack decode, hqc.py:703-708)."""
        squeeze = np.ndim(z) == 1
        z = torch.atleast_2d(torch.as_tensor(z, device=self.device).to(torch.int32))
        lay = self.layout
        bits = _pad1(z).index_select(-1, self._chk_var.reshape(-1).long()).reshape(z.shape[0], lay.r, lay.dc)
        syn = torch.sum(torch.where(self._chk_mask, bits, 0), dim=-1) % 2
        e = self.decode_syndrome(syn, channel_probs)
        out = (z + e) % 2
        return out[0] if squeeze else out
