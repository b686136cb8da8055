"""Batched q-ary min-sum LDPC decoding over symbol alphabet [-B..B].

Counterpart of the reference's Rust ``Decoder`` (decoder.rs:417-724) and of
the JAX package's ``ops/qary.py``: min-sum LLRs ``ln(max/p)``, the extrinsic
min over zero-sum configurations as exact min-plus convolutions
(:mod:`~sca_ldpc_tpu_torch.ops.minplus`), arg-min normalization, arg-min hard
decision, GF "multiplication" by H entries in {-1,+1} as alphabet reversal,
and a leading frame batch axis.

``backend`` selects how an iteration runs (JAX package name in brackets):

- ``"plain"`` (``"xla"``): :func:`_qary_min_sum` in plain PyTorch;
- ``"chain"`` (``"pallas"``): the same loop with the check update in the
  CUDA kernel ``chain_exclusive_cuda`` (K5);
- ``"fused"`` (``"fused"``): the whole decode in the CUDA kernel
  ``qary_min_sum_fused_cuda`` (K6); fixed iterations only.

On CPU tensors the kernel wrappers run their plain versions, so every backend
decodes on the CPU too.
"""

import numpy as np
import torch

from ..channels.llr import probs_to_llr
from ..codes.layout import CodeLayout
from . import minplus
from .minplus import BIG

BACKENDS = ("plain", "chain", "fused")


def _signed(msg, sign):
    """Apply GF multiplication by h in {-1,+1}: reverse the symbol axis where
    h < 0 (decoder.rs:164-172)."""
    return torch.where(sign[..., None] < 0, msg.flip(-1), msg)


def default_backend(device, early_exit, fits):
    """The default backend of the q-ary decoders, chosen once at
    construction: ``"plain"`` on the CPU; on a CUDA device ``"chain"`` with
    ``early_exit``, else ``"fused"`` when ``fits()`` (one frame fits the
    fused kernel's shared memory) and ``"chain"``, which takes any size,
    when it does not."""
    if device.type != "cuda":
        return "plain"
    if early_exit:
        return "chain"
    return "fused" if fits() else "chain"


def _var_sign_mask(chk_sign, var_flat):
    """The variable-side sign and mask of ``CodeLayout`` (``var_sign``,
    ``var_mask``) from ``chk_sign`` and ``var_flat``: a slot is real when it
    points below the sentinel R*DC, and its sign is its edge's."""
    pad = chk_sign.numel()
    var_mask = var_flat < pad
    var_sign = torch.where(var_mask, chk_sign.reshape(-1)[var_flat.clamp(max=pad - 1).long()], 1)
    return var_sign, var_mask


def _qary_min_sum(
    chk_var,  # [R, DC] int, pad == n
    chk_sign,  # [R, DC] int, +-1
    chk_mask,  # [R, DC] 0/1 or bool
    var_flat,  # [N, DV] int into [R*DC+1]
    channel,  # [Bt, N, Q] min-sum LLRs (finite; inf pre-clipped)
    max_iter: int,
    b_range: int,
    backend: str = "plain",  # check update: "plain" | "chain"
    early_exit: bool = False,  # stop when every frame satisfies all checks
):
    """Plain decode loop, a counterpart of the JAX package's ``_qary_min_sum``
    (which takes ``var_sign``/``var_mask`` too; here they are derived); the
    plain version of ``qary_min_sum_fused_cuda``."""
    bt, n, q = channel.shape
    r, dc = chk_var.shape
    dv = var_flat.shape[1]
    dev = channel.device
    s_mid = (dc - 1) * b_range  # support bound of any (DC-1)-operand conv
    idx_c = chk_var.reshape(-1).long()
    idx_v = var_flat.reshape(-1).long()
    chk_mask = chk_mask.bool()
    mask_c = chk_mask[..., None]
    var_sign, var_mask = _var_sign_mask(chk_sign, var_flat)

    # Pad slots get the min-plus identity (delta at symbol 0), exactly the
    # reference's treatment of missing/irregular slots.
    delta = minplus.identity(q, device=dev)
    delta_row = torch.broadcast_to(delta, (bt, 1, q))

    def gather_chk(x):  # [Bt, N, Q] -> [Bt, R, DC, Q], pads read the delta row
        return torch.cat([x, delta_row], dim=1).index_select(1, idx_c).reshape(bt, r, dc, q)

    v2c = torch.where(mask_c, _signed(gather_chk(channel), chk_sign), delta)

    def body(v2c):
        # check update: exact min over zero-sum configs via min-plus convs,
        # on the consumed +-B output window.
        if backend == "chain":
            from .kernels.qary_cuda import chain_exclusive_cuda

            ext = chain_exclusive_cuda(v2c, s_mid, b_range)
        else:
            ext = minplus.chain_exclusive(v2c, s_mid, s_out=b_range)
        c2v = torch.clamp_max(ext.flip(-1), BIG)  # beta_j[d] = ext_j[-d]

        # variable update: total = channel + ((u_0 + u_1) + ...), the JAX
        # package's summation order, pads adding 0.
        c2v_flat = torch.cat([c2v.reshape(bt, r * dc, q), torch.zeros((bt, 1, q), device=dev)], dim=1)
        c2v_var = c2v_flat.index_select(1, idx_v).reshape(bt, n, dv, q)
        u = torch.where(var_mask[..., None], _signed(c2v_var, var_sign), 0.0)
        acc = u[:, :, 0]
        for t in range(1, dv):
            acc = acc + u[:, :, t]
        total = channel + acc

        # Extrinsic computed check-side: signed(total - c2v_u) ==
        # signed(total) - c2v (reversal is a permutation).
        prim = _signed(gather_chk(total), chk_sign) - c2v
        prim = prim - torch.amin(prim, dim=-1, keepdim=True)
        prim = torch.clamp_max(prim, BIG)
        return torch.where(mask_c, prim, delta).contiguous(), total

    def hard_of(total):
        return torch.argmin(total, dim=-1).to(torch.int32) - b_range

    if not early_exit:
        # The reference takes its hard decision from the totals of the final
        # iteration's variable update (decoder.rs:654-662).
        total = torch.zeros((bt, n, q), device=dev)
        for _ in range(max_iter):
            v2c, total = body(v2c)
        return hard_of(total)

    # Early exit (beyond the reference): each frame's hard decision latches at
    # the first iteration whose decision satisfies every check (signed symbol
    # sum 0 over the integers); the batch stops when all frames have latched
    # or max_iter is reached.
    sign_c = chk_sign.to(torch.int32)

    def satisfied(hard):
        hard_pad = torch.cat([hard, torch.zeros((bt, 1), dtype=torch.int32, device=dev)], dim=1)
        sym = hard_pad.index_select(1, idx_c).reshape(bt, r, dc)
        sym = torch.where(chk_mask, sym * sign_c, 0)
        return torch.all(sym.sum(dim=-1) == 0, dim=-1)

    hard_out = torch.zeros((bt, n), dtype=torch.int32, device=dev)
    conv = torch.zeros((bt,), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iter and not bool(torch.all(conv)):
        v2c, total = body(v2c)
        hard = hard_of(total)
        hard_out = torch.where(conv[:, None], hard_out, hard)
        conv = conv | satisfied(hard)
        it += 1
    return hard_out


class QaryDecoder:
    """Q-ary min-sum decoder over a parity-check matrix with entries {-1,0,+1}.

    ``QaryDecoder(H, B, iterations)`` as the reference's registered decoders
    (pydecoder.rs:24-45).  ``backend`` is one of :data:`BACKENDS` (module
    docstring); by default (:func:`default_backend`) ``"fused"`` on a CUDA
    device when a frame fits the kernel's shared memory, ``"chain"`` there
    otherwise or with ``early_exit``, and ``"plain"`` on the CPU.  Inputs
    (numpy arrays or tensors) are placed on ``device``; decisions come back
    there as int32.
    """

    def __init__(self, H, b_range: int, max_iter: int, dc=None, dv=None, backend=None,
                 early_exit=False, device="cuda"):
        self.layout = CodeLayout.from_h(np.asarray(H), dc=dc, dv=dv)
        self.b = int(b_range)
        self.q = 2 * self.b + 1
        self.max_iter = int(max_iter)
        self.early_exit = bool(early_exit)
        self.device = torch.device(device)
        lay = self.layout
        if backend is None:
            def fits():
                from .kernels.circulant_cuda import smem_limits
                from .kernels.qary_cuda import fused_launch

                try:
                    fused_launch(lay.n, lay.r, lay.dc, self.q, *smem_limits(self.device))
                except ValueError:
                    return False
                return True

            backend = default_backend(self.device, self.early_exit, fits)
        if backend not in BACKENDS:
            raise ValueError(f"unknown q-ary backend {backend!r}; expected one of {BACKENDS}")
        if backend == "fused" and self.early_exit:
            raise ValueError("backend='fused' runs fixed iterations in-kernel")
        self.backend = backend
        adjacency = tuple(np.asarray(a, np.int32) for a in (lay.chk_var, lay.chk_sign, lay.chk_mask, lay.var_flat))
        if backend == "fused":
            # checked once here, so that a decode makes no host sync for it
            from .kernels.qary_cuda import fused_adjacency_bad

            if fused_adjacency_bad(lay.n, *map(torch.from_numpy, adjacency)):
                raise ValueError("H's entries must be -1, 0 or +1 for backend='fused'")
        # the adjacency as int32 device arrays, as every backend takes it
        self._args = tuple(torch.as_tensor(a, device=self.device) for a in adjacency)

    def _decode_llr(self, llr):
        if self.backend == "fused":
            from .kernels.qary_cuda import qary_min_sum_fused_cuda

            return qary_min_sum_fused_cuda(llr, *self._args, self.b, self.max_iter, check_adjacency=False)
        return _qary_min_sum(*self._args, llr, self.max_iter, self.b,
                             backend=self.backend, early_exit=self.early_exit)

    def _decode(self, llr):
        squeeze = llr.ndim == 2
        if squeeze:
            llr = llr[None]
        if llr.shape[-1] != self.q:
            raise ValueError(f"expected {self.q} symbol columns, got {llr.shape[-1]}")
        hard = self._decode_llr(minplus.clip_inf(llr).contiguous())
        return hard[0] if squeeze else hard

    def min_sum(self, channel_probs):
        """Decode ``[N, Q]`` (or batched ``[Bt, N, Q]``) symbol probability
        tables to hard decisions in ``[-B..B]``; probabilities become min-sum
        LLRs ``ln(max/p)`` (pydecoder.rs:53-65)."""
        probs = torch.as_tensor(channel_probs, dtype=torch.float32, device=self.device)
        return self._decode(probs_to_llr(probs))

    def min_sum_llr(self, channel_llr):
        """Decode precomputed min-sum LLRs (inf allowed; clipped internally)."""
        return self._decode(torch.as_tensor(channel_llr, dtype=torch.float32, device=self.device))
