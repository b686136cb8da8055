"""Two-alphabet q-ary decoder for ``H = [H'|I]`` codes (the Kyber attack).

Counterpart of the reference's Rust ``DecoderSpecial``
(decoder_special.rs:294-675) and of the JAX package's
``ops/qary_special.py``: the first ``N-R`` columns are secret coefficients in
``[-B..B]`` ("B-variables"); the last ``R`` columns are measured check sums in
``[-BSUM..BSUM]`` with ``BSUM = SW*B``.  Each check connects up to ``SW``
B-variables and exactly one sum variable.  The check update is the min-plus
chain of :mod:`~sca_ldpc_tpu_torch.ops.minplus` with the sum variable's
signed channel as the extra operand (a degree-1 variable's v2c message is its
channel, constant across iterations); irregular rows are identity-delta
padding; the sum totals come from the full convolution of a check's SW
B-messages.

``backend`` selects how an iteration runs (JAX package name in brackets):

- ``"plain"`` (``"xla"``): :func:`_special_min_sum` in plain PyTorch;
- ``"chain"`` (``"pallas"``): the same loop with the check update in the
  CUDA kernel ``chain_exclusive_cuda`` (K5), the sum variable as its extra
  operand;
- ``"fused"`` (``"fused"``): the whole decode in the CUDA kernel
  ``qary_special_min_sum_fused_cuda`` (K7); fixed iterations only.

On CPU tensors the kernel wrappers run their plain versions, so every backend
decodes on the CPU too.
"""

import numpy as np
import torch

from ..channels.llr import probs_to_llr
from ..utils import spans
from . import minplus
from .minplus import BIG
from .qary import BACKENDS, _signed, default_backend


def _special_min_sum(
    bvar_idx,  # [R, SW] int, pad == n_b
    bvar_sign,  # [R, SW] int, +-1
    bvar_mask,  # [R, SW] 0/1 or bool
    var_flat,  # [N_b, DV] int into [R*SW+1]
    var_sign,  # [N_b, DV] int, +-1
    var_mask,  # [N_b, DV] 0/1 or bool
    sum_sign,  # [R] int: sign of each row's identity entry
    channel,  # [Bt, N_b, 2B+1] min-sum LLRs (finite)
    channel_sum_row,  # [Bt, R, 2BSUM+1] min-sum LLRs, row-ordered (finite)
    max_iter: int,
    b: int,
    bsum: int,
    backend: str = "plain",  # check update: "plain" | "chain"
    early_exit: bool = False,  # stop when every frame satisfies all checks
):
    """Plain decode loop, a counterpart of the JAX package's
    ``_special_min_sum``; the plain version of
    ``qary_special_min_sum_fused_cuda``.  Returns ``(hard_b [Bt, N_b],
    hard_sum_row [Bt, R])`` int32 (sum decisions in row order)."""
    bt, n_b, qb = channel.shape
    r, sw = bvar_idx.shape
    dv = var_flat.shape[1]
    qs = 2 * bsum + 1
    dev = channel.device
    s_mid = (2 * sw - 1) * b  # support of (SW-1) B-vars conv'd with the sum var
    idx_c = bvar_idx.reshape(-1).long()
    idx_v = var_flat.reshape(-1).long()
    bvar_mask = bvar_mask.bool()
    mask_c = bvar_mask[..., None]
    var_mask = var_mask.bool()

    delta = minplus.identity(qb, device=dev)
    delta_row = torch.broadcast_to(delta, (bt, 1, qb))

    def gather_chk(x):  # [Bt, N_b, QB] -> [Bt, R, SW, QB], pads read the delta row
        return torch.cat([x, delta_row], dim=1).index_select(1, idx_c).reshape(bt, r, sw, qb)

    v2c = torch.where(mask_c, _signed(gather_chk(channel), bvar_sign), delta)
    # Degree-1 sum variables: v2c == signed channel, forever.
    v2c_sum = _signed(channel_sum_row, sum_sign).contiguous()
    ident_sum = minplus.identity(qs, device=dev)

    def body(v2c):
        # check update: the chain over the SW B-messages and the sum message
        if backend == "chain":
            from .kernels.qary_cuda import chain_exclusive_cuda

            ext = chain_exclusive_cuda(v2c, s_mid, b, v2c_sum)
        else:
            ext = minplus.chain_exclusive(v2c, s_mid, extra=v2c_sum, s_out=b)
        c2v = torch.clamp_max(ext.flip(-1), BIG)  # [Bt, R, SW, QB]

        # the full conv of all SW B-messages has support exactly +-BSUM
        full = ident_sum
        for j in range(sw):
            full = minplus.conv(v2c[..., j, :], full, bsum)
        c2v_sum = torch.clamp_max(full.flip(-1), BIG)  # [Bt, R, QS]

        # B-variable update: total = channel + ((u_0 + u_1) + ...), the JAX
        # package's summation order, pads adding 0.
        c2v_flat = torch.cat([c2v.reshape(bt, r * sw, qb), torch.zeros((bt, 1, qb), device=dev)], dim=1)
        c2v_var = c2v_flat.index_select(1, idx_v).reshape(bt, n_b, dv, qb)
        u = torch.where(var_mask[..., None], _signed(c2v_var, var_sign), 0.0)
        acc = u[:, :, 0]
        for t in range(1, dv):
            acc = acc + u[:, :, t]
        total_b = channel + acc

        # extrinsic computed check-side: signed(total) - c2v
        prim = _signed(gather_chk(total_b), bvar_sign) - c2v
        prim = prim - torch.amin(prim, dim=-1, keepdim=True)
        prim = torch.clamp_max(prim, BIG)
        v2c_new = torch.where(mask_c, prim, delta).contiguous()

        # sum-variable totals (no outgoing update needed)
        total_sum = channel_sum_row + _signed(c2v_sum, sum_sign)
        return v2c_new, total_b, total_sum

    def decide(total_b, total_sum):
        hard_b = torch.argmin(total_b, dim=-1).to(torch.int32) - b
        hard_sum_row = torch.argmin(total_sum, dim=-1).to(torch.int32) - bsum
        return hard_b, hard_sum_row

    if not early_exit:
        total_b = torch.zeros((bt, n_b, qb), device=dev)
        total_sum = torch.zeros((bt, r, qs), device=dev)
        for _ in range(max_iter):
            v2c, total_b, total_sum = body(v2c)
        return decide(total_b, total_sum)

    # Early exit (beyond the reference): each frame's decisions latch at the
    # first iteration where every row satisfies sum(signed B-symbols) +
    # signed sum-symbol == 0 over the integers (the counterweight rule,
    # decoder_special.rs:533-537); the batch stops when all frames have
    # latched or max_iter is reached.
    sign_c = bvar_sign.to(torch.int32)
    sign_s = sum_sign.to(torch.int32)

    def satisfied(hard_b, hard_sum_row):
        hard_pad = torch.cat([hard_b, torch.zeros((bt, 1), dtype=torch.int32, device=dev)], dim=1)
        sym = hard_pad.index_select(1, idx_c).reshape(bt, r, sw)
        sym = torch.where(bvar_mask, sym * sign_c, 0)
        return torch.all(sym.sum(dim=-1) + sign_s * hard_sum_row == 0, dim=-1)

    out_b = torch.zeros((bt, n_b), dtype=torch.int32, device=dev)
    out_s = torch.zeros((bt, r), dtype=torch.int32, device=dev)
    conv = torch.zeros((bt,), dtype=torch.bool, device=dev)
    it = 0
    while it < max_iter and not bool(torch.all(conv)):
        v2c, total_b, total_sum = body(v2c)
        hard_b, hard_sum_row = decide(total_b, total_sum)
        out_b = torch.where(conv[:, None], out_b, hard_b)
        out_s = torch.where(conv[:, None], out_s, hard_sum_row)
        conv = conv | satisfied(hard_b, hard_sum_row)
        it += 1
    return out_b, out_s


def special_index_arrays(H, sw=None):
    """The adjacency of ``[H'|I]`` as the JAX package's ``QarySpecialDecoder``
    builds it: ``(bvar_idx, bvar_sign, bvar_mask, var_flat, var_sign,
    var_mask, sum_sign, row_of_sum)`` numpy arrays (the JAX dtypes) and
    ``sum_var`` (the sum variable each row serves)."""
    H = np.asarray(H)
    r, n = H.shape
    n_b = n - r
    rows, cols = np.nonzero(H)
    is_sum = cols >= n_b
    deg_b = np.bincount(rows[~is_sum], minlength=r)
    sw = int(sw if sw is not None else max(1, deg_b.max()))
    if np.bincount(rows[is_sum], minlength=r).max() != 1 or is_sum.sum() != r:
        raise ValueError("each row must contain exactly one sum-variable entry")
    if np.bincount(cols[is_sum] - n_b, minlength=r).max() != 1:
        raise ValueError("each sum variable must appear in exactly one row")

    bvar_idx = np.full((r, sw), n_b, np.int32)
    bvar_sign = np.ones((r, sw), np.int8)
    bvar_mask = np.zeros((r, sw), bool)
    sum_sign = np.ones(r, np.int8)
    sum_var = np.zeros(r, np.int32)
    dv = int(np.bincount(cols[~is_sum], minlength=n_b)[:n_b].max()) if (~is_sum).any() else 1
    var_flat = np.full((n_b, dv), r * sw, np.int32)
    var_sign = np.ones((n_b, dv), np.int8)
    var_mask = np.zeros((n_b, dv), bool)

    slot_c = np.zeros(r, np.int32)
    slot_v = np.zeros(n_b, np.int32)
    for i, j in zip(rows, cols):
        s = np.int8(H[i, j])
        if j >= n_b:
            sum_sign[i] = s
            sum_var[i] = j - n_b
        else:
            sc = slot_c[i]
            if sc >= sw:
                raise ValueError(f"row {i} has more than SW={sw} B-variables")
            bvar_idx[i, sc] = j
            bvar_sign[i, sc] = s
            bvar_mask[i, sc] = True
            sv = slot_v[j]
            var_flat[j, sv] = i * sw + sc
            var_sign[j, sv] = s
            var_mask[j, sv] = True
            slot_c[i] = sc + 1
            slot_v[j] = sv + 1

    row_of_sum = np.zeros(r, np.int32)
    row_of_sum[sum_var] = np.arange(r, dtype=np.int32)
    return (bvar_idx, bvar_sign, bvar_mask, var_flat, var_sign, var_mask, sum_sign, row_of_sum), sum_var


class QarySpecialDecoder:
    """Decoder for ``[H'|I]`` with per-class alphabets B (secrets) and BSUM
    (measured sums).  Construction mirrors pydecoder.rs:84-117:
    ``QarySpecialDecoder(H, B, BSUM, iterations)``.

    ``backend`` is one of :data:`~sca_ldpc_tpu_torch.ops.qary.BACKENDS`
    (module docstring); by default ``"fused"`` on a CUDA device when a frame
    fits the kernel's shared memory and ``"chain"`` otherwise or with
    ``early_exit``, and ``"plain"`` on the CPU.  Inputs (numpy arrays or
    tensors) are placed on ``device``; decisions come back there as int32,
    B-variables then sum variables in column order.
    """

    def __init__(self, H, b: int, bsum: int, max_iter: int, sw=None, backend=None,
                 early_exit=False, device="cuda"):
        H = np.asarray(H)
        r, n = H.shape
        if bsum % b != 0:
            raise ValueError(f"BSUM ({bsum}) must be a multiple of B ({b})")
        self.b, self.bsum, self.max_iter = int(b), int(bsum), int(max_iter)
        self.early_exit = bool(early_exit)
        self.device = torch.device(device)
        self.n, self.r, self.n_b = n, r, n - r
        arrays, sum_var = special_index_arrays(H, sw)
        self.sw = arrays[0].shape[1]
        if self.bsum != self.sw * self.b:
            raise ValueError(f"BSUM ({bsum}) must equal SW ({self.sw}) * B ({b})")
        if backend is None:
            def fits():
                from .kernels.circulant_cuda import smem_limits
                from .kernels.qary_cuda import special_fused_launch

                try:
                    special_fused_launch(self.n_b, r, self.sw, self.b, self.bsum, *smem_limits(self.device))
                except ValueError:
                    return False
                return True

            backend = default_backend(self.device, self.early_exit, fits)
        if backend not in BACKENDS:
            raise ValueError(f"unknown q-ary backend {backend!r}; expected one of {BACKENDS}")
        if backend == "fused" and self.early_exit:
            raise ValueError("backend='fused' runs fixed iterations in-kernel")
        self.backend = backend
        # the JAX decoder's _args, as int32 device tensors
        self._args = tuple(torch.as_tensor(a.astype(np.int32), device=self.device) for a in arrays)
        self._sum_var = torch.as_tensor(sum_var, dtype=torch.int64, device=self.device)

    def _decode_llr(self, llr_b, llr_s_row):
        """The decode of clipped channels (sum variables in row order); the
        span ``kyber.decode`` (``utils/spans.py``) around it, K7's wrapper
        and its adjacency check included."""
        bvar_idx, bvar_sign, bvar_mask, var_flat, var_sign, var_mask, sum_sign, row_of_sum = self._args
        with spans.span("kyber.decode"):
            if self.backend == "fused":
                from .kernels.qary_cuda import qary_special_min_sum_fused_cuda

                vsum = _signed(llr_s_row, sum_sign).contiguous()
                hard_b, hard_s_row = qary_special_min_sum_fused_cuda(
                    llr_b, llr_s_row, vsum, bvar_idx, bvar_sign, bvar_mask, var_flat, sum_sign,
                    self.b, self.bsum, self.max_iter,
                )
            else:
                hard_b, hard_s_row = _special_min_sum(
                    *self._args[:7], llr_b, llr_s_row, self.max_iter, self.b, self.bsum,
                    backend=self.backend, early_exit=self.early_exit,
                )
            return torch.cat([hard_b, hard_s_row.index_select(1, row_of_sum.long())], dim=1)

    def min_sum_llr(self, channel_llr, channel_llr_sum):
        """Decode min-sum LLRs (inf allowed; clipped internally):
        ``channel_llr`` [N-R, 2B+1] and ``channel_llr_sum`` [R, 2BSUM+1]
        (sum variables in column order), or both with a leading batch axis."""
        llr_b = torch.as_tensor(channel_llr, dtype=torch.float32, device=self.device)
        llr_s = torch.as_tensor(channel_llr_sum, dtype=torch.float32, device=self.device)
        squeeze = llr_b.ndim == 2
        if squeeze:
            llr_b, llr_s = llr_b[None], llr_s[None]
        want_b = (llr_b.shape[0], self.n_b, 2 * self.b + 1)
        want_s = (llr_b.shape[0], self.r, 2 * self.bsum + 1)
        if tuple(llr_b.shape) != want_b or tuple(llr_s.shape) != want_s:
            raise ValueError(f"expected channels of shapes {want_b[1:]} and {want_s[1:]} (optionally "
                             f"batched), got {tuple(llr_b.shape)} and {tuple(llr_s.shape)}")
        llr_b = minplus.clip_inf(llr_b).contiguous()
        # order the sum-variable channels by serving row
        llr_s_row = minplus.clip_inf(llr_s).index_select(1, self._sum_var).contiguous()
        hard = self._decode_llr(llr_b, llr_s_row)
        return hard[0] if squeeze else hard

    def min_sum(self, channel_probs, channel_probs_sum):
        """Decode symbol probability tables ``[N-R, 2B+1]`` and
        ``[R, 2BSUM+1]`` (or batched) to hard decisions; probabilities
        become min-sum LLRs ``ln(max/p)`` (pydecoder.rs:125-145) where they
        lie, so numpy inputs give the same LLR bits, and so the same
        decisions, on every device."""
        def f32(p):  # numpy views may have negative strides (reversed sum tables)
            return p.float() if isinstance(p, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(p, np.float32))

        return self.min_sum_llr(probs_to_llr(f32(channel_probs)), probs_to_llr(f32(channel_probs_sum)))
