"""CUDA q-ary min-sum kernels and their plain PyTorch versions.

Counterparts of ``sca_ldpc_tpu/ops/kernels/qary_pallas.py``:

- :func:`chain_exclusive_cuda` (``chain_exclusive_pallas``, K5): the check
  update, the exclusive min-plus prefix/suffix chain of every check, with an
  optional per-check ``extra`` operand; bitwise equal to
  :func:`~sca_ldpc_tpu_torch.ops.minplus.chain_exclusive`;
- :func:`qary_min_sum_fused_cuda` (``qary_min_sum_fused``, K6): the whole
  fixed-iteration decode in one launch, hard decisions out; bitwise equal
  totals, so equal decisions, to the plain ``_qary_min_sum``.

Both launch ``csrc/qary_min_sum.cu`` (built with ``nvcc`` at first use, see
``_build.py``) for CUDA tensors, and run the plain version for CPU tensors.
There is no fallback: a CUDA tensor that the kernel cannot take raises.  Each
wrapper counts its kernel launches in ``.launches``.

Unlike the TPU kernels, the batch need not be a multiple of a tile, and the
graph adjacency is passed as int32 index arrays (``CodeLayout``'s
``chk_var``, ``chk_sign``, ``chk_mask`` and ``var_flat``), not as one-hot
matrices.
"""

import ctypes
import functools

import torch

from ..minplus import chain_exclusive
from .circulant_cuda import _check, _cuda_stream

MAX_SMEM_BYTES = 232448  # dynamic shared memory a Hopper block may use
_F32 = (torch.float32,)
_I32 = (torch.int32,)


@functools.cache
def _lib():
    from ._build import load

    lib = load("qary_min_sum")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.qary_chain_exclusive.argtypes = [p, p, p, ll, i, i, i, i, i, p]
    lib.qary_chain_exclusive.restype = i
    lib.qary_min_sum_fused.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p, p]
    lib.qary_min_sum_fused.restype = i
    lib.qary_chain_smem_bytes.argtypes = [i, i, i, i, i]
    lib.qary_chain_smem_bytes.restype = ll
    lib.qary_fused_smem_bytes.argtypes = [i, i, i, i]
    lib.qary_fused_smem_bytes.restype = ll
    return lib


def chain_exclusive_plain(v2c, s_mid, s_out, extra=None):
    """Plain PyTorch version of :func:`chain_exclusive_cuda`, on any device."""
    return chain_exclusive(v2c, s_mid, extra=extra, s_out=s_out)


def chain_exclusive_cuda(v2c, s_mid, s_out, extra=None):
    """``minplus.chain_exclusive(v2c, s_mid, extra, s_out)``, as the JAX
    package's ``chain_exclusive_pallas(v2c, s_mid, s_out, extra)``.

    v2c: [Bt, R, DC, Q] float32, Q odd; extra: [Bt, R, We] float32, We odd,
    or None.  Returns [Bt, R, DC, 2*s_out+1] float32.
    """
    device = v2c.device
    if v2c.ndim != 4:
        raise ValueError(f"v2c must be [Bt, R, DC, Q], got shape {tuple(v2c.shape)}")
    bt, r, dc, q = v2c.shape
    _check(v2c, "v2c", (bt, r, dc, q), _F32, device)
    if q % 2 == 0 or dc < 1:
        raise ValueError(f"v2c must be [Bt, R, DC >= 1, Q odd], got shape {tuple(v2c.shape)}")
    s_mid, s_out = int(s_mid), int(s_out)
    if s_mid < 0 or s_out < 0:
        raise ValueError(f"s_mid {s_mid} and s_out {s_out} must be >= 0")
    we = 0
    if extra is not None:
        we = extra.shape[-1] if extra.ndim == 3 else 0
        _check(extra, "extra", (bt, r, we), _F32, device)
        if we % 2 == 0:
            raise ValueError(f"extra must be [{bt}, {r}, We odd], got shape {tuple(extra.shape)}")
    if device.type == "cpu":
        return chain_exclusive_plain(v2c, s_mid, s_out, extra)

    stream = _cuda_stream(device)
    smem = _lib().qary_chain_smem_bytes(dc, q, s_mid, s_out, we)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"chain_exclusive_cuda: DC={dc}, Q={q}, s_mid={s_mid}, s_out={s_out}, We={we} need "
            f"{smem} B of shared memory per block of 8 checks; the bound is {MAX_SMEM_BYTES} B"
        )
    with torch.cuda.device(device):
        out = torch.empty((bt, r, dc, 2 * s_out + 1), dtype=torch.float32, device=device)
        if bt * r:
            rc = _lib().qary_chain_exclusive(
                v2c.data_ptr(), extra.data_ptr() if extra is not None else None, out.data_ptr(),
                bt * r, dc, q, s_mid, s_out, we, stream,
            )
            if rc != 0:
                raise RuntimeError(f"qary_chain_exclusive launch failed: CUDA error {rc}")
            chain_exclusive_cuda.launches += 1
    return out


chain_exclusive_cuda.launches = 0


def qary_min_sum_fused_plain(channel, chk_var, chk_sign, chk_mask, var_flat, b_range, max_iter):
    """Plain PyTorch version of :func:`qary_min_sum_fused_cuda`, on any
    device: the fixed-iteration plain ``_qary_min_sum``."""
    from ..qary import _qary_min_sum

    return _qary_min_sum(chk_var, chk_sign, chk_mask, var_flat, channel, int(max_iter), int(b_range))


def qary_min_sum_fused_cuda(channel, chk_var, chk_sign, chk_mask, var_flat, b_range, max_iter):
    """Whole q-ary min-sum decode, as the JAX package's ``qary_min_sum_fused``.

    channel: [Bt, N, Q] float32 finite min-sum LLRs, Q = 2*b_range+1;
    chk_var, chk_sign, chk_mask: [R, DC] int32 and var_flat: [N, DV] int32,
    as in :class:`~sca_ldpc_tpu_torch.codes.layout.CodeLayout` (chk_mask 0/1).
    Returns hard decisions [Bt, N] int32 in [-b_range..b_range].
    """
    device = channel.device
    if channel.ndim != 3 or chk_var.ndim != 2 or var_flat.ndim != 2:
        raise ValueError("channel must be [Bt, N, Q], chk_var [R, DC] and var_flat [N, DV]")
    bt, n, q = channel.shape
    r, dc = chk_var.shape
    dv = var_flat.shape[1]
    _check(channel, "channel", (bt, n, q), _F32, device)
    for name, x, shape in (("chk_var", chk_var, (r, dc)), ("chk_sign", chk_sign, (r, dc)),
                           ("chk_mask", chk_mask, (r, dc)), ("var_flat", var_flat, (n, dv))):
        _check(x, name, shape, _I32, device)
    b_range, max_iter = int(b_range), int(max_iter)
    if q != 2 * b_range + 1:
        raise ValueError(f"channel has {q} symbol columns, expected 2*{b_range}+1")
    if max_iter < 0:
        raise ValueError("max_iter must be >= 0")
    if device.type == "cpu":
        return qary_min_sum_fused_plain(channel, chk_var, chk_sign, chk_mask, var_flat, b_range, max_iter)

    stream = _cuda_stream(device)
    smem = _lib().qary_fused_smem_bytes(n, r, dc, q)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"qary_min_sum_fused_cuda: N={n}, R={r}, DC={dc}, Q={q} need {smem} B of shared memory "
            f"per frame; the bound is {MAX_SMEM_BYTES} B (backend='chain' takes any size)"
        )
    real = chk_mask != 0
    bad = (
        (real & ((chk_var < 0) | (chk_var >= n))).any()
        | ((chk_sign != 1) & (chk_sign != -1)).any()
        | ((var_flat < 0) | (var_flat > r * dc)).any()
    )
    if bool(bad):
        raise ValueError("adjacency out of range: chk_var in [0, N) on real slots, chk_sign +-1, "
                         "var_flat in [0, R*DC]")
    with torch.cuda.device(device):
        hard = torch.empty((bt, n), dtype=torch.int32, device=device)
        if bt:
            rc = _lib().qary_min_sum_fused(
                channel.data_ptr(), chk_var.data_ptr(), chk_sign.data_ptr(), chk_mask.data_ptr(),
                var_flat.data_ptr(), bt, n, r, dc, dv, q, max_iter, hard.data_ptr(), stream,
            )
            if rc != 0:
                raise RuntimeError(f"qary_min_sum_fused launch failed: CUDA error {rc}")
            qary_min_sum_fused_cuda.launches += 1
    return hard


qary_min_sum_fused_cuda.launches = 0
