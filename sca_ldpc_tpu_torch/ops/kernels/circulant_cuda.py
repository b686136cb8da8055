"""CUDA circulant-BP kernels and their plain PyTorch versions.

Counterparts of ``sca_ldpc_tpu/ops/kernels/circulant_pallas.py``:

- :func:`circulant_bp_cuda` (``circulant_bp_pallas``): priors and syndrome in,
  decisions out;
- :func:`circulant_fer_cuda` (``circulant_fer_pallas``): true error bits in,
  success and convergence flags out, with the syndrome, decode and comparison
  on the card.

Both launch ``csrc/circulant_bp.cu`` (built with ``nvcc`` at first use, see
``_build.py``) for CUDA tensors, and run the plain version beside them for
CPU tensors.  There is no fallback: a CUDA tensor that the kernel cannot take
raises.  Each wrapper counts its kernel launches in ``.launches``.

Unlike the TPU kernels, the batch need not be a multiple of a tile, messages
are f32 (the TPU kernels store bf16), and the shifts are runtime data.
"""

import ctypes
import functools

import numpy as np
import torch

from ..circulant_bp import _circulant_bp_frames

_METHODS = {"product_sum": 0, "min_sum": 1}
_MAX_W = 64
_INT_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)


@functools.cache
def _lib():
    from ._build import load

    lib = load("circulant_bp")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.circulant_bp_decode.argtypes = [p, p, p, p, i, i, i, i, i, p, p, p, p, p, p]
    lib.circulant_bp_decode.restype = i
    lib.circulant_fer_step.argtypes = [p, f, p, i, i, i, i, i, p, p, p, p, p, p, p]
    lib.circulant_fer_step.restype = i
    return lib


def _check(x, name, shape, dtypes, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {x.dtype}, expected one of {dtypes}")
    if device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_args(shifts, n, max_iter, method):
    if method not in _METHODS:
        raise ValueError(f"unknown bp method: {method}")
    shifts = tuple(int(k) % n for k in shifts)
    if not 1 <= len(shifts) <= _MAX_W:
        raise ValueError(f"circulant weight {len(shifts)} outside [1, {_MAX_W}]")
    if int(max_iter) < 0:
        raise ValueError("max_iter must be >= 0")
    return shifts


def _cuda_stream(device):
    if device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA or (plain version) CPU tensors, not {device}")
    return torch.cuda.current_stream(device).cuda_stream


def circulant_bp_plain(prior_c, prior_i, syndrome, shifts, max_iter, method="min_sum"):
    """Plain PyTorch version of :func:`circulant_bp_cuda`, on any device."""
    return _circulant_bp_frames(prior_c, prior_i, syndrome, tuple(shifts), True, int(max_iter), method)


def circulant_bp_cuda(prior_c, prior_i, syndrome, shifts, max_iter, method="min_sum"):
    """Decode [B, N] syndromes of ``[circulant | I]``.

    prior_c, prior_i: [B, N] float32 LLRs; syndrome: [B, N] 0/1 (integer or
    bool); shifts: the circulant's support offsets.  Returns (e [B, 2N] int32,
    conv [B] bool, iters [B] int32), ``iters`` being the iteration at which
    each frame first converged, or the number run if it never did.
    """
    device = prior_c.device
    if prior_c.ndim != 2:
        raise ValueError(f"prior_c must be [B, N], got shape {tuple(prior_c.shape)}")
    b, n = prior_c.shape
    _check(prior_c, "prior_c", (b, n), (torch.float32,), device)
    _check(prior_i, "prior_i", (b, n), (torch.float32,), device)
    _check(syndrome, "syndrome", (b, n), _INT_DTYPES, device)
    shifts = _check_args(shifts, n, max_iter, method)
    if device.type == "cpu":
        return circulant_bp_plain(prior_c, prior_i, syndrome, shifts, max_iter, method)

    stream = _cuda_stream(device)
    w = len(shifts)
    with torch.cuda.device(device):
        syn = syndrome.to(torch.uint8).contiguous()
        k = torch.tensor(shifts, dtype=torch.int32, device=device)
        c2v = torch.empty((b, w, n), dtype=torch.float32, device=device)
        tot = torch.empty((b, n), dtype=torch.float32, device=device)
        e = torch.empty((b, 2 * n), dtype=torch.uint8, device=device)
        conv = torch.empty((b,), dtype=torch.uint8, device=device)
        iters = torch.empty((b,), dtype=torch.int32, device=device)
        if b:
            rc = _lib().circulant_bp_decode(
                prior_c.data_ptr(), prior_i.data_ptr(), syn.data_ptr(), k.data_ptr(),
                w, n, b, int(max_iter), _METHODS[method],
                c2v.data_ptr(), tot.data_ptr(), e.data_ptr(), conv.data_ptr(), iters.data_ptr(),
                stream,
            )
            if rc != 0:
                raise RuntimeError(f"circulant_bp_decode launch failed: CUDA error {rc}")
            circulant_bp_cuda.launches += 1
    return e.to(torch.int32), conv.bool(), iters


circulant_bp_cuda.launches = 0


def circulant_fer_plain(errors, shifts, error_rate, max_iter, method="product_sum"):
    """Plain PyTorch version of :func:`circulant_fer_cuda`, on any device."""
    b, n2 = errors.shape
    n = n2 // 2
    e = errors.to(torch.int32)
    syn = (sum(torch.roll(e[:, :n], k, dims=-1) for k in shifts) + e[:, n:]) % 2
    prior = float(np.log((1 - error_rate) / error_rate))
    pc = torch.full((b, n), prior, dtype=torch.float32, device=errors.device)
    e_hat, conv, _ = _circulant_bp_frames(pc, pc, syn, tuple(shifts), True, int(max_iter), method)
    return torch.all(e_hat == e, dim=-1), conv


def circulant_fer_cuda(errors, shifts, error_rate, max_iter, method="product_sum"):
    """FER step core: [B, 2N] 0/1 error bits (integer or bool) in ->
    ([B] success, [B] converged) bool flags, decoding with the uniform prior
    ``log((1 - error_rate) / error_rate)``."""
    device = errors.device
    if errors.ndim != 2 or errors.shape[1] % 2:
        raise ValueError(f"errors must be [B, 2N], got shape {tuple(errors.shape)}")
    b, n2 = errors.shape
    n = n2 // 2
    _check(errors, "errors", (b, n2), _INT_DTYPES, device)
    shifts = _check_args(shifts, n, max_iter, method)
    if not 0.0 < error_rate < 1.0:
        raise ValueError(f"error_rate {error_rate} outside (0, 1)")
    if device.type == "cpu":
        return circulant_fer_plain(errors, shifts, error_rate, max_iter, method)

    stream = _cuda_stream(device)
    w = len(shifts)
    prior = float(np.log((1 - error_rate) / error_rate))
    with torch.cuda.device(device):
        err = errors.to(torch.uint8).contiguous()
        k = torch.tensor(shifts, dtype=torch.int32, device=device)
        c2v = torch.empty((b, w, n), dtype=torch.float32, device=device)
        tot = torch.empty((b, n), dtype=torch.float32, device=device)
        syn = torch.empty((b, n), dtype=torch.uint8, device=device)
        e_hat = torch.empty((b, n2), dtype=torch.uint8, device=device)
        ok = torch.empty((b,), dtype=torch.uint8, device=device)
        conv = torch.empty((b,), dtype=torch.uint8, device=device)
        if b:
            rc = _lib().circulant_fer_step(
                err.data_ptr(), prior, k.data_ptr(), w, n, b, int(max_iter), _METHODS[method],
                c2v.data_ptr(), tot.data_ptr(), syn.data_ptr(), e_hat.data_ptr(),
                ok.data_ptr(), conv.data_ptr(), stream,
            )
            if rc != 0:
                raise RuntimeError(f"circulant_fer_step launch failed: CUDA error {rc}")
            circulant_fer_cuda.launches += 1
    return ok.bool(), conv.bool()


circulant_fer_cuda.launches = 0
