"""CUDA circulant-BP kernels and their plain PyTorch versions.

Counterparts of ``sca_ldpc_tpu/ops/kernels/circulant_pallas.py``:

- :func:`circulant_bp_cuda` (``circulant_bp_pallas``): priors and syndrome in,
  decisions out;
- :func:`circulant_fer_cuda` (``circulant_fer_pallas``): true error bits in,
  success and convergence flags out, with the syndrome, decode and comparison
  on the card;
- :func:`circulant_bp_lean_cuda` (``circulant_bp_pallas_lean``) and
  :func:`circulant_fer_lean_cuda` (``circulant_fer_pallas_lean``): the same
  two entry points over the lean decode, which rounds its v2c and c2v
  messages to bf16 at the TPU kernel's rounding points (product-sum only);
- :func:`multi_circulant_bp_cuda` (K8; the XLA function
  ``ops/circulant_bp.py`` ``_multi_circulant_bp``, which has no Pallas
  kernel): the HQC attack's masked decode over P stacked circulants.

The first two launch ``csrc/circulant_bp.cu``, the lean pair
``csrc/circulant_lean.cu``, K8 ``csrc/circulant_multi.cu`` (built with
``nvcc`` at first use, see ``_build.py``), for CUDA tensors, and run the
plain version beside them for CPU tensors.  There is no fallback: a CUDA tensor that the kernel cannot take
raises.  Each wrapper counts its kernel launches in ``.launches``.
:func:`circulant_launch` is the first pair's launch configuration for a
device's shared-memory limits (:func:`smem_limits`): where the variable
totals live (shared or device memory), threads a block and the padded plane
stride; :func:`circulant_lean_launch` is the lean pair's (how many variables
a thread stages in shared memory); :func:`multi_circulant_launch` is K8's
cooperative grid for the card's resident blocks
(:func:`multi_circulant_occupancy`).

Unlike the TPU kernels, the batch need not be a multiple of a tile and the
shifts are runtime data.  K1/K2 keep f32 messages (their TPU kernels store
bf16 v2c); the lean kernels keep the TPU kernel's bf16 planes.
"""

import ctypes
import functools
import re
from typing import NamedTuple

import numpy as np
import torch

from ..circulant_bp import _BIG, _circulant_bp_frames, _multi_circulant_bp_frames, _phi

_METHODS = {"product_sum": 0, "min_sum": 1}
_MAX_W = 64
_INT_DTYPES = (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)

# K1/K2 are built with __launch_bounds__(1024, 1): at most 64 registers a
# thread, so 1024 threads (32 warps) a SM, as one block or two.
THREADS_SM = 1024


def _round_up(x, m):
    return -(-x // m) * m


class CirculantLaunch(NamedTuple):
    """Launch configuration of K1/K2 for one (N, w)."""

    placement: str  # "shared": tot in the block's shared memory; "device": tot [B, N] in device memory
    threads: int  # threads a block
    blocks_per_sm: int  # blocks resident on one SM by design
    smem_bytes: int  # dynamic shared memory a block: the shifts, then tot in the shared placement
    ld: int  # c2v plane stride in floats: N rounded up to a multiple of 32


# K3/K4 are built with __launch_bounds__(512, 2): at most 64 registers a
# thread, so two blocks of 512 threads (32 warps) a SM.  Each block keeps
# the phi table and the shifts in static shared memory and, in dynamic shared
# memory, the bf16 extrinsics of the chunk of variables it is updating: w
# planes x LeanLaunch.elems variables a thread.
LEAN_THREADS = 512
LEAN_MAX_ELEMS = 4
LEAN_STATIC_SMEM = 4 * 36 * 128 + 4 * _MAX_W


class LeanLaunch(NamedTuple):
    """Launch configuration of K3/K4 for one circulant weight."""

    elems: int  # variables a thread holds at a time in the variable sweep
    smem_bytes: int  # dynamic shared memory a block: w * elems * LEAN_THREADS bf16 extrinsics
    blocks_per_sm: int  # blocks resident on one SM by design


def smem_limits(device):
    """(dynamic shared memory one block may opt in to, one SM's shared
    memory) of a CUDA device, in bytes."""
    props = torch.cuda.get_device_properties(device)
    return props.shared_memory_per_block_optin, props.shared_memory_per_multiprocessor


def circulant_launch(n, w, smem_block, smem_sm):
    """K1/K2's launch configuration for circulant size ``n`` and weight ``w``
    on a device with the shared-memory limits ``smem_block`` and ``smem_sm``
    (:func:`smem_limits`).

    The shifts take ``w`` rounded up to 32 ints at the head of shared
    memory; the totals (4n bytes) follow them when the block can hold both,
    and live in device memory otherwise.  Two blocks of 512 threads share an
    SM when their shared memory, with what CUDA reserves for each block (the
    SM's shared memory less what one block may opt in to), fits twice, else
    one block of 1024: 32 warps either way."""
    n, w = int(n), int(w)
    if n < 1 or not 1 <= w <= _MAX_W:
        raise ValueError(f"need n >= 1 and w in [1, {_MAX_W}], got n={n}, w={w}")
    shifts_bytes = 4 * _round_up(w, 32)
    placement, smem = "shared", shifts_bytes + 4 * n
    if smem > smem_block:
        placement, smem = "device", shifts_bytes
    blocks = 2 if 2 * (smem + smem_sm - smem_block) <= smem_sm else 1
    return CirculantLaunch(placement, THREADS_SM // blocks, blocks, smem, _round_up(n, 32))


def circulant_lean_launch(w, smem_block, smem_sm):
    """K3/K4's launch configuration for circulant weight ``w`` on a device
    with the shared-memory limits ``smem_block`` and ``smem_sm``
    (:func:`smem_limits`): the most variables a thread (up to
    ``LEAN_MAX_ELEMS``) whose extrinsics, with the kernel's static shared
    memory and what CUDA reserves for each block, still fit twice on an SM;
    if not even one a thread fits twice, the most that fit once."""
    w = int(w)
    if not 1 <= w <= _MAX_W:
        raise ValueError(f"need w in [1, {_MAX_W}], got w={w}")
    reserved = smem_sm - smem_block
    for blocks in (2, 1):
        for elems in range(LEAN_MAX_ELEMS, 0, -1):
            smem = 2 * w * elems * LEAN_THREADS
            if LEAN_STATIC_SMEM + smem <= smem_block and blocks * (LEAN_STATIC_SMEM + smem + reserved) <= smem_sm:
                return LeanLaunch(elems, smem, blocks)
    raise ValueError(f"shared memory of {smem_block} B a block cannot hold the lean kernel's state for w={w}")


@functools.cache
def _lib():
    from ._build import load

    lib = load("circulant_bp")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.circulant_bp_decode.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p, p, p, p]
    lib.circulant_bp_decode.restype = i
    lib.circulant_fer_step.argtypes = [p, f, p, i, i, i, i, i, i, i, i, p, p, p, p, p, p, p]
    lib.circulant_fer_step.restype = i
    lib.circulant_bp_occupancy.argtypes = [i, i, i, i, i]
    lib.circulant_bp_occupancy.restype = i
    return lib


def circulant_occupancy(n, w, method="product_sum", device="cuda"):
    """The launch configuration of (n, w) on ``device`` (a dict of
    :func:`circulant_launch`'s fields) plus ``resident_blocks`` and
    ``resident_warps`` per SM of its K1/K2 instance, from the occupancy
    calculator.  Needs a CUDA device."""
    if method not in _METHODS:
        raise ValueError(f"unknown bp method: {method}")
    device = torch.device(device)
    cfg = circulant_launch(n, w, *smem_limits(device))
    with torch.cuda.device(device):
        blocks = _lib().circulant_bp_occupancy(int(w), _METHODS[method], int(cfg.placement == "shared"),
                                               cfg.threads, cfg.smem_bytes)
    if blocks < 0:
        raise RuntimeError(f"circulant_bp_occupancy failed: CUDA error {-blocks}")
    return {**cfg._asdict(), "resident_blocks": blocks, "resident_warps": blocks * cfg.threads // 32}


def _ptxas_report(lib_path, pattern, key):
    """{key(match of ``pattern`` in an entry function's name): (registers,
    spill bytes stored and loaded)} from the ``.log`` beside a built library."""
    out, inst, spill = {}, None, 0
    for ln in lib_path.with_suffix(".log").read_text().splitlines():
        m = re.search(pattern, ln)
        if m and "Compiling entry function" in ln:
            inst, spill = key(m), 0
        elif inst and "spill stores" in ln:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln).groups()
            spill = int(st) + int(ld)
        elif inst and "Used" in ln:
            out[inst] = (int(re.search(r"Used (\d+) registers", ln)[1]), spill)
            inst = None
    return out


def circulant_ptxas():
    """ptxas's ``-v`` report on every K1/K2 instance of the built library:
    {(MAXW, method, placement): (registers, spill bytes stored and loaded)}
    a thread.  Builds the library if needed (needs nvcc)."""
    from ._build import build

    return _ptxas_report(
        build("circulant_bp"), r"circulant_bp_kernelILi(\d+)ELb(\d)ELb(\d)E",
        lambda m: (int(m[1]), "min_sum" if m[2] == "1" else "product_sum", "shared" if m[3] == "1" else "device"))


def _scratch(b, w, n, device):
    """K1/K2's launch configuration, c2v [B, w, ld] and, in the device
    placement only, tot [B, N] (None in the shared one)."""
    cfg = circulant_launch(n, w, *smem_limits(device))
    c2v = torch.empty((b, w, cfg.ld), dtype=torch.float32, device=device)
    tot = torch.empty((b, n), dtype=torch.float32, device=device) if cfg.placement == "device" else None
    return cfg, c2v, tot


@functools.cache
def _lean_lib():
    from ._build import load

    lib = load("circulant_lean")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.circulant_bp_lean_decode.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p, p, p, p, p, p]
    lib.circulant_bp_lean_decode.restype = i
    lib.circulant_fer_lean_step.argtypes = [p, f, p, i, i, i, i, i, i, i, p, p, p, p, p, p, p]
    lib.circulant_fer_lean_step.restype = i
    lib.circulant_lean_phi_table.argtypes = [p, p, p]
    lib.circulant_lean_phi_table.restype = i
    lib.circulant_lean_occupancy.argtypes = [i, i, i]
    lib.circulant_lean_occupancy.restype = i
    return lib


def circulant_lean_occupancy(w, device="cuda"):
    """The launch configuration of weight ``w`` on ``device`` and the resident
    blocks and warps per SM of the lean kernel's two instances for it, from
    the occupancy calculator: {"decode" (K3) / "fer" (K4): {"elems",
    "smem_bytes", "blocks_per_sm" (the launch configuration's), "resident_blocks",
    "resident_warps"}}.  Needs a CUDA device."""
    device = torch.device(device)
    cfg = circulant_lean_launch(w, *smem_limits(device))
    out = {}
    with torch.cuda.device(device):
        for fer, name in enumerate(("decode", "fer")):
            blocks = _lean_lib().circulant_lean_occupancy(fer, cfg.elems, cfg.smem_bytes)
            if blocks < 0:
                raise RuntimeError(f"circulant_lean_occupancy failed: CUDA error {-blocks}")
            out[name] = {**cfg._asdict(), "resident_blocks": blocks, "resident_warps": blocks * LEAN_THREADS // 32}
    return out


def circulant_lean_ptxas():
    """ptxas's ``-v`` report on the lean kernel's instances of the built
    library: {("decode" (K3) / "fer" (K4), elems): (registers, spill bytes
    stored and loaded)} a thread.  Builds the library if needed (needs nvcc)."""
    from ._build import build

    return _ptxas_report(build("circulant_lean"), r"circulant_lean_kernelILb(\d)ELi(\d)EE",
                         lambda m: ("fer" if m[1] == "1" else "decode", int(m[2])))


def circulant_lean_phi_table(device="cuda"):
    """The lean kernel's shared-memory phi table as one block builds it, read
    through its index function for every bf16 bit pattern, and the direct
    phi of the same bf16 magnitudes: two [65536] float32 tensors indexed by
    the bf16's bits.  Needs a CUDA device."""
    device = torch.device(device)
    stream = _cuda_stream(device)
    with torch.cuda.device(device):
        tab, direct = (torch.empty((1 << 16,), dtype=torch.float32, device=device) for _ in range(2))
        rc = _lean_lib().circulant_lean_phi_table(tab.data_ptr(), direct.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"circulant_lean_phi_table launch failed: CUDA error {rc}")
    return tab, direct


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


def _check_lean_args(shifts, n, max_iter, method):
    if method != "product_sum":
        raise ValueError(f"the lean kernels are product-sum only, not {method!r}")
    return _check_args(shifts, n, max_iter, method)


def _check_decode(prior_c, prior_i, syndrome):
    """Checks the decode inputs; returns (device, B, N)."""
    device = prior_c.device
    if prior_c.ndim != 2:
        raise ValueError(f"prior_c must be [B, N], got shape {tuple(prior_c.shape)}")
    b, n = prior_c.shape
    _check(prior_c, "prior_c", (b, n), (torch.float32,), device)
    _check(prior_i, "prior_i", (b, n), (torch.float32,), device)
    _check(syndrome, "syndrome", (b, n), _INT_DTYPES, device)
    return device, b, n


def _check_fer(errors, error_rate):
    """Checks the FER-step inputs; returns (device, B, N)."""
    device = errors.device
    if errors.ndim != 2 or errors.shape[1] % 2:
        raise ValueError(f"errors must be [B, 2N], got shape {tuple(errors.shape)}")
    b, n2 = errors.shape
    _check(errors, "errors", (b, n2), _INT_DTYPES, device)
    if not 0.0 < error_rate < 1.0:
        raise ValueError(f"error_rate {error_rate} outside (0, 1)")
    return device, b, n2 // 2


def _syndrome_and_prior(errors, shifts, error_rate):
    """The FER step's syndrome [B, N] of [B, 2N] error bits and its uniform
    prior LLR ``log((1 - p) / p)``, as a [B, N] float32 tensor."""
    b, n2 = errors.shape
    n = n2 // 2
    e = errors.to(torch.int32)
    syn = (sum(torch.roll(e[:, :n], k, dims=-1) for k in shifts) + e[:, n:]) % 2
    prior = float(np.log((1 - error_rate) / error_rate))
    return syn, torch.full((b, n), prior, dtype=torch.float32, device=errors.device)


def _cuda_stream(device):
    if device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA or (plain version) CPU tensors, not {device}")
    return torch.cuda.current_stream(device).cuda_stream


def circulant_bp_plain(prior_c, prior_i, syndrome, shifts, max_iter, method="min_sum", with_identity=True):
    """Plain PyTorch version of :func:`circulant_bp_cuda`, on any device."""
    return _circulant_bp_frames(prior_c, prior_i, syndrome, tuple(shifts), with_identity, int(max_iter), method)


def circulant_bp_cuda(prior_c, prior_i, syndrome, shifts, max_iter, method="min_sum", with_identity=True):
    """Decode [B, N] syndromes of ``[circulant | I]``, or of the circulant
    alone with ``with_identity=False``.

    prior_c, prior_i: [B, N] float32 LLRs (``prior_i`` is not read without
    the identity); syndrome: [B, N] 0/1 (integer or bool); shifts: the
    circulant's support offsets.  Returns (e [B, 2N] int32, or [B, N] without
    the identity, conv [B] bool, iters [B] int32), ``iters`` being the
    iteration at which each frame first converged, or the number run if it
    never did.
    """
    device, b, n = _check_decode(prior_c, prior_i, syndrome)
    shifts = _check_args(shifts, n, max_iter, method)
    if device.type == "cpu":
        return circulant_bp_plain(prior_c, prior_i, syndrome, shifts, max_iter, method, with_identity)

    stream = _cuda_stream(device)
    w = len(shifts)
    with torch.cuda.device(device):
        syn = syndrome.to(torch.uint8).contiguous()
        k = torch.tensor(shifts, dtype=torch.int32, device=device)
        cfg, c2v, tot = _scratch(b, w, n, device)
        e = torch.empty((b, 2 * n if with_identity else n), dtype=torch.uint8, device=device)
        conv = torch.empty((b,), dtype=torch.uint8, device=device)
        iters = torch.empty((b,), dtype=torch.int32, device=device)
        if b:
            rc = _lib().circulant_bp_decode(
                prior_c.data_ptr(), prior_i.data_ptr(), syn.data_ptr(), k.data_ptr(),
                w, n, cfg.ld, b, int(max_iter), _METHODS[method], int(bool(with_identity)),
                cfg.threads, cfg.smem_bytes, c2v.data_ptr(), None if tot is None else tot.data_ptr(),
                e.data_ptr(), conv.data_ptr(), iters.data_ptr(), stream,
            )
            if rc != 0:
                raise RuntimeError(f"circulant_bp_decode launch failed: CUDA error {rc}")
            circulant_bp_cuda.launches += 1
    return e.to(torch.int32), conv.bool(), iters


circulant_bp_cuda.launches = 0


def circulant_fer_plain(errors, shifts, error_rate, max_iter, method="product_sum"):
    """Plain PyTorch version of :func:`circulant_fer_cuda`, on any device."""
    syn, pc = _syndrome_and_prior(errors, shifts, error_rate)
    e_hat, conv, _ = _circulant_bp_frames(pc, pc, syn, tuple(shifts), True, int(max_iter), method)
    return torch.all(e_hat == errors.to(torch.int32), dim=-1), conv


def circulant_fer_cuda(errors, shifts, error_rate, max_iter, method="product_sum"):
    """FER step core: [B, 2N] 0/1 error bits (integer or bool) in ->
    ([B] success, [B] converged) bool flags, decoding with the uniform prior
    ``log((1 - error_rate) / error_rate)``."""
    device, b, n = _check_fer(errors, error_rate)
    shifts = _check_args(shifts, n, max_iter, method)
    if device.type == "cpu":
        return circulant_fer_plain(errors, shifts, error_rate, max_iter, method)

    stream = _cuda_stream(device)
    w = len(shifts)
    prior = float(np.log((1 - error_rate) / error_rate))
    with torch.cuda.device(device):
        err = errors.to(torch.uint8).contiguous()
        k = torch.tensor(shifts, dtype=torch.int32, device=device)
        cfg, c2v, tot = _scratch(b, w, n, device)
        syn = torch.empty((b, n), dtype=torch.uint8, device=device)
        e_i = torch.empty((b, n), dtype=torch.uint8, device=device)
        ok = torch.empty((b,), dtype=torch.uint8, device=device)
        conv = torch.empty((b,), dtype=torch.uint8, device=device)
        if b:
            rc = _lib().circulant_fer_step(
                err.data_ptr(), prior, k.data_ptr(), w, n, cfg.ld, b, int(max_iter), _METHODS[method],
                cfg.threads, cfg.smem_bytes, c2v.data_ptr(), None if tot is None else tot.data_ptr(),
                syn.data_ptr(), e_i.data_ptr(), ok.data_ptr(), conv.data_ptr(), stream,
            )
            if rc != 0:
                raise RuntimeError(f"circulant_fer_step launch failed: CUDA error {rc}")
            circulant_fer_cuda.launches += 1
    return ok.bool(), conv.bool()


circulant_fer_cuda.launches = 0


def _sgn(x):
    return torch.where(x >= 0, 1.0, -1.0)


def _lean_state(b, w, n, device):
    """The lean kernel's launch configuration, its plane stride ``ld`` (N
    rounded up to 32 bf16 values, so that every plane row starts on a
    64-byte boundary) and its per-frame state, which needs no
    initialisation: the messages v2c [B, w, ld] bf16 and acc [B, N] f32
    (each check's phi sum, with its sign parity in the sign bit)."""
    cfg = circulant_lean_launch(w, *smem_limits(device))
    ld = _round_up(n, 32)
    return cfg, ld, (torch.empty((b, w, ld), dtype=torch.bfloat16, device=device),
                     torch.empty((b, n), dtype=torch.float32, device=device))


def circulant_bp_lean_plain(prior_c, prior_i, syndrome, shifts, max_iter):
    """Plain PyTorch version of :func:`circulant_bp_lean_cuda`, on any device:
    the lean decode of ``_make_lean_kernel`` (shifts as data, one plane per
    group, no lane padding) on [B, N] tensors, with its rounding points.  The
    v2c and c2v planes are stored in bf16 (round to nearest even), the check
    accumulators are rebuilt from the stored bf16 planes, and the variable
    totals add the f32 extrinsics in plane order.  Returns (e [B, 2N] int32,
    conv [B] bool, iters [B] int32)."""
    bf16 = torch.bfloat16
    syn = syndrome.to(torch.int32)
    sgn_pi = _sgn(prior_i)
    phi_pi = _phi(torch.abs(prior_i))
    sgn_pi_syn = sgn_pi * (1 - 2 * syn).to(torch.float32)

    def accumulators(v2c):
        """Check accumulators (phi sum, sign product) over the identity
        plane, then the bf16 planes in order."""
        acc_phi, acc_sgn = phi_pi, sgn_pi_syn
        for plane in v2c:
            p = plane.float()
            acc_phi = acc_phi + _phi(torch.abs(p))
            acc_sgn = acc_sgn * _sgn(p)
        return acc_phi, acc_sgn

    # plane t, check i: the message from variable (i - k_t) mod N, unclipped at first
    v2c = [torch.roll(prior_c, k, dims=-1).to(bf16) for k in shifts]
    acc_phi, acc_sgn = accumulators(v2c)
    e_out = torch.cat([prior_c < 0, prior_i < 0], dim=-1).to(torch.int32)
    conv = torch.zeros((syn.shape[0],), dtype=torch.bool, device=syn.device)
    iters = torch.zeros((syn.shape[0],), dtype=torch.int32, device=syn.device)
    it = 0
    while it < int(max_iter) and not bool(torch.all(conv)):
        # pass A: extrinsics (stored bf16) and the f32 variable totals
        tot = prior_c
        c2v = []
        for plane, k in zip(v2c, shifts):
            p = plane.float()
            ext = acc_sgn * _sgn(p) * _phi(torch.clamp(acc_phi - _phi(torch.abs(p)), min=1e-9))
            c2v.append(ext.to(bf16))
            tot = tot + torch.roll(ext, -k, dims=-1)
        tot_i = prior_i + acc_sgn * sgn_pi * _phi(torch.clamp(acc_phi - phi_pi, min=1e-9))
        # pass B: planes rewritten from the bf16 extrinsics; the syndrome of
        # the decisions shares the rolls of the totals
        syn_hat = (tot_i < 0).to(torch.int32)
        for t, k in enumerate(shifts):
            rolled = torch.roll(tot, k, dims=-1)
            v2c[t] = torch.clamp(rolled - c2v[t].float(), -_BIG, _BIG).to(bf16)
            syn_hat = syn_hat + (rolled < 0).to(torch.int32)
        acc_phi, acc_sgn = accumulators(v2c)
        ok = torch.all(syn_hat % 2 == syn, dim=-1)
        e = torch.cat([tot < 0, tot_i < 0], dim=-1).to(torch.int32)
        # latch each frame's first converged estimate
        e_out = torch.where(conv[:, None], e_out, e)
        iters = torch.where(conv, iters, it + 1)
        conv = conv | ok
        it += 1
    return e_out, conv, iters


def circulant_bp_lean_cuda(prior_c, prior_i, syndrome, shifts, max_iter, method="product_sum"):
    """Lean decode of [B, N] syndromes of ``[circulant | I]`` (K3): the
    inputs and outputs of :func:`circulant_bp_cuda`, product-sum only, with
    the message planes stored in bf16 as ``circulant_bp_pallas_lean`` does."""
    device, b, n = _check_decode(prior_c, prior_i, syndrome)
    shifts = _check_lean_args(shifts, n, max_iter, method)
    if device.type == "cpu":
        return circulant_bp_lean_plain(prior_c, prior_i, syndrome, shifts, max_iter)

    stream = _cuda_stream(device)
    w = len(shifts)
    with torch.cuda.device(device):
        syn = syndrome.to(torch.uint8).contiguous()
        k = torch.tensor(shifts, dtype=torch.int32, device=device)
        cfg, ld, state = _lean_state(b, w, n, device)
        e = torch.empty((b, 2 * n), dtype=torch.uint8, device=device)
        conv = torch.empty((b,), dtype=torch.uint8, device=device)
        iters = torch.empty((b,), dtype=torch.int32, device=device)
        if b:
            rc = _lean_lib().circulant_bp_lean_decode(
                prior_c.data_ptr(), prior_i.data_ptr(), syn.data_ptr(), k.data_ptr(), w, n, ld, b, int(max_iter),
                cfg.elems, cfg.smem_bytes, *(x.data_ptr() for x in state), e.data_ptr(), conv.data_ptr(),
                iters.data_ptr(), stream,
            )
            if rc != 0:
                raise RuntimeError(f"circulant_bp_lean_decode launch failed: CUDA error {rc}")
            circulant_bp_lean_cuda.launches += 1
    return e.to(torch.int32), conv.bool(), iters


circulant_bp_lean_cuda.launches = 0


def circulant_fer_lean_plain(errors, shifts, error_rate, max_iter):
    """Plain PyTorch version of :func:`circulant_fer_lean_cuda`, on any device."""
    syn, pc = _syndrome_and_prior(errors, shifts, error_rate)
    e_hat, conv, _ = circulant_bp_lean_plain(pc, pc, syn, shifts, max_iter)
    return torch.all(e_hat == errors.to(torch.int32), dim=-1), conv


def circulant_fer_lean_cuda(errors, shifts, error_rate, max_iter, method="product_sum"):
    """Lean FER step (K4): the inputs and outputs of
    :func:`circulant_fer_cuda` over the lean decode, product-sum only."""
    device, b, n = _check_fer(errors, error_rate)
    shifts = _check_lean_args(shifts, n, max_iter, method)
    if device.type == "cpu":
        return circulant_fer_lean_plain(errors, shifts, error_rate, max_iter)

    stream = _cuda_stream(device)
    w = len(shifts)
    prior = float(np.log((1 - error_rate) / error_rate))
    with torch.cuda.device(device):
        err = errors.to(torch.uint8).contiguous()
        k = torch.tensor(shifts, dtype=torch.int32, device=device)
        cfg, ld, state = _lean_state(b, w, n, device)
        syn = torch.empty((b, n), dtype=torch.uint8, device=device)
        e_hat = torch.empty((b, 2 * n), dtype=torch.uint8, device=device)
        ok = torch.empty((b,), dtype=torch.uint8, device=device)
        conv = torch.empty((b,), dtype=torch.uint8, device=device)
        if b:
            rc = _lean_lib().circulant_fer_lean_step(
                err.data_ptr(), prior, k.data_ptr(), w, n, ld, b, int(max_iter), cfg.elems, cfg.smem_bytes,
                *(x.data_ptr() for x in state), syn.data_ptr(), e_hat.data_ptr(), ok.data_ptr(), conv.data_ptr(),
                stream,
            )
            if rc != 0:
                raise RuntimeError(f"circulant_fer_lean_step launch failed: CUDA error {rc}")
            circulant_fer_lean_cuda.launches += 1
    return ok.bool(), conv.bool()


circulant_fer_lean_cuda.launches = 0


# K8 is one cooperative launch a decode of MULTI_THREADS-thread blocks, each
# a check (or variable) a thread; a block stages the shifts (a frame's P * w
# at most MULTI_MAX_SHIFTS) and a bitmask of the running frames (at most
# MULTI_MAX_BATCH) in shared memory: shifts [P, w] shared by the batch once
# (stage 0), per-frame shifts [B, P, w] all at once where they fit in
# MULTI_MAX_STAGED ints with the bitmask (stage 1), or a tile's with the tile
# (stage 2).
MULTI_THREADS = 256
MULTI_MAX_SHIFTS = 10240
MULTI_MAX_BATCH = 65535
MULTI_MAX_STAGED = 12288  # ints: the 48 KB of shared memory a block takes without an opt-in


def multi_circulant_stage(batch, p, w, per_frame):
    """How K8 stages the shifts of ``batch`` frames of ``p`` blocks of
    weight ``w``: 0 for shifts [P, w] shared by the batch, else 1 (every
    frame's [P, w] staged once a block) where those and the bitmask fit in
    ``MULTI_MAX_STAGED`` ints, 2 (a tile's staged with it) where they do not."""
    if not per_frame:
        return 0
    return 1 if int(batch) * int(p) * int(w) + -(-int(batch) // 32) <= MULTI_MAX_STAGED else 2


class MultiLaunch(NamedTuple):
    """K8's cooperative launch for one (batch, P, N)."""

    grid: int  # blocks of the launch: the work tiles or the co-resident blocks, the fewer
    row_tiles: int  # work tiles of the check and syndrome sweeps: (frame, circulant block, row tile)
    var_tiles: int  # work tiles of the variable sweep: (frame, variable tile)
    threads: int  # threads a block, rows (or variables) a tile


def multi_circulant_launch(batch, p, n, blocks_per_sm, sms):
    """K8's launch for ``batch`` frames of ``p`` circulant blocks of size
    ``n`` on a device that holds ``blocks_per_sm`` of its blocks on each of
    ``sms`` SMs (:func:`multi_circulant_occupancy`).

    A cooperative launch needs every block resident, so the grid is the
    co-resident blocks where the check sweep has more tiles than that, and
    the tiles otherwise; block ``x`` of a grid of ``G`` walks the tiles
    ``x, x + G, ...``."""
    batch, p, n, resident = int(batch), int(p), int(n), int(blocks_per_sm) * int(sms)
    if batch < 1 or p < 1 or n < 1:
        raise ValueError(f"need batch, p and n >= 1, got batch={batch}, p={p}, n={n}")
    if resident < 1:
        raise ValueError(f"the device holds no K8 block resident ({blocks_per_sm} a SM on {sms} SMs)")
    tiles = -(-n // MULTI_THREADS)
    return MultiLaunch(min(batch * p * tiles, resident), batch * p * tiles, batch * tiles, MULTI_THREADS)


@functools.cache
def _multi_lib():
    from ._build import load

    lib = load("circulant_multi")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.multi_circulant_bp_decode.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p, p, p, p, p, p]
    lib.multi_circulant_bp_decode.restype = i
    lib.multi_circulant_bp_occupancy.argtypes = [i, i, i, i, i, p]
    lib.multi_circulant_bp_occupancy.restype = i
    return lib


@functools.cache
def _multi_occupancy(device_index, w, method, p, batch, stage):
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        rc = _multi_lib().multi_circulant_bp_occupancy(int(w), _METHODS[method], int(stage), int(p), int(batch), out)
    if rc != 0:
        raise RuntimeError(f"multi_circulant_bp_occupancy failed: CUDA error {rc}")
    return {"blocks_per_sm": out[0], "sms": out[1], "cooperative": bool(out[2]), "threads": out[3]}


def multi_circulant_occupancy(w, method="product_sum", p=1, device="cuda", batch=1, stage=0):
    """The card's limits for K8's instance of (w, method) with ``p`` blocks'
    shifts staged as ``stage`` (:func:`multi_circulant_stage`) and ``batch``
    frames' bitmask in shared memory: {"blocks_per_sm" (occupancy
    calculator), "sms", "cooperative" (the card can launch cooperatively),
    "threads" (a block)}.  Needs a CUDA device."""
    if method not in _METHODS:
        raise ValueError(f"unknown bp method: {method}")
    device = torch.device(device)
    return dict(_multi_occupancy(device.index if device.index is not None else torch.cuda.current_device(),
                                 int(w), method, int(p), int(batch), int(stage)))


def multi_circulant_ptxas():
    """ptxas's ``-v`` report on K8's instances: {(MAXW, method): (registers,
    spill bytes stored and loaded)} a thread.  Builds the library if needed
    (needs nvcc)."""
    from ._build import build

    return _ptxas_report(build("circulant_multi"), r"multi_decode_kernelILi(\d+)ELb(\d)E",
                         lambda m: (int(m[1]), "min_sum" if m[2] == "1" else "product_sum"))


def _check_multi(prior_c, prior_i, syndrome, shifts, max_iter, method):
    """Checks the masked decode's inputs; returns (device, B, P, N, shifts as
    int32 [P, W] or [B, P, W] in [0, N) on the device)."""
    device = prior_c.device
    if prior_c.ndim != 2 or syndrome.ndim != 3:
        raise ValueError(f"prior_c must be [B, N] and syndrome [B, P, N], got shapes {tuple(prior_c.shape)} "
                         f"and {tuple(syndrome.shape)}")
    b, p, n = syndrome.shape
    _check(prior_c, "prior_c", (b, n), (torch.float32,), device)
    _check(prior_i, "prior_i", (b, p, n), (torch.float32,), device)
    _check(syndrome, "syndrome", (b, p, n), _INT_DTYPES, device)
    k = torch.as_tensor(shifts, device=device)
    if k.ndim not in (2, 3) or tuple(k.shape[:-1]) not in ((p,), (b, p)) or not 1 <= k.shape[-1] <= _MAX_W:
        raise ValueError(f"shifts must be [P={p}, W] or [B={b}, P={p}, W] with W in [1, {_MAX_W}], got shape "
                         f"{tuple(k.shape)}")
    if k.dtype not in _INT_DTYPES[1:]:
        raise TypeError(f"shifts has dtype {k.dtype}, expected an integer dtype")
    if method not in _METHODS:
        raise ValueError(f"unknown bp method: {method}")
    if int(max_iter) < 0:
        raise ValueError("max_iter must be >= 0")
    return device, b, p, n, (k.to(torch.int64) % n).to(torch.int32).contiguous()


def multi_circulant_bp_plain(prior_c, prior_i, syndrome, shifts, max_iter, method="product_sum"):
    """Plain PyTorch version of :func:`multi_circulant_bp_cuda`, on any device.
    Per-frame shifts [B, P, W] decode frame by frame, each with its own."""
    shifts = torch.as_tensor(shifts)
    if shifts.ndim == 2 or not len(shifts):  # shared shifts, or no frame (any [P, W] decodes none)
        return _multi_circulant_bp_frames(prior_c, prior_i, syndrome, shifts if shifts.ndim == 2 else
                                          shifts.new_zeros(shifts.shape[1:]), int(max_iter), method)
    outs = [_multi_circulant_bp_frames(prior_c[f:f + 1], prior_i[f:f + 1], syndrome[f:f + 1], shifts[f],
                                       int(max_iter), method) for f in range(syndrome.shape[0])]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def multi_circulant_bp_cuda(prior_c, prior_i, syndrome, shifts, max_iter, method="product_sum"):
    """Decode the masked multi-circulant code ``[[C_1]; ...; [C_P]] | I_{P*N}``
    (K8).

    prior_c [B, N] float32 LLRs of the shared variables; prior_i [B, P, N]
    float32 identity priors (exactly 0 on an unmeasured row); syndrome
    [B, P, N] 0/1 (integer or bool); shifts integers (a tensor or array;
    one circulant's support offsets a block), [P, W] shared by the batch or
    [B, P, W], frame b decoded with the circulants ``shifts[b]`` (the
    batched attack's round, an instance a frame).  Returns (e_c [B, N] int32, e_i [B, P, N]
    int32, conv [B] bool, iters [B] int32), ``iters`` being the iteration at
    which each frame first converged, or the number run if it never did.

    One cooperative launch on the current stream, of the blocks that
    :func:`multi_circulant_launch` picks from the card's limits, and no
    synchronisation; a launch the card refuses raises.
    """
    device, b, p, n, k = _check_multi(prior_c, prior_i, syndrome, shifts, max_iter, method)
    if device.type == "cpu":
        return multi_circulant_bp_plain(prior_c, prior_i, syndrome, k, max_iter, method)
    w = k.shape[-1]
    if p * w > MULTI_MAX_SHIFTS or b > MULTI_MAX_BATCH:
        raise ValueError(f"P * W = {p * w} shifts a frame or B = {b} frames above the kernel's {MULTI_MAX_SHIFTS} "
                         f"and {MULTI_MAX_BATCH}")
    stage = multi_circulant_stage(b, p, w, k.ndim == 3)

    stream = _cuda_stream(device)
    ld = _round_up(n, 32)
    with torch.cuda.device(device):
        syn = syndrome.to(torch.uint8).contiguous()
        c2v = torch.empty((b, p, w, ld), dtype=torch.float32, device=device)
        tot = torch.empty((b, n), dtype=torch.float32, device=device)
        flags = torch.empty((2 * b,), dtype=torch.int32, device=device)
        e_c = torch.empty((b, n), dtype=torch.uint8, device=device)
        e_i = torch.empty((b, p, n), dtype=torch.uint8, device=device)
        conv = torch.empty((b,), dtype=torch.uint8, device=device)
        iters = torch.empty((b,), dtype=torch.int32, device=device)
        if b:
            occ = multi_circulant_occupancy(w, method, p, device, b, stage)
            grid = multi_circulant_launch(b, p, n, occ["blocks_per_sm"], occ["sms"]).grid
            rc = _multi_lib().multi_circulant_bp_decode(
                prior_c.data_ptr(), prior_i.data_ptr(), syn.data_ptr(), k.data_ptr(), stage, p, w, n, ld, b,
                int(max_iter), _METHODS[method], int(grid), c2v.data_ptr(), tot.data_ptr(),
                flags.data_ptr(), e_c.data_ptr(), e_i.data_ptr(), conv.data_ptr(), iters.data_ptr(), stream,
            )
            if rc != 0:
                raise RuntimeError(f"multi_circulant_bp_decode failed: CUDA error {rc}"
                                   + (" (cooperative launch too large: grid above the co-resident blocks)"
                                      if rc == 720 else ""))
            multi_circulant_bp_cuda.launches += 1
    return e_c.to(torch.int32), e_i.to(torch.int32), conv.bool(), iters


multi_circulant_bp_cuda.launches = 0
