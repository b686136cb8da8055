"""CUDA q-ary min-sum kernels and their plain PyTorch versions.

Counterparts of ``sca_ldpc_tpu/ops/kernels/qary_pallas.py``:

- :func:`chain_exclusive_cuda` (``chain_exclusive_pallas``, K5): the check
  update, the exclusive min-plus prefix/suffix chain of every check, with an
  optional per-check ``extra`` operand; bitwise equal to
  :func:`~sca_ldpc_tpu_torch.ops.minplus.chain_exclusive`; its instance
  (warps a block, checks a warp) comes from :func:`chain_launch`, its table
  (caps, guarded offsets, combine order) from :func:`chain_table`;
- :func:`qary_min_sum_fused_cuda` (``qary_min_sum_fused``, K6): the whole
  fixed-iteration decode in one launch, hard decisions out; bitwise equal
  totals, so equal decisions, to the plain ``_qary_min_sum``;
- :func:`qary_special_min_sum_fused_cuda` (``qary_special_min_sum_fused``,
  K7): the whole fixed-iteration two-alphabet (Kyber) decode in one launch;
  bitwise equal totals, so equal decisions, to the plain
  ``qary_special._special_min_sum``.

All launch ``csrc/qary_min_sum.cu`` (built with ``nvcc`` at first use, see
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
from typing import NamedTuple

import torch

from ..minplus import chain_exclusive
from .circulant_cuda import _check, _cuda_stream, _ptxas_report, smem_limits

_F32 = (torch.float32,)
_I32 = (torch.int32,)

# K6's instances, warps a block (one frame), built as K7's: at most 64
# registers a thread, so 32 warps an SM as far as registers go.  The 4-warp
# block, taken only when no larger one fits, keeps every frame of DC >= 6
# that the form before took (8 warps, no guards) in one block.
FUSED_WARPS = (32, 16, 8, 4)
FUSED_SM_WARPS = 32

# K7's instances, warps a block (one frame): each is built with
# __launch_bounds__(32 * warps, 32 / warps), at most 64 registers a thread,
# so 32 warps an SM as far as registers go.
SPECIAL_WARPS = (32, 16, 8)
SPECIAL_SM_WARPS = 32


# K5's staged instances: warps a block and checks a warp, each built with
# __launch_bounds__(32 * warps, 32 / warps), at most 64 registers a thread;
# a table of at most CHAIN_MAX_D slots.  CHAIN_PER_WARP_WARPS: the per-warp
# form's block (one check a warp, no staging), kept for the shapes whose
# staged block does not fit.
CHAIN_WARPS = (16, 8, 4)
CHAIN_CHECKS = (1, 2, 4)
CHAIN_SM_WARPS = 32
# resident warps an SM beyond which more bought K5 little (tools/qary_forms.py,
# every instance: 16 warps of 4 checks within 2.5% of 32 warps of 2 at Q = 15)
CHAIN_HIDE_WARPS = 16
CHAIN_MAX_D = 32
CHAIN_PER_WARP_WARPS = 8


class FusedLaunch(NamedTuple):
    """Launch configuration of K6 or K7 for one code and alphabet."""

    warps: int  # warps a block (one frame)
    blocks_per_sm: int  # blocks resident on one SM by design
    smem_bytes: int  # dynamic shared memory a block


@functools.cache
def _lib():
    from ._build import load

    lib = load("qary_min_sum")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.qary_chain_exclusive.argtypes = [p, p, p, ll, p, i, i, i, p]
    lib.qary_chain_exclusive.restype = i
    lib.qary_chain_table_bytes.argtypes = []
    lib.qary_chain_table_bytes.restype = i
    lib.qary_min_sum_fused.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, p, p]
    lib.qary_min_sum_fused.restype = i
    lib.qary_chain_smem_bytes.argtypes = [p, i, i]
    lib.qary_chain_smem_bytes.restype = ll
    lib.qary_fused_smem_bytes.argtypes = [i, i, i, i, i]
    lib.qary_fused_smem_bytes.restype = ll
    lib.qary_fused_occupancy.argtypes = [i, i, i]
    lib.qary_fused_occupancy.restype = i
    lib.qary_special_min_sum_fused.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p]
    lib.qary_special_min_sum_fused.restype = i
    lib.qary_special_fused_smem_bytes.argtypes = [i, i, i, i, i, i]
    lib.qary_special_fused_smem_bytes.restype = ll
    return lib


def fused_cap(count, d, b):
    """Stored support of K6's partial conv of ``count`` operands (the
    kernel's fused_cap)."""
    return min(count, d - count) * b


def fused_partial_offset(count, d, b):
    """Offset of K6's partial conv of ``count`` operands in a warp's chain
    buffer, every partial between BIG guards of 2b floats (the kernel's
    fused_partial_offset; ``count = d``: the buffer's floats)."""
    return 2 * b + sum(2 * fused_cap(c, d, b) + 1 + 2 * b for c in range(count))


def fused_suffix_offset(d, b):
    """Floats from a K6 warp's prefix chain buffer to its suffix chain
    buffer (the kernel's fused_suffix_offset): the buffer rounded up to 16
    modulo 32, so that the two chains' lanes of a pass read banks 16 apart."""
    pf = fused_partial_offset(d, d, b)
    return pf + (48 - pf % 32) % 32


def fused_smem_bytes(n, r, dc, q, warps):
    """Dynamic shared memory of one K6 block (one frame) of ``warps`` warps:
    v2c [R, DC, Q] and the totals [N, Q], each warp's prefix and suffix
    chain buffers, and the block's table of DC + 1 partial offsets and the
    DC slots in combine order (4-byte ints).

    4 (R DC Q + N Q + W (S + P) + 2 DC + 1) bytes, P =
    :func:`fused_partial_offset` (DC, DC, B) and S =
    :func:`fused_suffix_offset` (DC, B).  A Python copy of the kernel's
    ``qary_fused_smem_bytes`` (with ``fused_cap``, ``fused_partial_offset``
    and ``fused_suffix_offset``), so that the chooser and
    ``QaryDecoder``'s fit run without the library.  Nothing but the card
    test ``test_fused_launch_configuration_on_the_card`` and
    ``chip_smoke.py`` phase 6 holds the two copies equal."""
    b = (q - 1) // 2
    warp_floats = fused_suffix_offset(dc, b) + fused_partial_offset(dc, dc, b)
    return 4 * (r * dc * q + n * q + warps * warp_floats + 2 * dc + 1)


def fused_launch(n, r, dc, q, smem_block, smem_sm):
    """K6's launch configuration for a code of ``n`` variables and ``r``
    checks of ``dc`` slots over ``q`` symbols on a device with the
    shared-memory limits ``smem_block`` and ``smem_sm``
    (:func:`~sca_ldpc_tpu_torch.ops.kernels.circulant_cuda.smem_limits`).

    Of :data:`FUSED_WARPS` down to 8 warps, the instance whose blocks hold
    the most warps an SM, by shared memory (with what CUDA reserves for each
    block: the SM's shared memory less what one block may opt in to) and by
    registers (:data:`FUSED_SM_WARPS`); among instances that tie, the
    smallest block: more frames in flight and fewer warps at each
    ``__syncthreads()``.  The 4-warp instance only when no larger block
    fits: it keeps the frames that outgrew 8 warps, and was slower wherever
    8 fit.  On the H100 (NVIDIA H100 80GB HBM3, 700 W; ``tools/qary_forms.py``,
    one call) that is one block of 32 warps at the medium decoder (Q = 15;
    16-warp blocks fit one an SM: 3.059 ms for 2.491 at 512 frames; 4-warp
    blocks two an SM: 5.138) and four of 8 at Q = 3 (batch 4096: 2.424 ms
    for 2.631 at one of 32 and 2.447 at eight of 4).  Raises ValueError
    when not even one block of the smallest fits."""
    reserved = smem_sm - smem_block
    fitting = [(w, fused_smem_bytes(n, r, dc, q, w)) for w in FUSED_WARPS]
    fitting = [(w, smem) for w, smem in fitting if smem <= smem_block]
    if not fitting:
        warps = FUSED_WARPS[-1]
        raise ValueError(
            f"qary_min_sum_fused_cuda: N={n}, R={r}, DC={dc}, Q={q} need {fused_smem_bytes(n, r, dc, q, warps)} B "
            f"of shared memory per frame at {warps} warps; the bound is {smem_block} B (backend='chain' takes any size)")
    best = None
    for warps, smem in [x for x in fitting if x[0] >= 8] or fitting:
        cfg = FusedLaunch(warps, min(smem_sm // (smem + reserved), FUSED_SM_WARPS // warps), smem)
        if best is None or cfg.warps * cfg.blocks_per_sm >= best.warps * best.blocks_per_sm:
            best = cfg
    return best


def fused_occupancy(n, r, dc, q, device="cuda"):
    """K6's launch configuration on ``device``, as :func:`_occupancy`
    gives it.  Needs a CUDA device."""
    device = torch.device(device)
    cfg = fused_launch(n, r, dc, q, *smem_limits(device))
    return _occupancy(6, cfg, _lib().qary_fused_smem_bytes(n, r, dc, q, cfg.warps), device)


def _occupancy(kernel, cfg, lib_smem, device):
    """The launch configuration ``cfg`` of K6 (``kernel`` 6) or K7 (7) as a
    dict of :class:`FusedLaunch`'s fields, the library's own count of its
    shared memory (``lib_smem_bytes``), and ``resident_blocks`` and
    ``resident_warps`` per SM of its instance from the occupancy
    calculator."""
    with torch.cuda.device(device):
        blocks = _lib().qary_fused_occupancy(kernel, cfg.warps, cfg.smem_bytes)
    if blocks < 0:
        raise RuntimeError(f"qary_fused_occupancy failed: CUDA error {-blocks}")
    return {**cfg._asdict(), "lib_smem_bytes": lib_smem, "resident_blocks": blocks,
            "resident_warps": blocks * cfg.warps}


def fused_ptxas(kernel):
    """ptxas's ``-v`` report on the instances of K6 (``kernel`` 6) or K7
    (7) of the built library: {warps: (registers, spill bytes stored and
    loaded)} a thread.  Builds the library if needed (needs nvcc)."""
    from ._build import build

    name = {6: "qary_fused_kernel", 7: "qary_special_fused_kernel"}[kernel]
    return _ptxas_report(build("qary_min_sum"), name + r"ILi(\d+)EE", lambda m: int(m[1]))


def fused_adjacency_bad(n, chk_var, chk_sign, chk_mask, var_flat):
    """A 0-d bool tensor, true when K6's adjacency is out of range:
    ``chk_var`` outside [0, N) on a real slot, ``chk_sign`` not +-1 or
    ``var_flat`` outside [0, R*DC]."""
    real = chk_mask != 0
    return (
        (real & ((chk_var < 0) | (chk_var >= n))).any()
        | ((chk_sign != 1) & (chk_sign != -1)).any()
        | ((var_flat < 0) | (var_flat > chk_var.numel())).any()
    )


def _cap(count, d, b_sup, s_pre, s_mid):
    """Stored support of a partial conv of ``count`` operands (the kernel's cap_of)."""
    return min(count * b_sup, s_pre + (d - 1 - count) * b_sup, s_mid)


def special_warp_floats(sw, b, bsum):
    """Floats of one K7 warp's slice of shared memory (the kernel's
    special_warp_floats): the row's signed sum channel, then the chain's
    scratch (prefix and suffix partial convs, the ``sw`` combine outputs) or
    the sum decision's two buffers, whichever is larger."""
    qs, s_pre, s_mid = 2 * bsum + 1, b + bsum, (2 * sw - 1) * b
    partials = sum(2 * _cap(c, sw, b, s_pre, s_mid) + 1 for c in range(sw))
    return qs + max(2 * partials + sw * (2 * s_pre + 1), 2 * qs)


def special_fused_smem_bytes(n_b, r, sw, b, bsum, warps):
    """Dynamic shared memory of one K7 block (one frame) of ``warps`` warps:
    v2c [R, SW, QB] and the B totals [NB, QB], then each warp's slice."""
    qb = 2 * b + 1
    return 4 * (r * sw * qb + n_b * qb + warps * special_warp_floats(sw, b, bsum))


def special_fused_launch(n_b, r, sw, b, bsum, smem_block, smem_sm):
    """K7's launch configuration for a code of ``n_b`` B-variables, ``r``
    rows of ``sw`` B-slots and the alphabets ``b``, ``bsum`` on a device with
    the shared-memory limits ``smem_block`` and ``smem_sm``
    (:func:`~sca_ldpc_tpu_torch.ops.kernels.circulant_cuda.smem_limits`):
    the most warps a block (of :data:`SPECIAL_WARPS`) whose block fits, and
    the blocks an SM holds, by its shared memory with what CUDA reserves for
    each block (the SM's shared memory less what one block may opt in to)
    and by registers (:data:`SPECIAL_SM_WARPS`).  Each instance reaches the
    registers' 32 warps an SM when its blocks fit, so the largest block that
    fits holds the most warps.  Raises ValueError when not even one block of
    the smallest fits."""
    reserved = smem_sm - smem_block
    for warps in SPECIAL_WARPS:
        smem = special_fused_smem_bytes(n_b, r, sw, b, bsum, warps)
        if smem <= smem_block:
            return FusedLaunch(warps, min(smem_sm // (smem + reserved), SPECIAL_SM_WARPS // warps), smem)
    warps = SPECIAL_WARPS[-1]
    raise ValueError(
        f"qary_special_min_sum_fused_cuda: NB={n_b}, R={r}, SW={sw}, B={b}, BSUM={bsum} need "
        f"{special_fused_smem_bytes(n_b, r, sw, b, bsum, warps)} B of shared memory per frame at {warps} warps; "
        f"the bound is {smem_block} B (backend='chain' takes any size)")


def special_fused_occupancy(n_b, r, sw, b, bsum, device="cuda"):
    """K7's launch configuration on ``device``, as :func:`_occupancy` gives
    it.  Needs a CUDA device."""
    device = torch.device(device)
    cfg = special_fused_launch(n_b, r, sw, b, bsum, *smem_limits(device))
    return _occupancy(7, cfg, _lib().qary_special_fused_smem_bytes(n_b, r, sw, b, bsum, cfg.warps), device)


class ChainTable(NamedTuple):
    """K5's table for one shape (the kernel's ``ChainTable``): a check's
    staged operands, its chain region (prefix chain buffer, suffix chain
    buffer ``suf`` floats in, then with the extra operand the slots' combine
    outputs) and how each pass walks it.  Offsets are in floats."""

    d: int
    q: int
    s_mid: int
    s_out: int
    we: int  # extra operand's width, 0 without
    in_stride: int  # floats a staged operand takes
    in_guard: int  # its BIG guards on each side (read by a chain step that walks the partial)
    suf: int
    tmp: int  # extra only: the combine outputs' offset in the chain region
    tmp_stride: int  # extra only: a slot's floats there
    region: int  # floats of a check's chain region
    wc: int  # combine outputs a slot: 2 (s_out + se) + 1
    cap: tuple  # stored support of the partial of c operands (minplus.chain_exclusive's cap)
    off: tuple  # its offset in a chain buffer, every partial between BIG guards of ``guard`` floats
    swap: tuple  # chain step t walks the partial (1) or the operand (0): minplus.conv's operand swap
    slot: tuple  # the combine's slots by falling term window (ties: slot order)
    walk: tuple  # that slot's walked partial, offset in the chain region
    terms: tuple  # its term window
    read: tuple  # its read partial's offset in the chain region plus the conv's index offset
    guard: int


class _CChainTable(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_int) for f in ChainTable._fields[:12]]
                + [(f, ctypes.c_int * CHAIN_MAX_D) for f in ChainTable._fields[12:19]])


class ChainLaunch(NamedTuple):
    """Launch configuration of K5 for one shape."""

    warps: int  # warps a block
    checks: int  # checks a warp; 0: the per-warp form (one check a warp, no staging)
    blocks_per_sm: int  # blocks resident on one SM by design
    smem_bytes: int  # dynamic shared memory a block


@functools.cache
def chain_table(d, q, s_mid, s_out, we=0, checks=1):
    """K5's table for ``chain_exclusive`` over ``d`` operands of width ``q``
    (supports ``s_mid``, ``s_out``, an extra operand of width ``we`` or none)
    at ``checks`` checks a warp.

    Every conv of the chain reads one operand at ``k0 + k - i`` for output k
    and walked term i (``minplus.conv``'s loop, after its operand swap).
    Where that index leaves the operand, the term is ``a[i] + BIG``; the
    kernel reads the same BIG from a guard.  A chain step that walks the
    operand (width 2B+1) reads the partial of t operands up to ``cap(t+1) + B
    - cap(t)`` outside it, one that walks the partial reads the operand up to
    ``cap(t+1) + cap(t) - B`` outside; the combine to +-s_pre reads the
    wider partial up to ``s_pre + m - M`` outside (m, M the two caps); the
    extra conv never leaves its combine output.  One guard width, the
    largest a partial needs, sits between the partials of each chain buffer.
    The suffix buffer starts 16 banks from the prefix buffer (the two chains'
    lanes of a pass read banks 16 apart); a slot's combine output takes a
    stride of the output width modulo 32 (the extra pass's lanes on distinct
    banks); with several checks a warp a check's region is 16/checks modulo
    32 floats (the checks' lanes on distinct banks)."""
    d, q, s_mid, s_out, we, checks = (int(x) for x in (d, q, s_mid, s_out, we, checks))
    b = (q - 1) // 2
    se = (we - 1) // 2 if we else 0
    s_pre = s_out + se
    w_out = 2 * s_out + 1
    cap = tuple(min(c * b, s_pre + (d - 1 - c) * b, s_mid) for c in range(d))
    swap = tuple(int(min(t * b, cap[t]) < b) for t in range(d - 1))
    reach = [cap[t + 1] + b - cap[t] for t in range(d - 1) if not swap[t]]
    reach += [s_pre + min(cap[j], cap[d - 1 - j]) - max(cap[j], cap[d - 1 - j]) for j in range(d)]
    guard = max(0, *reach)
    in_guard = max([0] + [cap[t + 1] + cap[t] - b for t in range(d - 1) if swap[t]])
    off, f = [], guard
    for c in range(d):
        off.append(f)
        f += 2 * cap[c] + 1 + guard
    suf = f + (48 - f % 32) % 32
    wc = 2 * s_pre + 1
    tmp, tmp_stride = suf + f, (wc + (w_out - wc) % 32 if we else 0)
    region = tmp + d * tmp_stride
    if checks > 1:
        region += (16 // checks - region) % 32
    walk, terms, read = [], [], []
    for j in range(d):
        cj, cs = cap[j], cap[d - 1 - j]
        pre, sfx = off[j], suf + off[d - 1 - j]
        walk.append(sfx if cs < cj else pre)  # minplus.conv walks the narrower partial
        read.append((pre if cs < cj else sfx) + cj + cs - s_pre)
        terms.append(2 * min(cj, cs) + 1)
    slot = tuple(sorted(range(d), key=lambda j: (-terms[j], j)))
    return ChainTable(d, q, s_mid, s_out, we, q + 2 * in_guard, in_guard, suf, tmp, tmp_stride, region, wc, cap,
                      tuple(off), swap, slot, tuple(walk[j] for j in slot), tuple(terms[j] for j in slot),
                      tuple(read[j] for j in slot), guard)


def chain_warp_floats(d, q, s_mid, s_out, we=0):
    """Floats of one warp's slice in K5's per-warp form (the kernel's
    chain_warp_floats): the check's operands, its extra operand, both chains'
    capped partials back to back and one combine output."""
    t = chain_table(d, q, s_mid, s_out, we)
    f = d * q + 2 * sum(2 * c + 1 for c in t.cap)
    return f + (we + t.wc if we else 0)


CHAIN_TABLE_BYTES = ctypes.sizeof(_CChainTable)


def chain_smem_bytes(d, q, s_mid, s_out, we, warps, checks):
    """Dynamic shared memory of one K5 block of the instance (``warps``,
    ``checks``): the table, then each check's staged operands, extra operand,
    outputs and chain region; ``checks`` 0: the per-warp form's
    CHAIN_PER_WARP_WARPS slices.  A Python copy of the kernel's
    ``qary_chain_smem_bytes``, so that the chooser runs without the library;
    the card test ``test_chain_launch_configuration_on_the_card`` holds the
    two equal."""
    if checks == 0:
        return 4 * warps * chain_warp_floats(d, q, s_mid, s_out, we)
    t = chain_table(d, q, s_mid, s_out, we, checks)
    return CHAIN_TABLE_BYTES + 4 * warps * checks * (d * (t.in_stride + 2 * s_out + 1) + we + t.region)


def chain_steps(d, q, s_mid, s_out, we, checks):
    """Serial term steps of a warp's ``checks`` checks in K5's staged form,
    per check: each pass of 32 lanes takes as many steps as its widest term
    window (chain steps, the combine by falling window, the extra pass)."""
    t = chain_table(d, q, s_mid, s_out, we, checks)
    steps = 0
    for s in range(d - 1):
        items = 2 * checks * (2 * t.cap[s + 1] + 1)
        steps += -(-items // 32) * (2 * t.cap[s] + 1 if t.swap[s] else q)
    # a combine pass's widest window is its first item's: the slots come by falling window
    steps += sum(t.terms[p // checks // t.wc] for p in range(0, checks * d * t.wc, 32))
    if we:
        steps += -(-checks * d * (2 * s_out + 1) // 32) * we
    return steps / checks


def chain_instance(d, q, s_mid, s_out, we, warps, checks, smem_block, smem_sm):
    """The ChainLaunch of K5's instance (``warps``, ``checks``) for a shape,
    or None where its block does not fit ``smem_block``; blocks an SM by
    shared memory (with what CUDA reserves for each block: the SM's shared
    memory less what one block may opt in to) and by registers
    (:data:`CHAIN_SM_WARPS` for the staged instances; the per-warp form's
    64 warps an SM at most)."""
    smem = chain_smem_bytes(d, q, s_mid, s_out, we, warps, checks)
    if smem > smem_block:
        return None
    sm_warps = CHAIN_SM_WARPS if checks else 64
    return ChainLaunch(warps, checks, min(smem_sm // (smem + smem_sm - smem_block), sm_warps // warps), smem)


@functools.cache
def chain_launch(d, q, s_mid, s_out, we, smem_block, smem_sm):
    """K5's launch configuration for ``chain_exclusive`` over ``d`` operands
    of width ``q`` (supports ``s_mid``, ``s_out``, extra width ``we`` or 0)
    on a device with the shared-memory limits ``smem_block`` and ``smem_sm``
    (:func:`~sca_ldpc_tpu_torch.ops.kernels.circulant_cuda.smem_limits`).

    Of the staged instances (:data:`CHAIN_WARPS` x :data:`CHAIN_CHECKS`)
    whose block fits: those whose blocks hold at least
    :data:`CHAIN_HIDE_WARPS` warps an SM (or the most, where none does), by
    shared memory and registers (:func:`chain_instance`); among them the
    fewest serial term steps a check (:func:`chain_steps`: several checks
    share a warp where one check's passes leave lanes idle), then the most
    warps an SM, then the smallest block.  Where no staged block fits (or d >
    CHAIN_MAX_D), the per-warp form, which fits wherever the form before the
    redesign did (it is that form).  Raises ValueError when not even that
    fits.  On the H100 (NVIDIA H100 80GB HBM3, 700.00 W;
    ``tools/qary_forms.py``, one call, batch 4096): 4 warps x 4 checks at Q =
    15 (1.927 ms; 1.844 the best instance, 16 x 2), Q = 3 (0.269, the best
    within 0.5%) and Kyber eta 2 (3.808, the best), 4 x 2 at eta 3 (6.350,
    the best; 6.858 the best of one check a warp, 32 warps an SM)."""
    best, best_key = None, None
    for checks in CHAIN_CHECKS if d <= CHAIN_MAX_D else ():
        steps = chain_steps(d, q, s_mid, s_out, we, checks)
        for warps in CHAIN_WARPS:
            cfg = chain_instance(d, q, s_mid, s_out, we, warps, checks, smem_block, smem_sm)
            if cfg is None:
                continue
            sm_warps = cfg.warps * cfg.blocks_per_sm
            key = (-min(sm_warps, CHAIN_HIDE_WARPS), steps, -sm_warps, warps)
            if best is None or key < best_key:
                best, best_key = cfg, key
    best = best or chain_instance(d, q, s_mid, s_out, we, CHAIN_PER_WARP_WARPS, 0, smem_block, smem_sm)
    if best is None:
        smem = chain_smem_bytes(d, q, s_mid, s_out, we, CHAIN_PER_WARP_WARPS, 0)
        raise ValueError(
            f"chain_exclusive_cuda: DC={d}, Q={q}, s_mid={s_mid}, s_out={s_out}, We={we} need {smem} B of shared "
            f"memory per block of {CHAIN_PER_WARP_WARPS} checks; the bound is {smem_block} B")
    return best


@functools.cache
def _c_table(d, q, s_mid, s_out, we, checks):
    """:func:`chain_table` as the kernel's struct (the per-warp form reads
    only its shape)."""
    t = chain_table(d, q, s_mid, s_out, we, max(checks, 1))
    c = _CChainTable(*t[:12])
    if d <= CHAIN_MAX_D:
        for f in ChainTable._fields[12:19]:
            getattr(c, f)[:len(getattr(t, f))] = getattr(t, f)
    return c


def chain_ptxas():
    """ptxas's ``-v`` report on K5's instances of the built library:
    {(warps, checks): (registers, spill bytes stored and loaded)} a thread,
    (8, 0) the per-warp form.  Builds the library if needed (needs nvcc)."""
    from ._build import build

    path = build("qary_min_sum")
    staged = _ptxas_report(path, r"chain_staged_kernelILi(\d+)ELi(\d+)EE", lambda m: (int(m[1]), int(m[2])))
    return {**staged, **_ptxas_report(path, r"chain_exclusive_kernel", lambda m: (CHAIN_PER_WARP_WARPS, 0))}


@functools.cache
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def chain_exclusive_plain(v2c, s_mid, s_out, extra=None):
    """Plain PyTorch version of :func:`chain_exclusive_cuda`, on any device."""
    return chain_exclusive(v2c, s_mid, extra=extra, s_out=s_out)


def chain_exclusive_cuda(v2c, s_mid, s_out, extra=None, instance=None):
    """``minplus.chain_exclusive(v2c, s_mid, extra, s_out)``, as the JAX
    package's ``chain_exclusive_pallas(v2c, s_mid, s_out, extra)``.

    v2c: [Bt, R, DC, Q] float32, Q odd; extra: [Bt, R, We] float32, We odd,
    or None.  Returns [Bt, R, DC, 2*s_out+1] float32.  ``instance`` (for
    tests) forces (warps, checks) of :data:`CHAIN_WARPS` x
    :data:`CHAIN_CHECKS`, or (CHAIN_PER_WARP_WARPS, 0), in place of
    :func:`chain_launch`'s choice.
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
    smem_block, smem_sm = smem_limits(device)
    if instance is None:
        cfg = chain_launch(dc, q, s_mid, s_out, we, smem_block, smem_sm)
    else:
        warps, checks = instance
        if not ((warps in CHAIN_WARPS and checks in CHAIN_CHECKS and dc <= CHAIN_MAX_D)
                or (warps, checks) == (CHAIN_PER_WARP_WARPS, 0)):
            raise ValueError(f"instance={instance} is not one of K5's instances")
        cfg = chain_instance(dc, q, s_mid, s_out, we, warps, checks, smem_block, smem_sm)
        if cfg is None:
            raise ValueError(f"instance={instance}: a block does not fit the card's shared memory")
    with torch.cuda.device(device):
        out = torch.empty((bt, r, dc, 2 * s_out + 1), dtype=torch.float32, device=device)
        if bt * r:
            max_blocks = _sm_count(device) * max(cfg.blocks_per_sm, 1)
            rc = _lib().qary_chain_exclusive(
                v2c.data_ptr(), extra.data_ptr() if extra is not None else None, out.data_ptr(), bt * r,
                ctypes.byref(_c_table(dc, q, s_mid, s_out, we, cfg.checks)), cfg.warps, cfg.checks, max_blocks, stream,
            )
            if rc != 0:
                raise RuntimeError(f"qary_chain_exclusive launch failed: CUDA error {rc}")
            chain_exclusive_cuda.launches += 1
            chain_exclusive_cuda.instances.add((cfg.warps, cfg.checks))
    return out


chain_exclusive_cuda.launches = 0
chain_exclusive_cuda.instances = set()  # the instances (warps, checks) launched


def qary_min_sum_fused_plain(channel, chk_var, chk_sign, chk_mask, var_flat, b_range, max_iter):
    """Plain PyTorch version of :func:`qary_min_sum_fused_cuda`, on any
    device: the fixed-iteration plain ``_qary_min_sum``."""
    from ..qary import _qary_min_sum

    return _qary_min_sum(chk_var, chk_sign, chk_mask, var_flat, channel, int(max_iter), int(b_range))


def qary_min_sum_fused_cuda(channel, chk_var, chk_sign, chk_mask, var_flat, b_range, max_iter, warps=None,
                            check_adjacency=True):
    """Whole q-ary min-sum decode, as the JAX package's ``qary_min_sum_fused``.

    channel: [Bt, N, Q] float32 finite min-sum LLRs, Q = 2*b_range+1;
    chk_var, chk_sign, chk_mask: [R, DC] int32 and var_flat: [N, DV] int32,
    as in :class:`~sca_ldpc_tpu_torch.codes.layout.CodeLayout` (chk_mask 0/1).
    Returns hard decisions [Bt, N] int32 in [-b_range..b_range].  ``warps``
    (for tests) forces one of :data:`FUSED_WARPS` in place of
    :func:`fused_launch`'s choice.  The adjacency's range
    (:func:`fused_adjacency_bad`) is checked on the device, a host sync,
    unless ``check_adjacency`` is False: :class:`~sca_ldpc_tpu_torch.ops.qary.QaryDecoder`
    checks its fixed arrays once, when it is built.
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
    if warps is None:
        warps = fused_launch(n, r, dc, q, *smem_limits(device)).warps
    elif warps not in FUSED_WARPS:
        raise ValueError(f"warps={warps} is not one of K6's instances {FUSED_WARPS}")
    elif fused_smem_bytes(n, r, dc, q, warps) > smem_limits(device)[0]:
        raise ValueError(f"warps={warps}: a block does not fit the card's shared memory")
    if check_adjacency and bool(fused_adjacency_bad(n, chk_var, chk_sign, chk_mask, var_flat)):
        raise ValueError("adjacency out of range: chk_var in [0, N) on real slots, chk_sign +-1, "
                         "var_flat in [0, R*DC]")
    with torch.cuda.device(device):
        hard = torch.empty((bt, n), dtype=torch.int32, device=device)
        if bt:
            rc = _lib().qary_min_sum_fused(
                channel.data_ptr(), chk_var.data_ptr(), chk_sign.data_ptr(), chk_mask.data_ptr(),
                var_flat.data_ptr(), bt, n, r, dc, dv, q, max_iter, warps, hard.data_ptr(), stream,
            )
            if rc != 0:
                raise RuntimeError(f"qary_min_sum_fused launch failed: CUDA error {rc}")
            qary_min_sum_fused_cuda.launches += 1
            qary_min_sum_fused_cuda.instances.add(warps)
    return hard


qary_min_sum_fused_cuda.launches = 0
qary_min_sum_fused_cuda.instances = set()  # the instances (warps a block) launched


def qary_special_min_sum_fused_plain(channel_llr, channel_sum_row, vsum_signed, bvar_idx, bvar_sign, bvar_mask,
                                     var_flat, sum_sign, b, bsum, max_iter):
    """Plain PyTorch version of :func:`qary_special_min_sum_fused_cuda`, on
    any device: the fixed-iteration plain ``_special_min_sum`` (which forms
    the signed sum channel itself, so ``vsum_signed`` is not read)."""
    from ..qary import _var_sign_mask
    from ..qary_special import _special_min_sum

    var_sign, var_mask = _var_sign_mask(bvar_sign, var_flat)
    return _special_min_sum(bvar_idx, bvar_sign, bvar_mask, var_flat, var_sign, var_mask, sum_sign,
                            channel_llr, channel_sum_row, int(max_iter), int(b), int(bsum))


def qary_special_min_sum_fused_cuda(channel_llr, channel_sum_row, vsum_signed, bvar_idx, bvar_sign, bvar_mask,
                                    var_flat, sum_sign, b, bsum, max_iter, warps=None):
    """Whole two-alphabet decode of ``[H'|I]``, as the JAX package's
    ``qary_special_min_sum_fused``.

    channel_llr: [Bt, NB, 2b+1] float32 finite min-sum LLRs of the
    B-variables; channel_sum_row: [Bt, R, 2bsum+1] float32 finite LLRs of
    the sum variables in row order; vsum_signed: the same reversed on rows
    whose ``sum_sign`` is -1 (the sum variable's constant v2c message);
    bvar_idx, bvar_sign, bvar_mask: [R, SW] int32 and var_flat: [NB, DV]
    int32, as :func:`~sca_ldpc_tpu_torch.ops.qary_special.special_index_arrays`
    gives them (bvar_mask 0/1); sum_sign: [R] int32.  Returns
    ``(hard_b [Bt, NB], hard_sum_row [Bt, R])`` int32.  ``warps`` (for
    tests) forces one of :data:`SPECIAL_WARPS` in place of
    :func:`special_fused_launch`'s choice.
    """
    device = channel_llr.device
    if channel_llr.ndim != 3 or channel_sum_row.ndim != 3 or bvar_idx.ndim != 2 or var_flat.ndim != 2:
        raise ValueError("channel_llr must be [Bt, NB, QB], channel_sum_row [Bt, R, QS], bvar_idx [R, SW] "
                         "and var_flat [NB, DV]")
    bt, nb, qb = channel_llr.shape
    r, sw = bvar_idx.shape
    qs = channel_sum_row.shape[2]
    dv = var_flat.shape[1]
    _check(channel_llr, "channel_llr", (bt, nb, qb), _F32, device)
    _check(channel_sum_row, "channel_sum_row", (bt, r, qs), _F32, device)
    _check(vsum_signed, "vsum_signed", (bt, r, qs), _F32, device)
    for name, x, shape in (("bvar_idx", bvar_idx, (r, sw)), ("bvar_sign", bvar_sign, (r, sw)),
                           ("bvar_mask", bvar_mask, (r, sw)), ("var_flat", var_flat, (nb, dv)),
                           ("sum_sign", sum_sign, (r,))):
        _check(x, name, shape, _I32, device)
    b, bsum, max_iter = int(b), int(bsum), int(max_iter)
    if qb != 2 * b + 1 or qs != 2 * bsum + 1 or b < 1 or bsum < 1:
        raise ValueError(f"channels have {qb} and {qs} symbol columns, expected 2*{b}+1 and 2*{bsum}+1 (b, bsum >= 1)")
    if max_iter < 0:
        raise ValueError("max_iter must be >= 0")
    if device.type == "cpu":
        return qary_special_min_sum_fused_plain(channel_llr, channel_sum_row, vsum_signed, bvar_idx, bvar_sign,
                                                bvar_mask, var_flat, sum_sign, b, bsum, max_iter)

    stream = _cuda_stream(device)
    if warps is None:
        warps = special_fused_launch(nb, r, sw, b, bsum, *smem_limits(device)).warps
    elif warps not in SPECIAL_WARPS:
        raise ValueError(f"warps={warps} is not one of K7's instances {SPECIAL_WARPS}")
    elif special_fused_smem_bytes(nb, r, sw, b, bsum, warps) > smem_limits(device)[0]:
        raise ValueError(f"warps={warps}: a block does not fit the card's shared memory")
    real = bvar_mask != 0
    bad = (
        (real & ((bvar_idx < 0) | (bvar_idx >= nb))).any()
        | ((bvar_sign != 1) & (bvar_sign != -1)).any()
        | ((sum_sign != 1) & (sum_sign != -1)).any()
        | ((var_flat < 0) | (var_flat > r * sw)).any()
    )
    if bool(bad):
        raise ValueError("adjacency out of range: bvar_idx in [0, NB) on real slots, bvar_sign and sum_sign "
                         "+-1, var_flat in [0, R*SW]")
    with torch.cuda.device(device):
        hard_b = torch.empty((bt, nb), dtype=torch.int32, device=device)
        hard_s = torch.empty((bt, r), dtype=torch.int32, device=device)
        if bt:
            rc = _lib().qary_special_min_sum_fused(
                channel_llr.data_ptr(), channel_sum_row.data_ptr(), vsum_signed.data_ptr(), bvar_idx.data_ptr(),
                bvar_sign.data_ptr(), bvar_mask.data_ptr(), var_flat.data_ptr(), sum_sign.data_ptr(),
                bt, nb, r, sw, dv, b, bsum, max_iter, warps, hard_b.data_ptr(), hard_s.data_ptr(), stream,
            )
            if rc != 0:
                raise RuntimeError(f"qary_special_min_sum_fused launch failed: CUDA error {rc}")
            qary_special_min_sum_fused_cuda.launches += 1
            qary_special_min_sum_fused_cuda.instances.add(warps)
    return hard_b, hard_s


qary_special_min_sum_fused_cuda.launches = 0
qary_special_min_sum_fused_cuda.instances = set()  # the instances (warps a block) launched
