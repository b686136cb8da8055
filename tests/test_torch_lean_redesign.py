"""The Hopper form of the lean kernels K3/K4 (``csrc/circulant_lean.cu``), on
the CPU: the index function of its phi table over every bf16 value, its
launch configuration, and a torch emulation of its arithmetic held against
the plain versions.

The emulation follows the kernel step by step on per-frame buffers: phi of a
bf16 message read from a table of 4,608 entries through the clamped bf16
bits; each check's accumulator with its sign parity in the float's sign bit;
no set-up plane sweep (the decode's first accumulators from look-ups of
``bf16(prior_c)``, its first pass A without a plane read; the FER step's
first accumulator and first extrinsics as per-frame constants whose sign
alone follows the syndrome bit); one message plane array, stored at the
variable with rows at the padded stride ``ld``: pass A reads a chunk's
messages at its own variables, stages the bf16 extrinsics (the shared-memory
buffer of the kernel), and with the totals complete overwrites the messages
in place; pass B reads them at the shifted index together with the
variables' decisions and writes no plane; each sweep's checks or variables
dealt out to threads in chunks of ``elems * threads``, thread ``tid`` holding
``chunk + tid + e * threads``; sums in plane order; per-frame early exit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sca_ldpc_tpu_torch.codes import CirculantLayout, random_circulant_first_row
from sca_ldpc_tpu_torch.ops.circulant_bp import _BIG, _phi
from sca_ldpc_tpu_torch.ops.kernels import circulant_cuda
from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import (
    LEAN_MAX_ELEMS,
    LEAN_STATIC_SMEM,
    LEAN_THREADS,
    circulant_bp_lean_plain,
    circulant_fer_lean_plain,
    circulant_lean_launch,
)

torch.set_num_threads(1)

# the kernel's kTabLo and kTabSize: bf16 magnitudes from 2^-30 (the exponent
# that holds 1e-9) to the end of the exponent that holds 60.0
TAB_LO, TAB_SIZE = 0x3080, 36 * 128
SIGN = -(1 << 31)


def _bf16_value(bits):
    """float32 values of bf16 bit patterns given as an int tensor in [0, 65535]."""
    as_i16 = torch.from_numpy(bits.numpy().astype(np.uint16).view(np.int16))
    return as_i16.view(torch.bfloat16).float().reshape(bits.shape)


def _bf16_bits(x):
    """bf16 bit patterns (int32 in [0, 65535]) of float32 values, rounded to nearest even."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF


def _tab_index(bits):
    return torch.clamp((bits & 0x7FFF) - TAB_LO, 0, TAB_SIZE - 1)


def _negative(bits):
    return bits > 0x8000


def _table():
    return _phi(_bf16_value(TAB_LO + torch.arange(TAB_SIZE)))


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---- the table's index function


def test_table_spans_the_clamp():
    assert _bf16_value(torch.tensor([TAB_LO])).item() == 2.0**-30 < 1e-9
    assert _bf16_value(torch.tensor([TAB_LO + 128])).item() == 2.0**-29 > 1e-9
    assert _bf16_bits(torch.tensor([60.0])).item() == 0x4270 < TAB_LO + TAB_SIZE
    assert 4 * TAB_SIZE == 18432
    tab = _table()
    lo, hi = _phi(torch.tensor([1e-9, 60.0]))
    assert _same_bits(tab[:1], lo[None]) and _same_bits(tab[-1:], hi[None])
    # phi(60) is -log(1) = -0.0: the table keeps the sign of that zero
    assert hi.item() == 0.0 and torch.signbit(hi) and torch.signbit(tab[-1])


def test_table_lookup_equals_phi_for_every_bf16_value():
    """Every bf16 magnitude, with either sign (NaNs left out): the look-up
    through the clamped bits equals phi of the value, bit for bit."""
    bits = torch.arange(1 << 16, dtype=torch.int32)
    bits = bits[(bits & 0x7FFF) <= 0x7F80]
    assert len(bits) == 2 * (0x7F80 + 1)
    x = _bf16_value(bits)
    assert torch.isinf(x).sum() == 2 and not torch.isnan(x).any()
    assert _same_bits(_table()[_tab_index(bits)], _phi(x.abs()))
    assert torch.equal(_negative(bits), x < 0)


@pytest.mark.parametrize("value", [0.0, -0.0, 1e-12, 9.9e-10, 1e-9, 1.1e-9, 0.5, 59.9, 60.0, 60.5, 69.0, 1e30,
                                   float("inf"), -float("inf"), -3.25])
def test_table_lookup_of_rounded_floats(value):
    """A float32 rounded to bf16 as the kernel rounds it, at both ends of
    the clamp and beyond them."""
    x = torch.tensor([value], dtype=torch.float32)
    bits = _bf16_bits(x)
    rounded = x.to(torch.bfloat16).float()
    assert _same_bits(_table()[_tab_index(bits)], _phi(rounded.abs()))
    assert bool(_negative(bits)) == bool(rounded < 0)


# ---- launch configuration


def test_launch_constants_are_the_kernel_sources():
    """The wrapper's constants, and this file's, are those ``circulant_lean.cu``
    compiles in: threads a block, the most variables a thread, the table and
    the static shared memory (the table and ``kMaxW`` shifts)."""
    src = (Path(circulant_cuda.__file__).parents[2] / "csrc" / "circulant_lean.cu").read_text()
    const = {name: eval(value) for name, value in re.findall(r"constexpr int (k\w+) = ([0-9a-fx* ]+);", src)}
    assert (const["kThreads"], const["kMaxElemsA"], const["kElemsB"]) == (LEAN_THREADS, LEAN_MAX_ELEMS, ELEMS_B)
    assert (const["kTabLo"], const["kTabSize"], const["kBlocksPerSm"]) == (TAB_LO, TAB_SIZE, 2)
    assert LEAN_STATIC_SMEM == 4 * const["kTabSize"] + 4 * const["kMaxW"] == 18688
    assert "__shared__ float tab_s[kTabSize];" in src and "__shared__ int k_s[kMaxW];" in src


@pytest.mark.parametrize("w,elems", [(20, 4), (30, 3), (1, 4), (64, 1)])
def test_launch_holds_two_blocks_an_sm_on_an_h100(w, elems):
    """HQC-128 (w = 20) stages 4 variables a thread, HQC-192/256 (w = 30) 3:
    the most whose bf16 extrinsics fit twice on an SM beside the table."""
    cfg = circulant_lean_launch(w, *H100)
    assert cfg == (elems, 2 * w * elems * LEAN_THREADS, 2)
    per_block = LEAN_STATIC_SMEM + cfg.smem_bytes + (H100[1] - H100[0])
    assert 2 * per_block <= H100[1]
    if elems < LEAN_MAX_ELEMS:
        assert 2 * (per_block + 2 * w * LEAN_THREADS) > H100[1]


def test_launch_follows_the_device_limits():
    """Less shared memory (an A100's 166,912 B a block) stages fewer
    variables; where two blocks no longer fit, one block takes what fits;
    where nothing fits, the helper raises."""
    a100 = (166_912, 167_936)
    assert circulant_lean_launch(20, *a100) == (3, 61_440, 2)
    assert circulant_lean_launch(30, *a100) == (2, 61_440, 2)
    assert circulant_lean_launch(64, *a100) == (2, 131_072, 1)
    assert circulant_lean_launch(20, 49_152, 65_536) == (1, 20_480, 1)
    with pytest.raises(ValueError):
        circulant_lean_launch(30, 49_152, 65_536)
    for w in (0, 65):
        with pytest.raises(ValueError):
            circulant_lean_launch(w, *H100)


# ---- torch emulation of the kernel


ELEMS_B = 6  # the kernel's kElemsB
H100 = (232_448, 233_472)  # shared memory one block may opt in to, and one SM's


def _thread_order(n, threads, elems):
    """Checks (or variables) in the order the block's threads own them: in
    chunks of elems * threads, thread tid holds chunk + tid + e * threads
    for e < elems; each index below n exactly once."""
    order = [chunk + tid + e * threads for chunk in range(0, n, elems * threads) for tid in range(threads)
             for e in range(elems)]
    order = torch.tensor([i for i in order if i < n])
    assert torch.equal(torch.sort(order).values, torch.arange(n))
    return order


def _pack(ph, neg):
    mag = ph.view(torch.int32) & 0x7FFFFFFF
    return torch.where(neg, mag | SIGN, mag).view(torch.float32)


def _acc_neg(a):
    return a.view(torch.int32) < 0


def _signed(mag, neg):
    return torch.where(neg, -mag, mag)


def _emulate(shifts, max_iter, threads, prior_c=None, prior_i=None, syn=None, errors=None, prior=None, elems=None,
             elems_b=ELEMS_B):
    """The kernel on B frames (a frame's sweeps vectorised over its checks,
    taken in thread order).  Decode: ``prior_c``, ``prior_i``, ``syn``; FER
    step: ``errors`` [B, 2N] and one constant ``prior``.  ``elems``: pass A's
    variables a thread (the launch configuration's on an H100 if None).
    Returns (decisions [B, 2N] int32, conv [B] bool, iters [B] int32)."""
    fer = errors is not None
    f32 = torch.float32
    k = [int(x) for x in shifts]
    w = len(k)
    b, n = (errors.shape[0], errors.shape[1] // 2) if fer else syn.shape
    if elems is None:
        elems = circulant_lean_launch(w, *H100).elems
    tab = _table()
    ld = -(-n // 32) * 32
    var = _thread_order(n, threads, elems)  # the variables of pass A
    chk = _thread_order(n, threads, elems_b)  # the checks of pass B
    setup = _thread_order(n, threads, 1)  # the checks of the set-up sweep
    fwd = [(var + kt) % n for kt in k]  # check (j + k_t) of variable j
    back = [(chk - kt) % n for kt in k]  # variable (i - k_t) of check i

    def look_up(bits):
        return tab[_tab_index(bits)]

    v2c = torch.full((b, w, ld), -1, dtype=torch.int32)  # bf16 bits, stored at the variable; -1: never written
    acc = torch.full((b, n), float("nan"), dtype=f32)
    e = torch.zeros((b, 2 * n), dtype=torch.int32)

    # ---- set-up
    if fer:
        const = torch.tensor(prior, dtype=f32)
        err = errors.to(torch.int32)
        s = err[:, n + setup]
        for kt in k:
            s = s + err[:, (setup - kt) % n]
        syn = torch.zeros((b, n), dtype=torch.int32)
        syn[:, setup] = s & 1
        neg_pc = bool(const < 0)
        v0 = _bf16_bits(const[None])
        ph0, neg_v0 = look_up(v0)[0], bool(_negative(v0))
        phi_pc = _phi(const.abs())
        acc0 = phi_pc.clone()
        for _ in range(w):
            acc0 = acc0 + ph0
        neg0 = neg_pc ^ (neg_v0 and w % 2 == 1)
        ext0 = _phi(torch.clamp(acc0 - ph0, min=1e-9))
        ext_i0 = _phi(torch.clamp(acc0 - phi_pc, min=1e-9))
        e[:] = int(neg_pc)
        pc = const.expand(b, n)
        pi = pc
    else:
        pc, pi = prior_c, prior_i
        syn = syn.to(torch.int32)
        p_i = pi[:, setup]
        ph = _phi(p_i.abs())
        neg = (p_i < 0) ^ syn[:, setup].bool()
        for kt in k:
            v = _bf16_bits(pc[:, (setup - kt) % n])
            ph = ph + look_up(v)
            neg = neg ^ _negative(v)
        acc[:, setup] = _pack(ph, neg)
        e = torch.cat([pc < 0, pi < 0], dim=-1).to(torch.int32)

    active = torch.ones(b, dtype=torch.bool)
    iters = torch.zeros(b, dtype=torch.int32)
    conv = torch.zeros(b, dtype=torch.bool)
    for it in range(max_iter):
        if not active.any():
            break
        first = it == 0
        # ---- pass A over variables: the extrinsics, staged as bf16 bits, and the f32 totals
        s = pc[:, var].clone()
        staged = []
        if first and fer:
            ext_pos = _signed(ext0, torch.tensor(neg0 ^ neg_v0))
            ext_neg = -ext_pos
            bits_pos, bits_neg = _bf16_bits(ext_pos[None])[0], _bf16_bits(ext_neg[None])[0]
            for t in range(w):
                flip = syn[:, fwd[t]].bool()
                staged.append(torch.where(flip, bits_neg, bits_pos))
                s = s + torch.where(flip, ext_neg, ext_pos)
        else:
            if first:
                v_first = _bf16_bits(pc[:, var])
            for t in range(w):
                v = v_first if first else v2c[:, t, var]
                assert (v >= 0).all(), "pass A read a message that was never written"
                a = acc[:, fwd[t]]
                ext = _signed(_phi(torch.clamp(a.abs() - look_up(v), min=1e-9)), _acc_neg(a) ^ _negative(v))
                staged.append(_bf16_bits(ext))
                s = s + ext
        # then the next messages in place, from the complete totals
        new_v2c = torch.full_like(v2c, -1)
        for t in range(w):
            new_v2c[:, t, var] = _bf16_bits(torch.clamp(s - _bf16_value(staged[t]), -_BIG, _BIG))
        assert (new_v2c[:, :, :n] >= 0).all(), "pass A left a message unwritten"
        assert (new_v2c[:, :, n:] == -1).all(), "pass A wrote a row's padding"
        new_e = e.clone()
        new_e[:, var] = (s < 0).to(torch.int32)
        v2c = torch.where(active[:, None, None], new_v2c, v2c)
        e = torch.where(active[:, None], new_e, e)
        # ---- pass B over checks
        sy = syn[:, chk]
        p_i = pi[:, chk]
        phi_i = phi_pc.expand(b, n) if fer else _phi(p_i.abs())
        neg_pi = p_i < 0
        if first and fer:
            ext_i = ext_i0.expand(b, n)
            neg_acc = sy.bool() ^ neg0
        else:
            a = acc[:, chk]
            ext_i = _phi(torch.clamp(a.abs() - phi_i, min=1e-9))
            neg_acc = _acc_neg(a)
        e_i = (p_i + _signed(ext_i, neg_acc ^ neg_pi)) < 0
        parity = e_i.clone()
        ph = phi_i.clone()
        neg = neg_pi ^ sy.bool()
        for t in range(w):
            v = v2c[:, t, back[t]]
            parity = parity ^ e[:, back[t]].bool()
            ph = ph + look_up(v)
            neg = neg ^ _negative(v)
        new_acc = torch.empty_like(acc)
        new_acc[:, chk] = _pack(ph, neg)
        bad = (parity != sy.bool()).any(dim=-1)
        new_e = e.clone()
        new_e[:, n + chk] = e_i.to(torch.int32)
        e = torch.where(active[:, None], new_e, e)
        acc = torch.where(active[:, None], new_acc, acc)
        iters = torch.where(active, it + 1, iters)
        conv = conv | (active & ~bad)
        active = active & bad
    return e, conv, iters


def _layout(n, w):
    return CirculantLayout.from_first_row(random_circulant_first_row(n, w, 5), with_identity=True)


def _syndrome(err, lay):
    return torch.from_numpy(((err @ lay.to_dense().T) % 2).astype(np.int32))


def _assert_same(got, ref):
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


# (threads, elems of pass A, elems of pass B): the kernel's on an H100, and small ones that give n = 128/150
# several chunks and a ragged tail
DEALS = [(LEAN_THREADS, None, ELEMS_B), (32, 2, 3), (8, 3, 1)]


@pytest.mark.parametrize("threads,elems,elems_b", DEALS)
@pytest.mark.parametrize("max_iter", [0, 1, 3, 20])
@pytest.mark.parametrize("n", [128, 150])
def test_emulated_decode_matches_plain(n, max_iter, threads, elems, elems_b):
    """Decode: priors varied per position, some beyond the +-60 clip, some
    under 1e-9, zero and negative; a frame that never converges."""
    w, b, rate = 4, 8, 0.03
    lay = _layout(n, w)
    rng = np.random.RandomState(11)
    err = (rng.rand(b, 2 * n) < rate).astype(np.int32)
    err[0, : n // 3] = 1
    p = np.float32(np.log((1 - rate) / rate))
    pc = (p + rng.uniform(-1, 1, (b, n))).astype(np.float32)
    pc[:, :3] = 69.0
    pc[:, 3] = 1e-12
    pc[:, 4] = 0.0
    pc[:, 5] = -0.75
    pi = np.full((b, n), p, np.float32)
    pi[:, 7] = -2.0
    pi[:, 8] = 80.0
    args = (torch.from_numpy(pc), torch.from_numpy(pi), _syndrome(err, lay))
    got = _emulate(lay.shifts, max_iter, threads, *args, elems=elems, elems_b=elems_b)
    ref = circulant_bp_lean_plain(*args, lay.shifts, max_iter)
    _assert_same(got, ref)
    if max_iter == 20:
        assert not ref[1][0] and ref[1][1:].any() and int(ref[2].min()) < 20


@pytest.mark.parametrize("max_iter", [0, 1, 2, 3, 20])
def test_emulated_decode_matches_plain_on_the_sharp_frames(max_iter):
    """The noisy frames on which bf16 storage changes decisions (B = 32,
    n = 150, w = 4, seed 7, rate 0.07, channel priors varied per position)."""
    n, w, b, seed, rate = 150, 4, 32, 7, 0.07
    lay = _layout(n, w)
    rng = np.random.RandomState(seed)
    err = (rng.rand(b, 2 * n) < rate).astype(np.int32)
    prior = np.float32(np.log((1 - rate) / rate))
    pc = np.full((b, n), prior, np.float32) + rng.uniform(-1, 1, (b, n)).astype(np.float32)
    pi = np.full((b, n), prior, np.float32)
    args = (torch.from_numpy(pc), torch.from_numpy(pi), _syndrome(err, lay))
    _assert_same(_emulate(lay.shifts, max_iter, LEAN_THREADS, *args),
                 circulant_bp_lean_plain(*args, lay.shifts, max_iter))


@pytest.mark.parametrize("threads,elems,elems_b", DEALS[:2])
@pytest.mark.parametrize("max_iter", [0, 1, 3, 20])
@pytest.mark.parametrize("n,w,rate", [(128, 4, 0.02), (150, 4, 0.04), (150, 5, 0.07), (128, 5, 0.7)])
def test_emulated_fer_step_matches_plain(n, w, rate, max_iter, threads, elems, elems_b):
    """FER step: the syndrome of the error bits and the hoisted constants of
    the first iteration; an odd weight and a rate above one half make the
    constant prior's sign count."""
    b = 8
    lay = _layout(n, w)
    err = (np.random.RandomState(6).rand(b, 2 * n) < min(rate, 0.08)).astype(np.uint8)
    err[0, : n // 3] = 1
    errors = torch.from_numpy(err)
    prior = float(np.log((1 - rate) / rate))
    e, conv, iters = _emulate(lay.shifts, max_iter, threads, errors=errors, prior=prior, elems=elems,
                              elems_b=elems_b)
    ok = (e == errors.to(torch.int32)).all(dim=-1)
    ok_p, conv_p = circulant_fer_lean_plain(errors, lay.shifts, rate, max_iter)
    assert torch.equal(ok, ok_p) and torch.equal(conv, conv_p)
    prior_t = torch.full((b, n), prior)
    ref = circulant_bp_lean_plain(prior_t, prior_t, _syndrome(err.astype(np.int32), lay), lay.shifts, max_iter)
    _assert_same((e, conv, iters), ref)
    if max_iter == 20 and rate < 0.05:
        assert ok[1:].any() and not ok[0]
