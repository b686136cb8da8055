"""The Hopper form of the q-ary check-update kernel K5 (``csrc/qary_min_sum.cu``
``qary_chain_exclusive``), on the CPU: its launch configuration, the shapes it
takes, and its lane schedule held against the min-plus chain.

The launch configuration (``chain_launch``) is read at the H100's limits:
232,448 B of shared memory a block may opt in to, 233,472 B an SM.

The schedule (``_schedule``) follows the kernel's ``chain_group`` through the
host's table (``chain_table``), address by address in one check's shared
memory (staged operands, extra operand, outputs, chain region): step t of
the prefix and of the suffix chain in one pass over (check, chain, output)
lanes; every slot's combine over (check, slot, output) lanes, the slots by
falling term window; with the extra operand every slot's extra conv in one
pass.  The tests show that each pass computes every output once, that each
output's terms are exactly ``minplus.conv``'s (a read of a BIG guard standing
for the BIG term of an index outside the operand), and that the emulated
update equals ``chain_exclusive`` bit for bit, as the JAX package's does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sca_ldpc_tpu.ops import minplus as jminplus
from sca_ldpc_tpu_torch.ops import minplus
from sca_ldpc_tpu_torch.ops.kernels.qary_cuda import (
    CHAIN_CHECKS,
    CHAIN_HIDE_WARPS,
    CHAIN_MAX_D,
    CHAIN_PER_WARP_WARPS,
    CHAIN_SM_WARPS,
    ChainLaunch,
    chain_instance,
    chain_launch,
    chain_smem_bytes,
    chain_steps,
    chain_table,
    chain_warp_floats,
)

torch.set_num_threads(1)

H100 = (232448, 233472)  # shared memory a block may opt in to, an SM's
LANES = 32
BIG = minplus.BIG

# (DC, Q, s_mid, s_out, We): the medium decoder's check update, the early-exit FER's (Q = 3), the Kyber chain
# at eta 2 and 3 (the five cells of tools/qary_forms.py --kernels k5)
CELLS = {
    "medium": (7, 15, 42, 7, 0),
    "q3": (7, 3, 6, 1, 0),
    "kyber_eta2": (6, 5, 22, 2, 25),
    "kyber_eta3": (6, 7, 33, 3, 37),
}
# general shapes: the cells, s_out = B + 1 with the extra operand, chain steps that walk the partial (s_mid <
# B) and read the operand beyond its support, Q = 1, one operand, outputs wider than the full support
SHAPES = [*CELLS.values(), (6, 5, 22, 3, 25), (4, 5, 6, 2, 0), (3, 9, 3, 4, 0), (4, 9, 2, 1, 0), (5, 1, 0, 2, 3),
          (5, 7, 4, 6, 5), (1, 5, 3, 9, 7), (2, 11, 1, 0, 0)]


# ---- launch configuration


@pytest.mark.parametrize("cell,expected", [
    ("medium", ChainLaunch(4, 4, 4, 53552)), ("q3", ChainLaunch(4, 4, 8, 10032)),
    ("kyber_eta2", ChainLaunch(4, 4, 5, 41456)), ("kyber_eta3", ChainLaunch(4, 2, 6, 33744)),
])
def test_launch_at_the_cells(cell, expected):
    """Every cell holds at least CHAIN_HIDE_WARPS warps an SM, in blocks of
    4 warps; the checks a warp take the fewest serial term steps a check
    among the instances that do: 4 at Q = 15, Q = 3 and Kyber eta 2 (16, 32
    and 20 warps an SM), 2 at eta 3 (24; 4 would hold 12)."""
    cfg = chain_launch(*CELLS[cell], *H100)
    assert cfg == expected
    assert CHAIN_HIDE_WARPS <= cfg.warps * cfg.blocks_per_sm <= CHAIN_SM_WARPS
    assert cfg.blocks_per_sm * (cfg.smem_bytes + H100[1] - H100[0]) <= H100[1]
    assert cfg.smem_bytes == chain_smem_bytes(*CELLS[cell], cfg.warps, cfg.checks)
    if cell == "kyber_eta3":
        assert chain_instance(*CELLS[cell], 4, 4, *H100).blocks_per_sm * 4 < CHAIN_HIDE_WARPS


def test_serial_term_steps_at_the_cells():
    """The serial term steps a check, against the form before (one check a
    warp, lanes over outputs only, the combine slot by slot: 345, 57 and 222
    at Q = 15, Q = 3 and Kyber eta 2)."""
    steps = {c: [chain_steps(*CELLS[c], k) for k in CHAIN_CHECKS] for c in CELLS}
    assert steps["medium"] == [254, 232.5, 225]
    assert steps["q3"] == [23, 12, 10.25]
    assert steps["kyber_eta2"] == [86, 80, 76.5]
    assert steps["kyber_eta3"][0] < steps["kyber_eta2"][0] * 2.2


def test_shared_memory_count():
    """A medium-decoder check takes its 105 staged operands, 105 outputs and a
    chain region of two buffers of 287 floats (the 175 of the capped
    partials, 1 + 15 + 29 + 43 + 43 + 29 + 15, and 8 guards of 14), the
    suffix buffer 304 floats in (16 modulo 32), padded to 616 (8 modulo 32)
    at 2 checks a warp; the block adds the table."""
    t = chain_table(*CELLS["medium"], 2)
    assert (t.guard, t.suf, t.in_guard) == (14, 304, 0) and t.off[-1] + 2 * t.cap[-1] + 1 + t.guard == 287
    assert t.region == 616 and t.region % 32 == 8
    assert chain_smem_bytes(*CELLS["medium"], 4, 2) == 944 + 4 * 8 * (105 + 105 + 616)
    # Kyber eta 2: guards of 12 (the combine's slot 2 reads the suffix of 3 operands 12 past it), so chain
    # buffers of 66 + 7 * 12 = 150 floats; the six combine outputs of 29 floats at a stride of 37 (5 modulo 32)
    k = chain_table(*CELLS["kyber_eta2"], 2)
    assert (k.guard, k.suf, k.tmp, k.wc, k.tmp_stride) == (12, 176, 176 + 150, 29, 37)


@pytest.mark.parametrize("d", [33, 40])
def test_more_slots_than_the_table_take_the_per_warp_form(d):
    assert d > CHAIN_MAX_D
    cfg = chain_launch(d, 3, d - 1, 1, 0, *H100)
    assert (cfg.warps, cfg.checks) == (CHAIN_PER_WARP_WARPS, 0)
    assert cfg.smem_bytes == 4 * CHAIN_PER_WARP_WARPS * chain_warp_floats(d, 3, d - 1, 1)


def _old_fits(shape):
    """The form before the redesign: 8 checks of chain_warp_floats floats a block."""
    return 4 * 8 * chain_warp_floats(*shape) <= H100[0]


def test_every_shape_the_form_before_took_still_launches():
    """No (DC, Q, s_mid, s_out, We) on the grid that the form before took
    (8 warps' slices within the block's limit) is refused; a shape whose
    staged block does not fit takes the per-warp form, the form before
    itself.  QaryDecoder's shapes (DC <= 32, B <= 15) and the Kyber chain's
    (SW <= 10, eta <= 8) take a staged instance wherever the form before
    fitted; the Kyber chain's at SW >= 12 and eta >= 10 can need the
    per-warp form (its SW combine outputs side by side outgrow a block)."""
    refused, per_warp, shapes = [], [], 0
    for d in range(1, 13):
        for b in range(0, 8):
            q = 2 * b + 1
            for s_mid in sorted({0, max(b - 1, 0), b, (d - 1) * b, (2 * d - 1) * b, 3 * d * b + 5}):
                for s_out in sorted({0, 1, b, b + 1, s_mid, 200}):
                    for we in (0, 1, 3, 2 * d * b + 1, 61):
                        shape = (d, q, s_mid, s_out, we)
                        if not _old_fits(shape):
                            continue
                        shapes += 1
                        try:
                            cfg = chain_launch(*shape, *H100)
                        except ValueError:
                            refused.append(shape)
                            continue
                        if cfg.checks == 0:
                            per_warp.append(shape)
    assert shapes > 10000 and not refused
    assert len(per_warp) < shapes // 10
    decoders = [(d, 2 * b + 1, (d - 1) * b, b, 0) for d in range(1, CHAIN_MAX_D + 1) for b in range(1, 16)]
    decoders += [(d, 2 * b + 1, (2 * d - 1) * b, b, 2 * d * b + 1) for d in range(1, 11) for b in range(1, 9)]
    for shape in decoders:
        if _old_fits(shape):
            assert chain_launch(*shape, *H100).checks > 0, shape


# ---- the lane schedule


def _layout(t):
    """One check's shared memory as the kernel lays it out, in floats: staged
    operands, extra operand, outputs, chain region."""
    w_out = 2 * t.s_out + 1
    ex = t.d * t.in_stride
    ob = ex + t.we
    reg = ob + t.d * w_out
    return ex, ob, reg, reg + t.region


def _schedule(t, checks):
    """The kernel's passes: for each, the lanes' items (lane, check, target
    address, walked address, window, read address at term 0, conv), the
    addresses in one check's memory (``_layout``) and ``conv`` naming the
    minplus.conv whose output the item is: ("pre" | "suf", count, k),
    ("comb", slot, k) or ("extra", slot, k)."""
    d, q, b = t.d, t.q, (t.q - 1) // 2
    ex, ob, reg, _ = _layout(t)
    w_out = 2 * t.s_out + 1
    passes = []
    for s in range(d - 1):
        ct, cn = t.cap[s], t.cap[s + 1]
        items = []
        for p in range(checks * 2 * (2 * cn + 1)):
            g, c, k = p % checks, (p // checks) % 2, p // (2 * checks)
            part = reg + (t.suf if c else 0)
            x = (d - 1 - s if c else s) * t.in_stride + t.in_guard
            po = part + t.off[s]
            a, bb = (po, x) if t.swap[s] else (x, po)
            w = 2 * ct + 1 if t.swap[s] else q
            items.append((p % LANES, g, part + t.off[s + 1] + k, a, w, bb + b + ct - cn + k,
                          ("suf" if c else "pre", s + 1, k)))
        passes.append(items)
    items = []
    for p in range(checks * d * t.wc):
        g, r = p % checks, p // checks
        rank, k = divmod(r, t.wc)
        j = t.slot[rank]
        target = reg + t.tmp + j * t.tmp_stride + k if t.we else ob + j * w_out + k
        items.append((p % LANES, g, target, reg + t.walk[rank], t.terms[rank], reg + t.read[rank] + k, ("comb", j, k)))
    passes.append(items)
    if t.we:
        items = []
        for p in range(checks * d * w_out):
            g, r = p % checks, p // checks
            j, k = divmod(r, w_out)
            items.append((p % LANES, g, ob + r, ex, t.we, reg + t.tmp + j * t.tmp_stride + t.we - 1 + k,
                          ("extra", j, k)))
        passes.append(items)
    return passes


def _what(t, addr):
    """What one check's shared memory holds at ``addr``: ("in", operand,
    symbol), ("ex", symbol), ("pre" | "suf", count, index), ("comb", slot,
    index), or None for a BIG guard; anything else fails."""
    ex, ob, reg, end = _layout(t)
    if 0 <= addr < ex:
        op, i = divmod(addr, t.in_stride)
        i -= t.in_guard
        return ("in", op, i) if 0 <= i < t.q else None
    if ex <= addr < ob:
        return ("ex", addr - ex)
    assert reg <= addr < end, addr
    o = addr - reg
    if o >= t.tmp and t.we:
        j, i = divmod(o - t.tmp, t.tmp_stride)
        assert i < t.wc
        return ("comb", j, i)
    chain = "suf" if o >= t.suf else "pre"
    o -= t.suf if chain == "suf" else 0
    assert 0 <= o < t.off[-1] + 2 * t.cap[-1] + 1 + t.guard, addr
    for c in range(t.d):
        if t.off[c] <= o < t.off[c] + 2 * t.cap[c] + 1:
            return (chain, c, o - t.off[c])
    return None


def _conv_terms(sa, ha, sb, hb, s_out):
    """minplus.conv's terms, {(output k, a index, b index)}, with its operand
    swap and padding: a b index outside b's support (a BIG term) as None."""
    swap = hb < ha
    if swap:
        sa, sb, ha, hb = sb, sa, hb, ha
    off, pad = sa + sb - s_out, max(0, sa + s_out - sb)
    terms = set()
    for k in range(2 * s_out + 1):
        for i in range(sa - ha, sa + ha + 1):
            start = off - i + pad
            jb = start + k - pad if pad <= start + k < pad + 2 * sb + 1 else None
            terms.add((k, jb, i) if swap else (k, i, jb))
    return terms


def _expected_terms(t, conv):
    """The terms chain_exclusive's conv behind ``conv`` takes, as (k, a
    index, b index) over its own operands (a first as chain_exclusive passes
    them)."""
    kind, j, _ = conv
    b, d = (t.q - 1) // 2, t.d
    se = (t.we - 1) // 2 if t.we else 0
    cap = t.cap
    if kind in ("pre", "suf"):  # conv(operand, partial of count j - 1, cap(j), b_half=(j - 1) b)
        return _conv_terms(b, b, cap[j - 1], min((j - 1) * b, cap[j - 1]), cap[j])
    if kind == "comb":  # conv(prefix j, suffix of d-1-j, s_pre, j b, (d-1-j) b)
        cs = cap[d - 1 - j]
        return _conv_terms(cap[j], min(j * b, cap[j]), cs, min((d - 1 - j) * b, cs), t.s_out + se)
    return _conv_terms(se, se, t.s_out + se, t.s_out + se, t.s_out)  # conv(extra, combine j, s_out)


def _operand_index(t, conv, what):
    """A read's index in the conv's own operand ("a" or "b", index), None for
    a guard."""
    if what is None:
        return None
    kind, j, _ = conv
    d = t.d
    if kind in ("pre", "suf"):
        op = j - 1 if kind == "pre" else d - j
        if what[0] == "in":
            assert what[1] == op
            return ("a", what[2])
        assert what[:2] == (kind, j - 1)
        return ("b", what[2])
    if kind == "comb":
        if what[:2] == ("pre", j):
            return ("a", what[2])
        assert what[:2] == ("suf", d - 1 - j), (what, conv)
        return ("b", what[2])
    if what[0] == "ex":
        return ("a", what[1])
    assert what[:2] == ("comb", j)
    return ("b", what[2])


@pytest.mark.parametrize("checks", CHAIN_CHECKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_each_pass_covers_its_outputs_once(shape, checks):
    """Each pass computes every (check, output) of its convs on one lane and
    writes no address twice; the combine's lanes take the slots by falling
    term window."""
    t = chain_table(*shape, checks)
    d, w_out = t.d, 2 * t.s_out + 1
    expected = [{(c, s + 1, k) for c in ("pre", "suf") for k in range(2 * t.cap[s + 1] + 1)} for s in range(d - 1)]
    expected.append({("comb", j, k) for j in range(d) for k in range(t.wc)})
    if t.we:
        expected.append({("extra", j, k) for j in range(d) for k in range(w_out)})
    passes = _schedule(t, checks)
    assert len(passes) == len(expected)
    for items, convs in zip(passes, expected):
        targets = [(g, target) for _, g, target, *_ in items]
        assert len(set(targets)) == len(targets)
        assert sorted((g, conv) for _, g, *_, conv in items) == sorted((g, c) for g in range(checks) for c in convs)
        assert [lane for lane, *_ in items] == [p % LANES for p in range(len(items))]
    assert list(t.terms) == sorted(t.terms, reverse=True)
    assert sorted(t.slot) == list(range(t.d))


@pytest.mark.parametrize("shape", SHAPES)
def test_guarded_reads_are_minplus_terms(shape):
    """Every term an item reads is minplus.conv's term for that output: the
    walked operand inside its support, the read one inside it or on a BIG
    guard of its own buffer exactly where conv's index leaves the operand;
    no term is missing or added."""
    t = chain_table(*shape, 1)
    got = {}
    for items in _schedule(t, 1):
        for _, _, _, a, w, bb, conv in items:
            terms = got.setdefault(conv[:2], set())
            for i in range(w):
                ra = _operand_index(t, conv, _what(t, a + i))
                rb = _operand_index(t, conv, _what(t, bb - i))
                assert ra is not None and ra[0] in "ab"
                # chain_exclusive passes (operand, partial), (prefix, suffix) and (extra, combine) as (a, b)
                pair = {ra[0]: ra[1], ("b" if ra[0] == "a" else "a"): None if rb is None else rb[1]}
                assert rb is None or rb[0] != ra[0]
                terms.add((conv[2], pair["a"], pair["b"]))
    for key, terms in got.items():
        assert terms == _expected_terms(t, (*key, 0)), key


def _emulate(alphas, extra, t, checks):
    """The kernel's update of [n, d, q] operands (and [n, we] extra), by its
    schedule on one check's shared memory a row, in float32."""
    n = alphas.shape[0]
    ex, ob, reg, end = _layout(t)
    mem = torch.full((n, end), float("nan"))
    staged = torch.full((n, t.d, t.in_stride), BIG)
    staged[:, :, t.in_guard:t.in_guard + t.q] = alphas
    mem[:, :ex] = staged.reshape(n, -1)
    if t.we:
        mem[:, ex:ob] = extra
    mem[:, reg:] = BIG
    mem[:, reg + t.off[0]] = 0.0
    mem[:, reg + t.suf + t.off[0]] = 0.0
    for items in _schedule(t, checks):
        vals = []
        for _, _, target, a, w, bb, _ in items:
            acc = torch.full((n,), float("inf"))
            for i in range(w):
                acc = torch.minimum(acc, mem[:, a + i] + mem[:, bb - i])
            vals.append((target, torch.clamp_max(acc, BIG)))
        for target, v in vals:  # a pass reads nothing it writes
            mem[:, target] = v
    return mem[:, ob:reg].reshape(n, t.d, 2 * t.s_out + 1)


def _inputs(shape, seed):
    d, q, _, _, we = shape
    rng = np.random.RandomState(seed)
    alphas = (rng.rand(24, d, q) * 30).astype(np.float32)
    alphas[rng.rand(*alphas.shape) < 0.15] = BIG
    alphas[rng.rand(*alphas.shape) < 0.05] *= -1  # negative entries make the padding terms matter
    extra = (rng.rand(24, we) * 30).astype(np.float32)
    extra[rng.rand(*extra.shape) < 0.1] = BIG
    extra[rng.rand(*extra.shape) < 0.05] *= -1
    return alphas, extra


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_update_equals_chain_exclusive(shape):
    """The emulated update equals the port's chain_exclusive bit for bit, and
    that equals the JAX package's on the same numpy inputs."""
    d, q, s_mid, s_out, we = shape
    alphas, extra = _inputs(shape, sum(shape))
    a_t, e_t = torch.from_numpy(alphas), torch.from_numpy(extra) if we else None
    ref = minplus.chain_exclusive(a_t, s_mid, extra=e_t, s_out=s_out)
    got = _emulate(a_t, e_t, chain_table(*shape, 2), 2)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    jext = np.asarray(jminplus.chain_exclusive(jnp.asarray(alphas), s_mid, extra=jnp.asarray(extra) if we else None,
                                               s_out=s_out))
    np.testing.assert_array_equal(ref.numpy().view(np.uint32), jext.view(np.uint32))
