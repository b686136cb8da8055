"""The Hopper form of the q-ary decode kernel K6 (``csrc/qary_min_sum.cu``
``qary_min_sum_fused``), on the CPU: its launch configuration, the check of
its adjacency when ``QaryDecoder`` is built, and a torch emulation of its
check update held against the min-plus chain.

The launch configuration (``fused_launch``) is read at the H100's limits:
232,448 B of shared memory a block may opt in to, 233,472 B an SM.

The emulation follows the kernel's row update (``fused_check``): each chain
lives in one buffer with every partial between BIG guards of 2B floats (the
kernel's ``fused_partial_offset``), so no term tests its index; step t of the
prefix chain and step t of the suffix chain run in one pass, a lane on each
(chain, output), the chains on alternate lanes; then every slot's combine in passes over (slot, output)
lanes, the slots by falling term window, written reversed as c2v.  The tests
show that every (chain, output) and (slot, output) has one lane, that each
lane's terms are exactly ``minplus.conv``'s (a guard read standing for the
BIG term of an index outside the operand), and that the emulated update
equals ``chain_exclusive`` bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sca_ldpc_tpu.ops import minplus as jminplus
from sca_ldpc_tpu_torch.codes import (
    CodeLayout,
    make_qary_qc_parity_check_matrix,
    make_regular_ldpc_parity_check_matrix_identity,
)
from sca_ldpc_tpu_torch.ops import QaryDecoder, minplus
from sca_ldpc_tpu_torch.ops.kernels import qary_cuda
from sca_ldpc_tpu_torch.ops.kernels.qary_cuda import (
    FUSED_SM_WARPS,
    FUSED_WARPS,
    fused_cap,
    fused_launch,
    fused_partial_offset,
    fused_smem_bytes,
    fused_suffix_offset,
)

torch.set_num_threads(1)

H100 = (232448, 233472)  # shared memory a block may opt in to, an SM's
LANES = 32
TOY = np.array([[1, 1, 1, 1, 0, 0], [0, 0, 1, 1, 0, 1], [1, 0, 0, 1, 1, 0]], np.int8)


def _shape(H):
    """(N, R, DC) of a code as the decoder lays it out."""
    lay = CodeLayout.from_h(H)
    return lay.n, lay.r, lay.dc


def _medium():
    return make_regular_ldpc_parity_check_matrix_identity(300, 150, 3, 6, 1)


# ---- launch configuration


def test_shared_memory_count():
    """A block holds the frame's v2c [R, DC, Q] and totals [N, Q] (90,000 B
    at the medium decoder), each warp's two chain buffers (287 floats each
    at DC = 7, B = 7: the 175 of the capped partials, 1 + 15 + 29 + 43 + 43
    + 29 + 15, and 8 guards of 14; the suffix buffer starts 304 floats in,
    16 modulo 32), and the block's table of 15 ints.  The form before kept
    175 floats a chain and no table: 101,200, 112,400 and 134,800 B at 8,
    16 and 32 warps.  The 4-warp block is smaller than the form before's
    8-warp one."""
    assert fused_partial_offset(7, 7, 7) == 175 + 8 * 14 == 287
    assert fused_suffix_offset(7, 7) == 304 and 304 % 32 == 16
    assert [fused_cap(c, 7, 7) for c in range(7)] == [0, 7, 14, 21, 21, 14, 7]
    for warps, nbytes in ((4, 99516), (8, 108972), (16, 127884), (32, 165708)):
        assert fused_smem_bytes(450, 150, 7, 15, warps) == nbytes == 90000 + warps * 4 * (304 + 287) + 4 * 15
    # B = 1: caps 0, 1, 2, 3, 3, 2, 1, so 31 floats of partials and 8 guards of 2 a chain
    assert fused_partial_offset(7, 7, 1) == 31 + 16 and fused_suffix_offset(7, 1) == 48
    assert fused_smem_bytes(450, 150, 7, 3, 8) == 4 * (3150 + 1350 + 8 * (48 + 47) + 15) == 21100
    assert fused_smem_bytes(450, 150, 7, 3, 4) == 4 * (3150 + 1350 + 4 * (48 + 47) + 15) == 19580


@pytest.mark.parametrize("q,expected", [(15, (32, 1, 165708)), (3, (8, 4, 21100))])
def test_launch_at_the_medium_decoder(q, expected):
    """The medium decoder (Q = 15) and DecoderN450R150V3C7B1 (Q = 3): 32
    warps an SM, as one block at Q = 15 (a block of 16 warps fits only one
    an SM) and as four of 8 at Q = 3 (every instance reaches 32 warps there;
    the smallest block down to 8 warps has the most frames in flight; 4
    warps only where no larger block fits)."""
    n, r, dc = _shape(_medium())
    assert (n, r, dc) == (450, 150, 7)
    cfg = fused_launch(n, r, dc, q, *H100)
    assert tuple(cfg) == expected
    assert cfg.blocks_per_sm * (cfg.smem_bytes + H100[1] - H100[0]) <= H100[1]
    assert cfg.warps * cfg.blocks_per_sm == FUSED_SM_WARPS


@pytest.mark.parametrize("code,b", [("signed_qc", 2), ("toy", 7), ("medium", 1), ("medium", 7)])
def test_launch_at_the_card_test_codes(code, b):
    """tests/test_torch_cuda_qary.py's codes reach the registers' 32 warps
    an SM, in blocks of 8 warps or more."""
    H = {"signed_qc": make_qary_qc_parity_check_matrix(30, 4, 2, np.random.RandomState(3)), "toy": TOY,
         "medium": _medium()}[code]
    n, r, dc = _shape(H)
    cfg = fused_launch(n, r, dc, 2 * b + 1, *H100)
    assert cfg.warps * cfg.blocks_per_sm == FUSED_SM_WARPS and cfg.warps >= 8
    assert cfg.smem_bytes == fused_smem_bytes(n, r, dc, 2 * b + 1, cfg.warps)


def test_launch_where_a_frame_does_not_fit():
    """R = 1500, DC = 7, Q = 15 (the card tests' code that takes "chain"):
    one frame's v2c alone is 630,000 B, so no instance fits and the chooser
    raises, as the decoder's fits() reads it."""
    big = make_regular_ldpc_parity_check_matrix_identity(3000, 1500, 3, 6, 1)
    n, r, dc = _shape(big)
    with pytest.raises(ValueError, match="shared memory"):
        fused_launch(n, r, dc, 15, *H100)


@pytest.mark.parametrize("dc,q,old_max,new_max", [(7, 15, 368, 371), (7, 3, 1920, 1923), (5, 5, 1441, 1439)])
def test_the_boundary_where_a_frame_fits(dc, q, old_max, new_max):
    """Of the codes [H | I] with N = 3R, the largest R whose frame one block
    takes, in the form before (8 warps, a chain's capped partials back to
    back: 101,200 B at the medium decoder) and now (down to 4 warps; the
    chain buffers' guards, the suffix buffers' bank alignment and the table
    cost more a warp).  At DC = 7 (the medium decoder at Q = 15 and its Q =
    3 code) the 4-warp block is smaller than the form before's, so every
    frame it took still goes to "fused" and a few more do.  At the signed QC
    code's DC = 5, B = 2 a 4-warp block is larger: R = 1440 and 1441 moved
    to "chain"."""
    b = (q - 1) // 2

    def old_bytes(r):
        caps = [min(c * b, (dc - c) * b, (dc - 1) * b) for c in range(dc)]
        return 4 * (r * dc * q + 3 * r * q + 8 * 2 * sum(2 * c + 1 for c in caps))

    assert old_bytes(old_max) <= H100[0] < old_bytes(old_max + 1)
    assert dc != 7 or q != 15 or old_bytes(150) == 101200
    for r in range(1, new_max + 1):  # 4 warps only where no block of 8 fits
        warps = fused_launch(3 * r, r, dc, q, *H100).warps
        assert warps in FUSED_WARPS and (warps == 4) == (fused_smem_bytes(3 * r, r, dc, q, 8) > H100[0])
    with pytest.raises(ValueError, match="shared memory"):
        fused_launch(3 * new_max + 3, new_max + 1, dc, q, *H100)
    if dc == 7:
        assert fused_launch(3 * old_max, old_max, dc, q, *H100).warps == 4
    if q == 15:  # R = 270: a block of 32 warps does not fit, one of 16 does (16 warps an SM)
        assert tuple(fused_launch(810, 270, 7, 15, *H100)) == (16, 1, 199884)


def test_instances_reach_the_registers_warps():
    """Each instance's blocks, when they fit, make the 32 warps an SM that 64
    registers a thread allow."""
    assert FUSED_WARPS == tuple(sorted(FUSED_WARPS, reverse=True))
    assert all(FUSED_SM_WARPS % w == 0 for w in FUSED_WARPS)
    assert FUSED_SM_WARPS * 32 * 64 == 65536


# ---- the adjacency, checked once when the decoder is built


def test_decoder_rejects_an_out_of_range_adjacency_when_built():
    """An entry of H outside {-1, 0, +1} gives a chk_sign the kernel cannot
    take: QaryDecoder with backend "fused" raises when it is built, so no
    decode needs the check (a host sync a call on the card)."""
    H = TOY.copy()
    H[1, 5] = 2
    with pytest.raises(ValueError, match="-1, 0 or \\+1"):
        QaryDecoder(H, 7, 3, backend="fused", device="cpu")
    assert QaryDecoder(TOY, 7, 3, backend="fused", device="cpu").backend == "fused"
    assert QaryDecoder(H, 7, 3, backend="plain", device="cpu").backend == "plain"


def test_decoder_calls_the_kernel_without_the_per_call_check(monkeypatch):
    """The decoder's fused calls pass check_adjacency=False; direct calls of
    the wrapper keep the check (its default)."""
    seen = []
    real = qary_cuda.qary_min_sum_fused_cuda

    def spy(*args, **kwargs):
        seen.append(kwargs.get("check_adjacency", True))
        return real(*args, **kwargs)

    monkeypatch.setattr(qary_cuda, "qary_min_sum_fused_cuda", spy)
    dec = QaryDecoder(TOY, 7, 2, backend="fused", device="cpu")
    hard = dec.min_sum_llr(torch.zeros((2, 6, 15)))
    assert hard.shape == (2, 6) and seen == [False]


# ---- the check update's emulation


def _order(d, b):
    """The kernel's table of slots by falling combine window (ties: slot order)."""
    win = [min(fused_cap(j, d, b), fused_cap(d - 1 - j, d, b)) for j in range(d)]
    return sorted(range(d), key=lambda j: (-win[j], j))


def _chain_lanes(d, b):
    """The kernel's prefix/suffix passes: [step t][lane] -> the (chain,
    output) pairs it computes, chain 0 the prefix and 1 the suffix, on
    alternate lanes."""
    out = []
    for t in range(d - 1):
        w = 2 * fused_cap(t + 1, d, b) + 1
        out.append([[(p % 2, p // 2) for p in range(lane, 2 * w, LANES)] for lane in range(LANES)])
    return out


def _combine_lanes(d, b):
    """The kernel's combine passes: lane -> the (slot, output) pairs it computes."""
    q, order = 2 * b + 1, _order(d, b)
    return [[(order[p // q], p % q) for p in range(lane, d * q, LANES)] for lane in range(LANES)]


def _chain_step(t, d, b):
    """Step t as the kernel walks it: (walked operand is the partial,
    window, offset of the b-index at output 0 and term 0 from the partial's
    start or the operand's)."""
    ct, cn = fused_cap(t, d, b), fused_cap(t + 1, d, b)
    return (True, 1, b - cn) if t == 0 else (False, 2 * b + 1, b + ct - cn)


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


def _guarded(j, width):
    """A padded read: inside the partial its index, in a guard None (BIG)."""
    return j if 0 <= j < width else None


# (DC, B): the medium decoder at Q = 15 and Q = 3, the card tests' signed QC code and toy code, one operand
SHAPES = [(7, 7), (7, 1), (5, 2), (4, 7), (1, 2)]


@pytest.mark.parametrize("d,b", SHAPES)
def test_chain_lanes_cover_minplus_terms_exactly(d, b):
    """Each prefix/suffix step's (chain, output) pairs have one lane each,
    and the kernel's terms for every output are minplus.conv's for that
    step (chain_exclusive's prefix(t+1) = conv(alpha_t, prefix(t),
    cap(t+1), b_half=t b), the suffix alike), every padded read inside its
    chain buffer's guards."""
    guard = 2 * b
    for t, lanes in enumerate(_chain_lanes(d, b)):
        ct, cn = fused_cap(t, d, b), fused_cap(t + 1, d, b)
        pairs = sorted(p for lane in lanes for p in lane)
        assert pairs == [(c, k) for c in (0, 1) for k in range(2 * cn + 1)]
        walks_partial, window, off = _chain_step(t, d, b)
        got = set()
        for _, k in pairs:
            for i in range(window):
                j = off + k - i
                if walks_partial:  # (operand index, partial index)
                    assert 0 <= j < 2 * b + 1
                    got.add((k, j, i))
                else:
                    assert -guard <= j < 2 * ct + 1 + guard
                    got.add((k, i, _guarded(j, 2 * ct + 1)))
        assert got == _conv_terms(b, b, ct, min(t * b, ct), cn)


@pytest.mark.parametrize("d,b", SHAPES)
def test_combine_lanes_cover_minplus_terms_exactly(d, b):
    """Every (slot, output) pair has one lane; each slot's terms are
    minplus.conv(prefix j, suffix of d-1-j, b)'s with chain_exclusive's half
    supports; a pass's lanes hold slots of falling window."""
    q, guard = 2 * b + 1, 2 * b
    pairs = [p for lane in _combine_lanes(d, b) for p in lane]
    assert sorted(pairs) == [(j, k) for j in range(d) for k in range(q)]
    windows = [min(fused_cap(j, d, b), fused_cap(d - 1 - j, d, b)) for j in _order(d, b)]
    assert windows == sorted(windows, reverse=True)
    for j in range(d):
        cj, cs = fused_cap(j, d, b), fused_cap(d - 1 - j, d, b)
        swap = cs < cj  # the kernel walks the suffix partial and reads the prefix
        got = set()
        for k in range(q):
            for i in range(2 * min(cj, cs) + 1):
                jb = cj + cs - b + k - i
                assert -guard <= jb < 2 * max(cj, cs) + 1 + guard
                read = _guarded(jb, 2 * max(cj, cs) + 1)
                got.add((k, read, i) if swap else (k, i, read))  # (k, prefix index, suffix index)
        assert got == _conv_terms(cj, min(j * b, cj), cs, min((d - 1 - j) * b, cs), b)


def _emulate(alphas, b):
    """The kernel's row update for every row: [..., D, Q] operands -> [..., D,
    Q] c2v (reversed), float32, from padded chain buffers."""
    d = alphas.shape[-2]
    q = 2 * b + 1
    rows = alphas.shape[:-2]
    pf = fused_partial_offset(d, d, b)
    off = [fused_partial_offset(c, d, b) for c in range(d + 1)]
    chains = [torch.full(rows + (pf,), minplus.BIG), torch.full(rows + (pf,), minplus.BIG)]  # guards
    for c in chains:
        c[..., off[0]] = 0.0  # the partial of 0 operands

    def min_terms(a, a0, window, bb, b0):  # min over i of a[a0 + i] + bb[b0 - i], then min BIG
        acc = torch.full(rows, float("inf"))
        for i in range(window):
            acc = torch.minimum(acc, a[..., a0 + i] + bb[..., b0 - i])
        return torch.clamp_max(acc, minplus.BIG)

    for t, lanes in enumerate(_chain_lanes(d, b)):
        walks_partial, window, shift = _chain_step(t, d, b)
        for pairs in lanes:
            for c, k in pairs:
                x = alphas[..., d - 1 - t if c else t, :]
                part = chains[c]
                if walks_partial:
                    val = min_terms(part, off[0], window, x, shift + k)
                else:
                    val = min_terms(x, 0, window, part, off[t] + shift + k)
                part[..., off[t + 1] + k] = val
    pre, suf = chains
    out = torch.empty(alphas.shape, dtype=torch.float32)
    for pairs in _combine_lanes(d, b):
        for j, k in pairs:
            cj, cs = fused_cap(j, d, b), fused_cap(d - 1 - j, d, b)
            if cs < cj:
                val = min_terms(suf, off[d - 1 - j], 2 * cs + 1, pre, off[j] + cj + cs - b + k)
            else:
                val = min_terms(pre, off[j], 2 * cj + 1, suf, off[d - 1 - j] + cj + cs - b + k)
            out[..., j, q - 1 - k] = val
    return out


@pytest.mark.parametrize("d,b", SHAPES)
def test_emulated_update_equals_chain_exclusive(d, b):
    """Random operands with BIG entries, negative entries (which make the BIG
    terms of out-of-range indices matter) and pad slots (the delta
    identity): the emulated c2v equals chain_exclusive's, reversed and
    capped at BIG as the decode takes it, bit for bit, and the port's
    chain_exclusive equals the JAX package's."""
    q, s_mid = 2 * b + 1, (d - 1) * b
    rng = np.random.RandomState(100 * d + b)
    alphas = (rng.rand(48, d, q) * 30).astype(np.float32)
    alphas[rng.rand(*alphas.shape) < 0.15] = minplus.BIG
    alphas[rng.rand(*alphas.shape) < 0.05] *= -1
    pad = rng.rand(48, d) < 0.2
    alphas[pad] = minplus.BIG
    alphas[pad, b] = 0.0
    a_t = torch.from_numpy(alphas)
    ext = minplus.chain_exclusive(a_t, s_mid, s_out=b)
    ref = torch.clamp_max(ext.flip(-1), minplus.BIG)
    got = _emulate(a_t, b)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    jext = np.asarray(jminplus.chain_exclusive(jnp.asarray(alphas), s_mid, s_out=b))
    np.testing.assert_array_equal(ext.numpy().view(np.uint32), jext.view(np.uint32))
