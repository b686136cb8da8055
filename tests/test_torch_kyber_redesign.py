"""The Hopper form of the Kyber decode kernel K7 (``csrc/qary_min_sum.cu``
``qary_special_min_sum_fused``), on the CPU: its launch configuration and a
torch emulation of its check update held against the min-plus chain.

The launch configuration (``special_fused_launch``) is read at the H100's
limits: 232,448 B of shared memory a block may opt in to, 233,472 B an SM.

The emulation follows the kernel's row update (``special_check``): step t of
the prefix chain and step t of the suffix chain in one pass, a lane on each
(chain, output), each output by ``conv_out`` (``conv_warp``'s arithmetic for
one output); the combine convolutions by ``conv_warp`` (whose term sets K5's
tests already hold; ``minplus.conv`` here), all slots' outputs kept side by
side; then every slot's extra-operand convolution in one pass, a lane on each
(slot, output), each lane walking the extra operand's whole term window.  The
tests show that every (chain, output) and (slot, output) has one lane, that
each lane's terms are exactly ``minplus.conv``'s, and that the emulated update
equals ``chain_exclusive`` with ``extra`` bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sca_ldpc_tpu.ops import minplus as jminplus
from sca_ldpc_tpu_torch.codes import make_qary_qc_parity_check_matrix
from sca_ldpc_tpu_torch.models.kyber import gen_ldpc_matrix
from sca_ldpc_tpu_torch.ops import minplus
from sca_ldpc_tpu_torch.ops.kernels.qary_cuda import (
    SPECIAL_SM_WARPS,
    SPECIAL_WARPS,
    special_fused_launch,
    special_fused_smem_bytes,
    special_warp_floats,
)
from sca_ldpc_tpu_torch.ops.qary_special import special_index_arrays
from sca_ldpc_tpu_torch.utils import make_random_state

torch.set_num_threads(1)

H100 = (232448, 233472)  # shared memory a block may opt in to, an SM's
LANES = 32


def _irregular(deg0=2, seed=17, n_b=12, r=6, sw=3):
    """tests/test_torch_cuda_kyber.py's small irregular code."""
    rng = make_random_state(seed)
    H = np.zeros((r, n_b + r), np.int8)
    for i in range(r):
        deg = deg0 if i == 0 else sw
        H[i, rng.choice(n_b, deg, replace=False)] = rng.choice([-1, 1], deg)
    H[np.arange(r), n_b + rng.permutation(r)] = rng.choice([-1, 1], r)
    return H


def _shape(H):
    """(NB, R, SW) of a [H'|I] code as the decoder lays it out."""
    arrays, _ = special_index_arrays(H)
    return H.shape[1] - H.shape[0], H.shape[0], arrays[0].shape[1]


# ---- launch configuration


def test_shared_memory_count():
    """A block holds the frame's v2c [R, SW, QB] and B totals [NB, QB]
    (76,800 B at Kyber-768, eta = 2; 107,520 B at eta = 3), then a slice a
    warp: the row's sum channel [QS], the prefix and suffix partials and the
    SW combine outputs [SW, 2 (B + BSUM) + 1] (331 floats at eta = 2, 487
    at eta = 3; the form before kept one combine output: 186 and 272)."""
    assert special_warp_floats(6, 2, 12) == 25 + 2 * 66 + 6 * 29 == 331
    assert special_warp_floats(6, 3, 18) == 37 + 2 * 96 + 6 * 43 == 487
    assert special_fused_smem_bytes(768, 512, 6, 2, 12, 32) == 76800 + 32 * 4 * 331
    assert special_fused_smem_bytes(768, 512, 6, 3, 18, 32) == 107520 + 32 * 4 * 487


@pytest.mark.parametrize("eta,expected", [(2, (32, 1, 119168)), (3, (32, 1, 169856))])
def test_launch_at_kyber768(eta, expected):
    """DecoderN1280R512SW6: one block of 32 warps an SM at eta 2 and 3 (the
    8-warp form before held 16 and 8 warps an SM)."""
    H = gen_ldpc_matrix(6, 0, check_blocks=2)
    n_b, r, sw = _shape(H)
    cfg = special_fused_launch(n_b, r, sw, eta, sw * eta, *H100)
    assert (n_b, r, sw) == (768, 512, 6)
    assert tuple(cfg) == expected
    assert cfg.blocks_per_sm * (cfg.smem_bytes + H100[1] - H100[0]) <= H100[1]


@pytest.mark.parametrize("code", ["irregular", "signed_identity", "block16"])
@pytest.mark.parametrize("eta", [2, 3])
def test_launch_at_the_small_codes(code, eta):
    """The card tests' small codes take the instance with the most warps,
    one block an SM by registers."""
    H = {"irregular": _irregular(), "signed_identity": _irregular(deg0=3, seed=18),
         "block16": make_qary_qc_parity_check_matrix(16, 6, 3, make_random_state(5), check_blocks=2)}[code]
    n_b, r, sw = _shape(H)
    cfg = special_fused_launch(n_b, r, sw, eta, sw * eta, *H100)
    assert (cfg.warps, cfg.blocks_per_sm) == (32, 1)
    assert cfg.smem_bytes == special_fused_smem_bytes(n_b, r, sw, eta, sw * eta, cfg.warps)


def test_launch_falls_back_and_raises():
    """A frame that fits only smaller blocks gets them; one that fits no
    block raises (the decoder then takes backend "chain")."""
    assert tuple(special_fused_launch(768, 1024, 6, 3, 18, *H100)) == (16, 1, 224704)  # 4 check blocks
    assert tuple(special_fused_launch(768, 1100, 6, 3, 18, *H100)) == (8, 1, 221888)
    with pytest.raises(ValueError, match="shared memory"):
        special_fused_launch(768, 1280, 6, 3, 18, *H100)  # 5 check blocks
    # a card with less shared memory a block (166,912 B; 167,936 an SM) runs eta = 3 in blocks of 16 warps
    assert tuple(special_fused_launch(768, 512, 6, 2, 12, 166912, 167936)) == (32, 1, 119168)
    assert tuple(special_fused_launch(768, 512, 6, 3, 18, 166912, 167936)) == (16, 1, 138688)


def test_instances_reach_the_registers_warps():
    """Each instance's blocks, when they fit, make the 32 warps an SM that 64
    registers a thread allow; larger blocks first."""
    assert SPECIAL_WARPS == tuple(sorted(SPECIAL_WARPS, reverse=True))
    assert all(SPECIAL_SM_WARPS % w == 0 for w in SPECIAL_WARPS)
    assert SPECIAL_SM_WARPS * 32 * 64 == 65536


# ---- the check update's emulation


def _cap(count, sw, b, s_pre, s_mid):
    return min(count * b, s_pre + (sw - 1 - count) * b, s_mid)


def _chain_lanes(sw, b, s_pre, s_mid):
    """The kernel's prefix/suffix passes: [step t][lane] -> the (chain,
    output) pairs it computes, chain 0 the prefix and 1 the suffix."""
    out = []
    for t in range(sw - 1):
        w = 2 * _cap(t + 1, sw, b, s_pre, s_mid) + 1
        out.append([[divmod(p, w) for p in range(lane, 2 * w, LANES)] for lane in range(LANES)])
    return out


def _extra_lanes(sw, qb):
    """The kernel's extra pass: lane -> the (slot, output) pairs it computes."""
    return [[divmod(p, qb) for p in range(lane, sw * qb, LANES)] for lane in range(LANES)]


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


def _conv_out_terms(sa, ha, sb, hb, s_out, k):
    """The kernel's conv_out(a, sa, ha, b, sb, hb, s_out, k) terms, {(k, a
    index, b index)}: a b index outside b as None (the kernel adds BIG)."""
    ha, hb = min(ha, sa), min(hb, sb)
    swap = hb < ha
    if swap:
        sa, sb, ha, hb = sb, sa, hb, ha
    terms = set()
    for i in range(sa - ha, sa + ha + 1):
        j = sa + sb - s_out - i + k
        jb = j if 0 <= j < 2 * sb + 1 else None
        terms.add((k, jb, i) if swap else (k, i, jb))
    return terms


def _conv_out(a, sa, ha, b, sb, hb, s_out, k):
    """conv_out on [..., W] operands: the min over its terms, then min with BIG."""
    ha, hb = min(ha, sa), min(hb, sb)
    if hb < ha:
        a, b, sa, sb, ha, hb = b, a, sb, sa, hb, ha
    acc = torch.full(a.shape[:-1], float("inf"))
    for i in range(sa - ha, sa + ha + 1):
        j = sa + sb - s_out - i + k
        bv = b[..., j] if 0 <= j < 2 * sb + 1 else torch.full(a.shape[:-1], minplus.BIG)
        acc = torch.minimum(acc, a[..., i] + bv)
    return torch.clamp_max(acc, minplus.BIG)


def _emulate(alphas, extra, s_mid, b, bsum):
    """The kernel's row update for every row: [..., SW, QB] operands and
    [..., QS] extra -> [..., SW, QB] c2v (reversed), float32."""
    sw = alphas.shape[-2]
    qb = 2 * b + 1
    s_pre = b + bsum
    rows = alphas.shape[:-2]
    chains = ([torch.zeros(rows + (1,))], [torch.zeros(rows + (1,))])  # prefix, suffix by count
    for t, lanes in enumerate(_chain_lanes(sw, b, s_pre, s_mid)):
        ct, cn = _cap(t, sw, b, s_pre, s_mid), _cap(t + 1, sw, b, s_pre, s_mid)
        nxt = (torch.empty(rows + (2 * cn + 1,)), torch.empty(rows + (2 * cn + 1,)))
        for pairs in lanes:
            for c, k in pairs:
                operand = alphas[..., sw - 1 - t if c else t, :]
                nxt[c][..., k] = _conv_out(operand, b, b, chains[c][t], ct, t * b, cn, k)
        for c in (0, 1):
            chains[c].append(nxt[c])
    pre, suf = chains
    tmp = [minplus.conv(pre[j], suf[sw - 1 - j], s_pre, a_half_support=j * b, b_half_support=(sw - 1 - j) * b)
           for j in range(sw)]  # every slot's combine output, side by side
    out = torch.empty(alphas.shape, dtype=torch.float32)
    for pairs in _extra_lanes(sw, qb):
        for j, k in pairs:
            acc = torch.full(rows, float("inf"))
            for i in range(2 * bsum + 1):  # the lane's whole window
                acc = torch.minimum(acc, extra[..., i] + tmp[j][..., 2 * bsum + k - i])
            out[..., j, qb - 1 - k] = torch.clamp_max(acc, minplus.BIG)
    return out


# (SW, B): Kyber-768 at eta = 2 and 3, the small irregular codes (SW = 3), block16 (SW = 6)
SHAPES = [(6, 2), (6, 3), (3, 2), (3, 3)]


@pytest.mark.parametrize("sw,b", SHAPES)
def test_chain_lanes_cover_minplus_terms_exactly(sw, b):
    """Each prefix/suffix step's (chain, output) pairs have one lane each,
    and conv_out's terms for every output are minplus.conv's for that step
    (chain_exclusive's prefix(j+1) = conv(alpha_j, prefix(j), cap(j+1),
    b_half=j b), the suffix alike)."""
    s_pre, s_mid = b + sw * b, (2 * sw - 1) * b
    for t, lanes in enumerate(_chain_lanes(sw, b, s_pre, s_mid)):
        ct, cn = _cap(t, sw, b, s_pre, s_mid), _cap(t + 1, sw, b, s_pre, s_mid)
        pairs = sorted(p for lane in lanes for p in lane)
        assert pairs == [(c, k) for c in (0, 1) for k in range(2 * cn + 1)]
        got = set().union(*(_conv_out_terms(b, b, ct, t * b, cn, k) for k in range(2 * cn + 1)))
        assert got == _conv_terms(b, b, ct, min(t * b, ct), cn)


@pytest.mark.parametrize("sw,b", SHAPES)
def test_extra_lanes_cover_minplus_terms_exactly(sw, b):
    """Every (slot, output) pair has one lane, and that lane's terms are
    minplus.conv(extra, e, s_out, se, s_pre)'s, none of them out of e's
    support."""
    bsum, qb = sw * b, 2 * b + 1
    s_pre = b + bsum
    pairs = [p for lane in _extra_lanes(sw, qb) for p in lane]
    assert sorted(pairs) == [(j, k) for j in range(sw) for k in range(qb)]
    want = _conv_terms(bsum, bsum, s_pre, s_pre, b)
    for j in range(sw):
        got = {(k, i, 2 * bsum + k - i) for jj, k in pairs if jj == j for i in range(2 * bsum + 1)}
        assert got == want
    assert all(jb is not None for _, _, jb in want)


@pytest.mark.parametrize("sw,b", SHAPES)
def test_emulated_update_equals_chain_exclusive(sw, b):
    """Random operands with BIG entries, pad slots (the delta identity) and
    a random extra: the emulated c2v equals chain_exclusive's, reversed, bit
    for bit, and the port's chain_exclusive equals the JAX package's."""
    bsum, qb = sw * b, 2 * b + 1
    s_mid = (2 * sw - 1) * b
    rng = np.random.RandomState(100 * sw + b)
    alphas = (rng.rand(64, sw, qb) * 30).astype(np.float32)
    alphas[rng.rand(*alphas.shape) < 0.15] = minplus.BIG
    pad = rng.rand(64, sw) < 0.2
    alphas[pad] = minplus.BIG
    alphas[pad, b] = 0.0
    extra = (rng.rand(64, 2 * bsum + 1) * 40).astype(np.float32)
    extra[rng.rand(*extra.shape) < 0.1] = minplus.BIG
    a_t, e_t = torch.from_numpy(alphas), torch.from_numpy(extra)
    ref = minplus.chain_exclusive(a_t, s_mid, extra=e_t, s_out=b)
    got = _emulate(a_t, e_t, s_mid, b, bsum)
    assert torch.equal(got.flip(-1).view(torch.int32), ref.view(torch.int32))
    jref = np.asarray(jminplus.chain_exclusive(jnp.asarray(alphas), s_mid, extra=jnp.asarray(extra), s_out=b))
    np.testing.assert_array_equal(ref.numpy().view(np.uint32), jref.view(np.uint32))
