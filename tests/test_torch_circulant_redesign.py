"""The host side of the Hopper form of K1/K2 (``csrc/circulant_bp.cu``), on
the CPU: its launch configuration, a torch emulation of its index arithmetic
held against the plain version, and the bounds ``chip_smoke.py`` reports.

The emulation follows the kernel step by step on flat per-frame buffers: the
c2v planes at the padded stride ``ld`` (padding left unwritten), tot where
the shared-memory placement keeps it (after the shifts), each sweep's
checks or variables dealt out to threads as ``i = tid + k * threads``,
messages gathered at ``(i - k_t) mod N`` and scattered back at
``(j + k_t) mod N``, a message's sign in its float's sign bit, sums in plane
order, the FER step's hoisted first iteration, per-frame early exit, and the
circulant decisions read from tot at the end.
"""

import numpy as np
import pytest
import torch

from sca_ldpc_tpu_torch.codes import CirculantLayout, random_circulant_first_row
from sca_ldpc_tpu_torch.ops import minplus
from sca_ldpc_tpu_torch.ops.circulant_bp import MIN_SUM_ALPHA, _BIG, _phi
from sca_ldpc_tpu_torch.ops.kernels.bounds import chain_bound_ms, chain_pairs, circulant_bound_ms
from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import (
    circulant_bp_plain,
    circulant_fer_plain,
    circulant_launch,
)

torch.set_num_threads(1)

METHODS = ["product_sum", "min_sum"]
HQC = {"HQC-128": 17669, "HQC-192": 35851, "HQC-256": 57637}
# an H100's shared memory: what one block may opt in to, and one SM's (of
# which CUDA reserves the difference, 1 KB, for each resident block)
SMEM_BLOCK, SMEM_SM = 232_448, 233_472
H100 = (SMEM_BLOCK, SMEM_SM)


# ---- launch configuration


@pytest.mark.parametrize("w", [20, 30])
@pytest.mark.parametrize("name", sorted(HQC))
def test_hqc_sizes_keep_tot_in_shared_memory(name, w):
    n = HQC[name]
    cfg = circulant_launch(n, w, *H100)
    assert cfg.placement == "shared"
    assert cfg.smem_bytes == 4 * 32 + 4 * n <= SMEM_BLOCK
    assert cfg.blocks_per_sm * (cfg.smem_bytes + 1024) <= SMEM_SM
    # 2 x 512 threads where two blocks' shared memory fits (HQC-128), else 1 x 1024
    assert (cfg.blocks_per_sm, cfg.threads) == ((2, 512) if name == "HQC-128" else (1, 1024))
    assert cfg.blocks_per_sm * cfg.threads // 32 == 32
    assert cfg.ld % 32 == 0 and n <= cfg.ld < n + 32


@pytest.mark.parametrize("n,w,placement", [(65003, 4, "device"), (58080, 30, "shared"), (58081, 30, "device"),
                                           (58080, 64, "device"), (58048, 64, "shared")])
def test_placement_switches_at_the_shared_memory_cap(n, w, placement):
    """The shifts take w rounded up to 32 ints, so the cap on N is 58,080
    for w <= 32 and 58,048 above; beyond it tot goes to device memory and two
    blocks of 512 threads share an SM."""
    cfg = circulant_launch(n, w, *H100)
    assert cfg.placement == placement
    shifts_bytes = 4 * (32 if w <= 32 else 64)
    if placement == "device":
        assert (cfg.smem_bytes, cfg.threads, cfg.blocks_per_sm) == (shifts_bytes, 512, 2)
    else:
        assert cfg.smem_bytes == shifts_bytes + 4 * n
    assert cfg.ld % 32 == 0 and n <= cfg.ld < n + 32


def test_placement_follows_the_device_limits():
    """A device with less shared memory a block (an A100's 166,912 B) moves
    the cap on N; the same N keeps tot in shared memory on an H100."""
    a100 = (166_912, 167_936)
    assert circulant_launch(35851, 30, *a100).placement == "shared"
    cfg = circulant_launch(57637, 30, *a100)
    assert (cfg.placement, cfg.threads) == ("device", 512)
    assert circulant_launch(57637, 30, *H100).placement == "shared"


@pytest.mark.parametrize("name, w, slotted, budget", [("HQC-128", 20, 16, 44_908), ("HQC-128", 30, 11, 44_908),
                                                     ("HQC-192", 30, 23, 88_916), ("HQC-192", 20, 32, 88_916)])
def test_hqc128_and_hqc192_stage_the_planes_within_their_budget(name, w, slotted, budget):
    """What two blocks of 512 (HQC-128) or one of 1024 (HQC-192) leave of an
    SM's shared memory beside their totals holds, from the next 16-byte line,
    a slot of a tile's w plane rows (128 B each) and an 8-byte mbarrier for
    each slotted warp, then two tile counters: every warp at w = 20, 11 of 16
    and 23 of 32 at w = 30.  The blocks an SM and smem_bytes are those of the
    unstaged form."""
    n = HQC[name]
    cfg = circulant_launch(n, w, *H100)
    assert (cfg.placement, cfg.stage_warps) == ("shared", slotted) and 2 * slotted >= cfg.threads // 32
    assert cfg.smem_bytes == 4 * 32 + 4 * n
    assert (cfg.blocks_per_sm, cfg.threads) == ((2, 512) if name == "HQC-128" else (1, 1024))
    assert budget == SMEM_SM // cfg.blocks_per_sm - 1024 - cfg.smem_bytes
    assert cfg.stage_bytes == -cfg.smem_bytes % 16 + slotted * (128 * w + 8) + 8 <= budget
    assert budget - cfg.stage_bytes < 128 * w + 8 or slotted == cfg.threads // 32  # no room for one more slot
    assert cfg.smem_bytes + cfg.stage_bytes <= SMEM_BLOCK
    assert cfg.blocks_per_sm * (cfg.smem_bytes + cfg.stage_bytes + 1024) <= SMEM_SM
    # a tile's rows [32 k, 32 k + 32) stay inside a plane row of ld floats
    assert cfg.ld == 32 * -(-n // 32)


@pytest.mark.parametrize("n,w", [(57637, 30), (57637, 20), (58080, 30), (58081, 30), (65003, 4)])
def test_hqc256_and_the_device_placement_keep_the_planes_in_device_memory(n, w):
    """HQC-256's totals leave 1,772 B a block, less than one warp's slot; tot
    in device memory takes the unstaged form whatever is free."""
    cfg = circulant_launch(n, w, *H100)
    assert (cfg.stage_warps, cfg.stage_bytes) == (0, 0)
    if n == 57637:
        assert cfg.placement == "shared" and SMEM_BLOCK - cfg.smem_bytes == 1_772


def test_staging_follows_the_device_limits():
    """On an A100's limits (166,912 B a block, 167,936 an SM) HQC-128 and
    HQC-192 keep tot in shared memory but leave room for the slots of 4 of 16
    and 6 of 32 warps, under half: not staged; on an H100 both are."""
    a100 = (166_912, 167_936)
    for n, w in ((17669, 20), (35851, 30)):
        cfg = circulant_launch(n, w, *a100)
        assert cfg.placement == "shared" and (cfg.stage_warps, cfg.stage_bytes) == (0, 0)
        assert circulant_launch(n, w, *H100).stage_warps > 0
    assert circulant_launch(57637, 30, *a100).stage_warps == 0


def test_launch_config_rejects_bad_sizes():
    for n, w in ((0, 4), (128, 0), (128, 65)):
        with pytest.raises(ValueError):
            circulant_launch(n, w, *H100)


# ---- torch emulation of the kernel


def _thread_order(n, threads):
    """Checks (or variables) in the order the block's threads own them:
    thread tid takes tid, tid + threads, ...; each index exactly once."""
    order = torch.cat([torch.arange(tid, n, threads) for tid in range(min(threads, n))])
    assert torch.equal(torch.sort(order).values, torch.arange(n))
    return order


def _with_sign(x, neg):
    return torch.where(neg, -x.abs(), x.abs())


def _emulate(syn, shifts, max_iter, method, with_identity, threads, prior_c=None, prior_i=None, prior=None):
    """The kernel on B frames (a frame's sweeps vectorised over its checks,
    taken in thread order).  Decode API: per-position priors ``prior_c`` /
    ``prior_i``; FER step: one constant ``prior``.  Returns (decisions [B, 2N]
    or [B, N] int32, conv [B] bool, iters [B] int32, c2v [B, w * ld])."""
    b, n = syn.shape
    w = len(shifts)
    cfg = circulant_launch(n, w, *H100)
    ld, pad = cfg.ld, 32 * -(-w // 32)
    uniform = prior_c is None
    ms = method == "min_sum"
    f32 = torch.float32
    const = torch.tensor(0.0 if prior is None else prior, dtype=f32)
    pc = const.expand(b, n) if uniform else prior_c
    pi = (const.expand(b, n) if uniform else prior_i) if with_identity else torch.zeros((b, n), dtype=f32)
    syn = syn.to(torch.int64)
    k = [int(x) for x in shifts]
    ci = _thread_order(n, threads)  # checks, as the check and syndrome sweeps deal them out
    vj = _thread_order(n, threads)  # variables, as the variable sweep deals them out

    # shared memory of the frame: the shifts (pad ints), then tot
    assert cfg.placement == "device" or 4 * (pad + n) == cfg.smem_bytes
    smem = torch.full((b, pad + n), float("nan"), dtype=f32)
    tot = smem[:, pad:]
    c2v = torch.full((b, w * ld), float("nan"), dtype=f32)
    tot[:] = pc  # set-up: tot is the prior, the identity decisions its hard decisions
    dec_i = (pi < 0).to(torch.int64)
    m_i_const = const.abs() if ms else _phi(const.abs())
    first_ext = torch.tensor(0.0, dtype=f32)
    if uniform:
        if ms:
            first_ext = MIN_SUM_ALPHA * torch.clamp(const.abs(), max=_BIG)
        else:
            acc = torch.tensor(0.0, dtype=f32)
            for _ in range(w + 1):
                acc = acc + m_i_const
            first_ext = _phi(torch.clamp(acc - m_i_const.abs(), min=1e-9))
    first_flip = int(bool(const < 0)) & w

    active = torch.ones(b, dtype=torch.bool)
    iters = torch.zeros(b, dtype=torch.int32)
    for it in range(max_iter):
        if not active.any():
            break
        first = it == 0
        new_c2v, new_dec_i = c2v.clone(), dec_i.clone()
        # ---- check sweep
        if first and uniform:
            ext = torch.where(((syn[:, ci] ^ first_flip) & 1).bool(), -first_ext, first_ext)
            for t in range(w):
                new_c2v[:, t * ld + ci] = ext
            new_dec_i[:, ci] = (const + ext < 0).to(torch.int64)
        else:
            p_i = pi[:, ci]
            neg_i = p_i < 0
            parity = (syn[:, ci] ^ neg_i.to(torch.int64)).bool()
            acc = torch.zeros((b, n), dtype=f32)
            min1 = torch.full((b, n), float("inf"), dtype=f32)
            min2 = min1.clone()
            cnt = torch.zeros((b, n), dtype=torch.int64)
            m = []

            def take(mag, min1, min2, cnt):
                lt, eq = mag < min1, mag == min1
                return (torch.where(lt, mag, min1), torch.where(lt, min1, torch.where(eq, min2, torch.minimum(min2, mag))),
                        torch.where(lt, 1, torch.where(eq, cnt + 1, cnt)))

            for t in range(w):
                j = ci - k[t]
                j = j + n * (j < 0)
                tj = tot[:, j]
                v = tj if first else torch.clamp(tj - c2v[:, t * ld + ci], -_BIG, _BIG)
                ng = v < 0
                parity = parity ^ ng
                mag = v.abs()
                if ms:
                    min1, min2, cnt = take(mag, min1, min2, cnt)
                    m.append(_with_sign(mag, ng))
                else:
                    pm = _phi(mag)
                    acc = acc + pm
                    m.append(_with_sign(pm, ng))
            if with_identity:
                m_i = (p_i.abs() if ms else _phi(p_i.abs())) if not uniform else m_i_const.expand(b, n)
                if ms:
                    min1, min2, cnt = take(m_i, min1, min2, cnt)
                else:
                    acc = acc + m_i
            for t in range(w):
                mt = m[t].abs()
                if ms:
                    ext = MIN_SUM_ALPHA * torch.clamp(torch.where((mt == min1) & (cnt == 1), min2, min1), max=_BIG)
                else:
                    ext = _phi(torch.clamp(acc - mt, min=1e-9))
                new_c2v[:, t * ld + ci] = torch.where(parity ^ torch.signbit(m[t]), -ext, ext)
            if with_identity:
                if ms:
                    ext_i = MIN_SUM_ALPHA * torch.clamp(torch.where((m_i == min1) & (cnt == 1), min2, min1), max=_BIG)
                else:
                    ext_i = _phi(torch.clamp(acc - m_i, min=1e-9))
                tot_i = p_i + torch.where(parity ^ neg_i, -ext_i, ext_i)
                new_dec_i[:, ci] = (tot_i < 0).to(torch.int64)
        c2v = torch.where(active[:, None], new_c2v, c2v)
        dec_i = torch.where(active[:, None], new_dec_i, dec_i)
        # ---- variable sweep, in plane order
        s = torch.zeros((b, n), dtype=f32)
        for t in range(w):
            i = vj + k[t]
            i = i - n * (i >= n)
            s = s + c2v[:, t * ld + i]
        new_tot = tot.clone()
        new_tot[:, vj] = pc[:, vj] + s
        tot[:] = torch.where(active[:, None], new_tot, tot)
        # ---- syndrome sweep
        sy = dec_i[:, ci] if with_identity else torch.zeros((b, n), dtype=torch.int64)
        for t in range(w):
            j = ci - k[t]
            j = j + n * (j < 0)
            sy = sy + (tot[:, j] < 0).to(torch.int64)
        bad = ((sy & 1) != syn[:, ci]).any(dim=-1)
        iters = torch.where(active, it + 1, iters)
        active = active & bad
    conv = ~active & (iters > 0)
    dec_c = (tot < 0).to(torch.int32)
    e = torch.cat([dec_c, dec_i.to(torch.int32)], dim=-1) if with_identity else dec_c
    return e, conv, iters, c2v


def _frames(n, w, seed, rate, b=8):
    lay = CirculantLayout.from_first_row(random_circulant_first_row(n, w, 5), with_identity=True)
    rng = np.random.RandomState(seed)
    err = (rng.rand(b, 2 * n) < rate).astype(np.int64)
    err[0, : n // 3] = 1  # a frame that never converges
    e_c = torch.from_numpy(err[:, :n])
    syn_c = sum(torch.roll(e_c, k, dims=-1) for k in lay.shifts) % 2
    return lay, torch.from_numpy(err), syn_c, (syn_c + torch.from_numpy(err[:, n:])) % 2


def _check_planes(c2v, n, ld, w):
    planes = c2v.view(c2v.shape[0], w, ld)
    assert torch.isnan(planes[:, :, n:]).all(), "the padding of a plane row was written"


@pytest.mark.parametrize("threads", [None, 32])
@pytest.mark.parametrize("with_identity", [True, False])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", [128, 150])
def test_emulated_decode_matches_plain(n, method, with_identity, threads):
    """Decode API: priors varied per position (some beyond the clip),
    max_iter 0 and 12, a frame that never converges."""
    w = 4
    lay, err, syn_c, syn = _frames(n, w, 3, 0.02)
    rng = np.random.RandomState(4)
    p = np.float32(np.log(0.98 / 0.02))
    pc = torch.from_numpy((p + rng.uniform(-1, 1, (8, n))).astype(np.float32))
    pc[:, :3] = 69.0
    pi = torch.full((8, n), float(p))
    s = syn if with_identity else syn_c
    nt = threads or circulant_launch(n, w, *H100).threads
    for max_iter in (0, 12):
        e, conv, iters, c2v = _emulate(s, lay.shifts, max_iter, method, with_identity, nt, pc, pi)
        e_p, conv_p, iters_p = circulant_bp_plain(pc, pi, s, lay.shifts, max_iter, method, with_identity)
        assert torch.equal(e, e_p) and torch.equal(conv, conv_p) and torch.equal(iters, iters_p)
        if max_iter:
            _check_planes(c2v, n, circulant_launch(n, w, *H100).ld, w)
            assert not conv[0] and conv[1:].any()


@pytest.mark.parametrize("threads", [None, 32])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n", [128, 150])
def test_emulated_fer_step_matches_plain(n, method, threads):
    """FER step: the syndrome of the error bits, one constant prior (the
    hoisted first iteration), success = decisions equal the errors."""
    w, rate = 4, 0.02
    lay, err, _, syn = _frames(n, w, 6, rate)
    nt = threads or circulant_launch(n, w, *H100).threads
    prior = float(np.log((1 - rate) / rate))
    prior_t = torch.full((8, n), prior)
    for max_iter in (0, 1, 12):
        e, conv, iters, _ = _emulate(syn, lay.shifts, max_iter, method, True, nt, prior=prior)
        ok = (e == err.to(torch.int32)).all(dim=-1)
        ok_p, conv_p = circulant_fer_plain(err.to(torch.uint8), lay.shifts, rate, max_iter, method)
        assert torch.equal(ok, ok_p) and torch.equal(conv, conv_p)
        e_p, _, iters_p = circulant_bp_plain(prior_t, prior_t, syn, lay.shifts, max_iter, method)
        assert torch.equal(e, e_p) and torch.equal(iters, iters_p)
    assert ok[1:].any() and not ok[0]


# ---- bounds


def test_chain_pairs_count_the_chain_loops():
    """chain_pairs equals the terms of every convolution chain_exclusive
    runs whose b-index lies inside b's support (a term outside adds BIG and
    changes no output), counted term by term, at the medium decoder's (Q =
    15 and Q = 3) and the Kyber decoders' shapes: 5,787 of the 6,795 loop
    passes at the medium decoder, 213 of 243 at Q = 3."""
    count = [0, 0]
    conv = minplus.conv

    def counting(a, b, s_out, a_half_support=None, b_half_support=None):
        sa, sb = (a.shape[-1] - 1) // 2, (b.shape[-1] - 1) // 2
        ha = sa if a_half_support is None else min(int(a_half_support), sa)
        hb = sb if b_half_support is None else min(int(b_half_support), sb)
        if hb < ha:
            sa, sb, ha, hb = sb, sa, hb, ha
        for i in range(sa - ha, sa + ha + 1):
            for k in range(2 * s_out + 1):
                count[0] += 0 <= sa + sb - s_out - i + k <= 2 * sb
                count[1] += 1
        return conv(a, b, s_out, a_half_support, b_half_support)

    minplus.conv = counting
    try:
        for d, b, s_mid, s_out, se, loops in ((7, 7, 42, 7, 0, 6795), (7, 1, 6, 1, 0, 243), (6, 2, 22, 2, 12, 2230),
                                              (6, 3, 33, 3, 18, 4606)):
            count[:] = [0, 0]
            extra = torch.rand(1, 2 * se + 1) if se else None
            minplus.chain_exclusive(torch.rand(1, d, 2 * b + 1), s_mid, extra=extra, s_out=s_out)
            assert count[1] == loops
            assert chain_pairs(d, b, s_mid, s_out, se) == count[0] < loops
        assert chain_pairs(7, 7, 42, 7) == 5787 and chain_pairs(7, 1, 6, 1) == 213
    finally:
        minplus.conv = conv


def test_circulant_bound_at_hqc128():
    """4096 frames of 2.796 iterations, (20 + 1) x 17,669 messages each, 4
    transcendentals a message on 132 x 16 SFU lanes at 1.98 GHz: about
    4 ms, against 0.04 ms for the bytes in and out."""
    ms, by = circulant_bound_ms(round(4096 * 2.796), 20, 17669, 4096 * 2 * 17669 + 2 * 4096)
    assert by == "operations" and 4.0 < ms < 4.1


def test_chain_bound_counts_two_instructions_a_pair():
    """An add and a min are one FP32 instruction each, 128 a clock on each of
    132 SMs at 1.98 GHz: 10^9 pairs take 2e9 / 33.45e12 s, about 0.06 ms,
    when no bytes bind."""
    ms, by = chain_bound_ms(1, 2, 1, 1, 1, 0, 0)
    pairs = chain_pairs(2, 1, 1, 1, 0)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 2 * pairs / (132 * 128 * 1.98e9))
    ms, by = chain_bound_ms(10**9 // pairs, 2, 1, 1, 1, 0, 0)
    assert 0.0597 < ms < 0.0598
