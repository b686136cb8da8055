"""The benchmark's yardstick against the port on the CPU: the reference decode
against the port's plain decode on small circulant codes, the frozen first-row
draw, the frozen roofline arithmetic and the key's secret."""

import numpy as np
import pytest
import torch

from benchmark import codegen, roofline
from benchmark.reference.attack import decision_stats, masked_inputs
from benchmark.reference.bp import decode, fer_decode, round_bf16
from benchmark.reference.hqc_secret import read_keypair, secret_y
from benchmark.tests.test_bench_layout import ROOT


@pytest.mark.parametrize("n,w,seed,rate", [(128, 4, 1, 0.03), (150, 4, 3, 0.05), (149, 4, 7, 0.07)])
def test_fer_decisions_equal_port_plain(n, w, seed, rate):
    from sca_ldpc_tpu_torch.ops.circulant_bp import _circulant_bp_frames

    shifts = np.flatnonzero(codegen.first_row(n, w, seed)).tolist()
    g = torch.Generator().manual_seed(seed)
    errors = (torch.rand((96, 2 * n), generator=g) < rate).to(torch.uint8)
    e = errors.to(torch.int32)
    syn = (sum(torch.roll(e[:, :n], k, dims=-1) for k in shifts) + e[:, n:]) % 2
    prior = torch.full((96, n), float(np.log((1 - rate) / rate)), dtype=torch.float32)
    e_port, conv_port, it_port = _circulant_bp_frames(prior, prior, syn, tuple(shifts), True, 30, "product_sum")
    e_c, e_i, _c, it_ref = decode(prior, prior[:, None], syn[:, None], [shifts], 30, block=40)
    assert torch.equal(torch.cat([e_c, e_i[:, 0]], dim=-1).to(torch.int32), e_port)
    assert torch.equal(it_ref, it_port)
    ok, conv, iters = fer_decode(errors, shifts, rate, 30, block=33)
    assert torch.equal(ok, torch.all(e_port == e, dim=-1)) and torch.equal(iters, it_port)
    assert torch.equal(conv, conv_port.to(torch.bool))
    assert 0 < int(ok.sum()) < 96 or rate < 0.05  # the comparison sees failing frames at the higher rates


def test_masked_decode_equals_port_plain():
    from sca_ldpc_tpu_torch.ops.kernels import multi_circulant_bp_plain

    n, p, w = 131, 3, 4
    rng = np.random.RandomState(5)
    shifts = [np.flatnonzero(codegen.first_row(n, w, s)).tolist() for s in range(p)]
    rows, checks = [], []
    for blk in range(p):
        for bit in rng.choice(n, size=40, replace=False):
            rows.append((blk, int(bit)))
            checks.append((int(rng.rand() < 0.3), float(rng.choice([0.9942, 1.0, 0.97]))))
    prior_c, prior_i, syn = masked_inputs(rows, checks, n, 9, p, "cpu")
    ref = decode(prior_c, prior_i, syn, shifts, 100)
    port = multi_circulant_bp_plain(prior_c, prior_i, syn, torch.tensor(shifts), 100)
    for a, b in zip(ref, port):
        assert torch.equal(a.to(b.dtype), b)
    y = sorted(rng.choice(n, size=9, replace=False).tolist())
    good, bad, bad_sat, bad_unsat, success = decision_stats(ref[0][0].numpy(), ref[1][0].numpy(), rows, checks, y)
    assert good + bad == int(ref[0][0].sum()) and bad_sat + bad_unsat <= len(rows)
    assert success == (bad == 0 and good == 9)


def test_bf16_store_changes_messages():
    x = torch.tensor([1.0 + 2.0 ** -10, 3.0], dtype=torch.float32)
    assert torch.equal(round_bf16(x), torch.tensor([1.0, 3.0]))


@pytest.mark.parametrize("n,w,seed", [(17669, 20, 0), (57637, 30, 0), (150, 4, 3), (17669, 20, 4242)])
def test_first_row_is_the_ports_draw(n, w, seed):
    from sca_ldpc_tpu_torch.codes import random_circulant_first_row

    assert np.array_equal(codegen.first_row(n, w, seed), random_circulant_first_row(n, w, seed))


@pytest.mark.parametrize("iters,p,w,n,nbytes", [(1_400_000, 1, 20, 17669, 10 ** 6), (100, 1, 20, 17669, 500_000),
                                                 (100, 3, 20, 17669, 10 ** 9), (6144, 1, 30, 57637, 236 * 10 ** 6)])
def test_roofline_is_the_ports_arithmetic(iters, p, w, n, nbytes):
    from sca_ldpc_tpu_torch.ops.kernels import bounds

    assert roofline.circulant_bound_ms(iters, w, n, nbytes) == bounds.circulant_bound_ms(iters, w, n, nbytes)
    assert roofline.multi_circulant_bound_ms(iters, p, w, n, nbytes) == \
        bounds.multi_circulant_bound_ms(iters, p, w, n, nbytes)


def test_roofline_values_at_the_cells():
    # HQC-128: 4096 frames, 1.78 iterations a frame after the first
    ms, binds = roofline.circulant_bound_ms(4096 * 1.78, 20, 17669, 4096 * 4 * 17669)
    assert binds == "operations" and ms == pytest.approx(4 * 7290 * 21 * 17669 / (132 * 16 * 1.98e9) * 1e3)
    # K8: 100 iterations of one block at HQC-128
    ms, binds = roofline.multi_circulant_bound_ms(100, 1, 20, 17669, 4 * 17669 * 5)
    assert binds == "operations" and ms == pytest.approx(0.0355, abs=5e-5)


def test_secret_equals_ports_binding():
    from sca_ldpc_tpu_torch.models.hqc.model import Hqc128

    _pub, sk = read_keypair(ROOT / "benchmark" / "configs" / "hqc128.key")
    ours = secret_y(ROOT / "csrc" / "libhqc_core.so", "128", sk)
    assert ours == sorted(Hqc128.secrets_from_key(sk)[1]) and len(ours) == Hqc128.params("OMEGA")
