"""The CUDA Kyber kernel (K7 qary_special_min_sum_fused_cuda) against its plain
PyTorch version, and the two-alphabet decoder's backends, on the card.
Without a CUDA device every test skips.  This file imports no JAX, so it runs
on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda_kyber.py
"""

import numpy as np
import pytest
import torch

from sca_ldpc_tpu_torch.channels import probs_to_llr
from sca_ldpc_tpu_torch.codes import make_qary_qc_parity_check_matrix
from sca_ldpc_tpu_torch.models.kyber import gen_ldpc_matrix, simulate_kyber_attack
from sca_ldpc_tpu_torch.ops import QarySpecialDecoder, minplus
from sca_ldpc_tpu_torch.ops.kernels import qary_cuda
from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import smem_limits
from sca_ldpc_tpu_torch.ops.kernels.qary_cuda import (
    SPECIAL_WARPS,
    chain_exclusive_cuda,
    fused_ptxas,
    qary_special_min_sum_fused_cuda,
    qary_special_min_sum_fused_plain,
    special_fused_launch,
    special_fused_occupancy,
    special_fused_smem_bytes,
)
from sca_ldpc_tpu_torch.ops.qary import _signed
from sca_ldpc_tpu_torch.utils import make_random_state

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _irregular(deg0=2, seed=17, n_b=12, r=6, sw=3):
    """Row 0 of degree ``deg0``, +-1 entries, a permuted and signed identity."""
    rng = make_random_state(seed)
    H = np.zeros((r, n_b + r), np.int8)
    for i in range(r):
        deg = deg0 if i == 0 else sw
        H[i, rng.choice(n_b, deg, replace=False)] = rng.choice([-1, 1], deg)
    H[np.arange(r), n_b + rng.permutation(r)] = rng.choice([-1, 1], r)
    return H


def _codes():
    return {
        "irregular": (_irregular(), 3),
        "signed_identity": (_irregular(deg0=3, seed=18), 3),
        "block16": (make_qary_qc_parity_check_matrix(16, 6, 3, make_random_state(5), check_blocks=2), 6),
        "kyber768": (gen_ldpc_matrix(6, 0, check_blocks=2), 6),
    }


def _inputs(H, b, bsum, frames, seed, device):
    """Row-ordered, clipped min-sum LLRs of Dirichlet channels (some zero
    probabilities: +inf LLRs, clipped to BIG) and the kernel's adjacency."""
    dec = QarySpecialDecoder(H, b, bsum, 1, backend="plain", device=device)
    r, n = H.shape
    rng = np.random.RandomState(seed)
    pb = rng.dirichlet(np.ones(2 * b + 1), size=(frames, n - r))
    ps = rng.dirichlet(np.ones(2 * bsum + 1), size=(frames, r))
    pb[:, ::7, 0] = 0.0
    ps[:, ::5, -1] = 0.0
    llr_b = minplus.clip_inf(probs_to_llr(torch.tensor(pb, dtype=torch.float32, device=device))).contiguous()
    llr_s = minplus.clip_inf(probs_to_llr(torch.tensor(ps, dtype=torch.float32, device=device)))
    llr_s = llr_s.index_select(1, dec._sum_var).contiguous()
    bvar_idx, bvar_sign, bvar_mask, var_flat, _, _, sum_sign, _ = dec._args
    vsum = _signed(llr_s, sum_sign).contiguous()
    return llr_b, llr_s, vsum, bvar_idx, bvar_sign, bvar_mask, var_flat, sum_sign


# None: the instance special_fused_launch picks; else each instance (warps a block) forced
WARPS = [None, *SPECIAL_WARPS]


@pytest.mark.parametrize("code", ["irregular", "signed_identity", "block16"])
@pytest.mark.parametrize("eta", [2, 3])
@pytest.mark.parametrize("max_iter", [0, 1, 10])
@pytest.mark.parametrize("warps", WARPS)
def test_kernel_decisions_equal_plain_on_small_codes(cuda, code, eta, max_iter, warps):
    H, sw = _codes()[code]
    args = _inputs(H, eta, sw * eta, 37, 5, cuda)
    before = qary_special_min_sum_fused_cuda.launches
    hb, hs = qary_special_min_sum_fused_cuda(*args, eta, sw * eta, max_iter, warps=warps)
    pb, ps = qary_special_min_sum_fused_plain(*args, eta, sw * eta, max_iter)
    torch.cuda.synchronize()
    assert qary_special_min_sum_fused_cuda.launches == before + 1
    assert hb.dtype == hs.dtype == torch.int32
    assert hb.shape == (37, H.shape[1] - H.shape[0]) and hs.shape == (37, H.shape[0])
    assert torch.equal(hb, pb) and torch.equal(hs, ps)


@pytest.mark.parametrize("eta,frames", [(2, 256), (3, 64)])
@pytest.mark.parametrize("warps", WARPS)
def test_kernel_decisions_equal_plain_at_kyber768(cuda, eta, frames, warps):
    """DecoderN1280R512SW6 (NB = 768, R = 512, DV = 4) at eta = 2 and at the
    adaptive path's eta = 3 (QB = 7, QS = 37), 10 iterations."""
    H, sw = _codes()["kyber768"]
    args = _inputs(H, eta, sw * eta, frames, eta, cuda)
    hb, hs = qary_special_min_sum_fused_cuda(*args, eta, sw * eta, 10, warps=warps)
    pb, ps = qary_special_min_sum_fused_plain(*args, eta, sw * eta, 10)
    torch.cuda.synchronize()
    assert torch.equal(hb, pb) and torch.equal(hs, ps)


@pytest.mark.parametrize("code", ["irregular", "block16", "kyber768"])
@pytest.mark.parametrize("eta", [2, 3])
def test_launch_configuration_on_the_card(cuda, code, eta):
    """The chooser's shared-memory count equals the library's for every
    instance; the occupancy calculator holds the chosen instance's blocks
    resident on an SM; ptxas reports every instance."""
    H, sw = _codes()[code]
    r, n_b = H.shape[0], H.shape[1] - H.shape[0]
    for warps in SPECIAL_WARPS:
        assert qary_cuda._lib().qary_special_fused_smem_bytes(n_b, r, sw, eta, sw * eta, warps) == special_fused_smem_bytes(
            n_b, r, sw, eta, sw * eta, warps)
    occ = special_fused_occupancy(n_b, r, sw, eta, sw * eta, cuda)
    assert occ["lib_smem_bytes"] == occ["smem_bytes"]
    assert (occ["warps"], occ["blocks_per_sm"]) == special_fused_launch(n_b, r, sw, eta, sw * eta, *smem_limits(cuda))[:2]
    assert occ["resident_blocks"] >= occ["blocks_per_sm"]
    assert set(fused_ptxas(7)) == set(SPECIAL_WARPS)


def test_forced_launch_is_checked(cuda):
    H, sw = _codes()["block16"]
    args = _inputs(H, 2, 12, 3, 1, cuda)
    before = qary_special_min_sum_fused_cuda.launches
    with pytest.raises(ValueError, match="instances"):
        qary_special_min_sum_fused_cuda(*args, 2, 12, 5, warps=12)
    assert qary_special_min_sum_fused_cuda.launches == before


def test_decoder_backends_on_the_card(cuda):
    H, _ = _codes()["kyber768"]
    dec = QarySpecialDecoder(H, 2, 12, 6, device=cuda)
    assert dec.backend == "fused"
    assert QarySpecialDecoder(H, 2, 12, 6, early_exit=True, device=cuda).backend == "chain"
    rng = np.random.RandomState(3)
    pb = rng.dirichlet(np.ones(5), size=(9, 768)).astype(np.float32)
    ps = rng.dirichlet(np.ones(25), size=(9, 512)).astype(np.float32)
    ref = QarySpecialDecoder(H, 2, 12, 6, backend="plain", device="cpu").min_sum(pb, ps)
    before = (qary_special_min_sum_fused_cuda.launches, chain_exclusive_cuda.launches)
    for backend in ("plain", "chain", "fused"):
        got = QarySpecialDecoder(H, 2, 12, 6, backend=backend, device=cuda).min_sum(pb, ps)
        assert got.device.type == "cuda" and torch.equal(got.cpu(), ref), backend
    assert (qary_special_min_sum_fused_cuda.launches, chain_exclusive_cuda.launches) == (before[0] + 1,
                                                                                          before[1] + 6)
    ee = QarySpecialDecoder(H, 2, 12, 6, backend="plain", early_exit=True, device="cpu").min_sum(pb, ps)
    assert torch.equal(QarySpecialDecoder(H, 2, 12, 6, early_exit=True, device=cuda).min_sum(pb, ps).cpu(), ee)


def test_default_backend_takes_chain_when_a_frame_does_not_fit(cuda):
    """At eta = 3 and check_blocks = 5 a frame needs 252,128 B of shared
    memory even in blocks of 8 warps: the default backend is "chain" and
    decodes as "plain" does; an explicit "fused" raises."""
    H = gen_ldpc_matrix(6, 0, check_blocks=5)
    dec = QarySpecialDecoder(H, 3, 18, 3, device=cuda)
    assert dec.backend == "chain"
    rng = np.random.RandomState(4)
    pb = rng.dirichlet(np.ones(7), size=(3, 768)).astype(np.float32)
    ps = rng.dirichlet(np.ones(37), size=(3, 1280)).astype(np.float32)
    ref = QarySpecialDecoder(H, 3, 18, 3, backend="plain", device=cuda).min_sum(pb, ps)
    assert torch.equal(dec.min_sum(pb, ps), ref)
    fused = QarySpecialDecoder(H, 3, 18, 3, backend="fused", device=cuda)
    before = qary_special_min_sum_fused_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        fused.min_sum(pb, ps)
    assert qary_special_min_sum_fused_cuda.launches == before


def test_kernel_raises_on_unsupported_inputs(cuda):
    H, sw = _codes()["block16"]
    args = _inputs(H, 2, 12, 3, 1, cuda)
    before = qary_special_min_sum_fused_cuda.launches
    with pytest.raises(ValueError):  # 2b+1 != QB
        qary_special_min_sum_fused_cuda(*args, 3, 12, 5)
    with pytest.raises(ValueError):  # 2bsum+1 != QS
        qary_special_min_sum_fused_cuda(*args, 2, 11, 5)
    with pytest.raises(TypeError):
        qary_special_min_sum_fused_cuda(args[0].double(), *args[1:], 2, 12, 5)
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        qary_special_min_sum_fused_cuda(*args[:7], args[7].cpu(), 2, 12, 5)
    with pytest.raises(ValueError):  # not contiguous
        qary_special_min_sum_fused_cuda(args[0], args[1].transpose(0, 1).contiguous().transpose(0, 1),
                                        *args[2:], 2, 12, 5)
    bad_idx = args[3].clone()
    bad_idx[0, 0] = H.shape[1]
    with pytest.raises(ValueError, match="adjacency"):
        qary_special_min_sum_fused_cuda(*args[:3], bad_idx, *args[4:], 2, 12, 5)
    bad_sign = args[7].clone()
    bad_sign[0] = 0
    with pytest.raises(ValueError, match="adjacency"):
        qary_special_min_sum_fused_cuda(*args[:7], bad_sign, 2, 12, 5)
    assert qary_special_min_sum_fused_cuda.launches == before


def test_kyber_attack_on_the_card_equals_the_cpu_run(cuda):
    kw = dict(accuracy=0.995, num_patterns=3, num_patterns_sum=3, sum_weight=6, check_blocks=2, iterations=10,
              runs=2)
    before = qary_special_min_sum_fused_cuda.launches
    on_card = simulate_kyber_attack(make_random_state(7), device=cuda, **kw)
    assert qary_special_min_sum_fused_cuda.launches == before + 2
    assert on_card == simulate_kyber_attack(make_random_state(7), device="cpu", **kw)
    assert all(r["correct_coefficients"] / r["total_coefficients"] > 0.95 for r in on_card)
