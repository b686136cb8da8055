"""The CUDA q-ary kernels (K5 chain_exclusive_cuda, K6 qary_min_sum_fused_cuda)
against their plain PyTorch versions, on the card (K5 at every instance).  Without a CUDA device
every test skips.  This file imports no JAX, so it runs on a machine without
it:

    python -m pytest --noconftest tests/test_torch_cuda_qary.py
"""

import ctypes

import numpy as np
import pytest
import torch

from sca_ldpc_tpu_torch.channels import probs_to_llr
from sca_ldpc_tpu_torch.codes import (
    make_qary_qc_parity_check_matrix,
    make_regular_ldpc_parity_check_matrix_identity,
)
from sca_ldpc_tpu_torch.ops import QaryDecoder, minplus
from sca_ldpc_tpu_torch.ops.kernels import qary_cuda
from sca_ldpc_tpu_torch.ops.kernels.circulant_cuda import smem_limits
from sca_ldpc_tpu_torch.ops.kernels.qary_cuda import (
    CHAIN_CHECKS,
    CHAIN_PER_WARP_WARPS,
    CHAIN_TABLE_BYTES,
    CHAIN_WARPS,
    FUSED_WARPS,
    _c_table,
    chain_exclusive_cuda,
    chain_exclusive_plain,
    chain_instance,
    chain_launch,
    chain_ptxas,
    chain_smem_bytes,
    fused_launch,
    fused_occupancy,
    fused_ptxas,
    fused_smem_bytes,
    qary_min_sum_fused_cuda,
    qary_min_sum_fused_plain,
)
from sca_ldpc_tpu_torch.sim import simulate_frame_error_rate_qary

pytestmark = pytest.mark.cuda
TOY = np.array([[1, 1, 1, 1, 0, 0], [0, 0, 1, 1, 0, 1], [1, 0, 0, 1, 1, 0]], np.int8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _bits(x):
    return x.contiguous().view(torch.int32)


def _v2c(bt, r, dc, q, seed, device):
    rng = np.random.RandomState(seed)
    v = (rng.rand(bt, r, dc, q) * 20).astype(np.float32)
    v[rng.rand(*v.shape) < 0.1] = minplus.BIG
    v[rng.rand(*v.shape) < 0.05] *= -1  # negative entries make the padding terms matter
    return torch.from_numpy(v).to(device)


@pytest.mark.parametrize("bt,r,dc,q", [(13, 10, 7, 15), (5, 7, 4, 5), (3, 4, 1, 3), (9, 150, 7, 15)])
def test_chain_kernel_bitwise_equals_plain(cuda, bt, r, dc, q):
    b = (q - 1) // 2
    v2c = _v2c(bt, r, dc, q, bt, cuda)
    before = chain_exclusive_cuda.launches
    out = chain_exclusive_cuda(v2c, (dc - 1) * b, b)
    ref = chain_exclusive_plain(v2c, (dc - 1) * b, b)
    torch.cuda.synchronize()
    assert chain_exclusive_cuda.launches == before + 1
    assert out.shape == (bt, r, dc, q) and torch.equal(_bits(out), _bits(ref))


@pytest.mark.parametrize("bt", [11, 16])
def test_chain_kernel_with_extra_bitwise_equals_plain(cuda, bt):
    sw, b = 6, 2
    se = sw * b
    rng = np.random.RandomState(bt)
    v2c = torch.from_numpy((rng.rand(bt, 10, sw, 2 * b + 1) * 20).astype(np.float32)).to(cuda)
    extra = torch.from_numpy((rng.rand(bt, 10, 2 * se + 1) * 20).astype(np.float32)).to(cuda)
    extra[:, :3, :5] = minplus.BIG
    for s_out in (b, b + 1):
        out = chain_exclusive_cuda(v2c, (2 * sw - 1) * b, s_out, extra)
        ref = chain_exclusive_plain(v2c, (2 * sw - 1) * b, s_out, extra)
        torch.cuda.synchronize()
        assert out.shape == (bt, 10, sw, 2 * s_out + 1) and torch.equal(_bits(out), _bits(ref))


# (v2c shape, s_mid, s_out, extra width): the medium decoder's check update, the early-exit FER's at Q = 3, the
# Kyber chain at eta 2 and 3 (and s_out = B + 1), and a shape whose chain steps walk the partial (s_mid < B)
CHAIN_SHAPES = [((7, 13, 7, 15), 42, 7, 0), ((7, 13, 7, 3), 6, 1, 0), ((5, 13, 6, 5), 22, 2, 25),
                ((5, 13, 6, 7), 33, 3, 37), ((5, 13, 6, 5), 22, 3, 25), ((7, 13, 3, 9), 3, 4, 0)]


def _instances(shape, s_mid, s_out, we, device):
    d, q = shape[2:]
    limits = smem_limits(device)
    staged = [(w, k) for k in CHAIN_CHECKS for w in CHAIN_WARPS
              if chain_instance(d, q, s_mid, s_out, we, w, k, *limits)]
    return staged + [(CHAIN_PER_WARP_WARPS, 0)]


@pytest.mark.parametrize("shape,s_mid,s_out,we", CHAIN_SHAPES)
def test_chain_kernel_every_instance_bitwise_equals_plain(cuda, shape, s_mid, s_out, we):
    """91 checks, which no instance's block of 8 to 64 checks divides; each
    instance forced, and the chosen one, bitwise equal to plain."""
    v2c = _v2c(*shape, sum(shape) + we, cuda)
    extra = None
    if we:
        rng = np.random.RandomState(we)
        e = (rng.rand(*shape[:2], we) * 20).astype(np.float32)
        e[rng.rand(*e.shape) < 0.1] = minplus.BIG
        e[rng.rand(*e.shape) < 0.05] *= -1
        extra = torch.from_numpy(e).to(cuda)
    ref = chain_exclusive_plain(v2c, s_mid, s_out, extra)
    chosen = chain_launch(shape[2], shape[3], s_mid, s_out, we, *smem_limits(cuda))
    for instance in [None, *_instances(shape, s_mid, s_out, we, cuda)]:
        before = chain_exclusive_cuda.launches
        out = chain_exclusive_cuda(v2c, s_mid, s_out, extra, instance=instance)
        torch.cuda.synchronize()
        assert chain_exclusive_cuda.launches == before + 1
        assert out.shape == ref.shape and torch.equal(_bits(out), _bits(ref)), instance
    assert (chosen.warps, chosen.checks) in chain_exclusive_cuda.instances


@pytest.mark.parametrize("shape,s_mid,s_out,we", CHAIN_SHAPES)
def test_chain_launch_configuration_on_the_card(cuda, shape, s_mid, s_out, we):
    """The host's copy of the kernel's table struct has its size; the
    chooser's shared-memory count equals the library's for every instance;
    ptxas reports every instance, at most 64 registers and no spills for the
    staged ones."""
    d, q = shape[2:]
    lib = qary_cuda._lib()
    assert lib.qary_chain_table_bytes() == CHAIN_TABLE_BYTES
    for w, k in [(w, k) for k in CHAIN_CHECKS for w in CHAIN_WARPS] + [(CHAIN_PER_WARP_WARPS, 0)]:
        assert lib.qary_chain_smem_bytes(ctypes.byref(_c_table(d, q, s_mid, s_out, we, k)), w, k) == chain_smem_bytes(
            d, q, s_mid, s_out, we, w, k)
    ptxas = chain_ptxas()
    assert set(ptxas) == {(w, k) for w in CHAIN_WARPS for k in CHAIN_CHECKS} | {(CHAIN_PER_WARP_WARPS, 0)}
    assert all(regs <= 64 and spill == 0 for (w, k), (regs, spill) in ptxas.items() if k)


def test_forced_chain_instance_is_checked(cuda):
    v2c = _v2c(2, 3, 7, 15, 0, cuda)
    before = chain_exclusive_cuda.launches
    with pytest.raises(ValueError, match="instances"):
        chain_exclusive_cuda(v2c, 42, 7, instance=(12, 1))
    with pytest.raises(ValueError, match="instances"):
        chain_exclusive_cuda(_v2c(1, 2, 40, 3, 0, cuda), 39, 1, instance=(8, 1))  # DC above the table's
    assert chain_exclusive_cuda.launches == before
    out = chain_exclusive_cuda(_v2c(1, 2, 40, 3, 0, cuda), 39, 1)  # the per-warp form takes it
    assert (CHAIN_PER_WARP_WARPS, 0) in chain_exclusive_cuda.instances and out.shape == (1, 2, 40, 3)


def test_fer_early_exit_chain_equals_plain_on_the_same_frames(cuda):
    """The early-exit q-ary FER takes "chain" by default (K5 at Q = 3) and
    gives the plain backend's triple on the same frames."""
    H = make_regular_ldpc_parity_check_matrix_identity(300, 150, 3, 6, 1)
    before = chain_exclusive_cuda.launches
    runs = [simulate_frame_error_rate_qary(H, 1, 0.005, 300, 7, batch_size=128, backend=be, early_exit=True,
                                           device=cuda) for be in (None, "plain")]
    assert chain_exclusive_cuda.launches > before
    assert runs[0] == runs[1] and runs[0][0] > 0


def _fused_inputs(H, b, frames, seed, device):
    dec = QaryDecoder(H, b, 1, backend="fused", device=device)
    probs = np.random.RandomState(seed).dirichlet(np.ones(2 * b + 1), size=(frames, H.shape[1]))
    probs[..., 0] = 0.0  # +inf LLRs, clipped to BIG
    probs /= probs.sum(-1, keepdims=True)
    llr = minplus.clip_inf(probs_to_llr(torch.from_numpy(probs.astype(np.float32)).to(device)))
    return llr.contiguous(), dec._args


def _codes():
    medium = make_regular_ldpc_parity_check_matrix_identity(300, 150, 3, 6, 1)
    return {
        "medium": (medium, 7),
        "medium_q3": (medium, 1),  # DecoderN450R150V3C7B1, the q-ary FER's code
        "signed_qc": (make_qary_qc_parity_check_matrix(30, 4, 2, np.random.RandomState(3)), 2),
        "toy": (TOY, 7),
    }


# None: the instance fused_launch picks; else each instance (warps a block) forced
WARPS = [None, *FUSED_WARPS]


@pytest.mark.parametrize("code", ["medium", "medium_q3", "signed_qc", "toy"])
@pytest.mark.parametrize("max_iter", [0, 1, 10])
@pytest.mark.parametrize("warps", WARPS)
def test_fused_kernel_hard_decisions_equal_plain(cuda, code, max_iter, warps):
    H, b = _codes()[code]
    llr, args = _fused_inputs(H, b, 37, 5, cuda)
    before = qary_min_sum_fused_cuda.launches
    hard = qary_min_sum_fused_cuda(llr, *args, b, max_iter, warps=warps)
    ref = qary_min_sum_fused_plain(llr, *args, b, max_iter)
    torch.cuda.synchronize()
    assert qary_min_sum_fused_cuda.launches == before + 1
    assert hard.dtype == torch.int32 and hard.shape == (37, H.shape[1])
    assert torch.equal(hard, ref)


@pytest.mark.parametrize("code", ["medium", "medium_q3", "signed_qc", "toy"])
def test_fused_launch_configuration_on_the_card(cuda, code):
    """The chooser's shared-memory count equals the library's for every
    instance; the occupancy calculator holds the chosen instance's blocks
    resident on an SM; ptxas reports every instance, at most 64 registers
    and no spills."""
    H, b = _codes()[code]
    lay = QaryDecoder(H, b, 1, backend="plain", device="cpu").layout
    q = 2 * b + 1
    for warps in FUSED_WARPS:
        assert qary_cuda._lib().qary_fused_smem_bytes(lay.n, lay.r, lay.dc, q, warps) == fused_smem_bytes(
            lay.n, lay.r, lay.dc, q, warps)
    occ = fused_occupancy(lay.n, lay.r, lay.dc, q, cuda)
    assert occ["lib_smem_bytes"] == occ["smem_bytes"]
    assert (occ["warps"], occ["blocks_per_sm"]) == fused_launch(lay.n, lay.r, lay.dc, q, *smem_limits(cuda))[:2]
    assert occ["resident_blocks"] >= occ["blocks_per_sm"]
    ptxas = fused_ptxas(6)
    assert set(ptxas) == set(FUSED_WARPS)
    assert all(regs <= 64 and spill == 0 for regs, spill in ptxas.values())


def test_forced_fused_launch_is_checked(cuda):
    H, b = _codes()["toy"]
    llr, args = _fused_inputs(H, b, 3, 1, cuda)
    before = qary_min_sum_fused_cuda.launches
    with pytest.raises(ValueError, match="instances"):
        qary_min_sum_fused_cuda(llr, *args, b, 5, warps=12)
    assert qary_min_sum_fused_cuda.launches == before


def test_decoder_backends_on_the_card(cuda):
    H, b = _codes()["medium"]
    llr, _ = _fused_inputs(H, b, 9, 6, cuda)
    assert QaryDecoder(H, b, 5, device=cuda).backend == "fused"
    assert QaryDecoder(H, b, 5, early_exit=True, device=cuda).backend == "chain"
    ref = QaryDecoder(H, b, 5, backend="plain", device=cuda).min_sum_llr(llr)
    for backend in ("chain", "fused"):
        assert torch.equal(QaryDecoder(H, b, 5, backend=backend, device=cuda).min_sum_llr(llr), ref)
    ee = QaryDecoder(H, b, 5, backend="plain", early_exit=True, device=cuda).min_sum_llr(llr)
    assert torch.equal(QaryDecoder(H, b, 5, early_exit=True, device=cuda).min_sum_llr(llr), ee)


def test_default_backend_takes_chain_when_a_frame_does_not_fit(cuda):
    """R = 1500, DC = 7, Q = 15: one frame's v2c alone is 630,000 B, above the
    232,448 B a block may use.  The default backend is "chain", chosen at
    construction, and decodes as "plain" does."""
    big = make_regular_ldpc_parity_check_matrix_identity(3000, 1500, 3, 6, 1)
    dec = QaryDecoder(big, 7, 3, device=cuda)
    assert dec.backend == "chain"
    llr, _ = _fused_inputs(big, 7, 4, 2, cuda)
    before = (chain_exclusive_cuda.launches, qary_min_sum_fused_cuda.launches)
    hard = dec.min_sum_llr(llr)
    assert (chain_exclusive_cuda.launches, qary_min_sum_fused_cuda.launches) == (before[0] + 3, before[1])
    assert torch.equal(hard, QaryDecoder(big, 7, 3, backend="plain", device=cuda).min_sum_llr(llr))


def test_explicit_fused_backend_raises_when_a_frame_does_not_fit(cuda):
    big = make_regular_ldpc_parity_check_matrix_identity(3000, 1500, 3, 6, 1)
    dec = QaryDecoder(big, 7, 3, backend="fused", device=cuda)
    llr, _ = _fused_inputs(big, 7, 2, 3, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        dec.min_sum_llr(llr)


def test_fer_fused_equals_plain_on_the_same_frames(cuda):
    H = make_regular_ldpc_parity_check_matrix_identity(300, 150, 3, 6, 1)
    runs = [simulate_frame_error_rate_qary(H, 1, 0.005, 300, 7, batch_size=128, backend=be, device=cuda)
            for be in ("fused", "plain")]
    assert runs[0] == runs[1] and runs[0][0] > 0


def test_wrappers_raise_on_unsupported_inputs(cuda):
    v2c = _v2c(4, 6, 7, 15, 0, cuda)
    before = (chain_exclusive_cuda.launches, qary_min_sum_fused_cuda.launches)
    with pytest.raises(ValueError):  # even Q
        chain_exclusive_cuda(v2c[..., :14].contiguous(), 36, 7)
    with pytest.raises(TypeError):
        chain_exclusive_cuda(v2c.double(), 42, 7)
    with pytest.raises(ValueError):
        chain_exclusive_cuda(v2c.transpose(1, 2), 42, 7)
    with pytest.raises(ValueError):  # extra on another device
        chain_exclusive_cuda(v2c, 42, 7, torch.zeros((4, 6, 5)))
    with pytest.raises(ValueError, match="shared memory"):
        chain_exclusive_cuda(_v2c(1, 1, 7, 301, 0, cuda), 900, 150)

    H, b = _codes()["medium"]
    llr, args = _fused_inputs(H, b, 3, 1, cuda)
    with pytest.raises(ValueError):  # Q != 2B+1
        qary_min_sum_fused_cuda(llr, *args, b + 1, 5)
    with pytest.raises(TypeError):
        qary_min_sum_fused_cuda(llr.double(), *args, b, 5)
    bad_var = args[0].clone()
    bad_var[0, 0] = H.shape[1]
    with pytest.raises(ValueError):
        qary_min_sum_fused_cuda(llr, bad_var, *args[1:], b, 5)
    big = make_regular_ldpc_parity_check_matrix_identity(3000, 1500, 3, 6, 1)
    llr_big, args_big = _fused_inputs(big, b, 1, 1, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        qary_min_sum_fused_cuda(llr_big, *args_big, b, 5)
    assert (chain_exclusive_cuda.launches, qary_min_sum_fused_cuda.launches) == before
    # the chain backend takes the code the fused kernel cannot hold
    hard = QaryDecoder(big, b, 1, backend="chain", device=cuda).min_sum_llr(llr_big)
    assert hard.shape == (1, big.shape[1])
