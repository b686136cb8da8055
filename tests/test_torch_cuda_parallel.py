"""Several ranks on the card: the sharded functions of
``sca_ldpc_tpu_torch.parallel`` in a world of one rank over NCCL, each equal
to its one-device run, and two ranks on one card over gloo
(``multihost_fer``), equal to one rank.  Without a CUDA device every test
skips.  This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda_parallel.py
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_world_worker as worker
from sca_ldpc_tpu_torch.codes import CirculantLayout, random_circulant_first_row
from sca_ldpc_tpu_torch.ops.circulant_bp import _multi_circulant_bp
from sca_ldpc_tpu_torch.ops.kernels import (
    circulant_bp_cuda,
    circulant_fer_cuda,
    multi_circulant_bp_cuda,
    qary_min_sum_fused_cuda,
)
from sca_ldpc_tpu_torch.ops.qary_special import QarySpecialDecoder
from sca_ldpc_tpu_torch.parallel import (
    fer_simulation,
    init_distributed,
    make_mesh,
    make_sharded_masked_decode,
    make_sharded_qary_fer_step,
    make_sharded_special_decode,
    sharded_fer_simulation,
)
from sca_ldpc_tpu_torch.parallel.mesh import shard_rows
from sca_ldpc_tpu_torch.parallel.qary import make_qary_fer_rows
from sca_ldpc_tpu_torch.utils import make_random_state

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A world of one rank over NCCL on cuda:0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    init_distributed(f"file://{tmp_path_factory.mktemp('nccl')}/rdv", 1, 0, device="cuda:0")
    try:
        mesh = make_mesh(device="cuda:0")
        assert dist.get_backend(mesh.group) == "nccl"
        yield mesh
    finally:
        dist.destroy_process_group()


def _gen(seed):
    g = torch.Generator(device="cuda:0")
    g.manual_seed(seed)
    return g


def _layout():
    return CirculantLayout.from_first_row(random_circulant_first_row(1021, 11, make_random_state(0)), True)


@pytest.mark.parametrize("backend, kernel", [("fused", circulant_fer_cuda), ("decode", circulant_bp_cuda)])
def test_sharded_fer_equals_fer_simulation(mesh, backend, kernel):
    lay = _layout()
    probs = np.full(lay.n_vars, 0.07, np.float32)
    before = kernel.launches
    got = sharded_fer_simulation(lay, probs, 1024, _gen(0), mesh, batch=512, max_iter=20, backend=backend)
    assert kernel.launches - before == 2
    assert got == fer_simulation(lay, probs, 1024, _gen(0), "cuda:0", batch=512, max_iter=20, backend=backend)
    assert 0 < got[0] < 1024  # at 0.07 some frames fail


def test_sharded_masked_decode_equals_one_launch(mesh):
    arrays = worker.attack_instances(1021, 3, 11, 6, 5, 8)
    before = multi_circulant_bp_cuda.launches
    got = make_sharded_masked_decode(mesh, max_iter=30)(*arrays)
    assert multi_circulant_bp_cuda.launches - before == 1
    one = _multi_circulant_bp(*(torch.as_tensor(a, device="cuda:0") for a in arrays), 30, "product_sum")
    assert all(torch.equal(a, b) for a, b in zip(got, one[:3]))


def test_sharded_qary_step_equals_its_halves(mesh):
    dec = worker.qary_decoder("cuda:0")
    assert dec.backend == "fused"
    before = qary_min_sum_fused_cuda.launches
    got = [int(x) for x in make_sharded_qary_fer_step(dec, 0.003, mesh)(_gen(3), 1024)]
    assert qary_min_sum_fused_cuda.launches - before == 1
    local = make_qary_fer_rows(dec, 0.003)
    halves = [local(_gen(3), 1024, shard_rows(1024, r, 2)) for r in (0, 1)]
    assert got == [sum(int(h[0]) for h in halves), max(int(h[1]) for h in halves), min(int(h[2]) for h in halves),
                   1024]


def test_sharded_special_decode_equals_the_decoder(mesh):
    H, p_b, p_s = worker.special_inputs()
    dec = QarySpecialDecoder(H, 2, 6, max_iter=6, device="cuda:0")
    assert torch.equal(make_sharded_special_decode(dec, mesh)(p_b, p_s), dec.min_sum(p_b, p_s))


def test_two_ranks_on_one_card_equal_one(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    common = [sys.executable, "-m", "sca_ldpc_tpu_torch.scripts.multihost_fer", "--runs", "1024", "--batch", "512",
              "--n", "1021", "--code-weight", "11", "--error-rate", "0.07", "--max-iter", "20", "--seed", "0",
              "--backend", "fused", "--device", "cuda"]
    procs = [subprocess.Popen(common + ["--dist-backend", "gloo", "--coordinator", f"file://{tmp_path}/rdv",
                                        "--num-processes", "2", "--process-id", str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
             for r in (0, 1)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    lay = _layout()
    ref = fer_simulation(lay, np.full(lay.n_vars, 0.07, np.float32), 1024, _gen(0), "cuda:0", batch=512,
                         max_iter=20, backend="fused")
    assert (got["successes"], got["frames"]) == ref and got["launches"]["circulant_fer_cuda"] == 4
    assert 0 < ref[0] < 1024  # at 0.07 some frames fail: the counts have something to disagree on
