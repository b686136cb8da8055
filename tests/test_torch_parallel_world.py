"""PyTorch port conformance: real several-process worlds on the CPU (gloo).

- Two ranks (``tests/torch_world_worker.py``, two processes joined through a
  rendezvous file) run every sharded function: the mesh's shapes and errors,
  the sharded FER step (``"decode"`` on a circulant and on a general layout,
  ``"fused"``), the sharded q-ary FER step, the sharded masked and special
  decodes, and the batched attack through ``ShardedCirculantDecodeExecutor``
  with ``crosscheck=True``.  Every result equals the world of one in this
  process, count for count and bit for bit; the attack equals the unsharded
  batched run, instance for instance; ranks that disagree on a round raise,
  both of them.
- ``multihost_fer`` in two processes equals one process and
  ``fer_simulation`` (the JAX package's ``test_parallel.py:88`` case).
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_world_worker as worker
from sca_ldpc_tpu_torch.codes import CirculantLayout, random_circulant_first_row
from sca_ldpc_tpu_torch.ops.qary_special import QarySpecialDecoder
from sca_ldpc_tpu_torch.parallel import (
    fer_simulation,
    make_mesh,
    make_sharded_fer_step,
    make_sharded_masked_decode,
    make_sharded_qary_fer_step,
    make_sharded_special_decode,
)
from sca_ldpc_tpu_torch.utils import make_random_state

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two ranks' results and the inputs they decoded."""
    tmp = tmp_path_factory.mktemp("world")
    pc, pi, syn, shifts = worker.attack_instances(48, 2, 3, 4, 11, 3)
    H, p_b, p_s = worker.special_inputs()
    inputs = {"pc": pc, "pi": pi, "syn": syn, "shifts": shifts, "H_special": H, "p_b": p_b, "p_s": p_s}
    np.savez(tmp / "inputs.npz", **inputs)
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_world_worker.py"), str(r), "2",
                               str(tmp / "rdv"), str(tmp / "inputs.npz"), str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV)
             for r in (0, 1)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-3000:] for o in outs]
    ranks = []
    for r in (0, 1):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, inputs


def test_world_mesh(world):
    ranks, _ = world
    for r, out in enumerate(ranks):
        assert out["shape"] == ({"data": 2, "model": 1}, 2, r, "gloo")
        assert out["shape_1x2"] == {"data": 1, "model": 2}
        assert out["bad_shape"] == "mesh 3x1 != 2 ranks"
        assert "the ranks disagree on the rank" in out["mismatch"]
    assert ranks[0]["subset"] == {"data": 1, "model": 1} and "not one of the mesh's ranks" in ranks[1]["subset"]


@pytest.mark.parametrize("case", [c[0] for c in worker.fer_cases()])
def test_world_fer_equals_one_rank(world, case):
    ranks, _ = world
    _name, lay, probs, backend, batch = next(c for c in worker.fer_cases() if c[0] == case)
    one = [int(x) for x in make_sharded_fer_step(lay, probs, make_mesh(device="cpu"), max_iter=20,
                                                 backend=backend)(worker.gen(9), batch)]
    assert ranks[0][case] == ranks[1][case] == one
    assert 0 < one[0] < batch


def test_world_qary_equals_one_rank(world):
    ranks, _ = world
    one = [int(x) for x in make_sharded_qary_fer_step(worker.qary_decoder(), 0.003,
                                                      make_mesh(device="cpu"))(worker.gen(3), 64)]
    assert ranks[0]["qary"] == ranks[1]["qary"] == one
    assert 0 < one[0] < 64 and one[3] == 64


def test_world_masked_and_special_decodes_equal_one_rank(world):
    ranks, inputs = world
    one = make_sharded_masked_decode(make_mesh(device="cpu"), max_iter=30)(
        *(inputs[k] for k in ("pc", "pi", "syn", "shifts")))
    special = QarySpecialDecoder(inputs["H_special"], 2, 6, max_iter=6, device="cpu")
    hard = make_sharded_special_decode(special, make_mesh(device="cpu"))(inputs["p_b"], inputs["p_s"]).numpy()
    for out in ranks:
        assert all(np.array_equal(a, b.numpy()) for a, b in zip(out["masked"], one))
        assert np.array_equal(out["special"], hard)


def test_world_sharded_executor_equals_unsharded(world):
    """Two instances, one a rank, ``crosscheck=True`` on both ranks: every
    instance's recovery flag, oracle calls and success sequence equal the
    unsharded batched run's, and so do the rounds."""
    ranks, _ = world
    ref = worker.run_attack(None, [1, 2])
    assert ref[1] > 0 and all(len(seq) for _ok, _calls, seq in ref[0])
    assert ranks[0]["attack"] == ranks[1]["attack"] == ref


def test_world_round_mismatch_raises_on_every_rank(world):
    ranks, _ = world
    assert all("the ranks disagree on the round" in out["attack_mismatch"] for out in ranks)


def test_multihost_fer_two_processes_equal_one(tmp_path):
    """The JAX test's argv (``test_parallel.py:88``): 2 processes on the CPU
    give the 1-process run's counts, which are ``fer_simulation``'s."""
    common = [sys.executable, "-m", "sca_ldpc_tpu_torch.scripts.multihost_fer", "--runs", "128", "--n", "127",
              "--code-weight", "3", "--error-rate", "0.02", "--seed", "3", "--device", "cpu"]
    procs = [subprocess.Popen(common + ["--coordinator", f"file://{tmp_path}/rdv", "--num-processes", "2",
                                        "--process-id", str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV, cwd=ROOT)
             for r in (0, 1)]
    single = subprocess.run(common, capture_output=True, text=True, timeout=240, env=ENV, cwd=ROOT)
    outs = [p.communicate(timeout=240) for p in procs]
    assert single.returncode == 0, single.stderr[-2000:]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    ref = json.loads(single.stdout.strip().splitlines()[-1])
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    assert outs[1][0].strip() == ""  # only rank 0 prints
    assert got["process_count"] == got["device_count"] == 2 and got["mesh"] == [2, 1]
    assert ref["process_count"] == 1 and ref["mesh"] == [1, 1]
    assert (got["successes"], got["frames"]) == (ref["successes"], ref["frames"])

    lay = CirculantLayout.from_first_row(random_circulant_first_row(127, 3, make_random_state(3)), True)
    gen = torch.Generator()
    gen.manual_seed(3)
    assert fer_simulation(lay, np.full(254, 0.02, np.float32), 128, gen, "cpu", batch=128, max_iter=30,
                          backend="decode") == (ref["successes"], ref["frames"])
    assert 0 < ref["successes"] < 128
