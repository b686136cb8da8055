"""PyTorch port conformance, end to end: ``simulate_hqc_attacks_batched``
with two HQC-128 instances (seeds 1 and 2, a decode every 100 checks,
circulant weight 20, both on the fixture key: ``keypair()`` draws from the
OS, so the test pins it) through ``decode_backend="general"``, the port on
the CPU against the JAX package, instance by instance: the success of every
decode, the oracle calls at every decode and in all, and the final decode's
stats.  Each instance also equals its own single-instance run, and a
recovered instance's checkpoint is deleted.  Marked ``slow``: the six
attacks take about a minute on one thread."""

import pytest
import torch

from sca_ldpc_tpu.models.hqc import Hqc128 as JaxHqc128
from sca_ldpc_tpu.models.hqc import simulate_hqc_attacks_batched as jax_batched
from sca_ldpc_tpu_torch.models.hqc import Hqc128, read_or_generate_keypair, simulate_hqc_attacks_batched
from sca_ldpc_tpu_torch.models.hqc import simulate_hqc_idealized_oracle
from sca_ldpc_tpu_torch.utils import make_random_state

torch.set_num_threads(1)

KEY = "fixtures/test-hqc128.key"
SEEDS = [1, 2]
ARGS = dict(decode_every=100, weight=20, max_oracle_calls=60000, decode_backend="general")


def _trajectory(tracking):
    return [(d["checks"], d["oracle_calls"], d["success"]) for d in tracking.decoder_stats]


@pytest.mark.slow
def test_two_instances_equal_jax_and_their_solo_runs(tmp_path, monkeypatch):
    keypair = read_or_generate_keypair(Hqc128, KEY)
    for hqc in (Hqc128, JaxHqc128):
        monkeypatch.setattr(hqc, "keypair", classmethod(lambda cls: keypair))
    ckpt_dir = tmp_path / "ckpts"
    results, rounds = simulate_hqc_attacks_batched(SEEDS, checkpoint_dir=str(ckpt_dir), device="cpu", **ARGS)
    jresults, jrounds = jax_batched(SEEDS, **ARGS)
    assert rounds == jrounds >= 1
    for seed, (ok, tr), (jok, jtr) in zip(SEEDS, results, jresults):
        assert ok and jok
        assert tr.num_oracle_calls == jtr.num_oracle_calls
        assert _trajectory(tr) == _trajectory(jtr)
        assert tr.decoder_stats[-1] == jtr.decoder_stats[-1] and tr.decoder_stats[-1]["bad_flips"] == 0
        solo_ok, solo = simulate_hqc_idealized_oracle(make_random_state(seed), keypair=keypair, device="cpu", **ARGS)
        assert solo_ok and _trajectory(solo) == _trajectory(tr)
    assert list(ckpt_dir.iterdir()) == []  # recovered instances delete their checkpoints
