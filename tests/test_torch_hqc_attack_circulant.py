"""PyTorch port conformance, end to end: the HQC-128 key-recovery attack
(seed 0, decode every 50 checks, weight 20, the fixture key) with
``decode_backend="circulant"`` (the masked decode, on the CPU the plain
version of K8), the port on the CPU against the JAX package.  Equal: the
success of every decode, the oracle calls at every decode and in all, the
number of decodes and the final decode's stats.  A failed decode runs all
100 iterations, where XLA's and PyTorch's log/tanh may differ in ulps, so
the flip counts of failed decodes are no contract.  Marked ``slow``: the
57 plain masked decodes, most of them 100 iterations, take about a minute
on one thread."""

import pytest
import torch

from sca_ldpc_tpu.models.hqc import simulate_hqc_idealized_oracle as jax_attack
from sca_ldpc_tpu.utils import make_random_state as jax_random_state
from sca_ldpc_tpu_torch.models.hqc import simulate_hqc_idealized_oracle
from sca_ldpc_tpu_torch.utils import make_random_state

torch.set_num_threads(1)

BACKEND = "circulant"
ARGS = dict(decode_every=50, weight=20, keyfile="fixtures/test-hqc128.key", error_rate=0.0, param_set="128",
            max_oracle_calls=60000, decode_backend=BACKEND)


def _trajectory(tracking):
    return [(d["checks"], d["oracle_calls"], d["success"]) for d in tracking.decoder_stats]


@pytest.mark.slow  # about 70 s on one thread; tier-1 keeps the decode's checks (test_torch_multi_circulant.py)
def test_attack_end_to_end_matches_jax():
    ok, tracking = simulate_hqc_idealized_oracle(make_random_state(0), device="cpu", **ARGS)
    ok_j, tracking_j = jax_attack(jax_random_state(0), **ARGS)
    assert ok and ok_j
    assert tracking.num_oracle_calls == tracking_j.num_oracle_calls
    assert _trajectory(tracking) == _trajectory(tracking_j)
    assert tracking.decoder_stats[-1] == tracking_j.decoder_stats[-1]
    assert tracking.decode_seconds > 0.0
