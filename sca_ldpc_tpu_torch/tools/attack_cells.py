"""K8's cells: the masked decodes of the seed-0 HQC-128 attack.

The attack (``simulate_hqc_idealized_oracle`` with the idealized oracle, seed
0, the fixture key, a decode every 50 checks, circulant weight 20) runs once
through a decode executor that records each decode's check set.  A cell takes
the recovery's 2,850 rows (the last decode's), the same rows at their true
values, or the first decode's 50, spread over P = 1, 3 or 8 circulant blocks,
at batch 1 (that end's decode) or 16 (the 16 decodes at that end).
``chip_smoke.py`` phase 16 holds K8 against plain on them and
``circulant_forms --kernels k8`` times K8's forms on them.  An instance cell
gives each of I recorded check sets its own circulants and block count, the
batched attack's round with per-instance shifts ``[I, P, W]`` (phase 18).
"""

from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

N = 17669  # HQC-128's circulant size
KEYFILE = Path(__file__).resolve().parents[2] / "fixtures" / "test-hqc128.key"  # the attack's fixture key
ATTACK = dict(decode_every=50, weight=20, keyfile=str(KEYFILE), error_rate=0.0, param_set="128",
              max_oracle_calls=60000)
ITERATIONS, BATCH, BLOCKS = 100, 16, (1, 3, 8)


class Recorder:
    """A decode executor that keeps each decode's check set (the masked
    decoder's rows and block shifts, the checks, the secret's support) and
    then decodes as the decoder would alone."""

    def __init__(self):
        self.sets = []

    def decode(self, decoder, tracking, checks, y_sparse):
        state = decoder.state_dict()
        self.sets.append((list(state["rows"]), list(state["block_shifts"]), list(checks), list(y_sparse)))
        return decoder.decode(tracking, checks, y_sparse)


def record_sets(device):
    """Run the seed-0 attack through ``"circulant"`` on ``device``; returns
    (recovered, tracking, the decodes' check sets)."""
    from ..models.hqc import simulate_hqc_idealized_oracle
    from ..utils import make_random_state

    if not KEYFILE.is_file():  # the attack would make a new key there
        raise FileNotFoundError(f"the fixture key {KEYFILE} is missing")
    rec = Recorder()
    ok, tracking = simulate_hqc_idealized_oracle(make_random_state(0), decode_backend="circulant",
                                                 decode_executor=rec, device=device, **ATTACK)
    return ok, tracking, rec.sets


@contextmanager
def fixture_keys():
    """Every ``Hqc128.keypair()`` (drawn from the OS) gives the fixture key
    while the context lasts, so that the batched attack's instances, which
    draw their keys there, attack a known key; yields that keypair."""
    from ..models.hqc import Hqc128, read_or_generate_keypair

    keypair = read_or_generate_keypair(Hqc128, str(KEYFILE))
    Hqc128.keypair = classmethod(lambda cls: keypair)  # shadows the base class's method
    try:
        yield keypair
    finally:
        del Hqc128.keypair


def cells():
    """(label, which end of the attack, true values, P) of every cell; each
    runs at batch 1 and ``BATCH``."""
    return ([("2850 rows", "last", False, p) for p in BLOCKS] + [("2850 rows, true values", "last", True, 1)]
            + [("50 rows", "first", False, p) for p in BLOCKS])


def pick(sets, end, b):
    """The ``b`` check sets at the ``end`` ("first" or "last") of the attack."""
    return sets[:b] if end == "first" else sets[-b:]


def _circulant(seed):
    """The support of the HQC-128 circulant of weight 20 drawn from ``seed``."""
    from ..codes import random_circulant_first_row
    from ..utils import make_random_state

    return tuple(int(k) for k in np.flatnonzero(random_circulant_first_row(N, ATTACK["weight"],
                                                                           make_random_state(seed))))


def _frame(check_set, blocks, true_values, p_pad=None):
    """One frame of the masked decode's inputs: the recorded ``check_set``'s
    rows measured in every block of ``blocks`` (circulant supports), each
    with its value under that block's circulant, wrong where the attack's
    check was wrong (unless ``true_values``), with the attack's certainty;
    padded to ``p_pad`` blocks with inert ones."""
    from ..models.hqc import sparse_times_sparse
    from ..models.hqc.attack import MaskedCirculantCheckDecoder, add_check, make_params

    rows, block_shifts, checks, y = check_set
    params = make_params("128", ATTACK["decode_every"], ATTACK["weight"])
    truth = [set(sparse_times_sparse(y, list(k), N)) for k in blocks]
    measured = [set(sparse_times_sparse(y, list(k), N)) for k in block_shifts]
    dec = MaskedCirculantCheckDecoder(params, device="cpu")
    dec.load_state_dict({"row_supports": [], "rows": [], "block_shifts": list(blocks)})
    spread = []
    for q in range(len(blocks)):
        for (blk, bit), (c, certainty) in zip(rows, checks):
            wrong = not true_values and bool(c) != (bit in measured[blk])
            add_check(dec, blocks[q], spread, None, bit, (bit in truth[q]) != wrong, certainty)
    return dec.build_masked_arrays(spread, y, p_pad=p_pad)


def _tensors(frames, shifts, device):
    prior_c, prior_i, syn = (np.stack([f[i] for f in frames]) for i in range(3))
    return (torch.from_numpy(prior_c).to(device), torch.from_numpy(prior_i).to(device),
            torch.from_numpy(syn.astype(np.uint8)).to(device), torch.from_numpy(shifts).to(device))


def masked_cell(sets, p, device, true_values=False):
    """The masked decode's inputs for the recorded check sets ``sets`` (one
    frame each) over ``p`` blocks: block 0 the attack's circulant, blocks 1..
    circulants of seeds 1..; every block measures the set's rows, each with
    its value under that block's circulant, wrong where the attack's check
    was wrong (unless ``true_values``), with the attack's certainty."""
    blocks = [tuple(sets[0][1][0])] + [_circulant(q) for q in range(1, p)]
    frames = [_frame(check_set, blocks, true_values) for check_set in sets]
    return _tensors(frames, frames[0][3], device)


def instance_cell(sets, blocks_per_instance, device):
    """A batched round's inputs: instance f decodes the recorded check set
    ``sets[f]`` over ``blocks_per_instance[f]`` circulants of its own (seeds
    100 f + 1, ...; no two instances share one), padded with inert blocks to
    the round's largest count, so the shifts are per instance
    ``[I, P_pad, W]``."""
    p_pad = max(blocks_per_instance)
    frames = [_frame(check_set, [_circulant(100 * f + q + 1) for q in range(p)], False, p_pad)
              for f, (check_set, p) in enumerate(zip(sets, blocks_per_instance))]
    return _tensors(frames, np.stack([f[3] for f in frames]), device)


class ModelledClock:
    """A modelled cycle counter in place of the native ``decode_oracle``'s
    rdtscp: a decapsulation of ``ct`` takes ``base + cost * extra`` cycles,
    ``extra`` being the extra seed expansions of the plaintext that ``ct``
    decodes to (the re-encryption ``decaps`` performs, the channel's
    physical cause), plus Gaussian noise of ``sigma`` cycles and an
    exponential tail of mean ``tail`` cycles a measurement, drawn from
    ``seed``.  Everything above the counter (profiling, calibration, the
    guard, ``TimingChannel``'s differential decisions and recalibration,
    the attack's Bayesian amplification) runs as on a host.  The default
    cost is the card host's profiled expansion cost (4,182 cycles, PERF.md);
    the noise puts the calibrated accuracy near 0.99 (fail class) and 0.93
    (success class).

    Use as a context manager around the attack: it replaces
    ``HQC.decode_oracle`` of the class ``HQC`` and puts it back after.
    ``decapsulations`` counts the modelled decapsulations."""

    def __init__(self, HQC, seed=0, base=700_000, cost=4182, sigma=1800.0, tail=1500.0):
        self.HQC, self.base, self.cost, self.sigma, self.tail = HQC, base, cost, sigma, tail
        self.rng = np.random.RandomState(seed)
        self._extra = {}  # ct bytes -> extra seed expansions of its decoded plaintext
        self.decapsulations = 0

    def extra(self, ct, priv):
        key = bytes(ct)
        if key not in self._extra:
            pt = self.HQC.decode_intermediates(ct, priv)[0]
            self._extra[key] = self.HQC.num_rejections(bytes(pt)) // 1000 - 3
        return self._extra[key]

    def decode_oracle(self, ct, priv, num_measurements):
        n = int(num_measurements)
        self.decapsulations += n
        t = (self.base + self.cost * self.extra(ct, priv) + self.sigma * self.rng.standard_normal(n)
             + self.rng.exponential(self.tail, n))
        return [int(x) for x in t]

    def __enter__(self):
        self.HQC.decode_oracle = staticmethod(self.decode_oracle)  # shadows the class method
        return self

    def __exit__(self, *exc):
        del self.HQC.decode_oracle
