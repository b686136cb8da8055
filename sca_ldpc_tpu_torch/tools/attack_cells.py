"""K8's cells: the masked decodes of the seed-0 HQC-128 attack.

The attack (``simulate_hqc_idealized_oracle`` with the idealized oracle, seed
0, the fixture key, a decode every 50 checks, circulant weight 20) runs once
through a decode executor that records each decode's check set.  A cell takes
the recovery's 2,850 rows (the last decode's), the same rows at their true
values, or the first decode's 50, spread over P = 1, 3 or 8 circulant blocks,
at batch 1 (that end's decode) or 16 (the 16 decodes at that end).
``chip_smoke.py`` phase 16 holds K8 against plain on them and
``circulant_forms --kernels k8`` times K8's forms on them.
"""

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


def cells():
    """(label, which end of the attack, true values, P) of every cell; each
    runs at batch 1 and ``BATCH``."""
    return ([("2850 rows", "last", False, p) for p in BLOCKS] + [("2850 rows, true values", "last", True, 1)]
            + [("50 rows", "first", False, p) for p in BLOCKS])


def pick(sets, end, b):
    """The ``b`` check sets at the ``end`` ("first" or "last") of the attack."""
    return sets[:b] if end == "first" else sets[-b:]


def masked_cell(sets, p, device, true_values=False):
    """The masked decode's inputs for the recorded check sets ``sets`` (one
    frame each) over ``p`` blocks: block 0 the attack's circulant, blocks 1..
    circulants of seeds 1..; every block measures the set's rows, each with
    its value under that block's circulant, wrong where the attack's check
    was wrong (unless ``true_values``), with the attack's certainty."""
    from ..codes import random_circulant_first_row
    from ..models.hqc import sparse_times_sparse
    from ..models.hqc.attack import MaskedCirculantCheckDecoder, add_check, make_params
    from ..utils import make_random_state

    params = make_params("128", ATTACK["decode_every"], ATTACK["weight"])
    blocks = [tuple(sets[0][1][0])] + [tuple(int(k) for k in np.flatnonzero(random_circulant_first_row(
        N, ATTACK["weight"], make_random_state(q)))) for q in range(1, p)]
    frames = []
    for rows, block_shifts, checks, y in sets:
        truth = [set(sparse_times_sparse(y, list(k), N)) for k in blocks]
        measured = [set(sparse_times_sparse(y, list(k), N)) for k in block_shifts]
        dec = MaskedCirculantCheckDecoder(params, device="cpu")
        dec.load_state_dict({"row_supports": [], "rows": [], "block_shifts": blocks})
        spread = []
        for q in range(p):
            for (blk, bit), (c, certainty) in zip(rows, checks):
                wrong = not true_values and bool(c) != (bit in measured[blk])
                add_check(dec, blocks[q], spread, None, bit, (bit in truth[q]) != wrong, certainty)
        frames.append(dec.build_masked_arrays(spread, y))
    prior_c, prior_i, syn, shifts = [np.stack([f[i] for f in frames]) for i in range(3)] + [frames[0][3]]
    return (torch.from_numpy(prior_c).to(device), torch.from_numpy(prior_i).to(device),
            torch.from_numpy(syn.astype(np.uint8)).to(device), torch.from_numpy(shifts).to(device))
