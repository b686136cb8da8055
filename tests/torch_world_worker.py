"""One rank of a world, for ``tests/test_torch_parallel_world.py`` (gloo
on the CPU) and for a check over several cards (NCCL, ``cuda:<rank>``).

    python tests/torch_world_worker.py <rank> <world> <rendezvous file> <inputs.npz> <out dir> [device]

Joins the world, runs every sharded function of ``sca_ldpc_tpu_torch.parallel``
and the sharded batched attack on the inputs the test wrote, and saves what
each returned to ``<out dir>/rank<rank>.pkl``.  Imports no JAX.
"""

import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from sca_ldpc_tpu_torch.codes import (  # noqa: E402
    CirculantLayout,
    CodeLayout,
    make_regular_ldpc_parity_check_matrix,
    make_regular_ldpc_parity_check_matrix_identity,
    random_circulant_first_row,
)
from sca_ldpc_tpu_torch.ops.qary import QaryDecoder  # noqa: E402
from sca_ldpc_tpu_torch.ops.qary_special import QarySpecialDecoder  # noqa: E402
from sca_ldpc_tpu_torch.parallel import (  # noqa: E402
    init_distributed,
    make_mesh,
    make_sharded_fer_step,
    make_sharded_masked_decode,
    make_sharded_qary_fer_step,
    make_sharded_special_decode,
)
from sca_ldpc_tpu_torch.utils import make_random_state  # noqa: E402

ATTACK = dict(decode_every=25, weight=20, max_oracle_calls=800)  # a short two-instance batched attack


def gen(seed, device="cpu"):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def fer_cases():
    """(name, layout, probs, backend, batch) of the FER steps run."""
    circ = CirculantLayout.from_first_row(random_circulant_first_row(64, 3, make_random_state(2)), True)
    general = CodeLayout.from_h(make_regular_ldpc_parity_check_matrix(96, 48, 3, 6, make_random_state(1)))
    return [("decode-circulant", circ, np.full(128, 0.03, np.float32), "decode", 32),
            ("fused", circ, np.full(128, 0.03, np.float32), "fused", 32),
            ("decode-general", general, np.full(96, 0.04, np.float32), "decode", 32)]


def qary_decoder(device="cpu"):
    """DecoderN450R150V3C7B1's shape: the (3, 6)-regular code of 300 columns
    with the identity, B = 1, 5 iterations."""
    H = make_regular_ldpc_parity_check_matrix_identity(300, 150, 3, 6, make_random_state(2))
    return QaryDecoder(H.astype(np.int8), b_range=1, max_iter=5, device=device)


def special_inputs():
    """A small [H'|I] code (24 B-variables in [-2..2], 8 sums of 3 in
    [-6..6]) and 4 instances of Dirichlet-like channels."""
    rng = make_random_state(7)
    nb, r, sw, b, bsum, i_n = 24, 8, 3, 2, 6, 4
    H = np.zeros((r, nb + r), np.int8)
    for i in range(r):
        cols = rng.choice(nb, sw, replace=False)
        H[i, cols] = rng.choice([-1, 1], sw)
        H[i, nb + i] = 1
    p_b = rng.rand(i_n, nb, 2 * b + 1).astype(np.float32) + 0.1
    p_b /= p_b.sum(-1, keepdims=True)
    p_s = rng.rand(i_n, r, 2 * bsum + 1).astype(np.float32) + 0.1
    p_s /= p_s.sum(-1, keepdims=True)
    return H, p_b, p_s


def run_attack(mesh, seeds, crosscheck=True, device="cpu"):
    """The batched attack through the sharded executor (``mesh`` None: the
    unsharded one) on the fixture key; per instance (recovered, oracle calls,
    success sequence), and the rounds."""
    from sca_ldpc_tpu_torch.models.hqc import batched, simulate_hqc_attacks_batched
    from sca_ldpc_tpu_torch.tools.attack_cells import fixture_keys

    with fixture_keys():
        if mesh is None:
            executor = batched.BatchedCirculantDecodeExecutor(len(seeds), max_iter=50, device=device)
        else:
            executor = batched.ShardedCirculantDecodeExecutor(len(seeds), mesh, max_iter=50, crosscheck=crosscheck)
        results, rounds = simulate_hqc_attacks_batched(seeds, decode_backend="circulant", executor=executor,
                                                       device=device, **ATTACK)
    return [(ok, t.num_oracle_calls, [d["success"] for d in t.decoder_stats]) for ok, t in results], rounds


def attack_instances(n, p, w, i_n, seed, weight):
    """Masked-decode inputs of ``i_n`` instances (the JAX package's
    ``tests/test_parallel.py`` construction): each a random sparse word under
    ``p`` random circulants of ``w`` shifts, 60% of the rows measured."""
    rng = make_random_state(seed)
    prior_c = np.zeros((i_n, n), np.float32)
    prior_i = np.zeros((i_n, p, n), np.float32)
    syn = np.zeros((i_n, p, n), np.int32)
    shifts = np.zeros((i_n, p, w), np.int32)
    big = float(np.log((1 - 1e-9) / 1e-9))
    for i in range(i_n):
        y = np.zeros(n, np.int8)
        y[rng.choice(n, weight, replace=False)] = 1
        prior_c[i] = np.log((1 - weight / n) / (weight / n))
        for b in range(p):
            shifts[i, b] = np.sort(rng.choice(n, w, replace=False))
            par = sum(np.roll(y, int(k)).astype(int) for k in shifts[i, b]) % 2
            meas = rng.rand(n) < 0.6
            syn[i, b] = np.where(meas, par, 0)
            prior_i[i, b] = np.where(meas, big, 0.0)
    return prior_c, prior_i, syn, shifts


def main(rank, world, rdv, inputs, out_dir, device="cpu"):
    torch.set_num_threads(1)
    assert init_distributed(f"file://{rdv}", world, rank, device=device) == (rank, world)
    out = {}
    try:
        mesh = make_mesh(device=device)
        out["shape"] = (mesh.shape, mesh.size, mesh.rank, dist.get_backend(mesh.group))
        out["shape_1x2"] = make_mesh(data=1, model=world, device=device).shape
        try:
            make_mesh(data=3, device=device)
        except ValueError as e:
            out["bad_shape"] = str(e)
        try:
            out["subset"] = make_mesh(ranks=[0], device=device).shape
        except ValueError as e:
            out["subset"] = str(e)
        try:
            mesh.check_same([rank], "the rank")
        except RuntimeError as e:
            out["mismatch"] = str(e)

        for name, lay, probs, backend, batch in fer_cases():
            step = make_sharded_fer_step(lay, probs, mesh, max_iter=20, backend=backend)
            out[name] = [int(x) for x in step(gen(9, device), batch)]
        step = make_sharded_qary_fer_step(qary_decoder(device), 0.003, mesh)
        out["qary"] = [int(x) for x in step(gen(3, device), 64)]

        arrays = np.load(inputs)
        masked = make_sharded_masked_decode(mesh, max_iter=30)(*(arrays[k] for k in ("pc", "pi", "syn", "shifts")))
        out["masked"] = [t.cpu().numpy() for t in masked]
        special = QarySpecialDecoder(arrays["H_special"], 2, 6, max_iter=6, device=device)
        out["special"] = make_sharded_special_decode(special, mesh)(arrays["p_b"], arrays["p_s"]).cpu().numpy()

        out["attack"] = run_attack(mesh, [1, 2], device=device)
        try:  # the ranks run different seeds: their first round differs, and every rank must raise
            run_attack(mesh, [1, 2 + rank], crosscheck=False, device=device)
        except RuntimeError as e:
            out["attack_mismatch"] = str(e)
    finally:
        dist.destroy_process_group()
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])
