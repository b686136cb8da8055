#!/usr/bin/env python
"""Several-process sharded FER simulation driver (the JAX package's
``scripts/multihost_fer.py`` on the port).

The reference scales across machines by launching independent processes and
merging CSV files (run-parallel-hqc-simulation.sh:10-45).  Here N processes
form ONE SPMD program: every process runs this script with the same
arguments and its own ``--process-id`` (or under ``torchrun``, which sets the
rendezvous variables); ``torch.distributed`` connects them
(``parallel.init_distributed``), each process is one rank on one device, and
the sharded FER step (``parallel/fer.py``) splits every batch over the ranks
and reduces the counts with the process group's collectives.  The frames do
not depend on the number of ranks, so a run of any world size at the same
``--batch`` gives the same counts.

The JAX script's ``--force-cpu-devices`` (virtual CPU devices a process) has
no counterpart: a CPU world is several processes with ``--device cpu``,
joined over gloo.  On cards each rank takes ``cuda:{LOCAL_RANK %
device_count}`` and the group runs over NCCL; NCCL refuses two ranks on one
card, so such a world passes ``--dist-backend gloo``.

Examples (two terminals or subprocesses; one line each):

    python -m sca_ldpc_tpu_torch.scripts.multihost_fer --coordinator localhost:9876 \\
        --num-processes 2 --process-id 0 --device cpu ...
    python -m sca_ldpc_tpu_torch.scripts.multihost_fer ... --process-id 1 ...
    torchrun --nproc-per-node 4 -m sca_ldpc_tpu_torch.scripts.multihost_fer --n 17669 --code-weight 20

Rank 0 prints one JSON line with the reduced results (the JAX script's keys,
``device_count`` being the ranks), the kernels' launches summed over the
ranks, and the seconds of the simulation.
"""

import argparse
import json
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", default=None,
                    help="rendezvous address host:port or file:///path (required if num-processes > 1 "
                         "outside torchrun)")
    ap.add_argument("--num-processes", type=int, default=None, help="world size (default: WORLD_SIZE or 1)")
    ap.add_argument("--process-id", type=int, default=None, help="this rank (default: RANK or 0)")
    ap.add_argument("--device", default="cuda", help="'cuda' (the default; raises without a card) or 'cpu'")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend (default: nccl on cards, gloo on the CPU)")
    ap.add_argument("--backend", default="decode", choices=["decode", "fused"],
                    help="FER step backend: 'decode' (the JAX 'xla') or 'fused' (the JAX 'pallas', K1)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--runs", type=int, default=512)
    ap.add_argument("--batch", type=int, default=None,
                    help="frames a step over all ranks (default: the JAX rule, min(runs, 256 x ranks))")
    ap.add_argument("--n", type=int, default=257, help="circulant size")
    ap.add_argument("--code-weight", type=int, default=5)
    ap.add_argument("--error-rate", type=float, default=0.01)
    ap.add_argument("--max-iter", type=int, default=30)
    ap.add_argument("--model", type=int, default=1, help="mesh model-axis size")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from sca_ldpc_tpu_torch.codes import CirculantLayout, random_circulant_first_row
    from sca_ldpc_tpu_torch.ops.kernels import circulant_bp_cuda, circulant_fer_cuda
    from sca_ldpc_tpu_torch.parallel import init_distributed, make_mesh, sharded_fer_simulation
    from sca_ldpc_tpu_torch.utils import make_random_state

    rank, world = init_distributed(args.coordinator, args.num_processes, args.process_id, args.device,
                                   args.dist_backend)
    try:
        first_row = random_circulant_first_row(args.n, args.code_weight, make_random_state(args.seed))
        layout = CirculantLayout.from_first_row(first_row, with_identity=True)
        probs = np.full(layout.n_vars, args.error_rate, np.float32)
        mesh = make_mesh(model=args.model, device=args.device)
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(args.seed)
        kernels = (circulant_fer_cuda, circulant_bp_cuda)
        before = [k.launches for k in kernels]
        t0 = time.perf_counter()
        successes, frames = sharded_fer_simulation(layout, probs, args.runs, gen, mesh, batch=args.batch,
                                                   max_iter=args.max_iter, backend=args.backend)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        seconds = time.perf_counter() - t0
        launches = torch.tensor([k.launches - b for k, b in zip(kernels, before)], device=mesh.device)
        launches = mesh.all_reduce(launches, "sum").tolist()
        summary = {
            "successes": int(successes),
            "frames": int(frames),
            "fer": round(1.0 - successes / frames, 6),
            "process_count": world,
            "device_count": mesh.size,
            "mesh": [mesh.shape["data"], mesh.shape["model"]],
            "backend": args.backend,
            "device": str(mesh.device),
            "launches": {k.__name__: n for k, n in zip(kernels, launches)},
            "seconds": seconds,
        }
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(summary))
        return summary
    return None


if __name__ == "__main__":
    main()
