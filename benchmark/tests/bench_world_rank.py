"""One rank of a four-rank FER run on the CPU (gloo), for the fault test:
``python -m benchmark.tests.bench_world_rank <rendezvous file> <fault> <rank>``.
Fault ``no_exchange`` leaves the all-reduce between the ranks out; rank 0
prints whether the run came out correct."""

import sys

import torch

from benchmark import run as bench
from benchmark.tests.test_bench_faults import sharded_cell


def main(rdv, fault, rank):
    torch.set_num_threads(1)
    if fault == "no_exchange":
        from sca_ldpc_tpu_torch.parallel.mesh import Mesh

        Mesh.all_reduce = lambda self, x, op="sum": x
    cell = sharded_cell()
    ctx = bench.Context(cell, 2**31 + 777, 1.0, 0, rank, 4, torch.device("cpu"), rdv)
    result = bench.driver_module(cell.traffic).run(ctx)
    if rank == 0:
        print(bench.result_line(cell, result, 0, "cpu")["correct"])


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]))
