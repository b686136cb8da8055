"""Batched multi-instance HQC attacks.

Counterpart of the JAX package's ``models/hqc/batched.py``: I independent
attack instances (each with its own key, RNG, plaintexts and check set) run
on host threads, and their periodic LDPC decodes are batched into one device
call a round.  The adaptive per-instance control flow stays on the host.

The orchestration is a barrier batcher: an instance reaching a decode point
blocks until every live instance has one pending (instances advance at
matched cadences, one decode per DECODE_EVERY checks), then the last arrival
runs the round's decode for everyone, from its own thread on the current
CUDA stream.  Instances that finish deregister, shrinking the barrier.

The instances take turns: a thread holds the batcher's lock
(:meth:`BatchedDecodeExecutor.turn`) while its instance's host code runs and
gives it up only while it waits for a round.  Run side by side, the
instances' threads hand the GIL to one another at every numpy call that
releases it (the fast oracle's spectrum updates), a context switch each:
on the H100's 8-CPU host four instances took 18 s against 5.8 s one after
another (PERF.md).  Taking turns costs nothing the threads gained,
since the GIL ran one at a time anyway.

Unlike the JAX package, a round pads to its own largest check count and
block count (no compile-shape buckets: inert padding leaves the decisions
unchanged), a ``"circulant"`` round is ONE launch of K8 with per-instance
shifts ``[I, P, W]`` (each instance keeps its own early exit), and
checkpoints are named by instance index and seed, so equal seeds do not
share a file.  :class:`ShardedCirculantDecodeExecutor` splits each round's
instances over the ranks of a ``torch.distributed`` mesh.
"""

import hashlib
import logging
import os
import threading
import time

import numpy as np
import torch

from ...ops.binary_bp import decode_received_instances
from ...ops.circulant_bp import _multi_circulant_bp
from ...utils import make_random_state
from ...utils.device import resolve_device
from .attack import make_params, simulate_hqc_idealized_oracle

logger = logging.getLogger(__name__)


class BatchedDecodeExecutor:
    """Barrier batcher: collects one pending decode per live instance, runs
    them as one batched decode on ``device``, distributes the results (or
    the round's error, to every waiter).  ``seconds`` sums the rounds' own
    time (building the arrays, the decode, the statistics)."""

    def __init__(self, num_instances, max_iter=100, method="product_sum", device="cuda"):
        self._lock = threading.Condition(threading.RLock())
        self._live = num_instances
        self._pending = {}  # thread ident -> (decoder, tracking, checks, y_sparse)
        self._results = {}
        self._generation = 0
        self.max_iter = max_iter
        self.method = method
        self.device = torch.device(device)
        self.batched_calls = 0
        self.seconds = 0.0

    def turn(self):
        """The lock an instance's thread holds while its host code runs (a
        reentrant lock: :meth:`decode` gives it up while the instance waits
        for its round, and takes it back after), so that one instance runs
        at a time."""
        return self._lock

    def deregister(self):
        with self._lock:
            self._live -= 1
            if self._pending and len(self._pending) >= self._live:
                self._run_batch_locked()
                self._lock.notify_all()

    def decode(self, decoder, tracking, checks, y_sparse) -> bool:
        me = threading.get_ident()
        with self._lock:
            gen = self._generation
            self._pending[me] = (decoder, tracking, list(checks), list(y_sparse))
            if len(self._pending) >= self._live:
                self._run_batch_locked()
                self._lock.notify_all()
            else:
                self._lock.wait_for(lambda: me in self._results or self._generation > gen)
            result = self._results.pop(me)
            if isinstance(result, BaseException):
                raise result
            return result

    def _run_batch_locked(self):
        items = list(self._pending.items())
        self._pending.clear()
        self._generation += 1
        self.batched_calls += 1
        t0 = time.perf_counter()
        try:
            self._execute(items)
        except BaseException as e:  # passed on to every waiter, each raises it
            for tid, _ in items:
                self._results[tid] = e
        finally:
            self.seconds += time.perf_counter() - t0

    def _target_shape(self, items):
        r_pad = max(len(checks) for _tid, (_d, _t, checks, _y) in items)
        dv = max(dec.needed_dv() for _tid, (dec, _t, _c, _y) in items)
        return r_pad, dv

    def _execute(self, items):
        r_pad, dv = self._target_shape(items)
        builds = [(tid, dec, tr, checks, y, *dec.build_arrays(checks, y, r_pad=r_pad, dv=dv))
                  for tid, (dec, tr, checks, y) in items]
        logger.info(f"Batched decode: {len(items)} instances, R_pad={r_pad}, DV={dv}")
        decoded = decode_received_instances([b[5] for b in builds], [b[6] for b in builds], [b[7] for b in builds],
                                            self.max_iter, self.method, self.device)
        for i, (tid, dec, tr, checks, y, *_rest) in enumerate(builds):
            self._results[tid] = dec.stats_from_decoded(tr, decoded[i], checks, y)


class BatchedPaddedDecodeExecutor(BatchedDecodeExecutor):
    """Barrier batcher at persistent capacities: the padded check count and
    the variable-degree cap only grow (doubling) across rounds.  Batched
    counterpart of ``PaddedCheckDecoder``."""

    def __init__(self, num_instances, max_iter=100, method="product_sum", r_cap=4096, dv_cap=16, device="cuda"):
        super().__init__(num_instances, max_iter, method, device)
        self.r_cap = int(r_cap)
        self.dv_cap = int(dv_cap)

    def _target_shape(self, items):
        r = max(len(checks) for _tid, (_d, _t, checks, _y) in items)
        while r > self.r_cap:
            self.r_cap *= 2
        dv = max(dec.needed_dv() for _tid, (dec, _t, _c, _y) in items)
        while dv > self.dv_cap:
            self.dv_cap *= 2
        return self.r_cap, self.dv_cap


class BatchedCirculantDecodeExecutor(BatchedDecodeExecutor):
    """Barrier batcher over ``MaskedCirculantCheckDecoder`` instances: one
    masked full-circulant decode for all of them, ``_multi_circulant_bp``
    with per-instance shifts ``[I, P_pad, W]`` (one launch of K8 on the
    card), the decisions read back in one copy.  Instances with fewer
    plaintexts are padded with all-inert blocks to the round's largest
    block count."""

    def _execute(self, items):
        p_pad = max(len(dec._block_shifts) for _tid, (dec, _t, _c, _y) in items)
        builds = [(tid, dec, tr, checks, y, *dec.build_masked_arrays(checks, y, p_pad=p_pad))
                  for tid, (dec, tr, checks, y) in items]
        logger.info(f"Batched masked-circulant decode: {len(items)} instances, P_pad={p_pad}")
        prior_c, prior_i, syn, shifts = (torch.as_tensor(np.stack([b[k] for b in builds]), device=self.device)
                                         for k in (5, 6, 7, 8))
        e_c, e_i, _conv, _it = _multi_circulant_bp(prior_c, prior_i, syn, shifts, self.max_iter, self.method)
        n = e_c.shape[1]
        flat = torch.cat([e_c, e_i.reshape(len(builds), -1)], dim=1).cpu().numpy()  # one copy for the round
        for i, (tid, dec, tr, checks, y, *_rest) in enumerate(builds):
            self._results[tid] = dec.stats_from_masked(tr, flat[i, :n], flat[i, n:].reshape(p_pad, n), checks, y)


class ShardedCirculantDecodeExecutor(BatchedCirculantDecodeExecutor):
    """Barrier batcher whose rounds split over the ranks of a mesh
    (``parallel.make_mesh``): the batched attack's masked decodes through
    :func:`~sca_ldpc_tpu_torch.parallel.attack.make_sharded_masked_decode`,
    each rank decoding its block of the round's instances in one K8 launch on
    the mesh's device, the decisions gathered to every rank.

    SPMD, as a several-process JAX program is: every rank runs the same
    :func:`simulate_hqc_attacks_batched` on the same seeds and keys, so every
    rank builds the same rounds.  A round's instances are put in the order of
    their arrays' digests (the order threads reach the barrier differs
    between ranks), padded to a multiple of the mesh's size by repeating the
    last one, and the ranks compare the round's shape and digest before the
    launch: a rank whose round differs raises on every rank.

    ``crosscheck=True`` also decodes every instance alone on this rank
    (``_multi_circulant_bp``, what :class:`BatchedCirculantDecodeExecutor`
    runs for one instance) and raises unless the sharded decisions equal it.
    """

    def __init__(self, num_instances, mesh, max_iter=100, method="product_sum", crosscheck=False):
        super().__init__(num_instances, max_iter, method, mesh.device)
        from ...parallel.attack import make_sharded_masked_decode

        self.mesh = mesh
        self.crosscheck = crosscheck
        self._sharded_decode = make_sharded_masked_decode(mesh, max_iter=max_iter, method=method)

    def _execute(self, items):
        p_pad = max(len(dec._block_shifts) for _tid, (dec, _t, _c, _y) in items)
        builds = []
        for tid, (dec, tr, checks, y) in items:
            arrays = dec.build_masked_arrays(checks, y, p_pad=p_pad)
            digest = hashlib.sha256(b"".join(np.ascontiguousarray(a).tobytes() for a in arrays)).digest()
            builds.append((digest, tid, dec, tr, checks, y, *arrays))
        builds.sort(key=lambda b: b[0])
        pad = (-len(builds)) % self.mesh.size
        logger.info(f"Sharded masked-circulant decode: {len(builds)} instances (+{pad} pad) over "
                    f"{self.mesh.size} ranks, P_pad={p_pad}")
        round_digest = hashlib.sha256(b"".join(b[0] for b in builds)).digest()
        self.mesh.check_same([len(builds), p_pad, int.from_bytes(round_digest[:7], "little")], "the round")
        stack = [np.stack([b[k] for b in builds] + [builds[-1][k]] * pad) for k in (6, 7, 8, 9)]
        e_c, e_i, _conv = self._sharded_decode(*stack)
        n = e_c.shape[1]
        flat = torch.cat([e_c, e_i.reshape(len(e_c), -1)], dim=1)[: len(builds)].cpu().numpy()
        if self.crosscheck:
            for i, b in enumerate(builds):
                one = [torch.as_tensor(a[None], device=self.device) for a in b[6:9]]
                rc, ri, _cv, _it = _multi_circulant_bp(*one, torch.as_tensor(b[9], device=self.device),
                                                       self.max_iter, self.method)
                if not (np.array_equal(rc[0].cpu().numpy(), flat[i, :n])
                        and np.array_equal(ri[0].reshape(-1).cpu().numpy(), flat[i, n:])):
                    raise RuntimeError(f"the sharded decode differs from the single-device decode for instance {i} "
                                       "of the round")
        for i, (_digest, tid, dec, tr, checks, y, *_rest) in enumerate(builds):
            self._results[tid] = dec.stats_from_masked(tr, flat[i, :n], flat[i, n:].reshape(p_pad, n), checks, y)


EXECUTORS = {
    "general": BatchedDecodeExecutor,
    "padded": BatchedPaddedDecodeExecutor,
    "circulant": BatchedCirculantDecodeExecutor,
}


def checkpoint_name(index, seed):
    """The checkpoint file of instance ``index`` (its seed ``seed``): the
    index keeps two instances of one seed apart."""
    return f"instance_{index}_{seed}.ckpt"


def simulate_hqc_attacks_batched(
    seeds,
    decode_every: int,
    weight: int,
    error_rate=0.0,
    param_set="128",
    max_oracle_calls=None,
    oracle_backend="fast",
    decode_backend="general",
    executor=None,
    checkpoint_dir=None,
    device="cuda",
    **attack_kwargs,
):
    """Run len(seeds) independent attack instances with batched decodes.

    Each instance attacks its own random key (``params.HQC.keypair()``),
    on a thread of its own; the threads take turns (one runs its host code
    at a time, :meth:`BatchedDecodeExecutor.turn`).
    Returns ``(results, batched_calls)``: a list of (success, tracking) in
    seed order and the number of decode rounds.  ``decode_backend``:
    "circulant" batches masked full-circulant decodes, one K8 launch a round
    on the card; "padded" batches checks-only decodes at a persistent
    capacity; "general" batches checks-only decodes padded to the round's
    largest check count.  ``executor`` replaces the backend's executor.

    ``oracle_backend="timing"`` runs every instance against the measured
    timing channel: instances profile and calibrate their own keys and their
    cycle-timed measurement blocks serialize on
    ``eval_oracle.MEASUREMENT_LOCK``, while the decode rounds still batch on
    the device.  Extra ``attack_kwargs`` (``timing_measure``, ...) go to
    :func:`simulate_hqc_idealized_oracle`.

    ``checkpoint_dir``: per-instance mid-attack checkpoints
    (``instance_<index>_<seed>.ckpt``) written at every clean point; on a
    relaunch with the same seeds each instance with a checkpoint resumes its
    exact state and the others start fresh; a recovered instance's
    checkpoint is deleted.  ``device``: where the decodes run; the default
    needs a CUDA device and raises without one.  An instance that fails
    raises its error here once every instance has ended.
    """
    device = resolve_device(device)
    if executor is None:
        if decode_backend not in EXECUTORS:
            raise ValueError(f"unknown decode_backend: {decode_backend}")
        executor = EXECUTORS[decode_backend](len(seeds), device=device)
    results = [None] * len(seeds)
    errors = [None] * len(seeds)
    params = make_params(param_set, decode_every, weight, error_rate)
    keypairs = [params.HQC.keypair() for _ in seeds]
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)

    def run(i, seed):
        ckpt_path = os.path.join(checkpoint_dir, checkpoint_name(i, seed)) if checkpoint_dir else None
        with executor.turn():
            run_instance(i, seed, ckpt_path)

    def run_instance(i, seed, ckpt_path):
        try:
            results[i] = simulate_hqc_idealized_oracle(
                make_random_state(seed),
                decode_every,
                weight,
                keyfile=None,
                error_rate=error_rate,
                param_set=param_set,
                max_oracle_calls=max_oracle_calls,
                oracle_backend=oracle_backend,
                decode_executor=executor,
                decode_backend=decode_backend,
                keypair=keypairs[i],
                checkpoint_path=ckpt_path,
                resume=bool(ckpt_path and os.path.exists(ckpt_path)),
                device=device,
                **attack_kwargs,
            )
            if ckpt_path and results[i][0] and os.path.exists(ckpt_path):
                os.remove(ckpt_path)  # a recovered key must not be resumed
        except BaseException as e:  # raised below, once every instance has ended
            errors[i] = e
        finally:
            executor.deregister()

    threads = [threading.Thread(target=run, args=(i, s), daemon=True) for i, s in enumerate(seeds)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    logger.info(f"Batched run: {executor.batched_calls} batched decode calls")
    return results, executor.batched_calls
