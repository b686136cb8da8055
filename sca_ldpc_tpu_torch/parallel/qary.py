"""Several-rank q-ary and two-alphabet decoding.

Counterpart of the JAX package's ``parallel/qary.py``.  The reference's whole
q-ary parallelism is a host thread pool over independent
``decoder.min_sum`` calls (decode.py:247-277); here independent frames are a
batch axis split over the mesh's ranks:

- :func:`make_sharded_qary_fer_step`: the q-ary FER simulation
  (decode.py:180-286) with the channel sampled on the device (the good and
  bad symbol distributions are two [Q] rows selected by a Bernoulli error
  mask, so no [B, n, Q] tensor crosses from the host) and statistics reduced
  over the ranks (successes, the most noisy symbols corrected, the fewest
  that failed).  Every rank draws the whole mask, redraws included, from its
  generator (seeded alike on every rank) and keeps its own rows, so the
  frames do not depend on the number of ranks;
- :func:`make_sharded_special_decode`: the two-alphabet (Kyber) decode of
  many independent posterior sets, the instances split over the ranks and
  the decisions gathered.
"""

import numpy as np
import torch

from ..channels.llr import probs_to_llr
from ..ops import minplus
from ..ops.qary import QaryDecoder, _qary_min_sum


def qary_channel_rows(b_range):
    """The reference's good/bad per-position symbol distributions
    (decode.py:233-237): near-uniform with the correct (0) symbol boosted
    [good] or the max symbol boosted [bad].  Returns ``(good[Q], bad[Q])``."""
    bb = 2 * b_range + 1
    p_lin = 1.0 / bb
    good = np.full(bb, p_lin, np.float32)
    bad = np.full(bb, p_lin, np.float32)
    good[[b_range, -1]] = [1.75 * p_lin, 0.25 * p_lin]
    bad[[-1, b_range]] = [1.75 * p_lin, 0.25 * p_lin]
    return good, bad


def make_qary_fer_rows(decoder: QaryDecoder, error_rate, redraw_rounds=8):
    """A rank's part of the sharded q-ary FER step: ``rows(generator, batch,
    rows) -> (successes, max_errs_success, min_errs_fail)`` over the frames
    ``rows`` of a ``batch`` drawn whole, 0-d int64 tensors on the decoder's
    device; ``min_errs_fail`` is the global ``batch`` when none of them
    failed, ``max_errs_success`` 0 when none succeeded.

    The mask is drawn, then ``redraw_rounds`` times each frame without a
    noisy symbol takes a fresh draw (the reference re-samples on the host,
    decode.py:258-259).  The decode runs the decoder's backend without the
    early exit, as the JAX step does: K6 on the card for a decoder built with
    the default ``early_exit=False`` whose frames fit the kernel.
    """
    dev = decoder.device
    n = decoder.layout.n
    good, bad = qary_channel_rows(decoder.b)
    llr_good, llr_bad = (minplus.clip_inf(probs_to_llr(torch.from_numpy(r))).to(dev) for r in (good, bad))
    rate = float(error_rate)

    def decode(llr):
        if decoder.backend == "fused":
            return decoder._decode_llr(llr)
        return _qary_min_sum(*decoder._args, llr, decoder.max_iter, decoder.b, backend=decoder.backend,
                             early_exit=False)

    def local(generator, batch, rows):
        mask = torch.rand((batch, n), generator=generator, device=dev) < rate
        for _ in range(redraw_rounds):
            fresh = torch.rand((batch, n), generator=generator, device=dev) < rate
            mask = torch.where(mask.any(dim=1, keepdim=True), mask, fresh)
        mask = mask[rows]
        hard = decode(torch.where(mask[:, :, None], llr_bad, llr_good).contiguous())
        ok = torch.all(hard == 0, dim=-1)
        errs = mask.sum(dim=-1)
        return ok.sum(), torch.where(ok, errs, 0).max(), torch.where(ok, batch, errs).min()

    return local


def make_sharded_qary_fer_step(decoder: QaryDecoder, error_rate, mesh, redraw_rounds=8):
    """Build the sharded q-ary FER step: ``step(generator, batch) ->
    (successes, max_errs_success, min_errs_fail, frames)``, ``batch`` frames
    sampled, decoded and compared on the devices, split over ``mesh`` (a
    multiple of its size).  ``min_errs_fail`` is ``batch`` (the JAX step's
    "nothing failed") when no frame failed; ``max_errs_success`` is 0 when
    none succeeded.  The counts are 0-d tensors on the decoder's device,
    which is this rank's; ``generator`` lives there too, seeded alike on
    every rank.  See :func:`make_qary_fer_rows`."""
    local = make_qary_fer_rows(decoder, error_rate, redraw_rounds)

    def step(generator, batch):
        if batch % mesh.size:
            raise ValueError(f"batch {batch} is not a multiple of {mesh.size} ranks")
        succ, max_ok, min_fail = local(generator, batch, mesh.rows(batch))
        return (mesh.all_reduce(succ, "sum"), mesh.all_reduce(max_ok, "max"), mesh.all_reduce(min_fail, "min"),
                batch)

    return step


def sharded_qary_fer_simulation(decoder, error_rate, runs, generator, mesh, batch=None):
    """Run ``runs`` q-ary frames in sharded batches.

    Returns ``(successes, max_errs_success, min_errs_fail, frames)`` with
    the reference's None for min_errs_fail when nothing failed.  The JAX
    package's batch arithmetic: ``batch`` defaults to ``min(max(runs, W),
    64 W)`` for W ranks, every batch is a multiple of W, so ``frames`` may
    exceed ``runs``."""
    w = mesh.size
    if batch is None:
        batch = min(max(runs, w), 64 * w)
    batch = max(w, (batch // w) * w)
    step = make_sharded_qary_fer_step(decoder, error_rate, mesh)
    successes = 0
    max_ok = 0
    min_fail = None
    done = 0
    while done < runs:
        cur = min(batch, max(w, runs - done))
        cur = max(w, (cur // w) * w)
        s, mx, mn, frames = step(generator, cur)
        successes += int(s)
        max_ok = max(max_ok, int(mx))
        if int(mn) < int(frames):
            min_fail = int(mn) if min_fail is None else min(min_fail, int(mn))
        done += cur
    return successes, max_ok, min_fail, done


def make_sharded_special_decode(decoder, mesh):
    """Instance-sharded two-alphabet (Kyber) decode.

    Returns ``decode(channel_probs [I, N-R, 2B+1], channel_probs_sum
    [I, R, 2BSUM+1]) -> hard [I, N]`` on the decoder's device (this rank's),
    every rank passing the same inputs and getting every instance's
    decisions; rank ``r`` decodes its block of ``I / ranks`` instances
    through ``decoder.min_sum`` (K7 on the card where a frame fits).  I must
    be a multiple of the mesh's size."""
    def decode(p_b, p_s):
        i_n = len(p_b)
        if i_n % mesh.size:
            raise ValueError(f"instance count {i_n} not a multiple of {mesh.size} ranks")
        rows = mesh.rows(i_n)
        return mesh.all_gather(decoder.min_sum(p_b[rows], p_s[rows]))

    return decode
