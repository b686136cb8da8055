"""Monte-Carlo frame-error-rate simulation, batched on the device.

Reference semantics: decode.py:130-177 (binary, one frame per Python-loop
iteration through ldpc.bp_decoder) and decode.py:180-286 (q-ary, the
all-zero codeword with noisy symbol distributions, one Rust decode per
thread-pool task).  Here a batch of frames is sampled on the device, all its
syndromes computed at once, and the whole batch decoded by one decoder call;
only per-batch counts cross to the host.  The thread pool of the reference
is replaced by the batch axis.
"""

import logging

import numpy as np
import torch

from ..channels.errors import ErrorsProvider
from ..codes.layout import CodeLayout
from ..ops.binary_bp import BinaryBPDecoder, _pad1
from ..ops.qary import QaryDecoder
from ..utils import make_random_state, rng_to_torch_generator
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)


def _syndromes(layout: CodeLayout, errors, chk_var, chk_mask):
    """[B, n] int errors -> [B, R] syndromes through the layout's gathers
    (``chk_var``/``chk_mask`` on the errors' device)."""
    b = errors.shape[0]
    bits = _pad1(errors).index_select(-1, chk_var.reshape(-1)).reshape(b, layout.r, layout.dc)
    return torch.sum(torch.where(chk_mask, bits, 0), dim=-1) % 2


def simulate_frame_error_rate(
    H,
    errors_provider: ErrorsProvider,
    runs: int,
    rng,
    max_iter=None,
    method="product_sum",
    batch_size=None,
    device="cuda",
):
    """Count successful decodings over ``runs`` random frames.

    API-compatible with decode.py:130-177; ``max_iter`` defaults to n like
    the reference's ``bp_decoder(..., max_iter=n)``, the batch to
    ``min(runs, 1024)``.  Errors are sampled on ``device`` from a
    ``torch.Generator`` made from ``rng`` (one host draw a batch, as the JAX
    package's key): statistically the reference's host loop, not its
    per-position RNG stream, so conformance is at the FER level.  The decode
    is :class:`BinaryBPDecoder`; the default device needs a CUDA device and
    raises without one.
    """
    H = np.asarray(H)
    n = H.shape[1]
    rng = make_random_state(rng)
    device = resolve_device(device)
    max_iter = int(max_iter if max_iter is not None else n)

    channel_probs = errors_provider.get_binary_channel_probs(n)
    if channel_probs == [None]:
        channel_probs = np.full(n, errors_provider.get_error_rate(), dtype=np.float32)
    else:
        channel_probs = np.asarray(channel_probs, dtype=np.float32)

    decoder = BinaryBPDecoder(H, max_iter=max_iter, method=method, channel_probs=channel_probs, device=device)
    layout = decoder.layout
    chk_var = torch.as_tensor(layout.chk_var, device=device).long()
    chk_mask = torch.as_tensor(layout.chk_mask, device=device)

    batch = int(batch_size or min(runs, 1024))
    successes = 0
    done = 0
    while done < runs:
        cur = min(batch, runs - done)
        errors = errors_provider.sample_batch(rng_to_torch_generator(rng, device), cur, n)
        decoded = decoder.decode_syndrome(_syndromes(layout, errors, chk_var, chk_mask))
        successes += int(torch.all(decoded == errors, dim=-1).sum())
        done += cur
    return successes


def simulate_frame_error_rate_qary(
    H,
    b_range,
    error_rate,
    runs,
    rng,
    iterations=5,
    batch_size=None,
    host_sampling=False,
    backend=None,
    early_exit=False,
    device="cuda",
):
    """Q-ary FER on the all-zero codeword with good/bad symbol distributions.

    Every position gets the near-uniform "good" distribution (correct symbol
    boosted) or, with probability ``error_rate``, the "bad" one (max symbol
    boosted); frames with no noisy symbol are resampled (decode.py:250-259).
    Returns ``(successes, max_errs_success, min_errs_fail)``.

    ``host_sampling=True`` replays the reference's exact per-position
    ``rng.rand()`` stream, so fixed seeds reproduce its frames bit for bit.
    Otherwise the mask is sampled on ``device`` with a ``torch.Generator``
    derived from ``rng`` (one host draw per batch and per resample round, as
    the JAX package's ``rng_to_jax_key``): statistically the same, not the
    same frames.  ``backend``/``early_exit`` go to :class:`QaryDecoder`.
    """
    H = np.asarray(H)
    n = H.shape[1]
    rng = make_random_state(rng)
    device = resolve_device(device)
    bb = 2 * b_range + 1

    p_lin = 1.0 / bb
    good = np.full(bb, p_lin, np.float32)
    bad = np.full(bb, p_lin, np.float32)
    good[[b_range, -1]] = [1.75 * p_lin, 0.25 * p_lin]
    bad[[-1, b_range]] = [1.75 * p_lin, 0.25 * p_lin]
    good_t = torch.from_numpy(good).to(device)
    bad_t = torch.from_numpy(bad).to(device)

    decoder = QaryDecoder(H.astype(np.int8), b_range, iterations, backend=backend,
                          early_exit=early_exit, device=device)

    batch = int(batch_size or min(runs, 256))
    successes = 0
    max_errs_success = 0
    min_errs_fail = None
    done = 0
    while done < runs:
        cur = min(batch, runs - done)
        if host_sampling:
            mask = np.zeros((cur, n), dtype=bool)
            for f in range(cur):
                while True:
                    row = rng.rand(n) < error_rate  # the same stream as n rng.rand() calls
                    if row.any():
                        mask[f] = row
                        break
            mask = torch.from_numpy(mask).to(device)
        else:
            gen = rng_to_torch_generator(rng, device)
            mask = torch.rand((cur, n), generator=gen, device=device) < error_rate
            empty = ~mask.any(dim=1)
            while bool(empty.any()):
                gen = rng_to_torch_generator(rng, device)
                redo = torch.rand((int(empty.sum()), n), generator=gen, device=device) < error_rate
                mask[empty] = redo
                empty = ~mask.any(dim=1)
        errs = mask.sum(dim=1)

        channel = torch.where(mask[:, :, None], bad_t, good_t)
        ok = (decoder.min_sum(channel) == 0).all(dim=1)
        n_ok, max_ok, min_fail = torch.stack(
            [ok.sum(), torch.where(ok, errs, 0).max(), torch.where(ok, n + 1, errs).min()]
        ).tolist()
        successes += n_ok
        if n_ok:
            max_errs_success = max(max_errs_success, max_ok)
        if n_ok < cur:
            min_errs_fail = min_fail if min_errs_fail is None else min(min_errs_fail, min_fail)
        done += cur

    logger.info(f"Highest number of noisy symbols corrected, per frame: {max_errs_success}")
    logger.info(f"Lowest number of noisy symbols that failed correction: {min_errs_fail}")
    return successes, max_errs_success, min_errs_fail
