"""Probability -> LLR conversions on tensors.

Two conventions coexist in the reference and both are kept:

- Binary BP uses the standard log-likelihood ratio ``L = ln(P(0) / P(1))``
  built from per-position error probabilities (decode.py:155-161).
- The q-ary decoders use "min-sum LLRs" relative to the most likely symbol:
  ``llr[d] = ln(max_p / p[d])`` with ``+inf`` for zero-probability symbols
  (reference: decoder.rs:668-692 ``into_llr``).
"""

import torch


def binary_prior_llr(p_error):
    """LLR of a binary prior: ``ln((1-p)/p)`` elementwise."""
    p = torch.clamp(torch.as_tensor(p_error, dtype=torch.float32), 1e-30, 1.0 - 1e-12)
    return torch.log((1.0 - p) / p)


def probs_to_llr(probs, axis=-1, validate=False):
    """Q-ary min-sum LLRs: ``ln(max / p)`` along ``axis``; zeros map to +inf.

    Matches decoder.rs:668-692 exactly (including that probabilities are
    assumed to sum to ~1; set ``validate=True`` to check it like the Rust
    code does: ``ValueError`` unless every sum along ``axis`` is 1 +- 0.001).
    """
    probs = torch.as_tensor(probs, dtype=torch.float32)
    if validate and not bool(torch.all(torch.abs(probs.sum(dim=axis) - 1.0) < 1e-3)):
        raise ValueError("channel probabilities must sum to 1 (+-0.001)")
    mx = torch.amax(probs, dim=axis, keepdim=True)
    pos = probs > 0
    return torch.where(pos, torch.log(mx / torch.where(pos, probs, 1.0)), torch.inf)
