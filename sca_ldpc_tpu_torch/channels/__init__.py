from .llr import binary_prior_llr, probs_to_llr

__all__ = ["binary_prior_llr", "probs_to_llr"]
