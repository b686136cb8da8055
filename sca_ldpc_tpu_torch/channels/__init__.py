from .errors import ErrorsProvider
from .llr import binary_prior_llr, probs_to_llr

__all__ = ["ErrorsProvider", "binary_prior_llr", "probs_to_llr"]
