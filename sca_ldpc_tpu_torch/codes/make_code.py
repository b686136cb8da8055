"""Parity-check matrix construction (host-side NumPy).

So far only the random circulant of the HQC attack code: its first row, with
distance-spectrum multiplicity at most 1 (reference: make_code.py:220-273).
The RNG draw sequence matches the reference, so fixed seeds give the same
codes in this package and in ``sca_ldpc_tpu``.
"""

from . import distance_spectrum
from ..utils import make_random_state


def random_circulant_first_row(n, weight, seed=None):
    """First row only of the DS-constrained random circulant — the memory-lean
    entry point for large N (HQC-256: N=57637), paired with
    :class:`~sca_ldpc_tpu_torch.codes.layout.CirculantLayout` instead of a
    dense H."""
    return distance_spectrum.gen_array_ds_multiplicity(n, weight, 1, make_random_state(seed))
