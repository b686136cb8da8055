"""The HQC key-recovery attack: the native HQC model binding, the attack's
parameters and tracking, the fast oracle, the measured timing oracle, the
attack itself with its three decode backends (``"general"``, ``"padded"``,
``"circulant"``), and batched multi-instance attacks."""

from .model import Hqc128, Hqc192, Hqc256, hqc_by_param_set
from .tracking import HqcSimulationParams, HqcSimulationTracking
from .attack import (
    read_or_generate_keypair,
    search_distinguishable_plaintext,
    simulate_hqc_idealized_oracle,
    sparse_times_sparse,
    shift_and_add_mod_2_sparse,
    toggle_bits_in_v,
    toggle_outer_block,
)
from .batched import simulate_hqc_attacks_batched

__all__ = [
    "Hqc128",
    "Hqc192",
    "Hqc256",
    "hqc_by_param_set",
    "HqcSimulationParams",
    "HqcSimulationTracking",
    "read_or_generate_keypair",
    "search_distinguishable_plaintext",
    "simulate_hqc_idealized_oracle",
    "simulate_hqc_attacks_batched",
    "sparse_times_sparse",
    "shift_and_add_mod_2_sparse",
    "toggle_bits_in_v",
    "toggle_outer_block",
]
