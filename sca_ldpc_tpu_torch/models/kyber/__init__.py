from .params import Q, ETA, BLOCK_LEN, NUM_BLOCKS, secret_range, secret_range_len, to_zq_range
from .secrets import (
    sample_secret_coefs,
    secret_distribution,
    gen_ldpc_matrix,
    compute_ssum,
    generate_secret,
    generate_secret_for_H,
)
from .patterns import (
    coding_from_patterns,
    get_closest_accuracy,
    get_patterns,
    get_restricted_single_patterns,
    get_single_patterns,
    get_sum_patterns,
    pattern_four_consecutive,
)
from .pipeline import (
    get_channel_probabilities,
    get_decoder,
    simulate_kyber_attack,
    simulate_kyber_attack_adaptive,
)

__all__ = [
    "Q", "ETA", "BLOCK_LEN", "NUM_BLOCKS",
    "secret_range", "secret_range_len", "to_zq_range",
    "sample_secret_coefs", "secret_distribution", "gen_ldpc_matrix",
    "compute_ssum", "generate_secret", "generate_secret_for_H",
    "coding_from_patterns", "get_closest_accuracy", "get_patterns",
    "get_restricted_single_patterns", "get_single_patterns", "get_sum_patterns",
    "pattern_four_consecutive",
    "get_channel_probabilities", "get_decoder", "simulate_kyber_attack",
    "simulate_kyber_attack_adaptive",
]
