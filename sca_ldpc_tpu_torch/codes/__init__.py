from .distance_spectrum import calc_ds, check_ds_addition_limit, gen_array_ds_multiplicity
from .make_code import (
    circular_qary_parity_check_block,
    fixed_weight_vec,
    flatten_matrix_parts,
    make_qary_qc_parity_check_matrix,
    make_qc_parity_check_matrix,
    make_regular_ldpc_parity_check_matrix,
    make_regular_ldpc_parity_check_matrix_identity,
    random_circulant_first_row,
)
from .layout import CirculantLayout, CodeLayout

__all__ = [
    "calc_ds",
    "check_ds_addition_limit",
    "gen_array_ds_multiplicity",
    "fixed_weight_vec",
    "flatten_matrix_parts",
    "circular_qary_parity_check_block",
    "make_qary_qc_parity_check_matrix",
    "make_qc_parity_check_matrix",
    "make_regular_ldpc_parity_check_matrix",
    "make_regular_ldpc_parity_check_matrix_identity",
    "random_circulant_first_row",
    "CodeLayout",
    "CirculantLayout",
]
