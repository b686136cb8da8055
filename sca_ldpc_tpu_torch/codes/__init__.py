from .distance_spectrum import calc_ds, check_ds_addition_limit, gen_array_ds_multiplicity
from .make_code import random_circulant_first_row
from .layout import CirculantLayout

__all__ = [
    "calc_ds",
    "check_ds_addition_limit",
    "gen_array_ds_multiplicity",
    "random_circulant_first_row",
    "CirculantLayout",
]
