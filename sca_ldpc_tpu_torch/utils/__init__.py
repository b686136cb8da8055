from .rng import make_random_state, rng_to_torch_generator

__all__ = [
    "make_random_state",
    "rng_to_torch_generator",
]
