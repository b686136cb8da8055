from .fer import fer_simulation, make_fer_step

__all__ = [
    "fer_simulation",
    "make_fer_step",
]
