from .attack import make_sharded_masked_decode
from .distributed import init_distributed
from .fer import fer_simulation, make_fer_step, make_sharded_fer_step, sharded_fer_simulation
from .kyber import kyber_attack_simulation, kyber_channels, kyber_draw, kyber_tables, make_kyber_attack_step
from .mesh import Mesh, make_mesh
from .qary import make_sharded_qary_fer_step, make_sharded_special_decode, sharded_qary_fer_simulation

__all__ = [
    "Mesh",
    "fer_simulation",
    "init_distributed",
    "kyber_attack_simulation",
    "kyber_channels",
    "kyber_draw",
    "kyber_tables",
    "make_fer_step",
    "make_kyber_attack_step",
    "make_mesh",
    "make_sharded_fer_step",
    "make_sharded_masked_decode",
    "make_sharded_qary_fer_step",
    "make_sharded_special_decode",
    "sharded_fer_simulation",
    "sharded_qary_fer_simulation",
]
