"""The secret of an HQC key, read through the victim library's C interface.

The key file is the pickled ``(public key, secret key)`` byte pair of the
repository's fixtures.  ``hqc_secrets_from_key`` of ``csrc/libhqc_core.so``
expands the secret key into the support of ``y``, which the attack recovers.
This binding is the benchmark's own: it shares no code with the program's.
"""

import ctypes
import io
import pickle
from pathlib import Path

import numpy as np

_VERSIONS = {"128": 0, "192": 1, "256": 2}


class _BytesOnly(pickle.Unpickler):
    """Unpickles tuples of bytes and nothing that names a class."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(f"key file names {module}.{name}: not a pair of byte strings")


def read_keypair(path):
    """(public key, secret key) bytes from a pickled key file."""
    key = _BytesOnly(io.BytesIO(Path(path).read_bytes())).load()
    if not (isinstance(key, tuple) and len(key) == 2 and all(isinstance(k, (bytes, bytearray)) for k in key)):
        raise ValueError(f"{path} does not hold an HQC (public, private) byte pair")
    return bytes(key[0]), bytes(key[1])


def secret_y(library, param_set, secret_key):
    """Sorted support of ``y`` of ``secret_key`` under the HQC parameter set
    ``param_set`` ("128", "192" or "256")."""
    lib = ctypes.CDLL(str(library))
    ver = _VERSIONS[str(param_set)]
    lib.hqc_param.restype = ctypes.c_longlong
    lib.hqc_param.argtypes = [ctypes.c_int, ctypes.c_char_p]
    lib.hqc_secrets_from_key.restype = ctypes.c_int
    u8p, u32p, u64p = (ctypes.POINTER(t) for t in (ctypes.c_uint8, ctypes.c_uint32, ctypes.c_uint64))
    lib.hqc_secrets_from_key.argtypes = [ctypes.c_int, u8p, u64p, u32p]
    n, omega = (int(lib.hqc_param(ver, what)) for what in (b"N", b"OMEGA"))
    sk = np.frombuffer(secret_key, dtype=np.uint8).copy()
    x = np.zeros((n + 63) // 64, dtype=np.uint64)
    y = np.zeros(omega, dtype=np.uint32)
    got = lib.hqc_secrets_from_key(ver, sk.ctypes.data_as(u8p), x.ctypes.data_as(u64p), y.ctypes.data_as(u32p))
    if got != omega:
        raise RuntimeError(f"hqc_secrets_from_key returned {got}, expected {omega}")
    return sorted(int(v) for v in y)
