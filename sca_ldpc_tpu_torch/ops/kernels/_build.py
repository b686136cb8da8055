"""Build the package's CUDA sources with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``build/sca_ldpc_tpu_torch/lib<name>-<hash>.so`` at the root of the
checkout, then loaded with ``ctypes``.  The file name carries a hash of the
source and the flags, so an edited source is rebuilt and a stale library is
never loaded.  ``nvcc``'s ``-Xptxas -v`` report (registers, spills) is kept
beside the library as ``.log``.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "sca_ldpc_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME) / "bin" / "nvcc" if CUDA_HOME else None
    if nvcc is None or not nvcc.is_file():
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of sca_ldpc_tpu_torch are built at first "
            "use and need the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)"
        )
    return str(nvcc)


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    return ctypes.CDLL(str(build(name)))
