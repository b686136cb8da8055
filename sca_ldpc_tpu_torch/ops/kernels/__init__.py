"""The port's hand-written CUDA kernels: each wrapper launches its kernel for
CUDA tensors and runs its plain PyTorch version (exported beside it) for CPU
tensors."""

from .circulant_cuda import (
    circulant_bp_cuda,
    circulant_bp_lean_cuda,
    circulant_bp_lean_plain,
    circulant_bp_plain,
    circulant_fer_cuda,
    circulant_fer_lean_cuda,
    circulant_fer_lean_plain,
    circulant_fer_plain,
)
from .qary_cuda import (
    chain_exclusive_cuda,
    chain_exclusive_plain,
    qary_min_sum_fused_cuda,
    qary_min_sum_fused_plain,
    qary_special_min_sum_fused_cuda,
    qary_special_min_sum_fused_plain,
)

__all__ = [
    "chain_exclusive_cuda",
    "chain_exclusive_plain",
    "circulant_bp_cuda",
    "circulant_bp_lean_cuda",
    "circulant_bp_lean_plain",
    "circulant_bp_plain",
    "circulant_fer_cuda",
    "circulant_fer_lean_cuda",
    "circulant_fer_lean_plain",
    "circulant_fer_plain",
    "qary_min_sum_fused_cuda",
    "qary_min_sum_fused_plain",
    "qary_special_min_sum_fused_cuda",
    "qary_special_min_sum_fused_plain",
]
