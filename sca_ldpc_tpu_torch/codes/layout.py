"""Device layout of the circulant parity-check matrices.

:class:`CirculantLayout` is the fast path for (quasi-)circulant codes (the HQC
attack matrix, make_code.py:220-273).  Each nonzero diagonal of the circulant
is one ``[batch, N]`` message plane; check/variable alignment is a cyclic
shift per plane, which the CUDA kernel does as index arithmetic on the load.
"""

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CirculantLayout:
    """Layout for ``H = circulant(first_row)`` or ``H = [circulant | I]``.

    ``circulant(c)[i, j] = c[(i - j) mod n]``, so check ``i`` touches variables
    ``(i - k) mod n`` for each support offset ``k`` — one message plane per
    offset.  The optional identity block contributes one extra variable per
    check, already check-aligned (no shift needed).
    """

    n: int
    shifts: tuple  # support offsets k of the first row
    with_identity: bool

    @property
    def weight(self) -> int:
        return len(self.shifts)

    @property
    def n_vars(self) -> int:
        return self.n * 2 if self.with_identity else self.n

    @classmethod
    def from_first_row(cls, first_row: np.ndarray, with_identity: bool) -> "CirculantLayout":
        shifts = tuple(int(k) for k in np.flatnonzero(np.asarray(first_row)))
        return cls(n=len(first_row), shifts=shifts, with_identity=with_identity)

    @classmethod
    def from_reference(cls, obj) -> "CirculantLayout":
        """The same code as any object with ``n``, ``shifts`` and
        ``with_identity`` attributes, such as the JAX package's layout."""
        return cls(
            n=int(obj.n),
            shifts=tuple(int(k) for k in obj.shifts),
            with_identity=bool(obj.with_identity),
        )

    def to_dense(self) -> np.ndarray:
        from scipy.linalg import circulant

        row = np.zeros(self.n, dtype=int)
        row[list(self.shifts)] = 1
        H = circulant(row)
        if self.with_identity:
            H = np.concatenate([H, np.identity(self.n, dtype=int)], axis=1)
        return H
