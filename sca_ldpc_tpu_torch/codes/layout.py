"""Device layouts of sparse parity-check matrices (host-side NumPy).

- :class:`CodeLayout` — general padded adjacency.  Messages live check-major
  as ``[batch, R, DC, ...]`` tensors; variable-side access goes through a
  precomputed flat gather index.  Padding slots point at one sentinel
  position that holds the reduction identity, so irregular codes (the
  reference's ``Option`` slots, decoder.rs:39,66) cost nothing but masked
  lanes.
- :class:`CirculantLayout` — the fast path for (quasi-)circulant codes (the
  HQC attack matrix, make_code.py:220-273).  Each nonzero diagonal of the
  circulant is one ``[batch, N]`` message plane; check/variable alignment is
  a cyclic shift per plane, which the CUDA kernel does as index arithmetic on
  the load.
"""

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CodeLayout:
    """Padded sparse adjacency for an R x N parity-check matrix with entries
    in {-1, 0, +1}; every field equals the JAX package's ``CodeLayout``."""

    n: int
    r: int
    dc: int  # max check degree (nonzeros per row)
    dv: int  # max variable degree (nonzeros per column)
    n_edges: int
    # Check-major adjacency, shape [R, DC]; pad slots hold var index == n.
    chk_var: np.ndarray  # int32
    chk_sign: np.ndarray  # int8, pad +1
    chk_mask: np.ndarray  # bool
    chk_deg: np.ndarray  # int32 [R], real slots per check
    # Variable-major indirection into the flattened [R*DC + 1] message array;
    # pad slots point at the sentinel R*DC.
    var_flat: np.ndarray  # int32 [N, DV]
    var_sign: np.ndarray  # int8 [N, DV], pad +1
    var_mask: np.ndarray  # bool [N, DV]
    var_deg: np.ndarray  # int32 [N]

    @property
    def flat_size(self) -> int:
        return self.r * self.dc + 1

    @classmethod
    def from_h(cls, H: np.ndarray, dc: int | None = None, dv: int | None = None) -> "CodeLayout":
        H = np.asarray(H)
        rows, cols = np.nonzero(H)  # row-major, as the reference inserts edges (decoder.rs:507-539)
        signs = H[rows, cols].astype(np.int8)
        return cls.from_edges(H.shape[0], H.shape[1], rows, cols, signs, dc=dc, dv=dv)

    @classmethod
    def from_edges(cls, r, n, rows, cols, signs=None, dc=None, dv=None) -> "CodeLayout":
        """Vectorized construction from an edge list in row-major order,
        without a dense H."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        e = len(rows)
        signs = np.ones(e, dtype=np.int8) if signs is None else np.asarray(signs, dtype=np.int8)
        deg_c = np.bincount(rows, minlength=r)
        deg_v = np.bincount(cols, minlength=n)
        dc = int(dc if dc is not None else (deg_c.max() if e else 1))
        dv = int(dv if dv is not None else (deg_v.max() if e else 1))
        if e and (deg_c.max() > dc or deg_v.max() > dv):
            raise ValueError("H exceeds the requested dc/dv bounds")

        starts_c = np.zeros(r, dtype=np.int64)
        np.cumsum(deg_c[:-1], out=starts_c[1:])
        chk_slot = np.arange(e) - starts_c[rows]

        chk_var = np.full((r, dc), n, dtype=np.int32)
        chk_sign = np.ones((r, dc), dtype=np.int8)
        chk_mask = np.zeros((r, dc), dtype=bool)
        chk_var[rows, chk_slot] = cols
        chk_sign[rows, chk_slot] = signs
        chk_mask[rows, chk_slot] = True

        # Variable-side slots: edges sorted by (col, row), the reference's
        # per-variable insertion order.
        order = np.lexsort((rows, cols))
        cols_s = cols[order]
        starts_v = np.zeros(n, dtype=np.int64)
        np.cumsum(deg_v[:-1], out=starts_v[1:])
        var_slot = np.arange(e) - starts_v[cols_s]

        var_flat = np.full((n, dv), r * dc, dtype=np.int32)
        var_sign = np.ones((n, dv), dtype=np.int8)
        var_mask = np.zeros((n, dv), dtype=bool)
        flat_pos = (rows * dc + chk_slot).astype(np.int32)
        var_flat[cols_s, var_slot] = flat_pos[order]
        var_sign[cols_s, var_slot] = signs[order]
        var_mask[cols_s, var_slot] = True

        return cls(
            n=int(n),
            r=int(r),
            dc=dc,
            dv=dv,
            n_edges=int(e),
            chk_var=chk_var,
            chk_sign=chk_sign,
            chk_mask=chk_mask,
            chk_deg=deg_c.astype(np.int32),
            var_flat=var_flat,
            var_sign=var_sign,
            var_mask=var_mask,
            var_deg=deg_v.astype(np.int32),
        )


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
