"""Fast incremental decoding oracle for the HQC attack.

The attack probes thousands of single-bit ciphertext modifications per
recovered parity check, each probe asking only "does decoding still succeed?"
(hqc.py:782-871 drives a full decapsulation per probe through liboqs).

Key observations (the JAX package's redesign of the oracle hot loop, kept
here in NumPy on the host):
- With the idealized construction the decoder input is
  ``base = v - u*y`` (native ``decode_intermediates`` exposes it once);
  any probe is that base XOR a sparse flip set.
- RM(1,7) block decoding is an argmax over the Walsh-Hadamard spectrum of
  the block's multiplicity-summed +-1 vector.  Flipping ONE bit changes one
  position of that vector by -+2, so the whole 128-point spectrum updates
  with a rank-1 add of a Hadamard row — no transform, no decapsulation.
- Bounded-distance RS decoding succeeds iff at most DELTA of the N1 block
  symbols decode wrongly, so the oracle answer is a wrong-block counter.

A probe therefore costs a 128-element update + argmax (vs a full decaps),
and candidate batches vectorize: `probe_bits` evaluates C candidates as
[C, 128] array ops; the base spectra are one [N1, 128] x [128, 128] product.

Exactness: equivalence with the native decode path is enforced by
tests/test_torch_hqc_model.py over random flip sets, and the attack can
cross-check continuously (oracle_backend="fast" + crosscheck_every).
"""

import logging

import numpy as np

logger = logging.getLogger(__name__)

_H128 = None


def hadamard_128():
    global _H128
    if _H128 is None:
        h = np.array([[1]], dtype=np.int32)
        for _ in range(7):
            h = np.block([[h, h], [h, -h]])
        _H128 = h
    return _H128


def _rm_decode_from_spectrum(W):
    """[..., 128] spectra -> decoded RM symbols (argmax |W|, sign -> msb).

    Matches csrc/hqc_core.cpp rm_decode_block: first maximal index wins.
    """
    aw = np.abs(W)
    u = np.argmax(aw, axis=-1)
    wv = np.take_along_axis(W, u[..., None], axis=-1)[..., 0]
    return np.where(wv < 0, u | 0x80, u).astype(np.uint8)


class FastCiphertextState:
    """Decoder-input state of one (possibly modified) ciphertext.

    Tracks, per RM block: the multiplicity-summed +-1 vector's Walsh
    spectrum ``W[N1, 128]`` and whether the block currently decodes to the
    right RS symbol.  Bit indices follow the attack's v-bit numbering
    (block * N2 + bit), matching toggle_bits_in_v semantics.
    """

    def __init__(self, params, input_bits, rs_symbols):
        self.params = params
        self.n1 = params.HQC.params("N1")
        self.n2 = params.HQC.params("N2")
        self.mult = self.n2 // 128
        self.delta = params.HQC.params("DELTA")
        self.bits = np.asarray(input_bits, dtype=np.int8).copy()  # [n1*n2]
        self.rs_symbols = np.asarray(rs_symbols, dtype=np.uint8)  # [n1]

        # f[b, j] = sum over copies of (1 - 2*bit)
        pm = 1 - 2 * self.bits.reshape(self.n1, self.mult, 128).astype(np.int32)
        f = pm.sum(axis=1)
        self.W = f @ hadamard_128()  # [n1, 128]
        self._refresh_wrong()

    @classmethod
    def from_ciphertext(cls, params, ct, priv, pt):
        """Build from one native decapsulation (the only decaps needed)."""
        _pt2, rs_enc, _rm, inp, _u, _v = params.HQC.decode_intermediates(ct, priv)
        n1n2 = params.HQC.params("N1N2")
        bits = np.unpackbits(np.frombuffer(bytes(inp), np.uint8), bitorder="little")[
            :n1n2
        ]
        # true RS codeword symbols of the attacked plaintext
        from .model import _lib, _buf, _out

        lib = _lib()
        _ptb, ptp = _buf(pt)
        cw, cwp = _out(params.HQC.params("N1"))
        lib.hqc_rs_encode(params.HQC.VER, ptp, cwp)
        return cls(params, bits, cw)

    def _refresh_wrong(self):
        decoded = _rm_decode_from_spectrum(self.W)
        self.wrong = decoded != self.rs_symbols
        self.wrong_count = int(self.wrong.sum())

    def copy(self):
        new = object.__new__(FastCiphertextState)
        new.params = self.params
        new.n1, new.n2, new.mult, new.delta = self.n1, self.n2, self.mult, self.delta
        new.bits = self.bits.copy()
        new.rs_symbols = self.rs_symbols
        new.W = self.W.copy()
        new.wrong = self.wrong.copy()
        new.wrong_count = self.wrong_count
        return new

    def decode_success(self) -> bool:
        return self.wrong_count <= self.delta

    # -- mutations ----------------------------------------------------------

    def toggle_bits(self, bit_indices):
        """Flip v-bits in place (incremental spectrum update per block)."""
        idx = np.asarray(list(bit_indices), dtype=np.int64)
        if idx.size == 0:
            return self
        blocks = idx // self.n2
        pos = (idx % self.n2) % 128
        delta = (4 * self.bits[idx].astype(np.int32) - 2)  # -2 if bit 0->1 else +2
        H = hadamard_128()
        np.add.at(self.W, (blocks[:, None], np.arange(128)[None, :]), delta[:, None] * H[pos])
        self.bits[idx] ^= 1
        changed = np.unique(blocks)
        decoded = _rm_decode_from_spectrum(self.W[changed])
        self.wrong_count += int((decoded != self.rs_symbols[changed]).sum()) - int(
            self.wrong[changed].sum()
        )
        self.wrong[changed] = decoded != self.rs_symbols[changed]
        return self

    def toggle_block(self, block):
        """Flip a whole RM block: the spectrum negates."""
        self.W[block] = -self.W[block]
        b0 = block * self.n2
        self.bits[b0 : b0 + self.n2] ^= 1
        decoded = _rm_decode_from_spectrum(self.W[block][None])[0]
        was = bool(self.wrong[block])
        now = decoded != self.rs_symbols[block]
        self.wrong[block] = now
        self.wrong_count += int(now) - int(was)
        return self

    # -- probes (no state change) ------------------------------------------

    def probe_bit(self, bit) -> bool:
        """Decoding success if v-bit ``bit`` were flipped."""
        return bool(self.probe_bits([bit])[0])

    def probe_bits(self, bit_indices) -> np.ndarray:
        """Vectorized: for each candidate single-bit flip, would decoding
        succeed?  [C] bool."""
        idx = np.asarray(list(bit_indices), dtype=np.int64)
        blocks = idx // self.n2
        pos = (idx % self.n2) % 128
        delta = (4 * self.bits[idx].astype(np.int32) - 2)
        H = hadamard_128()
        W_new = self.W[blocks] + delta[:, None] * H[pos]  # [C, 128]
        decoded = _rm_decode_from_spectrum(W_new)
        now_wrong = decoded != self.rs_symbols[blocks]
        counts = self.wrong_count - self.wrong[blocks].astype(int) + now_wrong.astype(int)
        return counts <= self.delta

    def probe_block(self, block) -> bool:
        decoded = _rm_decode_from_spectrum(-self.W[block][None])[0]
        now = decoded != self.rs_symbols[block]
        count = self.wrong_count - int(self.wrong[block]) + int(now)
        return count <= self.delta
