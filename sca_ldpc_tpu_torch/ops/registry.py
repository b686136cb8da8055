"""Decoder geometry registry.

The reference registers const-generic decoder instances under names like
``DecoderN450R150V3C7B1`` / ``DecoderN1280R512SW6`` (lib.rs:32-75) and
selects them by string reflection (decode.py:227-229, kyber.py:379-435).
Here any geometry is constructible, so the registry is a name parser: the
same name strings resolve to decoders with shapes validated against H.
"""

import re

import numpy as np

from .qary import QaryDecoder
from .qary_special import QarySpecialDecoder

_PLAIN = re.compile(r"^DecoderN(\d+)R(\d+)V(\d+)C(\d+)B(\d+)$")
_SPECIAL = re.compile(r"^DecoderN(\d+)R(\d+)SW(\d+)$")


def get_decoder_by_name(name, H, iterations, eta=2, **kwargs):
    """Construct the decoder a reference instance name denotes.

    - ``DecoderN{n}R{r}V{dv}C{dc}B{b}`` -> :class:`QaryDecoder` (decoder.rs
      semantics);
    - ``DecoderN{n}R{r}SW{sw}`` -> :class:`QarySpecialDecoder`, the
      two-alphabet decoder with B = eta, BSUM = sw*eta (decoder_special.rs
      semantics; eta = 2 for Kyber-768, the registered instances of
      lib.rs:53-75).

    ``kwargs`` go to the decoder (``backend``, ``device``, ...).
    """
    H = np.asarray(H, dtype=np.int8)
    m = _PLAIN.match(name)
    if m:
        n, r, dv, dc, b = map(int, m.groups())
        if H.shape != (r, n):
            raise ValueError(f"{name}: H shape {H.shape} != ({r}, {n})")
        return QaryDecoder(H, b_range=b, max_iter=iterations, dc=dc, dv=dv, **kwargs)
    m = _SPECIAL.match(name)
    if m:
        n, r, sw = map(int, m.groups())
        if H.shape != (r, n):
            raise ValueError(f"{name}: H shape {H.shape} != ({r}, {n})")
        return QarySpecialDecoder(H, b=eta, bsum=sw * eta, max_iter=iterations, sw=sw, **kwargs)
    raise ValueError(f"unrecognized decoder name: {name}")


def decoder_name_for(H, b):
    """Name a plain q-ary geometry like decode.py:218-227 does."""
    H = np.asarray(H)
    r, n = H.shape
    v = int(np.count_nonzero(H, axis=0).max())
    c = int(np.count_nonzero(H, axis=1).max())
    return f"DecoderN{n}R{r}V{v}C{c}B{b}"
