from .circulant_bp import CirculantBPDecoder

__all__ = [
    "CirculantBPDecoder",
]
