from .circulant_bp import CirculantBPDecoder
from .qary import QaryDecoder
from .registry import decoder_name_for, get_decoder_by_name

__all__ = [
    "CirculantBPDecoder",
    "QaryDecoder",
    "decoder_name_for",
    "get_decoder_by_name",
]
