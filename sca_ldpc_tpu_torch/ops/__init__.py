from .circulant_bp import CirculantBPDecoder
from .qary import QaryDecoder
from .qary_special import QarySpecialDecoder
from .registry import decoder_name_for, get_decoder_by_name

__all__ = [
    "CirculantBPDecoder",
    "QaryDecoder",
    "QarySpecialDecoder",
    "decoder_name_for",
    "get_decoder_by_name",
]
