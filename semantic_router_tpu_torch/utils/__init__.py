from .device import resolve_device
from .tokenization import (
    Encoding,
    EncodingCache,
    HashTokenizer,
    HFTokenizer,
    Tokenizer,
    decode_entity_spans,
    encode_windows,
)

__all__ = [
    "Encoding",
    "EncodingCache",
    "HashTokenizer",
    "HFTokenizer",
    "Tokenizer",
    "decode_entity_spans",
    "encode_windows",
    "resolve_device",
]
