"""Native (C++) host components, loaded with ctypes (copy of
mr_mt3_tpu/native): the FLAC codec (native/flac.cc) and the per-song
tokenizer core (native/tokenizer.cc, held equal to the Python RLE loop).
Each library is built by g++ at first use into mr_mt3_tpu_torch/_build/
(native/_loader.py); importing builds nothing.
"""

from mr_mt3_tpu_torch.native.flac import (
    decode_flac_bytes,
    encode_flac_bytes,
    flac_available,
    read_flac,
)
from mr_mt3_tpu_torch.native.tokenizer import (
    encode_and_index_events_native,
    native_available,
)
