"""Audio frontend: log-mel spectrograms (torch) and WAV I/O (numpy)."""

from mr_mt3_tpu_torch.audio.frontend import (
    MAX_LOG_MEL,
    MIN_LOG_MEL,
    SpectrogramConfig,
    compute_logmel,
    normalize_logmel,
)
from mr_mt3_tpu_torch.audio.io import (
    read_audio,
    read_wav,
    read_wav_bytes,
    resample,
    write_wav,
)
