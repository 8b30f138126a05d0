"""Transcription inference engine."""

from mr_mt3_tpu_torch.infer.handler import InferenceHandler
