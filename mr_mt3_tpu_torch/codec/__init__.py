"""Token codec & MIDI-event ontology (host-side, pure Python/NumPy).

Behavior-compatible rebuild of the reference's vendored mt3 codec layer
(reference: contrib/event_codec.py, contrib/vocabularies.py,
contrib/run_length_encoding.py, contrib/note_sequences.py,
contrib/metrics_utils.py, contrib/preprocessor.py). Token table:

  shift     0-1000     (steps_per_second=100, max_shift_seconds=10)
  pitch     1001-1128
  velocity  1129-1130  (num_velocity_bins=1: bin 0 = note off)
  tie       1131
  program   1132-1259
  drum      1260-1387

num_classes = 1388; model-space adds 3 special tokens (PAD=0, EOS=1, UNK=2)
and 100 extra ids, padded to a multiple of 128 -> 1536 embeddings.
"""

from mr_mt3_tpu_torch.codec.events import Codec, Event, EventRange
from mr_mt3_tpu_torch.codec.vocabulary import (
    DECODED_EOS_ID,
    DECODED_INVALID_ID,
    TokenVocabulary,
    VocabularyConfig,
    build_codec,
    num_embeddings,
    vocabulary_from_codec,
)
