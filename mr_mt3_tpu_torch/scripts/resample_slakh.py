"""Resample Slakh mixes to 16 kHz PCM_24 wavs (mix_16k.wav) (copy of
mr_mt3_tpu/scripts/resample_slakh.py).

(reference: resample.py) FLAC mixes decode through the port's native
codec (mr_mt3_tpu_torch/native/flac.cc); wav inputs are handled natively
too. Threaded like the reference (ThreadPool of 12).

Usage: python -m mr_mt3_tpu_torch.scripts.resample_slakh <slakh_root>
"""

from __future__ import annotations

import concurrent.futures
import glob
import os
import sys
import traceback

from mr_mt3_tpu_torch.audio import read_audio, resample, write_wav


def convert_one(fname: str) -> None:
    audio, sr = read_audio(fname)
    if sr != 16000:
        audio = resample(audio, sr, 16000)
    out = fname.rsplit('.', 1)[0] + '_16k.wav'
    write_wav(out, audio, 16000, subtype='PCM_24')


def main(root: str, mix_name: str = 'mix.flac') -> list:
    """Convert every <root>/{train,validation,test}/**/<mix_name>. A file
    that fails is reported and skipped, as the reference's pool does; the
    failed files are returned."""
    failed = []
    for split in ['train', 'validation', 'test']:
        files = sorted(glob.glob(
            os.path.join(root, split, '**', mix_name), recursive=True))
        print(f'{split}: {len(files)} files')
        with concurrent.futures.ThreadPoolExecutor(max_workers=12) as pool:
            futures = {pool.submit(convert_one, f): f for f in files}
            for future in concurrent.futures.as_completed(futures):
                try:
                    future.result()
                except Exception:
                    traceback.print_exc()
                    failed.append(futures[future])
    return sorted(failed)


if __name__ == '__main__':
    main(sys.argv[1], *(sys.argv[2:] or []))
