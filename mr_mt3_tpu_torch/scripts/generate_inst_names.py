"""Generate per-song inst_names.json from Slakh metadata.yaml (copy of
mr_mt3_tpu/scripts/generate_inst_names.py).

(reference: generate_inst_names.py) Maps each rendered stem's program
number back to its Slakh class name; stems without integrated_loudness
(not rendered) are skipped.

Usage: python -m mr_mt3_tpu_torch.scripts.generate_inst_names <split_dir> [...]
"""

from __future__ import annotations

import json
import sys
from glob import glob

import yaml

from mr_mt3_tpu_torch.codec.slakh import SLAKH_CLASS_PROGRAMS


def find_inst_name(is_drum: bool, program_num: int) -> str:
    if is_drum:
        return 'Drums'
    inst = None
    for name, program in SLAKH_CLASS_PROGRAMS.items():
        if program_num >= program:
            inst = name
        else:
            break
    assert inst is not None
    return inst


def main(root_path: str) -> None:
    for meta_path in glob(f'{root_path}/**/metadata.yaml', recursive=True):
        with open(meta_path) as f:
            metadata = yaml.safe_load(f)
        inst_names = {}
        for stem, info in metadata['stems'].items():
            if info.get('integrated_loudness') is not None:
                inst_names[stem] = find_inst_name(info['is_drum'],
                                                  info['program_num'])
        out = meta_path.replace('metadata.yaml', 'inst_names.json')
        with open(out, 'w') as w:
            json.dump(inst_names, w)
    print('done')


if __name__ == '__main__':
    for split in sys.argv[1:]:
        main(split)
