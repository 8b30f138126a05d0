"""Per-instrument 90/5/5 split of the ComMU dataset (port of
mr_mt3_tpu/scripts/create_commu_test_split.py; pandas is imported by
main, so the port imports without it).

(reference: scripts/commu/create_commu_test_split.py) Writes
commu_meta_v2.csv with a split_data column and moves MIDIs into
commu_midi_v2/{train,val,test}.

Usage: python -m mr_mt3_tpu_torch.scripts.create_commu_test_split \
    <commu_root>
"""

from __future__ import annotations

import glob
import os
import sys
from collections import defaultdict

from mr_mt3_tpu_torch.scripts.commu_const import get_inst_dict


def main(root: str) -> None:
    import pandas as pd

    processed = os.path.join(root, 'dataset_processed')
    for sub in ['', 'commu_audio_v2', 'commu_midi_v2']:
        os.makedirs(os.path.join(processed, sub), exist_ok=True)

    inst_dict = get_inst_dict()
    df = pd.read_csv(os.path.join(root, 'dataset', 'commu_meta.csv'))

    inst_to_ids = defaultdict(list)
    for _, row in df.iterrows():
        for key in inst_dict:
            if key in row['inst']:
                inst_to_ids[key].append(row['id'])
    for key in inst_to_ids:
        inst_to_ids[key] = sorted(inst_to_ids[key])

    sorted_keys = sorted(inst_to_ids, key=lambda k: len(inst_to_ids[k]),
                         reverse=True)
    for key in sorted_keys:
        ids = inst_to_ids[key]
        n = len(ids)
        splits = {
            'train': ids[:int(n * 0.9)],
            'val': ids[int(n * 0.9):int(n * 0.95)],
            'test': ids[int(n * 0.95):],
        }
        print(key, *(len(splits[s]) for s in ('train', 'val', 'test')))
        for split, split_ids in splits.items():
            for idname in split_ids:
                df.loc[df.id == idname, 'split_data'] = split

    df.to_csv(os.path.join(processed, 'commu_meta_v2.csv'), index=False)

    for split in ['train', 'val', 'test']:
        os.makedirs(os.path.join(processed, 'commu_audio_v2', split),
                    exist_ok=True)
        os.makedirs(os.path.join(processed, 'commu_midi_v2', split),
                    exist_ok=True)
    for _, row in df.iterrows():
        split = row.get('split_data')
        if split not in ('train', 'val', 'test'):
            continue
        matches = glob.glob(os.path.join(
            root, 'dataset', 'commu_midi', '*', 'raw', f"{row['id']}.mid"))
        if matches:
            os.rename(matches[0], os.path.join(
                processed, 'commu_midi_v2', split, f"{row['id']}.mid"))


if __name__ == '__main__':
    main(sys.argv[1])
