"""Offline data-preparation and analysis scripts (copies of the Slakh and
leakage scripts of mr_mt3_tpu/scripts). Each runs as
`python -m mr_mt3_tpu_torch.scripts.<name>`:

  generate_inst_names  <split_dir> ...   metadata.yaml -> inst_names.json
  merge_slakh_midi     <split_dir>       MIDI/S*.mid -> all_src_v2.mid
  resample_slakh       <slakh_root>      mix.flac -> mix_16k.wav (PCM_24)
  instrument_leakage   --ground_truth <split_dir> <out_dir> ...
"""
