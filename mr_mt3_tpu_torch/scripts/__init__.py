"""Offline data-preparation, analysis and conversion scripts (ports of
mr_mt3_tpu/scripts and tools/convert_weight.py). Each runs as
`python -m mr_mt3_tpu_torch.scripts.<name>`:

  generate_inst_names  <split_dir> ...   metadata.yaml -> inst_names.json
  merge_slakh_midi     <split_dir>       MIDI/S*.mid -> all_src_v2.mid
  resample_slakh       <slakh_root>      mix.flac -> mix_16k.wav (PCM_24)
  instrument_leakage   --ground_truth <split_dir> <out_dir> ...
  convert_weight       <t5x.pk> <out.pth>  official MT3 T5X -> port weights
  convert_nsynth_json_to_midi <nsynth_dir>  examples.json -> midi/*.mid
  parse_nsynth_valid   --examples ... --path '<midis>/*.mid' --tag_name out
  evaluate_nsynth_json --json_path out.json  instrument / pitch accuracy
  create_commu_test_split <commu_root>   90/5/5 split (needs pandas)
  render_commu         <commu_root> <soundfont.sf2>  (needs fluidsynth)
"""
