"""python -m mr_mt3_tpu_torch.eval: transcribe a dataset and score it (the
port's counterpart of the repo's test.py).

The CLI mirrors the reference (reference: test.py, test.sh):

  python -m mr_mt3_tpu_torch.eval --config-name=config_slakh_segmem \\
      model=MT3NetSegMemV2WithPrev trainer.precision=bf16 \\
      path=runs/.../checkpoints/last eval.eval_dataset=Slakh \\
      'eval.audio_dir=/data/slakh/test/*/mix_16k.wav' \\
      eval.exp_tag_name=out_midis eval.midi_dir=/data/slakh/test/ \\
      [+eval.quantize=auto] [device=cpu]

`path` is a checkpoint of the port's trainer, a reference torch .pth/.pt
file (the T5X converter's output too) or an Orbax directory of the JAX
trainer (read through tensorstore: utils/orbax_read.py). mel_norm
is off for the official checkpoint (reference: test.py:123). It runs on the
card unless device=cpu is given (and raises without a card).
eval.quantize=auto serves the decode through the probe-guarded window
kernel on the card and the exact path on the CPU (infer/scores.py).

More than one card, as test.py spans its chips: `devices` (null: every
visible card; an int or a list of ids: how many) puts a model replica on
each and shards the decode batches over them (parallel.Mesh). multihost=true
joins the process group of a launcher (`torchrun --nnodes=N
--nproc_per_node=G -m mr_mt3_tpu_torch.eval multihost=true ...`): each
rank transcribes its stride of the songs on its own card, and rank 0
scores the shared output directory for all.
"""

from __future__ import annotations

import glob
import os
import sys


def main(argv=None):
    """Run the CLI on `argv` (default sys.argv[1:]); returns the scores."""
    from mr_mt3_tpu_torch import parallel
    from mr_mt3_tpu_torch.infer.scores import get_scores
    from mr_mt3_tpu_torch.train import REPO_CONFIGS
    from mr_mt3_tpu_torch.utils import builders
    from mr_mt3_tpu_torch.utils.config import load_config, parse_cli
    from mr_mt3_tpu_torch.utils.device import resolve_device

    config_name, config_dir, overrides = parse_cli(
        sys.argv[1:] if argv is None else argv)
    default_dir = os.environ.get('MR_MT3_CONFIGS') or REPO_CONFIGS
    cfg = load_config(config_dir or default_dir, config_name, overrides)
    for key, value in (('path', cfg.get('path')),
                       ('eval.exp_tag_name', cfg.eval.get('exp_tag_name')),
                       ('eval.audio_dir', cfg.eval.get('audio_dir'))):
        if not value:
            raise ValueError(f'{key}=... is required')
    device = resolve_device(cfg.get('device'))
    # the data axis (test.py:75-92): under multihost each rank decodes on
    # its own card (local_mesh: None for one); otherwise a replica on each
    # of `devices` cards
    if bool(cfg.get('multihost')):
        parallel.init_multihost(backend=parallel.backend_for(device))
        mesh = parallel.local_mesh(device.type)
        print(f'multihost eval: rank {parallel.rank()}/{parallel.world()}, '
              f'node {parallel.node_rank()}/{parallel.node_count()}')
    else:
        n_dev = parallel.data_devices(cfg.get('devices'), device)
        mesh = (parallel.make_mesh(
            data=n_dev, devices=parallel.visible_devices(device.type))
            if n_dev > 1 else None)
    if mesh is not None:
        print(f'eval mesh: {mesh.n_data} devices on the data axis')

    model = builders.build_model(cfg)
    # reference defaults to a NON-strict torch load when
    # eval.load_weights_strict is unset (reference test.py:107-110);
    # +eval.load_weights_strict=True opts into the strict check
    strict = cfg.eval.get('load_weights_strict')
    _, step = builders.load_weights_and_step(
        str(cfg.path), model, strict=False if strict is None else bool(strict))
    print(f'loaded weights from {cfg.path} (step {step})')

    files = sorted(glob.glob(cfg.eval.audio_dir))
    if cfg.eval.eval_dataset == 'NSynth':
        # no vocals/mallets in the training vocab (reference: test.py:117-119)
        files = [f for f in files if 'vocal' not in f and 'mallet' not in f]
    if cfg.eval.get('eval_first_n_examples'):
        files = files[:int(cfg.eval.eval_first_n_examples)]

    mel_norm = 'pretrained/mt3.pth' not in str(cfg.path)
    ground_truth = cfg.eval.get('midi_dir') or cfg.dataset.test.root_dir

    return get_scores(
        model=model,
        eval_audio_dir=files,
        mel_norm=mel_norm,
        eval_dataset=cfg.eval.eval_dataset,
        exp_tag_name=cfg.eval.exp_tag_name,
        ground_truth_midi_dir=ground_truth,
        contiguous_inference=bool(cfg.eval.get('contiguous_inference')),
        use_tf_spectral_ops=bool(cfg.eval.get('use_tf_spectral_ops')),
        batch_size=int(cfg.eval.get('batch_size') or 8),
        max_length=int(cfg.eval.get('max_length') or 1024),
        songs_per_batch=int(cfg.eval.get('songs_per_batch') or 4),
        quantize=str(cfg.eval.get('quantize') or 'none'),
        mesh=mesh,
        device=device if mesh is None else None,
    )


if __name__ == '__main__':
    main()
