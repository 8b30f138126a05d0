"""One rank of tests/test_torch_ddp.py's process group (gloo, on the CPU).

    python tests/ddp_rank.py <job file> <rank> <world> <store file>

Reads the job the test wrote (torch.save: the model config and initial
weights, the train and validation batches, the eval sets), joins the
group through a file store, and writes <job dir>/rank<rank>.pt: per loss
type the metrics of three DDP steps on this rank's slices and the
parameters after them, the validation sums, how many checkpoint files this
rank wrote, and the scores get_scores returned here (or the error it
raised, where an eval set names a rank whose decodes fail), each followed
by an all-reduce of the ranks' numbers. Imports no JAX.
"""

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(job_path, rank, world, store):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    from mr_mt3_tpu_torch import parallel
    from mr_mt3_tpu_torch.infer import InferenceHandler
    from mr_mt3_tpu_torch.infer.scores import get_scores
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.train import optim, trainer

    job = torch.load(job_path, weights_only=False)
    parallel.init_multihost(backend='gloo', init_method=f'file://{store}')
    out = {'rank': parallel.rank(), 'world': parallel.world()}

    def model_of(cfg, state_dict):
        model = MT3(MT3Config(**cfg))
        model.load_state_dict(state_dict)
        return model

    for loss_type in ('ce', 'weighted'):
        model = model_of(job['cfg'], job['state_dict'])
        opt = optim.make_optimizer(**job['optimizer'])
        state = trainer.create_train_state(model, opt)
        assert state.ddp is not None
        step = trainer.make_train_step(loss_type)
        metrics = []
        for batch in job['batches']:
            m = step(state, parallel.shard_batch(batch, world, rank), None)
            metrics.append({k: float(v) for k, v in m.items()})
        out[loss_type] = {'metrics': metrics, 'step': state.step,
                          'params': {k: v.clone() for k, v in
                                     model.state_dict().items()}}

    saves = []
    real_save = torch.save

    def counting_save(obj, path, *a, **kw):
        saves.append(str(path))
        return real_save(obj, path, *a, **kw)
    torch.save = counting_save
    try:
        tr = trainer.Trainer(model, opt, loss_type='ce',
                             out_dir=job['out_dir'])
        out['validation_sums'] = tr.validation_sums(state,
                                                    job['val_batches'])
        tr.save_checkpoint(state, 'last')
    finally:
        torch.save = real_save
    out['saves'] = saves
    out['checkpoints'] = sorted(os.listdir(os.path.join(job['out_dir'],
                                                        'checkpoints')))

    for name, ev in job['eval'].items():
        if ev.get('fail_rank') == rank:
            # this rank's decodes raise, as an out-of-memory would
            def broken(*a, **kw):
                raise RuntimeError('decode failed on this rank')
            InferenceHandler.transcribe_many = broken
            InferenceHandler.inference = broken
        try:
            out[name] = get_scores(
                model=model_of(ev['cfg'], ev['state_dict']),
                eval_audio_dir=ev['files'], eval_dataset=ev['dataset'],
                exp_tag_name=ev['out'], ground_truth_midi_dir=ev['gt'],
                max_length=ev['max_length'], verbose=False, device='cpu')
        except RuntimeError as e:
            out[name] = {'error': str(e)}
        # the next collective pairs up on every rank
        out[f'{name}_after'] = float(parallel.all_reduce_sum(
            torch.tensor([rank + 1.0]))[0])
    real_save(out, os.path.join(os.path.dirname(job_path), f'rank{rank}.pt'))
    parallel.shutdown()


if __name__ == '__main__':
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
