"""One rank of tests/test_torch_tensor_parallel.py's grids (gloo, on the CPU).

    python tests/tp_rank.py <job dir> <rank> <world> <model>

Reads <job dir>/job.pt (torch.save: JAX parameter trees as numpy arrays,
the decode inputs, the train batches, a one-rank checkpoint), joins a
grid of world / model x model ranks through the file store <job
dir>/store, runs every leg of the grid on this rank's shards and writes
<job dir>/rank<rank>.pt: the tokens and the teacher-forced logits of the
tensor-parallel handler, the parameters (gathered whole) after three
train steps without dropout and, on the model-only grid, with dropout and
the clip (each step's gradients too), the checkpoint it wrote and the
slices it restored, and the bf16 segment-memory handler's tokens and the
attention calls it made. Imports no JAX.
"""

import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def tree(flat):
    """{'a/b/c': array} -> nested dict."""
    out = {}
    for key, value in flat.items():
        node = out
        *path, leaf = key.split('/')
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = value
    return out


def main(job_dir, rank, world, model_size):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    from mr_mt3_tpu_torch import parallel
    from mr_mt3_tpu_torch.infer import InferenceHandler
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.parallel import tensor as tp_ops
    from mr_mt3_tpu_torch.train import optim, trainer
    from mr_mt3_tpu_torch.utils.checkpoint_import import (
        state_dict_shard_from_jax_params,
    )

    job = torch.load(os.path.join(job_dir, 'job.pt'), weights_only=False)
    parallel.init_multihost(backend='gloo', init_method='file://'
                            + os.path.join(job_dir, 'store'))
    mesh = parallel.Mesh(('cpu',) * world, model=model_size)
    out = {'rank': rank, 'data_index': mesh.data_index(),
           'model_index': mesh.model_index(), 'shape': mesh.shape}
    t0 = time.monotonic()
    laps = out['laps'] = {}

    def lap(name):
        laps[name] = time.monotonic() - t0

    def shard_of(params, cfg):
        """A model holding this rank's shard, loaded from the JAX tree
        through state_dict_shard_from_jax_params."""
        model = tp_ops.shard_model(MT3(cfg), mesh)
        model.load_state_dict(state_dict_shard_from_jax_params(
            tree(params), cfg, mesh.model, mesh.model_index()), strict=True)
        return model

    # the handler: tokens and teacher-forced logits, fp32
    cfg = MT3Config(**job['small_cfg'])
    model = shard_of(job['small'], cfg).eval()
    handler = InferenceHandler(model=model, mesh=mesh, device='cpu',
                               max_length=job['max_length'], batch_size=4)
    out['handler_model_is_model'] = handler.model is model
    out['attention_kernel'] = handler.cfg.attention_kernel
    out['graphs'] = handler.capture_graphs()
    out['tokens'] = handler._decode_all(torch.from_numpy(job['mel']))
    with torch.no_grad():
        out['logits'] = model(torch.from_numpy(job['mel']),
                              torch.from_numpy(job['ids'])).numpy()
    out['local_heads'] = model.decoder.block[0].self_attn.n_heads
    lap('handler')

    # three AdamW steps, dropout off, on this rank's rows of the batches
    def train(cfg_kw, params, optimizer, seed, grads=None):
        """grads: a list for each step's gradients (gathered whole), as
        the optimizer receives them."""
        cfg = MT3Config(**cfg_kw)
        model = shard_of(params, cfg)
        opt = optim.make_optimizer(**optimizer)
        state = trainer.create_train_state(model, opt)
        if grads is not None:
            names = [n for n, _ in model.named_parameters()]
            real = opt.step

            def keeping(gs):
                grads.append({n: tp_ops.full_tensor(g, n, model.tp).clone()
                              for n, g in zip(names, gs)})
                return real(gs)
            opt.step = keeping
        step = trainer.make_train_step('ce')
        metrics = []
        for batch in job['batches']:
            part = parallel.shard_batch(batch, mesh.n_data, mesh.data_index())
            m = step(state, part, seed)
            metrics.append({k: float(v) for k, v in m.items()})
        return state, metrics

    state, metrics = train(job['train_cfg'], job['train_params'],
                           job['optimizer'], None)
    out['train'] = {'metrics': metrics, 'step': state.step,
                    'params': tp_ops.full_state_dict(state.model),
                    'ddp': state.ddp is not None}
    lap('train')

    if mesh.n_data == 1:
        # dropout and the clip: the masks a one-rank step draws
        grads = []
        state, metrics = train(job['dropout_cfg'], job['train_params'],
                               job['dropout_optimizer'], job['seed'], grads)
        out['dropout'] = {'metrics': metrics, 'grads': grads,
                          'params': tp_ops.full_state_dict(state.model)}
        lap('dropout')
        # a checkpoint written here, and a one-rank one restored
        tr = trainer.Trainer(state.model, state.optimizer,
                             out_dir=os.path.join(job_dir, 'run'))
        tr.save_checkpoint(state, 'tp')
        restored = trainer.create_train_state(
            shard_of(job['train_params'], MT3Config(**job['dropout_cfg'])),
            optim.make_optimizer(**job['dropout_optimizer']))
        tr.restore_state(job['one_rank_checkpoint'], restored)
        out['restored'] = {
            'step': restored.step,
            'params': {k: v.clone() for k, v in
                       restored.model.state_dict().items()},
            'mu': [t.clone() for t in restored.optimizer.mu],
            'names': [n for n, _ in restored.model.named_parameters()]}
        lap('checkpoints')

        # the bf16 segment-memory model (the parity golden's weights, which
        # decode to EOS within a few blocks), the attention kernel's route
        # (its plain version on the CPU), one contiguous chain
        cfg = MT3Config(**job['segmem_cfg'])
        seg = shard_of(job['segmem'], cfg).eval()
        h = InferenceHandler(model=seg, mesh=mesh, device='cpu',
                             max_length=job['segmem_max_length'],
                             contiguous_inference=True, segment_bucket=1)
        from mr_mt3_tpu_torch.ops import train_attention as ta
        calls = []
        real = ta.fused_attention

        def counting(q, *a, **kw):
            calls.append(tuple(q.shape))
            return real(q, *a, **kw)
        ta.fused_attention = counting
        try:
            out['segmem_tokens'] = h._decode_all(
                torch.from_numpy(job['segmem_mel']))
        finally:
            ta.fused_attention = real
        out['segmem_attention_shapes'] = calls
        lap('segmem')
    out['seconds'] = time.monotonic() - t0
    torch.save(out, os.path.join(job_dir, f'rank{rank}.pt'))
    parallel.barrier()
    parallel.shutdown()


if __name__ == '__main__':
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
