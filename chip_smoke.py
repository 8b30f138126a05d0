#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (mr_mt3_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. environment: card name and power limit, torch / CUDA / nvcc versions;
  2. build: every kernel of the main paths from csrc/ (nvcc, one process
     per source, started together): fused_decode_window (the window and
     the grouped int8 window), fused_decode_step, fused_attention_fwd,
     fused_attention_bwd, int8_matmul (int8_matmul and int8_gated_ff),
     int8_decode_attention and logmel;
  2b. native (native_phase): the host C++ libraries of native/ (the FLAC
     codec and the tokenizer core) built by g++ at first use, in parallel;
     FLAC round trips at 16 kHz mono and 44.1 kHz stereo, 16- and 24-bit,
     fixed, LPC and mid-side (NATIVE_FLAC_CASES, a minute of audio each),
     the decoded integers equal to the input, encode and decode seconds
     per minute of audio; truncated and mutated streams each refused with
     ValueError; the host numbers printed beside the card line;
  2c. profiling (profiling_check, early: no profiler session opened
     before it): utils/profiling.py's trace() around one log-mel launch
     writes a Chrome trace naming logmel_kernel, and benchmark() and
     Timer over PROFILING_CALLS launches read within PROFILING_FACTOR of
     CUDA-event timing of the same calls;
  3. window kernel against its plain PyTorch version on the card at full
     width (MT3Config(), seeded weights and encoder states, Lenc 256), in
     each mode (fused_bf16, fused = int8, fused_int4):
     B in {8, 64} x pos0 in {0, 32, 992}, and B in {8, 64}, pos0 992 at
     the segment-memory model's Lenc 320, the cache rows < pos0 decoded
     by the kernel itself; tokens equal up to a first divergence that is
     only allowed where the plain version scores the two tokens nearly
     alike; bf16 K/V rows, or integer K/V codes and their scales, and
     last-step logits within each mode's bounds (BOUNDS); in the integer
     modes the same bounds must also fail the kernel against a control,
     a plain version without the int8 requantization of q and the
     probabilities; CUDA-event timings (median) beside the
     bytes/operations bound, the plain version's in WINDOW_MAIN_CASE only;
  3b. the int8 tiers' kernels against their plain versions at full width
     (int8_kernel_cases): int8_matmul at the lm_head (512 x 1536),
     int8_gated_ff at 512 / 1024, int8_decode_attention over a 1024 cache
     at positions 0, 31 and 1023 and across 256 and 320 encoder rows
     (head width 64, and 24), each at B 8 and 64 with f32 and bf16
     inputs, within INT8_BOUNDS, which must also catch a control (the
     attention without the requantization of p; the matmul on x rounded
     to bf16 in f32, on bf16-dequantized weights in bf16); CUDA-event
     times of the wrappers and of each call queued behind a spin kernel,
     the host's cost hidden (queued_ms), beside the bound, the plain
     version's and a library yardstick (for the matmul also torch._weight_int8pack_mm, the same
     function);
  3b'. int8_decode_attention's device-position entry (the step loop's
     self-attention: the position an int32 in device memory, the launch
     sized for n_max, the phase bound; int8_device_position_cases): B 8
     and 64 x f32 / bf16 x positions 0, 31, 63, 511 and 1023 of a 1024
     cache, within INT8_BOUNDS of the plain version with the control
     caught, against the host-int launch (its unequal share printed), a
     host position at n_max and n_max past the cache refused, a device
     position at n_max giving NaN; then capture_survival: one block of
     the int8 step loop replayed from a saved state equal to the block
     run eagerly, and 120 more replays leaving int8_gated_ff's grid
     barrier count word zero, its generation word advanced once a launch;
  3c. the log-mel kernel (logmel_cases) at the handler's shapes, B in
     {8, 64} segments of 32768 samples (and a ragged 16000), a tone, white
     noise and zeros, both filterbank styles: within LOGMEL_BOUNDS of its
     plain version (compute_logmel: torch FFT) and of a float64 DFT by
     products on its constants, which a control (the products without
     the Hann window) must break; zeros at log(1e-5); CUDA-event times of
     the kernel and of compute_logmel beside the function's bound (an
     FFT's operations) and the bound of the kernel's own FFT;
  3d. the step kernel (step_cases) against its plain version at full
     width in each mode: B in {8, 64} at positions 0, 255, 256, 700 and
     1023 of a 1024 cache filled from a seed (Lenc 256: chunk 256, up to
     four live chunks), and B 8 at 511, 512 and 1023 at Lenc 320 (chunk
     512): logits, emitted rows (bf16) or codes and scales within
     STEP_BOUNDS; in the integer modes a control, the plain version with
     one chunk (the window's softmax, not the step's function), must
     break them wherever two or more chunks are live; CUDA-event times
     beside the plain version's and the bound;
  3e. the grouped int8 window (grouped_cases) against its plain version:
     G in {2, 8} x pos0 in {0, 224, 992}, 32-step windows, chunk 256, the
     cache rows < pos0 decoded by the kernel itself; tokens, codes and
     scales within the `fused` window's BOUNDS, the emitted scales
     bf16-representable; the `fused` window kernel on the same inputs
     ungrouped timed beside it (a yardstick, not the same function);
  4. fused_attention_fwd against its plain version at the segment-memory
     path's shapes (ATTN_CASES: the memory encoder at B 8 and 64, the
     probe's causal decoder and 1024 x 320 cross attention, the parity
     model's head width 24, a ragged causal 520 and 4096 keys), called as
     the model calls it (fused_attention on the unpadded K/V: its padding
     and kv_valid included) and compared with the plain version on the
     padded K/V, within ATTN_BOUNDS, which must also catch a control (the
     output divided by the row sum after the value product), with the
     kernel's time and TFLOP/s, the plain version's time, the bound and
     scaled_dot_product_attention's time (a yardstick the port never
     calls);
  5. parity on the card: the overfit parity model of
     tests/goldens/parity_vanilla.npz (loaded with numpy through the
     port's weights bridge, its audio rebuilt and checked against the
     stored hash) decodes both songs at max_length 1024 through
     fused_int4, fused, fused_bf16, int8 and int8_kv with no token off
     the golden, and the probe ladder walks it as the JAX ladder does
     (int4 demoted for a material flip, int8 kept; from int8 and int8_kv,
     each kept, as the CPU test pins JAX's walk); then
     parity_withprev.npz (contiguous) through the exact path, the three
     window tiers and the two int8 tiers (those also equal to the same
     decode on their kernels' plain versions) and parity_v1.npz
     through the exact path, no token off; and the withprev model at
     bf16 gives the same tokens with its memory encoder on the kernel and
     on einsum;
  6. main path: the handler exactly as `python -m mr_mt3_tpu_torch.serve`
     builds and prepares it (configs/config.yaml, model=MT3Net, seed-0
     random weights, default tier fused_int4, probe ladder and prewarm on)
     at eval.max_length 512 (MAIN_PATH_MAX_LENGTH; users' default 1024,
     cut for time), serving WAV clips over HTTP from two concurrent
     clients, then from one client in turn the 4.0 s clip as 16-bit WAV
     and as 16-bit FLAC at 16 kHz (decode_audio's samples bit-equal, the
     MIDI replies equal), as 44.1 kHz stereo FLAC (200, MIDI) and a
     truncated FLAC body (400); the ladder's walk is printed, and no
     demotion may come from an exception;
  7. segment-memory main path: the same for `python -m
     mr_mt3_tpu_torch.serve model=MT3NetSegMemV2WithPrev
     trainer.precision=bf16` (the paper's model, chained decode), also at
     eval.max_length 512; the
     fused_attention launches must equal the long attentions the model
     ran (memory-encoder calls and teacher-forced forwards at L >= 512);
     on both servers the log-mel launches equal the handler's
     _compute_mel calls (the probe's and the prewarm's counted);
  7b. eval main path: `python -m mr_mt3_tpu_torch.eval model=MT3Net
     eval.max_length=512` through eval.__main__.main(argv) on 4 fabricated Slakh-format songs
     (4-10 s, tones and their notes as all_src_v2.mid), seed-0 random
     weights saved as a port checkpoint, at +eval.quantize=auto (the
     ladder from fused_int4) and at none: a MIDI per song,
     evaluate_main's keys, the log-mel launches equal to the
     _compute_mel calls, seconds per song and the tier served; on the
     auto leg's output the paper's instrument-leakage analysis
     (scripts/instrument_leakage.py: programs per transcription, presence
     P/R/F1; the ground truth's count equal to the stems written);
  7c. F1 on the card against the CPU: get_scores on the parity model over
     its corpus and notes, on the CPU and on the card held at none,
     fused_bf16, fused and fused_int4, every score within 0.001 (the JAX
     package's bar) of the CPU's;
  8. serving through each window tier held (fused_int4, fused, fused_bf16;
     prepare_handler(probe=False)): the same clips, every answer MIDI; at
     fused_int4 the FLAC requests of phase 6 as well, on the window kernel
     (the default server's ladder may demote at random weights; every
     server that takes them must launch log-mel once a decoding request,
     and the window kernel where it decodes on a window tier);
  8b. the int8 tiers as `serve +eval.quantize=int8|int8_kv` builds them:
     the ladder's walk from each (printed), a handler held at each
     serving the clips at eval.max_length 128 (cut for time), the int8 kernels' launches equal to the greedy
     steps times num_decoder_layers + 1 (int8) or 2 x num_decoder_layers
     (int8_kv); and the segment-memory model at bf16 through each tier
     held, one clip at eval.max_length 64 (cut from 1024 for time);
  9. one worst-case decode (B=8, 1024 steps) on each window tier, each
     int8 tier and the exact path (fp32, TF32 off), and one chained
     segment-memory
     decode on fused_bf16 (8 chains x 8 segments x 1024 steps); the
     step-by-step tiers (int8, int8_kv, none) both eagerly (graphs=False,
     WORST_EAGER_STEPS steps: cut for time) and from replayed CUDA graphs
     (the main path, every phase captured first: capture seconds and graph
     memory printed), each with ms/step, RTF, device ms/step and idle
     share; the exact tier's graphed tokens equal to the eager ones over
     the eager steps, an int8 tier's apart only at benign flips;
  9b. the step path (step_path): 1024 greedy steps of B=8 segments through
     fused_decode_step in each mode, the argmax taken outside: launches
     equal to the steps, ms per step and RTF, the first 128 steps' tokens
     against the same loop on the plain version (a row may part only at a
     near-tie, BOUNDS' max_gap_rel); on the parity model the step-driven tokens equal the
     window's in fused_bf16 and fused, up to each row's EOS;
  9c. the grouped path (grouped_path): benchmarks/dev_fused_group_axis.py's
     decode, 8 groups of 8 segments (B 64), 32-step windows, chunk 256,
     1024 steps, against the `fused` window at B 64 on the same encoder
     states: ms per step, RTF, launches (32 windows each); on the parity
     model tiled to 16 rows the grouped tokens equal the window's;
 10. fused_attention_bwd against its plain version at the training step's
     shapes (ATTN_BWD_CASES: B 12, the memory encoder, the decoder's
     causal and cross attentions, head width 24, a ragged causal 520; 4096
     keys at B 2), called through autograd as the model calls it, within
     ATTN_BWD_BOUNDS, two runs bit-identical, a rowsum(dO * O) delta
     control read against the bounds (recorded), with the kernel's time
     and TFLOP/s, the plain version's, the bound and the backward of
     scaled_dot_product_attention (a yardstick);
 11. training parity on the card: the full-width segment-memory model at
     bf16, one batch on each of two seeds, loss and every gradient with
     the attention kernels against attention_kernel='einsum' and against
     the kernels' plain versions, the plain versions against einsum at
     fp32 (TRAIN_PARITY_BOUNDS), a control (dk scaled) the bounds must
     catch, ms per train step on both routes with a profile of one step
     (device ms, idle share, the attention kernels' ms), and an fp32 step
     on the card against the CPU;
 12. training main path: `python -m mr_mt3_tpu_torch.train` with TRAIN_ARGS
     (the paper's recipe at bf16) through train.main(argv) on a fabricated
     corpus as Slakh publishes it (mix.flac at 44.1 kHz, MIDI stems,
     metadata.yaml), prepared by the port's generate_inst_names,
     merge_slakh_midi and resample_slakh (seconds printed) and its songs
     tokenized by the native core and the Python path with equal arrays
     (ms per song printed): 2 epochs with validation, then a resume from
     'last' for one more; the native tokenizer counted on each leg, no
     fallback; finite losses, loadable checkpoints, the step going on, and
     the attention kernels' launches equal to the long attentions the
     steps ran (forward and backward); the eval hook (TRAIN_EVAL_ARGS)
     reads the validation songs' mix.flac and logs val_f1_* after each
     validation;
 13. multi_card, the data axis on the one card (parallel/mesh.py): (a) in
     this process, the handler on a mesh of cuda:0 twice (two model
     replicas, each decoding half of a call's rows on a host thread of its
     own) at fused_int4 and none, the vanilla model (MT3Config(), seed 0,
     24 segments of the kernel's log-mel, 8 rows a replica) and the bf16
     segment-memory model chained (two songs of 8 chains, one a replica),
     max_length 64 (cut for time): tokens equal to the one-replica
     handler's on calls of the same rows, the window kernel's launches
     counted by replica thread; (b) meanwhile three children
     (multi_card_rank): a one-rank NCCL group, whose fp32 DDP steps equal
     the plain steps bit for bit (metrics and parameters) and which scores
     the parity model in one process; two gloo ranks sharing the card (NCCL
     refuses two ranks on one device): DDP steps of the full-width bf16
     segment-memory model (fused attention forward and backward launches
     equal to the long attentions each rank ran, the same reduced metrics
     and parameters on both), an fp32 leg against the one-process run on
     the whole batch (a partial batch of 3 rows whose slices hold unequal
     counts of real tokens): the first step within the card's fp32
     sum-order bounds, and after 3 AdamW steps at most 1e-3 of the
     parameters further than the CPU tests' 1e-5 apart, each of them an
     element whose gradient the sum orders' noise can turn
     (fp32_readings), and get_scores on two ranks equal to one process's, each
     rank's log-mel launches equal to its _compute_mel calls; (c) the
     model axis (tensor parallelism, parallel/tensor.py), six more children
     (tp_rank) on gloo ranks sharing the card: two ranks at model=2
     decoding the vanilla model in fp32 at none (tokens equal to the
     one-replica handler's on the same 24 segments, log-mel launches equal
     to the _compute_mel calls, the step loops eager: graphs false) and
     the bf16 segment-memory model's contiguous chain at max_length 512
     (fused_attention_fwd launches equal to each rank's long attentions,
     on H = 3 heads; tokens against the one-rank handler's by
     classify_flips' margin rule, none material), and a data=2 x model=2
     grid of four ranks training the bf16 model (forward and backward
     launches equal to the long attentions on each rank, on 3 heads, every
     rank's gathered parameters and metrics equal) and the fp32 model
     against the one-process run (fp32_readings); quantize=fused_int4 on a
     model=2 mesh raises. A child's failure, or its running past
     MULTI_RANK_TIMEOUT_S, fails the phase.
 12b. overfit on the card (overfit_on_card): tests/test_system_overfit.py
     at its size in fp32, its songs from overfit_corpus, trained with the
     port's train step until the loss < 0.2 within 400 steps; the trained
     spans transcribed through InferenceHandler at quantize 'none' with
     mean onset F1 > 0.8 (the JAX test's bar) and log-mel launches equal
     to the _compute_mel calls; then (a) the same with the frontend on
     compute_logmel (both F1s must pass; the tokens that differ are
     counted), (b) the probe ladder from the serving default fused_int4
     (the tier kept, the F1 there, the window launches covering the
     windows run) and (c) scripts/instrument_leakage.py on the
     transcriptions;
 12c. converted T5X checkpoint served (converted_t5x): a seeded T5X tree
     at the official MT3 shapes (t5x_tree), pickled, converted by `python
     -m mr_mt3_tpu_torch.scripts.convert_weight`, its .pth holding exactly
     MT3(MT3Config())'s keys and shapes; InferenceHandler(weight_path=...)
     transcribes a seeded clip at fused_int4 (window launches equal to the
     windows needed) and at none (log-mel launches equal to the
     _compute_mel calls on both), and the card's fp32 logits are within
     CARD_CPU_LOGIT_REL of the same file's on the CPU;
 12d. adversarial gradient (adversarial_gradient): fgsm and pgd_linf
     (3 steps) on vanilla MT3 at full width in bf16 (adversarial_weights),
     4 mels of 256 frames, 1024 labels: fused attention forward and
     backward launches equal to the long attentions the gradients ran
     (adversarial_attentions), FGSM values in {0, +-epsilon}, PGD inside
     the ball, the loss at x + delta not below the loss at x; the input
     gradient's sign agreement with the fp32 einsum route's no worse on
     the kernel route than on the bf16 einsum route up to the sampling
     noise of the two counts (ADV_SIGN_SIGMAS), and a control (head 0's
     attention gradients negated) caught by the same reading;
 12e. orbax without tensorstore (orbax_without_tensorstore): without
     tensorstore, load_weights on an Orbax directory raises RuntimeError
     naming it; with it, its presence is printed;
Launch counts are zeroed just before each of phases 6, 7, 7b's legs, 8,
each leg of 8b, 9b and 9c, of 12, 12b's legs, 12c's legs, 12d and 13 and
read just after; the window launches must cover every
window the decoded tokens needed. The step loops replay captured CUDA
graphs, which call no Python: their runners add each replayed block's
launches (recorded at its capture, and taken back off the counts then)
and its steps to the wrappers' LAUNCHES and to fast_decode.STEPS, which
StepLog reads, so launches still equal steps x the per-step count. Each phase prints its seconds. Then one
JSON line of kernel numbers, the card line, and the result line.
versus() is not a phase: it times the attention, log-mel and decode
kernels against another design's sources, which a run has to be given.
"""

import json
import math
import os
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, 'chiprun_out')

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# bf16 tensor-core FLOP/s. The bound below is against these.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12

# Kernel vs plain version. Both sum in f32 but in different orders, so a
# bf16-rounded activation may land one bf16 ulp (2^-8 relative) apart;
# such flips pass from layer to layer (a flipped input moves every output
# of the next projection a little, which flips some of its roundings), and
# the unscaled attention over up to 1024 cache rows amplifies them. In the
# integer modes the same order differences move the f32 K/V values by
# about as much (~1% of the largest |value|), which at int8's step (1/127
# of a row's max) moves many codes by one or a few steps; and the integer
# attention requantizes q and the probabilities per (row, head), so a
# value that moves across a rounding tie moves a score or a probability
# by a whole step, which the softmax over up to 1024 cache rows amplifies.
# Each case reads, per batch row up to its first divergence:
#   kv_rel_err              bf16 K/V rows, largest |difference| over the
#                           largest |row| of the compared steps;
#   kv_rel_err_beyond_step  integer modes: dequantized rows (code x
#                           scale), the part of the difference beyond one
#                           quantization step of the row, over the largest
#                           |value|;
#   codes_unequal           share of K/V codes not equal;
#   first_layer_codes_unequal  the same over the second layer's K/V rows
#                           of the window's first step only, which follow
#                           one layer of attention from equal inputs: the
#                           sum-order differences flip codes there only at
#                           rare ties, while a wrong attention moves them
#                           all;
#   code_max_diff           largest |code difference|;
#   scale_rel_err           per-row scales, over the largest scale;
#   logit_rel_err           last-step logits of the rows whose tokens all
#                           agree, over the largest |logit|;
#   max_gap_rel             at each row's first divergence, the plain
#                           version's score of its token minus its score of
#                           the kernel's, over the step's largest |logit|
#                           (a divergence is allowed only at a near-tie);
# and a case in which every unfinished row diverges fails, since no logits
# of an unfinished row are then compared.
# The bounds of each mode, with the largest reading over the six cases of
# runs E, F and G (NVIDIA H100 80GB HBM3, 700 W; PERF.md, H100 port);
# fused_bf16 keeps the bounds it was first ported with (the gap bound is
# 2 x its logit bound). Each integer case also runs the control (float_attention_control)
# and fails unless the control breaks a bound: in run G its smallest
# first_layer_codes_unequal was 0.214 (int8) and 0.0123 (int4), and it
# broke that bound in all twelve cases.
BOUNDS = {
    'fused_bf16': {'kv_rel_err': 4e-2,              # read 0.0212
                   'logit_rel_err': 3e-2,           # 0.0151
                   'max_gap_rel': 6e-2},            # 0.0182
    'fused': {'kv_rel_err_beyond_step': 6e-2,       # 0.0346
              'codes_unequal': 0.30,                # 0.2008
              'first_layer_codes_unequal': 5e-2,    # 0.0140 (G)
              'code_max_diff': 24,                  # 12
              'scale_rel_err': 5e-2,                # 0.0256
              'logit_rel_err': 6e-2,                # 0.0321
              'max_gap_rel': 5e-2},                 # 0.0195
    'fused_int4': {'kv_rel_err_beyond_step': 3e-2,  # 0.0110
                   'codes_unequal': 0.03,           # 0.0100
                   'first_layer_codes_unequal': 2e-3,  # 0.0002 (G)
                   'code_max_diff': 2,              # 1
                   'scale_rel_err': 6e-2,           # 0.0298
                   'logit_rel_err': 1e-1,           # 0.0628
                   'max_gap_rel': 4e-2},            # 0.0136
}
TIMED_RUNS = 20
# the plain versions' times: a median over fewer runs, with no warm-up
# beyond the comparison's own call (their times measure the host, PERF.md);
# the plain window is thousands of host-launched ops (~1 s a window), so
# one run each, which keeps the whole script inside its time limit
PLAIN_TIMED_RUNS = 3
PLAIN_WINDOW_TIMED_RUNS = 1
TIERS = ('fused_bf16', 'fused', 'fused_int4')
# the window case (batch, pos0, Lenc) whose numbers the kernel line reports
WINDOW_MAIN_CASE = (8, 992, 256)
# Depth cut for time (the whole script must finish well inside 1200 s,
# about 600): the serving and eval main paths decode at
# eval.max_length MAIN_PATH_MAX_LENGTH (users' default 1024; the probe's
# full-length confirm still runs, at this length, above its 256-step
# probes), the int8 tiers' held servers at INT8_SERVING_MAX_LENGTH, and
# the step path holds its first STEP_PATH_PLAIN_STEPS steps against the
# plain loop. The worst-case decodes keep 1024 steps.
MAIN_PATH_MAX_LENGTH = 512


def fail(msg):
    print(f'chip_smoke FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


PHASE_SECONDS = {}
_phase_now = [None, None]      # the running phase's name and start time


def phase(name):
    """Start a phase: print its name, and the seconds of the one before."""
    now = time.monotonic()
    if _phase_now[0] is not None:
        PHASE_SECONDS[_phase_now[0]] = round(now - _phase_now[1], 1)
        print(f'   ({_phase_now[0]}: {now - _phase_now[1]:.1f} s)',
              flush=True)
    _phase_now[:] = [name, now]
    if name is not None:
        print(f'== {name}', flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True)
    if out.returncode != 0:
        fail(f'nvidia-smi failed: {out.stderr.strip()}')
    return out.stdout.strip().splitlines()[0]


def environment(torch):
    phase('environment')
    print(card_line())
    nvcc = subprocess.run(['bash', '-c', 'nvcc --version || '
                           '/usr/local/cuda/bin/nvcc --version'],
                          capture_output=True, text=True)
    nvcc_v = (nvcc.stdout.strip().splitlines() or ['nvcc not found'])[-1]
    print(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}, {nvcc_v}')
    print(f'device: {torch.cuda.get_device_name(0)}, '
          f'{torch.cuda.device_count()} visible')


def build_kernels():
    """Build every library of csrc/ in parallel (one nvcc a source, a
    library's PARTS too); print ptxas."""
    phase('build')
    from concurrent.futures import ThreadPoolExecutor

    from mr_mt3_tpu_torch.ops import cuda_build
    parts = {p for ps in cuda_build.PARTS.values() for p in ps}
    names = sorted(f[:-3] for f in os.listdir(cuda_build.CSRC_DIR)
                   if f.endswith('.cu') and f[:-3] not in parts)
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(names)) as pool:
        results = list(pool.map(
            lambda n: cuda_build.build(n, verbose=True), names))
    for name, (path, log) in zip(names, results):
        regs = [ln.strip() for ln in log.splitlines()
                if 'registers' in ln or 'spill' in ln]
        print(f'built {name} -> {os.path.relpath(path, REPO)}')
        for ln in regs:
            print(f'  ptxas: {ln}')
    print(f'build seconds: {time.monotonic() - t0:.1f}')


# FLAC round trips of the native phase: (case, sample rate, channels, bits,
# encoder mode: -1 auto (fixed order <= 2), 0-4 fixed order, 100 + o LPC
# order o, mid-side), each over NATIVE_FLAC_SECONDS of a tone and noise
NATIVE_FLAC_CASES = [
    ('16k_mono_16bit_auto', 16000, 1, 16, -1, False),
    ('16k_mono_24bit_lpc8', 16000, 1, 24, 108, False),
    ('44k1_stereo_16bit_fixed4', 44100, 2, 16, 4, False),
    ('44k1_stereo_16bit_mid_side', 44100, 2, 16, -1, True),
    ('44k1_stereo_24bit_lpc4', 44100, 2, 24, 104, False)]
NATIVE_FLAC_SECONDS = 60.0


def flac_ints(seconds, sr, channels, bits, seed):
    """A tone and noise as `bits`-bit integers, (n, channels) int32."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    full = float(1 << (bits - 1)) - 1
    x = np.stack([0.4 * np.sin(2 * np.pi * 330 * (1 + c) * t)
                  + 0.05 * rng.normal(size=t.shape)
                  for c in range(channels)], 1)
    return np.round(x.clip(-1, 1) * full).astype(np.int32)


def malformed_flac_streams():
    """(name, bytes) that the decoder must refuse with ValueError:
    truncations of a valid stream and mutations of its headers."""
    from mr_mt3_tpu_torch.native import encode_flac_bytes
    mono = encode_flac_bytes(flac_ints(0.4, 16000, 1, 16, 7), 16000)
    stereo = encode_flac_bytes(flac_ints(0.4, 16000, 2, 16, 7), 16000,
                               mid_side=True)
    streams = [(f'truncated_{cut}', mono[:cut]) for cut in (
        4, 8, 20, 41, 60, 100, len(mono) // 3, len(mono) // 2)]
    frame = 42   # the first frame header, after 4 + 38 bytes of metadata

    def mutated(name, data, **at):
        out = bytearray(data)
        for offset, value in at.items():
            out[int(offset[1:])] = value(out[int(offset[1:])])
        streams.append((name, bytes(out)))
    # STREAMINFO: the 20-bit sample rate at bytes 18-20, the 36-bit total
    # sample count from the low nibble of byte 21
    mutated('bad_magic', stereo, b3=lambda b: ord('D'))
    mutated('first_block_not_streaminfo', stereo, b4=lambda b: 5)
    mutated('frame_sync_zeroed', stereo, **{f'b{frame}': lambda b: 0})
    mutated('sample_rate_zero', stereo, b18=lambda b: 0, b19=lambda b: 0,
            b20=lambda b: b & 0x0F)
    mutated('total_samples_2_36', stereo, b21=lambda b: b | 0x0F)
    mutated('mono_frame_claims_mid_side', mono,
            **{f'b{frame + 3}': lambda b: (b & 0x0F) | (10 << 4)})
    mutated('reserved_channel_code', stereo,
            **{f'b{frame + 3}': lambda b: (b & 0x0F) | (12 << 4)})
    return streams


def native_phase(torch):
    """The native host layer: tokenizer and FLAC libraries built by g++ at
    first use (native/_loader.py), FLAC round trips whose decoded integers
    must equal the input (decode seconds per minute of audio), malformed
    streams that must each raise ValueError. Host numbers, printed beside
    the card line."""
    phase('native: g++ libraries, FLAC round trips, malformed streams')
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from mr_mt3_tpu_torch.native import flac, tokenizer
    card = card_line()
    results = {'card': card}
    t0 = time.monotonic()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda lib: lib.load(),
                      (flac.LIBRARY, tokenizer.LIBRARY)))
    results['build_seconds'] = time.monotonic() - t0
    results['libraries'] = {
        lib.source: {'built': lib.built, 'seconds': lib.load_seconds,
                     'path': os.path.relpath(lib.path(), REPO)}
        for lib in (flac.LIBRARY, tokenizer.LIBRARY)}
    print(f'[{card}] native libraries in {results["build_seconds"]:.2f} s '
          f'(g++, in parallel): {json.dumps(results["libraries"])}')
    rows = []
    for i, (case, sr, channels, bits, mode, mid_side) in enumerate(
            NATIVE_FLAC_CASES):
        x = flac_ints(NATIVE_FLAC_SECONDS, sr, channels, bits, i)
        t1 = time.monotonic()
        data = flac.encode_flac_bytes(x, sr, bits=bits, force_mode=mode,
                                      mid_side=mid_side)
        t2 = time.monotonic()
        y, got_sr = flac.decode_flac_bytes(data)
        t3 = time.monotonic()
        back = np.round(y.astype(np.float64) * (1 << (bits - 1))).astype(
            np.int32)
        if got_sr != sr or not np.array_equal(back, x):
            fail(f'FLAC round trip {case}: rate {got_sr}, integers '
                 f'{"equal" if np.array_equal(back, x) else "unequal"}')
        minutes = NATIVE_FLAC_SECONDS / 60
        rows.append({'case': case, 'bytes': len(data),
                     'ratio': len(data) / x.nbytes * 32 / bits,
                     'encode_s_per_min': (t2 - t1) / minutes,
                     'decode_s_per_min': (t3 - t2) / minutes})
        print(f'[{card}] FLAC {case}: {len(data)} bytes, encode '
              f'{rows[-1]["encode_s_per_min"]:.3f} s and decode '
              f'{rows[-1]["decode_s_per_min"]:.3f} s a minute of audio, '
              f'integers equal')
    results['flac'] = rows
    refused = []
    for name, data in malformed_flac_streams():
        try:
            flac.decode_flac_bytes(data)
        except ValueError:
            refused.append(name)
            continue
        fail(f'the malformed FLAC stream {name} decoded')
    results['malformed_refused'] = refused
    print(f'[{card}] {len(refused)} malformed FLAC streams refused with '
          f'ValueError: {", ".join(refused)}')
    return results


def decoder_bytes(cfg, tier):
    """Bytes of the decoder's weights, lm_head and norms (and the f32
    column scales of the integer tiers) in a tier, with the per-code width
    (2, 1 or 0.5 B) and the projections' multiply-adds per row."""
    L, D, inner = cfg.num_decoder_layers, cfg.d_model, cfg.inner_dim
    F, V = cfg.d_ff, cfg.vocab_size
    width = {'fused_bf16': 2, 'fused': 1, 'fused_int4': 0.5}[tier]
    per_layer = D * 3 * inner + inner * D + D * inner + inner * D \
        + D * 2 * F + F * D
    weights = width * (L * per_layer + D * V) + 4 * (L * 3 * D + D)
    if tier != 'fused_bf16':
        weights += 4 * (L * (3 * inner + D + inner + D + 2 * F + D) + V)
    return weights, width, L * per_layer + D * V


def window_bound_ms(cfg, batch, pos0, lenc, t_window, tier='fused_bf16'):
    """Least time for one window as a function: each input byte read once
    (only the cache rows < pos0 and the embedding rows the window uses),
    each output byte written once, against HBM bandwidth; and its
    operations: the projections' multiply-adds at the bf16 tensor-core
    peak, the attention dots at the bf16 peak (fused_bf16) or the int8
    peak (integer modes). Each tier counts its own bytes: weights and K/V
    codes at 2 B (bf16), 1 B (int8) or 0.5 B (int4), plus the f32 scales
    (per column, per position, per emitted row). Returns (ms, bound_by)."""
    L, H, dk, D = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv, cfg.d_model
    scaled = tier != 'fused_bf16'
    weights, width, macs = decoder_bytes(cfg, tier)
    kv_pos = L * H * batch * (lenc + pos0)           # K/V positions read
    read = (weights + 2 * t_window * batch * D + 4 * t_window * D
            + 2 * kv_pos * (width * dk + (4 if scaled else 0)) + 8 * batch)
    rows = 2 * t_window * L * H * batch              # emitted K/V rows
    written = 4 * t_window * batch + 4 * batch + (
        rows * (dk + 4) if scaled else rows * 2 * dk)
    proj = t_window * 2 * batch * macs
    attn = 0
    for t in range(t_window):
        attn += L * batch * H * 2 * 2 * dk * (pos0 + t + 1 + lenc)
    t_bytes = (read + written) / HBM_BYTES_PER_S
    t_ops = proj / BF16_FLOPS + attn / (INT8_OPS if scaled else BF16_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def time_ms(torch, fn, runs=TIMED_RUNS, warmup=2):
    """Median per-call device time: CUDA events between back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    events[0].record()
    for i in range(runs):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1])
                             for i in range(runs))


def compare_window(torch, cfg, tier, got, want, logits, last_logits):
    """Per batch row: tokens equal up to a first divergence (its score gap
    read from the plain version's logits); the window's K/V rows compared
    up to that step (bf16 rows; or integer codes and their per-row scales,
    dequantized as code x scale); last-step logits compared for rows whose
    tokens all agree. Returns the readings named above the bounds."""
    exact = tier == 'fused_bf16'
    toks_k, fin_k, rows_k = got[0].cpu(), got[1].cpu(), \
        {k: v.cpu() for k, v in got[2].items()}
    toks_p, fin_p, rows_p = want[0].cpu(), want[1].cpu(), \
        {k: v.cpu() for k, v in want[2].items()}
    logits, last_logits = logits.cpu(), last_logits.cpu()
    T, B = toks_p.shape
    H = cfg.num_heads
    diverged, max_gap = [], 0.0
    equal = total = code_diff = flags_differ = 0
    kv_err = kv_excess = kv_scale = scale_err = scale_max = 0.0
    logit_err = logit_scale = 0.0
    for b in range(B):
        diff = (toks_k[:, b] != toks_p[:, b]).nonzero()
        last = T - 1
        if len(diff):
            d = int(diff[0])
            row = logits[d, b]
            gap = float(row[toks_p[d, b]] - row[toks_k[d, b]])
            max_gap = max(max_gap, gap / float(row.abs().max()))
            diverged.append((b, d))
            last = d
        else:
            flags_differ += int(not torch.equal(fin_k[b], fin_p[b]))
            logit_err = max(logit_err, float(
                (last_logits[b] - logits[T - 1, b]).abs().max()))
            logit_scale = max(logit_scale,
                              float(logits[T - 1, b].abs().max()))

        def row_b(t):          # (T, L, H*B, ...) -> steps <= last of row b
            return t[:last + 1].reshape(last + 1, -1, H, B,
                                        *t.shape[3:])[:, :, :, b]
        for key in ('k', 'v'):
            a, r = row_b(rows_k[key + 'q']), row_b(rows_p[key + 'q'])
            if exact:
                a, r = a.float(), r.float()
            else:
                sk, sp = row_b(rows_k[key + 's']), row_b(rows_p[key + 's'])
                equal += int((a == r).sum())
                total += a.numel()
                code_diff = max(code_diff,
                                int((a.int() - r.int()).abs().max()))
                scale_err = max(scale_err, float((sk - sp).abs().max()))
                scale_max = max(scale_max, float(sp.abs().max()))
                a, r = a.float() * sk[..., None], r.float() * sp[..., None]
                kv_excess = max(kv_excess, float(
                    ((a - r).abs() - sp[..., None]).max()))
            kv_err = max(kv_err, float((a - r).abs().max()))
            kv_scale = max(kv_scale, float(r.abs().max()))
    # the last row starts finished and is checked for pad by the caller
    unfinished_agreeing = B - 1 - sum(1 for b, _ in diverged if b < B - 1)
    out = {'max_abs_err': kv_err, 'kv_rel_err': kv_err / kv_scale,
           'logit_rel_err': logit_err / max(logit_scale, 1e-30),
           'rows_diverged': len(diverged), 'max_gap_rel': max_gap,
           'unfinished_rows_agreeing': unfinished_agreeing,
           'finished_flags_differ': flags_differ}
    if not exact:
        first_layer = max(float((rows_k[k][0, 1] != rows_p[k][0, 1])
                                .float().mean()) for k in ('kq', 'vq'))
        out.update({'kv_rel_err_beyond_step': kv_excess / kv_scale,
                    'codes_unequal': 1 - equal / total,
                    'first_layer_codes_unequal': first_layer,
                    'code_max_diff': code_diff,
                    'scale_rel_err': scale_err / scale_max})
    return out


def violations(tier, readings):
    """The readings past their mode's bounds, as messages."""
    bad = [f'{key} {readings[key]:.4g} > {bound}'
           for key, bound in BOUNDS[tier].items() if readings[key] > bound]
    if readings['unfinished_rows_agreeing'] < 1:
        bad.append('every unfinished row diverged, so no logits were '
                   'compared')
    if readings['finished_flags_differ']:
        bad.append('finished flags differ with equal tokens')
    return bad


def float_attention_control(torch, fd, args):
    """A deliberately wrong plain version of an integer mode: attention
    over cache and cross rows in f32 against the dequantized codes, with
    no int8 requantization of q and the probabilities. The bounds must
    tell the kernel from it: a kernel that skipped the requantization
    would fail them."""
    def scores(q, codes, scale):
        return torch.einsum('bhd,hbdp->bhp', q, codes) \
            * scale.transpose(0, 1)

    def values(p, codes, scale):
        return torch.einsum('bhp,hbdp->bhd', p * scale.transpose(0, 1),
                            codes)
    real = fd._int_scores, fd._int_values
    fd._int_scores, fd._int_values = scores, values
    try:
        return fd.fused_decode_window_reference(*args, return_logits=True)
    finally:
        fd._int_scores, fd._int_values = real


def kernel_cases(torch):
    """Window kernel vs its plain version at full width on the card."""
    phase('kernel vs plain (full width)')
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    from mr_mt3_tpu_torch.ops.fast_decode import stack_decode_params
    from mr_mt3_tpu_torch.utils.builders import init_params

    cfg = MT3Config()
    dev = torch.device('cuda')
    model = init_params(MT3(cfg), seed=0).to(dev).eval()
    T = fd.FUSED_WINDOW
    # (batch, pos0, Lenc): vanilla MT3's 256 encoder rows, and the segment-
    # memory model's 256 + 64 memory rows at 8 chains and at the per-call
    # cap of 64 chains
    cases = [(b, p, 256) for b in (8, 64) for p in (0, 32, 992)] \
        + [(b, 992, 320) for b in (8, 64)]
    results, bad = {}, []
    for tier in TIERS:
        dp = stack_decode_params(model, quantize=tier)
        fp = dp.fused
        results[tier] = []
        # the same seeded encoder states and tokens for every tier
        gen = torch.Generator().manual_seed(1)
        for batch, pos0, lenc in cases:
            enc = (torch.randn((batch, lenc, cfg.d_model), generator=gen)
                   * 0.5).to(dev)
            cross = fd.precompute_cross_kv_fused(dp, cfg, enc)
            cache = fd.init_fused_cache(cfg, batch, 1024, dev, tier)
            tokens = torch.randint(3, cfg.vocab_size, (batch,),
                                   generator=gen, dtype=torch.int32).to(dev)
            finished = torch.zeros(batch, dtype=torch.bool, device=dev)
            # rows < pos0 hold what a decode leaves there: decode up to
            # pos0 with the kernel itself (chained windows)
            for p in range(0, pos0, T):
                toks_w, finished, cache = fd.fused_decode_window(
                    cfg, fp, dp, tokens, finished, p, cache, cross, T)
                tokens = toks_w[:, -1].contiguous()
            finished = finished.clone()
            finished[batch - 1] = True      # a finished row must emit pad
            pos_rows = fd.window_pos_rows(dp, pos0, T)
            args = (cfg, fp, pos_rows, tokens, finished, pos0, cache, cross,
                    T)
            last_logits = torch.empty((batch, cfg.vocab_size), device=dev)
            got = fd.fused_decode_window_cuda(*args, logits_out=last_logits)
            torch.cuda.synchronize()
            want = fd.fused_decode_window_reference(*args,
                                                    return_logits=True)
            if not bool((got[0][:, batch - 1] == cfg.pad_token_id).all()):
                fail(f'{tier}: a finished row emitted a non-pad token')
            errs = compare_window(torch, cfg, tier, got, want[:3], want[3],
                                  last_logits)
            name = f'{tier} B={batch} pos0={pos0} Lenc={lenc}'
            bad += [f'{name}: {v}' for v in violations(tier, errs)]
            if tier != 'fused_bf16':
                ctrl = float_attention_control(torch, fd, args)
                ctrl = compare_window(torch, cfg, tier, got, ctrl[:3],
                                      ctrl[3], last_logits)
                caught = violations(tier, ctrl)
                errs['control'] = {k: ctrl[k] for k in BOUNDS[tier]}
                errs['control_caught_by'] = caught
                if not caught:
                    bad.append(f'{name}: the bounds do not tell the '
                               f'kernel from the f32 attention control')
            ms = time_ms(torch, lambda: fd.fused_decode_window_cuda(*args))
            # the plain window (~1 s a call) is timed only in the case the
            # kernel line reports (WINDOW_MAIN_CASE), for the script's time
            plain_ms = time_ms(
                torch, lambda: fd.fused_decode_window_reference(*args),
                runs=PLAIN_WINDOW_TIMED_RUNS, warmup=0) \
                if (batch, pos0, lenc) == WINDOW_MAIN_CASE else None
            bound, bound_by = window_bound_ms(cfg, batch, pos0, lenc, T,
                                              tier)
            case = {'tier': tier, 'batch': batch, 'pos0': pos0,
                    'lenc': lenc, **errs,
                    'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound,
                    'bound_by': bound_by}
            print(json.dumps(case), flush=True)
            results[tier].append(case)
        del dp, fp, cross, cache
    if bad:
        fail('kernel vs plain version: ' + '; '.join(bad))
    return results


# The step kernel (fused_decode_step) against its plain version. Readings,
# per case: logit_rel_err, the largest |logit difference| over the largest
# |logit|; bf16: kv_rel_err, the emitted rows' largest |difference| over
# their largest |value|, and layer1_kv_rel_err, the same over the second
# layer's rows; integer modes: codes_unequal (share of emitted codes not
# equal, all layers), layer1_codes_unequal (the same over the second
# layer's rows), code_max_diff and scale_rel_err. The second layer's rows
# follow one layer of chunked attention from equal inputs: sum-order
# differences move them only at rounding ties, a wrong chunking moves them
# broadly. Over all eight layers the same differences grow: with a cache of
# seeded random rows the function itself turns a 1-ulp change of its input
# into 3-4% of the logits and 4-7% of the last layer's rows (the plain
# version on the CPU at B 16, position 255), so the all-layer readings are
# wide. In the integer modes a control (the plain version with one chunk:
# the window's softmax, not the step's function) must break a bound
# wherever two or more chunks are live. The layer-1 readings are tied to
# rounding ties, so they jump: one requantized probability code that flips
# in layer 0 moves its row's whole attention output by ~1/127 (run AJ's
# int8 case at position 255, one live chunk, read 0.0456 where run AI's
# cases read at most 0.0101). Bounds about 3x the largest reading of runs
# AI and AJ (NVIDIA H100 80GB HBM3, 700 W; PERF.md), the layer-1 code
# bounds between the kernel's largest reading and the control's smallest
# (int8 0.0456 and 0.343, int4 0.00358 and 0.0176).
STEP_BOUNDS = {
    'fused_bf16': {'logit_rel_err': 0.4,             # read 0.134
                   'kv_rel_err': 0.4,                # 0.136
                   'layer1_kv_rel_err': 1.5e-2},     # 0.00469
    'fused': {'logit_rel_err': 0.25,                 # 0.0759
              'codes_unequal': 0.45,                 # 0.166 (control 0.596)
              'layer1_codes_unequal': 0.12,          # 0.0456
              'code_max_diff': 48,                   # 20
              'scale_rel_err': 0.13},                # 0.0431
    'fused_int4': {'logit_rel_err': 0.4,             # 0.131
                   'codes_unequal': 0.05,            # 0.0194 (control 0.068)
                   'layer1_codes_unequal': 8e-3,     # 0.00358
                   'code_max_diff': 3,               # 2
                   'scale_rel_err': 0.25},           # 0.0840
}
# (batch, position, Lenc) of a 1024-position cache: vanilla MT3's 256
# encoder rows (chunk 256: positions 0 and 255 one live chunk, 256 one, 700
# three, 1023 four) and the segment-memory model's 320 (chunk 512)
STEP_CASES = [(b, p, 256) for b in (8, 64) for p in (0, 255, 256, 700, 1023)] \
    + [(8, p, 320) for p in (511, 512, 1023)]
# The step on a cache the overfit parity model decoded itself (B 8, Lenc
# 256, chunk 256): positions with 1, 2 and 4 live chunks. Its rows are the
# model's own, not seeded noise, so a 1-ulp change does not grow into
# percents of the logits and the bounds can be far tighter than
# STEP_BOUNDS. The previous design (fd_kernel) read (run CD, NVIDIA H100
# 80GB HBM3, 700 W; PERF.md) logits within 9.2e-6 (bf16) and 8e-8 (int)
# of the largest |logit|, rows and codes equal, scales within 8.3e-8:
# readings of f32 rounding. Each bound is about 3x its reading, but not below a floor set
# before the redesign ran at the size of one rounding tie that another f32
# order may break (a bf16 attention output one ulp apart: logits 1e-3,
# rows 8e-3, two ulps of the largest |value|; a few codes of one row, one
# code step; scales 1e-3); each floor at least 3x below the one-chunk
# control's smallest reading (logits 0.0068, int8 / int4 codes 0.118 /
# 0.0091, layer 1 0.237 / 0.0182, scales 0.0042).
PARITY_STEP_TOKENS = 1001
PARITY_STEP_POSITIONS = (200, 500, 1000)
PARITY_STEP_BOUNDS = {
    'fused_bf16': {'logit_rel_err': 1e-3,            # read 9.16e-6
                   'kv_rel_err': 8e-3,               # 0
                   'layer1_kv_rel_err': 8e-3},       # 0
    'fused': {'logit_rel_err': 1e-3,                 # 7.89e-8
              'codes_unequal': 0.02,                 # 0 (control 0.118)
              'layer1_codes_unequal': 0.04,          # 0 (control 0.237)
              'code_max_diff': 1,                    # 0 (control 2)
              'scale_rel_err': 1e-3},                # 8.27e-8 (0.0042)
    'fused_int4': {'logit_rel_err': 1e-3,            # 3.18e-8
                   'codes_unequal': 0.003,           # 0 (control 0.0091)
                   'layer1_codes_unequal': 0.006,    # 0 (control 0.0182)
                   'code_max_diff': 1,               # 0 (control 1)
                   'scale_rel_err': 1e-3},           # 6.83e-8 (0.0056)
}
STEP_PATH_STEPS = 1024
# the step path's steps held against the plain loop (~20-30 ms a step)
STEP_PATH_PLAIN_STEPS = 128
# the grouped window's cases (groups, pos0) and its path's shape, after
# benchmarks/dev_fused_group_axis.py: 8 groups (B 64), t_window 32, chunk 256
GROUPED_CASES = [(g, p) for g in (2, 8) for p in (0, 224, 992)]
GROUPED_T, GROUPED_CHUNK, GROUPED_PATH_GROUPS = 32, 256, 8
SEGMENT_S = 256 * 128 / 16000            # audio seconds in one segment


def step_bound_ms(cfg, batch, position, lenc, tier):
    """Least time for one step as a function: the weights, lm_head, the
    input rows, the cross K/V and the cache rows < position read once, the
    logits and the emitted rows written once, against HBM bandwidth; the
    projections' and attention's operations at the bf16 (or int8) peak.
    Returns (ms, bound_by)."""
    L, H, dk, D = cfg.num_decoder_layers, cfg.num_heads, cfg.d_kv, cfg.d_model
    scaled = tier != 'fused_bf16'
    weights, width, macs = decoder_bytes(cfg, tier)
    kv_pos = L * H * batch * (lenc + position)
    read = weights + 4 * batch * D \
        + 2 * kv_pos * (width * dk + (4 if scaled else 0))
    rows = 2 * L * H * batch
    written = 4 * batch * cfg.vocab_size + (
        rows * (dk + 4) if scaled else rows * 2 * dk)
    t_bytes = (read + written) / HBM_BYTES_PER_S
    attn = L * batch * H * 2 * 2 * dk * (position + 1 + lenc)
    t_ops = 2 * batch * macs / BF16_FLOPS \
        + attn / (INT8_OPS if scaled else BF16_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def seeded_cache(torch, fd, cfg, batch, tier, gen, max_len=1024):
    """A cache whose every position holds a row from gen (a generator on
    the cache's device): bf16 N(0, 1) values, or codes uniform in +-qmax
    with scales 0.5-1.5 / qmax."""
    from mr_mt3_tpu_torch.ops.int8_matmul import pack_int4
    dev = gen.device
    cache = fd.init_fused_cache(cfg, batch, max_len, dev, tier)
    shape = (cfg.num_decoder_layers, cfg.num_heads, batch, cfg.d_kv, max_len)
    for key in ('k', 'v'):
        if tier == 'fused_bf16':
            cache[key + 'q'] = torch.randn(shape, generator=gen,
                                           device=dev).to(torch.bfloat16)
            continue
        qmax = fd.QMAX[tier]
        codes = torch.randint(-qmax, qmax + 1, shape, generator=gen,
                              dtype=torch.int8, device=dev)
        cache[key + 'q'] = pack_int4(codes) if tier == 'fused_int4' \
            else codes
        cache[key + 's'] = (torch.rand(shape[:3] + shape[4:], generator=gen,
                                       device=dev) + 0.5) / qmax
    return cache


def compare_step(torch, tier, got, want):
    """Readings of a step's outputs against another version's (above
    STEP_BOUNDS)."""
    lk, rk = got[0].float(), {k: v.float() for k, v in got[1].items()}
    lp, rp = want[0].float(), {k: v.float() for k, v in want[1].items()}
    err = float((lk - lp).abs().max())
    out = {'max_abs_err': err,
           'logit_rel_err': err / float(lp.abs().max())}
    if tier == 'fused_bf16':
        for name, cut in (('kv_rel_err', slice(None)),
                          ('layer1_kv_rel_err', 1)):
            out[name] = max(float((rk[k][cut] - rp[k][cut]).abs().max()
                                  / rp[k][cut].abs().max())
                            for k in ('kq', 'vq'))
        return out
    out['codes_unequal'] = max(float((rk[k] != rp[k]).float().mean())
                               for k in ('kq', 'vq'))
    out['layer1_codes_unequal'] = max(
        float((rk[k][1] != rp[k][1]).float().mean()) for k in ('kq', 'vq'))
    out['code_max_diff'] = int(max(float((rk[k] - rp[k]).abs().max())
                                   for k in ('kq', 'vq')))
    out['scale_rel_err'] = max(
        float((rk[k] - rp[k]).abs().max() / rp[k].abs().max())
        for k in ('ks', 'vs'))
    return out


def step_violations(tier, readings):
    return [f'{key} {readings[key]:.4g} > {bound}'
            for key, bound in STEP_BOUNDS[tier].items()
            if readings[key] > bound]


def parity_step_violations(tier, readings):
    return [f'{key} {readings[key]:.4g} > {bound}'
            for key, bound in PARITY_STEP_BOUNDS[tier].items()
            if readings[key] > bound]


def parity_step_cases(torch):
    """The step kernel vs its plain version on a cache the parity model
    decoded itself: PARITY_STEP_TOKENS positions from the start token
    through fused_decode_step (B 8: the first song's segments tiled), then
    one step at each of PARITY_STEP_POSITIONS against the plain version,
    within PARITY_STEP_BOUNDS, and in the integer modes against the
    one-chunk control wherever two or more chunks are live. Returns the
    cases per tier."""
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    from mr_mt3_tpu_torch.ops.fast_decode import stack_decode_params

    dev = torch.device('cuda')
    pmodel, penc, _ = parity_encoder_states(torch, dev)
    cfg, batch = pmodel.cfg, 8
    enc = penc.repeat(-(-batch // penc.shape[0]), 1, 1)[:batch]
    results, bad = {}, []
    for tier in TIERS:
        dp = stack_decode_params(pmodel, quantize=tier)
        cross = fd.precompute_cross_kv_fused(dp, cfg, enc)
        cache = fd.init_fused_cache(cfg, batch, 1024, dev, tier)
        chunk = fd.cache_chunk(cache, cross)
        tok = torch.full((batch,), cfg.decoder_start_token_id, device=dev)
        inputs = []
        for pos in range(PARITY_STEP_TOKENS):
            inputs.append(tok)
            logits, cache = fd.fused_decode_step(cfg, dp.fused, dp, tok, pos,
                                                 cache, cross)
            tok = logits.argmax(-1)
        results[tier] = []
        for pos in PARITY_STEP_POSITIONS:
            x = dp.token_embed[inputs[pos]].float() \
                + dp.pos_table[pos].float()
            args = (cfg, dp.fused, x, pos, cache, cross, chunk)
            got = fd.fused_decode_step_cuda(*args)
            torch.cuda.synchronize()
            errs = compare_step(torch, tier, got,
                                fd.fused_decode_step_reference(*args))
            name = f'parity cache {tier} B={batch} pos={pos}'
            bad += [f'{name}: {v}' for v in parity_step_violations(tier,
                                                                   errs)]
            live = -(-pos // chunk)
            if tier != 'fused_bf16' and live > 1:
                ctrl = compare_step(torch, tier, got,
                                    fd.fused_decode_step_reference(
                                        *args[:-1], 1024))
                errs['control'] = {k: ctrl[k]
                                   for k in PARITY_STEP_BOUNDS[tier]}
                errs['control_caught_by'] = parity_step_violations(tier,
                                                                   ctrl)
                if not errs['control_caught_by']:
                    bad.append(f'{name}: the bounds do not tell the kernel '
                               f'from the one-chunk control')
            case = {'tier': tier, 'cache': 'parity', 'batch': batch,
                    'position': pos, 'lenc': enc.shape[1], 'chunk': chunk,
                    'live_chunks': live, **errs}
            print(json.dumps(case), flush=True)
            results[tier].append(case)
    if bad:
        fail('step kernel vs plain version on the parity cache: '
             + '; '.join(bad))
    return results


def step_cases(torch):
    """The step kernel vs its plain version at full width on the card,
    then on the parity model's own cache (parity_step_cases)."""
    phase('step kernel vs plain (full width)')
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    from mr_mt3_tpu_torch.ops.fast_decode import stack_decode_params
    from mr_mt3_tpu_torch.utils.builders import init_params

    cfg = MT3Config()
    dev = torch.device('cuda')
    model = init_params(MT3(cfg), seed=0).to(dev).eval()
    results, bad = {}, []
    for tier in TIERS:
        dp = stack_decode_params(model, quantize=tier)
        fp = dp.fused
        results[tier] = []
        gen = torch.Generator().manual_seed(5)
        cache_gen = torch.Generator(device=dev).manual_seed(6)
        for batch, pos, lenc in STEP_CASES:
            enc = (torch.randn((batch, lenc, cfg.d_model), generator=gen)
                   * 0.5).to(dev)
            cross = fd.precompute_cross_kv_fused(dp, cfg, enc)
            cache = seeded_cache(torch, fd, cfg, batch, tier, cache_gen)
            chunk = fd.cache_chunk(cache, cross)
            tokens = torch.randint(3, cfg.vocab_size, (batch,),
                                   generator=gen).to(dev)
            x = dp.token_embed[tokens].float() + dp.pos_table[pos].float()
            args = (cfg, fp, x, pos, cache, cross, chunk)
            got = fd.fused_decode_step_cuda(*args)
            torch.cuda.synchronize()
            errs = compare_step(torch, tier, got,
                                fd.fused_decode_step_reference(*args))
            name = f'{tier} B={batch} pos={pos} Lenc={lenc}'
            bad += [f'{name}: {v}' for v in step_violations(tier, errs)]
            live = -(-pos // chunk)
            if tier != 'fused_bf16' and live > 1:
                ctrl = compare_step(torch, tier, got,
                                    fd.fused_decode_step_reference(
                                        *args[:-1], 1024))
                errs['control'] = {k: ctrl[k] for k in STEP_BOUNDS[tier]}
                errs['control_caught_by'] = step_violations(tier, ctrl)
                if not errs['control_caught_by']:
                    bad.append(f'{name}: the bounds do not tell the kernel '
                               f'from the one-chunk control')
            ms = time_ms(torch, lambda: fd.fused_decode_step_cuda(*args))
            plain_ms = time_ms(
                torch, lambda: fd.fused_decode_step_reference(*args),
                runs=PLAIN_TIMED_RUNS, warmup=0)
            bound, bound_by = step_bound_ms(cfg, batch, pos, lenc, tier)
            case = {'tier': tier, 'batch': batch, 'position': pos,
                    'lenc': lenc, 'chunk': chunk, 'live_chunks': live,
                    **errs, 'ms': ms, 'plain_ms': plain_ms,
                    'bound_ms': bound, 'bound_by': bound_by}
            print(json.dumps(case), flush=True)
            results[tier].append(case)
        del dp, fp, cross, cache
    if bad:
        fail('step kernel vs plain version: ' + '; '.join(bad))
    for tier, cases in parity_step_cases(torch).items():
        results[tier] += cases
    return results


def first_eos_cut(torch, tokens, eos_id):
    """Per row, the tokens up to and including the first EOS (all if
    none), as lists: what a decode that pads after EOS must agree on."""
    rows = []
    for row in tokens.cpu().tolist():
        rows.append(row[:row.index(eos_id) + 1] if eos_id in row else row)
    return rows


def parity_encoder_states(torch, dev):
    """The parity model on dev, the encoder states of the first song's
    segments under it, and its golden max_length."""
    from mr_mt3_tpu_torch.infer import InferenceHandler
    model, _, max_length, audios = parity_model(torch, 'parity_vanilla.npz')
    model = model.to(dev)
    handler = InferenceHandler(model=model, max_length=max_length,
                               batch_size=4, quantize='fused')
    segments, _, valid = handler._audio_to_segments(audios[0])
    with torch.no_grad():
        enc = model.encode_audio(torch.as_tensor(
            handler._compute_mel(segments, valid), device=dev))
    return model, enc, max_length


def step_loop(torch, fd, cfg, dp, cross, batch, steps, plain=False):
    """Greedy decode through the step (the kernel through fused_decode_step,
    or with plain its plain version), argmax outside; returns the tokens
    (B, steps) and each step's logits if plain."""
    dev = cross['ckq'].device
    # a cache length that both chunk bases (256 and 512) divide
    cache = fd.init_fused_cache(cfg, batch, -(-steps // 512) * 512, dev,
                                fd.fused_tier(dp.fused))
    chunk = fd.cache_chunk(cache, cross)
    tok = torch.full((batch,), cfg.decoder_start_token_id, device=dev)
    out, logits = [], []
    for pos in range(steps):
        if plain:
            x = dp.token_embed[tok].float() + dp.pos_table[pos].float()
            lg, rows = fd.fused_decode_step_reference(
                cfg, dp.fused, x, pos, cache, cross, chunk)
            fd.scatter_step_rows(cfg, cache, rows, pos)
            logits.append(lg)
        else:
            lg, cache = fd.fused_decode_step(cfg, dp.fused, dp, tok, pos,
                                             cache, cross)
        tok = lg.argmax(-1)
        out.append(tok)
    return torch.stack(out, 1), logits


def step_path(torch):
    """The slice's step path: 1024 greedy steps of B=8 segments through
    fused_decode_step in each mode, the launches counted, the first
    STEP_PATH_PLAIN_STEPS steps' tokens against the same loop on the plain
    version (margin rule); the parity model's
    step-driven tokens against its window's."""
    phase(f'step path (fused_decode_step, B=8, {STEP_PATH_STEPS} steps)')
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    from mr_mt3_tpu_torch.ops.fast_decode import (
        greedy_loop_fused,
        stack_decode_params,
    )
    from mr_mt3_tpu_torch.utils.builders import init_params

    cfg = MT3Config()
    dev = torch.device('cuda')
    model = init_params(MT3(cfg), seed=0).to(dev).eval()
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        enc = model.encode_audio(torch.rand((8, 256, cfg.mel_bins),
                                            generator=gen).to(dev))
    out = {}
    for tier in TIERS:
        dp = stack_decode_params(model, quantize=tier)
        cross = fd.precompute_cross_kv_fused(dp, cfg, enc)
        step_loop(torch, fd, cfg, dp, cross, 8, 8)          # warm-up
        torch.cuda.synchronize()
        fd.STEP_LAUNCHES[tier] = 0
        t0 = time.monotonic()
        toks, _ = step_loop(torch, fd, cfg, dp, cross, 8, STEP_PATH_STEPS)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        launches = fd.STEP_LAUNCHES[tier]
        if launches != STEP_PATH_STEPS:
            fail(f'{tier}: {launches} step launches for {STEP_PATH_STEPS} '
                 f'steps')
        t0 = time.monotonic()
        plain, logits = step_loop(torch, fd, cfg, dp, cross, 8,
                                  STEP_PATH_PLAIN_STEPS, plain=True)
        torch.cuda.synchronize()
        plain_secs = time.monotonic() - t0
        gaps, agreeing = [], 0
        for b in range(8):
            diff = (toks[b, :STEP_PATH_PLAIN_STEPS] != plain[b]).nonzero()
            if not len(diff):
                agreeing += 1
                continue
            d = int(diff[0])
            row = logits[d][b]
            gaps.append(float((row[plain[b, d]] - row[toks[b, d]]).abs()
                              / row.abs().max()))
        max_gap = max(gaps, default=0.0)
        if max_gap > BOUNDS[tier]['max_gap_rel']:
            fail(f'{tier} step path: a row parts from the plain loop at a '
                 f'score gap of {max_gap:.4g} (bound '
                 f'{BOUNDS[tier]["max_gap_rel"]})')
        out[tier] = {'steps': STEP_PATH_STEPS, 'launches': launches,
                     'seconds': secs,
                     'ms_per_step': secs / STEP_PATH_STEPS * 1e3,
                     'rtf': 8 * SEGMENT_S / secs,
                     'plain_ms_per_step':
                         plain_secs / STEP_PATH_PLAIN_STEPS * 1e3,
                     'plain_steps': STEP_PATH_PLAIN_STEPS,
                     'rows_agreeing_with_plain': agreeing,
                     'max_gap_rel': max_gap}
        print(f'{tier}: {json.dumps(out[tier])}', flush=True)
    # the overfit parity model: step-driven tokens equal the window's
    # (tests/test_fused_decode.py:225-284), up to each row's first EOS
    pmodel, penc, max_length = parity_encoder_states(torch, dev)
    for tier in ('fused_bf16', 'fused'):
        dp = stack_decode_params(pmodel, quantize=tier)
        cross = fd.precompute_cross_kv_fused(dp, pmodel.cfg, penc)
        stepped, _ = step_loop(torch, fd, pmodel.cfg, dp, cross,
                               penc.shape[0], max_length)
        window = greedy_loop_fused(pmodel.cfg, dp, penc, max_length)[:, 1:]
        eos = pmodel.cfg.eos_token_id
        if first_eos_cut(torch, stepped, eos) != \
                first_eos_cut(torch, window, eos):
            fail(f'{tier}: the step-driven tokens on the parity model '
                 f'differ from the window\'s')
        out[f'parity_{tier}'] = {'rows': penc.shape[0], 'steps': max_length,
                                 'equal_to_window': True}
        print(f'parity model {tier}: {penc.shape[0]} rows x {max_length} '
              f'step-driven tokens equal the window\'s up to each EOS')
    return out


def grouped_as_window(rows, groups, layers, heads):
    """Grouped rows (T, L*G, H*8, ...) -> the window's (T, L, H*B, ...)."""
    out = {}
    for key, r in rows.items():
        tail = r.shape[3:]
        r = r.reshape((r.shape[0], layers, groups, heads, 8) + tail)
        out[key] = r.movedim(3, 2).reshape(
            (r.shape[0], layers, heads * groups * 8) + tail)
    return out


def grouped_cases(torch):
    """The grouped int8 window kernel vs its plain version at full width:
    tokens, codes and scales within the `fused` window's BOUNDS, the
    emitted scales bf16-representable; the `fused` window on the same
    inputs timed beside it (a yardstick, not the same function)."""
    phase('grouped kernel vs plain (full width, int8)')
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    from mr_mt3_tpu_torch.ops import group_axis_kernel as gk
    from mr_mt3_tpu_torch.ops.fast_decode import stack_decode_params
    from mr_mt3_tpu_torch.utils.builders import init_params

    cfg = MT3Config()
    dev = torch.device('cuda')
    model = init_params(MT3(cfg), seed=0).to(dev).eval()
    dp = stack_decode_params(model, quantize='fused')
    fp, T, L, H = dp.fused, GROUPED_T, cfg.num_decoder_layers, cfg.num_heads
    gen = torch.Generator().manual_seed(3)
    results, bad = [], []
    for groups, pos0 in GROUPED_CASES:
        batch = 8 * groups
        enc = (torch.randn((batch, 256, cfg.d_model), generator=gen)
               * 0.5).to(dev)
        cross = gk.regroup_cross_kv(fd.precompute_cross_kv_fused(dp, cfg, enc),
                                    groups)
        cache = gk.init_fused_cache_grouped(cfg, groups, 1024, dev)
        tokens = torch.randint(3, cfg.vocab_size, (batch,), generator=gen,
                               dtype=torch.int32).to(dev)
        finished = torch.zeros(batch, dtype=torch.bool, device=dev)
        for p in range(0, pos0, T):         # rows < pos0 by the kernel
            toks_w, finished, cache = gk.fused_decode_window_grouped(
                cfg, fp, dp, tokens, finished, p, cache, cross, T,
                GROUPED_CHUNK)
            tokens = toks_w[:, -1].contiguous()
        finished = finished.clone()
        finished[batch - 1] = True
        pos_rows = fd.window_pos_rows(dp, pos0, T)
        args = (cfg, fp, pos_rows, tokens, finished, pos0, cache, cross, T,
                GROUPED_CHUNK)
        last_logits = torch.empty((batch, cfg.vocab_size), device=dev)
        got = gk.fused_decode_window_grouped_cuda(*args,
                                                  logits_out=last_logits)
        torch.cuda.synchronize()
        want = gk.fused_decode_window_grouped_reference(*args,
                                                        return_logits=True)
        name = f'grouped G={groups} pos0={pos0}'
        if not bool((got[0][:, batch - 1] == cfg.pad_token_id).all()):
            bad.append(f'{name}: a finished row emitted a non-pad token')
        for key in ('ks', 'vs'):
            s = got[2][key]
            if not torch.equal(s, s.to(torch.bfloat16).float()):
                bad.append(f'{name}: emitted {key} not bf16-representable')
        errs = compare_window(
            torch, cfg, 'fused',
            (got[0], got[1], grouped_as_window(got[2], groups, L, H)),
            (want[0], want[1], grouped_as_window(want[2], groups, L, H)),
            want[3], last_logits)
        bad += [f'{name}: {v}' for v in violations('fused', errs)]
        ms = time_ms(torch, lambda: gk.fused_decode_window_grouped_cuda(*args))
        plain_ms = time_ms(
            torch, lambda: gk.fused_decode_window_grouped_reference(*args),
            runs=PLAIN_WINDOW_TIMED_RUNS, warmup=0)
        flat = {k: gk.ungroup(v, groups).contiguous()
                for k, v in cache.items()}
        flat_cross = {k: gk.ungroup(v, groups).contiguous()
                      for k, v in cross.items()}
        window_ms = time_ms(torch, lambda: fd.fused_decode_window_cuda(
            cfg, fp, pos_rows, tokens, finished, pos0, flat, flat_cross, T))
        bound, bound_by = window_bound_ms(cfg, batch, pos0, 256, T, 'fused')
        case = {'groups': groups, 'batch': batch, 'pos0': pos0,
                'chunk': GROUPED_CHUNK, **errs, 'ms': ms,
                'plain_ms': plain_ms, 'bound_ms': bound,
                'bound_by': bound_by, 'fused_window_ms': window_ms}
        print(json.dumps(case), flush=True)
        results.append(case)
    if bad:
        fail('grouped kernel vs plain version: ' + '; '.join(bad))
    return results


def grouped_decode(torch, cfg, dp, cross, batch, steps, grouped):
    """Chained 32-step windows over `steps` positions from the start token:
    the grouped kernel on group-major operands, or the `fused` window.
    Returns the tokens (B, steps)."""
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    from mr_mt3_tpu_torch.ops import group_axis_kernel as gk
    dev = next(iter(cross.values())).device
    if grouped:
        cache = gk.init_fused_cache_grouped(cfg, batch // 8, steps, dev)
    else:
        cache = fd.init_fused_cache(cfg, batch, steps, dev, 'fused')
    tok = torch.full((batch,), cfg.decoder_start_token_id, device=dev,
                     dtype=torch.int32)
    fin = torch.zeros(batch, dtype=torch.bool, device=dev)
    out = []
    for i in range(0, steps, GROUPED_T):
        if grouped:
            w, fin, cache = gk.fused_decode_window_grouped(
                cfg, dp.fused, dp, tok, fin, i, cache, cross, GROUPED_T,
                GROUPED_CHUNK)
        else:
            w, fin, cache = fd.fused_decode_window(
                cfg, dp.fused, dp, tok, fin, i, cache, cross, GROUPED_T)
        out.append(w)
        tok = w[:, -1].contiguous()
    return torch.cat(out, 1)


def grouped_path(torch):
    """benchmarks/dev_fused_group_axis.py's decode on the card: 8 groups of
    8 segments (B 64), 32-step windows, chunk 256, 1024 steps, its ms and
    RTF against the `fused` window at B 64 on the same encoder states; the
    launches counted; on the parity model tiled to 16 rows the grouped
    tokens equal the window's (tests/test_fused_decode.py:377-438)."""
    groups = GROUPED_PATH_GROUPS
    batch = 8 * groups
    phase(f'grouped path (G={groups}, B={batch}, {STEP_PATH_STEPS} steps)')
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    from mr_mt3_tpu_torch.ops import group_axis_kernel as gk
    from mr_mt3_tpu_torch.ops.fast_decode import stack_decode_params
    from mr_mt3_tpu_torch.utils.builders import init_params

    cfg = MT3Config()
    dev = torch.device('cuda')
    model = init_params(MT3(cfg), seed=0).to(dev).eval()
    dp = stack_decode_params(model, quantize='fused')
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        enc = model.encode_audio(torch.rand((batch, 256, cfg.mel_bins),
                                            generator=gen).to(dev))
    cross = fd.precompute_cross_kv_fused(dp, cfg, enc)
    cross_g = gk.regroup_cross_kv(cross, groups)
    grouped_decode(torch, cfg, dp, cross_g, batch, 64, True)     # warm-up
    grouped_decode(torch, cfg, dp, cross, batch, 64, False)
    torch.cuda.synchronize()
    out = {}
    for name, grouped, c in (('grouped', True, cross_g),
                             ('fused_window', False, cross)):
        gk.LAUNCHES['fused'] = 0
        fd.LAUNCHES['fused'] = 0
        t0 = time.monotonic()
        toks = grouped_decode(torch, cfg, dp, c, batch, STEP_PATH_STEPS,
                              grouped)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        launches = (gk.LAUNCHES if grouped else fd.LAUNCHES)['fused']
        if launches != STEP_PATH_STEPS // GROUPED_T:
            fail(f'{name}: {launches} launches for '
                 f'{STEP_PATH_STEPS // GROUPED_T} windows')
        out[name] = {'seconds': secs, 'launches': launches,
                     'ms_per_step': secs / STEP_PATH_STEPS * 1e3,
                     'rtf': batch * SEGMENT_S / secs, 'tokens': toks}
    out['token_agreement'] = float(
        (out['grouped'].pop('tokens') == out['fused_window'].pop('tokens'))
        .float().mean())
    print(json.dumps(out), flush=True)
    # the parity model's two confident rows tiled to 16 (two groups)
    pmodel, penc, max_length = parity_encoder_states(torch, dev)
    penc = penc[:2].repeat(8, 1, 1)
    pdp = stack_decode_params(pmodel, quantize='fused')
    pcross = fd.precompute_cross_kv_fused(pdp, pmodel.cfg, penc)
    steps = -(-max_length // GROUPED_T) * GROUPED_T
    got = grouped_decode(torch, pmodel.cfg, pdp,
                         gk.regroup_cross_kv(pcross, 2), 16, steps, True)
    want = grouped_decode(torch, pmodel.cfg, pdp, pcross, 16, steps, False)
    if not torch.equal(got, want):
        fail('the grouped tokens on the parity model differ from the '
             'window\'s')
    out['parity_tiled_16'] = {'steps': steps, 'equal_to_window': True}
    print(f'parity model tiled to 16 rows: {steps} grouped tokens equal the '
          f'window\'s')
    return out


def wav_bytes(samples, sr=16000):
    pcm = (samples.clip(-1, 1) * 32767).astype('<i2').tobytes()
    return (b'RIFF' + struct.pack('<I', 36 + len(pcm)) + b'WAVE'
            + b'fmt ' + struct.pack('<IHHIIHH', 16, 1, 1, sr, sr * 2, 2, 16)
            + b'data' + struct.pack('<I', len(pcm)) + pcm)


def clip(seconds, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    x = sum(0.2 * np.sin(2 * np.pi * f * t)
            for f in 220.0 * 2 ** (rng.integers(0, 24, 3) / 12))
    return (x + 1e-3 * rng.normal(size=t.shape)).astype(np.float32)


def windows_needed(tokens, batch, max_length, eos_id, fused_window):
    """Windows the fused decode driver must run to give `tokens` (N,
    max_length + 1), decoded in batches of `batch` rows: per batch, up to
    the window holding the last row's first EOS, or every window when a
    row never emits one. Returns (decode calls, windows)."""
    import numpy as np
    t_win = min(fused_window, max(8, -(-max_length // 8) * 8))
    all_windows = -(-max_length // t_win)
    calls = windows = 0
    for start in range(0, len(tokens), batch):
        steps = []
        for row in tokens[start:start + batch, 1:]:
            eos = np.flatnonzero(row == eos_id)
            steps.append(int(eos[0]) + 1 if len(eos) else max_length + 1)
        calls += 1
        windows += min(all_windows, (max(steps) - 1) // t_win + 1)
    return calls, windows


def serve_clips(torch, handler, info, after=None):
    """Serve the 4 WAV clips from two concurrent clients through the
    port's HTTP server around `handler`; every answer must be MIDI. Then
    after(url), where given, on the same server. Returns the /healthz
    payload, read before after()."""
    from mr_mt3_tpu_torch import serve
    server = serve.make_server(handler, 0, info)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f'http://127.0.0.1:{server.server_address[1]}'
    clips = [(2.5, 0), (4.0, 1), (6.0, 2), (9.5, 3)]
    replies = {}

    def client(jobs):
        for seconds, seed in jobs:
            req = urllib.request.Request(
                url + '/transcribe', data=wav_bytes(clip(seconds, seed)),
                method='POST')
            t1 = time.monotonic()
            with urllib.request.urlopen(req, timeout=600) as resp:
                replies[seed] = (resp.status, resp.read(),
                                 time.monotonic() - t1)

    try:
        t1 = time.monotonic()
        clients = [threading.Thread(target=client, args=(clips[i::2],))
                   for i in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
        wall = time.monotonic() - t1
        with urllib.request.urlopen(url + '/healthz', timeout=60) as resp:
            health = json.loads(resp.read())
        if after is not None:
            after(url)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    for seconds, seed in clips:
        if seed not in replies:
            fail(f'no reply for the {seconds} s clip')
        status, body, secs = replies[seed]
        if status != 200 or body[:4] != b'MThd':
            fail(f'{seconds} s clip: HTTP {status}, body {body[:16]!r}')
        print(f'clip {seconds} s -> {len(body)} MIDI bytes in {secs:.2f} s')
    print(f'{len(clips)} requests in {wall:.2f} s wall')
    return health


def post(url, body):
    """POST body -> (HTTP status, reply bytes, seconds); an error status
    is returned, not raised."""
    req = urllib.request.Request(url, data=body, method='POST')
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.read(), time.monotonic() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read(), time.monotonic() - t0


def flac_requests(url, results):
    """After serve_clips, from one client one after another: the 4.0 s
    clip as 16-bit WAV and as 16-bit FLAC at 16 kHz (serve.decode_audio's
    samples bit-equal; the two decodes' tokens and MIDI replies equal: at
    random weights the MIDI may hold no note), the clip at 44.1 kHz stereo
    as FLAC (200 and MIDI), and a truncated FLAC body (400). The three
    decoding requests must launch the log-mel kernel (one _compute_mel
    each) and, where the server decodes on a window tier, the window
    kernel. Fills `results`."""
    import numpy as np

    from mr_mt3_tpu_torch import serve
    from mr_mt3_tpu_torch.audio import resample
    from mr_mt3_tpu_torch.native import encode_flac_bytes
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    from mr_mt3_tpu_torch.ops import mel_kernel as mk
    samples = clip(4.0, 1)
    wav = wav_bytes(samples)
    flac16 = encode_flac_bytes(
        (samples.clip(-1, 1) * 32767).astype(np.int32), 16000)
    x44 = resample(samples, 16000, 44100)
    flac44 = encode_flac_bytes(
        (np.stack([x44, 0.8 * x44], 1).clip(-1, 1) * 32767).astype(np.int32),
        44100, mid_side=True)
    t0 = time.monotonic()
    from_flac = serve.decode_audio(flac16)
    results['decode_audio_flac16k_ms'] = (time.monotonic() - t0) * 1e3
    from_wav = serve.decode_audio(wav)
    if from_flac.dtype != from_wav.dtype or \
            not np.array_equal(from_flac, from_wav):
        fail('decode_audio: the FLAC body\'s samples differ from the WAV '
             'body\'s')
    replies = {}
    windows0, mels0 = sum(fd.LAUNCHES[t] for t in TIERS), \
        mk.LAUNCHES[mk.KERNEL]
    decodes = TokenLog()
    try:
        for name, body in (('wav_16k', wav), ('flac_16k', flac16),
                           ('flac_44k1_stereo', flac44),
                           ('flac_truncated', flac16[:len(flac16) // 3])):
            replies[name] = post(url + '/transcribe', body)
            status, reply, secs = replies[name]
            print(f'{name}: {len(body)} body bytes -> HTTP {status}, '
                  f'{len(reply)} bytes in {secs:.2f} s')
            results[name] = {'status': status, 'body_bytes': len(body),
                             'reply_bytes': len(reply), 'seconds': secs}
    finally:
        decodes.close()
    tokens = [call[1] for call in decodes.calls]
    if len(tokens) != 3 or not np.array_equal(tokens[0], tokens[1]):
        fail(f'{len(tokens)} decodes for 3 requests, or the WAV and FLAC '
             f'bodies of one clip decoded to different tokens')
    tiers = [call[0] for call in decodes.calls]
    launches = {'window': sum(fd.LAUNCHES[t] for t in TIERS) - windows0,
                mk.KERNEL: mk.LAUNCHES[mk.KERNEL] - mels0}
    print(f'FLAC requests decoded at {tiers}: launches {launches}')
    if launches[mk.KERNEL] != 3 or (
            any(t in TIERS for t in tiers) and launches['window'] < 3):
        fail(f'the FLAC requests at {tiers} launched {launches}')
    results.update({'tokens_compared': int(tokens[0].size), 'tiers': tiers,
                    'decodes': len(tokens), 'launches': launches})
    for name in ('wav_16k', 'flac_16k', 'flac_44k1_stereo'):
        status, reply, _ = replies[name]
        if status != 200 or reply[:4] != b'MThd':
            fail(f'{name}: HTTP {status}, body {reply[:60]!r}')
    if replies['wav_16k'][1] != replies['flac_16k'][1]:
        fail('the WAV and FLAC bodies of one clip gave different MIDI')
    status, reply, _ = replies['flac_truncated']
    if status != 400 or b'FLAC' not in reply:
        fail(f'a truncated FLAC body: HTTP {status}, {reply[:80]!r}')
    print(f'FLAC over HTTP: samples bit-equal to the WAV body\'s, '
          f'{tokens[0].size} tokens and the MIDI equal, 44.1 kHz stereo '
          f'served, the truncated body refused')


class Patches:
    """Stands in for named methods or module functions until closed:
    patch(owner, name, wrapper) makes owner.name call wrapper(real, *args,
    **kw), real being what owner.name was."""

    def __init__(self):
        self.patched = []

    def patch(self, owner, name, wrapper):
        real = getattr(owner, name)
        self.patched.append((owner, name, real))
        setattr(owner, name, lambda *args, **kw: wrapper(real, *args, **kw))

    def close(self):
        for owner, name, real in reversed(self.patched):
            setattr(owner, name, real)
        self.patched = []


class DecodeLog(Patches):
    """Records every InferenceHandler._decode_all call (the server's
    handler, the probe's twins, the prewarm) with its tier, batch and
    length, to work out how many windows each kernel mode had to run."""

    def __init__(self):
        from mr_mt3_tpu_torch.infer import InferenceHandler
        super().__init__()
        self.calls = []

        def recording(real, handler, mel):
            tokens = real(handler, mel)
            self.calls.append((handler.quantize, handler.batch_size,
                               handler.max_length, handler.cfg.eos_token_id,
                               tokens))
            return tokens
        self.patch(InferenceHandler, '_decode_all', recording)

    def windows(self, tier):
        """(decode calls, windows) the decodes on `tier` needed."""
        from mr_mt3_tpu_torch.ops import fused_decode as fd
        calls = windows = 0
        for quantize, batch, max_length, eos_id, tokens in self.calls:
            if quantize == tier:
                c, w = windows_needed(
                    tokens, min(batch, fd.FUSED_MAX_BATCH), max_length,
                    eos_id, fd.FUSED_WINDOW)
                calls, windows = calls + c, windows + w
        return calls, windows


class TokenLog(Patches):
    """Records the tier and the decoded tokens of every song transcribed
    until closed (InferenceHandler._postprocess, which every decode path
    calls once a song)."""

    def __init__(self):
        import numpy as np

        from mr_mt3_tpu_torch.infer import InferenceHandler
        super().__init__()
        self.calls = []

        def recording(real, handler, tokens):
            self.calls.append((handler.quantize, np.array(tokens)))
            return real(handler, tokens)
        self.patch(InferenceHandler, '_postprocess', recording)


class MelLog(Patches):
    """Counts InferenceHandler._compute_mel calls (the served handler's,
    the probe twins', the prewarm's) until closed: on the card each is one
    launch of the log-mel kernel."""

    def __init__(self):
        from mr_mt3_tpu_torch.infer import InferenceHandler
        super().__init__()
        self.calls = 0

        def counting(real, handler, segments, valid):
            self.calls += 1
            return real(handler, segments, valid)
        self.patch(InferenceHandler, '_compute_mel', counting)

    def check(self, launches, where):
        print(f'logmel: {launches} launches for {self.calls} '
              f'_compute_mel calls ({where})')
        if launches != self.calls or self.calls < 1:
            fail(f'logmel: {launches} launches for {self.calls} '
                 f'_compute_mel calls ({where})')


def check_launches(launches, log, tiers):
    """Each tier's launches cover the windows its decodes needed."""
    for tier in tiers:
        calls, windows = log.windows(tier)
        print(f'{tier}: {launches[tier]} window launches for {windows} '
              f'windows over {calls} decode calls')
        if windows < calls or launches[tier] < windows:
            fail(f'{tier}: {launches[tier]} kernel launches for {windows} '
                 f'windows decoded')


class ProbeWalk(Patches):
    """Stands in for serve.quantize_probe, the server's probe entry point,
    until closed, recording each probe of the ladder: its tier, length,
    counts and seconds, or the error it raised."""

    FIELDS = ('tier', 'length', 'flips', 'total', 'material_rows',
              'benign_rows', 'downstream_rows', 'material_margin',
              'margin_noise', 'classify_error', 'error', 'seconds')

    def __init__(self):
        from mr_mt3_tpu_torch import serve
        super().__init__()
        self.steps = []
        self.patch(serve, 'quantize_probe', self.probe)

    def probe(self, real, handler, max_length=None, **kw):
        t0 = time.monotonic()
        tier = handler.quantize
        try:
            res = real(handler, max_length=max_length, **kw)
        except Exception as e:
            self.steps.append({'tier': tier, 'error': repr(e)[:200]})
            raise
        step = {'tier': tier, 'length': max_length or 'short',
                'seconds': round(time.monotonic() - t0, 1)}
        if isinstance(res, dict):
            step.update(res)
        else:
            step['flips'], step['total'] = res
        self.steps.append(step)
        return res

    def print(self):
        for step in self.steps:
            print('ladder: ' + json.dumps({k: step.get(k)
                                            for k in self.FIELDS}))

    def check(self, handler, decode):
        """The /healthz decode block names the served tier, prewarmed; the
        walk started at fused_int4 and no probe, classification or
        demotion came from an exception."""
        if not decode.get('prewarmed') or decode.get('quantize') != \
                handler.quantize:
            fail(f'/healthz decode info: {decode}')
        errors = [st for st in self.steps
                  if 'error' in st or 'classify_error' in st]
        failed = [d for d in decode.get('demotions', []) if 'failed' in d]
        if errors or failed or 'probe_error' in decode or \
                'classify_error' in decode:
            fail(f'a probe raised: {errors or failed or decode}')
        if not self.steps or self.steps[0]['tier'] != 'fused_int4':
            fail('the ladder did not probe fused_int4')


def main_path(torch):
    """`python -m mr_mt3_tpu_torch.serve` as users start it: default tier
    fused_int4, probe ladder and prewarm on, then 4 clips over HTTP."""
    phase('main path: python -m mr_mt3_tpu_torch.serve equivalent')
    from mr_mt3_tpu_torch import serve
    from mr_mt3_tpu_torch.ops import fused_decode as fd

    from mr_mt3_tpu_torch.ops import mel_kernel as mk

    for tier in TIERS:
        fd.LAUNCHES[tier] = 0
    mk.LAUNCHES[mk.KERNEL] = 0
    log = DecodeLog()
    mels = MelLog()
    walk = ProbeWalk()
    try:
        t0 = time.monotonic()
        handler = serve.build_handler(
            [f'eval.max_length={MAIN_PATH_MAX_LENGTH}'])
        if handler.quantize != 'fused_int4' or \
                handler.max_length != MAIN_PATH_MAX_LENGTH:
            fail(f'default tier is {handler.quantize!r}, expected '
                 f'fused_int4')
        info = serve.prepare_handler(handler)
        print(f'handler built, probed and prewarmed in '
              f'{time.monotonic() - t0:.1f} s')
        walk.print()
        flac = {}
        health = serve_clips(torch, handler, info,
                             after=lambda url: flac_requests(url, flac))
    finally:
        walk.close()
        mels.close()
        log.close()
    launches = dict(fd.LAUNCHES)
    launches[mk.KERNEL] = mk.LAUNCHES[mk.KERNEL]
    decode = health['decode']
    print(f'healthz: {json.dumps(health)}')
    walk.check(handler, decode)
    check_launches(launches, log, TIERS)
    mels.check(launches[mk.KERNEL], 'the serving main path')
    if launches['fused_int4'] < 1:
        fail('the int4 kernel was not launched on the main path')
    return {'tier': handler.quantize, 'walk': walk.steps,
            'launches': launches, 'flac_requests': flac,
            'demotions': decode.get('demotions', [])}


def held_tier_serving(torch):
    """Serve the clips through a handler held at each window tier (the
    serve CLI with eval.quantize=<tier>, prepare_handler(probe=False)),
    and at fused_int4 the FLAC requests too (flac_requests)."""
    from mr_mt3_tpu_torch import serve
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    launches = {}
    for tier in TIERS:
        phase(f'serving held at {tier}')
        handler = serve.build_handler([f'eval.quantize={tier}'])
        for t in TIERS:
            fd.LAUNCHES[t] = 0
        log = DecodeLog()
        flac = {}
        try:
            t0 = time.monotonic()
            info = serve.prepare_handler(handler, probe=False)
            print(f'prewarmed in {time.monotonic() - t0:.1f} s')
            # the default tier also serves the FLAC requests: the ladder
            # of the default server may demote at random weights
            health = serve_clips(
                torch, handler, info,
                after=(lambda url: flac_requests(url, flac))
                if tier == 'fused_int4' else None)
        finally:
            log.close()
        if health['decode'].get('quantize') != tier:
            fail(f'/healthz decode info: {health["decode"]}')
        check_launches(fd.LAUNCHES, log, (tier,))
        if len(log.calls) != health['batches'] + 1 + flac.get('decodes', 0):
            fail(f'{len(log.calls)} decodes recorded for '
                 f'{health["batches"]} request batches, the prewarm and '
                 f'{flac.get("decodes", 0)} FLAC requests')
        launches[tier] = fd.LAUNCHES[tier]
        del handler
        torch.cuda.empty_cache()
    return launches


# tests/parity_common.py:36 VANILLA_CFG: the overfit parity model's widths
PARITY_DIMS = dict(d_model=96, d_kv=24, d_ff=192, num_heads=4,
                   num_encoder_layers=2, num_decoder_layers=2)
# where the JAX package's probe ladder leaves the parity model (below)
PARITY_LADDER_TIER = 'fused'


def parity_corpus():
    """The two fixed parity songs, (audios, note lists of (start, end,
    pitch)): a numpy copy of tests/parity_common.py:91-123, which imports
    the JAX package."""
    import numpy as np
    rng = np.random.default_rng(2024)
    sr, t_total = 16000, 3 * 256 * 128
    audios, note_lists = [], []
    for _ in range(2):
        notes = []
        audio = rng.normal(size=t_total).astype(np.float32) * 1e-3
        starts = np.sort(rng.choice(np.arange(1, 11), size=9,
                                    replace=False)) / 2.0
        for s in starts:
            pitch = int(rng.integers(55, 76))
            length = 0.4
            f = 440.0 * 2 ** ((pitch - 69) / 12)
            i0, i1 = int(s * sr), int((s + length) * sr)
            seg_t = np.arange(i1 - i0) / sr
            env = np.minimum(1, np.minimum(seg_t / 0.02,
                                           (length - seg_t) / 0.05))
            audio[i0:i1] += (0.5 * np.sin(2 * np.pi * f * seg_t)
                             * env).astype(np.float32)
            notes.append((s, s + length, pitch))
        audios.append(audio)
        note_lists.append(notes)
    return audios, note_lists


def parity_model(torch, name, **cfg_kw):
    """The overfit parity model of tests/goldens/<name> in the port, its
    weights loaded with numpy through the port's weights bridge; returns
    (model, golden tokens, max_length, the two corpus audios, checked
    against the stored hash)."""
    import hashlib

    import numpy as np

    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.utils.checkpoint_import import (
        state_dict_from_jax_params,
    )
    blob = np.load(os.path.join(REPO, 'tests', 'goldens', name))
    params = {}
    for key in blob.files:
        if key.startswith('param:'):
            node, parts = params, key[len('param:'):].split('/')
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = blob[key]
    audios, _ = parity_corpus()
    sha = hashlib.sha256()
    for a in audios:
        sha.update(np.ascontiguousarray(a, np.float32).tobytes())
    want_sha = blob['audio_sha'].item()
    want_sha = want_sha.decode() if isinstance(want_sha, bytes) else want_sha
    if sha.hexdigest() != want_sha:
        fail('the rebuilt parity audio does not match audio_sha')
    cfg = MT3Config(**PARITY_DIMS, **cfg_kw)
    model = MT3(cfg).eval()
    model.load_state_dict(state_dict_from_jax_params(params, cfg),
                          strict=True)
    return model, blob['tokens'], int(blob['max_length']), audios


def parity_on_card(torch):
    """The overfit parity model through each window tier on the card: no
    token off the golden; then the probe ladder walks it as JAX does."""
    phase('parity on the card (tests/goldens/parity_vanilla.npz)')
    from mr_mt3_tpu_torch import serve
    from mr_mt3_tpu_torch.infer import InferenceHandler
    model, golden, max_length, audios = parity_model(
        torch, 'parity_vanilla.npz')
    flips = {}
    for tier in ('fused_int4', 'fused', 'fused_bf16') + INT8_TIERS:
        handler = InferenceHandler(model=model, max_length=max_length,
                                   batch_size=4, quantize=tier)
        t0 = time.monotonic()
        flips[tier] = 0
        for song, audio in enumerate(audios):
            segments, _, valid = handler._audio_to_segments(audio)
            tokens = handler._decode_all(handler._compute_mel(segments,
                                                              valid))
            if tokens.shape != golden[song].shape:
                fail(f'{tier} song {song}: tokens {tokens.shape}, golden '
                     f'{golden[song].shape}')
            flips[tier] += int((tokens != golden[song]).sum())
        print(f'{tier}: {flips[tier]} of {golden.size} tokens off the '
              f'golden, both songs at max_length {max_length} '
              f'({time.monotonic() - t0:.1f} s)')
        if flips[tier]:
            fail(f'{tier} flipped {flips[tier]} golden tokens on the card')
    # The JAX package's own ladder, on the CPU with this model and the
    # probe audio, demotes fused_int4 for one material first flip (17 of
    # 514 probe tokens, first-flip margin 0.4607) and keeps fused; the
    # port's ladder gives the same dict there
    # (tests/test_torch_probe.py::TestAgainstJax::
    # test_parity_model_probe_equals_jax). The card must walk it the same
    # way, and never for an exception.
    handler = InferenceHandler(model=model, max_length=max_length,
                               batch_size=4, quantize='fused_int4')
    t0 = time.monotonic()
    info = serve.prepare_handler(handler)
    info['seconds'] = round(time.monotonic() - t0, 1)
    print(f'ladder on the parity model: {json.dumps(info)}')
    demotions = info.get('demotions', [])
    if handler.quantize != PARITY_LADDER_TIER or len(demotions) != 1 or \
            'material' not in demotions[0] or 'probe_error' in info:
        fail(f'the ladder on the parity model ended at '
             f'{handler.quantize!r}, not as the JAX ladder does '
             f'({PARITY_LADDER_TIER!r} after one material-flip demotion): '
             f'{info}')
    return {'flips': flips, 'ladder': info,
            'int8_ladders': parity_int8_ladders(torch, model)}


# Depth cut for time: the step-by-step tiers' eager legs (graphs=False, a
# comparison only; 12.7-14.6 ms a step on an NVIDIA H100 80GB HBM3 at
# 700 W whose host ran ~1.5x slower than usual, PERF.md §5) decode
# WORST_EAGER_STEPS steps, against the first as many of the graphed
# 1024-step decode; the graphed main path keeps 1024
WORST_EAGER_STEPS = 256


def worst_case(torch):
    """B=8, 1024-step decode on each window tier, each int8 tier and the
    exact fp32 path. The step-by-step tiers (int8, int8_kv, none) run both
    ways: the eager switch (graphs=False, comparison only, the first
    WORST_EAGER_STEPS steps) and the main path, replayed CUDA graphs
    (every phase captured first, its seconds and memory read); for each,
    device_per_step gives the device's busy time per step, its idle share
    of the timed step, and the int8 kernels' share. The exact tier's
    graphed tokens must equal its eager ones; an int8 tier's may part only
    where infer/probe.classify_flips calls the first flip of the row
    benign."""
    phase('worst-case decode (B=8, max_length 1024)')
    from mr_mt3_tpu_torch.infer import InferenceHandler
    from mr_mt3_tpu_torch.infer.probe import classify_flips
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.ops.decode import greedy_decode
    from mr_mt3_tpu_torch.ops.fast_decode import (
        capture_phases,
        stack_decode_params,
    )
    from mr_mt3_tpu_torch.utils.builders import init_params

    cfg = MT3Config()
    dev = torch.device('cuda')
    model = init_params(MT3(cfg), seed=0).to(dev).eval()
    gen = torch.Generator().manual_seed(2)
    mel = torch.rand((8, 256, cfg.mel_bins), generator=gen).to(dev)
    audio_s = 8 * 256 * 128 / 16000
    out, rows = {}, {}

    def timed(tier, dp, label, graphs=None, max_length=1024):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        toks = greedy_decode(model, mel, max_length, quantize=tier, dp=dp,
                             graphs=graphs)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        toks = toks.cpu()
        if toks.shape != (8, max_length + 1) or int(toks.min()) < 0 or \
                int(toks.max()) >= cfg.vocab_size:
            fail(f'{label}: bad tokens {tuple(toks.shape)}')
        steps = int((toks[:, 1:] != cfg.pad_token_id).sum(1).max())
        row = {'seconds': secs, 'steps': steps,
               'ms_per_step': secs / max(steps, 1) * 1e3,
               'rtf': audio_s / secs}
        print(f'{label}: {secs:.3f} s, {steps} steps decoded, '
              f'{row["ms_per_step"]:.4f} ms/step, realtime factor '
              f'{row["rtf"]:.2f}')
        return toks, row

    def profiled(tier, dp, label, row, graphs=None):
        def decode(n):
            return greedy_decode(model, mel, n, quantize=tier, dp=dp,
                                 graphs=graphs)
        for n in PROFILE_STEPS:      # the graphs of both lengths captured
            decode(n)
        row.update(device_per_step(torch, decode, row['ms_per_step']))
        print(f'{label}: device busy {row["device_ms_per_step"]:.4f} '
              f'ms/step at positions {PROFILE_STEPS[0]}-'
              f'{PROFILE_STEPS[1] - 1} (idle share {row["idle_share"]:.3f} '
              f'of the timed step); int8 kernels ms/step '
              f'{json.dumps(row["kernel_ms_per_step"])}')

    for tier in ('fused_int4', 'fused', 'fused_bf16') + INT8_TIERS + (
            'none',):
        dp = stack_decode_params(model, quantize=tier)
        greedy_decode(model, mel[:, :, :], 32, quantize=tier, dp=dp,
                      graphs=False)
        if tier in TIERS:
            out[tier], rows[tier] = timed(tier, dp, tier)
            continue
        eager, rows[tier] = timed(tier, dp, f'{tier} eager', graphs=False,
                                  max_length=WORST_EAGER_STEPS)
        profiled(tier, dp, f'{tier} eager', rows[tier], graphs=False)
        t0 = time.monotonic()
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        capture = capture_phases(dp)
        torch.cuda.synchronize()
        capture['seconds_with_warmups'] = time.monotonic() - t0
        capture['allocated_bytes_after'] = torch.cuda.memory_allocated()
        capture['allocated_bytes_before'] = allocated
        print(f'{tier}: captured {capture["graphs"]} graphs of 8 steps in '
              f'{capture["capture_seconds"]:.3f} s of captures '
              f'({capture["seconds_with_warmups"]:.3f} s with their '
              f'warm-ups), graph memory {capture["graph_allocated_bytes"]} '
              f'bytes allocated and {capture["graph_reserved_bytes"]} '
              f'reserved (torch.cuda.memory_allocated / memory_reserved '
              f'before and after each capture)')
        out[tier], graphed = timed(tier, dp, f'{tier} graphed')
        profiled(tier, dp, f'{tier} graphed', graphed)
        graphed['capture'] = capture
        rows[tier] = {'eager': rows[tier], 'graphed': graphed,
                      **{k: graphed[k] for k in ('ms_per_step', 'rtf',
                                                 'seconds', 'steps')}}
        prefix = out[tier][:, :eager.shape[1]]
        same = bool((prefix == eager).all())
        rows[tier]['graphed_equals_eager'] = same
        print(f'{tier}: graphed tokens equal the eager ones over the first '
              f'{WORST_EAGER_STEPS} steps: {same}')
        if tier == 'none' and not same:
            fail('the exact tier\'s graphed tokens differ from its eager '
                 'ones')
        if not same:
            handler = InferenceHandler(model=model,
                                       max_length=WORST_EAGER_STEPS,
                                       quantize=tier)
            flips = classify_flips(handler, prefix.numpy(), eager.numpy(),
                                   mel)
            rows[tier]['graphed_vs_eager_flips'] = flips
            print(f'{tier}: graphed vs eager flips {json.dumps(flips)}')
            if flips['material_rows']:
                fail(f'{tier}: the graphed loop parts from the eager one '
                     f'at a material margin: {flips}')
    for tier in ('fused_int4', 'fused', 'fused_bf16') + INT8_TIERS:
        agree = float((out[tier] == out['none']).float().mean())
        rows[tier]['agreement_with_exact'] = agree
        print(f'{tier} vs exact token agreement: {agree:.4f}')
    return rows


# The step-by-step tiers' device time per step: decodes of PROFILE_STEPS[0]
# and PROFILE_STEPS[1] steps, each under torch.profiler; the difference of
# their device time over the extra steps leaves out the encoder and the
# set-up both share, so it reads the steps at positions PROFILE_STEPS[0]
# to PROFILE_STEPS[1] - 1 (the attention's share grows with the position:
# a lower bound of a 1024-step decode's mean)
PROFILE_STEPS = (8, 40)
# the CUDA kernels of the int8 tiers, by their names in a trace
INT8_KERNEL_NAMES = {'int8_matmul': 'i8mm_kernel',
                     'int8_gated_ff': 'i8ff_kernel',
                     'int8_decode_attention': 'i8att_kernel'}


def device_time(torch, fn, by_name=False):
    """Device time of one call of fn from a torch.profiler trace: the
    summed durations of the events on the card (kernels, copies, sets), in
    all and of the int8 kernels by name (ms); with by_name, also every
    device event's ms by its name. Host events are left out: the device
    time the profiler gives an operator is that of the kernels it
    launched, which are counted once, as device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total, kernels = 0.0, {name: 0.0 for name in INT8_KERNEL_NAMES}
    names = {}
    for event in prof.events():
        if event.device_type != DeviceType.CUDA:
            continue
        ms = event.time_range.elapsed_us() / 1e3
        total += ms
        names[event.name] = names.get(event.name, 0.0) + ms
        for name, symbol in INT8_KERNEL_NAMES.items():
            if symbol in event.name:
                kernels[name] += ms
    if total <= 0:
        fail('torch.profiler recorded no device time')
    return (total, kernels, names) if by_name else (total, kernels)


# calls of a kernel in one trace_ms or queued_ms reading
TRACE_RUNS = 20


def kernel_trace_ms(torch, fn, symbol, runs=TRACE_RUNS, tries=3):
    """The kernel's own time: the device duration (ms) of the events whose
    name holds `symbol` over `runs` calls of fn, from one torch.profiler
    trace. time_ms's intervals also hold the host's cost of
    each call (the wrapper's checks, ctypes), which sets them once a kernel
    takes a few microseconds. The profiler drops or cuts short an event
    now and then: the reading is the median of the events the trace
    holds, and a trace that holds fewer than half of them is taken again,
    `tries` times. symbol may be a tuple of names, any of which counts.
    Used by `versus` only: processes that had opened some 30-40 sessions
    lost kernel events in the next (runs DB and DU), so the default run's
    int8 phase reads queued_ms instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    symbols = (symbol,) if isinstance(symbol, str) else tuple(symbol)
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        ms = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and any(sym in e.name for sym in symbols)]
        if 2 * len(ms) >= runs:
            return statistics.median(ms)
    fail(f'{tries} traces of {runs} calls each hold {len(ms)} of the '
         f'kernels {symbols}')


# cycles of the spin kernel that queued_ms puts first: ~10 ms at the
# H100's 1.98 GHz, against the ~1 ms the host takes to queue 20 calls of
# a wrapper (~50 us each, time_ms)
QUEUE_SPIN_CYCLES = 20_000_000


def queued_ms(torch, calls, runs=TRACE_RUNS, tries=3):
    """Each fn of calls' device time per call with the host's cost hidden
    (ms): `runs` calls of each are queued behind a spin kernel
    (torch.cuda._sleep), so that the card runs them back to back, and CUDA
    events between the calls time each one (the median). time_ms's
    intervals also hold the host's cost of each call (the wrapper's
    checks, ctypes), which sets them once a kernel takes a few
    microseconds. A reading counts only where the spin was still running
    when the host had queued every call; else the spin is made 4x longer
    and the calls are queued again, `tries` times. No profiler session
    (see kernel_trace_ms)."""
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    cycles = QUEUE_SPIN_CYCLES
    for _ in range(tries):
        spun = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        spun.record()
        events = []
        for fn in calls:
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(runs + 1)]
            ev[0].record()
            for i in range(runs):
                fn()
                ev[i + 1].record()
            events.append(ev)
        ahead = not spun.query()
        torch.cuda.synchronize()
        if ahead:
            return [statistics.median(ev[i].elapsed_time(ev[i + 1])
                                      for i in range(runs))
                    for ev in events]
        cycles *= 4
    fail(f'the host did not queue {runs} calls of each of {len(calls)} '
         f'functions within a spin of {cycles // 4} cycles, {tries} times')


def device_per_step(torch, decode, wall_ms_per_step):
    """decode(n) decodes n steps; its device busy ms per step over the
    steps PROFILE_STEPS apart, the int8 kernels' share of it by name, and
    the idle share of wall_ms_per_step (a timed decode's)."""
    (short, k_short), (full, k_full) = (
        device_time(torch, lambda n=n: decode(n)) for n in PROFILE_STEPS)
    extra = PROFILE_STEPS[1] - PROFILE_STEPS[0]
    per_step = (full - short) / extra
    if per_step <= 0:
        fail(f'device time does not grow with the steps: {short:.4f} ms '
             f'for {PROFILE_STEPS[0]}, {full:.4f} for {PROFILE_STEPS[1]}')
    return {'device_ms_per_step': per_step,
            'idle_share': 1 - per_step / wall_ms_per_step,
            'kernel_ms_per_step': {k: (k_full[k] - k_short[k]) / extra
                                   for k in k_full}}


# fused_attention_fwd against its plain version on the same inputs: both
# keep f32 scores and an f32 softmax and sum in other orders (the kernel's
# bf16 products on the tensor cores), so an output or a probability near a
# bf16 rounding midpoint rounds one ulp apart. Bounds at about 3x the
# largest reading over the cases of the calibration run (run J, NVIDIA
# H100 80GB HBM3, 700 W; PERF.md, H100 port): rel_err, the largest
# |difference| over the largest |plain output|, read 0.0035 (one bf16 ulp
# of the largest output); unequal, the share of outputs not equal, 4.5e-4.
ATTN_BOUNDS = {'rel_err': 1e-2, 'unequal': 1.5e-3}
# (name, batch, Lq, Lk, heads, head width, causal): the memory encoder
# (B 8 chains, and 64, the per-call cap), the probe's teacher-forced
# decoder self-attention and cross-attention (Lk 256 + 64 = 320, padded
# to 384) at full width, the parity model's head width 24, a ragged causal
# length (520: not a multiple of the kernels' 64-row tiles) and a key
# length past the ~3400 keys at which the earlier design (f32 score rows
# in shared memory) refused to launch (4096 keys)
ATTN_CASES = [
    ('memory_encoder_b8', 8, 1024, 1024, 6, 64, False),
    ('memory_encoder_b64', 64, 1024, 1024, 6, 64, False),
    ('decoder_causal_b8', 8, 1024, 1024, 6, 64, True),
    ('cross_1024x320_b8', 8, 1024, 320, 6, 64, False),
    ('parity_d24_b8', 8, 1024, 1024, 4, 24, False),
    ('ragged_causal_520_b8', 8, 520, 520, 6, 64, True),
    ('long_kv_1024x4096_b2', 2, 1024, 4096, 6, 64, False),
    # a model=2 rank's heads of the memory encoder (the model axis)
    ('memory_encoder_tp_h3_b8', 8, 1024, 1024, 3, 64, False),
]


def attention_columns(lq, kv_valid, causal):
    """The key columns the Lq rows see in all."""
    return sum(min(kv_valid, i + 1) if causal else kv_valid
               for i in range(lq))


def attention_flops(b, lq, kv_valid, h, d, causal, products=2):
    """Operations of the function (q.k and p.v, or the backward's five
    products) over the columns each row sees."""
    return 2 * products * b * h * d * attention_columns(lq, kv_valid, causal)


def attention_bound_ms(b, lq, lk, kv_valid, h, d, causal):
    """Least time for the call as a function: q, the kv_valid K/V rows and
    the output moved once (bf16), against HBM; and the multiply-adds this
    data needs (q.k and p.v over the columns each row sees) at the bf16
    tensor-core peak. Returns (ms, bound_by)."""
    flops = attention_flops(b, lq, kv_valid, h, d, causal)
    nbytes = 2 * b * h * d * (2 * lq + 2 * kv_valid)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def attention_control(torch, q, k, v, causal, kv_valid):
    """A deliberately wrong plain forward, the one-pass flash shortcut:
    e = exp(s - max) rounded to bf16 before it is normalized, the output
    divided by the row sum after the value product. ATTN_BOUNDS must catch
    it (the function normalizes p in f32 before it rounds it). e = p /
    max(p) and the row sum is 1 / max(p), since e is 1 at the max."""
    from mr_mt3_tpu_torch.ops import train_attention as ta
    p = ta._probabilities(q, k, causal, kv_valid)
    top = p.amax(-1, keepdim=True)
    o = torch.einsum('bhqk,bkhd->bhqd', (p / top).to(v.dtype).float(),
                     v.float())
    return (o * top).transpose(1, 2).to(q.dtype)


def attention_readings(torch, got, want):
    """max_abs_err; rel_err, the largest |difference| over the largest
    |plain output|; unequal, the share of outputs not equal."""
    diff = (got.float() - want.float()).abs()
    return {'max_abs_err': float(diff.max()),
            'rel_err': float(diff.max()) / float(want.float().abs().max()),
            'unequal': float((got != want).float().mean())}


def attention_cases(torch):
    """fused_attention_fwd vs its plain version at the main path's shapes:
    fused_attention (the wrapper models/mt3.py calls) on the unpadded K/V
    against fused_attention_reference on K/V padded by _pad_kv. Then the
    kernel's time (fused_attention_cuda on the padded K/V), the plain
    version's, the bound and PyTorch's scaled_dot_product_attention (scale
    1.0, the same padded tensors, the kv_valid mask as a boolean
    attn_mask) as a yardstick."""
    phase('fused_attention_fwd vs plain (full width)')
    import torch.nn.functional as F

    from mr_mt3_tpu_torch.ops import train_attention as ta
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(3)
    results, bad = [], []
    for name, b, lq, lk, h, d, causal in ATTN_CASES:
        q, k, v = [torch.randn((b, n, h, d), generator=gen).to(
            dev, torch.bfloat16) for n in (lq, lk, lk)]
        before = ta.LAUNCHES[ta.KERNEL]
        got = ta.fused_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if ta.LAUNCHES[ta.KERNEL] != before + 1:
            fail(f'{name}: fused_attention did not launch the kernel')
        kp, vp, valid = ta._pad_kv(k, v)
        want = ta.fused_attention_reference(q, kp, vp, causal, valid)
        scale = float(want.float().abs().max())
        readings = attention_readings(torch, got, want)
        bad += [f'{name}: {key} {readings[key]:.4g} > {bound}'
                for key, bound in ATTN_BOUNDS.items()
                if readings[key] > bound]
        control = attention_readings(
            torch, attention_control(torch, q, kp, vp, causal, valid), want)
        caught = [key for key, bound in ATTN_BOUNDS.items()
                  if control[key] > bound]
        if not caught:
            bad.append(f'{name}: ATTN_BOUNDS pass the control (divide '
                       f'after the product): {control}')
        qt, kt, vt = (t.transpose(1, 2) for t in (q, kp, vp))
        mask = None
        if valid < kp.shape[1]:
            mask = (torch.arange(kp.shape[1], device=dev) < valid).expand(
                lq, kp.shape[1])

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal, scale=1.0)
        lib_out = library().transpose(1, 2).float()
        ms = time_ms(torch, lambda: ta.fused_attention_cuda(
            q, kp, vp, causal, valid))
        plain_ms = time_ms(torch, lambda: ta.fused_attention_reference(
            q, kp, vp, causal, valid), runs=PLAIN_TIMED_RUNS, warmup=0)
        library_ms = time_ms(torch, library)
        bound, bound_by = attention_bound_ms(b, lq, kp.shape[1], valid, h,
                                             d, causal)
        tflops = attention_flops(b, lq, valid, h, d, causal) / ms / 1e9
        case = {'case': name, 'batch': b, 'lq': lq, 'lk': kp.shape[1],
                'kv_valid': valid, 'heads': h, 'head_width': d,
                'causal': causal, **readings,
                'control': control, 'control_caught_by': caught,
                'library_rel_diff': float((lib_out - want.float()).abs()
                                          .max()) / scale,
                'ms': ms, 'plain_ms': plain_ms, 'library_ms': library_ms,
                'bound_ms': bound, 'bound_by': bound_by, 'tflops': tflops}
        print(json.dumps(case), flush=True)
        print(f'{name}: {ms:.4f} ms, {tflops:.1f} TFLOP/s of the '
              f'function (bound {bound:.4f} ms by {bound_by}); control '
              f'caught by {caught}', flush=True)
        results.append(case)
        del q, k, v, kp, vp, got, want, lib_out
        torch.cuda.empty_cache()
    if bad:
        fail('fused_attention_fwd vs plain version: ' + '; '.join(bad))
    return results


# fused_attention_bwd against its plain version on the same inputs. Both
# recompute f32 scores and an f32 softmax and round p and ds to bf16, and
# sum in other orders, so a value near a bf16 rounding midpoint rounds one
# step apart; dq sums ds k, whose terms cancel (each row of ds sums to
# zero), so its f32 noise is large against its value and more of its
# roundings flip. Per gradient: rel_err, the largest |difference| over the
# largest |plain value|; unequal, the share of values not equal;
# ulp_apart, the share more than one bf16 step (of the larger magnitude)
# apart. Bounds at about 3x the largest reading of the calibration run
# (run Q, NVIDIA H100 80GB HBM3, 700 W; PERF.md): rel_err 0.0034 (one
# bf16 step of the largest value), unequal 0.0082 and ulp_apart 0.0046
# (both dq's; dk and dv read at most 0.0015 and 0.00025).
ATTN_BWD_BOUNDS = {'rel_err': 1e-2, 'unequal': 2.5e-2, 'ulp_apart': 1.5e-2}
# (name, batch, Lq, Lk, heads, head width, causal) at the training step's
# B 12 (num_rows_per_batch): the memory encoder, the decoder's causal
# self-attention and its cross-attention over 256 + 64 rows (padded to
# 384) at a bucketed target length of 1024, the head width 24, a ragged
# causal length (520) and a key length past the earlier design's
# shared-memory cap (4096 keys, B 2)
ATTN_BWD_CASES = [
    ('memory_encoder_b12', 12, 1024, 1024, 6, 64, False),
    ('decoder_causal_b12', 12, 1024, 1024, 6, 64, True),
    ('cross_1024x320_b12', 12, 1024, 320, 6, 64, False),
    ('d24_b12', 12, 1024, 1024, 4, 24, False),
    ('ragged_causal_520_b12', 12, 520, 520, 6, 64, True),
    ('long_kv_1024x4096_b2', 2, 1024, 4096, 6, 64, False),
    # a model=2 rank's heads of the memory encoder (the model axis)
    ('memory_encoder_tp_h3_b8', 8, 1024, 1024, 3, 64, False),
]


def bf16_steps_apart(torch, got, want):
    """Share of entries more than one bf16 step (of the larger magnitude)
    apart."""
    mag = torch.maximum(got.abs(), want.abs())
    _, exp = torch.frexp(mag)
    step = torch.ldexp(torch.ones_like(mag), exp - 8)
    return float(((got - want).abs() > step).float().mean())


def attention_backward_bound_ms(b, lq, kv_valid, h, d, causal):
    """Least time for the backward as a function: q, dO, the kv_valid K/V
    rows, dq and the kv_valid dK/dV rows moved once (bf16), against HBM;
    and the multiply-adds of its five products (q k^T, dO v^T, p^T dO,
    ds k, ds^T q) over the columns each row sees, at the bf16 tensor-core
    peak. Returns (ms, bound_by)."""
    flops = attention_flops(b, lq, kv_valid, h, d, causal, products=5)
    nbytes = 2 * b * h * d * (3 * lq + 4 * kv_valid)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def attention_backward_control(torch, q, k, v, do, causal, kv_valid):
    """The backward with FlashAttention-2's delta, rowsum(dO * O) from the
    forward's bf16 output, in place of the function's rowsum(dp * p) from
    f32 p and dp (O came from the rounded p, so the two differ). Read
    against ATTN_BWD_BOUNDS; a miss is recorded, not a failure."""
    from mr_mt3_tpu_torch.ops import train_attention as ta
    p = ta._probabilities(q, k, causal, kv_valid)
    out = ta.fused_attention_reference(q, k, v, causal, kv_valid).float()
    dof = do.float()
    pb = p.to(do.dtype).float()
    dv = torch.einsum('bhqk,bqhd->bkhd', pb, dof)
    dp = torch.einsum('bqhd,bkhd->bhqk', dof, v.float())
    delta = (dof * out).sum(-1).transpose(1, 2)[..., None]
    dsb = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.einsum('bhqk,bkhd->bqhd', dsb, k.float())
    dk = torch.einsum('bhqk,bqhd->bkhd', dsb, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_backward_readings(torch, got, want):
    """Per gradient (dq, dk, dv; want trimmed to got's length): max_abs_err,
    rel_err, unequal and ulp_apart (ATTN_BWD_BOUNDS' readings)."""
    readings = {}
    for g_name, g, w in zip(('dq', 'dk', 'dv'), got, want):
        w = w[:, :g.shape[1]].float()
        g = g.float()
        diff = (g - w).abs()
        readings[g_name] = {
            'max_abs_err': float(diff.max()),
            'rel_err': float(diff.max()) / float(w.abs().max()),
            'unequal': float((g != w).float().mean()),
            'ulp_apart': bf16_steps_apart(torch, g, w)}
    return readings


def attention_backward_cases(torch):
    """fused_attention_bwd vs its plain version at the training step's
    shapes: autograd through fused_attention (as models/mt3.py calls it, on
    the unpadded K/V: the padding's gradient trimmed) against
    fused_attention_backward_reference on the padded K/V; two kernel runs
    on the same inputs must be bit-identical. Then the kernel's time
    (fused_attention_backward_cuda on the padded K/V), the plain
    version's, the bound and the backward of PyTorch's
    scaled_dot_product_attention (torch.autograd.grad, scale 1.0, the same
    padded tensors; a yardstick the port never calls)."""
    phase('fused_attention_bwd vs plain (full width)')
    import torch.nn.functional as F

    from mr_mt3_tpu_torch.ops import train_attention as ta
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(5)
    results, bad = [], []
    for name, b, lq, lk, h, d, causal in ATTN_BWD_CASES:
        q, k, v, do = [torch.randn((b, n, h, d), generator=gen).to(
            dev, torch.bfloat16) for n in (lq, lk, lk, lq)]
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = ta.LAUNCHES[ta.KERNEL_BWD]
        out = ta.fused_attention(*leaves, causal=causal)
        got = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        if ta.LAUNCHES[ta.KERNEL_BWD] != before + 1:
            fail(f'{name}: the backward did not launch the kernel')
        kp, vp, valid = ta._pad_kv(k, v)
        want = ta.fused_attention_backward_reference(q, kp, vp, do, causal,
                                                     valid)
        readings = attention_backward_readings(torch, got, want)
        bad += [f'{name} {g_name}: {key} {reading[key]:.4g} > {bound}'
                for g_name, reading in readings.items()
                for key, bound in ATTN_BWD_BOUNDS.items()
                if reading[key] > bound]
        control = attention_backward_readings(
            torch, attention_backward_control(torch, q, kp, vp, do, causal,
                                              valid), want)
        caught = [f'{g_name} {key}' for g_name, reading in control.items()
                  for key, bound in ATTN_BWD_BOUNDS.items()
                  if reading[key] > bound]
        del got, want, out, leaves
        first = ta.fused_attention_backward_cuda(q, kp, vp, do, causal, valid)
        again = ta.fused_attention_backward_cuda(q, kp, vp, do, causal, valid)
        identical = all(torch.equal(x, y) for x, y in zip(first, again))
        if not identical:
            bad.append(f'{name}: two runs on the same inputs differ')
        del first, again
        ms = time_ms(torch, lambda: ta.fused_attention_backward_cuda(
            q, kp, vp, do, causal, valid))
        plain_ms = time_ms(torch, lambda: ta.fused_attention_backward_reference(
            q, kp, vp, do, causal, valid), runs=PLAIN_TIMED_RUNS, warmup=0)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, kp, vp))
        mask = None
        if valid < kp.shape[1]:
            mask = (torch.arange(kp.shape[1], device=dev) < valid).expand(
                lq, kp.shape[1])
        lib_out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal, scale=1.0)
        dot = do.transpose(1, 2)
        library_ms = time_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True))
        bound, bound_by = attention_backward_bound_ms(b, lq, valid, h, d,
                                                      causal)
        tflops = attention_flops(b, lq, valid, h, d, causal,
                                 products=5) / ms / 1e9
        case = {'case': name, 'batch': b, 'lq': lq, 'lk': kp.shape[1],
                'kv_valid': valid, 'heads': h, 'head_width': d,
                'causal': causal, **readings, 'bit_identical': identical,
                'max_abs_err': max(r['max_abs_err']
                                   for r in readings.values()),
                'delta_control': control,
                'delta_control_caught_by': caught,
                'ms': ms, 'plain_ms': plain_ms, 'library_ms': library_ms,
                'bound_ms': bound, 'bound_by': bound_by, 'tflops': tflops}
        print(json.dumps(case), flush=True)
        print(f'{name}: {ms:.4f} ms, {tflops:.1f} TFLOP/s of the '
              f'function (bound {bound:.4f} ms by {bound_by}); the '
              f'rowsum(dO * O) delta control caught by '
              f'{caught or "nothing"}', flush=True)
        results.append(case)
        del q, k, v, do, kp, vp, qt, kt, vt, lib_out, dot
        torch.cuda.empty_cache()
    if bad:
        fail('fused_attention_bwd vs plain version: ' + '; '.join(bad))
    return results


# the parts of versus(): each times this tree's kernels against another
# design's sources of the same kernels
VERSUS_PARTS = ('attention', 'logmel', 'decode', 'int8')
VERSUS_SOURCES = {'attention': ('fused_attention_fwd', 'fused_attention_bwd'),
                  'logmel': ('logmel',),
                  'decode': ('fused_decode_window', 'fused_decode_step'),
                  'int8': ('int8_matmul', 'int8_decode_attention')}
# (batch, pos0, Lenc) of the window cases timed against the old design
VERSUS_WINDOW_CASES = [(b, p, 256) for b in (8, 64) for p in (0, 32, 992)] \
    + [(8, 992, 320), (64, 992, 320)]
VERSUS_STEP_CASES = [(8, 1023), (64, 1023)]
VERSUS_GROUPED_CASES = [(8, 0), (8, 992)]
# window runs a turn: ~10-100 ms each, 4 turns a case
VERSUS_WINDOW_RUNS = 5
# the decoder megakernels by their names in a trace (csrc/fused_decode.cuh:
# fd_kernel, fw_kernel and, above 8 rows of the step and the grouped
# window, ft_kernel)
DECODE_KERNEL_SYMBOLS = ('fd_kernel<', 'fw_kernel<', 'ft_kernel<')


def versus_turns(torch, run_old, run_new, runs=TIMED_RUNS):
    """old, new, new, old with time_ms; the old times left out (and its
    error kept) where it cannot run."""
    times = {'old_ms': [], 'new_ms': []}
    try:
        run_old()
        torch.cuda.synchronize()
    except RuntimeError as e:
        times['old_error'] = str(e)
    for which in ('old', 'new', 'new', 'old'):
        if which == 'old' and 'old_error' in times:
            continue
        times[f'{which}_ms'].append(time_ms(
            torch, run_old if which == 'old' else run_new, runs=runs))
    return times


def old_libraries(old_dir, names):
    """Build old_dir/<name>.cu for each name (with its PARTS where old_dir
    holds them; one nvcc a source, in parallel, with cuda_build's flags,
    headers from old_dir) into old_dir/_build and load them."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from mr_mt3_tpu_torch.ops import cuda_build
    out_dir = os.path.join(old_dir, '_build')

    def build(name):
        try:
            path, _ = cuda_build.build(
                name, out=os.path.join(out_dir, f'lib{name}.so'),
                csrc=old_dir)
        except RuntimeError as e:
            fail(f'the old {name}.cu does not build:\n{e}')
        return ctypes.CDLL(str(path))
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


def versus(torch, old_dir, parts=VERSUS_PARTS):
    """This tree's kernels against the design they replace, on one card in
    one call. old_dir holds that design's sources: a git-ignored copy of
    another commit's csrc/ (e.g. `git archive <commit>
    mr_mt3_tpu_torch/csrc | tar -x -C .archive/parent_csrc
    --strip-components=2`), with the headers they include; each takes the
    same C launch as this tree's, or a prefix of its pointers. Parts:
    'attention' (the forward and backward kernels per ATTN_CASES and
    ATTN_BWD_CASES, then TRAIN_TIMED_STEPS train steps at B 12 with a
    profile of one step), 'logmel' (B 8 and 64 segments, with
    compute_logmel timed beside) and 'decode' (the window per mode at
    VERSUS_WINDOW_CASES on a seeded cache, the step at VERSUS_STEP_CASES,
    the grouped int8 window at VERSUS_GROUPED_CASES) and 'int8' (every
    int8_kernel_cases case of int8_matmul, int8_gated_ff and
    int8_decode_attention, with each kernel's own time from a trace beside
    the launch's). Each case is timed in turns (old, new, new, old) through
    the same C launch; a case the old design refuses records its error.
    Writes versus.json under OUT_DIR. Alone:

        python3 -c "import torch, chip_smoke; chip_smoke.build_kernels();
        chip_smoke.versus(torch, '.archive/parent_csrc')"

    (one part: parts=('int8',)).
    """
    phase('kernels against the design they replace')
    names = [n for part in parts for n in VERSUS_SOURCES[part]]
    old = old_libraries(old_dir, names)
    results = {'card': card_line()}
    if 'attention' in parts:
        results.update(attention_versus(torch, old))
    if 'logmel' in parts:
        results['logmel'] = logmel_versus(torch, old['logmel'])
    if 'decode' in parts:
        results.update(decode_versus(torch, old))
    if 'int8' in parts:
        results.update(int8_versus(torch, old))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'versus.json'), 'w') as f:
        json.dump(results, f, indent=1)
    phase(None)
    return results


def attention_versus(torch, old):
    """versus()'s attention part; old holds the old libraries."""
    import contextlib
    import ctypes

    import numpy as np

    from mr_mt3_tpu_torch.ops import train_attention as ta
    from mr_mt3_tpu_torch.train import optim
    from mr_mt3_tpu_torch.train.trainer import (create_train_state,
                                                make_train_step)
    old_f, old_b = old[ta.KERNEL], old[ta.KERNEL_BWD]
    old_f.faf_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    old_b.fab_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    for lib, fn in ((old_f, 'faf_error_string'),
                    (old_b, 'fab_error_string')):
        getattr(lib, fn).argtypes = [ctypes.c_int]
        getattr(lib, fn).restype = ctypes.c_char_p
    new_f, new_b = ta._library(), ta._library_bwd()

    def forward(lib, q, k, v, causal, valid):
        b, lq, h, d = q.shape
        out = torch.empty_like(q)
        rc = lib.faf_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), b, lq, k.shape[1], h, d, valid,
                            int(causal),
                            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(lib.faf_error_string(rc).decode())
        return out

    def backward(lib, q, k, v, do, causal, valid):
        b, lq, h, d = q.shape
        grads = [torch.empty_like(t) for t in (q, k, v)]
        stats = torch.empty((3, b, h, lq), dtype=torch.float32,
                            device=q.device)
        rc = lib.fab_launch(*(t.data_ptr() for t in (q, k, v, do, *grads)),
                            stats.data_ptr(), b, lq, k.shape[1], h, d,
                            valid, int(causal),
                            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(lib.fab_error_string(rc).decode())
        return tuple(grads)

    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(3)
    results = {'forward': [], 'backward': []}
    for kind, cases in (('forward', ATTN_CASES),
                        ('backward', ATTN_BWD_CASES)):
        for name, b, lq, lk, h, d, causal in cases:
            q, k, v, do = [torch.randn((b, n, h, d), generator=gen).to(
                dev, torch.bfloat16) for n in (lq, lk, lk, lq)]
            kp, vp, valid = ta._pad_kv(k, v)
            if kind == 'forward':
                times = versus_turns(
                    torch,
                    lambda: forward(old_f, q, kp, vp, causal, valid),
                    lambda: forward(new_f, q, kp, vp, causal, valid))
                flops = attention_flops(b, lq, valid, h, d, causal)
            else:
                times = versus_turns(
                    torch,
                    lambda: backward(old_b, q, kp, vp, do, causal, valid),
                    lambda: backward(new_b, q, kp, vp, do, causal, valid))
                flops = attention_flops(b, lq, valid, h, d, causal,
                                        products=5)
            case = {'case': name, **times, 'new_tflops': flops / min(
                times['new_ms']) / 1e9}
            print(json.dumps({kind: case}), flush=True)
            results[kind].append(case)
            del q, k, v, do, kp, vp
            torch.cuda.empty_cache()

    @contextlib.contextmanager
    def design(lib_f, lib_b):
        real = ta.fused_attention_cuda, ta.fused_attention_backward_cuda
        ta.fused_attention_cuda = lambda *a: forward(lib_f, *a)
        ta.fused_attention_backward_cuda = lambda *a: backward(lib_b, *a)
        try:
            yield
        finally:
            ta.fused_attention_cuda, ta.fused_attention_backward_cuda = real

    cfg, _ = training_configs()
    model = training_model(torch, cfg, 'fused', TRAIN_PARITY_SEEDS[0])
    state = create_train_state(model, optim.make_optimizer(
        2e-4, use_schedule=False))
    step = make_train_step()
    big = training_batch(np.random.default_rng(6),
                         int(cfg.num_rows_per_batch), 1024, 900)
    results['train_step'] = {'old': [], 'new': []}
    for which in ('old', 'new', 'new', 'old'):
        libs = (old_f, old_b) if which == 'old' else (new_f, new_b)
        with design(*libs):
            step(state, big, None)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            for _ in range(TRAIN_TIMED_STEPS):
                step(state, big, None)
            torch.cuda.synchronize()
            ms = (time.monotonic() - t0) / TRAIN_TIMED_STEPS * 1e3
            prof = train_step_profile(torch, lambda: step(state, big, None),
                                      ms)
        print(f'train step, {which} design: {ms:.2f} ms/step', flush=True)
        print_step_profile(f'{which} design', prof)
        results['train_step'][which].append({'ms_per_step': ms, **prof})
    return results


def logmel_versus(torch, old_lib):
    """versus()'s log-mel part: each design's C launch on the same tone
    segments (B in LOGMEL_BATCHES), the old on its DFT constants, the new
    on its FFT tables, in turns; compute_logmel timed beside; the largest
    |difference| between the two outputs."""
    import ctypes

    from mr_mt3_tpu_torch.audio import SpectrogramConfig, compute_logmel
    from mr_mt3_tpu_torch.ops import mel_kernel as mk
    old_lib.logmel_launch.argtypes = [ctypes.c_void_p] * 5 \
        + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    new_lib = mk._library()
    cfg = SpectrogramConfig()
    dev = torch.device('cuda')
    cos_m, sin_m, fbank = (torch.from_numpy(c).to(dev)
                           for c in mk._dft_constants(cfg))
    tables = mk._device_constants(cfg, dev)
    hop, fft, mel = cfg.hop_width, cfg.fft_size, cfg.num_mel_bins
    cases = []
    for batch in LOGMEL_BATCHES:
        n = LOGMEL_SAMPLES
        frames = -(-n // hop)
        x = torch.from_numpy(logmel_inputs('tone', batch, n)).to(dev)
        outs = [torch.empty((batch, frames, mel), device=dev)
                for _ in range(2)]
        stream = torch.cuda.current_stream().cuda_stream

        def run_old():
            rc = old_lib.logmel_launch(
                x.data_ptr(), cos_m.data_ptr(), sin_m.data_ptr(),
                fbank.data_ptr(), outs[0].data_ptr(), batch, n, hop, fft,
                frames, fft // 2 + 1, cos_m.shape[1], mel, mk.EPS, stream)
            if rc:
                raise RuntimeError(f'old logmel launch failed: {rc}')

        def run_new():
            rc = new_lib.logmel_launch(
                x.data_ptr(), *(t.data_ptr() for t in tables),
                outs[1].data_ptr(), batch, n, hop, fft, frames, mel, mk.EPS,
                stream)
            if rc:
                raise RuntimeError(f'new logmel launch failed: {rc}')
        times = versus_turns(torch, run_old, run_new)
        run_new()
        torch.cuda.synchronize()
        case = {'batch': batch, **times,
                'library_ms': time_ms(torch, lambda: compute_logmel(x, cfg)),
                'old_vs_new_max_abs': float((outs[0] - outs[1]).abs().max())}
        print(json.dumps({'logmel': case}), flush=True)
        cases.append(case)
    return cases


def decode_versus(torch, old):
    """versus()'s decode part: the window in each mode, the step in each
    mode and the grouped int8 window, the old libraries called with the
    first of this tree's launch pointers that they count (the new ones sit
    at the end), on seeded caches of 1024 positions."""
    import contextlib
    import ctypes

    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    from mr_mt3_tpu_torch.ops import group_axis_kernel as gk
    from mr_mt3_tpu_torch.ops.fast_decode import stack_decode_params
    from mr_mt3_tpu_torch.utils.builders import init_params
    libs = {name: (old[name], fd._LIBRARIES[name][0])
            for name in ('fused_decode_window', 'fused_decode_step')}
    for name, (lib, prefix) in libs.items():
        for entry in fd._LIBRARIES[name][1]:
            getattr(lib, entry).argtypes = [ctypes.c_void_p] * 2 + [
                ctypes.c_float, ctypes.c_void_p]
        getattr(lib, prefix + '_error_string').restype = ctypes.c_char_p

    def old_launch(name, entry, label, tensors, dims, eps, dev):
        lib, prefix = libs[name]
        tensors = tensors[:getattr(lib, prefix + '_pointer_count')()]
        ptrs = (ctypes.c_void_p * len(tensors))(
            *[None if t is None else t.data_ptr() for t in tensors])
        rc = getattr(lib, entry)(ptrs, (ctypes.c_int * len(dims))(*dims),
                                 eps, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f'old {label}: '
                               + getattr(lib, prefix + '_error_string')(rc)
                               .decode())

    @contextlib.contextmanager
    def old_design():
        real = fd._launch
        fd._launch = old_launch
        try:
            yield
        finally:
            fd._launch = real

    def timed(run, trace=False):
        def run_old():
            with old_design():
                run()
        times = versus_turns(torch, run_old, run, runs=VERSUS_WINDOW_RUNS)
        if trace:         # each kernel's own time, in turns (old, new)
            for which, fn in (('old', run_old), ('new', run)):
                times[f'{which}_trace_ms'] = kernel_trace_ms(
                    torch, fn, DECODE_KERNEL_SYMBOLS, runs=TRACE_RUNS // 2)
        return times

    cfg = MT3Config()
    dev = torch.device('cuda')
    model = init_params(MT3(cfg), seed=0).to(dev).eval()
    T = fd.FUSED_WINDOW
    gen = torch.Generator().manual_seed(9)
    cache_gen = torch.Generator(device=dev).manual_seed(10)
    out = {'window': [], 'step': [], 'grouped': []}
    for tier in TIERS:
        dp = stack_decode_params(model, quantize=tier)
        fp = dp.fused
        for batch, pos0, lenc in VERSUS_WINDOW_CASES:
            enc = (torch.randn((batch, lenc, cfg.d_model), generator=gen)
                   * 0.5).to(dev)
            cross = fd.precompute_cross_kv_fused(dp, cfg, enc)
            cache = seeded_cache(torch, fd, cfg, batch, tier, cache_gen)
            tokens = torch.randint(3, cfg.vocab_size, (batch,), generator=gen,
                                   dtype=torch.int32).to(dev)
            finished = torch.zeros(batch, dtype=torch.bool, device=dev)
            args = (cfg, fp, fd.window_pos_rows(dp, pos0, T), tokens,
                    finished, pos0, cache, cross, T)
            case = {'tier': tier, 'batch': batch, 'pos0': pos0, 'lenc': lenc,
                    **timed(lambda: fd.window_launch(*args))}
            print(json.dumps({'window': case}), flush=True)
            out['window'].append(case)
        for batch, pos in VERSUS_STEP_CASES:
            enc = (torch.randn((batch, 256, cfg.d_model), generator=gen)
                   * 0.5).to(dev)
            cross = fd.precompute_cross_kv_fused(dp, cfg, enc)
            cache = seeded_cache(torch, fd, cfg, batch, tier, cache_gen)
            tokens = torch.randint(3, cfg.vocab_size, (batch,),
                                   generator=gen).to(dev)
            x = dp.token_embed[tokens].float() + dp.pos_table[pos].float()
            args = (cfg, fp, x, pos, cache, cross, fd.cache_chunk(cache,
                                                                  cross))
            case = {'tier': tier, 'batch': batch, 'position': pos,
                    **timed(lambda: fd.fused_decode_step_cuda(*args),
                            trace=True)}
            print(json.dumps({'step': case}), flush=True)
            out['step'].append(case)
        if tier == 'fused':
            for groups, pos0 in VERSUS_GROUPED_CASES:
                batch = 8 * groups
                enc = (torch.randn((batch, 256, cfg.d_model), generator=gen)
                       * 0.5).to(dev)
                cross = gk.regroup_cross_kv(
                    fd.precompute_cross_kv_fused(dp, cfg, enc), groups)
                cache = gk.init_fused_cache_grouped(cfg, groups, 1024, dev)
                tokens = torch.randint(3, cfg.vocab_size, (batch,),
                                       generator=gen, dtype=torch.int32
                                       ).to(dev)
                finished = torch.zeros(batch, dtype=torch.bool, device=dev)
                args = (cfg, fp, fd.window_pos_rows(dp, pos0, T), tokens,
                        finished, pos0, cache, cross, T, GROUPED_CHUNK)
                case = {'groups': groups, 'pos0': pos0, **timed(
                    lambda: gk.fused_decode_window_grouped_cuda(*args),
                    trace=True)}
                print(json.dumps({'grouped': case}), flush=True)
                out['grouped'].append(case)
        del dp, fp
        torch.cuda.empty_cache()
    return out


def int8_versus(torch, old):
    """versus()'s int8 part: every int8_kernel_cases case (int8_case_inputs)
    through each design's C launch with the same arguments (a design
    whose feed-forward takes no scratch and barrier words ignores those
    last two), in turns: the launches' time_ms and the kernel's own
    trace_ms, and the largest |difference| between the two outputs."""
    import ctypes

    from mr_mt3_tpu_torch.ops import int8_attention as i8a
    from mr_mt3_tpu_torch.ops import int8_matmul as i8m
    ptr, num = ctypes.c_void_p, ctypes.c_int
    old_mm, old_att = old['int8_matmul'], old['int8_decode_attention']
    old_mm.i8mm_launch.argtypes = [ptr] * 4 + [num] * 4 + [ptr]
    old_mm.i8ff_launch.argtypes = [ptr] * 8 + [num] * 4 + [ptr] * 3
    old_att.i8att_launch.argtypes = [ptr] * 6 + [num] * 6 + [ptr]
    libs = {'old': (old_mm, old_att), 'new': (i8m._library(), i8a._library())}
    dev = torch.device('cuda')
    stream = torch.cuda.current_stream().cuda_stream
    dtype_id = i8m._DTYPE_ID
    out = {k: [] for k in INT8_KERNEL_NAMES}
    for kernel, case, args in int8_case_inputs(torch):
        x = args[0]
        b, dt = x.shape[0], dtype_id[x.dtype]
        if kernel == 'int8_matmul':
            _, w, s = args
            shape = (b, w.shape[1])
            ptrs = [t.data_ptr() for t in args]
            dims = [b, *w.shape, dt]
        elif kernel == 'int8_gated_ff':
            h, w0, s0, w1, s1, wo, so = args
            shape = h.shape
            f = w0.shape[1]
            ptrs = [t.data_ptr() for t in (h, w0, w1, wo, s0, s1, so)]
            dims = [b, h.shape[1], f, dt]
            g = torch.empty((b, -(-f // 8) * 8), dtype=torch.bfloat16,
                            device=dev)
            extra = [g.data_ptr(), i8m._barrier(dev, stream).data_ptr()]
        else:
            q, kq, ks, vq, vs, pos = args
            shape = (b, q.shape[1] * q.shape[2])
            ptrs = [t.data_ptr() for t in (q, kq, ks, vq, vs)]
            dims = [*q.shape, kq.shape[-1], pos, dt]
        outs = {k: torch.empty(shape, dtype=x.dtype, device=dev)
                for k in ('old', 'new')}

        def launch(which):
            mm, att = libs[which]
            o = outs[which].data_ptr()
            if kernel == 'int8_matmul':
                rc = mm.i8mm_launch(*ptrs, o, *dims, stream)
            elif kernel == 'int8_gated_ff':
                rc = mm.i8ff_launch(*ptrs, o, *dims, stream, *extra)
            else:
                rc = att.i8att_launch(*ptrs[:5], o, *dims, stream)
            if rc:
                raise RuntimeError(f'{which} {kernel} launch failed: {rc}')
        run_old, run_new = (lambda: launch('old')), (lambda: launch('new'))
        case.update(versus_turns(torch, run_old, run_new))
        symbol = INT8_KERNEL_NAMES[kernel]
        for which in ('old', 'new', 'new', 'old'):
            case.setdefault(f'{which}_trace_ms', []).append(kernel_trace_ms(
                torch, run_old if which == 'old' else run_new, symbol))
        torch.cuda.synchronize()
        case['old_vs_new_max_abs'] = float(
            (outs['old'].float() - outs['new'].float()).abs().max())
        print(json.dumps({kernel: case}), flush=True)
        out[kernel].append(case)
    return {'int8': out}


# tests/parity_common.py:39-42: the segment-memory parity models
WITHPREV_KW = dict(segmem_variant='encoder_append', segmem_length=16)
V1_KW = dict(segmem_variant='decoder_prepend', segmem_length=16,
             segmem_seed='eos')


def segmem_parity_on_card(torch):
    """parity_withprev.npz contiguous through the exact path and the three
    window tiers, parity_v1.npz through the exact path: no token off the
    golden. Then the withprev model at bf16, its memory encoder on the
    kernel and on einsum: the same tokens."""
    phase('segment-memory parity on the card (parity_withprev.npz, '
          'parity_v1.npz)')
    from mr_mt3_tpu_torch.infer import InferenceHandler
    from mr_mt3_tpu_torch.ops import fast_decode
    from mr_mt3_tpu_torch.ops import train_attention as ta
    from mr_mt3_tpu_torch.ops.decode import module_runners
    from mr_mt3_tpu_torch.ops.fast_decode import merge_stats

    def decode_songs(model, quantize, audios, max_length):
        handler = InferenceHandler(model=model, max_length=max_length,
                                   contiguous_inference=True,
                                   segment_bucket=1, quantize=quantize)
        out = []
        for audio in audios:
            segments, _, valid = handler._audio_to_segments(audio)
            out.append(handler._decode_all(handler._compute_mel(segments,
                                                                valid)))
        return out

    flips = {}
    for name, kw, tiers in (
            ('parity_withprev.npz', WITHPREV_KW,
             ('none',) + TIERS + INT8_TIERS),
            ('parity_v1.npz', V1_KW, ('none',))):
        model, golden, max_length, audios = parity_model(torch, name, **kw)
        for tier in tiers:
            t0 = time.monotonic()
            module_steps = fast_decode.STEPS['module']
            tokens = decode_songs(model, tier, audios, max_length)
            if name == 'parity_v1.npz':
                # the v1 model's exact path: _greedy_loop's captured blocks
                stats = merge_stats(list(module_runners(model).values()))
                ran = fast_decode.STEPS['module'] - module_steps
                print(f'{name}: {ran} module-path steps, graphs '
                      f'{json.dumps(stats)}')
                if ran < 1 or stats['graphs'] < 1:
                    fail(f'{name}: the module path ran {ran} steps and '
                         f'captured {stats["graphs"]} graphs')
            off = sum(int((t != g).sum()) for t, g in zip(tokens, golden))
            flips[f'{name}:{tier}'] = off
            print(f'{name} {tier}: {off} of {golden.size} tokens off the '
                  f'golden, contiguous, max_length {max_length} '
                  f'({time.monotonic() - t0:.1f} s)')
            if off:
                fail(f'{name} {tier} flipped {off} golden tokens on the '
                     f'card')
            if tier in INT8_TIERS:
                plain = PlainInt8()
                try:
                    want = decode_songs(model, tier, audios, max_length)
                finally:
                    plain.close()
                differ = sum(int((a != b).sum())
                             for a, b in zip(tokens, want))
                print(f'{name} {tier}: {differ} tokens differ between the '
                      f'kernels and their plain versions')
                flips[f'{name}:{tier}:kernels_vs_plain'] = differ
                if differ:
                    fail(f'{name} {tier}: the kernels and their plain '
                         f'versions differ in {differ} tokens')
    # the withprev model at bf16: memory encoder through the kernel, then
    # through einsum; the exact decode path in both
    bf16 = {}
    for kernel in ('fused', 'einsum'):
        model, golden, max_length, audios = parity_model(
            torch, 'parity_withprev.npz', dtype='bfloat16',
            attention_kernel=kernel, **WITHPREV_KW)
        ta.LAUNCHES[ta.KERNEL] = 0
        bf16[kernel] = decode_songs(model, 'none', audios, max_length)
        launches = ta.LAUNCHES[ta.KERNEL]
        off = sum(int((t != g).sum()) for t, g in zip(bf16[kernel], golden))
        print(f'withprev at bf16, attention_kernel={kernel!r}: {off} of '
              f'{golden.size} tokens off the fp32 golden, {launches} '
              f'fused_attention launches')
        if (launches > 0) != (kernel == 'fused'):
            fail(f'attention_kernel={kernel!r} launched the kernel '
                 f'{launches} times')
        flips[f'withprev_bf16_{kernel}_vs_fp32_golden'] = off
    differ = sum(int((a != b).sum()) for a, b in zip(bf16['fused'],
                                                     bf16['einsum']))
    print(f'bf16 withprev: {differ} tokens differ between the kernel and '
          f'einsum')
    if differ:
        fail(f'the bf16 withprev tokens differ between the kernel and '
             f'einsum in {differ} places')
    flips['bf16_kernel_vs_einsum'] = differ
    return flips


class SegmemLog(Patches):
    """Records every memory-chain decode (InferenceHandler._segmem_on)
    with its tier, length, tokens and valid rows, every memory-encoder
    call (MT3.compute_segmem) and every teacher-forced forward, to work out
    the window launches the chains needed and the fused_attention launches
    the model's long attentions make."""

    def __init__(self):
        from mr_mt3_tpu_torch.infer import InferenceHandler
        from mr_mt3_tpu_torch.models import MT3
        from mr_mt3_tpu_torch.models import mt3
        super().__init__()
        self.decodes, self.attention_calls = [], 0
        self.memory_encoder_calls = self.forwards = 0
        log = self

        def fused(model, length):
            """Whether a full-sequence attention at this length takes the
            kernel: the model's rule (mt3.Attention._fused_eligible)."""
            return length >= mt3._FUSED_MIN_LEN and length % 8 == 0 and \
                mt3.resolve_attention_kernel(
                    model.cfg, model.proj.weight.device) == 'fused'

        def segmem_decode(real, handler, replica, mel_segments, valid_mask):
            tokens = real(handler, replica, mel_segments, valid_mask)
            log.decodes.append((handler.quantize, handler.max_length,
                                handler.cfg.eos_token_id, tokens,
                                valid_mask.cpu().numpy()))
            return tokens

        def compute_segmem(real, model, prev_ids):
            log.memory_encoder_calls += 1
            if fused(model, prev_ids.shape[1]):
                log.attention_calls += model.cfg.segmem_num_layers
            return real(model, prev_ids)

        def forward(real, model, mel, decoder_input_ids, targets_prev=None):
            log.forwards += 1
            if fused(model, decoder_input_ids.shape[1]):
                # each decoder layer: causal self- and cross-attention
                log.attention_calls += 2 * model.cfg.num_decoder_layers
            return real(model, mel, decoder_input_ids, targets_prev)
        self.patch(InferenceHandler, '_segmem_on', segmem_decode)
        self.patch(MT3, 'compute_segmem', compute_segmem)
        self.patch(MT3, 'forward', forward)

    def windows(self, tier):
        """(chain decodes, windows) the chains on `tier` needed: per
        segment, up to the window of the last valid row's first EOS."""
        from mr_mt3_tpu_torch.ops import fused_decode as fd
        calls = windows = 0
        for quantize, max_length, eos_id, tokens, valid in self.decodes:
            if quantize != tier:
                continue
            calls += 1
            for s in range(tokens.shape[1]):
                _, w = windows_needed(tokens[valid, s], len(tokens),
                                      max_length, eos_id, fd.FUSED_WINDOW)
                windows += w
        return calls, windows


SEGMEM_ARGS = ['model=MT3NetSegMemV2WithPrev', 'trainer.precision=bf16']


def segmem_main_path(torch):
    """`python -m mr_mt3_tpu_torch.serve model=MT3NetSegMemV2WithPrev
    trainer.precision=bf16` as users start it: the paper's model at full
    width, seed-0 random weights, default tier fused_int4, probe ladder and
    prewarm on, then the WAV clips over HTTP from two clients."""
    phase('segment-memory main path: python -m mr_mt3_tpu_torch.serve '
          + ' '.join(SEGMEM_ARGS))
    from mr_mt3_tpu_torch import serve
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    from mr_mt3_tpu_torch.ops import train_attention as ta

    from mr_mt3_tpu_torch.ops import mel_kernel as mk

    for tier in TIERS:
        fd.LAUNCHES[tier] = 0
    ta.LAUNCHES[ta.KERNEL] = 0
    mk.LAUNCHES[mk.KERNEL] = 0
    log = SegmemLog()
    mels = MelLog()
    walk = ProbeWalk()
    try:
        t0 = time.monotonic()
        handler = serve.build_handler(
            SEGMEM_ARGS + [f'eval.max_length={MAIN_PATH_MAX_LENGTH}'])
        cfg = handler.cfg
        if handler.quantize != 'fused_int4' or \
                handler.max_length != MAIN_PATH_MAX_LENGTH or \
                cfg.segmem_variant != 'encoder_append' or \
                cfg.dtype != 'bfloat16' or handler.contiguous_inference:
            fail(f'the segmem server is not the paper model at bf16, '
                 f'chained, from fused_int4: {cfg}, {handler.quantize!r}')
        info = serve.prepare_handler(handler)
        ready = time.monotonic() - t0
        print(f'handler built, probed and prewarmed in {ready:.1f} s '
              f'(prewarm buckets {info.get("prewarm_buckets")}, '
              f'{info.get("prewarm_seconds")} s)')
        walk.print()
        health = serve_clips(torch, handler, info)
    finally:
        walk.close()
        mels.close()
        log.close()
    launches = dict(fd.LAUNCHES)
    launches[ta.KERNEL] = ta.LAUNCHES[ta.KERNEL]
    launches[mk.KERNEL] = mk.LAUNCHES[mk.KERNEL]
    mels.check(launches[mk.KERNEL], 'the segment-memory main path')
    decode = health['decode']
    print(f'healthz: {json.dumps(health)}')
    walk.check(handler, decode)
    for tier in TIERS:
        calls, windows = log.windows(tier)
        print(f'{tier}: {launches[tier]} window launches for {windows} '
              f'windows over {calls} chain decodes')
        if launches[tier] < windows:
            fail(f'{tier}: {launches[tier]} kernel launches for {windows} '
                 f'windows decoded')
    if launches['fused_int4'] < 1:
        fail('the int4 window kernel was not launched on the segmem path')
    print(f'{ta.KERNEL}: {launches[ta.KERNEL]} launches for '
          f'{log.attention_calls} long attentions ('
          f'{log.memory_encoder_calls} memory-encoder calls, '
          f'{log.forwards} teacher-forced forwards)')
    if launches[ta.KERNEL] != log.attention_calls or \
            log.attention_calls < 1:
        fail(f'{ta.KERNEL}: {launches[ta.KERNEL]} launches for '
             f'{log.attention_calls} long attentions')
    return {'tier': handler.quantize, 'walk': walk.steps,
            'launches': launches,
            'memory_encoder_calls': log.memory_encoder_calls,
            'teacher_forced_forwards': log.forwards,
            'ready_seconds': ready,
            'demotions': decode.get('demotions', [])}


def segmem_worst_case(torch):
    """One chained decode on fused_bf16 at the serving shape: 8 chains x 8
    segments x 1024 steps of the paper's model at bf16 (seed-0 random
    weights rarely emit EOS); and the memory encoder alone at B = 8."""
    phase('segment-memory worst case (fused_bf16, 8 chains x 8 segments '
          'x 1024 steps)')
    from mr_mt3_tpu_torch import serve
    from mr_mt3_tpu_torch.ops import decode
    from mr_mt3_tpu_torch.ops.fast_decode import stack_decode_params

    handler = serve.build_handler(SEGMEM_ARGS)
    model, cfg = handler.model, handler.cfg
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(4)
    mel = torch.rand((8, 8, 256, cfg.mel_bins), generator=gen).to(dev)
    dp = stack_decode_params(model, quantize='fused_bf16')
    decode.segmem_greedy_decode(model, mel[:, :1], 32,
                                quantize='fused_bf16', dp=dp)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    toks = decode.segmem_greedy_decode(model, mel, 1024,
                                       quantize='fused_bf16', dp=dp)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    toks = toks.cpu()
    if toks.shape != (8, 8, 1025) or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size:
        fail(f'segmem worst case: bad tokens {tuple(toks.shape)}')
    steps = int((toks[..., 1:] != cfg.pad_token_id).sum(-1).amax(0).sum())
    mem = toks[:, 0, :1024].to(dev)
    with torch.no_grad():
        mem_ms = time_ms(torch, lambda: model.compute_segmem(mem))
    audio_s = 8 * 8 * 256 * 128 / 16000
    out = {'seconds': secs, 'steps': steps,
           'ms_per_step': secs / max(steps, 1) * 1e3, 'rtf': audio_s / secs,
           'memory_encoder_ms_per_segment': mem_ms}
    print(f'fused_bf16 chains: {secs:.3f} s for {steps} sequential steps '
          f'(8 segments), {out["ms_per_step"]:.4f} ms/step, realtime '
          f'factor {out["rtf"]:.2f}; memory encoder {mem_ms:.4f} ms per '
          f'segment (B=8, L=1024)')
    return out


# ---- the int8 and int8_kv decode tiers -----------------------------------

INT8_TIERS = ('int8', 'int8_kv')
# The three kernels of the int8 tiers against their plain versions on the
# same inputs, at the main path's shapes. Readings: rel_err, the largest
# |difference| over the largest |plain output|; unequal, the share of
# outputs not equal; heads_apart (attention), the share of (row, head)
# outputs whose largest |difference| passes 1e-4 of their largest |plain
# output|. Both versions sum in f32 in other orders (and the plain
# version's products run in cuBLAS), so f32 outputs differ in their last
# bits almost everywhere (unequal 0.38-0.86 in run W: no bound) and a bf16
# output near a rounding midpoint lands one bf16 step apart. Largest
# readings over the cases of run W (NVIDIA H100 80GB HBM3, 700 W; PERF.md):
#   int8_matmul     f32 rel 3.6e-7; bf16 rel 1.6e-3 (one step of one
#                   output), unequal 8.1e-5;
#   int8_gated_ff   f32 rel 4.6e-4 (its intermediate is rounded to bf16,
#                   and one rounding at a tie moves the outputs it feeds);
#                   bf16 rel 3.3e-4, unequal 1.8e-4;
#   int8_decode_attention  f32 rel 5.6e-7, no head apart (no requantized
#                   code moved, in runs W-Z alike); bf16 rel 8.6e-3,
#                   unequal 1.8e-2, heads_apart 2.1%.
# Bounds: about 3x those; rel_err of a bf16 output at least two bf16
# steps (2^-7) and unequal at least 1e-3 (a handful of roundings at B=8);
# no f32 attention head apart. The control reads rel_err 0.0045-0.0175
# and 0.92-1.0 of the heads apart (run W).
INT8_BOUNDS = {
    ('int8_matmul', 'float32'): {'rel_err': 1.5e-6},
    ('int8_matmul', 'bfloat16'): {'rel_err': 2 ** -7, 'unequal': 1e-3},
    ('int8_gated_ff', 'float32'): {'rel_err': 1.5e-3},
    ('int8_gated_ff', 'bfloat16'): {'rel_err': 2 ** -7, 'unequal': 1e-3},
    ('int8_decode_attention', 'float32'): {'rel_err': 2e-6,
                                           'heads_apart': 0.0},
    ('int8_decode_attention', 'bfloat16'): {'rel_err': 2.6e-2,
                                            'heads_apart': 0.06},
}
# (name, heads, d_kv, cache length, position): the full-width decoder's
# self-attention at the first, 32nd and last of 1024 positions, its
# cross-attention over the vanilla encoder (256) and the segment-memory
# model's (256 + 64), and the parity model's head width 24
INT8_ATTN_CASES = [
    ('self_pos0', 6, 64, 1024, 0),
    ('self_pos31', 6, 64, 1024, 31),
    ('self_pos1023', 6, 64, 1024, 1023),
    ('cross_lenc256', 6, 64, 256, 255),
    ('cross_lenc320', 6, 64, 320, 319),
    ('d24_self_pos1023', 4, 24, 1024, 1023),
    ('d24_cross_lenc320', 4, 24, 320, 319),
]
INT8_BATCHES = (8, 64)
INT8_DTYPES = ('float32', 'bfloat16')


def output_readings(torch, got, want, head_width=None):
    """The readings named above INT8_BOUNDS, of got against want (B, N)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    out = {'max_abs_err': float(diff.max()),
           'rel_err': float(diff.max()) / max(float(w.abs().max()), 1e-30),
           'unequal': float((g != w).float().mean())}
    if head_width:
        d = diff.reshape(diff.shape[0], -1, head_width).amax(-1)
        m = w.abs().reshape(diff.shape[0], -1, head_width).amax(-1)
        out['heads_apart'] = float((d > 1e-4 * m).float().mean())
    return out


def int8_violations(kernel, dtype, readings):
    return [f'{key} {readings[key]:.4g} > {bound}'
            for key, bound in INT8_BOUNDS[(kernel, dtype)].items()
            if readings[key] > bound]


# A rounding tie: the plain version's unrounded value lies within a share
# of a step of the rounding midpoint. The kernels' f32 sums run in other
# orders than the plain versions' (~1e-7 relative), so only such a value
# can round the other way. TIE_SHARE of a bf16 ulp of an output (~3e-5 of a
# step apart); CODE_TIE_SHARE of one int8 code of a requantized
# probability (p vs / its scale, up to 127: ~1e-6 relative moves it by
# ~1.3e-4); G_TIE_SHARE of a bf16 step of a feed-forward gate (a sum of 512
# products, ~2e-6 relative, ~5e-4 of a step, more where terms cancel).
TIE_SHARE = 0.01
CODE_TIE_SHARE = 1e-3
G_TIE_SHARE = 4e-3
# a q code at a tie (q / its scale within Q_TIE_SHARE, ~13 f32 ulps at
# 127, of a half-integer; bf16 q values make such near-exact ties likely)
# moves every score of its (row, head), so a difference anywhere in that
# head is explained
Q_TIE_SHARE = 1e-4


def bf16_tie_readings(torch, got, want, want32, head_width=None,
                      movement=None):
    """Trace each bf16 output of got (B, N) unequal to the plain version's
    want to a rounding tie: of the output itself (want32, the plain
    version's value before its last rounding to bf16, within TIE_SHARE of
    a step of the midpoint between its two bf16 neighbours, got one of
    them), or of an intermediate (movement (B, N): the most that the
    plain version's intermediates at ties, each rounded the other way, can
    move the output; got within that and one output step of want32).
    Returns the unequal outputs, those a tie explains, the outputs and
    the heads."""
    g, w, w32 = got.float(), want.float(), want32.float()
    unequal = g != w
    lo = (w32.view(torch.int32) & -65536).view(torch.float32)  # to zero
    hi = ((w32.view(torch.int32) & -65536) + 65536).view(torch.float32)
    step = (hi - lo).abs()
    tie = ((w32 - (lo + hi) / 2).abs() <= TIE_SHARE * step) \
        & ((g == lo) | (g == hi))
    if movement is not None:
        tie = tie | ((g - w32).abs() <= movement + step)
    return {'unequal_outputs': int(unequal.sum()),
            'unequal_at_ties': int((unequal & tie).sum()),
            'unexplained': int((unequal & ~tie).sum()),
            'outputs': g.numel(),
            'heads': g.numel() // head_width if head_width else None}


def _near_half(x, share):
    """Whether x lies within share of a half-integer (a rounding tie)."""
    x = x.abs()
    return (x - x.floor() - 0.5).abs() <= share


def int8_attention_tie_movement(torch, q, k_q, k_scale, v_q, v_scale,
                                position):
    """(B, H dk): the most that the plain version's requantized
    probability codes at a rounding tie (p vs / its scale within
    CODE_TIE_SHARE of a half-integer), each one code the other way, move
    an output of int8_decode_attention; unbounded in a (row, head) whose
    int8 q has a code at a tie (Q_TIE_SHARE)."""
    b, h, dk = q.shape
    n = int(position) + 1
    qf = q.float()
    qs = torch.clamp(qf.abs().amax(-1, keepdim=True), min=1e-12) / 127
    qi = torch.clamp(torch.round(qf / qs), -127, 127)
    s = torch.einsum('bhd,bhdk->bhk', qi.double(),
                     k_q[..., :n].double()).float()
    s = s * qs * k_scale[:, :, 0, :n]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    pv = e / e.sum(-1, keepdim=True) * v_scale[:, :, 0, :n]
    ps = torch.clamp(pv.abs().amax(-1, keepdim=True), min=1e-20) / 127
    ties = _near_half(pv / ps, CODE_TIE_SHARE).double()
    move = torch.einsum('bhk,bhdk->bhd', ties, v_q[..., :n].double().abs())
    move = move.float() * ps
    q_tie = _near_half(qf / qs, Q_TIE_SHARE).any(-1, keepdim=True)
    return torch.where(q_tie, float('inf'), move).reshape(b, h * dk)


def int8_gated_ff_tie_movement(torch, h, w0_q, s0, w1_q, s1, wo_q, so):
    """(B, D): the most that the plain version's bf16 gates g at a
    rounding tie (within G_TIE_SHARE of a step of the midpoint), each
    rounded the other way, move an output of int8_gated_ff."""
    from mr_mt3_tpu_torch.models.mt3 import gelu_new
    hf = h.float()
    g = gelu_new((hf @ w0_q.float()) * s0) * ((hf @ w1_q.float()) * s1)
    lo = (g.view(torch.int32) & -65536).view(torch.float32)
    hi = ((g.view(torch.int32) & -65536) + 65536).view(torch.float32)
    step = (hi - lo).abs()
    ties = (g - (lo + hi) / 2).abs() <= G_TIE_SHARE * step
    return ((ties * step) @ wo_q.float().abs()) * so.abs()


# the intermediates each int8 kernel rounds before its output
TIE_MOVEMENT = {
    'int8_matmul': lambda torch, *args: None,
    'int8_gated_ff': int8_gated_ff_tie_movement,
    'int8_decode_attention': int8_attention_tie_movement}


def int8_bf16_violations(kernel, readings):
    """int8_violations of a bf16 case, where a share bound coarser than
    one element (one unequal output, or one head apart, already breaks
    it) is held by the ties instead: it stands only if an unequal output
    is not traced to a rounding tie (bf16_tie_readings). Every other bound
    stands as it is."""
    bounds = INT8_BOUNDS[(kernel, 'bfloat16')]
    units = {'unequal': readings['outputs'], 'heads_apart': readings['heads']}
    coarse = {key for key, n in units.items()
              if key in bounds and n and bounds[key] * n < 1}
    return [v for v in int8_violations(kernel, 'bfloat16', readings)
            if v.split()[0] not in coarse or readings['unexplained']]


def int8_attention_control(torch, q, k_q, k_scale, v_q, v_scale, position):
    """A deliberately wrong plain version of int8_decode_attention: the
    probabilities times the V scales go into the value sums in f32, not
    requantized to int8. The bounds must tell the kernel from it."""
    b, h, dk = q.shape
    n = position + 1
    qf = q.float()
    qs = torch.clamp(qf.abs().amax(-1, keepdim=True), min=1e-12) / 127
    qi = torch.clamp(torch.round(qf / qs), -127, 127)
    s = torch.einsum('bhd,bhdk->bhk', qi.double(),
                     k_q[..., :n].double()).float()
    s = s * qs * k_scale[:, :, 0, :n]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    pv = e / e.sum(-1, keepdim=True) * v_scale[:, :, 0, :n]
    out = torch.einsum('bhk,bhdk->bhd', pv.double(),
                       v_q[..., :n].double()).float()
    return out.reshape(b, h * dk).to(q.dtype)


# torch._weight_int8pack_mm(x (B, K), W (N, K) int8, scales (N,)) is
# y = (x @ W^T) * scales, int8_matmul's function: the library yardstick
# where this torch registers a CUDA kernel for it. On the card (run CO,
# torch 2.11.0+cu128) its kernel (weight_int8pack_mm_kernel, f32
# throughout) took f32 and bf16 x with f32 scales; bf16 x goes through two
# more kernels, a conversion to f32 and of the output back, which its
# queued_ms holds.
INT8PACK_OP = 'aten::_weight_int8pack_mm'


def int8_matmul_control(torch, x, w_q, scale):
    """A deliberately wrong plain version of int8_matmul: in f32, x rounded
    to bf16 first (what a bf16 tensor-core product would take); in bf16,
    the product on weights dequantized to bf16 (lm_deq: the library
    yardstick's function). The bounds must tell the kernel from it."""
    from mr_mt3_tpu_torch.ops.int8_matmul import int8_matmul_reference
    if x.dtype == torch.float32:
        return int8_matmul_reference(x.to(torch.bfloat16).float(), w_q, scale)
    return x @ (w_q.float() * scale).to(x.dtype)


def int8_matmul_bound_ms(b, k, n, elt):
    """x read once, the int8 weights and f32 scales once, y written once,
    against HBM; 2 b k n operations at the bf16 peak (the TPU kernel's bf16
    dot). Returns (ms, bound_by)."""
    nbytes = b * k * elt + k * n + 4 * n + b * n * elt
    return _bound(nbytes, 2 * b * k * n / BF16_FLOPS)


def int8_gated_ff_bound_ms(b, d, f, elt):
    """h in and out once, three int8 weight matrices and their scales once;
    6 b d f operations at the bf16 peak."""
    nbytes = 2 * b * d * elt + 3 * d * f + 4 * (2 * f + d)
    return _bound(nbytes, 6 * b * d * f / BF16_FLOPS)


def int8_attention_bound_ms(b, h, dk, n, elt):
    """q in and out once, the n attended positions' K and V codes and
    scales once; the two int8 dots (4 b h dk n operations) at the int8
    peak."""
    nbytes = 2 * b * h * dk * elt + 2 * b * h * n * (dk + 4)
    return _bound(nbytes, 4 * b * h * dk * n / INT8_OPS)


def _bound(nbytes, t_ops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def int8_case_inputs(torch):
    """The inputs of int8_kernel_cases on the card, from one seed, in
    order: yields (kernel, case, args) for int8_matmul (the lm_head, 512 x
    1536), int8_gated_ff (512 / 1024) and int8_decode_attention
    (INT8_ATTN_CASES) at INT8_BATCHES x INT8_DTYPES, args those of the
    kernel's wrapper."""
    from mr_mt3_tpu_torch.ops import int8_attention as i8a
    from mr_mt3_tpu_torch.ops import int8_matmul as i8m
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(5)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    def quantized(k, n):
        codes, scale = i8m.quantize_columns(randn(k, n, scale=0.05))
        return codes.contiguous(), scale[None].contiguous()

    d, vocab, ff = 512, 1536, 1024
    w_lm, s_lm = quantized(d, vocab)
    w0, s0 = quantized(d, ff)
    w1, s1 = quantized(d, ff)
    wo, so = quantized(ff, d)
    for dtype in INT8_DTYPES:
        tdt = getattr(torch, dtype)
        for b in INT8_BATCHES:
            yield ('int8_matmul',
                   {'case': 'lm_head', 'batch': b, 'dtype': dtype},
                   (randn(b, d).to(tdt), w_lm, s_lm))
            yield ('int8_gated_ff',
                   {'case': 'ff_512x1024', 'batch': b, 'dtype': dtype},
                   (randn(b, d).to(tdt), w0, s0, w1, s1, wo, so))
            for name, heads, dk, k_len, pos in INT8_ATTN_CASES:
                q = randn(b, heads, dk).to(tdt)
                (kq, ks), (vq, vs) = (i8a.quantize_kv_rows(
                    randn(b, heads, dk, k_len)) for _ in range(2))
                yield ('int8_decode_attention',
                       {'case': name, 'batch': b, 'dtype': dtype,
                        'heads': heads, 'd_kv': dk, 'cache': k_len,
                        'position': pos},
                       (q, kq, ks, vq, vs, pos))


def int8_kernel_cases(torch):
    """int8_matmul, int8_gated_ff and int8_decode_attention against their
    plain versions on int8_case_inputs; the matmul and the attention also
    against their controls (int8_matmul_control, int8_attention_control).
    Then each kernel's time: its wrapper's, as the decode calls it
    (time_ms), and with the host's cost hidden (queued_ms); the plain
    version's, the bound and a library yardstick that is not the same
    function: torch.matmul on weights dequantized once beforehand, and
    scaled_dot_product_attention (scale 1.0) over the dequantized
    positions <= position; none for the feed-forward. The matmul also
    against torch._weight_int8pack_mm, the same function, where the card's
    torch has it: its call's time, its queued_ms (queued with the
    kernel's) and its output against the plain version's."""
    phase('int8 kernels vs plain (full width)')
    import torch.nn.functional as F

    from mr_mt3_tpu_torch.ops import int8_attention as i8a
    from mr_mt3_tpu_torch.ops import int8_matmul as i8m
    results = {'int8_matmul': [], 'int8_gated_ff': [],
               'int8_decode_attention': []}
    bad = []

    def record(kernel, case, got, args, head_width=None, control=None):
        plain = kernels[kernel][1]
        want = plain(*args)
        torch.cuda.synchronize()
        readings = output_readings(torch, got, want, head_width)
        dtype = case['dtype']
        name = f'{kernel} {case["case"]} B={case["batch"]} {dtype}'
        if dtype == 'bfloat16':
            # the plain version on the f32 input is its value before the
            # last rounding to bf16 (it widens its input to f32 first)
            readings.update(bf16_tie_readings(
                torch, got, want, plain(args[0].float(), *args[1:]),
                head_width, TIE_MOVEMENT[kernel](torch, *args)))
            violations = int8_bf16_violations(kernel, readings)
        else:
            violations = int8_violations(kernel, dtype, readings)
        case.update(readings)
        bad.extend(f'{name}: {v}' for v in violations)
        if control is not None:
            ctrl = output_readings(torch, got, control, head_width)
            caught = int8_violations(kernel, dtype, ctrl)
            case['control'] = {k: ctrl[k]
                               for k in INT8_BOUNDS[(kernel, dtype)]}
            case['control_caught_by'] = caught
            if not caught:
                bad.append(f'{name}: the bounds do not tell the kernel from '
                           f'its control')
        return case

    kernels = {'int8_matmul': (i8m.int8_matmul_cuda,
                               i8m.int8_matmul_reference),
               'int8_gated_ff': (i8m.int8_gated_ff_cuda,
                                 i8m.int8_gated_ff_reference),
               'int8_decode_attention': (i8a.int8_decode_attention_cuda,
                                         i8a.int8_decode_attention_reference)}
    lm_deq, lm_pack = {}, {}
    for kernel, case, args in int8_case_inputs(torch):
        library_call = None
        cuda, plain = kernels[kernel]
        dtype, b = case['dtype'], case['batch']
        tdt = getattr(torch, dtype)
        elt = 4 if dtype == 'float32' else 2
        got = cuda(*args)
        if kernel == 'int8_matmul':
            x, w_lm, s_lm = args
            record(kernel, case, got, args,
                   control=int8_matmul_control(torch, *args))
            if dtype not in lm_deq:
                lm_deq[dtype] = (w_lm.float() * s_lm).to(tdt)
            case['library_ms'] = time_ms(
                torch, lambda: torch.matmul(x, lm_deq[dtype]))
            if torch._C._dispatch_has_kernel_for_dispatch_key(INT8PACK_OP,
                                                              'CUDA'):
                if not lm_pack:   # W (N, K) and the scales (N,), once
                    lm_pack['w'] = w_lm.t().contiguous()
                    lm_pack['s'] = s_lm[0].contiguous()

                def library_call():
                    return torch._weight_int8pack_mm(x, lm_pack['w'],
                                                     lm_pack['s'])
                got_lib = output_readings(torch, library_call(), plain(*args))
                case.update(int8pack_ms=time_ms(torch, library_call),
                            int8pack_rel_err=got_lib['rel_err'],
                            int8pack_unequal=got_lib['unequal'])
            case['bound_ms'], case['bound_by'] = int8_matmul_bound_ms(
                b, *w_lm.shape, elt)
        elif kernel == 'int8_gated_ff':
            record(kernel, case, got, args)
            case['library_ms'] = None
            case['bound_ms'], case['bound_by'] = int8_gated_ff_bound_ms(
                b, *args[1].shape, elt)
        else:
            q, kq, ks, vq, vs, pos = args
            heads, dk = case['heads'], case['d_kv']
            # at position 0 p is 1 and requantizes exactly: the control is
            # the same function there
            record(kernel, case, got, args, dk,
                   int8_attention_control(torch, *args) if pos else None)
            n = pos + 1
            qt = q[:, :, None, :]
            # (B, H, n, dk) with dense strides (at n = 1 .contiguous() keeps
            # the transposed strides, which SDPA refuses)
            kt, vt = ((c[..., :n].float() * sc[..., :n]).to(tdt)
                      .transpose(-1, -2)
                      .clone(memory_format=torch.contiguous_format)
                      for c, sc in ((kq, ks), (vq, vs)))
            case['library_ms'] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, scale=1.0))
            case['bound_ms'], case['bound_by'] = int8_attention_bound_ms(
                b, heads, dk, n, elt)
            del kt, vt
        case['ms'] = time_ms(torch, lambda: cuda(*args))
        queued = [lambda: cuda(*args)]
        if library_call is not None:
            queued.append(library_call)
        case['queued_ms'], *library_queued = queued_ms(torch, queued)
        if library_queued:
            case['int8pack_queued_ms'] = library_queued[0]
        case['plain_ms'] = time_ms(torch, lambda: plain(*args),
                                   runs=PLAIN_TIMED_RUNS, warmup=0)
        print(json.dumps(case), flush=True)
        results[kernel].append(case)
        del got, args
    if bad:
        fail('int8 kernels vs plain versions: ' + '; '.join(bad))
    return results


# The device-position entry of int8_decode_attention (the step loop's
# self-attention: the position an int32 in device memory, the launch sized
# for n_max, the phase bound) at these positions of a 1024 cache, at
# INT8_BATCHES x INT8_DTYPES, full width (6 heads of 64)
DEVICE_POSITIONS = (0, 31, 63, 511, 1023)


def int8_device_position_cases(torch):
    """The device-position int8_decode_attention against its plain version
    (the host-int form at the same position) within INT8_BOUNDS, the
    attention control caught past position 0, and against the host-int
    launch at the same position (its share of unequal outputs printed:
    the layout follows n_max, so the softmax sum's order may differ); its
    time and the host-int launch's. A host-known position at or past
    n_max raises, n_max past the cache raises before any launch, and a
    device position at or past n_max gives NaN outputs."""
    phase('int8_decode_attention, device position (full width)')
    from mr_mt3_tpu_torch.ops import int8_attention as i8a
    from mr_mt3_tpu_torch.ops.fast_decode import phase_bounds
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(13)
    bounds = phase_bounds(1024)
    rows, bad = [], []
    for dtype in INT8_DTYPES:
        tdt = getattr(torch, dtype)
        for b in INT8_BATCHES:
            for pos in DEVICE_POSITIONS:
                n_max = next(bound for bound in bounds if pos < bound)
                q = (torch.randn((b, 6, 64), generator=gen)).to(dev, tdt)
                (kq, ks), (vq, vs) = (i8a.quantize_kv_rows(torch.randn(
                    (b, 6, 64, 1024), generator=gen).to(dev))
                    for _ in range(2))
                args = (q, kq, ks, vq, vs, pos)
                where = torch.tensor(pos, dtype=torch.int32, device=dev)

                def device_call():
                    return i8a.int8_decode_attention_cuda(
                        q, kq, ks, vq, vs, where, n_max)
                before = i8a.LAUNCHES[i8a.KERNEL]
                got = device_call()
                torch.cuda.synchronize()
                name = f'B={b} {dtype} position {pos} n_max {n_max}'
                if i8a.LAUNCHES[i8a.KERNEL] != before + 1:
                    bad.append(f'{name}: not one launch')
                plain = i8a.int8_decode_attention_reference(*args)
                readings = output_readings(torch, got, plain, 64)
                if dtype == 'bfloat16':
                    readings.update(bf16_tie_readings(
                        torch, got, plain,
                        i8a.int8_decode_attention_reference(
                            q.float(), *args[1:]), 64,
                        int8_attention_tie_movement(torch, *args)))
                    violations = int8_bf16_violations(
                        'int8_decode_attention', readings)
                else:
                    violations = int8_violations('int8_decode_attention',
                                                 dtype, readings)
                bad.extend(f'{name}: {v}' for v in violations)
                case = {'batch': b, 'dtype': dtype, 'position': pos,
                        'n_max': n_max, **readings}
                if pos:
                    ctrl = output_readings(
                        torch, got, int8_attention_control(torch, *args), 64)
                    caught = int8_violations('int8_decode_attention', dtype,
                                             ctrl)
                    case['control_caught_by'] = caught
                    if not caught:
                        bad.append(f'{name}: the bounds do not tell the '
                                   f'kernel from its control')
                host = i8a.int8_decode_attention_cuda(*args)
                vs_host = output_readings(torch, got, host, 64)
                case['vs_host_int'] = vs_host
                if int8_violations('int8_decode_attention', dtype, vs_host):
                    bad.append(f'{name}: against the host-int launch '
                               f'{vs_host}')
                case['ms'] = time_ms(torch, device_call)
                case['host_int_ms'] = time_ms(
                    torch, lambda: i8a.int8_decode_attention_cuda(*args))
                case['bound_ms'], case['bound_by'] = \
                    int8_attention_bound_ms(b, 6, 64, pos + 1,
                                            4 if dtype == 'float32' else 2)
                print(json.dumps(case), flush=True)
                rows.append(case)
    # refusals on the host side, and the device-side guard
    q, kq, ks = args[:3]
    try:
        i8a.int8_decode_attention(q, kq, ks, kq, ks, 64, 64)
        bad.append('a host position at n_max was not refused')
    except ValueError as e:
        print(f'host position 64 at n_max 64 refused: {e}')
    where = torch.tensor(64, dtype=torch.int32, device=dev)
    try:
        i8a.int8_decode_attention(q, kq, ks, kq, ks, where, 1025)
        bad.append('n_max past the cache was not refused')
    except ValueError as e:
        print(f'n_max 1025 over a 1024 cache refused: {e}')
    nan = i8a.int8_decode_attention(q, kq, ks, kq, ks, where, 64)
    if not bool(torch.isnan(nan).all()):
        bad.append('a device position at n_max did not give NaN')
    print('device position 64 at n_max 64: every output NaN')
    unequal = [c['vs_host_int']['unequal'] for c in rows]
    print(f'device-position vs host-int launch: unequal share at most '
          f'{max(unequal):.4g}, mean {statistics.mean(unequal):.4g}')
    if bad:
        fail('int8_decode_attention, device position: ' + '; '.join(bad))
    return rows


def capture_survival(torch):
    """One block of the 'int8' step loop at full width (B 8, the first
    phase, 8 steps of 8 int8_gated_ff and 1 int8_matmul launches each)
    replayed from a saved state against the same block run eagerly from
    it: tokens, flags and caches equal. Then 120 more replays: the
    feed-forward's grid barrier words of the capture stream read back with
    the count word zero and the generation word advanced once a launch."""
    phase('capture survival (one int8 block, 120 replays)')
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.ops import int8_matmul as i8m
    from mr_mt3_tpu_torch.ops.fast_decode import (
        stack_decode_params,
        greedy_loop_fast,
    )
    from mr_mt3_tpu_torch.utils.builders import init_params
    cfg = MT3Config()
    dev = torch.device('cuda')
    model = init_params(MT3(cfg), seed=0).to(dev).eval()
    dp = stack_decode_params(model, quantize='int8')
    gen = torch.Generator().manual_seed(6)
    enc = torch.randn((8, 256, cfg.d_model), generator=gen).to(dev)
    greedy_loop_fast(cfg, dp, enc, 64, 'int8')      # captures (64, 8)
    runner = next(iter(dp.runners.values()))
    runner.reset(dp, enc, None)
    for _ in range(2):
        runner.block(dp, 64, 8, graphs=False)
    state = [runner.tokens, runner.finished, runner.step_index,
             *runner.cache]
    saved = [t.clone() for t in state]
    runner.block(dp, 64, 8, graphs=False)
    eager = [t.clone() for t in state]
    for t, was in zip(state, saved):
        t.copy_(was)
    bar = i8m._barrier(runner.device, runner.stream.cuda_stream)
    generation = int(bar[1])
    runner.block(dp, 64, 8, graphs=True)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(state, eager))
    for _ in range(120):
        runner.step_index.fill_(16)
        runner.block(dp, 64, 8, graphs=True)
    torch.cuda.synchronize()
    words = bar.tolist()
    launches = 121 * 8 * cfg.num_decoder_layers
    out = {'replay_equals_eager': same, 'barrier_words': words,
           'generation_advance': words[1] - generation,
           'feed_forward_launches_replayed': launches}
    print(f'capture survival: {json.dumps(out)}')
    if not same:
        fail('a replayed int8 block differs from the same block run '
             'eagerly')
    if words[0] != 0 or words[1] - generation != launches:
        fail(f'the captured int8_gated_ff left its barrier words at '
             f'{words} (generation {generation} before {launches} '
             f'launches)')
    return out


class StepLog(Patches):
    """Counts the greedy steps of each tier from when it is made until
    closed: the step loops' counter (fast_decode.STEPS), which the
    runners add to at every step run eagerly and, for a captured block,
    at every replay (a replay calls no Python step)."""

    def __init__(self):
        from mr_mt3_tpu_torch.ops import fast_decode
        super().__init__()
        self._counter = fast_decode.STEPS
        self._start = dict(fast_decode.STEPS)
        self._final = None

    @property
    def steps(self):
        counts = self._final if self._final is not None else self._counter
        return {tier: n - self._start.get(tier, 0)
                for tier, n in counts.items() if n != self._start.get(tier, 0)}

    def close(self):
        if self._final is None:
            self._final = dict(self._counter)
        super().close()


def steps_needed(log, tier):
    """Greedy steps the step-by-step loop had to run for the decodes on
    `tier` that DecodeLog recorded: per batch, up to the first early-exit
    check (every _EXIT_CHECK_EVERY steps) after the last row's first EOS,
    or max_length."""
    import numpy as np

    from mr_mt3_tpu_torch.ops.fast_decode import _EXIT_CHECK_EVERY as every
    steps = 0
    for quantize, batch, max_length, eos_id, tokens in log.calls:
        if quantize != tier:
            continue
        for start in range(0, len(tokens), batch):
            last = 0
            for row in tokens[start:start + batch]:
                eos = np.flatnonzero(row[1:] == eos_id)
                last = max(last, int(eos[0]) + 1 if len(eos)
                           else max_length + every)
            steps += min(max_length, -(-last // every) * every)
    return steps


def int8_launches():
    from mr_mt3_tpu_torch.ops import int8_attention as i8a
    from mr_mt3_tpu_torch.ops import int8_matmul as i8m
    return {**i8m.LAUNCHES, **i8a.LAUNCHES}


def zero_launches():
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    from mr_mt3_tpu_torch.ops import int8_attention as i8a
    from mr_mt3_tpu_torch.ops import int8_matmul as i8m
    from mr_mt3_tpu_torch.ops import train_attention as ta
    for counts in (fd.LAUNCHES, ta.LAUNCHES, i8m.LAUNCHES, i8a.LAUNCHES):
        for key in counts:
            counts[key] = 0


def check_int8_launches(tier, steps, layers):
    """The kernels of `tier` launched steps x their per-step count, the
    other int8 kernels and the window kernel not at all."""
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    got = int8_launches()
    want = ({'int8_matmul': steps, 'int8_gated_ff': steps * layers,
             'int8_decode_attention': 0} if tier == 'int8' else
            {'int8_matmul': 0, 'int8_gated_ff': 0,
             'int8_decode_attention': 2 * layers * steps})
    print(f'{tier}: {steps} greedy steps, launches {got} (expected '
          f'{want})')
    if got != want or steps < 1 or any(fd.LAUNCHES.values()):
        fail(f'{tier}: launches {got} and window launches {fd.LAUNCHES} '
             f'for {steps} steps (expected {want})')
    return got


# the int8 tiers' held servers (their eager step loop is host-bound, ~7-15
# ms a step at B 8): cut from 1024 for time
INT8_SERVING_MAX_LENGTH = 128


def int8_tier_serving(torch):
    """The int8 tiers as `python -m mr_mt3_tpu_torch.serve
    +eval.quantize=<tier>` builds them: first the probe ladder's walk from
    the tier (printed; random weights may demote it), then a handler held
    at the tier (prepare_handler(probe=False)) serving the 4 clips over
    HTTP at eval.max_length INT8_SERVING_MAX_LENGTH; the kernels' launches must equal the steps decoded times the
    per-step count (num_decoder_layers + 1 for int8, 2 x
    num_decoder_layers for int8_kv)."""
    from mr_mt3_tpu_torch import serve
    from mr_mt3_tpu_torch.infer import probe as probe_mod
    out = {}
    for tier in INT8_TIERS:
        phase(f'ladder walk from {tier} (random weights)')
        handler = serve.build_handler([f'+eval.quantize={tier}'])
        if handler.quantize != tier:
            fail(f'+eval.quantize={tier} built a {handler.quantize!r} '
                 f'handler')
        t0 = time.monotonic()
        walk = probe_mod.resolve_auto_quantize(handler, verbose=True)
        walk['seconds'] = round(time.monotonic() - t0, 1)
        print(f'ladder from {tier}: {json.dumps(walk)}')
        if 'probe_error' in walk or 'classify_error' in walk:
            fail(f'the ladder from {tier} raised: {walk}')
        del handler
        phase(f'serving held at {tier}')
        handler = serve.build_handler(
            [f'+eval.quantize={tier}',
             f'eval.max_length={INT8_SERVING_MAX_LENGTH}'])
        zero_launches()
        log, steps = DecodeLog(), StepLog()
        try:
            t0 = time.monotonic()
            info = serve.prepare_handler(handler, probe=False)
            print(f'prewarmed in {time.monotonic() - t0:.1f} s')
            health = serve_clips(torch, handler, info)
        finally:
            steps.close()
            log.close()
        if health['decode'].get('quantize') != tier:
            fail(f'/healthz decode info: {health["decode"]}')
        ran = steps.steps.get(tier, 0)
        # the decodes' steps, and those the prewarm's captures warmed up
        # (every phase the decodes did not reach)
        warmups = info['graphs']['capture_warmup_steps']
        need = steps_needed(log, tier) + warmups
        print(f'{tier}: graphs {json.dumps(info["graphs"])}')
        if set(steps.steps) != {tier} or ran != need:
            fail(f'{tier}: {steps.steps} greedy steps run, {need} needed by '
                 f'the decoded tokens')
        launches = check_int8_launches(tier, ran,
                                       handler.cfg.num_decoder_layers)
        out[tier] = {'walk': walk, 'steps': ran, 'launches': launches,
                     'graphs': info['graphs'],
                     'decodes': len(log.calls)}
        del handler
        torch.cuda.empty_cache()
    return out


SEGMEM_INT8_MAX_LENGTH = 64


def segmem_int8_leg(torch):
    """The segment-memory model at bf16 (SEGMEM_ARGS) through each int8
    tier held, one 2.5 s clip (one chain of batch_size segments) at
    eval.max_length SEGMEM_INT8_MAX_LENGTH: MIDI out, and the kernels'
    launches equal to the steps times the per-step count."""
    from mr_mt3_tpu_torch import serve
    from mr_mt3_tpu_torch.midi import note_sequence_to_midi_bytes
    out = {}
    for tier in INT8_TIERS:
        phase(f'segment-memory leg held at {tier} (bf16, max_length '
              f'{SEGMEM_INT8_MAX_LENGTH})')
        handler = serve.build_handler(
            SEGMEM_ARGS + [f'+eval.quantize={tier}',
                           f'eval.max_length={SEGMEM_INT8_MAX_LENGTH}'])
        if handler.cfg.dtype != 'bfloat16' or handler.quantize != tier:
            fail(f'the segmem {tier} handler: {handler.cfg}, '
                 f'{handler.quantize!r}')
        zero_launches()
        steps = StepLog()
        try:
            t0 = time.monotonic()
            midi = note_sequence_to_midi_bytes(handler.transcribe(
                clip(2.5, 0)))
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
        finally:
            steps.close()
        if midi[:4] != b'MThd':
            fail(f'segmem {tier}: no MIDI out')
        ran = steps.steps.get(tier, 0)
        if set(steps.steps) != {tier}:
            fail(f'segmem {tier}: steps {steps.steps}')
        launches = check_int8_launches(tier, ran,
                                       handler.cfg.num_decoder_layers)
        print(f'segmem {tier}: {len(midi)} MIDI bytes in {secs:.2f} s, '
              f'{ran} steps, {secs / max(ran, 1) * 1e3:.3f} ms/step')
        out[tier] = {'steps': ran, 'seconds': secs, 'launches': launches}
        del handler
        torch.cuda.empty_cache()
    return out


class PlainInt8(Patches):
    """Swaps the int8 kernels' wrappers for their plain versions until
    closed (the decode then runs the plain versions on the card), and runs
    the step loop eagerly: the plain attention reads the device position
    back to the host, which a graph capture cannot hold."""

    def __init__(self):
        from mr_mt3_tpu_torch.ops import fast_decode
        from mr_mt3_tpu_torch.ops import int8_attention as i8a
        from mr_mt3_tpu_torch.ops import int8_matmul as i8m
        super().__init__()
        self.patch(fast_decode, 'use_graphs',
                   lambda real, device, graphs, tp=None:
                   real(device, False, tp))
        for mod, name, plain in (
                (i8m, 'int8_matmul', i8m.int8_matmul_reference),
                (i8m, 'int8_gated_ff', i8m.int8_gated_ff_reference),
                (i8a, 'int8_decode_attention',
                 i8a.int8_decode_attention_reference)):
            self.patch(mod, name,
                       lambda real, *args, plain=plain, **kw: plain(*args,
                                                                    **kw))


# the parity model's ladder from each int8 tier as
# tests/test_torch_probe.py::TestAgainstJax::
# test_parity_model_ladder_from_int8_tiers_equals_jax pins JAX's walk on
# the CPU: a 64-step probe and the confirm at the 96-step serving length,
# 0 flips in both (130 and 194 probe tokens), the tier kept
PARITY_INT8_LADDER = {'max_length': 96, 'probe_max_length': 64}


def parity_int8_ladders(torch, model):
    """The probe ladder from each int8 tier on the parity model, as the
    CPU test pins JAX's walk."""
    from mr_mt3_tpu_torch.infer import InferenceHandler
    from mr_mt3_tpu_torch.infer import probe as probe_mod
    walks = {}
    real = probe_mod.PROBE_MAX_LENGTH
    probe_mod.PROBE_MAX_LENGTH = PARITY_INT8_LADDER['probe_max_length']
    try:
        for tier in INT8_TIERS:
            handler = InferenceHandler(
                model=model, max_length=PARITY_INT8_LADDER['max_length'],
                batch_size=4, quantize=tier)
            info = probe_mod.resolve_auto_quantize(handler, verbose=False)
            print(f'ladder from {tier} on the parity model: '
                  f'{json.dumps(info)}')
            if handler.quantize != tier or info.get('probe_flips') != 0 or \
                    info.get('confirm_flips') != 0 or 'demotions' in info:
                fail(f'the ladder from {tier} on the parity model did not '
                     f'walk as the JAX ladder does (kept, 0 flips): {info}')
            walks[tier] = info
    finally:
        probe_mod.PROBE_MAX_LENGTH = real
    return walks


# ---- training (the train CLI's main path) --------------------------------

# The log-mel kernel (csrc/logmel.cu) against (a) its plain version,
# audio/frontend.py::compute_logmel (torch FFT), at tests/test_mel_pallas.py's
# bounds, the ones the JAX package holds logmel_pallas to: 2e-3 in log space
# where the plain log-mel is above -4, 0.02 in mel space everywhere (an FFT
# and a DFT by products round apart most in the noise-floor bins); and (b) a
# float64 DFT by products on the kernel's own constants (logmel_f64), the
# kernel's arithmetic without its f32 rounding, bounds at ~3x the largest
# reading of run AC (NVIDIA H100 80GB HBM3, 700 W; PERF.md): log_err 2.2e-4,
# mel_err 1.8e-4 (against compute_logmel 5.7e-4 and 2.9e-4). The control,
# the same products with the Hann window left out of the constants, must
# break both (it read log_err 5.7-7.1, mel_err 24.7-248).
LOGMEL_BOUNDS = {'vs_plain': {'log_err': 2e-3, 'mel_err': 2e-2},
                 'vs_f64': {'log_err': 7e-4, 'mel_err': 6e-4}}
LOGMEL_BATCHES = (8, 64)
LOGMEL_SAMPLES = 256 * 128          # one 2.048 s segment
FP32_FLOPS = 67e12                  # H100 SXM f32 on the CUDA cores


def logmel_inputs(kind, batch, n=LOGMEL_SAMPLES, seed=0):
    """(batch, n) f32 segments: 'tone' is tests/test_mel_pallas.py::_tone
    (440 and 1200 Hz), each row shifted by 1000 samples and at gain 1 or
    0.3 in turn; 'noise' white noise at 0.1; 'zeros' the log floor."""
    import numpy as np
    if kind == 'zeros':
        return np.zeros((batch, n), np.float32)
    if kind == 'noise':
        rng = np.random.default_rng(seed)
        return (rng.normal(size=(batch, n)) * 0.1).astype(np.float32)
    rows = []
    for i in range(batch):
        t = (np.arange(n) + 1000 * i) / 16000
        x = np.sin(2 * np.pi * 440 * t) + 0.5 * np.sin(2 * np.pi * 1200 * t
                                                       + 1)
        rows.append((x / 1.5) * (1.0 if i % 2 == 0 else 0.3))
    return np.stack(rows).astype(np.float32)


def logmel_f64(torch, samples, config, hann=True):
    """(B, n) -> log-mel in float64, by the kernel's products: pad_end
    frames times the constants of ops/mel_kernel.py::_dft_constants (upcast
    from f32), the magnitude, the filterbank, safe_log (eps 1e-5). With
    hann=False the constants are cos and -sin with no window (the
    control)."""
    import numpy as np

    from mr_mt3_tpu_torch.ops import mel_kernel
    hop, fft = config.hop_width, config.fft_size
    bins = fft // 2 + 1
    cos_m, sin_m, fbank = mel_kernel._dft_constants(config)
    cos_m, sin_m, fbank = cos_m[:, :bins], sin_m[:, :bins], fbank[:bins]
    if not hann:
        angle = 2.0 * np.pi * np.outer(np.arange(fft), np.arange(bins)) / fft
        cos_m, sin_m = np.cos(angle), -np.sin(angle)
    dev = samples.device
    x = samples.double()
    frames = -(-x.shape[-1] // hop)
    pad = fft + hop * (frames - 1) - x.shape[-1]
    x = torch.nn.functional.pad(x, (0, pad)).unfold(-1, fft, hop)
    re = x @ torch.as_tensor(np.asarray(cos_m, np.float64), device=dev)
    im = x @ torch.as_tensor(np.asarray(sin_m, np.float64), device=dev)
    mel = torch.sqrt(re * re + im * im) @ torch.as_tensor(
        np.asarray(fbank, np.float64), device=dev)
    return torch.log(torch.where(mel <= 0, torch.full_like(mel, 1e-5), mel))


def logmel_readings(torch, got, want):
    """log_err: the largest |difference| where want's log-mel is above -4;
    mel_err: the largest |difference| of exp() everywhere."""
    got, want = got.double(), want.double()
    energy = want > -4
    diff = (got - want).abs()
    return {'log_err': float(diff[energy].max()) if energy.any() else 0.0,
            'mel_err': float((got.exp() - want.exp()).abs().max()),
            'energy_share': float(energy.double().mean())}


def logmel_violations(bounds, readings):
    return [f'{k} {readings[k]:.3g} > {v:g}' for k, v in bounds.items()
            if readings[k] > v]


def logmel_bound_ms(batch, n, config):
    """The least time the function needs, whatever the algorithm: per
    frame the window (N products), a real FFT (2.5 N log2 N operations,
    half a complex FFT's 5 N log2 N), the magnitudes (4 a bin), the mel
    products over the filterbank's nonzeros (2 each) and the log (1 an
    output), in f32 at 67 TFLOP/s; against its bytes (the audio read
    once, the filterbank's nonzeros, the output written once) at 3.35
    TB/s."""
    import numpy as np

    from mr_mt3_tpu_torch.ops import mel_kernel
    hop, fft, mel = config.hop_width, config.fft_size, config.num_mel_bins
    frames, bins = -(-n // hop), fft // 2 + 1
    nnz = int(np.count_nonzero(mel_kernel._dft_constants(config)[2]))
    per_frame = fft + 2.5 * fft * math.log2(fft) + 4 * bins + 2 * nnz + mel
    nbytes = 4 * (batch * n + nnz + batch * frames * mel)
    return _bound(nbytes, batch * frames * per_frame / FP32_FLOPS)


def logmel_fft_bound_ms(batch, n, config):
    """The bound of the kernel's own algorithm, not of the function: per
    frame the window (N products), a radix-2 complex FFT of N / 2 points
    (5 (N / 2) log2(N / 2) operations), the real-input post-pass and the
    magnitude (16 a bin), the mel products over each filter's range of
    nonzero bins (2 each) and the log (1 an output), at 67 TFLOP/s: how
    far the kernel is from the arithmetic it chose."""
    from mr_mt3_tpu_torch.ops import mel_kernel
    hop, fft, mel = config.hop_width, config.fft_size, config.num_mel_bins
    frames, bins, half = -(-n // hop), fft // 2 + 1, fft // 2
    span = int(mel_kernel._fft_constants(config)[3].sum())
    per_frame = fft + 5 * half * math.log2(half) + 16 * bins + 2 * span \
        + mel
    return batch * frames * per_frame / FP32_FLOPS * 1e3


def logmel_cases(torch):
    """The log-mel kernel at the handler's shapes (B in {8, 64} segments
    of 32768 samples; a ragged 16000 at B 8), tone / noise / zeros, both
    filterbank styles: against compute_logmel and logmel_f64 within
    LOGMEL_BOUNDS, the control breaking both, zeros at log(1e-5); CUDA-
    event times of the kernel and of compute_logmel (cuFFT and cuBLAS: the
    plain version, and the library yardstick) beside the bound."""
    phase('log-mel kernel vs compute_logmel and a float64 DFT')
    from mr_mt3_tpu_torch.audio import SpectrogramConfig, compute_logmel
    from mr_mt3_tpu_torch.ops import mel_kernel as mk
    cases = []
    plan = [(style, batch, kind, LOGMEL_SAMPLES)
            for style in ('torch', 'tf') for batch in LOGMEL_BATCHES
            for kind in ('tone', 'noise', 'zeros')]
    plan.append(('torch', 8, 'tone', 16000))
    for style, batch, kind, n in plan:
        cfg = SpectrogramConfig(filterbank_style=style)
        x = torch.from_numpy(logmel_inputs(kind, batch, n)).cuda()
        got = mk.logmel(x, cfg)
        torch.cuda.synchronize()
        want_shape = (batch, -(-n // 128), cfg.num_mel_bins)
        if tuple(got.shape) != want_shape or not torch.isfinite(got).all():
            fail(f'logmel {style} B={batch} {kind}: shape '
                 f'{tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}')
        plain = compute_logmel(x, cfg)
        f64 = logmel_f64(torch, x, cfg)
        case = {'style': style, 'batch': batch, 'kind': kind, 'samples': n,
                'vs_plain': logmel_readings(torch, got, plain),
                'vs_f64': logmel_readings(torch, got, f64),
                'plain_vs_f64': logmel_readings(torch, plain, f64)}
        case['max_abs_err'] = float((got.double() - plain.double()).abs()
                                    .max())
        bad = [f'{ref}: {v}' for ref in ('vs_plain', 'vs_f64')
               for v in logmel_violations(LOGMEL_BOUNDS[ref], case[ref])]
        if kind == 'zeros':
            floor = float((got.double() - math.log(1e-5)).abs().max())
            case['floor_err'] = floor
            if floor > 1e-4:
                bad.append(f'zeros: {floor:.3g} off log(1e-5)')
        else:
            ctrl = logmel_f64(torch, x, cfg, hann=False)
            for ref, want in (('vs_plain', plain), ('vs_f64', f64)):
                r = logmel_readings(torch, ctrl, want)
                case[f'control_{ref}'] = r
                if not logmel_violations(LOGMEL_BOUNDS[ref], r):
                    bad.append(f'the control passes {ref}: {r}')
        if kind == 'tone' and n == LOGMEL_SAMPLES:
            case['ms'] = time_ms(torch, lambda: mk.logmel(x, cfg))
            case['plain_ms'] = time_ms(torch, lambda: compute_logmel(x, cfg))
            case['library_ms'] = case['plain_ms']
            case['bound_ms'], case['bound_by'] = logmel_bound_ms(
                batch, n, cfg)
            case['fft_bound_ms'] = logmel_fft_bound_ms(batch, n, cfg)
        print(f'logmel {style} B={batch} {kind} n={n}: ' + json.dumps(
            {k: v for k, v in case.items()
             if k not in ('style', 'batch', 'kind', 'samples')}))
        if bad:
            fail(f'logmel {style} B={batch} {kind} n={n}: {bad}')
        cases.append(case)
    return cases


EVAL_DIR = os.path.join(REPO, '.chip_smoke_eval')
# the eval main path: `python -m mr_mt3_tpu_torch.eval` on vanilla MT3 at
# full width (configs/config.yaml, seed-0 random weights saved as a port
# checkpoint) over 4 fabricated Slakh-format songs (14 segments)
EVAL_SONG_SECONDS = (4.0, 5.5, 7.0, 10.0)
EVAL_ARGS = ['model=MT3Net', f'eval.max_length={MAIN_PATH_MAX_LENGTH}']
# evaluate_main's keys
SCORE_KEYS = {'Onset precision', 'Onset recall', 'Onset F1'} | {
    f'Onset + program {m} ({g})' for m in ('precision', 'recall', 'F1')
    for g in ('flat', 'full', 'midi_class')}
# the JAX package's bar for a quantized tier's scores (infer/scores.py)
F1_TOLERANCE = 1e-3


def write_song(path, notes, program=0, is_drum=False):
    """notes [(start, end, pitch)] -> a MIDI file (the port's writer)."""
    from mr_mt3_tpu_torch.codec import note_sequences as nsq
    from mr_mt3_tpu_torch.midi import note_sequence_to_midi_file
    ns = nsq.NoteSequence()
    for start, end, pitch in notes:
        ns.add_note(start_time=start, end_time=end, pitch=int(pitch),
                    velocity=100, program=program, is_drum=is_drum,
                    instrument=9 if is_drum else 0)
        ns.total_time = max(ns.total_time, end)
    note_sequence_to_midi_file(ns, path)


def eval_set(root, audios, note_lists, subtype='PCM_16'):
    """A Slakh-format eval set: <root>/<song>/mix_16k.wav (the port's
    audio/io.write_wav) and the notes as <root>/<song>/all_src_v2.mid.
    Returns the WAV paths."""
    from mr_mt3_tpu_torch.audio import write_wav
    files = []
    for i, (audio, notes) in enumerate(zip(audios, note_lists)):
        d = os.path.join(root, f'Track{i:05d}')
        os.makedirs(d)
        write_wav(os.path.join(d, 'mix_16k.wav'), audio, 16000,
                  subtype=subtype)
        write_song(os.path.join(d, 'all_src_v2.mid'), notes)
        files.append(os.path.join(d, 'mix_16k.wav'))
    return files


def tone_songs(seconds, seed):
    """Songs of sine notes (a note every 0.5 s, 0.4 s long, random
    pitches 48-84) over -60 dB noise: (audios, note lists)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    audios, note_lists = [], []
    for sec in seconds:
        audio = rng.normal(size=int(16000 * sec)) * 1e-3
        notes = []
        for start in np.arange(0.25, sec - 0.5, 0.5):
            pitch = int(rng.integers(48, 85))
            i0, n = int(start * 16000), int(0.4 * 16000)
            t = np.arange(n) / 16000
            env = np.minimum(1, np.minimum(t / 0.02, (0.4 - t) / 0.05))
            audio[i0:i0 + n] += 0.3 * env * np.sin(
                2 * np.pi * 440 * 2 ** ((pitch - 69) / 12) * t)
            notes.append((float(start), float(start) + 0.4, pitch))
        audios.append(audio.astype('float32'))
        note_lists.append(notes)
    return audios, note_lists


class TierLog(Patches):
    """Records the tier of every InferenceHandler.transcribe_many call
    until closed (the tier get_scores served after its ladder), and what
    any call raised: get_scores catches it and retries song by song, and
    chip_smoke must not pass over it."""

    def __init__(self):
        from mr_mt3_tpu_torch.infer import InferenceHandler
        super().__init__()
        self.tiers, self.errors = [], []

        def recording(real, handler, audios):
            self.tiers.append(handler.quantize)
            try:
                return real(handler, audios)
            except Exception as e:
                self.errors.append(repr(e)[:300])
                raise
        self.patch(InferenceHandler, 'transcribe_many', recording)

    def close(self):
        super().close()
        if self.errors:
            fail(f'transcribe_many raised: {self.errors}')


def eval_main_path(torch):
    """`python -m mr_mt3_tpu_torch.eval model=MT3Net` as users run it,
    through eval.__main__.main(argv), on 4 fabricated songs at
    +eval.quantize=auto (the probe ladder from fused_int4) and at none:
    every song's MIDI written, evaluate_main's keys returned, the log-mel
    kernel's launches equal to the _compute_mel calls (the probe's
    counted), the window launches covering the windows decoded."""
    phase('eval main path: python -m mr_mt3_tpu_torch.eval '
          + ' '.join(EVAL_ARGS))
    import shutil

    from mr_mt3_tpu_torch.eval.__main__ import main as eval_main
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    from mr_mt3_tpu_torch.ops import mel_kernel as mk
    from mr_mt3_tpu_torch.utils import builders
    from mr_mt3_tpu_torch.utils.config import load_config

    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    results = {}
    try:
        songs = os.path.join(EVAL_DIR, 'songs')
        files = eval_set(songs, *tone_songs(EVAL_SONG_SECONDS, seed=3))
        model = builders.init_params(builders.build_model(load_config(
            os.path.join(REPO, 'configs'), 'config', EVAL_ARGS)), 0)
        ckpt = os.path.join(EVAL_DIR, 'weights')
        torch.save({'params': model.state_dict(), 'step': 0}, ckpt)
        del model
        for quantize in ('auto', 'none'):
            out = os.path.join(EVAL_DIR, f'midis_{quantize}')
            for tier in TIERS:
                fd.LAUNCHES[tier] = 0
            mk.LAUNCHES[mk.KERNEL] = 0
            decodes, mels, tiers = DecodeLog(), MelLog(), TierLog()
            t0 = time.monotonic()
            try:
                scores = eval_main(EVAL_ARGS + [
                    f'path={ckpt}', f'eval.audio_dir={songs}/*/mix_16k.wav',
                    f'eval.exp_tag_name={out}', f'eval.midi_dir={songs}',
                    f'+eval.quantize={quantize}'])
            finally:
                tiers.close()
                mels.close()
                decodes.close()
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
            launches = dict(fd.LAUNCHES)
            launches[mk.KERNEL] = mk.LAUNCHES[mk.KERNEL]
            served = tiers.tiers[-1] if tiers.tiers else None
            print(f'eval at {quantize}: {secs:.1f} s for {len(files)} songs '
                  f'({secs / len(files):.2f} s a song, probe included), '
                  f'tier served {served!r}, Onset F1 '
                  f'{scores.get("Onset F1")}, launches {launches}')
            midis = [os.path.join(out, os.path.basename(os.path.dirname(f)),
                                  'mix.mid') for f in files]
            missing = [m for m in midis if not os.path.exists(m)
                       or open(m, 'rb').read(4) != b'MThd']
            if missing or set(scores) != SCORE_KEYS:
                fail(f'eval at {quantize}: missing MIDI {missing}, score '
                     f'keys {sorted(scores)}')
            # at auto the ladder may end at any tier: random weights give
            # material flips (serving's ladder walks them the same way)
            if tiers.tiers != [served] or \
                    (quantize == 'none' and served != 'none'):
                fail(f'eval at {quantize}: tiers {tiers.tiers}')
            mels.check(launches[mk.KERNEL], f'eval at {quantize}')
            check_launches(launches, decodes, TIERS)
            if quantize == 'auto' and launches['fused_int4'] < 1:
                fail('the ladder did not launch the int4 kernel')
            results[quantize] = {
                'seconds': secs, 'seconds_per_song': secs / len(files),
                'songs': len(files), 'tier': served, 'scores': scores,
                'launches': launches, 'compute_mel_calls': mels.calls}
            if quantize == 'auto':
                results['leakage'] = leakage(out, songs)
    finally:
        shutil.rmtree(EVAL_DIR, ignore_errors=True)
    return results


def leakage(out, truth):
    """The paper's instrument-leakage analysis
    (`python -m mr_mt3_tpu_torch.scripts.instrument_leakage`) of the
    transcriptions in `out` against the ground truth `truth`: distinct
    programs per transcription and instrument-presence P/R/F1. On `truth`
    itself every song counts the one program eval_set wrote."""
    import warnings

    from mr_mt3_tpu_torch.scripts import instrument_leakage as il
    songs = sorted(os.listdir(truth))
    t0 = time.monotonic()
    counts = il.count_num_instruments(out, truth)
    with warnings.catch_warnings():
        # random weights may transcribe no program: the means are then NaN
        warnings.simplefilter('ignore', RuntimeWarning)
        presence = il.instrument_presence_f1(out, truth)
    truth_counts = il.count_num_instruments(truth, truth)
    secs = time.monotonic() - t0
    print(f'leakage: programs per transcription {counts}; presence '
          f'{json.dumps(presence)}; ground truth {truth_counts} '
          f'({secs:.2f} s)')
    if sorted(counts) != songs or truth_counts != {s: 1 for s in songs}:
        fail(f'leakage: counts {counts}, ground truth {truth_counts} for '
             f'songs {songs}')
    return {'programs_per_transcription': counts, 'presence': presence,
            'ground_truth_programs': truth_counts, 'seconds': secs}


def eval_f1_card_vs_cpu(torch):
    """get_scores on the overfit parity model over its own corpus (float
    WAVs) and notes: on the CPU, then on the card held at each tier (the
    exact path and the three window tiers): every score within
    F1_TOLERANCE of the CPU's."""
    phase('F1 on the card vs the CPU (tests/goldens/parity_vanilla.npz)')
    import shutil

    from mr_mt3_tpu_torch.infer.scores import get_scores
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    model, _, max_length, _ = parity_model(torch, 'parity_vanilla.npz')
    results = {}
    try:
        gt = os.path.join(EVAL_DIR, 'parity')
        files = eval_set(gt, *parity_corpus(), subtype='FLOAT')
        for tier in ('cpu', 'none') + TIERS:
            t0 = time.monotonic()
            tiers = TierLog()
            try:
                scores = get_scores(
                    model=model, eval_audio_dir=files,
                    exp_tag_name=os.path.join(EVAL_DIR, f'midis_{tier}'),
                    ground_truth_midi_dir=gt, max_length=max_length,
                    quantize='none' if tier == 'cpu' else tier,
                    device='cpu' if tier == 'cpu' else 'cuda',
                    verbose=False)
            finally:
                tiers.close()
            results[tier] = {'scores': scores,
                             'seconds': time.monotonic() - t0}
            apart = max((abs(scores[k] - results['cpu']['scores'][k])
                         for k in SCORE_KEYS if k in scores), default=None)
            results[tier]['max_apart'] = apart
            print(f'{tier}: Onset F1 {scores.get("Onset F1")}, program F1 '
                  f'(full) {scores.get("Onset + program F1 (full)")}, '
                  f'largest score apart from the CPU {apart} '
                  f'({results[tier]["seconds"]:.1f} s)')
            if set(scores) != SCORE_KEYS or apart > F1_TOLERANCE:
                fail(f'{tier}: scores {scores} against the CPU\'s '
                     f'{results["cpu"]["scores"]}')
        if results['cpu']['scores']['Onset F1'] < 0.5:
            fail(f'the parity model scores {results["cpu"]["scores"]}')
    finally:
        shutil.rmtree(EVAL_DIR, ignore_errors=True)
    return results


TRAIN_DIR = os.path.join(REPO, '.chip_smoke_train')
# the paper's recipe (train.py:5-7) at bf16 on the card; every override
# below the model's is a cut of scale. Its eval hook is off here and on in
# the training main path (TRAIN_EVAL_ARGS)
TRAIN_ARGS = ['--config-name=config_slakh_segmem',
              'model=MT3NetSegMemV2WithPrev', 'dataset=SlakhPrev',
              'model_segmem_length=64', 'trainer.precision=bf16',
              'eval.audio_dir=null']
# the eval hook on the training main path, every epoch, over the first val
# song (15 segments, two memory chains); decodes cut to 64 steps (the
# exact path's eager loop takes ~10 ms a step, 8 segments a chain in turn)
TRAIN_EVAL_ARGS = ['eval.eval_after_num_epoch=0', 'eval.eval_per_epoch=1',
                   'eval.eval_first_n_examples=1', 'eval.max_length=64']
# The bf16 training step of the full-width model (one batch, dropout off)
# with the attention kernels, per parameter gradient, against (a)
# attention_kernel='einsum', which rounds its scores to bf16 before the
# softmax; (b) the same fused route with the kernels' plain versions,
# which differ from the kernels only in sum order; (c) at fp32, the plain
# versions against einsum (sum order only, no bf16 rounding). Readings:
# the loss's relative difference; per parameter the largest |difference|
# over the largest |value| (grad_rel) and the difference's norm over the
# value's (grad_norm_rel), worst and median. Run T (seeds 0 / 1; NVIDIA
# H100 80GB HBM3, 700 W; PERF.md) read: (c) loss 0 / 0, grad_rel 3.2e-5 /
# 4.3e-5, grad_norm_rel 2.2e-5 / 3.2e-5, so the two routes compute one
# function and (a) and (b) are bf16 rounding carried through 17 layers;
# (b) loss 3.9e-5 / 6.3e-5, grad_rel 0.17 / 0.24 (median 0.076 / 0.098),
# grad_norm_rel 0.149 / 0.159 (median 0.085 / 0.110); (a) loss 8.2e-5 /
# 9.9e-5, grad_rel 0.29 / 0.74 (median 0.14 / 0.19), grad_norm_rel 0.25 /
# 0.44 (median 0.15 / 0.22). Bounds at 2x the larger reading ((c) at
# about 3x): the readings repeat to the digit on the same seeds (runs Q,
# R, S), and the control (dk x 1.3) read grad_norm_rel 1.15 (median 0.41)
# and grad_rel 1.33 (median 0.39) against (b)'s reference, past every
# bound of (b). (a) checks scale and sign only; (b) with its control and
# (c) carry the check.
TRAIN_PARITY_BOUNDS = {
    'kernel_vs_einsum': {'loss_rel': 2e-4, 'grad_rel': 1.5,
                         'grad_rel_median': 0.4, 'grad_norm_rel': 0.9,
                         'grad_norm_rel_median': 0.45},
    'kernel_vs_plain': {'loss_rel': 1.3e-4, 'grad_rel': 0.48,
                        'grad_rel_median': 0.2, 'grad_norm_rel': 0.32,
                        'grad_norm_rel_median': 0.22},
    'f32_plain_vs_einsum': {'loss_rel': 1e-6, 'grad_rel': 1.5e-4,
                            'grad_norm_rel': 1e-4}}
TRAIN_PARITY_SEEDS = (0, 1)
# the control: the backward kernel's dk scaled by this must break
# TRAIN_PARITY_BOUNDS['kernel_vs_plain']
TRAIN_PARITY_CONTROL_DK = 1.3
# fp32 on the card (TF32 off) vs the CPU: the same math in other sum orders
TRAIN_F32_LOSS_RTOL = 1e-5
# training steps timed per attention route for the ms/step yardstick
TRAIN_TIMED_STEPS = 5


# the training corpus's stems: (Slakh class, General MIDI program, drums)
SLAKH_STEMS = [('Acoustic Piano', 0, False), ('Electric Bass', 33, False),
               ('Drums', 0, True)]


def slakh_corpus(root, songs, seconds, dense, seed):
    """A corpus as slakh2100_flac_redux publishes it: per song a 44.1 kHz
    16-bit mono mix.flac of noise (the port's encoder), three stems (piano,
    bass, drums) as MIDI/S00.mid... (the port's writer), one note every
    0.05 s per stem where `dense` (so a 2.048 s segment's targets bucket to
    768 or 1024 tokens and the decoder's attentions take the kernels),
    every 0.4 s otherwise, and metadata.yaml naming each stem's program.
    mix_16k.wav, all_src_v2.mid and inst_names.json are left to the
    preparation scripts."""
    import numpy as np
    import yaml

    from mr_mt3_tpu_torch.codec import note_sequences as nsq
    from mr_mt3_tpu_torch.midi import note_sequence_to_midi_file
    from mr_mt3_tpu_torch.native import encode_flac_bytes
    rng = np.random.default_rng(seed)
    for si in range(songs):
        d = os.path.join(root, f'Track{seed:02d}{si:03d}')
        os.makedirs(os.path.join(d, 'MIDI'))
        audio = rng.normal(size=int(44100 * seconds)) * 0.05
        with open(os.path.join(d, 'mix.flac'), 'wb') as f:
            f.write(encode_flac_bytes(
                (audio.clip(-1, 1) * 32767).astype(np.int32), 44100))
        gap = 0.05 if dense[si] else 0.4
        stems = {}
        for ti, (name, program, drum) in enumerate(SLAKH_STEMS):
            ns = nsq.NoteSequence()
            for i in range(int((seconds - 0.5) / gap)):
                ns.add_note(start_time=i * gap, end_time=i * gap + 0.04,
                            pitch=int(rng.integers(36, 84)), velocity=100,
                            program=program, is_drum=drum,
                            instrument=9 if drum else 0)
            ns.total_time = seconds
            note_sequence_to_midi_file(
                ns, os.path.join(d, 'MIDI', f'S{ti:02d}.mid'))
            stems[f'S{ti:02d}'] = {
                'inst_class': name, 'program_num': program, 'is_drum': drum,
                'audio_rendered': True, 'midi_saved': True,
                'integrated_loudness': float(-20 - ti)}
        with open(os.path.join(d, 'metadata.yaml'), 'w') as f:
            yaml.safe_dump({'audio_dir': 'stems', 'midi_dir': 'MIDI',
                            'stems': stems}, f)


def prepare_slakh(root, splits):
    """The Slakh preparation as users run it, through the port's scripts:
    generate_inst_names and merge_slakh_midi on each split, then
    resample_slakh on the root. Returns each script's seconds."""
    from mr_mt3_tpu_torch.scripts import (
        generate_inst_names,
        merge_slakh_midi,
        resample_slakh,
    )
    seconds = {}
    for name, run in (
            ('generate_inst_names',
             lambda: [generate_inst_names.main(s) for s in splits]),
            ('merge_slakh_midi',
             lambda: [merge_slakh_midi.main(s) for s in splits]),
            ('resample_slakh', lambda: resample_slakh.main(root))):
        t0 = time.monotonic()
        out = run()
        seconds[name] = time.monotonic() - t0
        if name == 'resample_slakh' and out:
            fail(f'resample_slakh failed on {out}')
    for split in splits:
        for song in os.listdir(split):
            d = os.path.join(split, song)
            with open(os.path.join(d, 'inst_names.json')) as f:
                names = json.load(f)
            if names != {f'S{i:02d}': n for i, (n, _, _) in
                         enumerate(SLAKH_STEMS)} or not all(
                    os.path.exists(os.path.join(d, f)) for f in (
                        'all_src_v2.mid', 'mix_16k.wav')):
                fail(f'{d}: inst_names {names}, {sorted(os.listdir(d))}')
    return seconds


def tokenizer_check(splits):
    """Each prepared song read as training reads it (SlakhDataset's
    __getitem__: read_audio, its stems and inst_names.json,
    transforms.tokenize_song), its one tokenizer call recorded: the native
    core's five arrays equal those of the Python path
    (rle.encode_and_index_events) on the same inputs. Returns ms per song
    on each path."""
    import numpy as np

    from mr_mt3_tpu_torch.codec import note_sequences as nsq
    from mr_mt3_tpu_torch.codec import rle
    from mr_mt3_tpu_torch.data import transforms
    from mr_mt3_tpu_torch.data.slakh import SlakhDataset
    from mr_mt3_tpu_torch.native import tokenizer
    recorded = []

    def recording(real, times, values, codec, frame_times,
                  include_ties=True):
        t0 = time.monotonic()
        out = real(times, values, codec, frame_times,
                   include_ties=include_ties)
        recorded.append((time.monotonic() - t0, times, values, codec,
                         frame_times, include_ties, out))
        return out

    songs = []
    patches = Patches()
    patches.patch(transforms, 'encode_note_events', recording)
    try:
        for split in splits:
            ds = SlakhDataset(split, shuffle=False, cache_songs=False)
            for idx, row in enumerate(ds.df):
                calls, before = tokenizer.CALLS, len(recorded)
                if ds[idx] is None:
                    fail(f'{row["audio_path"]}: the dataset skipped it')
                if len(recorded) != before + 1 or \
                        tokenizer.CALLS != calls + 1:
                    fail(f'{row["audio_path"]}: not one native tokenizer '
                         f'call ({transforms.NATIVE_FALLBACK})')
                songs.append(row['audio_path'])
    finally:
        patches.close()
    native_ms, python_ms, note_events = [], [], []
    for path, (secs, times, values, codec, frame_times, include_ties,
               native) in zip(songs, recorded):
        t0 = time.monotonic()
        python = rle.encode_and_index_events(
            state=nsq.NoteEncodingState() if include_ties else None,
            event_times=times, event_values=values,
            encode_event_fn=nsq.note_event_data_to_events, codec=codec,
            frame_times=frame_times,
            encoding_state_to_events_fn=(
                nsq.note_encoding_state_to_events if include_ties
                else None))
        python_ms.append((time.monotonic() - t0) * 1e3)
        native_ms.append(secs * 1e3)
        note_events.append(len(values))
        for name, a, b in zip(('events', 'starts', 'ends', 'state_events',
                               'state_idx'), native, python):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                fail(f'{path}: native {name} differ from the Python '
                     f'path\'s')
    return {'songs': len(native_ms), 'note_events': note_events,
            'native_ms_per_song': statistics.mean(native_ms),
            'python_ms_per_song': statistics.mean(python_ms)}


class TrainLog(Patches):
    """Stands in for the trainer's train step and the model's forward and
    memory encoder until closed: times each train step (synchronized),
    counts its real target tokens, and counts the long attentions the
    model runs (models/mt3.py's rule: Lq >= 512, Lq % 8 == 0, a bf16
    model on the card) forward, and backward where gradients flow.
    time_steps=False counts the attentions alone (no synchronize)."""

    def __init__(self, torch, time_steps=True):
        from mr_mt3_tpu_torch.models import MT3
        from mr_mt3_tpu_torch.models import mt3
        from mr_mt3_tpu_torch.train import trainer
        super().__init__()
        self.steps = []            # (seconds, target tokens, target length)
        self.fwd = self.bwd = 0
        log = self

        def fused(model, length):
            return length >= mt3._FUSED_MIN_LEN and length % 8 == 0 and \
                mt3.resolve_attention_kernel(
                    model.cfg, model.proj.weight.device) == 'fused'

        def count(n):
            log.fwd += n
            if torch.is_grad_enabled():
                log.bwd += n

        def make_train_step(real, *args, **kw):
            step = real(*args, **kw)

            def timed(state, batch, seed):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                metrics = step(state, batch, seed)
                torch.cuda.synchronize()
                t = batch['targets']
                log.steps.append((time.monotonic() - t0,
                                  int((t != -100).sum()), t.shape[1]))
                return metrics
            return timed

        def forward(real, model, mel, decoder_input_ids=None,
                    targets_prev=None, labels=None, generator=None):
            length = (labels if decoder_input_ids is None
                      else decoder_input_ids).shape[1]
            if fused(model, length):
                count(2 * model.cfg.num_decoder_layers)
            return real(model, mel, decoder_input_ids, targets_prev,
                        labels, generator)

        def compute_segmem(real, model, prev_ids):
            if fused(model, prev_ids.shape[1]):
                count(model.cfg.segmem_num_layers)
            return real(model, prev_ids)
        if time_steps:
            self.patch(trainer, 'make_train_step', make_train_step)
        self.patch(MT3, 'forward', forward)
        self.patch(MT3, 'compute_segmem', compute_segmem)


def step_breakdown(torch, state, batch):
    """One train step's parts, each closed by a synchronize (so their sum
    exceeds an unsynchronized step): the batch to the card and its mel,
    the forward and the loss, the gradients, the optimizer; the median
    of TRAIN_TIMED_STEPS steps, in ms."""
    from mr_mt3_tpu_torch.audio import SpectrogramConfig
    from mr_mt3_tpu_torch.train import losses
    from mr_mt3_tpu_torch.train.trainer import batch_to_device, batch_to_mel
    params = state.optimizer.params
    parts = {'mel_ms': [], 'forward_ms': [], 'backward_ms': [],
             'optimizer_ms': []}

    def lap(key, t0):
        torch.cuda.synchronize()
        t1 = time.monotonic()
        parts[key].append((t1 - t0) * 1e3)
        return t1
    for _ in range(TRAIN_TIMED_STEPS):
        torch.cuda.synchronize()
        t = time.monotonic()
        b = batch_to_device(batch, params[0].device)
        mel = batch_to_mel(b['audio'], b['valid_frames'], SpectrogramConfig())
        t = lap('mel_ms', t)
        loss = losses.cross_entropy_loss(
            state.model(mel, labels=b['targets'],
                        targets_prev=b['targets_prev']), b['targets'])
        t = lap('forward_ms', t)
        grads = torch.autograd.grad(loss, params)
        t = lap('backward_ms', t)
        state.optimizer.step(grads)
        lap('optimizer_ms', t)
    return {k: statistics.median(v) for k, v in parts.items()}


def training_configs():
    """The training phases' configurations: TRAIN_ARGS (bf16, the kernel
    route where attention_kernel allows it) and its fp32 twin, dropout
    off."""
    from mr_mt3_tpu_torch.utils.config import load_config
    cfg = load_config(os.path.join(REPO, 'configs'), 'config_slakh_segmem',
                      TRAIN_ARGS[1:] + ['model.config.dropout_rate=0.0'])
    f32 = load_config(os.path.join(REPO, 'configs'), 'config_slakh_segmem',
                      TRAIN_ARGS[1:4] + ['model.config.dropout_rate=0.0'])
    return cfg, f32


def training_batch(rng, rows, length, real):
    """A seeded train batch: rows of 256-frame audio, `real` target tokens
    and an EOS padded to `length`, the previous segment's targets."""
    import numpy as np
    targets = np.concatenate([
        rng.integers(3, 1391, (rows, real)), np.ones((rows, 1), np.int64),
        np.full((rows, length - real - 1), -100, np.int64)], axis=1)
    return {'audio': (rng.normal(size=(rows, 256 * 128)) * 0.1
                      ).astype(np.float32),
            'valid_frames': np.full((rows,), 256, np.int32),
            'targets': targets,
            'targets_prev': np.roll(targets, 1, axis=0)}


def training_model(torch, config, kernel, seed):
    """The configuration's model on the card with attention_kernel=kernel,
    seeded weights."""
    from mr_mt3_tpu_torch.models import MT3
    from mr_mt3_tpu_torch.utils import builders
    model = MT3(builders.build_model(config).cfg.replace(
        attention_kernel=kernel))
    return builders.init_params(model, seed=seed).to(torch.device('cuda'))


# the attention kernels by the symbols in a trace (both designs' names)
ATTN_KERNEL_SYMBOLS = {'fused_attention_fwd': ('faf_kernel',),
                       'fused_attention_bwd': ('fab_dq_kernel',
                                               'fab_dkdv_kernel')}
# kernels by name kept in a train step's profile
TRAIN_PROFILE_TOP = 12


def train_step_profile(torch, run_step, wall_ms):
    """One train step (run_step()) under torch.profiler (device_time by
    name): device busy ms, the idle share of wall_ms (the timed loop's ms
    per step), the attention kernels' ms and their share of the device
    time, and the TRAIN_PROFILE_TOP largest device events by name."""
    total, _, names = device_time(torch, run_step, by_name=True)
    attention = {kernel: sum(ms for name, ms in names.items()
                             if any(sym in name for sym in symbols))
                 for kernel, symbols in ATTN_KERNEL_SYMBOLS.items()}
    top = sorted(names.items(), key=lambda kv: -kv[1])[:TRAIN_PROFILE_TOP]
    return {'device_ms': total, 'wall_ms': wall_ms,
            'idle_share': 1 - total / wall_ms,
            'attention_ms': attention,
            'attention_share': sum(attention.values()) / total,
            'top_ms': dict(top)}


def print_step_profile(label, prof):
    print(f'train step profile, {label}: device {prof["device_ms"]:.2f} ms '
          f'of {prof["wall_ms"]:.2f} (idle {prof["idle_share"]:.1%}); '
          f'attention kernels ' + json.dumps(
              {k: round(v, 3) for k, v in prof['attention_ms'].items()})
          + f' ({prof["attention_share"]:.1%} of the device time)',
          flush=True)


def training_parity(torch):
    """The full-width segment-memory model at bf16 (dropout off, B 12, a
    bucketed target length of 1024), for each of TRAIN_PARITY_SEEDS (the
    weights and the batch): loss and every parameter's gradient with the
    attention kernels against the same with attention_kernel='einsum', and
    against the kernels' plain versions on the same route; the plain
    versions against einsum at fp32, where the two routes differ only in
    sum order; on the first seed a control, the kernels with the backward's
    dk scaled by TRAIN_PARITY_CONTROL_DK, which TRAIN_PARITY_BOUNDS must
    catch. Then TRAIN_TIMED_STEPS train steps on each of the kernel and
    einsum routes twice, in turns (ms/step, the yardstick), and one step
    of each under torch.profiler (train_step_profile: device ms, idle
    share, the attention kernels' ms); then an fp32 step (B 2, einsum) on
    the card against the same step on the CPU."""
    phase('training parity on the card (full-width segmem model)')
    import contextlib

    import numpy as np

    from mr_mt3_tpu_torch.ops import train_attention as ta
    from mr_mt3_tpu_torch.train import losses, optim
    from mr_mt3_tpu_torch.train.trainer import (
        batch_to_device,
        batch_to_mel,
        create_train_state,
        make_train_step,
    )
    from mr_mt3_tpu_torch.audio import SpectrogramConfig
    from mr_mt3_tpu_torch.utils import builders

    cfg, f32 = training_configs()
    dev = torch.device('cuda')
    rows = int(cfg.num_rows_per_batch)
    batch = training_batch

    def loss_and_grads(model, b):
        t = batch_to_device(b, model.proj.weight.device)
        mel = batch_to_mel(t['audio'], t['valid_frames'], SpectrogramConfig())
        loss = losses.cross_entropy_loss(
            model(mel, labels=t['targets'], targets_prev=t['targets_prev']),
            t['targets'])
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return float(loss.detach()), grads

    @contextlib.contextmanager
    def kernels_replaced(forward, backward):
        real = ta.fused_attention_cuda, ta.fused_attention_backward_cuda
        ta.fused_attention_cuda, ta.fused_attention_backward_cuda = \
            forward, backward
        try:
            yield
        finally:
            ta.fused_attention_cuda, ta.fused_attention_backward_cuda = real

    def plain():
        return kernels_replaced(ta.fused_attention_reference,
                                ta.fused_attention_backward_reference)

    def control():
        kernel = ta.fused_attention_backward_cuda

        def backward(*args):
            dq, dk, dv = kernel(*args)
            return dq, dk * TRAIN_PARITY_CONTROL_DK, dv
        return kernels_replaced(ta.fused_attention_cuda, backward)

    def model_of(config, kernel, seed):
        return training_model(torch, config, kernel, seed)

    def compare(got, want):
        """loss relative; per parameter, the largest |difference| over the
        largest |value| and the norm of the difference over the norm of
        the value: the worst parameter and the median of each."""
        out = {'loss_rel': abs(got[0] - want[0]) / abs(want[0])}
        for key, fn in (('grad_rel', lambda d, w: float(d.abs().max()) /
                         float(w.abs().max())),
                        ('grad_norm_rel', lambda d, w: float(d.norm()) /
                         float(w.norm()))):
            rel = {name: fn(g - w, w)
                   for name, g, w in zip(names, got[1], want[1])}
            worst = max(rel, key=rel.get)
            out.update({key: rel[worst], f'{key}_worst_param': worst,
                        f'{key}_median': statistics.median(rel.values())})
        return out

    def violations(kind, reading):
        return [f'{kind} {k} {reading[k]:.4g} > {b}'
                for k, b in TRAIN_PARITY_BOUNDS[kind].items()
                if reading[k] > b]

    readings, models, names = {}, {}, None
    for seed in TRAIN_PARITY_SEEDS:
        big = batch(np.random.default_rng(6 + seed), rows, 1024, 900)
        out = {}
        for kernel in ('fused', 'einsum'):
            model = model_of(cfg, kernel, seed)
            names = [n for n, _ in model.named_parameters()]
            before = dict(ta.LAUNCHES)
            out[kernel] = loss_and_grads(model, big)
            torch.cuda.synchronize()
            launched = {k: ta.LAUNCHES[k] - before[k] for k in ta.LAUNCHES}
            want = 1 + 2 * model.cfg.num_decoder_layers \
                if kernel == 'fused' else 0
            if launched != {ta.KERNEL: want, ta.KERNEL_BWD: want}:
                fail(f'attention_kernel={kernel!r}: launches {launched}, '
                     f'expected {want} forward and backward')
            if seed == TRAIN_PARITY_SEEDS[0]:
                models[kernel] = model
        with plain():
            out['plain'] = loss_and_grads(model_of(cfg, 'fused', seed), big)
        if seed == TRAIN_PARITY_SEEDS[0]:
            with control():
                out['control'] = loss_and_grads(models['fused'], big)
        with plain():
            out['f32_plain'] = loss_and_grads(model_of(f32, 'fused', seed),
                                              big)
        out['f32_einsum'] = loss_and_grads(model_of(f32, 'einsum', seed), big)
        torch.cuda.empty_cache()
        readings[f'seed{seed}'] = {
            'loss_fused': out['fused'][0], 'loss_einsum': out['einsum'][0],
            'loss_plain': out['plain'][0],
            'kernel_vs_einsum': compare(out['fused'], out['einsum']),
            'kernel_vs_plain': compare(out['fused'], out['plain']),
            'f32_plain_vs_einsum': compare(out['f32_plain'],
                                           out['f32_einsum'])}
        if 'control' in out:
            readings['control_vs_plain'] = compare(out['control'],
                                                   out['plain'])
        print(json.dumps({f'seed{seed}': readings[f'seed{seed}']}),
              flush=True)
        del out
    print(json.dumps({'control_vs_plain': readings['control_vs_plain']}),
          flush=True)
    bad = [v for seed in TRAIN_PARITY_SEEDS for kind in TRAIN_PARITY_BOUNDS
           for v in violations(kind, readings[f'seed{seed}'][kind])]
    if bad:
        fail('training step: ' + '; '.join(bad))
    caught = violations('kernel_vs_plain', readings['control_vs_plain'])
    print(f'control (dk x {TRAIN_PARITY_CONTROL_DK}) caught by: '
          + ('; '.join(caught) or 'nothing'), flush=True)
    if not caught:
        fail(f'TRAIN_PARITY_BOUNDS["kernel_vs_plain"] pass the control (dk '
             f'x {TRAIN_PARITY_CONTROL_DK}): {readings["control_vs_plain"]}')
    big = batch(np.random.default_rng(6 + TRAIN_PARITY_SEEDS[0]), rows, 1024,
                900)

    # ms per train step on each route (the same batch, dropout off), the
    # routes timed in turns (fused, einsum, einsum, fused): the step is
    # host-bound, and the host's speed drifts within a run
    runs = {}
    for kernel in ('fused', 'einsum'):
        state = create_train_state(models[kernel], optim.make_optimizer(
            2e-4, use_schedule=False))
        step = make_train_step()
        step(state, big, None)
        runs[kernel] = {'state': state, 'step': step, 'turns_ms': []}
    for kernel in ('fused', 'einsum', 'einsum', 'fused'):
        run = runs[kernel]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(TRAIN_TIMED_STEPS):
            run['metrics'] = run['step'](run['state'], big, None)
        torch.cuda.synchronize()
        run['turns_ms'].append(
            (time.monotonic() - t0) / TRAIN_TIMED_STEPS * 1e3)
    timing = {}
    tokens = int((big['targets'] != -100).sum())
    for kernel, run in runs.items():
        ms = statistics.mean(run['turns_ms'])
        timing[kernel] = {'ms_per_step': ms, 'turns_ms': run['turns_ms'],
                          'target_tokens_per_s': tokens / ms * 1e3,
                          'loss': float(run['metrics']['loss']),
                          **step_breakdown(torch, run['state'], big)}
        print(f'train step, attention_kernel={kernel!r}: {ms:.2f} ms/step '
              f'(turns {", ".join(f"{t:.2f}" for t in run["turns_ms"])}), '
              f'{tokens / ms * 1e3:.0f} target tokens/s (B {rows}, target '
              f'length 1024, memory 1024); synchronized parts (ms): '
              + json.dumps({k: round(v, 2) for k, v in timing[kernel].items()
                            if k.endswith('_ms') and k != 'turns_ms'}),
              flush=True)
        timing[kernel]['profile'] = train_step_profile(
            torch, lambda: run['step'](run['state'], big, None), ms)
        print_step_profile(kernel, timing[kernel]['profile'])
        if not np.isfinite(timing[kernel]['loss']):
            fail(f'{kernel}: the loss after {TRAIN_TIMED_STEPS} steps is '
                 f'not finite')
    del models, runs, state, step
    torch.cuda.empty_cache()

    # fp32: the card (TF32 off) against the CPU on one small step
    small = batch(np.random.default_rng(5), 2, 128, 100)
    losses_f32 = {}
    for where, device in (('cuda', dev), ('cpu', torch.device('cpu'))):
        model = builders.init_params(builders.build_model(f32), seed=0)
        losses_f32[where] = loss_and_grads(model.to(device), small)[0]
    f32_rel = abs(losses_f32['cuda'] - losses_f32['cpu']) / abs(
        losses_f32['cpu'])
    print(f'fp32 step: loss on the card {losses_f32["cuda"]:.7f}, on the '
          f'CPU {losses_f32["cpu"]:.7f}, relative {f32_rel:.3g}')
    if f32_rel > TRAIN_F32_LOSS_RTOL:
        fail(f'fp32 loss on the card vs the CPU: {f32_rel:.3g} > '
             f'{TRAIN_F32_LOSS_RTOL}')
    return {**readings, 'timing': timing, 'f32_card_vs_cpu_rel': f32_rel}


def training_main_path(torch):
    """`python -m mr_mt3_tpu_torch.train` as TRAIN_ARGS gives it, through
    train.main(argv), on a fabricated corpus in Slakh's published layout
    (4 train songs, 2 of them dense, and 2 validation songs, 30 s each;
    slakh_corpus) prepared by the port's scripts (prepare_slakh), its
    songs tokenized by the native core and the Python path with equal
    arrays (tokenizer_check): 2 epochs with validation, then a resume from
    'last' for one more. The native tokenizer tokenized the first leg's
    corpus, with no fallback; every logged loss finite; the checkpoints
    load; the step and the optimizer count go on from the resumed ones;
    the kernels' launches equal the long attentions the steps and
    validations ran; the eval hook (TRAIN_EVAL_ARGS) reads the validation
    songs' mix.flac and logs val_f1_* after each validation, its decodes
    on the exact path, its log-mel launches equal to its _compute_mel
    calls."""
    phase('training main path: python -m mr_mt3_tpu_torch.train '
          + ' '.join([a for a in TRAIN_ARGS[1:]
                      if not a.startswith('eval.audio_dir')]
                     + ['eval.audio_dir=<validation>/*/mix.flac']
                     + TRAIN_EVAL_ARGS))
    import shutil

    import numpy as np

    from mr_mt3_tpu_torch import train
    from mr_mt3_tpu_torch.data import transforms
    from mr_mt3_tpu_torch.models import MT3
    from mr_mt3_tpu_torch.native import tokenizer
    from mr_mt3_tpu_torch.ops import mel_kernel as mk
    from mr_mt3_tpu_torch.ops import train_attention as ta
    from mr_mt3_tpu_torch.train.trainer import load_checkpoint
    from mr_mt3_tpu_torch.utils import builders
    from mr_mt3_tpu_torch.utils.config import load_config

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    corpus = {split: os.path.join(TRAIN_DIR, split)
              for split in ('train', 'validation')}
    t0 = time.monotonic()
    slakh_corpus(corpus['train'], 4, 30.0, [True, False, True, False],
                 seed=1)
    slakh_corpus(corpus['validation'], 2, 30.0, [True, False], seed=2)
    results = {'corpus_seconds': time.monotonic() - t0}
    results['preparation_seconds'] = prepare_slakh(TRAIN_DIR,
                                                   list(corpus.values()))
    results['tokenizer'] = tokenizer_check(list(corpus.values()))
    print(f'[{card_line()}] Slakh corpus (mix.flac, MIDI stems, '
          f'metadata.yaml) written in {results["corpus_seconds"]:.2f} s; '
          f'prepared by the port\'s scripts in seconds '
          f'{json.dumps(results["preparation_seconds"])}; tokenizer '
          f'{json.dumps(results["tokenizer"])}')
    out_dir = os.path.join(TRAIN_DIR, 'run')
    argv = TRAIN_ARGS + TRAIN_EVAL_ARGS + [
        f'eval.audio_dir={corpus["validation"]}/*/mix.flac',
        f'eval.midi_dir={corpus["validation"]}',
        f'dataset.train.root_dir={corpus["train"]}',
        f'dataset.val.root_dir={corpus["validation"]}', f'out_dir={out_dir}',
        'trainer.check_val_every_n_epoch=1', 'trainer.log_every_n_steps=1',
        'modelcheckpoint.every_n_epochs=1', 'modelcheckpoint.save_top_k=1',
        'optim.warmup_steps=4', 'optim.num_steps_per_epoch=4']
    try:
        for leg, extra in (('first', ['trainer.max_epochs=2']),
                           ('resumed', ['trainer.max_epochs=3',
                                        f'path={out_dir}/checkpoints/last'])):
            for k in ta.LAUNCHES:
                ta.LAUNCHES[k] = 0
            mk.LAUNCHES[mk.KERNEL] = 0
            tokenizer.CALLS = 0
            log = TrainLog(torch)
            mels, tiers = MelLog(), TierLog()
            t0 = time.monotonic()
            try:
                state = train.main(argv + extra)
            finally:
                tiers.close()
                mels.close()
                log.close()
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
            launches = dict(ta.LAUNCHES)
            mels.check(mk.LAUNCHES[mk.KERNEL], f'the eval hook, {leg} leg')
            launches[mk.KERNEL] = mk.LAUNCHES[mk.KERNEL]
            steps = log.steps
            timed = steps[1:] or steps   # the first step pays the warm-up
            ms = statistics.median(s for s, _, _ in timed) * 1e3
            tok_s = sum(n for _, n, _ in timed) / sum(s for s, _, _ in timed)
            if tokenizer.CALLS < 1 or transforms.NATIVE_FALLBACK:
                fail(f'{leg}: {tokenizer.CALLS} songs tokenized natively '
                     f'(fallback: {transforms.NATIVE_FALLBACK})')
            results[leg] = {
                'native_tokenizer_calls': tokenizer.CALLS,
                'seconds': secs, 'steps': len(steps), 'state_step': state.step,
                'optimizer_count': state.optimizer.count,
                'target_lengths': [L for _, _, L in steps],
                'ms_per_step_median': ms, 'target_tokens_per_s': tok_s,
                'launches': launches,
                'long_attentions': {'forward': log.fwd, 'backward': log.bwd}}
            print(f'{leg}: {len(steps)} steps in {secs:.1f} s (corpus '
                  f'tokenization and validation included), target lengths '
                  f'{[L for _, _, L in steps]}, median {ms:.2f} ms/step, '
                  f'{tok_s:.0f} target tokens/s; launches {launches} for '
                  f'{log.fwd} long attentions forward, {log.bwd} backward; '
                  f'{tokenizer.CALLS} songs tokenized natively', flush=True)
            if launches[ta.KERNEL] != log.fwd or \
                    launches[ta.KERNEL_BWD] != log.bwd or log.bwd < 1 or \
                    tiers.tiers != ['none'] * len(tiers.tiers):
                fail(f'{leg}: kernel launches {launches} for {log.fwd} '
                     f'forward and {log.bwd} backward long attentions')
            if not any(L >= 512 for _, _, L in steps) or \
                    not any(L < 512 for _, _, L in steps):
                fail(f'{leg}: the target lengths {[L for _, _, L in steps]} '
                     f'do not cover both attention routes')
        first, resumed = results['first'], results['resumed']
        if first['state_step'] != 8 or resumed['state_step'] != 12 or \
                resumed['optimizer_count'] != 12 or resumed['steps'] != 4:
            fail(f'steps: first {first["state_step"]}, resumed '
                 f'{resumed["state_step"]} after {resumed["steps"]} steps '
                 f'(optimizer count {resumed["optimizer_count"]})')
        records = [json.loads(ln) for ln in open(
            os.path.join(out_dir, 'logs', 'metrics.jsonl'))]
        train_losses = [r['train_loss'] for r in records
                        if 'train_loss' in r]
        val_losses = [r['val_loss'] for r in records if 'val_loss' in r]
        if len(train_losses) != 12 or len(val_losses) != 3 or not all(
                np.isfinite(train_losses + val_losses)):
            fail(f'losses: train {train_losses}, val {val_losses}')
        # the eval hook after each of the 3 validations
        val_f1 = [{k: r[k] for k in ('val_f1_flat', 'val_f1_midi_class',
                                     'val_f1_full')}
                  for r in records if 'val_f1_flat' in r]
        print(f'eval hook scores: {val_f1}')
        if len(val_f1) != 3 or not all(0 <= v <= 1 for r in val_f1
                                       for v in r.values()):
            fail(f'eval hook: {val_f1} in the metrics')
        results['val_f1'] = val_f1
        # save_top_k 1: each leg keeps its own best (a resumed run prunes
        # only the top-k files it wrote)
        ckpts = sorted(os.listdir(os.path.join(out_dir, 'checkpoints')))
        topk = [c for c in ckpts if c.startswith('epoch=')]
        if 'last' not in ckpts or 'final' not in ckpts or len(topk) != 2:
            fail(f'checkpoints: {ckpts}')
        for name in ['last', 'final'] + topk:
            blob = load_checkpoint(os.path.join(out_dir, 'checkpoints', name))
            model = builders.build_model(load_config(
                os.path.join(REPO, 'configs'), 'config_slakh_segmem',
                TRAIN_ARGS[1:]))
            builders.load_weights(os.path.join(out_dir, 'checkpoints', name),
                                  model, strict=True)
            if not isinstance(model, MT3) or 'opt_state' not in blob:
                fail(f'checkpoint {name} did not load')
        print(f'train losses {[round(x, 4) for x in train_losses]}; val '
              f'losses {[round(x, 4) for x in val_losses]}; checkpoints '
              f'{ckpts}')
        results.update({'train_losses': train_losses,
                        'val_losses': val_losses, 'checkpoints': ckpts})
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return results



# ---- the data axis on the one card (multi_card) ----

# ---- the overfit system test on the card (tests/test_system_overfit.py) --

OVERFIT_DIR = os.path.join(REPO, '.chip_smoke_overfit')
# tests/test_system_overfit.py's model, run and bars, unchanged: fp32, no
# dropout; AdamW at lr 2e-3, no schedule, no weight decay; the loop stops
# at a loss below OVERFIT_STOP_LOSS or after OVERFIT_MAX_STEPS steps, and
# the run must end below OVERFIT_LOSS; then the handler (max_length 256,
# batch_size 4) transcribes each song's trained span, OVERFIT_SPAN
# samples (3 x 256-frame windows), and the mean onset F1 must exceed
# OVERFIT_F1
OVERFIT_DIMS = dict(d_model=96, d_kv=24, d_ff=192, num_heads=4,
                    num_encoder_layers=2, num_decoder_layers=2,
                    dropout_rate=0.0)
OVERFIT_SONGS = ('Track00001', 'Track00002')
OVERFIT_SPAN = 768 * 128
OVERFIT_MAX_STEPS = 400
OVERFIT_STOP_LOSS = 0.02
OVERFIT_LOSS = 0.2
OVERFIT_F1 = 0.8
OVERFIT_MAX_LENGTH = 256
OVERFIT_BATCH = 4


def tonal_song(rng, duration=6.25, sr=16000, n_notes=9):
    """(audio, notes) where each note is a sine at its MIDI pitch
    (tests/test_system_overfit.py:31-52). Notes start at 0.5-5 s and last
    0.4 s, inside the first 3 x 256-frame windows: the dataset's splitter
    drops the trailing partial window, so that region is never trained."""
    import numpy as np
    audio = np.zeros(int(duration * sr), np.float32)
    notes = []
    starts = np.sort(rng.choice(np.arange(1, 11), size=n_notes,
                                replace=False)) / 2.0
    for s in starts:
        pitch = int(rng.integers(55, 76))
        length = 0.4
        f = 440.0 * 2 ** ((pitch - 69) / 12)
        i0, i1 = int(s * sr), int((s + length) * sr)
        seg_t = np.arange(i1 - i0) / sr
        env = np.minimum(1, np.minimum(seg_t / 0.02, (length - seg_t) / 0.05))
        audio[i0:i1] += (0.5 * np.sin(2 * np.pi * f * seg_t) * env).astype(
            np.float32)
        notes.append((s, s + length, pitch))
    return audio, notes


def overfit_corpus(root):
    """The two songs of tests/test_system_overfit.py:55-74 (seed 0), as
    Slakh lays a song out and written by the port: mix_16k.wav, MIDI/S00.mid
    (program 0), inst_names.json and the merged all_src_v2.mid
    (scripts/merge_slakh_midi.py). Returns {song: notes}."""
    import numpy as np

    from mr_mt3_tpu_torch.audio import write_wav
    from mr_mt3_tpu_torch.scripts.merge_slakh_midi import merge_song_midis
    rng = np.random.default_rng(0)
    songs = {}
    for song in OVERFIT_SONGS:
        d = os.path.join(root, song)
        os.makedirs(os.path.join(d, 'MIDI'))
        audio, notes = tonal_song(rng)
        write_wav(os.path.join(d, 'mix_16k.wav'), audio, 16000)
        write_song(os.path.join(d, 'MIDI', 'S00.mid'), notes)
        with open(os.path.join(d, 'inst_names.json'), 'w') as f:
            json.dump({'S00': 'Acoustic Piano'}, f)
        merge_song_midis(d)
        songs[song] = notes
    return songs


def overfit_train(torch, root, device):
    """tests/test_system_overfit.py:78-101 in the port: the six fixed
    segments of SlakhDataset(root) (deterministic, 3 rows a song, 256
    frames and 256 labels a row) in one collate_batch, the OVERFIT_DIMS
    model (init_params, seed 0) on `device`, and the trainer's train step
    until the loss drops below OVERFIT_STOP_LOSS or OVERFIT_MAX_STEPS steps
    are taken. Returns (model in eval mode, the losses)."""
    from mr_mt3_tpu_torch.data import SlakhDataset, collate_batch
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.train.optim import make_optimizer
    from mr_mt3_tpu_torch.train.trainer import (
        create_train_state,
        make_train_step,
    )
    from mr_mt3_tpu_torch.utils.builders import init_params
    ds = SlakhDataset(root, shuffle=False, is_deterministic=True,
                      is_randomize_tokens=False, num_rows_per_batch=3,
                      split_frame_length=256, event_length=256)
    batch = collate_batch([ds[0], ds[1]])
    model = init_params(MT3(MT3Config(**OVERFIT_DIMS)), 0).to(device)
    state = create_train_state(model, make_optimizer(
        2e-3, use_schedule=False, weight_decay=0.0))
    step = make_train_step()
    losses = []
    for _ in range(OVERFIT_MAX_STEPS):
        losses.append(float(step(state, batch, None)['loss']))
        if losses[-1] < OVERFIT_STOP_LOSS:
            break
    return model.eval(), losses


def overfit_transcribe(handler, root, out):
    """Each song's trained span through handler.inference, written to
    <out>/<song>/mix.mid (the layout scripts/instrument_leakage.py reads):
    {song: onset F1} against its all_src_v2.mid (program_aware_note_scores,
    'flat')."""
    from mr_mt3_tpu_torch.audio import read_wav
    from mr_mt3_tpu_torch.eval import program_aware_note_scores
    scores = {}
    for song in OVERFIT_SONGS:
        audio, _ = read_wav(os.path.join(root, song, 'mix_16k.wav'))
        path = os.path.join(out, song, 'mix.mid')
        os.makedirs(os.path.dirname(path), exist_ok=True)
        ns = handler.inference(audio[:OVERFIT_SPAN], outpath=path)
        if ns is None or not ns.notes:
            fail(f'overfit: no notes transcribed for {song}')
        scores[song] = program_aware_note_scores(
            os.path.join(root, song, 'all_src_v2.mid'), path,
            'flat')['Onset F1']
    return scores


def overfit_on_card(torch):
    """tests/test_system_overfit.py on the card at its size (fp32): train
    with the port's train step until the loss is below OVERFIT_LOSS within
    OVERFIT_MAX_STEPS steps, transcribe the trained spans at quantize
    'none' with mean onset F1 > OVERFIT_F1 and one log-mel launch a
    _compute_mel call; then on these weights (a) the same with the
    frontend on compute_logmel (both F1s must pass, the tokens that
    differ counted), (b) the probe ladder from the serving default
    (its tier kept, the F1 there, the window launches against the windows
    run) and (c) scripts/instrument_leakage.py on the transcriptions."""
    phase('overfit on the card (tests/test_system_overfit.py, fp32)')
    import shutil

    import numpy as np

    from mr_mt3_tpu_torch import serve
    from mr_mt3_tpu_torch.audio import compute_logmel
    from mr_mt3_tpu_torch.infer import InferenceHandler
    from mr_mt3_tpu_torch.infer import handler as handler_module
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    from mr_mt3_tpu_torch.ops import mel_kernel as mk
    shutil.rmtree(OVERFIT_DIR, ignore_errors=True)
    songs = os.path.join(OVERFIT_DIR, 'songs')
    out = {}
    try:
        overfit_corpus(songs)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        model, losses = overfit_train(torch, songs, torch.device('cuda'))
        secs = time.monotonic() - t0
        print(f'trained {len(losses)} steps in {secs:.1f} s '
              f'({1e3 * secs / len(losses):.1f} ms a step): loss '
              f'{losses[0]:.4f} -> {losses[-1]:.4f}')
        if losses[-1] >= OVERFIT_LOSS:
            fail(f'overfit: final loss {losses[-1]} after {len(losses)} '
                 f'steps')
        out['train'] = {'steps': len(losses), 'first_loss': losses[0],
                        'final_loss': losses[-1], 'seconds': secs}

        def transcribe(label, **kw):
            handler = InferenceHandler(model=model,
                                       max_length=OVERFIT_MAX_LENGTH,
                                       batch_size=OVERFIT_BATCH, **kw)
            tokens = TokenLog()
            try:
                scores = overfit_transcribe(
                    handler, songs, os.path.join(OVERFIT_DIR, label))
            finally:
                tokens.close()
            f1 = float(np.mean(list(scores.values())))
            print(f'{label}: onset F1 {scores}, mean {f1:.4f}')
            if f1 <= OVERFIT_F1:
                fail(f'overfit, {label}: mean onset F1 {f1} <= '
                     f'{OVERFIT_F1} ({scores})')
            return handler, f1, [t for _, t in tokens.calls]

        mk.LAUNCHES[mk.KERNEL] = 0
        mels = MelLog()
        try:
            _, f1_kernel, kernel_tokens = transcribe('kernel_logmel')
        finally:
            mels.close()
        mels.check(mk.LAUNCHES[mk.KERNEL], 'the overfit transcription')
        out['none'] = {'mean_f1': f1_kernel,
                       'logmel_launches': mk.LAUNCHES[mk.KERNEL],
                       'compute_mel_calls': mels.calls}

        # (a) the frontend on its plain version, compute_logmel
        plain = Patches()
        plain.patch(handler_module, 'logmel',
                    lambda real, x, config: compute_logmel(x, config))
        mk.LAUNCHES[mk.KERNEL] = 0
        try:
            _, f1_plain, plain_tokens = transcribe('plain_logmel')
        finally:
            plain.close()
        if mk.LAUNCHES[mk.KERNEL]:
            fail('the plain-frontend leg launched the log-mel kernel')
        differ = sum(int((a != b).sum())
                     for a, b in zip(kernel_tokens, plain_tokens))
        total = sum(a.size for a in kernel_tokens)
        print(f'(a) kernel log-mel F1 {f1_kernel:.4f}, compute_logmel F1 '
              f'{f1_plain:.4f}; {differ} of {total} tokens differ')
        out['plain_logmel'] = {'mean_f1': f1_plain, 'tokens_differ': differ,
                               'tokens': total}

        # (b) the probe ladder from the serving default
        for t in TIERS:
            fd.LAUNCHES[t] = 0
        decodes, walk = DecodeLog(), ProbeWalk()
        try:
            handler = InferenceHandler(
                model=model, max_length=OVERFIT_MAX_LENGTH,
                batch_size=OVERFIT_BATCH,
                quantize=serve.default_quantize(torch.device('cuda')))
            info = serve.prepare_handler(handler)
            walk.print()
            scores = overfit_transcribe(handler, songs,
                                        os.path.join(OVERFIT_DIR, 'ladder'))
        finally:
            walk.close()
            decodes.close()
        f1_ladder = float(np.mean(list(scores.values())))
        windows = {t: decodes.windows(t)[1] for t in TIERS}
        print(f'(b) the ladder from fused_int4 keeps {handler.quantize!r} '
              f'(demotions {info.get("demotions", [])}); onset F1 there '
              f'{scores}, mean {f1_ladder:.4f}; window launches '
              f'{dict(fd.LAUNCHES)} for windows run {windows}')
        check_launches(fd.LAUNCHES, decodes, TIERS)
        out['ladder'] = {'tier': handler.quantize, 'mean_f1': f1_ladder,
                         'demotions': info.get('demotions', []),
                         'window_launches': dict(fd.LAUNCHES),
                         'windows': windows}

        # (c) the instrument-leakage analysis of the transcriptions
        print('(c) ', end='')
        out['leakage'] = leakage(os.path.join(OVERFIT_DIR, 'kernel_logmel'),
                                 songs)
    finally:
        shutil.rmtree(OVERFIT_DIR, ignore_errors=True)
    return out


# ---- converted T5X weights, served at full width --------------------------

T5X_DIR = os.path.join(REPO, '.chip_smoke_t5x')
# the official MT3 checkpoint's shapes (MT3Config())
T5X_DIMS = dict(d_model=512, heads=6, d_kv=64, d_ff=1024, vocab=1536,
                mel_bins=512, layers=(8, 8))
T5X_CLIP_SECONDS = 4.0


def t5x_tree(seed, d_model, heads, d_kv, d_ff, vocab, mel_bins, layers):
    """A pickled T5X state dict's tree as the official MT3 checkpoint lays
    it out (the keys tests/test_scripts_tools.py:127-187 fabricates, a
    state/ subtree beside target/), seeded: kernels N(0, 1/fan_in) like
    init_params, norm scales 1 + N(0, 0.01)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    inner = heads * d_kv
    tree = {}

    def put(path, shape, kind='kernel'):
        node, parts = tree, path.split('/')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        value = rng.standard_normal(shape)
        if kind == 'norm':
            value = 1 + 0.1 * value
        else:
            # T5X kernels are (in, out); the embedding's fan-in is d_model
            value /= np.sqrt(shape[1] if kind == 'embedding' else shape[0])
        node[parts[-1]] = value.astype(np.float32)

    attn = [('query', (d_model, inner)), ('key', (d_model, inner)),
            ('value', (d_model, inner)), ('out', (inner, d_model))]
    mlp = [('wi_0', (d_model, d_ff)), ('wi_1', (d_model, d_ff)),
           ('wo', (d_ff, d_model))]
    n_enc, n_dec = layers
    for i in range(n_enc):
        lyr = f'target/encoder/layers_{i}'
        for proj, shape in attn:
            put(f'{lyr}/attention/{proj}/kernel', shape)
        for w, shape in mlp:
            put(f'{lyr}/mlp/{w}/kernel', shape)
        put(f'{lyr}/pre_attention_layer_norm/scale', (d_model,), 'norm')
        put(f'{lyr}/pre_mlp_layer_norm/scale', (d_model,), 'norm')
    for i in range(n_dec):
        lyr = f'target/decoder/layers_{i}'
        for proj, shape in attn:
            put(f'{lyr}/self_attention/{proj}/kernel', shape)
            put(f'{lyr}/encoder_decoder_attention/{proj}/kernel', shape)
        for w, shape in mlp:
            put(f'{lyr}/mlp/{w}/kernel', shape)
        for norm in ('pre_self_attention_layer_norm',
                     'pre_cross_attention_layer_norm', 'pre_mlp_layer_norm'):
            put(f'{lyr}/{norm}/scale', (d_model,), 'norm')
    put('target/encoder/encoder_norm/scale', (d_model,), 'norm')
    put('target/decoder/decoder_norm/scale', (d_model,), 'norm')
    put('target/encoder/continuous_inputs_projection/kernel',
        (mel_bins, d_model))
    put('target/decoder/token_embedder/embedding', (vocab, d_model),
        'embedding')
    put('target/decoder/logits_dense/kernel', (d_model, vocab))
    tree['state'] = {'param_states': {'step': np.zeros((), np.int32)}}
    return tree


# fp32 on the card (TF32 off) against the CPU, the same weights and inputs:
# the logits' largest difference over their largest |value|, held to
# training_parity's fp32 card-vs-CPU bound
CARD_CPU_LOGIT_REL = TRAIN_F32_LOSS_RTOL
CARD_CPU_LOGIT_LABELS = 256


def converted_t5x(torch):
    """A seeded T5X tree at the official MT3 shapes, pickled and converted
    by `python -m mr_mt3_tpu_torch.scripts.convert_weight`; the .pth holds
    exactly MT3(MT3Config())'s keys and shapes, and
    InferenceHandler(weight_path=...) serves it: a seeded clip at
    fused_int4 (window launches equal to the windows the decode needed)
    and at none, log-mel launches equal to the _compute_mel calls; the
    card's fp32 logits within CARD_CPU_LOGIT_REL of the same file's on the
    CPU."""
    phase('converted T5X checkpoint served (full width)')
    import pickle
    import shutil

    from mr_mt3_tpu_torch.audio import (
        SpectrogramConfig,
        compute_logmel,
        normalize_logmel,
    )
    from mr_mt3_tpu_torch.infer import InferenceHandler
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    from mr_mt3_tpu_torch.ops import mel_kernel as mk
    from mr_mt3_tpu_torch.utils.builders import load_weights
    from mr_mt3_tpu_torch.utils.checkpoint_import import (
        load_torch_checkpoint,
    )
    shutil.rmtree(T5X_DIR, ignore_errors=True)
    os.makedirs(T5X_DIR)
    pk = os.path.join(T5X_DIR, 't5x_state.pk')
    pth = os.path.join(T5X_DIR, 'mt3_converted.pth')
    out = {}
    try:
        t0 = time.monotonic()
        with open(pk, 'wb') as f:
            pickle.dump(t5x_tree(0, **T5X_DIMS), f)
        run = subprocess.run(
            [sys.executable, '-m', 'mr_mt3_tpu_torch.scripts.convert_weight',
             pk, pth], cwd=REPO, capture_output=True, text=True, timeout=300)
        if run.returncode != 0:
            fail(f'convert_weight exited {run.returncode}: '
                 f'{run.stderr[-2000:]}')
        out['convert_seconds'] = time.monotonic() - t0
        state_dict = load_torch_checkpoint(pth)
        reference = MT3(MT3Config()).state_dict()
        missing = sorted(set(reference) - set(state_dict))
        unexpected = sorted(set(state_dict) - set(reference))
        mismatched = [k for k in reference if k in state_dict
                      and state_dict[k].shape != reference[k].shape]
        n_params = sum(v.numel() for v in reference.values())
        print(f'converted in {out["convert_seconds"]:.1f} s: '
              f'{len(state_dict)} keys, {len(missing)} missing, '
              f'{len(unexpected)} unexpected, {len(mismatched)} of another '
              f'shape; {n_params} parameters')
        if missing or unexpected or mismatched:
            fail(f'converted checkpoint: missing {missing[:5]}, unexpected '
                 f'{unexpected[:5]}, shapes {mismatched[:5]}')
        out['keys'] = len(state_dict)
        out['parameters'] = n_params
        audio = clip(T5X_CLIP_SECONDS, seed=16)
        for tier in ('fused_int4', 'none'):
            for t in TIERS:
                fd.LAUNCHES[t] = 0
            mk.LAUNCHES[mk.KERNEL] = 0
            decodes, mels = DecodeLog(), MelLog()
            try:
                handler = InferenceHandler(
                    weight_path=pth, quantize=tier,
                    max_length=MAIN_PATH_MAX_LENGTH)
                loaded = handler.model.state_dict()
                n_loaded = sum(p.numel() for p in
                               handler.model.parameters())
                if n_loaded != n_params or not all(
                        torch.equal(loaded[k].cpu(), state_dict[k])
                        for k in reference):
                    fail(f'{tier}: the handler holds {n_loaded} parameters '
                         f'unequal to the converted file\'s {n_params}')
                t0 = time.monotonic()
                ns = handler.transcribe(audio)
                torch.cuda.synchronize()
                secs = time.monotonic() - t0
            finally:
                mels.close()
                decodes.close()
            launches = dict(fd.LAUNCHES)
            launches[mk.KERNEL] = mk.LAUNCHES[mk.KERNEL]
            calls, windows = (decodes.windows(tier) if tier in TIERS
                              else (len(decodes.calls), 0))
            print(f'{tier}: {len(ns.notes)} notes in {secs:.2f} s, '
                  f'launches {launches}, {windows} windows over {calls} '
                  f'decode calls')
            mels.check(launches[mk.KERNEL], f'the converted model at {tier}')
            want = {t: windows if t == tier else 0 for t in TIERS}
            if {t: launches[t] for t in TIERS} != want or \
                    (tier in TIERS and windows < 1):
                fail(f'{tier}: window launches {launches} for the windows '
                     f'{want} the decode needed')
            out[tier] = {'seconds': secs, 'notes': len(ns.notes),
                         'launches': launches, 'windows': windows,
                         'compute_mel_calls': mels.calls}
        # the 'none' handler's fp32 model against the same file on the CPU
        cpu_model = load_weights(pth, MT3(MT3Config())).eval()
        mel = normalize_logmel(compute_logmel(
            torch.from_numpy(audio[None, :256 * 128].copy()),
            SpectrogramConfig()))
        ids = torch.randint(3, 1391, (1, CARD_CPU_LOGIT_LABELS),
                            generator=torch.Generator().manual_seed(16))
        with torch.no_grad():
            card = handler.model(mel.cuda(), decoder_input_ids=ids.cuda())
            host = cpu_model(mel, decoder_input_ids=ids)
        rel = float((card.cpu() - host).abs().max() / host.abs().max())
        print(f'fp32 logits, card (TF32 off) vs CPU: largest difference '
              f'{rel:.3g} of the largest |logit| (bound '
              f'{CARD_CPU_LOGIT_REL})')
        if not rel <= CARD_CPU_LOGIT_REL:
            fail(f'converted model: card logits {rel} apart from the CPU\'s')
        out['card_vs_cpu_logit_rel'] = rel
    finally:
        shutil.rmtree(T5X_DIR, ignore_errors=True)
    return out


# ---- the adversarial gradient at full width in bf16 -----------------------

# models/adversarial.py on vanilla MT3 (MT3Config(), adversarial_weights)
# at bf16, where the decoder's 1024-label attentions take the fused kernels
ADV_ROWS, ADV_FRAMES, ADV_LABELS = 4, 256, 1024
# FGSM at fgsm's default epsilon; PGD at tests/test_scripts_tools.py:334's
# steps, whose third (3 x 0.02 > 0.05) the projection clips
ADV_EPSILON = 0.1
ADV_PGD = dict(epsilon=0.05, alpha=0.02, num_iter=3)


def adversarial_weights(cfg, seed=0):
    """init_params' seed-`seed` weights with every query projection
    scaled by d_kv^-1/2, the scale T5's initialization gives q (std
    (d_model d_kv)^-1/2). The attention is unscaled: with q at init_params'
    N(0, 1/fan_in) its logits have a standard deviation of ~sqrt(d_kv), the
    softmax saturates, and at 8+8 layers the input gradient is chaotic
    (bf16 rounding alone leaves it uncorrelated with fp32's, so a sign
    agreement would read chance)."""
    from mr_mt3_tpu_torch.models import MT3
    from mr_mt3_tpu_torch.utils.builders import init_params
    weights = init_params(MT3(cfg), seed).state_dict()
    for key in weights:
        if key.endswith('.q.weight'):
            weights[key] = weights[key] / math.sqrt(cfg.d_kv)
    return weights


def adversarial_attentions(cfg, length):
    """(forward, backward) fused attention launches of one input gradient
    of the vanilla model at `length` labels (models/mt3.py's rule: Lq >=
    512, Lq % 8 == 0): forward, each decoder layer's self- and
    cross-attention; backward, all of them but the first layer's
    self-attention, which reads only the token embeddings, so no gradient
    to the mel flows through it. The encoder's 256 frames stay on einsum."""
    from mr_mt3_tpu_torch.models import mt3
    if length < mt3._FUSED_MIN_LEN or length % 8:
        return 0, 0
    n = cfg.num_decoder_layers
    return 2 * n, 2 * n - 1


# "No worse than bf16 einsum" read through sampling noise: the kernel
# route's input gradient may disagree in sign with the fp32 route's on
# more elements than the bf16 einsum route's by at most ADV_SIGN_SIGMAS
# standard deviations of the difference of two such counts, sqrt(d_kernel
# + d_einsum) for two routes that draw their disagreements independently;
# the control must exceed that. (The first run on an NVIDIA H100 80GB
# HBM3 at 700 W read shares 0.993986 and 0.994030, ~3,153 and ~3,130
# disagreements of 524,288, for kernel and einsum: a strict comparison is
# a coin flip between two routes of equal noise. The control read
# 0.679941, ~167,803.)
ADV_SIGN_SIGMAS = 3.0


def sign_disagreements(torch, grad, ref):
    """Elements where `ref` is not 0 whose sign `grad` does not match:
    (count, elements compared)."""
    live = ref != 0
    apart = (torch.sign(grad) != torch.sign(ref)) & live
    return int(apart.sum()), int(live.sum())


def within_einsum_noise(disagree, einsum):
    """Whether `disagree` sign disagreements are no more than the bf16
    einsum route's `einsum`, up to ADV_SIGN_SIGMAS of sampling noise."""
    return disagree <= einsum + ADV_SIGN_SIGMAS * math.sqrt(disagree + einsum)


class NegatedHead(Patches):
    """The control: the attention backward's dq, dk and dv of head 0
    negated (the CUDA kernel's on the card, its plain version's on the
    CPU), a wrong gradient the sign-agreement reading must catch."""

    def __init__(self):
        from mr_mt3_tpu_torch.ops import train_attention as ta
        super().__init__()

        def negated(real, *args):
            grads = []
            for g in real(*args):            # (B, L, H, D)
                g = g.clone()
                g[:, :, 0] = -g[:, :, 0]
                grads.append(g)
            return tuple(grads)
        self.patch(ta, 'fused_attention_backward_cuda', negated)
        self.patch(ta, 'fused_attention_backward_reference', negated)


def adversarial_gradient_readings(torch, make_model, mel, labels):
    """The input gradient's sign disagreements with the fp32 einsum
    route's, for the bf16 kernel route, the bf16 einsum route (the floor
    the kernel must reach, within_einsum_noise) and the kernel route under
    NegatedHead (which must miss it): {'n', 'disagree', 'share'}.
    make_model(**cfg) gives the model with the same weights."""
    from mr_mt3_tpu_torch.models import adversarial
    ref = adversarial.input_gradient(make_model(), mel, labels)
    kernel = make_model(dtype='bfloat16')
    grads = {'kernel': adversarial.input_gradient(kernel, mel, labels),
             'einsum': adversarial.input_gradient(
                 make_model(dtype='bfloat16', attention_kernel='einsum'),
                 mel, labels)}
    control = NegatedHead()
    try:
        grads['control'] = adversarial.input_gradient(kernel, mel, labels)
    finally:
        control.close()
    counts = {k: sign_disagreements(torch, g.float(), ref.float())
              for k, g in grads.items()}
    n = counts['kernel'][1]
    disagree = {k: c for k, (c, _) in counts.items()}
    return {'n': n, 'disagree': disagree,
            'share': {k: 1 - c / n for k, c in disagree.items()}}


def adversarial_gradient(torch):
    """fgsm and pgd_linf (models/adversarial.py) on vanilla MT3 at full
    width in bf16, B = ADV_ROWS mels of ADV_FRAMES frames and labels of
    ADV_LABELS tokens: the fused forward and backward launches equal to
    the long attentions the gradients ran (adversarial_attentions), FGSM
    values in {0, +-epsilon}, PGD inside the epsilon ball, the loss at
    x + delta not below the loss at x on the kernel route; the input
    gradient's sign agreement with the fp32 einsum route's no worse on
    the kernel route than on the bf16 einsum route (within_einsum_noise),
    and the negated-head control caught by the same reading."""
    phase('adversarial gradient (full width, bf16)')
    from mr_mt3_tpu_torch.models import MT3, MT3Config, adversarial
    from mr_mt3_tpu_torch.models import mt3
    from mr_mt3_tpu_torch.ops import train_attention as ta
    from mr_mt3_tpu_torch.utils.builders import init_params
    dev = torch.device('cuda')
    weights = adversarial_weights(MT3Config())

    def make_model(**kw):
        model = MT3(MT3Config(**kw))
        model.load_state_dict(weights)
        return model.to(dev).eval()
    kernel = make_model(dtype='bfloat16')
    if mt3.resolve_attention_kernel(kernel.cfg, dev) != 'fused':
        fail('the bf16 model does not take the fused attention route')
    gen = torch.Generator().manual_seed(0)
    mel = torch.randn((ADV_ROWS, ADV_FRAMES, kernel.cfg.mel_bins),
                      generator=gen).to(dev)
    labels = torch.randint(3, 1391, (ADV_ROWS, ADV_LABELS), generator=gen)
    labels[:, -1] = kernel.cfg.eos_token_id
    labels = labels.to(dev)
    fwd, bwd = adversarial_attentions(kernel.cfg, ADV_LABELS)
    grads = 1 + ADV_PGD['num_iter']
    for k in ta.LAUNCHES:
        ta.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    delta = adversarial.fgsm(kernel, mel, labels, epsilon=ADV_EPSILON)
    pgd = adversarial.pgd_linf(kernel, mel, labels, **ADV_PGD)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    launches = dict(ta.LAUNCHES)
    want = {ta.KERNEL: fwd * grads, ta.KERNEL_BWD: bwd * grads}
    print(f'fgsm + pgd_linf({ADV_PGD["num_iter"]} steps): {grads} input '
          f'gradients in {secs:.2f} s; launches {launches} for the long '
          f'attentions run {want}')
    if launches != want:
        fail(f'adversarial: launches {launches}, long attentions {want}')
    vals = delta.abs()
    on_grid = bool(((vals < 1e-6) | ((vals - ADV_EPSILON).abs() < 1e-6))
                   .all())
    pgd_max = float(pgd.abs().max())
    with torch.no_grad():
        base = float(adversarial.input_loss(kernel, mel, labels))
        at_fgsm = float(adversarial.input_loss(kernel, mel + delta, labels))
        at_pgd = float(adversarial.input_loss(kernel, mel + pgd, labels))
    print(f'FGSM values in {{0, +-{ADV_EPSILON}}}: {on_grid}; PGD largest '
          f'|delta| {pgd_max:.6g} (the ball {ADV_PGD["epsilon"]}); loss '
          f'{base:.5f}, at x + FGSM '
          f'{at_fgsm:.5f}, at x + PGD {at_pgd:.5f}')
    if not on_grid or abs(pgd_max - ADV_PGD['epsilon']) > 1e-6 or \
            at_fgsm < base or at_pgd < base:
        fail('adversarial: perturbations off their grid or ball, or a '
             'loss below the clean one')
    signs = adversarial_gradient_readings(torch, make_model, mel, labels)
    d = signs['disagree']
    print(f'input-gradient sign agreement with fp32 einsum over '
          f'{signs["n"]} elements: kernel {signs["share"]["kernel"]:.6f} '
          f'({d["kernel"]} apart), bf16 einsum '
          f'{signs["share"]["einsum"]:.6f} ({d["einsum"]}), negated-head '
          f'control {signs["share"]["control"]:.6f} ({d["control"]})')
    if not within_einsum_noise(d['kernel'], d['einsum']):
        fail(f'adversarial: the kernel route disagrees with fp32 on more '
             f'signs than bf16 einsum beyond its noise ({signs})')
    if within_einsum_noise(d['control'], d['einsum']):
        fail(f'adversarial: the reading did not catch the control '
             f'({signs})')
    # a reading, not a check: bf16 einsum at init_params' own weights (q
    # unscaled), the chaotic gradient adversarial_weights avoids
    raw = init_params(MT3(MT3Config()), 0).state_dict()
    unscaled = []
    for kw in ({}, {'dtype': 'bfloat16', 'attention_kernel': 'einsum'}):
        model = MT3(MT3Config(**kw))
        model.load_state_dict(raw)
        unscaled.append(adversarial.input_gradient(model.to(dev).eval(),
                                                   mel, labels).float())
    apart, n = sign_disagreements(torch, unscaled[1], unscaled[0])
    cosine = float(torch.nn.functional.cosine_similarity(
        unscaled[1].flatten(), unscaled[0].flatten(), dim=0))
    signs['unscaled_q_einsum'] = {'share': 1 - apart / n, 'cosine': cosine}
    print(f'at init_params\' weights (q unscaled): bf16 einsum sign '
          f'agreement {1 - apart / n:.6f}, cosine with fp32 {cosine:.4f}')
    return {'launches': launches, 'long_attentions': want,
            'gradients': grads, 'seconds': secs, 'loss': base,
            'loss_fgsm': at_fgsm, 'loss_pgd': at_pgd, 'pgd_max': pgd_max,
            'sign_agreement': signs}


# ---- utils/profiling.py and the Orbax reader on the card -----------------

PROFILING_DIR = os.path.join(REPO, 'chiprun_out', 'profiling_trace')
# logmel.cu calls a timed run makes (B=64: ~0.42 ms each on an NVIDIA
# H100 80GB HBM3 at 700 W), so the host's launches are a small part of a
# wall time that waits for the card
PROFILING_CALLS = 10
PROFILING_RUNS = 10
# benchmark's and Timer's best wall time over the CUDA events' median of
# the same calls: the host's launches and the synchronize add to the wall
# time, the events see only the queue
PROFILING_FACTOR = 1.5


def profiling_check(torch):
    """utils/profiling.py on the card: trace() around one logmel launch
    writes a Chrome trace naming logmel_kernel; benchmark() and Timer on
    PROFILING_CALLS launches agree with CUDA-event timing of the same calls
    within PROFILING_FACTOR."""
    phase('profiling (utils/profiling.py)')
    from mr_mt3_tpu_torch.audio import SpectrogramConfig
    from mr_mt3_tpu_torch.ops import mel_kernel as mk
    from mr_mt3_tpu_torch.utils import profiling
    cfg = SpectrogramConfig()
    x = torch.from_numpy(logmel_inputs('tone', 64)).cuda()
    mk.logmel(x, cfg)
    torch.cuda.synchronize()
    with profiling.trace(PROFILING_DIR):
        mk.logmel(x, cfg)
    path = os.path.join(PROFILING_DIR, 'trace.json')
    with open(path) as f:
        names = {e.get('name', '') for e in json.load(f)['traceEvents']}
    kernels = sorted(n for n in names if 'logmel_kernel' in n)
    print(f'trace: {os.path.relpath(path, REPO)}, {len(names)} event '
          f'names, logmel kernel events {kernels}')
    if not kernels:
        fail('profiling.trace: no logmel_kernel event in the trace')

    def calls():
        for _ in range(PROFILING_CALLS):
            out = mk.logmel(x, cfg)
        return out
    event_ms = time_ms(torch, calls, runs=PROFILING_RUNS)
    bench = profiling.benchmark(calls, warmup=2, iters=PROFILING_RUNS)
    timer = profiling.Timer()
    for _ in range(PROFILING_RUNS):
        with timer.measure(sync_value=x):
            calls()
    ratios = {'benchmark': 1e3 * bench['best_s'] / event_ms,
              'timer': 1e3 * timer.best / event_ms}
    print(f'{PROFILING_CALLS} logmel calls at B=64: CUDA events '
          f'{event_ms:.4f} ms, benchmark best {1e3 * bench["best_s"]:.4f} '
          f'mean {1e3 * bench["mean_s"]:.4f} ms, Timer best '
          f'{1e3 * timer.best:.4f} mean {1e3 * timer.mean:.4f} ms; ratios '
          f'{ratios}')
    if not all(1 / PROFILING_FACTOR <= r <= PROFILING_FACTOR
               for r in ratios.values()):
        fail(f'profiling: wall times {ratios} x the CUDA events\' '
             f'(factor {PROFILING_FACTOR})')
    return {'trace_kernels': kernels, 'event_ms': event_ms,
            'benchmark': bench, 'timer_best_s': timer.best,
            'timer_mean_s': timer.mean, 'ratios': ratios}


def orbax_without_tensorstore(torch):
    """The machine may lack tensorstore: then load_weights on an Orbax
    directory raises RuntimeError naming it (no fallback). Where it is
    installed, that is printed (the reader's parity is a CPU test)."""
    phase('orbax without tensorstore')
    import importlib.util
    import shutil
    import tempfile

    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.utils.builders import load_weights
    if importlib.util.find_spec('tensorstore') is not None:
        print('tensorstore is installed: Orbax directories are read')
        return {'tensorstore': True}
    d = tempfile.mkdtemp(dir=REPO, prefix='.chip_smoke_orbax')
    try:
        with open(os.path.join(d, '_METADATA'), 'w') as f:
            json.dump({'tree_metadata': {}, 'use_ocdbt': True,
                       'use_zarr3': False}, f)
        try:
            load_weights(d, MT3(MT3Config(**PARITY_DIMS)))
        except RuntimeError as e:
            if 'tensorstore' not in str(e):
                fail(f'load_weights raised {e!r}, naming no tensorstore')
            print(f'tensorstore is not installed: load_weights raised '
                  f'{e!r}')
            return {'tensorstore': False, 'error': str(e)}
        fail('load_weights read an Orbax directory without tensorstore')
    finally:
        shutil.rmtree(d, ignore_errors=True)


MULTI_DIR = os.path.join(REPO, '.chip_smoke_multi')
# the replicas' decodes: max_length cut to 64 (users' 1024) for time; the
# vanilla leg decodes 24 segments (calls of 16 rows, 8 a replica), the
# chained leg two songs of 8 chains of 8 segments (one a replica)
MULTI_MAX_LENGTH = 64
MULTI_VANILLA_SEGMENTS = 24
MULTI_CHAINS = 8
MULTI_TIERS = ('fused_int4', 'none')
# the rank legs: train steps per leg, the global batch (rows, target
# length, real tokens of each row: the two gloo ranks' slices hold
# unequal counts), and each child's time limit
MULTI_TRAIN_STEPS = 3
MULTI_BF16_STEPS = 2
MULTI_TRAIN_ROWS = (700, 520, 60)
MULTI_TRAIN_LENGTH = 1024
MULTI_RANK_TIMEOUT_S = 300
# the fp32 leg, two ranks against one process on the whole batch
# (fp32_readings): the first step's loss terms and reduced gradients
# within the card's fp32 sum-order bounds (TRAIN_PARITY_BOUNDS's
# f32_plain_vs_einsum, run T), grad_norm every step within the CPU tests'
# 1e-4 (tests/test_torch_train.py). The parameters after
# MULTI_TRAIN_STEPS steps: at most MULTI_APART_SHARE of them further apart
# than the CPU tests' 1e-5 (PARAM_ATOL), every one of those explained by
# its gradients (MULTI_NOISE_RATIO), and the parameters' difference at
# most MULTI_UPDATE_REL of the update. Run DX read 1.06e-4 of 48.3M (5095)
# apart, up to 1.08e-3 (about one step of the learning rate), and
# update_rel 7.2e-4, where the CPU tests' tiny model reads none; the first
# step's gradients read 1.1e-4 of their leaves' largest |value|, the CPU
# tests' 1e-4 set on a model of 145K parameters. MULTI_APART_SHARE and
# MULTI_UPDATE_REL are set from that one reading, about 10x and 7x above.
MULTI_PARAM_ATOL = 1e-5
MULTI_APART_SHARE = 1e-3
MULTI_UPDATE_REL = 5e-3
# AdamW is elementwise. At steps t >= 2, sqrt(v_hat) >= 0.577 |g1| (g1's
# weight in v_hat_3 is 1/3), and m_hat and v_hat are convex combinations
# of the steps' g and g^2, so a change dg (each step's largest) in an
# element's gradients moves its update by at most 2 dg / sqrt(v_hat) <=
# 3.46 dg / |g1|, and its parameter, over the learning rates 0 + 5e-4 +
# 1e-3 (MULTI_OPTIMIZER), by at most 5.2e-3 dg / |g1|. An element apart by
# more than MULTI_PARAM_ATOL therefore has |g1| < 520 dg; the ratio
# allows 2x for the clip's per-step scale (derived, not read).
MULTI_NOISE_RATIO = 1e3
MULTI_FP32_BOUNDS = {
    'loss_rel_first': TRAIN_PARITY_BOUNDS['f32_plain_vs_einsum']['loss_rel'],
    'loss_other_rel_first':
        TRAIN_PARITY_BOUNDS['f32_plain_vs_einsum']['loss_rel'],
    'grad_rel': TRAIN_PARITY_BOUNDS['f32_plain_vs_einsum']['grad_rel'],
    'grad_norm_rel':
        TRAIN_PARITY_BOUNDS['f32_plain_vs_einsum']['grad_norm_rel'],
    'grad_norm_rel_max': 1e-4,
    'params_apart_share': MULTI_APART_SHARE,
    'apart_unexplained': 0,
    'update_rel': MULTI_UPDATE_REL}
MULTI_OPTIMIZER = dict(lr=1e-3, warmup_steps=2, total_steps=10,
                       clip_norm=1.0)


class ReplicaLog(Patches):
    """Counts the window kernel's launches by the host thread that made
    them (a mesh's replicas decode on threads 'replica-<i>')."""

    def __init__(self):
        from mr_mt3_tpu_torch.ops import fused_decode as fd
        super().__init__()
        self.by_thread = {}
        lock = threading.Lock()

        def counting(real, *args, **kw):
            out = real(*args, **kw)
            name = threading.current_thread().name
            with lock:
                self.by_thread[name] = self.by_thread.get(name, 0) + 1
            return out
        self.patch(fd, 'fused_decode_window_cuda', counting)


def multi_train_batch(seed):
    """The rank legs' global batch: MULTI_TRAIN_ROWS real tokens a row
    (three rows: on two ranks, slices of 2 and 1 + a padding row), the
    previous segment's targets beside them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rows = len(MULTI_TRAIN_ROWS)
    targets = np.full((rows, MULTI_TRAIN_LENGTH), -100, np.int64)
    for i, real in enumerate(MULTI_TRAIN_ROWS):
        targets[i, :real] = rng.integers(3, 1391, real)
        targets[i, real] = 1
    targets[0, 5] = 1140          # an instrument token
    return {'audio': (rng.normal(size=(rows, 256 * 128)) * 0.1
                      ).astype(np.float32),
            'valid_frames': np.full((rows,), 256, np.int32),
            'targets': targets,
            'targets_prev': np.roll(targets, 1, axis=0)}


def multi_card_rank(leg, rank, world, store, backend=None, kind='cuda'):
    """One child of the multi_card phase (`python -c "import chip_smoke;
    chip_smoke.multi_card_rank(...)"`), its rank's results to
    MULTI_DIR/<leg>_rank<rank>.json (parameters beside them, .pt).

    leg 'nccl' (one rank): an fp32 DDP step on a one-rank NCCL group and
    the plain step, MULTI_TRAIN_STEPS each from the same weights: loss,
    grad_norm and every parameter equal bit for bit; the plain run's
    parameters kept for the gloo fp32 leg; get_scores on the parity model
    in one process. leg 'gloo' (two ranks sharing the card): the bf16
    segment-memory model's DDP steps (fused attention launches counted),
    the fp32 leg's parameters after MULTI_TRAIN_STEPS, get_scores on two
    ranks (log-mel launches counted against _compute_mel calls).
    backend and kind ('cpu') serve a rehearsal of the legs on the CPU
    with training_model and training_configs replaced."""
    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    from mr_mt3_tpu_torch import parallel
    from mr_mt3_tpu_torch.infer.scores import get_scores
    from mr_mt3_tpu_torch.ops import mel_kernel as mk
    from mr_mt3_tpu_torch.ops import train_attention as ta
    from mr_mt3_tpu_torch.train import optim, trainer

    parallel.init_multihost(backend=backend or leg,
                            init_method=f'file://{store}')
    out = {'rank': parallel.rank(), 'world': parallel.world(),
           'device': str(parallel.rank_device(kind))}
    cfg, f32 = training_configs()
    batches = [multi_train_batch(50 + i) for i in range(MULTI_TRAIN_STEPS)]

    def run(config, kernel, steps, ddp, loss_type='weighted', keep=None):
        """steps train steps (DDP on this rank's slices, or plain on the
        whole batch); keep: a path for every step's gradients (the reduced
        ones under DDP), as the optimizer receives them."""
        model = training_model(torch, config, kernel, seed=1)
        opt = optim.make_optimizer(**MULTI_OPTIMIZER)
        if ddp:
            state = trainer.create_train_state(model, opt)
        else:
            opt.init(list(model.parameters()))
            state = trainer.TrainState(model=model, optimizer=opt)
        kept = []
        if keep:
            real_step = opt.step
            names = [n for n, _ in model.named_parameters()]

            def keeping(grads):
                kept.append({n: g.detach().clone()
                             for n, g in zip(names, grads)})
                return real_step(grads)
            opt.step = keeping
        step = trainer.make_train_step(loss_type)
        metrics = []
        for batch in batches[:steps]:
            part = parallel.shard_batch(batch, world, rank) if ddp \
                else batch
            m = step(state, part, None)
            metrics.append({k: float(v) for k, v in m.items()})
        if keep:
            torch.save(kept, keep)
        return model, metrics

    t0 = time.monotonic()
    if leg == 'nccl':
        plain, plain_m = run(f32, 'auto', MULTI_TRAIN_STEPS, ddp=False,
                             keep=os.path.join(MULTI_DIR,
                                               'fp32_plain_grads.pt'))
        ddp, ddp_m = run(f32, 'auto', MULTI_TRAIN_STEPS, ddp=True)
        unequal = [k for k, v in plain.state_dict().items()
                   if not torch.equal(v, ddp.state_dict()[k])]
        out['fp32'] = {'plain': plain_m, 'ddp': ddp_m,
                       'metrics_equal': plain_m == ddp_m,
                       'params_unequal': unequal}
        torch.save(plain.state_dict(),
                   os.path.join(MULTI_DIR, 'fp32_plain.pt'))
        del plain, ddp
    else:
        ta.LAUNCHES[ta.KERNEL] = ta.LAUNCHES[ta.KERNEL_BWD] = 0
        log = TrainLog(torch, time_steps=False)
        try:
            model, bf16_m = run(cfg, 'auto', MULTI_BF16_STEPS, ddp=True,
                                loss_type='ce')
        finally:
            log.close()
        out['bf16'] = {'metrics': bf16_m,
                       'launches': {k: ta.LAUNCHES[k] for k in
                                    (ta.KERNEL, ta.KERNEL_BWD)},
                       'long_attentions': {'forward': log.fwd,
                                           'backward': log.bwd},
                       'param_sum': float(sum(
                           p.detach().double().sum()
                           for p in model.parameters()))}
        del model
        model, f32_m = run(f32, 'auto', MULTI_TRAIN_STEPS, ddp=True,
                           keep=os.path.join(MULTI_DIR, 'fp32_ddp_grads.pt')
                           if rank == 0 else None)
        out['fp32'] = {'ddp': f32_m}
        if rank == 0:
            torch.save(model.state_dict(),
                       os.path.join(MULTI_DIR, 'fp32_ddp.pt'))
        del model
    out['train_seconds'] = time.monotonic() - t0

    t0 = time.monotonic()
    model, _, max_length, _ = parity_model(torch, 'parity_vanilla.npz')
    gt = os.path.join(MULTI_DIR, 'parity')
    mk.LAUNCHES[mk.KERNEL] = 0
    mels = MelLog()
    try:
        scores = get_scores(
            model=model, eval_audio_dir=sorted(
                os.path.join(gt, d, 'mix_16k.wav') for d in os.listdir(gt)),
            exp_tag_name=os.path.join(MULTI_DIR, f'midis_{leg}'),
            ground_truth_midi_dir=gt, max_length=max_length,
            quantize='none', device=kind, verbose=False)
    finally:
        mels.close()
    out['eval'] = {'scores': scores, 'logmel': mk.LAUNCHES[mk.KERNEL],
                   'compute_mel_calls': mels.calls,
                   'seconds': time.monotonic() - t0}
    with open(os.path.join(MULTI_DIR, f'{leg}_rank{rank}.json'), 'w') as f:
        json.dump(out, f)
    parallel.shutdown()


def fp32_readings(torch, ddp_metrics, one_metrics, two='ddp',
                  label='fp32, two gloo ranks vs one process'):
    """The fp32 leg: two gloo ranks (or, two='tp', the model axis's 2x2
    grid) against one process on the whole batch, from the same weights. The first step computes one function in
    other sum orders (the loss split over the ranks, the gradients
    averaged), so its loss and its reduced gradients are held to the
    card's fp32 sum-order bounds (TRAIN_PARITY_BOUNDS['f32_plain_vs_
    einsum']); grad_norm every step to the CPU tests' 1e-4. After
    MULTI_TRAIN_STEPS AdamW steps the parameters are read against the CPU
    tests' 1e-5: AdamW divides each gradient by its own magnitude, so an
    element whose gradient lies within the sum orders' noise may step
    either way (up to the learning rate). The share of such elements is
    bounded, and every element apart must be one whose first-step |grad|
    lies below MULTI_NOISE_RATIO times the largest difference between its
    two runs' gradients over the steps (apart_unexplained counts the
    others); apart_noise_share is the share of all elements that meet that
    test, apart_ratio_max the largest first-step |grad| over that
    difference among those apart, apart_below_noise the share of those
    apart whose first-step gradient is below that difference itself (its
    sign may flip)."""
    read = {}
    for key in ddp_metrics[0]:
        rel = [abs(a[key] - b[key]) / abs(b[key])
               for a, b in zip(ddp_metrics, one_metrics)]
        read[f'{key}_rel_first'] = rel[0]
        read[f'{key}_rel_max'] = max(rel)
    one_g, two_g = (torch.load(os.path.join(MULTI_DIR, f'fp32_{w}_grads.pt'),
                               map_location='cuda') for w in ('plain', two))
    first, noise = {}, {}
    for k, g in one_g[0].items():
        d = two_g[0][k] - g
        first[k] = (float(d.abs().max() / g.abs().max().clamp(min=1e-30)),
                    float(d.norm() / g.norm().clamp(min=1e-30)))
        noise[k] = (two_g[0][k] - g).abs()
        for a, b in zip(one_g[1:], two_g[1:]):
            noise[k] = noise[k].maximum((b[k] - a[k]).abs())
    g1 = {k: g.abs() for k, g in one_g[0].items()}
    del one_g, two_g
    read['grad_rel'] = max(v[0] for v in first.values())
    read['grad_rel_leaf'] = max(first, key=lambda k: first[k][0])
    read['grad_rel_median'] = statistics.median(v[0]
                                                for v in first.values())
    read['grad_norm_rel'] = max(v[1] for v in first.values())
    one, two = (torch.load(os.path.join(MULTI_DIR, f'fp32_{w}.pt'),
                           map_location='cuda') for w in ('plain', two))
    start = training_model(torch, training_configs()[1], 'auto',
                           seed=1).state_dict()
    read['param_max_apart'] = max(float((one[k] - two[k]).abs().max())
                                  for k in one)
    apart = unexplained = below = noisy = 0
    ratio = 0.0
    for k in one:
        far = (one[k] - two[k]).abs() > MULTI_PARAM_ATOL
        explained = g1[k] < MULTI_NOISE_RATIO * noise[k]
        apart += int(far.sum())
        unexplained += int((far & ~explained).sum())
        below += int((far & (g1[k] < noise[k])).sum())
        noisy += int(explained.sum())
        if far.any():
            ratio = max(ratio, float((g1[k][far] / noise[k][far].clamp(
                min=1e-30)).max()))
    read['params'] = sum(v.numel() for v in one.values())
    read['params_apart'] = apart
    read['params_apart_share'] = apart / read['params']
    read['apart_unexplained'] = unexplained
    read['apart_below_noise'] = below / max(apart, 1)
    read['apart_noise_share'] = noisy / read['params']
    read['apart_ratio_max'] = ratio
    read['update_rel'] = math.sqrt(
        sum(float(((one[k] - two[k]).double() ** 2).sum()) for k in one)
        / sum(float(((one[k] - start[k]).double() ** 2).sum())
              for k in one))
    del one, two, start, g1, noise
    print(f'{label}: {json.dumps(read)}', flush=True)
    for key, bound in MULTI_FP32_BOUNDS.items():
        if read[key] > bound:
            fail(f'{label}: {key} {read[key]} > {bound}')
    return read


def start_rank(leg, rank, world, store):
    code = (f'import chip_smoke; chip_smoke.multi_card_rank({leg!r}, '
            f'{rank}, {world}, {store!r})')
    return subprocess.Popen([sys.executable, '-c', code], cwd=REPO,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


# The model axis (tensor parallelism) on the one card: gloo ranks sharing
# cuda:0 (NCCL refuses two ranks on one device), started beside the data
# axis's children. tp_decode: two ranks, model=2, the vanilla model
# (MT3Config(), fp32, seed 0) on the replicas leg's MULTI_VANILLA_SEGMENTS
# segments at MULTI_MAX_LENGTH in one call (the rows are independent:
# the tokens equal those of its calls of 8), then the paper's bf16
# segment-memory model (seed 0) on TP_SEGMEM_SEGMENTS segments of one
# contiguous chain at MAIN_PATH_MAX_LENGTH (the memory encoder reads L =
# max_length and takes the attention kernel from 512 on), both at
# quantize='none'. tp_train: four ranks, data=2 x model=2, the training
# legs' bf16 and fp32 models on multi_train_batch's 3-row batch of 1024
# targets. A decode step makes 26 collectives at full width, and a gloo
# collective takes ~1.1-1.2 ms on the card's host whether its tensor is
# on the card or not (probes/tp_collectives.py): the legs' seconds say
# nothing of tensor parallelism's speed.
TP_SEGMEM_SEGMENTS = 2
TP_SEGMEM_SEED = 11
TP_MODEL = 2


class HeadsLog(Patches):
    """Records the (B, L, H, D) shape of every q the attention kernels'
    launches read (ops/train_attention.py's fused_attention_cuda and
    fused_attention_backward_cuda) until closed."""

    def __init__(self):
        from mr_mt3_tpu_torch.ops import train_attention as ta
        super().__init__()
        self.fwd, self.bwd = [], []

        def recording(into):
            def wrapper(real, q, *args, **kw):
                into.append(list(q.shape))
                return real(q, *args, **kw)
            return wrapper
        self.patch(ta, 'fused_attention_cuda', recording(self.fwd))
        self.patch(ta, 'fused_attention_backward_cuda', recording(self.bwd))


def tp_segmem_mel():
    """The segment-memory leg's log-mel input: TP_SEGMEM_SEGMENTS segments
    of seeded noise, (S, 256, 512) float32 (numpy, the same bits in the
    children and in the parent)."""
    import numpy as np
    rng = np.random.default_rng(TP_SEGMEM_SEED)
    return (rng.normal(size=(TP_SEGMEM_SEGMENTS, 256, 512)) * 0.5
            ).astype(np.float32)


def tp_vanilla_audio():
    """The vanilla leg's audio: decode_replicas' (seed 7)."""
    import numpy as np
    rng = np.random.default_rng(7)
    return (rng.normal(size=MULTI_VANILLA_SEGMENTS * 256 * 128) * 0.1
            ).astype(np.float32)


def segmem_model(torch, kind='cuda'):
    """The paper's segment-memory model as serve.build_handler(SEGMEM_ARGS)
    builds it: bf16, seed-0 random weights."""
    from mr_mt3_tpu_torch import serve
    return serve.build_handler(
        SEGMEM_ARGS + (['device=cpu'] if kind == 'cpu' else [])).model


def tp_rank(leg, rank, world, store, kind='cuda'):
    """One child of the multi_card phase's model axis (`python -c "import
    chip_smoke; chip_smoke.tp_rank(...)"`), on a gloo group sharing the
    card; its results to MULTI_DIR/<leg>_rank<rank>.json (arrays beside
    them, .npy / .pt).

    leg 'tp_decode' (two ranks, model=2): the vanilla model's TP handler
    on the decode_replicas audio (log-mel launches and _compute_mel calls
    counted), the tokens and the mel saved; then the segment-memory
    model's contiguous chain (fused_attention_fwd launches, long
    attentions and the heads the kernel read counted), the tokens saved.
    leg 'tp_train'
    (four ranks, data=2 x model=2): MULTI_BF16_STEPS steps of the bf16
    segment-memory model (attention launches, long attentions and heads
    counted; each parameter's sum, gathered whole), MULTI_TRAIN_STEPS fp32
    steps, every step's gradients and the parameters after them gathered
    whole and saved by rank 0 for fp32_readings. kind 'cpu' serves a
    rehearsal on the CPU with the models swapped for tiny ones."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    from mr_mt3_tpu_torch import parallel
    from mr_mt3_tpu_torch.infer import InferenceHandler
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.ops import mel_kernel as mk
    from mr_mt3_tpu_torch.ops import train_attention as ta
    from mr_mt3_tpu_torch.parallel import tensor as tp_ops
    from mr_mt3_tpu_torch.train import optim, trainer
    from mr_mt3_tpu_torch.utils import builders

    parallel.init_multihost(backend='gloo', init_method=f'file://{store}')
    dev = parallel.rank_device(kind)
    mesh = parallel.Mesh((dev,) * world, model=TP_MODEL)
    out = {'rank': rank, 'world': world, 'device': str(dev),
           'mesh': mesh.shape, 'data_index': mesh.data_index(),
           'model_index': mesh.model_index()}
    t0 = time.monotonic()
    laps = out['laps'] = {}
    torch.set_num_threads(2)

    def lap(name):
        laps[name] = round(time.monotonic() - t0, 3)

    if leg == 'tp_decode':
        model = builders.init_params(MT3(MT3Config()), seed=0).to(dev)
        lap('vanilla_model')
        handler = InferenceHandler(model=model, mesh=mesh,
                                   max_length=MULTI_MAX_LENGTH,
                                   batch_size=MULTI_VANILLA_SEGMENTS)
        segments, _, valid = handler._audio_to_segments(tp_vanilla_audio())
        mk.LAUNCHES[mk.KERNEL] = 0
        mels = MelLog()
        try:
            mel = handler._compute_mel(segments[:MULTI_VANILLA_SEGMENTS],
                                       valid[:MULTI_VANILLA_SEGMENTS])
            lap('vanilla_mel')
            tokens = handler._decode_all(mel)
            lap('vanilla_decode')
        finally:
            mels.close()
        out['vanilla'] = {'logmel': mk.LAUNCHES[mk.KERNEL],
                          'compute_mel_calls': mels.calls,
                          'graphs': handler.capture_graphs(),
                          'local_heads':
                              model.decoder.block[0].self_attn.n_heads,
                          'seconds': time.monotonic() - t0}
        if rank == 0:
            np.save(os.path.join(MULTI_DIR, 'tp_vanilla_tokens.npy'), tokens)
            np.save(os.path.join(MULTI_DIR, 'tp_vanilla_mel.npy'),
                    mel.float().cpu().numpy())
        del handler, model
        model = segmem_model(torch, kind)
        lap('segmem_model')
        handler = InferenceHandler(model=model, mesh=mesh,
                                   max_length=MAIN_PATH_MAX_LENGTH,
                                   contiguous_inference=True,
                                   segment_bucket=1)
        ta.LAUNCHES[ta.KERNEL] = 0
        log, heads = TrainLog(torch, time_steps=False), HeadsLog()
        try:
            with torch.no_grad():
                tokens = handler._decode_all(
                    torch.as_tensor(tp_segmem_mel(), device=dev))
        finally:
            log.close()
            heads.close()
        lap('segmem_decode')
        out['segmem'] = {'launches': ta.LAUNCHES[ta.KERNEL],
                         'long_attentions': log.fwd, 'kernel_q': heads.fwd,
                         'seconds': laps['segmem_decode']
                         - laps['vanilla_decode']}
        if rank == 0:
            np.save(os.path.join(MULTI_DIR, 'tp_segmem_tokens.npy'), tokens)
    else:
        cfg, f32 = training_configs()
        batches = [multi_train_batch(50 + i)
                   for i in range(MULTI_TRAIN_STEPS)]

        def run(config, steps, loss_type, keep=None):
            model = tp_ops.shard_model(
                training_model(torch, config, 'auto', seed=1), mesh)
            opt = optim.make_optimizer(**MULTI_OPTIMIZER)
            state = trainer.create_train_state(model, opt)
            kept = []
            if keep is not None:
                real_step = opt.step
                names = [n for n, _ in model.named_parameters()]

                def keeping(grads):
                    kept.append({n: tp_ops.full_tensor(g, n, model.tp)
                                 .detach().clone()
                                 for n, g in zip(names, grads)})
                    return real_step(grads)
                opt.step = keeping
            step = trainer.make_train_step(loss_type)
            metrics = []
            for batch in batches[:steps]:
                part = parallel.shard_batch(batch, mesh.n_data,
                                            mesh.data_index())
                m = step(state, part, None)
                metrics.append({k: float(v) for k, v in m.items()})
            if keep:
                torch.save(kept, keep)
            return model, state, metrics

        ta.LAUNCHES[ta.KERNEL] = ta.LAUNCHES[ta.KERNEL_BWD] = 0
        log, heads = TrainLog(torch, time_steps=False), HeadsLog()
        try:
            model, state, bf16_m = run(cfg, MULTI_BF16_STEPS, 'ce')
        finally:
            log.close()
            heads.close()
        lap('bf16')
        full = tp_ops.full_state_dict(model)
        out['bf16'] = {'metrics': bf16_m, 'ddp': state.ddp is not None,
                       'launches': {k: ta.LAUNCHES[k] for k in
                                    (ta.KERNEL, ta.KERNEL_BWD)},
                       'long_attentions': {'forward': log.fwd,
                                           'backward': log.bwd},
                       'kernel_q': {'forward': heads.fwd,
                                    'backward': heads.bwd},
                       'param_sums': {k: float(v.double().sum())
                                      for k, v in full.items()}}
        del model, state, full
        # the first data index's model group keeps the gradients; rank 0
        # writes them and the parameters
        keep = mesh.data_index() == 0
        model, _, f32_m = run(
            f32, MULTI_TRAIN_STEPS, 'weighted',
            keep=(os.path.join(MULTI_DIR, 'fp32_tp_grads.pt')
                  if rank == 0 else '') if keep else None)
        full = tp_ops.full_state_dict(model)
        if rank == 0:
            torch.save(full, os.path.join(MULTI_DIR, 'fp32_tp.pt'))
        out['fp32'] = {'tp': f32_m}
        del model, full
        lap('fp32')
    out['seconds'] = time.monotonic() - t0
    with open(os.path.join(MULTI_DIR, f'{leg}_rank{rank}.json'), 'w') as f:
        json.dump(out, f)
    parallel.barrier()
    parallel.shutdown()


def start_tp_rank(leg, rank, world, store):
    code = (f'import chip_smoke; chip_smoke.tp_rank({leg!r}, {rank}, '
            f'{world}, {store!r})')
    return subprocess.Popen([sys.executable, '-c', code], cwd=REPO,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def tp_references(torch):
    """The parent's side of the model axis: quantize='fused_int4' on a
    model=2 mesh raises before any collective; the one-rank handler's
    contiguous chain of the segment-memory model (the tp_segmem leg's
    reference). Returns (the refusal's message, the one-rank handler, its
    tokens, the mel)."""
    from mr_mt3_tpu_torch.infer import InferenceHandler
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.parallel import Mesh
    dev = torch.device('cuda', 0)
    try:
        InferenceHandler(model=MT3(MT3Config()), quantize='fused_int4',
                         mesh=Mesh((dev, dev), model=TP_MODEL))
    except ValueError as e:
        refusal = str(e)
    else:
        fail('quantize=fused_int4 on a model=2 mesh did not raise')
    if 'model axis' not in refusal:
        fail(f'the model-axis refusal does not name it: {refusal}')
    one = InferenceHandler(model=segmem_model(torch), device=dev,
                           max_length=MAIN_PATH_MAX_LENGTH,
                           contiguous_inference=True, segment_bucket=1)
    mel = torch.as_tensor(tp_segmem_mel(), device=dev)
    return refusal, one, one._decode_all(mel), mel


def tp_checks(torch, refs, vanilla_tokens, vanilla_mel, one_metrics):
    """The model axis's children against their references: the vanilla
    tokens equal the one-replica handler's (decode_replicas, the same
    rows), log-mel launches equal the _compute_mel calls; the segment-
    memory chain against the one-rank handler by classify_flips' margin
    rule, fused_attention_fwd launches equal to the long attentions on
    each rank, on H / TP_MODEL heads; the 2x2 training's launches likewise
    (forward and backward), every rank's gathered parameters equal, the
    fp32 leg against the one-process step by fp32_readings."""
    import numpy as np

    from mr_mt3_tpu_torch.infer.probe import classify_flips
    from mr_mt3_tpu_torch.ops import train_attention as ta
    refusal, one, one_tokens, mel = refs
    dec = [json.load(open(os.path.join(MULTI_DIR,
                                       f'tp_decode_rank{r}.json')))
           for r in range(TP_MODEL)]
    train = [json.load(open(os.path.join(MULTI_DIR,
                                         f'tp_train_rank{r}.json')))
             for r in range(2 * TP_MODEL)]
    heads = one.cfg.num_heads // TP_MODEL
    got = np.load(os.path.join(MULTI_DIR, 'tp_vanilla_tokens.npy'))
    mel_equal = bool(np.array_equal(
        np.load(os.path.join(MULTI_DIR, 'tp_vanilla_mel.npy')),
        vanilla_mel))
    vanilla_equal = bool(np.array_equal(got, vanilla_tokens))
    print(f'TP vanilla (model={TP_MODEL}, fp32, none): tokens equal '
          f'{vanilla_equal} (the mel equal {mel_equal}); '
          + '; '.join(f'rank {d["rank"]}: logmel {d["vanilla"]["logmel"]} '
                      f'for {d["vanilla"]["compute_mel_calls"]} '
                      f'_compute_mel calls, graphs {d["vanilla"]["graphs"]}, '
                      f'{d["vanilla"]["seconds"]:.1f} s' for d in dec),
          flush=True)
    if not vanilla_equal:
        fail(f'TP vanilla tokens differ from one replica\'s (mel equal '
             f'{mel_equal})')
    for d in dec:
        v = d['vanilla']
        if v['logmel'] != v['compute_mel_calls'] or v['logmel'] < 1:
            fail(f'TP rank {d["rank"]}: logmel launches {v["logmel"]} for '
                 f'{v["compute_mel_calls"]} _compute_mel calls')
        if v['local_heads'] != heads or v['graphs'].get('graphs') is not \
                False:
            fail(f'TP rank {d["rank"]}: {v}')
    seg = np.load(os.path.join(MULTI_DIR, 'tp_segmem_tokens.npy'))
    flips = {'material_rows': 0, 'benign_rows': 0}
    if not np.array_equal(seg, one_tokens):
        flips = classify_flips(one, seg, one_tokens, mel)
    print(f'TP segmem chain (bf16, none, max_length '
          f'{MAIN_PATH_MAX_LENGTH}): tokens equal '
          f'{bool(np.array_equal(seg, one_tokens))}, flips {flips}; '
          + '; '.join(f'rank {d["rank"]}: fused_attention_fwd '
                      f'{d["segmem"]["launches"]} for '
                      f'{d["segmem"]["long_attentions"]} long attentions, q '
                      f'{d["segmem"]["kernel_q"]}, '
                      f'{d["segmem"]["seconds"]:.1f} s (laps {d["laps"]})'
                      for d in dec),
          flush=True)
    if flips['material_rows']:
        fail(f'TP segmem tokens: material flips {flips}')
    for d in dec:
        s = d['segmem']
        if s['launches'] != s['long_attentions'] or s['launches'] < 1 or \
                any(q[2] != heads for q in s['kernel_q']):
            fail(f'TP segmem rank {d["rank"]}: {s}')
    for t in train:
        b = t['bf16']
        losses = [m['loss'] for m in b['metrics']]
        print(f'TP train rank {t["rank"]} (data {t["data_index"]}, model '
              f'{t["model_index"]}): bf16 losses {losses}, attention '
              f'launches {b["launches"]} for {b["long_attentions"]} long '
              f'attentions, heads read '
              f'{sorted({q[2] for q in b["kernel_q"]["forward"]})} / '
              f'{sorted({q[2] for q in b["kernel_q"]["backward"]})}, '
              f'{t["seconds"]:.1f} s (laps {t["laps"]})', flush=True)
        if b['launches'][ta.KERNEL] != b['long_attentions']['forward'] or \
                b['launches'][ta.KERNEL_BWD] != \
                b['long_attentions']['backward'] or \
                b['long_attentions']['backward'] < 1 or not b['ddp'] or \
                any(q[2] != heads for q in b['kernel_q']['forward']
                    + b['kernel_q']['backward']) or \
                not all(math.isfinite(x) for x in losses):
            fail(f'TP train rank {t["rank"]}: {b}')
        if b['param_sums'] != train[0]['bf16']['param_sums']:
            fail(f'TP train: rank {t["rank"]}\'s gathered parameters differ '
                 'from rank 0\'s')
        if b['metrics'] != train[0]['bf16']['metrics'] or \
                t['fp32']['tp'] != train[0]['fp32']['tp']:
            fail(f'TP train: rank {t["rank"]}\'s metrics differ')
    fp32 = fp32_readings(torch, train[0]['fp32']['tp'], one_metrics,
                         two='tp', label='fp32, 2x2 TP grid vs one process')
    return {'refusal': refusal, 'vanilla_tokens_equal': vanilla_equal,
            'vanilla_mel_equal': mel_equal,
            'segmem_tokens_equal': bool(np.array_equal(seg, one_tokens)),
            'segmem_flips': flips,
            'decode_ranks': dec,
            'train_ranks': [{k: t[k] for k in ('rank', 'data_index',
                                               'model_index', 'seconds',
                                               'laps')}
                            | {'bf16': {k: v for k, v in t['bf16'].items()
                                        if k != 'param_sums'}}
                            for t in train],
            'fp32': fp32}


def decode_replicas(torch):
    """The handler on a mesh of the card twice against the one-replica
    handler, at each of MULTI_TIERS: the vanilla model (MT3Config(), seed
    0) on MULTI_VANILLA_SEGMENTS segments of log-mel from the kernel, calls
    of 8 rows a replica; the segment-memory model (bf16, seed 0) on two
    songs of MULTI_CHAINS chains, chained, one song a replica, the
    one-replica handler decoding each song alone. Tokens equal; the window
    kernel's launches counted per replica thread. multi_card runs this
    while its rank children train and evaluate on the same card, so the
    seconds read here are the decodes' under that load, not a reading of
    two replicas' overlap."""
    import numpy as np

    from mr_mt3_tpu_torch import serve
    from mr_mt3_tpu_torch.infer import InferenceHandler
    from mr_mt3_tpu_torch.models import MT3, MT3Config
    from mr_mt3_tpu_torch.ops import fused_decode as fd
    from mr_mt3_tpu_torch.parallel import Mesh
    from mr_mt3_tpu_torch.utils import builders
    dev = torch.device('cuda', 0)
    mesh = Mesh((dev, dev))
    vanilla = builders.init_params(MT3(MT3Config()), seed=0).to(dev).eval()
    segmem = serve.build_handler(SEGMEM_ARGS).model
    rng = np.random.default_rng(7)
    probe = InferenceHandler(model=vanilla, device=dev)
    audio = (rng.normal(size=MULTI_VANILLA_SEGMENTS * 256 * 128) * 0.1
             ).astype(np.float32)
    segments, _, valid = probe._audio_to_segments(audio)
    mel = probe._compute_mel(segments[:MULTI_VANILLA_SEGMENTS],
                             valid[:MULTI_VANILLA_SEGMENTS])
    songs = [torch.as_tensor((rng.normal(size=(
        MULTI_CHAINS * 8, 256, 512)) * 0.5).astype(np.float32), device=dev)
        for _ in range(2)]
    results = {}
    # the model axis's vanilla reference: one replica's exact tokens
    refs = {'vanilla_mel': mel.float().cpu().numpy()}
    for tier in MULTI_TIERS:
        kw = dict(quantize=tier, max_length=MULTI_MAX_LENGTH, batch_size=8)
        for name, model in (('vanilla', vanilla), ('segmem', segmem)):
            one = InferenceHandler(model=model, device=dev, **kw)
            two = InferenceHandler(model=model, mesh=mesh, **kw)

            def decode_one():
                if name == 'vanilla':
                    return one._decode_all(mel)
                return [one._decode_segmem_chained([m])[0] for m in songs]

            def decode_two():
                if name == 'vanilla':
                    return two._decode_all(mel)
                return two._decode_segmem_chained(songs)
            # the first decodes pack the weights and capture the graphs;
            # the second ones are timed and counted
            t0 = time.monotonic()
            decode_one()
            one_cold_s = time.monotonic() - t0
            t0 = time.monotonic()
            decode_two()
            two_cold_s = time.monotonic() - t0
            for t in TIERS:
                fd.LAUNCHES[t] = 0
            torch.cuda.synchronize()
            t0 = time.monotonic()
            want = decode_one()
            one_s = time.monotonic() - t0
            one_launches = sum(fd.LAUNCHES.values())
            for t in TIERS:
                fd.LAUNCHES[t] = 0
            log = ReplicaLog()
            try:
                t0 = time.monotonic()
                got = decode_two()
                two_s = time.monotonic() - t0
            finally:
                log.close()
            if (name, tier) == ('vanilla', 'none'):
                refs['vanilla_tokens'] = want
            equal = (np.array_equal(got, want) if name == 'vanilla'
                     else all(np.array_equal(g, w)
                              for g, w in zip(got, want)))
            per_replica = {k: v for k, v in sorted(log.by_thread.items())}
            launches = sum(fd.LAUNCHES.values())
            row = {'tokens_equal': bool(equal), 'one_replica_s': one_s,
                   'two_replicas_s': two_s, 'one_replica_cold_s': one_cold_s,
                   'two_replicas_cold_s': two_cold_s,
                   'one_replica_launches': one_launches,
                   'launches': launches,
                   'launches_by_replica': per_replica,
                   'tokens': int(sum(np.size(g) for g in got)
                                 if name == 'segmem' else got.size)}
            results[f'{name}_{tier}'] = row
            print(f'replicas {name} {tier}: tokens equal {equal}, one '
                  f'replica {one_s:.3f} s, two {two_s:.3f} s (first '
                  f'decodes {one_cold_s:.2f} / {two_cold_s:.2f} s; the card '
                  f'shared with the rank children), window launches '
                  f'{per_replica} (one replica {one_launches})', flush=True)
            if not equal:
                fail(f'{name} {tier}: two replicas\' tokens differ from '
                     f'the one-replica handler\'s')
            # every launch on a replica's thread, each replica launching;
            # a part of padding rows alone still runs its first window
            if tier.startswith('fused') and (
                    set(per_replica) != {'replica-0', 'replica-1'}
                    or min(per_replica.values()) < 1
                    or sum(per_replica.values()) != launches
                    or launches < one_launches):
                fail(f'{name} {tier}: window launches by replica '
                     f'{per_replica} ({launches} counted), one replica '
                     f'{one_launches}')
            if not tier.startswith('fused') and per_replica:
                fail(f'{name} {tier}: window launches {per_replica}')
            del one, two
    torch.cuda.empty_cache()
    return results, refs


def multi_card(torch):
    """Both axes on the one card: decode replicas (decode_replicas) and
    the model axis's references (tp_references) in this process while
    three children (multi_card_rank) run a one-rank NCCL group and two
    gloo ranks sharing the card, and six more (tp_rank) the model axis on
    gloo ranks sharing it: two decoding at model=2 and a data=2 x model=2
    grid training; then the checks of both axes (tp_checks for the model
    axis). Every child's failure or timeout fails the phase."""
    phase('multi-card: replicas, DDP ranks, multi-process eval, model axis')
    import shutil

    from mr_mt3_tpu_torch.ops import train_attention as ta
    shutil.rmtree(MULTI_DIR, ignore_errors=True)
    os.makedirs(MULTI_DIR)
    eval_set(os.path.join(MULTI_DIR, 'parity'), *parity_corpus(),
             subtype='FLOAT')
    procs = {('nccl', 0): start_rank('nccl', 0, 1,
                                     os.path.join(MULTI_DIR, 'nccl.store')),
             **{('gloo', r): start_rank('gloo', r, 2,
                                        os.path.join(MULTI_DIR,
                                                     'gloo.store'))
                for r in range(2)},
             **{(leg, r): start_tp_rank(leg, r, world,
                                        os.path.join(MULTI_DIR,
                                                     f'{leg}.store'))
                for leg, world in (('tp_decode', TP_MODEL),
                                   ('tp_train', 2 * TP_MODEL))
                for r in range(world)}}
    t0 = time.monotonic()
    try:
        replicas, one_replica = decode_replicas(torch)
        replicas_s = time.monotonic() - t0
        tp_refs = tp_references(torch)
        tp_refs_s = time.monotonic() - t0 - replicas_s
        logs = {}
        for key, proc in procs.items():
            left = MULTI_RANK_TIMEOUT_S - (time.monotonic() - t0)
            try:
                logs[key] = proc.communicate(timeout=max(left, 1))[0]
            except subprocess.TimeoutExpired:
                fail(f'multi_card child {key} ran past '
                     f'{MULTI_RANK_TIMEOUT_S} s')
        for key, proc in procs.items():
            print(f'--- child {key} (rc {proc.returncode}):\n'
                  + logs[key][-3000:], flush=True)
            if proc.returncode != 0:
                fail(f'multi_card child {key} exited {proc.returncode}')
        ranks_s = time.monotonic() - t0
        nccl = json.load(open(os.path.join(MULTI_DIR, 'nccl_rank0.json')))
        gloo = [json.load(open(os.path.join(MULTI_DIR,
                                            f'gloo_rank{r}.json')))
                for r in range(2)]
        # one-rank NCCL: the DDP step is the plain step bit for bit
        if not nccl['fp32']['metrics_equal'] or \
                nccl['fp32']['params_unequal']:
            fail(f'one-rank NCCL DDP vs plain: {nccl["fp32"]}')
        # two gloo ranks: the same reduced metrics and parameters on both
        for key in ('bf16', 'fp32'):
            a, b = (g[key]['metrics'] if key == 'bf16'
                    else g[key]['ddp'] for g in gloo)
            if a != b:
                fail(f'{key}: the two ranks\' metrics differ: {a} {b}')
        if gloo[0]['bf16']['param_sum'] != gloo[1]['bf16']['param_sum']:
            fail('bf16: the two ranks\' parameters differ')
        for g in gloo:
            launches = g['bf16']['launches']
            long = g['bf16']['long_attentions']
            losses = [m['loss'] for m in g['bf16']['metrics']]
            print(f'gloo rank {g["rank"]} on {g["device"]}: bf16 losses '
                  f'{losses}, fused attention launches {launches} for '
                  f'{long["forward"]} forward and {long["backward"]} '
                  f'backward long attentions')
            if launches[ta.KERNEL] != long['forward'] or \
                    launches[ta.KERNEL_BWD] != long['backward'] or \
                    long['backward'] < 1 or \
                    not all(math.isfinite(x) for x in losses):
                fail(f'bf16 DDP on rank {g["rank"]}: {g["bf16"]}')
        fp32 = fp32_readings(torch, gloo[0]['fp32']['ddp'],
                             nccl['fp32']['plain'])
        # evaluation: two ranks' scores equal one process's
        one = nccl['eval']['scores']
        for g in gloo:
            ev = g['eval']
            print(f'eval rank {g["rank"]}: Onset F1 '
                  f'{ev["scores"].get("Onset F1")}, logmel launches '
                  f'{ev["logmel"]} for {ev["compute_mel_calls"]} '
                  f'_compute_mel calls ({ev["seconds"]:.1f} s)')
            if ev['scores'] != one:
                fail(f'rank {g["rank"]} scores {ev["scores"]} against one '
                     f'process\'s {one}')
            if ev['logmel'] != ev['compute_mel_calls'] or ev['logmel'] < 1:
                fail(f'rank {g["rank"]}: logmel launches {ev["logmel"]} for '
                     f'{ev["compute_mel_calls"]} _compute_mel calls')
        if set(one) != SCORE_KEYS or one['Onset F1'] < 0.5:
            fail(f'the parity model scores {one} in one process')
        tp = tp_checks(torch, tp_refs, one_replica['vanilla_tokens'],
                       one_replica['vanilla_mel'], nccl['fp32']['plain'])
        tp['references_seconds'] = tp_refs_s
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(MULTI_DIR, ignore_errors=True)
    return {'replicas': replicas, 'replicas_seconds': replicas_s,
            'ranks_seconds': ranks_s,
            'nccl_one_rank': {'bit_equal': True,
                              'train_seconds': nccl['train_seconds'],
                              'metrics': nccl['fp32']['ddp']},
            'gloo_two_ranks': [{k: g[k] for k in ('rank', 'device', 'bf16',
                                                   'train_seconds')}
                               for g in gloo],
            'fp32': fp32,
            'eval': {'scores': one,
                     'ranks': [{k: g['eval'][k] for k in
                                ('logmel', 'compute_mel_calls', 'seconds')}
                               for g in gloo],
                     'one_process_seconds': nccl['eval']['seconds']},
            'model_axis': tp}


def main():
    try:
        import torch
    except ImportError:
        fail('torch is not installed')
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false')
    if not os.path.isdir(os.path.join(REPO, 'mr_mt3_tpu_torch')):
        fail('mr_mt3_tpu_torch/ is not beside this script')
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    environment(torch)
    build_kernels()
    native = native_phase(torch)
    profiled = profiling_check(torch)
    cases = kernel_cases(torch)
    stepped = step_cases(torch)
    grouped = grouped_cases(torch)
    int8_cases = int8_kernel_cases(torch)
    device_position = int8_device_position_cases(torch)
    survival = capture_survival(torch)
    mel_cases = logmel_cases(torch)
    attn_cases = attention_cases(torch)
    bwd_cases = attention_backward_cases(torch)
    parity = parity_on_card(torch)
    parity['segmem'] = segmem_parity_on_card(torch)
    main = main_path(torch)
    segmem = segmem_main_path(torch)
    evaluation = {'main_path': eval_main_path(torch),
                  'f1_card_vs_cpu': eval_f1_card_vs_cpu(torch)}
    launches = held_tier_serving(torch)
    int8_serving = int8_tier_serving(torch)
    int8_segmem = segmem_int8_leg(torch)
    worst = worst_case(torch)
    worst['segmem_fused_bf16'] = segmem_worst_case(torch)
    step_main = step_path(torch)
    grouped_main = grouped_path(torch)
    training = {'parity': training_parity(torch),
                'main_path': training_main_path(torch)}
    overfit = overfit_on_card(torch)
    t5x = converted_t5x(torch)
    adversarial = adversarial_gradient(torch)
    orbax = orbax_without_tensorstore(torch)
    multi = multi_card(torch)
    ranks = multi['gloo_two_ranks']
    train_launches = {
        k: sum(leg['launches'][k]
               for leg in (training['main_path']['first'],
                           training['main_path']['resumed']))
        for k in ('fused_attention_fwd', 'fused_attention_bwd')}

    notes = {'library_note': 'no single PyTorch call computes a greedy '
                             'window'}
    kernels = []
    for tier in TIERS:
        main_case = next(c for c in cases[tier] if (
            c['batch'], c['pos0'], c['lenc']) == WINDOW_MAIN_CASE)
        kernels.append({
            'name': f'fused_decode_window[{tier}]', 'mode': tier,
            'route': 'cuda',
            'source': 'mr_mt3_tpu_torch/csrc/fused_decode_window.cu',
            'replaces': 'mr_mt3_tpu/ops/fused_decode.py:969',
            'launches': launches[tier],
            'max_abs_err': max(c['max_abs_err'] for c in cases[tier]),
            'ms': main_case['ms'], 'plain_ms': main_case['plain_ms'],
            'bound_ms': main_case['bound_ms'],
            'bound_by': main_case['bound_by'],
            'library_ms': None, **notes,
            'main_path_launches': main['launches'][tier],
            'segmem_path_launches': segmem['launches'][tier],
            **({'multi_card_launches_by_replica': {
                leg: multi['replicas'][f'{leg}_{tier}']['launches_by_replica']
                for leg in ('vanilla', 'segmem')}}
               if tier in MULTI_TIERS else {}),
            **({'converted_t5x_launches':
                t5x['fused_int4']['launches']['fused_int4']}
               if tier == 'fused_int4' else {}),
            'overfit_ladder_launches':
                overfit['ladder']['window_launches'][tier],
            'cases': cases[tier]})
    for tier in TIERS:
        main_case = next(c for c in stepped[tier] if c['batch'] == 8
                         and c['position'] == 1023 and c['lenc'] == 256)
        kernels.append({
            'name': f'fused_decode_step[{tier}]', 'mode': tier,
            'route': 'cuda',
            'source': 'mr_mt3_tpu_torch/csrc/fused_decode_step.cu',
            'replaces': 'mr_mt3_tpu/ops/fused_decode.py:676',
            'launches': step_main[tier]['launches'],
            'max_abs_err': max(c['max_abs_err'] for c in stepped[tier]),
            'max_abs_err_note': 'logits, over all cases',
            'ms': main_case['ms'], 'plain_ms': main_case['plain_ms'],
            'bound_ms': main_case['bound_ms'],
            'bound_by': main_case['bound_by'], 'library_ms': None,
            'library_note': 'none: no PyTorch call computes a decoder step',
            'cases': stepped[tier]})
    main_case = next(c for c in grouped if c['groups'] == 8
                     and c['pos0'] == 992)
    kernels.append({
        'name': 'fused_decode_window_grouped', 'mode': 'fused',
        'route': 'cuda',
        'source': 'mr_mt3_tpu_torch/csrc/fused_decode_window.cu',
        'replaces': 'benchmarks/group_axis_kernel.py:385',
        'launches': grouped_main['grouped']['launches'],
        'max_abs_err': max(c['max_abs_err'] for c in grouped),
        'ms': main_case['ms'], 'plain_ms': main_case['plain_ms'],
        'bound_ms': main_case['bound_ms'], 'bound_by': main_case['bound_by'],
        'library_ms': None,
        'library_note': 'none: no PyTorch call computes a grouped window; '
                        'yardstick fused_window_ms, the `fused` window kernel '
                        'on the same inputs ungrouped (one cache chunk: not '
                        'the same function)',
        'fused_window_ms': main_case['fused_window_ms'],
        'cases': grouped})
    enc = next(c for c in attn_cases if c['case'] == 'memory_encoder_b8')
    kernels.append({
        'name': 'fused_attention_fwd', 'route': 'cuda',
        'source': 'mr_mt3_tpu_torch/csrc/fused_attention_fwd.cu',
        'header': 'mr_mt3_tpu_torch/csrc/fused_attention.cuh',
        'replaces': 'mr_mt3_tpu/ops/train_attention.py:185',
        'launches': segmem['launches']['fused_attention_fwd'],
        'max_abs_err': max(c['max_abs_err'] for c in attn_cases),
        'ms': enc['ms'], 'plain_ms': enc['plain_ms'],
        'bound_ms': enc['bound_ms'], 'bound_by': enc['bound_by'],
        'tflops': enc['tflops'], 'library_ms': enc['library_ms'],
        'library_note': 'torch.nn.functional.scaled_dot_product_attention, '
                        'scale 1.0, timed only',
        'training_path_launches': train_launches['fused_attention_fwd'],
        'adversarial_launches': adversarial['launches'][
            'fused_attention_fwd'],
        'ddp_launches_by_rank': [r['bf16']['launches']['fused_attention_fwd']
                                 for r in ranks],
        'tp_decode_launches_by_rank': [
            r['segmem']['launches'] for r in multi['model_axis'][
                'decode_ranks']],
        'tp_train_launches_by_rank': [
            r['bf16']['launches']['fused_attention_fwd']
            for r in multi['model_axis']['train_ranks']],
        'cases': attn_cases})
    enc = next(c for c in bwd_cases if c['case'] == 'memory_encoder_b12')
    kernels.append({
        'name': 'fused_attention_bwd', 'route': 'cuda',
        'source': 'mr_mt3_tpu_torch/csrc/fused_attention_bwd.cu',
        'header': 'mr_mt3_tpu_torch/csrc/fused_attention.cuh',
        'replaces': 'mr_mt3_tpu/ops/train_attention.py:204',
        'launches': train_launches['fused_attention_bwd'],
        'max_abs_err': max(c['max_abs_err'] for c in bwd_cases),
        'ms': enc['ms'], 'plain_ms': enc['plain_ms'],
        'bound_ms': enc['bound_ms'], 'bound_by': enc['bound_by'],
        'tflops': enc['tflops'], 'library_ms': enc['library_ms'],
        'library_note': 'torch.autograd.grad through torch.nn.functional.'
                        'scaled_dot_product_attention, scale 1.0, timed only',
        'adversarial_launches': adversarial['launches'][
            'fused_attention_bwd'],
        'ddp_launches_by_rank': [r['bf16']['launches']['fused_attention_bwd']
                                 for r in ranks],
        'tp_train_launches_by_rank': [
            r['bf16']['launches']['fused_attention_bwd']
            for r in multi['model_axis']['train_ranks']],
        'cases': bwd_cases})
    notes = {
        'int8_matmul': 'torch._weight_int8pack_mm (x, W (N, K) int8 '
                       'transposed once beforehand, f32 scales): the same '
                       'function, timed only; dequant_matmul_ms: '
                       'torch.matmul on the weights dequantized once '
                       'beforehand (reads bf16/f32 weights, not int8: not '
                       'the same function)',
        'int8_gated_ff': 'none: no single PyTorch call computes the gated '
                         'feed-forward',
        'int8_decode_attention': 'torch.nn.functional.scaled_dot_product_'
                                 'attention, scale 1.0, on the cache '
                                 'dequantized beforehand (no int8 q or p: '
                                 'not the same function), timed only'}
    for kernel, tier, source, line, main_case in (
            ('int8_matmul', 'int8', 'int8_matmul.cu', 'int8_matmul.py:71',
             'lm_head'),
            ('int8_gated_ff', 'int8', 'int8_matmul.cu',
             'int8_matmul.py:108', 'ff_512x1024'),
            ('int8_decode_attention', 'int8_kv', 'int8_decode_attention.cu',
             'int8_attention.py:101', 'self_pos1023')):
        rows = int8_cases[kernel]
        case = next(c for c in rows if c['case'] == main_case and
                    c['batch'] == 8 and c['dtype'] == 'float32')
        library = {'library_ms': case['library_ms']}
        if kernel == 'int8_matmul':
            library = {'library_ms': case.get('int8pack_ms'),
                       'library_queued_ms': case.get('int8pack_queued_ms'),
                       'queued_ms': case['queued_ms'],
                       'dequant_matmul_ms': case['library_ms']}
        kernels.append({
            'name': kernel, 'route': 'cuda',
            'source': f'mr_mt3_tpu_torch/csrc/{source}',
            'replaces': f'mr_mt3_tpu/ops/{line}',
            'launches': int8_serving[tier]['launches'][kernel],
            'max_abs_err': max(c['max_abs_err'] for c in rows),
            'ms': case['ms'], 'plain_ms': case['plain_ms'],
            'bound_ms': case['bound_ms'], 'bound_by': case['bound_by'],
            **library, 'library_note': notes[kernel],
            'segmem_path_launches': int8_segmem[tier]['launches'][kernel],
            'cases': rows})
        if kernel == 'int8_decode_attention':
            case = next(c for c in device_position if c['batch'] == 8 and
                        c['dtype'] == 'float32' and c['position'] == 1023)
            kernels[-1]['device_position'] = {
                'entry': 'i8att_launch_dev (position in device memory, '
                         'launch sized for n_max, the phase bound)',
                'max_abs_err': max(c['max_abs_err']
                                   for c in device_position),
                'ms': case['ms'], 'host_int_ms': case['host_int_ms'],
                'bound_ms': case['bound_ms'],
                'vs_host_int_unequal_max': max(
                    c['vs_host_int']['unequal'] for c in device_position),
                'cases': device_position}
    case = next(c for c in mel_cases if c['style'] == 'torch' and
                c['batch'] == 8 and c['kind'] == 'tone' and
                c['samples'] == LOGMEL_SAMPLES)
    kernels.append({
        'name': 'logmel', 'route': 'cuda',
        'source': 'mr_mt3_tpu_torch/csrc/logmel.cu',
        'replaces': 'mr_mt3_tpu/ops/mel_pallas.py:137',
        'launches': evaluation['main_path']['auto']['launches']['logmel'],
        'max_abs_err': max(c['vs_plain']['mel_err'] for c in mel_cases),
        'max_abs_err_note': 'mel space (exp of the output) against '
                            'compute_logmel over all cases; in log space '
                            'where log-mel > -4 at most '
                            f'{max(c["vs_plain"]["log_err"] for c in mel_cases):.3g}',
        'ms': case['ms'], 'plain_ms': case['plain_ms'],
        'bound_ms': case['bound_ms'], 'bound_by': case['bound_by'],
        'library_ms': case['library_ms'],
        'library_note': 'compute_logmel, the plain version: torch.fft.rfft '
                        '(cuFFT) and a matmul (cuBLAS), timed as both',
        'eval_none_launches':
            evaluation['main_path']['none']['launches']['logmel'],
        'serving_main_path_launches': main['launches']['logmel'],
        'segmem_path_launches': segmem['launches']['logmel'],
        'multi_process_eval_launches_by_rank': [
            r['logmel'] for r in multi['eval']['ranks']],
        'tp_decode_launches_by_rank': [
            r['vanilla']['logmel']
            for r in multi['model_axis']['decode_ranks']],
        'overfit_launches': overfit['none']['logmel_launches'],
        'converted_t5x_launches': {
            tier: t5x[tier]['launches']['logmel']
            for tier in ('fused_int4', 'none')},
        'cases': mel_cases})
    phase(None)
    print(f'phase seconds: {json.dumps(PHASE_SECONDS)}')
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, 'chip_smoke_kernels.json'), 'w') as f:
        json.dump({'card': card_line(), 'kernels': kernels,
                   'native': native, 'parity': parity, 'main_path': main,
                   'segmem_main_path': segmem, 'evaluation': evaluation,
                   'int8_serving': int8_serving,
                   'int8_segmem': int8_segmem,
                   'worst_case': worst, 'training': training,
                   'capture_survival': survival,
                   'step_path': step_main, 'grouped_path': grouped_main,
                   'multi_card': multi, 'profiling': profiled,
                   'overfit': overfit, 'converted_t5x': t5x,
                   'adversarial': adversarial, 'orbax': orbax,
                   'phase_seconds': PHASE_SECONDS}, f, indent=1)
    print(json.dumps({'kernels': kernels}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
