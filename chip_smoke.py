#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py                     # every phase
    python3 chip_smoke.py --only fused         # the fused kernels' rows
    python3 chip_smoke.py --only conv          # the conv kernel's rows
    python3 chip_smoke.py --only flash         # the flash kernels' rows
    python3 chip_smoke.py --only stream        # serve --stream's models
    python3 chip_smoke.py --only v2 bench      # MobileViTV2; the bench entry
    python3 chip_smoke.py --only trainx        # the trainer extras
    python3 chip_smoke.py --only surface       # resize, export, HTTP
    python3 chip_smoke.py --only tooling       # native I/O, the CLI's tools
    python3 chip_smoke.py --only dp            # data parallelism and ZeRO
    python3 chip_smoke.py --only layouts       # tensor and sequence
                                               # parallelism on MobileViT-s
    python3 chip_smoke.py --only pp_ep         # pipeline and expert
                                               # parallelism on MobileViT-s
    python3 chip_smoke.py --only kernels serve # or any of kernels, fused,
                                               # conv, flash, serve, train,
                                               # trainx, timing, stream, v2,
                                               # bench, surface, tooling,
                                               # dp, layouts, pp_ep
    python3 chip_smoke.py --ab-forward DIR     # Large3D's eager forward of
                                               # the tree at DIR and of this
                                               # one, in turns

Phases, in order (each prints JSON lines; any failure exits non-zero; a
run with --only says on a JSON line which phases it skipped and prints no
kernels summary):
  1. device   the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    nvcc builds every kernel from picklebot_tpu_torch/csrc/
              (fused_bottleneck, flash_attention, folded_conv), one process
              per source, all started together; meanwhile the profiler's
              one-time start-up runs on a trivial op
  3. kernels  each kernel against its plain PyTorch version on the card:
              the fused bottleneck at the 15 MobileNetLarge3D, the 7
              MobileViT-s and the 11 MobileNetSmall3D bottleneck geometries
              of a bs-8, 32x224x224 clip batch (bf16; each with its plan,
              two more calls bit-equal, device times from a trace and the
              SM clock; a split launch also against the plain version of
              its order), plus one f32 case with TF32 off; the flash
              forward kernel, packed without lse
              at MobileViT-s's three stages' shapes and with lse at stage
              1, per head at the three and at N=100, qkv-packed at stage 1
              (bf16; each with its plan, device times from a trace, the SM
              clock, TFLOP/s and two more calls bit-equal), f32 cases
              with TF32 off, and head dims 32 and 64; the fused
              kernels at batches past a grid's 65,535 y blocks (fb_main
              with B*T' = 67,200, fb_pool with B = 65,600); the flash
              backward kernels (dQ, dK/dV) against flash_backward_reference
              at the same shapes (with device times from a trace, the D
              pass, TFLOP/s, and two more calls bit-equal); the conv
              kernel, forward and dx, at
              MobileViT-s's six conv1/conv4 geometries (bf16; the plan each
              takes, stage 1 unsplit and stage 3 split over taps), at
              MobileViT-xxs's widths and the per-axis kernel sizes (1,3,3),
              (3,3,1), (1,5,3) (bf16 and f32), and in f32 with TF32 off at
              stage 2; kernel, plain and library times by CUDA events,
              bounds, TFLOP/s; the HMMA count of the SASS (cuobjdump) of
              the fused, conv and flash libraries and their ptxas
              registers, stack frames and spills (0 HMMA, a spill or a
              stack frame in a bf16 fused pool or main, conv, flash
              forward, dQ or dK/dV function fails the run; the others are
              reported);
              and 'auto''s threshold swept: at N = 32 ... 784 the
              head-packed kernel against the plain sdpa route, forward and
              forward + backward, by CUDA events and device time, and the
              smallest N from which the kernel route wins
  4. serve    picklebot_tpu_torch.serve.main on 16 synthetic clips at full
              width from a seeded .pth, for MobileNetLarge3D, MobileViT-s
              ('auto' attention), MobileNetSmall3D and MoViNet-A2: checks
              the predictions, the exact kernel launches of each run
              (every count set to 0 just before it, read just after; none
              for MoViNet-A2, which runs no hand-written kernel), and one
              batch's logits against the plain path on the card; then the
              predict throughput at bs 8, the forward's device time (for
              MobileViT-s also with conv1/conv4 on the library conv, as
              before the conv kernel, and at each of 'auto''s threshold
              routes), and a torch.profiler trace of one
              forward (device time by kernel, idle share; a trace without
              device events fails the run)
  5. pallas   one MobileViT-s forward each with attention_backend
              'pallas' and 'pallas_packed': 9 per-head flash launches
              each, logits against the plain path
  6. train    python -m picklebot_tpu_torch.cli on synthetic configs
              derived from configs/mobilevit_s.json,
              mobilenet_large_50k.json, mobilenet_small_50k.json and
              movinet_a2_50k.json (full width; each cut on a JSON line:
              32x224x224 synthetic clips, batch 8, 2 microbatches, 3
              steps, 48 clips): finite losses, the exact kernel launches
              of each run (the flash backward and the conv dx kernels
              included), and the written .pth serves; one MobileViT-s
              train step each with 'pallas' and 'pallas_packed'; every
              parameter's gradient against the plain path (kernels=False)
              on one bs-8 batch of MobileViT-s and MobileNetLarge3D; train
              step time, samples/s, forward and backward split, peak
              memory, and a torch.profiler trace of one train step per
              model (MobileViT-s also with conv1/conv4 on the library
              conv, and at each of 'auto''s threshold routes, 3 timed
              steps each)
  7. trainx   the trainer extras: the CLI on MobileNetLarge3D at full
              width (configs/mobilenet_large_50k.json cut as the train
              phase's, 40-frame clips windowed to 32 by temporal_jitter, 2
              epochs of 3 steps) with ema_decay, freeze_params (block1),
              augment_flip/crop/brightness, remat 1,
              checkpoint_every_steps 1, keep_checkpoints 2, save_best and
              early_stop_patience 1: run A uninterrupted, run B stopped by
              a SIGTERM after optimizer step 2 and finished by
              auto_resume, under deterministic algorithms; B's tail losses
              and final snapshot equal A's bit for bit, the exact fused
              launches of each run with the remat recompute, the frozen
              stem at its initial value, the snapshots, _best/ and
              statistics/*.npy written, the .pth served; one MobileViT-s
              bs-8 train step with remat 1 against remat 0 in bf16 and f32
              (exact launches of rows 2, 3, 4 and 7; f32 gradients and
              BatchNorm buffers within 1e-6 of max|ref|); the peak memory
              of a Large3D bs-8 train step at remat 0 and 1
  8. stream   the online models of serve --stream (MoViNetA2Stream,
              MobileNetLarge2D, MobileNetSmall2D), none of which runs a
              hand-written kernel: picklebot_tpu_torch.serve.main on 16
              whole synthetic clips each (exactly zero launches, finite
              (8, 13) logits); serve's per-clip stream loop on one 32-frame
              clip at --chunk 1, 4 and 5, f32 and bf16, against the whole
              clip (the 2-D models) or the same pieces on the CPU
              (MoViNetA2Stream, whose SE blocks pool the chunk's frames;
              in bf16 the card's distance from f32 against the CPU's),
              BatchNorm variances calibrated no lower than 1e-2;
              causality (the first chunk's logits under two different
              tails); per-chunk latency at --chunk 1 and 4 (host clock and
              CUDA events, median of 20 after 4), frames/s, a trace of one
              chunk-1 step, the whole-clip forward at bs 8; the CLI on a
              config derived from mobilenet_large2d_50k.json (cut as the
              train phase's), its .pth streamed; train() refusing
              MoViNetA2Stream
  9. v2       MobileViTV2 at full width (13 classes, seeded weights,
              BatchNorms calibrated on one batch) on uint8 256x256 images,
              which runs no hand-written kernel (exactly zero launches over
              the phase): at bs 8 the card's f32 logits (TF32 off) against
              the CPU's within 1e-4 of max|logit|, bf16 against the card's
              f32 (5% and the argmax rule), one f32 train step against the
              same step on the CPU (loss 1e-4, every gradient 1% rms and
              cosine 0.9999); at bs 32 the forward (CUDA events), the bf16
              train step (host clock, data on the card), images/s, peak
              memory, and a trace of one forward and one train step
 10. bench    python -m picklebot_tpu_torch.bench in this process:
              MobileNetLarge3D infer at bs 16, eager and --baked (the
              exported program loaded back; the fused main kernel must
              run in both) and MobileViTV2 train at bs 32, 256x256 (no
              launch); each prints its JSON line with a value above 0 and
              the card
 11. surface  the rest of serving at full width, MobileNetLarge3D (13
              classes, bf16, seeded weights, BatchNorms calibrated as in
              the serve phase): two 32x720x1280 uint8 clips through
              make_predict_fn(input_size=224): the card's resize (f32,
              TF32 off) against the CPU's within 1e-5 on [0, 1] pixels,
              exactly 8 pool and 15 main launches, the logits against the
              plain path (the serve bound); the bs-8 predict's time
              (events) and one trace of its stages (H2D copy, cast,
              resize, forward); Large3D and MobileViT-s exported with a
              symbolic batch on the card, saved and loaded back: their
              graphs' picklebot:: op nodes counted, the program at bs 1,
              3 and 8 against the eager predictor (bit-equal expected)
              and its exact launches; serve.make_http_server in this
              process over a RequestBatcher on the eager model and on the
              loaded program, at --batch-window 10 and 0: 8 clients, 32
              POSTs of .npy clips (no cv2 on the card's machine), every
              answer the batcher's record, each batch's records repeated
              in process, /healthz counting them and a 413 and a 400
              probe; requests/s and p50/p99 latency. At most 60 s of its
              own clock
 12. tooling  native I/O and the rest of the tooling: the C++ collate
              of 8 ragged 20-40-frame 224x224 clips bit-equal to the numpy
              path, its counter moved, both host times; the ffmpeg decode
              backend where its library builds (else the build error's
              first line): the committed mp4 fixture byte-exact against
              its stored OpenCV frames, then served through serve --csv
              with data_backend ffmpeg on MobileNetLarge3D bf16 (exactly
              8 pool and 15 main launches); the CLI on MobileNetLarge3D
              (the train phase's cuts, 32 clips, 2 steps) with autotune,
              --profile and --torch-profile-dir: the trace names
              pool_bf16_kernel / main_bf16_kernel exactly as often as
              LAUNCHES counted over the run, train_stats.prof written, one
              cache entry with both candidates, every batch through the
              native collate, a second autotune_config measuring nothing,
              memory_stats beside the run's peak; the autotuner's readings
              (MobileNetLarge3D train and MoViNet-A2 infer at bs 8; the
              kernels of a MoViNetA2Stream chunk-1 step with
              cudnn.benchmark off and on); the summary's totals of
              MobileNetLarge3D and MobileViT-s and their GFLOPs per clip.
              At most 120 s of its own clock
 13. dp       data parallelism and ZeRO on the one card, MobileNetLarge3D
              at full width (seed 0, 32x224x224, lr 3e-4, 2 steps a run):
              NCCL at world 1 (bs 8 in 2 microbatches, bf16, AdamW8bit)
              through the train step's DP path against the same steps
              with no process group, deterministic algorithms on
              (bit-equal expected; exactly 8 pool and 15 main launches
              per microbatch), and one more step of each in turns (CUDA
              events); whether NCCL takes two ranks on one card (a probe,
              recorded); two processes of this script sharing the card
              over gloo (--dp-rank), each bs 4 of a global bs-8 batch,
              DP, ZeRO-1 and ZeRO-3 in f32 (TF32 off, AdamW) and bf16
              (AdamW8bit): DP against a one-process emulation of its
              semantics on the card (bit-equal expected), f32 ZeRO-1 and
              ZeRO-3 against DP and bf16 ZeRO-3 against ZeRO-1 (bit-equal
              expected; else f32 1e-5 of max|ref|, bf16 the train
              bounds), every rank's launches exact and its weights equal
              to the other's, its parameter and optimizer-state bytes,
              peak memory, collective bytes per step and step times (one
              card shared: no speed figure); the autotuner's broadcast (rank 1 takes rank
              0's winner, measuring nothing); make_sharded_predict_fn over
              two replicas on cuda:0 at a ragged batch of 5 against the
              unsharded predictor (the serve bound; 8 pool and 15 main
              launches per replica call); serve --data-parallel 2 exiting
              non-zero and naming the one card found
 14. layouts  tensor and sequence parallelism on the one card, MobileViT-s
              at full width (seed 0, one bs-8 microbatch of the train
              phase's 32x224x224 clips a step, 2 steps, lr 3e-4, the
              global-norm clip at 1.0): two processes of this script
              sharing the card over gloo (--layout-rank), laid out as the
              mesh model 2 and then seq 2, each in f32 (TF32 off, AdamW)
              and bf16 (AdamW8bit), against the same steps in one process
              on the card: f32 losses and first-step gradients within 1e-5
              of max|ref| (bit equality recorded, not expected), weights
              within Adam's bound, bf16 losses within the train bounds;
              the ranks' weights equal; every rank's launches of rows 2,
              3, 4 and 7 exact (at seq 2 stages 1 and 3 run ring attention
              and only stage 2's 4 layers launch the flash kernels);
              collective counts and bytes per step by kind against the
              figures from the shapes; ring attention at the stage-1 and
              stage-3 shapes against the plain attention, forward and
              gradients, f32 and bf16; the TP run's .pth loaded strictly
              in one process and served (exact launches). The 4-rank
              model 2 x seq 2 run is left to the CPU tests
 15. pp_ep    pipeline and expert parallelism on the one card, the layouts
              phase's model, batch, steps, lr and clip, two processes of
              this script over gloo (--ppep-rank): at pipe 2 with 2 and 4
              pipeline microbatches (stages 1 and 2 pipeline, stage 3 runs
              the plain loop), and at expert 2 on MobileViT-s with 4
              experts, top-2, capacity factor 1.25, dispatch 'replicated'
              and 'tokens' (stage 2, N = 147, falls back to 'replicated'),
              each in f32 (TF32 off, AdamW) and bf16 (AdamW8bit), against
              the same steps in one process on the card: f32 first-step
              gradients within 1e-5 of max|ref| of the one-process step
              that computes the layout's arithmetic (the stacks in the
              same microbatches; the experts as the ranks compute them),
              and of the plain reference (the unsharded step; for
              'tokens' the experts on the ranks' token groups) within
              twice the floor measured between the two; bf16 losses
              within the train bounds; the ranks' weights equal; every rank's launches of
              rows 2, 3, 4 and 7 exact (PP: a pipelined stack's layers run
              on all M + 1 ticks, forward and backward); collective counts
              and bytes per step by kind against the figures from the
              shapes; the EP run's .pth loaded strictly in one process and
              served (exact launches). The 4-rank pipe 2 x model 2 and
              pipe 2 x seq 2 runs are left to the CPU tests
 16. summary  the collates of the whole run (none on numpy), {"kernels":
              [...]}, the card line, and last {"ok": true, "device": ...}
Per-shape numbers also go to chiprun_out/chip_smoke.json. Without CUDA it
exits with code 2 and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense; f32 w/o TF32
# (B, T, H, W, C), k, s, SE, E, Co: MobileNetLarge3D's 15 bottlenecks at
# bs 8 and a (8, 32, 224, 224, 3) input
GEOMETRIES = [
    ((8, 16, 112, 112, 16), 3, 1, False, 16, 16),
    ((8, 18, 112, 112, 16), 3, 2, False, 64, 24),
    ((8, 10, 56, 56, 24), 3, 1, False, 72, 24),
    ((8, 12, 56, 56, 24), 5, 2, True, 72, 40),
    ((8, 8, 28, 28, 40), 5, 1, True, 120, 40),
    ((8, 12, 28, 28, 40), 5, 1, True, 120, 40),
    ((8, 16, 28, 28, 40), 3, 2, False, 240, 80),
    ((8, 9, 14, 14, 80), 3, 1, False, 240, 80),
    ((8, 11, 14, 14, 80), 3, 1, False, 184, 80),
    ((8, 13, 14, 14, 80), 3, 1, False, 184, 80),
    ((8, 15, 14, 14, 80), 3, 1, True, 480, 112),
    ((8, 17, 14, 14, 112), 3, 1, True, 672, 112),
    ((8, 19, 14, 14, 112), 5, 2, True, 672, 160),
    ((8, 12, 7, 7, 160), 5, 1, True, 960, 160),
    ((8, 16, 7, 7, 160), 5, 1, True, 960, 160),
]
# MobileViT-s's 7 bottlenecks (stem[0..3], trunk[0..2][0]) at the same
# input; the serve phase checks that the model gives them these shapes
VIT_GEOMETRIES = [
    ((8, 16, 112, 112, 16), 3, 1, False, 64, 32),
    ((8, 18, 112, 112, 32), 3, 2, False, 128, 64),
    ((8, 10, 56, 56, 64), 3, 1, False, 256, 64),
    ((8, 12, 56, 56, 64), 3, 1, False, 256, 64),
    ((8, 14, 56, 56, 64), 3, 2, False, 256, 96),
    ((8, 8, 28, 28, 96), 3, 2, False, 512, 128),
    ((8, 5, 14, 14, 128), 3, 2, False, 512, 160),
]
# MobileNetSmall3D's 11 bottlenecks at the same input (E = 16, 72, 88 and
# 120 are no multiples of the kernels' 32-channel chunk)
SMALL_GEOMETRIES = [
    ((8, 16, 112, 112, 16), 3, 2, True, 16, 16),
    ((8, 9, 56, 56, 16), 3, 2, False, 72, 24),
    ((8, 6, 28, 28, 24), 3, 1, False, 88, 24),
    ((8, 8, 28, 28, 24), 5, 2, True, 96, 40),
    ((8, 6, 14, 14, 40), 5, 1, True, 240, 40),
    ((8, 10, 14, 14, 40), 5, 1, True, 240, 40),
    ((8, 14, 14, 14, 40), 5, 1, True, 120, 48),
    ((8, 18, 14, 14, 48), 5, 1, True, 144, 48),
    ((8, 22, 14, 14, 48), 5, 2, True, 288, 96),
    ((8, 13, 7, 7, 96), 5, 1, True, 576, 96),
    ((8, 17, 7, 7, 96), 5, 1, True, 576, 96),
]
# MobileViT-s attention at bs 8: 64 sequences (8 clips x 8 patch
# positions) of N tokens, 8 heads of 16, per stage: (N, layers)
VIT_ATTENTION = [(784, 2), (147, 4), (32, 3)]
VIT_SEQS, VIT_HEADS, VIT_DHEAD = 64, 8, 16
# the layers of those that 'auto' sends to the head-packed kernel (N at
# least the port's _PACKED_MIN_SEQ), per stage N; every exact flash launch
# count of a MobileViT-s run follows from it, and the run fails if the
# port's threshold routes otherwise
VIT_PACKED = {784: 2, 147: 4, 32: 3}
# 'auto''s threshold: N swept for it on the card, and the thresholds of
# MobileViT-s's four routes (no stage, stage 1, stages 1-2, every stage on
# the packed kernel), timed in turns in the serve and timing phases; 512
# is the JAX package's (a TPU measurement)
SWEEP_N = (32, 64, 147, 256, 512, 784)
PACKED_MIN_SEQ_TURNS = (785, 512, 147, 32)
# timed train steps at each of those routes in the timing phase (5
# elsewhere): cut from 5 so that the whole script keeps its time with the
# stream phase added; the routes' train steps lie within host noise of
# each other (PERF.md)
TRAIN_TURN_REPS = 3
# MobileViT-s's dense stride-1 3x3x3 convs at the same input, per stage:
# the MobileViTBlock's activation (B, T, H, W) and channel width C; conv1
# is C -> C on it, conv4 2C -> C. The serve phase checks that the model
# gives them these shapes.
VIT_CONV_STAGES = [((8, 8, 28, 28), 96), ((8, 5, 14, 14), 128),
                   ((8, 4, 7, 7), 160)]
# (x shape, Co, kernel): MobileViT-xxs's widths at bs 8 (48, 64, 80; conv4
# of its middle stage), then the per-axis kernel sizes of the JAX
# package's test of this kernel
CONV_EXTRA_CASES = [
    ((8, 8, 28, 28, 48), 48, (3, 3, 3)), ((8, 5, 14, 14, 128), 64, (3, 3, 3)),
    ((8, 4, 7, 7, 80), 80, (3, 3, 3)), ((2, 3, 4, 4, 64), 32, (1, 3, 3)),
    ((1, 5, 4, 3, 32), 32, (3, 3, 1)), ((1, 3, 5, 4, 32), 32, (1, 5, 3)),
    ((1, 4, 6, 5, 32), 48, (3, 3, 3))]
# bf16: the plain path rounds the expanded and depthwise tensors to bf16
# (2^-9 relative each) where the kernel keeps them f32, so outputs differ
# by a few bf16 ulps of the output's range; 3% of max|plain| bounds that.
# The same bound holds the flash kernel in bf16: the JAX package's own
# bf16 bound for its flash kernel (tests/test_flash_packed.py), since the
# kernel rounds unnormalized probabilities to bf16 where the plain version
# rounds normalized ones.
BF16_REL_TOL = 3e-2
# bf16 flash, besides: rms(err) within 1% of rms(ref). Rounding moves each
# output by a few 2^-9 (rms ratio ~0.3%); a stride or layout fault moves
# every output by about its own size. max|ref| comes from a few peaked
# rows, ~25x the rms output at N=784, so the max bound alone is loose.
# The conv kernel in bf16 is held to both bounds as well: it and its plain
# version (cuDNN) accumulate in f32 and round once, so they differ by one
# bf16 ulp of a few outputs (measured rms ratio ~0.02%).
BF16_RMS_TOL = 1e-2
# f32 with TF32 off: the same f32 chain summed in another order.
F32_REL_TOL = 1e-4
FLASH_F32_REL_TOL = 2e-4     # online softmax against one softmax, f32
LSE_ABS_TOL = 1e-3           # f32 logsumexp of f32 scores, two orders
# logits after 15 blocks in bf16: the two paths' roundings random-walk
# through about 45 ops, sqrt(45) * 2^-9 ~ 1.3%; allow 5% of max|logit|.
LOGIT_REL_TOL = 5e-2
# train: a bs-8 step's loss and every parameter's gradient, kernel path
# against the plain path. In f32 with TF32 off both paths compute the same
# function (the fused bottleneck's backward is the plain chain's,
# recomputed; the flash backward is the plain backward's algebra), so every
# leaf is held to 1% rms and a cosine of 0.9999 (run 4B: worst 0.32%, in a
# Large3D SE layer behind 15 train-mode BatchNorms; MobileViT-s 2e-5). In
# bf16 the gradients themselves are far from f32: run 4B measured the plain
# path's bf16 gradients 43% (rms, the median leaf of Large3D) and 9%
# (MobileViT-s) from the f32 ones, up to 150% on a few leaves, so no bound
# of 5% between two bf16 paths can hold. There each leaf's kernel-path
# gradient must be no farther from the f32 gradient than twice the plain
# path's distance plus 5% (run 4B: at most 1.67 times), and the losses
# agree within 2%. A leaf whose gradient is zero in exact arithmetic (a
# bias straight before a train-mode BatchNorm) or negligible carries
# rounding noise only: a plain f32 gradient below 1% of the median leaf's
# rms marks one, and its f32 kernel-vs-plain difference must stay below
# that floor.
TRAIN_LOSS_REL_TOL = 2e-2
F32_LOSS_REL_TOL = 1e-4
GRAD_F32_RMS_TOL = 1e-2
GRAD_F32_MIN_COS = 0.9999
GRAD_BF16_FACTOR, GRAD_BF16_SLACK = 2.0, 5e-2
GRAD_NOISE_FLOOR = 1e-2
# the train phase's cuts of the repo's configs (full width)
TRAIN_CUTS = {"data_backend": "synthetic", "synthetic_shape": [32, 224, 224],
              "batch_size": 8, "effective_batch_size": 16,
              "synthetic_len": 48}
TRAIN_STEPS = 3
# the online models of serve --stream; the chunks the stream phase holds
# against the whole clip (5 leaves a ragged tail of 2 on 32 frames), and
# the chunks it times (median of 20 chunks after 4 warm-up)
STREAM_MODELS = ("MoViNetA2Stream", "MobileNetLarge2D", "MobileNetSmall2D")
STREAM_CHUNKS = (1, 4, 5)
STREAM_TIMED = (1, 4)
STREAM_WARMUP, STREAM_REPS = 4, 20
# the stream models' BatchNorm variances are calibrated no lower than this
# (as in tests/test_torch_stream.py): a near-constant channel divided by a
# variance near 0 amplifies rounding
STREAM_BN_VAR_FLOOR = 1e-2
# MoViNetA2Stream in bf16 on the card against the same run on the CPU: bf16
# alone moves this model's logits further than 5% of max|logit| on both
# sides alike (on an H100 the whole clip's 0.2008 on the card and 0.2001 on
# the CPU from f32, at max|logit| 0.18; PERF.md), so the card's bf16 logits
# are held to the f32 ones: no farther than 2x the CPU's bf16 run, plus 5%
# of max|logit|, as the train phase holds bf16 gradients (GRAD_BF16_FACTOR)
STREAM_BF16_FACTOR = 2.0
# causality: the first chunk's logits under two different tails. Expected
# bit-equal (the same kernels on the same inputs); 1e-6 of max|logit| is
# allowed in case cuDNN picks its algorithm per call
CAUSAL_REL_TOL = 1e-6
# MobileViTV2 (the v2 phase): full width, 13 classes, uint8 256x256
# images; the checks at bs 8 (card f32 with TF32 off against the CPU's f32
# within 1e-4 of max|logit|, one f32 train step's loss within
# F32_LOSS_REL_TOL and gradients within GRAD_F32_RMS_TOL / GRAD_F32_MIN_COS),
# the timings at bs 32
V2_SIZE = 256
V2_CHECK_BATCH, V2_TIMED_BATCH = 8, 32
V2_F32_LOGIT_TOL = 1e-4
# the bench phase: picklebot_tpu_torch.bench in this process, so that the
# launch counts of each run can be read
BENCH_RUNS = (
    ["--model", "MobileNetLarge3D", "--mode", "infer", "--batch", "16",
     "--steps", "10"],
    ["--model", "MobileNetLarge3D", "--mode", "infer", "--batch", "16",
     "--steps", "10", "--baked"],
    ["--model", "MobileViTV2", "--mode", "train", "--batch", "32",
     "--size", "256", "--steps", "5"],
)
# surface: native-resolution clips resized in the predictor to 224, the
# resize held card vs CPU in f32 (TF32 off) on [0, 1] pixels; the exported
# program at these batches; the HTTP server's load (clients, POSTs, the
# --batch-window values, the body cap of its 413 probe); the phase's own
# time limit
SURFACE_NATIVE = (32, 720, 1280)
SURFACE_SIZE = 224
RESIZE_ABS_TOL = 1e-5
SURFACE_EXPORT_BATCHES = (1, 3, 8)
HTTP_CLIENTS, HTTP_POSTS = 8, 32
HTTP_WINDOWS = (10.0, 0.0)
HTTP_MAX_BODY = 8 << 20
SURFACE_MAX_S = 60.0
# tooling: the native collate at the loader's shapes (8 ragged uint8
# clips of 20-40 frames, 224x224, windowed to max_frames); the committed
# mp4 fixture and its OpenCV-decoded frames; the CLI on MobileNetLarge3D
# cut as the train phase's (32 clips: 4 train, 4 eval batches) with the
# autotuner, cProfile and the torch.profiler trace on; the autotuner's
# readings; the summary's totals (PERF.md section 4); the phase's limit,
# twice the 60 s it is meant to take: on an NVIDIA H100 80GB HBM3 at
# 700 W it read 53.4-77.9 s, most of it the traced CLI run (419k kernel
# events, a 729 MB trace), whose host's speed moved 1.5x between runs
TOOLING_CLIPS, TOOLING_T, TOOLING_MAX_FRAMES = 8, (20, 40), 32
FIXTURE = os.path.join(ROOT, "tests", "data", "clip_10x32x48.mp4")
FIXTURE_RGB = os.path.join(ROOT, "tests", "data", "clip_10x32x48_rgb.npy")
TOOLING_CUTS = dict(TRAIN_CUTS, synthetic_len=32, autotune=True)
TOOLING_STEPS = 2
SUMMARY_TOTALS = {"MobileNetLarge3D": 4_205_675, "MobileViT-s": 8_453_136}
TOOLING_MAX_S = 120.0
# dp: MobileNetLarge3D at full width under data parallelism on the one
# card, DP_STEPS steps per run at a constant lr: NCCL at world 1 (bs 8 in
# 2 microbatches, bf16, AdamW8bit), and two processes sharing the card
# over gloo (each rank bs 4 of a global bs-8 batch, one microbatch) in
# each of DP_JOBS: (name, ZeRO stage, dtype, optimizer). f32 runs with
# TF32 off; one that is not bit-equal to its reference must lie within
# DP_F32_REL_TOL of each tensor's max|ref|, a bf16 one's losses within
# TRAIN_LOSS_REL_TOL. A rank is killed past DP_RANK_TIMEOUT seconds.
DP_STEPS, DP_LR = 2, 3e-4
DP_JOBS = (("dp_f32", 0, "f32", "adamw"), ("z1_f32", 1, "f32", "adamw"),
           ("z3_f32", 3, "f32", "adamw"),
           ("dp_bf16", 0, "bf16", "adamw8bit"),
           ("z1_bf16", 1, "bf16", "adamw8bit"),
           ("z3_bf16", 3, "bf16", "adamw8bit"))
DP_F32_REL_TOL = 1e-5
DP_RANK_TIMEOUT = 240
# the layouts phase: MobileViT-s at full width (seed 0) over two
# processes of this script sharing the card over gloo, laid out as the
# mesh of each of LAYOUT_MODES, LAYOUT_STEPS steps of one bs-8 microbatch
# (the train phase's synthetic clips) at lr LAYOUT_LR with the global-norm
# clip at LAYOUT_CLIP, in each of LAYOUT_JOBS (name, dtype, optimizer),
# against the same steps in one process on the card. f32 (TF32 off): the
# first step's loss within LAYOUT_F32_REL_TOL; the model-2 run's
# first-step gradients within LAYOUT_F32_REL_TOL of each tensor's max|ref|
# of the one-process step that computes the FFN in the ranks' two slices
# (``ffn_in_halves``: the same arithmetic, so bit equality is expected);
# both layouts' gradients against the plain one-process step within
# LAYOUT_FLOOR_FACTOR times the f32 floor that this run measures between
# those two one-process steps (two reassociations of the same sums,
# amplified through the train-mode BatchNorms: 2.5e-5 on a stem
# BatchNorm's bias on an NVIDIA H100), and never tighter than
# LAYOUT_F32_REL_TOL; the weights after each step within Adam's bound
# (its first steps move a weight by about lr * sign(g), so a gradient at
# noise level may flip: LAYOUT_ADAM_LRS * lr per step). bf16 (AdamW8bit):
# the losses within TRAIN_LOSS_REL_TOL. The ranks' weights must be equal.
LAYOUT_STEPS, LAYOUT_LR, LAYOUT_CLIP = 2, 3e-4, 1.0
LAYOUT_JOBS = (("f32", "f32", "adamw"), ("bf16", "bf16", "adamw8bit"))
LAYOUT_MODES = {"tp": {"model": 2}, "sp": {"seq": 2}}
LAYOUT_F32_REL_TOL = 1e-5
LAYOUT_ADAM_LRS = 2.0
LAYOUT_FLOOR_FACTOR = 2.0
LAYOUT_RANK_TIMEOUT = 240
# MobileViT-s's transformer stages at bs 8: (N, embed width, FFN width
# multiple, layers); 8 heads of 16; the collective figures of the layouts
# and pp_ep phases follow from them
VIT_STAGES = ((784, 144, 2, 2), (147, 192, 4, 4), (32, 240, 4, 3))
# the pp_ep phase: the layouts phase's model, batch, steps, lr and clip
# over two processes of this script sharing the card over gloo, at pipe 2
# (mode "pp": pipeline_microbatches 2 and 4; stages 1 and 2 pipeline,
# stage 3's depth 3 runs the plain loop) and at expert 2 (mode "ep":
# MobileViT-s with PPEP_MOE's experts, dispatch 'replicated' and
# 'tokens'), each job (model options, dtype, optimizer) against the same
# steps in one process on the card. f32: each run against the
# one-process step with the layout's arithmetic (``stacks_in_microbatches``
# for PP, ``moe_as_ranks`` for EP) within LAYOUT_F32_REL_TOL, and against
# its plain reference (the one-process step; for 'tokens' the one that
# routes the ranks' token groups, ``moe_in_groups``) within
# LAYOUT_FLOOR_FACTOR times the floor this run measures between the two
# one-process steps, and never tighter than LAYOUT_F32_REL_TOL (the
# split reassociates batch sums that reach the BatchNorm affine terms, as
# the layouts phase found); bf16 (AdamW8bit): the losses within
# TRAIN_LOSS_REL_TOL. Flash launches per PP train step: a
# pipelined stack runs each of its rank's d/2 layers on every one of the
# M + 1 ticks, forward and backward; the plain loop d.
PPEP_MOE = {"moe_experts": 4, "moe_top_k": 2, "moe_capacity_factor": 1.25}
PPEP_JOBS = {
    "pp": {f"m{m}_{dtype}": ({"pipeline_microbatches": m}, dtype, opt)
           for m in (2, 4)
           for dtype, opt in (("f32", "adamw"), ("bf16", "adamw8bit"))},
    "ep": {f"{short}_{dtype}": ({"moe_dispatch": dispatch}, dtype, opt)
           for short, dispatch in (("rep", "replicated"), ("tok", "tokens"))
           for dtype, opt in (("f32", "adamw"), ("bf16", "adamw8bit"))}}
PPEP_FLASH_PP = {m: sum((d // 2) * (m + 1) if d % 2 == 0 else d
                        for *_, d in VIT_STAGES) for m in (2, 4)}
# what --only can pick; with no --only every phase runs
PHASES = ("kernels", "fused", "conv", "flash", "serve", "train", "trainx",
          "timing", "stream", "v2", "bench", "surface", "tooling", "dp",
          "layouts", "pp_ep")


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sm_clocks():
    """The card's SM clock now and its maximum (MHz), as nvidia-smi reads
    them: device times move with the clock, so rows carry it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    now, top = out.stdout.strip().splitlines()[0].split(",")
    return {"sm_mhz": int(now), "sm_max_mhz": int(top)}


def time_ms(fn, reps=5):
    """Mean ms of ``fn`` over ``reps`` runs by CUDA events, after one
    warm-up run."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(fn, reps, runs=5):
    """The median of ``runs`` ``time_ms`` readings: a call whose event
    time is the host's moves from reading to reading."""
    return sorted(time_ms(fn, reps) for _ in range(runs))[runs // 2]


def device_ms(fn, reps=5, tries=3):
    """Mean device time (ms) per call of the kernels ``fn`` launches, from
    a torch.profiler trace of ``reps`` calls after one warm-up call: their
    own time, without the gaps that host work leaves between launches. A
    trace can come back without device events (one on an H100 did), so up
    to ``tries`` traces are taken; None if none held any."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans:
            return sum(spans) / 1e3 / reps
    return None


def roofline(nbytes, flops, dtype_name):
    """Least time (ms) on an H100: max(bytes / 3.35 TB/s, FLOPs / peak)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def bound(shape, k, s, e, co, elem, pass_):
    """Least time for one fused-bottleneck pass at this geometry. Bytes:
    the input frames the output reads, the weights and the output, once
    each (no expanded tensor). FLOPs: expand over those frames, depthwise,
    and for the main pass the scale and projection (the pool pass's
    recompute is its own row)."""
    from picklebot_tpu_torch.ops.fused_bottleneck import out_shape
    b, t, h, w, c = shape
    to, ho, wo = out_shape(t, h, w, k, s)
    p = k // 2
    frames = b * sum(1 for i in range(to) if 0 <= i * s - p < t)
    nbytes = frames * h * w * c * elem + (c * e + k * k * e) * elem
    flops = 2 * frames * (h * w * c * e + ho * wo * k * k * e)
    if pass_ == "main":
        nbytes += e * co * elem + b * e * 4 + b * to * ho * wo * co * elem
        flops += frames * ho * wo * (e + 2 * e * co)
    else:
        nbytes += b * e * 4
        flops += frames * ho * wo * e
    return roofline(nbytes, flops, "bfloat16" if elem == 2 else "float32")


def flash_bound(s, h, n, d, elem, with_lse):
    """Least time for one flash-attention forward: Q, K, V read and O
    (and the f32 lse) written once; 4*N^2*D useful FLOPs per (sequence,
    head), QK^T and PV."""
    nbytes = 4 * s * h * n * d * elem + (s * h * n * 4 if with_lse else 0)
    flops = 4 * s * h * n * n * d
    return dict(roofline(nbytes, flops, "bfloat16" if elem == 2
                         else "float32"), flops=flops)


def flash_bwd_bound(s, h, n, d, elem, which):
    """Least time for the flash backward: 'dq' reads q, k, v, dO, lse and
    D and writes dq, 6*N^2*D FLOPs per head (S, dP, dQ); 'dkv' the same
    reads, dk and dv written, 8*N^2*D (S, dP, dV, dK); 'pair' the whole
    function, q, k, v, dO read and dq, dk, dv written, S, dP, dV, dQ and
    dK once: 10*N^2*D."""
    tensors, flops = {"dq": (5, 6), "dkv": (6, 8), "pair": (7, 10)}[which]
    nbytes = tensors * s * h * n * d * elem + 2 * s * h * n * 4
    flops *= s * h * n * n * d
    return dict(roofline(nbytes, flops, "bfloat16" if elem == 2
                         else "float32"), flops=flops)


def make_case(shape, k, e, co, dtype, seed):
    """Seeded input and weights on the card, scaled like the model's
    (U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights, input in [0, 1))."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]

    def u(*size, fan_in):
        b = fan_in ** -0.5
        return ((torch.rand(*size, generator=g, device="cuda") * 2 - 1)
                * b).to(dtype)

    x = torch.rand(*shape, generator=g, device="cuda").to(dtype)
    r = e // 4
    return x, dict(w1=u(c, e, fan_in=c), wd=u(k, k, e, fan_in=k * k),
                   w2=u(e, co, fan_in=e), se_w1=u(e, r, fan_in=e),
                   se_b1=u(r, fan_in=e), se_w2=u(r, e, fan_in=r),
                   se_b2=u(e, fan_in=r))


def library_chain(x, w, k, s, scale, project):
    """The unfused chain as cuDNN convolutions on the channels-last
    layout (timed as a yardstick only; the port never calls it)."""
    import torch.nn.functional as F
    e = w["w1"].shape[1]
    xc = x.permute(0, 4, 1, 2, 3)             # channels_last_3d view
    h = F.conv3d(xc, w["w1"].t().reshape(e, -1, 1, 1, 1))
    d = F.conv3d(h, w["wd"].permute(2, 0, 1).reshape(e, 1, 1, k, k),
                 stride=s, padding=k // 2, groups=e)
    if not project:
        return d.float().sum(dim=(2, 3, 4))
    d = d * scale.to(d.dtype)[:, :, None, None, None]
    return F.conv3d(d, w["w2"].t().reshape(-1, e, 1, 1, 1))


def check_close(name, got, want, rel_tol, abs_tol=0.0):
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    ok = err <= rel_tol * ref + abs_tol + 1e-6
    if not ok:
        raise AssertionError(f"{name}: max abs err {err} > {rel_tol} * "
                             f"max|ref| {ref} + {abs_tol}")
    return err, ref


def check_bf16_flash(name, got, want):
    """bf16 flash output against its plain version: max abs err within
    BF16_REL_TOL of max|ref| and rms err within BF16_RMS_TOL of rms(ref)."""
    err, ref = check_close(name, got, want, BF16_REL_TOL)
    rms_err = (got.float() - want.float()).pow(2).mean().sqrt().item()
    rms_ref = want.float().pow(2).mean().sqrt().item()
    if rms_err > BF16_RMS_TOL * rms_ref:
        raise AssertionError(f"{name}: rms err {rms_err} > {BF16_RMS_TOL} "
                             f"* rms(ref) {rms_ref}")
    return dict(err=err, max_ref=ref, rms_err=rms_err, rms_ref=rms_ref)


def fused_rows(model, geometries, seed0, reps):
    """The fused-bottleneck kernels against their plain versions at each
    geometry (bf16): the check, the plan, two more calls bit-equal, kernel,
    plain and cuDNN-chain times by CUDA events, the kernel's device time
    from a trace and the SM clock after it. A split launch is also held
    against the plain version of its order (``pool_split_reference``, f32
    with TF32 off, to F32_REL_TOL: the same f32 values summed in another
    order; ``main_split_reference`` to the bf16 flash bounds)."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.ops import fused_bottleneck as fb

    def timed(name, fn, plain, lib, plan, extra):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            raise AssertionError(f"{name}: two calls differ")
        return dict(extra, plan=plan._asdict(), bit_equal_repeat=True,
                    ms=time_ms(fn, reps), plain_ms=time_ms(plain, reps),
                    library_ms=time_ms(lib, reps),
                    device_ms=device_ms(fn, reps),
                    clocks_after_trace=sm_clocks())

    rows, per = [], {"pool": [], "main": []}
    for i, (shape, k, s, se, e, co) in enumerate(geometries):
        x, w = make_case(shape, k, e, co, torch.bfloat16, seed=seed0 + i)
        b, t, h, wd_, c = shape
        to, ho, wo = fb.out_shape(t, h, wd_, k, s)
        row = {"model": model, "block": i, "x": list(shape), "k": k,
               "s": s, "se": se, "E": e, "out": [b, to, ho, wo, co]}
        if se:
            name = f"{model} pool block {i}"
            plan = fb._pool_plan(tuple(shape), k, s, e, x.dtype)
            want = fb.pool_reference(x, w["w1"], w["wd"], k, s)
            got = fb.fused_pool(x, w["w1"], w["wd"], k, s)
            torch.cuda.synchronize()
            err, ref = check_close(name, got, want, BF16_REL_TOL)
            extra = {}
            if plan.splits > 1:
                with DtypePolicy.f32().precision():
                    split_want = fb.pool_split_reference(x, w["w1"],
                                                         w["wd"], k, s, plan)
                extra["err_vs_split_plain"] = check_close(
                    f"{name} (split plain)", got, split_want,
                    F32_REL_TOL)[0]
            per["pool"].append(dict(err=err, **bound(
                shape, k, s, e, co, 2, "pool"), **timed(
                name, lambda: fb.fused_pool(x, w["w1"], w["wd"], k, s),
                lambda: fb.pool_reference(x, w["w1"], w["wd"], k, s),
                lambda: library_chain(x, w, k, s, None, False), plan,
                extra)))
            row["pool"] = dict(per["pool"][-1], max_ref=ref)
            scale = fb.se_scale(want / float(to * ho * wo), w["se_w1"],
                                w["se_b1"], w["se_w2"], w["se_b2"],
                                x.dtype)
        else:
            scale = torch.ones((b, e), device="cuda")
        name = f"{model} main block {i}"
        plan = fb._main_plan(tuple(shape), k, s, e, co, x.dtype)
        want = fb.main_reference(x, w["w1"], w["wd"], w["w2"], scale, k, s)
        got = fb.fused_main(x, w["w1"], w["wd"], w["w2"], scale, k, s)
        torch.cuda.synchronize()
        if tuple(got.shape) != (b, to, ho, wo, co):
            raise AssertionError(f"{name}: shape {got.shape}")
        err, ref = check_close(name, got, want, BF16_REL_TOL)
        extra = {}
        if plan.splits > 1:
            with DtypePolicy.f32().precision():
                split_want = fb.main_split_reference(
                    x, w["w1"], w["wd"], w["w2"], scale, k, s, plan.splits)
            extra["vs_split_plain"] = check_bf16_flash(
                f"{name} (split plain)", got, split_want)
        per["main"].append(dict(err=err, **bound(
            shape, k, s, e, co, 2, "main"), **timed(
            name, lambda: fb.fused_main(x, w["w1"], w["wd"], w["w2"],
                                        scale, k, s),
            lambda: fb.main_reference(x, w["w1"], w["wd"], w["w2"], scale,
                                      k, s),
            lambda: library_chain(x, w, k, s, scale, True), plan, extra)))
        row["main"] = dict(per["main"][-1], max_ref=ref)
        emit({"phase": "kernels", **row})
        rows.append(row)
        del x, w, got, want
    return rows, per


def fused_f32_case():
    """One f32 case, TF32 off, tight tolerance: block3[0] (k5, s2, SE)."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.ops import fused_bottleneck as fb
    shape, k, s, se, e, co = GEOMETRIES[3]
    x, w = make_case(shape, k, e, co, torch.float32, seed=100)
    with DtypePolicy.f32().precision():
        want_p = fb.pool_reference(x, w["w1"], w["wd"], k, s)
        got_p = fb.fused_pool(x, w["w1"], w["wd"], k, s)
        scale = torch.rand(want_p.shape, device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(101))
        want_m = fb.main_reference(x, w["w1"], w["wd"], w["w2"], scale, k,
                                   s)
        got_m = fb.fused_main(x, w["w1"], w["wd"], w["w2"], scale, k, s)
        torch.cuda.synchronize()
    f32 = {"pool": check_close("pool f32", got_p, want_p, F32_REL_TOL)[0],
           "main": check_close("main f32", got_m, want_m, F32_REL_TOL)[0]}
    emit({"phase": "kernels", "f32_case": "block3.0", "max_abs_err": f32,
          "rel_tol": F32_REL_TOL})


def seeded_qkv(n, dtype, seed):
    """A seeded (64, N, 3*128) qkv projection output on the card: its
    chunk(3, -1) views are q, k, v as MultiHeadAttention hands them on,
    its (64, N, 3, H, D) view the 'pallas_packed' layout."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(VIT_SEQS, n, 3 * VIT_HEADS * VIT_DHEAD, generator=g,
                       device="cuda").to(dtype)


def flash_rows(reps):
    """The flash forward kernel against its plain versions at MobileViT-s's
    shapes (bf16): packed without lse at every stage (N=147 and 32 ragged)
    and with lse at stage 1, per head at every stage and at N=100 (a
    ragged tile inside a warp's rows), qkv-packed at stage 1. Each row:
    the check, two more calls bit-equal, the plan, kernel, plain and SDPA
    times by CUDA events, kernel and SDPA device times from a trace (at
    N=147 and 32 a call's host work outlasts its kernel), the SM clock
    after the traces, TFLOP/s on the 4*N^2*D FLOPs per head, and the
    ratios to bound and SDPA. Then f32 with TF32 off (packed with lse at
    stage 1, per head and qkv-packed at N=147, the last key tile ragged),
    and per head at head dims 32 and 64 (bf16). Rows carry the entry
    point and the ``LAUNCHES`` key it counts under."""
    import torch
    import torch.nn.functional as F
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.ops import flash_attention as fa

    h, d = VIT_HEADS, VIT_DHEAD
    scale = d ** -0.5
    rows = []

    def sdpa_lib(q4, k4, v4):      # yardstick only; the port never calls it
        return F.scaled_dot_product_attention(q4, k4, v4, scale=scale)

    def heads_of(qkv5):            # (S, N, 3, H, D) -> q, k, v (S, H, N, D)
        return [qkv5.select(-3, i).transpose(-2, -3) for i in range(3)]

    def held(row, fn, plain, lib, with_lse):
        """Check one bf16 case against its plain version, then time it."""
        name = f"flash {row['entry']} bf16 n={row['n']}" + (
            " (lse)" if with_lse else "")
        got, want = fn(), plain()
        torch.cuda.synchronize()
        if with_lse:
            row["lse_err"] = check_close(f"{name} lse", got[1], want[1],
                                         0.0, LSE_ABS_TOL)[0]
            got, want = got[0], want[0]
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)}")
        row.update(check_bf16_flash(name, got, want))
        first, second = fn(), fn()
        torch.cuda.synchronize()
        row["bit_equal_repeat"] = all(
            torch.equal(a, b) for a, b in zip(
                first if with_lse else [first],
                second if with_lse else [second]))
        if not row["bit_equal_repeat"]:
            raise AssertionError(f"{name}: two calls differ")
        n = row["n"]
        row.update(flash_bound(VIT_SEQS, h, n, d, 2, with_lse),
                   plan=fa._forward_plan((VIT_SEQS, h, n, d),
                                         torch.bfloat16)._asdict(),
                   ms=time_ms(fn, reps), plain_ms=time_ms(plain, reps),
                   library_ms=time_ms(lib, reps),
                   device_ms=device_ms(fn, reps),
                   library_device_ms=device_ms(lib, reps),
                   clocks_after_traces=sm_clocks())
        for pre in ("", "device_"):
            t, t_lib = row[f"{pre}ms"], row[f"library_{pre}ms"]
            row[f"{pre}tflops"] = (None if t is None
                                   else row["flops"] / t / 1e9)
            row[f"{pre}x_bound"] = None if t is None else t / row["bound_ms"]
            row[f"{pre}x_library"] = (None if t is None or t_lib is None
                                      else t / t_lib)
        emit({"phase": "kernels", "flash": "fwd", **row})
        rows.append(row)

    # packed, bf16: without lse at every stage, with lse at stage 1
    for n, with_lse in [(n_, False) for n_, _ in VIT_ATTENTION] + [
            (VIT_ATTENTION[0][0], True)]:
        q, k, v = seeded_qkv(n, torch.bfloat16, seed=200 + n).chunk(3, -1)
        split = [fa.split_heads(t, h) for t in (q, k, v)]
        held({"entry": "packed", "kernel": "packed", "n": n,
              "dtype": "bfloat16", "lse": with_lse},
             lambda: fa.flash_attention_packed(q, k, v, h,
                                               with_lse=with_lse),
             lambda: fa.flash_attention_packed_reference(
                 q, k, v, h, with_lse=with_lse),
             lambda: sdpa_lib(*split), with_lse)
        del q, k, v, split

    # per head, every stage and N=100, bf16, on the split heads' views
    for n in sorted({n_ for n_, _ in VIT_ATTENTION} | {100}, reverse=True):
        split = [fa.split_heads(t, h) for t in seeded_qkv(
            n, torch.bfloat16, seed=300 + n).chunk(3, dim=-1)]
        held({"entry": "heads", "kernel": "heads", "n": n,
              "dtype": "bfloat16", "lse": False},
             lambda: fa.flash_attention(*split),
             lambda: fa.flash_attention_reference(*split),
             lambda: sdpa_lib(*split), False)
        del split

    # qkv-packed ('pallas_packed'), stage 1, bf16: q, k, v read in place
    # from the (64, N, 3, H, D) view of one projection output
    n = VIT_ATTENTION[0][0]
    qkv5 = seeded_qkv(n, torch.bfloat16, seed=350).unflatten(-1, (3, h, d))
    if tuple(fa.flash_attention_qkvpacked(qkv5).shape) != (VIT_SEQS, n, h,
                                                           d):
        raise AssertionError("flash qkv-packed: output shape")
    held({"entry": "qkvpacked", "kernel": "heads", "n": n,
          "dtype": "bfloat16", "lse": False},
         lambda: fa.flash_attention_qkvpacked(qkv5),
         lambda: fa.flash_attention_qkvpacked_reference(qkv5),
         lambda: sdpa_lib(*heads_of(qkv5)), False)
    del qkv5

    # f32, TF32 off
    f32 = {}
    with DtypePolicy.f32().precision():
        q, k, v = seeded_qkv(VIT_ATTENTION[0][0], torch.float32,
                             seed=400).chunk(3, dim=-1)
        want, want_lse = fa.flash_attention_packed_reference(
            q, k, v, h, with_lse=True)
        got, lse = fa.flash_attention_packed(q, k, v, h, with_lse=True)
        f32["packed n=784"] = check_close("flash packed f32", got, want,
                                          FLASH_F32_REL_TOL)[0]
        f32["packed n=784 lse"] = check_close(
            "flash packed f32 lse", lse, want_lse, 0.0, LSE_ABS_TOL)[0]
        qkv = seeded_qkv(147, torch.float32, seed=401)
        split = [fa.split_heads(t, h) for t in qkv.chunk(3, dim=-1)]
        f32["heads n=147"] = check_close(
            "flash per-head f32 n=147", fa.flash_attention(*split),
            fa.flash_attention_reference(*split), FLASH_F32_REL_TOL)[0]
        qkv5 = qkv.unflatten(-1, (3, h, d))
        f32["qkvpacked n=147"] = check_close(
            "flash qkv-packed f32 n=147", fa.flash_attention_qkvpacked(qkv5),
            fa.flash_attention_qkvpacked_reference(qkv5),
            FLASH_F32_REL_TOL)[0]
    emit({"phase": "kernels", "f32_case": "flash", "max_abs_err": f32,
          "rel_tol": FLASH_F32_REL_TOL, "lse_abs_tol": LSE_ABS_TOL})
    del q, k, v, want, want_lse, got, lse, qkv, split, qkv5

    # the kernel's other head dims (MobileViT uses 16): per head, bf16,
    # N=147, H*D = 128
    dims = {}
    for dh in (32, 64):
        split = [fa.split_heads(t, VIT_HEADS * VIT_DHEAD // dh)
                 for t in seeded_qkv(147, torch.bfloat16,
                                     seed=500 + dh).chunk(3, dim=-1)]
        dims[f"d={dh}"] = check_bf16_flash(
            f"flash per-head bf16 d={dh}", fa.flash_attention(*split),
            fa.flash_attention_reference(*split))
    emit({"phase": "kernels", "head_dims_case": "flash per-head n=147",
          **dims})
    return rows


def packed_route_sweep(reps):
    """'auto''s two routes at each N of SWEEP_N (64 sequences x 8 heads x
    16, bf16, q, k and v the chunks of one qkv projection output, as
    MultiHeadAttention hands them on): the head-packed kernel
    (``flash_attention_packed``) against the plain route (``sdpa`` on split
    heads, merged), the forward alone and forward + backward
    (``FlashPackedFn`` against autograd through ``sdpa``), each by CUDA
    events and by device time from a trace. The two routes' outputs are
    held against each other at the flash bf16 bound; their input grads'
    distance is reported. Event times are the median of five readings
    (at small N they are the host's). The pick: the smallest swept N from
    which the kernel route is faster in all four times, at that N and at
    every larger one (None if at none)."""
    import torch
    from picklebot_tpu_torch.ops import attention
    from picklebot_tpu_torch.ops import flash_attention as fa

    h, d = VIT_HEADS, VIT_DHEAD
    scale = d ** -0.5
    rows = []
    for n in SWEEP_N:
        qkv = seeded_qkv(n, torch.bfloat16, seed=900 + n)
        g = torch.randn(VIT_SEQS, n, h * d, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(
                            901 + n)).to(torch.bfloat16)
        leaf = qkv.detach().requires_grad_()

        def kernel_route(t):
            return fa.flash_attention_packed(*t.chunk(3, dim=-1), h, scale)

        def sdpa_route(t):
            q, k, v = (fa.split_heads(x, h) for x in t.chunk(3, dim=-1))
            return fa.merge_heads(fa.sdpa(q, k, v, scale))

        def fwd_bwd(route):
            return lambda: torch.autograd.grad(route(leaf), leaf, g)[0]
        calls = {"kernel_fwd": lambda: kernel_route(qkv),
                 "sdpa_fwd": lambda: sdpa_route(qkv),
                 "kernel_fwd_bwd": fwd_bwd(kernel_route),
                 "sdpa_fwd_bwd": fwd_bwd(sdpa_route)}
        row = {"n": n, "out": check_bf16_flash(
            f"sweep n={n} packed kernel against sdpa route",
            calls["kernel_fwd"](), calls["sdpa_fwd"]())}
        dq_k, dq_s = calls["kernel_fwd_bwd"](), calls["sdpa_fwd_bwd"]()
        row["grad_rms_err_over_rms"] = ((dq_k.float() - dq_s.float()).pow(
            2).mean().sqrt() / dq_s.float().pow(2).mean().sqrt()).item()
        for name, fn in calls.items():
            row[f"ms_{name}"] = median_ms(fn, reps)
            row[f"device_ms_{name}"] = device_ms(fn, reps)
        times = [(row[f"{pre}ms_kernel_{w}"], row[f"{pre}ms_sdpa_{w}"])
                 for pre in ("", "device_") for w in ("fwd", "fwd_bwd")]
        row["kernel_faster"] = all(None not in t and t[0] < t[1]
                                   for t in times)
        emit({"phase": "kernels", "sweep": "packed_min_seq", **row})
        rows.append(row)
        del qkv, g, leaf, dq_k, dq_s
    pick = None
    for row in reversed(rows):
        if not row["kernel_faster"]:
            break
        pick = row["n"]
    out = {"phase": "kernels", "sweep": "packed_min_seq", "n": list(SWEEP_N),
           "pick": pick, "port_packed_min_seq": attention._PACKED_MIN_SEQ,
           "clocks": sm_clocks()}
    emit(out)
    return dict(out, rows=rows)


def flash_bwd_case(layout, n, dtype, seed, dh=VIT_DHEAD):
    """One flash backward case on MobileViT-s's stage shapes: seeded
    q, k, v (views of one qkv projection) and output gradient, the
    Function's grads (forward kernel with lse, D, dQ and dK/dV kernels;
    ``run`` computes them again), the plain backward's from the same
    forward residuals, and, but for qkv-packed, per-kernel launchers on
    the kernels' (S, H, N, D) views, the D pass and the kernels' plan, for
    timing."""
    import torch
    from picklebot_tpu_torch.ops import flash_attention as fa
    h, scale = VIT_HEADS * VIT_DHEAD // dh, dh ** -0.5
    qkv = seeded_qkv(n, dtype, seed).requires_grad_()
    g = torch.randn(VIT_SEQS, n, h * dh, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        seed + 1)).to(dtype)
    if layout == "qkvpacked":
        qkv5 = qkv.unflatten(-1, (3, h, dh))
        g5 = g.unflatten(-1, (h, dh))

        def run():
            return [t.transpose(-2, -3) for t in torch.autograd.grad(
                fa.flash_attention_qkvpacked(qkv5), qkv5, g5)[0].unbind(-3)]
        q, k, v = fa._qkv_split(qkv5.detach())
        out, lse = fa._qkvpacked_forward(qkv5.detach(), scale, True)
        want = fa.flash_backward_reference(q, k, v, out.transpose(-2, -3),
                                           lse, g5.transpose(-2, -3), scale)
        return dict(got=run(), want=want, run=run)
    q, k, v = qkv.chunk(3, dim=-1)
    if layout == "packed":
        def run():
            return [fa.split_heads(t, h) for t in torch.autograd.grad(
                fa.flash_attention_packed(q, k, v, h), (q, k, v), g)]
        with torch.no_grad():
            out, lse = fa.flash_attention_packed(q, k, v, h, with_lse=True)
    else:
        q, k, v = (fa.split_heads(t, h) for t in (q, k, v))
        g = fa.split_heads(g, h)

        def run():
            return torch.autograd.grad(fa.flash_attention(q, k, v),
                                       (q, k, v), g)
        with torch.no_grad():
            out, lse = fa._heads_forward(q, k, v, scale, True)
    heads = [fa.split_heads(t, h) if layout == "packed" else t
             for t in (q.detach(), k.detach(), v.detach(), out, g)]
    want = fa.flash_backward_reference(*heads[:4], lse, heads[4], scale)
    # the kernels' own views, D and output buffers, for the timed launches
    bufs = [torch.empty_like(t) for t in heads[:3]]
    q4, k4, v4, o4, g4, *out4 = (fa._as_seq_head(t) for t in heads + bufs)
    lse3 = lse.reshape(q4.shape[:3])
    dd = fa._backward_d(o4, g4)

    def launch(name):
        fa._launch_backward_kernel(name, q4, k4, v4, g4, lse3, dd, *out4,
                                   scale)
    return dict(got=run(), want=want, run=run, launch=launch, heads=heads,
                lse=lse, d_pass=lambda: fa._backward_d(o4, g4),
                plan=fa._backward_plan(q4.shape, q4.dtype))


def bitwise_repeatable(c):
    """Two more backward calls of a case give gradients equal bit for bit
    to each other (no atomics: the order of every sum is fixed)."""
    import torch
    first, second = c["run"](), c["run"]()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, second))


def flash_bwd_rows(reps):
    """The flash backward kernels against ``flash_backward_reference`` at
    MobileViT-s's attention shapes: packed at the stages 'auto' sends to
    the packed kernel (VIT_PACKED) and per head at every stage (bf16, with
    the plan, dQ, dK/dV and D-pass times by CUDA events and from a trace,
    plain and library times, TFLOP/s against the
    pair's bound, and two more calls bit-equal), qkv-packed at stage 1
    (bf16, bit-equal too), f32 with TF32 off (packed at stage 1, per head
    at N=147, a ragged last tile), head dims 32 and 64 (bf16, per head,
    N=147). Library: autograd through F.scaled_dot_product_attention on
    the same tensors, its backward alone, set against D + dQ + dK/dV."""
    import torch
    import torch.nn.functional as F
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.ops import flash_attention as fa

    h, d = VIT_HEADS, VIT_DHEAD
    rows = []

    def held(name, got, want, f32=False):
        out = {}
        for part, a, b in zip(("dq", "dk", "dv"), got, want):
            if f32:
                out[part] = dict(err=check_close(
                    f"{name} {part}", a, b, FLASH_F32_REL_TOL)[0])
            else:
                out[part] = check_bf16_flash(f"{name} {part}", a, b)
        torch.cuda.synchronize()
        return out

    for layout, n, seed in [("packed", n_, 600 + n_) for n_ in VIT_PACKED] + [
            ("heads", n_, 610 + n_) for n_, _ in VIT_ATTENTION]:
        c = flash_bwd_case(layout, n, torch.bfloat16, seed)
        errs = held(f"flash bwd {layout} bf16 n={n}", c["got"], c["want"])
        q, k, v, o, g = c["heads"]
        lib_in = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib_in, scale=d ** -0.5)

        def lib_backward():
            torch.autograd.grad(lib_out, lib_in, g, retain_graph=True)
        calls = {"dq": lambda: c["launch"]("dq"),
                 "dkv": lambda: c["launch"]("dkv"), "d": c["d_pass"]}
        row = {"entry": layout, "n": n, "dtype": "bfloat16", **errs,
               "err": max(e["err"] for e in errs.values()),
               "plan": c["plan"]._asdict(),
               "bit_equal_repeat": bitwise_repeatable(c),
               **{f"ms_{k_}": time_ms(f, reps) for k_, f in calls.items()},
               "plain_ms": time_ms(lambda: fa.flash_backward_reference(
                   q, k, v, o, c["lse"], g, d ** -0.5), reps),
               "library_ms": time_ms(lib_backward, reps),
               **{f"device_ms_{k_}": device_ms(f, reps)
                  for k_, f in calls.items()},
               "library_device_ms": device_ms(lib_backward, reps),
               "clocks_after_traces": sm_clocks()}
        if not row["bit_equal_repeat"]:
            raise AssertionError(f"flash bwd {layout} n={n}: two backward "
                                 "calls differ")
        for which in ("dq", "dkv", "pair"):
            row[f"bound_{which}"] = flash_bwd_bound(VIT_SEQS, h, n, d, 2,
                                                    which)
        # the whole backward (D pass, dQ, dK/dV) against SDPA's, and the
        # pair's rate on the function's 10*N^2*D FLOPs per head
        for pre in ("", "device_"):
            parts = [row[f"{pre}ms_{k_}"] for k_ in calls]
            lib = row[f"library_{pre}ms"]
            whole = None if None in parts else sum(parts)
            pair = None if None in parts else parts[0] + parts[1]
            row[f"{pre}ms_backward"] = whole
            row[f"{pre}x_library"] = (None if whole is None or lib is None
                                      else whole / lib)
            row[f"{pre}tflops_pair"] = (
                None if pair is None
                else row["bound_pair"]["flops"] / pair / 1e9)
            row[f"{pre}x_bound_pair"] = (
                None if pair is None
                else pair / row["bound_pair"]["bound_ms"])
        emit({"phase": "kernels", "kernel": "flash_bwd", **row})
        rows.append(row)
        del c, q, k, v, o, g, lib_in, lib_out

    c = flash_bwd_case("qkvpacked", VIT_ATTENTION[0][0], torch.bfloat16,
                       650)
    qkv_errs = held("flash bwd qkv-packed bf16 n=784", c["got"], c["want"])
    if not bitwise_repeatable(c):
        raise AssertionError("flash bwd qkv-packed: two backward calls "
                             "differ")
    f32 = {}
    with DtypePolicy.f32().precision():
        for layout, n in (("packed", VIT_ATTENTION[0][0]), ("heads", 147)):
            c = flash_bwd_case(layout, n, torch.float32, 660)
            f32[f"{layout} n={n}"] = held(f"flash bwd {layout} f32 n={n}",
                                          c["got"], c["want"], f32=True)
    dims = {}
    for dh in (32, 64):
        c = flash_bwd_case("heads", 147, torch.bfloat16, 670 + dh, dh=dh)
        dims[f"d={dh}"] = held(f"flash bwd per-head bf16 d={dh}", c["got"],
                               c["want"])
    emit({"phase": "kernels", "kernel": "flash_bwd",
          "qkvpacked n=784 bf16": qkv_errs, "f32": f32,
          "rel_tol_f32": FLASH_F32_REL_TOL, "head_dims": dims})
    return rows


def conv_bound(shape, co, kernel, elem):
    """Least time for the stride-1 same-padded dense conv: x and w read
    and the output written once; 2*Ci*Co FLOPs per output position and
    tap that stays inside the clip (a tap in the zero padding needs no
    arithmetic, so the count is this geometry's, not 27 per position)."""
    b, t, h, w, ci = shape

    def inside(n, k):
        return sum(max(0, n - abs(d - (k - 1) // 2)) for d in range(k))
    taps_inside = b * inside(t, kernel[0]) * inside(h, kernel[1]) * inside(
        w, kernel[2])
    m = b * t * h * w
    nbytes = (m * (ci + co) + kernel[0] * kernel[1] * kernel[2] * ci * co
              ) * elem
    flops = 2 * taps_inside * ci * co
    return dict(roofline(nbytes, flops, "bfloat16" if elem == 2
                         else "float32"), flops=flops)


def conv_case(shape, co, kernel, dtype, seed):
    """Seeded x, w (Kt, Kh, Kw, Ci, Co) and output gradient on the card, w
    scaled U(-1/sqrt(fan_in), 1/sqrt(fan_in)); the flipped weight and the
    library's weight layout for the yardstick calls."""
    import torch
    g_ = torch.Generator(device="cuda").manual_seed(seed)
    ci = shape[-1]
    bound_ = (ci * kernel[0] * kernel[1] * kernel[2]) ** -0.5
    x = torch.randn(*shape, generator=g_, device="cuda").to(dtype)
    w = ((torch.rand(*kernel, ci, co, generator=g_, device="cuda") * 2 - 1)
         * bound_).to(dtype)
    g = torch.randn(*shape[:-1], co, generator=g_, device="cuda").to(dtype)
    pads = tuple(((k - 1) // 2,) * 2 for k in kernel)
    w_flip = w.flip(0, 1, 2).transpose(-1, -2).contiguous()
    w_lib = w.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    return x, w, g, pads, w_flip, w_lib


def conv_rows(reps):
    """The conv kernel against its plain version on the card, forward and
    dx: MobileViT-s's six conv1/conv4 geometries (bf16, with the plan each
    launch takes, kernel, plain and library times, bounds, achieved
    TFLOP/s and the ratios to bound and library; kernel and library
    device times from a trace too, since at stages 2 and 3 a call's host
    work outlasts its kernels), MobileViT-xxs's widths
    and the JAX test's per-axis kernel sizes (bf16 and f32), and one f32
    case at stage 2 with TF32 off. Stage 1's forward runs unsplit and
    stage 3's split over taps (both checked here); a split case is also
    held against ``folded_conv_split_reference``, the plain version of the
    split's order. Plain: ``folded_conv_reference`` (forward; for dx on
    the output gradient with the flipped weight). Library, timed as a
    yardstick only: ``F.conv3d`` on the channels_last_3d view with the
    weight in cuDNN's layout, and ``torch.nn.grad.conv3d_input`` for dx
    (its result is also held against the kernel's)."""
    import torch
    import torch.nn.functional as F
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.ops import folded_conv as fc

    def plans(shape, co, kernel):
        m, taps = shape[0] * shape[1] * shape[2] * shape[3], (
            kernel[0] * kernel[1] * kernel[2])
        return fc._plan(m, co, taps), fc._plan(m, shape[-1], taps)

    def held(name, shape, co, kernel, dtype, seed):
        x, w, g, pads, w_flip, w_lib = conv_case(shape, co, kernel, dtype,
                                                 seed)
        assert fc.folded_conv_s1_eligible(x.shape, w.shape, (1, 1, 1), pads)
        xr = x.detach().requires_grad_()
        out = fc.folded_conv_s1(xr, w, pads)
        dx, = torch.autograd.grad(out, xr, g)
        want = fc.folded_conv_reference(x, w, pads)
        want_dx = fc.folded_conv_reference(g, w_flip, pads)
        lib_dx = torch.nn.grad.conv3d_input(
            x.permute(0, 4, 1, 2, 3).shape, w_lib, g.permute(0, 4, 1, 2, 3),
            padding=tuple(p[0] for p in pads)).permute(0, 2, 3, 4, 1)
        torch.cuda.synchronize()
        if out.shape != want.shape or dx.shape != x.shape:
            raise AssertionError(f"{name}: shapes {tuple(out.shape)}, "
                                 f"{tuple(dx.shape)}")
        if dtype == torch.bfloat16:
            errs = {"fwd": check_bf16_flash(f"{name} fwd", out, want),
                    "dx": check_bf16_flash(f"{name} dx", dx, want_dx),
                    "dx_vs_library": check_bf16_flash(f"{name} dx (library)",
                                                     dx, lib_dx)}
            plan = plans(shape, co, kernel)[0]
            if plan.splits > 1:
                errs["fwd_vs_split_plain"] = check_bf16_flash(
                    f"{name} fwd (split plain)", out,
                    fc.folded_conv_split_reference(x, w, pads, plan.splits))
        else:
            errs = {"fwd": dict(err=check_close(f"{name} fwd", out, want,
                                                F32_REL_TOL)[0]),
                    "dx": dict(err=check_close(f"{name} dx", dx, want_dx,
                                               F32_REL_TOL)[0]),
                    "dx_vs_library": dict(err=check_close(
                        f"{name} dx (library)", dx, lib_dx, F32_REL_TOL)[0])}
        return errs, (x, w, g, pads, w_flip, w_lib)

    rows = []
    for stage, ((b, t, h, w_), c) in enumerate(VIT_CONV_STAGES, 1):
        for conv, ci in (("conv1", c), ("conv4", 2 * c)):
            shape, kernel = (b, t, h, w_, ci), (3, 3, 3)
            name = f"conv stage {stage} {conv} bf16"
            plan_fwd, plan_dx = plans(shape, c, kernel)
            if (stage == 1) != (plan_fwd.splits == 1):
                raise AssertionError(f"{name}: plan {plan_fwd}; stage 1 "
                                     "must run unsplit, stage 3 split")
            errs, (x, w, g, pads, w_flip, w_lib) = held(
                name, shape, c, kernel, torch.bfloat16, 700 + 10 * stage + ci)
            xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
            row = {"stage": stage, "conv": conv, "x": list(shape), "Co": c,
                   "k": list(kernel), "dtype": "bfloat16", **errs,
                   "plan_fwd": plan_fwd._asdict(),
                   "plan_dx": plan_dx._asdict(),
                   "fwd_bound": conv_bound(shape, c, kernel, 2),
                   "dx_bound": conv_bound(shape[:-1] + (c,), ci, kernel, 2),
                   "ms_fwd": time_ms(lambda: fc._conv(x, w, pads, "fwd"),
                                     reps),
                   "ms_dx": time_ms(lambda: fc._conv(g, w_flip, pads, "dx"),
                                    reps),
                   "plain_ms_fwd": time_ms(
                       lambda: fc.folded_conv_reference(x, w, pads), reps),
                   "plain_ms_dx": time_ms(
                       lambda: fc.folded_conv_reference(g, w_flip, pads),
                       reps),
                   "library_ms_fwd": time_ms(
                       lambda: F.conv3d(xc, w_lib, padding=1), reps),
                   "library_ms_dx": time_ms(
                       lambda: torch.nn.grad.conv3d_input(
                           xc.shape, w_lib, gc, padding=1), reps)}
            row.update(
                device_ms_fwd=device_ms(lambda: fc._conv(x, w, pads, "fwd"),
                                        reps),
                device_ms_dx=device_ms(lambda: fc._conv(g, w_flip, pads,
                                                        "dx"), reps),
                library_device_ms_fwd=device_ms(
                    lambda: F.conv3d(xc, w_lib, padding=1), reps),
                library_device_ms_dx=device_ms(
                    lambda: torch.nn.grad.conv3d_input(xc.shape, w_lib, gc,
                                                       padding=1), reps))
            for which in ("fwd", "dx"):
                ms, bnd = row[f"ms_{which}"], row[f"{which}_bound"]
                row[f"tflops_{which}"] = bnd["flops"] / ms / 1e9
                row[f"x_bound_{which}"] = ms / bnd["bound_ms"]
                row[f"x_library_{which}"] = ms / row[f"library_ms_{which}"]
                dev = row[f"device_ms_{which}"]
                row[f"device_tflops_{which}"] = (
                    None if dev is None else bnd["flops"] / dev / 1e9)
            emit({"phase": "kernels", "kernel": "folded_conv", **row})
            rows.append(row)
            del x, w, g, w_flip, w_lib, xc, gc
    extra = {}
    for i, (shape, co, kernel) in enumerate(CONV_EXTRA_CASES):
        key = f"{list(shape)}->{co} k{list(kernel)}"
        extra[key] = {"bf16": held(f"conv {key} bf16", shape, co, kernel,
                                   torch.bfloat16, 800 + i)[0],
                      "plan_fwd": plans(shape, co, kernel)[0]._asdict()}
        with DtypePolicy.f32().precision():
            extra[key]["f32"] = held(f"conv {key} f32", shape, co, kernel,
                                     torch.float32, 850 + i)[0]
    with DtypePolicy.f32().precision():
        (b, t, h, w_), c = VIT_CONV_STAGES[1]
        f32 = {conv: held(f"conv stage 2 {conv} f32", (b, t, h, w_, ci), c,
                          (3, 3, 3), torch.float32, 900 + ci)[0]
               for conv, ci in (("conv1", c), ("conv4", 2 * c))}
    emit({"phase": "kernels", "kernel": "folded_conv", "f32_stage_2": f32,
          "rel_tol_f32": F32_REL_TOL, "bf16_rel_tol": BF16_REL_TOL,
          "bf16_rms_tol": BF16_RMS_TOL, "other_widths_and_kernels": extra})
    return rows


def sass_check(lib_path, kernel, must):
    """Tensor cores and registers of one built library: the count of HMMA
    instructions in each function's SASS (``cuobjdump -sass``), and
    ptxas's registers, stack frame and spill bytes for each from the build
    log. Fails if a function whose name holds one of ``must`` (the bf16
    ones) has no HMMA, spills or keeps a stack frame (an array indexed at
    run time lives in local memory without counting as a spill), or if
    there is none; the others are reported only."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    hmma, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            hmma[name] = 0
        elif name and "HMMA" in line:
            hmma[name] += 1
    ptxas, name = {}, None
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name = found.group(1)
            ptxas[name] = {}
        spills = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                           r"stores, (\d+) bytes spill loads", line)
        if name and spills:
            ptxas[name].update(stack_frame=int(spills.group(1)),
                               spill_stores=int(spills.group(2)),
                               spill_loads=int(spills.group(3)))
        regs = re.search(r"Used (\d+) registers", line)
        if name and regs:
            ptxas[name]["registers"] = int(regs.group(1))
    funcs = {n: dict(hmma=c, **ptxas.get(n, {})) for n, c in hmma.items()}
    checked = {n: v for n, v in funcs.items() if any(m in n for m in must)}
    emit({"phase": "kernels", "kernel": kernel, "sass": funcs})
    if not checked or any(v["hmma"] == 0 or v.get("spill_stores", 1)
                          or v.get("spill_loads", 1)
                          or v.get("stack_frame", 1)
                          for v in checked.values()):
        raise AssertionError(f"{kernel} functions {checked}: each needs HMMA "
                             "instructions, no spills and no stack frame "
                             "(local memory)")
    return funcs


def fused_large_batch_cases():
    """The fused kernels at batches past the 65,535 of a grid's y axis:
    fb_main with B*T' = 2,100 x 32 = 67,200 frames and fb_pool with B =
    65,600 samples, small frames (4x4, k 3, stride 1, C 16, E 32, bf16),
    each against its plain version."""
    import torch
    from picklebot_tpu_torch.ops import fused_bottleneck as fb
    k, s, e, co = 3, 1, 32, 16
    res = {}
    x, w = make_case((2100, 30, 4, 4, 16), k, e, co, torch.bfloat16, 150)
    scale = torch.rand((x.shape[0], e), device="cuda", generator=(
        torch.Generator(device="cuda").manual_seed(151)))
    got = fb.fused_main(x, w["w1"], w["wd"], w["w2"], scale, k, s)
    want = fb.main_reference(x, w["w1"], w["wd"], w["w2"], scale, k, s)
    torch.cuda.synchronize()
    if got.shape[0] * got.shape[1] <= 65535:
        raise AssertionError(f"fb_main large batch: output {got.shape}")
    res["main"] = dict(x=list(x.shape), frames=got.shape[0] * got.shape[1],
                       err=check_close("fb_main B*T' > 65535", got, want,
                                       BF16_REL_TOL)[0])
    del x, w, scale, got, want
    x, w = make_case((65600, 1, 4, 4, 16), k, e, co, torch.bfloat16, 152)
    got = fb.fused_pool(x, w["w1"], w["wd"], k, s)
    want = fb.pool_reference(x, w["w1"], w["wd"], k, s)
    torch.cuda.synchronize()
    res["pool"] = dict(x=list(x.shape), err=check_close(
        "fb_pool B > 65535", got, want, BF16_REL_TOL)[0])
    emit({"phase": "kernels", "large_batch_case": res,
          "rel_tol": BF16_REL_TOL})
    return res


# the depthwise stencil's input a (B, T, H, W, E) at the bottlenecks of
# the benchmark's two training cells: MobileNetLarge3D at bs 16 (15) and
# MobileViT-s at bs 8 (7)
DW_CELLS = (("MobileNetLarge3D", 16, GEOMETRIES),
            ("MobileViT-s", 8, VIT_GEOMETRIES))
# kernel against plain, both f32 sums of the same products rounded once:
# they differ where an f32 sum taken in another order rounds the other
# way, one bf16 ulp (2^-8 of a value) at most; f32 to F32_REL_TOL
DW_BF16_REL_TOL = 2 ** -8
# cuDNN's kernels that must not run under the fused backward's span
CUDNN_CONV = ("convolve", "cudnn", "Nchw", "Nhwc", "nchw", "nhwc",
              "implicit_gemm", "setTensor")


def dw_case(shape, k, s, dtype, seed):
    """Seeded a (B, T, H, W, E), wd (k, k, E) ~ U(+-1/k) and an output
    gradient g on the card."""
    import torch
    from picklebot_tpu_torch.ops.fused_bottleneck import out_shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, t, h, w, e = shape
    a = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    wd = ((torch.rand((k, k, e), generator=gen, device="cuda") * 2 - 1)
          / k).to(dtype)
    g = torch.randn((b, *out_shape(t, h, w, k, s), e), generator=gen,
                    device="cuda").to(dtype)
    return a, wd, g


def dw_bound(shape, k, s, elem):
    """Least time of each of the stencil's three passes at this geometry:
    each reads its inputs and writes its output once (stencil: a's frames
    that an output frame reads, d; dgrad: g's valid frames, da; wgrad: a's
    read frames and g's valid frames, dw); 2*k*k FLOPs per valid output
    element each."""
    from picklebot_tpu_torch.ops.fused_bottleneck import (out_shape,
                                                          valid_frames)
    b, t, h, w, e = shape
    to, ho, wo = out_shape(t, h, w, k, s)
    n = valid_frames(t, k, s)[1]
    a_read, g_valid = b * n * h * w * e, b * n * ho * wo * e
    weights = k * k * e
    nbytes = {"stencil": a_read + b * to * ho * wo * e + weights,
              "dgrad": g_valid + b * t * h * w * e + weights,
              "wgrad": a_read + g_valid + weights}
    name = "bfloat16" if elem == 2 else "float32"
    return {p: roofline(v * elem, 2 * g_valid * k * k, name)
            for p, v in nbytes.items()}


def dw_library(a, wd, g, s):
    """cuDNN's grouped conv3d forward and backward on the same tensors:
    the recompute's old depthwise conv, timed as a yardstick only (the
    port no longer calls it there)."""
    import torch
    from picklebot_tpu_torch.ops.conv import depthwise_conv
    ar, wr = a.detach().requires_grad_(), wd.detach().requires_grad_()
    return torch.autograd.grad(depthwise_conv(ar, wr, s), (ar, wr), g)


def dw_rows(reps):
    """The depthwise stencil's backward kernels against their plain
    versions at the two training cells' 22 bottleneck geometries, bf16
    (DW_BF16_REL_TOL) and f32 (F32_REL_TOL): stencil, dgrad, wgrad (its
    plain version in the plan's range order), zero frames and unread
    input frames exactly zero, each kernel's second call bit-equal; in
    bf16 the plan, each kernel's device time from a trace, the plain
    version's and cuDNN's grouped conv3d forward + backward's times by
    CUDA events, and the passes' bounds. Sums per train microbatch of
    each cell."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.ops import fused_bottleneck as fb
    rows, per_micro = [], {}
    for model, batch, geometries in DW_CELLS:
        sums = {"stencil": 0.0, "dgrad": 0.0, "wgrad": 0.0, "plain": 0.0,
                "library": 0.0, "bound": 0.0}
        for i, (shape, k, s, _, e, _) in enumerate(geometries):
            shape = (batch, *shape[1:4], e)
            b, t, h, w, _ = shape
            first, n = fb.valid_frames(t, k, s)
            p = k // 2
            read = [ti for ti in range(t) if (ti + p) % s == 0]
            row = {"model": model, "block": i, "a": list(shape), "k": k,
                   "s": s}
            for dtype in (torch.bfloat16, torch.float32):
                tol = DW_BF16_REL_TOL if dtype == torch.bfloat16 \
                    else F32_REL_TOL
                tag = f"{model} dw block {i} {dtype}"
                a, wd, g = dw_case(shape, k, s, dtype, 900 + 7 * i)
                fns = {
                    "stencil": (lambda: fb.dw_stencil(a, wd, s),
                                lambda: fb.dw_stencil_reference(a, wd, s)),
                    "dgrad": (lambda: fb.dw_dgrad(g, wd, s, shape),
                              lambda: fb.dw_dgrad_reference(g, wd, s,
                                                            shape)),
                    "wgrad": (lambda: fb.dw_wgrad(a, g, k, s),
                              lambda: fb.dw_wgrad_reference(a, g, k, s))}
                got = {}
                with DtypePolicy.f32().precision():
                    for pas, (fn, plain) in fns.items():
                        got[pas] = fn()
                        want = plain()
                        torch.cuda.synchronize()
                        err, ref = check_close(f"{tag} {pas}", got[pas],
                                               want, tol)
                        if not torch.equal(got[pas], fn()):
                            raise AssertionError(f"{tag} {pas}: two calls "
                                                 "differ")
                        row.setdefault(pas, {})[str(dtype)[6:]] = dict(
                            err=err, max_ref=ref, bit_equal_repeat=True)
                zero_out = torch.ones(got["stencil"].shape[1], dtype=bool,
                                      device="cuda")
                zero_out[first:first + n] = False
                zero_in = torch.ones(t, dtype=bool, device="cuda")
                zero_in[read] = False
                if got["stencil"][:, zero_out].any() or \
                        got["dgrad"][:, zero_in].any():
                    raise AssertionError(f"{tag}: a zero frame or an "
                                         "unread input frame is not zero")
                if dtype != torch.bfloat16:
                    continue
                bounds = dw_bound(shape, k, s, 2)
                for pas, (fn, plain) in fns.items():
                    row[pas].update(
                        plan=fb._dw_plan(shape, k, s, dtype, pas)._asdict(),
                        device_ms=device_ms(fn, reps), ms=time_ms(fn, reps),
                        **bounds[pas])
                    # a trace without device events: the events' time
                    sums[pas] += row[pas]["device_ms"] or row[pas]["ms"]
                    sums["bound"] += bounds[pas]["bound_ms"]
                row["plain_ms"] = sum(time_ms(plain, reps)
                                      for _, plain in fns.values())
                row["library_ms"] = time_ms(lambda: dw_library(a, wd, g, s),
                                            reps)
                row["library_device_ms"] = device_ms(
                    lambda: dw_library(a, wd, g, s), reps)
                sums["plain"] += row["plain_ms"]
                sums["library"] += (row["library_device_ms"]
                                    or row["library_ms"])
                del a, wd, g, got
            row["clocks_after_trace"] = sm_clocks()
            emit({"phase": "kernels", "stencil_backward": row})
            rows.append(row)
        per_micro[model] = dict(sums, kernels=sums["stencil"] + sums["dgrad"]
                                + sums["wgrad"], batch=batch)
        emit({"phase": "kernels", "stencil_backward_per_microbatch": model,
              **per_micro[model]})
    return {"rows": rows, "per_microbatch_ms": per_micro}


def dw_whole_backward():
    """One whole ``FusedBottleneckFn`` backward at each of the 22 cell
    geometries (bf16): every input's gradient against the cuDNN recompute
    (``fused_bottleneck_reference`` differentiated by autograd, the old
    path), within the flash bounds (BF16_REL_TOL of max|ref|, BF16_RMS_TOL
    rms)."""
    import torch
    from picklebot_tpu_torch.ops import fused_bottleneck as fb
    out = []
    names = ("x", "w1", "wd", "w2", "se_w1", "se_b1", "se_w2", "se_b2")
    for model, batch, geometries in DW_CELLS:
        for i, (shape, k, s, se, e, co) in enumerate(geometries):
            shape = (batch, *shape[1:])
            x, w = make_case(shape, k, e, co, torch.bfloat16, seed=700 + i)
            args = [x] + [w[n] for n in names[1:]]
            if not se:
                args[4:] = [None] * 4
            ins = [None if v is None else v.detach().requires_grad_()
                   for v in args]
            outs = fb.fused_bottleneck(*ins, k, s, se)
            g = torch.randn(outs.shape, device="cuda", generator=(
                torch.Generator(device="cuda").manual_seed(800 + i))).to(
                    outs.dtype)
            live = [v for v in ins if v is not None]
            got = torch.autograd.grad(outs, live, g)
            old = [v.detach().requires_grad_() if v is not None else None
                   for v in args]
            want = torch.autograd.grad(
                fb.fused_bottleneck_reference(*old, k, s, se),
                [v for v in old if v is not None], g)
            torch.cuda.synchronize()
            live_names = [n for n, v in zip(names, ins) if v is not None]
            out.append({"model": model, "block": i, **{
                n: check_bf16_flash(f"{model} block {i} d{n}", gv, wv)
                for n, gv, wv in zip(live_names, got, want)}})
            del x, w, args, ins, outs, g, got, want, old
    emit({"phase": "kernels", "whole_backward": len(out),
          "worst_rel": max(v["err"] / max(v["max_ref"], 1e-30)
                           for r in out for n, v in r.items()
                           if isinstance(v, dict))})
    return out


def dw_train_microbatch():
    """One train microbatch (forward and backward, bf16) of each cell's
    model at its batch on 32x224x224 clips: the fused counters' deltas
    exact (15 of each stencil key in MobileNetLarge3D, 7 in MobileViT-s),
    and in a trace of it no cuDNN conv kernel launched under the span
    ``picklebot.fused_bottleneck.backward``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from picklebot_tpu_torch.ops import fused_bottleneck as fb
    from picklebot_tpu_torch.ops.linear import ChannelDropout, Dropout
    from picklebot_tpu_torch.train.losses import cross_entropy
    from portbench.harness import spans, trace
    res = {}
    for label, make, batch, want in (
            ("MobileNetLarge3D", large3d, 16,
             {"pool": 8, "main": 15, **dw(15)}),
            ("MobileViT-s", mobilevit_s, 8, {"main": 7, **dw(7)})):
        model = make().cuda().train()
        for mod in model.modules():            # no dropout generator here
            if isinstance(mod, (ChannelDropout, Dropout)):
                mod.p = 0.0
        gen = torch.Generator(device="cuda").manual_seed(31)
        x = torch.rand((batch, 32, 224, 224, 3), generator=gen,
                       device="cuda").to(torch.bfloat16)
        lbl = torch.arange(batch, device="cuda") % 13

        def micro():
            cross_entropy(model(x), lbl).backward()
        micro()
        torch.cuda.synchronize()
        before = dict(fb.LAUNCHES)
        micro()
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in fb.LAUNCHES.items()}
        if delta != {k: want.get(k, 0) for k in delta}:
            raise AssertionError(f"{label} train microbatch: fused launches "
                                 f"{delta}, want {want}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(trace.WINDOW_SPAN):
                micro()
                torch.cuda.synchronize()
        att = spans.attribute(*trace.events(prof))
        if att is None:
            raise AssertionError(f"{label}: the trace's launches and device "
                                 "events do not pair")
        under = att.device.get(spans.FUSED_BACKWARD, [])
        names = sorted({d.name for d in under})
        bad = [n for n in names if any(c in n for c in CUDNN_CONV)]
        if not under or bad:
            raise AssertionError(f"{label}: under {spans.FUSED_BACKWARD} "
                                 f"{len(under)} device events, cuDNN conv "
                                 f"kernels {bad[:5]}")
        res[label] = {"launches": delta, "events_under_span": len(under),
                      "kernels_under_span": [n[:100] for n in names],
                      "span_busy_ms": att.busy_us.get(
                          spans.FUSED_BACKWARD, 0.0) / 1e3}
        emit({"phase": "kernels", "stencil_backward_train": label,
              **res[label]})
        del model, x, prof
    return res


def phase_kernels():
    return (*fused_phase(), *flash_phase(), conv_rows(reps=5))


def fused_phase():
    """The fused rows of the three models that run the fused kernels, the
    f32 case and the large-batch cases."""
    rows, fused_per = [], {}
    for model, geometries, seed0 in (
            ("MobileNetLarge3D", GEOMETRIES, 0),
            ("MobileViT-s", VIT_GEOMETRIES, 50),
            ("MobileNetSmall3D", SMALL_GEOMETRIES, 70)):
        model_rows, fused_per[model] = fused_rows(model, geometries, seed0,
                                                  reps=5)
        rows += model_rows
    fused_f32_case()
    large_batch = fused_large_batch_cases()
    stencil = {"rows": dw_rows(reps=5), "whole_backward": dw_whole_backward(),
               "train_microbatch": dw_train_microbatch()}
    return rows, fused_per, large_batch, stencil


def flash_phase():
    """The flash forward and backward rows, then 'auto''s sweep."""
    return (flash_rows(reps=5), flash_bwd_rows(reps=5),
            packed_route_sweep(reps=10))


def calibrate_batchnorm(model, x, var_floor=0.0):
    """Set every BatchNorm's running statistics to those of its input on
    one batch (the plain path, on the card), the variance at least
    ``var_floor``: a seeded random model then gives O(1) activations and
    logits whose argmax means something."""
    import torch
    from picklebot_tpu_torch.ops.norm import BatchNorm

    def hook(mod, args):
        v = args[0].float()
        dims = tuple(range(v.dim() - 1))
        mod.running_mean.copy_(v.mean(dims))
        mod.running_var.copy_(v.var(dims, unbiased=False).clamp_min(
            var_floor))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm)]
    with torch.no_grad():
        model(x, kernels=False)
    for hnd in handles:
        hnd.remove()


def clip_batch():
    """Host uint8 features and the preprocessed bf16 batch on the card:
    the first 8 of the synthetic clips the serve runs see."""
    import torch
    from picklebot_tpu_torch.data.dataset import ClipDataset, pad_collate
    from picklebot_tpu_torch.train.step import preprocess
    ds = ClipDataset("", "", backend="synthetic",
                     synthetic_shape=(32, 224, 224), synthetic_len=16)
    feats, _ = pad_collate([ds[i][0] for i in range(8)], [0] * 8, 16, 128)
    return feats, preprocess(torch.from_numpy(feats).cuda(), torch.bfloat16)


def all_counters():
    """The launch counts of every kernel module, by module."""
    from picklebot_tpu_torch.ops import flash_attention as fa
    from picklebot_tpu_torch.ops import folded_conv as fc
    from picklebot_tpu_torch.ops import fused_bottleneck as fb
    return {"fused": fb.LAUNCHES, "flash": fa.LAUNCHES, "conv": fc.LAUNCHES}


def launches_wanted(**by_module):
    """Every kernel's wanted count: those named, and 0 for every other."""
    return {name: {k: by_module.get(name, {}).get(k, 0) for k in c}
            for name, c in all_counters().items()}


def dw(n):
    """The depthwise stencil's backward launches of ``n`` fused
    bottleneck backwards: each runs the stencil, dgrad and wgrad once."""
    return {"dw_stencil": n, "dw_dgrad": n, "dw_wgrad": n}


@contextlib.contextmanager
def conv_on_library():
    """Within the block every ``Conv3d`` keeps to ``F.conv3d``: MobileViT's
    conv1/conv4 as they ran before the conv kernel was wired in, the
    other kernels still on. For before-and-after timings inside one run;
    the port has no such switch."""
    from picklebot_tpu_torch.ops.conv import Conv3d
    saved = Conv3d.takes_folded_kernel
    Conv3d.takes_folded_kernel = lambda self, x: False
    try:
        yield
    finally:
        Conv3d.takes_folded_kernel = saved


@contextlib.contextmanager
def packed_min_seq(n):
    """Within the block 'auto' sends sequences of at least ``n`` tokens to
    the head-packed kernel (the port's ``_PACKED_MIN_SEQ`` patched): to
    time MobileViT-s at each of the threshold's routes inside one run; the
    port has no such switch."""
    from picklebot_tpu_torch.ops import attention
    saved = attention._PACKED_MIN_SEQ
    attention._PACKED_MIN_SEQ = n
    try:
        yield
    finally:
        attention._PACKED_MIN_SEQ = saved


def by_packed_min_seq(measure):
    """``measure()`` at each threshold of PACKED_MIN_SEQ_TURNS in turn,
    then once more at the port's own."""
    out = {}
    for n in PACKED_MIN_SEQ_TURNS:
        with packed_min_seq(n):
            out[str(n)] = measure()
    out["port_again"] = measure()
    return out


def zero_counters(counters):
    """Set every launch count to 0 (just before a main-path run)."""
    for c in counters.values():
        c.update(dict.fromkeys(c, 0))


def read_counters(counters):
    return {name: dict(c) for name, c in counters.items()}


def serve_run(cfg, model, counters, pth=None):
    """picklebot_tpu_torch.serve.main on 16 synthetic clips at --batch 8
    from ``model``'s weights (or the ``.pth`` at ``pth``), with every
    launch counter set to 0 just before it and read just after. Checks
    the predictions; returns the launches and the wall time."""
    import torch
    from picklebot_tpu_torch import serve
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "cfg.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        if pth is None:
            pth = os.path.join(tmp, "weights.pth")
            torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                       pth)
        zero_counters(counters)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = serve.main([cfg_path, "--checkpoint", pth, "--csv",
                             "synthetic", "--limit", "16", "--batch", "8"])
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = read_counters(counters)
    lines = [json.loads(l) for l in out.getvalue().splitlines()
             if l.startswith("{")]
    preds = [l for l in lines if "pred" in l]
    if rc != 0 or len(preds) != 16 or "evaluated" not in lines[-1]:
        raise AssertionError(f"serve: rc {rc}, {len(preds)} predictions, "
                             f"last line {lines[-1] if lines else None}")
    if not all(0 <= p["pred"] < 13 and 0 < p["confidence"] <= 1
               for p in preds):
        raise AssertionError(f"serve: bad prediction lines {preds}")
    return launches, serve_s, len(preds), lines[-1]


def plain_logits(name, model, x):
    """f32 logits of the plain path (``kernels=False``) on the card, which
    must launch no hand-written kernel."""
    import torch
    counters = all_counters()
    zero_counters(counters)
    with torch.inference_mode():
        ref = model(x, kernels=False).float()
    torch.cuda.synchronize()
    if read_counters(counters) != launches_wanted():
        raise AssertionError(f"{name} plain path (kernels=False) launched "
                             f"{read_counters(counters)}")
    return ref


def logits_against_plain(name, got, ref):
    """Logits against a reference's (the kernel path's against the plain
    path's on the card, unless the caller says otherwise): max abs err
    within 5% of max|logit|, argmax equal wherever the reference's top-2
    margin exceeds twice that."""
    import torch
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite logits")
    err = (got - ref).abs().max().item()
    scale_ = ref.abs().max().item()
    tol = LOGIT_REL_TOL * scale_
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
    argmax_ok = bool((got.argmax(-1) == ref.argmax(-1))[clear].all())
    if err > tol or not argmax_ok:
        raise AssertionError(f"{name} logits: max abs err {err} (tol {tol}),"
                             f" argmax agrees where clear: {argmax_ok}")
    return {"logits_max_abs_err": err, "logits_max_abs": scale_,
            "rel_tol": LOGIT_REL_TOL,
            "argmax_agree": int((got.argmax(-1) == ref.argmax(-1)).sum()),
            "argmax_clear": int(clear.sum())}


def throughput(model, feats, x):
    """predict() from a host uint8 batch to host logits, and the forward's
    device time with the kernels and on the plain path."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.train.step import make_predict_fn
    predict = make_predict_fn(model, DtypePolicy.bf16(), device="cuda")
    for _ in range(2):
        predict(feats)
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        predict(feats)
    dt = time.perf_counter() - t0
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(x), reps=reps)
        plain_ms = time_ms(lambda: model(x, kernels=False), reps=reps)
        with conv_on_library():
            conv_lib_ms = time_ms(lambda: model(x), reps=reps)
        fwd_ms2 = time_ms(lambda: model(x), reps=reps)
    return {"batch": 8, "clip": [32, 224, 224],
            "predict_clips_per_s": 8 * reps / dt, "forward_ms": fwd_ms,
            "forward_plain_ms": plain_ms,
            "forward_ms_conv_on_library": conv_lib_ms,
            "forward_ms_again": fwd_ms2}


def serve_config(model_name, **extra):
    return {"model_name": model_name, "num_classes": 13,
            "use_autocast": True, "data_backend": "synthetic",
            "synthetic_shape": [32, 224, 224], "t_bucket": 16,
            "max_frames": 128, "synthetic_len": 16, **extra}


def phase_serve_mobilenet(name, make_model, geometries, gpu_line, feats, x):
    """MobileNetLarge3D or MobileNetSmall3D: every bottleneck on the fused
    kernels (the pool pass in the SE blocks), no other kernel."""
    import torch

    model = make_model().cuda().eval()
    calibrate_batchnorm(model, x)
    shapes = bottleneck_inputs(model, x)
    if shapes != [g[0] for g in geometries]:
        raise AssertionError(f"{name} bottleneck inputs {shapes}, not the "
                             "geometries the kernels were held at")
    n_se = sum(b.use_se for b in model.bottlenecks())
    n_blocks = len(list(model.bottlenecks()))
    launches, serve_s, n_preds, evaluated = serve_run(
        serve_config(name), model, all_counters())
    want = launches_wanted(fused={"pool": 2 * n_se, "main": 2 * n_blocks})
    if launches != want:
        raise AssertionError(f"serve {name}: launches {launches}, want "
                             f"{want}")
    launches = launches["fused"]
    emit({"phase": "serve", "model": name, "predictions": n_preds,
          "evaluated": evaluated, "launches": launches,
          "serve_wall_s": serve_s})

    with torch.inference_mode():
        check = logits_against_plain(name, model(x).float(),
                                     plain_logits(name, model, x))
    emit({"phase": "serve", "model": name, **check})
    result = {"phase": "serve", "model": name,
              **throughput(model, feats, x), "card": gpu_line,
              "launches": launches}
    emit(result)
    result["profile"] = phase_profile(name, model, x)
    return result


def phase_serve_movinet(gpu_line, feats, x):
    """MoViNet-A2 (offline): matmuls and cuDNN depthwise convs only, so
    the run must launch no hand-written kernel; its logits are held to be
    finite and of the right shape, its predictions checked by
    ``serve_run``."""
    import torch

    model = movinet_a2().cuda().eval()
    calibrate_batchnorm(model, x)
    launches, serve_s, n_preds, evaluated = serve_run(
        serve_config("MoViNetA2"), model, all_counters())
    if launches != launches_wanted():
        raise AssertionError(f"serve MoViNetA2: launches {launches}, want "
                             "none")
    with torch.inference_mode():
        logits = model(x).float()
    if tuple(logits.shape) != (8, 13) or not torch.isfinite(logits).all():
        raise AssertionError(f"MoViNetA2 logits: shape {tuple(logits.shape)}"
                             ", or not finite")
    emit({"phase": "serve", "model": "MoViNetA2", "predictions": n_preds,
          "evaluated": evaluated, "launches": launches,
          "logits_max_abs": logits.abs().max().item(),
          "serve_wall_s": serve_s})
    result = {"phase": "serve", "model": "MoViNetA2",
              **throughput(model, feats, x), "card": gpu_line,
              "launches": launches}
    emit(result)
    result["profile"] = phase_profile("MoViNetA2", model, x)
    return result


def conv_kernel_inputs(model, x):
    """(input shape, Co) of every conv that takes the conv kernel, in one
    plain forward."""
    import torch
    from picklebot_tpu_torch.ops.conv import Conv3d
    seen = []

    def hook(mod, args):
        if mod.takes_folded_kernel(args[0]):
            seen.append((tuple(args[0].shape), mod.out_channels))
    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, Conv3d)]
    with torch.inference_mode():
        model(x, kernels=False)
    for hnd in handles:
        hnd.remove()
    return seen


def bottleneck_inputs(model, x):
    """The (B, T, H, W, C) input shape of each of the model's bottlenecks
    in one plain forward."""
    import torch
    shapes = []
    handles = [b.register_forward_pre_hook(
        lambda mod, args: shapes.append(tuple(args[0].shape)))
        for b in model.bottlenecks()]
    with torch.inference_mode():
        model(x, kernels=False)
    for hnd in handles:
        hnd.remove()
    return shapes


def phase_serve_mobilevit(gpu_line, feats, x):
    import torch
    from picklebot_tpu_torch.models.mobilevit import (MOBILEVIT_CONFIGS,
                                                      MobileViT)
    widths = MOBILEVIT_CONFIGS["s"]
    cfg = serve_config("MobileViT", **widths, attention_backend="auto")
    model = MobileViT(num_classes=13, seed=0, **widths).cuda().eval()
    calibrate_batchnorm(model, x)
    shapes = bottleneck_inputs(model, x)
    if shapes != [g[0] for g in VIT_GEOMETRIES]:
        raise AssertionError(f"MobileViT-s bottleneck inputs {shapes}, "
                             "not the geometries the kernels were held at")
    convs = conv_kernel_inputs(model, x)
    want_convs = [(dims + (ci,), c) for dims, c in VIT_CONV_STAGES
                  for ci in (c, 2 * c)]
    if convs != want_convs:
        raise AssertionError(f"MobileViT-s conv1/conv4 inputs {convs}, not "
                             f"the geometries the kernel was held at")
    launches, serve_s, n_preds, evaluated = serve_run(cfg, model,
                                                      all_counters())
    # 2 batches x (7 bottlenecks without SE; the VIT_PACKED attention
    # layers; conv1 and conv4 of 3 blocks)
    want = launches_wanted(fused={"main": 14},
                           flash={"packed": 2 * sum(VIT_PACKED.values())},
                           conv={"fwd": 12})
    if launches != want:
        raise AssertionError(f"MobileViT serve: launches {launches}, "
                             f"want {want}")
    emit({"phase": "serve", "model": "MobileViT-s", "predictions": n_preds,
          "evaluated": evaluated, "launches": launches,
          "serve_wall_s": serve_s})

    ref = plain_logits("MobileViT-s", model, x)
    with torch.inference_mode():
        check = logits_against_plain("MobileViT-s", model(x).float(), ref)
    emit({"phase": "serve", "model": "MobileViT-s", **check})
    result = {"phase": "serve", "model": "MobileViT-s",
              **throughput(model, feats, x), "card": gpu_line,
              "launches": launches}
    with torch.inference_mode():
        result["forward_ms_by_packed_min_seq"] = by_packed_min_seq(
            lambda: time_ms(lambda: model(x), reps=10))
    emit(result)
    result["profile"] = phase_profile("MobileViT-s", model, x)
    for backend in ("pallas", "pallas_packed"):
        result[backend] = backend_forward(backend, model, x, ref)
    return result


def backend_forward(backend, model, x, ref):
    """One MobileViT-s forward with ``model``'s weights and another
    attention backend, whose 9 layers all take the per-head kernel
    ('pallas': split heads; 'pallas_packed': the (..., N, 3, H, D) qkv
    view). Launch counts set to 0 just before it and read just after;
    logits against the plain path's ``ref``."""
    import torch
    from picklebot_tpu_torch.models.mobilevit import (MOBILEVIT_CONFIGS,
                                                      MobileViT)

    other = MobileViT(num_classes=13, seed=0, attention_backend=backend,
                      **MOBILEVIT_CONFIGS["s"]).cuda().eval()
    other.load_state_dict(model.state_dict())
    counters = all_counters()
    zero_counters(counters)
    with torch.inference_mode():
        got = other(x).float()
        torch.cuda.synchronize()
    launches = read_counters(counters)
    want = launches_wanted(fused={"main": 7}, flash={"heads": 9},
                           conv={"fwd": 6})
    if launches != want:
        raise AssertionError(f"MobileViT {backend} forward: launches "
                             f"{launches}, want {want}")
    check = logits_against_plain(f"MobileViT-s {backend}", got, ref)
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: other(x), reps=10)
    emit({"phase": backend, "model": "MobileViT-s", "launches": launches,
          "forward_ms": fwd_ms, **check})
    return {"launches": launches, "forward_ms": fwd_ms, **check}


def warm_profiler():
    """Run torch.profiler once on a trivial op: its one-time start-up
    takes seconds, and paid here it overlaps the kernel build instead of
    the first trace. Returns the seconds it took."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_profile(name, model, x):
    """Where one bs-8 forward's device time goes (kernels on)."""
    import torch

    def forward():
        with torch.inference_mode():
            model(x)
    return profile_run(name, forward, "profile")


def union_us(spans):
    """Length of the union of (start, end) spans."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total if cur_e is None else total + cur_e - cur_s


def profile_run(name, fn, phase):
    """A torch.profiler trace of one call of ``fn`` after a warm-up call,
    with device time summed by kernel class (the port's kernels by name,
    the rest by name too) and the device's busy and idle share between
    the first and the last kernel. A trace that holds no device events
    fails the run: the idle share and the device times are read from
    it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t_start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError(f"profile {name}: the trace holds no device "
                             "events")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy = union_us(spans)
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    # cuDNN's generic grouped-conv weight gradient (the depthwise convs'
    # in the fused bottleneck's recompute backward) runs kernels that
    # overlap in time, so classes also get the union of their spans
    classes = {"flash_attention": ("fwd_bf16_kernel<", "fwd_f32_kernel<"),
               "flash_attention_bwd": ("dq_bf16_kernel<", "dkv_bf16_kernel<",
                                       "dq_f32_kernel<", "dkv_f32_kernel<"),
               "fused_bottleneck": ("main_bf16_kernel<", "pool_bf16_kernel<",
                                    "main_f32_kernel", "pool_f32_kernel",
                                    "main_split_sum_kernel",
                                    "pool_split_sum_kernel"),
               "folded_conv": ("conv_f32_kernel", "conv_bf16_kernel<",
                               "conv_split_sum_kernel"),
               "cudnn_grouped_wgrad": ("convolveNd_wgrad_engine<",)}
    by_class = {c: sum(t for n, t in by_name.items()
                       if any(p in n for p in pats))
                for c, pats in classes.items()}
    busy_by_class = {c: union_us([
        (e.time_range.start, e.time_range.end) for e in kernels
        if any(p in e.name for p in pats)]) / 1e3
        for c, pats in classes.items()}
    out = {"phase": phase, "model": name, "wall_ms": wall_ms,
           "kernel_window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
           "device_idle_share": 1 - busy / window,
           "kernel_launches": len(kernels),
           "by_class_ms": {c: t / 1e3 for c, t in by_class.items()},
           "busy_by_class_ms": busy_by_class,
           "other_ms": (sum(by_name.values()) - sum(by_class.values()))
           / 1e3,
           "top_kernels_ms": [[n[:120], t / 1e3] for n, t in sorted(
               by_name.items(), key=lambda kv: -kv[1])[:12]],
           "seconds": time.perf_counter() - t_start}
    emit(out)
    return out


# --------------------------------------------------------------------------
# stream
# --------------------------------------------------------------------------

def stream_model(name):
    from picklebot_tpu_torch.models.registry import initialize_model
    from picklebot_tpu_torch.utils.config import Config
    return initialize_model(Config(model_name=name, num_classes=13,
                                   seed=0).validate())


def streamed(model, frames, chunk, policy, device="cuda"):
    """serve's per-clip stream loop (``serve.stream_clip``, what --stream
    runs after decoding) on uint8 frames (T, 224, 224, 3): the list of
    (record, f32 logits) per chunk."""
    from picklebot_tpu_torch.serve import stream_clip
    return list(stream_clip(model, frames, chunk, policy, device, "CE", 13))


def check_records(name, records, t_total, chunk):
    frames = [r["frame"] for r, _ in records]
    want = list(range(chunk, t_total, chunk)) + [t_total]
    if frames != want or not all(
            0 <= r["pred"] < 13 and 0 < r["confidence"] <= 1
            and np.isfinite(lg).all() for r, lg in records):
        raise AssertionError(f"{name} chunk {chunk}: frames {frames} (want "
                             f"{want}), records {records[-1][0]}")


def cpu_stream_logits(model, frames, chunk, policy):
    """The last logits of a stream over uint8 frames (T, H, W, 3) on the
    CPU, written out plainly by the JAX server's rule: whole chunks, then
    a ragged tail frame by frame, from a zero carry; f32 (1, classes)."""
    import torch
    from picklebot_tpu_torch.train.step import preprocess
    dtype = policy.compute_dtype
    tail = len(frames) % chunk
    sizes = [chunk] * (len(frames) // chunk) + [1] * tail
    start = 0
    with torch.inference_mode(), policy.precision():
        carry = model.init_stream(1, *frames.shape[1:3], dtype, "cpu")
        for size in sizes:
            x = preprocess(torch.from_numpy(frames[None, start:start + size]),
                           dtype)
            logits, carry = model(x, carry)
            start += size
    return logits.float()


def stream_against_whole(name, model, frames):
    """The last chunk's logits of --stream at each of STREAM_CHUNKS on one
    32-frame clip (t_bucket 32: no padding frames), in f32 with TF32 off
    and in bf16, against a reference: f32 within 1e-4 of max|logit|, bf16
    within 5% of max|logit| with the argmax equal where the top-2 margin
    is clear (MoViNetA2Stream: STREAM_BF16_FACTOR's bound).

    The 2-D models' reference is the whole-clip predict path in the same
    dtype: their chunks give the whole clip's logits exactly (the SE
    blocks pool each frame alone, the LSTM is causal). MoViNetA2Stream's
    SE blocks pool over the chunk's frames, as in the JAX package, so its
    chunked logits are not the whole clip's (their distance is reported):
    its reference is the same pieces run on the CPU in the same dtype
    (``cpu_stream_logits``), and its whole-clip pass is held to the CPU's
    too. Its bf16 check reads how far bf16 itself moves each side: the
    card's bf16 logits from the card's f32 ones, and the CPU's from the
    CPU's; the card's may be at most STREAM_BF16_FACTOR times the CPU's,
    plus 5% of max|logit|. The card-vs-CPU distance is reported."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.train.step import make_predict_fn
    cpu_model = None
    if name == "MoViNetA2Stream":
        cpu_model = stream_model(name).eval()
        cpu_model.load_state_dict(model.state_dict())
    out, f32 = {}, {}

    def check(label, dtype, key, got, ref):
        if dtype == "float32":
            f32[key] = got, ref
            err = (got - ref).abs().max().item()
            scale_ = ref.abs().max().item()
            if not err <= F32_REL_TOL * scale_:
                raise AssertionError(f"{label}: max abs err {err}, tol "
                                     f"{F32_REL_TOL * scale_}")
            return {"logits_max_abs_err": err, "logits_max_abs": scale_,
                    "rel_tol": F32_REL_TOL}
        if cpu_model is None:
            return logits_against_plain(label, got, ref)
        card, cpu = f32[key]
        res = {"logits_max_abs_err": (got - ref).abs().max().item(),
               "bf16_vs_f32_card": (got - card).abs().max().item(),
               "bf16_vs_f32_cpu": (ref - cpu).abs().max().item(),
               "f32_logits_max_abs": cpu.abs().max().item()}
        res["tol"] = (STREAM_BF16_FACTOR * res["bf16_vs_f32_cpu"]
                      + LOGIT_REL_TOL * res["f32_logits_max_abs"])
        if not (torch.isfinite(got).all()
                and res["bf16_vs_f32_card"] <= res["tol"]):
            raise AssertionError(f"{label}: the card's bf16 logits lie "
                                 f"farther from f32 than the CPU's allow: "
                                 f"{res}")
        return res

    for dtype, policy in (("float32", DtypePolicy.f32()),
                          ("bfloat16", DtypePolicy.bf16())):
        whole = torch.from_numpy(
            make_predict_fn(model, policy, device="cuda")(frames[None]))
        if cpu_model is not None:
            whole_cpu = torch.from_numpy(make_predict_fn(
                cpu_model, policy, device="cpu")(frames[None]))
            out[f"{dtype}_whole_clip_card_vs_cpu"] = check(
                f"{name} {dtype} whole clip against the CPU", dtype, "whole",
                whole, whole_cpu)
        for chunk in STREAM_CHUNKS:
            records = streamed(model, frames, chunk, policy)
            check_records(name, records, len(frames), chunk)
            got = torch.from_numpy(records[-1][1])
            ref, against = whole, "whole_clip"
            if cpu_model is not None:
                ref = cpu_stream_logits(cpu_model, frames, chunk, policy)
                against = "cpu_stream"
            res = check(f"{name} {dtype} stream chunk {chunk} against "
                        f"{against}", dtype, chunk, got, ref)
            out[f"{dtype}_chunk{chunk}"] = dict(
                res, against=against, chunks=len(records),
                argmax=int(got.argmax()), ref_argmax=int(ref.argmax()),
                whole_clip_max_abs_err=(got - whole).abs().max().item(),
                whole_clip_max_abs=whole.abs().max().item())
    return out


def causality(name, model, frames):
    """Two clips that share their first 4 frames: the first chunk's
    logits (--chunk 4) must not change with the frames after it."""
    from picklebot_tpu_torch.core.policy import DtypePolicy
    other = frames.copy()
    other[4:] = np.random.RandomState(1).randint(
        0, 256, other[4:].shape, np.uint8)
    runs = [streamed(model, clip, 4, DtypePolicy.bf16())
            for clip in (frames, other)]
    firsts = [r[0][1] for r in runs]
    if np.array_equal(runs[0][-1][1], runs[1][-1][1]):
        raise AssertionError(f"{name}: the last chunk's logits do not see "
                             "the changed frames")
    err = float(np.abs(firsts[0] - firsts[1]).max())
    scale_ = float(np.abs(firsts[0]).max())
    if err > CAUSAL_REL_TOL * scale_:
        raise AssertionError(f"{name}: the first chunk's logits moved by "
                             f"{err} with later frames")
    return {"bit_equal": bool(np.array_equal(firsts[0], firsts[1])),
            "max_abs_err": err, "logits_max_abs": scale_}


def stream_timing(model, chunk):
    """Per-chunk latency of --stream at ``chunk`` frames, bf16, on a clip
    of (STREAM_WARMUP + STREAM_REPS) chunks of random frames: host clock
    around each chunk (H2D, preprocess, forward, logits to the host) and
    CUDA events around the forward; medians over STREAM_REPS after
    STREAM_WARMUP chunks."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.serve import stream_clip
    n = STREAM_WARMUP + STREAM_REPS
    frames = np.random.RandomState(2).randint(
        0, 256, (n * chunk, 224, 224, 3), np.uint8)
    events = []

    def before(mod, args):
        events.append([torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True)])
        events[-1][0].record()

    def after(mod, args, out):
        events[-1][1].record()

    hooks = [model.register_forward_pre_hook(before),
             model.register_forward_hook(after)]
    host = []
    try:
        gen = stream_clip(model, frames, chunk, DtypePolicy.bf16(), "cuda",
                          "CE", 13)
        while True:
            t0 = time.perf_counter()
            if next(gen, None) is None:
                break
            host.append((time.perf_counter() - t0) * 1e3)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    ev = [a.elapsed_time(b) for a, b in events]
    host, ev = host[STREAM_WARMUP:], ev[STREAM_WARMUP:]
    host_ms = float(np.median(host))
    return {"chunk": chunk, "chunks_timed": len(host),
            "host_ms_median": host_ms, "event_ms_median": float(
                np.median(ev)), "host_ms_min": min(host),
            "host_ms_max": max(host), "frames_per_s": chunk * 1e3 / host_ms}


def stream_profile(name, model):
    """A torch.profiler trace of one chunk-1 step of --stream (bf16)."""
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.serve import stream_clip
    frames = np.random.RandomState(3).randint(0, 256, (4, 224, 224, 3),
                                              np.uint8)
    gen = stream_clip(model, frames, 1, DtypePolicy.bf16(), "cuda", "CE",
                      13)
    return profile_run(name, lambda: next(gen), "stream_profile")


def phase_stream_model(name, gpu_line, feats, x):
    """One online model: serve.main on whole clips (no hand-written
    launch), its logits, --stream against the whole clip, causality,
    chunk latency, a chunk-1 trace and the whole-clip forward time."""
    import torch

    t_start = time.perf_counter()
    model = stream_model(name).cuda().eval()
    calibrate_batchnorm(model, x, STREAM_BN_VAR_FLOOR)
    counters = all_counters()
    launches, serve_s, n_preds, evaluated = serve_run(
        serve_config(name), model, counters)
    if launches != launches_wanted():
        raise AssertionError(f"serve {name}: launches {launches}, want "
                             "none")
    with torch.inference_mode():
        logits = model(x).float()
    if tuple(logits.shape) != (8, 13) or not torch.isfinite(logits).all():
        raise AssertionError(f"{name} logits: shape {tuple(logits.shape)}, "
                             "or not finite")
    emit({"phase": "stream", "model": name, "predictions": n_preds,
          "evaluated": evaluated, "launches": launches,
          "logits_max_abs": logits.abs().max().item(),
          "serve_wall_s": serve_s})
    frames = feats[0]                      # one 32-frame 224x224 clip
    zero_counters(counters)
    against = stream_against_whole(name, model, frames)
    causal = causality(name, model, frames)
    stream_launches = read_counters(counters)
    if stream_launches != launches_wanted():
        raise AssertionError(f"--stream {name}: launches {stream_launches}"
                             ", want none")
    emit({"phase": "stream", "model": name, "against_whole_clip": against,
          "causality": causal, "launches": stream_launches})
    timing = {f"chunk{c}": stream_timing(model, c) for c in STREAM_TIMED}
    with torch.inference_mode():
        forward_ms = time_ms(lambda: model(x), reps=5)
    result = {"phase": "stream", "model": name, "card": gpu_line,
              "latency": timing, "whole_clip_forward_ms_bs8": forward_ms}
    emit(result)
    result.update(against_whole_clip=against, causality=causal,
                  serve_launches=launches, stream_launches=stream_launches,
                  profile=stream_profile(name, model))
    result["seconds"] = time.perf_counter() - t_start
    return result


def phase_stream(gpu_line, feats, x, counters):
    """The three online models, then MobileNetLarge2D trained through the
    CLI (no hand-written launch; its .pth served through --stream), and
    train() refusing MoViNetA2Stream."""
    from picklebot_tpu_torch.train.loop import train
    from picklebot_tpu_torch.utils.config import Config
    out = {name: phase_stream_model(name, gpu_line, feats, x)
           for name in STREAM_MODELS}
    t0 = time.perf_counter()
    out["train_MobileNetLarge2D"] = phase_train_cli(
        "MobileNetLarge2D", "mobilenet_large2d_50k.json", counters,
        *[launches_wanted()] * 2, stream=True)
    try:
        train(Config(model_name="MoViNetA2Stream", num_classes=13),
              device="cuda")
    except ValueError as e:
        if "MoViNetA2Stream" not in str(e):
            raise
        out["train_refuses_MoViNetA2Stream"] = str(e)
    else:
        raise AssertionError("train() took a MoViNetA2Stream config")
    emit({"phase": "stream", "train_refuses_MoViNetA2Stream":
          out["train_refuses_MoViNetA2Stream"]})
    out["train_MobileNetLarge2D"]["seconds"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------
# MobileViTV2 and the bench entry
# --------------------------------------------------------------------------

def mobilevitv2():
    from picklebot_tpu_torch.models.mobilevitv2 import MobileViTV2
    return MobileViTV2(num_classes=13, seed=0)


def image_batch(batch, seed):
    """uint8 (batch, 256, 256, 3) images from a numpy seed."""
    return np.random.RandomState(seed).randint(
        0, 256, (batch, V2_SIZE, V2_SIZE, 3), np.uint8)


def f32_train_grads(model, feats, labels, device):
    """One f32 train step (AdamW, one microbatch) of a copy of ``model``
    on ``device``: the loss and every parameter's gradient, on the CPU."""
    import copy
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.train.optim import AdamW
    from picklebot_tpu_torch.train.step import make_train_step
    m = copy.deepcopy(model).to(device)
    step = make_train_step(m, AdamW(m.parameters()), "CE",
                           lambda epoch: 3e-4, DtypePolicy.f32(),
                           device=device)
    metrics = step(0, feats[None], labels[None])
    return float(metrics["loss"][0]), {
        n: p.grad.float().cpu() for n, p in m.named_parameters()}


def grads_close(label, truth, got):
    """Every leaf of ``got`` within GRAD_F32_RMS_TOL (rms) and
    GRAD_F32_MIN_COS of ``truth``; a leaf whose reference is below the
    noise floor (GRAD_NOISE_FLOOR of the median leaf's rms) only within
    that floor. Returns the worst leaf's numbers."""
    import torch

    def rms(t):
        return t.pow(2).mean().sqrt().item()
    scale = {n: rms(g) for n, g in truth.items()}
    floor = GRAD_NOISE_FLOOR * sorted(scale.values())[len(scale) // 2]
    bad, stats, noise = [], {}, []
    for n, ref in truth.items():
        diff = rms(got[n] - ref)
        if scale[n] < floor:
            noise.append(n)
            if diff > floor:
                bad.append((n, "noise leaf", diff))
            continue
        st = stats[n] = {"rms": diff / scale[n], "cos": torch.nn.functional
                         .cosine_similarity(got[n].flatten(), ref.flatten(),
                                            dim=0).item()}
        if st["rms"] > GRAD_F32_RMS_TOL or st["cos"] < GRAD_F32_MIN_COS:
            bad.append((n, st))
    if bad:
        raise AssertionError(f"{label} gradients: {bad[:6]}")
    return {"leaves": len(truth), "noise_leaves": noise,
            "worst_rms": max(v["rms"] for v in stats.values()),
            "worst_cos": min(v["cos"] for v in stats.values())}


def phase_v2(gpu_line, counters):
    """MobileViTV2 at full width on 256x256 images, which runs no
    hand-written kernel: BatchNorms calibrated on one bs-8 batch; f32
    logits (TF32 off) against the CPU's, bf16 against the card's f32; one
    f32 train step against the same step on the CPU; the bs-32 forward
    (CUDA events) and bf16 train step (host clock, data on the card),
    peak memory and traces of each. Every launch count must stay 0."""
    import copy
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.train.step import preprocess
    t_start = time.perf_counter()
    model = mobilevitv2().cuda().eval()
    feats = image_batch(V2_CHECK_BATCH, 0)
    labels = np.arange(V2_CHECK_BATCH) % 13
    x = preprocess(torch.from_numpy(feats).cuda(), torch.float32)
    calibrate_batchnorm(model, x)
    zero_counters(counters)
    with torch.inference_mode():
        with DtypePolicy.f32().precision():
            card_f32 = model(x).float()
        card_bf16 = model(x.bfloat16()).float()
    cpu_model = copy.deepcopy(model).cpu()
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu_f32 = cpu_model(x.cpu())
    cpu_forward_s = time.perf_counter() - t0
    if tuple(card_f32.shape) != (V2_CHECK_BATCH, 13) or not bool(
            torch.isfinite(card_f32).all()):
        raise AssertionError(f"MobileViTV2 logits: shape "
                             f"{tuple(card_f32.shape)}, or not finite")
    f32_err = (card_f32.cpu() - cpu_f32).abs().max().item()
    f32_tol = V2_F32_LOGIT_TOL * cpu_f32.abs().max().item()
    if f32_err > f32_tol:
        raise AssertionError(f"MobileViTV2 f32 logits, card vs CPU: max abs "
                             f"err {f32_err} (tol {f32_tol})")
    bf16 = logits_against_plain("MobileViTV2 bf16 vs card f32", card_bf16,
                                card_f32)
    t0 = time.perf_counter()
    cpu_loss, cpu_grads = f32_train_grads(cpu_model, feats, labels, "cpu")
    cpu_step_s = time.perf_counter() - t0
    card_loss, card_grads = f32_train_grads(
        model, torch.from_numpy(feats).cuda(),
        torch.as_tensor(labels, device="cuda"), "cuda")
    if abs(card_loss - cpu_loss) > F32_LOSS_REL_TOL * abs(cpu_loss):
        raise AssertionError(f"MobileViTV2 f32 train loss: card {card_loss}"
                             f", CPU {cpu_loss}")
    grads = grads_close("MobileViTV2 f32 train step, card vs CPU",
                        cpu_grads, card_grads)
    checks = {"phase": "v2", "model": "MobileViTV2", "batch": V2_CHECK_BATCH,
              "image": [V2_SIZE, V2_SIZE],
              "f32_logits_max_abs_err": f32_err, "f32_tol": f32_tol,
              "logits_max_abs": cpu_f32.abs().max().item(),
              "bf16_against_f32": bf16,
              "f32_train_loss": {"card": card_loss, "cpu": cpu_loss},
              "f32_train_grads": grads, "cpu_forward_s": cpu_forward_s,
              "cpu_train_step_s": cpu_step_s}
    emit(checks)

    feats32 = torch.from_numpy(image_batch(V2_TIMED_BATCH, 1)).cuda()
    x32 = preprocess(feats32, torch.bfloat16)

    def forward():
        with torch.inference_mode():
            model(x32)
    forward_ms = time_ms(forward, reps=10)
    step, _ = train_step_for(mobilevitv2().cuda())
    f = feats32[None]
    lb = torch.as_tensor(np.arange(V2_TIMED_BATCH) % 13, device="cuda")[None]
    for _ in range(2):
        step(0, f, lb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        step(0, f, lb)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    peak = torch.cuda.max_memory_allocated()
    res = {"phase": "v2", "model": "MobileViTV2", "batch": V2_TIMED_BATCH,
           "image": [V2_SIZE, V2_SIZE], "dtype": "bfloat16",
           "forward_ms": forward_ms, "train_step_ms": step_ms,
           "images_per_s": V2_TIMED_BATCH * 1e3 / step_ms,
           "optimizer": "adamw8bit", "peak_memory_bytes": peak,
           "card": gpu_line}
    emit(res)
    res["profile"] = profile_run("MobileViTV2 forward", forward, "v2_profile")
    res["train_profile"] = profile_run("MobileViTV2 train step",
                                       lambda: step(0, f, lb),
                                       "v2_train_profile")
    launches = read_counters(counters)
    if launches != launches_wanted():
        raise AssertionError(f"MobileViTV2 launched {launches}, want none")
    res.update(checks=checks, launches=launches,
               seconds=time.perf_counter() - t_start)
    emit({"phase": "v2", "launches": launches, "seconds": res["seconds"]})
    return res


def phase_bench(counters):
    """``picklebot_tpu_torch.bench`` in process on each of BENCH_RUNS,
    every launch count set to 0 just before and read just after: one JSON
    line each with a value above 0 and the card; the Large3D run on the
    fused main kernel, the MobileViTV2 run on none."""
    from picklebot_tpu_torch import bench
    out = []
    for argv in BENCH_RUNS:
        t0 = time.perf_counter()
        zero_counters(counters)
        line = bench.main(argv)
        launches = read_counters(counters)
        model = argv[1]
        if not line["value"] > 0 or not line["device"] or line[
                "vs_baseline"] is not None:
            raise AssertionError(f"bench {model}: {line}")
        if model == "MobileNetLarge3D" and not launches["fused"]["main"]:
            raise AssertionError(f"bench {model} launched {launches}: the "
                                 "fused main kernel never ran")
        if model == "MobileViTV2" and launches != launches_wanted():
            raise AssertionError(f"bench {model} launched {launches}, want "
                                 "none")
        rec = {"phase": "bench", "argv": argv, "line": line,
               "launches": launches, "seconds": time.perf_counter() - t0}
        emit(rec)
        out.append(rec)
    return out


# --------------------------------------------------------------------------
# surface: the in-graph resize, the exported program, the HTTP server
# --------------------------------------------------------------------------

def native_clips(n, seed):
    """``n`` uint8 clips at SURFACE_NATIVE (T, H, W), RGB, from ``seed``."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, *SURFACE_NATIVE, 3), dtype=np.uint8)


def stage_trace(model, feats):
    """One bs-n predict of ``feats`` (host uint8, native size) in its four
    stages (H2D copy, cast and /255, resize, forward with the logits'
    copy back), each closed by a synchronize, under one torch.profiler
    trace. Each stage's time by CUDA events recorded at its ends in that
    call, and its device busy time from the trace: the union of the device
    events that start within the stage's CPU range (the hand-written
    kernels, launched through ctypes, are linked to no torch op, so a
    stage cannot be read from its ops' device time); the H2D copies by
    name."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from picklebot_tpu_torch.ops.resize import resize_frames

    stages = ("h2d", "cast", "resize", "forward")

    def run(marks):
        marks[0].record()
        with record_function("surface_h2d"):
            x = torch.from_numpy(feats).cuda()
            marks[1].record()
            torch.cuda.synchronize()
        with record_function("surface_cast"):
            x = x.to(torch.bfloat16) / 255.0
            marks[2].record()
            torch.cuda.synchronize()
        with record_function("surface_resize"):
            x = resize_frames(x, SURFACE_SIZE)
            marks[3].record()
            torch.cuda.synchronize()
        with record_function("surface_forward"):
            with torch.inference_mode():
                model(x).float().cpu()
            marks[4].record()
            torch.cuda.synchronize()

    def new_marks():
        return [torch.cuda.Event(enable_timing=True) for _ in range(5)]

    run(new_marks())
    marks = new_marks()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(marks)
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = prof.events()
    device = [e for e in events if e.device_type == cuda
              and not e.name.startswith("surface_")]
    ranges = {e.name[len("surface_"):]: e.time_range for e in events
              if e.name.startswith("surface_") and e.device_type == cpu}
    event_ms = {k: marks[i].elapsed_time(marks[i + 1])
                for i, k in enumerate(stages)}
    busy = {k: union_us([(e.time_range.start, e.time_range.end)
                         for e in device
                         if ranges[k].start <= e.time_range.start
                         < ranges[k].end]) / 1e3 for k in stages}
    copies = [(e.time_range.start, e.time_range.end) for e in device
              if "HtoD" in e.name]
    total = sum(event_ms.values())
    if not device or total <= 0:
        raise AssertionError(f"surface trace: {len(device)} device events, "
                             f"stage event ms {event_ms}")
    return {"wall_ms": wall_ms, "stage_event_ms": event_ms,
            "stage_share": {k: v / total for k, v in event_ms.items()},
            "h2d_gb_per_s": feats.nbytes / (event_ms["h2d"] * 1e6),
            "trace_device_busy_ms": busy,
            "trace_h2d_copies_ms": union_us(copies) / 1e3,
            "trace_h2d_copies": len(copies)}


def surface_resize(model, counters):
    """Two native-resolution clips through ``make_predict_fn(input_size=
    224)``: the card's resize (f32, TF32 off) against the CPU's, the
    kernels' launches of the forward and its logits against the plain
    path; then the bs-8 predict's time and one staged trace."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.ops.resize import resize_frames
    from picklebot_tpu_torch.train.step import make_predict_fn, preprocess

    t_start = time.perf_counter()
    clips = native_clips(2, seed=11)
    pixels = torch.from_numpy(clips).float() / 255.0
    want = resize_frames(pixels, SURFACE_SIZE)
    with DtypePolicy.f32().precision():
        got = resize_frames(pixels.cuda(), SURFACE_SIZE).cpu()
    resize_err = (got - want).abs().max().item()
    if got.shape != (2, 32, SURFACE_SIZE, SURFACE_SIZE, 3) or \
            resize_err > RESIZE_ABS_TOL:
        raise AssertionError(f"resize on the card: shape {tuple(got.shape)}"
                             f", max abs err {resize_err} against the CPU "
                             f"(tol {RESIZE_ABS_TOL})")
    del pixels, want, got
    x = preprocess(torch.from_numpy(clips).cuda(), torch.bfloat16,
                   input_size=SURFACE_SIZE)
    # the model's BatchNorms calibrated on these clips, as the serve
    # phase calibrates on its own: logits of O(1) whose argmax means
    # something
    calibrate_batchnorm(model, x)
    predict = make_predict_fn(model, DtypePolicy.bf16(),
                              input_size=SURFACE_SIZE, device="cuda")
    zero_counters(counters)
    logits = predict(clips)
    torch.cuda.synchronize()
    launches = read_counters(counters)
    if launches != launches_wanted(fused={"pool": 8, "main": 15}):
        raise AssertionError(f"surface resize: launches {launches}, want "
                             "pool 8 and main 15")
    check = logits_against_plain(
        "surface resize", torch.from_numpy(logits).cuda(),
        plain_logits("surface resize", model, x))
    del x
    feats8 = np.concatenate([clips] * 4)
    forward_ms = median_ms(lambda: predict(feats8), reps=2, runs=3)
    trace = stage_trace(model, feats8)
    out = {"phase": "surface", "part": "resize",
           "native": list(SURFACE_NATIVE), "size": SURFACE_SIZE,
           "resize_f32_max_abs_err": resize_err,
           "resize_tol": RESIZE_ABS_TOL, "launches": launches,
           **check, "batch": 8, "batch_bytes": feats8.nbytes,
           "forward_ms": forward_ms, "trace": trace,
           "seconds": time.perf_counter() - t_start}
    emit(out)
    return out


def graph_ops(program):
    """{picklebot op: nodes} of an exported program's graph."""
    counts = {}
    for node in program.graph.nodes:
        target = str(node.target)
        if node.op == "call_function" and target.startswith("picklebot."):
            name = target.split(".")[1]
            counts[name] = counts.get(name, 0) + 1
    return counts


def surface_export(label, model, model_name, feats, counters, per_forward,
                   nodes):
    """Export ``model``'s predictor on the card with a symbolic batch,
    save and load it back; the graph's custom-op nodes (``nodes``), the
    loaded program at bs 1, 3 and 8 against the eager predictor (bit-equal
    expected: the same kernels at the same plans; else the serve bound,
    and the reading kept), and the launches over those forwards
    (``per_forward`` each). Returns the record and the loaded predict."""
    import torch
    from picklebot_tpu_torch import export as ex
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.train.step import make_predict_fn

    t0 = time.perf_counter()
    policy = DtypePolicy.bf16()
    program = ex.export_predictor(model, policy, frames=32,
                                  size=SURFACE_SIZE, model_name=model_name,
                                  device="cuda")
    export_s = time.perf_counter() - t0
    found = graph_ops(program)
    if found != nodes:
        raise AssertionError(f"exported {label}: custom-op nodes {found}, "
                             f"want {nodes}")
    meta = {"model_name": model_name, "num_classes": 13, "criterion": "CE",
            "frames": 32, "size": SURFACE_SIZE, "batch": -1,
            "sample_fps": 0.0, "compute_dtype": "bfloat16",
            "device": "cuda:0", "torch_version": torch.__version__}
    t1 = time.perf_counter()
    path = os.path.join(tempfile.mkdtemp(), "program.pt2")
    ex.save_artifact(path, program, meta)
    predict, _ = ex.load_artifact(path, "cuda")
    size = os.path.getsize(path)
    os.remove(path)
    load_s = time.perf_counter() - t1
    eager = make_predict_fn(model, policy, device="cuda")
    readings = []
    zero_counters(counters)
    for b in SURFACE_EXPORT_BATCHES:
        readings.append((b, predict(feats[:b])))
    torch.cuda.synchronize()
    launches = read_counters(counters)
    n = len(SURFACE_EXPORT_BATCHES)
    want = launches_wanted(**{m: {k: v * n for k, v in c.items()}
                              for m, c in per_forward.items()})
    if launches != want:
        raise AssertionError(f"exported {label}: launches {launches} over "
                             f"{n} forwards, want {want}")
    per_batch = {}
    for b, got in readings:
        ref = eager(feats[:b])
        diff = float(np.abs(got - ref).max())
        rec = {"max_abs_diff": diff, "bit_equal": diff == 0.0}
        if diff:
            rec.update(logits_against_plain(
                f"exported {label} bs {b}", torch.from_numpy(got),
                torch.from_numpy(ref)))
        per_batch[str(b)] = rec
    out = {"phase": "surface", "part": f"export_{label}", "nodes": found,
           "launches": launches, "forwards": n, "per_batch": per_batch,
           "export_s": export_s, "save_load_s": load_s,
           "artifact_bytes": size, "seconds": time.perf_counter() - t0}
    emit(out)
    return out, predict


def _post(port, body, timeout=120):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/predict", body=body)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _post_length_only(port, length):
    """POST /predict that declares ``length`` body bytes and sends none:
    the server must answer from the header alone."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", str(length))
        conn.endheaders()
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _healthz(port):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/healthz")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def surface_http(label, records, clips, window, counters):
    """``serve.make_http_server`` in this process over a
    ``RequestBatcher(records)`` at ``window`` ms: HTTP_CLIENTS threads
    send HTTP_POSTS POSTs of ``.npy`` clips (this machine has no cv2, so
    the harness's classify_path ``np.load``s the body; the server takes
    any classify_path). Every answer must be the batcher's record for
    its clip, each batch's records those of the same batch run again in
    process, and, against each clip served alone, pred and label equal
    with the confidence within 1e-3 (the batch size moves the kernels'
    plans); the launches 8 pool and 15 main per predictor call; /healthz
    then counts the POSTs and, after one 413 and one 400 probe, two
    errors."""
    import hashlib
    import io
    import threading
    import torch
    from picklebot_tpu_torch import serve

    bodies, digests = [], []
    for clip in clips:
        buf = io.BytesIO()
        np.save(buf, clip)
        bodies.append(buf.getvalue())
        digests.append(hashlib.sha1(clip.tobytes()).hexdigest())
    calls = []

    def recording(batch):
        recs = records(batch)
        calls.append((batch, recs))
        return recs

    batcher = serve.RequestBatcher(recording, max_batch=8, window_ms=window)
    srv = serve.make_http_server(
        0, lambda path: batcher.submit(np.load(path, allow_pickle=False)),
        {"mode": label}, max_body=HTTP_MAX_BODY, request_timeout=120.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]
    answers = [None] * HTTP_POSTS
    latency = [None] * HTTP_POSTS
    per_client = HTTP_POSTS // HTTP_CLIENTS

    def client(c):
        for j in range(per_client):
            i = c * per_client + j
            t0 = time.perf_counter()
            answers[i] = _post(port, bodies[i % len(bodies)])
            latency[i] = (time.perf_counter() - t0) * 1e3

    try:
        zero_counters(counters)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(HTTP_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = read_counters(counters)
        health = _healthz(port)
        if health["requests"] != HTTP_POSTS or health["errors"] != 0:
            raise AssertionError(f"http {label}: /healthz {health}")
        too_big = _post_length_only(port, HTTP_MAX_BODY + 1)
        not_npy = _post(port, b"not a clip")
        probes = _healthz(port)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    if too_big[0] != 413 or not_npy[0] != 400 or \
            probes["requests"] != HTTP_POSTS + 2 or probes["errors"] != 2:
        raise AssertionError(f"http {label}: probes {too_big} {not_npy}, "
                             f"/healthz {probes}")
    if any(a is None or a[0] != 200 for a in answers):
        raise AssertionError(f"http {label}: answers {answers}")
    n_calls = len(calls)
    if launches != launches_wanted(fused={"pool": 8 * n_calls,
                                          "main": 15 * n_calls}):
        raise AssertionError(f"http {label}: launches {launches} over "
                             f"{n_calls} predictor calls")
    served = {}
    for batch, recs in calls:
        if records(batch) != recs:
            raise AssertionError(f"http {label}: a batch of {len(batch)} "
                                 "gives other records when run again")
        for clip, rec in zip(batch, recs):
            served.setdefault(hashlib.sha1(clip.tobytes()).hexdigest(),
                              []).append(rec)
    alone = [records([clip])[0] for clip in clips]
    conf_diff = 0.0
    for i, (_, rec) in enumerate(answers):
        k = i % len(clips)
        if rec not in served[digests[k]]:
            raise AssertionError(f"http {label}: answer {rec} is no record "
                                 "the batcher made for its clip")
        ref = alone[k]
        if (rec["pred"], rec["label"]) != (ref["pred"], ref["label"]) or \
                abs(rec["confidence"] - ref["confidence"]) > 1e-3:
            raise AssertionError(f"http {label}: answer {rec}, the clip "
                                 f"alone {ref}")
        conf_diff = max(conf_diff, abs(rec["confidence"] - ref["confidence"]))
    lat = sorted(latency)
    out = {"phase": "surface", "part": f"http_{label}", "window_ms": window,
           "posts": HTTP_POSTS, "clients": HTTP_CLIENTS,
           "predictor_calls": n_calls,
           "batch_sizes": [len(b) for b, _ in calls],
           "requests_per_s": HTTP_POSTS / wall_s,
           "latency_p50_ms": lat[len(lat) // 2],
           "latency_p99_ms": lat[min(len(lat) - 1,
                                     int(0.99 * len(lat)))],
           "launches": launches,
           "max_confidence_diff_vs_alone": conf_diff,
           "healthz": probes, "wall_s": wall_s}
    emit(out)
    return out


def phase_surface(gpu_line, feats, x, counters):
    """MobileNetLarge3D at full width (13 classes, bf16, seeded weights,
    BatchNorms calibrated on the resized clips): the in-graph resize of
    native-resolution clips, the exported program (and MobileViT-s's),
    and the HTTP server over the eager model and over the loaded program.
    Fails past SURFACE_MAX_S of its own clock."""
    from picklebot_tpu_torch import serve
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.train.step import make_predict_fn
    from picklebot_tpu_torch.utils.config import Config

    t_start = time.perf_counter()
    model = large3d().cuda().eval()
    out = {"card": gpu_line, "resize": surface_resize(model, counters)}
    out["export_large3d"], artifact = surface_export(
        "large3d", model, "MobileNetLarge3D", feats, counters,
        {"fused": {"pool": 8, "main": 15}},
        {"fused_pool": 8, "fused_main": 15})
    vit = mobilevit_s().cuda().eval()
    calibrate_batchnorm(vit, x)
    packed = sum(VIT_PACKED.values())
    out["export_mobilevit"], _ = surface_export(
        "mobilevit", vit, "MobileViT", feats, counters,
        {"fused": {"main": 7}, "flash": {"packed": packed},
         "conv": {"fwd": 6}},
        {"fused_main": 7, "flash_packed": packed, "folded_conv_fwd": 6})
    del vit
    config = Config(model_name="MobileNetLarge3D", num_classes=13,
                    t_bucket=16, max_frames=128).validate()
    eager = serve.records_fn(make_predict_fn(model, DtypePolicy.bf16(),
                                             device="cuda"), config, 8)
    exported = serve.exported_records_fn(
        artifact, {"criterion": "CE", "num_classes": 13, "batch": -1}, 8)
    clips = list(feats)
    for label, records in (("eager", eager), ("exported", exported)):
        for window in HTTP_WINDOWS:
            out[f"http_{label}_{window:g}"] = surface_http(
                label, records, clips, window, counters)
    out["seconds"] = time.perf_counter() - t_start
    emit({"phase": "surface", "card": gpu_line, "seconds": out["seconds"]})
    if out["seconds"] > SURFACE_MAX_S:
        raise AssertionError(f"surface phase took {out['seconds']:.1f} s "
                             f"(at most {SURFACE_MAX_S})")
    return out


# --------------------------------------------------------------------------
# tooling: native I/O, the CLI's profilers and autotuner, the summary
# --------------------------------------------------------------------------

def tooling_collate():
    """The native collate of TOOLING_CLIPS ragged clips against the numpy
    path (the same bytes), each timed by the host clock (median of 5);
    the numpy reference calls are taken off the counter again."""
    from picklebot_tpu_torch.data import native
    from picklebot_tpu_torch.data.dataset import pad_collate
    rng = np.random.RandomState(14)
    lengths = rng.randint(TOOLING_T[0], TOOLING_T[1] + 1, TOOLING_CLIPS)
    clips = [rng.randint(0, 256, (t, 224, 224, 3), np.uint8)
             for t in lengths]
    labels = list(range(TOOLING_CLIPS))
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise AssertionError("tooling: the native collate did not build: "
                             f"{native.build_error('collate')}")
    build_s = time.perf_counter() - t0

    def timed(**kw):
        times, batch = [], None
        for _ in range(5):
            t0 = time.perf_counter()
            batch, _ = pad_collate(clips, labels, 8, TOOLING_MAX_FRAMES,
                                   **kw)
            times.append((time.perf_counter() - t0) * 1e3)
        return batch, sorted(times)[2]
    before = dict(native.COLLATES)
    got, native_ms = timed()
    moved = native.COLLATES["native"] - before["native"]
    want, numpy_ms = timed(native=False)
    native.COLLATES["numpy"] = before["numpy"]
    if moved != 5 or native.COLLATES["numpy"] != before["numpy"]:
        raise AssertionError(f"tooling: the native collate counted {moved} "
                             "of 5 calls")
    if got.shape != (TOOLING_CLIPS, TOOLING_MAX_FRAMES, 224, 224, 3) or \
            got.tobytes() != want.tobytes():
        raise AssertionError("tooling: the native collate's batch is not "
                             "the numpy path's")
    out = {"clip_frames": lengths.tolist(), "batch_shape": list(got.shape),
           "bit_equal": True, "native_collates": moved,
           "build_or_load_s": build_s, "native_ms": native_ms,
           "numpy_ms": numpy_ms, "timing": "host clock, median of 5"}
    emit({"phase": "tooling", "part": "collate", **out})
    return out


def tooling_decode(counters):
    """The ffmpeg backend where its library builds: the fixture decoded
    byte-exact against its stored frames, then served through serve's
    --csv with data_backend ffmpeg on MobileNetLarge3D bf16 (exact
    launches). Where it does not build, the build error's first line."""
    from picklebot_tpu_torch import serve
    from picklebot_tpu_torch.data import native
    out = {"ffmpeg_available": native.ffmpeg_available()}
    if not out["ffmpeg_available"]:
        lines = (native.build_error("videodec") or "").strip().splitlines()
        # the compiler's first error, else the message's first line
        out["build_error"] = next((l for l in lines if "error" in l),
                                  lines[0] if lines else "")
        print(f"ffmpeg decode backend unavailable: {out['build_error']}",
              flush=True)
        emit({"phase": "tooling", "part": "decode", **out})
        return out
    want = np.load(FIXTURE_RGB)
    t0 = time.perf_counter()
    got = native.decode_video_ffmpeg(FIXTURE)
    out["decode_ms"] = (time.perf_counter() - t0) * 1e3
    if got.shape != want.shape or got.tobytes() != want.tobytes():
        raise AssertionError(f"tooling: ffmpeg decode of the fixture "
                             f"{got.shape} is not its stored frames "
                             f"{want.shape}")
    out["fixture"] = {"shape": list(got.shape), "byte_exact": True}
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "ann.csv")
        with open(csv, "w") as f:
            f.write(f"filename,zone\n{os.path.basename(FIXTURE)},5\n")
        cfg_path = os.path.join(tmp, "cfg.json")
        with open(cfg_path, "w") as f:
            json.dump(serve_config(
                "MobileNetLarge3D", data_backend="ffmpeg",
                video_paths=os.path.dirname(FIXTURE), input_size=224), f)
        pth = os.path.join(tmp, "weights.pth")
        import torch
        torch.save(large3d().state_dict(), pth)
        zero_counters(counters)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc = serve.main([cfg_path, "--checkpoint", pth, "--csv", csv,
                             "--batch", "8"])
        torch.cuda.synchronize()
        launches = read_counters(counters)
    lines = [json.loads(l) for l in text.getvalue().splitlines()
             if l.startswith("{")]
    want_launches = launches_wanted(fused={"pool": 8, "main": 15})
    if rc != 0 or not lines or lines[-1].get("evaluated") != 1 or \
            launches != want_launches:
        raise AssertionError(f"tooling: serve --csv through ffmpeg: rc {rc}, "
                             f"lines {lines}, launches {launches}")
    out["serve"] = {"records": lines, "launches": launches}
    emit({"phase": "tooling", "part": "decode", **out})
    return out


def trace_kernel_counts(trace_dir, stems):
    """Kernel events of the torch.profiler trace(s) in ``trace_dir`` whose
    name holds each stem, counted over the whole trace (the profiler's
    device events do not always fall inside their CPU ranges on the
    card's machine): ({stem: count}, events, MB, seconds to read). The
    trace runs to hundreds of MB, so it is searched for each event's
    ``"cat": "kernel", "name": ...`` pair rather than parsed; a count
    that misses the launches fails the phase."""
    import glob
    import re
    pair = re.compile(r'"kernel",\s*"name":\s*"([^"]*)"')
    t0 = time.perf_counter()
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if not files:
        raise AssertionError(f"tooling: no trace written in {trace_dir}")
    counts, events, size = dict.fromkeys(stems, 0), 0, 0
    for path in files:
        size += os.path.getsize(path)
        with open(path) as f:
            text = f.read()
        for m in pair.finditer(text):
            events += 1
            for stem in stems:
                counts[stem] += stem in m.group(1)
    return counts, events, size / 2 ** 20, time.perf_counter() - t0


def tooling_cli(counters):
    """The CLI in process on configs/mobilenet_large_50k.json cut to
    TOOLING_CUTS, ``--steps 2 --profile --torch-profile-dir`` with
    ``autotune`` on and its cache in a temporary file, in a temporary
    working directory: the trace names the fused pool and main kernels
    exactly as often as LAUNCHES counted over the run (the autotuner's
    measurements included), train_stats.prof is written, the cache holds
    one entry with both candidates, every batch went through the native
    collate, and a second autotune_config measures nothing."""
    import math
    import torch
    from picklebot_tpu_torch import cli
    from picklebot_tpu_torch.data import native
    from picklebot_tpu_torch.utils import autotune, profiling
    from picklebot_tpu_torch.utils.config import load_config

    t_start = time.perf_counter()
    prev_cache = os.environ.get("PICKLEBOT_AUTOTUNE_CACHE")
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        cache = os.path.join(tmp, "autotune.json")
        os.environ["PICKLEBOT_AUTOTUNE_CACHE"] = cache
        try:
            with open(os.path.join(ROOT, "configs",
                                   "mobilenet_large_50k.json")) as f:
                cfg = json.load(f)
            reduced = {k: {"from": cfg.get(k), "to": v}
                       for k, v in TOOLING_CUTS.items() if cfg.get(k) != v}
            cfg.update(TOOLING_CUTS, checkpoint_dir=os.path.join(tmp, "ck"),
                       log_dir=os.path.join(tmp, "runs"))
            path = os.path.join(tmp, "cfg.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            trace_dir = os.path.join(tmp, "trace")
            zero_counters(counters)
            collates = dict(native.COLLATES)
            torch.cuda.reset_peak_memory_stats()
            text = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                summary = cli.main([path, "--steps", str(TOOLING_STEPS),
                                    "--profile", "--torch-profile-dir",
                                    trace_dir])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counters(counters)
            peak = torch.cuda.max_memory_allocated()
            memory = profiling.memory_stats()
            stems = ("pool_bf16_kernel", "main_bf16_kernel")
            in_trace, events, trace_mb, read_s = trace_kernel_counts(
                trace_dir, stems)
            with open(cache) as f:
                entries = json.load(f)
            n_micro = TOOLING_STEPS * (TOOLING_CUTS["effective_batch_size"]
                                       // TOOLING_CUTS["batch_size"])
            n_eval = -(-TOOLING_CUTS["synthetic_len"]
                       // TOOLING_CUTS["batch_size"])
            batches = {k: native.COLLATES[k] - collates[k]
                       for k in collates}
            prof_written = os.path.exists(os.path.join(tmp,
                                                       "train_stats.prof"))
            # the same config again: a cache hit, no measurement
            config = load_config(path)
            before = open(cache).read()
            zero_counters(counters)
            _, again = autotune.autotune_config(config, "train",
                                                device="cuda")
            torch.cuda.synchronize()
            second = read_counters(counters)
            cache_unchanged = open(cache).read() == before
        finally:
            if prev_cache is None:
                os.environ.pop("PICKLEBOT_AUTOTUNE_CACHE", None)
            else:
                os.environ["PICKLEBOT_AUTOTUNE_CACHE"] = prev_cache
    key, entry = next(iter(entries.items())) if len(entries) == 1 \
        else (None, None)
    fused = launches["fused"]
    problems = []
    if fused["pool"] != in_trace["pool_bf16_kernel"] or \
            fused["main"] != in_trace["main_bf16_kernel"]:
        problems.append(f"trace {in_trace} against launches {fused}")
    if fused["pool"] < 8 * (n_micro + n_eval) or \
            fused["main"] < 15 * (n_micro + n_eval) or \
            any(any(c.values()) for n, c in launches.items()
                if n != "fused"):
        problems.append(f"launches {launches}")
    if not prof_written:
        problems.append("no train_stats.prof")
    if entry is None or set(entry["measured"]) != {"benchmark_off",
                                                   "benchmark_on"}:
        problems.append(f"autotune cache {entries}")
    if batches != {"native": n_micro + n_eval, "numpy": 0}:
        problems.append(f"collates {batches}, want {n_micro + n_eval} "
                        "native")
    if any(any(c.values()) for c in second.values()) or \
            not cache_unchanged or entry is None or \
            again != entry["benchmark"]:
        problems.append(f"second autotune_config: launches {second}, "
                        f"cache unchanged {cache_unchanged}")
    losses = summary["train_losses"]
    if len(losses) != n_micro or not all(map(math.isfinite, losses)):
        problems.append(f"losses {losses}")
    if problems:
        raise AssertionError("tooling: the CLI run: " + "; ".join(problems))
    out = {"config": "configs/mobilenet_large_50k.json", "width": "full",
           "reduced": reduced, "steps": TOOLING_STEPS,
           "launches": launches, "trace_counts": in_trace,
           "trace_kernel_events": events, "trace_mb": trace_mb,
           "trace_read_s": read_s, "train_stats_prof": True,
           "autotune_key": key, "autotune_entry": entry,
           "collates": batches, "cli_wall_s": wall,
           "peak_memory_bytes": peak, "memory_stats": memory,
           "train_losses": losses,
           "seconds": time.perf_counter() - t_start}
    emit({"phase": "tooling", "part": "cli", **out})
    return out


def tooling_autotune_readings():
    """Readings, not gates: the autotuner's per-candidate times for
    MobileNetLarge3D train bs 8 and MoViNet-A2 infer bs 8 (32x224x224,
    bf16, a fresh cache), and the device kernels of one MoViNetA2Stream
    chunk-1 step traced with cudnn.benchmark off and on."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.serve import stream_clip
    from picklebot_tpu_torch.utils import autotune
    from picklebot_tpu_torch.utils.config import Config
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "autotune.json")
        for label, name, mode in (("MobileNetLarge3D", "MobileNetLarge3D",
                                   "train"),
                                  ("MoViNet-A2", "MoViNetA2", "infer")):
            cfg = Config(model_name=name, num_classes=13, batch_size=8,
                         effective_batch_size=8,
                         synthetic_shape=(32, 224, 224)).validate()
            t0 = time.perf_counter()
            winner = autotune.autotune(cfg, mode, device="cuda",
                                       cache_path=cache)
            with open(cache) as f:
                entry = json.load(f)[autotune._cache_key(
                    cfg, mode, autotune._tune_shape(cfg, mode), "cuda")]
            out[f"{label}_{mode}"] = {
                "benchmark": winner, "samples_per_s": entry["measured"],
                "ms_per_step": entry["ms_per_step"],
                "seconds": time.perf_counter() - t0}
    from torch.profiler import ProfilerActivity, profile
    model = stream_model("MoViNetA2Stream").cuda().eval()
    frames = np.random.RandomState(3).randint(0, 256, (4, 224, 224, 3),
                                              np.uint8)
    for benchmark in (False, True):
        # one chunk-1 step after one warm-up step (cuDNN's search runs
        # there with the flag on), its device kernels only
        with autotune.cudnn_benchmark(benchmark):
            gen = stream_clip(model, frames, 1, DtypePolicy.bf16(), "cuda",
                              "CE", 13)
            next(gen)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                next(gen)
                torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = {}
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
        out[f"stream_chunk1_{autotune.candidate_name(benchmark)}"] = {
            "device_busy_ms": union_us([(e.time_range.start,
                                         e.time_range.end)
                                        for e in kernels]) / 1e3,
            "kernel_launches": len(kernels),
            "top_kernels_ms": [[n[:120], t] for n, t in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:3]]}
    del model
    torch.cuda.empty_cache()
    emit({"phase": "tooling", "part": "autotune_readings", **out})
    return out


def tooling_summary():
    """utils/summary.py on MobileNetLarge3D and MobileViT-s: the totals
    against SUMMARY_TOTALS, the forward's GFLOPs per 32x224x224 clip."""
    from picklebot_tpu_torch.utils import summary
    out = {}
    for label, make, name in (("MobileNetLarge3D", large3d,
                               "MobileNetLarge3D"),
                              ("MobileViT-s", mobilevit_s, "MobileViT")):
        model = make()
        rows = summary.param_table(model, name)
        if rows[-1][1] != SUMMARY_TOTALS[label]:
            raise AssertionError(f"tooling: summary of {label} totals "
                                 f"{rows[-1][1]}, not "
                                 f"{SUMMARY_TOTALS[label]}")
        flops = summary.cost_summary(model, (1, 32, 224, 224, 3))["flops"]
        out[label] = {"rows": rows, "total": rows[-1][1],
                      "gflops_per_clip": flops / 1e9}
    emit({"phase": "tooling", "part": "summary",
          **{k: {"total": v["total"], "gflops_per_clip": v[
              "gflops_per_clip"]} for k, v in out.items()}})
    return out


def phase_tooling(gpu_line, counters):
    """Native I/O and the tooling: the collate, the decode backend, the
    CLI with every tool on, the autotuner's readings, the summary.
    Fails past TOOLING_MAX_S of its own clock."""
    t_start = time.perf_counter()
    out = {"card": gpu_line, "collate": tooling_collate(),
           "decode": tooling_decode(counters), "cli": tooling_cli(counters),
           "autotune": tooling_autotune_readings(),
           "summary": tooling_summary()}
    out["seconds"] = time.perf_counter() - t_start
    emit({"phase": "tooling", "card": gpu_line, "seconds": out["seconds"]})
    if out["seconds"] > TOOLING_MAX_S:
        raise AssertionError(f"tooling phase took {out['seconds']:.1f} s "
                             f"(at most {TOOLING_MAX_S})")
    return out


# --------------------------------------------------------------------------
# --ab-forward: Large3D's eager serve forward, this tree against another
# --------------------------------------------------------------------------

# run in a fresh process with the tree at ROOT first on sys.path: Large3D
# (13 classes, seed 0, bf16) on a bs-8 32x224x224 batch, its device busy
# ms from one trace, then three times the forward's CUDA-event ms (median
# of 5 windows of 10 after warm-up), each followed, where the tree routes
# kernel calls through ops/library.py, by the same with every kernel
# call forced through its custom op
AB_SNIPPET = r"""
import importlib.util, json, sys
sys.path.insert(0, {root!r})
spec = importlib.util.spec_from_file_location("cs", {script!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import numpy as np, torch
from picklebot_tpu_torch.utils.build import build_all
build_all()
from picklebot_tpu_torch.train.step import preprocess
model = cs.large3d().cuda().eval()
rng = np.random.RandomState(0)
feats = rng.randint(0, 256, (8, 32, 224, 224, 3)).astype(np.uint8)
x = preprocess(torch.from_numpy(feats).cuda(), torch.bfloat16)

def forward_ms():
    with torch.inference_mode():
        return cs.median_ms(lambda: model(x), reps=10)

with torch.inference_mode():
    prof = cs.profile_run("large3d", lambda: model(x), "ab_forward")
out = {{"root": {root!r}, "device_busy_ms": prof["device_busy_ms"],
        "kernel_launches": prof["kernel_launches"], "forward_ms": [],
        "forward_ms_ops_forced": []}}
try:
    from picklebot_tpu_torch.ops import library
except ImportError:
    library = None
direct = library.use_ops if library is not None else None
for _ in range(3):
    out["forward_ms"].append(forward_ms())
    if library is not None:
        library.use_ops = lambda: True
        out["forward_ms_ops_forced"].append(forward_ms())
        library.use_ops = direct
print("AB " + json.dumps(out), flush=True)
"""


def ab_forward(parent_root):
    """Large3D's eager serve forward of the tree at ``parent_root`` (A)
    and of this tree (B) in turns A B B A A B B A, each in its own
    process."""
    results = []
    for root in (parent_root, ROOT, ROOT, parent_root) * 2:
        proc = subprocess.run(
            [sys.executable, "-c", AB_SNIPPET.format(
                root=root, script=os.path.abspath(__file__))],
            capture_output=True, text=True, timeout=600)
        lines = [l for l in proc.stdout.splitlines() if l.startswith("AB ")]
        if proc.returncode != 0 or not lines:
            raise AssertionError(f"ab_forward on {root}: rc "
                                 f"{proc.returncode}\n{proc.stderr[-3000:]}")
        rec = json.loads(lines[-1][3:])
        rec["tree"] = "parent" if root == parent_root else "change"
        emit({"phase": "ab_forward", **rec})
        results.append(rec)

    def stats(vals):
        vals = sorted(vals)
        mid = len(vals) // 2
        return {"median": (vals[mid] + vals[~mid]) / 2, "min": vals[0],
                "max": vals[-1], "n": len(vals)}
    summary = {
        "parent": stats([v for r in results if r["tree"] == "parent"
                         for v in r["forward_ms"]]),
        "change": stats([v for r in results if r["tree"] == "change"
                         for v in r["forward_ms"]]),
        "change_ops_forced": stats([v for r in results
                                    for v in r["forward_ms_ops_forced"]]),
        "device_busy_ms": stats([r["device_busy_ms"] for r in results])}
    emit({"phase": "ab_forward", "summary": summary})
    return results


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------

def phase_train_cli(label, cfg_file, counters, per_micro, per_eval,
                    stream=False):
    """``python -m picklebot_tpu_torch.cli`` (in process) on
    ``configs/<cfg_file>`` with TRAIN_CUTS, for TRAIN_STEPS steps, every
    launch count set to 0 just before and read just after: the counts
    must be exactly ``per_micro`` per train microbatch (forward and
    backward) plus ``per_eval`` per eval batch. Then the .pth it wrote
    serves 8 clips, and with ``stream`` one 32-frame clip through
    --stream's loop (--chunk 4)."""
    import math
    import torch
    from picklebot_tpu_torch import cli, serve

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(ROOT, "configs", cfg_file)) as f:
            cfg = json.load(f)
        reduced = {k: {"from": cfg.get(k), "to": v}
                   for k, v in TRAIN_CUTS.items() if cfg.get(k) != v}
        cfg.update(TRAIN_CUTS, checkpoint_dir=os.path.join(tmp, "ck"),
                   log_dir=os.path.join(tmp, "runs"))
        path = os.path.join(tmp, "cfg.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        emit({"phase": "train", "model": label,
              "config": f"configs/{cfg_file}", "width": "full",
              "reduced": reduced, "steps": {"from": None,
                                            "to": TRAIN_STEPS}})
        zero_counters(counters)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.chdir(tmp):
            summary = cli.main([path, "--steps", str(TRAIN_STEPS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters(counters)
        n_micro = TRAIN_STEPS * (TRAIN_CUTS["effective_batch_size"]
                                 // TRAIN_CUTS["batch_size"])
        n_eval = -(-TRAIN_CUTS["synthetic_len"] // TRAIN_CUTS["batch_size"])
        want = {c: {k: per_micro[c][k] * n_micro + per_eval[c][k] * n_eval
                    for k in per_micro[c]} for c in per_micro}
        if launches != want:
            raise AssertionError(f"train {label}: launches {launches}, "
                                 f"want {want}")
        losses = summary["train_losses"]
        if len(losses) != n_micro or not all(
                math.isfinite(v) for v in losses + [summary[
                    "final_val_loss"]]):
            raise AssertionError(f"train {label}: losses {losses}, val "
                                 f"{summary['final_val_loss']}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = serve.main([path, "--checkpoint", summary["checkpoint"],
                             "--csv", "synthetic", "--limit", "8",
                             "--batch", "8"])
        preds = [json.loads(line) for line in out.getvalue().splitlines()
                 if line.startswith('{"clip"')]
        if rc != 0 or len(preds) != 8:
            raise AssertionError(f"train {label}: serving the .pth gave rc "
                                 f"{rc}, {len(preds)} predictions")
        if stream:
            from picklebot_tpu_torch.convert import load_pth
            from picklebot_tpu_torch.core.policy import DtypePolicy
            model = load_pth(summary["checkpoint"], stream_model(label))
            clip = np.random.RandomState(4).randint(
                0, 256, (32, 224, 224, 3), np.uint8)
            records = streamed(model.cuda().eval(), clip, 4,
                               DtypePolicy.bf16())
            check_records(f"train {label} .pth", records, 32, 4)
    res = {"phase": "train", "model": label, "launches": launches,
           "launches_per_microbatch": per_micro,
           "launches_per_eval_batch": per_eval, "microbatches": n_micro,
           "eval_batches": n_eval, "train_losses": losses,
           "val_loss": summary["final_val_loss"], "cli_wall_s": wall,
           "pth_served": len(preds),
           "pth_streamed": len(records) if stream else None,
           "seconds": time.perf_counter() - t_start}
    emit(res)
    return res


def mobilevit_s(backend="auto"):
    from picklebot_tpu_torch.models.mobilevit import (MOBILEVIT_CONFIGS,
                                                      MobileViT)
    return MobileViT(num_classes=13, seed=0, attention_backend=backend,
                     **MOBILEVIT_CONFIGS["s"])


def large3d():
    from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D
    return MobileNetLarge3D(13, seed=0)


def small3d():
    from picklebot_tpu_torch.models.mobilenet3d import MobileNetSmall3D
    return MobileNetSmall3D(13, seed=0)


def movinet_a2():
    from picklebot_tpu_torch.models.movinet import MoViNetA2
    return MoViNetA2(13, seed=0)


def train_step_for(model, remat=0):
    """The port's train step (AdamW8bit, bf16, constant lr) on the card."""
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.train.optim import AdamW8bit
    from picklebot_tpu_torch.train.step import make_train_step
    opt = AdamW8bit(model.parameters(), weight_decay=5e-4)
    return make_train_step(model, opt, "CE", lambda epoch: 3e-4,
                           DtypePolicy.bf16(), device="cuda",
                           remat=remat), opt


def phase_train_backends(counters, feats, labels):
    """One MobileViT-s train step (one bs-8 microbatch) each with
    'pallas' and 'pallas_packed': every layer's attention forward and
    backward on the per-head kernels, 9 launches each."""
    import math
    import torch
    out = {}
    want = launches_wanted(fused={"main": 7, **dw(7)},
                           flash={"heads": 9, "dq": 9, "dkv": 9},
                           conv={"fwd": 6, "dx": 6})
    for backend in ("pallas", "pallas_packed"):
        step, _ = train_step_for(mobilevit_s(backend).cuda())
        zero_counters(counters)
        metrics = step(0, feats[None], labels[None])
        torch.cuda.synchronize()
        launches = read_counters(counters)
        loss = float(metrics["loss"][0])
        if launches != want or not math.isfinite(loss):
            raise AssertionError(f"train step {backend}: launches "
                                 f"{launches} (want {want}), loss {loss}")
        out[backend] = {"launches": launches, "loss": loss}
        emit({"phase": "train", "model": f"MobileViT-s {backend}",
              **out[backend]})
    return out


def grads_against_plain(label, make_model, x, labels):
    """One bs-8 train-mode step's loss and every parameter's gradient,
    kernel path against the plain path (kernels=False), from the same
    seeded weights, dropout p set to 0, in bf16 and in f32 with TF32 off;
    the bounds are stated with GRAD_F32_RMS_TOL above."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.ops.linear import ChannelDropout, Dropout
    from picklebot_tpu_torch.train.losses import cross_entropy
    lbl = torch.as_tensor(labels, device="cuda")
    res = {}
    for dtype, policy in (("bf16", DtypePolicy.bf16()),
                          ("f32", DtypePolicy.f32())):
        for kernels in (True, False):
            m = make_model().cuda().train()
            for mod in m.modules():
                if isinstance(mod, (ChannelDropout, Dropout)):
                    mod.p = 0.0
            with policy.precision():
                loss = cross_entropy(m(x.to(policy.compute_dtype),
                                       kernels=kernels), lbl)
                loss.backward()
            res[dtype, kernels] = (loss.item(), {
                n: p.grad.float() for n, p in m.named_parameters()})
            del m, loss

    def rms(t):
        return t.pow(2).mean().sqrt().item()

    def cos(a, b):
        return torch.nn.functional.cosine_similarity(
            a.flatten(), b.flatten(), dim=0).item()

    bad = []
    for dtype, tol in (("bf16", TRAIN_LOSS_REL_TOL),
                       ("f32", F32_LOSS_REL_TOL)):
        got, want = res[dtype, True][0], res[dtype, False][0]
        if abs(got - want) > tol * abs(want):
            bad.append((f"{dtype} loss", got, want))
    truth, f32_k = res["f32", False][1], res["f32", True][1]
    bf16_k, bf16_p = res["bf16", True][1], res["bf16", False][1]
    scale = {n: rms(g) for n, g in truth.items()}
    floor = GRAD_NOISE_FLOOR * sorted(scale.values())[len(scale) // 2]
    stats, noise = {}, []
    for n, ref in truth.items():
        if scale[n] < floor:
            noise.append(n)
            if rms(f32_k[n] - ref) > floor:
                bad.append((n, "noise leaf", rms(f32_k[n] - ref)))
            continue
        st = stats[n] = dict(
            f32=rms(f32_k[n] - ref) / scale[n], f32_cos=cos(f32_k[n], ref),
            bf16=rms(bf16_k[n] - bf16_p[n]) / rms(bf16_p[n]),
            bf16_cos=cos(bf16_k[n], bf16_p[n]),
            kernel_vs_f32=rms(bf16_k[n] - ref) / scale[n],
            plain_vs_f32=rms(bf16_p[n] - ref) / scale[n])
        if (st["f32"] > GRAD_F32_RMS_TOL or st["f32_cos"] < GRAD_F32_MIN_COS
                or st["kernel_vs_f32"] > GRAD_BF16_FACTOR
                * st["plain_vs_f32"] + GRAD_BF16_SLACK):
            bad.append((n, st))
    worst = {k: max(v[k] for v in stats.values())
             for k in ("f32", "bf16", "kernel_vs_f32", "plain_vs_f32")}
    worst.update(f32_cos=min(v["f32_cos"] for v in stats.values()),
                 bf16_cos=min(v["bf16_cos"] for v in stats.values()),
                 kernel_over_plain_vs_f32=max(
                     v["kernel_vs_f32"] / v["plain_vs_f32"]
                     for v in stats.values()))
    median = {k: sorted(v[k] for v in stats.values())[len(stats) // 2]
              for k in ("kernel_vs_f32", "plain_vs_f32", "bf16")}
    out = {"phase": "train_grads", "model": label,
           "loss": {f"{d} {'kernels' if k else 'plain'}": v[0]
                    for (d, k), v in res.items()},
           "leaves": len(truth), "noise_leaves": noise,
           "noise_floor": floor, "worst": worst, "median": median}
    emit(out)
    if bad:
        raise AssertionError(f"{label} grads against plain: {bad[:6]}")
    return dict(out, per_leaf=stats)


def phase_train_timing(label, make_model, feats, x, labels, gpu_line,
                       vit_turns=False):
    """Train step (bs 8, one microbatch, uint8 host batch -> optimizer
    update) by host clock after a synchronize, samples/s, peak device
    memory over those steps; forward (train mode, with a graph),
    forward+backward and the optimizer update alone by CUDA events; a
    trace of one train step. ``vit_turns`` (MobileViT-s): the step,
    forward and backward once more with conv1/conv4 on the library conv
    (as before the conv kernel), then the step again with the kernel; and
    the step and forward+backward at each of 'auto''s threshold routes
    (``by_packed_min_seq``)."""
    import torch
    from picklebot_tpu_torch.ops.linear import dropout_rng
    from picklebot_tpu_torch.train.losses import cross_entropy
    t_start = time.perf_counter()
    model = make_model().cuda()
    step, opt = train_step_for(model)
    f, lb = feats[None], labels[None]
    for _ in range(2):
        step(0, f, lb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        step(0, f, lb)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    peak = torch.cuda.max_memory_allocated()

    def timed_steps(n=reps):
        step(0, f, lb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step(0, f, lb)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3
    lbl = torch.as_tensor(labels, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model.train()

    def forward():
        with dropout_rng(gen):
            return cross_entropy(model(x), lbl)
    fwd_ms = time_ms(forward, reps)
    fwd_bwd_ms = time_ms(lambda: forward().backward(), reps)
    opt_ms = time_ms(lambda: opt.step(3e-4), reps)
    res = {"phase": "train_timing", "model": label, "batch": 8,
           "clip": [32, 224, 224], "dtype": "bfloat16",
           "optimizer": "adamw8bit", "train_step_ms": step_ms,
           "samples_per_s": 8e3 / step_ms, "forward_ms": fwd_ms,
           "backward_ms": fwd_bwd_ms - fwd_ms, "optimizer_ms": opt_ms,
           "peak_memory_bytes": peak, "card": gpu_line}
    if vit_turns:
        with conv_on_library():
            lib_fwd = time_ms(forward, reps)
            res["conv_on_library"] = {
                "train_step_ms": timed_steps(), "forward_ms": lib_fwd,
                "backward_ms": time_ms(lambda: forward().backward(), reps)
                - lib_fwd}
        res["train_step_ms_again"] = timed_steps()
        res["by_packed_min_seq"] = by_packed_min_seq(lambda: {
            "train_step_ms": timed_steps(TRAIN_TURN_REPS),
            "forward_backward_ms": time_ms(lambda: forward().backward(),
                                           TRAIN_TURN_REPS)})
    emit(res)
    res["profile"] = profile_run(f"{label} train step",
                                 lambda: step(0, f, lb), "train_profile")
    res["seconds"] = time.perf_counter() - t_start
    return res


# --------------------------------------------------------------------------
# trainx: the trainer extras
# --------------------------------------------------------------------------

# the trainx phase's CLI config: the train phase's cuts of
# configs/mobilenet_large_50k.json, 2 epochs of 3 steps, with every extra
# of the trainer on; 40-frame clips, so that temporal_jitter takes a
# random 32-frame window of each
TRAINX_CUTS = dict(TRAIN_CUTS, synthetic_shape=[40, 224, 224], max_frames=32,
                   t_bucket=16, max_iters=2, eval_interval=1,
                   ema_decay=0.99, freeze_params=["block1"],
                   augment_flip=True, augment_crop=8, augment_brightness=0.2,
                   remat=1, temporal_jitter=True, checkpoint_every_steps=1,
                   keep_checkpoints=2, save_best=True, early_stop_patience=1)
TRAINX_INTERRUPT_AFTER = 2    # run B: SIGTERM after optimizer step 2
# Large3D launches with remat 1: every bottleneck is a call of the root,
# so each train microbatch runs its pool and main passes twice (forward,
# recompute), the backward's stencil kernels once; eval batches once
TRAINX_PER_MICRO = {"pool": 16, "main": 30, **dw(15)}
TRAINX_PER_EVAL = {"pool": 8, "main": 15}
# MobileViT-s, one bs-8 microbatch with remat 1: every forward kernel
# twice, the backward kernels once
VIT_REMAT_LAUNCHES = {0: {"fused": {"main": 7, **dw(7)},
                          "flash": {"packed": 9, "dq": 9, "dkv": 9},
                          "conv": {"fwd": 6, "dx": 6}},
                      1: {"fused": {"main": 14, **dw(7)},
                          "flash": {"packed": 18, "dq": 9, "dkv": 9},
                          "conv": {"fwd": 12, "dx": 6}}}
REMAT_F32_GRAD_TOL = 1e-6     # of max|ref|, every gradient and buffer


@contextlib.contextmanager
def _interrupted(after):
    """Within the block the trainer's train step sends the process SIGTERM
    before its (after + 1)-th call: a preemption that the loop's handler
    ends gracefully. A patch inside the script."""
    import signal
    from picklebot_tpu_torch.train import loop
    real = loop.make_train_step
    calls = []

    def make(*a, **k):
        fn = real(*a, **k)

        def step(*args):
            if len(calls) >= after:
                os.kill(os.getpid(), signal.SIGTERM)
            calls.append(1)
            return fn(*args)
        return step
    loop.make_train_step = make
    try:
        yield
    finally:
        loop.make_train_step = real


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (warn-only, so that an op without
    one is named, not fatal) with CUBLAS_WORKSPACE_CONFIG set, for the
    block only."""
    import torch
    prev_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if prev_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_env


def _cli_run(cfg_path, counters):
    import torch
    from picklebot_tpu_torch import cli
    zero_counters(counters)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        summary = cli.main([cfg_path])
    torch.cuda.synchronize()
    return summary, read_counters(counters)["fused"], \
        time.perf_counter() - t0, out.getvalue()


def _state_diff(a, b):
    """Max |a - b| over the tensors of two snapshots' model, ema and
    optimizer state, by part; 0.0 everywhere is bit equality."""
    import torch

    def flat(p):
        out = {f"model.{k}": v for k, v in p["model"].items()}
        out.update({f"ema.{k}": v for k, v in p["ema"].items()})
        for part in ("m", "v"):
            for i, st in enumerate(p["optimizer"][part]):
                for j, t in enumerate(st if isinstance(st, tuple)
                                      else (st,)):
                    out[f"optimizer.{part}.{i}.{j}"] = t
        for k in ("loop_state", "early_stop"):
            out[k] = p[k]
        return out
    fa, fb = flat(a), flat(b)
    if fa.keys() != fb.keys():
        raise AssertionError("trainx: the two snapshots hold different "
                             "tensors")
    diff = {}
    for k, v in fa.items():
        d = (v.double() - fb[k].double()).abs().max().item() \
            if v.numel() else 0.0
        part = k.split(".")[0]
        diff[part] = max(diff.get(part, 0.0), d)
    diff["optimizer_steps"] = abs(a["optimizer"]["steps"]
                                  - b["optimizer"]["steps"])
    diff["epoch"] = abs(a["epoch"] - b["epoch"])
    return diff, not any(torch.is_tensor(v) and not torch.equal(v, fb[k])
                         for k, v in fa.items())


def phase_trainx_cli(counters):
    """The CLI on MobileNetLarge3D at full width with every trainer extra
    (TRAINX_CUTS): run A uninterrupted; run B stopped by SIGTERM after
    optimizer step 2 and finished by auto_resume. Deterministic algorithms
    on (CUBLAS_WORKSPACE_CONFIG set for the phase only): B's tail losses
    and final snapshot (weights, BatchNorm buffers, EMA, optimizer, loop
    and early-stop state) equal A's bit for bit; the exact fused launches
    of each run, the remat recompute included; the frozen stem at its
    initial value and outside the optimizer; the snapshots, _best/ and
    statistics/*.npy written; A's .pth served."""
    import warnings
    import torch
    from picklebot_tpu_torch import serve
    from picklebot_tpu_torch.models.registry import initialize_model
    from picklebot_tpu_torch.train import checkpoint as ckpt
    from picklebot_tpu_torch.utils.config import load_config

    t_start = time.perf_counter()
    res = {"phase": "trainx", "model": "MobileNetLarge3D"}
    with deterministic(), tempfile.TemporaryDirectory() as tmp, \
            contextlib.chdir(tmp), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with open(os.path.join(ROOT, "configs",
                               "mobilenet_large_50k.json")) as f:
            cfg = json.load(f)
        reduced = {k: {"from": cfg.get(k), "to": v}
                   for k, v in TRAINX_CUTS.items() if cfg.get(k) != v}
        emit({"phase": "trainx", "model": "MobileNetLarge3D",
              "config": "configs/mobilenet_large_50k.json",
              "width": "full", "reduced": reduced})
        paths = {}
        for run in ("a", "b"):
            cfg.update(TRAINX_CUTS,
                       checkpoint_dir=os.path.join(tmp, run, "ck"),
                       log_dir=os.path.join(tmp, run, "runs"))
            paths[run] = os.path.join(tmp, f"{run}.json")
            with open(paths[run], "w") as f:
                json.dump(cfg, f)
        config = load_config(paths["a"])
        n_steps = (config.synthetic_len // config.batch_size
                   // config.grad_accum_steps)
        accum = config.grad_accum_steps
        n_eval = -(-config.synthetic_len // config.batch_size)

        def want(micro, evals):
            return {k: TRAINX_PER_MICRO[k] * micro
                    + TRAINX_PER_EVAL.get(k, 0) * evals
                    for k in TRAINX_PER_MICRO}

        a, launch_a, wall_a, _ = _cli_run(paths["a"], counters)
        n_evals = len(a["val_losses"])
        runs = {"a": launch_a}
        with _interrupted(TRAINX_INTERRUPT_AFTER):
            b1, runs["b_interrupted"], wall_b1, _ = _cli_run(
                paths["b"], counters)
        with open(paths["b"]) as f:
            cfg_b = dict(json.load(f), auto_resume=True)
        with open(paths["b"], "w") as f:
            json.dump(cfg_b, f)
        b2, runs["b_resumed"], wall_b2, log_b2 = _cli_run(paths["b"],
                                                          counters)
        done = TRAINX_INTERRUPT_AFTER * accum
        wanted = {
            "a": want(n_steps * config.max_iters * accum,
                      n_eval * n_evals),
            "b_interrupted": want(done, 0),
            "b_resumed": want(len(a["train_losses"]) - done,
                              n_eval * n_evals)}
        if runs != wanted:
            raise AssertionError(f"trainx: fused launches {runs}, want "
                                 f"{wanted}")
        if "auto_resume: found" not in log_b2:
            raise AssertionError("trainx: run B did not resume from a "
                                 "snapshot")
        fins = {run: ckpt.load_checkpoint(ckpt.latest_checkpoint(
            os.path.join(tmp, run, "ck",
                         f"{config.run_name()}_finished")))
            for run in ("a", "b")}
        diff, bit_equal = _state_diff(fins["a"], fins["b"])
        tail_equal = (b1["train_losses"] == a["train_losses"][:done]
                      and b2["train_losses"] == a["train_losses"][done:])
        refused = sorted({str(w.message).split(" does not have")[0]
                          for w in caught
                          if "deterministic" in str(w.message)})
        if not (bit_equal and tail_equal):
            if not refused:
                raise AssertionError(
                    f"trainx: the resumed run differs from the "
                    f"uninterrupted one ({diff}) and no op refused "
                    f"determinism")
            lr = config.learning_rate
            bound = 2 * lr * len(b2["train_losses"])
            loss_ok = all(abs(x - y) <= TRAIN_LOSS_REL_TOL * abs(y)
                          for x, y in zip(b1["train_losses"]
                                          + b2["train_losses"],
                                          a["train_losses"]))
            if not loss_ok or diff["ema"] > bound or any(
                    diff[k] != 0 for k in ("loop_state", "epoch",
                                           "optimizer_steps")):
                raise AssertionError(f"trainx: resumed run off bounds "
                                     f"{diff} (ops {refused})")
        # the frozen stem: its initial value, no optimizer state (its EMA,
    # d * p + (1 - d) * p in f32, may move by a rounding, as in JAX)
        fresh = initialize_model(config).state_dict()
        stem = [k for k in fresh if k.startswith("block1.")
                and not k.split(".")[-1].startswith(("running",
                                                     "num_batches"))]
        for run, fin in fins.items():
            for k in stem:
                if not torch.equal(fin["model"][k], fresh[k]):
                    raise AssertionError(f"trainx {run}: frozen {k} "
                                         "moved")
            n_opt = len(fin["optimizer"]["shapes"])
            n_params = sum(1 for k in fin["ema"])
            if n_opt != n_params - len(stem):
                raise AssertionError(f"trainx {run}: the optimizer "
                                     f"holds {n_opt} of {n_params}")
        # the files: the ranked snapshots, _best/, statistics/*.npy
        snaps = os.path.join(tmp, "a", "ck", "MobileNetLarge3D")
        listed = sorted(os.listdir(snaps))
        best_dir = snaps + "_best"
        best = sorted(os.listdir(best_dir))
        stats = sorted(os.listdir("statistics"))
        latest = os.path.basename(ckpt.latest_checkpoint(snaps))
        val = a["val_losses"]
        if (listed != [f"step_{e}" for e in range(n_evals)]
                + [f"step_{n_evals - 1}_{n_steps}"]
                or latest != f"step_{n_evals - 1}"
                or not 1 <= len(best) <= 2
                or best[-1] != f"step_{int(np.argmin(val))}"
                or len(stats) != 5):
            raise AssertionError(f"trainx: files {listed}, latest "
                                 f"{latest}, best {best}, statistics "
                                 f"{stats}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = serve.main([paths["a"], "--checkpoint",
                             a["checkpoint"], "--csv", "synthetic",
                             "--limit", "8", "--batch", "8"])
        preds = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith('{"clip"')]
        if rc != 0 or len(preds) != 8:
            raise AssertionError(f"trainx: serving the .pth gave rc "
                                 f"{rc}, {len(preds)} predictions")
        res.update(
            launches=runs, launches_per_microbatch=TRAINX_PER_MICRO,
            launches_per_eval_batch=TRAINX_PER_EVAL,
            train_losses=a["train_losses"], val_losses=val,
            stopped_early=a["stopped_early"],
            resumed_bit_equal=bit_equal and tail_equal,
            max_abs_diff=diff, nondeterministic_ops=refused,
            snapshots=listed, best=best, statistics=stats,
            pth_served=len(preds),
            cli_wall_s={"a": wall_a, "b_interrupted": wall_b1,
                        "b_resumed": wall_b2})
    res["seconds"] = time.perf_counter() - t_start
    emit(res)
    return res


def _remat_step(make_model, remat, policy, feats, labels, counters):
    """One train step (one bs-8 microbatch, AdamW, seeded dropout) with
    ``remat``: the launches, the gradients and the BatchNorm buffers."""
    import torch
    from picklebot_tpu_torch.train.optim import AdamW
    from picklebot_tpu_torch.train.step import make_train_step
    model = make_model().cuda()
    step = make_train_step(model, AdamW(model.parameters()), "CE",
                           lambda epoch: 3e-4, policy, seed=3,
                           device="cuda", remat=remat)
    zero_counters(counters)
    metrics = step(0, feats[None], labels[None])
    torch.cuda.synchronize()
    launches = read_counters(counters)
    grads = {n: p.grad.float() for n, p in model.named_parameters()
             if p.grad is not None}
    bufs = {n: b.float() for n, b in model.named_buffers()}
    return launches, float(metrics["loss"][0]), grads, bufs


def phase_trainx_remat(counters, feats, labels, gpu_line):
    """MobileViT-s, one bs-8 train step with remat 1 against remat 0, in
    bf16 and in f32 (TF32 off), deterministic algorithms on: the exact
    launches of rows 2, 3, 4 and 7 with the recompute; every gradient and
    BatchNorm buffer within REMAT_F32_GRAD_TOL of max|ref| in f32, and in
    bf16 no farther than twice a remat-0 repeat's distance (a repeat of
    the same step: the card's own noise) or that bound. Then the peak
    device memory of a MobileNetLarge3D bs-8 bf16 train step at remat 0
    and 1 (a reading)."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    t_start = time.perf_counter()
    res = {"phase": "trainx_remat", "card": gpu_line}

    def rel_err(ref, new):
        if ref.keys() != new.keys():
            raise AssertionError("trainx remat: the runs hold different "
                                 "tensors")
        return max((new[k] - ref[k]).abs().max().item()
                   / max(ref[k].abs().max().item(), 1e-30) for k in ref)

    for dtype, policy in (("bf16", DtypePolicy.bf16()),
                          ("f32", DtypePolicy.f32())):
        with deterministic():
            got = {r: _remat_step(mobilevit_s, r, policy, feats, labels,
                                  counters) for r in (0, 1)}
            repeat = _remat_step(mobilevit_s, 0, policy, feats, labels,
                                 counters)
        for r in (0, 1):
            wanted = launches_wanted(**VIT_REMAT_LAUNCHES[r])
            if got[r][0] != wanted:
                raise AssertionError(f"trainx MobileViT-s {dtype} remat "
                                     f"{r}: launches {got[r][0]}, want "
                                     f"{wanted}")
        (_, loss0, g0, b0), (_, loss1, g1, b1) = got[0], got[1]
        err = {"grads": rel_err(g0, g1), "buffers": rel_err(b0, b1)}
        noise = {"grads": rel_err(g0, repeat[2]),
                 "buffers": rel_err(b0, repeat[3])}
        bound = REMAT_F32_GRAD_TOL if dtype == "f32" else max(
            REMAT_F32_GRAD_TOL, 2 * max(noise.values()))
        if max(err.values()) > bound or \
                abs(loss1 - loss0) > 1e-6 * abs(loss0):
            raise AssertionError(f"trainx remat {dtype}: rel err {err} "
                                 f"(bound {bound}, a repeat's {noise}), "
                                 f"loss {loss1} vs {loss0}")
        res[dtype] = {"launches": {r: got[r][0] for r in (0, 1)},
                      "loss": {0: loss0, 1: loss1}, "max_rel_err": err,
                      "repeat_max_rel_err": noise, "bound": bound}
    del got
    memory = {}
    for r in (0, 1):
        step, _ = train_step_for(large3d().cuda(), remat=r)
        step(0, feats[None], labels[None])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step(0, feats[None], labels[None])
        torch.cuda.synchronize()
        memory[r] = {"peak_memory_bytes": torch.cuda.max_memory_allocated(),
                     "train_step_ms": (time.perf_counter() - t0) * 1e3}
        del step
    res["large3d_bf16_bs8"] = memory
    res["seconds"] = time.perf_counter() - t_start
    emit(res)
    return res


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dp_batch(a, b, seed):
    """DP_STEPS steps of (a, b) uint8 32x224x224 clips and labels."""
    rng = np.random.RandomState(seed)
    feats = rng.randint(0, 256, (DP_STEPS, a, b, 32, 224, 224, 3),
                        dtype=np.uint8)
    return feats, rng.randint(0, 13, (DP_STEPS, a, b))


def dp_setup(dtype, optimizer, zero=0, world=1, rank=0):
    """MobileNetLarge3D at full width (seed 0) on the card with its train
    step at the data-parallel layout of the process's group (``zero``: 0
    DP, or the ZeRO stage over ``world`` ranks)."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.parallel import zero as zero_mod
    from picklebot_tpu_torch.train.optim import OPTIMIZERS
    from picklebot_tpu_torch.train.step import make_train_step
    model = large3d().to("cuda")
    policy = DtypePolicy.bf16() if dtype == "bf16" else DtypePolicy.f32()
    layout = None
    if zero:
        layout = zero_mod.ZeroLayout(model, world, rank, zero)
        opt = zero_mod.zero_optimizer(OPTIMIZERS[optimizer], layout,
                                      weight_decay=5e-4)
    else:
        opt = OPTIMIZERS[optimizer](model.parameters(), weight_decay=5e-4)
    step = make_train_step(model, opt, "CE", lambda epoch: DP_LR, policy,
                           device=torch.device("cuda"), zero=layout)
    return model, opt, step, layout


def dp_steps(step, feats, labels, rank=0, world=1):
    """DP_STEPS steps on this rank's share of each global batch: losses
    and the host-clock ms of each step (ending in a synchronize)."""
    import torch
    b = feats.shape[2] // world
    losses, ms = [], []
    for s in range(DP_STEPS):
        t0 = time.perf_counter()
        m = step(0, feats[s][:, rank * b:(rank + 1) * b],
                 labels[s][:, rank * b:(rank + 1) * b], s * feats.shape[1])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(m["loss"].float().cpu())
    return losses, ms


def host_state(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def dp_diff(label, got, want, got_losses, want_losses, dtype):
    """A run's state dict and losses against a reference's: bit-equal
    expected; else f32 within DP_F32_REL_TOL of each tensor's max|ref|,
    bf16 losses within TRAIN_LOSS_REL_TOL (the train bounds, PERF.md
    section 2), the readings kept either way."""
    import torch
    bit_equal = all(torch.equal(got[k], want[k]) for k in want) and all(
        torch.equal(a, b) for a, b in zip(got_losses, want_losses))
    rel = max(((got[k].double() - want[k].double()).abs().max()
               / want[k].double().abs().max().clamp(min=1e-30)).item()
              for k in want if want[k].is_floating_point())
    loss_rel = max(((a - b).abs() / b.abs()).max().item()
                   for a, b in zip(got_losses, want_losses))
    ok = bit_equal or (rel <= DP_F32_REL_TOL if dtype == "f32"
                       else loss_rel <= TRAIN_LOSS_REL_TOL)
    out = {"bit_equal": bit_equal, "max_rel_err": rel,
           "loss_max_rel_err": loss_rel}
    if not ok:
        raise AssertionError(f"dp {label}: {out}")
    return out


def dp_world1(counters):
    """NCCL at world 1: 2 bf16 steps (bs 8, 2 microbatches, AdamW8bit)
    through the DP path of the train step, against the same 2 steps with
    no process group, deterministic algorithms on: bit-equal expected;
    exact launches; then one more step of each in turns A B B A (CUDA
    events)."""
    import torch
    import torch.distributed as dist
    from picklebot_tpu_torch.parallel import mesh
    feats, labels = dp_batch(2, 8, 11)
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
           "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with deterministic():
            ref_model, _, ref_step, _ = dp_setup("bf16", "adamw8bit")
            ref_losses, _ = dp_steps(ref_step, feats, labels)
            mesh.init_distributed()
            backend = dist.get_backend()
            model, _, step, _ = dp_setup("bf16", "adamw8bit")
            zero_counters(counters)
            mesh.reset_counts()
            losses, ms = dp_steps(step, feats, labels)
            launches = read_counters(counters)
            collectives = mesh.counts()
            diff = dp_diff("nccl world 1", host_state(model),
                           host_state(ref_model), losses, ref_losses, "bf16")
            turns = {"no_group": [], "nccl_world1": []}
            x = (feats[0], labels[0])
            for label, fn in (("no_group", ref_step), ("nccl_world1", step),
                              ("nccl_world1", step), ("no_group", ref_step)):
                turns[label].append(time_ms(lambda: fn(0, *x), reps=1))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    want = launches_wanted(fused={"pool": 8 * 2 * DP_STEPS,
                                  "main": 15 * 2 * DP_STEPS,
                                  **dw(15 * 2 * DP_STEPS)})
    if launches != want:
        raise AssertionError(f"dp nccl world 1 launches {launches}, want "
                             f"{want}")
    out = {"backend": backend, **diff, "losses": [l.tolist() for l in losses],
           "launches": launches, "collectives_per_step": {
               k: {"count": v["count"] / DP_STEPS,
                   "bytes": v["bytes"] / DP_STEPS}
               for k, v in collectives.items()},
           "step_ms_host": ms, "step_ms_events_in_turns": turns}
    emit({"phase": "dp", "part": "nccl_world1", **out})
    return out


def dp_spawn(mode, out_dir, timeout):
    """Two processes of this script on the one card (``--dp-rank``):
    their outputs and exit codes; killed past ``timeout`` seconds."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
         "--dp-port", str(port), "--dp-out", out_dir, "--dp-mode", mode],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n[killed: timeout]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs, [p.returncode for p in procs]


def dp_rank_bytes(model, opt, layout):
    """This rank's parameter and optimizer-state bytes at rest, counted
    from the tensors."""
    params = (sum(s.numel() * s.element_size() for s in layout.shards)
              if layout is not None and layout.stage == 3 else
              sum(p.numel() * p.element_size() for p in model.parameters()))
    moments = [t for st in opt.m + opt.v
               for t in (st if isinstance(st, tuple) else (st,))]
    return params, sum(t.numel() * t.element_size() for t in moments)


def dp_rank_main(args):
    """One rank of the two-process runs (``--dp-rank``): gloo on cuda:0.
    Mode ``gloo``: each of DP_JOBS, DP_STEPS steps of bs 4 (the rank's
    half of a global bs-8 batch) under deterministic algorithms, then the
    autotuner's broadcast; mode ``nccl_probe``: one NCCL all-reduce, to
    see whether NCCL takes two ranks on one card."""
    import hashlib
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from picklebot_tpu_torch.parallel import mesh
    rank = args.dp_rank
    if args.dp_mode == "nccl_probe":
        try:
            mesh.init_distributed(f"localhost:{args.dp_port}",
                                  backend="nccl", device="cuda:0", rank=rank,
                                  world_size=2)
            t = torch.ones(4, device="cuda")
            dist.all_reduce(t)
            torch.cuda.synchronize()
            print(json.dumps({"dp_rank": rank, "nccl": f"ran: {t.tolist()}"}))
        except Exception as e:      # noqa: BLE001 -- the reading
            print(json.dumps({"dp_rank": rank, "nccl":
                              f"refused: {type(e).__name__}: {e}"[:600]}))
        return 0
    from picklebot_tpu_torch.train import checkpoint as ckpt
    mesh.init_distributed(f"localhost:{args.dp_port}", backend="gloo",
                          device="cuda:0", rank=rank, world_size=2)
    counters = all_counters()
    feats, labels = dp_batch(1, 8, 12)
    results = {}
    with deterministic():
        for name, zero, dtype, optimizer in DP_JOBS:
            torch.cuda.reset_peak_memory_stats()
            model, opt, step, layout = dp_setup(dtype, optimizer, zero, 2,
                                                rank)
            params_b, opt_b = dp_rank_bytes(model, opt, layout)
            zero_counters(counters)
            mesh.reset_counts()
            losses, ms = dp_steps(step, feats, labels, rank, 2)
            launches = read_counters(counters)
            collectives = mesh.counts()
            snap = ckpt.snapshot(model, opt, None, 0, [0, 0], [0, 0, 0],
                                 zero=layout)
            digest = hashlib.sha256()
            for k in sorted(snap["model"]):
                digest.update(snap["model"][k].numpy().tobytes())
            if rank == 0:
                torch.save({"model": snap["model"], "losses": losses,
                            "optimizer": snap["optimizer"]},
                           os.path.join(args.dp_out, f"{name}.pt"))
            results[name] = {
                "losses": [l.tolist() for l in losses], "step_ms_host": ms,
                "launches": launches, "digest": digest.hexdigest(),
                "param_bytes": params_b, "optimizer_state_bytes": opt_b,
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "collectives_per_step": {
                    k: {"count": v["count"] / DP_STEPS,
                        "bytes": v["bytes"] / DP_STEPS}
                    for k, v in collectives.items()}}
            del model, opt, step, layout, snap
            torch.cuda.empty_cache()
    results["autotune"] = dp_rank_autotune(rank, args.dp_out)
    with open(os.path.join(args.dp_out, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    print(json.dumps({"dp_rank": rank, "launches": {
        k: v["launches"]["fused"] for k, v in results.items()
        if isinstance(v, dict) and "launches" in v}}))
    dist.destroy_process_group()
    return 0


def dp_rank_autotune(rank, out_dir):
    """``autotune_config`` at world 2 (deterministic algorithms off: under
    them there is one candidate): rank 0 measures, rank 1 takes its
    winner and measures nothing. Each rank its own cache file."""
    from picklebot_tpu_torch.utils import autotune as at
    from picklebot_tpu_torch.utils.config import Config
    calls = []
    real = at.measure_candidate

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    at.measure_candidate = counted
    os.environ["PICKLEBOT_AUTOTUNE_CACHE"] = os.path.join(
        out_dir, f"autotune_rank{rank}.json")
    cfg = Config(model_name="MobileNetLarge3D", num_classes=13,
                 batch_size=2, effective_batch_size=2,
                 synthetic_shape=(8, 64, 64), autotune=True).validate()
    try:
        _, flag = at.autotune_config(cfg, "train", device="cuda:0")
    finally:
        at.measure_candidate = real
    return {"flag": flag, "measured": len(calls)}


def dp_emulate(dtype, optimizer, feats, labels):
    """The DP semantics at 2 ranks in one process on the card: each rank's
    half in turn, from its own BatchNorm buffers and with its rank's
    dropout seed; then the gradients summed / 2, the buffers averaged,
    the losses averaged and one update. Deterministic algorithms on."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.train.optim import OPTIMIZERS
    from picklebot_tpu_torch.train.step import _micro_seed, make_train_step
    model = large3d().to("cuda")
    opt = OPTIMIZERS[optimizer](model.parameters(), weight_decay=5e-4)
    policy = DtypePolicy.bf16() if dtype == "bf16" else DtypePolicy.f32()
    noop = type("NoUpdate", (), {"step": lambda self, lr: None})()
    local = [make_train_step(model, noop, "CE", lambda e: DP_LR, policy,
                             seed=_micro_seed(0, -1 - r),
                             device=torch.device("cuda")) for r in range(2)]
    params = list(model.parameters())
    stats = [k for k, _ in model.named_buffers()
             if k.endswith((".running_mean", ".running_var"))]
    buffers = [{k: b.clone() for k, b in model.named_buffers()}
               for _ in range(2)]
    b = feats.shape[2] // 2
    losses = []
    with deterministic():
        for s in range(DP_STEPS):
            grads, loss = None, None
            for r in range(2):
                model.load_state_dict(buffers[r], strict=False)
                m = local[r](0, feats[s][:, r * b:(r + 1) * b],
                             labels[s][:, r * b:(r + 1) * b],
                             s * feats.shape[1])
                buffers[r] = {k: v.clone() for k, v in model.named_buffers()}
                g = [p.grad.clone() for p in params]
                grads = g if grads is None else [x + y for x, y in
                                                 zip(grads, g)]
                loss = m["loss"] if loss is None else loss + m["loss"]
            with torch.no_grad():
                for p, g in zip(params, grads):
                    p.grad = g / 2
                opt.step(DP_LR)
                for k in stats:
                    avg = (buffers[0][k] + buffers[1][k]) / 2
                    buffers[0][k] = buffers[1][k] = avg
                model.load_state_dict(buffers[0], strict=False)
            losses.append((loss / 2).float().cpu())
    torch.cuda.synchronize()
    return host_state(model), losses


def dp_gloo(counters):
    """The two-process runs on the one card over gloo, checked against
    the one-process emulation and against each other."""
    import torch
    with tempfile.TemporaryDirectory(prefix="dp_") as out_dir:
        t0 = time.perf_counter()
        outs, rcs = dp_spawn("gloo", out_dir, DP_RANK_TIMEOUT)
        spawn_s = time.perf_counter() - t0
        if any(rcs):
            raise AssertionError(f"dp gloo ranks exited {rcs}:\n"
                                 + "\n".join(o[-3000:] for o in outs))
        ranks = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        saved = {name: torch.load(os.path.join(out_dir, f"{name}.pt"),
                                  weights_only=False)
                 for name, *_ in DP_JOBS}
    want = launches_wanted(fused={"pool": 8 * DP_STEPS,
                                  "main": 15 * DP_STEPS,
                                  **dw(15 * DP_STEPS)})
    checks = {}
    for name, *_ in DP_JOBS:
        for r in range(2):
            if ranks[r][name]["launches"] != want:
                raise AssertionError(f"dp {name} rank {r} launches "
                                     f"{ranks[r][name]['launches']}, want "
                                     f"{want}")
        if ranks[0][name]["digest"] != ranks[1][name]["digest"]:
            raise AssertionError(f"dp {name}: the ranks' weights differ")
    feats, labels = dp_batch(1, 8, 12)
    for dtype, optimizer in (("f32", "adamw"), ("bf16", "adamw8bit")):
        ref, ref_losses = dp_emulate(dtype, optimizer, feats, labels)
        dp = saved[f"dp_{dtype}"]
        checks[f"dp_{dtype}_vs_emulation"] = dp_diff(
            f"dp {dtype} against the emulation", dp["model"], ref,
            dp["losses"], ref_losses, dtype)
    for a, b in (("z1_f32", "dp_f32"), ("z3_f32", "dp_f32"),
                 ("z3_bf16", "z1_bf16")):
        dtype = "f32" if a.endswith("f32") else "bf16"
        checks[f"{a}_vs_{b}"] = dp_diff(
            f"{a} against {b}", saved[a]["model"], saved[b]["model"],
            saved[a]["losses"], saved[b]["losses"], dtype)
    za, zb = saved["z3_bf16"]["optimizer"], saved["z1_bf16"]["optimizer"]
    flat = [(x, y) for part in ("m", "v") for sx, sy in zip(za[part],
                                                           zb[part])
            for x, y in zip(sx if isinstance(sx, tuple) else (sx,),
                            sy if isinstance(sy, tuple) else (sy,))]
    checks["z3_bf16_vs_z1_bf16"]["optimizer_bit_equal"] = all(
        torch.equal(x, y) for x, y in flat)
    tune = [r["autotune"] for r in ranks]
    if tune[0]["flag"] != tune[1]["flag"] or tune[1]["measured"] != 0 \
            or tune[0]["measured"] == 0:
        raise AssertionError(f"dp autotune broadcast: {tune}")
    res = {"checks": checks, "autotune": tune, "spawn_seconds": spawn_s,
           "note": "two processes share one card: step times are not a "
                   "speed figure",
           "by_job": {name: {k: [ranks[r][name][k] for r in range(2)]
                             for k in ("step_ms_host", "param_bytes",
                                       "optimizer_state_bytes",
                                       "peak_memory_bytes",
                                       "collectives_per_step")}
                      for name, *_ in DP_JOBS},
           "launches": {f"rank{r}": {name: ranks[r][name]["launches"]
                                     for name, *_ in DP_JOBS}
                        for r in range(2)}}
    emit({"phase": "dp", "part": "gloo_two_ranks", **res})
    return res


def dp_sharded_predict(counters):
    """make_sharded_predict_fn over two replicas on cuda:0 at a ragged
    batch of 5 (padded to 6, trimmed) against the unsharded predictor
    (the serve bound); exact launches per replica call; serve
    --data-parallel 2 on this one-card machine exits non-zero naming the
    count found."""
    import torch
    from picklebot_tpu_torch import serve
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.train.step import (make_predict_fn,
                                                make_sharded_predict_fn)
    model = large3d().to("cuda")
    feats = np.random.RandomState(13).randint(0, 256, (5, 32, 224, 224, 3),
                                              dtype=np.uint8)
    sharded = make_sharded_predict_fn(model, ["cuda:0", "cuda:0"],
                                      DtypePolicy.bf16())
    sharded(feats)
    zero_counters(counters)
    got = sharded(feats)
    torch.cuda.synchronize()
    launches = read_counters(counters)
    want = launches_wanted(fused={"pool": 16, "main": 30})
    if launches != want or got.shape != (5, 13):
        raise AssertionError(f"dp sharded predict: launches {launches} "
                             f"(want {want}), shape {got.shape}")
    single = make_predict_fn(model, DtypePolicy.bf16(), device="cuda")(feats)
    check = logits_against_plain("dp sharded predict", torch.tensor(got),
                                 torch.tensor(single))
    with tempfile.TemporaryDirectory() as tmp:
        cfg = os.path.join(tmp, "cfg.json")
        with open(cfg, "w") as f:
            json.dump(serve_config("MobileNetLarge3D"), f)
        pth = os.path.join(tmp, "w.pth")
        torch.save(host_state(model), pth)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = serve.main([cfg, "--checkpoint", pth, "--csv", "x",
                             "--data-parallel", "2"])
    found = f"found {torch.cuda.device_count()}"
    if rc == 0 or found not in err.getvalue():
        raise AssertionError(f"serve --data-parallel 2: rc {rc}, "
                             f"{err.getvalue()!r}")
    out = {**check, "launches": launches,
           "serve_data_parallel_2": {"rc": rc,
                                     "stderr": err.getvalue().strip()}}
    emit({"phase": "dp", "part": "sharded_predict", **out})
    return out


def phase_dp(counters):
    """Data parallelism and ZeRO on the one card (module docstring)."""
    t0 = time.perf_counter()
    res = {"nccl_world1": dp_world1(counters)}
    outs, rcs = dp_spawn("nccl_probe", tempfile.gettempdir(), 90)
    probe = [json.loads(line) for o in outs for line in o.splitlines()
             if line.startswith('{"dp_rank"')]
    res["nccl_two_ranks_one_card"] = {"exit_codes": rcs, "ranks": probe,
                                      "tail": [o[-600:] for o in outs]}
    emit({"phase": "dp", "part": "nccl_two_ranks_one_card",
          **res["nccl_two_ranks_one_card"]})
    res["gloo"] = dp_gloo(counters)
    res["sharded_predict"] = dp_sharded_predict(counters)
    res["seconds"] = time.perf_counter() - t0
    emit({"phase": "dp", "seconds": res["seconds"]})
    return res


def layout_batch():
    """LAYOUT_STEPS steps of one bs-8 microbatch: the train phase's
    synthetic 32x224x224 clips and labels."""
    from picklebot_tpu_torch.data.dataset import ClipDataset, pad_collate
    n = 8 * LAYOUT_STEPS
    ds = ClipDataset("", "", backend="synthetic",
                     synthetic_shape=(32, 224, 224), synthetic_len=n)
    items = [ds[i] for i in range(n)]
    feats, labels = pad_collate([c for c, _ in items], [l for _, l in items],
                                16, 128)
    return (feats.reshape((LAYOUT_STEPS, 1, 8) + feats.shape[1:]),
            np.asarray(labels).reshape(LAYOUT_STEPS, 1, 8))


def layout_setup(dtype, optimizer, **model_kw):
    """MobileViT-s (seed 0) on the card with its train step, built with
    ``model_kw`` (its mesh axes, its experts; none: the one-process
    model)."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.models.mobilevit import (MOBILEVIT_CONFIGS,
                                                      MobileViT)
    from picklebot_tpu_torch.train.optim import OPTIMIZERS
    from picklebot_tpu_torch.train.step import make_train_step
    model = MobileViT(num_classes=13, seed=0, **MOBILEVIT_CONFIGS["s"],
                      **model_kw).to("cuda")
    policy = DtypePolicy.bf16() if dtype == "bf16" else DtypePolicy.f32()
    opt = OPTIMIZERS[optimizer](model.parameters(), weight_decay=5e-4)
    step = make_train_step(model, opt, "CE", lambda epoch: LAYOUT_LR, policy,
                           max_grad_norm=LAYOUT_CLIP,
                           device=torch.device("cuda"))
    return model, step


def layout_steps(model, step, feats, labels):
    """LAYOUT_STEPS steps: per step the losses, the collectives (counted
    from 0 for the step) and the full weights after it (the TP or EP
    shards gathered); the first step's gradients (gathered); host ms per
    step."""
    import torch
    from picklebot_tpu_torch.parallel import mesh
    from picklebot_tpu_torch.parallel.megatron import gather_tensor, layout
    from picklebot_tpu_torch.train.checkpoint import full_state_dict
    lay = layout(model)
    out = {"losses": [], "collectives": [], "states": [], "ms": []}
    for s in range(LAYOUT_STEPS):
        mesh.reset_counts()
        t0 = time.perf_counter()
        m = step(0, feats[s], labels[s], s)
        torch.cuda.synchronize()
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["collectives"].append(mesh.counts())
        out["losses"].append(m["loss"].float().cpu())
        if s == 0:
            out["grads"] = {n: (gather_tensor(p.grad, lay[n][1], lay[n][0])
                                if n in lay else p.grad).float().cpu().clone()
                            for n, p in model.named_parameters()}
        out["states"].append({k: v.detach().cpu().clone()
                              for k, v in full_state_dict(model).items()})
    return out


def layout_collectives_want(mode, dtype, stack_params):
    """The collectives of one train step (one bs-8 microbatch) at
    ``mode``, worked out from VIT_STAGES: {kind: {count, bytes}} of the
    kinds that occur. TP: each FFN's g all-reduces its (64, N, E) output
    forward and f its input gradient backward, plus the clip's one
    all-reduce of the 18 sharded leaves' f32 squares. SP at 2: a stage
    whose N is even runs token-sharded: the exit's all-gather forward and
    the entry's backward, each (64, N, E); per layer K and V one hop each
    way, each (64, 8, N/2, 16); then one f32 all-reduce over 'seq' of
    those stacks' ``stack_params`` parameter gradients."""
    elt = 2 if dtype == "bf16" else 4
    act = [64 * n * e * elt for n, e, _, _ in VIT_STAGES]
    layers = [d for _, _, _, d in VIT_STAGES]
    if mode == "tp":
        n = sum(layers)
        return {"all-reduce": {"count": 2 * n + 1,
                               "bytes": sum(2 * d * a for d, a in
                                            zip(layers, act)) + 4 * 2 * n}}
    sp = [(n, d, a) for (n, _, _, d), a in zip(VIT_STAGES, act)
          if n % 2 == 0]
    return {"all-gather": {"count": 2 * len(sp),
                           "bytes": sum(2 * a for _, _, a in sp)},
            "collective-permute": {
                "count": sum(4 * d for _, d, _ in sp),
                "bytes": sum(4 * d * 64 * VIT_HEADS * (n // 2) * VIT_DHEAD
                             * elt for n, d, _ in sp)},
            "all-reduce": {"count": 1, "bytes": 4 * stack_params}}


def sp_stack_params():
    """The parameters of MobileViT-s's token-sharded stacks at seq 2 (the
    stages whose N is even): per layer qkv (3*128, E), out (E, 128) and
    the FFN's two (E*mult, E) weights."""
    return sum(d * (4 * 128 * e + 2 * e * mult * e)
               for n, e, mult, d in VIT_STAGES if n % 2 == 0)


def layout_ring_checks(rank):
    """Ring attention over 'seq' at MobileViT-s's stage-1 and stage-3
    shapes (64 sequences, 8 heads of 16, N 784 and 32), forward and the
    gradients of a weighted sum, each rank's block against the plain
    attention (``sdpa``) of the whole sequence on the card: f32 (TF32
    off) within LAYOUT_F32_REL_TOL of max|ref|, bf16 within the flash
    bounds of bf16 ``sdpa``; CUDA-event times of both, forward and
    backward."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.ops.flash_attention import sdpa
    from picklebot_tpu_torch.ops.ring_attention import ring_attention
    out = {}
    scale = VIT_DHEAD ** -0.5
    for n in (784, 32):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator().manual_seed(n)
            q, k, v, w = (torch.randn(VIT_SEQS, VIT_HEADS, n, VIT_DHEAD,
                                      generator=g).to("cuda", dtype)
                          for _ in range(4))
            blk = slice(rank * n // 2, (rank + 1) * n // 2)
            with DtypePolicy.f32().precision():
                full = [t.clone().requires_grad_(True) for t in (q, k, v)]
                ref = sdpa(*full, scale)
                (ref.float() * w.float()).sum().backward()
                mine = [t[..., blk, :].clone().requires_grad_(True)
                        for t in (q, k, v)]
                got = ring_attention(*mine, "seq", scale)
                (got.float() * w[..., blk, :].float()).sum().backward()
                torch.cuda.synchronize()

                def ring_step():
                    parts = [t.detach().requires_grad_(True) for t in mine]
                    o = ring_attention(*parts, "seq", scale)
                    o.float().sum().backward()

                def plain_step():
                    parts = [t.detach().requires_grad_(True) for t in full]
                    sdpa(*parts, scale).float().sum().backward()
                ring_ms = time_ms(ring_step, reps=3)
                plain_ms = time_ms(plain_step, reps=3)
            name = f"ring N={n} {str(dtype)[6:]} rank {rank}"
            pairs = [("out", got, ref[..., blk, :])] + [
                (f"d{t}", mine[i].grad, full[i].grad[..., blk, :])
                for i, t in enumerate("qkv")]
            errs = {}
            for label, a, b in pairs:
                if dtype == torch.float32:
                    err, mx = check_close(f"{name} {label}", a, b,
                                          LAYOUT_F32_REL_TOL)
                    errs[label] = {"max_abs_err": err, "max_ref": mx}
                else:
                    errs[label] = check_bf16_flash(f"{name} {label}", a, b)
            out[f"{n}_{str(dtype)[6:]}"] = {
                "errors": errs, "ring_fwd_bwd_ms": ring_ms,
                "plain_fwd_bwd_ms": plain_ms}
    return out


def layout_rank_main(args):
    """One rank of the layouts phase (``--layout-rank``): gloo on cuda:0,
    the mesh of ``--layout-mode``, each of LAYOUT_JOBS under
    deterministic algorithms; at 'sp' also the ring checks. Rank 0 saves
    the runs (and at 'tp' the f32 run's full weights as a .pth)."""
    import hashlib
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from picklebot_tpu_torch.parallel import mesh
    rank, mode = args.layout_rank, args.layout_mode
    mesh.init_distributed(f"localhost:{args.dp_port}", backend="gloo",
                          device="cuda:0", rank=rank, world_size=2)
    mesh.init_mesh(**LAYOUT_MODES[mode])
    counters = all_counters()
    feats, labels = layout_batch()
    results = {}
    with deterministic():
        for name, dtype, optimizer in LAYOUT_JOBS:
            torch.cuda.reset_peak_memory_stats()
            model, step = layout_setup(
                dtype, optimizer, **{{"model": "model_axis",
                                      "seq": "sequence_axis"}[a]: a
                                     for a in LAYOUT_MODES[mode]})
            zero_counters(counters)
            run = layout_steps(model, step, feats, labels)
            launches = read_counters(counters)
            digest = hashlib.sha256()
            for k in sorted(run["states"][-1]):
                digest.update(run["states"][-1][k].numpy().tobytes())
            if rank == 0:
                torch.save(run, os.path.join(args.dp_out,
                                             f"{mode}_{name}.pt"))
                if mode == "tp" and dtype == "f32":
                    torch.save(run["states"][-1],
                               os.path.join(args.dp_out, "tp.pth"))
            results[name] = {
                "launches": launches, "digest": digest.hexdigest(),
                "engaged": [n for n, m in model.named_modules()
                            if getattr(m, "sp_engaged", False)],
                "step_ms_host": run["ms"],
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "local_params": sum(p.numel() for p in model.parameters()),
                "collectives": run["collectives"]}
            del model, step, run
            torch.cuda.empty_cache()
    if mode == "sp":
        results["ring"] = layout_ring_checks(rank)
    with open(os.path.join(args.dp_out, f"{mode}_rank{rank}.json"),
              "w") as f:
        json.dump(results, f)
    print(json.dumps({"layout_rank": rank, "mode": mode}))
    dist.destroy_process_group()
    return 0


def layout_spawn(mode, out_dir, timeout, kind="layout"):
    """The two processes of ``mode`` (``--layout-rank``, or with ``kind``
    "ppep" ``--ppep-rank``): outputs and exit codes; each killed past
    ``timeout`` seconds."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), f"--{kind}-rank", str(r),
         f"--{kind}-mode", mode, "--dp-port", str(port), "--dp-out", out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT) for r in range(2)]
    outs = []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n[killed: timeout]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs, [p.returncode for p in procs]


@contextlib.contextmanager
def ffn_in_halves(n=2):
    """Within the block every MobileViT FeedForward computes its hidden
    width in ``n`` slices, as the 'model' ranks do, and adds their
    outputs (the all-reduce's sum of two is one add): the tensor-parallel
    step's arithmetic in one process, to tell a fault of the layout from
    f32 reassociation. A patch inside this script; the port has no such
    switch."""
    import torch.nn.functional as F
    from picklebot_tpu_torch.models.mobilevit import FeedForward
    saved = FeedForward.forward

    def forward(self, x):
        xv = x.view_as(x)    # as tp_copy_in: the slices' dx meet here
        w0, w3 = self.net[0].weight, self.net[3].weight
        h = w0.shape[0] // n
        parts = [F.linear(self.net[2](self.net[1](F.linear(
            xv, w0[r * h:(r + 1) * h].to(x.dtype)))),
            w3[:, r * h:(r + 1) * h].contiguous().to(x.dtype))
            for r in range(n)]
        return self.net[4](sum(parts[1:], parts[0]))
    FeedForward.forward = forward
    try:
        yield
    finally:
        FeedForward.forward = saved


def layout_reference(dtype, optimizer, feats, labels, patch=None,
                     **model_kw):
    """The same steps in this process, no process group: the one-process
    MobileViT-s (built with ``model_kw``) on the card, deterministic
    algorithms on, inside ``patch`` if given (``ffn_in_halves``: its
    FFNs in the two slices of model 2)."""
    import torch
    with deterministic(), (patch or contextlib.nullcontext()):
        model, step = layout_setup(dtype, optimizer, **model_kw)
        run = layout_steps(model, step, feats, labels)
    del model, step
    torch.cuda.empty_cache()
    return run


def layout_diff(got, ref, dtype, grad_bound=LAYOUT_F32_REL_TOL):
    """A run against a reference run: {bit_equal, per-step loss errors,
    gradient and weight errors, ok}; the five gradients farthest from the
    reference are named. f32: the first step's loss within
    LAYOUT_F32_REL_TOL, every first-step gradient within ``grad_bound``
    of its max|ref|, the weights within Adam's bound; bf16: the losses
    within TRAIN_LOSS_REL_TOL."""
    import torch

    def rel(a, b):
        return ((a.double() - b.double()).abs().max()
                / b.double().abs().max().clamp(min=1e-30)).item()
    loss_rel = [((a - b).abs() / b.abs()).max().item()
                for a, b in zip(got["losses"], ref["losses"])]
    weights_abs = max((got["states"][s][k].double()
                       - ref["states"][s][k].double()).abs().max().item()
                      / (s + 1)
                      for s in range(LAYOUT_STEPS)
                      for k in ref["states"][s]
                      if ref["states"][s][k].is_floating_point())
    grads = sorted(((rel(got["grads"][k], ref["grads"][k]), k,
                     ref["grads"][k].abs().max().item())
                    for k in ref["grads"]), reverse=True)
    out = {"bit_equal": all(
        torch.equal(got["states"][-1][k], ref["states"][-1][k])
        for k in ref["states"][-1]) and all(
        torch.equal(a, b) for a, b in zip(got["losses"], ref["losses"])),
        "grads_bit_equal": all(torch.equal(got["grads"][k], ref["grads"][k])
                               for k in ref["grads"]),
        "loss_rel_err_by_step": loss_rel,
        "weights_max_abs_err_per_step": weights_abs,
        "grad_max_rel_err": grads[0][0],
        "grad_worst": [{"param": k, "rel_err": e, "max_ref": m}
                       for e, k, m in grads[:5]]}
    if dtype == "f32":
        out["grad_bound"] = grad_bound
        out["ok"] = (loss_rel[0] <= LAYOUT_F32_REL_TOL
                     and grads[0][0] <= grad_bound
                     and weights_abs <= LAYOUT_ADAM_LRS * LAYOUT_LR)
    else:
        out["ok"] = max(loss_rel) <= TRAIN_LOSS_REL_TOL
    return out


def phase_layouts(counters, gpu_line):
    """Tensor and sequence parallelism on the one card (module
    docstring)."""
    import torch
    from picklebot_tpu_torch.models.mobilevit import (MOBILEVIT_CONFIGS,
                                                      MobileViT)
    t_start = time.perf_counter()
    feats, labels = layout_batch()
    packed = sum(VIT_PACKED.values())
    sp_packed = sum(c for n, c in VIT_PACKED.items() if n % 2)
    # per rank and step: the flash launches (rows 3-4) and the stacks
    # that run token-sharded; at seq 2 the even-N stages go through ring
    # attention and stage 2 (N = 147) falls back to the packed kernel
    per_step = {"tp": (packed, []),
                "sp": (sp_packed, [f"trunk.{i}.1.transformer"
                                   for i, (n, *_) in enumerate(VIT_STAGES)
                                   if n % 2 == 0])}
    res = {"card": gpu_line, "modes": {}}
    failed = []
    refs = {name: layout_reference(dtype, opt, feats, labels)
            for name, dtype, opt in LAYOUT_JOBS}
    # the f32 floor: the one-process step with the FFN in two slices
    # against the plain one
    halves = layout_reference("f32", "adamw", feats, labels,
                              patch=ffn_in_halves())
    res["f32_floor"] = layout_diff(halves, refs["f32"], "f32")
    for key in ("ok", "grad_bound"):     # a reading, not a check
        res["f32_floor"].pop(key)
    floor = res["f32_floor"]["grad_max_rel_err"]
    plain_bound = max(LAYOUT_F32_REL_TOL, LAYOUT_FLOOR_FACTOR * floor)
    emit({"phase": "layouts", "part": "f32_floor", **res["f32_floor"],
          "plain_bound": plain_bound})
    with tempfile.TemporaryDirectory(prefix="layouts_") as out_dir:
        for mode in LAYOUT_MODES:
            t0 = time.perf_counter()
            outs, rcs = layout_spawn(mode, out_dir, LAYOUT_RANK_TIMEOUT)
            spawn_s = time.perf_counter() - t0
            if any(rcs):
                raise AssertionError(f"layouts {mode} ranks exited {rcs}:\n"
                                     + "\n".join(o[-3000:] for o in outs))
            ranks = []
            for r in range(2):
                with open(os.path.join(out_dir, f"{mode}_rank{r}.json")) as f:
                    ranks.append(json.load(f))
            flash_n, engaged = per_step[mode]
            want = launches_wanted(
                fused={"main": 7 * LAYOUT_STEPS, **dw(7 * LAYOUT_STEPS)},
                flash={"packed": flash_n * LAYOUT_STEPS,
                       "dq": flash_n * LAYOUT_STEPS,
                       "dkv": flash_n * LAYOUT_STEPS},
                conv={"fwd": 6 * LAYOUT_STEPS, "dx": 6 * LAYOUT_STEPS})
            checks = {}
            for name, dtype, _ in LAYOUT_JOBS:
                coll = layout_collectives_want(mode, dtype,
                                               sp_stack_params())
                for r in range(2):
                    got = ranks[r][name]
                    if got["launches"] != want:
                        raise AssertionError(
                            f"layouts {mode} {name} rank {r} launches "
                            f"{got['launches']}, want {want}")
                    if got["engaged"] != engaged:
                        raise AssertionError(
                            f"layouts {mode} {name} rank {r}: token-sharded "
                            f"stacks {got['engaged']}, want {engaged}")
                    for s, c in enumerate(got["collectives"]):
                        c = {k: v for k, v in c.items() if v["count"]}
                        if c != coll:
                            raise AssertionError(
                                f"layouts {mode} {name} rank {r} step {s} "
                                f"collectives {c}, want {coll}")
                if ranks[0][name]["digest"] != ranks[1][name]["digest"]:
                    raise AssertionError(f"layouts {mode} {name}: the "
                                         "ranks' weights differ")
                run = torch.load(os.path.join(out_dir, f"{mode}_{name}.pt"),
                                 weights_only=False)
                checks[name] = layout_diff(run, refs[name], dtype,
                                           plain_bound)
                checks[name]["collectives_per_step"] = coll
                if mode == "tp" and dtype == "f32":
                    checks["f32_vs_halves"] = layout_diff(run, halves,
                                                          "f32")

            failed += [f"{mode} {k}" for k, c in checks.items()
                       if not c["ok"]]
            mres = {"checks": checks, "spawn_seconds": spawn_s,
                    "launches": {f"rank{r}": {n: ranks[r][n]["launches"]
                                              for n, *_ in LAYOUT_JOBS}
                                 for r in range(2)},
                    "by_job": {n: {k: [ranks[r][n][k] for r in range(2)]
                                   for k in ("step_ms_host",
                                             "peak_memory_bytes",
                                             "local_params")}
                               for n, *_ in LAYOUT_JOBS},
                    "note": "two processes share one card: step times are "
                            "not a speed figure"}
            if mode == "sp":
                mres["ring"] = [ranks[r]["ring"] for r in range(2)]
            if mode == "tp":
                # the TP run's .pth (full leaves) in one process: strict
                # load, then serve on the card with model_parallel in the
                # config (serve takes the replicated equivalent)
                pth = os.path.join(out_dir, "tp.pth")
                model = MobileViT(num_classes=13, seed=1,
                                  **MOBILEVIT_CONFIGS["s"])
                model.load_state_dict(torch.load(pth, weights_only=True),
                                      strict=True)
                cfg = serve_config("MobileViT", **MOBILEVIT_CONFIGS["s"],
                                   attention_backend="auto",
                                   model_parallel=2)
                launches, serve_s, n_preds, evaluated = serve_run(
                    cfg, model, counters, pth=pth)
                swant = launches_wanted(fused={"main": 14},
                                        flash={"packed": 2 * packed},
                                        conv={"fwd": 12})
                if launches != swant:
                    raise AssertionError(f"layouts tp .pth serve: launches "
                                         f"{launches}, want {swant}")
                mres["serve_pth"] = {"predictions": n_preds,
                                     "evaluated": evaluated,
                                     "launches": launches,
                                     "serve_wall_s": serve_s}
            emit({"phase": "layouts", "mode": mode, **mres})
            res["modes"][mode] = mres
    res["four_ranks"] = ("model 2 x seq 2 is left to the CPU tests "
                         "(tests/test_torch_sp.py::test_sp_composes_with_tp)")
    res["seconds"] = time.perf_counter() - t_start
    emit({"phase": "layouts", "seconds": res["seconds"]})
    if failed:
        raise AssertionError(f"layouts: {failed} against the one-process "
                             "runs past the bounds (their JSON lines above)")
    return res


def ppep_stack_params(stages):
    """The parameters of MobileViT-s's transformer stacks at ``stages``
    (VIT_STAGES rows): per layer qkv (3*128, E), out (E, 128) and the
    FFN's two (E*mult, E) weights."""
    return sum(d * (4 * 128 * e + 2 * e * mult * e)
               for n, e, mult, d in stages)


def ppep_capacity(n):
    """MoEFeedForward.capacity(n) at PPEP_MOE's 4 experts, top-2, 1.25."""
    return max(1, math.ceil(2 * n * 1.25 / 4))


def ppep_collectives_want(mode, job, dtype, stages=VIT_STAGES, seqs=64):
    """The collectives of one train step (one bs-8 microbatch) of a pp_ep
    job, worked out from VIT_STAGES: {kind: {count, bytes}}. Activations
    are the stacks' (64, N, E) in the compute dtype. PP at M microbatches
    over 2 stages: a stack whose depth is even pipelines, with M hops of
    one (64/M, N, E) microbatch forward and M back, the exit's all-reduce
    forward and the entry's backward; then one f32 all-reduce over 'pipe'
    of those stacks' parameter gradients. EP 'replicated': per MoE layer
    g's all-reduce of the output forward and f's of the input's gradient
    and of the router's (4, E) f32 one backward. EP 'tokens': a stage
    whose N is even shards its tokens: per layer the exit's all-gather
    forward and the entry's backward, one all-reduce of the 8 f32 routing
    statistics, the router's gradient, and two all-to-alls of the (4, 64,
    cap(N/2), E) slots each way; stage 2 (N = 147) falls back to
    'replicated'. Both EP modes: the clip's one all-reduce of the 18
    expert banks' f32 squares. ``stages`` and ``seqs`` (sequences in the
    batch, 8 a clip) give other shapes the same rules."""
    elt = 2 if dtype == "bf16" else 4
    act = {n: seqs * n * e * elt for n, e, _, _ in stages}
    want = {}

    def add(kind, count, nbytes):
        c = want.setdefault(kind, {"count": 0, "bytes": 0})
        c["count"] += count
        c["bytes"] += nbytes

    if mode == "pp":
        micro = PPEP_JOBS["pp"][job][0]["pipeline_microbatches"]
        piped = [s for s in stages if s[3] % 2 == 0]
        for n, _, _, _ in piped:
            add("collective-permute", 2 * micro, 2 * act[n])
            add("all-reduce", 2, 2 * act[n])
        add("all-reduce", 1, 4 * ppep_stack_params(piped))
        return want
    tokens = PPEP_JOBS["ep"][job][0]["moe_dispatch"] == "tokens"
    for n, e, _, d in stages:
        if tokens and n % 2 == 0:
            slots = 4 * seqs * ppep_capacity(n // 2) * e * elt
            add("all-gather", 2 * d, 2 * d * act[n])
            add("all-reduce", 2 * d, d * (8 * 4 + 4 * e * 4))
            add("all-to-all", 4 * d, 4 * d * slots)
        else:
            add("all-reduce", 3 * d, d * (2 * act[n] + 4 * e * 4))
    add("all-reduce", 1, 4 * 2 * sum(d for *_, d in stages))
    return want


def ppep_model_kw(mode, job_kw=None, distributed=True):
    """MobileViT-s's options for a pp_ep job: the experts of the ep mode
    (PPEP_MOE), the job's options and, when ``distributed``, the mode's
    mesh axis."""
    kw = dict(job_kw or {})
    if mode == "ep":
        kw.update(PPEP_MOE)
    if not distributed:
        kw.pop("pipeline_microbatches", None)
    elif mode == "pp":
        kw["pipeline_axis"] = "pipe"
    else:
        kw["expert_axis"] = "expert"
    return kw


def ppep_rank_main(args):
    """One rank of the pp_ep phase (``--ppep-rank``): gloo on cuda:0, the
    mesh of ``--ppep-mode`` (pipe 2 or expert 2), each of its
    PPEP_JOBS under deterministic algorithms. Rank 0 saves the runs (and
    the f32 'replicated' EP run's full weights as a .pth)."""
    import hashlib
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from picklebot_tpu_torch.parallel import mesh
    rank, mode = args.ppep_rank, args.ppep_mode
    mesh.init_distributed(f"localhost:{args.dp_port}", backend="gloo",
                          device="cuda:0", rank=rank, world_size=2)
    mesh.init_mesh(**{"pipe" if mode == "pp" else "expert": 2})
    counters = all_counters()
    feats, labels = layout_batch()
    results = {}
    with deterministic():
        for name, (job_kw, dtype, optimizer) in PPEP_JOBS[mode].items():
            torch.cuda.reset_peak_memory_stats()
            model, step = layout_setup(dtype, optimizer,
                                       **ppep_model_kw(mode, job_kw))
            zero_counters(counters)
            run = layout_steps(model, step, feats, labels)
            launches = read_counters(counters)
            digest = hashlib.sha256()
            for k in sorted(run["states"][-1]):
                digest.update(run["states"][-1][k].numpy().tobytes())
            if rank == 0:
                torch.save(run, os.path.join(args.dp_out,
                                             f"{mode}_{name}.pt"))
                if name == "rep_f32":
                    torch.save(run["states"][-1],
                               os.path.join(args.dp_out, "ep.pth"))
            results[name] = {
                "launches": launches, "digest": digest.hexdigest(),
                "pp_engaged": [n for n, m in model.named_modules()
                               if getattr(m, "pp_engaged", False)],
                "step_ms_host": run["ms"],
                "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                "local_params": sum(p.numel() for p in model.parameters()),
                "collectives": run["collectives"]}
            del model, step, run
            torch.cuda.empty_cache()
    with open(os.path.join(args.dp_out, f"{mode}_rank{rank}.json"),
              "w") as f:
        json.dump(results, f)
    print(json.dumps({"ppep_rank": rank, "mode": mode}))
    dist.destroy_process_group()
    return 0


@contextlib.contextmanager
def stacks_in_microbatches(m, stages=2):
    """Within the block every MobileViT transformer stack whose depth
    splits over ``stages`` runs its layers on the batch in ``m``
    microbatches, one after the other, and concatenates them: the
    pipeline's arithmetic in one process, to tell a fault of the schedule
    from f32 reassociation. A patch inside this script; the port has no
    such switch."""
    import torch
    from picklebot_tpu_torch.models.mobilevit import TransformerStack
    saved = TransformerStack.forward

    def forward(self, x, kernels=True):
        if len(self.layers) % stages or x.shape[0] % m:
            return saved(self, x, kernels)
        outs = []
        for h in x.chunk(m):
            for attn, ff in self.pairs():
                h = attn(h, kernels=kernels) + h
                h = ff(h) + h
            outs.append(h)
        return torch.cat(outs)
    TransformerStack.forward = forward
    try:
        yield
    finally:
        TransformerStack.forward = saved


@contextlib.contextmanager
def moe_in_groups(size=2):
    """Within the block every MoE feed-forward whose token count splits
    over ``size`` routes the tokens regrouped as ``size`` blocks (the
    'tokens' dispatch's rank-local groups) in one process: the JAX test's
    reference for that mode. A patch inside this script."""
    from picklebot_tpu_torch.ops.moe import MoEFeedForward
    saved = MoEFeedForward.forward

    def forward(self, x):
        *lead, n, d = x.shape
        if n % size:
            return saved(self, x)
        return saved(self, x.reshape(*lead, size, n // size, d)).reshape(
            x.shape)
    MoEFeedForward.forward = forward
    try:
        yield
    finally:
        MoEFeedForward.forward = saved


@contextlib.contextmanager
def moe_as_ranks(size=2):
    """Within the block every MoE feed-forward computes as the ``size``
    ranks of expert parallelism do, in one process: per rank its own
    routing ('replicated': of every token; 'tokens', where the count
    splits: of its block, with the routing statistics averaged over the
    ranks), its experts' slots on its slice of the banks, 1/size of the
    aux loss's gradient ('replicated'), and the ranks' partial outputs
    summed ('replicated') or the slots exchanged as the two all-to-alls
    move them and the blocks concatenated ('tokens'). Each rank's input
    gradient is summed inside its own branch before the ranks' meet, as
    the collectives sum them: the layout's arithmetic in one process, to
    tell a fault of the layout from f32 reassociation. A patch inside this
    script; the port has no such switch."""
    import torch
    from picklebot_tpu_torch.ops.moe import MoEFeedForward
    saved = MoEFeedForward.forward

    def forward(self, x):
        *lead, n, d = x.shape
        e, g = self.n_experts, math.prod(lead)
        el = e // size
        banks = [(self.w1[..., s * el:(s + 1) * el],
                  self.w2[..., s * el:(s + 1) * el]) for s in range(size)]
        xv = x.view_as(x)      # where the ranks' input gradients meet
        if self.dispatch == "tokens" and n % size == 0:
            nl = n // size
            cap = self.capacity(nl)
            per, stats = [], None
            for r in range(size):
                xt = xv.narrow(-2, r * nl, nl).reshape(g, nl, d)
                choices, frac, prob = self._routing(xt, self.router)
                st = torch.cat([frac, prob]).detach()
                stats = st if stats is None else stats + st
                per.append((xt, choices, prob))
            frac_g, prob_g = (stats / size).split(e)
            aux, sent = None, []
            for xt, choices, prob in per:
                a = e * (frac_g * prob_g).sum() + (e / size) * (
                    frac_g * (prob - prob.detach())).sum()
                aux = a if aux is None else aux + a
                sent.append(self._dispatch(xt, choices, cap, 0, e))
            # expert rank s: every rank's slots of its experts, rank order
            ys = [self._experts(torch.cat([xin[s * el:(s + 1) * el]
                                           for xin, _ in sent], 1),
                                *banks[s]) for s in range(size)]
            outs = []
            for r, ((xt, choices, _), (_, where)) in enumerate(zip(per,
                                                                  sent)):
                yo = torch.cat([y[:, r * g:(r + 1) * g] for y in ys], 0)
                outs.append(self.drop2(self._combine(
                    yo, choices, where, xt.dtype)).reshape(*lead, nl, d))
            self._publish(aux)
            return torch.cat(outs, dim=-2)
        cap = self.capacity(n)
        out, aux = None, None
        for r in range(size):
            xt = xv.reshape(g, n, d)
            choices, frac, prob = self._routing(xt, self.router)
            a = e * (frac * prob).sum()
            a = a / size + (a * (1.0 - 1.0 / size)).detach()
            aux = a if aux is None else aux + a
            xin, where = self._dispatch(xt, choices, cap, r * el, el)
            part = self._combine(self._experts(xin, *banks[r]), choices,
                                 where, xt.dtype)
            out = part if out is None else out + part
        self._publish(aux)
        return self.drop2(out).reshape(*lead, n, d)
    MoEFeedForward.forward = forward
    try:
        yield
    finally:
        MoEFeedForward.forward = saved


def ppep_reference(dtype, optimizer, feats, labels, mode=None, patch=None,
                   job_kw=None):
    """``layout_reference`` of the one-process MobileViT-s of ``mode``
    (the ep mode's experts, ``job_kw``)."""
    return layout_reference(dtype, optimizer, feats, labels, patch,
                            **ppep_model_kw(mode, job_kw, distributed=False))


def phase_pp_ep(counters, gpu_line):
    """Pipeline and expert parallelism on the one card (module
    docstring)."""
    import torch
    from picklebot_tpu_torch.models.mobilevit import (MOBILEVIT_CONFIGS,
                                                      MobileViT)
    t_start = time.perf_counter()
    feats, labels = layout_batch()
    res = {"card": gpu_line, "modes": {}}
    failed = []
    refs = {}
    for dtype, opt in (("f32", "adamw"), ("bf16", "adamw8bit")):
        refs[("pp", dtype)] = ppep_reference(dtype, opt, feats, labels)
        refs[("ep", dtype)] = ppep_reference(dtype, opt, feats, labels, "ep")
    # the one-process steps that reproduce each layout's arithmetic: the
    # stacks in microbatches, the experts in the ranks' token groups
    for micro in (2, 4):
        refs[("pp", f"m{micro}")] = ppep_reference(
            "f32", "adamw", feats, labels,
            patch=stacks_in_microbatches(micro))
    refs[("ep", "groups")] = ppep_reference("f32", "adamw", feats, labels,
                                            "ep", patch=moe_in_groups())
    for short, dispatch in (("rep", "replicated"), ("tok", "tokens")):
        refs[("ep", f"{short}_ranks")] = ppep_reference(
            "f32", "adamw", feats, labels, "ep", patch=moe_as_ranks(),
            job_kw={"moe_dispatch": dispatch})
    # the f32 floors: each layout's arithmetic in one process against the
    # reference it is held to
    floors = {}
    for name, got, ref in (
            ("m2", ("pp", "m2"), ("pp", "f32")),
            ("m4", ("pp", "m4"), ("pp", "f32")),
            ("rep", ("ep", "rep_ranks"), ("ep", "f32")),
            ("tok", ("ep", "tok_ranks"), ("ep", "groups"))):
        d = layout_diff(refs[got], refs[ref], "f32")
        floors[name] = d["grad_max_rel_err"]
        res[f"f32_floor_{name}"] = {k: v for k, v in d.items()
                                    if k not in ("ok", "grad_bound")}
    emit({"phase": "pp_ep", "part": "f32_floors", **floors})
    with tempfile.TemporaryDirectory(prefix="pp_ep_") as out_dir:
        for mode in ("pp", "ep"):
            t0 = time.perf_counter()
            outs, rcs = layout_spawn(mode, out_dir, LAYOUT_RANK_TIMEOUT,
                                     kind="ppep")
            spawn_s = time.perf_counter() - t0
            if any(rcs):
                raise AssertionError(f"pp_ep {mode} ranks exited {rcs}:\n"
                                     + "\n".join(o[-3000:] for o in outs))
            ranks = []
            for r in range(2):
                with open(os.path.join(out_dir, f"{mode}_rank{r}.json")) as f:
                    ranks.append(json.load(f))
            checks = {}
            for name, (job_kw, dtype, _) in PPEP_JOBS[mode].items():
                flash_n = (PPEP_FLASH_PP[job_kw["pipeline_microbatches"]]
                           if mode == "pp" else sum(VIT_PACKED.values()))
                want = launches_wanted(
                    fused={"main": 7 * LAYOUT_STEPS,
                           **dw(7 * LAYOUT_STEPS)},
                    flash={"packed": flash_n * LAYOUT_STEPS,
                           "dq": flash_n * LAYOUT_STEPS,
                           "dkv": flash_n * LAYOUT_STEPS},
                    conv={"fwd": 6 * LAYOUT_STEPS, "dx": 6 * LAYOUT_STEPS})
                coll = ppep_collectives_want(mode, name, dtype)
                engaged = (["trunk.0.1.transformer", "trunk.1.1.transformer"]
                           if mode == "pp" else [])
                for r in range(2):
                    got = ranks[r][name]
                    if got["launches"] != want:
                        raise AssertionError(
                            f"pp_ep {mode} {name} rank {r} launches "
                            f"{got['launches']}, want {want}")
                    if got["pp_engaged"] != engaged:
                        raise AssertionError(
                            f"pp_ep {mode} {name} rank {r}: pipelined "
                            f"stacks {got['pp_engaged']}, want {engaged}")
                    for s, c in enumerate(got["collectives"]):
                        c = {k: v for k, v in c.items() if v["count"]}
                        if c != coll:
                            raise AssertionError(
                                f"pp_ep {mode} {name} rank {r} step {s} "
                                f"collectives {c}, want {coll}")
                if ranks[0][name]["digest"] != ranks[1][name]["digest"]:
                    raise AssertionError(f"pp_ep {mode} {name}: the ranks' "
                                         "weights differ")
                run = torch.load(os.path.join(out_dir, f"{mode}_{name}.pt"),
                                 weights_only=False)
                if dtype == "bf16":
                    checks[name] = layout_diff(run, refs[(mode, "bf16")],
                                               "bf16")
                else:
                    # the plain reference at twice the floor, the
                    # layout's own arithmetic at LAYOUT_F32_REL_TOL
                    same, ref = {
                        "m2_f32": ("m2", ("pp", "f32")),
                        "m4_f32": ("m4", ("pp", "f32")),
                        "rep_f32": ("rep_ranks", ("ep", "f32")),
                        "tok_f32": ("tok_ranks", ("ep", "groups"))}[name]
                    floor = floors[same.split("_")[0]]
                    bound = max(LAYOUT_F32_REL_TOL,
                                LAYOUT_FLOOR_FACTOR * floor)
                    checks[name] = layout_diff(run, refs[ref], "f32", bound)
                    checks[f"{name}_vs_{same}"] = layout_diff(
                        run, refs[(mode, same)], "f32")
                checks[name]["collectives_per_step"] = coll
            failed += [f"{mode} {k}" for k, c in checks.items()
                       if not c["ok"]]
            mres = {"checks": checks, "spawn_seconds": spawn_s,
                    "launches": {f"rank{r}": {n: ranks[r][n]["launches"]
                                              for n in PPEP_JOBS[mode]}
                                 for r in range(2)},
                    "by_job": {n: {k: [ranks[r][n][k] for r in range(2)]
                                   for k in ("step_ms_host",
                                             "peak_memory_bytes",
                                             "local_params")}
                               for n in PPEP_JOBS[mode]},
                    "note": "two processes share one card: step times are "
                            "not a speed figure"}
            if mode == "ep":
                # the EP run's .pth (full leaves) in one process: strict
                # load, then serve on the card with expert_parallel in the
                # config (serve takes the replicated equivalent)
                pth = os.path.join(out_dir, "ep.pth")
                model = MobileViT(num_classes=13, seed=1,
                                  **MOBILEVIT_CONFIGS["s"], **PPEP_MOE)
                model.load_state_dict(torch.load(pth, weights_only=True),
                                      strict=True)
                mres["one_process_params"] = sum(
                    p.numel() for p in model.parameters())
                cfg = serve_config("MobileViT", **MOBILEVIT_CONFIGS["s"],
                                   attention_backend="auto",
                                   expert_parallel=2, **PPEP_MOE)
                launches, serve_s, n_preds, evaluated = serve_run(
                    cfg, model, counters, pth=pth)
                packed = sum(VIT_PACKED.values())
                swant = launches_wanted(fused={"main": 14},
                                        flash={"packed": 2 * packed},
                                        conv={"fwd": 12})
                if launches != swant:
                    raise AssertionError(f"pp_ep ep .pth serve: launches "
                                         f"{launches}, want {swant}")
                mres["serve_pth"] = {"predictions": n_preds,
                                     "evaluated": evaluated,
                                     "launches": launches,
                                     "serve_wall_s": serve_s}
            emit({"phase": "pp_ep", "mode": mode, **mres})
            res["modes"][mode] = mres
    res["four_ranks"] = ("pipe 2 x model 2 and pipe 2 x seq 2 are left to "
                         "the CPU tests (tests/test_torch_pp.py::"
                         "test_pp_composes_with_tp_and_sp)")
    res["seconds"] = time.perf_counter() - t_start
    emit({"phase": "pp_ep", "seconds": res["seconds"]})
    if failed:
        raise AssertionError(f"pp_ep: {failed} against the one-process "
                             "runs past the bounds (their JSON lines above)")
    return res


def fused_entry(name, line, fused_per, launches_by_run):
    """Summary entry of one fused-bottleneck kernel: ms, plain, bound and
    library times summed over one bs-8 forward of each model (the top
    level: MobileNetLarge3D's)."""
    def sums(r):
        if not r:
            return None
        dev = [v["device_ms"] for v in r]
        return {"ms": sum(v["ms"] for v in r),
                "device_ms": None if None in dev else sum(dev),
                "plain_ms": sum(v["plain_ms"] for v in r),
                "bound_ms": sum(v["bound_ms"] for v in r),
                "bound_by": ("bytes" if sum(v["bytes_ms"] for v in r)
                             >= sum(v["ops_ms"] for v in r)
                             else "operations"),
                "library_ms": sum(v["library_ms"] for v in r),
                "geometries": len(r)}
    per_forward = {model: sums(per[name])
                   for model, per in fused_per.items()}
    large = per_forward["MobileNetLarge3D"]
    return {
        "name": f"fused_bottleneck_{name}", "route": "cuda",
        "source": "picklebot_tpu_torch/csrc/fused_bottleneck.cu",
        "replaces": f"picklebot_tpu/ops/pallas/fused_bottleneck.py:{line}",
        "launches": sum(r[name] for r in launches_by_run.values()),
        "launches_by_run": {k: r[name] for k, r in launches_by_run.items()},
        "max_abs_err": max(v["err"] for per in fused_per.values()
                           for v in per[name]),
        **{k: large[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "device_ms")},
        "per_forward": per_forward}


def conv_entry(which, rows, launches_by_run):
    """Summary entry of the conv kernel's forward or dx: times summed over
    the six launches of one bs-8 MobileViT-s forward (or one train
    microbatch's backward)."""
    def total(key):
        vals = [r[key] for r in rows]
        return None if None in vals else sum(vals)
    bounds = [r[f"{which}_bound"] for r in rows]
    return {"name": f"folded_conv_{which}", "route": "cuda",
            "source": "picklebot_tpu_torch/csrc/folded_conv.cu",
            "replaces": "picklebot_tpu/ops/pallas/folded_conv.py:58",
            "launches": sum(r[which] for r in launches_by_run.values()),
            "launches_by_run": {k: r[which]
                                for k, r in launches_by_run.items()},
            "max_abs_err": max(r[which]["err"] for r in rows),
            "ms": total(f"ms_{which}"),
            "plain_ms": total(f"plain_ms_{which}"),
            "bound_ms": sum(b["bound_ms"] for b in bounds),
            "bound_by": ("bytes" if sum(b["bytes_ms"] for b in bounds)
                         >= sum(b["ops_ms"] for b in bounds)
                         else "operations"),
            "library_ms": total(f"library_ms_{which}"),
            "device_ms": total(f"device_ms_{which}"),
            "library_device_ms": total(f"library_device_ms_{which}"),
            "per_forward" if which == "fwd" else "per_microbatch":
            {f"stage {r['stage']} {r['conv']}": 1 for r in rows}}


def flash_entry(name, kernel, line, rows, launches_by_run, per_forward):
    """Summary entry of one flash entry point: times summed over the
    launches of one bs-8 MobileViT-s forward that takes it
    (``per_forward``: {N: launches})."""
    nolse = [r for r in rows if r["entry"] == kernel and not r["lse"]]
    by_n = {r["n"]: r for r in nolse}

    def total(key):
        return sum(by_n[n][key] * cnt for n, cnt in per_forward.items())
    out = {"name": name, "route": "cuda",
           "source": "picklebot_tpu_torch/csrc/flash_attention.cu",
           "replaces": line,
           "launches": sum(r[kernel] for r in launches_by_run.values()),
           "launches_by_run": {k: r[kernel]
                               for k, r in launches_by_run.items()},
           "max_abs_err": max(r["err"] for r in rows
                              if r["kernel"] == kernel),
           **{k: total(k) for k in ("ms", "plain_ms", "bound_ms",
                                    "library_ms")},
           "bound_by": ("bytes" if total("bytes_ms") >= total("ops_ms")
                        else "operations"),
           **{k: (None if any(by_n[n][k] is None for n in per_forward)
                  else total(k))
              for k in ("device_ms", "library_device_ms")},
           "per_forward": {str(n): c for n, c in per_forward.items()}}
    return out


def flash_bwd_entry(name, kernel, line, rows, entry, launches_by_run,
                    per_step):
    """Summary entry of one flash backward kernel on one layout: times
    summed over the launches of one bs-8 MobileViT-s train microbatch that
    takes it (``per_step``: {N: launches}). The plain and library times
    are those of the whole backward (both kernels' work)."""
    by_n = {r["n"]: r for r in rows if r["entry"] == entry}

    def total(f):
        vals = [f(by_n[n]) for n in per_step]
        return None if None in vals else sum(
            v * c for v, c in zip(vals, per_step.values()))
    parts = ("dq",) if kernel == "dq" else ("dk", "dv")
    return {"name": name, "route": "cuda",
            "source": "picklebot_tpu_torch/csrc/flash_attention.cu",
            "replaces": line,
            "launches": sum(r[kernel] for r in launches_by_run.values()),
            "launches_by_run": {k: r[kernel]
                                for k, r in launches_by_run.items()},
            "max_abs_err": max(r[p]["err"] for r in by_n.values()
                               for p in parts),
            "ms": total(lambda r: r[f"ms_{kernel}"]),
            "plain_ms": total(lambda r: r["plain_ms"]),
            "bound_ms": total(lambda r: r[f"bound_{kernel}"]["bound_ms"]),
            "bound_by": ("bytes" if total(
                lambda r: r[f"bound_{kernel}"]["bytes_ms"]) >= total(
                lambda r: r[f"bound_{kernel}"]["ops_ms"])
                else "operations"),
            "library_ms": total(lambda r: r["library_ms"]),
            "device_ms": total(lambda r: r[f"device_ms_{kernel}"]),
            "library_device_ms": total(lambda r: r["library_device_ms"]),
            "plain_and_library_cover": "the whole backward",
            "per_microbatch": {str(n): c for n, c in per_step.items()}}


def parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(
        description="Run the PyTorch/CUDA port on one NVIDIA card and check "
        "it end to end.")
    ap.add_argument(
        "--only", nargs="+", choices=PHASES,
        help="run only these phases after the device and build phases: "
        "kernels (every kernel against its plain version), fused (the "
        "fused-bottleneck rows, the f32 and large-batch cases and the "
        "fused library's SASS check alone), conv (the conv "
        "kernel's rows alone), flash (the flash kernels' rows alone, "
        "forward and backward), serve, train (the CLI runs, the attention "
        "backends, the gradients against the plain path), trainx (the "
        "trainer extras: resume, remat, freeze, EMA), timing (the "
        "train-step timings), stream (serve --stream's models: whole "
        "clips, chunks against the whole clip, causality, chunk latency, "
        "MobileNetLarge2D's CLI run), v2 (MobileViTV2: logits and a train "
        "step against the CPU, timings, traces), bench (the port's bench "
        "entry on three runs), surface (the in-graph resize, the exported "
        "program, the HTTP server), tooling (the native collate and "
        "decoder, the CLI with the profilers and the autotuner, the "
        "summary), dp (data parallelism and ZeRO: NCCL at world 1, two "
        "processes on the card over gloo, the sharded predictor, the "
        "autotuner's broadcast), layouts (tensor and sequence "
        "parallelism on MobileViT-s: two processes on the card over gloo "
        "against one, ring attention, the TP run's .pth served), pp_ep "
        "(pipeline and expert parallelism on MobileViT-s: two processes "
        "on the card over gloo against one, the EP run's .pth served). A "
        "partial run prints no kernels summary")
    ap.add_argument(
        "--ab-forward", metavar="DIR", default=None,
        help="instead of the phases: MobileNetLarge3D's eager serve "
        "forward of the tree at DIR and of this one in turns A B B A A B "
        "B A")
    # one rank of the dp phase's two-process runs (the phase starts them)
    ap.add_argument("--dp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dp-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dp-out", help=argparse.SUPPRESS)
    ap.add_argument("--dp-mode", choices=("gloo", "nccl_probe"),
                    help=argparse.SUPPRESS)
    # one rank of the layouts phase (the phase starts them)
    ap.add_argument("--layout-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--layout-mode", choices=tuple(LAYOUT_MODES),
                    help=argparse.SUPPRESS)
    # one rank of the pp_ep phase (the phase starts them)
    ap.add_argument("--ppep-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--ppep-mode", choices=tuple(PPEP_JOBS),
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None):
    import torch
    args = parse_args(argv)
    only = set(args.only or ())

    def selected(phase):
        return not only or phase in only

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the "
              "port on an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if args.dp_rank is not None:
        return dp_rank_main(args)
    if args.layout_rank is not None:
        return layout_rank_main(args)
    if args.ppep_rank is not None:
        return ppep_rank_main(args)
    from picklebot_tpu_torch.utils.build import build_all

    gpu_line = nvidia_smi_line()
    print(gpu_line, flush=True)
    emit({"phase": "device", "nvidia_smi": gpu_line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        build = pool.submit(build_all)
        warm_s = warm_profiler()
        libs = build.result()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "profiler_warmup_seconds": warm_s, "libraries": sorted(libs)})
    for path in libs.values():
        log = path.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip(), file=sys.stderr)

    seconds = {"build": time.perf_counter() - t0,
               "profiler_warmup": warm_s}
    if args.ab_forward:
        ab_forward(os.path.abspath(args.ab_forward))
        print(gpu_line, flush=True)
        emit({"ok": True, "ab_forward": args.ab_forward,
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()}})
        return 0
    from picklebot_tpu_torch.ops import attention
    routed = {n: layers for n, layers in VIT_ATTENTION
              if n >= attention._PACKED_MIN_SEQ}
    if routed != VIT_PACKED:
        raise AssertionError(f"'auto' at _PACKED_MIN_SEQ = "
                             f"{attention._PACKED_MIN_SEQ} sends {routed} "
                             f"to the packed kernel; VIT_PACKED says "
                             f"{VIT_PACKED}")
    rows = fused_per = large_batch = flash = flash_bwd = sweep = conv = None
    stencil = None
    large = vit = small = movinet = None
    sass = {}
    t0 = time.perf_counter()
    if selected("kernels"):
        (rows, fused_per, large_batch, stencil, flash, flash_bwd, sweep,
         conv) = phase_kernels()
    if "fused" in only and not selected("kernels"):
        rows, fused_per, large_batch, stencil = fused_phase()
    if "conv" in only and not selected("kernels"):
        conv = conv_rows(reps=5)
    if "flash" in only and not selected("kernels"):
        flash, flash_bwd, sweep = flash_phase()
    if selected("kernels") or "fused" in only:
        sass["fused_bottleneck"] = sass_check(
            libs["fused_bottleneck"], "fused_bottleneck",
            ("pool_bf16_kernel", "main_bf16_kernel"))
        dw_local = {n: v for n, v in sass["fused_bottleneck"].items()
                    if "dw_" in n and any(v.get(f, 1) for f in (
                        "stack_frame", "spill_stores", "spill_loads"))}
        if dw_local:
            raise AssertionError(f"stencil backward kernels in local "
                                 f"memory: {dw_local}")
    if selected("kernels") or "conv" in only:
        sass["folded_conv"] = sass_check(libs["folded_conv"], "folded_conv",
                                         ("conv_bf16_kernel",))
    if selected("kernels") or "flash" in only:
        sass["flash_attention"] = sass_check(
            libs["flash_attention"], "flash_attention",
            ("fwd_bf16_kernel", "dq_bf16_kernel", "dkv_bf16_kernel"))
    if sass:
        seconds["kernels"] = time.perf_counter() - t0
    if any(selected(p) for p in ("serve", "train", "trainx", "timing",
                                 "stream", "surface")):
        feats, x = clip_batch()
    if selected("serve"):
        t0 = time.perf_counter()
        large = phase_serve_mobilenet("MobileNetLarge3D", large3d,
                                      GEOMETRIES, gpu_line, feats, x)
        seconds["serve_large3d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vit = phase_serve_mobilevit(gpu_line, feats, x)
        seconds["serve_mobilevit"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        small = phase_serve_mobilenet("MobileNetSmall3D", small3d,
                                      SMALL_GEOMETRIES, gpu_line, feats, x)
        seconds["serve_small3d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        movinet = phase_serve_movinet(gpu_line, feats, x)
        seconds["serve_movinet"] = time.perf_counter() - t0
        for key, res in (("large3d", large), ("mobilevit", vit),
                         ("small3d", small), ("movinet", movinet)):
            seconds[f"profile_{key}"] = res["profile"]["seconds"]

    counters = all_counters()
    labels = np.arange(8) % 13
    train = {}
    if selected("train"):
        # per train microbatch (forward and backward) and per eval batch
        packed = sum(VIT_PACKED.values())
        cli_runs = [
            ("MobileViT-s", "mobilevit_s.json",
             launches_wanted(fused={"main": 7, **dw(7)},
                             flash={"packed": packed, "dq": packed,
                                    "dkv": packed},
                             conv={"fwd": 6, "dx": 6}),
             launches_wanted(fused={"main": 7}, flash={"packed": packed},
                             conv={"fwd": 6})),
            ("MobileNetLarge3D", "mobilenet_large_50k.json",
             launches_wanted(fused={"pool": 8, "main": 15, **dw(15)}),
             launches_wanted(fused={"pool": 8, "main": 15})),
            ("MobileNetSmall3D", "mobilenet_small_50k.json",
             launches_wanted(fused={"pool": 9, "main": 11, **dw(11)}),
             launches_wanted(fused={"pool": 9, "main": 11})),
            ("MoViNetA2", "movinet_a2_50k.json", *[launches_wanted()] * 2)]
        for label, cfg_file, per_micro, per_eval in cli_runs:
            t0 = time.perf_counter()
            train[label] = phase_train_cli(label, cfg_file, counters,
                                           per_micro=per_micro,
                                           per_eval=per_eval)
            seconds[f"train_{label}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train["backends"] = phase_train_backends(counters, feats, labels)
        train["grads"] = {
            "MobileViT-s": grads_against_plain("MobileViT-s", mobilevit_s, x,
                                               labels),
            "MobileNetLarge3D": grads_against_plain("MobileNetLarge3D",
                                                    large3d, x, labels)}
        seconds["train_backends_and_grads"] = time.perf_counter() - t0
    trainx = None
    if selected("trainx"):
        t0 = time.perf_counter()
        trainx = {"cli": phase_trainx_cli(counters),
                  "remat": phase_trainx_remat(counters, feats, labels,
                                              gpu_line)}
        seconds["trainx"] = time.perf_counter() - t0
    if selected("timing"):
        train["timing"] = {
            label: phase_train_timing(
                label, make, feats, x, labels, gpu_line,
                vit_turns=label == "MobileViT-s")
            for label, make in (("MobileViT-s", mobilevit_s),
                                ("MobileNetLarge3D", large3d),
                                ("MobileNetSmall3D", small3d),
                                ("MoViNetA2", movinet_a2))}
        seconds["train_timing"] = sum(t["seconds"]
                                      for t in train["timing"].values())
    stream = None
    if selected("stream"):
        stream = phase_stream(gpu_line, feats, x, counters)
        seconds.update({f"stream_{k}": v["seconds"]
                        for k, v in stream.items() if isinstance(v, dict)})
    v2 = bench_runs = None
    if selected("v2"):
        v2 = phase_v2(gpu_line, counters)
        seconds["v2"] = v2["seconds"]
    if selected("bench"):
        t0 = time.perf_counter()
        bench_runs = phase_bench(counters)
        seconds["bench"] = time.perf_counter() - t0
    surface = None
    if selected("surface"):
        surface = phase_surface(gpu_line, feats, x, counters)
        seconds["surface"] = surface["seconds"]
    tooling = None
    if selected("tooling"):
        tooling = phase_tooling(gpu_line, counters)
        seconds["tooling"] = tooling["seconds"]
    dp = None
    if selected("dp"):
        dp = phase_dp(counters)
        seconds["dp"] = dp["seconds"]
    layouts = None
    if selected("layouts"):
        layouts = phase_layouts(counters, gpu_line)
        seconds["layouts"] = layouts["seconds"]
    pp_ep = None
    if selected("pp_ep"):
        pp_ep = phase_pp_ep(counters, gpu_line)
        seconds["pp_ep"] = pp_ep["seconds"]
    seconds["total"] = time.perf_counter() - T_START
    emit({"phase": "seconds", **seconds})

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    record = {"card": gpu_line, "seconds": seconds, "sass": sass,
              "geometries": rows, "large_batch": large_batch,
              "stencil_backward": stencil, "flash": flash,
              "flash_bwd": flash_bwd, "packed_min_seq_sweep": sweep,
              "folded_conv": conv,
              "serve": {"MobileNetLarge3D": large, "MobileViT-s": vit,
                        "MobileNetSmall3D": small, "MoViNetA2": movinet},
              "train": train, "trainx": trainx, "stream": stream, "v2": v2,
              "bench": bench_runs, "surface": surface, "tooling": tooling,
              "dp": dp, "layouts": layouts, "pp_ep": pp_ep}
    if only:
        skipped = [p for p in PHASES if not selected(p)
                   and not (p in ("fused", "conv", "flash")
                            and selected("kernels"))]
        emit({"phase": "skipped", "phases": skipped,
              "note": "a partial run (--only): no summary line"})
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_only.json"),
                  "w") as f:
            json.dump(dict(record, only=sorted(only)), f, indent=1)
        print(gpu_line, flush=True)
        emit({"ok": True, "only": sorted(only),
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()}})
        return 0

    # launches of each main-path run, read just after it
    runs = {"serve_large3d": large["launches"],
            "serve_small3d": small["launches"],
            "serve_mobilevit": vit["launches"]["fused"],
            **{f"forward_mobilevit_{b}": vit[b]["launches"]["fused"]
               for b in ("pallas", "pallas_packed")},
            **{f"train_{m}": train[m]["launches"]["fused"]
               for m in ("MobileViT-s", "MobileNetLarge3D",
                         "MobileNetSmall3D")},
            **{f"train_step_mobilevit_{b}":
               train["backends"][b]["launches"]["fused"]
               for b in ("pallas", "pallas_packed")}}
    runs.update({f"trainx_large3d_{k}": v
                 for k, v in trainx["cli"]["launches"].items()})
    vit_remat = {f"trainx_mobilevit_{dtype}_remat{r}": launches
                 for dtype in ("bf16", "f32")
                 for r, launches in trainx["remat"][dtype][
                     "launches"].items()}
    runs.update({k: v["fused"] for k, v in vit_remat.items()})
    surface_runs = {f"surface_{k}": v["launches"]
                    for k, v in surface.items()
                    if isinstance(v, dict) and "launches" in v}
    runs.update({k: v["fused"] for k, v in surface_runs.items()})
    runs["tooling_cli"] = tooling["cli"]["launches"]["fused"]
    runs["dp_nccl_world1"] = dp["nccl_world1"]["launches"]["fused"]
    for rank, jobs in dp["gloo"]["launches"].items():
        runs.update({f"dp_gloo_{rank}_{job}": launches["fused"]
                     for job, launches in jobs.items()})
    runs["dp_sharded_predict"] = dp["sharded_predict"]["launches"]["fused"]
    # the layouts phase: each rank's run of each job, and the .pth served
    layout_runs = {f"layouts_{mode}_{rank}_{job}": launches
                   for mode, m in layouts["modes"].items()
                   for rank, jobs in m["launches"].items()
                   for job, launches in jobs.items()}
    layout_runs["layouts_tp_pth_serve"] = layouts["modes"]["tp"][
        "serve_pth"]["launches"]
    # the pp_ep phase likewise, under the prefix ppep_
    layout_runs.update({f"ppep_{mode}_{rank}_{job}": launches
                        for mode, m in pp_ep["modes"].items()
                        for rank, jobs in m["launches"].items()
                        for job, launches in jobs.items()})
    layout_runs["ppep_ep_pth_serve"] = pp_ep["modes"]["ep"]["serve_pth"][
        "launches"]
    runs.update({k: v["fused"] for k, v in layout_runs.items()})
    if tooling["decode"]["ffmpeg_available"]:
        runs["tooling_serve_ffmpeg"] = tooling["decode"]["serve"][
            "launches"]["fused"]
    flash_runs = {"serve_mobilevit": vit["launches"]["flash"],
                  **{f"forward_mobilevit_{b}": vit[b]["launches"]["flash"]
                     for b in ("pallas", "pallas_packed")},
                  "train_MobileViT-s":
                  train["MobileViT-s"]["launches"]["flash"]}
    packed_bwd_runs = {"train_MobileViT-s":
                       train["MobileViT-s"]["launches"]["flash"],
                       **{k: v["flash"] for k, v in vit_remat.items()}}
    heads_bwd_runs = {f"train_step_mobilevit_{b}":
                      train["backends"][b]["launches"]["flash"]
                      for b in ("pallas", "pallas_packed")}
    flash_runs.update(heads_bwd_runs)
    flash_runs.update({k: v["flash"] for k, v in vit_remat.items()})
    flash_runs["surface_export_mobilevit"] = surface_runs[
        "surface_export_mobilevit"]["flash"]
    flash_runs.update({k: v["flash"] for k, v in layout_runs.items()})
    packed_bwd_runs.update({k: v["flash"] for k, v in layout_runs.items()})
    conv_runs = {"serve_mobilevit": vit["launches"]["conv"],
                 **{f"forward_mobilevit_{b}": vit[b]["launches"]["conv"]
                    for b in ("pallas", "pallas_packed")},
                 "train_MobileViT-s":
                 train["MobileViT-s"]["launches"]["conv"],
                 **{f"train_step_mobilevit_{b}":
                    train["backends"][b]["launches"]["conv"]
                    for b in ("pallas", "pallas_packed")},
                 **{k: v["conv"] for k, v in vit_remat.items()},
                 "surface_export_mobilevit":
                 surface_runs["surface_export_mobilevit"]["conv"],
                 **{k: v["conv"] for k, v in layout_runs.items()}}
    tpu = "picklebot_tpu/ops/pallas/"
    kernels = [
        fused_entry("pool", 86, fused_per, runs),
        fused_entry("main", 103, fused_per, runs),
        flash_entry("flash_packed_fwd", "packed",
                    f"{tpu}flash_packed.py:122", flash, flash_runs,
                    VIT_PACKED),
        flash_entry("flash_fwd", "heads", f"{tpu}flash_attention.py:47",
                    flash, flash_runs, dict(VIT_ATTENTION)),
        flash_bwd_entry("flash_packed_bwd_dq", "dq",
                        f"{tpu}flash_packed.py:271", flash_bwd, "packed",
                        packed_bwd_runs, VIT_PACKED),
        flash_bwd_entry("flash_packed_bwd_dkv", "dkv",
                        f"{tpu}flash_packed.py:304", flash_bwd, "packed",
                        packed_bwd_runs, VIT_PACKED),
        flash_bwd_entry("flash_bwd_dq", "dq", f"{tpu}flash_attention.py:146",
                        flash_bwd, "heads", heads_bwd_runs,
                        dict(VIT_ATTENTION)),
        flash_bwd_entry("flash_bwd_dkv", "dkv",
                        f"{tpu}flash_attention.py:173", flash_bwd, "heads",
                        heads_bwd_runs, dict(VIT_ATTENTION)),
        conv_entry("fwd", conv, conv_runs),
        conv_entry("dx", conv, {k: r for k, r in conv_runs.items()
                                if k.startswith(("train_", "trainx_",
                                                 "layouts_", "ppep_"))}),
    ]
    # the host's collate over the whole script: every batch the C++ core's
    from picklebot_tpu_torch.data.native import COLLATES
    collates = dict(COLLATES)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(dict(record, kernels=kernels, collates=collates), f,
                  indent=1)
    emit({"phase": "summary", "collates": collates})
    if collates["numpy"] or not collates["native"]:
        raise AssertionError(f"a batch left the native collate: {collates}")
    print(gpu_line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
