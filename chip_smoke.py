#!/usr/bin/env python3
r"""
Drives the PyTorch port (``virtex_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root, on a machine with a CUDA card, ``nvcc``
(``/usr/local/cuda``) and PyTorch built for CUDA. It exits non-zero, and
prints no result, when there is no card or when any phase fails:

1. device: the card's name and power limit; TF32 off for every comparison.
2. build: kernels K1, K2, K4's two stages, the BatchNorm forward's two,
   the decode attention and beam select (``virtex_tpu_torch/csrc/*.cu``)
   are built with
   ``nvcc`` for ``sm_90a``, one process per source, in parallel.
3. K1 against its plain PyTorch version on the card: the flagship's
   attention shapes (batch 128, 16 heads of 64; self 30×30 causal + pad,
   cross 30×49), a per-head mask, the wide gate shape (640, 30, 79, 32, 64),
   fp32 (the scalar variant) and bf16 (the tensor-core variant, checked by
   its launch count), and dropout's keep fraction and seeding.
4. K2 against its plain version at the train step's shapes (batch 128; self
   30×30 causal + pad and cross 30×49, q/k/v strided views of the packed
   projection), fp32 and bf16; with dropout 0.1, K1's and K2's keep masks
   equal ``philox_keep_reference`` bit for bit in both variants, and K2's
   gradients match the plain version given that mask. Then K1 and K2 in
   bf16 at the edges of the tensor-core tiling (Tq 1, Tk 1, a fully masked
   query row, D 32 and 128, q/k/v views that are not 16-byte aligned), and
   one dropout forward and backward of ``MultiHeadAttention`` under
   ``torch.cuda.set_sync_debug_mode("error")``: no host sync.
5. K4's stage 1 (the channel sums) and stage 2 (dx) against their plain
   versions at the 12 ResNet-50 BatchNorm shapes at batch 128 in bf16 (the
   vector variants), with an NCHW-contiguous dy, an odd M, a C of 60 (the
   scalar variants), and the fp32 and both mixed-dtype instantiations; two
   launches of each give equal bits. Both stages also at batch 256 (the
   fine-tune's one micro-step) at its largest and smallest shapes,
   112×112×64 and 7×7×2048; and stage 2 with ``m_total`` = 2·M (sums
   reduced over two ranks) at 112×112×64 and 7×7×2048. Then the BatchNorm
   forward's kernels at the 12 shapes at batch 128 in bf16: the statistics
   within FWD_STATS_TOL of their plain version, the running statistics
   (updated in the same launch) and the apply, in train and eval mode,
   bit-equal to the torch ops; two launches give equal bits, in the vector
   variants.
6. eval step: the flagship ``bicaptioning_R_50_L1_H1024`` at full width in
   bf16 (built by ``PretrainingModelFactory.from_spec`` on the card, its
   default; weights from a numpy seed), batch 32 of captions of varied
   length.
   Finite losses, exactly 4 K1 launches, and the same losses from a copy
   of the model whose attention calls the plain version.
7. captioning: beam search (K = 5, 30 steps) on 32 images, its decode
   attention launched twice per layer and step (self and cross), in no
   other kernel than the eval step's; then the decode attention against
   its plain version at the caption cell's shapes (1280 query rows, 256
   images' 49 visual tokens shared by 5 beams each; the self cache at every
   n_valid 1..30 of 30 positions) at 32 and 16 heads, within
   TOL["bfloat16"], one launch a call, equal bits twice, positions past
   n_valid never read; the flagship's teacher-forced decode along the
   captions (cross K/V per image) within LOSS_RTOL of a copy whose decode
   attention is the plain version; and its device time beside its bound,
   the plain version and ``scaled_dot_product_attention`` (SDPA_BACKEND).
   Beam select at the caption cell's shapes (256 images x 5 beams over
   10,000 tokens, 2 kept a beam; step 0's mode keeping 5 of each image's
   first row) bit-equal to its plain version on the CPU, on drawn rows and
   on rows of ties, ±0 and −inf, one launch a call, equal bits twice; the
   beam search above launched it once a step; its device time beside its
   bound, the plain version and two ``torch.topk`` calls (phase 9).
8. train step: the flagship in bf16, micro-batch 128 × accumulation 2 as
   ``bench.py`` runs it, captions of varied length, the optimizer of
   ``OPTIM.*``. With dropout 0 the first step's losses and ``grad_norm``
   match a copy whose attention and BatchNorm (forward and backward) call
   the plain versions, and so do the running statistics; then five steps
   with dropout 0.1 and no warmup give finite losses and a Lookahead sync
   at step 5. Every step makes exactly 8 K1, 8 K2, 106 launches of each K4
   stage and 106 of each BatchNorm forward kernel, every K1 and K2 launch
   of a bf16 main path (here and in phases 6 and 11) in the tensor-core
   variant and every K4 and BatchNorm forward launch in the vector
   variant.
9. timings: K1, K2, K4's two stages, the whole BatchNorm backward and the
   BatchNorm forward's two kernels beside their bounds, their plain
   versions and their library calls (``scaled_dot_product_attention``
   pinned to SDPA_BACKEND, its aten backward op,
   ``torch.batch_norm_backward_reduce``, ``torch.batch_norm_backward_elemt``,
   ``torch.batch_norm_stats`` and ``torch.batch_norm_elemt``; device time
   from CUDA-graph replay, in turns), per call and per train step (the
   forward at batch 256, per update of 256 in one micro-step, as the
   benchmark's train cell runs it), and how many of a step's
   BatchNorm backwards got a dy that had to be copied to rows; the eval
   step, beam captioning, and the train step with the kernels and with the
   plain versions (host clock); one flagship train step under
   ``torch.profiler``: device busy time and kernel time by kind.
10. K1 and K2 at the task ablations' attention (``L1_H2048_A32_F8192``:
    batch 128, 32 heads of 64), fp32 and bf16, with the masks as
    ``make_self_attention_mask`` returns them: causal + pad (B, 1, T, T)
    and masked LM's pad-only (B, 1, 1, T), which the kernels read with a
    query stride of 0; and the 30×49 cross-attention. With dropout 0.1 the
    keep masks equal ``philox_keep_reference`` bit for bit. Device times
    beside the bounds, the plain versions and the library calls.
11. the four other pretext tasks of ``configs/task_ablations`` (forward
    captioning, masked LM, token and multilabel classification) at full
    width in bf16, micro-batch 128 × accumulation 2, on batches shaped as
    their datasets make them. With dropout 0 the first step's losses and
    ``grad_norm`` match a plain-kernel copy; three steps with dropout 0.1
    give finite losses; every step makes exactly 4 K1, 4 K2 and 106 + 106
    K4 launches (0, 0 and 106 + 106 for the classification tasks); the eval
    step at
    batch 32 gives finite losses and well-formed predictions. Host ms per
    step with the kernels and with the plain versions.
12. nucleus captioning (p 0.9, 30 steps) with the flagship model of phase
    6 on 32 images: tokens in range, seeded draws, no K1, K2 or K4 launch
    and two decode attention launches per layer and step, and the first
    step's drop set on the card equal to the CPU's.
13. pretraining: the JPEG codecs on the machine, and the data plane's
    decoder for the card (nvJPEG) round-tripping quality-95 images within
    DECODE_MEAN_TOL; a synthetic COCO-2017 directory (512 train and 64 val
    JPEGs at 640x480 and 480x640, five captions each, instances json) and
    a tokenizer JSON written here; ``pretrain_virtex.main`` on
    ``configs/_base_bicaptioning_R_50_L1_H1024.yaml`` for 6 iterations of
    256 images (128 x accumulation 2, dropout 0.1), validating and saving
    every 3: finite losses, a finite validation loss, the checkpoints and
    ``best.json``, and exactly 8 K1, 8 K2 and 106 + 106 K4 launches per
    train step and K1 launches in the validation eval step; then a run
    resumed from ``checkpoint_3`` through 6 whose losses and final model
    and optimizer state equal the unbroken run's (RESUME_RTOL; cuDNN's
    deterministic algorithms on); the loader's images/s alone and the
    CLI's ms per iteration.
14. eval_captioning (``python -m virtex_tpu_torch.scripts.eval_captioning``)
    on phase 13's last checkpoint over the synthetic val split, with
    ``--calc-metrics --output``, by beam search and by nucleus sampling:
    one prediction per val image, captions that decode, the metrics'
    keys, CIDEr (the port's PTB tokenizer and CIDEr-D) finite in [0, 1000],
    no kernel launched; then ``--images`` on a directory of JPEGs (string
    ids). The first 4 val images' beam tokens on the card, in fp32 and in
    bf16, against a CPU fp32 run of the same checkpoint: equal, or a near
    tie (beam scores within BEAM_SCORE_RTOL). Host ms per batch of 32.
15. the binary SentencePiece reader on this machine: the committed
    ``tests/fixtures/torch_sp_bpe.model`` encodes and decodes equal to its
    golden, and ``python -m virtex_tpu_torch.scripts.tokenizer_selfcheck``
    passes on the Unigram byte-fallback ``tests/fixtures/
    torch_sp_unigram.model`` and its golden (the JAX reader's ids),
    importing no ``transformers``, protobuf or sentencepiece.
16. clf_linear (``python -m virtex_tpu_torch.scripts.clf_linear``) with
    ``--weight-init virtex`` from phase 13, on synthetic ImageNet and
    iNaturalist trees (512 train and 128 val JPEGs each, 500x375 and
    375x500), 4 iterations of 256, checkpoints every 2: the linear probe
    (``configs/downstream/imagenet_clf.yaml``) launches no K4 and leaves
    the backbone bit-unchanged; the fine-tune (``inaturalist_clf.yaml``,
    ResNet-50 at 224², bf16, one micro-step of 256) launches exactly 53 +
    53 K4 per step, all in the vector variants, its first step within
    LOSS_RTOL of a copy whose BatchNorm backward runs the plain versions;
    finite losses, top-1 in [0, 100] on the last line, checkpoints and
    ``best.json``. Host ms per step alone and per CLI iteration, one
    fine-tune step under ``torch.profiler``, K4 timed at batch 256.
17. clf_voc07 (``python -m virtex_tpu_torch.scripts.clf_voc07``) with
    ``--weight-init virtex`` from phase 13 on a synthetic VOC2007 tree (20
    classes, 512 trainval and 512 test JPEGs at 500x375 and 375x500 written
    with PIL, positives in every class, some "difficult" entries), ResNet-50
    bf16 at 224, batch 128: no kernel launched, L2-normalised features of
    the right shape, 260 SVM fits each stopped at a gradient norm <= 1e-6
    of its start, per-class APs and the mAP line. Then the solver alone at
    VOC2007's size (5011 x 2048 trainval, 4952 test features drawn from a
    seed with a class signal; 260 fits in fp64 on the card) under the same
    gate, and two classes at C 1 equal to the same solver on the host CPU
    within 1e-8 of w's scale. Features and loader images/s, seconds for the
    fits, peak memory.
18. remat: the flagship train step (128 x 2, bf16, dropout 0.1) with
    ``visual_remat`` and ``textual_remat`` against the plain step, from one
    generator seed and one batch, cuDNN deterministic: 16 K1, 8 K2 and 106
    + 106 K4 launches (the plain step's 8 K1 and the recomputation's 8 on
    the same seeds), loss within 1e-5 and ``grad_norm`` within 1e-3
    (relative), BatchNorm buffers equal, the generator's state equal; whether
    the parameters are bit-equal; host ms per step in turns and peak memory
    of both.
19. BatchNorm's "batch" sampler: the flagship step at ``bn_stat_stride`` 4:
    no K4 launch (plain autograd, the JAX package's own path), the first
    step's loss (dropout 0) within LOSS_RTOL of fp32 plain math on the card,
    running statistics finite and ``num_batches_tracked`` one per micro-step
    in all 53 layers; then steps with dropout 0.1 and their ms.
20. data parallelism: (a) phase 13's CLI run again as rank 0 of a process
    group of one over NCCL, joined through torchrun's environment: losses,
    validation and every tensor of its last checkpoint bit-equal to phase
    13's, the launches of every step as there, and the all-reduces counted
    (53 + 53 BatchNorm ones per micro-step, one of the gradients per
    iteration, the losses' denominators and the metrics). (b) two ranks
    over gloo on the one card, each a process of its own (``python3
    chip_smoke.py --dp-rank R ...``), the flagship at full width from rank
    0's weights by broadcast, one step on global batch 2 x 128 as two ranks
    of 64 x accum 2, dropout 0, against one process on the same global
    micro-batches: fp32 with TF32 off, the losses, the BatchNorm running
    buffers and the gradients outside the ResNet within DP_FP32_TOL of each
    tensor's scale; then the fp32 step again with the ResNet's ReLU masks
    and max-pool choices pinned to the one process's (``ResNetBranches``),
    every gradient, buffer and loss within DP_FP32_TOL; and ``bn_train``
    synced over the ranks against one process at 112×112×64 and 7×7×2048
    within DP_FP32_TOL;
    bf16, the losses within LOSS_RTOL; 8 K1, 8 K2 and 106 + 106 K4 launches per rank; the ranks'
    dropout seeds and K1/K2 keep masks differ, each equal to
    ``philox_keep_reference`` on its seed. Host ms of the world-2 step
    (gloo stages the all-reduces through the host) and the host ms inside
    its all-reduces by kind.
21. the model zoo (``virtex_tpu_torch.model_zoo``): (a) each of its 16
    entries at its published widths, weights drawn on the card from a seed
    (``card_randomize_``), written as a reference-format ``.pth`` into a
    ``$VIRTEX_TPU_ZOO_DIR`` and loaded by ``model_zoo.get(entry,
    pretrained=True)`` on the card, every tensor bit-equal to the file; its
    eval step at batch 32 in bf16 with 4·L K1 launches for a bicaptioning
    head of L layers (2·L for one direction, none for the linear head);
    beam captioning at batch 32 for ``L4_H1024``. (b) the seven
    architectures no earlier phase trains (``R_101``, ``R_50W2X``, ``L2``,
    ``L3``, ``L4``, ``H512``, ``H768``) each take a train step at 128 × 2
    in bf16 with the flagship's optimizer: 8·L K1 and K2 launches and two
    of each K4 stage per BatchNorm layer (104 in ResNet-101, 53 else), the
    losses and ``grad_norm`` as phase 8 holds them to a plain-kernel copy;
    ms per step, peak GiB and one step under ``torch.profiler``. (c) K1
    and K2 at 8 and 12 heads (B 128 self and cross, K1 also at B 32; keep
    masks bit for bit) and K4's two stages at the BatchNorm shapes of
    ``R_50W2X`` and ``R_101`` beyond ResNet-50's, against their plain
    versions at phases 3-5's tolerances, timed as phases 9 and 10 time
    them. (d) ``resnet50_extractor(pretrained=True)``
    through ``torch.hub.load(..., source="local")`` on NHWC and NCHW images,
    (32, 7, 7, 2048) and bit-equal to ``model_zoo.get``'s ``model.visual``.
    (e) ``eval_detectron2 --weight-init virtex`` on phase 13's checkpoint
    and on (a)'s ``R_101`` file: with no detectron2 here each writes its
    ``.pkl``, whose tensors renamed back equal the checkpoint's ResNet bit
    for bit, in 16 and 33 blocks. (f) ``build_vocabulary`` on phase 13's
    captions: the ``.model`` and the ``.sp.model`` encode them alike.
22. tensor parallelism of the textual head: two gloo ranks on the one
    card, each a process of its own (``python3 chip_smoke.py --tp-rank R
    ...``), on a mesh of data 1 × model 2 (``PARALLEL.MODEL`` 2): each rank
    holds 8 of the flagship's 16 heads and half of its feed-forward
    columns. (a) One fp32 step (TF32 off, dropout 0, cuDNN deterministic)
    of 128 × 2 from rank 0's weights by broadcast, against phase 20(b)'s
    one process on the same batch: the losses, ``grad_norm``, the BatchNorm
    buffers and every gradient gathered to full names within DP_FP32_TOL of
    each tensor's scale; 8 K1, 8 K2 and 106 + 106 K4 launches per rank, and
    the all-reduces by kind as TP_STEP_COLLECTIVES works them out. (b)
    Three bf16 steps at dropout 0.1: after each, every replicated parameter
    and buffer bit-equal on the two ranks, the ranks' losses bit-equal,
    and their first attention seeds apart by 1000003, each one's K1 and
    K2 keep masks equal to ``philox_keep_reference``; host ms of the step
    and inside its all-reduces (gloo, staged through the host). (c)
    ``bicaptioning_R_50_L1_H2048`` (A32 F8192, 16 heads per rank), one bf16
    step at dropout 0, the losses within LOSS_RTOL of one process's. (d)
    ``pretrain_virtex`` with ``PARALLEL.MODEL 2`` on phase 13's data, 4
    iterations, validating and saving every 2, and resumed from 2: rank
    0's checkpoints hold full tensors, which a one-process model loads and
    whose slices equal each rank's shards bit for bit; the resumed run's
    last checkpoint bit-equal to the unbroken one's.
23. the feature bit-check and the closure rehearsal: (a) ``python -m
    virtex_tpu_torch.scripts.feature_bitcheck`` on the five
    ``configs/task_ablations`` at full width (R-50 at 224², the H2048 head,
    B 2, fp32, TF32 off, dropout 0), each on a ``.pth`` drawn on the card
    with ``card_randomize_``: the card writes its eval grid, losses and
    d(loss)/d(image) (4/2/2/0/0 K1 and K2, 53 + 53 K4 launches) and the
    CPU is held to them at the script's gates; (b) the card held to the
    JAX package's results in ``tests/fixtures/torch_bitcheck_golden.npz``
    (resnet18 at 64²) on the numpy-drawn ``.pth`` files whose sha256 it
    pins; (c) ``python -m virtex_tpu_torch.scripts.reproduce_parity`` on
    the card, every step of the synthetic rehearsal.
24. the end-to-end learning proof (``python -m virtex_tpu_torch.scripts.
    quality_proxy``): (a) K1 and K2 at the proxy's head, 4 heads of 32,
    fp32 and bf16, self-attention over 30 (and 16) tokens and
    cross-attention to 16 and 4 visual tokens at B 8, 16 and 32, and K1 at
    16 heads at the full width's validation batch of 48, against their
    plain versions; their keep masks bit for bit at 4 heads of 32; K4's two
    stages at resnet18's BatchNorm shapes at 128² (B 16, 32) and 64² (B 8,
    down to 32 rows); each timed beside its bound, plain version and
    library call. (b) ``--mode overfit``: 300 steps on one batch of 8,
    the last loss under 1.0 and beam search (SOS kept) giving back at
    least 6 of the 8 captions exactly. (c) ``--accum 2``, the JAX proxy's
    recipe: 400 iterations of pretrain_virtex on the learnable COCO
    (resnet18 at 128², L1_H128_A4_F512, bf16, dropout 0.1), then
    eval_captioning --calc-metrics by beam search and by nucleus sampling:
    CIDEr ≥ 100 and ≥ 80. (d) ``--width full``: the same at the flagship's
    widths (R-50 at 224², L1_H1024_A16_F4096, 128 × 2) for 100 iterations,
    the same gates. Each part's K1, K2 and K4 launches equal steps ×
    micro-steps × layers × directions, and its eval steps' as phase 13's.
    Every phase's seconds are printed before the kernels line.

The line before the last is a JSON object on the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import io
import itertools
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda:0"
SEED = 0
EVAL_BATCH = 32
# The pretraining CLI's validation sweep runs the eval step on batches of
# OPTIM.BATCH_SIZE and then the split's remainder: 64 (phase 13's whole
# synthetic split in one batch), and on COCO val2017 (5000 images) 19
# batches of 256 and one of 136. K1 is held to its plain version at each.
VAL_BATCHES = (64, 256, 5000 % 256)
# K1 against the plain version, per element |a − b| / (|ref| + ATOL):
# q, k, v ~ N(0, 1), so outputs are O(1) and ATOL = 1 is their scale.
ATOL = 1.0
TOL = {"float32": 1e-5,   # two fp32 sums of ≤ 79 terms in other orders
       "bfloat16": 2e-2}  # a flipped bf16 rounding of P or O is 2^-8
# The eval step's losses, K1 model against the plain-attention model: the
# models differ only in where bf16 attention outputs round (one bf16 ulp,
# 2^-8, at most), and each loss averages ~900 tokens.
LOSS_RTOL = 1e-2
KEEP_RANGE = (0.89, 0.91)  # dropout rate 0.1
# The train step as bench.py runs it: micro-batch 128, accumulation 2.
TRAIN_BATCH, ACCUM, TRAIN_STEPS = 128, 2, 5
LAUNCHES_PER_STEP = {"K1": 8, "K2": 8, "K4": 106, "K4dx": 106}
# K2 against the plain version: as K1 (TOL, ATOL); its sums run over <= 49
# keys or 30 queries. K4 against the plain version, per element
# |a − b| / (|ref| + sqrt(M)): both read the inputs exactly and sum M terms
# of scale 1 in fp32 in other orders, so sqrt(M) is the sums' scale. K4's
# dx against its plain version, per element |a − b| / (|ref| + 1) (dx is
# γ·rstd·O(1)): both compute it in fp32 from the same sums and round once to
# x's dtype, so fp32 differs by the association of the same terms and bf16
# by at most one rounding (2^-8).
K4_TOL = 1e-5
# The BatchNorm forward's statistics kernel against its plain version, per
# element |a − b| / (|ref| + 1) on the O(1) means, var and rstd: both read x
# exactly and sum in fp32 in other orders.
FWD_STATS_TOL = 1e-5
# The running statistics after a train step, kernels against the plain
# versions, per element |a − b| / (|ref| + 1): each layer's input is bf16,
# and where the two sides' statistics differ in their last fp32 bits the
# apply rounds some elements of y the other way, so every later layer's
# statistics carry bf16 noise, up to one rounding (2^-8). The update's own
# arithmetic is held bit for bit in phase 5.
RUNNING_TOL = 2 ** -8
DX_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
# First train step, kernels against the plain versions (dropout 0): the
# losses as the eval step's (LOSS_RTOL). grad_norm: the plain attention
# backward rounds dP to bf16 through autograd of the bf16 cast of P, which
# K2 does not, and the BatchNorm sums add in other orders; 2^-8 relative
# noise on some gradients moves the global norm by far less than 1e-2.
GRAD_NORM_RTOL = 1e-2
# The task ablations' textual head, L1_H2048_A32_F8192: 32 heads of 64.
WIDE_HEADS = 32
# configs/task_ablations/<stem>.yaml, each trained as phase 8 trains the
# flagship; launches per step: self- and cross-attention in one direction
# over two micro-steps, and the 53 BatchNorm layers over two.
TASKS = {"captioning_R_50_L1_H2048": {"K1": 4, "K2": 4, "K4": 106,
                                      "K4dx": 106},
         "masked_lm_R_50_L1_H2048": {"K1": 4, "K2": 4, "K4": 106,
                                     "K4dx": 106},
         "token_classification_R_50": {"K1": 0, "K2": 0, "K4": 106,
                                       "K4dx": 106},
         "multilabel_classification_R_50": {"K1": 0, "K2": 0, "K4": 106,
                                            "K4dx": 106}}
TASK_DROPOUT_STEPS = 3
# Masked LM's batches: BERT-style masking of the inner positions
# (virtex_tpu/data/datasets/masked_lm.py); multilabel's: COCO categories
# 1..80, distinct and sorted, padded with 0 to 80 slots
# (virtex_tpu/data/datasets/classification.py).
MASK_INDEX, MASK_PROPORTION, MASK_PROB, REPLACE_PROB = 3, 0.15, 0.85, 0.10
MAX_LABELS = 80
# Nucleus captioning: p as MODEL.DECODER.NUCLEUS_SIZE; drop-set rows whose
# sorted mass before some token lies this close to p are not compared
# (fp32 sums in other orders may fall on either side).
NUCLEUS_P, BOUNDARY_MARGIN = 0.9, 1e-6
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): HBM
# bytes/s, dense bf16 tensor-core and fp32 (outside the tensor cores)
# FLOP/s. A kernel's bound is the larger of its bytes (each input read
# once, each output written once) and its operations at these rates.
HBM_BYTES_PER_S, BF16_FLOPS, FP32_FLOPS = 3.35e12, 989e12, 67e12
# The PyTorch call timed beside K1 and K2 (never called by the port):
# scaled_dot_product_attention with the same bool mask, pinned to this
# backend; K2's is that backend's aten backward op on its forward's saved
# outputs.
SDPA_BACKEND = "EFFICIENT_ATTENTION"
# CUDA-graph calls and replays per timing of the BatchNorm backward, whose
# plain versions take up to ~3 ms a call.
BN_CALLS, BN_REPLAYS = 20, 5
L2_BYTES = 50 * 2 ** 20  # the H100's L2 cache
# Every distinct (H, C) of ResNet-50's BatchNorm layers at 224²
# (tests/tpu_bn_parity.py).
R50_BN_SHAPES = [(112, 64), (56, 64), (56, 256), (56, 128), (28, 128),
                 (28, 512), (28, 256), (14, 256), (14, 1024), (14, 512),
                 (7, 512), (7, 2048)]
# clf_linear's fine-tune (configs/downstream/inaturalist_clf.yaml): batch
# 256 in one micro-step, so every BatchNorm's M is twice the train step's.
# K4 is held to its plain versions (phase 5) and timed (phase 16) at the
# largest and the smallest of its shapes there.
FINETUNE_BATCH = 256
FINETUNE_K4_SHAPES = [(112, 64), (7, 2048)]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# Seconds per phase: the time since the previous line goes to this line's
# phase number.
PHASE_SECONDS: dict = {}
_LAST_LINE = [time.perf_counter()]


def say(phase: str, msg: str) -> None:
    now = time.perf_counter()
    key = phase.split()[0]
    PHASE_SECONDS[key] = PHASE_SECONDS.get(key, 0.0) + now - _LAST_LINE[0]
    _LAST_LINE[0] = now
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def rel_err(a, ref, atol: float) -> float:
    a, ref = a.double(), ref.double()
    return float(((a - ref).abs() / (ref.abs() + atol)).max())


# -- phase 3 -----------------------------------------------------------------
def attention_inputs(torch, B, Tq, Tk, N, D, dtype, device, seed,
                     packed=False):
    """q (B, Tq, N, D), k and v (B, Tk, N, D) ~ N(0, 1). ``packed``: views
    into one projection, as ``MultiHeadAttention`` passes them (q/k/v of
    (B, Tq, 3·N·D) for self-attention, k/v of (B, Tk, 2·N·D) for cross)."""
    rng = np.random.RandomState(seed)
    draw = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.randn(*shape).astype(np.float32)).to(device, dtype)
    if not packed:
        return [draw(B, T, N, D) for T in (Tq, Tk, Tk)]
    if Tq == Tk:
        return [t.view(B, Tq, N, D) for t in draw(B, Tq, 3 * N * D)
                .split(N * D, dim=-1)]
    k, v = (t.view(B, Tk, N, D) for t in draw(B, Tk, 2 * N * D)
            .split(N * D, dim=-1))
    return [draw(B, Tq, N * D).view(B, Tq, N, D), k, v]


def self_mask(torch, B, T, device, seed, lengths=None):
    """Causal + key padding, lengths drawn in [3, T] (row 0 full)."""
    if lengths is None:
        rng = np.random.RandomState(seed)
        lengths = rng.randint(3, T + 1, B)
        lengths[0] = T
    lengths = torch.as_tensor(lengths, device=device)
    pos = torch.arange(T, device=device)
    key_ok = (pos[None, :] < lengths[:, None])[:, None, None, :]
    return key_ok & (pos[None, :] <= pos[:, None])[None, None]


def tensor_core_wanted(torch, A, q, k):
    """Whether K1 and K2 should take their tensor-core variant for these
    operands; every bf16 shape this script runs must."""
    want = A.use_tensor_cores(q.dtype, q.shape[3], k.shape[1])
    if q.dtype == torch.bfloat16 and not want:
        fail(f"bf16 q {tuple(q.shape)}, k {tuple(k.shape)}: the wrapper "
             "would not take the tensor-core variant")
    return want


def k1_out(torch, A, name, q, k, v, mask, rate=0.0, seed=None):
    """fused_attention on the card, checked to launch K1 once, in the
    tensor-core variant exactly where the operands are bf16."""
    want = tensor_core_wanted(torch, A, q, k)
    before = launched()
    out = A.fused_attention(q, k, v, mask, rate, seed)
    torch.cuda.synchronize()
    if launched() - before != {("k1", "mma" if want else "scalar"): 1}:
        fail(f"K1 {name}: fused_attention did not launch K1's "
             f"{'tensor-core' if want else 'scalar'} variant once")
    return out


def check_k1(torch, A, device):
    """K1 against ``attention_reference`` on the card. Returns the largest
    absolute bf16 error at the eval step's shapes, the dropout keep
    fraction, and a summary of the per-case errors."""
    cases = [
        # name, (B, Tq, Tk, N, D), mask kind; "main" cases are the eval
        # step's launches: B=32 (phase 6) and the validation sweep's batches,
        # q/k/v strided views of one projection
        *[(f"main {kind} {B}x30x{Tk}{suffix}", (B, 30, Tk, 16, 64), mask)
          for B in (EVAL_BATCH, *VAL_BATCHES)
          for kind, Tk, suffix, mask in (
              ("self", 30, " causal+pad", "causal_pad"),
              ("cross", 49, "", "none"))],
        ("self 128x30x30 causal+pad", (128, 30, 30, 16, 64), "causal_pad"),
        ("cross 128x30x49", (128, 30, 49, 16, 64), "none"),
        ("cross 128x30x49 per-head", (128, 30, 49, 16, 64), "per_head"),
        ("gate 640x30x79x32", (640, 30, 79, 32, 64), "none"),
        ("gate 640x30x30 causal", (640, 30, 30, 16, 64), "causal"),
    ]
    worst = {}
    main_path_err = 0.0
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for i, (name, (B, Tq, Tk, N, D), kind) in enumerate(cases):
            main = name.startswith("main")
            q, k, v = attention_inputs(torch, B, Tq, Tk, N, D, dtype, device,
                                       SEED + i, packed=main)
            if kind == "causal_pad":
                mask = self_mask(torch, B, Tq, device, SEED + i)
            elif kind == "causal":
                mask = self_mask(torch, B, Tq, device, SEED,
                                 lengths=np.full(B, Tq))
            elif kind == "per_head":
                rng = np.random.RandomState(SEED + i)
                m = rng.rand(B, N, Tq, Tk) > 0.4
                m[..., 0] = True
                mask = torch.from_numpy(m).to(device)
            else:
                mask = None
            out = k1_out(torch, A, f"{name} {dtype_name}", q, k, v, mask)
            ref = A.attention_reference(q, k, v, mask)
            if out.shape != ref.shape or out.dtype != ref.dtype:
                fail(f"K1 {name} {dtype_name}: {out.shape} {out.dtype} vs "
                     f"{ref.shape} {ref.dtype}")
            err = rel_err(out, ref, ATOL)
            worst[f"{name} {dtype_name}"] = err
            if not err <= TOL[dtype_name]:
                fail(f"K1 {name} {dtype_name}: error {err:.3e} > "
                     f"{TOL[dtype_name]:.0e}")
            if dtype_name == "bfloat16" and main:
                main_path_err = max(main_path_err,
                                    float((out.float() - ref.float())
                                          .abs().max()))

    # Dropout: q = k = 0 makes P uniform, so with v = 1 the mean output is
    # the kept fraction over (1 − rate) (tests/tpu_attention_parity.py).
    rate = 0.1
    z = torch.zeros(8, 128, 8, 32, device=device)
    ones = torch.ones_like(z)

    def drop(seed):
        return A.fused_attention(z, z, ones, None, rate, seed)

    first, again, other = drop(42), drop(42), drop(43)
    keep = float(first.mean()) * (1.0 - rate)
    if not KEEP_RANGE[0] <= keep <= KEEP_RANGE[1]:
        fail(f"K1 dropout keep fraction {keep:.4f} outside {KEEP_RANGE}")
    if not torch.equal(first, again):
        fail("K1 dropout: the same seed gave another output")
    if torch.equal(first, other):
        fail("K1 dropout: another seed gave the same output")
    summary = ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
    return main_path_err, keep, summary


# -- phase 4 -----------------------------------------------------------------
def k2_grads(torch, A, q, k, v, mask, g, rate=0.0, seed=None):
    """dq, dk, dv through K1 and K2 (one K2 launch, checked, in the
    tensor-core variant exactly where the operands are bf16)."""
    want = tensor_core_wanted(torch, A, q, k)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    before = launched()
    A.fused_attention(q, k, v, mask, rate, seed).backward(g)
    torch.cuda.synchronize()
    ran = launched() - before
    if (ran[("k2", "mma")], ran[("k2", "scalar")]) != (int(want),
                                                      int(not want)):
        fail(f"K2: the attention backward did not launch K2's "
             f"{'tensor-core' if want else 'scalar'} variant once")
    return q.grad, k.grad, v.grad


def train_attention_inputs(torch, kind, dtype, device, seed):
    """The train step's attention at batch 128: q/k/v strided views of the
    packed projection, g ~ N(0, 1), and the mask."""
    Tk = 30 if kind == "self" else 49
    q, k, v = attention_inputs(torch, TRAIN_BATCH, 30, Tk, 16, 64, dtype,
                               device, seed, packed=True)
    g = attention_inputs(torch, TRAIN_BATCH, 30, 30, 16, 64, dtype, device,
                         seed + 1)[0]
    mask = self_mask(torch, TRAIN_BATCH, 30, device, seed) \
        if kind == "self" else None
    return q, k, v, g, mask


def check_k2(torch, A, device):
    """K2 against ``attention_backward_reference`` on the card, without and
    with dropout, and K1's and K2's keep masks against
    ``philox_keep_reference`` bit for bit. Returns the largest absolute
    bf16 gradient error at the train step's shapes and a summary."""
    worst, main_err = {}, 0.0
    rate, seed = 0.1, 1234
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for i, kind in enumerate(("self", "cross")):
            q, k, v, g, mask = train_attention_inputs(torch, kind, dtype,
                                                      device, SEED + 20 + i)
            keep = A.philox_keep_reference(seed, TRAIN_BATCH, 16, 30,
                                           k.shape[1], rate, device=device)
            for r, ref in ((0.0, A.attention_backward_reference(
                    q, k, v, mask, g)), (rate, A.attention_backward_reference(
                        q, k, v, mask, g, keep, rate))):
                ours = k2_grads(torch, A, q, k, v, mask, g, r,
                                seed if r else None)
                name = f"{kind} B{TRAIN_BATCH} {dtype_name} dropout {r}"
                for part, a, b in zip("qkv", ours, ref):
                    if a.shape != b.shape or not a.dtype == b.dtype == dtype:
                        fail(f"K2 {name} d{part}: {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
                    err = rel_err(a, b, ATOL)
                    worst[f"{name} d{part}"] = err
                    if not err <= TOL[dtype_name]:
                        fail(f"K2 {name} d{part}: error {err:.3e} > "
                             f"{TOL[dtype_name]:.0e}")
                    if dtype_name == "bfloat16" and r == 0.0:
                        main_err = max(main_err, float(
                            (a.float() - b.float()).abs().max()))

    keep = [check_keep_bits(torch, A, device, 16, rate, seed, dtype)
            for dtype in (torch.float32, torch.bfloat16)][-1]
    summary = ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
    return main_err, keep, summary


def check_keep_bits(torch, A, device, N, rate, seed, dtype,
                    B=TRAIN_BATCH, Tq=30, Tk=49, D=64):
    """K1's and K2's keep masks at (B, N heads, Tq, Tk), head size D
    (Tq, Tk <= D), against ``philox_keep_reference``, bit for bit, in
    ``dtype`` (fp32: the scalar variants; bf16: the tensor-core ones);
    returns the kept fraction.

    q = k = 0 makes P uniform. With v the identity over (key, d), K1's
    output row i is keep[i, :]/(Tk·(1 − rate)); with g the identity over
    (query, d), K2's dv[j, i] is keep[i, j]/(Tk·(1 − rate))."""
    want = A.philox_keep_reference(seed, B, N, Tq, Tk, rate, device=device)
    zq = torch.zeros(B, Tq, N, D, device=device, dtype=dtype)
    zk = torch.zeros(B, Tk, N, D, device=device, dtype=dtype)

    def eye(T):
        return torch.eye(T, D, device=device, dtype=dtype)[
            None, :, None, :].expand(B, T, N, D).contiguous()

    out = k1_out(torch, A, "keep mask", zq, zk, eye(Tk), None, rate, seed)
    if not torch.equal(out.permute(0, 2, 1, 3)[..., :Tk] > 0, want):
        fail(f"K1 dropout, {N} heads, {dtype}: the keep mask is not "
             "philox_keep_reference's")
    _, _, dv = k2_grads(torch, A, zq, zk, eye(Tk), None, eye(Tq), rate, seed)
    if not torch.equal(dv.permute(0, 2, 3, 1)[:, :, :Tq, :] > 0, want):
        fail(f"K2 dropout, {N} heads, {dtype}: the keep mask is not "
             "philox_keep_reference's")
    return float(want.float().mean())


# name: (B, Tq, Tk, N, D, mask kind); bf16, so the tensor-core variants
EDGE_CASES = {
    "Tq 1": (32, 1, 49, 16, 64, "none"),
    "Tk 1": (32, 30, 1, 16, 64, "none"),
    "fully masked query row": (32, 30, 30, 16, 64, "row_masked"),
    "D 32": (32, 30, 49, 16, 32, "per_head"),
    "D 128": (32, 30, 30, 8, 128, "causal_pad"),
    "unaligned strided q/k/v": (32, 30, 30, 16, 64, "causal_pad"),
}


def edge_case(torch, name, device, seed):
    """bf16 q, k, v, g and the mask of ``EDGE_CASES[name]``. The unaligned
    case takes q/k/v as views of a packed projection one element in, so
    that neither their base pointers nor their row strides are 16-byte
    aligned and the wrapper must copy them."""
    B, Tq, Tk, N, D, kind = EDGE_CASES[name]
    rng = np.random.RandomState(seed)
    draw = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.randn(*shape).astype(np.float32)).to(device, torch.bfloat16)
    if name.startswith("unaligned"):
        q, k, v = (t.view(B, Tq, N, D) for t in draw(
            B, Tq, 3 * N * D + 1)[..., 1:].split(N * D, dim=-1))
    else:
        q, k, v = draw(B, Tq, N, D), draw(B, Tk, N, D), draw(B, Tk, N, D)
    g = draw(B, Tq, N, D)
    if kind == "none":
        return q, k, v, g, None
    if kind == "per_head":
        return q, k, v, g, torch.from_numpy(rng.rand(B, N, Tq, Tk) > 0.4).to(
            device)
    mask = self_mask(torch, B, Tq, device, seed)
    if kind == "row_masked":
        mask = mask.clone()
        mask[:, :, 3, :] = False
    return q, k, v, g, mask


def check_edges(torch, A, device):
    """K1 and K2 against their plain versions at the edges of the
    tensor-core variants' tiling. Returns the largest absolute errors of
    K1 and K2 and a summary of the relative ones."""
    from virtex_tpu_torch.ops._launch import aligned_16
    worst, abs_err = {}, {"K1": 0.0, "K2": 0.0}
    tol = TOL["bfloat16"]
    for i, name in enumerate(EDGE_CASES):
        q, k, v, g, mask = edge_case(torch, name, device, SEED + 60 + i)
        if name.startswith("unaligned") and aligned_16(q):
            fail("the unaligned edge case is aligned")
        out = k1_out(torch, A, name, q, k, v, mask)
        pairs = [("out", out, A.attention_reference(q, k, v, mask))]
        pairs += list(zip(("dq", "dk", "dv"),
                          k2_grads(torch, A, q, k, v, mask, g),
                          A.attention_backward_reference(q, k, v, mask, g)))
        for part, got, ref in pairs:
            err = rel_err(got, ref, ATOL)
            worst[f"{name} {part}"] = err
            if got.shape != ref.shape or not err <= tol:
                fail(f"edge case {name} {part}: {tuple(got.shape)} vs "
                     f"{tuple(ref.shape)}, error {err:.3e} > {tol:.0e}")
            kernel = "K1" if part == "out" else "K2"
            abs_err[kernel] = max(abs_err[kernel], float(
                (got.float() - ref.float()).abs().max()))
    summary = ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
    return abs_err["K1"], abs_err["K2"], summary


def check_no_sync_dropout(torch, port, device):
    """One dropout forward and backward of ``MultiHeadAttention`` at the
    flagship's width (B 128, 16 heads, causal + pad mask) under
    ``torch.cuda.set_sync_debug_mode("error")``: the seed is drawn on the
    card and K1 and K2 read it there, so nothing is read back."""
    mha = port.MultiHeadAttention(1024, 16, dropout=0.1).to(device).train()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    x = torch.randn(TRAIN_BATCH, 30, 1024, device=device, generator=gen,
                    dtype=torch.bfloat16)
    mask = self_mask(torch, TRAIN_BATCH, 30, device, SEED)
    torch.cuda.synchronize()
    before = launched()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mha(x, x, mask, generator=gen).float().sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    ran = launched() - before
    if (ran[("k1", "mma")], ran[("k2", "mma")]) != (1, 1):
        fail("MultiHeadAttention with dropout did not launch the "
             "tensor-core K1 and K2 once each")
    grad = mha.in_proj_weight.grad
    if grad is None or not bool(torch.isfinite(grad).all()):
        fail("MultiHeadAttention with dropout: no finite gradient")


# -- phase 5 -----------------------------------------------------------------
def bn_inputs(torch, B, hw, C, device, gen, dy_layout="channels_last",
              dy_dtype=None, x_dtype=None):
    """x ~ 2·N(0, 1) + 0.5 and dy ~ N(0, 1), bf16 unless given, as NCHW
    views of NHWC memory (dy NCHW-contiguous if asked), with x's fp32 mean
    and rstd."""
    def draw():
        return torch.randn(B, hw, hw, C, generator=gen, device=device)
    x = draw().mul_(2.0).add_(0.5).to(x_dtype or torch.bfloat16).permute(
        0, 3, 1, 2)
    dy = draw().to(dy_dtype or torch.bfloat16).permute(0, 3, 1, 2)
    if dy_layout == "nchw":
        dy = dy.contiguous()
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    var = (xf.square().mean((0, 2, 3)) - mean.square()).clamp_(min=0.0)
    return dy, x, mean, 1.0 / torch.sqrt(var + 1e-5)


# name: (B, H = W, C, dy's layout, dy's dtype, x's dtype). The 12 shapes
# of the train step, then the edges: an NCHW-contiguous dy, an odd M, a C
# the 8-wide bf16 vectors do not divide (the scalar variants), and the
# fp32 and mixed-dtype instantiations.
K4_CASES = [(f"{hw}x{hw}x{C}", TRAIN_BATCH, hw, C, "channels_last",
             "bfloat16", "bfloat16") for hw, C in R50_BN_SHAPES] + [
    ("28x28x512 NCHW dy", TRAIN_BATCH, 28, 512, "nchw", "bfloat16",
     "bfloat16"),
    ("odd M 3x7x7x2048", 3, 7, 2048, "channels_last", "bfloat16",
     "bfloat16"),
    ("scalar variant 3x7x7x60", 3, 7, 60, "channels_last", "bfloat16",
     "bfloat16"),
    ("fp32 32x56x56x64", 32, 56, 64, "channels_last", "float32", "float32"),
    ("bf16 dy fp32 x 32x56x56x64", 32, 56, 64, "channels_last", "bfloat16",
     "float32"),
    ("fp32 dy bf16 x 32x56x56x64", 32, 56, 64, "channels_last", "float32",
     "bfloat16"),
] + [(f"B{FINETUNE_BATCH} {hw}x{hw}x{C}", FINETUNE_BATCH, hw, C,
      "channels_last", "bfloat16", "bfloat16")
     for hw, C in FINETUNE_K4_SHAPES]


def bn_counts():
    return vector_counts("k4_sums", "k4_dx")


def check_k4(torch, BN, device, cases=K4_CASES, m_total=True,
             main_batches=(TRAIN_BATCH, FINETUNE_BATCH)):
    """K4's stage 1 against ``bn_backward_sums_reference`` and its stage 2
    against ``bn_backward_dx_reference`` (both fed the plain sums) on the
    card, at ``cases``; each stage launched twice must give equal bits, in
    the variant ``k4_vector_width`` names; with ``m_total``, stage 2 with
    the count of two ranks. Returns the largest absolute errors of the
    sums and of dx at the model shapes (batches ``main_batches``), and a
    summary."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    worst, sums_err, dx_err = {}, 0.0, 0.0
    for name, B, hw, C, layout, dy_name, x_name in cases:
        dy, x, mean, rstd = bn_inputs(torch, B, hw, C, device, gen, layout,
                                      getattr(torch, dy_name),
                                      getattr(torch, x_name))
        weight = torch.rand(C, generator=gen, device=device) + 0.5
        wide = torch.float32 if "float32" in (dy_name, x_name) \
            else torch.bfloat16
        vector = BN.k4_vector_width(wide, C, True) > 1
        if vector == name.startswith("scalar"):
            fail(f"K4 {name}: k4_vector_width gives the "
                 f"{'vector' if vector else 'scalar'} variant")
        before = bn_counts()
        out = BN.bn_backward_sums(dy, x, mean, rstd)
        again = BN.bn_backward_sums(dy, x, mean, rstd)
        ref = BN.bn_backward_sums_reference(dy, x, mean, rstd)
        dx = BN.bn_backward_dx(dy, x, mean, rstd, weight, ref)
        dx_again = BN.bn_backward_dx(dy, x, mean, rstd, weight, ref)
        dx_ref = BN.bn_backward_dx_reference(dy, x, mean, rstd, weight, ref)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(bn_counts(), before))
        if launched != (2, 2 * vector, 2, 2 * vector):
            fail(f"K4 {name}: (stage 1, vector, dx, vector) launches "
                 f"{launched}, expected two of each stage in the "
                 f"{'vector' if vector else 'scalar'} variant")
        if not torch.equal(out, again) or not torch.equal(dx, dx_again):
            fail(f"K4 {name}: two launches gave different bits")
        M = B * hw * hw
        err = rel_err(out, ref, M ** 0.5)
        dx_tol = DX_TOL[x_name]
        err_dx = rel_err(dx, dx_ref, 1.0)
        worst[name] = (err, err_dx)
        if out.shape != (2, C) or not err <= K4_TOL:
            fail(f"K4 {name}: {tuple(out.shape)}, error {err:.3e} > "
                 f"{K4_TOL:.0e}")
        if dx.shape != x.shape or dx.dtype != x.dtype or not err_dx <= dx_tol:
            fail(f"K4 dx {name}: {tuple(dx.shape)} {dx.dtype}, error "
                 f"{err_dx:.3e} > {dx_tol:.0e}")
        if layout == "nchw":
            cl = dy.contiguous(memory_format=torch.channels_last)
            if not torch.equal(out, BN.bn_backward_sums(cl, x, mean, rstd)):
                fail("K4: an NCHW dy and its channels_last copy differ")
            if not torch.equal(dx, BN.bn_backward_dx(cl, x, mean, rstd,
                                                     weight, ref)):
                fail("K4 dx: an NCHW dy and its channels_last copy differ")
        elif B in main_batches:
            sums_err = max(sums_err, float((out - ref).abs().max()))
            dx_err = max(dx_err, float((dx.float() - dx_ref.float()).abs()
                                       .max()))
    # Stage 2 under data parallelism: sums reduced over DP_WORLD ranks and
    # m_total their count (here the local sums doubled, as two ranks
    # holding the same shard would give). dy has a mean and a part along
    # x̂, so that dβ/M and dγ/M are O(1) and a wrong count shows.
    for hw, C in FINETUNE_K4_SHAPES if m_total else ():
        dy, x, mean, rstd = bn_inputs(torch, TRAIN_BATCH, hw, C, device, gen)
        xhat = (x.float() - mean[:, None, None]) * rstd[:, None, None]
        dy = (dy.float() + 1.0 + 0.5 * xhat).to(torch.bfloat16)
        weight = torch.rand(C, generator=gen, device=device) + 0.5
        total = 2.0 * BN.bn_backward_sums_reference(dy, x, mean, rstd)
        M = TRAIN_BATCH * hw * hw
        before = bn_counts()
        dx = BN.bn_backward_dx(dy, x, mean, rstd, weight, total,
                               m_total=DP_WORLD * M)
        dx_ref = BN.bn_backward_dx_reference(dy, x, mean, rstd, weight,
                                             total, m_total=DP_WORLD * M)
        local = BN.bn_backward_dx_reference(dy, x, mean, rstd, weight, total)
        torch.cuda.synchronize()
        launched = tuple(a - b for a, b in zip(bn_counts(), before))
        err_dx = rel_err(dx, dx_ref, 1.0)
        name = f"m_total 2M {hw}x{hw}x{C}"
        worst[name] = (0.0, err_dx)
        if launched != (0, 0, 1, 1) or not err_dx <= DX_TOL["bfloat16"]:
            fail(f"K4 dx {name}: launches {launched}, error {err_dx:.3e} > "
                 f"{DX_TOL['bfloat16']:.1e}")
        if rel_err(dx, local, 1.0) <= DX_TOL["bfloat16"]:
            fail(f"K4 dx {name}: m_total changed nothing")
        dx_err = max(dx_err, float((dx.float() - dx_ref.float()).abs().max()))
    summary = ", ".join(f"{k} {v[0]:.2e}/{v[1]:.2e}"
                        for k, v in worst.items())
    return sums_err, dx_err, summary


def check_bn_forward(torch, BN, device, batch=TRAIN_BATCH,
                     shapes=R50_BN_SHAPES):
    """The BatchNorm forward's kernels against their plain versions on the
    card, bf16 x (NCHW views of NHWC memory, ~2·N(0, 1) + 0.5) at
    ``batch`` and ``shapes`` (the flagship's): the statistics (E[x], E[x²],
    var, rstd) within FWD_STATS_TOL of ``bn_forward_stats_reference``; the
    running statistics, updated in the same launch, bit-equal to
    ``update_running_reference`` of the kernel's own mean and var; the
    apply bit-equal to ``bn_apply_reference`` on the kernel's statistics
    (train mode) and on the updated running statistics (eval mode); the
    statistics and the apply launched twice for equal bits, all in the
    vector variants. Returns the largest absolute errors of the statistics
    and of the apply (0 where bit-equal), and a summary."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 7)
    worst, stats_err, apply_err = {}, 0.0, 0.0
    for hw, C in shapes:
        M = batch * hw * hw
        x = (torch.randn(batch, hw, hw, C, generator=gen, device=device)
             * 2.0 + 0.5).to(torch.bfloat16).permute(0, 3, 1, 2)
        weight = torch.rand(C, generator=gen, device=device) + 0.5
        bias = torch.randn(C, generator=gen, device=device) * 0.1
        running = BN.Running(
            torch.randn(C, generator=gen, device=device) * 0.3,
            torch.rand(C, generator=gen, device=device) + 0.5,
            torch.zeros((), dtype=torch.int64, device=device), 0.9, M)
        want = BN.Running(running.mean.clone(), running.var.clone(),
                          running.count.clone(), 0.9, M)
        before = fwd_counts()
        stats = BN.bn_forward_stats(x, BN_EPS, running)
        again = BN.bn_forward_stats(x, BN_EPS)
        ref = BN.bn_forward_stats_reference(x, BN_EPS)
        BN.update_running_reference(want, stats[0], stats[2])
        eval_rstd = 1.0 / torch.sqrt(want.var + BN_EPS)
        with torch.no_grad():
            y = BN.bn_apply(x, stats[0], stats[3], weight, bias,
                            torch.bfloat16)
            y_again = BN.bn_apply(x, stats[0], stats[3], weight, bias,
                                  torch.bfloat16)
            y_eval = BN.bn_apply(x, want.mean, eval_rstd, weight, bias,
                                 torch.bfloat16)
        y_ref = BN.bn_apply_reference(x, stats[0], stats[3], weight, bias,
                                      torch.bfloat16)
        y_eval_ref = BN.bn_apply_reference(x, want.mean, eval_rstd, weight,
                                           bias, torch.bfloat16)
        torch.cuda.synchronize()
        name = f"{hw}x{hw}x{C}"
        launched = tuple(a - b for a, b in zip(fwd_counts(), before))
        if launched != (2, 2, 3, 3):
            fail(f"BatchNorm forward {name}: (statistics, vector, apply, "
                 f"vector) launches {launched}, expected (2, 2, 3, 3)")
        if not torch.equal(stats, again) or not torch.equal(y, y_again):
            fail(f"BatchNorm forward {name}: two launches gave different "
                 "bits")
        if not (torch.equal(running.mean, want.mean)
                and torch.equal(running.var, want.var)
                and int(running.count) == 1):
            fail(f"BatchNorm forward {name}: the running statistics differ "
                 "from update_running_reference's")
        err = rel_err(stats, ref, 1.0)
        worst[name] = err
        if stats.shape != (4, C) or not err <= FWD_STATS_TOL:
            fail(f"BatchNorm forward statistics {name}: "
                 f"{tuple(stats.shape)}, error {err:.3e} > "
                 f"{FWD_STATS_TOL:.0e}")
        stats_err = max(stats_err, float((stats - ref).abs().max()))
        apply_err = max(apply_err, float((y.float() - y_ref.float()).abs()
                                         .max()),
                        float((y_eval.float() - y_eval_ref.float()).abs()
                              .max()))
        if not torch.equal(y, y_ref) or not torch.equal(y_eval, y_eval_ref):
            fail(f"BatchNorm forward apply {name}: not bit-equal to the "
                 f"torch ops (max abs error {apply_err:.3e})")
        del x, y, y_again, y_eval, y_ref, y_eval_ref
    summary = ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
    return stats_err, apply_err, summary


# -- phases 6 and 7 ----------------------------------------------------------
def randomize_(torch, model, seed: int) -> None:
    """Redraw every floating parameter and buffer from a numpy seed,
    keeping each tensor's init mean and spread (std 0.1 where the init is a
    constant: BN and LayerNorm scales and biases, BN statistics, the output
    bias). Tied tensors are drawn once."""
    rng = np.random.RandomState(seed)
    seen = set()
    with torch.no_grad():
        for _, t in sorted(model.state_dict(keep_vars=True).items()):
            if not t.is_floating_point() or t.data_ptr() in seen:
                continue
            seen.add(t.data_ptr())
            mean = float(t.mean())
            std = float(t.std()) if t.numel() > 1 else 0.0
            z = rng.standard_normal(tuple(t.shape)).astype(np.float32)
            t.copy_(torch.from_numpy(mean + (std or 0.1) * z))


def card_randomize_(torch, model, seed: int) -> None:
    """``randomize_``'s rule, each tensor's draws from a generator on
    ``DEVICE`` seeded with ``seed``: as quick as the card, and the same
    bits in every process on one card. Phases 21 and 22 draw with it; the
    earlier phases keep ``randomize_``'s numpy draws, on which phase 12's
    gate was set."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    seen = set()
    with torch.no_grad():
        for _, t in sorted(model.state_dict(keep_vars=True).items()):
            if not t.is_floating_point() or t.data_ptr() in seen:
                continue
            seen.add(t.data_ptr())
            mean = float(t.mean())
            std = float(t.std()) if t.numel() > 1 else 0.0
            z = torch.randn(tuple(t.shape), generator=gen, device=DEVICE)
            t.copy_(mean + (std or 0.1) * z)


def caption_batch(torch, B, image_size, T, vocab, seed, device):
    """``__graft_entry__._synthetic_batch`` with captions of varied length
    ([SOS] words [EOS], padded with 0; ``noitpac_tokens`` reversed)."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(5, T + 1, B).astype(np.int32)
    lengths[0] = T
    tokens = np.zeros((B, T), np.int32)
    noitpac = np.zeros_like(tokens)
    for i, n in enumerate(lengths):
        row = np.concatenate([[1], rng.randint(4, vocab, n - 2), [2]])
        tokens[i, :n] = row
        noitpac[i, :n] = row[::-1]
    image = rng.rand(B, image_size, image_size, 3).astype(np.float32)
    batch = {"image": image, "caption_tokens": tokens,
             "noitpac_tokens": noitpac, "caption_lengths": lengths}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def plain_bn(m, BN) -> None:
    """Point a SubsampledBatchNorm's forward (statistics, with the running
    statistics' update, and apply) and backward (sums and dx) at the plain
    versions."""
    m.stats_fn = BN.bn_forward_stats_reference
    m.apply_fn = BN.bn_apply_reference
    m.sums_fn = BN.bn_backward_sums_reference
    m.dx_fn = BN.bn_backward_dx_reference


def plain_copy(model, A, BN, MultiHeadAttention, SubsampledBatchNorm):
    """A copy of ``model`` whose attention (forward and, through autograd,
    backward; and the decode path's) and BatchNorm (forward and backward)
    call the plain versions."""
    from virtex_tpu_torch.ops.decode_attention import (
        decode_attention_reference,
    )
    twin = copy.deepcopy(model)
    for m in twin.modules():
        if isinstance(m, MultiHeadAttention):
            m.attention_fn = A.attention_reference
            m.decode_attention_fn = decode_attention_reference
        elif isinstance(m, SubsampledBatchNorm):
            plain_bn(m, BN)
    return twin


# -- phase 7 -----------------------------------------------------------------
# The decode attention at the caption cell's shapes (the benchmark's
# caption.r50h2048.beam): 256 images x 5 beams, 64 dims a head, cross to
# the 49 visual tokens of 224², self over a 30-position cache; at 32 heads
# (H2048) and 16 (the flagship's H1024). Held to its plain version per
# element at TOL["bfloat16"] and ATOL, as K1 is: both read the bf16 operands
# exactly and sum in fp32 in other orders, and a probability or an output
# whose bf16 rounding falls the other way moves by 2^-8.
DECODE_IMAGES, DECODE_BEAMS = 256, 5
DECODE_TOKENS, DECODE_POSITIONS = 49, 30
DECODE_HEADS = (32, 16)


def decode_out(torch, DA, q, k, v, n_valid, rows_per_kv):
    """The op on the card, checked to launch its kernel once and to give
    equal bits twice."""
    before = launched()
    out = DA.decode_attention(q, k, v, n_valid, rows_per_kv)
    again = DA.decode_attention(q, k, v, n_valid, rows_per_kv)
    torch.cuda.synchronize()
    if launched() - before != {DA.KEY: 2} or not torch.equal(out, again):
        fail(f"decode attention {tuple(q.shape)} x {tuple(k.shape)}, n_valid "
             f"{n_valid}: not one launch a call, or other bits the second "
             "time")
    return out


def decode_error(torch, DA, q, k, v, n_valid, rows_per_kv=1) -> float:
    got = decode_out(torch, DA, q, k, v, n_valid, rows_per_kv)
    err = rel_err(got, DA.decode_attention_reference(q, k, v, n_valid,
                                                     rows_per_kv), ATOL)
    if not err <= TOL["bfloat16"]:
        fail(f"decode attention {tuple(q.shape)} x {tuple(k.shape)}, n_valid "
             f"{n_valid}: {err:.2e} > {TOL['bfloat16']} of the plain version")
    return err


def decode_inputs(torch, heads, device, seed):
    """q (1280, 1, N, 64), the cross K/V (256, 49, N, 64) and the self cache
    (1280, 30, N, 64), bf16 ~ N(0, 1)."""
    rows = DECODE_IMAGES * DECODE_BEAMS
    rng = np.random.RandomState(seed)
    draw = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.randn(*shape).astype(np.float32)).to(device, torch.bfloat16)
    return (draw(rows, 1, heads, 64),
            [draw(DECODE_IMAGES, DECODE_TOKENS, heads, 64) for _ in "kv"],
            [draw(rows, DECODE_POSITIONS, heads, 64) for _ in "kv"])


def check_decode_attention(torch, DA, device) -> float:
    """Phase 7: the kernel against its plain version; the largest error."""
    errs = []
    for heads in DECODE_HEADS:
        q, (ck, cv), (k, v) = decode_inputs(torch, heads, device, SEED)
        errs.append(decode_error(torch, DA, q, ck, cv, DECODE_TOKENS,
                               DECODE_BEAMS))
        for n_valid in range(1, DECODE_POSITIONS + 1):
            errs.append(decode_error(torch, DA, q, k, v, n_valid))
        half = DECODE_POSITIONS // 2
        kn, vn = k.clone(), v.clone()
        kn[:, half:], vn[:, half:] = float("nan"), float("nan")
        if not torch.equal(decode_out(torch, DA, q, kn, vn, half, 1),
                           decode_out(torch, DA, q, k, v, half, 1)):
            fail("decode attention: positions past n_valid moved the output")
    return max(errs)


def teacher_forced(torch, model, images, tokens, beams, sos):
    """Log-probabilities of ``tokens`` (B·beams, T) fed to the decode step
    one position at a time from the start token, each image's cross K/V
    held once for its beams, as the caption loop holds them."""
    with torch.inference_mode():
        caches = model.init_decode(model.encode_visual(images),
                                   tokens.shape[1])
        caches = [{"k": c["k"].repeat_interleave(beams, dim=0),
                   "v": c["v"].repeat_interleave(beams, dim=0),
                   "ck": c["ck"], "cv": c["cv"]} for c in caches]
        prev = torch.full((tokens.shape[0],), sos, dtype=torch.long,
                          device=tokens.device)
        out = []
        for t in range(tokens.shape[1]):
            logits, caches = model.decode_step(prev, t, caches)
            out.append(torch.log_softmax(logits.float(), dim=-1).gather(
                1, tokens[:, t:t + 1]))
            prev = tokens[:, t]
        return torch.cat(out, dim=1)


def check_decode_model(torch, model, plain_model, images, captions, beams,
                       sos):
    """The flagship's decode along the captions, beam b of image i fed the
    captions of image i + b: the decode attention model against the plain
    one, the mean log-probability within LOSS_RTOL (the models differ only
    in where bf16 attention outputs round). Returns both means and the
    largest gap of one token."""
    B = captions.shape[0]
    rows = torch.arange(B, device=captions.device)
    tokens = torch.stack([captions[(rows + b) % B] for b in range(beams)],
                         dim=1).reshape(B * beams, -1)
    got = teacher_forced(torch, model, images, tokens, beams, sos)
    want = teacher_forced(torch, plain_model, images, tokens, beams, sos)
    mean, ref = float(got.mean()), float(want.mean())
    if not abs(mean - ref) <= LOSS_RTOL * abs(ref):
        fail(f"teacher-forced decode: mean log-probability {mean:.5f} with "
             f"the decode attention kernel, {ref:.5f} plain")
    return mean, ref, float((got - want).abs().max())


def decode_sdpa_call(torch, q, k, v, n_valid, rows_per_kv):
    """The decode attention's library call: one
    ``scaled_dot_product_attention`` pinned to SDPA_BACKEND on (B, N, T, D)
    views, an image's beams as its query rows."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    rows, _, N, D = k.shape
    qt = q.view(rows, rows_per_kv, N, D).transpose(1, 2)
    kt, vt = (t[:, :n_valid].transpose(1, 2) for t in (k, v))

    def call():
        with sdpa_kernel(getattr(SDPBackend, SDPA_BACKEND)):
            return F.scaled_dot_product_attention(qt, kt, vt)
    return call


def time_decode_attention(torch, DA, device) -> dict:
    """Device ms per call at 32 heads, cross and self at 30 and 15 valid
    positions: {case: (kernel, plain, library, bound ms, bound_by)}; the
    kernel and the library call by CUDA-graph replay in turns (library,
    kernel, kernel, library), the plain version, milliseconds a call, by
    back-to-back calls."""
    q, (ck, cv), (k, v) = decode_inputs(torch, DECODE_HEADS[0], device,
                                        SEED + 1)
    out = {}
    for name, kk, vv, n, per in (
            ("cross", ck, cv, DECODE_TOKENS, DECODE_BEAMS),
            ("self 30", k, v, DECODE_POSITIONS, 1),
            ("self 15", k, v, DECODE_POSITIONS // 2, 1)):
        R, _, N, D = q.shape
        kernel = lambda: DA.decode_attention(q, kk, vv, n, per)  # noqa: E731
        library = decode_sdpa_call(torch, q, kk, vv, n, per)
        l1, k1, k2, l2 = (graph_ms(torch, f, 20, 5)
                          for f in (library, kernel, kernel, library))
        plain = cuda_ms(torch, lambda: DA.decode_attention_reference(
            q, kk, vv, n, per), 10)
        moved = 2 * nbytes(q) + 2 * kk.shape[0] * n * N * D * 2
        out[name] = ((k1 + k2) / 2, plain, (l1 + l2) / 2) + bound(
            moved, 4 * R * N * n * D)
    return out


# Beam select at the caption cell's shapes: 256 images x 5 beams over the
# 10,000-token vocabulary, 2 kept a beam; step 0's mode keeps 5 of each
# image's first row. Held to its plain version on the CPU bit for bit (the
# scores, tokens and source rows), which orders −0.0 and +0.0 as equal.
SELECT_IMAGES, SELECT_BEAMS, SELECT_VOCAB, SELECT_PER_NODE = 256, 5, 10000, 2
SELECT_EOS = 2


def select_inputs(torch, seed, finished=0.2, adversarial=False):
    """log-probs (1280, 10000) fp32, the log_softmax of 3·N(0, 1) rows; the
    beams' last tokens, ``finished`` of them EOS; scores (256, 5). The
    adversarial rows: values rounded to halves (many equal maxima), ±0
    beside each other, rows of −inf, and scores of ±0."""
    g = torch.Generator().manual_seed(seed)
    R = SELECT_IMAGES * SELECT_BEAMS
    x = torch.log_softmax(torch.randn(R, SELECT_VOCAB, generator=g) * 3, -1)
    last = torch.randint(0, SELECT_VOCAB, (R,), generator=g)
    last[torch.rand(R, generator=g) < finished] = SELECT_EOS
    scores = -torch.rand(SELECT_IMAGES, SELECT_BEAMS, generator=g) * 20
    if adversarial:
        x = torch.round(x * 2) / 2
        x[:, ::13], x[:, 5::29] = -0.0, 0.0
        x[::7] = -float("inf")
        scores[::3] = -0.0
        scores[1::3] = 0.0
    return x, last, scores


def same_bits(torch, got, want) -> bool:
    return all(g.shape == w.shape and g.dtype == w.dtype and torch.equal(
        *(t.view(torch.int32) if t.dtype == torch.float32 else t
          for t in (g.cpu(), w.cpu()))) for g, w in zip(got, want))


def select_out(torch, BS, fn, *args):
    """The op on the card, checked to launch its kernel once a call and to
    give equal bits twice."""
    before = launched()
    out, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    if launched() - before != {BS.KEY: 2} or not same_bits(torch, out, again):
        fail(f"beam select {fn.__name__}: not one launch a call, or other "
             "bits the second time")
    return out


def check_beam_select(torch, BS, device) -> str:
    """Phase 7: the kernel against its plain version on the CPU, in the
    search's loop and step-0 modes."""
    done = []
    for name, adversarial in (("drawn", False), ("ties, ±0, -inf", True)):
        x, last, scores = select_inputs(torch, SEED + len(done),
                                        adversarial=adversarial)
        args = (SELECT_EOS, SELECT_PER_NODE)
        got = select_out(torch, BS, BS.beam_select, x.to(device),
                         last.to(device), scores.to(device), *args)
        if not same_bits(torch, got, BS.beam_select(x, last, scores, *args)):
            fail(f"beam select ({name} rows): the kernel's scores, tokens or "
                 "source rows differ from the plain version's")
        got = select_out(torch, BS, BS.beam_select_first, x.to(device),
                         SELECT_BEAMS, SELECT_BEAMS)
        if not same_bits(torch, got, BS.beam_select_first(
                x, SELECT_BEAMS, SELECT_BEAMS)):
            fail(f"beam select at step 0 ({name} rows): the kernel's values "
                 "or tokens differ from the plain version's")
        done.append(name)
    return "; ".join(done)


def time_beam_select(torch, BS, device) -> dict:
    """Device ms per call, in the loop and at step 0: {case: (kernel,
    plain, library, bound ms, bound_by)}. Three input sets in turn (153.6
    MB, past the 50 MB L2), no beam finished (every row read); the kernel
    and the library call (``torch.topk`` per beam, then per image) by
    CUDA-graph replay in turns (library, kernel, kernel, library), the
    plain version by back-to-back calls."""
    sets = [tuple(t.to(device) for t in select_inputs(torch, SEED + 5 + i,
                                                      finished=0.0))
            for i in range(3)]
    B, K, P = SELECT_IMAGES, SELECT_BEAMS, SELECT_PER_NODE

    def library(x, last, scores):
        values, _ = torch.topk(x, P, dim=-1)
        return torch.topk((scores.reshape(B * K, 1) + values).reshape(
            B, K * P), K, dim=-1)

    def library_first(x, last, scores):
        return torch.topk(x.view(B, K, -1)[:, 0], K, dim=-1)

    out = {}
    for name, kernel, plain, lib, rows in (
            ("in-loop", lambda x, last, scores: BS.beam_select(
                x, last, scores, SELECT_EOS, P),
             lambda x, last, scores: BS.beam_select_reference(
                 x, last, scores, SELECT_EOS, P), library, B * K),
            ("step 0", lambda x, last, scores: BS.beam_select_first(x, K, K),
             lambda x, last, scores: BS.beam_select_first_reference(x, K, K),
             library_first, B)):
        l1, k1, k2, l2 = (graph_ms(torch, rotating(f, sets), 30, 5)
                          for f in (lib, kernel, kernel, lib))
        p = cuda_ms(torch, rotating(plain, sets), 6)
        out[name] = ((k1 + k2) / 2, p, (l1 + l2) / 2) + bound(
            rows * SELECT_VOCAB * 4, 0)
    return out


# -- phase 8 -----------------------------------------------------------------
# The launches on every main path of this process by (kernel, variant)
# (read by checked_counts, summed over the run), for the kernels line.
MAIN_PATH_LAUNCHES = collections.Counter()
_seen = collections.Counter()  # the count at the last reading


def launched():
    """The port's launches since ``reset_counts`` by (kernel, variant), as
    its launch seam counts them (``virtex_tpu_torch/ops/_launch.py``)."""
    from virtex_tpu_torch.ops import _launch
    return _launch.snapshot()


def total(counts, kernel: str) -> int:
    """``kernel``'s launches in ``counts``, every variant."""
    return sum(n for (name, _), n in counts.items() if name == kernel)


def vector_counts(*kernels) -> tuple:
    """Each kernel's launches since ``reset_counts`` and, of those, its
    vector variant's."""
    counts, out = launched(), []
    for kernel in kernels:
        out += [total(counts, kernel), counts[(kernel, "vector")]]
    return tuple(out)


def fwd_counts():
    return vector_counts("bn_stats", "bn_apply")


def raw_counts() -> dict:
    """The launches since ``reset_counts``, whatever their variants."""
    counts = launched()
    return {"K1": total(counts, "k1"), "K2": total(counts, "k2"),
            "K4": total(counts, "k4_sums"), "K4dx": total(counts, "k4_dx")}


def checked_counts() -> dict:
    """The launches since ``reset_counts``. Every main path here runs in
    bf16, so none may have taken a scalar variant: each K1 and K2 launch
    the tensor-core one, and each of K4's (stage 1 and dx) and of the
    BatchNorm forward's (statistics and apply) the vector one. The
    launches since the last reading join MAIN_PATH_LAUNCHES."""
    counts = launched()
    scalar = {key: n for key, n in counts.items() if key[1] == "scalar"}
    if scalar:
        fail(f"launches of a bf16 main path took the scalar variant: "
             f"{scalar}")
    MAIN_PATH_LAUNCHES.update(counts - _seen)
    _seen.clear()
    _seen.update(counts)
    return raw_counts()


def reset_counts() -> None:
    from virtex_tpu_torch.ops import _launch
    _launch.reset()
    _seen.clear()


def train_batch(torch, spec, device, seed):
    """(ACCUM, TRAIN_BATCH, ...) leaves: micro-batches of captions of varied
    length, the JAX package's accumulation layout."""
    flat = caption_batch(torch, ACCUM * TRAIN_BATCH, spec.image_size,
                         spec.max_caption_length, spec.vocab_size, seed,
                         device)
    return {k: v.reshape((ACCUM, TRAIN_BATCH) + v.shape[1:])
            for k, v in flat.items()}


def bn_shape_counts(model, SubsampledBatchNorm):
    """Record every BatchNorm input shape of the next forward: returns the
    {shape: calls} dict it fills and a function that removes the hooks."""
    counts = {}

    def hook(module, inputs):
        shape = tuple(inputs[0].shape)
        counts[shape] = counts.get(shape, 0) + 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, SubsampledBatchNorm)]
    return counts, lambda: [h.remove() for h in handles]


# -- phase 9 -----------------------------------------------------------------
def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, calls: int = 50, replays: int = 10) -> float:
    """Device time per call of ``fn``: ``calls`` back-to-back calls are
    captured in a CUDA graph and replayed, so the host's work between
    launches (which ``cuda_ms`` includes where it exceeds the kernel's
    time) is not timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def host_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean wall time of ``fn`` ending in a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(bytes_moved: float, flops: float, flop_rate: float = BF16_FLOPS):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of moving ``bytes_moved`` at HBM rate and doing ``flops`` at
    ``flop_rate``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_bound(q, k, mask, backward):
    """K1's (or K2's) bound: q, k, v (and g) read once, the output (or
    dq, dk, dv) written once, the mask read once; 2 (or 5) products of
    2·B·N·Tq·Tk·D FLOPs in bf16."""
    B, Tq, N, D = q.shape
    Tk = k.shape[1]
    qb, kb = nbytes(q), nbytes(k)
    moved = (2 * qb + 2 * kb + 2 * kb + qb if backward
             else qb + 2 * kb + qb) + nbytes(mask)
    return bound(moved, 2 * (5 if backward else 2) * B * N * Tq * Tk * D)


def time_turns(torch, kernel, plain, library, calls=50, replays=10):
    """Device ms per call of a kernel's wrapper, its plain version and its
    library call, by CUDA-graph replay in turns (plain, library, kernel,
    kernel, library, plain). Returns (kernel, plain, library)."""
    p1, l1, k1, k2, l2, p2 = (graph_ms(torch, f, calls, replays) for f in (
        plain, library, kernel, kernel, library, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2, (l1 + l2) / 2


def sdpa_call(torch, q, k, v, mask):
    """K1's library call: one ``scaled_dot_product_attention`` on (B, N, T,
    D) views of the same operands, with the same bool mask, pinned to
    SDPA_BACKEND."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def call():
        with sdpa_kernel(getattr(SDPBackend, SDPA_BACKEND)):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    return call


def sdpa_backward_call(torch, q, k, v, g, mask):
    """K2's library call: the backward op of SDPA's memory-efficient
    backend, on the outputs its forward saves, with the bool mask turned
    into the additive bias that SDPA makes of it (-inf where False, the key
    dimension padded to 16 for alignment)."""
    aten = torch.ops.aten
    qt, kt, vt, gt = (t.transpose(1, 2) for t in (q, k, v, g))
    B, N, Tq, _ = qt.shape
    Tk = kt.shape[2]
    bias = None
    if mask is not None:
        full = torch.zeros(*mask.shape[:3], -(-Tk // 16) * 16,
                           dtype=q.dtype, device=q.device)
        full[..., :Tk].masked_fill_(~mask, float("-inf"))
        bias = full[..., :Tk].expand(B, N, Tq, Tk)
    out, lse, seed, offset = aten._scaled_dot_product_efficient_attention(
        qt, kt, vt, bias, True)

    def call():
        return aten._scaled_dot_product_efficient_attention_backward(
            gt, qt, kt, vt, bias, out, lse, seed, offset, 0.0,
            [True, True, True, False])
    return call


def time_attention(torch, A, q, k, v, g, mask):
    """K1, and K2 if ``g`` is not None, at one shape, bf16: {"K1"|"K2":
    (kernel ms, plain ms, library ms, bound ms, bound_by)}, device time per
    call in turns."""
    k1 = time_turns(torch, lambda: A.fused_attention(q, k, v, mask),
                    lambda: A.attention_reference(q, k, v, mask),
                    sdpa_call(torch, q, k, v, mask))
    if g is None:
        return {"K1": k1 + attention_bound(q, k, mask, False)}
    k2 = time_turns(torch, lambda: A._launch_bwd(q, k, v, mask, g, 0.0, None),
                    lambda: A.attention_backward_reference(q, k, v, mask, g),
                    sdpa_backward_call(torch, q, k, v, g, mask))
    return {"K1": k1 + attention_bound(q, k, mask, False),
            "K2": k2 + attention_bound(q, k, mask, True)}


def time_k1_eager(torch, A, q, k, v, mask):
    """K1 and the plain version by back-to-back eager calls, which include
    the host's launch work: (K1 ms, plain ms)."""
    kernel = lambda: A.fused_attention(q, k, v, mask)  # noqa: E731
    plain = lambda: A.attention_reference(q, k, v, mask)  # noqa: E731
    e1, e2, e3, e4 = (cuda_ms(torch, f, 200)
                      for f in (plain, kernel, kernel, plain))
    return (e2 + e3) / 2, (e1 + e4) / 2


def rotating(fn, sets):
    """A call of ``fn`` on each of ``sets`` in turn, one per call."""
    turn = itertools.cycle(sets)
    return lambda: fn(*next(turn))


def time_bn(torch, BN, device, batch=TRAIN_BATCH, shapes=R50_BN_SHAPES):
    """K4's stage 1, its stage 2 (dx) and the whole BatchNorm backward (the
    two in turn) at ``shapes`` (the 12 ResNet-50 shapes), bf16, ``batch``
    (the train step's 128), each beside
    its plain version and its library call: for stage 1
    ``torch.batch_norm_backward_reduce`` (the same sums but Σ dy·(x − μ)
    without the rstd factor), for dx ``torch.batch_norm_backward_elemt`` on
    the same inputs and sums (count M), for the whole backward the two in
    turn. The plain dx is the torch stage K4's stage 2 replaces. Calls take
    copies of the inputs in turn, enough that they exceed the L2 cache
    (L2_BYTES) twice: a train step finds x cold. Returns {(H, C): {"sums" |
    "dx" | "bwd": (kernel ms, plain ms, library ms, bound ms, bound_by)}};
    each bound reads every input once and writes every output once."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    times = {}
    for hw, C in shapes:
        M = batch * hw * hw
        count = torch.full((1,), M, dtype=torch.int32, device=device)
        sets = []
        while not sets or len(sets) * nbytes(*sets[0][:2]) < 2 * L2_BYTES:
            dy, x, mean, rstd = bn_inputs(torch, batch, hw, C, device, gen)
            weight = torch.rand(C, generator=gen, device=device) + 0.5
            sums = BN.bn_backward_sums(dy, x, mean, rstd)
            sets.append((dy, x, mean, rstd, weight, sums, sums[1] / rstd))

        def kernel_sums(dy, x, mean, rstd, *_):
            return BN.bn_backward_sums(dy, x, mean, rstd)

        def plain_sums(dy, x, mean, rstd, *_):
            return BN.bn_backward_sums_reference(dy, x, mean, rstd)

        def library_sums(dy, x, mean, rstd, weight, *_):
            return torch.batch_norm_backward_reduce(dy, x, mean, rstd, weight,
                                                    True, False, False)

        def kernel_dx(dy, x, mean, rstd, weight, sums, _):
            return BN.bn_backward_dx(dy, x, mean, rstd, weight, sums)

        def plain_dx(dy, x, mean, rstd, weight, sums, _):
            return BN.bn_backward_dx_reference(dy, x, mean, rstd, weight,
                                               sums)

        def library_dx(dy, x, mean, rstd, weight, sums, sum_dy_xmu):
            return torch.batch_norm_backward_elemt(
                dy, x, mean, rstd, weight, sums[0], sum_dy_xmu, count)

        def kernel_bwd(dy, x, mean, rstd, weight, *_):
            return BN.bn_backward_dx(dy, x, mean, rstd, weight,
                                     BN.bn_backward_sums(dy, x, mean, rstd))

        def plain_bwd(dy, x, mean, rstd, weight, *_):
            return BN.bn_backward_dx_reference(
                dy, x, mean, rstd, weight,
                BN.bn_backward_sums_reference(dy, x, mean, rstd))

        def library_bwd(dy, x, mean, rstd, weight, *_):
            s = torch.batch_norm_backward_reduce(dy, x, mean, rstd, weight,
                                                 True, False, False)
            return torch.batch_norm_backward_elemt(dy, x, mean, rstd, weight,
                                                   s[0], s[1], count)

        def timed(kernel, plain, library):
            return time_turns(torch, *(rotating(f, sets) for f in (
                kernel, plain, library)), BN_CALLS, BN_REPLAYS)

        dy, x, mean, rstd, weight, sums, _ = sets[0]
        channel = nbytes(mean, rstd, weight, sums)
        times[(hw, C)] = {
            "sums": timed(kernel_sums, plain_sums, library_sums) + bound(
                nbytes(dy, x, mean, rstd, sums), 4 * M * C, FP32_FLOPS),
            "dx": timed(kernel_dx, plain_dx, library_dx) + bound(
                nbytes(dy, x, x) + channel, 6 * M * C, FP32_FLOPS),
            "bwd": timed(kernel_bwd, plain_bwd, library_bwd) + bound(
                nbytes(dy, x, x) + channel, 10 * M * C, FP32_FLOPS)}
        del sets, dy, x
    return times


BN_EPS = 1e-5  # ResNet's BatchNorm eps (MODEL.VISUAL's default)
# The BatchNorm forward is timed at the benchmark train cell's update: 256
# images in one micro-step.
FWD_TIMING_BATCH = 256


def time_bn_forward(torch, BN, device, batch=TRAIN_BATCH,
                    shapes=R50_BN_SHAPES):
    """BatchNorm's train-mode forward, bf16, ``batch``, at ``shapes``: its
    statistics kernel, its apply kernel and the two in turn, each beside
    its plain version (the torch ops the kernels replaced) and its library
    call (``torch.batch_norm_stats``, ``torch.batch_norm_elemt`` on the
    same statistics, the two in turn), rotating input copies past the L2
    cache as ``time_bn`` does. Returns {(H, C): {"stats" | "apply" | "fwd":
    (kernel ms, plain ms, library ms, bound ms, bound_by)}}; the bounds
    read x once for the statistics, once more for the apply and write y
    once, with the per-channel vectors."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    times = {}
    for hw, C in shapes:
        M = batch * hw * hw
        sets = []
        while not sets or len(sets) * nbytes(sets[0][0]) < 2 * L2_BYTES:
            x = (torch.randn(batch, hw, hw, C, generator=gen, device=device)
                 * 2.0 + 0.5).to(torch.bfloat16).permute(0, 3, 1, 2)
            weight = torch.rand(C, generator=gen, device=device) + 0.5
            bias = torch.randn(C, generator=gen, device=device) * 0.1
            stats = BN.bn_forward_stats(x, BN_EPS)
            sets.append((x, weight, bias, stats[0], stats[3]))

        def kernel_stats(x, *_):
            return BN.bn_forward_stats(x, BN_EPS)

        def plain_stats(x, *_):
            return BN.bn_forward_stats_reference(x, BN_EPS)

        def library_stats(x, *_):
            return torch.batch_norm_stats(x, BN_EPS)

        def kernel_apply(x, weight, bias, mean, rstd):
            return BN.bn_apply(x, mean, rstd, weight, bias, torch.bfloat16)

        def plain_apply(x, weight, bias, mean, rstd):
            return BN.bn_apply_reference(x, mean, rstd, weight, bias,
                                         torch.bfloat16)

        def library_apply(x, weight, bias, mean, rstd):
            return torch.batch_norm_elemt(x, weight, bias, mean, rstd,
                                          BN_EPS)

        def kernel_fwd(x, weight, bias, *_):
            return BN.bn_forward(x, weight, bias, BN_EPS, torch.bfloat16)

        def plain_fwd(x, weight, bias, *_):
            st = BN.bn_forward_stats_reference(x, BN_EPS)
            return BN.bn_apply_reference(x, st[0], st[3], weight, bias,
                                         torch.bfloat16)

        def library_fwd(x, weight, bias, *_):
            mean, invstd = torch.batch_norm_stats(x, BN_EPS)
            return torch.batch_norm_elemt(x, weight, bias, mean, invstd,
                                          BN_EPS)

        def timed(kernel, plain, library):
            with torch.no_grad():
                return time_turns(torch, *(rotating(f, sets) for f in (
                    kernel, plain, library)), BN_CALLS, BN_REPLAYS)

        x, weight, bias, mean, rstd = sets[0]
        channel = nbytes(weight, bias, mean, rstd)
        times[(hw, C)] = {
            "stats": timed(kernel_stats, plain_stats, library_stats) + bound(
                nbytes(x) + 2 * channel, 3 * M * C, FP32_FLOPS),
            "apply": timed(kernel_apply, plain_apply, library_apply) + bound(
                2 * nbytes(x) + channel, 3 * M * C, FP32_FLOPS),
            "fwd": timed(kernel_fwd, plain_fwd, library_fwd) + bound(
                3 * nbytes(x) + 3 * channel, 6 * M * C, FP32_FLOPS)}
        del sets, x
    return times


def bn_forward_lines(card, times, bn_shapes, batch):
    """One line per key of ``time_bn_forward``'s times: per call at each
    shape, and summed over the BatchNorm calls of ``bn_shapes``."""
    calls = sum(bn_shapes.values())
    lines = []
    for key, title, library in (
            ("stats", "BatchNorm forward statistics", "batch_norm_stats"),
            ("apply", "BatchNorm forward apply", "batch_norm_elemt"),
            ("fwd", "BatchNorm forward, both kernels",
             "batch_norm_stats + batch_norm_elemt")):
        step = per_step(times, bn_shapes, key)
        lines.append(
            f"{card} | {title}, bf16 B{batch}, device ms per call (library: "
            f"{library}): " + "; ".join(
                f"{hw}x{hw}x{C} {timing_text(t[key])}"
                for (hw, C), t in times.items())
            + f" | summed over {calls} calls: kernel {step[0]:.3f}, plain "
            f"{step[1]:.3f}, library {step[2]:.3f}, bound {step[3]:.3f} "
            f"({step[3] / step[0]:.0%} of bound)")
    return lines


def per_step(times, bn_shapes, key):
    """One train step's (kernel, plain, library, bound) ms of ``key``:
    each BatchNorm input shape of the step's forward passes, (B, C, H, W),
    times the device ms at its (H, C)."""
    return [sum(n * times[(s[2], s[1])][key][i] for s, n in bn_shapes.items())
            for i in range(4)]


def bn_timing_line(card, times, step, calls, title, library):
    return (f"{card} | {title}, bf16 B{TRAIN_BATCH}, device ms per call "
            f"(library: {library}): " + "; ".join(
                f"{hw}x{hw}x{C} {timing_text(t)}" for (hw, C), t in
                times.items()) + f" | per train step ({calls} calls): "
            f"kernel {step[0]:.3f}, plain {step[1]:.3f}, library "
            f"{step[2]:.3f}, bound {step[3]:.3f} ({step[3] / step[0]:.0%} of "
            "bound)")


# Kernel names, lowercased, by kind; the first kind that matches counts.
KERNEL_KINDS = [
    ("K1", ("attention_fwd",)), ("K2", ("attention_bwd",)),
    ("K4 sums", ("bn_sums",)), ("K4 dx", ("bn_dx",)),
    ("optimizer", ("multi_tensor_apply",)),
    ("GEMM/conv", ("gemm", "conv", "cutlass", "xmma", "cudnn", "sm90_",
                   "implicit", "wgrad", "dgrad", "fprop", "cublas")),
    ("elementwise", ("elementwise",)), ("reduction", ("reduce",)),
]


PROFILE_TOP = 8  # kernels named in the profile line


def profile_step(torch, fn) -> str:
    """One call of ``fn`` (warmed up by the caller) under torch.profiler:
    the device busy ms (union of the device events' intervals), host ms,
    peak device memory, and device ms by kernel kind."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return (f"host {host:.1f} ms, peak {peak:.2f} GiB; the profiler saw "
                "no device events")
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    kinds = {}
    for e in events:
        name = e.name.lower()
        kind = next((k for k, keys in KERNEL_KINDS
                     if any(key in name for key in keys)), "other")
        n, ms = kinds.get(kind, (0, 0.0))
        kinds[kind] = (n + 1, ms + (e.time_range.end - e.time_range.start)
                       / 1e3)
    by_kind = ", ".join(f"{k} {ms:.2f} ms ({n})" for k, (n, ms) in
                        sorted(kinds.items(), key=lambda kv: -kv[1][1]))
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    top = "; ".join(f"{ms:.2f} ms {name[:90]}" for name, ms in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:PROFILE_TOP])
    return (f"host {host:.1f} ms, device busy {busy / 1e3:.1f} ms, "
            f"{len(events)} device events, peak {peak:.2f} GiB; by kind "
            f"(ms, events): {by_kind} | top kernels: {top}")


def check_fwd_counts(fwd, what: str) -> None:
    """A train step's BatchNorm forward launches: one statistics and one
    apply launch for each K4 stage-1 launch, all in the vector variants
    (``fwd_counts``, read right after the step's ``checked_counts``)."""
    want = LAUNCHES_PER_STEP["K4"]
    if fwd != (want, want, want, want):
        fail(f"{what}: BatchNorm forward (statistics, vector, apply, "
             f"vector) launches {fwd}, expected {want} of each")


def running_gap(torch, model, plain, SubsampledBatchNorm) -> float:
    """The largest gap, per element |a − b| / (|ref| + 1), between the
    running statistics of ``model``'s BatchNorms (updated by the
    statistics kernel) and those of its plain copy (updated by the torch
    ops from the plain statistics) after the same steps; fails above
    RUNNING_TOL, or if the counts differ."""
    worst = 0.0
    for a, b in zip(model.modules(), plain.modules()):
        if not isinstance(a, SubsampledBatchNorm):
            continue
        if not torch.equal(a.num_batches_tracked, b.num_batches_tracked):
            fail(f"num_batches_tracked {int(a.num_batches_tracked)} with "
                 f"the kernels, {int(b.num_batches_tracked)} plain")
        worst = max(worst, rel_err(a.running_mean, b.running_mean, 1.0),
                    rel_err(a.running_var, b.running_var, 1.0))
    if not worst <= RUNNING_TOL:
        fail(f"running statistics {worst:.3e} from the plain versions' "
             f"(tol {RUNNING_TOL:.1e})")
    return worst


def check_train(torch, port, device):
    """Phase 8. Returns what phase 9 times and the kernels line reads."""
    A, BN = port.A, port.BN
    spec = dataclasses.replace(port.ModelSpec.flagship(), textual_dropout=0.0)
    torch.manual_seed(SEED)
    model = port.PretrainingModelFactory.from_spec(spec)
    randomize_(torch, model, SEED)
    model = model.to(device)
    plain = plain_copy(model, A, BN, port.MultiHeadAttention,
                       port.SubsampledBatchNorm)
    optim = port.OptimSpec.flagship()
    step = port.make_train_step(
        model, port.build_optimizer(model.named_parameters(), optim), ACCUM)
    plain_step = port.make_train_step(
        plain, port.build_optimizer(plain.named_parameters(), optim), ACCUM)
    batch = train_batch(torch, spec, device, SEED)

    # First step, dropout 0: the kernels against the plain versions.
    shapes, unhook = bn_shape_counts(model, port.SubsampledBatchNorm)
    reset_counts()             # a main path starts here
    metrics = {k: float(v) for k, v in step(batch).items()}
    torch.cuda.synchronize()
    first_counts = checked_counts()  # ... and ends here
    first_fwd = fwd_counts()
    dy_copies = launched()[("k4_dy", "copy")]
    unhook()
    if first_counts != LAUNCHES_PER_STEP:
        fail(f"train step launched {first_counts}, expected "
             f"{LAUNCHES_PER_STEP}")
    check_fwd_counts(first_fwd, "train step 1")
    ref = {k: float(v) for k, v in plain_step(batch).items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        fail(f"train step: non-finite metrics {metrics}")
    for key in ref:
        rtol = GRAD_NORM_RTOL if key == "grad_norm" else LOSS_RTOL
        if not abs(metrics[key] - ref[key]) <= rtol * abs(ref[key]):
            fail(f"train step: {key} {metrics[key]} with the kernels, "
                 f"{ref[key]} with the plain versions (rtol {rtol})")
    worst = {k: abs(metrics[k] - ref[k]) / abs(ref[k]) for k in ref}
    running_err = running_gap(torch, model, plain, port.SubsampledBatchNorm)
    say("8 train step", f"{spec.model_name} {spec.visual_name} "
        f"{spec.textual_name} {spec.dtype}, micro-batch {TRAIN_BATCH} x "
        f"accum {ACCUM}, dropout 0: kernels {json.dumps(metrics)}; plain "
        f"(attention, BatchNorm forward and backward) {json.dumps(ref)}; "
        f"relative gaps "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}; "
        f"running statistics within {running_err:.2e} (tol "
        f"{RUNNING_TOL:.1e}); launches {first_counts}, BatchNorm forward "
        f"{first_fwd[0]} statistics + {first_fwd[2]} apply, all vector")

    # Five steps with dropout 0.1 and no warmup; Lookahead syncs at step 5.
    spec01 = port.ModelSpec.flagship()
    model5 = port.PretrainingModelFactory.from_spec(spec01)
    randomize_(torch, model5, SEED + 1)
    model5 = model5.to(device)
    opt5 = port.build_optimizer(model5.named_parameters(),
                                dataclasses.replace(optim, warmup_steps=0))
    if opt5.lookahead_k != TRAIN_STEPS:
        fail(f"Lookahead k is {opt5.lookahead_k}, expected {TRAIN_STEPS}")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    step5 = port.make_train_step(model5, opt5, ACCUM, generator=gen)
    losses, counts5 = [], {k: 0 for k in LAUNCHES_PER_STEP}
    for i in range(1, TRAIN_STEPS + 1):
        slow_before = opt5.slow[0].clone()
        reset_counts()         # a main path starts here
        loss = float(step5(batch)["loss"])
        torch.cuda.synchronize()
        counts = checked_counts()  # ... and ends here
        if counts != LAUNCHES_PER_STEP:
            fail(f"train step {i} launched {counts}, expected "
                 f"{LAUNCHES_PER_STEP}")
        check_fwd_counts(fwd_counts(), f"train step {i}")
        counts5 = {k: counts5[k] + counts[k] for k in counts}
        if not np.isfinite(loss):
            fail(f"train step {i}: loss {loss}")
        losses.append(loss)
        synced = not torch.equal(slow_before, opt5.slow[0])
        if synced != (i == TRAIN_STEPS):
            fail(f"train step {i}: Lookahead synced {synced}; expected a "
                 f"sync at step {TRAIN_STEPS} only")
    gap = max(float((p.detach() - s).abs().max())
              for p, s in zip(opt5.params, opt5.slow))
    if not gap <= 1e-5:
        fail(f"after the Lookahead sync the weights are {gap} from the slow "
             "weights")
    say("8 train step", f"dropout 0.1, no warmup, {TRAIN_STEPS} steps: "
        f"losses {losses}; Lookahead synced at step {TRAIN_STEPS} (weights "
        f"within {gap:.1e} of the slow copy); launches per step "
        f"{LAUNCHES_PER_STEP}")
    del model5, opt5, step5
    launches = {k: first_counts[k] + counts5[k] for k in counts5}
    return step, plain_step, batch, shapes, launches, dy_copies


# -- phase 10 ----------------------------------------------------------------
def wide_attention_case(torch, port, kind, dtype, device, seed):
    """The task ablations' attention at batch 128, 32 heads of 64: q/k/v
    strided views of the packed projection, g ~ N(0, 1), and the mask as
    ``make_self_attention_mask`` returns it for ``kind``: "causal_pad"
    (captioning's self-attention, (B, 1, 30, 30)), "pad_only" (masked LM's,
    (B, 1, 1, 30)) or "cross" (30×49, no mask)."""
    Tk = 49 if kind == "cross" else 30
    q, k, v = attention_inputs(torch, TRAIN_BATCH, 30, Tk, WIDE_HEADS, 64,
                               dtype, device, seed, packed=True)
    g = attention_inputs(torch, TRAIN_BATCH, 30, 30, WIDE_HEADS, 64, dtype,
                         device, seed + 1)[0]
    if kind == "cross":
        return q, k, v, g, None
    rng = np.random.RandomState(seed)
    lengths = rng.randint(3, 31, TRAIN_BATCH)
    lengths[0] = 30
    tokens = torch.zeros(TRAIN_BATCH, 30, dtype=torch.long, device=device)
    mask = port.make_self_attention_mask(
        tokens, torch.from_numpy(lengths).to(device),
        causal=kind == "causal_pad")
    want = (TRAIN_BATCH, 1, 1 if kind == "pad_only" else 30, 30)
    if tuple(mask.shape) != want:
        fail(f"{kind} mask has shape {tuple(mask.shape)}, expected {want}")
    q_stride = port.A._mask_arg(mask, TRAIN_BATCH, 30, 30)[1][2]
    if (q_stride == 0) != (kind == "pad_only"):
        fail(f"{kind} mask: the kernels would read it with a query stride "
             f"of {q_stride}")
    return q, k, v, g, mask


WIDE_KINDS = ("causal_pad", "pad_only", "cross")


def check_wide(torch, port, device):
    """K1 and K2 against their plain versions at 32 heads, without and with
    dropout, and their keep masks bit for bit. Returns the largest absolute
    bf16 errors of K1 and K2 and a summary."""
    A = port.A
    worst, k1_err, k2_err = {}, 0.0, 0.0
    rate, seed = 0.1, 4321

    def check(name, got, ref, dtype_name):
        if got.shape != ref.shape or got.dtype != ref.dtype:
            fail(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                 f"{tuple(ref.shape)} {ref.dtype}")
        err = rel_err(got, ref, ATOL)
        worst[name] = err
        if not err <= TOL[dtype_name]:
            fail(f"{name}: error {err:.3e} > {TOL[dtype_name]:.0e}")
        return float((got.float() - ref.float()).abs().max())

    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for i, kind in enumerate(WIDE_KINDS):
            q, k, v, g, mask = wide_attention_case(torch, port, kind, dtype,
                                                   device, SEED + 40 + i)
            out = k1_out(torch, A, f"{kind} 32 heads {dtype_name}", q, k, v,
                         mask)
            err = check(f"K1 {kind} {dtype_name}", out,
                        A.attention_reference(q, k, v, mask), dtype_name)
            if dtype_name == "bfloat16":
                k1_err = max(k1_err, err)
            keep = A.philox_keep_reference(seed, TRAIN_BATCH, WIDE_HEADS, 30,
                                           k.shape[1], rate, device=device)
            for r, ref in ((0.0, A.attention_backward_reference(
                    q, k, v, mask, g)), (rate, A.attention_backward_reference(
                        q, k, v, mask, g, keep, rate))):
                ours = k2_grads(torch, A, q, k, v, mask, g, r,
                                seed if r else None)
                for part, a, b in zip("qkv", ours, ref):
                    err = check(f"K2 {kind} {dtype_name} dropout {r} d{part}",
                                a, b, dtype_name)
                    if dtype_name == "bfloat16" and r == 0.0:
                        k2_err = max(k2_err, err)
    keep = [check_keep_bits(torch, A, device, WIDE_HEADS, rate, seed, dtype)
            for dtype in (torch.float32, torch.bfloat16)][-1]
    summary = ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
    return k1_err, k2_err, keep, summary


def time_wide(torch, port, device):
    """K1 and K2 at 32 heads, bf16, batch 128: {kind: time_attention's
    result}."""
    return {kind: time_attention(torch, port.A, *wide_attention_case(
        torch, port, kind, torch.bfloat16, device, SEED))
        for kind in WIDE_KINDS}


def timing_text(t) -> str:
    """kernel, plain, library and bound ms of one time_turns + bound."""
    return (f"{t[0]:.4f} (plain {t[1]:.4f}, library {t[2]:.4f}, bound "
            f"{t[3]:.4f} by {t[4]}, {t[3] / t[0]:.0%} of bound)")


# -- phase 11 ----------------------------------------------------------------
def mask_tokens(tokens, lengths, vocab, rng):
    """Masked LM's input and labels: ⌈15%⌉ of the inner positions chosen;
    of those 85% [MASK]ed (labelled with the token), 10% a random token,
    the rest kept; a single chosen position is always [MASK]ed; labels are
    padding (0) elsewhere."""
    tokens, labels = tokens.copy(), np.zeros_like(tokens)
    for i, n in enumerate(lengths):
        chosen = rng.choice(np.arange(1, n - 1),
                            size=int(np.ceil((n - 2) * MASK_PROPORTION)),
                            replace=False)
        for j in chosen:
            flag = rng.uniform()
            if len(chosen) == 1 or flag <= MASK_PROB:
                labels[i, j], tokens[i, j] = tokens[i, j], MASK_INDEX
            elif flag <= MASK_PROB + REPLACE_PROB:
                tokens[i, j] = rng.randint(vocab)
    return tokens, labels


def task_batch(torch, spec, B, seed, device):
    """A batch of B with the keys and values the task's dataset makes:
    captions for captioning and masked LM (masked as the dataset masks
    them), the caption tokens as labels for token classification, and
    COCO categories for multilabel classification."""
    batch = caption_batch(torch, B, spec.image_size, spec.max_caption_length,
                          spec.vocab_size, seed, device)
    name = spec.model_name
    if name in ("virtex", "bicaptioning", "captioning"):
        return batch
    rng = np.random.RandomState(seed + 1)
    tokens = batch["caption_tokens"].cpu().numpy()
    lengths = batch["caption_lengths"].cpu().numpy()
    image = batch["image"]
    if name == "masked_lm":
        tokens, labels = mask_tokens(tokens, lengths, spec.vocab_size, rng)
        out = {"image": image, "caption_tokens": tokens,
               "masked_labels": labels, "caption_lengths": lengths}
    elif name == "token_classification":
        out = {"image": image, "labels": tokens}
    else:
        labels = np.zeros((B, MAX_LABELS), np.int32)
        for i in range(B):
            cats = np.sort(rng.choice(np.arange(1, spec.vocab_size),
                                      size=rng.randint(1, 9), replace=False))
            labels[i, :len(cats)] = cats
        out = {"image": image, "labels": labels}
    return {k: v if torch.is_tensor(v) else torch.from_numpy(v).to(device)
            for k, v in out.items()}


def check_task(torch, port, device, stem):
    """Phase 11 for one task: returns its main-path launches and timings."""
    A, BN = port.A, port.BN
    want = TASKS[stem]
    spec = port.ModelSpec.task_ablation(stem)
    name = spec.model_name
    model = port.PretrainingModelFactory.from_spec(
        dataclasses.replace(spec, textual_dropout=0.0))
    randomize_(torch, model, SEED)
    model = model.to(device)
    plain = plain_copy(model, A, BN, port.MultiHeadAttention,
                       port.SubsampledBatchNorm)
    optim = port.OptimSpec.task_ablation(stem)
    step = port.make_train_step(
        model, port.build_optimizer(model.named_parameters(), optim), ACCUM)
    plain_step = port.make_train_step(
        plain, port.build_optimizer(plain.named_parameters(), optim), ACCUM)
    flat = task_batch(torch, spec, ACCUM * TRAIN_BATCH, SEED, device)
    batch = {k: v.reshape((ACCUM, TRAIN_BATCH) + v.shape[1:])
             for k, v in flat.items()}

    # Dropout 0 (a copy of the weights trains with dropout 0.1 below).
    dropout_model = port.PretrainingModelFactory.from_spec(spec)
    dropout_model.load_state_dict(model.state_dict())
    dropout_model = dropout_model.to(device)
    reset_counts()             # a main path starts here
    metrics = {k: float(v) for k, v in step(batch).items()}
    torch.cuda.synchronize()
    counts = checked_counts()   # ... and ends here
    if counts != want:
        fail(f"{name} train step launched {counts}, expected {want}")
    ref = {k: float(v) for k, v in plain_step(batch).items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        fail(f"{name} train step: non-finite metrics {metrics}")
    for key in ref:
        rtol = GRAD_NORM_RTOL if key == "grad_norm" else LOSS_RTOL
        if not abs(metrics[key] - ref[key]) <= rtol * abs(ref[key]):
            fail(f"{name} train step: {key} {metrics[key]} with the "
                 f"kernels, {ref[key]} with the plain versions (rtol {rtol})")
    gaps = {k: float(f"{abs(metrics[k] - ref[k]) / abs(ref[k]):.3e}")
            for k in ref}
    launches = dict(counts)

    # Three steps with dropout 0.1.
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    dropout_step = port.make_train_step(
        dropout_model, port.build_optimizer(dropout_model.named_parameters(),
                                            optim), ACCUM, generator=gen)
    losses = []
    for i in range(TASK_DROPOUT_STEPS):
        reset_counts()         # a main path starts here
        loss = float(dropout_step(batch)["loss"])
        torch.cuda.synchronize()
        counts = checked_counts()  # ... and ends here
        if counts != want:
            fail(f"{name} dropout step {i + 1} launched {counts}, expected "
                 f"{want}")
        if not np.isfinite(loss):
            fail(f"{name} dropout step {i + 1}: loss {loss}")
        losses.append(loss)
        launches = {k: launches[k] + counts[k] for k in counts}
    del dropout_model, dropout_step

    # Eval step at batch 32, and the eval-mode predictions.
    eval_batch = task_batch(torch, spec, EVAL_BATCH, SEED + 7, device)
    reset_counts()             # a main path starts here
    eval_losses = {k: float(v)
                   for k, v in port.make_eval_step(model)(eval_batch).items()}
    with torch.inference_mode():
        preds = model.eval()(eval_batch)["predictions"]
    torch.cuda.synchronize()
    counts = checked_counts()   # ... and ends here
    launches = {k: launches[k] + counts[k] for k in counts}
    # two forwards (the eval step's, the predictions'), each one micro-step
    # of the train step's forward: half its K1 launches
    if counts != {"K1": want["K1"], "K2": 0, "K4": 0, "K4dx": 0}:
        fail(f"{name} eval step and predictions launched {counts}")
    if not all(np.isfinite(v) for v in eval_losses.values()):
        fail(f"{name} eval step: non-finite losses {eval_losses}")
    if name.endswith("classification"):
        if tuple(preds.shape) != (EVAL_BATCH, 10):
            fail(f"{name} predictions have shape {tuple(preds.shape)}")
        if int(preds.min()) < 0 or int(preds.max()) >= spec.vocab_size:
            fail(f"{name} predictions outside [0, {spec.vocab_size})")
    else:
        tokens = eval_batch["caption_tokens"]
        if preds.shape != tokens.shape:
            fail(f"{name} predictions have shape {tuple(preds.shape)}")
        if name == "masked_lm" and bool((preds[
                eval_batch["masked_labels"] == spec.unk_index]
                != spec.unk_index).any()):
            fail("masked LM predictions are not padding where the label is")

    step_ms = [host_ms(torch, lambda f=f: f(batch), 2, warmup=1)
               for f in (plain_step, step, step, plain_step)]
    say("11 task", f"{stem}: {name} {spec.visual_name} {spec.textual_name} "
        f"{spec.dtype}, micro-batch {TRAIN_BATCH} x accum {ACCUM}, dropout "
        f"0: kernels {json.dumps(metrics)}; relative gaps to the plain "
        f"versions {json.dumps(gaps)}; dropout 0.1: losses {losses}; "
        f"launches per step {want}; eval B{EVAL_BATCH} "
        f"{json.dumps(eval_losses)}, predictions {tuple(preds.shape)}")
    del model, plain, step, plain_step
    return launches, step_ms


def task_timing_line(stem, step_ms):
    kernels = (step_ms[1] + step_ms[2]) / 2
    plain = (step_ms[0] + step_ms[3]) / 2
    images = ACCUM * TRAIN_BATCH
    return (f"{stem} host ms per step (plain, kernels, kernels, plain): "
            f"{', '.join(f'{t:.1f}' for t in step_ms)} | kernels "
            f"{kernels:.1f} ms = {images / kernels * 1e3:.1f} img/s; plain "
            f"{plain:.1f} ms = {images / plain * 1e3:.1f} img/s")


# -- phase 12 ----------------------------------------------------------------
def boundary_rows(logits, p):
    """Rows of (B, V) logits where some token's mass sorted strictly before
    it (float64, descending, ties by index) lies within BOUNDARY_MARGIN of
    ``p``."""
    x = logits.double().sort(dim=-1, descending=True, stable=True).values
    probs = x.softmax(dim=-1)
    before = probs.cumsum(dim=-1) - probs
    return ((before - p).abs() < BOUNDARY_MARGIN).any(dim=-1)


def check_nucleus(torch, port, model, spec, images, device):
    """Phase 12. Returns the launches of its main path and ms per batch."""
    nspec = dataclasses.replace(spec, decoder_name="nucleus_sampling",
                                nucleus_size=NUCLEUS_P)
    decoder = port.CaptionDecoderFactory.from_spec(nspec)
    caption_fn = port.make_caption_fn(model, decoder, spec.sos_index,
                                      spec.prefix_mode)

    def draw(seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return caption_fn(images, gen)

    reset_counts()             # a main path starts here
    tokens = draw(SEED)
    torch.cuda.synchronize()
    counts = checked_counts()   # ... and ends here
    decodes = launched()[port.DA.KEY]
    if any(counts.values()):
        fail(f"nucleus captioning launched {counts}; its decode path "
             "launches no K1, K2 or K4")
    step_decodes = 2 * spec.textual["num_layers"]  # self and cross
    if not (0 < decodes <= step_decodes * spec.max_decoding_steps
            and decodes % step_decodes == 0):
        fail(f"nucleus captioning launched the decode attention {decodes} "
             f"times, not {step_decodes} per step")
    B = images.shape[0]
    if tuple(tokens.shape) != (B, spec.max_decoding_steps):
        fail(f"nucleus captions have shape {tuple(tokens.shape)}")
    lo, hi = int(tokens.min()), int(tokens.max())
    if lo < 0 or hi >= spec.vocab_size:
        fail(f"nucleus caption ids outside [0, {spec.vocab_size}): "
             f"{lo}..{hi}")
    if not torch.equal(tokens, draw(SEED)):
        fail("nucleus captioning: one generator seed gave two captionings")
    if torch.equal(tokens, draw(SEED + 1)):
        fail("nucleus captioning: another seed gave the same captions")

    # The first step's drop set, on the card and on the CPU.
    with torch.inference_mode():
        caches = model.init_decode(model.encode_visual(images),
                                   spec.max_decoding_steps)
        start = torch.full((B,), spec.sos_index, dtype=torch.long,
                           device=device)
        logits = model.decode_step(start, 0, caches)[0].float()
    on_card = port.topp_drop(logits, NUCLEUS_P).cpu()
    on_cpu = port.topp_drop(logits.cpu(), NUCLEUS_P)
    skip = boundary_rows(logits.cpu(), NUCLEUS_P)
    if int(skip.sum()) > B // 4:
        fail(f"nucleus drop set: {int(skip.sum())} of {B} rows sit on the "
             "boundary")
    if not torch.equal(on_card[~skip], on_cpu[~skip]):
        fail("nucleus drop set: the card and the CPU disagree")
    kept = (~on_cpu).sum(dim=-1)
    ms = host_ms(torch, lambda: draw(SEED), 3, warmup=1)
    say("12 nucleus", f"p {NUCLEUS_P}, {spec.max_decoding_steps} steps, "
        f"B{B}: tokens {tuple(tokens.shape)}, ids in [{lo}, {hi}], seeded; "
        f"no K1, K2 or K4 launch, {decodes} decode attention launches; "
        f"first-step drop set equal on the card and the "
        f"CPU in {B - int(skip.sum())} of {B} rows (nucleus of "
        f"{int(kept.min())}..{int(kept.max())} tokens); first caption "
        f"{tokens[0, :10].tolist()} | {card_line()} | {ms:.1f} ms per batch")
    return counts, ms


# -- phase 13 ----------------------------------------------------------------
PRETRAIN_CONFIG = os.path.join("configs",
                               "_base_bicaptioning_R_50_L1_H1024.yaml")
PRETRAIN_ITERS, PRETRAIN_CKPT_EVERY = 6, 3
# The pretraining CLI as bench.py trains the flagship: 256 images per
# iteration in two micro-batches of 128 (TRAIN_BATCH x ACCUM).
PRETRAIN_OVERRIDES = ["OPTIM.GRAD_ACCUM_STEPS", ACCUM,
                      "OPTIM.NUM_ITERATIONS", PRETRAIN_ITERS,
                      "OPTIM.WARMUP_STEPS", 2, "MODEL.TEXTUAL.DROPOUT", 0.1,
                      # cuDNN's deterministic algorithms, so that the resumed
                      # run can be held to the unbroken one bit for bit
                      "CUDNN_DETERMINISTIC", True, "CUDNN_BENCHMARK", False]
# A synthetic COCO-2017 directory: COCO's usual image sizes (H, W), five
# captions per image, JPEG quality 95.
SYNTH_TRAIN, SYNTH_VAL, SYNTH_CAPTIONS = 512, 64, 5
COCO_SIZES = ((480, 640), (640, 480))
JPEG_QUALITY = 95
# Decoded pixels of smooth images encoded at quality 95 with 4:2:0 chroma,
# against the pixels that were encoded: mean |Δ| on the 0..255 scale.
# libjpeg gives 1.27 at these sizes on the CPU, most of it the faint noise
# that quantization drops; planes or channels out of place are off by tens.
DECODE_MEAN_TOL = 3.0
DECODE_CHECK_IMAGES = 8
# JPEGs from libjpeg encoders (4:2:0, 4:2:2, 4:4:4, grayscale, progressive)
# with libjpeg's decoded pixels and batch_transform outputs, written on the
# CPU by tests/make_torch_jpeg_reference.py. The card's decoder is held to
# them: mean |Δ| on the 0..255 scale, per image and per batch output. The
# luma plane is never subsampled, so its mean |Δ| (Y = .299R + .587G +
# .114B, nearly free of chroma) is the tight gate: IDCTs differ by a level
# or two, a colour space or a chroma plane out of place by tens. RGB is
# looser: libjpeg upsamples 4:2:0 and 4:2:2 chroma with a triangle filter
# and nvJPEG replicates it, which differs by up to ~80 levels at the sharp
# saturated edges these small images are full of; the batch outputs,
# resized down, average those edges out.
JPEG_REFERENCE = os.path.join("tests", "fixtures",
                              "torch_jpeg_reference.npz")
REFERENCE_LUMA_TOL = 1.0
REFERENCE_RGB_TOL = 4.0
REFERENCE_BATCH_TOL = 3.0
# Where phases 13-16 write their data and runs; removed at the end.
WORK = os.path.join(REPO, "build", "phase13")
# Each validation eval step: self- and cross-attention in both directions.
EVAL_LAUNCHES = {"K1": 4, "K2": 0, "K4": 0, "K4dx": 0}
# Resumed against unbroken run, steps 4-6: losses relative, and every
# model and optimizer tensor per element relative to its own scale.
RESUME_RTOL = 1e-3
# The loader timed alone: batches, and the data plane's threads (the CLI's
# --cpu-workers default).
LOADER_TIMED_BATCHES, LOADER_THREADS = 4, 4
_WORDS = {"color": ["red", "green", "blue", "yellow", "white", "black",
                    "brown", "orange"],
          "thing": ["dog", "cat", "bus", "train", "horse", "boat", "kite",
                    "clock", "pizza", "bird"],
          "verb": ["sitting", "standing", "parked", "lying", "waiting"],
          "place": ["street", "field", "table", "beach", "kitchen", "park"],
          "side": ["left", "right"]}


def synth_caption(rng) -> str:
    w = {k: v[rng.randint(len(v))] for k, v in _WORDS.items()}
    return (f"a {w['color']} {w['thing']} {w['verb']} on the {w['side']} "
            f"side of the {w['place']}")


def write_tokenizer(path: str) -> None:
    """A BPE tokenizer JSON in the layout ``train_tokenizer`` writes (the
    special ids 0-3, Metaspace, fuse_unk), whose merges build every word of
    the synthetic captions letter by letter into one ``▁word`` token."""
    words = sorted({w for ws in _WORDS.values() for w in ws}
                   | {"a", "on", "the", "side", "of"})
    specials = ["<unk>", "[SOS]", "[EOS]", "[MASK]"]
    vocab = {t: i for i, t in enumerate(specials)}
    for c in sorted({"▁", *"".join(words)}):
        vocab[c] = len(vocab)
    merges = []
    for w in words:
        piece = "▁"
        for c in w:
            if piece + c not in vocab:
                merges.append([piece, c])
                vocab[piece + c] = len(vocab)
            piece += c
    meta = {"type": "Metaspace", "replacement": "▁",
            "prepend_scheme": "always", "split": True}
    blob = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": i, "content": t, "single_word": False,
                              "lstrip": False, "rstrip": False,
                              "normalized": False, "special": True}
                             for i, t in enumerate(specials)],
            "normalizer": None, "pre_tokenizer": meta,
            "post_processor": None, "decoder": meta,
            "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                      "continuing_subword_prefix": None,
                      "end_of_word_suffix": None, "fuse_unk": True,
                      "byte_fallback": False, "ignore_merges": False,
                      "vocab": vocab, "merges": merges}}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(blob, f, ensure_ascii=False)


def synth_image(torch, rng, h: int, w: int, device) -> np.ndarray:
    """A smooth RGB8 image, drawn on ``device`` from parameters drawn from
    ``rng``: a colour, two low-frequency waves per channel and faint noise,
    so that a quality-95 JPEG keeps it closely."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.randint(2**31)))
    y = torch.linspace(0.0, 1.0, h, device=device)[:, None, None]
    x = torch.linspace(0.0, 1.0, w, device=device)[None, :, None]
    img = torch.tensor(rng.uniform(40, 215, 3), dtype=torch.float32,
                       device=device).expand(h, w, 3)
    for amp, sign in ((30.0, 1.0), (15.0, -1.0)):
        fy, fx, ph = (torch.tensor(v, dtype=torch.float32, device=device)
                      for v in rng.uniform(0.5, 3.0, (3, 3)))
        img = img + amp * torch.sin(2 * np.pi * (fy * y + sign * fx * x)
                                    + ph)
    img = img + torch.randint(-2, 3, (h, w, 3), generator=gen, device=device)
    return img.clamp(0, 255).to(torch.uint8).cpu().numpy()


def probe_decoders() -> str:
    """Which JPEG codecs this machine has, by file (nothing is imported)."""
    import importlib.util
    cuda = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = {
        "jpeglib.h": any(os.path.exists(os.path.join(d, "jpeglib.h"))
                         for d in ("/usr/include", "/usr/local/include")),
        "nvjpeg.h": os.path.exists(os.path.join(cuda, "include", "nvjpeg.h")),
        "libnvjpeg.so": os.path.exists(os.path.join(cuda, "lib64",
                                                    "libnvjpeg.so")),
        "PIL": importlib.util.find_spec("PIL") is not None}
    return ", ".join(f"{k} {'yes' if v else 'no'}" for k, v in found.items())


def check_decoder(torch, plane, device) -> float:
    """Mean |Δ| of smooth images encoded at JPEG_QUALITY and decoded,
    against the encoded pixels, over both COCO sizes."""
    rng = np.random.RandomState(SEED)
    errs = []
    for i in range(DECODE_CHECK_IMAGES):
        h, w = COCO_SIZES[i % 2]
        img = synth_image(torch, rng, h, w, device)
        out = plane.decode(plane.encode_jpeg(img, JPEG_QUALITY))
        if out.shape != img.shape:
            fail(f"decoded shape {out.shape}, encoded {img.shape}")
        errs.append(float(np.abs(out.astype(np.float32) - img).mean()))
    err = max(errs)
    if not err <= DECODE_MEAN_TOL:
        fail(f"{plane.decoder}: quality-{JPEG_QUALITY} round trip mean |Δ| "
             f"{err:.3f} > {DECODE_MEAN_TOL}")
    return err


def check_reference_jpegs(port, plane):
    """The plane's decode and batch_transform of JPEG_REFERENCE's images
    against libjpeg's stored outputs. Returns {image: (luma mean, RGB mean,
    RGB max) |Δ|} and the mean |Δ| of the uint8 and float32 batch outputs,
    on the 0..255 scale."""
    native = port.native
    ref = np.load(os.path.join(REPO, JPEG_REFERENCE))
    names = [str(n) for n in ref["names"]]
    jpegs = [ref[f"jpeg_{i}"].tobytes() for i in range(len(names))]
    luma = np.array([0.299, 0.587, 0.114], np.float32)
    errs = {}
    for i, name in enumerate(names):
        got = plane.decode(jpegs[i]).astype(np.float32)
        want = ref[f"pixels_{i}"].astype(np.float32)
        if got.shape != want.shape:
            fail(f"{plane.decoder}: {name} decoded to {got.shape}, libjpeg "
                 f"{want.shape}")
        d = np.abs(got - want)
        errs[name] = (float(np.abs((got - want) @ luma).mean()),
                      float(d.mean()), float(d.max()))
    size = ref["out_uint8"].shape[1]
    rects, flips = ref["rects"], ref["flips"]
    u8 = plane.batch_transform(jpegs, rects, flips, size, native.RAW_MEAN,
                               native.RAW_STD, ref["jitters"], uint8=True)
    f32 = plane.batch_transform(jpegs, rects, flips, size)
    batch_errs = (
        float(np.abs(u8.astype(np.float32) - ref["out_uint8"]).mean()),
        float((np.abs(f32 - ref["out_float32"])
               * native.IMAGENET_STD * 255).mean()))
    if not (all(y <= REFERENCE_LUMA_TOL and m <= REFERENCE_RGB_TOL
                for y, m, _ in errs.values())
            and max(batch_errs) <= REFERENCE_BATCH_TOL):
        fail(f"{plane.decoder} against libjpeg on {JPEG_REFERENCE}: per "
             f"image (luma mean, RGB mean, RGB max) |Δ| {errs} (tol "
             f"{REFERENCE_LUMA_TOL}, {REFERENCE_RGB_TOL}), batch uint8/"
             f"float32 mean |Δ| {batch_errs} (tol {REFERENCE_BATCH_TOL})")
    return errs, batch_errs


def write_synthetic_coco(torch, plane, root: str, device) -> None:
    """COCO-2017 layout: {train,val}2017/*.jpg, captions_*.json and
    instances_*.json (one to three of 80 categories per image)."""
    rng = np.random.RandomState(SEED)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    cat_ids = [i + 1 + i // 10 for i in range(80)]  # sparse, as COCO's are
    image_id = 0
    for split, n in (("train", SYNTH_TRAIN), ("val", SYNTH_VAL)):
        os.makedirs(os.path.join(root, f"{split}2017"), exist_ok=True)
        images, caps, insts = [], [], []
        for i in range(n):
            image_id += 1
            h, w = COCO_SIZES[i % 2]
            name = f"{image_id:012d}.jpg"
            with open(os.path.join(root, f"{split}2017", name), "wb") as f:
                f.write(plane.encode_jpeg(synth_image(torch, rng, h, w,
                                                      device), JPEG_QUALITY))
            images.append({"id": image_id, "file_name": name, "height": h,
                           "width": w})
            caps += [{"id": len(caps) + 1, "image_id": image_id,
                      "caption": synth_caption(rng).capitalize() + "."}
                     for _ in range(SYNTH_CAPTIONS)]
            insts += [{"id": len(insts) + 1, "image_id": image_id,
                       "category_id": int(c), "bbox": [0, 0, 10, 10]}
                      for c in rng.choice(cat_ids, rng.randint(1, 4),
                                          replace=False)]
        with open(os.path.join(root, "annotations",
                               f"captions_{split}2017.json"), "w") as f:
            json.dump({"images": images, "annotations": caps}, f)
        with open(os.path.join(root, "annotations",
                               f"instances_{split}2017.json"), "w") as f:
            json.dump({"images": images, "annotations": insts,
                       "categories": [{"id": c, "name": f"category {c}"}
                                      for c in cat_ids]}, f)


def run_pretrain(torch, port, args: list, per_step: list, per_eval: list):
    """``pretrain_virtex.main`` on ``args``, recording the launches of each
    train step and each eval step (:func:`counted_steps`)."""
    with counted_steps(port, port.pretrain, per_step, per_eval):
        return port.pretrain.main(port.common_parser().parse_args(args))


@contextlib.contextmanager
def counted_steps(port, module, per_step: list, per_eval: list):
    """While open, the train steps and eval steps that ``module`` makes
    record their launches in ``per_step`` and ``per_eval`` (read around
    each call, no sync: the counts are bumped on the host at launch); an
    eval step's record also holds its batch size under "B"."""

    def counted(make, record, with_batch):
        def factory(*a, **k):
            step = make(*a, **k)

            def wrapped(batch):
                before = checked_counts()
                out = step(batch)
                after = checked_counts()
                counts = {k: after[k] - before[k] for k in after}
                if with_batch:
                    counts["B"] = int(batch["image"].shape[0])
                record.append(counts)
                return out
            return wrapped
        return factory

    saved = {name: getattr(module, name) for name in ("make_train_step",
                                                      "make_eval_step")
             if hasattr(module, name)}
    module.make_train_step = counted(saved["make_train_step"], per_step,
                                     False)
    if "make_eval_step" in saved:
        module.make_eval_step = counted(saved["make_eval_step"], per_eval,
                                        True)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def flat_state(port, path: str) -> dict:
    """A checkpoint's model and optimizer tensors, by name."""
    ckpt = port.read_checkpoint(path)
    out = {f"model.{k}": v for k, v in ckpt["model"].items()}
    for key, v in ckpt["optimizer"].items():
        if isinstance(v, dict):
            out.update({f"optimizer.{key}.{n}": t for n, t in v.items()})
    return out


def check_evals(run: str, evals: list) -> None:
    """Every validation eval step launched K1 as EVAL_LAUNCHES says, on a
    batch that phase 3 held K1 against its plain version at."""
    if not evals or any({k: c[k] for k in EVAL_LAUNCHES} != EVAL_LAUNCHES
                        or c["B"] not in VAL_BATCHES for c in evals):
        fail(f"{run}: the validation eval steps launched {evals}; expected "
             f"{EVAL_LAUNCHES} each on batches of {VAL_BATCHES}")


def check_pretraining(torch, port, device):
    """Phase 13. Returns its launches, and the run directory, the COCO root
    and the tokenizer JSON that phases 14, 16 and 20 read (under WORK,
    which main removes), the CLI's arguments and its result."""
    probe = probe_decoders()
    plane = port.DataPlane(port.decoder_for(device))
    decode_err = check_decoder(torch, plane, device)
    ref_errs, batch_errs = check_reference_jpegs(port, plane)
    say("13 pretraining", f"decoders on this machine: {probe}; the card's "
        f"runs decode with {plane.decoder}; quality-{JPEG_QUALITY} round "
        f"trip of {DECODE_CHECK_IMAGES} smooth images at COCO's sizes: mean "
        f"|Δ| {decode_err:.3f} <= {DECODE_MEAN_TOL}; against libjpeg on "
        f"{JPEG_REFERENCE} (luma mean <= {REFERENCE_LUMA_TOL}, RGB mean <= "
        f"{REFERENCE_RGB_TOL}, RGB max |Δ|): " + ", ".join(
            f"{k} {y:.3f}, {m:.3f}, {x:.0f}"
            for k, (y, m, x) in ref_errs.items())
        + f"; batch_transform mean |Δ| uint8 with jitter {batch_errs[0]:.3f}"
        f", float32 {batch_errs[1]:.3f} (<= {REFERENCE_BATCH_TOL})")

    work = WORK
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "coco")
    t0 = time.perf_counter()
    write_synthetic_coco(torch, plane, root, device)
    tokenizer = os.path.join(work, "tokenizer.json")
    write_tokenizer(tokenizer)
    say("13 pretraining", f"wrote {SYNTH_TRAIN} train and {SYNTH_VAL} val "
        f"JPEGs (640x480 and 480x640, {SYNTH_CAPTIONS} captions each, "
        f"instances json) with {plane.decoder}'s encoder and a tokenizer "
        f"JSON in {time.perf_counter() - t0:.1f} s")

    base = ["--config", os.path.join(REPO, PRETRAIN_CONFIG),
            "--checkpoint-every", str(PRETRAIN_CKPT_EVERY), "--log-every",
            "1", "--device", str(device), "--config-override",
            "DATA.ROOT", root, "DATA.TOKENIZER_MODEL", tokenizer,
            *[str(v) for v in PRETRAIN_OVERRIDES]]
    run = os.path.join(work, "run")
    steps, evals = [], []
    reset_counts()     # a main path starts here
    result = run_pretrain(torch, port, base + ["--serialization-dir", run],
                          steps, evals)
    torch.cuda.synchronize()
    launches = checked_counts()  # ... and ends here
    losses = [result["losses"][i] for i in range(1, PRETRAIN_ITERS + 1)]
    if not all(np.isfinite(losses)):
        fail(f"pretraining: losses {losses}")
    if len(steps) != PRETRAIN_ITERS or any(c != LAUNCHES_PER_STEP
                                           for c in steps):
        fail(f"pretraining: train steps launched {steps}, expected "
             f"{LAUNCHES_PER_STEP} in each of {PRETRAIN_ITERS}")
    val = result["val"]
    if sorted(val) != [3, 6] or not all(np.isfinite(v["loss"])
                                        for v in val.values()):
        fail(f"pretraining: validation {val}")
    check_evals("pretraining", evals)
    for name in ("checkpoint_3.pth", "checkpoint_6.pth",
                 "checkpoint_best.pth", "best.json"):
        if not os.path.isfile(os.path.join(run, name)):
            fail(f"pretraining: {name} is missing from {run}")
    seconds = [result["seconds"][i] for i in range(2, PRETRAIN_ITERS + 1)]
    step_ms = 1e3 * float(np.median(seconds))
    images = TRAIN_BATCH * ACCUM
    say("13 pretraining", f"python -m virtex_tpu_torch.scripts."
        f"pretrain_virtex on {PRETRAIN_CONFIG}, {images} images per "
        f"iteration (micro-batch {TRAIN_BATCH} x accum {ACCUM}), dropout "
        f"0.1: losses {json.dumps(losses)}; validation loss at 3 and 6 "
        f"{val[3]['loss']:.4f}, {val[6]['loss']:.4f}; launches per train "
        f"step {steps[0]} (all {PRETRAIN_ITERS}), per eval step "
        f"{evals[0]}; checkpoint_3, checkpoint_6, checkpoint_best and "
        f"best.json written")

    # Resume from iteration 3 and run through 6.
    resumed_run = os.path.join(work, "resumed")
    rsteps, revals = [], []
    resumed = run_pretrain(
        torch, port, base + ["--serialization-dir", resumed_run,
                             "--resume-from",
                             os.path.join(run, "checkpoint_3.pth")],
        rsteps, revals)
    if rsteps != [LAUNCHES_PER_STEP] * (PRETRAIN_ITERS - PRETRAIN_CKPT_EVERY):
        fail(f"resumed run: train steps launched {rsteps}, expected "
             f"{LAUNCHES_PER_STEP} in each of iterations "
             f"{PRETRAIN_CKPT_EVERY + 1}-{PRETRAIN_ITERS}")
    check_evals("resumed run", revals)
    gaps = {i: abs(resumed["losses"][i] - result["losses"][i])
            / abs(result["losses"][i]) for i in range(4, PRETRAIN_ITERS + 1)}
    if sorted(resumed["losses"]) != list(range(4, PRETRAIN_ITERS + 1)) or \
            not all(g <= RESUME_RTOL for g in gaps.values()):
        fail(f"resumed losses {resumed['losses']} vs unbroken "
             f"{result['losses']} (rtol {RESUME_RTOL})")
    a = flat_state(port, os.path.join(run, "checkpoint_6.pth"))
    b = flat_state(port, os.path.join(resumed_run, "checkpoint_6.pth"))
    if sorted(a) != sorted(b):
        fail("resumed checkpoint_6 holds other tensors than the unbroken")
    worst, equal = 0.0, 0
    for k in a:
        if not a[k].is_floating_point():
            if not torch.equal(a[k], b[k]):
                fail(f"resumed {k} {b[k]} vs unbroken {a[k]}")
            equal += 1
            continue
        scale = float(a[k].abs().max()) + 1e-12
        worst = max(worst, rel_err(b[k], a[k], scale))
        equal += int(torch.equal(a[k], b[k]))
    if not worst <= RESUME_RTOL:
        fail(f"resumed final state differs by {worst:.3e} of scale")
    say("13 pretraining", f"resumed from checkpoint_3 through {PRETRAIN_ITERS}"
        f": loss gaps {json.dumps({k: float(f'{v:.3e}') for k, v in gaps.items()})}"
        f" (rtol {RESUME_RTOL}); launches per train step {rsteps[0]} (all "
        f"{len(rsteps)}), per eval step {revals[0]}; final model and "
        f"optimizer state: "
        f"{equal} of {len(a)} tensors bit-equal, worst {worst:.3e} of scale "
        f"(cuDNN deterministic algorithms on, benchmark off)")

    # The loader alone on the host, then the CLI's own step times.
    cfg = port.Config(os.path.join(REPO, PRETRAIN_CONFIG),
                      ["DATA.ROOT", root, "DATA.TOKENIZER_MODEL", tokenizer])
    dataset = port.PretrainingDatasetFactory.from_config(
        cfg, port.DataPlane(plane.decoder, threads=LOADER_THREADS), "train")
    loader = port.DataLoader(dataset, images, background=False, seed=SEED)
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    for _ in range(LOADER_TIMED_BATCHES):
        next(it)
    loader_ips = LOADER_TIMED_BATCHES * images / (time.perf_counter() - t0)
    card = card_line()
    say("13 pretraining", f"{card} | loader alone ({plane.decoder} decode, "
        f"an OpenMP team of {LOADER_THREADS} on {os.cpu_count()} host "
        "cores): "
        f"{loader_ips:.1f} images/s over {LOADER_TIMED_BATCHES} batches of "
        f"{images} | CLI, host ms per iteration (iterations 2-"
        f"{PRETRAIN_ITERS}, each ending in a sync): "
        f"{', '.join(f'{1e3 * s:.1f}' for s in seconds)}; median "
        f"{step_ms:.1f} ms = {images / step_ms * 1e3:.1f} images/s")
    return launches, run, root, tokenizer, base, result


# -- phases 14-16 ------------------------------------------------------------
NO_LAUNCHES = {"K1": 0, "K2": 0, "K4": 0, "K4dx": 0}
# eval_captioning's batch (its --batch-size default), and the first val
# images whose beam captions on the card are held to a CPU fp32 run.
CAPTION_BATCH, CPU_CAPTION_IMAGES = 32, 4
# A caption on the card that differs from the CPU fp32 one must be a near
# tie: its beam score (the summed log-probability the search maximises)
# within this relative gap of the CPU's, by the card's own model. fp32
# differs from the CPU by the order of its sums; bf16 by its roundings.
BEAM_SCORE_RTOL = {"float32": 1e-3, "bfloat16": 5e-2}
DIRECTORY_IMAGES = 6
SP_MODEL = os.path.join("tests", "fixtures", "torch_sp_bpe.model")
SP_GOLDEN = os.path.join("tests", "fixtures", "torch_sp_bpe_golden.json")
SP_UNIGRAM = os.path.join("tests", "fixtures", "torch_sp_unigram.model")
SP_UNIGRAM_GOLDEN = os.path.join("tests", "fixtures",
                                 "torch_sp_unigram_golden.json")
# Phase 16's synthetic transfer sets: ImageNet's usual sizes (H, W), 8
# wnids; iNaturalist labels drawn from its 8142 classes.
DOWN_SIZES = ((375, 500), (500, 375))
DOWN_TRAIN, DOWN_VAL, DOWN_WNIDS, INAT_CLASSES = 512, 128, 8, 8142
CLF_ITERS, CLF_CKPT_EVERY = 4, 2
DOWN_CONFIGS = {"probe": os.path.join("configs", "downstream",
                                      "imagenet_clf.yaml"),
                "finetune": os.path.join("configs", "downstream",
                                         "inaturalist_clf.yaml")}
# Each train step of the fine-tune: ResNet-50's 53 BatchNorm layers in one
# micro-step; the probe's frozen backbone runs none.
CLF_LAUNCHES = {"probe": NO_LAUNCHES,
                "finetune": {"K1": 0, "K2": 0, "K4": 53, "K4dx": 53}}
CLF_TIMED_STEPS = 3


def run_cli(module, args: list, log_path: str):
    """``module.main`` on ``args``, its standard output (the logs and what
    it prints) written to ``log_path``; returns the result and the last
    line it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = module.main(module.build_parser().parse_args(args))
    with open(log_path, "w") as f:
        f.write(out.getvalue())
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    return result, lines[-1] if lines else ""


def caption_tokens(torch, port, spec, ckpt, images, device):
    """Beam-search tokens and scores of ``images`` by the model of
    ``spec`` on ``device`` with the checkpoint's weights."""
    model = port.PretrainingModelFactory.from_spec(spec, device)
    port.load_model_variables(ckpt, model)
    decoder = port.CaptionDecoderFactory.from_spec(spec)
    found = {}
    search = decoder.search

    def recording(*a, **k):
        found["out"] = search(*a, **k)
        return found["out"]
    decoder.search = recording
    fn = port.make_caption_fn(model, decoder, spec.sos_index,
                              spec.prefix_mode)
    fn(images.to(device))
    tokens, scores = found["out"]
    return tokens.cpu(), scores.float().cpu()


def check_eval_captioning(torch, port, device, run, root, tokenizer):
    """Phase 14."""
    ckpt = os.path.join(run, f"checkpoint_{PRETRAIN_ITERS}.pth")
    with open(os.path.join(root, "annotations",
                           "captions_val2017.json")) as f:
        val_ids = sorted(im["id"] for im in json.load(f)["images"])
    base = ["--config", os.path.join(REPO, PRETRAIN_CONFIG),
            "--checkpoint-path", ckpt, "--device", str(device),
            "--batch-size", str(CAPTION_BATCH), "--calc-metrics"]
    over = ["--config-override", "DATA.ROOT", root, "DATA.TOKENIZER_MODEL",
            tokenizer]
    runs = {}
    for name, extra in (("beam", []),
                        ("nucleus", ["MODEL.DECODER.NAME",
                                     "nucleus_sampling"])):
        out_dir = os.path.join(WORK, f"eval_{name}")
        out_json = os.path.join(out_dir, "predictions.json")
        reset_counts()   # a main path starts here
        result, last = run_cli(port.eval_captioning, base + [
            "--serialization-dir", out_dir, "--output", out_json] + over
            + extra, os.path.join(WORK, f"eval_{name}.log"))
        torch.cuda.synchronize()
        counts = checked_counts()  # ... and ends here
        if counts != NO_LAUNCHES:
            fail(f"eval_captioning ({name}) launched {counts}; its decode "
                 "path runs no kernel")
        preds = result["predictions"]
        with open(out_json) as f:
            if json.load(f) != preds:
                fail(f"eval_captioning ({name}): --output differs from the "
                     "predictions")
        if sorted(p["image_id"] for p in preds) != val_ids:
            fail(f"eval_captioning ({name}): {len(preds)} predictions for "
                 f"{len(val_ids)} val images")
        if not all(isinstance(p["caption"], str) for p in preds) or not \
                any(p["caption"] for p in preds):
            fail(f"eval_captioning ({name}): captions {preds[:3]}")
        metrics = json.loads(last)
        if set(metrics) != {"CIDEr", "SPICE"} or metrics != result[
                "metrics"] or not (np.isfinite(metrics["CIDEr"])
                                   and 0.0 <= metrics["CIDEr"] <= 1000.0):
            fail(f"eval_captioning ({name}): last line {last!r}")
        runs[name] = result

    # --images: a directory of JPEGs, captioned with string ids.
    directory = os.path.join(WORK, "images")
    os.makedirs(directory, exist_ok=True)
    files = sorted(os.listdir(os.path.join(root, "val2017")))
    stems = [f"photo_{i}" for i in range(DIRECTORY_IMAGES)]
    for stem, name in zip(stems, files):
        shutil.copyfile(os.path.join(root, "val2017", name),
                        os.path.join(directory, f"{stem}.jpg"))
    reset_counts()   # a main path starts here
    result, _ = run_cli(port.eval_captioning, base[:-1] + [
        "--serialization-dir", os.path.join(WORK, "eval_images"),
        "--images", directory] + over, os.path.join(WORK, "eval_images.log"))
    torch.cuda.synchronize()
    if checked_counts() != NO_LAUNCHES:  # ... and ends here
        fail("eval_captioning --images launched a kernel")
    ids = [p["image_id"] for p in result["predictions"]]
    if ids != stems:
        fail(f"eval_captioning --images: ids {ids}, expected {stems}")

    # The first val images: the card's beams against a CPU fp32 run.
    cfg = port.Config(os.path.join(REPO, PRETRAIN_CONFIG),
                      ["DATA.ROOT", root, "DATA.TOKENIZER_MODEL", tokenizer])
    spec = port.ModelSpec.from_config(cfg)
    spec32 = dataclasses.replace(spec, dtype="float32")
    plane = port.DataPlane(port.decoder_for(device))
    dataset = port.PretrainingDatasetFactory.from_config(cfg, plane, "val")
    host = dataset.collate_fn(dataset.get_batch(
        list(range(CPU_CAPTION_IMAGES)),
        [np.random.RandomState(i) for i in range(CPU_CAPTION_IMAGES)]))
    images = torch.from_numpy(host["image"])
    cpu_tokens, cpu_scores = caption_tokens(torch, port, spec32, ckpt,
                                            images, "cpu")
    tok = port.TokenizerFactory.from_config(cfg)
    cpu_captions = port.decode_predictions(cpu_tokens, tok, spec.eos_index)
    holds = {}
    for label, s in (("float32", spec32), ("bfloat16", spec)):
        tokens, scores = caption_tokens(torch, port, s, ckpt, images, device)
        equal = [bool(torch.equal(a, b)) for a, b in zip(tokens, cpu_tokens)]
        gaps = [0.0 if e else float(abs(scores[i] - cpu_scores[i])
                                    / abs(cpu_scores[i]))
                for i, e in enumerate(equal)]
        if max(gaps) > BEAM_SCORE_RTOL[label]:
            fail(f"beam captions on the card ({label}) against the CPU "
                 f"fp32 run: equal {equal}, score gaps {gaps} > "
                 f"{BEAM_SCORE_RTOL[label]}; card "
                 f"{port.decode_predictions(tokens, tok, spec.eos_index)}, "
                 f"CPU {cpu_captions}")
        holds[label] = (sum(equal), max(gaps))
    cli_first = [p["caption"] for p in runs["beam"]["predictions"][
        :CPU_CAPTION_IMAGES]]
    cli_equal = sum(a == b for a, b in zip(cli_first, cpu_captions))

    card = card_line()
    beam, nucleus = runs["beam"], runs["nucleus"]
    say("14 eval_captioning", f"python -m virtex_tpu_torch.scripts."
        f"eval_captioning on checkpoint_{PRETRAIN_ITERS} of phase 13, "
        f"{len(val_ids)} val images, batch {CAPTION_BATCH}: beam "
        f"{json.dumps(beam['metrics'])}, nucleus "
        f"{json.dumps(nucleus['metrics'])} (port PTB tokenizer and CIDEr-D; "
        f"SPICE 0.0: no java/jar); one prediction per val image in both; "
        f"--images on {DIRECTORY_IMAGES} JPEGs gave string ids {ids[:2]}...; "
        f"no kernel launched (decode runs plain attention); first beam "
        f"captions {json.dumps(cli_first[:2])}")
    say("14 eval_captioning", f"first {CPU_CAPTION_IMAGES} val images, beam "
        f"tokens against a CPU fp32 run: card fp32 equal in "
        f"{holds['float32'][0]}/{CPU_CAPTION_IMAGES} (score gap of the "
        f"others {holds['float32'][1]:.2e} <= "
        f"{BEAM_SCORE_RTOL['float32']}), card bf16 equal in "
        f"{holds['bfloat16'][0]}/{CPU_CAPTION_IMAGES} (score gap "
        f"{holds['bfloat16'][1]:.2e} <= {BEAM_SCORE_RTOL['bfloat16']}); "
        f"the CLI's bf16 captions equal the CPU's in {cli_equal}/"
        f"{CPU_CAPTION_IMAGES}")
    per_batch = {name: ", ".join(f"{1e3 * t:.1f}" for t in r["seconds"])
                 for name, r in runs.items()}
    say("14 eval_captioning", f"{card} | eval_captioning host ms per batch "
        f"of {CAPTION_BATCH} (copy in, encode, decode, captions out), each "
        f"batch in order: beam {per_batch['beam']}; nucleus "
        f"{per_batch['nucleus']}")


def check_sp_model(port) -> None:
    """Phase 15: the committed binary SentencePiece fixture, read by the
    port on this machine, gives the JAX reader's golden ids and decodes."""
    import importlib.util

    def present(name):
        try:
            return importlib.util.find_spec(name) is not None
        except ModuleNotFoundError:
            return False
    have = {m: present(m) for m in ("transformers", "google.protobuf",
                                    "sentencepiece")}
    before = set(sys.modules)
    tok = port.SentencePieceBPETokenizer(os.path.join(REPO, SP_MODEL))
    with open(os.path.join(REPO, SP_GOLDEN), encoding="utf-8") as f:
        golden = json.load(f)
    bad = [c["text"] for c in golden["cases"]
           if tok.encode(c["text"]) != c["ids"]
           or tok.decode(c["ids"]) != c["decoded"]]
    if bad or tok.get_vocab_size() != golden["vocab_size"]:
        fail(f"{SP_MODEL}: {len(bad)} of {len(golden['cases'])} captions "
             f"differ from {SP_GOLDEN} (e.g. {bad[:3]}), vocabulary "
             f"{tok.get_vocab_size()} vs {golden['vocab_size']}")
    from virtex_tpu_torch.scripts import tokenizer_selfcheck
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tokenizer_selfcheck.main(["--model", os.path.join(
            REPO, SP_UNIGRAM), "--golden", os.path.join(REPO,
                                                        SP_UNIGRAM_GOLDEN)])
    if rc != 0 or "PASS" not in out.getvalue():
        fail(f"tokenizer_selfcheck on {SP_UNIGRAM} exited {rc}: "
             f"{out.getvalue()[-2000:]}")
    loaded = sorted(m for m in set(sys.modules) - before
                    if m.split(".")[0] in ("transformers", "sentencepiece")
                    or m.startswith("google.protobuf"))
    if loaded:
        fail(f"reading {SP_MODEL} and {SP_UNIGRAM} imported {loaded}")
    say("15 sentencepiece", f"{SP_MODEL} ({tok.get_vocab_size()} pieces) "
        f"read by the port: {len(golden['cases'])} captions encode and "
        f"decode equal to {SP_GOLDEN}; python -m virtex_tpu_torch.scripts."
        f"tokenizer_selfcheck on the Unigram byte-fallback {SP_UNIGRAM}: "
        f"{out.getvalue().strip().splitlines()[-1]}; installed here: "
        + ", ".join(f"{k} {'yes' if v else 'no'}" for k, v in have.items())
        + "; none imported")


def write_transfer_sets(torch, plane, device):
    """An ImageNet folder tree and an iNaturalist json tree, each with
    DOWN_TRAIN train and DOWN_VAL val JPEGs at ImageNet's sizes. Returns
    their roots."""
    rng = np.random.RandomState(SEED + 16)
    imagenet = os.path.join(WORK, "imagenet")
    inat = os.path.join(WORK, "inaturalist")

    def write(path, i):
        h, w = DOWN_SIZES[i % 2]
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(plane.encode_jpeg(synth_image(torch, rng, h, w, device),
                                      JPEG_QUALITY))

    for split, n in (("train", DOWN_TRAIN), ("val", DOWN_VAL)):
        for i in range(n):
            write(os.path.join(imagenet, split, f"n{i % DOWN_WNIDS:08d}",
                               f"{split}_{i:05d}.JPEG"), i)
        images, annotations = [], []
        for i in range(n):
            name = f"{split}/{i:05d}.jpg"
            write(os.path.join(inat, name), i)
            images.append({"id": i + 1, "file_name": name})
            annotations.append({"image_id": i + 1, "category_id":
                                int(rng.randint(INAT_CLASSES))})
        os.makedirs(os.path.join(inat, "annotations"), exist_ok=True)
        with open(os.path.join(inat, "annotations", f"{split}2018.json"),
                  "w") as f:
            json.dump({"images": images, "annotations": annotations}, f)
    return imagenet, inat


def run_clf(torch, port, name, args, first_step):
    """``clf_linear.main`` on ``args``, recording each train step's
    launches and device-synced ms. With ``first_step`` (a dict), the first
    step is also taken by a copy of the model and optimizer whose BatchNorm
    backward calls the plain versions, and both steps' metrics are stored
    there. Returns the CLI's result, its last line, the per-step records,
    and the train step and the last batch for timing afterwards."""
    cli, BN = port.clf_linear, port.BN
    make = cli.make_train_step
    steps, kept = [], {}

    def factory(model, optimizer, *a, **k):
        step = make(model, optimizer, *a, **k)

        def wrapped(batch):
            plain_step = None
            if first_step is not None and not steps:
                twin, twin_opt = copy.deepcopy((model, optimizer))
                for m in twin.modules():
                    if isinstance(m, port.SubsampledBatchNorm):
                        plain_bn(m, BN)
                plain_step = make(twin, twin_opt)
            before = checked_counts()
            t0 = time.perf_counter()
            out = step(batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = checked_counts()
            steps.append({**{key: after[key] - before[key] for key in after},
                          "ms": ms})
            if plain_step is not None:
                first_step["kernels"] = {key: float(v)
                                         for key, v in out.items()}
                first_step["plain"] = {key: float(v) for key, v in
                                       plain_step(batch).items()}
            kept.update(step=step, batch=batch)
            return out
        return wrapped

    cli.make_train_step = factory
    try:
        result, last = run_cli(cli, args,
                               os.path.join(WORK, f"clf_{name}.log"))
    finally:
        cli.make_train_step = make
    return result, last, steps, kept


def check_clf_linear(torch, port, device, run, flagship_step_ms):
    """Phase 16. Returns the fine-tune's launches."""
    plane = port.DataPlane(port.decoder_for(device))
    t0 = time.perf_counter()
    imagenet, inat = write_transfer_sets(torch, plane, device)
    say("16 clf_linear", f"wrote {DOWN_TRAIN} train and {DOWN_VAL} val JPEGs "
        f"({DOWN_SIZES[0][1]}x{DOWN_SIZES[0][0]} and "
        f"{DOWN_SIZES[1][1]}x{DOWN_SIZES[1][0]}) into an ImageNet tree "
        f"({DOWN_WNIDS} wnids) and an iNaturalist json tree in "
        f"{time.perf_counter() - t0:.1f} s")
    ckpt = os.path.join(run, f"checkpoint_{PRETRAIN_ITERS}.pth")
    pretrained = port.read_checkpoint(ckpt)["model"]
    # --weight-init random keeps a fresh backbone as it is (virtex runs in
    # both CLI runs below).
    fresh = port.VisualBackboneFactory.create("torchvision::resnet50").to(
        device)
    drawn = {k: v.clone() for k, v in fresh.state_dict().items()}
    port.apply_backbone_weight_init(fresh, "random", None)
    if any(not torch.equal(v, drawn[k]) for k, v in
           fresh.state_dict().items()):
        fail("apply_backbone_weight_init(random) changed the backbone")
    del fresh, drawn
    out = {}
    for name, root in (("probe", imagenet), ("finetune", inat)):
        serial = os.path.join(WORK, f"clf_{name}")
        args = ["--down-config", os.path.join(REPO, DOWN_CONFIGS[name]),
                "--weight-init", "virtex", "--checkpoint-path", ckpt,
                "--serialization-dir", serial, "--device", str(device),
                "--checkpoint-every", str(CLF_CKPT_EVERY), "--log-every",
                "1", "--down-config-override", "DATA.ROOT", root,
                "OPTIM.NUM_ITERATIONS", str(CLF_ITERS)]
        first = {} if name == "finetune" else None
        reset_counts()   # a main path starts here
        result, last, steps, kept = run_clf(torch, port, name, args, first)
        torch.cuda.synchronize()
        launches = checked_counts()  # ... and ends here
        want = CLF_LAUNCHES[name]
        if len(steps) != CLF_ITERS or any(
                {k: c[k] for k in want} != want for c in steps):
            fail(f"clf_linear {name}: train steps launched {steps}, "
                 f"expected {want} in each of {CLF_ITERS}")
        if launches != {k: CLF_ITERS * v for k, v in want.items()}:
            fail(f"clf_linear {name}: the run launched {launches}")
        losses = [result["losses"][i] for i in range(1, CLF_ITERS + 1)]
        metric = json.loads(last)
        dataset = "imagenet" if name == "probe" else "inaturalist"
        if not all(np.isfinite(losses)) or set(metric) != {
                "metric", "value"} or metric["metric"] != \
                f"{dataset}_top1" or not 0.0 <= metric["value"] <= 100.0:
            fail(f"clf_linear {name}: losses {losses}, last line {last!r}")
        for f in (f"checkpoint_{CLF_CKPT_EVERY}.pth",
                  f"checkpoint_{CLF_ITERS}.pth", "checkpoint_best.pth",
                  "best.json"):
            if not os.path.isfile(os.path.join(serial, f)):
                fail(f"clf_linear {name}: {f} is missing")
        saved = port.read_checkpoint(os.path.join(
            serial, f"checkpoint_{CLF_ITERS}.pth"))["model"]
        visual = {k: v for k, v in saved.items() if k.startswith("visual.")}
        unchanged = sum(torch.equal(v, pretrained[k])
                        for k, v in visual.items())
        if name == "probe" and unchanged != len(visual):
            fail(f"linear probe: {len(visual) - unchanged} of {len(visual)} "
                 "backbone tensors changed")
        if name == "finetune":
            ref = first["plain"]
            gaps = {k: abs(first["kernels"][k] - ref[k]) / abs(ref[k])
                    for k in ("loss", "grad_norm")}
            if not all(g <= LOSS_RTOL for g in gaps.values()):
                fail(f"fine-tune first step: kernels {first['kernels']}, "
                     f"plain BatchNorm {ref} (rtol {LOSS_RTOL})")
        # The step alone on the last batch, then one step profiled.
        step_ms = host_ms(torch, lambda: kept["step"](kept["batch"]),
                          CLF_TIMED_STEPS, warmup=1)
        profile = (profile_step(torch, lambda: kept["step"](kept["batch"]))
                   if name == "finetune" else None)
        cli_ms = [1e3 * result["seconds"][i] for i in range(2, CLF_ITERS + 1)]
        out[name] = dict(losses=losses, metric=metric, steps=steps,
                         launches=launches, step_ms=step_ms, cli_ms=cli_ms,
                         unchanged=(unchanged, len(visual)), first=first,
                         profile=profile)
        del kept
        torch.cuda.empty_cache()

    card = card_line()
    batch = FINETUNE_BATCH
    probe, ft = out["probe"], out["finetune"]
    say("16 clf_linear", f"linear probe ({DOWN_CONFIGS['probe']}, "
        f"--weight-init virtex from phase 13's checkpoint_{PRETRAIN_ITERS}, "
        f"{CLF_ITERS} iterations of {batch}): losses "
        f"{json.dumps(probe['losses'])}; {json.dumps(probe['metric'])}; "
        f"launches per step {probe['steps'][0]['K4']} K4 "
        f"{probe['steps'][0]['K4dx']} K4 dx; backbone "
        f"{probe['unchanged'][0]}/{probe['unchanged'][1]} tensors "
        f"bit-unchanged")
    gaps = {k: abs(ft["first"]["kernels"][k] - ft["first"]["plain"][k])
            / abs(ft["first"]["plain"][k]) for k in ("loss", "grad_norm")}
    say("16 clf_linear", f"fine-tune ({DOWN_CONFIGS['finetune']}, ResNet-50 "
        f"bf16 at 224, batch {batch} in one micro-step, {CLF_ITERS} "
        f"iterations): losses {json.dumps(ft['losses'])}; "
        f"{json.dumps(ft['metric'])}; launches per step "
        f"{json.dumps({k: ft['steps'][0][k] for k in NO_LAUNCHES})} (all "
        f"{CLF_ITERS}, vector variants); first step kernels "
        f"{json.dumps(ft['first']['kernels'])} vs plain BatchNorm "
        f"{json.dumps(ft['first']['plain'])} (relative "
        f"{json.dumps({k: float(f'{v:.2e}') for k, v in gaps.items()})} <= "
        f"{LOSS_RTOL}); checkpoints {CLF_CKPT_EVERY} and {CLF_ITERS} and "
        f"best.json written")
    for name, label in (("finetune", "fine-tune"), ("probe", "probe")):
        r = out[name]
        in_cli = ", ".join(f"{c['ms']:.1f}" for c in r["steps"])
        with_data = ", ".join(f"{t:.1f}" for t in r["cli_ms"])
        say("16 clf_linear", f"{card} | {label} B{batch}: train step alone "
            f"(the last batch, {CLF_TIMED_STEPS} steps each ending in a "
            f"sync) {r['step_ms']:.1f} ms = "
            f"{batch / r['step_ms'] * 1e3:.1f} images/s; in the CLI, ms per "
            f"step {in_cli} and per iteration with its batch's loading "
            f"(iterations 2-{CLF_ITERS}) {with_data}")
    say("16 clf_linear", f"{card} | fine-tune step {ft['step_ms']:.1f} ms for "
        f"{batch} images vs the flagship's train step (phase 9, 128 x "
        f"accum 2) {flagship_step_ms:.1f} ms | one fine-tune step under "
        f"torch.profiler: {ft['profile']}")
    # The fine-tune's train split through the loader alone (the CLI's
    # loader prefetches while the first step autotunes cuDNN, so its
    # iterations 2-4 do not show the loader's pace).
    cfg = port.Config(os.path.join(REPO, DOWN_CONFIGS["finetune"]),
                      ["DATA.ROOT", inat])
    loader = port.DataLoader(port.DownstreamDatasetFactory.from_config(
        cfg, port.DataPlane(plane.decoder, threads=LOADER_THREADS), "train"),
        batch, background=False)
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    for _ in range(LOADER_TIMED_BATCHES):
        next(it)
    loader_ips = LOADER_TIMED_BATCHES * batch / (time.perf_counter() - t0)
    say("16 clf_linear", f"{card} | fine-tune train split through the "
        f"loader alone ({plane.decoder} decode, an OpenMP team of "
        f"{LOADER_THREADS}): {loader_ips:.1f} images/s over "
        f"{LOADER_TIMED_BATCHES} batches of {batch}, against the step "
        f"alone's {batch / ft['step_ms'] * 1e3:.1f}")
    k4 = time_bn(torch, port.BN, device, FINETUNE_BATCH, FINETUNE_K4_SHAPES)
    say("16 clf_linear", f"{card} | K4 at B{FINETUNE_BATCH}, bf16, device ms "
        "per call (library: torch.batch_norm_backward_reduce / _elemt): "
        + "; ".join(f"{hw}x{hw}x{C} sums {timing_text(t['sums'])}, dx "
                    f"{timing_text(t['dx'])}"
                    for (hw, C), t in k4.items()))
    return ft["launches"]


# -- phase 17 ----------------------------------------------------------------
VOC_CONFIG = os.path.join("configs", "downstream", "voc07_clf.yaml")
# The synthetic VOC2007 tree: 20 classes, VOC's image sizes (DOWN_SIZES),
# each class present in ~15% of the images and "difficult" in ~3%.
VOC_CLASSES, VOC_TRAIN, VOC_TEST = 20, 512, 512
VOC_BATCH = 128   # configs/downstream/voc07_clf.yaml OPTIM.BATCH_SIZE
VOC_POSITIVE, VOC_DIFFICULT = 0.15, 0.03
# The solver alone at VOC2007's own size: 5011 trainval and 4952 test
# images, ResNet-50's 2048 features; a class shifts its positives' features
# by SVM_SIGNAL along a direction of its own before the L2 normalisation:
# 2.5 times the noise's 1/sqrt(SVM_DIM) along any one direction, so that no
# line splits a class and the test mAP lands in VOC2007's range for real
# backbones (75.1 on an H100). The run fails outside SVM_MAP_RANGE.
SVM_TRAIN, SVM_TEST, SVM_DIM = 5011, 4952, 2048
SVM_SIGNAL = 2.5 / SVM_DIM ** 0.5
SVM_MAP_RANGE = (60.0, 90.0)
SVM_COSTS_N, SVM_FOLDS = 4, 3
SVM_FITS = VOC_CLASSES * (SVM_COSTS_N * SVM_FOLDS + 1)  # CV, then the fit
# Every fit stops at a gradient norm <= SVM_GRAD_GATE of its start; two
# classes' fits at C 1 on the card against the same solver on the card's
# host CPU, both fp64: w within SVM_CPU_RTOL of its scale.
SVM_GRAD_GATE, SVM_CPU_CLASSES, SVM_CPU_RTOL = 1e-6, 2, 1e-8
FEATURE_DIM = 2048   # ResNet-50's pooled features


def write_voc_tree(torch, root: str, device) -> None:
    """A VOC2007 tree (``JPEGImages``, ``ImageSets/Main/<class>_<split>.txt``)
    of VOC_TRAIN trainval and VOC_TEST test JPEGs written with PIL, every
    class with positives in both splits and some "difficult" entries."""
    from PIL import Image
    rng = np.random.RandomState(SEED + 17)
    os.makedirs(os.path.join(root, "JPEGImages"))
    os.makedirs(os.path.join(root, "ImageSets", "Main"))
    for split, n in (("trainval", VOC_TRAIN), ("test", VOC_TEST)):
        raw = rng.choice([1, 0, -1], (n, VOC_CLASSES), p=[
            VOC_POSITIVE, VOC_DIFFICULT, 1 - VOC_POSITIVE - VOC_DIFFICULT])
        for c in range(VOC_CLASSES):
            if (raw[:, c] == 1).sum() < 3:
                raw[rng.choice(n, 3, replace=False), c] = 1
        for i in range(n):
            h, w = DOWN_SIZES[i % 2]
            Image.fromarray(synth_image(torch, rng, h, w, device)).save(
                os.path.join(root, "JPEGImages", f"{split}_{i:05d}.jpg"),
                quality=JPEG_QUALITY)
        for c in range(VOC_CLASSES):
            with open(os.path.join(root, "ImageSets", "Main",
                                   f"class{c:02d}_{split}.txt"), "w") as f:
                f.writelines(f"{split}_{i:05d} {raw[i, c]:2d}\n"
                             for i in range(n))


def svm_problem(torch, device, n: int, directions, rng):
    """``n`` L2-normalised (n, SVM_DIM) features on ``device`` and their
    VOC-style targets (n, VOC_CLASSES) in {1, 0, −1}: N(0, 1) rows shifted
    by SVM_SIGNAL along each present class's direction."""
    targets = rng.choice([1, 0, -1], (n, VOC_CLASSES), p=[
        VOC_POSITIVE, 1 - VOC_POSITIVE - VOC_DIFFICULT, VOC_DIFFICULT])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.randint(2**31)))
    x = torch.randn(n, SVM_DIM, generator=gen, device=device)
    present = torch.from_numpy((targets == 1).astype(np.float32)).to(device)
    x = x / SVM_DIM ** 0.5 + SVM_SIGNAL * present @ directions
    return x / x.norm(dim=1, keepdim=True), targets


def check_svm_fits(stats, where: str) -> float:
    """The gradient gate over every fit of one ``train_test_svms``; returns
    the largest ratio."""
    ratio = stats["grad_norm"] / stats["grad_norm0"]
    if ratio.numel() != SVM_FITS or not bool((ratio <= SVM_GRAD_GATE).all()):
        fail(f"{where}: {ratio.numel()} fits (expected {SVM_FITS}), gradient "
             f"norms up to {float(ratio.max()):.2e} of their start (gate "
             f"{SVM_GRAD_GATE:.0e})")
    return float(ratio.max())


def check_clf_voc07(torch, port, device, run):
    """Phase 17. Returns the CLI's launches (none: BatchNorm runs on its
    running statistics)."""
    svm = port.svm
    root = os.path.join(WORK, "VOC2007")
    t0 = time.perf_counter()
    write_voc_tree(torch, root, device)
    say("17 clf_voc07", f"wrote a VOC2007 tree of {VOC_TRAIN} trainval and "
        f"{VOC_TEST} test JPEGs ({DOWN_SIZES[0][1]}x{DOWN_SIZES[0][0]} and "
        f"{DOWN_SIZES[1][1]}x{DOWN_SIZES[1][0]}, PIL, quality "
        f"{JPEG_QUALITY}) with {VOC_CLASSES} classes in "
        f"{time.perf_counter() - t0:.1f} s")
    ckpt = os.path.join(run, f"checkpoint_{PRETRAIN_ITERS}.pth")
    args = ["--config", os.path.join(REPO, PRETRAIN_CONFIG),
            "--down-config", os.path.join(REPO, VOC_CONFIG),
            "--weight-init", "virtex", "--checkpoint-path", ckpt,
            "--serialization-dir", os.path.join(WORK, "voc07"),
            "--device", str(device), "--down-config-override", "DATA.ROOT",
            root]
    reset_counts()       # a main path starts here
    result, last = run_cli(port.clf_voc07, args,
                           os.path.join(WORK, "clf_voc07.log"))
    torch.cuda.synchronize()
    launches = checked_counts()  # ... and ends here
    if launches != NO_LAUNCHES:
        fail(f"clf_voc07 launched {launches}; its backbone runs BatchNorm on "
             "running statistics")
    metric = json.loads(last)
    if set(metric) != {"metric", "value"} or metric["metric"] != \
            "voc07_mAP" or not 0.0 <= metric["value"] <= 100.0:
        fail(f"clf_voc07: last line {last!r}")
    for split, n in (("trainval", VOC_TRAIN), ("test", VOC_TEST)):
        x, labels = result["features"][split]
        norms = x.double().norm(dim=1)
        if tuple(x.shape) != (n, FEATURE_DIM) or not bool(
                torch.isfinite(x).all()) \
                or float((norms - 1).abs().max()) > 1e-5 or \
                labels.shape != (n, VOC_CLASSES):
            fail(f"clf_voc07 {split}: features {tuple(x.shape)}, norms "
                 f"{float(norms.min())}..{float(norms.max())}, labels "
                 f"{labels.shape}")
    cli_ratio = check_svm_fits(result["solver"], "clf_voc07's SVMs")
    aps = [r.ap for r in result["results"]]
    if len(aps) != VOC_CLASSES or not all(0.0 <= a <= 1.0 for a in aps):
        fail(f"clf_voc07: per-class APs {aps}")
    sec = result["seconds"]
    card = card_line()
    say("17 clf_voc07", f"{card} | CLI (--weight-init virtex from phase 13's "
        f"checkpoint_{PRETRAIN_ITERS}, ResNet-50 bf16 at 224, batch "
        f"{VOC_BATCH}): "
        f"{json.dumps(metric)}; costs chosen "
        f"{[r.cost for r in result['results']]}; no kernel launched; "
        f"features {VOC_TRAIN / sec['trainval']:.1f} images/s (trainval, "
        f"with its loading), {VOC_TEST / sec['test']:.1f} (test); the "
        f"{SVM_FITS} SVM fits {sec['svm']:.2f} s, gradient norms <= "
        f"{cli_ratio:.1e} of their start")

    # The loader alone on the trainval split (the CLI's extraction waits on
    # it): LOADER_TIMED_BATCHES batches after the first.
    cfg = port.Config(os.path.join(REPO, VOC_CONFIG), ["DATA.ROOT", root])
    plane = port.DataPlane(port.decoder_for(device), threads=LOADER_THREADS)
    loader = port.DataLoader(port.DownstreamDatasetFactory.from_config(
        cfg, plane, "trainval"), VOC_BATCH, shuffle=False, infinite=True,
        background=False)
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    for _ in range(LOADER_TIMED_BATCHES):
        next(it)
    loader_ips = LOADER_TIMED_BATCHES * VOC_BATCH / (time.perf_counter()
                                                     - t0)

    # The solver alone at VOC2007's size.
    rng = np.random.RandomState(SEED + 170)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 170)
    directions = torch.randn(VOC_CLASSES, SVM_DIM, generator=gen,
                             device=device) / SVM_DIM ** 0.5
    x_train, t_train = svm_problem(torch, device, SVM_TRAIN, directions, rng)
    x_test, t_test = svm_problem(torch, device, SVM_TEST, directions, rng)
    names = [f"class{c:02d}" for c in range(VOC_CLASSES)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results, stats = svm.train_test_svms(x_train, t_train, x_test, t_test,
                                         names)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    ratio = check_svm_fits(stats, f"the SVMs at {SVM_TRAIN} x {SVM_DIM}")
    steps = stats["steps"]
    # The CV fits come class by class, cost by cost, fold by fold.
    cost_steps = steps[:VOC_CLASSES * SVM_COSTS_N * SVM_FOLDS].reshape(
        VOC_CLASSES, SVM_COSTS_N, SVM_FOLDS).transpose(0, 1).reshape(
        SVM_COSTS_N, -1)
    mAP = 100.0 * float(np.mean([r.ap for r in results]))
    if not SVM_MAP_RANGE[0] <= mAP <= SVM_MAP_RANGE[1]:
        fail(f"SVMs at VOC2007's size: mAP {mAP} outside {SVM_MAP_RANGE}: "
             "the synthetic features are easier or harder than VOC2007's")

    # Two classes at C 1 on the card and on the host CPU.
    labels = np.stack([svm.binary_labels(t_train[:, c])
                       for c in range(SVM_CPU_CLASSES)])
    costs = np.stack([svm.row_costs(y, 1.0, np.arange(SVM_TRAIN))
                      for y in labels])
    card_sol = svm.solve(x_train, torch.from_numpy(labels),
                         torch.from_numpy(costs))
    t0 = time.perf_counter()
    cpu_sol = svm.solve(x_train.cpu(), torch.from_numpy(labels),
                        torch.from_numpy(costs))
    cpu_s = time.perf_counter() - t0
    w_card = torch.cat([card_sol.w, card_sol.b[:, None]], 1).cpu()
    w_cpu = torch.cat([cpu_sol.w, cpu_sol.b[:, None]], 1)
    gap = float(((w_card - w_cpu).abs().amax(1)
                 / w_cpu.abs().amax(1)).max())
    if not gap <= SVM_CPU_RTOL:
        fail(f"SVM at C 1: the card's w is {gap:.2e} of its scale from the "
             f"host CPU's (tol {SVM_CPU_RTOL:.0e})")
    say("17 clf_voc07", f"{card} | solver alone at VOC2007's size "
        f"({SVM_TRAIN} x {SVM_DIM} trainval, {SVM_TEST} test, {VOC_CLASSES} "
        f"classes, fp64 on the card): {SVM_FITS} fits in {fit_s:.2f} s "
        f"(Newton steps per fit {int(steps.min())}..{int(steps.max())}, "
        f"{int(steps.sum())} in all; CV fits' steps by cost "
        + ", ".join(f"C {c}: {int(n.min())}..{int(n.max())}" for c, n in
                    zip(svm.SVM_COSTS, cost_steps))
        + f"), gradient norms <= {ratio:.1e} of their "
        f"start (gate {SVM_GRAD_GATE:.0e}), peak {peak:.2f} GiB; mAP "
        f"{mAP:.3f} (gate {SVM_MAP_RANGE[0]}..{SVM_MAP_RANGE[1]}; signal "
        f"{SVM_SIGNAL:.4f}, 2.5 sigma); costs chosen "
        f"{[r.cost for r in results]}; {SVM_CPU_CLASSES} classes at C 1 equal the host CPU's "
        f"fp64 solve within {gap:.1e} of w's scale (tol "
        f"{SVM_CPU_RTOL:.0e}; the CPU took {cpu_s:.1f} s) | loader alone on "
        f"the trainval JPEGs ({plane.decoder} decode, an OpenMP team of "
        f"{LOADER_THREADS}): {loader_ips:.1f} images/s")
    return launches


# -- phase 18 ----------------------------------------------------------------
REMAT_LAUNCHES = {"K1": 16, "K2": 8, "K4": 106, "K4dx": 106}
REMAT_LOSS_RTOL, REMAT_GRAD_RTOL = 1e-5, 1e-3


def drawn_state(torch, port, spec, seed: int, draw=randomize_) -> dict:
    """The state dict of a ``spec`` model on the card, drawn from ``seed``
    by ``draw``."""
    torch.manual_seed(SEED)
    model = port.PretrainingModelFactory.from_spec(spec, DEVICE)
    draw(torch, model, seed)
    return model.state_dict()


def seeded_step(torch, port, spec, state: dict, seed: int):
    """A ``spec`` model on the card loaded from ``state``, its generator
    seeded with ``seed``, and its train step (micro-batch TRAIN_BATCH x
    ACCUM, the flagship's optimizer)."""
    model = port.PretrainingModelFactory.from_spec(spec, DEVICE)
    model.load_state_dict(state, strict=True)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    opt = port.build_optimizer(model.named_parameters(),
                               port.OptimSpec.flagship())
    return model, gen, port.make_train_step(model, opt, ACCUM, generator=gen)


def counted_step(torch, port, step, batch):
    """One train step between ``reset_counts`` and ``checked_counts``, with
    its metrics, host ms and peak GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()   # a main path starts here
    t0 = time.perf_counter()
    metrics = {k: float(v) for k, v in step(batch).items()}
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = checked_counts()  # ... and ends here
    return metrics, counts, ms, torch.cuda.max_memory_allocated() / 2**30


def check_remat(torch, port, device):
    """Phase 18. Returns the launches of its two counted steps."""
    spec = port.ModelSpec.flagship()   # dropout 0.1
    remat_spec = dataclasses.replace(spec, visual_remat=True,
                                     textual_remat=True)
    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        state = drawn_state(torch, port, spec, SEED + 18)
        plain, gen_p, step_p = seeded_step(torch, port, spec, state,
                                           SEED + 18)
        remat, gen_r, step_r = seeded_step(torch, port, remat_spec, state,
                                           SEED + 18)
        del state
        if not (remat.visual.cnn.remat and remat.textual.transformer.remat
                and remat.backward_textual.transformer.remat):
            fail("ModelSpec visual_remat/textual_remat did not reach the "
                 "ResNet and both transformers")
        batch = train_batch(torch, spec, device, SEED + 18)
        m_p, c_p, ms_p, gib_p = counted_step(torch, port, step_p, batch)
        m_r, c_r, ms_r, gib_r = counted_step(torch, port, step_r, batch)
        if c_p != LAUNCHES_PER_STEP or c_r != REMAT_LAUNCHES:
            fail(f"remat: the plain step launched {c_p} (expected "
                 f"{LAUNCHES_PER_STEP}), the remat step {c_r} (expected "
                 f"{REMAT_LAUNCHES})")
        if not abs(m_r["loss"] - m_p["loss"]) <= REMAT_LOSS_RTOL * abs(
                m_p["loss"]) or not abs(m_r["grad_norm"] - m_p["grad_norm"]) \
                <= REMAT_GRAD_RTOL * m_p["grad_norm"]:
            fail(f"remat step {m_r} against the plain step {m_p}")
        if not torch.equal(gen_p.get_state(), gen_r.get_state()):
            fail("remat: the generator ends the step elsewhere than the "
                 "plain step leaves it")
        # The recomputation replays the first forward on the same inputs,
        # dropout bits and K1 seed, and cuDNN is deterministic: every
        # parameter and buffer after the step equals the plain step's.
        s_p, s_r = plain.state_dict(), remat.state_dict()
        unequal = [k for k in s_p if not torch.equal(s_p[k], s_r[k])]
        if unequal:
            fail(f"remat: {len(unequal)} of {len(s_p)} parameters and buffers "
                 f"differ from the plain step's after it, e.g. {unequal[:4]}")
        steps_ms = [host_ms(torch, lambda f=f: f(batch), 2, warmup=1)
                    for f in (step_p, step_r, step_r, step_p)]
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    card = card_line()
    say("18 remat", f"{card} | flagship, micro-batch {TRAIN_BATCH} x accum "
        f"{ACCUM}, bf16, dropout 0.1, cuDNN deterministic, one generator "
        f"seed: MODEL.VISUAL.REMAT + MODEL.TEXTUAL.REMAT {json.dumps(m_r)} "
        f"vs plain {json.dumps(m_p)}; launches {c_r} vs {c_p}; all {len(s_p)} "
        f"parameters and buffers (BatchNorm's running statistics and "
        f"num_batches_tracked among them) bit-equal after the step; "
        f"generator state equal | host ms per step (plain, remat, remat, "
        f"plain): {', '.join(f'{t:.1f}' for t in steps_ms)}; first step "
        f"{ms_p:.1f} / {ms_r:.1f} ms; peak {gib_p:.2f} GiB plain, "
        f"{gib_r:.2f} GiB remat")
    del plain, remat, step_p, step_r, batch
    return {k: c_p[k] + c_r[k] for k in c_p}


# -- phase 19 ----------------------------------------------------------------
STAT_STRIDE, SAMPLER_STEPS = 4, 3
R50_BN_LAYERS = 53
SAMPLER_LAUNCHES = {"K1": 8, "K2": 8, "K4": 0, "K4dx": 0}


def check_sampler(torch, port, device):
    """Phase 19. Returns the launches of its counted steps."""
    spec = dataclasses.replace(port.ModelSpec.flagship(),
                               bn_stat_stride=STAT_STRIDE)
    f32 = dataclasses.replace(spec, dtype="float32")
    batch = train_batch(torch, spec, device, SEED + 19)
    # First step, dropout 0: bf16 through the kernels against fp32 plain
    # math (plain attention; the sampler's BatchNorm is plain torch).
    state = drawn_state(torch, port, spec, SEED + 19)
    model, _, step = seeded_step(torch, port, dataclasses.replace(
        spec, textual_dropout=0.0), state, SEED + 19)
    ref, _, _ = seeded_step(torch, port, dataclasses.replace(
        f32, textual_dropout=0.0), state, SEED + 19)
    ref = plain_copy(ref, port.A, port.BN, port.MultiHeadAttention,
                     port.SubsampledBatchNorm)
    ref_step = port.make_train_step(ref, port.build_optimizer(
        ref.named_parameters(), port.OptimSpec.flagship()), ACCUM)
    metrics, counts, _, _ = counted_step(torch, port, step, batch)
    want = {k: float(v) for k, v in ref_step(batch).items()}
    if counts != SAMPLER_LAUNCHES:
        fail(f"BN_STAT_STRIDE {STAT_STRIDE}: the step launched {counts}, "
             f"expected {SAMPLER_LAUNCHES}")
    gap = abs(metrics["loss"] - want["loss"]) / abs(want["loss"])
    if not gap <= LOSS_RTOL:
        fail(f"BN_STAT_STRIDE {STAT_STRIDE}: loss {metrics['loss']} against "
             f"fp32 plain math {want['loss']} (rtol {LOSS_RTOL})")
    bns = [m for m in model.modules()
           if isinstance(m, port.SubsampledBatchNorm)]
    tracked = {int(m.num_batches_tracked) for m in bns}
    if len(bns) != R50_BN_LAYERS or tracked != {ACCUM} or not all(
            bool(torch.isfinite(m.running_var).all()
                 and torch.isfinite(m.running_mean).all()) for m in bns):
        fail(f"BN_STAT_STRIDE {STAT_STRIDE}: {len(bns)} BatchNorm layers, "
             f"num_batches_tracked {tracked}, or non-finite statistics")
    del ref, ref_step, model, step
    torch.cuda.empty_cache()
    # Steps with dropout 0.1.
    model, _, step = seeded_step(torch, port, spec, state, SEED + 190)
    del state
    losses, total = [], dict(counts)
    for _ in range(SAMPLER_STEPS):
        m, c, _, _ = counted_step(torch, port, step, batch)
        if c != SAMPLER_LAUNCHES or not np.isfinite(m["loss"]):
            fail(f"BN_STAT_STRIDE {STAT_STRIDE}, dropout 0.1: launched {c}, "
                 f"loss {m['loss']}")
        losses.append(m["loss"])
        total = {k: total[k] + c[k] for k in total}
    step_ms = host_ms(torch, lambda: step(batch), 3, warmup=1)
    say("19 sampler", f"{card_line()} | flagship, micro-batch {TRAIN_BATCH} "
        f"x accum {ACCUM}, bf16, BN_STAT_STRIDE {STAT_STRIDE} (statistics "
        f"from {TRAIN_BATCH // max(1, min(STAT_STRIDE, TRAIN_BATCH // 8))} "
        f"of {TRAIN_BATCH} images): first "
        f"step, dropout 0, loss {metrics['loss']} vs fp32 plain math "
        f"{want['loss']} (relative {gap:.2e} <= {LOSS_RTOL}); launches "
        f"{counts}; running statistics finite, num_batches_tracked {ACCUM} "
        f"(one per micro-step) in all {R50_BN_LAYERS} layers; "
        f"{SAMPLER_STEPS} steps with "
        f"dropout 0.1: losses {losses} | {step_ms:.1f} ms per step")
    del model, step
    return total


# -- phase 20 ----------------------------------------------------------------
# (a) The pretraining CLI of phase 13 again, as rank 0 of a process group of
# one over NCCL (torchrun's environment): per train step, in each of the 53
# BatchNorm layers of both micro-steps the forward statistics and K4's sums,
# the two caption losses' denominators of both micro-steps, one gradient and
# one metrics all-reduce; per validation (one batch of 64) the metrics and
# the two denominators.
VALIDATIONS = PRETRAIN_ITERS // PRETRAIN_CKPT_EVERY
DP1_COLLECTIVES = {
    "bn_stats": R50_BN_LAYERS * ACCUM * PRETRAIN_ITERS,
    "bn_sums": R50_BN_LAYERS * ACCUM * PRETRAIN_ITERS,
    "loss_count": 2 * ACCUM * PRETRAIN_ITERS + 2 * VALIDATIONS,
    "grads": PRETRAIN_ITERS, "metrics": PRETRAIN_ITERS + VALIDATIONS}
# (b) Two ranks over gloo on the one card, each a process with its own CUDA
# context: global batch ACCUM x TRAIN_BATCH, DP_LOCAL images of each
# micro-batch per rank, against one process on the same global batch, in
# fp32 with TF32 off and in bf16. The ranks' convolutions over 64 images do
# not give the bits of one over 128, and a last-bit difference in a
# pre-activation that lies within it of zero flips that ReLU (or a max-pool
# window's choice): the flipped element's whole term leaves or joins the
# weight gradient upstream, a sum over M positions that at random weights
# has no coherent part, so one flip moves it by ~1/sqrt(M) of its scale
# (~1e-2 in layer4, M = 6272). The main-path fp32 step is held where flips
# do not reach: the losses, the BatchNorm running buffers and the
# gradients outside the ResNet within DP_FP32_TOL of each tensor's scale.
# A second fp32 step replays the one process's ReLU masks and max-pool
# indices on each rank's rows (ResNetBranches): the same function on both
# sides, piecewise-linear branch for branch, so the losses, the buffers
# and every gradient tensor's relative L2 error are held within
# DP_FP32_TOL, and each gradient element within DP_SUM_TOL of its tensor's
# scale. cuDNN is deterministic in both fp32 steps. bf16: the losses
# within LOSS_RTOL.
DP_WORLD = 2
DP_LOCAL = TRAIN_BATCH // DP_WORLD
DP_FP32_TOL = 1e-4
# A pinned gradient per element at its tensor's scale: layer1's dβ sums
# M = 2 x 128 x 56² = 802816 terms of random sign, which the ranks add in
# halves and one process whole; fp32 adds ~2^-24·sqrt(M) = 5.3e-5 of the
# sum's scale by the order alone (measured on the H100: 1.22e-4, with
# every tensor's relative L2 error under 7.2e-5).
DP_SUM_TOL = 4e-4
DP_ERRORS = ("loss_err", "buffer_err", "other_grad_err", "grad_l2")
DP_STEP_COLLECTIVES = {"bn_stats": R50_BN_LAYERS * ACCUM,
                       "bn_sums": R50_BN_LAYERS * ACCUM,
                       "loss_count": 2 * ACCUM, "grads": 1, "metrics": 1}
DP_TIMEOUT_S = 600


def check_dp_world_1(torch, port, device, base, run13, result13):
    """Phase 20(a). Returns its launches."""
    from virtex_tpu_torch.utils import distributed
    with socket.socket() as s:
        s.bind(("localhost", 0))
        free = s.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(free)}
    os.environ.update(env)
    run = os.path.join(WORK, "run_nccl1")
    steps, evals = [], []
    t0 = time.perf_counter()
    try:
        distributed.reset_all_reduce_counts()
        reset_counts()     # a main path starts here
        result = run_pretrain(torch, port, base + ["--serialization-dir",
                                                   run], steps, evals)
        torch.cuda.synchronize()
        launches = checked_counts()  # ... and ends here
        backend = torch.distributed.get_backend()
        world = distributed.get_world_size()
        collectives = dict(distributed.all_reduce_counts)
    finally:
        distributed.shutdown()
        for k in env:
            os.environ.pop(k, None)
    if (backend, world) != ("nccl", 1):
        fail(f"NCCL at world 1: the run's group was {backend} of {world}")
    if steps != [LAUNCHES_PER_STEP] * PRETRAIN_ITERS:
        fail(f"NCCL at world 1: train steps launched {steps}")
    check_evals("NCCL at world 1", evals)
    if collectives != DP1_COLLECTIVES:
        fail(f"NCCL at world 1: all-reduces {collectives}, expected "
             f"{DP1_COLLECTIVES}")
    if result["losses"] != result13["losses"] \
            or result["val"] != result13["val"]:
        fail(f"NCCL at world 1: losses {result['losses']}, validation "
             f"{result['val']} against phase 13's {result13['losses']}, "
             f"{result13['val']}")
    a = flat_state(port, os.path.join(run13, f"checkpoint_{PRETRAIN_ITERS}"
                                      ".pth"))
    b = flat_state(port, os.path.join(run, f"checkpoint_{PRETRAIN_ITERS}"
                                      ".pth"))
    unequal = [k for k in a if k not in b or not torch.equal(a[k], b[k])]
    if sorted(a) != sorted(b) or unequal:
        fail(f"NCCL at world 1: {len(unequal)} of {len(a)} tensors of "
             f"checkpoint_{PRETRAIN_ITERS} differ from phase 13's, e.g. "
             f"{unequal[:4]}")
    say("20 data parallel", f"(a) in {time.perf_counter() - t0:.1f} s: "
        f"python -m virtex_tpu_torch.scripts."
        f"pretrain_virtex as rank 0 of a process group of 1 over NCCL "
        f"(torchrun's environment), phase 13's data and flags: losses and "
        f"validation equal to phase 13's, all {len(a)} model and optimizer "
        f"tensors of checkpoint_{PRETRAIN_ITERS} bit-equal; all-reduces "
        f"{json.dumps(collectives)}; launches per train step {steps[0]} "
        f"(all {PRETRAIN_ITERS})")
    return launches


class ResNetBranches:
    """The ResNet's piecewise choices, each ReLU's mask and the stem's
    max-pool indices, in call order: recorded from one run (``saved`` None)
    or replayed into another (``saved``: what a recording gave, for this
    run's rows). A replayed ReLU keeps the recorded mask's elements and a
    replayed max pool takes the recorded indices, so the run computes the
    recorded run's branch of the network; ``flips`` counts where its own
    choices differ. Use as a context manager around the step: it swaps
    ``modules/resnet.py``'s ``F`` for this object."""

    def __init__(self, torch, saved=None):
        self.torch, self.saved = torch, saved
        self.record = saved is None
        self.entries, self.at = [], 0
        self.flips = {"relu": 0, "max_pool": 0}

    def __getattr__(self, name):   # every other F.<fn>
        return getattr(self.torch.nn.functional, name)

    def __enter__(self):
        from virtex_tpu_torch.modules import resnet
        self.module, self.plain = resnet, resnet.F
        resnet.F = self
        return self

    def __exit__(self, *exc):
        self.module.F = self.plain

    def _next(self, kind, like):
        want = self.saved[self.at]
        self.at += 1
        if want.shape != like.shape:
            fail(f"replayed {kind} {self.at}: {tuple(want.shape)} against "
                 f"{tuple(like.shape)}")
        return self.torch.empty_like(like, dtype=want.dtype).copy_(want)

    def relu(self, x):
        torch = self.torch
        mask = x > 0
        if self.record:
            self.entries.append(mask)
            return torch.relu(x)
        want = self._next("ReLU mask", mask)
        self.flips["relu"] += int((mask != want).sum())
        return torch.where(want, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))

    def max_pool2d(self, x, kernel, stride, padding):
        torch = self.torch
        y, idx = torch.nn.functional.max_pool2d(x, kernel, stride, padding,
                                                return_indices=True)
        if self.record:
            self.entries.append(idx)
            return y
        want = self._next("max-pool indices", idx)
        self.flips["max_pool"] += int((idx != want).sum())
        picked = torch.gather(x.flatten(2), 2, want.flatten(2))
        return torch.empty_like(y).copy_(picked.view(y.shape))


BIT_SHIFTS = tuple(range(8))


def pack_rows(torch, entries, rows) -> list:
    """A recording's entries cut to ``rows`` of the batch dim, for a rank:
    masks packed 8 to a byte, indices as int16 (< 112², the stem's
    plane)."""
    out = []
    for t in entries:
        t = t[rows].contiguous()
        if t.dtype == torch.bool:
            shifts = torch.tensor(BIT_SHIFTS, dtype=torch.uint8,
                                  device=t.device)
            data = (t.view(-1, 8).to(torch.uint8) << shifts).sum(
                1, dtype=torch.uint8)
        else:
            data = t.to(torch.int16)
        out.append((tuple(t.shape), str(t.dtype), data.cpu()))
    return out


def unpack_rows(torch, packed, device) -> list:
    out = []
    for shape, dtype, data in packed:
        data = data.to(device)
        if dtype == "torch.bool":
            shifts = torch.tensor(BIT_SHIFTS, dtype=torch.uint8,
                                  device=device)
            t = ((data.unsqueeze(1) >> shifts) & 1).bool().view(shape)
        else:
            t = data.long().view(shape)
        out.append(t)
    return out


def conditioning(torch, model, SubsampledBatchNorm):
    """Hooks on every BatchNorm of ``model`` that record, once, the
    smallest var/mean² over its input's channels (fp64 statistics):
    where E[x²] − E[x]² cancels most. Returns the {name: (ratio, channel)}
    dict they fill and a function that removes them."""
    found = {}

    def hook(name):
        def record(module, inputs):
            if name in found:
                return
            x = inputs[0].detach().double()
            dims = [d for d in range(x.dim()) if d != 1]
            var, mean = torch.var_mean(x, dims, correction=0)
            ratio = var / mean.square().clamp(min=1e-300)
            c = int(ratio.argmin())
            found[name] = (float(ratio[c]), c)
        return record

    handles = [m.register_forward_pre_hook(hook(n))
               for n, m in model.named_modules()
               if isinstance(m, SubsampledBatchNorm)]
    return found, lambda: [h.remove() for h in handles]


def grad_errors(torch, grads, ref, device) -> dict:
    """Per tensor: max |a − b| / (|b| + max |b|), the per-element error at
    the tensor's scale."""
    return {n: rel_err(g.to(device), ref[n].to(device),
                       float(ref[n].abs().max()) + 1e-30)
            for n, g in grads.items()}


def dp_reference(torch, port, device, work) -> dict:
    """One process's steps on the global batch, written for the ranks with
    the weights and the batch: fp32, recording the ResNet's branches (each
    rank's rows written to ``branches<r>.pt``), and bf16. Returns the
    smallest var/mean² of each BatchNorm's input channels in the fp32
    step's first micro-step."""
    spec = dataclasses.replace(port.ModelSpec.flagship(),
                               textual_dropout=0.0)
    state = drawn_state(torch, port, spec, SEED + 20)
    batch = train_batch(torch, spec, device, SEED + 20)
    ref = {"state": {k: v.cpu() for k, v in state.items()},
           "batch": {k: v.cpu() for k, v in batch.items()}}
    deterministic = torch.backends.cudnn.deterministic
    for dtype in ("float32", "bfloat16"):
        # fp32 with no atomics in cuDNN's backward, on both sides
        torch.backends.cudnn.deterministic = dtype == "float32" \
            or deterministic
        model, _, step = seeded_step(torch, port, dataclasses.replace(
            spec, dtype=dtype), state, SEED + 20)
        if dtype == "float32":
            ratios, unhook = conditioning(torch, model,
                                          port.SubsampledBatchNorm)
            with ResNetBranches(torch) as branches:
                metrics = step(batch)
            unhook()
            for r in range(DP_WORLD):
                rows = slice(r * DP_LOCAL, (r + 1) * DP_LOCAL)
                torch.save(pack_rows(torch, branches.entries, rows),
                           os.path.join(work, f"branches{r}.pt"))
            del branches
            ref[dtype] = {
                "grads": {n: p.grad.cpu()
                          for n, p in model.named_parameters()},
                "buffers": {n: b.cpu() for n, b in model.named_buffers()
                            if n.endswith(("running_mean",
                                           "running_var"))}}
        else:
            metrics = step(batch)
            ref[dtype] = {}
        ref[dtype]["metrics"] = {k: float(v) for k, v in metrics.items()}
        del model, step
    torch.backends.cudnn.deterministic = deterministic
    torch.save(ref, os.path.join(work, "reference.pt"))
    del state, batch, ref
    torch.cuda.empty_cache()
    return ratios


def dp_bn_check(torch, port, mesh, device) -> float:
    """``bn_train`` synced over the ranks, each on its rows of one batch of
    TRAIN_BATCH, against ``bn_train`` on the whole batch in this process,
    fp32 at FINETUNE_K4_SHAPES (K4's vector variants): this rank's dx rows,
    the ranks' dγ and dβ summed, the mean and the variance. The cotangent
    has a mean and a part along x, so that the sums' terms of dx are O(1)
    and a wrong count shows. Returns the largest error at each tensor's
    scale."""
    from virtex_tpu_torch.ops._mesh import kernel_group
    from virtex_tpu_torch.utils import distributed
    rows = slice(mesh.rank * DP_LOCAL, (mesh.rank + 1) * DP_LOCAL)
    worst = 0.0
    for hw, C in FINETUNE_K4_SHAPES:
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 20 + C)

        def draw():
            return torch.randn(TRAIN_BATCH, hw, hw, C, generator=gen,
                               device=device).permute(0, 3, 1, 2)
        x = draw().mul_(2.0).add_(0.5)
        g = draw().add_(1.0).add_(0.5 * x)
        weight = torch.rand(C, generator=gen, device=device) + 0.5
        bias = 0.1 * torch.randn(C, generator=gen, device=device)

        def run(x, g, group):
            x = x.detach().requires_grad_()
            w, b = (t.clone().requires_grad_() for t in (weight, bias))
            with kernel_group(group):
                y, mean, var = port.BN.bn_train(x, w, b, 1e-5,
                                                torch.float32)
                y.backward(g)
            return x.grad, w.grad, b.grad, mean, var

        dx, dw, db, mean, var = run(x, g, None)
        got = run(x[rows], g[rows], mesh.group)
        sums = distributed.all_reduce_sum(torch.stack(got[1:3]), "check")
        for a, b in ((got[0], dx[rows]), (sums[0], dw), (sums[1], db),
                     (got[3], mean), (got[4], var)):
            worst = max(worst, rel_err(a, b, float(b.abs().max())))
        del x, g, dx, got
    torch.cuda.empty_cache()
    return worst


def fp32_errors(torch, model, metrics, want, device) -> dict:
    """A rank's fp32 step against one process's: the largest error of each
    kind at each tensor's scale, and the tensor with the largest gradient
    error."""
    errs = grad_errors(torch, {n: p.grad for n, p in
                               model.named_parameters()},
                       want["grads"], device)
    buffers = dict(model.named_buffers())
    worst = max(errs, key=errs.get)
    l2 = {n: float((p.grad.double() - want["grads"][n].to(device).double())
                   .norm() / want["grads"][n].double().norm().clamp(
                       min=1e-300).to(device))
          for n, p in model.named_parameters()}
    return {"grad_err": errs[worst], "worst": worst,
            "top": sorted(((v, n) for n, v in errs.items()),
                          reverse=True)[:5],
            "grad_l2": max(l2.values()),
            "other_grad_err": max(v for n, v in errs.items()
                                  if not n.startswith("visual.")),
            "buffer_err": max(rel_err(buffers[n], r.to(device),
                                      float(r.abs().max()))
                              for n, r in want["buffers"].items()),
            "loss_err": max(abs(metrics[k] - v) / abs(v)
                            for k, v in want["metrics"].items()
                            if k != "grad_norm"),
            "grads": len(errs), "buffers": len(want["buffers"])}


def reduced_kind(tensor, group) -> str:
    """What an all-reduce carries: the flat gradient buffer, a (2, C)
    BatchNorm tensor, or a scalar or metrics vector."""
    return ("grads" if tensor.numel() > 2**20 else
            "bn (2, C)" if tensor.dim() == 2 else "scalars")


@contextlib.contextmanager
def timed_all_reduces(torch, totals: dict, kind=reduced_kind):
    """Add the host ms spent inside ``torch.distributed.all_reduce`` to
    ``totals`` by ``kind(tensor, group)``, each call after a synchronize,
    so that the wait for the card's queued work is not counted."""
    dist = torch.distributed
    plain = dist.all_reduce

    def timed(tensor, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = plain(tensor, *args, **kwargs)
        kind_ = kind(tensor, kwargs.get("group"))
        totals[kind_] = totals.get(kind_, 0.0) \
            + (time.perf_counter() - t0) * 1e3
        return out

    dist.all_reduce = timed
    try:
        yield
    finally:
        dist.all_reduce = plain


def dp_worker(rank: int, work: str, url: str) -> None:
    """Phase 20(b), one rank: the fp32 and bf16 steps on its shard of the
    global batch from rank 0's weights (fp32 twice: on its own ReLU and
    max-pool choices, then on the one process's), and its dropout stream;
    writes ``rank<r>.json``."""
    import torch
    sys.path.insert(0, REPO)
    port = import_port()
    from virtex_tpu_torch.engine.train_state import step_seed
    from virtex_tpu_torch.parallel import create_mesh, replicate_
    from virtex_tpu_torch.utils import distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(DEVICE)
    torch.cuda.set_device(device)
    distributed.initialize(url, DP_WORLD, rank, backend="gloo")
    mesh = create_mesh()
    ref = torch.load(os.path.join(work, "reference.pt"), weights_only=True)
    rows = slice(rank * DP_LOCAL, (rank + 1) * DP_LOCAL)
    batch = {k: v[:, rows].to(device) for k, v in ref["batch"].items()}
    out = {"rank": rank, "local_batch": int(batch["image"].shape[1])}
    spec = dataclasses.replace(port.ModelSpec.flagship(),
                               textual_dropout=0.0)

    def fresh_step(model):
        opt = port.build_optimizer(model.named_parameters(),
                                   port.OptimSpec.flagship())
        gen = torch.Generator(device=device)
        gen.manual_seed(step_seed(SEED, 0, rank))
        return port.make_train_step(model, opt, ACCUM, generator=gen,
                                    mesh=mesh)

    for name in ("float32", "bfloat16"):
        torch.backends.cudnn.deterministic = name == "float32"
        model = port.PretrainingModelFactory.from_spec(
            dataclasses.replace(spec, dtype=name), DEVICE)
        model.load_state_dict(ref["state"], strict=True)
        if rank:  # other weights, which the broadcast must replace
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(0.5)
        replicate_(model, mesh)
        step = fresh_step(model)
        distributed.reset_all_reduce_counts()
        torch.cuda.synchronize()
        reset_counts()   # a main path starts here
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in step(batch).items()}
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        counts = (raw_counts if name == "float32"
                  else checked_counts)()  # ... and ends here
        res = {"metrics": metrics, "launches": counts,
               "collectives": dict(distributed.all_reduce_counts),
               "first_ms": first_ms}
        if name == "float32":
            res.update(fp32_errors(torch, model, metrics, ref[name], device))
            # Again from the same state, on the one process's branches.
            model.load_state_dict(ref["state"], strict=True)
            step = fresh_step(model)
            saved = unpack_rows(torch, torch.load(
                os.path.join(work, f"branches{rank}.pt"),
                weights_only=True), device)
            with ResNetBranches(torch, saved) as branches:
                pinned = {k: float(v) for k, v in step(batch).items()}
            if branches.at != len(saved):
                fail(f"rank {rank}: the pinned step replayed {branches.at} "
                     f"of {len(saved)} recorded branches")
            res["pinned"] = fp32_errors(torch, model, pinned, ref[name],
                                        device)
            res["flips"], res["branches"] = branches.flips, len(saved)
            del saved, branches
        else:
            res["step_ms"] = host_ms(torch, lambda: step(batch), 1,
                                     warmup=0)
            totals = {}
            with timed_all_reduces(torch, totals):
                res["synced_ms"] = host_ms(torch, lambda: step(batch), 1,
                                           warmup=0)
            res["all_reduce_ms"] = totals
        out[name] = res
        del model, step
        torch.cuda.empty_cache()
    out["bn"] = dp_bn_check(torch, port, mesh, device)
    # The dropout stream: the first seed this rank's generator gives the
    # attention kernels at iteration 1, and K1's and K2's masks at it.
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(SEED, 1, rank))
    seed = torch.randint(2**31 - 1, (), generator=gen, device=device)
    out["keep"] = check_keep_bits(torch, port.A, device, 16, 0.1, seed,
                                  torch.bfloat16)
    out["seed"] = int(seed)
    distributed.synchronize()
    distributed.shutdown()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def bn_after(weight: str) -> str:
    """The BatchNorm that normalises a ResNet conv's output:
    ``...conv1.weight`` → ``...bn1``, ``...downsample.0.weight`` →
    ``...downsample.1``."""
    head = weight.rsplit(".", 1)[0]
    if head.endswith("downsample.0"):
        return head[:-1] + "1"
    stem, _, last = head.rpartition(".")
    return f"{stem}.{last.replace('conv', 'bn')}"


def check_dp_world_2(torch, port, device, step_ms_1):
    """Phase 20(b). Returns the ranks' launches, summed, and its seconds:
    the one process's reference, and the ranks."""
    work = os.path.join(WORK, "dp2")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    ratios = dp_reference(torch, port, device, work)
    ref_b16 = torch.load(os.path.join(work, "reference.pt"),
                         weights_only=True)["bfloat16"]["metrics"]
    t1 = time.perf_counter()
    url = f"file://{os.path.join(work, 'rendezvous')}"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--dp-rank", str(r), work, url], cwd=REPO)
             for r in range(DP_WORLD)]
    try:
        rcs = [p.wait(timeout=DP_TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = {"reference": t1 - t0, "ranks": time.perf_counter() - t1}
    if rcs != [0] * DP_WORLD:
        fail(f"two ranks over gloo: the ranks exited {rcs}")
    ranks = []
    for r in range(DP_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    total = {k: 0 for k in NO_LAUNCHES}
    for o in ranks:
        f32, b16 = o["float32"], o["bfloat16"]
        if f32["launches"] != LAUNCHES_PER_STEP \
                or b16["launches"] != LAUNCHES_PER_STEP:
            fail(f"rank {o['rank']}: a step launched {f32['launches']} in "
                 f"fp32, {b16['launches']} in bf16; expected "
                 f"{LAUNCHES_PER_STEP}")
        if f32["collectives"] != DP_STEP_COLLECTIVES \
                or b16["collectives"] != DP_STEP_COLLECTIVES:
            fail(f"rank {o['rank']}: all-reduces {f32['collectives']}, "
                 f"{b16['collectives']}; expected {DP_STEP_COLLECTIVES}")
        free = {k: f32[k] for k in DP_ERRORS if k != "grad_l2"}
        pinned = {k: f32["pinned"][k] for k in DP_ERRORS}
        if max(free.values()) > DP_FP32_TOL \
                or max(pinned.values()) > DP_FP32_TOL \
                or f32["pinned"]["grad_err"] > DP_SUM_TOL:
            fail(f"rank {o['rank']}, fp32, against one process (tol "
                 f"{DP_FP32_TOL:.0e}): on its own branches {free}; on the "
                 f"one process's {pinned}, per element (tol "
                 f"{DP_SUM_TOL:.0e}) {f32['pinned']['top']}; flips "
                 f"{f32['flips']}")
        if not o["bn"] <= DP_FP32_TOL:
            fail(f"rank {o['rank']}: bn_train synced over the ranks against "
                 f"one process, fp32: {o['bn']:.3e} (tol {DP_FP32_TOL:.0e})")
        gap = max(abs(b16["metrics"][k] - v) / abs(v)
                  for k, v in ref_b16.items() if k != "grad_norm")
        if not gap <= LOSS_RTOL:
            fail(f"rank {o['rank']}, bf16: losses {b16['metrics']} against "
                 f"one process's {ref_b16} (rtol {LOSS_RTOL})")
        for name in ("float32", "bfloat16"):
            total = {k: total[k] + o[name]["launches"][k] for k in total}
    if ranks[0]["float32"]["metrics"] != ranks[1]["float32"]["metrics"]:
        fail("two ranks over gloo: the ranks' metrics differ")
    keep = [port.A.philox_keep_reference(o["seed"], TRAIN_BATCH, 16, 30, 49,
                                         0.1, device=device) for o in ranks]
    if ranks[0]["seed"] == ranks[1]["seed"] or torch.equal(*keep):
        fail(f"the ranks drew one dropout stream: seeds "
             f"{[o['seed'] for o in ranks]}")
    f32, b16 = ranks[0]["float32"], ranks[0]["bfloat16"]

    def worst(key, pinned=False):
        return max((o["float32"]["pinned"] if pinned else o["float32"])[key]
                   for o in ranks)

    low = min(ratios, key=lambda n: ratios[n][0])
    behind = bn_after(f32["worst"])
    behind_text = (f"{behind} {ratios[behind][0]:.3e} (channel "
                   f"{ratios[behind][1]})" if behind in ratios else
                   f"{behind}: not found")
    say("20 data parallel", f"(b) {DP_WORLD} ranks over gloo on one card "
        f"(a CUDA context each), flagship at full width, global batch "
        f"{ACCUM} x {TRAIN_BATCH} = {DP_WORLD} ranks x ({DP_LOCAL} x accum "
        f"{ACCUM}), dropout 0, rank 0's weights broadcast. fp32 (TF32 off) "
        f"against one process on the same global micro-batches, worst over "
        f"the ranks, per element at each tensor's scale (tol "
        f"{DP_FP32_TOL:.0e}): on the ranks' own ReLU and max-pool choices, "
        f"losses {worst('loss_err'):.3e}, {f32['buffers']} BatchNorm "
        f"running buffers {worst('buffer_err'):.3e}, the gradients outside "
        f"the ResNet {worst('other_grad_err'):.3e}, (not held) all "
        f"{f32['grads']} gradients {worst('grad_err'):.3e} at {f32['worst']}"
        f" (relative L2 {worst('grad_l2'):.3e})"
        f"; on the one process's {f32['branches']} recorded choices per "
        f"rank, losses {worst('loss_err', True):.3e}, buffers "
        f"{worst('buffer_err', True):.3e}, all gradients' relative L2 "
        f"{worst('grad_l2', True):.3e}, per element "
        f"{worst('grad_err', True):.3e} at {f32['pinned']['worst']} (tol "
        f"{DP_SUM_TOL:.0e}); "
        f"choices of the one process's that a rank's own values flip "
        f"there: {[o['float32']['flips'] for o in ranks]}. Smallest "
        f"var/mean² over a BatchNorm input's channels (fp64, first "
        f"micro-step of the one process): {ratios[low][0]:.3e} at {low} "
        f"(channel {ratios[low][1]}); at {behind_text}, the BatchNorm after "
        f"the worst gradient. bn_train synced over the ranks against one "
        f"process at {FINETUNE_K4_SHAPES} (fp32, B {TRAIN_BATCH}): "
        f"{max(o['bn'] for o in ranks):.3e}; bf16 loss "
        f"{b16['metrics']['loss']} vs {ref_b16['loss']} (rtol {LOSS_RTOL}); "
        f"launches per rank per step {b16['launches']}; all-reduces per step "
        f"{json.dumps(b16['collectives'])}; dropout 0.1: the ranks' first "
        f"attention seeds {[o['seed'] for o in ranks]}, K1's and K2's keep "
        f"masks equal philox_keep_reference on each rank's seed (keep "
        f"{ranks[0]['keep']:.4f}, {ranks[1]['keep']:.4f}) and differ "
        f"between the ranks")
    say("20 data parallel", f"{card_line()} | bf16 world-2 step over gloo "
        f"(the all-reduces staged through the host; not NCCL's time), host "
        f"ms per step on ranks 0 and 1 (first step, a second): " + "; ".join(
            f"{o['bfloat16']['first_ms']:.1f}, {o['bfloat16']['step_ms']:.1f}"
            for o in ranks)
        + f" | a third step with a synchronize before each all-reduce, its "
        f"ms and the host ms inside the all-reduces by kind: " + "; ".join(
            f"rank {o['rank']} {o['bfloat16']['synced_ms']:.1f} "
            + json.dumps({k: round(v, 1) for k, v in
                          o["bfloat16"]["all_reduce_ms"].items()})
            for o in ranks)
        + f" | phase 9's one-process step of 2 x 128: {step_ms_1:.1f} ms")
    return total, seconds


# -- phase 21 ----------------------------------------------------------------
ZOO_FLAGSHIP = "width_ablations/bicaptioning_R_50_L1_H1024.yaml"
ZOO_R101 = "backbone_ablations/bicaptioning_R_101_L1_H1024.yaml"
# The zoo's architectures that no phase before this one trained on the card,
# each with its ResNet's BatchNorm layers.
ZOO_TRAINED = {"backbone_ablations/bicaptioning_R_101_L1_H1024.yaml": 104,
               "backbone_ablations/bicaptioning_R_50W2X_L1_H1024.yaml": 53,
               "depth_ablations/bicaptioning_R_50_L2_H1024.yaml": 53,
               "depth_ablations/bicaptioning_R_50_L3_H1024.yaml": 53,
               "depth_ablations/bicaptioning_R_50_L4_H1024.yaml": 53,
               "width_ablations/bicaptioning_R_50_L1_H512.yaml": 53,
               "width_ablations/bicaptioning_R_50_L1_H768.yaml": 53}
# Beam captioning runs for the deepest head.
ZOO_BEAM = "depth_ablations/bicaptioning_R_50_L4_H1024.yaml"
# H512's and H768's attention: 8 and 12 heads of 64.
ZOO_HEADS = (8, 12)
# Detectron2's residual blocks (res2..res5) of a ResNet-50 and a ResNet-101.
D2_BLOCKS = {50: 16, 101: 33}


def zoo_eval_launches(spec) -> dict:
    """K1 launches of one eval step: self- and cross-attention in each
    layer, in both caption directions for bicaptioning; none for the
    linear head."""
    k1 = 0 if spec.linear_head else 2 * spec.textual["num_layers"] * (
        2 if spec.caption_backward else 1)
    return {"K1": k1, "K2": 0, "K4": 0, "K4dx": 0}


def zoo_train_step(torch, port, device, rel, model, cfg, n_bn):
    """Phase 21(b) for one architecture: the zoo's model (dropout 0) takes
    one train step at 128 x 2 with the flagship's optimizer against a
    plain-kernel copy, then two timed steps and one under torch.profiler.
    Returns its launches, its BatchNorm input shapes, the host ms per step
    and the peak GiB of the timed steps."""
    A, BN = port.A, port.BN
    t0 = time.perf_counter()
    spec = port.ModelSpec.from_config(cfg)
    layers = spec.textual["num_layers"]
    found = sum(isinstance(m, port.SubsampledBatchNorm)
                for m in model.modules())
    if found != n_bn:
        fail(f"zoo {rel}: {found} BatchNorm layers, expected {n_bn}")
    want = {"K1": 8 * layers, "K2": 8 * layers, "K4": ACCUM * n_bn,
            "K4dx": ACCUM * n_bn}
    optim = port.OptimSpec.flagship()
    plain = plain_copy(model, A, BN, port.MultiHeadAttention,
                       port.SubsampledBatchNorm)
    step = port.make_train_step(
        model, port.build_optimizer(model.named_parameters(), optim), ACCUM)
    plain_step = port.make_train_step(
        plain, port.build_optimizer(plain.named_parameters(), optim), ACCUM)
    batch = train_batch(torch, spec, device, SEED)
    shapes, unhook = bn_shape_counts(model, port.SubsampledBatchNorm)
    reset_counts()             # a main path starts here
    metrics = {k: float(v) for k, v in step(batch).items()}
    torch.cuda.synchronize()
    counts = checked_counts()   # ... and ends here
    unhook()
    if counts != want:
        fail(f"zoo {rel} train step launched {counts}, expected {want}")
    ref = {k: float(v) for k, v in plain_step(batch).items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        fail(f"zoo {rel} train step: non-finite metrics {metrics}")
    for key in ref:
        rtol = GRAD_NORM_RTOL if key == "grad_norm" else LOSS_RTOL
        if not abs(metrics[key] - ref[key]) <= rtol * abs(ref[key]):
            fail(f"zoo {rel} train step: {key} {metrics[key]} with the "
                 f"kernels, {ref[key]} with the plain versions (rtol {rtol})")
    gaps = {k: float(f"{abs(metrics[k] - ref[k]) / abs(ref[k]):.3e}")
            for k in ref}
    del plain, plain_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()             # a main path starts here
    ms = host_ms(torch, lambda: step(batch), 2, warmup=0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    profile = profile_step(torch, lambda: step(batch))
    timed = checked_counts()    # ... and ends here
    if timed != {k: 3 * v for k, v in want.items()}:
        fail(f"zoo {rel}: three more steps launched {timed}")
    say("21 zoo train", f"{rel}: {spec.visual_name} {spec.textual_name} "
        f"{spec.dtype}, micro-batch {TRAIN_BATCH} x accum {ACCUM}, dropout "
        f"0: kernels {json.dumps(metrics)}; relative gaps to the plain "
        f"versions {json.dumps(gaps)}; launches per step {want}; "
        f"{time.perf_counter() - t0:.1f} s in all | {card_line()} | one "
        f"step under torch.profiler: {profile}")
    launches = {k: counts[k] + timed[k] for k in counts}
    return launches, shapes, ms, peak


def check_zoo(torch, port, device, zoo_dir):
    """Phase 21(a) and (b): every zoo entry written as a reference-format
    ``.pth`` (weights drawn on the card from a seed), loaded by ``model_zoo.get(...,
    pretrained=True)`` on the card, bit-equal, and run through the eval
    step; beam captioning for ZOO_BEAM; the ZOO_TRAINED architectures
    through a train step. Keeps the flagship's and R-101's files in
    ``zoo_dir``. Returns the launches, the BatchNorm shapes of the trained
    ResNets, and {entry: (ms, peak GiB)}."""
    zoo = port.model_zoo
    entries = sorted(zoo._MODEL_ZOO_CONFIGS.items(), key=lambda e: e[::-1])
    names = sorted(set(zoo._MODEL_ZOO_CONFIGS.values()))
    keep = {zoo._MODEL_ZOO_CONFIGS[r] for r in (ZOO_FLAGSHIP, ZOO_R101)}
    last = {name: i for i, (_, name) in enumerate(entries)}
    launches = dict(NO_LAUNCHES)
    bn_shapes, train_times, written = {}, {}, {}
    for i, (rel, name) in enumerate(entries):
        # dropout 0 where the entry trains below (it holds no weights)
        overrides = (["MODEL.TEXTUAL.DROPOUT", 0.0] if rel in ZOO_TRAINED
                     else [])
        path = os.path.join(zoo_dir, name + ".pth")
        t0 = time.perf_counter()
        if name not in written:
            # initialised and drawn on the card, which is quicker than
            # drawing on the host
            with torch.device(device):
                model, _ = zoo.get(rel, overrides=overrides)
            card_randomize_(torch, model, SEED + names.index(name))
            written[name] = {k: v.detach().cpu() for k, v in
                             model.state_dict().items()}
            torch.save({"model": written[name]}, path)
            del model
        t1 = time.perf_counter()
        model, cfg = zoo.get(rel, pretrained=True, overrides=overrides)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t1
        if next(model.parameters()).device != device:
            fail(f"model_zoo.get built {rel} on "
                 f"{next(model.parameters()).device}")
        loaded = model.state_dict()
        unequal = [k for k, v in written[name].items()
                   if k not in loaded or not torch.equal(loaded[k].cpu(), v)]
        if sorted(loaded) != sorted(written[name]) or unequal:
            fail(f"zoo {rel}: {len(unequal)} of {len(loaded)} tensors differ "
                 f"from {name}.pth, e.g. {unequal[:3]}")
        spec = port.ModelSpec.from_config(cfg)
        if spec.dtype != "bfloat16":
            fail(f"zoo {rel}: DTYPE {spec.dtype}")
        batch = task_batch(torch, spec, EVAL_BATCH, SEED + i, device)
        want = zoo_eval_launches(spec)
        reset_counts()         # a main path starts here
        losses = {k: float(v)
                  for k, v in port.make_eval_step(model)(batch).items()}
        torch.cuda.synchronize()
        eval_counts = checked_counts()  # ... and ends here
        if eval_counts != want:
            fail(f"zoo {rel} eval step launched {eval_counts}, expected "
                 f"{want}")
        if not all(np.isfinite(v) for v in losses.values()):
            fail(f"zoo {rel} eval step: non-finite losses {losses}")
        launches = {k: launches[k] + eval_counts[k] for k in launches}
        note = ""
        if rel == ZOO_BEAM:
            decoder = port.AutoRegressiveBeamSearch(
                spec.eos_index, spec.max_decoding_steps, spec.beam_size)
            caption_fn = port.make_caption_fn(model, decoder,
                                              spec.sos_index,
                                              spec.prefix_mode)
            reset_counts()     # a main path starts here
            captions = caption_fn(batch["image"])
            torch.cuda.synchronize()
            counts = checked_counts()  # ... and ends here
            if any(counts.values()):
                fail(f"zoo {rel}: beam search launched {counts}")
            lo, hi = int(captions.min()), int(captions.max())
            if tuple(captions.shape) != (EVAL_BATCH, spec.max_decoding_steps) \
                    or lo < 0 or hi >= spec.vocab_size:
                fail(f"zoo {rel}: captions {tuple(captions.shape)}, ids "
                     f"{lo}..{hi}")
            note = (f"; beam K={spec.beam_size} B{EVAL_BATCH}: tokens "
                    f"{tuple(captions.shape)} in [{lo}, {hi}], no launch")
        say("21 zoo", f"{rel}: {name}.pth (written in {t1 - t0:.1f} s) "
            f"loaded by model_zoo.get(..., pretrained=True) on {device} in "
            f"{load_s:.1f} s, all {len(loaded)} tensors "
            f"bit-equal; eval B{EVAL_BATCH} {spec.dtype} "
            f"{json.dumps(losses)}, launches {eval_counts}{note}")
        if rel in ZOO_TRAINED:
            counts, shapes, ms, peak = zoo_train_step(
                torch, port, device, rel, model, cfg, ZOO_TRAINED[rel])
            launches = {k: launches[k] + counts[k] for k in launches}
            bn_shapes[rel] = shapes
            train_times[rel] = (ms, peak)
        del model
        if last[name] == i:
            written.pop(name)
            if name not in keep:
                os.remove(path)
        torch.cuda.empty_cache()
    return launches, bn_shapes, train_times


def zoo_k4_shapes(bn_shapes) -> list:
    """The (H, C) of the trained ResNets' BatchNorms at TRAIN_BATCH that
    phases 5 and 16 do not hold K4 to: those outside ResNet-50's."""
    found = {(s[2], s[1]) for shapes in bn_shapes.values() for s in shapes
             if s[0] == TRAIN_BATCH}
    return sorted(found - set(R50_BN_SHAPES))


def check_zoo_kernels(torch, port, device, bn_shapes):
    """Phase 21(c): K1 and K2 at 8 and 12 heads (B 128, the train step's
    self 30×30 causal + pad and cross 30×49, fp32 and bf16; their keep
    masks bit for bit; K1 also at B 32) and K4's two stages at the new
    ResNet shapes, against their plain versions at phases 3-5's
    tolerances, then timed. Returns the largest absolute bf16 errors of
    K1, K2, K4's sums and dx, and the timings."""
    A, BN = port.A, port.BN
    worst, err = {}, {"K1": 0.0, "K2": 0.0}
    for N in ZOO_HEADS:
        for dtype_name in ("float32", "bfloat16"):
            dtype = getattr(torch, dtype_name)
            tol = TOL[dtype_name]
            for B, kind in ((TRAIN_BATCH, "self"), (TRAIN_BATCH, "cross"),
                            (EVAL_BATCH, "self"), (EVAL_BATCH, "cross")):
                Tk = 30 if kind == "self" else 49
                seed = SEED + 80 + N + B
                q, k, v = attention_inputs(torch, B, 30, Tk, N, 64, dtype,
                                           device, seed, packed=True)
                mask = self_mask(torch, B, 30, device, seed) \
                    if kind == "self" else None
                name = f"{N} heads {kind} B{B} {dtype_name}"
                pairs = [("K1", k1_out(torch, A, name, q, k, v, mask),
                          A.attention_reference(q, k, v, mask))]
                if B == TRAIN_BATCH:
                    g = attention_inputs(torch, B, 30, 30, N, 64, dtype,
                                         device, seed + 1)[0]
                    pairs += [("K2", a, b) for a, b in zip(
                        k2_grads(torch, A, q, k, v, mask, g),
                        A.attention_backward_reference(q, k, v, mask, g))]
                for kernel, got, ref in pairs:
                    e = rel_err(got, ref, ATOL)
                    worst[f"{kernel} {name}"] = max(
                        e, worst.get(f"{kernel} {name}", 0.0))
                    if got.shape != ref.shape or not e <= tol:
                        fail(f"{kernel} {name}: {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)}, error {e:.3e} > {tol:.0e}")
                    if dtype_name == "bfloat16":
                        err[kernel] = max(err[kernel], float(
                            (got.float() - ref.float()).abs().max()))
            check_keep_bits(torch, A, device, N, 0.1, 4321 + N, dtype)
    shapes = zoo_k4_shapes(bn_shapes)
    if not shapes:
        fail("the trained ResNets have no BatchNorm shape beyond "
             "ResNet-50's")
    cases = [(f"{hw}x{hw}x{C}", TRAIN_BATCH, hw, C, "channels_last",
              "bfloat16", "bfloat16") for hw, C in shapes]
    sums_err, dx_err, k4_summary = check_k4(torch, BN, device, cases,
                                            m_total=False)
    summary = ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
    attention_times = {}
    for N in ZOO_HEADS:
        for B, kind in ((TRAIN_BATCH, "self"), (TRAIN_BATCH, "cross"),
                        (EVAL_BATCH, "self"), (EVAL_BATCH, "cross")):
            Tk = 30 if kind == "self" else 49
            q, k, v = attention_inputs(torch, B, 30, Tk, N, 64,
                                       torch.bfloat16, device, SEED,
                                       packed=True)
            g = attention_inputs(torch, B, 30, 30, N, 64, torch.bfloat16,
                                 device, SEED + 1)[0] \
                if B == TRAIN_BATCH else None
            mask = self_mask(torch, B, 30, device, SEED) \
                if kind == "self" else None
            attention_times[(N, kind, B)] = time_attention(torch, A, q, k, v,
                                                           g, mask)
    bn_times = time_bn(torch, BN, device, shapes=shapes)
    return (err["K1"], err["K2"], sums_err, dx_err, summary, k4_summary,
            attention_times, bn_times)


def check_hub(torch, port, device):
    """Phase 21(d): ``resnet50_extractor(pretrained=True)`` through
    ``torch.hub.load(..., source="local")`` from the zoo's flagship
    ``.pth``, on NHWC and NCHW images, bit-equal to ``model_zoo.get``'s
    ``model.visual``; cuDNN deterministic."""
    rng = np.random.RandomState(SEED)
    images = torch.from_numpy(rng.rand(EVAL_BATCH, 224, 224, 3).astype(
        np.float32)).to(device)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        extract = torch.hub.load(os.path.join(REPO, "virtex_tpu_torch"),
                                 "resnet50_extractor", source="local",
                                 pretrained=True)
        nhwc, nchw = extract(images), extract(images.permute(0, 3, 1, 2))
        model, _ = port.model_zoo.get(ZOO_FLAGSHIP, pretrained=True)
        with torch.inference_mode():
            ref = model.visual.eval()(images)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if tuple(nhwc.shape) != (EVAL_BATCH, 7, 7, 2048) \
            or nhwc.device != device:
        fail(f"hub extractor: {tuple(nhwc.shape)} on {nhwc.device}")
    if not torch.equal(nhwc, ref) or not torch.equal(nchw, ref):
        fail("hub extractor: its features are not model.visual's bits "
             f"(NHWC max |diff| {float((nhwc - ref).abs().max()):.3e}, NCHW "
             f"{float((nchw - ref).abs().max()):.3e})")
    say("21 hub", f"torch.hub.load(virtex_tpu_torch, 'resnet50_extractor', "
        f"source='local', pretrained=True): B{EVAL_BATCH} 224² NHWC and "
        f"NCHW → {tuple(nhwc.shape)} {nhwc.dtype} on {nhwc.device}, both "
        f"bit-equal to model_zoo.get('{ZOO_FLAGSHIP}', pretrained=True)'s "
        "model.visual")


def check_detectron2(torch, port, run, zoo_dir):
    """Phase 21(e): eval_detectron2 --weight-init virtex on phase 13's
    checkpoint and on the zoo's R-101 ``.pth``. Without detectron2 each
    writes its ``.pkl``, whose tensors renamed back are the checkpoint's
    ResNet bit for bit."""
    import importlib.util
    import pickle
    if importlib.util.find_spec("detectron2") is not None:
        fail("detectron2 is installed here; phase 21(e) exports only")
    d2 = port.eval_detectron2
    runs = [(os.path.join(REPO, PRETRAIN_CONFIG),
             os.path.join(run, f"checkpoint_{PRETRAIN_ITERS}.pth")),
            (os.path.join(REPO, "configs", ZOO_R101),
             os.path.join(zoo_dir, "bicaptioning_R_101_L1_H1024.pth"))]
    done = []
    for config, ckpt in runs:
        depth = d2.infer_resnet_depth(port.Config(config).MODEL.VISUAL.NAME)
        out = os.path.join(WORK, f"d2_R{depth}")
        t0 = time.perf_counter()
        result, _ = run_cli(d2, ["--config", config, "--weight-init",
                                 "virtex", "--checkpoint-path", ckpt,
                                 "--serialization-dir", out],
                            out + ".log")
        seconds = time.perf_counter() - t0
        with open(result["output"], "rb") as f:
            exported = pickle.load(f)
        if result["results"] is not None or not exported.get(
                "matching_heuristics"):
            fail(f"eval_detectron2 R-{depth}: {sorted(exported)}, results "
                 f"{result['results']}")
        backbone = {k[len("visual.cnn."):]: v for k, v in
                    port.read_checkpoint(ckpt)["model"].items()
                    if k.startswith("visual.cnn.")
                    and not k.endswith("num_batches_tracked")}
        back = {port.detectron2_name(k): k for k in backbone}
        unequal = [k for k, v in exported["model"].items()
                   if k not in back or not np.array_equal(
                       v, backbone[back[k]].float().numpy())]
        if sorted(back) != sorted(exported["model"]) or unequal:
            fail(f"eval_detectron2 R-{depth}: {len(unequal)} exported tensors "
                 f"are not the checkpoint's, e.g. {unequal[:3]}")
        blocks = {".".join(k.split(".")[:2]) for k in exported["model"]
                  if k.startswith("res")}
        if depth not in D2_BLOCKS or len(blocks) != D2_BLOCKS[depth]:
            fail(f"eval_detectron2: depth {depth}, {len(blocks)} blocks")
        done.append(f"R-{depth} from {os.path.relpath(ckpt, REPO)}: "
                    f"{len(exported['model'])} tensors in "
                    f"{len(blocks)} blocks, renamed back bit-equal to the "
                    f"checkpoint's ResNet ({seconds:.1f} s)")
    say("21 detectron2", "python -m virtex_tpu_torch.scripts.eval_detectron2"
        " --weight-init virtex, no detectron2 here so the .pkl is the "
        "result: " + "; ".join(done))


def check_vocabulary(port, root):
    """Phase 21(f): build_vocabulary on phase 13's captions; the port's
    reader loads the JSON ``.model`` and the ``.sp.model`` and encodes
    every caption alike."""
    captions = os.path.join(root, "annotations", "captions_train2017.json")
    prefix = os.path.join(WORK, "vocab", "coco")
    t0 = time.perf_counter()
    paths, _ = run_cli(port.build_vocabulary, ["-c", captions, "-o", prefix],
                       prefix + ".log")
    seconds = time.perf_counter() - t0
    from_json = port.SentencePieceBPETokenizer(paths["model"])
    from_sp = port.SentencePieceBPETokenizer(paths["sp_model"])
    with open(captions) as f:
        texts = [a["caption"] for a in json.load(f)["annotations"]]
    differ = [t for t in texts if from_json.encode(t) != from_sp.encode(t)]
    if differ or not texts:
        fail(f"build_vocabulary: {len(differ)} of {len(texts)} captions "
             f"encode differently from the .sp.model, e.g. {differ[:2]}")
    loaded = sorted(m for m in sys.modules for bad in (
        "transformers", "tokenizers", "sentencepiece")
        if m == bad or m.startswith(bad + "."))
    if loaded:
        fail(f"build_vocabulary imported {loaded}")
    say("21 vocabulary", f"python -m virtex_tpu_torch.scripts."
        f"build_vocabulary on phase 13's {len(texts)} captions in "
        f"{seconds:.2f} s (Python {sys.version.split()[0]}): "
        f"{from_json.get_vocab_size()} pieces; the .model and the .sp.model "
        f"encode all {len(texts)} captions alike; no transformers, "
        "tokenizers or sentencepiece imported; no kernel")


def zoo_timing_lines(card, attention_times, bn_times, train_times):
    lib = (f"library: scaled_dot_product_attention, {SDPA_BACKEND}; K2's: "
           "its aten backward op")
    yield (f"{card} | K1 and K2 at the zoo's head counts, bf16, device ms "
           f"per call ({lib}): " + "; ".join(
               f"{N} heads {kind} B{B} " + ", ".join(
                   f"{kernel} {timing_text(t)}" for kernel, t in
                   times.items())
               for (N, kind, B), times in attention_times.items()))
    for key, title, library in (
            ("sums", "K4 stage 1 (sums)", "torch.batch_norm_backward_reduce"),
            ("dx", "K4 stage 2 (dx)", "torch.batch_norm_backward_elemt")):
        yield (f"{card} | {title} at the wide and deep ResNets' new shapes, "
               f"bf16 B{TRAIN_BATCH}, device ms per call (library: "
               f"{library}): " + "; ".join(
                   f"{hw}x{hw}x{C} {timing_text(t[key])}"
                   for (hw, C), t in bn_times.items()))
    yield (f"{card} | zoo train steps, micro-batch {TRAIN_BATCH} x accum "
           f"{ACCUM}, bf16, host ms per step (mean of two) and peak GiB: "
           + "; ".join(f"{rel.split('/')[1][:-5]} {ms:.1f} ms = "
                       f"{ACCUM * TRAIN_BATCH / ms * 1e3:.1f} img/s, "
                       f"{peak:.2f} GiB"
                       for rel, (ms, peak) in train_times.items()))


def check_phase21(torch, port, device, run, root):
    """Phase 21. Returns its launches and the largest absolute bf16
    errors of K1, K2, K4's sums and dx at its shapes."""
    zoo_dir = os.path.join(WORK, "zoo")
    os.makedirs(zoo_dir, exist_ok=True)
    env = {port.model_zoo.ZOO_DIR_ENV: zoo_dir}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        launches, bn_shapes, train_times = check_zoo(torch, port, device,
                                                     zoo_dir)
        (k1_err, k2_err, sums_err, dx_err, summary, k4_summary,
         attention_times, bn_times) = check_zoo_kernels(torch, port, device,
                                                        bn_shapes)
        say("21 zoo kernels", f"K1 and K2 at {ZOO_HEADS} heads match the "
            f"plain versions (fp32 tol {TOL['float32']:.0e}, bf16 tol "
            f"{TOL['bfloat16']:.0e}, atol {ATOL}), keep masks bit for bit: "
            f"{summary}; K4 at {zoo_k4_shapes(bn_shapes)} (sums/dx errors): "
            f"{k4_summary}")
        card = card_line()
        for line in zoo_timing_lines(card, attention_times, bn_times,
                                     train_times):
            say("21 zoo timings", line)
        check_hub(torch, port, device)
        torch.cuda.empty_cache()
        check_detectron2(torch, port, run, zoo_dir)
        check_vocabulary(port, root)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return launches, (k1_err, k2_err, sums_err, dx_err)


# -- phase 22 ----------------------------------------------------------------
# Tensor parallelism: two gloo ranks on the one card on a mesh of data 1 x
# model 2. Per train step of ACCUM micro-steps, each rank all-reduces: over
# its data group (one rank here) each of the 53 BatchNorm layers' statistics
# and K4's sums and the two caption losses' denominators per micro-step, and
# the gradients and the metrics once; over its model group, per micro-step,
# in each of the two decoders, the backward of the copy on the inputs of its
# four column-split blocks (the self-attention's x, the cross-attention's x
# and visual tokens, the FFN's x) and the forward sums of its three
# row-split blocks (both attentions' out_proj, linear2), and once per step
# the clip's sum of the split gradients' squares:
#   tp_copy = 2 · 4 · ACCUM, tp_reduce = 2 · 3 · ACCUM, grad_norm = 1.
TP_MODEL = 2
TP_HEADS = 16 // TP_MODEL
TP_STEP_COLLECTIVES = {"bn_stats": R50_BN_LAYERS * ACCUM,
                       "bn_sums": R50_BN_LAYERS * ACCUM,
                       "loss_count": 2 * ACCUM,
                       "tp_copy": 2 * 4 * ACCUM, "tp_reduce": 2 * 3 * ACCUM,
                       "grads": 1, "grad_norm": 1, "metrics": 1}
TP_DROPOUT_STEPS = 3
TP_WIDE = "bicaptioning_R_50_L1_H2048"   # A32 F8192: 16 heads per rank
TP_WIDE_TEXTUAL = "transdec_postnorm::L1_H2048_A32_F8192"
TP_SEED_STRIDE = 1000003   # modules/transformer.py SHARD_SEED_STRIDE
# (d): the CLI on phase 13's data, validating and saving every 2 of 4
# iterations, then resumed from 2.
TP_CLI_ITERS, TP_CLI_EVERY = 4, 2
TP_TIMEOUT_S = 600


def tp_model(torch, port, spec, state, mesh, rank):
    """A ``spec`` model on the card from ``state`` (rank 1 from other
    weights, which the broadcast replaces), sliced to this rank's shard,
    and its train step with the flagship's optimizer and a generator."""
    from virtex_tpu_torch.parallel import replicate_, shard_module_
    model = port.PretrainingModelFactory.from_spec(spec, DEVICE)
    model.load_state_dict(state, strict=True)
    if rank:
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(0.5)
    shard_module_(replicate_(model, mesh), mesh)
    opt = port.build_optimizer(model.named_parameters(),
                               port.OptimSpec.flagship(), mesh=mesh)
    gen = torch.Generator(device=DEVICE)
    return model, gen, port.make_train_step(model, opt, ACCUM, generator=gen,
                                            mesh=mesh)


def replicated_unequal(torch, model, mesh) -> list:
    """The names of ``model``'s replicated parameters and buffers whose
    bits differ from model rank 0's (each dtype's tensors broadcast in one
    flat buffer over the model group)."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
    from virtex_tpu_torch.parallel.mesh import tp_split
    by_dtype = {}
    for name, t in itertools.chain(model.named_parameters(),
                                   model.named_buffers()):
        if tp_split(name) is None:
            by_dtype.setdefault(t.dtype, []).append((name, t.detach()))
    bad = []
    for entries in by_dtype.values():
        mine = [t for _, t in entries]
        flat = _flatten_dense_tensors(mine)
        torch.distributed.broadcast(flat, src=0, group=mesh.model_group)
        for (name, _), a, b in zip(entries, mine,
                                   _unflatten_dense_tensors(flat, mine)):
            if not torch.equal(a, b):
                bad.append(name)
    return bad


def tp_cli(torch, port, args: list, mesh) -> dict:
    """``pretrain_virtex`` on this rank, its launches per train and eval
    step, and whether the model's shards at the end equal the slices of
    the last checkpoint."""
    from virtex_tpu_torch.parallel.mesh import shard_state_dict
    cli = port.pretrain
    made = []
    plain_shard = cli.shard_module_

    def recorded(model, mesh):
        made.append(plain_shard(model, mesh))
        return made[-1]

    cli.shard_module_ = recorded
    steps, evals = [], []
    try:
        result = run_pretrain(torch, port, args, steps, evals)
    finally:
        cli.shard_module_ = plain_shard
    run = args[args.index("--serialization-dir") + 1]
    full = port.read_checkpoint(os.path.join(
        run, f"checkpoint_{TP_CLI_ITERS}.pth"), map_location=DEVICE)["model"]
    own = made[0].state_dict()
    sliced = shard_state_dict(full, mesh)
    unequal = [k for k, v in own.items() if not torch.equal(v, sliced[k])]
    return {"losses": result["losses"], "val": result["val"],
            "steps": steps, "evals": evals, "unequal": unequal,
            "tensors": len(own)}


def tp_worker(rank: int, work: str, url: str) -> None:
    """Phase 22, one rank of data 1 × model 2; writes ``rank<r>.json``."""
    import torch
    sys.path.insert(0, REPO)
    port = import_port()
    from virtex_tpu_torch.engine.train_state import step_seed
    from virtex_tpu_torch.parallel import create_mesh
    from virtex_tpu_torch.parallel.mesh import gather_tensor
    from virtex_tpu_torch.utils import distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(DEVICE)
    torch.cuda.set_device(device)
    distributed.initialize(url, TP_MODEL, rank, backend="gloo")
    mesh = create_mesh(1, TP_MODEL)
    ref = torch.load(os.path.join(WORK, "dp2", "reference.pt"),
                     weights_only=True)
    batch = {k: v.to(device) for k, v in ref["batch"].items()}
    spec = dataclasses.replace(port.ModelSpec.flagship(), textual_dropout=0.0)
    out = {"rank": rank, "model_rank": mesh.model_rank, "seconds": {}}
    mark = [time.perf_counter()]

    def lap(part):
        now = time.perf_counter()
        out["seconds"][part] = now - mark[0]
        mark[0] = now

    # (a) fp32 against one process
    torch.backends.cudnn.deterministic = True
    model, gen, step = tp_model(torch, port, dataclasses.replace(
        spec, dtype="float32"), ref["state"], mesh, rank)
    gen.manual_seed(step_seed(SEED, 0, mesh.data_rank))
    distributed.reset_all_reduce_counts()
    torch.cuda.synchronize()
    reset_counts()   # a main path starts here
    metrics = {k: float(v) for k, v in step(batch).items()}
    torch.cuda.synchronize()
    counts = raw_counts()   # ... and ends here
    collectives = dict(distributed.all_reduce_counts)
    grads = {n: gather_tensor(n, p.grad, mesh, "check")
             for n, p in model.named_parameters()}
    want = ref["float32"]
    errs = grad_errors(torch, grads, want["grads"], device)
    buffers = dict(model.named_buffers())
    worst = max(errs, key=errs.get)
    out["float32"] = {
        "metrics": metrics, "launches": counts, "collectives": collectives,
        "grad_err": errs[worst], "worst": worst, "grads": len(errs),
        "buffer_err": max(rel_err(buffers[n], r.to(device),
                                  float(r.abs().max()))
                          for n, r in want["buffers"].items()),
        "loss_err": max(abs(metrics[k] - v) / abs(v)
                        for k, v in want["metrics"].items())}
    del model, step, grads
    torch.cuda.empty_cache()
    lap("a")

    # (b) bf16 at dropout 0.1: replicated tensors bit-equal, seeds apart
    torch.backends.cudnn.deterministic = True
    model, gen, step = tp_model(torch, port, port.ModelSpec.flagship(),
                                ref["state"], mesh, rank)
    attn = model.textual.transformer.layers[0].self_attn
    plain_fn, seeds = attn.attention_fn, []

    def recorded(q, k, v, mask, dropout_rate=0.0, dropout_seed=None):
        if dropout_seed is not None and not seeds:
            seeds.append(int(dropout_seed))
        return plain_fn(q, k, v, mask, dropout_rate=dropout_rate,
                        dropout_seed=dropout_seed)

    attn.attention_fn = recorded
    b16 = {"metrics": [], "unequal": [], "launches": []}
    for it in range(1, TP_DROPOUT_STEPS + 1):
        gen.manual_seed(step_seed(SEED, it, mesh.data_rank))
        distributed.reset_all_reduce_counts()
        torch.cuda.synchronize()
        reset_counts()   # a main path starts here
        metrics = {k: float(v) for k, v in step(batch).items()}
        torch.cuda.synchronize()
        b16["launches"].append(checked_counts())  # ends here
        if it == 1:
            b16["collectives"] = dict(distributed.all_reduce_counts)
        b16["metrics"].append(metrics)
        b16["unequal"].append(replicated_unequal(torch, model, mesh))
    b16["seed"] = seeds[0]
    b16["keep"] = check_keep_bits(torch, port.A, device, TP_HEADS, 0.1,
                                  seeds[0], torch.bfloat16)
    attn.attention_fn = plain_fn
    b16["step_ms"] = host_ms(torch, lambda: step(batch), 1, warmup=0)
    totals = {}
    model_group = mesh.model_group

    def kind(tensor, group):
        return ("model group" if group is model_group else
                "data group, grads" if tensor.numel() > 2**20 else
                "data group, other")
    with timed_all_reduces(torch, totals, kind):
        b16["synced_ms"] = host_ms(torch, lambda: step(batch), 1, warmup=0)
    b16["all_reduce_ms"] = totals
    out["bfloat16"] = b16
    del model, step
    torch.cuda.empty_cache()
    lap("b")

    # (c) the H2048 head, 16 heads per rank
    wide = dataclasses.replace(port.ModelSpec.flagship(),
                               textual_name=TP_WIDE_TEXTUAL,
                               textual_dropout=0.0)
    state = drawn_state(torch, port, wide, SEED + 22, card_randomize_)
    wbatch = train_batch(torch, wide, device, SEED + 22)
    model, gen, step = tp_model(torch, port, wide, state, mesh, rank)
    del state
    gen.manual_seed(step_seed(SEED, 0, mesh.data_rank))
    torch.cuda.synchronize()
    reset_counts()   # a main path starts here
    metrics = {k: float(v) for k, v in step(wbatch).items()}
    torch.cuda.synchronize()
    out["wide"] = {"metrics": metrics,
                   "launches": checked_counts()}  # ends here
    del model, step, wbatch
    torch.cuda.empty_cache()
    lap("c")

    # (d) the CLI, and its resume
    with open(os.path.join(work, "cli_args.json")) as f:
        base = json.load(f)
    runs = {}
    for name, extra in (("unbroken", []), ("resumed", [
            "--resume-from", os.path.join(work, "cli_unbroken",
                                          f"checkpoint_{TP_CLI_EVERY}.pth")])):
        runs[name] = tp_cli(torch, port, base + [
            "--serialization-dir", os.path.join(work, f"cli_{name}"),
            *extra], mesh)
    out["cli"] = runs
    lap("d")
    distributed.synchronize()
    distributed.shutdown()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def tp_reference(torch, port, device) -> dict:
    """One process's bf16 step of the H2048 model at dropout 0 on (c)'s
    weights and batch: its metrics."""
    wide = dataclasses.replace(port.ModelSpec.flagship(),
                               textual_name=TP_WIDE_TEXTUAL,
                               textual_dropout=0.0)
    state = drawn_state(torch, port, wide, SEED + 22, card_randomize_)
    batch = train_batch(torch, wide, device, SEED + 22)
    model, gen, step = seeded_step(torch, port, wide, state, SEED)
    del state
    metrics = {k: float(v) for k, v in step(batch).items()}
    del model, step, batch
    torch.cuda.empty_cache()
    return metrics


def check_tp(torch, port, device, pretrain_args):
    """Phase 22. Returns the ranks' counted launches, summed, and its
    seconds: the one process's reference, and the ranks."""
    work = os.path.join(WORK, "tp")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    ref_wide = tp_reference(torch, port, device)
    ref = torch.load(os.path.join(WORK, "dp2", "reference.pt"),
                     weights_only=True)["float32"]["metrics"]
    base = [a for a in pretrain_args] + [
        "OPTIM.NUM_ITERATIONS", str(TP_CLI_ITERS), "PARALLEL.MODEL",
        str(TP_MODEL), "--checkpoint-every", str(TP_CLI_EVERY)]
    with open(os.path.join(work, "cli_args.json"), "w") as f:
        json.dump(base, f)
    t1 = time.perf_counter()
    url = f"file://{os.path.join(work, 'rendezvous')}"
    logs = [open(os.path.join(work, f"rank{r}.log"), "w")
            for r in range(TP_MODEL)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--tp-rank", str(r), work, url], cwd=REPO,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(TP_MODEL)]
    try:
        rcs = [p.wait(timeout=TP_TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    seconds = {"reference": t1 - t0, "ranks": time.perf_counter() - t1}
    if rcs != [0] * TP_MODEL:
        tails = []
        for r in range(TP_MODEL):
            with open(os.path.join(work, f"rank{r}.log")) as f:
                tails.append(f"rank {r}: {f.read()[-3000:]}")
        fail(f"tensor parallel: the ranks exited {rcs}\n" + "\n".join(tails))
    ranks = []
    for r in range(TP_MODEL):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    total = {k: 0 for k in NO_LAUNCHES}
    for o in ranks:
        f32, b16, wide, cli = (o["float32"], o["bfloat16"], o["wide"],
                               o["cli"])
        for what, got in (("fp32 step", f32["launches"]),
                          *(("bf16 step", c) for c in b16["launches"]),
                          ("H2048 step", wide["launches"])):
            if got != LAUNCHES_PER_STEP:
                fail(f"rank {o['rank']}: the {what} launched {got}; "
                     f"expected {LAUNCHES_PER_STEP}")
        if f32["collectives"] != TP_STEP_COLLECTIVES \
                or b16["collectives"] != TP_STEP_COLLECTIVES:
            fail(f"rank {o['rank']}: all-reduces {f32['collectives']}, "
                 f"{b16['collectives']}; expected {TP_STEP_COLLECTIVES}")
        errs = {k: f32[k] for k in ("grad_err", "buffer_err", "loss_err")}
        if max(errs.values()) > DP_FP32_TOL:
            fail(f"rank {o['rank']}, fp32, against one process (tol "
                 f"{DP_FP32_TOL:.0e}): {errs} (worst gradient "
                 f"{f32['worst']})")
        if any(b16["unequal"]):
            fail(f"rank {o['rank']}: replicated tensors differ from model "
                 f"rank 0's after the bf16 dropout steps: {b16['unequal']}")
        gap = max(abs(wide["metrics"][k] - v) / abs(v)
                  for k, v in ref_wide.items() if k != "grad_norm")
        if not gap <= LOSS_RTOL:
            fail(f"rank {o['rank']}, H2048 bf16: losses {wide['metrics']} "
                 f"against one process's {ref_wide} (rtol {LOSS_RTOL})")
        for name, run in cli.items():
            if any(c != LAUNCHES_PER_STEP for c in run["steps"]) \
                    or not run["steps"]:
                fail(f"rank {o['rank']}, CLI {name}: train steps launched "
                     f"{run['steps']}")
            check_evals(f"rank {o['rank']}, CLI {name}", run["evals"])
            if run["unequal"]:
                fail(f"rank {o['rank']}, CLI {name}: its shards differ "
                     f"from the last checkpoint's slices: "
                     f"{run['unequal'][:4]}")
        counted = [f32["launches"], *b16["launches"], wide["launches"]] \
            + [c for run in cli.values() for c in run["steps"]
               + [{k: e[k] for k in NO_LAUNCHES} for e in run["evals"]]]
        for c in counted:
            total = {k: total[k] + c[k] for k in total}
    r0, r1 = ranks
    for key in ("float32", "bfloat16", "wide"):
        if r0[key]["metrics"] != r1[key]["metrics"]:
            fail(f"tensor parallel, {key}: the ranks' metrics differ: "
                 f"{r0[key]['metrics']} vs {r1[key]['metrics']}")
    s0, s1 = r0["bfloat16"]["seed"], r1["bfloat16"]["seed"]
    if s1 - s0 != TP_SEED_STRIDE * (r1["model_rank"] - r0["model_rank"]):
        fail(f"tensor parallel: first attention seeds {s0}, {s1}; expected "
             f"them {TP_SEED_STRIDE} apart")
    keep = [port.A.philox_keep_reference(s, TRAIN_BATCH, TP_HEADS, 30, 49,
                                         0.1, device=device)
            for s in (s0, s1)]
    if torch.equal(*keep):
        fail("tensor parallel: the two shards drew one keep mask")
    runs = r0["cli"]
    unbroken, resumed = runs["unbroken"], runs["resumed"]
    if r0["cli"]["unbroken"]["losses"] != r1["cli"]["unbroken"]["losses"]:
        fail("tensor parallel CLI: the ranks' losses differ")
    if sorted(unbroken["val"], key=int) != [str(TP_CLI_EVERY),
                                            str(TP_CLI_ITERS)] \
            or not all(np.isfinite(v["loss"])
                       for v in unbroken["val"].values()):
        fail(f"tensor parallel CLI: validation {unbroken['val']}")
    late = {k: v for k, v in unbroken["losses"].items()
            if int(k) > TP_CLI_EVERY}
    if resumed["losses"] != late:
        fail(f"tensor parallel CLI: resumed losses {resumed['losses']} vs "
             f"unbroken {late}")
    last = f"checkpoint_{TP_CLI_ITERS}.pth"
    a = flat_state(port, os.path.join(work, "cli_unbroken", last))
    b = flat_state(port, os.path.join(work, "cli_resumed", last))
    unequal = [k for k in a if k not in b or not torch.equal(a[k], b[k])]
    if sorted(a) != sorted(b) or unequal:
        fail(f"tensor parallel CLI: {len(unequal)} of {len(a)} tensors of "
             f"the resumed {last} differ from the unbroken run's, e.g. "
             f"{unequal[:4]}")
    one = port.PretrainingModelFactory.from_spec(port.ModelSpec.flagship(),
                                                 DEVICE)
    one.load_state_dict(port.read_checkpoint(
        os.path.join(work, "cli_unbroken", last))["model"], strict=True)
    del one
    torch.cuda.empty_cache()
    f32, b16 = r0["float32"], r0["bfloat16"]

    def worst(key):
        return max(o["float32"][key] for o in ranks)

    say("22 tensor parallel", f"(a) data 1 x model {TP_MODEL} over gloo on "
        f"one card (a CUDA context each), flagship at full width, {TP_HEADS}"
        f" of 16 heads and 2048 of 4096 FFN columns per rank, one step of "
        f"{ACCUM} x {TRAIN_BATCH}, dropout 0, rank 0's weights broadcast, "
        f"fp32 (TF32 off, cuDNN deterministic) against phase 20(b)'s one "
        f"process (tol {DP_FP32_TOL:.0e} per element at each tensor's "
        f"scale): losses and grad_norm {worst('loss_err'):.3e}, BatchNorm "
        f"buffers {worst('buffer_err'):.3e}, all {f32['grads']} gradients "
        f"gathered to full names {worst('grad_err'):.3e} (worst "
        f"{f32['worst']}); loss {f32['metrics']['loss']} vs {ref['loss']}; "
        f"launches per rank {f32['launches']}; all-reduces per step "
        f"{json.dumps(f32['collectives'])}")
    say("22 tensor parallel", f"(b) bf16, dropout 0.1, {TP_DROPOUT_STEPS} "
        f"steps: every replicated parameter and buffer bit-equal on the two "
        f"ranks after each, losses bit-equal "
        f"{[m['loss'] for m in b16['metrics']]}; first attention seeds "
        f"{s0}, {s1} ({TP_SEED_STRIDE} apart), each rank's K1 and K2 keep "
        f"masks at {TP_HEADS} heads equal philox_keep_reference on its seed "
        f"(keep {r0['bfloat16']['keep']:.4f}, {r1['bfloat16']['keep']:.4f}) "
        f"and differ between the ranks; launches per rank per step "
        f"{b16['launches'][0]} (all {TP_DROPOUT_STEPS}). (c) {TP_WIDE} (16 of 32 heads per rank), bf16, "
        f"dropout 0: loss {r0['wide']['metrics']['loss']} vs one process's "
        f"{ref_wide['loss']} (rtol {LOSS_RTOL}); launches "
        f"{r0['wide']['launches']}. (d) python -m virtex_tpu_torch.scripts."
        f"pretrain_virtex PARALLEL.MODEL {TP_MODEL} on phase 13's data, "
        f"{TP_CLI_ITERS} iterations: losses "
        f"{json.dumps(unbroken['losses'])}, validation at {TP_CLI_EVERY} "
        f"and {TP_CLI_ITERS}; rank 0's {last} loads into one process and "
        f"its slices equal each rank's {unbroken['tensors']} tensors bit for "
        f"bit; resumed from {TP_CLI_EVERY}, all {len(a)} model and "
        f"optimizer tensors of {last} bit-equal to the unbroken run's")
    say("22 tensor parallel", f"{card_line()} | bf16 TP step of {ACCUM} x "
        f"{TRAIN_BATCH} over gloo (the all-reduces staged through the host; "
        f"not NCCL's time), host ms on ranks 0 and 1: " + "; ".join(
            f"{o['bfloat16']['step_ms']:.1f}" for o in ranks)
        + " | a step with a synchronize before each all-reduce, its ms and "
        "the host ms inside the all-reduces by group: " + "; ".join(
            f"rank {o['rank']} {o['bfloat16']['synced_ms']:.1f} "
            + json.dumps({k: round(v, 1) for k, v in
                          o["bfloat16"]["all_reduce_ms"].items()})
            for o in ranks)
        + " | the ranks' seconds by part (after starting up): " + "; ".join(
            json.dumps({k: round(v, 1) for k, v in o["seconds"].items()})
            for o in ranks))
    return total, seconds


# -- phase 23 ----------------------------------------------------------------
# (a) The five task ablations at full width (R-50 at 224², the H2048 head),
# each on a .pth drawn on the card; the card's results held on the CPU.
BITCHECK_CONFIGS = {
    "task_ablations/bicaptioning_R_50_L1_H2048.yaml":
        {"K1": 4, "K2": 4, "K4": 53, "K4dx": 53},
    "task_ablations/captioning_R_50_L1_H2048.yaml":
        {"K1": 2, "K2": 2, "K4": 53, "K4dx": 53},
    "task_ablations/masked_lm_R_50_L1_H2048.yaml":
        {"K1": 2, "K2": 2, "K4": 53, "K4dx": 53},
    "task_ablations/token_classification_R_50.yaml":
        {"K1": 0, "K2": 0, "K4": 53, "K4dx": 53},
    "task_ablations/multilabel_classification_R_50.yaml":
        {"K1": 0, "K2": 0, "K4": 53, "K4dx": 53},
}
# (b) The JAX package's results on the golden's numpy-drawn .pth files
# (resnet18 at 64²: 20 BatchNorms), written on the CPU by
# tests/torch_bitcheck_jax.py --golden.
BITCHECK_GOLDEN = os.path.join("tests", "fixtures",
                               "torch_bitcheck_golden.npz")
GOLDEN_BN_LAYERS = 20


def bitcheck_run(port, argv: list, log_path: str):
    """``feature_bitcheck.main(argv)``, its output to ``log_path``; returns
    the exit code and, where the train-mode checks ran again on other ReLU
    sides, how they were chosen and the input gradient's error there."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port.feature_bitcheck.main(argv)
    with open(log_path, "w") as f:
        f.write(out.getvalue())
    rerun = re.search(r"\[PASS\] d\(loss\)/d\(image\) \((.*)\): "
                      r"err=(\S+)", out.getvalue())
    return rc, rerun and (rerun.group(1), float(rerun.group(2)))


def key_errors(port, path: str, ref_path: str, task: str) -> dict:
    """The per-element error of each result of ``task`` in ``path``
    against ``ref_path`` (feature_bitcheck's metric)."""
    fb = port.feature_bitcheck
    mine, _ = fb.load_reference(path, task)
    ref, _ = fb.load_reference(ref_path, task)
    return {k: fb.channel_error(mine[k], ref[k]) for k in sorted(ref)}


def check_bitcheck_full(torch, port, device, work):
    """Phase 23(a). Returns its launches and each task's largest errors."""
    fb = port.feature_bitcheck
    launches = dict(NO_LAUNCHES)
    errors = {}
    for i, rel in enumerate(BITCHECK_CONFIGS):
        stem = os.path.splitext(os.path.basename(rel))[0]
        config = os.path.join("configs", rel)
        torch.manual_seed(SEED + 23 + i)    # card_randomize_ keeps the
        model, cfg = port.model_zoo.get(    # init's mean and spread
            rel, overrides=fb.FORCED_OVERRIDES, device=DEVICE)
        card_randomize_(torch, model, SEED + 23 + i)
        pth = os.path.join(work, f"{stem}.pth")
        torch.save({"model": model.state_dict()}, pth)
        task = cfg.MODEL.NAME
        del model
        torch.cuda.empty_cache()
        card_npz = os.path.join(work, f"{stem}_card.npz")
        cpu_npz = os.path.join(work, f"{stem}_cpu.npz")
        common = ["--config", config, "--checkpoint-path", pth]
        reset_counts()       # a main path starts here
        rc, _ = bitcheck_run(port, common + ["--device", DEVICE, "--write",
                                             card_npz],
                             os.path.join(work, f"{stem}_card.log"))
        torch.cuda.synchronize()
        counts = raw_counts()  # ... and ends here
        if rc != 0:
            fail(f"feature_bitcheck on the card, {stem}: exit {rc} "
                 f"(log {work})")
        if counts != BITCHECK_CONFIGS[rel]:
            fail(f"feature_bitcheck on the card, {stem}: launches {counts}, "
                 f"expected {BITCHECK_CONFIGS[rel]}")
        launches = {k: launches[k] + counts[k] for k in launches}
        rc, sides = bitcheck_run(port, common + [
            "--device", "cpu", "--write", cpu_npz, "--against", card_npz],
            os.path.join(work, f"{stem}_cpu.log"))
        if rc != 0:
            with open(os.path.join(work, f"{stem}_cpu.log")) as f:
                fail(f"feature_bitcheck, the CPU held to the card, {stem}: "
                     f"exit {rc}:\n{f.read()[-3000:]}")
        errors[stem] = (key_errors(port, cpu_npz, card_npz, task), sides,
                        counts)
        os.remove(pth)
    return launches, errors


def check_bitcheck_golden(torch, port, device, work):
    """Phase 23(b). Returns its launches and each task's largest errors
    against the JAX package."""
    fb = port.feature_bitcheck
    with np.load(os.path.join(REPO, BITCHECK_GOLDEN)) as f:
        golden = {k: f[k] for k in f.files}
    tasks = sorted(k.split("/")[0] for k in golden if k.endswith("/config"))
    launches = dict(NO_LAUNCHES)
    errors = {}
    for task in tasks:
        config = str(golden[f"{task}/config"])
        overrides = [str(v) for v in golden[f"{task}/overrides"]]
        seed, batch = int(golden[f"{task}/seed"]), int(
            golden[f"{task}/batch_size"])
        pth = os.path.join(work, f"golden_{task}.pth")
        sha = fb.write_checkpoint(os.path.join(REPO, config), overrides,
                                  seed, pth)
        if sha != str(golden[f"{task}/checkpoint_sha256"]):
            fail(f"the golden's {task} .pth drew another sha256 on this "
                 f"machine: {sha}")
        card_npz = os.path.join(work, f"golden_{task}_card.npz")
        reset_counts()       # a main path starts here
        rc, sides = bitcheck_run(port, [
            "--config", config, "--config-override", *overrides,
            "--checkpoint-path", pth, "--seed", str(seed),
            "--batch-size", str(batch), "--device", DEVICE,
            "--write", card_npz, "--against", BITCHECK_GOLDEN],
            os.path.join(work, f"golden_{task}.log"))
        torch.cuda.synchronize()
        counts = raw_counts()  # ... and ends here
        if rc != 0:
            with open(os.path.join(work, f"golden_{task}.log")) as f:
                fail(f"feature_bitcheck, the card held to the JAX package's "
                     f"golden, {task}: exit {rc}:\n{f.read()[-3000:]}")
        if counts["K4"] < GOLDEN_BN_LAYERS or counts["K4dx"] < \
                GOLDEN_BN_LAYERS:
            fail(f"feature_bitcheck on the card, golden {task}: launches "
                 f"{counts}, expected {GOLDEN_BN_LAYERS} of each K4 stage "
                 "or more")
        launches = {k: launches[k] + counts[k] for k in launches}
        errors[task] = (key_errors(port, card_npz,
                                   os.path.join(REPO, BITCHECK_GOLDEN),
                                   task), sides, counts)
    return launches, errors


def check_rehearsal(torch, port, device, work):
    """Phase 23(c). Returns its launches and the steps' seconds."""
    log = os.path.join(work, "rehearsal.log")
    out = io.StringIO()
    reset_counts()           # a main path starts here
    try:
        with contextlib.redirect_stdout(out):
            summary = port.reproduce_parity.rehearse(
                ["--device", DEVICE, "--workdir",
                 os.path.join(work, "parity")])
    except port.reproduce_parity.StepFailed as e:
        with open(log, "w") as f:
            f.write(out.getvalue())
        fail(f"the synthetic rehearsal failed: {e}:\n"
             f"{out.getvalue()[-3000:]}")
    torch.cuda.synchronize()
    counts = raw_counts()    # ... and ends here
    with open(log, "w") as f:
        f.write(out.getvalue())
    text = out.getvalue()
    for want in ("rehearsal complete", "feature_bitcheck: PASS"):
        if want not in text:
            fail(f"the synthetic rehearsal printed no {want!r} ({log})")
    if text.count("tokenizer_selfcheck: PASS") != 2:
        fail(f"the synthetic rehearsal's tokenizer self-checks ({log})")
    if min(counts.values()) == 0:
        fail(f"the synthetic rehearsal launched {counts}: every kernel "
             "runs in its pretraining")
    return counts, summary


def error_text(errors: dict) -> str:
    return "; ".join(
        f"{name} " + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + (f" (dimage {sides[1]:.3e} with {sides[0]})" if sides else "")
        + f", launches {json.dumps(counts)}"
        for name, (errs, sides, counts) in errors.items())


def check_phase23(torch, port, device):
    """Phase 23. Returns its launches, summed."""
    fb = port.feature_bitcheck
    work = os.path.join(WORK, "bitcheck")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    full_counts, full = check_bitcheck_full(torch, port, device, work)
    t1 = time.perf_counter()
    say("23 bitcheck", f"{card_line()} | (a) python -m virtex_tpu_torch."
        f"scripts.feature_bitcheck on the five task ablations at full width "
        f"(R-50 at 224², L1_H2048_A32_F8192, B 2, fp32 with TF32 off, "
        f"dropout 0), each on a .pth drawn on the card: the card's grid, "
        f"losses and d(loss)/d(image) written, the CPU held to them (gates "
        f"{fb.GRID_TOL:.0e} grid, {fb.LOSS_TOL:.0e} losses, "
        f"{fb.GRAD_TOL:.0e} dimage, per element at its channel's scale), "
        f"the CPU's largest errors per key: {error_text(full)}; "
        f"{t1 - t0:.1f} s")
    golden_counts, golden = check_bitcheck_golden(torch, port, device, work)
    t2 = time.perf_counter()
    say("23 bitcheck", f"{card_line()} | (b) the card against the JAX "
        f"package's results ({BITCHECK_GOLDEN}: resnet18 at 64², "
        f"L1_H128_A4_F256, B 2, each on the numpy-drawn .pth whose sha256 "
        f"it pins), largest errors per key: {error_text(golden)}; "
        f"{t2 - t1:.1f} s")
    rehearsal_counts, summary = check_rehearsal(torch, port, device, work)
    t3 = time.perf_counter()
    say("23 rehearsal", f"{card_line()} | (c) python -m virtex_tpu_torch."
        f"scripts.reproduce_parity (synthetic, on {DEVICE}): every step "
        f"passed, seconds " + json.dumps(
            {k: round(v, 2) for k, v in summary["seconds"].items()})
        + f"; eval_captioning {json.dumps(summary['eval_captioning']['metrics'])}"
        f", VOC07 mAP {summary['clf_voc07']['mAP']:.2f}, top-1 "
        f"{summary['clf_linear']['value']:.2f}; launches "
        f"{json.dumps(rehearsal_counts)}; {t3 - t2:.1f} s | phase 23 "
        f"{t3 - t0:.1f} s")
    return {k: full_counts[k] + golden_counts[k] + rehearsal_counts[k]
            for k in NO_LAUNCHES}


# -- phase 24 ----------------------------------------------------------------
# The end-to-end learning proof (virtex_tpu_torch/scripts/quality_proxy.py).
# (a) K1 and K2 at the proxy's head, L1_H128_A4: 4 heads of 32, bf16 and
# fp32. (B, Tq, Tk): the captions' self-attention (30 tokens; 16 in the
# overfit) and the cross-attention to resnet18's grid, 4x4 = 16 tokens at
# 128² and 2x2 = 4 at 64²; B 16 is the proxy's micro-batch at accumulation
# 2 and its last validation batch, 32 its batch at accumulation 1 and its
# first validation batch, 8 the overfit's batch. Then K1 at the full-width
# proxy's one validation batch of 48 (16 heads of 64, as phase 3's).
PROXY_HEADS, PROXY_HEAD_DIM = 4, 32
PROXY_ATTENTION = [(B, 30, Tk) for B in (16, 32) for Tk in (30, 16, 4)] \
    + [(8, 16, 16), (8, 16, 4)]
PROXY_KEEP_SHAPES = [(16, 30, 16), (8, 16, 4)]   # dropout 0.1 bit for bit
FULL_VAL_BATCH = 48
# K4's two stages at resnet18's BatchNorm shapes, (H, C) by image side,
# at the batches each side runs: 128² at the proxy's micro-batches, 64² at
# the overfit's 8 (its smallest M: 2·2·8 = 32 rows).
RESNET18_BN_SHAPES = {128: [(64, 64), (32, 64), (16, 128), (8, 256),
                            (4, 512)],
                      64: [(32, 64), (16, 64), (8, 128), (4, 256),
                           (2, 512)]}
PROXY_K4_BATCHES = {128: (16, 32), 64: (8,)}
RESNET18_BN_LAYERS = 20
# (b)-(d): the overfit, the JAX proxy's recipe at accumulation 2, and the
# proxy at the flagship's widths. Launches per train step of a
# bicaptioning L1 head: self- and cross-attention in two directions per
# micro-step (K1 and K2), and both K4 stages per BatchNorm per micro-step;
# per validation eval step EVAL_LAUNCHES, and 4 K1 more for the
# validation's logged predictions (one forward of the first batch).
PROXY_ACCUM = 2
PROXY_RECIPE_ITERATIONS = 400
FULL_ITERATIONS = 100


def step_launches(accum: int, bn_layers: int) -> dict:
    return {"K1": 4 * accum, "K2": 4 * accum, "K4": bn_layers * accum,
            "K4dx": bn_layers * accum}


def proxy_attention_cases(torch, dtype, device, seed):
    """Phase 24(a)'s K1/K2 operands: (name, q, k, v, g, mask), q/k/v
    strided views of one projection as ``MultiHeadAttention`` passes
    them."""
    N, D = PROXY_HEADS, PROXY_HEAD_DIM
    for i, (B, Tq, Tk) in enumerate(PROXY_ATTENTION):
        q, k, v = attention_inputs(torch, B, Tq, Tk, N, D, dtype, device,
                                   seed + i, packed=True)
        g = attention_inputs(torch, B, Tq, Tq, N, D, dtype, device,
                             seed + 50 + i)[0]
        mask = self_mask(torch, B, Tq, device, seed + i) if Tq == Tk \
            else None
        kind = "self" if Tq == Tk else "cross"
        yield f"{kind} B{B} {Tq}x{Tk}", q, k, v, g, mask


def check_proxy_kernels(torch, port, device):
    """Phase 24(a): K1 and K2 at the proxy's shapes, K1 at the full-width
    proxy's validation batch, and K4's two stages at resnet18's, against
    their plain versions at phases 3-5's tolerances; K1's and K2's keep
    masks bit for bit at 4 heads of 32. Returns the largest absolute bf16
    errors of K1, K2, K4's sums and dx, and a summary."""
    A, BN = port.A, port.BN
    worst, err = {}, {"K1": 0.0, "K2": 0.0}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        cases = [(f"{name} {dtype_name}", q, k, v, g, mask)
                 for name, q, k, v, g, mask in proxy_attention_cases(
                     torch, dtype, device, SEED + 240)]
        for i, kind in enumerate(("self", "cross")):
            Tk = 30 if kind == "self" else 49
            q, k, v = attention_inputs(torch, FULL_VAL_BATCH, 30, Tk, 16, 64,
                                       dtype, device, SEED + 260 + i,
                                       packed=True)
            mask = self_mask(torch, FULL_VAL_BATCH, 30, device, SEED + 260) \
                if kind == "self" else None
            cases.append((f"16x64 {kind} B{FULL_VAL_BATCH} {dtype_name}",
                          q, k, v, None, mask))
        for name, q, k, v, g, mask in cases:
            pairs = [("K1", k1_out(torch, A, name, q, k, v, mask),
                      A.attention_reference(q, k, v, mask))]
            if g is not None:
                pairs += [("K2", a, b) for a, b in zip(
                    k2_grads(torch, A, q, k, v, mask, g),
                    A.attention_backward_reference(q, k, v, mask, g))]
            for kernel, got, ref in pairs:
                e = rel_err(got, ref, ATOL)
                worst[f"{kernel} {name}"] = max(
                    e, worst.get(f"{kernel} {name}", 0.0))
                if got.shape != ref.shape or not e <= TOL[dtype_name]:
                    fail(f"{kernel} {name}: {tuple(got.shape)} vs "
                         f"{tuple(ref.shape)}, error {e:.3e} > "
                         f"{TOL[dtype_name]:.0e}")
                if dtype_name == "bfloat16":
                    err[kernel] = max(err[kernel], float(
                        (got.float() - ref.float()).abs().max()))
        for j, (B, Tq, Tk) in enumerate(PROXY_KEEP_SHAPES):
            check_keep_bits(torch, A, device, PROXY_HEADS, 0.1, 2400 + j,
                            dtype, B=B, Tq=Tq, Tk=Tk, D=PROXY_HEAD_DIM)
    cases = [(f"B{B} {hw}x{hw}x{C}", B, hw, C, "channels_last", "bfloat16",
              "bfloat16") for side, shapes in RESNET18_BN_SHAPES.items()
             for B in PROXY_K4_BATCHES[side] for hw, C in shapes]
    sums_err, dx_err, k4_summary = check_k4(
        torch, BN, device, cases, m_total=False,
        main_batches=[B for batches in PROXY_K4_BATCHES.values()
                      for B in batches])
    summary = ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
    return err["K1"], err["K2"], sums_err, dx_err, summary, k4_summary


# Timed in phase 24(a): K1 and K2 at the proxy's train shapes (B 16 at
# 128², B 8 at 64²), K1 alone at its validation batch of 32; K4 at
# resnet18's 128² shapes at B 16, and its smallest M.
PROXY_TIMED = [(16, 30, 30, True), (16, 30, 16, True), (8, 16, 16, True),
               (8, 16, 4, True), (32, 30, 30, False), (32, 30, 16, False)]
PROXY_TIMED_K4 = {16: RESNET18_BN_SHAPES[128], 8: [(2, 512)]}


def time_proxy_kernels(torch, port, device):
    """Phase 24(a)'s timings: {(B, Tq, Tk): {"K1"[, "K2"]: ...}} and
    {(B, H, C): {"sums" | "dx" | "bwd": ...}}, as phases 9 and 21 time
    them."""
    A, BN = port.A, port.BN
    attention = {}
    for B, Tq, Tk, backward in PROXY_TIMED:
        q, k, v = attention_inputs(torch, B, Tq, Tk, PROXY_HEADS,
                                   PROXY_HEAD_DIM, torch.bfloat16, device,
                                   SEED, packed=True)
        g = attention_inputs(torch, B, Tq, Tq, PROXY_HEADS, PROXY_HEAD_DIM,
                             torch.bfloat16, device, SEED + 1)[0] \
            if backward else None
        mask = self_mask(torch, B, Tq, device, SEED) if Tq == Tk else None
        attention[(B, Tq, Tk)] = time_attention(torch, A, q, k, v, g, mask)
    bn = {}
    for B, shapes in PROXY_TIMED_K4.items():
        bn.update({(B,) + key: t for key, t in time_bn(
            torch, BN, device, batch=B, shapes=shapes).items()})
    return attention, bn


def proxy_timing_lines(card, attention, bn):
    lib = (f"library: scaled_dot_product_attention, {SDPA_BACKEND}; K2's: "
           "its aten backward op")
    yield (f"{card} | K1 and K2 at 4 heads of 32, bf16, device ms per call "
           f"({lib}): " + "; ".join(
               f"{'self' if Tq == Tk else 'cross'} B{B} {Tq}x{Tk} "
               + ", ".join(f"{kernel} {timing_text(t)}"
                           for kernel, t in times.items())
               for (B, Tq, Tk), times in attention.items()))
    for key, title, library in (
            ("sums", "K4 stage 1 (sums)", "torch.batch_norm_backward_reduce"),
            ("dx", "K4 stage 2 (dx)", "torch.batch_norm_backward_elemt")):
        yield (f"{card} | {title} at resnet18's shapes, bf16, device ms per "
               f"call (library: {library}): " + "; ".join(
                   f"B{B} {hw}x{hw}x{C} {timing_text(t[key])}"
                   for (B, hw, C), t in bn.items()))


def proxy_run(torch, port, argv: list, log_path: str):
    """``quality_proxy.run`` on ``argv`` on the card, its output to
    ``log_path``; returns its summary and the launches of its window."""
    out = io.StringIO()
    reset_counts()           # a main path starts here
    with contextlib.redirect_stdout(out):
        summary = port.quality_proxy.run(
            port.quality_proxy.build_parser().parse_args(
                argv + ["--device", DEVICE]))
    torch.cuda.synchronize()
    counts = checked_counts()  # ... and ends here
    with open(log_path, "w") as f:
        f.write(out.getvalue())
    return summary, counts


def curve_text(losses: dict) -> str:
    return ", ".join(f"{it}: {loss:.3f}" for it, loss in losses.items())


def check_overfit(torch, port, work):
    """Phase 24(b). Returns its launches and summary."""
    qp = port.quality_proxy
    steps = []
    with counted_steps(port, qp, steps, []):
        summary, counts = proxy_run(torch, port, [
            "--mode", "overfit", "--workdir", os.path.join(work, "overfit")],
            os.path.join(work, "overfit.log"))
    per_step = step_launches(1, RESNET18_BN_LAYERS)
    want = {k: qp.OVERFIT_STEPS * v for k, v in per_step.items()}
    if len(steps) != qp.OVERFIT_STEPS or any(c != per_step for c in steps) \
            or counts != want:
        fail(f"overfit: launches {counts} ({len(steps)} steps, first "
             f"{steps[:1]}), expected {per_step} in each of "
             f"{qp.OVERFIT_STEPS} steps and none in the captioning")
    line = summary["line"]
    if line["overfit_smoke"] != "PASS":
        fail(f"overfit: {json.dumps(line)} (loss gate "
             f"{qp.OVERFIT_LOSS_GATE}, exact captions >= "
             f"{qp.OVERFIT_MATCH_GATE} of {qp.OVERFIT_IMAGES}); losses "
             f"{curve_text(summary['losses'])}; captions "
             f"{summary['captions']} vs {summary['truth']}")
    return counts, summary


def check_proxy_recipe(torch, port, work, name, argv, iterations, accum,
                       bn_layers):
    """Phase 24(c) and (d): the proxy CLI run of ``argv``. Returns its
    launches and summary; fails unless every train and eval step
    launched as its recipe says and the CIDEr gates pass."""
    qp = port.quality_proxy
    steps, evals = [], []
    with counted_steps(port, port.pretrain, steps, evals):
        summary, counts = proxy_run(
            torch, port, argv + ["--workdir", os.path.join(work, name)],
            os.path.join(work, f"{name}.log"))
    per_step = step_launches(accum, bn_layers)
    # checkpoint-every = iterations: one validation, whose first batch's
    # predictions are logged (4 K1 more)
    want = {k: iterations * v + sum(e[k] for e in evals)
            + (4 if k == "K1" else 0) for k, v in per_step.items()}
    if len(steps) != iterations or any(c != per_step for c in steps) or \
            not evals or any({k: e[k] for k in EVAL_LAUNCHES}
                             != EVAL_LAUNCHES for e in evals) \
            or counts != want:
        fail(f"quality proxy {name}: launches {counts}, expected {want} "
             f"({per_step} in each of {iterations} train steps, "
             f"{EVAL_LAUNCHES} per eval step, none in eval_captioning); "
             f"{len(steps)} steps, eval steps {evals}")
    line = summary["line"]
    if line["iterations"] != iterations or \
            line["grad_accum_steps"] != accum:
        fail(f"quality proxy {name}: ran {json.dumps(line)}")
    losses = summary["pretrain"]["losses"]
    if not all(np.isfinite(v) for v in losses.values()):
        fail(f"quality proxy {name}: losses {curve_text(losses)}")
    if line["quality_proxy_smoke"] != "PASS":
        fail(f"quality proxy {name}: {json.dumps(line)} (gates beam >= "
             f"{qp.BEAM_CIDER_GATE}, nucleus >= {qp.NUCLEUS_CIDER_GATE}); "
             f"losses {curve_text(losses)}; validation "
             f"{summary['pretrain']['val']}")
    return counts, summary


def proxy_text(summary) -> str:
    """Seconds, loss curve, validation loss, CIDEr and a sample of
    captions of one proxy run."""
    pre, truth = summary["pretrain"], summary["truth"]
    seconds = [pre["seconds"][i] for i in sorted(pre["seconds"])][1:]
    sample = [(p["caption"], summary["nucleus"]["predictions"][i]["caption"],
               truth[p["image_id"]])
              for i, p in enumerate(summary["beam"]["predictions"][:3])]
    val = pre["val"][summary["iterations"]]["loss"]
    return (f"{json.dumps(summary['line'])}; losses "
            f"{curve_text(pre['losses'])}; validation loss {val:.4f}"
            f"; host ms per iteration median "
            f"{1e3 * float(np.median(seconds)):.1f}; seconds " + json.dumps(
                {k: round(v, 1) for k, v in summary["seconds"].items()})
            + "; beam | nucleus | truth: " + "; ".join(
                f"{b!r} | {n!r} | {t!r}" for b, n, t in sample))


def check_phase24(torch, port, device):
    """Phase 24. Returns its launches, summed, and the largest absolute
    bf16 errors of K1, K2, K4's sums and dx at (a)'s shapes."""
    qp = port.quality_proxy
    work = os.path.join(WORK, "proxy")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    (k1_err, k2_err, sums_err, dx_err, summary,
     k4_summary) = check_proxy_kernels(torch, port, device)
    attention, bn = time_proxy_kernels(torch, port, device)
    say("24 proxy kernels", f"(a) K1 and K2 at {PROXY_HEADS} heads of "
        f"{PROXY_HEAD_DIM} and K1 at the full width's validation batch of "
        f"{FULL_VAL_BATCH} match the plain versions (fp32 tol "
        f"{TOL['float32']:.0e}, bf16 tol {TOL['bfloat16']:.0e}, atol "
        f"{ATOL}), keep masks bit for bit at {PROXY_KEEP_SHAPES}: {summary}"
        f"; K4 at resnet18's shapes (sums/dx errors): {k4_summary}; "
        f"{time.perf_counter() - t0:.1f} s")
    card = card_line()
    for line in proxy_timing_lines(card, attention, bn):
        say("24 proxy timings", line)

    t1 = time.perf_counter()
    overfit_counts, overfit = check_overfit(torch, port, work)
    pairs = list(zip(overfit["captions"], overfit["truth"]))
    say("24 overfit", f"{card_line()} | (b) python -m virtex_tpu_torch."
        f"scripts.quality_proxy --mode overfit: {json.dumps(overfit['line'])}"
        f" (gates loss < {qp.OVERFIT_LOSS_GATE}, >= {qp.OVERFIT_MATCH_GATE} "
        f"of {qp.OVERFIT_IMAGES} exact); losses "
        f"{curve_text(overfit['losses'])}; launches "
        f"{json.dumps(overfit_counts)}; seconds " + json.dumps(
            {k: round(v, 1) for k, v in overfit["seconds"].items()})
        + "; pred | truth: " + "; ".join(f"{c!r} | {g!r}"
                                         for c, g in pairs[:3])
        + f"; {time.perf_counter() - t1:.1f} s")

    t2 = time.perf_counter()
    recipe_counts, recipe = check_proxy_recipe(
        torch, port, work, "recipe",
        ["--iterations", str(PROXY_RECIPE_ITERATIONS), "--accum",
         str(PROXY_ACCUM)], PROXY_RECIPE_ITERATIONS, PROXY_ACCUM,
        RESNET18_BN_LAYERS)
    say("24 proxy", f"{card_line()} | (c) python -m virtex_tpu_torch.scripts"
        f".quality_proxy --accum {PROXY_ACCUM} (the JAX proxy's recipe: "
        f"resnet18 at 128², L1_H128_A4_F512, bf16, dropout 0.1, batch 32 in "
        f"{PROXY_ACCUM} micro-steps, AdamW): {proxy_text(recipe)}; launches "
        f"{json.dumps(recipe_counts)}; {time.perf_counter() - t2:.1f} s")

    t3 = time.perf_counter()
    full_counts, full = check_proxy_recipe(
        torch, port, work, "full",
        ["--width", "full", "--iterations", str(FULL_ITERATIONS)],
        FULL_ITERATIONS, ACCUM, R50_BN_LAYERS)
    say("24 proxy", f"{card_line()} | (d) python -m virtex_tpu_torch.scripts"
        f".quality_proxy --width full (R-50 at 224², L1_H1024_A16_F4096, "
        f"bf16, dropout 0.1, {TRAIN_BATCH} x accum {ACCUM}, 256² images): "
        f"{proxy_text(full)}; launches {json.dumps(full_counts)}; "
        f"{time.perf_counter() - t3:.1f} s | phase 24 "
        f"{time.perf_counter() - t0:.1f} s")
    launches = {k: overfit_counts[k] + recipe_counts[k] + full_counts[k]
                for k in NO_LAUNCHES}
    return launches, (k1_err, k2_err, sums_err, dx_err)


def import_port():
    """The port's entry points, as one namespace."""
    from virtex_tpu_torch.config import Config, ModelSpec, OptimSpec
    from virtex_tpu_torch.data.loader import DataLoader
    from virtex_tpu_torch.engine.captioner import make_caption_fn
    from virtex_tpu_torch.engine.checkpointing import read_checkpoint
    from virtex_tpu_torch.engine.evaluation import make_eval_step
    from virtex_tpu_torch.engine.trainer import make_train_step
    from virtex_tpu_torch.factories import (
        CaptionDecoderFactory,
        PretrainingDatasetFactory,
        PretrainingModelFactory,
    )
    from virtex_tpu_torch.modules.normalization import SubsampledBatchNorm
    from virtex_tpu_torch import native
    from virtex_tpu_torch.native import DataPlane, decoder_for
    from virtex_tpu_torch.modules.transformer import (
        MultiHeadAttention,
        make_self_attention_mask,
    )
    from virtex_tpu_torch.ops import _build
    from virtex_tpu_torch.ops import attention as A
    from virtex_tpu_torch.ops import batchnorm as BN
    from virtex_tpu_torch.ops import beam_select as BS
    from virtex_tpu_torch.ops import decode_attention as DA
    from virtex_tpu_torch.optim.optimizer import build_optimizer
    from virtex_tpu_torch.scripts import (
        clf_linear,
        clf_voc07,
        eval_captioning,
    )
    from virtex_tpu_torch.utils import svm
    from virtex_tpu_torch.scripts import pretrain_virtex as pretrain
    from virtex_tpu_torch.engine.captioner import decode_predictions
    from virtex_tpu_torch.engine.checkpointing import load_model_variables
    from virtex_tpu_torch.data.tokenizers import SentencePieceBPETokenizer
    from virtex_tpu_torch.factories import (
        DownstreamDatasetFactory,
        TokenizerFactory,
        VisualBackboneFactory,
    )
    from virtex_tpu_torch.engine.checkpointing import (
        apply_backbone_weight_init,
    )
    from virtex_tpu_torch.utils.beam_search import AutoRegressiveBeamSearch
    from virtex_tpu_torch.utils.common import common_parser
    from virtex_tpu_torch.utils.nucleus_sampling import topp_drop
    from virtex_tpu_torch.model_zoo import model_zoo
    from virtex_tpu_torch.modules.visual_backbones import detectron2_name
    from virtex_tpu_torch.scripts import build_vocabulary, eval_detectron2
    from virtex_tpu_torch.scripts import feature_bitcheck, reproduce_parity
    from virtex_tpu_torch.scripts import quality_proxy
    return types.SimpleNamespace(**locals())


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, REPO)
    try:
        port = import_port()
    except ImportError as e:
        fail(f"cannot import the port (run from the repository root): {e}")
    A, BN, _build = port.A, port.BN, port._build
    device = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)

    # 1. device
    card = card_line()
    print(card, flush=True)  # as nvidia-smi gives it: name, power limit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("1 device", f"{card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | TF32 off for matmul and cuDNN")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "smem" in ln]
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    say("2 build", f"{', '.join(sources)} built from "
        f"{os.path.relpath(_build.CSRC, REPO)} for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s (nvcc, one per source in "
        f"parallel, and the link: {_build.build_seconds or 0.0:.1f} s); "
        f"ptxas: {' | '.join(ptxas)}")

    # 3. K1 against the plain version
    k1_err, keep, summary = check_k1(torch, A, device)
    say("3 K1", f"matches the plain version (fp32 tol {TOL['float32']:.0e},"
        f" bf16 tol {TOL['bfloat16']:.0e}, atol {ATOL}): {summary}; "
        f"dropout keep {keep:.4f} at rate 0.1, seeded")

    # 4. K2 against the plain version
    k2_err, keep, summary = check_k2(torch, A, device)
    say("4 K2", f"matches the plain version (fp32 tol {TOL['float32']:.0e},"
        f" bf16 tol {TOL['bfloat16']:.0e}, atol {ATOL}): {summary}; K1's "
        f"and K2's keep masks equal philox_keep_reference bit for bit in "
        f"both variants (fp32 scalar, bf16 tensor-core; B {TRAIN_BATCH}, "
        f"16 heads, 30x49, keep {keep:.4f} at rate 0.1)")

    edge_k1_err, edge_k2_err, summary = check_edges(torch, A, device)
    say("4 K1 K2 edges", f"tensor-core variants match the plain versions "
        f"(bf16 tol {TOL['bfloat16']:.0e}, atol {ATOL}): {summary}")
    check_no_sync_dropout(torch, port, device)
    say("4 K1 K2 seed", "a dropout forward and backward of "
        "MultiHeadAttention (B 128, 16 heads) made no host sync under "
        "torch.cuda.set_sync_debug_mode('error')")

    # 5. K4 and the BatchNorm forward against the plain versions
    k4_err, dx_err, summary = check_k4(torch, BN, device)
    say("5 K4", f"stage 1 and dx (with m_total 2M too) match their plain "
        f"versions (sums tol "
        f"{K4_TOL:.0e} of sqrt(M); dx tol {DX_TOL['float32']:.0e} fp32, "
        f"{DX_TOL['bfloat16']:.1e} bf16, of |ref| + 1) and repeat their "
        f"bits, each in the variant k4_vector_width names (sums/dx errors):"
        f" {summary}")
    fwd_stats_err, fwd_apply_err, summary = check_bn_forward(torch, BN,
                                                             device)
    say("5 BN forward", f"bf16 B{TRAIN_BATCH} at the 12 ResNet-50 shapes, "
        f"vector variants: statistics within {FWD_STATS_TOL:.0e} of |ref| + "
        f"1 of the plain version (max abs {fwd_stats_err:.2e}; per shape: "
        f"{summary}); the running statistics and the apply (train and eval "
        f"mode) bit-equal to the torch ops; two launches, equal bits")

    # 6. eval step, flagship at full width
    spec = port.ModelSpec.flagship()
    torch.manual_seed(SEED)
    model = port.PretrainingModelFactory.from_spec(spec)  # on the card
    if next(model.parameters()).device != device:
        fail(f"PretrainingModelFactory.from_spec built the model on "
             f"{next(model.parameters()).device}, not {device}")
    randomize_(torch, model, SEED)
    model = model.eval()
    plain_model = plain_copy(model, A, BN, port.MultiHeadAttention,
                             port.SubsampledBatchNorm)
    batch = caption_batch(torch, EVAL_BATCH, spec.image_size,
                          spec.max_caption_length, spec.vocab_size, SEED,
                          device)
    eval_step = port.make_eval_step(model)
    decoder = port.AutoRegressiveBeamSearch(spec.eos_index,
                                            spec.max_decoding_steps,
                                            spec.beam_size)
    caption_fn = port.make_caption_fn(model, decoder, spec.sos_index,
                                      spec.prefix_mode)
    images = batch["image"]

    reset_counts()             # a main path starts here
    metrics = eval_step(batch)
    eval_counts = checked_counts()
    captions = caption_fn(images)
    torch.cuda.synchronize()
    serve_counts = checked_counts()  # ... and ends here
    serve_decodes = launched()[port.DA.KEY]
    serve_selects = launched()[port.BS.KEY]

    losses = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in losses.values()):
        fail(f"eval step: non-finite losses {losses}")
    if eval_counts != {"K1": 4, "K2": 0, "K4": 0, "K4dx": 0}:
        fail(f"eval step launched {eval_counts}, expected 4 K1 launches "
             "(self + cross attention in both caption directions) only")
    plain = {k: float(v) for k, v in port.make_eval_step(plain_model)(batch)
             .items()}
    worst = max(abs(losses[k] - plain[k]) / abs(plain[k]) for k in plain)
    if not worst <= LOSS_RTOL:
        fail(f"eval step: K1 losses {losses} vs plain {plain}, relative "
             f"{worst:.2e} > {LOSS_RTOL}")
    say("6 eval step", f"{spec.model_name} {spec.visual_name} "
        f"{spec.textual_name} {spec.dtype} B={EVAL_BATCH}: losses "
        f"{json.dumps(losses)}; plain attention {json.dumps(plain)} "
        f"(rel {worst:.2e} <= {LOSS_RTOL}); K1 launches {eval_counts['K1']}")

    # 7. captioning
    if tuple(captions.shape) != (EVAL_BATCH, spec.max_decoding_steps):
        fail(f"captions have shape {tuple(captions.shape)}")
    if captions.dtype not in (torch.int32, torch.int64):
        fail(f"captions have dtype {captions.dtype}")
    lo, hi = int(captions.min()), int(captions.max())
    if lo < 0 or hi >= spec.vocab_size:
        fail(f"caption ids outside [0, {spec.vocab_size}): {lo}..{hi}")
    if serve_counts != eval_counts:
        fail(f"beam search launched kernels ({serve_counts} after the eval "
             f"step's {eval_counts}); its decode path launches no K1, K2 or "
             "K4")
    step_decodes = 2 * spec.textual["num_layers"]  # self and cross
    if not (0 < serve_decodes <= step_decodes * spec.max_decoding_steps
            and serve_decodes % step_decodes == 0):
        fail(f"beam search launched the decode attention {serve_decodes} "
             f"times, not {step_decodes} per step")
    # One select a step; a search that stops early drops its last step.
    steps_run = serve_decodes // step_decodes
    if serve_selects != (steps_run if steps_run == spec.max_decoding_steps
                         else steps_run - 1):
        fail(f"beam search launched beam select {serve_selects} times over "
             f"{steps_run} decode steps, not once a step")
    say("7 captioning", f"beam K={spec.beam_size}, {spec.max_decoding_steps}"
        f" steps: tokens {tuple(captions.shape)} {captions.dtype}, ids in "
        f"[{lo}, {hi}]; first caption {captions[0, :10].tolist()}; "
        f"{serve_decodes} decode attention launches "
        f"({steps_run} steps); {serve_selects} beam select launches")
    decode_err_max = check_decode_attention(torch, port.DA, device)
    say("7 decode attention", f"matches the plain version (bf16 tol "
        f"{TOL['bfloat16']:.0e}, atol {ATOL}; max {decode_err_max:.2e}) at "
        f"{DECODE_IMAGES * DECODE_BEAMS} query rows and {DECODE_HEADS} heads "
        f"of 64: cross to {DECODE_IMAGES} x {DECODE_TOKENS} K/V rows, "
        f"{DECODE_BEAMS} rows each; self at n_valid 1..{DECODE_POSITIONS} "
        f"of {DECODE_POSITIONS}; one launch a call, equal bits twice, "
        f"positions past n_valid never read")
    tf_mean, tf_ref, tf_gap = check_decode_model(
        torch, model, plain_model, images, captions, spec.beam_size,
        spec.sos_index)
    say("7 decode attention", f"teacher-forced decode along the captions, "
        f"{EVAL_BATCH} images x {spec.beam_size} beams, cross K/V per "
        f"image: mean log-probability {tf_mean:.5f} against {tf_ref:.5f} "
        f"plain (rel {abs(tf_mean - tf_ref) / abs(tf_ref):.2e} <= "
        f"{LOSS_RTOL}); largest gap of one token {tf_gap:.3e}")
    summary = check_beam_select(torch, port.BS, device)
    say("7 beam select", f"{SELECT_IMAGES} images x {SELECT_BEAMS} beams "
        f"over {SELECT_VOCAB} tokens, {SELECT_PER_NODE} kept a beam, and "
        f"step 0 keeping {SELECT_BEAMS}: scores, tokens and source rows "
        f"bit-equal to the plain version on the CPU ({summary} rows); one "
        f"launch a call, equal bits twice")

    # 8. train step
    (train_step, plain_train_step, tbatch, bn_shapes, train_launches,
     dy_copies) = check_train(torch, port, device)

    # 9. timings
    eval_shapes = {"self B32": (30, True), "cross B32": (49, False)}
    k1_eval, k1_eager = {}, {}
    for name, (Tk, causal) in eval_shapes.items():
        q, k, v = attention_inputs(torch, EVAL_BATCH, 30, Tk, 16, 64,
                                   torch.bfloat16, device, SEED)
        mask = self_mask(torch, EVAL_BATCH, 30, device, SEED) if causal \
            else None
        k1_eval[name] = time_attention(torch, A, q, k, v, None, mask)["K1"]
        k1_eager[name] = time_k1_eager(torch, A, q, k, v, mask)
    train_times = {kind: time_attention(torch, A, *train_attention_inputs(
        torch, kind, torch.bfloat16, device, SEED))
        for kind in ("self", "cross")}
    bn_times = time_bn(torch, BN, device)
    bn_step = {key: per_step(bn_times, bn_shapes, key)
               for key in ("sums", "dx", "bwd")}
    bn_fwd_times = time_bn_forward(torch, BN, device, FWD_TIMING_BATCH)
    # One update of FWD_TIMING_BATCH in one micro-step: each BatchNorm
    # once (the first step ran each ACCUM times).
    update_shapes = {s: n // ACCUM for s, n in bn_shapes.items()}
    fwd_calls = sum(update_shapes.values())
    bn_fwd_step = {key: per_step(bn_fwd_times, update_shapes, key)
                   for key in ("stats", "apply")}
    bn_calls = sum(bn_shapes.values())
    decode_times = time_decode_attention(torch, port.DA, device)
    select_times = time_beam_select(torch, port.BS, device)
    eval_ms = host_ms(torch, lambda: eval_step(batch), 20)
    caption_ms = host_ms(torch, lambda: caption_fn(images), 3, warmup=1)
    step_ms = [host_ms(torch, lambda f=f: f(tbatch), 2, warmup=1)
               for f in (plain_train_step, train_step, train_step,
                         plain_train_step)]
    kernel_step_ms = (step_ms[1] + step_ms[2]) / 2
    plain_step_ms = (step_ms[0] + step_ms[3]) / 2
    images_per_step = ACCUM * TRAIN_BATCH
    card = card_line()
    lib = f"library: scaled_dot_product_attention, {SDPA_BACKEND}"
    say("9 timings", f"{card} | K1, bf16, 16 heads, device ms per call "
        f"({lib}): " + "; ".join(
            f"{name} {timing_text(k1_eval[name])}, eager {k1_eager[name][0]:.4f}"
            f" vs plain {k1_eager[name][1]:.4f}" for name in eval_shapes)
        + "; " + "; ".join(f"{kind} B{TRAIN_BATCH} "
                           f"{timing_text(t['K1'])}"
                           for kind, t in train_times.items())
        + f" | eval step B{EVAL_BATCH} {eval_ms:.2f} ms = "
        f"{EVAL_BATCH / eval_ms * 1e3:.1f} img/s | beam captioning "
        f"B{EVAL_BATCH} {caption_ms:.1f} ms per batch")
    say("9 timings", f"{card} | K2, bf16, 16 heads, device ms per call "
        f"({lib}: its aten backward op): " + "; ".join(
            f"{kind} B{TRAIN_BATCH} {timing_text(t['K2'])}"
            for kind, t in train_times.items()))
    for key, title, library in (
            ("sums", "K4 stage 1 (sums)", "torch.batch_norm_backward_reduce"),
            ("dx", "K4 stage 2 (dx; plain: the torch dx stage it replaces)",
             "torch.batch_norm_backward_elemt"),
            ("bwd", "BatchNorm backward, both stages",
             "batch_norm_backward_reduce + batch_norm_backward_elemt")):
        say("9 timings", bn_timing_line(
            card, {k: t[key] for k, t in bn_times.items()}, bn_step[key],
            bn_calls, title, library))
    for line in bn_forward_lines(card, bn_fwd_times, update_shapes,
                                 FWD_TIMING_BATCH):
        say("9 timings", line)
    say("9 timings", f"{card} | decode attention, bf16, {DECODE_HEADS[0]} "
        f"heads of 64, {DECODE_IMAGES * DECODE_BEAMS} query rows, device ms "
        f"per call (library: scaled_dot_product_attention, {SDPA_BACKEND}, "
        f"an image's beams as its query rows): " + "; ".join(
            f"{name} {timing_text(t)}" for name, t in decode_times.items()))
    say("9 timings", f"{card} | beam select, fp32, {SELECT_IMAGES} images x "
        f"{SELECT_BEAMS} beams over {SELECT_VOCAB} tokens, device ms per "
        f"call (library: torch.topk per beam and per image; bound: one read "
        f"of the rows): " + "; ".join(
            f"{name} {timing_text(t)}" for name, t in select_times.items()))
    say("9 timings", f"{card} | dy copied to rows before K4 in {dy_copies} "
        f"of the first train step's {bn_calls} BatchNorm backwards")
    say("9 timings", f"{card} | train step, micro-batch {TRAIN_BATCH} x "
        f"accum {ACCUM}, bf16, host ms per step (plain, kernels, kernels, "
        f"plain): {', '.join(f'{t:.1f}' for t in step_ms)} | kernels "
        f"{kernel_step_ms:.1f} ms = "
        f"{images_per_step / kernel_step_ms * 1e3:.1f} img/s; plain "
        f"{plain_step_ms:.1f} ms = "
        f"{images_per_step / plain_step_ms * 1e3:.1f} img/s")
    profile = profile_step(torch, lambda: train_step(tbatch))
    say("9 profile", f"{card} | one flagship train step (micro-batch "
        f"{TRAIN_BATCH} x accum {ACCUM}, dropout 0, after the timed steps) "
        f"under torch.profiler: {profile}")
    del train_step, plain_train_step, tbatch
    torch.cuda.empty_cache()

    # 10. K1 and K2 at 32 heads, with masked LM's pad-only mask
    wide_k1_err, wide_k2_err, keep, summary = check_wide(torch, port, device)
    wide_times = time_wide(torch, port, device)
    say("10 K1 K2 32 heads", f"match the plain versions (fp32 tol "
        f"{TOL['float32']:.0e}, bf16 tol {TOL['bfloat16']:.0e}, atol "
        f"{ATOL}): {summary}; keep masks equal philox_keep_reference bit "
        f"for bit in both variants (B {TRAIN_BATCH}, {WIDE_HEADS} heads, "
        f"30x49, keep {keep:.4f} at rate 0.1)")
    say("10 K1 K2 32 heads", f"{card_line()} | bf16 B{TRAIN_BATCH}, device "
        f"ms per call (library: scaled_dot_product_attention, "
        f"{SDPA_BACKEND}; K2's: its aten backward op): " +
        "; ".join(f"{kind} K1 {timing_text(t['K1'])}, K2 "
                  f"{timing_text(t['K2'])}" for kind, t in wide_times.items()))

    # 11. the other pretext tasks
    task_launches = {k: 0 for k in LAUNCHES_PER_STEP}
    task_ms = {}
    for stem in TASKS:
        launches, task_ms[stem] = check_task(torch, port, device, stem)
        task_launches = {k: task_launches[k] + launches[k]
                         for k in launches}
        torch.cuda.empty_cache()
    card = card_line()
    for stem, step_ms in task_ms.items():
        say("11 task timings", f"{card} | {task_timing_line(stem, step_ms)}")

    # 12. nucleus captioning with the flagship model of phase 6
    nucleus_counts, _ = check_nucleus(torch, port, model, spec, images,
                                      device)
    del model, plain_model, eval_step, caption_fn, batch, images
    torch.cuda.empty_cache()

    # 13. pretraining through the CLI, and its resume
    pretrain_counts, run, root, tokenizer, pretrain_args, pretrain_result = \
        check_pretraining(torch, port, device)
    torch.cuda.empty_cache()

    # 14. eval_captioning on phase 13's checkpoint
    check_eval_captioning(torch, port, device, run, root, tokenizer)
    torch.cuda.empty_cache()

    # 15. the binary SentencePiece reader
    check_sp_model(port)

    # 16. clf_linear: the linear probe and the fine-tune
    finetune_counts = check_clf_linear(torch, port, device, run,
                                       kernel_step_ms)
    torch.cuda.empty_cache()

    # 17. clf_voc07 on phase 13's checkpoint, and the SVMs at VOC's size
    voc_counts = check_clf_voc07(torch, port, device, run)
    torch.cuda.empty_cache()

    # 18. remat, against the plain step
    remat_counts = check_remat(torch, port, device)
    torch.cuda.empty_cache()

    # 19. BatchNorm's "batch" sampler at BN_STAT_STRIDE 4
    sampler_counts = check_sampler(torch, port, device)
    torch.cuda.empty_cache()

    # 20. data parallel: NCCL at world 1 against phase 13, and two ranks
    # over gloo on the one card against one process
    dp1_counts = check_dp_world_1(torch, port, device, pretrain_args, run,
                                  pretrain_result)
    torch.cuda.empty_cache()
    dp2_counts, dp2_seconds = check_dp_world_2(torch, port, device,
                                               kernel_step_ms)
    torch.cuda.empty_cache()

    # 21. the model zoo on the card, the hub, the Detectron2 export and the
    # vocabulary
    zoo_counts, zoo_errs = check_phase21(torch, port, device, run, root)
    torch.cuda.empty_cache()

    # 22. tensor parallelism: two gloo ranks on the card, data 1 x model 2
    tp_counts, tp_seconds = check_tp(torch, port, device, pretrain_args)
    torch.cuda.empty_cache()

    # 23. feature_bitcheck at full width, the card against the JAX
    # package's golden, and the closure rehearsal
    bitcheck_counts = check_phase23(torch, port, device)
    torch.cuda.empty_cache()

    # 24. the end-to-end learning proof: the kernels at the proxy's shapes,
    # the overfit check, the JAX proxy's recipe and the full-width proxy
    proxy_counts, proxy_errs = check_phase24(torch, port, device)
    shutil.rmtree(WORK)
    say("seconds", "per phase (the time up to each phase's last line): "
        + json.dumps({k: round(v, 1) for k, v in PHASE_SECONDS.items()})
        + f"; 20(b): the one process's reference "
        f"{dp2_seconds['reference']:.1f}, the ranks "
        f"{dp2_seconds['ranks']:.1f}; 22: the one process's reference "
        f"{tp_seconds['reference']:.1f}, the ranks "
        f"{tp_seconds['ranks']:.1f}; all "
        f"{sum(PHASE_SECONDS.values()):.1f}")
    later = {k: voc_counts[k] + remat_counts[k] + sampler_counts[k]
             + dp1_counts[k] + dp2_counts[k] + zoo_counts[k]
             + tp_counts[k] + bitcheck_counts[k] + proxy_counts[k]
             for k in NO_LAUNCHES}

    # ms (and plain_ms, library_ms, bound_ms): K1 as in the eval step
    # (mean of its self and cross launches at B32); K2 the mean of the
    # train step's self and cross launches (B128); each K4 stage the mean
    # over one train step's launches.
    def row(times):
        return {"ms": sum(t[0] for t in times) / len(times),
                "plain_ms": sum(t[1] for t in times) / len(times),
                "bound_ms": sum(t[3] for t in times) / len(times),
                "bound_by": times[0][4],
                "library_ms": sum(t[2] for t in times) / len(times)}

    print(json.dumps({"kernels": [{
        "name": "K1 attention_fwd",
        "route": "cuda",
        "source": "virtex_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "virtex_tpu/ops/attention.py:87",
        "launches": serve_counts["K1"] + train_launches["K1"]
        + task_launches["K1"] + nucleus_counts["K1"]
        + pretrain_counts["K1"] + later["K1"],
        "max_abs_err": max(k1_err, wide_k1_err, edge_k1_err, zoo_errs[0],
                           proxy_errs[0]),
        **row(list(k1_eval.values())),
    }, {
        "name": "K2 attention_bwd",
        "route": "cuda",
        "source": "virtex_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "virtex_tpu/ops/attention.py:103",
        "launches": train_launches["K2"] + task_launches["K2"]
        + nucleus_counts["K2"] + pretrain_counts["K2"] + later["K2"],
        "max_abs_err": max(k2_err, wide_k2_err, edge_k2_err, zoo_errs[1],
                           proxy_errs[1]),
        **row([t["K2"] for t in train_times.values()]),
    }, {
        "name": "K4 bn_backward_sums",
        "route": "cuda",
        "source": "virtex_tpu_torch/csrc/bn_backward_sums.cu",
        "replaces": "virtex_tpu/ops/batchnorm.py:128",
        "launches": train_launches["K4"] + task_launches["K4"]
        + nucleus_counts["K4"] + pretrain_counts["K4"]
        + finetune_counts["K4"] + later["K4"],
        "max_abs_err": max(k4_err, zoo_errs[2], proxy_errs[2]),
        **row([tuple(t / bn_calls for t in bn_step["sums"])
               + (next(iter(bn_times.values()))["sums"][4],)]),
    }, {
        "name": "K4 bn_backward_dx",
        "route": "cuda",
        "source": "virtex_tpu_torch/csrc/bn_backward_sums.cu",
        "replaces": "virtex_tpu/ops/batchnorm.py:278",
        "launches": train_launches["K4dx"] + task_launches["K4dx"]
        + nucleus_counts["K4dx"] + pretrain_counts["K4dx"]
        + finetune_counts["K4dx"] + later["K4dx"],
        "max_abs_err": max(dx_err, zoo_errs[3], proxy_errs[3]),
        **row([tuple(t / bn_calls for t in bn_step["dx"])
               + (next(iter(bn_times.values()))["dx"][4],)]),
    }, {
        "name": "bn_forward_stats",
        "route": "cuda",
        "source": "virtex_tpu_torch/csrc/bn_forward.cu",
        "replaces": "virtex_tpu/ops/batchnorm.py:216",
        "launches": total(MAIN_PATH_LAUNCHES, "bn_stats"),
        "max_abs_err": fwd_stats_err,
        **row([tuple(t / fwd_calls for t in bn_fwd_step["stats"])
               + (next(iter(bn_fwd_times.values()))["stats"][4],)]),
    }, {
        "name": "bn_forward_apply",
        "route": "cuda",
        "source": "virtex_tpu_torch/csrc/bn_forward.cu",
        "replaces": "virtex_tpu/ops/batchnorm.py:222",
        "launches": total(MAIN_PATH_LAUNCHES, "bn_apply"),
        "max_abs_err": fwd_apply_err,
        **row([tuple(t / fwd_calls for t in bn_fwd_step["apply"])
               + (next(iter(bn_fwd_times.values()))["apply"][4],)]),
    }, {
        "name": "decode_attention",
        "route": "cuda",
        "source": "virtex_tpu_torch/csrc/decode_attention.cu",
        "replaces": "none (virtex_tpu/modules/transformer.py:110, :131: "
                    "einsum attention)",
        "launches": total(MAIN_PATH_LAUNCHES, "decode_attention"),
        "max_abs_err": decode_err_max,
        **row([decode_times["cross"], decode_times["self 30"]]),
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:   # one rank of phase 20(b)
        dp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    elif sys.argv[1:2] == ["--tp-rank"]:   # one rank of phase 22
        tp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()
