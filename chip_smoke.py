#!/usr/bin/env python3
"""Smoke run of the PyTorch port (detr_tensorflow_tpu_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, one status line each; any failure raises and exits non-zero:
  1. device: a CUDA card is required (no CPU fallback); prints
     ``nvidia-smi --query-gpu=name,power.limit``;
  2. build: nvcc builds every kernel of the serving and training paths from
     csrc/, one process per source, all at once; prints each kernel's ptxas
     report and the HMMA (tensor-core) instructions in the SASS of the three
     tensor-core attention kernels, of E-mma, of E-tf32, of D-mma and of
     D-tf32, and the IMMA (int8 tensor-core) instructions of each compiled
     configuration of F and G, and fails if any has none;
  3. kernels: attention A at every shape of the served path against its
     plain PyTorch version: fp32 (TF32 off) through the tensor-core kernel
     A-tf32 (3xTF32) and through the SIMT kernel called directly, bf16
     through the tensor-core kernel A-mma and through the SIMT kernel
     called directly; A-tf32 or A-mma, SIMT, plain and library times from
     CUDA graphs at B=2 and at the b1 896x1408 shapes (the tensor-core
     kernels at each CTA shape); then the attention forward with dropout
     and its backward at the training shapes, against plain autograd at
     dropout 0 and given the mask the kernel library materialises: fp32
     through A-tf32 and the tensor-core A' (3xTF32), bf16 through A-mma and
     A'-bf16 (bf16 tensor cores), and the SIMT A' called directly at both
     dtypes; at each training shape the fp32 forward with dropout 0.1
     (A-tf32 at each CTA shape, the SIMT A, plain, SDPA) and the backward
     (the tensor-core A', the SIMT A', plain, SDPA's backward) timed from
     CUDA graphs in turns, and their sums per training step; at each
     training shape the bf16 step's A-mma with dropout 0.1 (at each CTA
     shape, the SIMT A beside it) and A'-bf16 with the SIMT A' beside it
     against plain, SDPA and their bound, timed the same way, and their
     sums per bf16 step;
  4. lap: the LAP kernel on 48 problems (6 decoder layers x batch 8)
     against its plain version and scipy, on prefix and scattered row
     masks, with its device time from CUDA graphs, the time of a loop of
     calls (host included) and the serial chain (Dijkstra steps) of the
     longest problem;
  5. serving: full-width DETR-R50 (seeded random weights) behind
     ``Predictor``: 3 requests with the launch counters reset just before,
     the whole forward against the plain-attention model, padded against
     exact, the same fp32 forward under torch's default TF32 flags (cuDNN
     convs on TF32) against TF32 off (a reading of boxes and logits beside
     the golden tolerances, not a gate), and one bf16 request (A-mma 18 per
     bf16 forward, A-tf32 18 per fp32 one, the SIMT kernel 0) from float32
     parameters, whose forward is no further from the fp32 forward than
     twice the bf16 plain-attention model's;
  6. http: the port's HTTP service on 127.0.0.1, 3 POSTs and /healthz;
  7. int8 kernels: F (fused int8 1x1) and G (int8 3x3, stride 1 and 2) at
     every distinct shape of the b1 896x1408 int8 forward against their
     plain versions (integer-equal), with kernel, plain and library times
     from CUDA graphs and each shape's bound, F's plan (tile, cluster,
     CTAs) and G's (output patch, channels, cluster, CTAs) at each;
  8. int8 serving: full-width DETR-R50 at bf16 compute with the int8
     backbone quantized from its own fp32 backbone on two seeded 800x1333
     images, 3 requests through ``Predictor`` with the counters reset just
     before (32 F, 16 G, 18 A-mma per forward), median latency, and c5 on the
     kernel route against the plain int8 route and the fp32 backbone;
  9. training: full-width DETR-R50 at b8 376x672 fp32: one step's loss and
     gradients, kernel route against plain route at dropout 0; eight
     dropout-0.1 steps through ``fit`` with the counters reset just before
     (per step A-tf32 18, SIMT A 0, tensor-core A' 18, SIMT A' and A'-bf16
     0, B 1, C 1);
     one more step under ``torch.profiler``: B's and C's device time and
     their share of the step's kernel time; matching and loss under
     ``torch.cuda.set_sync_debug_mode("error")``; the step's wall and
     device-busy time under ``torch.profiler`` and its peak memory;
 9b. bf16 training: the same model built with ``dtype="bfloat16"`` (float32
     parameters, bf16 compute). The kernel route against the plain-attention
     route with the matching shared, at dropout 0 and at dropout 0.1 with
     every route's masks alike (A-mma and A'-bf16 at both, the main path's
     kernels): loss within 1e-2 relative, every gradient
     float32 and no further from the fp32 step's on the same weights and
     masks than the plain route's (median over tensors within 2x, each
     tensor within 3x); then four dropout-0.1 steps through ``Trainer``
     with the counters reset just before (per step A-mma 18, A'-bf16 18,
     B 1, C 1, A-tf32, SIMT A, SIMT A' and A'-mma 0), every parameter and
     Adam moment float32 after each; median step time, device-busy time and
     peak memory beside the fp32 step's, and one step's kernel time with the
     attention kernels' share;
 9c. entry points: a synthetic COCO set of 16 PNG images at COCO-like sizes
     with 1-20 boxes each; ``train_coco.main`` trains full-width DETR-R50
     on it for 4 steps at b8 376x672 fp32 with augmentation through
     ``Trainer.prefetch``, checkpointing; ``restore_latest`` and one more
     step (A-tf32 and A'-mma 18 a step, B 1, C 1); the loader's images/s
     and a loader-fed step beside an in-memory one; ``eval.main`` at
     original size, batch 1 and batch 4, with equal AP tables (A-tf32 18 a
     forward, C 1), one eval batch against the plain-attention model;
     SIGTERM during ``fit`` under ``PreemptionGuard``;
 10. fused kernels: C (stem max pool), D (fused bottleneck tail) and E
     (whole identity bottleneck) at every distinct shape of one b1 forward
     of the fused-backbone model, at 896x1408 with a mask (C, D x16) and
     768x1280 bucket-exact (C, D x4, E x12), fp32 (TF32 off) and bf16, and
     C at the training stem (8, 64, 188, 336) fp32,
     against their plain versions (C bit-equal), with kernel, plain and
     yardstick times from CUDA graphs and each shape's bound; D runs on
     D-tf32 (TF32 tensor cores, 3xTF32) at fp32, with its bound as 3xTF32,
     and on D-mma (bf16 tensor cores) at bf16, both with the output tile
     staged in shared memory, each timed beside the SIMT D called at its
     dtype (at fp32 with its bound on the fp32 pipes); E runs on
     E-tf32 (TF32 tensor cores, 3xTF32, thread-block clusters) at fp32, with
     its bound as 3xTF32 and on the fp32 pipes, and on E-mma (bf16 tensor
     cores, thread-block clusters) at bf16, one compiled plan per width
     each, each timed beside the SIMT kernel called at its dtype; prints how
     many clusters of each plan the card holds at once;
 11. fused serving: full-width DETR-R50 with ``fuse_residual=True,
     fuse_bottleneck=True`` and the unfused model from one seed and one set
     of nonzero FrozenBN buffers: 3 requests through ``Predictor`` with the
     counters reset just before (per bucket-exact forward C 1, D-tf32 4,
     D-mma 0, SIMT E 0, E-mma 0, E-tf32 12, A-tf32 18; per masked forward C
     1, D-tf32 16, E 0, A-tf32 18; SIMT D 0), c5, boxes and logits against
     the unfused model at fp32; the fused bf16 model's main path, a
     bucket-exact and a masked request with the counters reset just before
     (C 1, D-mma 4, E-mma 12, A-mma 18; C 1, D-mma 16, E 0, A-mma 18; SIMT D
     and D-tf32 0), the fused
     bf16 model's c5 against the unfused fp32 model's beside the unfused
     bf16 model's own gap at both, and the median latency of both models at
     768x1280 b1 and 800x1333 b1, fp32 and bf16, with each one's
     device-busy time and idle share under ``torch.profiler``;
 12. checkpoints and DC5: a seeded DETR-R50-DC5 state_dict in facebook's
     naming, saved as ``{"model", "args": Namespace}`` and built with
     ``build_detr(weights=.pth, dilation=True)``; served at 800x1333 b1
     (the 896x1408 bucket: 56x88 = 4928 keys), 3 requests each at fp32
     (TF32 off, A-tf32 18 a forward) and bf16 (A-mma 18), held against the
     plain-attention model (golden tolerances at fp32, the bf16 test's at
     bf16); p50 latency, device busy time and idle share beside DETR-R50's;
     A-tf32 and A-mma at (4928, 4928) and (100, 4928) against plain, SDPA
     and the bound; the fused DC5 model (bucket-exact: C 1, D-tf32 6,
     E-tf32 10, E on undilated identity blocks only; masked: D-tf32 16)
     against the unfused one; the int8 DC5 model (G 12 at stride 1 and 2 at
     stride 2, the 2 dilated 3x3s outside G as taps and ``torch._int_mm``,
     bit-exact and timed beside G and the float64 convolution), its c5
     integer-equal to the plain int8 route; a DC5 b8 376x672 fp32 step at
     dropout 0.1 without remat (A-tf32 18, A'-mma 18, B 1, C 1) and with
     ``remat=True, backbone_remat=2`` (A-tf32 36: every layer recomputed),
     gradients within twice two identical steps' difference, the generator
     in the same state, memory and step times beside; ``DetrModel.save``
     and ``build_detr(weights=.npz)`` on the card, outputs bit-equal;
 13. segmentation: a seeded DETR-R50 DETRsegm state_dict in facebook's
     naming (``detr.``-prefixed detector, ``mask_head.*``,
     ``bbox_attention.*``) loaded by ``build_detr(weights=.pth, masks=True)``;
     ``Predictor(masks=True)`` at 800x1333 b1, fp32 (TF32 off, A-tf32 18 a
     request) and bf16 (A-mma 18), C 1, 5 requests after one warm-up, each
     mask bool at the image's size, with p50 latency, device busy time, idle
     share and peak memory beside the same detector's requests without
     masks, and the segmentation head's device time alone; one int8 segm
     forward (F 32, G 16, A-mma 18) and one bucket-exact fused fp32 segm
     forward at 768x1280 (C 1, D-tf32 4, E-tf32 12, A-tf32 18), each one's
     pred_masks gap against the unfused fp32 model printed as a reading; a
     reduced-depth segm model on the card against the CPU (the CPU parity
     tests' bounds); one POST /detect with masks whose ``mask_rle`` decodes
     to the Predictor's masks; the frozen-detector mask-head step at b8
     376x672 fp32 dropout 0.1 (2 steps: A-tf32 18, A' 0, B 1, C 1 a step;
     mask_loss and dice_loss logged), its busy time and memory;
     ``finetune_coco_masks`` for 2 steps, then ``eval --masks`` over 4
     synthetic PNG images with polygon masks (A-tf32 18 and C 1 an image),
     whose AP table has a mask row;
 14. panoptic: kernel B's 256-column instance on 48 problems of 250 x 250
     (the panoptic recipe's 250 target slots and queries, scattered n_real
     0-60, one problem of 250 real rows, past the rows its shared memory
     stages) against its plain version and scipy, with tied costs too, timed
     from CUDA graphs beside the bound and the serial chain; a synthetic COCO
     panoptic set (8 PNG images at COCO-like sizes
     up to 800x1333, COCO panoptic's 80 things and 53 stuff classes, thing,
     stuff and crowd segments and VOID in segment-id PNGs) evaluated by
     ``eval.main --masks --pq --panoptic_ann`` on a seeded DETR-R50 DETRsegm
     .pth with 202 logits at fp32 (TF32 off) and bf16 (A-tf32 or A-mma 18
     and C 1 an image, B 0), images/s and peak memory; the device merge
     (``inference.kept_probs`` + ``merge_full_res``) against the host's
     ``np_merge_full_res`` on the same probabilities (equal away from ties)
     and the PQ table from the host maps against eval's, the merge's time;
     ``finetune_coco_masks.main --panoptic_ann`` for 2 frozen-detector steps
     at b8 376x672 (A-tf32 18, B 1 at 100 columns, C 1 a step); the JAX
     package's panoptic recipe at full width: the panoptic train loader, 250
     queries and target slots, every group training, 3 b8 376x672 fp32 steps
     (A-tf32 18, A'-mma 18, B 1 at 250 columns, C 1 a step; halved to b4,
     logged, if b8 does not fit), busy and wall time and peak memory, the
     train state round-tripped through ``train/checkpoint.py``;
 15. JPEG: ``data/jpeg.py`` (g++) decodes every committed fixture of
     tests/data/jpeg to the SHA-256 imageio gave (``expected.json``), and
     one thread's decode time at 640x480 and 1333x800 with the host CPU's
     model; from copies of the fixtures, a COCO set of 256 JPEGs with 1-20
     boxes each: the loader's images/s, ``train_coco.main`` for 3 b8 376x672
     fp32 steps (A-tf32 18, A'-mma 18, B 1, C 1 a step), a loader-fed
     epoch's steps beside in-memory ones, ``eval.main`` at b1 over 8 (A-tf32
     18, C 1 an image); ``finetune_voc.main`` and ``finetune_hardhat.main``
     (a CSV set, "person" excluded) for 2 heads-only steps each (A-tf32 18,
     B 1, C 1); kernel B's generic instance (above 255 columns) at 6x300x300,
     12x900x900 with one problem of 900 real rows, 2x2000x2000, 1x4097x4097
     with 3900 real rows (one staged, the rest read from L2) and 1x5000x5000
     with 4800 (its state in device memory) against its plain version
     and scipy, tied costs too, timed from CUDA graphs beside the bound and
     the serial chain; one b8 376x672 fp32 step of DETR-R50 at 300 queries
     and target slots (A-tf32 18, A'-mma 18, B 1 on the generic instance,
     C 1), its busy time, B's share and peak memory; ``eval.main --masks
     --pq --panoptic_ann`` over 4 JPEG images with PNG segment maps on a
     seeded DETRsegm .pth (A-tf32 18, C 1 an image).
 16. serving artifacts: full-width DETR-R50 from a seeded facebook-named
     .pth at fp32 (TF32 off), bf16, int8 (bf16 compute, quantized on two
     seeded 800x1333 images), fused fp32 and fused bf16 (nonzero FrozenBN
     buffers) and the DETRsegm model with masks at fp32, each in a process
     of its own (the fused models' two buckets apart): exported by
     ``export.export_predictor`` (at 800x1333; the fused models at 768x1280
     too, both buckets with a masked and an unmasked program), loaded by
     ``export.load_predictor`` and served beside the live Predictor: the
     same detections within the golden tolerances (masks within 1e-4 of
     their pixels), the same launches per request with the counters reset
     just before (fp32 A-tf32 18, C 1; bf16 A-mma 18, C 1; int8 A-mma 18, F
     32, G 16; fused exact A 18, C 1, D 4, E 12; fused masked A 18, C 1, D
     16; masks A-tf32 18, C 1), the fp32 program traced at b2 serving b1 and
     b8; export and load seconds, artifact MB, and, the processes taking the
     card in turns once all are ready, p50 (p10-p90) of 30 b1 requests
     interleaved with the live Predictor's, and the device-busy time of one,
     beside the live Predictor's; a reduced model exported on the
     CPU and loaded onto the card (A-tf32 3, C 1; detections within the
     golden tolerances of the live CPU Predictor's).
 17. parallel: (b) ``multihost.initialize`` with NCCL at world size 1 and
     one ``Trainer(mesh=make_mesh(1))`` step (DDP over the one-rank NCCL
     group) against the plain Trainer's; then two rank processes sharing
     the card over Gloo (NCCL refuses two ranks on one device): (a) DDP,
     full-width DETR-R50 fp32 at b8 376x672 as 2 x b4 with uneven box
     counts, 2 steps at dropout 0 with the counters reset just before
     (per rank and step A-tf32 18, A'-mma 18, B 1, C 1), the losses, the
     first step's gradients and the parameters after both steps against
     the one-process b8 Trainer's, then 4 steps at dropout 0.1 with the
     parameters bit-equal across the ranks after each; (c) Megatron tensor
     parallelism, the transformer split 4 + 4 heads, b2 376x672 at dropout
     0: the forward (A-tf32 18 a rank at H = 4, C 1; with the loss and the
     backward, A'-mma 18 and B 1 more) and every gradient, gathered whole,
     against the unsplit model. Readings, labelled as two
     ranks sharing one card: each rank's step wall, the gradient
     all-reduce under ``torch.profiler`` and alone, beside the one-process
     b8 step of phase 9.
Kernel C runs in every ``ResNetBackbone`` forward: serving, training and
fused serving count it (1 per forward or step); the int8 model's stem is
not a ``ResNetBackbone`` and launches none.
Kernel times: every kernel, B included, from CUDA graphs: their calls are
shorter than the wrapper's host cost (B's loop of calls is printed beside,
as a time that includes the host).
Every kernel's record carries its bound (bytes over 3.35 TB/s or operations
over the published peak of their type) and, where one PyTorch call computes
the same function, that call's time as a yardstick the port never calls.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import functools
import importlib.util
import io
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

# The seeded inputs the card tests share: B's wide problems and the JPEG sets.
_spec = importlib.util.spec_from_file_location(
    "smoke_inputs", Path(__file__).resolve().parent / "scripts" / "smoke_inputs.py")
smoke_inputs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke_inputs)
JPEG_DIR, HARDHAT_CLASSES, LAP_GENERIC = (smoke_inputs.JPEG_DIR, smoke_inputs.HARDHAT_CLASSES,
                                          smoke_inputs.LAP_GENERIC)
generic_lap_problems, jpeg_sources, write_jpeg_sets = (
    smoke_inputs.generic_lap_problems, smoke_inputs.jpeg_sources, smoke_inputs.write_jpeg_sets)

# (Lq, Lk) of every attention call on the served path: encoder self and
# decoder cross at the 896x1408 and 800x1344 buckets, decoder self, and
# the 512x640 bucket's encoder self.
ATTN_SHAPES = [(1232, 1232), (100, 1232), (1050, 1050), (100, 1050), (100, 100), (320, 320)]
TIMED_SHAPES = [(1232, 1232), (100, 1232)]
# Batch 1 at the 896x1408 bucket: encoder self, decoder cross, decoder self.
B1_TIMED_SHAPES = [(1232, 1232), (100, 1232), (100, 100)]
ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
LAUNCHES_PER_FORWARD = 18  # 6 encoder self + 6 decoder self + 6 decoder cross
BOX_ATOL, LOGIT_ATOL = 5e-4, 5e-3  # kernel model vs plain-attention model, fp32
PADDED_BOX_ATOL = 1e-3
SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu", "lap.cu", "int8_matmul.cu",
           "int8_conv.cu", "maxpool.cu", "fused_residual.cu", "fused_bottleneck.cu",
           "flash_attention_fwd_mma.cu", "flash_attention_bwd_mma.cu",
           "flash_attention_fwd_tf32.cu", "fused_bottleneck_mma.cu", "fused_bottleneck_tf32.cu",
           "fused_residual_mma.cu", "fused_residual_tf32.cu", "flash_attention_bwd_bf16.cu")
MMA_SOURCES = ("flash_attention_fwd_mma.cu", "flash_attention_bwd_mma.cu",
               "flash_attention_fwd_tf32.cu", "fused_bottleneck_mma.cu", "fused_bottleneck_tf32.cu",
               "fused_residual_mma.cu", "fused_residual_tf32.cu", "flash_attention_bwd_bf16.cu")
CSRC = "detr_tensorflow_tpu_torch/csrc/"
REPLACES = {
    "flash_attention_fwd": "detr_tensorflow_tpu/ops/pallas/flash_attention.py:77",
    "flash_attention_fwd_mma": "detr_tensorflow_tpu/ops/pallas/flash_attention.py:77",
    "flash_attention_fwd_tf32": "detr_tensorflow_tpu/ops/pallas/flash_attention.py:77",
    "flash_attention_bwd": "detr_tensorflow_tpu/ops/pallas/flash_attention.py:115",
    "flash_attention_bwd_mma": "detr_tensorflow_tpu/ops/pallas/flash_attention.py:115",
    "flash_attention_bwd_bf16": "detr_tensorflow_tpu/ops/pallas/flash_attention.py:115",
    "lap": "detr_tensorflow_tpu/ops/pallas/lap.py:77",
    "lap_wide": "detr_tensorflow_tpu/ops/pallas/lap.py:77",
    "lap_generic": "detr_tensorflow_tpu/ops/pallas/lap.py:77",
    "int8_matmul": "detr_tensorflow_tpu/ops/pallas/int8_matmul.py:96",
    "int8_conv": "detr_tensorflow_tpu/ops/pallas/int8_conv.py:64",
    "maxpool": "detr_tensorflow_tpu/ops/pallas/maxpool.py:99",
    "fused_residual": "detr_tensorflow_tpu/ops/pallas/fused_residual.py:37",
    "fused_residual_mma": "detr_tensorflow_tpu/ops/pallas/fused_residual.py:37",
    "fused_residual_tf32": "detr_tensorflow_tpu/ops/pallas/fused_residual.py:37",
    "fused_bottleneck": "detr_tensorflow_tpu/ops/pallas/fused_bottleneck.py:54",
    "fused_bottleneck_mma": "detr_tensorflow_tpu/ops/pallas/fused_bottleneck.py:54",
    "fused_bottleneck_tf32": "detr_tensorflow_tpu/ops/pallas/fused_bottleneck.py:54",
}
DEVICE = "cuda"
# Published H100 SXM peaks (dense tensor-core rates; fp32 without them): bound_ms is the larger
# of bytes over the memory rate and operations over the peak of their type.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1.979e15, "bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}

# Training: (Lq, Lk) of encoder self, decoder cross and decoder self
# attention at 376x672 (a 12x21 = 252-key map), batch 8, 8 heads, Dh 32;
# each runs 6 times a step. A' is timed at each of them.
TRAIN_ATTN_SHAPES = [(252, 252), (100, 252), (100, 100)]
DROPOUT = 0.1
# Gradient tolerance relative to the largest reference value: fp32 differs
# by summation order; bf16 rounds P and dS at the TPU kernel's points, the
# plain version at autograd's.
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 5e-2}
LAP_PROBLEMS, LAP_SLOTS, LAP_MAX_REAL = 48, 100, 30
TRAIN_BATCH, TRAIN_HW, TRAIN_STEPS = 8, (376, 672), 8
TRAIN_STEM = (8, 64, 188, 336)  # kernel C's input in a training step: conv1's output
BACKGROUND = 91  # DETR-R50's "no object" logit of 92
LOSS_RTOL, TENSOR_GRAD_RTOL, NOISE_FLOOR = 1e-4, 1e-3, 1e-6
# The bf16 step (float32 parameters, bf16 compute), b8 376x672, dropout 0.1.
# Parity at dropout 0 and at dropout 0.1 (A-mma forward, A'-bf16 backward,
# every route given the same masks): the kernel
# route's loss within BF16_LOSS_RTOL of the plain route's (the two round
# attention at different points, and the rounding noise of a bf16 forward
# reaches the loss at ~1e-3), and its gradients, against the fp32 step's on
# the same weights, no further than the plain route's: the median relative
# distance over the tensors within BF16_GAP_FACTOR, each tensor within
# BF16_TENSOR_GAP_FACTOR (two draws of bf16 rounding noise;
# tests/test_torch_bf16.py measured 2.4x on a tensor against the JAX
# package's bf16 step). A guard that the routes drew the same masks: the
# plain route's median distance from the fp32 step within
# BF16_SAME_MASKS_GAP (0.046 at dropout 0).
BF16_TRAIN_STEPS = 4
BF16_LOSS_RTOL, BF16_GAP_FACTOR, BF16_TENSOR_GAP_FACTOR = 1e-2, 2.0, 3.0
BF16_SAME_MASKS_GAP = 0.25

# int8 serving: one DETR-R50 forward at the 896x1408 bucket launches F 32
# times (conv1 x16, conv3 tail x16) and G 16 times (13 stride 1, 3 stride 2).
INT8_BUCKET = (896, 1408)
F_PER_FORWARD = {"plain": 16, "residual": 12, "residual2": 4}
G_PER_FORWARD = {1: 13, 2: 3}
# c5 against the fp32 backbone: the PTQ bounds of tests/test_quantized.py.
C5_MAX_REL, C5_MIN_CORR = 0.10, 0.99

# The fused-backbone model: one b1 forward at a masked bucket runs D on all
# 16 bottlenecks; at a bucket-exact one D on the 4 block_0s, E on the 12
# identity blocks. Kernel D and E against their plain versions, relative to
# the largest reference value: fp32 sums in another order; bf16 rounds at
# the same points, and a sum on the other side of a rounding boundary moves
# one bf16 ulp (2^-8). c5 of the fused against the unfused model at fp32:
# the same arithmetic in another order over 16 blocks (rel 1e-4). The fused
# bf16 model rounds at fewer points than the unfused bf16 model (T1 and T2
# only, inside E), so its c5 may be no further from the unfused fp32
# model's than FUSED_BF16_C5_RATIO times the unfused bf16 model's.
FUSED_MASKED, FUSED_EXACT = (896, 1408), (768, 1280)
FUSED_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
FUSED_C5_RTOL = 1e-4
FUSED_BF16_C5_RATIO = 2.0
# (C, SIMT D, D-mma, D-tf32, SIMT E, E-mma, E-tf32) per b1 forward of the fused model.
FUSED_PER_FORWARD = {("exact", "float32"): (1, 0, 0, 4, 0, 0, 12),
                     ("masked", "float32"): (1, 0, 0, 16, 0, 0, 0),
                     ("exact", "bfloat16"): (1, 0, 4, 0, 0, 12, 0),
                     ("masked", "bfloat16"): (1, 0, 16, 0, 0, 0, 0)}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, ops: dict) -> tuple:
    """(least time in ms, "bytes" or "operations") for moving ``nbytes`` and
    doing ``ops`` ({dtype: count}) at the card's published peaks."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = sum(n / PEAK_OPS_S[dtype] for dtype, n in ops.items())
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sdpa(torch, q, k, v, mask, dropout_p=0.0):
    """The library call for attention, yardstick only: PyTorch's
    scaled_dot_product_attention on (B, H, L, Dh) views, Q already scaled,
    ``mask`` True = padded key."""
    keep = None if mask is None else ~mask[:, None, None, :]
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=keep,
        dropout_p=dropout_p, scale=1.0)


def graph_ms(torch, fn, iters: int = 20, replays: int = 3) -> float:
    """Device time of one ``fn`` call in ms: ``iters`` calls captured in a
    CUDA graph, replayed ``replays`` times between CUDA events, so the host's
    cost of launching (the Python wrapper, ~40 us a call) is not in it."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def device_busy_ms(torch, fn, calls: int = 3):
    """(wall ms, device-busy ms, device events) per call of ``fn`` over
    ``calls`` calls under torch.profiler, busy being the union of the card's
    kernel and copy intervals and events their count: 1 - busy / wall is the
    device's idle share, the profiler's own host cost included. Busy is None
    where the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / calls
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    return wall_ms, (busy_us / 1e3 / calls if spans else None), len(spans) / calls


def kernel_ms(torch, fn, names) -> tuple:
    """One ``fn`` call under torch.profiler: (the device time of all its
    kernels, {name: the device time of the kernels whose name contains it})
    in ms, summed over launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    return total, {n: sum(e.time_range.elapsed_us() for e in kernels if n in e.name) / 1e3
                   for n in names}


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn`` in ms, from CUDA events around ``iters`` calls: the
    host's cost of each call included where it exceeds the device's."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(torch, b, lq, lk, dtype, seed):
    rng = np.random.default_rng(seed)
    h, dh = 8, 32
    q = rng.normal(size=(b, lq, h, dh)) * dh**-0.5
    k = rng.normal(size=(b, lk, h, dh))
    v = rng.normal(size=(b, lk, h, dh))
    # Row 0 loses a ragged tail, row 1 about half its keys.
    valid = np.array([lk - lk // 7, lk // 2 + 1][:b])
    mask = np.arange(lk)[None, :] >= valid[:, None]
    to = lambda x: torch.from_numpy(x).to(DEVICE, dtype)  # noqa: E731
    return to(q), to(k), to(v), torch.from_numpy(mask).to(DEVICE)


def attention_bound(b, lq, lk, name, masked=True, lse=False):
    """q, k, v in and out written once, the mask's bytes and the row lse
    where the call has them; 4 * Lq * Lk * Dh flops a head (QK^T and PV) at
    the peak of the dtype, three times over for "tf32" (3xTF32 products)."""
    size = 2 if name == "bfloat16" else 4
    nbytes = b * 8 * 32 * (2 * lq + 2 * lk) * size + (b * lk if masked else 0)
    flops = 4 * b * 8 * lq * lk * 32
    return bound_ms(nbytes + (b * 8 * lq * 4 if lse else 0),
                    {name: 3 * flops if name == "tf32" else flops})


def exp_floor_ms(b, lq, lk):
    """One exp per (query, key) pair of the 8 heads on the SFUs: 16 a clock
    on each of 132 SMs at the 1.98 GHz boost clock."""
    return 1e3 * b * 8 * lq * lk / (16 * 132 * 1.98e9)


def check_attention(name, label, out, ref, q):
    if out.shape != q.shape or out.dtype != q.dtype:
        raise AssertionError(f"{label} output {out.shape} {out.dtype}")
    err = float((out.float() - ref.float()).abs().max())
    if not err <= ATOL[name]:
        raise AssertionError(f"{label} disagrees with plain: {err} > {ATOL[name]}")
    return err


def forward_counts(fa):
    """Forward launches so far: (SIMT A, A-mma, A-tf32)."""
    return fa.mha.launches, fa.mha.mma_launches, fa.mha.tf32_launches


def phase_kernels(torch, fa):
    """Kernel A on its three routes at every attention shape of the served
    path, against the plain version: fp32 through ``mha`` (the 3xTF32
    tensor-core kernel A-tf32), bf16 through ``mha`` (the bf16 tensor-core
    kernel A-mma), and both dtypes through the SIMT kernel called directly.
    Then, at batch 2 and at the b1 shapes, the tensor-core kernel of each
    dtype (at each CTA shape, masked and not) and the SIMT kernel are held
    against plain again and timed from CUDA graphs with plain and SDPA."""
    worst = {"float32": 0.0, "bfloat16": 0.0, "simt float32": 0.0, "simt bfloat16": 0.0}
    routes = {"float32": ("tf32", (0, 0, 1)), "bfloat16": ("mma", (0, 1, 0))}
    for lq, lk in ATTN_SHAPES:
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v, mask = attention_inputs(torch, 2, lq, lk, dtype, seed=lq * 7 + lk)
            before = forward_counts(fa)
            out = fa.mha(q, k, v, mask)
            routed = tuple(a - b for a, b in zip(forward_counts(fa), before))
            route, expected = routes[name]
            if routed != expected:
                raise AssertionError(f"({lq},{lk}) {name}: (simt, mma, tf32) launches {routed}")
            ref = fa.reference_mha(q, k, v, mask)
            torch.cuda.synchronize()
            err = check_attention(name, f"{route} ({lq},{lk}) {name}", out, ref, q)
            worst[name] = max(worst[name], err)
            simt = fa.launch_forward_simt(q, k, v, mask, None, 0.0, False)[0]
            torch.cuda.synchronize()
            simt_err = check_attention(name, f"simt ({lq},{lk}) {name}", simt, ref, q)
            worst[f"simt {name}"] = max(worst[f"simt {name}"], simt_err)
            log(f"  attention ({lq},{lk}) {name}: {route} max_abs_err {err:.3e}, simt "
                f"{simt_err:.3e} (tol {ATOL[name]})")

    times = {}
    for b, shapes in ((2, TIMED_SHAPES), (1, B1_TIMED_SHAPES)):
        for lq, lk in shapes:
            for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
                q, k, v, mask = attention_inputs(torch, b, lq, lk, dtype, seed=lq * 5 + lk + b)
                route = routes[name][0]
                simt = lambda: fa.launch_forward_simt(  # noqa: E731
                    q, k, v, mask, None, 0.0, False)
                plain = lambda: fa.reference_mha(q, k, v, mask)  # noqa: E731
                fast = lambda m=mask: fa.mha(q, k, v, m)  # noqa: E731

                def at_shape(shape):
                    if name == "bfloat16":
                        return fa.launch_forward_mma(q, k, v, mask, False, shape=shape)
                    return fa.launch_forward_tf32(q, k, v, mask, None, 0.0, False, shape=shape)

                # Each kernel, and each CTA shape of the tensor-core kernel, against
                # plain at this batch before it is timed (b1 is the served batch).
                outs = {("simt", True): simt()[0], (route, True): fast(), (route, False): fast(None)}
                refs = {True: plain(), False: fa.reference_mha(q, k, v)}
                for shape in fa.MMA_SHAPES:
                    outs[(shape, True)] = at_shape(shape)[0]
                torch.cuda.synchronize()
                errs = []
                for (what, m), out in outs.items():
                    errs.append(check_attention(
                        name, f"{what} ({lq},{lk}) {name} B={b} masked {m}", out, refs[m], q))
                    key = f"simt {name}" if what == "simt" else name
                    worst[key] = max(worst[key], errs[-1])
                t = {}
                p1, s1, m1, m2, s2, p2 = (graph_ms(torch, f)
                                          for f in (plain, simt, fast, fast, simt, plain))
                t[route], t["simt"], t["plain"] = (m1 + m2) / 2, (s1 + s2) / 2, (p1 + p2) / 2
                # Without the key-padding mask (the decoder's self-attention has none).
                t[f"{route} unmasked"] = graph_ms(torch, lambda: fast(None))
                t["sdpa unmasked"] = graph_ms(torch, lambda: sdpa(torch, q, k, v, None))
                for shape in fa.MMA_SHAPES:
                    t[shape] = graph_ms(torch, lambda: at_shape(shape))
                t["sdpa"] = graph_ms(torch, lambda: sdpa(torch, q, k, v, mask))
                t["bound"] = attention_bound(b, lq, lk, name)
                if name == "float32":
                    t["bound3x"] = attention_bound(b, lq, lk, "tf32")
                times[(b, lq, lk, name)] = t
                sms = torch.cuda.get_device_properties(0).multi_processor_count
                shape = fa.cta_shape(b * 8, lq, sms)
                bound3x = (f", {t['bound3x'][0]:.4f} ms as 3xTF32 ({t['bound3x'][1]})"
                           if name == "float32" else "")
                log(f"  attention ({lq},{lk}) {name} B={b}: {len(errs)} outputs against plain, "
                    f"max_abs_err {max(errs):.3e} (tol {ATOL[name]})")
                log(f"  attention ({lq},{lk}) {name} B={b} H=8 Dh=32, CUDA graphs: {route} "
                    f"{t[route]:.4f} ms ({m1:.4f}, {m2:.4f}; CTA shape {shape}; "
                    + ", ".join(f"{s_} {t[s_]:.4f}" for s_ in fa.MMA_SHAPES)
                    + f"; unmasked {t[route + ' unmasked']:.4f}, scaled_dot_product_attention "
                    f"unmasked {t['sdpa unmasked']:.4f}), simt {t['simt']:.4f} ms, plain "
                    f"{t['plain']:.4f} ms, library scaled_dot_product_attention {t['sdpa']:.4f} "
                    f"ms, bound {t['bound'][0]:.4f} ms ({t['bound'][1]}){bound3x}, exp floor "
                    f"{exp_floor_ms(b, lq, lk):.4f} ms")
    return worst, times


def train_attention_inputs(torch, lq, lk, dtype, seed, masked, b=8):
    rng = np.random.default_rng(seed)
    h, dh = 8, 32
    q = rng.normal(size=(b, lq, h, dh)) * dh**-0.5
    k, v, dout = (rng.normal(size=s) for s in ((b, lk, h, dh), (b, lk, h, dh), (b, lq, h, dh)))
    to = lambda x: torch.from_numpy(x).to(DEVICE, dtype)  # noqa: E731
    mask = None
    if masked:  # a ragged key-padding mask: each image keeps its own prefix
        valid = rng.integers(lk // 3, lk + 1, size=b)
        mask = torch.from_numpy(np.arange(lk)[None, :] >= valid[:, None]).to(DEVICE)
    return to(q), to(k), to(v), to(dout), mask


def attention_grads(torch, fn, q, k, v, dout):
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    out.backward(dout)
    return out.detach(), q.grad, k.grad, v.grad


def phase_train_kernels(torch, fa):
    """Kernel A with dropout and kernel A' at the training shapes: through
    ``mha`` (fp32: A-tf32 and the tensor-core A' (3xTF32), bf16: A-mma and
    A'-bf16), and the SIMT A' called directly at both dtypes; each against
    plain autograd at dropout 0 and 0.1. Then, at every training shape and
    dropout 0.1, the forward and the backward from CUDA graphs, in turns: at
    fp32 A-tf32, the SIMT A, the tensor-core A' and the SIMT A'; at bf16
    A-mma, the SIMT A, A'-bf16 and the SIMT A'; each beside plain and SDPA
    (``time_train_forward``, ``time_train_attention``)."""
    worst = {"float32": 0.0, "bfloat16": 0.0, "simt float32": 0.0, "simt bfloat16": 0.0}
    times, fwd_times = {}, {}
    for lq, lk in TRAIN_ATTN_SHAPES:
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            masked = (lq, lk) == (100, 252)
            q, k, v, dout, mask = train_attention_inputs(torch, lq, lk, dtype, lq * 3 + lk, masked)
            for rate in (0.0, DROPOUT):
                seed = torch.tensor([lq * 100003 + lk * 7 + int(rate * 10)], device=DEVICE)
                keep = None
                if rate:
                    keep = fa.kernel_keep_mask(seed, 64, lq, lk, rate)
                    if not torch.equal(keep, fa.keep_mask(seed, 64, lq, lk, rate)):
                        raise AssertionError("kernel dropout bits differ from the PyTorch Philox")
                    kept, n = float(keep.float().mean()), keep.numel()
                    if abs(kept - (1 - rate)) > 5 * (rate * (1 - rate) / n) ** 0.5:
                        raise AssertionError(f"keep rate {kept} at ({lq},{lk})")
                    keep = keep.view(8, 8, lq, lk)
                got = attention_grads(torch, lambda *t: fa.mha(*t, mask, rate, seed), q, k, v, dout)
                ref = attention_grads(torch, lambda *t: fa.reference_mha(*t, mask, keep, rate),
                                      q, k, v, dout)
                checks = [(name, zip(got, ref, ("out", "dq", "dk", "dv")))]
                out, lse = fa.launch_forward(q, k, v, mask, seed, rate, True)
                simt = fa.launch_backward_simt(q, k, v, out, dout, lse, mask, seed, rate)
                checks.append((f"simt {name}", zip(simt, ref[1:], ("dq", "dk", "dv"))))
                torch.cuda.synchronize()
                errs = []
                for label, pairs in checks:
                    for g, r, what in pairs:
                        err = float((g.float() - r.float()).abs().max())
                        scale = max(1.0, float(r.float().abs().max()))
                        tol = ATOL[name] if what == "out" else GRAD_RTOL[name] * scale
                        if not err <= tol:
                            raise AssertionError(f"{label} {what} disagrees with plain autograd "
                                                 f"at ({lq},{lk}) dropout {rate}: {err} > {tol}")
                        if what != "out":
                            worst[label] = max(worst[label], err)
                        errs.append(f"{'simt ' if label.startswith('simt') else ''}{what} "
                                    f"{err:.2e}")
                route = fa.backward_route(dtype, 32)
                log(f"  attention fwd+bwd ({lq},{lk}) {name} dropout {rate}"
                    f"{' masked' if masked else ''}, backward route {route}: {', '.join(errs)}")
            key = (lq, lk) if name == "float32" else (lq, lk, name)
            fwd_times[key] = time_train_forward(torch, fa, q, k, v, mask)
            times[key] = time_train_attention(torch, fa, q, k, v, dout, mask)
    return worst, times, fwd_times


def graph_turns(torch, fns, routes):
    """Each of ``routes`` (keys of ``fns``) and plain from CUDA graphs in
    turns (plain, the routes, the routes backwards, plain): {route: (mean,
    (first, second))}."""
    turns = ["plain"] + routes + routes[::-1] + ["plain"]
    runs = collections.defaultdict(list)
    for what in turns:
        runs[what].append(graph_ms(torch, fns[what], iters=10))
    return {what: (sum(r) / 2, tuple(r)) for what, r in runs.items()}


def time_train_forward(torch, fa, q, k, v, mask):
    """A at one training shape (b8, dropout 0.1, with the row lse the
    backward reads) from CUDA graphs, each kernel held against plain given
    the kernel library's keep mask first: the tensor-core kernel of the
    dtype's route (fp32: A-tf32, bf16: A-mma) at the CTA shape ``cta_shape``
    picks and at each shape, and the SIMT kernel called directly. Kernels
    and plain in turns, SDPA's forward with ``dropout_p`` beside; the bound
    at the dtype's peak (the fp32 pipes or bf16) and, at fp32, as 3xTF32 on
    the tensor cores."""
    name = "float32" if q.dtype == torch.float32 else "bfloat16"
    lq, lk = q.shape[1], k.shape[1]
    seed = torch.tensor([54321], device=DEVICE)
    keep = fa.kernel_keep_mask(seed, 64, lq, lk, DROPOUT).view(8, 8, lq, lk)
    route = fa.forward_route(q.dtype, DROPOUT, 32)
    if route == "tf32":
        fast = lambda shape=None: fa.launch_forward_tf32(  # noqa: E731
            q, k, v, mask, seed, DROPOUT, True, shape=shape)
    else:
        fast = lambda shape=None: fa.launch_forward_mma(  # noqa: E731
            q, k, v, mask, True, dropout_seed=seed, dropout_rate=DROPOUT, shape=shape)
    fns = {"plain": lambda: fa.reference_mha(q, k, v, mask, keep, DROPOUT),
           "simt": lambda: fa.launch_forward_simt(q, k, v, mask, seed, DROPOUT, True),
           route: fast}
    fns.update({shape: functools.partial(fast, shape) for shape in fa.MMA_SHAPES})
    routes, shapes = [route, "simt"], list(fa.MMA_SHAPES)
    ref = fns["plain"]()
    outs = {what: fns[what]()[0] for what in routes + shapes}
    torch.cuda.synchronize()
    errs = {what: check_attention(name, f"{what} ({lq},{lk}) {name} dropout {DROPOUT}", out, ref,
                                  q) for what, out in outs.items()}
    turns = graph_turns(torch, fns, routes)
    t = {what: mean for what, (mean, _) in turns.items()}
    t.update({shape: graph_ms(torch, fns[shape], iters=10) for shape in shapes})
    t.update(err=max(errs.values()), errs=errs,
             sdpa=graph_ms(torch, lambda: sdpa(torch, q, k, v, mask, DROPOUT), iters=10),
             bound=attention_bound(8, lq, lk, name, mask is not None, lse=True))
    label = {"tf32": "A-tf32", "mma": "A-mma", "simt": "SIMT A"}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"  attention forward ({lq},{lk}) {name} B=8 H=8 Dh=32 dropout {DROPOUT}"
        f"{' masked' if mask is not None else ''}, against plain given the keep mask: "
        + ", ".join(f"{w} {e:.2e}" for w, e in errs.items()) + "; CUDA graphs: "
        + ", ".join(f"{label[w]} {t[w]:.4f} ms ({turns[w][1][0]:.4f}, {turns[w][1][1]:.4f})"
                    for w in routes)
        + f" ({label[route]} CTA shape {fa.cta_shape(64, lq, sms)}; "
        + ", ".join(f"{s_} {t[s_]:.4f}" for s_ in shapes) + ")"
        + f", plain {t['plain']:.4f} ms, library scaled_dot_product_attention with dropout_p "
        f"{t['sdpa']:.4f} ms, bound {t['bound'][0]:.4f} ms at the {name} peak "
        f"({t['bound'][1]})")
    if name == "float32":
        t["bound3x"] = attention_bound(8, lq, lk, "tf32", mask is not None, lse=True)
        log(f"    bound as 3xTF32 {t['bound3x'][0]:.4f} ms ({t['bound3x'][1]})")
    return t


def time_train_attention(torch, fa, q, k, v, dout, mask):
    """A' at one training shape (b8, dropout 0.1) from CUDA graphs: at fp32
    the tensor-core kernel (3xTF32) and the SIMT kernel, at bf16 A'-bf16
    (the route bf16 takes) and the SIMT kernel, in turns with plain, SDPA's
    backward beside;
    the plain and library backwards as a graph of forward and backward
    less one of the forward (autograd runs a backward on its forward's
    stream, so both are captured). The bound at the dtype's peak (the fp32
    pipes or bf16) and, at fp32, as 3xTF32 on the tensor cores."""
    name = "float32" if q.dtype == torch.float32 else "bfloat16"
    lq, lk = q.shape[1], k.shape[1]
    seed = torch.tensor([12345], device=DEVICE)
    keep = fa.keep_mask(seed, 64, lq, lk, DROPOUT).view(8, 8, lq, lk)
    out, lse = fa.launch_forward(q, k, v, mask, seed, DROPOUT, True)
    args = (q, k, v, out, dout, lse, mask, seed, DROPOUT)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    plain_fwd = lambda: fa.reference_mha(qr, kr, vr, mask, keep, DROPOUT)  # noqa: E731
    fns = {"plain": lambda: torch.autograd.grad(plain_fwd(), (qr, kr, vr), dout),
           "simt": lambda: fa.launch_backward_simt(*args),
           "mma": lambda: fa.launch_backward_mma(*args),
           "bf16": lambda: fa.launch_backward_bf16(*args)}
    routes = ["mma", "simt"] if name == "float32" else ["bf16", "simt"]
    turns = graph_turns(torch, fns, routes)
    t = {what: mean for what, (mean, _) in turns.items()}
    t["plain"] -= graph_ms(torch, plain_fwd, iters=10)
    qs, ks, vs = (t_.detach().clone().requires_grad_() for t_ in (q, k, v))
    lib_fwd = lambda: sdpa(torch, qs, ks, vs, mask, DROPOUT)  # noqa: E731
    lib_all = lambda: torch.autograd.grad(  # noqa: E731
        lib_fwd(), (qs, ks, vs), dout.transpose(1, 2))
    t["sdpa"] = graph_ms(torch, lib_all, iters=10) - graph_ms(torch, lib_fwd, iters=10)
    # q, k, v, dout in; dq, dk, dv out; the row lse; the mask; and at fp32
    # out, which A'-mma reads for delta (A'-bf16 and the SIMT A' sum delta
    # over the keys and never read it). Five products of 2 * Dh flops per
    # (query, key) pair and head.
    size = q.element_size()
    query_side = 4 if name == "float32" else 3
    nbytes = (8 * 8 * 32 * (query_side * lq + 4 * lk) * size + 8 * 8 * lq * 4
              + (8 * lk if mask is not None else 0))
    flops = 10 * 8 * 8 * lq * lk * 32
    t["bound"] = bound_ms(nbytes, {name: flops})
    label = {"mma": "tensor-core A'", "bf16": "A'-bf16", "simt": "SIMT A'"}
    log(f"  attention backward ({lq},{lk}) {name} B=8 H=8 Dh=32 dropout {DROPOUT}"
        f"{' masked' if mask is not None else ''}, CUDA graphs: "
        + ", ".join(f"{label[w]} {t[w]:.4f} ms ({turns[w][1][0]:.4f}, {turns[w][1][1]:.4f})"
                    for w in routes)
        + f", plain {t['plain']:.4f} ms, library scaled_dot_product_attention backward "
        f"{t['sdpa']:.4f} ms (plain and library: forward and backward less forward), bound "
        f"{t['bound'][0]:.4f} ms at the {name} peak ({t['bound'][1]})")
    if name == "float32":
        t["bound3x"] = bound_ms(nbytes, {"tf32": 3 * flops})
        log(f"    bound as 3xTF32 {t['bound3x'][0]:.4f} ms ({t['bound3x'][1]})")
    return t


def lap_problems(seed, ties=False, scattered=False):
    """48 problems of 100 x 100 costs with 0-30 real rows each: a prefix of
    the rows (``pad_targets``' masks) or, ``scattered``, anywhere."""
    rng = np.random.default_rng(seed)
    shape = (LAP_PROBLEMS, LAP_SLOTS, LAP_SLOTS)
    cost = (rng.integers(0, 4, size=shape) if ties else rng.normal(size=shape)).astype(np.float32)
    n_real = rng.integers(0, LAP_MAX_REAL + 1, size=LAP_PROBLEMS)
    n_real[:2] = 0, LAP_MAX_REAL
    mask = np.arange(LAP_SLOTS)[None, :] < n_real[:, None]
    if scattered:
        mask = np.stack([rng.permutation(m) for m in mask])
    return cost, mask, n_real


def phase_lap(torch, lap):
    from scipy.optimize import linear_sum_assignment

    worst = 0.0
    for ties, scattered in ((False, False), (False, True), (True, False)):
        cost, mask, n_real = lap_problems(3 + ties, ties, scattered)
        ct, mt = torch.from_numpy(cost).to(DEVICE), torch.from_numpy(mask).to(DEVICE)
        got = lap.solve_lap_masked(ct, mt).cpu().numpy()
        t0 = time.perf_counter()
        plain = lap.reference_solve_lap_masked(ct, mt).cpu().numpy()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        scipy_cols = [linear_sum_assignment(c[m])[1] for c, m in zip(cost, mask)]
        scipy_ms = 1e3 * (time.perf_counter() - t0)
        for i, (m, n) in enumerate(zip(mask, n_real)):
            if (got[i, ~m] != -1).any() or len(set(got[i, m].tolist())) != n:
                raise AssertionError(f"problem {i}: not an assignment of its {n} real rows")
            best = float(cost[i, m][np.arange(n), scipy_cols[i]].sum())
            err = abs(float(cost[i, m][np.arange(n), got[i, m]].sum()) - best)
            worst = max(worst, err)
            if not err <= 1e-4 * max(1.0, abs(best)):
                raise AssertionError(f"problem {i}: cost {err} above the optimum")
            if not ties and ((got[i, m] != scipy_cols[i]).any() or (got[i] != plain[i]).any()):
                raise AssertionError(f"problem {i}: assignment differs from plain/scipy")
        if ties:
            log("  lap tied costs: optimal cost equal to scipy's on every problem")
        elif scattered:
            log("  lap scattered row masks: assignments equal to plain and scipy")
        else:
            call = lambda: lap.solve_lap_masked(ct, mt)  # noqa: E731
            ms = graph_ms(torch, call)
            loop_ms = time_ms(torch, call, iters=20, warmup=3)
            chain = max(lap.augmenting_steps(ct.cpu(), mt.cpu()))
            # The kernel reads the cost rows of real targets only; the
            # operations of the augmenting paths are a few per cost read.
            bound = bound_ms(4 * LAP_SLOTS * int(n_real.sum()) + 5 * mask.size, {})
            times = (ms, plain_ms, scipy_ms, bound, loop_ms, chain)
            log(f"  lap {LAP_PROBLEMS}x{LAP_SLOTS}x{LAP_SLOTS}, n_real 0..{LAP_MAX_REAL}: "
                f"kernel {ms:.4f} ms from CUDA graphs, {loop_ms:.4f} ms a call from CUDA events "
                f"around a loop of calls (host included), plain (on the card's tensors) "
                f"{plain_ms:.2f} ms, scipy host loop {scipy_ms:.2f} ms (no single PyTorch call "
                f"solves it), bound {bound[0]:.5f} ms ({bound[1]}); serial chain of the longest "
                f"problem {chain} Dijkstra steps (plain version's count); assignments equal to "
                f"plain and scipy")
    return worst, times


def random_images(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in shapes]


def check_detections(dets, num_classes=92):
    for d in dets:
        n = len(d.boxes)
        if d.boxes.shape != (n, 4) or len(d.labels) != n or len(d.scores) != n:
            raise AssertionError("ragged detection arrays")
        if not (np.isfinite(d.boxes).all() and np.isfinite(d.scores).all()):
            raise AssertionError("non-finite detections")
        if n and not ((d.boxes >= 0).all() and (d.boxes <= 1).all()
                      and (d.labels >= 0).all() and (d.labels < num_classes).all()
                      and (d.scores > 0).all() and (d.scores <= 1).all()):
            raise AssertionError("detections out of range")


def tf32_default_reading(torch, model, x, mask, tf32_defaults):
    """The fp32 forward under torch's default TF32 flags ``tf32_defaults``
    ((matmul, cuDNN), read before main turns both off) against the same
    forward with TF32 off: max |delta| of boxes and logits beside the golden
    tolerances. A reading, not a gate; both flags are restored."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = tuple(f.allow_tf32 for f in flags)
    try:
        with torch.inference_mode():
            ref = model(x, mask)
            for f, value in zip(flags, tf32_defaults):
                f.allow_tf32 = value
            out = model(x, mask)
        torch.cuda.synchronize()
    finally:
        for f, value in zip(flags, saved):
            f.allow_tf32 = value
    errs = {k: float((out[k] - ref[k]).abs().max()) for k in ("pred_boxes", "pred_logits")}
    log(f"  fp32 forward under torch's default TF32 flags (matmul {tf32_defaults[0]}, cuDNN "
        f"{tf32_defaults[1]}) against TF32 off, unfused 800x1333 b1: boxes max |delta| "
        f"{errs['pred_boxes']:.3e} (golden tol {BOX_ATOL}), logits {errs['pred_logits']:.3e} "
        f"(golden tol {LOGIT_ATOL}); a reading, not a gate")
    return errs


def phase_serving(torch, fa, mp, api, Predictor, tf32_defaults):
    model = api.build_detr(seed=0, device=DEVICE)
    predictor = Predictor(model, background_class=91)
    img_a, img_b, img_c, img_d = random_images(
        [(800, 1333), (480, 640), (800, 1333), (800, 1333)], seed=1)
    predictor.warmup([(800, 1333), (480, 640)])

    # main path: three requests, three forwards
    fa.mha.launches = fa.mha.mma_launches = fa.mha.tf32_launches = 0
    mp.max_pool_3x3_s2.launches = 0
    t0 = time.perf_counter()
    r1 = predictor([img_a])
    t1 = time.perf_counter()
    r2 = predictor([img_b])
    t2 = time.perf_counter()
    r3 = predictor([img_c, img_d])
    t3 = time.perf_counter()
    (simt, mma, launches), pool_launches = forward_counts(fa), mp.max_pool_3x3_s2.launches
    log(f"  requests: 800x1333 b1 {1e3 * (t1 - t0):.2f} ms, 480x640 b1 "
        f"{1e3 * (t2 - t1):.2f} ms, 2x800x1333 b2 {1e3 * (t3 - t2):.2f} ms; launches: "
        f"A-tf32 {launches}, A (SIMT) {simt}, A-mma {mma}, C {pool_launches}")
    if launches != 3 * LAUNCHES_PER_FORWARD or simt or mma or pool_launches != 3:
        raise AssertionError(f"{launches} A-tf32, {simt} A, {mma} A-mma and {pool_launches} C "
                             f"launches for 3 fp32 forwards")
    for dets in (r1, r2, r3):
        check_detections(dets)
    if sorted(predictor.buckets) != [(512, 640), (896, 1408)]:
        raise AssertionError(f"buckets {predictor.buckets}")

    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        predictor([img_a])
        lat.append(1e3 * (time.perf_counter() - t0))
    fp32_ms = statistics.median(lat)
    log(f"  Predictor 800x1333 b1 fp32 latency: median {fp32_ms:.2f} ms "
        f"of {[round(x, 2) for x in lat]}")

    # The whole forward against the same weights with plain attention.
    plain = api.build_detr(seed=0, device=DEVICE, attn_impl="plain")
    frames = np.zeros((1, 896, 1408, 3), np.uint8)
    frames[0, :800, :1333] = img_a
    mask = np.zeros((1, 896, 1408), bool)
    mask[0, :800, :1333] = True
    pm = torch.from_numpy(mask).to(DEVICE)
    with torch.inference_mode():
        x = predictor.normalize(torch.from_numpy(frames).to(DEVICE)) * pm[..., None]
    ours, ref = model(x, pm), plain(x, pm)
    for key, atol in (("pred_boxes", BOX_ATOL), ("pred_logits", LOGIT_ATOL)):
        err = float((ours[key] - ref[key]).abs().max())
        log(f"  forward {key}: kernel vs plain attention max_abs_err {err:.3e} (tol {atol})")
        if not err <= atol:
            raise AssertionError(f"{key} disagrees with the plain-attention model: {err}")
    tf32_errs = tf32_default_reading(torch, model, x, pm, tf32_defaults)

    # Padded = exact: 768x1280 alone vs on an 896x1408 canvas with its mask.
    exact_img = random_images([(768, 1280)], seed=2)[0]
    with torch.inference_mode():
        alone = predictor.normalize(torch.from_numpy(exact_img[None]).to(DEVICE))
        canvas = torch.zeros((1, 896, 1408, 3), device=DEVICE)
        canvas[:, :768, :1280] = alone
        cmask = torch.zeros((1, 896, 1408), dtype=torch.bool, device=DEVICE)
        cmask[:, :768, :1280] = True
    err = float((model(alone)["pred_boxes"] - model(canvas, cmask)["pred_boxes"]).abs().max())
    log(f"  padded vs exact 768x1280 boxes max_abs_err {err:.3e} (tol {PADDED_BOX_ATOL})")
    if not err <= PADDED_BOX_ATOL:
        raise AssertionError(f"padded forward differs from exact: {err}")

    model_bf16 = api.build_detr(seed=0, device=DEVICE, dtype="bfloat16")
    pred_bf16 = Predictor(model_bf16, background_class=91)
    pred_bf16.warmup([(800, 1333)])
    fa.mha.launches = fa.mha.mma_launches = fa.mha.tf32_launches = 0  # main path
    mp.max_pool_3x3_s2.launches = 0
    t0 = time.perf_counter()
    dets = pred_bf16([img_a])
    bf16_ms = 1e3 * (time.perf_counter() - t0)
    simt, mma_launches, tf32 = forward_counts(fa)
    log(f"  bf16 request launches: A-mma {mma_launches}, A (SIMT) {simt}, A-tf32 {tf32}, "
        f"C {mp.max_pool_3x3_s2.launches}")
    if (mma_launches != LAUNCHES_PER_FORWARD or simt or tf32
            or mp.max_pool_3x3_s2.launches != 1):
        raise AssertionError(f"bf16: {mma_launches} A-mma, {simt} A, {tf32} A-tf32 and "
                             f"{mp.max_pool_3x3_s2.launches} C launches for one forward")
    pool_launches += mp.max_pool_3x3_s2.launches
    check_detections(dets)
    # The bf16 forward (A-mma) against the bf16 plain-attention model, both
    # from the fp32 weights: no further from the fp32 forward than
    # BF16_GAP_FACTOR times the plain model's own distance (max |diff|).
    plain_bf16 = api.build_detr(seed=0, device=DEVICE, dtype="bfloat16", attn_impl="plain")
    ours16, ref16 = model_bf16(x, pm), plain_bf16(x, pm)
    for key in ("pred_boxes", "pred_logits"):
        direct = float((ours16[key] - ref16[key]).abs().max())
        gap, plain_gap = (float((o[key] - ours[key]).abs().max()) for o in (ours16, ref16))
        log(f"  bf16 forward {key}: kernel vs plain attention max_abs_err {direct:.3e}; from the "
            f"fp32 forward: kernel {gap:.3e}, plain {plain_gap:.3e} (tol {BF16_GAP_FACTOR} x)")
        if not gap <= BF16_GAP_FACTOR * plain_gap:
            raise AssertionError(f"bf16 {key} further from fp32 than the plain-attention model's")
    del plain_bf16
    lat16 = []
    for _ in range(5):
        t0 = time.perf_counter()
        pred_bf16([img_a])
        lat16.append(1e3 * (time.perf_counter() - t0))
    log(f"  Predictor 800x1333 b1 bf16: first {bf16_ms:.2f} ms, median "
        f"{statistics.median(lat16):.2f} ms of {[round(x, 2) for x in lat16]}")
    del plain, model_bf16, pred_bf16
    return (predictor, launches, mma_launches, pool_launches, fp32_ms, statistics.median(lat16),
            tf32_errs)


def int8_path_shapes(height, width):
    """Every kernel F and G launch of one b1 int8 DETR-R50 forward at a
    (height, width) bucket: F as (M, C, K, Cd, variant), G as (H, W, C, K,
    stride), each with its count per forward."""
    f, g = collections.Counter(), collections.Counter()
    h, w = height, width
    for _ in range(2):  # the stem's 7x7/s2 conv and 3x3/s2 max pool
        h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    cin = 64
    for s, (n_blocks, d1, d2) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512),
                                               (256, 512, 1024, 2048))):
        for b in range(n_blocks):
            st = 2 if s and b == 0 else 1
            f[(h * w, cin, d1, 0, "plain")] += 1
            g[(h, w, d1, d1, st)] += 1
            h, w = (h - 1) // st + 1, (w - 1) // st + 1
            f[(h * w, d1, d2, cin, "residual2") if b == 0 else (h * w, d1, d2, 0, "residual")] += 1
            cin = d2
    return f, g


def f_bound_ms(m, c, k, cd, variant):
    """Kernel F's bound at one shape: x, W, the coefficients and the output
    (with the residual, or xd and Wd) each moved once; the contraction on the
    int8 tensor cores, the epilogue's fp32 terms on the fp32 pipes."""
    nbytes = m * c + k * c + 8 * k + m * k + (m * k + 4 if variant == "residual" else 0) + (
        m * cd + k * cd + 8 * k if variant == "residual2" else 0)
    terms = 2 + (2 if variant == "residual" else 0) + (4 if variant == "residual2" else 0)
    return bound_ms(nbytes, {"int8": 2 * m * k * (c + cd), "float32": terms * m * k})


def int8_operands(torch, seed):
    """Seeded int8 operands on the card: post-ReLU activations in [0, 127],
    weights in [-127, 127], per-channel scales that put the epilogue's input
    at ~40 (the int8 range), biases ~N(0, 10)."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def act(*shape):
        return torch.randint(0, 128, shape, dtype=torch.int8, device=DEVICE, generator=gen)

    def wts(*shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, device=DEVICE, generator=gen)

    def scale(k, c):  # acc std ~ sqrt(C) * 73 * 73
        return (torch.rand(k, device=DEVICE, generator=gen) + 0.5) * (40.0 / (5373.0 * c**0.5))

    def bias(k):
        return torch.randn(k, device=DEVICE, generator=gen) * 10.0

    return act, wts, scale, bias


def check_int8(torch, name, kernel, plain):
    """Kernel against its plain version on the same operands: int8 results
    integer-equal for the precise epilogue and within 1 LSB for the bf16 one
    (the same arithmetic, so equal in practice); bf16 outputs equal."""
    worst = 0
    for precise in (True, False):
        got, ref = kernel(precise=precise), plain(precise=precise)
        err = int((got.int() - ref.int()).abs().max())
        if got.shape != ref.shape or not err <= (0 if precise else 1):
            raise AssertionError(f"{name} precise={precise}: kernel vs plain off by {err}")
        worst = max(worst, err)
    got = kernel(precise=True, out_dtype=torch.bfloat16)
    if not torch.equal(got, plain(precise=True, out_dtype=torch.bfloat16)):
        raise AssertionError(f"{name}: bf16 output differs from plain")
    return worst


def phase_int8_kernels(torch, mm, conv):
    """F and G at every distinct shape of the b1 896x1408 int8 path."""
    f_shapes, g_shapes = int8_path_shapes(*INT8_BUCKET)
    act, wts, scale, bias = int8_operands(torch, seed=17)
    # Per kernel, summed over one forward's launches: kernel, plain, library
    # and bound ms, the part of the bound from launches bound by bytes, and
    # the kernel timed from a Python loop of calls (the wrapper's host cost).
    totals = {name: np.zeros(6) for name in ("int8_matmul", "int8_conv")}
    worst = {name: 0 for name in totals}
    for (m, c, k, cd, variant), count in sorted(f_shapes.items()):
        x, w, s, b = act(m, c), wts(k, c), scale(k, c), bias(k)
        if variant == "plain":
            fn, extra = "qmatmul", ()
        elif variant == "residual":
            fn, extra = "qmatmul_residual", (act(m, k), torch.tensor(0.3, device=DEVICE))
        else:
            fn, extra = "qmatmul_residual2", (act(m, cd), wts(k, cd), scale(k, cd), bias(k))
        kernel = lambda **kw: getattr(mm, fn)(x, w, s, b, *extra, relu=True, **kw)  # noqa: E731
        plain = lambda **kw: getattr(mm, "reference_" + fn)(  # noqa: E731
            x, w, s, b, *extra, relu=True, **kw)
        worst["int8_matmul"] = max(worst["int8_matmul"], check_int8(torch, fn, kernel, plain))
        p1, k1, k2, p2 = (graph_ms(torch, f) for f in (plain, kernel, kernel, plain))
        wt = w.t()
        if variant == "residual2":
            wdt = extra[1].t()
            library = lambda: (torch._int_mm(x, wt), torch._int_mm(extra[0], wdt))  # noqa: E731
        else:
            library = lambda: torch._int_mm(x, wt)  # noqa: E731
        lib_ms = graph_ms(torch, library)
        bound = f_bound_ms(m, c, k, cd, variant)
        loop_ms = time_ms(torch, kernel, iters=20, warmup=2)
        totals["int8_matmul"] += count * np.array([(k1 + k2) / 2, (p1 + p2) / 2, lib_ms, bound[0],
                                                   bound[0] * (bound[1] == "bytes"), loop_ms])
        plan = mm.plan(m, c, k, cd)
        log(f"  F {variant} M={m} C={c} K={k}{f' Cd={cd}' if cd else ''} (x{count}): plan "
            f"{plan.rows}x{plan.channels} tile, cluster {plan.cluster}, {plan.ctas} CTAs; kernel "
            f"{(k1 + k2) / 2:.4f} ms (from a Python loop {loop_ms:.4f}), plain "
            f"{(p1 + p2) / 2:.4f} ms, torch._int_mm {lib_ms:.4f} ms (the contraction alone, not "
            f"the same function), bound {bound[0]:.4f} ms ({bound[1]})")
    for (h, w_, c, k, st), count in sorted(g_shapes.items()):
        x, wt, s, b = act(1, h, w_, c), wts(k, 3, 3, c), scale(k, 9 * c), bias(k)
        kernel = lambda **kw: conv.conv3x3_int8(  # noqa: E731
            x, wt, s, b, stride=st, relu=True, **kw)
        plain = lambda **kw: conv.reference_conv3x3_int8(  # noqa: E731
            x, wt, s, b, stride=st, relu=True, **kw)
        worst["int8_conv"] = max(worst["int8_conv"],
                                 check_int8(torch, f"conv s{st}", kernel, plain))
        p1, k1, k2, p2 = (graph_ms(torch, f) for f in (plain, kernel, kernel, plain))
        xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)  # channels-last NCHW
        wb = wt.permute(0, 3, 1, 2).to(torch.bfloat16)
        lib_ms = graph_ms(torch, lambda: torch.nn.functional.conv2d(xb, wb, stride=st, padding=1))
        ho, wo = (h - 1) // st + 1, (w_ - 1) // st + 1
        bound = bound_ms(h * w_ * c + 9 * c * k + 8 * k + ho * wo * k,
                         {"int8": 2 * ho * wo * 9 * c * k, "float32": 2 * ho * wo * k})
        loop_ms = time_ms(torch, kernel, iters=20, warmup=2)
        totals["int8_conv"] += count * np.array([(k1 + k2) / 2, (p1 + p2) / 2, lib_ms, bound[0],
                                                 bound[0] * (bound[1] == "bytes"), loop_ms])
        plan = conv.plan(1, h, w_, c, k, st)
        log(f"  G stride {st} {h}x{w_} C={c} K={k} (x{count}): plan {plan.patch_h}x"
            f"{plan.patch_w} patch x {plan.channels} channels, cluster {plan.cluster}, "
            f"{plan.ctas} CTAs; kernel {(k1 + k2) / 2:.4f} ms "
            f"(from a Python loop {loop_ms:.4f}), plain {(p1 + p2) / 2:.4f} ms, bf16 cuDNN conv "
            f"{lib_ms:.4f} ms (the float path it stands in for, not the same function), bound "
            f"{bound[0]:.4f} ms ({bound[1]})")
    for name, (k_ms, p_ms, l_ms, b_ms, _, loop_ms) in totals.items():
        log(f"  {name} per forward (sum over its launches): kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms, library {l_ms:.4f} ms, bound {b_ms:.4f} ms; kernel vs plain "
            f"max |diff| {worst[name]} LSB; kernel timed from a Python loop of calls "
            f"{loop_ms:.4f} ms (the wrapper's host cost included)")
    return worst, totals


def reset_int8_counts(mm, conv):
    mm.qmatmul.launches = mm.qmatmul_residual.launches = mm.qmatmul_residual2.launches = 0
    conv.conv3x3_int8.launches = {1: 0, 2: 0}


def phase_int8_serving(torch, fa, mm, conv, mp, api, quantized, Predictor, fp32_ms, bf16_ms):
    """Full-width DETR-R50 with the int8 backbone at bf16 compute, quantized
    from its own fp32 backbone on two seeded 800x1333 images, behind
    Predictor."""
    model = api.build_detr(seed=0, device=DEVICE, dtype="bfloat16", backbone_quant=True)
    predictor = Predictor(model, background_class=BACKGROUND)
    t0 = time.perf_counter()
    with torch.inference_mode():
        calib = predictor.normalize(
            torch.from_numpy(np.stack(random_images([(800, 1333)] * 2, seed=11))).to(DEVICE))
    quantized.quantize_model(model, calib)
    torch.cuda.synchronize()
    log(f"  quantize_model on 2x800x1333: {time.perf_counter() - t0:.2f} s")
    del calib
    img_a, img_b, img_c, img_d = random_images(
        [(800, 1333), (480, 640), (800, 1333), (800, 1333)], seed=1)
    predictor.warmup([(800, 1333), (480, 640)])

    reset_int8_counts(mm, conv)  # main path: three requests, three forwards
    fa.mha.launches = fa.mha.mma_launches = fa.mha.tf32_launches = 0
    mp.max_pool_3x3_s2.launches = 0
    t0 = time.perf_counter()
    r1 = predictor([img_a])
    t1 = time.perf_counter()
    r2 = predictor([img_b])
    t2 = time.perf_counter()
    r3 = predictor([img_c, img_d])
    t3 = time.perf_counter()
    f_counts = {"plain": mm.qmatmul.launches, "residual": mm.qmatmul_residual.launches,
                "residual2": mm.qmatmul_residual2.launches}
    g_counts, a_count = dict(conv.conv3x3_int8.launches), fa.mha.mma_launches
    simt_count, pool_count = fa.mha.launches + fa.mha.tf32_launches, mp.max_pool_3x3_s2.launches
    log(f"  requests: 800x1333 b1 {1e3 * (t1 - t0):.2f} ms, 480x640 b1 {1e3 * (t2 - t1):.2f} ms, "
        f"2x800x1333 b2 {1e3 * (t3 - t2):.2f} ms")
    log(f"  launches in 3 forwards: F {f_counts}, G {g_counts}, A-mma {a_count}, A (SIMT and "
        f"tf32) {simt_count}, C {pool_count} (the int8 stem is not a ResNetBackbone)")
    if (f_counts != {k: 3 * v for k, v in F_PER_FORWARD.items()}
            or g_counts != {k: 3 * v for k, v in G_PER_FORWARD.items()}
            or a_count != 3 * LAUNCHES_PER_FORWARD or simt_count or pool_count != 0):
        raise AssertionError("int8 launch counts differ from 32 F, 13 + 3 G, 18 A-mma, 0 A, 0 C "
                             "per forward")
    for dets in (r1, r2, r3):
        check_detections(dets)

    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        predictor([img_a])
        lat.append(1e3 * (time.perf_counter() - t0))
    median = statistics.median(lat)
    log(f"  Predictor 800x1333 b1 int8 backbone, bf16 compute: median {median:.2f} ms of "
        f"{[round(x, 2) for x in lat]}; in this run fp32 {fp32_ms:.2f} ms, bf16 {bf16_ms:.2f} ms")

    # c5 on the kernel route against the plain int8 route at fp32 compute
    # (TF32 off): c5 = int8 * out_scale, so equal tensors mean equal int8.
    frames = np.zeros((1,) + INT8_BUCKET + (3,), np.uint8)
    frames[0, :800, :1333] = img_a
    pm = torch.zeros((1,) + INT8_BUCKET, dtype=torch.bool, device=DEVICE)
    pm[0, :800, :1333] = True
    int8_backbone = model.module.backbone_quant
    with torch.inference_mode():
        x = predictor.normalize(torch.from_numpy(frames).to(DEVICE)) * pm[..., None]
        c5 = int8_backbone(x, pm, torch.float32)
        c5_plain = int8_backbone(x, pm, torch.float32, use_kernels=False)
        ref = model.module.backbone(x, pm).permute(0, 2, 3, 1)
    if not torch.equal(c5, c5_plain):
        raise AssertionError("int8 c5: kernel route differs from the plain int8 route")
    c5, ref = c5[:, :25, :42].double(), ref[:, :25, :42].double()  # the valid 800x1333 region
    rel = float((c5 - ref).abs().mean() / ref.abs().mean())
    corr = float(torch.corrcoef(torch.stack([c5.flatten(), ref.flatten()]))[0, 1])
    log(f"  c5 at fp32 compute: kernel route integer-equal to the plain int8 route; against "
        f"the fp32 backbone rel err {rel:.4f}, correlation {corr:.4f}")
    if not (rel <= C5_MAX_REL and corr >= C5_MIN_CORR):
        raise AssertionError(f"int8 c5 far from the fp32 backbone: rel {rel}, corr {corr}")
    del model, predictor
    return f_counts, g_counts, a_count, median


def phase_http(predictor, serve, class_names):
    shapes = [(800, 1333), (480, 640), (600, 800)]
    service = serve.DetrService(predictor, class_names)
    # cuDNN plans are cached per thread and shape: warm them on the device thread.
    service.submit(predictor.warmup, shapes)
    server = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            r.read()  # the client's one-time set-up stays out of the POST times
        for img in random_images(shapes, seed=3):
            buf = io.BytesIO()
            np.save(buf, img)
            req = urllib.request.Request(url + "/detect", data=buf.getvalue(), method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                status, payload = r.status, json.loads(r.read())
            ms = 1e3 * (time.perf_counter() - t0)
            if status != 200 or not isinstance(payload.get("detections"), list):
                raise AssertionError(f"/detect answered {status}: {payload}")
            for d in payload["detections"]:
                if set(d) != {"box", "label", "class", "score"} or len(d["box"]) != 4:
                    raise AssertionError(f"malformed detection {d}")
            log(f"  POST /detect {img.shape[0]}x{img.shape[1]}: 200, "
                f"{len(payload['detections'])} detections, {ms:.2f} ms")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            status, health = r.status, json.loads(r.read())
        if status != 200 or health.get("ok") is not True:
            raise AssertionError(f"/healthz answered {status}: {health}")
        log(f"  GET /healthz: 200, buckets {health['buckets']}")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")


def train_batch(seed, slots=None):
    """A native b8 376x672 batch built in memory: normalized-scale images and
    1-20 boxes per image, padded with ``pad_targets`` to ``slots`` target
    slots (default MAX_TARGETS, DETR's 100 queries)."""
    from detr_tensorflow_tpu_torch.data import MAX_TARGETS, pad_targets

    rng = np.random.default_rng(seed)
    boxes, classes, mask = zip(*(
        pad_targets(np.concatenate([rng.uniform(0.1, 0.9, (n, 2)),
                                    rng.uniform(0.05, 0.5, (n, 2))], -1),
                    rng.integers(0, BACKGROUND, size=n), slots or MAX_TARGETS)
        for n in rng.integers(1, 21, size=TRAIN_BATCH)))
    images = rng.normal(size=(TRAIN_BATCH,) + TRAIN_HW + (3,)).astype(np.float32)
    return {"images": images, "boxes": np.stack(boxes), "classes": np.stack(classes),
            "mask": np.stack(mask)}


def gradient_agreement(grads_k, grads_p):
    """Per-tensor gradient agreement of two routes: ||g_k - g_p|| <=
    TENSOR_GRAD_RTOL ||g_p||. A tensor whose gradient is below
    NOISE_FLOOR of the largest tensor gradient has an exactly-zero
    gradient (every k_proj bias: softmax ignores a per-row shift; parts of
    the first decoder layer's self-attention, whose input is zero), and
    both routes return rounding noise there: such a tensor is held to the
    floor itself. Returns (worst (rel err, name), noise tensor names)."""
    scale = max(float(g.norm()) for g in grads_p.values())
    worst, noise = (0.0, ""), []
    for name, g in grads_p.items():
        diff = float((grads_k[name] - g).norm())
        if float(g.norm()) <= NOISE_FLOOR * scale:
            noise.append(name)
            if not diff <= NOISE_FLOOR * scale:
                raise AssertionError(f"{name}: {diff} above the noise floor")
            continue
        rel = diff / float(g.norm())
        worst = max(worst, (rel, name))
        if not rel <= TENSOR_GRAD_RTOL:
            raise AssertionError(f"{name}: gradient rel err {rel} > {TENSOR_GRAD_RTOL}")
    return worst, noise


def phase_training(torch, fa, lap, mp, api, train, losses):
    from detr_tensorflow_tpu_torch.train.engine import batch_to_device

    targets = ("boxes", "classes", "mask")
    batch = batch_to_device(train_batch(5), DEVICE)
    # Parity at dropout 0: the kernel route's matching goes to the plain
    # route, so the two differ in attention (A and A') only.
    results = []
    match = None
    for impl in ("auto", "plain"):
        model = api.build_detr(seed=0, device=DEVICE, dropout=0.0, attn_impl=impl).module
        out = model(batch["images"], train=True)
        if match is None:
            match = losses.match_all_layers(out, *(batch[k] for k in targets))
        total, _ = losses.detr_loss(out, *(batch[k] for k in targets), BACKGROUND, match=match)
        total.backward()
        results.append((float(total.detach()), {n: p.grad for n, p in model.named_parameters()}))
        del model, out
    (loss_k, grads_k), (loss_p, grads_p) = results
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    worst, noise = gradient_agreement(grads_k, grads_p)
    log(f"  parity at dropout 0: loss kernel {loss_k:.6f} plain {loss_p:.6f} (rel {loss_err:.2e}, "
        f"tol {LOSS_RTOL}); worst gradient rel err {worst[0]:.2e} ({worst[1]}, tol "
        f"{TENSOR_GRAD_RTOL}) over {len(grads_p) - len(noise)} tensors; {len(noise)} tensors "
        f"with an exactly-zero gradient agree within the noise floor: {', '.join(noise)}")
    if not loss_err <= LOSS_RTOL:
        raise AssertionError("kernel route and plain route losses disagree")
    del results, grads_k, grads_p
    torch.cuda.empty_cache()

    # DETR's learning rates (the config's defaults: backbone 1e-5, transformer
    # 1e-4). At 1e-3 on the whole model the random-weight backbone, whose
    # FrozenBN does not normalise, swings c5's largest value between 1e1 and
    # 1e6 from one step to the next, and a run can overflow to a non-finite loss.
    config = train.TrainingConfig(background_class=BACKGROUND, train_backbone=True,
                                  train_transformers=True, batch_size=TRAIN_BATCH)
    model = api.build_detr(seed=0, device=DEVICE).module  # dropout 0.1
    trainer = train.Trainer(model, config, seed=0)
    batch = batch_to_device(train_batch(6), DEVICE)
    trainer.step(batch)  # first call: cuDNN plans and kernel loads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks, losses_seen = [time.perf_counter()], []

    def log_fn(host_log, step):
        marks.append(time.perf_counter())
        losses_seen.append(host_log["total_loss"])

    fa.mha.tf32_launches = fa.mha.backward_launches = lap.solve_lap_masked.launches = 0  # main path
    mp.max_pool_3x3_s2.launches = fa.mha.mma_launches = fa.mha.backward_mma_launches = 0
    fa.mha.launches = fa.mha.backward_bf16_launches = 0
    train.fit(trainer, [batch] * TRAIN_STEPS, config, epoch_nb=0, log_fn=log_fn, log_every=1)
    counts = (fa.mha.tf32_launches, fa.mha.backward_launches, lap.solve_lap_masked.launches,
              mp.max_pool_3x3_s2.launches, fa.mha.backward_mma_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    median = statistics.median(step_ms)
    log(f"  {TRAIN_STEPS} steps at dropout {DROPOUT}: losses {[round(x, 4) for x in losses_seen]}")
    log(f"  step times {[round(x, 2) for x in step_ms]} ms, median {median:.2f} ms, "
        f"{TRAIN_BATCH * 1e3 / median:.2f} images/s, peak device memory {peak_gb:.2f} GiB")
    log(f"  launches in {TRAIN_STEPS} steps: attention forward A-tf32 {counts[0]}, SIMT "
        f"{fa.mha.launches}, A-mma {fa.mha.mma_launches}; backward tensor-core {counts[4]}, "
        f"A'-bf16 {fa.mha.backward_bf16_launches} and SIMT {counts[1]}, lap {counts[2]}, max pool "
        f"{counts[3]}")
    per_step = (LAUNCHES_PER_FORWARD, 0, 1, 1, LAUNCHES_PER_FORWARD)
    if (counts != tuple(TRAIN_STEPS * c for c in per_step) or fa.mha.mma_launches
            or fa.mha.launches or fa.mha.backward_bf16_launches):
        raise AssertionError(f"launch counts {counts}, {fa.mha.launches} SIMT A, "
                             f"{fa.mha.mma_launches} A-mma and {fa.mha.backward_bf16_launches} "
                             f"A'-bf16, expected {per_step} per step (A-tf32, SIMT A', B, C, "
                             f"tensor-core A') and no SIMT A, A-mma or A'-bf16 (fp32)")
    if not all(np.isfinite(losses_seen)) or not losses_seen[-1] < losses_seen[0]:
        raise AssertionError(f"losses not finite and falling: {losses_seen}")
    wall_ms, busy_ms, events = device_busy_ms(torch, lambda: trainer.step(batch))
    log(f"  under torch.profiler: {wall_ms:.2f} ms wall, {busy_ms:.2f} ms device busy, "
        f"{events:.0f} kernels and copies a step")
    step_kernels, by_name = kernel_ms(torch, lambda: trainer.step(batch),
                                      ("lap_kernel", "max_pool_3x3_s2"))
    log(f"  one step under torch.profiler: {step_kernels:.2f} ms of kernel time; B (lap_kernel) "
        f"{by_name['lap_kernel']:.4f} ms ({by_name['lap_kernel'] / step_kernels:.3%}), C "
        f"(max_pool_3x3_s2) {by_name['max_pool_3x3_s2']:.4f} ms "
        f"({by_name['max_pool_3x3_s2'] / step_kernels:.3%})")

    out = model(batch["images"], train=True, generator=trainer.generator)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        total, _ = losses.detr_loss(out, *(batch[k] for k in targets), BACKGROUND)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not bool(torch.isfinite(total)):
        raise AssertionError("non-finite loss")
    log("  matching and loss ran under set_sync_debug_mode('error'): no host sync")
    return counts, {"median": median, "peak_gb": peak_gb, "wall": wall_ms, "busy": busy_ms,
                    "events": events}


# The entry-points phase: a synthetic COCO set of COCO-like image sizes
# written as PNG, DETR-R50 trained on it from image files by
# ``train_coco.main`` (b8 376x672, augmentation, Trainer.prefetch) and
# evaluated by ``eval.main`` at original size, batch 1 and batch 4. The
# rates are taken on a second set of ENTRY_RATE_IMAGES: one epoch of it is
# many times the batches the loader holds ahead of a step, so the later
# steps of a loader-fed epoch wait on the loader if it falls behind.
ENTRY_SIZES = [(480, 640), (427, 640), (640, 480)]
ENTRY_IMAGES, ENTRY_BOXES, ENTRY_STEPS, ENTRY_EVAL_BATCH = 16, (1, 20), 4, 4
ENTRY_RATE_IMAGES = 256


def reset_counts(fa, lap, mp):
    fa.mha.tf32_launches = fa.mha.backward_launches = lap.solve_lap_masked.launches = 0
    lap.solve_lap_masked.wide_launches = lap.solve_lap_masked.generic_launches = 0
    mp.max_pool_3x3_s2.launches = fa.mha.mma_launches = fa.mha.backward_mma_launches = 0
    fa.mha.launches = fa.mha.backward_bf16_launches = 0


def read_counts(fa, lap, mp) -> dict:
    return {"A-tf32": fa.mha.tf32_launches, "A'-mma": fa.mha.backward_mma_launches,
            "B": lap.solve_lap_masked.launches, "C": mp.max_pool_3x3_s2.launches,
            "A-mma": fa.mha.mma_launches, "A SIMT": fa.mha.launches,
            "A' SIMT": fa.mha.backward_launches, "A'-bf16": fa.mha.backward_bf16_launches}


def expect_counts(label, counts, steps=0, forwards=0):
    """A fp32 training step launches A-tf32 and A'-mma 18 times, B and C
    once; an eval forward A-tf32 18 times and C once; nothing else runs."""
    want = {"A-tf32": LAUNCHES_PER_FORWARD * (steps + forwards),
            "A'-mma": LAUNCHES_PER_FORWARD * steps, "B": steps, "C": steps + forwards,
            "A-mma": 0, "A SIMT": 0, "A' SIMT": 0, "A'-bf16": 0}
    log(f"  launches {label}: {counts}")
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")


def phase_entry_points(torch, fa, lap, mp, api, train):
    """The port's workflows from image files at DETR-R50's full width,
    fp32: ``train_coco.main`` for ENTRY_STEPS loader-fed steps with a
    checkpoint, ``restore_latest`` and one more step; the loader's
    throughput and a loader-fed step against an in-memory one;
    ``eval.main`` at batch 1 and ENTRY_EVAL_BATCH with equal AP tables, the
    eval rates, one eval batch's forward against the plain-attention
    model's; SIGTERM
    during ``fit`` under ``PreemptionGuard``. Counts reset just before each
    run and read just after."""
    import itertools
    import math
    import os
    import shutil
    import signal
    import tempfile

    from detr_tensorflow_tpu_torch import eval as eval_main
    from detr_tensorflow_tpu_torch import train_coco
    from detr_tensorflow_tpu_torch.data import load_coco_dataset, make_synthetic_coco

    root = tempfile.mkdtemp(prefix="chip_smoke_coco_")
    try:
        t = time.perf_counter()
        make_synthetic_coco(root, n_images=ENTRY_IMAGES, seed=0, sizes=ENTRY_SIZES,
                            boxes_per_image=ENTRY_BOXES)
        log(f"  wrote {ENTRY_IMAGES} PNG images ({ENTRY_SIZES} in turn, {ENTRY_BOXES[0]}-"
            f"{ENTRY_BOXES[1]} boxes each) in {time.perf_counter() - t:.2f} s")
        ckpt = os.path.join(root, "ckpt")
        data = ["--data_dir", root, "--img_dir", "images", "--ann_file", "ann.json",
                "--device", DEVICE]
        argv = data + ["--batch_size", str(TRAIN_BATCH), "--target_batch", str(TRAIN_BATCH),
                       "--image_size", *map(str, TRAIN_HW), "--epochs", str(ENTRY_STEPS),
                       "--steps_per_epoch", "1", "--evaluation_steps", "0",
                       "--checkpoint_dir", ckpt]
        path_counts = collections.Counter()

        def main_path_counts(label, **runs):
            counts = read_counts(fa, lap, mp)
            expect_counts(label, counts, **runs)
            path_counts.update(counts)

        reset_counts(fa, lap, mp)  # main path: training from image files
        t = time.perf_counter()
        trainer = train_coco.main(argv)
        torch.cuda.synchronize()
        log(f"  train_coco.main: {trainer.steps} steps in {time.perf_counter() - t:.2f} s "
            "(model build and first-call setup included)")
        main_path_counts("train_coco.main", steps=ENTRY_STEPS)
        if trainer.steps != ENTRY_STEPS or train.latest_step(ckpt) != ENTRY_STEPS:
            raise AssertionError(f"{trainer.steps} steps, checkpoint at "
                                 f"{train.latest_step(ckpt)}, expected {ENTRY_STEPS}")
        config = trainer.config
        loader, _ = load_coco_dataset(config, TRAIN_BATCH, augmentation=True, seed=1)

        resumed = train.Trainer(api.get_detr_model(
            config, include_top=False, nb_class=config.background_class + 1, tf_backbone=True,
            device=DEVICE).module, config)
        train.restore_latest(resumed, ckpt)
        for (name, p), q in zip(trainer.model.named_parameters(), resumed.model.parameters()):
            if not torch.equal(p, q):
                raise AssertionError(f"restored {name} differs from the trained one")
        reset_counts(fa, lap, mp)  # main path: one more step after the restore
        log_after = resumed.step(next(resumed.prefetch(itertools.islice(loader, 1))))
        loss = float(log_after["total_loss"])
        main_path_counts("the step after restore_latest", steps=1)
        if not (math.isfinite(loss) and resumed.steps == ENTRY_STEPS + 1):
            raise AssertionError(f"step after the restore: loss {loss}, step {resumed.steps}")
        log(f"  restore_latest: step {ENTRY_STEPS} restored (parameters equal), step "
            f"{resumed.steps} loss {loss:.4f}")
        del resumed

        rate_root = os.path.join(root, "rate")
        t = time.perf_counter()
        make_synthetic_coco(rate_root, n_images=ENTRY_RATE_IMAGES, seed=1, sizes=ENTRY_SIZES,
                            boxes_per_image=ENTRY_BOXES)
        log(f"  wrote a second set of {ENTRY_RATE_IMAGES} PNG images for the rates in "
            f"{time.perf_counter() - t:.2f} s")
        rate_data = train.DataConfig(data_dir=rate_root, img_dir="images", ann_file="ann.json")
        rate_loader, _ = load_coco_dataset(config.replace(data=rate_data), TRAIN_BATCH,
                                           augmentation=True, seed=1)
        t, images = time.perf_counter(), 0
        for batch in rate_loader:
            images += len(batch["images"])
        loader_rate = images / (time.perf_counter() - t)
        log(f"  loader alone ({rate_loader.num_workers} threads, PNG decode, augmentation, "
            f"normalization, b{TRAIN_BATCH} {TRAIN_HW[0]}x{TRAIN_HW[1]}): {images} images in one "
            f"epoch, {loader_rate:.1f} images/s")

        def step_times(batches):
            marks = [time.perf_counter()]

            def log_fn(host_log, step):
                marks.append(time.perf_counter())

            train.fit(trainer, batches, config, epoch_nb=0, log_fn=log_fn, log_every=1)
            return [1e3 * (b - a) for a, b in zip(marks, marks[1:])]

        # Batches ready before a step can wait: the HostDataset queue, the
        # one its producer holds, and Trainer.prefetch's two in flight.
        ahead = rate_loader.prefetch + 1 + 2
        fed = step_times(rate_loader)
        in_memory_batch = next(iter(loader))
        in_memory = step_times([in_memory_batch] * len(fed))
        fed_ms, memory_ms = statistics.median(fed), statistics.median(in_memory)
        steady_ms = statistics.median(fed[ahead:])
        log(f"  fp32 step fed by the loader over one epoch of {len(fed)} steps: "
            f"{[round(x, 2) for x in fed]} ms, median {fed_ms:.2f}, {steady_ms:.2f} over steps "
            f"{ahead}-{len(fed) - 1} (past the {ahead} batches held ahead); fed one in-memory "
            f"batch: median {memory_ms:.2f} over {len(in_memory)} steps")

        shapes = [ENTRY_SIZES[i % len(ENTRY_SIZES)] for i in range(ENTRY_IMAGES)]
        buckets = collections.Counter((-(-h // 128) * 128, -(-w // 128) * 128) for h, w in shapes)
        tables = {}
        for batch_size in (1, ENTRY_EVAL_BATCH):
            forwards = sum(-(-n // batch_size) for n in buckets.values())
            reset_counts(fa, lap, mp)  # main path: evaluation from image files
            tables[batch_size] = eval_main.main(data + ["--batch", str(batch_size)])
            torch.cuda.synchronize()
            main_path_counts(f"eval.main --batch {batch_size}", forwards=forwards)
            log(f"  eval.main --batch {batch_size}: {forwards} forwards, box AP "
                f"{dict(tables[batch_size]['box'])}")
        if tables[1] != tables[ENTRY_EVAL_BATCH]:
            raise AssertionError(f"AP tables differ: batch 1 {tables[1]}, batch "
                                 f"{ENTRY_EVAL_BATCH} {tables[ENTRY_EVAL_BATCH]}")
        # Eval's images/s on a model built beforehand, warm (eval.main ran both
        # batch sizes' shapes): reading, padding, the forward and the AP.
        model = api.get_detr_model(None, include_top=True, device=DEVICE)
        eval_config = train.TrainingConfig(data=train.DataConfig(
            data_dir=root, img_dir="images", ann_file="ann.json"))
        eval_rates = {}
        for batch_size in (1, ENTRY_EVAL_BATCH):
            valid, names = load_coco_dataset(eval_config.replace(data=rate_data), batch_size,
                                             augmentation=None)
            cfg = eval_config.replace(background_class=valid.background_class)
            t = time.perf_counter()
            eval_main.eval_model(model, cfg, names, valid)
            torch.cuda.synchronize()
            eval_rates[batch_size] = ENTRY_RATE_IMAGES / (time.perf_counter() - t)
        log(f"  eval images/s over the {ENTRY_RATE_IMAGES} images, warm, model built beforehand: "
            + ", ".join(f"b{b} {r:.2f}" for b, r in eval_rates.items()))
        # One eval batch through the kernel model and the plain-attention model.
        valid, _ = load_coco_dataset(eval_config, ENTRY_EVAL_BATCH, augmentation=None,
                                     shuffle=False)
        batch = next(iter(valid))
        images = torch.as_tensor(batch["images"]).to(DEVICE)
        pixel_mask = torch.as_tensor(batch["pixel_mask"]).to(DEVICE)
        plain = api.get_detr_model(None, include_top=True, device=DEVICE, attn_impl="plain")
        outs = [m(images, pixel_mask) for m in (model, plain)]
        errs = {k: float((outs[0][k] - outs[1][k]).abs().max())
                for k in ("pred_boxes", "pred_logits")}
        log(f"  eval forward ({tuple(images.shape)} with a pixel mask) against the plain-attention "
            f"model: boxes {errs['pred_boxes']:.3e} (tol {BOX_ATOL}), logits "
            f"{errs['pred_logits']:.3e} (tol {LOGIT_ATOL})")
        if not (errs["pred_boxes"] <= BOX_ATOL and errs["pred_logits"] <= LOGIT_ATOL):
            raise AssertionError(f"eval forward against plain attention: {errs}")
        del outs, model, plain

        steps_before = trainer.steps
        with train.PreemptionGuard() as guard:  # the signal lands as the first step logs
            done = train.fit(trainer, [in_memory_batch] * 4, config, epoch_nb=0,
                             preemption_guard=guard, log_every=1,
                             log_fn=lambda host_log, step: os.kill(os.getpid(), signal.SIGTERM))
        if done is not False or train.latest_step(ckpt) != trainer.steps \
                or trainer.steps != steps_before + 2:
            raise AssertionError(f"preemption: fit returned {done}, checkpoint at "
                                 f"{train.latest_step(ckpt)}, step {trainer.steps}")
        log(f"  SIGTERM during fit under PreemptionGuard: fit returned False with a checkpoint "
            f"at step {trainer.steps}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return path_counts, {"loader_images_s": loader_rate, "fed_ms": fed_ms, "ahead": ahead,
                         "steady_ms": steady_ms, "memory_ms": memory_ms,
                         "eval_images_s": eval_rates}


def tensor_gaps(ours, plain, exact):
    """The bf16 kernel route's gradients (or outputs) ``ours`` and the bf16
    plain route's ``plain`` against the fp32 step's ``exact``, in relative
    distance e = ||x - exact|| / ||exact|| per tensor: (median e of ours,
    median e of plain, worst (ours e / max(plain e, plain median), name)).
    Raises unless ours' median is within BF16_GAP_FACTOR of plain's and every
    tensor within BF16_TENSOR_GAP_FACTOR of max(plain e, plain median); a
    tensor whose exact value is below NOISE_FLOOR of the largest (an
    exactly-zero gradient) is held in absolute distance to
    BF16_TENSOR_GAP_FACTOR times max(plain's, NOISE_FLOOR of the largest)."""
    scale = max(float(g.norm()) for g in exact.values())
    rel, noise = {}, {}
    for name, ref in exact.items():
        norm = float(ref.norm())
        gaps = [float((t[name].float() - ref).norm()) for t in (ours, plain)]
        if norm > NOISE_FLOOR * scale:
            rel[name] = [g / norm for g in gaps]
        else:
            noise[name] = gaps
    ours_med = statistics.median(e[0] for e in rel.values())
    plain_med = statistics.median(e[1] for e in rel.values())
    worst = max((e[0] / max(e[1], plain_med), n) for n, e in rel.items())
    if not ours_med <= BF16_GAP_FACTOR * plain_med:
        raise AssertionError(f"bf16 kernel route median gap {ours_med} > {BF16_GAP_FACTOR} x "
                             f"plain route's {plain_med}")
    if not worst[0] <= BF16_TENSOR_GAP_FACTOR:
        raise AssertionError(f"{worst[1]}: bf16 kernel route {worst[0]} x the plain route's gap")
    for name, (g_ours, g_plain) in noise.items():
        if not g_ours <= BF16_TENSOR_GAP_FACTOR * max(g_plain, NOISE_FLOOR * scale):
            raise AssertionError(f"{name}: {g_ours} above the noise floor")
    return ours_med, plain_med, worst, len(noise)


def bf16_parity(torch, fa, api, losses, batch, rate):
    """One step's loss and gradients of the bf16 kernel route, the bf16
    plain-attention route and the fp32 step on the same weights, batch,
    matching and dropout masks (each model's generator seeded alike: the
    FFN masks come from it, the attention masks from the Philox seed each
    layer draws from it, which the plain route expands with ``keep_mask``).
    Raises unless the kernel route's loss is within BF16_LOSS_RTOL of the
    plain route's and its gradients, all float32, are no further from the
    fp32 step's than the plain route's (``tensor_gaps``)."""
    targets = ("boxes", "classes", "mask")
    results, match = {}, None
    before = (fa.mha.backward_bf16_launches, fa.mha.backward_launches)
    for key, dtype, impl in (("kernel", "bfloat16", "auto"), ("plain", "bfloat16", "plain"),
                             ("fp32", "float32", "auto")):
        model = api.build_detr(seed=0, device=DEVICE, dropout=rate, attn_impl=impl,
                               dtype=dtype).module
        gen = torch.Generator(device=DEVICE).manual_seed(17)
        fwd_before = forward_counts(fa)
        out = model(batch["images"], train=True, generator=gen)
        if key == "kernel":
            fwd_counts = tuple(a - b for a, b in zip(forward_counts(fa), fwd_before))
        if match is None:
            match = losses.match_all_layers(out, *(batch[k] for k in targets))
        total, _ = losses.detr_loss(out, *(batch[k] for k in targets), BACKGROUND, match=match)
        total.backward()
        if any(p.dtype != torch.float32 or p.grad.dtype != torch.float32
               for p in model.parameters()):
            raise AssertionError(f"{key}: a parameter or gradient is not float32")
        results[key] = (float(total.detach()), {n: p.grad for n, p in model.named_parameters()})
        del model, out
    (loss_k, grads_k), (loss_p, grads_p), (loss_32, grads_32) = (
        results[k] for k in ("kernel", "plain", "fp32"))
    launches = fa.mha.backward_bf16_launches - before[0]
    if (launches, fa.mha.backward_launches - before[1]) != (LAUNCHES_PER_FORWARD, 0):
        raise AssertionError(f"bf16 parity: {launches} A'-bf16 and "
                             f"{fa.mha.backward_launches - before[1]} SIMT A' launches, expected "
                             f"{LAUNCHES_PER_FORWARD} and 0")
    if fwd_counts != (0, LAUNCHES_PER_FORWARD, 0):
        raise AssertionError(f"bf16 parity: (SIMT A, A-mma, A-tf32) launches {fwd_counts} in the "
                             f"kernel route's forward, expected (0, {LAUNCHES_PER_FORWARD}, 0)")
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    ours_med, plain_med, worst, n_noise = tensor_gaps(grads_k, grads_p, grads_32)
    forward = {"mma": "A-mma", "simt": "SIMT A"}[fa.forward_route(torch.bfloat16, rate, 32)]
    backward = {"bf16": "A'-bf16", "simt": "SIMT A'"}[fa.backward_route(torch.bfloat16, 32)]
    log(f"  bf16 parity at dropout {rate} (kernel route: {forward} and {backward}, "
        f"{LAUNCHES_PER_FORWARD} launches of {forward}, {launches} of {backward}): loss kernel "
        f"{loss_k:.6f} plain "
        f"{loss_p:.6f} (rel {loss_err:.2e}, tol {BF16_LOSS_RTOL}), fp32 step {loss_32:.6f}; "
        f"gradients against the fp32 step's, median relative distance kernel route "
        f"{ours_med:.4f}, plain route {plain_med:.4f} (tol {BF16_GAP_FACTOR} x), worst tensor "
        f"{worst[1]} at {worst[0]:.3f} x (tol {BF16_TENSOR_GAP_FACTOR} x), {n_noise} "
        f"exactly-zero tensors within the floor")
    if not loss_err <= BF16_LOSS_RTOL:
        raise AssertionError(f"bf16 kernel route and plain route losses disagree at dropout {rate}")
    if not plain_med <= BF16_SAME_MASKS_GAP:
        raise AssertionError(f"the bf16 plain route's gradients lie {plain_med} from the fp32 "
                             f"step's at dropout {rate}: the routes did not share their masks")
    torch.cuda.empty_cache()


def phase_bf16_training(torch, fa, lap, mp, api, train, losses):
    """The bf16 training step (float32 parameters, bf16 compute): parity of
    the kernel route with the plain-attention route against the fp32 step
    on the same weights, batch and matching (``bf16_parity``), at dropout 0
    and at dropout 0.1 with the same masks (the forward on A-mma, the
    backward on A'-bf16: the main path's kernels); then
    steps at dropout 0.1 through ``Trainer`` with the counts reset just
    before; then its time under the profiler, and one step's kernel time
    with the attention's share."""
    from detr_tensorflow_tpu_torch.train.engine import batch_to_device

    batch = batch_to_device(train_batch(5), DEVICE)
    for rate in (0.0, DROPOUT):
        bf16_parity(torch, fa, api, losses, batch, rate)

    config = train.TrainingConfig(background_class=BACKGROUND, train_backbone=True,
                                  train_transformers=True, batch_size=TRAIN_BATCH)
    model = api.build_detr(seed=0, device=DEVICE, dtype="bfloat16").module  # dropout 0.1
    trainer = train.Trainer(model, config, seed=0)
    batch = batch_to_device(train_batch(6), DEVICE)
    trainer.step(batch)  # first call: cuDNN plans and kernel loads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks, losses_seen = [time.perf_counter()], []

    def log_fn(host_log, step):
        marks.append(time.perf_counter())
        losses_seen.append(host_log["total_loss"])
        if any(p.dtype != torch.float32 for p in model.parameters()):
            raise AssertionError(f"a parameter is not float32 after step {step}")

    fa.mha.tf32_launches = fa.mha.backward_launches = lap.solve_lap_masked.launches = 0  # main path
    mp.max_pool_3x3_s2.launches = fa.mha.mma_launches = fa.mha.backward_mma_launches = 0
    fa.mha.launches = fa.mha.backward_bf16_launches = 0
    train.fit(trainer, [batch] * BF16_TRAIN_STEPS, config, epoch_nb=0, log_fn=log_fn, log_every=1)
    counts = {"A-mma": fa.mha.mma_launches, "A'-bf16": fa.mha.backward_bf16_launches,
              "A' SIMT": fa.mha.backward_launches, "B": lap.solve_lap_masked.launches,
              "C": mp.max_pool_3x3_s2.launches, "A-tf32": fa.mha.tf32_launches,
              "A SIMT": fa.mha.launches, "A'-mma": fa.mha.backward_mma_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    step_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    median = statistics.median(step_ms)
    log(f"  bf16: {BF16_TRAIN_STEPS} steps at dropout {DROPOUT}: losses "
        f"{[round(x, 4) for x in losses_seen]}; every parameter float32 after each step")
    log(f"  bf16 step times {[round(x, 2) for x in step_ms]} ms, median {median:.2f} ms, "
        f"{TRAIN_BATCH * 1e3 / median:.2f} images/s, peak device memory {peak_gb:.2f} GiB")
    per_step = {k: v / BF16_TRAIN_STEPS for k, v in counts.items()}
    log(f"  bf16 launches per step: {per_step}")
    expected = {"A-mma": LAUNCHES_PER_FORWARD, "A'-bf16": LAUNCHES_PER_FORWARD, "A' SIMT": 0,
                "B": 1, "C": 1, "A-tf32": 0, "A SIMT": 0, "A'-mma": 0}
    if per_step != expected:
        raise AssertionError(f"bf16 launches per step {per_step}, expected {expected}")
    if not all(np.isfinite(losses_seen)):
        raise AssertionError(f"bf16 losses not finite: {losses_seen}")
    moments = [t for s_ in trainer.optimizer.adam.state.values() for t in s_.values()
               if isinstance(t, torch.Tensor) and t.dim()]
    if not moments or any(t.dtype != torch.float32 for t in moments):
        raise AssertionError("an Adam moment is not float32")
    wall_ms, busy_ms, events = device_busy_ms(torch, lambda: trainer.step(batch))
    log(f"  bf16 under torch.profiler: {wall_ms:.2f} ms wall, {busy_ms:.2f} ms device busy, "
        f"{events:.0f} kernels and copies a step")
    # The attention's kernels: A-mma, A'-bf16's pre-pass and passes.
    names = ("flash_attention_fwd_mma_kernel", "prepass_kernel", "passes_kernel")
    step_kernels, by_name = kernel_ms(torch, lambda: trainer.step(batch), names)
    attention = sum(by_name.values())
    log(f"  one bf16 step under torch.profiler: {step_kernels:.2f} ms of kernel time; attention "
        f"{attention:.4f} ms ({attention / step_kernels:.2%}): A-mma "
        f"{by_name[names[0]]:.4f}, A'-bf16 {by_name[names[1]] + by_name[names[2]]:.4f} (pre-pass "
        f"{by_name[names[1]]:.4f}, passes {by_name[names[2]]:.4f})")
    return counts, {"median": median, "peak_gb": peak_gb, "wall": wall_ms, "busy": busy_ms,
                    "events": events, "attention": attention, "kernels": step_kernels}


def fused_path_shapes(height, width, masked):
    """Every kernel C, D and E launch of one b1 fused-backbone DETR-R50
    forward at a (height, width) bucket: C's input (C, H, W), D as (Cin,
    Cout, H, W) and E as (C, M, H, W), each with its count per forward."""
    h, w = (height - 1) // 2 + 1, (width - 1) // 2 + 1  # the stem's 7x7/s2 conv
    c_shape = (64, h, w)
    h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1  # its 3x3/s2 max pool
    d, e = collections.Counter(), collections.Counter()
    for s, (n_blocks, d1, d2) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512),
                                               (256, 512, 1024, 2048))):
        if s:
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        d[(d1, d2, h, w)] += n_blocks if masked else 1
        if not masked:
            e[(d2, d1, h, w)] += n_blocks - 1
    return c_shape, d, e


def d_counts(fr):
    """Kernel D's launch counters: (SIMT D, D-mma, D-tf32)."""
    d = fr.conv1x1_bn_residual_relu
    return d.launches, d.mma_launches, d.tf32_launches


def fused_rel_err(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max()) / max(1.0, float(ref.float().abs().max()))


def phase_fused_kernels(torch, mp, fr, fb):
    """C, D and E at every distinct shape of a b1 fused-backbone forward at
    the masked and the bucket-exact bucket, fp32 and bf16."""
    F = torch.nn.functional
    gen = torch.Generator(device=DEVICE).manual_seed(23)

    def cl(*shape, fill=torch.rand):  # NCHW in channels_last, as the backbone holds it
        return fill(*shape, device=DEVICE, generator=gen).contiguous(
            memory_format=torch.channels_last)

    def normal(*shape, std=1.0):
        return torch.randn(*shape, device=DEVICE, generator=gen) * std

    # [kernel][bucket][dtype] -> per-forward sums of (kernel, plain, yardstick, bound, bound by
    # bytes) ms, and the worst relative and absolute errors per kernel and dtype.
    totals = collections.defaultdict(lambda: np.zeros(5))
    worst = collections.defaultdict(float)
    worst_abs = collections.defaultdict(float)

    def record(kernel, bucket, name, count, fn_kernel, fn_plain, fn_yard, bound, exact, label):
        got, ref = fn_kernel(), fn_plain()
        torch.cuda.synchronize()
        if exact:
            if not torch.equal(got, ref):
                raise AssertionError(f"{kernel} {label} {name}: not bit-equal to plain")
            err = 0.0
        else:
            err = fused_rel_err(got, ref)
            if not err <= FUSED_RTOL[name]:
                raise AssertionError(f"{kernel} {label} {name}: rel err {err} > {FUSED_RTOL[name]}")
        worst[(kernel, name)] = max(worst[(kernel, name)], err)
        worst_abs[(kernel, name)] = max(worst_abs[(kernel, name)],
                                        float((got.float() - ref.float()).abs().max()))
        p1, k1, k2, p2 = (graph_ms(torch, f) for f in (fn_plain, fn_kernel, fn_kernel, fn_plain))
        yard = graph_ms(torch, fn_yard)
        kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
        totals[(kernel, bucket, name)] += count * np.array(
            [kms, pms, yard, bound[0], bound[0] * (bound[1] == "bytes")])
        return kms, pms, yard, err

    for name, plans, occupancy in (("E-mma", fb.MMA_PLANS, fb.mma_occupancy),
                                   ("E-tf32", fb.TF32_PLANS, fb.tf32_occupancy)):
        for m, plan in plans.items():
            clusters, smem = occupancy(m)
            log(f"  {name} M={m} plan {plan}: {smem} bytes of shared memory a CTA; the card "
                f"holds {clusters} clusters of {plan[2]} at once (cudaOccupancyMaxActiveClusters)")
    for bucket, masked in ((FUSED_MASKED, True), (FUSED_EXACT, False)):
        (c0, h0, w0), d_shapes, e_shapes = fused_path_shapes(*bucket, masked)
        tag = f"{bucket[0]}x{bucket[1]}{' masked' if masked else ''}"
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            size = 2 if name == "bfloat16" else 4
            x = torch.relu(cl(1, c0, h0, w0, fill=torch.randn)).to(dtype)
            ho, wo = (h0 - 1) // 2 + 1, (w0 - 1) // 2 + 1
            bound = bound_ms((h0 * w0 + ho * wo) * c0 * size, {})
            kms, pms, yard, _ = record(
                "maxpool", tag, name, 1, lambda: mp.max_pool_3x3_s2(x, nonneg=True),
                lambda: mp.reference_max_pool_3x3_s2(x),
                lambda: F.max_pool2d(x, 3, stride=2, padding=1), bound, True, "")
            log(f"  C {tag} (1,{c0},{h0},{w0}) {name}: kernel {kms:.4f} ms, plain {pms:.4f} ms, "
                f"F.max_pool2d {yard:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}); bit-equal")
            for (cin, cout, h, w), count in sorted(d_shapes.items()):
                x = cl(1, cin, h, w).to(dtype)
                wt = normal(cout, cin, 1, 1, std=cin**-0.5).to(dtype)
                scale, shift = torch.rand(cout, device=DEVICE, generator=gen) + 0.5, normal(cout, std=0.3)
                identity = cl(1, cout, h, w, fill=torch.randn).to(dtype)
                sd, td = scale.to(dtype)[:, None, None], shift.to(dtype)[:, None, None]
                p = h * w
                nbytes = (p * (cin + 2 * cout) + cout * cin) * size + 8 * cout
                gemm, epilogue = 2 * p * cin * cout, 4 * p * cout
                # At fp32 D-tf32's bound as 3xTF32 (three MMAs a product) and the SIMT D's
                # on the fp32 pipes, the GEMM counted in both; at bf16 both at the bf16 peak.
                mma = name == "bfloat16"
                if mma:
                    bound = simt_bound = bound_ms(nbytes, {"bfloat16": gemm, "float32": epilogue})
                else:
                    bound = bound_ms(nbytes, {"tf32": 3 * gemm, "float32": epilogue})
                    simt_bound = bound_ms(nbytes, {"float32": gemm + epilogue})
                label = f"({cin}->{cout}, {h}x{w})"
                ops = (x, wt, scale, shift, identity)
                plain = lambda: fr.reference_conv1x1_bn_residual_relu(*ops)  # noqa: E731
                chain = lambda: F.relu(F.conv2d(x, wt) * sd + td + identity)  # noqa: E731
                # conv1x1_bn_residual_relu routes bf16 to D-mma, fp32 to D-tf32.
                kernel, short, bn = (("fused_residual_mma", "D-mma", 128) if mma else
                                     ("fused_residual_tf32", "D-tf32", 64))
                before = d_counts(fr)
                fr.conv1x1_bn_residual_relu(*ops)
                if tuple(a - b for a, b in zip(d_counts(fr), before)) != (0, int(mma), int(not mma)):
                    raise AssertionError(f"D {label} {name} did not route to {short}")
                kms, pms, yard, err = record(
                    kernel, tag, name, count, lambda: fr.conv1x1_bn_residual_relu(*ops), plain,
                    chain, bound, False, label)
                # the SIMT D called at the same dtype, beside it
                simt, _, _, simt_err = record("fused_residual", tag, name, count,
                                              lambda: fr.launch_simt(*ops), plain, chain,
                                              simt_bound, False, label)
                bounds = (f"bound {bound[0]:.4f} ms ({bound[1]})" if mma else
                          f"bound {bound[0]:.4f} ms as 3xTF32 ({bound[1]}), "
                          f"{simt_bound[0]:.4f} ms on the fp32 pipes ({simt_bound[1]})")
                log(f"  D {tag} {cin}->{cout} {h}x{w} (x{count}) {name}: {short} {kms:.4f} ms "
                    f"({-(-p // 128) * -(-cout // bn)} CTAs of 128x{bn}), SIMT D {simt:.4f} ms, "
                    f"plain {pms:.4f} ms, unfused cuDNN chain (conv, BN, residual, ReLU; not the "
                    f"same function) {yard:.4f} ms, {bounds}; rel err {short} {err:.2e}, SIMT "
                    f"{simt_err:.2e}")
            for (c, m, h, w), count in sorted(e_shapes.items()):
                x = cl(1, c, h, w).to(dtype)
                w1t, w2t, w3t = (normal(*s, std=k**-0.5).to(dtype)
                                 for s, k in (((c, m), c), ((9, m, m), 9 * m), ((m, c), m)))
                b1 = torch.rand(m, device=DEVICE, generator=gen) + 0.5  # > 0: the halo is tested
                b2, b3 = normal(m, std=0.1), normal(c, std=0.1)
                ops = (w1t, b1, w2t, b2, w3t, b3)
                k1_, k2_ = w1t.t()[:, :, None, None], w2t.reshape(3, 3, m, m).permute(3, 2, 0, 1)
                k3_ = w3t.t()[:, :, None, None]
                bd = [b.to(dtype)[:, None, None] for b in (b1, b2, b3)]

                def chain():
                    t = F.relu(F.conv2d(x, k1_) + bd[0])
                    t = F.relu(F.conv2d(t, k2_, padding=1) + bd[1])
                    return F.relu(F.conv2d(t, k3_) + bd[2] + x)

                p = h * w
                nbytes = (2 * p * c + 2 * c * m + 9 * m * m) * size + 4 * (2 * m + c)
                flops = 2 * p * (2 * c * m + 9 * m * m)
                # E-tf32's bound as 3xTF32 (three MMAs a product); the SIMT kernel's on
                # the fp32 pipes.
                bound = bound_ms(nbytes, {name: flops})
                bound3x = bound_ms(nbytes, {"tf32": 3 * flops})
                label = f"(C={c}, M={m}, {h}x{w})"
                plain = lambda: fb.reference_fused_bottleneck(x, *ops)  # noqa: E731
                # fused_bottleneck routes fp32 to E-tf32, bf16 to E-mma.
                kernel, short, plan = (("fused_bottleneck_mma", "E-mma", fb.mma_plan(c, m))
                                       if name == "bfloat16" else
                                       ("fused_bottleneck_tf32", "E-tf32", fb.tf32_plan(c, m)))
                before = fb.fused_bottleneck.mma_launches + fb.fused_bottleneck.tf32_launches
                simt_before = fb.fused_bottleneck.launches
                fb.fused_bottleneck(x, *ops)
                if (fb.fused_bottleneck.mma_launches + fb.fused_bottleneck.tf32_launches - before,
                        fb.fused_bottleneck.launches - simt_before) != (1, 0):
                    raise AssertionError(f"E {label} {name} did not route to {short}")
                kms, pms, yard, err = record(kernel, tag, name, count,
                                             lambda: fb.fused_bottleneck(x, *ops), plain, chain,
                                             bound if name == "bfloat16" else bound3x, False, label)
                simt, _, _, simt_err = record("fused_bottleneck", tag, name, count,
                                              lambda: fb.launch_simt(x, *ops), plain, chain,
                                              bound, False, label)
                bounds = (f"bound {bound[0]:.4f} ms ({bound[1]})" if name == "bfloat16" else
                          f"bound {bound3x[0]:.4f} ms as 3xTF32 ({bound3x[1]}), "
                          f"{bound[0]:.4f} ms on the fp32 pipes ({bound[1]})")
                log(f"  E {tag} C={c} M={m} {h}x{w} (x{count}) {name}: {short} {kms:.4f} ms "
                    f"(plan (tile_h, tile_w, cluster) {plan}), SIMT kernel {simt:.4f} ms, plain "
                    f"{pms:.4f} ms, unfused cuDNN chain (three convs with bias, ReLU and residual; "
                    f"not the same function) {yard:.4f} ms, {bounds}; rel err {short} {err:.2e}, "
                    f"SIMT {simt_err:.2e}")
    x = torch.relu(cl(*TRAIN_STEM, fill=torch.randn))
    b0, c0, h0, w0 = TRAIN_STEM
    bound = bound_ms(b0 * c0 * (h0 * w0 + ((h0 - 1) // 2 + 1) * ((w0 - 1) // 2 + 1)) * 4, {})
    kms, pms, yard, _ = record(
        "maxpool", "training", "float32", 1, lambda: mp.max_pool_3x3_s2(x, nonneg=True),
        lambda: mp.reference_max_pool_3x3_s2(x),
        lambda: F.max_pool2d(x, 3, stride=2, padding=1), bound, True, "training")
    log(f"  C training stem {TRAIN_STEM} float32: kernel {kms:.4f} ms, plain {pms:.4f} ms, "
        f"F.max_pool2d {yard:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}); bit-equal")
    for (kernel, bucket, name), (kms, pms, yard, b, _) in sorted(totals.items()):
        if kernel != "maxpool":
            log(f"  {kernel} per {bucket} forward, {name} (sum over its launches): kernel "
                f"{kms:.4f} ms, plain {pms:.4f} ms, unfused chain {yard:.4f} ms, bound {b:.4f} ms")
    return worst, worst_abs, totals


def seeded_frozen_bn(torch, module, seed):
    """Moderate nonzero FrozenBN buffers from a seed (scale near 1, shifts
    ~0.1, variances in [0.5, 1.5]), the same for every model given the seed."""
    from detr_tensorflow_tpu_torch.models.layers import FrozenBatchNorm

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, FrozenBatchNorm):
                n = m.weight.numel()
                for buf, value in ((m.weight, 1 + 0.1 * torch.randn(n, generator=gen)),
                                   (m.bias, 0.1 * torch.randn(n, generator=gen)),
                                   (m.running_mean, 0.1 * torch.randn(n, generator=gen)),
                                   (m.running_var, 0.5 + torch.rand(n, generator=gen))):
                    buf.copy_(value)


def bf16_c5_gap(torch, models, x, mask, label):
    """c5 of the fused bf16 model and of the unfused bf16 model against the
    unfused fp32 model's, at image ``x`` with pixel mask ``mask`` (None at a
    bucket-exact image: E-mma and D-mma; else D-mma in every block): the
    fused model's gap may be at most FUSED_BF16_C5_RATIO times the unfused
    one's."""
    with torch.inference_mode():
        c5 = {key: models[key].module.backbone(x.to(models[key].module.dtype), mask)
              for key in (("float32", False), ("bfloat16", True), ("bfloat16", False))}
    if not all(bool(torch.isfinite(v).all()) for v in c5.values()):
        raise AssertionError(f"bf16 c5 {label}: non-finite values")
    ref = c5[("float32", False)]
    fused, unfused = (fused_rel_err(c5[("bfloat16", f)], ref) for f in (True, False))
    log(f"  bf16 {label}: c5 rel err against the unfused fp32 model: fused {fused:.3e}, unfused "
        f"bf16 {unfused:.3e} (tol {FUSED_BF16_C5_RATIO} x the unfused gap, |c5| max "
        f"{float(ref.abs().max()):.2f})")
    if not fused <= FUSED_BF16_C5_RATIO * unfused:
        raise AssertionError(f"fused bf16 c5 gap at {label} {fused} > {FUSED_BF16_C5_RATIO} x "
                             f"{unfused}")


def phase_fused_serving(torch, fa, mp, fr, fb, api, Predictor):
    """The fused-backbone DETR-R50 behind Predictor, against the unfused
    model from the same seed and FrozenBN buffers."""
    models = {}
    for dtype in ("float32", "bfloat16"):
        for fused in (True, False):
            flags = dict(fuse_residual=True, fuse_bottleneck=True) if fused else {}
            model = api.build_detr(seed=0, device=DEVICE, dtype=dtype, **flags)
            seeded_frozen_bn(torch, model.module, seed=31)
            models[(dtype, fused)] = model
    img_e, img_m, img_e2, img_e3 = random_images([(768, 1280), (800, 1333), (768, 1280),
                                                  (768, 1280)], seed=7)
    predictor = Predictor(models[("float32", True)], background_class=BACKGROUND)
    predictor.warmup([(800, 1333), (768, 1280)])  # both routes of each bucket
    d = fr.conv1x1_bn_residual_relu
    names = "C, SIMT D, D-mma, D-tf32, SIMT E, E-mma, E-tf32, A-tf32, A-mma, A SIMT"

    def counts():
        return (mp.max_pool_3x3_s2.launches, *d_counts(fr),
                fb.fused_bottleneck.launches, fb.fused_bottleneck.mma_launches,
                fb.fused_bottleneck.tf32_launches, fa.mha.tf32_launches, fa.mha.mma_launches,
                fa.mha.launches)

    def reset():
        mp.max_pool_3x3_s2.launches = d.launches = d.mma_launches = d.tf32_launches = 0
        fb.fused_bottleneck.launches = fb.fused_bottleneck.mma_launches = 0
        fb.fused_bottleneck.tf32_launches = 0
        fa.mha.tf32_launches = fa.mha.mma_launches = fa.mha.launches = 0

    def per_request(pred, requests):
        """Detections checked, host ms and launches of each request, the
        counters reset just before the first."""
        reset()
        seen, times = [], []
        for images in requests:
            t0 = time.perf_counter()
            dets = pred(images)
            times.append(1e3 * (time.perf_counter() - t0))
            seen.append(counts())
            check_detections(dets)
        per = [tuple(b - a for a, b in zip((0,) * len(c) if i == 0 else seen[i - 1], c))
               for i, c in enumerate(seen)]
        return per, times, seen[-1]

    # main path of the fused fp32 model: bucket-exact, masked, bucket-exact b2
    per, times, totals = per_request(predictor, ([img_e], [img_m], [img_e2, img_e3]))
    log(f"  requests: 768x1280 b1 {times[0]:.2f} ms, 800x1333 b1 {times[1]:.2f} ms, "
        f"2x768x1280 b2 {times[2]:.2f} ms; launches ({names}) per request {per}")
    expected = [FUSED_PER_FORWARD[(k, "float32")] + (LAUNCHES_PER_FORWARD, 0, 0)
                for k in ("exact", "masked", "exact")]
    if per != expected:
        raise AssertionError(f"fused launches {per}, expected {expected}")

    # fp32 (TF32 off): c5, boxes and logits against the unfused model, at a
    # bucket-exact forward (E-tf32 and D-tf32) and a masked one (D-tf32 only).
    fused, plain = models[("float32", True)], models[("float32", False)]
    with torch.inference_mode():
        exact = predictor.normalize(torch.from_numpy(img_e[None]).to(DEVICE))
        canvas = torch.zeros((1,) + FUSED_MASKED + (3,), device=DEVICE)
        canvas[:, :800, :1333] = predictor.normalize(torch.from_numpy(img_m[None]).to(DEVICE))
        pm = torch.zeros((1,) + FUSED_MASKED, dtype=torch.bool, device=DEVICE)
        pm[:, :800, :1333] = True
        for label, x, mask in (("768x1280 exact", exact, None), ("800x1333 masked", canvas, pm)):
            c5, c5_ref = fused.module.backbone(x, mask), plain.module.backbone(x, mask)
            if not (torch.isfinite(c5).all() and torch.isfinite(c5_ref).all()):
                raise AssertionError(f"{label}: non-finite c5")
            rel = fused_rel_err(c5, c5_ref)
            out, ref = fused(x, mask), plain(x, mask)
            errs = {k: float((out[k] - ref[k]).abs().max()) for k in ("pred_boxes", "pred_logits")}
            log(f"  fp32 {label}: c5 rel err {rel:.2e} (tol {FUSED_C5_RTOL}, |c5| max "
                f"{float(c5_ref.abs().max()):.2f}), boxes {errs['pred_boxes']:.3e} (tol "
                f"{BOX_ATOL}), logits {errs['pred_logits']:.3e} (tol {LOGIT_ATOL})")
            if not (rel <= FUSED_C5_RTOL and errs["pred_boxes"] <= BOX_ATOL
                    and errs["pred_logits"] <= LOGIT_ATOL):
                raise AssertionError(f"fused model differs from the unfused one at {label}")

    medians, bf16_counts = {}, None
    for dtype in ("float32", "bfloat16"):
        preds = {fused_: Predictor(models[(dtype, fused_)], background_class=BACKGROUND)
                 for fused_ in (True, False)}
        images = {"768x1280": img_e, "800x1333": img_m}
        for pred in preds.values():
            pred.warmup([(768, 1280), (800, 1333)])
        if dtype == "bfloat16":
            # main path of the fused bf16 model: a bucket-exact request, then a masked one
            per, _, bf16_counts = per_request(preds[True], ([img_e], [img_m]))
            log(f"  fused bf16 768x1280 b1 and 800x1333 b1 requests: launches ({names}) per "
                f"request {per}")
            expected = [FUSED_PER_FORWARD[(k, "bfloat16")] + (0, LAUNCHES_PER_FORWARD, 0)
                        for k in ("exact", "masked")]
            if per != expected:
                raise AssertionError(f"fused bf16 launches {per}, expected {expected}")
            bf16_c5_gap(torch, models, exact, None, "768x1280 exact")
            bf16_c5_gap(torch, models, canvas, pm, "800x1333 masked")
        for size, img in images.items():
            lat = {True: [], False: []}
            for i in range(5):  # interleaved, each first in turn
                for fused_ in ((True, False) if i % 2 == 0 else (False, True)):
                    t0 = time.perf_counter()
                    check_detections(preds[fused_]([img]))
                    lat[fused_].append(1e3 * (time.perf_counter() - t0))
            medians[(dtype, size)] = {k: statistics.median(v) for k, v in lat.items()}
            log(f"  Predictor {size} b1 {dtype}: fused median {medians[(dtype, size)][True]:.2f} "
                f"ms of {[round(v, 2) for v in lat[True]]}, unfused "
                f"{medians[(dtype, size)][False]:.2f} ms of {[round(v, 2) for v in lat[False]]}")
            for fused_ in (True, False):
                wall, busy, _ = device_busy_ms(torch, lambda: preds[fused_]([img]))
                share = ("not measured" if busy is None else
                         f"{busy:.2f} ms, idle {1 - busy / wall:.2f}")
                log(f"  under torch.profiler, {'fused' if fused_ else 'unfused'} {dtype} {size} "
                    f"b1: wall {wall:.2f} ms per request, device busy {share}")
    del models, predictor
    return totals, bf16_counts, medians


def facebook_state_dict(seed, depth=50, num_encoder_layers=6, num_decoder_layers=6,
                        model_dim=256, dim_feedforward=2048, num_classes=92, num_queries=100,
                        base=64):
    """A torch DETR state_dict in facebookresearch/detr's naming
    (``backbone.0.body.*``, packed ``in_proj`` attention, ``class_embed``,
    ``bbox_embed.layers.*``) with float32 values from a numpy seed: conv and
    linear weights N(0, 1/fan_in), biases N(0, 0.1^2), FrozenBN weight
    1 + N(0, 0.1^2), bias and running mean N(0, 0.1^2), running variance
    U(0.5, 1.5), ``query_embed`` N(0, 1). ``base`` is the stem's width
    (64 in a ResNet; smaller for naming tests)."""
    import torch

    rng = np.random.default_rng(seed)
    sd = {}

    def put(key, x):
        sd[key] = torch.from_numpy(np.asarray(x, np.float32))

    def weight(key, *shape):
        put(key, rng.normal(size=shape) / np.sqrt(np.prod(shape[1:])))

    def bias(key, n):
        put(key, 0.1 * rng.normal(size=n))

    def bn(prefix, c):
        put(prefix + ".weight", 1.0 + 0.1 * rng.normal(size=c))
        bias(prefix + ".bias", c)
        bias(prefix + ".running_mean", c)
        put(prefix + ".running_var", rng.uniform(0.5, 1.5, size=c))

    def linear(prefix, cout, cin):
        weight(prefix + ".weight", cout, cin)
        bias(prefix + ".bias", cout)

    def norm(prefix, c):
        put(prefix + ".weight", 1.0 + 0.1 * rng.normal(size=c))
        bias(prefix + ".bias", c)

    root = "backbone.0.body."
    weight(root + "conv1.weight", base, 3, 7, 7)
    bn(root + "bn1", base)
    cin = base
    for s, n_blocks in enumerate({50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]):
        d1 = base * 2 ** s
        for b in range(n_blocks):
            p = f"{root}layer{s + 1}.{b}."
            for j, (ci, co, k) in enumerate(((cin, d1, 1), (d1, d1, 3), (d1, 4 * d1, 1))):
                weight(f"{p}conv{j + 1}.weight", co, ci, k, k)
                bn(f"{p}bn{j + 1}", co)
            if b == 0:
                weight(p + "downsample.0.weight", 4 * d1, cin, 1, 1)
                bn(p + "downsample.1", 4 * d1)
            cin = 4 * d1
    weight("input_proj.weight", model_dim, cin, 1, 1)
    bias("input_proj.bias", model_dim)
    put("query_embed.weight", rng.normal(size=(num_queries, model_dim)))

    def attention(prefix):
        linear(prefix + ".in_proj", 3 * model_dim, model_dim)
        sd[prefix + ".in_proj_weight"] = sd.pop(prefix + ".in_proj.weight")
        sd[prefix + ".in_proj_bias"] = sd.pop(prefix + ".in_proj.bias")
        linear(prefix + ".out_proj", model_dim, model_dim)

    for side, n_layers, attns, norms in (
            ("encoder", num_encoder_layers, ("self_attn",), 2),
            ("decoder", num_decoder_layers, ("self_attn", "multihead_attn"), 3)):
        for i in range(n_layers):
            p = f"transformer.{side}.layers.{i}."
            for a in attns:
                attention(p + a)
            linear(p + "linear1", dim_feedforward, model_dim)
            linear(p + "linear2", model_dim, dim_feedforward)
            for j in range(norms):
                norm(f"{p}norm{j + 1}", model_dim)
    norm("transformer.decoder.norm", model_dim)
    linear("class_embed", num_classes, model_dim)
    for j, cout in enumerate((model_dim, model_dim, 4)):
        linear(f"bbox_embed.layers.{j}", cout, model_dim)
    return sd


def segmentation_state_dict(seed, num_heads=8, model_dim=256, base=64, **detector):
    """A facebook DETRsegm state_dict: ``facebook_state_dict``'s detector
    under ``detr.``, beside ``bbox_attention.{q,k}_linear`` and
    ``mask_head.*`` (``MaskHeadSmallConv``: lay1 over concat(features,
    attention maps), lay2-lay5, out_lay, GroupNorms gn1-gn5 and the FPN
    adapters over c4/c3/c2), values from a numpy seed as the detector's.
    ``detector`` goes to ``facebook_state_dict``."""
    import torch

    sd = {"detr." + k: v for k, v in facebook_state_dict(seed, model_dim=model_dim, base=base,
                                                         **detector).items()}
    rng = np.random.default_rng(seed + 1)

    def put(key, x):
        sd[key] = torch.from_numpy(np.asarray(x, np.float32))

    for name in ("q_linear", "k_linear"):
        put(f"bbox_attention.{name}.weight",
            rng.normal(size=(model_dim, model_dim)) / np.sqrt(model_dim))
        put(f"bbox_attention.{name}.bias", 0.1 * rng.normal(size=model_dim))
    dims = [model_dim + num_heads, model_dim // 2, model_dim // 4, model_dim // 8,
            model_dim // 16]
    convs = [("lay1", dims[0], dims[0], 3)] + [
        (f"lay{j + 2}", dims[j], dims[j + 1], 3) for j in range(4)] + [
        ("out_lay", dims[4], 1, 3)] + [
        (f"adapter{j + 1}", base * 4 * 2 ** (2 - j), dims[j + 1], 1) for j in range(3)]
    for name, cin, cout, k in convs:
        put(f"mask_head.{name}.weight", rng.normal(size=(cout, cin, k, k)) / np.sqrt(cin * k * k))
        put(f"mask_head.{name}.bias", 0.1 * rng.normal(size=cout))
    for j, c in enumerate(dims):
        put(f"mask_head.gn{j + 1}.weight", 1.0 + 0.1 * rng.normal(size=c))
        put(f"mask_head.gn{j + 1}.bias", 0.1 * rng.normal(size=c))
    return sd


# Checkpoints and DC5. DETR-R50-DC5 (the last stage dilated: C5 at stride 16)
# loaded from a facebook-named .pth. At the 896x1408 serving bucket its
# encoder sees 56x88 = 4928 keys (DETR-R50: 28x44 = 1232).
DC5_SERVE, DC5_BUCKET, DC5_EXACT = (800, 1333), (896, 1408), (768, 1280)
DC5_KEYS = 56 * 88
DC5_ATTN_SHAPES = [(DC5_KEYS, DC5_KEYS), (100, DC5_KEYS)]
# A fused DC5 forward: (C, D-tf32, E-tf32). Bucket-exact, E on the ten
# undilated identity blocks (2 + 3 + 5), D on the four block_0 and the two
# dilated blocks; masked, D on all 16.
DC5_FUSED_PER_FORWARD = {"exact": (1, 6, 10), "masked": (1, 16, 0)}
# An int8 DC5 forward: G at stride 1 on 12 blocks (the dilated stage's
# block_0 among them) and at stride 2 on 2; the 2 dilated 3x3s outside G.
DC5_G_PER_FORWARD = {1: 12, 2: 2}
DC5_DILATED_PER_FORWARD = 2
# remat recomputes every encoder and decoder layer in the backward: the
# attention forward launches twice a step.
REMAT_A_PER_STEP = 2 * LAUNCHES_PER_FORWARD
# The remat step's gradients may differ from the step's without remat by
# at most this factor times two identical steps' difference (cuDNN's and
# A' reductions may sum in another order from one run to the next), with
# a floor of REMAT_FLOOR of each tensor's norm.
REMAT_GAP_FACTOR, REMAT_FLOOR = 2.0, 1e-6
BF16_FORWARD_ATOL = {"pred_boxes": 1.5e-2, "pred_logits": 7.5e-2}  # tests/test_torch_bf16.py


def phase_dc5(torch, fa, lap, mp, fr, fb, mm, conv, api, quantized, train, Predictor):
    """Checkpoints and the DC5 family: a seeded DETR-R50-DC5 written as
    facebook publishes it, served, fused, quantized, trained with and
    without remat, saved and loaded."""
    import argparse
    import os
    import tempfile

    from detr_tensorflow_tpu_torch.train.engine import batch_to_device, forward_loss

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dc5_")
    path = os.path.join(tmp.name, "detr-r50-dc5.pth")
    t0 = time.perf_counter()
    torch.save({"model": facebook_state_dict(seed=41), "args": argparse.Namespace(
        backbone="resnet50", dilation=True, lr=1e-4, dec_layers=6)}, path)
    t1 = time.perf_counter()
    build = functools.partial(api.build_detr, weights=path, dilation=True, device=DEVICE)
    models = {(dt, impl): build(dtype=dt, attn_impl=impl)
              for dt in ("float32", "bfloat16") for impl in ("auto", "plain")}
    log(f"  facebook-named DETR-R50-DC5 .pth with args written in {t1 - t0:.2f} s, 4 models "
        f"built from it in {time.perf_counter() - t1:.2f} s")
    # Launches on this phase's main paths, by the kernel's entry in the kernels line.
    launches = collections.Counter()
    out = {"launches": launches}

    # Served at 800x1333 b1 (the 896x1408 bucket, masked): 3 requests a dtype.
    img = random_images([DC5_SERVE], seed=43)[0]
    predictors = {dt: Predictor(models[(dt, "auto")], background_class=BACKGROUND)
                  for dt in ("float32", "bfloat16")}
    for dtype, pred in predictors.items():
        pred.warmup([DC5_SERVE])
        reset_counts(fa, lap, mp)  # main path
        for _ in range(3):
            check_detections(pred([img]))
        counts = read_counts(fa, lap, mp)
        route = "A-tf32" if dtype == "float32" else "A-mma"
        want = {k: 0 for k in counts}
        want.update({route: 3 * LAUNCHES_PER_FORWARD, "C": 3})
        log(f"  DC5 {dtype} 800x1333 b1, 3 requests: launches {counts}")
        if counts != want:
            raise AssertionError(f"DC5 {dtype} serving launches {counts}, expected {want}")
        launches["flash_attention_fwd_tf32" if dtype == "float32" else
                 "flash_attention_fwd_mma"] += counts[route]
        launches["maxpool"] += counts["C"]
    (h, w), (bh, bw) = DC5_SERVE, DC5_BUCKET
    frames = np.zeros((1, bh, bw, 3), np.uint8)
    frames[0, :h, :w] = img
    pm = torch.zeros((1, bh, bw), dtype=torch.bool, device=DEVICE)
    pm[0, :h, :w] = True
    with torch.inference_mode():
        x = predictors["float32"].normalize(torch.from_numpy(frames).to(DEVICE)) * pm[..., None]
        res = {key: m(x, pm) for key, m in models.items()}
    torch.cuda.synchronize()
    ours32 = res[("float32", "auto")]
    for key, atol in (("pred_boxes", BOX_ATOL), ("pred_logits", LOGIT_ATOL)):
        err = float((ours32[key] - res[("float32", "plain")][key]).abs().max())
        direct = float((res[("bfloat16", "auto")][key] - res[("bfloat16", "plain")][key]).abs().max())
        gap, plain_gap = (float((res[("bfloat16", impl)][key] - ours32[key]).abs().max())
                          for impl in ("auto", "plain"))
        log(f"  DC5 forward {key}: fp32 kernel vs plain attention max_abs_err {err:.3e} (tol "
            f"{atol}); bf16 kernel vs plain {direct:.3e} (tol {BF16_FORWARD_ATOL[key]}), from the "
            f"fp32 forward kernel {gap:.3e}, plain {plain_gap:.3e} (tol {BF16_GAP_FACTOR} x)")
        if not (err <= atol and direct <= BF16_FORWARD_ATOL[key]
                and gap <= BF16_GAP_FACTOR * plain_gap):
            raise AssertionError(f"DC5 {key} disagrees with the plain-attention model")
    if not all(bool(torch.isfinite(v).all()) for r in res.values() for v in r.values()):
        raise AssertionError("DC5 forward: non-finite outputs")

    # Request latency and device busy time, DETR-R50 beside DETR-R50-DC5.
    out["latency"] = {}
    for dtype in ("float32", "bfloat16"):
        r50 = Predictor(api.build_detr(seed=0, device=DEVICE, dtype=dtype),
                        background_class=BACKGROUND)
        r50.warmup([DC5_SERVE])
        for name, pred in (("DETR-R50", r50), ("DETR-R50-DC5", predictors[dtype])):
            lat = []
            for _ in range(5):
                t0 = time.perf_counter()
                pred([img])
                lat.append(1e3 * (time.perf_counter() - t0))
            wall, busy, events = device_busy_ms(torch, lambda: pred([img]))
            share = "not measured" if busy is None else f"{busy:.2f} ms, idle {1 - busy / wall:.2f}"
            out["latency"][(name, dtype)] = (statistics.median(lat), busy, wall)
            log(f"  {name} {dtype} 800x1333 b1: p50 {statistics.median(lat):.2f} ms of "
                f"{[round(v, 2) for v in lat]}; under torch.profiler wall {wall:.2f} ms, device "
                f"busy {share}, {events:.0f} kernels and copies")
        del r50
    del res, predictors, models[("float32", "plain")], models[("bfloat16", "plain")]
    torch.cuda.empty_cache()

    # A-tf32 and A-mma at DC5's b1 shapes against plain, SDPA and the bound.
    out["attention"] = {}
    for lq, lk in DC5_ATTN_SHAPES:
        for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            q, k, v, mask = attention_inputs(torch, 1, lq, lk, dtype, seed=lq + lk)
            fast = lambda: fa.mha(q, k, v, mask)  # noqa: E731
            plain = lambda: fa.reference_mha(q, k, v, mask)  # noqa: E731
            err = check_attention(name, f"DC5 ({lq},{lk}) {name}", fast(), plain(), q)
            p1, k1, k2, p2 = (graph_ms(torch, f, iters=10) for f in (plain, fast, fast, plain))
            lib = graph_ms(torch, lambda: sdpa(torch, q, k, v, mask), iters=10)
            bound = attention_bound(1, lq, lk, "tf32" if name == "float32" else name)
            out["attention"][(lq, lk, name)] = dict(ms=(k1 + k2) / 2, plain=(p1 + p2) / 2,
                                                    sdpa=lib, bound=bound, err=err)
            del q, k, v, mask
            log(f"  attention ({lq},{lk}) {name} B=1 H=8 Dh=32 masked, CUDA graphs: "
                f"{'A-tf32' if name == 'float32' else 'A-mma'} {(k1 + k2) / 2:.4f} ms ({k1:.4f}, "
                f"{k2:.4f}), plain {(p1 + p2) / 2:.4f} ms, scaled_dot_product_attention "
                f"{lib:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}"
                f"{', as 3xTF32' if name == 'float32' else ''}); max_abs_err {err:.3e}")
    torch.cuda.empty_cache()

    # The fused DC5 model: E on undilated identity blocks only, D on every tail.
    fused = build(fuse_residual=True, fuse_bottleneck=True)
    unfused = models[("float32", "auto")]
    img_e = random_images([DC5_EXACT], seed=44)[0]
    pred = Predictor(fused, background_class=BACKGROUND)
    pred.warmup([DC5_EXACT, DC5_SERVE])
    d, e = fr.conv1x1_bn_residual_relu, fb.fused_bottleneck
    per = {}
    for label, image in (("exact", img_e), ("masked", img)):
        mp.max_pool_3x3_s2.launches = d.launches = d.mma_launches = d.tf32_launches = 0
        e.launches = e.mma_launches = e.tf32_launches = fa.mha.tf32_launches = 0  # main path
        check_detections(pred([image]))
        per[label] = (mp.max_pool_3x3_s2.launches, d.tf32_launches, e.tf32_launches)
        others = (d.launches, d.mma_launches, e.launches, e.mma_launches)
        log(f"  fused DC5 fp32 {label} b1: (C, D-tf32, E-tf32) {per[label]}, A-tf32 "
            f"{fa.mha.tf32_launches}, (SIMT D, D-mma, SIMT E, E-mma) {others}")
        if (per[label] != DC5_FUSED_PER_FORWARD[label] or any(others)
                or fa.mha.tf32_launches != LAUNCHES_PER_FORWARD):
            raise AssertionError(f"fused DC5 {label} launches {per[label]}, {others}")
        launches["maxpool"] += per[label][0]
        launches["fused_residual_tf32"] += per[label][1]
        launches["fused_bottleneck_tf32"] += per[label][2]
        launches["flash_attention_fwd_tf32"] += fa.mha.tf32_launches
    with torch.inference_mode():
        exact = pred.normalize(torch.from_numpy(img_e[None]).to(DEVICE))
        for label, xx, mask in (("768x1280 exact", exact, None), ("800x1333 masked", x, pm)):
            rel = fused_rel_err(fused.module.backbone(xx, mask), unfused.module.backbone(xx, mask))
            a, b = fused(xx, mask), unfused(xx, mask)
            errs = {k: float((a[k] - b[k]).abs().max()) for k in ("pred_boxes", "pred_logits")}
            log(f"  fused DC5 fp32 {label} against unfused: c5 rel err {rel:.2e} (tol "
                f"{FUSED_C5_RTOL}), boxes {errs['pred_boxes']:.3e} (tol {BOX_ATOL}), logits "
                f"{errs['pred_logits']:.3e} (tol {LOGIT_ATOL})")
            if not (rel <= FUSED_C5_RTOL and errs["pred_boxes"] <= BOX_ATOL
                    and errs["pred_logits"] <= LOGIT_ATOL):
                raise AssertionError(f"fused DC5 differs from unfused at {label}")
    del fused, pred
    torch.cuda.empty_cache()

    # The int8 DC5 model: G on the undilated 3x3s, the dilated ones outside G.
    int8 = build(dtype="bfloat16", backbone_quant=True)
    pred = Predictor(int8, background_class=BACKGROUND)
    with torch.inference_mode():
        calib = pred.normalize(
            torch.from_numpy(np.stack(random_images([DC5_SERVE] * 2, seed=11))).to(DEVICE))
    quantized.quantize_model(int8, calib)
    del calib
    pred.warmup([DC5_SERVE])
    reset_int8_counts(mm, conv)  # main path
    conv.dilated_conv3x3_int8.calls = fa.mha.mma_launches = 0
    check_detections(pred([img]))
    g_counts, dilated = dict(conv.conv3x3_int8.launches), conv.dilated_conv3x3_int8.calls
    f_counts = (mm.qmatmul.launches, mm.qmatmul_residual.launches, mm.qmatmul_residual2.launches)
    log(f"  int8 DC5 800x1333 b1: G {g_counts}, dilated 3x3s outside G {dilated}, F {f_counts}, "
        f"A-mma {fa.mha.mma_launches}")
    if (g_counts != DC5_G_PER_FORWARD or dilated != DC5_DILATED_PER_FORWARD
            or f_counts != tuple(F_PER_FORWARD.values())
            or fa.mha.mma_launches != LAUNCHES_PER_FORWARD):
        raise AssertionError("int8 DC5 launch counts")
    launches["int8_conv"] += sum(g_counts.values())
    launches["int8_matmul"] += sum(f_counts)
    launches["flash_attention_fwd_mma"] += fa.mha.mma_launches
    with torch.inference_mode():
        c5 = int8.module.backbone_quant(x, pm, torch.float32)
        c5_plain = int8.module.backbone_quant(x, pm, torch.float32, use_kernels=False)
    if not torch.equal(c5, c5_plain):
        raise AssertionError("int8 DC5 c5: kernel route differs from the plain int8 route")
    rng = np.random.default_rng(45)
    c5_map = (1, bh // 16, bw // 16, 512)  # the dilated stage's conv2 input
    a1 = torch.from_numpy(rng.integers(-128, 128, c5_map, dtype=np.int8)).to(DEVICE)
    w2 = torch.from_numpy(rng.integers(-127, 128, (512, 3, 3, 512), dtype=np.int8)).to(DEVICE)
    s2 = torch.full((512,), 1e-4, device=DEVICE)
    b2 = torch.from_numpy(rng.normal(size=512).astype(np.float32)).to(DEVICE)
    lib = lambda: conv.dilated_conv3x3_int8(a1, w2, s2, b2, dilation=2, relu=True)  # noqa: E731
    plain = lambda: conv.reference_dilated_conv3x3_int8(  # noqa: E731
        a1, w2, s2, b2, dilation=2, relu=True)
    g = lambda: conv.conv3x3_int8(a1, w2, s2, b2, stride=1, relu=True)  # noqa: E731
    if not torch.equal(lib(), plain()):
        raise AssertionError("the dilated int8 3x3 differs from the plain int32 convolution")
    times = [graph_ms(torch, f, iters=10) for f in (plain, lib, lib, plain, g)]
    bound = bound_ms(2 * a1.numel() + w2.numel() + 2 * 512 * 4,
                     {"int8": 2 * a1.numel() // 512 * 9 * 512 * 512})
    out["dilated"] = dict(ms=(times[1] + times[2]) / 2, plain=(times[0] + times[3]) / 2,
                          g=times[4], bound=bound)
    log(f"  c5 of the int8 DC5 model: kernel route integer-equal to the plain int8 route; the "
        f"dilated 3x3 at {c5_map}->512 bit-exact against the float64 convolution, CUDA "
        f"graphs: taps + torch._int_mm {out['dilated']['ms']:.4f} ms, float64 convolution "
        f"{out['dilated']['plain']:.4f} ms, kernel G undilated at the same shape {times[4]:.4f} "
        f"ms, bound {bound[0]:.4f} ms ({bound[1]})")
    del int8, pred, c5, c5_plain, a1, w2, models[("bfloat16", "auto")]
    torch.cuda.empty_cache()

    # A DC5 training step at b8 376x672 (24x42 = 1008 keys), fp32, dropout 0.1,
    # without remat, and with remat and backbone_remat=2.
    config = train.TrainingConfig(background_class=BACKGROUND, train_backbone=True,
                                  train_transformers=True, batch_size=TRAIN_BATCH)
    batch = batch_to_device(train_batch(46), DEVICE)

    def grads(model, seed=7):
        """Loss, gradients, the generator's end state and the peak memory
        above what was allocated before the forward, in GiB."""
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        total, _, _ = forward_loss(model, batch, config, True, gen)
        total.backward()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        return (total.detach(), {n: p.grad.clone() for n, p in model.named_parameters()},
                gen.get_state(), peak)

    step = {}
    for label, kw in (("without remat", {}), ("remat", dict(remat=True, backbone_remat=2))):
        model = build(**kw).module
        step[label] = {"grads": [grads(model) for _ in range(2 if not kw else 1)]}
        trainer = train.Trainer(model, config, seed=0)
        trainer.step(batch)  # cuDNN plans, kernel loads
        reset_counts(fa, lap, mp)  # main path
        trainer.step(batch)
        counts = read_counts(fa, lap, mp)
        want = {k: 0 for k in counts}
        want.update({"A-tf32": REMAT_A_PER_STEP if kw else LAUNCHES_PER_FORWARD,
                     "A'-mma": LAUNCHES_PER_FORWARD, "B": 1, "C": 1})
        log(f"  DC5 b{TRAIN_BATCH} 376x672 fp32 step {label}: launches {counts}")
        if counts != want:
            raise AssertionError(f"DC5 step {label}: launches {counts}, expected {want}")
        for name, key in (("flash_attention_fwd_tf32", "A-tf32"),
                          ("flash_attention_bwd_mma", "A'-mma"), ("lap", "B"), ("maxpool", "C")):
            launches[name] += counts[key]
        wall, busy, events = device_busy_ms(torch, lambda: trainer.step(batch))
        step[label].update(counts=counts, wall=wall, busy=busy, events=events)
        del trainer, model
        torch.cuda.empty_cache()
    (l_a, g_a, s_a, peak), (l_b, g_b, s_b, _) = step["without remat"]["grads"]
    l_r, g_r, s_r, peak_r = step["remat"]["grads"][0]
    worst = (0.0, "")
    for name, ga in g_a.items():
        rerun = float((g_b[name] - ga).norm())
        allowed = REMAT_GAP_FACTOR * max(rerun, REMAT_FLOOR * float(ga.norm()), 1e-30)
        diff = float((g_r[name] - ga).norm())
        worst = max(worst, (diff / allowed, name))
        if not diff <= allowed:
            raise AssertionError(f"remat gradient {name}: {diff} from the step without remat, "
                                 f"two identical steps {rerun}")
    loss_rerun = float((l_b - l_a).abs())
    if not (float((l_r - l_a).abs()) <= REMAT_GAP_FACTOR * max(loss_rerun, REMAT_FLOOR * float(l_a.abs()))
            and torch.equal(s_r, s_a) and torch.equal(s_b, s_a)):
        raise AssertionError("remat: loss or the generator's state differs from the step without")
    bitequal = all(torch.equal(g_r[n], g) for n, g in g_a.items())
    rerun_bitequal = all(torch.equal(g_b[n], g) for n, g in g_a.items())
    log(f"  remat=True, backbone_remat=2 against the step without remat: loss {float(l_r):.6f} / "
        f"{float(l_a):.6f}, gradients bit-equal {bitequal} (two steps without remat bit-equal "
        f"{rerun_bitequal}), worst tensor at {worst[0]:.3f} of its allowance ({worst[1]}), the "
        f"generator in the same state; torch.cuda.max_memory_allocated of a forward and backward, "
        f"above the memory held before it: {peak_r:.2f} GiB with remat against {peak:.2f} GiB")
    for label, st in step.items():
        log(f"  DC5 step {label} under torch.profiler: wall {st['wall']:.2f} ms, device busy "
            f"{st['busy']:.2f} ms, {st['events']:.0f} kernels and copies")
    out["step"] = {k: dict(v, grads=None) for k, v in step.items()}
    out["peak"] = (peak, peak_r)
    del step, g_a, g_b, g_r
    torch.cuda.empty_cache()

    # Save in the JAX package's .npz and load back on the card: bit-equal.
    model = models.pop(("float32", "auto"))
    npz = os.path.join(tmp.name, "dc5.npz")
    model.save(npz)
    back = api.build_detr(weights=npz, dilation=True, device=DEVICE, seed=1)
    with torch.inference_mode():
        a, b = model(x, pm), back(x, pm)
    if not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("DC5 saved and loaded: outputs differ")
    dets = [Predictor(m, background_class=BACKGROUND)([img])[0] for m in (model, back)]
    if not all(np.array_equal(getattr(dets[0], f), getattr(dets[1], f))
               for f in ("boxes", "labels", "scores")):
        raise AssertionError("DC5 saved and loaded: detections differ")
    log(f"  DetrModel.save -> build_detr(weights=.npz) on the card: outputs and "
        f"{len(dets[0].boxes)} detections bit-equal ({os.path.getsize(npz) / 2**20:.1f} MiB)")
    del model, back
    tmp.cleanup()
    torch.cuda.empty_cache()
    return out


# Instance segmentation: DETR-R50 with its mask head (DETRsegm), served at
# 800x1333 b1 (the 896x1408 bucket: stride-4 masks of 224x352), the int8 and
# fused backbones under it, the mask-head training step of the frozen-detector
# recipe, and the entry points. The CPU comparison runs a reduced-depth model.
SEG_SERVE, SEG_BUCKET, SEG_EXACT = (800, 1333), (896, 1408), (768, 1280)
SEG_SMALL = dict(backbone_stage_sizes=(1, 1, 1, 1), num_encoder_layers=2, num_decoder_layers=2)
SEG_SMALL_IN = (256, 384, 230, 301)  # canvas (H, W) and the image's valid extent in it
# The CPU parity tests' bounds (tests/test_torch_segmentation.py).
SEG_MASK_ATOL = 1e-3
SEG_STEPS, SEG_ENTRY_IMAGES = 2, 4
SEG_FUSED_PER_FORWARD = (1, 4, 12)  # (C, D-tf32, E-tf32) of a bucket-exact fused forward


def _mask_head_ms(torch, model, x, mask):
    """Device ms of the segmentation head alone (``bbox_attention`` and
    ``mask_head``) on the inputs one forward gives them, from CUDA events
    around 3 calls of each after one warm call."""
    args = {}
    hooks = [getattr(model.module, name).register_forward_hook(
        lambda m, a, o, name=name: args.__setitem__(name, a)) for name in ("bbox_attention",
                                                                           "mask_head")]
    try:
        with torch.inference_mode():
            model(x, mask)
    finally:
        for h in hooks:
            h.remove()
    out = {}
    with torch.inference_mode():
        for name, a in args.items():
            fn = getattr(model.module, name)
            out[name] = time_ms(torch, lambda: fn(*a), iters=3, warmup=1)
    return out


def phase_segmentation(torch, fa, lap, mp, fr, fb, mm, conv, api, quantized, train, serve,
                       Predictor):
    """Instance segmentation: a seeded DETR-R50 DETRsegm checkpoint in
    facebook's naming, served with masks at fp32 and bf16 beside the same
    detector without masks, through the int8 and the fused backbones, held
    against the CPU at reduced depth, over HTTP, trained by the
    frozen-detector recipe, and through ``finetune_coco_masks`` and
    ``eval --masks``. Counts reset just before each main-path run and read
    just after."""
    import math
    import os
    import tempfile

    from detr_tensorflow_tpu_torch import eval as eval_main
    from detr_tensorflow_tpu_torch import finetune_coco_masks
    from detr_tensorflow_tpu_torch.data import make_synthetic_coco
    from detr_tensorflow_tpu_torch.data.masks import rle_to_mask
    from detr_tensorflow_tpu_torch.train.engine import batch_to_device

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_segm_")
    path = os.path.join(tmp.name, "detr-r50-segm.pth")
    t0 = time.perf_counter()
    torch.save({"model": segmentation_state_dict(seed=51)}, path)
    build = functools.partial(api.build_detr, weights=path, device=DEVICE)
    models = {(dt, masks): build(dtype=dt, masks=masks)
              for dt in ("float32", "bfloat16") for masks in (True, False)}
    log(f"  facebook-named DETR-R50 DETRsegm .pth written and 4 models built from it (with and "
        f"without masks, fp32 and bf16) in {time.perf_counter() - t0:.2f} s")
    launches = collections.Counter()
    out = {"launches": launches}

    # Serving at 800x1333 b1, 5 requests a model after one warm-up.
    img = random_images([SEG_SERVE], seed=52)[0]
    (h, w), (bh, bw) = SEG_SERVE, SEG_BUCKET
    frames = np.zeros((1, bh, bw, 3), np.uint8)
    frames[0, :h, :w] = img
    pm = torch.zeros((1, bh, bw), dtype=torch.bool, device=DEVICE)
    pm[0, :h, :w] = True
    out["serving"] = {}
    for dtype in ("float32", "bfloat16"):
        route = "A-tf32" if dtype == "float32" else "A-mma"
        for masks in (True, False):
            pred = Predictor(models[(dtype, masks)], background_class=BACKGROUND, masks=masks)
            pred.warmup([SEG_SERVE])
            reset_counts(fa, lap, mp)  # main path
            lat = []
            for _ in range(5):
                t0 = time.perf_counter()
                dets = pred([img])
                lat.append(1e3 * (time.perf_counter() - t0))
            counts = read_counts(fa, lap, mp)
            want = {k: 0 for k in counts}
            want.update({route: 5 * LAUNCHES_PER_FORWARD, "C": 5})
            if counts != want:
                raise AssertionError(f"segm {dtype} masks={masks} serving launches {counts}, "
                                     f"expected {want}")
            launches["flash_attention_fwd_tf32" if dtype == "float32" else
                     "flash_attention_fwd_mma"] += counts[route]
            launches["maxpool"] += counts["C"]
            check_detections(dets)
            d = dets[0]
            if masks and (d.masks is None or d.masks.dtype != bool
                          or d.masks.shape != (len(d.boxes), h, w)):
                raise AssertionError(f"masks {None if d.masks is None else d.masks.shape}, "
                                     f"expected bool ({len(d.boxes)}, {h}, {w})")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            pred([img])
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            wall, busy, events = device_busy_ms(torch, lambda: pred([img]))
            share = "not measured" if busy is None else f"{busy:.2f} ms, idle {1 - busy / wall:.2f}"
            head = _mask_head_ms(torch, models[(dtype, masks)], pred.normalize(
                torch.from_numpy(frames).to(DEVICE)) * pm[..., None], pm) if masks else {}
            out["serving"][(dtype, masks)] = dict(p50=statistics.median(lat), busy=busy,
                                                  wall=wall, peak=peak, head=head)
            log(f"  DETR-R50 {'with masks' if masks else 'without masks'} {dtype} 800x1333 b1: "
                f"p50 {statistics.median(lat):.2f} ms of {[round(v, 2) for v in lat]}; under "
                f"torch.profiler wall {wall:.2f} ms, device busy {share}, {events:.0f} kernels "
                f"and copies; peak memory above the model {peak:.2f} GiB; launches {counts}"
                + (f"; {len(d.boxes)} masks ({h}x{w} bool); segmentation head alone, CUDA events: "
                   f"bbox_attention {head['bbox_attention']:.2f} ms, mask_head "
                   f"{head['mask_head']:.2f} ms" if masks else ""))
            del pred
    torch.cuda.empty_cache()

    # The int8 and fused backbones under the mask head, against the unfused
    # fp32 model (readings of the pred_masks gap).
    with torch.inference_mode():
        x = Predictor(models[("float32", True)], BACKGROUND).normalize(
            torch.from_numpy(frames).to(DEVICE)) * pm[..., None]
        ref = models[("float32", True)](x, pm)
    int8 = build(dtype="bfloat16", masks=True, backbone_quant=True)
    with torch.inference_mode():
        calib = Predictor(int8, BACKGROUND).normalize(
            torch.from_numpy(np.stack(random_images([SEG_SERVE] * 2, seed=53))).to(DEVICE))
    quantized.quantize_model(int8, calib)
    del calib
    with torch.inference_mode():
        int8(x, pm)  # kernel builds and plans
    reset_int8_counts(mm, conv)  # main path
    fa.mha.mma_launches = 0
    with torch.inference_mode():
        q8 = int8(x, pm)
    torch.cuda.synchronize()
    f_counts = (mm.qmatmul.launches, mm.qmatmul_residual.launches, mm.qmatmul_residual2.launches)
    g_counts = dict(conv.conv3x3_int8.launches)
    if (f_counts != tuple(F_PER_FORWARD.values()) or g_counts != G_PER_FORWARD
            or fa.mha.mma_launches != LAUNCHES_PER_FORWARD):
        raise AssertionError(f"int8 segm launches: F {f_counts}, G {g_counts}, A-mma "
                             f"{fa.mha.mma_launches}")
    launches["int8_matmul"] += sum(f_counts)
    launches["int8_conv"] += sum(g_counts.values())
    launches["flash_attention_fwd_mma"] += fa.mha.mma_launches
    int8_gap = float((q8["pred_masks"] - ref["pred_masks"]).abs().max())
    if not bool(torch.isfinite(q8["pred_masks"]).all()):
        raise AssertionError("int8 segm forward: non-finite pred_masks")
    del int8, q8
    fused = build(masks=True, fuse_residual=True, fuse_bottleneck=True)
    xe = random_images([SEG_EXACT], seed=54)[0]
    with torch.inference_mode():
        xe = Predictor(fused, BACKGROUND).normalize(torch.from_numpy(xe[None]).to(DEVICE))
        fused(xe)  # kernel builds
    d, e = fr.conv1x1_bn_residual_relu, fb.fused_bottleneck
    d.tf32_launches = e.tf32_launches = mp.max_pool_3x3_s2.launches = 0  # main path
    d.launches = d.mma_launches = e.launches = e.mma_launches = fa.mha.tf32_launches = 0
    with torch.inference_mode():
        fo = fused(xe)
    torch.cuda.synchronize()
    fused_counts = (mp.max_pool_3x3_s2.launches, d.tf32_launches, e.tf32_launches,
                    fa.mha.tf32_launches)
    if fused_counts != SEG_FUSED_PER_FORWARD + (LAUNCHES_PER_FORWARD,) or any(
            (d.launches, d.mma_launches, e.launches, e.mma_launches)):
        raise AssertionError(f"fused segm launches (C, D-tf32, E-tf32, A-tf32) {fused_counts}")
    for name, n in zip(("maxpool", "fused_residual_tf32", "fused_bottleneck_tf32",
                        "flash_attention_fwd_tf32"), fused_counts):
        launches[name] += n
    with torch.inference_mode():
        fused_gap = float((fo["pred_masks"] - models[("float32", True)](xe)["pred_masks"])
                          .abs().max())
    log(f"  int8 segm 800x1333 b1 (bf16 compute): F {f_counts}, G {g_counts}, A-mma "
        f"{LAUNCHES_PER_FORWARD}; fused segm fp32 768x1280 bucket-exact: (C, D-tf32, E-tf32, "
        f"A-tf32) {fused_counts}; pred_masks max |gap| against the unfused fp32 model (a "
        f"reading): int8 {int8_gap:.3e}, fused {fused_gap:.3e}")
    out["gaps"] = (int8_gap, fused_gap)
    del fused, fo, ref, x, xe
    torch.cuda.empty_cache()

    # The card against the CPU at reduced depth (fp32, TF32 off).
    small = {d: api.build_detr(device=d, masks=True, **SEG_SMALL) for d in (DEVICE, "cpu")}
    sh, sw, vh, vw = SEG_SMALL_IN
    xs = torch.from_numpy(np.random.default_rng(55).normal(size=(1, sh, sw, 3)).astype(
        np.float32))
    ms = torch.zeros((1, sh, sw), dtype=torch.bool)
    ms[:, :vh, :vw] = True
    xs = xs * ms[..., None]
    card = small[DEVICE](xs.to(DEVICE), ms.to(DEVICE))
    cpu = small["cpu"](xs, ms)
    errs = {k: float((card[k].cpu() - cpu[k]).abs().max())
            for k in ("pred_boxes", "pred_logits", "pred_masks")}
    log(f"  reduced-depth segm model (stages 1,1,1,1, 2+2 layers) {sh}x{sw} masked, card fp32 "
        f"against the CPU: boxes {errs['pred_boxes']:.3e} (tol {BOX_ATOL}), logits "
        f"{errs['pred_logits']:.3e} (tol {LOGIT_ATOL}), pred_masks {errs['pred_masks']:.3e} (tol "
        f"{SEG_MASK_ATOL})")
    if not (errs["pred_boxes"] <= BOX_ATOL and errs["pred_logits"] <= LOGIT_ATOL
            and errs["pred_masks"] <= SEG_MASK_ATOL):
        raise AssertionError(f"segm card against CPU: {errs}")
    out["cpu_errs"] = errs
    del small, card, cpu

    # HTTP: mask_rle decodes to the Predictor's mask.
    pred = Predictor(models[("float32", True)], background_class=BACKGROUND, masks=True)
    service = serve.DetrService(pred, [str(i) for i in range(92)])
    service.submit(pred.warmup, [SEG_SERVE])
    server = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        buf = io.BytesIO()
        np.save(buf, img)
        req = urllib.request.Request(f"http://127.0.0.1:{server.server_address[1]}/detect",
                                     data=buf.getvalue(), method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            status, payload = r.status, json.loads(r.read())
        ms_post = 1e3 * (time.perf_counter() - t0)
        det = service.detect([img])[0]
        dets = payload.get("detections", [])
        if status != 200 or len(dets) != len(det.masks) or not all(
                np.array_equal(rle_to_mask(dd["mask_rle"]).astype(bool), m)
                for dd, m in zip(dets, det.masks)):
            raise AssertionError("POST /detect with masks: mask_rle does not decode to the "
                                 "Predictor's masks")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")
    log(f"  POST /detect 800x1333 with --masks: 200 in {ms_post:.2f} ms, {len(dets)} detections, "
        f"each mask_rle decoding to the Predictor's mask")
    del pred, service, models
    torch.cuda.empty_cache()

    # The mask-head training step: the frozen-detector recipe, b8 376x672,
    # dropout 0.1.
    config = train.TrainingConfig(background_class=BACKGROUND, train_backbone=False,
                                  train_transformers=False, train_nlayers=True,
                                  batch_size=TRAIN_BATCH)
    batch = train_batch(56)
    rng = np.random.default_rng(56)
    hm, wm = (-(-TRAIN_HW[0] // 4), -(-TRAIN_HW[1] // 4))
    batch["t_masks"] = (rng.random((TRAIN_BATCH, 100, hm, wm)) < 0.3).astype(np.uint8)
    batch = batch_to_device(batch, DEVICE)
    model = build(masks=True).module
    trainer = train.Trainer(model, config, seed=0)
    trainer.step(batch)  # cuDNN plans, kernel loads
    reset_counts(fa, lap, mp)  # main path
    logs = [trainer.step(batch) for _ in range(SEG_STEPS)]
    counts = read_counts(fa, lap, mp)
    want = {k: 0 for k in counts}
    want.update({"A-tf32": SEG_STEPS * LAUNCHES_PER_FORWARD, "B": SEG_STEPS, "C": SEG_STEPS})
    losses_ = [float(lg["total_loss"]) for lg in logs]
    if counts != want or not all(math.isfinite(v) for v in losses_) or not all(
            {"mask_loss", "dice_loss"} <= set(lg) for lg in logs):
        raise AssertionError(f"mask-head step: launches {counts} (expected {want}), losses "
                             f"{losses_}")
    for name, key in (("flash_attention_fwd_tf32", "A-tf32"), ("lap", "B"), ("maxpool", "C")):
        launches[name] += counts[key]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    trainer.step(batch)
    torch.cuda.synchronize()
    step_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    wall, busy, events = device_busy_ms(torch, lambda: trainer.step(batch))
    out["step"] = dict(wall=wall, busy=busy, peak=step_peak)
    log(f"  mask-head step (frozen detector) b{TRAIN_BATCH} {TRAIN_HW[0]}x{TRAIN_HW[1]} fp32 "
        f"dropout {DROPOUT}, {SEG_STEPS} steps: launches {counts}; losses "
        f"{[round(v, 4) for v in losses_]}, mask_loss {float(logs[-1]['mask_loss']):.4f}, "
        f"dice_loss {float(logs[-1]['dice_loss']):.4f}; under torch.profiler wall {wall:.2f} ms, "
        f"device busy {busy:.2f} ms, {events:.0f} kernels and copies; peak memory of a step "
        f"above the memory held before it {step_peak:.2f} GiB")
    del trainer, model, batch
    torch.cuda.empty_cache()

    # Entry points from image files with polygon masks: a training set of
    # SEG_STEPS batches and an evaluation set of SEG_ENTRY_IMAGES images.
    def data(name, n, seed):
        root = os.path.join(tmp.name, name)
        make_synthetic_coco(root, n_images=n, seed=seed, masks=True, sizes=ENTRY_SIZES,
                            boxes_per_image=ENTRY_BOXES)
        return ["--data_dir", root, "--img_dir", "images", "--ann_file", "ann.json",
                "--device", DEVICE]

    reset_counts(fa, lap, mp)  # main path: mask-head training from image files
    t0 = time.perf_counter()
    trainer = finetune_coco_masks.main(data("train", SEG_STEPS * TRAIN_BATCH, 57) + [
        "--weights", path, "--batch_size", str(TRAIN_BATCH), "--target_batch", str(TRAIN_BATCH),
        "--image_size", *map(str, TRAIN_HW), "--epochs", "1", "--steps_per_epoch",
        str(SEG_STEPS), "--evaluation_steps", "0"])
    torch.cuda.synchronize()
    counts = read_counts(fa, lap, mp)
    want = {k: 0 for k in counts}
    want.update({"A-tf32": SEG_STEPS * LAUNCHES_PER_FORWARD, "B": SEG_STEPS, "C": SEG_STEPS})
    if counts != want or trainer.steps != SEG_STEPS:
        raise AssertionError(f"finetune_coco_masks: {trainer.steps} steps, launches {counts}")
    for name, key in (("flash_attention_fwd_tf32", "A-tf32"), ("lap", "B"), ("maxpool", "C")):
        launches[name] += counts[key]
    npz = os.path.join(tmp.name, "segm.npz")
    api.DetrModel(trainer.model).save(npz)
    log(f"  finetune_coco_masks.main: {trainer.steps} steps in {time.perf_counter() - t0:.2f} s "
        f"(model build included), launches {counts}; saved as .npz")
    del trainer
    torch.cuda.empty_cache()
    reset_counts(fa, lap, mp)  # main path: mask AP from image files
    table = eval_main.main(data("val", SEG_ENTRY_IMAGES, 58) + ["--weights", npz, "--masks"])
    counts = read_counts(fa, lap, mp)
    want = {k: 0 for k in counts}
    want.update({"A-tf32": SEG_ENTRY_IMAGES * LAUNCHES_PER_FORWARD, "C": SEG_ENTRY_IMAGES})
    if counts != want or set(table) != {"box", "mask"}:
        raise AssertionError(f"eval --masks: launches {counts}, table {table}")
    for name, key in (("flash_attention_fwd_tf32", "A-tf32"), ("maxpool", "C")):
        launches[name] += counts[key]
    log(f"  eval.main --masks (full lattice, batch 1, {SEG_ENTRY_IMAGES} images): launches "
        f"{counts}; mask AP {dict(table['mask'])}")
    tmp.cleanup()
    torch.cuda.empty_cache()
    return out


# Panoptic segmentation: DETR-R50 with its DETRsegm mask head on COCO
# panoptic's category layout (80 things with COCO's ids in 1-90, 53 stuff with
# panoptic's ids in 92-200: 202 logits, background 201), over a synthetic
# COCO panoptic set at COCO-like sizes; and kernel B at the panoptic recipe's
# 250 queries and 250 target slots.
PAN_STUFF = (92, 93, 95, 100, 107, 109, 112, 118, 119, 122, 125, 128, 130, 133, 138, 141, 144,
             145, 147, 148, 149, 151, 154, 155, 156, 159, 161, 166, 168, 171, 175, 176, 177, 178,
             180, 181, 184, 185, 186, 187, 188, 189, 190, 191, 192, 193, 194, 195, 196, 197,
             198, 199, 200)
PAN_CLASSES, PAN_BACKGROUND = 202, 201
PAN_SIZES = [(800, 1333), (640, 480), (427, 640), (480, 640), (612, 612), (375, 500),
             (800, 1066), (512, 683)]
PAN_STEPS, PAN_RECIPE_STEPS, PAN_QUERIES = 2, 3, 250
PAN_LAP_SLOTS, PAN_LAP_MAX_REAL = 250, 60
# The device merge against the host's: equal away from pixels whose two best
# weighted scores, or whose winner's probability and the threshold, lie
# within PAN_MERGE_BAND (the card's bilinear resize rounds as numpy's only
# to float32's last bits); the PQ table from the host maps within
# PAN_PQ_ATOL of eval's, its counts equal.
PAN_MERGE_BAND, PAN_PQ_ATOL = 1e-5, 1e-4


def write_panoptic_set(root, sizes, seed, things, stuff, jpegs=None):
    """A COCO panoptic set as its files, from a numpy seed: per (h, w) a
    random RGB PNG (or, given ``jpegs``, a copy of ``jpegs[i]``, a JPEG file
    of that size) and a segment-id PNG (id = R + 256 G + 65536 B, ids drawn
    from all 24 bits) of 2-5 stuff bands across the image, 4-30 thing
    rectangles over them, one crowd thing and a VOID rectangle (id 0);
    ``panoptic.json`` with the images, each segment's category, iscrowd,
    area and bbox (none on the first stuff band, whose box the loaders take
    from its mask) and the categories. Returns the json's path."""
    import os
    import shutil

    from detr_tensorflow_tpu_torch.data.image_io import write_png

    rng = np.random.default_rng(seed)
    for d in ("images", "panoptic"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    images, annotations = [], []
    for i, (h, w) in enumerate(sizes):
        image_name = f"{i}.jpg" if jpegs else f"{i}.png"
        if jpegs:
            shutil.copy(jpegs[i], os.path.join(root, "images", image_name))
        else:
            write_png(os.path.join(root, "images", image_name),
                      rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        ids = rng.choice(2 ** 24 - 1, size=48, replace=False) + 1
        id_map = np.zeros((h, w), np.int64)
        cuts = [0] + sorted(rng.choice(np.arange(1, h), rng.integers(1, 5), replace=False)) + [h]
        segs = []
        for y0, y1 in zip(cuts[:-1], cuts[1:]):
            id_map[y0:y1] = ids[len(segs)]
            segs.append((ids[len(segs)], int(rng.choice(stuff)), 0))
        n_things = int(rng.integers(4, 31))
        for t in range(n_things + 1):  # the last one is a crowd
            bh, bw = int(rng.integers(h // 20, h // 3)), int(rng.integers(w // 20, w // 3))
            y0, x0 = int(rng.integers(0, h - bh)), int(rng.integers(0, w - bw))
            id_map[y0:y0 + bh, x0:x0 + bw] = ids[len(segs)]
            segs.append((ids[len(segs)], int(rng.choice(things)), int(t == n_things)))
        vh, vw = int(rng.integers(h // 20, h // 6)), int(rng.integers(w // 20, w // 6))
        vy, vx = int(rng.integers(0, h - vh)), int(rng.integers(0, w - vw))
        id_map[vy:vy + vh, vx:vx + vw] = 0
        info = []
        for k, (sid, cat, crowd) in enumerate(segs):
            ys, xs = np.nonzero(id_map == sid)
            if len(ys) == 0:  # covered by later segments
                continue
            seg = {"id": int(sid), "category_id": cat, "iscrowd": crowd, "area": int(len(ys))}
            if k:
                seg["bbox"] = [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                               int(ys.max() - ys.min() + 1)]
            info.append(seg)
        write_png(os.path.join(root, "panoptic", f"{i}.png"), np.stack(
            [id_map % 256, (id_map // 256) % 256, id_map // 65536], -1).astype(np.uint8))
        images.append({"id": i, "file_name": image_name, "height": h, "width": w})
        annotations.append({"image_id": i, "file_name": f"{i}.png", "segments_info": info})
    categories = ([{"id": c, "name": f"thing{c}", "isthing": 1} for c in things]
                  + [{"id": c, "name": f"stuff{c}", "isthing": 0} for c in stuff])
    path = os.path.join(root, "panoptic.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": annotations, "categories": categories}, f)
    return path


def panoptic_lap_problems(seed, ties=False, wide_problem=True):
    """48 problems of 250 x 250 costs with 0-60 real rows each, scattered
    over the 250 slots, and (``wide_problem``) problem 1 with all 250 rows
    real: more than the kernel's shared memory stages."""
    rng = np.random.default_rng(seed)
    shape = (LAP_PROBLEMS, PAN_LAP_SLOTS, PAN_LAP_SLOTS)
    cost = rng.integers(0, 4, size=shape) if ties else rng.normal(size=shape)
    cost = cost.astype(np.float32)
    n_real = rng.integers(0, PAN_LAP_MAX_REAL + 1, size=LAP_PROBLEMS)
    n_real[0] = 0
    if wide_problem:
        n_real[1] = PAN_LAP_SLOTS
    mask = np.stack([rng.permutation(np.arange(PAN_LAP_SLOTS) < n) for n in n_real])
    return cost, mask, n_real


def phase_panoptic_lap(torch, lap):
    """B's 256-column instance at 48 x 250 x 250 against its plain version
    and scipy: assignments equal on continuous costs, the optimal cost on
    tied ones; its time from CUDA graphs beside the plain version's, scipy's,
    the bound and the serial chain, with and without the 250-row problem."""
    from scipy.optimize import linear_sum_assignment

    worst, times = 0.0, {}
    for ties, wide_problem in ((False, True), (True, True), (False, False)):
        cost, mask, n_real = panoptic_lap_problems(71 + ties + 2 * wide_problem, ties,
                                                   wide_problem)
        ct, mt = torch.from_numpy(cost).to(DEVICE), torch.from_numpy(mask).to(DEVICE)
        wide0 = lap.solve_lap_masked.wide_launches
        got = lap.solve_lap_masked(ct, mt).cpu().numpy()
        if lap.solve_lap_masked.wide_launches != wide0 + 1:
            raise AssertionError("B at 250 columns did not launch its 256-column instance")
        t0 = time.perf_counter()
        plain = lap.reference_solve_lap_masked(ct, mt).cpu().numpy()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        scipy_cols = [linear_sum_assignment(c[m])[1] for c, m in zip(cost, mask)]
        scipy_ms = 1e3 * (time.perf_counter() - t0)
        for i, (m, n) in enumerate(zip(mask, n_real)):
            if (got[i, ~m] != -1).any() or len(set(got[i, m].tolist())) != n:
                raise AssertionError(f"problem {i}: not an assignment of its {n} real rows")
            best = float(cost[i, m][np.arange(n), scipy_cols[i]].sum())
            err = abs(float(cost[i, m][np.arange(n), got[i, m]].sum()) - best)
            worst = max(worst, err)
            if not err <= 1e-4 * max(1.0, abs(best)):
                raise AssertionError(f"problem {i} of 250 columns: cost {err} above the optimum")
            if not ties and ((got[i, m] != scipy_cols[i]).any() or (got[i] != plain[i]).any()):
                raise AssertionError(f"problem {i} of 250 columns: assignment differs from "
                                     "plain/scipy")
        if ties:
            log("  lap 48x250x250 tied costs (one problem of 250 real rows): optimal cost equal "
                "to scipy's on every problem")
            continue
        call = lambda: lap.solve_lap_masked(ct, mt)  # noqa: E731
        ms = graph_ms(torch, call)
        chain = max(lap.augmenting_steps(ct.cpu(), mt.cpu()))
        bound = bound_ms(4 * PAN_LAP_SLOTS * int(n_real.sum()) + 5 * mask.size, {})
        times[wide_problem] = (ms, plain_ms, scipy_ms, bound, chain)
        log(f"  lap {LAP_PROBLEMS}x{PAN_LAP_SLOTS}x{PAN_LAP_SLOTS} (256-column instance), "
            f"scattered n_real 0..{PAN_LAP_MAX_REAL}"
            + (f" and one problem of {PAN_LAP_SLOTS} real rows" if wide_problem else "")
            + f": kernel {ms:.4f} ms from CUDA graphs, plain (on the card's tensors) "
            f"{plain_ms:.2f} ms, scipy host loop {scipy_ms:.2f} ms, bound {bound[0]:.5f} ms "
            f"({bound[1]}); serial chain of the longest problem {chain} Dijkstra steps; "
            f"assignments equal to plain and scipy")
    return worst, times


def _pq_gaps(got, want):
    """(counts equal, the largest |difference| of pq/sq/rq) between two
    ``panoptic_quality`` tables."""
    same, gap = set(got["per_class"]) == set(want["per_class"]), 0.0
    for c, w in want["per_class"].items():
        g = got["per_class"].get(c, {})
        same &= all(g.get(k) == w[k] for k in ("tp", "fp", "fn"))
        gap = max([gap] + [abs(g.get(k, 0.0) - w[k]) for k in ("pq", "sq", "rq")])
    for part in ("things", "stuff"):
        gap = max([gap] + [abs(got[part][k] - want[part][k]) for k in ("pq", "sq", "rq")])
    return same, max(gap, abs(got["pq"] - want["pq"]))


def phase_panoptic(torch, fa, lap, mp, api, train):
    """Panoptic segmentation: B at 250 columns; a seeded DETR-R50 DETRsegm
    checkpoint over COCO panoptic's 202 classes evaluated by
    ``eval --masks --pq --panoptic_ann`` at fp32 and bf16 on a synthetic COCO
    panoptic set, the device merge against the host's; its frozen detector
    finetuned by ``finetune_coco_masks --panoptic_ann``; and the JAX
    package's panoptic training recipe at full width (250 queries and target
    slots, every group training) through the panoptic train loader, its
    train state round-tripped. Counts reset just before each main-path run
    and read just after."""
    import os
    import tempfile

    from detr_tensorflow_tpu_torch import eval as eval_main
    from detr_tensorflow_tpu_torch import finetune_coco_masks, inference
    from detr_tensorflow_tpu_torch.data import COCO_CLASS_NAME, load_coco_panoptic
    from detr_tensorflow_tpu_torch.metrics import panoptic_quality

    launches = collections.Counter()
    out = {"launches": launches}
    out["lap_err"], out["lap"] = phase_panoptic_lap(torch, lap)

    things = [i for i, name in enumerate(COCO_CLASS_NAME[:91]) if name != "N/A"]
    if len(things) != 80 or len(PAN_STUFF) != 53:
        raise AssertionError(f"{len(things)} things and {len(PAN_STUFF)} stuff classes")
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_panoptic_")
    root = os.path.join(tmp.name, "coco_panoptic")
    t0 = time.perf_counter()
    ann = write_panoptic_set(root, PAN_SIZES, 61, things, PAN_STUFF)
    png_dir = os.path.join(root, "panoptic")
    path = os.path.join(tmp.name, "detr-r50-panoptic.pth")
    torch.save({"model": segmentation_state_dict(seed=62, num_classes=PAN_CLASSES)}, path)
    log(f"  synthetic COCO panoptic set: {len(PAN_SIZES)} PNG images at {PAN_SIZES}, 80 things "
        f"and 53 stuff classes ({PAN_CLASSES} logits, background {PAN_BACKGROUND}), and a "
        f"seeded facebook-named DETR-R50 DETRsegm .pth written in "
        f"{time.perf_counter() - t0:.2f} s")
    data = ["--data_dir", root, "--img_dir", "images", "--ann_file", "panoptic.json",
            "--device", DEVICE, "--weights", path, "--panoptic_ann", ann,
            "--panoptic_png_dir", png_dir]
    n_images = len(PAN_SIZES)

    # eval --masks --pq --panoptic_ann, fp32 (TF32 off) and bf16.
    out["eval"] = {}
    for dtype in ("float32", "bfloat16"):
        route = "A-tf32" if dtype == "float32" else "A-mma"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts(fa, lap, mp)  # main path
        t0 = time.perf_counter()
        table = eval_main.main(data + ["--masks", "--pq", "--compute_dtype", dtype],
                               num_classes=PAN_CLASSES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(fa, lap, mp)
        want = {k: 0 for k in counts}
        want.update({route: n_images * LAUNCHES_PER_FORWARD, "C": n_images})
        pq = table.get("pq", {})
        if counts != want or set(table) != {"box", "mask", "pq"} or not {
                "things", "stuff"} <= set(pq) or not 0.0 <= pq["pq"] <= 1.0:
            raise AssertionError(f"eval --pq {dtype}: launches {counts} (expected {want}), "
                                 f"table keys {set(table)}")
        launches["flash_attention_fwd_tf32" if dtype == "float32" else
                 "flash_attention_fwd_mma"] += counts[route]
        launches["maxpool"] += counts["C"]
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        out["eval"][dtype] = dict(images_s=n_images / wall, peak=peak, pq=pq)
        tp = sum(c["tp"] for c in pq["per_class"].values())
        fp = sum(c["fp"] for c in pq["per_class"].values())
        fn = sum(c["fn"] for c in pq["per_class"].values())
        log(f"  eval.main --masks --pq --panoptic_ann {dtype}, {n_images} images at batch 1: "
            f"{n_images / wall:.2f} images/s ({wall:.2f} s, the model's build from the .pth and "
            f"the loader's start included); launches {counts}; peak memory above the memory "
            f"held before it {peak:.2f} GiB; PQ {100 * pq['pq']:.2f} over {pq['n_classes']} "
            f"classes (things {pq['things']['n_classes']}, stuff {pq['stuff']['n_classes']}; "
            f"tp {tp}, fp {fp}, fn {fn}: random weights)")
    torch.cuda.empty_cache()

    # The device merge against the host's on the same probabilities, and the
    # PQ table from the host maps against eval's (fp32).
    model = api.build_detr(weights=path, device=DEVICE, masks=True, num_classes=PAN_CLASSES)
    config = train.TrainingConfig(background_class=PAN_BACKGROUND)
    valid_dt, _ = load_coco_panoptic(config, 1, ann_file=ann, png_dir=png_dir,
                                     img_dir=os.path.join(root, "images"))
    args = collections.defaultdict(list)
    differing, band, pixels, host_s = 0, 0, 0, 0.0
    merge_ms = None
    for batch in valid_dt:
        x = torch.from_numpy(batch["images"]).to(DEVICE)
        pm = torch.from_numpy(batch["pixel_mask"]).to(DEVICE)
        outputs = model(x, pm)
        _, labels, scores, keep = (t[0].cpu().numpy() for t in inference.postprocess(
            outputs, PAN_BACKGROUND, "yxyx"))
        probs = inference.mask_probs(outputs["pred_masks"], pm)[0]
        h, w = int(batch["pixel_mask"][0][:, 0].sum()), int(batch["pixel_mask"][0][0].sum())
        dev = inference.merge_full_res(inference.kept_probs(probs, keep, h, w), scores[keep])
        if merge_ms is None and (h, w) == PAN_SIZES[0]:
            merge_ms = time_ms(torch, lambda: inference.merge_full_res(
                inference.kept_probs(probs, keep, h, w), scores[keep]), iters=5, warmup=1)
        t0 = time.perf_counter()
        up = inference.upsample_mask_probs(probs.cpu().numpy()[keep], (h, w))
        host = (inference.np_merge_full_res(up, scores[keep], np.ones(int(keep.sum()), bool))
                if keep.any() else np.full((h, w), -1, np.int32))
        host_s += time.perf_counter() - t0
        if keep.sum() >= 2:
            weighted = up * scores[keep]
            top2 = np.partition(weighted, -2, axis=-1)[..., -2:]
            best = np.take_along_axis(up, weighted.argmax(-1)[..., None], -1)[..., 0]
            near = ((np.abs(top2[..., 1] - top2[..., 0]) <= PAN_MERGE_BAND)
                    | (np.abs(best - 0.5) <= PAN_MERGE_BAND))
        else:
            near = np.zeros((h, w), bool)
        off = dev != host
        if (off & ~near).any():
            raise AssertionError(f"device merge differs from np_merge_full_res at "
                                 f"{int((off & ~near).sum())} pixels away from ties")
        differing, band = differing + int(off.sum()), band + int(near.sum())
        pixels += h * w
        n = int(batch["mask"][0].sum())
        args["pred_seg_maps"].append(host)
        args["pred_labels"].append(labels[keep])
        args["gt_masks"].append(batch["t_masks_full"][0][:n, :h, :w] > 0)
        args["gt_classes"].append(batch["classes"][0][:n])
        args["gt_iscrowd"].append(batch["gt_is_crowd"][0][:n])
        args["void_masks"].append(batch["void_mask"][0][:h, :w])
    host_table = panoptic_quality(**args, stuff_classes=valid_dt.stuff_classes)
    same, gap = _pq_gaps(out["eval"]["float32"]["pq"], host_table)
    if not same or gap > PAN_PQ_ATOL:
        raise AssertionError(f"eval's PQ table against the host maps': counts equal {same}, "
                             f"largest gap {gap}")
    out["merge_ms"] = merge_ms
    log(f"  device merge (kept_probs + merge_full_res) against np_merge_full_res on the same "
        f"probabilities, {n_images} images: {differing} of {pixels} pixels differ, all within "
        f"the {PAN_MERGE_BAND} band of a tie or of the threshold ({band} pixels there); PQ "
        f"table "
        f"from the host maps: counts equal, largest |gap| {gap:.2e}; the merge at "
        f"{PAN_SIZES[0][0]}x{PAN_SIZES[0][1]} with 100 kept queries {merge_ms:.3f} ms (CUDA "
        f"events, its (h, w) map copied to the host), the host's upsample_mask_probs + "
        f"np_merge_full_res {1e3 * host_s / n_images:.1f} ms an image")
    del model, valid_dt
    torch.cuda.empty_cache()

    # finetune_coco_masks --panoptic_ann: the frozen detector, 100 queries.
    reset_counts(fa, lap, mp)  # main path
    t0 = time.perf_counter()
    trainer = finetune_coco_masks.main(data + [
        "--batch_size", str(TRAIN_BATCH), "--target_batch", str(TRAIN_BATCH), "--image_size",
        *map(str, TRAIN_HW), "--epochs", str(PAN_STEPS), "--steps_per_epoch", "1"],
        num_classes=PAN_CLASSES)
    torch.cuda.synchronize()
    counts = read_counts(fa, lap, mp)
    want = {k: 0 for k in counts}
    want.update({"A-tf32": PAN_STEPS * LAUNCHES_PER_FORWARD, "B": PAN_STEPS, "C": PAN_STEPS})
    if counts != want or trainer.steps != PAN_STEPS or lap.solve_lap_masked.wide_launches:
        raise AssertionError(f"finetune_coco_masks --panoptic_ann: {trainer.steps} steps, "
                             f"launches {counts}")
    for name, key in (("flash_attention_fwd_tf32", "A-tf32"), ("lap", "B"), ("maxpool", "C")):
        launches[name] += counts[key]
    log(f"  finetune_coco_masks.main --panoptic_ann: {trainer.steps} frozen-detector steps at "
        f"b{TRAIN_BATCH} {TRAIN_HW[0]}x{TRAIN_HW[1]}, 100 queries, in "
        f"{time.perf_counter() - t0:.2f} s (model build included), launches {counts} (B at 100 "
        f"columns)")
    del trainer
    torch.cuda.empty_cache()

    # The JAX package's panoptic recipe at full width: 250 queries and target
    # slots, every group training, fp32 (TF32 off), dropout 0.1.
    for batch_size in (TRAIN_BATCH, TRAIN_BATCH // 2):
        try:
            out["recipe"] = _panoptic_recipe(torch, fa, lap, mp, api, train, batch_size, root,
                                             tmp.name, launches)
            break
        except torch.cuda.OutOfMemoryError as e:
            if batch_size < TRAIN_BATCH:
                raise
            reason = str(e).splitlines()[0]
        log(f"  the 250-query step at b{batch_size} does not fit in the card's memory "
            f"({reason}): halving the batch")
        torch.cuda.empty_cache()
    tmp.cleanup()
    torch.cuda.empty_cache()
    return out


def _panoptic_recipe(torch, fa, lap, mp, api, train, batch_size, root, tmp, launches):
    """PAN_RECIPE_STEPS steps of the 250-query recipe at ``batch_size``
    376x672 on one batch of the panoptic train loader over ``root``: their
    launches, busy time, wall time and peak memory, and a round trip of the
    train state through ``train/checkpoint.py``."""
    import math
    import os

    from detr_tensorflow_tpu_torch.data import load_coco_panoptic_train
    from detr_tensorflow_tpu_torch.train.checkpoint import restore_latest, save_checkpoint
    from detr_tensorflow_tpu_torch.train.engine import batch_to_device

    config = train.TrainingConfig(
        data=train.DataConfig(data_dir=root, img_dir="images", ann_file="panoptic.json"),
        image_size=TRAIN_HW, num_queries=PAN_QUERIES, batch_size=batch_size, target_batch=None,
        train_backbone=True, train_transformers=True, train_nlayers=True,
        background_class=PAN_BACKGROUND)
    dataset, _ = load_coco_panoptic_train(config, batch_size)
    batch = next(iter(dataset))
    if batch["boxes"].shape[1] != PAN_QUERIES or batch["t_masks"].shape[1] != PAN_QUERIES:
        raise AssertionError(f"target slots {batch['boxes'].shape[1]}, expected {PAN_QUERIES}")
    real = batch["mask"].sum(1)
    batch = batch_to_device(batch, DEVICE)
    build = functools.partial(api.build_detr, device=DEVICE, masks=True,
                              num_classes=PAN_CLASSES, num_queries=PAN_QUERIES)
    trainer = train.Trainer(build().module, config, seed=0)
    trainer.step(batch)  # cuDNN plans, kernel loads
    reset_counts(fa, lap, mp)  # main path
    logs = [trainer.step(batch) for _ in range(PAN_RECIPE_STEPS)]
    torch.cuda.synchronize()
    counts = read_counts(fa, lap, mp)
    wide = lap.solve_lap_masked.wide_launches
    want = {k: 0 for k in counts}
    want.update({"A-tf32": PAN_RECIPE_STEPS * LAUNCHES_PER_FORWARD, "C": PAN_RECIPE_STEPS,
                 "A'-mma": PAN_RECIPE_STEPS * LAUNCHES_PER_FORWARD, "B": PAN_RECIPE_STEPS})
    losses_ = [float(lg["total_loss"]) for lg in logs]
    if counts != want or wide != PAN_RECIPE_STEPS or not all(math.isfinite(v) for v in losses_):
        raise AssertionError(f"250-query step: launches {counts} (expected {want}), B at 250 "
                             f"columns {wide}, losses {losses_}")
    for name, key in (("flash_attention_fwd_tf32", "A-tf32"),
                      ("flash_attention_bwd_mma", "A'-mma"), ("maxpool", "C")):
        launches[name] += counts[key]
    launches["lap_wide"] += wide
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    trainer.step(batch)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    wall, busy, events = device_busy_ms(torch, lambda: trainer.step(batch), calls=2)
    ckpt = os.path.join(tmp, "ckpt")
    save_checkpoint(trainer, ckpt)
    restored = restore_latest(train.Trainer(build().module, config, seed=9), ckpt)
    if restored is None or restored.steps != trainer.steps or not all(
            torch.equal(a, b) for a, b in zip(trainer.model.state_dict().values(),
                                             restored.model.state_dict().values())):
        raise AssertionError("the 250-query train state did not round-trip")
    nxt = (float(trainer.step(batch)["total_loss"]), float(restored.step(batch)["total_loss"]))
    if not math.isfinite(nxt[0]) or abs(nxt[0] - nxt[1]) > 1e-6 * abs(nxt[0]):
        raise AssertionError(f"the step after the round trip: losses {nxt}")
    log(f"  250-query panoptic recipe (every group training, fp32, dropout {DROPOUT}) "
        f"b{batch_size} {TRAIN_HW[0]}x{TRAIN_HW[1]}, {PAN_QUERIES} target slots "
        f"({real.tolist()} real), {PAN_RECIPE_STEPS} steps: launches {counts}, B at 250 "
        f"columns {wide}; losses "
        f"{[round(v, 4) for v in losses_]}; under torch.profiler wall {wall:.2f} ms, device "
        f"busy {busy:.2f} ms, {events:.0f} kernels and copies; peak memory of a step above the "
        f"memory held before it {peak:.2f} GiB; train state round-tripped through "
        f"train/checkpoint.py (step {restored.steps}), the next step's loss {nxt[0]:.6f} / "
        f"{nxt[1]:.6f} restored")
    return dict(batch=batch_size, wall=wall, busy=busy, peak=peak, losses=losses_)


# JPEG files on the card (phase 15): the committed fixtures of
# tests/data/jpeg (written by scripts/make_jpeg_fixtures.py where Pillow and
# OpenCV are installed; the card's machine has neither), decoded by the
# port's data/jpeg.py and held to the SHA-256 imageio gave for each; COCO,
# VOC, CSV (hard-hat) and COCO panoptic sets built from copies of them
# (scripts/smoke_inputs.py) drive the entry points; kernel B's generic
# instance at the widths of wider query sets, and a 300-query training step.
JPEG_TIMED = ("q75_420_640x480.jpg", "q85_420_1333x800.jpg")
JPEG_RATE_IMAGES, JPEG_STEPS, JPEG_EVAL_IMAGES = 256, 3, 8
JPEG_FT_IMAGES, JPEG_FT_STEPS, JPEG_PAN_IMAGES = 16, 2, 4
WIDE_QUERIES = 300


def phase_generic_lap(torch, lap):
    """B's generic instance at every LAP_GENERIC width against its plain
    version and scipy: assignments equal on continuous costs, the optimal
    cost on tied ones (two widths); its time from CUDA graphs beside the
    plain version's (on the card's tensors), scipy's, the bound and the
    serial chain. Returns ({label: times}, the worst cost gap)."""
    from scipy.optimize import linear_sum_assignment

    times, worst = {}, 0.0
    cases = [(case, False) for case in LAP_GENERIC] + [(LAP_GENERIC[0], True),
                                                        (LAP_GENERIC[1], True)]
    for k, ((label, p, c, real, many), ties) in enumerate(cases):
        cost, mask, n_real = generic_lap_problems(90 + k, p, c, real, many, ties)
        ct, mt = torch.from_numpy(cost).to(DEVICE), torch.from_numpy(mask).to(DEVICE)
        before = lap.solve_lap_masked.generic_launches
        got = lap.solve_lap_masked(ct, mt).cpu().numpy()
        if lap.solve_lap_masked.generic_launches != before + 1:
            raise AssertionError(f"B at {c} columns did not launch its generic instance")
        t0 = time.perf_counter()
        plain = None if ties else lap.reference_solve_lap_masked(ct, mt).cpu().numpy()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        scipy_cols = [linear_sum_assignment(cm[m])[1] for cm, m in zip(cost, mask)]
        scipy_ms = 1e3 * (time.perf_counter() - t0)
        for i, (m, n) in enumerate(zip(mask, n_real)):
            if (got[i, ~m] != -1).any() or len(set(got[i, m].tolist())) != n:
                raise AssertionError(f"{c} columns, problem {i}: not an assignment")
            best = float(cost[i, m][np.arange(n), scipy_cols[i]].sum())
            err = abs(float(cost[i, m][np.arange(n), got[i, m]].sum()) - best)
            worst = max(worst, err)
            if not err <= 1e-4 * max(1.0, abs(best)):
                raise AssertionError(f"{c} columns, problem {i}: cost {err} above the optimum")
            if not ties and ((got[i, m] != scipy_cols[i]).any() or (got[i] != plain[i]).any()):
                raise AssertionError(f"{c} columns, problem {i}: assignment differs from "
                                     "plain/scipy")
        if ties:
            log(f"  lap {p}x{c}x{c} tied costs: optimal cost equal to scipy's on every problem")
            continue
        ms = graph_ms(torch, lambda: lap.solve_lap_masked(ct, mt), iters=5)
        chain = max(lap.augmenting_steps(ct.cpu(), mt.cpu()))
        bound = bound_ms(4 * c * int(n_real.sum()) + 5 * mask.size, {})
        scratch = lap.generic_scratch_bytes(p, c, c)
        times[label] = dict(ms=ms, plain_ms=plain_ms, scipy_ms=scipy_ms, bound=bound,
                            chain=chain, shape=(p, c, c))
        log(f"  lap {p}x{c}x{c} ({label}; generic instance, state "
            f"{'in device memory, ' + str(scratch) + ' B' if scratch else 'in shared memory'}), "
            f"n_real {n_real.min()}..{n_real.max()}: kernel {ms:.4f} ms from CUDA graphs, plain "
            f"(on the card's tensors) {plain_ms:.2f} ms, scipy host loop {scipy_ms:.2f} ms, "
            f"bound {bound[0]:.5f} ms ({bound[1]}); serial chain of the longest problem {chain} "
            f"Dijkstra steps ({1e3 * ms / chain if chain else 0:.2f} us a step at most); "
            f"assignments equal to plain and scipy")
    return times, worst


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it: model name, vendor, family
    and model number (a virtual machine may report the name as unknown)."""
    fields = {}
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        key, _, value = line.partition(":")
        fields.setdefault(key.strip(), value.strip())
    return (f"{fields.get('model name', 'no model name')} ({fields.get('vendor_id', '?')} family "
            f"{fields.get('cpu family', '?')} model {fields.get('model', '?')})")


def phase_jpeg_decode():
    """data/jpeg.py on every committed fixture: the SHA-256 of each array
    against expected.json; one thread's decode time at 640x480 4:2:0 and
    1333x800 4:2:0; the host CPU's model name."""
    import hashlib

    from detr_tensorflow_tpu_torch.data import jpeg

    expected = json.loads((JPEG_DIR / "expected.json").read_text())
    t0 = time.perf_counter()
    jpeg.get_lib()
    build_s = time.perf_counter() - t0
    for name, want in expected.items():
        image = jpeg.read_jpeg(str(JPEG_DIR / name))
        digest = hashlib.sha256(np.ascontiguousarray(image).tobytes()).hexdigest()
        if list(image.shape) != want["shape"] or digest != want["sha256"]:
            raise AssertionError(f"{name} ({want['encoded']}): decoded {image.shape} "
                                 f"{digest[:12]}, imageio gave {want['shape']} "
                                 f"{want['sha256'][:12]}")
    decode_ms = {}
    for name in JPEG_TIMED:
        data = (JPEG_DIR / name).read_bytes()
        jpeg.decode_jpeg(data)
        t0 = time.perf_counter()
        for _ in range(20):
            jpeg.decode_jpeg(data)
        decode_ms[name] = 1e3 * (time.perf_counter() - t0) / 20
    cpu = host_cpu()
    log(f"  data/jpeg.py (g++ build {build_s:.2f} s): {len(expected)} fixtures decoded, every "
        f"SHA-256 equal to imageio's in expected.json ("
        + ", ".join(f"{n}: {v['encoded']}" for n, v in expected.items())
        + f"); one thread's decode "
        + ", ".join(f"{n} {ms:.2f} ms" for n, ms in decode_ms.items())
        + f" (host CPU: {cpu}, {len(os.sched_getaffinity(0))} cores usable)")
    return decode_ms, cpu


def phase_jpeg(torch, fa, lap, mp, api, train):
    """The path from JPEG files at DETR-R50's full width, fp32: (a) the
    decoder on the fixtures; (b) a COCO set of JPEG_RATE_IMAGES JPEGs: the
    loader's images/s, ``train_coco.main`` for JPEG_STEPS steps, a
    loader-fed epoch's steps beside in-memory ones, ``eval.main`` at b1 over
    JPEG_EVAL_IMAGES; (c) ``finetune_voc.main`` and (d)
    ``finetune_hardhat.main`` for JPEG_FT_STEPS steps each; (e) B's generic
    instance at the LAP_GENERIC widths and a WIDE_QUERIES-query b8 step; (f)
    ``eval.main --masks --pq --panoptic_ann`` over JPEG_PAN_IMAGES JPEGs on
    a seeded DETR-R50 DETRsegm .pth. Counts reset just before each run and
    read just after."""
    import itertools
    import math
    import tempfile

    from detr_tensorflow_tpu_torch import eval as eval_main
    from detr_tensorflow_tpu_torch import finetune_hardhat, finetune_voc, train_coco
    from detr_tensorflow_tpu_torch.data import COCO_CLASS_NAME, load_coco_dataset
    from detr_tensorflow_tpu_torch.train.engine import batch_to_device

    launches = collections.Counter()
    out = {"launches": launches}
    names = {"A-tf32": "flash_attention_fwd_tf32", "A'-mma": "flash_attention_bwd_mma",
             "B": "lap", "C": "maxpool"}

    def main_path_counts(label, **runs):
        counts = read_counts(fa, lap, mp)
        expect_counts(label, counts, **runs)
        for key, name in names.items():
            launches[name] += counts[key]
        return counts

    out["decode_ms"], out["cpu"] = phase_jpeg_decode()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_jpeg_")
    root = tmp.name
    t0 = time.perf_counter()
    write_jpeg_sets(root, 23, JPEG_RATE_IMAGES, JPEG_EVAL_IMAGES, JPEG_FT_IMAGES)
    log(f"  JPEG sets from copies of {len(jpeg_sources())} fixtures: COCO {JPEG_RATE_IMAGES} "
        f"images with 1-20 boxes, VOC and hard-hat CSV {JPEG_FT_IMAGES} each, in "
        f"{time.perf_counter() - t0:.2f} s")

    # (b) COCO from JPEG files.
    coco = os.path.join(root, "coco")
    data = ["--data_dir", coco, "--img_dir", "images", "--device", DEVICE]
    fit_args = ["--batch_size", str(TRAIN_BATCH), "--target_batch", str(TRAIN_BATCH),
                "--image_size", *map(str, TRAIN_HW), "--evaluation_steps", "0"]
    reset_counts(fa, lap, mp)  # main path: training from JPEG files
    t0 = time.perf_counter()
    trainer = train_coco.main(data + ["--ann_file", "ann.json", "--epochs", str(JPEG_STEPS),
                                      "--steps_per_epoch", "1"] + fit_args)
    torch.cuda.synchronize()
    log(f"  train_coco.main on JPEG files: {trainer.steps} steps in "
        f"{time.perf_counter() - t0:.2f} s (model build included)")
    main_path_counts("train_coco.main (JPEG)", steps=JPEG_STEPS)
    config = trainer.config
    loader, _ = load_coco_dataset(config, TRAIN_BATCH, augmentation=True, seed=1)
    t0, n = time.perf_counter(), 0
    for batch in loader:
        n += len(batch["images"])
    rate = n / (time.perf_counter() - t0)
    log(f"  loader alone ({loader.num_workers} threads, JPEG decode, augmentation, "
        f"normalization, b{TRAIN_BATCH} {TRAIN_HW[0]}x{TRAIN_HW[1]}): {n} images in one epoch, "
        f"{rate:.1f} images/s")

    def step_times(batches):
        marks = [time.perf_counter()]
        train.fit(trainer, batches, config, epoch_nb=0, log_every=1,
                  log_fn=lambda host_log, step: marks.append(time.perf_counter()))
        return [1e3 * (b - a) for a, b in zip(marks, marks[1:])]

    ahead = loader.prefetch + 1 + 2  # the HostDataset queue, its producer's, prefetch's two
    reset_counts(fa, lap, mp)  # main path: a loader-fed epoch, then in-memory steps
    fed = step_times(loader)
    in_memory = step_times([next(iter(loader))] * len(fed))
    torch.cuda.synchronize()
    main_path_counts("fit over the JPEG loader and in memory", steps=2 * len(fed))
    out["rate"], out["fed_ms"] = rate, statistics.median(fed)
    out["steady_ms"], out["memory_ms"] = statistics.median(fed[ahead:]), statistics.median(in_memory)
    log(f"  fp32 step fed by the JPEG loader over one epoch of {len(fed)} steps: "
        f"{[round(x, 2) for x in fed]} ms, median {out['fed_ms']:.2f}, {out['steady_ms']:.2f} "
        f"over steps {ahead}-{len(fed) - 1}; fed one in-memory batch: median "
        f"{out['memory_ms']:.2f} over {len(in_memory)} steps")
    del trainer, loader
    torch.cuda.empty_cache()
    reset_counts(fa, lap, mp)  # main path: evaluation from JPEG files
    t0 = time.perf_counter()
    table = eval_main.main(data + ["--ann_file", "ann_eval.json", "--batch", "1"])
    torch.cuda.synchronize()
    out["eval_images_s"] = JPEG_EVAL_IMAGES / (time.perf_counter() - t0)
    main_path_counts("eval.main --batch 1 (JPEG)", forwards=JPEG_EVAL_IMAGES)
    if "box" not in table:
        raise AssertionError(f"eval on JPEG files: no box AP in {set(table)}")
    log(f"  eval.main --batch 1 over {JPEG_EVAL_IMAGES} JPEG images: "
        f"{out['eval_images_s']:.2f} images/s (model build included), box AP "
        f"{dict(table['box'])}")
    torch.cuda.empty_cache()

    # (c) VOC and (d) hard-hat CSV: JPEG_FT_STEPS steps of each finetuning
    # recipe's epoch 0 (heads only: A' not launched), no validation pass.
    ft_args = fit_args + ["--epochs", "1", "--steps_per_epoch", str(JPEG_FT_STEPS)]
    for label, entry, argv in (
            ("finetune_voc.main", finetune_voc, [
                "--data_dir", os.path.join(root, "voc"), "--img_dir", "JPEGImages",
                "--ann_dir", "Annotations"]),
            ("finetune_hardhat.main", finetune_hardhat, [
                "--data_dir", os.path.join(root, "hardhat"), "--img_dir", "train",
                "--ann_file", "train/_annotations.csv"])):
        reset_counts(fa, lap, mp)  # main path: a finetuning recipe on JPEG files
        t0 = time.perf_counter()
        trainer = entry.main(argv + ["--device", DEVICE] + ft_args)
        torch.cuda.synchronize()
        counts = read_counts(fa, lap, mp)
        want = {k: 0 for k in counts}
        want.update({"A-tf32": JPEG_FT_STEPS * LAUNCHES_PER_FORWARD, "B": JPEG_FT_STEPS,
                     "C": JPEG_FT_STEPS})
        classes = trainer.model.cls_layer.weight.shape[0]
        if counts != want or trainer.steps != JPEG_FT_STEPS or (
                entry is finetune_hardhat and classes != len(HARDHAT_CLASSES)):
            raise AssertionError(f"{label}: {trainer.steps} steps, {classes} classes, "
                                 f"launches {counts} (expected {want})")
        for key, name in names.items():
            launches[name] += counts[key]
        log(f"  {label} on JPEG files: {trainer.steps} heads-only steps at b{TRAIN_BATCH} "
            f"{TRAIN_HW[0]}x{TRAIN_HW[1]} in {time.perf_counter() - t0:.2f} s (model build "
            f"included), {classes} classes, launches {counts}")
        del trainer
        torch.cuda.empty_cache()

    # (e) B's generic instance, and a WIDE_QUERIES-query step of DETR-R50.
    out["lap"], out["lap_err"] = phase_generic_lap(torch, lap)
    config = train.TrainingConfig(image_size=TRAIN_HW, num_queries=WIDE_QUERIES,
                                  batch_size=TRAIN_BATCH, target_batch=None, train_backbone=True,
                                  train_transformers=True, train_nlayers=True,
                                  background_class=BACKGROUND)
    batch = batch_to_device(train_batch(31, slots=WIDE_QUERIES), DEVICE)
    trainer = train.Trainer(api.build_detr(device=DEVICE, num_queries=WIDE_QUERIES).module,
                            config, seed=0)
    trainer.step(batch)  # cuDNN plans
    reset_counts(fa, lap, mp)  # main path: the 300-query step
    loss = float(trainer.step(batch)["total_loss"])
    torch.cuda.synchronize()
    generic = lap.solve_lap_masked.generic_launches
    main_path_counts(f"the {WIDE_QUERIES}-query step", steps=1)
    launches["lap"] -= generic  # B's launch in that step was its generic instance's
    launches["lap_generic"] += generic
    if generic != 1 or not math.isfinite(loss):
        raise AssertionError(f"{WIDE_QUERIES}-query step: B's generic instance {generic}, "
                             f"loss {loss}")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    trainer.step(batch)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    wall, busy, events = device_busy_ms(torch, lambda: trainer.step(batch), calls=2)
    _, lap_ms = kernel_ms(torch, lambda: trainer.step(batch), ["lap_kernel_generic"])
    out["wide_step"] = dict(wall=wall, busy=busy, peak=peak, lap_ms=lap_ms["lap_kernel_generic"])
    log(f"  {WIDE_QUERIES}-query DETR-R50 step (every group training, fp32, dropout {DROPOUT}) "
        f"b{TRAIN_BATCH} {TRAIN_HW[0]}x{TRAIN_HW[1]}, {WIDE_QUERIES} target slots: loss "
        f"{loss:.4f}, B on its generic instance once; under torch.profiler wall {wall:.2f} ms, "
        f"device busy {busy:.2f} ms, {events:.0f} kernels and copies; B's kernel "
        f"{lap_ms['lap_kernel_generic']:.4f} ms of it; peak memory of a step above the memory "
        f"held before it {peak:.2f} GiB")
    del trainer, batch
    torch.cuda.empty_cache()

    # (f) eval --masks --pq --panoptic_ann over JPEG images.
    things = [i for i, name in enumerate(COCO_CLASS_NAME[:91]) if name != "N/A"]
    sources = jpeg_sources()[:JPEG_PAN_IMAGES]
    pan = os.path.join(root, "panoptic")
    ann = write_panoptic_set(pan, [hw for _, hw in sources], 64, things, PAN_STUFF,
                             jpegs=[str(src) for src, _ in sources])
    path = os.path.join(root, "detr-r50-panoptic.pth")
    torch.save({"model": segmentation_state_dict(seed=62, num_classes=PAN_CLASSES)}, path)
    reset_counts(fa, lap, mp)  # main path: panoptic evaluation from JPEG files
    t0 = time.perf_counter()
    table = eval_main.main(["--data_dir", pan, "--img_dir", "images", "--ann_file",
                            "panoptic.json", "--device", DEVICE, "--weights", path,
                            "--panoptic_ann", ann, "--panoptic_png_dir",
                            os.path.join(pan, "panoptic"), "--masks", "--pq"],
                           num_classes=PAN_CLASSES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_path_counts("eval.main --masks --pq --panoptic_ann (JPEG)", forwards=JPEG_PAN_IMAGES)
    pq = table.get("pq", {})
    if set(table) != {"box", "mask", "pq"} or not 0.0 <= pq.get("pq", -1.0) <= 1.0:
        raise AssertionError(f"eval --pq on JPEG files: table keys {set(table)}")
    out["pan_images_s"] = JPEG_PAN_IMAGES / wall
    log(f"  eval.main --masks --pq --panoptic_ann over {JPEG_PAN_IMAGES} JPEG images "
        f"({[hw for _, hw in sources]}) with PNG segment maps: {out['pan_images_s']:.2f} "
        f"images/s (the model's build from the .pth included), PQ {100 * pq['pq']:.2f} over "
        f"{pq['n_classes']} classes (random weights)")
    tmp.cleanup()
    torch.cuda.empty_cache()
    return out


# Phase 16, serving artifacts: each model's artifact (export.export_predictor)
# against the live Predictor on the same requests. ART_SERVE's bucket is
# 896x1408 at divisor 128; the fused models also serve ART_EXACT, which fills
# its bucket (the unmasked program, kernel E's route). One process a model
# (and a fused model's two buckets apart): tracing a program is host work
# of ~10 s, so the models export and load at once, on the host's cores; then
# they take turns to time a request on a quiet card.
ART_SERVE, ART_EXACT = (800, 1333), (768, 1280)
ART_BATCHES = (1, 8)  # the programs are traced at batch 2
_FUSED = dict(fuse_residual=True, fuse_bottleneck=True)
# name: the checkpoint ("detector", "segm"; None: seeded weights), the build
# flags, the request size and its launches per request (one forward at any
# batch; PERF.md section 6, Launches), and whether the artifact is exported
# on the CPU.
def _art(weights, flags, size, launches, cpu=False):
    return {"weights": weights, "flags": flags, "size": size, "launches": launches, "cpu": cpu}


ART_VARIANTS = {
    "fp32": _art("detector", {}, ART_SERVE, {"A-tf32": 18, "C": 1}),
    "bf16": _art("detector", dict(dtype="bfloat16"), ART_SERVE, {"A-mma": 18, "C": 1}),
    "int8": _art("detector", dict(dtype="bfloat16", backbone_quant=True), ART_SERVE,
                 {"A-mma": 18, "F": 32, "G": 16}),
    "fused fp32 exact": _art("detector", _FUSED, ART_EXACT,
                             {"A-tf32": 18, "C": 1, "D-tf32": 4, "E-tf32": 12}),
    "fused fp32 masked": _art("detector", _FUSED, ART_SERVE, {"A-tf32": 18, "C": 1, "D-tf32": 16}),
    "fused bf16 exact": _art("detector", dict(dtype="bfloat16", **_FUSED), ART_EXACT,
                             {"A-mma": 18, "C": 1, "D-mma": 4, "E-mma": 12}),
    "fused bf16 masked": _art("detector", dict(dtype="bfloat16", **_FUSED), ART_SERVE,
                              {"A-mma": 18, "C": 1, "D-mma": 16}),
    "masks fp32": _art("segm", dict(masks=True), ART_SERVE, {"A-tf32": 18, "C": 1}),
    # A reduced model (one encoder and one decoder layer: 3 attention calls)
    # exported on the CPU, loaded onto the card.
    "reduced, CPU export": _art(None, dict(backbone_stage_sizes=(1, 1, 1, 1), num_encoder_layers=1,
                                           num_decoder_layers=1), (480, 640),
                                {"A-tf32": 3, "C": 1}, cpu=True),
}
ART_SCORE_ATOL = 1e-3  # the golden tolerance of scores (tests/test_torch_serving.py)
ART_MASK_TOL = 1e-4  # share of mask pixels that may differ from the live Predictor's
ART_TIMEOUT_S = 900
# b1 requests a side, the artifact's and the live Predictor's interleaved,
# for the printed p50: a smoke reading. scripts/torch_dtype_cost_probe.py
# compares the two over hundreds of requests.
ART_REQUESTS = 30
# The kernel records these counters add to.
ART_RECORDS = {"A-tf32": "flash_attention_fwd_tf32", "A-mma": "flash_attention_fwd_mma",
               "C": "maxpool", "D-tf32": "fused_residual_tf32", "D-mma": "fused_residual_mma",
               "E-tf32": "fused_bottleneck_tf32", "E-mma": "fused_bottleneck_mma",
               "F": "int8_matmul", "G": "int8_conv"}


def serving_counts(fa, mp, fr, fb, mm, conv) -> dict:
    """Every serving kernel's launch counter, the SIMT ones on no path too."""
    d, e = fr.conv1x1_bn_residual_relu, fb.fused_bottleneck
    return {"A-tf32": fa.mha.tf32_launches, "A-mma": fa.mha.mma_launches,
            "A SIMT": fa.mha.launches, "C": mp.max_pool_3x3_s2.launches,
            "D-tf32": d.tf32_launches, "D-mma": d.mma_launches, "D SIMT": d.launches,
            "E-tf32": e.tf32_launches, "E-mma": e.mma_launches, "E SIMT": e.launches,
            "F": mm.qmatmul.launches + mm.qmatmul_residual.launches
            + mm.qmatmul_residual2.launches, "G": sum(conv.conv3x3_int8.launches.values())}


def reset_serving_counts(fa, mp, fr, fb, mm, conv) -> None:
    d, e = fr.conv1x1_bn_residual_relu, fb.fused_bottleneck
    fa.mha.tf32_launches = fa.mha.mma_launches = fa.mha.launches = 0
    mp.max_pool_3x3_s2.launches = d.tf32_launches = d.mma_launches = d.launches = 0
    e.tf32_launches = e.mma_launches = e.launches = 0
    mm.qmatmul.launches = mm.qmatmul_residual.launches = mm.qmatmul_residual2.launches = 0
    conv.conv3x3_int8.launches = {s: 0 for s in conv.conv3x3_int8.launches}


def detection_gaps(ours, ref) -> dict:
    """Largest gaps of one request's detections from another's: boxes and
    scores (inf where the kept detections differ in number or label), and
    the share of mask pixels that differ."""
    gaps = {"boxes": 0.0, "scores": 0.0, "masks": 0.0}
    for a, b in zip(ours, ref, strict=True):
        if len(a.labels) != len(b.labels) or (a.labels != b.labels).any():
            return {k: float("inf") for k in gaps}
        if len(a.labels):
            gaps["boxes"] = max(gaps["boxes"], float(np.abs(a.boxes - b.boxes).max()))
            gaps["scores"] = max(gaps["scores"], float(np.abs(a.scores - b.scores).max()))
        if a.masks is not None and a.masks.size:
            gaps["masks"] = max(gaps["masks"], float((a.masks != b.masks).mean()))
    return gaps


def check_gaps(say, label, gaps) -> None:
    say(f"  {label}: artifact against the live Predictor, largest gaps boxes "
        f"{gaps['boxes']:.3e} (tol {BOX_ATOL}), scores {gaps['scores']:.3e} (tol "
        f"{ART_SCORE_ATOL}), mask pixels {gaps['masks']:.2e} (tol {ART_MASK_TOL})")
    if not (gaps["boxes"] <= BOX_ATOL and gaps["scores"] <= ART_SCORE_ATOL
            and gaps["masks"] <= ART_MASK_TOL):
        raise AssertionError(f"{label}: the artifact's detections differ from the live "
                             f"Predictor's: {gaps}")


def artifact_variant(name, spec, files, turn) -> dict:
    """One model of phase 16, in a process of its own: built, warmed,
    exported, loaded and served beside its live Predictor, every request
    with the counters reset just before it and read just after; then, in
    ``turn`` (a context that holds the card for this process alone), the
    p50 (and p10-p90) of ART_REQUESTS b1 requests and the device-busy time
    of a b1 request, from the artifact and from the live Predictor. Returns
    the log lines, the launches and the readings."""
    import tempfile

    import torch

    from detr_tensorflow_tpu_torch import export
    from detr_tensorflow_tpu_torch.models import api, quantized
    from detr_tensorflow_tpu_torch.ops import flash_attention as fa
    from detr_tensorflow_tpu_torch.ops import fused_bottleneck as fb
    from detr_tensorflow_tpu_torch.ops import fused_residual as fr
    from detr_tensorflow_tpu_torch.ops import int8_conv as conv
    from detr_tensorflow_tpu_torch.ops import int8_matmul as mm
    from detr_tensorflow_tpu_torch.ops import maxpool as mp
    from detr_tensorflow_tpu_torch.predictor import Predictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flags, size, cpu_export = spec["flags"], spec["size"], spec["cpu"]
    lines, launches, counters = [], collections.Counter(), (fa, mp, fr, fb, mm, conv)
    say = lines.append
    t0 = time.perf_counter()
    model = api.build_detr(weights=files.get(spec["weights"]), seed=66,
                           device="cpu" if cpu_export else DEVICE, **flags)
    if "fuse_bottleneck" in flags:
        seeded_frozen_bn(torch, model.module, seed=64)
    live = Predictor(model, background_class=BACKGROUND, masks=bool(flags.get("masks")))
    if flags.get("backbone_quant"):
        with torch.inference_mode():
            calib = live.normalize(torch.from_numpy(
                np.stack(random_images([size] * 2, seed=11))).to(DEVICE))
        quantized.quantize_model(model, calib)
    live.warmup([size])
    build_s = time.perf_counter() - t0
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_artifact_", dir=files["dir"])
    t0 = time.perf_counter()
    export.export_predictor(live, tmp.name, [size])
    export_s = time.perf_counter() - t0
    programs = sum(f.endswith(".pt2") for f in os.listdir(tmp.name))
    mb = sum(os.path.getsize(os.path.join(tmp.name, f)) for f in os.listdir(tmp.name)) / 2**20
    weights_mb = os.path.getsize(os.path.join(tmp.name, "weights.pt")) / 2**20
    t0 = time.perf_counter()
    loaded = export.load_predictor(tmp.name, device=DEVICE)
    load_s = time.perf_counter() - t0
    loaded.warmup([size])

    def request(pred, images):
        reset_serving_counts(*counters)
        dets = pred(images)
        got = {k: v for k, v in serving_counts(*counters).items() if v}
        launches.update({ART_RECORDS[k]: v for k, v in got.items()})
        check_detections(dets)
        return dets, got

    want = spec["launches"]
    for b in ART_BATCHES if name == "fp32" else ART_BATCHES[:1]:
        images = random_images([size] * b, seed=63 + b)
        art_dets, art_n = request(loaded, images)
        if cpu_export:  # the live Predictor runs on the CPU, whose plain versions count nothing
            live_dets, live_n = live(images), art_n
        else:
            live_dets, live_n = request(live, images)
        # One request of a bucket is one forward, whatever its batch.
        label = f"{name} {size[0]}x{size[1]} b{b}" + (" (traced at b2)" if b > 1 else "")
        say(f"  {label} launches: live {live_n}, artifact {art_n} (expected {want})")
        if not live_n == art_n == want:
            raise AssertionError(f"{label}: launches live {live_n}, artifact {art_n}, "
                                 f"expected {want}")
        check_gaps(say, label, detection_gaps(art_dets, live_dets))
    rec = {"export_s": export_s, "programs": programs, "load_s": load_s, "mb": mb,
           "weights_mb": weights_mb}
    img = random_images([size], seed=70)
    preds = {"artifact": loaded} if cpu_export else {"live": live, "artifact": loaded}
    with turn:
        lat = {k: [] for k in preds}
        for i in range(ART_REQUESTS):  # interleaved, each first in turn
            for key in (list(preds) if i % 2 == 0 else list(preds)[::-1]):
                t0 = time.perf_counter()
                preds[key](img)
                lat[key].append(1e3 * (time.perf_counter() - t0))
        for key, pred in preds.items():
            deciles = statistics.quantiles(lat[key], n=10)
            rec[key + "_p50"], rec[key + "_p10"], rec[key + "_p90"] = \
                statistics.median(lat[key]), deciles[0], deciles[-1]
            rec[key + "_wall"], rec[key + "_busy"], _ = device_busy_ms(torch, lambda: pred(img))
    reading = {k: f"p50 {rec[k + '_p50']:.2f} ms (p10-p90 {rec[k + '_p10']:.2f}-"
                  f"{rec[k + '_p90']:.2f}), device busy under torch.profiler "
                  + ("not measured" if rec[k + "_busy"] is None else f"{rec[k + '_busy']:.2f} ms")
               for k in preds}
    say(f"  {name}: built and warmed in {build_s:.2f} s; {programs} program(s) exported in "
        f"{export_s:.2f} s ({export_s / programs:.2f} s each), artifact {mb:.1f} MB "
        f"({weights_mb:.1f} MB of weights, once), loaded in {load_s:.2f} s; {size[0]}x"
        f"{size[1]} b1 over {ART_REQUESTS} requests a side: artifact {reading['artifact']}; "
        f"live {reading.get('live', 'not run (a CPU model)')}")
    tmp.cleanup()
    return {"log": lines, "launches": dict(launches), "rec": rec}


def _artifact_worker(name, spec, files, barrier, lock, results):
    """Process target: ``artifact_variant`` with the card held in turns
    once every process is ready (``barrier``), its result or its
    traceback on ``results``."""
    import contextlib
    import traceback

    @contextlib.contextmanager
    def turn():
        barrier.wait(timeout=ART_TIMEOUT_S)
        with lock:
            yield

    try:
        results.put((name, artifact_variant(name, spec, files, turn())))
    except Exception:  # the process's boundary: reported to the parent, which raises
        barrier.abort()
        results.put((name, {"error": traceback.format_exc()}))


def phase_artifacts(torch) -> dict:
    """Serving artifacts: full-width DETR-R50 from a seeded facebook-named
    .pth (fp32, bf16, int8, fused fp32 and bf16, with masks at fp32) and a
    reduced model exported on the CPU, each in a process of its own
    (``artifact_variant``); raises if any of them fails."""
    import multiprocessing
    import queue
    import tempfile

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_artifacts_")
    files = {"dir": tmp.name}
    checkpoints = {spec["weights"] for spec in ART_VARIANTS.values()}
    for key, state in (("detector", lambda: facebook_state_dict(seed=61)),
                       ("segm", lambda: segmentation_state_dict(seed=62))):
        if key in checkpoints:
            files[key] = os.path.join(tmp.name, key + ".pth")
            torch.save({"model": state()}, files[key])
    ctx = multiprocessing.get_context("spawn")
    barrier, lock, results = ctx.Barrier(len(ART_VARIANTS)), ctx.Lock(), ctx.Queue()
    procs = [ctx.Process(target=_artifact_worker, daemon=True, args=(
        name, spec, files, barrier, lock, results)) for name, spec in ART_VARIANTS.items()]
    for proc in procs:
        proc.start()
    out, errors = {}, {}
    try:
        deadline = time.perf_counter() + ART_TIMEOUT_S
        while len(out) + len(errors) < len(procs):
            try:
                name, res = results.get(timeout=5)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead or time.perf_counter() > deadline:
                    barrier.abort()
                    raise AssertionError(f"phase 16: {len(dead)} process(es) died, "
                                         f"{len(out)} of {len(procs)} reported")
                continue
            (errors if "error" in res else out)[name] = res
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.terminate()
                proc.join()
        tmp.cleanup()
    if errors:
        raise AssertionError("phase 16 failed:\n" + "\n".join(
            f"[{name}]\n{res['error']}" for name, res in errors.items()))
    launches = collections.Counter()
    for name in ART_VARIANTS:
        for line in out[name]["log"]:
            log(line)
        launches.update(out[name]["launches"])
    return {"launches": launches, "models": {n: out[n]["rec"] for n in ART_VARIANTS}}


# Phase 17, parallelism across processes: two ranks sharing the one card over
# Gloo (NCCL refuses two ranks on one device; Gloo all-reduces CUDA tensors
# through host memory), DETR-R50 at full width, fp32 with TF32 off. (a) DDP:
# b8 376x672 as 2 x b4, the loss and the parameters after PAR_STEPS steps at
# dropout 0 against the one-process b8 Trainer, then PAR_DROPOUT_STEPS steps at
# dropout 0.1 with the parameters bit-equal across the ranks after each; (b)
# NCCL at world size 1 in this process; (c) Megatron tensor parallelism, the
# transformer split 4 + 4 heads, b2, the forward and every gradient at dropout
# 0 against the unsplit model. Every wait on a rank is bounded by
# PAR_TIMEOUT_S; a failure in a rank raises here.
PAR_WORLD, PAR_STEPS, PAR_DROPOUT_STEPS, PAR_TP_BATCH = 2, 2, 4, 2
PAR_TIMEOUT_S = 300
PAR_TRAIN_SEED, PAR_TP_SEED = 5, 7


def _par_config(train):
    return train.TrainingConfig(background_class=BACKGROUND, train_backbone=True,
                                train_transformers=True, batch_size=TRAIN_BATCH)


def _cpu_state(tensors):
    return {n: t.detach().float().cpu().clone() for n, t in tensors}


def _first_grads(trainer, into: dict) -> None:
    """Copy the gradients of ``trainer``'s next step into ``into`` as the
    optimizer finds them (the global batch's, before the per-tensor clip)."""
    step = trainer.optimizer.step

    def snapshot(lrs):
        if not into:
            into.update(_cpu_state((n, p.grad) for n, p in trainer.model.named_parameters()))
        return step(lrs)

    trainer.optimizer.step = snapshot


def parallel_rank(rank, tmp, results):
    """Process target: one of PAR_WORLD ranks on the card (phase 17). Puts
    its numbers on ``results`` (or its traceback); rank 0 writes its
    gradients and parameters to ``tmp``."""
    import traceback

    import torch

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        import torch.distributed as dist

        from detr_tensorflow_tpu_torch import train
        from detr_tensorflow_tpu_torch.models import api
        from detr_tensorflow_tpu_torch.ops import flash_attention as fa, lap, losses, maxpool
        from detr_tensorflow_tpu_torch.parallel import make_mesh, multihost, shard_batch, tp
        from detr_tensorflow_tpu_torch.train.engine import batch_to_device

        multihost.initialize(init_method=f"file://{tmp}/rendezvous", num_processes=PAR_WORLD,
                             process_id=rank, backend="gloo", device=DEVICE,
                             timeout_s=PAR_TIMEOUT_S)
        out = {"rank": rank}
        config = _par_config(train)
        batch = train_batch(PAR_TRAIN_SEED)
        mesh = make_mesh(PAR_WORLD)
        local = batch_to_device(shard_batch(batch, mesh), DEVICE)
        out["boxes"] = int(local["mask"].sum())

        # (a) DDP at dropout 0: the main path, its launches counted.
        model = api.build_detr(seed=0, device=DEVICE, dropout=0.0).module
        trainer = train.Trainer(model, config, seed=0, mesh=mesh)
        first = {}
        _first_grads(trainer, first)
        reset_counts(fa, lap, maxpool)
        losses_seen = [float(trainer.step(local)["total_loss"]) for _ in range(PAR_STEPS)]
        torch.cuda.synchronize()
        if rank == 0:
            torch.save(first, os.path.join(tmp, "grads.pt"))
        out["counts"] = read_counts(fa, lap, maxpool)
        out["losses"] = losses_seen
        if rank == 0:
            torch.save(_cpu_state(model.named_parameters()), os.path.join(tmp, "params.pt"))
        grad_bytes = sum(4 * p.numel() for p in trainer.optimizer.params)
        del trainer, model
        torch.cuda.empty_cache()

        # (a) at dropout 0.1: bit-equal parameters across the ranks after
        # each step; each rank's step wall; the all-reduce under the profiler.
        model = api.build_detr(seed=0, device=DEVICE).module
        trainer = train.Trainer(model, config, seed=0, mesh=mesh)
        params = list(model.parameters())
        walls, equal = [], []
        for _ in range(PAR_DROPOUT_STEPS):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.step(local)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            mine = torch.cat([p.detach().reshape(-1) for p in params])
            theirs = mine.clone()
            dist.broadcast(theirs, src=0)
            same = torch.tensor([int(torch.equal(mine, theirs))], device=DEVICE)
            dist.all_reduce(same, op=dist.ReduceOp.MIN)
            equal.append(bool(same.item()))
        out["walls"], out["equal"] = walls, equal
        from torch.profiler import ProfilerActivity, profile

        dist.barrier()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.step(local)
            torch.cuda.synchronize()
        # Gloo runs the all-reduce on its own threads, which the profiler
        # does not time: it sees DDP's calls (their host time) and Gloo's
        # copies of the CUDA buckets through host memory (device time).
        events = prof.key_averages()
        out["allreduce_calls_ms"] = sum(e.cpu_time_total for e in events
                                        if "allreduce" in e.key) / 1e3
        out["memcpy_ms"] = sum(getattr(e, "device_time_total", 0.0) for e in events
                               if e.key.startswith("Memcpy")) / 1e3
        flat = torch.zeros(grad_bytes // 4, device=DEVICE)
        alone = []
        for _ in range(3):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(flat)
            torch.cuda.synchronize()
            alone.append(1e3 * (time.perf_counter() - t0))
        out["allreduce_alone_ms"], out["grad_bytes"] = statistics.median(alone), grad_bytes
        del trainer, model, params, flat, mine, theirs
        torch.cuda.empty_cache()

        # (c) tensor parallelism: the unsplit model's forward and gradients,
        # then the split one's (H = 4 a rank), gathered whole.
        tmesh = make_mesh(PAR_WORLD, ("data", "model"), (1, PAR_WORLD))
        tbatch = batch_to_device({k: v[:PAR_TP_BATCH] for k, v in
                                  train_batch(PAR_TP_SEED).items()}, DEVICE)
        targets = [tbatch[k] for k in ("boxes", "classes", "mask")]
        results_tp = []
        for split in (False, True):
            model = api.build_detr(seed=0, device=DEVICE, dropout=0.0).module
            if split:
                trainer = train.Trainer(model, config, seed=0, mesh=tmesh)
                heads = {m.num_heads // m.tp.size for m in model.modules() if hasattr(m, "tp")
                         and hasattr(m, "q_proj")}
                reset_counts(fa, lap, maxpool)
            outputs = model(tbatch["images"], train=True)
            if split:
                torch.cuda.synchronize()
                out["tp_counts"], out["tp_heads"] = read_counts(fa, lap, maxpool), sorted(heads)
            total, _ = losses.detr_loss(outputs, *targets, BACKGROUND)
            total.backward()
            if split:
                torch.cuda.synchronize()
                out["tp_step_counts"] = read_counts(fa, lap, maxpool)
            mg = trainer.model_group if split else None
            grads = {n: p.grad if mg is None or tp.split_dim(n, p.dim()) is None
                     else tp.gather_tensor(p.grad, tp.split_dim(n, p.dim()), mg)
                     for n, p in model.named_parameters()}
            results_tp.append((float(total.detach()), {k: v.detach() for k, v in outputs.items()},
                               {n: g.detach().float().cpu() for n, g in grads.items()}))
            del model, outputs, total, grads
            if split:
                del trainer
            torch.cuda.empty_cache()
        (loss_ref, out_ref, grads_ref), (loss_tp, out_tp, grads_tp) = results_tp
        out["tp_loss"] = (loss_tp, loss_ref)
        out["tp_out_err"] = {k: float((out_tp[k] - out_ref[k]).abs().max()) for k in out_ref
                             if out_ref[k].numel()}
        out["tp_grads"] = gradient_agreement(grads_tp, grads_ref)
        multihost.shutdown()
        results.put(out)
    except Exception:  # the process's boundary: reported to the parent, which raises
        results.put({"rank": rank, "error": traceback.format_exc()})


def phase_parallel(torch, fa, lap, mp, api, train, losses):
    """Phase 17: (b) NCCL at world size 1 here, the one-process reference
    steps and step walls, then (a) and (c) in PAR_WORLD rank processes on
    the card. Returns the numbers it printed and the ranks' launches."""
    import multiprocessing
    import queue
    import tempfile

    from detr_tensorflow_tpu_torch.parallel import make_mesh, multihost
    from detr_tensorflow_tpu_torch.train.engine import batch_to_device

    config = _par_config(train)
    batch = batch_to_device(train_batch(PAR_TRAIN_SEED), DEVICE)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_")
    res = {}

    # (b) NCCL at world size 1: DDP over a one-rank NCCL group, one step.
    steps = []
    for nccl in (False, True):
        mesh = None
        if nccl:
            multihost.initialize(init_method=f"file://{tmp.name}/nccl", num_processes=1,
                                 process_id=0, backend="nccl", timeout_s=PAR_TIMEOUT_S)
            mesh = make_mesh(1)
        model = api.build_detr(seed=0, device=DEVICE, dropout=0.0).module
        trainer = train.Trainer(model, config, seed=0, mesh=mesh)
        loss = float(trainer.step(batch)["total_loss"])
        steps.append((loss, trainer.ddp is not None,
                      [p.detach().clone() for p in model.parameters()]))
        del trainer, model
        if nccl:
            multihost.shutdown()
    (loss_p, _, params_p), (loss_n, wrapped, params_n) = steps
    res["nccl_err"] = max(float((a - b).abs().max()) for a, b in zip(params_n, params_p))
    log(f"  (b) NCCL at world size 1: Trainer(mesh=make_mesh(1)) wraps DDP over the NCCL group: "
        f"{wrapped}; its step against the plain Trainer's: loss {loss_n:.6f} / {loss_p:.6f}, "
        f"largest parameter difference after the step {res['nccl_err']:.3e}")
    if not wrapped or abs(loss_n - loss_p) > LOSS_RTOL * abs(loss_p):
        raise AssertionError("NCCL world-1 step: no DDP wrapper, or its loss disagrees")
    del steps, params_p, params_n
    torch.cuda.empty_cache()

    # The one-process b8 reference of (a): PAR_STEPS steps at dropout 0.
    model = api.build_detr(seed=0, device=DEVICE, dropout=0.0).module
    start = _cpu_state(model.named_parameters())
    trainer = train.Trainer(model, config, seed=0)
    ref_grads = {}
    _first_grads(trainer, ref_grads)
    ref_losses = [float(trainer.step(batch)["total_loss"]) for _ in range(PAR_STEPS)]
    ref_params = _cpu_state(model.named_parameters())
    lrs = {n: trainer._lrs[g] for n, g in train.optimizers.param_labels(model).items()}
    del trainer, model
    # One process's step walls at dropout 0.1, b8 and b4, beside the ranks'.
    trainer = train.Trainer(api.build_detr(seed=0, device=DEVICE).module, config, seed=0)
    single = {}
    for b in (TRAIN_BATCH, TRAIN_BATCH // PAR_WORLD):
        part, walls = {k: v[:b] for k, v in batch.items()}, []
        for _ in range(PAR_DROPOUT_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.step(part)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
        single[b] = statistics.median(walls[1:])
    del trainer, batch
    torch.cuda.empty_cache()

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=parallel_rank, daemon=True, args=(r, tmp.name, results))
             for r in range(PAR_WORLD)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    ranks = {}
    try:
        deadline = time.perf_counter() + PAR_TIMEOUT_S
        while len(ranks) < PAR_WORLD:
            try:
                got = results.get(timeout=5)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead or time.perf_counter() > deadline:
                    raise AssertionError(f"phase 17: {len(dead)} rank(s) died, {len(ranks)} of "
                                         f"{PAR_WORLD} reported in {time.perf_counter() - t0:.0f} s")
                continue
            if "error" in got:
                raise AssertionError(f"phase 17, rank {got['rank']}:\n{got['error']}")
            ranks[got["rank"]] = got
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.terminate()
                proc.join()
    res["ranks_s"] = time.perf_counter() - t0
    r0, r1 = ranks[0], ranks[1]

    # (a) against the one-process reference.
    grads = torch.load(os.path.join(tmp.name, "grads.pt"))
    params = torch.load(os.path.join(tmp.name, "params.pt"))
    tmp.cleanup()
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref_losses))
    worst, noise = gradient_agreement(grads, ref_grads)
    envelope = max(float((params[n] - ref_params[n]).abs().max()) / (2 * PAR_STEPS * lrs[n])
                   for n in ref_params)
    moved = {n: _rel_norm(params[n] - start[n], ref_params[n] - start[n]) for n in ref_params
             if n not in noise}
    log(f"  (a) DDP, 2 ranks on one card over Gloo, b{TRAIN_BATCH} as 2 x b{TRAIN_BATCH // 2} "
        f"({r0['boxes']} and {r1['boxes']} real boxes): losses {r0['losses']} (rank 1 "
        f"{r1['losses']}) against one process's {ref_losses}, worst rel {loss_err:.2e} (tol "
        f"{LOSS_RTOL}); first step's gradients: worst rel err {worst[0]:.2e} ({worst[1]}, tol "
        f"{TENSOR_GRAD_RTOL}), {len(noise)} tensors within the noise floor; parameters after "
        f"{PAR_STEPS} Adam steps: largest difference {envelope:.3f} of 2 x {PAR_STEPS} x lr "
        f"(Adam moves an element at most ~lr a step), update rel err median "
        f"{statistics.median(moved.values()):.2e}, worst {max(moved.values()):.2e}")
    if r0["boxes"] == r1["boxes"]:
        raise AssertionError("phase 17 wants uneven box counts across the ranks")
    if r0["losses"] != r1["losses"] or not loss_err <= LOSS_RTOL or not envelope <= 1.0:
        raise AssertionError("DDP steps disagree with the one-process steps")
    per_step = {"A-tf32": LAUNCHES_PER_FORWARD, "A'-mma": LAUNCHES_PER_FORWARD, "B": 1, "C": 1}
    for r in (r0, r1):
        expect_counts(f"rank {r['rank']}, {PAR_STEPS} DDP steps", r["counts"], steps=PAR_STEPS)
    log(f"  (a) dropout {DROPOUT}: parameters bit-equal across the ranks after each of "
        f"{PAR_DROPOUT_STEPS} steps: {r0['equal']}")
    if not all(r0["equal"]) or r0["equal"] != r1["equal"]:
        raise AssertionError("the ranks' parameters drifted apart at dropout 0.1")

    # (c) tensor parallelism against the unsplit model.
    for r in (r0, r1):
        loss_tp, loss_ref = r["tp_loss"]
        (tp_worst, tp_name), tp_noise = r["tp_grads"]
        log(f"  (c) TP rank {r['rank']}: heads a rank {r['tp_heads']}, forward launches "
            f"{r['tp_counts']}; loss {loss_tp:.6f} / unsplit {loss_ref:.6f}; outputs max abs "
            f"diff { {k: f'{v:.2e}' for k, v in r['tp_out_err'].items()} }; gradients worst rel "
            f"err {tp_worst:.2e} ({tp_name}), {len(tp_noise)} within the noise floor")
        expect_counts(f"rank {r['rank']}, one TP forward", r["tp_counts"], forwards=1)
        expect_counts(f"rank {r['rank']}, that forward, its loss and backward",
                      r["tp_step_counts"], steps=1)
        if (r["tp_heads"] != [4] or abs(loss_tp - loss_ref) > LOSS_RTOL * abs(loss_ref)
                or r["tp_out_err"]["pred_boxes"] > BOX_ATOL
                or r["tp_out_err"]["pred_logits"] > LOGIT_ATOL):
            raise AssertionError("the split transformer disagrees with the unsplit one")

    res.update(
        walls=(statistics.median(r0["walls"][1:]), statistics.median(r1["walls"][1:])),
        allreduce_calls=(r0["allreduce_calls_ms"], r1["allreduce_calls_ms"]),
        memcpy=(r0["memcpy_ms"], r1["memcpy_ms"]),
        allreduce_alone=(r0["allreduce_alone_ms"], r1["allreduce_alone_ms"]),
        grad_bytes=r0["grad_bytes"], single=single,
        launches={k: r0["counts"][k] + r1["counts"][k] + r0["tp_step_counts"][k]
                  + r1["tp_step_counts"][k] for k in per_step})
    half = TRAIN_BATCH // PAR_WORLD
    log(f"  readings, two ranks sharing one card (not a multi-GPU rate), dropout {DROPOUT}, medians "
        f"of steps 2-{PAR_DROPOUT_STEPS}: b{half} step wall a rank {res['walls'][0]:.2f} / "
        f"{res['walls'][1]:.2f} ms (each step {[round(w, 2) for w in r0['walls']]} / "
        f"{[round(w, 2) for w in r1['walls']]}); one process alone b{half} {single[half]:.2f} ms, "
        f"b{TRAIN_BATCH} {single[TRAIN_BATCH]:.2f} ms; the gradients, "
        f"{res['grad_bytes'] / 1e6:.1f} MB fp32, all-reduced through Gloo: one step under "
        f"torch.profiler, DDP's all-reduce calls {res['allreduce_calls'][0]:.2f} / "
        f"{res['allreduce_calls'][1]:.2f} ms of host time and Gloo's copies through host memory "
        f"{res['memcpy'][0]:.2f} / {res['memcpy'][1]:.2f} ms of device time (Gloo's own threads "
        f"are not timed by the profiler); one all_reduce of those bytes alone "
        f"{res['allreduce_alone'][0]:.2f} / {res['allreduce_alone'][1]:.2f} ms (host clock)")
    return res


# Phase 18: pipeline parallelism. Two rank processes share the card over
# Gloo (NCCL refuses two ranks on one device) as the two stages of a
# ("stage",) mesh, each stage boundary staged through pinned host memory
# (``parallel/p2p.py``, route "gloo-host"). DETR-R50 at full width and depth,
# the b8 376x672 fp32 recipe (TF32 off): 1F1B (``Trainer(pipeline_1f1b=)``,
# stage 0 the prefix and the 6 encoder slots, stage 1 the 6 decoder slots
# and the loss, 4 microbatches of 2) and GPipe (``DETR(pipeline=)``, each
# stage 3 encoder and 3 decoder layers), held against one process's
# sequential step; then each rank's step wall, device time, p2p traffic,
# parameter bytes and peak memory at 4 and 8 microbatches of 2.
PIPE_WORLD, PIPE_SEED, PIPE_WALL_STEPS, PIPE_TIMEOUT_S = 2, 9, 6, 300
PIPE_MICRO = 4  # choose_n_micro(8, 2): microbatches of 2
# Launches per rank and step, (stage 0, stage 1): 1F1B runs stage 0's
# encoder slots forward, then again in each backward's re-linearization,
# and stage 1's decoder slots once with their loss (B once a microbatch);
# GPipe runs the backbone and the loss on every rank and half of each stack.
PIPE_1F1B_COUNTS = ({"A-tf32": 2 * 6 * PIPE_MICRO, "A'-mma": 6 * PIPE_MICRO, "B": 0, "C": 1},
                    {"A-tf32": 12 * PIPE_MICRO, "A'-mma": 12 * PIPE_MICRO, "B": PIPE_MICRO,
                     "C": 0})
PIPE_GPIPE_COUNTS = {"A-tf32": 9 * PIPE_MICRO, "A'-mma": 9 * PIPE_MICRO, "B": 1, "C": 1}
PIPE_TAG = 1 << 30  # the transfer probe's tags, beyond the schedules'
# Dropout 0.1 follows the trainer's seed: over these seeds the first step's
# loss, and the first step's gradient between the first two, move with the
# seed pipelined by at least this share of what they move in one process
# (the same masks' statistics, drawn per microbatch and slot; a slot whose
# masks ignored the seed would shrink both).
PIPE_DROPOUT_SEEDS, PIPE_SEED_SPREAD = (0, 1, 2, 3), 0.1


def _pipe_counts(counts):
    return {k: counts[k] for k in ("A-tf32", "A'-mma", "B", "C")}


def _pipe_big_batch(torch, batch):
    """b16: the b8 batch and another b8 one."""
    from detr_tensorflow_tpu_torch.train.engine import batch_to_device

    other = batch_to_device(train_batch(PIPE_SEED + 1), DEVICE)
    return {k: torch.cat([batch[k], other[k]]) for k in batch}


def _grad_gap_sq(a, b):
    """(sum of ||a - b||^2, sum of ||a||^2) over the tensors of two
    gradient dicts."""
    return (sum(float((a[n] - b[n]).square().sum()) for n in a),
            sum(float(g.square().sum()) for g in a.values()))


def pipeline_rank(rank, tmp, results):
    """Process target: stage ``rank`` of PIPE_WORLD on the card (phase 18).
    Puts its numbers on ``results`` (or its traceback); writes its first
    1F1B step's gradients, and rank 0 GPipe's outputs and gradients, to
    ``tmp``."""
    import traceback

    import torch

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        import torch.distributed as dist

        from detr_tensorflow_tpu_torch import train
        from detr_tensorflow_tpu_torch.models import api
        from detr_tensorflow_tpu_torch.ops import flash_attention as fa, lap, losses, maxpool
        from detr_tensorflow_tpu_torch.parallel import PipelineSpec, make_mesh, multihost, p2p, pp
        from detr_tensorflow_tpu_torch.train.engine import batch_to_device
        from detr_tensorflow_tpu_torch.utils import profiling, trees

        multihost.initialize(init_method=f"file://{tmp}/rendezvous_pp", num_processes=PIPE_WORLD,
                             process_id=rank, backend="gloo", device=DEVICE,
                             timeout_s=PIPE_TIMEOUT_S)
        mesh = make_mesh(PIPE_WORLD, ("stage",))
        out = {"rank": rank, "route": p2p.route(DEVICE)}
        config = _par_config(train)
        batch = batch_to_device(train_batch(PIPE_SEED), DEVICE)

        def build(dropout):
            return api.build_detr(seed=0, device=DEVICE, dropout=dropout).module

        def trainer(dropout, seed=0, n_micro=None):
            return train.Trainer(build(dropout), config, seed=seed,
                                 pipeline_1f1b=PipelineSpec(mesh, n_micro=n_micro))

        def wall(fn):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0)

        # (a) 1F1B at dropout 0, the main path: launches counted, p2p traffic.
        tr = trainer(0.0)
        first = {}
        _first_grads(tr, first)
        reset_counts(fa, lap, maxpool)
        p2p.reset_stats()
        losses_seen = [float(tr.step(batch)["total_loss"])]
        torch.cuda.synchronize()
        out["counts"] = _pipe_counts(read_counts(fa, lap, maxpool))
        out["p2p"] = dict(p2p.stats)
        out["live"] = pp.last_stats["max_live"]
        losses_seen.append(float(tr.step(batch)["total_loss"]))
        out["losses"] = losses_seen
        torch.save(first, os.path.join(tmp, f"pipe_grads{rank}.pt"))
        params = dict(tr.model.named_parameters())
        out["stage_bytes"], out["stage_size"] = trees.tree_bytes(params), trees.tree_size(params)
        del tr, first, params
        torch.cuda.empty_cache()

        # (b) dropout 0.1: step walls, one step under the profiler, seeds.
        tr = trainer(DROPOUT)
        first = {}
        _first_grads(tr, first)
        seed_losses, walls = [], []
        for i in range(PIPE_WALL_STEPS):
            p2p.reset_stats()
            logs = []
            walls.append(wall(lambda: logs.append(float(tr.step(batch)["total_loss"]))))
            if i == 0:
                seed_losses.append(logs[0])
        out["walls"], out["p2p_step"] = walls, dict(p2p.stats)
        out["finite"] = all(bool(torch.isfinite(g).all()) for g in first.values())
        dist.barrier()
        with profiling.trace(os.path.join(tmp, f"trace{rank}")) as prof:
            tr.step(batch)
        out["device"] = profiling.device_stats_per_step(prof, 1)
        del tr, first, prof
        seed_grads = []
        for seed in PIPE_DROPOUT_SEEDS:
            tr = trainer(DROPOUT, seed)
            if len(seed_grads) < 2:
                seed_grads.append({})
                _first_grads(tr, seed_grads[-1])
            seed_losses.append(float(tr.step(batch)["total_loss"]))
            del tr
        out["seed_losses"] = seed_losses
        out["seed_grad_sq"] = _grad_gap_sq(*seed_grads)
        del seed_grads
        torch.cuda.empty_cache()

        # (c) one stage boundary's tree there and back, alone (host clock).
        tree = {"src": torch.randn(2, 252, 256, device=DEVICE),
                "pos": torch.randn(2, 252, 256, device=DEVICE),
                "qpos": torch.randn(2, 100, 256, device=DEVICE)}
        there = p2p.Link(1 - rank, PIPE_TAG, DEVICE)
        back = p2p.Link(1 - rank, PIPE_TAG + 64, DEVICE)
        trips = []
        for i in range(6):  # the first carries the layout's header too

            def trip():
                if rank == 0:
                    there.send(tree, i)
                    got = back.recv(i)
                    if not torch.equal(got["src"], tree["src"]):
                        raise AssertionError("the boundary tree came back changed")
                else:
                    back.send(there.recv(i), i)
                p2p.drain()

            trips.append(wall(trip))
        out["trip_ms"], out["trip_bytes"] = statistics.median(trips[1:]), p2p.nbytes(
            p2p.spec_of(tree))
        del tree

        # (d) peak memory a rank in a training step (Adam's moments made by
        # the step before) at 4 and 8 microbatches of 2 (b8, b16).
        big = _pipe_big_batch(torch, batch)
        peaks = {}
        for b, n_micro in ((batch, PIPE_MICRO), (big, 2 * PIPE_MICRO)):
            tr = trainer(0.0, n_micro=n_micro)
            tr.step(b)  # Adam's moments exist from here on
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tr.step(b)
            torch.cuda.synchronize()
            peaks[("1f1b", n_micro)] = torch.cuda.max_memory_allocated() / 2**30
            del tr
            torch.cuda.empty_cache()
            # GPipe through the Trainer on the same mesh (every rank the
            # whole model, its Adam moments and its gradients made whole).
            tr = train.Trainer(build(0.0).set_pipeline(PipelineSpec(mesh, n_micro=n_micro)),
                               config, seed=0, mesh=mesh)
            tr.step(b)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tr.step(b)
            torch.cuda.synchronize()
            peaks[("gpipe", n_micro)] = torch.cuda.max_memory_allocated() / 2**30
            del tr
            torch.cuda.empty_cache()
        out["peaks"] = peaks
        del big

        # (e) GPipe at dropout 0 through DETR(pipeline=), the main path.
        model = build(0.0).set_pipeline(PipelineSpec(mesh))
        reset_counts(fa, lap, maxpool)
        outputs = model(batch["images"], train=True)
        total, _ = losses.detr_loss(outputs, batch["boxes"], batch["classes"], batch["mask"],
                                    BACKGROUND)
        total.backward()
        torch.cuda.synchronize()
        out["gpipe_counts"] = _pipe_counts(read_counts(fa, lap, maxpool))
        out["gpipe_loss"] = float(total)
        if rank == 0:
            torch.save({"outputs": {k: v.detach().cpu() for k, v in outputs.items()},
                        "grads": _cpu_state((n, p.grad) for n, p in model.named_parameters())},
                       os.path.join(tmp, "gpipe.pt"))
        del model, outputs, total
        multihost.shutdown()
        results.put(out)
    except Exception:  # the process's boundary: reported to the parent, which raises
        results.put({"rank": rank, "error": traceback.format_exc()})


def time_pipeline_kernels(torch, fa, lap):
    """The kernels at the launch shapes of a pipelined step, beside the
    sequential step's, from CUDA graphs: A-tf32 (dropout 0.1, with the lse)
    and A'-mma at the three training shapes at B = 2 (a microbatch) and
    B = 8; B as 4 solves of 12 problems and as one of 48."""
    out = {}
    for lq, lk in TRAIN_ATTN_SHAPES:
        masked = (lq, lk) == (100, 252)
        for b in (2, TRAIN_BATCH):
            q, k, v, dout, mask = train_attention_inputs(torch, lq, lk, torch.float32,
                                                         lq * 3 + lk, masked, b=b)
            seed = torch.tensor([4242], device=DEVICE)
            o, lse = fa.launch_forward_tf32(q, k, v, mask, seed, DROPOUT, True)
            # A'-mma's bound as in time_train_attention, at batch b (3xTF32).
            nbytes = b * 8 * 32 * (4 * lq + 4 * lk) * 4 + b * 8 * lq * 4 + (b * lk if masked
                                                                            else 0)
            out[(lq, lk, b)] = (
                graph_ms(torch, lambda: fa.launch_forward_tf32(q, k, v, mask, seed, DROPOUT,
                                                               True)),
                graph_ms(torch, lambda: fa.launch_backward_mma(q, k, v, o, dout, lse, mask,
                                                               seed, DROPOUT)),
                attention_bound(b, lq, lk, "tf32", masked, lse=True),
                bound_ms(nbytes, {"tf32": 3 * 10 * b * 8 * lq * lk * 32}))
    cost, mask, _ = lap_problems(3)
    ct, mt = torch.from_numpy(cost).to(DEVICE), torch.from_numpy(mask).to(DEVICE)
    part = LAP_PROBLEMS // PIPE_MICRO
    out["lap"] = (graph_ms(torch, lambda: lap.solve_lap_masked(ct, mt)),
                  graph_ms(torch, lambda: [lap.solve_lap_masked(ct[i * part:(i + 1) * part],
                                                                mt[i * part:(i + 1) * part])
                                           for i in range(PIPE_MICRO)]))
    return out


def phase_pipeline(torch, fa, lap, mp, api, train, losses):
    """Phase 18: the kernels at the pipelined shapes, one process's
    sequential references, then the PIPE_WORLD stage ranks on the card, held
    against them. Returns the numbers it printed and the ranks' launches."""
    import multiprocessing
    import queue
    import tempfile

    from detr_tensorflow_tpu_torch.train.engine import batch_to_device
    from detr_tensorflow_tpu_torch.utils import profiling

    res = {"kernels": time_pipeline_kernels(torch, fa, lap)}
    for (lq, lk, b), (f_ms, b_ms, f_bound, b_bound) in sorted(
            (k, v) for k, v in res["kernels"].items() if k != "lap"):
        log(f"  (kernels) ({lq},{lk}) B={b}: A-tf32 {f_ms:.4f} ms (bound {f_bound[0]:.4f}, "
            f"{f_bound[1]}), A'-mma {b_ms:.4f} ms (bound {b_bound[0]:.4f}, {b_bound[1]}); CUDA "
            f"graphs, dropout {DROPOUT}, bounds as 3xTF32")
    whole, parts = res["kernels"]["lap"]
    log(f"  (kernels) B: one solve of {LAP_PROBLEMS} problems {whole:.4f} ms, "
        f"{PIPE_MICRO} solves of {LAP_PROBLEMS // PIPE_MICRO} {parts:.4f} ms (CUDA graphs)")

    config = _par_config(train)
    batch = batch_to_device(train_batch(PIPE_SEED), DEVICE)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_pipeline_")
    # One process, dropout 0: the outputs, the first step's gradients and
    # two steps' losses; then at dropout 0.1 its step wall and device time.
    model = api.build_detr(seed=0, device=DEVICE, dropout=0.0).module
    with torch.no_grad():
        ref_out = {k: v.cpu() for k, v in model(batch["images"], train=True).items()}
    trainer = train.Trainer(model, config, seed=0)
    ref_grads = {}
    _first_grads(trainer, ref_grads)
    ref_losses = [float(trainer.step(batch)["total_loss"]) for _ in range(2)]
    del trainer, model
    trainer = train.Trainer(api.build_detr(seed=0, device=DEVICE).module, config, seed=0)
    walls = []
    for _ in range(PIPE_WALL_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    with profiling.trace(os.path.join(tmp.name, "trace_single")) as prof:
        trainer.step(batch)
    res["single"] = (statistics.median(walls[1:]), profiling.device_stats_per_step(prof, 1))
    del trainer, prof
    # The same at dropout 0.1 over PIPE_DROPOUT_SEEDS: the first step's
    # loss, and the first two seeds' first-step gradients.
    seq_losses, seq_grads = [], []
    for seed in PIPE_DROPOUT_SEEDS:
        trainer = train.Trainer(api.build_detr(seed=0, device=DEVICE, dropout=DROPOUT).module,
                                config, seed=seed)
        if len(seq_grads) < 2:
            seq_grads.append({})
            _first_grads(trainer, seq_grads[-1])
        seq_losses.append(float(trainer.step(batch)["total_loss"]))
        del trainer
    gap_sq, norm_sq = _grad_gap_sq(*seq_grads)
    res["seq_seeds"] = (seq_losses, (gap_sq / norm_sq) ** 0.5)
    del seq_grads
    torch.cuda.empty_cache()

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=pipeline_rank, daemon=True, args=(r, tmp.name, results))
             for r in range(PIPE_WORLD)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    ranks = {}
    try:
        deadline = time.perf_counter() + PIPE_TIMEOUT_S
        while len(ranks) < PIPE_WORLD:
            try:
                got = results.get(timeout=5)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead or time.perf_counter() > deadline:
                    raise AssertionError(f"phase 18: {len(dead)} rank(s) died, {len(ranks)} of "
                                         f"{PIPE_WORLD} reported in {time.perf_counter() - t0:.0f} s")
                continue
            if "error" in got:
                raise AssertionError(f"phase 18, rank {got['rank']}:\n{got['error']}")
            ranks[got["rank"]] = got
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.terminate()
                proc.join()
    res["ranks_s"] = time.perf_counter() - t0
    r0, r1 = ranks[0], ranks[1]
    grads = {}
    for r in range(PIPE_WORLD):
        grads.update(torch.load(os.path.join(tmp.name, f"pipe_grads{r}.pt")))
    gpipe = torch.load(os.path.join(tmp.name, "gpipe.pt"))
    tmp.cleanup()

    # (a) 1F1B against the one-process step.
    if set(grads) != set(ref_grads):
        raise AssertionError(f"1F1B gradients of {sorted(set(grads) ^ set(ref_grads))[:4]} "
                             "missing or extra")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref_losses))
    worst, noise = gradient_agreement(grads, ref_grads)
    log(f"  (a) 1F1B, 2 stage ranks on one card over Gloo ({r0['route']}), b{TRAIN_BATCH} as "
        f"{PIPE_MICRO} microbatches: losses {r0['losses']} (rank 1 {r1['losses']}) against one "
        f"process's {ref_losses}, worst rel {loss_err:.2e} (tol {LOSS_RTOL}); first step's "
        f"gradients, both stages merged: worst rel err {worst[0]:.2e} ({worst[1]}, tol "
        f"{TENSOR_GRAD_RTOL}), {len(noise)} tensors within the noise floor; live saved inputs "
        f"a stage {r0['live']} / {r1['live']}")
    if r0["losses"] != r1["losses"] or not loss_err <= LOSS_RTOL:
        raise AssertionError("1F1B steps disagree with the one-process steps")
    for r, want in zip((r0, r1), PIPE_1F1B_COUNTS):
        log(f"  launches rank {r['rank']}, one 1F1B step: {r['counts']}")
        if r["counts"] != want:
            raise AssertionError(f"rank {r['rank']}: 1F1B launches {r['counts']}, expected {want}")

    # (b) dropout 0.1: deterministic given the seed, and moving with it as
    # far as one process's step does.
    s0_again, pipe_losses = r0["seed_losses"][0], r0["seed_losses"][1:]
    seq_losses, seq_grad_gap = res["seq_seeds"]
    pipe_spread, seq_spread = statistics.pstdev(pipe_losses), statistics.pstdev(seq_losses)
    pipe_grad_gap = (sum(r["seed_grad_sq"][0] for r in (r0, r1))
                     / sum(r["seed_grad_sq"][1] for r in (r0, r1))) ** 0.5
    stage_gaps = [(r["seed_grad_sq"][0] / r["seed_grad_sq"][1]) ** 0.5 for r in (r0, r1)]
    log(f"  (b) 1F1B dropout {DROPOUT}: first-step loss over seeds {list(PIPE_DROPOUT_SEEDS)} "
        f"{[round(v, 6) for v in pipe_losses]} (seed 0 again {s0_again:.6f}; rank 1 "
        f"{[round(v, 6) for v in r1['seed_losses'][1:]]}), std {pipe_spread:.4f}; one "
        f"process's {[round(v, 6) for v in seq_losses]}, std {seq_spread:.4f}; first-step "
        f"gradient, seed 1 against seed 0, ||g1 - g0|| / ||g0|| {pipe_grad_gap:.4f} (stage 0 "
        f"{stage_gaps[0]:.4f}, stage 1 {stage_gaps[1]:.4f}), one process's "
        f"{seq_grad_gap:.4f}; required at least {PIPE_SEED_SPREAD} of one process's; "
        f"gradients finite: {r0['finite']} / {r1['finite']}")
    if (s0_again != pipe_losses[0] or r0["seed_losses"] != r1["seed_losses"]
            or not pipe_spread >= PIPE_SEED_SPREAD * seq_spread
            or not pipe_grad_gap >= PIPE_SEED_SPREAD * seq_grad_gap
            or not (r0["finite"] and r1["finite"])):
        raise AssertionError("1F1B dropout: not deterministic given the seed, moving less with "
                             "the seed than one process's step, or not finite")

    # (c) GPipe against the one-process forward and step.
    out_err = {k: float((gpipe["outputs"][k] - ref_out[k]).abs().max()) for k in ref_out}
    g_worst, g_noise = gradient_agreement(gpipe["grads"], ref_grads)
    g_loss_err = abs(r0["gpipe_loss"] - ref_losses[0]) / abs(ref_losses[0])
    log(f"  (c) GPipe DETR(pipeline=): loss {r0['gpipe_loss']:.6f} / {r1['gpipe_loss']:.6f} "
        f"against {ref_losses[0]:.6f} (rel {g_loss_err:.2e}); outputs max abs diff "
        f"{ {k: f'{v:.2e}' for k, v in out_err.items()} }; gradients worst rel err "
        f"{g_worst[0]:.2e} ({g_worst[1]}), {len(g_noise)} within the noise floor")
    if (r0["gpipe_loss"] != r1["gpipe_loss"] or not g_loss_err <= LOSS_RTOL
            or out_err["pred_boxes"] > BOX_ATOL or out_err["pred_logits"] > LOGIT_ATOL):
        raise AssertionError("GPipe disagrees with the sequential model")
    for r in (r0, r1):
        log(f"  launches rank {r['rank']}, one GPipe forward and backward: {r['gpipe_counts']}")
        if r["gpipe_counts"] != PIPE_GPIPE_COUNTS:
            raise AssertionError(f"rank {r['rank']}: GPipe launches {r['gpipe_counts']}, "
                                 f"expected {PIPE_GPIPE_COUNTS}")

    # (d) readings.
    single_wall, single_dev = res["single"]
    for r in (r0, r1, {"device": single_dev}):
        if r["device"] is None:
            raise AssertionError("torch.profiler saw no CUDA kernel: no device time")
    for r in (r0, r1):
        dev, pst, one = r["device"], r["p2p_step"], r["p2p"]
        log(f"  (d) rank {r['rank']} (stage {r['rank']}): step wall median of steps "
            f"2-{PIPE_WALL_STEPS} {statistics.median(r['walls'][1:]):.2f} ms (each "
            f"{[round(w, 2) for w in r['walls']]}); device time a step "
            f"{dev['device_ms']:.2f} ms of kernels over {dev['kernels']:.0f} kernels, copies "
            f"{dev['copy_ms']:.2f} ms, busy span {dev['span_ms']:.2f} ms; p2p a step "
            f"{pst['bytes_sent'] / 1e6:.3f} MB sent / {pst['bytes_received'] / 1e6:.3f} MB "
            f"received in {pst['messages']} messages, host time sending {pst['send_ms']:.2f} ms "
            f"and receiving (waits for the other stage included) {pst['recv_ms']:.2f} ms "
            f"(the dropout-0 step: {one['bytes_sent'] / 1e6:.3f} / "
            f"{one['bytes_received'] / 1e6:.3f} MB); parameters {r['stage_size']:,} "
            f"({r['stage_bytes'] / 1e6:.1f} MB); peak memory GiB "
            f"{ {f'{k} n_micro {n}': round(v, 3) for (k, n), v in r['peaks'].items()} }")
    log(f"  (d) one process b{TRAIN_BATCH}: step wall {single_wall:.2f} ms, device time "
        f"{single_dev['device_ms']:.2f} ms over {single_dev['kernels']:.0f} kernels; one "
        f"boundary tree ({r0['trip_bytes'] / 1e6:.3f} MB: src, pos, qpos of a microbatch) "
        f"there and back alone {r0['trip_ms']:.2f} ms (host clock, median of 5)")
    res.update(ranks={0: r0, 1: r1}, loss_err=loss_err, grad_worst=worst, gpipe_worst=g_worst,
               launches={k: r0["counts"][k] + r1["counts"][k] + r0["gpipe_counts"][k]
                         + r1["gpipe_counts"][k] for k in PIPE_GPIPE_COUNTS})
    return res


def _rel_norm(a, b) -> float:
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def sass_counts(nvcc_build, path, op="HMMA") -> dict:
    """``op`` instructions (HMMA: bf16 and TF32 tensor cores, IMMA: int8) in
    the SASS of each kernel of a built library, by mangled name."""
    cuobjdump = Path(nvcc_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and op in line:
            counts[name] += 1
    return counts


def template_args(mangled: str) -> str:
    """The int and bool template arguments of a mangled kernel name, those
    of a class argument (kernel G's tile) included, as <..>."""
    args = re.findall(r"L[ib](\d+)E", mangled)
    return "<" + ",".join(args) + ">" if args else ""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a GPU")
    from detr_tensorflow_tpu_torch import serve
    from detr_tensorflow_tpu_torch.data import COCO_CLASS_NAME
    from detr_tensorflow_tpu_torch.models import api
    from detr_tensorflow_tpu_torch import train
    from detr_tensorflow_tpu_torch.ops import flash_attention as fa
    from detr_tensorflow_tpu_torch.models import quantized
    from detr_tensorflow_tpu_torch.ops import int8_conv, int8_matmul, lap, losses, nvcc_build
    from detr_tensorflow_tpu_torch.ops import fused_bottleneck, fused_residual, maxpool
    from detr_tensorflow_tpu_torch.predictor import Predictor

    # fp32 parity needs full fp32 matmuls and convolutions (TF32 off); torch's
    # defaults are kept for the serving phase's reading of them.
    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    t = time.perf_counter()
    builds = dict(zip(SOURCES, nvcc_build.build_all(SOURCES)))
    for source, build in builds.items():
        log(f"[build] {source}: nvcc {build.seconds:.2f} s -> {build.path.name}")
        entry_name = ""
        for line in build.log.splitlines():
            if "Compiling entry" in line:  # a mangled name: keep its template arguments
                entry_name = template_args(line)
            elif "registers" in line or "spill" in line:
                log(f"  ptxas{' ' + entry_name if entry_name else ''}: {line.strip()}")
    for source in MMA_SOURCES:
        hmma = sum(sass_counts(nvcc_build, builds[source].path).values())
        log(f"[build] {source}: {hmma} HMMA instructions in its SASS (cuobjdump)")
        if hmma == 0:
            raise AssertionError(f"{source} compiled to no tensor-core instruction")
    for source, params in (("int8_matmul.cu", "variant,relu,bf16 out,precise"),
                           ("int8_conv.cu", "stride,patch rows,patch columns,CTAs an SM,relu,"
                                            "bf16 out,precise")):
        imma = {template_args(name): n for name, n in
                sass_counts(nvcc_build, builds[source].path, "IMMA").items()}
        log(f"[build] {source}: IMMA instructions in the SASS of each configuration <{params}>: "
            f"{imma}")
        if not imma or min(imma.values()) == 0:
            raise AssertionError(f"a configuration of {source} compiled to no int8 tensor-core "
                                 "instruction")
    log(f"[build] ok in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    worst, times = phase_kernels(torch, fa)
    bwd_worst, bwd_times, fwd_train_times = phase_train_kernels(torch, fa)
    log(f"[kernels] ok in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    lap_err, lap_times = phase_lap(torch, lap)
    log(f"[lap] ok in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    predictor, launches, mma_serving, pool_serving, fp32_ms, bf16_ms, tf32_errs = phase_serving(
        torch, fa, maxpool, api, Predictor, tf32_defaults)
    log(f"[serving] ok in {time.perf_counter() - t:.1f} s, {launches} A-tf32 launches "
        f"in 3 fp32 forwards, {mma_serving} A-mma in 1 bf16 forward")

    t = time.perf_counter()
    phase_http(predictor, serve, COCO_CLASS_NAME)
    log(f"[http] ok in {time.perf_counter() - t:.1f} s")
    del predictor
    torch.cuda.empty_cache()

    t = time.perf_counter()
    int8_worst, int8_times = phase_int8_kernels(torch, int8_matmul, int8_conv)
    log(f"[int8 kernels] ok in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    f_counts, g_counts, int8_a, int8_ms = phase_int8_serving(
        torch, fa, int8_matmul, int8_conv, maxpool, api, quantized, Predictor, fp32_ms, bf16_ms)
    log(f"[int8 serving] ok in {time.perf_counter() - t:.1f} s, median {int8_ms:.2f} ms")
    torch.cuda.empty_cache()

    t = time.perf_counter()
    counts, step32 = phase_training(torch, fa, lap, maxpool, api, train, losses)
    log(f"[training] ok in {time.perf_counter() - t:.1f} s, median step {step32['median']:.2f} ms")
    torch.cuda.empty_cache()

    t = time.perf_counter()
    counts16, step16 = phase_bf16_training(torch, fa, lap, maxpool, api, train, losses)
    log(f"[bf16 training] ok in {time.perf_counter() - t:.1f} s; b8 376x672 step, bf16 / fp32: "
        f"median wall {step16['median']:.2f} / {step32['median']:.2f} ms, under the profiler "
        f"{step16['wall']:.2f} / {step32['wall']:.2f} ms wall, {step16['busy']:.2f} / "
        f"{step32['busy']:.2f} ms device busy and {step16['events']:.0f} / "
        f"{step32['events']:.0f} kernels and copies, peak memory {step16['peak_gb']:.2f} / "
        f"{step32['peak_gb']:.2f} GiB")
    torch.cuda.empty_cache()

    t = time.perf_counter()
    entry_counts, entry = phase_entry_points(torch, fa, lap, maxpool, api, train)
    log(f"[entry points] ok in {time.perf_counter() - t:.1f} s; loader {entry['loader_images_s']:.1f} "
        f"images/s, b{TRAIN_BATCH} fp32 step fed by the loader (past the {entry['ahead']} "
        f"batches held ahead) / in memory, median {entry['fed_ms']:.2f} "
        f"({entry['steady_ms']:.2f}) / "
        f"{entry['memory_ms']:.2f} ms, eval images/s "
        + ", ".join(f"b{b} {r:.2f}" for b, r in entry["eval_images_s"].items()))
    torch.cuda.empty_cache()

    t = time.perf_counter()
    fused_worst, fused_abs, fused_times = phase_fused_kernels(
        torch, maxpool, fused_residual, fused_bottleneck)
    log(f"[fused kernels] ok in {time.perf_counter() - t:.1f} s; worst kernel vs plain rel err "
        f"{ {f'{k} {n}': f'{v:.2e}' for (k, n), v in sorted(fused_worst.items())} }")

    t = time.perf_counter()
    fused_counts, fused_bf16_counts, fused_ms = phase_fused_serving(
        torch, fa, maxpool, fused_residual, fused_bottleneck, api, Predictor)
    log(f"[fused serving] ok in {time.perf_counter() - t:.1f} s, b1 median fused / unfused: "
        + ", ".join(f"{size} {dtype} {v[True]:.2f} / {v[False]:.2f} ms"
                    for (dtype, size), v in fused_ms.items()))

    t = time.perf_counter()
    dc5 = phase_dc5(torch, fa, lap, maxpool, fused_residual, fused_bottleneck, int8_matmul,
                    int8_conv, api, quantized, train, Predictor)
    lat = dc5["latency"]
    log(f"[checkpoints and DC5] ok in {time.perf_counter() - t:.1f} s; 800x1333 b1 p50 DETR-R50 / "
        f"DETR-R50-DC5: " + ", ".join(
            f"{dt} {lat[('DETR-R50', dt)][0]:.2f} / {lat[('DETR-R50-DC5', dt)][0]:.2f} ms"
            for dt in ("float32", "bfloat16"))
        + f"; launches on its main paths {dict(dc5['launches'])}")

    t = time.perf_counter()
    seg = phase_segmentation(torch, fa, lap, maxpool, fused_residual, fused_bottleneck,
                             int8_matmul, int8_conv, api, quantized, train, serve, Predictor)
    sv = seg["serving"]
    log(f"[segmentation] ok in {time.perf_counter() - t:.1f} s; 800x1333 b1 p50 with / without "
        f"masks: " + ", ".join(f"{dt} {sv[(dt, True)]['p50']:.2f} / {sv[(dt, False)]['p50']:.2f} "
                               f"ms" for dt in ("float32", "bfloat16"))
        + f"; launches on its main paths {dict(seg['launches'])}")

    t = time.perf_counter()
    pan = phase_panoptic(torch, fa, lap, maxpool, api, train)
    ev, rec = pan["eval"], pan["recipe"]
    log(f"[panoptic] ok in {time.perf_counter() - t:.1f} s; eval --pq images/s fp32 / bf16 "
        f"{ev['float32']['images_s']:.2f} / {ev['bfloat16']['images_s']:.2f}; the 250-query "
        f"step b{rec['batch']}: wall {rec['wall']:.2f} ms, busy {rec['busy']:.2f} ms, peak "
        f"{rec['peak']:.2f} GiB; launches on its main paths {dict(pan['launches'])}")

    t = time.perf_counter()
    jp = phase_jpeg(torch, fa, lap, maxpool, api, train)
    ws = jp["wide_step"]
    log(f"[jpeg] ok in {time.perf_counter() - t:.1f} s; decode "
        + ", ".join(f"{n} {ms:.2f} ms" for n, ms in jp["decode_ms"].items())
        + f" (one thread, {jp['cpu']}); JPEG loader {jp['rate']:.1f} images/s; b{TRAIN_BATCH} "
        f"fp32 step fed by it / in memory, median {jp['fed_ms']:.2f} ({jp['steady_ms']:.2f}) / "
        f"{jp['memory_ms']:.2f} ms; eval b1 {jp['eval_images_s']:.2f} images/s; B's generic "
        f"instance " + ", ".join(f"{v['shape'][0]}x{v['shape'][1]}x{v['shape'][2]} "
                                 f"{v['ms']:.4f} ms (chain {v['chain']})"
                                 for v in jp["lap"].values())
        + f"; the {WIDE_QUERIES}-query step: wall {ws['wall']:.2f} ms, busy {ws['busy']:.2f} ms, "
        f"peak {ws['peak']:.2f} GiB; launches on its main paths {dict(jp['launches'])}")

    t = time.perf_counter()
    art = phase_artifacts(torch)
    log(f"[artifacts] ok in {time.perf_counter() - t:.1f} s; b1 p50 of {ART_REQUESTS} requests, "
        "artifact / live: " + ", ".join(
            f"{n} {r['artifact_p50']:.2f} / {r.get('live_p50', float('nan')):.2f} ms"
            for n, r in art["models"].items())
        + "; export s per program, load s: " + ", ".join(
            f"{n} {r['export_s'] / r['programs']:.2f}, {r['load_s']:.2f}"
            for n, r in art["models"].items())
        + f"; launches on its main paths {dict(art['launches'])}")

    t = time.perf_counter()
    par = phase_parallel(torch, fa, lap, maxpool, api, train, losses)
    par_launches = collections.Counter({
        "flash_attention_fwd_tf32": par["launches"]["A-tf32"],
        "flash_attention_bwd_mma": par["launches"]["A'-mma"], "lap": par["launches"]["B"],
        "maxpool": par["launches"]["C"]})
    log(f"[parallel] ok in {time.perf_counter() - t:.1f} s ({par['ranks_s']:.1f} s in the rank "
        f"processes); two ranks sharing one card: b{TRAIN_BATCH // 2} step wall a rank "
        f"{par['walls'][0]:.2f} / {par['walls'][1]:.2f} ms, gradient all-reduce alone "
        f"{par['allreduce_alone'][0]:.2f} ms, one process b{TRAIN_BATCH // 2} / b{TRAIN_BATCH} "
        f"{par['single'][TRAIN_BATCH // 2]:.2f} / {par['single'][TRAIN_BATCH]:.2f} ms; NCCL "
        f"world-1 largest difference {par['nccl_err']:.3e}; launches on its main paths "
        f"{dict(par_launches)}")

    t = time.perf_counter()
    pipe = phase_pipeline(torch, fa, lap, maxpool, api, train, losses)
    pipe_launches = collections.Counter({
        "flash_attention_fwd_tf32": pipe["launches"]["A-tf32"],
        "flash_attention_bwd_mma": pipe["launches"]["A'-mma"], "lap": pipe["launches"]["B"],
        "maxpool": pipe["launches"]["C"]})
    walls = [statistics.median(pipe["ranks"][r]["walls"][1:]) for r in (0, 1)]
    log(f"[pipeline] ok in {time.perf_counter() - t:.1f} s ({pipe['ranks_s']:.1f} s in the rank "
        f"processes); two stages sharing one card, b{TRAIN_BATCH} as {PIPE_MICRO} microbatches: "
        f"step wall a rank {walls[0]:.2f} / {walls[1]:.2f} ms against one process's "
        f"{pipe['single'][0]:.2f} ms; 1F1B loss rel err {pipe['loss_err']:.2e}, gradients worst "
        f"{pipe['grad_worst'][0]:.2e}, GPipe gradients worst {pipe['gpipe_worst'][0]:.2e}; "
        f"launches on its main paths {dict(pipe_launches)}")

    a32, a16 = times[(2, 1232, 1232, "float32")], times[(2, 1232, 1232, "bfloat16")]
    # The training shapes' times: fp32 under (Lq, Lk), bf16 under (Lq, Lk, "bfloat16").
    bwd_times16 = {k[:2]: v for k, v in bwd_times.items() if len(k) == 3}
    fwd_train16 = {k[:2]: v for k, v in fwd_train_times.items() if len(k) == 3}
    bwd_times = {k: v for k, v in bwd_times.items() if len(k) == 2}
    fwd_train_times = {k: v for k, v in fwd_train_times.items() if len(k) == 2}
    bwd, bwd16, fwd16 = bwd_times[(252, 252)], bwd_times16[(252, 252)], fwd_train16[(252, 252)]
    per_step = {key: sum(LAUNCHES_PER_FORWARD // 3 * t[key] for t in bwd_times.values())
                for key in ("mma", "simt", "plain", "sdpa")}
    log(f"[kernels] A' per training step (6 calls at each of {list(bwd_times)}), ms from CUDA "
        f"graphs: tensor-core {per_step['mma']:.4f}, SIMT {per_step['simt']:.4f}, plain "
        f"{per_step['plain']:.4f}, SDPA backward {per_step['sdpa']:.4f}")
    fwd_step = {key: sum(LAUNCHES_PER_FORWARD // 3 * t[key] for t in fwd_train_times.values())
                for key in ("tf32", "simt", "plain", "sdpa")}
    log(f"[kernels] A per training step at dropout {DROPOUT} (6 calls at each of "
        f"{list(fwd_train_times)}), ms from CUDA graphs: A-tf32 {fwd_step['tf32']:.4f}, SIMT "
        f"{fwd_step['simt']:.4f}, plain {fwd_step['plain']:.4f}, SDPA forward with dropout_p "
        f"{fwd_step['sdpa']:.4f}")
    for label, table, kernel in (("A-mma", fwd_train16, "mma"),
                                 ("A (SIMT, on no path)", fwd_train16, "simt"),
                                 ("A'-bf16", bwd_times16, "bf16"),
                                 ("A' (SIMT, on no path)", bwd_times16, "simt")):
        step = {key: sum(LAUNCHES_PER_FORWARD // 3 * t[key] for t in table.values())
                for key in (kernel, "plain", "sdpa")}
        bound = sum(LAUNCHES_PER_FORWARD // 3 * t["bound"][0] for t in table.values())
        log(f"[kernels] {label} per bf16 training step at dropout {DROPOUT} (6 calls at each of "
            f"{list(table)}), ms from CUDA graphs: kernel {step[kernel]:.4f}, plain "
            f"{step['plain']:.4f}, SDPA {step['sdpa']:.4f}, bound {bound:.4f}")
    faster = {shape: t["bf16"] < t["simt"] for shape, t in bwd_times16.items()}
    log(f"[kernels] A'-bf16 faster than the SIMT A' at bf16, each training shape: {faster}")
    faster = {shape: (t["mma"] < t["simt"], t["mma"] < t["sdpa"])
              for shape, t in fwd_train16.items()}
    log(f"[kernels] A-mma with dropout faster than (the SIMT A, SDPA with dropout_p) at bf16, each "
        f"training shape: {faster}")
    mma_err = max([worst["bfloat16"]] + [e for t in fwd_train16.values()
                                         for w, e in t["errs"].items() if w != "simt"])
    lap_ms, lap_plain_ms, _, (lap_bound, lap_by), lap_loop_ms, lap_chain = lap_times
    pan_lap = pan["lap"][True]
    gen = jp["lap"][LAP_GENERIC[0][0]]

    # "measured_at": the shape and dtype of the times, which differ between
    # kernels and have changed between versions of this script.
    def entry(name, source, launches_, err, ms_, plain_, bound, by, library, at):
        return {"name": name, "route": "cuda", "source": CSRC + source,
                "replaces": REPLACES[name],
                "launches": (launches_ + dc5["launches"][name] + seg["launches"][name]
                             + pan["launches"][name] + jp["launches"][name]
                             + art["launches"][name] + par_launches[name]
                             + pipe_launches[name]),
                "max_abs_err": err,
                "ms": ms_, "plain_ms": plain_, "bound_ms": bound, "bound_by": by,
                "library_ms": library, "measured_at": at}

    def train_at(dtype):
        return f"(252,252) {dtype} B=8 H=8 Dh=32 dropout {DROPOUT}, one call"

    def int8_at(per_forward):
        return (f"b1 {INT8_BUCKET[0]}x{INT8_BUCKET[1]} int8 forward, summed over its "
                f"{sum(per_forward.values())} launches")

    # A per-forward bound is bound by what bounds the larger part of it.
    int8_by = {n: "bytes" if v[4] >= v[3] / 2 else "operations" for n, v in int8_times.items()}
    masked_tag = f"{FUSED_MASKED[0]}x{FUSED_MASKED[1]} masked"
    exact_tag = f"{FUSED_EXACT[0]}x{FUSED_EXACT[1]}"

    def fused_entry(name, source, launches_, bucket, dtype="float32"):
        kms, pms, yard, b, b_bytes = fused_times[(name, bucket, dtype)]
        at = (f"(1,64,448,704) {dtype}, the {bucket} stem, one call" if name == "maxpool" else
              f"b1 {bucket} {dtype} forward, summed over its "
              f"{12 if 'bottleneck' in name else 16} launches")
        return entry(name, source, launches_, fused_abs[(name, dtype)], kms, pms, b,
                     "bytes" if b_bytes >= b / 2 else "operations",
                     yard if name == "maxpool" else None, at)

    record = {"kernels": [
        entry("flash_attention_fwd", SOURCES[0], counts16["A SIMT"],
              max(t["errs"]["simt"] for t in fwd_train16.values()), fwd16["simt"],
              fwd16["plain"], *fwd16["bound"], fwd16["sdpa"],
              train_at("bfloat16") + ", with the row lse, called directly"),
        entry("flash_attention_bwd", SOURCES[1], counts[1] + counts16["A' SIMT"],
              bwd_worst["simt bfloat16"], bwd16["simt"], bwd16["plain"], *bwd16["bound"],
              bwd16["sdpa"], train_at("bfloat16") + ", called directly"),
        entry("lap", SOURCES[2], counts[2] + counts16["B"] + entry_counts["B"], lap_err, lap_ms,
              lap_plain_ms,
              lap_bound, lap_by, None, f"{LAP_PROBLEMS} problems of {LAP_SLOTS}x{LAP_SLOTS} "
              "float32, one call"),
        entry("lap_wide", SOURCES[2], 0, pan["lap_err"], *pan_lap[:2], *pan_lap[3], None,
              f"{LAP_PROBLEMS} problems of {PAN_LAP_SLOTS}x{PAN_LAP_SLOTS} float32 (the "
              f"256-column instance), scattered n_real 0..{PAN_LAP_MAX_REAL} and one problem of "
              f"{PAN_LAP_SLOTS}, one call"),
        entry("lap_generic", SOURCES[2], 0, jp["lap_err"], gen["ms"], gen["plain_ms"],
              *gen["bound"], None, f"{gen['shape'][0]} problems of {gen['shape'][1]}x"
              f"{gen['shape'][2]} float32 (the generic instance), scattered n_real "
              f"{LAP_GENERIC[0][3][0]}..{LAP_GENERIC[0][3][1]}, one call"),
        entry("int8_matmul", SOURCES[3], sum(f_counts.values()), int8_worst["int8_matmul"],
              *int8_times["int8_matmul"][[0, 1, 3]], int8_by["int8_matmul"],
              int8_times["int8_matmul"][2], int8_at(F_PER_FORWARD)),
        entry("int8_conv", SOURCES[4], sum(g_counts.values()), int8_worst["int8_conv"],
              *int8_times["int8_conv"][[0, 1, 3]], int8_by["int8_conv"],
              int8_times["int8_conv"][2], int8_at(G_PER_FORWARD)),
        fused_entry("maxpool", SOURCES[5], pool_serving + counts[3] + counts16["C"]
                    + entry_counts["C"] + fused_counts[0] + fused_bf16_counts[0], masked_tag),
        fused_entry("fused_residual", SOURCES[6], fused_counts[1] + fused_bf16_counts[1],
                    masked_tag),
        fused_entry("fused_bottleneck", SOURCES[7], fused_counts[4] + fused_bf16_counts[4],
                    exact_tag),
        entry("flash_attention_fwd_mma", SOURCES[8],
              mma_serving + int8_a + fused_bf16_counts[8] + counts16["A-mma"], mma_err,
              a16["mma"], a16["plain"], *a16["bound"], a16["sdpa"],
              "(1232,1232) bfloat16 B=2 H=8 Dh=32, one call"),
        entry("flash_attention_bwd_mma", SOURCES[9], counts[4] + entry_counts["A'-mma"],
              bwd_worst["float32"], bwd["mma"],
              bwd["plain"], *bwd["bound3x"], bwd["sdpa"], train_at("float32")),
        entry("flash_attention_fwd_tf32", SOURCES[10],
              launches + counts[0] + entry_counts["A-tf32"] + fused_counts[7],
              worst["float32"], a32["tf32"], a32["plain"], *a32["bound3x"], a32["sdpa"],
              "(1232,1232) float32 B=2 H=8 Dh=32, one call"),
        fused_entry("fused_bottleneck_mma", SOURCES[11], fused_counts[5] + fused_bf16_counts[5],
                    exact_tag, "bfloat16"),
        fused_entry("fused_bottleneck_tf32", SOURCES[12], fused_counts[6] + fused_bf16_counts[6],
                    exact_tag),
        fused_entry("fused_residual_mma", SOURCES[13], fused_counts[2] + fused_bf16_counts[2],
                    masked_tag, "bfloat16"),
        fused_entry("fused_residual_tf32", SOURCES[14], fused_counts[3] + fused_bf16_counts[3],
                    masked_tag),
        entry("flash_attention_bwd_bf16", SOURCES[15], counts16["A'-bf16"], bwd_worst["bfloat16"],
              bwd16["bf16"], bwd16["plain"], *bwd16["bound"], bwd16["sdpa"], train_at("bfloat16")),
    ]}
    tf32_chain = fused_times[("fused_bottleneck_tf32", exact_tag, "float32")][2]
    a_bwd16, simt_bwd16 = counts16["A'-bf16"], counts16["A' SIMT"]
    entry_bwd = entry_counts["A'-mma"]
    d_mma_chain = fused_times[("fused_residual_mma", masked_tag, "bfloat16")][2]
    d_tf32_chain = fused_times[("fused_residual_tf32", masked_tag, "float32")][2]
    log(f"[summary] flash_attention_fwd (SIMT, on no path, called directly): max_abs_err bf16 "
        f"dropout {DROPOUT} against plain given the keep mask at the training shapes, "
        f"ms/plain_ms/library_ms (scaled_dot_product_attention with dropout_p) at (252,252) bf16 "
        f"B=8 H=8 Dh=32 from CUDA graphs, launches {counts16['A SIMT']} in {BF16_TRAIN_STEPS} "
        f"bf16 training steps, bound "
        f"at the bf16 peak (called directly at (1232,1232) B=2: fp32 {a32['simt']:.4f} ms, "
        f"max_abs_err {worst['simt float32']:.3e}; bf16 without dropout {a16['simt']:.4f} ms, "
        f"{worst['simt bfloat16']:.3e}); flash_attention_fwd_tf32 (3xTF32): max_abs_err fp32 "
        f"{worst['float32']:.3e}, ms/plain_ms/library_ms at (1232,1232) fp32 B=2 from CUDA "
        f"graphs, launches {launches} fp32 serving + {counts[0]} training + "
        f"{entry_counts['A-tf32']} entry points + {fused_counts[7]} "
        f"fused fp32 serving, bound as 3xTF32 on the tensor cores; flash_attention_fwd_mma: "
        f"max_abs_err bf16 {mma_err:.3e} (served shapes and the training shapes with dropout), "
        f"ms/plain_ms/library_ms at (1232,1232) bf16 B=2 from CUDA graphs (with dropout "
        f"{DROPOUT} at (252,252) B=8: {fwd16['mma']:.4f} ms, SDPA with dropout_p "
        f"{fwd16['sdpa']:.4f}), launches "
        f"{mma_serving} bf16 serving + {int8_a} int8 serving + {fused_bf16_counts[8]} fused bf16 "
        f"serving + {counts16['A-mma']} in {BF16_TRAIN_STEPS} bf16 training steps; "
        f"flash_attention_bwd_bf16 (A'-bf16): gradient max_abs_err bf16 "
        f"{bwd_worst['bfloat16']:.3e}, launches {a_bwd16} in {BF16_TRAIN_STEPS} bf16 training "
        f"steps, ms/plain_ms/library_ms backward at (252,252) bf16 B=8 dropout {DROPOUT}, bound "
        f"at the bf16 peak; flash_attention_bwd (SIMT, on no path, called directly): gradient "
        f"max_abs_err bf16 {bwd_worst['simt bfloat16']:.3e}, fp32 "
        f"{bwd_worst['simt float32']:.3e}, launches {counts[1]} in {TRAIN_STEPS} fp32 and "
        f"{simt_bwd16} in {BF16_TRAIN_STEPS} bf16 training steps, times as "
        f"A'-bf16's; flash_attention_bwd_mma (3xTF32): gradient max_abs_err fp32 "
        f"{bwd_worst['float32']:.3e}, launches {counts[4]} in {TRAIN_STEPS} fp32 training steps "
        f"+ {entry_bwd} in the entry points' {ENTRY_STEPS + 1} steps, "
        f"ms/plain_ms/library_ms backward at (252,252) fp32 B=8 dropout {DROPOUT}, bound as 3xTF32 "
        f"on the tensor cores; both backwards from CUDA graphs (plain and library: forward and "
        f"backward less forward); lap: optimal-cost max_abs_err "
        f"{lap_err:.3e}, ms kernel from CUDA graphs ({lap_loop_ms:.4f} ms a call in a loop, host "
        f"included) / plain_ms plain version on 48 problems, no library call, bound on bytes "
        f"with a serial chain of {lap_chain} Dijkstra steps, launches at 100 columns; "
        f"lap_wide (the same kernel's 256-column instance): optimal-cost max_abs_err "
        f"{pan['lap_err']:.3e}, ms/plain_ms at 48x250x250 with one problem of 250 real rows "
        f"(serial chain {pan_lap[4]} Dijkstra steps; without that problem "
        f"{pan['lap'][False][0]:.4f} ms, chain {pan['lap'][False][4]}), launches at 250 "
        f"columns in the 250-query steps; lap_generic (the same kernel's generic instance, "
        f"above 255 columns): optimal-cost max_abs_err {jp['lap_err']:.3e} over the "
        f"{len(LAP_GENERIC)} widths, ms/plain_ms at {gen['shape'][0]}x{gen['shape'][1]}x"
        f"{gen['shape'][2]} (serial chain {gen['chain']}; "
        + ", ".join(f"{v['shape'][0]}x{v['shape'][1]}x{v['shape'][2]} {v['ms']:.4f} ms, plain "
                    f"{v['plain_ms']:.2f}, bound {v['bound'][0]:.5f}, chain {v['chain']}"
                    for v in jp["lap"].values())
        + f"), launches in the {WIDE_QUERIES}-query step; "
        f"int8_matmul and int8_conv: max |kernel - plain| in LSB, ms/plain_ms/bound_ms/"
        f"library_ms summed over one b1 896x1408 forward's launches (library: torch._int_mm "
        f"and the bf16 cuDNN conv, not the same functions), launches in 3 int8 forwards; "
        f"maxpool (C): max_abs_err fp32 0 (bit-equal), ms/plain_ms/library_ms (F.max_pool2d) "
        f"at the {masked_tag} stem (1,64,448,704) fp32, launches {pool_serving} serving + "
        f"{counts[3]} fp32 training + {counts16['C']} bf16 training + "
        f"{entry_counts['C']} entry points + "
        f"{fused_counts[0] + fused_bf16_counts[0]} fused serving; "
        f"fused_residual (D, SIMT) and "
        f"fused_bottleneck (E, SIMT), both called directly: max_abs_err fp32 "
        f"{fused_abs[('fused_residual', 'float32')]:.3e} and "
        f"{fused_abs[('fused_bottleneck', 'float32')]:.3e}, ms/plain_ms/bound_ms summed "
        f"over one b1 fp32 forward's launches ({masked_tag}: D x16; {exact_tag}: E x12; both "
        f"bounds on the fp32 pipes, the GEMM counted), no library call computes either (unfused "
        f"cuDNN chains printed above), launches in the 3 fused fp32 forwards (0: fp32 runs D-tf32 "
        f"and E-tf32) and the 2 fused bf16 ones (0: bf16 runs D-mma and E-mma); "
        f"fused_bottleneck_mma (E-mma): max_abs_err bf16 "
        f"{fused_abs[('fused_bottleneck_mma', 'bfloat16')]:.3e}, ms/plain_ms/bound_ms summed "
        f"over one b1 bf16 {exact_tag} forward's 12 launches, "
        f"launches {fused_counts[5]} in the 3 fused fp32 forwards + {fused_bf16_counts[5]} in "
        f"the 2 fused bf16 ones; fused_residual_mma (D-mma): max_abs_err bf16 "
        f"{fused_abs[('fused_residual_mma', 'bfloat16')]:.3e}, ms/plain_ms/bound_ms summed over "
        f"one b1 bf16 {masked_tag} forward's 16 launches (the unfused bf16 cuDNN chain, not the "
        f"same function, {d_mma_chain:.4f} ms), launches {fused_counts[2]} in the 3 fused fp32 "
        f"forwards + {fused_bf16_counts[2]} in the 2 fused bf16 ones; "
        f"fused_bottleneck_tf32 (E-tf32, 3xTF32): max_abs_err fp32 "
        f"{fused_abs[('fused_bottleneck_tf32', 'float32')]:.3e}, ms/plain_ms/bound_ms summed over "
        f"one b1 fp32 {exact_tag} forward's 12 launches (bound as 3xTF32 on the tensor cores; "
        f"the unfused fp32 cuDNN chain, not the same function, {tf32_chain:.4f} ms), launches "
        f"{fused_counts[6]} in the 3 fused fp32 forwards + {fused_bf16_counts[6]} in the 2 fused "
        f"bf16 ones; fused_residual_tf32 (D-tf32, 3xTF32): max_abs_err fp32 "
        f"{fused_abs[('fused_residual_tf32', 'float32')]:.3e}, ms/plain_ms/bound_ms summed over "
        f"one b1 fp32 {masked_tag} forward's 16 launches (bound as 3xTF32 on the tensor cores; the "
        f"unfused fp32 cuDNN chain, not the same function, {d_tf32_chain:.4f} ms), launches "
        f"{fused_counts[3]} in the 3 fused fp32 forwards + {fused_bf16_counts[3]} in the 2 fused "
        f"bf16 ones; torch's default TF32 flags against TF32 off, unfused fp32 800x1333 b1 "
        f"(a reading): boxes {tf32_errs['pred_boxes']:.3e}, logits {tf32_errs['pred_logits']:.3e}")
    log(smi)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
