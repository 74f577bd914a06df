#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``aa_rmvsnet_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failure exits non-zero:

1. device: the card's name and power limit, as ``nvidia-smi`` gives them;
2. build: every CUDA source of the port, compiled with nvcc;
3. kernel vs plain: the ConvLSTM gate kernel against its plain PyTorch
   version on the card, at the five cell shapes of a depth step of the
   inference main path (864x1152), at odd shapes, at ``hidden=3`` (2, 3,
   7, 5), whose plane is no multiple of the 16-byte vector, and with z
   and c as contiguous views one element into their storage, off the
   16-byte grid (the last two take the kernel's scalar path), and at the
   cell shapes of a spatial rank's slab (half the rows of 864x1152 and of
   128x160: 5i, 5h, 5k, 6f and 6g), fp32 (atol 1e-6) and bf16 (atol 2e-2), with
   the share of outputs at the five cells
   that differ from the plain version's; kernel, plain, library-call times
   and the kernel's bound per depth step, in fp32 and in bf16 (the
   inference main path's type); kernel and library-call times of one fp32
   depth step at the ``dtu_train`` cell shapes (128x160) with the inputs
   cold in device memory (launch-bound there, so no bound share); the
   registered custom op (``torch.ops.aa_rmvsnet_torch.lstm_gates``, the
   path of a traced program) on a cell, equal to the wrapper bit for bit
   with one launch; and the host's cost per call of the wrapper, of the
   custom op and of the library call;
3b. backward kernel vs plain: the same for the ConvLSTM gate-backward
   kernel at the same shapes, fp32 (atol 1e-5) and bf16 (atol 5e-2), its
   times in fp32 and
   in bf16 (the type of a bf16 training step) beside
   ``_thnn_fused_lstm_cell_backward_impl`` in the same type and the byte
   bound (bf16: half of fp32's bytes);
4. CUDA vs CPU: the whole ``forward`` at 64x80, V=3, D=48 on both devices
   (depth equal on >= 99.9 % of pixels, confidence atol 1e-4);
4b. CUDA vs CPU training gradients: one remat training forward and
   backward at 64x80, V=3, D=16, depth_block 8 on both devices.  Loss rtol
   1e-5.  Gradients: each tensor's max_abs_err over max(max|g|, 1e-3)
   (the normalised bar of ``tests/test_train.py:246-249``), worst tensor
   within max(1e-3, 10 x the CPU gradients' own move when every weight is
   scaled by 1 + 1e-7 noise).  The loss is piecewise smooth (ReLU,
   max-pool, the sampler's integer coordinates), and one rounding's worth
   of change in the weights already moves some gradients by more than
   1e-3 of their size: a fixed 1e-3 bar would test rounding, not the
   kernels.  The deformable convs' offset kernels start at zero, the
   reference's init, so that no deform sample sits within an ulp of an
   integer coordinate, where the sampler's gradient jumps;
4h. CUDA vs CPU training with the JAX package's levers: 4b's step with
   ``TrainConfig(fold_omega=True)`` and ``"hybrid"`` at 4b's bars, and
   with ``feature_dtype=torch.bfloat16`` (the sweep in bf16 on the fp32
   weights cast in the graph), 2 x 5 x D forward and 5 x D backward
   launches each, all of the bf16 instantiations in bf16.  A bf16 cast
   absorbs 1e-7 weight noise (most draws change no bf16 weight), so the
   bf16 step's bars come from the CPU's own move under noise of one bf16
   rounding (2^-8), as the root mean square over 8 draws (one draw's loss
   move varies tenfold, and the card's bf16 step is not deterministic):
   the loss, the worst and the median gradient tensor of each of two runs
   on the card within twice that move (the output conv's bias, whose exact
   gradient is 0, printed apart);
4e. CUDA vs CPU evidential training: one step of ``cli train
   --evidential``'s loss (``pipeline/train.py:evidential_loss_fn``: the
   remat sweep, the probability volume, the head in train mode,
   ``loss_emvsnet``) and its backward at 64x80, V=3, D=16, depth_block 8,
   maxdisp 16 on both devices, with seeded core and head.  Loss rtol 1e-5;
   the worst gradient over core and head, and the worst updated BatchNorm
   statistic, each within max(1e-3, 10 x the CPU's own move under 1e-7
   weight noise), as 4b; 2 x 5 x D forward and 5 x D backward gate-kernel
   launches;
4c. packed vs exact on the card, fp32, at 64x80, V=3, D=48: the packed-row
   warp, gather_pack=2, and 6x6 tables with gather_pack=2 on a scene whose
   16-hypothesis span lies between 2 and 4 px, each against the unpacked
   path (depth equal on >= 99.9 % of pixels, cost volume atol 5e-4,
   confidence atol 1e-4), with the mode the gate picks asserted; the fused
   residual equal to the unfused one bit for bit;
4d. the JAX package's bf16 guardrail (``tests/test_models.py:782-821``) on
   the card: 256x320, V=3, D=128, the bf16 packed path against the exact
   fp32 one, >= 95 % of pixels within one depth bin, and >= 99.9 % of the
   pixels whose fp32 confidence exceeds 0.3 where those are more than half
   the map (their share is printed either way).  The weights are
   ``utils/synthetic.py:matching_model``'s (He-normal FeatNet and omega, a
   regularizer that passes the photometric cost through): the guardrail
   was set for trained weights, and random ones leave the costs flat;
4f. the quantized levers, CUDA against CPU, fp32, at 64x80, V=3, D=48
   (``SweepConfig.table_dtype`` / ``residual_dtype``: fp8 tables unpacked,
   int8 tables packed, fp8, int8 and dual residuals with fp8 tables, the
   fp8 residual with ``fold_omega=True``, and the production stack: int8
   tables, dual residual, gather_pack 2, 6x6 tables, fused), each with
   depth equal on >= 99 % of pixels and confidence atol 1e-3 (an fp8 cast
   turns the devices' ~1e-6 feature differences into whole fp8 steps at
   rounding boundaries); fp8 and int8 tables built on the card equal to
   the CPU's bit for bit; the int8 blend (``ops/patch_sample.py:int8_blend``)
   and omega's int8 rw0 convolution (``models/aggregation.py:int8_conv``)
   equal to integer-exact references (an int64 product sum; a float64
   convolution, exact for these integers) rounded once, bit for bit,
   including sums at their bounds (580,644 and 4,645,152), the
   convolution at the ``dtu_eval`` shape;
4g. the JAX package's lever guardrails (``tests/test_models.py:306-345``
   and ``:637-690``) on the card, on phase 4d's scene with
   ``matching_model(sharpness=1000)`` weights (so that most pixels are
   confident): each lever in bf16 (the residuals with int8 tables, as in
   the production stack) against the bf16 packed path without levers,
   >= 90 % of pixels within one bin and, for the residuals and the
   production stack, >= 99 % of the confident pixels (the base's
   confidence > 0.3, asserted to be more than half the map); the int8
   residual misses that bar on these
   weights in the JAX package too (``tests/test_torch_quant_pipeline.py``),
   so its shares are printed beside the dual residual's, which must beat
   them;
4i. the JAX package's int8 omega chain (``AA_RMVSNET_OMEGA_INT8=chain``,
   ``models/aggregation.py:_omega_chain``), CUDA against CPU at 64x80 with
   8 folded volumes on seeded bf16 omega weights: each of its four int8
   stages equal to an integer-exact reference (a float64 convolution of
   its own int8 inputs) rounded once, bit for bit, on both devices; the
   card's stage inputs equal to the CPU's on >= 99.9 % of activations, none
   off by more than 1; the weights within 2^-6 of the CPU's; the chain
   against the base int8 path within the JAX package's bars (mean < 0.03,
   max < 0.25); then on 4g's scene the dual residual and the production
   stack with the chain, each >= 90 % of pixels and >= 99 % of the
   confident ones within one bin of the bf16 packed path;
5. main path, inference: ``run_inference`` with ``InferConfig()``'s
   defaults (bf16, packed rows where the gate passes, fused residual) at
   the ``dtu_eval`` geometry (V=5, D=512, 864x1152, depth_block 8) on an
   in-memory synthetic plane scene (``utils/synthetic.py``; cameras 2
   apart, so that the 4x4 gate passes) for two reference views, with the
   packed mode (True, 1, 4) of both maps and the gate kernels' launch
   counts asserted (5 x D x maps forward, no backward), the gate's worst
   step and host seconds printed;
5b. the exact path kept: one map of the same scene with ``--fp32
   --packed_rows 0``'s settings, its launch count asserted, and the share
   of its depths within one bin of the bf16 packed map's; then the same
   map in fp32 with packed rows (``--fp32``, mode (True, 1, 4)) with the
   seeded head attached (depth from the core), its launch count asserted:
   the serial maps that 5i's fp32 runs, and 5l's head on them, are held to;
5c. the evidential head: alone, CUDA against CPU at 32x40, D=32, fp32 with
   seeded weights (``utils/synthetic.py:seeded_head``), at the CPU tests'
   bars (gamma 2e-3; nu, alpha, beta 1e-3; prob_combine 1e-4); then the
   main path with a head, ``cli eval --evidential_ckpt``'s: ``run_inference``
   with ``InferConfig()``'s defaults, a seeded head and ``depth_source
   evidential``, for one map of the phase-5 scene, with its packed mode,
   5 x D forward and no backward gate-kernel launches asserted, the four
   PFM families finite, gamma inside the sweep, nu > 0 and alpha > 1; it
   prints the core's and the head's seconds and the peak memory of the
   core with the collected volume and of the head, and keeps the head's
   probability volume and maps for 5l;
5d. the JAX package's production stack (``cli eval --int8_tables
   --dual_residual --gather_pack 2 --table_taps 6``): ``run_inference``
   with those levers for one map of the phase-5 scene, its packed mode
   (True, 2, 4) and 5 x D forward and no backward gate-kernel launches
   asserted, its seconds and peak memory printed beside phase 5's, and the
   share of its depths within one bin of phase 5's map;
5j. the production stack with the int8 omega chain: 5d's map again with
   ``AA_RMVSNET_OMEGA_INT8=chain``, its mode, 5 x D forward and no backward
   launches and omega's 4 int8 convolutions a call (5d: 1) asserted, its
   seconds and peak memory beside 5d's, and its depths within one bin of
   5d's map on no fewer pixels than 5d's are of phase 5's;
5f. the eval fan-out (``cli eval --fanout 2``): ``run_inference`` with
   ``InferConfig()``'s defaults under ``make_mesh(data=2)``, two gloo ranks
   on ``cuda:0`` (NCCL refuses two ranks on one card), each building phase
   5's scene from its seed and taking one of its two maps; each map held
   to phase 5's (depth equal on >= 99.9 % of pixels, confidence atol 1e-4,
   and whether bit for bit), packed modes (True, 1, 4), 5 x D x maps
   forward launches over the ranks, seconds per map and peak memory by
   rank;
5g. the depth pipeline (``cli eval --depth_stages 2 --pipeline_maps 2``):
   the same under ``make_mesh(depth=2)``, two gloo stages on ``cuda:0``
   sweeping 256 hypotheses each of both maps, the ConvLSTM carry handed on
   through pinned host memory; held to phase 5's maps at 5f's bars, packed
   modes (True, 1, 4), the same launch count, the seconds of the group
   and the peak memory by stage; then the carry's handoff timed alone at
   the map's shape (5 cells' (h, c) of seeded values in bf16), three
   times from a barrier: stage 0's ``send_carry`` until its send
   completes, stage 1's ``recv_carry`` until the carry is on its card,
   with the bytes checked;
5i. the spatial split (``cli eval --spatial 2``): the same under
   ``make_mesh(spatial=2)`` for phase 5's first map, two gloo ranks on
   ``cuda:0`` each sweeping its 432 rows of every view, with the halo
   exchanges, row gathers and GroupNorm all-reduces of
   ``parallel/spatial.py``, three times: with ``InferConfig()``'s defaults
   (bf16, packed rows), a smoke check held to 5b's exact map no farther
   than phase 5's bf16 map is, with the count and seconds of each rank's
   all-gathers and all-reduces (each timed between two synchronises, which
   slows the map); in fp32 with packed rows and on the exact fp32 path,
   each held to 5b's serial map of the same settings at 5f's bars; each
   with its packed mode, 5 x D forward launches a rank with 432x1152 the
   largest plane the gate kernel ran on, the seconds and the peak memory
   by rank (the fp32 packed run's with the head of 5l).  5f, 5g, 5i and 5l
   run in one pair of rank subprocesses with a deadline;
5l. the evidential head split over the spatial axis (``cli eval --spatial
   2 --evidential_ckpt``): 5c's probability volume (864x1152, D=512, fp32)
   split over two gloo ranks on ``cuda:0``, each running the seeded head on
   its 432 rows (``EvidentialHead.forward(..., mesh)``: every 3D
   convolution with its halo rows), the four maps gathered to rank 0 held
   to 5c's at the CPU bars on every pixel, each rank's seconds and peak
   memory while the head runs beside 5c's one process; then 5i's fp32
   packed-rows run with the seeded head attached (each rank's head on its
   rows of the collected volume, 5 x D forward launches a rank): each
   rank's four maps of its rows, joined, held to 5b's serial run with the
   head at those bars on >= 99.9 % of pixels, the aleatoric and epistemic
   PFMs finite;
5h. the commands a user runs, ``python -m aa_rmvsnet_tpu_torch.cli eval
   --fanout 2`` and then ``--spatial 2``, with phase 5's flags (``--preset
   dtu_eval``, D=512, depth block 8, bf16 and packed rows by default) on
   phase 5's scene written as a scene directory: each command starts its
   two ranks on ``cuda:0`` over gloo itself; its first line, its exit code
   and its maps, held to phase 5's at 5f's bars (``--spatial 2``'s bf16
   map by 5i's smoke check), are checked.  The card's machine has no cv2, so the
   scene's images are written as ``.npy`` arrays under their ``.jpg``
   names and decoded by a stand-in ``cv2`` module (``imread`` by
   ``np.load``, ``cvtColor`` a channel flip) put first on the command's
   ``PYTHONPATH``; all past the decode is the command's own;
5k. view with spatial: ``make_mesh(view=2, spatial=2)``, four gloo ranks on
   ``cuda:0``, phase 5's map 0 with D cut to 64 (the plane in mid-sweep),
   exact fp32: ``forward`` on the mesh (each rank its view rank's 2 source
   views on its 432 rows, the features gathered over the spatial group,
   the view mean merged over the view group) and ``run_inference`` on it
   (the view ranks as replicas), each held to this process's serial exact
   map at 5f's bars (each view rank's map for ``forward``; how far the view
   ranks' maps lie apart printed), 5 x D forward launches a rank a run,
   seconds and peak memory by rank;
6. main path, training: ``run_training`` at the ``dtu_train`` geometry
   (128x160, V=5, D=128, depth_block 16, batch 1, Adam 1e-3 on the
   cosine schedule of a 10-epoch DTU run) for 8 steps on one synthetic
   plane sample, with a falling loss, 2 x 5 x D forward and 5 x D
   backward gate-kernel launches per step (forward, recompute, backward),
   and a checkpoint that restores bit for bit and trains one more step;
6b. main path, evidential training (``cli train --evidential``):
   ``run_training`` with ``evidential=True`` at the same geometry and
   maxdisp 32, the seeded core and a fresh head from seed 1 (the JAX
   init, as ``cli train`` draws it), 8 steps on the phase-6 sample, with
   the same launch counts per step, a falling finite loss, BatchNorm
   running statistics that changed, and a checkpoint that restores core,
   head, statistics and Adam moments bit for bit and trains one more
   step; it prints the seconds of each step and the peak memory;
6c. main path, bf16 training: ``run_training`` with
   ``feature_dtype=torch.bfloat16`` at phase 6's geometry, 8 steps, with
   2 x 5 x D forward and 5 x D backward launches a step, all bf16, a
   falling finite loss and fp32 master weights that moved; seconds per
   step and peak memory beside phase 6's; then one step with
   ``fold_omega=True`` (fp32), its launches, seconds and peak memory;
6d. main path, data-parallel training: two processes on ``torch.distributed``
   (gloo, both ranks on cuda:0: NCCL refuses two ranks on one card) at
   batch 1 each, rank 1 with half its pixels masked, against this process
   at batch 2, for the core and for the evidential head (maxdisp 32): the
   ranks' weights equal bit for bit, the loss rtol 1e-5, the worst
   gradient within max(2e-4, 10 x the batch-2 step's own move under 1e-7
   weight noise), the updated weights 1e-6 where the gradient's sign is
   settled (twice the rate elsewhere: Adam's first step), the BatchNorm
   statistics 1e-5 of their size; seconds per step and peak memory of a
   rank; then a world-size-1 NCCL group's step against the step without a
   mesh, with its all-reduces counted (at least one under the mesh, none
   without).  The ranks are subprocesses with a free port and a deadline;
6e. view-sharded training: ``TrainConfig(mesh=make_mesh(view=2))`` at
   phase 6's geometry, two gloo ranks on ``cuda:0`` each sweeping 2 of the
   4 source views of one sample, against this process's step on it, for
   the core and the evidential head, at 6d's bars, with 2 x 5 x D forward
   and 5 x D backward launches a rank (6d's and 6e's ranks take the core
   and then the head in one launch);
6f. spatial training: ``TrainConfig(mesh=make_mesh(spatial=2))`` at phase
   6's geometry, two gloo ranks on ``cuda:0`` each stepping on its 64 rows
   of the sample (every row-split op differentiated, the remat recompute
   re-issuing its collectives), against this process's step on the whole
   sample, for the core, at 6d's bars, with 2 x 5 x D forward and 5 x D
   backward launches a rank;
6g. spatial evidential training: ``TrainConfig(evidential=True,
   mesh=make_mesh(spatial=2))`` at 6f's geometry with maxdisp 32, each rank
   running the head on its rows of the cost volume and the labels (the
   head's BatchNorm statistics summed over the ranks), against this
   process's evidential step at 6d's bars, the ranks equal bit for bit
   after the step, each rank's peak memory beside PR 15's 4.30 GiB (the
   head on the gathered volume), with 2 x 5 x D forward and 5 x D backward
   launches a rank;
7. the fusion kernel (``ops/fusion.py:fuse_ref``) against its plain
   version, bit for bit on the card and on the CPU: one 864x1152 reference
   view of a noisy plane against 10 sources, with how many of its terms lie
   within 1e-12, 1e-9 and 1e-6 of a threshold, and inputs with every
   special depth and sources projecting outside (1 and ``MAX_SOURCES``
   sources; 1, 9 and 16 levels); its division against IEEE division on
   2^24 operand pairs; its time per reference view against its bound;
7b. a 49-view scan fused in memory (``fuse_views``), one kernel launch per
   reference view;
7c. depth maps, fusion and quality end to end on a plane;
8. export (``utils/export.py``): ``export_forward`` of seeded weights at the
   JAX package's export defaults ((1, 3, 64, 80, 3), D=16, depth block 8,
   fp32, unpacked) on a plane scene, its graph holding the gate kernel as
   the custom op ``aa_rmvsnet_torch::lstm_gates`` 5 x D times and no
   ``tanh``; the exported program run on the card, with exactly 5 x D
   gate-kernel launches, against eager ``forward`` on the same inputs
   (depth and confidence bit for bit; failing that, held to the card's
   bars, depth equal on >= 99.9 % of pixels and confidence 1e-4, with the
   differences printed); the serialised program written, loaded with
   ``load_and_call`` and equal to the program it came from; the same for
   ``export_evidential`` of a seeded head at (1, 32, 64, 80), maxdisp 32,
   held to eager at the head's CPU bars, and its round trip through
   ``save_exported_evidential`` held to the program at the same bars
   (cuDNN's transposed 3D convolutions may sum in another order from one
   call to the next: eager run twice is printed beside them).

Before the total, a line gives each phase's seconds.  The line before the
last is ``{"kernels": [...]}``; each kernel's
``launches`` is its count on the training main path (phase 6), and
``launches_by_path`` gives it for every main path (phases 5, 5b, 5c, 5d,
5j (``inference_levers_omega_chain``), 5f (``inference_fanout``), 5g
(``inference_depth_pipeline``), 5i (``inference_spatial``,
``inference_spatial_packed_fp32``, ``inference_spatial_fp32``; its
fp32 packed run carries 5l's head, so ``inference_spatial_evidential`` is
the same run's count) and 5k (``inference_view_spatial``), 6, 6b, 6c
(``training_bf16``,
``training_fold_omega``), 6d (``training_data_parallel``), 6e
(``training_view_parallel``), 6f (``training_spatial``) and 6g
(``training_spatial_evidential``), the ranks' sums, 7c and 8);
``ms``, ``plain_ms``, ``bound_ms`` and ``library_ms`` are fp32 times per
depth step, and the gate kernels' ``*_bf16`` keys the same in bf16;
``ms_train_shapes`` and ``library_ms_train_shapes`` are fp32 times per
``dtu_train`` depth step, and ``host_us_per_call`` and
``library_host_us_per_call`` the host's cost of one call (the forward's
``op_host_us_per_call`` that of the registered custom op, which only a
traced program calls).  Device times
come from CUDA events around runs queued behind a sleep on the device
(``dtu_eval`` shapes) or a 1 GiB write (``dtu_train`` shapes), so that they
time the device and not the host.  The last line is
``{"ok": true, "device": {...}}``.  Weights are random, made from a seed
(``utils/synthetic.py:seeded_model``).
TF32 is off throughout: cuDNN would otherwise run the fp32 convolutions in
TF32, which keeps about three decimal digits.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

SEED = 0
# Main path: the dtu_eval preset geometry.
MAIN_H, MAIN_W, MAIN_V, MAIN_D, MAIN_BLOCK, MAIN_MAPS = 864, 1152, 5, 512, 8, 2
MAIN_DEPTH_MIN, MAIN_DEPTH_INTERVAL = 425.0, 1.0
# Cameras 2 apart: the worst depth step moves a sample < 0.1 px, so 8
# hypotheses span < 1 px and the 4x4 packed gate passes.
MAIN_PLANE = dict(seed=SEED + 3, focal=2000.0, baseline=2.0, plane_depth=600.0)
# Small whole-path check, CUDA against CPU, and packed against exact.
SMALL_H, SMALL_W, SMALL_V, SMALL_D = 64, 80, 3, 48
# The bf16 guardrail of the JAX package; the levers' guardrail scene's
# depth step.
GUARD_H, GUARD_W, GUARD_V, GUARD_D = 256, 320, 3, 128
GUARD_INTERVAL = 2.5
# Small training check, CUDA against CPU; the evidential one's maxdisp.
GRAD_D, GRAD_BLOCK, GRAD_MAXDISP = 16, 8, 16
# Draws of 2^-8 weight noise that calibrate the small bf16 training check.
BF16_NOISE_DRAWS = 8
# The evidential head alone, CUDA against CPU, and its bars (those of
# tests/test_torch_evidential.py).
EV_H, EV_W, EV_D = 32, 40, 32
EV_BARS = {"gamma": 2e-3, "nu": 1e-3, "alpha": 1e-3, "beta": 1e-3, "prob_combine": 1e-4}
# Training main path: the dtu_train preset geometry, 8 steps; the
# evidential head's maxdisp there (cli train --evidential's default).
TRAIN_H, TRAIN_W, TRAIN_V, TRAIN_D, TRAIN_BLOCK, TRAIN_STEPS = 128, 160, 5, 128, 16, 8
TRAIN_MAXDISP = 32
# Cosine schedule length of a 10-epoch DTU run: 79 training scans x 49
# reference views x 7 lights x 2 sweep directions per epoch.
DTU_TRAIN_TOTAL_STEPS = 10 * 79 * 49 * 7 * 2
# The automatic depth block's second geometry: tnt_intermediate_1920 (7
# views), one map, D cut from 512 to 64 (the sweep's peak depends on the
# block, not on D).
TNT_H, TNT_W, TNT_V, TNT_D = 1056, 1920, 7, 64
# The estimate of the automatic depth block, against the measured peak.
ESTIMATE_BAR = 0.20
# Fusion: a DTU-sized scan at the dtu_eval prediction geometry, 49 views of
# a plane with 10 sources each, images at DTU's 1200x1600 (so that the
# resize to the prediction runs), depths the plane plus noise that puts
# pixels on every side of each level's thresholds (level i passes a
# relative depth error under i/1300, 0.92 i at 600).
FUSE_VIEWS, FUSE_SRCS, FUSE_IMG_H, FUSE_IMG_W, FUSE_LEVELS = 49, 10, 1200, 1600, 9
FUSE_FOCAL, FUSE_BASELINE, FUSE_PLANE, FUSE_NOISE = 2000.0, 2.0, 600.0, 3.0
# How close phase 7's terms come to a threshold; the fusion kernel's edge
# cases (utils/synthetic.py:fusion_edge_case) at an odd size, with 1 and
# MAX_SOURCES sources and these level counts.
NEAR_TOLERANCES = (1e-12, 1e-9, 1e-6)
EDGE_H, EDGE_W, EDGE_LEVELS = 75, 101, (1, 9, 16)
# Operand pairs on which the fusion kernel's division is held to IEEE's.
DIVISION_PAIRS = 1 << 24
# The chain: run_inference, fusion and quality on a plane scene at 864x1152,
# 4 maps, D cut from 512 to 128 at 2.5 a step, with matching_model weights.
CHAIN_MAPS, CHAIN_D, CHAIN_DEPTH_MIN, CHAIN_INTERVAL = 4, 128, 440.0, 2.5
# The JAX package's switch of the int8 omega chain (4i, 5j).
OMEGA_CHAIN = "AA_RMVSNET_OMEGA_INT8"
# View with spatial (5k): phase 5's map 0 with D cut from 512 to 64, the
# plane (at 600) in the middle of the sweep.
VS_D, VS_DEPTH_MIN = 64, 568.0
# Export (phase 8) at the JAX package's export defaults: the forward at
# (1, 3, 64, 80, 3), D=16, depth block 8, fp32, unpacked; the head at
# (1, 32, 64, 80), maxdisp 32.
EXPORT_SHAPE, EXPORT_D, EXPORT_BLOCK = (1, 3, 64, 80, 3), 16, 8
EXPORT_HEAD_SHAPE, EXPORT_MAXDISP = (1, 32, 64, 80), 32
# The H100 SXM's float64 rate outside the tensor cores (NVIDIA's data
# sheet), the fusion kernel's operations bound.  The rate counts an FMA as
# two operations: 64 FMA lanes an SM x 2 x 132 SMs x ~1.98 GHz.
FP64_PER_S = 34e12


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ~25 ms of device sleep at the H100's clock, longer than the host takes to
# queue the launches of one timing.
HOST_AHEAD_CYCLES = 50_000_000


def _cuda_time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, by CUDA events.  The
    runs are queued behind a sleep on the device, so that the events time
    the device and not the host's cost of issuing the launches."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOST_AHEAD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def memory_bytes_per_s() -> float:
    """Peak device-memory rate from the card's own clock and bus width
    (double data rate)."""
    props = torch.cuda.get_device_properties(0)
    return props.memory_clock_rate * 1e3 * 2 * props.memory_bus_width / 8


def phase_device() -> None:
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False; this script needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, memory rate "
          f"{memory_bytes_per_s() / 1e12:.3f} TB/s (from clock and bus width)",
          flush=True)


def phase_build() -> None:
    from aa_rmvsnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {len(libs)} CUDA source(s) in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(p.name for p in libs), flush=True)


def _cell_shapes(H, W):
    """(B, hidden, h, w) of the five ConvLSTM cells of one depth step."""
    return [(1, 16, H, W), (1, 16, H // 2, W // 2), (1, 16, H // 4, W // 4),
            (1, 16, H // 2, W // 2), (1, 8, H, W)]


def _slab_cell_shapes():
    """The cells of a spatial rank's slab on two ranks: half the rows of
    phase 5's map (5i, 5h, 5k) and of phase 6's (6f, 6g)."""
    return _cell_shapes(MAIN_H // 2, MAIN_W) + _cell_shapes(TRAIN_H // 2, TRAIN_W)


def _library_gates(zl, zeros, cl):
    """The same gate math as one PyTorch call (``nn.LSTMCell``'s fused CUDA
    cell), on ``(N, 4h)`` gates in its (i, f, g, o) order plus a zero
    hidden-gate tensor.  A yardstick only: the port never calls it."""
    return torch.ops.aten._thnn_fused_lstm_cell(zl, zeros, cl)


def _to_library_layout(z, c):
    B, h4, H, W = z.shape
    h = h4 // 4
    zr = z.view(B, 4, h, H, W)[:, [0, 1, 3, 2]]  # (i, f, o, g) -> (i, f, g, o)
    zl = zr.permute(0, 3, 4, 1, 2).reshape(B * H * W, 4 * h).contiguous()
    cl = c.permute(0, 2, 3, 1).reshape(B * H * W, h).contiguous()
    return zl, cl


def _library_inputs(z, c):
    """The library call's inputs for ``(z, c)``: the ``(N, 4h)`` layout and
    its zero hidden gates, made once so that no timing includes them."""
    zl, cl = _to_library_layout(z, c)
    return zl, torch.zeros_like(zl), cl


def _at_storage_offset(t):
    """A contiguous copy of ``t`` that starts one element into its storage,
    so that its data pointer is off the 16-byte grid."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def _host_us(fn, calls: int = 1000, rounds: int = 3) -> float:
    """Host microseconds per call of ``fn()``: the least over ``rounds``
    rounds of ``calls`` calls each, with no synchronisation inside a round
    (the least, since the host's other work only adds time)."""
    for _ in range(10):
        fn()
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / calls * 1e6


def phase_kernel() -> dict:
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.utils.device import device_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cells = _cell_shapes(MAIN_H, MAIN_W)
    # (shape, z and c one element into their storage): the cells, the
    # spatial split's (a rank's slab of half the rows, in inference and in
    # training) and the odd shapes take the 16-byte path; hidden=3 (a plane
    # of 105) and the offset views the scalar one.
    cases = [(shape, False) for shape in dict.fromkeys(
        cells + _slab_cell_shapes() + [(2, 16, 9, 13), (2, 8, 9, 13), (2, 3, 7, 5)])]
    cases.append(((2, 16, 9, 13), True))
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    bars = {torch.float32: 1e-6, torch.bfloat16: 2e-2}
    inputs = {torch.float32: [], torch.bfloat16: []}  # the five cells' (z, c)
    unequal = {torch.float32: [0, 0], torch.bfloat16: [0, 0]}  # at the cells: differ, all
    times = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for shape, offset in cases:
                B, h, H, W = shape
                z = torch.randn(B, 4 * h, H, W, device="cuda", generator=gen)
                if dtype == torch.float32:
                    c = torch.randn(B, h, H, W, device="cuda", generator=gen)
                else:
                    # |c'| < 2 keeps one bf16 ulp of the output (<= 2^-7)
                    # inside the 2e-2 bar; larger cells round across ulps.
                    c = torch.rand(B, h, H, W, device="cuda", generator=gen) * 2 - 1
                z, c = z.to(dtype), c.to(dtype)
                if offset:
                    z, c = _at_storage_offset(z), _at_storage_offset(c)
                h_k, c_k = gates.lstm_gates(z, c)
                torch.cuda.synchronize()
                h_p, c_p = gates.lstm_gates_reference(z, c)
                err = max((h_k.float() - h_p.float()).abs().max().item(),
                          (c_k.float() - c_p.float()).abs().max().item())
                ok = err <= bars[dtype]
                print(f"kernel: lstm_gates {str(dtype)[6:]} {shape}"
                      f"{' z, c at storage offset 1' if offset else ''} max_abs_err "
                      f"{err:.3e} (bar {bars[dtype]:g}) {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    _fail(f"lstm_gates disagrees with its plain version at {shape} {dtype}")
                max_err[dtype] = max(max_err[dtype], err)
                if shape in cells and not offset:
                    inputs[dtype].append((z, c))
                    unequal[dtype][0] += (h_k != h_p).sum().item() + (c_k != c_p).sum().item()
                    unequal[dtype][1] += 2 * c.numel()

        for dtype, step_inputs in inputs.items():
            # One depth step's five launches in main-path order: 0.92 GB in
            # fp32, 0.46 GB in bf16, far beyond the 50 MB L2, so each launch
            # finds its inputs cold.
            def kernel_step():
                for z, c in step_inputs:
                    gates.lstm_gates(z, c)

            def plain_step():
                for z, c in step_inputs:
                    gates.lstm_gates_reference(z, c)

            lib_inputs = [_library_inputs(z, c) for z, c in step_inputs]
            lib_err = 0.0
            for (z, c), args in zip(step_inputs, lib_inputs):
                hy, cy, _ = _library_gates(*args)
                h_p, c_p = gates.lstm_gates_reference(z, c)
                B, h, H, W = c.shape
                h_p = h_p.permute(0, 2, 3, 1).reshape(-1, h)
                c_p = c_p.permute(0, 2, 3, 1).reshape(-1, h)
                lib_err = max(lib_err, (hy.float() - h_p.float()).abs().max().item(),
                              (cy.float() - c_p.float()).abs().max().item())
            if lib_err > (1e-5 if dtype == torch.float32 else bars[dtype]):
                _fail(f"library yardstick computes another function in {dtype} "
                      f"(err {lib_err:.3e})")

            def library_step():
                for args in lib_inputs:
                    _library_gates(*args)

            ms = _cuda_time_ms(kernel_step, reps=50)
            plain_ms = _cuda_time_ms(plain_step, reps=10)
            library_ms = _cuda_time_ms(library_step, reps=20)
            ms_again = _cuda_time_ms(kernel_step, reps=50)
            del lib_inputs

            elems = sum(B * h * H * W for B, h, H, W in cells)
            nbytes = elems * step_inputs[0][0].element_size() * (4 + 1 + 2)  # i, f, o, g, c; h', c'
            bytes_ms = nbytes / memory_bytes_per_s() * 1e3
            # ~30 fp32 operations per element (3 sigmoids, 2 tanh, 3 FMAs) at
            # the card's 67 TFLOP/s non-tensor fp32 peak, whatever the storage
            # type: far under the byte bound.
            ops_ms = elems * 30 / 67e12 * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            times[dtype] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                bound_ms=bound_ms,
                                bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            differ, total = unequal[dtype]
            print(f"kernel: {str(dtype)[6:]}, one depth step = 5 launches, "
                  f"{elems / 1e6:.2f} M elements, {nbytes / 1e9:.3f} GB: kernel {ms:.4f} ms "
                  f"(again {ms_again:.4f}), plain {plain_ms:.4f} ms, library "
                  f"{library_ms:.4f} ms (_thnn_fused_lstm_cell, max_abs_err vs plain "
                  f"{lib_err:.1e}), bound {bound_ms:.4f} ms by bytes ({bound_ms / ms:.0%} "
                  f"of it); outputs unequal to the plain version's {differ / total:.4%}",
                  flush=True)

        # The training main path's shapes (fp32): one depth step at
        # dtu_train, 0.68 M elements, 19 MB.  The forward of a remat block's
        # recompute finds its inputs in device memory, so a 1 GiB buffer is
        # written between runs (see phase 3b).
        train_cells = _cell_shapes(TRAIN_H, TRAIN_W)
        train_inputs = [(torch.randn(B, 4 * h, H, W, device="cuda", generator=gen),
                         torch.randn(B, h, H, W, device="cuda", generator=gen))
                        for B, h, H, W in train_cells]
        train_lib_inputs = [_library_inputs(z, c) for z, c in train_inputs]
        flush = torch.empty(2**28, device="cuda")

        def train_kernel_step():
            for args in train_inputs:
                gates.lstm_gates(*args)

        def train_library_step():
            for args in train_lib_inputs:
                _library_gates(*args)

        train_ms = device_ms(train_kernel_step, flush)
        train_library_ms = device_ms(train_library_step, flush)
        train_ms_again = device_ms(train_kernel_step, flush)
        train_library_ms_again = device_ms(train_library_step, flush)
        del flush

        # The custom op a traced program calls: the same kernel, one launch.
        small, small_lib = train_inputs[2], train_lib_inputs[2]
        before = gates.launches
        h_op, c_op = gates.lstm_gates_op(*small)
        torch.cuda.synchronize()
        h_w, c_w = gates.lstm_gates(*small)
        if gates.launches - before != 2 or not (torch.equal(h_op, h_w)
                                                and torch.equal(c_op, c_w)):
            _fail(f"the custom op and the wrapper launched {gates.launches - before} "
                  "kernels for a call each, or they disagree")

        # The host's cost of one call at the smallest dtu_train cell, in turns.
        host_us = [_host_us(lambda: gates.lstm_gates(*small))]
        op_host_us = [_host_us(lambda: gates.lstm_gates_op(*small))]
        library_host_us = [_host_us(lambda: _library_gates(*small_lib))]
        library_host_us.append(_host_us(lambda: _library_gates(*small_lib)))
        op_host_us.append(_host_us(lambda: gates.lstm_gates_op(*small)))
        host_us.append(_host_us(lambda: gates.lstm_gates(*small)))

    train_elems = sum(B * h * H * W for B, h, H, W in train_cells)
    print(f"kernel: forward at the dtu_train cell shapes ({TRAIN_H}x{TRAIN_W}), fp32, one "
          f"depth step = 5 launches, {train_elems / 1e6:.3f} M elements, inputs cold in "
          f"device memory: kernel {train_ms * 1e3:.2f} us (again {train_ms_again * 1e3:.2f}), "
          f"{train_ms * 1e3 / 5:.2f} us a launch; library {train_library_ms * 1e3:.2f} us "
          f"(again {train_library_ms_again * 1e3:.2f}), {train_library_ms * 1e3 / 5:.2f} us "
          "a launch; launch-bound at these shapes, so no bound share", flush=True)
    print(f"kernel: custom op aa_rmvsnet_torch::lstm_gates on {train_cells[2]}: equal to "
          "the wrapper bit for bit, one launch", flush=True)
    print(f"kernel: host cost per call at {train_cells[2]}, 1000 calls, no sync, no "
          f"autograd graph: wrapper gates.lstm_gates {host_us[0]:.2f}, {host_us[1]:.2f} us; "
          f"custom op {op_host_us[0]:.2f}, {op_host_us[1]:.2f} us; library call "
          f"{library_host_us[0]:.2f}, {library_host_us[1]:.2f} us", flush=True)
    fp32, bf16 = times[torch.float32], times[torch.bfloat16]
    return {
        "name": "lstm_gates",
        "route": "cuda",
        "source": "aa_rmvsnet_tpu_torch/csrc/lstm_gates.cu",
        "replaces": "aa_rmvsnet_tpu/ops/pallas/gates.py:41",
        "launches": None,
        "max_abs_err": max_err[torch.float32],
        **fp32,
        **{f"{k}_bf16": v for k, v in bf16.items()},
        "max_abs_err_bf16": max_err[torch.bfloat16],
        "ms_train_shapes": train_ms,
        "library_ms_train_shapes": train_library_ms,
        "host_us_per_call": min(host_us),
        "op_host_us_per_call": min(op_host_us),
        "library_host_us_per_call": min(library_host_us),
    }


def _library_gates_backward(dhl, dcl, cl, cyl, workspace):
    """The same backward as one PyTorch call (``nn.LSTMCell``'s fused CUDA
    cell backward), on the ``(N, 4h)`` layout with the forward's workspace
    of activated gates.  A yardstick only: the port never calls it."""
    return torch.ops.aten._thnn_fused_lstm_cell_backward_impl(dhl, dcl, cl, cyl,
                                                              workspace, False)


def _backward_library_inputs(z, c, dh, dcn):
    """The library backward's inputs for the same function: the ``(N, 4h)``
    layout and the forward's workspace of activated gates."""
    zl, zeros, cl = _library_inputs(z, c)
    _, cyl, workspace = _library_gates(zl, zeros, cl)
    h = c.shape[1]
    dhl = dh.permute(0, 2, 3, 1).reshape(-1, h).contiguous()
    dcl = dcn.permute(0, 2, 3, 1).reshape(-1, h).contiguous()
    return dhl, dcl, cl, cyl, workspace


def phase_backward_kernel() -> dict:
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.utils.device import device_ms

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cells = _cell_shapes(MAIN_H, MAIN_W)
    # (shape, z and c one element into their storage): the cells and the
    # spatial split's take the 16-byte path; hidden=3 (a plane of 105) and
    # the offset views the scalar one.
    cases = [(shape, False) for shape in dict.fromkeys(
        cells + _slab_cell_shapes() + [(2, 16, 9, 13), (2, 8, 9, 13), (2, 3, 7, 5)])]
    cases.append(((2, 16, 9, 13), True))
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    bars = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
    step_inputs = {torch.float32: [], torch.bfloat16: []}  # the five cells' inputs
    times = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for shape, offset in cases:
                B, h, H, W = shape
                z = torch.randn(B, 4 * h, H, W, device="cuda", generator=gen)
                if dtype == torch.float32:
                    c, dh, dcn = (torch.randn(B, h, H, W, device="cuda", generator=gen)
                                  for _ in range(3))
                else:
                    # Inputs in (-1, 1) keep every output below 2 in
                    # magnitude, where one bf16 ulp (<= 2^-7) is inside the
                    # bar; kernel and plain version may round one ulp apart.
                    c, dh, dcn = (torch.rand(B, h, H, W, device="cuda", generator=gen) * 2 - 1
                                  for _ in range(3))
                z, c, dh, dcn = (t.to(dtype) for t in (z, c, dh, dcn))
                if offset:
                    z, c = _at_storage_offset(z), _at_storage_offset(c)
                dz_k, dc_k = gates.lstm_gates_backward(z, c, dh, dcn)
                torch.cuda.synchronize()
                dz_p, dc_p = gates.lstm_gates_backward_reference(z, c, dh, dcn)
                err = max((dz_k.float() - dz_p.float()).abs().max().item(),
                          (dc_k.float() - dc_p.float()).abs().max().item())
                ok = err <= bars[dtype]
                print(f"kernel: lstm_gates_backward {str(dtype)[6:]} {shape}"
                      f"{' z, c at storage offset 1' if offset else ''} max_abs_err "
                      f"{err:.3e} (bar {bars[dtype]:g}) {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    _fail(f"lstm_gates_backward disagrees with its plain version at "
                          f"{shape} {dtype}")
                max_err[dtype] = max(max_err[dtype], err)
                if shape in cells and not offset:
                    step_inputs[dtype].append((z, c, dh, dcn))

        elems = sum(B * h * H * W for B, h, H, W in cells)
        for dtype, inputs in step_inputs.items():
            # One depth step's five backward launches, 1.58 GB in fp32 and
            # 0.79 GB in bf16 (the type of a bf16 training step): every
            # launch finds its inputs cold in the 50 MB L2.
            def kernel_step():
                for args in inputs:
                    gates.lstm_gates_backward(*args)

            def plain_step():
                for args in inputs:
                    gates.lstm_gates_backward_reference(*args)

            lib_inputs = []
            lib_err = 0.0
            for z, c, dh, dcn in inputs:
                lib_inputs.append(_backward_library_inputs(z, c, dh, dcn))
                dgates, dcx, _ = _library_gates_backward(*lib_inputs[-1])
                h = c.shape[1]
                dz_p, dc_p = gates.lstm_gates_backward_reference(z, c, dh, dcn)
                dz_pl, _ = _to_library_layout(dz_p, dc_p)
                dc_pl = dc_p.permute(0, 2, 3, 1).reshape(-1, h)
                lib_err = max(lib_err, (dgates.float() - dz_pl.float()).abs().max().item(),
                              (dcx.float() - dc_pl.float()).abs().max().item())
            if lib_err > (1e-5 if dtype == torch.float32 else bars[dtype]):
                _fail(f"backward library yardstick computes another function in {dtype} "
                      f"(err {lib_err:.3e})")

            def library_step():
                for args in lib_inputs:
                    _library_gates_backward(*args)

            ms = _cuda_time_ms(kernel_step, reps=50)
            plain_ms = _cuda_time_ms(plain_step, reps=10)
            library_ms = _cuda_time_ms(library_step, reps=20)
            ms_again = _cuda_time_ms(kernel_step, reps=50)
            del lib_inputs
            # Read i, f, o, g, c, dh, dc'; write di, df, do, dg, dc.
            nbytes = elems * inputs[0][0].element_size() * (7 + 5)
            bytes_ms = nbytes / memory_bytes_per_s() * 1e3
            # ~50 fp32 operations per element (3 sigmoids, 2 tanh, ~20
            # products and sums) at the card's 67 TFLOP/s non-tensor fp32
            # peak, whatever the storage type.
            ops_ms = elems * 50 / 67e12 * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            times[dtype] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                bound_ms=bound_ms,
                                bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            print(f"kernel: backward {str(dtype)[6:]}, one depth step = 5 launches, "
                  f"{elems / 1e6:.2f} M elements, {nbytes / 1e9:.3f} GB: kernel {ms:.4f} ms "
                  f"(again {ms_again:.4f}), plain {plain_ms:.4f} ms, library "
                  f"{library_ms:.4f} ms (_thnn_fused_lstm_cell_backward_impl, max_abs_err "
                  f"vs plain {lib_err:.1e}), bound {bound_ms:.4f} ms by bytes "
                  f"({bound_ms / ms:.0%} of it)", flush=True)
        del step_inputs

        # The training main path's shapes: one depth step at dtu_train,
        # 0.68 M elements, 32 MB.  In a remat block the backward runs after
        # the block's recompute, so its inputs come from device memory: a
        # 1 GiB buffer is written between runs.  Writing it takes ~0.3 ms
        # of device time, longer than the host takes to issue the five
        # launches, so the events time the device and not the host.
        train_cells = _cell_shapes(TRAIN_H, TRAIN_W)
        train_inputs = [
            (torch.randn(B, 4 * h, H, W, device="cuda", generator=gen),
             *(torch.randn(B, h, H, W, device="cuda", generator=gen) for _ in range(3)))
            for B, h, H, W in train_cells
        ]
        train_lib_inputs = [_backward_library_inputs(*args) for args in train_inputs]
        flush = torch.empty(2**28, device="cuda")

        def train_kernel_step():
            for args in train_inputs:
                gates.lstm_gates_backward(*args)

        def train_library_step():
            for args in train_lib_inputs:
                _library_gates_backward(*args)

        train_ms = device_ms(train_kernel_step, flush)
        train_library_ms = device_ms(train_library_step, flush)
        train_ms_again = device_ms(train_kernel_step, flush)
        train_library_ms_again = device_ms(train_library_step, flush)
        del flush

        # The host's cost of one call at the smallest dtu_train cell.
        small, small_lib = train_inputs[2], train_lib_inputs[2]
        host_us = [_host_us(lambda: gates.lstm_gates_backward(*small))]
        library_host_us = [_host_us(lambda: _library_gates_backward(*small_lib))]
        library_host_us.append(_host_us(lambda: _library_gates_backward(*small_lib)))
        host_us.append(_host_us(lambda: gates.lstm_gates_backward(*small)))

    train_elems = sum(B * h * H * W for B, h, H, W in train_cells)
    print(f"kernel: backward at the dtu_train cell shapes ({TRAIN_H}x{TRAIN_W}), one depth "
          f"step = 5 launches, {train_elems / 1e6:.3f} M elements, inputs cold in device "
          f"memory: kernel {train_ms * 1e3:.2f} us (again {train_ms_again * 1e3:.2f}), "
          f"{train_ms * 1e3 / 5:.2f} us a launch; library {train_library_ms * 1e3:.2f} us "
          f"(again {train_library_ms_again * 1e3:.2f}), {train_library_ms * 1e3 / 5:.2f} us "
          "a launch; launch-bound at these shapes (3.7 us a launch in the training "
          "profile), so no bound share", flush=True)
    print(f"kernel: host cost per call at {train_cells[2]}, 1000 calls, no sync: wrapper "
          f"gates.lstm_gates_backward {host_us[0]:.2f}, {host_us[1]:.2f} us; library call "
          f"{library_host_us[0]:.2f}, {library_host_us[1]:.2f} us", flush=True)

    fp32, bf16 = times[torch.float32], times[torch.bfloat16]
    return {
        "name": "lstm_gates_backward",
        "route": "cuda",
        "source": "aa_rmvsnet_tpu_torch/csrc/lstm_gates.cu",
        "replaces": "aa_rmvsnet_tpu/ops/pallas/gates.py:54",
        "launches": None,
        "max_abs_err": max_err[torch.float32],
        **fp32,
        **{f"{k}_bf16": v for k, v in bf16.items()},
        "max_abs_err_bf16": max_err[torch.bfloat16],
        "ms_train_shapes": train_ms,
        "library_ms_train_shapes": train_library_ms,
        "host_us_per_call": min(host_us),
        "library_host_us_per_call": min(library_host_us),
    }


def phase_small() -> None:
    from aa_rmvsnet_tpu_torch.models import SweepConfig, forward
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_scene, seeded_model

    (sample,) = plane_scene(SMALL_H, SMALL_W, SMALL_V, SMALL_D, maps=1, seed=SEED + 2,
                            focal=400.0, baseline=2.0, plane_depth=500.0,
                            depth_min=425.0, depth_interval=2.5)
    model = seeded_model(SEED)
    config = SweepConfig(depth_block=8, collect_volume=False)
    outs = {}
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            model.to(dev)
            args = [torch.from_numpy(sample[k])[None].to(dev)
                    for k in ("imgs", "proj_matrices", "depth_values")]
            before = gates.launches
            t0 = time.perf_counter()
            out = forward(model, *args, config)
            outs[dev] = {k: v.cpu().numpy() for k, v in out.items()}
            dt = time.perf_counter() - t0
            launched = gates.launches - before
            print(f"small: forward on {dev} in {dt:.2f} s, gate kernel launches "
                  f"{launched}", flush=True)
            if dev == "cuda" and launched != 5 * SMALL_D:
                _fail(f"small CUDA forward launched the gate kernel {launched} times")
    same = np.mean(outs["cpu"]["depth"] == outs["cuda"]["depth"])
    conf_err = np.abs(outs["cpu"]["photometric_confidence"]
                      - outs["cuda"]["photometric_confidence"]).max()
    ok = same >= 0.999 and conf_err <= 1e-4
    print(f"small: CUDA vs CPU at {SMALL_H}x{SMALL_W}, V={SMALL_V}, D={SMALL_D}: depth "
          f"equal on {same:.4%} of pixels (bar 99.9%), confidence max_abs_err "
          f"{conf_err:.3e} (bar 1e-4) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        _fail("CUDA forward disagrees with the CPU forward")


def _worst(ref: dict, other: dict) -> tuple[str, float]:
    """(tensor, max_abs_err / max(max|ref|, 1e-3)) of the worst tensor of
    ``other`` against ``ref``.  The floor also covers the output conv's
    bias, whose gradient is exactly zero (softmax is shift-invariant) and so
    rounding noise."""
    rels = {}
    for name, g in ref.items():
        err = (other[name] - g).abs().max().item()
        rels[name] = err / max(g.abs().max().item(), 1e-3) if np.isfinite(err) else np.inf
    name = max(rels, key=rels.get)
    return name, rels[name]


def _small_train_host_batch():
    from aa_rmvsnet_tpu_torch.data.loader import batch_samples
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_train_sample

    return batch_samples([plane_train_sample(
        SMALL_H, SMALL_W, SMALL_V, GRAD_D, seed=SEED + 4, focal=400.0, baseline=2.0,
        plane_depth=500.0, depth_min=425.0, depth_interval=7.5)])


def _small_loss_and_grads(host: dict, config, dev: str, label: str, nudge: float = 0.0,
                          noise: torch.Generator | None = None):
    """One remat training forward and backward of the seeded model (zero
    deform offsets, as the reference initialises them; every other weight
    scaled by 1 + ``nudge`` N(0, 1)) on ``dev``: the loss, the gradients on
    the CPU, and the gate-kernel launches (forward, backward, bf16 forward,
    bf16 backward)."""
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.pipeline.train import batch_to_device, loss_fn
    from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_model

    model = seeded_model(SEED)
    with torch.no_grad():
        for name, param in model.named_parameters():
            if ".p_conv." in name:
                param.zero_()
            elif nudge:
                param.mul_(1 + nudge * torch.randn(param.shape, generator=noise))
    model.to(dev)
    counters = ("launches", "backward_launches", "bf16_launches", "bf16_backward_launches")
    before = [getattr(gates, k) for k in counters]
    t0 = time.perf_counter()
    loss, _ = loss_fn(model, batch_to_device(host, dev), config)
    loss.backward()
    grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
    launched = tuple(getattr(gates, k) - b for k, b in zip(counters, before))
    print(f"{label}: loss and gradients on {dev}{f' (weights x 1 + {nudge:g} noise)' if nudge else ''}"
          f" in {time.perf_counter() - t0:.2f} s, gate kernel launches forward {launched[0]}, "
          f"backward {launched[1]} (bf16 {launched[2]}, {launched[3]})", flush=True)
    return loss.item(), grads, launched


def phase_train_small() -> None:
    from aa_rmvsnet_tpu_torch.models import SweepConfig

    host = _small_train_host_batch()
    config = SweepConfig(depth_block=GRAD_BLOCK, remat=True)
    noise = torch.Generator().manual_seed(SEED + 6)
    label = "train-small"
    loss_cpu, g_cpu, _ = _small_loss_and_grads(host, config, "cpu", label)
    _, g_nudged, _ = _small_loss_and_grads(host, config, "cpu", label, 1e-7, noise)
    loss_cuda, g_cuda, launched = _small_loss_and_grads(host, config, "cuda", label)
    if launched != (2 * 5 * GRAD_D, 5 * GRAD_D, 0, 0):
        _fail(f"small CUDA training step launched the gate kernels {launched} times")

    loss_rel = abs(loss_cuda - loss_cpu) / abs(loss_cpu)
    dev_name, dev_err = _worst(g_cpu, g_cuda)
    ref_name, ref_err = _worst(g_cpu, g_nudged)
    bar = max(1e-3, 10 * ref_err)
    ok = loss_rel <= 1e-5 and dev_err <= bar
    print(f"train-small: CUDA vs CPU at {SMALL_H}x{SMALL_W}, V={SMALL_V}, D={GRAD_D}, "
          f"depth_block {GRAD_BLOCK}, remat: loss {loss_cuda:.6f} vs {loss_cpu:.6f} "
          f"(rel {loss_rel:.2e}, bar 1e-5); gradients of {len(g_cpu)} tensors, worst "
          f"max_abs_err / max(max|g|, 1e-3) {dev_err:.2e} ({dev_name}); the CPU's own "
          f"move under 1e-7 weight noise {ref_err:.2e} ({ref_name}); bar {bar:.2e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        _fail("CUDA training gradients disagree with the CPU ones")


def _relative(ref: dict, other: dict, skip: str) -> dict:
    """Per tensor but ``skip``, max_abs_err / max(max|ref|, 1e-3)."""
    return {name: (other[name] - g).abs().max().item() / max(g.abs().max().item(), 1e-3)
            for name, g in ref.items() if name != skip}


def phase_train_levers_small() -> None:
    """``TrainConfig(fold_omega=True | "hybrid")`` in fp32 and
    ``feature_dtype=torch.bfloat16``: one remat step CUDA against CPU."""
    from aa_rmvsnet_tpu_torch.pipeline.train import TrainConfig

    host = _small_train_host_batch()
    for name, levers in (("fold_omega=True", dict(fold_omega=True)),
                         ("fold_omega='hybrid'", dict(fold_omega="hybrid")),
                         ("bf16", dict(feature_dtype=torch.bfloat16))):
        config = TrainConfig(depth_block=GRAD_BLOCK, **levers).sweep(remat=True)
        bf16 = config.feature_dtype == torch.bfloat16
        label = f"train-small {name}"
        noise = torch.Generator().manual_seed(SEED + 6)
        loss_cpu, g_cpu, _ = _small_loss_and_grads(host, config, "cpu", label)
        loss_n7, g_n7, _ = _small_loss_and_grads(host, config, "cpu", label, 1e-7, noise)
        loss_cuda, g_cuda, launched = _small_loss_and_grads(host, config, "cuda", label)
        want = (2 * 5 * GRAD_D, 5 * GRAD_D) * 2 if bf16 else (2 * 5 * GRAD_D, 5 * GRAD_D, 0, 0)
        if launched != want:
            _fail(f"small CUDA {name} training step launched the gate kernels {launched} "
                  f"times, not {want}")
        loss_rel = abs(loss_cuda - loss_cpu) / abs(loss_cpu)
        if not bf16:  # phase 4b's bars
            dev_name, dev_err = _worst(g_cpu, g_cuda)
            ref_name, ref_err = _worst(g_cpu, g_n7)
            bar = max(1e-3, 10 * ref_err)
            ok = loss_rel <= 1e-5 and dev_err <= bar
            print(f"{label}: CUDA vs CPU at {SMALL_H}x{SMALL_W}, V={SMALL_V}, D={GRAD_D}, "
                  f"depth_block {GRAD_BLOCK}, remat: loss {loss_cuda:.6f} vs {loss_cpu:.6f} "
                  f"(rel {loss_rel:.2e}, bar 1e-5); gradients of {len(g_cpu)} tensors, worst "
                  f"{dev_err:.2e} ({dev_name}); the CPU's own move under 1e-7 weight noise "
                  f"{ref_err:.2e} ({ref_name}); bar {bar:.2e} {'ok' if ok else 'FAIL'}",
                  flush=True)
        else:
            # A bf16 cast absorbs 1e-7 weight noise (most draws move no bf16
            # weight, and so no gradient), so the CPU's own move is taken
            # under noise of one bf16 rounding, 2^-8; that move is itself the
            # size of bf16's error (~0.9 of the worst tensor, ~0.3 of the
            # median one on the CPU).  One draw's loss move varies by an
            # order of magnitude from draw to draw, and the card's bf16 step
            # is not deterministic (its atomics sum in no fixed order), so
            # the scale is the root mean square over BF16_NOISE_DRAWS draws,
            # the bars are 2x it (on the loss, the worst and the median
            # tensor), and two runs on the card must each meet them.  The
            # output conv's bias, whose exact gradient is 0, holds bf16
            # rounding noise on both sides and is printed apart.
            skip = "cost_regularization.conv_0.bias"
            moves = {"loss": [], "worst": [], "median": []}
            for _ in range(BF16_NOISE_DRAWS):
                loss_n8, g_n8, _ = _small_loss_and_grads(host, config, "cpu", label,
                                                         2.0**-8, noise)
                move = list(_relative(g_cpu, g_n8, skip).values())
                moves["loss"].append(abs(loss_n8 - loss_cpu) / abs(loss_cpu))
                moves["worst"].append(max(move))
                moves["median"].append(float(np.median(move)))
            rms = {k: float(np.sqrt(np.mean(np.square(v)))) for k, v in moves.items()}
            loss_bar = max(1e-5, 2 * rms["loss"])
            worst_bar = max(1e-3, 2 * rms["worst"])
            median_bar = 2 * rms["median"]
            loss_cuda2, g_cuda2, launched = _small_loss_and_grads(host, config, "cuda", label)
            if launched != want:
                _fail(f"small CUDA {name} training step launched the gate kernels "
                      f"{launched} times, not {want}")
            runs = []
            for loss_c, g_c in ((loss_cuda, g_cuda), (loss_cuda2, g_cuda2)):
                dev = _relative(g_cpu, g_c, skip)
                dev_name = max(dev, key=dev.get)
                runs.append((abs(loss_c - loss_cpu) / abs(loss_cpu), dev[dev_name], dev_name,
                             float(np.median(list(dev.values()))),
                             (g_c[skip] - g_cpu[skip]).abs().max().item()))
            ok = all(r[0] <= loss_bar and r[1] <= worst_bar and r[3] <= median_bar
                     for r in runs)
            move7 = _relative(g_cpu, g_n7, skip)
            span = {k: f"{min(v):.2e}-{max(v):.2e}" for k, v in moves.items()}
            print(f"{label}: CUDA (two runs) vs CPU at {SMALL_H}x{SMALL_W}, V={SMALL_V}, "
                  f"D={GRAD_D}, depth_block {GRAD_BLOCK}, remat: loss {loss_cuda:.6f}, "
                  f"{loss_cuda2:.6f} vs {loss_cpu:.6f} (rel {runs[0][0]:.2e}, {runs[1][0]:.2e}; "
                  f"the two runs {abs(loss_cuda2 - loss_cuda) / abs(loss_cpu):.2e} apart; bar "
                  f"{loss_bar:.2e} = 2 x the root mean square of the moves under "
                  f"{BF16_NOISE_DRAWS} draws of 2^-8 noise, {span['loss']}; 1e-7 noise moved "
                  f"it {abs(loss_n7 - loss_cpu) / abs(loss_cpu):.2e}); gradients of "
                  f"{len(dev)} tensors, worst {runs[0][1]:.3e} ({runs[0][2]}), {runs[1][1]:.3e} "
                  f"({runs[1][2]}), bar {worst_bar:.3e} (moves {span['worst']}); median "
                  f"{runs[0][3]:.3e}, {runs[1][3]:.3e}, bar {median_bar:.3e} (moves "
                  f"{span['median']}); the CPU's own worst move under 1e-7 noise "
                  f"{max(move7.values()):.3e}; {skip} max_abs_err {runs[0][4]:.2e}, "
                  f"{runs[1][4]:.2e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            _fail(f"CUDA {name} training gradients disagree with the CPU ones")


def phase_train_evidential_small() -> None:
    from aa_rmvsnet_tpu_torch.data.loader import batch_samples
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.pipeline.train import (
        TrainConfig,
        batch_to_device,
        evidential_loss_fn,
    )
    from aa_rmvsnet_tpu_torch.utils.synthetic import (
        plane_train_sample,
        seeded_head,
        seeded_model,
    )

    host = batch_samples([plane_train_sample(
        SMALL_H, SMALL_W, SMALL_V, GRAD_D, seed=SEED + 4, focal=400.0, baseline=2.0,
        plane_depth=500.0, depth_min=425.0, depth_interval=7.5)])
    config = TrainConfig(depth_block=GRAD_BLOCK, evidential=True, maxdisp=GRAD_MAXDISP)
    noise = torch.Generator().manual_seed(SEED + 9)

    def loss_and_grads(dev: str, nudge: float = 0.0):
        model, head = seeded_model(SEED), seeded_head(SEED)
        with torch.no_grad():
            for name, param in model.named_parameters():
                if ".p_conv." in name:  # zero offsets, as in phase 4b
                    param.zero_()
            if nudge:
                for param in list(model.parameters()) + list(head.parameters()):
                    param.mul_(1 + nudge * torch.randn(param.shape, generator=noise))
        model.to(dev).train()
        head.to(dev).train()
        before = (gates.launches, gates.backward_launches)
        t0 = time.perf_counter()
        loss, _ = evidential_loss_fn(model, head, batch_to_device(host, dev), config,
                                     config.sweep(remat=True))
        loss.backward()
        grads = {n: p.grad.cpu() for n, p in model.named_parameters()}
        grads.update({f"evidential.{n}": p.grad.cpu() for n, p in head.named_parameters()})
        stats = {n: b.cpu() for n, b in head.named_buffers() if n.endswith(("_mean", "_var"))}
        launched = (gates.launches - before[0], gates.backward_launches - before[1])
        print(f"train-evidential-small: loss and gradients on {dev}"
              f"{' (nudged weights)' if nudge else ''} in {time.perf_counter() - t0:.2f} s, "
              f"gate kernel launches forward {launched[0]}, backward {launched[1]}", flush=True)
        return loss.item(), grads, stats, launched

    loss_cpu, g_cpu, s_cpu, _ = loss_and_grads("cpu")
    _, g_nudged, s_nudged, _ = loss_and_grads("cpu", nudge=1e-7)
    loss_cuda, g_cuda, s_cuda, launched = loss_and_grads("cuda")
    if launched != (2 * 5 * GRAD_D, 5 * GRAD_D):
        _fail(f"small CUDA evidential training step launched the gate kernels {launched} times")
    loss_rel = abs(loss_cuda - loss_cpu) / abs(loss_cpu)
    results = {}
    for what, ref, cuda, nudged in (("gradients", g_cpu, g_cuda, g_nudged),
                                    ("BN statistics", s_cpu, s_cuda, s_nudged)):
        dev_name, dev_err = _worst(ref, cuda)
        ref_name, ref_err = _worst(ref, nudged)
        bar = max(1e-3, 10 * ref_err)
        results[what] = (dev_err <= bar, f"{what} of {len(ref)} tensors, worst max_abs_err / "
                         f"max(max|x|, 1e-3) {dev_err:.2e} ({dev_name}); the CPU's own move "
                         f"under 1e-7 weight noise {ref_err:.2e} ({ref_name}); bar {bar:.2e}")
    ok = loss_rel <= 1e-5 and all(good for good, _ in results.values())
    print(f"train-evidential-small: CUDA vs CPU at {SMALL_H}x{SMALL_W}, V={SMALL_V}, "
          f"D={GRAD_D}, depth_block {GRAD_BLOCK}, maxdisp {GRAD_MAXDISP}, remat, head in train "
          f"mode: loss {loss_cuda:.6f} vs {loss_cpu:.6f} (rel {loss_rel:.2e}, bar 1e-5); "
          + "; ".join(text for _, text in results.values()) + f" {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        _fail("CUDA evidential training disagrees with the CPU")


def _packed_bars(name: str, out: dict, exact: dict) -> None:
    """Packed against exact: depth equal on >= 99.9 % of pixels, cost
    volume atol 5e-4, confidence atol 1e-4."""
    same = (out["depth"] == exact["depth"]).float().mean().item()
    cost_err = (out["cost_volume"] - exact["cost_volume"]).abs().max().item()
    conf_err = (out["photometric_confidence"]
                - exact["photometric_confidence"]).abs().max().item()
    ok = same >= 0.999 and cost_err <= 5e-4 and conf_err <= 1e-4
    print(f"packed: {name} vs the unpacked path: depth equal on {same:.4%} of pixels "
          f"(bar 99.9%), cost volume max_abs_err {cost_err:.3e} (bar 5e-4), confidence "
          f"{conf_err:.3e} (bar 1e-4) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        _fail(f"{name} disagrees with the unpacked path")


def phase_packed_small() -> None:
    from aa_rmvsnet_tpu_torch.models import SweepConfig, forward, pick_packed_rows
    from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, resolve_packed_mode
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_scene, seeded_model

    model = seeded_model(SEED).cuda()

    def scene(baseline):
        (sample,) = plane_scene(SMALL_H, SMALL_W, SMALL_V, SMALL_D, maps=1, seed=SEED + 2,
                                focal=400.0, baseline=baseline, plane_depth=500.0,
                                depth_min=425.0, depth_interval=2.5)
        return sample

    def expect_mode(sample, want, **levers):
        got = resolve_packed_mode(sample, InferConfig(out_root="", feature_dtype=torch.float32,
                                                      **levers))
        if got != want:
            _fail(f"the packed gate picked {got} where this phase needs {want}")

    def run(sample, **config):
        args = [torch.from_numpy(sample[k])[None].cuda()
                for k in ("imgs", "proj_matrices", "depth_values")]
        with torch.inference_mode():
            return forward(model, *args, SweepConfig(depth_block=8, **config))

    near = scene(2.0)
    expect_mode(near, (True, 2, 4), gather_pack=2)
    exact = run(near)
    packed = run(near, packed_rows=True)
    _packed_bars("packed rows (4x4)", packed, exact)
    fused = run(near, packed_rows=True, fused_residual=True)
    same = torch.equal(fused["cost_volume"], packed["cost_volume"])
    print(f"packed: fused residual equals the unfused one bit for bit: {same}", flush=True)
    if not same:
        _fail("the fused residual differs from the unfused one")
    _packed_bars("gather_pack=2 (4x4)", run(near, packed_rows=True, gather_pack=2), exact)

    # Cameras 15 apart: one step moves a sample 0.165 px, so 16 hypotheses
    # span 2.5 px, past the 4x4 window's 2 px and within the 6x6 one's 4.
    far = scene(15.0)
    block16 = (far["proj_matrices"], far["depth_values"], SMALL_H, SMALL_W, 16)
    if pick_packed_rows(*block16, taps=4) or not pick_packed_rows(*block16, taps=6):
        _fail("the 6x6 scene's 16-hypothesis span is not in (2, 4] px")
    expect_mode(far, (True, 2, 6), gather_pack=2, table_taps=6)
    _packed_bars("6x6 tables with gather_pack=2",
                 run(far, packed_rows=True, gather_pack=2, table_taps=6, fused_residual=True),
                 run(far))


def phase_bf16_guardrail() -> None:
    from aa_rmvsnet_tpu_torch.models import SweepConfig, forward
    from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, resolve_packed_mode, sweep_config
    from aa_rmvsnet_tpu_torch.utils.synthetic import matching_model, plane_scene

    # The middle of three cameras 16 apart, the plane at 480 (a hypothesis):
    # the sources are the texture shifted by exactly 20 px either way, so at
    # the plane's depth the warp hits whole pixels and the residual vanishes,
    # and the nearest depth step moves a sample 0.26 px (8 hypotheses span
    # 1.85 px, inside the 4x4 gate's 1.9).
    depth_interval = 2.5
    sample = plane_scene(GUARD_H, GUARD_W, GUARD_V, GUARD_D, maps=2, seed=SEED + 7,
                         focal=600.0, baseline=16.0, plane_depth=480.0, depth_min=425.0,
                         depth_interval=depth_interval)[1]
    config = InferConfig(out_root="")
    mode = resolve_packed_mode(sample, config)
    if mode != (True, 1, 4):
        _fail(f"the packed gate picked {mode} for the guardrail scene, not (True, 1, 4)")
    # Random weights give nearly flat costs, whose winner any rounding moves
    # far: the guardrail assumes a network whose costs peak at the match.
    model = matching_model(SEED).cuda()
    args = [torch.from_numpy(sample[k])[None].cuda()
            for k in ("imgs", "proj_matrices", "depth_values")]
    with torch.inference_mode():
        bf16 = forward(model, *args, sweep_config(config, mode))
        fp32 = forward(model, *args, SweepConfig(depth_block=8, collect_volume=False))
    within = ((bf16["depth"] - fp32["depth"]).abs() <= depth_interval + 1e-6).cpu().numpy()
    confident = (fp32["photometric_confidence"] > 0.3).cpu().numpy()
    share, conf_share = within.mean(), confident.mean()
    conf_within = within[confident].mean() if confident.any() else 0.0
    ok = share >= 0.95
    if conf_share > 0.5:
        ok = ok and conf_within >= 0.999
        note = f"{conf_within:.4%} of them within one bin (bar 99.9%)"
    else:
        note = ("untrained weights leave too few confident pixels for the confident-pixel "
                "bar, which applies where they are more than half the map")
    on_plane = ((fp32["depth"] - 480.0).abs() <= depth_interval + 1e-6).float().mean().item()
    print(f"bf16 guardrail at {GUARD_H}x{GUARD_W}, V={GUARD_V}, D={GUARD_D}, packed mode "
          f"{mode}, bf16 vs exact fp32: {share:.4%} of pixels within one depth bin (bar 95%); "
          f"fp32 confidence > 0.3 on {conf_share:.2%} of pixels, {note}; the fp32 depth is "
          f"within one bin of the plane on {on_plane:.2%} of pixels "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        _fail("the bf16 packed path fails the bf16 guardrail")


def _lever_configs():
    """The levers of phase 4f by name: ``SweepConfig`` settings on top of
    depth_block 8, fp32."""
    f8, i8 = torch.float8_e4m3fn, torch.int8
    return {
        "fp8 tables, unpacked": dict(table_dtype=f8),
        "int8 tables, packed": dict(packed_rows=True, table_dtype=i8),
        "fp8 residual, fp8 tables": dict(packed_rows=True, table_dtype=f8, residual_dtype=f8),
        "int8 residual, fp8 tables": dict(packed_rows=True, table_dtype=f8, residual_dtype=i8),
        "dual residual, fp8 tables": dict(packed_rows=True, table_dtype=f8,
                                          residual_dtype="dual"),
        "fp8 residual, fold_omega": dict(fold_omega=True, residual_dtype=f8),
        "production stack (int8 tables, dual, gather_pack 2, 6x6, fused)": dict(
            packed_rows=True, gather_pack=2, table_taps=6, fused_residual=True,
            table_dtype=i8, residual_dtype="dual"),
    }


def phase_levers_small() -> None:
    from aa_rmvsnet_tpu_torch.models import SweepConfig, forward
    from aa_rmvsnet_tpu_torch.models.aggregation import int8_conv
    from aa_rmvsnet_tpu_torch.ops.patch_sample import build_patch_table_packed_quant, int8_blend
    from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, resolve_packed_mode
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_scene, seeded_model

    # Tables built on the card against the CPU's, from the same features.
    feat = torch.randn(2, SMALL_H, SMALL_W, 32, generator=torch.Generator().manual_seed(SEED))
    for dtype in (torch.float8_e4m3fn, torch.int8):
        for taps in (2, 4, 6):
            t_cpu, s_cpu = build_patch_table_packed_quant(feat, dtype, taps)
            t_gpu, s_gpu = build_patch_table_packed_quant(feat.cuda(), dtype, taps)
            same = (torch.equal(t_gpu.view(torch.uint8).cpu(), t_cpu.view(torch.uint8))
                    and torch.equal(s_gpu.cpu(), s_cpu))
            if not same:
                _fail(f"{dtype} {taps}x{taps} tables built on the card differ from the CPU's")
    print("levers: fp8 and int8 tables (2x2, 4x4, 6x6) built on the card equal the CPU's "
          "bit for bit", flush=True)

    # The int8 blend: an int64 product sum at 4,096 groups of 36 taps (two
    # at the bound), and a float64 product (exact for these integers) at the
    # dtu_eval blend shape, 995,328 pixels x (16 x 16) @ (16 x 32).
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    w = torch.randint(0, 128, (4096, 16, 36), device="cuda", generator=gen)
    rows = torch.randint(-127, 128, (4096, 36, 32), device="cuda", generator=gen,
                         dtype=torch.int8)
    w[:2], rows[0], rows[1] = 127, 127, -127
    exact = (w[:, :, :, None].long() * rows[:, None].long()).sum(dim=2)
    if exact.abs().max().item() != 580_644:
        _fail("the int8 blend's bound case does not reach 580,644")
    w_main = torch.randint(0, 128, (MAIN_H * MAIN_W, 16, 16), device="cuda", generator=gen)
    rows_main = torch.randint(-127, 128, (MAIN_H * MAIN_W, 16, 32), device="cuda",
                              generator=gen, dtype=torch.int8)
    exact_main = torch.bmm(w_main.double(), rows_main.double())
    for out_dtype in (torch.float32, torch.bfloat16):
        ok = (torch.equal(int8_blend(w.float(), rows, out_dtype), exact.to(out_dtype))
              and torch.equal(int8_blend(w_main.float(), rows_main, out_dtype),
                              exact_main.float().to(out_dtype)))
        if not ok:
            _fail(f"the int8 blend in {out_dtype} is not the exact integer sum")
    del w_main, rows_main, exact_main

    # Omega's int8 rw0: the grouped 3x3 convolution at the dtu_eval shape
    # (one view's 8 folded hypotheses, channels last as the residual lies),
    # one output at the bound, against cuDNN's float64 convolution.
    x = torch.randint(0, 128, (1, MAIN_H, MAIN_W, 8 * 32), device="cuda", generator=gen,
                      dtype=torch.int8)
    k = torch.randint(-127, 128, (8 * 4, 32, 3, 3), device="cuda", generator=gen).float()
    x[0, 1:4, 1:4, :32], k[0] = 127, 127
    got = int8_conv(x.permute(0, 3, 1, 2), k, 1, 8)
    exact = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).double(), k.double(), padding=1,
                                       groups=8)
    if exact.max().item() != 4_645_152 or not torch.equal(got, exact.float().to(torch.bfloat16)):
        _fail("omega's int8 rw0 convolution is not the exact integer sum rounded once")
    del x, exact, got
    print("levers: the int8 blend (fp32 and bf16, |sums| up to 580,644; and at the dtu_eval "
          "shape) and omega's int8 rw0 convolution (bf16, at the dtu_eval shape, sums up to "
          "4,645,152) equal integer-exact references bit for bit", flush=True)

    (sample,) = plane_scene(SMALL_H, SMALL_W, SMALL_V, SMALL_D, maps=1, seed=SEED + 2,
                            focal=400.0, baseline=2.0, plane_depth=500.0,
                            depth_min=425.0, depth_interval=2.5)
    mode = resolve_packed_mode(sample, InferConfig(out_root="", feature_dtype=torch.float32,
                                                   gather_pack=2, table_taps=6))
    if mode != (True, 2, 4):
        _fail(f"the packed gate picked {mode} for the lever scene, not (True, 2, 4)")
    model = seeded_model(SEED)
    outs = {}
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            model.to(dev)
            args = [torch.from_numpy(sample[key])[None].to(dev)
                    for key in ("imgs", "proj_matrices", "depth_values")]
            for name, levers in _lever_configs().items():
                out = forward(model, *args, SweepConfig(depth_block=8, collect_volume=False,
                                                        **levers))
                outs[dev, name] = {key: v.cpu() for key, v in out.items()}
    for name in _lever_configs():
        cpu, gpu = outs["cpu", name], outs["cuda", name]
        same = (cpu["depth"] == gpu["depth"]).float().mean().item()
        conf_err = (cpu["photometric_confidence"]
                    - gpu["photometric_confidence"]).abs().max().item()
        ok = same >= 0.99 and conf_err <= 1e-3
        print(f"levers: CUDA vs CPU at {SMALL_H}x{SMALL_W}, V={SMALL_V}, D={SMALL_D}, fp32, "
              f"{name}: depth equal on {same:.4%} of pixels (bar 99%), confidence "
              f"max_abs_err {conf_err:.3e} (bar 1e-3) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            _fail(f"the lever {name!r} on CUDA disagrees with the CPU")


def _guardrail_setup() -> dict:
    """The scene, weights and base of the lever guardrails (4g, 4i): phase
    4d's scene with ``matching_model(sharpness=1000)`` weights, the bf16
    packed path without levers as the base, its confident pixels, and the
    production stack's sweep settings in the mode the gate picks."""
    from aa_rmvsnet_tpu_torch.models import forward
    from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, resolve_packed_mode, sweep_config
    from aa_rmvsnet_tpu_torch.utils.synthetic import matching_model, plane_scene

    sample = plane_scene(GUARD_H, GUARD_W, GUARD_V, GUARD_D, maps=2, seed=SEED + 7,
                         focal=600.0, baseline=16.0, plane_depth=480.0, depth_min=425.0,
                         depth_interval=GUARD_INTERVAL)[1]
    base_config = InferConfig(out_root="")
    if resolve_packed_mode(sample, base_config) != (True, 1, 4):
        _fail("the packed gate did not pick (True, 1, 4) for the lever guardrail scene")
    stack = InferConfig(out_root="", table_dtype=torch.int8, residual_dtype="dual",
                        gather_pack=2, table_taps=6)
    stack_mode = resolve_packed_mode(sample, stack)
    model = matching_model(SEED, sharpness=1000.0).cuda()
    args = [torch.from_numpy(sample[k])[None].cuda()
            for k in ("imgs", "proj_matrices", "depth_values")]
    base_sweep = sweep_config(base_config, (True, 1, 4))
    with torch.inference_mode():
        base = forward(model, *args, base_sweep)
    confident = (base["photometric_confidence"] > 0.3).cpu().numpy()
    if confident.mean() <= 0.5:
        _fail(f"only {confident.mean():.2%} of the guardrail's pixels are confident")
    return dict(model=model, args=args, base_sweep=base_sweep, base=base, confident=confident,
                stack=sweep_config(stack, stack_mode), stack_mode=stack_mode)


def _guardrail_shares(setup: dict, config) -> tuple[float, float]:
    """The shares of all and of the confident pixels whose depth lies
    within one bin of the guardrail's base under the sweep ``config``."""
    from aa_rmvsnet_tpu_torch.models import forward

    with torch.inference_mode():
        out = forward(setup["model"], *setup["args"], config)
    within = ((out["depth"] - setup["base"]["depth"]).abs()
              <= GUARD_INTERVAL + 1e-6).cpu().numpy()
    return within.mean(), within[setup["confident"]].mean()


def phase_levers_guardrail() -> None:
    f8, i8 = torch.float8_e4m3fn, torch.int8
    setup = _guardrail_setup()
    base_sweep, confident = setup["base_sweep"], setup["confident"]
    levers = {  # name: (sweep config, confident-pixel bar or None)
        "fp8 tables": (replace(base_sweep, table_dtype=f8), None),
        "int8 tables": (replace(base_sweep, table_dtype=i8), None),
        # The residuals with the production stack's int8 tables.
        "fp8 residual": (replace(base_sweep, table_dtype=i8, residual_dtype=f8), 0.99),
        "int8 residual": (replace(base_sweep, table_dtype=i8, residual_dtype=i8), None),
        "dual residual": (replace(base_sweep, table_dtype=i8, residual_dtype="dual"), 0.99),
        f"production stack {setup['stack_mode']}": (setup["stack"], 0.99),
    }
    shares = {}
    for name, (config, conf_bar) in levers.items():
        shares[name] = _guardrail_shares(setup, config)
        if name == "int8 residual":
            ok, bars = True, "no bar: the JAX package's int8 residual misses it too"
        else:
            ok = shares[name][0] >= 0.90 and (conf_bar is None or shares[name][1] >= conf_bar)
            bars = "bars 90%" + ("" if conf_bar is None else f", {conf_bar:.0%} confident")
        print(f"levers guardrail at {GUARD_H}x{GUARD_W}, V={GUARD_V}, D={GUARD_D}, bf16, "
              f"{name} vs the bf16 packed path: {shares[name][0]:.4%} of pixels within one "
              f"bin, {shares[name][1]:.4%} of the {confident.mean():.2%} confident ones "
              f"({bars}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            _fail(f"the {name} lever fails the JAX package's guardrail")
    if shares["dual residual"][1] <= shares["int8 residual"][1]:
        _fail("the dual residual does not beat the int8 residual on confident pixels")


@contextlib.contextmanager
def _omega_chain_on():
    """The JAX package's switch of the int8 omega chain, set for the block."""
    os.environ[OMEGA_CHAIN] = "chain"
    try:
        yield
    finally:
        del os.environ[OMEGA_CHAIN]


@contextlib.contextmanager
def _int8_convs(record: bool = False):
    """Count omega's int8 convolutions (``models/aggregation.py:int8_conv``)
    in the block; with ``record`` keep each one's ``(x, kernel, padding,
    groups, out)``."""
    from aa_rmvsnet_tpu_torch.models import aggregation

    calls = []
    conv = aggregation.int8_conv

    def spy(x, weight, padding, groups):
        out = conv(x, weight, padding, groups)
        calls.append((x, weight, padding, groups, out) if record else None)
        return out

    aggregation.int8_conv = spy
    try:
        yield calls
    finally:
        aggregation.int8_conv = conv


def phase_omega_chain() -> None:
    """4i: the int8 omega chain (``AA_RMVSNET_OMEGA_INT8=chain``) on the
    card against the CPU at 64x80, G=8 folded volumes (one view's block of
    8 hypotheses), on seeded bf16 omega weights whose GroupNorm affines are
    drawn too (they set the chain's static bounds), and a quantized squared
    residual as the JAX package's chain test builds it.  On each device
    each of the four int8 stages (rw0, stem0, stem1, rw2) equals the
    integer-exact convolution of its own int8 inputs (float64) rounded once
    to bf16, bit for bit; the card's stage inputs equal the CPU's on >=
    99.9 % of activations, none off by more than 1 (a GroupNorm statistic
    summed in another order moves an activation across a rounding
    boundary); the weights within 2^-6 of the CPU's (the CPU tests' bar
    against JAX where activations differ); the chain against the base int8
    path within the JAX package's bars (mean < 0.03, max < 0.25); then on
    4g's scene the dual residual (int8 tables) and the production stack
    with the chain on, each >= 90 % of pixels and >= 99 % of the confident
    ones within one bin of the bf16 packed path (the JAX package's claim
    for the chain, ``tests/test_models.py:609-612``)."""
    from aa_rmvsnet_tpu_torch.models.aggregation import omega_folded
    from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_model

    groups = 8
    gen = torch.Generator().manual_seed(SEED + 21)
    omega = seeded_model(SEED).omega.to(torch.bfloat16)
    rw0, rw1 = omega.reweight_network[:2]
    with torch.no_grad():
        for gn in (rw0[1], rw1.stem[0][1], rw1.stem[2]):
            gn.weight.copy_(1.0 + 0.5 * torch.randn(gn.weight.shape, generator=gen))
            gn.bias.copy_(0.3 * torch.randn(gn.bias.shape, generator=gen))
    raw = torch.randn(2, SMALL_H, SMALL_W, groups * 32, generator=gen) ** 2
    scale = torch.randn(32, generator=gen).abs() * 0.1 + 0.05
    x = torch.clamp(torch.round(raw / scale.repeat(groups)), 0, 127).to(torch.int8)
    runs = {}
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            omega.to(dev)
            with _omega_chain_on(), _int8_convs(record=True) as calls:
                weights = omega_folded(omega, x.to(dev), groups, scale.to(dev))
            runs[dev] = (weights.float().cpu(), calls)
        base = omega_folded(omega, x.cuda(), groups, scale.cuda()).float().cpu()
        largest = 0
        for dev, (_, calls) in runs.items():
            if len(calls) != 4:
                _fail(f"the chain ran {len(calls)} int8 convolutions on {dev}, not 4")
            for i, (xi, kernel, padding, g, out) in enumerate(calls):
                exact = torch.nn.functional.conv2d(xi.double(), kernel.double(),
                                                   padding=padding, groups=g)
                largest = max(largest, int(exact.abs().max().item()))
                if not torch.equal(out, exact.float().to(torch.bfloat16)):
                    _fail(f"chain stage {i} on {dev} is not the exact integer sum rounded once")
        shares = []
        for i, (c, g) in enumerate(zip(runs["cpu"][1], runs["cuda"][1])):
            diff = (g[0].cpu().int() - c[0].int()).abs()
            shares.append((diff == 0).float().mean().item())
            if diff.max().item() > 1 or shares[-1] < 0.999:
                _fail(f"chain stage {i}: the card's int8 inputs equal the CPU's on "
                      f"{shares[-1]:.4%}, off by up to {diff.max().item()}")
    w_cpu, w_gpu = runs["cpu"][0], runs["cuda"][0]
    err = (w_gpu - w_cpu).abs().max().item()
    same = (w_gpu == w_cpu).float().mean().item()
    moved = (w_gpu - base).abs()
    ok = err <= 2.0 ** -6 and moved.mean().item() < 0.03 and moved.max().item() < 0.25
    print(f"omega chain: CUDA vs CPU at {SMALL_H}x{SMALL_W}, G={groups}, bf16 weights: the "
          f"4 int8 stages equal integer-exact references rounded once on both devices (sums "
          f"up to {largest:,}); the card's stage inputs equal the CPU's on "
          f"[{', '.join(f'{x:.4%}' for x in shares)}] (bar 99.9%, off by at most 1); weights "
          f"max_abs_err {err:.3e} (bar 2^-6), bit for bit on {same:.4%}; chain vs base on the "
          f"card mean {moved.mean().item():.4f}, max {moved.max().item():.4f} (JAX's bars "
          f"0.03, 0.25) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        _fail("the int8 omega chain on the card disagrees with the CPU or the base path")

    setup = _guardrail_setup()
    with _omega_chain_on(), _int8_convs() as calls:
        levers = {"dual residual": replace(setup["base_sweep"], table_dtype=torch.int8,
                                           residual_dtype="dual"),
                  f"production stack {setup['stack_mode']}": setup["stack"]}
        for name, config in levers.items():
            calls.clear()
            within, conf_within = _guardrail_shares(setup, config)
            ok = within >= 0.90 and conf_within >= 0.99 and calls
            print(f"omega chain guardrail at {GUARD_H}x{GUARD_W}, V={GUARD_V}, D={GUARD_D}, "
                  f"bf16, {name} with the chain ({len(calls)} int8 convolutions) vs the bf16 "
                  f"packed path: {within:.4%} of pixels within one bin, {conf_within:.4%} of "
                  f"the {setup['confident'].mean():.2%} confident ones (bars 90%, 99% "
                  f"confident) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                _fail(f"the {name} with the int8 omega chain fails the guardrail")


def _check_maps(out_root: str, maps: int, depth_min: float, depth_max: float) -> np.ndarray:
    """The PFMs of ``maps`` maps: shapes, finite values, depth in the sweep,
    confidence in (0, 1].  Returns map 0's depth."""
    from aa_rmvsnet_tpu_torch.core.pfm import read_pfm

    first = None
    for ref in range(maps):
        depth, _ = read_pfm(os.path.join(out_root, "scan1", "depth_est_0", f"{ref:08d}.pfm"))
        conf, _ = read_pfm(os.path.join(out_root, "scan1", "confidence_0", f"{ref:08d}.pfm"))
        if depth.shape != (MAIN_H, MAIN_W) or conf.shape != (MAIN_H, MAIN_W):
            _fail(f"map {ref}: shapes {depth.shape} / {conf.shape}")
        if not (np.isfinite(depth).all() and np.isfinite(conf).all()):
            _fail(f"map {ref}: non-finite values")
        if depth.min() < depth_min or depth.max() > depth_max:
            _fail(f"map {ref}: depth outside the sweep [{depth_min}, {depth_max}]")
        if conf.min() <= 0.0 or conf.max() > 1.0 + 1e-6:
            _fail(f"map {ref}: confidence outside (0, 1]")
        first = depth if first is None else first
    return first


def _main_scene():
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_scene

    return plane_scene(MAIN_H, MAIN_W, MAIN_V, MAIN_D, maps=MAIN_MAPS, **MAIN_PLANE,
                       depth_min=MAIN_DEPTH_MIN, depth_interval=MAIN_DEPTH_INTERVAL)


def phase_main(samples) -> tuple[int, np.ndarray, dict]:
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.ops.homography import max_depth_step_displacement
    from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference
    from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_model

    steps = [max_depth_step_displacement(s["proj_matrices"][1:], s["proj_matrices"][0],
                                         s["depth_values"], MAIN_H, MAIN_W) for s in samples]
    model = seeded_model(SEED)
    with tempfile.TemporaryDirectory() as out_root:
        torch.cuda.reset_peak_memory_stats()
        gates.launches = gates.backward_launches = 0
        stats = run_inference(model, samples,
                              InferConfig(out_root=out_root, num_workers=2, device="cuda"))
        launches = gates.launches
        backward = gates.backward_launches
        peak = torch.cuda.max_memory_allocated()
        expect = 5 * MAIN_D * MAIN_MAPS
        if stats["count"] != MAIN_MAPS or launches != expect or backward != 0:
            _fail(f"main path wrote {stats['count']} maps with {launches} gate "
                  f"kernel and {backward} backward launches; expected {MAIN_MAPS}, "
                  f"{expect} and 0")
        if stats["modes"] != [(True, 1, 4)] * MAIN_MAPS:
            _fail(f"main path took packed modes {stats['modes']}, not (True, 1, 4)")
        depth0 = _check_maps(out_root, MAIN_MAPS, MAIN_DEPTH_MIN,
                             MAIN_DEPTH_MIN + MAIN_DEPTH_INTERVAL * (MAIN_D - 1))
        maps = [_read_maps(out_root, ref) for ref in range(MAIN_MAPS)]
    secs = ", ".join(f"{s:.3f}" for s in stats["map_seconds"])
    gate_secs = ", ".join(f"{s:.3f}" for s in stats["gate_seconds"])
    print(f"main: run_inference, InferConfig() defaults (bf16, packed rows, fused residual), "
          f"at {MAIN_H}x{MAIN_W}, V={MAIN_V}, D={MAIN_D}, depth_block {MAIN_BLOCK}: "
          f"{MAIN_MAPS} maps, packed modes {stats['modes']}, gate's worst step "
          f"[{', '.join(f'{x:.4f}' for x in steps)}] px (8 hypotheses span "
          f"{7 * max(steps):.3f} px), gate host seconds [{gate_secs}], seconds per map "
          f"[{secs}], peak memory {peak / 2**30:.2f} GiB, gate kernel launches {launches} "
          f"(= 5 x {MAIN_D} x {MAIN_MAPS}, bf16); PFMs finite, depth in the sweep, "
          "confidence in (0, 1]", flush=True)
    return launches, depth0, {"map_seconds": stats["map_seconds"], "peak": peak,
                              "modes": stats["modes"], "maps": maps}


def _read_maps(out_root: str, ref: int) -> tuple:
    from aa_rmvsnet_tpu_torch.core.pfm import read_pfm

    return tuple(read_pfm(os.path.join(out_root, "scan1", family, f"{ref:08d}.pfm"))[0]
                 for family in ("depth_est_0", "confidence_0"))


def phase_main_exact(samples, phase5: dict) -> tuple[int, int]:
    """5b: one exact fp32 map, then map 0 in fp32 with packed rows and the
    seeded head attached (``depth_source`` wta); ``phase5`` gains them
    (``exact``, ``packed_fp32``), which the spatial split's fp32 maps are
    held to (5i), the head's four maps of the packed one (``packed_fp32_nig``,
    which 5l's split head on 5i's packed run is held to), and the bf16
    packed map 0's distance from the exact one (``bf16_vs_exact``: the
    share of depths within one bin, the confidence's max_abs_err), the
    calibration of the spatial split's bf16 smoke bar (5i, 5h).  Returns
    the two runs' gate launches."""
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference
    from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_head, seeded_model

    model = seeded_model(SEED)
    with tempfile.TemporaryDirectory() as out_root:
        torch.cuda.reset_peak_memory_stats()
        gates.launches = gates.backward_launches = 0
        stats = run_inference(model, samples[:1], InferConfig(
            out_root=out_root, feature_dtype=torch.float32, packed_rows=False,
            fused_residual=False, num_workers=2, device="cuda"))
        launches = gates.launches
        backward = gates.backward_launches
        peak = torch.cuda.max_memory_allocated()
        if stats["count"] != 1 or launches != 5 * MAIN_D or backward != 0 \
                or stats["modes"] != [(False, 1, 4)]:
            _fail(f"exact path wrote {stats['count']} maps in modes {stats['modes']} with "
                  f"{launches} gate kernel and {backward} backward launches; expected 1, "
                  f"(False, 1, 4), {5 * MAIN_D} and 0")
        _check_maps(out_root, 1, MAIN_DEPTH_MIN,
                    MAIN_DEPTH_MIN + MAIN_DEPTH_INTERVAL * (MAIN_D - 1))
        phase5["exact"] = _read_maps(out_root, 0)
        phase5["exact_seconds"] = stats["map_seconds"][0]
    head = seeded_head(SEED)
    hook = head.register_forward_hook(
        lambda module, args, out: phase5.update(packed_fp32_nig=_nig(out)))
    with tempfile.TemporaryDirectory() as out_root:
        gates.launches = gates.backward_launches = 0
        packed = run_inference(model, samples[:1], InferConfig(
            out_root=out_root, feature_dtype=torch.float32, num_workers=2, device="cuda",
            evidential=head))
        hook.remove()
        packed_launches = gates.launches
        if packed["count"] != 1 or packed_launches != 5 * MAIN_D \
                or gates.backward_launches != 0 or packed["modes"] != [(True, 1, 4)]:
            _fail(f"fp32 packed path wrote {packed['count']} maps in modes {packed['modes']} "
                  f"with {packed_launches} gate kernel and {gates.backward_launches} backward "
                  f"launches; expected 1, (True, 1, 4), {5 * MAIN_D} and 0")
        _check_maps(out_root, 1, MAIN_DEPTH_MIN,
                    MAIN_DEPTH_MIN + MAIN_DEPTH_INTERVAL * (MAIN_D - 1))
        phase5["packed_fp32"] = _read_maps(out_root, 0)
        phase5["packed_fp32_seconds"] = packed["map_seconds"][0]
        phase5["packed_fp32_head_seconds"] = packed["head_seconds"][0]
    within, conf_err = _distance(phase5["maps"][0], phase5["exact"])
    phase5["bf16_vs_exact"] = (within, conf_err)
    print(f"main-exact: run_inference, fp32, packed_rows=False, fused_residual=False, at "
          f"{MAIN_H}x{MAIN_W}, V={MAIN_V}, D={MAIN_D}: 1 map in {stats['map_seconds'][0]:.3f} s, "
          f"peak memory {peak / 2**30:.2f} GiB, gate kernel launches {launches} "
          f"(= 5 x {MAIN_D}, fp32); the bf16 packed map 0 is within one depth bin of it on "
          f"{within:.4%} of pixels, confidence max_abs_err {conf_err:.3e}; map 0 in fp32 with "
          f"packed rows (mode (True, 1, 4)) in {packed['map_seconds'][0]:.3f} s, the seeded "
          f"head on it {packed['head_seconds'][0]:.3f} s (5l's serial reference), gate kernel "
          f"launches {packed_launches}", flush=True)
    return launches, packed_launches


NIG = ("gamma", "nu", "alpha", "beta")


def _nig(out: dict) -> np.ndarray:
    """The head's four maps of a sample, ``(4, H, W)`` on the host, from
    its outputs (a forward hook's)."""
    return torch.stack([out[k][0] for k in NIG]).float().cpu().numpy()


def _distance(got: tuple, want: tuple) -> tuple[float, float]:
    """Of two ``(depth, confidence)`` maps: the share of depths within one
    bin, and the confidence's max_abs_err."""
    within = float(np.mean(np.abs(got[0] - want[0]) <= MAIN_DEPTH_INTERVAL + 1e-6))
    return within, float(np.abs(got[1] - want[1]).max())


def _bf16_held_to_exact(label: str, got: tuple, phase5: dict) -> str:
    """A bf16 map 0 of the spatial split against phase 5b's exact fp32 map,
    at least as close as phase 5's own bf16 map is: its depths within one
    bin on no fewer pixels, less 5 points, and its confidence within twice
    that map's max_abs_err.  A smoke check: with the seeded (untrained)
    weights one bf16 rounding anywhere moves a quarter of the depths by
    more than a bin (phase 5 against 5b), so two bf16 sweeps whose sums
    associate differently (the row split's GroupNorm statistics, cuDNN's
    algorithms at the slab's shapes) cannot agree bit for bit; the split
    itself, packed rows and the exact path, is held at 5f's bars in fp32
    (5i)."""
    within, conf_err = _distance(got, phase5["exact"])
    serial_within, serial_conf = phase5["bf16_vs_exact"]
    equal = float(np.mean(got[0] == phase5["maps"][0][0]))
    ok = within >= serial_within - 0.05 and conf_err <= 2 * serial_conf
    text = (f"against 5b's exact fp32 map: depth within one bin on {within:.4%} of pixels "
            f"(bar: phase 5's bf16 map's {serial_within:.4%} less 5 points), confidence "
            f"max_abs_err {conf_err:.3e} (bar: twice phase 5's {serial_conf:.3e}); depth "
            f"equal to phase 5's bf16 map on {equal:.4%} of pixels")
    if not ok:
        _fail(f"{label}: bf16 map farther from the exact one than phase 5's: {text}")
    return text


def phase_evidential(samples) -> tuple[int, int, dict]:
    from aa_rmvsnet_tpu_torch.core.pfm import read_pfm
    from aa_rmvsnet_tpu_torch.models import evidential_apply
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference
    from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_head, seeded_model

    # The head alone, CUDA against CPU, at the bars of the CPU tests.
    rng = np.random.RandomState(SEED + 8)
    cost = torch.from_numpy((3.0 * rng.randn(1, EV_D, EV_H, EV_W)).astype(np.float32))
    dvals = torch.from_numpy(
        (MAIN_DEPTH_MIN + 2.75 * np.arange(EV_D, dtype=np.float32))[None])
    head = seeded_head(SEED)
    outs = {}
    with torch.inference_mode():
        for dev in ("cpu", "cuda"):
            head.to(dev)
            out = evidential_apply(head, cost.to(dev), dvals.to(dev))
            outs[dev] = {k: v.cpu() for k, v in out.items()}
    errs = {k: (outs["cuda"][k] - outs["cpu"][k]).abs().max().item() for k in EV_BARS}
    ok = all(errs[k] <= bar for k, bar in EV_BARS.items())
    print(f"evidential: head CUDA vs CPU at {EV_H}x{EV_W}, D={EV_D}, seeded weights, fp32: "
          + ", ".join(f"{k} max_abs_err {errs[k]:.3e} (bar {bar:g})" for k, bar in EV_BARS.items())
          + f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        _fail("the evidential head on CUDA disagrees with the CPU")

    # The main path with a head: one dtu_eval map, InferConfig() defaults.
    # Hooks on the head read the memory when it starts and its outputs'
    # ranges, and keep its input (held by evidential_apply while the head
    # runs in any case) and its maps for 5l; they launch no gate kernel.
    model, head = seeded_model(SEED), seeded_head(SEED)
    marks = {}

    def before_head(module, args):
        torch.cuda.synchronize()
        marks["core_peak"] = torch.cuda.max_memory_allocated()
        marks["held"] = torch.cuda.memory_allocated()
        marks["prob"], marks["dvals"] = args[0], args[1]
        torch.cuda.reset_peak_memory_stats()

    def after_head(module, args, out):
        marks["gamma"] = (out["gamma"].min().item(), out["gamma"].max().item())
        marks["nu_min"] = out["nu"].min().item()
        marks["alpha_min"] = out["alpha"].min().item()
        marks["nig"] = _nig(out)

    hooks = [head.register_forward_pre_hook(before_head), head.register_forward_hook(after_head)]
    depth_max = MAIN_DEPTH_MIN + MAIN_DEPTH_INTERVAL * (MAIN_D - 1)
    with tempfile.TemporaryDirectory() as out_root:
        torch.cuda.reset_peak_memory_stats()
        gates.launches = gates.backward_launches = 0
        stats = run_inference(model, samples[:1], InferConfig(
            out_root=out_root, num_workers=2, device="cuda", evidential=head,
            depth_source="evidential"))
        launches, backward = gates.launches, gates.backward_launches
        head_peak = torch.cuda.max_memory_allocated()
        for hook in hooks:
            hook.remove()
        head_input = {"prob": marks.pop("prob").cpu().numpy(),
                      "dvals": marks.pop("dvals").cpu().numpy(), "nig": marks["nig"],
                      "seconds": stats["head_seconds"][0], "peak": head_peak,
                      "maxdisp": head.maxdisp}
        if stats["count"] != 1 or launches != 5 * MAIN_D or backward != 0 \
                or stats["modes"] != [(True, 1, 4)]:
            _fail(f"evidential path wrote {stats['count']} maps in modes {stats['modes']} "
                  f"with {launches} gate kernel and {backward} backward launches; expected 1, "
                  f"(True, 1, 4), {5 * MAIN_D} and 0")
        maps = {}
        for family in ("depth_est_0", "confidence_0", "aleatoric_0", "epistemic_0"):
            maps[family], _ = read_pfm(os.path.join(out_root, "scan1", family, "00000000.pfm"))
            if maps[family].shape != (MAIN_H, MAIN_W) or not np.isfinite(maps[family]).all():
                _fail(f"evidential {family}: shape {maps[family].shape} or non-finite values")
    gamma = maps["depth_est_0"]
    if gamma.min() < MAIN_DEPTH_MIN - 1e-3 or gamma.max() > depth_max + 1e-3:
        _fail(f"evidential gamma [{gamma.min()}, {gamma.max()}] outside the sweep "
              f"[{MAIN_DEPTH_MIN}, {depth_max}]")
    if not (marks["nu_min"] > 0.0 and marks["alpha_min"] > 1.0):
        _fail(f"evidential nu min {marks['nu_min']}, alpha min {marks['alpha_min']}")
    print(f"evidential: run_inference, InferConfig() defaults (bf16, packed rows, fused "
          f"residual) + seeded head (fp32), depth_source evidential, at {MAIN_H}x{MAIN_W}, "
          f"V={MAIN_V}, D={MAIN_D}: 1 map, packed mode {stats['modes'][0]}, core "
          f"{stats['map_seconds'][0]:.3f} s (timed window, as phase 5), head "
          f"{stats['head_seconds'][0]:.3f} s; peak memory of the core with the collected volume "
          f"{marks['core_peak'] / 2**30:.2f} GiB, held when the head starts "
          f"{marks['held'] / 2**30:.2f} GiB, peak during the head {head_peak / 2**30:.2f} GiB "
          f"(phase 5 gives the map without head or volume); gamma in "
          f"[{marks['gamma'][0]:.3f}, {marks['gamma'][1]:.3f}] (sweep [{MAIN_DEPTH_MIN}, "
          f"{depth_max}]), nu min {marks['nu_min']:.3e}, alpha min {marks['alpha_min']:.4f}, "
          f"aleatoric in [{maps['aleatoric_0'].min():.4g}, {maps['aleatoric_0'].max():.4g}], "
          f"epistemic in [{maps['epistemic_0'].min():.4g}, {maps['epistemic_0'].max():.4g}]; "
          f"gate kernel launches {launches} (= 5 x {MAIN_D}), backward {backward}; four PFM "
          "families finite", flush=True)
    return launches, backward, head_input


def _production_stack_map(samples, label: str) -> dict:
    """One map of the phase-5 scene through ``run_inference`` with the JAX
    package's production stack of levers (``cli eval --int8_tables
    --dual_residual --gather_pack 2 --table_taps 6``): its mode (True, 2,
    4), 5 x D forward and no backward gate launches asserted, its PFMs
    checked as phase 5's.  Returns its seconds, peak memory, launches, map
    0's depth and the int8 convolutions omega ran."""
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference
    from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_model

    model = seeded_model(SEED)
    with tempfile.TemporaryDirectory() as out_root, _int8_convs() as convs:
        torch.cuda.reset_peak_memory_stats()
        gates.launches = gates.backward_launches = 0
        stats = run_inference(model, samples[:1], InferConfig(
            out_root=out_root, table_dtype=torch.int8, residual_dtype="dual", gather_pack=2,
            table_taps=6, num_workers=2, device="cuda"))
        launches = gates.launches
        backward = gates.backward_launches
        peak = torch.cuda.max_memory_allocated()
        if stats["count"] != 1 or launches != 5 * MAIN_D or backward != 0 \
                or stats["modes"] != [(True, 2, 4)]:
            _fail(f"{label} wrote {stats['count']} maps in modes "
                  f"{stats['modes']} with {launches} gate kernel and {backward} backward "
                  f"launches; expected 1, (True, 2, 4), {5 * MAIN_D} and 0")
        depth0 = _check_maps(out_root, 1, MAIN_DEPTH_MIN,
                             MAIN_DEPTH_MIN + MAIN_DEPTH_INTERVAL * (MAIN_D - 1))
    return {"seconds": stats["map_seconds"][0], "peak": peak, "launches": launches,
            "depth": depth0, "int8_convs": len(convs)}


def phase_main_levers(samples, packed_depth0: np.ndarray, phase5: dict) -> dict:
    """5d: the production stack's map; returns :func:`_production_stack_map`'s
    result with its depths' share within one bin of phase 5's map 0."""
    run = _production_stack_map(samples, "the production stack")
    run["within_phase5"] = np.mean(np.abs(run["depth"] - packed_depth0)
                                   <= MAIN_DEPTH_INTERVAL + 1e-6)
    print(f"main-levers: run_inference, the production stack (bf16, int8 tables, dual "
          f"residual, gather_pack 2, table_taps 6, fused residual) at {MAIN_H}x{MAIN_W}, "
          f"V={MAIN_V}, D={MAIN_D}: packed mode (True, 2, 4), 1 map in "
          f"{run['seconds']:.3f} s (phase 5: "
          f"[{', '.join(f'{x:.3f}' for x in phase5['map_seconds'])}] s), peak memory "
          f"{run['peak'] / 2**30:.2f} GiB (phase 5: {phase5['peak'] / 2**30:.2f} GiB), gate "
          f"kernel launches {run['launches']} (= 5 x {MAIN_D}), backward 0; its depths within "
          f"one bin of phase 5's map 0 on {run['within_phase5']:.4%} of pixels", flush=True)
    return run


def phase_main_levers_chain(samples, phase5d: dict) -> int:
    """5j: 5d's map with the int8 omega chain on (``AA_RMVSNET_OMEGA_INT8=
    chain``): omega's 4 int8 convolutions for each of its 256 calls (4
    source views x 64 blocks of 8) where 5d ran 1, its seconds and peak
    memory beside 5d's, and its depths within one bin of 5d's map on no
    fewer pixels than 5d's are of phase 5's (the chain moves the map no
    more than the stack's own levers do).  Returns its gate launches."""
    with _omega_chain_on():
        run = _production_stack_map(samples, "the production stack with the chain")
    calls = (MAIN_V - 1) * (MAIN_D // MAIN_BLOCK)
    within = np.mean(np.abs(run["depth"] - phase5d["depth"]) <= MAIN_DEPTH_INTERVAL + 1e-6)
    ok = (run["int8_convs"] == 4 * calls and phase5d["int8_convs"] == calls
          and within >= phase5d["within_phase5"])
    print(f"main-levers-chain: run_inference, the production stack with the int8 omega chain "
          f"at {MAIN_H}x{MAIN_W}, V={MAIN_V}, D={MAIN_D}: packed mode (True, 2, 4), omega's "
          f"int8 convolutions {run['int8_convs']} (5d: {phase5d['int8_convs']}), 1 map in "
          f"{run['seconds']:.3f} s (5d: {phase5d['seconds']:.3f} s), peak memory "
          f"{run['peak'] / 2**30:.2f} GiB (5d: {phase5d['peak'] / 2**30:.2f} GiB), gate kernel "
          f"launches {run['launches']} (= 5 x {MAIN_D}), backward 0; its depths within one bin "
          f"of 5d's map on {within:.4%} of pixels (bar: 5d's share against phase 5's, "
          f"{phase5d['within_phase5']:.4%}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        _fail("the production stack with the int8 omega chain")
    return run["launches"]


def _dtu_train_sample():
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_train_sample

    # DTU training cameras at 160x128 have a focal length of ~361 px.
    return plane_train_sample(TRAIN_H, TRAIN_W, TRAIN_V, TRAIN_D, seed=SEED + 5,
                              focal=361.54, baseline=20.0, plane_depth=600.0,
                              depth_min=425.0, depth_interval=2.65)


def phase_train() -> dict:
    from aa_rmvsnet_tpu_torch.models import AARMVSNetCore
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.pipeline.checkpoint import restore_latest
    from aa_rmvsnet_tpu_torch.pipeline.train import TrainConfig, make_optimizer, run_training
    from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_model

    dataset = [_dtu_train_sample()] * TRAIN_STEPS
    model = seeded_model(SEED)
    with tempfile.TemporaryDirectory() as logdir:
        config = TrainConfig(
            learning_rate=1e-3, lr_min=2e-6, total_steps=DTU_TRAIN_TOTAL_STEPS,
            depth_block=TRAIN_BLOCK, epochs=1, batch_size=1, num_workers=2,
            summary_freq=TRAIN_STEPS, logdir=logdir, device="cuda",
        )
        torch.cuda.reset_peak_memory_stats()
        gates.launches = gates.backward_launches = 0
        stats = run_training(model, dataset, config)
        launches, backward = gates.launches, gates.backward_launches
        peak = torch.cuda.max_memory_allocated()
        losses = stats["losses"]
        expect = (2 * 5 * TRAIN_D * TRAIN_STEPS, 5 * TRAIN_D * TRAIN_STEPS)
        if stats["step"] != TRAIN_STEPS or (launches, backward) != expect:
            _fail(f"training main path ran {stats['step']} steps with {launches} forward "
                  f"and {backward} backward gate-kernel launches; expected "
                  f"{TRAIN_STEPS}, {expect[0]} and {expect[1]}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            _fail(f"training losses not finite and falling: {losses}")

        # The checkpoint of step 8 restores bit for bit into a fresh model
        # and optimizer, and the resumed run trains one more finite step.
        fresh = AARMVSNetCore().cuda()
        optimizer, scheduler = make_optimizer(fresh.parameters(), config,
                                              DTU_TRAIN_TOTAL_STEPS)
        restored = restore_latest(logdir, fresh, optimizer, scheduler)
        same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                      fresh.state_dict().values()))
        if restored != TRAIN_STEPS or not same:
            _fail(f"checkpoint restored step {restored}, weights equal: {same}")
        resumed = run_training(AARMVSNetCore(), dataset,
                               replace(config, epochs=2, max_steps=1, resume=True))
        if (resumed["start_step"], resumed["step"]) != (TRAIN_STEPS, TRAIN_STEPS + 1) \
                or not np.isfinite(resumed["losses"]).all():
            _fail(f"resumed run: {resumed}")
    secs = ", ".join(f"{s:.3f}" for s in stats["step_seconds"])
    print(f"train: run_training at {TRAIN_H}x{TRAIN_W}, V={TRAIN_V}, D={TRAIN_D}, "
          f"depth_block {TRAIN_BLOCK}, batch 1, fp32, Adam 1e-3: {TRAIN_STEPS} steps, "
          f"seconds per step [{secs}], peak memory {peak / 2**30:.2f} GiB, losses "
          f"[{', '.join(f'{x:.4f}' for x in losses)}], gate kernel launches forward "
          f"{launches} (= 2 x 5 x {TRAIN_D} x {TRAIN_STEPS}), backward {backward} "
          f"(= 5 x {TRAIN_D} x {TRAIN_STEPS}); checkpoint of step {restored} restored "
          f"bit for bit, resumed step {resumed['step']} loss "
          f"{resumed['losses'][0]:.4f}", flush=True)
    return {"launches": launches, "backward": backward, "step_seconds": stats["step_seconds"],
            "peak": peak}


def phase_train_evidential() -> tuple[int, int]:
    from aa_rmvsnet_tpu_torch.models import AARMVSNetCore, EvidentialHead
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.pipeline.checkpoint import checkpoint_path, restore_latest
    from aa_rmvsnet_tpu_torch.pipeline.train import (
        TrainConfig,
        make_optimizer,
        run_training,
        trainable_parameters,
    )
    from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_model

    dataset = [_dtu_train_sample()] * TRAIN_STEPS
    model = seeded_model(SEED)
    # cli train --evidential's fresh head: the JAX init, from seed 1.
    head = EvidentialHead(TRAIN_MAXDISP, generator=torch.Generator().manual_seed(1))
    stats0 = {n: b.clone() for n, b in head.named_buffers() if n.endswith(("_mean", "_var"))}
    with tempfile.TemporaryDirectory() as logdir:
        config = TrainConfig(
            learning_rate=1e-3, lr_min=2e-6, total_steps=DTU_TRAIN_TOTAL_STEPS,
            depth_block=TRAIN_BLOCK, epochs=1, batch_size=1, num_workers=2,
            summary_freq=TRAIN_STEPS, logdir=logdir, device="cuda", evidential=True,
            maxdisp=TRAIN_MAXDISP,
        )
        torch.cuda.reset_peak_memory_stats()
        gates.launches = gates.backward_launches = 0
        stats = run_training(model, dataset, config, head=head)
        launches, backward = gates.launches, gates.backward_launches
        peak = torch.cuda.max_memory_allocated()
        losses = stats["losses"]
        expect = (2 * 5 * TRAIN_D * TRAIN_STEPS, 5 * TRAIN_D * TRAIN_STEPS)
        if stats["step"] != TRAIN_STEPS or (launches, backward) != expect:
            _fail(f"evidential training ran {stats['step']} steps with {launches} forward "
                  f"and {backward} backward gate-kernel launches; expected "
                  f"{TRAIN_STEPS}, {expect[0]} and {expect[1]}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            _fail(f"evidential training losses not finite and falling: {losses}")
        moved = sum(not torch.equal(b.cpu(), stats0[n]) for n, b in head.named_buffers()
                    if n in stats0)
        if moved != len(stats0):
            _fail(f"only {moved} of {len(stats0)} BatchNorm statistics changed")

        # The checkpoint of step 8 restores core, head (with its statistics)
        # and the Adam moments bit for bit into fresh modules and a fresh
        # optimizer, and the resumed run trains one more finite step.
        fresh, fresh_head = AARMVSNetCore().cuda(), EvidentialHead(TRAIN_MAXDISP).cuda()
        optimizer, scheduler = make_optimizer(trainable_parameters(fresh, fresh_head), config,
                                              DTU_TRAIN_TOTAL_STEPS)
        restored = restore_latest(logdir, fresh, optimizer, scheduler, head=fresh_head)
        same = all(torch.equal(a, b) for m, f in ((model, fresh), (head, fresh_head))
                   for a, b in zip(m.state_dict().values(), f.state_dict().values()))
        saved = torch.load(checkpoint_path(logdir, TRAIN_STEPS), map_location="cpu",
                           weights_only=True)["optimizer"]["state"]
        moments = [(optimizer.state[p], saved[i])
                   for i, p in enumerate(optimizer.param_groups[0]["params"])]
        same_adam = len(saved) == len(moments) and all(
            torch.equal(state[k].cpu(), want[k]) for state, want in moments
            for k in ("exp_avg", "exp_avg_sq", "step"))
        if restored != TRAIN_STEPS or not same or not same_adam:
            _fail(f"evidential checkpoint restored step {restored}, weights and statistics "
                  f"equal: {same}, Adam moments equal: {same_adam}")
        resumed = run_training(AARMVSNetCore(), dataset,
                               replace(config, epochs=2, max_steps=1, resume=True),
                               head=EvidentialHead(TRAIN_MAXDISP))
        if (resumed["start_step"], resumed["step"]) != (TRAIN_STEPS, TRAIN_STEPS + 1) \
                or not np.isfinite(resumed["losses"]).all():
            _fail(f"resumed evidential run: {resumed}")
    secs = ", ".join(f"{s:.3f}" for s in stats["step_seconds"])
    print(f"train-evidential: run_training, evidential=True, at {TRAIN_H}x{TRAIN_W}, "
          f"V={TRAIN_V}, D={TRAIN_D}, depth_block {TRAIN_BLOCK}, maxdisp {TRAIN_MAXDISP}, "
          f"batch 1, fp32, Adam 1e-3 over core and head: {TRAIN_STEPS} steps, seconds per "
          f"step [{secs}], peak memory {peak / 2**30:.2f} GiB, losses "
          f"[{', '.join(f'{x:.4f}' for x in losses)}], {moved} BatchNorm statistics changed, "
          f"gate kernel launches forward {launches} (= 2 x 5 x {TRAIN_D} x {TRAIN_STEPS}), "
          f"backward {backward} (= 5 x {TRAIN_D} x {TRAIN_STEPS}); checkpoint of step "
          f"{restored} restored bit for bit (core, head, statistics, Adam moments), resumed "
          f"step {resumed['step']} loss {resumed['losses'][0]:.4f}", flush=True)
    return launches, backward


def phase_train_bf16(phase6: dict) -> dict:
    """Phase 6c: ``run_training`` in bf16 at ``dtu_train``, then one step
    with ``fold_omega=True``; returns the launches of both paths."""
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.pipeline.train import TrainConfig, run_training
    from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_model

    counters = ("launches", "backward_launches", "bf16_launches", "bf16_backward_launches")
    sample = _dtu_train_sample()
    config = TrainConfig(
        learning_rate=1e-3, lr_min=2e-6, total_steps=DTU_TRAIN_TOTAL_STEPS,
        depth_block=TRAIN_BLOCK, epochs=1, batch_size=1, num_workers=2,
        summary_freq=TRAIN_STEPS, device="cuda", feature_dtype=torch.bfloat16,
    )
    model = seeded_model(SEED)
    before = [p.detach().clone() for p in model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    for k in counters:
        setattr(gates, k, 0)
    stats = run_training(model, [sample] * TRAIN_STEPS, config)
    launched = tuple(getattr(gates, k) for k in counters)
    peak = torch.cuda.max_memory_allocated()
    losses = stats["losses"]
    expect = (2 * 5 * TRAIN_D * TRAIN_STEPS, 5 * TRAIN_D * TRAIN_STEPS) * 2
    if stats["step"] != TRAIN_STEPS or launched != expect:
        _fail(f"bf16 training ran {stats['step']} steps with gate-kernel launches {launched} "
              f"(forward, backward, bf16 forward, bf16 backward); expected {TRAIN_STEPS}, "
              f"{expect}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        _fail(f"bf16 training losses not finite and falling: {losses}")
    moved = sum(not torch.equal(p.detach().cpu(), b) for p, b in zip(model.parameters(), before))
    if any(p.dtype != torch.float32 for p in model.parameters()) or moved == 0:
        _fail(f"bf16 training: master weights not fp32 or unchanged ({moved} moved)")

    # One step with folded omega (fp32), JAX's other training lever.
    fold = TrainConfig(**{**config.__dict__, "feature_dtype": torch.float32,
                          "fold_omega": True, "summary_freq": 1})
    model = seeded_model(SEED)
    torch.cuda.reset_peak_memory_stats()
    for k in counters:
        setattr(gates, k, 0)
    fold_stats = run_training(model, [sample], fold)
    fold_launched = tuple(getattr(gates, k) for k in counters)
    fold_peak = torch.cuda.max_memory_allocated()
    if fold_launched != (2 * 5 * TRAIN_D, 5 * TRAIN_D, 0, 0) \
            or not np.isfinite(fold_stats["losses"]).all():
        _fail(f"fold_omega=True step: launches {fold_launched}, losses {fold_stats['losses']}")

    def mean_after_first(secs):
        return float(np.mean(secs[1:])) if len(secs) > 1 else float(secs[0])

    secs = ", ".join(f"{x:.3f}" for x in stats["step_seconds"])
    print(f"train-bf16: run_training, feature_dtype=torch.bfloat16, at {TRAIN_H}x{TRAIN_W}, "
          f"V={TRAIN_V}, D={TRAIN_D}, depth_block {TRAIN_BLOCK}, batch 1, fp32 master weights "
          f"and Adam: {TRAIN_STEPS} steps, seconds per step [{secs}], mean of steps 2-"
          f"{TRAIN_STEPS} {mean_after_first(stats['step_seconds']):.3f} s against phase 6's "
          f"fp32 {mean_after_first(phase6['step_seconds']):.3f} s; peak memory "
          f"{peak / 2**30:.2f} GiB against {phase6['peak'] / 2**30:.2f}; losses "
          f"[{', '.join(f'{x:.4f}' for x in losses)}]; gate kernel launches forward "
          f"{launched[0]} (= 2 x 5 x {TRAIN_D} x {TRAIN_STEPS}, all bf16), backward "
          f"{launched[1]} (= 5 x {TRAIN_D} x {TRAIN_STEPS}, all bf16); {moved} parameter "
          f"tensors moved, all fp32", flush=True)
    print(f"train-fold: one run_training step with fold_omega=True, fp32, at the same "
          f"geometry: {fold_stats['step_seconds'][0]:.3f} s (the first step of a process "
          f"section, against phase 6's first {phase6['step_seconds'][0]:.3f} s), peak memory "
          f"{fold_peak / 2**30:.2f} GiB, loss {fold_stats['losses'][0]:.4f}, gate kernel "
          f"launches forward {fold_launched[0]}, backward {fold_launched[1]}", flush=True)
    return {"training_bf16": launched[:2], "training_fold_omega": fold_launched[:2]}


# One rank of phases 6d-6g: for each case (the core, then the core with
# the head), a train_step of the seeded weights on its rows of the batch,
# under a gloo mesh on cuda:0 with a data axis of 2 (6d), a view axis of 2
# (6e) or a spatial axis of 2 (6f, 6g; the head's labels stay whole) (mode
# "rank"), or a world-size-1 NCCL group's step of the core against the
# step without a mesh (mode "nccl"), with the step's calls of
# torch.distributed.all_reduce counted; the results go to a torch.save
# file.  A warm-up step on a copy of the weights comes first, so
# that the compared step does not pay the first calls; "timed" more steps
# after it (two by default; none for 6g, whose steps take ~12 s) are
# timed.
DP_WORKER = """
import json, sys, time
import numpy as np, torch
from aa_rmvsnet_tpu_torch.models import AARMVSNetCore, EvidentialHead
from aa_rmvsnet_tpu_torch.ops import gates
from aa_rmvsnet_tpu_torch.parallel import initialize_distributed, make_mesh
from aa_rmvsnet_tpu_torch.pipeline.train import (
    TrainConfig, batch_rows, make_optimizer, train_step, trainable_parameters)
from aa_rmvsnet_tpu_torch.utils.device import disable_tf32

a = json.loads(sys.argv[1])
disable_tf32()
if a["mode"] == "rank":
    initialize_distributed(f"localhost:{a['port']}", 2, a["rank"], backend="gloo")
else:
    torch.distributed.init_process_group("nccl", init_method=f"tcp://localhost:{a['port']}",
                                         world_size=1, rank=0)
mesh = make_mesh(view=a["view"], spatial=a["spatial"], device="cuda")
weights = torch.load(a["weights"], weights_only=True)
data = np.load(a["batch"])
rows = slice(*a["rows"])
whole = {k: torch.from_numpy(np.ascontiguousarray(data[k][rows])).cuda() for k in data.files}
all_reduces = [0]
all_reduce = torch.distributed.all_reduce


def counted_all_reduce(*args, **kwargs):
    all_reduces[0] += 1
    return all_reduce(*args, **kwargs)


torch.distributed.all_reduce = counted_all_reduce


def step(with_mesh, evidential, timed_after=0):
    model = AARMVSNetCore()
    model.load_state_dict(weights["core"])
    head = None
    if evidential:
        head = EvidentialHead(a["maxdisp"])
        head.load_state_dict(weights["head"])
        head.cuda()
    model.cuda()
    config = TrainConfig(depth_block=a["block"], device="cuda", evidential=evidential,
                         maxdisp=a["maxdisp"], mesh=mesh if with_mesh else None)
    optimizer, scheduler = make_optimizer(trainable_parameters(model, head), config,
                                          a["total_steps"])
    batch = batch_rows(whole, config.mesh)
    gates.launches = gates.backward_launches = all_reduces[0] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, _ = train_step(model, optimizer, scheduler, batch, config, head)
    torch.cuda.synchronize()
    seconds = [time.perf_counter() - t0]
    out = {"peak": torch.cuda.max_memory_allocated(),
           "launches": (gates.launches, gates.backward_launches),
           "all_reduces": all_reduces[0],
           "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
           "state": {k: v.cpu() for k, v in model.state_dict().items()}}
    if head is not None:
        out["grads"].update({"evidential." + n: p.grad.cpu() for n, p in head.named_parameters()})
        out["state"].update({"evidential." + k: v.cpu() for k, v in head.state_dict().items()})
    for _ in range(timed_after):
        t0 = time.perf_counter()
        train_step(model, optimizer, scheduler, batch, config, head)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    out["seconds"] = seconds
    return out


out = {}
for evidential in a["cases"]:
    step(a["mode"] == "rank", evidential)  # warm-up
    out[evidential] = step(True, evidential, timed_after=a.get("timed", 2))
if a["mode"] == "nccl":
    out = {"mesh": out[False], "plain": step(False, False),
           "backend": torch.distributed.get_backend()}
torch.save(out, a["out"])
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _run_workers(argss: list[dict], workdir: str, timeout: float = 600,
                 worker: str = DP_WORKER) -> list[dict]:
    """Run ``worker`` once per argument dict, all at once, under one
    deadline; a hang or a failed process fails the phase."""
    procs = []
    for i, args in enumerate(argss):
        args = {**args, "out": os.path.join(workdir, f"out{i}.pt")}
        procs.append((subprocess.Popen(
            [sys.executable, "-c", worker, json.dumps(args)], cwd=os.getcwd(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), args["out"]))
    try:
        results = [proc.communicate(timeout=timeout) for proc, _ in procs]
    except subprocess.TimeoutExpired:
        _fail(f"the ranks did not finish in {timeout} s")
    finally:
        for proc, _ in procs:
            proc.kill()
    for (proc, _), (_, err) in zip(procs, results):
        if proc.returncode != 0:
            _fail(f"a rank exited with {proc.returncode}: {err[-2000:]}")
    return [torch.load(out, weights_only=False) for _, out in procs]


def _single_step(weights: dict, batch: dict, evidential: bool, nudge: float = 0.0) -> dict:
    """The same step in this process on the whole global batch, no mesh."""
    from aa_rmvsnet_tpu_torch.models import AARMVSNetCore, EvidentialHead
    from aa_rmvsnet_tpu_torch.pipeline.train import (
        TrainConfig,
        make_optimizer,
        train_step,
        trainable_parameters,
    )

    model = AARMVSNetCore()
    model.load_state_dict(weights["core"])
    head = None
    if evidential:
        head = EvidentialHead(TRAIN_MAXDISP)
        head.load_state_dict(weights["head"])
    if nudge:
        noise = torch.Generator().manual_seed(SEED + 12)
        with torch.no_grad():
            for p in trainable_parameters(model, head):
                p.mul_(1 + nudge * torch.randn(p.shape, generator=noise))
    model.cuda()
    if head is not None:
        head.cuda()
    config = TrainConfig(depth_block=TRAIN_BLOCK, device="cuda", evidential=evidential,
                         maxdisp=TRAIN_MAXDISP)
    optimizer, scheduler = make_optimizer(trainable_parameters(model, head), config,
                                          DTU_TRAIN_TOTAL_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, _ = train_step(model, optimizer, scheduler,
                            {k: torch.from_numpy(v).cuda() for k, v in batch.items()},
                            config, head)
    torch.cuda.synchronize()
    out = {"seconds": time.perf_counter() - t0, "peak": torch.cuda.max_memory_allocated(),
           "metrics": {k: float(v) for k, v in metrics.items()},
           "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
           "state": {k: v.cpu() for k, v in model.state_dict().items()}}
    if head is not None:
        out["grads"].update({"evidential." + n: p.grad.cpu() for n, p in head.named_parameters()})
        out["state"].update({"evidential." + k: v.cpu() for k, v in head.state_dict().items()})
    return out


def _hold_ranks_to_single(label: str, ranks: list, weights: dict, batch: dict,
                          evidential: bool, wall: float, phase6: dict, launched: list,
                          what: str) -> None:
    """The ranks' step against this process's step on ``batch`` (the
    global batch) at phase 6d's bars: the ranks' weights equal bit for bit,
    the loss rtol 1e-5, the worst gradient within max(2e-4, 10 x the step's
    own move under 1e-7 weight noise), the updated weights 1e-6 where the
    gradient's sign is settled (2 x the rate elsewhere: Adam's first step),
    the BatchNorm statistics 1e-5 of their size; each rank's gate launches
    2 x 5 x D forward and 5 x D backward, added to ``launched``."""
    single = _single_step(weights, batch, evidential)
    nudged = _single_step(weights, batch, evidential, nudge=1e-7)
    for r in ranks:
        if r["launches"] != (2 * 5 * TRAIN_D, 5 * TRAIN_D):
            _fail(f"{label}: a rank launched the gate kernels {r['launches']} times")
        launched[0] += r["launches"][0]
        launched[1] += r["launches"][1]
    same = all(torch.equal(t, ranks[1]["state"][k]) for k, t in ranks[0]["state"].items())
    loss, want = ranks[0]["metrics"]["loss"], single["metrics"]["loss"]
    loss_rel = abs(loss - want) / abs(want)
    grad_name, grad_err = _worst(single["grads"], ranks[0]["grads"])
    move_name, move = _worst(single["grads"], nudged["grads"])
    bar = max(2e-4, 10 * move)
    # Adam's first step moves a weight by ~lr times its gradient's
    # sign: where the gradient is inside its bar of 0 the sign, and
    # the move, are rounding (within 2 lr); elsewhere 1e-6.
    weight_err = 0.0
    for k, g in single["grads"].items():
        settled = g.abs() > 2 * bar * max(g.abs().max().item(), 1e-3)
        err = (ranks[0]["state"][k] - single["state"][k]).abs()
        if err.max().item() > 2e-3:
            _fail(f"{label}: weight {k} moved {err.max().item():.3e} from the "
                  "single-process step, more than 2 x the rate")
        weight_err = max(weight_err, err[settled].max().item() if settled.any() else 0)
    stats = {k: v for k, v in single["state"].items()
             if k.endswith(("running_mean", "running_var"))}
    stat_err = max((((ranks[0]["state"][k] - v).abs().max().item()
                     / max(v.abs().max().item(), 1e-3)) for k, v in stats.items()),
                   default=0.0)
    ok = (same and loss_rel <= 1e-5 and grad_err <= bar and weight_err <= 1e-6
          and stat_err <= 1e-5)
    batch_size = len(batch["imgs"])
    head = f", maxdisp {TRAIN_MAXDISP}" if evidential else ""
    print(f"{label}: {what}, {TRAIN_H}x{TRAIN_W}, V={TRAIN_V}, D={TRAIN_D}{head}: ranks "
          f"equal bit for bit {same}; loss {loss:.6f} vs {want:.6f} (rel "
          f"{loss_rel:.2e}, bar 1e-5); gradients worst {grad_err:.2e} ({grad_name}), "
          f"bar {bar:.2e} (the single step's move under 1e-7 weight noise {move:.2e}, "
          f"{move_name}); updated weights {weight_err:.2e} where the gradient is "
          f"settled (bar 1e-6); {len(stats)} BatchNorm statistics worst "
          f"{stat_err:.2e} (bar 1e-5); seconds a step after a warm-up one: ranks "
          f"[{', '.join(f'{x:.3f}' for x in ranks[0]['seconds'])}], "
          f"[{', '.join(f'{x:.3f}' for x in ranks[1]['seconds'])}] (two processes "
          f"sharing the card, {wall:.1f} s from spawn to exit for the ranks' cases), one "
          f"process at batch "
          f"{batch_size} {single['seconds']:.3f}, phase 6's fp32 batch 1 "
          f"{float(np.mean(phase6['step_seconds'][1:])):.3f}; peak memory by rank "
          f"[{', '.join(f'{r['peak'] / 2**30:.2f}' for r in ranks)}] GiB, one process "
          f"{single['peak'] / 2**30:.2f} GiB {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        _fail(f"{label}: the ranks' step disagrees with one process's")


def phase_data_parallel(phase6: dict) -> tuple[int, int]:
    """Phase 6d: two gloo ranks on cuda:0 at batch 1 each against this
    process at batch 2, for the core and the evidential head; then a
    world-size-1 NCCL group's step.  Returns the ranks' gate launches."""
    from aa_rmvsnet_tpu_torch.models import EvidentialHead
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_train_sample, seeded_model

    rows = [_dtu_train_sample(), plane_train_sample(
        TRAIN_H, TRAIN_W, TRAIN_V, TRAIN_D, seed=SEED + 7, focal=361.54, baseline=20.0,
        plane_depth=620.0, depth_min=425.0, depth_interval=2.65)]
    keys = ("imgs", "proj_matrices", "depth_values", "depth", "mask")
    batch = {k: np.stack([r[k] for r in rows]) for k in keys}
    batch["mask"][1, : TRAIN_H // 2] = 0.0  # the ranks' valid counts differ
    weights = {"core": seeded_model(SEED).state_dict(),
               "head": EvidentialHead(TRAIN_MAXDISP,
                                      generator=torch.Generator().manual_seed(1)).state_dict()}
    launched = [0, 0]
    with tempfile.TemporaryDirectory() as workdir:
        np.savez(os.path.join(workdir, "batch.npz"), **batch)
        torch.save(weights, os.path.join(workdir, "weights.pt"))
        common = dict(weights=os.path.join(workdir, "weights.pt"),
                      batch=os.path.join(workdir, "batch.npz"), block=TRAIN_BLOCK,
                      maxdisp=TRAIN_MAXDISP, total_steps=DTU_TRAIN_TOTAL_STEPS)
        port = _free_port()
        t0 = time.perf_counter()
        ranks = _run_workers([dict(common, mode="rank", rank=r, port=port, view=1, spatial=1,
                                   rows=[r, r + 1], cases=[False, True]) for r in range(2)],
                             workdir)
        wall = time.perf_counter() - t0
        for evidential in (False, True):
            _hold_ranks_to_single(f"data-parallel {'evidential' if evidential else 'core'}",
                                  [r[evidential] for r in ranks], weights, batch, evidential,
                                  wall, phase6, launched,
                                  "two gloo ranks on cuda:0 at batch 1 (rank 1 with half its "
                                  "pixels masked) against one process at batch 2")

        (nccl,) = _run_workers([dict(common, mode="nccl", rank=0, port=_free_port(), view=1,
                                     spatial=1, rows=[0, 1], cases=[False])], workdir)
        mesh, plain = nccl["mesh"], nccl["plain"]
        loss_rel = abs(mesh["metrics"]["loss"] - plain["metrics"]["loss"]) \
            / abs(plain["metrics"]["loss"])
        grad_name, grad_err = _worst(plain["grads"], mesh["grads"])
        ok = nccl["backend"] == "nccl" and loss_rel <= 1e-5 and grad_err <= 2e-4 \
            and mesh["launches"] == (2 * 5 * TRAIN_D, 5 * TRAIN_D) \
            and mesh["all_reduces"] >= 1 and plain["all_reduces"] == 0
        print(f"data-parallel nccl: a world-size-1 {nccl['backend']} group's step on cuda:0 "
              f"({mesh['all_reduces']} all-reduces, none without the mesh: "
              f"{plain['all_reduces']}) "
              f"against the step without a mesh: loss rel {loss_rel:.2e} (bar 1e-5), "
              f"gradients worst {grad_err:.2e} ({grad_name}, bar 2e-4), seconds a step "
              f"[{', '.join(f'{x:.3f}' for x in mesh['seconds'])}] against "
              f"{plain['seconds'][0]:.3f} s; gate kernel launches {mesh['launches']} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            _fail("the world-size-1 NCCL step disagrees with the step without a mesh")
    return tuple(launched)


# One rank of phases 5f, 5g, 5i and 5l: run_inference with InferConfig()'s
# defaults under make_mesh(data=2), under make_mesh(depth=2) with
# pipeline_maps 2, and under make_mesh(spatial=2) on the first map (then
# that map in fp32 with packed rows and the seeded head, and on the exact
# fp32 path, 5b's two settings), both ranks on cuda:0 over gloo, on phase
# 5's scene built again from its seed; per path the stats, the gate
# launches, the peak memory and the seconds (and the head's maps of the
# rank's rows) go to a torch.save file, and with them 5l's head on the
# rank's rows of 5c's probability volume (its seconds, its peak memory and,
# on rank 0, the gathered maps) and the seconds of three handoffs of a
# seeded carry of the map's shape from stage 0 to stage 1.
# On the first spatial path (bf16) the row-split ops' collectives are
# counted and timed (a synchronise on each side, so that a collective's
# time is its own and not the card's queued work), which slows that map;
# the fp32 paths run without these probes.  On every spatial path the
# planes the gate kernel runs on are recorded.
INFER_WORKER = """
import json, sys, time
import numpy as np, torch
import chip_smoke
from aa_rmvsnet_tpu_torch.models import blocks
from aa_rmvsnet_tpu_torch.models.regularizer import init_states
from aa_rmvsnet_tpu_torch.ops import gates
from aa_rmvsnet_tpu_torch.parallel import (
    initialize_distributed, make_mesh, recv_carry, send_carry, spatial, spatial_rows)
from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference
from aa_rmvsnet_tpu_torch.utils.device import disable_tf32
from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_head, seeded_model

a = json.loads(sys.argv[1])
disable_tf32()
initialize_distributed(f"localhost:{a['port']}", 2, a["rank"], backend="gloo")
samples = chip_smoke._main_scene()
model, head = seeded_model(chip_smoke.SEED), seeded_head(chip_smoke.SEED)
comm, planes, slabs = {}, set(), []


def timed(kind, fn):
    def collective(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            comm[kind][0] += 1
            comm[kind][1] += time.perf_counter() - t0
    return collective


def recorded(z, c):
    planes.add(tuple(z.shape[-2:]))
    return lstm_gates(z, c)


lstm_gates = blocks.lstm_gates
fp32 = dict(feature_dtype=torch.float32)
exact = dict(fp32, packed_rows=False, fused_residual=False)
plain_collectives = spatial._all_gather, torch.distributed.all_reduce
hook = head.register_forward_hook(lambda module, args, ev: slabs.append(chip_smoke._nig(ev)))
out, meshes = {}, {}
for path, axes, maps, dataset, settings in (
        ("fanout", {"data": 2}, None, samples, {}),
        ("pipeline", {"depth": 2}, 2, samples, {}),
        ("spatial", {"spatial": 2}, None, samples[:1], {}),
        ("spatial_packed_fp32", {"spatial": 2}, None, samples[:1], dict(fp32, evidential=head)),
        ("spatial_fp32", {"spatial": 2}, None, samples[:1], exact)):
    mesh = meshes[path] = make_mesh(**axes, device="cuda")
    torch.cuda.set_device(mesh.device)
    probed = path == "spatial"
    spatial._all_gather, torch.distributed.all_reduce = (
        (timed("all_gather", plain_collectives[0]), timed("all_reduce", plain_collectives[1]))
        if probed else plain_collectives)
    blocks.lstm_gates = recorded if path.startswith("spatial") else lstm_gates
    comm.update(all_gather=[0, 0.0], all_reduce=[0, 0.0])
    planes.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gates.launches = gates.backward_launches = 0
    t0 = time.perf_counter()
    stats = run_inference(model, dataset, InferConfig(
        out_root=a["out_root"] + "_" + path, num_workers=2, mesh=mesh, pipeline_maps=maps,
        **settings))
    out[path] = {"stats": stats, "launches": (gates.launches, gates.backward_launches),
                 "peak": torch.cuda.max_memory_allocated(),
                 "seconds": time.perf_counter() - t0,
                 "comm": {k: list(v) for k, v in comm.items()} if probed else None,
                 "planes": sorted(planes), "nig": list(slabs)}
    slabs.clear()
    torch.cuda.empty_cache()
# 5l, part 1: the head on this rank's rows of 5c's probability volume; the
# four maps gathered to spatial rank 0.
hook.remove()
mesh = meshes["spatial"]
volume = np.load(a["head_prob"], mmap_mode="r")
row0, rows = spatial_rows(mesh, volume.shape[2])
prob = torch.from_numpy(np.ascontiguousarray(volume[:, :, row0:row0 + rows])).to(mesh.device)
del volume
dvals = torch.from_numpy(np.load(a["head_dvals"])).to(mesh.device)
with torch.inference_mode():
    head.to(mesh.device).eval()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ev = head(prob, dvals, mesh)
    nig = spatial.gather_rows_to_first(torch.stack([ev[k][0] for k in chip_smoke.NIG]), mesh)
    del ev
    torch.cuda.synchronize()
    out["spatial_head"] = {"seconds": time.perf_counter() - t0, "held": held, "rows": rows,
                           "peak": torch.cuda.max_memory_allocated(),
                           "nig": None if nig is None else nig.cpu().numpy()}
del prob, nig
torch.cuda.empty_cache()
mesh = meshes["pipeline"]
noise = torch.Generator(device=mesh.device).manual_seed(chip_smoke.SEED)
carry = tuple(tuple(torch.randn(t.shape, generator=noise, device=mesh.device).to(t.dtype)
                    for t in pair)
              for pair in init_states(1, chip_smoke.MAIN_H, chip_smoke.MAIN_W,
                                      dtype=torch.bfloat16, device=mesh.device))
handoff = []
for _ in range(3):
    torch.distributed.barrier(group=mesh.depth_group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if mesh.coord("depth") == 0:
        work, _ = send_carry(carry, 1, mesh.depth_group)
        work.wait()
    else:
        got = recv_carry(carry, 0, mesh.depth_group)
        torch.cuda.synchronize()
    handoff.append(time.perf_counter() - t0)
    if mesh.coord("depth") == 1 and not all(
            torch.equal(x, y) for pair, sent in zip(got, carry) for x, y in zip(pair, sent)):
        raise SystemExit("the carry arrived changed")
out["pipeline"]["handoff"] = handoff
torch.save(out, a["out"])
torch.distributed.destroy_process_group()
"""


def phase_inference_ranks(phase5: dict, head_input: dict) -> tuple[int, int, int, int, int]:
    """5f, 5g, 5i and 5l: two INFER_WORKER ranks, the fan-out, the depth
    pipeline and the spatial split (bf16, fp32 with packed rows and the
    seeded head, exact fp32), each path's maps checked as phase 5's and
    held to them (the spatial split's fp32 maps to 5b's); then the head
    split over the ranks on 5c's probability volume (``head_input``, which
    goes to the ranks as a ``.npy`` file).  Returns each path's gate
    launches over the ranks."""
    torch.cuda.empty_cache()  # this process's cached blocks, for the ranks
    launched = []
    with tempfile.TemporaryDirectory() as workdir:
        out_root = os.path.join(workdir, "maps")
        files = {"head_prob": os.path.join(workdir, "head_prob.npy"),
                 "head_dvals": os.path.join(workdir, "head_dvals.npy")}
        np.save(files["head_prob"], head_input["prob"])
        np.save(files["head_dvals"], head_input["dvals"])
        port = _free_port()
        t0 = time.perf_counter()
        ranks = _run_workers([dict(files, rank=r, port=port, out_root=out_root)
                              for r in range(2)], workdir, worker=INFER_WORKER)
        wall = time.perf_counter() - t0
        # The spatial paths sweep their one map on both ranks, a slab each.
        for path, maps, forward, report in (
                ("fanout", MAIN_MAPS, 5 * MAIN_D * MAIN_MAPS, _report_fanout),
                ("pipeline", MAIN_MAPS, 5 * MAIN_D * MAIN_MAPS, _report_pipeline),
                *((path, 1, 2 * 5 * MAIN_D, functools.partial(_report_spatial, path))
                  for path in ("spatial", "spatial_packed_fp32", "spatial_fp32"))):
            _check_maps(f"{out_root}_{path}", maps, MAIN_DEPTH_MIN,
                        MAIN_DEPTH_MIN + MAIN_DEPTH_INTERVAL * (MAIN_D - 1))
            got = [_read_maps(f"{out_root}_{path}", ref) for ref in range(maps)]
            per_path = [r[path] for r in ranks]
            launches = [sum(r["launches"][i] for r in per_path) for i in (0, 1)]
            if launches != [forward, 0]:
                _fail(f"{path}: the ranks launched the gate kernels {launches} times; "
                      f"expected {forward} forward and no backward")
            report(per_path, got, phase5, wall)
            launched.append(launches[0])
        _report_spatial_head([r["spatial_head"] for r in ranks],
                             [r["spatial_packed_fp32"] for r in ranks], out_root, phase5,
                             head_input)
    return tuple(launched)


def _nig_held(label: str, got: np.ndarray, want: np.ndarray, share: float) -> str:
    """The head's four maps ``(4, H, W)`` against ``want`` at the CPU bars
    (gamma 2e-3; nu, alpha, beta 1e-3) on at least ``share`` of the
    pixels, each map finite."""
    if got.shape != want.shape or not np.isfinite(got).all():
        _fail(f"{label}: maps of shape {got.shape} (expected {want.shape}) or not finite")
    errs, within = [], []
    for g, w, key in zip(got, want, NIG):
        diff = np.abs(g - w)
        errs.append(float(diff.max()))
        within.append(float(np.mean(diff <= EV_BARS[key])))
    if min(within) < share:
        _fail(f"{label}: within the bars on {within} of pixels, max_abs_err {errs}")
    return ", ".join(f"{k} max_abs_err {e:.3e} (bar {EV_BARS[k]:g}, within it on {w:.4%})"
                     for k, e, w in zip(NIG, errs, within))


def _report_spatial_head(heads: list, packed: list, out_root: str, phase5: dict,
                         head_input: dict) -> None:
    """5l: the evidential head split over two gloo ranks on cuda:0.  Part 1:
    each rank runs the seeded head on its 432 rows of 5c's probability
    volume (864x1152, D=512, fp32); the four maps gathered to rank 0 are
    held to 5c's at the CPU bars, and each rank's peak memory while the head
    runs (from the slab on the card) is printed beside 5c's one process.
    Part 2: 5i's fp32 packed-rows run carries the seeded head; each rank's
    maps of its rows, joined, are held to 5b's serial run of the same
    settings and head at those bars on >= 99.9 % of pixels (5f's rule for
    the depth), and the aleatoric and epistemic PFMs are finite."""
    from aa_rmvsnet_tpu_torch.core.pfm import read_pfm

    label = "spatial head"
    part1 = _nig_held(label, heads[0]["nig"], head_input["nig"], 1.0)
    slab = [h["rows"] for h in heads]
    joined = np.concatenate([p["nig"][0] for p in packed], axis=1)
    part2 = _nig_held(label, joined, phase5["packed_fp32_nig"], 0.999)
    for family in ("aleatoric_0", "epistemic_0"):
        m, _ = read_pfm(os.path.join(f"{out_root}_spatial_packed_fp32", "scan1", family,
                                     "00000000.pfm"))
        if m.shape != (MAIN_H, MAIN_W) or not np.isfinite(m).all():
            _fail(f"{label}: {family} of shape {m.shape} or not finite")
    seconds = [per_rank[0] for per_rank in packed[0]["stats"]["head_seconds"]]
    print(f"spatial head: EvidentialHead.forward(..., mesh), make_mesh(spatial=2), two gloo "
          f"ranks on cuda:0, seeded head (fp32), on 5c's probability volume ({MAIN_H}x{MAIN_W}, "
          f"D={MAIN_D}, maxdisp {head_input['maxdisp']}), rows {slab} a rank: the maps gathered "
          f"to rank 0 against 5c's head, {part1}; seconds by rank "
          f"[{', '.join(f'{h['seconds']:.3f}' for h in heads)}] (two processes sharing the "
          f"card; 5c alone {head_input['seconds']:.3f}); peak memory while the head runs by "
          f"rank [{', '.join(f'{h['peak'] / 2**30:.2f}' for h in heads)}] GiB, of which the "
          f"slab and the rest held at its start "
          f"[{', '.join(f'{h['held'] / 2**30:.2f}' for h in heads)}] (5c, one process: "
          f"{head_input['peak'] / 2**30:.2f} GiB); on 5i's fp32 packed run (the head on each "
          f"rank's rows of the collected volume) against 5b's serial run with the head: "
          f"{part2}; head seconds by rank [{', '.join(f'{x:.3f}' for x in seconds)}] (5b "
          f"alone {phase5['packed_fp32_head_seconds']:.3f}); aleatoric and epistemic PFMs "
          "finite ok", flush=True)


def _held_to_phase5(label: str, got: list, phase5: dict) -> str:
    """Each map against phase 5's: depth equal on >= 99.9 % of pixels,
    confidence atol 1e-4; whether bit for bit."""
    shares, errs, exact = [], [], True
    for (depth, conf), (want_depth, want_conf) in zip(got, phase5["maps"]):
        shares.append(float(np.mean(depth == want_depth)))
        errs.append(float(np.abs(conf - want_conf).max()))
        exact = exact and np.array_equal(depth, want_depth) and np.array_equal(conf, want_conf)
    ok = min(shares) >= 0.999 and max(errs) <= 1e-4
    if not ok:
        _fail(f"{label}: maps off phase 5's: depth equal on {shares}, confidence {errs}")
    return (f"against phase 5's maps: depth equal on [{', '.join(f'{x:.4%}' for x in shares)}] "
            f"of pixels (bar 99.9 %), confidence max_abs_err "
            f"[{', '.join(f'{x:.2e}' for x in errs)}] (bar 1e-4), bit for bit {exact}")


def _report_fanout(ranks: list, got: list, phase5: dict, wall: float) -> None:
    """5f: ``run_inference`` under ``make_mesh(data=2)``, two gloo ranks on
    cuda:0, one of phase 5's two maps each."""
    stats = ranks[0]["stats"]
    modes = [m for per_rank in stats["modes"] for m in per_rank]
    if stats["count"] != MAIN_MAPS or modes != [(True, 1, 4)] * MAIN_MAPS:
        _fail(f"fan-out wrote {stats['count']} maps in packed modes {modes}")
    held = _held_to_phase5("fan-out", got, phase5)
    print(f"fan-out: run_inference, InferConfig() defaults, make_mesh(data=2), two gloo ranks "
          f"on cuda:0 at {MAIN_H}x{MAIN_W}, V={MAIN_V}, D={MAIN_D}: {stats['count']} maps, "
          f"packed modes {modes}, seconds per map by rank "
          f"{[[round(x, 3) for x in r] for r in stats['map_seconds']]} (two processes "
          f"sharing the card; phase 5 alone "
          f"[{', '.join(f'{x:.3f}' for x in phase5['map_seconds'])}]), total_s "
          f"{stats['total_s']:.3f}, {ranks[0]['seconds']:.1f} s from the call to its return "
          f"({wall:.1f} s from spawn to exit with 5g and 5i); peak memory by rank "
          f"[{', '.join(f'{r['peak'] / 2**30:.2f}' for r in ranks)}] GiB (phase 5 "
          f"{phase5['peak'] / 2**30:.2f}); {held}; gate kernel launches "
          f"{sum(r['launches'][0] for r in ranks)} (= 5 x {MAIN_D} x {MAIN_MAPS}) ok",
          flush=True)


def _report_pipeline(ranks: list, got: list, phase5: dict, wall: float) -> None:
    """5g: ``run_inference`` under ``make_mesh(depth=2)``, ``pipeline_maps=2``:
    two gloo stages on cuda:0, each sweeping its 256 hypotheses of both of
    phase 5's maps, the carry handed over through pinned host memory."""
    stats = ranks[0]["stats"]
    if stats["count"] != MAIN_MAPS or stats["modes"] != [(True, 1, 4)] * MAIN_MAPS:
        _fail(f"the depth pipeline wrote {stats['count']} maps in packed modes "
              f"{stats['modes']}")
    held = _held_to_phase5("depth pipeline", got, phase5)
    carry = 2 * 33 * MAIN_H * MAIN_W * 2  # 5 cells' (h, c) in bf16, bytes
    print(f"depth-pipeline: run_inference, InferConfig() defaults, make_mesh(depth=2), "
          f"pipeline_maps {MAIN_MAPS}, two gloo stages on cuda:0 at {MAIN_H}x{MAIN_W}, "
          f"V={MAIN_V}, D={MAIN_D} ({MAIN_D // 2} a stage): {stats['count']} maps, packed "
          f"modes {stats['modes']}, seconds per group "
          f"[{', '.join(f'{x:.3f}' for x in stats['group_seconds'])}] (two processes "
          f"sharing the card; phase 5 alone "
          f"[{', '.join(f'{x:.3f}' for x in phase5['map_seconds'])}] a map), "
          f"{ranks[0]['seconds']:.1f} s from the call to its return; the carry's handoff "
          f"({carry / 1e6:.1f} MB in bf16) timed alone, seconds from a barrier: stage 0 "
          f"to its send complete [{', '.join(f'{x:.4f}' for x in ranks[0]['handoff'])}], "
          f"stage 1 to the carry on its card "
          f"[{', '.join(f'{x:.4f}' for x in ranks[1]['handoff'])}]; peak memory by stage "
          f"[{', '.join(f'{r['peak'] / 2**30:.2f}' for r in ranks)}] GiB (phase 5 "
          f"{phase5['peak'] / 2**30:.2f}); {held}; gate kernel launches "
          f"{sum(r['launches'][0] for r in ranks)} (= 5 x {MAIN_D} x {MAIN_MAPS}) ok",
          flush=True)


def _report_spatial(path: str, ranks: list, got: list, phase5: dict, wall: float) -> None:
    """5i: ``run_inference`` under ``make_mesh(spatial=2)`` on phase 5's
    first map: two gloo ranks on cuda:0, each sweeping its 432 rows with
    the halo exchanges, row gathers and GroupNorm all-reduces of
    ``parallel/spatial.py``; 5 x D forward launches a rank, the gate kernel
    on the slab's planes (432x1152 at full scale).  The fp32 maps, with
    packed rows and on the exact path, are held to 5b's serial maps of the
    same settings at 5f's bars.  With ``InferConfig()``'s defaults (bf16,
    packed rows) the map is a smoke check, held to 5b's exact map by
    :func:`_bf16_held_to_exact`, and its collectives are counted and timed
    (probes that slow it; 5h times the same map without them)."""
    stats = ranks[0]["stats"]
    modes = [m for per_rank in stats["modes"] for m in per_rank]
    label, settings, want_mode, want, alone = {
        "spatial": ("spatial", "InferConfig() defaults", (True, 1, 4), None,
                    f"phase 5 alone {phase5['map_seconds'][0]:.3f}"),
        "spatial_packed_fp32": ("spatial fp32 packed", "fp32 with packed rows", (True, 1, 4),
                                "packed_fp32", f"5b alone {phase5['packed_fp32_seconds']:.3f}"),
        "spatial_fp32": ("spatial fp32", "5b's exact settings", (False, 1, 4), "exact",
                         f"5b alone {phase5['exact_seconds']:.3f}"),
    }[path]
    if stats["count"] != 1 or modes != [want_mode] * 2:
        _fail(f"{label}: {stats['count']} maps written, packed modes {modes}")
    slab = (MAIN_H // 2, MAIN_W)
    for r in ranks:
        if r["launches"][0] != 5 * MAIN_D or max(r["planes"]) != slab:
            _fail(f"{label}: a rank launched the gate kernel {r['launches'][0]} times on "
                  f"planes {r['planes']}; expected {5 * MAIN_D} with {slab} the largest")
    if want is None:
        held = _bf16_held_to_exact(label, got[0], phase5)
    else:
        held = _held_to_phase5(label, got, {"maps": [phase5[want]]}).replace(
            "phase 5's maps", f"5b's serial map of these settings")
    comm = [r["comm"] for r in ranks]
    if comm[0] is None:
        probes = "no probes"
    else:
        probes = (f"collectives a rank (each timed between two synchronises): all-gathers "
                  f"(halos, row gathers) {[c['all_gather'][0] for c in comm]} in "
                  f"[{', '.join(f'{c['all_gather'][1]:.3f}' for c in comm)}] s, all-reduces "
                  f"(GroupNorm statistics) {[c['all_reduce'][0] for c in comm]} in "
                  f"[{', '.join(f'{c['all_reduce'][1]:.3f}' for c in comm)}] s")
    print(f"{label}: run_inference, {settings}, make_mesh(spatial=2), two gloo ranks on "
          f"cuda:0 at {MAIN_H}x{MAIN_W} ({slab[0]} rows a rank), V={MAIN_V}, D={MAIN_D}: map "
          f"0, packed modes {modes}, seconds by rank "
          f"{[round(x, 3) for r in stats['map_seconds'] for x in r]} (two processes sharing "
          f"the card; {alone}), {ranks[0]['seconds']:.1f} s from the call to its return; "
          f"{probes}; gate planes {ranks[0]['planes']}; peak memory by rank "
          f"[{', '.join(f'{r['peak'] / 2**30:.2f}' for r in ranks)}] GiB (phase 5 "
          f"{phase5['peak'] / 2**30:.2f}); {held}; gate kernel launches "
          f"{[r['launches'][0] for r in ranks]} (5 x {MAIN_D} a rank) ok", flush=True)


# The stand-in for cv2 of phase 5h: the scene's images are .npy arrays
# (BGR, as cv2 decodes) under their .jpg names.
CV2_STANDIN = '''
import numpy as np

IMREAD_COLOR, COLOR_BGR2RGB = 1, 4


def imread(path, flags=IMREAD_COLOR):
    try:
        return np.load(path)
    except FileNotFoundError:
        return None


def cvtColor(img, code):
    return img[..., ::-1]
'''


def _write_main_scene(root: str) -> None:
    """Phase 5's scene as a scene directory ``root/scan1`` (images, cams,
    ``pair.txt`` listing phase 5's reference views and their sources
    nearest first), its images written for :data:`CV2_STANDIN`."""
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_cameras, plane_views

    scan = os.path.join(root, "scan1")
    os.makedirs(os.path.join(scan, "images"))
    os.makedirs(os.path.join(scan, "cams"))
    n_cams = MAIN_MAPS + MAIN_V - 1
    cams = plane_cameras(MAIN_H, MAIN_W, n_cams, MAIN_PLANE["focal"], MAIN_PLANE["baseline"])
    for v, (img, (K, E)) in enumerate(zip(plane_views(MAIN_H, MAIN_W, n_cams, **MAIN_PLANE),
                                          cams)):
        with open(os.path.join(scan, "images", f"{v:08d}.jpg"), "wb") as f:
            np.save(f, img[..., ::-1])
        rows = lambda m: [" ".join(repr(float(x)) for x in row) for row in m]  # noqa: E731
        with open(os.path.join(scan, "cams", f"{v:08d}_cam.txt"), "w") as f:
            f.write("\n".join(["extrinsic", *rows(E), "", "intrinsic", *rows(K), "",
                               f"{MAIN_DEPTH_MIN!r} {MAIN_DEPTH_INTERVAL!r}", ""]))
    _write_pair(root, MAIN_MAPS)


def _write_pair(root: str, maps: int) -> None:
    """``root/scan1/pair.txt`` listing phase 5's first ``maps`` reference
    views and their sources, nearest first."""
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_sources

    n_cams = MAIN_MAPS + MAIN_V - 1
    with open(os.path.join(root, "scan1", "pair.txt"), "w") as f:
        f.write(f"{maps}\n")
        for ref in range(maps):
            sources = plane_sources(ref, n_cams)
            f.write(f"{ref}\n{len(sources)} "
                    + " ".join(f"{v} {len(sources) - i}" for i, v in enumerate(sources)) + "\n")


def phase_cli_ranks(phase5: dict) -> None:
    """5h: ``python -m aa_rmvsnet_tpu_torch.cli eval --fanout 2``, then
    ``--spatial 2``, with phase 5's flags on phase 5's scene written to
    disk; each command's two ranks share ``cuda:0`` over gloo.  Each
    command's first line, exit code and maps are checked: the fan-out's
    held to phase 5's at 5f's bars, the spatial split's map 0 (the scene's
    ``pair.txt`` then lists reference view 0 alone) to 5b's exact map by
    :func:`_bf16_held_to_exact`."""
    from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_model

    with tempfile.TemporaryDirectory() as workdir:
        _write_main_scene(workdir)
        listfile, ckpt = os.path.join(workdir, "list.txt"), os.path.join(workdir, "model.ckpt")
        with open(listfile, "w") as f:
            f.write("scan1\n")
        torch.save({"model": seeded_model(SEED).state_dict()}, ckpt)
        standin = os.path.join(workdir, "standin")
        os.makedirs(standin)
        with open(os.path.join(standin, "cv2.py"), "w") as f:
            f.write(CV2_STANDIN)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [standin, os.getcwd()] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        for flag, maps in (("--fanout", MAIN_MAPS), ("--spatial", 1)):
            name = f"cli eval {flag} 2"
            out_root = os.path.join(workdir, "maps" + flag)
            if maps == 1:
                _write_pair(workdir, 1)
            cmd = [sys.executable, "-m", "aa_rmvsnet_tpu_torch.cli", "eval", "--testpath",
                   workdir, "--testlist", listfile, "--preset", "dtu_eval", "--loadckpt", ckpt,
                   "--view_num", str(MAIN_V), "--numdepth", str(MAIN_D), "--max_h",
                   str(MAIN_H), "--max_w", str(MAIN_W), "--interval_scale", "1",
                   "--depth_block", str(MAIN_BLOCK), "--outdir", out_root, flag, "2"]
            torch.cuda.empty_cache()  # this process's cached blocks, for the ranks
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, cwd=os.getcwd(), env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True, start_new_session=True)
            try:
                out, err = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                _fail(f"{name} did not finish in 300 s")
            finally:
                try:
                    os.killpg(proc.pid, 9)  # the ranks too
                except ProcessLookupError:
                    pass
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                _fail(f"{name} exited with {proc.returncode}: {err[-2000:]}")
            lines = out.splitlines()
            first = f"eval: 2 ranks ({flag} 2) on torch.distributed, backend gloo, ranks on " \
                "cuda:0, cuda:0"
            if lines[0] != first:
                _fail(f"{name} began {lines[0]!r}, not {first!r}")
            _check_maps(out_root, maps, MAIN_DEPTH_MIN,
                        MAIN_DEPTH_MIN + MAIN_DEPTH_INTERVAL * (MAIN_D - 1))
            got = [_read_maps(out_root, ref) for ref in range(maps)]
            held = (_held_to_phase5(name, got, phase5) if maps > 1
                    else _bf16_held_to_exact(name, got[0], phase5))
            printed = [line for line in lines if "scan1/" in line]
            print(f"{name}: exit 0 in {wall:.1f} s (spawn, two ranks sharing cuda:0, "
                  f"{maps} map(s) at {MAIN_H}x{MAIN_W}, V={MAIN_V}, D={MAIN_D}); first line "
                  f"{lines[0]!r}; its map lines {printed}; {held}", flush=True)


def phase_view_parallel(phase6: dict) -> tuple[int, int]:
    """6e: ``TrainConfig(mesh=make_mesh(view=2))`` at ``dtu_train``: two gloo
    ranks on cuda:0, each sweeping 2 of the 4 source views, against this
    process's step on the same sample, for the core and the evidential
    head, at phase 6d's bars.  Returns the ranks' gate launches."""
    from aa_rmvsnet_tpu_torch.models import EvidentialHead
    from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_model

    keys = ("imgs", "proj_matrices", "depth_values", "depth", "mask")
    sample = _dtu_train_sample()
    batch = {k: np.stack([sample[k]]) for k in keys}
    weights = {"core": seeded_model(SEED).state_dict(),
               "head": EvidentialHead(TRAIN_MAXDISP,
                                      generator=torch.Generator().manual_seed(1)).state_dict()}
    launched = [0, 0]
    with tempfile.TemporaryDirectory() as workdir:
        np.savez(os.path.join(workdir, "batch.npz"), **batch)
        torch.save(weights, os.path.join(workdir, "weights.pt"))
        common = dict(weights=os.path.join(workdir, "weights.pt"),
                      batch=os.path.join(workdir, "batch.npz"), block=TRAIN_BLOCK,
                      maxdisp=TRAIN_MAXDISP, total_steps=DTU_TRAIN_TOTAL_STEPS)
        port = _free_port()
        t0 = time.perf_counter()
        ranks = _run_workers([dict(common, mode="rank", rank=r, port=port, view=2, spatial=1,
                                   rows=[0, 1], cases=[False, True]) for r in range(2)], workdir)
        wall = time.perf_counter() - t0
        for evidential in (False, True):
            _hold_ranks_to_single(f"view-parallel {'evidential' if evidential else 'core'}",
                                  [r[evidential] for r in ranks], weights, batch, evidential,
                                  wall, phase6, launched,
                                  "two gloo ranks on cuda:0 with a view axis of 2 (source "
                                  "views 1-2 and 3-4) against one process on the sample")
    return tuple(launched)


def phase_spatial_training(phase6: dict) -> tuple[int, int]:
    """6f: ``TrainConfig(mesh=make_mesh(spatial=2))`` at ``dtu_train``: two
    gloo ranks on cuda:0, each stepping on its 64 rows of the sample (the
    halo exchanges, row gathers and GroupNorm all-reduces differentiated,
    the gradients summed over the spatial group), against this process's
    step on the whole sample, for the core, at phase 6d's bars.  Returns
    the ranks' gate launches."""
    from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_model

    keys = ("imgs", "proj_matrices", "depth_values", "depth", "mask")
    sample = _dtu_train_sample()
    batch = {k: np.stack([sample[k]]) for k in keys}
    weights = {"core": seeded_model(SEED).state_dict()}
    launched = [0, 0]
    with tempfile.TemporaryDirectory() as workdir:
        np.savez(os.path.join(workdir, "batch.npz"), **batch)
        torch.save(weights, os.path.join(workdir, "weights.pt"))
        common = dict(weights=os.path.join(workdir, "weights.pt"),
                      batch=os.path.join(workdir, "batch.npz"), block=TRAIN_BLOCK,
                      maxdisp=TRAIN_MAXDISP, total_steps=DTU_TRAIN_TOTAL_STEPS)
        port = _free_port()
        t0 = time.perf_counter()
        ranks = _run_workers([dict(common, mode="rank", rank=r, port=port, view=1, spatial=2,
                                   rows=[0, 1], cases=[False]) for r in range(2)], workdir)
        wall = time.perf_counter() - t0
        _hold_ranks_to_single("spatial core", [r[False] for r in ranks], weights, batch, False,
                              wall, phase6, launched,
                              f"two gloo ranks on cuda:0 with a spatial axis of 2 (rows 0-"
                              f"{TRAIN_H // 2 - 1} and {TRAIN_H // 2}-{TRAIN_H - 1}) against "
                              "one process on the sample")
    return tuple(launched)


def phase_spatial_evidential_training(phase6: dict) -> tuple[int, int]:
    """6g: ``TrainConfig(evidential=True, mesh=make_mesh(spatial=2))`` at
    ``dtu_train`` with maxdisp 32: two gloo ranks on cuda:0, each sweeping
    its 64 rows of the sample and running the head on its rows of the cost
    volume against its rows of the labels (the BatchNorm statistics summed
    over the ranks), against this process's evidential step on the sample,
    at phase 6d's bars; the ranks equal bit for bit after the step, each
    rank's peak memory printed beside the 4.30 GiB a rank of PR 15's
    design (the head on the gathered volume).  Returns the ranks' gate
    launches."""
    from aa_rmvsnet_tpu_torch.models import EvidentialHead
    from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_model

    keys = ("imgs", "proj_matrices", "depth_values", "depth", "mask")
    sample = _dtu_train_sample()
    batch = {k: np.stack([sample[k]]) for k in keys}
    weights = {"core": seeded_model(SEED).state_dict(),
               "head": EvidentialHead(TRAIN_MAXDISP,
                                      generator=torch.Generator().manual_seed(1)).state_dict()}
    launched = [0, 0]
    with tempfile.TemporaryDirectory() as workdir:
        np.savez(os.path.join(workdir, "batch.npz"), **batch)
        torch.save(weights, os.path.join(workdir, "weights.pt"))
        common = dict(weights=os.path.join(workdir, "weights.pt"),
                      batch=os.path.join(workdir, "batch.npz"), block=TRAIN_BLOCK,
                      maxdisp=TRAIN_MAXDISP, total_steps=DTU_TRAIN_TOTAL_STEPS)
        port = _free_port()
        t0 = time.perf_counter()
        ranks = _run_workers([dict(common, mode="rank", rank=r, port=port, view=1, spatial=2,
                                   rows=[0, 1], cases=[True], timed=0) for r in range(2)],
                             workdir)
        wall = time.perf_counter() - t0
        _hold_ranks_to_single("spatial evidential", [r[True] for r in ranks], weights, batch,
                              True, wall, phase6, launched,
                              f"two gloo ranks on cuda:0 with a spatial axis of 2 (rows 0-"
                              f"{TRAIN_H // 2 - 1} and {TRAIN_H // 2}-{TRAIN_H - 1}, the head "
                              "on each rank's rows; PR 15's head on the gathered volume: 4.30 "
                              "GiB a rank) against one process on the sample")
    return tuple(launched)


def _view_spatial_scene() -> dict:
    """Phase 5's map 0 with D cut to 64 (the plane in mid-sweep)."""
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_scene

    return plane_scene(MAIN_H, MAIN_W, MAIN_V, VS_D, maps=MAIN_MAPS, **MAIN_PLANE,
                       depth_min=VS_DEPTH_MIN, depth_interval=MAIN_DEPTH_INTERVAL)[0]


# One rank of phase 5k: under make_mesh(view=2, spatial=2), four gloo ranks
# on cuda:0, the exact fp32 forward of _view_spatial_scene's map on the
# rank's rows (the view rank's 2 source views), then run_inference on it
# with 5b's exact settings (the view ranks as replicas); per path the
# outputs, the gate launches, the seconds and the peak memory go to a
# torch.save file.
VIEW_SPATIAL_WORKER = """
import json, sys, time, warnings
import torch
import chip_smoke
from aa_rmvsnet_tpu_torch.models import SweepConfig, forward
from aa_rmvsnet_tpu_torch.ops import gates
from aa_rmvsnet_tpu_torch.parallel import initialize_distributed, make_mesh, spatial_rows
from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference
from aa_rmvsnet_tpu_torch.utils.device import disable_tf32
from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_model

a = json.loads(sys.argv[1])
disable_tf32()
initialize_distributed(f"localhost:{a['port']}", 4, a["rank"], backend="gloo")
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    mesh = make_mesh(view=2, spatial=2, device="cuda")
torch.cuda.set_device(mesh.device)
sample = chip_smoke._view_spatial_scene()
model = seeded_model(chip_smoke.SEED).cuda()
row0, rows = spatial_rows(mesh, chip_smoke.MAIN_H)
out = {"coords": (mesh.coord("view"), mesh.coord("spatial")),
       "warned": any("view > 1 combined with spatial > 1" in str(w.message) for w in caught)}


def measured(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gates.launches = gates.backward_launches = 0
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return {"result": result, "seconds": time.perf_counter() - t0,
            "launches": (gates.launches, gates.backward_launches),
            "peak": torch.cuda.max_memory_allocated()}


def sweep():
    inputs = [torch.from_numpy(sample["imgs"][None, :, row0:row0 + rows]).cuda(),
              torch.from_numpy(sample["proj_matrices"][None]).cuda(),
              torch.from_numpy(sample["depth_values"][None]).cuda()]
    with torch.inference_mode():
        res = forward(model, *inputs, SweepConfig(depth_block=chip_smoke.MAIN_BLOCK,
                                                  collect_volume=False, mesh=mesh))
    return res["depth"][0].cpu(), res["photometric_confidence"][0].cpu()


out["forward"] = measured(sweep)
torch.cuda.empty_cache()
out["infer"] = measured(lambda: run_inference(model, [sample], InferConfig(
    out_root=a["out_root"], feature_dtype=torch.float32, packed_rows=False,
    fused_residual=False, num_workers=0, mesh=mesh), progress=False))
torch.save(out, a["out"])
torch.distributed.destroy_process_group()
"""


def phase_view_spatial() -> int:
    """5k: ``make_mesh(view=2, spatial=2)``, four gloo ranks sharing cuda:0,
    on phase 5's map 0 with D cut to 64, exact fp32: ``forward`` on the
    mesh (each rank sweeps its view rank's 2 source views on its 432 rows,
    the source features gathered over the spatial group and the partial
    view mean merged over the view group once per depth block), then
    ``run_inference`` on it with 5b's exact settings (the view ranks as
    replicas, spatial rank 0 of view rank 0 writing).  Both held to this
    process's serial exact map at 5i's fp32 bars (5f's: depth equal on >=
    99.9 % of pixels, confidence atol 1e-4), each view rank's map for
    ``forward``; 5 x D forward gate launches a rank a run.  Returns the
    ranks' gate launches."""
    from aa_rmvsnet_tpu_torch.models import SweepConfig, forward
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.utils.synthetic import seeded_model

    sample = _view_spatial_scene()
    model = seeded_model(SEED).cuda()
    inputs = [torch.from_numpy(sample[k])[None].cuda()
              for k in ("imgs", "proj_matrices", "depth_values")]
    gates.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        serial = forward(model, *inputs, SweepConfig(depth_block=MAIN_BLOCK,
                                                     collect_volume=False))
    torch.cuda.synchronize()
    serial_seconds = time.perf_counter() - t0
    if gates.launches != 5 * VS_D:
        _fail(f"view-spatial: the serial map launched the gate kernel {gates.launches} times")
    want = {"maps": [(serial["depth"][0].cpu().numpy(),
                      serial["photometric_confidence"][0].cpu().numpy())]}
    del model, inputs, serial
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        out_root = os.path.join(workdir, "maps")
        port = _free_port()
        t0 = time.perf_counter()
        ranks = _run_workers([dict(rank=r, port=port, out_root=out_root) for r in range(4)],
                             workdir, worker=VIEW_SPATIAL_WORKER)
        wall = time.perf_counter() - t0
        if [r["coords"] for r in ranks] != [(0, 0), (0, 1), (1, 0), (1, 1)] \
                or not all(r["warned"] for r in ranks):
            _fail("view-spatial: the ranks' coordinates or make_mesh's warning")
        # Each view rank's map (its two slabs), held to the serial one: the
        # view ranks regularize the same merged costs, but the card's
        # convolutions need not be bit for bit from one process to another.
        serial_text = ("phase 5's maps", f"the serial exact D={VS_D} map")
        views, held_forward = [], []
        for v in range(2):
            views.append(tuple(torch.cat([ranks[2 * v + s]["forward"]["result"][i]
                                          for s in range(2)]).numpy() for i in range(2)))
            held_forward.append(_held_to_phase5(f"view-spatial forward, view rank {v}",
                                                [views[v]], want).replace(*serial_text))
        replicas = (float(np.mean(views[0][0] == views[1][0])),
                    float(np.abs(views[0][1] - views[1][1]).max()))
        _check_maps(out_root, 1, VS_DEPTH_MIN, VS_DEPTH_MIN + MAIN_DEPTH_INTERVAL * (VS_D - 1))
        held_infer = _held_to_phase5("view-spatial run_inference", [_read_maps(out_root, 0)],
                                     want).replace(*serial_text)
    stats = ranks[0]["infer"]["result"]
    modes = [m for per_rank in stats["modes"] for m in per_rank]
    if stats["count"] != 1 or modes != [(False, 1, 4)] * 4:
        _fail(f"view-spatial: run_inference wrote {stats['count']} maps in modes {modes}")
    launches = 0
    for r in ranks:
        for path in ("forward", "infer"):
            if r[path]["launches"] != (5 * VS_D, 0):
                _fail(f"view-spatial: a rank's {path} launched the gate kernels "
                      f"{r[path]['launches']} times; expected ({5 * VS_D}, 0)")
            launches += r[path]["launches"][0]
    print(f"view-spatial: make_mesh(view=2, spatial=2), four gloo ranks on cuda:0 at "
          f"{MAIN_H}x{MAIN_W} ({MAIN_H // 2} rows and 2 of the {MAIN_V - 1} source views a "
          f"rank), D={VS_D}, exact fp32: forward, view rank 0 {held_forward[0]}, view rank 1 "
          f"{held_forward[1]}; the view ranks' depth equal on {replicas[0]:.4%}, confidence "
          f"{replicas[1]:.2e} apart; seconds by rank "
          f"[{', '.join(f'{r['forward']['seconds']:.3f}' for r in ranks)}] (four processes "
          f"sharing the card; serial {serial_seconds:.3f}); run_inference (view ranks as "
          f"replicas) {held_infer}, seconds by rank "
          f"[{', '.join(f'{r['infer']['seconds']:.3f}' for r in ranks)}]; peak memory by "
          f"rank [{', '.join(f'{r['forward']['peak'] / 2**30:.2f}' for r in ranks)}] GiB; "
          f"gate kernel launches {launches} (5 x {VS_D} a rank a run); {wall:.1f} s from "
          "spawn to exit ok", flush=True)
    return launches


def phase_feat_chunk(samples, phase5: dict) -> None:
    """5e: FeatNet with all views in one batch (chunk 0, the default)
    against one view at a time (chunk 1), and the automatic depth block's
    estimate against the measured peaks."""
    from aa_rmvsnet_tpu_torch.models.network import cast_model, extract_features
    from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference
    from aa_rmvsnet_tpu_torch.utils.config import (
        derive_depth_block, featnet_memory_bytes, memory_budget, sweep_memory_bytes,
    )
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_scene, seeded_model

    model = seeded_model(SEED).cuda()
    imgs = torch.from_numpy(samples[0]["imgs"][None]).cuda()
    feats, secs, peaks = {}, {}, {}
    with torch.inference_mode():
        bf16 = cast_model(model, torch.bfloat16)
        fp32 = extract_features(model, imgs, torch.float32)
        for chunk in (0, 1, 0, 1):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            feats[chunk] = extract_features(bf16, imgs, torch.bfloat16, chunk)
            torch.cuda.synchronize()
            secs.setdefault(chunk, []).append(time.perf_counter() - t0)
            peaks[chunk] = torch.cuda.max_memory_allocated() - held
    chunk_err = (feats[0].float() - feats[1].float()).abs().max().item()
    equal = (feats[0] == feats[1]).float().mean().item()
    bf16_err = (feats[1].float() - fp32).abs().max().item()
    estimates = {k: featnet_memory_bytes(MAIN_H, MAIN_W, MAIN_V, True, k) for k in (0, 1)}
    ok = chunk_err <= 2 * bf16_err and all(
        abs(estimates[k] / peaks[k] - 1) <= ESTIMATE_BAR for k in (0, 1))
    print(f"feat-chunk: FeatNet bf16 at {MAIN_H}x{MAIN_W}, V={MAIN_V}: chunk 0 (one batch) "
          f"{', '.join(f'{t:.4f}' for t in secs[0])} s, peak {peaks[0] / 2**30:.2f} GiB "
          f"(estimate {estimates[0] / 2**30:.2f}); chunk 1 "
          f"{', '.join(f'{t:.4f}' for t in secs[1])} s, peak {peaks[1] / 2**30:.2f} GiB "
          f"(estimate {estimates[1] / 2**30:.2f}); equal on {equal:.4%} of features, "
          f"max_abs_err {chunk_err:.3e} (bar: twice bf16's own max_abs_err from fp32, "
          f"{bf16_err:.3e}; estimates within {ESTIMATE_BAR:.0%}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        _fail("FeatNet chunks disagree beyond bf16's rounding, or their memory estimate "
              "is off")
    del feats, fp32, bf16

    budget = memory_budget("cuda")
    rows = []
    pick = derive_depth_block(MAIN_H, MAIN_W, MAIN_V, MAIN_D, budget=budget)
    if pick != MAIN_BLOCK:
        _fail(f"the automatic depth block at dtu_eval is {pick}; phase 5 ran {MAIN_BLOCK}")
    rows.append(("dtu_eval", MAIN_H, MAIN_W, MAIN_V, MAIN_D, pick,
                 sweep_memory_bytes(MAIN_H, MAIN_W, MAIN_V, pick, MAIN_D), phase5["peak"],
                 phase5["modes"][0]))
    pick = derive_depth_block(TNT_H, TNT_W, TNT_V, 512, budget=budget)
    tnt = plane_scene(TNT_H, TNT_W, TNT_V, TNT_D, maps=1, seed=SEED + 13, focal=2000.0,
                      baseline=2.0, plane_depth=600.0, depth_min=MAIN_DEPTH_MIN,
                      depth_interval=MAIN_DEPTH_INTERVAL)
    with tempfile.TemporaryDirectory() as out_root:
        torch.cuda.reset_peak_memory_stats()
        stats = run_inference(seeded_model(SEED), tnt, InferConfig(
            out_root=out_root, depth_block=pick, num_workers=2, device="cuda"))
        peak = torch.cuda.max_memory_allocated()
    if stats["modes"] != [(True, 1, 4)]:
        _fail(f"the tnt_intermediate_1920 map took packed mode {stats['modes']}")
    rows.append(("tnt_intermediate_1920", TNT_H, TNT_W, TNT_V, TNT_D, pick,
                 sweep_memory_bytes(TNT_H, TNT_W, TNT_V, pick, TNT_D), peak,
                 stats["modes"][0]))
    for name, H, W, V, D, block, estimate, measured, mode in rows:
        ratio = estimate / measured
        ok = abs(ratio - 1.0) <= ESTIMATE_BAR and measured <= budget
        print(f"auto-block: {name} ({H}x{W}, V={V}, D={D}), budget {budget / 2**30:.2f} GiB: "
              f"derive_depth_block picks {block}; estimate {estimate / 2**30:.2f} GiB, "
              f"max_memory_allocated {measured / 2**30:.2f} GiB in mode {mode}, ratio "
              f"{ratio:.3f} (bar 1 +- {ESTIMATE_BAR}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            _fail(f"the depth-block estimate at {name} is off the measured peak")
    print(f"auto-block: the tnt_intermediate_1920 map ran in {stats['map_seconds'][0]:.3f} s "
          f"(D={TNT_D}, cut from 512)", flush=True)


def _fusion_equal(fusion, args, num_levels: int, what: str) -> tuple:
    """The kernel's outputs on ``args``, failing unless they equal the plain
    version's on the card and on the CPU bit for bit."""
    kernel = fusion.fuse_ref(*args, num_levels)
    torch.cuda.synchronize()
    plain = fusion.fuse_ref_reference(*args, num_levels)
    cpu = fusion.fuse_ref_reference(*(a.cpu() if torch.is_tensor(a) else a for a in args),
                                    num_levels)
    names = ("level counts", "loose count", "reprojected sum")
    for name, k, p, c in zip(names, kernel, plain, cpu):
        if not (torch.equal(k, p) and torch.equal(k.cpu(), c)):
            diff = (k.cpu() != c).float().mean().item()
            _fail(f"fusion kernel {name} differs from its plain version on {what}, "
                  f"{num_levels} levels ({diff:.4%} of the CPU's differ)")
    return kernel


def _near_thresholds(fusion, args, num_levels: int, tolerances) -> list[int]:
    """Pixel-sources whose distance or relative difference lies within each
    tolerance of one of its level's thresholds (the plain version's terms)."""
    depths, ref, index, mats = args
    thresholds = torch.tensor(fusion.level_thresholds(num_levels, 4.0, 1300.0),
                              dtype=torch.float64, device=depths.device)
    near = [0] * len(tolerances)
    for s, m in zip(index.tolist(), mats.cpu().tolist()):
        dist, rel, *_ = fusion.pair_terms(depths[ref], depths[s], m)
        gap = torch.minimum((dist[..., None] - thresholds[:, 0]).abs().amin(-1),
                            (rel[..., None] - thresholds[:, 1]).abs().amin(-1))
        for i, tol in enumerate(tolerances):
            near[i] += int((gap < tol).sum())
    return near


def phase_fusion_kernel() -> dict:
    """7: the fusion kernel against its plain version on the card and on
    the CPU, bit for bit, on a plane and on inputs with every special depth,
    and its times."""
    from aa_rmvsnet_tpu_torch.ops import fusion
    from aa_rmvsnet_tpu_torch.utils.device import device_ms
    from aa_rmvsnet_tpu_torch.utils.synthetic import (
        division_operands, fusion_edge_case, fusion_plane_views,
    )

    args = fusion_plane_views(MAIN_H, MAIN_W, FUSE_SRCS, FUSE_FOCAL, FUSE_BASELINE, FUSE_PLANE,
                              FUSE_NOISE, SEED + 17)
    kernel = _fusion_equal(fusion, args, FUSE_LEVELS, "the plane")
    shares = [f"{c.float().mean().item() / FUSE_SRCS:.3f}" for c in kernel[0]]
    near = _near_thresholds(fusion, args, FUSE_LEVELS, NEAR_TOLERANCES)
    a, c = division_operands(DIVISION_PAIRS, SEED + 31)
    quotients = fusion.kernel_quotients(torch.from_numpy(a).cuda(), torch.from_numpy(c).cuda())
    with np.errstate(all="ignore"):
        ieee = a / c
    if not np.array_equal(quotients.cpu().numpy(), ieee, equal_nan=True):
        _fail(f"the fusion kernel's division differs from IEEE division on "
              f"{int((quotients.cpu().numpy() != ieee).sum())} of {DIVISION_PAIRS} pairs")
    edges = []
    for num_src in (1, fusion.MAX_SOURCES):
        depths, ref, srcs, mats = fusion_edge_case(EDGE_H, EDGE_W, num_src, seed=SEED + 29)
        edge_args = (torch.from_numpy(depths).cuda(), ref,
                     torch.tensor(srcs, dtype=torch.int32, device="cuda"),
                     torch.from_numpy(mats).cuda())
        for num_levels in EDGE_LEVELS:
            counts = _fusion_equal(fusion, edge_args, num_levels, f"{num_src} edge sources")[0]
            edges.append(f"{num_src} x {num_levels}: {(counts[-1] > 0).float().mean().item():.3f}")

    flush = torch.empty(2**28, device="cuda")
    ms = device_ms(lambda: fusion.fuse_ref(*args), flush, reps=20)
    plain_ms = device_ms(lambda: fusion.fuse_ref_reference(*args), flush, reps=3, warmup=1)
    ms_again = device_ms(lambda: fusion.fuse_ref(*args), flush, reps=20)
    del flush
    px = MAIN_H * MAIN_W
    nbytes = px * 4 * (1 + FUSE_SRCS + FUSE_LEVELS + 2)
    bytes_ms = nbytes / memory_bytes_per_s() * 1e3
    ops = fusion.fp64_operations(px, args[3].cpu().numpy())
    ops_ms = ops / FP64_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"fusion: kernel vs plain at {MAIN_H}x{MAIN_W}, 1 reference view, {FUSE_SRCS} "
          f"sources, depths {FUSE_PLANE} + N(0, {FUSE_NOISE}^2): level counts, loose count "
          f"and reprojected sums equal bit for bit to the plain version on the card and on "
          f"the CPU; share of sources passing per level [{', '.join(shares)}]; pixel-sources "
          f"within {', '.join(f'{t:g}' for t in NEAR_TOLERANCES)} of a threshold: "
          f"{', '.join(str(n) for n in near)} of {px * FUSE_SRCS}; kernel "
          f"{ms:.4f} ms (again {ms_again:.4f}) per reference view, plain {plain_ms:.4f} ms; "
          f"bound {bound_ms:.4f} ms by {'bytes' if bytes_ms >= ops_ms else 'operations'} "
          f"({bytes_ms:.4f} ms for {nbytes / 1e6:.1f} MB, {ops_ms:.4f} ms for "
          f"{ops / 1e9:.3f} G float64 "
          f"operations at {FP64_PER_S / 1e12:.0f} TFLOP/s), {bound_ms / ms:.0%} of it",
          flush=True)
    print(f"fusion-division: the kernel's quotients (a divisor's reciprocal shared) equal "
          f"IEEE division bit for bit on {DIVISION_PAIRS} pairs: random bit patterns, "
          f"magnitudes 1e-6 to 1e6, and the edges of the fast range", flush=True)
    print(f"fusion-edges: bit for bit on the card and the CPU at {EDGE_H}x{EDGE_W} with 2 % "
          f"each of 0, negative, NaN, +inf and -inf depths, sources projecting outside and "
          f"reference intrinsics changing between sources, "
          f"sources x levels: share of pixels whose loosest level passes "
          f"[{'; '.join(edges)}]", flush=True)
    return {
        "name": "fuse_ref",
        "route": "cuda",
        "source": "aa_rmvsnet_tpu_torch/csrc/fusion_core.cu",
        "replaces": "native/fusion_core.cpp:82",
        "launches": None,
        "max_abs_err": 0.0,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def phase_fusion_scan() -> int:
    """7b: a DTU-sized scan fused in memory on the card."""
    from aa_rmvsnet_tpu_torch.ops import fusion
    from aa_rmvsnet_tpu_torch.pipeline.fuse import FuseConfig, fuse_views
    from aa_rmvsnet_tpu_torch.utils.synthetic import fusion_scan

    depths, confs, images, cams, pairs = fusion_scan(
        FUSE_VIEWS, FUSE_SRCS, MAIN_H, MAIN_W, FUSE_IMG_H, FUSE_IMG_W, FUSE_FOCAL,
        FUSE_BASELINE, FUSE_PLANE, FUSE_NOISE, SEED + 19)
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fusion.launches = 0
        t0 = time.perf_counter()
        xyz, rgb = fuse_views(depths, confs, images, cams, pairs, FuseConfig(device="cuda"))
        secs.append(time.perf_counter() - t0)
        launches = fusion.launches
        peak = torch.cuda.max_memory_allocated()
    z_err = float(np.median(np.abs(xyz[:, 2] - FUSE_PLANE)))
    if launches != FUSE_VIEWS or len(xyz) == 0 or not np.isfinite(xyz).all() \
            or z_err > FUSE_NOISE:
        _fail(f"the fused scan: {launches} kernel launches, {len(xyz)} points, median "
              f"|z - plane| {z_err}")
    print(f"fusion-scan: fuse_views, {FUSE_VIEWS} views x {FUSE_SRCS} sources at "
          f"{MAIN_H}x{MAIN_W}, images {FUSE_IMG_H}x{FUSE_IMG_W}: "
          f"{', '.join(f'{s:.3f}' for s in secs)} s per scan, {len(xyz)} points, median "
          f"|z - plane| {z_err:.4f}, peak memory {peak / 2**30:.2f} GiB (the inputs "
          f"{sum(d.numel() * 8 + images[v].numel() for v, d in depths.items()) / 2**30:.2f} "
          f"GiB), fusion kernel launches "
          f"{launches} (one per reference view)", flush=True)
    return launches


def phase_chain() -> tuple[int, int]:
    """7c: depth maps, fusion and quality on the card, end to end."""
    from aa_rmvsnet_tpu_torch.core.pfm import read_pfm
    from aa_rmvsnet_tpu_torch.ops import fusion, gates
    from aa_rmvsnet_tpu_torch.pipeline.fuse import FuseConfig, fuse_views
    from aa_rmvsnet_tpu_torch.pipeline.infer import InferConfig, run_inference
    from aa_rmvsnet_tpu_torch.utils.quality import accuracy_completeness
    from aa_rmvsnet_tpu_torch.utils.synthetic import (
        matching_model, nearest_pairs, plane_cameras, plane_scene,
    )

    plane = 600.0
    samples = plane_scene(MAIN_H, MAIN_W, MAIN_V, CHAIN_D, maps=CHAIN_MAPS, seed=SEED + 23,
                          focal=FUSE_FOCAL, baseline=FUSE_BASELINE, plane_depth=plane,
                          depth_min=CHAIN_DEPTH_MIN, depth_interval=CHAIN_INTERVAL)
    cams = plane_cameras(MAIN_H, MAIN_W, CHAIN_MAPS, FUSE_FOCAL, FUSE_BASELINE)
    with tempfile.TemporaryDirectory() as out_root:
        gates.launches = gates.backward_launches = fusion.launches = 0
        stats = run_inference(matching_model(SEED, sharpness=1000.0), samples,
                              InferConfig(out_root=out_root, num_workers=2, device="cuda"))
        launches, backward = gates.launches, gates.backward_launches
        maps = {
            family: {r: read_pfm(os.path.join(out_root, "scan1", family, f"{r:08d}.pfm"))[0]
                     for r in range(CHAIN_MAPS)}
            for family in ("depth_est_0", "confidence_0")
        }
    if launches != 5 * CHAIN_D * CHAIN_MAPS or backward != 0:
        _fail(f"the chain's maps launched the gate kernel {launches} times, backward "
              f"{backward}; expected {5 * CHAIN_D * CHAIN_MAPS} and 0")
    images = {r: np.full((MAIN_H, MAIN_W, 3), 128, np.uint8) for r in range(CHAIN_MAPS)}
    pairs = nearest_pairs(range(CHAIN_MAPS), CHAIN_MAPS - 1)
    t0 = time.perf_counter()
    xyz, _ = fuse_views(maps["depth_est_0"], maps["confidence_0"], images, dict(enumerate(cams)),
                        pairs, FuseConfig(device="cuda"))
    fuse_s = time.perf_counter() - t0
    fused_launches = fusion.launches
    z_err = float(np.median(np.abs(xyz[:, 2] - plane))) if len(xyz) else float("inf")
    # The ground truth: every other pixel of the reference views on the plane.
    ys, xs = np.mgrid[0:MAIN_H:2, 0:MAIN_W:2].astype(np.float64)
    K = cams[0][0].astype(np.float64)
    gt = np.concatenate([np.stack([(xs - K[0, 2]) * plane / K[0, 0] + r * FUSE_BASELINE,
                                   (ys - K[1, 2]) * plane / K[1, 1],
                                   np.full_like(xs, plane)], -1).reshape(-1, 3)
                         for r in range(CHAIN_MAPS)])
    quality = accuracy_completeness(xyz, gt, max_dist=20.0, downsample=1.0) if len(xyz) else {}
    depth_err = np.median(np.abs(np.stack(list(maps["depth_est_0"].values())) - plane))
    if fused_launches != CHAIN_MAPS or len(xyz) == 0 or z_err >= CHAIN_INTERVAL:
        _fail(f"the chain fused {len(xyz)} points with {fused_launches} kernel launches, "
              f"median |z - plane| {z_err} (bar one hypothesis interval, {CHAIN_INTERVAL})")
    print(f"chain: run_inference, InferConfig() defaults, matching_model weights, at "
          f"{MAIN_H}x{MAIN_W}, V={MAIN_V}, D={CHAIN_D} (cut from 512), {CHAIN_MAPS} maps in "
          f"packed modes {stats['modes']}, {', '.join(f'{s:.3f}' for s in stats['map_seconds'])} "
          f"s a map, gate kernel launches {launches} (= 5 x {CHAIN_D} x {CHAIN_MAPS}); median "
          f"|depth - plane| {depth_err:.4f}; fuse_views {fuse_s:.3f} s, {len(xyz)} points, "
          f"fusion kernel launches {fused_launches}, median |z - plane| {z_err:.4f} (bar "
          f"{CHAIN_INTERVAL}); accuracy mean {quality['accuracy_mean']:.4f} median "
          f"{quality['accuracy_median']:.4f}, completeness mean "
          f"{quality['completeness_mean']:.4f} median {quality['completeness_median']:.4f}, "
          f"overall {quality['overall']:.4f} (voxel 1.0, clamp 20; {quality['n_pred']} / "
          f"{quality['n_gt']} points)", flush=True)
    return launches, fused_launches


def _held_to(name: str, got: dict, want: dict, bars: dict) -> str:
    """The verdict on ``got`` against ``want``: bit for bit where they are
    equal on every key of ``bars``, else each key's difference, failing
    past its bar (``depth``: the least share of equal pixels; the others:
    max_abs_err)."""
    if all(torch.equal(got[k], want[k]) for k in bars):
        return "bit for bit"
    notes = []
    for key, bar in bars.items():
        if key == "depth":
            share = (got[key] == want[key]).float().mean().item()
            ok, note = share >= bar, f"depth equal on {share:.4%} (bar {bar:.1%})"
        else:
            err = (got[key] - want[key]).abs().max().item()
            ok, note = err <= bar, f"{key} max_abs_err {err:.3e} (bar {bar:g})"
        notes.append(note)
        if not ok:
            _fail(f"{name}: {note}")
    return "within the bars, not bit for bit: " + ", ".join(notes)


def phase_export() -> int:
    from aa_rmvsnet_tpu_torch.models import SweepConfig, evidential_apply, forward
    from aa_rmvsnet_tpu_torch.ops import gates
    from aa_rmvsnet_tpu_torch.utils.export import (
        export_evidential,
        export_forward,
        load_and_call,
        save_exported_evidential,
    )
    from aa_rmvsnet_tpu_torch.utils.synthetic import plane_scene, seeded_head, seeded_model

    # A plane scene at the export shape, 16 hypotheses 2.5 apart around it.
    _, V, H, W, _ = EXPORT_SHAPE
    (sample,) = plane_scene(H, W, V, EXPORT_D, maps=1, seed=SEED + 2, focal=400.0,
                            baseline=2.0, plane_depth=500.0, depth_min=480.0,
                            depth_interval=2.5)
    imgs, proj, depths = (torch.from_numpy(sample[k])[None].cuda()
                          for k in ("imgs", "proj_matrices", "depth_values"))
    model = seeded_model(SEED)
    gates.launches = 0
    t0 = time.perf_counter()
    data, program = export_forward(model, EXPORT_SHAPE, EXPORT_D, EXPORT_BLOCK)
    export_s = time.perf_counter() - t0
    traced_launches = gates.launches
    targets = [node.target for node in program.graph.nodes if node.op == "call_function"]
    n_op = sum(t is torch.ops.aa_rmvsnet_torch.lstm_gates.default for t in targets)
    n_tanh = sum("tanh" in str(t) for t in targets)
    if n_op != 5 * EXPORT_D or n_tanh or traced_launches:
        _fail(f"the exported forward holds {n_op} gate ops (expected {5 * EXPORT_D}) and "
              f"{n_tanh} tanh nodes (expected 0); tracing launched {traced_launches} kernels")

    with torch.no_grad():
        eager = forward(model, imgs, proj, depths,
                        SweepConfig(depth_block=EXPORT_BLOCK, collect_volume=False))
        module = program.module()
        gates.launches = 0
        exported = module(imgs, proj, depths)
        torch.cuda.synchronize()
        launches = gates.launches
    if launches != 5 * EXPORT_D:
        _fail(f"the exported forward launched the gate kernel {launches} times, not "
              f"5 x {EXPORT_D}")
    verdict = _held_to("exported forward", exported, eager,
                       {"depth": 0.999, "photometric_confidence": 1e-4})
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "forward.pt2")
        with open(path, "wb") as f:
            f.write(data)
        t0 = time.perf_counter()
        loaded = load_and_call(path, model, imgs, proj, depths)
        load_s = time.perf_counter() - t0
    if not all(torch.equal(loaded[k], exported[k]) for k in exported):
        _fail("the loaded forward disagrees with the program it was saved from")
    print(f"export: forward at {EXPORT_SHAPE}, D={EXPORT_D}, depth block {EXPORT_BLOCK}, fp32, "
          f"unpacked: exported and serialised in {export_s:.1f} s ({len(data) / 2**20:.1f} MiB, "
          f"{len(targets)} call nodes, {n_op} aa_rmvsnet_torch::lstm_gates, no tanh); run on "
          f"the card with {launches} gate kernel launches (= 5 x {EXPORT_D}); against eager "
          f"forward: {verdict}; written, loaded and called (load_and_call) in {load_s:.1f} s, "
          "equal to the program", flush=True)

    head = seeded_head(SEED)
    B, D, H, W = EXPORT_HEAD_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    cost = 3.0 * torch.randn(EXPORT_HEAD_SHAPE, device="cuda", generator=gen)
    dvals = (MAIN_DEPTH_MIN + 2.75 * torch.arange(D, device="cuda", dtype=torch.float32))[None]
    t0 = time.perf_counter()
    _, head_program = export_evidential(head, EXPORT_HEAD_SHAPE, EXPORT_MAXDISP)
    head_export_s = time.perf_counter() - t0
    with torch.no_grad():
        eager = evidential_apply(head, cost, dvals)
        eager_again = evidential_apply(head, cost, dvals)
        exported = head_program.module()(cost, dvals)
    verdict = _held_to("exported head", exported, eager, EV_BARS)
    repeat = _held_to("eager head run twice", eager_again, eager, EV_BARS)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "head.pt2")
        nbytes = save_exported_evidential(path, head, input_shape=EXPORT_HEAD_SHAPE,
                                          maxdisp=EXPORT_MAXDISP)
        loaded = load_and_call(path, head, cost, dvals)
    # Not held bit for bit: cuDNN's transposed 3D convolutions may sum in
    # another order from one call to the next.
    round_trip = _held_to("loaded head", loaded, exported, EV_BARS)
    print(f"export: evidential head at {EXPORT_HEAD_SHAPE}, maxdisp {EXPORT_MAXDISP}, seeded "
          f"weights: exported and serialised in {head_export_s:.1f} s; against eager: "
          f"{verdict}; save_exported_evidential ({nbytes / 2**20:.1f} MiB) and load_and_call "
          f"against the program: {round_trip}; eager run twice: {repeat}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
              "CUDA GPU", file=sys.stderr)
        return 1
    try:
        import aa_rmvsnet_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc}); run from the "
              "root of the repository", file=sys.stderr)
        return 1
    from aa_rmvsnet_tpu_torch.utils.device import disable_tf32

    disable_tf32()
    t0 = time.perf_counter()
    seconds = {}

    def run(name, fn, *args):
        start = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - start
        return result

    run("1", phase_device)
    run("2", phase_build)
    forward = run("3", phase_kernel)
    backward = run("3b", phase_backward_kernel)
    run("4", phase_small)
    run("4b", phase_train_small)
    run("4h", phase_train_levers_small)
    run("4e", phase_train_evidential_small)
    run("4c", phase_packed_small)
    run("4d", phase_bf16_guardrail)
    run("4f", phase_levers_small)
    run("4g", phase_levers_guardrail)
    run("4i", phase_omega_chain)
    samples = run("scene", _main_scene)
    bf16_launches, packed_depth0, phase5 = run("5", phase_main, samples)
    run("5e", phase_feat_chunk, samples, phase5)
    fp32_launches, fp32_packed_launches = run("5b", phase_main_exact, samples, phase5)
    evidential_launches, evidential_backward, head_input = run("5c", phase_evidential, samples)
    levers5d = run("5d", phase_main_levers, samples, packed_depth0, phase5)
    omega_chain_launches = run("5j", phase_main_levers_chain, samples, levers5d)
    (fanout_launches, pipeline_launches, spatial_launches, spatial_packed_fp32_launches,
     spatial_fp32_launches) = run("5f+5g+5i+5l", phase_inference_ranks, phase5, head_input)
    del head_input
    run("5h", phase_cli_ranks, phase5)
    view_spatial_launches = run("5k", phase_view_spatial)
    phase6 = run("6", phase_train)
    forward["launches"], backward["launches"] = phase6["launches"], phase6["backward"]
    train_ev_launches, train_ev_backward = run("6b", phase_train_evidential)
    levers = run("6c", phase_train_bf16, phase6)
    levers["training_data_parallel"] = run("6d", phase_data_parallel, phase6)
    levers["training_view_parallel"] = run("6e", phase_view_parallel, phase6)
    levers["training_spatial"] = run("6f", phase_spatial_training, phase6)
    levers["training_spatial_evidential"] = run("6g", phase_spatial_evidential_training, phase6)
    fusion = run("7", phase_fusion_kernel)
    fusion["launches"] = run("7b", phase_fusion_scan)
    chain_launches, chain_fused = run("7c", phase_chain)
    export_launches = run("8", phase_export)
    fusion["launches_by_path"] = {"fusion_scan": fusion["launches"], "chain": chain_fused}
    forward["launches_by_path"] = {"inference_bf16_packed": bf16_launches,
                                   "inference_fp32": fp32_launches,
                                   "inference_fp32_packed": fp32_packed_launches,
                                   "inference_evidential": evidential_launches,
                                   "inference_levers": levers5d["launches"],
                                   "inference_levers_omega_chain": omega_chain_launches,
                                   "inference_fanout": fanout_launches,
                                   "inference_depth_pipeline": pipeline_launches,
                                   "inference_spatial": spatial_launches,
                                   "inference_spatial_packed_fp32":
                                       spatial_packed_fp32_launches,
                                   "inference_spatial_fp32": spatial_fp32_launches,
                                   "inference_spatial_evidential":
                                       spatial_packed_fp32_launches,
                                   "inference_view_spatial": view_spatial_launches,
                                   "training": forward["launches"],
                                   "training_evidential": train_ev_launches,
                                   **{k: v[0] for k, v in levers.items()},
                                   "chain": chain_launches,
                                   "export": export_launches}
    backward["launches_by_path"] = {"inference_bf16_packed": 0, "inference_fp32": 0,
                                    "inference_evidential": evidential_backward,
                                    "inference_levers": 0,
                                    "inference_levers_omega_chain": 0, "inference_fanout": 0,
                                    "inference_depth_pipeline": 0, "inference_spatial": 0,
                                    "inference_spatial_packed_fp32": 0,
                                    "inference_spatial_fp32": 0,
                                    "inference_spatial_evidential": 0,
                                    "inference_view_spatial": 0,
                                    "inference_fp32_packed": 0,
                                    "training": backward["launches"],
                                    "training_evidential": train_ev_backward,
                                    **{k: v[1] for k, v in levers.items()},
                                    "chain": 0, "export": 0}
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()),
          flush=True)
    print(f"total: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": [forward, backward, fusion]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
