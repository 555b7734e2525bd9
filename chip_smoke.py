#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (py4cast_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases — each passes or raises, so any failure ends the run with a
non-zero exit code and no result line:

1. the card: its name and power limit (nvidia-smi), TF32 off;
2. build every CUDA kernel of the main path from ``py4cast_tpu_torch/csrc``
   with nvcc (one process per source, all at once); ptxas's registers
   and spills of every a-fwd, b-fwd (row-tile and warp-row), c-fwd,
   a-bwd, b-bwd (node and corner pass) and c-bwd (dq and dK/dV pass)
   instance;
3. each forward kernel against its plain PyTorch version at the main
   path's shapes (GraphLAM at 500x500: each mesh level's lattice,
   125x125, 63x63 and 32x32, for the stencil message; the 500x500 grid
   for the corner hop, which gathers from the 125x125 level-0 lattice
   through GraphLAM's corner maps, at h = 64 and at h = 96, the widest
   it takes), each with its bound and a second call bit for bit, and
   the launched instance's registers, spills and resident blocks,
   inputs from a numpy seed, then both timed with CUDA events;
3b. each backward kernel the same way, with random cotangents: input
   gradients against the plain backward, weight gradients (sums over
   every cell) against the plain backward in fp64, as is the plain
   backward in fp32; a-bwd at each GraphLAM level's lattice (125x125,
   63x63, 32x32), each with its bound, a second call bit for bit, and
   the launched instance's registers, spills and resident blocks; b-bwd
   at the 500x500 grid the same way, with its share of the bound and
   both launched passes' registers, spills, resident blocks and cells a
   tile;
3c. the short-KV attention kernels (c-fwd and c-bwd) at the Segformer
   512x640 cell's four stage shapes, a ragged Lq, a K/V that spills its
   tiles, UNetRPP's seven shapes at 512x640 (head dims 8, 16, 32, 64,
   128; K/V 64 or 32 projected tokens) and its Dummy call's deepest
   stage (K/V of 4 tokens): the forward against the plain version and its lse against
   the fp64 logsumexp, dq against the plain backward, dk and dv against
   it in fp64, both kernels bit for bit against a second call; c-fwd's
   launch shape with its registers, spills and resident blocks (and
   ptxas's report from phase 2), c-bwd's the same for both its passes;
   each with its bound; timed with CUDA events beside
   F.scaled_dot_product_attention (the library's time, never on the
   path), and c-fwd's sum over one 512x640 model call, and c-bwd's over
   one train step's backward, beside it, for Segformer and for UNetRPP;
4. ``Trainer.predict`` on the Dummy dataset with GraphLAM at the width of
   config/CLI/model/graphlam.yaml: launch counts of both forward
   kernels, finite outputs, the first batch against the same module on
   the CPU;
5. the full-size GraphLAM rollout (500x500 grid, batch 1, 3 AR steps)
   through the same predict path: ms per step, peak memory, a profile of
   where the device time goes and of how many device activities a call
   runs, and step 1 against the CPU;
6. ``Trainer.fit`` on Dummy, GraphLAM at the same width: launch counts of
   all four kernels, a finite and changing train loss, ``last`` and the
   manifest written, a resume that continues the optimizer-step count,
   ``Trainer.test``; one train step's gradients on the card against the
   CPU's; the CLI's fit, test and predict in-process;
7. one full-size train step (500x500, batch 1, 1 AR step): ms per step,
   peak memory, a profile of where the device time goes and of its
   device activities, finite loss and gradients;
8. ``Trainer.predict`` on Dummy with Segformer at the width of
   config/CLI/model/segformer.yaml: 8 c-fwd launches per model call,
   finite outputs, agreement with the CPU;
9. ``Trainer.fit`` on Dummy with Segformer, phase 6's schedule: exact
   c-fwd and c-bwd counts, a resume, ``Trainer.test``, one train step's
   gradients against the CPU's, the CLI with segformer.yaml;
10. the full-width Segformer at 512x640 (batch 1, 21 weather and 21
   forcing features): a 3-step predict and a 1-AR-step AdamW train step,
   ms per step, peak memory, profiles, step 1 against the CPU;
11. HalfUNet at the width of config/CLI/model/halfunet.yaml (64
   filters, depth 4, no bias, no ghost): ``Trainer.predict`` and
   ``Trainer.fit`` on Dummy with every hand kernel counted at 0, the
   CLI with halfunet.yaml, and phase 10's 512x640 predict and train
   step;
12. HiLAM at the width of config/CLI/model/hilam.yaml (h 64, 4
   processor layers, 3 mesh levels; lattices 125², 63², 32² at
   500x500): ``Trainer.predict`` and ``Trainer.fit`` on Dummy with
   exact launch counts (16 a-fwd and 1 b-fwd a forward, as many a-bwd
   and b-bwd a backward), card against CPU, the CLI, and phases 5 and
   7's 500x500 predict and train step;
13. HiLAMParallel at the width of hilamparallel.yaml: the same on
   Dummy (12 a-fwd a forward; 9 a-bwd a backward, the stages whose
   outputs reach the loss) and a 500x500 predict;
14. the observers: PSD-K, PSD-Var and ACC (``module.make_metrics``) on
   the card over phase 11's HalfUNet 512x640 and phase 5's GraphLAM
   500x500 predictions (graph layout) against fp64 scipy/numpy
   versions, a second update bit for bit, no host sync inside an
   update, the device ms of one update by CUDA events beside its
   bound, and a profile of one update; ``Trainer.test`` with logging on, on Dummy for GraphLAM and
   Segformer: exact launch counts, PSD-Var and ACC scores within 1e-4
   of the CPU's, the host ms a batch with logging on and off; the
   CLI's predict with ``data.save_gribs`` against a template
   ``make_template`` built for Dummy's grid, every GRIB field read back
   against the .npy predictions within the packing quantum;
15. UNet at the width of config/CLI/model/unet.yaml (64 features,
   depth 4): ``Trainer.predict`` and ``Trainer.fit`` on Dummy with every
   hand kernel counted at 0, the CLI with unet.yaml, and phase 10's
   512x640 predict and train step;
16. UNetRPP at the width of config/CLI/model/unetrpp.yaml (hidden 1024,
   depths 3/3/3/3, heads 16/4, linear upsampling, instance norm) with
   ``attention_code: flash_attn``: ``Trainer.predict`` and
   ``Trainer.fit`` on Dummy with exact launch counts (15 c-fwd a
   forward, 15 c-bwd a backward), card against CPU, a resume,
   ``Trainer.test``; the CLI's fit, test and predict with unetrpp.yaml
   as shipped (``attention_code: torch``, every count 0) and its fit
   again with ``flash_attn`` (counted); phase 10's 512x640 predict and
   train step with ``flash_attn`` and again with ``torch``;
17. bf16 (``precision: bf16``, the JAX package's mixed precision): (a)
   the six kernel wrappers on bf16 inputs at phases 3, 3b and 3c's
   shapes, each launching its kernel: outputs and gradients in the
   Pallas kernels' dtypes, within one bf16 ulp of the plain version run
   in fp32 on the same bf16 values and rounded at the same points
   (weight gradients, fp32, against fp64), a second call bit for bit,
   and the wrapper's time on bf16 and on fp32 inputs beside the
   boundary casts' alone; (b) ``Trainer.predict`` and ``Trainer.fit``
   (test; the fp32 fits cover resume) on Dummy for each of the seven
   models in bf16: the launch counts of their fp32 phases, fp32 masters
   and AdamW moments, the card's bf16 predictions of the first batch
   within twice the CPU's bf16-vs-fp32 gap of the card's fp32 ones, and
   one step's gradients within twice the
   CPU's own bf16 error of the CPU's; (c) the full-size GraphLAM
   500x500 predict and train step, HalfUNet and UNetRPP (flash_attn)
   512x640, in bf16 beside their fp32 numbers of phases 5, 7, 11 and
   16: ms/step, peak memory, device time, idle share, copies and casts;
18. the ResNet-encoder models and the perceptual loss, no hand kernel
   (every count stays 0): (a) ``Trainer.predict`` and ``Trainer.fit``
   (resume, test, gradients card vs CPU) on Dummy for CustomUNet,
   DeepLabV3 and DeepLabV3Plus at the width of their config/CLI/model
   yamls (resnet18, depth 5, decoder 256), and the CLI with each yaml;
   (b) CustomUNet with ``encoder_weights: true``: the bundled
   data/pretrained/resnet18.npz loaded on the card, encoder params bit
   for bit the CPU's; (c) each model's 512x640 predict and train step
   as phase 10's; (d) the perceptual loss's value and gradient card vs
   CPU, a HalfUNet Dummy fit with [WeightedLoss + 0.1 perceptual], and
   HalfUNet's 512x640 train step with and without it beside the loss's
   own device ms; (e) the three models' Dummy predict and fit in bf16,
   as phase 17 (b); the phase's wall time;
19. SwinUNetR, plugin discovery and the gather-table GNN path, no hand
   kernel (every count stays 0): (a) SwinUNetR at the width of
   config/CLI/model/swinunetr.yaml (feature size 24, depths 2/2/2/2,
   heads 3/6/12/24, window 7) on Dummy: ``Trainer.predict`` and
   ``Trainer.fit`` (resume, test, gradients card vs CPU), the CLI with
   swinunetr.yaml, a second predict and backward bit for bit, and
   predict and fit in bf16 as phase 17 (b); (b) its 512x640 predict and
   train step in fp32 and in bf16, as phase 10's; (c) the CLI's fit,
   test and predict with ``--model.model_name Identity``, found by
   plugin discovery; (d) GraphLAM and HiLAM with ``use_lattice: false``
   at 500x500, as phases 5 and 7, the table path's step 1 against the
   lattice path's from one state dict, a second predict and backward
   bit for bit; HiLAMParallel's table path on Dummy, predict and fit;
   (e) GraphLAM on an 8x8 grid at mesh_levels 2, whose multimesh repeats
   edges, on the table path against the CPU; the phase's wall time;
20. the data axis (``parallel.mesh``): (a) an NCCL process group of one
   rank (MASTER_ADDR 127.0.0.1, a free port): three AdamW steps of
   GraphLAM at 500x500 and of Segformer at 512x640, bit for bit as the
   same steps without a group (which repeat bit for bit themselves),
   with the same launches (phase 7's a step, three times), and the
   gradient all-reduce's buffer bytes and ms for GraphLAM, Segformer and
   UNetRPP at 512x640; (b) ``torchrun --standalone --nproc-per-node 1 -m
   py4cast_tpu_torch`` fit, test and predict on Dummy with
   halfunet.yaml, one set of outputs written; (c) HiLAM and HalfUNet on
   a 1791x64 crop padded to 1792 rows (``lat_multiple=2``): a train step
   and a predict, counted, predictions back at 1791 rows; (d) on two
   cards or more, two NCCL ranks against one; the phase's wall time;
21. the spatial axis (``parallel.spatial``): (a) on every card count,
   the band pieces at full width fed by hand from a whole-grid tensor on
   the card and held to the whole-grid call, forward and backward, on 2
   and on 4 bands: HalfUNet 512x640's first ConvBlock (halo rows, band
   statistics) and its GroupNorm; GraphLAM 500x500's g2m (partial
   aggregates) and m2g (kernels b-fwd and b-bwd on each band, counted;
   ``dps`` and the weight gradients summed over the bands); at 512x640,
   run on every band in one process through the modules' own band code
   (``testing.run_on_bands``), Segformer's stage-1 attention (its K/V
   gathered), UNetRPP's stage-0 EPA block (flash_attn) and a shifted
   SwinBlock (the roll across bands), kernels c-fwd and c-bwd launched
   at each band's shape, counted and each launch held against its plain
   version; where (b) runs, and with ``--spatial``, in fp64 on 2 and 4
   bands, the ResNet encoder's stem (the 7x7 stride-2 conv padded 3, on
   a (3, 2) halo) and its -inf-padded max pool, ASPP 12/24/36 on the
   16x20 map (halos deeper than a band), the perceptual loss's band
   shares, fwd and bwd, and ``mask_blocks`` bit for bit, and the noise
   floor of (b)'s bars: three AdamW steps of each of
   (b)'s cells in one process against the same with cuDNN off (other
   conv algorithms) and with a planted band fault (every stride-1 SAME
   and every explicitly padded conv run on the two halves of its rows
   apart, as bands without their halo exchange), which must break the
   parameters' bar wherever it moves the losses; (b) with two
   cards or more, S = 2 NCCL ranks against one, with four 2 x 2 too:
   three AdamW steps of HalfUNet, Segformer, UNetRPP (flash_attn),
   SwinUNetR (lat padded to 672), CustomUNet (under the perceptual loss
   0.1 and ``mask_ratio`` 0.25) and DeepLabV3Plus 512x640, GraphLAM and
   HiLAM 500x500 at their yamls' widths, losses and parameters (max-abs over scale,
   relative L2) within TOL, the first step's reduced gradients within
   GRAD_TOL, each bar widened to NOISE_FACTOR times the cell's noise
   floor where that is more, a-fwd, a-bwd and b
   launched each step as often as on one rank, per-rank ms a step, peak
   memory and the bytes the halo exchanges received; with four, one HalfUNet train
   step on the 1791x2801 Titan grid (padded to 1792) at S = 1, 2 and 4
   and each rank's peak memory; "not run, N card(s)" otherwise; the
   phase's wall time;
22. the datasets, on trees written from a seed under build/ and deleted
   after: (a) Titan at its default configuration (37 fields, 21
   AROME input_output and 16 ARPEGE inputs, on PAAROME_1S40's 512x640
   subdomain, 12 hours of files, periods narrowed in a dataset conf
   JSON): the port's dataset CLI's prepare (statistics), describe and
   speedtest, and titan.yaml's loader (batch 2, 10 workers) ms a batch
   in its steady state (2 batches skipped, 10 timed) through the C++ npy
   reader and through per-file numpy reads; (b) the
   CLI's fit (3 optimizer steps), test and predict on it, fp32, with
   halfunet.yaml and graphlam.yaml, each counted (GraphLAM's a-fwd,
   a-bwd, b-fwd and b-bwd at 512x640), predictions written and read
   back; beside it, the first batch on the card bit for bit the numpy
   item, the first step's loss within TOL of the CPU's and its gradients
   held against the CPU's as phase 21 (b) holds them, host ms a train
   step, loader ms a batch, ``_to_device`` ms and peak memory; (c)
   Poesy at its real 600x600x45x16 shape (one run, t2m and u10, two
   1.04 GB memory-mapped files), members 0 and 3, HalfUNet at
   halfunet.yaml's width: fit 2 steps, test and predict, the members
   each trained on, scored and exported; (d) Rainfall, a dozen
   1536x1536 files: one HalfUNet fit step and one predict, their peak
   memory; the phase's wall time;
23. the user tools: (a) ``export.export_forward`` (as
   ``Trainer._log_model`` calls it; every Dummy fit of phases 6 to 19
   also checks that a grid model's fit wrote model/forward.pt2 and a
   graph model's did not) of HalfUNet, Segformer and UNetRPP
   (``attention_code: pallas``) at their yamls' width at 512x640, batch
   1, fp32; each program reloaded by ``load_and_infer`` and run against
   the eager model within 1e-5 of its scale, its launches counted (8 and
   15 c-fwd for Segformer and UNetRPP, none else), the file deleted
   after; (b) the FLOPs (``ops/flops.py``, under fake tensors) of one
   predict call and one train step of all eleven models at their yamls'
   width, grid models at 512x640 and graph models at 500x500, each
   kernel's share, HalfUNet and GraphLAM counted again by a real call on
   the card, which must count the same; (c) a Dummy GraphLAM fit of one
   batch with ``trainer.profiler: jax``: its torch.profiler trace under
   build/ names the a and b kernels, forward and backward, and is
   deleted; (d) the host microseconds of 1,000 c-fwd calls at a tiny
   shape through the custom op and through its bare CUDA
   implementation; the phase's wall time;
24. the weight-making tools and the ResNet34 path (no hand kernel:
   every count 0), everything written under build/smoke_tools and
   deleted after: (a) ``tools/pretrain_encoder`` with ``--encoder
   resnet34`` at its defaults (500 steps, batch 16, 64x64), its first
   and last denoise MSE, steps a second, its first three losses against
   the same steps on the CPU; (b) DeepLabV3Plus at deeplabv3plus.yaml's
   width on that ResNet34 npz at 512x640, batch 1: the loaded encoder
   the npz's bit for bit through ``convert.encoder_to_flax``, a predict
   call and two train steps, counted, the first loss against the CPU's,
   peak memory and host ms a step; (c) ``tools/train_perceptual_features``
   at its defaults (800 steps, batch 32): the committed file's keys and
   shapes, three steps' parameters against the CPU's, steps a second;
   (d) a seeded torchvision resnet34 checkpoint through
   ``tools/convert_torchvision_encoder``, a Dummy fit of CustomUNet with
   ``encoder_norm: affine`` on it; (e) ``tools/make_grib_template
   --dataset dummy --margin 4`` read back with ``io/grib2.read_grib2``;
   the phase's wall time beside its 60 s budget;
25. the graph models at hidden widths past the row-tile instances of
   kernels a and b (a-fwd above 128, b-fwd above 96, a-bwd and b-bwd
   above 64), on their wide instances (``csrc/wide_rows.cuh``): (a) each
   of the four kernels at h = 128 and 256 at the path's shapes (a at the
   125x125 level, e (1,8,125,125,h); b at the 500x500 grid, vd
   (1,500,500,h)) against its plain version (the backward's weight
   gradients against the plain backward in fp64), a second call bit for
   bit, timed beside the plain version (CUDA-event medians over 5
   windows of 3 calls), its bound and its instance's registers, spills,
   shared memory, resident blocks and rows a tile; (b) at h = 65, 100,
   130 and 512, each kernel once at small shapes against its plain
   version and a second call bit for bit; (c) one bf16 shape a kernel at
   h = 256 within one bf16 ulp of its plain version (as 17 (a));
   (d) ``Trainer.predict`` (3 AR steps) and ``Trainer.fit`` (2 train
   steps) at 500x500, batch 1, on synthetic data: GraphLAM at
   ``hidden_dims`` 128 and 256, HiLAM at 128 (predict and fit),
   HiLAMParallel at 128 (predict), counted (each wide instance launched
   whenever the width needs it), host ms a step and peak memory; (e)
   GraphLAM at 128 and 256 and HiLAM at 128 on a 64x64 grid: one train
   step's loss and gradients on the card against the CPU (phase 6's
   bars); the phase's
   wall time beside its 40 s budget;
26. the script's wall time, each phase's wall seconds, one JSON line
   with every kernel's numbers, the card's line, then the result line.

Each model path runs with every launch count set to 0 just before it
and read just after; a kernel of the path that was not launched, or a
kernel of another path that was, fails the run.

``--kernels NAME ...`` runs phases 1 to 3c for those kernels alone and
stops without a result line: the short loop for one kernel's work.
``--datasets`` runs phases 1, 2 and 22 alone and stops without a
result line: the loop for the data path.
``--tools`` runs phases 1, 2, 23 and 24 alone and stops without a
result line: the loop for the user tools.
``--steps`` runs phases 1, 2, 5 and 7 alone (GraphLAM's 500x500 predict
and train step, their host ms) and stops without a result line: the
same-call comparison of two trees' host cost a step.
``--spatial`` runs phases 1, 2, 20 (d) and 21 alone and stops without a
result line: the multi-card loop for the data and spatial axes, which
saves running every one-card phase again on four cards.
``--wide`` runs phases 1, 2 and 25 alone and stops without a result
line: the loop for the graph models' wide widths.

Exits non-zero without a result when torch sees no CUDA device or the
package is missing. Build outputs go to ``build/`` and long reports to
``chiprun_out/``, both inside the checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from types import SimpleNamespace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
BUILD = ROOT / "build"
TOL = 1e-4
#: gradients: the JAX kernel tests' bar (tests/test_stencil_kernel.py:86)
GRAD_TOL = 2e-4
#: one train step's gradients, card against CPU, over the whole model
TRAIN_GRAD_TOL = 1e-3
TRAIN_LOSS_RTOL = 1e-5

#: settings_init_args of config/CLI/model/graphlam.yaml
GRAPHLAM_ARGS = {
    "tmp_dir": "/tmp",
    "hidden_dims": 64,
    "hidden_layers": 1,
    "use_checkpointing": False,
    "offload_to_cpu": False,
    "mesh_aggr": "sum",
    "processor_layers": 4,
    "use_lattice": True,
}

#: settings_init_args of config/CLI/model/segformer.yaml (the other
#: fields at SegformerSettings' defaults)
SEGFORMER_ARGS = {"num_layers": 2, "decoder_dim": 256, "num_downsampling_chans": 32}

#: settings_init_args of config/CLI/model/halfunet.yaml (depth at
#: HalfUNetSettings' default, 4)
HALFUNET_ARGS = {"num_filters": 64, "dilation": 1, "bias": False, "use_ghost": False,
                 "last_activation": "Identity", "absolute_pos_embed": False,
                 "autopad_enabled": True}

#: settings_init_args of config/CLI/model/unet.yaml (depth at
#: UNetSettings' default, 4)
UNET_ARGS = {"init_features": 64, "autopad_enabled": True}

#: settings_init_args of config/CLI/model/unetrpp.yaml, as shipped
#: (attention_code "torch": the plain attention)
UNETRPP_ARGS = {"hidden_size": 1024, "num_heads_encoder": 16, "num_heads_decoder": 4,
                "pos_embed": "perceptron", "norm_name": "instance", "dropout_rate": 0.0,
                "depths": [3, 3, 3, 3], "conv_op": "Conv2d", "linear_upsampling": True,
                "downsampling_rate": 4, "decoder_proj_size": 64,
                "encoder_proj_sizes": [64, 64, 64, 32], "add_skip_connections": True,
                "attention_code": "torch"}
#: the path of kernels c-fwd and c-bwd
FLASH_ATTN = {"attention_code": "flash_attn"}

#: settings_init_args of config/CLI/model/customunet.yaml (decoder
#: channels at CustomUNetSettings' default, 256/128/64/32/16)
CUSTOMUNET_ARGS = {"encoder_name": "resnet18", "encoder_depth": 5, "encoder_weights": False,
                   "autopad_enabled": True}
#: settings_init_args of config/CLI/model/deeplabv3.yaml and
#: deeplabv3plus.yaml
DEEPLAB_ARGS = {"encoder_name": "resnet18", "encoder_depth": 5, "encoder_weights": False,
                "decoder_channels": 256, "activation": None, "upsampling": 8}
#: the ResNet-encoder models and their config/CLI/model files
RESNET_YAMLS = {"CustomUNet": "customunet", "DeepLabV3": "deeplabv3",
                "DeepLabV3Plus": "deeplabv3plus"}
#: the yamls' WeightedLoss with the perceptual loss beside it
PERCEPTUAL_LOSSES = [{"class": "WeightedLoss", "weight": 1.0, "params": {"loss": "MSELoss"}},
                     {"class": "PerceptualLossPy4Cast", "weight": 0.1}]

#: settings_init_args of config/CLI/model/swinunetr.yaml (window 7,
#: SwinUNetRSettings' default)
SWINUNETR_ARGS = {"depths": [2, 2, 2, 2], "num_heads": [3, 6, 12, 24], "feature_size": 24,
                  "norm_name": "instance", "drop_rate": 0.0, "attn_drop_rate": 0.0,
                  "dropout_path_rate": 0.0, "normalize": True, "use_checkpoint": False,
                  "downsample": "merging", "use_v2": False}
#: the graph models' gather-table path
TABLE = {"use_lattice": False}

#: each model's settings_init_args; hilam.yaml and hilamparallel.yaml
#: carry graphlam.yaml's (h 64, 4 processor layers, 3 mesh levels);
#: UNetRPP's main path is the kernels' (flash_attn)
MODEL_ARGS = {"GraphLAM": GRAPHLAM_ARGS, "HiLAM": GRAPHLAM_ARGS, "HiLAMParallel": GRAPHLAM_ARGS,
              "Segformer": SEGFORMER_ARGS, "HalfUNet": HALFUNET_ARGS, "UNet": UNET_ARGS,
              "UNetRPP": {**UNETRPP_ARGS, **FLASH_ATTN}, "CustomUNet": CUSTOMUNET_ARGS,
              "DeepLabV3": DEEPLAB_ARGS, "DeepLabV3Plus": DEEPLAB_ARGS,
              "SwinUNetR": SWINUNETR_ARGS, "Identity": {}}

#: H100 SXM data-sheet peaks (full 700 W power limit): HBM3 bytes/s and
#: fp32 operations/s outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

#: the TPU kernel each one replaces in the JAX package: its body
#: (file:line) and the function that reaches pl.pallas_call
REPLACES = {
    "stencil_message": ("py4cast_tpu/ops/stencil_kernel.py:52", "_fwd_kernel via _fwd_call:96"),
    "corner_hop": ("py4cast_tpu/ops/hop_kernel.py:120", "_fwd_kernel via _fwd_call:539"),
    "stencil_message_bwd": ("py4cast_tpu/ops/stencil_kernel.py:245",
                            "_bwd_kernel via _bwd_call:347"),
    "corner_hop_bwd": ("py4cast_tpu/ops/hop_kernel.py:267", "_bwd_kernel via _bwd_call:589"),
    "short_kv_attention": ("py4cast_tpu/ops/attention.py:33", "_fwd_kernel via _forward:101"),
    "short_kv_attention_bwd": ("py4cast_tpu/ops/attention.py:47",
                               "_bwd_kernel via _bwd_rule:128"),
}


#: the sources each --kernels name builds (the attention's check runs
#: its forward and its backward)
KERNEL_SOURCES = {
    "stencil_message": ("stencil_message",),
    "corner_hop": ("corner_hop",),
    "stencil_message_bwd": ("stencil_message_bwd",),
    "corner_hop_bwd": ("corner_hop_bwd",),
    "short_kv_attention": ("short_kv_attention", "short_kv_attention_bwd"),
}

#: the kernels whose registers and spills phase 2 reports, by source
PTXAS_KERNELS = {
    "stencil_message": ("stencil_message_fwd", "stencil_message_fwd_wide"),
    "corner_hop": ("corner_hop_fwd", "corner_hop_fwd_warps", "corner_hop_fwd_wide"),
    "short_kv_attention": ("short_kv_attention_fwd",),
    "stencil_message_bwd": ("stencil_message_bwd", "stencil_message_bwd_wide"),
    "corner_hop_bwd": ("corner_hop_bwd_node", "corner_hop_bwd_corner",
                       "corner_hop_bwd_node_wide", "corner_hop_bwd_corner_wide"),
    "short_kv_attention_bwd": ("short_kv_attention_bwd_dq", "short_kv_attention_bwd_dkdv"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if len(out) > 1 else out[0]


def time_ms(fn, reps: int = 15, warmup: int = 3, inner: int = 10) -> float:
    """Median device milliseconds of one ``fn()`` call over ``reps``
    windows, each ``inner`` back-to-back calls between two CUDA events on
    the current stream. Each window starts behind a sleep kernel that
    outlasts the host's enqueueing of the window (twice its host time at
    up to 2 GHz), so the calls run back to back on the device and the
    host's share of a call (the wrapper's checks, allocations and launch)
    is not counted, even where it is longer than the device's work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    cycles = int(4e9 * (time.perf_counter() - t0)) + 100_000
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def ptxas_summary(text: str, kernel: str) -> list:
    """(template arguments joined by commas, registers, (spill store
    bytes, spill load bytes)) of each instance of the kernel template
    ``kernel`` in ``nvcc -Xptxas -v`` output."""
    rows, spills, name = [], {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills[name] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            inst = re.search(kernel + r"I((?:Li\d+E)+)", name)
            if inst:
                rows.append((",".join(re.findall(r"Li(\d+)E", inst.group(1))),
                             int(m.group(1)), name))
    return [(inst, regs, spills.get(name, (None, None))) for inst, regs, name in rows]


def bound(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol: float = TOL) -> float:
    """Max abs difference; raises when it exceeds ``tol`` relative to the
    reference's scale (or ``tol`` absolute below 1)."""
    err = float((got.double() - want.double()).abs().max())
    scale = max(1.0, float(want.abs().max()))
    if not np.isfinite(err) or err > tol * scale:
        raise AssertionError(f"{name}: max abs diff {err:.3e} exceeds {tol:g} x {scale:.3g}")
    return err


def max_abs_diff(a, b) -> float:
    """The largest |a - b| over two lists of host arrays."""
    return max(float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max())
               for x, y in zip(a, b))


def _rand(rng, *shape, scale=1.0, shift=0.0, device="cuda"):
    a = rng.standard_normal(shape).astype(np.float32) * scale + shift
    return torch.from_numpy(a).to(device)


# ------------------------------------------------------------------- phase 3
def stencil_inputs(rng, b=1, hr=125, w=125, h=64, shifted=False):
    """e, the source projection (ps (b, hr, w, h) for the forward, its
    eight shifts vs (b, 8, hr, w, h) for the backward when ``shifted``),
    pd, mask and the weights."""
    src = (b, 8, hr, w, h) if shifted else (b, hr, w, h)
    return (
        _rand(rng, b, 8, hr, w, h), _rand(rng, *src), _rand(rng, b, hr, w, h),
        torch.from_numpy((rng.uniform(size=(8, hr, w, 1)) > 0.2).astype(np.float32)).cuda(),
        _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, scale=0.2, shift=1.0), _rand(rng, h, scale=0.1),
    )


def hop_inputs(rng, b=1, hr=500, w=500, h=64, ff=3):
    """(ps, rows, cols): the source projection on GraphLAM's level-0
    lattice (the grid coarsened by 4, as build_graph_artifacts does) and
    its int32 corner maps; and the grid's vd, feats and the weights."""
    from py4cast_tpu_torch.models.graph import _corners_rc

    coarse = (max(2, hr // 4), max(2, w // 4))
    (r0, r1), (c0, c1) = _corners_rc((hr, w), coarse)
    maps = [torch.from_numpy(np.stack(m).astype(np.int32)).cuda() for m in ((r0, r1), (c0, c1))]
    src = (_rand(rng, b, *coarse, h), *maps)
    rest = (
        _rand(rng, b, hr, w, h), _rand(rng, 4, hr, w, ff, scale=0.5),
        _rand(rng, ff, h, scale=ff ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, h, scale=h ** -0.5),
        _rand(rng, h, scale=0.1), _rand(rng, h, scale=0.2, shift=1.0), _rand(rng, h, scale=0.1),
        _rand(rng, h, h, scale=(2 * h) ** -0.5), _rand(rng, h, h, scale=(2 * h) ** -0.5),
        _rand(rng, h, scale=0.1), _rand(rng, h, h, scale=h ** -0.5), _rand(rng, h, scale=0.1),
        _rand(rng, h, scale=0.2, shift=1.0), _rand(rng, h, scale=0.1),
    )
    return src, rest


#: the lattice sides of GraphLAM's three mesh levels at 500x500 (the
#: stencil kernels run once a level in each of the 4 processor layers)
GRAPHLAM_LEVELS = (125, 63, 32)


def _max_rel(got, want) -> tuple:
    """(max abs difference, that over the reference's scale) over pairs
    of tensors, each held to TOL of its scale."""
    err = rel = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        e = compare(f"output {i}", g, w)
        err, rel = max(err, e), max(rel, e / max(1.0, float(w.abs().max())))
    return err, rel


def check_stencil(rng, b=1, h=64) -> dict:
    """a-fwd against its plain version at each GraphLAM level's lattice
    (residual on), a second call bit for bit, both timed, with the bound
    and its share; the launched instance's registers, spills and
    resident blocks. The level-0 numbers on top, every level's under
    "shapes", and the sum over one forward's 12 launches."""
    from py4cast_tpu_torch.ops.stencil_kernel import (
        fused_stencil_message,
        fwd_kernel_attributes,
        stencil_message_plain,
    )

    rows = []
    for hr in GRAPHLAM_LEVELS:
        w = hr
        args = stencil_inputs(rng, b, hr, w, h)
        got = fused_stencil_message(*args, residual=True)
        torch.cuda.synchronize()
        err, rel = _max_rel(got, stencil_message_plain(*args, residual=True))
        again = fused_stencil_message(*args, residual=True)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"stencil_message {hr}x{w}: a second call differs")
        del got, again
        ms = time_ms(lambda: fused_stencil_message(*args, residual=True))
        plain_ms = time_ms(lambda: stencil_message_plain(*args, residual=True))
        cells = b * hr * w
        # reads e (8 rows a cell), ps, pd, mask, the weights; writes out
        # (8 rows a cell) and agg: the kernel shifts ps itself
        n_bytes = 4 * (2 * 8 * cells * h + 3 * cells * h + 8 * hr * w + 2 * h * h + 4 * h)
        # per cell and direction: two h x h products, plus ~19 elementwise
        # operations a channel (bias/vs/pd adds, silu, LayerNorm, residual, agg)
        n_ops = 8 * cells * (4 * h * h + 19 * h)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        rows.append({
            "label": f"level {len(rows)}",
            "shape": f"e ({b},8,{hr},{w},{h}) ps ({b},{hr},{w},{h}) residual=True",
            "max_abs_err": err, "max_err_over_scale": rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
        })
    top = rows[0]
    return {
        "name": "stencil_message", "route": "cuda",
        "source": "py4cast_tpu_torch/csrc/stencil_message.cu",
        "replaces": REPLACES["stencil_message"][0],
        "replaces_function": REPLACES["stencil_message"][1],
        "shape": top["shape"], "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_err_over_scale": max(r["max_err_over_scale"] for r in rows),
        "ms": top["ms"], "kernel_ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"], "library_ms": None,
        # one 500x500 forward's 12 launches: 4 layers x the three levels
        "forward_ms": 4 * sum(r["ms"] for r in rows),
        "launch": fwd_kernel_attributes(h, h), "shapes": rows,
    }


def check_hop(rng, b=1, hr=500, w=500, ff=3) -> dict:
    """b-fwd against its plain version at the GraphLAM grid, at h = 64 (the
    path's width, row tiles) and h = 96 (the widest, warp rows), each with
    a second call bit for bit, both timed, the bound and its share, and
    the launched instance's registers, spills, resident blocks and cells
    a tile. The h = 64 numbers on top, both widths' under "shapes"."""
    from py4cast_tpu_torch.ops.hop_kernel import (
        corner_hop_plain,
        fused_corner_hop,
        fwd_kernel_attributes,
    )

    rows = []
    for h in (64, 96):
        src, rest = hop_inputs(rng, b, hr, w, h, ff)
        out = fused_corner_hop(*src, *rest, mean=False)
        torch.cuda.synchronize()
        err, rel = _max_rel([out], [corner_hop_plain(*src, *rest, mean=False)])
        if not torch.equal(out, fused_corner_hop(*src, *rest, mean=False)):
            raise AssertionError(f"corner_hop h={h}: a second call differs")
        del out
        ms = time_ms(lambda: fused_corner_hop(*src, *rest, mean=False))
        plain_ms = time_ms(lambda: corner_hop_plain(*src, *rest, mean=False))
        cells = b * hr * w
        # reads vd, ps on the level-0 lattice, the two maps, feats, the
        # weights; writes v_out: the kernel gathers the corners itself
        n_bytes = 4 * (2 * cells * h + src[0].numel() + src[1].numel() + src[2].numel()
                       + 4 * hr * w * ff + 5 * h * h + ff * h + 8 * h)
        # per cell: eight h x h products (Wd, 4 x Wo, Nd0a, Nd0b, Nd1), the
        # 4 corner-feature products, ~84 elementwise operations a channel
        n_ops = cells * (16 * h * h + 8 * ff * h + 84 * h)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        rows.append({
            "label": f"h={h}",
            "shape": f"ps {tuple(src[0].shape)} vd ({b},{hr},{w},{h}) feats (4,{hr},{w},{ff}) "
                     "mean=False",
            "max_abs_err": err, "max_err_over_scale": rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
            "launch": fwd_kernel_attributes(h),
        })
        del src, rest
    top = rows[0]
    return {
        "name": "corner_hop", "route": "cuda",
        "source": "py4cast_tpu_torch/csrc/corner_hop.cu",
        "replaces": REPLACES["corner_hop"][0],
        "replaces_function": REPLACES["corner_hop"][1],
        "shape": top["shape"], "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_err_over_scale": max(r["max_err_over_scale"] for r in rows),
        "ms": top["ms"], "kernel_ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "share_of_bound": top["share_of_bound"], "library_ms": None,
        "launch": top["launch"], "shapes": rows,
    }


# ------------------------------------------------------------------ phase 3b
def _check_bwd(name, got, plain32, plain64, n_inputs):
    """Input gradients against the plain backward (fp32); weight
    gradients, sums over every cell, against the plain backward in fp64,
    and the fp32 plain backward against it too, so that another
    summation order is not read as a fault. Returns the kernel's largest
    difference from its reference, and the largest such difference over
    the reference's scale (max(1, max|ref|)), the quantity the bar holds."""
    err = rel = 0.0
    for i, (g, p32, p64) in enumerate(zip(got, plain32, plain64)):
        ref = p32 if i < n_inputs else p64
        what = "input" if i < n_inputs else "weight"
        e = compare(f"{name} {what} grad {i}", g, ref, GRAD_TOL)
        err, rel = max(err, e), max(rel, e / max(1.0, float(ref.abs().max())))
        if i >= n_inputs:
            compare(f"{name} weight grad {i} (plain fp32)", p32, p64, GRAD_TOL)
    return err, rel


def check_stencil_bwd(rng, b=1, h=64) -> dict:
    """a-bwd against the plain backward at each GraphLAM level's lattice
    (residual on), a second call bit for bit, both timed; the launched
    instance's registers, spills and resident blocks. The level-0 numbers
    on top, every level's under "shapes"."""
    from py4cast_tpu_torch.ops.stencil_kernel import (
        bwd_kernel_attributes,
        fused_stencil_message_bwd,
        stencil_message_bwd_plain,
    )

    rows = []
    for hr in GRAPHLAM_LEVELS:
        w = hr
        args = stencil_inputs(rng, b, hr, w, h, shifted=True)
        g_out, g_agg = _rand(rng, b, 8, hr, w, h), _rand(rng, b, hr, w, h)
        got = fused_stencil_message_bwd(*args, g_out, g_agg, residual=True)
        torch.cuda.synchronize()
        plain32 = stencil_message_bwd_plain(*args, g_out, g_agg, residual=True)
        plain64 = stencil_message_bwd_plain(*(a.double() for a in args), g_out.double(),
                                            g_agg.double(), residual=True)
        err, rel = _check_bwd(f"stencil_message_bwd {hr}x{w}", got, plain32, plain64, 3)
        again = fused_stencil_message_bwd(*args, g_out, g_agg, residual=True)
        if not all(torch.equal(x, y) for x, y in zip(got[3:], again[3:])):
            raise AssertionError(f"stencil_message_bwd {hr}x{w}: a second call differs")
        del plain32, plain64, again
        ms = time_ms(lambda: fused_stencil_message_bwd(*args, g_out, g_agg, residual=True))
        plain_ms = time_ms(lambda: stencil_message_bwd_plain(*args, g_out, g_agg, residual=True))
        cells = b * hr * w
        # reads e, vs, g_out (8 rows a cell), pd, g_agg, mask, the weights;
        # writes de, dvs (8 rows), dpd and the weight gradients
        n_bytes = 4 * (5 * 8 * cells * h + 3 * cells * h + 8 * hr * w + 2 * (2 * h * h + 4 * h))
        # per cell and direction: six h x h products (e@We and z@Wo
        # recomputed, dt@Wo^T, dpre@We^T, z^T dt, e^T dpre), ~40 elementwise
        # operations a channel (silu and its derivative, LayerNorm forward
        # and backward, the masked cotangent, the residual, the sums)
        n_ops = 8 * cells * (12 * h * h + 40 * h)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        rows.append({
            "label": f"level {len(rows)}", "shape": f"e,vs,g_out ({b},8,{hr},{w},{h}) residual=True",
            "max_abs_err": err, "max_err_over_scale": rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
        })
    top = rows[0]
    return {
        "name": "stencil_message_bwd", "route": "cuda",
        "source": "py4cast_tpu_torch/csrc/stencil_message_bwd.cu",
        "replaces": REPLACES["stencil_message_bwd"][0],
        "replaces_function": REPLACES["stencil_message_bwd"][1],
        "shape": top["shape"], "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_err_over_scale": max(r["max_err_over_scale"] for r in rows),
        "ms": top["ms"], "kernel_ms": top["ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"], "library_ms": None,
        # one 500x500 train step's 12 launches: 4 layers x the three levels
        "train_step_ms": 4 * sum(r["ms"] for r in rows),
        "launch": bwd_kernel_attributes(h, h), "shapes": rows,
    }


def check_hop_bwd(rng, b=1, hr=500, w=500, h=64, ff=3):
    """b-bwd against the plain backward at the GraphLAM grid, a second
    call bit for bit, both timed; the launched node and corner passes'
    registers, spills, resident blocks and cells a tile."""
    from py4cast_tpu_torch.ops.hop_kernel import (
        bwd_kernel_attributes,
        corner_hop_bwd_plain,
        fused_corner_hop_bwd,
        gather_corners,
    )

    src, rest = hop_inputs(rng, b, hr, w, h, ff)
    psg = gather_corners(*src)  # what CornerHopFn's backward hands the kernel
    del src
    g = _rand(rng, b, hr, w, h)
    got = fused_corner_hop_bwd(psg, *rest, g, mean=False)
    torch.cuda.synchronize()
    plain32 = corner_hop_bwd_plain(psg, *rest, g, mean=False)
    plain64 = corner_hop_bwd_plain([p.double() for p in psg], *(a.double() for a in rest),
                                   g.double(), mean=False)
    err, rel = _check_bwd("corner_hop_bwd", got, plain32, plain64, 5)
    del plain32, plain64
    again = fused_corner_hop_bwd(psg, *rest, g, mean=False)
    if not all(torch.equal(x, y) for x, y in zip(got[5:], again[5:])):
        raise AssertionError("corner_hop_bwd: a second call differs")
    del got, again
    ms = time_ms(lambda: fused_corner_hop_bwd(psg, *rest, g, mean=False))
    plain_ms = time_ms(lambda: corner_hop_bwd_plain(psg, *rest, g, mean=False))
    cells = b * hr * w
    # reads psg_k, vd, g, feats, the weights; writes dpsg_k, dvd and the
    # weight gradients
    n_bytes = 4 * (11 * cells * h + 4 * hr * w * ff + 2 * (5 * h * h + ff * h + 8 * h))
    # per cell: 24 h x h products (8 of the forward, their 8 transposes,
    # 8 weight-gradient updates), the corner-feature products and their
    # gradient (16 ff*h), ~200 elementwise operations a channel
    n_ops = cells * (48 * h * h + 16 * ff * h + 200 * h)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    return {
        "name": "corner_hop_bwd", "route": "cuda",
        "source": "py4cast_tpu_torch/csrc/corner_hop_bwd.cu",
        "replaces": REPLACES["corner_hop_bwd"][0],
        "replaces_function": REPLACES["corner_hop_bwd"][1],
        "shape": f"psg,vd,g ({b},{hr},{w},{h}) feats (4,{hr},{w},{ff}) mean=False",
        "max_abs_err": err, "max_err_over_scale": rel,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "share_of_bound": bound_ms / ms,
        "library_ms": None, "launch": bwd_kernel_attributes(h),
    }


# ------------------------------------------------------------------ phase 3c
#: (BH, Lq, Lk, D) of the attention at the 512x640 Segformer cell (heads
#: 1/2/5/8 of dim 32; every stage's K/V reduced to 16x20), then a ragged
#: Lq and a K/V that spills its shared-memory tiles; then UNetRPP's at
#: 512x640 (unetrpp.yaml, batch 1: encoder stages of 128x160 ... 16x20
#: tokens, dims 128/256/512/1024 over 16 heads, K/V projected onto
#: 64/64/64/32 tokens; decoder blocks dims 512/256/128 over 4 heads, 64
#: tokens), and its Dummy call's deepest encoder stage (batch 8 x 16
#: heads, 2x2 tokens: the K/V projection keeps all 4)
ATTENTION_SHAPES = {
    "stage1": (1, 20480, 320, 32),
    "stage2": (2, 5120, 320, 32),
    "stage3": (5, 1280, 320, 32),
    "stage4": (8, 320, 320, 32),
    "ragged": (1, 20481, 320, 32),
    "spill": (2, 2048, 4097, 64),
    "epa_enc1": (16, 20480, 64, 8),
    "epa_enc2": (16, 5120, 64, 16),
    "epa_enc3": (16, 1280, 64, 32),
    "epa_enc4": (16, 320, 32, 64),
    "epa_dec3": (4, 1280, 64, 128),
    "epa_dec2": (4, 5120, 64, 64),
    "epa_dec1": (4, 20480, 64, 32),
    "epa_dummy_enc4": (128, 4, 4, 64),
}
#: UNetRPP's launches a 512x640 model call at each shape: each encoder
#: stage's depth (a stage of depth 0 still holds one block), then one
#: decoder block for each stage but the deepest (as launches_per_call)
_EPA_DEPTHS = [max(1, d) for d in UNETRPP_ARGS["depths"]]
UNETRPP_CALLS = {**{f"epa_enc{i + 1}": d for i, d in enumerate(_EPA_DEPTHS)},
                 **{f"epa_dec{i}": 1 for i in range(len(_EPA_DEPTHS) - 1, 0, -1)}}


def _sdpa(q, k, v, scale):
    """The library's attention on (BH, L, D): one call, a yardstick only."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q[None], k[None], v[None], scale=scale)[0]


def check_attention(rng) -> list:
    """c-fwd and c-bwd against their plain versions at every shape of
    ATTENTION_SHAPES, and each against a second call bit for bit; both
    timed, beside the plain versions and the library, at each; c-fwd's
    launch shape and its kernel's registers, spills and resident blocks,
    c-bwd's for both its kernels. Returns their two entries of the
    kernels line, the stage-1 numbers on top, every shape's under
    "shapes", and c-fwd's sum over one 512x640 model call (each stage
    twice) and c-bwd's over its backward, beside the library's."""
    from py4cast_tpu_torch.ops.attention import (
        bwd_kernel_attributes,
        bwd_launch_shape,
        fused_short_kv_attention,
        fused_short_kv_attention_bwd,
        fwd_kernel_attributes,
        fwd_launch_shape,
        short_kv_attention_bwd_plain,
        short_kv_attention_plain,
    )

    fwd_rows, bwd_rows = [], []
    for label, (bh, lq, lk, d) in ATTENTION_SHAPES.items():
        q, k, v = _rand(rng, bh, lq, d), _rand(rng, bh, lk, d), _rand(rng, bh, lk, d)
        do = _rand(rng, bh, lq, d)
        scale = d ** -0.5
        o, lse = fused_short_kv_attention(q, k, v, scale)
        torch.cuda.synchronize()
        f_err = compare(f"short_kv_attention {label}", o, short_kv_attention_plain(q, k, v, scale))
        lse64 = torch.logsumexp(torch.einsum("bqd,bkd->bqk", q.double(), k.double()) * scale, -1)
        lse_err = compare(f"short_kv_attention {label} lse (fp64)", lse, lse64)
        o2, lse2 = fused_short_kv_attention(q, k, v, scale)
        if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
            raise AssertionError(f"short_kv_attention {label}: a second call differs")
        del lse64, o2, lse2
        rows, splits = fwd_launch_shape(bh, lq, lk, d)
        launch = {"rows": rows, "splits": splits,
                  **fwd_kernel_attributes(d, rows, splits)}
        rows, splits, key_tile, query_splits = bwd_launch_shape(bh, lq, lk, d)
        b_launch = {"rows": rows, "splits": splits, "key_tile": key_tile,
                    "query_splits": query_splits,
                    "dkdv_blocks": -(-lk // key_tile) * query_splits * bh,
                    **bwd_kernel_attributes(d, rows, splits)}
        got = fused_short_kv_attention_bwd(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        plain32 = short_kv_attention_bwd_plain(q, k, v, do, scale)
        plain64 = short_kv_attention_bwd_plain(q.double(), k.double(), v.double(), do.double(),
                                               scale)
        b_err, b_rel = _check_bwd(f"short_kv_attention_bwd {label}", got, plain32, plain64, 1)
        again = fused_short_kv_attention_bwd(q, k, v, o, lse, do, scale)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"short_kv_attention_bwd {label}: a second call differs")
        del plain32, plain64, again

        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_out = _sdpa(ql, kl, vl, scale)
        pairs = bh * lq * lk
        f_bound = bound(4 * (2 * bh * lq * d + 2 * bh * lk * d + bh * lq), pairs * (4 * d + 5))
        # the function's bytes: q, o, dO, dq (Lq x D), lse, k, v, dk, dv
        # (Lk x D), each once; not a design's scratch
        b_bytes = 4 * (4 * bh * lq * d + bh * lq + 4 * bh * lk * d)
        b_bound = bound(b_bytes, pairs * (10 * d + 10))
        common = {"shape": f"q ({bh},{lq},{d}) k,v ({bh},{lk},{d})", "label": label}
        fwd_rows.append({
            **common, "max_abs_err": f_err, "lse_max_abs_err": lse_err, "launch": launch,
            "ms": time_ms(lambda: fused_short_kv_attention(q, k, v, scale)),
            "plain_ms": time_ms(lambda: short_kv_attention_plain(q, k, v, scale)),
            "library_ms": time_ms(lambda: _sdpa(q, k, v, scale)),
            "library_fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
                _sdpa(ql, kl, vl, scale), (ql, kl, vl), do)),
            "bound_ms": f_bound[0], "bound_by": f_bound[1],
        })
        bwd_rows.append({
            **common, "max_abs_err": b_err, "max_err_over_scale": b_rel, "launch": b_launch,
            "ms": time_ms(lambda: fused_short_kv_attention_bwd(q, k, v, o, lse, do, scale)),
            "plain_ms": time_ms(lambda: short_kv_attention_bwd_plain(q, k, v, do, scale)),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                lib_out, (ql, kl, vl), do, retain_graph=True)),
            "bound_ms": b_bound[0], "bound_by": b_bound[1],
        })
        bwd_rows[-1]["share_of_bound"] = b_bound[0] / bwd_rows[-1]["ms"]
        del ql, kl, vl, lib_out

    entries = []
    for name, rows in (("short_kv_attention", fwd_rows), ("short_kv_attention_bwd", bwd_rows)):
        top = rows[0]  # stage 1, the largest call of the main path
        entries.append({
            "name": name, "route": "cuda", "source": f"py4cast_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name][0], "replaces_function": REPLACES[name][1],
            "shape": top["shape"], "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": top["ms"], "kernel_ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
            "library_ms": top["library_ms"],
            "library": ("F.scaled_dot_product_attention, fp32, TF32 off"
                        + (" (its backward: autograd.grad)" if name.endswith("_bwd") else "")),
            "shapes": rows,
        })
    stages = [r for r in fwd_rows if r["label"].startswith("stage")]
    entries[0]["model_call_ms"] = 2 * sum(r["ms"] for r in stages)
    entries[0]["model_call_library_ms"] = 2 * sum(r["library_ms"] for r in stages)
    stages = [r for r in bwd_rows if r["label"].startswith("stage")]
    entries[1]["model_backward_ms"] = 2 * sum(r["ms"] for r in stages)
    entries[1]["model_backward_library_ms"] = 2 * sum(r["library_ms"] for r in stages)
    entries[1]["model_backward_bound_ms"] = 2 * sum(r["bound_ms"] for r in stages)
    for entry, rows, key in ((entries[0], fwd_rows, "unetrpp_model_call"),
                             (entries[1], bwd_rows, "unetrpp_model_backward")):
        epa = [r for r in rows if r["label"] in UNETRPP_CALLS]
        for what in ("ms", "library_ms", "bound_ms"):
            entry[f"{key}_{what}"] = sum(UNETRPP_CALLS[r["label"]] * r[what] for r in epa)
        entry["slower_than_library"] = [r["label"] for r in rows if r["ms"] > r["library_ms"]]
    return entries


# ------------------------------------------------------------------- phase 4
def _wrappers() -> dict:
    from py4cast_tpu_torch.testing import kernel_wrappers

    return kernel_wrappers()


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def model_settings(name: str, overrides=None, **kw):
    """The TrainingSettings of ``name`` at its config's width, with
    ``overrides`` of its settings_init_args."""
    from py4cast_tpu_torch.training import TrainingSettings

    return TrainingSettings(model_name=name,
                            settings_init_args={**MODEL_ARGS[name], **(overrides or {})},
                            training_strategy="diff_ar", **kw)


def launches_per_call(module) -> tuple:
    """({kernel: launches} of one model forward, and of one backward)."""
    name, ms = module.settings.model_name, module.model_settings
    if name in ("SwinUNetR", "Identity") or not getattr(ms, "use_lattice", True):
        return {}, {}  # window attention, a Dense, the table path's gathers: no hand kernel
    if name == "GraphLAM":  # one stencil stage a mesh level a layer
        per = ms.mesh_levels * ms.processor_layers
        return ({"stencil_message": per, "corner_hop": 1},
                {"stencil_message_bwd": per, "corner_hop_bwd": 1})
    if name == "HiLAM":  # intra_up_{1..L-1} and intra_down_{L-2..0} a layer
        per = 2 * (ms.mesh_levels - 1) * ms.processor_layers
        return ({"stencil_message": per, "corner_hop": 1},
                {"stencil_message_bwd": per, "corner_hop_bwd": 1})
    if name == "HiLAMParallel":  # intra_{0..L-1} a layer
        L, layers = ms.mesh_levels, ms.processor_layers
        # backward: only the stages whose outputs reach the loss; the j-th
        # layer from the end reaches level 0 from levels 0..j-1 alone
        return ({"stencil_message": L * layers, "corner_hop": 1},
                {"stencil_message_bwd": sum(min(j, L) for j in range(1, layers + 1)),
                 "corner_hop_bwd": 1})
    if name == "Segformer":  # one attention a MiT layer
        per = len(ms.dims) * ms.num_layers
        return {"short_kv_attention": per}, {"short_kv_attention_bwd": per}
    if name in ("HalfUNet", "UNet", *RESNET_YAMLS):  # cuDNN's convolutions: no hand kernel
        return {}, {}
    if name == "UNetRPP":  # one attention an EPA block, on the kernels or not
        if ms.attention_code not in ("flash_attn", "pallas"):
            return {}, {}
        per = sum(max(1, d) for d in ms.depths) + len(ms.depths) - 1
        return {"short_kv_attention": per}, {"short_kv_attention_bwd": per}
    raise ValueError(f"no launch counts for model {name!r}")


def expected_launches(module, forwards: int, backwards: int) -> dict:
    """Every kernel's count after ``forwards`` model calls and
    ``backwards`` backward passes: 0 for the kernels of other models."""
    fwd, bwd = launches_per_call(module)
    want = {name: 0 for name in _wrappers()}
    want.update({k: v * forwards for k, v in fwd.items()})
    want.update({k: v * backwards for k, v in bwd.items()})
    return want


def predict_dummy(settings, keep=None) -> dict:
    """Trainer.predict on Dummy, counted, its first batch against the
    same module on the CPU (fp32: within TOL; under bf16 phase 17 holds
    them to its own bar). ``keep`` (a dict) receives both first-batch
    predictions as host arrays."""
    from py4cast_tpu_torch.datasets import get_datasets
    from py4cast_tpu_torch.training import AutoRegressiveModule, Trainer, TrainerConfig

    _, _, test_ds = get_datasets("dummy", 2, 1, 3)
    module = AutoRegressiveModule(settings, test_ds.dataset_info, device="cuda")
    state = module.init_params(torch.Generator().manual_seed(0))
    trainer = Trainer(TrainerConfig(batch_size=8, device="cuda"))

    reset_counts()
    t0 = time.perf_counter()
    preds = trainer.predict(module, test_ds, state)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()

    steps = 3
    forwards = len(preds) * steps
    want = expected_launches(module, forwards, 0)
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    spatial = (64 * 64,) if module.is_graph else (64, 64)
    for p in preds:
        finite = bool(np.isfinite(p.array).all())
        if p.shape[1:] != (steps, *spatial, 1) or not finite:
            raise AssertionError(f"bad predictions: shape {p.shape}, finite={finite}")

    # the CPU predicts the first batch of 8 alone (the card's counts cover all)
    first = {id(s) for s in test_ds.sample_list[:8]}
    cpu_module = AutoRegressiveModule(settings, test_ds.dataset_info, device="cpu")
    cpu_preds = Trainer(TrainerConfig(batch_size=8, device="cpu")).predict(
        cpu_module, test_ds.filter_samples(lambda s: id(s) in first),
        {k: v.cpu() for k, v in state.items()}
    )
    held = [p.array for p in preds[:len(cpu_preds)]]
    if keep is not None:
        keep.update(card=held, cpu=[c.array for c in cpu_preds])
    if module.compute_dtype != torch.float32:
        err = max_abs_diff(held, [c.array for c in cpu_preds])
    else:
        err = max(
            compare("predict (cuda vs cpu)", torch.from_numpy(g), torch.from_numpy(c.array))
            for g, c in zip(held, cpu_preds)
        )
    return {"model": settings.model_name, "precision": settings.precision, "launches": counts,
            "forwards": forwards, "batches": len(preds), "batches_vs_cpu": len(cpu_preds),
            "seconds": seconds, "max_abs_err_vs_cpu": err}


# ------------------------------------------------------------------- phase 5
def full_size_rollout(name: str = "GraphLAM", steps: int = 3, grid=(500, 500),
                      profile_name: str = "smoke_profile.txt", keep=None,
                      precision: str = "32", overrides=None) -> dict:
    """A graph model at its config's width on bench.py's GNN cell: a
    3-step predict at batch 1, counted, timed, profiled; step 1 against
    the CPU (under bf16: its distance from the card's fp32 step 1, see
    ``step1_against``); ``overrides`` of its settings_init_args (phase
    19: the table path). ``keep`` (a dict) receives the dataset info, and
    the predictions and the batch's targets on the host (so they hold no
    card memory in the phases between), for phase 14."""
    from py4cast_tpu_torch.testing import synthetic_batch, synthetic_dataset_info
    from py4cast_tpu_torch.training import AutoRegressiveModule

    # bench.py's GNN cell: 500x500 grid, 21 weather and 21 forcing features
    info = synthetic_dataset_info(grid_shape=grid, weather_features=21, forcing_features=21)
    settings = model_settings(name, overrides, precision=precision)
    t0 = time.perf_counter()
    module = AutoRegressiveModule(settings, info, device="cuda")
    build_s = time.perf_counter() - t0
    state = module.init_params(torch.Generator().manual_seed(0))
    batch = synthetic_batch(info, batch_size=1, num_input_steps=2, num_pred_steps=steps, seed=0)

    module.predict_step(state, batch)  # warm-up: allocator, kernels' first launch
    torch.cuda.synchronize()
    reset_counts()
    module.predict_step(state, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != expected_launches(module, steps, 0):
        raise AssertionError(f"{name} {grid} predict launches {counts}")
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        preds = module.predict_step(state, batch)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3 / steps)
    peak = torch.cuda.max_memory_allocated()
    arr = preds.array
    if arr.shape != (1, steps, grid[0] * grid[1], 21) or not bool(torch.isfinite(arr).all()):
        raise AssertionError(f"full-size predictions: shape {tuple(arr.shape)} or non-finite")
    if keep is not None:
        keep.update(info=info, preds=arr.cpu(), targets=batch.outputs.array)

    profile = profile_step(lambda: module.predict_step(state, batch), profile_name)
    call_ms = float(np.median(runs)) * steps
    profile["device_idle_share"] = max(0.0, 1.0 - profile["device_busy_ms"] / call_ms)

    one = synthetic_batch(info, batch_size=1, num_input_steps=2, num_pred_steps=1, seed=0)
    err = step1_against(module, settings, info, state, one, f"{name} full-size")
    return {"model": name, "precision": precision, "overrides": overrides or {},
            "grid": list(grid), "batch": 1,
            "steps": steps, "graph_build_s": build_s, "launches": counts,
            "ms_per_step_runs": runs, "ms_per_step": float(np.median(runs)),
            "peak_mem_bytes": peak, **err, "profile": profile}


def step1_against(module, settings, info, params, one, what) -> dict:
    """Step 1 on the card against the CPU module with the same weights
    (plain path), within TOL. Under bf16 against the card's fp32 module
    instead, recorded, not held to a bar: a full-size CPU run in bf16
    costs minutes, and phase 17's Dummy runs hold bf16 to the CPU."""
    from py4cast_tpu_torch.training import AutoRegressiveModule

    gpu1 = module.predict_step(params, one).array.cpu()
    if module.compute_dtype == torch.float32:
        cpu_module = AutoRegressiveModule(settings, info, device="cpu")
        cpu1 = cpu_module.predict_step({k: v.cpu() for k, v in params.items()}, one).array
        return {"max_abs_err_step1_vs_cpu": compare(f"{what} step 1 (cuda vs cpu)", gpu1, cpu1)}
    fp32 = AutoRegressiveModule(dataclasses.replace(settings, precision="32"), info,
                                device="cuda")
    ref = fp32.predict_step(params, one).array.cpu()
    if not bool(torch.isfinite(gpu1).all()):
        raise AssertionError(f"{what} bf16 step 1 is not finite")
    return {"max_abs_diff_step1_vs_fp32": float((gpu1 - ref).abs().max()),
            "scale_step1": float(ref.abs().max())}


#: how the profile's device activities are grouped in the report
GROUPS = (
    ("corner_hop kernel", ("corner_hop_fwd",)),
    ("stencil_message kernel", ("stencil_message_fwd",)),
    ("corner_hop_bwd kernel", ("corner_hop_bwd",)),
    ("stencil_message_bwd kernel", ("stencil_message_bwd",)),
    ("short_kv_attention kernel", ("short_kv_attention_fwd",)),
    # c-bwd's dq pass, dK/dV pass and split sum (short_kv_attention_bwd_dq,
    # _dkdv, _sum) all fall here
    ("short_kv_attention_bwd kernel", ("short_kv_attention_bwd",)),
    ("weight-gradient partial sums", ("sum_partials",)),
    ("AdamW (foreach)", ("multi_tensor_apply",)),
    ("host-to-device batch copy", ("Memcpy HtoD",)),
    ("layer_norm (torch)", ("layer_norm",)),
    ("group_norm (torch)", ("group_norm", "GroupNorm", "RowwiseMoments",
                            "ComputeFusedParams", "ComputeInternalGradients",
                            "ComputeBackwardFusedParams")),
    ("max_pool (torch)", ("max_pool",)),
    ("softmax (torch)", ("softmax",)),
    ("bilinear resize (torch)", ("upsample_bilinear",)),
    ("convolutions (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "cudnn")),
    ("matmuls (cuBLAS/CUTLASS)", ("gemm",)),
    # .contiguous() copies and .to(dtype) casts (the bf16 boundaries)
    ("copies and dtype casts", ("copy_kernel",)),
)


def profile_step(step, out_name: str) -> dict:
    """Device time over one call of ``step`` (torch.profiler), from the
    device activities only (kernels and copies), summed by group, and
    the count of those activities. The full table goes to
    chiprun_out/<out_name>."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    # device activities only: not the profiler's buffer requests, and not
    # the GPU ranges of the optimizer's record_function annotations
    # (Optimizer.step#AdamW.step), which span kernels already counted
    rows = sorted(
        ((float(e.self_device_time_total), e.key, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and "Activity Buffer" not in e.key
         and not e.key.startswith("Optimizer.")),
        reverse=True,
    )
    busy_ms = sum(r[0] for r in rows) / 1e3
    groups = {name: 0.0 for name, _ in GROUPS}
    groups["other"] = 0.0
    for us, key, _ in rows:
        name = next((g for g, pats in GROUPS if any(p in key for p in pats)), "other")
        groups[name] += us / 1e3
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / out_name).write_text(
        "\n".join(f"{us / 1e3:10.3f} ms  x{n:<5d} {key}" for us, key, n in rows if us > 0)
    )
    return {"device_busy_ms": busy_ms, "device_activities": sum(n for _, _, n in rows),
            "groups_ms": groups,
            "top": [{"kernel": k[:80], "ms": us / 1e3, "calls": n} for us, k, n in rows[:8]]}


# ------------------------------------------------------------------- phase 6
class _ListLogger:
    """Keeps what the trainer logs: scalars, and the tags of figures."""

    def __init__(self):
        self.rows = []
        self.figures = []

    def log_scalar(self, tag, value, step):
        self.rows.append((tag, float(value), step))

    def log_figure(self, tag, fig, step):
        self.figures.append((tag, step))


def train_dummy(name: str, overrides=None, precision: str = "32", losses=None,
                resume: bool = True) -> dict:
    """Trainer.fit on Dummy (3 train batches, 1 val batch) with model
    ``name`` (``overrides`` of its settings_init_args; ``losses`` in place
    of the default WeightedLoss), counted; resume (unless ``resume`` is
    False: phase 17's bf16 fits, whose resume the fp32 fits cover);
    Trainer.test; one step's gradients against the CPU. Under bf16 the
    masters and AdamW's moments must stay fp32, and the card's gradients
    are held over the whole vector to twice the CPU's own bf16 error:
    |g_card - g_cpu| <= 2 |g_cpu - g_cpu_fp32|."""
    import shutil

    from py4cast_tpu_torch.datasets import get_datasets
    from py4cast_tpu_torch.training import AutoRegressiveModule, Trainer, TrainerConfig

    # 1 AR step in training, 3 in validation and test, linked into the
    # settings as the CLI links them
    train_ds, val_ds, test_ds = get_datasets("dummy", 2, 1, 3)
    settings = model_settings(name, overrides, num_warmup_steps=2, num_pred_steps_train=1,
                              num_pred_steps_val_test=3, precision=precision,
                              **({"losses": losses} if losses else {}))
    suffix = ("" if precision == "32" else f"_{precision}") + ("_losses" if losses else "")
    save = BUILD / f"smoke_fit_{settings.model_name.lower()}{suffix}"
    shutil.rmtree(save, ignore_errors=True)
    module = AutoRegressiveModule(settings, train_ds.dataset_info, device="cuda")
    log = _ListLogger()
    cfg = TrainerConfig(max_epochs=1, batch_size=8, limit_train_batches=3, limit_val_batches=1,
                        save_path=str(save), log_every_n_steps=1, device="cuda")
    trainer = Trainer(cfg, loggers=[log])

    reset_counts()
    t0 = time.perf_counter()
    state = trainer.fit(module, train_ds, val_ds)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()

    train_steps, val_forwards = 3, 1 * settings.num_pred_steps_val_test
    forwards = train_steps * settings.num_pred_steps_train + val_forwards
    backwards = train_steps * settings.num_pred_steps_train
    want = expected_launches(module, forwards, backwards)
    if counts != want:
        raise AssertionError(f"fit kernel launches {counts}, expected {want}")
    losses = [v for tag, v, _ in log.rows if tag == "train/loss"]
    if len(losses) != train_steps or not np.isfinite(losses).all() or len(set(losses)) < 2:
        raise AssertionError(f"train losses {losses}: not {train_steps} finite, changing values")
    ckpt = save / "checkpoints"
    if not ((ckpt / "last" / "state.pt").is_file() and (ckpt / "manifest.json").is_file()):
        raise AssertionError(f"fit wrote no last checkpoint or manifest under {ckpt}")
    # _log_model: a torch.export program for a grid model, none for a graph model
    program = save / "model" / "forward.pt2"
    if program.is_file() == module.is_graph:
        raise AssertionError(f"fit of {name}: model/forward.pt2 "
                             f"{'written' if module.is_graph else 'missing'}")
    if state.step != train_steps:
        raise AssertionError(f"fit took {state.step} optimizer steps, expected {train_steps}")

    resumed = state
    if resume:
        resumed = trainer.fit(module, train_ds, val_ds, ckpt_path=str(ckpt / "last"))
        if resumed.step != 2 * train_steps:
            raise AssertionError(f"resume ended at step {resumed.step}, "
                                 f"expected {2 * train_steps}")
    scores = trainer.test(module, test_ds, resumed)
    if not scores or not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"test scores {scores}")

    # one train step's gradients on the card and on the CPU, same params
    params = {k: v.detach().cpu() for k, v in state.params.items()}
    batch = next(iter(train_ds.loader(batch_size=8, num_workers=1)))
    loss_gpu, grads_gpu = module.loss_and_grads(params, batch)
    cpu_module = AutoRegressiveModule(settings, train_ds.dataset_info, device="cpu")
    loss_cpu, grads_cpu = cpu_module.loss_and_grads(params, batch)
    loss_rel = abs(float(loss_gpu) - float(loss_cpu)) / abs(float(loss_cpu))
    extra = {}
    if precision == "32":
        if not loss_rel <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"train loss card {float(loss_gpu)} vs cpu {float(loss_cpu)}")
        grad_err = max(compare(f"grad {k} (cuda vs cpu)", grads_gpu[k].cpu(), grads_cpu[k],
                               TRAIN_GRAD_TOL) for k in grads_cpu)
    else:
        masters = list(resumed.params.values())
        moments = [v for p in masters for v in resumed.optimizer.state[p].values()
                   if torch.is_tensor(v) and v.is_floating_point()]
        if {t.dtype for t in masters + moments} != {torch.float32}:
            raise AssertionError("bf16 fit: masters or AdamW moments are not fp32")
        fp32_module = AutoRegressiveModule(dataclasses.replace(settings, precision="32"),
                                           train_ds.dataset_info, device="cpu")
        _, grads_cpu32 = fp32_module.loss_and_grads(params, batch)

        def norm(d):
            return float(torch.sqrt(sum((v.double() ** 2).sum() for v in d.values())))

        grad_err = norm({k: grads_gpu[k].cpu() - grads_cpu[k] for k in grads_cpu})
        own = norm({k: grads_cpu[k] - grads_cpu32[k] for k in grads_cpu})
        if not grad_err <= 2 * own:
            raise AssertionError(f"bf16 gradients: |card - cpu| {grad_err:.3e} > 2 x "
                                 f"|cpu bf16 - cpu fp32| {own:.3e}")
        extra = {"grad_l2_card_vs_cpu": grad_err, "grad_l2_cpu_bf16_vs_fp32": own,
                 "grad_l2": norm(grads_cpu32)}
    zero = [k for k, g in grads_gpu.items() if float(g.abs().max()) == 0.0]
    # HiLAMParallel's last layers cannot reach level 0 from the levels
    # above: those parameters get zero gradients on both devices, as
    # jax.grad gives them; every other model must move every parameter
    unreached = ([k for k in zero if float(grads_cpu[k].abs().max()) == 0.0]
                 if name == "HiLAMParallel" else [])
    if len(zero) > len(unreached):
        raise AssertionError(f"parameters with no gradient on the card: "
                             f"{[k for k in zero if k not in unreached][:5]}")
    return {"model": name, "precision": precision, "launches": counts,
            "train_steps": train_steps, "val_forwards": val_forwards, "seconds": seconds,
            "train_losses": losses, "resumed_step": resumed.step,
            "test_scores": scores, "loss_cuda": float(loss_gpu), "loss_cpu": float(loss_cpu),
            "loss_rel_diff": loss_rel, "max_abs_grad_err_vs_cpu": grad_err,
            "unreached_params": len(unreached), **extra}


#: what the CLI runs in cli_dummy: the fit's 2 train batches (1 AR step
#: each) and 1 validation batch (3 steps, trainer.yaml), then test and
#: predict over Dummy's test set (3 steps)
CLI_STEPS = {
    "fit": ["--trainer.max_epochs", "1", "--trainer.limit_train_batches", "2",
            "--trainer.limit_val_batches", "1"],
    "test": ["--trainer.ckpt_path", "last"],
    "predict": ["--trainer.ckpt_path", "last"],
}


def cli_launches(model: str, args: dict, sub: str) -> dict:
    """Every kernel's count after one CLI subcommand of cli_dummy on
    Dummy with model ``model`` at settings_init_args ``args``."""
    from types import SimpleNamespace

    from py4cast_tpu_torch.datasets import get_datasets
    from py4cast_tpu_torch.models import get_model_kls_and_settings

    _, ms = get_model_kls_and_settings(model, dict(args))
    module = SimpleNamespace(settings=SimpleNamespace(model_name=model), model_settings=ms)
    test_batches = -(-len(get_datasets("dummy", 2, 1, 3)[2]) // 8)
    calls = {"fit": (2 + 3, 2), "test": (3 * test_batches, 0),
             "predict": (3 * test_batches, 0)}[sub]
    return expected_launches(module, *calls)


def cli_dummy(model_yaml, extra=(), subcommands=tuple(CLI_STEPS), want=None) -> dict:
    """The port's CLI in-process: fit, then test and predict from its
    checkpoint, with config/CLI's trainer and dummy files and the model's
    file (``graphlam``, ``segformer``, ``halfunet``, ``hilam``,
    ``hilamparallel``, ``unet``, ``unetrpp``, ``swinunetr``; None for
    none, the model named in ``extra``) and ``extra`` arguments.
    With ``want`` (a function of the subcommand), each subcommand runs
    with every launch count set to 0 before it and must end on
    ``want(subcommand)``."""
    import shutil

    from py4cast_tpu_torch import cli

    save = BUILD / "_".join(["smoke_cli", model_yaml or "", *extra[1::2]])
    shutil.rmtree(save, ignore_errors=True)
    configs = ["--config", str(ROOT / "config/CLI/trainer.yaml"),
               "--config", str(ROOT / "config/CLI/dataset/dummy.yaml"),
               *(["--config", str(ROOT / f"config/CLI/model/{model_yaml}.yaml")]
                 if model_yaml else []),
               "--trainer.save_path", str(save), *extra]
    launches = {}
    for sub in subcommands:
        reset_counts()
        if cli.main([sub, *configs, *CLI_STEPS[sub]]) != 0:
            raise AssertionError(f"cli {sub} failed")
        launches[sub] = read_counts()
        if want is not None and launches[sub] != want(sub):
            raise AssertionError(f"cli {model_yaml} {sub} launches {launches[sub]}, "
                                 f"expected {want(sub)}")
    if "test" not in subcommands:
        return {"launches": launches}
    scores = json.loads((save / "test_scores.json").read_text())
    preds = sorted((save / "predictions").glob("batch_*.npy"))
    arrays = [np.load(p) for p in preds]
    if not preds or not all(np.isfinite(a).all() for a in arrays) or not np.isfinite(
            scores["test_mean_loss"]):
        raise AssertionError(f"cli outputs: {len(preds)} prediction files, scores {scores}")
    return {"test_mean_loss": scores["test_mean_loss"], "prediction_files": len(preds),
            "prediction_shape": list(arrays[0].shape), "launches": launches}


# ------------------------------------------------------------------- phase 7
def full_size_train_step(name: str = "GraphLAM", grid=(500, 500), reps: int = 5,
                         profile_name: str = "smoke_profile_train.txt",
                         precision: str = "32", overrides=None) -> dict:
    """One AdamW train step (1 AR step, batch 1) of a graph model at its
    config's width (``overrides`` of its settings_init_args) on the GNN
    cell, counted, timed, profiled."""
    from py4cast_tpu_torch.testing import synthetic_batch, synthetic_dataset_info
    from py4cast_tpu_torch.training import AutoRegressiveModule

    info = synthetic_dataset_info(grid_shape=grid, weather_features=21, forcing_features=21)
    module = AutoRegressiveModule(model_settings(name, overrides, num_warmup_steps=2,
                                                 precision=precision), info, device="cuda")
    state = module.init_state(torch.Generator().manual_seed(0), num_training_steps=100)
    batch = synthetic_batch(info, batch_size=1, num_input_steps=2, num_pred_steps=1, seed=0)

    for _ in range(2):  # warm-up: allocator, kernels' first launch, lr 0 step
        module.train_step(state, batch)
    torch.cuda.synchronize()
    reset_counts()
    module.train_step(state, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != expected_launches(module, 1, 1):
        raise AssertionError(f"{name} {grid} train-step launches {counts}")
    torch.cuda.reset_peak_memory_stats()
    runs, losses = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        loss = module.train_step(state, batch)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all():
        raise AssertionError(f"full-size train losses {losses}")
    loss, grads = module.loss_and_grads(state, batch)
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    if bad or not np.isfinite(float(loss)):
        raise AssertionError(f"full-size gradients not finite: {bad[:5]}, loss {float(loss)}")

    profile = profile_step(lambda: module.train_step(state, batch), profile_name)
    step_ms = float(np.median(runs))
    profile["device_idle_share"] = max(0.0, 1.0 - profile["device_busy_ms"] / step_ms)
    return {"model": name, "precision": precision, "overrides": overrides or {},
            "grid": list(grid), "batch": 1,
            "pred_steps": 1, "launches": counts, "ms_per_train_step_runs": runs,
            "ms_per_train_step": step_ms, "peak_mem_bytes": peak, "losses": losses,
            "profile": profile}


# ------------------------------------------------------------------ phase 10
def _timed(fn, reps: int) -> list:
    """Host-clock milliseconds of ``reps`` calls, each ended by a sync."""
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return runs


def grid_model_full_size(name: str = "Segformer", grid=(512, 640), steps: int = 3,
                         reps: int = 5, keep=None, overrides=None, tag=None,
                         precision: str = "32") -> dict:
    """A grid model (Segformer, HalfUNet, UNet, UNetRPP) at its config's
    width (``overrides`` of its settings_init_args) on bench.py's
    Segformer grid (512x640, 21 weather and 21 forcing features), batch
    1: a 3-step predict and a 1-AR-step AdamW train step, counted, timed,
    profiled (chiprun_out/smoke_profile_<tag>*.txt); step 1 against the
    CPU. ``keep`` as in full_size_rollout."""
    from py4cast_tpu_torch.testing import synthetic_batch, synthetic_dataset_info
    from py4cast_tpu_torch.training import AutoRegressiveModule

    info = synthetic_dataset_info(grid_shape=grid, weather_features=21, forcing_features=21)
    settings = model_settings(name, overrides, num_warmup_steps=2, precision=precision)
    tag = tag or name.lower()
    module = AutoRegressiveModule(settings, info, device="cuda")
    params = module.init_params(torch.Generator().manual_seed(0))
    batch = synthetic_batch(info, batch_size=1, num_input_steps=2, num_pred_steps=steps, seed=0)

    # ---- predict
    module.predict_step(params, batch)  # warm-up: allocator, cuDNN's choice, kernels
    torch.cuda.synchronize()
    reset_counts()
    preds = module.predict_step(params, batch)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != expected_launches(module, steps, 0):
        raise AssertionError(f"{name} 512x640 predict launches {counts}")
    arr = preds.array
    if arr.shape != (1, steps, *grid, 21) or not bool(torch.isfinite(arr).all()):
        raise AssertionError(f"{name} 512x640 predictions: shape {tuple(arr.shape)} "
                             "or non-finite")
    if keep is not None:
        keep.update(info=info, preds=arr.cpu(), targets=batch.outputs.array)
    torch.cuda.reset_peak_memory_stats()
    runs = [ms / steps for ms in _timed(lambda: module.predict_step(params, batch), 3)]
    peak = torch.cuda.max_memory_allocated()
    profile = profile_step(lambda: module.predict_step(params, batch),
                           f"smoke_profile_{tag}.txt")
    profile["device_idle_share"] = max(0.0, 1.0 - profile["device_busy_ms"]
                                       / (float(np.median(runs)) * steps))
    one = synthetic_batch(info, batch_size=1, num_input_steps=2, num_pred_steps=1, seed=0)
    err = step1_against(module, settings, info, params, one, f"{name} 512x640")
    predict = {"steps": steps, "launches": counts, "ms_per_step_runs": runs,
               "ms_per_step": float(np.median(runs)), "peak_mem_bytes": peak,
               **err, "profile": profile}
    del preds, arr

    # ---- train
    state = module.init_state(None, num_training_steps=100, params=params)
    for _ in range(2):  # warm-up: allocator, cuDNN's choice, lr-0 step
        module.train_step(state, one)
    torch.cuda.synchronize()
    reset_counts()
    module.train_step(state, one)
    torch.cuda.synchronize()
    t_counts = read_counts()
    if t_counts != expected_launches(module, 1, 1):
        raise AssertionError(f"{name} 512x640 train-step launches {t_counts}")
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t_runs = _timed(lambda: losses.append(float(module.train_step(state, one))), reps)
    t_peak = torch.cuda.max_memory_allocated()
    if not np.isfinite(losses).all():
        raise AssertionError(f"{name} 512x640 train losses {losses}")
    t_profile = profile_step(lambda: module.train_step(state, one),
                             f"smoke_profile_{tag}_train.txt")
    step_ms = float(np.median(t_runs))
    t_profile["device_idle_share"] = max(0.0, 1.0 - t_profile["device_busy_ms"] / step_ms)
    train = {"pred_steps": 1, "launches": t_counts, "ms_per_train_step_runs": t_runs,
             "ms_per_train_step": step_ms, "peak_mem_bytes": t_peak, "losses": losses,
             "profile": t_profile}
    return {"model": name, "precision": precision, "settings": settings.settings_init_args,
            "grid": list(grid), "batch": 1, "params": module.num_params(params),
            "predict": predict, "train": train}


# ------------------------------------------------------------------ phase 14
#: the metrics' bars against an fp64 scipy version of the reference
#: pipeline (tests/test_torch_metrics.py says why each)
PSD_TOL = 1e-5
ACC_TOL = 1e-4
PSD_VAR_LOG10_TOL = 1e-3


def _psd_fp64(x: np.ndarray) -> np.ndarray:
    """The reference PSD pipeline in fp64, independent of the port:
    scipy's orthonormal DCT-II, fx² / W², the batch mean, then the
    'double binning' (each point of radius r adds the flat spectrum at
    2r and half of it at 2r ± 1 to bin r < rmax); (B, C, H, W) → (C, Rmax)."""
    from scipy.fft import dctn

    sig = (dctn(x, type=2, axes=(-2, -1), norm="ortho") ** 2 / x.shape[-1] ** 2).mean(axis=0)
    h, w = sig.shape[-2:]
    y, xx = np.indices((h, w))
    r = np.sqrt((xx - h // 2) ** 2 + (y - w // 2) ** 2).astype(int)
    rmax = min(xx.max(), y.max(), r.max()) // 2
    rr = r.ravel()
    n = h * w
    keep = rr < rmax
    out = []
    for flat in sig.reshape(sig.shape[0], -1):
        val = (flat[np.clip(2 * rr, 0, n - 1)] + 0.5 * flat[np.clip(2 * rr - 1, 0, n - 1)]
               + 0.5 * flat[np.clip(2 * rr + 1, 0, n - 1)])
        out.append(np.bincount(rr[keep], val[keep], minlength=rmax)
                   / np.maximum(np.bincount(rr[keep], minlength=rmax), 1))
    return np.stack(out)


def metrics_full_size(kept: dict, label: str) -> dict:
    """PSD-K, PSD-Var and ACC (as ``make_metrics`` builds them: the PSDs
    at the last of 3 steps) over a full-size phase's predictions against
    its batch's targets, on the card: against fp64 scipy/numpy, a second
    update bit for bit, no host sync inside an update, the state on the
    card, the device ms of one update (all three) by CUDA events beside
    its bound, and a profile of one update."""
    import warnings

    from py4cast_tpu_torch.metrics import MetricACC, MetricPSDK, MetricPSDVar

    info = kept["info"]
    preds = kept["preds"].to("cuda")
    targets = torch.from_numpy(kept["targets"]).to("cuda").reshape(preds.shape)
    mask = torch.ones_like(preds)
    b, steps, nfeat = preds.shape[0], preds.shape[1], preds.shape[-1]
    grid = tuple(info.statics.grid_shape)
    names = info.output_feature_names
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # ACC's note on scalar climate normals
        metrics = {
            "psd_k": MetricPSDK(BUILD / f"smoke_metrics_{label}", names, grid,
                                pred_step=steps - 1, device="cuda"),
            "psd_var": MetricPSDVar(names, grid, pred_step=steps - 1, device="cuda"),
            "acc": MetricACC(info, steps, device="cuda"),
        }

    def update_all(states):
        return {k: m.update(states[k], preds, targets, mask) for k, m in metrics.items()}

    def fresh():
        return {k: m.init_state() for k, m in metrics.items()}

    first = update_all(fresh())  # builds the DCT matrices and bin tables once
    start = fresh()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            second = update_all(start)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [str(w.message)[:120] for w in caught if "synchroniz" in str(w.message).lower()]
    if syncs:
        raise AssertionError(f"{label}: a metrics update synchronized the host: {syncs}")
    on_card = {v.device.type for st in second.values() for v in st.values()}
    if on_card != {"cuda"}:
        raise AssertionError(f"{label}: metric state on {on_card}, not the card")
    repeat = all(torch.equal(first[k][n], second[k][n]) for k in first for n in first[k])
    if not repeat:
        raise AssertionError(f"{label}: a second metrics update differs from the first")

    # fp64 references of the same pipeline
    def bchw64(t):
        x = t[:, steps - 1].double().cpu().numpy()
        return np.moveaxis(x.reshape(b, grid[0], grid[1], nfeat), -1, 1)

    psd_p, psd_t = _psd_fp64(bchw64(preds)), _psd_fp64(bchw64(targets))
    k_state = second["psd_k"]
    errs = {}
    for key, want in (("sum_psd_pred", psd_p), ("sum_psd_target", psd_t)):
        got = k_state[key].double().cpu().numpy()
        errs[key] = float(np.abs(got - want).max() / np.abs(want).max())
        if not errs[key] <= PSD_TOL:
            raise AssertionError(f"{label} PSD-K {key}: {errs[key]:.3e} of scale > {PSD_TOL}")
    var = metrics["psd_var"].compute(second["psd_var"], "test")
    eps = 1e-12
    var_ref = np.sqrt(np.mean((np.log10(psd_t + eps) - np.log10(psd_p + eps)) ** 2, axis=1))
    errs["psd_var_log10"] = max(float(abs(var[f"test_rmse_psd/{n}"] - var_ref[i]))
                                for i, n in enumerate(metrics["psd_var"].feature_names))
    if not errs["psd_var_log10"] <= PSD_VAR_LOG10_TOL:
        raise AssertionError(f"{label} PSD-Var: {errs['psd_var_log10']:.3e} log10")
    acc = metrics["acc"].compute(second["acc"], "test")
    means = metrics["acc"].climate_means.double().cpu().numpy()
    p64, t64 = preds.double().cpu().numpy(), targets.double().cpu().numpy()
    sp = tuple(range(2, p64.ndim - 1))
    pa, ta = p64 - means, t64 - means
    acc_ref = ((pa * ta).mean(sp) / np.sqrt((pa**2).mean(sp) * (ta**2).mean(sp) + 1e-12)).mean(0)
    errs["acc"] = max(float(abs(acc[f"test_acc/{n}_step{j}"] - acc_ref[j, i]))
                      for i, n in enumerate(metrics["acc"].feature_names) for j in range(steps))
    if not errs["acc"] <= ACC_TOL:
        raise AssertionError(f"{label} ACC: {errs['acc']:.3e} > {ACC_TOL}")

    ms = time_ms(lambda: update_all(start))
    profile = profile_step(lambda: update_all(start), f"smoke_profile_metrics_{label}.txt")
    h, w = grid
    images = 4 * b * nfeat  # PSD-K and PSD-Var each transform pred and target
    flops = images * (2 * h * h * w + 2 * h * w * w)
    bound_ms, bound_by = bound(3 * preds.numel() * 4, flops)
    return {"label": label, "shape": list(preds.shape), "grid": list(grid),
            "update_ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms, "dct_gflop": flops / 1e9,
            "max_err": errs, "bit_for_bit": repeat, "host_syncs": len(syncs),
            "profile": profile,
            "psd_var": [float(v) for v in var.values()][:3],
            "acc_step0": [float(acc_ref[0, i]) for i in range(3)]}


def test_with_logging(name: str) -> dict:
    """Trainer.test on Dummy with logging on (score cards, spatial error,
    prediction maps, PSD-K, PSD-Var, ACC): exact launch counts, the
    PSD-Var and ACC entries finite and within 1e-4 of the same module's
    on the CPU; the host ms a test batch with logging on and off."""
    import math

    from py4cast_tpu_torch.datasets import get_datasets
    from py4cast_tpu_torch.plots import can_draw
    from py4cast_tpu_torch.training import AutoRegressiveModule, Trainer, TrainerConfig

    _, _, test_ds = get_datasets("dummy", 2, 1, 3)
    settings = model_settings(name, num_pred_steps_val_test=3)
    module = AutoRegressiveModule(settings, test_ds.dataset_info, device="cuda")
    params = module.init_params(torch.Generator().manual_seed(0))
    cpu_module = AutoRegressiveModule(settings, test_ds.dataset_info, device="cpu")
    save = BUILD / f"smoke_test_{name.lower()}"

    def run(logging: bool, device: str = "cuda"):
        trainer = Trainer(TrainerConfig(batch_size=8, num_workers=1, device=device,
                                        logging_enabled=logging,
                                        save_path=str(save / f"{device}_{logging}")),
                          loggers=[_ListLogger()])
        m, p = (module, params) if device == "cuda" else (
            cpu_module, {k: v.cpu() for k, v in params.items()})
        t0 = time.perf_counter()
        scores = trainer.test(m, test_ds, p)
        if device == "cuda":
            torch.cuda.synchronize()
        return scores, time.perf_counter() - t0

    run(True)  # warm-up: allocator, kernels, DCT matrices, bin tables, figures
    reset_counts()
    scores, _ = run(True)
    counts = read_counts()
    batches = math.ceil(len(test_ds) / 8)
    want = expected_launches(module, batches * settings.num_pred_steps_val_test, 0)
    if counts != want:
        raise AssertionError(f"{name} test (logging on) launches {counts}, expected {want}")
    feat = test_ds.dataset_info.output_feature_names[0]
    keys = [f"test_rmse_psd/{feat}"] + [f"test_acc/{feat}_step{j}" for j in range(3)]
    if not all(k in scores and np.isfinite(scores[k]) for k in keys):
        raise AssertionError(f"{name} test scores lack finite PSD-Var/ACC entries: {scores}")
    cpu_scores, _ = run(True, "cpu")
    if set(cpu_scores) != set(scores):
        raise AssertionError(f"{name} test score keys card {sorted(scores)} vs cpu")
    err = max(abs(scores[k] - cpu_scores[k]) / max(1.0, abs(cpu_scores[k])) for k in scores)
    if not err <= TOL:
        raise AssertionError(f"{name} test scores card vs cpu: {err:.3e} > {TOL}")
    # (off, on, on, off) four times: the host ms a batch, logging off and on
    times = {False: [], True: []}
    for logging in (False, True, True, False) * 4:
        times[logging].append(run(logging)[1] * 1e3 / batches)
    off, on = float(np.median(times[False])), float(np.median(times[True]))
    return {"model": name, "launches": counts, "batches": batches, "figures": can_draw(),
            "scores": {k: scores[k] for k in keys}, "max_rel_err_vs_cpu": err,
            "ms_per_batch_logging_off": times[False], "ms_per_batch_logging_on": times[True],
            "logging_overhead_ms_per_batch": on - off}


def cli_predict_gribs() -> dict:
    """The CLI's predict with data.save_gribs on phase 6's GraphLAM run,
    against a template make_template built for Dummy's grid: counted;
    every GRIB field read back equals the .npy predictions (graph layout,
    put back on the grid) within the simple packing's quantum."""
    import shutil

    from py4cast_tpu_torch import cli
    from py4cast_tpu_torch.datasets import get_datasets
    from py4cast_tpu_torch.io import grib2, outputs

    test_ds = get_datasets("dummy", 2, 1, 3)[2]
    grid, names = test_ds.grid, test_ds.dataset_info.output_feature_names
    out = BUILD / "smoke_gribs"
    shutil.rmtree(out, ignore_errors=True)
    template = grib2.make_template(out / "template.grib", grid.lat[:, 0], grid.lon[0],
                                   outputs.template_fids_for_features(names))
    conf = out / "io.json"
    conf.write_text(json.dumps({
        "template_grib": str(template), "directory": str(out / "gribs"),
        "output_kwargs": ["dummy"], "sample_identifiers": ["date", "sample", "leadtime"],
        "path_to_runtime": "{}/{}_{}_+{}h.grib"}))
    run = BUILD / "smoke_cli_graphlam"
    args = ["predict", "--config", str(ROOT / "config/CLI/trainer.yaml"),
            "--config", str(ROOT / "config/CLI/dataset/dummy.yaml"),
            "--config", str(ROOT / "config/CLI/model/graphlam.yaml"),
            "--trainer.save_path", str(run), "--trainer.ckpt_path", "last",
            "--data.save_gribs", "true", "--model.io_conf", str(conf)]
    reset_counts()
    t0 = time.perf_counter()
    if cli.main(args) != 0:
        raise AssertionError("cli predict --data.save_gribs true failed")
    seconds = time.perf_counter() - t0
    counts = read_counts()
    preds = np.concatenate([np.load(p) for p in sorted((run / "predictions").glob("batch_*.npy"))])
    n, steps = preds.shape[:2]
    want = cli_launches("GraphLAM", GRAPHLAM_ARGS, "predict")
    if counts != want:
        raise AssertionError(f"cli predict launches {counts}, expected {want}")
    preds = preds.reshape(n, steps, grid.x, grid.y)
    files, worst = 0, 0.0
    for i, sample in enumerate(test_ds.sample_list):
        date = sample.timestamps.datetime.strftime("%Y%m%d%H")
        for t in range(steps):
            path = out / "gribs" / "dummy" / f"{date}_b{i // 8}_s{i % 8}_+{t + 1}h.grib"
            (field,) = grib2.read_grib2(path)
            want_t = preds[i, t]
            quantum = 2 * (want_t.max() - want_t.min()) / (2**16 - 1)
            err = float(np.abs(np.asarray(field.values) - want_t).max())
            if not err <= quantum:
                raise AssertionError(f"{path.name}: read back {err:.3e} from the .npy "
                                     f"(quantum {quantum:.3e})")
            worst = max(worst, float(err / quantum))
            files += 1
    return {"launches": counts, "samples": n, "grib_files": files, "seconds": seconds,
            "max_err_in_quanta": worst}


# ------------------------------------------------------------------ phase 17
#: one bf16 ulp, relative: bf16 keeps 8 significant bits
BF16_ULP = 2.0 ** -7


def within_ulp(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """A bf16 output against its reference, rounded to bf16 at the same
    point: the same dtype, and elementwise within one bf16 ulp (|got -
    want| <= 2^-7 |want| + 2^-7 1e-3 max|want|). Returns the largest
    |got - want|."""
    if got.dtype != want.dtype:
        raise AssertionError(f"{name}: dtype {got.dtype}, expected {want.dtype}")
    g, w = got.double(), want.double()
    diff = (g - w).abs()
    slack = BF16_ULP * w.abs() + BF16_ULP * 1e-3 * float(w.abs().max())
    if not bool(torch.isfinite(g).all()) or bool((diff > slack).any()):
        worst = float((diff - slack).max())
        raise AssertionError(f"{name}: more than one bf16 ulp from the reference "
                             f"(worst excess {worst:.3e})")
    return float(diff.max())


def _bf16(ts):
    """Float tensors rounded to bf16; the int32 corner maps as they are."""
    return [t.to(torch.bfloat16) if t.is_floating_point() else t for t in ts]


def _fp32(ts):
    return [t.float() if t.is_floating_point() else t for t in ts]


def bf16_boundary(name, shape, call, plain, args16, n_rounded, want_dtypes) -> dict:
    """One kernel wrapper on bf16 inputs: ``call(args)`` (the wrapper)
    and ``plain(args)`` (its plain version) return tuples. The first
    ``n_rounded`` outputs are held within one bf16 ulp of the plain
    version run in fp32 on the same bf16 values and rounded to the
    wrapper's output dtypes (``want_dtypes``); the rest (weight gradients,
    fp32 as the TPU kernel's) against the plain version in fp64 at
    GRAD_TOL. A second call must repeat bit for bit. Times: the wrapper
    on the bf16 inputs, on their fp32 copies, and the boundary casts
    alone (the inputs to fp32, the rounded outputs from it)."""
    args32 = _fp32(args16)
    got = call(args16)
    torch.cuda.synchronize()
    if [g.dtype for g in got] != list(want_dtypes):
        raise AssertionError(f"{name} bf16: output dtypes {[g.dtype for g in got]}, "
                             f"expected {list(want_dtypes)}")
    ref = plain(args32)
    err = max(within_ulp(f"{name} bf16 output {i}", g, r.to(g.dtype))
              for i, (g, r) in enumerate(zip(got[:n_rounded], ref[:n_rounded])))
    if len(got) > n_rounded:
        ref64 = plain([t.double() if t.is_floating_point() else t for t in args32])
        err_w = max(compare(f"{name} bf16 weight grad {i}", g, r, GRAD_TOL)
                    for i, (g, r) in enumerate(zip(got[n_rounded:], ref64[n_rounded:])))
        del ref64
    else:
        err_w = None
    again = call(args16)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{name} bf16: a second call differs")
    out32 = [g.float() for g in got[:n_rounded]]
    del got, again, ref

    def casts():
        _fp32(args16)
        for o, dt in zip(out32, want_dtypes):
            o.to(dt)

    return {"name": name, "shape": shape, "max_abs_err_vs_plain_rounded": err,
            "max_abs_err_weight_grads_vs_fp64": err_w,
            "dtypes": [str(d).replace("torch.", "") for d in want_dtypes],
            "ms": time_ms(lambda: call(args16)), "fp32_ms": time_ms(lambda: call(args32)),
            "cast_ms": time_ms(casts)}


def check_bf16_kernels(rng) -> dict:
    """Phase 17 (a): the six kernel wrappers on bf16 inputs at phase 3,
    3b and 3c's shapes, each launching its kernel (the counts say so):
    dtypes as the Pallas kernels', one bf16 ulp, bit for bit, times."""
    from py4cast_tpu_torch.ops import attention
    from py4cast_tpu_torch.ops.hop_kernel import (
        corner_hop_bwd_plain,
        corner_hop_plain,
        fused_corner_hop,
        fused_corner_hop_bwd,
        gather_corners,
    )
    from py4cast_tpu_torch.ops.stencil_kernel import (
        fused_stencil_message,
        fused_stencil_message_bwd,
        stencil_message_bwd_plain,
        stencil_message_plain,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    rows = {name: [] for name in _wrappers()}
    reset_counts()
    for hr in GRAPHLAM_LEVELS:
        args = _bf16(stencil_inputs(rng, 1, hr, hr, 64))
        rows["stencil_message"].append(bf16_boundary(
            "stencil_message", f"e (1,8,{hr},{hr},64) ps (1,{hr},{hr},64) residual=True",
            lambda a: fused_stencil_message(*a, residual=True),
            lambda a: stencil_message_plain(*a, residual=True), args, 2, (bf16, bf16)))
        args = _bf16([*stencil_inputs(rng, 1, hr, hr, 64, shifted=True),
                      _rand(rng, 1, 8, hr, hr, 64), _rand(rng, 1, hr, hr, 64)])
        rows["stencil_message_bwd"].append(bf16_boundary(
            "stencil_message_bwd", f"e,vs,g_out (1,8,{hr},{hr},64) residual=True",
            lambda a: fused_stencil_message_bwd(*a, residual=True),
            lambda a: stencil_message_bwd_plain(*a, residual=True), args, 3,
            (bf16,) * 3 + (f32,) * 6))
        del args
    src, rest = hop_inputs(rng, 1, 500, 500, 64, 3)
    args = _bf16([*src, *rest])
    rows["corner_hop"].append(bf16_boundary(
        "corner_hop", "ps (1,125,125,64) vd (1,500,500,64) feats (4,500,500,3) mean=False",
        lambda a: (fused_corner_hop(*a, mean=False),),
        lambda a: (corner_hop_plain(*a, mean=False),), args, 1, (bf16,)))
    g = _rand(rng, 1, 500, 500, 64).to(bf16)
    args = [*gather_corners(*args[:3]), *args[3:], g]
    rows["corner_hop_bwd"].append(bf16_boundary(
        "corner_hop_bwd", "psg,vd,g (1,500,500,64) feats (4,500,500,3) mean=False",
        lambda a: fused_corner_hop_bwd(a[:4], *a[4:-1], a[-1], mean=False),
        lambda a: corner_hop_bwd_plain(a[:4], *a[4:-1], a[-1], mean=False), args, 5,
        (bf16,) * 5 + (f32,) * 14))
    del src, rest, args, g
    for label, (bh, lq, lk, d) in ATTENTION_SHAPES.items():
        scale = d ** -0.5
        qkv = [_rand(rng, bh, n, d).to(bf16) for n in (lq, lk, lk)]
        shape = f"{label}: q ({bh},{lq},{d}) k,v ({bh},{lk},{d})"
        row = bf16_boundary(
            "short_kv_attention", shape,
            lambda a: attention.fused_short_kv_attention(*a, scale)[:1],
            lambda a: (attention.short_kv_attention_plain(*a, scale),), qkv, 1, (bf16,))
        o32, lse = attention._short_kv_attention_fp32(*qkv, scale)
        rows["short_kv_attention"].append(row)
        do = _rand(rng, bh, lq, d).to(bf16)
        args = [*qkv, o32, lse, do]
        rows["short_kv_attention_bwd"].append(bf16_boundary(
            "short_kv_attention_bwd", shape,
            lambda a: attention.fused_short_kv_attention_bwd(*a, scale),
            lambda a: attention.short_kv_attention_bwd_plain(*a[:3], a[5], scale), args, 3,
            (bf16,) * 3))
        del qkv, o32, lse, do, args
    counts = read_counts()
    if not all(counts[name] > 0 for name in rows):
        raise AssertionError(f"bf16 inputs did not launch every kernel: {counts}")
    return {"launches": counts, "kernels": rows}


def bf16_dummy(name: str, fp32_predict: dict, fp32_kept: dict, fp32_fit: dict) -> dict:
    """Phase 17 (b): Trainer.predict and Trainer.fit on Dummy in bf16
    with model ``name``: the same launch counts as its fp32 phases; the
    card's bf16 predictions within twice the CPU's own bf16 error
    (max |cpu_bf16 - cpu_fp32|) of the card's fp32 predictions; fit's
    checks under bf16 (``train_dummy``, no resume)."""
    kept = {}
    predict = predict_dummy(model_settings(name, precision="bf16"), keep=kept)
    if predict["launches"] != fp32_predict["launches"]:
        raise AssertionError(f"{name} bf16 predict launches {predict['launches']}, "
                             f"fp32 {fp32_predict['launches']}")
    gap_cpu = max_abs_diff(kept["cpu"], fp32_kept["cpu"])
    gap_card = max_abs_diff(kept["card"], fp32_kept["card"])
    if not gap_card <= 2 * gap_cpu:
        raise AssertionError(f"{name} bf16 predict: card bf16 vs fp32 {gap_card:.3e} > 2 x "
                             f"the CPU's {gap_cpu:.3e}")
    predict.update(bf16_vs_fp32_card=gap_card, bf16_vs_fp32_cpu=gap_cpu,
                   scale=max(float(np.abs(a).max()) for a in fp32_kept["card"]))
    fit = train_dummy(name, precision="bf16", resume=False)
    if fit["launches"] != fp32_fit["launches"]:
        raise AssertionError(f"{name} bf16 fit launches {fit['launches']}, "
                             f"fp32 {fp32_fit['launches']}")
    return {"model": name, "predict": predict, "fit": fit}


def bf16_vs_fp32(fp32: dict, bf16: dict) -> dict:
    """ms, peak memory, device time and idle share of a full-size cell in
    fp32 and in bf16, side by side."""
    def nums(row):
        if "predict" in row:  # grid_model_full_size: a predict and a train step
            return {**{f"predict_{k}": v for k, v in nums(row["predict"]).items()},
                    **{f"train_{k}": v for k, v in nums(row["train"]).items()}}
        ms = row.get("ms_per_step", row.get("ms_per_train_step"))
        prof = row["profile"]
        return {"ms": ms, "peak_mem_bytes": row["peak_mem_bytes"],
                "device_busy_ms": prof["device_busy_ms"],
                "device_idle_share": prof["device_idle_share"],
                "casts_ms": prof["groups_ms"].get("copies and dtype casts", 0.0)}

    a, b = nums(fp32), nums(bf16)
    return {k: [a[k], b[k]] for k in a}


# ------------------------------------------------------------------ phase 18
def pretrained_on_card() -> dict:
    """Phase 18 (b): CustomUNet with ``encoder_weights: true`` loads
    data/pretrained/resnet18.npz on the card: every encoder parameter
    lands on the card and equals the CPU module's bit for bit, the stem
    the npz's fp16 kernel adapted to Dummy's input channels; then
    Trainer.predict on Dummy from those weights, counted, against the
    CPU."""
    from py4cast_tpu_torch.datasets import get_datasets
    from py4cast_tpu_torch.models.pretrained import (
        adapt_in_channels,
        default_weights_path,
        load_encoder_npz,
    )
    from py4cast_tpu_torch.training import AutoRegressiveModule

    settings = model_settings("CustomUNet", {"encoder_weights": True})
    path = default_weights_path("resnet18")
    if path != ROOT / "data" / "pretrained" / "resnet18.npz":
        raise AssertionError(f"encoder_weights: true resolved to {path}, not the bundled npz")
    info = get_datasets("dummy", 2, 1, 3)[2].dataset_info
    card = AutoRegressiveModule(settings, info, device="cuda").init_params(
        torch.Generator().manual_seed(0))
    cpu = AutoRegressiveModule(settings, info, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    enc = [k for k in cpu if k.startswith("encoder.")]
    differ = [k for k in enc if card[k].device.type != "cuda" or not torch.equal(card[k].cpu(),
                                                                                   cpu[k])]
    if differ:
        raise AssertionError(f"pretrained encoder params differ card vs cpu: {differ[:5]}")
    flat, meta = load_encoder_npz(path)
    n_in = cpu["encoder.stem_conv.weight"].shape[1]
    stem = torch.from_numpy(np.ascontiguousarray(adapt_in_channels(
        flat["stem_conv/kernel"], n_in).astype(np.float32).transpose(3, 2, 0, 1)))
    if not torch.equal(card["encoder.stem_conv.weight"].cpu(), stem):
        raise AssertionError("the card's stem is not the npz's kernel adapted to the inputs")
    predict = predict_dummy(settings)
    return {"npz": str(path.relative_to(ROOT)), "meta": meta, "encoder_params": len(enc),
            "encoder_values": sum(cpu[k].numel() for k in enc), "stem_in_channels": n_in,
            "predict": predict}


def perceptual_vs_cpu() -> dict:
    """Phase 18 (d): the perceptual loss's value (B, T) and its gradient
    with respect to the prediction on the card against the CPU, on
    Dummy-shaped fields (B 8, 3 steps, 64x64) with a masked patch; each
    within TOL of its own scale."""
    from types import SimpleNamespace

    from py4cast_tpu_torch.datasets import get_datasets
    from py4cast_tpu_torch.losses import PerceptualLossPy4Cast
    from py4cast_tpu_torch.utils import exact_reductions

    info = get_datasets("dummy", 2, 1, 3)[0].dataset_info
    names = info.output_feature_names
    rng = np.random.default_rng(0)
    shape = (8, 3, 64, 64, len(names))
    pred, target = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    mask = np.ones(shape, np.float32)
    mask[:, :, :5, :7] = 0.0

    def run(device):
        loss = PerceptualLossPy4Cast()
        loss.prepare(np.ones((64, 64, 1), np.float32), info, names)
        p = torch.from_numpy(pred).to(device).requires_grad_(True)
        with exact_reductions():
            value = loss(SimpleNamespace(array=p),
                         SimpleNamespace(array=torch.from_numpy(target).to(device)),
                         torch.from_numpy(mask).to(device))
            value.sum().backward()
        return value.detach().cpu(), p.grad.cpu()

    errs = {}
    for what, card, cpu in zip(("value", "gradient"), run("cuda"), run("cpu")):
        scale = float(cpu.abs().max())
        errs[what] = float((card.double() - cpu.double()).abs().max()) / scale
        if not errs[what] <= TOL:
            raise AssertionError(f"perceptual {what} card vs cpu: {errs[what]:.3e} of scale")
    return {"shape": list(shape), "rel_err_value": errs["value"],
            "rel_err_gradient": errs["gradient"]}


def perceptual_full_size(grid=(512, 640), reps: int = 3) -> dict:
    """Phase 18 (d): HalfUNet's 512x640 AdamW train step (halfunet.yaml's
    width, batch 1, 1 AR step, 21 + 21 features) with the WeightedLoss
    alone and with the perceptual loss beside it: host ms a step, peak
    memory, device busy ms; and the perceptual loss alone, forward and
    backward on a prediction of the cell's shape, in device ms (CUDA
    events)."""
    from types import SimpleNamespace

    from py4cast_tpu_torch.losses import PerceptualLossPy4Cast
    from py4cast_tpu_torch.testing import synthetic_batch, synthetic_dataset_info
    from py4cast_tpu_torch.training import AutoRegressiveModule
    from py4cast_tpu_torch.utils import exact_reductions

    info = synthetic_dataset_info(grid_shape=grid, weather_features=21, forcing_features=21)
    one = synthetic_batch(info, batch_size=1, num_input_steps=2, num_pred_steps=1, seed=0)
    rows = {}
    for label, losses in (("weighted", None), ("weighted_perceptual", PERCEPTUAL_LOSSES)):
        settings = model_settings("HalfUNet", num_warmup_steps=2,
                                  **({"losses": losses} if losses else {}))
        module = AutoRegressiveModule(settings, info, device="cuda")
        state = module.init_state(torch.Generator().manual_seed(0), num_training_steps=100)
        for _ in range(2):  # warm-up: allocator, cuDNN's choice, lr-0 step
            module.train_step(state, one)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses_seen = []
        runs = _timed(lambda: losses_seen.append(float(module.train_step(state, one))), reps)
        peak = torch.cuda.max_memory_allocated()
        if not np.isfinite(losses_seen).all():
            raise AssertionError(f"HalfUNet 512x640 {label} train losses {losses_seen}")
        profile = profile_step(lambda: module.train_step(state, one),
                               f"smoke_profile_halfunet_train_{label}.txt")
        step_ms = float(np.median(runs))
        profile["device_idle_share"] = max(0.0, 1.0 - profile["device_busy_ms"] / step_ms)
        rows[label] = {"ms_per_train_step_runs": runs, "ms_per_train_step": step_ms,
                       "peak_mem_bytes": peak, "losses": losses_seen, "profile": profile}
        del module, state
    loss = PerceptualLossPy4Cast()
    loss.prepare(np.ones((*grid, 1), np.float32), info, info.output_feature_names)
    rng = np.random.default_rng(1)
    fields = [_rand(rng, 1, 1, *grid, 21) for _ in range(2)]
    pred = fields[0].requires_grad_(True)
    mask = torch.ones_like(fields[1])

    def loss_step():
        value = loss(SimpleNamespace(array=pred), SimpleNamespace(array=fields[1]), mask)
        value.sum().backward()

    with exact_reductions():
        loss_ms = time_ms(loss_step, reps=5, warmup=2, inner=3)
    w, wp = rows["weighted"], rows["weighted_perceptual"]
    return {"grid": list(grid), "rows": rows, "loss_fwd_bwd_device_ms": loss_ms,
            "added_ms_per_train_step": wp["ms_per_train_step"] - w["ms_per_train_step"],
            "added_device_busy_ms": (wp["profile"]["device_busy_ms"]
                                     - w["profile"]["device_busy_ms"]),
            "added_peak_mem_bytes": wp["peak_mem_bytes"] - w["peak_mem_bytes"]}


def resnet_phase() -> dict:
    """Phase 18, no hand kernel (every count stays 0): (a) CustomUNet,
    DeepLabV3 and DeepLabV3Plus at their yamls' width on Dummy, predict
    and fit, the CLI with each yaml; (b) CustomUNet's pretrained encoder
    on the card; (c) each at 512x640; (d) the perceptual loss: card vs
    CPU, a HalfUNet fit with it, HalfUNet's 512x640 train step with and
    without it; (e) the three models' Dummy predict and fit in bf16."""
    t18 = time.perf_counter()
    resnet = {"dummy": {}, "full_size": {}, "bf16": {}}
    resnet_kept = {name: {} for name in RESNET_YAMLS}
    for name, yaml_name in RESNET_YAMLS.items():
        predict = predict_dummy(model_settings(name), keep=resnet_kept[name])
        log(f"{yaml_name} predict dummy: {json.dumps(predict)}")
        fitted = train_dummy(name)
        log(f"{yaml_name} fit dummy: {json.dumps(fitted)}")
        fitted["cli"] = cli_dummy(
            yaml_name, want=lambda sub, n=name: cli_launches(n, MODEL_ARGS[n], sub))
        log(f"{yaml_name} cli dummy: {json.dumps(fitted['cli'])}")
        resnet["dummy"][name] = {"predict": predict, "fit": fitted}
    resnet["pretrained"] = pretrained_on_card()
    log(f"customunet pretrained encoder: {json.dumps(resnet['pretrained'])}")
    for name in RESNET_YAMLS:
        resnet["full_size"][name] = grid_model_full_size(name, reps=3)
        log(f"{RESNET_YAMLS[name]} 512x640: {json.dumps(resnet['full_size'][name])}")
    resnet["perceptual"] = {"vs_cpu": perceptual_vs_cpu()}
    log(f"perceptual card vs cpu: {json.dumps(resnet['perceptual']['vs_cpu'])}")
    resnet["perceptual"]["fit"] = train_dummy("HalfUNet", losses=PERCEPTUAL_LOSSES)
    log(f"halfunet fit dummy with the perceptual loss: "
        f"{json.dumps(resnet['perceptual']['fit'])}")
    resnet["perceptual"]["full_size"] = perceptual_full_size()
    log(f"halfunet 512x640 train step with and without the perceptual loss: "
        f"{json.dumps(resnet['perceptual']['full_size'])}")
    for name in RESNET_YAMLS:
        d = resnet["dummy"][name]
        resnet["bf16"][name] = bf16_dummy(name, d["predict"], resnet_kept[name], d["fit"])
        log(f"bf16 dummy {name}: {json.dumps(resnet['bf16'][name])}")
    del resnet_kept
    resnet["wall_s"] = time.perf_counter() - t18
    log(f"phase 18 wall: {resnet['wall_s']:.1f} s")
    return resnet


# ------------------------------------------------------------------ phase 19
def repeat_bit_for_bit(module, params, batch, what: str) -> dict:
    """A predict step, and one train step's loss and gradients, each
    twice on the card, counted: the second call bit for bit the first,
    and no hand kernel launched."""
    reset_counts()
    preds = [module.predict_step(params, batch).array for _ in range(2)]
    (l1, g1), (l2, g2) = (module.loss_and_grads(params, batch) for _ in range(2))
    torch.cuda.synchronize()
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"{what}: hand kernels launched {counts}")
    differ = [k for k in g1 if not torch.equal(g1[k], g2[k])]
    if not torch.equal(preds[0], preds[1]) or not torch.equal(l1, l2) or differ:
        raise AssertionError(f"{what}: a second call differs (predictions equal "
                             f"{torch.equal(preds[0], preds[1])}, loss equal "
                             f"{torch.equal(l1, l2)}, gradients {differ[:5]})")
    return {"predict_bit_for_bit": True, "loss_bit_for_bit": True,
            "gradients_bit_for_bit": len(g1)}


def dummy_repeat(name: str, overrides=None) -> dict:
    """``repeat_bit_for_bit`` on a Dummy train batch (3 AR steps to
    predict, 1 to train), params from seed 0."""
    from py4cast_tpu_torch.datasets import get_datasets
    from py4cast_tpu_torch.training import AutoRegressiveModule

    train_ds = get_datasets("dummy", 2, 1, 3)[0]
    module = AutoRegressiveModule(model_settings(name, overrides), train_ds.dataset_info,
                                  device="cuda")
    params = module.init_params(torch.Generator().manual_seed(0))
    batch = next(iter(train_ds.loader(batch_size=8, num_workers=1)))
    return repeat_bit_for_bit(module, params, batch, f"{name} Dummy")


def table_vs_lattice(name: str, grid=(500, 500)) -> dict:
    """Phase 19 (d): the table path's step 1 against the lattice path's
    at 500x500 from one state dict on the card, within TOL of scale, and
    the table path's predict and backward repeated bit for bit."""
    from py4cast_tpu_torch.testing import synthetic_batch, synthetic_dataset_info
    from py4cast_tpu_torch.training import AutoRegressiveModule

    info = synthetic_dataset_info(grid_shape=grid, weather_features=21, forcing_features=21)
    lattice = AutoRegressiveModule(model_settings(name), info, device="cuda")
    table = AutoRegressiveModule(model_settings(name, TABLE), info, device="cuda")
    if lattice.model.table_path or not table.model.table_path:
        raise AssertionError(f"{name}: paths not as asked")
    params = lattice.init_params(torch.Generator().manual_seed(0))
    one = synthetic_batch(info, batch_size=1, num_input_steps=2, num_pred_steps=1, seed=0)
    got = table.predict_step(params, one).array
    want = lattice.predict_step(params, one).array
    err = compare(f"{name} {grid} table vs lattice step 1", got, want)
    repeat = repeat_bit_for_bit(table, params, one, f"{name} {grid} table path")
    return {"model": name, "grid": list(grid), "max_abs_err_table_vs_lattice": err,
            "scale": float(want.abs().max()), **repeat}


def degenerate_multimesh() -> dict:
    """Phase 19 (e): GraphLAM at graphlam.yaml's width on an 8x8 grid at
    mesh_levels 2: its 2x2 level-0 lattice repeats edges across levels,
    so use_lattice true falls through to the table path, as in the JAX
    package; a 3-step predict on the card, counted (0), against the
    CPU."""
    from py4cast_tpu_torch.testing import synthetic_batch, synthetic_dataset_info
    from py4cast_tpu_torch.training import AutoRegressiveModule

    info = synthetic_dataset_info(grid_shape=(8, 8), weather_features=21, forcing_features=21)
    settings = model_settings("GraphLAM", {"mesh_levels": 2})
    module = AutoRegressiveModule(settings, info, device="cuda")
    graph = module.model.graph
    if graph.multi_lattice_ok or not module.model.table_path:
        raise AssertionError("the 8x8 grid's multimesh did not take the table path")
    params = module.init_params(torch.Generator().manual_seed(0))
    batch = synthetic_batch(info, batch_size=1, num_input_steps=2, num_pred_steps=3, seed=0)
    reset_counts()
    preds = module.predict_step(params, batch).array
    torch.cuda.synchronize()
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"degenerate multimesh: hand kernels launched {counts}")
    if preds.shape != (1, 3, 64, 21) or not bool(torch.isfinite(preds).all()):
        raise AssertionError(f"degenerate multimesh predictions {tuple(preds.shape)}")
    cpu = AutoRegressiveModule(settings, info, device="cpu").predict_step(
        {k: v.cpu() for k, v in params.items()}, batch).array
    err = compare("degenerate multimesh predict (cuda vs cpu)", preds.cpu(), cpu)
    return {"grid": [8, 8], "level_hw": [list(hw) for hw in graph.level_hw],
            "multi_edges": len(graph.multi), "launches": counts, "max_abs_err_vs_cpu": err}


def swin_table_phase() -> dict:
    """Phase 19, no hand kernel (every count stays 0): (a) SwinUNetR on
    Dummy; (b) at 512x640 in fp32 and bf16; (c) Identity through the
    CLI; (d) the table path at 500x500 and HiLAMParallel's on Dummy;
    (e) the degenerate multimesh."""
    t19 = time.perf_counter()
    swin = {}
    kept = {}
    swin["predict"] = predict_dummy(model_settings("SwinUNetR"), keep=kept)
    log(f"swinunetr predict dummy: {json.dumps(swin['predict'])}")
    swin["fit"] = train_dummy("SwinUNetR")
    log(f"swinunetr fit dummy: {json.dumps(swin['fit'])}")
    swin["fit"]["cli"] = cli_dummy(
        "swinunetr", want=lambda sub: cli_launches("SwinUNetR", SWINUNETR_ARGS, sub))
    log(f"swinunetr cli dummy: {json.dumps(swin['fit']['cli'])}")
    swin["repeat"] = dummy_repeat("SwinUNetR")
    log(f"swinunetr dummy repeat: {json.dumps(swin['repeat'])}")
    swin["bf16"] = bf16_dummy("SwinUNetR", swin["predict"], kept, swin["fit"])
    log(f"bf16 dummy SwinUNetR: {json.dumps(swin['bf16'])}")
    del kept
    swin["full_size"] = grid_model_full_size("SwinUNetR", reps=3)
    log(f"swinunetr 512x640: {json.dumps(swin['full_size'])}")
    swin["full_size_bf16"] = grid_model_full_size("SwinUNetR", precision="bf16",
                                                  tag="swinunetr_bf16", reps=3)
    log(f"swinunetr 512x640 bf16: {json.dumps(swin['full_size_bf16'])}")
    log("  swinunetr fp32 -> bf16: " + json.dumps(bf16_vs_fp32(swin["full_size"],
                                                               swin["full_size_bf16"])))
    out = {"swinunetr": swin}
    out["identity_cli"] = cli_dummy(
        None, ["--model.model_name", "Identity"],
        want=lambda sub: cli_launches("Identity", {}, sub))
    log(f"identity cli dummy: {json.dumps(out['identity_cli'])}")
    table = {}
    for name in ("GraphLAM", "HiLAM"):
        tag = name.lower()
        table[name] = {
            "predict": full_size_rollout(name, overrides=TABLE,
                                         profile_name=f"smoke_profile_{tag}_table.txt"),
            "train": full_size_train_step(name, overrides=TABLE,
                                          profile_name=f"smoke_profile_{tag}_table_train.txt"),
            "vs_lattice": table_vs_lattice(name)}
        for what, row in table[name].items():
            log(f"{tag} table path 500x500 {what}: {json.dumps(row)}")
    table["HiLAMParallel"] = {"predict": predict_dummy(model_settings("HiLAMParallel", TABLE)),
                              "fit": train_dummy("HiLAMParallel", TABLE)}
    for what, row in table["HiLAMParallel"].items():
        log(f"hilamparallel table path dummy {what}: {json.dumps(row)}")
    out["table"] = table
    out["degenerate_multimesh"] = degenerate_multimesh()
    log(f"graphlam degenerate multimesh: {json.dumps(out['degenerate_multimesh'])}")
    out["wall_s"] = time.perf_counter() - t19
    log(f"phase 19 wall: {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------------ phase 20
#: the launcher variables phase 20 (a) sets for its group of one rank
_GROUP_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


def data_axis_steps(name: str, grid, steps: int = 3) -> dict:
    """``steps`` AdamW steps (1 AR step, batch 1) of ``name`` at its
    config's width on ``grid``, each on its own synthetic batch, counted:
    the launches must be ``steps`` forwards' and backwards'. Inside a
    process group when one is up."""
    from py4cast_tpu_torch.testing import synthetic_batch, synthetic_dataset_info
    from py4cast_tpu_torch.training import AutoRegressiveModule

    info = synthetic_dataset_info(grid_shape=grid, weather_features=21, forcing_features=21)
    module = AutoRegressiveModule(model_settings(name, num_warmup_steps=2), info, device="cuda")
    state = module.init_state(torch.Generator().manual_seed(0), num_training_steps=100)
    batches = [synthetic_batch(info, batch_size=1, num_input_steps=2, num_pred_steps=1, seed=k)
               for k in range(steps)]
    reset_counts()
    losses = [module.train_step(state, b) for b in batches]
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != expected_launches(module, steps, steps):
        raise AssertionError(f"{name} {grid} {steps} train steps: launches {counts}")
    losses = [float(v) for v in losses]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{name} {grid} train losses {losses}")
    return {"module": module, "state": state, "losses": losses, "launches": counts,
            "distributed": module.mesh.distributed}


def time_all_reduce(params: dict, label: str) -> dict:
    """The gradient all-reduce of a process group's train step on
    ``params``' layout (gradients of ones): its flat fp32 buffer's bytes,
    the ms of ``all_reduce_grads`` (copy in, all_reduce, divide, copy
    back) and of the ``all_reduce`` alone, CUDA events."""
    import torch.distributed as dist

    from py4cast_tpu_torch.parallel.mesh import all_reduce_grads

    for p in params.values():
        p.grad = torch.ones_like(p)
    n_bytes = all_reduce_grads(params, 1)
    flat = torch.cat([p.grad.reshape(-1) for p in params.values()])
    row = {"label": label, "params": sum(p.numel() for p in params.values()),
           "buffer_bytes": n_bytes,
           "all_reduce_grads_ms": time_ms(lambda: all_reduce_grads(params, 1), reps=10, inner=5),
           "all_reduce_ms": time_ms(lambda: dist.all_reduce(flat), reps=10, inner=5),
           "world_size": dist.get_world_size(), "backend": dist.get_backend()}
    for p in params.values():
        p.grad = None
    return row


def torchrun_cli() -> dict:
    """Phase 20 (b): ``torchrun --standalone --nproc-per-node 1 -m
    py4cast_tpu_torch`` fit, test and predict on Dummy with
    halfunet.yaml; one set of outputs written."""
    import shutil

    from py4cast_tpu_torch.datasets import get_datasets

    save = BUILD / "smoke_torchrun"
    shutil.rmtree(save, ignore_errors=True)
    configs = ["--config", str(ROOT / "config/CLI/trainer.yaml"),
               "--config", str(ROOT / "config/CLI/dataset/dummy.yaml"),
               "--config", str(ROOT / "config/CLI/model/halfunet.yaml"),
               "--trainer.save_path", str(save)]
    env = {k: v for k, v in os.environ.items() if k not in _GROUP_ENV}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    # where site-packages holds no bytecode, each process would compile
    # torch's sources again (8 s): fit writes it here, test and predict
    # read it
    env["PYTHONPYCACHEPREFIX"] = str(BUILD / "pycache")
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    seconds = {}
    for sub in CLI_STEPS:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "py4cast_tpu_torch", sub, *configs,
             *CLI_STEPS[sub]],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        seconds[sub] = time.perf_counter() - t0
        (OUT_DIR / f"smoke_torchrun_{sub}.log").write_text(out.stdout + out.stderr)
        if out.returncode != 0:
            raise AssertionError(f"torchrun {sub} exited with {out.returncode}:\n"
                                 f"{(out.stdout + out.stderr)[-3000:]}")
    test_batches = -(-len(get_datasets("dummy", 2, 1, 3)[2]) // 8)
    written = sorted(str(p.relative_to(save)) for p in save.rglob("*") if p.is_file())
    preds = [w for w in written if w.startswith("predictions/")]
    once = {name: sum(w.endswith(name) for w in written)
            for name in ("test_scores.json", "manifest.json", "run_info.json", "signature.json")}
    states = [w for w in written if w.endswith("state.pt")]
    if (set(once.values()) != {1} or len(preds) != test_batches
            or sorted(states) != ["checkpoints/best/state.pt", "checkpoints/last/state.pt"]):
        raise AssertionError(f"torchrun outputs: {once}, {len(preds)} prediction files "
                             f"(expected {test_batches}), checkpoints {states}")
    scores = json.loads((save / "test_scores.json").read_text())
    arrays = [np.load(save / p) for p in preds]
    if not np.isfinite(scores["test_mean_loss"]) or not all(np.isfinite(a).all()
                                                             for a in arrays):
        raise AssertionError(f"torchrun outputs not finite: {scores}")
    return {"seconds": seconds, "files": len(written), "prediction_files": len(preds),
            "prediction_shape": list(arrays[0].shape),
            "test_mean_loss": scores["test_mean_loss"]}


def lat_padding_1791(name: str, grid=(1791, 64)) -> dict:
    """Phase 20 (c): ``name`` at its config's width on a 1791-row crop,
    padded to 1792 (lat_multiple 2): one train step and a 1-step
    predict, counted; a finite loss, predictions back at 1791 rows."""
    from py4cast_tpu_torch.testing import synthetic_batch, synthetic_dataset_info
    from py4cast_tpu_torch.training import AutoRegressiveModule

    info = synthetic_dataset_info(grid_shape=grid, weather_features=21, forcing_features=21)
    module = AutoRegressiveModule(model_settings(name, num_warmup_steps=2), info, device="cuda",
                                  lat_multiple=2)
    if module._lat_pad != 1 or getattr(module.model, "table_path", False):
        raise AssertionError(f"{name} {grid}: lat pad {module._lat_pad}, not the lattice path")
    state = module.init_state(torch.Generator().manual_seed(0), num_training_steps=100)
    batch = synthetic_batch(info, batch_size=1, num_input_steps=2, num_pred_steps=1, seed=0)
    reset_counts()
    loss = float(module.train_step(state, batch))
    preds = module.predict_step(state, batch).array
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != expected_launches(module, 2, 1):
        raise AssertionError(f"{name} {grid} padded: launches {counts}")
    spatial = (grid[0] * grid[1],) if module.is_graph else tuple(grid)
    if (not np.isfinite(loss) or tuple(preds.shape) != (1, 1, *spatial, 21)
            or not bool(torch.isfinite(preds).all())):
        raise AssertionError(f"{name} {grid} padded: loss {loss}, predictions "
                             f"{tuple(preds.shape)}")
    return {"model": name, "grid": list(grid), "padded_lat": grid[0] + module._lat_pad,
            "loss": loss, "prediction_shape": list(preds.shape), "launches": counts}


def two_ranks_vs_one() -> dict:
    """Phase 20 (d), on two cards or more: two NCCL ranks (one card
    each) against one, three AdamW steps of GraphLAM at graphlam.yaml's
    width on a 64x64 grid, global batch 2: losses and parameters within
    TOL of scale."""
    from py4cast_tpu_torch.testing import run_ranks

    kwargs = {"model_name": "GraphLAM", "settings_init_args": GRAPHLAM_ARGS, "grid": [64, 64],
              "batch_size": 2, "device": "cuda"}
    one = run_ranks("py4cast_tpu_torch.testing:train_report", 1, kwargs, device="cuda",
                    timeout=300)[0]
    two = run_ranks("py4cast_tpu_torch.testing:train_report", 2, kwargs, device="cuda",
                    timeout=300)
    loss_err = max(abs(a - b) / abs(b) for r in two for a, b in zip(r["losses"], one["losses"]))
    param_err = max(compare(f"two ranks vs one: {k}", r["params"][k], v)
                    for r in two for k, v in one["params"].items())
    if not loss_err <= TOL:
        raise AssertionError(f"two ranks vs one: losses {[r['losses'] for r in two]} vs "
                             f"{one['losses']}")
    return {"losses_one": one["losses"], "losses_two": two[0]["losses"],
            "loss_rel_err": loss_err, "max_abs_param_err": param_err}


def data_axis_phase(train_full=None) -> dict:
    """Phase 20, the data axis: (a) an NCCL group of one rank, three
    AdamW steps of GraphLAM at 500x500 and of Segformer at 512x640 bit
    for bit as without a group (where two runs without one agree bit for
    bit), counted as phase 7 counts
    (``train_full``, phase 7's result, when given), and the gradient
    all-reduce's bytes and ms for GraphLAM, Segformer and UNetRPP
    (512x640); (b) torchrun's fit, test and predict; (c) lat padding at
    1791 rows; (d) two ranks against one, on two cards or more."""
    from py4cast_tpu_torch.parallel.mesh import distributed, maybe_init_distributed
    from py4cast_tpu_torch.testing import _free_port
    from py4cast_tpu_torch.training import AutoRegressiveModule

    t20 = time.perf_counter()
    log(f"phase 20 card: {card_line()}")
    cells = {"GraphLAM": (500, 500), "Segformer": (512, 640)}
    alone = {name: data_axis_steps(name, grid) for name, grid in cells.items()}
    for name, grid in cells.items():  # the baseline repeats bit for bit
        again, want = data_axis_steps(name, grid), alone[name]
        differ = [k for k, p in want["state"].params.items()
                  if not torch.equal(again["state"].params[k], p)]
        if again["losses"] != want["losses"] or differ:
            raise AssertionError(f"{name}: a second run without a group differs: losses "
                                 f"{again['losses']} vs {want['losses']}, params {differ[:5]}")
        del again
    per_step = {k: v * 3 for k, v in (train_full or {}).get("launches", {}).items()}
    if per_step and alone["GraphLAM"]["launches"] != per_step:
        raise AssertionError(f"GraphLAM 3 steps {alone['GraphLAM']['launches']}, phase 7's "
                             f"x 3 {per_step}")
    saved = {k: os.environ.get(k) for k in _GROUP_ENV}
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
                       "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"})
    import torch.distributed as dist

    try:
        if not maybe_init_distributed("cuda", timeout=300) or dist.get_backend() != "nccl":
            raise AssertionError("no NCCL process group")
        group = {}
        for name, grid in cells.items():
            run = data_axis_steps(name, grid)
            want = alone[name]
            if not run["distributed"] or run["launches"] != want["launches"]:
                raise AssertionError(f"{name} in the group: launches {run['launches']}, "
                                     f"alone {want['launches']}")
            differ = [k for k, p in want["state"].params.items()
                      if not torch.equal(run["state"].params[k], p)]
            if run["losses"] != want["losses"] or differ:
                raise AssertionError(f"{name}: one NCCL rank differs from no group: losses "
                                     f"{run['losses']} vs {want['losses']}, params {differ[:5]}")
            group[name] = {"grid": list(grid), "losses": run["losses"],
                           "launches": run["launches"], "bit_for_bit": True,
                           "all_reduce": time_all_reduce(run["state"].params, name)}
            del run
        from py4cast_tpu_torch.testing import synthetic_dataset_info

        rpp = AutoRegressiveModule(
            model_settings("UNetRPP"),
            synthetic_dataset_info(grid_shape=(512, 640), weather_features=21,
                                   forcing_features=21), device="cuda")
        group["UNetRPP"] = {"grid": [512, 640], "all_reduce": time_all_reduce(
            {k: torch.zeros_like(v).requires_grad_() for k, v in rpp.model.named_parameters()},
            "UNetRPP")}
        del rpp
    finally:
        if distributed():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    del alone
    torch.cuda.empty_cache()
    out = {"one_rank_group": group}
    for name, row in group.items():
        log(f"phase 20 (a) {name}: {json.dumps(row)}")
    out["torchrun"] = torchrun_cli()
    log(f"phase 20 (b) torchrun fit/test/predict: {json.dumps(out['torchrun'])}")
    out["lat_padding"] = [lat_padding_1791(n) for n in ("HiLAM", "HalfUNet")]
    for row in out["lat_padding"]:
        log(f"phase 20 (c) {row['model']} 1791 rows: {json.dumps(row)}")
    if torch.cuda.device_count() >= 2:
        out["two_ranks"] = two_ranks_vs_one()
        log(f"phase 20 (d) two NCCL ranks vs one: {json.dumps(out['two_ranks'])}")
    else:
        log("phase 20 (d): not run, 1 card")
    out["wall_s"] = time.perf_counter() - t20
    log(f"phase 20 wall: {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------------ phase 21
#: the band counts phase 21 (a) feeds by hand on one card
BAND_COUNTS = (2, 4)


def _fed_rows(x, band, halo: int):
    """Band ``band``'s rows of NHWC ``x`` with ``halo`` rows a side from
    the neighbour bands and zeros at the global edges: what
    ``parallel.spatial.halo_rows`` hands a band, cut from the whole grid."""
    import torch.nn.functional as F

    rows = band.rows(x.shape[1])
    return F.pad(x, (0, 0, 0, 0, halo, halo))[:, rows.start:rows.stop + 2 * halo]


def _rel_l2(name: str, got, want, tol: float = TOL) -> float:
    """||got - want|| / ||want||; raises above ``tol``."""
    err = float((got.double() - want.double()).norm() / want.double().norm())
    if not err <= tol:
        raise AssertionError(f"{name}: relative L2 difference {err:.3e} exceeds {tol:g}")
    return err


def _grads(out, g, leaves):
    return torch.autograd.grad((out * g).sum(), leaves, allow_unused=True,
                               materialize_grads=True)


def _block_on_bands(block, x, count: int):
    """HalfUNet's ConvBlock on ``count`` bands of NHWC ``x``: each conv fed
    its halo rows from the whole grid of the layer before, each GroupNorm
    the sums of every band, added up by hand; the bands' outputs
    concatenated."""
    from py4cast_tpu_torch.parallel.spatial import Band

    bands = [Band(s, count) for s in range(count)]
    h = x
    for i in range(2):
        conv, norm = getattr(block, f"Conv_{i}"), getattr(block, f"GroupNorm_{i}")
        halo, _ = conv.band_halo()
        ys = [conv.forward_halo(_fed_rows(h, b, halo)) for b in bands]
        sums = sum(norm.band_sums(y) for y in ys)
        n = x.shape[1] * x.shape[2] * (ys[0].shape[-1] // norm.num_groups)
        h = torch.cat([torch.relu(norm.normalize(y, sums, n)) for y in ys], dim=1)
    return h


def halfunet_band_block(rng, grid=(512, 640)) -> dict:
    """Phase 21 (a), HalfUNet: the first ConvBlock at halfunet.yaml's width
    (67 inputs at 21 + 21 features, 64 filters, no bias) on 2 and on 4
    bands (``_block_on_bands``) against the whole-grid call, and its
    first GroupNorm alone, each band fed its sums by hand.

    Held to TOL of scale: in fp32 the block's forward and the
    GroupNorm's forward and gradients; in fp64 the block's forward and
    every gradient. The block's fp32 gradients are printed, not held:
    cuDNN picks other algorithms for a band's shape than for the whole
    grid's (FFT and Winograd among them), and a ReLU input within their
    rounding of zero passes its gradient on one side of the kink and not
    on the other; fp64 leaves no such input, so it holds the bands'
    arithmetic itself. Beside the fp32 gradients' relative L2 difference
    stands the whole-grid fp32 call's own, against fp64."""
    from py4cast_tpu_torch.models.unet import ConvBlock
    from py4cast_tpu_torch.parallel.spatial import Band
    from py4cast_tpu_torch.training import init_weights

    block = ConvBlock(67, HALFUNET_ARGS["num_filters"], use_bias=HALFUNET_ARGS["bias"]).cuda()
    init_weights(block, torch.Generator(device="cuda").manual_seed(0))
    x32 = _rand(rng, 1, *grid, 67).requires_grad_()
    g32 = _rand(rng, 1, *grid, 64)
    want = {}
    for dtype in (torch.float32, torch.float64):
        blk = block.to(dtype)
        x, g = x32.detach().to(dtype).requires_grad_(), g32.to(dtype)
        out = blk(x)
        want[dtype] = (x, g, out.detach(), _grads(out, g, [x, *blk.parameters()]))
        del out
    rows = []
    for count in BAND_COUNTS:
        row = {"bands": count}
        for dtype, tag in ((torch.float32, "fp32"), (torch.float64, "fp64")):
            blk = block.to(dtype)
            x, g, out, grads = want[dtype]
            h = _block_on_bands(blk, x, count)
            row[f"block_forward_max_abs_err_{tag}"] = compare(
                f"ConvBlock on {count} bands ({tag})", h.detach(), out)
            got = _grads(h, g, [x, *blk.parameters()])
            names = ["x", *(k for k, _ in blk.named_parameters())]
            if dtype == torch.float64:
                row["block_grad_max_abs_err_fp64"] = max(
                    compare(f"ConvBlock on {count} bands (fp64): d{k}", a, b)
                    for k, a, b in zip(names, got, grads))
            else:
                row["block_grad_rel_l2_fp32"] = max(
                    float((a - b).norm() / b.norm()) for a, b in zip(got, grads))
                row["whole_fp32_vs_fp64_grad_rel_l2"] = max(
                    float((a.double() - b).norm() / b.norm())
                    for a, b in zip(grads, want[torch.float64][3]))
            del h, got
        blk = block.to(torch.float32)
        gn = blk.GroupNorm_0
        x2 = _rand(rng, 1, *grid, 64, scale=3.0, shift=1.5).requires_grad_()
        gn_leaves = [x2, gn.weight, gn.bias]
        gn_want = gn(x2)
        gn_want_grads = _grads(gn_want, g32, gn_leaves)
        parts = [Band(s, count).cut(x2, 1) for s in range(count)]
        sums = sum(gn.band_sums(p) for p in parts)
        gn_got = torch.cat([gn.normalize(p, sums, grid[0] * grid[1] * 8) for p in parts], dim=1)
        row["groupnorm_forward_max_abs_err"] = compare(
            f"GroupNorm on {count} bands", gn_got.detach(), gn_want.detach())
        row["groupnorm_grad_max_abs_err"] = max(
            compare(f"GroupNorm on {count} bands: d{k}", a, b)
            for k, a, b in zip(("x", "weight", "bias"), _grads(gn_got, g32, gn_leaves),
                               gn_want_grads))
        rows.append(row)
    return {"model": "HalfUNet", "grid": list(grid), "piece": "ConvBlock_0 (67 -> 64)",
            "rows": rows}


def graph_band_hops(rng, grid=(500, 500)) -> dict:
    """Phase 21 (a), GraphLAM: the g2m and m2g hops at graphlam.yaml's
    width (h 64, 3 levels; level 0 125x125) on 2 and on 4 bands against
    the whole grid's, each band's grid-side metadata cut by a model built
    on that band. g2m: the bands' partial aggregates added up by hand,
    then the node update. m2g: ``CornerHopFn`` on each band's rows
    against the whole mesh projection, kernels b-fwd and b-bwd launched
    once a band and counted; its output rows, ``dps`` and the weight
    gradients summed over the bands against the whole's. Forwards within
    TOL of scale, gradients within GRAD_TOL."""
    from py4cast_tpu_torch.models.graph import GraphLAM, GraphModelSettings
    from py4cast_tpu_torch.parallel.spatial import Band
    from py4cast_tpu_torch.testing import synthetic_statics
    from py4cast_tpu_torch.training import init_weights

    settings = GraphModelSettings(**GRAPHLAM_ARGS)
    graph = GraphLAM.build_graph(settings, synthetic_statics(grid, 10).meshgrid)
    whole = GraphLAM(67, 21, (grid[0] * grid[1],), settings, graph).cuda()
    init_weights(whole, torch.Generator(device="cuda").manual_seed(0))
    h = GRAPHLAM_ARGS["hidden_dims"]
    level0 = graph.level_hw[0]
    grid_v = _rand(rng, 1, *grid, h).requires_grad_()
    mesh_v = _rand(rng, 1, *level0, h).requires_grad_()
    g_mesh, g_grid = _rand(rng, 1, *level0, h), _rand(rng, 1, *grid, h)
    f32 = torch.float32
    rows = []
    g2m, m2g = whole.g2m, whole.m2g
    g2m_leaves = [grid_v, mesh_v, *g2m.parameters()]
    m2g_leaves = [mesh_v, grid_v, *m2g.parameters()]
    g2m_want = g2m(grid_v, mesh_v, whole._lat("g2m", f32))
    g2m_want_grads = _grads(g2m_want, g_mesh, g2m_leaves)
    m2g_want = m2g(mesh_v, grid_v, whole._lat("m2g", f32))
    m2g_want_grads = _grads(m2g_want, g_grid, m2g_leaves)
    torch.cuda.synchronize()
    for count in BAND_COUNTS:
        bands = [Band(s, count) for s in range(count)]
        lats = [GraphLAM(67, 21, (grid[0] * grid[1],), settings, graph, band=(s, count)).cuda()
                for s in range(count)]
        agg = sum(g2m.aggregate(b.cut(grid_v, 1), mesh_v, m._lat("g2m", f32))
                  for b, m in zip(bands, lats))
        got = g2m.update(mesh_v, agg, whole._lat("g2m", f32))
        g2m_fwd = compare(f"g2m on {count} bands", got.detach(), g2m_want.detach())
        g2m_grad = max(compare(f"g2m on {count} bands: grad {i}", a, b, GRAD_TOL)
                       for i, (a, b) in enumerate(zip(_grads(got, g_mesh, g2m_leaves),
                                                      g2m_want_grads)))
        reset_counts()
        got = torch.cat([m2g(mesh_v, b.cut(grid_v, 1), m._lat("m2g", f32))
                         for b, m in zip(bands, lats)], dim=1)
        got_grads = _grads(got, g_grid, m2g_leaves)
        torch.cuda.synchronize()
        counts = read_counts()
        want_counts = {name: 0 for name in counts}
        want_counts.update(corner_hop=count, corner_hop_bwd=count)
        if counts != want_counts:
            raise AssertionError(f"m2g on {count} bands: launches {counts}")
        m2g_fwd = compare(f"m2g on {count} bands", got.detach(), m2g_want.detach())
        m2g_grad = max(compare(f"m2g on {count} bands: grad {i}", a, b, GRAD_TOL)
                       for i, (a, b) in enumerate(zip(got_grads, m2g_want_grads)))
        rows.append({"bands": count, "band_rows": grid[0] // count,
                     "g2m_forward_max_abs_err": g2m_fwd, "g2m_grad_max_abs_err": g2m_grad,
                     "m2g_forward_max_abs_err": m2g_fwd, "m2g_grad_max_abs_err": m2g_grad,
                     "launches": counts})
        del lats, got, got_grads
    return {"model": "GraphLAM", "grid": list(grid), "level0": list(level0), "rows": rows}


@contextlib.contextmanager
def _recorded_kernel_c(calls: list):
    """Kernel c's custom ops (``p4t::short_kv_attention_fwd`` and
    ``_bwd``, as the wrappers call them) record each call's arguments
    and outputs in ``calls`` while the body runs."""
    from py4cast_tpu_torch.ops import attention

    saved = attention.short_kv_attention_fwd, attention.short_kv_attention_bwd

    def recording(kind, op):
        def call(*args):
            out = op(*args)
            calls.append((kind, [a.detach() if torch.is_tensor(a) else a for a in args],
                          [t.detach() for t in out]))
            return out
        return call

    attention.short_kv_attention_fwd = recording("fwd", saved[0])
    attention.short_kv_attention_bwd = recording("bwd", saved[1])
    try:
        yield
    finally:
        attention.short_kv_attention_fwd, attention.short_kv_attention_bwd = saved


def _kernel_c_vs_plain(calls: list) -> dict:
    """Each recorded launch of kernel c against its plain version on its
    own inputs: c-fwd's o and lse within TOL of scale, c-bwd's dq, dk
    and dv within GRAD_TOL. Returns the largest errors and the launch
    shapes (BH, Lq, Lk, D)."""
    from py4cast_tpu_torch.ops.attention import (
        short_kv_attention_bwd_plain,
        short_kv_attention_plain,
    )

    errs, shapes = {"fwd": 0.0, "bwd": 0.0}, set()
    for kind, args, out in calls:
        q, k, v = args[:3]
        scale = args[-1]
        shapes.add((kind, *q.shape, k.shape[1]))
        if kind == "fwd":
            s = torch.einsum("bqd,bkd->bqk", q, k) * scale
            want = [short_kv_attention_plain(q, k, v, scale), torch.logsumexp(s, dim=-1)]
            tol = TOL
        else:
            dq, dk, dv = short_kv_attention_bwd_plain(q, k, v, args[5], scale)
            want, out, tol = [dq, dk, dv], [out[0], out[1][0], out[1][1]], GRAD_TOL
        errs[kind] = max(errs[kind], max(compare(f"kernel c-{kind} at {tuple(q.shape)} vs plain",
                                                 a, b, tol) for a, b in zip(out, want)))
    return {"c_fwd_max_abs_err_vs_plain": errs["fwd"], "c_bwd_max_abs_err_vs_plain": errs["bwd"],
            "launch_shapes": sorted(list(t) for t in shapes)}


def _piece_on_bands(name: str, op, x, g, params, count: int) -> dict:
    """``op`` (a module's own band code) on ``count`` bands of ``x`` run
    together in this process (``testing.run_on_bands``: each exchange fed
    what the other bands send), against the whole-grid call: the bands'
    outputs within TOL of scale, the gradients of x and of every
    parameter (summed over the bands) within GRAD_TOL. Each launch of
    kernel c in the bands' run is counted and held against its plain
    version."""
    from py4cast_tpu_torch.testing import run_on_bands

    leaves = [x, *params]
    want = op(x)
    want_grads = _grads(want, g, leaves)
    want = want.detach()
    calls = []

    def band_step(band):
        out = op(band.cut(x, 1))
        return out.detach(), _grads(out, band.cut(g, 1), leaves)

    def before_last():
        reset_counts()
        calls.clear()

    t0 = time.perf_counter()
    with _recorded_kernel_c(calls):
        results = run_on_bands(band_step, count, before_last)
    torch.cuda.synchronize()
    counts = read_counts()
    row = {"bands": count, "band_rows": x.shape[1] // count, "launches": counts,
           "wall_s": time.perf_counter() - t0,
           "forward_max_abs_err": compare(f"{name} on {count} bands",
                                          torch.cat([r[0] for r in results], dim=1), want),
           "grad_max_abs_err": max(
               compare(f"{name} on {count} bands: grad {i}", sum(r[1][i] for r in results), w,
                       GRAD_TOL) for i, w in enumerate(want_grads))}
    row.update(_kernel_c_vs_plain(calls))
    return row


def attention_band_pieces(rng, grid=(512, 640)) -> dict:
    """Phase 21 (a), the attention models: at ``grid`` and each yaml's
    width, on 2 and on 4 bands (``_piece_on_bands``), forward and
    backward: Segformer's stage-1 ``EfficientSelfAttention`` (dim 32, one
    head, K/V reduced x8: the band's queries against the 320 keys
    gathered from every band), UNetRPP's stage-0 ``EPABlock`` (dim 128,
    16 heads, 64 projected tokens, ``attention_code: flash_attn``: token
    sums all-reduced, the band's queries against the whole projected
    K/V, its convs on halo rows) and a shifted ``SwinBlock`` of stage 0
    (dim 24, 3 heads, window 7: the lat roll across the bands, each
    band's windows of the shift mask) on the stage-0 tokens of the lat
    that a band count pads 512 rows to (672 at 2 bands, 896 at 4).
    c-fwd and c-bwd launch once a band each, at the band's shape."""
    from py4cast_tpu_torch.models.segformer import EfficientSelfAttention
    from py4cast_tpu_torch.models.swin import SwinStage
    from py4cast_tpu_torch.models.unetrpp import EPABlock
    from py4cast_tpu_torch.training import init_weights

    def drawn(module):
        module = module.cuda()
        init_weights(module, torch.Generator(device="cuda").manual_seed(0))
        return module

    h, w = grid[0] // 4, grid[1] // 4
    seg = drawn(EfficientSelfAttention(32, 1, 8))
    dims = UNETRPP_ARGS["hidden_size"] // 8
    epa = drawn(EPABlock(dims, UNETRPP_ARGS["num_heads_encoder"],
                         UNETRPP_ARGS["encoder_proj_sizes"][0], h * w, kernel=True))
    out = {"grid": list(grid), "segformer": [], "unetrpp": [], "swinunetr": []}
    x_seg, g_seg = _rand(rng, 1, h, w, 32).requires_grad_(), _rand(rng, 1, h, w, 32)
    x_epa, g_epa = _rand(rng, 1, h, w, dims).requires_grad_(), _rand(rng, 1, h, w, dims)
    f, heads, ws = SWINUNETR_ARGS["feature_size"], SWINUNETR_ARGS["num_heads"][0], 7
    for count in BAND_COUNTS:
        row = _piece_on_bands("Segformer EfficientSelfAttention", seg, x_seg, g_seg,
                              list(seg.parameters()), count)
        want = {name: 0 for name in row["launches"]}
        want.update(short_kv_attention=count, short_kv_attention_bwd=count)
        if row["launches"] != want:
            raise AssertionError(f"Segformer attention on {count} bands: {row['launches']}")
        out["segformer"].append(row)
        row = _piece_on_bands("UNetRPP EPABlock", epa, x_epa, g_epa, list(epa.parameters()),
                              count)
        if row["launches"] != want:
            raise AssertionError(f"UNetRPP EPABlock on {count} bands: {row['launches']}")
        out["unetrpp"].append(row)
        # the lat a band count pads 512 rows to (lat_multiple = bands x
        # 7·2^4), halved by the patch embedding; the lon padded to the window
        lat = -(-grid[0] // (count * ws * 16)) * count * ws * 16
        hw = (lat // 2, -(-grid[1] // 2 // ws) * ws)
        stage = drawn(SwinStage(f, 2, heads, ws, 0.0, 0.0, (0.0, 0.0), hw))
        block = stage.SwinBlock_1

        def shifted(t, stage=stage, block=block):
            return block(t, stage._mask(t.shape[1], t.shape[2]))

        x_sw = _rand(rng, 1, *hw, f).requires_grad_()
        row = _piece_on_bands("shifted SwinBlock", shifted, x_sw, _rand(rng, 1, *hw, f),
                              list(block.parameters()), count)
        row["stage_hw"] = list(hw)
        out["swinunetr"].append(row)
        del stage, block, x_sw
    return out


def _shares_on_bands(name: str, fn, leaves, count: int) -> dict:
    """``fn(band)`` (a loss share of the band's rows, or None off a band:
    the whole grid's loss) on ``count`` bands run together in this
    process (``testing.run_on_bands``), against the whole grid: the
    shares summed within TOL of scale of the whole loss, the gradients
    of ``leaves`` summed over the bands within GRAD_TOL."""
    from py4cast_tpu_torch.parallel.spatial import halo_rows
    from py4cast_tpu_torch.testing import run_on_bands

    want = fn(None)
    want_grads = torch.autograd.grad(want.sum(), leaves)

    def band_step(band):
        share = fn(band)
        return share.detach(), torch.autograd.grad(share.sum(), leaves)

    def before_last():
        halo_rows.bytes = 0

    t0 = time.perf_counter()
    results = run_on_bands(band_step, count, before_last)
    torch.cuda.synchronize()
    return {"bands": count, "wall_s": time.perf_counter() - t0,
            "halo_bytes_a_band": halo_rows.bytes // count,
            "forward_max_abs_err": compare(f"{name} on {count} bands",
                                           sum(r[0] for r in results), want.detach()),
            "grad_max_abs_err": max(
                compare(f"{name} on {count} bands: grad {i}", sum(r[1][i] for r in results), w,
                        GRAD_TOL) for i, w in enumerate(want_grads))}


def resnet_band_pieces(rng, grid=(512, 640)) -> dict:
    """Phase 21 (a), the ResNet-encoder models, the perceptual loss and
    ``mask_ratio``, where (b) runs and with ``--spatial``: at ``grid`` and
    the yamls' widths, on 2 and on 4 bands run together in this process
    (``testing.run_on_bands``), forward and backward against the whole
    grid, in fp64 (a ReLU input within fp32 rounding of zero, or a near
    tie at the pool, would pass its gradient on one side alone; fp64
    holds the bands' arithmetic itself): the encoder's stem (67 inputs,
    the 7x7 stride-2 conv padded 3 on a (3, 2) halo, GroupNorm on band
    statistics, ReLU) and its -inf-padded 3x3 stride-2 max pool on a
    (1, 0) halo; ASPP at deeplabv3plus.yaml's width (512 -> 256, rates
    12/24/36) on the 16x20 deepest map, whose halos span several bands
    of 8 or 4 rows; ``PerceptualLossPy4Cast`` (its trained three scales)
    on 21 fields, the bands' shares summed against the whole loss, with
    the halo bytes a band received (fp64); and ``mask_blocks`` at ratio
    0.25 on the card's generator, the bands' masks bit for bit the whole
    grid's."""
    from py4cast_tpu_torch.losses import PerceptualLossPy4Cast
    from py4cast_tpu_torch.models.deeplab import ASPP
    from py4cast_tpu_torch.models.unet import ResNetEncoder, max_pool_3x3
    from py4cast_tpu_torch.rollout import mask_blocks
    from py4cast_tpu_torch.testing import run_on_bands, synthetic_dataset_info
    from py4cast_tpu_torch.training import init_weights

    def drawn(module):
        module = module.cuda()
        init_weights(module, torch.Generator(device="cuda").manual_seed(0))
        return module.double()

    def held(name, op, x, g, params, count):
        row = _piece_on_bands(name, op, x, g, params, count)
        if any(row.pop("launches").values()):
            raise AssertionError(f"{name} launched a hand kernel")
        for key in ("c_fwd_max_abs_err_vs_plain", "c_bwd_max_abs_err_vs_plain",
                    "launch_shapes"):
            row.pop(key)
        return row

    f64 = torch.float64
    encoder = drawn(ResNetEncoder(67, CUSTOMUNET_ARGS["encoder_name"], 1))

    def stem(t):
        return max_pool_3x3(torch.relu(encoder.stem_norm(encoder.stem_conv(t))))

    x_stem = _rand(rng, 1, *grid, 67).to(f64).requires_grad_()
    g_stem = _rand(rng, 1, grid[0] // 4, grid[1] // 4, 64).to(f64)
    aspp = drawn(ASPP(512, DEEPLAB_ARGS["decoder_channels"], (12, 24, 36)))
    deep = (grid[0] // 32, grid[1] // 32)
    x_aspp = _rand(rng, 1, *deep, 512).to(f64).requires_grad_()
    g_aspp = _rand(rng, 1, *deep, DEEPLAB_ARGS["decoder_channels"]).to(f64)
    info = synthetic_dataset_info(grid_shape=grid, weather_features=21, forcing_features=21)
    loss = PerceptualLossPy4Cast()
    loss.prepare(np.ones((*grid, 1), np.float32), info, info.output_feature_names)
    loss.kernels = [k.cuda().double() for k in loss.kernels]
    loss.biases = [b.cuda().double() for b in loss.biases]
    loss.stats = {k: v.cuda().double() for k, v in loss.stats.items()}
    pred = _rand(rng, 1, 1, *grid, 21).to(f64).requires_grad_()
    tgt = _rand(rng, 1, 1, *grid, 21).to(f64)

    def perceptual(band):
        p, t = (pred, tgt) if band is None else (band.cut(pred, 2), band.cut(tgt, 2))
        return loss(SimpleNamespace(array=p), SimpleNamespace(array=t), torch.ones_like(t))

    x_mask = _rand(rng, 1, *grid, 67) + 5.0
    out = {"grid": list(grid), "stem_and_pool": [], "aspp": [], "perceptual_loss": [],
           "mask_blocks": []}
    for count in BAND_COUNTS:
        out["stem_and_pool"].append(held("ResNet stem and max pool (fp64)", stem, x_stem, g_stem,
                                         list(encoder.stem_conv.parameters())
                                         + list(encoder.stem_norm.parameters()), count))
        out["aspp"].append(held("ASPP 12/24/36 on the 16x20 map (fp64)", aspp, x_aspp, g_aspp,
                                list(aspp.parameters()), count))
        out["aspp"][-1]["band_rows"] = deep[0] // count
        out["perceptual_loss"].append(_shares_on_bands(
            "PerceptualLossPy4Cast (fp64)", perceptual, [pred], count))
        want = mask_blocks(x_mask, torch.Generator(device="cuda").manual_seed(0), 0.25)
        got = torch.cat(run_on_bands(lambda band: mask_blocks(
            band.cut(x_mask, 1), torch.Generator(device="cuda").manual_seed(0), 0.25), count),
            dim=1)
        if not torch.equal(got, want):
            raise AssertionError(f"mask_blocks on {count} bands differs from the whole grid's")
        out["mask_blocks"].append({"bands": count, "bit_for_bit": True,
                                   "masked_share": float((want == 0).all(dim=-1).double().mean())})
    del encoder, aspp, x_stem, x_aspp, pred, tgt, x_mask
    return out


#: phase 21 (b)'s cells: model -> (grid, settings_init_args); the module
#: pads the lat to whole bands of what the model needs (SwinUNetR's
#: windows of 7: bands of a multiple of 7·2^4 rows, 512 rows to 672)
SPATIAL_CELLS = {"HalfUNet": ((512, 640), HALFUNET_ARGS),
                 "GraphLAM": ((500, 500), GRAPHLAM_ARGS),
                 "HiLAM": ((500, 500), GRAPHLAM_ARGS),
                 "Segformer": ((512, 640), SEGFORMER_ARGS),
                 "UNetRPP": ((512, 640), {**UNETRPP_ARGS, **FLASH_ATTN}),
                 "SwinUNetR": ((512, 640), SWINUNETR_ARGS),
                 "CustomUNet": ((512, 640), CUSTOMUNET_ARGS),
                 "DeepLabV3Plus": ((512, 640), DEEPLAB_ARGS)}
#: the cells' training settings beside the yamls' (CustomUNet trains
#: under the perceptual loss and block masks). SwinUNetR's one process
#: pads its lat to 672 rows as its S = 2 bands do (a multiple of 2 x 112):
#: its windows, norms and attention read the pad rows, so the bands give
#: one process's numbers on that padded grid, not on 512 rows
SPATIAL_CELL_SETTINGS = {"CustomUNet": {"losses": PERCEPTUAL_LOSSES, "mask_ratio": 0.25},
                         "SwinUNetR": {"lat_multiple": 224}}
#: the bars of phase 21's comparisons (losses relative, parameters over
#: each leaf's scale and in relative L2, gradients over the largest)
BARS = {"loss_rel_err": TOL, "param_max_err_over_scale": TOL, "param_rel_l2": TOL,
        "grad_max_err_over_largest": GRAD_TOL}
#: a bar widens to this many times what one process reads against itself
#: with cuDNN off (``noise_floor``) where that is more: AdamW's first
#: steps move an element by about the learning rate whatever its
#: gradient's size, so rounding that flips a gradient near zero moves it
#: apart by up to twice the rate, on one process as on the bands
NOISE_FACTOR = 4


def measures(want: dict, got: list) -> dict:
    """Three AdamW steps of ``got`` (``train_report``s: the ranks of a
    layout, or one other process) against one process's ``want``: the
    losses (relative), the parameters after the steps (the largest
    difference over each leaf's scale, and over every element in
    relative L2), the first step's gradients (the largest difference
    over the largest gradient; beside it, printed, their relative L2 and
    the share of their signs that flipped)."""
    loss_err = max(abs(a - b) / abs(b) for r in got for a, b in zip(r["losses"], want["losses"]))
    max_err, worst = max((float((r["params"][k] - v).abs().max()) / max(1.0, float(v.abs().max())),
                          k) for r in got for k, v in want["params"].items() if v.numel())
    flat = torch.cat([v.double().reshape(-1) for v in want["params"].values()])
    l2_err = max(float((torch.cat([r["params"][k].double().reshape(-1) for k in want["params"]])
                        - flat).norm() / flat.norm()) for r in got)
    g_one = torch.cat([v.double().reshape(-1) for v in want["grads"].values()])
    g_got = [torch.cat([r["grads"][k].double().reshape(-1) for k in want["grads"]]) for r in got]
    return {"loss_rel_err": loss_err, "param_max_err_over_scale": max_err, "param_worst": worst,
            "param_rel_l2": l2_err,
            "grad_max_err_over_largest": max(float((g - g_one).abs().max())
                                             for g in g_got) / float(g_one.abs().max()),
            "grad_rel_l2": max(float((g - g_one).norm() / g_one.norm()) for g in g_got),
            "grad_sign_flips": max(float(((g > 0) != (g_one > 0)).double().mean())
                                   for g in g_got)}


def broken(read: dict, floor: dict) -> list:
    """The ``BARS`` that ``read`` breaks, each widened to NOISE_FACTOR
    times ``floor``'s reading where that is more."""
    return [k for k, bar in BARS.items() if not read[k] <= max(bar, NOISE_FACTOR * floor[k])]


@contextlib.contextmanager
def halves_without_halo():
    """A planted band fault in one process: every stride-1 SAME conv and
    every explicitly padded conv (the ResNet encoder's) that reads
    neighbour rows runs on the two halves of its input's rows apart,
    each padded as a whole grid, as two bands whose halo exchange sent
    zeros."""
    from py4cast_tpu_torch.models.base import FlaxConv2d

    forward = FlaxConv2d.forward

    def cut(self, x):
        if ((not self.same or self.stride[0] == 1) and any(self.band_halo())
                and x.shape[1] % (2 * self.stride[0]) == 0):
            h = x.shape[1] // 2
            return torch.cat([forward(self, x[:, :h]), forward(self, x[:, h:])], dim=1)
        return forward(self, x)

    FlaxConv2d.forward = cut
    try:
        yield
    finally:
        FlaxConv2d.forward = forward


@contextlib.contextmanager
def cudnn_off():
    """Convolutions through PyTorch's own CUDA kernels, not cuDNN's:
    other algorithms, other rounding."""
    before = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = before


def one_and_its_floor(case: dict):
    """``train_report(**case)`` in this process, and the ``measures`` of
    the same run with cuDNN off against it: the noise floor."""
    from py4cast_tpu_torch.testing import train_report

    want = train_report(**case)
    with cudnn_off():
        other = train_report(**case)
    return want, measures(want, [other])


def spatial_case(name: str, batch_size: int) -> dict:
    grid, args = SPATIAL_CELLS[name]
    return {"model_name": name, "settings_init_args": args, "grid": list(grid),
            "batch_size": batch_size, "device": "cuda", **SPATIAL_CELL_SETTINGS.get(name, {})}


def noise_floor() -> dict:
    """Phase 21 (a), on every card count: what phase 21 (b)'s bars read
    between two runs of one process that only round differently, and
    for a band fault. For each ``SPATIAL_CELLS`` model, three AdamW
    steps of its cell (batch 1) in one process against the same with
    cuDNN off (the noise floor) and under ``halves_without_halo`` (the
    planted fault), each read by ``measures``. Wherever the fault moves
    the losses at all (the models with 3x3 convs), it must break the
    parameters' bar in relative L2, widened by the floor as (b) widens
    it."""
    from py4cast_tpu_torch.testing import train_report

    out = {}
    for name in SPATIAL_CELLS:
        case = spatial_case(name, 1)
        want, floor = one_and_its_floor(case)
        with halves_without_halo():
            fault = measures(want, [train_report(**case)])
        torch.cuda.empty_cache()
        fault["broken"] = broken(fault, floor)
        out[name] = {"cudnn_off": floor, "halves_without_halo": fault}
        log(f"phase 21 (a) {name} noise floor: {json.dumps(out[name])}")
    for name, row in out.items():
        fault = row["halves_without_halo"]
        if fault["loss_rel_err"] > 0 and "param_rel_l2" not in fault["broken"]:
            raise AssertionError(f"{name}: the planted band fault keeps within the parameters' "
                                 f"bar: {row}")
    return out


def spatial_ranks_vs_one(layout) -> dict:
    """Phase 21 (b): data x spatial NCCL ranks (one card each) against one
    process, three AdamW steps of each ``SPATIAL_CELLS`` model at its
    yaml's width (global batch: one sample a data rank), all run in one
    launch of the ranks, within ``BARS`` (each widened to NOISE_FACTOR
    times the cell's noise floor, one process against itself with cuDNN
    off, where that is more): losses, parameters after the steps and the
    first step's gradients as AdamW receives them (summed over the
    bands, averaged over the data ranks), which AdamW's steps cannot
    show the scale of; kernels a, b and c launched as often each step as
    one rank launches them. Per rank: host ms a step, peak memory and
    the bytes its halo exchanges, K/V gathers and rolls received a
    step."""
    from py4cast_tpu_torch.testing import run_ranks

    data, spatial = layout
    cases = [spatial_case(name, data) for name in SPATIAL_CELLS]
    one = [one_and_its_floor(case) for case in cases]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks("py4cast_tpu_torch.testing:train_reports", data * spatial,
                      {"cases": cases, "mesh": [data, spatial]}, device="cuda", timeout=600)
    wall = time.perf_counter() - t0
    out = {"layout": [data, spatial], "wall_s": wall, "cells": [], "failures": []}
    for i, (case, (want, floor)) in enumerate(zip(cases, one)):
        name = case["model_name"]
        got = [r[i] for r in ranks]
        read = measures(want, got)
        if broken(read, floor):
            out["failures"].append(f"{name} {layout}: {broken(read, floor)} {read}, "
                                   f"noise floor {floor}")
        for r in got:
            for step, (a, b) in enumerate(zip(r["launches"], want["launches"])):
                if a != b:
                    out["failures"].append(f"{name} {layout} rank {r['rank']} step {step}: "
                                           f"launches {a}, one process {b}")
        out["cells"].append({
            "model": name, "grid": case["grid"], "losses_one": want["losses"],
            "losses_ranks": got[0]["losses"], **read, "noise_floor": floor,
            "launches_a_step": want["launches"][-1],
            "one": {"host_ms": want["host_ms"], "peak_bytes": want["peak_bytes"]},
            "ranks": [{"rank": r["rank"], "host_ms": r["host_ms"], "peak_bytes": r["peak_bytes"],
                       **{k: r[k] for k in ("halo_bytes", "gather_bytes", "roll_bytes")}}
                      for r in got]})
    return out


def titan_halfunet(spatials, grid=(1791, 2801)) -> dict:
    """Phase 21 (b), four cards: one HalfUNet train step (halfunet.yaml:
    64 filters, depth 4) on the full-resolution Titan grid, lat padded to
    1792 (``lat_multiple`` 4), at each spatial extent of ``spatials`` (1
    in this process, more on that many NCCL ranks): the loss, host ms
    and each rank's peak memory."""
    from py4cast_tpu_torch.testing import run_ranks, train_report

    case = {"model_name": "HalfUNet", "settings_init_args": HALFUNET_ARGS, "grid": list(grid),
            "batch_size": 1, "steps": 1, "device": "cuda", "lat_multiple": 4}
    rows = []
    for sp in spatials:
        if sp == 1:
            reports = [train_report(**case)]
            torch.cuda.empty_cache()
        else:
            reports = run_ranks("py4cast_tpu_torch.testing:train_report", sp,
                                {**case, "mesh": [1, sp]}, device="cuda", timeout=600)
        rows.append({"spatial": sp, "loss": reports[0]["losses"][0],
                     "host_ms": [r["host_ms"][0] for r in reports],
                     "peak_bytes": [r["peak_bytes"] for r in reports],
                     "halo_bytes": [r["halo_bytes"][0] for r in reports]})
        if not np.isfinite(rows[-1]["loss"]):
            raise AssertionError(f"Titan HalfUNet at spatial {sp}: loss {rows[-1]['loss']}")
    losses = [r["loss"] for r in rows]
    if max(losses) - min(losses) > TOL * abs(losses[0]):
        raise AssertionError(f"Titan HalfUNet: losses {losses} differ across spatial extents")
    return {"grid": list(grid), "padded_lat": 1792, "rows": rows}


def spatial_phase(floor: bool = False) -> dict:
    """Phase 21, the spatial axis: (a) on every card count, the band
    pieces at full width fed by hand (``halfunet_band_block``,
    ``graph_band_hops``: b-fwd and b-bwd counted;
    ``attention_band_pieces``: c-fwd and c-bwd counted), and, where (b)
    runs or ``floor`` asks (``--spatial``), the ResNet encoder's stem and
    pool, ASPP, the perceptual loss and the block masks on bands
    (``resnet_band_pieces``) and the noise floor of (b)'s bars
    (``noise_floor``); (b) with two cards or
    more, S = 2 NCCL ranks against one, and with four, 2 x 2 against one
    (``spatial_ranks_vs_one``) and the Titan-size HalfUNet step
    (``titan_halfunet``); "not run, N card(s)" otherwise."""
    t21 = time.perf_counter()
    rng = np.random.default_rng(21)
    out = {"halfunet_bands": halfunet_band_block(rng)}
    log(f"phase 21 (a) HalfUNet bands: {json.dumps(out['halfunet_bands'])}")
    torch.cuda.empty_cache()
    out["graph_bands"] = graph_band_hops(rng)
    log(f"phase 21 (a) GraphLAM bands: {json.dumps(out['graph_bands'])}")
    torch.cuda.empty_cache()
    out["attention_bands"] = attention_band_pieces(rng)
    log(f"phase 21 (a) Segformer, UNetRPP and SwinUNetR bands: "
        f"{json.dumps(out['attention_bands'])}")
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    if floor or cards >= 2:
        out["resnet_bands"] = resnet_band_pieces(rng)
        log(f"phase 21 (a) ResNet stem and pool, ASPP, perceptual loss and mask_blocks bands: "
            f"{json.dumps(out['resnet_bands'])}")
        torch.cuda.empty_cache()
        out["noise_floor"] = noise_floor()
    else:
        log("phase 21 (a) ResNet, perceptual loss and mask_blocks bands, noise floor: not run, "
            "1 card (--spatial runs them)")
    out["ranks"] = []
    for layout in ((1, 2), (2, 2)):
        if cards >= layout[0] * layout[1]:
            row = spatial_ranks_vs_one(layout)
            out["ranks"].append(row)
            log(f"phase 21 (b) {layout[0]}x{layout[1]} NCCL ranks vs one: {json.dumps(row)}")
            if row["failures"]:
                raise AssertionError("; ".join(row["failures"]))
        else:
            log(f"phase 21 (b) {layout[0]}x{layout[1]}: not run, {cards} card(s)")
    if cards >= 4:
        out["titan"] = titan_halfunet((1, 2, 4))
        log(f"phase 21 (b) Titan HalfUNet: {json.dumps(out['titan'])}")
    else:
        log(f"phase 21 (b) Titan HalfUNet at spatial 1, 2, 4: not run, {cards} card(s)")
    out["wall_s"] = time.perf_counter() - t21
    log(f"phase 21 wall: {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------------ phase 22
#: phase 22's trees, written afresh under build/ and deleted after
SMOKE_TREES = BUILD / "smoke_data" / "trees"
#: the Titan, Poesy and Rainfall model configs phase 22 runs: the yamls'
#: widths (halfunet.yaml, graphlam.yaml)
TITAN_MODELS = ("halfunet", "graphlam")
#: the Titan loader's steady window: batches skipped (the prefetch's
#: start-up), then batches timed
LOADER_WINDOW = (2, 10)


def _titan_smoke_conf() -> dict:
    """TitanAccessor.default_config() with its periods narrowed to 12
    hours of files: the train day's hours 0-7 (7 samples of titan.yaml's
    1 + 1 steps) and hours 0, 1, 3 and 4 of the next day for valid and
    test (a t0 every 3 hours: 2 samples each). Grid, subdomain and the
    37 fields stay as they are."""
    from py4cast_tpu_torch.datasets.titan import TitanAccessor

    conf = TitanAccessor.default_config()
    day2 = {"start": 20230102, "end": 20230102, "obs_step": 3600, "obs_step_btw_t0": 10800}
    conf["periods"] = {"train": {"start": 20230101, "end": 20230101, "obs_step": 3600},
                       "valid": day2, "test": dict(day2)}
    return conf


def _titan_dates():
    import datetime as dt

    return ([dt.datetime(2023, 1, 1, h) for h in range(8)]
            + [dt.datetime(2023, 1, 2, h) for h in (0, 1, 3, 4)])


def _numpy_titan():
    """TitanAccessor reading each file with np.load, one param at a time
    (no fused read, no C++ reader): the plain version of the reader."""
    from py4cast_tpu_torch.datasets.titan import TitanAccessor

    class NumpyTitan(TitanAccessor):
        @classmethod
        def file_paths_for(cls, *args, **kwargs):
            return None

        @classmethod
        def load_data_from_disk(cls, dataset_name, param, timestamps, member=0,
                                file_format="npy"):
            paths = TitanAccessor.file_paths_for(dataset_name, param, timestamps, member, "npy")
            return np.stack([np.load(p) for p in paths])[..., None]

    return NumpyTitan()


def _with_accessor(ds, accessor):
    """A shallow copy of dataset ``ds`` whose samples read through
    ``accessor``."""
    import copy

    out = copy.copy(ds)
    out.accessor = accessor
    out.__dict__.pop("sample_list", None)
    return out


def _repeated(ds, times: int):
    """A shallow copy of dataset ``ds`` whose samples are its own
    ``times`` over, in order: a window long enough for a steady rate."""
    import copy

    out = copy.copy(ds)
    out.__dict__["sample_list"] = list(ds.sample_list) * times
    return out


def _loader_ms(ds, batch_size: int, num_workers: int, skip: int, n: int) -> float:
    """ms a batch of ``ds``'s unshuffled loader in its steady state: the
    time from the ``skip``-th batch to the ``skip + n``-th, over ``n`` (the
    prefetch's start-up, in the first batches, left out)."""
    it = iter(ds.loader(batch_size=batch_size, num_workers=num_workers))
    for _ in range(skip):
        next(it)
    t0 = time.perf_counter()
    for _ in range(n):
        next(it)
    return (time.perf_counter() - t0) * 1e3 / n


def _dataset_cli(*args) -> str:
    """The port's dataset CLI in-process; its standard output, echoed."""
    import contextlib
    import io

    from py4cast_tpu_torch.datasets import dataset_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dataset_cli.main(list(args))
    if rc != 0:
        raise AssertionError(f"dataset_cli {' '.join(args)}: exit {rc}")
    text = buf.getvalue()
    for line in text.splitlines()[-4:]:
        log(f"  dataset_cli {args[1]}: {line}")
    return text


def titan_data(conf_path: Path) -> dict:
    """Phase 22 (a): the Titan tree at the default configuration, the
    port's dataset CLI on it (prepare with the statistics, describe,
    speedtest), and the steady ms a batch of titan.yaml's loader (batch
    2, 10 workers; ``LOADER_WINDOW``, over the train samples repeated)
    through the C++ reader and through per-file numpy reads, in the
    order C++, numpy, numpy, C++ (warm page cache: the files were just
    written)."""
    from py4cast_tpu_torch.datasets import get_datasets
    from py4cast_tpu_torch.datasets.synthetic_trees import titan_fields, write_titan_tree

    conf = _titan_smoke_conf()
    conf_path.write_text(json.dumps(conf))
    fields = titan_fields(conf)
    t0 = time.perf_counter()
    sub = conf["grid"]["subdomain"]
    files = write_titan_tree(SMOKE_TREES / "titan",
                             f"titan_aro_arp_{conf['grid']['name']}_{'-'.join(map(str, sub))}",
                             fields, _titan_dates(), (sub[1] - sub[0], sub[3] - sub[2]), seed=22)
    write_s = time.perf_counter() - t0
    n_bytes = sum(p.stat().st_size for p in files)
    common = ["--dataset-conf", str(conf_path), "--num-input-steps", "1"]
    t0 = time.perf_counter()
    _dataset_cli("titan_aro_arp", "prepare", *common)
    prepare_s = time.perf_counter() - t0
    described = _dataset_cli("titan_aro_arp", "describe", *common)
    if "Summarizing titan_aro_arp_PAAROME_1S40" not in described:
        raise AssertionError("dataset_cli describe printed no summary")
    speed = _dataset_cli("titan_aro_arp", "speedtest", *common, "--batch-size", "2",
                         "--num-workers", "10", "--n-iter", "3")
    speed_ms = float(re.search(r"ms a batch: ([0-9.]+)", speed).group(1))

    train = get_datasets("titan_aro_arp", 1, 1, 1, dataset_conf=str(conf_path))[0]
    plain = _with_accessor(train, _numpy_titan())
    skip, n = LOADER_WINDOW
    times = -(-2 * (skip + n) // len(train))
    loaders = {"cpp": _repeated(train, times), "numpy": _repeated(plain, times)}
    reads = {"cpp": [], "numpy": []}
    for which in ("cpp", "numpy", "numpy", "cpp"):
        reads[which].append(_loader_ms(loaders[which], 2, 10, skip, n))
    item, want = train[0], plain[0]
    for attr in ("inputs", "outputs", "forcing"):
        if not np.array_equal(getattr(item, attr).array, getattr(want, attr).array):
            raise AssertionError(f"Titan item {attr}: the fused C++ read differs from numpy's")
    return {**titan_sample_breakdown(train.sample_list[0]), "fields": len(fields),
            "grid": list(train.grid_shape), "hours": len(_titan_dates()),
            "files": len(files), "bytes": n_bytes, "write_s": write_s,
            "prepare_s": prepare_s, "train_samples": len(train),
            "speedtest_ms_a_batch": speed_ms, "batches_skipped": skip, "batches_timed": n,
            "loader_ms_a_batch_cpp": reads["cpp"], "loader_ms_a_batch_numpy": reads["numpy"],
            "batch": 2, "workers": 10, "page_cache": "warm"}


def titan_sample_breakdown(sample, reps: int = 3) -> dict:
    """Where one Titan sample's load goes, host ms (medians of ``reps``):
    the C++ reader alone on the sample's files, the fused read with the
    standardization (``_batched_param_arrays``), the whole ``load`` (the
    features concatenated, the forcings generated), and numpy's np.load
    of the same files."""
    from py4cast_tpu_torch.native import read_npy_float32_batch

    paths = [q for prm in sample.params for q in sample.accessor.file_paths_for(
        sample.settings.dataset_name, prm, sample._param_stamps(prm), sample.member, "npy")]
    shape = np.load(paths[0], mmap_mode="r").shape
    calls = {"read_ms": lambda: read_npy_float32_batch(paths, shape),
             "numpy_read_ms": lambda: [np.load(q) for q in paths],
             "read_and_standardize_ms": lambda: sample._batched_param_arrays(True),
             "load_ms": sample.load}
    out = {"sample_files": len(paths)}
    for key, fn in calls.items():
        out[key] = float(np.median(_timed(fn, reps)))
    return out


def titan_step_checks(model_yaml: str, conf_path: Path) -> dict:
    """Phase 22 (b), in-process beside the CLI: the first train batch on
    the card equals the numpy item bit for bit; the first step's loss on
    the card within TOL of the CPU's for the same params and batch, and
    its gradients held against the CPU's (``titan_grads_vs_cpu``); host
    ms a train step, loader ms a batch, ``_to_device`` ms of a batch and
    peak memory (3 AdamW steps on that batch after one warm-up)."""
    import yaml

    from py4cast_tpu_torch.datasets import get_datasets
    from py4cast_tpu_torch.training import AutoRegressiveModule, TrainingSettings

    model = yaml.safe_load((ROOT / f"config/CLI/model/{model_yaml}.yaml").read_text())["model"]
    model["betas"] = tuple(model["betas"])
    train = get_datasets("titan_aro_arp", 1, 1, 1, dataset_conf=str(conf_path))[0]
    settings = TrainingSettings(**model, num_input_steps=1, num_pred_steps_train=1,
                                num_pred_steps_val_test=1)
    t0 = time.perf_counter()
    loader = iter(train.loader(batch_size=2, num_workers=10))
    batch = next(loader)
    loader_ms = [(time.perf_counter() - t0) * 1e3]
    for _ in range(2):
        t0 = time.perf_counter()
        next(loader)
        loader_ms.append((time.perf_counter() - t0) * 1e3)
    del loader
    plain = _with_accessor(train, _numpy_titan())
    module = AutoRegressiveModule(settings, train.dataset_info, device="cuda")
    torch.cuda.synchronize()
    copy_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        on_card = {a: module._to_device(getattr(batch, a).array)
                   for a in ("inputs", "forcing", "outputs")}
        torch.cuda.synchronize()
        copy_ms.append((time.perf_counter() - t0) * 1e3)
    for a, t in on_card.items():
        want = np.stack([getattr(plain[i], a).array for i in range(2)])
        got = t.cpu().numpy().reshape(want.shape)
        if not np.array_equal(got, want):
            raise AssertionError(f"{model_yaml}: the batch's {a} on the card is not the numpy item")
    del on_card

    state = module.init_state(torch.Generator().manual_seed(0), num_training_steps=4)
    params = {k: v.detach().cpu().clone() for k, v in state.params.items()}
    loss_card, grads = module.loss_and_grads(params, batch)
    cpu = AutoRegressiveModule(settings, train.dataset_info, device="cpu")
    loss_cpu, grads_cpu = cpu.loss_and_grads(params, batch)
    rel = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    if not rel <= TOL or not all(bool(torch.isfinite(g).all()) for g in grads.values()):
        raise AssertionError(f"{model_yaml} Titan step 1: loss card {float(loss_card)} vs "
                             f"cpu {float(loss_cpu)} (rel {rel:.2e}) or non-finite gradients")
    grad = titan_grads_vs_cpu(model_yaml, grads, grads_cpu)
    del grads, grads_cpu, cpu
    module.train_step(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        loss = module.train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not np.isfinite(float(loss)):
        raise AssertionError(f"{model_yaml} Titan train step: loss {float(loss)}")
    return {"batch_equals_numpy_item": True, "loss_card": float(loss_card),
            "loss_cpu": float(loss_cpu), "loss_rel_diff": rel, **grad, "host_ms_a_step": step_ms,
            "loader_ms_a_batch": loader_ms, "to_device_ms_a_batch": copy_ms,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def titan_grads_vs_cpu(model_yaml: str, card: dict, cpu: dict) -> dict:
    """The first Titan step's gradients on the card against the CPU's
    (where the kernel wrappers run their plain versions), as phase 21 (b)
    holds its gradients: GraphLAM's (a-bwd and b-bwd at 512x640) each
    leaf within GRAD_TOL of the largest CPU gradient; HalfUNet's, for
    cuDNN's per-shape algorithms and the ReLU kinks, by the ratio of the
    norms within GRAD_TOL of 1. The worst leaf, the relative L2 and the
    norm ratio are printed beside, whichever is held."""
    largest = max(float(g.abs().max()) for g in cpu.values())
    errs = {k: float((card[k].cpu().double() - g.double()).abs().max()) for k, g in cpu.items()}
    worst = max(errs, key=errs.get)
    flat_card = torch.cat([card[k].cpu().double().reshape(-1) for k in cpu])
    flat_cpu = torch.cat([g.double().reshape(-1) for g in cpu.values()])
    out = {"grad_worst_leaf": worst, "grad_max_err_over_largest": errs[worst] / largest,
           "grad_rel_l2": float((flat_card - flat_cpu).norm() / flat_cpu.norm()),
           "grad_norm_ratio_off_1": abs(float(flat_card.norm() / flat_cpu.norm()) - 1.0),
           "grad_held_by": ("norm ratio" if model_yaml == "halfunet" else "max over largest")}
    held = out["grad_norm_ratio_off_1" if model_yaml == "halfunet" else
               "grad_max_err_over_largest"]
    if not held <= GRAD_TOL:
        raise AssertionError(f"{model_yaml} Titan step 1 gradients, card vs CPU: {out}")
    return out


def titan_cli(model_yaml: str, conf_path: Path) -> dict:
    """Phase 22 (b): the port's CLI on the Titan tree, fp32, with
    trainer.yaml, titan.yaml (``data.dataset_conf`` the conf's JSON) and
    the model's yaml: fit (3 optimizer steps, 1 validation batch), then
    test and predict from its checkpoint (the manifest's contract checked
    against the dataset), each counted; the predictions written and
    read back."""
    import shutil
    from types import SimpleNamespace

    import yaml

    from py4cast_tpu_torch import cli
    from py4cast_tpu_torch.models import get_model_kls_and_settings

    save = BUILD / f"smoke_titan_{model_yaml}"
    shutil.rmtree(save, ignore_errors=True)
    configs = ["--config", str(ROOT / "config/CLI/trainer.yaml"),
               "--config", str(ROOT / "config/CLI/dataset/titan.yaml"),
               "--config", str(ROOT / f"config/CLI/model/{model_yaml}.yaml"),
               "--data.dataset_conf", str(conf_path), "--trainer.save_path", str(save)]
    extra = {"fit": ["--trainer.max_epochs", "1", "--trainer.limit_train_batches", "3",
                     "--trainer.limit_val_batches", "1"],
             "test": ["--trainer.ckpt_path", "last"], "predict": ["--trainer.ckpt_path", "last"]}
    model = yaml.safe_load((ROOT / f"config/CLI/model/{model_yaml}.yaml").read_text())["model"]
    _, ms = get_model_kls_and_settings(model["model_name"], dict(model["settings_init_args"]))
    counted = SimpleNamespace(settings=SimpleNamespace(model_name=model["model_name"]),
                              model_settings=ms)
    # 1 + 1 steps, batch 2: 3 train steps and 1 validation batch; the 2
    # test samples are 1 batch for test and for predict
    calls = {"fit": (3 + 1, 3), "test": (1, 0), "predict": (1, 0)}
    out = {"launches": {}, "seconds": {}}
    for sub in ("fit", "test", "predict"):
        reset_counts()
        t0 = time.perf_counter()
        if cli.main([sub, *configs, *extra[sub]]) != 0:
            raise AssertionError(f"cli {sub} on Titan with {model_yaml}.yaml failed")
        torch.cuda.synchronize()
        out["seconds"][sub] = time.perf_counter() - t0
        out["launches"][sub] = read_counts()
        want = expected_launches(counted, *calls[sub])
        if out["launches"][sub] != want:
            raise AssertionError(f"cli {sub} Titan {model_yaml}: launches "
                                 f"{out['launches'][sub]}, expected {want}")
    manifest = json.loads((save / "checkpoints" / "manifest.json").read_text())
    scores = json.loads((save / "test_scores.json").read_text())
    preds = [np.load(p) for p in sorted((save / "predictions").glob("batch_*.npy"))]
    grid = tuple(manifest["grid_shape"])
    spatial = (grid[0] * grid[1],) if model["model_name"] == "GraphLAM" else grid
    if (len(preds) != 1 or preds[0].shape != (2, 1, *spatial, 21)
            or not np.isfinite(preds[0]).all() or not np.isfinite(scores["test_mean_loss"])):
        raise AssertionError(f"Titan {model_yaml} outputs: {[p.shape for p in preds]}, "
                             f"scores {scores}")
    out.update(model=model["model_name"], test_mean_loss=scores["test_mean_loss"],
               prediction_files=len(preds), prediction_shape=list(preds[0].shape),
               manifest_grid=manifest["grid_shape"],
               manifest_features=len(manifest["output_feature_names"]))
    return out


def _recording_loads(into: list):
    """A Sample.load that records each sample's (t0, member) in ``into``."""
    from py4cast_tpu_torch.datasets.base import Sample

    load = Sample.load

    def recording(self, *args, **kwargs):
        into.append((self.timestamps.datetime.isoformat(), int(self.member)))
        return load(self, *args, **kwargs)

    return load, recording


def poesy_members(conf_path: Path) -> dict:
    """Phase 22 (c): Poesy at its real DATA_SHAPE (600 x 600 x 45
    leadtimes x 16 members; one run, t2m and u10: two 1.04 GB files
    written through open_memmap in slabs), members 0 and 3; HalfUNet at
    halfunet.yaml's width: prepare, fit (2 steps of batch 2), test and
    predict; the members each loaded, scored and exported."""
    import datetime as dt

    from py4cast_tpu_torch.datasets import get_datasets
    from py4cast_tpu_torch.datasets.base import Sample
    from py4cast_tpu_torch.datasets.poesy import DATA_SHAPE, PoesyAccessor
    from py4cast_tpu_torch.datasets.synthetic_trees import write_poesy_tree
    from py4cast_tpu_torch.training import AutoRegressiveModule, Trainer, TrainerConfig

    t0 = time.perf_counter()
    files = write_poesy_tree(SMOKE_TREES / "poesy", DATA_SHAPE, [dt.datetime(2021, 6, 1)],
                             variables=("t2m", "u10"), seed=22)
    write_s = time.perf_counter() - t0
    conf = PoesyAccessor.default_config()

    def leadtimes(first, last):
        return {"start": 20210601, "end": 20210601, "refcst_daily_runs": [0],
                "refcst_leadtime_start_in_sec": 3600 * first,
                "refcst_leadtime_end_in_sec": 3600 * (last + 1),
                "refcst_leadtime_step_in_sec": 3600}

    conf["periods"] = {"train": leadtimes(1, 2), "valid": leadtimes(3, 3),
                       "test": leadtimes(4, 4)}
    conf["members"] = [0, 3]
    conf["params"] = {k: v for k, v in conf["params"].items() if k in ("t2m", "u10")}
    conf_path.write_text(json.dumps(conf))
    t0 = time.perf_counter()
    _dataset_cli("poesy", "prepare", "--dataset-conf", str(conf_path))
    prepare_s = time.perf_counter() - t0
    train_ds, val_ds, test_ds = get_datasets("poesy", 1, 1, 1, dataset_conf=str(conf_path))
    t0 = time.perf_counter()
    train_ds[0]
    load_ms = (time.perf_counter() - t0) * 1e3
    settings = model_settings("HalfUNet", num_warmup_steps=2, num_pred_steps_train=1,
                              num_pred_steps_val_test=1, num_input_steps=1)
    module = AutoRegressiveModule(settings, train_ds.dataset_info, device="cuda")
    trainer = Trainer(TrainerConfig(max_epochs=1, check_val_every_n_epoch=2, batch_size=2,
                                    num_workers=2, logging_enabled=False, device="cuda",
                                    save_path=str(BUILD / "smoke_poesy")))
    seen = {"fit": [], "test": [], "predict": []}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for what in seen:
        load, recording = _recording_loads(seen[what])
        Sample.load = recording
        try:
            if what == "fit":
                state = trainer.fit(module, train_ds, val_ds)
            elif what == "test":
                scores = trainer.test(module, test_ds, state)
            else:
                preds = trainer.predict(module, test_ds, state)
        finally:
            Sample.load = load
    counts = read_counts()
    if counts != expected_launches(module, 0, 0):
        raise AssertionError(f"Poesy HalfUNet launched {counts}")

    def keys(ds):
        return {(s.timestamps.datetime.isoformat(), int(s.member)) for s in ds.sample_list}

    members = {what: sorted({m for _, m in seen[what]}) for what in seen}
    rows = sum(p.array.shape[0] for p in preds)
    if (state.step != 2 or set(seen["fit"]) != keys(train_ds) or set(seen["test"]) != keys(test_ds)
            or set(seen["predict"]) != keys(test_ds) or rows != len(test_ds)
            or any(m != [0, 3] for m in members.values())
            or not np.isfinite(scores["test_mean_loss"])
            or not all(np.isfinite(p.array).all() for p in preds)):
        raise AssertionError(f"Poesy members: steps {state.step}, seen {seen}, rows {rows}, "
                             f"scores {scores}")
    return {"data_shape": list(DATA_SHAPE), "files": len(files),
            "bytes": sum(p.stat().st_size for p in files), "write_s": write_s,
            "prepare_s": prepare_s, "sample_load_ms": load_ms, "grid": list(train_ds.grid_shape),
            "members_trained": members["fit"], "members_scored": members["test"],
            "members_exported": members["predict"], "optimizer_steps": state.step,
            "test_mean_loss": scores["test_mean_loss"], "prediction_rows": rows,
            "prediction_shape": list(preds[0].array.shape),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def rainfall_run(conf_path: Path) -> dict:
    """Phase 22 (d): a dozen 1536 x 1536 radar files (5 minutes apart,
    npz stored without compression: zlib would take most of the phase),
    Rainfall's default configuration narrowed to their hour and
    rainfall.yaml's steps (2 inputs, 1 AR step to train, 3 to predict):
    prepare, one HalfUNet fit step at halfunet.yaml's width and one
    sample's predict, the peak memory of each."""
    import datetime as dt

    from py4cast_tpu_torch.datasets import get_datasets
    from py4cast_tpu_torch.datasets.rainfall import RainfallAccessor
    from py4cast_tpu_torch.datasets.synthetic_trees import write_rainfall_tree
    from py4cast_tpu_torch.training import AutoRegressiveModule, Trainer, TrainerConfig

    t0 = time.perf_counter()
    write_rainfall_tree(SMOKE_TREES / "rainfall", dt.datetime(2023, 6, 1), 12, (1536, 1536),
                        seed=22, compressed=False)
    write_s = time.perf_counter() - t0
    conf = RainfallAccessor.default_config()
    day = {"start": 20230601, "end": 20230601, "obs_step": 300}
    conf["periods"] = {"train": day, "valid": dict(day), "test": dict(day)}
    conf_path.write_text(json.dumps(conf))
    steps = ["--num-input-steps", "2", "--num-pred-steps-val-test", "3"]
    t0 = time.perf_counter()
    _dataset_cli("rainfall", "prepare", "--dataset-conf", str(conf_path), *steps)
    prepare_s = time.perf_counter() - t0
    train_ds, val_ds, test_ds = get_datasets("rainfall", 2, 1, 3, dataset_conf=str(conf_path))
    settings = model_settings("HalfUNet", num_warmup_steps=2, num_pred_steps_train=1,
                              num_pred_steps_val_test=3, num_input_steps=2)
    module = AutoRegressiveModule(settings, train_ds.dataset_info, device="cuda")
    trainer = Trainer(TrainerConfig(max_epochs=1, check_val_every_n_epoch=2, batch_size=1,
                                    limit_train_batches=1, num_workers=2, logging_enabled=False,
                                    device="cuda", save_path=str(BUILD / "smoke_rainfall")))
    first = test_ds.sample_list[0]
    one = test_ds.filter_samples(lambda s: s is first)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.fit(module, train_ds, val_ds)
    torch.cuda.synchronize()
    fit_s, fit_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (pred,) = trainer.predict(module, one, state)
    torch.cuda.synchronize()
    predict_s, predict_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    if read_counts() != expected_launches(module, 0, 0):
        raise AssertionError(f"Rainfall HalfUNet launched {read_counts()}")
    if (state.step != 1 or pred.array.shape != (1, 3, *train_ds.grid_shape, 1)
            or not np.isfinite(pred.array).all()):
        raise AssertionError(f"Rainfall: step {state.step}, prediction {pred.array.shape}")
    return {"grid": list(train_ds.grid_shape), "files": 12, "write_s": write_s,
            "prepare_s": prepare_s, "train_samples": len(train_ds), "fit_s": fit_s,
            "fit_peak_bytes": fit_peak, "predict_s": predict_s, "predict_peak_bytes": predict_peak,
            "prediction_shape": list(pred.array.shape)}


def datasets_phase() -> dict:
    """Phase 22, the datasets: (a) Titan at its default configuration
    (``titan_data``); (b) the CLI's fit, test and predict on it with
    halfunet.yaml and graphlam.yaml, and the in-process checks of
    ``titan_step_checks``; (c) Poesy's members (``poesy_members``); (d)
    Rainfall (``rainfall_run``). The accessors read trees under
    ``SMOKE_TREES``, whatever the environment names, and the trees are
    deleted after."""
    import shutil

    import py4cast_tpu_torch.datasets.poesy as poesy
    import py4cast_tpu_torch.datasets.rainfall as rainfall
    import py4cast_tpu_torch.datasets.titan as titan

    t22 = time.perf_counter()
    shutil.rmtree(SMOKE_TREES, ignore_errors=True)
    SMOKE_TREES.mkdir(parents=True)
    roots = [(titan, "TITAN_PATH", SMOKE_TREES / "titan"),
             (poesy, "POESY_PATH", SMOKE_TREES / "poesy"),
             (poesy, "CACHE_DIR", SMOKE_TREES / "cache"),
             (rainfall, "RAINFALL_PATH", SMOKE_TREES / "rainfall")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in roots]
    for mod, attr, path in roots:
        setattr(mod, attr, path)
    try:
        titan_conf = SMOKE_TREES / "titan_aro_arp.json"
        out = {"card": card_line(), "titan": titan_data(titan_conf)}
        log(f"phase 22 (a) Titan data: {json.dumps(out['titan'])}")
        for model_yaml in TITAN_MODELS:
            row = titan_cli(model_yaml, titan_conf)
            row["steps"] = titan_step_checks(model_yaml, titan_conf)
            out[f"titan_{model_yaml}"] = row
            log(f"phase 22 (b) Titan {model_yaml}: {json.dumps(row)}")
            torch.cuda.empty_cache()
        out["poesy"] = poesy_members(SMOKE_TREES / "poesy.json")
        log(f"phase 22 (c) Poesy: {json.dumps(out['poesy'])}")
        torch.cuda.empty_cache()
        out["rainfall"] = rainfall_run(SMOKE_TREES / "rainfall.json")
        log(f"phase 22 (d) Rainfall: {json.dumps(out['rainfall'])}")
        torch.cuda.empty_cache()
    finally:
        for mod, attr, value in saved:
            setattr(mod, attr, value)
        shutil.rmtree(SMOKE_TREES, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t22
    log(f"phase 22 wall: {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------------ phase 23
#: the grid models phase 23 counts at 512x640 (UNetRPP with
#: attention_code pallas, which runs kernels c-fwd and c-bwd as the main
#: path's flash_attn does), and the graph models it counts at 500x500
FLOP_GRID_MODELS = {"HalfUNet": None, "Segformer": None,
                    "UNetRPP": {"attention_code": "pallas"}, "UNet": None, "CustomUNet": None,
                    "DeepLabV3": None, "DeepLabV3Plus": None, "SwinUNetR": None}
FLOP_GRAPH_MODELS = ("GraphLAM", "HiLAM", "HiLAMParallel")
#: the grid models phase 23 (a) exports at 512x640 and reloads: the
#: script's time limit leaves room for these three (the Dummy fits of
#: phases 6 to 19 check that every grid model's fit wrote its program)
EXPORT_MODELS = ("HalfUNet", "Segformer", "UNetRPP")
#: the models whose FLOPs phase 23 (b) also counts by a real call on the
#: card, which must equal the count under fake tensors
REAL_COUNT_MODELS = ("HalfUNet", "GraphLAM")
#: the reloaded program against the eager model, relative to its scale
EXPORT_RTOL = 1e-5
SMOKE_EXPORT = BUILD / "smoke_export"


def _flop_row(module, params, real: bool) -> dict:
    """FLOPs of one predict call (1 AR step) and one train step of
    ``module`` at its grid under fake tensors, each kernel's share, and
    with ``real`` the same counts from a real call on the card."""
    from py4cast_tpu_torch.ops import flops

    row = {}
    for kind, count in (("predict", flops.predict_flops), ("train_step", flops.train_step_flops)):
        t0 = time.perf_counter()
        by_op = count(module, params)
        row[kind] = {"flops": sum(by_op.values()), "by_op": by_op,
                     "kernel_shares": flops.kernel_shares(by_op),
                     "count_s": time.perf_counter() - t0}
        if real:
            t0 = time.perf_counter()
            on_card = count(module, params, fake=False)
            torch.cuda.synchronize()
            row[kind]["real_count_s"] = time.perf_counter() - t0
            if on_card != by_op:
                raise AssertionError(f"{module.settings.model_name} {kind} FLOPs: fake {by_op}, "
                                     f"a real call on the card {on_card}")
            row[kind]["real_call_equal"] = True
    return row


def export_and_reload(module, params, name: str) -> dict:
    """Phase 23 (a): ``export_forward`` (as ``Trainer._log_model`` calls
    it) of ``module``'s model at 512x640, batch 1, fp32; the program
    reloaded by ``load_and_infer`` and run against the eager model within
    EXPORT_RTOL of its scale, its kernel launches counted (one forward's);
    the file deleted after."""
    from py4cast_tpu_torch.export import export_forward, load_and_infer

    dest = SMOKE_EXPORT / f"{name}.pt2"
    t0 = time.perf_counter()
    export_forward(module.model, params, module.model.input_shape, dest)
    export_s = time.perf_counter() - t0
    size = dest.stat().st_size
    x = _rand(np.random.default_rng(23), 1, *module.model.input_shape,
              module.num_input_features)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    got = load_and_infer(dest, x)
    torch.cuda.synchronize()
    load_run_s = time.perf_counter() - t0
    counts = read_counts()
    dest.unlink()
    want = expected_launches(module, 1, 0)
    if counts != want:
        raise AssertionError(f"{name}: the reloaded program launched {counts}, expected {want}")
    from torch.func import functional_call

    with torch.no_grad():
        eager = functional_call(module.model, params, (x,))
    err = float((got.double() - eager.double()).abs().max())
    scale = float(eager.abs().max())
    if not (np.isfinite(err) and err <= EXPORT_RTOL * scale):
        raise AssertionError(f"{name}: reloaded program vs eager {err:.3e} > "
                             f"{EXPORT_RTOL:g} x {scale:.3g}")
    return {"export_s": export_s, "file_bytes": size, "load_and_run_s": load_run_s,
            "launches": counts, "max_abs_err_vs_eager": err, "scale": scale}


def profiled_fit() -> dict:
    """Phase 23 (c): a Dummy GraphLAM fit of one batch with
    ``trainer.profiler: jax``: its trace under build/ names the a and b
    kernels (forward and backward); deleted after."""
    import shutil

    from py4cast_tpu_torch.datasets import get_datasets
    from py4cast_tpu_torch.training import AutoRegressiveModule, Trainer, TrainerConfig

    train_ds, val_ds, _ = get_datasets("dummy", 2, 1, 3)
    settings = model_settings("GraphLAM", num_warmup_steps=2, num_pred_steps_val_test=3)
    module = AutoRegressiveModule(settings, train_ds.dataset_info, device="cuda")
    save = BUILD / "smoke_profiled_fit"
    shutil.rmtree(save, ignore_errors=True)
    cfg = TrainerConfig(max_epochs=1, batch_size=8, limit_train_batches=1, limit_val_batches=1,
                        save_path=str(save), logging_enabled=False, device="cuda",
                        profiler="jax")
    reset_counts()
    t0 = time.perf_counter()
    Trainer(cfg).fit(module, train_ds, val_ds)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    want = expected_launches(module, 1 + settings.num_pred_steps_val_test, 1)
    try:
        if counts != want:
            raise AssertionError(f"profiled fit launched {counts}, expected {want}")
        traces = sorted((save / "profile").glob("*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"profiled fit: {len(traces)} trace files under {save}/profile")
        events = json.loads(traces[0].read_text())["traceEvents"]
        kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
        named = {kernel: [k for k in kernels if kernel in k] for kernel in
                 ("stencil_message_fwd", "stencil_message_bwd", "corner_hop_fwd",
                  "corner_hop_bwd")}
        missing = [kernel for kernel, found in named.items() if not found]
        if missing:
            raise AssertionError(f"the fit's trace names no {missing} kernel among "
                                 f"{len(kernels)} kernels")
        return {"seconds": seconds, "launches": counts, "trace_bytes": traces[0].stat().st_size,
                "device_kernels": len(kernels),
                "kernel_names": {k: v[:2] for k, v in named.items()}}
    finally:
        shutil.rmtree(save, ignore_errors=True)


def dispatch_cost(calls: int = 1000) -> dict:
    """Phase 23 (d): host microseconds a c-fwd call at a tiny shape
    (BH 1, Lq 64, Lk 4, D 16), through the custom op and through its
    bare CUDA implementation, ``calls`` calls each ending in a
    synchronize, in turns (op, bare, bare, op)."""
    from py4cast_tpu_torch.ops import attention

    rng = np.random.default_rng(230)
    q, k, v = (_rand(rng, 1, n, 16) for n in (64, 4, 4))
    fns = {"op": attention.short_kv_attention_fwd,
           "bare": attention._short_kv_attention_fwd_cuda}
    for fn in fns.values():
        for _ in range(20):
            fn(q, k, v, 0.25)
    runs = {name: [] for name in fns}
    for name in ("op", "bare", "bare", "op"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fns[name](q, k, v, 0.25)
        torch.cuda.synchronize()
        runs[name].append((time.perf_counter() - t0) / calls * 1e6)
    return {"calls": calls, "us_per_call": runs,
            "op_minus_bare_us": float(np.mean(runs["op"]) - np.mean(runs["bare"]))}


def tools_phase() -> dict:
    """Phase 23, the user tools: (a) ``export_forward`` of HalfUNet,
    Segformer and UNetRPP at their yamls' width at 512x640, reloaded and
    run against the eager model, Segformer's and UNetRPP's programs
    counted on c-fwd; (b)
    the FLOPs of one predict call and one train step of all eleven models
    (``ops/flops.py``, under fake tensors; HalfUNet and GraphLAM also by a
    real call on the card, which must count the same), each kernel's
    share; (c) a profiled Dummy GraphLAM fit; (d) the custom op's
    dispatch cost; the phase's wall time."""
    from py4cast_tpu_torch.testing import synthetic_dataset_info
    from py4cast_tpu_torch.training import AutoRegressiveModule

    t23 = time.perf_counter()
    out = {"card": card_line(), "export": {}, "flops": {}}
    SMOKE_EXPORT.mkdir(parents=True, exist_ok=True)
    grid_info = synthetic_dataset_info(grid_shape=(512, 640), weather_features=21,
                                       forcing_features=21)
    graph_info = synthetic_dataset_info(grid_shape=(500, 500), weather_features=21,
                                        forcing_features=21)
    try:
        for name, overrides in FLOP_GRID_MODELS.items():
            module = AutoRegressiveModule(model_settings(name, overrides), grid_info,
                                          device="cuda")
            params = module.init_params(torch.Generator().manual_seed(0))
            if name in EXPORT_MODELS:
                out["export"][name] = export_and_reload(module, params, name)
                log(f"phase 23 (a) {name} 512x640 export: {json.dumps(out['export'][name])}")
            out["flops"][name] = _flop_row(module, params, name in REAL_COUNT_MODELS)
            log(f"phase 23 (b) {name} 512x640 FLOPs: {json.dumps(out['flops'][name])}")
            del module, params
            torch.cuda.empty_cache()
    finally:
        import shutil

        shutil.rmtree(SMOKE_EXPORT, ignore_errors=True)
    for name in FLOP_GRAPH_MODELS:
        module = AutoRegressiveModule(model_settings(name), graph_info, device="cuda")
        params = module.init_params(torch.Generator().manual_seed(0))
        out["flops"][name] = _flop_row(module, params, name in REAL_COUNT_MODELS)
        log(f"phase 23 (b) {name} 500x500 FLOPs: {json.dumps(out['flops'][name])}")
        del module, params
        torch.cuda.empty_cache()
    out["profiled_fit"] = profiled_fit()
    log(f"phase 23 (c) profiled GraphLAM fit: {json.dumps(out['profiled_fit'])}")
    out["dispatch"] = dispatch_cost()
    log(f"phase 23 (d) c-fwd dispatch: {json.dumps(out['dispatch'])}")
    out["wall_s"] = time.perf_counter() - t23
    log(f"phase 23 wall: {out['wall_s']:.1f} s")
    return out


# ------------------------------------------------------------------ phase 24
#: where phase 24 writes its weights, checkpoints and template (deleted after)
SMOKE_TOOLS = BUILD / "smoke_tools"
#: deeplabv3plus.yaml's width on the ResNet34 encoder
RESNET34 = {"encoder_name": "resnet34"}
#: phase 24's budget of wall seconds
PHASE24_BUDGET_S = 60.0
#: the first steps of a weight tool's training, card against CPU: the
#: pretraining's losses (relative) and the perceptual features (absolute)
PRETRAIN_LOSS_RTOL = 1e-4
#: the pretraining's steps held against the CPU: its eager steps and two
#: replays of its CUDA graph
PRETRAIN_HELD = 5
FEATURES_ATOL = 1e-5


def _quiet(_msg) -> None:
    """A tool's log while it runs again for a comparison."""


def pretrain_resnet34(out: Path) -> dict:
    """Phase 24 (a): ``tools/pretrain_encoder`` with ``--encoder resnet34``
    at its defaults (500 steps, batch 16, 64x64) on the card, the pieces
    its ``main`` runs (``pretrain``, then ``save_encoder``): the denoise
    MSE at the first and last step (the last lower), steps a second over
    the whole call and over steps 100 to 499 (the step is a CUDA graph's
    replay after its EAGER_STEPS eager steps; the loss syncs the host at
    every 100th step); its first PRETRAIN_HELD losses, eager and replayed,
    against the same steps on the CPU (the same initial weights and
    fields) within PRETRAIN_LOSS_RTOL."""
    from py4cast_tpu_torch.tools import pretrain_encoder

    marks = []

    def timed_log(msg):
        marks.append(time.perf_counter())
        log(msg)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, losses = pretrain_encoder.pretrain("resnet34", device="cuda", log=timed_log)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"pretrain_encoder resnet34 mse {losses[0]} -> {losses[-1]}")
    t1 = time.perf_counter()
    path, arrays = pretrain_encoder.save_encoder(model, "resnet34", out)
    save_s = time.perf_counter() - t1
    card = losses[:PRETRAIN_HELD]
    _, cpu = pretrain_encoder.pretrain("resnet34", steps=PRETRAIN_HELD, device="cpu", log=_quiet)
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    if not max(rel) <= PRETRAIN_LOSS_RTOL:
        raise AssertionError(f"pretrain_encoder resnet34 first {PRETRAIN_HELD} losses card "
                             f"{card} vs cpu {cpu}")
    return {"steps": len(losses), "mse_first": losses[0], "mse_last": losses[-1],
            "steps_per_s": len(losses) / seconds, "train_s": seconds,
            "steady_steps_per_s": (len(losses) - 1 - 100) / (marks[-1] - marks[1]),
            "eager_steps": pretrain_encoder.EAGER_STEPS, "held_card": card, "held_cpu": cpu,
            "held_max_rel_diff": max(rel), "npz": str(path.relative_to(ROOT)),
            "arrays": arrays, "npz_bytes": path.stat().st_size, "save_s": save_s}


def deeplab_resnet34(npz: Path, grid=(512, 640)) -> dict:
    """Phase 24 (b): DeepLabV3Plus at deeplabv3plus.yaml's width on (a)'s
    ResNet34 encoder (``encoder_weights: <npz>``) at 512x640, batch 1,
    21 + 21 features: the loaded encoder through ``encoder_to_flax`` is
    the npz bit for bit (the stem adapted to the inputs); one predict
    call and two AdamW train steps, counted (no hand kernel: every count
    0); the first step's loss within TOL of the CPU's; peak memory and
    host ms of the second step."""
    from py4cast_tpu_torch.convert import encoder_to_flax
    from py4cast_tpu_torch.models.pretrained import adapt_in_channels, load_encoder_npz
    from py4cast_tpu_torch.testing import synthetic_batch, synthetic_dataset_info
    from py4cast_tpu_torch.training import AutoRegressiveModule

    info = synthetic_dataset_info(grid_shape=grid, weather_features=21, forcing_features=21)
    settings = model_settings("DeepLabV3Plus", {**RESNET34, "encoder_weights": str(npz)},
                              num_warmup_steps=2)
    module = AutoRegressiveModule(settings, info, device="cuda")
    params = module.init_params(torch.Generator().manual_seed(0))
    flat, meta = load_encoder_npz(npz)
    got = encoder_to_flax(params)
    n_in = params["encoder.stem_conv.weight"].shape[1]
    want = {**flat, "stem_conv/kernel": adapt_in_channels(flat["stem_conv/kernel"], n_in)}
    differ = sorted(k for k in want if k not in got or not np.array_equal(got[k], want[k]))
    if differ or set(got) != set(want):
        raise AssertionError(f"DeepLabV3Plus resnet34 encoder vs npz: {differ[:5]}")
    if any(v.device.type != "cuda" for v in params.values()):
        raise AssertionError("DeepLabV3Plus resnet34 params not on the card")
    one = synthetic_batch(info, batch_size=1, num_input_steps=2, num_pred_steps=1, seed=0)

    reset_counts()
    preds = module.predict_step(params, one).array
    torch.cuda.synchronize()
    if preds.shape != (1, 1, *grid, 21) or not bool(torch.isfinite(preds).all()):
        raise AssertionError(f"DeepLabV3Plus resnet34 prediction {tuple(preds.shape)} "
                             "or non-finite")
    state = module.init_state(None, num_training_steps=100, params=params)
    torch.cuda.reset_peak_memory_stats()
    losses, runs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(module.train_step(state, one)))
        runs.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    if counts != expected_launches(module, 2, 2):
        raise AssertionError(f"DeepLabV3Plus resnet34 launches {counts}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"DeepLabV3Plus resnet34 train losses {losses}")
    cpu_module = AutoRegressiveModule(settings, info, device="cpu")
    loss_cpu, _ = cpu_module.loss_and_grads({k: v.cpu() for k, v in params.items()}, one)
    rel = abs(losses[0] - float(loss_cpu)) / abs(float(loss_cpu))
    if not rel <= TOL:
        raise AssertionError(f"DeepLabV3Plus resnet34 first loss card {losses[0]} vs cpu "
                             f"{float(loss_cpu)}")
    return {"model": "DeepLabV3Plus", "settings": settings.settings_init_args,
            "grid": list(grid), "batch": 1, "params": module.num_params(params),
            "npz_meta": meta, "encoder_arrays": len(got), "stem_in_channels": n_in,
            "launches": counts, "losses": losses, "loss_cpu": float(loss_cpu),
            "loss_rel_diff": rel, "host_ms_per_train_step": runs, "peak_mem_bytes": peak}


def perceptual_features(out: Path) -> dict:
    """Phase 24 (c): ``tools/train_perceptual_features`` at its defaults
    (800 steps, batch 32) on the card, the pieces its ``main`` runs: the
    npz has the committed file's keys and shapes; the first three steps'
    parameters against the CPU's from the same seed within
    FEATURES_ATOL; steps a second."""
    from py4cast_tpu_torch.losses import PERCEPTUAL_FEATS
    from py4cast_tpu_torch.tools import train_perceptual_features as tpf

    card3, _ = tpf.train(steps=3, device="cuda", log=_quiet)
    cpu3, _ = tpf.train(steps=3, device="cpu", log=_quiet)
    err = max(float((card3[k].cpu() - cpu3[k]).abs().max()) for k in cpu3)
    if not err <= FEATURES_ATOL:
        raise AssertionError(f"perceptual features after 3 steps card vs cpu: {err:.3e}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, losses = tpf.train(device="cuda", log=log)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    path = tpf.save_features(params, out)
    with np.load(path) as got, np.load(PERCEPTUAL_FEATS) as shipped:
        shapes = {k: got[k].shape for k in got.files}
        if shapes != {k: shipped[k].shape for k in shipped.files}:
            raise AssertionError(f"perceptual features {shapes} are not the committed file's")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"perceptual features mse {losses[0]} -> {losses[-1]}")
    return {"steps": len(losses), "mse_first": losses[0], "mse_last": losses[-1],
            "steps_per_s": len(losses) / seconds, "train_s": seconds,
            "first3_max_abs_diff_vs_cpu": err, "npz": str(path.relative_to(ROOT))}


def converted_customunet() -> dict:
    """Phase 24 (d): a seeded torchvision resnet34 checkpoint
    (``torch.save``) through ``tools/convert_torchvision_encoder``'s
    ``main``; CustomUNet at customunet.yaml's width with ``encoder_norm:
    affine`` on it: the card's encoder is the npz's, and Trainer.fit on
    Dummy (2 train batches of 8, 1 validation batch), counted."""
    from py4cast_tpu_torch.convert import encoder_to_flax
    from py4cast_tpu_torch.datasets import get_datasets
    from py4cast_tpu_torch.models.pretrained import load_encoder_npz
    from py4cast_tpu_torch.testing import torchvision_resnet_state_dict
    from py4cast_tpu_torch.tools import convert_torchvision_encoder
    from py4cast_tpu_torch.training import AutoRegressiveModule, Trainer, TrainerConfig

    ckpt, npz = SMOKE_TOOLS / "resnet34-torchvision.pth", SMOKE_TOOLS / "resnet34_affine.npz"
    torch.save(torchvision_resnet_state_dict("resnet34"), ckpt)
    if convert_torchvision_encoder.main([str(ckpt), "--encoder", "resnet34",
                                         "--out", str(npz)]) != 0:
        raise AssertionError("convert_torchvision_encoder failed")
    flat, meta = load_encoder_npz(npz)
    train_ds, val_ds, _ = get_datasets("dummy", 2, 1, 3)
    settings = model_settings("CustomUNet", {**RESNET34, "encoder_norm": "affine",
                                             "encoder_weights": str(npz)},
                              num_warmup_steps=2, num_pred_steps_train=1,
                              num_pred_steps_val_test=3)
    module = AutoRegressiveModule(settings, train_ds.dataset_info, device="cuda")
    got = encoder_to_flax(module.init_params(torch.Generator().manual_seed(0)))
    # torchvision's convs carry no bias: the model keeps its own (zeros)
    differ = sorted(k for k in flat if k != "stem_conv/kernel"
                    and (k not in got or not np.array_equal(got[k], flat[k])))
    if differ:
        raise AssertionError(f"CustomUNet affine encoder vs converted npz: {differ[:5]}")
    logger = _ListLogger()
    cfg = TrainerConfig(max_epochs=1, batch_size=8, limit_train_batches=2, limit_val_batches=1,
                        save_path=str(SMOKE_TOOLS / "fit_customunet_affine"),
                        log_every_n_steps=1, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    state = Trainer(cfg, loggers=[logger]).fit(module, train_ds, val_ds)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    if counts != expected_launches(module, 2 + 3, 2):
        raise AssertionError(f"CustomUNet affine fit launches {counts}")
    losses = [v for tag, v, _ in logger.rows if tag == "train/loss"]
    if state.step != 2 or len(losses) != 2 or not np.isfinite(losses).all():
        raise AssertionError(f"CustomUNet affine fit: step {state.step}, losses {losses}")
    if any(v.device.type != "cuda" for v in state.params.values()):
        raise AssertionError("CustomUNet affine fit's params are not on the card")
    return {"npz_meta": meta, "arrays": len(flat), "launches": counts, "train_losses": losses,
            "fit_s": seconds}


def grib_template(margin: int = 4) -> dict:
    """Phase 24 (e): ``tools/make_grib_template --dataset dummy --margin
    4``, read back with ``io/grib2.read_grib2``: one field a template id
    of Dummy's outputs, each on Dummy's grid widened by ``margin`` cells
    a side."""
    from py4cast_tpu_torch.datasets import get_datasets
    from py4cast_tpu_torch.io.grib2 import read_grib2
    from py4cast_tpu_torch.io.outputs import template_fids_for_features
    from py4cast_tpu_torch.tools import make_grib_template

    out = SMOKE_TOOLS / "dummy_template.grib"
    if make_grib_template.main(["--dataset", "dummy", "--output", str(out),
                                "--margin", str(margin)]) != 0:
        raise AssertionError("make_grib_template failed")
    ds = get_datasets("dummy", 2, 1, 1)[0]
    lat = make_grib_template.widen(np.asarray(ds.grid.lat)[:, 0], margin)
    lon = make_grib_template.widen(np.asarray(ds.grid.lon)[0, :], margin)
    fids = template_fids_for_features(ds.dataset_info.output_feature_names)
    fields = read_grib2(out)
    ids = [(f.discipline, f.parameter_category, f.parameter_number, f.level) for f in fields]
    want = [(d.get("discipline", 0), d.get("parameterCategory", 0), d.get("parameterNumber", 0),
             d.get("level", 0)) for d in fids]
    if ids != want:
        raise AssertionError(f"GRIB template ids {ids}, asked {want}")
    for f in fields:
        if (f.values.shape != (lat.size, lon.size) or not np.allclose(f.lat, lat, atol=1e-5)
                or not np.allclose(f.lon, lon, atol=1e-5)):
            raise AssertionError(f"GRIB template grid {f.values.shape}, asked "
                                 f"{(lat.size, lon.size)}")
    return {"fields": len(fields), "grid": [int(lat.size), int(lon.size)], "ids": ids,
            "bytes": out.stat().st_size}


def weight_tools_phase() -> dict:
    """Phase 24, the weight-making tools and the ResNet34 path on the
    card: (a) the ResNet34 encoder pretrained, (b) DeepLabV3Plus on it at
    512x640, (c) the perceptual features, (d) converted torchvision
    weights under CustomUNet, (e) a GRIB template; everything written
    under build/smoke_tools and deleted after; the phase's wall time
    beside its budget, PHASE24_BUDGET_S."""
    import shutil

    t24 = time.perf_counter()
    out = {"card": card_line()}
    shutil.rmtree(SMOKE_TOOLS, ignore_errors=True)
    SMOKE_TOOLS.mkdir(parents=True)
    parts = (("a", "pretrain", "pretrain_encoder resnet34",
              lambda: pretrain_resnet34(SMOKE_TOOLS / "resnet34.npz")),
             ("b", "deeplab", "DeepLabV3Plus resnet34 512x640",
              lambda: deeplab_resnet34(SMOKE_TOOLS / "resnet34.npz")),
             ("c", "perceptual", "train_perceptual_features",
              lambda: perceptual_features(SMOKE_TOOLS / "perceptual_feats.npz")),
             ("d", "torchvision", "converted torchvision resnet34 under CustomUNet",
              converted_customunet),
             ("e", "grib", "make_grib_template", grib_template))
    try:
        for tag, key, what, run in parts:
            t0 = time.perf_counter()
            out[key] = run()
            out[key]["wall_s"] = time.perf_counter() - t0
            log(f"phase 24 ({tag}) {what}: {json.dumps(out[key])}")
    finally:
        shutil.rmtree(SMOKE_TOOLS, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t24
    out["within_budget"] = out["wall_s"] <= PHASE24_BUDGET_S
    log(f"phase 24 wall: {out['wall_s']:.1f} s (budget {PHASE24_BUDGET_S:.0f} s"
        f"{'' if out['within_budget'] else ', over it'})")
    return out


# ------------------------------------------------------------------ phase 25
PHASE25_BUDGET_S = 40.0
#: the graph models' widths past the row-tile instances that phase 25
#: drives at 500x500 (the yamls' 64 is phases 4-13's)
WIDE_WIDTHS = (128, 256)
#: widths the path does not take: each kernel once, correctness only
WIDE_ODD_WIDTHS = (65, 100, 130, 512)
#: (model, hidden_dims, train): phase 25's 500x500 rows
WIDE_MODELS = (("GraphLAM", 128, True), ("GraphLAM", 256, True), ("HiLAM", 128, True),
               ("HiLAMParallel", 128, False))
#: (model, hidden_dims): phase 25's 64x64 train steps, card against CPU
WIDE_VS_CPU = (("GraphLAM", 128), ("GraphLAM", 256), ("HiLAM", 128))


#: each kernel's widest row-tile (or warp-row) instance, as its source's
#: WIDE_ABOVE: above it the wide instance must launch (the C entries say
#: which instance launched; these are what they must say)
WIDE_CAPS = {"stencil_message": 128, "stencil_message_bwd": 64, "corner_hop": 96,
             "corner_hop_bwd": 64}


def read_wide_counts() -> dict:
    return {name: _wrappers()[name].launches_wide for name in WIDE_CAPS}


def reset_wide_counts():
    reset_counts()
    for name in WIDE_CAPS:
        _wrappers()[name].launches_wide = 0


def check_wide_kernels(rng, h: int) -> list:
    """Phase 25 (a): the four kernels at width h at the path's shapes,
    each against its plain version (weight gradients against fp64), a
    second call bit for bit, timed beside the plain version, with its
    bound and the launched instance's attributes."""
    from py4cast_tpu_torch.ops import hop_kernel as hk
    from py4cast_tpu_torch.ops import stencil_kernel as sk

    caps, rows = WIDE_CAPS, []

    def row(name, shape, err, rel, fn, plain, n_bytes, n_ops, launch):
        bound_ms, bound_by = bound(n_bytes, n_ops)
        # fewer windows than phase 3's: a call at h = 256 takes up to 60 ms
        ms, plain_ms = (time_ms(f, reps=5, warmup=1, inner=3) for f in (fn, plain))
        return {"name": name, "h": h, "instance": "wide" if h > caps[name] else "row tiles",
                "shape": shape, "max_abs_err": err, "max_err_over_scale": rel, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "share_of_bound": bound_ms / ms, "library_ms": None, "launch": launch}

    hr = GRAPHLAM_LEVELS[0]
    cells = hr * hr
    args = stencil_inputs(rng, 1, hr, hr, h)
    got = sk.fused_stencil_message(*args, residual=True)
    err, rel = _max_rel(got, sk.stencil_message_plain(*args, residual=True))
    again = sk.fused_stencil_message(*args, residual=True)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"stencil_message h={h}: a second call differs")
    del got, again
    # the bytes and operations as phase 3's and 3b's (check_stencil,
    # check_stencil_bwd, check_hop, check_hop_bwd) count them
    rows.append(row(
        "stencil_message", f"e (1,8,{hr},{hr},{h}) ps (1,{hr},{hr},{h}) residual=True", err, rel,
        lambda: sk.fused_stencil_message(*args, residual=True),
        lambda: sk.stencil_message_plain(*args, residual=True),
        4 * (2 * 8 * cells * h + 3 * cells * h + 8 * cells + 2 * h * h + 4 * h),
        8 * cells * (4 * h * h + 19 * h), sk.fwd_kernel_attributes(h, h)))
    args = [*stencil_inputs(rng, 1, hr, hr, h, shifted=True), _rand(rng, 1, 8, hr, hr, h),
            _rand(rng, 1, hr, hr, h)]
    got = sk.fused_stencil_message_bwd(*args, residual=True)
    torch.cuda.synchronize()
    plain32 = sk.stencil_message_bwd_plain(*args, residual=True)
    plain64 = sk.stencil_message_bwd_plain(*(a.double() for a in args), residual=True)
    err, rel = _check_bwd(f"stencil_message_bwd h={h}", got, plain32, plain64, 3)
    again = sk.fused_stencil_message_bwd(*args, residual=True)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"stencil_message_bwd h={h}: a second call differs")
    del got, again, plain32, plain64
    rows.append(row(
        "stencil_message_bwd", f"e,vs,g_out (1,8,{hr},{hr},{h}) residual=True", err, rel,
        lambda: sk.fused_stencil_message_bwd(*args, residual=True),
        lambda: sk.stencil_message_bwd_plain(*args, residual=True),
        4 * (5 * 8 * cells * h + 3 * cells * h + 8 * cells + 2 * (2 * h * h + 4 * h)),
        8 * cells * (12 * h * h + 40 * h), sk.bwd_kernel_attributes(h, h)))
    del args

    gr, ff = 500, 3
    cells = gr * gr
    src, rest = hop_inputs(rng, 1, gr, gr, h, ff)
    out = hk.fused_corner_hop(*src, *rest)
    err, rel = _max_rel([out], [hk.corner_hop_plain(*src, *rest)])
    if not torch.equal(out, hk.fused_corner_hop(*src, *rest)):
        raise AssertionError(f"corner_hop h={h}: a second call differs")
    del out
    rows.append(row(
        "corner_hop", f"ps {tuple(src[0].shape)} vd (1,{gr},{gr},{h}) feats (4,{gr},{gr},{ff})",
        err, rel, lambda: hk.fused_corner_hop(*src, *rest),
        lambda: hk.corner_hop_plain(*src, *rest),
        4 * (2 * cells * h + src[0].numel() + src[1].numel() + src[2].numel()
             + 4 * cells * ff + 5 * h * h + ff * h + 8 * h),
        cells * (16 * h * h + 8 * ff * h + 84 * h), hk.fwd_kernel_attributes(h)))
    psg, g = hk.gather_corners(*src), _rand(rng, 1, gr, gr, h)
    del src
    got = hk.fused_corner_hop_bwd(psg, *rest, g)
    torch.cuda.synchronize()
    plain32 = hk.corner_hop_bwd_plain(psg, *rest, g)
    plain64 = hk.corner_hop_bwd_plain([p.double() for p in psg], *(a.double() for a in rest),
                                      g.double())
    err, rel = _check_bwd(f"corner_hop_bwd h={h}", got, plain32, plain64, 5)
    del plain32, plain64
    again = hk.fused_corner_hop_bwd(psg, *rest, g)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"corner_hop_bwd h={h}: a second call differs")
    del got, again
    rows.append(row(
        "corner_hop_bwd", f"psg,vd,g (1,{gr},{gr},{h}) feats (4,{gr},{gr},{ff})", err, rel,
        lambda: hk.fused_corner_hop_bwd(psg, *rest, g),
        lambda: hk.corner_hop_bwd_plain(psg, *rest, g),
        4 * (11 * cells * h + 4 * cells * ff + 2 * (5 * h * h + ff * h + 8 * h)),
        cells * (48 * h * h + 16 * ff * h + 200 * h), hk.bwd_kernel_attributes(h)))
    del psg, rest, g
    torch.cuda.empty_cache()
    return rows


def check_wide_odd_widths(rng) -> list:
    """Phase 25 (b): each kernel at widths the path does not take, at
    small shapes (a 9x7 lattice; a 13x11 grid, batch 2, mean
    aggregation), once against its plain version and a second call bit
    for bit; each call counted on its instance."""
    from py4cast_tpu_torch.ops import hop_kernel as hk
    from py4cast_tpu_torch.ops import stencil_kernel as sk

    caps, rows = WIDE_CAPS, []
    for h in WIDE_ODD_WIDTHS:
        reset_wide_counts()
        errs = {}
        args = stencil_inputs(rng, 1, 9, 7, h)
        got = sk.fused_stencil_message(*args, residual=True)
        errs["stencil_message"] = _max_rel(got, sk.stencil_message_plain(*args, residual=True))[0]
        same = all(torch.equal(x, y)
                   for x, y in zip(got, sk.fused_stencil_message(*args, residual=True)))
        args = [*stencil_inputs(rng, 1, 9, 7, h, shifted=True), _rand(rng, 1, 8, 9, 7, h),
                _rand(rng, 1, 9, 7, h)]
        got = sk.fused_stencil_message_bwd(*args, residual=True)
        errs["stencil_message_bwd"] = _check_bwd(
            f"stencil_message_bwd h={h}", got, sk.stencil_message_bwd_plain(*args, residual=True),
            sk.stencil_message_bwd_plain(*(a.double() for a in args), residual=True), 3)[0]
        same &= all(torch.equal(x, y)
                    for x, y in zip(got, sk.fused_stencil_message_bwd(*args, residual=True)))
        src, rest = hop_inputs(rng, 2, 13, 11, h)
        out = hk.fused_corner_hop(*src, *rest, mean=True)
        errs["corner_hop"] = _max_rel([out], [hk.corner_hop_plain(*src, *rest, mean=True)])[0]
        same &= torch.equal(out, hk.fused_corner_hop(*src, *rest, mean=True))
        psg, g = hk.gather_corners(*src), _rand(rng, 2, 13, 11, h)
        got = hk.fused_corner_hop_bwd(psg, *rest, g, mean=True)
        errs["corner_hop_bwd"] = _check_bwd(
            f"corner_hop_bwd h={h}", got, hk.corner_hop_bwd_plain(psg, *rest, g, mean=True),
            hk.corner_hop_bwd_plain([p.double() for p in psg], *(a.double() for a in rest),
                                    g.double(), mean=True), 5)[0]
        same &= all(torch.equal(x, y)
                    for x, y in zip(got, hk.fused_corner_hop_bwd(psg, *rest, g, mean=True)))
        torch.cuda.synchronize()
        if not same:
            raise AssertionError(f"a kernel at h={h}: a second call differs")
        wide, counts = read_wide_counts(), read_counts()
        for name, cap in caps.items():
            if counts[name] != 2 or wide[name] != (2 if h > cap else 0):
                raise AssertionError(f"h={h} {name}: launches {counts[name]}, "
                                     f"wide {wide[name]}")
        rows.append({"h": h, "max_abs_err": errs, "launches_wide": wide})
    return rows


def check_wide_bf16(rng, h: int = 256) -> list:
    """Phase 25 (c): each kernel's wide instance on bf16 inputs, one
    shape each, within one bf16 ulp of its plain version (17 (a)'s
    bar)."""
    from py4cast_tpu_torch.ops import hop_kernel as hk
    from py4cast_tpu_torch.ops import stencil_kernel as sk

    bf16, f32 = torch.bfloat16, torch.float32
    args = _bf16(stencil_inputs(rng, 1, 32, 32, h))
    rows = [bf16_boundary(
        "stencil_message", f"e (1,8,32,32,{h}) ps (1,32,32,{h}) residual=True",
        lambda a: sk.fused_stencil_message(*a, residual=True),
        lambda a: sk.stencil_message_plain(*a, residual=True), args, 2, (bf16, bf16))]
    args = _bf16([*stencil_inputs(rng, 1, 32, 32, h, shifted=True), _rand(rng, 1, 8, 32, 32, h),
                  _rand(rng, 1, 32, 32, h)])
    rows.append(bf16_boundary(
        "stencil_message_bwd", f"e,vs,g_out (1,8,32,32,{h}) residual=True",
        lambda a: sk.fused_stencil_message_bwd(*a, residual=True),
        lambda a: sk.stencil_message_bwd_plain(*a, residual=True), args, 3,
        (bf16,) * 3 + (f32,) * 6))
    src, rest = hop_inputs(rng, 1, 64, 64, h, 3)
    args = _bf16([*src, *rest])
    rows.append(bf16_boundary(
        "corner_hop", f"ps (1,16,16,{h}) vd (1,64,64,{h}) feats (4,64,64,3)",
        lambda a: (hk.fused_corner_hop(*a),), lambda a: (hk.corner_hop_plain(*a),), args, 1,
        (bf16,)))
    args = [*hk.gather_corners(*args[:3]), *args[3:], _rand(rng, 1, 64, 64, h).to(bf16)]
    rows.append(bf16_boundary(
        "corner_hop_bwd", f"psg,vd,g (1,64,64,{h}) feats (4,64,64,3)",
        lambda a: hk.fused_corner_hop_bwd(a[:4], *a[4:-1], a[-1]),
        lambda a: hk.corner_hop_bwd_plain(a[:4], *a[4:-1], a[-1]), args, 5,
        (bf16,) * 5 + (f32,) * 14))
    return rows


def _check_wide_launches(what: str, h: int, kernels) -> dict:
    """The wide launches of a counted run: each kernel in ``kernels``
    launched, and on its wide instance (every launch) exactly when h is
    past its cap."""
    caps, counts, wide = WIDE_CAPS, read_counts(), read_wide_counts()
    for name in kernels:
        want = counts[name] if h > caps[name] else 0
        if counts[name] == 0 or wide[name] != want:
            raise AssertionError(f"{what}: {name} launches {counts[name]}, wide {wide[name]}, "
                                 f"expected {want} wide")
    return wide


def wide_model_row(name: str, h: int, train: bool, grid=(500, 500)) -> dict:
    """Phase 25 (d): Trainer.predict (3 AR steps, batch 1) and, with
    ``train``, Trainer.fit (2 train steps, batch 1, no validation) of a
    graph model at hidden width h on synthetic data at 500x500 (21
    weather and 21 forcing features), each counted; host ms a step (the
    timed predict after a warm-up one, and one more train step after
    the fit), peak memory, finite outputs and losses."""
    import shutil

    from py4cast_tpu_torch.testing import SyntheticDataset, synthetic_batch, synthetic_dataset_info
    from py4cast_tpu_torch.training import AutoRegressiveModule, Trainer, TrainerConfig

    info = synthetic_dataset_info(grid_shape=grid, weather_features=21, forcing_features=21)
    settings = model_settings(name, {"hidden_dims": h}, num_warmup_steps=2,
                              num_pred_steps_train=1, num_pred_steps_val_test=3)
    module = AutoRegressiveModule(settings, info, device="cuda")
    state = module.init_params(torch.Generator().manual_seed(0))
    data = SyntheticDataset(info, 1, num_pred_steps=3, seed=0)
    trainer = Trainer(TrainerConfig(batch_size=1, num_workers=1, device="cuda"))
    trainer.predict(module, data, state)  # warm-up
    torch.cuda.synchronize()
    reset_wide_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    preds = trainer.predict(module, data, state)
    torch.cuda.synchronize()
    out = {"model": name, "hidden_dims": h, "grid": list(grid), "batch": 1,
           "predict_ms_a_step": (time.perf_counter() - t0) * 1e3 / 3,
           "predict_peak_mem_bytes": torch.cuda.max_memory_allocated()}
    if read_counts() != expected_launches(module, 3, 0):
        raise AssertionError(f"{name} h={h} predict launches {read_counts()}")
    out["predict_launches_wide"] = _check_wide_launches(f"{name} h={h} predict", h,
                                                        ("stencil_message", "corner_hop"))
    arr = preds[0].array
    if arr.shape != (1, 3, grid[0] * grid[1], 21) or not np.isfinite(arr).all():
        raise AssertionError(f"{name} h={h} predictions: shape {arr.shape} or non-finite")
    del preds, arr
    if train:
        save = BUILD / f"smoke_wide_{name.lower()}_{h}"
        shutil.rmtree(save, ignore_errors=True)
        log_rows = _ListLogger()
        fit_trainer = Trainer(TrainerConfig(
            max_epochs=1, batch_size=1, num_workers=1, limit_train_batches=2,
            check_val_every_n_epoch=2, log_every_n_steps=1, save_path=str(save),
            device="cuda"), loggers=[log_rows])
        train_data = SyntheticDataset(info, 2, num_pred_steps=1, seed=1)
        reset_wide_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fitted = fit_trainer.fit(module, train_data, train_data)
        torch.cuda.synchronize()
        out["fit_s"] = time.perf_counter() - t0
        out["fit_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        if read_counts() != expected_launches(module, 2, 2) or fitted.step != 2:
            raise AssertionError(f"{name} h={h} fit launches {read_counts()}, "
                                 f"step {fitted.step}")
        out["fit_launches_wide"] = _check_wide_launches(
            f"{name} h={h} fit", h, ("stencil_message", "corner_hop", "stencil_message_bwd",
                                     "corner_hop_bwd"))
        losses = [v for tag, v, _ in log_rows.rows if tag == "train/loss"]
        if len(losses) != 2 or not np.isfinite(losses).all():
            raise AssertionError(f"{name} h={h} train losses {losses}")
        out["train_losses"] = losses
        batch = synthetic_batch(info, batch_size=1, num_input_steps=2, num_pred_steps=1, seed=1)
        t0 = time.perf_counter()
        module.train_step(fitted, batch)
        torch.cuda.synchronize()
        out["train_ms_a_step"] = (time.perf_counter() - t0) * 1e3
        shutil.rmtree(save, ignore_errors=True)
        del fitted
    del module, state
    torch.cuda.empty_cache()
    return out


def wide_vs_cpu(name: str, h: int, grid=(64, 64)) -> dict:
    """Phase 25 (e): one train step's loss and gradients of a graph model
    at width h on a grid small enough for the CPU, card against CPU from
    the same parameters and batch, at phase 6's bars."""
    from py4cast_tpu_torch.testing import synthetic_batch, synthetic_dataset_info
    from py4cast_tpu_torch.training import AutoRegressiveModule

    info = synthetic_dataset_info(grid_shape=grid, weather_features=21, forcing_features=21)
    settings = model_settings(name, {"hidden_dims": h}, num_warmup_steps=2)
    module = AutoRegressiveModule(settings, info, device="cuda")
    params = {k: v.detach().cpu()
              for k, v in module.init_params(torch.Generator().manual_seed(0)).items()}
    batch = synthetic_batch(info, batch_size=1, num_input_steps=2, num_pred_steps=1, seed=2)
    reset_wide_counts()
    loss_gpu, grads_gpu = module.loss_and_grads(params, batch)
    torch.cuda.synchronize()
    wide = _check_wide_launches(f"{name} h={h} {grid} step", h,
                                ("stencil_message", "corner_hop", "stencil_message_bwd",
                                 "corner_hop_bwd"))
    loss_cpu, grads_cpu = AutoRegressiveModule(settings, info, device="cpu").loss_and_grads(
        params, batch)
    loss_rel = abs(float(loss_gpu) - float(loss_cpu)) / abs(float(loss_cpu))
    if not loss_rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{name} h={h} loss card {float(loss_gpu)} vs cpu {float(loss_cpu)}")
    grad_err = max(compare(f"{name} h={h} grad {k} (cuda vs cpu)", grads_gpu[k].cpu(),
                           grads_cpu[k], TRAIN_GRAD_TOL) for k in grads_cpu)
    return {"model": name, "hidden_dims": h, "grid": list(grid), "loss_cuda": float(loss_gpu),
            "loss_cpu": float(loss_cpu), "loss_rel_diff": loss_rel,
            "max_abs_grad_err_vs_cpu": grad_err, "launches_wide": wide}


def wide_phase() -> dict:
    """Phase 25: the graph models and kernels a and b at hidden widths
    past the row-tile instances."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(25)
    out = {"card": card_line(), "kernels": [], "part_wall_s": {}}
    since = [t0]

    def part(name):
        now = time.perf_counter()
        out["part_wall_s"][name] = round(now - since[0], 1)
        since[0] = now

    for h in WIDE_WIDTHS:
        for row in check_wide_kernels(rng, h):
            log(f"phase 25 (a) {row['name']} h={h} ({row['instance']}): {json.dumps(row)}")
            out["kernels"].append(row)
    part("a")
    out["odd_widths"] = check_wide_odd_widths(rng)
    for row in out["odd_widths"]:
        log(f"phase 25 (b) h={row['h']}: {json.dumps(row)}")
    part("b")
    out["bf16"] = check_wide_bf16(rng)
    for row in out["bf16"]:
        log(f"phase 25 (c) bf16 {row['name']} {row['shape']}: {json.dumps(row)}")
    part("c")
    out["models"] = [wide_model_row(*m) for m in WIDE_MODELS]
    for row in out["models"]:
        log(f"phase 25 (d) {row['model']} h={row['hidden_dims']} 500x500: {json.dumps(row)}")
    part("d")
    out["vs_cpu"] = [wide_vs_cpu(name, h) for name, h in WIDE_VS_CPU]
    for row in out["vs_cpu"]:
        log(f"phase 25 (e) {row['model']} h={row['hidden_dims']} 64x64 card vs cpu: "
            f"{json.dumps(row)}")
    part("e")
    reset_wide_counts()
    out["wall_s"] = time.perf_counter() - t0
    log(f"phase 25 wall: {out['wall_s']:.1f} s (budget {PHASE25_BUDGET_S:.0f} s; parts "
        f"{json.dumps(out['part_wall_s'])})")
    return out


# ---------------------------------------------------------------------- main
def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--kernels", nargs="+", choices=sorted(KERNEL_SOURCES), metavar="NAME",
        help="only build, check and time these kernels (phases 1 to 3c), print their "
             "numbers and stop, with no result line; names: " + ", ".join(sorted(KERNEL_SOURCES)))
    parser.add_argument(
        "--datasets", action="store_true",
        help="only build the kernels and run phase 22 (the Titan, Poesy and Rainfall "
             "datasets), with no result line")
    parser.add_argument(
        "--tools", action="store_true",
        help="only build the kernels and run phases 23 (export, FLOP counts, the profiled "
             "fit, the custom ops' dispatch cost) and 24 (the weight-making tools, the "
             "ResNet34 path), with no result line")
    parser.add_argument(
        "--steps", action="store_true",
        help="only build the kernels and run phases 5 and 7 (GraphLAM's 500x500 predict and "
             "train step: host ms), with no result line")
    parser.add_argument(
        "--wide", action="store_true",
        help="only build the kernels and run phase 25 (the graph models and kernels a and "
             "b at hidden widths past the row-tile instances), with no result line")
    parser.add_argument(
        "--spatial", action="store_true",
        help="only build the kernels and run phases 20 (d) and 21 (the data and spatial "
             "axes across cards), with no result line")
    parsed = parser.parse_args(argv)
    only = parsed.kernels
    t_start = time.perf_counter()
    walls, since = {}, [t_start]

    def lap(phase: str) -> None:
        """Each phase's wall seconds, for the line before the result."""
        now = time.perf_counter()
        walls[phase] = round(now - since[0], 1)
        since[0] = now
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to run", file=sys.stderr)
        return 1
    os.environ.setdefault("PY4CAST_TPU_ROOTDIR", str(ROOT / "build" / "smoke_data"))
    import py4cast_tpu_torch  # fails here when run outside the repo

    found = Path(py4cast_tpu_torch.__file__).resolve().parent.parent
    if found != ROOT:
        raise RuntimeError(f"py4cast_tpu_torch was imported from {found}, not from this checkout")
    from py4cast_tpu_torch.ops import _build

    # phase 1: the card
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {kind} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    log("tf32: matmul.allow_tf32=False cudnn.allow_tf32=False")

    # phase 2: build every kernel of the path; beside it, ptxas's
    # registers and spills of every kernel's instances
    t0 = time.perf_counter()
    sources = _build.SOURCES if only is None else tuple(
        src for name in only for src in KERNEL_SOURCES[name])
    reported = {src: names for src, names in PTXAS_KERNELS.items() if src in sources}
    libs = _build.build_all(sources)  # every compile reports ptxas's registers
    ptxas_text = {src: _build.ptxas_report(src) for src in reported}
    log(f"build: {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    OUT_DIR.mkdir(exist_ok=True)
    for src, names in reported.items():
        (OUT_DIR / f"ptxas_{src}.txt").write_text(ptxas_text[src])
        for kernel in names:
            for inst, regs, spills in ptxas_summary(ptxas_text[src], kernel):
                log(f"ptxas {kernel}<{inst}>: {regs} registers, "
                    f"spill stores/loads {spills[0]}/{spills[1]} bytes")
    lap("1-2")

    # phase 3 and 3b: each kernel against its plain version at the main
    # path's shapes
    rng = np.random.default_rng(0)
    checks = {"stencil_message": lambda: [check_stencil(rng)],
              "corner_hop": lambda: [check_hop(rng)],
              "stencil_message_bwd": lambda: [check_stencil_bwd(rng)],
              "corner_hop_bwd": lambda: [check_hop_bwd(rng)],
              # phase 3c: the attention kernels at the Segformer cell's shapes
              "short_kv_attention": lambda: check_attention(rng)}
    kernels = [] if (parsed.spatial or parsed.datasets or parsed.tools or parsed.steps
                     or parsed.wide) else [
        k for name, check in checks.items() if only is None or name in only for k in check()]
    for k in kernels:
        log(f"kernel {k['name']}: max_abs_err {k['max_abs_err']:.3e} ms {k['ms']:.4f} "
            f"plain_ms {k['plain_ms']:.4f} bound_ms {k['bound_ms']:.4f} ({k['bound_by']})"
            + (f" library_ms {k['library_ms']:.4f}" if k["library_ms"] is not None else ""))
        for row in k.get("shapes", []):
            log(f"  {row['label']} {row['shape']}: {json.dumps(row)}")
        if k["name"] in ("corner_hop", "corner_hop_bwd"):
            log(f"  launch {json.dumps(k['launch'])}; share of bound {k['share_of_bound']:.3f}")
        if "forward_ms" in k:
            log(f"  launch {json.dumps(k['launch'])}; one 500x500 forward's 12 launches "
                f"(4 x each level): {k['forward_ms']:.4f} ms")
        if "train_step_ms" in k:
            log(f"  launch {json.dumps(k['launch'])}; one 500x500 train step's 12 launches "
                f"(4 x each level): {k['train_step_ms']:.4f} ms")
        if "model_call_ms" in k:
            log(f"  one 512x640 model call (2 x each stage): kernel {k['model_call_ms']:.4f} ms, "
                f"library {k['model_call_library_ms']:.4f} ms")
        if "model_backward_ms" in k:
            log(f"  one 512x640 train step's backward (2 x each stage): kernel "
                f"{k['model_backward_ms']:.4f} ms, library {k['model_backward_library_ms']:.4f} ms, "
                f"bound {k['model_backward_bound_ms']:.4f} ms")
        for key in ("unetrpp_model_call", "unetrpp_model_backward"):
            if f"{key}_ms" in k:
                log(f"  {key.replace('_', ' ')} at 512x640 (15 launches): kernel "
                    f"{k[key + '_ms']:.4f} ms, library {k[key + '_library_ms']:.4f} ms, "
                    f"bound {k[key + '_bound_ms']:.4f} ms")
        if k.get("slower_than_library"):
            log(f"  slower than the library at: {', '.join(k['slower_than_library'])}")

    if only is not None:
        log(card)
        log(json.dumps({"kernels": kernels}))
        return 0
    if parsed.datasets:
        out = datasets_phase()
        (OUT_DIR / "smoke_datasets_report.json").write_text(json.dumps(out, indent=1))
        log(f"wall: {time.perf_counter() - t_start:.1f} s")
        log(card)
        return 0
    if parsed.steps:
        full, train_full = full_size_rollout("GraphLAM"), full_size_train_step("GraphLAM")
        log(f"phase 5 GraphLAM 500x500 predict, ms a step: {json.dumps(full['ms_per_step_runs'])}")
        log("phase 7 GraphLAM 500x500 train step, ms: "
            + json.dumps(train_full["ms_per_train_step_runs"]))
        log(card)
        return 0
    if parsed.wide:
        lap("1-2")
        out = wide_phase()
        lap("25")
        (OUT_DIR / "smoke_wide_report.json").write_text(json.dumps(out, indent=1))
        log(f"wall: {time.perf_counter() - t_start:.1f} s")
        log(f"phase wall s: {json.dumps(walls)}")
        log(card)
        return 0
    if parsed.tools:
        out = {"tools": tools_phase(), "weight_tools": weight_tools_phase()}
        (OUT_DIR / "smoke_tools_report.json").write_text(json.dumps(out, indent=1))
        log(f"wall: {time.perf_counter() - t_start:.1f} s")
        log(card)
        return 0
    if parsed.spatial:
        out = {"card": card, "cards": torch.cuda.device_count()}
        if torch.cuda.device_count() >= 2:
            out["two_ranks"] = two_ranks_vs_one()
            log(f"phase 20 (d) two NCCL ranks vs one: {json.dumps(out['two_ranks'])}")
        else:
            log("phase 20 (d): not run, 1 card")
        out["spatial"] = spatial_phase(floor=True)
        lap("20d-21")
        (OUT_DIR / "smoke_spatial_report.json").write_text(json.dumps(out, indent=1))
        log(f"wall: {time.perf_counter() - t_start:.1f} s")
        log(f"phase wall s: {json.dumps(walls)}")
        log(card)
        return 0

    lap("3")
    # phase 4: Trainer.predict on Dummy, counted
    kept32 = {name: {} for name in MODEL_ARGS}  # the fp32 Dummy predictions, for phase 17
    dummy = predict_dummy(model_settings("GraphLAM"), keep=kept32["GraphLAM"])
    log(f"predict dummy: {json.dumps(dummy)}")
    lap("4")

    # phase 5: the full-size rollout
    graph_kept = {}
    full = full_size_rollout("GraphLAM", keep=graph_kept)
    log(f"full size: {json.dumps(full)}")
    lap("5")

    # phase 6: Trainer.fit on Dummy, counted; resume, test, gradients
    # against the CPU; the CLI
    fit = train_dummy("GraphLAM")
    log(f"fit dummy: {json.dumps(fit)}")
    fit["cli"] = cli_dummy("graphlam")
    log(f"cli dummy: {json.dumps(fit['cli'])}")
    lap("6")

    # phase 7: one full-size train step
    train_full = full_size_train_step("GraphLAM")
    log(f"full-size train step: {json.dumps(train_full)}")
    lap("7")

    # phase 8: Trainer.predict on Dummy with Segformer, counted
    seg_dummy = predict_dummy(model_settings("Segformer"), keep=kept32["Segformer"])
    log(f"segformer predict dummy: {json.dumps(seg_dummy)}")
    lap("8")

    # phase 9: Trainer.fit on Dummy with Segformer, counted; resume,
    # test, gradients against the CPU; the CLI with segformer.yaml
    seg_fit = train_dummy("Segformer")
    log(f"segformer fit dummy: {json.dumps(seg_fit)}")
    seg_fit["cli"] = cli_dummy("segformer")
    log(f"segformer cli dummy: {json.dumps(seg_fit['cli'])}")
    lap("9")

    # phase 10: the full-width Segformer at 512x640
    seg_full = grid_model_full_size("Segformer")
    log(f"segformer 512x640: {json.dumps(seg_full)}")
    lap("10")

    # phase 11: HalfUNet (no hand kernel: every count stays 0) on Dummy,
    # predict and fit, the CLI with halfunet.yaml; 512x640 predict and
    # train step
    unet_dummy = predict_dummy(model_settings("HalfUNet"), keep=kept32["HalfUNet"])
    log(f"halfunet predict dummy: {json.dumps(unet_dummy)}")
    unet_fit = train_dummy("HalfUNet")
    log(f"halfunet fit dummy: {json.dumps(unet_fit)}")
    unet_fit["cli"] = cli_dummy("halfunet")
    log(f"halfunet cli dummy: {json.dumps(unet_fit['cli'])}")
    unet_kept = {}
    unet_full = grid_model_full_size("HalfUNet", keep=unet_kept)
    log(f"halfunet 512x640: {json.dumps(unet_full)}")
    lap("11")

    # phase 12: HiLAM on Dummy, predict and fit, the CLI with hilam.yaml;
    # 500x500 predict and train step
    hilam_dummy = predict_dummy(model_settings("HiLAM"), keep=kept32["HiLAM"])
    log(f"hilam predict dummy: {json.dumps(hilam_dummy)}")
    hilam_fit = train_dummy("HiLAM")
    log(f"hilam fit dummy: {json.dumps(hilam_fit)}")
    hilam_fit["cli"] = cli_dummy("hilam")
    log(f"hilam cli dummy: {json.dumps(hilam_fit['cli'])}")
    hilam_full = full_size_rollout("HiLAM", profile_name="smoke_profile_hilam.txt")
    log(f"hilam 500x500: {json.dumps(hilam_full)}")
    hilam_train = full_size_train_step("HiLAM", profile_name="smoke_profile_hilam_train.txt")
    log(f"hilam 500x500 train step: {json.dumps(hilam_train)}")
    lap("12")

    # phase 13: HiLAMParallel on Dummy, predict and fit, the CLI with
    # hilamparallel.yaml; a 500x500 predict
    par_dummy = predict_dummy(model_settings("HiLAMParallel"), keep=kept32["HiLAMParallel"])
    log(f"hilamparallel predict dummy: {json.dumps(par_dummy)}")
    par_fit = train_dummy("HiLAMParallel")
    log(f"hilamparallel fit dummy: {json.dumps(par_fit)}")
    par_fit["cli"] = cli_dummy("hilamparallel")
    log(f"hilamparallel cli dummy: {json.dumps(par_fit['cli'])}")
    par_full = full_size_rollout("HiLAMParallel",
                                 profile_name="smoke_profile_hilamparallel.txt")
    log(f"hilamparallel 500x500: {json.dumps(par_full)}")
    lap("13")

    # phase 14: the observers. (a) PSD-K, PSD-Var and ACC on the card over
    # phase 11's HalfUNet 512x640 and phase 5's GraphLAM 500x500 (graph
    # layout) predictions; (b) Trainer.test with logging on, counted, on
    # Dummy for GraphLAM and Segformer; (c) the CLI's predict with
    # data.save_gribs
    observers = {"metrics": [metrics_full_size(unet_kept, "halfunet_512x640"),
                             metrics_full_size(graph_kept, "graphlam_500x500")]}
    del unet_kept, graph_kept
    for row in observers["metrics"]:
        log(f"metrics {row['label']}: {json.dumps(row)}")
    observers["test_logging"] = [test_with_logging(n) for n in ("GraphLAM", "Segformer")]
    for row in observers["test_logging"]:
        log(f"test with logging {row['model']}: {json.dumps(row)}")
    observers["cli_gribs"] = cli_predict_gribs()
    log(f"cli predict gribs: {json.dumps(observers['cli_gribs'])}")
    lap("14")

    # phase 15: UNet (no hand kernel: every count stays 0) on Dummy,
    # predict and fit, the CLI with unet.yaml; 512x640 predict and train
    # step
    plain_dummy = predict_dummy(model_settings("UNet"), keep=kept32["UNet"])
    log(f"unet predict dummy: {json.dumps(plain_dummy)}")
    plain_fit = train_dummy("UNet")
    log(f"unet fit dummy: {json.dumps(plain_fit)}")
    plain_fit["cli"] = cli_dummy("unet", want=lambda sub: cli_launches("UNet", UNET_ARGS, sub))
    log(f"unet cli dummy: {json.dumps(plain_fit['cli'])}")
    plain_full = grid_model_full_size("UNet")
    log(f"unet 512x640: {json.dumps(plain_full)}")
    lap("15")

    # phase 16: UNetRPP on kernels c-fwd and c-bwd (flash_attn) on Dummy,
    # predict and fit; the CLI with unetrpp.yaml as shipped (torch, every
    # count 0) and its fit with flash_attn; 512x640 with both codes
    rpp_dummy = predict_dummy(model_settings("UNetRPP"), keep=kept32["UNetRPP"])
    log(f"unetrpp predict dummy: {json.dumps(rpp_dummy)}")
    rpp_fit = train_dummy("UNetRPP")
    log(f"unetrpp fit dummy: {json.dumps(rpp_fit)}")
    rpp_fit["cli"] = cli_dummy(
        "unetrpp", want=lambda sub: cli_launches("UNetRPP", UNETRPP_ARGS, sub))
    log(f"unetrpp cli dummy (as shipped, torch): {json.dumps(rpp_fit['cli'])}")
    rpp_fit["cli_flash_attn"] = cli_dummy(
        "unetrpp", ["--model.settings_init_args.attention_code", "flash_attn"], ("fit",),
        want=lambda sub: cli_launches("UNetRPP", MODEL_ARGS["UNetRPP"], sub))
    log(f"unetrpp cli dummy fit (flash_attn): {json.dumps(rpp_fit['cli_flash_attn'])}")
    rpp_full = {code: grid_model_full_size("UNetRPP", overrides={"attention_code": code},
                                           tag=f"unetrpp_{code}")
                for code in ("flash_attn", "torch")}
    for code, row in rpp_full.items():
        log(f"unetrpp 512x640 {code}: {json.dumps(row)}")
    lap("16")

    # phase 17: bf16. (a) the six kernels at a bf16 boundary; (b) every
    # model's Dummy predict and fit in bf16, counted as in fp32; (c) the
    # full-size GraphLAM, HalfUNet and UNetRPP (flash_attn) cells in bf16
    fits = (fit, seg_fit, unet_fit, hilam_fit, par_fit, plain_fit, rpp_fit)
    predicts = (dummy, seg_dummy, unet_dummy, hilam_dummy, par_dummy, plain_dummy, rpp_dummy)
    bf16 = {"boundary": check_bf16_kernels(rng)}
    for name, rows in bf16["boundary"]["kernels"].items():
        for row in rows:
            log(f"bf16 kernel {row['shape']}: {json.dumps(row)}")
    bf16["dummy"] = [bf16_dummy(f["model"], d, kept32[f["model"]], f)
                     for f, d in zip(fits, predicts)]
    del kept32
    for row in bf16["dummy"]:
        log(f"bf16 dummy {row['model']}: {json.dumps(row)}")
    bf16["full_size"] = {
        "graphlam_predict": full_size_rollout("GraphLAM", precision="bf16",
                                              profile_name="smoke_profile_bf16.txt"),
        "graphlam_train": full_size_train_step("GraphLAM", precision="bf16",
                                               profile_name="smoke_profile_bf16_train.txt"),
        "halfunet": grid_model_full_size("HalfUNet", precision="bf16", tag="halfunet_bf16"),
        "unetrpp_flash_attn": grid_model_full_size("UNetRPP", overrides=FLASH_ATTN,
                                                   precision="bf16",
                                                   tag="unetrpp_flash_attn_bf16"),
    }
    fp32_full = {"graphlam_predict": full, "graphlam_train": train_full,
                 "halfunet": unet_full, "unetrpp_flash_attn": rpp_full["flash_attn"]}
    for cell, row in bf16["full_size"].items():
        log(f"bf16 {cell}: {json.dumps(row)}")
        log(f"  {cell} fp32 -> bf16: " + json.dumps(bf16_vs_fp32(fp32_full[cell], row)))
    lap("17")

    # phase 18: the ResNet-encoder models and the perceptual loss
    resnet = resnet_phase()
    lap("18")

    # phase 19: SwinUNetR, the Identity plugin, the gather-table path
    swin_table = swin_table_phase()
    lap("19")
    phase19_runs = [(swin_table["swinunetr"]["fit"], swin_table["swinunetr"]["predict"]),
                    (swin_table["table"]["HiLAMParallel"]["fit"],
                     swin_table["table"]["HiLAMParallel"]["predict"])]

    # phase 20: the data axis: an NCCL group of one rank bit for bit,
    # torchrun, lat padding at 1791 rows
    data_axis = data_axis_phase(train_full)
    lap("20")

    # phase 21: the spatial axis: the band pieces fed by hand, and NCCL
    # ranks on bands against one when the machine has the cards
    spatial = spatial_phase()
    lap("21")

    # phase 22: the Titan, Poesy and Rainfall datasets, Titan's default
    # configuration through the CLI with HalfUNet and GraphLAM
    datasets = datasets_phase()
    lap("22")

    # phase 23: the user tools: export and reload, the FLOP counts, a
    # profiled fit, the custom ops' dispatch cost
    tools = tools_phase()
    lap("23")

    # phase 24: the weight-making tools, the ResNet34 path on the card
    weight_tools = weight_tools_phase()
    lap("24")

    # phase 25: the graph models and kernels a and b at hidden widths
    # past the row-tile instances
    wide = wide_phase()
    lap("25")

    # each model path ran with every count set to 0 just before it and
    # checked just after (a kernel of another path launched fails); a
    # kernel's launches are the sum over the paths that run it
    by_kernel = {}
    for row in bf16["boundary"]["kernels"].values():
        for r in row:
            by_kernel.setdefault(r["name"], r)  # the first shape: phase 3's top row
    for k in kernels:
        k["launches"] = sum(f["launches"][k["name"]] for f in fits)
        k["launches_predict"] = sum(d["launches"][k["name"]] for d in predicts)
        k["launches_bf16"] = sum(b["fit"]["launches"][k["name"]] for b in bf16["dummy"])
        k["launches_by_model"] = {
            f["model"]: [f["launches"][k["name"]], d["launches"][k["name"]]]
            for f, d in [*zip(fits, predicts),
                         *((r["fit"], r["predict"]) for r in resnet["dummy"].values())]}
        # phase 19's models launch none: each run above checked its counts
        k["launches_by_model"].update({
            f"{f['model']}{'' if f['model'] == 'SwinUNetR' else ' (table)'}":
                [f["launches"][k["name"]], d["launches"][k["name"]]]
            for f, d in phase19_runs})
        # the same in a process group (phase 20 (a): GraphLAM and Segformer)
        k["launches_process_group"] = sum(
            row["launches"][k["name"]] for row in data_axis["one_rank_group"].values()
            if "launches" in row)
        # phase 21: the band pieces (b on each band), and a step of each
        # NCCL rank layout's cells, per rank
        k["launches_spatial"] = sum(row["launches"][k["name"]]
                                    for row in [*spatial["graph_bands"]["rows"],
                                                *spatial["attention_bands"]["segformer"],
                                                *spatial["attention_bands"]["unetrpp"]]) + sum(
            cell["launches_a_step"][k["name"]] for row in spatial["ranks"]
            for cell in row["cells"])
        # phase 22: the CLI's fit, test and predict on Titan (GraphLAM's)
        k["launches_titan"] = sum(counts[k["name"]] for m in TITAN_MODELS
                                  for counts in datasets[f"titan_{m}"]["launches"].values())
        top = by_kernel[k["name"]]
        k["bf16"] = {"shape": top["shape"], "ms": top["ms"], "fp32_ms": top["fp32_ms"],
                     "cast_ms": top["cast_ms"],
                     "max_abs_err_vs_plain_rounded": top["max_abs_err_vs_plain_rounded"]}

    (OUT_DIR / "smoke_report.json").write_text(json.dumps(
        {"card": card, "kind": kind, "kernels": kernels, "predict_dummy": dummy,
         "full_size": full, "fit_dummy": fit, "full_size_train": train_full,
         "segformer_predict_dummy": seg_dummy, "segformer_fit_dummy": seg_fit,
         "segformer_full_size": seg_full, "halfunet_predict_dummy": unet_dummy,
         "halfunet_fit_dummy": unet_fit, "halfunet_full_size": unet_full,
         "hilam_predict_dummy": hilam_dummy, "hilam_fit_dummy": hilam_fit,
         "hilam_full_size": hilam_full, "hilam_full_size_train": hilam_train,
         "hilamparallel_predict_dummy": par_dummy, "hilamparallel_fit_dummy": par_fit,
         "hilamparallel_full_size": par_full, "observers": observers,
         "unet_predict_dummy": plain_dummy, "unet_fit_dummy": plain_fit,
         "unet_full_size": plain_full, "unetrpp_predict_dummy": rpp_dummy,
         "unetrpp_fit_dummy": rpp_fit, "unetrpp_full_size": rpp_full, "bf16": bf16,
         "resnet": resnet, "swin_table": swin_table, "data_axis": data_axis,
         "spatial": spatial, "datasets": datasets, "tools": tools,
         "weight_tools": weight_tools, "wide": wide,
         "wall_s": time.perf_counter() - t_start, "phase_wall_s": walls}, indent=1))
    log(f"wall: {time.perf_counter() - t_start:.1f} s")
    log(f"phase wall s: {json.dumps(walls)}")
    log(card)
    log(json.dumps({"kernels": [{k: v for k, v in row.items()
                                 if k not in ("shapes", "launches_by_model")}
                                for row in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
