#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (irdu_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each timed and printed as it ends:

  build     nvcc builds the port's CUDA kernels (kernels/csrc) into one library;
  serving   the main path: the 86k flagship snapshot loaded in bf16 answers five
            denoising requests through predict.denoise (512x512, 480x320,
            256x384, 1024x1024, 2048x2048; seeded piecewise-smooth images with
            seed-2204 sigma=25 noise). Each request must launch K3
            (fused_block_stack) exactly 3 times, K4 (fused_gated_block) 32 times
            and K2 (edge_weights_chw) 8 times, and the solver's planes K1
            (gg_unroll_chw, one call per plane of at most 768·1024 pixels) and
            K5 (gg_fused_step_chw, 5 calls per larger plane) as PER_REQUEST
            says, and raise the PSNR. Then each request is served once more with
            every kernel call held against its plain version on that call's own
            tensors (the bf16 bars below), and the 512x512 request is timed with
            the blocks on their kernels and on the plain PyTorch (cuDNN) route,
            in turns;
  profile   torch.profiler over PROFILE_REQUESTS steady 512x512 flagship
            requests: the 10 device kernels with the most total time and
            the device's idle share of the window (``profile_requests``);
  small     the lite and micro models (their default snapshots, bf16) answer
            the 512x512 request, counts zeroed just before each: lite must
            launch 5 K3, 10 K4, 4 K1, 8 K2 (its scale-0 C = 24 runs on the
            block kernel's padded channels), micro 7 K3, 2 K4, 4 K1, 8 K2; each
            raises the PSNR and every call is held against its plain version;
  pixel     the pixel-domain model (pixel_synthetic_2050.npz, bf16) answers
            512x512, 480x320 and 1024x1024 through predict.denoise, counts
            zeroed just before: each request must launch K2 once (2G = 48
            graphs, diamond-12) and K8 (pixel_segment_nhwc) exactly 6 times
            and no other kernel, and raise the PSNR; then on the CHW route
            (the NHWC flag off) the 512x512 request must launch K2 once and K7
            (gg_pixel_unroll_chw) once, and the 1024x1024 and 2048x2048
            requests (above K7's 768·1024 cap) K2 once and K5
            (gg_fused_step_chw, single-scale, diamond-12, reflect) 6 times,
            and raise the PSNR. Each request is served once more with every
            kernel call held against its plain version (K1's bf16 bar; K2's
            for K2), and the two routes are timed at 512x512, 1024x1024 and
            2048x2048 in turns (data, not a claim);
  ablation  the six configs/ablation_*.yaml models (ABLATION_MODELS: the
            configs' model sections, at their widths) built through
            models.registry.create_model with weights from a seeded
            generator, in bf16, answer the 512x512 request through
            predict.denoise, counts zeroed just before each: the launches
            must be ABLATION_LAUNCHES (one_graph_filter "single" and
            "single_split" exactly 3 K9, fused_system_matvec; "single_noGTV"
            none), the output finite; each is served once more with every
            kernel call held against its plain version (K1's bar for K1, K5
            and K9, K2's for K2, block_bar for K3 and K4); then each model in
            f32, kernels against plain, max|d| <= 1e-5 of max(1, max|ref|)
            (the random weights give outputs up to ~30, where f32 rounding
            alone is ~2e-6; no PSNR bar);
  kernels   each kernel against its plain PyTorch version on the card, in f32
            (atol 5e-4, rtol 1e-3) and bf16 (K2: max|d| <= 4e-3; K1: 4e-3 plus
            one bf16 ulp of the value; K3, K4: below): K1 and K2 at every shape a
            512x512 request gives them, with the snapshot's filter parameters;
            K3 and K4 at every block shape of the three requests, with the
            snapshot's block parameters; seeded inputs. In f32 every K1, K3 and
            K4 output must also move at least CHANGE_FACTOR times the bar away
            from its input, so that a kernel returning its input cannot pass;
            kernel and plain times from CUDA events at the 512x512 shapes,
            and beside each kernel time its device time (``device_ms``:
            torch.profiler over the same repetitions, the durations of the
            device events linked to the timed calls' launches, no host work
            in the window; the ``device_ms`` line says how each was taken).
            K1 also on the 480x320 request's 120x80 and 60x40 planes (ragged
            tiles), K4 also at micro's and the ablation heads' widths and K3
            at every other served shape, lite's, micro's and the split
            ablation heads', with seeded blocks, timed, each row naming the
            kernel that took it (K1_RAGGED, K4_EXTRA, K3_EXTRA); K1 and K3/K4
            times are the median of 3 repeats, kept with them, and K1's rows
            record the CTAs per SM of its cooperative grid.
            K3 and K4 in bf16 are held to block_bar: at most 1 % of the
            outputs beyond one ulp, none beyond one ulp plus the plain
            version's own bf16 rounding error, and an RMS error against the
            unrounded f32 function at most 1.1 times the plain version's.
            K5 in each mode, K6a (with and without GLR and identity) and K6b
            (with and without y) at the 1024x1024 request's scale-0 shape with
            the snapshot's scale-0 parameters, f32 (the bar above and the
            CHANGE_FACTOR rule) and bf16 (K1's bar); K5 against the K6a/K6b
            composition in f32; K5 timed at every shape the 1024x1024 and
            2048x2048 requests give it. Then the band route against the K1
            route on the 512x512 request's scale-0 code (K1's cap set to 0)
            on cross-4, diamond-12 and ring-8: f32 within 5e-4 + 1e-3·|ref|,
            and both routes timed in bf16 by device time, in turns. K1 on
            each of K1_OPTIONS (diamond-12, ring-8, cross-4 with the reflect
            pad, cross-4 without stats tables, diamond-12 with the reflect
            pad, ring-8 with the zero pad) at the 512x512 request's four
            scale shapes, bf16 within K1's bar and timed, one f32 row a
            option that moves its input by CHANGE_FACTOR times its bar
            (``k1_option_rows``); K3 with dw_mxu (the expand folded into the
            taps, ``block_stack_dw_mxu.cu``) at the 512x512 request's K3
            shape with the snapshot's blocks against its plain version,
            bf16 within block_bar and timed, f32 (``block_stack.cu``) with
            the CHANGE_FACTOR rule (``dw_mxu_rows``). K2 on the diamond-12
            window at (1, 144, 512, 512), K7 at the 512x512 pixel request's
            shapes and at K7_RAGGED (ragged tiles, a
            plane below one tile) and K8 in each mode at 512x512, with
            the pixel snapshot's parameters, f32 (the bar above, and for K7
            and K8 the CHANGE_FACTOR rule) and bf16 (K2's and K1's bars), timed
            in bf16; K7's row records the CTAs an SM of its cooperative grid,
            and the ``k7_band_512`` line times K7 against the pixel solver's
            six-call K5 band route on the same inputs, by device time, in
            turns. K5 in each pixel mode (rhs; cg from x, emitting the
            update; cg with beta*prev; rethresh with y) and K6a, K6b on
            diamond-12 with the reflect pad at the 1024x1024 pixel request's
            shape (1, 72, 1024, 1024), G = 24, and at 37x53 (ragged tiles),
            the same bars, K5 timed at 1024x1024 and 2048x2048. K9 at the
            "single" ablation's shape (1, 512, 512, 96), G = 1, and at
            (1, 37, 53, 40), G = 2 (ragged tiles and channel chunks), f32 and
            bf16, against its plain version and (f32) against K6a on the same
            data permuted to CHW. K5 two-scale at K5_RAGGED and K8 at
            K8_RAGGED (ragged tiles, odd H and W, a partial graph group),
            each mode, f32 and bf16, the same bars, untimed. The planners'
            shared-memory counts must equal the kernels' own layouts
            (``layout_mismatches``). K2 on the ring-8 window at GLR
            boosting's four calls of a 512x512 request (BOOSTING_K2, the
            snapshot's metric diagonals), f32 and bf16, timed in bf16
            (``boosting_k2_rows``);
  windows   every graph window the solver kernels take beyond the served ones
            (``phase_windows``): the pixel model (its snapshot, bf16) on
            cross-4 and ring-8 serves 512x512 on NHWC (1 K2, 6 K8), 512x512 on
            CHW (1 K2, 1 K7) and 1024x1024 on CHW (1 K2, 6 K5), and the 86k
            flagship on diamond-12 and ring-8 serves 512x512 with every plane
            under K1's cap on K1 (window_launches: 3 K3, 32 K4, 4 K1, 8 K2, no
            K5), each with its counts zeroed just before and read just
            after, then once more with every kernel call held against its
            plain version (K2's bar; K1's for K1, K5, K6a, K7, K8) and recorded,
            each kernel's calls of a request replayed and timed (ms,
            device_ms, plain_ms, bound); the pixel model with eval_skip_solve
            launches nothing; the WINDOW_ABLATIONS configs (seeded as the
            ablation phase seeds them) on diamond-12 and ring-8 serve 512x512
            the same way, with no K9: the two-scale solvers 1 K1 (their plane
            is under the cap) and no K5, the single-scale GTV+GLR solvers
            their 3 matvecs on K6a (``window_ablation_launches``); one f32 row per
            kernel and window at the served shapes (K2; K5 in the pixel mode
            at 1024x1024 and two-scale at the flagship's 512x512 scale 0; K7;
            K8 in each mode) and per ablation solver and window (kernels
            against plain on its 512x512 input), each moving its input by
            CHANGE_FACTOR times its bar;
  model     the whole model in f32 with TF32 off on each flagship request's
            noisy image (the first is 1x512x512x3): kernel path against plain
            path (blocks as PyTorch ops, the solver's plain versions),
            max|d| <= 1e-3, and the PSNR of both within 0.01 dB; the same for
            the pixel model on its 512x512 and 480x320 requests (the NHWC
            route, and at 512x512 the CHW route, against both solver flags
            off), on a 484x324 crop of the 512x512 one (H % 8 == 4, W %
            16 == 4: ragged tiles) on both kernel routes, and on the 1024x1024
            request on the CHW route (K5's pixel mode);
  eval      the eval protocol (irdu_tpu_torch.eval.harness.evaluate_pairs,
            bucket 64, seed-2204 sigma=25 noise) on the synthetic val set
            (data.synthetic.synthetic_val_set: 6 images at 384x512, made in
            memory) with each served snapshot in bf16 (EVAL_SNAPSHOTS: the
            flagship, lite and micro at cg3 and cg1, the pixel model on its
            served NHWC route and on its CHW route), counts zeroed just before
            each and read just after (6 times one image's launches,
            EVAL_PER_IMAGE): each mean PSNR with a JAX number (EVAL_TARGETS)
            within EVAL_BAR_DB of it, every variant's mean and per-image PSNR
            and gap printed on a line; each snapshot's cg3 in f32. The
            flagship (cg3) and the pixel model also at batches of 1 and
            EVAL_BATCH (evaluate_pairs_batched, scored on the card, MP/s
            printed): per-image PSNRs
            within EVAL_SAME_DB of one image a call; and the flagship in f32
            with its kernels against their plain versions, per image within
            EVAL_SAME_DB. Then the other snapshots with a JAX number
            (EVAL_MORE): the 50k flagship at cg3, cg1 and both with filter
            scales 1-3, the sigma-15 and sigma-50 flagships (the noise at
            their own sigma) and the distilled micro at cg3 and cg1, each
            within EVAL_BAR_DB of its EVAL_TARGETS number with its launches,
            and each snapshot's cg3 in f32;
  variants  the three configurations of conv_variant and the v4 pixel core
            (VARIANT_MODELS, the configs' model sections at their widths;
            seeded weights) serve the 512x512 request in bf16, counts zeroed
            just before: the conv-variant flagships launch as the plain one
            (σ and the gain folded into the kernels), the no-stencil pixel
            core K2 and 6 K8 (VARIANT_LAUNCHES); every kernel call held
            against its plain version, the pixel core's CHW route (K2, K7)
            too; served again with the kernels off; then in f32
            with the kernels on and off, max|d| <= VARIANT_F32_ATOL and <=
            ABLATION_F32_BAR of max(1, max|ref|) (seeded non-expansive
            weights give outputs near 0.004). The same for the full-width
            flagship of nsubnets 2 at every scale (SUBNET_MODEL, seeded): a
            512x512 request's launches (3 K3, 32 K4, 4 K1, 8 K2: the grouped
            blocks on K3/K4 with block-diagonal operands), every K3/K4 call
            within block_bar, its K3 and K4 calls replayed and timed by
            device time (``subnet_variant``);
  tile      tiled inference (parallel.spatial.tiled_forward, TILE-pixel tiles,
            TILE_HALO halo) on the flagship: f32 at TILE_F32, kernels against
            plain, max|d| <= 1e-3; bf16 at TILE_BF16 through
            predict.denoise(tile=TILE), counts zeroed just before (16 tiles,
            each a 512x512 request's launches), timed in turns against the
            whole-image request, both PSNRs and their gap printed;
  natural   the natural-image set (artifacts/natural_eval: 4 RGB PNGs read
            without PIL, with their suspect masks) through eval.natural in
            bf16: the noisy input's rows at sigma 25, 15 and 50 within
            NATURAL_NOISY_DB of the JAX script's, and the nine snapshots of
            NATURAL_ROWS (each at its sigma) within EVAL_BAR_DB of JAX's means,
            per-image gaps printed, 4 images' launches each;
  baselines GLR boosting and the baselines with their snapshots
            (BASELINE_ROWS), loaded by predict.load_model in bf16: the eval
            protocol on the synthetic val set (dncnn, drunet, restormer
            within EVAL_BAR_DB of JAX's 21.901, 30.461, 38.373; boosting's
            printed, JAX has none) and the natural set at sigma 25 (within
            EVAL_BAR_DB of JAX's 24.952, 21.718, 24.902, 25.224, per-image
            gaps printed), counts zeroed just before each: boosting exactly
            4 K2 (ring-8) an image and no other kernel, its natural run
            again with every K2 call held against its plain version; the
            baselines no launch at all; each model's 512x512 request timed
            (data). Then the zoo's eight models without a snapshot
            (BASELINE_SEEDED, the JAX constructors' default widths, seeded
            weights) at 128x128: f32 on the card within 1e-3 of max(1,
            max|ref|) of the same weights on the CPU, bf16 finite, no
            launch (``phase_baselines``);
  deploy    the serving export (irdu_tpu_torch.deploy): the 50k flagship in
            bf16, again with int8 pointwise weights, and the pixel model, each
            exported at 1x384x512x3 to a file, loaded by a fresh
            load_exported and run through the protocol: within EVAL_BAR_DB of
            JAX's number (44.743, 44.911, 36.84), every image within
            EVAL_SAME_DB of the same model run eagerly, with the eager run's
            launches; the int8 artifact carries 110 int8 tensors and is the
            smaller; bytes, export and load seconds and the request ms eager
            against the artifact (in turns) printed;
  train     the trainer (irdu_tpu_torch.train) on the card, each of the
            configs flagship_sigma25, micro_distill_sigma25 and
            lightformer_pixel_sigma (TRAIN_CONFIGS, held to the YAML by a CPU
            test) cut to stage 0 with TRAIN_PATCHES crops, on the synthetic
            train set in memory: the flagship at full width in f32 runs 2
            steps with a checkpoint and an eval, resumes in a fresh Trainer
            to step 4 (state and batches bitwise, no launch in a step, every
            parameter with a non-zero gradient); one loss and backward on the
            card against the CPU; distillation from the config's teacher
            (flagship_synthetic_2050.npz) in bf16
            on K3, K4, K2 and K1 (each teacher forward one 128x128 request's
            launches, its first step's calls held against their plain
            versions, the student none, remat on against off), 6 steps on
            one batch lowering the loss; the pixel model 3 steps; the trained
            student written with save_params_npz and served by predict in the
            eval protocol with micro's launches; the autograd guard raising
            (``phase_train``);
  stages    every curriculum stage of flagship_sigma25 (128² batch 4 to 384²
            batch 1) and lightformer_pixel_sigma (64² batch 16 to 512² batch
            1) at full width in f32, each stage alone, remat off then on: 2
            Trainer steps each, the second step's ms, peak allocated and
            reserved GiB, finite losses and gradients, no launch in a step;
            out of memory with remat off is a recorded reading (the bytes
            asked for), with remat on a failure. The native C++ batch path
            (data/native) built with g++; on the flagship's stage 3 and the
            pixel's stage 0 the step loop's wait in next(loader) against its
            step for the python and the native backend, and their first 3
            batches bitwise equal (``phase_stages``). Stages 1-3 run with
            remat off only (STAGE_REMAT: room for the parallel phase);
  parallel  multi-GPU on the one card (``phase_parallel``): two groups of
            PARALLEL_WORLD gloo ranks spawned together after the build (the
            train legs in one, the serving paths in the other), each rank
            on cuda:0, each reporting its launches: two DDP steps of
            flagship_sigma25's model (full width, f32, plain versions) on
            global batches of
            PARALLEL_BATCH 128² images, loss and gradients within
            TRAIN_GRAD_RTOL of each tensor's max of one process's steps on
            the same batches, no launch in a step; one tensor-parallel step
            (tp = 2, the Megatron and expert splits) on PARALLEL_TP_BATCH of
            them, loss within 1e-4 of one process's; one tp = 2 step of
            ablation_no_latent (PARALLEL_ABLATION: 2 images cropped to 64²,
            its MixtureGTVGLR experts and its heads' gated blocks split),
            loss within 1e-4 of one process's; the 86k snapshot in
            bf16 on the 2048x2048 request through halo_shard_forward
            (PARALLEL_HALO rows; each rank's 1152x2048 window: 3 K3, 32 K4,
            3 K1, 8 K2, 5 K5) and sharded_tiled_forward (PARALLEL_TILE tiles,
            PARALLEL_TILE_HALO halo; each rank 32 windows of 320x320 as one
            batch: 3 K3, 32 K4, 4 K1, 8 K2), max|d| within K1's bf16 bar of
            the whole-image request and of the one-rank run of the same
            function, both PSNRs printed, rank 0's first run of each path
            with every kernel call held against its plain version. Meanwhile
            NCCL at world size 1 in this process: one DDP step (loss within
            1e-4 of one process's) and one halo_shard_forward (the whole
            image).
            The line names the backends, world sizes and how the halo rows
            travelled (host buffers under gloo).

The build must take under 60 s, the windows phase under 30 s, the parallel
phase under 60 s, the train,
baselines and stages phases under 90 s each, the deploy phase under 120 s
and the whole script under 450 s; a run over any budget fails.

Stdout ends with the card's name and power limit, a JSON line of per-kernel
results, the serving, ``k7_band_512``, windows, model, eval, variants, tile, natural,
baselines, deploy, train, stages, parallel and
``device_ms`` lines, the phase times and, only when every phase passed,
{"ok": true, "device": {...}}. Details go to chiprun_out/. Exits non-zero
without a CUDA card, without the package beside this script, or when any
phase fails.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")
BUDGET_S = {"build": 60, "train": 90, "deploy": 120, "baselines": 90, "stages": 90,
            "parallel": 60, "windows": 30, "total": 450}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
BF16_TC_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores
DEVICE = "cuda"
FRAME = 512  # the kernel phase runs at the shapes of a FRAME² request
REQUESTS = ((512, 512), (480, 320), (256, 384), (1024, 1024), (2048, 2048))
BAND = 1024  # the kernel phase's K5, K6a and K6b rows run at the shapes of a BAND² request
K3_PER_REQUEST, K4_PER_REQUEST = 3, 32
K4_PER_SCALE = {1: 12, 2: 12, 3: 8}  # encoder + decoder blocks at scales 1-2, encoder at 3
KERNEL_NAMES = ("fused_block_stack", "fused_gated_block", "gg_unroll_chw", "edge_weights_chw",
                "gg_fused_step_chw", "gg_matvec_chw", "gtv_rethresh_chw", "gg_pixel_unroll_chw",
                "pixel_segment_nhwc", "fused_system_matvec")


def launches(k3, k4, k1, k2, k5, k7=0, k8=0, k9=0):
    """Launches of one request at cg3 (K6a and K6b are K5's oracles only)."""
    return dict(zip(KERNEL_NAMES, (k3, k4, k1, k2, k5, 0, 0, k7, k8, k9)))


# K1 takes a scale's plane up to 768·1024 pixels (W rounded up to 128, both
# extents ≤ 1024) in one call; a larger plane takes 5 K5 steps: scale 0 at
# 1024², scales 0 and 1 at 2048²
PER_REQUEST = {(512, 512): launches(3, 32, 4, 8, 0), (480, 320): launches(3, 32, 4, 8, 0),
               (256, 384): launches(3, 32, 4, 8, 0), (1024, 1024): launches(3, 32, 3, 8, 5),
               (2048, 2048): launches(3, 32, 2, 8, 10)}
# the smaller members of the family at 512² (lite: C = 24, 48 on K3, 96, 192
# on K4; micro: C = 16, 32, 64 on K3, 128 on K4)
SMALL_MODELS = {"lite": launches(5, 10, 4, 8, 0), "micro": launches(7, 2, 4, 8, 0)}
# the pixel model (its snapshot, bf16): every request on the NHWC route, K2
# once on 2G graphs and 6 K8 segments; the 512x512 one once more on the CHW
# route, K2 once and K7 once
PIXEL_REQUESTS = ((512, 512), (480, 320), (1024, 1024))
PIXEL_RAGGED = (484, 324)  # a crop of the 512x512 request for the f32 model check
PIXEL_NHWC = launches(0, 0, 0, 1, 0, k8=6)
PIXEL_CHW = launches(0, 0, 0, 1, 0, k7=1)
# the CHW route above K7's cap: K2 once, then 6 single-scale K5 steps
PIXEL_BAND_REQUESTS = ((1024, 1024), (2048, 2048))
PIXEL_CHW_BAND = launches(0, 0, 0, 1, 6)
K8_CALLS = {"rhs": 1, "cg1": 2, "cg2": 2, "rethresh": 1}  # per pixel request
# the windows phase: the pixel model on its other windows, each served on
# the routes and sizes of WINDOW_PIXEL_RUNS; the flagship on its other
# windows at WINDOW_FLAGSHIP_REQUEST (K1 under its cap, the K5 band route
# above it: window_launches); the kernels whose calls there are timed
# (WINDOW_REPS replays of a request's calls)
WINDOW_PIXEL = ("cross4", "ring8")
WINDOW_PIXEL_RUNS = (("nhwc", (512, 512), PIXEL_NHWC), ("chw", (512, 512), PIXEL_CHW),
                     ("chw", (1024, 1024), launches(0, 0, 0, 1, 6)))
WINDOW_FLAGSHIP = ("diamond12", "ring8")
WINDOW_FLAGSHIP_REQUEST = (512, 512)
WINDOW_KERNELS = ("edge_weights_chw", "gg_fused_step_chw", "gg_pixel_unroll_chw",
                  "pixel_segment_nhwc", "gg_matvec_chw", "gg_unroll_chw")
# the ablation configs whose solver takes the graph window, each served at
# ABLATION_SIDE² on WINDOW_FLAGSHIP's windows: the two-scale solver (K1) and
# the single-scale GTV+GLR solver (its matvecs on K6a)
WINDOW_ABLATIONS = ("ablation_no_latent", "ablation_no_latent_no_mixture",
                    "ablation_no_orders", "ablation_no_orders_split")
# the variants phase's full-width flagship of 2 subnets at every scale
# (seeded weights; no config sets nsubnets): blocks on K3/K4 with dense
# block-diagonal operands and the per-subnet norm
SUBNET_MODEL = {"type": "abstract_multiscale_graph_filter", "dims": [48, 96, 192, 384],
                "hidden_dims": [96, 192, 384, 768], "ngraphs": [8, 16, 16, 32],
                "num_blocks": [4, 6, 6, 8], "num_blocks_out": 4, "nsubnets": [2, 2, 2, 2]}
SUBNET_SEED = 22
WINDOW_REPS = 3
# K5's pixel mode per pixel request on the CHW route above the cap
K5_PIXEL_CALLS = {"rhs": 1, "cg_use_x_rhs_emit_update": 2, "cg_prev": 2, "rethresh_y": 1}
# the six configs/ablation_*.yaml models, their ``model:`` sections as the
# files give them (the card's machine has no PyYAML; a CPU test holds these to
# the files), each served once at ABLATION_SIDE² in bf16 with seeded weights
ABLATION_MODELS = {
    "ablation_no_latent": {"type": "multiscale_graph_filter", "ngraphs": 32},
    "ablation_no_latent_no_mixture": {"type": "one_graph_filter", "n_channels_hidden": 96,
                                      "solver": "two_scale_nl"},
    "ablation_no_mixture": {"type": "abstract_multiscale_graph_filter",
                            "dims": [48, 96, 192, 384], "hidden_dims": [96, 192, 384, 768],
                            "ngraphs": [1, 1, 1, 1], "num_blocks": [4, 6, 6, 8],
                            "num_blocks_out": 4},
    "ablation_no_orders": {"type": "one_graph_filter", "n_channels_hidden": 96,
                           "solver": "single"},
    "ablation_no_orders_noGTV": {"type": "one_graph_filter", "n_channels_hidden": 96,
                                 "solver": "single_noGTV"},
    "ablation_no_orders_split": {"type": "one_graph_filter", "n_channels_hidden": 96,
                                 "solver": "single_split"},
}
ABLATION_SIDE = 512
# launches per ABLATION_SIDE² request: the nonlinear3 heads run 3 blocks on K4
# at C = 96 (2 heads on the two-scale solvers), the split heads one K3 each at
# C = 48; K2 once per scale on the stacked graphs; the single-scale GTV+GLR
# solver 3 K9; no_mixture is the flagship's path with one graph per scale
ABLATION_LAUNCHES = {
    "ablation_no_latent": launches(0, 6, 1, 2, 0),
    "ablation_no_latent_no_mixture": launches(0, 6, 1, 2, 0),
    "ablation_no_mixture": launches(3, 32, 4, 8, 0),
    "ablation_no_orders": launches(0, 3, 0, 1, 0, k9=3),
    "ablation_no_orders_noGTV": launches(0, 3, 0, 1, 0),
    "ablation_no_orders_split": launches(2, 0, 0, 1, 0, k9=3),
}
ABLATION_F32_BAR = 1e-5  # the f32 forward, kernels against plain, of max(1, max|ref|)
K9_SHAPE = (1, 512, 512, 96)  # the "single" ablation's matvec at 512x512, G = 1
# ragged 16x16 tiles both ways, G = 2 graphs of F = 20 channels: a partial last chunk
# of 8 lanes in each graph
K9_RAGGED = (1, 37, 53, 40)
# K5's pixel mode and K6a/K6b on diamond-12 also at ragged tiles (the
# single-scale 16x64 tiles K6a/K6b launch too), odd H and W
STEP_RAGGED = (37, 53)
K9_CALLS = 3  # per "single" request
# K7 also on ragged 16x64 tiles with odd H and W, and on a plane smaller than
# one tile, with the pixel snapshot's G = 24, F = 3
K7_RAGGED = ((37, 53), (12, 40))
LOUD = (1, 20, 20, 1)  # per-scale factor on the snapshot's μ, ρ, γ in the K1 rows
# K1 also at the 480x320 request's scale-2 and scale-3 planes (ragged 32x64
# tiles; the 60x40 plane is smaller than one tile)
K1_RAGGED = ((2, (120, 80)), (3, (60, 40)))
# K5 two-scale on ragged 32x64 tiles (every plan's tiles cut short in both
# directions): (H, W), G, F
K5_RAGGED = ((74, 134), 2, 6)
# K8 on ragged 16x32 tiles with odd H and W: G = 5 (a partial last graph
# group, lane-by-lane loads) and the pixel model's G = 24, F = 3
K8_RAGGED = ((37, 53), (5, 24), 3)
# K4 also at the served shapes outside the flagship: micro's C = 128 (hidden
# 256) at 64², the ablation heads' C = 96 (hidden 256) at 512² and 256²
K4_EXTRA = ((128, 256, 64, 64), (96, 256, 512, 512), (96, 256, 256, 256))
# K3 also at every other served shape, with seeded blocks: (model whose
# 512x512 request makes the call, C, hidden, blocks, H, W, calls per request):
# lite's scale 0 (C = 24, on block_stack.cu) and scale 1, micro's scales 0-2,
# the split ablation heads (2 per request)
K3_EXTRA = (("lite", 24, 48, 2, 512, 512, 3), ("lite", 48, 96, 3, 256, 256, 2),
            ("micro", 16, 32, 2, 512, 512, 3), ("micro", 32, 64, 2, 256, 256, 2),
            ("micro", 64, 128, 2, 128, 128, 2),
            ("ablation_no_orders_split", 48, 128, 3, 512, 512, 2))
# the eval protocol (irdu_tpu_torch.eval): the synthetic val set (6 images,
# 384x512), seed-2204 sigma=25 noise, bucket 64; each served snapshot's
# variants, and the JAX package's PSNR on the same protocol (bf16 on the TPU)
EVAL_SNAPSHOTS = (("flagship", (3, 1)), ("lite", (3, 1)), ("micro", (3, 1)), ("pixel", (3,)))
EVAL_TARGETS = {
    "flagship-cg3": (47.335, "artifacts/round5_eval/curve_cont100k.log:4"),
    "lite-cg3": (32.224, "PERF.md at 577e783, lines 170-178"),
    "lite-cg1": (32.174, "PERF.md at 577e783, lines 170-178"),
    "micro-cg3": (31.307, "PERF.md at 577e783, lines 170-178"),
    "micro-cg1": (31.162, "PERF.md at 577e783, lines 170-178"),
    "pixel": (36.84, "PERF.md at 577e783, line 342"),
}
# the other snapshots with a JAX number on the protocol: (label, family,
# snapshot, sigma of the noise, (cg_iters, filter_scales) per variant); each
# variant's tag is eval.curve.variant_tag(label, cg, filter_scales)
EVAL_MORE = (
    ("flagship50k", "flagship", "flagship_50k_51000.npz", 25.0,
     ((3, None), (1, None), (3, (1, 2, 3)), (1, (1, 2, 3)))),
    ("s15", "flagship", "flagship_synthetic_s15_2050.npz", 15.0, ((3, None),)),
    ("s50", "flagship", "flagship_synthetic_s50_2050.npz", 50.0, ((3, None),)),
    ("distill50k", "micro", "micro_distill50k_2050.npz", 25.0, ((3, None), (1, None))),
)
EVAL_TARGETS.update({
    "flagship50k-cg3": (44.743, "artifacts/round4_eval/curve_flagship50k.log:2"),
    "flagship50k-cg1": (41.434, "artifacts/round4_eval/curve_flagship50k.log:3"),
    "flagship50k-cg3-fs123": (39.504, "artifacts/round4_eval/curve_flagship50k.log:4"),
    "flagship50k-cg1-fs123": (39.493, "artifacts/round4_eval/curve_flagship50k.log:5"),
    "s15-cg3": (34.787, "artifacts/round5_eval/curve_s15.log:4 (sigma 15)"),
    "s50-cg3": (31.512, "artifacts/round5_eval/curve_s50.log:4 (sigma 50)"),
    "distill50k-cg3": (31.383, "artifacts/round4_eval/curve_distill50k.json"),
    "distill50k-cg1": (31.220, "artifacts/round4_eval/curve_distill50k.json"),
})
EVAL_BAR_DB = 0.05  # BASELINE.md:25
EVAL_SAME_DB = 0.01  # batched against sequential; kernels against plain in f32
EVAL_BATCH = 4
# launches of one 384x512 val image (the served route; pixel on NHWC, and on CHW)
EVAL_PER_IMAGE = {"flagship": launches(3, 32, 4, 8, 0), **SMALL_MODELS, "pixel": PIXEL_NHWC,
                  "pixel-chw": PIXEL_CHW,
                  "flagship-fs123": launches(3, 32, 3, 6, 0)}  # scale 0 not filtered
# the natural-image set (artifacts/natural_eval: 4 RGB PNGs, 66x484, 124x143,
# 157x483, 470x235, and their suspect masks) through eval.natural in bf16: the
# noisy input's rows (sigma: psnr, masked psnr, source) and each snapshot's
# mean (sigma, family, snapshot, JAX's mean, JAX's per-image row), from the
# JAX script's results_sigma*.jsonl and logs
NATURAL_NOISY = {25.0: (20.584919084147636, 20.58418993708186,
                        "artifacts/natural_eval/results_sigma25.jsonl:1"),
                 15.0: (24.8693972636648, 24.869601951620016,
                        "artifacts/round5_eval/nat_s15.log:1"),
                 50.0: (15.067518997534416, 15.063832718427465,
                        "artifacts/round5_eval/nat_s50.log:1")}
NATURAL_NOISY_DB = 1e-6
NATURAL_ROWS = (
    (25.0, "flagship", "flagship_cont100k_35000.npz", 29.144, (31.463, 27.467, 30.173, 27.473)),
    (25.0, "flagship", "flagship_50k_51000.npz", 28.713, (31.488, 26.273, 30.127, 26.964)),
    (25.0, "flagship", "flagship_synthetic_2050.npz", 24.427, (26.528, 20.793, 25.39, 24.996)),
    (25.0, "lite", "lite_synthetic_2050.npz", 24.339, (27.007, 20.735, 25.331, 24.286)),
    (25.0, "micro", "micro_synthetic_2050.npz", 24.030, (26.482, 21.101, 25.241, 23.296)),
    (25.0, "micro", "micro_distill50k_2050.npz", 23.941, (26.536, 21.029, 25.038, 23.159)),
    (25.0, "pixel", "pixel_synthetic_2050.npz", 25.635, (28.766, 21.118, 26.131, 26.524)),
    (15.0, "flagship", "flagship_synthetic_s15_2050.npz", 26.066, (28.072, 21.872, 27.203, 27.118)),
    (50.0, "flagship", "flagship_synthetic_s50_2050.npz", 23.410, (25.887, 20.056, 24.21, 23.489)),
)
# GLR boosting and the baselines with their snapshots (bf16; predict's builds,
# JAX's constructions): (family, snapshot, JAX's protocol number and its
# source, or None: JAX has none, JAX's natural-set sigma-25 mean and per-image
# row, artifacts/natural_eval/results_sigma25.jsonl:10-13)
BASELINE_ROWS = (
    ("boosting", "boosting_synthetic_2050.npz", None,
     24.952, (26.283, 22.426, 26.521, 24.578)),
    ("dncnn", "dncnn_synthetic_2050.npz", (21.901, "artifacts/round4_eval/curve_dncnn.log:2"),
     21.718, (21.912, 20.848, 21.638, 22.472)),
    ("drunet", "drunet_synthetic_2050.npz", (30.461, "artifacts/round4_eval/curve_drunet.log:2"),
     24.902, (26.378, 21.979, 26.391, 24.861)),
    ("restormer", "restormer_synthetic_2050.npz",
     (38.373, "artifacts/round4_eval/curve_restormer.log:4"),
     25.224, (28.026, 20.906, 25.726, 26.236)),
)
# one image's launches: boosting's K2 once a level on ring-8; the baselines none
BASELINE_PER_IMAGE = {"boosting": launches(0, 0, 0, 4, 0)}
# GLR boosting's K2 calls at a FRAME² request: (level, node features F); G = 5
BOOSTING_K2 = ((0, 12), (1, 12), (2, 24), (3, 48))
BOOSTING_GRAPHS = 5
# the models of the zoo without a snapshot, at the JAX constructors' default
# widths with weights from a seeded generator: one BASELINE_SIDE² request each,
# f32 on the card against the same weights on the CPU within BASELINE_F32_BAR
# of max(1, max|ref|), then bf16 on the card, finite; model: input channels
BASELINE_SEEDED = {"fdncnn": 2, "ircnn": 1, "unet": 1, "resunet": 1, "unetres_subp": 1,
                   "unetplus": 3, "nonlocal_unet": 3, "swinir": 3}
BASELINE_SIDE = 128
BASELINE_F32_BAR = 1e-3
# the serving export (irdu_tpu_torch.deploy) on the card: (tag, family,
# snapshot, int8 pointwise weights, input shape, JAX's protocol PSNR and its
# source); each artifact runs the protocol on the synthetic val set
DEPLOY_ROWS = (
    ("flagship50k-bf16", "flagship", "flagship_50k_51000.npz", False, (1, 384, 512, 3),
     44.743, "artifacts/round4_eval/curve_flagship50k.log:2"),
    ("flagship50k-int8", "flagship", "flagship_50k_51000.npz", True, (1, 384, 512, 3),
     44.911, "artifacts/round4_eval/int8.log:6"),
    ("pixel-bf16", "pixel", "pixel_synthetic_2050.npz", False, (1, 384, 512, 3),
     36.84, "PERF.md at 577e783, line 342"),
)
DEPLOY_INT8_KERNELS = 110  # JAX's count of quantized 2-D kernels (int8.log:6)
DEPLOY_ROUNDS = 1  # request timing, eager and artifact in turns
DEPLOY_REQUESTS = 3  # timed requests a turn
# the configurations the registry built last: their ``model:`` sections as the
# files give them (a CPU test holds these to the files), served at 512x512 with
# seeded weights; the pixel model with both solver flags on, as predict serves
# its family: its no-stencil core takes K2 and K8 with the identity stencil
VARIANT_MODELS = {
    "flagship_sigma25_nonexpansive": {
        "type": "abstract_multiscale_graph_filter", "n_channels_in": 3, "n_channels_out": 3,
        "dims": [48, 96, 192, 384], "hidden_dims": [96, 192, 384, 768],
        "nsubnets": [1, 1, 1, 1], "ngraphs": [8, 16, 16, 32], "num_blocks": [4, 6, 6, 8],
        "num_blocks_out": 4, "conv_variant": "non_expansive"},
    "flagship_sigma25_spectral": {
        "type": "abstract_multiscale_graph_filter", "n_channels_in": 3, "n_channels_out": 3,
        "dims": [48, 96, 192, 384], "hidden_dims": [96, 192, 384, 768],
        "nsubnets": [1, 1, 1, 1], "ngraphs": [8, 16, 16, 32], "num_blocks": [4, 6, 6, 8],
        "num_blocks_out": 4, "conv_variant": "spectral_norm"},
    "lightformer_pixel_v4": {
        "type": "multiscale_sequence_denoiser", "n_graphs": 16, "n_node_fts": 3,
        "n_cnn_fts": 48, "window": "diamond12", "stats_mode": "none", "feature_n_levels": 4},
}
VARIANT_SERVE = {"multiscale_sequence_denoiser": {"use_pallas_solver": True,
                                                   "use_nhwc_solver": True}}
# the served routes' launches: the variant's factors folded into the block
# kernels' operands, the no-stencil pixel core on NHWC
VARIANT_LAUNCHES = {"flagship_sigma25_nonexpansive": PER_REQUEST[(512, 512)],
                    "flagship_sigma25_spectral": PER_REQUEST[(512, 512)],
                    "lightformer_pixel_v4": PIXEL_NHWC}
VARIANT_F32_ATOL = 1e-3
# tiled inference on the flagship: f32 at TILE_F32 (kernels against plain),
# bf16 at TILE_BF16 (timed against the whole-image request, in turns)
TILE, TILE_HALO = 512, 64
TILE_F32, TILE_BF16 = (1024, 1024), (2048, 2048)
TILE_ROUNDS = 1
# the training configurations as the files give them (the card's machine has
# no PyYAML; a CPU test holds these to the files): manual_seed, model,
# parallel, datasets.train without its two paths, train
_FLAGSHIP_STAGES = [{"patch_size": 128, "batch_size": 4, "max_num_patchs": 800000},
                    {"patch_size": 192, "batch_size": 3, "max_num_patchs": 600000},
                    {"patch_size": 256, "batch_size": 2, "max_num_patchs": 400000},
                    {"patch_size": 384, "batch_size": 1, "max_num_patchs": 200000}]
_FLAGSHIP_NOISE = {"dist_mode": "addictive_noise_scale", "lambda_noise": 25.0,
                   "use_data_aug": True, "seed": 2204}
TRAIN_CONFIGS = {
    "flagship_sigma25": {
        "manual_seed": 3407,
        "model": {"type": "abstract_multiscale_graph_filter", "n_channels_in": 3,
                  "n_channels_out": 3, "dims": [48, 96, 192, 384],
                  "hidden_dims": [96, 192, 384, 768], "nsubnets": [1, 1, 1, 1],
                  "ngraphs": [8, 16, 16, 32], "num_blocks": [4, 6, 6, 8], "num_blocks_out": 4},
        "parallel": {"data_parallel": "auto"},
        "datasets_train": _FLAGSHIP_NOISE,
        "train": {"num_epochs": 1, "stages": _FLAGSHIP_STAGES, "schedule": {"type": "flagship"},
                  "use_aux_losses": True, "loss02_weight": 0.1, "loss03_weight": 0.5,
                  "verbose_rate": 100, "checkpoint_rate": 5000, "eval_rate": 1000,
                  "keep_checkpoints": 5}},
    "micro_distill_sigma25": {
        "manual_seed": 3407,
        "model": {"type": "abstract_multiscale_graph_filter", "n_channels_in": 3,
                  "n_channels_out": 3, "dims": [16, 32, 64, 128],
                  "hidden_dims": [32, 64, 128, 256], "nsubnets": [1, 1, 1, 1],
                  "ngraphs": [4, 4, 8, 8], "num_blocks": [2, 2, 2, 2], "num_blocks_out": 2,
                  "remat": True},
        "parallel": {"data_parallel": "auto"},
        "datasets_train": _FLAGSHIP_NOISE,
        "train": {"num_epochs": 1, "stages": _FLAGSHIP_STAGES, "schedule": {"type": "flagship"},
                  "use_aux_losses": True, "loss02_weight": 0.1, "loss03_weight": 0.5,
                  "distill": {"model": {"type": "abstract_multiscale_graph_filter",
                                        "dims": [48, 96, 192, 384],
                                        "hidden_dims": [96, 192, 384, 768],
                                        "ngraphs": [8, 16, 16, 32], "num_blocks": [4, 6, 6, 8],
                                        "num_blocks_out": 4, "use_pallas_blocks": True,
                                        "use_pallas_solver": True},
                              "weights": "artifacts/weights/flagship_synthetic_2050.npz",
                              "weight": 1.0, "dtype": "bfloat16"},
                  "verbose_rate": 100, "checkpoint_rate": 5000, "eval_rate": 1000,
                  "keep_checkpoints": 5}},
    "lightformer_pixel_sigma": {
        "manual_seed": 3407,
        "model": {"type": "multiscale_sequence_denoiser", "n_graphs": 24, "n_node_fts": 3,
                  "n_cnn_fts": 72, "window": "diamond12"},
        "parallel": {"data_parallel": "auto"},
        "datasets_train": {"dist_mode": "vary_addictive_noise",
                           "lambda_noise": [[1.0, 10.0, 15.0, 20.0, 25.0],
                                            [0.1, 0.1, 0.1, 0.1, 0.6]],
                           "use_data_aug": True},
        "train": {"num_epochs": 1,
                  "stages": [{"patch_size": 64, "batch_size": 16, "max_num_patchs": 800000},
                             {"patch_size": 128, "batch_size": 4, "max_num_patchs": 600000},
                             {"patch_size": 256, "batch_size": 2, "max_num_patchs": 400000},
                             {"patch_size": 512, "batch_size": 1, "max_num_patchs": 200000}],
                  "schedule": {"type": "multistep", "base_lr": 0.0004,
                               "milestones": [200000, 500000, 650000], "gamma": 0.5},
                  "use_aux_losses": False}},
}
# the train phase cuts each run to stage 0 with TRAIN_PATCHES crop positions
# (the configs' 800000 cost seconds of crop draws a dataset)
TRAIN_PATCHES = 2400
TRAIN_STEPS = {"flagship": (2, 4), "distill": 3, "pixel": 3, "fixed_batch": 6}
TRAIN_GRAD_BATCH = 1  # images of the step's batch in the card-against-CPU gradient
TRAIN_GRAD_SIDE = 64  # ... each its top-left crop of this side (the CPU's backward is the cost)
# the stages phase: every stage of these configs alone, STAGE_STEPS steps
# from STAGE_BATCHES batches of crops, under remat off and on; the loop's
# wait on its loader measured on the stage LOADER_WAIT names, LOADER_STEPS
# steps a backend
STAGE_CONFIGS = ("flagship_sigma25", "lightformer_pixel_sigma")
STAGE_STEPS, STAGE_BATCHES = 2, 3
STAGE_REMAT = {1: (False,), 2: (False,), 3: (False,)}  # by stage index; else off, on
# the parallel phase: spawned gloo ranks on the one card; the train legs on
# flagship_sigma25's model at its stage-0 patch, the serving legs on the
# 86k snapshot at the last REQUESTS image
PARALLEL_WORLD = 2
PARALLEL_GROUPS = ("train", "paths")  # two groups of PARALLEL_WORLD ranks, run together
PARALLEL_SIDE, PARALLEL_BATCH, PARALLEL_STEPS, PARALLEL_TP_BATCH = 128, 4, 2, 2
PARALLEL_SEED = 20
PARALLEL_HALO, PARALLEL_TILE, PARALLEL_TILE_HALO = 64, 256, 32
PARALLEL_LOSS_ATOL = 1e-4  # tensor parallel against one process (JAX's dryrun bar)
# the tp = 2 step of an ablation config (its MixtureGTVGLR experts and its
# heads' gated blocks split): the config, then the images of the first
# global batch and the side of their top-left crop
PARALLEL_ABLATION = ("ablation_no_latent", 2, 64)
LOADER_WAIT = {"flagship_sigma25": 3, "lightformer_pixel_sigma": 0}
LOADER_STEPS = 2
GIB = 2 ** 30
TRAIN_GRAD_RTOL = 1e-3  # card against CPU: max|d| <= this of max(1e-6, max|g_cpu|), per tensor
TRAIN_LOSS_RTOL = 1e-5
PROFILE_REQUESTS = 3  # steady 512x512 flagship requests under torch.profiler
CHANGE_FACTOR = 10  # K1: max|out - y| must be this many times the agreement bar
# The compiled variants of a kernel with several, listed on the kernels line
# (K1: one instance file per window, each with an instance whose pad is
# "edge", which every model sends, and one that reads the other pads at run
# time), each with the basis of its rows.
KERNEL_INSTANCES = {"gg_unroll_chw": [
    dict(window=window, pad=pad, source=f"irdu_tpu_torch/kernels/csrc/{source}", basis=basis)
    for window, source, (edge, other) in (
        ("cross4", "gg_unroll.cu", (["512x512 request",
                                     "512x512 request's shapes, cross4 no stats"],
                                    ["512x512 request's shapes, cross4 reflect"])),
        ("diamond12", "gg_unroll_diamond12.cu", (["512x512 request's shapes, diamond12",
                                                  "512x512 request, diamond12"],
                                                 ["512x512 request's shapes, diamond12 reflect"])),
        ("ring8", "gg_unroll_ring8.cu", (["512x512 request's shapes, ring8",
                                          "512x512 request, ring8"],
                                         ["512x512 request's shapes, ring8 zero"])))
    for pad, basis in (("edge", edge), ("zero, reflect", other))]}
# K1's options beyond the served cross-4 "edge" (``k1_option_rows``): window,
# stencil pad, stats tables set to None; every instance of KERNEL_INSTANCES
K1_OPTIONS = {"diamond12": ("diamond12", "edge", False), "ring8": ("ring8", "edge", False),
              "cross4 reflect": ("cross4", "reflect", False),
              "cross4 no stats": ("cross4", "edge", True),
              "diamond12 reflect": ("diamond12", "reflect", False),
              "ring8 zero": ("ring8", "zero", False)}


def k1_ops_per_pixel(iters, n_edges=4, stats=True):
    """f32 operations the unroll needs per full-res pixel of one plane on a
    window of E edges, each edge term computed once (an add, mul or compare
    is 1, a fused multiply-add 2); half-res work counts a quarter. Per scale
    (``ops.pixel_unroll.edge_ops``): Q·x = 18 + 5·E, the re-threshold
    18 + 10·E, GLR 19 + 2·E, A·x = Q + GLR + 3 (cross-4: 38, 58, 27, 68;
    the stencil 9, the GTV edge term 3 and the re-threshold's 8 per edge,
    the scatter 2 per edge, GLR's FMA 2 per edge). A·x at a full-res pixel:
    A·x + 2 (x + t₀ + Up t₁) + (A·x + 4) / 4, the box down 4 a half-res
    pixel; rhs_a: Q + 3 + (4 + Q + 1) / 4; rhs_b: R + 3 + (4 + R + 1) / 4;
    CG updates: step 1 3, step 2 3, step 3 5 (β₂ momentum). Cross-4 at cg3:
    403.5; diamond-12 763.5; ring-8 583.5. Without stats tables (``stats``
    False: JAX's kernel skips the stencil and its transpose) Q 5·E, the
    re-threshold 10·E, GLR 1 + 2·E: cross-4 at cg3 223.5."""
    from irdu_tpu_torch.ops.pixel_unroll import edge_ops

    ops = edge_ops(n_edges, stats, stats)
    q, re_, ax = ops["q"], ops["rethresh"], ops["matvec"]
    a_x = ax + 2 + (ax + 4) / 4
    total = q + 3 + (4 + q + 1) / 4 + a_x + 3
    if iters >= 2:
        total += re_ + 3 + (4 + re_ + 1) / 4 + a_x + 3
    if iters >= 3:
        total += a_x + 5
    return total


def k2_ops_per_pixel_graph(f, n_edges=4):
    """f32 operations per pixel and graph, each edge's dot product computed
    once: |c|² 2F, t = c·m/|c| 2F, the dots with the half of the window's
    neighbours that come after the pixel (the others are theirs) E/2·2F; then
    1/|c|, the E similarities' scaling and the softmax over E edges, about
    5E (cross-4: 8F + 20; diamond-12: 16F + 60)."""
    return 4 * f + n_edges * f + 5 * n_edges


def piecewise_smooth(h, w, seed):
    """A clean test image: a smooth colour ramp with 12 flat-shaded and
    gradient-shaded rectangles and disks on top, in [0, 1]."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32) / max(h, w)
    img = rs.rand(3) * 0.5 + rs.randn(3) * 0.3 * yy[..., None] + rs.randn(3) * 0.3 * xx[..., None]
    for _ in range(12):
        cy, cx, r = rs.rand() * h, rs.rand() * w, (0.05 + 0.25 * rs.rand()) * min(h, w)
        yi, xi = np.mgrid[0:h, 0:w]
        mask = ((yi - cy) ** 2 + (xi - cx) ** 2 < r * r) if rs.rand() < 0.5 else (
            (abs(yi - cy) < r) & (abs(xi - cx) < r * (0.5 + rs.rand())))
        shade = rs.rand(3) + rs.randn(3) * 0.4 * yy[..., None]
        img = np.where(mask[..., None], shade, img)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def cuda_ms(fn, reps, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def times(fn, reps, repeats=1):
    """A kernel row's times: ``ms`` by CUDA events (with ``repeats`` > 1 the
    median of that many runs, kept as ``ms_repeats``) and ``device_ms``, the
    kernel's own time from torch.profiler over the same repetitions
    (``kernels/timing.py``; events also time the wrapper's host work)."""
    from irdu_tpu_torch.kernels.timing import device_ms

    runs = [cuda_ms(fn, reps) for _ in range(repeats)]
    out = dict(ms=float(np.median(runs)), device_ms=device_ms(fn, reps))
    if repeats > 1:
        out["ms_repeats"] = [round(t, 5) for t in runs]
    return out


def device_ms_sessions():
    """How the run's ``device_ms`` times were taken (``kernels/timing.py``):
    its profiler sessions, the void ones (run again: a device event with no
    launch, a timed call short of device events, or no device time), the
    sessions whose trace lacks device events of their first calls, the
    times taken by CUDA events after a sleep instead, the range of the
    trace's launch-to-device lead (negative when it puts device time before
    the launch), and the largest relative gap between the sum by launch and
    the sum by the trace's clock. Every session's record goes to
    ``chiprun_out/device_ms_sessions.json``."""
    timing = sys.modules.get("irdu_tpu_torch.kernels.timing")
    sessions = timing.SESSIONS if timing else []
    with open(os.path.join(OUT_DIR, "device_ms_sessions.json"), "w") as fh:
        json.dump(sessions, fh)
    profiled = [r for r in sessions if "by_clock" in r]
    leads = [r["lead_us"] for r in profiled if r["lead_us"] is not None]
    both = [r for r in profiled if r["by_launch"] and r["by_clock"]]
    return {"device_ms": dict(
        sessions=len(profiled),
        void=sum(not (r["complete"] and r["by_launch"]) for r in profiled),
        short_start=sum(min(r["per_call"], default=0) < max(r["per_call"], default=0)
                        for r in profiled),
        events_after_sleep=sum("events_after_sleep_ms" in r for r in sessions),
        lead_us=[min(leads), max(leads)] if leads else None,
        max_gap=max((abs(r["by_clock"] / r["by_launch"] - 1) for r in both), default=None))}


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def within(a, b, atol, rtol):
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


class Smoke:
    def __init__(self):
        self.phases = {}
        self.failed = []
        self.path_counts = {}  # path → launches per kernel in that path's run
        self.pixel_model = None
        self.lines = {}
        self.model = None

    def run(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            result = fn(*args)
        except Exception:  # report the phase and go on, the run fails at the end
            traceback.print_exc()
            self.failed.append(name)
            result = None
        self.phases[name] = round(time.perf_counter() - t0, 3)
        status = "FAILED" if name in self.failed else "ok"
        print(f"phase {name}: {status} in {self.phases[name]} s", flush=True)
        return result



def require(cond, what):
    if not cond:
        raise AssertionError(what)


def k1_bar(ker, ref):
    """K1 in bf16: 4e-3 plus one bf16 ulp of the value. Kernel and plain
    version compute the same f32 values and round them to bf16 at different
    points, and the solver planes exceed 1, where that ulp is above 4e-3."""
    return within(ker, ref, 4e-3, 2.0 ** -7)


ULP_SHARE = 1e-2  # K3, K4 in bf16: the share of outputs allowed beyond one ulp
RMS_FACTOR = 1.1  # K3, K4 in bf16: RMS error against the f32 function, kernel vs plain


def block_bar(ker, ref, exact):
    """K3 and K4 in bf16: (ok, share beyond one ulp, the plain version's own
    error, the kernel's RMS error over the plain version's, both against the
    f32 function). Kernel and plain version round y0, y3 and the output to
    bf16 at the same points, but they sum in f32 in other orders, so a value
    next to a rounding boundary may round the other way; through the project
    (and the stacked blocks) one such flip moves an output by more than its
    own ulp where the terms are large and the output small. So:
    - at most ULP_SHARE of the outputs beyond one ulp (4e-3 + 2^-7·|ref|);
    - every output within one ulp plus the plain version's own rounding
      error, the largest |ref - exact| of the call, where exact is the same
      function in f32 on the same inputs without the bf16 roundings;
    - the kernel no less accurate than the plain version: its RMS error
      against exact at most RMS_FACTOR times the plain version's."""
    a, r, e = ker.float(), ref.float(), exact.float()
    d = (a - r).abs()
    ulp = 4e-3 + 2.0 ** -7 * r.abs()
    own = float((r - e).abs().max())
    share = float((d > ulp).float().mean())
    rms = float((a - e).square().mean().sqrt()) / max(float((r - e).square().mean().sqrt()), 1e-12)
    ok = share <= ULP_SHARE and bool((d <= ulp + own).all()) and rms <= RMS_FACTOR
    return ok, share, own, rms


def unrounded(plain, args, kw):
    """The plain version in f32 on the same (bf16) inputs: no bf16 rounding."""
    return plain(*(t.float() for t in args),
                 **{k: v.float() if hasattr(v, "float") else v for k, v in kw.items()})


def block_ops_per_pixel(c, hidden2):
    """Operations one block needs per pixel: (tensor-core, CUDA-core). The
    two 1x1 products are 2·C·2H + 2·H·C = 3·C·2H on the tensor cores; on the
    CUDA cores the 9 depthwise taps 18 per hidden channel, the gate
    σ(m)·m·u about 6 per m/u pair (exp, add, divide, 2 mul), so 21·2H, and
    the norm (sum, centred square-sum, scale, multiply: 8 per channel) with
    the skip, 8·C."""
    return 3 * c * hidden2, 21 * hidden2 + 8 * c


def k2_bar(ker, ref):
    return within(ker, ref, 4e-3, 0.0)


@functools.lru_cache(maxsize=1)
def request_images():
    """The flagship requests' (clean, noisy) images, made once."""
    return tuple(request_image(k) for k in range(len(REQUESTS)))


def request_image(k):
    """REQUESTS[k]'s (clean, noisy) image."""
    clean = piecewise_smooth(*REQUESTS[k], seed=k)
    noise = np.random.RandomState(2204).normal(0, 25 / 255.0, clean.shape)
    return clean, (clean + noise).astype(np.float32)


def psnr(clean, out):
    from irdu_tpu_torch.eval.metrics import img_as_ubyte, psnr_255

    return round(psnr_255(clean * 255, img_as_ubyte(np.clip(out, 0, 1))), 3)


def phase_build(smoke):
    """Build the library; ptxas's report of K1's (every window's instances),
    K3's dw_mxu kernel's, K5's (which K6a and K6b launch too), K7's and K9's
    kernels (registers, stack, spills) goes to ``lines["ptxas"]``, with every
    ptxas warning of the build and each source's compile seconds (``units``).
    Fails if the library was built here and an instance of the dw_mxu
    kernel, K7 or K9 spills or none is reported (K1's diamond-12 instances
    spill at their 128-register cap: reported, not gated)."""
    from irdu_tpu_torch.kernels.build import build, ptxas_report

    path, log, seconds = build()
    with open(os.path.join(OUT_DIR, "nvcc_build.log"), "w") as fh:
        fh.write(log)
    smoke.lines["ptxas"] = dict(
        {name: ptxas_report(log, kernel) for name, kernel in
         (("gg_unroll_chw", "gg_unroll_kernel"), ("fused_block_stack_dw_mxu", "dw_mxu_kernel"),
          ("gg_fused_step_chw", "step_kernel"),
          ("gg_pixel_unroll_chw", "pixel_unroll_kernel"),
          ("fused_system_matvec", "system_matvec_kernel"))},
        warnings=sorted({ln.strip() for ln in log.splitlines() if "warning" in ln}),
        units={m.group(1): float(m.group(2))
               for m in re.finditer(r"^build: (\S+) ([\d.]+) s$", log, re.M)},
        built=bool(log))
    if log:  # built here: every dw_mxu, K7 and K9 instance reported, none spilling
        for name in ("fused_block_stack_dw_mxu", "gg_pixel_unroll_chw", "fused_system_matvec"):
            entries = smoke.lines["ptxas"][name]
            require(entries and all(e.get("spill_stores") == 0 and e.get("spill_loads") == 0
                                    for e in entries), f"ptxas: {name} spills: {entries}")
    print(f"build: {seconds:.2f} s (one nvcc per source and a link, sm_90a) -> "
          f"{os.path.relpath(path, REPO)}", flush=True)
    return seconds


def wrappers():
    """The kernel wrappers, by name."""
    from irdu_tpu_torch.ops.block_stack import fused_block_stack
    from irdu_tpu_torch.ops.edge_weights import edge_weights_chw
    from irdu_tpu_torch.ops.fused_step import gg_fused_step_chw, gg_matvec_chw, gtv_rethresh_chw
    from irdu_tpu_torch.ops.gated_block import fused_gated_block
    from irdu_tpu_torch.ops.pixel_nhwc import pixel_segment_nhwc
    from irdu_tpu_torch.ops.pixel_unroll import gg_pixel_unroll_chw
    from irdu_tpu_torch.ops.solver_unroll import gg_unroll_chw
    from irdu_tpu_torch.ops.system_matvec import fused_system_matvec

    return dict(zip(KERNEL_NAMES, (fused_block_stack, fused_gated_block, gg_unroll_chw,
                                   edge_weights_chw, gg_fused_step_chw, gg_matvec_chw,
                                   gtv_rethresh_chw, gg_pixel_unroll_chw, pixel_segment_nhwc,
                                   fused_system_matvec)))


def serve(model, requests):
    """Serve each (clean, noisy, (h, w)) once with every count set to 0 just
    before and read just after: one row per request, and the counts."""
    from irdu_tpu_torch.predict import denoise

    kern = wrappers()
    for k in kern.values():
        k.launches = 0
    rows = []
    for clean, noisy, (h, w) in requests:
        before = {n: k.launches for n, k in kern.items()}
        t0 = time.perf_counter()
        out = denoise(model, noisy)  # ends in a device-to-host copy
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        rows.append(dict(
            shape=[h, w], ms=round(ms, 3),
            psnr_noisy=psnr(clean, noisy), psnr_denoised=psnr(clean, out),
            launches={n: k.launches - before[n] for n, k in kern.items()},
            finite=bool(np.isfinite(out).all())))
    return rows, {n: k.launches for n, k in kern.items()}


def check_row(r, want):
    """A served request: its launches are ``want``, its PSNR rose, every
    kernel call agreed with its plain version."""
    require(r["launches"] == want, f"request {r['shape']}: launches {r['launches']}, "
            f"want {want}")
    require(r["finite"] and r["psnr_denoised"] > r["psnr_noisy"],
            f"request {r['shape']}: PSNR {r['psnr_noisy']} -> {r['psnr_denoised']}")
    require(r["calls_ok"], f"request {r['shape']}: a kernel call disagrees with its "
            f"plain version, or the calls are not those launched (max|d| "
            f"{r['max_abs_err']})")


def phase_serving(smoke):
    from irdu_tpu_torch.predict import denoise, load_model

    model = smoke.model = load_model(device=DEVICE)  # bf16 params and activations on the card
    images = request_images()
    for _, noisy in images:  # warm-up: cuDNN plans, allocator
        denoise(model, noisy)
    sync()
    from irdu_tpu_torch.ops.block_stack import fused_block_stack

    fused_block_stack.dw_mxu_launches = 0  # the dw_mxu kernel, off the served path
    rows, smoke.path_counts["serving"] = serve(
        model, [(c, n, hw) for (c, n), hw in zip(images, REQUESTS)])
    smoke.path_counts["serving"]["fused_block_stack_dw_mxu"] = fused_block_stack.dw_mxu_launches
    require(fused_block_stack.dw_mxu_launches == 0, "serving launched the dw_mxu kernel")
    for row, (_, noisy) in zip(rows, images):  # after the counts: these launches do not count
        row.update(checked_request(model, noisy, PER_REQUEST[tuple(row["shape"])]))
    smoke.lines["serving"] = {"serving": rows, "weights": "flagship_cont100k_35000.npz",
                              "dtype": str(next(model.parameters()).dtype)[6:],
                              "blocks_512": blocks_ab(model, images[0][1])}
    for r in rows:
        check_row(r, PER_REQUEST[tuple(r["shape"])])


def busy_in_window(intervals, t0, t1):
    """The length of the union of (start, end) intervals inside [t0, t1]."""
    busy, end = 0.0, t0
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, t1)  # the part not yet counted, inside the window
        if b > a:
            busy += b - a
            end = b
    return busy


def profile_requests(model, noisy, n=PROFILE_REQUESTS, top=10):
    """torch.profiler (CPU and CUDA activity) over n steady requests after one
    untimed request and one profiled but discarded (the profiler's own
    first-use set-up), each under a "request" annotation: the ``top`` device
    kernels by total time (calls, total ms, mean µs), the window from the
    first request's start to the last one's end, the device's busy time in
    it (the union of its kernel, memcpy and memset intervals) and its idle
    share. Raises if the trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from irdu_tpu_torch.kernels.timing import DEVICE_CATS, trace_spans
    from irdu_tpu_torch.predict import denoise

    denoise(model, noisy)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        denoise(model, noisy)
        sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            with record_function("request"):
                denoise(model, noisy)  # ends in a device-to-host copy
        sync()
    spans = trace_spans(prof)
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    requests = [e for e in spans if e.get("name") == "request"
                and e.get("cat") in ("user_annotation", "cpu_op")]
    require(device and requests, "the profiler recorded no device activity or no request")
    t0 = min(e["ts"] for e in requests)
    t1 = max(e["ts"] + e["dur"] for e in requests)
    busy = busy_in_window([(e["ts"], e["ts"] + e["dur"]) for e in device], t0, t1)
    kernels = {}
    for e in device:
        if e.get("cat") == "kernel":
            k = kernels.setdefault(e["name"][:120], [0, 0.0])
            k[0] += 1
            k[1] += e["dur"]
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    return dict(requests=n, window_ms=round((t1 - t0) / 1e3, 3),
                device_busy_ms=round(busy / 1e3, 3), idle_share=round(1 - busy / (t1 - t0), 4),
                kernel_ms=round(sum(v[1] for v in kernels.values()) / 1e3, 3),
                top=[dict(name=name, calls=c, total_ms=round(d / 1e3, 3),
                          mean_us=round(d / c, 2)) for name, (c, d) in ranked])


def phase_profile(smoke):
    """The profile line: ``profile_requests`` on the 512x512 flagship request."""
    from irdu_tpu_torch.predict import load_model

    model = smoke.model or load_model(device=DEVICE)
    out = profile_requests(model, request_images()[0][1])
    smoke.lines["profile"] = {"profile": out, "shape": list(REQUESTS[0]), "dtype": "bfloat16"}


def phase_small(smoke):
    """lite and micro (default snapshots, bf16) on the 512x512 request."""
    import torch

    from irdu_tpu_torch.predict import DEFAULT_WEIGHTS, denoise, load_model

    clean, noisy = request_images()[0]
    out = []
    for name, want in SMALL_MODELS.items():
        model = load_model(device=DEVICE, name=name)
        denoise(model, noisy)  # warm-up
        sync()
        (row,), _ = serve(model, [(clean, noisy, REQUESTS[0])])
        row.update(model=name, weights=os.path.basename(DEFAULT_WEIGHTS[name]),
                   **checked_request(model, noisy, want))
        out.append(row)
        del model
        torch.cuda.empty_cache()
    smoke.lines["small_models"] = {"small_models": out, "dtype": "bfloat16"}
    for r in out:
        check_row(r, SMALL_MODELS[r["model"]])


def pixel_images():
    """The pixel requests' (clean, noisy) images: the flagship requests of
    the same sizes."""
    images = dict(zip(REQUESTS, request_images()))
    return [images[hw] for hw in PIXEL_REQUESTS]


def phase_pixel(smoke):
    """The pixel model (its snapshot, bf16) serves PIXEL_REQUESTS on the NHWC
    route (1 K2 and 6 K8 each), then the 512x512 request on the CHW route
    (1 K2 and 1 K7), counts zeroed just before each run and read just after;
    each request once more with every kernel call held against its plain
    version; the two routes timed at 512x512 in turns."""
    from irdu_tpu_torch.predict import denoise, load_model

    model = smoke.pixel_model = load_model(device=DEVICE, name="pixel")
    mix = model.mixtureGLR_block03
    images = pixel_images()
    for _, noisy in images:  # warm-up: cuDNN plans, allocator
        denoise(model, noisy)
    sync()
    rows, counts = serve(model, [(c, n, hw) for (c, n), hw in zip(images, PIXEL_REQUESTS)])
    smoke.path_counts["pixel"] = counts
    for row, (_, noisy) in zip(rows, images):
        row.update(route="nhwc", **checked_request(model, noisy, PIXEL_NHWC, pixel_sites()))
    clean, noisy = images[0]
    by_size = dict(zip(REQUESTS, request_images()))
    band_images = [by_size[hw] for hw in PIXEL_BAND_REQUESTS]
    try:
        mix.use_nhwc_unroll = False
        for _, n in [images[0]] + band_images:  # warm-up of the CHW route, K7 and K5
            denoise(model, n)
        sync()
        (chw_row,), counts = serve(model, [(clean, noisy, PIXEL_REQUESTS[0])])
        smoke.path_counts["pixel_chw"] = counts
        chw_row.update(route="chw", **checked_request(model, noisy, PIXEL_CHW, pixel_sites()))
        band_rows, counts = serve(model, [(c, n, hw) for (c, n), hw in
                                          zip(band_images, PIXEL_BAND_REQUESTS)])
        smoke.path_counts["pixel_chw_band"] = counts
        for row, (_, n) in zip(band_rows, band_images):
            row.update(route="chw", **checked_request(model, n, PIXEL_CHW_BAND, pixel_sites()))
        routes = {f"routes_{hw[0]}": route_times(mix, model, by_size[hw][1])
                  for hw in (PIXEL_REQUESTS[0], *PIXEL_BAND_REQUESTS)}
    finally:
        mix.use_nhwc_unroll = True
    smoke.lines["pixel"] = {
        "pixel": rows + [chw_row] + band_rows, "weights": "pixel_synthetic_2050.npz",
        "dtype": "bfloat16", **routes}
    for r in rows:
        check_row(r, PIXEL_NHWC)
    check_row(chw_row, PIXEL_CHW)
    for r in band_rows:
        check_row(r, PIXEL_CHW_BAND)


def route_times(mix, model, noisy, rounds=1):
    """One pixel request on the NHWC and the CHW route, in turns: nhwc, chw,
    chw, nhwc per round (both routes warmed up before)."""
    from irdu_tpu_torch.predict import denoise

    times = {"nhwc": [], "chw": []}
    for _ in range(rounds):
        for route in ("nhwc", "chw", "chw", "nhwc"):
            mix.use_nhwc_unroll = route == "nhwc"
            sync()
            t0 = time.perf_counter()
            denoise(model, noisy)
            sync()
            times[route].append(round((time.perf_counter() - t0) * 1e3, 3))
    return {"shape": list(noisy.shape[:2]), "nhwc_ms": times["nhwc"], "chw_ms": times["chw"],
            "median_nhwc_ms": float(np.median(times["nhwc"])),
            "median_chw_ms": float(np.median(times["chw"])),
            "order": "nhwc, chw, chw, nhwc, x%d" % rounds}


def ablation_model(name, dtype):
    """The config's model built through the registry at its widths (its
    solver's window, ``deltas``, is switched by ``on_window``): weights
    drawn from torch's default generator seeded with the config's index, then
    the solvers' μ and ρ set to U(0.2, 0.6) and γ to U(0.02, 0.06) (their
    logs) from a generator seeded the same, so that every solver term shows
    (the inits, 1e-6 to 1e-3, leave the matvecs next to the identity)."""
    import torch

    from irdu_tpu_torch.models.registry import create_model

    kw = dict(ABLATION_MODELS[name])
    seed = sorted(ABLATION_MODELS).index(name)
    torch.manual_seed(seed)
    model = create_model(kw.pop("type"), **kw)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            leaf = pname.rsplit(".", 1)[-1]
            if leaf in ("muys00", "muys01", "ro00", "ro01"):
                p.copy_(torch.log(0.2 + 0.4 * torch.rand(p.shape, generator=gen)))
            elif leaf in ("gamma00", "gamma01"):
                p.copy_(torch.log(0.02 + 0.04 * torch.rand(p.shape, generator=gen)))
    return model.to(device=DEVICE, dtype=dtype).eval().requires_grad_(False)


def phase_ablation(smoke):
    """Each ablation model in bf16 serves the 512x512 request, counts zeroed
    just before and read just after; once more with every kernel call held
    against its plain version; then in f32, kernels against plain."""
    import torch

    from irdu_tpu_torch.models.registry import set_kernels
    from irdu_tpu_torch.predict import denoise

    clean, noisy = request_images()[0]
    rows, f32_rows = [], []
    x = torch.from_numpy(noisy[None]).to(DEVICE)
    for name in ABLATION_MODELS:
        model = ablation_model(name, torch.bfloat16)
        denoise(model, noisy)  # warm-up
        sync()
        (row,), smoke.path_counts[name] = serve(model, [(clean, noisy, REQUESTS[0])])
        row.update(config=name, **checked_request(model, noisy, ABLATION_LAUNCHES[name],
                                                  ablation_sites()))
        rows.append(row)
        print(f"ablation {name}: {row['ms']} ms, launches "
              f"{ {k: v for k, v in row['launches'].items() if v} }", flush=True)
        del model
        model = ablation_model(name, torch.float32)
        with torch.inference_mode():
            set_kernels(model, True)
            ker = model(x)
            set_kernels(model, False)
            ref = model(x)
        sync()
        f32_rows.append(dict(config=name, shape=list(x.shape), max_abs_err=max_abs(ker, ref),
                             max_ref=float(ref.abs().max()), change=max_abs(ref, x),
                             finite=bool(torch.isfinite(ker).all())))
        del model, ker, ref
        torch.cuda.empty_cache()
    smoke.lines["ablation"] = {"ablation": rows, "f32": f32_rows, "dtype": "bfloat16",
                               "weights": "random, seeded (ablation_model)",
                               "f32_bar": ABLATION_F32_BAR}
    for r in rows:
        want = ABLATION_LAUNCHES[r["config"]]
        require(r["launches"] == want, f"{r['config']}: launches {r['launches']}, want {want}")
        require(r["finite"], f"{r['config']}: output not finite")
        for route, res in (("served", r), ("chw", r.get("chw", r))):
            require(res["calls_ok"], f"{r['config']} ({route}): a kernel call disagrees with "
                    f"its plain version, or the calls are not those launched "
                    f"(max|d| {res['max_abs_err']})")
    for r in f32_rows:
        require(r["finite"] and r["max_abs_err"] <= ABLATION_F32_BAR * max(1.0, r["max_ref"]),
                f"{r['config']}: f32 kernels vs plain max|d| {r['max_abs_err']} "
                f"(max|ref| {r['max_ref']})")


def blocks_ab(model, noisy, rounds=3):
    """The 512x512 request with the encoder/decoder blocks on K3/K4 and on
    the plain PyTorch route (cuDNN convolutions), in turns: plain, kernels,
    kernels, plain per round, after one untimed request on each route (cuDNN
    picks its algorithms on the first). The solver stays on K1/K2."""
    from irdu_tpu_torch.predict import denoise

    times = {"kernels": [], "plain": []}
    try:
        for route in ("plain", "kernels"):
            model.use_kernels = route == "kernels"
            denoise(model, noisy)
        for _ in range(rounds):
            for route in ("plain", "kernels", "kernels", "plain"):
                model.use_kernels = route == "kernels"
                sync()
                t0 = time.perf_counter()
                denoise(model, noisy)
                sync()
                times[route].append(round((time.perf_counter() - t0) * 1e3, 3))
    finally:
        model.use_kernels = True
    return {"blocks_kernels_ms": times["kernels"], "blocks_plain_ms": times["plain"],
            "median_kernels_ms": float(np.median(times["kernels"])),
            "median_plain_ms": float(np.median(times["plain"])),
            "order": "plain, kernels, kernels, plain, x%d" % rounds}


def flagship_sites():
    """Where models/flagship.py and solvers/gtv_glr.py look the kernels up:
    (module, name, plain version, bf16 bar; None: block_bar)."""
    from irdu_tpu_torch.models import flagship
    from irdu_tpu_torch.ops.block_stack import block_stack_plain
    from irdu_tpu_torch.ops.edge_weights import edge_weights_plain
    from irdu_tpu_torch.ops.fused_step import fused_step_plain
    from irdu_tpu_torch.ops.gated_block import gated_block_plain
    from irdu_tpu_torch.ops.solver_unroll import gg_unroll_plain
    from irdu_tpu_torch.solvers import gtv_glr

    return ((flagship, "fused_block_stack", block_stack_plain, None),
            (flagship, "fused_gated_block", gated_block_plain, None),
            (gtv_glr, "gg_unroll_chw", gg_unroll_plain, k1_bar),
            (gtv_glr, "edge_weights_chw", edge_weights_plain, k2_bar),
            (gtv_glr, "gg_fused_step_chw", fused_step_plain, k1_bar))


def pixel_sites():
    """Where solvers/pixel_gtv.py and ops/pixel_nhwc.py look the pixel
    model's kernels up."""
    from irdu_tpu_torch.ops import pixel_nhwc
    from irdu_tpu_torch.ops.edge_weights import edge_weights_plain
    from irdu_tpu_torch.ops.fused_step import fused_step_plain
    from irdu_tpu_torch.ops.pixel_unroll import pixel_unroll_plain
    from irdu_tpu_torch.solvers import pixel_gtv

    return ((pixel_gtv, "edge_weights_chw", edge_weights_plain, k2_bar),
            (pixel_gtv, "gg_pixel_unroll_chw", pixel_unroll_plain, k1_bar),
            (pixel_gtv, "gg_fused_step_chw", fused_step_plain, k1_bar),
            (pixel_nhwc, "pixel_segment_nhwc", pixel_nhwc.pixel_segment_plain, k1_bar))


def ablation_sites():
    """Where the ablation models look their kernels up: the flagship's sites
    (its blocks, which the feature heads share through run_blocks, and the
    two-scale solver) and solvers/ablation_solvers.py's."""
    from irdu_tpu_torch.ops.edge_weights import edge_weights_plain
    from irdu_tpu_torch.ops.fused_step import matvec_plain
    from irdu_tpu_torch.ops.system_matvec import system_matvec_plain
    from irdu_tpu_torch.solvers import ablation_solvers

    return flagship_sites() + ((ablation_solvers, "edge_weights_chw", edge_weights_plain, k2_bar),
                               (ablation_solvers, "fused_system_matvec", system_matvec_plain,
                                k1_bar),
                               (ablation_solvers, "gg_matvec_chw", matvec_plain, k1_bar))


@contextlib.contextmanager
def kernel_checks(sites):
    """While open, every kernel call through ``sites`` is held against its
    plain version on that call's own tensors (both outputs of a K5 call that
    emits its update, or of a K8 cg1 segment). Yields the record:
    {"log": {kernel: [(max|d|, ok), ...]}, "share", "rms"} (K3 and K4: the
    largest share beyond one ulp and RMS ratio of ``block_bar``)."""
    log = {name: [] for _, name, _, _ in sites}
    share = {n: 0.0 for n in ("fused_block_stack", "fused_gated_block") if n in log}
    rms = dict(share)

    def checked(name, kernel, plain, bar):
        def call(*args, **kw):
            out = kernel(*args, **kw)
            ref = plain(*args, **kw)
            if name in share:
                ok, frac, _, ratio = block_bar(out, ref, unrounded(plain, args, kw))
                share[name] = max(share[name], frac)
                rms[name] = max(rms[name], ratio)
                err = max_abs(out, ref)
            else:
                pairs = list(zip(out, ref)) if isinstance(out, tuple) else [(out, ref)]
                ok = all(bar(o, r) for o, r in pairs)
                err = max(max_abs(o, r) for o, r in pairs)
            log[name].append((err, ok))
            return out
        # a wrapper that counts its launches through its module's name for
        # itself (K8: pixel_unroll_nhwc calls it in the same module) counts
        # here while this one sits in its place; these calls are not counted
        call.launches = 0
        return call

    saved = [getattr(mod, name) for mod, name, _, _ in sites]
    for (mod, name, plain, bar), kernel in zip(sites, saved):
        setattr(mod, name, checked(name, kernel, plain, bar))
    try:
        yield {"log": log, "share": share, "rms": rms}
    finally:
        for (mod, name, _, _), kernel in zip(sites, saved):
            setattr(mod, name, kernel)


def checks_summary(rec, want):
    """A ``kernel_checks`` record: the max|d| of each kernel, and whether
    every call agreed and the calls per kernel are ``want``."""
    log = rec["log"]
    return dict(max_abs_err={n: max((e for e, _ in v), default=None) for n, v in log.items()},
                beyond_one_ulp_share=rec["share"], rms_vs_plain=rec["rms"],
                calls_checked=sum(len(v) for v in log.values()),
                calls_ok=all(len(v) == want[n] for n, v in log.items())
                and all(ok for v in log.values() for _, ok in v))


def checked_request(model, noisy, want, sites=None):
    """Serve one request with every kernel call held against its plain
    version (``kernel_checks``); the max|d| of each kernel, and whether
    every call agreed and the calls per kernel are ``want``.
    ``sites``: where the model looks its kernels up (default: the flagship's)."""
    from irdu_tpu_torch.predict import denoise

    with kernel_checks(sites or flagship_sites()) as rec:
        denoise(model, noisy)
    return checks_summary(rec, want)


def _filter_params(model, s):
    """The snapshot's filter parameters of scale s, in f32 on the card."""
    import torch

    from irdu_tpu_torch.ops.solver_unroll import unroll_scal

    lf = model.local_filters[s].local_filter
    exp = lambda p: torch.exp(p.float())  # noqa: E731
    m = torch.cat([lf.GTVmodule00.multiM, lf.GLRmodule00.multiM]).float()
    m1 = torch.cat([lf.GTVmodule01.multiM, lf.GLRmodule01.multiM]).float()
    tables = [mod.stats_table() for mod in (lf.GTVmodule00, lf.GLRmodule00,
                                           lf.GTVmodule01, lf.GLRmodule01)]
    scal = unroll_scal(lf.n_graphs, exp(lf.muys00), exp(lf.ro00), exp(lf.muys01),
                       exp(lf.ro01), exp(lf.gamma00), exp(lf.gamma01),
                       lf.alphaCGD.float(), lf.betaCGD.float())
    return lf.n_graphs, m, m1, tables, scal


def phase_kernels(smoke):
    import torch

    from irdu_tpu_torch.kernels.build import dtype_code, kernel_library
    from irdu_tpu_torch.ops.edge_weights import edge_weights_chw, edge_weights_plain
    from irdu_tpu_torch.ops.solver_unroll import gg_unroll_chw, gg_unroll_plain
    from irdu_tpu_torch.predict import load_model

    model = smoke.model or load_model(device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    k1_rows, k2_rows = [], []

    def agree(name, ker, ref):
        if ker.dtype == torch.float32:
            return within(ker, ref, 5e-4, 1e-3)
        return (k1_bar if name == "gg_unroll_chw" else k2_bar)(ker, ref)

    def bar_at(ref, dtype):  # the agreement bar at the output's largest value
        big = float(ref.float().abs().max())
        return 5e-4 + 1e-3 * big if dtype == torch.float32 else 4e-3 + 2.0 ** -7 * big

    for s in range(4):
        g, m0, m1, tables, scal = _filter_params(model, s)
        # at scales 1-2 the snapshot's μ, ρ, γ move the planes by < 0.05, so
        # there they are scaled ×20 to make every stencil term show; scales 0
        # and 3 move them by ~2 already
        scal = scal.clone()
        scal[:, :6] *= LOUD[s]
        params = f"snapshot, mu/rho/gamma x{LOUD[s]}"
        c = model.local_filters[s].local_filter.n_node_fts * g
        h = w = FRAME >> s
        for dtype in (torch.float32, torch.bfloat16):
            # unit-scale seeded inputs: features N(0, 1), solver planes U[0, 1)
            f00 = torch.randn(1, 2 * c, h, w, device=DEVICE, generator=gen).to(dtype)
            f01 = torch.randn(1, 2 * c, h // 2, w // 2, device=DEVICE, generator=gen).to(dtype)
            y = torch.rand(1, c, h, w, device=DEVICE, generator=gen).to(dtype)
            ws = []
            for feats, m, res in ((f00, m0, "full"), (f01, m1, "half")):
                ker = edge_weights_chw(feats, m, n_graphs=2 * g)
                ref = edge_weights_plain(feats, m, 2 * g)
                sync()
                k2_rows.append(dict(scale=s, res=res, shape=list(feats.shape),
                                    dtype=str(dtype)[6:], max_abs_err=max_abs(ker, ref),
                                    ok=agree("edge_weights_chw", ker, ref)))
                ws += [ref[:, :g].contiguous(), ref[:, g:].contiguous()]
            args = (y, ws[0], ws[1], ws[2], ws[3], *tables, scal)
            # f32 at every eval_cg_iters; bf16, the serving dtype, at 3
            for iters in ((1, 2, 3) if dtype == torch.float32 else (3,)):
                ker = gg_unroll_chw(*args, n_graphs=g, eval_cg_iters=iters)
                ref = gg_unroll_plain(*args, n_graphs=g, eval_cg_iters=iters)
                sync()
                # the f32 rows must also move y well beyond their bar; the
                # bf16 bar (one ulp of |x| ≈ 2-3) is near the change at scale 1
                change, bar = max_abs(ref, y), bar_at(ref, dtype)
                moved = dtype != torch.float32 or change >= CHANGE_FACTOR * bar
                k1_rows.append(dict(
                    scale=s, shape=list(y.shape), dtype=str(dtype)[6:],
                    params=f"{params}, cg{iters}", max_abs_err=max_abs(ker, ref),
                    max_ref=float(ref.float().abs().max()), change=change, bar=bar,
                    ok=agree("gg_unroll_chw", ker, ref) and moved))
            if dtype == torch.float32:
                continue
            # times in bf16, the serving dtype
            for row, feats, m in ((k2_rows[-2], f00, m0), (k2_rows[-1], f01, m1)):
                e = 2 * g * 4 * feats.shape[2] * feats.shape[3]
                nbytes = feats.numel() * 2 + m.numel() * 4 + e * 2
                ops = feats.shape[2] * feats.shape[3] * 2 * g * k2_ops_per_pixel_graph(c // g)
                row.update(
                    **times(lambda: edge_weights_chw(feats, m, n_graphs=2 * g), 20),
                    plain_ms=cuda_ms(lambda: edge_weights_plain(feats, m, 2 * g), 5),
                    **_bound(nbytes, ops))
            nbytes = sum(t.numel() * t.element_size() for t in args) + y.numel() * 2
            ops = y.numel() * k1_ops_per_pixel(3)
            k1_rows[-1].update(
                **times(lambda: gg_unroll_chw(*args, n_graphs=g), 10, repeats=3),
                ctas_per_sm=kernel_library().irdu_gg_unroll_ctas_per_sm(0, dtype_code(dtype)),
                plain_ms=cuda_ms(lambda: gg_unroll_plain(*args, n_graphs=g), 3),
                **_bound(nbytes, ops))
    k1_rows += k1_ragged_rows(model, gen, bar_at) + k1_option_rows(model, gen, bar_at)
    smoke.kernel_rows = {"gg_unroll_chw": k1_rows, "edge_weights_chw": k2_rows,
                         **block_rows(model, gen, bar_at), **step_rows(model, gen, bar_at),
                         "fused_block_stack_dw_mxu": dw_mxu_rows(model, gen, bar_at)}
    pixel = smoke.pixel_model or load_model(device=DEVICE, name="pixel")
    for more in (pixel_rows(pixel, gen, bar_at, smoke.lines), pixel_step_rows(pixel, gen, bar_at),
                 k9_rows(gen, bar_at), ragged_step_rows(gen, bar_at), boosting_k2_rows(gen)):
        for name, rows in more.items():
            smoke.kernel_rows.setdefault(name, []).extend(rows)
    smoke.lines["band_route"] = band_route(model)
    with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as fh:
        json.dump(smoke.kernel_rows, fh, indent=1)
    bad = [(k, r) for k, rows in smoke.kernel_rows.items() for r in rows if not r["ok"]]
    require(not bad, f"kernels disagree with their plain versions, or moved their "
            f"input by under {CHANGE_FACTOR}x the bar: {bad}")
    mismatched = layout_mismatches(model)
    require(not mismatched, f"planner and kernel shared memory differ: {mismatched}")
    require(smoke.lines["band_route"]["ok"], f"the band route disagrees with the K1 route: "
            f"{smoke.lines['band_route']}")


def layout_mismatches(model):
    """The planners' shared-memory counts against the kernels' own layouts
    (the library's ``irdu_block_stack_wgmma_smem``,
    ``irdu_block_stack_dw_mxu_smem``, ``irdu_edge_weights_smem``, ``irdu_fused_step_hopper_smem``,
    ``irdu_pixel_segment_smem``, ``irdu_pixel_unroll_smem`` and
    ``irdu_system_matvec_smem``): K3's wgmma kernel and its dw_mxu kernel
    at every served (C, H) they take, K2 at the plan of every call of the 512x512 flagship request
    and of the pixel model's diamond-12 call, bf16 and f32; K5 (and so
    K6a's and K6b's single-scale launches) at its tile and K8 at every tile
    plan it is built with, on every window, with and without GLR; K7 on every window
    and K9 at the tile of each type. Returns the (what, planner bytes,
    kernel bytes) that differ."""
    import torch

    from irdu_tpu_torch.kernels.build import kernel_library
    from irdu_tpu_torch.ops.block_stack import dw_mxu_smem_bytes, stack_route, stack_smem_bytes
    from irdu_tpu_torch.ops import fused_step as fs
    from irdu_tpu_torch.ops import pixel_nhwc as pn
    from irdu_tpu_torch.ops import pixel_unroll as pu
    from irdu_tpu_torch.ops import system_matvec as sm
    from irdu_tpu_torch.ops.edge_weights import plan_edge_tiles

    lib = kernel_library()
    out = []
    for c, hidden in {(48, 2 * 48)} | {(c, hd) for _, c, hd, *_ in K3_EXTRA}:
        if stack_route(torch.bfloat16, c, hidden) == "wgmma":
            got = lib.irdu_block_stack_wgmma_smem(c, hidden)
            out.append((f"K3 C={c} H={hidden}", stack_smem_bytes(c, hidden), got))
            out.append((f"K3 dw_mxu C={c} H={hidden}", dw_mxu_smem_bytes(c, hidden),
                        lib.irdu_block_stack_dw_mxu_smem(c, hidden)))
    calls = [(2 * lf.n_graphs, lf.n_node_fts, FRAME >> res, 1)
             for s, lf in enumerate(f.local_filter for f in model.local_filters)
             for res in (s, s + 1)] + [(48, 3, FRAME, 2)]
    for g, f, side, radius in calls:
        for esize in (2, 4):
            bh, tx, fc, smem = plan_edge_tiles(f, esize, radius)
            got = lib.irdu_edge_weights_smem(esize, fc, f, bh, tx, radius)
            out.append((f"K2 G={g} F={f} {side}² e{esize}", smem, got))
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        esize = 4 if code == 0 else 2
        for two, win in ((two, win) for two in (True, False) for win in range(3)):
            for glr in (False, True):
                got = lib.irdu_fused_step_hopper_smem(win, int(two), int(glr), code)
                out.append((f"K5 window={win} two={two} glr={glr} e{esize}",
                            fs.k5_smem_bytes(win, two, glr, esize), got))
        for win in range(3):
            for plan in range(len(pn.K8_PLANS) if code else 1):
                for glr in (False, True):
                    got = lib.irdu_pixel_segment_smem(win, int(glr), plan, code)
                    out.append((f"K8 window={win} glr={glr} plan={plan} e{esize}",
                                pn.k8_smem_bytes(glr, plan, esize, win), got))
            out.append((f"K7 window={win} e{esize}", pu.k7_smem_bytes(dtype, win),
                        lib.irdu_pixel_unroll_smem(win, code)))
        out.append((f"K9 e{esize}", sm.k9_smem_bytes(dtype), lib.irdu_system_matvec_smem(code)))
    return [m for m in out if m[1] != m[2]]


def k1_ragged_rows(model, gen, bar_at):
    """K1 against its plain version on the planes of K1_RAGGED (ragged
    32x64 tiles: a plane smaller than one tile, tile rows cut short), f32
    and bf16 at cg3, with the snapshot's filter parameters of that scale,
    seeded inputs; untimed."""
    import torch

    from irdu_tpu_torch.ops.edge_weights import edge_weights_plain
    from irdu_tpu_torch.ops.solver_unroll import gg_unroll_chw, gg_unroll_plain

    rows = []
    for s, (h, w) in K1_RAGGED:
        g, m0, m1, tables, scal = _filter_params(model, s)
        scal = scal.clone()
        scal[:, :6] *= LOUD[s]
        c = model.local_filters[s].local_filter.n_node_fts * g
        for dtype in (torch.float32, torch.bfloat16):
            y = torch.rand(1, c, h, w, device=DEVICE, generator=gen).to(dtype)
            ws = []
            for m, res in ((m0, 1), (m1, 2)):
                feats = torch.randn(1, 2 * c, h // res, w // res, device=DEVICE,
                                    generator=gen).to(dtype)
                wt = edge_weights_plain(feats, m, 2 * g)
                ws += [wt[:, :g].contiguous(), wt[:, g:].contiguous()]
            args = (y, *ws, *tables, scal)
            ker = gg_unroll_chw(*args, n_graphs=g)
            ref = gg_unroll_plain(*args, n_graphs=g)
            sync()
            change, bar = max_abs(ref, y), bar_at(ref, dtype)
            ok = (within(ker, ref, 5e-4, 1e-3) and change >= CHANGE_FACTOR * bar
                  if dtype == torch.float32 else k1_bar(ker, ref))
            rows.append(dict(scale=s, shape=list(y.shape), dtype=str(dtype)[6:], ragged=True,
                             params=f"snapshot, mu/rho/gamma x{LOUD[s]}, cg3",
                             max_abs_err=max_abs(ker, ref), max_ref=float(ref.float().abs().max()),
                             change=change, bar=bar, ok=ok))
    return rows


def k1_option_rows(model, gen, bar_at):
    """K1 on each of K1_OPTIONS (diamond-12 and ring-8 with the "edge" pad,
    cross-4 with the reflect pad and with no stats tables, diamond-12 with
    the reflect pad, ring-8 with the zero pad: every K1 instance) against its plain
    version at the 512x512 request's four scale shapes, with the snapshot's
    filter parameters of each scale (μ, ρ, γ scaled by LOUD) and seeded
    inputs (features N(0, 1) through K2's plain version on the window,
    planes U[0, 1)): bf16 within K1's bar, timed (``times``, the plain
    version once), with its bound, under the basis "512x512 request's
    shapes, <option>" (the windows phase times the 512x512 request's own
    K1 calls on a window under "512x512 request, <window>"); one f32 row at
    scale 0 within 5e-4 + 1e-3·|ref| that moves y by CHANGE_FACTOR times
    that bar."""
    import torch

    from irdu_tpu_torch.kernels.build import dtype_code, kernel_library
    from irdu_tpu_torch.ops.edge_weights import edge_weights_plain
    from irdu_tpu_torch.ops.solver_unroll import gg_unroll_chw, gg_unroll_plain
    from irdu_tpu_torch.ops.windows import WINDOWS, window_code

    rows = []
    for option, (window, pad, no_stats) in K1_OPTIONS.items():
        deltas = WINDOWS[window]
        for s in range(4):
            g, m0, m1, tables, scal = _filter_params(model, s)
            scal = scal.clone()
            scal[:, :6] *= LOUD[s]
            tables = [None] * 4 if no_stats else tables
            c = model.local_filters[s].local_filter.n_node_fts * g
            h = w = FRAME >> s
            for dtype in (torch.float32, torch.bfloat16) if s == 0 else (torch.bfloat16,):
                y = torch.rand(1, c, h, w, device=DEVICE, generator=gen).to(dtype)
                ws = []
                for m, res in ((m0, 1), (m1, 2)):
                    feats = torch.randn(1, 2 * c, h // res, w // res, device=DEVICE,
                                        generator=gen).to(dtype)
                    wt = edge_weights_plain(feats, m, 2 * g, deltas)
                    ws += [wt[:, :g].contiguous(), wt[:, g:].contiguous()]
                args = (y, *ws, *tables, scal)
                kw = dict(n_graphs=g, stats_mode=pad, deltas=deltas)
                ker = gg_unroll_chw(*args, **kw)
                ref = gg_unroll_plain(*args, **kw)
                sync()
                change, bar = max_abs(ref, y), bar_at(ref, dtype)
                ok = (within(ker, ref, 5e-4, 1e-3) and change >= CHANGE_FACTOR * bar
                      if dtype == torch.float32 else k1_bar(ker, ref))
                row = dict(scale=s, shape=list(y.shape), dtype=str(dtype)[6:], window=window,
                           stats_mode=pad, no_stats=no_stats,
                           params=f"snapshot, mu/rho/gamma x{LOUD[s]}, cg3",
                           max_abs_err=max_abs(ker, ref), max_ref=float(ref.float().abs().max()),
                           change=change, bar=bar, ok=ok)
                if dtype == torch.bfloat16:
                    nbytes = sum(t.numel() * t.element_size() for t in args
                                 if t is not None) + y.numel() * 2
                    row.update(
                        basis=f"{FRAME}x{FRAME} request's shapes, {option}", calls=1,
                        **times(lambda: gg_unroll_chw(*args, **kw), 10),
                        ctas_per_sm=kernel_library().irdu_gg_unroll_ctas_per_sm(
                            window_code(deltas), dtype_code(dtype)),
                        plain_ms=cuda_ms(lambda: gg_unroll_plain(*args, **kw), 1, 0),
                        **_bound(nbytes, y.numel() * k1_ops_per_pixel(
                            3, len(deltas), stats=not no_stats)))
                rows.append(row)
                del ker, ref
    return rows


def dw_mxu_rows(model, gen, bar_at):
    """K3 with ``dw_mxu`` (``block_stack_dw_mxu.cu`` in bf16, ``block_stack.cu``
    in f32) at the 512x512 request's K3 shape, the snapshot's four scale-0
    encoder blocks (C = 48, H = 96), seeded N(0, 1) input, against
    ``block_stack_dw_mxu_plain``: bf16 within ``block_bar``, timed with its
    bound (9·2·C·2H + 2·H·C tensor-core and 6·H + 8·C CUDA-core operations a
    pixel and block), K3_PER_REQUEST calls a request as K3's; f32 within
    5e-4 + 1e-3·|ref|, moving its input by CHANGE_FACTOR times that bar."""
    import torch

    from irdu_tpu_torch.ops.block_stack import (block_stack_dw_mxu_plain, fused_block_stack,
                                                pack_block_params)

    rows = []
    blocks = model.encoder_scales[0][:4]
    c = model.dims[0]
    for dtype in (torch.float32, torch.bfloat16):
        params = [{k: v.to(dtype) for k, v in blk.gated_params().items()} for blk in blocks]
        x = torch.randn(1, c, FRAME, FRAME, device=DEVICE, generator=gen).to(dtype)
        args = (x, *pack_block_params(params, dtype))
        ker = fused_block_stack(*args, dw_mxu=True)
        ref = block_stack_dw_mxu_plain(*args)
        sync()
        change, bar = max_abs(ref, x), bar_at(ref, dtype)
        hidden2 = params[0]["w1"].shape[1]
        row = dict(blocks=len(blocks), shape=list(x.shape), hidden=hidden2 // 2,
                   dtype=str(dtype)[6:], params="snapshot, encoder scale 0, dw_mxu",
                   kernel="block_stack_dw_mxu.cu" if dtype == torch.bfloat16 else "block_stack.cu",
                   max_abs_err=max_abs(ker, ref), max_ref=float(ref.float().abs().max()),
                   change=change, bar=bar)
        if dtype == torch.float32:
            row["ok"] = within(ker, ref, 5e-4, 1e-3) and change >= CHANGE_FACTOR * bar
        else:
            (row["ok"], row["beyond_one_ulp_share"], row["plain_own_err"],
             row["rms_vs_plain"]) = block_bar(ker, ref, unrounded(block_stack_dw_mxu_plain,
                                                                  args, {}))
            npx = x.shape[2] * x.shape[3] * len(blocks)
            nbytes = 2 * x.numel() * x.element_size() + sum(
                t.numel() * t.element_size() for t in args[1:])
            row.update(calls=K3_PER_REQUEST,
                       **times(lambda: fused_block_stack(*args, dw_mxu=True), 20, repeats=3),
                       plain_ms=cuda_ms(lambda: block_stack_dw_mxu_plain(*args), 2),
                       **_bound(nbytes, (3 * hidden2 + 8 * c) * npx,
                                (9 * 2 * c * hidden2 + hidden2 * c) * npx))
        rows.append(row)
        del ker, ref, args
    return rows


def ragged_step_rows(gen, bar_at):
    """K5 two-scale (cross-4, "edge") and K8 against their plain versions on
    the ragged shapes K5_RAGGED and K8_RAGGED, f32 and bf16, each mode, on
    seeded inputs: planes U[0, 1), the previous update 0.3·N(0, 1), weights
    softmaxes of N(0, 1) draws over the window, stencil rows (1, .5, .5, .5)
    + 0.3·N(0, 1), per-graph scalars 0.3-0.6; untimed."""
    import torch

    from irdu_tpu_torch.ops.fused_step import fused_scal, fused_step_plain, gg_fused_step_chw
    from irdu_tpu_torch.ops.pixel_nhwc import pixel_segment_nhwc, pixel_segment_plain

    def rnd(*shape):
        return torch.randn(*shape, device=DEVICE, generator=gen)

    def unit(*shape):
        return torch.rand(*shape, device=DEVICE, generator=gen)

    def soft(*shape, dim):
        return torch.softmax(rnd(*shape), dim=dim)

    base = torch.tensor([1.0, 0.5, 0.5, 0.5], device=DEVICE)
    rows = {"gg_fused_step_chw": [], "pixel_segment_nhwc": []}
    (h, w), g, f = K5_RAGGED
    c = g * f
    planes = [unit(1, c, h, w), unit(1, c, h, w), 0.3 * rnd(1, c, h, w)]
    ws = [soft(1, g, 4, h, w, dim=2), soft(1, g, 4, h, w, dim=2),
          soft(1, g, 4, h // 2, w // 2, dim=2), soft(1, g, 4, h // 2, w // 2, dim=2)]
    tables = [base[None, :, None] + 0.3 * rnd(g, 4, f) for _ in range(4)]
    v = {k: 0.3 + 0.3 * unit(g) for k in ("mu0", "ro0", "mu1", "ro1", "alpha", "beta",
                                          "gamma0", "gamma1")}
    scal = fused_scal(g, **v)
    for dtype in (torch.float32, torch.bfloat16):
        x, aux, prev = (t.to(dtype) for t in planes)
        wt = [t.to(dtype) for t in ws]
        for name, mode, aux_, prev_, kw in (
                ("rhs", "rhs", None, None, {}),
                ("cg_prev_emit_update", "cg", aux, prev, dict(emit_update=True)),
                ("rethresh_y", "rethresh", aux, None, {})):
            args = (x, aux_, prev_, *wt, *tables, scal)
            kw = dict(mode=mode, n_graphs=g, **kw)
            ker, ref = gg_fused_step_chw(*args, **kw), fused_step_plain(*args, **kw)
            sync()
            row = dict(case=name, shape=list(x.shape), dtype=str(dtype)[6:], ragged=True,
                       params="seeded")
            row.update(_agree(ker, ref, aux_ if mode == "rethresh" else x, dtype, bar_at))
            rows["gg_fused_step_chw"].append(row)
    (h, w), graphs, f = K8_RAGGED
    p = base[None] + 0.2 * rnd(2, 4)
    for g in graphs:
        c = g * f
        planes = [unit(1, h, w, c), unit(1, h, w, c), 0.3 * rnd(1, h, w, c)]
        packed = [soft(1, h, w, 12, g, dim=3).reshape(1, h, w, 12 * g) for _ in range(2)]
        sc = torch.stack([0.3 + 0.3 * unit(c) for _ in range(5)])
        for dtype in (torch.float32, torch.bfloat16):
            x, aux, prev = (t.to(dtype) for t in planes)
            wg, wl = (t.to(dtype) for t in packed)
            for mode, aux_, prev_, wl_ in (("rhs", None, None, None), ("cg1", None, None, wl),
                                           ("cg2", aux, prev, wl),
                                           ("rethresh", aux, None, None)):
                args = (x, aux_, prev_, wg, wl_, p, sc)
                kw = dict(mode=mode, n_graphs=g)
                ker, ref = pixel_segment_nhwc(*args, **kw), pixel_segment_plain(*args, **kw)
                sync()
                row = dict(mode=mode, shape=list(x.shape), n_graphs=g, dtype=str(dtype)[6:],
                           ragged=True, params="seeded")
                row.update(_agree(ker, ref, aux_ if mode == "rethresh" else x, dtype, bar_at))
                rows["pixel_segment_nhwc"].append(row)
    return rows


def k5_ops_per_pixel(mode, y=False, prev=False):
    """f32 operations one K5 call needs per full-res pixel of one plane,
    counted as ``k1_ops_per_pixel`` counts them: rhs 51.75 (ρ₀Q₀x, x + t₀ +
    Up t₁, the half-res box down, Q₁ and ρ₁ at a quarter); cg: A·x 88, then
    rhs − A·x and x + α·upd 3, β·prev 2; rethresh: 58 + 1 + 1 +
    (4 + 58 + 1) / 4 = 75.75, y 1."""
    if mode == "rhs":
        return 51.75
    if mode == "cg":
        return 91 + 2 * prev
    return 75.75 + y


def k6_ops_per_pixel(kernel, with_glr=False, identity=False, y=False):
    """K6a: ρQx 39, μ·GLR 27 + 2, x 1; K6b: ρRx 59, y 1."""
    if kernel == "gg_matvec_chw":
        return 39 + 29 * with_glr + identity
    return 59 + y


def step_rows(model, gen, bar_at):
    """K5, K6a and K6b against their plain versions at the BAND² request's
    scale-0 shape (1, 48, 1024, 1024) with the snapshot's scale-0 parameters,
    f32 and bf16 (f32 also: the CHANGE_FACTOR rule, and K5 against the
    K6a/K6b composition), seeded U[0, 1) planes and K2 weights of N(0, 1)
    features; K5 timed in bf16 at every shape the BAND² and 2·BAND²
    requests give it (scale 0 at both, scale 1 at 2·BAND²). ``calls``: the
    calls of one BAND² request (K5), or 1 for the main variant of K6a/K6b."""
    import torch

    from irdu_tpu_torch.ops.edge_weights import edge_weights_plain
    from irdu_tpu_torch.ops.fused_step import (fused_scal, fused_step_plain,
                                               gg_fused_step_chw, gg_matvec_chw,
                                               gtv_rethresh_chw, matvec_plain, rethresh_plain)

    rows = {"gg_fused_step_chw": [], "gg_matvec_chw": [], "gtv_rethresh_chw": []}
    for s, side in ((0, BAND), (0, 2 * BAND), (1, 2 * BAND)):
        g, m0, m1, tables, _ = _filter_params(model, s)
        lf = model.local_filters[s].local_filter
        exp = lambda p: torch.exp(p.float())  # noqa: E731
        mu0, ro0, mu1, ro1, gam0, gam1 = (exp(p) for p in (
            lf.muys00, lf.ro00, lf.muys01, lf.ro01, lf.gamma00, lf.gamma01))
        a, b = lf.alphaCGD.float(), lf.betaCGD.float()
        c = lf.n_node_fts * g
        h = w = side >> s
        checked = (s, side) == (0, BAND)
        for dtype in ((torch.float32, torch.bfloat16) if checked else (torch.bfloat16,)):
            x, aux = (torch.rand(1, c, h, w, device=DEVICE, generator=gen).to(dtype)
                      for _ in range(2))
            prev = (0.3 * torch.randn(1, c, h, w, device=DEVICE, generator=gen)).to(dtype)
            ws = []
            for res, m in ((1, m0), (2, m1)):
                feats = torch.randn(1, 2 * c, h // res, w // res, device=DEVICE,
                                    generator=gen).to(dtype)
                wt = edge_weights_plain(feats, m, 2 * g)
                ws += [wt[:, :g].contiguous(), wt[:, g:].contiguous()]
            del feats, wt
            scal_gtv = fused_scal(g, ro0=ro0, ro1=ro1, gamma0=gam0, gamma1=gam1)
            cases = (  # name, mode, aux, prev, keywords, scal, calls per BAND² request
                ("rhs", "rhs", None, None, {}, scal_gtv, 1),
                ("cg_use_x_rhs", "cg", None, None, dict(use_x_rhs=True),
                 fused_scal(g, mu0=mu0, ro0=ro0, mu1=mu1, ro1=ro1, alpha=a[0]), 1),
                ("rethresh_y", "rethresh", aux, None, {}, scal_gtv, 1),
                ("cg_emit_update", "cg", aux, None, dict(emit_update=True),
                 fused_scal(g, mu0=mu0, ro0=ro0, mu1=mu1, ro1=ro1, alpha=a[1]), 1),
                ("cg_prev", "cg", aux, prev, {},
                 fused_scal(g, mu0=mu0, ro0=ro0, mu1=mu1, ro1=ro1, alpha=a[2], beta=b[2]), 1),
                ("cg_prev_emit_update", "cg", aux, prev, dict(emit_update=True),
                 fused_scal(g, mu0=mu0, ro0=ro0, mu1=mu1, ro1=ro1, alpha=a[2], beta=b[2]), 0))
            for name, mode, aux_, prev_, kw, scal, calls in cases:
                args = (x, aux_, prev_, *ws, *tables, scal)
                kw = dict(mode=mode, n_graphs=g, **kw)
                ker = gg_fused_step_chw(*args, **kw)
                ref = fused_step_plain(*args, **kw)
                sync()
                row = dict(scale=s, request=[side, side], case=name, shape=list(x.shape),
                           dtype=str(dtype)[6:], params="snapshot")
                row.update(_agree(ker, ref, aux_ if mode == "rethresh" else x, dtype, bar_at))
                if dtype == torch.float32:  # K5 against its K6a/K6b composition
                    main = ker[0] if isinstance(ker, tuple) else ker
                    comp = k6_composition(args, kw, g)
                    row["vs_k6"] = max_abs(main, comp)
                    row["ok"] = row["ok"] and within(main, comp, 5e-4, 1e-3)
                if dtype == torch.bfloat16:
                    tensors = [t for t in (x, aux_, prev_) if t is not None] + ws[:1] + ws[2:3]
                    if mode == "cg":
                        tensors += ws[1:2] + ws[3:4]
                    nbytes = (sum(t.numel() * t.element_size() for t in tensors)
                              + x.numel() * x.element_size() * (1 + bool(kw.get("emit_update"))))
                    ops = x.numel() * k5_ops_per_pixel(mode, y=aux_ is not None,
                                                       prev=prev_ is not None)
                    row.update(calls=calls if checked else 0,
                               **times(lambda: gg_fused_step_chw(*args, **kw), 10),
                               plain_ms=cuda_ms(lambda: fused_step_plain(*args, **kw), 2, 1),
                               **_bound(nbytes, ops))
                rows["gg_fused_step_chw"].append(row)
                del ker, ref
            if not checked:
                continue
            for with_glr, identity in ((True, True), (True, False), (False, True), (False, False)):
                args = (x, ws[1], ws[0], tables[1], tables[0], mu0, ro0)
                kw = dict(n_graphs=g, add_identity=identity, with_glr=with_glr)
                ker, ref = gg_matvec_chw(*args, **kw), matvec_plain(*args, **kw)
                row = dict(case=f"glr={with_glr}, identity={identity}", shape=list(x.shape),
                           dtype=str(dtype)[6:], params="snapshot, scale 0")
                row.update(_agree(ker, ref, x if identity else None, dtype, bar_at))
                if dtype == torch.bfloat16:
                    tensors = [x, ws[0]] + ([ws[1]] if with_glr else [])
                    row.update(calls=int(with_glr and identity),
                               **times(lambda: gg_matvec_chw(*args, **kw), 10),
                               plain_ms=cuda_ms(lambda: matvec_plain(*args, **kw), 2, 1),
                               **_bound(sum(t.numel() * t.element_size() for t in tensors)
                                        + x.numel() * x.element_size(), x.numel()
                                        * k6_ops_per_pixel("gg_matvec_chw", with_glr, identity)))
                rows["gg_matvec_chw"].append(row)
            for y in (aux, None):
                args = (x, y, ws[0], tables[0], gam0, ro0)
                ker, ref = gtv_rethresh_chw(*args, n_graphs=g), rethresh_plain(*args, n_graphs=g)
                row = dict(case=f"y={y is not None}", shape=list(x.shape), dtype=str(dtype)[6:],
                           params="snapshot, scale 0")
                row.update(_agree(ker, ref, y, dtype, bar_at))
                if dtype == torch.bfloat16:
                    tensors = [x, ws[0]] + ([y] if y is not None else [])
                    row.update(calls=int(y is not None),
                               **times(lambda: gtv_rethresh_chw(*args, n_graphs=g), 10),
                               plain_ms=cuda_ms(lambda: rethresh_plain(*args, n_graphs=g), 2, 1),
                               **_bound(sum(t.numel() * t.element_size() for t in tensors)
                                        + x.numel() * x.element_size(), x.numel()
                                        * k6_ops_per_pixel("gtv_rethresh_chw", y=y is not None)))
                rows["gtv_rethresh_chw"].append(row)
            del x, aux, prev, ws
            torch.cuda.empty_cache()
    return rows


def _agree(ker, ref, base, dtype, bar_at):
    """Kernel against plain version (both outputs of an emitting K5 call):
    f32 within 5e-4 + 1e-3·|ref| and moved at least CHANGE_FACTOR times that
    bar away from ``base`` (the input it adds to, or 0); bf16 K1's bar."""
    import torch

    pairs = list(zip(ker, ref)) if isinstance(ker, tuple) else [(ker, ref)]
    out = dict(max_abs_err=max(max_abs(k, r) for k, r in pairs),
               max_ref=max(float(r.float().abs().max()) for _, r in pairs))
    ref0 = pairs[0][1]
    out["bar"] = bar_at(ref0, dtype)
    out["change"] = float((ref0.float() - (0 if base is None else base.float())).abs().max())
    if dtype == torch.float32:
        out["ok"] = (all(within(k, r, 5e-4, 1e-3) for k, r in pairs)
                     and out["change"] >= CHANGE_FACTOR * out["bar"])
    else:
        out["ok"] = all(k1_bar(k, r) for k, r in pairs)
    return out


def k6_composition(args, kw, g):
    """K5's output from K6a/K6b calls and the box resampling, as the JAX
    tests compose it (tests/test_solver_chw.py::test_fused_*): the system
    matvec or re-threshold at each scale, then the step's update. K6a and
    K6b run K5's single-scale kernel body, so this holds K5's two-scale
    path (the half-res stencils on the x box's box means, the 2x2 box's
    half-res term) and its epilogues against that body; each call is also
    held against its plain version in its own rows."""
    from irdu_tpu_torch.ops.graph import box_down2x2, box_up2x2
    from irdu_tpu_torch.ops.fused_step import gg_matvec_chw, gtv_rethresh_chw

    x, aux, prev, wg0, wl0, wg1, wl1, pg0, pl0, pg1, pl1, scal = args
    mode = kw["mode"]
    col = [scal[:, k] for k in range(8)]  # μ₀, ρ₀, μ₁, ρ₁, α, β, γ₀, γ₁
    xd = box_down2x2(x)
    if mode == "rethresh":
        return (gtv_rethresh_chw(x, aux, wg0, pg0, col[6], col[1], n_graphs=g)
                + box_up2x2(gtv_rethresh_chw(xd, None, wg1, pg1, col[7], col[3], n_graphs=g)))
    glr = mode == "cg"
    ax = (gg_matvec_chw(x, wl0, wg0, pl0, pg0, col[0], col[1], n_graphs=g, with_glr=glr)
          + box_up2x2(gg_matvec_chw(xd, wl1, wg1, pl1, pg1, col[2], col[3], n_graphs=g,
                                    with_glr=glr, add_identity=False)))
    if mode == "rhs":
        return ax
    per_chan = lambda v: v.repeat_interleave(x.shape[1] // g)[None, :, None, None]  # noqa: E731
    upd = (x if kw.get("use_x_rhs") else aux) - ax
    if prev is not None:
        upd = upd + per_chan(col[5]) * prev
    return x + per_chan(col[4]) * upd


def band_route(model, rounds=2):
    """The flagship's scale-0 solver on the 512x512 request's scale-0 code
    through K1 and through the band route (K1's cap set to 0), on cross-4
    and on each of WINDOW_FLAGSHIP: in f32 on the kernels, within
    5e-4 + 1e-3·|ref|; in bf16 (the serving model) by device time
    (``device_ms``: the kernels of 3 solver calls a session, no host work),
    in turns, K1, band, band, K1 per round, after one untimed call on each
    route. The top-level keys are cross-4's; ``windows`` holds each
    window's; ``ok`` is every window's."""
    import torch

    from irdu_tpu_torch.kernels.timing import device_ms
    from irdu_tpu_torch.predict import load_model
    from irdu_tpu_torch.solvers import gtv_glr

    _, noisy = request_images()[0]
    img = torch.from_numpy(noisy[None]).to(DEVICE)
    cap = gtv_glr._MEGA_MAX_PIXELS
    out = {"windows": {}}
    try:
        model32 = load_model(device=DEVICE, dtype=torch.float32)
        lf32 = model32.local_filters[0].local_filter
        lf = model.local_filters[0].local_filter
        with torch.inference_mode():
            code32 = model32.encode(img)[0]
            code = model.encode(img.to(next(model.parameters()).dtype))[0]
        for window in ("cross4",) + WINDOW_FLAGSHIP:
            with on_window([lf32, lf], window), torch.inference_mode():
                gtv_glr._MEGA_MAX_PIXELS = cap
                via_k1 = lf32(code32)
                gtv_glr._MEGA_MAX_PIXELS = 0
                via_band = lf32(code32)
                sync()
                row = dict(shape=list(code32.shape), f32_max_abs_err=max_abs(via_band, via_k1),
                           f32_change=max_abs(via_k1, code32),
                           ok=within(via_band, via_k1, 5e-4, 1e-3))
                del via_k1, via_band
                times = {"k1": [], "band": []}
                for route in ("k1", "band"):
                    gtv_glr._MEGA_MAX_PIXELS = 0 if route == "band" else cap
                    lf(code)
                for _ in range(rounds):
                    for route in ("k1", "band", "band", "k1"):
                        gtv_glr._MEGA_MAX_PIXELS = 0 if route == "band" else cap
                        times[route].append(round(device_ms(lambda: lf(code), 3, pad=1), 4))
            row.update(bf16_k1_ms=times["k1"], bf16_band_ms=times["band"],
                       median_k1_ms=float(np.median(times["k1"])),
                       median_band_ms=float(np.median(times["band"])),
                       order="k1, band, band, k1, x%d" % rounds, timing="device_ms")
            out["windows"][window] = row
        out.update({k: v for k, v in out["windows"]["cross4"].items()})
        out["ok"] = all(r["ok"] for r in out["windows"].values())
        del model32, lf32
    finally:
        gtv_glr._MEGA_MAX_PIXELS = cap
    return out


def block_rows(model, gen, bar_at):
    """K3 and K4 against their plain versions at every block shape of the
    flagship requests, f32 and bf16, with the snapshot's block parameters (K3:
    the four scale-0 encoder blocks; K4: the first encoder block of each
    scale) on seeded N(0, 1) inputs; times at the 512x512 shapes in bf16."""
    import torch

    from irdu_tpu_torch.ops.block_stack import (block_stack_plain, fused_block_stack,
                                                pack_block_params, stack_route)
    from irdu_tpu_torch.ops.gated_block import fused_gated_block, gated_block_plain

    def k3_kernel(dtype, c, hidden):  # the source a K3 call runs on
        return {"wgmma": "block_stack_wgmma.cu", "block_stack": "block_stack.cu"}[
            stack_route(dtype, c, hidden)]

    rows = {"fused_block_stack": [], "fused_gated_block": []}
    for (h, w) in REQUESTS:
        for s in range(4):
            blocks = model.encoder_scales[s][:4] if s == 0 else model.encoder_scales[s][:1]
            c = model.dims[s]
            for dtype in (torch.float32, torch.bfloat16):
                params = [{k: v.to(dtype) for k, v in blk.gated_params().items()}
                          for blk in blocks]
                x = torch.randn(1, c, h >> s, w >> s, device=DEVICE, generator=gen).to(dtype)
                if s == 0:
                    name, args, kw = "fused_block_stack", (x, *pack_block_params(params, dtype)), {}
                    kernel, plain, calls = fused_block_stack, block_stack_plain, K3_PER_REQUEST
                else:
                    name, args, kw = "fused_gated_block", (x,), params[0]
                    kernel, plain, calls = fused_gated_block, gated_block_plain, K4_PER_SCALE[s]
                ker = kernel(*args, **kw)
                ref = plain(*args, **kw)
                sync()
                change, bar = max_abs(ref, x), bar_at(ref, dtype)
                row = dict(scale=s, blocks=len(blocks), shape=list(x.shape),
                           dtype=str(dtype)[6:], params=f"snapshot, encoder scale {s}",
                           max_abs_err=max_abs(ker, ref),
                           max_ref=float(ref.float().abs().max()), change=change, bar=bar)
                if s == 0:
                    row["kernel"] = k3_kernel(dtype, c, params[0]["w2"].shape[0])
                if dtype == torch.float32:
                    row["ok"] = within(ker, ref, 5e-4, 1e-3) and change >= CHANGE_FACTOR * bar
                else:
                    (row["ok"], row["beyond_one_ulp_share"], row["plain_own_err"],
                     row["rms_vs_plain"]) = block_bar(ker, ref, unrounded(plain, args, kw))
                if dtype == torch.bfloat16 and (h, w) == (FRAME, FRAME):
                    tc, cc = block_ops_per_pixel(c, params[0]["w1"].shape[1])
                    npx = x.shape[2] * x.shape[3] * len(blocks)
                    nbytes = 2 * x.numel() * x.element_size() + sum(
                        t.numel() * t.element_size() for t in list(args[1:]) + list(kw.values()))
                    row.update(calls=calls, **times(lambda: kernel(*args, **kw), 20, repeats=3),
                               plain_ms=cuda_ms(lambda: plain(*args, **kw), 5),
                               **_bound(nbytes, cc * npx, tc * npx))
                rows[name].append(row)
    for c, hidden, h, w in K4_EXTRA:  # seeded N(0, 1) blocks at the other served widths
        def rnd(*shape):
            return torch.randn(*shape, device=DEVICE, generator=gen)
        kw = dict(scale=(rnd(c) * 0.1 + 1).bfloat16(),
                  w1=(rnd(2 * hidden, c) / c ** 0.5).bfloat16().t(),
                  dwk=(rnd(2 * hidden, 3, 3) * 0.2).bfloat16().permute(1, 2, 0),
                  w2=(rnd(c, hidden) / hidden ** 0.5).bfloat16().t(),
                  skip=torch.tensor([1.0, 0.8], device=DEVICE).bfloat16())
        x = torch.randn(1, c, h, w, device=DEVICE, generator=gen).bfloat16()
        ker, ref = fused_gated_block(x, **kw), gated_block_plain(x, **kw)
        sync()
        row = dict(shape=list(x.shape), hidden=hidden, dtype="bfloat16",
                   params="seeded N(0, 1) block", max_abs_err=max_abs(ker, ref),
                   max_ref=float(ref.float().abs().max()))
        (row["ok"], row["beyond_one_ulp_share"], row["plain_own_err"],
         row["rms_vs_plain"]) = block_bar(ker, ref, unrounded(gated_block_plain, (x,), kw))
        rows["fused_gated_block"].append(row)
    for model, c, hidden, k, h, w, calls in K3_EXTRA:  # seeded N(0, 1) blocks, bf16
        def rnd(*shape):
            return torch.randn(*shape, device=DEVICE, generator=gen)
        blocks = [dict(scale=rnd(c) * 0.1 + 1, w1=rnd(c, 2 * hidden) / c ** 0.5,
                       dwk=rnd(3, 3, 2 * hidden) * 0.2, w2=rnd(hidden, c) / hidden ** 0.5,
                       skip=torch.tensor([1.0, 0.8], device=DEVICE)) for _ in range(k)]
        args = (torch.randn(1, c, h, w, device=DEVICE, generator=gen).bfloat16(),
                *pack_block_params(blocks, torch.bfloat16))
        ker, ref = fused_block_stack(*args), block_stack_plain(*args)
        sync()
        row = dict(blocks=k, shape=[1, c, h, w], hidden=hidden, dtype="bfloat16",
                   params="seeded N(0, 1) blocks", kernel=k3_kernel(torch.bfloat16, c, hidden),
                   basis=f"{model} {FRAME}x{FRAME} request", max_abs_err=max_abs(ker, ref),
                   max_ref=float(ref.float().abs().max()))
        (row["ok"], row["beyond_one_ulp_share"], row["plain_own_err"],
         row["rms_vs_plain"]) = block_bar(ker, ref, unrounded(block_stack_plain, args, {}))
        tc, cc = block_ops_per_pixel(c, 2 * hidden)
        npx = h * w * k
        row.update(calls=calls, **times(lambda: fused_block_stack(*args), 20, repeats=3),
                   plain_ms=cuda_ms(lambda: block_stack_plain(*args), 5),
                   **_bound(2 * args[0].numel() * 2 + sum(t.numel() * t.element_size()
                                                          for t in args[1:]),
                            cc * npx, tc * npx))
        rows["fused_block_stack"].append(row)
        del ker, ref, args
    return rows


def pixel_rows(model, gen, bar_at, lines):
    """K2 on the diamond-12 window, K7, and K8 in each mode against their
    plain versions at the shapes of a 512x512 pixel request, with the
    snapshot's solver parameters (multiM, the scalar stencils, μ, ρ, γ, α, β),
    f32 (atol 5e-4, rtol 1e-3; K7 and K8 also the CHANGE_FACTOR rule) and
    bf16 (K2: k2_bar; K7, K8: K1's bar), on seeded inputs: features N(0, 1),
    signals U[0, 1), the previous update 0.3·N(0, 1), the weights K2's of the
    features; K7 also at K7_RAGGED, untimed. Times in bf16 from CUDA events;
    ``calls``: per pixel request on its route (K2 on diamond-12: 1 on the CHW
    route, kept out of the flagship request's sum). K7's yardstick goes to
    ``lines["k7_band_512"]``: the pixel solver's six-call K5 band route on
    the same bf16 inputs, device time against K7's, in turns. The f32 K7 row
    keeps its tile's device time (``f32_device_ms``), out of the sums."""
    import torch

    from irdu_tpu_torch.ops.edge_weights import edge_weights_chw, edge_weights_plain
    from irdu_tpu_torch.ops.graph import pack_edge_weights
    from irdu_tpu_torch.ops.pixel_nhwc import (nhwc_ops_per_pixel, pixel_segment_nhwc,
                                               pixel_segment_plain)
    from irdu_tpu_torch.kernels.build import dtype_code, kernel_library
    from irdu_tpu_torch.kernels.timing import device_ms
    from irdu_tpu_torch.ops.pixel_unroll import (K7_TILES, pixel_unroll_ops_per_pixel,
                                                 gg_pixel_unroll_chw, pixel_unroll_plain)
    from irdu_tpu_torch.ops.windows import DIAMOND12

    mix = model.mixtureGLR_block03
    g, f = mix.n_graphs, mix.n_node_fts
    c, n_e = g * f, len(DIAMOND12)
    h, w = PIXEL_REQUESTS[0]
    m = torch.cat([mix.GTVmodule00.multiM, mix.GLRmodule00.multiM]).float()
    tables = (mix.GTVmodule00.stats_table(), mix.GLRmodule00.stats_table())
    scal = mix._scal()
    p = torch.stack([mix.GTVmodule00.stats_scalars(), mix.GLRmodule00.stats_scalars()])
    planar = {k: v.float().repeat(f) for k, v in
              (("mu", mix.muys00), ("ro", mix.ro00), ("gamma", torch.exp(mix.gamma00.float())))}
    alpha, beta = mix.alphaCGD.float().repeat(1, f), mix.betaCGD.float().repeat(1, f)

    def seg_scal(i):  # K8's (5, C) rows for CG step i (α only, β too from step 1 of a round)
        return torch.stack([planar["mu"], planar["ro"], planar["gamma"], alpha[i],
                            beta[i] if i % 2 else torch.zeros_like(alpha[i])])

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors if t is not None)

    rows = {"edge_weights_chw": [], "gg_pixel_unroll_chw": [], "pixel_segment_nhwc": []}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        feats = torch.randn(1, c, h, w, device=DEVICE, generator=gen).to(dtype)
        feats2 = torch.cat([feats, feats], dim=1)
        ker = edge_weights_chw(feats2, m, n_graphs=2 * g, deltas=DIAMOND12)
        ref = edge_weights_plain(feats2, m, 2 * g, DIAMOND12)
        sync()
        row = dict(window="diamond12", shape=list(feats2.shape), dtype=str(dtype)[6:],
                   params="pixel snapshot multiM", max_abs_err=max_abs(ker, ref),
                   ok=k2_bar(ker, ref) if bf16 else within(ker, ref, 5e-4, 1e-3))
        if bf16:
            row.update(calls=0, **times(lambda: edge_weights_chw(
                feats2, m, n_graphs=2 * g, deltas=DIAMOND12), 10),
                plain_ms=cuda_ms(lambda: edge_weights_plain(feats2, m, 2 * g, DIAMOND12), 2, 1),
                **_bound(nbytes(feats2, m, ker), h * w * 2 * g * k2_ops_per_pixel_graph(f, n_e)))
        rows["edge_weights_chw"].append(row)
        wg, wl = ref[:, :g].contiguous(), ref[:, g:].contiguous()
        del ker, feats2
        y = torch.rand(1, f, h, w, device=DEVICE, generator=gen).to(dtype)
        args = (y, wg, wl, *tables, scal)
        ker = gg_pixel_unroll_chw(*args, n_graphs=g)
        ref = pixel_unroll_plain(*args, n_graphs=g)
        sync()
        row = dict(shape=list(ker.shape), dtype=str(dtype)[6:], params="pixel snapshot")
        row.update(_agree(ker, ref, y.repeat(1, g, 1, 1), dtype, bar_at))
        row.update(ctas_per_sm=kernel_library().irdu_pixel_unroll_ctas_per_sm(
            1, dtype_code(dtype)), tile=list(K7_TILES[dtype]))
        if bf16:
            row.update(calls=1, **times(lambda: gg_pixel_unroll_chw(*args, n_graphs=g), 5),
                       plain_ms=cuda_ms(lambda: pixel_unroll_plain(*args, n_graphs=g), 2, 1),
                       **_bound(nbytes(*args, ker), ker.numel() * pixel_unroll_ops_per_pixel()))
            lines["k7_band_512"] = k7_yardstick(mix, args, g)
        else:  # the f32 tile's device time, on no request's path (kept out of the sums)
            row.update(f32_device_ms=device_ms(lambda: gg_pixel_unroll_chw(*args, n_graphs=g), 5))
        rows["gg_pixel_unroll_chw"].append(row)
        del ker, ref
        x, aux = (torch.rand(1, h, w, c, device=DEVICE, generator=gen).to(dtype)
                  for _ in range(2))
        prev = (0.3 * torch.randn(1, h, w, c, device=DEVICE, generator=gen)).to(dtype)
        wgp, wlp = pack_edge_weights(wg), pack_edge_weights(wl)
        del wg, wl
        cases = {"rhs": (None, None, None, seg_scal(0)), "cg1": (None, None, wlp, seg_scal(0)),
                 "cg2": (aux, prev, wlp, seg_scal(1)), "rethresh": (aux, None, None, seg_scal(0))}
        for mode, (aux_, prev_, wl_, sc) in cases.items():
            args = (x, aux_, prev_, wgp, wl_, p, sc)
            kw = dict(mode=mode, n_graphs=g)
            ker = pixel_segment_nhwc(*args, **kw)
            ref = pixel_segment_plain(*args, **kw)
            sync()
            row = dict(mode=mode, shape=list(x.shape), dtype=str(dtype)[6:],
                       params="pixel snapshot")
            row.update(_agree(ker, ref, aux_ if mode == "rethresh" else x, dtype, bar_at))
            if bf16:
                outs = ker if isinstance(ker, tuple) else (ker,)
                row.update(calls=K8_CALLS[mode],
                           **times(lambda: pixel_segment_nhwc(*args, **kw), 10),
                           plain_ms=cuda_ms(lambda: pixel_segment_plain(*args, **kw), 2, 1),
                           **_bound(nbytes(*args, *outs), x.numel() * nhwc_ops_per_pixel(mode)))
            rows["pixel_segment_nhwc"].append(row)
            del ker, ref
        del x, aux, prev, wgp, wlp
        torch.cuda.empty_cache()
    for side in K7_RAGGED:  # ragged tiles, a plane below one tile; untimed
        for dtype in (torch.float32, torch.bfloat16):
            feats = torch.randn(1, c, *side, device=DEVICE, generator=gen).to(dtype)
            wt = edge_weights_plain(torch.cat([feats, feats], dim=1), m, 2 * g, DIAMOND12)
            y = torch.rand(1, f, *side, device=DEVICE, generator=gen).to(dtype)
            args = (y, wt[:, :g].contiguous(), wt[:, g:].contiguous(), *tables, scal)
            ker = gg_pixel_unroll_chw(*args, n_graphs=g)
            ref = pixel_unroll_plain(*args, n_graphs=g)
            sync()
            row = dict(shape=list(ker.shape), dtype=str(dtype)[6:], params="pixel snapshot",
                       case="ragged")
            row.update(_agree(ker, ref, y.repeat(1, g, 1, 1), dtype, bar_at))
            rows["gg_pixel_unroll_chw"].append(row)
            del ker, ref, feats, wt
    return rows


def k7_yardstick(mix, args, g, rounds=2):
    """K7 against the pixel solver's six-call K5 band route (its route above
    K7's cap, forced here at 512x512) on the same bf16 inputs: device time
    of one unroll each (``kernels/timing.py``: launch-linked profiler
    events), K7, band, band, K7 per round. The band route rounds each step's
    output to bf16 and K7 keeps f32 between its steps, so the outputs are
    compared only loosely (max|d|, kept with the times)."""
    from irdu_tpu_torch.kernels.timing import device_ms
    from irdu_tpu_torch.ops.pixel_unroll import gg_pixel_unroll_chw

    y, wg, wl, pg, pl, scal = args

    def k7():
        return gg_pixel_unroll_chw(*args, n_graphs=g)

    def band():
        return mix._band_route(y.repeat(1, g, 1, 1), wg, wl, (pg, pl))

    t = {"k7": [], "band": []}
    for _ in range(rounds):
        for name in ("k7", "band", "band", "k7"):
            t[name].append(round(device_ms(k7 if name == "k7" else band, 5), 5))
    out = dict(shape=list(y.shape[-2:]), n_graphs=g, k7_device_ms=t["k7"],
               band_device_ms=t["band"], median_k7_ms=float(np.median(t["k7"])),
               median_band_ms=float(np.median(t["band"])),
               band_vs_k7_max_abs=max_abs(band(), k7()),
               order="k7, band, band, k7, x%d" % rounds, calls={"k7": 1, "band": 6})
    out["band_over_k7"] = out["median_band_ms"] / out["median_k7_ms"]
    return out


def pixel_step_rows(model, gen, bar_at):
    """K5's pixel mode (single-scale, diamond-12, reflect) in the four calls
    of the pixel band route, and K6a (with GLR and the identity; GTV only),
    K6b (with y) on that window, against their plain versions at the
    1024x1024 pixel request's shape (1, 72, 1024, 1024), G = 24, and at
    STEP_RAGGED, with the pixel snapshot's solver parameters, f32 (the
    CHANGE_FACTOR rule too) and bf16 (K1's bar), on seeded inputs: signals
    U[0, 1), the previous update 0.3·N(0, 1), the weights K2's plain
    version of N(0, 1) features. K5 timed in bf16 at 1024x1024 and
    2048x2048; ``calls``: per pixel request of that size on the CHW route
    (K6a, K6b: on no path)."""
    import torch

    from irdu_tpu_torch.ops.edge_weights import edge_weights_plain
    from irdu_tpu_torch.ops.fused_step import (fused_scal, fused_step_plain,
                                               gg_fused_step_chw, gg_matvec_chw,
                                               gtv_rethresh_chw, matvec_plain, rethresh_plain)
    from irdu_tpu_torch.ops.windows import DIAMOND12

    mix = model.mixtureGLR_block03
    g, f = mix.n_graphs, mix.n_node_fts
    c = g * f
    m = torch.cat([mix.GTVmodule00.multiM, mix.GLRmodule00.multiM]).float()
    pg, pl = mix.GTVmodule00.stats_table(), mix.GLRmodule00.stats_table()
    mu, ro = mix.muys00.float(), mix.ro00.float()
    gamma = torch.exp(mix.gamma00.float())
    alpha, beta = mix.alphaCGD.float(), mix.betaCGD.float()
    pix = dict(n_graphs=g, deltas=DIAMOND12, stats_mode="reflect")
    rows = {"gg_fused_step_chw": [], "gg_matvec_chw": [], "gtv_rethresh_chw": []}

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors if t is not None)

    for side in (*PIXEL_BAND_REQUESTS, STEP_RAGGED):
        h, w = side
        checked = side != PIXEL_BAND_REQUESTS[1]  # f32 too, and K6a/K6b
        timed = side in PIXEL_BAND_REQUESTS
        for dtype in ((torch.float32, torch.bfloat16) if checked else (torch.bfloat16,)):
            x, aux = (torch.rand(1, c, h, w, device=DEVICE, generator=gen).to(dtype)
                      for _ in range(2))
            prev = (0.3 * torch.randn(1, c, h, w, device=DEVICE, generator=gen)).to(dtype)
            feats = torch.randn(1, c, h, w, device=DEVICE, generator=gen).to(dtype)
            wt = edge_weights_plain(torch.cat([feats, feats], dim=1), m, 2 * g, DIAMOND12)
            wg, wl = wt[:, :g].contiguous(), wt[:, g:].contiguous()
            del feats, wt
            cases = (  # name, mode, aux, prev, GLR graphs, keywords, scal, ops per pixel
                ("rhs", "rhs", None, None, False, {}, fused_scal(g, ro0=ro), 80),
                ("cg_use_x_rhs_emit_update", "cg", None, None, True,
                 dict(use_x_rhs=True, emit_update=True),
                 fused_scal(g, mu0=mu, ro0=ro, alpha=alpha[0]), 127),
                ("cg_prev", "cg", aux, prev, True, {},
                 fused_scal(g, mu0=mu, ro0=ro, alpha=alpha[1], beta=beta[1]), 130),
                ("rethresh_y", "rethresh", aux, None, False, {},
                 fused_scal(g, ro0=ro, gamma0=gamma), 140))
            for name, mode, aux_, prev_, glr, kw, scal, ops in cases:
                args = (x, aux_, prev_, wg, wl if glr else None, None, None, pg,
                        pl if glr else None, None, None, scal)
                kw = dict(mode=mode, **pix, **kw)
                ker = gg_fused_step_chw(*args, **kw)
                ref = fused_step_plain(*args, **kw)
                sync()
                row = dict(window="diamond12", case=name, shape=list(x.shape),
                           dtype=str(dtype)[6:], params="pixel snapshot")
                if timed:
                    row.update(request=list(side), basis=f"{h}x{w} pixel request, CHW route")
                row.update(_agree(ker, ref, aux_ if mode == "rethresh" else x, dtype, bar_at))
                if timed and dtype == torch.bfloat16:
                    outs = ker if isinstance(ker, tuple) else (ker,)
                    row.update(calls=K5_PIXEL_CALLS[name],
                               **times(lambda: gg_fused_step_chw(*args, **kw), 10),
                               plain_ms=cuda_ms(lambda: fused_step_plain(*args, **kw), 2, 1),
                               **_bound(nbytes(x, aux_, prev_, wg, wl if glr else None, *outs),
                                        x.numel() * ops))
                rows["gg_fused_step_chw"].append(row)
                del ker, ref
            if checked:
                for with_glr in (True, False):
                    args = (x, wl, wg, pl, pg, mu, ro)
                    kw = dict(with_glr=with_glr, **pix)
                    ker, ref = gg_matvec_chw(*args, **kw), matvec_plain(*args, **kw)
                    row = dict(window="diamond12", case=f"glr={with_glr}, identity=True",
                               shape=list(x.shape), dtype=str(dtype)[6:],
                               params="pixel snapshot")
                    row.update(_agree(ker, ref, x, dtype, bar_at))
                    if timed and dtype == torch.bfloat16:
                        row.update(calls=0, **times(lambda: gg_matvec_chw(*args, **kw), 10),
                                   plain_ms=cuda_ms(lambda: matvec_plain(*args, **kw), 2, 1),
                                   **_bound(nbytes(x, wg, wl if with_glr else None, ker),
                                            x.numel() * (124 if with_glr else 80)))
                    rows["gg_matvec_chw"].append(row)
                args = (x, aux, wg, pg, gamma, ro)
                ker, ref = gtv_rethresh_chw(*args, **pix), rethresh_plain(*args, **pix)
                row = dict(window="diamond12", case="y=True", shape=list(x.shape),
                           dtype=str(dtype)[6:], params="pixel snapshot")
                row.update(_agree(ker, ref, aux, dtype, bar_at))
                if timed and dtype == torch.bfloat16:
                    row.update(calls=0, **times(lambda: gtv_rethresh_chw(*args, **pix), 10),
                               plain_ms=cuda_ms(lambda: rethresh_plain(*args, **pix), 2, 1),
                               **_bound(nbytes(x, aux, wg, ker), x.numel() * 140))
                rows["gtv_rethresh_chw"].append(row)
                del ker, ref
            del x, aux, prev, wg, wl
            torch.cuda.empty_cache()
    return rows


def boosting_k2_rows(gen):
    """K2 on the ring-8 window at GLR boosting's four calls of a FRAME²
    request (BOOSTING_K2: level k's (1, 5·F, FRAME >> k, FRAME >> k)), with
    the boosting snapshot's metric diagonals, features N(0, 1): f32 (atol
    5e-4, rtol 1e-3) and bf16 (k2_bar) against the plain version, the bf16
    call timed (one call a request), its bound by bytes (features read once,
    E = 8 weights written once) and operations."""
    import torch

    from irdu_tpu_torch.ops.edge_weights import edge_weights_chw, edge_weights_plain
    from irdu_tpu_torch.ops.windows import RING8
    from irdu_tpu_torch.utils.weights import load_params_npz

    tree = load_params_npz(os.path.join(REPO, "artifacts", "weights",
                                        "boosting_synthetic_2050.npz"))["params"]
    g, rows = BOOSTING_GRAPHS, []
    for level, f in BOOSTING_K2:
        h = w = FRAME >> level
        m32 = torch.from_numpy(tree[f"level_{level}"]["GLRmodule"]["multiM"]).to(DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            feats = torch.randn(1, g * f, h, w, device=DEVICE, generator=gen).to(dtype)
            m = m32.to(dtype)
            ker = edge_weights_chw(feats, m, n_graphs=g, deltas=RING8)
            ref = edge_weights_plain(feats, m, g, RING8)
            sync()
            bf16 = dtype == torch.bfloat16
            row = dict(window="ring8", level=level, shape=list(feats.shape), graphs=g,
                       dtype=str(dtype)[6:], params="boosting snapshot multiM",
                       max_abs_err=max_abs(ker, ref),
                       ok=k2_bar(ker, ref) if bf16 else within(ker, ref, 5e-4, 1e-3))
            if bf16:
                nbytes = (feats.numel() + ker.numel()) * 2 + m.numel() * 2
                row.update(basis=f"{FRAME}x{FRAME} boosting request", calls=1,
                           **times(lambda: edge_weights_chw(feats, m, n_graphs=g, deltas=RING8),
                                   20),
                           plain_ms=cuda_ms(lambda: edge_weights_plain(feats, m, g, RING8), 5),
                           **_bound(nbytes, h * w * g * k2_ops_per_pixel_graph(f, 8)))
            rows.append(row)
            del ker, ref, feats
    torch.cuda.empty_cache()
    return {"edge_weights_chw": rows}


def k9_rows(gen, bar_at):
    """K9 against its plain version at the "single" ablation's shape
    K9_SHAPE, G = 1, and at K9_RAGGED, G = 2, f32 and bf16, and in f32
    against K6a on the same data permuted to CHW (the two compute one
    function): the ablation's identity stencil rows, and seeded random rows;
    μ, ρ U(0.2, 0.6); x U[0, 1); the weights K2's plain version of N(0, 1)
    features (GTV, GLR stacked). Timed in bf16 at K9_SHAPE with the identity
    rows, ``calls`` per "single" request."""
    import torch

    from irdu_tpu_torch.ops.edge_weights import edge_weights_plain
    from irdu_tpu_torch.ops.fused_step import gg_matvec_chw
    from irdu_tpu_torch.ops.system_matvec import (OPS_PER_PIXEL_CHANNEL, fused_system_matvec,
                                                  identity_rows, system_matvec_plain)

    rows = []
    for (b, h, w, c), g in ((K9_SHAPE, 1), (K9_RAGGED, 2)):
        timed = (b, h, w, c) == K9_SHAPE
        mu, ro = (0.2 + 0.4 * torch.rand(g, device=DEVICE, generator=gen) for _ in range(2))
        mu_c, ro_c = mu.repeat_interleave(c // g), ro.repeat_interleave(c // g)
        random_rows = [torch.tensor([1.0, 0.5, 0.5, 0.5], device=DEVICE)[:, None]
                       + 0.3 * torch.randn(4, c, device=DEVICE, generator=gen) for _ in range(2)]
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.rand(b, h, w, c, device=DEVICE, generator=gen).to(dtype)
            feats = torch.randn(b, 2 * c, h, w, device=DEVICE, generator=gen).to(dtype)
            m = 0.5 + torch.rand(2 * g, c // g, device=DEVICE, generator=gen)
            wt = edge_weights_plain(feats, m, 2 * g)  # (B, 2G, 4, H, W): GTV, then GLR
            wg, wl = (v.permute(0, 3, 4, 1, 2).contiguous() for v in (wt[:, :g], wt[:, g:]))
            del feats, wt
            for stencil, (pl, pg) in (("identity", (identity_rows(c, DEVICE),) * 2),
                                      ("random", random_rows)):
                args = (x, wl, wg, pl, pg, mu_c, ro_c)
                ker = fused_system_matvec(*args, n_graphs=g)
                ref = system_matvec_plain(*args, n_graphs=g)
                sync()
                row = dict(case=f"{stencil} stencil rows", shape=list(x.shape), n_graphs=g,
                           dtype=str(dtype)[6:], params="seeded")
                if timed:
                    row["basis"] = f"{h}x{w} single ablation request"
                row.update(_agree(ker, ref, x, dtype, bar_at))
                if dtype == torch.float32:  # against K6a on the same data in CHW

                    def table(r):
                        return r.reshape(4, g, c // g).permute(1, 0, 2)

                    k6 = gg_matvec_chw(x.permute(0, 3, 1, 2).contiguous(),
                                       wl.permute(0, 3, 4, 1, 2).contiguous(),
                                       wg.permute(0, 3, 4, 1, 2).contiguous(), table(pl),
                                       table(pg), mu, ro, n_graphs=g).permute(0, 2, 3, 1)
                    sync()
                    row["vs_k6a"] = max_abs(ker, k6)
                    row["ok"] = row["ok"] and within(ker, k6, 5e-4, 1e-3)
                    del k6
                if timed and dtype == torch.bfloat16 and stencil == "identity":
                    row.update(calls=K9_CALLS,
                               **times(lambda: fused_system_matvec(*args, n_graphs=g), 20),
                               plain_ms=cuda_ms(lambda: system_matvec_plain(*args, n_graphs=g),
                                                3, 1),
                               **_bound(sum(t.numel() * t.element_size()
                                            for t in (x, wl, wg, ker)),
                                        x.numel() * OPS_PER_PIXEL_CHANNEL))
                rows.append(row)
                del ker, ref
            del x, wg, wl
            torch.cuda.empty_cache()
    return {"fused_system_matvec": rows}


def _bound(nbytes, ops, tensor_ops=0):
    """The least time: bytes over the memory rate, f32 CUDA-core operations
    over their peak and bf16 tensor-core operations over theirs (the units
    run side by side, so the largest of the three)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / F32_OPS_PER_S, tensor_ops / BF16_TC_OPS_PER_S) * 1e3
    out = dict(bytes=int(nbytes), ops=int(ops), bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    if tensor_ops:
        out["tensor_ops"] = int(tensor_ops)
    return out


def source_headers(source):
    """The repo's headers that a kernel source includes, directly or through
    another header, as paths in the repo (common.cuh aside)."""
    csrc = os.path.dirname(source)
    found, todo = [], [source]
    while todo:
        with open(os.path.join(REPO, todo.pop())) as fh:
            names = re.findall(r'^#include "([\w.]+)"', fh.read(), re.M)
        for n in names:
            path = f"{csrc}/{n}"
            if n != "common.cuh" and path not in found:
                found.append(path)
                todo.append(path)
    return found


def kernels_line(smoke):
    """The per-kernel summary: ms, device_ms, plain_ms and bound_ms are
    summed over the calls one request makes (bf16; a timed row counts
    ``calls`` times): a 512x512 request for K1-K4, a 1024x1024 one for K5
    (a 512x512 request launches none), one call for K6a and K6b (K5's
    oracles, on no request's path), a 512x512 pixel request for K7 (CHW
    route) and K8 (NHWC route), a 512x512 "single" ablation request for K9;
    rows timed on another basis (K5's pixel mode per 1024x1024 and
    2048x2048 pixel request, K3 per lite, micro and split-ablation request,
    K2 on ring-8 per 512x512 boosting request) are summed the same way
    under ``by_basis``; max_abs_err is the f32
    maximum; K3's source is the wgmma stack kernel's, and its rows name the
    kernel each shape took (``block_stack.cu`` for lite's C = 24 and f32);
    K3 with ``dw_mxu`` is an entry of its own (``block_stack_dw_mxu.cu``, off
    every served path, per 512x512 request as K3); ``instances`` lists each
    kernel's compiled variants where it has several (K1: window, pad, source,
    the basis that times it);
    launches are those of the paths' runs (flagship serving, the small
    models, pixel NHWC, pixel CHW, pixel CHW above the cap, each ablation
    config, GLR boosting's protocol and natural runs), summed and by
    path."""
    meta = {
        "fused_block_stack": ("irdu_tpu_torch/kernels/csrc/block_stack_wgmma.cu",
                              "irdu_tpu/ops/pallas/block_stack.py:214"),
        "fused_block_stack_dw_mxu": ("irdu_tpu_torch/kernels/csrc/block_stack_dw_mxu.cu",
                                     "irdu_tpu/ops/pallas/block_stack.py:214"),
        "fused_gated_block": ("irdu_tpu_torch/kernels/csrc/gated_block.cu",
                              "irdu_tpu/ops/pallas/gated_block.py:94"),
        "gg_unroll_chw": ("irdu_tpu_torch/kernels/csrc/gg_unroll.cu",
                          "irdu_tpu/ops/pallas/solver_unroll.py:242"),
        "edge_weights_chw": ("irdu_tpu_torch/kernels/csrc/edge_weights.cu",
                             "irdu_tpu/ops/pallas/solver_chw.py:848"),
        "gg_fused_step_chw": ("irdu_tpu_torch/kernels/csrc/fused_step_hopper.cu",
                              "irdu_tpu/ops/pallas/solver_chw.py:511"),
        "gg_matvec_chw": ("irdu_tpu_torch/kernels/csrc/fused_step_hopper.cu",
                          "irdu_tpu/ops/pallas/solver_chw.py:735"),
        "gtv_rethresh_chw": ("irdu_tpu_torch/kernels/csrc/fused_step_hopper.cu",
                             "irdu_tpu/ops/pallas/solver_chw.py:799"),
        "gg_pixel_unroll_chw": ("irdu_tpu_torch/kernels/csrc/pixel_unroll.cu",
                                "irdu_tpu/ops/pallas/solver_unroll.py:394"),
        "pixel_segment_nhwc": ("irdu_tpu_torch/kernels/csrc/pixel_nhwc.cu",
                               "irdu_tpu/ops/pallas/pixel_nhwc.py:294"),
        "fused_system_matvec": ("irdu_tpu_torch/kernels/csrc/system_matvec.cu",
                                "irdu_tpu/ops/pallas/solver_matvec.py:166"),
    }
    basis = {"gg_fused_step_chw": f"{BAND}x{BAND} request", "gg_matvec_chw": "one call",
             "gtv_rethresh_chw": "one call",
             "gg_pixel_unroll_chw": f"{FRAME}x{FRAME} pixel request, CHW route",
             "pixel_segment_nhwc": f"{FRAME}x{FRAME} pixel request, NHWC route",
             "fused_system_matvec": f"{K9_SHAPE[1]}x{K9_SHAPE[2]} single ablation request"}

    def summed_over(rows):
        rows = [r for r in rows if r.get("calls", 1)]
        return dict(ms=sum(r["ms"] * r.get("calls", 1) for r in rows),
                    device_ms=sum(r["device_ms"] * r.get("calls", 1) for r in rows),
                    plain_ms=sum(r["plain_ms"] * r.get("calls", 1) for r in rows),
                    bound_ms=sum(r["bound_ms"] * r.get("calls", 1) for r in rows),
                    calls=sum(r.get("calls", 1) for r in rows))

    out = []
    for name, (source, replaces) in meta.items():
        rows = getattr(smoke, "kernel_rows", {}).get(name, [])
        timed = [r for r in rows if "ms" in r]
        main_basis = basis.get(name, f"{FRAME}x{FRAME} request")
        others = sorted({r["basis"] for r in timed if r.get("basis", main_basis) != main_basis})
        by_basis = {b: summed_over([r for r in timed if r.get("basis") == b]) for b in others}
        summed = [r for r in timed if r.get("basis", main_basis) == main_basis
                  and r.get("calls", 1)]
        f32 = [r["max_abs_err"] for r in rows if r["dtype"] == "float32"]
        bf16 = [r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16"]
        out.append(dict(
            name=name, route="cuda", source=source, headers=source_headers(source),
            replaces=replaces, instances=KERNEL_INSTANCES.get(name),
            launches=sum(c.get(name, 0) for c in smoke.path_counts.values()),
            launches_by_path={k: c.get(name, 0) for k, c in smoke.path_counts.items()},
            max_abs_err=max(f32) if f32 else None,
            max_abs_err_bf16=max(bf16) if bf16 else None,
            per=main_basis,
            ms=sum(r["ms"] * r.get("calls", 1) for r in summed) if summed else None,
            device_ms=(sum(r["device_ms"] * r.get("calls", 1) for r in summed)
                       if summed else None),
            plain_ms=sum(r["plain_ms"] * r.get("calls", 1) for r in summed) if summed else None,
            bound_ms=sum(r["bound_ms"] * r.get("calls", 1) for r in summed) if summed else None,
            bound_by=max(summed, key=lambda r: r["bound_ms"])["bound_by"] if summed else None,
            library_ms=None,
            library_note=("no single PyTorch call computes a block" if "block" in name
                          else "none: no single call" if "pixel" in name or "matvec" in name
                          else "no single PyTorch call computes this function"),
            by_basis=by_basis, per_call=timed))
    return {"kernels": out}


def dark_split(clean, out):
    """Where the error sits: the share of near-black pixels (every channel of
    the clean image below 0.1), their share of the squared error, and the
    uint8-domain PSNR inside and outside them."""
    from irdu_tpu_torch.eval.metrics import img_as_ubyte

    err = ((img_as_ubyte(np.clip(out, 0, 1)).astype(np.float64) - clean * 255.0) ** 2).mean(-1)
    dark = clean.max(-1) < 0.1

    def db(mask):
        return round(float(10 * np.log10(255.0 ** 2 / err[mask].mean())), 3) if mask.any() else None

    return dict(near_black_px_share=round(float(dark.mean()), 4),
                near_black_err_share=round(float(err[dark].sum() / err.sum()), 4),
                psnr_near_black=db(dark), psnr_rest=db(~dark))


# ---------------------------------------------------------------------------
# the windows phase: every graph window the solver kernels take beyond the
# served ones (the pixel family on cross-4 and ring-8, the flagship on
# diamond-12 and ring-8), and the skip-solve probe
# ---------------------------------------------------------------------------


def window_launches(model, hw):
    """The flagship's launches on ``hw`` on any window, derived from the
    model: PER_REQUEST's blocks, K2 twice a filtering block, and per
    filtering block K1 once where its plane is under the cap
    (``gtv_glr._mega_ok``), else the K5 steps ``gtv_glr._band_route`` issues
    at its ``eval_cg_iters`` (rhs, cg; then rethresh, cg; then cg)."""
    from irdu_tpu_torch.solvers.gtv_glr import _mega_ok

    steps = {1: 2, 2: 4, 3: 5}
    want = dict(PER_REQUEST[hw])
    shapes = [(1, 1, hw[0] >> s, hw[1] >> s) for s in range(len(model.local_filters))]
    want.update(gg_unroll_chw=sum(map(_mega_ok, shapes)),
                edge_weights_chw=2 * len(model.local_filters),
                gg_fused_step_chw=sum(steps[f.local_filter.eval_cg_iters]
                                      for f, shape in zip(model.local_filters, shapes)
                                      if not _mega_ok(shape)))
    return want


@contextlib.contextmanager
def on_window(solvers, name):
    """Each solver's graph window set to ``name`` (its ``deltas``; no
    parameter depends on the window), restored after."""
    from irdu_tpu_torch.ops.windows import WINDOWS

    saved = [m.deltas for m in solvers]
    for m in solvers:
        m.deltas = WINDOWS[name]
    try:
        yield
    finally:
        for m, d in zip(solvers, saved):
            m.deltas = d


@contextlib.contextmanager
def recorded_calls(sites):
    """While open, each call through ``sites`` is kept as (args, kwargs)
    under its kernel's name and passed on (nested inside ``kernel_checks``,
    to the checked call)."""
    calls = {name: [] for _, name, _, _ in sites}
    saved = [getattr(mod, name) for mod, name, _, _ in sites]

    def recorder(name, fn):
        def call(*args, **kw):
            calls[name].append((args, kw))
            return fn(*args, **kw)
        call.launches = 0  # as kernel_checks' wrappers: K8 counts through its module's name
        return call

    for (mod, name, _, _), fn in zip(sites, saved):
        setattr(mod, name, recorder(name, fn))
    try:
        yield calls
    finally:
        for (mod, name, _, _), fn in zip(sites, saved):
            setattr(mod, name, fn)


def k5_window_ops(mode, n_edges, two, glr=True, y=False, prev=False, gtv_stats=True,
                  glr_stats=True):
    """f32 operations one K5 call needs per full-res pixel of one plane on a
    window of E edges, each edge term once (``ops.pixel_unroll.edge_ops``,
    with or without each operator's stencil): its term (rhs Q, cg Q [+ GLR],
    rethresh R), two-scale plus a quarter of the half-res term and of its box
    mean and upsampled add (4); then the epilogue: rhs 1, cg rhs − (x + T)
    and x + α·upd 4 (β·prev 2), rethresh y 1."""
    from irdu_tpu_torch.ops.pixel_unroll import edge_ops

    ops = edge_ops(n_edges, gtv_stats, glr_stats)
    term = {"rhs": ops["q"], "cg": ops["q"] + ops["glr"] * glr, "rethresh": ops["rethresh"]}[mode]
    return term + (term + 4) / 4 * two + {"rhs": 1, "cg": 4 + 2 * prev, "rethresh": y}[mode]


def has_stencil(table):
    """Whether a stats table asks for stencil work: not where it is None or
    the identity's ([1, 0, 0, 0] for every graph and feature, as the solvers
    pass a missing stencil), where the function needs no stencil."""
    return table is not None and not (bool((table[:, 0] == 1).all())
                                      and bool((table[:, 1:] == 0).all()))


def call_cost(name, args, kw, out):
    """The bytes one recorded call moves (each tensor argument read once,
    each output written once), the f32 operations it does and its bf16
    tensor-core operations (K3, K4: the grouped products' own, a 1/nsubnets
    share of the dense block-diagonal ones the kernel multiplies, whose
    zeros the function does not need). A graph operator whose stats tables
    ask for no stencil (``has_stencil``) counts none."""
    import torch

    from irdu_tpu_torch.ops.pixel_nhwc import nhwc_ops_per_pixel
    from irdu_tpu_torch.ops.pixel_unroll import edge_ops, pixel_unroll_ops_per_pixel

    tensors = [t for t in (*args, *kw.values(), *(out if isinstance(out, tuple) else (out,)))
               if isinstance(t, torch.Tensor)]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    if name in ("fused_block_stack", "fused_gated_block"):
        x, ns = args[0], kw.get("nsubnets", 1)
        k, hidden2 = ((args[2].shape[0], args[2].shape[1]) if name == "fused_block_stack"
                      else (1, kw["w1"].shape[1]))
        tc, cc = block_ops_per_pixel(x.shape[1], hidden2)
        npx = x.shape[0] * x.shape[2] * x.shape[3] * k
        return nbytes, cc * npx, tc * npx / ns
    n_e = len(kw["deltas"])
    if name == "gg_matvec_chw":  # x, w_glr, w_gtv, pglr, pgtv, mu, ro
        ops = edge_ops(n_e, has_stencil(args[4]), has_stencil(args[3]))
        return nbytes, args[0].numel() * ops["matvec"], 0
    if name == "edge_weights_chw":
        feats, g = args[0], kw["n_graphs"]
        b, c, h, w = feats.shape
        return nbytes, b * h * w * g * k2_ops_per_pixel_graph(c // g, n_e), 0
    if name == "gg_fused_step_chw":
        x, aux, prev = args[:3]
        return nbytes, x.numel() * k5_window_ops(
            kw["mode"], n_e, args[5] is not None, glr=kw.get("with_glr", True),
            y=aux is not None, prev=prev is not None,
            gtv_stats=has_stencil(args[7]) or has_stencil(args[9]),
            glr_stats=has_stencil(args[8]) or has_stencil(args[10])), 0
    if name == "gg_pixel_unroll_chw":  # y, w_gtv, w_glr, pgtv, pglr, scal
        stats = has_stencil(args[3]) or has_stencil(args[4])
        return nbytes, out.numel() * pixel_unroll_ops_per_pixel(n_e, stats), 0
    if name == "gg_unroll_chw":  # the tables are args[5:9]
        stats = any(has_stencil(t) for t in args[5:9])
        return nbytes, out.numel() * k1_ops_per_pixel(kw.get("eval_cg_iters", 3), n_e, stats), 0
    return nbytes, args[0].numel() * nhwc_ops_per_pixel(kw["mode"], n_e,  # K8
                                                        has_stencil(args[5])), 0


def replay_rows(calls, summary, sites, basis, window, names=WINDOW_KERNELS):
    """One bf16 row per kernel of ``names`` of a request's recorded calls:
    all its calls replayed, timed as one (``times``: CUDA events and device
    time over WINDOW_REPS replays), the plain versions' time, the bound
    summed over the calls, the max|d| of the checked run's calls; ``calls``
    1 (the row is a request's)."""
    kern = wrappers()
    plains = {name: plain for _, name, plain, _ in sites}
    rows = {}
    for name, recs in calls.items():
        if not recs or name not in names:
            continue
        nbytes = ops = tops = 0
        for args, kw in recs:
            b, o, t = call_cost(name, args, kw, kern[name](*args, **kw))
            nbytes, ops, tops = nbytes + b, ops + o, tops + t
        sync()

        def run(fn, recs=recs):
            for args, kw in recs:
                fn(*args, **kw)

        rows[name] = [dict(
            window=window, basis=basis, dtype="bfloat16", calls=1, n_calls=len(recs),
            max_abs_err=summary["max_abs_err"][name], ok=summary["calls_ok"],
            **times(lambda: run(kern[name]), WINDOW_REPS),
            plain_ms=cuda_ms(lambda: run(plains[name]), 1, 1), **_bound(nbytes, ops, tops))]
    return rows


def window_request(model, solvers, window, noisy, clean, hw, want, sites):
    """One request on ``window``: served with every count zeroed just before
    and read just after, then again with every kernel call held against its
    plain version and recorded; returns the served row (its launches, the
    checks), the counts, the recorded calls and the checks' summary."""
    with on_window(solvers, window):
        (row,), counts = serve(model, [(clean, noisy, hw)])
        with kernel_checks(sites) as rec, recorded_calls(sites) as calls:
            from irdu_tpu_torch.predict import denoise

            denoise(model, noisy)
        summary = checks_summary(rec, want)
    row.update(window=window, **summary)
    row["launches_ok"] = row["launches"] == want
    return row, counts, calls, summary


def phase_windows(smoke):
    """The pixel model (its snapshot, bf16) on cross-4 and ring-8 serves
    512x512 on NHWC (1 K2, 6 K8), 512x512 on CHW (1 K2, 1 K7) and 1024x1024
    on CHW (1 K2, 6 K5), and the 86k flagship on diamond-12 and ring-8 serves
    512x512 (window_launches: 3 K3, 32 K4, 4 K1, 8 K2, no K5), each with its
    counts zeroed just before and read just after, then once more with every
    kernel call held against its plain version (K2's bar; K1, K5, K7, K8 K1's)
    and recorded; each kernel's calls of each request replayed and timed
    (``replay_rows``). The pixel model with ``eval_skip_solve`` on 512x512
    launches nothing. The WINDOW_ABLATIONS models (seeded, bf16) on
    diamond-12 and ring-8 serve 512x512 the same way, their launches
    ``window_ablation_launches`` (no K9; K1 or K6a).
    Then one f32 row per kernel and window at the served shapes
    (``window_f32_rows``) and per ablation solver and window
    (``window_ablation_f32_rows``), which must move its input by
    CHANGE_FACTOR times its bar."""
    import torch

    from irdu_tpu_torch.predict import denoise, load_model

    by_size = dict(zip(REQUESTS, request_images()))
    pixel = smoke.pixel_model or load_model(device=DEVICE, name="pixel")
    mix = pixel.mixtureGLR_block03
    flagship = smoke.model or load_model(device=DEVICE)
    solvers = [f.local_filter for f in flagship.local_filters]
    requests, new_rows = [], {}

    def add(rows):
        for name, rs in rows.items():
            new_rows.setdefault(name, []).extend(rs)

    try:
        for window in WINDOW_PIXEL:
            for route, hw, want in WINDOW_PIXEL_RUNS:
                mix.use_nhwc_unroll = route == "nhwc"
                clean, noisy = by_size[hw]
                with on_window([mix], window):
                    denoise(pixel, noisy)  # warm-up
                path = f"windows_pixel_{window}_{route}_{hw[0]}"
                row, smoke.path_counts[path], calls, summary = window_request(
                    pixel, [mix], window, noisy, clean, hw, want, pixel_sites())
                requests.append(dict(row, model="pixel", route=route))
                add(replay_rows(calls, summary, pixel_sites(),
                                f"{hw[0]}x{hw[1]} pixel request, {route.upper()} route, "
                                f"{window}", window))
                del calls
        mix.use_nhwc_unroll = True
        hw = WINDOW_PIXEL_RUNS[0][1]  # the served route's 512x512 request
        clean, noisy = by_size[hw]
        mix.eval_skip_solve = True
        denoise(pixel, noisy)
        (skip,), smoke.path_counts["windows_pixel_skip_solve"] = serve(
            pixel, [(clean, noisy, hw)])
    finally:
        mix.use_nhwc_unroll, mix.eval_skip_solve = True, False
    requests.append(dict(skip, model="pixel", route="eval_skip_solve",
                         launches_ok=not any(skip["launches"].values())))
    hw = WINDOW_FLAGSHIP_REQUEST
    want = window_launches(flagship, hw)
    clean, noisy = by_size[hw]
    for window in WINDOW_FLAGSHIP:
        with on_window(solvers, window):
            denoise(flagship, noisy)  # warm-up
        row, smoke.path_counts[f"windows_flagship_{window}"], calls, summary = window_request(
            flagship, solvers, window, noisy, clean, hw, want, flagship_sites())
        requests.append(dict(row, model="flagship"))
        add(replay_rows(calls, summary, flagship_sites(),
                        f"{hw[0]}x{hw[1]} request, {window}", window))
        del calls
    for name in WINDOW_ABLATIONS:
        model = ablation_model(name, torch.bfloat16)
        solver = model.localfilter
        want = window_ablation_launches(name, model)
        for window in WINDOW_FLAGSHIP:
            with on_window([solver], window):
                denoise(model, noisy)  # warm-up
            row, smoke.path_counts[f"windows_{name}_{window}"], calls, summary = window_request(
                model, [solver], window, noisy, clean, hw, want, ablation_sites())
            requests.append(dict(row, model=name))
            add(replay_rows(calls, summary, ablation_sites(),
                            f"{hw[0]}x{hw[1]} {name} request, {window}", window))
            del calls
        del model, solver
    torch.cuda.empty_cache()
    add(window_ablation_f32_rows(noisy))
    add(window_f32_rows(pixel, flagship))
    for name, rows in new_rows.items():
        smoke.kernel_rows.setdefault(name, []).extend(rows)
    smoke.lines["windows"] = {
        "requests": requests, "rows": new_rows, "card": smoke.lines["device"]["nvidia_smi"],
        "weights": {"pixel": "pixel_synthetic_2050.npz",
                    "flagship": "flagship_cont100k_35000.npz"}, "dtype": "bfloat16"}
    for r in requests:
        what = f"windows: {r['model']} {r.get('window')} {r.get('route')} {r['shape']}"
        require(r["launches_ok"] and r["finite"],
                f"{what}: launches {r['launches']}, finite {r['finite']}")
        require(r.get("calls_ok", True), f"{what}: a kernel call disagrees with its plain "
                f"version, or the calls are not those launched (max|d| {r.get('max_abs_err')})")
    bad = [(k, r) for k, rows in new_rows.items() for r in rows if not r["ok"]]
    require(not bad, f"windows: rows disagree with their plain versions, or an f32 row "
            f"moved its input by under {CHANGE_FACTOR}x the bar: {bad}")


def window_ablation_launches(name, model):
    """An ablation model's launches on a window other than cross-4, derived
    from the model: ABLATION_LAUNCHES' heads and K2; the two-scale solver
    (MixtureGTVGLR) on K1 as on cross-4 (its ABLATION_SIDE² plane is under
    the cap); the single-scale GTV+GLR solver's K9 matvecs on K6a instead."""
    from irdu_tpu_torch.solvers.gtv_glr import MixtureGTVGLR

    want = dict(ABLATION_LAUNCHES[name])
    if not isinstance(model.localfilter, MixtureGTVGLR):
        want.update(gg_matvec_chw=want["fused_system_matvec"], fused_system_matvec=0)
    return want


def window_ablation_f32_rows(noisy):
    """One f32 row per WINDOW_ABLATIONS solver and WINDOW_FLAGSHIP window: the
    solver (its heads, K2 and K5 or K6a) on its input at ABLATION_SIDE² (the
    request image tiled to its channels), kernels against plain (atol 5e-4,
    rtol 1e-3), moving its input by CHANGE_FACTOR times that bar
    (``_agree``)."""
    import torch

    from irdu_tpu_torch.models.registry import set_kernels

    rows = {"ablation_solvers": []}
    img = torch.from_numpy(noisy[None]).to(DEVICE).permute(0, 3, 1, 2)
    for name in WINDOW_ABLATIONS:
        solver = ablation_model(name, torch.float32).localfilter
        x = img.repeat(1, solver.n_graphs * solver.n_node_fts // 3, 1, 1).contiguous()
        for window in WINDOW_FLAGSHIP:
            with on_window([solver], window), torch.inference_mode():
                set_kernels(solver, True)
                ker = solver(x)
                set_kernels(solver, False)
                ref = solver(x)
            sync()
            row = dict(window=window, config=name, shape=list(x.shape), dtype="float32",
                       params="seeded (ablation_model)")
            row.update(_agree(ker, ref, x, torch.float32,
                              lambda r, dt: 5e-4 + 1e-3 * float(r.float().abs().max())))
            rows["ablation_solvers"].append(row)
            del ker, ref
        del solver, x
        torch.cuda.empty_cache()
    return rows


def window_f32_rows(pixel, flagship):
    """One f32 row per kernel and window, kernel against plain on seeded
    inputs at the served shapes (atol 5e-4, rtol 1e-3; K5, K7 and K8 also
    moving their input by CHANGE_FACTOR times that bar, ``_agree``): K2, K7
    and K8 in each mode at the 512x512 pixel request's shapes and K5's four
    pixel-mode calls at 1024x1024 (pixel snapshot parameters) on cross-4 and
    ring-8; K2 and K5's two-scale calls at the 512x512 flagship request's
    scale 0 (the 86k snapshot's scale-0 parameters) on diamond-12 and
    ring-8."""
    import torch

    from irdu_tpu_torch.ops.edge_weights import edge_weights_chw, edge_weights_plain
    from irdu_tpu_torch.ops.fused_step import fused_scal, fused_step_plain, gg_fused_step_chw
    from irdu_tpu_torch.ops.graph import pack_edge_weights
    from irdu_tpu_torch.ops.pixel_nhwc import pixel_segment_nhwc, pixel_segment_plain
    from irdu_tpu_torch.ops.pixel_unroll import gg_pixel_unroll_chw, pixel_unroll_plain
    from irdu_tpu_torch.ops.windows import WINDOWS

    f32 = torch.float32
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    rows = {"edge_weights_chw": [], "gg_fused_step_chw": [], "gg_pixel_unroll_chw": [],
            "pixel_segment_nhwc": []}

    def bar_at(ref, dtype):
        return 5e-4 + 1e-3 * float(ref.float().abs().max())

    def rand(*shape, scale=None):
        t = (torch.randn if scale else torch.rand)(*shape, device=DEVICE, generator=gen)
        return t * scale if scale else t

    def k2_row(feats, m, g, deltas, window, params):
        ker = edge_weights_chw(feats, m, n_graphs=g, deltas=deltas)
        ref = edge_weights_plain(feats, m, g, deltas)
        sync()
        rows["edge_weights_chw"].append(dict(
            window=window, shape=list(feats.shape), dtype="float32", params=params,
            max_abs_err=max_abs(ker, ref), ok=within(ker, ref, 5e-4, 1e-3)))
        return ref

    def step_row(window, case, args, kw, base, params):
        ker, ref = gg_fused_step_chw(*args, **kw), fused_step_plain(*args, **kw)
        sync()
        row = dict(window=window, case=case, shape=list(args[0].shape), dtype="float32",
                   params=params)
        row.update(_agree(ker, ref, base, f32, bar_at))
        rows["gg_fused_step_chw"].append(row)

    mix = pixel.mixtureGLR_block03
    g, f = mix.n_graphs, mix.n_node_fts
    c = g * f
    m = torch.cat([mix.GTVmodule00.multiM, mix.GLRmodule00.multiM]).float()
    tables = tuple(t.float() for t in (mix.GTVmodule00.stats_table(),
                                       mix.GLRmodule00.stats_table()))
    scal = mix._scal().float()
    p = torch.stack([mix.GTVmodule00.stats_scalars(), mix.GLRmodule00.stats_scalars()]).float()
    mu, ro = mix.muys00.float(), mix.ro00.float()
    gamma = torch.exp(mix.gamma00.float())
    alpha, beta = mix.alphaCGD.float(), mix.betaCGD.float()
    planar = {k: v.repeat(f) for k, v in (("mu", mu), ("ro", ro), ("gamma", gamma))}
    seg_scal = [torch.stack([planar["mu"], planar["ro"], planar["gamma"], alpha[i].repeat(f),
                             beta[i].repeat(f) if i % 2 else torch.zeros(c, device=DEVICE)])
                for i in range(2)]
    for window in WINDOW_PIXEL:
        d = WINDOWS[window]
        h, w = PIXEL_REQUESTS[0]
        feats = rand(1, c, h, w, scale=1.0)
        wt = k2_row(torch.cat([feats, feats], dim=1), m, 2 * g, d, window, "pixel snapshot")
        wg, wl = wt[:, :g].contiguous(), wt[:, g:].contiguous()
        y = rand(1, f, h, w)
        args = (y, wg, wl, *tables, scal)
        ker = gg_pixel_unroll_chw(*args, n_graphs=g, deltas=d)
        ref = pixel_unroll_plain(*args, n_graphs=g, deltas=d)
        sync()
        row = dict(window=window, shape=list(ker.shape), dtype="float32",
                   params="pixel snapshot")
        row.update(_agree(ker, ref, y.repeat(1, g, 1, 1), f32, bar_at))
        rows["gg_pixel_unroll_chw"].append(row)
        x, aux = rand(1, h, w, c), rand(1, h, w, c)
        prev = rand(1, h, w, c, scale=0.3)
        wgp, wlp = pack_edge_weights(wg), pack_edge_weights(wl)
        for mode, (aux_, prev_, wl_, sc) in {
                "rhs": (None, None, None, seg_scal[0]), "cg1": (None, None, wlp, seg_scal[0]),
                "cg2": (aux, prev, wlp, seg_scal[1]),
                "rethresh": (aux, None, None, seg_scal[0])}.items():
            args = (x, aux_, prev_, wgp, wl_, p, sc)
            kw = dict(mode=mode, n_graphs=g, deltas=d)
            ker, ref = pixel_segment_nhwc(*args, **kw), pixel_segment_plain(*args, **kw)
            sync()
            row = dict(window=window, mode=mode, shape=list(x.shape), dtype="float32",
                       params="pixel snapshot")
            row.update(_agree(ker, ref, aux_ if mode == "rethresh" else x, f32, bar_at))
            rows["pixel_segment_nhwc"].append(row)
        del feats, wt, wg, wl, y, x, aux, prev, wgp, wlp, ker, ref
        h, w = PIXEL_BAND_REQUESTS[0]
        x, aux = rand(1, c, h, w), rand(1, c, h, w)
        prev = rand(1, c, h, w, scale=0.3)
        feats = rand(1, c, h, w, scale=1.0)
        wt = edge_weights_plain(torch.cat([feats, feats], dim=1), m, 2 * g, d)
        wg, wl = wt[:, :g].contiguous(), wt[:, g:].contiguous()
        del feats, wt
        pix = dict(n_graphs=g, deltas=d, stats_mode="reflect")
        for case, mode, aux_, prev_, glr, kw, sc in (
                ("rhs", "rhs", None, None, False, {}, fused_scal(g, ro0=ro)),
                ("cg_use_x_rhs_emit_update", "cg", None, None, True,
                 dict(use_x_rhs=True, emit_update=True),
                 fused_scal(g, mu0=mu, ro0=ro, alpha=alpha[0])),
                ("cg_prev", "cg", aux, prev, True, {},
                 fused_scal(g, mu0=mu, ro0=ro, alpha=alpha[1], beta=beta[1])),
                ("rethresh_y", "rethresh", aux, None, False, {},
                 fused_scal(g, ro0=ro, gamma0=gamma))):
            args = (x, aux_, prev_, wg, wl if glr else None, None, None, tables[0],
                    tables[1] if glr else None, None, None, sc)
            step_row(window, case, args, dict(mode=mode, **pix, **kw),
                     aux_ if mode == "rethresh" else x, "pixel snapshot")
        del x, aux, prev, wg, wl
        torch.cuda.empty_cache()
    gs, m0, m1, ftables, _ = _filter_params(flagship, 0)
    lf = flagship.local_filters[0].local_filter
    mu0, ro0, mu1, ro1, gam0, gam1 = lf._positive()
    a, b = lf.alphaCGD.float(), lf.betaCGD.float()
    c = lf.n_node_fts * gs
    h, w = WINDOW_FLAGSHIP_REQUEST
    ftables = [t.float() for t in ftables]
    for window in WINDOW_FLAGSHIP:
        d = WINDOWS[window]
        ws = []
        for res, mm in ((1, m0), (2, m1)):
            wt = k2_row(rand(1, 2 * c, h // res, w // res, scale=1.0), mm, 2 * gs, d, window,
                        f"86k snapshot, scale 0, {'full' if res == 1 else 'half'} res")
            ws += [wt[:, :gs].contiguous(), wt[:, gs:].contiguous()]
        x, aux = rand(1, c, h, w), rand(1, c, h, w)
        prev = rand(1, c, h, w, scale=0.3)
        scal_gtv = fused_scal(gs, ro0=ro0, ro1=ro1, gamma0=gam0, gamma1=gam1)
        for case, mode, aux_, prev_, kw, sc in (
                ("rhs", "rhs", None, None, {}, scal_gtv),
                ("cg_use_x_rhs", "cg", None, None, dict(use_x_rhs=True),
                 fused_scal(gs, mu0=mu0, ro0=ro0, mu1=mu1, ro1=ro1, alpha=a[0])),
                ("rethresh_y", "rethresh", aux, None, {}, scal_gtv),
                ("cg_prev_emit_update", "cg", aux, prev, dict(emit_update=True),
                 fused_scal(gs, mu0=mu0, ro0=ro0, mu1=mu1, ro1=ro1, alpha=a[2], beta=b[2]))):
            args = (x, aux_, prev_, *ws, *ftables, sc)
            step_row(window, case, args, dict(mode=mode, n_graphs=gs, deltas=d, **kw),
                     aux_ if mode == "rethresh" else x, "86k snapshot, scale 0")
        del x, aux, prev, ws
        torch.cuda.empty_cache()
    return rows


def phase_model(smoke):
    """The f32 model on each request's noisy image, kernel path against plain
    path; the denoised outputs go to chiprun_out/model_outputs.npz (in
    float16, to keep the output directory small)."""
    import torch

    from irdu_tpu_torch.models.registry import set_kernels
    from irdu_tpu_torch.predict import load_model

    model = load_model(device=DEVICE, dtype=torch.float32)
    rows, saved = [], {}
    for (clean, noisy), (h, w) in zip(request_images(), REQUESTS):
        x = torch.from_numpy(noisy[None]).to(DEVICE)  # every request is a multiple of 16
        with torch.inference_mode():
            set_kernels(model, True)
            ker = model(x)
            set_kernels(model, False)
            ref = model(x)
        sync()
        ker_np, ref_np = ker[0].cpu().numpy(), ref[0].cpu().numpy()
        saved[f"{h}x{w}"] = ker_np
        rows.append(dict(shape=[1, h, w, 3], max_abs_err=max_abs(ker, ref),
                         finite=bool(torch.isfinite(ker).all()),
                         psnr_kernels=psnr(clean, ker_np), psnr_plain=psnr(clean, ref_np),
                         **dark_split(clean, ker_np)))
    del model
    torch.cuda.empty_cache()
    rows += pixel_model_rows(saved)
    np.savez_compressed(os.path.join(OUT_DIR, "model_outputs.npz"),
                        **{k: v.astype(np.float16) for k, v in saved.items()})
    smoke.lines["model"] = {"model_check": rows, "dtype": "float32", "tf32": False,
                            "atol": 1e-3}
    for r in rows:
        require(r["finite"] and r["max_abs_err"] <= 1e-3,
                f"{r['shape']}: kernel path vs plain path max|d| {r['max_abs_err']}")
        require(abs(r["psnr_kernels"] - r["psnr_plain"]) <= 0.01,
                f"{r['shape']}: PSNR {r['psnr_kernels']} (kernels) vs {r['psnr_plain']}")


def pixel_model_rows(saved):
    """The pixel model in f32 on its 512x512 and 480x320 requests' noisy
    images: the NHWC kernel route against the plain route (both solver flags
    off); at 512x512, and on the PIXEL_RAGGED crop of it, the CHW kernel
    route against it too; at 1024x1024 the CHW route above K7's cap (K5's
    pixel mode)."""
    import torch

    from irdu_tpu_torch.predict import load_model

    model = load_model(device=DEVICE, dtype=torch.float32, name="pixel")
    mix = model.mixtureGLR_block03
    (clean_512, noisy_512), request_480, request_1024 = pixel_images()
    rh, rw = PIXEL_RAGGED
    cases = (((clean_512, noisy_512), PIXEL_REQUESTS[0], ("nhwc", "chw")),
             (request_480, PIXEL_REQUESTS[1], ("nhwc",)),
             ((clean_512[:rh, :rw], noisy_512[:rh, :rw]), PIXEL_RAGGED, ("nhwc", "chw")),
             (request_1024, PIXEL_BAND_REQUESTS[0], ("chw",)))
    rows = []
    try:
        for (clean, noisy), (h, w), routes in cases:
            x = torch.from_numpy(np.ascontiguousarray(noisy[None])).to(DEVICE)
            with torch.inference_mode():
                mix.use_nhwc_unroll = mix.use_pallas_unroll = False
                ref = model(x)
                for route in routes:
                    mix.use_nhwc_unroll, mix.use_pallas_unroll = route == "nhwc", True
                    require(mix.route() == route, route)
                    ker = model(x)
                    sync()
                    ker_np = ker[0].cpu().numpy()
                    saved[f"pixel_{route}_{h}x{w}"] = ker_np
                    rows.append(dict(model="pixel", route=route, shape=[1, h, w, 3],
                                     max_abs_err=max_abs(ker, ref),
                                     finite=bool(torch.isfinite(ker).all()),
                                     psnr_kernels=psnr(clean, ker_np),
                                     psnr_plain=psnr(clean, ref[0].cpu().numpy())))
    finally:
        mix.use_nhwc_unroll = mix.use_pallas_unroll = True
    return rows


def counted(fn):
    """fn() with every launch count set to 0 just before and read just after."""
    kern = wrappers()
    for k in kern.values():
        k.launches = 0
    out = fn()
    sync()
    return out, {n: k.launches for n, k in kern.items()}


def times_launches(per, n):
    return {k: n * v for k, v in per.items()}


def phase_eval(smoke):
    """The eval protocol on the synthetic val set in bf16 for every served
    snapshot and variant (``EVAL_SNAPSHOTS``): mean and per-image PSNR, each
    gated one within EVAL_BAR_DB of its JAX target, the launches of the
    run 6 times one image's; the pixel model's CHW route too (no target);
    each snapshot's cg3 in f32. Then batches of 1 and EVAL_BATCH against one
    image a call (``evaluate_pairs_batched`` with ``device_metrics``) for the
    flagship and the pixel model, and the flagship in f32 with its kernels
    against their plain versions: per-image PSNRs within EVAL_SAME_DB."""
    import torch

    from irdu_tpu_torch.data.synthetic import synthetic_val_set
    from irdu_tpu_torch.eval.curve import variant_tag
    from irdu_tpu_torch.eval.harness import evaluate_pairs, evaluate_pairs_batched
    from irdu_tpu_torch.models.registry import set_kernels
    from irdu_tpu_torch.predict import batch_forward, load_model

    images = synthetic_val_set()

    def protocol(model, sigma=25.0):
        return evaluate_pairs(batch_forward(model), images, sigma, bucket=64)

    def gap(a, b):
        return max(abs(x - y) for x, y in zip(a, b))

    rows, batched, lines = [], [], []

    def record(tag, per, res, counts, dtype="bfloat16", sigma=25.0):
        target, source = EVAL_TARGETS.get(tag, (None, None))
        row = dict(variant=tag, dtype=dtype, sigma=sigma, psnr=res["mean_psnr"],
                   psnr_per_image=res["psnr"], target=target, target_source=source,
                   gap_db=None if target is None else res["mean_psnr"] - target,
                   launches=counts, want=times_launches(EVAL_PER_IMAGE[per], len(images)))
        rows.append(row)
        lines.append(f"eval {tag} ({dtype}, sigma {sigma:g}): mean {row['psnr']:.4f} dB, target "
                     f"{target if target is not None else 'none'}"
                     + ("" if target is None else f", gap {row['gap_db']:+.4f}")
                     + f"; per image {[round(p, 4) for p in res['psnr']]}")
        print(lines[-1], flush=True)
        return row

    def batch_check(tag, model, seq):
        # batch 1 and EVAL_BATCH through the one function: like-for-like MP/s
        for size in (1, EVAL_BATCH):
            res, counts = counted(lambda: evaluate_pairs_batched(
                batch_forward(model), images, 25.0, bucket=64, batch_size=size,
                device_metrics=True))
            smoke.path_counts[f"eval_b{size}_{tag}"] = counts
            batched.append(dict(variant=tag, batch=size, psnr_per_image=res["psnr"],
                                max_gap_db=gap(res["psnr"], seq), mp_per_s=res["mp_per_s"],
                                launches=counts))
            print(f"eval {tag} batch {size}: {res['mp_per_s']:.3f} MP/s, max gap to one "
                  f"image a call {batched[-1]['max_gap_db']:.5f} dB", flush=True)

    for name, cgs in EVAL_SNAPSHOTS:
        for cg in cgs:
            tag = variant_tag(name, cg, None)
            model = load_model(device=DEVICE, name=name, cg_iters=cg)
            res, smoke.path_counts[f"eval_{tag}"] = counted(lambda: protocol(model))
            record(tag, name, res, smoke.path_counts[f"eval_{tag}"])
            if name == "flagship" and cg == 3:
                batch_check(tag, model, res["psnr"])
            if name == "pixel":
                batch_check(tag, model, res["psnr"])
                mix = model.mixtureGLR_block03
                try:
                    mix.use_nhwc_unroll = False
                    chw, smoke.path_counts["eval_pixel_chw"] = counted(lambda: protocol(model))
                finally:
                    mix.use_nhwc_unroll = True
                record("pixel-chw", "pixel-chw", chw, smoke.path_counts["eval_pixel_chw"])
            del model
            torch.cuda.empty_cache()
        model = load_model(device=DEVICE, dtype=torch.float32, name=name)
        ker = protocol(model)
        rows.append(dict(variant=variant_tag(name, 3, None), dtype="float32", sigma=25.0,
                         psnr=ker["mean_psnr"], psnr_per_image=ker["psnr"]))
        print(f"eval {rows[-1]['variant']} (float32): mean {ker['mean_psnr']:.4f} dB", flush=True)
        if name == "flagship":
            set_kernels(model, False)
            plain = protocol(model)
            f32 = dict(variant="flagship-cg3", psnr_kernels=ker["psnr"], psnr_plain=plain["psnr"],
                       max_gap_db=gap(ker["psnr"], plain["psnr"]))
        del model
        torch.cuda.empty_cache()
    for label, family, fname, sigma, variants in EVAL_MORE:
        path = os.path.join(REPO, "artifacts", "weights", fname)
        for cg, fs in variants:
            tag = variant_tag(label, cg, fs)
            model = load_model(path, DEVICE, name=family, cg_iters=cg, filter_scales=fs)
            res, smoke.path_counts[f"eval_{tag}"] = counted(lambda: protocol(model, sigma))
            per = family if fs is None else f"{family}-fs{''.join(map(str, fs))}"
            record(tag, per, res, smoke.path_counts[f"eval_{tag}"], sigma=sigma)
            del model
            torch.cuda.empty_cache()
        model = load_model(path, DEVICE, torch.float32, name=family)
        ker = protocol(model, sigma)
        rows.append(dict(variant=variant_tag(label, 3, None), dtype="float32", sigma=sigma,
                         psnr=ker["mean_psnr"], psnr_per_image=ker["psnr"]))
        print(f"eval {rows[-1]['variant']} (float32, sigma {sigma:g}): mean "
              f"{ker['mean_psnr']:.4f} dB", flush=True)
        del model
        torch.cuda.empty_cache()
    smoke.lines["eval"] = {"eval": rows, "batched": batched, "f32_kernels_vs_plain": f32,
                           "images": "synthetic_val_set(): 6 at 384x512",
                           "sigma": "25 unless the row says",
                           "bucket": 64, "bar_db": EVAL_BAR_DB, "same_db": EVAL_SAME_DB}
    for r in rows:
        if r.get("target") is not None:
            require(abs(r["gap_db"]) <= EVAL_BAR_DB,
                    f"eval {r['variant']}: {r['psnr']:.4f} dB, target {r['target']}")
        if "want" in r:
            require(r["launches"] == r["want"], f"eval {r['variant']}: launches "
                    f"{r['launches']}, want {r['want']}")
    for b in batched:
        require(b["max_gap_db"] <= EVAL_SAME_DB, f"eval {b['variant']}: batch {b['batch']} "
                f"against one image a call, {b['max_gap_db']} dB")
    require(f32["max_gap_db"] <= EVAL_SAME_DB,
            f"eval flagship f32: kernels against plain, {f32['max_gap_db']} dB")


def variant_model(name, dtype):
    """The config's model through the registry, served as its family is
    (VARIANT_SERVE), weights from torch's default generator seeded with the
    config's index (the spectral u vectors are the port's own seeded draw)."""
    import torch

    from irdu_tpu_torch.models.registry import create_model

    kw = dict(VARIANT_MODELS[name])
    kind = kw.pop("type")
    torch.manual_seed(sorted(VARIANT_MODELS).index(name))
    model = create_model(kind, **kw, **VARIANT_SERVE.get(kind, {}))
    return model.to(device=DEVICE, dtype=dtype).eval().requires_grad_(False)


def kernels_on(model, on):
    """Every kernel switch of the model: set_kernels' and the pixel solver's
    two route flags (both off: the plain route)."""
    from irdu_tpu_torch.models.registry import set_kernels

    set_kernels(model, on)
    for m in model.modules():
        if hasattr(m, "use_nhwc_unroll"):
            m.use_nhwc_unroll = m.use_pallas_unroll = on


def phase_variants(smoke):
    """The three configurations with conv variants or the v4 pixel core
    (VARIANT_MODELS), seeded weights: each serves the 512x512 request in
    bf16, counts zeroed just before, the launches VARIANT_LAUNCHES, every
    kernel call held against its plain version (the pixel model on its CHW
    route as well, K2 and K7 checked the same way); once more with the kernels
    off; then in f32 with the kernels on and off, max|d| <= VARIANT_F32_ATOL
    and <= ABLATION_F32_BAR of max(1, max|ref|)."""
    import torch

    from irdu_tpu_torch.predict import denoise

    clean, noisy = request_images()[0]
    x = torch.from_numpy(noisy[None]).to(DEVICE)
    rows = []
    for name in VARIANT_MODELS:
        sites = pixel_sites() if "pixel" in name else flagship_sites()
        model = variant_model(name, torch.bfloat16)
        denoise(model, noisy)  # warm-up
        sync()
        (row,), smoke.path_counts[f"variant_{name}"] = serve(model, [(clean, noisy, REQUESTS[0])])
        row.update(config=name, **checked_request(model, noisy, VARIANT_LAUNCHES[name], sites))
        if "pixel" in name:  # the CHW route too: K2 and K7, the stencil the identity
            model.mixtureGLR_block03.use_nhwc_unroll = False
            row["chw"] = checked_request(model, noisy, PIXEL_CHW, sites)
        kernels_on(model, False)
        off = denoise(model, noisy)
        row["kernels_off_finite"] = bool(np.isfinite(off).all())
        del model
        model = variant_model(name, torch.float32)
        with torch.inference_mode():
            kernels_on(model, True)
            ker = model(x)
            kernels_on(model, False)
            ref = model(x)
        sync()
        row.update(f32_max_abs_err=max_abs(ker, ref), f32_max_ref=float(ref.abs().max()),
                   f32_finite=bool(torch.isfinite(ker).all()))
        rows.append(row)
        print(f"variants {name}: {row['ms']} ms, launches "
              f"{ {k: v for k, v in row['launches'].items() if v} }, f32 kernels vs plain "
              f"{row['f32_max_abs_err']:.3g}", flush=True)
        del model, ker, ref
        torch.cuda.empty_cache()
    rows.append(subnet_variant(smoke, clean, noisy, x))
    smoke.lines["variants"] = {"variants": rows, "weights": "random, seeded (variant_model)",
                               "f32_atol": VARIANT_F32_ATOL}
    for r in rows:
        want = VARIANT_LAUNCHES.get(r["config"], PER_REQUEST[REQUESTS[0]])
        require(r["launches"] == want, f"{r['config']}: launches {r['launches']}, want {want}")
        require(r["finite"] and r["kernels_off_finite"] and r["f32_finite"],
                f"{r['config']}: output not finite")
        for route, res in (("served", r), ("chw", r.get("chw", r))):
            require(res["calls_ok"], f"{r['config']} ({route}): a kernel call disagrees with "
                    f"its plain version, or the calls are not those launched "
                    f"(max|d| {res['max_abs_err']})")
        require(r["f32_max_abs_err"] <= min(VARIANT_F32_ATOL,
                                             ABLATION_F32_BAR * max(1.0, r["f32_max_ref"])),
                f"{r['config']}: f32 kernels vs plain max|d| {r['f32_max_abs_err']}")


def subnet_model(dtype):
    """SUBNET_MODEL through the registry, weights from torch's default
    generator seeded with SUBNET_SEED."""
    import torch

    from irdu_tpu_torch.models.registry import create_model

    kw = dict(SUBNET_MODEL)
    torch.manual_seed(SUBNET_SEED)
    model = create_model(kw.pop("type"), **kw)
    return model.to(device=DEVICE, dtype=dtype).eval().requires_grad_(False)


def subnet_variant(smoke, clean, noisy, x):
    """The flagship of 2 subnets a scale (SUBNET_MODEL, seeded) serves the
    512x512 request in bf16, counts zeroed just before: a 512x512 request's
    launches (3 K3, 32 K4, 4 K1, 8 K2); once more with every kernel call held
    against its plain version (K3, K4: block_bar) and recorded, the K3 and
    K4 calls replayed and timed (``replay_rows``, under the basis "512x512
    request, nsubnets 2"); served with the kernels off; then in f32 with the
    kernels on and off. The variants row of it."""
    import torch

    from irdu_tpu_torch.predict import denoise

    want = PER_REQUEST[REQUESTS[0]]
    model = subnet_model(torch.bfloat16)
    denoise(model, noisy)  # warm-up
    sync()
    (row,), smoke.path_counts["variant_nsubnets_2"] = serve(model, [(clean, noisy, REQUESTS[0])])
    with kernel_checks(flagship_sites()) as rec, recorded_calls(flagship_sites()) as calls:
        denoise(model, noisy)
    summary = checks_summary(rec, want)
    row.update(config="nsubnets_2222", nsubnets=SUBNET_MODEL["nsubnets"], **summary)
    timed = replay_rows(calls, summary, flagship_sites(),
                        f"{FRAME}x{FRAME} request, nsubnets 2", "cross4",
                        names=("fused_block_stack", "fused_gated_block"))
    del calls
    for name, rs in timed.items():
        smoke.kernel_rows.setdefault(name, []).extend(rs)
    row["rows"] = timed
    kernels_on(model, False)
    row["kernels_off_finite"] = bool(np.isfinite(denoise(model, noisy)).all())
    del model
    model = subnet_model(torch.float32)
    with torch.inference_mode():
        kernels_on(model, True)
        ker = model(x)
        kernels_on(model, False)
        ref = model(x)
    sync()
    row.update(f32_max_abs_err=max_abs(ker, ref), f32_max_ref=float(ref.abs().max()),
               f32_finite=bool(torch.isfinite(ker).all()))
    print(f"variants nsubnets 2: {row['ms']} ms, launches "
          f"{ {k: v for k, v in row['launches'].items() if v} }, f32 kernels vs plain "
          f"{row['f32_max_abs_err']:.3g}", flush=True)
    del model, ker, ref
    torch.cuda.empty_cache()
    return row


def phase_tile(smoke):
    """Tiled inference on the flagship (TILE-pixel tiles, TILE_HALO halo):
    in f32 at TILE_F32, the kernels against their plain versions within
    1e-3; in bf16 at TILE_BF16, the tiled request (counts zeroed just before,
    16 tiles' launches) and the whole-image request timed in turns
    (tiled, whole, whole, tiled) with both PSNRs and their gap (not gated:
    the halo's edge sees other context than the whole image does)."""
    import torch

    from irdu_tpu_torch.models.registry import set_kernels
    from irdu_tpu_torch.parallel.spatial import tiled_forward
    from irdu_tpu_torch.predict import batch_forward, denoise, load_model

    by_size = dict(zip(REQUESTS, request_images()))
    clean, noisy = by_size[TILE_F32]
    model = load_model(device=DEVICE, dtype=torch.float32)
    set_kernels(model, True)
    ker = tiled_forward(batch_forward(model), noisy, tile=TILE, halo=TILE_HALO)
    set_kernels(model, False)
    ref = tiled_forward(batch_forward(model), noisy, tile=TILE, halo=TILE_HALO)
    f32 = dict(shape=list(TILE_F32), max_abs_err=float(np.abs(ker - ref).max()),
               psnr_kernels=psnr(clean, ker), psnr_plain=psnr(clean, ref),
               finite=bool(np.isfinite(ker).all()))
    del model
    torch.cuda.empty_cache()

    model = smoke.model
    clean, noisy = by_size[TILE_BF16]
    denoise(model, noisy, tile=TILE)  # warm-up of the tile shapes
    sync()
    out, counts = counted(lambda: denoise(model, noisy, tile=TILE))
    smoke.path_counts["tile"] = counts
    n_tiles = int(np.prod([-(-n // TILE) for n in TILE_BF16]))
    times = {"tiled": [], "whole": []}
    for _ in range(TILE_ROUNDS):
        for kind in ("tiled", "whole", "whole", "tiled"):
            sync()
            t0 = time.perf_counter()
            res = denoise(model, noisy, tile=TILE if kind == "tiled" else 0)
            sync()
            times[kind].append(round((time.perf_counter() - t0) * 1e3, 3))
            if kind == "whole":
                whole = res
    row = dict(shape=list(TILE_BF16), tile=TILE, halo=TILE_HALO, tiles=n_tiles, launches=counts,
               want=times_launches(PER_REQUEST[(512, 512)], n_tiles),
               tiled_ms=times["tiled"], whole_ms=times["whole"],
               median_tiled_ms=float(np.median(times["tiled"])),
               median_whole_ms=float(np.median(times["whole"])),
               psnr_noisy=psnr(clean, noisy), psnr_tiled=psnr(clean, out),
               psnr_whole=psnr(clean, whole), finite=bool(np.isfinite(out).all()),
               order="tiled, whole, whole, tiled, x%d" % TILE_ROUNDS)
    row["psnr_gap_db"] = round(row["psnr_tiled"] - row["psnr_whole"], 3)
    smoke.lines["tile"] = {"tile": row, "f32": f32, "dtype": "bfloat16"}
    print(f"tile {TILE_BF16}: tiled {row['median_tiled_ms']} ms, {row['psnr_tiled']} dB; "
          f"whole {row['median_whole_ms']} ms, {row['psnr_whole']} dB", flush=True)
    require(f32["finite"] and f32["max_abs_err"] <= 1e-3,
            f"tile f32: kernels vs plain max|d| {f32['max_abs_err']}")
    require(row["launches"] == row["want"], f"tile: launches {row['launches']}, "
            f"want {row['want']}")
    require(row["finite"] and row["psnr_tiled"] > row["psnr_noisy"],
            f"tile: PSNR {row['psnr_noisy']} -> {row['psnr_tiled']}")


def phase_natural(smoke):
    """The natural-image set through ``eval.natural`` on the card in bf16:
    the noisy input's rows at sigma 25, 15 and 50 within NATURAL_NOISY_DB of
    the JAX script's (they cover the PNG reader, the masks, the noise, the
    pad and the rounding), then each snapshot of NATURAL_ROWS at its sigma,
    counts zeroed just before and read just after (4 times one image's
    launches, EVAL_PER_IMAGE): its mean within EVAL_BAR_DB of JAX's, the
    per-image gaps and the masked mean printed."""
    import torch

    from irdu_tpu_torch.eval import natural

    images, masks = natural.load_set()
    noisy, rows = [], []
    for sigma, (want, want_masked, source) in NATURAL_NOISY.items():
        r = natural.noisy_row(images, masks, sigma)
        noisy.append(dict(sigma=sigma, psnr=r["psnr"], masked_psnr=r["masked_psnr"],
                          target=want, masked_target=want_masked, source=source,
                          gap_db=r["psnr"] - want, masked_gap_db=r["masked_psnr"] - want_masked))
        print(f"natural noisy input, sigma {sigma:g}: {r['psnr']:.9f} dB (JAX {want:.9f}), "
              f"masked {r['masked_psnr']:.9f} (JAX {want_masked:.9f})", flush=True)
    for sigma, family, fname, target, per_image in NATURAL_ROWS:
        path = os.path.join(natural.WEIGHTS, fname)
        row, counts = counted(lambda: natural.snapshot_row(family, path, images, masks, sigma,
                                                           device=DEVICE))
        smoke.path_counts[f"natural_{fname[:-len('.npz')]}"] = counts
        rows.append(dict(row, sigma=sigma, target=target, gap_db=row["psnr"] - target,
                         per_image_target=list(per_image),
                         per_image_gap=[round(a - b, 3) for a, b in zip(row["per_image"],
                                                                        per_image)],
                         launches=counts,
                         want=times_launches(EVAL_PER_IMAGE[family], len(images))))
        print(f"natural {fname} (sigma {sigma:g}, bf16): mean {row['psnr']:.4f} dB, JAX "
              f"{target}, gap {rows[-1]['gap_db']:+.4f}; masked {row['masked_psnr']:.4f}; "
              f"per-image gaps {rows[-1]['per_image_gap']}", flush=True)
        torch.cuda.empty_cache()
    smoke.lines["natural"] = {"noisy": noisy, "rows": rows, "bar_db": EVAL_BAR_DB,
                              "noisy_bar_db": NATURAL_NOISY_DB, "bucket": natural.BUCKET,
                              "images": [list(im.shape) for im in images]}
    for r in noisy:
        require(abs(r["gap_db"]) <= NATURAL_NOISY_DB and abs(r["masked_gap_db"])
                <= NATURAL_NOISY_DB, f"natural noisy input at sigma {r['sigma']}: {r}")
    for r in rows:
        require(abs(r["gap_db"]) <= EVAL_BAR_DB,
                f"natural {r['snapshot']}: {r['psnr']:.4f} dB, JAX {r['target']}")
        require(r["launches"] == r["want"],
                f"natural {r['snapshot']}: launches {r['launches']}, want {r['want']}")


def boosting_sites():
    """Where models/glr_boosting.py looks K2 up."""
    from irdu_tpu_torch.models import glr_boosting
    from irdu_tpu_torch.ops.edge_weights import edge_weights_plain

    return ((glr_boosting, "edge_weights_chw", edge_weights_plain, k2_bar),)


def phase_baselines(smoke):
    """GLR boosting and the baselines on the card. Each snapshot model of
    BASELINE_ROWS, loaded by predict.load_model in bf16: the eval protocol
    on the synthetic val set (gated within EVAL_BAR_DB of JAX's number where
    JAX has one; boosting's printed with none) and the natural set at sigma
    25 through eval.natural (within EVAL_BAR_DB of JAX's mean, per-image gaps
    printed), counts zeroed just before each and read just after: boosting 4
    K2 (ring-8) an image and nothing else, the baselines no launch at all;
    boosting's natural run once more with every K2 call held against its
    plain version (k2_bar); each model's FRAME² request timed (the median of
    eval.curve.request_ms, data). Then the zoo's seeded models
    (BASELINE_SEEDED, default widths, seed k): one BASELINE_SIDE² request,
    f32 on the card against the same weights on the CPU within
    BASELINE_F32_BAR of max(1, max|ref|), then bf16 on the card, finite."""
    import torch

    from irdu_tpu_torch.data.synthetic import synthetic_val_set
    from irdu_tpu_torch.eval import natural
    from irdu_tpu_torch.eval.curve import request_ms
    from irdu_tpu_torch.eval.harness import evaluate_pairs
    from irdu_tpu_torch.models.registry import create_model
    from irdu_tpu_torch.predict import batch_forward, load_model

    val = synthetic_val_set()
    images, masks = natural.load_set()
    rows, seeded = [], []
    for family, fname, protocol, target, per_image in BASELINE_ROWS:
        path = os.path.join(natural.WEIGHTS, fname)
        model = load_model(path, DEVICE, name=family)
        want = BASELINE_PER_IMAGE.get(family, launches(0, 0, 0, 0, 0))
        res, counts = counted(lambda: evaluate_pairs(batch_forward(model), val, 25.0, bucket=64))
        smoke.path_counts[f"baselines_{family}_eval"] = counts
        nat, nat_counts = counted(lambda: natural.snapshot_row(family, path, images, masks, 25.0,
                                                               device=DEVICE))
        smoke.path_counts[f"baselines_{family}_natural"] = nat_counts
        row = dict(family=family, snapshot=fname, dtype="bfloat16",
                   psnr=res["mean_psnr"], psnr_per_image=res["psnr"],
                   target=protocol and protocol[0], target_source=protocol and protocol[1],
                   gap_db=protocol and res["mean_psnr"] - protocol[0], launches=counts,
                   want=times_launches(want, len(val)),
                   natural=nat["psnr"], natural_masked=nat["masked_psnr"],
                   natural_target=target, natural_gap_db=nat["psnr"] - target,
                   natural_per_image_gap=[round(a - b, 3) for a, b in zip(nat["per_image"],
                                                                          per_image)],
                   natural_launches=nat_counts,
                   natural_want=times_launches(want, len(images)))
        if family == "boosting":
            with kernel_checks(boosting_sites()) as rec:
                natural.snapshot_row(family, path, images, masks, 25.0, device=DEVICE)
            row["natural_checked"] = checks_summary(
                rec, {"edge_weights_chw": want["edge_weights_chw"] * len(images)})
        ms = request_ms(model)
        row.update(request_ms=ms, median_request_ms=float(np.median(ms)),
                   request=f"{FRAME}x{FRAME} predict.denoise")
        rows.append(row)
        print(f"baselines {family} (bf16): protocol {row['psnr']:.4f} dB, target "
              f"{row['target'] if protocol else 'none'}"
              + ("" if not protocol else f", gap {row['gap_db']:+.4f}")
              + f"; natural {nat['psnr']:.4f} dB, JAX {target}, gap {row['natural_gap_db']:+.4f}, "
              f"per-image gaps {row['natural_per_image_gap']}; {FRAME}x{FRAME} request "
              f"{row['median_request_ms']:.3f} ms", flush=True)
        del model
        torch.cuda.empty_cache()
    for k, (name, c_in) in enumerate(BASELINE_SEEDED.items()):
        torch.manual_seed(k)
        model = create_model(name).eval().requires_grad_(False)
        x = torch.from_numpy(np.random.RandomState(k).rand(
            1, BASELINE_SIDE, BASELINE_SIDE, c_in).astype(np.float32))
        with torch.inference_mode():
            ref = model(x)
        model.to(DEVICE)
        with torch.inference_mode():
            out, counts = counted(lambda: model(x.to(DEVICE)).cpu())
        model.to(torch.bfloat16)
        with torch.inference_mode():
            half = model(x.to(DEVICE, torch.bfloat16)).float().cpu()
        smoke.path_counts[f"baselines_{name}"] = counts
        big = max(1.0, float(ref.abs().max()))
        seeded.append(dict(model=name, shape=list(x.shape), max_abs_err=max_abs(out, ref),
                           max_ref=float(ref.abs().max()), bar=BASELINE_F32_BAR * big,
                           bf16_finite=bool(torch.isfinite(half).all()),
                           bf16_max_abs_vs_f32=max_abs(half, ref), launches=counts))
        print(f"baselines {name} (seeded, {BASELINE_SIDE}x{BASELINE_SIDE}): f32 card vs CPU "
              f"max|d| {seeded[-1]['max_abs_err']:.3e} (bar {seeded[-1]['bar']:.1e}); bf16 "
              f"finite {seeded[-1]['bf16_finite']}", flush=True)
        del model
        torch.cuda.empty_cache()
    smoke.lines["baselines"] = {"snapshots": rows, "seeded": seeded, "bar_db": EVAL_BAR_DB,
                                "f32_bar": BASELINE_F32_BAR, "sigma": 25.0}
    for r in rows:
        if r["target"] is not None:
            require(abs(r["gap_db"]) <= EVAL_BAR_DB,
                    f"baselines {r['family']}: protocol {r['psnr']:.4f} dB, JAX {r['target']}")
        require(abs(r["natural_gap_db"]) <= EVAL_BAR_DB,
                f"baselines {r['family']}: natural {r['natural']:.4f} dB, "
                f"JAX {r['natural_target']}")
        require(r["launches"] == r["want"] and r["natural_launches"] == r["natural_want"],
                f"baselines {r['family']}: launches {r['launches']} / {r['natural_launches']}, "
                f"want {r['want']} / {r['natural_want']}")
        if "natural_checked" in r:
            require(r["natural_checked"]["calls_ok"], f"baselines {r['family']}: a K2 call "
                    f"disagrees with its plain version: {r['natural_checked']}")
    for r in seeded:
        require(r["max_abs_err"] <= r["bar"] and r["bf16_finite"]
                and not any(r["launches"].values()), f"baselines {r['model']}: {r}")


def phase_deploy(smoke):
    """The serving export on the card (``irdu_tpu_torch.deploy``): each
    DEPLOY_ROWS model exported by ``export_forward`` into a file under the
    git-ignored experiments/, loaded by a fresh ``load_exported`` and run
    through the protocol on the synthetic val set (sigma 25, bucket 64),
    counts zeroed just before and read just after; the same model run
    eagerly (the int8 one with the same dequantized weights) through the
    protocol too. Gates: the artifact's mean within EVAL_BAR_DB of JAX's
    number, every image within EVAL_SAME_DB of the eager run, the artifact's
    launches those of the eager run and 6 times one image's
    (EVAL_PER_IMAGE); the int8 artifact carries DEPLOY_INT8_KERNELS int8
    tensors and is smaller than the bf16 one. Printed: max|d| of the outputs
    on one image, the bytes, the export and load seconds, and the request
    ms eager against the artifact in turns."""
    import copy
    import shutil

    import torch

    from irdu_tpu_torch import deploy
    from irdu_tpu_torch.data.synthetic import synthetic_val_set
    from irdu_tpu_torch.eval.harness import evaluate_pairs
    from irdu_tpu_torch.predict import batch_forward, load_model

    work = os.path.join(REPO, "experiments", "chip_smoke_deploy")  # git-ignored, removed after
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    images = synthetic_val_set()
    rows = []
    for tag, family, fname, int8, shape, target, source in DEPLOY_ROWS:
        weights = os.path.join(REPO, "artifacts", "weights", fname)
        model = load_model(weights, DEVICE, torch.float32 if int8 else torch.bfloat16,
                           name=family)
        path = os.path.join(work, f"{tag}.pt2")
        t0 = time.perf_counter()
        deploy.export_forward(model, *shape[:3], dtype=torch.bfloat16, path=path,
                              pointwise_int8=int8, info=dict(model=family, weights=fname))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run = deploy.load_exported(path)
        load_s = time.perf_counter() - t0
        if int8:  # the same dequantized weights, eagerly
            model = copy.deepcopy(model)
            deploy.quantize_pointwise(model, torch.bfloat16)

        def artifact(batch):
            return run(torch.from_numpy(np.ascontiguousarray(batch, np.float32))).float()

        art, art_counts = counted(lambda: evaluate_pairs(artifact, images, 25.0, bucket=64))
        eager, eager_counts = counted(lambda: evaluate_pairs(batch_forward(model), images, 25.0,
                                                             bucket=64))
        smoke.path_counts[f"deploy_{tag}"] = art_counts
        x = torch.from_numpy((images[0][None] / 255.0).astype(np.float32)).to(DEVICE)
        with torch.inference_mode():
            diff = (run(x).float() - model(x.to(torch.bfloat16)).float()).abs().max().item()
        x = x.to(torch.bfloat16)
        ms = {"eager": [], "artifact": []}
        for _ in range(DEPLOY_ROUNDS):
            for kind in ("eager", "artifact", "artifact", "eager"):
                fn = run if kind == "artifact" else model
                for _ in range(DEPLOY_REQUESTS):
                    sync()
                    t0 = time.perf_counter()
                    with torch.inference_mode():
                        fn(x)
                    sync()
                    ms[kind].append((time.perf_counter() - t0) * 1e3)
        rows.append(dict(
            tag=tag, weights=fname, int8=int8, input=list(shape), psnr=art["mean_psnr"],
            psnr_eager=eager["mean_psnr"], target=target, target_source=source,
            gap_db=art["mean_psnr"] - target,
            max_gap_eager_db=max(abs(a - b) for a, b in zip(art["psnr"], eager["psnr"])),
            max_abs_diff_eager=diff, bytes=os.path.getsize(path),
            int8_tensors=run.meta["int8_tensors"], kernel_ops=run.meta["kernel_ops"],
            export_s=round(export_s, 3), load_s=round(load_s, 3),
            request_ms_eager=round(float(np.median(ms["eager"])), 3),
            request_ms_artifact=round(float(np.median(ms["artifact"])), 3),
            request_ms_order=f"eager, artifact, artifact, eager, x{DEPLOY_ROUNDS}, "
                             f"{DEPLOY_REQUESTS} requests a turn",
            launches=art_counts, launches_eager=eager_counts,
            want=times_launches(EVAL_PER_IMAGE[family], len(images))))
        r = rows[-1]
        print(f"deploy {tag}: {r['bytes']} bytes, {r['int8_tensors']} int8 tensors, export "
              f"{r['export_s']} s, load {r['load_s']} s; protocol {r['psnr']:.4f} dB (JAX "
              f"{target}, gap {r['gap_db']:+.4f}; eager {r['psnr_eager']:.4f}, max gap "
              f"{r['max_gap_eager_db']:.5f}); max|d| to eager {diff:.4g}; request ms eager "
              f"{r['request_ms_eager']} artifact {r['request_ms_artifact']}", flush=True)
        del model, run
        torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    smoke.lines["deploy"] = {"rows": rows, "is_exporting": hasattr(torch.compiler, "is_exporting"),
                             "bar_db": EVAL_BAR_DB, "same_db": EVAL_SAME_DB}
    for r in rows:
        require(abs(r["gap_db"]) <= EVAL_BAR_DB,
                f"deploy {r['tag']}: {r['psnr']:.4f} dB, JAX {r['target']}")
        require(r["max_gap_eager_db"] <= EVAL_SAME_DB,
                f"deploy {r['tag']}: artifact against eager {r['max_gap_eager_db']} dB")
        require(r["launches"] == r["launches_eager"] == r["want"],
                f"deploy {r['tag']}: launches {r['launches']}, eager {r['launches_eager']}, "
                f"want {r['want']}")
    by_tag = {r["tag"]: r for r in rows}
    int8, bf16 = by_tag["flagship50k-int8"], by_tag["flagship50k-bf16"]
    require(int8["int8_tensors"] == DEPLOY_INT8_KERNELS,
            f"deploy: {int8['int8_tensors']} int8 tensors, JAX {DEPLOY_INT8_KERNELS}")
    require(int8["bytes"] < bf16["bytes"],
            f"deploy: int8 artifact {int8['bytes']} bytes, bf16 {bf16['bytes']}")


def train_config(name, corpus, **train):
    """The trainer's configuration of ``name``: its sections (TRAIN_CONFIGS)
    cut to stage 0 with TRAIN_PATCHES crop positions, the corpus (csv_path,
    root_folder), ``train``'s keys over its train section, the config's own
    teacher snapshot (its path taken from the repo's root)
    and the synthetic val set as its eval set."""
    import copy

    src = copy.deepcopy(TRAIN_CONFIGS[name])
    tc = src["train"]
    tc["stages"] = [dict(tc["stages"][0], max_num_patchs=TRAIN_PATCHES)]
    tc.update(train)
    if "distill" in tc:
        tc["distill"]["weights"] = os.path.join(REPO, tc["distill"]["weights"])
    return {"name": name, "manual_seed": src["manual_seed"], "model": src["model"],
            "parallel": src["parallel"],
            "datasets": {"train": dict(src["datasets_train"], **corpus)}, "train": tc,
            "eval": {"sigma": 25.0, "datasets": {"synthetic_val": {}}}}


def train_corpus(root):
    """The 24 synthetic train images (``synthetic_train_set``), listed in a CSV
    written with ``csv`` under ``root``, and the images by the CSV's paths:
    (the config's dataset paths, {path: image})."""
    import csv

    from irdu_tpu_torch.data.synthetic import synthetic_train_set

    images = {f"t{i:03d}.png": im for i, im in enumerate(synthetic_train_set())}
    os.makedirs(root, exist_ok=True)
    csv_path = os.path.join(root, "train.csv")
    with open(csv_path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["index", "path", "height", "width", "nchannels"])
        for i, (path, im) in enumerate(images.items()):
            w.writerow([i, path, im.shape[0], im.shape[1], im.shape[2]])
    return {"csv_path": csv_path, "root_folder": root}, images


def launch_counts():
    return {n: k.launches for n, k in wrappers().items()}


def counts_since(before):
    return {n: c - before[n] for n, c in launch_counts().items()}


def smoke_trainer(conf, workdir, images, record, check_first=False):
    """A ``Trainer`` that takes the corpus as arrays and the synthetic val set
    as its eval set, and records each step: its ms (synchronized), loss,
    launches, host copy of the batch, and how many parameter tensors got a
    non-zero gradient (all finite?). ``check_first``: the first step's
    kernel calls held against their plain versions (``kernel_checks``)."""
    from irdu_tpu_torch.data.synthetic import synthetic_val_set
    from irdu_tpu_torch.train.trainer import Trainer

    class SmokeTrainer(Trainer):
        def _stage_dataset(self, stage, epoch):
            return super()._stage_dataset(stage, epoch, images=images)

        def _eval_images(self, spec):
            return synthetic_val_set()

        def _train_step_for(self, remat):
            step = super()._train_step_for(remat)

            def recorded(state, noisy, clean, gen):
                sync()
                before = launch_counts()
                t0 = time.perf_counter()
                if check_first and not record:
                    with kernel_checks(flagship_sites()) as rec:
                        state, m = step(state, noisy, clean, gen)
                    checks = checks_summary(rec, PER_REQUEST[(512, 512)])
                else:
                    state, m = step(state, noisy, clean, gen)
                    checks = None
                sync()
                ms = (time.perf_counter() - t0) * 1e3
                grads = [p.grad for p in state.model.parameters()]
                record.append(dict(step=state.step, ms=ms, loss=float(m["loss"]),
                                   psnr=float(m["psnr"]), launches=counts_since(before),
                                   checks=checks, batch=(noisy.cpu(), clean.cpu()),
                                   grads_nonzero=sum(g is not None and bool(g.ne(0).any())
                                                     for g in grads),
                                   grads_finite=all(g is None or bool(g.isfinite().all())
                                                    for g in grads)))
                return state, m

            return recorded

    return SmokeTrainer(conf, workdir=workdir, device=DEVICE)


def step_times(record, batch):
    """Median ms of the recorded steps after each run's first, and images/s."""
    ms = float(np.median([r["ms"] for r in record[1:]] or [record[0]["ms"]]))
    return dict(step_ms=[round(r["ms"], 3) for r in record], median_step_ms=round(ms, 3),
                images_per_s=round(batch / ms * 1e3, 3))


def no_launches(counts):
    return not any(counts.values())


def same_tensors(a, b):
    """Host tensors, pairwise bitwise equal."""
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def adam_moments(optimizer):
    return [t.detach().cpu().clone() for st in optimizer.state.values()
            for k in ("exp_avg", "exp_avg_sq") for t in (st[k],)]


def grad_gaps(grads, ref):
    """Per tensor max|d| over max(1e-6, max|ref|): the worst and its name."""
    worst, name = 0.0, None
    for n, g in ref.items():
        gap = float((grads[n].cpu() - g).abs().max()) / max(1e-6, float(g.abs().max()))
        if gap > worst:
            worst, name = gap, n
    return worst, name


def loss_and_grads(model, noisy, clean, noise, extra=None):
    from irdu_tpu_torch.train.steps import flagship_loss

    model.zero_grad(set_to_none=True)
    loss, den = flagship_loss(model, noisy, clean, latent_noise=noise)
    if extra is not None:
        loss = loss + extra(den)
    loss.backward()
    return float(loss), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def code_noise(batch, dims, side, device, seed=0):
    """Standard normal latent draws for the codes of a batch of side² images."""
    import torch

    rs = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rs.randn(batch, d, side >> s, side >> s).astype(np.float32))
                 .to(device) for s, d in enumerate(dims))


def phase_train(smoke):
    """The trainer on the card (``irdu_tpu_torch.train``), each config cut to
    stage 0 (``train_config``) on the synthetic train set:

      1. flagship_sigma25 at full width, f32, 128² batch 4: ``Trainer.run``
         to step 2 (TRAIN_STEPS; a checkpoint; the eval protocol on the
         synthetic val set at step 2, on the kernels: 6 images' launches),
         then a fresh ``Trainer`` on the same workdir resumes and runs to
         step 4. The restored params and Adam moments equal the saved ones
         bitwise, the batches of steps 3-4 equal a straight run's (its
         loader's batches 2-3) bitwise, every loss is finite, every parameter tensor gets a
         finite non-zero gradient in every step (the tensors that moved are
         counted, not gated) and no kernel launched in a step; the step's ms
         and images/s printed;
      2. one ``flagship_loss`` and its backward on TRAIN_GRAD_BATCH images
         of step 1's batch (their TRAIN_GRAD_SIDE² top-left crops) with the
         latent noise passed in, on the
         card and on the CPU (TF32 off):
         loss within TRAIN_LOSS_RTOL, each gradient tensor within
         TRAIN_GRAD_RTOL of its max;
      3. micro_distill_sigma25 (micro student, remat on; the config's
         flagship teacher, flagship_synthetic_2050.npz, in bf16 on the kernels),
         TRAIN_STEPS["distill"] steps: each teacher forward
         launches one 128² request's K3, K4, K1 and K2 (PER_REQUEST at
         512²'s counts) and the student nothing; every teacher kernel call of
         the first step is held against its plain version; the teacher's
         params are bitwise unchanged; one step's gradients with remat on and
         off within TRAIN_GRAD_RTOL; then TRAIN_STEPS["fixed_batch"] steps on
         one batch end below the first step's loss;
      4. lightformer_pixel_sigma at full width, 64² batch 16, 3 steps (its
         aux losses off): finite losses, no launch;
      5. the trained student written by ``save_params_npz`` (bf16) and
         loaded by ``predict.load_model(name="micro")``: the eval protocol in
         bf16, 6 images' micro launches (EVAL_PER_IMAGE), its PSNR printed
         (no target); in f32 its kernels against their plain versions, per
         image within EVAL_SAME_DB;
      6. the guard: a flagship forward on the card with the kernels on and
         parameters requiring grad raises its RuntimeError."""
    import copy
    import shutil

    import torch

    from irdu_tpu_torch.data.loader import batched_loader
    from irdu_tpu_torch.data.synthetic import synthetic_val_set
    from irdu_tpu_torch.eval.harness import evaluate_pairs
    from irdu_tpu_torch.models.registry import create_model, set_kernels, set_remat
    from irdu_tpu_torch.predict import batch_forward, load_model
    from irdu_tpu_torch.train.steps import teacher_forward
    from irdu_tpu_torch.utils.weights import params_from_torch, save_params_npz

    work = os.path.join(REPO, "experiments", "chip_smoke_train")  # git-ignored, removed after
    shutil.rmtree(work, ignore_errors=True)
    corpus, images = train_corpus(os.path.join(work, "corpus"))
    teacher_npz = TRAIN_CONFIGS["micro_distill_sigma25"]["train"]["distill"]["weights"]
    line, fails = {"teacher_weights": teacher_npz, "max_num_patchs": TRAIN_PATCHES,
                   "stage": 0}, []
    print(f"train: the distillation teacher is the config's {teacher_npz}; stage 0 with "
          f"{TRAIN_PATCHES} crop positions", flush=True)

    def check(cond, what):
        if not cond:
            fails.append(what)

    # 1. flagship: run, checkpoint, resume
    first, then = TRAIN_STEPS["flagship"]
    wd = os.path.join(work, "flagship")
    rec_a, rec_b = [], []
    conf = train_config("flagship_sigma25", corpus, max_steps=first, checkpoint_rate=first,
                        eval_rate=first, verbose_rate=1)
    tr = smoke_trainer(conf, wd, images, rec_a)
    initial = [p.detach().cpu().clone() for p in tr.model.parameters()]
    eval_before = launch_counts()
    tr.run()
    sync()
    eval_launches = {n: c - sum(r["launches"][n] for r in rec_a)
                     for n, c in counts_since(eval_before).items()}
    saved = [p.detach().cpu().clone() for p in tr.model.parameters()]
    saved_moments = adam_moments(tr.state.optimizer)
    del tr
    conf = train_config("flagship_sigma25", corpus, max_steps=then, checkpoint_rate=first,
                        eval_rate=0, verbose_rate=1)
    tr = smoke_trainer(conf, wd, images, rec_b)
    restored_ok = (tr.state.step == first and same_tensors(
        saved, [p.detach().cpu() for p in tr.model.parameters()])
        and same_tensors(saved_moments, adam_moments(tr.state.optimizer)))
    tr.run()
    sync()
    final = [p.detach().cpu() for p in tr.model.parameters()]
    ds = tr._stage_dataset(conf["train"]["stages"][0], 0)
    straight = [b for _, b in zip(range(then), batched_loader(ds, 4))][first:]
    batches_ok = len(rec_b) == then - first and all(
        same_tensors(r["batch"], (torch.from_numpy(n), torch.from_numpy(c)))
        for r, (n, c) in zip(rec_b, straight))
    recs = rec_a + rec_b
    # every tensor must get a non-zero gradient in every step (a graph cut
    # would leave some at zero); whether a tensor moves is reported: the
    # solvers' log-parameters start at log(1e-4), where their gradients
    # (~1e-12) give Adam updates of ~lr·1e-4, below an f32 ulp of the value
    moved = sum(not torch.equal(a, b) for a, b in zip(initial, final))
    line["flagship"] = dict(
        steps=[r["step"] for r in recs], loss=[r["loss"] for r in recs],
        psnr=[r["psnr"] for r in recs], restored_bitwise=restored_ok,
        resumed_batches_bitwise=batches_ok, params_moved=f"{moved}/{len(final)}",
        grads_nonzero=[r["grads_nonzero"] for r in recs],
        step_launches=sum(sum(r["launches"].values()) for r in recs),
        eval_launches=eval_launches,
        eval_want=times_launches(EVAL_PER_IMAGE["flagship"], 6), **step_times(recs, 4))
    smoke.path_counts["train_eval_flagship_f32"] = eval_launches
    smoke.path_counts["train_steps_flagship"] = {n: sum(r["launches"][n] for r in recs)
                                                 for n in KERNEL_NAMES}
    print(f"train flagship: {line['flagship']['median_step_ms']} ms a step "
          f"({line['flagship']['images_per_s']} images/s, 128x128 batch 4, f32), losses "
          f"{[round(x, 5) for x in line['flagship']['loss']]}", flush=True)
    check(restored_ok, "flagship: the restored params or Adam moments differ from the saved")
    check(batches_ok, "flagship: the batches after the resume differ from a straight run's")
    check(all(np.isfinite(r["loss"]) for r in recs), "flagship: a loss is not finite")
    check(all(r["grads_nonzero"] == len(final) and r["grads_finite"] for r in recs),
          f"flagship: parameter tensors with a zero or non-finite gradient: "
          f"{[len(final) - r['grads_nonzero'] for r in recs]}")
    check(all(no_launches(r["launches"]) for r in recs), "flagship: a kernel launched in a step")
    check(eval_launches == line["flagship"]["eval_want"],
          f"flagship: eval launches {eval_launches}")
    batch = rec_a[0]["batch"]
    del tr, initial, saved, saved_moments, final
    torch.cuda.empty_cache()

    # 2. the card's gradient against the CPU's
    torch.manual_seed(0)
    mc = dict(TRAIN_CONFIGS["flagship_sigma25"]["model"])
    model = create_model(mc.pop("type"), **mc)
    set_kernels(model, False)
    cpu_model = copy.deepcopy(model)
    model.to(DEVICE)
    noise = code_noise(TRAIN_GRAD_BATCH, mc["dims"], TRAIN_GRAD_SIDE, "cpu")
    batch = tuple(t[:TRAIN_GRAD_BATCH, :TRAIN_GRAD_SIDE, :TRAIN_GRAD_SIDE].contiguous()
                  for t in batch)
    loss_gpu, g_gpu = loss_and_grads(model, batch[0].to(DEVICE), batch[1].to(DEVICE),
                                     tuple(n.to(DEVICE) for n in noise))
    t0 = time.perf_counter()
    loss_cpu, g_cpu = loss_and_grads(cpu_model, batch[0], batch[1], noise)
    cpu_s = time.perf_counter() - t0
    gap, where = grad_gaps(g_gpu, g_cpu)
    line["grad_vs_cpu"] = dict(loss_card=loss_gpu, loss_cpu=loss_cpu,
                               loss_rel=abs(loss_gpu - loss_cpu) / abs(loss_cpu),
                               worst_grad_gap=gap, worst_tensor=where, tensors=len(g_cpu),
                               cpu_s=round(cpu_s, 3), tf32=torch.backends.cudnn.allow_tf32)
    print(f"train grad: loss card {loss_gpu:.7f} cpu {loss_cpu:.7f}; worst gradient gap "
          f"{gap:.3g} of max ({where})", flush=True)
    check(line["grad_vs_cpu"]["loss_rel"] <= TRAIN_LOSS_RTOL, "grad: loss card vs CPU")
    check(gap <= TRAIN_GRAD_RTOL, f"grad: {where} card vs CPU {gap}")
    del cpu_model, g_cpu, g_gpu

    # 6. the guard (this model's parameters require grad)
    set_kernels(model, True)
    before = launch_counts()
    try:
        model(torch.rand(1, 64, 64, 3, device=DEVICE))
        guard = "no error"
    except RuntimeError as exc:
        guard = str(exc)
    line["guard"] = dict(message=guard, launches=sum(counts_since(before).values()))
    check("set_kernels(model, False)" in guard and not line["guard"]["launches"],
          f"guard: {guard}")
    del model
    torch.cuda.empty_cache()

    # 3. distillation
    rec_d, tcounts = [], []
    conf = train_config("micro_distill_sigma25", corpus, max_steps=TRAIN_STEPS["distill"],
                        checkpoint_rate=0, eval_rate=0, verbose_rate=1)
    tr = smoke_trainer(conf, os.path.join(work, "distill"), images, rec_d, check_first=True)
    teacher = tr.teacher
    teacher_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    forward = teacher.forward

    def counted_forward(x):
        b = launch_counts()
        out = forward(x)
        tcounts.append(counts_since(b))
        return out

    teacher.forward = counted_forward
    tr.run()
    sync()
    teacher.forward = forward
    want = PER_REQUEST[(512, 512)]
    student = [{n: r["launches"][n] - t[n] for n in KERNEL_NAMES} for r, t in zip(rec_d, tcounts)]
    teacher_same = all(torch.equal(v, teacher.state_dict()[k]) for k, v in teacher_before.items())
    student_model = tr.model
    noisy, clean = (t.to(DEVICE) for t in rec_d[0]["batch"])
    t_out = teacher_forward(teacher, noisy)
    distill_term = lambda den: torch.mean(torch.abs(den - t_out))  # noqa: E731
    noise = code_noise(4, TRAIN_CONFIGS["micro_distill_sigma25"]["model"]["dims"], 128, DEVICE)
    set_remat(student_model, True)
    _, g_on = loss_and_grads(student_model, noisy, clean, noise, distill_term)
    set_remat(student_model, False)
    _, g_off = loss_and_grads(student_model, noisy, clean, noise, distill_term)
    set_remat(student_model, True)
    remat_gap, remat_where = grad_gaps(g_on, {n: g.cpu() for n, g in g_off.items()})
    fixed = []
    for _ in range(TRAIN_STEPS["fixed_batch"]):
        _, m = tr.train_step(tr.state, noisy, clean, None, latent_noise=noise)
        fixed.append(float(m["loss"]))
    line["distill"] = dict(
        steps=[r["step"] for r in rec_d], loss=[r["loss"] for r in rec_d],
        teacher_launches=tcounts, student_launches=student, teacher_want=want,
        first_step_checks={k: v for k, v in rec_d[0]["checks"].items()},
        teacher_params_bitwise_unchanged=teacher_same, remat_grad_gap=remat_gap,
        remat_worst_tensor=remat_where, fixed_batch_loss=[fixed[0], fixed[-1]],
        **step_times(rec_d, 4))
    smoke.path_counts["train_teacher"] = {n: sum(t[n] for t in tcounts) for n in KERNEL_NAMES}
    print(f"train distill: {line['distill']['median_step_ms']} ms a step "
          f"({line['distill']['images_per_s']} images/s); teacher calls checked "
          f"{rec_d[0]['checks']['calls_checked']}; remat gap {remat_gap:.3g}; fixed batch "
          f"{fixed[0]:.5f} -> {fixed[-1]:.5f}", flush=True)
    check(len(tcounts) == len(rec_d) and all(t == want for t in tcounts),
          f"distill: teacher launches {tcounts}")
    check(all(no_launches(s) for s in student), f"distill: student launches {student}")
    check(rec_d[0]["checks"]["calls_ok"], "distill: a teacher kernel call disagrees with its "
          f"plain version ({rec_d[0]['checks']['max_abs_err']})")
    check(teacher_same, "distill: the teacher's params changed")
    check(remat_gap <= TRAIN_GRAD_RTOL, f"distill: remat on vs off {remat_where} {remat_gap}")
    check(all(np.isfinite(r["loss"]) for r in rec_d), "distill: a loss is not finite")
    check(fixed[-1] < fixed[0], f"distill: fixed batch loss {fixed[0]} -> {fixed[-1]}")

    # 5. serving the trained student
    path = os.path.join(work, "micro_trained.npz")
    save_params_npz(path, params_from_torch(student_model), dtype=torch.bfloat16)
    del tr, teacher, student_model, g_on, g_off
    torch.cuda.empty_cache()
    val = synthetic_val_set()
    served = load_model(weights=path, device=DEVICE, name="micro")
    res, counts = counted(lambda: evaluate_pairs(batch_forward(served), val, 25.0, bucket=64))
    smoke.path_counts["train_eval_micro_trained"] = counts
    f32 = load_model(weights=path, device=DEVICE, dtype=torch.float32, name="micro")
    ker = evaluate_pairs(batch_forward(f32), val, 25.0, bucket=64)
    set_kernels(f32, False)
    plain = evaluate_pairs(batch_forward(f32), val, 25.0, bucket=64)
    f32_gap = max(abs(a - b) for a, b in zip(ker["psnr"], plain["psnr"]))
    line["served_student"] = dict(psnr_bf16=res["mean_psnr"], psnr_per_image=res["psnr"],
                                  launches=counts,
                                  want=times_launches(EVAL_PER_IMAGE["micro"], len(val)),
                                  f32_kernels_vs_plain_max_gap_db=f32_gap,
                                  snapshot_bytes=os.path.getsize(path))
    print(f"train served student (micro, bf16): {res['mean_psnr']:.4f} dB on the synthetic val "
          f"set (no target); f32 kernels vs plain {f32_gap:.5f} dB", flush=True)
    check(counts == line["served_student"]["want"], f"served student: launches {counts}")
    check(f32_gap <= EVAL_SAME_DB, f"served student: f32 kernels vs plain {f32_gap} dB")
    del served, f32
    torch.cuda.empty_cache()

    # 4. pixel
    rec_p = []
    conf = train_config("lightformer_pixel_sigma", corpus, max_steps=TRAIN_STEPS["pixel"],
                        checkpoint_rate=0, eval_rate=0, verbose_rate=1)
    tr = smoke_trainer(conf, os.path.join(work, "pixel"), images, rec_p)
    tr.run()
    sync()
    line["pixel"] = dict(steps=[r["step"] for r in rec_p], loss=[r["loss"] for r in rec_p],
                         step_launches=sum(sum(r["launches"].values()) for r in rec_p),
                         **step_times(rec_p, 16))
    smoke.path_counts["train_steps_student"] = {
        n: smoke.path_counts["train_steps_flagship"][n] + sum(s[n] for s in student)
        + sum(r["launches"][n] for r in rec_p) for n in KERNEL_NAMES}
    print(f"train pixel: {line['pixel']['median_step_ms']} ms a step "
          f"({line['pixel']['images_per_s']} images/s, 64x64 batch 16, f32), losses "
          f"{[round(x, 5) for x in line['pixel']['loss']]}", flush=True)
    check(all(np.isfinite(r["loss"]) for r in rec_p), "pixel: a loss is not finite")
    check(all(no_launches(r["launches"]) for r in rec_p), "pixel: a kernel launched in a step")
    del tr
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    line["failed_checks"] = fails
    smoke.lines["train"] = line
    require(not fails, f"train: {fails}")


def stage_config(name, corpus, stage_idx, remat, batches=STAGE_BATCHES):
    """``train_config`` of ``name`` with the one stage ``stage_idx`` as its
    stages list: the config's patch and batch size, ``batches`` batches of
    crops, the stage's ``remat`` set; STAGE_STEPS steps, no eval."""
    conf = train_config(name, corpus, max_steps=STAGE_STEPS, checkpoint_rate=0, eval_rate=0,
                        verbose_rate=1)
    stage = TRAIN_CONFIGS[name]["train"]["stages"][stage_idx]
    conf["train"]["stages"] = [dict(stage, max_num_patchs=batches * stage["batch_size"],
                                    remat=remat)]
    return conf


def requested_bytes(message):
    """The bytes an out-of-memory error says the allocator asked for."""
    m = re.search(r"Tried to allocate ([\d.]+) ([KMGT]?i?B)", message)
    if not m:
        return None
    unit = {"B": 1, "KiB": 2**10, "MiB": 2**20, "GiB": 2**30, "TiB": 2**40}.get(m.group(2), 1)
    return int(float(m.group(1)) * unit)


def loader_wait(tr, stage, steps=LOADER_STEPS):
    """The step loop of ``Trainer.run`` driven by hand on ``tr``'s model and
    step, for each backend: the ms the loop blocks in ``next(loader)`` (the
    device prefetch over ``batched_loader``), of which ``loader_ms`` is spent
    in ``batched_loader``'s own ``next`` (waiting for the batch to be made;
    the rest is the prefetch's pinned copy), the garbage collections during
    the waits, and the synchronized step ms after each; the first wait
    includes the loader's start. Then the first 3 native batches against
    the python backend's, bitwise."""
    import gc
    import itertools

    import torch

    from irdu_tpu_torch.data.loader import batched_loader, device_prefetch

    def timed(batches, spent):
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            spent.append(time.perf_counter() - t0)
            if batch is None:
                return
            yield batch

    def collections():
        return sum(g["collections"] for g in gc.get_stats())

    ds = tr._stage_dataset(stage, 0)
    out = dict(patch=stage["patch_size"], batch=stage["batch_size"],
               native_compatible=ds.native_compatible())
    for backend in ("python", "native"):
        spent = []
        it = device_prefetch(timed(batched_loader(ds, stage["batch_size"], backend=backend),
                                   spent), DEVICE)
        wait_ms, loader_ms, ms, gcs = [], [], [], 0
        for _ in range(steps):
            before, c0 = len(spent), collections()
            t0 = time.perf_counter()
            noisy, clean = next(it)
            t1 = time.perf_counter()
            gcs += collections() - c0
            loader_ms.append(sum(spent[before:]) * 1e3)
            tr.state, _ = tr.train_step(tr.state, noisy, clean, tr.generator)
            sync()
            wait_ms.append((t1 - t0) * 1e3)
            ms.append((time.perf_counter() - t1) * 1e3)
        it.close()
        out[backend] = dict(wait_ms=[round(w, 3) for w in wait_ms],
                            loader_ms=[round(w, 3) for w in loader_ms],
                            step_ms=[round(s, 3) for s in ms],
                            gc_collections_in_waits=gcs,
                            median_wait_ms=round(float(np.median(wait_ms[1:])), 3),
                            median_loader_ms=round(float(np.median(loader_ms[1:])), 3),
                            median_step_ms=round(float(np.median(ms[1:])), 3))
    firsts = {b: list(itertools.islice(batched_loader(ds, stage["batch_size"], backend=b), 3))
              for b in ("python", "native")}
    out["native_vs_python_bitwise"] = len(firsts["native"]) == 3 and all(
        np.array_equal(a, c) and np.array_equal(b, d)
        for (a, b), (c, d) in zip(firsts["python"], firsts["native"]))
    del firsts
    torch.cuda.synchronize()
    return out


def phase_stages(smoke):
    """Every curriculum stage of flagship_sigma25 and lightformer_pixel_sigma
    (STAGE_CONFIGS; full width, f32) on the card, each alone: a config whose
    stages list is that one stage (STAGE_BATCHES batches of crops from the
    synthetic train set, 420-519 px, so the 512² crops are padded), under
    remat off, then on (stages 1-3 off only, STAGE_REMAT). For each
    (config, stage, remat), after ``reset_peak_memory_stats``: STAGE_STEPS
    ``Trainer`` steps, the second step's ms, ``max_memory_allocated`` and
    ``max_memory_reserved`` in GiB (and what was allocated before the run),
    finite losses and gradients, no kernel launch in a step. An
    out-of-memory error with remat off is a reading (``oom``, the bytes asked for);
    with remat on (stage 0) the run must complete. The run's checkpoint at
    ``max_steps`` is not written (it would time a 160 MB file write, not the
    stage). On the stage named in
    LOADER_WAIT of each config (remat as the config trains, off, unless that
    ran out of memory) the loop's wait in ``next(loader)`` against the step,
    for the python and the native backend, and native against python
    batches bitwise (``loader_wait``)."""
    import gc
    import shutil

    import torch

    from irdu_tpu_torch.data import native
    from irdu_tpu_torch.models.registry import set_remat

    work = os.path.join(REPO, "experiments", "chip_smoke_stages")  # git-ignored, removed after
    shutil.rmtree(work, ignore_errors=True)
    corpus, images = train_corpus(os.path.join(work, "corpus"))
    t0 = time.perf_counter()
    lib_ok = native.available()
    line = {"card": smoke.lines.get("device", {}).get("nvidia_smi"), "steps": STAGE_STEPS,
            "native_library": dict(available=lib_ok, error=native.load_error(),
                                   seconds_to_build_and_load=round(time.perf_counter() - t0, 3),
                                   compiler=native.compiler(), flags=list(native.CXX_FLAGS)),
            "runs": [], "loader_wait": {}}
    fails = []
    if not lib_ok:
        fails.append(f"the native library: {native.load_error()}")
    counts = {n: 0 for n in KERNEL_NAMES}
    for name in STAGE_CONFIGS:
        for idx, stage in enumerate(TRAIN_CONFIGS[name]["train"]["stages"]):
            for remat in STAGE_REMAT.get(idx, (False, True)):
                rec = []
                tr = smoke_trainer(stage_config(name, corpus, idx, remat),
                                   os.path.join(work, f"{name}_{idx}_{int(remat)}"), images, rec)
                tr.ckpt.save = lambda *a, **k: False
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                oom = None
                try:
                    tr.run()
                    sync()
                except (torch.cuda.OutOfMemoryError, RuntimeError) as exc:
                    if not re.search(r"out of memory|ALLOC_FAILED", str(exc)):
                        raise
                    oom = str(exc)
                row = dict(config=name, stage=idx, patch=stage["patch_size"],
                           batch=stage["batch_size"],
                           pixels=stage["patch_size"] ** 2 * stage["batch_size"], remat=remat,
                           steps=len(rec), step2_ms=round(rec[1]["ms"], 3) if len(rec) > 1 else None,
                           step_ms=[round(r["ms"], 3) for r in rec],
                           peak_allocated_gib=round(torch.cuda.max_memory_allocated() / GIB, 3),
                           peak_reserved_gib=round(torch.cuda.max_memory_reserved() / GIB, 3),
                           allocated_before_gib=round(before / GIB, 3),
                           loss=[r["loss"] for r in rec],
                           loss_finite=all(np.isfinite(r["loss"]) for r in rec),
                           grads_finite=all(r["grads_finite"] for r in rec),
                           step_launches=sum(sum(r["launches"].values()) for r in rec),
                           oom=oom is not None)
                if oom is not None:
                    row.update(oom_request_bytes=requested_bytes(oom), oom_message=oom[:300])
                for r in rec:
                    for n in KERNEL_NAMES:
                        counts[n] += r["launches"][n]
                line["runs"].append(row)
                print(f"stages {name} {idx} ({stage['patch_size']}² batch {stage['batch_size']}) "
                      f"remat {remat}: " + (f"OOM asking {row['oom_request_bytes']} bytes, "
                                            f"peak {row['peak_allocated_gib']} GiB"
                                            if oom else
                                            f"step 2 {row['step2_ms']} ms, peak "
                                            f"{row['peak_allocated_gib']} GiB allocated, "
                                            f"{row['peak_reserved_gib']} reserved"), flush=True)
                what = f"{name} stage {idx} remat {remat}"
                if oom is None or remat:
                    if oom is not None:
                        fails.append(f"{what}: out of memory ({row['oom_request_bytes']} bytes)")
                    elif len(rec) != STAGE_STEPS:
                        fails.append(f"{what}: {len(rec)} steps")
                    if not (row["loss_finite"] and row["grads_finite"]):
                        fails.append(f"{what}: a loss or gradient is not finite")
                    if row["step_launches"]:
                        fails.append(f"{what}: {row['step_launches']} kernel launches in a step")
                if (idx == LOADER_WAIT[name] and name not in line["loader_wait"]
                        and oom is None and lib_ok):
                    set_remat(tr.model, remat)
                    wait = loader_wait(tr, tr.config["train"]["stages"][0] | {
                        "max_num_patchs": (LOADER_STEPS + 2) * stage["batch_size"]})
                    wait["remat"] = remat
                    line["loader_wait"][name] = wait
                    print(f"stages loader wait, {name} stage {idx}: " + ", ".join(
                        f"{b} {wait[b]['median_wait_ms']} ms ({wait[b]['median_loader_ms']} "
                        f"in the loader) of a {wait[b]['median_step_ms']} ms step"
                        for b in ("python", "native"))
                        + f"; native batches bitwise {wait['native_vs_python_bitwise']}",
                        flush=True)
                    if not wait["native_vs_python_bitwise"]:
                        fails.append(f"{name}: native batches differ from python batches")
                del tr, rec
                gc.collect()
                torch.cuda.empty_cache()
        if lib_ok and name not in line["loader_wait"]:
            fails.append(f"{name}: no loader-wait reading")
    smoke.path_counts["stages_steps"] = counts
    shutil.rmtree(work, ignore_errors=True)
    line["failed_checks"] = fails
    smoke.lines["stages"] = line
    require(not fails, f"stages: {fails}")


def flagship_launches(h, w):
    """A flagship forward's launches on (h, w) images, whatever the batch:
    3 K3, 32 K4, 8 K2 and, per scale s, one K1 where the solver's
    (h/2^s, w/2^s) plane takes it (``gtv_glr._mega_ok``), else the band
    route's 5 K5: what PER_REQUEST lists for its requests."""
    from irdu_tpu_torch.solvers.gtv_glr import _mega_ok

    k1 = sum(_mega_ok((1, 1, h >> s, w >> s)) for s in range(4))
    return launches(K3_PER_REQUEST, K4_PER_REQUEST, k1, 8, 5 * (4 - k1))


def parallel_batches():
    """PARALLEL_STEPS global (noisy, clean) batches of PARALLEL_BATCH
    PARALLEL_SIDE² seeded piecewise-smooth images with sigma-25 noise, on the
    host."""
    import torch

    out = []
    for k in range(PARALLEL_STEPS):
        clean = np.stack([piecewise_smooth(PARALLEL_SIDE, PARALLEL_SIDE,
                                           seed=PARALLEL_SEED + k * PARALLEL_BATCH + i)
                          for i in range(PARALLEL_BATCH)])
        noisy = clean + np.random.RandomState(PARALLEL_SEED + k).normal(0, 25 / 255.0,
                                                                         clean.shape)
        out.append((torch.from_numpy(noisy.astype(np.float32)), torch.from_numpy(clean)))
    return out


def parallel_train(batches, mesh=None, ddp=False, grads=True, conf=None):
    """flagship_sigma25's model (full width, f32, plain versions, the init
    seeded with PARALLEL_SEED, the config's lr schedule) stepped once per
    global batch on ``mesh`` (None: one process; each rank takes its slice),
    the latent noise from a generator seeded alike: per step the loss, ms,
    launches and (``grads``) the gradients on the host; and the peak GiB
    allocated. ``ddp``: the objective in DDP even with one data rank.
    ``conf``: another model section (its loss the L1 term alone)."""
    import torch
    from torch.nn.parallel import DistributedDataParallel

    from irdu_tpu_torch.models.registry import create_model, set_kernels
    from irdu_tpu_torch.parallel.mesh import shard_batch
    from irdu_tpu_torch.train.steps import (Objective, create_train_state, distribute,
                                            make_train_step)
    from irdu_tpu_torch.train.trainer import build_schedule

    t0 = time.perf_counter()
    aux = conf is None
    conf = dict(TRAIN_CONFIGS["flagship_sigma25"]["model"] if aux else conf)
    torch.manual_seed(PARALLEL_SEED)
    model = create_model(conf.pop("type"), **conf).to(DEVICE)
    set_kernels(model, False)
    state = create_train_state(model, build_schedule({"type": "flagship"}))
    if mesh is not None:
        distribute(state, mesh)
        if ddp and state.ddp is None:
            state.ddp = DistributedDataParallel(
                Objective(model), device_ids=[torch.cuda.current_device()],
                process_group=mesh.data_group, broadcast_buffers=False)
    step = make_train_step(use_aux_losses=aux)
    gen = torch.Generator(device=DEVICE).manual_seed(PARALLEL_SEED)
    torch.cuda.reset_peak_memory_stats()
    rows = [dict(setup_s=round(time.perf_counter() - t0, 3))]
    for noisy, clean in batches:
        noisy, clean = (shard_batch((noisy, clean), mesh) if mesh is not None
                        else (noisy.to(DEVICE), clean.to(DEVICE)))
        sync()
        before = launch_counts()
        t0 = time.perf_counter()
        state, m = step(state, noisy, clean, gen)
        sync()
        row = dict(loss=float(m["loss"]), ms=round((time.perf_counter() - t0) * 1e3, 3),
                   launches=counts_since(before))
        if grads:
            row["grads"] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        rows.append(row)
    peak = round(torch.cuda.max_memory_allocated() / GIB, 3)
    del state, model, step
    torch.cuda.empty_cache()
    return rows[1:], dict(peak_gib=peak, setup_s=rows[0]["setup_s"])


def ablation_crop(batches):
    """PARALLEL_ABLATION's global batch: the first images of the first
    global batch, each its top-left crop."""
    _, n, side = PARALLEL_ABLATION
    return tuple(t[:n, :side, :side].contiguous() for t in batches[0])


def parallel_paths(model, noisy, mesh, check):
    """``halo_shard_forward`` and ``sharded_tiled_forward`` of the bf16
    flagship on ``mesh``: a run with (``check``) every kernel call held
    against its plain version (the other ranks run it plainly: it is
    collective), which also warms the path up, then a counted and timed
    one. Per path the image, its ms, launches and the checks."""
    from irdu_tpu_torch.parallel.spatial import halo_shard_forward, sharded_tiled_forward
    from irdu_tpu_torch.predict import batch_forward

    fwd = batch_forward(model)
    h, w = noisy.shape[:2]
    win = PARALLEL_TILE + 2 * PARALLEL_TILE_HALO
    paths = {"halo": (lambda: halo_shard_forward(fwd, noisy, mesh, halo=PARALLEL_HALO),
                      flagship_launches(h // mesh.dp + 2 * PARALLEL_HALO, w)),
             "tiled": (lambda: sharded_tiled_forward(fwd, noisy, mesh, tile=PARALLEL_TILE,
                                                     halo=PARALLEL_TILE_HALO),
                       flagship_launches(win, win))}
    out = {}
    for name, (run, want) in paths.items():
        checks = None
        if check:
            with kernel_checks(flagship_sites()) as rec:
                run()
            checks = checks_summary(rec, want)
        else:
            run()
        t0 = time.perf_counter()
        image, counts = counted(run)
        ms = round((time.perf_counter() - t0) * 1e3, 3)
        out[name] = dict(image=image, ms=ms, launches=counts, want=want, checks=checks)
    return out


def parallel_rank(rank, world, work, t_start, legs):
    """One gloo rank of the parallel phase on cuda:0, started at ``t_start``
    (the parent's clock) in the group of ``legs``: "train" (the DDP steps,
    then the tensor-parallel step) or "paths" (both spatial paths). Its
    results and each leg's seconds go to ``work``/<legs>_rank<rank>.pt."""
    import hashlib

    import torch
    import torch.distributed as dist

    from irdu_tpu_torch.kernels.build import library_path
    from irdu_tpu_torch.parallel.mesh import host_staged, init_distributed, make_mesh
    from irdu_tpu_torch.parallel.tensor import make_dp_tp_mesh
    from irdu_tpu_torch.predict import load_model

    require(os.path.isfile(library_path()), "a rank found no built kernel library")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # gloo: NCCL takes one rank a card; rank % device_count puts both on cuda:0
    dev = init_distributed("cuda", backend="gloo", rank=rank, world_size=world,
                           init_method="file://" + os.path.join(work, f"rendezvous_{legs}"))
    try:
        out = dict(rank=rank, backend=dist.get_backend(), world=dist.get_world_size(),
                   halo_rows="host buffers" if host_staged() else "device buffers",
                   legs_s={"start": round(time.perf_counter() - t_start, 3)})
        t0 = time.perf_counter()
        if legs == "train":
            batches = parallel_batches()
            out["dp"], out["dp_info"] = parallel_train(batches, make_mesh(dev),
                                                       grads=rank == 0)
            out["legs_s"]["dp"], t0 = round(time.perf_counter() - t0, 3), time.perf_counter()
            out["tp"], out["tp_info"] = parallel_train(
                [tuple(t[:PARALLEL_TP_BATCH] for t in batches[0])], make_dp_tp_mesh(world, dev),
                grads=False)
            out["legs_s"]["tp"], t0 = round(time.perf_counter() - t0, 3), time.perf_counter()
            out["tp_ablation"], _ = parallel_train(
                [ablation_crop(batches)], make_dp_tp_mesh(world, dev), grads=False,
                conf=ABLATION_MODELS[PARALLEL_ABLATION[0]])
            out["legs_s"]["tp_ablation"] = round(time.perf_counter() - t0, 3)
        else:
            _, noisy = request_image(len(REQUESTS) - 1)
            out["paths"] = parallel_paths(load_model(device=dev), noisy, make_mesh(dev),
                                          check=rank == 0)
            out["legs_s"]["paths"] = round(time.perf_counter() - t0, 3)
            for p in out["paths"].values():
                p["digest"] = hashlib.sha256(np.ascontiguousarray(p["image"]).tobytes()).hexdigest()
                if rank:
                    del p["image"]
        torch.save(out, os.path.join(work, f"{legs}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def phase_parallel(smoke):
    """Multi-GPU on the one card (see the module docstring): two groups of
    PARALLEL_WORLD gloo ranks spawned on cuda:0, and while they run the
    one-process references and NCCL at world size 1 in this process."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from irdu_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from irdu_tpu_torch.parallel.spatial import halo_shard_forward, sharded_tiled_forward
    from irdu_tpu_torch.predict import batch_forward, load_model

    for hw in REQUESTS:
        require(flagship_launches(*hw) == PER_REQUEST[hw], f"flagship_launches{hw}")
    os.makedirs(os.path.join(REPO, "experiments"), exist_ok=True)  # git-ignored
    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_", dir=os.path.join(REPO, "experiments"))
    fails = []
    ranks_run = []
    try:
        torch.cuda.empty_cache()
        # two groups of ranks, the train legs and the serving paths, start
        # together (~10-15 s to reach the card; each makes its own seeded
        # inputs) while the references run here
        t0 = time.perf_counter()
        for legs in PARALLEL_GROUPS:
            ranks_run.append(mp.start_processes(
                parallel_rank, args=(PARALLEL_WORLD, work, t0, legs), nprocs=PARALLEL_WORLD,
                join=False, start_method="spawn"))
        batches = parallel_batches()
        size = REQUESTS[-1]
        clean, noisy = request_image(len(REQUESTS) - 1)
        ref_dp, ref_info = parallel_train(batches)
        ref_tp, _ = parallel_train([tuple(t[:PARALLEL_TP_BATCH] for t in batches[0])],
                                   grads=False)
        ref_tp_ablation, _ = parallel_train([ablation_crop(batches)], grads=False,
                                            conf=ABLATION_MODELS[PARALLEL_ABLATION[0]])
        model = smoke.model if smoke.model is not None else load_model(device=DEVICE)
        fwd = batch_forward(model)
        fwd(noisy[None])
        sync()
        t1 = time.perf_counter()
        whole = fwd(noisy[None])[0].cpu().numpy()
        whole_ms = round((time.perf_counter() - t1) * 1e3, 3)
        one_rank = sharded_tiled_forward(fwd, noisy, tile=PARALLEL_TILE, halo=PARALLEL_TILE_HALO)
        torch.cuda.empty_cache()
        # NCCL at world size 1, here, while the gloo ranks run
        dev = init_distributed("cuda", rank=0, world_size=1,
                               init_method="file://" + os.path.join(work, "nccl"))
        try:
            mesh = make_mesh(dev)
            nccl_step, _ = parallel_train(batches[:1], mesh, ddp=True, grads=False)
            nccl_halo = halo_shard_forward(fwd, noisy, mesh, halo=PARALLEL_HALO)
            nccl = dict(backend=dist.get_backend(), world=dist.get_world_size(),
                        ddp_loss=nccl_step[0]["loss"], ddp_ms=nccl_step[0]["ms"],
                        ddp_loss_gap=abs(nccl_step[0]["loss"] - ref_dp[0]["loss"]),
                        halo_max_abs_vs_whole=float(np.abs(nccl_halo - whole).max()),
                        halo_within_k1_bar=k1_bar(torch.from_numpy(nccl_halo),
                                                  torch.from_numpy(whole)))
        finally:
            dist.destroy_process_group()
        refs_s = round(time.perf_counter() - t0, 3)
        torch.cuda.empty_cache()
        for run in ranks_run:
            while not run.join():
                pass
        ranks_run = []
        spawn_s = round(time.perf_counter() - t0, 3)
        groups = {legs: [torch.load(os.path.join(work, f"{legs}_rank{r}.pt"), weights_only=False)
                         for r in range(PARALLEL_WORLD)] for legs in PARALLEL_GROUPS}
        ranks = [{**t, **p, "legs_s": {"train": t["legs_s"], "paths": p["legs_s"]}}
                 for t, p in zip(groups["train"], groups["paths"])]

        dp_rows = []
        for k, ref in enumerate(ref_dp):
            row = dict(step=k + 1, ref_loss=ref["loss"], ref_ms=ref["ms"],
                       loss=[r["dp"][k]["loss"] for r in ranks],
                       ms=[r["dp"][k]["ms"] for r in ranks],
                       launches=[sum(r["dp"][k]["launches"].values()) for r in ranks])
            row["grad_gap"], row["grad_gap_tensor"] = grad_gaps(ranks[0]["dp"][k]["grads"],
                                                                ref["grads"])
            row["loss_gap"] = max(abs(v - ref["loss"]) for v in row["loss"]) / abs(ref["loss"])
            dp_rows.append(row)
            if row["loss_gap"] > TRAIN_GRAD_RTOL or row["grad_gap"] > TRAIN_GRAD_RTOL:
                fails.append(f"dp step {k + 1}: loss gap {row['loss_gap']}, gradient gap "
                             f"{row['grad_gap']} ({row['grad_gap_tensor']})")
            if any(row["launches"]) or ref["launches"] and any(ref["launches"].values()):
                fails.append(f"dp step {k + 1}: kernel launches {row['launches']}")
        tp_row = dict(ref_loss=ref_tp[0]["loss"], ref_ms=ref_tp[0]["ms"],
                      loss=[r["tp"][0]["loss"] for r in ranks],
                      ms=[r["tp"][0]["ms"] for r in ranks],
                      launches=[sum(r["tp"][0]["launches"].values()) for r in ranks],
                      peak_gib=[r["tp_info"]["peak_gib"] for r in ranks],
                      setup_s=[r["tp_info"]["setup_s"] for r in ranks])
        tp_row["loss_gap"] = max(abs(v - tp_row["ref_loss"]) for v in tp_row["loss"])
        if tp_row["loss_gap"] > PARALLEL_LOSS_ATOL or any(tp_row["launches"]):
            fails.append(f"tp: loss gap {tp_row['loss_gap']}, launches {tp_row['launches']}")
        name, n_img, side = PARALLEL_ABLATION
        tp_ablation = dict(config=name, global_batch=n_img, side=side,
                           ref_loss=ref_tp_ablation[0]["loss"], ref_ms=ref_tp_ablation[0]["ms"],
                           loss=[r["tp_ablation"][0]["loss"] for r in ranks],
                           ms=[r["tp_ablation"][0]["ms"] for r in ranks],
                           launches=[sum(r["tp_ablation"][0]["launches"].values())
                                     for r in ranks])
        tp_ablation["loss_gap"] = max(abs(v - tp_ablation["ref_loss"])
                                      for v in tp_ablation["loss"])
        if tp_ablation["loss_gap"] > PARALLEL_LOSS_ATOL or any(tp_ablation["launches"]):
            fails.append(f"tp {name}: loss gap {tp_ablation['loss_gap']}, launches "
                         f"{tp_ablation['launches']}")

        path_rows = {}
        for name, ref_img in (("halo", whole), ("tiled", one_rank)):
            mine = ranks[0]["paths"][name]
            img = mine["image"]
            row = dict(ms=[r["paths"][name]["ms"] for r in ranks],
                       launches=[r["paths"][name]["launches"] for r in ranks],
                       want=mine["want"], checks=mine["checks"],
                       same_on_every_rank=len({r["paths"][name]["digest"] for r in ranks}) == 1,
                       max_abs_vs_ref=float(np.abs(img - ref_img).max()),
                       within_k1_bar=k1_bar(torch.from_numpy(img), torch.from_numpy(ref_img)),
                       psnr=psnr(clean, np.clip(img, 0, 1)),
                       psnr_ref=psnr(clean, np.clip(ref_img, 0, 1)),
                       finite=bool(np.isfinite(img).all()))
            row["psnr_gap_db"] = round(row["psnr"] - row["psnr_ref"], 4)
            row["psnr_gap_to_whole_db"] = round(row["psnr"] - psnr(clean, np.clip(whole, 0, 1)), 4)
            for r in ranks:
                smoke.path_counts[f"parallel_{name}_rank{r['rank']}"] = r["paths"][name]["launches"]
            path_rows[name] = row
            if not (row["within_k1_bar"] and row["finite"] and row["same_on_every_rank"]):
                fails.append(f"{name}: max|d| {row['max_abs_vs_ref']} to the "
                             f"{'whole image' if name == 'halo' else 'one-rank run'}")
            if any(c != mine["want"] for c in row["launches"]) or not mine["checks"]["calls_ok"]:
                fails.append(f"{name}: launches {row['launches']}, want {mine['want']}, "
                             f"checks {mine['checks']}")

        if nccl["ddp_loss_gap"] > PARALLEL_LOSS_ATOL or not nccl["halo_within_k1_bar"]:
            fails.append(f"nccl world 1: {nccl}")

        line = dict(card=smoke.lines.get("device", {}).get("nvidia_smi"),
                    backends=[dict(backend=ranks[0]["backend"], world=ranks[0]["world"],
                                   groups=list(PARALLEL_GROUPS), device="cuda:0 (every rank)",
                                   halo_rows=ranks[0]["halo_rows"]),
                              dict(backend=nccl["backend"], world=nccl["world"],
                                   device=f"cuda:{torch.cuda.current_device()}",
                                   halo_rows="none (one rank: the whole image)")],
                    ranks_s=spawn_s, references_s=refs_s,
                    rank_legs_s=[r["legs_s"] for r in ranks],
                    train=dict(side=PARALLEL_SIDE, global_batch=PARALLEL_BATCH, steps=dp_rows,
                               ref_peak_gib=ref_info["peak_gib"],
                               peak_gib=[r["dp_info"]["peak_gib"] for r in ranks],
                               setup_s=[r["dp_info"]["setup_s"] for r in ranks]),
                    tp=dict(tp=PARALLEL_WORLD, global_batch=PARALLEL_TP_BATCH, **tp_row),
                    tp_ablation=dict(tp=PARALLEL_WORLD, **tp_ablation),
                    image=list(size), whole_ms=whole_ms, halo=dict(halo=PARALLEL_HALO,
                                                                   **path_rows["halo"]),
                    tiled=dict(tile=PARALLEL_TILE, halo=PARALLEL_TILE_HALO, **path_rows["tiled"]),
                    nccl=nccl, failed_checks=fails)
        smoke.lines["parallel"] = line
        print(f"parallel: {PARALLEL_WORLD} gloo ranks on cuda:0 (done in {spawn_s} s; halo "
              f"rows via {ranks[0]['halo_rows']}): dp steps {[r['ms'] for r in dp_rows]} ms, "
              f"gradient gaps {[r['grad_gap'] for r in dp_rows]}; tp loss gap "
              f"{tp_row['loss_gap']}, {PARALLEL_ABLATION[0]} {tp_ablation['loss_gap']}; "
              f"halo {path_rows['halo']['ms']} ms "
              f"({path_rows['halo']['psnr']} dB, whole {whole_ms} ms "
              f"{path_rows['halo']['psnr_ref']} dB), tiled {path_rows['tiled']['ms']} ms "
              f"({path_rows['tiled']['psnr']} dB); nccl world 1: {nccl}", flush=True)
    finally:
        for run in ranks_run:  # a failure here: stop the ranks
            for proc in run.processes:
                proc.terminate()
            for proc in run.processes:
                proc.join()
        shutil.rmtree(work, ignore_errors=True)
    require(not fails, f"parallel: {fails}")


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import irdu_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the irdu_tpu_torch package must sit beside this script",
              file=sys.stderr)
        return 2
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"
    print(card)
    from irdu_tpu_torch.kernels.build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
          f"{torch.version.cuda} nvcc {nvcc.stdout.strip().splitlines()[-1]}", flush=True)

    smoke = Smoke()
    smoke.lines["device"] = {"nvidia_smi": card, "torch": torch.__version__,
                             "cuda": torch.version.cuda}
    build_s = smoke.run("build", phase_build, smoke)
    if not smoke.failed:
        smoke.run("serving", phase_serving, smoke)
        smoke.run("profile", phase_profile, smoke)
        smoke.run("small", phase_small, smoke)
        smoke.run("pixel", phase_pixel, smoke)
        smoke.run("ablation", phase_ablation, smoke)
        smoke.run("kernels", phase_kernels, smoke)
        smoke.run("windows", phase_windows, smoke)
        smoke.run("model", phase_model, smoke)
        smoke.run("eval", phase_eval, smoke)
        smoke.run("variants", phase_variants, smoke)
        smoke.run("tile", phase_tile, smoke)
        smoke.run("natural", phase_natural, smoke)
        smoke.run("baselines", phase_baselines, smoke)
        smoke.run("deploy", phase_deploy, smoke)
        smoke.run("train", phase_train, smoke)
        smoke.run("stages", phase_stages, smoke)
        smoke.run("parallel", phase_parallel, smoke)
    smoke.lines["device_ms"] = device_ms_sessions()
    kernels = kernels_line(smoke)
    print(json.dumps(kernels), flush=True)
    for key in ("ptxas", "serving", "profile", "small_models", "pixel", "ablation",
                "band_route", "k7_band_512", "windows", "model", "eval", "variants", "tile",
                "natural", "baselines", "deploy", "train", "stages", "parallel",
                "device_ms"):
        if key in smoke.lines:
            print(json.dumps(smoke.lines[key]), flush=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_lines.json"), "w") as fh:
        json.dump(dict(smoke.lines, kernels=kernels, path_counts=smoke.path_counts), fh, indent=1)
    total = time.perf_counter() - t_start
    if build_s is not None and build_s > BUDGET_S["build"]:
        smoke.failed.append(f"build over its {BUDGET_S['build']} s budget ({build_s:.1f} s)")
    for phase in ("train", "deploy", "baselines", "stages", "parallel", "windows"):
        if smoke.phases.get(phase, 0) > BUDGET_S[phase]:
            smoke.failed.append(f"{phase} over its {BUDGET_S[phase]} s budget "
                                f"({smoke.phases[phase]:.1f} s)")
    if total > BUDGET_S["total"]:
        smoke.failed.append(f"run over its {BUDGET_S['total']} s budget ({total:.1f} s)")
    print(card)  # again beside the results: the card's name and power limit
    print(json.dumps({"phases_s": smoke.phases, "total_s": round(total, 3),
                      "budget_s": BUDGET_S, "failed": smoke.failed}), flush=True)
    if smoke.failed:
        print(f"chip_smoke: failed phases: {smoke.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def sync():
    import torch

    torch.cuda.synchronize()


if __name__ == "__main__":
    sys.exit(main())
