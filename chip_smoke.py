#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (``das3r_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line, each raising (non-zero exit) on
failure:

1. device: needs CUDA; prints the card's name and power limit
   (``nvidia-smi``) and turns TF32 off.
2. build: compiles every kernel under ``das3r_tpu_torch/csrc`` with nvcc
   (one process per source, in parallel) into ``build/torch_ext/``; prints
   ptxas's registers and spills per entry function and the blocks per SM
   of the kernels that report it (kernel B: serving and training).
3. scene: a synthetic 8-frame stage-1 scene at 288x512, rearranged, plus
   a 1.5M-Gaussian SH-degree-3 scene from a seed, written as the trained
   checkpoint (PLY + stage-1 w2c poses) that the render tool loads.
4. parity: for view 0 of that scene at full size, kernels A, B, C against
   their plain PyTorch versions on the card (``extract_chunks`` bitwise,
   ``blend_forward`` within 2e-4 with and without its ``n_last`` output,
   ``blend_backward`` within 2e-5 x max|g| per column group on cotangents
   from a seed), with times of kernel, plain version and the library
   call that computes the same function (where one exists), and each
   kernel's bound from the bytes and operations of this run. Two times
   each: ``ms``, CUDA events around one call of the wrapper, its host
   work included; ``device_ms``, the kernel alone as ``torch.profiler``
   records it (``library_device_ms``: every kernel of the library call).
   Both are medians of 10 calls; ``device_ms_calls`` and
   ``device_ms_kernels`` say over how many whole calls and with how many
   device records each (the same for ``library_device_ms``). Then the
   duplication table's pair ``dup_count`` / ``dup_emit`` against its plain
   version (the dense table, on the card), its keys bitwise, one line
   each (``device_ms`` of the kernel; ``ms`` and ``plain_ms`` of the pair
   on ``dup_count``'s).
5. reference: a small scene rendered on the card equals the port's CPU
   render (plain versions, held against JAX and the f64 oracle by
   ``tests/test_torch_*.py``) within 2e-4, and so do the gradients of its
   training loss, within 2e-5 x max|g| per parameter; and 800 Gaussians
   rasterized on the card, on both raster branches, against the port's
   float64 oracle (``ops/splat/reference.py``) within 2e-4, radii equal.
6. main: ``das3r_tpu_torch.eval.render_tool.render_sets`` renders all 8
   views on ``cuda``; checks 8 finite, non-constant PNGs, no dropped
   entry, and that the forward kernels launched once per view.
7. profile: one more render of view 1 under ``torch.profiler``: the
   device time by kernel, the host time by operator, and the device's
   idle share of the render's wall time.
8. train: ``das3r_tpu_torch.train.step.train_step``, 10 steps over frames
   0 and 1 of the synthetic scene at full width (the 1.5M Gaussians with
   every SH band filled, ``conf_static`` from the scene's dynamic maps,
   the stage-1 poses and FoVs), densification statistics tracked; checks
   finite losses, gradients (through the Adam moments), parameters and
   statistics, the Adam count, no dropped entry, that frame 0's loss fell,
   and that every kernel launched once per step.
9. train_profile: one more step under ``torch.profiler``: device ms by
   ``das3r::`` stage, forward and backward (a backward op belongs to the
   stage whose forward op has its autograd sequence number), the top
   kernels and the idle share.
10. trainer_scene: a synthetic 12-frame stage-1 scene at 288x512,
   rearranged, loaded in eval mode (11 train frames) and built by
   ``das3r_tpu_torch.train.scene_setup.build_scene`` with its defaults on
   ``cuda``: the dense init capped at 1.5M points, the k-NN scales and the
   window-path capacity probe (each timed).
11. trainer_entry_parity: kernels A, B, C as in phase 4 on view 0 of that
   bundle's entry stream, the non-saturating scene of the trainer's entry
   run, where most of their launches run. In both phases kernel B's line
   carries its per-tile work (entries per tile and each tile's longest
   pixel run: mean, max, the busiest SM's sum) and its blocks per SM,
   and how often its n_last agrees with the plain version's.
11b. bf16_table: the bf16 attribute table (``table_bf16``) on view 0 of
   that bundle and of the random scene: the card's encode bitwise the
   CPU's; B-bf16 (with and without n_last) and C-bf16 against their plain
   versions (the f32 plain versions on the decoded table) at the bars of
   phase 4; the bf16 image against the f32 one in JAX's envelope (max <
   1.5e-2, mean < 1e-3); B-bf16's and C-bf16's ``ms`` and ``device_ms``
   beside f32 B's and C's on the same stream, in turns (f32, bf16, bf16,
   f32, f32, bf16; each form's median of its three), with their
   bounds; view 0 as 2 tile ranges through B-bf16,
   reassembled bitwise the whole-image B-bf16; then 10 ``train_step``s of
   phase 8 with ``table_bf16`` (finite, the loss falls, one launch of
   B-bf16 and C-bf16 a step).
12. sharded: multi-device training on that bundle. First, in one
   process, its view 0 as 2, 4 and 5 tile ranges (5 leaves 4 padded
   tiles) through kernels A, B and C in their tile-range form: the
   reassembled image bitwise the whole-image B's, the summed g_table
   within 1e-6 x max|g| per column group of the whole-image C's, range 1
   of 4 against the plain versions at the bars of phase 4; per range
   count the layouts', B's and C's ``ms`` (all ranges in turn) and
   ``device_ms`` (each range's kernel alone, summed) beside the
   whole-image calls, and each range's bound. The same on the window
   path (K from the probe): view 0 as 2 and 4 ranges of window rows
   through kernels D and E in their tile-range form, the colours bitwise
   the whole-image D's, the summed gradients of the depth-rank table and
   of bg within 1e-6 x max|g|. Then
   ``parallel.sharded.make_sharded_train_step`` on two gloo ranks spawned
   on the one card (NCCL refuses two ranks on a device), 3 steps of one
   frame at (tile=2) and at (gauss=2), each against the port's unsharded
   step on the same card at the CPU tests' bars (the loss within rel
   1e-5, the first step's gradients within 2e-5 x max|g| per field, the
   parameters within 2 lr per step), and at (tile=2) on the window path
   (``entry_stream=False``, K from the probe); step ms (host clock after a
   synchronize), ``comm_stats`` bytes a step per family, peak memory a
   rank: two ranks on one card, not a scaling number.
13. window_parity: view 0 of that bundle at full size on the [T, K] window
   path, K from the probe's largest tile (a multiple of 128, at most
   16384): ``extract_windows`` bitwise, ``window_blend_forward`` within
   2e-4 with ``tin``'s zero pattern the plain version's,
   ``window_blend_backward`` within 2e-5 x max|g| per attribute group on
   the plain forward's ``tfinal`` and ``tin`` and again on kernel D's,
   each against its plain version, timed and bounded as above; kernel
   D's per-tile work (mean, max, the busiest SM's sum with block b on SM
   b mod the SM count) and blocks per SM; and, where no tile overflows
   K, kernel B on view 0's entry stream against kernel D's colours and
   final transmittance (bg = 0; the count of values that differ and the
   largest difference, within 2e-4) and the window-path image against
   the entry-stream image within 2e-4. Then the quantized-depth binning
   at 22 bits: the card's bins bitwise the CPU's, kernel D's colours on
   them against the plain version on the CPU (3 tile rows) within 2e-4,
   its binning time beside the exact binning's.
14. split_table: view 0 of that bundle and view 0 of the random scene,
   each binned three ways on both raster branches: the full-width
   ``[N, D]`` table; the split ``[N, L] + [H_cap, D - L]`` table at the
   shape ``models/autosize.auto_split_table`` picks from the scene's probe
   (the random scene probed as the JAX viewer probes, without conf; where
   no split is picked, L = 4 and ``auto_heavy_cap``, said so on the line);
   that split with half the heavy rows as its cap (rounded down to 1024,
   at least 1024). Gates: the split's keys and both branches' streams
   bitwise the full-width ones, its ``heavy_overflow`` 0; the starved
   cap's ``heavy_overflow`` the JAX formula from ``ntt`` on the host, and
   its keys a subset of the full-width keys, short only of over-cap heavy
   rows' cells at index >= L. Prints each way's binning time (``ms`` and
   ``device_ms`` of the whole ``bin_entry_stream`` or ``bin_gaussians``
   call, medians of 10), the split shape and the slot counts.
15. trainer: ``das3r_tpu_torch.train.trainer.train_scene`` twice on its
   own copy of the bundle, 44 iterations each (4 epochs), densify with
   clone and split at 10, 20 and 30, an opacity reset at 30, a test
   report and a save at 44: once on the entry stream, with a checkpoint
   at 44, once on the window path with the probed K. Checks finite losses
   and parameters, that the loss of iterations 12-22 is below that of
   1-11, the written PLY, pose npy and test log, the entry run's npz read
   back equal, and which kernels each run launched.
16. gui: ``das3r_tpu_torch.gui.ViewerScene.from_model_dir`` on the entry
   run's model (iteration 44) at the viewer's 480x320 on ``cuda``, and
   ``gui.server.make_server`` on 127.0.0.1 in a thread, answering real
   HTTP requests: ``/``, ``/state``, ``/render`` in modes rgb, confidence
   and no_soft at 8 yaws each, ``/traj``. Checks each PNG's shape, that it
   is not blank and that the modes differ, one launch of A and one of B
   per render, no dropped entry, and one panel per mode within 2e-4 of
   the same render through the plain versions of A and B; prints the
   request times (host clock), the ``render_panel`` times (CUDA events)
   and the PLY load.

17. stage1: ``das3r_tpu_torch.predictor.runner.run_scene`` at
   DUST3R_LARGE_CONFIG (606M parameters, seeded random weights from the
   testkit's generator, std 0.02) on ``cuda``: a 16-frame synthetic video
   at 288x512, ``eval_scene_graph(16)`` (110 symmetrized edges), the
   aligner's defaults (300 iterations), with flows from classic RAFT on
   seeded random weights (its flow head scaled by 0.01; 20 iterations,
   both directions of every edge) for the flow term, and the
   NeighborPropagator's mask refinement (``--refine_masks``). Then RAFT
   on one chunk of 12 edges timed, its first pair against the CPU
   within 1e-4 x max|CPU|, and SEA-RAFT "M" on the same chunk at 1
   iteration, timed and held the same way. Checks every output finite, the
   alignment loss falling, every artifact file written and no raster
   kernel launched; prints the parameter count, the peak device memory,
   each part's seconds (the host initialization apart from the loop),
   the loop's ms per iteration, its first and last loss, encode ms per
   frame and decode ms per pair (CUDA events, batches of 8) with a
   float32 and a bfloat16 trunk, a profile of 10 alignment iterations and
   of one decode batch, and the first pair of the runner's first
   decode batch (``encode_frames`` then ``decode_pairs`` on gathered
   tokens) on the card against the same functions in float32 on the CPU:
   each float32 map
   within 1e-4 x max|CPU|, the bfloat16 trunk's within the JAX package's
   bf16 bars (dynamic mask mean abs < 0.05, pts3d median relative < 0.1).
   The precision is the entry points' own (``utils/device.py::
   resolve_device`` turns TF32 off); the script sets none.
18. pipeline: ``das3r_tpu_torch.pipeline.run`` from a ``.pth`` of the same
   weights that the phase writes with ``testkit.save_reference_checkpoint``
   (the predictor's config is read back from it): 8 frames at size
   256 (144x256), stage 1, ``rearrange``, ``build_scene``, 20 stage-2
   iterations and ``render_sets``. Checks a finite stage-2 loss, the
   renders and the video, and the launches of each stage: D and F in the
   probe, A, B, C in training, A and B in the renders.
19. stage1_train: ``das3r_tpu_torch.predictor.train_loop.fit`` on ``cuda``
   (no raster kernel may launch). (a) The DAS3R recipe: the same
   DUST3R_LARGE_CONFIG weights, ``freeze='encoder_and_3d_predictor'``,
   ``Stage1TrainConfig``'s defaults (lr 5e-5, b2 0.95, weight decay
   0.05), ``WallTwoViewDataset`` at 512x288 (PointOdyssey's training
   resolution), batch 8, 2 epochs of 4 steps, a test pass over one batch
   each epoch and checkpoint-last/-best/-final written; checks every
   loss finite, every frozen tensor bitwise unchanged and every mask-head
   tensor moved, checkpoint-last reloaded bitwise, and the mask BCE on
   one fixed batch falling over 5 steps; prints the step ms (host clock
   after a synchronize), a profiled step, the peak memory, the
   checkpoints' seconds and bytes and the data's render seconds. (b)
   TINY from scratch through ``scripts/torch_train_tiny_stage1.py``'s
   functions (its data sets, configs and ``train``: ``fit``, the held-out
   IoU, ``stage1_tiny.npz``) at the setting of JAX's record (256 samples
   at 64x48, 60 epochs, lr 1e-3, freeze none; checkpoint-last written
   once, not every epoch), in a process of its own beside the quality
   phase's gt branch, while this process runs the TINY steps against
   the CPU and (d) (none of which needs (b)'s weights; (b)'s host-bound
   steps leave the card mostly idle, and their seconds are not the
   script's alone): the held-out mask IoU >= 0.7 (JAX's record 0.8733),
   no raster launch, and 3 TINY steps on the
   card against the CPU (losses, and at Adam eps 1e-2 the mask heads,
   within 1e-4 x max|CPU|). (c) ``eval_pose_estimation`` on a synthetic
   ``tum`` layout (8 frames at 288x512) with (b)'s model (read back from
   its npz), beside the predictor branch and the suite: every sequence
   evaluated, a finite ATE. (e) ``run_scene`` with RAFT flows on (b)'s
   learnt model (6 synthetic frames at 64x96, every setting at its
   default): a static share strictly between 0 and 1, the alignment's
   loss falling; each stage against the port on the CPU on the same
   inputs (the pair predictions and the flows within 1e-4 x max|CPU|;
   given the card's predictions and flows, the alignment's objective at
   its start, flow term on, within 1e-4 relative, its masks bitwise).
   (d) ``fit(mesh=make_mesh(data=2))`` on two gloo ranks sharing the
   card (``stage1_fit_rank``; not a scaling number): (d1) TINY on (b)'s
   data and recipe for 1 epoch (Adam eps 1e-2) against the one-rank
   ``fit`` on the card: the history's losses within 1e-4 relative, the
   mask heads within 1e-4 x max|one rank|, both ranks' parameters and
   AdamW state bitwise equal, rank 1 writing no file; (d2) (a)'s recipe
   at full width, a global batch of 8 (4 rows a rank), 3 steps: the
   step ms, the ``stage1_grads`` all-reduce's bytes and calls a step,
   each rank's render seconds against the one-rank render of the same
   samples, and each rank's peak memory.
20. quality: ``scripts/torch_quality_e2e.py``'s ``main`` on ``cuda``, the
   end-to-end path of synthetic stage-1 artifacts or the stage-1
   predictor, the rearrange bridge and the stage-2 trainer with the
   (i+5)%10 split, the PSNR-gated camera Adam and the test-pose protocol.
   The predictor branch at ``QUALITY_r05_predictor.json``'s recipe (12
   frames at 96x128, 2000 iterations) on the TINY weights (b) trained:
   stage-1 mask IoU >= 0.7, masked test PSNR >= 30 dB. The gt branch at
   ``QUALITY_r05.json``'s size (16 frames at 144x192, pose noise 0.02 of
   seed 11, PSNR gate 26) for 3,200 iterations: ``ate_init`` JAX's
   0.02549, ``ate_final`` no higher, PSNR >= 30 dB. Each: every loss
   finite, D and F launched by the probe, A, B and C once a training
   step, B and C once a test-pose step; prints the record beside JAX's,
   the seconds, the ms an iteration and the launches by stage. Each
   branch runs in a process of its own, started by stage1_train: the gt
   branch beside (b), the predictor branch once (b) has saved its
   weights, beside the suite's process and (c), (e).
21. suite: ``scripts/torch_run_benchmark_suite.py``'s ``main`` on
   ``cuda`` in a process of its own (beside the predictor branch), mode
   by mode, each with its launches counted from 0. Two
   synthetic scenes named from ``harness.DAVIS_SCENES`` (12 frames at
   96x128, rearranged, GT dynamic masks in the DAVIS layout): ``psnr``
   (300 iterations each, ``--gt_dynamic_mask``), each scene in the table,
   finite and equal to its ``test_log.txt``'s last line; ``render`` on
   the first (300 iterations on every frame, the video), one video frame
   a view; ``masks`` on stage 1 of (b)'s TINY weights for those scenes
   (size 64, 50 alignment iterations), ``mean_J`` in [0, 1] and equal to
   a numpy recount; ``pose`` on a synthetic 8-frame ``tum`` sequence at
   288x512 with the pipeline phase's DUST3R_LARGE ``.pth``, a finite ATE.
   Launches: A, B and C once a training step and B, C once a test-pose
   step of ``psnr`` and ``render``, D and F in their probes, none of A-F
   in ``masks`` (its stage 1 included) or ``pose``.

Then the ``kernels`` line (A, B, C, B-bf16 and C-bf16 at the trainer
scene with their random-scene numbers under ``random_scene``; B, C, D and
E with their tile-range numbers under ``tile_range``; D, E, F at the
trainer scene; launches by path, the viewer's, stage 1's, the pipeline's,
the bf16 steps', the sharded steps' of both paths, stage-1
training's, the quality runs' and the suite's modes' included), the
``nvidia-smi`` line, and
last the device line. Each phase's line carries ``at_s``, the seconds
since the script started. Everything it
writes lives under ``build/`` and is removed at exit (the kernel
libraries stay cached in ``build/torch_ext/``). The package is imported
from this script's own checkout, so the script fails, having printed
nothing, when it stands alone.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

N_GAUSSIANS = 1_500_000
HEIGHT, WIDTH = 288, 512
N_FRAMES = 8
SH_DEGREE = 3
SEED = 0
BLEND_TOL = 2e-4

# Published peaks of one H100 SXM at its full 700 W limit: HBM bandwidth
# and FP32 rate (NVIDIA data sheet); exp runs on the special-function
# units, 16 results per clock per SM (CUDA programming guide throughput
# table, compute capability 9.0) x 132 SMs x 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
BLEND_FLOP_PER_EVAL = 15     # power, alpha, the tests and the T update
# blend_backward per evaluation: power and alpha (~12), T restore, w,
# gC . c, dalpha and S (~13), the nine gradient terms (~30); on the
# special-function units the exp and the reciprocals of three divisions
BLEND_BWD_FLOP_PER_EVAL = 55
BLEND_BWD_SFU_PER_EVAL = 4
GRAD_TOL = 2e-5              # x max|g|: the JAX gradient bar
TRAIN_STEPS = 10
# window_blend_backward per evaluation: the replay (~15) and the backward
# (~40) FP32 operations; on the special-function units two exps and the
# reciprocals of two divisions
WINDOW_BWD_FLOP_PER_EVAL = 55
WINDOW_BWD_SFU_PER_EVAL = 4
TRAINER_FRAMES = 12          # eval mode holds out one: 11 train frames
TRAINER_ITERS = 44           # 4 epochs of the 11 train frames
K_CEILING = 16384            # the trainer's max_per_tile regrow ceiling
STAGE1_FRAMES = 16           # the JAX package's quality-harness length
STAGE1_EDGES = 110           # swinstride-5-noncyclic over 16, symmetrized
# x max|CPU| per map: one pair of DUST3R_LARGE_CONFIG on the card against
# the same model on the CPU, TF32 off
STAGE1_CPU_BAR = 1e-4
STAGE1_CPU_PAIRS = 1         # of the runner's first decode batch, held
                             # against the CPU (each takes seconds there)
STAGE1_BF16_MASK_MEAN = 0.05      # the JAX package's bf16 bars
STAGE1_BF16_PTS_MEDIAN_REL = 0.1
PIPELINE_FRAMES = 8
PIPELINE_SIZE = 256          # 144x256 frames: build_scene's k-NN ~3 s
PIPELINE_ITERS = 20
SHARDED_RANGES = (2, 4, 5)   # tile ranges of view 0; 5 leaves 4 padded
# x max|g| per column group: the ranges' summed g_table against the
# whole-image C (both add with atomics, in orders that differ)
RANGE_GRAD_TOL = 1e-6
SHARDED_STEPS = 3
WINDOW_RANGES = (2, 4)       # window-row ranges of view 0 (kernels D, E)
QDEPTH_BITS = 22             # the JAX test's quantized-depth keys
QDEPTH_CPU_TILES = 3         # tile rows of the CPU's quantized-depth check
FLOW_SEED = SEED + 12        # the flow networks' random weights
FLOW_CHUNK = 12              # edges per flow forward call (flow.py)
FLOW_CPU_BAR = 1e-4          # x max|CPU|: tests/test_torch_flow.py's bar
SEARAFT_CHECK_ITERS = 1      # the iterations that bar holds SEA-RAFT at
SHARDED_TIMEOUT = 360        # s, both ranks, start-up included
# stage-1 training at full width: the DAS3R recipe (Stage1TrainConfig's
# defaults) on PointOdyssey's training resolution (JAX datasets.py:112),
# batch 8 a GPU (DAS3R_b32_g4.sh; JAX training.py:12)
S1T_RES = (512, 288)         # (W, H)
S1T_BATCH = 8
S1T_EPOCHS, S1T_STEPS = 2, 4  # steps an epoch
S1T_BCE_STEPS = 5
# TINY from scratch: scripts/torch_train_tiny_stage1.py with the arguments
# of JAX's record, docs/tiny_stage1_iou_r5.json (held-out IoU 0.8733)
TINY_ARGV = ("--epochs", "60", "--n_train", "256", "--n_test", "32",
             "--resolution", "64", "48", "--lr", "1e-3", "--freeze", "none")
TINY_IOU_BAR = 0.7           # the bar JAX's record cleared (vs_baseline)
JAX_TINY_IOU = 0.8733
# card against CPU, 3 TINY steps: losses and mask-head parameters within
# STAGE1_CPU_BAR x max|ref|. Adam's first update is lr x sign(g), which
# float rounding flips where a gradient is ~0; the parameters are held
# where the update is a smooth function of the gradient (eps 1e-2), as
# tests/test_torch_stage1_training.py holds them against JAX
S1T_CPU_STEPS = 3
S1T_CPU_BATCH = 2            # pairs: the CPU's steps of the 72M-parameter
                             # TINY (DPT heads) take seconds each
S1T_SMOOTH_EPS = 1e-2
POSE_FRAMES = 8
POSE_ITERS = 50
# (d) fit(mesh=make_mesh(data=2)) on two gloo ranks sharing the card
S1T_DP_EPOCHS = 1            # (d1): TINY, (b)'s data and recipe
S1T_DP_BAR = 1e-4            # losses rel., mask heads x max|one rank|
S1T_DP_STEPS = 3             # (d2): full width, global batch S1T_BATCH
S1T_DP_TIMEOUT = 420         # s, both ranks, start-up included
# (e) stage 1 with RAFT flows on (b)'s learnt TINY weights
LEARNT_FRAMES = 6            # at 48x64, run at size 96 (64x96 frames:
LEARNT_SIZE = 96             # RAFT's 1/8 maps of 8 rows)
LEARNT_BAR = 1e-4            # x max|CPU|: the runner's end-to-end bar
# the quality phase: scripts/torch_quality_e2e.py at the recipes of the
# JAX package's records, QUALITY_r05_predictor.json (on (b)'s weights) and
# QUALITY_r05.json; the gt branch at 3,200 of the record's 4,000 iterations
# (the script's time limit), past the SH-degree bump at 3000 and ending in
# the test-pose protocol
QUALITY_PREDICTOR = dict(frames=12, height=96, width=128, iters=2000)
QUALITY_GT = dict(frames=16, height=144, width=192, iters=3200,
                  pose_noise=0.02, noise_seed=11, psnr_threshold=26.0)
JAX_QUALITY = {"predictor": dict(psnr=48.564, stage1_mask_iou=0.7724,
                                 stage1_ate=0.0713),
               "gt": dict(psnr=37.854, ate_init=0.02549, ate_final=0.02489)}
QUALITY_PSNR_BAR = 30.0      # dB: the script's PSNR_BAR_DB
QUALITY_TIMEOUT = 600        # s, each branch's process, start-up included
TINY_TIMEOUT = 900           # s, (b)'s process, start-up included
# the suite phase: scripts/torch_run_benchmark_suite.py on synthetic scenes
# named from harness.DAVIS_SCENES, in the DAVIS layouts, at the quality
# predictor branch's size; its pose mode on a tum sequence at full size
SUITE_SCENES = 2
SUITE = dict(frames=12, height=96, width=128, iters=300)
SUITE_POSE_FRAMES = 8        # at HEIGHT x WIDTH
SUITE_STAGE1_SIZE = 64       # the masks' stage 1: TINY at its 64x48
# table columns by what they hold
GROUPS = {"mean2d": [0, 1], "conic": [2, 3, 4], "color": [5, 6, 7],
          "opacity": [8]}
# a kernel's numbers on a phase's line and beside the other scene's
# the bf16 table's image against the f32 one: JAX's envelope
# (tests/test_entry_stream.py:293-294), on JAX's test background
BF16_ENV_MAX, BF16_ENV_MEAN = 1.5e-2, 1e-3
BF16_BG = (0.2, 0.3, 0.1)
BF16_SUMMARY_KEYS = ("max_abs_err", "max_abs_err_with_n_last",
                     "err_over_max_g", "image_err_vs_f32", "ms", "device_ms",
                     "f32_ms", "f32_device_ms", "device_ms_turns",
                     "plain_ms", "bound_ms", "bound_by", "n_last_agrees")
SUMMARY_KEYS = ("max_abs_err", "err_over_max_g", "ms", "device_ms",
                "device_ms_calls", "device_ms_kernels", "device_ms_sessions",
                "ms_with_n_last", "plain_ms", "library_ms",
                "library_device_ms", "library_device_ms_calls",
                "library_device_ms_kernels", "library_device_ms_sessions",
                "bound_ms", "bound_by", "n_last_agrees", "tile_spread",
                "blocks_per_sm")


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One phase's JSON line; ``at_s``: the seconds since the script
    started, where the phase ended."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - T_START}), flush=True)


def time_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up:
    a wrapper's time, its host work included."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# the host calls that put work on the card, each one device record
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


def device_ms(fn, kernel: str | None = None, key: str = "device_ms",
              reps: int = 10, max_sessions: int = 20) -> dict:
    """``{key: ms, key_calls: n, key_kernels: k, key_launches: l,
    key_sessions: s}``: the median over ``reps`` whole calls of ``fn``
    (after one warm-up) of the device time ``torch.profiler`` records (the
    CUDA kernel whose name contains ``kernel`` alone, or, with None, every
    kernel, copy and fill that the call launches), the calls it is over,
    the device records and host launches in each and the profiler
    sessions it took.

    Sessions of ``reps`` calls each run until ``reps`` whole calls were
    seen: on the H100 machine, late in a long process, a session kept the
    device records of only its last few calls, and a range once held one
    record more than its launches. A call is whole when its record is
    there (``kernel``), or when its range holds the most host launches of
    any range of ``fn`` and the number of device records that most of
    those ranges hold, of the numbers within 10% (at least one) of the
    largest (a session that lost records holds fewer). A launch through ``kernels.launch``
    (ctypes) makes a record that the profiler links to no host operation,
    so a call holds as many records as launches less its ctypes launches
    (the exact window binning: 80 launches, 77 records), and its
    ``device_ms`` leaves out those kernels' time; the range's own
    annotation on the device's timeline is not a launch and is left
    out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    RANGE = "device_ms.call"

    def tally(e):
        """(host launches, device records, their device us) within e"""
        recs = [k for k in e.kernels if k.name != RANGE]
        out = [int(e.name.startswith(LAUNCH_CALLS)), len(recs),
               sum(k.duration for k in recs)]
        for c in e.cpu_children:
            out = [a + b for a, b in zip(out, tally(c))]
        return out

    fn()
    torch.cuda.synchronize()
    ranges: list[tuple[int, int, float]] = []
    for session in range(1, max_sessions + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                with record_function(RANGE):
                    fn()
            torch.cuda.synchronize()
        events = prof.events()
        if kernel is not None:
            ranges += [(1, 1, e.device_time_total) for e in events
                       if e.device_type == DeviceType.CUDA
                       and kernel in e.name]
        else:
            ranges += [tuple(tally(e)) for e in events
                       if e.device_type == DeviceType.CPU and e.name == RANGE]
        full = max((n for n, _, _ in ranges), default=0)
        counts = collections.Counter(k for n, k, _ in ranges if n == full)
        top = max(counts, default=0)
        recs = max((k for k in counts if k >= top - max(1, top // 10)),
                   key=lambda k: (counts[k], k), default=0)
        times = [t for n, k, t in ranges if n == full > 0 and k == recs]
        if len(times) >= reps:
            return {key: statistics.median(times[:reps]) / 1e3,
                    f"{key}_calls": reps, f"{key}_kernels": recs,
                    f"{key}_launches": full, f"{key}_sessions": session}
    seen = sorted({(e.name[:60], str(e.device_type)) for e in events})
    raise AssertionError(
        f"{max_sessions} profiler sessions saw {len(times)} whole calls of "
        f"{kernel or 'the call'} ((launches, records) per range: "
        f"{dict(collections.Counter((n, k) for n, k, _ in ranges))}): "
        f"{seen[:40]}")


def bound(nbytes: float, ops_seconds: float = 0.0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    if ops_seconds > t_bytes:
        return ops_seconds * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def prefix_bytes(es, need, row_bytes):
    """Bytes of the ranks and distinct table rows in each tile's first
    ``need[t]`` slots: what a walk over those prefixes must read."""
    import torch
    dev = need.device
    tiles = torch.repeat_interleave(torch.arange(need.numel(), device=dev),
                                    need)
    first = torch.cumsum(need, 0) - need
    slots = (es.astart.long()[tiles] + torch.arange(tiles.numel(), device=dev)
             - first[tiles])
    rows = int(torch.unique(es.rank[slots]).numel())
    return slots.numel(), slots.numel() * 4 + rows * row_bytes


KERNELS = ("extract_chunks", "blend_forward", "blend_backward",
           "blend_forward_bf16", "blend_backward_bf16", "extract_windows",
           "window_blend_forward", "window_blend_backward", "dup_count",
           "dup_emit")
# every binning but the quantized-depth windows' builds its table with these
DUP = ("dup_count", "dup_emit")


def kernel_launches() -> dict:
    """{kernel: launches so far} of every kernel (the program's
    ``launch/<kernel>`` counters)."""
    from das3r_tpu_torch.utils import trace
    got = trace.counters("launch/")
    return {k: got.get("launch/" + k, 0) for k in KERNELS}


def launches_since(before: dict) -> dict:
    """{kernel: launches} since ``before`` (a ``kernel_launches()``)."""
    return {k: v - before[k] for k, v in kernel_launches().items()}


def run_counted(fn):
    """(fn(), {kernel: launches during the call})."""
    before = kernel_launches()
    out = fn()
    return out, launches_since(before)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    smi = smi.splitlines()[torch.cuda.current_device()]
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def blocks_per_sm(lib, name: str, arg: int = 128) -> int | None:
    """Blocks of kernel ``name`` resident per SM, from the CUDA occupancy
    calculator, where its library reports it (``arg``: the window kernels'
    chunk; for kernel B, 1 with n_last and 0 without)."""
    import ctypes
    fn = getattr(lib, f"{name}_blocks_per_sm", None)
    if fn is None:
        return None
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(arg)


def b_blocks_per_sm() -> dict:
    """Kernel B's blocks per SM: serving (no n_last) and training."""
    from das3r_tpu_torch.ops.splat import kernels
    lib = kernels.library("blend_forward")
    return {"serve": blocks_per_sm(lib, "blend_forward", 0),
            "train": blocks_per_sm(lib, "blend_forward", 1)}


def phase_build():
    from das3r_tpu_torch.ops.splat import kernels
    t0 = time.perf_counter()
    built = kernels.build_all()
    # each entry function's name, then its registers and spills
    ptxas = {name: [ln.strip() for ln in b["log"].splitlines()
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln]
             for name, b in built.items()}
    occupancy = {name: blocks_per_sm(kernels.library(name), name)
                 for name in kernels.SIGNATURES}
    occupancy["blend_forward"] = b_blocks_per_sm()
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas,
         blocks_per_sm={k: v for k, v in occupancy.items() if v is not None})


def phase_scene():
    """Stage-1 dir -> rearranged scene; random 1.5M-Gaussian checkpoint."""
    import numpy as np
    from das3r_tpu_torch.data import ply, readers, rearrange, synthetic

    t0 = time.perf_counter()
    if WORK.exists():
        shutil.rmtree(WORK)
    stage1, scene, model = WORK / "stage1", WORK / "scene", WORK / "model"
    synthetic.make_synthetic_stage1_dir(str(stage1), n_frames=N_FRAMES,
                                        height=HEIGHT, width=WIDTH, seed=SEED)
    rearrange.rearrange_scene(str(stage1), str(scene))
    data = readers.load_scene(str(scene))

    params, _, _ = synthetic.random_gaussian_scene(
        N_GAUSSIANS, n_frames=N_FRAMES, height=HEIGHT, width=WIDTH,
        seed=SEED, sh_degree=SH_DEGREE, device="cpu")
    rng = np.random.default_rng(SEED + 1)
    f_rest = rng.normal(0.0, 0.05, params.features_rest.shape)
    conf = rng.uniform(0.5, 1.0, N_GAUSSIANS)
    ply.write_gaussians(
        str(model / "point_cloud" / "iteration_1" / "point_cloud.ply"),
        xyz=params.xyz.numpy(), f_dc=params.features_dc.numpy(),
        f_rest=f_rest.astype(np.float32),
        opacity_logit=params.opacity.numpy(),
        conf_per_gaussian=conf.astype(np.float32),
        scaling=params.scaling.numpy(), rotation=params.rotation.numpy())
    # the stage-1 poses as the trained w2c poses
    (model / "pose").mkdir(parents=True)
    w2c = np.linalg.inv(data.poses_c2w.astype(np.float64))
    np.save(model / "pose" / "pose_1.npy", w2c.astype(np.float32))
    emit("scene", seconds=time.perf_counter() - t0, n_gaussians=N_GAUSSIANS,
         height=data.height, width=data.width, frames=data.n_frames)
    return scene, model, data


def view0_prep(model: Path, data, settings, dev):
    """Preprocess view 0 of the checkpoint as ``render`` does."""
    import numpy as np
    import torch
    from das3r_tpu_torch.eval.render_tool import load_gaussians_ply
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.ops.splat.preprocess import preprocess
    from das3r_tpu_torch.utils.quat import w2c_to_pose

    params, _, conf = load_gaussians_ply(
        str(model / "point_cloud" / "iteration_1" / "point_cloud.ply"),
        SH_DEGREE, dev)
    w2c = np.load(model / "pose" / "pose_1.npy")
    pose = w2c_to_pose(torch.as_tensor(w2c, device=dev))[0]
    xyz_cam, rot_cam = render_mod._camera_frame_gaussians(params, pose)
    view, proj, campos, tfx, tfy = render_mod._raster_common(
        float(data.fovx[0]), float(data.fovy[0]), dev)
    opacity = torch.sigmoid(params.opacity) * conf[:, None]
    return preprocess(
        xyz_cam, opacity, settings, viewmatrix=view, projmatrix=proj,
        campos=campos,
        shs=torch.cat([params.features_dc, params.features_rest], 1),
        scales=torch.exp(params.scaling), rotations=rot_cam,
        tan_fovx=tfx, tan_fovy=tfy)


def entry_kernel_parity(prep, settings, dev):
    """Kernels A, B and C against their plain versions on one view's entry
    stream (``prep`` binned with ``settings``), timed and bounded at its
    shapes. Returns (results, the stream's sizes)."""
    import numpy as np
    import torch
    from das3r_tpu_torch.ops.splat import binning, entry_blend

    n = prep.depth.shape[0]
    es = binning.bin_entry_stream(prep, settings)
    attr = torch.cat([prep.mean2d, prep.conic, prep.color,
                      prep.opacity[:, None]], 1)
    table = torch.cat([attr[es.order], torch.zeros_like(attr[:1])]
                      ).contiguous()
    ks = binning._sorted_key_stream(prep, settings)
    keys = ks.sorted_packed
    results = []

    # --- kernel A: extract_chunks -------------------------------------
    lay = binning.chunk_layout(keys, ks.nbits, settings,
                               binning.entry_stream_cap(settings, n))
    src0, nlive = lay.src0, lay.nlive
    got = binning.extract_chunks(keys, src0, nlive, ks.nbits, n)
    want = binning.extract_chunks_plain(keys, src0, nlive, ks.nbits, n)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"extract_chunks differs on {bad} slots")
    if not torch.equal(got, es.rank):
        raise AssertionError("extract_chunks disagrees with the stream")
    # the library call computes A's function: gather, decode, clamp, dead
    # lanes, int32
    lane = torch.arange(binning.CHUNK, device=dev)
    idx = torch.clamp_max(src0[:, None] + lane, max(keys.numel() - 1, 0)
                          ).reshape(-1)
    live_lane = (lane < nlive[:, None]).reshape(-1)
    mask = (1 << ks.nbits) - 1

    def library():
        return torch.where(live_lane, torch.clamp_max(keys[idx] & mask, n - 1),
                           n).to(torch.int32)

    if not torch.equal(library(), got):
        raise AssertionError("extract_chunks' library call differs")
    nbytes = (keys.numel() * 8 + src0.numel() * 8 + nlive.numel() * 4
              + got.numel() * 4)
    b_ms, b_by = bound(nbytes)

    def kernel():
        return binning.extract_chunks(keys, src0, nlive, ks.nbits, n)
    results.append(dict(
        name="extract_chunks", route="cuda",
        source="das3r_tpu_torch/csrc/extract_chunks.cu",
        replaces="das3r_tpu/ops/splat/binning.py:563",
        max_abs_err=0.0, ms=time_ms(kernel),
        **device_ms(kernel, "extract_chunks_kernel"),
        plain_ms=time_ms(lambda: binning.extract_chunks_plain(
            keys, src0, nlive, ks.nbits, n)),
        library_ms=time_ms(library),
        **device_ms(library, key="library_device_ms"),
        library_call="torch.where(live, torch.clamp_max(keys[idx] & mask, "
                     "n - 1), n).to(torch.int32)",
        bound_ms=b_ms, bound_by=b_by,
        slots=got.numel(), live_slots=int(nlive.sum()), bytes=nbytes))

    # --- kernel B: blend_forward --------------------------------------
    cpre, tfinal = entry_blend.blend_forward(table, es.rank, es.astart,
                                             es.count, settings)
    plain = entry_blend.blend_forward_plain(table, es.rank, es.astart,
                                            es.count, settings)
    torch.cuda.synchronize()
    err = torch.cat([(cpre - plain.cpre).abs().reshape(-1),
                     (tfinal - plain.tfinal).abs().reshape(-1)])
    max_err, mean_err = float(err.max()), float(err.mean())
    if not max_err <= BLEND_TOL:
        raise AssertionError(f"blend_forward max err {max_err} > {BLEND_TOL}")
    n_eval = int(plain.n_eval.sum())
    live = int(es.count.sum())
    # The serial loops need a prefix of each tile's list: as long as its
    # longest-running pixel's. Those slots' ranks and table rows are the
    # bytes this run's data needs.
    n_slots, pre_bytes = prefix_bytes(es, plain.n_eval.amax(1),
                                      entry_blend.N_ATTR * 4)
    nbytes = (pre_bytes + es.astart.numel() * 4 + es.count.numel() * 4
              + cpre.numel() * 4 + tfinal.numel() * 4)
    ops_s = max(n_eval * BLEND_FLOP_PER_EVAL / FP32_FLOP_PER_S,
                n_eval / SFU_OPS_PER_S)
    b_ms, b_by = bound(nbytes, ops_s)
    # one block per tile: the entries of each tile's list, and its longest
    # pixel run (the serial chain that ends the block)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    spread = dict(entries=tile_spread(es.count.long(), n_sm),
                  longest_pixel_run=tile_spread(plain.n_eval.amax(1), n_sm))
    results.append(dict(
        name="blend_forward", route="cuda",
        source="das3r_tpu_torch/csrc/blend_forward.cu",
        replaces="das3r_tpu/ops/splat/entry_blend.py:145",
        max_abs_err=max_err, mean_abs_err=mean_err,
        plain_ms=time_ms(lambda: entry_blend.blend_forward_plain(
            table, es.rank, es.astart, es.count, settings)),
        library_ms=None, library_device_ms=None, bound_ms=b_ms, bound_by=b_by,
        entries=live, entries_needed=n_slots,
        pixel_entry_evals=n_eval,
        evals_if_no_saturation=live * settings.tile * settings.tile,
        chunks_skipped=plain.chunks_skipped, tile_spread=spread,
        blocks_per_sm=b_blocks_per_sm(), bytes=nbytes))

    # the training forward: the same kernel, also writing n_last
    def fwd(for_backward):
        return entry_blend.blend_forward(table, es.rank, es.astart,
                                         es.count, settings, for_backward)

    cpre_n, tfinal_n, n_last = fwd(True)
    torch.cuda.synchronize()
    err_n = max(float((cpre_n - plain.cpre).abs().max()),
                float((tfinal_n - plain.tfinal).abs().max()))
    if not err_n <= BLEND_TOL:
        raise AssertionError(f"blend_forward with n_last: max err {err_n}")
    # timed in turns, n_last off, on, on, off: one call's noise is larger
    # than the difference
    turns = [time_ms(lambda b=b: fwd(b)) for b in (False, True, True, False)]
    results[-1].update(
        ms=(turns[0] + turns[3]) / 2, ms_with_n_last=(turns[1] + turns[2]) / 2,
        **device_ms(lambda: fwd(False), "blend_forward_kernel"),
        ms_turns_off_on_on_off=turns, max_abs_err_with_n_last=err_n,
        n_last_agrees=float((n_last == plain.n_last).float().mean()))

    # --- kernel C: blend_backward -------------------------------------
    gen = np.random.default_rng(SEED + 4)
    g_cpre = torch.as_tensor(gen.normal(size=tuple(cpre.shape)).astype(
        np.float32), device=dev)
    g_tfinal = torch.as_tensor(gen.normal(size=tuple(tfinal.shape)).astype(
        np.float32), device=dev)
    bwd_args = (table, es.rank, es.astart, es.count, settings)
    got = entry_blend.blend_backward(*bwd_args, tfinal_n, n_last, g_cpre,
                                     g_tfinal)
    want = entry_blend.blend_backward_plain(
        *bwd_args, plain.tfinal, plain.tin, g_cpre, g_tfinal).g_table
    torch.cuda.synchronize()
    rel = {k: float((got[:, c] - want[:, c]).abs().max()
                    / want[:, c].abs().max()) for k, c in GROUPS.items()}
    if not (torch.isfinite(got).all() and max(rel.values()) <= GRAD_TOL):
        raise AssertionError(f"blend_backward err / max|g| {rel} > "
                             f"{GRAD_TOL}")
    evals = int(n_last.sum())
    # The walk visits each tile's list up to its largest n_last; every
    # pixel tests the entries before its own n_last.
    n_slots, pre_bytes = prefix_bytes(es, n_last.amax(1).long(),
                                      entry_blend.N_ATTR * 4)
    nbytes = (pre_bytes + (n_last.numel() + es.astart.numel()
                           + es.count.numel()) * 4
              + (tfinal.numel() + g_cpre.numel() + g_tfinal.numel()) * 4
              + got.numel() * 4)
    ops_s = max(evals * BLEND_BWD_FLOP_PER_EVAL / FP32_FLOP_PER_S,
                evals * BLEND_BWD_SFU_PER_EVAL / SFU_OPS_PER_S)
    b_ms, b_by = bound(nbytes, ops_s)
    results.append(dict(
        name="blend_backward", route="cuda",
        source="das3r_tpu_torch/csrc/blend_backward.cu",
        replaces="das3r_tpu/ops/splat/entry_blend.py:237",
        max_abs_err=float((got - want).abs().max()),
        err_over_max_g=rel,
        ms=time_ms(lambda: entry_blend.blend_backward(
            *bwd_args, tfinal_n, n_last, g_cpre, g_tfinal)),
        **device_ms(lambda: entry_blend.blend_backward(
            *bwd_args, tfinal_n, n_last, g_cpre, g_tfinal),
            "blend_backward_kernel"),
        plain_ms=time_ms(lambda: entry_blend.blend_backward_plain(
            *bwd_args, plain.tfinal, plain.tin, g_cpre, g_tfinal)),
        library_ms=None, library_device_ms=None, bound_ms=b_ms, bound_by=b_by,
        pixel_entry_evals=evals, entries_needed=n_slots,
        max_n_last=int(n_last.max()), bytes=nbytes))
    results += dup_kernel_parity(prep, settings, ks)
    sizes = dict(n_gaussians=n, entries=live, stream_slots=es.rank.numel(),
                 max_tile_entries=int(es.count.max()),
                 entry_overflow=int(es.entry_overflow))
    return results, sizes


def dup_kernel_parity(prep, settings, ks):
    """``dup_count`` and ``dup_emit`` against their plain version (the
    dense duplication table, run on the card) on one view's ``prep``: the
    keys bitwise (in order on the full-width table, as a set on the split
    table, whose plain version emits two tables) and ``heavy_overflow``;
    timed, with each kernel's bound. Two rows: ``ms`` (the wrapper, its
    scan and its read of the total included) and ``plain_ms`` on the
    first."""
    import torch
    from das3r_tpu_torch.ops.splat import binning

    n = prep.depth.shape[0]
    split = binning.uses_split_table(settings)

    def kernel():
        return binning.dup_keys(prep, ks.order, ks.nbits, settings)

    def plain():
        return binning.dup_keys_plain(prep, ks.order, ks.nbits, settings)
    (keys, heavy, total), counts = run_counted(kernel)
    want, want_heavy = plain()
    torch.cuda.synchronize()
    if counts["dup_count"] != 1 or counts["dup_emit"] != 1:
        raise AssertionError(f"dup_keys launched {counts}")
    same = (torch.equal(torch.sort(keys).values, torch.sort(want).values)
            if split else torch.equal(keys, want))
    if not (same and int(total) == want.numel()
            and int(heavy) == int(want_heavy)):
        raise AssertionError(f"dup_keys: {keys.numel()} keys against the "
                             f"plain version's {want.numel()}, heavy "
                             f"overflow {int(heavy)} against "
                             f"{int(want_heavy)}, equal: {same}")
    if (settings.max_total_entries is None
            and not torch.equal(torch.sort(keys).values, ks.sorted_packed)):
        raise AssertionError("dup_keys disagrees with the sorted stream")
    # per row: the index, rect_min, rect_max, ntt, binnable, mean2d,
    # conic, q_cap (and h_pos); count writes 4 B, emit reads the count and
    # the scan and writes 8 B a key
    row = 8 + 8 + 8 + 4 + 1 + 8 + 12 + 4 + (8 if split else 0)
    count_bytes = n * (row + 4)
    emit_bytes = n * (row + 4 + 8) + keys.numel() * 8
    common = dict(source="das3r_tpu_torch/csrc/dup_keys.cu",
                  replaces="none: das3r_tpu/ops/splat/binning.py:"
                           "_sorted_key_stream's jnp table (XLA-fused)",
                  route="cuda", max_abs_err=0.0, library_ms=None,
                  library_device_ms=None, rows=n, keys=keys.numel(),
                  split_table=split)
    c_ms, c_by = bound(count_bytes)
    e_ms, e_by = bound(emit_bytes)
    return [
        dict(name="dup_count", ms=time_ms(kernel),
             **device_ms(kernel, "dup_count_kernel"),
             plain_ms=time_ms(plain), **device_ms(plain, key="plain_device_ms"),
             bound_ms=c_ms, bound_by=c_by, bytes=count_bytes, **common),
        dict(name="dup_emit", **device_ms(kernel, "dup_emit_kernel"),
             bound_ms=e_ms, bound_by=e_by, bytes=emit_bytes, **common)]


def summary(results):
    return {r["name"]: {k: r[k] for k in SUMMARY_KEYS if k in r}
            for r in results}


def phase_parity(model: Path, data, settings, dev):
    """Kernels A, B, C against their plain versions at the serving path's
    shapes: view 0 of the random scene."""
    t0 = time.perf_counter()
    prep = view0_prep(model, data, settings, dev)
    results, sizes = entry_kernel_parity(prep, settings, dev)
    emit("parity", seconds=time.perf_counter() - t0, **sizes,
         kernels=summary(results))
    return results


def phase_reference(dev):
    """Small scene: the card's render and training gradients equal the
    port's on the CPU."""
    import dataclasses

    import numpy as np
    import torch
    from das3r_tpu_torch.data import synthetic
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.models.gaussians import GaussianParams
    from das3r_tpu_torch.ops.splat import RasterSettings
    from das3r_tpu_torch.train.loss import photometric_loss

    t0 = time.perf_counter()
    params, meta, poses = synthetic.random_gaussian_scene(
        2000, n_frames=1, height=64, width=96, seed=SEED + 2,
        sh_degree=SH_DEGREE, device="cpu")
    rng = np.random.default_rng(SEED + 3)
    params.features_rest = torch.as_tensor(rng.normal(
        0.0, 0.05, params.features_rest.shape).astype(np.float32))
    s = RasterSettings(image_height=64, image_width=96, sh_degree=SH_DEGREE,
                       max_tiles_per_gaussian=32)
    bg = torch.tensor([0.1, 0.2, 0.3])
    imgs = {d: render_mod.render(
        params, meta, s, poses.pose(0), bg, 1.0, 1.0, mode="no_soft",
        device=d).image.cpu() for d in ("cpu", dev)}
    err = float((imgs["cpu"] - imgs[dev]).abs().max())
    if not (torch.isfinite(imgs[dev]).all() and err <= 2e-4):
        raise AssertionError(f"card render differs from CPU render: {err}")

    # the gradients of the training loss, every parameter field and the
    # pose, on the card against the CPU
    gt = torch.as_tensor(np.random.default_rng(SEED + 5).uniform(
        0, 1, (3, 64, 96)).astype(np.float32))
    grads = {}
    for d in ("cpu", dev):
        p = GaussianParams(**{f.name: getattr(params, f.name).detach()
                              .to(d).requires_grad_(True)
                              for f in dataclasses.fields(params)})
        pose = poses.pose(0).detach().to(d).requires_grad_(True)
        out = render_mod.render(p, meta, s, pose, bg, 1.0, 1.0,
                                mode="train", device=d)
        loss = photometric_loss(out.image, gt.to(d), p.conf_static[0]).loss
        leaves = [getattr(p, f.name) for f in dataclasses.fields(p)]
        grads[d] = [g.cpu() for g in torch.autograd.grad(loss, leaves
                                                         + [pose])]
    names = [f.name for f in dataclasses.fields(params)] + ["pose"]
    rel = {k: float((a - b).abs().max() / b.abs().max())
           for k, a, b in zip(names, grads[dev], grads["cpu"])}
    if not max(rel.values()) <= GRAD_TOL:
        raise AssertionError(f"card gradients differ from CPU: {rel}")
    oracle = oracle_check(s, dev)
    emit("reference", seconds=time.perf_counter() - t0, max_abs_err=err,
         shape=list(imgs[dev].shape), grad_err_over_max_g=rel,
         oracle=oracle)


def oracle_check(s, dev) -> dict:
    """``rasterize`` on the card, entry stream and window path, against
    the float64 oracle (``ops/splat/reference.py``) on a scene of 800
    Gaussians in front of the identity camera: the image within 2e-4, the
    radii equal."""
    import numpy as np
    import torch
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.ops.splat import rasterize
    from das3r_tpu_torch.ops.splat.reference import rasterize_reference

    rng = np.random.default_rng(SEED + 13)
    n = 800
    z = rng.uniform(2.0, 6.0, n)
    means = np.stack([rng.uniform(-0.5, 0.5, n) * z,
                      rng.uniform(-0.35, 0.35, n) * z, z], 1)
    q = rng.normal(size=(n, 4))
    kw = dict(scales=rng.uniform(0.02, 0.15, (n, 3)),
              rotations=q / np.linalg.norm(q, axis=1, keepdims=True),
              colors_precomp=rng.uniform(0, 1, (n, 3)),
              bg=np.array([0.1, 0.2, 0.3]))
    kw = {k: v.astype(np.float32) for k, v in kw.items()}
    means, ops = means.astype(np.float32), rng.uniform(
        0.1, 0.9, (n, 1)).astype(np.float32)
    view, proj, campos, tfx, tfy = (
        x.numpy() for x in render_mod._raster_common(1.0, 1.0, "cpu"))
    cam = dict(viewmatrix=view, projmatrix=proj, campos=campos,
               tan_fovx=float(tfx), tan_fovy=float(tfy))
    ref, ref_radii = rasterize_reference(means, ops, s, **cam, **kw)
    covered = float((np.abs(ref - kw["bg"][:, None, None]).max(0)
                     > 0.01).mean())
    if covered < 0.5:
        raise AssertionError(f"the oracle scene covers {covered} of the "
                             f"image")
    out = {"covered": covered}
    for name, st in (("entry_stream", s),
                     ("window", dataclasses.replace(
                         s, entry_stream=False, max_per_tile=1024))):
        img, radii, aux = rasterize(means, ops, st, **cam, **kw, device=dev)
        err = float(np.abs(img.cpu().numpy() - ref).max())
        same_radii = bool(np.array_equal(radii.cpu().numpy(), ref_radii))
        if not (err <= BLEND_TOL and same_radii
                and int(aux.tile_overflow) == 0):
            raise AssertionError(f"{name} render against the f64 oracle: "
                                 f"{err}, radii equal {same_radii}")
        out[name] = dict(max_abs_err=err, radii_equal=same_radii)
    return out


def phase_main(scene: Path, model: Path, device=None):
    """The render tool over every view; returns each kernel's launches."""
    import numpy as np
    from PIL import Image
    from das3r_tpu_torch.eval import render_tool

    t0 = time.perf_counter()
    stats: list[dict] = []
    (_, paths), launches = run_counted(lambda: render_tool.render_sets(
        str(scene), str(model), iteration=1, stats=stats, device=device))
    seconds = time.perf_counter() - t0

    if len(paths) != N_FRAMES:
        raise AssertionError(f"{len(paths)} PNGs, expected {N_FRAMES}")
    for p in paths:
        arr = np.asarray(Image.open(p))
        if arr.shape != (HEIGHT, WIDTH, 3) or arr.min() == arr.max():
            raise AssertionError(f"{p}: shape {arr.shape}, constant image")
    for st in stats:
        if not st["finite"] or st["entry_overflow"] != 0:
            raise AssertionError(f"view {st['view']}: {st}")
    ms = [st["ms"] for st in stats]
    emit("main", seconds=seconds, views=len(paths),
         render_ms_median_views_2_8=statistics.median(ms[1:]),
         render_ms=ms, entries_per_view=[st["entries"] for st in stats],
         launches=launches)
    return launches


def profile_call(fn, top: int = 10):
    """One call of ``fn`` under ``torch.profiler`` (after a synchronize):
    (its wall ms, the device's busy ms and idle share, the kernel
    launches, the ``top`` kernels and host operators that took the most
    time; the profile). A ``das3r::`` range's device-side span is not a
    kernel and is left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kern = sorted((e for e in events if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("das3r::")),
                  key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    host = sorted((e for e in events if e.device_type == DeviceType.CPU
                   and not e.key.startswith("das3r::")),
                  key=lambda e: -e.self_cpu_time_total)
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms,
                kernel_launches=sum(e.count for e in kern),
                device_top=[dict(name=e.key[:100], calls=e.count,
                                 ms=e.self_device_time_total / 1e3)
                            for e in kern[:top]],
                host_top=[dict(name=e.key[:60], calls=e.count,
                               ms=e.self_cpu_time_total / 1e3)
                          for e in host[:top]]), prof


def phase_profile(model: Path, data, settings, dev):
    """View 1 once more, under torch.profiler, after the main phase."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from das3r_tpu_torch.eval.render_tool import load_gaussians_ply
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.utils.quat import w2c_to_pose

    params, meta, conf = load_gaussians_ply(
        str(model / "point_cloud" / "iteration_1" / "point_cloud.ply"),
        SH_DEGREE, dev)
    pose = w2c_to_pose(torch.as_tensor(
        np.load(model / "pose" / "pose_1.npy"), device=dev))[1]
    bg = torch.zeros(3, device=dev)

    def view1():
        return render_mod.render(params, meta, settings, pose, bg,
                                 float(data.fovx[1]), float(data.fovy[1]),
                                 mode="test", conf_per_gaussian=conf,
                                 device=dev)

    view1()
    summary, prof = profile_call(view1, top=8)
    # das3r:: ranges are the rasterizer's stages (ops/splat/rasterize.py,
    # binning.py); an operator's or a stage's device time is that of its
    # kernels.
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    stages = [e for e in host if e.key.startswith("das3r::")]
    ops = sorted((e for e in host if not e.key.startswith("das3r::")),
                 key=lambda e: -e.device_time_total)
    emit("profile", **summary,
         stages=[dict(name=e.key, host_ms=e.cpu_time_total / 1e3,
                      device_ms=e.device_time_total / 1e3) for e in stages],
         ops_top=[dict(name=e.key, calls=e.count,
                       device_ms=e.device_time_total / 1e3)
                  for e in ops[:12]])


def train_scene(data, dev):
    """The 1.5M-Gaussian scene of the serving phases, every SH band filled,
    with ``conf_static`` from the scene's dynamic maps and the stage-1
    poses and FoVs, as training parameters on ``dev``."""
    import numpy as np
    import torch
    from das3r_tpu_torch.data import synthetic
    from das3r_tpu_torch.models.gaussians import init_pose_params

    params, meta, _ = synthetic.random_gaussian_scene(
        N_GAUSSIANS, n_frames=N_FRAMES, height=HEIGHT, width=WIDTH,
        seed=SEED, sh_degree=SH_DEGREE, device=dev)
    rng = np.random.default_rng(SEED + 1)
    params.features_rest = torch.as_tensor(rng.normal(
        0.0, 0.05, tuple(params.features_rest.shape)).astype(np.float32),
        device=dev)
    params.conf_static = torch.as_tensor(
        1.0 - data.dyna_avg.astype(np.float32), device=dev)
    w2c = np.linalg.inv(data.poses_c2w.astype(np.float64)).astype(np.float32)
    poses = init_pose_params(w2c, float(data.fovx[0]), float(data.fovy[0]),
                             device=dev)
    return params, meta, poses


def phase_train(data, settings, dev, phase: str = "train"):
    """``train_step`` at full width over frames 0 and 1; returns each
    kernel's launches and what one more step needs. With
    ``settings.table_bf16`` the bf16 forms of B and C run."""
    import dataclasses
    import math

    import torch
    from das3r_tpu_torch.train import step as step_mod
    from das3r_tpu_torch.train.config import OptimizationConfig

    t0 = time.perf_counter()
    params, meta, poses = train_scene(data, dev)
    state = step_mod.init_train_state(params, poses)
    cfg = OptimizationConfig()
    gts = torch.as_tensor(data.images, device=dev)
    bg = torch.zeros(3, device=dev)

    def step(state, meta, uid):
        return step_mod.train_step(
            state, meta, uid, gts[uid], float(data.fovx[uid]),
            float(data.fovy[uid]), bg, settings, cfg, track_stats=True)

    setup_s = time.perf_counter() - t0
    before = kernel_launches()
    marks, metrics = [], []
    for i in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, meta, m = step(state, meta, i % 2)
        end.record()
        marks.append((start, end))
        metrics.append(m)
    torch.cuda.synchronize()
    launches = launches_since(before)
    ms = [a.elapsed_time(b) for a, b in marks]
    losses = [float(m.loss) for m in metrics]

    finite = all(math.isfinite(x) for x in losses)
    for opt in (state.opt, state.opt_cam):
        for group in (opt.mu, opt.nu):
            finite &= all(bool(torch.isfinite(getattr(group, f.name)).all())
                          for f in dataclasses.fields(group))
    for group in (state.params, state.poses):
        finite &= all(bool(torch.isfinite(getattr(group, f.name)).all())
                      for f in dataclasses.fields(group))
    finite &= bool(torch.isfinite(meta.xyz_grad_accum).all())
    if not finite:
        raise AssertionError(f"non-finite loss, gradient or parameter: "
                             f"losses {losses}")
    if int(state.opt.count) != TRAIN_STEPS or state.step != TRAIN_STEPS:
        raise AssertionError(f"Adam count {int(state.opt.count)}, step "
                             f"{state.step}, expected {TRAIN_STEPS}")
    dropped = sum(int(m.entry_overflow) for m in metrics)
    if dropped:
        raise AssertionError(f"{dropped} entries dropped")
    if not losses[TRAIN_STEPS - 2] < losses[0]:
        raise AssertionError(f"frame 0's loss did not fall: {losses}")
    # the entry-stream kernels once per step, the window path's never
    entry = ("extract_chunks",) + DUP + (
        ("blend_forward_bf16", "blend_backward_bf16") if settings.table_bf16
        else ("blend_forward", "blend_backward"))
    for name, count in launches.items():
        if count != (TRAIN_STEPS if name in entry else 0):
            raise AssertionError(f"{name} launched {count} times in "
                                 f"{TRAIN_STEPS} train steps")
    emit(phase, seconds=time.perf_counter() - t0, setup_seconds=setup_s,
         steps=TRAIN_STEPS, step_ms_median_steps_2_10=statistics.median(
             ms[1:]), step_ms=ms, losses=losses,
         psnr=[float(m.psnr) for m in metrics],
         cam_steps=int(state.opt_cam.count),
         visible=[int(m.radii_nonzero) for m in metrics],
         stats_denom_max=float(meta.denom.max()),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         launches=launches)
    return launches, lambda: step(state, meta, 0)


def stage_times(prof) -> dict:
    """Device ms of each top-level ``das3r::`` stage of a profiled train
    step, forward and backward, from the kernels each operator launched
    (a range's own device-side span is not counted). A forward operator
    belongs to its enclosing top-level stage range; a backward operator
    (run by the autograd engine, on its own thread for the GPU) belongs to
    the stage of the forward operator with the same autograd sequence
    number. Operators outside every range (the camera transform,
    activations, the conf gather, gradient accumulation) fall under
    ``render_other``."""
    top = ("das3r::preprocess", "das3r::bin_entry_stream",
           "das3r::bin_gaussians", "das3r::blend", "das3r::assemble",
           "das3r::loss", "das3r::adam")
    events = prof.events()
    backward = "autograd::engine::evaluate_function"

    def owner(e):
        """(top-level range, evaluate_function) enclosing ``e``."""
        rng = ev = None
        while e is not None:
            if rng is None and e.name in top:
                rng = e.name[len("das3r::"):]
            if e.name.startswith(backward):
                ev = e
            e = e.cpu_parent
        return rng or "render_other", ev

    seq = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            rng, ev = owner(e)
            if ev is None:
                seq.setdefault(e.sequence_nr, rng)
    out: dict[str, dict[str, float]] = {}
    for e in events:
        if not e.kernels or e.name.startswith("das3r::"):
            continue
        rng, ev = owner(e)
        key = "forward_ms"
        if ev is not None:
            key, rng = "backward_ms", seq.get(ev.sequence_nr, "render_other")
        d = out.setdefault(rng, {})
        d[key] = d.get(key, 0.0) + sum(k.duration for k in e.kernels) / 1e3
    return out


def phase_train_profile(one_step, phase: str = "train_profile"):
    """One more train step under ``torch.profiler``."""
    summary, prof = profile_call(one_step, top=12)
    stages = stage_times(prof)
    emit(phase, **summary, stages=stages, stages_total_ms=sum(
        sum(d.values()) for d in stages.values()))


class _Timed:
    """Wrap ``module.name`` while inside: each call's seconds (after a
    synchronize), its arguments and its result are kept, and its kernel
    launches (the counts' change across the call) summed into
    ``launches``, so that one stage of an entry point can be timed,
    counted and checked without running it twice."""

    def __init__(self, module, name: str, sync: bool = True):
        """``sync=False``: no synchronize and nothing kept but the
        launches and the count of calls (a stage called thousands of times
        in a run that is timed as a whole)."""
        self.module, self.name, self.sync = module, name, sync
        self.seconds, self.args, self.results = [], [], []
        self.calls = 0
        self.launches = collections.Counter()

    def __enter__(self):
        import torch
        self.orig = orig = getattr(self.module, self.name)

        def wrapped(*args, **kw):
            before = kernel_launches()
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            self.calls += 1
            self.launches.update(launches_since(before))
            if not self.sync:
                return out
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            self.args.append((args, kw))
            self.results.append(out)
            return out
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


# f32 and bf16 in turns, three each: the median of three turns sets a
# kernel's time, so one turn's profiler reading alone cannot (on the H100
# machine a turn's profiler median has read half the kernel's time while
# its CUDA-event time stayed level with the other turns')
TURNS = ("f32", "bf16", "bf16", "f32", "f32", "bf16")


def turn_fields(turns: list, dev_turns: list) -> dict:
    """The bf16 form's ``ms`` and ``device_ms`` and the f32 form's, each
    the median of its ``TURNS``; every turn's reading, and the profiler
    sessions and records of each ``device_ms`` turn."""
    pick = {k: [i for i, t in enumerate(TURNS) if t == k]
            for k in ("f32", "bf16")}
    dev = [d["device_ms"] for d in dev_turns]
    return dict(
        ms=statistics.median(turns[i] for i in pick["bf16"]),
        device_ms=statistics.median(dev[i] for i in pick["bf16"]),
        f32_ms=statistics.median(turns[i] for i in pick["f32"]),
        f32_device_ms=statistics.median(dev[i] for i in pick["f32"]),
        turn_order=list(TURNS), ms_turns=turns, device_ms_turns=dev,
        device_ms_turn_sessions=[d["device_ms_sessions"] for d in dev_turns],
        device_ms_turn_records=[d["device_ms_kernels"] for d in dev_turns])


def bf16_table_view(prep, settings, dev) -> list[dict]:
    """Kernels B and C in their table_bf16 form on one view's entry stream
    (``prep`` binned with ``settings``): the card's encode bitwise the
    CPU's; B-bf16 (with and without ``n_last``) and C-bf16 against their
    plain versions (the f32 plain versions on the decoded table) at the
    bars of ``entry_kernel_parity``; the bf16 image against the f32 image
    in JAX's envelope; B-bf16's and C-bf16's times beside f32 B's and C's
    on the same stream, in ``TURNS``, and their bounds."""
    import numpy as np
    import torch
    from das3r_tpu_torch.ops.splat import binning
    from das3r_tpu_torch.ops.splat import entry_blend as eb

    es = binning.bin_entry_stream(prep, settings)
    attr = torch.cat([prep.mean2d, prep.conic, prep.color,
                      prep.opacity[:, None]], 1)
    table = torch.cat([attr[es.order], torch.zeros_like(attr[:1])]
                      ).contiguous()
    t16 = eb.encode_bf16_table(table)
    cpu16 = eb.encode_bf16_table(table.cpu())
    differ = int((t16.view(torch.int16).cpu() != cpu16.view(torch.int16))
                 .sum())
    if differ:
        raise AssertionError(f"the card's bf16 encode differs from the "
                             f"CPU's on {differ} values")
    dec = eb.decode_bf16_table(t16)
    stream = (es.rank, es.astart, es.count, settings)

    # --- B-bf16 --------------------------------------------------------
    cpre, tfinal = eb.blend_forward(t16, *stream)
    cpre_n, tfinal_n, n_last = eb.blend_forward(t16, *stream, True)
    plain = eb.blend_forward_plain(dec, *stream)
    torch.cuda.synchronize()
    err = max(float((cpre - plain.cpre).abs().max()),
              float((tfinal - plain.tfinal).abs().max()))
    err_n = max(float((cpre_n - plain.cpre).abs().max()),
                float((tfinal_n - plain.tfinal).abs().max()))
    if not max(err, err_n) <= BLEND_TOL:
        raise AssertionError(f"blend_forward_bf16 max err {err} (with "
                             f"n_last {err_n}) > {BLEND_TOL}")
    bg = torch.tensor(BF16_BG, device=dev).reshape(1, 3, 1)
    c32, t32 = eb.blend_forward(table, *stream)
    img = ((cpre + tfinal * bg) - (c32 + t32 * bg)).abs()
    env = dict(max=float(img.max()), mean=float(img.mean()))
    if not (env["max"] < BF16_ENV_MAX and env["mean"] < BF16_ENV_MEAN):
        raise AssertionError(f"the bf16 image against the f32 image: {env} "
                             f"(JAX's envelope {BF16_ENV_MAX}, "
                             f"{BF16_ENV_MEAN})")
    n_eval = int(plain.n_eval.sum())
    n_slots, pre_bytes = prefix_bytes(es, plain.n_eval.amax(1),
                                      eb.N_ATTR_BF16 * 2)
    nbytes = (pre_bytes + es.astart.numel() * 4 + es.count.numel() * 4
              + cpre.numel() * 4 + tfinal.numel() * 4)
    b_ms, b_by = bound(nbytes, max(
        n_eval * BLEND_FLOP_PER_EVAL / FP32_FLOP_PER_S,
        n_eval / SFU_OPS_PER_S))

    def fwd(tab):
        return eb.blend_forward(tab, *stream)

    tabs = [{"f32": table, "bf16": t16}[k] for k in TURNS]
    turns = [time_ms(lambda t=t: fwd(t)) for t in tabs]
    dev_turns = [device_ms(lambda t=t: fwd(t), "blend_forward_kernel")
                 for t in tabs]
    b = dict(
        name="blend_forward_bf16", route="cuda",
        source="das3r_tpu_torch/csrc/blend_forward.cu",
        replaces="das3r_tpu/ops/splat/entry_blend.py:145",
        form="table_bf16: the [N+1, 11] bf16 table decoded where it is "
             "staged (JAX: _load_attrs, entry_blend.py:71)",
        max_abs_err=err, max_abs_err_with_n_last=err_n,
        image_err_vs_f32=env,
        **turn_fields(turns, dev_turns),
        plain_ms=time_ms(lambda: eb.blend_forward_plain(
            eb.decode_bf16_table(t16), *stream)),
        library_ms=None, library_device_ms=None, bound_ms=b_ms,
        bound_by=b_by, pixel_entry_evals=n_eval, entries_needed=n_slots,
        n_last_agrees=float((n_last == plain.n_last).float().mean()),
        bytes=nbytes)

    # --- C-bf16 --------------------------------------------------------
    gen = np.random.default_rng(SEED + 4)
    g_cpre = torch.as_tensor(gen.normal(size=tuple(cpre.shape)).astype(
        np.float32), device=dev)
    g_tfinal = torch.as_tensor(gen.normal(size=tuple(tfinal.shape)).astype(
        np.float32), device=dev)
    got = eb.blend_backward(t16, *stream, tfinal_n, n_last, g_cpre,
                            g_tfinal)
    want = eb.blend_backward_plain(dec, *stream, plain.tfinal, plain.tin,
                                   g_cpre, g_tfinal).g_table
    torch.cuda.synchronize()
    rel = {k: float((got[:, c] - want[:, c]).abs().max()
                    / want[:, c].abs().max()) for k, c in GROUPS.items()}
    if not (got.dtype == torch.float32 and got.shape == table.shape
            and torch.isfinite(got).all() and max(rel.values()) <= GRAD_TOL):
        raise AssertionError(f"blend_backward_bf16 err / max|g| {rel} > "
                             f"{GRAD_TOL}")
    _, t32n, nl32 = eb.blend_forward(table, *stream, True)

    def bwd(tab, tf, nl):
        return eb.blend_backward(tab, *stream, tf, nl, g_cpre, g_tfinal)

    args = [{"f32": (table, t32n, nl32), "bf16": (t16, tfinal_n, n_last)}[k]
            for k in TURNS]
    turns = [time_ms(lambda a=a: bwd(*a)) for a in args]
    dev_turns = [device_ms(lambda a=a: bwd(*a), "blend_backward_kernel")
                 for a in args]
    evals = int(n_last.sum())
    n_slots, pre_bytes = prefix_bytes(es, n_last.amax(1).long(),
                                      eb.N_ATTR_BF16 * 2)
    nbytes = (pre_bytes + (n_last.numel() + es.astart.numel()
                           + es.count.numel()) * 4
              + (tfinal.numel() + g_cpre.numel() + g_tfinal.numel()) * 4
              + got.numel() * 4)
    c_ms, c_by = bound(nbytes, max(
        evals * BLEND_BWD_FLOP_PER_EVAL / FP32_FLOP_PER_S,
        evals * BLEND_BWD_SFU_PER_EVAL / SFU_OPS_PER_S))
    c = dict(
        name="blend_backward_bf16", route="cuda",
        source="das3r_tpu_torch/csrc/blend_backward.cu",
        replaces="das3r_tpu/ops/splat/entry_blend.py:237",
        form="table_bf16: decoded at both reads of the table; the "
             "gradient is the f32 table's (JAX: _load_attrs at :248, _bwd "
             "at :510)",
        max_abs_err=float((got - want).abs().max()), err_over_max_g=rel,
        **turn_fields(turns, dev_turns),
        plain_ms=time_ms(lambda: eb.blend_backward_plain(
            eb.decode_bf16_table(t16), *stream, plain.tfinal, plain.tin,
            g_cpre, g_tfinal)),
        library_ms=None, library_device_ms=None, bound_ms=c_ms,
        bound_by=c_by, pixel_entry_evals=evals, entries_needed=n_slots,
        bytes=nbytes)
    return [b, c]


def bf16_ranges(bundle, dev) -> dict:
    """View 0 of the trainer's bundle as 2 tile ranges through B-bf16 in
    its tile-range form, reassembled bitwise the whole-image B-bf16."""
    import torch
    from das3r_tpu_torch.ops.splat import binning
    from das3r_tpu_torch.ops.splat import entry_blend as eb
    from das3r_tpu_torch.ops.splat.rasterize import (range_capacity,
                                                     range_tiles)

    s = dataclasses.replace(bundle.settings, table_bf16=True)
    with torch.no_grad():
        prep = trainer_view0_prep(bundle, s, dev)
    n = prep.depth.shape[0]
    ks = binning._sorted_key_stream(prep, s)
    es = binning.entry_stream_from_keys(ks, s, n,
                                        binning.entry_stream_cap(s, n))
    attr = torch.cat([prep.mean2d, prep.conic, prep.color,
                      prep.opacity[:, None]], 1)
    t16 = eb.encode_bf16_table(torch.cat([attr[es.order], torch.zeros_like(
        attr[:1])]))
    whole = eb.blend_forward(t16, es.rank, es.astart, es.count, s)
    t_loc = range_tiles(s, 2)
    rows = [[], []]
    for i in range(2):
        e = binning.entry_stream_from_keys(ks, s, n, range_capacity(s, n),
                                           i * t_loc, t_loc)
        for k, x in enumerate(eb.blend_forward(
                t16, e.rank, e.astart, e.count, s, tile0=i * t_loc,
                n_tiles_out=t_loc)):
            rows[k].append(x)
    torch.cuda.synchronize()
    same = all(torch.equal(torch.cat(r)[:s.n_tiles], w)
               for r, w in zip(rows, whole))
    if not same:
        raise AssertionError("2 bf16 tile ranges differ from the whole-image "
                             "B-bf16")
    return dict(ranges=2, t_loc=t_loc, image_bitwise=True)


def phase_bf16_table(bundle, model: Path, data, settings, dev):
    """The bf16 attribute table: kernels B and C in their table_bf16 form
    on view 0 of the trainer's bundle and of the random scene
    (``bf16_table_view``), view 0 as 2 tile ranges (``bf16_ranges``), and
    ``TRAIN_STEPS`` train steps on the random scene with ``table_bf16``
    (``phase_train``: finite, the loss falls, one launch of B-bf16 and
    C-bf16 a step). Returns the kernel rows (the trainer view's, the
    random scene's under ``random_scene``) and the steps' launches."""
    import torch
    t0 = time.perf_counter()
    with torch.no_grad():
        prep = trainer_view0_prep(bundle, bundle.settings, dev)
        results = bf16_table_view(prep, bundle.settings, dev)
        del prep
        prep = view0_prep(model, data, settings, dev)
        random_scene = bf16_table_view(prep, settings, dev)
        del prep
    for r, r_random in zip(results, random_scene):
        r["scene"] = "trainer view 0"
        r["random_scene"] = {k: r_random[k] for k in BF16_SUMMARY_KEYS
                             if k in r_random}
    ranges = bf16_ranges(bundle, dev)
    torch.cuda.empty_cache()
    launches, _ = phase_train(data, dataclasses.replace(
        settings, table_bf16=True), dev, "bf16_train")
    torch.cuda.empty_cache()
    emit("bf16_table", seconds=time.perf_counter() - t0,
         kernels={r["name"]: {k: r[k] for k in BF16_SUMMARY_KEYS if k in r}
                  for r in results}, tile_ranges=ranges,
         train_launches=launches)
    return results, launches


def phase_trainer_scene(dev):
    """The trainer's scene: 12 synthetic frames at full width, eval split,
    ``build_scene`` with its defaults (k-NN and probe timed)."""
    import torch
    from das3r_tpu_torch.data import readers, rearrange, synthetic
    from das3r_tpu_torch.models import autosize, gaussians
    from das3r_tpu_torch.train import scene_setup

    t0 = time.perf_counter()
    stage1, scene = WORK / "trainer_stage1", WORK / "trainer_scene"
    synthetic.make_synthetic_stage1_dir(str(stage1), n_frames=TRAINER_FRAMES,
                                        height=HEIGHT, width=WIDTH,
                                        seed=SEED + 7)
    rearrange.rearrange_scene(str(stage1), str(scene))
    data = readers.load_scene(str(scene), eval_mode=True)
    io_s = time.perf_counter() - t0
    with _Timed(gaussians, "knn_mean_sq_dist") as knn, \
            _Timed(autosize, "probe_capacities") as probe:
        t1 = time.perf_counter()
        bundle, launches = run_counted(
            lambda: scene_setup.build_scene(data, device=dev))
        build_s = time.perf_counter() - t1
    stats = probe.results[0]
    k_probe = min(-(-stats.max_tile // 128) * 128, K_CEILING)
    n_live = int(bundle.meta.alive.sum())
    # every synthetic pixel passes the confidence test; the init keeps the
    # 1.5M most confident of the 11 train frames' pixels
    if (n_live != min(1_500_000, 11 * HEIGHT * WIDTH)
            or len(bundle.train_data.images) != 11):
        raise AssertionError(f"{n_live} live Gaussians, "
                             f"{len(bundle.train_data.images)} train frames")
    for name in ("extract_windows", "window_blend_forward"):
        if launches[name] == 0:
            raise AssertionError(f"the probe launched no {name}")
    st = bundle.settings
    emit("trainer_scene", seconds=time.perf_counter() - t0, io_seconds=io_s,
         build_scene_seconds=build_s, knn_seconds=knn.seconds,
         probe_seconds=probe.seconds, probe=stats._asdict(),
         k_probe=k_probe, n_gaussians=n_live,
         capacity=int(bundle.params.xyz.shape[0]),
         settings=dict(max_per_tile=st.max_per_tile,
                       max_tiles_per_gaussian=st.max_tiles_per_gaussian,
                       max_total_entries=st.max_total_entries,
                       light_dup_width=st.light_dup_width,
                       heavy_rows_cap=st.heavy_rows_cap),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
         launches=launches)
    return bundle, k_probe, launches, stats


def visited_chunk_work(counts, deltas, tin, chunk, eps):
    """(live slots in the visited chunks per tile [T], visited chunks) of
    the window blend: what the serial loops of kernels D and E evaluate
    per pixel."""
    import torch
    n_chunks = tin.shape[1]
    visited = tin.amax(2) >= eps                               # [T, nc]
    c = torch.arange(n_chunks, device=tin.device)
    lo = torch.clamp(deltas.long()[:, None] - c * chunk, 0, chunk)
    hi = torch.clamp((deltas + counts).long()[:, None] - c * chunk, 0, chunk)
    slots = torch.where(visited, hi - lo, torch.zeros_like(lo))
    return slots.sum(1), int(visited.sum())


def tile_spread(tile_slots, n_sm: int) -> dict:
    """The spread of a one-block-per-tile kernel's work: per-tile slots
    (mean, max) and per-SM sums with block b placed on SM b mod n_sm."""
    import torch
    per_sm = torch.zeros(n_sm, dtype=torch.int64, device=tile_slots.device)
    per_sm.index_add_(0, torch.arange(tile_slots.numel(),
                                      device=tile_slots.device) % n_sm,
                      tile_slots)
    return dict(tiles=tile_slots.numel(),
                tile_mean=float(tile_slots.float().mean()),
                tile_max=int(tile_slots.max()), sms=n_sm,
                sm_mean=float(per_sm.float().mean()),
                busiest_sm=int(per_sm.max()))


def trainer_view0_prep(bundle, settings, dev):
    """View 0 of the trainer's bundle, preprocessed as
    ``render(mode="train")`` preprocesses it."""
    import torch
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.models.gaussians import per_gaussian_conf
    from das3r_tpu_torch.ops.splat.preprocess import preprocess

    params, meta = bundle.params, bundle.meta
    xyz_cam, rot_cam = render_mod._camera_frame_gaussians(
        params, bundle.poses.pose(0))
    view, proj, campos, tfx, tfy = render_mod._raster_common(
        float(bundle.train_data.fovx[0]), float(bundle.train_data.fovy[0]),
        dev)
    opacity = (torch.sigmoid(params.opacity)
               * per_gaussian_conf(params, meta)[:, None]
               * meta.alive[:, None])
    return preprocess(
        xyz_cam, opacity, settings, viewmatrix=view, projmatrix=proj,
        campos=campos,
        shs=torch.cat([params.features_dc, params.features_rest], 1),
        scales=torch.exp(params.scaling), rotations=rot_cam,
        tan_fovx=tfx, tan_fovy=tfy)


def phase_trainer_entry_parity(bundle, dev):
    """Kernels A, B, C against their plain versions on view 0 of the
    trainer's bundle on the entry stream: the scene of the trainer's entry
    run, where most of their launches run. Its opacities never saturate a
    tile, so every pixel walks its tile's whole list."""
    import torch
    t0 = time.perf_counter()
    with torch.no_grad():
        prep = trainer_view0_prep(bundle, bundle.settings, dev)
        results, sizes = entry_kernel_parity(prep, bundle.settings, dev)
    emit("trainer_entry_parity", seconds=time.perf_counter() - t0, **sizes,
         kernels=summary(results))
    return results


def range_rows(x, tile0: int, t_loc: int):
    """Rows [tile0, tile0 + t_loc) of a per-tile tensor, zero past its
    end (a range's padded tail)."""
    import torch
    out = torch.zeros((t_loc,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    k = max(min(t_loc, x.shape[0] - tile0), 0)
    out[:k] = x[tile0:tile0 + k]
    return out


def sharded_tile_ranges(bundle, dev) -> dict:
    """View 0 of the trainer's bundle blended as 2, 4 and 5 tile ranges by
    kernels B and C in their tile-range form, in one process: the
    reassembled image against the whole-image B (bitwise), the summed
    g_table against the whole-image C (``RANGE_GRAD_TOL`` x max|g| per
    column group), one range of 4 against the plain versions (the bars of
    ``entry_kernel_parity``); per range count the layouts', B's and C's
    times (``ms``: all ranges in turn; ``device_ms``: the sum of each
    range's kernel alone) beside the whole-image calls, and each range's
    bound."""
    import numpy as np
    import torch
    from das3r_tpu_torch.ops.splat import binning, entry_blend
    from das3r_tpu_torch.ops.splat.rasterize import (range_capacity,
                                                     range_tiles)

    s = bundle.settings
    with torch.no_grad():
        prep = trainer_view0_prep(bundle, s, dev)
    n = prep.depth.shape[0]
    n_tiles, P = s.n_tiles, s.tile * s.tile
    ks = binning._sorted_key_stream(prep, s)
    es = binning.entry_stream_from_keys(ks, s, n,
                                        binning.entry_stream_cap(s, n))
    attr = torch.cat([prep.mean2d, prep.conic, prep.color,
                      prep.opacity[:, None]], 1)
    table = torch.cat([attr[es.order], torch.zeros_like(attr[:1])]
                      ).contiguous()
    del prep, attr
    gen = np.random.default_rng(SEED + 9)
    g_cpre = torch.as_tensor(gen.normal(size=(n_tiles, 3, P)).astype(
        np.float32), device=dev)
    g_tfinal = torch.as_tensor(gen.normal(size=(n_tiles, 1, P)).astype(
        np.float32), device=dev)

    def fwd(e, **rng):
        return entry_blend.blend_forward(table, e.rank, e.astart, e.count,
                                         s, True, **rng)

    def bwd(e, tfinal, n_last, gc, gt, **rng):
        return entry_blend.blend_backward(table, e.rank, e.astart, e.count,
                                          s, tfinal, n_last, gc, gt, **rng)

    cpre, tfinal, n_last = fwd(es)
    g_whole = bwd(es, tfinal, n_last, g_cpre, g_tfinal)
    # per-tile work for the bounds: each tile's pixel-entry evaluations
    # (plain forward) and its longest pixel run
    n_eval = entry_blend.blend_forward_plain(table, es.rank, es.astart,
                                             es.count, s).n_eval
    torch.cuda.synchronize()

    def b_bound(e, ev, need):
        _, pre = prefix_bytes(e, need, entry_blend.N_ATTR * 4)
        # astart and count in; cpre, tfinal and n_last out
        nbytes = pre + e.count.numel() * 8 + e.count.numel() * P * 5 * 4
        evals = int(ev.sum())
        return bound(nbytes, max(evals * BLEND_FLOP_PER_EVAL / FP32_FLOP_PER_S,
                                 evals / SFU_OPS_PER_S))

    def c_bound(e, nl):
        _, pre = prefix_bytes(e, nl.amax(1).long(), entry_blend.N_ATTR * 4)
        # n_last, tfinal and the four cotangents in; g_table out
        nbytes = (pre + e.count.numel() * 8 + nl.numel() * 6 * 4
                  + table.numel() * 4)
        evals = int(nl.sum())
        return bound(nbytes, max(
            evals * BLEND_BWD_FLOP_PER_EVAL / FP32_FLOP_PER_S,
            evals * BLEND_BWD_SFU_PER_EVAL / SFU_OPS_PER_S))

    whole = dict(
        b_ms=time_ms(lambda: fwd(es)),
        b_device_ms=device_ms(lambda: fwd(es),
                              "blend_forward_kernel")["device_ms"],
        c_ms=time_ms(lambda: bwd(es, tfinal, n_last, g_cpre, g_tfinal)),
        c_device_ms=device_ms(lambda: bwd(es, tfinal, n_last, g_cpre,
                                          g_tfinal),
                              "blend_backward_kernel")["device_ms"],
        b_bound_ms=b_bound(es, n_eval, n_eval.amax(1))[0],
        c_bound_ms=c_bound(es, n_last)[0])
    out = {"whole": whole}
    cap = range_capacity(s, n)
    for n_ranges in SHARDED_RANGES:
        t_loc = range_tiles(s, n_ranges)
        tile0s = [i * t_loc for i in range(n_ranges)]

        def layouts():
            return [binning.entry_stream_from_keys(ks, s, n, cap, t0, t_loc)
                    for t0 in tile0s]

        streams = layouts()
        runs = []
        for t0, e in zip(tile0s, streams):
            rng = dict(tile0=t0, n_tiles_out=t_loc)
            cp, tf, nl = fwd(e, **rng)
            cot = (range_rows(g_cpre, t0, t_loc),
                   range_rows(g_tfinal, t0, t_loc))
            runs.append((e, rng, cp, tf, nl, cot))
        g_sum = torch.zeros_like(table)
        for e, rng, cp, tf, nl, cot in runs:
            g_sum += bwd(e, tf, nl, *cot, **rng)
        torch.cuda.synchronize()
        cp_all = torch.cat([r[2] for r in runs])[:n_tiles]
        tf_all = torch.cat([r[3] for r in runs])[:n_tiles]
        if not (torch.equal(cp_all, cpre) and torch.equal(tf_all, tfinal)):
            raise AssertionError(
                f"{n_ranges} ranges: the reassembled image differs from "
                f"the whole-image B on "
                f"{int((cp_all != cpre).sum() + (tf_all != tfinal).sum())} "
                f"values")
        rel = {k: float((g_sum[:, c] - g_whole[:, c]).abs().max()
                        / g_whole[:, c].abs().max())
               for k, c in GROUPS.items()}
        if not max(rel.values()) <= RANGE_GRAD_TOL:
            raise AssertionError(f"{n_ranges} ranges: summed g_table err / "
                                 f"max|g| {rel} > {RANGE_GRAD_TOL}")
        per_range = []
        for t0, (e, rng, cp, tf, nl, cot) in zip(tile0s, runs):
            b_ms, b_by = b_bound(e, range_rows(n_eval, t0, t_loc),
                                 range_rows(n_eval.amax(1), t0, t_loc))
            c_ms, c_by = c_bound(e, nl)
            per_range.append(dict(
                tile0=t0, entries=int(e.count.sum()),
                b_device_ms=device_ms(lambda e=e, rng=rng: fwd(e, **rng),
                                      "blend_forward_kernel")["device_ms"],
                c_device_ms=device_ms(
                    lambda e=e, rng=rng, tf=tf, nl=nl, cot=cot: bwd(
                        e, tf, nl, *cot, **rng),
                    "blend_backward_kernel")["device_ms"],
                b_bound_ms=b_ms, b_bound_by=b_by, c_bound_ms=c_ms,
                c_bound_by=c_by))
        res = dict(
            t_loc=t_loc, padded_tiles=n_ranges * t_loc - n_tiles,
            capacity=cap, layout_ms=time_ms(layouts),
            b_ms=time_ms(lambda: [fwd(r[0], **r[1]) for r in runs]),
            c_ms=time_ms(lambda: [bwd(r[0], r[3], r[4], *r[5], **r[1])
                                  for r in runs]),
            b_device_ms=sum(r["b_device_ms"] for r in per_range),
            c_device_ms=sum(r["c_device_ms"] for r in per_range),
            g_table_err_over_max_g=rel, image_bitwise=True,
            per_range=per_range)
        if n_ranges == 4:      # one range against the plain versions
            e, rng, cp, tf, nl, cot = runs[1]
            plain = entry_blend.blend_forward_plain(
                table, e.rank, e.astart, e.count, s, **rng)
            want = entry_blend.blend_backward_plain(
                table, e.rank, e.astart, e.count, s, plain.tfinal,
                plain.tin, *cot, **rng).g_table
            g_one = bwd(e, tf, nl, *cot, **rng)
            torch.cuda.synchronize()
            b_err = max(float((cp - plain.cpre).abs().max()),
                        float((tf - plain.tfinal).abs().max()))
            c_rel = {k: float((g_one[:, c] - want[:, c]).abs().max()
                              / want[:, c].abs().max())
                     for k, c in GROUPS.items()}
            if not (b_err <= BLEND_TOL and max(c_rel.values()) <= GRAD_TOL):
                raise AssertionError(
                    f"range 1 of 4 against the plain versions: B {b_err} "
                    f"(bar {BLEND_TOL}), C err / max|g| {c_rel} (bar "
                    f"{GRAD_TOL})")
            res.update(plain_range=1, b_max_abs_err=b_err,
                       c_err_over_max_g=c_rel)
        out[f"ranges_{n_ranges}"] = res
    return out


def window_tile_ranges(bundle, k_probe: int, dev) -> dict:
    """View 0 of the trainer's bundle on the [T, K] window path (K from
    the probe) blended as 2 and 4 ranges of window rows by kernels D and E
    in their tile-range form (``rasterize.window_range``), in one process:
    the reassembled colours bitwise the whole-image D's, the summed
    gradients of the depth-rank table and of bg within
    ``RANGE_GRAD_TOL`` x max|g| of the whole image's; per range count D's
    and E's ``ms`` (all ranges in turn) and ``device_ms`` (each range's
    kernel alone, summed) beside the whole image's, and each range's
    bound."""
    import numpy as np
    import torch
    from das3r_tpu_torch.ops.splat import binning, window_blend
    from das3r_tpu_torch.ops.splat.rasterize import range_tiles, window_range

    s = dataclasses.replace(bundle.settings, max_per_tile=k_probe,
                            entry_stream=False)
    with torch.no_grad():
        prep = trainer_view0_prep(bundle, s, dev)
        bins = binning.bin_gaussians(prep, s)
        attr = torch.cat([prep.mean2d, prep.conic, prep.color,
                          prep.opacity[:, None]], 1)[bins.order]
    del prep
    bg = torch.tensor(BF16_BG, device=dev)
    P = s.tile * s.tile
    cot = torch.as_tensor(np.random.default_rng(SEED + 10).normal(
        size=(s.n_tiles, P, 3)).astype(np.float32), device=dev)
    chunk = window_blend._pick_chunk(k_probe)

    def render(n_ranges):
        """(colours [T, P, 3], g_attr, g_bg, each range's (attrs, count,
        delta, colours))"""
        a = attr.clone().requires_grad_(True)
        b = bg.clone().requires_grad_(True)
        rows = [window_range(a, bins, b, s, n_ranges, i)
                for i in range(n_ranges)]
        colors = torch.cat(rows)[:s.n_tiles]
        g_a, g_b = torch.autograd.grad(colors, (a, b), cot)
        return colors.detach(), g_a, g_b

    def range_args(n_ranges, i):
        t_loc = range_tiles(s, n_ranges)
        t0 = i * t_loc
        count = range_rows(bins.count, t0, t_loc)
        delta = range_rows(bins.delta, t0, t_loc)
        attrs = attr[range_rows(bins.rank, t0, t_loc)].transpose(
            1, 2).contiguous()
        return attrs, count, delta, t0, t_loc

    def d_call(args):
        attrs, count, delta, t0, _ = args
        return window_blend.window_forward(attrs, count, delta, bg, s, t0)

    def e_call(args, fwd):
        attrs, count, delta, t0, t_loc = args
        g = range_rows(cot, t0, t_loc)
        return window_blend.window_backward(attrs, count, delta, bg, g,
                                            fwd[1], fwd[2], s, t0)

    def bounds(args, fwd):
        attrs, count, delta, _, _ = args
        slots, n_vis = visited_chunk_work(count, delta, fwd[2], chunk,
                                          s.transmittance_eps)
        evals = int(slots.sum()) * P
        d_bytes = (n_vis * chunk * 9 * 4 + count.numel() * 8
                   + sum(x.numel() * 4 for x in fwd))
        e_bytes = d_bytes + attrs.numel() * 4
        return (bound(d_bytes, max(evals * BLEND_FLOP_PER_EVAL
                                   / FP32_FLOP_PER_S,
                                   evals / SFU_OPS_PER_S)),
                bound(e_bytes, max(evals * WINDOW_BWD_FLOP_PER_EVAL
                                   / FP32_FLOP_PER_S,
                                   evals * WINDOW_BWD_SFU_PER_EVAL
                                   / SFU_OPS_PER_S)))

    colors, g_a, g_b = render(1)
    whole_args = range_args(1, 0)
    whole_fwd = d_call(whole_args)
    (d_b, _), (e_b, _) = bounds(whole_args, whole_fwd)
    out = {"whole": dict(
        d_ms=time_ms(lambda: d_call(whole_args)),
        d_device_ms=device_ms(lambda: d_call(whole_args),
                              "window_forward_kernel")["device_ms"],
        e_ms=time_ms(lambda: e_call(whole_args, whole_fwd)),
        e_device_ms=device_ms(lambda: e_call(whole_args, whole_fwd),
                              "window_backward_kernel")["device_ms"],
        d_bound_ms=d_b, e_bound_ms=e_b)}
    for n_ranges in WINDOW_RANGES:
        got, g_a2, g_b2 = render(n_ranges)
        torch.cuda.synchronize()
        if not torch.equal(got, colors):
            raise AssertionError(
                f"{n_ranges} window ranges: the reassembled colours differ "
                f"from the whole-image D on {int((got != colors).sum())} "
                f"values")
        rel = {k: float((g_a2[:, c] - g_a[:, c]).abs().max()
                        / g_a[:, c].abs().max()) for k, c in GROUPS.items()}
        rel["bg"] = float((g_b2 - g_b).abs().max() / g_b.abs().max())
        if not max(rel.values()) <= RANGE_GRAD_TOL:
            raise AssertionError(f"{n_ranges} window ranges: summed "
                                 f"gradients err / max|g| {rel} > "
                                 f"{RANGE_GRAD_TOL}")
        runs = [range_args(n_ranges, i) for i in range(n_ranges)]
        fwds = [d_call(a) for a in runs]
        per_range = []
        for a, f in zip(runs, fwds):
            (d_b, d_by), (e_b, e_by) = bounds(a, f)
            per_range.append(dict(
                tile0=a[3], live_slots=int(a[1].sum()),
                d_device_ms=device_ms(lambda a=a: d_call(a),
                                      "window_forward_kernel")["device_ms"],
                e_device_ms=device_ms(lambda a=a, f=f: e_call(a, f),
                                      "window_backward_kernel")["device_ms"],
                d_bound_ms=d_b, d_bound_by=d_by, e_bound_ms=e_b,
                e_bound_by=e_by))
        out[f"ranges_{n_ranges}"] = dict(
            t_loc=runs[0][4], padded_tiles=n_ranges * runs[0][4] - s.n_tiles,
            d_ms=time_ms(lambda: [d_call(a) for a in runs]),
            e_ms=time_ms(lambda: [e_call(a, f) for a, f in zip(runs, fwds)]),
            d_device_ms=sum(r["d_device_ms"] for r in per_range),
            e_device_ms=sum(r["e_device_ms"] for r in per_range),
            grad_err_over_max_g=rel, colors_bitwise=True,
            per_range=per_range)
    return out


def sharded_rank(rank: int, work: str, device: str) -> None:
    """One of the two ranks of ``sharded_steps``, in a process of its own
    on ``device`` (``cuda``: both ranks on card 0): for the meshes (tile=2) and (gauss=2), the port's
    unsharded step (world size 1) and the sharded step, each
    ``SHARDED_STEPS`` steps of one frame from the scene's state; the
    sharded run against the unsharded one at the CPU tests' bars (the
    loss within rel 1e-5 each step, the first step's gradients within
    2e-5 x max|g| per field, the parameters within 2 lr per step taken).
    Writes ``rank<r>.json``; raises on a failed bar."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from das3r_tpu_torch.models.gaussians import (GaussianMeta,
                                                  GaussianParams, PoseParams)
    from das3r_tpu_torch.ops.splat import RasterSettings
    from das3r_tpu_torch.parallel import comm_stats, make_mesh, multihost
    from das3r_tpu_torch.parallel import sharded
    from das3r_tpu_torch.train import optim
    from das3r_tpu_torch.train import step as step_mod
    from das3r_tpu_torch.train.config import OptimizationConfig

    work = Path(work)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    backend = multihost.initialize_distributed(
        f"file://{work / 'store'}", 2, rank, device=device)
    try:
        scene = torch.load(work / "scene.pt")
        settings = RasterSettings(**scene["settings"])
        cfg = OptimizationConfig()
        gts = scene["gts"].to(dev)
        fovx, fovy = scene["fovx"], scene["fovy"]
        bg = torch.zeros(3, device=dev)

        def fresh(mesh, gauss_axis):
            """The scene's state, copied: the steps update it in place."""
            params, poses, meta = (
                cls(**{k: v.to(dev, copy=True) for k, v in
                       scene[name].items()})
                for cls, name in ((GaussianParams, "params"),
                                  (PoseParams, "poses"),
                                  (GaussianMeta, "meta")))
            state = step_mod.init_train_state(params, poses)
            if gauss_axis:
                state = sharded.shard_state(state, mesh)
                meta = sharded.shard_meta(meta, mesh)
            return state, meta

        def run(mesh, gauss_axis, settings):
            state, meta = fresh(mesh, gauss_axis)
            step = sharded.make_sharded_train_step(
                mesh, settings, cfg, gauss_axis=gauss_axis, device=dev)
            losses, ms, comm, first = [], [], [], None
            before = kernel_launches()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            for k in range(SHARDED_STEPS):
                if on_card:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                with comm_stats.CommStats() as stats:
                    g_p, g_q, st = step.loss_and_grads(
                        state, meta, [k], gts[k:k + 1], fovx[k:k + 1],
                        fovy[k:k + 1], bg)
                    m = step.update(state, g_p, g_q, st)
                if on_card:
                    torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m.loss))
                comm.append(stats.families())
                if first is None:
                    first = (g_p, g_q)
            return dict(state=state, first=first, losses=losses, ms=ms,
                        comm=comm, launches=launches_since(before),
                        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30
                        if on_card else None)

        out = dict(rank=rank, backend=backend,
                   note="two ranks on one card: not a scaling number")
        window = dataclasses.replace(settings, entry_stream=False,
                                     max_per_tile=scene["window_k"])
        for name, kw, gauss_axis, rs in (
                ("tile_2", dict(tile=2), None, settings),
                ("gauss_2", dict(gauss=2), "gauss", settings),
                ("tile_2_window", dict(tile=2), None, window)):
            mesh = make_mesh(**kw)
            ref = run(make_mesh(world_size=1), None, rs)
            got = run(mesh, gauss_axis, rs)
            rows = (sharded.gauss_rows(mesh, ref["state"].params.xyz.shape[0])
                    if gauss_axis else slice(None))

            def part(k, x):
                return x[rows] if k in sharded.GAUSSIAN_FIELDS else x

            loss_rel = max(abs(a - b) / abs(b) for a, b in
                           zip(got["losses"], ref["losses"]))
            grad_rel = {}
            for g_got, g_ref in zip(got["first"], ref["first"]):
                for f in dataclasses.fields(g_ref):
                    w = part(f.name, getattr(g_ref, f.name))
                    g = getattr(g_got, f.name)
                    grad_rel[f.name] = float(
                        (g - w).abs().max() / (w.abs().max() + 1e-30))
            lrs = [optim.gaussian_lrs(j + 1, cfg, 1.0)
                   for j in range(SHARDED_STEPS)]
            cams = [optim.camera_lrs(j + 1, cfg)
                    for j in range(SHARDED_STEPS)]
            param_over_lr = {}
            for group, lr_list in (("params", lrs), ("poses", cams)):
                for f in dataclasses.fields(getattr(ref["state"], group)):
                    bar = 2 * sum(float(getattr(lr, f.name))
                                  for lr in lr_list) + 1e-7
                    w = part(f.name, getattr(getattr(ref["state"], group),
                                             f.name))
                    d = getattr(getattr(got["state"], group), f.name) - w
                    param_over_lr[f.name] = float(d.detach().abs().max()) / bar
            res = dict(
                mesh=mesh.shape, rows=[rows.start, rows.stop]
                if gauss_axis else None,
                losses=got["losses"], ref_losses=ref["losses"],
                loss_rel_err=loss_rel, grad_err_over_max_g=grad_rel,
                param_diff_over_bar=param_over_lr,
                step_ms=got["ms"], ref_step_ms=ref["ms"],
                comm_per_step=got["comm"], launches=got["launches"],
                ref_launches=ref["launches"],
                peak_mem_gb=got["peak_mem_gb"],
                ref_peak_mem_gb=ref["peak_mem_gb"])
            out[name] = res
            if not (loss_rel <= 1e-5 and max(grad_rel.values()) <= GRAD_TOL
                    and max(param_over_lr.values()) <= 1.0):
                raise AssertionError(f"rank {rank}, {name}: {res}")
            del ref, got
            if on_card:
                torch.cuda.empty_cache()
        (work / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def sharded_steps(bundle, k_probe: int, dev) -> list[dict]:
    """``parallel.sharded.make_sharded_train_step`` on the trainer's scene
    in two gloo processes that share ``dev`` (``cuda``: card 0;
    ``sharded_rank``), spawned after the kernels are built; each rank's
    results. The window path's steps take K = ``k_probe``."""
    import dataclasses

    import torch
    import torch.multiprocessing as mp

    work = WORK / "sharded"
    work.mkdir(parents=True)

    def cpu(group):
        return {f.name: getattr(group, f.name).detach().cpu()
                for f in dataclasses.fields(group)}

    data = bundle.train_data
    torch.save(dict(params=cpu(bundle.params), meta=cpu(bundle.meta),
                    poses=cpu(bundle.poses),
                    gts=torch.as_tensor(data.images[:SHARDED_STEPS]),
                    fovx=torch.as_tensor(data.fovx[:SHARDED_STEPS]),
                    fovy=torch.as_tensor(data.fovy[:SHARDED_STEPS]),
                    settings=dataclasses.asdict(bundle.settings),
                    window_k=k_probe),
               work / "scene.pt")
    ctx = mp.start_processes(sharded_rank, args=(str(work), str(dev)),
                             nprocs=2,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + SHARDED_TIMEOUT
    while not ctx.join(timeout=5):      # raises on a rank's failure
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            for proc in ctx.processes:
                proc.join(10)
            raise AssertionError(f"the sharded ranks ran past "
                                 f"{SHARDED_TIMEOUT} s")
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(2)]


def range_fields(ranges: dict, key: str) -> dict:
    """Kernel B's (``key`` "b"), C's ("c"), D's ("d") or E's ("e")
    tile-range numbers for the kernels line: per range count, all ranges'
    ``ms`` and ``device_ms`` and the largest bound of one range."""
    return {name: dict(ms=v[f"{key}_ms"], device_ms=v[f"{key}_device_ms"],
                       one_range_bound_ms=max(x[f"{key}_bound_ms"]
                                              for x in v["per_range"]))
            for name, v in ranges.items() if name != "whole"}


def phase_sharded(bundle, k_probe: int, dev):
    """Multi-device training on the trainer's scene: its view 0 as tile
    ranges in one process, on the entry stream (``sharded_tile_ranges``)
    and on the window path (``window_tile_ranges``), then the sharded
    step on two ranks sharing the card (``sharded_steps``). Returns the
    tile-range results of both paths and the sharded steps' launches of
    each kernel, summed over the ranks: on the entry stream (tile=2 and
    gauss=2) and on the window path (tile=2)."""
    import torch
    t0 = time.perf_counter()
    ranges = sharded_tile_ranges(bundle, dev)
    torch.cuda.empty_cache()
    win_ranges = window_tile_ranges(bundle, k_probe, dev)
    ranges_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    ranks = sharded_steps(bundle, k_probe, dev)
    launches = collections.Counter()
    win_launches = collections.Counter()
    for r in ranks:
        for mesh in ("tile_2", "gauss_2"):
            launches.update(r[mesh]["launches"])
        win_launches.update(r["tile_2_window"]["launches"])
    for name in ("extract_chunks", "blend_forward", "blend_backward") + DUP:
        if launches[name] != 4 * SHARDED_STEPS:
            raise AssertionError(f"the sharded steps launched {name} "
                                 f"{launches[name]} times")
    for name, count in win_launches.items():
        want = 2 * SHARDED_STEPS if name in (
            "extract_windows", "window_blend_forward",
            "window_blend_backward") + DUP else 0
        if count != want:
            raise AssertionError(f"the window path's sharded steps launched "
                                 f"{name} {count} times")
    emit("sharded", seconds=time.perf_counter() - t0,
         tile_ranges_seconds=ranges_s, tile_ranges=ranges,
         window_tile_ranges=win_ranges, sharded_step=ranks,
         launches=dict(launches), window_launches=dict(win_launches))
    return ranges, win_ranges, launches, win_launches


def quantized_depth_view(prep, attr, s, dev) -> dict:
    """The window path's quantized-depth binning (``depth_sort_bits`` =
    ``QDEPTH_BITS``) on one view (``prep``, its attribute rows ``attr``,
    window settings ``s``): the card's quantized depths, counts, overflows
    and live window slots bitwise the CPU's (both sorts are stable, so the
    payload of equal keys is in the same order); kernel D's colours on
    those bins against the plain version on the CPU for the tiles of
    ``QDEPTH_CPU_TILES`` consecutive tile rows from the image's middle,
    within 2e-4; the binning's times beside the exact binning's."""
    import torch
    from das3r_tpu_torch.ops.splat import binning, window_blend
    from das3r_tpu_torch.ops.splat.preprocess import Preprocessed

    sq = dataclasses.replace(s, depth_sort_bits=QDEPTH_BITS)
    if not binning.uses_quantized_depth(sq):
        raise AssertionError(f"{QDEPTH_BITS}-bit keys do not fit 32 bits")
    qb = binning.bin_gaussians(prep, sq)
    cpu = Preprocessed(*(x.cpu() for x in prep))
    qb_cpu = binning.bin_gaussians(cpu, sq)
    dq = binning.quantized_depth(prep.depth, prep.binnable.bool(),
                                 QDEPTH_BITS)
    dq_cpu = binning.quantized_depth(cpu.depth, cpu.binnable.bool(),
                                     QDEPTH_BITS)
    same = torch.equal(dq.cpu(), dq_cpu)
    for f in ("count", "full_count", "delta", "dup_overflow",
              "entry_overflow"):
        same &= torch.equal(getattr(qb, f).cpu(), getattr(qb_cpu, f))
    slot = torch.arange(qb.rank.shape[1])[None, :]
    live = slot < qb_cpu.count[:, None]
    same &= torch.equal(qb.rank.cpu()[live], qb_cpu.rank[live])
    if not same:
        raise AssertionError("the quantized-depth bins differ between the "
                             "card and the CPU")
    bg = torch.zeros(3, device=dev)
    attrs = attr[qb.rank].transpose(1, 2).contiguous()
    colors, _, _ = window_blend.window_forward(attrs, qb.count, qb.delta,
                                               bg, sq)
    rows = QDEPTH_CPU_TILES * s.tiles_x
    t0 = (s.tiles_y // 2) * s.tiles_x
    part = slice(t0, t0 + rows)
    want, _, _ = window_blend.window_forward_plain(
        attrs[part].cpu(), qb.count[part].cpu(), qb.delta[part].cpu(),
        bg.cpu(), sq, t0)
    err = float((colors[part].cpu() - want).abs().max())
    if not err <= BLEND_TOL:
        raise AssertionError(f"quantized-depth colours against the CPU: "
                             f"{err} > {BLEND_TOL}")
    return dict(
        bits=QDEPTH_BITS, bins_bitwise=True, cpu_tiles=[t0, t0 + rows],
        colors_err_vs_cpu=err, live_slots=int(qb.count.sum()),
        tile_overflow=int((qb.full_count > s.max_per_tile).sum()),
        entry_overflow=int(qb.entry_overflow),
        bin_ms=time_ms(lambda: binning.bin_gaussians(prep, sq)),
        exact_bin_ms=time_ms(lambda: binning.bin_gaussians(prep, s)),
        **device_ms(lambda: binning.bin_gaussians(prep, sq),
                    key="bin_device_ms"),
        **device_ms(lambda: binning.bin_gaussians(prep, s),
                    key="exact_bin_device_ms"))


def phase_window_parity(bundle, k_probe: int, dev):
    """Kernels D, E, F against their plain versions on view 0 of the
    trainer's bundle at full size, with K from the probe."""
    import dataclasses

    import numpy as np
    import torch
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.ops.splat import (binning, entry_blend, kernels,
                                           window_blend)

    t0 = time.perf_counter()
    s = dataclasses.replace(bundle.settings, max_per_tile=k_probe,
                            entry_stream=False)
    params, meta, poses = bundle.params, bundle.meta, bundle.poses
    fovx, fovy = (float(bundle.train_data.fovx[0]),
                  float(bundle.train_data.fovy[0]))
    results = []
    with torch.no_grad():
        prep = trainer_view0_prep(bundle, s, dev)
        n = prep.depth.shape[0]

        # --- kernel F: extract_windows --------------------------------
        ks = binning._sorted_key_stream(prep, s)
        keys = binning._pad128(ks.sorted_packed,
                               ((s.n_tiles + 1) << ks.nbits) - 1,
                               extra=k_probe + 128)
        bounds = torch.searchsorted(keys, torch.arange(
            s.n_tiles + 1, dtype=torch.int64, device=dev) << ks.nbits)
        start = bounds[:-1].contiguous()
        full_count = bounds[1:] - start
        args_f = (keys, start, k_probe, ks.nbits, n)
        got = binning.extract_windows(*args_f)
        want = binning.extract_windows_plain(*args_f)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"extract_windows differs on "
                                 f"{int((got != want).sum())} slots")
        mask = (1 << ks.nbits) - 1
        win_idx = start[:, None] + torch.arange(k_probe, device=dev)
        # distinct keys the windows cover (the windows overlap)
        cover = torch.zeros(keys.numel() + 1, dtype=torch.int32, device=dev)
        cover.index_add_(0, start, torch.ones_like(start, dtype=torch.int32))
        cover.index_add_(0, torch.clamp_max(start + k_probe, keys.numel()),
                         -torch.ones_like(start, dtype=torch.int32))
        keys_read = int((torch.cumsum(cover, 0)[:-1] > 0).sum())
        nbytes = keys_read * 8 + start.numel() * 8 + got.numel() * 4
        b_ms, b_by = bound(nbytes)

        def library_f():
            return torch.clamp_max(keys[win_idx] & mask, n - 1).to(
                torch.int32)
        results.append(dict(
            name="extract_windows", route="cuda",
            source="das3r_tpu_torch/csrc/extract_windows.cu",
            replaces="das3r_tpu/ops/splat/binning.py:96",
            max_abs_err=0.0,
            ms=time_ms(lambda: binning.extract_windows(*args_f)),
            **device_ms(lambda: binning.extract_windows(*args_f),
                        "extract_windows_kernel"),
            plain_ms=time_ms(lambda: binning.extract_windows_plain(*args_f)),
            library_ms=time_ms(library_f),
            **device_ms(library_f, key="library_device_ms"),
            library_call="torch.clamp_max(keys[start + arange(K)] & mask, "
                         "n - 1).to(torch.int32)",
            bound_ms=b_ms, bound_by=b_by, slots=got.numel(),
            keys_read=keys_read, bytes=nbytes))

        # --- kernel D: window_blend_forward ---------------------------
        bins = binning.bin_gaussians(prep, s)
        attr = torch.cat([prep.mean2d, prep.conic, prep.color,
                          prep.opacity[:, None]], 1)
        attrs = attr[bins.order][bins.rank].transpose(1, 2).contiguous()
        bg = torch.zeros(3, device=dev)
        args_d = (attrs, bins.count, bins.delta, bg, s)
        out = window_blend.window_forward(*args_d)
        plain = window_blend.window_forward_plain(*args_d)
        torch.cuda.synchronize()
        errs = {name: float((a - b).abs().max())
                for name, a, b in zip(("colors", "tfinal", "tin"), out,
                                      plain)}
        if not max(errs.values()) <= BLEND_TOL:
            raise AssertionError(f"window_blend_forward err {errs}")
        if not torch.equal(out[2] == 0, plain[2] == 0):
            raise AssertionError("window_blend_forward: tin's zero pattern "
                                 "differs from the plain version's")
        chunk = window_blend._pick_chunk(attrs.shape[2])
        tile_slots, n_vis = visited_chunk_work(
            bins.count, bins.delta, plain[2], chunk, s.transmittance_eps)
        slots = int(tile_slots.sum())
        P = s.tile * s.tile
        evals = slots * P
        in_bytes = (n_vis * chunk * 9 * 4
                    + (bins.count.numel() + bins.delta.numel()) * 4)
        out_bytes = sum(x.numel() * 4 for x in out)
        ops_s = max(evals * BLEND_FLOP_PER_EVAL / FP32_FLOP_PER_S,
                    evals / SFU_OPS_PER_S)
        b_ms, b_by = bound(in_bytes + out_bytes, ops_s)
        spread = tile_spread(
            tile_slots, torch.cuda.get_device_properties(0).multi_processor_count)
        results.append(dict(
            name="window_blend_forward", route="cuda",
            source="das3r_tpu_torch/csrc/window_blend_forward.cu",
            replaces="das3r_tpu/ops/splat/pallas_blend.py:145",
            max_abs_err=max(errs.values()), err_by_output=errs,
            ms=time_ms(lambda: window_blend.window_forward(*args_d)),
            **device_ms(lambda: window_blend.window_forward(*args_d),
                        "window_forward_kernel"),
            plain_ms=time_ms(lambda: window_blend.window_forward_plain(
                *args_d)),
            library_ms=None, library_device_ms=None, bound_ms=b_ms,
            bound_by=b_by,
            k_width=int(attrs.shape[2]), chunk=chunk, visited_chunks=n_vis,
            visited_live_slots=slots, pixel_slot_evals=evals,
            live_slots=int(bins.count.sum()),
            tile_overflow=int((full_count > k_probe).sum()),
            tile_spread=spread, blocks_per_sm=blocks_per_sm(
                kernels.library("window_blend_forward"),
                "window_blend_forward", chunk),
            bytes=in_bytes + out_bytes))

        # --- kernel E: window_blend_backward --------------------------
        g = torch.as_tensor(np.random.default_rng(SEED + 8).normal(
            size=tuple(out[0].shape)).astype(np.float32), device=dev)
        args_e = (attrs, bins.count, bins.delta, bg, g, plain[1], plain[2],
                  s)
        want = window_blend.window_backward_plain(*args_e)

        def rel_err(got):
            return {k: float((got[:, c] - want[:, c]).abs().max()
                             / want[:, c].abs().max())
                    for k, c in GROUPS.items()}
        # on the plain forward's tfinal and tin, then on kernel D's: the
        # pair of kernels against the pair of plain versions
        got = window_blend.window_backward(*args_e)
        got_on_d = window_blend.window_backward(*args_e[:5], out[1], out[2],
                                                s)
        torch.cuda.synchronize()
        rel, rel_on_d = rel_err(got), rel_err(got_on_d)
        for what, g_attrs, r in (("plain D's", got, rel),
                                 ("kernel D's", got_on_d, rel_on_d)):
            if not (torch.isfinite(g_attrs).all()
                    and max(r.values()) <= GRAD_TOL):
                raise AssertionError(f"window_blend_backward on {what} "
                                     f"outputs: err / max|g| {r}")
        in_bytes += (g.numel() + plain[1].numel() + plain[2].numel()) * 4
        out_bytes = got.numel() * 4
        ops_s = max(evals * WINDOW_BWD_FLOP_PER_EVAL / FP32_FLOP_PER_S,
                    evals * WINDOW_BWD_SFU_PER_EVAL / SFU_OPS_PER_S)
        b_ms, b_by = bound(in_bytes + out_bytes, ops_s)
        results.append(dict(
            name="window_blend_backward", route="cuda",
            source="das3r_tpu_torch/csrc/window_blend_backward.cu",
            replaces="das3r_tpu/ops/splat/pallas_blend.py:220",
            max_abs_err=float((got - want).abs().max()),
            err_over_max_g=rel, err_over_max_g_on_kernel_d=rel_on_d,
            ms=time_ms(lambda: window_blend.window_backward(*args_e)),
            **device_ms(lambda: window_blend.window_backward(*args_e),
                        "window_backward_kernel"),
            plain_ms=time_ms(lambda: window_blend.window_backward_plain(
                *args_e)),
            library_ms=None, library_device_ms=None, bound_ms=b_ms,
            bound_by=b_by,
            pixel_slot_evals=evals, bytes=in_bytes + out_bytes))

        # --- kernel B against kernel D, and the window image against the
        # entry-stream image ---------------------------------------------
        overflow = int((full_count > k_probe).sum())
        img_err = b_vs_d = None
        if overflow == 0:
            # B on view 0's entry stream, D's outputs above (bg = 0): the
            # same lists in the same order through the one step
            es = binning.bin_entry_stream(prep, bundle.settings)
            b_vs_d = dict(entry_overflow=int(es.entry_overflow))
            if b_vs_d["entry_overflow"] == 0:
                table = torch.cat([attr[es.order], torch.zeros_like(
                    attr[:1])]).contiguous()
                cpre, tfinal_b = entry_blend.blend_forward(
                    table, es.rank, es.astart, es.count, bundle.settings)
                diff = torch.cat([
                    (cpre - out[0].transpose(1, 2)).abs().reshape(-1),
                    (tfinal_b[:, 0] - out[1]).abs().reshape(-1)])
                b_vs_d.update(values=diff.numel(),
                              differ=int((diff != 0).sum()),
                              max_diff=float(diff.max()))
                if not b_vs_d["max_diff"] <= BLEND_TOL:
                    raise AssertionError(f"kernel B differs from kernel D: "
                                         f"{b_vs_d}")
            imgs = [render_mod.render(
                params, meta, dataclasses.replace(s, entry_stream=es),
                poses.pose(0), bg, fovx, fovy, mode="train",
                device=dev).image for es in (False, True)]
            img_err = float((imgs[0] - imgs[1]).abs().max())
            if not img_err <= BLEND_TOL:
                raise AssertionError(f"window image differs from the entry "
                                     f"stream's by {img_err}")
        qdepth = quantized_depth_view(prep, attr, s, dev)
    emit("window_parity", seconds=time.perf_counter() - t0, k_width=k_probe,
         max_tile_entries=int(full_count.max()), tile_overflow=overflow,
         image_err_vs_entry_stream=img_err, b_vs_d=b_vs_d,
         quantized_depth=qdepth,
         d_tile_spread=results[1]["tile_spread"],
         d_blocks_per_sm=results[1]["blocks_per_sm"],
         e_err_over_max_g_on_kernel_d=rel_on_d, kernels=summary(results))
    return results


def split_drops_ok(prep, s, full_keys, keys, nbits) -> int:
    """Raise unless ``keys`` (a split table's, heavy cap ``s``) are a subset
    of ``full_keys`` (the full-width table's) and every key they lack is a
    rect cell at index >= L of a heavy row past the cap (rows in depth
    order). Returns the count of keys they lack."""
    import torch
    L, d_cap = s.light_dup_width, s.max_tiles_per_gaussian
    if not bool(torch.isin(keys, full_keys).all()):
        raise AssertionError("the split table holds a key the full-width "
                             "table does not")
    lost = full_keys[~torch.isin(full_keys, keys)]
    alive = prep.binnable
    order = torch.argsort(torch.where(alive, prep.depth, torch.full_like(
        prep.depth, float("inf"))), stable=True)
    ntt = torch.where(alive, torch.clamp_max(prep.n_tiles_touched, d_cap),
                      torch.zeros_like(prep.n_tiles_touched))[order]
    heavy = ntt > L
    h_pos = torch.cumsum(heavy, 0) - heavy.long()
    over = heavy & (h_pos >= s.heavy_rows_cap)
    rank = lost & ((1 << nbits) - 1)
    g = order[rank]
    tile = lost >> nbits
    width = torch.clamp_min(prep.rect_max[g, 0] - prep.rect_min[g, 0], 1)
    cell = ((tile // s.tiles_x - prep.rect_min[g, 1]) * width
            + tile % s.tiles_x - prep.rect_min[g, 0])
    if not bool((over[rank] & (cell >= L)).all()):
        raise AssertionError("the split table lost a key that is not a "
                             "heavy row's tail past the cap")
    return lost.numel()


def host_heavy_overflow(prep, s) -> int:
    """The JAX package's ``heavy_overflow`` formula on the host, from
    ``ntt`` in depth order: the rect cells past L of the heavy rows beyond
    the first ``heavy_rows_cap``."""
    import numpy as np
    alive = prep.binnable.cpu().numpy()
    depth = np.where(alive, prep.depth.cpu().numpy(), np.inf)
    order = np.argsort(depth, kind="stable")
    ntt = np.where(alive, np.minimum(prep.n_tiles_touched.cpu().numpy(),
                                     s.max_tiles_per_gaussian), 0)[order]
    heavy = ntt > s.light_dup_width
    h_pos = np.cumsum(heavy) - heavy
    over = heavy & (h_pos >= s.heavy_rows_cap)
    return int((ntt - s.light_dup_width)[over].sum())


def split_table_view(name, prep, settings, stats, dev):
    """Bin one view three ways on both raster branches (the full-width
    table; the split ``auto_split_table`` picks from ``stats``; that split
    with half the heavy rows as its cap), gate and time each."""
    import dataclasses

    import torch
    from das3r_tpu_torch.models import autosize
    from das3r_tpu_torch.ops.splat import binning

    n = prep.depth.shape[0]
    d_cap = settings.max_tiles_per_gaussian
    pick = autosize.auto_split_table(stats, n, d_cap)
    picked = pick["heavy_rows_cap"] is not None
    light = pick.get("light_dup_width", 4)
    ntt = torch.clamp_max(prep.n_tiles_touched, d_cap)
    heavy_rows = int(((ntt > light) & prep.binnable).sum())
    cap = pick["heavy_rows_cap"] if picked else autosize.auto_heavy_cap(
        heavy_rows)
    starved_cap = max(1024, heavy_rows // 2 // 1024 * 1024)
    ways = {"full": dataclasses.replace(settings, heavy_rows_cap=None),
            "split": dataclasses.replace(settings, light_dup_width=light,
                                         heavy_rows_cap=cap),
            "starved": dataclasses.replace(settings, light_dup_width=light,
                                           heavy_rows_cap=starved_cap)}
    keys = {}
    for way, st in ways.items():
        ks = binning._sorted_key_stream(prep, st)
        keys[way] = ks.sorted_packed
        if way == "split" and (int(ks.heavy_overflow) != 0 or not
                               torch.equal(ks.sorted_packed, keys["full"])):
            raise AssertionError(f"{name}: the split table's keys differ "
                                 "from the full-width table's")
    nbits = binning.rank_bits(n)
    want = host_heavy_overflow(prep, ways["starved"])
    lost = split_drops_ok(prep, ways["starved"], keys["full"],
                          keys["starved"], nbits)
    fields = {"entry": ("rank", "chunk_tile", "count", "astart"),
              "window": ("rank", "delta", "count", "full_count")}
    binners = {"entry": binning.bin_entry_stream,
               "window": binning.bin_gaussians}
    branches = {}
    for branch, fn in binners.items():
        out = {}
        for way, st in ways.items():
            st = dataclasses.replace(st, entry_stream=branch == "entry")
            res = fn(prep, st)
            if way == "split":
                for f in fields[branch]:
                    if not torch.equal(getattr(res, f),
                                       getattr(out["full"]["bins"], f)):
                        raise AssertionError(f"{name}, {branch}: the split "
                                             f"table's {f} differs")
            if int(res.heavy_overflow) != (want if way == "starved" else 0):
                raise AssertionError(
                    f"{name}, {branch}, {way}: heavy_overflow "
                    f"{int(res.heavy_overflow)}, the formula gives {want}")
            out[way] = dict(bins=res, ms=time_ms(lambda: fn(prep, st)),
                            **device_ms(lambda: fn(prep, st)))
        branches[branch] = {way: {k: v for k, v in o.items() if k != "bins"}
                            for way, o in out.items()}
        torch.cuda.empty_cache()
    return dict(
        scene=name, n_gaussians=n, dup_cap=d_cap,
        split_picked_by_probe=picked, light_dup_width=light,
        heavy_rows_cap=cap, starved_heavy_rows_cap=starved_cap,
        heavy_rows=heavy_rows, probe_dup_hist=list(stats.dup_hist),
        slots_full=n * d_cap, slots_split=n * light + cap * (d_cap - light),
        slots_starved=n * light + starved_cap * (d_cap - light),
        live_keys=keys["full"].numel(), starved_heavy_overflow=want,
        starved_keys_lost=lost, branches=branches)


def phase_split_table(bundle, trainer_stats, model: Path, data,
                      serve_settings, dev):
    """The split-width duplication table against the full-width table on
    view 0 of the trainer scene and of the random serving scene."""
    import numpy as np
    import torch
    from das3r_tpu_torch.eval.render_tool import load_gaussians_ply
    from das3r_tpu_torch.models import autosize
    from das3r_tpu_torch.utils.quat import w2c_to_pose

    t0 = time.perf_counter()
    views = []
    with torch.no_grad():
        prep = trainer_view0_prep(bundle, bundle.settings, dev)
        views.append(split_table_view("trainer view 0", prep,
                                      bundle.settings, trainer_stats, dev))
        del prep
        # the serving scene's probe, as the JAX viewer probes: no conf
        params, meta, _ = load_gaussians_ply(
            str(model / "point_cloud" / "iteration_1" / "point_cloud.ply"),
            SH_DEGREE, dev)
        poses7 = w2c_to_pose(torch.as_tensor(
            np.load(model / "pose" / "pose_1.npy"), device=dev))
        stats = autosize.probe_capacities(
            params, meta, serve_settings, poses7, float(data.fovx[0]),
            float(data.fovy[0]), mode="no_soft")
        del params, meta
        prep = view0_prep(model, data, serve_settings, dev)
        views.append(split_table_view("random view 0", prep, serve_settings,
                                      stats, dev))
        del prep
    torch.cuda.empty_cache()
    emit("split_table", seconds=time.perf_counter() - t0, views=views)


def phase_gui(model: Path, dev):
    """The viewer and its HTTP server on the trainer's entry-stream model:
    real requests, each render's launches, and one panel per mode against
    the same render through the plain versions of kernels A and B."""
    import io
    import json as json_mod
    import threading
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image
    from das3r_tpu_torch.gui import ViewerScene
    from das3r_tpu_torch.gui import server as gui_server
    from das3r_tpu_torch.models import render as render_mod
    from das3r_tpu_torch.ops.splat import binning, entry_blend

    t0 = time.perf_counter()
    scene = ViewerScene.from_model_dir(str(model), TRAINER_ITERS, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    h, w = scene.settings.image_height, scene.settings.image_width
    app = gui_server.ViewerApp(scene)
    srv = gui_server.make_server(app, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def get(path):
        t = time.perf_counter()
        with urllib.request.urlopen(url + path, timeout=120) as r:
            body, ctype = r.read(), r.headers.get("Content-Type")
            if r.status != 200:
                raise AssertionError(f"{path}: HTTP {r.status}")
        return body, ctype, (time.perf_counter() - t) * 1e3

    try:
        page, ctype, _ = get("/")
        if "text/html" not in ctype or b"viewer" not in page:
            raise AssertionError(f"/: {ctype}, {page[:80]!r}")
        state = json_mod.loads(get("/state")[0])
        n_alive = int(scene.meta.alive.sum())
        if state["n_gaussians"] != n_alive:
            raise AssertionError(f"/state: {state}")
        want = {"extract_chunks": 1, "blend_forward": 1, "dup_count": 1,
                "dup_emit": 1}
        yaws = [round(k * 2 * np.pi / 8 / 0.005, 3) for k in range(8)]
        request_ms, pngs, launches = {}, {}, collections.Counter()
        with _Timed(render_mod, "render") as renders:
            for mode in ("rgb", "confidence", "no_soft"):
                for yaw in yaws:
                    (body, ctype, ms), counts = run_counted(
                        lambda: get(f"/render?mode={mode}&yaw={yaw}"))
                    if ctype != "image/png" or counts != {
                            k: want.get(k, 0) for k in counts}:
                        raise AssertionError(f"{mode} yaw {yaw}: {ctype}, "
                                             f"launches {counts}")
                    launches.update(counts)
                    arr = np.asarray(Image.open(io.BytesIO(body)))
                    if arr.shape != (h, w, 3) or arr.min() == arr.max():
                        raise AssertionError(f"{mode} yaw {yaw}: shape "
                                             f"{arr.shape}, blank")
                    request_ms.setdefault(mode, []).append(ms)
                    pngs[mode, yaw] = arr
            traj, ctype, traj_ms = get("/traj")
        if ctype != "image/png" or traj[:4] != b"\x89PNG":
            raise AssertionError(f"/traj: {ctype}")
        overflow = [int(r.aux.entry_overflow) for r in renders.results]
        entries = [int(r.aux.n_contrib_tiles.sum()) for r in renders.results]
        if len(overflow) != 24 or any(overflow):
            raise AssertionError(f"entry_overflow per render {overflow}")
        for yaw in yaws:
            if (np.array_equal(pngs["rgb", yaw], pngs["confidence", yaw])
                    or np.array_equal(pngs["rgb", yaw],
                                      pngs["no_soft", yaw])):
                raise AssertionError(f"yaw {yaw}: the modes render alike")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise AssertionError("the viewer's server thread did not stop")

    # one panel per mode against the plain versions of the table, A and B
    orbit = app.orbit
    plain_chunks = binning.extract_chunks_plain

    def plain_keys(*args):
        return (*binning.dup_keys_plain(*args), None)

    def plain_blend(table, rank, astart, count, settings, **tile_range):
        out = entry_blend.blend_forward_plain(table, rank, astart, count,
                                              settings, **tile_range)
        return out.cpre, out.tfinal

    parity, panel_ms = {}, {}
    kernel_a, kernel_b = binning.extract_chunks, entry_blend.blend_forward
    kernel_dup = binning.dup_keys
    for mode in ("rgb", "confidence", "no_soft"):
        img = scene.render_image(orbit, mode)
        before = kernel_launches()
        binning.extract_chunks = plain_chunks
        entry_blend.blend_forward = plain_blend
        binning.dup_keys = plain_keys
        try:
            plain = scene.render_image(orbit, mode)
        finally:
            binning.extract_chunks = kernel_a
            entry_blend.blend_forward = kernel_b
            binning.dup_keys = kernel_dup
        counts = launches_since(before)
        torch.cuda.synchronize()
        err = float((img - plain).abs().max())
        if (any(counts.values()) or not torch.isfinite(img).all()
                or not err <= BLEND_TOL):
            raise AssertionError(f"{mode}: panel err {err} against the "
                                 f"plain path (launches {counts})")
        parity[mode] = err
        panel_ms[mode] = time_ms(lambda: scene.render_panel(orbit, mode))
    emit("gui", seconds=time.perf_counter() - t0, ply_load_seconds=load_s,
         n_gaussians=n_alive, width=w, height=h, yaws=yaws,
         request_ms_median={m: statistics.median(v)
                            for m, v in request_ms.items()},
         request_ms=request_ms, traj_ms=traj_ms,
         render_ms_median=statistics.median(x * 1e3
                                            for x in renders.seconds),
         render_panel_ms=panel_ms, plain_path_max_abs_err=parity,
         entries_per_render=entries, launches=dict(launches))
    return dict(launches)


def _bundle_copy(bundle):
    """The bundle with its own parameters, poses and meta (the trainer
    updates them in place)."""
    import dataclasses

    def clone(group):
        return None if group is None else dataclasses.replace(group, **{
            f.name: getattr(group, f.name).detach().clone()
            for f in dataclasses.fields(group)})
    return dataclasses.replace(
        bundle, params=clone(bundle.params), meta=clone(bundle.meta),
        poses=clone(bundle.poses), test_poses=clone(bundle.test_poses))


def phase_trainer(bundle, k_probe: int, dev):
    """``train_scene`` on the entry stream and on the window path."""
    import dataclasses
    import math

    import numpy as np
    import torch
    from das3r_tpu_torch.models import densify as densify_mod
    from das3r_tpu_torch.train import checkpoint as ckpt
    from das3r_tpu_torch.train import step as step_mod
    from das3r_tpu_torch.train import trainer
    from das3r_tpu_torch.train.config import OptimizationConfig

    cfg = OptimizationConfig(iterations=TRAINER_ITERS, densify_from_iter=5,
                             densification_interval=10,
                             densify_until_iter=35, opacity_reset_interval=30)
    runs, launches = {}, {}
    want = {"entry_stream": ("extract_chunks", "blend_forward",
                             "blend_backward") + DUP,
            "window": ("extract_windows", "window_blend_forward",
                       "window_blend_backward") + DUP}
    for path, settings in (
            ("entry_stream", bundle.settings),
            ("window", dataclasses.replace(bundle.settings,
                                           entry_stream=False,
                                           max_per_tile=k_probe))):
        model = WORK / f"trainer_model_{path}"
        run_bundle = dataclasses.replace(_bundle_copy(bundle),
                                         settings=settings)
        warns, progress = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # each step, densify event and save timed (a synchronize after each)
        with _Timed(step_mod, "train_step") as steps, \
                _Timed(densify_mod, "densify_and_prune") as dens, \
                _Timed(ckpt, "save_train_state") as save_npz, \
                _Timed(ckpt, "save_scene_ply") as save_ply:
            res, counts = run_counted(lambda: trainer.train_scene(
                run_bundle, cfg, model_path=str(model), log_every=1,
                densify=True, densify_clone=True, densify_split=True,
                testing_iterations={TRAINER_ITERS},
                saving_iterations={TRAINER_ITERS},
                # the compressed checkpoint (~20 s) written and read back
                # on the entry stream only: the window run's state is the
                # same file format
                checkpoint_iterations=({TRAINER_ITERS}
                                       if path == "entry_stream" else set()),
                progress=progress.append, warn=warns.append, device=dev))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[path] = counts
        losses = res.losses
        state = res.state
        finite = all(math.isfinite(x) for x in losses) and all(
            bool(torch.isfinite(getattr(state.params, f.name)).all())
            for f in dataclasses.fields(state.params))
        if not finite or len(losses) != TRAINER_ITERS:
            raise AssertionError(f"{path}: non-finite loss or parameter, or "
                                 f"{len(losses)} losses: {losses}")
        early, later = (statistics.mean(losses[0:11]),
                        statistics.mean(losses[11:22]))
        if not later < early:
            raise AssertionError(f"{path}: mean loss of iterations 12-22 "
                                 f"{later} not below 1-11 {early}")
        files = [model / "point_cloud" / f"iteration_{TRAINER_ITERS}" /
                 "point_cloud.ply",
                 model / "pose" / f"pose_{TRAINER_ITERS}.npy",
                 model / "test_log.txt"]
        if path == "entry_stream":
            files.append(model / f"chkpnt{TRAINER_ITERS}.npz")
        missing = [str(f) for f in files if not f.exists()]
        if missing:
            raise AssertionError(f"{path}: not written: {missing}")
        if path == "entry_stream":
            loaded, meta = ckpt.load_train_state(str(files[-1]), state,
                                                 meta_template=res.meta)
            flat = [ckpt._flatten_with_paths(x)
                    for x in (loaded, state, meta, res.meta)]
            if not (flat[0].keys() == flat[1].keys()
                    and all(np.array_equal(flat[0][k], flat[1][k])
                            for k in flat[0])
                    and all(np.array_equal(flat[2][k], flat[3][k])
                            for k in flat[2])):
                raise AssertionError(f"{path}: the checkpoint reads back "
                                     "different")
            del loaded, flat
        for name in want[path]:
            if counts[name] == 0:
                raise AssertionError(f"{path}: {name} never launched")
        st = res.final_settings
        step_ms = [x * 1e3 for x in steps.seconds]
        runs[path] = dict(
            seconds=seconds, ms_per_iter=seconds * 1e3 / TRAINER_ITERS,
            step_ms_median=statistics.median(step_ms[1:]), step_ms=step_ms,
            densify_seconds=dens.seconds, save_npz_seconds=save_npz.seconds,
            save_ply_seconds=save_ply.seconds,
            iters_per_sec=res.iters_per_sec, losses=losses,
            mean_loss_1_11=early, mean_loss_12_22=later,
            test_psnr=res.test_psnr, progress=progress, warnings=warns,
            alive=int(res.meta.alive.sum()),
            settings=dict(max_per_tile=st.max_per_tile,
                          max_tiles_per_gaussian=st.max_tiles_per_gaussian,
                          max_total_entries=st.max_total_entries,
                          entry_stream=st.entry_stream),
            launches=counts)
        if path == "entry_stream":
            entry_model = model      # the viewer serves it (phase gui)
        else:
            shutil.rmtree(model, ignore_errors=True)
        # one more step of frame 0 on this path, profiled by das3r:: stage
        gt0 = torch.as_tensor(bundle.train_data.images[0], device=dev)
        fov0 = (float(bundle.train_data.fovx[0]),
                float(bundle.train_data.fovy[0]))

        def one_step(state=state, meta=res.meta, st=st):
            return step_mod.train_step(state, meta, 0, gt0, *fov0,
                                       torch.zeros(3, device=dev), st, cfg)
        one_step()
        phase_train_profile(one_step, f"trainer_{path}_step_profile")
        del res, state, run_bundle, one_step
        torch.cuda.empty_cache()
    emit("trainer", iterations=TRAINER_ITERS, runs=runs,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    return launches, entry_model


def stage1_weights():
    """DUST3R_LARGE_CONFIG's weights in the reference checkpoint's layout,
    from the testkit's generator (std 0.02) on the seed."""
    import numpy as np
    from das3r_tpu_torch.models.croco.dust3r import DUST3R_LARGE_CONFIG
    from das3r_tpu_torch.models.croco.testkit import random_torch_state_dict
    t0 = time.perf_counter()
    sd = random_torch_state_dict(DUST3R_LARGE_CONFIG,
                                 np.random.default_rng(SEED))
    return sd, time.perf_counter() - t0


def synthetic_frames(name: str, n_frames: int, seed: int) -> Path:
    """A directory of ``n_frames`` synthetic video frames at 288x512 (the
    stage-1 scene's images)."""
    from das3r_tpu_torch.data import synthetic
    gen, frames = WORK / f"{name}_gen", WORK / f"{name}_frames"
    synthetic.make_synthetic_stage1_dir(str(gen), n_frames=n_frames,
                                        height=HEIGHT, width=WIDTH,
                                        seed=seed)
    frames.mkdir(parents=True)
    for p in sorted(gen.glob("frame_*.png")):
        shutil.copy(p, frames)
    shutil.rmtree(gen)
    return frames


def stage1_flow_net(cls, seed: int):
    """A frozen RAFT or SEA-RAFT on seeded random weights (no checkpoint is
    in the repository), its flow head's last convolution scaled by 0.01:
    random weights otherwise give flows of hundreds of pixels, which the
    flow term's gates drop whole (per pixel above 50, per edge above
    25)."""
    import torch
    from das3r_tpu_torch.predictor import raft

    net = cls()
    state = raft.random_state_dict(net, seed)
    head = ("update_block.flow_head.conv2" if cls is raft.RAFT
            else "flow_head.2")
    for k in ("weight", "bias"):
        state[f"{head}.{k}"] *= 0.01
    raft.load_reference_weights(net, state)
    return net


def stage1_flows(flow_net, images01, edges, dev) -> dict:
    """The flow networks on stage 1's frames: classic RAFT (``flow_net``,
    the one the run's flow term used) on one chunk of ``FLOW_CHUNK``
    edges at 20 iterations, timed (CUDA events), and its first pair on
    the CPU within ``FLOW_CPU_BAR`` x max|CPU|, and timed with cuDNN's
    convolutions against without (``raft.without_cudnn``), in turns;
    SEA-RAFT "M" on the same
    chunk at ``SEARAFT_CHECK_ITERS`` iteration, timed, and its first pair
    on the CPU within the same bar (the CPU test's bar at that iteration
    count; batch norm runs in eval mode, so a pair's flow does not depend
    on the rest of its chunk)."""
    import numpy as np
    import torch
    from das3r_tpu_torch.predictor import raft, searaft

    imgs = torch.as_tensor(np.asarray(images01, np.float32),
                           device=dev) * 255.0
    ei = torch.as_tensor([i for i, _ in edges[:FLOW_CHUNK]], device=dev)
    ej = torch.as_tensor([j for _, j in edges[:FLOW_CHUNK]], device=dev)
    a, b = imgs[ei], imgs[ej]
    out = {}

    def turns(call):
        """(ms without cuDNN, ms with it), each the mean of two turns
        (without, with, with, without), and the two flows' largest
        difference: the convolution choice of ``raft.without_cudnn``."""
        orig = raft.without_cudnn
        ms = {False: [], True: []}
        for cudnn_on in (False, True, True, False):
            raft.without_cudnn = (contextlib.nullcontext if cudnn_on
                                  else orig)
            try:
                ms[cudnn_on].append(time_ms(call, reps=1))
                flow = call()
            finally:
                raft.without_cudnn = orig
            ms[f"flow_{cudnn_on}"] = flow
        diff = float((ms["flow_True"] - ms["flow_False"]).abs().max())
        return dict(ms_without_cudnn=ms[False], ms_with_cudnn=ms[True],
                    max_flow_diff=diff)

    for name, net, iters in (
            ("raft", flow_net, 20),
            ("searaft", stage1_flow_net(searaft.SeaRaft, FLOW_SEED + 1),
             SEARAFT_CHECK_ITERS)):
        net.to(dev)
        got = net(a, b, iters=iters)
        ms = time_ms(lambda: net(a, b, iters=iters), reps=3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = net.to("cpu")(a[:1].cpu(), b[:1].cpu(), iters=iters)
        cpu_s = time.perf_counter() - t0
        scale = float(want.abs().max())
        rel = float((got[:1].cpu() - want).abs().max()) / max(scale, 1e-30)
        if not (torch.isfinite(got).all() and rel <= FLOW_CPU_BAR):
            raise AssertionError(f"{name}: card against CPU {rel} x "
                                 f"max|CPU| > {FLOW_CPU_BAR}")
        out[name] = dict(iters=iters, pairs=FLOW_CHUNK,
                         ms_per_pair=ms / FLOW_CHUNK, chunk_ms=ms,
                         card_vs_cpu_rel=rel, max_flow=scale,
                         cpu_pair_seconds=cpu_s)
        if name == "raft":
            net.to(dev)
            out[name]["cudnn_turns"] = turns(lambda: net(a, b, iters=iters))
        del net
    return out


def phase_stage1(sd, dev):
    """``runner.run_scene`` at DUST3R_LARGE_CONFIG on a 16-frame video;
    encode / decode timings in float32 and with a bfloat16 trunk; one pair
    on the card against the same model on the CPU."""
    import dataclasses
    import math

    import numpy as np
    import torch
    from das3r_tpu_torch.models.croco.convert import load_reference_state_dict
    from das3r_tpu_torch.models.croco.dust3r import (DUST3R_LARGE_CONFIG,
                                                     AsymmetricCroCo3D)
    from das3r_tpu_torch.predictor import (alignment, inference,
                                           mask_refine, pairs, raft, runner)

    frames = synthetic_frames("stage1", STAGE1_FRAMES, SEED + 11)
    out_dir = WORK / "stage1_out"
    t0 = time.perf_counter()
    model = AsymmetricCroCo3D(DUST3R_LARGE_CONFIG)
    load_reference_state_dict(model, sd)
    model.to(dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.reset_peak_memory_stats()
    stats, progress, loop_args = {}, [], {}
    optimize = alignment.optimize

    def keep_args(params, *args, **kw):
        """the loop's inputs, its parameters as they enter, for the
        profile below"""
        loop_args.update(args=args, kw=kw, params=dataclasses.replace(
            params, **{f.name: getattr(params, f.name).detach().clone()
                       for f in dataclasses.fields(params)}))
        return optimize(params, *args, **kw)
    alignment.optimize = keep_args
    flow_net = stage1_flow_net(raft.RAFT, FLOW_SEED)
    try:
        res, launches = run_counted(lambda: runner.run_scene(
            str(frames), str(out_dir), model, device=dev, stats=stats,
            verbose=progress.append, raft_params=flow_net,
            mask_refiner=mask_refine.NeighborPropagator()))
    finally:
        alignment.optimize = optimize
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    sc = res.scene
    if stats["n_edges"] != STAGE1_EDGES or res.n_frames != STAGE1_FRAMES:
        raise AssertionError(f"{res.n_frames} frames, {stats['n_edges']} "
                             f"edges")
    bad = [k for k in ("depths", "poses_c2w", "focals", "intrinsics",
                       "im_conf", "dyna_avg", "dyna_max")
           if not np.isfinite(getattr(sc, k)).all()]
    al = stats["align"]
    if bad or not math.isfinite(sc.final_loss):
        raise AssertionError(f"non-finite stage-1 output: {bad}, loss "
                             f"{sc.final_loss}")
    if not al["last_loss"] < al["first_loss"]:
        raise AssertionError(f"the alignment loss did not fall: "
                             f"{al['first_loss']} -> {al['last_loss']}")
    want = ["pred_traj.txt", "pred_intrinsics.txt"] + [
        f"{p}_{i:04d}.{ext}" for i in range(STAGE1_FRAMES)
        for p, ext in (("frame", "png"), ("frame", "npy"), ("conf", "npy"),
                       ("dyna_avg", "npy"), ("dyna_max", "npy"),
                       ("dynamic_mask", "png"),
                       ("enlarged_dynamic_mask", "png"))]
    missing = [f for f in want if not (out_dir / f).exists()]
    if missing:
        raise AssertionError(f"stage 1 did not write {missing[:6]}")
    if any(launches.values()):
        raise AssertionError(f"stage 1 launched a raster kernel: {launches}")

    # encode ms per frame, decode ms per pair (CUDA events, batches of 8)
    images01, _ = runner.load_frames(str(frames))
    imgs = torch.as_tensor(inference.normalize_images(images01),
                           dtype=torch.float32, device=dev)
    edges = pairs.make_pairs(STAGE1_FRAMES,
                             pairs.eval_scene_graph(STAGE1_FRAMES))
    ei = torch.as_tensor([i for i, _ in edges[:8]], device=dev)
    ej = torch.as_tensor([j for _, j in edges[:8]], device=dev)
    # the runner's first decode batch, its first STAGE1_CPU_PAIRS pairs:
    # their tokens gathered from the frames they read, encoded in one batch
    # as the runner encodes
    checked = edges[:STAGE1_CPU_PAIRS]
    used = sorted({k for e in checked for k in e})
    li = torch.as_tensor([used.index(i) for i, _ in checked])
    lj = torch.as_tensor([used.index(j) for _, j in checked])

    def first_batch(m, on):
        on = torch.device(on)
        feats, poss = inference.encode_frames(m, imgs[used].to(on))
        return [{k: v.float().cpu() for k, v in r.items()}
                for r in inference.decode_pairs(m, feats, poss, li.to(on),
                                                lj.to(on), HEIGHT, WIDTH)]

    def timings(m):
        feats, poss = inference.encode_frames(m, imgs)
        return dict(
            encode_ms_per_frame=time_ms(
                lambda: inference.encode_frames(m, imgs[:8])) / 8,
            decode_ms_per_pair=time_ms(
                lambda: inference.decode_pairs(m, feats, poss, ei, ej,
                                               HEIGHT, WIDTH)) / 8)
    timing = {"float32": timings(model)}
    # where the time goes: 10 alignment iterations from the loop's start,
    # and one decode batch of 8 pairs (float32)
    edge, dyn, cfg, *shape = loop_args["args"]
    prof_align, _ = profile_call(lambda: optimize(
        loop_args["params"], edge, dyn, dataclasses.replace(cfg, niter=10),
        *shape, **{**loop_args["kw"], "losses": None}))
    del loop_args, edge, dyn
    feats, poss = inference.encode_frames(model, imgs)
    prof_decode, _ = profile_call(lambda: inference.decode_pairs(
        model, feats, poss, ei, ej, HEIGHT, WIDTH))
    del feats, poss
    card = first_batch(model, dev)
    m16 = AsymmetricCroCo3D(dataclasses.replace(DUST3R_LARGE_CONFIG,
                                                dtype=torch.bfloat16))
    load_reference_state_dict(m16, sd)
    timing["bf16_trunk"] = timings(m16.to(dev))
    card16 = first_batch(m16, dev)
    del m16
    torch.cuda.empty_cache()

    # that batch on the CPU in float32: the card's float32 maps within
    # STAGE1_CPU_BAR x max|CPU|; the bfloat16 trunk's within the JAX
    # package's bf16 bars (tests/test_croco_model.py:165-170)
    t1 = time.perf_counter()
    cpu = first_batch(model.to("cpu"), "cpu")
    cpu_s = time.perf_counter() - t1
    del model
    errs, bf16 = {}, {}
    for v, (rc, rg, rb) in enumerate(zip(cpu, card, card16)):
        for k in rc:
            ref, got = rc[k].numpy(), rg[k].numpy()
            if not (np.isfinite(got).all() and np.isfinite(rb[k]).all()):
                raise AssertionError(f"non-finite {k} on the card")
            scale = float(np.abs(ref).max())
            errs[f"view{v + 1}_{k}"] = dict(
                max_abs_err=float(np.abs(got - ref).max()), max_ref=scale,
                rel=float(np.abs(got - ref).max()) / max(scale, 1e-30))
        pts = "pts3d" if v == 0 else "pts3d_in_other_view"
        bf16[f"view{v + 1}"] = dict(
            dynamic_mask_mean_abs=float(
                (rb["dynamic_mask"] - rc["dynamic_mask"]).abs().mean()),
            pts3d_median_rel=float(((rb[pts] - rc[pts]).abs()
                                    / (rc[pts].abs() + 1e-3)).median()))
    worst = max(e["rel"] for e in errs.values())
    if not worst <= STAGE1_CPU_BAR:
        raise AssertionError(f"card against CPU {worst} x max|ref| > "
                             f"{STAGE1_CPU_BAR}: {errs}")
    for v, e in bf16.items():
        if not (e["dynamic_mask_mean_abs"] < STAGE1_BF16_MASK_MEAN
                and e["pts3d_median_rel"] < STAGE1_BF16_PTS_MEDIAN_REL):
            raise AssertionError(f"bfloat16 trunk against the CPU, {v}: "
                                 f"{e}")
    flows = stage1_flows(flow_net, images01, edges, dev)
    del flow_net
    torch.cuda.empty_cache()
    niter = alignment.AlignerConfig().niter
    emit("stage1", frames=STAGE1_FRAMES, height=HEIGHT, width=WIDTH,
         graph=stats["graph"], edges=stats["n_edges"], n_params=n_params,
         model_load_seconds=load_s,
         peak_mem_gb=peak_gb, seconds=stats["total_s"],
         load_frames_s=stats["load_s"], inference_s=stats["inference_s"],
         align_s=stats["align_s"], save_s=stats["save_s"],
         flow_s=stats["flow_s"], refine_s=stats["refine_s"],
         flow_ms_per_pair_in_run=stats["flow_s"] * 1e3 / (
             2 * stats["n_edges"]),
         flows=flows,
         init_s=al["init_s"], to_device_s=al["to_device_s"],
         align_loop_s=al["loop_s"],
         align_ms_per_iter=al["loop_s"] * 1e3 / niter,
         first_loss=al["first_loss"], last_loss=al["last_loss"],
         focal=float(sc.focals[0]),
         depth_range=[float(sc.depths.min()), float(sc.depths.max())],
         dynamic_share=float(sc.dynamic_masks.mean()), timing=timing,
         profile_align_10_iters=prof_align,
         profile_decode_8_pairs=prof_decode,
         tf32=dict(matmul=torch.backends.cuda.matmul.allow_tf32,
                   cudnn=torch.backends.cudnn.allow_tf32),
         card_vs_cpu_pairs=checked, card_vs_cpu=errs,
         card_vs_cpu_worst=worst, card_vs_cpu_bar=STAGE1_CPU_BAR,
         bf16_vs_cpu=bf16, cpu_batch_seconds=cpu_s,
         launches=launches, progress=progress)
    return launches


def phase_pipeline(sd, dev):
    """``pipeline.run`` from a .pth written here: 8 frames at size 256,
    stage 1 at DUST3R_LARGE_CONFIG, the bridge, 20 stage-2 iterations and
    the renders; each stage's kernel launches."""
    import math

    import torch
    from das3r_tpu_torch import pipeline
    from das3r_tpu_torch.eval import render_tool
    from das3r_tpu_torch.models.croco.dust3r import DUST3R_LARGE_CONFIG
    from das3r_tpu_torch.models.croco.testkit import save_reference_checkpoint
    from das3r_tpu_torch.train import scene_setup, trainer

    frames = synthetic_frames("pipeline", PIPELINE_FRAMES, SEED + 13)
    ckpt = WORK / "das3r_random.pth"
    t0 = time.perf_counter()
    save_reference_checkpoint(ckpt, sd, DUST3R_LARGE_CONFIG)
    save_s = time.perf_counter() - t0
    cfg = pipeline.PipelineConfig(ckpt=str(ckpt), iterations=PIPELINE_ITERS,
                                  size=PIPELINE_SIZE)
    progress = []
    with _Timed(scene_setup, "build_scene") as probe, \
            _Timed(trainer, "train_scene") as train, \
            _Timed(render_tool, "render_sets") as render:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out, launches = run_counted(lambda: pipeline.run(
            str(frames), str(WORK / "pipeline"), cfg,
            verbose=progress.append, device=dev))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
    if not math.isfinite(out["final_loss"]):
        raise AssertionError(f"stage-2 loss {out['final_loss']}")
    by_stage = {"probe": dict(probe.launches),
                "train": dict(train.launches),
                "render": dict(render.launches)}
    want = {"probe": ("extract_windows", "window_blend_forward") + DUP,
            "train": ("extract_chunks", "blend_forward", "blend_backward")
            + DUP,
            "render": ("extract_chunks", "blend_forward") + DUP}
    for stage, names in want.items():
        for k in names:
            if not by_stage[stage].get(k):
                raise AssertionError(f"pipeline {stage}: {k} never "
                                     f"launched: {by_stage}")
    renders = sorted(Path(out["model_path"]).glob(
        f"renders_{PIPELINE_ITERS}/*.png"))
    if len(renders) != PIPELINE_FRAMES or not Path(out["video"]).exists():
        raise AssertionError(f"{len(renders)} renders, video "
                             f"{out['video']}")
    stage1 = [x for x in progress if str(x).startswith("stage1")]
    emit("pipeline", frames=PIPELINE_FRAMES, size=PIPELINE_SIZE,
         iterations=PIPELINE_ITERS, seconds=seconds,
         ckpt_save_seconds=save_s,
         build_scene_seconds=probe.seconds,
         train_scene_seconds=train.seconds,
         render_sets_seconds=render.seconds,
         final_loss=out["final_loss"], iters_per_sec=out["iters_per_sec"],
         video=Path(out["video"]).name, launches=launches,
         launches_by_stage=by_stage, stage1_progress=stage1)
    return launches


class _Rendered:
    """A dataset whose every render's seconds are kept (``seconds``, one a
    sample rendered): its samples are made once up front, rendering as
    set-up, or with ``eager=False`` each time one is asked for."""

    def __init__(self, dataset, eager: bool = True):
        self.dataset, self.seconds, self.items = dataset, [], None
        if eager:
            self.items = [self._render(i) for i in range(len(dataset))]

    def _render(self, i):
        t0 = time.perf_counter()
        out = self.dataset[i]
        self.seconds.append(time.perf_counter() - t0)
        return out

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        return self._render(i) if self.items is None else self.items[i]


def _timed_steps(orig, times: list, losses: list):
    """``orig`` (``training.make_train_step``) whose every step is timed
    on the host clock after a synchronize, its losses kept."""
    import torch

    def make(*args, **kw):
        step = orig(*args, **kw)

        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*a, **k)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append([float(x) for x in out])
            return out
        return timed
    return make


def script_module(name: str):
    """``scripts/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_recipe(dev):
    """``scripts/torch_train_tiny_stage1.py`` as a module, and its
    arguments at ``TINY_ARGV`` on ``dev``, writing to WORK/tiny."""
    script = script_module("torch_train_tiny_stage1")
    return script, script.parse_args(
        [*TINY_ARGV, "--device", str(dev), "--out", str(WORK / "tiny")])


def tiny_run(dev) -> dict:
    """(b): TINY from scratch through the TINY script's data sets, configs
    and ``train`` at ``TINY_ARGV`` on ``dev`` (checkpoint-last once, at
    the end: the script's default writes all 72M parameters and their
    moments, ~870 MB, every epoch), its ``stage1_tiny.npz`` under
    WORK/tiny; the held-out IoU at its bar and no raster launch."""
    import math

    from das3r_tpu_torch.predictor import train_loop

    script, args = tiny_recipe(dev)

    def run():
        t0 = time.perf_counter()
        train, test = (_Rendered(d) for d in script.datasets(args))
        render_s = time.perf_counter() - t0
        tcfg, lcfg = script.configs(args)
        lcfg = dataclasses.replace(lcfg, save_freq=args.epochs)
        with _Timed(train_loop, "_save_ckpt") as ckpt, \
                _Timed(train_loop, "evaluate_stats") as evals:
            record, _, hist = script.train(args, train, test, tcfg, lcfg,
                                           progress=lambda *_: None)
        return record, hist, render_s, tcfg, lcfg, ckpt, evals

    (record, hist, render_s, tcfg, lcfg, ckpt, evals), launches = \
        run_counted(run)
    iou = record["value"]
    if not (iou >= TINY_IOU_BAR and not any(launches.values()) and all(
            math.isfinite(h["train_loss"]) for h in hist)):
        raise AssertionError(f"TINY held-out mask IoU {iou} (bar "
                             f"{TINY_IOU_BAR}), launches {launches}: "
                             f"{hist[-1]}")
    fit_s = record["seconds"]["train"]
    steps = args.epochs * tcfg.steps_per_epoch
    return dict(
        record=record, heldout_mask_iou=iou, jax_record_iou=JAX_TINY_IOU,
        iou_bar=TINY_IOU_BAR, argv=list(TINY_ARGV), steps=steps,
        save_freq=lcfg.save_freq, render_data_s=render_s, fit_s=fit_s,
        checkpoint_writes=len(ckpt.seconds), checkpoint_s=sum(ckpt.seconds),
        test_passes=len(evals.seconds), test_s=sum(evals.seconds),
        step_ms_loop=1e3 * (fit_s - sum(ckpt.seconds) - sum(evals.seconds))
        / steps, first_train_loss=hist[0]["train_loss"],
        final_train_loss=hist[-1]["train_loss"],
        test_loss_med=[h.get("test_wall_loss_med") for h in hist
                       if "test_wall_loss_med" in h], launches=launches)


def tiny_child(out: str, dev: str) -> None:
    """``tiny_run`` in a process of its own, its result written to
    ``out`` as JSON."""
    Path(out).write_text(json.dumps(tiny_run(dev)))


def tiny_trained(dev):
    """(b)'s trained TINY, read back from its ``stage1_tiny.npz`` (every
    tensor, the upsampling biases untied first), on ``dev``."""
    from das3r_tpu_torch.models.croco.dpt import untie_upsample_bias
    from das3r_tpu_torch.models.croco.dust3r import AsymmetricCroCo3D
    from das3r_tpu_torch.models.croco.testkit import TINY
    from das3r_tpu_torch.predictor import train_loop
    model = AsymmetricCroCo3D(TINY)
    untie_upsample_bias(model)
    train_loop.load_params_npz(str(WORK / "tiny" / "stage1_tiny.npz"),
                               model)
    return model.to(dev)


@functools.lru_cache(maxsize=1)
def tiny_weights() -> dict:
    """TINY's weights from the testkit's generator on seed 0 (numpy)."""
    import numpy as np
    from das3r_tpu_torch.models.croco.testkit import (TINY,
                                                      random_torch_state_dict)
    return random_torch_state_dict(TINY, np.random.default_rng(0))


def tiny_model(dev):
    from das3r_tpu_torch.models.croco.convert import load_reference_state_dict
    from das3r_tpu_torch.models.croco.dust3r import AsymmetricCroCo3D
    from das3r_tpu_torch.models.croco.testkit import TINY
    model = AsymmetricCroCo3D(TINY)
    load_reference_state_dict(model, tiny_weights())
    return model.to(dev)


def stage1_card_vs_cpu(batch, lr: float, dev) -> dict:
    """``S1T_CPU_STEPS`` steps of the TINY model (freeze none, lr 1e-3) on
    one batch, on the card and on the CPU, at the recipe's eps and at
    ``S1T_SMOOTH_EPS``: every loss within STAGE1_CPU_BAR x |CPU|; at the
    smooth eps every mask-head tensor within STAGE1_CPU_BAR x max|CPU|,
    at the recipe's the share of elements beyond that bar reported."""
    import numpy as np
    import torch
    from das3r_tpu_torch.predictor import training
    img1, img2, b = batch
    out = {}
    for name, eps in (("recipe_eps", training.Stage1TrainConfig().eps),
                      ("smooth_eps", S1T_SMOOTH_EPS)):
        runs = {}
        for on in (dev, "cpu"):
            model = tiny_model(on)
            train, _ = training.split_params(model, "none")
            cfg = training.Stage1TrainConfig(
                lr=lr, warmup_epochs=0.0, steps_per_epoch=10,
                epochs=10, freeze="none", eps=eps)
            step = training.make_train_step(model, cfg)
            opt = training.adamw_init(train)
            losses = [[float(x) for x in step(
                train, opt, torch.as_tensor(img1, device=on),
                torch.as_tensor(img2, device=on), b.to(on), i)]
                for i in range(S1T_CPU_STEPS)]
            runs[on] = (np.asarray(losses), {
                k: v.detach().cpu().numpy() for k, v in train.items()
                if k.startswith(training.TRAINABLE_KEYS)})
        (lg, pg), (lc, pc) = runs[dev], runs["cpu"]
        loss_rel = float((np.abs(lg - lc) / np.abs(lc)).max())
        rels = {k: float(np.abs(pg[k] - pc[k]).max() / np.abs(pc[k]).max())
                for k in pc}
        over = sum(int((np.abs(pg[k] - pc[k])
                        > STAGE1_CPU_BAR * np.abs(pc[k]).max()).sum())
                   for k in pc)
        out[name] = dict(eps=eps, loss_rel=loss_rel,
                         param_rel_worst=max(rels.values()),
                         params_beyond_bar=over,
                         params=sum(v.size for v in pc.values()))
        if not loss_rel <= STAGE1_CPU_BAR:
            raise AssertionError(f"stage-1 steps, {name}: losses card "
                                 f"against CPU {loss_rel} > bar: {out}")
        if name == "smooth_eps" and not max(rels.values()) <= STAGE1_CPU_BAR:
            raise AssertionError(f"stage-1 steps: mask heads card against "
                                 f"CPU {max(rels.values())} > bar: {out}")
    return out


def stage1_fit_args(work: Path, spec: dict, device):
    """(model, train set, test sets, train config, loop config) of a data-
    parallel part from its ``spec`` and ``weights.npz`` under ``work``,
    the model made on ``device`` (its initialization on the host takes
    seconds at full width); the sets render when asked
    (``_Rendered(eager=False)``)."""
    import numpy as np
    import torch
    from das3r_tpu_torch.models.croco.convert import load_reference_state_dict
    from das3r_tpu_torch.models.croco.dust3r import (DUST3R_LARGE_CONFIG,
                                                     AsymmetricCroCo3D)
    from das3r_tpu_torch.models.croco.testkit import TINY
    from das3r_tpu_torch.predictor import train_loop, training
    from das3r_tpu_torch.predictor.datasets import WallTwoViewDataset
    with torch.device(device):
        model = AsymmetricCroCo3D(TINY if spec["config"] == "TINY"
                                  else DUST3R_LARGE_CONFIG)
    with np.load(work / "weights.npz") as z:
        load_reference_state_dict(model, dict(z))
    return (model, _Rendered(WallTwoViewDataset(**spec["train"]), False),
            {"wall": _Rendered(WallTwoViewDataset(**spec["test"]), False)},
            training.Stage1TrainConfig(**spec["train_cfg"]),
            train_loop.Stage1LoopConfig(**spec["loop"]))


class Stage1FitProbe:
    """While entered, counts each file that ``train_loop.fit`` writes, by
    name (``wrote``), and keeps each fit's trainable parameters and AdamW
    state (``states``, from ``training.adamw_init``): ``digest()`` hashes
    the last. Used by the data-parallel ranks here and in
    ``tests/torch_parallel_workers.py``."""

    def __enter__(self):
        from das3r_tpu_torch.predictor import train_loop, training
        self.wrote, self.states = collections.Counter(), []
        self._orig = (train_loop._save_ckpt, train_loop._log_epoch,
                      training.adamw_init)

        def counted(fn):
            def write(path, *args):
                self.wrote[Path(path).name] += 1
                return fn(path, *args)
            return write

        def init(params):
            self.states.append((params, self._orig[2](params)))
            return self.states[-1][1]
        train_loop._save_ckpt = counted(self._orig[0])
        train_loop._log_epoch = counted(self._orig[1])
        training.adamw_init = init
        return self

    def __exit__(self, *exc):
        from das3r_tpu_torch.predictor import train_loop, training
        (train_loop._save_ckpt, train_loop._log_epoch,
         training.adamw_init) = self._orig

    def digest(self) -> str:
        """One hash of the last fit's trainable tensors and AdamW state."""
        import hashlib
        params, opt = self.states[-1]
        h = hashlib.sha256()
        for tree in (params, opt.mu, opt.nu):
            for k, v in tree.items():
                h.update(k.encode())
                h.update(v.detach().cpu().numpy().tobytes())
        h.update(opt.count.cpu().numpy().tobytes())
        return h.hexdigest()


def stage1_fit_rank(rank: int, work: str, device: str) -> None:
    """One of the two ranks of ``stage1_fit_parallel``, in a process of its
    own on ``device`` (``cuda``: both ranks on card 0, gloo):
    ``train_loop.fit(mesh=make_mesh(data=2))`` on the part in
    ``spec.json``, into ``out/``. Writes ``rank<r>.json``: the history,
    the steps' ms and losses, a hash of the parameters and AdamW state,
    the files this rank wrote, its render seconds, its collectives, its
    peak memory and its raster-kernel launches."""
    import torch
    import torch.distributed as dist
    from das3r_tpu_torch.parallel import comm_stats, multihost
    from das3r_tpu_torch.parallel.mesh import make_mesh
    from das3r_tpu_torch.predictor import train_loop, training

    t_start = time.perf_counter()
    work = Path(work)
    spec = json.loads((work / "spec.json").read_text())
    multihost.initialize_distributed(f"file://{work / 'store'}", 2, rank,
                                     device=device)
    try:
        mesh = make_mesh(data=2)
        model, train, tests, tcfg, lcfg = stage1_fit_args(work, spec,
                                                          device)
        lcfg = dataclasses.replace(lcfg, out_dir=str(work / "out"))
        step_s, step_losses = [], []
        make_step = training.make_train_step
        training.make_train_step = _timed_steps(make_step, step_s,
                                                step_losses)
        if device.startswith("cuda"):
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        try:
            with comm_stats.CommStats() as stats, Stage1FitProbe() as probe:
                t0 = time.perf_counter()
                (_, hist), launches = run_counted(lambda: train_loop.fit(
                    model, train, tests, tcfg, lcfg, mesh=mesh,
                    progress=lambda *_: None, device=device))
                fit_s = time.perf_counter() - t0
        finally:
            training.make_train_step = make_step
        grads = [b for _, tag, b in stats.calls if tag == "stage1_grads"]
        sets = [train, *tests.values()]
        out = dict(
            rank=rank, history=hist, setup_s=setup_s, fit_s=fit_s,
            step_ms=[1e3 * t for t in step_s], losses=step_losses,
            digest=probe.digest(), wrote=dict(probe.wrote),
            trainable_params=sum(p.numel()
                                 for p in probe.states[-1][0].values()),
            render_s=sum(sum(d.seconds) for d in sets),
            rendered=sum(len(d.seconds) for d in sets),
            grads_bytes_per_step=sum(grads) / max(len(step_s), 1),
            grads_calls_per_step=len(grads) / max(len(step_s), 1),
            comm=stats.families(), launches=launches,
            peak_mem_gb=(torch.cuda.max_memory_allocated() / 2**30
                         if device.startswith("cuda") else None))
        (work / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def stage1_fit_parallel(name: str, spec: dict, weights: dict, dev):
    """``stage1_fit_rank`` on two spawned ranks sharing ``dev``, on the
    part ``spec`` from ``weights`` (the reference layout); each rank's
    results and the part's work directory."""
    import numpy as np
    import torch.multiprocessing as mp
    work = WORK / f"stage1_dp_{name}"
    work.mkdir(parents=True)
    (work / "spec.json").write_text(json.dumps(spec))
    t0 = time.perf_counter()
    np.savez(work / "weights.npz", **weights)
    write_s = time.perf_counter() - t0
    ctx = mp.start_processes(stage1_fit_rank, args=(str(work), str(dev)),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + S1T_DP_TIMEOUT
    while not ctx.join(timeout=5):      # raises on a rank's failure
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            for proc in ctx.processes:
                proc.join(10)
            raise AssertionError(f"stage-1 ranks ({name}) ran past "
                                 f"{S1T_DP_TIMEOUT} s")
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(2)]
    for r in ranks:
        r.update(weights_write_s=write_s,
                 ranks_s=time.perf_counter() - t0 - write_s)
    return ranks, work


def check_ranks(name: str, ranks: list, steps: int) -> None:
    """What every data-parallel part must show: its steps, finite losses,
    the same history and bitwise the same parameters and AdamW state on
    both ranks, every file written by rank 0 alone, one ``stage1_grads``
    all-reduce a step of the trainable parameters' float32 bytes, and no
    raster kernel launched."""
    import math
    r0, r1 = ranks
    bad = [r["rank"] for r in ranks if len(r["losses"]) != steps
           or not all(math.isfinite(x) for row in r["losses"] for x in row)]
    if bad:
        raise AssertionError(f"stage-1 ranks ({name}): steps or losses of "
                             f"ranks {bad}")
    if r0["digest"] != r1["digest"] or r0["history"] != r1["history"]:
        raise AssertionError(f"stage-1 ranks ({name}) differ: "
                             f"{r0['digest']} {r1['digest']}")
    if r1["wrote"] or not r0["wrote"].get("checkpoint-final.npz"):
        raise AssertionError(f"stage-1 ranks ({name}) wrote {r0['wrote']} "
                             f"and {r1['wrote']}")
    for r in ranks:
        if (r["grads_calls_per_step"] != 1 or r["grads_bytes_per_step"]
                != 4 * r["trainable_params"]):
            raise AssertionError(f"stage-1 ranks ({name}): stage1_grads "
                                 f"{r['grads_calls_per_step']} calls, "
                                 f"{r['grads_bytes_per_step']} B a step")
        if any(r["launches"].values()):
            raise AssertionError(f"stage-1 ranks ({name}) launched a raster "
                                 f"kernel: {r['launches']}")


def stage1_dp_tiny(dev) -> dict:
    """(d1): TINY's ``fit`` on two ranks against the one-rank ``fit`` on
    the card, (b)'s data and recipe for ``S1T_DP_EPOCHS`` epochs at Adam
    eps ``S1T_SMOOTH_EPS``, a test pass every epoch."""
    import numpy as np
    from das3r_tpu_torch.predictor import train_loop
    script, args = tiny_recipe(dev)
    train_ds, test_ds = script.datasets(args)
    tcfg, lcfg = script.configs(args)
    spec = dict(
        config="TINY",
        train=dict(n=train_ds.n, resolution=list(train_ds.resolution),
                   seed=train_ds.seed),
        test=dict(n=test_ds.n, resolution=list(test_ds.resolution),
                  seed=test_ds.seed),
        train_cfg=dict(dataclasses.asdict(tcfg), eps=S1T_SMOOTH_EPS),
        loop=dict(epochs=S1T_DP_EPOCHS, batch_size=lcfg.batch_size,
                  eval_freq=1, save_freq=S1T_DP_EPOCHS + 1))
    ranks, work = stage1_fit_parallel("tiny", spec, tiny_weights(), dev)
    steps = S1T_DP_EPOCHS * tcfg.steps_per_epoch
    check_ranks("d1", ranks, steps)
    # the one-rank fit on the card, from the same files
    model, train, tests, tcfg, lcfg = stage1_fit_args(work, spec, dev)
    t0 = time.perf_counter()
    _, one_hist = train_loop.fit(
        model, train, tests, tcfg,
        dataclasses.replace(lcfg, out_dir=str(work / "one")),
        progress=lambda *_: None, device=dev)
    one_s = time.perf_counter() - t0
    loss_rel = max(abs(g[k] - w[k]) / abs(w[k])
                   for g, w in zip(ranks[0]["history"], one_hist)
                   for k in w if "loss" in k)
    with np.load(work / "out" / "checkpoint-final.npz") as zg, \
            np.load(work / "one" / "checkpoint-final.npz") as zw:
        heads = [k for k in zw.files if k.startswith("['params']")
                 and "downstream_head_dynamic_mask" in k]
        rels = {k: float(np.abs(zg[k] - zw[k]).max() / np.abs(zw[k]).max())
                for k in heads}
    shutil.rmtree(work)
    out = dict(
        epochs=S1T_DP_EPOCHS, steps=steps, eps=S1T_SMOOTH_EPS,
        loss_rel=loss_rel, mask_heads_rel_worst=max(rels.values()),
        mask_head_tensors=len(rels), bar=S1T_DP_BAR,
        ranks_bitwise=True, rank1_wrote=ranks[1]["wrote"],
        rank0_wrote=ranks[0]["wrote"], fit_s=[r["fit_s"] for r in ranks],
        setup_s=[r["setup_s"] for r in ranks], ranks_s=ranks[0]["ranks_s"],
        one_rank_fit_s=one_s,
        step_ms_median=[statistics.median(r["step_ms"]) for r in ranks],
        render_s=[r["render_s"] for r in ranks],
        peak_mem_gb=[r["peak_mem_gb"] for r in ranks],
        comm=ranks[0]["comm"], history=ranks[0]["history"],
        one_rank_history=one_hist)
    if not (loss_rel <= S1T_DP_BAR and max(rels.values()) <= S1T_DP_BAR):
        raise AssertionError(f"(d1) two ranks against one: {out}")
    return out


def stage1_dp_full(sd, one_rank_render_s: float, dev) -> dict:
    """(d2): (a)'s recipe at full width on two ranks, a global batch of
    ``S1T_BATCH`` for ``S1T_DP_STEPS`` steps, a test pass over one batch;
    ``one_rank_render_s`` is (a)'s render of the same samples."""
    spec = dict(
        config="DUST3R_LARGE_CONFIG",
        train=dict(n=S1T_BATCH * S1T_DP_STEPS, resolution=list(S1T_RES),
                   seed=1),
        test=dict(n=S1T_BATCH, resolution=list(S1T_RES), seed=999),
        train_cfg=dict(epochs=1, steps_per_epoch=S1T_DP_STEPS),
        loop=dict(epochs=1, batch_size=S1T_BATCH, save_freq=2))
    ranks, work = stage1_fit_parallel("full", spec, sd, dev)
    check_ranks("d2", ranks, S1T_DP_STEPS)
    shutil.rmtree(work)
    return dict(
        config=spec["config"], resolution=list(S1T_RES),
        global_batch=S1T_BATCH, rows_a_rank=S1T_BATCH // 2,
        steps=S1T_DP_STEPS, trainable_params=ranks[0]["trainable_params"],
        step_ms=[r["step_ms"] for r in ranks],
        step_ms_median_2_3=[statistics.median(r["step_ms"][1:])
                            for r in ranks],
        stage1_grads_bytes_per_step=ranks[0]["grads_bytes_per_step"],
        stage1_grads_calls_per_step=ranks[0]["grads_calls_per_step"],
        comm=[r["comm"] for r in ranks],
        render_s=[r["render_s"] for r in ranks],
        rendered=[r["rendered"] for r in ranks],
        one_rank_render_s=one_rank_render_s,
        peak_mem_gb=[r["peak_mem_gb"] for r in ranks],
        fit_s=[r["fit_s"] for r in ranks],
        setup_s=[r["setup_s"] for r in ranks], ranks_s=ranks[0]["ranks_s"],
        weights_write_s=ranks[0]["weights_write_s"],
        rank0_wrote=ranks[0]["wrote"], losses=ranks[0]["losses"],
        history=ranks[0]["history"])


def rel_err(got, want) -> float:
    """max|got - want| / max|want| (numpy or tensors)."""
    import numpy as np
    got, want = (np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64)
                 for x in (got, want))
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def learnt_flows(model, dev) -> dict:
    """(e): ``run_scene`` with RAFT flows on (b)'s learnt TINY model, every
    setting at its default, on the card: a static share strictly between
    0 and 1, finite outputs, a falling alignment loss. Each stage held
    against the port on the CPU on the same inputs: the pair predictions
    within ``LEARNT_BAR`` and the flows within ``FLOW_CPU_BAR`` x max|CPU|;
    the alignment's objective at its start (the host initialization, the
    flow term on from iteration 0), on the card's predictions and flows,
    within ``LEARNT_BAR`` relative, its masks bitwise. The alignment's
    state after its Adam steps is not held: the start puts many L1
    residuals at zero, where the gradient's direction is rounding, and
    Adam's normalized step moves those depths by lr either way (after 5
    steps an H100 and the CPU part by 1.1e-2 x max|CPU| in depths;
    PERF.md section 6)."""
    import copy
    import math

    import numpy as np
    from das3r_tpu_torch.data import synthetic
    from das3r_tpu_torch.predictor import alignment, flow, inference, raft
    from das3r_tpu_torch.predictor import runner

    gen, frames = WORK / "learnt_gen", WORK / "learnt_frames"
    synthetic.make_synthetic_stage1_dir(str(gen), n_frames=LEARNT_FRAMES,
                                        height=48, width=64, seed=SEED + 15)
    frames.mkdir()
    for p in sorted(gen.glob("frame_*.png")):
        shutil.copy(p, frames)
    flow_net = stage1_flow_net(raft.RAFT, FLOW_SEED)
    cpu_net = copy.deepcopy(flow_net)
    stats = {}
    with _Timed(inference, "run_pairs") as inf, \
            _Timed(flow, "compute_edge_flows") as fl, \
            _Timed(alignment, "align") as al:
        t0 = time.perf_counter()
        got = runner.run_scene(
            str(frames), str(WORK / "learnt_out"), model, size=LEARNT_SIZE,
            raft_params=flow_net, device=dev, stats=stats,
            verbose=lambda *_: None).scene
        card_s = time.perf_counter() - t0
    (_, images01, edges), _ = inf.args[0]
    preds, flows = inf.results[0], fl.results[0]
    (*inputs, cfg), _ = al.args[0]
    # the objective at the start, flow term on: one iteration's loss
    start_cfg = dataclasses.replace(cfg, niter=1, flow_loss_start_ratio=0.0)
    start = {}
    for on, fs in ((dev, flows), ("cpu", tuple(f.cpu() for f in flows))):
        start[on] = alignment.align(*inputs, start_cfg, flows=fs,
                                    device=on)
    t0 = time.perf_counter()
    cpu_preds = inference.run_pairs(copy.deepcopy(model).to("cpu"),
                                    images01, edges)
    cpu_flows = flow.compute_edge_flows(cpu_net, images01, edges,
                                        device="cpu")
    cpu_s = time.perf_counter() - t0
    static = float((~got.dynamic_masks).mean())
    pred_rel = {k: rel_err(getattr(preds, k), getattr(cpu_preds, k))
                for k in ("pred_i", "pred_j", "conf_i", "conf_j", "mask_i")}
    flow_rel = [rel_err(a, b) for a, b in zip(flows[:2], cpu_flows[:2])]
    g, w = start[dev], start["cpu"]
    loss_rel = abs(g.final_loss - w.final_loss) / abs(w.final_loss)
    al_stats = stats["align"]
    out = dict(frames=LEARNT_FRAMES, size=LEARNT_SIZE, niter=cfg.niter,
               edges=len(edges), shape=list(got.depths.shape),
               static_share=static,
               masks_equal=bool((g.dynamic_masks == w.dynamic_masks).all()
                                and (got.dynamic_masks
                                     == g.dynamic_masks).all()),
               first_loss=al_stats["first_loss"],
               last_loss=al_stats["last_loss"],
               preds_card_vs_cpu=pred_rel, flows_card_vs_cpu=flow_rel,
               start_loss=[g.final_loss, w.final_loss],
               start_loss_rel=loss_rel, bar=LEARNT_BAR,
               flow_bar=FLOW_CPU_BAR, seconds=card_s,
               flow_s=stats["flow_s"], align_s=stats["align_s"],
               cpu_seconds=cpu_s)
    finite = all(np.isfinite(getattr(got, k)).all()
                 for k in ("depths", "poses_c2w", "focals"))
    if not (0.0 < static < 1.0 and out["masks_equal"] and finite
            and math.isfinite(al_stats["last_loss"])
            and al_stats["last_loss"] < al_stats["first_loss"]
            and max(pred_rel.values()) <= LEARNT_BAR
            and max(flow_rel) <= FLOW_CPU_BAR and loss_rel <= LEARNT_BAR):
        raise AssertionError(f"stage 1 with flows on learnt weights: {out}")
    return out


def phase_stage1_train(sd, dev):
    """Stage-1 training (``predictor/train_loop.fit``) on the card: (a) the
    DAS3R recipe at DUST3R_LARGE_CONFIG; (b) TINY from scratch through the
    TINY script at JAX's recorded setting, held-out mask IoU, in a process
    of its own beside the quality phase's gt branch, while TINY steps on
    the card are held against the CPU and (d) runs; (c)
    ``eval_pose_estimation`` on a synthetic tum layout with (b)'s model
    and (e), beside the quality phase's predictor branch and the suite.
    No raster kernel may launch. Returns the launches and the quality
    phase's children."""
    import math
    import os

    import numpy as np
    import torch
    from das3r_tpu_torch.data import synthetic
    from das3r_tpu_torch.eval import pose_eval
    from das3r_tpu_torch.models.croco.convert import load_reference_state_dict
    from das3r_tpu_torch.models.croco.dust3r import (DUST3R_LARGE_CONFIG,
                                                     AsymmetricCroCo3D)
    from das3r_tpu_torch.predictor import alignment, train_loop, training
    from das3r_tpu_torch.predictor.datasets import (WallTwoViewDataset,
                                                    batch_iterator)

    def say(*what):
        """progress on stderr: a cut run still shows how far it got"""
        print("stage1_train:", *what, file=sys.stderr, flush=True)

    def main_path():
        # (a) the DAS3R recipe at full width
        model = AsymmetricCroCo3D(DUST3R_LARGE_CONFIG)
        load_reference_state_dict(model, sd)
        model.to(dev)
        t0 = time.perf_counter()
        n = S1T_BATCH * S1T_STEPS
        train_ds = _Rendered(WallTwoViewDataset(n=n, resolution=S1T_RES,
                                                seed=1))
        test_ds = _Rendered(WallTwoViewDataset(n=S1T_BATCH,
                                               resolution=S1T_RES, seed=999))
        render_s = time.perf_counter() - t0
        # the samples (d2) renders: its train set's first, and the test set
        dp_render_s = (sum(train_ds.seconds[:S1T_BATCH * S1T_DP_STEPS])
                       + sum(test_ds.seconds))
        say("(a) data rendered", render_s)
        tcfg = training.Stage1TrainConfig(epochs=S1T_EPOCHS,
                                          steps_per_epoch=S1T_STEPS)
        lcfg = train_loop.Stage1LoopConfig(
            epochs=S1T_EPOCHS, batch_size=S1T_BATCH,
            out_dir=str(WORK / "stage1_train"))
        # untied upsampling biases (fit unties them first) in the snapshot
        trainable = set(training.split_params(model, tcfg.freeze)[0])
        before = {k: v.detach().clone()
                  for k, v in model.named_parameters()}
        step_s, step_losses, progress = [], [], []
        orig_make = training.make_train_step
        training.make_train_step = _timed_steps(orig_make, step_s,
                                                step_losses)
        torch.cuda.reset_peak_memory_stats()
        try:
            with _Timed(train_loop, "_save_ckpt") as ckpt:
                t1 = time.perf_counter()
                _, hist = train_loop.fit(model, train_ds, {"wall": test_ds},
                                         tcfg, lcfg, progress=progress.append,
                                         device=dev)
                fit_s = time.perf_counter() - t1
        finally:
            training.make_train_step = orig_make
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        say("(a) fit", fit_s)
        bad = [x for x in step_losses if not all(map(math.isfinite, x))]
        bad += [h for h in hist if not all(
            math.isfinite(v) for k, v in h.items() if "loss" in k)]
        if bad or len(step_losses) != S1T_EPOCHS * S1T_STEPS:
            raise AssertionError(f"stage-1 losses: {bad or step_losses}")
        params = dict(model.named_parameters())
        frozen_moved = [k for k in before if k not in trainable
                        and not torch.equal(params[k], before[k])]
        heads_still = [k for k in trainable
                       if torch.equal(params[k], before[k])]
        if frozen_moved or heads_still:
            raise AssertionError(f"frozen tensors moved: {frozen_moved[:4]};"
                                 f" mask-head tensors unmoved: "
                                 f"{heads_still[:4]}")
        del before
        # checkpoint-last reloads bitwise: into fresh tensors, then written
        # again, against the model and the file
        last = WORK / "stage1_train" / "checkpoint-last.npz"
        fresh = {k: torch.zeros_like(params[k]) for k in trainable}
        opt = training.adamw_init(fresh)
        t2 = time.perf_counter()
        got = train_loop._load_ckpt(str(last), fresh, opt)
        load_s = time.perf_counter() - t2
        again = WORK / "stage1_train" / "reloaded.npz"
        train_loop._save_ckpt(str(again), fresh, opt, *got)
        za, zb = np.load(last), np.load(again)
        differ = [k for k in za.files if not np.array_equal(za[k], zb[k])]
        differ += [k for k in trainable if not torch.equal(fresh[k],
                                                           params[k])]
        if differ or sorted(za.files) != sorted(zb.files):
            raise AssertionError(f"checkpoint-last does not reload "
                                 f"bitwise: {differ[:4]}")
        ckpt_bytes = os.path.getsize(last)
        n_trainable = sum(params[k].numel() for k in trainable)
        del fresh, opt, za, zb
        # the mask BCE on one fixed batch, 5 steps at the recipe's lr,
        # then one step under the profiler
        img1, img2, b = next(batch_iterator(train_ds, S1T_BATCH, seed=0))
        img1 = torch.as_tensor(img1, device=dev)
        img2 = torch.as_tensor(img2, device=dev)
        b = b.to(dev)
        bcfg = training.Stage1TrainConfig(warmup_epochs=0.0, epochs=10**6)
        train, _ = training.split_params(model, bcfg.freeze)
        step = training.make_train_step(model, bcfg)
        opt = training.adamw_init(train)
        bce = [float(o.mask_1 + o.mask_2) for o in (
            step(train, opt, img1, img2, b, i)
            for i in range(S1T_BCE_STEPS))]
        if not bce[-1] < bce[0]:
            raise AssertionError(f"the mask BCE did not fall: {bce}")
        prof, _ = profile_call(lambda: step(train, opt, img1, img2, b,
                                            S1T_BCE_STEPS), top=12)
        del model, train, opt, step, params, img1, img2, b
        torch.cuda.empty_cache()
        full = dict(
            config="DUST3R_LARGE_CONFIG", freeze=tcfg.freeze, lr=tcfg.lr,
            b2=tcfg.b2, weight_decay=tcfg.weight_decay,
            resolution=list(S1T_RES), batch=S1T_BATCH, epochs=S1T_EPOCHS,
            steps_per_epoch=S1T_STEPS, trainable_params=n_trainable,
            render_data_s=render_s, fit_s=fit_s,
            step_ms=[1e3 * t for t in step_s],
            step_ms_median_2_8=1e3 * statistics.median(step_s[1:8]),
            checkpoint_writes=len(ckpt.seconds),
            checkpoint_s=ckpt.seconds, checkpoint_bytes=ckpt_bytes,
            checkpoint_load_s=load_s, peak_mem_gb=peak_gb,
            losses=step_losses, history=hist, mask_bce_5_steps=bce,
            profile_one_step=prof)

        # (b) TINY from scratch in a process of its own (``tiny_run``),
        # beside the quality phase's gt branch, and here meanwhile the
        # TINY steps against the CPU and (d): none of them needs (b)'s
        # weights, and (b)'s host-bound steps leave the card mostly idle
        children = {"gt": quality_spawn("gt", dev)}
        tiny_proc = spawn("tiny_child", WORK / "tiny.json", dev)
        script, args = tiny_recipe(dev)
        t0 = time.perf_counter()
        first = next(batch_iterator(script.datasets(args)[0], S1T_CPU_BATCH,
                                    seed=0))
        card_vs_cpu = stage1_card_vs_cpu(first, args.lr, dev)
        card_vs_cpu_s = time.perf_counter() - t0
        say("(b) card against CPU done")
        # (d) the data-parallel fit on two ranks sharing the card
        t0 = time.perf_counter()
        dp = dict(d1=stage1_dp_tiny(dev))
        say("(d1) done", time.perf_counter() - t0)
        torch.cuda.empty_cache()
        dp["d2"] = stage1_dp_full(sd, dp_render_s, dev)
        dp["seconds"] = time.perf_counter() - t0
        dp["beside_tiny"] = True
        say("(d2) done", dp["seconds"])
        ended = wait_children({"tiny": tiny_proc}, TINY_TIMEOUT)
        tiny = json.loads((WORK / "tiny.json").read_text())
        tiny.update(card_vs_cpu=card_vs_cpu, card_vs_cpu_s=card_vs_cpu_s,
                    child_s=ended["tiny"])
        say("(b) fit", tiny["fit_s"])
        # the quality phase's predictor branch and the suite on (b)'s
        # weights, beside (c) and (e) here
        children["predictor"] = quality_spawn("predictor", dev)
        children["suite"] = spawn("suite_child", WORK / "suite.json", dev)
        model = tiny_trained(dev)
        # (c) pose evaluation on a synthetic tum layout, (b)'s model
        seq = "rgbd_synthetic_wall"
        gen, root = WORK / "pose_gen", WORK / "pose_data"
        synthetic.make_synthetic_stage1_dir(str(gen), n_frames=POSE_FRAMES,
                                            height=HEIGHT, width=WIDTH,
                                            seed=SEED + 14)
        seq_dir = root / "tum" / seq
        (seq_dir / "rgb_50").mkdir(parents=True)
        for f in sorted(gen.glob("frame_*.png")):
            shutil.copy(f, seq_dir / "rgb_50")
        shutil.copy(gen / "pred_traj.txt", seq_dir / "groundtruth_50.txt")
        t0 = time.perf_counter()
        _, summary = pose_eval.eval_pose_estimation(
            "tum", str(root), str(WORK / "pose_out"), model,
            alignment.AlignerConfig(niter=POSE_ITERS), seq_list=[seq],
            verbose=lambda *_: None, device=dev)
        pose_s = time.perf_counter() - t0
        if not (summary["n_ok"] == summary["n_sequences"] == 1
                and math.isfinite(summary["mean_ate"])):
            raise AssertionError(f"pose evaluation: {summary}")
        pose = dict(frames=POSE_FRAMES, height=HEIGHT, width=WIDTH,
                    niter=POSE_ITERS, seconds=pose_s, **summary)
        say("(c) pose evaluation done")
        # (e) stage 1 with flows on (b)'s learnt weights
        flows = learnt_flows(model, dev)
        del model
        torch.cuda.empty_cache()
        say("(e) flows on learnt weights done")
        return full, tiny, pose, flows, dp, children

    (full, tiny, pose, flows, dp, children), launches = run_counted(
        main_path)
    if any(launches.values()):
        raise AssertionError(f"stage-1 training launched a raster kernel: "
                             f"{launches}")
    emit("stage1_train", full_width=full, tiny=tiny, pose_eval=pose,
         learnt_flows=flows, data_parallel=dp, launches=launches)
    return launches, children


@contextlib.contextmanager
def trainer_stages():
    """While inside, the stage-2 trainer's probe (``build_scene``), its
    training steps, its test-pose steps and its ``train_scene`` runs are
    each counted (``_Timed``)."""
    from das3r_tpu_torch.train import scene_setup, trainer
    from das3r_tpu_torch.train import step as step_mod
    with _Timed(scene_setup, "build_scene") as probe, \
            _Timed(step_mod, "train_step", sync=False) as steps, \
            _Timed(step_mod, "test_pose_step", sync=False) as tp_steps, \
            _Timed(trainer, "train_scene") as train:
        yield probe, steps, tp_steps, train


def launches_by_stage(launches: dict, probe, steps, tp_steps) -> dict:
    """A run's launches by the trainer's stage (``trainer_stages``); the
    rest, the evaluation renders, under ``eval``."""
    by_stage = {"probe": dict(probe.launches), "train": dict(steps.launches),
                "test_pose": dict(tp_steps.launches)}
    by_stage["eval"] = {k: launches[k] - sum(by_stage[s].get(k, 0)
                                             for s in by_stage)
                        for k in launches}
    return by_stage


def quality_launch_gate(branch: str, by_stage: dict, steps: int,
                        tp_steps: int | None) -> None:
    """The probe launched D, F and the table's pair (``DUP``), every
    training step A, B, C and the pair once, every test-pose step B, C and
    the pair once (None: a run without test poses)."""
    want = {"probe": {k: None for k in ("extract_windows",
                                        "window_blend_forward") + DUP},
            "train": {k: steps for k in ("extract_chunks", "blend_forward",
                                         "blend_backward") + DUP}}
    if tp_steps is not None:
        want["test_pose"] = {k: tp_steps for k in ("blend_forward",
                                                   "blend_backward") + DUP}
    for stage, names in want.items():
        for k, n in names.items():
            got = by_stage[stage].get(k, 0)
            if not got or (n is not None and got != n):
                raise AssertionError(f"{branch} {stage}: {k} "
                                     f"launched {got} times (want "
                                     f"{n or '> 0'}): {by_stage}")


def quality_run(branch: str, argv: list, dev) -> tuple[dict, dict]:
    """One run of the quality script's ``main`` on ``dev``: its record,
    the trainer's losses, and the launches of its probe, its training
    steps, its test-pose steps and the rest (the evaluation renders)."""
    import math

    import torch

    script = script_module("torch_quality_e2e")
    cuda = torch.device(dev).type == "cuda"
    with trainer_stages() as (probe, steps, tp_steps, train):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        record, launches = run_counted(lambda: script.main(
            argv + ["--device", str(dev)]))
        seconds = time.perf_counter() - t0
    res = train.results[0]
    iters = int(argv[argv.index("--iters") + 1])
    losses = res.losses
    bad = [x for x in losses if not math.isfinite(x)]
    if len(losses) != iters or bad:
        raise AssertionError(f"quality {branch}: {len(losses)} losses, "
                             f"non-finite: {bad[:4]}")
    by_stage = launches_by_stage(launches, probe, steps, tp_steps)
    quality_launch_gate(f"quality {branch}", by_stage, steps.calls,
                        tp_steps.calls)
    st = res.final_settings
    run = dict(
        record=record, seconds=seconds, train_steps=steps.calls,
        test_pose_steps=tp_steps.calls,
        ms_per_iter=train.seconds[0] * 1e3 / iters,
        build_scene_seconds=probe.seconds[0],
        train_scene_seconds=train.seconds[0], first_loss=losses[0],
        last_loss=losses[-1], mean_loss_last_100=statistics.mean(
            losses[-100:]),
        gaussians=int(res.meta.alive.sum()),
        settings=dict(max_total_entries=st.max_total_entries,
                      max_tiles_per_gaussian=st.max_tiles_per_gaussian,
                      heavy_rows_cap=st.heavy_rows_cap,
                      sh_degree=st.sh_degree),
        jax_record=JAX_QUALITY[branch], launches=launches,
        launches_by_stage=by_stage)
    return run, launches


def quality_child(branch: str, out: str, dev: str, *argv: str) -> None:
    """One quality run in a process of its own (``phase_quality``'s
    child): ``quality_run`` on ``dev``, its result written to ``out`` as
    JSON."""
    run, launches = quality_run(branch, list(argv), dev)
    Path(out).write_text(json.dumps(dict(run=run, launches=launches)))


def suite_scenes(root: Path) -> list:
    """``SUITE_SCENES`` synthetic scenes named from
    ``harness.DAVIS_SCENES``, each rearranged into ``root/data/<scene>``,
    its GT dynamic masks in the DAVIS layout (``root/gt/<scene>/
    00000.png``) and its frames in ``root/frames/<scene>``."""
    from das3r_tpu_torch.data import rearrange
    from das3r_tpu_torch.data.synthetic import make_synthetic_stage1_dir
    from das3r_tpu_torch.eval import harness
    scenes = harness.DAVIS_SCENES[:SUITE_SCENES]
    for k, scene in enumerate(scenes):
        gen = root / "gen" / scene
        make_synthetic_stage1_dir(str(gen), n_frames=SUITE["frames"],
                                  height=SUITE["height"],
                                  width=SUITE["width"], seed=SEED + 20 + k)
        rearrange.rearrange_scene(str(gen), str(root / "data" / scene))
        for sub in ("gt", "frames"):
            (root / sub / scene).mkdir(parents=True)
        for f in sorted(gen.glob("dynamic_mask_*.png")):
            shutil.copy(f, root / "gt" / scene
                        / f"{int(f.stem.split('_')[-1]):05d}.png")
        for f in sorted(gen.glob("frame_*.png")):
            shutil.copy(f, root / "frames" / scene)
    return scenes


def video_frames(path: str) -> int:
    """The frames of the video the render tool wrote: a GIF's (PIL), or
    an mp4's (imageio, else ffprobe)."""
    if path.endswith(".gif"):
        from PIL import Image
        with Image.open(path) as im:
            return im.n_frames
    try:
        import imageio.v2 as imageio
        with imageio.get_reader(path) as r:
            return r.count_frames()
    except Exception:
        return int(subprocess.run(
            ["ffprobe", "-v", "error", "-count_frames", "-select_streams",
             "v:0", "-show_entries", "stream=nb_read_frames", "-of",
             "csv=p=0", path], check=True, capture_output=True, text=True,
            timeout=60).stdout.strip())


def masks_recount(pred_root: Path, gt_root: Path, scenes: list) -> float:
    """The table_mask protocol's mean J counted again with numpy: each
    predicted ``dynamic_mask_<i>.png`` against GT ``<i>.png`` sampled at
    the prediction's size (row ``floor(y H / h)``, column likewise), J
    the intersection over the union (1 where both are empty), the mean
    over frames, then over scenes."""
    import numpy as np
    from PIL import Image
    per_scene = []
    for scene in scenes:
        js = []
        for f in sorted((pred_root / scene).glob("dynamic_mask_*.png")):
            g_path = gt_root / scene / f"{int(f.stem.split('_')[-1]):05d}.png"
            if not g_path.exists():
                continue
            pred = np.asarray(Image.open(f).convert("L")) > 0
            gt = np.asarray(Image.open(g_path).convert("L")) > 0
            (h, w), (hh, ww) = pred.shape, gt.shape
            gt = gt[(np.arange(h) * hh) // h][:, (np.arange(w) * ww) // w]
            union = float((pred | gt).sum())
            js.append(float((pred & gt).sum()) / union if union else 1.0)
        per_scene.append(float(np.mean(js)))
    return float(np.mean(per_scene))


def suite_run(dev) -> dict:
    """``scripts/torch_run_benchmark_suite.py``'s ``main`` on ``dev``,
    each mode as a user runs it, its launches counted from 0, and held at
    its bars: ``psnr`` and ``render`` on ``suite_scenes``, ``masks`` on the
    stage-1 outputs of (b)'s TINY weights for those scenes, ``pose`` on a
    synthetic tum sequence with the pipeline phase's DUST3R_LARGE .pth."""
    import math

    from das3r_tpu_torch.data.synthetic import make_synthetic_stage1_dir
    from das3r_tpu_torch.eval import harness
    from das3r_tpu_torch.predictor import alignment, runner

    suite = script_module("torch_run_benchmark_suite")
    root = WORK / "suite"
    t0 = time.perf_counter()
    scenes = suite_scenes(root)
    out = {"scenes": scenes, "setup_s": time.perf_counter() - t0}

    def run(mode, *argv, before=None):
        """one mode's main (after ``before``, counted with it): its
        result, seconds, launches and launches by trainer stage"""
        argv = [mode, *map(str, argv), "--device", str(dev)]

        def both():
            extra = before() if before else None
            return extra, suite.main(argv)
        with trainer_stages() as (probe, steps, tp_steps, train):
            t1 = time.perf_counter()
            (extra, ret), launches = run_counted(both)
            seconds = time.perf_counter() - t1
        by_stage = launches_by_stage(launches, probe, steps, tp_steps)
        return ret, dict(argv=argv, seconds=seconds, launches=launches,
                         launches_by_stage=by_stage, steps=steps.calls,
                         test_pose_steps=tp_steps.calls,
                         train_scene_s=train.seconds, extra=extra)

    iters = SUITE["iters"]
    # psnr: the (i+5)%10 split, GT dynamic masks, the PSNR table
    ret, rec = run("psnr", "--dataset", "davis", "--data_root",
                   root / "data", "--output_root", root / "psnr",
                   "--iterations", iters, "--scenes", *scenes,
                   "--gt_dynamic_mask", root / "gt")
    quality_launch_gate("suite psnr", rec["launches_by_stage"],
                        rec["steps"], rec["test_pose_steps"])
    table = ret["result"]
    logs = {s: harness.last_psnr(str(root / "psnr" / s / "test_log.txt"))
            for s in scenes}
    if not (rec["steps"] == iters * len(scenes) and all(
            table.get(s) is not None and math.isfinite(table[s])
            and table[s] == logs[s] for s in scenes)):
        raise AssertionError(f"suite psnr: table {table}, the logs' last "
                             f"lines {logs}, {rec['steps']} steps")
    out["psnr"] = dict(rec, table=table)
    # render: every frame trained, then the renders and the video
    ret, rec = run("render", "--dataset", "davis", "--data_root",
                   root / "data", "--output_root", root / "render",
                   "--iterations", iters, "--scenes", scenes[0])
    quality_launch_gate("suite render", rec["launches_by_stage"],
                        rec["steps"], None)
    video = ret["result"][scenes[0]]
    n_video = video_frames(video)
    views = len(list(Path(video).parent.glob("*.png")))
    if not (views == SUITE["frames"] and n_video == views
            and rec["steps"] == iters):
        raise AssertionError(f"suite render: {views} views, {n_video} "
                             f"frames in {video}, {rec['steps']} steps")
    out["render"] = dict(rec, video=Path(video).name, video_frames=n_video)

    # masks: stage 1 of (b)'s TINY weights on each scene's frames, then
    # the table_mask protocol against the GT masks
    def stage1():
        model = tiny_trained(dev)
        t1 = time.perf_counter()
        for scene in scenes:
            runner.run_scene(
                str(root / "frames" / scene), str(root / "masks" / scene),
                model, scene_graph="swin-2-noncyclic",
                aligner_cfg=alignment.AlignerConfig(niter=50),
                size=SUITE_STAGE1_SIZE, verbose=lambda *_: None,
                device=dev)
        return time.perf_counter() - t1
    ret, rec = run("masks", "--dataset", "davis", "--data_root",
                   root / "data", "--output_root", root / "masks",
                   "--gt_dynamic_mask", root / "gt", "--scenes", *scenes,
                   before=stage1)
    mean_j = ret["result"]["summary"]["mean_J"]
    recount = masks_recount(root / "masks", root / "gt", scenes)
    if not (mean_j is not None and 0 <= mean_j <= 1 and mean_j == recount
            and not any(rec["launches"].values())):
        raise AssertionError(f"suite masks: mean_J {mean_j}, numpy "
                             f"{recount}, launches {rec['launches']}")
    rec["stage1_s"] = rec.pop("extra")
    out["masks"] = dict(rec, per_scene=ret["result"]["per_scene"],
                        summary=ret["result"]["summary"], recount=recount)
    # pose: a synthetic tum sequence at full size, the .pth of the
    # pipeline phase (DUST3R_LARGE_CONFIG)
    seq = "rgbd_synthetic_suite"
    gen, seq_dir = root / "pose_gen", root / "pose_data" / "tum" / seq
    make_synthetic_stage1_dir(str(gen), n_frames=SUITE_POSE_FRAMES,
                              height=HEIGHT, width=WIDTH, seed=SEED + 22)
    (seq_dir / "rgb_50").mkdir(parents=True)
    for f in sorted(gen.glob("frame_*.png")):
        shutil.copy(f, seq_dir / "rgb_50")
    shutil.copy(gen / "pred_traj.txt", seq_dir / "groundtruth_50.txt")
    ret, rec = run("pose", "--dataset", "tum", "--data_root",
                   root / "pose_data", "--output_root", root / "pose",
                   "--ckpt", WORK / "das3r_random.pth", "--scenes", seq)
    summary = ret["result"]
    if not (summary["n_ok"] == summary["n_sequences"] == 1
            and math.isfinite(summary["mean_ate"])
            and not any(rec["launches"].values())):
        raise AssertionError(f"suite pose: {summary}, launches "
                             f"{rec['launches']}")
    out["pose"] = dict(rec, frames=SUITE_POSE_FRAMES, height=HEIGHT,
                       width=WIDTH, summary=summary)
    out["card"] = ret["card"]
    shutil.rmtree(root, ignore_errors=True)
    return out


def suite_child(out: str, dev: str) -> None:
    """``suite_run`` in a process of its own (beside the quality phase's
    children), its result written to ``out`` as JSON."""
    Path(out).write_text(json.dumps(suite_run(dev)))


CHILDREN: list = []     # every process spawned, stopped at exit


def spawn(fn: str, *args) -> subprocess.Popen:
    """``chip_smoke.<fn>(*args)`` in a fresh process, as a user runs a
    script; its stdout (the trainer's progress) on our stderr, so that
    stdout keeps the phase lines. ``spawned_at`` is its start on
    ``time.perf_counter``."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; chip_smoke.{fn}(*{[str(a) for a in args]!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=sys.stderr)
    proc.spawned_at = time.perf_counter()
    CHILDREN.append(proc)
    return proc


def stop_children() -> None:
    for child in CHILDREN:
        if child.poll() is None:
            child.kill()
            child.wait()


def wait_children(children: dict, timeout: float) -> dict:
    """Wait until every child of ``children`` has ended, each within
    ``timeout`` seconds of its start; raise on a non-zero exit or the
    time limit. Returns each child's seconds from start to end."""
    ended = {}
    while len(ended) < len(children):
        for name, child in children.items():
            if name not in ended and child.poll() is not None:
                if child.returncode != 0:
                    raise AssertionError(f"{name}: exit {child.returncode}")
                ended[name] = time.perf_counter() - child.spawned_at
            elif (name not in ended
                  and time.perf_counter() - child.spawned_at > timeout):
                raise AssertionError(f"{name}: past {timeout} s; ended: "
                                     f"{ended}")
        time.sleep(0.5)
    return ended


def quality_spawn(branch: str, dev) -> subprocess.Popen:
    """The quality script's ``branch`` at its JAX record's recipe
    (``QUALITY_PREDICTOR`` on (b)'s weights, ``QUALITY_GT``) in a process
    of its own (``quality_child``)."""
    p, g = QUALITY_PREDICTOR, QUALITY_GT
    argv = {
        "predictor": [
            "--work", str(WORK / "quality_predictor"), "--stage1",
            "predictor", "--frames", str(p["frames"]),
            "--height", str(p["height"]), "--width", str(p["width"]),
            "--iters", str(p["iters"]),
            "--stage1_ckpt", str(WORK / "tiny" / "stage1_tiny.npz")],
        "gt": [
            "--work", str(WORK / "quality_gt"), "--stage1", "gt",
            "--frames", str(g["frames"]), "--height", str(g["height"]),
            "--width", str(g["width"]), "--iters", str(g["iters"]),
            "--pose_noise", str(g["pose_noise"]),
            "--noise_seed", str(g["noise_seed"]),
            "--psnr_threshold", str(g["psnr_threshold"])]}[branch]
    return spawn("quality_child", branch, WORK / f"quality_{branch}.json",
                 dev, *argv)


def phase_quality(children: dict):
    """The end-to-end quality path, ``scripts/torch_quality_e2e.py``, at
    the JAX records' recipes, and the suite (``suite_run``): each in a
    fresh process, as a user runs the script, ``phase_stage1_train``
    started them (the gt branch beside (b), the predictor branch on the
    TINY weights (b) trained and saved, and the suite, beside (c) and
    (e)); their host-bound steps share the card, so their seconds are not
    the script's alone. Waits for them, holds each at its bars and
    returns the quality runs' launches and the suite's by mode."""
    t0 = time.perf_counter()
    ended = wait_children(children, QUALITY_TIMEOUT)
    waited = time.perf_counter() - t0
    argv = ("predictor", "gt")
    runs, launches = {}, {}
    for branch in argv:
        got = json.loads((WORK / f"quality_{branch}.json").read_text())
        runs[branch], launches[branch] = got["run"], got["launches"]
        shutil.rmtree(WORK / f"quality_{branch}", ignore_errors=True)
    pred, gt = runs["predictor"], runs["gt"]
    detail = pred["record"]["detail"]
    if not (pred["record"]["value"] >= QUALITY_PSNR_BAR
            and detail["stage1_mask_iou"] >= TINY_IOU_BAR):
        raise AssertionError(f"quality predictor: PSNR "
                             f"{pred['record']['value']} (bar "
                             f"{QUALITY_PSNR_BAR}), stage-1 mask IoU "
                             f"{detail['stage1_mask_iou']} (bar "
                             f"{TINY_IOU_BAR})")
    detail = gt["record"]["detail"]
    if not (gt["record"]["value"] >= QUALITY_PSNR_BAR
            and detail["ate_init"] == JAX_QUALITY["gt"]["ate_init"]
            and detail["ate_final"] <= detail["ate_init"]):
        raise AssertionError(f"quality gt: PSNR {gt['record']['value']} "
                             f"(bar {QUALITY_PSNR_BAR}), ATE "
                             f"{detail['ate_init']} -> "
                             f"{detail['ate_final']} (want "
                             f"{JAX_QUALITY['gt']['ate_init']} -> no "
                             f"higher)")
    emit("quality", waited_s=waited, side_by_side=True, predictor=pred,
         gt=gt, child_s={k: ended[k] for k in argv})
    suite = json.loads((WORK / "suite.json").read_text())
    emit("suite", seconds=ended["suite"], beside_quality=True, **suite)
    return launches, {mode: suite[mode]["launches"]
                      for mode in ("psnr", "render", "masks", "pose")}


def main() -> int:
    t_all = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    import das3r_tpu_torch
    if Path(das3r_tpu_torch.__file__).resolve().parents[1] != ROOT:
        raise SystemExit(f"chip_smoke: das3r_tpu_torch came from "
                         f"{das3r_tpu_torch.__file__}, not from {ROOT}")
    smi = phase_device()
    import torch
    from das3r_tpu_torch.ops.splat import RasterSettings

    try:
        phase_build()
        scene, model, data = phase_scene()
        settings = RasterSettings(image_height=HEIGHT, image_width=WIDTH,
                                  sh_degree=SH_DEGREE, max_per_tile=1024,
                                  max_tiles_per_gaussian=32)
        random_scene = phase_parity(model, data, settings, "cuda")
        torch.cuda.empty_cache()
        phase_reference("cuda")
        serve = phase_main(scene, model)
        phase_profile(model, data, settings, "cuda")
        torch.cuda.empty_cache()
        train, one_step = phase_train(data, settings, "cuda")
        phase_train_profile(one_step)
        del one_step
        torch.cuda.empty_cache()
        bundle, k_probe, build, probe_stats = phase_trainer_scene("cuda")
        # A, B, C at the trainer scene, where most of their launches run;
        # their serving-scene numbers beside
        results = phase_trainer_entry_parity(bundle, "cuda")
        for r, r_random in zip(results, random_scene):
            r["scene"] = "trainer view 0"
            r["random_scene"] = {k: r_random[k] for k in SUMMARY_KEYS
                                 if k in r_random}
        torch.cuda.empty_cache()
        bf16_rows, bf16_train = phase_bf16_table(bundle, model, data,
                                                 settings, "cuda")
        results += bf16_rows
        ranges, win_ranges, sharded, sharded_win = phase_sharded(
            bundle, k_probe, "cuda")
        for r in results:
            key = {"blend_forward": "b", "blend_backward": "c"}.get(r["name"])
            if key:
                r["tile_range"] = range_fields(ranges, key)
        torch.cuda.empty_cache()
        win_rows = phase_window_parity(bundle, k_probe, "cuda")
        for r in win_rows:
            key = {"window_blend_forward": "d",
                   "window_blend_backward": "e"}.get(r["name"])
            if key:
                r["tile_range"] = range_fields(win_ranges, key)
        results += win_rows
        torch.cuda.empty_cache()
        phase_split_table(bundle, probe_stats, model, data, settings, "cuda")
        trainer, entry_model = phase_trainer(bundle, k_probe, "cuda")
        del bundle
        torch.cuda.empty_cache()
        gui = phase_gui(entry_model, "cuda")
        torch.cuda.empty_cache()
        sd, weights_s = stage1_weights()
        emit("stage1_weights", seconds=weights_s,
             n_params=sum(v.size for v in sd.values()))
        stage1 = phase_stage1(sd, "cuda")
        torch.cuda.empty_cache()
        pipe = phase_pipeline(sd, "cuda")
        torch.cuda.empty_cache()
        s1_train, children = phase_stage1_train(sd, "cuda")
        del sd
        torch.cuda.empty_cache()
        quality, suite = phase_quality(children)
    finally:
        stop_children()
        shutil.rmtree(WORK, ignore_errors=True)
    # serving runs the entry-stream forward kernels once per view and no
    # other kernel
    want = {"extract_chunks": N_FRAMES, "blend_forward": N_FRAMES,
            "dup_count": N_FRAMES, "dup_emit": N_FRAMES}
    for kname, count in serve.items():
        if count != want.get(kname, 0):
            raise AssertionError(
                f"{kname} launched {count} times over {N_FRAMES} views")

    name, power = (x.strip() for x in smi.split(",", 1))
    for r in results:
        k = r["name"]
        r["launches_by_path"] = {
            "serve_8_views": serve[k], f"train_{TRAIN_STEPS}_steps": train[k],
            "build_scene_probe": build[k],
            f"trainer_entry_stream_{TRAINER_ITERS}_iters":
                trainer["entry_stream"][k],
            f"trainer_window_{TRAINER_ITERS}_iters": trainer["window"][k],
            "gui_24_panels": gui.get(k, 0),
            "stage1_16_frames": stage1[k],
            f"pipeline_{PIPELINE_ITERS}_iters": pipe[k],
            "stage1_train": s1_train[k],
            f"quality_predictor_{QUALITY_PREDICTOR['iters']}_iters":
                quality["predictor"][k],
            f"quality_gt_{QUALITY_GT['iters']}_iters": quality["gt"][k],
            **{f"suite_{mode}": n[k] for mode, n in suite.items()},
            f"sharded_2_ranks_{SHARDED_STEPS}_steps_x2": sharded.get(k, 0),
            f"sharded_window_2_ranks_{SHARDED_STEPS}_steps":
                sharded_win.get(k, 0),
            f"bf16_train_{TRAIN_STEPS}_steps": bf16_train[k]}
        r["launches"] = sum(r["launches_by_path"].values())
        r["card"], r["power_limit"] = name, power
    emit("done", seconds=time.perf_counter() - t_all)
    print(json.dumps({"kernels": results}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
