"""Drive the PyTorch/CUDA port (sensorium_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py [--out DIR]

Phases, each of which passes or makes the script exit non-zero:

1. device: a CUDA card must be present; prints its name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
2. build: compiles every kernel source of ``sensorium_tpu_torch/csrc`` with
   nvcc (one process per source, all started together) and prints the time;
3. kernels: each hand-written kernel against its plain PyTorch version on the
   card, at every shape the flagship chunk forward gives it, in bf16 and fp32,
   plus ragged shapes. fp32 (TF32 off) must agree within atol 1e-5 on
   unit-scale inputs; bf16 is held to the plain version computed in fp32
   from the same bf16 inputs within one bf16 rounding (rtol 2**-8, atol
   1e-5). Times are CUDA-event medians (a call under 2 ms is timed over
   back-to-back calls): the kernel, the plain version, and as a yardstick
   two cuDNN lowerings of the same conv, off the port's default route: ``F.conv3d(groups=C)`` and ``F.conv2d(groups=C)`` on the
   channels-last (B*T, C, H, W) view (temporal: kernel (k, 1) on the
   (B, C, T, H*W) view); ``library_ms`` is the faster of the two per shape,
   and both are recorded. Beside them, the least time the card needs to
   move the bytes or do the operations (``bound_ms``). The spatial cases add
   edges the kernel's tiling can get wrong: H and W that are not multiples
   of its tiles, frames wider or taller than one column tile, a 1x1 frame,
   channel tails (C not a multiple of 8 in bf16 or of 4 in fp32), k = 5 at
   both strides, C wider than one channel tile, and 8192 small frames, so
   that each block walks several. The temporal cases add the edges of the
   column walk: k = 3 and 5, T below k (1, 2) and not a multiple of the frame
   tile (37), channel tails and C wider than one channel tile;
3b. eval BN prologue: ``dw_spatial_fwd_bn`` and ``dw_temporal_fwd_bn`` (the
   depthwise convs with each block's eval ``pw_bn`` / ``spatial_bn`` and its
   SiLU run as their input prologue) at every shape of the flagship chunk
   forward, in bf16 and fp32, with running statistics that shift and scale
   every channel: each must be bitwise ``dw_*_fwd(bn_act_eval(x))`` on the
   card. Times (CUDA-event medians): the prologue conv, the plain kernel alone
   on BN's output (``plain_kernel_ms``), the eval BN pass (``bn_ms``) and the
   chain of the two (``chain_ms``); the bound moves x, w and y once and the
   BN's four vectors (its output is never written);
4. slice: the flagship DwiseNeuro (``configs/true_batch_001.py``, seeded
   random weights, bf16) serves 3 requests through ``Predictor(chunk_size=32)``:
   300-frame trials of 36x64 video, mouse 0. Each answer must be a finite,
   non-negative (7863, 300) array, and the launch counters must show 9
   spatial and 9 temporal prologue conv launches per chunk forward (no plain
   depthwise forward), and one BN kernel launch for each other BN (22
   without SiLU, 12 with);
5. card against CPU: the same weights in fp32, 2 windows through the
   single-mouse forward on the card (kernels) and on the CPU (plain
   versions); the largest difference must stay within 1e-3 of the largest
   CPU output;
6. backward kernels: ``dw_spatial_dx``, ``dw_spatial_dw`` and
   ``dw_temporal_dw`` against their plain versions at every shape of the
   flagship training step (batch 32 x 16 frames) and at ragged shapes, in
   bf16 and fp32. dx is held as the forward kernels are; dw (fp32) within
   1e-5 of the largest value (+1e-5) of the plain version computed in
   float64 from the same inputs. ``library_ms`` is the faster per shape of
   ``aten.convolution_backward`` (cuDNN) asked for the input or the weight
   gradient only, of the grouped ``conv3d`` and of phase 3's 2-D view;
   both are recorded, with the 2-D gradient's difference from the plain
   version. The dx and dw cases add edges the kernels' tilings can get
   wrong: H and W that are not multiples of their tiles, a channel tail (C
   not a multiple of 8 in bf16 or of 4 in fp32), k = 5 at both strides, and
   C wider than one channel tile; dw also a 1x1 frame and 8192 small frames,
   so that each block walks many. ``dw_temporal_dw`` adds the forward's
   temporal edge cases, and each of its calls is run twice and must give
   bitwise equal results;
7. train: the flagship ``MouseModel`` (the config's mice_poisson loss and
   AdamW, lr 2.4e-3 held constant, weight decay 0.05, EMA 0.999, seeded
   random weights) takes 2 warm-up and 10 timed steps on one synthetic batch
   of 32 clips made as ``bench.py`` makes it, then one ``val_step`` on the
   EMA weights. Every loss must be finite, the last below the first, and
   the launch counters must match the config: per step 9 + 1 (block 1 is
   rematerialized) spatial forwards, 2 x 9 + 1 temporal forwards (the
   temporal input gradient is the forward kernel), and 9 of each backward
   kernel; the BN kernels' launches those of ``expected_bn_launches`` (per
   BN forward the statistics, their finalize and the apply, block 1's 5
   again; per BN backward the sums, their slab sum and dx). One more step
   runs under ``torch.profiler``;
8. card against CPU, training: the flagship weights in fp32, drop rates 0,
   2 clips; one loss and backward on the card (kernels) and on the CPU
   (plain versions). The loss within 1e-4 relative, every parameter's
   gradient within 1e-3 of its tensor's largest CPU gradient, with a floor
   of 1e-6 of the model's largest gradient (BN biases that feed another BN
   have an analytically zero gradient);
9. fused kernel: ``fused_bn_silu_dw_spatial`` (BN-apply + SiLU + spatial
   depthwise conv) against its plain version at every BN -> SiLU -> spatial
   dw shape of a flagship chunk forward, at the two shapes of ``dwbench``
   that the model does not run, at ragged shapes and with half the channels
   dead (scale 0, shift != 0), in bf16 and fp32, held as phase 3 holds the
   forward kernels; each call is run twice and must give bitwise equal
   results. The ragged cases add the edges phase 3 gives the spatial
   forward (tile edges, a 1x1 frame, channel tails, k = 5 at both strides,
   C wider than one channel tile, 8192 small frames that blocks walk), with
   half the channels dead. No single PyTorch call computes this function:
   ``library_ms`` is the faster of two eager chains, ``silu(addcmul)`` ->
   ``F.conv3d(groups=C)`` and ``silu(addcmul)`` -> ``F.conv2d(groups=C)``
   (``dwbench``'s ``chain`` and ``chain2d``), and both are recorded; beside
   them ``dw_spatial_fwd``'s time on the same x and w (``fwd_ms``), the
   yardstick for what the prologue costs;
9b. batch norm: the BN kernels (``ops/bn_kernels.py``, ``csrc/bn_act.cu``)
   at every BN of a flagship train step and chunk forward (52 BNs, 30 with
   SiLU; block 1's 5 rerun in the step's backward), bf16: the statistics and
   apply (training forward), the backward's sums and dx, and the eval apply,
   each against its plain version within one rounding of each bf16
   intermediate (the statistics within 1e-4; the backward's sums over rows
   within ``BN_SUM_RTOL`` of their terms' magnitudes, and at
   ``BN_SUM_WITNESS`` both printed beside float64), and run twice to the same bits.
   Times are CUDA-event medians per call, summed over a step's and a chunk's
   calls (a chunk's 34: each block's pw_bn and spatial_bn run inside its
   depthwise convs, phase 3b): the kernels (replayed from a CUDA graph, so that the card's time
   and not the host's launches is timed at the small BNs), the plain
   versions, and as a yardstick
   ``F.batch_norm`` + ``F.silu`` on the (rows, C) view (``library_ms``,
   timed only: the port never calls it). Beside them the byte bound of the
   two passes each direction needs (training: x read twice and y written,
   x and dy read twice and dx written, 16 bytes a bf16 element; eval: 4);
10. dwbench: ``sensorium_tpu_torch.tools.dwbench`` at its own shapes, every
   impl; each must return a time, and ``fused`` must be within one bf16
   rounding of the activation of ``pallas``. This is the fused kernel's main
   path: its launches are counted here;
11. fit: a dataset in the on-disk layout at real widths (10 mice with their
   neuron counts, 36x64 video, 3 labeled 300-frame trials each) is written
   under ``--out``; with ``SENSORIUM_FOLD_ASSIGNMENT=trial`` the flagship
   ``MouseModel`` (CutMix alpha 1, p 0.5) trains on folds 1-2 through
   ``TrainMiceDataset`` -> ``MiceDataLoader`` (batch 32, drop_last, 8
   threads) for 2 epochs of 8 steps, validating on fold 0 (90 windows)
   with ``CorrelationMetric``, logging to CSV and JSONL. Every loss and
   ``val_corr`` must be finite, the launches per step those of phase 7,
   both logs two epochs long, and the native host library in use. It
   prints the clips/s fed from disk beside phase 7's and the share of the
   wall clock ``fit`` waited on the loader. The dataset also holds one
   unlabeled 300-frame ``live_test_main`` trial for each new mouse;
12. import proof: a reference-format ``.pth`` of the flagship model with
   the weights ``tests/golden/procedural_weights.py`` makes from the key and
   shape table of ``tests/golden/import_proof_flagship.npz``, converted by
   ``cli/import_torch.convert_checkpoint`` (fp32), loaded by
   ``Predictor(ckpt)`` and run on the golden's 40-frame trial: the result
   must match the reference implementation's own output within rtol 2e-3
   and atol 2e-4 of its largest value;
13. checkpoints: the flagship ``MouseModel`` (as in phase 7) takes a step;
   ``save`` then ``load_model`` must give the EMA weights bit for bit, a
   background save made before the next step must equal the sync save byte
   for byte (its copy to the host is made before the step changes the EMA
   in place), as must a background train state; ``load_train_state`` into
   a model built from another seed, then 2 steps, must give the
   uninterrupted run's losses and every parameter, buffer, EMA tensor,
   optimizer moment and the generator bit for bit; a ``PreemptionHandler``
   latched after an epoch must raise ``TrainingPreempted`` with the state
   saved. It prints each file's size and the seconds to save (sync, and
   what a background save blocks) and to load;
14. submission flow: ``cli.predict``'s unlabeled-split path (7 fold models
   from fold directories that link one flagship checkpoint, the trials of
   the 5 new mice from phase 11's dataset, shared staging, the mean on the
   card, the deferred fetch); every saved blend must match one
   ``Predictor``'s prediction of its trial within 1e-6 of its largest
   value. It prints trials/s and windows/s. The submission file is not
   written: pandas is not a dependency of the card's machine;
15. train CLI: ``sensorium_tpu_torch.cli.train`` on phase 11's dataset
   (``SENSORIUM_DATA_DIR`` and ``SENSORIUM_CONFIGS_DIR`` pointed at a
   temporary directory that holds the port's configs): in-process
   ``main(["-e", "smoke_001", "-f", "0"])`` (the flagship at full width, 64
   clips an epoch, a warmup and a train epoch) must log both epochs with
   finite losses and ``val_corr``, write ``config.json``, the logs, one
   ``model-001-*.ckpt`` and ``train_state.ckpt``, and launch the kernels of
   its steps and val forwards as phase 11 counts them; ``--resume`` on the
   finished fold must read the state of epoch 1 and take no step; the
   distillation recipe (``distillation_001``, student expansion 6 with 3
   blocks rematerialized) at the same size must train from that fold as its
   teacher, whose eval forward adds 9 + 9 launches a step; then the CLI as
   a subprocess (smoke_001 at 640 clips an epoch) gets a SIGTERM once its
   warmup epoch is logged and must exit 75 with a train state, and its
   ``--resume`` must exit 0 with every epoch logged once. It prints each
   run's wall seconds, steps/s, seconds before the first step and
   checkpoint seconds;
16. data parallelism (``sensorium_tpu_torch/parallel``). 16a, two ranks on
   this one card through the library: a child takes one unsharded flagship
   step at batch 32 in fp32 and in bf16 (SGD, drop rates on) and saves its
   loss, every gradient, the BN running statistics and the weights after
   it; then two processes
   on the card in a gloo group (NCCL refuses two ranks on one device) first
   check that gloo takes CUDA tensors for ``all_reduce`` (sum, max, min) and
   ``broadcast``, then take the same step at 16 rows each through
   ``MouseModel(mesh=...)``, in fp32 (every block rematerialized) and in
   bf16 (the flagship). Rank 0 holds each to the saved step (the bounds
   ``MESH_*`` below: fp32 at ``tests/test_parallel.py``'s tolerances, bf16
   within twice each tensor's own bf16 error); the ranks' weights must be
   the same, each rank's launches those of a step, and each prints its peak
   memory.
   16b, NCCL through the CLI at world size 1: ``python -m
   sensorium_tpu_torch.cli.train -e smoke_001 -f 0 --multihost
   127.0.0.1:PORT,1,0`` on phase 11's dataset must log phase 15's fold
   within ``MESH_LOG_RTOL`` / ``MESH_CORR_ATOL`` with phase 15's launches;
   then the SIGTERM run of phase 15 with ``--multihost``: exit 75, then
   ``--resume``, exit 0; its warmup epoch's steps/s beside phase 15's is the
   cost of the mesh path on one card. 16c, only with two cards or more:
   ``cli.train`` with the default ``--mesh data`` over every card, its logs
   held to 16b's tolerances, and ``cli.predict -s folds --mesh`` on that
   fold against one card within the serving tolerance; with one card it
   prints that 16c did not run;
17. serving export (``infer/export.py``): phase 13's checkpoint is exported
   as the all-mice window forward (symbolic batch) and as mouse 0's trial
   program (chunk 32, bucket 64, 36x64 frames, symbolic length); each
   prints its export seconds (checkpoint read, trace, write), ``.pt2``
   bytes and load seconds. The trial artifact serves phase 4's three
   300-frame requests (padded to 320 frames) beside the live ``Predictor``,
   windows/s printed for both. bf16: the frames that see only chunks of the
   same 32 windows in both must agree within 1e-5 of the largest output
   (only the blend's fp32 order differs); the last frames, which also see
   the live Predictor's short last chunk, within one bf16 rounding (2**-8),
   beside the live Predictor's own difference at another chunk size. The
   launch counters must show 9 + 9 prologue convs per chunk forward that torch's eager
   ``scan`` runs (torch 2.11 runs the first chunk twice). Then an fp32
   window artifact of mouse 0, traced on the card, must give the live
   model's numbers bitwise on phase 5's two windows, and moved to the CPU
   the card's within phase 5's bound;
18. tensor parallelism (``parallel/tensor.py``). 18a, two ranks of a
   ``{data: 1, model: 2}`` mesh on this card through the library (gloo,
   whose ``all_gather`` on CUDA tensors is checked first, with the other
   collectives): a child takes one unsharded flagship step at batch 16 in
   fp32 and bf16 (SGD, drop rates on); then each rank takes the same step
   on all 16 rows with half of the cortex and readout weights through
   ``MouseModel(mesh=...)``. Rank 0 holds it to the saved step at 16a's
   bounds (a sharded weight's gradient and value gathered whole), the ranks'
   replicated weights must be the same, each rank's launches a step's, and
   each prints its peak memory beside one card's. 18b, on the fp32 ranks: a
   ``.orbax`` train state and a model checkpoint after the step; fresh
   models load the state and take 2 more steps, bit for bit the
   uninterrupted ranks'; the TP-written checkpoint loads into one card's
   ``load_model`` and predicts within the serving tolerance of the TP
   forward; the directory's bytes and the save and load seconds are
   printed. 18c, only with two cards or more: smoke_001 in fp32 (every
   block rematerialized) through ``cli.train --mesh data,model
   --sharded-checkpoint`` over every card, its logs held at 16b's
   tolerances to the same fp32 fold on one card (in bf16 a forward's
   roundings depend on its size, which the data axis divides), then the
   SIGTERM run with those flags (exit 75) and ``--resume`` (exit 0); with
   one card it prints that 18c did not run (``--cards`` runs it). Two ranks
   on one card prove numbers, not speed;
19. serving over a model axis and across cards. 19a: phase 13's checkpoint
   served through ``Predictor(mesh=...)`` over a ``{data: 1, model: 2}`` and
   a ``{data: 2, model: 2}`` mesh of this card repeated (one replica a data
   index, its cortex and readout sliced over its two devices), phase 4's
   three requests; against a one-card ``Predictor`` whose chunk is a
   replica's share (32 / data), so that the frames that see only full
   chunks meet forwards of the same windows, within ``EXPORT_REL_TOL`` of
   the largest output; the difference from the chunk-32 one-card Predictor
   on every frame printed beside it; windows/s of both, each sliced
   weight's bytes a device, the host's milliseconds to queue one chunk's
   forwards against the milliseconds until the cards have run them, 9 + 9
   launches a replica's chunk forward. 19b:
   the trial program over a 2-way data mesh (``mesh_data=2``; this card
   repeated), exported, loaded and run on the same requests beside the live
   sharded ``Predictor`` (frames that see only full chunks within
   ``EXPORT_REL_TOL``); its graph must name the mesh's devices and no
   other; the tensors it stores (``state_dict`` and constants) must not
   exceed those of phase 17's one-card trial artifact (weights stored once);
   export and load seconds, ``.pt2`` bytes and the archive's bytes by part
   beside phase 17's artifact, windows/s. 19c: ``tools/dryrun.py``
   ``dryrun_multichip(2)``, two gloo ranks sharing this card, one sharded
   flagship step within 1e-4 of rank 0's unsharded step;
20. the benchmark program: ``python -m sensorium_tpu_torch.tools.bench``
   (the training headline) and then ``... --infer`` as children, each
   within ``BENCH_TIMEOUT`` seconds. Each must exit 0 and end in its
   contract line (the JAX bench's metric name, finite numbers, the card's
   name, a peak memory, ``dw_impl`` ``cuda``) with the kernel launches of
   phases 7 and 4 (per step, per chunk forward); its clips/s at least half
   of phase 7's and its windows/s at least half of phase 4's, or it
   measures some other program. Both lines and the two ratios are printed.

``--cards`` runs only the parts that need two cards or more, and fails with
fewer: 18c on phase 11's dataset, then phase 19 over 2-4 cards (devices
``i % cards``; the artifact of the (data 2, model 2) Predictor too, and a
one-card trial artifact to hold its stored bytes to; the dry run one NCCL
rank a card, up to 4) from a seeded flagship checkpoint.

After the counted serving run, one more request runs under
``torch.profiler`` and the device time is summed by kernel. The script then
prints the ``{"kernels": [...]}`` line, the nvidia-smi line again, and last
``{"ok": true, "device": {...}}``. The full per-shape record
(``chip_smoke.json``), the profiler traces (``chip_smoke_trace.json``,
``chip_smoke_train_trace.json``) and the fit's logs go to ``--out``, by
default ``build/chip_smoke/`` in the checkout; the fit's dataset is written
there too and removed after phase 15. Checkpoints, train states, the
prediction tree, the experiments and the artifacts of phases 12-19 go to a
temporary directory outside ``--out``, removed at the end. Each phase 12-19
counts the kernel launches of its own runs, from 0, and checks them against
their forwards and steps.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from sensorium_tpu_torch import constants
from sensorium_tpu_torch.utils.misc import get_lr

REPO = Path(__file__).resolve().parent

# The nn_module of configs/true_batch_001.py:36-61, with readout_outputs the
# ten mice's neuron counts.
FLAGSHIP_NN_MODULE = (
    "dwiseneuro",
    {
        "readout_outputs": list(constants.num_neurons),
        "in_channels": 5,
        "core_features": (64, 64, 64, 64, 128, 128, 128, 256, 256),
        "spatial_strides": (2, 1, 1, 1, 2, 1, 1, 2, 1),
        "spatial_kernel": 3,
        "temporal_kernel": 5,
        "expansion_ratio": 7,
        "se_reduce_ratio": 32,
        "cortex_features": (1024, 2048, 4096),
        "groups": 2,
        "softplus_beta": 0.07,
        "drop_rate": 0.4,
        "drop_path_rate": 0.1,
        "dtype": "bfloat16",
        "remat_blocks": (1,),
    },
)
FLAGSHIP_ARGUS = {
    "nn_module": FLAGSHIP_NN_MODULE,
    "frame_stack": {"size": 16, "step": 2, "position": "last"},
    "inputs_processor": ("stack_inputs", {"size": (64, 64), "pad_fill_value": 0.0}),
    "responses_processor": ("identity", {}),
}

# The training part of configs/true_batch_001.py:62-69 (lr = get_lr(3e-4, 32)).
FLAGSHIP_TRAIN_ARGUS = {
    **FLAGSHIP_ARGUS,
    "loss": ("mice_poisson", {"log_input": False, "full": False, "eps": 1e-8}),
    "optimizer": ("AdamW", {"lr": get_lr(3e-4, 32), "weight_decay": 0.05}),
    "iter_size": 1,
}
EMA_DECAY = 0.999
TRAIN_BATCH = 32
WARMUP_STEPS = 2
TIMED_STEPS = 10

CHUNK = 32  # windows per chunk forward
FRAMES = 16  # frames per window
TRIAL_LENGTH = 300
REQUESTS = 3
SEED = 0

# Published peaks of the card (NVIDIA data sheets, dense): device-memory
# bytes/s and fp32 operations/s outside the tensor cores, which is what the
# depthwise kernels' fp32 multiply-adds run on.
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100": (3.35e12, 67e12),  # SXM
}

BF16_RTOL = 2.0**-8
ATOL = 1e-5
CPU_REL_TOL = 1e-3
DW_REL_TOL = 1e-5  # weight gradients against float64: sums of up to 5e5 products
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL_TOL = 1e-3
TRAIN_GRAD_FLOOR = 1e-6
# Phase 9b: the backward's sums over rows against the plain version's, within
# BN_SUM_RTOL of the sum of the terms' magnitudes (fp32 sums of up to 2e6 terms
# in other orders, as the card tests hold them); at BN_SUM_WITNESS both are
# also held beside the same sums in float64, printed, to say which one drifts
# where the sums cancel.
BN_SUM_RTOL = 2e-5
BN_SUM_WITNESS = ("block_4.pw_bn", "block_7.pw_bn")

DWBENCH_ITERS = 10
# Phase 11: the on-disk dataset and the fit.
FIT_VIDEO = (36, 64)
FIT_TRIALS = 3  # labeled trials per mouse: trial i is fold_i under SENSORIUM_FOLD_ASSIGNMENT=trial
FIT_EPOCHS = 2
FIT_STEPS = 8  # per epoch
FIT_THREADS = 8
FIT_UNLABELED_SPLIT = "live_test_main"  # one unlabeled trial a new mouse, for phase 14

# Phase 12: the reference's own output for a 40-frame trial of the flagship
# model whose weights procedural_weights.py makes from names and shapes.
IMPORT_GOLDEN = REPO / "tests" / "golden" / "import_proof_flagship.npz"
PROCEDURAL_WEIGHTS = REPO / "tests" / "golden" / "procedural_weights.py"
IMPORT_RTOL = 2e-3  # tests/test_import_torch_flagship.py
IMPORT_ATOL_SCALE = 2e-4  # of max |expected|
# Phase 14: one checkpoint for all 7 folds, so the blend equals one Predictor.
SUBMISSION_EXPERIMENT = "smoke"
BLEND_REL_TOL = 1e-6
# Phase 15: the train CLI on phase 11's dataset, from the port's configs.
PORT_CONFIGS = REPO / "sensorium_tpu_torch" / "configs"
CLI_EXPERIMENT = "smoke_001"
CLI_DISTILL = "distill_smoke"  # distillation_001 at smoke_001's size, smoke_001's fold as the teacher
CLI_SIGTERM = "sigterm_smoke"  # smoke_001 with CLI_SIGTERM_EPOCH_SIZE clips an epoch
CLI_SIGTERM_EPOCH_SIZE = 640  # 20 steps an epoch at batch 32: the signal lands inside the fit
CLI_TP_FP32 = "tp_fp32_smoke"  # 18c: smoke_001 in fp32 with every block rematerialized
CLI_CHILD_TIMEOUT = 300  # seconds
# Phase 16: data parallelism. 16a holds two ranks of 16 rows to one step of
# 32, in fp32 at tests/test_parallel.py's tolerances (the loss 1e-5
# relative; weights rtol 1e-4 / atol 1e-5, dw kernels atol 5e-4; BN
# statistics rtol 1e-4 / atol 1e-5) and a gradient within phase 8's
# TRAIN_GRAD_REL_TOL of its tensor's largest value, floor TRAIN_GRAD_FLOOR
# of the model's largest; and in bf16, the flagship's dtype, where one
# step's gradients are only ~10% of their largest value from fp32's (16a
# prints it), each tensor within MESH_BF16_FACTOR times its own bf16 error
# (max |bf16 step - fp32 step| of the one-card reference) on top of the
# fp32 bounds, and the loss within MESH_BF16_LOSS_RTOL.
MESH_WORLD = 2
MESH_LR = get_lr(3e-4, TRAIN_BATCH)
MESH_LOSS_RTOL, MESH_BF16_LOSS_RTOL = 1e-5, 1e-4
MESH_PARAM_RTOL, MESH_PARAM_ATOL, MESH_DW_ATOL = 1e-4, 1e-5, 5e-4
MESH_STATS_RTOL, MESH_STATS_ATOL = 1e-4, 1e-5
MESH_BF16_FACTOR = 2.0
MESH_LOG_RTOL, MESH_CORR_ATOL = 1e-3, 1e-3  # 16b and 16c logs against phase 15's fold
MESH_PREDICT = "mesh_predict"  # 16c: 7 fold directories that link the mesh-trained fold's checkpoint
# Phase 17: the trial artifact's length bucket, and the bound, relative to
# the largest live output, of its bf16 results against its own program run
# eagerly on the live model (every frame) and against the live Predictor on
# the frames that see only chunks of the same 32 windows in both: where the
# forwards are the same, only the fp32 blend's order may differ. The other
# frames also see the live Predictor's short last chunk, whose bf16 products
# round otherwise; their difference is printed beside the live Predictor's
# own at chunk EXPORT_OTHER_CHUNK.
EXPORT_BUCKET = 64
EXPORT_REL_TOL = 1e-5
EXPORT_OTHER_CHUNK = 30
EXPORT_CHECKPOINT = "model-000-0.000000.ckpt"  # phase 13's EMA weights after one step, in the work directory
# Phase 18: tensor parallelism. 18a holds two ranks of a {data: 1, model: 2}
# mesh on this card, each holding all TP_BATCH rows and half of the cortex
# and readout weights, to one card's step of TP_BATCH rows at 16a's MESH_*
# bounds (a sharded weight's gradient and value gathered whole). 18b, on the
# fp32 ranks: a .orbax train state and a model checkpoint after the step;
# fresh models load the state and take TP_CONTINUED_STEPS more steps, which
# must be the uninterrupted ranks' bit for bit; the checkpoint loads into one
# card's load_model, whose forward on TP_PREDICT_ROWS rows is within
# CPU_REL_TOL (the serving tolerance) of the TP forward's largest value.
# Phase 19: the (data, model) meshes of 19a, the data mesh of 19b's
# artifact (mesh_data=2), and 19c's ranks on one card.
SERVE_MESHES = ((1, 2), (2, 2))
ARTIFACT_MESHES = ((2, 1),)  # --cards adds (2, 2)
DRYRUN_RANKS = 2
TP_WORLD = 2
TP_BATCH = 16
TP_CONTINUED_STEPS = 2
TP_PREDICT_ROWS = 4
# Phase 20: the benchmark program's children, and how far below phases 7 and 4 they may fall.
BENCH_TIMEOUT = 300  # seconds a child
BENCH_MIN_RATIO = 0.5
# Runs ``python -m MODULE ARGS`` and writes the kernel launches to PATH when the process exits.
COUNTED_MODULE = (
    "import atexit, json, runpy, sys\n"
    "from sensorium_tpu_torch.ops import dw_kernels\n"
    "path, module = sys.argv[1], sys.argv[2]\n"
    "atexit.register(lambda: open(path, 'w').write(json.dumps(dict(dw_kernels.LAUNCHES))))\n"
    "sys.argv = [module, *sys.argv[3:]]\n"
    "runpy.run_module(module, run_name='__main__', alter_sys=True)\n"
)


def fail(message: str) -> None:
    print(f"FAIL: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_peaks(name: str) -> tuple[float, float]:
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    fail(f"no published peaks known for card {name!r}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def kernel_label(mangled: str) -> str:
    """``dw_spatial_fwd_kernel<bf16,3,1,4>`` from the mangled name of a kernel
    in a namespace (the type, then the integer template arguments)."""
    scope = re.match(r"_ZN(\d+)", mangled)
    if not scope:
        return mangled
    pos = scope.end() + int(scope.group(1))  # past the namespace's name
    length = re.match(r"(\d+)", mangled[pos:])
    if not length:
        return mangled
    start = pos + length.end()
    name, rest = mangled[start : start + int(length.group(1))], mangled[start + int(length.group(1)) :]
    if not rest.startswith("I"):
        return name
    dtype = "bf16" if rest.startswith("I13__nv_bfloat16") else "f32" if rest.startswith("If") else ""
    args = [dtype, *re.findall(r"Li(\d+)E", rest.split("EEv")[0])]
    return f"{name}<{','.join(a for a in args if a)}>"


def ptxas_summary(log: str) -> list[str]:
    """One entry per kernel of ``nvcc -Xptxas -v`` output: its name, registers and spills."""
    out, name, spills = [], "", ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = kernel_label(entry.group(1))
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            used = re.search(r"Used (\d+) registers", line)
            out.append(f"{name} {used.group(1) if used else '?'} registers, {spills}")
    return out


def cuda_ms(fn, reps: int = 5, warmup: int = 2) -> float:
    """Median CUDA-event time of one call of ``fn`` in milliseconds. A call
    under 2 ms is timed over back-to-back calls, enough for about 2 ms a
    sample, so that the host's time to launch each call hides behind the
    card's work, as on the model's path, instead of adding to it while the
    card waits."""
    import torch

    def sample(calls: int) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    for _ in range(warmup):
        fn()
    calls = max(1, min(50, int(2.0 / max(sample(1), 0.04))))
    return statistics.median(sample(calls) for _ in range(reps))


def graph_ms(fn) -> float:
    """``cuda_ms`` of ``fn`` captured once in a CUDA graph: the card's time
    alone, where a call's few small launches take the host longer to make
    than the card to run."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay)


def spatial_2d_view(t):
    """(B, T, H, W, C) as the channels-last (B*T, C, H, W) view, without a copy."""
    b, f, h, w, c = t.shape
    return t.reshape(b * f, h, w, c).permute(0, 3, 1, 2)


def temporal_2d_view(t):
    """(B, T, H, W, C) as the channels-last (B, C, T, H*W) view, without a copy."""
    b, f, h, w, c = t.shape
    return t.reshape(b, f, h * w, c).permute(0, 3, 1, 2)


def flagship_kernel_shapes() -> list[dict]:
    """The depthwise convs of one flagship chunk forward, grouped by shape."""
    params = FLAGSHIP_NN_MODULE[1]
    feats, strides = params["core_features"], params["spatial_strides"]
    ratio, k = params["expansion_ratio"], params["spatial_kernel"]
    spatial, temporal = {}, {}
    size = FLAGSHIP_ARGUS["inputs_processor"][1]["size"][0]
    for block, (f, s) in enumerate(zip(feats, strides)):
        c = f * ratio
        spatial.setdefault((size, c, s), []).append(block)
        size = (size + 2 * (k // 2) - k) // s + 1
        temporal.setdefault((size, c), []).append(block)
    shapes = [
        {"kernel": "dw_spatial_fwd", "hw": (h, h), "c": c, "stride": s, "k": params["spatial_kernel"], "blocks": b}
        for (h, c, s), b in spatial.items()
    ]
    shapes += [
        {"kernel": "dw_temporal_fwd", "hw": (h, h), "c": c, "k": params["temporal_kernel"], "blocks": b}
        for (h, c), b in temporal.items()
    ]
    return shapes


def flagship_bn_calls(batch: int, frames: int) -> list[dict]:
    """Every BN of one flagship forward of ``batch`` clips of ``frames``
    frames: its place, x viewed as (rows, C), whether SiLU follows and
    whether its input is a strided view (the stride-2 shortcut of a block
    that keeps its width)."""
    params = FLAGSHIP_NN_MODULE[1]
    feats, strides = params["core_features"], params["spatial_strides"]
    ratio, k = params["expansion_ratio"], params["spatial_kernel"]
    size = FLAGSHIP_ARGUS["inputs_processor"][1]["size"][0]
    n = batch * frames
    calls = [{"name": "stem_bn", "block": None, "rows": n * size * size, "c": feats[0], "act": False,
              "strided": False}]
    for i, (f, s) in enumerate(zip(feats, strides)):
        # As DwiseNeuro builds block i: features[i] in, features[i + 1] out (the last keeps its width).
        out_f = feats[i + 1] if i + 1 < len(feats) else f
        mid, out_size = f * ratio, (size + 2 * (k // 2) - k) // s + 1
        rows_in, rows_out = n * size * size, n * out_size * out_size
        for name, rows, c, act in (("bn_sc", rows_out, out_f, False), ("pw_bn", rows_in, mid, True),
                                   ("spatial_bn", rows_out, mid, True), ("temporal_bn", rows_out, mid, True),
                                   ("pwl_bn", rows_out, out_f, False)):
            calls.append({"name": f"block_{i}.{name}", "block": i, "rows": rows, "c": c, "act": act,
                          "strided": name == "bn_sc" and s > 1 and f == out_f})
        size = out_size
    for i, f in enumerate(params["cortex_features"]):
        for name, act in (("bn", True), ("bn_sc", False)):
            calls.append({"name": f"cortex_{i}.{name}", "block": None, "rows": n, "c": f, "act": act,
                          "strided": False})
    return calls


def temporal_edge_cases(kernel: str) -> list[dict]:
    """The edges of the temporal kernels' column walk: k = 5 at a ragged frame,
    T below k (1, 2) and not a multiple of the frame tile (37) at both k,
    channel tails (C not a multiple of 8 in bf16 or of 4 in fp32) and C wider
    than one channel tile."""
    cases = [{"kernel": kernel, "hw": (9, 11), "c": 24, "k": 5, "blocks": [], "batch": (2, 7)}]
    for k in (3, 5):
        for t in (1, 2, 37):
            cases.append({"kernel": kernel, "hw": (9, 11), "c": 24, "k": k, "blocks": [], "batch": (2, t)})
        for hw, c in (((9, 11), 20), ((9, 11), 22), ((10, 12), 264)):
            cases.append({"kernel": kernel, "hw": hw, "c": c, "k": k, "blocks": [], "batch": (2, 7)})
    return cases


def check_kernels(peaks: tuple[float, float]) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from sensorium_tpu_torch.ops import dw_kernels

    bytes_per_s, ops_per_s = peaks
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [dict(s, batch=(CHUNK, FRAMES)) for s in flagship_kernel_shapes()]
    for stride in (1, 2):  # ragged shapes
        for k in (3, 5):
            cases.append({"kernel": "dw_spatial_fwd", "hw": (9, 11), "c": 24, "stride": stride, "k": k,
                          "blocks": [], "batch": (2, 3)})
    cases.append({"kernel": "dw_temporal_fwd", "hw": (9, 11), "c": 24, "k": 3, "blocks": [], "batch": (2, 7)})
    cases += temporal_edge_cases("dw_temporal_fwd")
    # The spatial forward's tile edges: sizes that are not multiples of its
    # tiles, frames wider or taller than one column tile, a 1x1 frame, channel
    # tails, C wider than one channel tile.
    edges = [((33, 17), 24, (3, 5)), ((7, 5), 24, (3, 5)), ((2, 70), 24, (3,)), ((70, 3), 24, (3,)),
             ((1, 1), 24, (3,)), ((9, 11), 20, (3,)), ((9, 11), 22, (3,)), ((10, 12), 264, (3,))]
    for hw, c, ks in edges:
        for k in ks:
            for stride in (1, 2):
                cases.append({"kernel": "dw_spatial_fwd", "hw": hw, "c": c, "stride": stride, "k": k, "blocks": [],
                              "batch": (2, 3)})
    # Enough small frames that each block walks several.
    for hw, c, k, stride in (((7, 5), 24, 3, 1), ((4, 4), 22, 3, 2), ((1, 1), 8, 5, 1)):
        cases.append({"kernel": "dw_spatial_fwd", "hw": hw, "c": c, "stride": stride, "k": k, "blocks": [],
                      "batch": (64, 128)})

    rows = []
    for case in cases:
        for dtype in (torch.bfloat16, torch.float32):
            b, t = case["batch"]
            h, w = case["hw"]
            c, k = case["c"], case["k"]
            x = torch.randn(b, t, h, w, c, device="cuda", generator=gen).to(dtype)
            if case["kernel"] == "dw_spatial_fwd":
                s = case["stride"]
                wt = (torch.randn(k, k, c, device="cuda", generator=gen) / k).to(dtype)
                run = lambda: dw_kernels.dw_spatial_fwd(x, wt, s)  # noqa: E731
                plain = lambda: dw_kernels.dw_spatial_plain(x, wt, s)  # noqa: E731
                wl = wt.permute(2, 0, 1)[:, None, None].contiguous()  # (C, 1, 1, k, k)
                library = lambda: F.conv3d(  # noqa: E731
                    x.permute(0, 4, 1, 2, 3), wl, stride=(1, s, s), padding=(0, k // 2, k // 2), groups=c
                )
                x2d, w2d = spatial_2d_view(x), wl[:, :, 0]  # (B*T, C, H, W) channels-last, (C, 1, k, k)
                library2d = lambda: F.conv2d(x2d, w2d, stride=s, padding=k // 2, groups=c)  # noqa: E731
                taps = k * k
            else:
                wt = (torch.randn(k, c, device="cuda", generator=gen) / math.sqrt(k)).to(dtype)
                run = lambda: dw_kernels.dw_temporal_fwd(x, wt)  # noqa: E731
                plain = lambda: dw_kernels.dw_temporal_plain(x, wt)  # noqa: E731
                wl = wt.t()[:, None, :, None, None].contiguous()  # (C, 1, k, 1, 1)
                library = lambda: F.conv3d(  # noqa: E731
                    x.permute(0, 4, 1, 2, 3), wl, padding=(k // 2, 0, 0), groups=c
                )
                x2d, w2d = temporal_2d_view(x), wl[..., 0]  # (B, C, T, H*W) channels-last, (C, 1, k, 1)
                library2d = lambda: F.conv2d(x2d, w2d, padding=(k // 2, 0), groups=c)  # noqa: E731
                taps = k
            y = run()
            torch.cuda.synchronize()
            ref = (
                dw_kernels.dw_spatial_plain(x.float(), wt.float(), case["stride"])
                if case["kernel"] == "dw_spatial_fwd"
                else dw_kernels.dw_temporal_plain(x.float(), wt.float())
            )
            lib = library().permute(0, 2, 3, 4, 1)
            lib2d = library2d().permute(0, 2, 3, 1).reshape(ref.shape)
            if y.shape != ref.shape or lib.shape != ref.shape:
                fail(f"{case['kernel']} {case}: shape {tuple(y.shape)} vs plain {tuple(ref.shape)}")
            err = (y.float() - ref).abs()
            rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
            ok = bool(torch.all(err <= ATOL + rtol * ref.abs()))
            lib_err = float((lib.float() - ref).abs().max())
            lib2d_err = float((lib2d.float() - ref).abs().max())
            del ref, lib, lib2d
            row = {
                "kernel": case["kernel"],
                "dtype": str(dtype).replace("torch.", ""),
                "shape": [b, t, h, w, c],
                "stride": case.get("stride", 1),
                "k": k,
                "blocks": case["blocks"],
                "max_abs_err": float(err.max()),
                "library_max_abs_err": lib_err,
                "library2d_max_abs_err": lib2d_err,
                "ok": ok,
            }
            del err
            nbytes = (x.numel() + wt.numel() + y.numel()) * x.element_size()
            ops = 2 * taps * y.numel()
            row["bytes"] = nbytes
            row["bytes_ms"], row["ops_ms"] = nbytes / bytes_per_s * 1e3, ops / ops_per_s * 1e3
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
            row["ms"] = cuda_ms(run)
            row["plain_ms"] = cuda_ms(plain, reps=3, warmup=1)
            row["library3d_ms"], row["library2d_ms"] = cuda_ms(library), cuda_ms(library2d)
            row["library_ms"] = min(row["library3d_ms"], row["library2d_ms"])
            rows.append(row)
            print(
                f"kernel {row['kernel']:<16} {row['dtype']:<8} {str(row['shape']):<28} s={row['stride']} k={k} "
                f"blocks={row['blocks']} err={row['max_abs_err']:.3g} ok={ok} ms={row['ms']:.4f} "
                f"plain_ms={row['plain_ms']:.4f} library3d_ms={row['library3d_ms']:.4f} "
                f"library2d_ms={row['library2d_ms']:.4f} "
                f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}, {nbytes / 1e9:.3f} GB)",
                flush=True,
            )
            del x, wt, y, x2d
            torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel checks disagree with their plain versions: {bad}")
    return rows


def check_prologue_kernels(peaks: tuple[float, float]) -> list[dict]:
    """Phase 3b: the eval BN prologue convs at every shape of the flagship
    chunk forward, bitwise the chain of the BN pass and the plain kernel,
    timed beside it."""
    import torch

    from sensorium_tpu_torch.ops import bn_kernels, dw_kernels

    bytes_per_s, ops_per_s = peaks
    eps = 1e-5
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for case in flagship_kernel_shapes():
        spatial = case["kernel"] == "dw_spatial_fwd"
        name = f"{case['kernel']}_bn"
        h, w = case["hw"]
        c, k = case["c"], case["k"]
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(CHUNK, FRAMES, h, w, c, device="cuda", generator=gen).to(dtype)
            bn = (1.5 + torch.randn(c, device="cuda", generator=gen), 0.5 + torch.rand(c, device="cuda", generator=gen),
                  1 + 0.2 * torch.randn(c, device="cuda", generator=gen), 0.2 * torch.randn(c, device="cuda", generator=gen))
            act = bn_kernels.bn_act_eval(x, *bn, eps, True)
            if spatial:
                s = case["stride"]
                wt = (torch.randn(k, k, c, device="cuda", generator=gen) / k).to(dtype)
                run = lambda: dw_kernels.dw_spatial_fwd_bn(x, wt, *bn, eps, s)  # noqa: E731
                plain = lambda: dw_kernels.dw_spatial_fwd(act, wt, s)  # noqa: E731
                chain = lambda: dw_kernels.dw_spatial_fwd(bn_kernels.bn_act_eval(x, *bn, eps, True), wt, s)  # noqa: E731
                taps = k * k
            else:
                wt = (torch.randn(k, c, device="cuda", generator=gen) / math.sqrt(k)).to(dtype)
                run = lambda: dw_kernels.dw_temporal_fwd_bn(x, wt, *bn, eps)  # noqa: E731
                plain = lambda: dw_kernels.dw_temporal_fwd(act, wt)  # noqa: E731
                chain = lambda: dw_kernels.dw_temporal_fwd(bn_kernels.bn_act_eval(x, *bn, eps, True), wt)  # noqa: E731
                taps = k
            y = run()
            ok = bool(torch.equal(y, plain()))
            nbytes = (x.numel() + wt.numel() + y.numel()) * x.element_size() + 4 * c * 4
            ops = 2 * taps * y.numel()
            row = {"kernel": name, "dtype": str(dtype).replace("torch.", ""), "shape": [CHUNK, FRAMES, h, w, c],
                   "stride": case.get("stride", 1), "k": k, "blocks": case["blocks"], "bitwise_chain": ok,
                   "ok": ok, "bytes": nbytes, "bytes_ms": nbytes / bytes_per_s * 1e3, "ops_ms": ops / ops_per_s * 1e3}
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
            row["ms"] = cuda_ms(run)
            row["plain_kernel_ms"] = cuda_ms(plain)
            row["bn_ms"] = cuda_ms(lambda: bn_kernels.bn_act_eval(x, *bn, eps, True))
            row["chain_ms"] = cuda_ms(chain)
            rows.append(row)
            print(f"kernel {name:<18} {row['dtype']:<8} {str(row['shape']):<28} s={row['stride']} k={k} "
                  f"blocks={row['blocks']} bitwise={ok} ms={row['ms']:.4f} plain_kernel_ms="
                  f"{row['plain_kernel_ms']:.4f} bn_ms={row['bn_ms']:.4f} chain_ms={row['chain_ms']:.4f} "
                  f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}, {nbytes / 1e9:.3f} GB)", flush=True)
            del x, act, y, wt
            torch.cuda.empty_cache()
    for name in ("dw_spatial_fwd_bn", "dw_temporal_fwd_bn"):
        flagship = [r for r in rows if r["kernel"] == name and r["dtype"] == "bfloat16"]
        sums = {key: sum(r[key] * len(r["blocks"]) for r in flagship)
                for key in ("ms", "plain_kernel_ms", "bn_ms", "chain_ms", "bound_ms")}
        print(f"kernel {name}: per flagship chunk forward (bf16): {sums['ms']:.3f} ms against {sums['bound_ms']:.3f} "
              f"ms bound ({100 * sums['bound_ms'] / sums['ms']:.1f}%); the plain kernel alone "
              f"{sums['plain_kernel_ms']:.3f} ms, the BN pass {sums['bn_ms']:.3f} ms, the chain "
              f"{sums['chain_ms']:.3f} ms", flush=True)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} prologue convs differ from the chain: {bad}")
    return rows


def make_trial(rng):
    import numpy as np

    return (
        rng.uniform(0, 255, (36, 64, TRIAL_LENGTH)).astype(np.float32),
        rng.uniform(0, 5, (2, TRIAL_LENGTH)).astype(np.float32),
        rng.uniform(50, 200, (2, TRIAL_LENGTH)).astype(np.float32),
    )


def serve(record: dict, out_dir: Path) -> dict:
    """Phase 4: the flagship model answers REQUESTS trials through the Predictor."""
    import numpy as np
    import torch

    from sensorium_tpu_torch.infer.predictor import Predictor
    from sensorium_tpu_torch.models.registry import get_nn_module
    from sensorium_tpu_torch.ops import bn_kernels, dw_kernels

    start = time.perf_counter()
    model = get_nn_module(*FLAGSHIP_NN_MODULE, device="cuda", generator=torch.Generator().manual_seed(SEED))
    predictor = Predictor.from_module(model, FLAGSHIP_ARGUS, chunk_size=CHUNK, device="cuda")
    torch.cuda.synchronize()
    params = sum(p.numel() for p in model.parameters())
    print(f"slice: flagship DwiseNeuro bf16, {params} parameters, built in {time.perf_counter() - start:.1f} s")

    rng = np.random.default_rng(SEED)
    warm = make_trial(rng)
    start = time.perf_counter()
    predictor.predict_trial(*warm, mouse_index=0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - start
    trials = [make_trial(rng) for _ in range(REQUESTS)]
    windows = len(predictor.indexes_generator.valid_anchors(TRIAL_LENGTH))
    forwards = REQUESTS * math.ceil(windows / CHUNK)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = time.perf_counter()
    outputs = [predictor.predict_trial(*trial, mouse_index=0) for trial in trials]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = dict(dw_kernels.LAUNCHES)
    bn_launches = dict(bn_kernels.LAUNCHES)

    for i, out in enumerate(outputs):
        expected = (FLAGSHIP_NN_MODULE[1]["readout_outputs"][0], TRIAL_LENGTH)
        if out.shape != expected:
            fail(f"request {i}: shape {out.shape}, expected {expected}")
        if not np.all(np.isfinite(out)) or np.any(out < 0):
            fail(f"request {i}: output not finite and non-negative")
    check_forward_launches("slice", launches, forwards)
    check_bn_launches("slice", bn_launches, expected_bn_launches(forwards=forwards))
    result = {
        "requests": REQUESTS,
        "windows_per_request": windows,
        "chunk_forwards": forwards,
        "launches": launches,
        "bn_launches": bn_launches,
        "seconds": elapsed,
        "seconds_per_trial": elapsed / REQUESTS,
        "windows_per_second": REQUESTS * windows / elapsed,
        "first_request_seconds": warm_s,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "output_mean": float(np.mean(outputs[0])),
    }
    print(
        f"slice: {REQUESTS} requests x {windows} windows in {elapsed:.3f} s: "
        f"{result['windows_per_second']:.1f} windows/s, {result['seconds_per_trial']:.3f} s/trial "
        f"(first request {warm_s:.2f} s), launches {launches} over {forwards} chunk forwards, "
        f"peak memory {result['peak_memory_gb']:.2f} GB",
        flush=True,
    )
    record["serve"] = result
    record["profile"] = profile(lambda: predictor.predict_trial(*trials[0], mouse_index=0), "one request",
                                out_dir / "chip_smoke_trace.json")
    del predictor, model
    torch.cuda.empty_cache()
    return launches


def profile(fn, label: str, trace: Path, top_n: int = 15) -> dict:
    """Where one call's device time goes: ``fn`` once under torch.profiler,
    kernels summed by name; the trace goes to ``trace``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    start = time.perf_counter()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - start) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:top_n]
    rows = [{"kernel": e.key[:120], "count": e.count, "ms": e.self_device_time_total / 1e3,
             "share": e.self_device_time_total / busy_us if busy_us else 0.0} for e in top]
    # The port's own kernels by the CUDA function names of csrc/ (dw_spatial_dw_kernel for dw_spatial_dw).
    port = {name: sum(e.self_device_time_total for e in kernels if f"{name}_" in e.key) / 1e3
            for name in ("dw_spatial_fwd", "dw_temporal_fwd", "dw_spatial_dx", "dw_spatial_dw", "dw_temporal_dw")}
    print(f"profile: {label} under torch.profiler, wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy_us / 1e3:.1f} ms ({busy_us / wall_us:.1%} of wall)", flush=True)
    for r in rows:
        print(f"profile:   {r['ms']:9.2f} ms {r['share']:6.1%} x{r['count']:<5} {r['kernel']}", flush=True)
    print("profile:   the port's kernels: " + ", ".join(
        f"{name} {ms:.2f} ms ({ms * 1e3 / busy_us if busy_us else 0.0:.2%})" for name, ms in port.items()), flush=True)
    prof.export_chrome_trace(str(trace))
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3, "top_kernels": rows, "port_kernels_ms": port}


def card_against_cpu(record: dict) -> None:
    """Phase 5: the same weights in fp32, 2 windows, card (kernels) vs CPU (plain)."""
    import numpy as np
    import torch

    from sensorium_tpu_torch.data.indexes import WindowIndexer
    from sensorium_tpu_torch.infer.predictor import assemble_trial_stack
    from sensorium_tpu_torch.models.registry import get_nn_module

    name, params = FLAGSHIP_NN_MODULE
    params = {**params, "dtype": "float32"}
    cpu_model = get_nn_module(name, params, device="cpu", generator=torch.Generator().manual_seed(SEED))
    card_model = get_nn_module(name, params, device="cuda", generator=torch.Generator().manual_seed(SEED))
    video, behavior, pupil = make_trial(np.random.default_rng(SEED + 1))
    stack = assemble_trial_stack(
        torch.from_numpy(np.ascontiguousarray(video.transpose(2, 0, 1))),
        torch.from_numpy(behavior), torch.from_numpy(pupil), 64, 64, 0.0,
    )
    indexer = WindowIndexer(FRAMES, FLAGSHIP_ARGUS["frame_stack"]["step"])
    windows = torch.from_numpy(indexer.windows([indexer.behind, TRIAL_LENGTH - 1]))  # first and last anchor
    batch = stack.index_select(1, windows.reshape(-1)).view(5, 2, FRAMES, 64, 64).transpose(0, 1).contiguous()
    with torch.inference_mode():
        card = card_model(batch.cuda(), mouse_index=0).cpu()
        cpu = cpu_model(batch, mouse_index=0)
    diff = float((card - cpu).abs().max())
    scale = float(cpu.abs().max())
    rel = diff / scale
    print(f"card vs cpu: fp32 single-mouse forward of 2 windows, max |diff| {diff:.4g}, "
          f"max |cpu| {scale:.4g}, relative {rel:.3g} (tolerance {CPU_REL_TOL})", flush=True)
    record["card_vs_cpu"] = {"max_abs_diff": diff, "max_abs_cpu": scale, "relative": rel, "tolerance": CPU_REL_TOL}
    if not (np.isfinite(rel) and rel <= CPU_REL_TOL):
        fail(f"card and CPU disagree: relative difference {rel}")


def backward_cases() -> list[dict]:
    """The backward kernels' calls of one flagship training step (grouped by
    shape), then ragged shapes."""
    cases = []
    for shape in flagship_kernel_shapes():
        batch = {"batch": (TRAIN_BATCH, FRAMES)}
        if shape["kernel"] == "dw_spatial_fwd":
            cases.append({**shape, **batch, "kernel": "dw_spatial_dx"})
            cases.append({**shape, **batch, "kernel": "dw_spatial_dw"})
        else:
            cases.append({**shape, **batch, "kernel": "dw_temporal_dw"})
    for hw in ((9, 11), (10, 12)):
        for k in (3, 5):
            for stride in (1, 2):
                for kernel in ("dw_spatial_dx", "dw_spatial_dw"):
                    cases.append({"kernel": kernel, "hw": hw, "c": 24, "stride": stride, "k": k, "blocks": [],
                                  "batch": (2, 3)})
            cases.append({"kernel": "dw_temporal_dw", "hw": hw, "c": 24, "k": k, "blocks": [], "batch": (2, 3)})
    cases += temporal_edge_cases("dw_temporal_dw")
    # dx and dw: sizes that are not multiples of the tiles, channel tails, C
    # wider than a channel tile; dw also a 1x1 frame.
    for hw, c, ks in (((33, 17), 24, (3, 5)), ((7, 5), 24, (3, 5)), ((9, 11), 20, (3,)), ((9, 11), 22, (3,)),
                      ((10, 12), 264, (3,)), ((1, 1), 24, (3,))):
        for k in ks:
            for stride in (1, 2):
                for kernel in ("dw_spatial_dx", "dw_spatial_dw"):
                    if hw == (1, 1) and kernel == "dw_spatial_dx":
                        continue
                    cases.append({"kernel": kernel, "hw": hw, "c": c, "stride": stride, "k": k, "blocks": [],
                                  "batch": (2, 3)})
    # dw: enough small frames that each block walks many of them.
    for hw, c, k, stride in (((7, 5), 24, 3, 1), ((4, 4), 22, 3, 2), ((1, 1), 8, 5, 1)):
        cases.append({"kernel": "dw_spatial_dw", "hw": hw, "c": c, "stride": stride, "k": k, "blocks": [],
                      "batch": (64, 128)})
    return cases


def check_backward_kernels(peaks: tuple[float, float]) -> list[dict]:
    """Phase 6: the backward kernels against their plain versions, timed."""
    import torch

    from sensorium_tpu_torch.ops import dw_kernels

    bytes_per_s, ops_per_s = peaks
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    backward = torch.ops.aten.convolution_backward
    rows = []
    for case in backward_cases():
        for dtype in (torch.bfloat16, torch.float32):
            b, t = case["batch"]
            h, w = case["hw"]
            c, k, name = case["c"], case["k"], case["kernel"]
            s = case.get("stride", 1)
            x = torch.randn(b, t, h, w, c, device="cuda", generator=gen).to(dtype)
            if name == "dw_temporal_dw":
                dy = torch.randn(b, t, h, w, c, device="cuda", generator=gen).to(dtype)
                wl = torch.empty(c, 1, k, 1, 1, device="cuda", dtype=dtype)
                conv = {"stride": [1, 1, 1], "padding": [k // 2, 0, 0]}
                view2d, conv2d = temporal_2d_view, {"stride": [1, 1], "padding": [k // 2, 0]}
                run = lambda: dw_kernels.dw_temporal_dw(x, dy, k)  # noqa: E731
                plain = lambda: dw_kernels.dw_temporal_dw_plain(x, dy, k)  # noqa: E731
                ref = dw_kernels.dw_temporal_dw_plain(x.double(), dy.double(), k)
                taps, mask = k, [False, True, False]
            else:
                oh, ow = dw_kernels.spatial_out_size(h, k, s), dw_kernels.spatial_out_size(w, k, s)
                dy = torch.randn(b, t, oh, ow, c, device="cuda", generator=gen).to(dtype)
                wt = (torch.randn(k, k, c, device="cuda", generator=gen) / k).to(dtype)
                wl = wt.permute(2, 0, 1)[:, None, None].contiguous()  # (C, 1, 1, k, k)
                conv = {"stride": [1, s, s], "padding": [0, k // 2, k // 2]}
                view2d, conv2d = spatial_2d_view, {"stride": [s, s], "padding": [k // 2, k // 2]}
                taps = k * k
                if name == "dw_spatial_dx":
                    run = lambda: dw_kernels.dw_spatial_dx(dy, wt, s, (h, w))  # noqa: E731
                    plain = lambda: dw_kernels.dw_spatial_dx_plain(dy, wt, s, (h, w))  # noqa: E731
                    ref = dw_kernels.dw_spatial_dx_plain(dy.float(), wt.float(), s, (h, w))
                    mask = [True, False, False]
                else:
                    run = lambda: dw_kernels.dw_spatial_dw(x, dy, k, s)  # noqa: E731
                    plain = lambda: dw_kernels.dw_spatial_dw_plain(x, dy, k, s)  # noqa: E731
                    ref = dw_kernels.dw_spatial_dw_plain(x.double(), dy.double(), k, s)
                    mask = [False, True, False]
            x_ncdhw, dy_ncdhw = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)
            library = lambda: backward(  # noqa: E731
                dy_ncdhw, x_ncdhw, wl, None, conv["stride"], conv["padding"], [1, 1, 1], False, [0, 0, 0], c, mask
            )
            x2d, dy2d, wl2d = view2d(x), view2d(dy), wl.squeeze(2 if name != "dw_temporal_dw" else 4)
            library2d = lambda: backward(  # noqa: E731
                dy2d, x2d, wl2d, None, conv2d["stride"], conv2d["padding"], [1, 1], False, [0, 0], c, mask
            )
            y = run()
            torch.cuda.synchronize()
            if y.shape != ref.shape:
                fail(f"{name} {case}: shape {tuple(y.shape)} vs plain {tuple(ref.shape)}")
            err = (y.to(ref.dtype) - ref).abs()
            if name == "dw_spatial_dx":  # the 2-D library's gradient, back in the kernel's layout
                lib2d = library2d()[0].permute(0, 2, 3, 1).reshape(ref.shape)
            else:
                lib2d = library2d()[1][:, 0].permute(1, 2, 0).reshape(ref.shape)
            lib2d_err = float((lib2d.to(ref.dtype) - ref).abs().max())
            del lib2d
            if name == "dw_spatial_dx":
                rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
                ok = bool(torch.all(err <= ATOL + rtol * ref.abs()))
                out_bytes = y.numel() * y.element_size()
                in_bytes = (dy.numel() + wt.numel()) * dy.element_size()
            else:
                ok = bool(err.max() <= DW_REL_TOL * ref.abs().max() + DW_REL_TOL)
                out_bytes = y.numel() * 4
                in_bytes = (x.numel() + dy.numel()) * x.element_size()
            if name == "dw_temporal_dw":  # fixed-order sums: a rerun is bitwise equal
                rerun_equal = torch.equal(y, run())
                ok = ok and rerun_equal
            row = {
                "kernel": name,
                "dtype": str(dtype).replace("torch.", ""),
                "shape": [b, t, h, w, c],
                "stride": s,
                "k": k,
                "blocks": case["blocks"],
                "max_abs_err": float(err.max()),
                "max_abs_ref": float(ref.abs().max()),
                "library2d_max_abs_err": lib2d_err,
                "ok": ok,
            }
            if name == "dw_temporal_dw":
                row["rerun_bitwise_equal"] = rerun_equal
            del err, ref
            nbytes = in_bytes + out_bytes
            ops = 2 * taps * dy.numel()
            row["bytes"] = nbytes
            row["bytes_ms"], row["ops_ms"] = nbytes / bytes_per_s * 1e3, ops / ops_per_s * 1e3
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
            row["ms"] = cuda_ms(run)
            row["plain_ms"] = cuda_ms(plain, reps=3, warmup=1)
            row["library3d_ms"], row["library2d_ms"] = cuda_ms(library), cuda_ms(library2d)
            row["library_ms"] = min(row["library3d_ms"], row["library2d_ms"])
            rows.append(row)
            print(
                f"kernel {name:<16} {row['dtype']:<8} {str(row['shape']):<28} s={s} k={k} "
                f"blocks={row['blocks']} err={row['max_abs_err']:.3g} (max |ref| {row['max_abs_ref']:.3g}) ok={ok} "
                f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} library3d_ms={row['library3d_ms']:.4f} "
                f"library2d_ms={row['library2d_ms']:.4f} (err {lib2d_err:.3g}) "
                f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}, {nbytes / 1e9:.3f} GB)",
                flush=True,
            )
            del x, dy, y, x2d, dy2d
            torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} backward kernel checks disagree with their plain versions: {bad}")
    return rows


def synthetic_batch(batch: int):
    """One batch made as bench.py makes it: uniform 0-255 video, gamma(1.5, 1)
    responses of every mouse's padded width, one-hot mouse ``i % 10``."""
    import numpy as np

    from sensorium_tpu_torch.data.datasets import MiceBatch

    rng = np.random.default_rng(SEED)
    inputs = rng.uniform(0, 255, (batch, 5, FRAMES, 64, 64)).astype(np.float32)
    targets = rng.gamma(1.5, 1.0, (batch, max(constants.num_neurons), FRAMES)).astype(np.float32)
    weights = np.zeros((batch, constants.num_mice), np.float32)
    weights[np.arange(batch), np.arange(batch) % constants.num_mice] = 1.0
    return MiceBatch(inputs=inputs, targets=targets, weights=weights)


def expected_train_launches() -> dict:
    """Kernel launches of one flagship train step, from the config."""
    params = FLAGSHIP_NN_MODULE[1]
    blocks, remat = len(params["core_features"]), len(params["remat_blocks"])
    return {"dw_spatial_fwd": blocks + remat, "dw_temporal_fwd": 2 * blocks + remat,
            "dw_spatial_dx": blocks, "dw_spatial_dw": blocks, "dw_temporal_dw": blocks}


def train(record: dict, out_dir: Path) -> dict:
    """Phase 7: flagship training steps through MouseModel, then a val_step."""
    import numpy as np
    import torch

    from sensorium_tpu_torch.engine.model import MouseModel
    from sensorium_tpu_torch.ops import bn_kernels, dw_kernels

    start = time.perf_counter()
    model = MouseModel(FLAGSHIP_TRAIN_ARGUS, device="cuda")
    model.set_ema(EMA_DECAY)
    state = model.build_state(seed=SEED, learning_rate=get_lr(3e-4, TRAIN_BATCH))
    batch = synthetic_batch(TRAIN_BATCH)
    torch.cuda.synchronize()
    print(f"train: flagship MouseModel bf16 (AdamW lr {get_lr(3e-4, TRAIN_BATCH)}, wd 0.05, EMA {EMA_DECAY}), "
          f"built in {time.perf_counter() - start:.1f} s", flush=True)

    start = time.perf_counter()
    losses = [model.train_step(batch) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - start
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start = time.perf_counter()
    losses += [model.train_step(batch) for _ in range(TIMED_STEPS)]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    launches = dict(dw_kernels.LAUNCHES)
    bn_launches = dict(bn_kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(v) for v in losses]

    per_step = expected_train_launches()
    result = {
        "batch": TRAIN_BATCH,
        "timed_steps": TIMED_STEPS,
        "seconds": elapsed,
        "seconds_per_step": elapsed / TIMED_STEPS,
        "clips_per_second": TIMED_STEPS * TRAIN_BATCH / elapsed,
        "warmup_seconds": warm_s,
        "peak_memory_gb": peak_gb,
        "losses": losses,
        "launches": launches,
        "launches_per_step_expected": per_step,
        "bn_launches": bn_launches,
    }
    print(f"train: {TIMED_STEPS} steps of batch {TRAIN_BATCH} in {elapsed:.3f} s: "
          f"{result['seconds_per_step']:.4f} s/step, {result['clips_per_second']:.1f} clips/s "
          f"(2 warm-up steps {warm_s:.2f} s), peak memory {peak_gb:.2f} GB", flush=True)
    print("train: losses " + " ".join(f"{v:.6f}" for v in losses), flush=True)
    print(f"train: launches {launches} over {TIMED_STEPS} steps, expected {per_step} per step", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"train: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train: the loss did not fall: first {losses[0]}, last {losses[-1]}")
    for key, count in per_step.items():
        if launches[key] != count * TIMED_STEPS:
            fail(f"train: {key} launched {launches[key]} times in {TIMED_STEPS} steps, expected {count} per step")
    check_bn_launches("train", bn_launches, expected_bn_launches(steps=TIMED_STEPS))

    val_loss, prediction, _, _ = model.val_step(batch)
    val_loss = float(val_loss)
    expected = (constants.num_mice, TRAIN_BATCH, max(constants.num_neurons), FRAMES)
    if tuple(prediction.shape) != expected or not np.isfinite(val_loss) or not bool(torch.isfinite(prediction).all()):
        fail(f"train: val_step on the EMA weights gave loss {val_loss}, prediction {tuple(prediction.shape)}")
    result["val_loss_ema"] = val_loss
    print(f"train: val_step on the EMA weights: loss {val_loss:.6f}, prediction {expected}", flush=True)
    del prediction
    result["profile"] = profile(lambda: model.train_step(batch), "one train step",
                                out_dir / "chip_smoke_train_trace.json", top_n=20)
    record["train"] = result
    del model, state
    torch.cuda.empty_cache()
    return launches


def train_card_against_cpu(record: dict) -> None:
    """Phase 8: one fp32 loss and backward at full width and depth, 2 clips,
    drop rates 0, on the card (kernels) and on the CPU (plain versions)."""
    import torch

    from sensorium_tpu_torch.engine.model import MouseModel

    name, params = FLAGSHIP_NN_MODULE
    argus = {**FLAGSHIP_TRAIN_ARGUS,
             "nn_module": (name, {**params, "dtype": "float32", "drop_rate": 0.0, "drop_path_rate": 0.0})}
    batch = synthetic_batch(2)
    out = {}
    for device in ("cuda", "cpu"):
        start = time.perf_counter()
        model = MouseModel(argus, device=device)
        model.build_state(seed=SEED)
        loss = float(model.train_step(batch))
        grads = {k: p.grad.detach().cpu() for k, p in model.state.model.named_parameters()}
        out[device] = (loss, grads)
        print(f"train card vs cpu: {device} loss {loss:.7g} in {time.perf_counter() - start:.1f} s", flush=True)
        del model
    (loss_card, grads_card), (loss_cpu, grads_cpu) = out["cuda"], out["cpu"]
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    largest = max(g.abs().max().item() for g in grads_cpu.values())
    ratios = {}
    for key, g in grads_cpu.items():
        bound = max(TRAIN_GRAD_REL_TOL * g.abs().max().item(), TRAIN_GRAD_FLOOR * largest)
        ratio = (grads_card[key] - g).abs().max().item() / bound
        ratios[key] = ratio if math.isfinite(ratio) else math.inf
    worst_name = max(ratios, key=ratios.get)
    worst = ratios[worst_name]
    result = {"loss_card": loss_card, "loss_cpu": loss_cpu, "loss_relative": loss_rel,
              "largest_gradient": largest, "worst_gradient_over_bound": worst, "worst_tensor": worst_name,
              "tensors": len(grads_cpu)}
    record["train_card_vs_cpu"] = result
    print(f"train card vs cpu: fp32, 2 clips, loss relative difference {loss_rel:.3g} (tolerance {TRAIN_LOSS_RTOL}); "
          f"worst gradient at {worst:.3g} of its bound ({worst_name}) over {len(grads_cpu)} tensors", flush=True)
    if not loss_rel <= TRAIN_LOSS_RTOL:
        fail(f"train: card and CPU losses differ by {loss_rel} relative")
    if not worst <= 1.0:
        fail(f"train: the gradient of {worst_name} differs beyond its bound ({worst} x)")


def fused_cases() -> list[dict]:
    """Phase 9's shapes: every BN -> SiLU -> spatial dw of a flagship chunk
    forward, then those of ``dwbench`` (phase 10) that the model does not
    run, then ragged ones, with and without dead channels."""
    from sensorium_tpu_torch.tools import dwbench

    cases = [dict(s, batch=(CHUNK, FRAMES), dead=False) for s in flagship_kernel_shapes()
             if s["kernel"] == "dw_spatial_fwd"]
    seen = {(c["batch"], c["hw"], c["c"], c["stride"], c["k"]) for c in cases}
    for _, (b, t, h, w, c, stride) in dwbench.SHAPES:
        if ((b, t), (h, w), c, stride, dwbench.K) not in seen:
            cases.append({"hw": (h, w), "c": c, "stride": stride, "k": dwbench.K, "blocks": [], "batch": (b, t),
                          "dead": False})
    for stride in (1, 2):
        for k in (3, 5):
            for dead in (False, True):
                cases.append({"hw": (9, 11), "c": 24, "stride": stride, "k": k, "blocks": [], "batch": (2, 3),
                              "dead": dead})
    # The edges of the kernel's tiling, as phase 3 gives the spatial forward's.
    edges = [((33, 17), 24, (3, 5)), ((7, 5), 24, (3, 5)), ((2, 70), 24, (3,)), ((70, 3), 24, (3,)),
             ((1, 1), 24, (3,)), ((9, 11), 20, (3,)), ((9, 11), 22, (3,)), ((10, 12), 264, (3,))]
    for hw, c, ks in edges:
        for k in ks:
            for stride in (1, 2):
                cases.append({"hw": hw, "c": c, "stride": stride, "k": k, "blocks": [], "batch": (2, 3),
                              "dead": True})
    for hw, c, k, stride in (((7, 5), 24, 3, 1), ((4, 4), 22, 3, 2), ((1, 1), 8, 5, 1)):
        cases.append({"hw": hw, "c": c, "stride": stride, "k": k, "blocks": [], "batch": (64, 128), "dead": True})
    return cases


def check_fused_kernel(peaks: tuple[float, float]) -> list[dict]:
    """Phase 9: the fused BN-apply + SiLU + depthwise kernel against its plain version, timed."""
    import torch

    from sensorium_tpu_torch.ops import dw_kernels
    from sensorium_tpu_torch.tools import dwbench

    name = "fused_bn_silu_dw_spatial"
    bytes_per_s, ops_per_s = peaks
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for case in fused_cases():
        for dtype in (torch.bfloat16, torch.float32):
            b, t = case["batch"]
            h, w = case["hw"]
            c, k, s = case["c"], case["k"], case["stride"]
            x = torch.randn(b, t, h, w, c, device="cuda", generator=gen).to(dtype)
            scale = 1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)
            shift = 0.2 * torch.randn(c, device="cuda", generator=gen)
            if case["dead"]:
                scale[c // 2 :] = 0.0
                shift[c // 2 :] = 1.0
            wt = (torch.randn(k, k, c, device="cuda", generator=gen) / k).to(dtype)
            run = lambda: dw_kernels.fused_bn_silu_dw_spatial(x, scale, shift, wt, s)  # noqa: E731
            plain = lambda: dw_kernels.fused_bn_silu_dw_spatial_plain(x, scale, shift, wt, s)  # noqa: E731
            chain3d = lambda: dwbench.chain(x, scale, shift, wt, s)  # noqa: E731
            chain2d = lambda: dwbench.chain2d(x, scale, shift, wt, s)  # noqa: E731
            fwd = lambda: dw_kernels.dw_spatial_fwd(x, wt, s)  # noqa: E731

            y = run()
            torch.cuda.synchronize()
            ref = dw_kernels.fused_bn_silu_dw_spatial_plain(x.float(), scale, shift, wt.float(), s)
            if y.shape != ref.shape or y.dtype != dtype:
                fail(f"{name} {case}: {tuple(y.shape)} {y.dtype} vs plain {tuple(ref.shape)}")
            err = (y.float() - ref).abs()
            rtol = BF16_RTOL if dtype == torch.bfloat16 else 0.0
            rerun_equal = torch.equal(y, run())  # one pass, no atomics: a rerun is bitwise equal
            ok = bool(torch.all(err <= ATOL + rtol * ref.abs())) and rerun_equal
            row = {
                "kernel": name,
                "dtype": str(dtype).replace("torch.", ""),
                "shape": [b, t, h, w, c],
                "stride": s,
                "k": k,
                "dead_channels": case["dead"],
                "blocks": case["blocks"],
                "max_abs_err": float(err.max()),
                "rerun_equal": rerun_equal,
                "ok": ok,
            }
            del err, ref
            nbytes = (x.numel() + wt.numel() + y.numel()) * x.element_size() + 2 * c * 4
            # k*k multiply-adds per output; a multiply-add, an exponential, an
            # add and a division per input element.
            ops = 2 * k * k * y.numel() + 5 * x.numel()
            row["bytes"] = nbytes
            row["bytes_ms"], row["ops_ms"] = nbytes / bytes_per_s * 1e3, ops / ops_per_s * 1e3
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row["bound_by"] = "bytes" if row["bytes_ms"] >= row["ops_ms"] else "operations"
            row["ms"] = cuda_ms(run)
            row["plain_ms"] = cuda_ms(plain, reps=3, warmup=1)
            row["chain3d_ms"], row["chain2d_ms"] = cuda_ms(chain3d), cuda_ms(chain2d)
            row["library_ms"] = min(row["chain3d_ms"], row["chain2d_ms"])
            row["fwd_ms"] = cuda_ms(fwd)
            rows.append(row)
            print(
                f"kernel {name} {row['dtype']:<8} {str(row['shape']):<28} s={s} k={k} "
                f"dead={case['dead']} blocks={row['blocks']} err={row['max_abs_err']:.3g} ok={ok} "
                f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} chain3d_ms={row['chain3d_ms']:.4f} "
                f"chain2d_ms={row['chain2d_ms']:.4f} fwd_ms={row['fwd_ms']:.4f} "
                f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}, {nbytes / 1e9:.3f} GB)",
                flush=True,
            )
            del x, wt, y
            torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} fused kernel checks disagree with the plain version: {bad}")
    return rows


def bn_sum_terms(x, dy, stats, act: bool):
    """The backward's two sums over rows (sum g, sum g * xhat) as their terms'
    magnitudes, |g| and |g * xhat| summed, and exactly, in float64: g is dy
    through SiLU's backward at the rounded BN output, as the kernels take it,
    and xhat (x - mean) * inv_std. Chunks of rows keep float64 in bounds."""
    import torch

    step = max(1, (1 << 26) // x.shape[1])
    terms = torch.zeros(2, x.shape[1], dtype=torch.float64, device=x.device)
    exact = torch.zeros_like(terms)
    for i in range(0, x.shape[0], step):
        xr, dyr = x[i : i + step], dy[i : i + step]
        z = torch.addcmul(stats[4], xr.float(), stats[3]).to(x.dtype)
        g = (torch.ops.aten.silu_backward(dyr, z) if act else dyr).double()
        gx = g * ((xr.double() - stats[0].double()) * stats[2].double())
        terms += torch.stack([g.abs().sum(0), gx.abs().sum(0)])
        exact += torch.stack([g.sum(0), gx.sum(0)])
    return terms, exact


def check_bn_kernels(peaks: tuple[float, float]) -> dict:
    """Phase 9b: the BN kernels at every BN of a flagship train step and chunk
    forward, against their plain versions, timed beside ``F.batch_norm`` +
    ``F.silu`` and the byte bound; returns the per-call rows and the sums."""
    import torch
    import torch.nn.functional as F

    from sensorium_tpu_torch.ops import bn_kernels

    bytes_per_s, _ = peaks
    params = FLAGSHIP_NN_MODULE[1]
    calls = flagship_bn_calls(CHUNK, FRAMES)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows, seen = [], {}
    for call in calls:
        key = (call["rows"], call["c"], call["act"], call["strided"])
        if key in seen:
            seen[key]["calls"].append(call["name"])
            continue
        r, c, act = call["rows"], call["c"], call["act"]
        # A strided shortcut: every other row of a tensor twice as tall (the wrapper copies it, as in the model).
        base = torch.randn(r * (2 if call["strided"] else 1), c, device="cuda", generator=gen)
        spread = 0.5 + torch.rand(c, device="cuda", generator=gen)
        offset = 2 * torch.randn(c, device="cuda", generator=gen)
        x = (base * spread + offset).to(torch.bfloat16)[:: 2 if call["strided"] else 1]
        del base
        dy = torch.randn(r, c, device="cuda", generator=gen).to(torch.bfloat16)
        shift = offset + 0.3 * torch.randn(c, device="cuda", generator=gen)
        scale = 1 + 0.1 * torch.randn(c, device="cuda", generator=gen)
        bias = 0.1 * torch.randn(c, device="cuda", generator=gen)
        mean, var = offset.clone(), spread.square()
        xc = x.contiguous()

        def train_fwd():
            return bn_kernels.bn_act_apply(x.contiguous(), bn_kernels.bn_stats(x.contiguous(), shift, scale, bias),
                                           act)

        stats = bn_kernels.bn_stats(xc, shift, scale, bias)

        def train_bwd():
            sums = bn_kernels.bn_act_grad(xc, dy, stats, act)
            return bn_kernels.bn_act_dx(xc, dy, stats, sums, scale, r, act)

        def plain_fwd():
            return bn_kernels.bn_act_apply_plain(x, bn_kernels.bn_stats_plain(x, shift, scale, bias, None, None, 1e-5),
                                                 act)

        def plain_bwd():
            sums = bn_kernels.bn_act_grad_plain(xc, dy, stats, act)
            return bn_kernels.bn_act_dx_plain(xc, dy, stats, sums, scale, r, act)

        def library_eval():
            y = F.batch_norm(x, mean, var, scale, bias, training=False)
            return F.silu(y) if act else y

        lib_x = xc.clone().requires_grad_(True)
        lib_scale, lib_bias = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
        lib_mean, lib_var = mean.clone(), var.clone()  # F.batch_norm moves them in place

        def library_train():
            y = F.batch_norm(lib_x, lib_mean, lib_var, lib_scale, lib_bias, training=True)
            if act:
                y = F.silu(y)
            return torch.autograd.grad(y, (lib_x, lib_scale, lib_bias), dy)

        # Correctness: the forward (statistics and y), the backward's sums and dx, and the eval apply.
        y, y_plain = train_fwd(), plain_fwd()
        stats_plain = bn_kernels.bn_stats_plain(xc, shift, scale, bias, None, None, 1e-5)
        z = torch.addcmul(stats[4], xc.float(), stats[3]).to(torch.bfloat16).float()
        ref = bn_kernels.bn_act_apply_plain(xc, stats, act).float()
        y_ok = bool(((y.float() - ref).abs() <= BF16_RTOL * (ref.abs() + (1.1 * z.abs() if act else 0)) + ATOL).all())
        std = stats_plain[1].sqrt()
        stats_ok = bool(((stats[0] - stats_plain[0]).abs() <= 1e-4 * (stats_plain[0].abs() + std)).all()
                        and ((stats[1] - stats_plain[1]).abs() <= 1e-4 * stats_plain[1]).all())
        sums = bn_kernels.bn_act_grad(xc, dy, stats, act)
        sums_plain = bn_kernels.bn_act_grad_plain(xc, dy, stats, act)
        terms, exact = bn_sum_terms(xc, dy, stats, act)
        floor = 1e-6 / BN_SUM_RTOL  # 1e-6 absolute, as the card tests
        sums_err = float(((sums - sums_plain).abs() / (terms + floor)).max())
        witness = None
        if call["name"] in BN_SUM_WITNESS:
            witness = {"kernel_vs_f64": float(((sums.double() - exact).abs() / (terms + floor)).max()),
                       "plain_vs_f64": float(((sums_plain.double() - exact).abs() / (terms + floor)).max()),
                       "kernel_vs_plain": sums_err,
                       "cancellation": float((terms / (exact.abs() + floor)).max())}
            print(f"kernel bn {call['name']}: backward sums against float64, relative to the terms' magnitudes: "
                  f"kernel {witness['kernel_vs_f64']:.3g}, plain {witness['plain_vs_f64']:.3g}, kernel against "
                  f"plain {sums_err:.3g}; |terms| / |sum| up to {witness['cancellation']:.3g}", flush=True)
        dx = train_bwd()
        dx_plain = bn_kernels.bn_act_dx_plain(xc, dy, stats, sums, scale, r, act).float()
        dx_err = float(((dx.float() - dx_plain).abs() / (dx_plain.abs().max() + ATOL)).max())
        eval_y = bn_kernels.bn_act_eval(x.contiguous(), mean, var, scale, bias, 1e-5, act)
        eval_err = float(((eval_y.float() - library_eval().float()).abs() / (library_eval().float().abs().max()
                                                                             + ATOL)).max())
        rerun_equal = (torch.equal(stats, bn_kernels.bn_stats(xc, shift, scale, bias))
                       and torch.equal(sums, bn_kernels.bn_act_grad(xc, dy, stats, act)) and torch.equal(dx, train_bwd()))
        ok = (y_ok and stats_ok and rerun_equal and sums_err <= BN_SUM_RTOL and dx_err <= 4 * BF16_RTOL
              and eval_err <= 4 * BF16_RTOL)
        del y, y_plain, z, ref, dx, dx_plain, eval_y
        n = r * c * 2  # bytes of one bf16 tensor of the call: x, y, dy or dx
        row = {
            "calls": [call["name"]], "rows": r, "c": c, "act": act, "strided": call["strided"],
            "stats_ok": stats_ok, "y_ok": y_ok, "sums_rel_err": sums_err, "dx_rel_err": dx_err,
            "eval_rel_err_vs_library": eval_err, "rerun_equal": rerun_equal, "ok": ok, "sums_witness": witness,
            "fwd_bound_ms": 3 * n / bytes_per_s * 1e3, "bwd_bound_ms": 5 * n / bytes_per_s * 1e3,
            "eval_bound_ms": 2 * n / bytes_per_s * 1e3,
            "fwd_ms": graph_ms(train_fwd), "bwd_ms": graph_ms(train_bwd),
            "eval_ms": graph_ms(lambda: bn_kernels.bn_act_eval(x.contiguous(), mean, var, scale, bias, 1e-5, act)),
            "plain_fwd_ms": cuda_ms(plain_fwd, reps=3, warmup=1), "plain_bwd_ms": cuda_ms(plain_bwd, reps=3, warmup=1),
            "plain_eval_ms": cuda_ms(lambda: bn_kernels.bn_act_eval_plain(x, mean, var, scale, bias, 1e-5, act),
                                     reps=3, warmup=1),
            "library_train_ms": cuda_ms(library_train), "library_eval_ms": cuda_ms(library_eval),
        }
        seen[key] = row
        rows.append(row)
        print(f"kernel bn {r}x{c} act={act} strided={call['strided']} ok={ok} (stats {stats_ok}, y {y_ok}, sums "
              f"{sums_err:.3g}, dx {dx_err:.3g}, eval vs library {eval_err:.3g}, rerun {rerun_equal}) "
              f"fwd_ms={row['fwd_ms']:.4f} bwd_ms={row['bwd_ms']:.4f} eval_ms={row['eval_ms']:.4f} "
              f"plain fwd/bwd/eval {row['plain_fwd_ms']:.3f}/{row['plain_bwd_ms']:.3f}/{row['plain_eval_ms']:.3f} "
              f"library train/eval {row['library_train_ms']:.4f}/{row['library_eval_ms']:.4f} "
              f"bound fwd/bwd/eval {row['fwd_bound_ms']:.4f}/{row['bwd_bound_ms']:.4f}/{row['eval_bound_ms']:.4f}", flush=True)
        del x, xc, dy, lib_x, stats, sums
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} BN kernel checks disagree with the plain version: {bad}")
    remat = set(params["remat_blocks"])
    step_forwards = {c["name"]: 1 + (c["block"] in remat) for c in calls}

    def total(field: str, per_call) -> float:
        return sum(row[field] * sum(per_call(name) for name in row["calls"]) for row in rows)

    step = {
        "ms": total("fwd_ms", step_forwards.get) + total("bwd_ms", lambda _: 1),
        "bound_ms": total("fwd_bound_ms", step_forwards.get) + total("bwd_bound_ms", lambda _: 1),
        "plain_ms": total("plain_fwd_ms", step_forwards.get) + total("plain_bwd_ms", lambda _: 1),
        "library_ms": total("library_train_ms", lambda _: 1),
    }
    # A chunk forward's BN passes: each block's pw_bn and spatial_bn run inside its depthwise convs (phase 3b).
    served = lambda name: 0 if name.endswith((".pw_bn", ".spatial_bn")) else 1  # noqa: E731
    chunk = {"ms": total("eval_ms", served), "bound_ms": total("eval_bound_ms", served),
             "plain_ms": total("plain_eval_ms", served), "library_ms": total("library_eval_ms", served)}
    for label, part in (("train step", step), ("chunk forward", chunk)):
        print(f"kernel bn: per flagship {label}: {part['ms']:.3f} ms against a byte bound of {part['bound_ms']:.3f} "
              f"ms ({100 * part['bound_ms'] / part['ms']:.1f}%); plain {part['plain_ms']:.2f} ms, "
              f"F.batch_norm + F.silu {part['library_ms']:.3f} ms", flush=True)
    return {"rows": rows, "step": step, "chunk": chunk}


def run_dwbench(record: dict) -> dict:
    """Phase 10: the port's dwbench at its shapes, the fused kernel's launches counted."""
    import torch

    from sensorium_tpu_torch.ops import dw_kernels
    from sensorium_tpu_torch.tools import dwbench

    name = "fused_bn_silu_dw_spatial"
    for key in dw_kernels.LAUNCHES:
        dw_kernels.LAUNCHES[key] = 0
    start = time.perf_counter()
    records = dwbench.run("cuda", iters=DWBENCH_ITERS, seed=SEED,
                          emit=lambda line: print(f"dwbench: {line}", flush=True))
    torch.cuda.synchronize()
    launches = dict(dw_kernels.LAUNCHES)
    elapsed = time.perf_counter() - start
    record["dwbench"] = {"iters": DWBENCH_ITERS, "seconds": elapsed, "records": records, "launches": launches}
    bad = dwbench.failed(records)
    if bad:
        fail(f"dwbench: {len(bad)} impls failed or disagreed: {bad}")
    # Per spatial shape: a warm-up call, the timed calls and the comparison with pallas.
    expected = len(dwbench.SHAPES) * (DWBENCH_ITERS + 2)
    if launches[name] != expected:
        fail(f"dwbench: {name} launched {launches[name]} times, expected {expected}")
    print(f"dwbench: {len(records)} (shape, impl) timings in {elapsed:.1f} s; launches {launches}", flush=True)
    return launches


def write_fit_dataset(root: Path) -> int:
    """The on-disk layout of the dataset (``<root>/<mouse>/{data,meta}``) at
    real widths, from the seed: FIT_TRIALS labeled trials a mouse, and for
    each new mouse one unlabeled trial of FIT_UNLABELED_SPLIT (phase 14);
    returns the bytes written."""
    import numpy as np

    rng = np.random.default_rng(SEED + 4)
    total = 0
    for mouse, neurons in zip(constants.mice, constants.num_neurons):
        mdir = root / mouse
        for sub in ("data/videos", "data/behavior", "data/pupil_center", "data/responses", "meta/trials",
                    "meta/neurons"):
            (mdir / sub).mkdir(parents=True, exist_ok=True)
        unlabeled = [FIT_UNLABELED_SPLIT] if mouse in constants.new_mice else []
        arrays = {
            "meta/trials/tiers.npy": np.array(["train"] * FIT_TRIALS + unlabeled),
            "meta/neurons/unit_ids.npy": np.arange(1, neurons + 1, dtype=np.int64),
            "meta/neurons/cell_motor_coordinates.npy": rng.uniform(0, 100, (neurons, 3)).astype(np.float32),
        }
        for trial in range(FIT_TRIALS):
            arrays[f"data/videos/{trial}.npy"] = rng.uniform(0, 255, (*FIT_VIDEO, TRIAL_LENGTH)).astype(np.float32)
            arrays[f"data/behavior/{trial}.npy"] = rng.uniform(0, 5, (2, TRIAL_LENGTH)).astype(np.float32)
            arrays[f"data/pupil_center/{trial}.npy"] = rng.uniform(50, 200, (2, TRIAL_LENGTH)).astype(np.float32)
            arrays[f"data/responses/{trial}.npy"] = rng.gamma(1.5, 1.0, (neurons, TRIAL_LENGTH)).astype(np.float32)
        for trial in range(FIT_TRIALS, FIT_TRIALS + len(unlabeled)):
            arrays[f"data/videos/{trial}.npy"] = rng.uniform(0, 255, (*FIT_VIDEO, TRIAL_LENGTH)).astype(np.float32)
            arrays[f"data/behavior/{trial}.npy"] = rng.uniform(0, 5, (2, TRIAL_LENGTH)).astype(np.float32)
            arrays[f"data/pupil_center/{trial}.npy"] = rng.uniform(50, 200, (2, TRIAL_LENGTH)).astype(np.float32)
        for name, array in arrays.items():
            np.save(mdir / name, array)
            total += array.nbytes
    return total


class TimedLoader:
    """A loader wrapped for phase 11: per pass, the seconds spent blocked in
    ``next()`` and (with ``sync``) the span until the card has finished the
    last batch's work."""

    def __init__(self, loader, sync: bool):
        self.loader = loader
        self.sync = sync
        self.passes: list[dict] = []

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        import torch

        record = {"batches": 0, "wait_seconds": 0.0}
        start = time.perf_counter()
        batches = iter(self.loader)
        while True:
            before = time.perf_counter()
            batch = next(batches, None)
            record["wait_seconds"] += time.perf_counter() - before
            if batch is None:
                break
            record["batches"] += 1
            yield batch
        if self.sync:
            torch.cuda.synchronize()
        record["seconds"] = time.perf_counter() - start
        self.passes.append(record)


def fit(record: dict, out_dir: Path) -> Path:
    """Phase 11: the flagship fit loop fed from disk; returns the dataset's
    root, which phases 14 and 15 read too."""
    import csv
    import os

    import numpy as np
    import torch

    from sensorium_tpu_torch.data import mouse_data, native
    from sensorium_tpu_torch.data.datasets import TrainMiceDataset, ValMiceDataset
    from sensorium_tpu_torch.data.indexes import WindowIndexer
    from sensorium_tpu_torch.data.inputs import get_inputs_processor
    from sensorium_tpu_torch.data.loader import MiceDataLoader
    from sensorium_tpu_torch.data.mixers import CutMix
    from sensorium_tpu_torch.data.responses import get_responses_processor
    from sensorium_tpu_torch.engine.callbacks import LoggingToCSV, LoggingToJSONL, Timer
    from sensorium_tpu_torch.engine.metrics import CorrelationMetric
    from sensorium_tpu_torch.engine.model import MouseModel
    from sensorium_tpu_torch.ops import dw_kernels

    root = out_dir / "fit_data"
    start = time.perf_counter()
    nbytes = write_fit_dataset(root)
    write_s = time.perf_counter() - start
    os.environ["SENSORIUM_FOLD_ASSIGNMENT"] = "trial"
    constants.sensorium_dir = root
    mouse_data.get_folds_tiers.cache_clear()
    stack = FLAGSHIP_ARGUS["frame_stack"]
    processors = (WindowIndexer(stack["size"], stack["step"], stack["position"]),
                  get_inputs_processor(*FLAGSHIP_ARGUS["inputs_processor"]),
                  get_responses_processor(*FLAGSHIP_ARGUS["responses_processor"]))
    train_set = TrainMiceDataset([mouse_data.get_mouse_data(m, ["fold_1", "fold_2"]) for m in constants.mice],
                                 *processors, mouse_epoch_size=-(-FIT_STEPS * TRAIN_BATCH // constants.num_mice),
                                 mixer=CutMix(alpha=1.0, prob=0.5), seed=SEED)
    val_set = ValMiceDataset([mouse_data.get_mouse_data(m, ["fold_0"]) for m in constants.mice], *processors)
    train_loader = TimedLoader(MiceDataLoader(train_set, TRAIN_BATCH, shuffle=True, seed=SEED,
                                              num_threads=FIT_THREADS, drop_last=True), sync=True)
    val_loader = TimedLoader(MiceDataLoader(val_set, TRAIN_BATCH, num_threads=FIT_THREADS), sync=False)
    if len(train_loader) != FIT_STEPS:
        fail(f"fit: {len(train_loader)} train batches per epoch, expected {FIT_STEPS}")
    if not native.available():
        fail("fit: the native host library is not in use")
    print(f"fit: wrote {nbytes / 1e9:.3f} GB in {write_s:.1f} s under {root}; {len(train_set)} train samples, "
          f"{len(val_set)} val windows ({len(val_loader)} batches); native host library {native.library_path().name}",
          flush=True)

    model = MouseModel(FLAGSHIP_TRAIN_ARGUS, device="cuda")
    model.set_ema(EMA_DECAY)
    model.build_state(seed=SEED, learning_rate=get_lr(3e-4, TRAIN_BATCH))
    log_dir = out_dir / "fit"
    logs = (LoggingToCSV(log_dir / "log.csv", append=False), LoggingToJSONL(log_dir / "log.jsonl", append=False))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in dw_kernels.LAUNCHES:
        dw_kernels.LAUNCHES[key] = 0
    start = time.perf_counter()
    model.fit(train_loader, val_loader=val_loader, num_epochs=FIT_EPOCHS, callbacks=[Timer(), *logs],
              metrics=[CorrelationMetric()])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = dict(dw_kernels.LAUNCHES)

    with open(log_dir / "log.csv", newline="") as handle:
        rows = list(csv.DictReader(handle))
    records = [json.loads(line) for line in (log_dir / "log.jsonl").read_text().splitlines()]
    waited = sum(p["wait_seconds"] for p in train_loader.passes + val_loader.passes)
    epochs = []
    for epoch, (rec, train_pass) in enumerate(zip(records, train_loader.passes)):
        epochs.append({
            "epoch": epoch,
            "train_loss": rec.get("train_loss"),
            "val_loss": rec.get("val_loss"),
            "val_corr": rec.get("val_corr"),
            "epoch_time": rec.get("epoch_time"),
            "train_seconds": train_pass["seconds"],
            "train_loader_wait_seconds": train_pass["wait_seconds"],
            "clips_per_second_from_disk": train_pass["batches"] * TRAIN_BATCH / train_pass["seconds"],
        })
    result = {
        "dataset_bytes": nbytes,
        "train_samples": len(train_set),
        "val_windows": len(val_set),
        "wall_seconds": wall,
        "loader_wait_seconds": waited,
        "loader_wait_share": waited / wall,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "epochs": epochs,
        "launches": launches,
    }
    record["fit"] = result
    for e in epochs:
        print(f"fit: epoch {e['epoch']}: train_loss {e['train_loss']:.6g}, val_loss {e['val_loss']:.6g}, "
              f"val_corr {e['val_corr']:.6g}; {FIT_STEPS} steps in {e['train_seconds']:.3f} s = "
              f"{e['clips_per_second_from_disk']:.1f} clips/s fed from disk, loader wait "
              f"{e['train_loader_wait_seconds']:.3f} s", flush=True)
    synthetic = record["train"]["clips_per_second"]
    print(f"fit: {FIT_EPOCHS} epochs in {wall:.2f} s, waiting on the loader {waited:.3f} s "
          f"({result['loader_wait_share']:.1%} of the wall clock); clips/s fed from disk (epoch 1) "
          f"{epochs[-1]['clips_per_second_from_disk']:.1f} against {synthetic:.1f} on one synthetic batch (phase 7); "
          f"peak memory {result['peak_memory_gb']:.2f} GB", flush=True)

    values = [v for e in epochs for v in (e["train_loss"], e["val_loss"], e["val_corr"])]
    if len(rows) != FIT_EPOCHS or len(records) != FIT_EPOCHS:
        fail(f"fit: the logs hold {len(rows)} CSV rows and {len(records)} JSONL records, expected {FIT_EPOCHS}")
    if not all(v is not None and np.isfinite(v) for v in values):
        fail(f"fit: a loss or val_corr is not finite: {epochs}")
    val_forwards = FIT_EPOCHS * len(val_loader)
    steps = FIT_EPOCHS * FIT_STEPS
    blocks = len(FLAGSHIP_NN_MODULE[1]["core_features"])
    expected = {key: count * steps for key, count in expected_train_launches().items()}
    expected["fused_bn_silu_dw_spatial"] = 0  # off the model's path
    expected["dw_spatial_fwd_bn"] = expected["dw_temporal_fwd_bn"] = blocks * val_forwards  # the eval forwards
    if launches != expected:
        fail(f"fit: launches {launches} over {steps} steps and {val_forwards} val forwards, expected {expected}")
    del model
    torch.cuda.empty_cache()
    return root


def reset_launches() -> None:
    from sensorium_tpu_torch.ops import bn_kernels, dw_kernels

    for counter in (dw_kernels.LAUNCHES, bn_kernels.LAUNCHES):
        for key in counter:
            counter[key] = 0


def check_forward_launches(phase: str, launches: dict, forwards: int) -> None:
    """9 spatial and 9 temporal prologue conv launches a chunk forward (each
    block's pw_bn and spatial_bn run inside them), nothing else."""
    blocks = len(FLAGSHIP_NN_MODULE[1]["core_features"])
    expected = {key: 0 for key in launches}
    expected.update(dw_spatial_fwd_bn=blocks * forwards, dw_temporal_fwd_bn=blocks * forwards)
    if launches != expected:
        fail(f"{phase}: launches {launches} for {forwards} chunk forwards, expected {expected}")


def expected_bn_launches(forwards: int = 0, steps: int = 0) -> dict:
    """BN kernel launches of ``forwards`` flagship chunk forwards (one apply
    a BN, but each block's pw_bn and spatial_bn, which run inside its
    depthwise convs) and ``steps`` train steps (statistics, finalize and
    apply a BN forward, block 1's rerun included; sums, their slab sum and dx
    a BN backward), from the config."""
    params = FLAGSHIP_NN_MODULE[1]
    calls = flagship_bn_calls(CHUNK, FRAMES)
    bns, act = len(calls), sum(c["act"] for c in calls)
    folded = 2 * len(params["core_features"])  # with SiLU
    rerun = [c for c in calls if c["block"] in params["remat_blocks"]]
    forward_bns, forward_act = bns + len(rerun), act + sum(c["act"] for c in rerun)
    return {"bn_stats": steps * forward_bns, "bn_finalize": steps * forward_bns,
            "bn_apply": forwards * (bns - act) + steps * (forward_bns - forward_act),
            "bn_silu_apply": forwards * (act - folded) + steps * forward_act, "bn_grad": steps * (bns - act),
            "bn_silu_grad": steps * act, "bn_grad_sum": steps * bns, "bn_dx": steps * (bns - act),
            "bn_silu_dx": steps * act}


def check_bn_launches(phase: str, launches: dict, expected: dict) -> None:
    """The BN kernels' launches, kind by kind, beside ``check_forward_launches``."""
    if launches != expected:
        fail(f"{phase}: BN launches {launches}, expected {expected}")


def gb(path: Path) -> float:
    return path.stat().st_size / 1e9


def import_proof(record: dict, work: Path) -> dict:
    """Phase 12: the reference's own sliding-window output of a flagship trial,
    through a reference-format .pth, ``cli/import_torch`` and ``Predictor(ckpt)``."""
    import importlib.util

    import numpy as np
    import torch

    from sensorium_tpu_torch.cli.import_torch import convert_checkpoint
    from sensorium_tpu_torch.infer.predictor import Predictor
    from sensorium_tpu_torch.ops import dw_kernels

    if not IMPORT_GOLDEN.exists() or not PROCEDURAL_WEIGHTS.exists():
        fail(f"import proof: {IMPORT_GOLDEN} or {PROCEDURAL_WEIGHTS} is missing")
    golden = np.load(IMPORT_GOLDEN)
    spec = importlib.util.spec_from_file_location("procedural_weights", PROCEDURAL_WEIGHTS)
    procedural = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(procedural)

    start = time.perf_counter()
    state = procedural.fill_state(json.loads(str(golden["meta_json"])))
    # The reference's config carries neither the compute dtype nor the remat choice.
    nn_kwargs = {k: v for k, v in FLAGSHIP_NN_MODULE[1].items() if k not in ("dtype", "remat_blocks")}
    argus = {**FLAGSHIP_TRAIN_ARGUS, "nn_module": ("dwiseneuro", nn_kwargs), "device": "cuda:0", "amp": True}
    pth, ckpt = work / "model-017-0.290500.pth", work / "model-017-0.290500.ckpt"
    torch.save({"model_name": "MouseModel", "params": argus,
                "nn_state_dict": {key: torch.from_numpy(value) for key, value in state.items()}}, pth)
    values = sum(v.size for v in state.values())
    del state
    made_s = time.perf_counter() - start
    start = time.perf_counter()
    convert_checkpoint(pth, ckpt, dtype="float32")
    convert_s = time.perf_counter() - start
    pth_gb = gb(pth)
    pth.unlink()

    start = time.perf_counter()
    predictor = Predictor(ckpt, chunk_size=CHUNK, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - start
    length = golden["video"].shape[-1]
    forwards = math.ceil(len(predictor.indexes_generator.valid_anchors(length)) / CHUNK)
    reset_launches()
    start = time.perf_counter()
    prediction = predictor.predict_trial(golden["video"], golden["behavior"], golden["pupil_center"],
                                         mouse_index=int(golden["mouse_index"]))
    predict_s = time.perf_counter() - start
    launches = dict(dw_kernels.LAUNCHES)
    expected = golden["prediction"]
    scale = float(np.max(np.abs(expected)))
    if prediction.shape != expected.shape:
        fail(f"import proof: prediction {prediction.shape}, the reference's {expected.shape}")
    diff = np.abs(prediction.astype(np.float64) - expected)
    max_abs = float(diff.max())
    max_rel = max_abs / scale  # relative to the largest value
    # Elementwise against the tolerance, as np.testing.assert_allclose holds it.
    worst = float(np.max(diff / (IMPORT_ATOL_SCALE * scale + IMPORT_RTOL * np.abs(expected))))
    within = bool(np.isfinite(worst) and worst <= 1.0)
    result = {"torch_values": values, "pth_gb": pth_gb, "ckpt_gb": gb(ckpt), "make_pth_seconds": made_s,
              "convert_seconds": convert_s, "predictor_load_seconds": load_s, "predict_seconds": predict_s,
              "shape": list(prediction.shape), "max_abs_err": max_abs, "max_rel_err": max_rel,
              "worst_over_tolerance": worst, "max_abs_expected": scale, "launches": launches}
    record["import_proof"] = result
    print(f"import proof: {values / 1e6:.1f}M reference values ({pth_gb:.3f} GB .pth made in {made_s:.1f} s), "
          f"converted in {convert_s:.1f} s to a {result['ckpt_gb']:.3f} GB checkpoint, Predictor(ckpt) loaded in "
          f"{load_s:.1f} s; fp32 prediction {tuple(prediction.shape)} of the golden {length}-frame trial against "
          f"the reference's: max abs err {max_abs:.4g}, relative to max |expected| {scale:.4g}: {max_rel:.3g}; "
          f"worst element at {worst:.3g} of its tolerance (rtol {IMPORT_RTOL}, atol {IMPORT_ATOL_SCALE} x max)",
          flush=True)
    if not within:
        fail(f"import proof: the prediction disagrees with the reference's (max abs {max_abs}, rel {max_rel})")
    check_forward_launches("import proof", launches, forwards)
    ckpt.unlink()
    del predictor
    torch.cuda.empty_cache()
    return launches


def checkpoints(record: dict, work: Path) -> dict:
    """Phase 13: checkpoints and resume of the flagship MouseModel."""
    import torch

    from sensorium_tpu_torch.engine import checkpoint as ckpt
    from sensorium_tpu_torch.engine.callbacks import Callback
    from sensorium_tpu_torch.engine.model import MouseModel, load_model
    from sensorium_tpu_torch.engine.preemption import PreemptionHandler, TrainingPreempted
    from sensorium_tpu_torch.ops import dw_kernels

    class PreemptAfterFirstEpoch(Callback):
        def __init__(self, handler):
            self.handler = handler

        def epoch_complete(self, state) -> None:
            if state.global_epoch == 0:
                self.handler.triggered = True

    def flagship(seed: int) -> MouseModel:
        model = MouseModel(FLAGSHIP_TRAIN_ARGUS, device="cuda")
        model.set_ema(EMA_DECAY)
        model.build_state(seed=seed, learning_rate=get_lr(3e-4, TRAIN_BATCH))
        return model

    def timed(fn) -> float:
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - start

    def unequal(a: dict, b: dict) -> list[str]:
        return [name for name in a if not torch.equal(a[name], b[name])]

    def full_state(model: MouseModel) -> dict:
        state = {f"model.{k}": v for k, v in model.state.model.state_dict().items()}
        state.update({f"ema.{k}": v for k, v in model.state.ema_model.state_dict().items()})
        for index, entry in model.state.optimizer.state_dict()["state"].items():
            state.update({f"optimizer.{index}.{key}": value for key, value in entry.items()})
        state["generator"] = model.state.generator.get_state()
        return state

    batch = synthetic_batch(TRAIN_BATCH)
    reset_launches()
    result: dict = {}
    a = flagship(SEED)
    a.train_step(batch)

    model_ckpt = work / EXPORT_CHECKPOINT
    result["model_save_sync_seconds"] = timed(lambda: a.save(model_ckpt))
    result["model_gb"] = gb(model_ckpt)
    loaded = {}
    result["model_load_seconds"] = timed(lambda: loaded.update(model=load_model(model_ckpt, device="cuda")))
    bad = unequal(a.state.eval_model.state_dict(), loaded["model"].state.model.state_dict())
    del loaded
    if bad:
        fail(f"checkpoints: load_model differs from the saved EMA weights at {bad[:5]}")
    background = work / "background.ckpt"
    result["model_save_background_blocking_seconds"] = timed(lambda: a.save(background, background=True))
    a.train_step(batch)  # updates the EMA in place while the write may be in flight
    result["model_background_flush_seconds"] = timed(ckpt.flush_pending_saves)
    if background.read_bytes() != model_ckpt.read_bytes():
        fail("checkpoints: the background save differs from the sync save of the same weights")
    background.unlink()  # model_ckpt stays for phase 17

    state_ckpt, state_background = work / "train_state.ckpt", work / "train_state_background.ckpt"
    result["state_save_sync_seconds"] = timed(lambda: a.save_train_state(state_ckpt, extra={"epoch": 0}))
    result["state_gb"] = gb(state_ckpt)
    result["state_save_background_blocking_seconds"] = timed(
        lambda: a.save_train_state(state_background, extra={"epoch": 0}, background=True))
    losses_a = [float(a.train_step(batch))]
    result["state_background_flush_seconds"] = timed(ckpt.flush_pending_saves)
    if state_background.read_bytes() != state_ckpt.read_bytes():
        fail("checkpoints: the background train state differs from the sync save of the same state")
    state_background.unlink()
    losses_a.append(float(a.train_step(batch)))

    b = flagship(SEED + 1)
    result["state_load_seconds"] = timed(lambda: b.load_train_state(state_ckpt))
    state_ckpt.unlink()
    losses_b = [float(b.train_step(batch)) for _ in range(2)]
    bad = unequal(full_state(a), full_state(b))
    result.update(losses_uninterrupted=losses_a, losses_resumed=losses_b, resume_unequal_tensors=bad)
    if losses_a != losses_b or bad:
        fail(f"checkpoints: 2 steps after load_train_state differ from the uninterrupted run: losses "
             f"{losses_b} against {losses_a}, tensors {bad[:5]} ({len(bad)})")
    del a
    torch.cuda.empty_cache()

    preempted = work / "preempted.ckpt"
    with PreemptionHandler() as handler:
        try:
            b.fit([batch], num_epochs=2, callbacks=[PreemptAfterFirstEpoch(handler)], preemption=handler,
                  preemption_save_path=preempted)
        except TrainingPreempted:
            result["preempted"] = True
    if not result.get("preempted") or not preempted.exists():
        fail("checkpoints: the preemption signal after epoch 0 did not save the state and raise TrainingPreempted")
    c = flagship(SEED + 2)
    extra = c.load_train_state(preempted)
    preempted.unlink()
    bad = unequal(full_state(b), full_state(c))
    if extra != {"epoch": 0} or c.state.step != b.state.step or bad:
        fail(f"checkpoints: the preemption save restores extra {extra}, step {c.state.step} "
             f"(expected {b.state.step}), unequal tensors {bad[:5]}")
    launches = dict(dw_kernels.LAUNCHES)
    steps = 4 + 2 + 1  # a: 4, b: 2 after the resume and 1 in the preempted fit
    expected = {key: 0 for key in launches}
    expected.update({key: count * steps for key, count in expected_train_launches().items()})
    result["launches"] = launches
    record["checkpoints"] = result
    print(f"checkpoints: model {result['model_gb']:.3f} GB: save {result['model_save_sync_seconds']:.2f} s sync, "
          f"{result['model_save_background_blocking_seconds']:.2f} s blocking in the background (then "
          f"{result['model_background_flush_seconds']:.2f} s to flush after a step), load_model "
          f"{result['model_load_seconds']:.2f} s, bitwise equal; train state {result['state_gb']:.3f} GB: save "
          f"{result['state_save_sync_seconds']:.2f} s sync, {result['state_save_background_blocking_seconds']:.2f} s "
          f"blocking in the background (flush {result['state_background_flush_seconds']:.2f} s), load "
          f"{result['state_load_seconds']:.2f} s; background files equal the sync ones byte for byte", flush=True)
    print(f"checkpoints: resumed from another seed, 2 steps: losses {losses_b} == uninterrupted {losses_a}, "
          f"every parameter, buffer, EMA tensor, moment and the generator bitwise equal; preemption after epoch 0 "
          f"raised TrainingPreempted with the state saved (step {c.state.step}); launches {launches}", flush=True)
    if launches != expected:
        fail(f"checkpoints: launches {launches} over {steps} steps, expected {expected}")
    del b, c
    torch.cuda.empty_cache()
    return launches


def point_data_dir(data_dir: Path) -> None:
    """What ``SENSORIUM_DATA_DIR=data_dir`` gives when the constants are imported."""
    constants.data_dir = data_dir
    constants.sensorium_dir = data_dir / "sensorium_all_2023"
    constants.experiments_dir = data_dir / "experiments"
    constants.predictions_dir = data_dir / "predictions"


def submission_flow(record: dict, fit_root: Path, work: Path) -> dict:
    """Phase 14: ``cli.predict -e smoke -s live_test_main`` over 7 fold
    directories that link one flagship checkpoint (no submission file:
    pandas is not installed on the card's machine)."""
    import numpy as np
    import torch

    from sensorium_tpu_torch.cli.predict import predict_unlabeled_split
    from sensorium_tpu_torch.compat import to_jax_variables
    from sensorium_tpu_torch.data import mouse_data
    from sensorium_tpu_torch.data.indexes import WindowIndexer
    from sensorium_tpu_torch.engine.checkpoint import save_model_checkpoint
    from sensorium_tpu_torch.infer.predictor import Predictor, _load_trial_arrays
    from sensorium_tpu_torch.models.registry import get_nn_module
    from sensorium_tpu_torch.ops import dw_kernels

    data_dir = work / "data"
    data_dir.mkdir()
    (data_dir / "sensorium_all_2023").symlink_to(fit_root.resolve(), target_is_directory=True)
    module = get_nn_module(*FLAGSHIP_NN_MODULE, device="cuda", generator=torch.Generator().manual_seed(SEED + 5))
    checkpoint = work / "model-020-0.300000.ckpt"
    save_model_checkpoint(checkpoint, FLAGSHIP_ARGUS, to_jax_variables(module))
    del module
    for fold in constants.folds_splits:
        fold_dir = data_dir / "experiments" / SUBMISSION_EXPERIMENT / fold
        fold_dir.mkdir(parents=True)
        (fold_dir / checkpoint.name).symlink_to(checkpoint)
    saved = (constants.data_dir, constants.sensorium_dir, constants.experiments_dir, constants.predictions_dir)
    point_data_dir(data_dir)
    mouse_data.get_folds_tiers.cache_clear()

    trials = {m: mouse_data.get_mouse_data(m, [FIT_UNLABELED_SPLIT])["trials"] for m in constants.new_mice}
    count = sum(len(t) for t in trials.values())
    stack = FLAGSHIP_ARGUS["frame_stack"]
    windows = len(WindowIndexer(stack["size"], stack["step"], stack["position"]).valid_anchors(TRIAL_LENGTH))
    folds = len(constants.folds_splits)
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    predict_unlabeled_split(SUBMISSION_EXPERIMENT, FIT_UNLABELED_SPLIT, "new", chunk_size=CHUNK, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = dict(dw_kernels.LAUNCHES)

    start = time.perf_counter()
    reference = Predictor(checkpoint, chunk_size=CHUNK, device="cuda")
    torch.cuda.synchronize()
    reference_load_s = time.perf_counter() - start
    worst, reference_s = 0.0, 0.0
    for mouse, mouse_trials in trials.items():
        for trial_data in mouse_trials:
            path = constants.predictions_dir / SUBMISSION_EXPERIMENT / FIT_UNLABELED_SPLIT / mouse / \
                f"{trial_data['trial_id']}.npy"
            saved_blend = np.load(path)
            arrays = _load_trial_arrays(trial_data)
            start = time.perf_counter()
            expected = reference.predict_trial(*arrays, constants.mouse2index[mouse])
            reference_s += time.perf_counter() - start
            if saved_blend.shape != expected.shape or not np.all(np.isfinite(saved_blend)):
                fail(f"submission flow: {path.name} of {mouse} is {saved_blend.shape}, expected {expected.shape}")
            worst = max(worst, float(np.max(np.abs(saved_blend - expected)) / np.max(np.abs(expected))))
    forwards_per_trial = math.ceil(windows / CHUNK)
    result = {"trials": count, "fold_models": folds, "window_forwards": count * folds * windows,
              "wall_seconds": wall, "trials_per_second": count / wall,
              "windows_per_second": count * folds * windows / wall, "max_rel_err_vs_one_predictor": worst,
              "checkpoint_gb": gb(checkpoint), "one_predictor_load_seconds": reference_load_s,
              "one_predictor_windows_per_second": count * windows / reference_s, "launches": launches}
    record["submission_flow"] = result
    print(f"submission flow: {count} trials x {folds} fold models x {windows} windows = "
          f"{result['window_forwards']} window forwards in {wall:.2f} s (7 checkpoint loads included): "
          f"{result['trials_per_second']:.3f} trials/s, {result['windows_per_second']:.1f} windows/s; one "
          f"Predictor: checkpoint loaded in {reference_load_s:.2f} s, the same trials at "
          f"{result['one_predictor_windows_per_second']:.1f} windows/s (blocking per trial); "
          f"the saved blends against one Predictor: max |diff| / max |expected| {worst:.3g} "
          f"(tolerance {BLEND_REL_TOL}); launches {launches}", flush=True)
    if not worst <= BLEND_REL_TOL:
        fail(f"submission flow: the 7-fold blend differs from one Predictor by {worst} relative")
    check_forward_launches("submission flow", launches, count * folds * forwards_per_trial)
    constants.data_dir, constants.sensorium_dir, constants.experiments_dir, constants.predictions_dir = saved
    mouse_data.get_folds_tiers.cache_clear()
    del reference
    torch.cuda.empty_cache()
    return launches


def write_cli_configs(configs_dir: Path) -> None:
    """The port's configs, and those phases 15 and 18c derive from them:
    the distillation recipe at smoke size with smoke_001's fold as its
    teacher, smoke_001 with CLI_SIGTERM_EPOCH_SIZE clips an epoch, and
    smoke_001 in fp32 with every block rematerialized."""
    configs_dir.mkdir(parents=True)
    for path in sorted(PORT_CONFIGS.glob("*.py")):
        shutil.copy(path, configs_dir / path.name)
    fp32 = {"dtype": "float32", "remat_blocks": tuple(range(9))}
    derived = {  # name: (base, config changes, nn_module changes)
        CLI_DISTILL: ("distillation_001", {"train_epoch_size": 64, "num_epochs": [1, 1],
                                           "distill": {"experiment": CLI_EXPERIMENT, "ratio": 0.36}}, {}),
        CLI_SIGTERM: (CLI_EXPERIMENT, {"train_epoch_size": CLI_SIGTERM_EPOCH_SIZE}, {}),
        CLI_TP_FP32: (CLI_EXPERIMENT, {}, fp32),
    }
    for name, (base, changes, nn_changes) in derived.items():
        (configs_dir / f"{name}.py").write_text(
            "from importlib.machinery import SourceFileLoader\n"
            "from pathlib import Path\n\n"
            f"_path = str(Path(__file__).resolve().parent / {base + '.py'!r})\n"
            f"config = dict(SourceFileLoader({base!r}, _path).load_module().config)\n"
            f"config.update({changes!r})\n"
            "_name, _nn = config['argus_params']['nn_module']\n"
            f"config['argus_params'] = {{**config['argus_params'], 'nn_module': (_name, {{**_nn, **{nn_changes!r}}})}}\n")


class CliClock:
    """Times an in-process ``cli.train`` run: the seconds before its first
    train step and those spent saving and loading train states and models,
    by wrapping the ``MouseModel`` methods while it is entered."""

    TIMED = ("save", "save_train_state", "load_train_state")

    def __init__(self):
        from sensorium_tpu_torch.engine.model import MouseModel

        self.cls = MouseModel
        self.start = 0.0
        self.first_step: float | None = None
        self.steps = 0
        self.checkpoint_seconds = 0.0
        self.resumed_epochs: list[int] = []  # the epoch each load_train_state found
        self._originals = {}

    def __enter__(self):
        from sensorium_tpu_torch.utils.profiling import sync

        def timed(original):
            def wrapper(model, *args, **kwargs):
                sync()
                start = time.perf_counter()
                result = original(model, *args, **kwargs)
                sync()
                self.checkpoint_seconds += time.perf_counter() - start
                if isinstance(result, dict):  # load_train_state's extra
                    self.resumed_epochs.append(int(result["epoch"]))
                return result

            return wrapper

        def train_step(original):
            def wrapper(model, batch, **kwargs):
                if self.first_step is None:
                    self.first_step = time.perf_counter()
                self.steps += 1
                return original(model, batch, **kwargs)

            return wrapper

        self._originals = {name: getattr(self.cls, name) for name in (*self.TIMED, "train_step")}
        for name in self.TIMED:
            setattr(self.cls, name, timed(self._originals[name]))
        self.cls.train_step = train_step(self._originals["train_step"])
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc_info):
        for name, original in self._originals.items():
            setattr(self.cls, name, original)


def read_cli_logs(fold_dir: Path) -> list[dict]:
    path = fold_dir / "log.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()] if path.exists() else []


def cli_log_times(fold_dir: Path) -> dict:
    """The wall-clock times (as ``time.time()``) of the lines of ``log.txt``
    that end an epoch, and of the preemption save's line, if there is one."""
    from datetime import datetime

    times: dict = {"epochs": []}
    for line in (fold_dir / "log.txt").read_text().splitlines():
        if not re.match(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} ", line):
            continue
        stamp = datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f").timestamp()
        if re.search(r" epoch \d+: ", line):
            times["epochs"].append(stamp)
        elif "Preemption signal" in line:
            times["preempted"] = stamp
    return times


def expected_cli_launches(steps: int, val_forwards: int, student: dict, teacher: dict | None) -> dict:
    """The kernel launches of ``steps`` train steps of the ``student``
    nn_module (with its ``teacher``'s eval forward, if any) and of
    ``val_forwards`` eval forwards; an eval forward runs the prologue convs."""
    blocks = len(student["core_features"])
    remat = student["remat_blocks"]
    remat = remat if isinstance(remat, int) else len(remat)
    taught = len(teacher["core_features"]) if teacher is not None else 0
    evals = taught * steps + blocks * val_forwards
    return {"dw_spatial_fwd": (blocks + remat) * steps, "dw_temporal_fwd": (2 * blocks + remat) * steps,
            "dw_spatial_dx": blocks * steps, "dw_spatial_dw": blocks * steps, "dw_temporal_dw": blocks * steps,
            "fused_bn_silu_dw_spatial": 0, "dw_spatial_fwd_bn": evals, "dw_temporal_fwd_bn": evals}


def cli_train_steps(config: dict) -> int:
    """The train steps of an epoch under ``config``."""
    return config["train_epoch_size"] // constants.num_mice * constants.num_mice // config["batch_size"]


def cli_fold_shape(config: dict) -> tuple[int, int]:
    """(train steps, val batches) an epoch of fold 0 under ``config``."""
    from sensorium_tpu_torch.data import mouse_data
    from sensorium_tpu_torch.data.datasets import ValMiceDataset
    from sensorium_tpu_torch.data.indexes import WindowIndexer
    from sensorium_tpu_torch.data.inputs import get_inputs_processor
    from sensorium_tpu_torch.data.responses import get_responses_processor

    params = config["argus_params"]
    steps = cli_train_steps(config)
    val = ValMiceDataset([mouse_data.get_mouse_data(m, ["fold_0"]) for m in constants.mice],
                         WindowIndexer(**params["frame_stack"]), get_inputs_processor(*params["inputs_processor"]),
                         get_responses_processor(*params["responses_processor"]))
    return steps, -(-len(val) // (config["batch_size"] // params.get("iter_size", 1)))


def run_cli_child(command: list[str], env: dict, out_path: Path, until=None) -> tuple[int, float, float, float]:
    """``command`` as a subprocess, its output to ``out_path``. With ``until``
    (a function), SIGTERM is sent once ``until()`` is true; the phase fails
    if the child ends first. Returns the exit code, its start (``time.time()``),
    its wall seconds and when the signal was sent (0 without ``until``)."""
    import signal

    with open(out_path, "w") as out:
        started_at, started = time.time(), time.perf_counter()
        proc = subprocess.Popen(command, env=env, cwd=REPO, stdout=out, stderr=subprocess.STDOUT)
    signalled = 0.0
    try:
        if until is not None:
            while proc.poll() is None and not until():
                if time.perf_counter() - started > CLI_CHILD_TIMEOUT:
                    fail(f"train cli: the signal's condition did not come within {CLI_CHILD_TIMEOUT} s")
                time.sleep(0.05)
            if proc.poll() is not None:
                fail(f"train cli: {command} ended (exit code {proc.returncode}) before the signal:\n"
                     f"{out_path.read_text()[-3000:]}")
            signalled = time.time()
            proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=CLI_CHILD_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return proc.returncode, started_at, time.perf_counter() - started, signalled


def train_cli(record: dict, fit_root: Path, work: Path, device: str = "cuda") -> dict:
    """Phase 15: ``cli.train`` on phase 11's dataset: the smoke_001 fold, its
    resume, a distillation from it, and a SIGTERM in a subprocess, then its
    resume. Returns the smoke fold's launches; the distillation's go to
    ``record["train_cli"]["distill_launches"]``."""
    import gc
    import os
    from importlib.machinery import SourceFileLoader

    import numpy as np
    import torch

    from sensorium_tpu_torch.cli import train
    from sensorium_tpu_torch.data import mouse_data
    from sensorium_tpu_torch.ops import dw_kernels
    from sensorium_tpu_torch.utils.misc import get_best_model_path
    from sensorium_tpu_torch.utils.profiling import sync

    data_dir, configs_dir = work / "train_cli", work / "train_cli_configs"
    data_dir.mkdir()
    (data_dir / "sensorium_all_2023").symlink_to(fit_root.resolve(), target_is_directory=True)
    write_cli_configs(configs_dir)
    saved = (constants.data_dir, constants.sensorium_dir, constants.experiments_dir, constants.predictions_dir,
             constants.configs_dir)
    point_data_dir(data_dir)
    constants.configs_dir = configs_dir
    mouse_data.get_folds_tiers.cache_clear()
    experiments = data_dir / "experiments"
    configs = {name: SourceFileLoader(name, str(configs_dir / f"{name}.py")).load_module().config
               for name in (CLI_EXPERIMENT, CLI_DISTILL, CLI_SIGTERM)}
    argv = ["-f", "0", "--device", device]
    if torch.cuda.device_count() > 1:
        argv.append("--no-mesh")  # this phase is the one-card CLI; phase 16c takes every card
    runs: dict = {}

    def finite(records: list[dict]) -> bool:
        return all(np.isfinite(r[k]) for r in records for k in ("train_loss", "val_loss", "val_corr"))

    def in_process(label: str, experiment: str, *flags: str) -> tuple[dict, CliClock]:
        fold = experiments / experiment / "fold_0"
        before = len(read_cli_logs(fold))
        sync()
        reset_launches()
        with CliClock() as clock:
            train.main(["-e", experiment, *argv, *flags])
        sync()
        wall = time.perf_counter() - clock.start
        new = read_cli_logs(fold)[before:]
        epochs_seconds = sum(r["epoch_time"] for r in new)
        run = {"wall_seconds": wall, "steps": clock.steps, "checkpoint_seconds": clock.checkpoint_seconds,
               "seconds_before_first_step": None if clock.first_step is None else clock.first_step - clock.start,
               "steps_per_second": clock.steps / epochs_seconds if epochs_seconds else 0.0,
               "epochs": new, "launches": dict(dw_kernels.LAUNCHES)}
        runs[label] = run
        gc.collect()
        torch.cuda.empty_cache()
        steps = (f"{clock.steps} steps at {run['steps_per_second']:.3f} steps/s over its epochs' time (validation "
                 f"included), {run['seconds_before_first_step']:.2f} s before the first step" if clock.steps
                 else "no step")
        print(f"train cli: {label}: {wall:.2f} s wall, {steps}, {clock.checkpoint_seconds:.2f} s saving and "
              f"loading checkpoints; launches {run['launches']}", flush=True)
        return run, clock

    # 1. The smoke fold.
    smoke_steps, val_batches = cli_fold_shape(configs[CLI_EXPERIMENT])
    nn_params = configs[CLI_EXPERIMENT]["argus_params"]["nn_module"][1]
    fold = experiments / CLI_EXPERIMENT / "fold_0"
    smoke, _ = in_process("smoke_001 fold 0", CLI_EXPERIMENT)
    files = sorted(p.name for p in fold.iterdir())
    if [(r["stage"], r["epoch"]) for r in smoke["epochs"]] != [("warmup", 0), ("train", 1)] or not finite(
            smoke["epochs"]):
        fail(f"train cli: smoke_001 logged {smoke['epochs']}")
    if (len([f for f in files if re.fullmatch(r"model-001-.*\.ckpt", f)]) != 1
            or not {"log.txt", "log.csv", "log.jsonl", "train_state.ckpt"} <= set(files)
            or not (fold.parent / "config.json").exists()):
        fail(f"train cli: the smoke_001 fold holds {files}")
    expected = expected_cli_launches(2 * smoke_steps, 2 * val_batches, nn_params, None)
    if smoke["launches"] != expected:
        fail(f"train cli: smoke_001 launched {smoke['launches']}, expected {expected} "
             f"({2 * smoke_steps} steps, {2 * val_batches} val forwards)")

    # 2. --resume on the finished fold.
    # It prints "Resumed from epoch 2" and that both stages are complete; here: the state read, no step taken.
    resumed, clock = in_process("smoke_001 --resume", CLI_EXPERIMENT, "--resume")
    if clock.resumed_epochs != [1] or resumed["steps"] or len(read_cli_logs(fold)) != 2:
        fail("train cli: --resume on the finished fold did not skip both stages")

    # 3. Distillation, the smoke fold as the teacher.
    # The teacher's forward shows in the launches.
    distill, _ = in_process("distillation from smoke_001", CLI_DISTILL)
    if ([(r["stage"], r["epoch"]) for r in distill["epochs"]] != [("warmup", 0), ("train", 1)]
            or not finite(distill["epochs"]) or get_best_model_path(experiments / CLI_DISTILL / "fold_0") is None):
        fail(f"train cli: the distillation logged {distill['epochs']}")
    expected = expected_cli_launches(2 * smoke_steps, 2 * val_batches,
                                     configs[CLI_DISTILL]["argus_params"]["nn_module"][1], nn_params)
    if distill["launches"] != expected:
        fail(f"train cli: the distillation launched {distill['launches']}, expected {expected}")

    # 4. A real SIGTERM to the CLI as a user runs it, once the warmup epoch is logged; then --resume.
    env = {**os.environ, "SENSORIUM_DATA_DIR": str(data_dir), "SENSORIUM_CONFIGS_DIR": str(configs_dir),
           "SENSORIUM_FOLD_ASSIGNMENT": "trial", "PYTHONPATH": str(REPO)}
    command = [sys.executable, "-m", "sensorium_tpu_torch.cli.train", "-e", CLI_SIGTERM, *argv]
    sigterm_fold = experiments / CLI_SIGTERM / "fold_0"
    sigterm_steps = cli_fold_shape(configs[CLI_SIGTERM])[0]
    out_path = work / "train_cli_child.out"
    code, started_at, wall, signalled = run_cli_child(
        command, env, out_path,
        until=lambda: (sigterm_fold / "log.jsonl").exists() and '"stage": "warmup"' in (
            sigterm_fold / "log.jsonl").read_text())
    times, interrupted = cli_log_times(sigterm_fold), read_cli_logs(sigterm_fold)
    if code != 75 or not (sigterm_fold / "train_state.ckpt").exists() or "preempted" not in times:
        fail(f"train cli: SIGTERM gave exit code {code}, expected 75 and a train state:\n"
             f"{out_path.read_text()[-3000:]}")
    run = runs["SIGTERM"] = {
        "wall_seconds": wall, "returncode": code, "steps_per_second": sigterm_steps / interrupted[0]["epoch_time"],
        "seconds_before_first_step": times["epochs"][0] - interrupted[0]["epoch_time"] - started_at,
        "signal_to_saved_seconds": times["preempted"] - signalled, "epochs": interrupted}
    print(f"train cli: SIGTERM: {wall:.2f} s wall, exit code {code}; the warmup epoch's {sigterm_steps} steps at "
          f"{run['steps_per_second']:.3f} steps/s (validation included), {run['seconds_before_first_step']:.2f} s "
          f"before the first step (imports, module build, kernel library load, dataset index), "
          f"{run['signal_to_saved_seconds']:.2f} s from the signal to the train state saved", flush=True)

    code, started_at, wall, _ = run_cli_child([*command, "--resume"], env, out_path)
    output, times, records = out_path.read_text(), cli_log_times(sigterm_fold), read_cli_logs(sigterm_fold)
    resumed_at = interrupted[-1]["epoch"] + 1
    epochs = [r["epoch"] for r in records]
    if (code != 0 or f"Resumed from epoch {resumed_at}" not in output
            or epochs != list(range(len(configs[CLI_SIGTERM]["num_epochs"])))):
        fail(f"train cli: the resume after SIGTERM gave exit code {code}, epochs {epochs}:\n{output[-3000:]}")
    new = records[len(interrupted):]
    run = runs["SIGTERM --resume"] = {
        "wall_seconds": wall, "returncode": code, "epochs": new,
        "steps_per_second": len(new) * sigterm_steps / sum(r["epoch_time"] for r in new),
        "seconds_before_first_step": times["epochs"][len(interrupted)] - new[0]["epoch_time"] - started_at,
        "after_last_epoch_seconds": started_at + wall - times["epochs"][-1]}
    print(f"train cli: SIGTERM --resume: {wall:.2f} s wall, exit code 0, resumed from epoch {resumed_at}, epochs "
          f"logged {epochs}; {len(new) * sigterm_steps} steps at {run['steps_per_second']:.3f} steps/s "
          f"(validation included), {run['seconds_before_first_step']:.2f} s before the first step (the train "
          f"state's load included), {run['after_last_epoch_seconds']:.2f} s after the last epoch's log line "
          f"(its model and train-state saves, and the exit)", flush=True)
    shutil.rmtree(experiments / CLI_SIGTERM)

    record["train_cli"] = {"runs": runs, "distill_launches": distill["launches"],
                           "steps_per_epoch": {CLI_EXPERIMENT: smoke_steps, CLI_SIGTERM: sigterm_steps},
                           "val_batches_per_epoch": val_batches}
    (constants.data_dir, constants.sensorium_dir, constants.experiments_dir, constants.predictions_dir,
     constants.configs_dir) = saved
    mouse_data.get_folds_tiers.cache_clear()
    return smoke["launches"]


def mesh_params(dtype: str) -> dict:
    """The flagship's training config with SGD (the update is linear in the
    gradient) in ``dtype``; fp32 rematerializes every block, which changes
    no number (the recompute is exact) and halves the memory."""
    nn_name, nn_params = FLAGSHIP_NN_MODULE
    if dtype == "float32":
        nn_params = {**nn_params, "dtype": "float32", "remat_blocks": tuple(range(len(nn_params["core_features"])))}
    return {**FLAGSHIP_TRAIN_ARGUS, "nn_module": (nn_name, nn_params), "optimizer": ("SGD", {"lr": MESH_LR})}


MESH_DTYPES = ("float32", "bfloat16")


def mesh_reference(work: Path, batch: int = TRAIN_BATCH, name: str = "reference.pt") -> None:
    """Phase 16a (and 18a), in a child process: one unsharded flagship step
    at ``batch`` rows in each of MESH_DTYPES, saved for the ranks to compare
    with."""
    import gc

    import torch

    from sensorium_tpu_torch.engine.model import MouseModel

    torch.backends.cuda.matmul.allow_tf32 = False
    saved = {}
    for dtype in MESH_DTYPES:
        torch.cuda.reset_peak_memory_stats()
        model = MouseModel(mesh_params(dtype), device="cuda")
        model.build_state(seed=SEED, learning_rate=MESH_LR)
        loss = float(model.train_step(synthetic_batch(batch)))
        module = model.state.model
        saved[dtype] = {"loss": loss, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "grads": {name: p.grad.detach().float().cpu() for name, p in module.named_parameters()},
                        "state": {name: t.detach().float().cpu() for name, t in module.state_dict().items()}}
        del model, module
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(saved, work / name)


def check_gloo_collectives(mesh) -> dict:
    """Whether gloo reduces, broadcasts and gathers CUDA tensors (the
    gathers in fp32 and bf16, the tensor-parallel layers' dtypes) as the
    port asks it to, over all of the mesh's processes."""
    import torch
    import torch.distributed as dist

    from sensorium_tpu_torch.parallel import mesh as mesh_lib

    world = mesh.processes
    ok = {}
    for op, expected in (("sum", world * (world + 1) / 2), ("max", world), ("min", 1)):
        tensor = torch.full((3,), float(mesh.index + 1), device="cuda")
        mesh_lib.all_reduce(mesh, tensor, op, over="all")
        ok[f"all_reduce_{op}"] = tensor.is_cuda and bool((tensor == expected).all())
    tensor = torch.full((3,), float(mesh.index + 7), device="cuda")
    mesh_lib.replicate_tree(mesh, tensor)
    ok["broadcast"] = tensor.is_cuda and bool((tensor == 7).all())
    for dtype in (torch.float32, torch.bfloat16):
        parts = [torch.empty(3, device="cuda", dtype=dtype) for _ in range(world)]
        dist.all_gather(parts, torch.full((3,), float(mesh.index + 1), device="cuda", dtype=dtype), group=mesh.group)
        ok[f"all_gather_{str(dtype).removeprefix('torch.')}"] = all(
            p.is_cuda and p.dtype == dtype and bool((p == i + 1).all()) for i, p in enumerate(parts))
    return ok


def compare_with_reference(grads: dict, state: dict, loss: float, reference: dict, dtype: str) -> dict:
    """16a's (and 18a's) errors against the one-card step, as fractions of
    their bounds (see MESH_*); ``grads`` and ``state`` by name, whole. In
    bf16 each bound adds MESH_BF16_FACTOR times the tensor's own bf16 error."""
    ref = reference[dtype]
    fp32 = reference["float32"]

    def bf16_error(kind: str, name: str) -> float:
        if dtype == "float32":
            return 0.0
        return MESH_BF16_FACTOR * float((ref[kind][name] - fp32[kind][name]).abs().max())

    model_max = max(float(g.abs().max()) for g in ref["grads"].values())
    ratios, bf16_rel, over_bf16 = {}, [], []
    for name, grad in grads.items():
        expected = ref["grads"][name]
        diff = float((grad.detach().float().cpu() - expected).abs().max())
        bound = (TRAIN_GRAD_REL_TOL * float(expected.abs().max()) + TRAIN_GRAD_FLOOR * model_max
                 + bf16_error("grads", name))
        ratios[f"grad/{name}"] = diff / bound
        error = bf16_error("grads", name) / MESH_BF16_FACTOR
        if error > 0.0:
            bf16_rel.append(error / max(float(fp32["grads"][name].abs().max()), 1e-30))
            over_bf16.append(diff / error)
    for name, value in state.items():
        expected = ref["state"][name]
        if name.endswith((".mean", ".var")):
            rtol, atol = MESH_STATS_RTOL, MESH_STATS_ATOL
        else:
            rtol, atol = MESH_PARAM_RTOL, MESH_DW_ATOL if "dw_kernel" in name else MESH_PARAM_ATOL
        bound = rtol * expected.abs() + atol + bf16_error("state", name)
        ratios[f"state/{name}"] = float(((value.detach().float().cpu() - expected).abs() / bound).max())
    loss_rel = abs(loss - ref["loss"]) / abs(ref["loss"])
    worst = {kind: max((r, k) for k, r in ratios.items() if k.startswith(kind)) for kind in ("grad/", "state/")}
    result = {"reference_loss": ref["loss"], "reference_peak_gb": ref["peak_gb"], "loss_rel_err": loss_rel,
              "loss_ratio": loss_rel / (MESH_LOSS_RTOL if dtype == "float32" else MESH_BF16_LOSS_RTOL),
              "grad_worst": worst["grad/"], "state_worst": worst["state/"], "ratios": ratios}
    if bf16_rel:
        # bf16's own error (a gradient tensor's max |bf16 - fp32| over fp32's largest value), and the two
        # ranks' difference from one card over that error: medians and the largest, over the tensors.
        result["bf16_error"] = {"median": statistics.median(bf16_rel), "max": max(bf16_rel)}
        result["ranks_over_bf16_error"] = {"median": statistics.median(over_bf16), "max": max(over_bf16)}
    return result


def mesh_rank(work: Path, rank: int, port: int) -> None:
    """Phase 16a, in a child process: rank ``rank`` of a gloo group on card 0,
    one step in each of MESH_DTYPES (the launches counted in bf16, the
    flagship's dtype)."""
    import gc

    import torch
    import torch.distributed as dist

    from sensorium_tpu_torch.engine.model import MouseModel
    from sensorium_tpu_torch.ops import dw_kernels
    from sensorium_tpu_torch.parallel import mesh as mesh_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=MESH_WORLD, rank=rank)
    try:
        mesh = mesh_lib.create_mesh(devices=["cuda:0"])
        result = {"rank": rank, "collectives": check_gloo_collectives(mesh)}
        (work / f"rank{rank}.json").write_text(json.dumps(result))
        if not all(result["collectives"].values()):
            return
        reference = torch.load(work / "reference.pt") if rank == 0 else None
        for dtype in MESH_DTYPES:
            model = MouseModel(mesh_params(dtype), mesh=mesh)
            model.build_state(seed=SEED, learning_rate=MESH_LR)
            batch = synthetic_batch(TRAIN_BATCH)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            start = time.perf_counter()
            loss = float(model.train_step(batch))
            step = {"step_seconds": time.perf_counter() - start, "launches": dict(dw_kernels.LAUNCHES),
                    "loss": loss, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            module = model.state.model
            sums = torch.stack([t.detach().double().sum() for t in module.state_dict().values()])
            high = mesh_lib.all_reduce(mesh, sums.clone(), "max")
            low = mesh_lib.all_reduce(mesh, sums.clone(), "min")
            step["replicas_identical"] = bool(torch.equal(high, low))
            if reference is not None:
                grads = {name: p.grad for name, p in module.named_parameters()}
                step.update(compare_with_reference(grads, module.state_dict(), loss, reference, dtype))
            result[dtype] = step
            del model, module
            gc.collect()
            torch.cuda.empty_cache()
        (work / f"rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def run_children(commands: list[list[str]], out_dir: Path, label: str) -> None:
    """Run ``commands`` at once, each one's output to a file; fail if one fails."""
    import os

    env = {**os.environ, "PYTHONPATH": str(REPO)}
    outs = [out_dir / f"{label}_{i}.out" for i in range(len(commands))]
    procs = []
    for command, out in zip(commands, outs):
        with open(out, "w") as handle:
            procs.append(subprocess.Popen(command, env=env, cwd=REPO, stdout=handle, stderr=subprocess.STDOUT))
    try:
        for proc in procs:
            proc.wait(timeout=CLI_CHILD_TIMEOUT)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, out in zip(procs, outs):
        if proc.returncode != 0:
            fail(f"{label}: {proc.args[1:4]} exited {proc.returncode}:\n{out.read_text()[-3000:]}")


def mesh_library(record: dict, work: Path) -> dict:
    """Phase 16a: two ranks on this card against one card's step. Returns each rank's launches."""
    mesh_dir = work / "mesh"
    mesh_dir.mkdir()
    start = time.perf_counter()
    script = str(Path(__file__).resolve())
    run_children([[sys.executable, script, "--mesh-child", "reference", "--out", str(mesh_dir)]], mesh_dir,
                 "mesh reference")
    reference_s = time.perf_counter() - start
    from sensorium_tpu_torch.cli.train import free_port

    port = free_port()
    run_children([[sys.executable, script, "--mesh-child", f"rank{rank}", "--port", str(port), "--out",
                   str(mesh_dir)] for rank in range(MESH_WORLD)], mesh_dir, "mesh ranks")
    ranks = [json.loads((mesh_dir / f"rank{rank}.json").read_text()) for rank in range(MESH_WORLD)]
    (mesh_dir / "reference.pt").unlink()
    for result in ranks:
        print(f"mesh: rank {result['rank']}: gloo on CUDA tensors {result['collectives']}", flush=True)
        if not all(result["collectives"].values()):
            fail(f"mesh: gloo does not take a CUDA tensor for {result['collectives']}")
    record["mesh_library"] = {"ranks": ranks, "reference_seconds": reference_s,
                              "seconds": time.perf_counter() - start}
    per_step = expected_train_launches()
    for dtype in MESH_DTYPES:
        for rank in ranks:
            step = rank[dtype]
            print(f"mesh: {dtype}: rank {rank['rank']}: loss {step['loss']:.6f}, step {step['step_seconds']:.2f} s "
                  f"(the first, with the gloo reductions), peak memory {step['peak_gb']:.2f} GB, launches "
                  f"{step['launches']}", flush=True)
        first = ranks[0][dtype]
        print(f"mesh: {dtype}: one card at batch {TRAIN_BATCH}: loss {first['reference_loss']:.6f}, peak "
              f"{first['reference_peak_gb']:.2f} GB; two ranks against it, as fractions of their bounds: the loss "
              f"{first['loss_ratio']:.3g} ({first['loss_rel_err']:.3g} relative), the worst gradient "
              f"{first['grad_worst'][1]} {first['grad_worst'][0]:.3g}, the worst weight or BN statistic "
              f"{first['state_worst'][1]} {first['state_worst'][0]:.3g}; replicas identical "
              f"{[r[dtype]['replicas_identical'] for r in ranks]}", flush=True)
        if "bf16_error" in first:
            print(f"mesh: {dtype}: one card's bf16 gradients against its fp32 ones, max |diff| over the tensor's "
                  f"largest value: median {first['bf16_error']['median']:.3g}, largest {first['bf16_error']['max']:.3g}"
                  f"; two ranks against one card over that bf16 error: median "
                  f"{first['ranks_over_bf16_error']['median']:.3g}, largest {first['ranks_over_bf16_error']['max']:.3g}",
                  flush=True)
        if not all(r[dtype]["replicas_identical"] for r in ranks):
            fail(f"mesh: {dtype}: the two ranks' weights differ after the step")
        for key in ("loss_ratio", "grad_worst", "state_worst"):
            value = first[key] if key == "loss_ratio" else first[key][0]
            if not value <= 1.0:
                fail(f"mesh: {dtype}: the two-rank step exceeds its bound: {key} {first[key]}")
    for rank in ranks:
        expected = {key: per_step.get(key, 0) for key in rank["bfloat16"]["launches"]}
        if rank["bfloat16"]["launches"] != expected:
            fail(f"mesh: rank {rank['rank']} launched {rank['bfloat16']['launches']} in its step, expected {expected}")
    return {f"mesh_rank{r['rank']}": r["bfloat16"]["launches"] for r in ranks}


def counted_cli(module: str, argv: list[str], launches_path: Path) -> list[str]:
    return [sys.executable, "-c", COUNTED_MODULE, str(launches_path), module, *argv]


def close_logs(label: str, got: list[dict], expected: list[dict]) -> float:
    """Fails unless ``got``'s epochs are ``expected``'s within the mesh log
    tolerances; returns the largest relative loss difference."""
    import numpy as np

    if [(r["stage"], r["epoch"]) for r in got] != [(r["stage"], r["epoch"]) for r in expected]:
        fail(f"{label}: logged {[(r['stage'], r['epoch']) for r in got]}, expected "
             f"{[(r['stage'], r['epoch']) for r in expected]}")
    worst = 0.0
    for a, b in zip(got, expected):
        for key in ("train_loss", "val_loss"):
            worst = max(worst, abs(a[key] - b[key]) / abs(b[key]))
        corr = max(abs(a[k] - b[k]) for k in b if k.startswith("val_corr"))
        if worst > MESH_LOG_RTOL or not corr <= MESH_CORR_ATOL or not np.isfinite(a["val_corr"]):
            fail(f"{label}: epoch {a['epoch']} {a} against {b}")
    return worst


def multihost_cli(record: dict, fit_root: Path, work: Path) -> dict:
    """Phase 16b: ``cli.train --multihost 127.0.0.1:PORT,1,0`` (NCCL, world
    size 1) against phase 15, then SIGTERM -> 75 -> ``--resume`` -> 0.
    Returns the launches of the smoke_001 fold."""
    import os

    import numpy as np

    from sensorium_tpu_torch.cli.train import free_port

    data_dir = work / "train_cli_mesh"
    data_dir.mkdir()
    (data_dir / "sensorium_all_2023").symlink_to(fit_root.resolve(), target_is_directory=True)
    # World size 1: one visible card, whatever the machine holds.
    env = {**os.environ, "SENSORIUM_DATA_DIR": str(data_dir),
           "SENSORIUM_CONFIGS_DIR": str(work / "train_cli_configs"), "SENSORIUM_FOLD_ASSIGNMENT": "trial",
           "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": "0"}
    phase15 = record["train_cli"]
    experiments = data_dir / "experiments"
    out_path, launches_path = work / "multihost_child.out", work / "multihost_launches.json"
    runs = {}

    # 1. The smoke_001 fold through NCCL at world size 1.
    argv = ["-e", CLI_EXPERIMENT, "-f", "0", "--multihost", f"127.0.0.1:{free_port()},1,0"]
    code, _, wall, _ = run_cli_child(counted_cli("sensorium_tpu_torch.cli.train", argv, launches_path), env,
                                     out_path)
    output = out_path.read_text()
    if code != 0 or "Multihost: process 0/1, 1 global devices (nccl, cuda:0)" not in output:
        fail(f"multihost cli: exit code {code}:\n{output[-3000:]}")
    records = read_cli_logs(experiments / CLI_EXPERIMENT / "fold_0")
    single = phase15["runs"]["smoke_001 fold 0"]
    worst = close_logs("multihost cli", records, single["epochs"])
    identical = all(a[k] == b[k] for a, b in zip(records, single["epochs"]) for k in b
                    if k not in ("time", "epoch_time"))
    launches = json.loads(launches_path.read_text())
    if launches != single["launches"]:
        fail(f"multihost cli: launched {launches}, phase 15's fold {single['launches']}")
    steps = 2 * phase15["steps_per_epoch"][CLI_EXPERIMENT]
    rate = steps / sum(r["epoch_time"] for r in records)
    runs["smoke_001 fold 0"] = {"wall_seconds": wall, "epochs": records, "launches": launches,
                                "steps_per_second": rate, "max_loss_rel_diff": worst, "identical_logs": identical}
    print(f"multihost cli: smoke_001 fold 0 through NCCL at world size 1: {wall:.2f} s wall, {steps} steps at "
          f"{rate:.3f} steps/s over its epochs (phase 15 in-process: {single['steps_per_second']:.3f}); logs "
          f"against phase 15's: largest loss difference {worst:.3g} relative, every logged number identical: "
          f"{identical}; launches {launches} (phase 15's)", flush=True)

    # 2. SIGTERM after the warmup epoch -> 75, then --resume -> 0; the warmup epoch's rate beside phase 15's.
    fold = experiments / CLI_SIGTERM / "fold_0"
    argv = ["-e", CLI_SIGTERM, "-f", "0", "--multihost", f"127.0.0.1:{free_port()},1,0"]
    command = [sys.executable, "-m", "sensorium_tpu_torch.cli.train", *argv]
    code, _, wall, _ = run_cli_child(command, env, out_path, until=lambda: (fold / "log.jsonl").exists() and
                                     '"stage": "warmup"' in (fold / "log.jsonl").read_text())
    interrupted = read_cli_logs(fold)
    if code != 75 or not (fold / "train_state.ckpt").exists():
        fail(f"multihost cli: SIGTERM gave exit code {code}, expected 75 and a train state:\n"
             f"{out_path.read_text()[-3000:]}")
    sigterm_steps = phase15["steps_per_epoch"][CLI_SIGTERM]
    rate = sigterm_steps / interrupted[0]["epoch_time"]
    single_rate = phase15["runs"]["SIGTERM"]["steps_per_second"]
    runs["SIGTERM"] = {"wall_seconds": wall, "returncode": code, "steps_per_second": rate, "epochs": interrupted,
                       "phase15_steps_per_second": single_rate, "mesh_path_cost": 1.0 - rate / single_rate}
    print(f"multihost cli: SIGTERM: exit code {code} in {wall:.2f} s; the warmup epoch's {sigterm_steps} steps "
          f"at {rate:.3f} steps/s (validation included) against phase 15's {single_rate:.3f} without a mesh: "
          f"the mesh path costs {100 * runs['SIGTERM']['mesh_path_cost']:.1f}% on one card", flush=True)
    argv[-1] = f"127.0.0.1:{free_port()},1,0"
    code, _, wall, _ = run_cli_child([sys.executable, "-m", "sensorium_tpu_torch.cli.train", *argv, "--resume"],
                                     env, out_path)
    epochs = [r["epoch"] for r in read_cli_logs(fold)]
    if code != 0 or epochs != list(range(2)) or "Resumed from epoch" not in out_path.read_text():
        fail(f"multihost cli: the resume gave exit code {code}, epochs {epochs}:\n{out_path.read_text()[-3000:]}")
    runs["SIGTERM --resume"] = {"wall_seconds": wall, "returncode": code}
    print(f"multihost cli: SIGTERM --resume: exit code 0 in {wall:.2f} s, epochs logged {epochs}", flush=True)
    shutil.rmtree(experiments / CLI_SIGTERM)
    if not np.isfinite(rate):
        fail("multihost cli: no steps/s")
    record["multihost_cli"] = {"runs": runs}
    return launches


def fp32_checkpoint(source: Path, target: Path) -> None:
    """``source``'s weights under its config with ``dtype`` float32."""
    from sensorium_tpu_torch.engine import checkpoint as ckpt

    payload = ckpt.load_model_checkpoint(source)
    params = payload["params"]
    name, nn_params = params["nn_module"]
    ckpt.save_model_checkpoint(target, {**params, "nn_module": (name, {**nn_params, "dtype": "float32"})},
                               payload["nn_state"])


def mesh_cards_cli(record: dict, fit_root: Path, work: Path) -> None:
    """Phase 16c, with two cards or more: ``cli.train`` over every card
    (``--mesh data``, the default), then ``cli.predict -s folds --mesh``
    against one card, in fp32: in bf16 a window's roundings depend on the
    size of the forward it is in, which the mesh divides (PERF.md, phase
    16c)."""
    import os

    import numpy as np
    import torch

    from sensorium_tpu_torch.cli import predict
    from sensorium_tpu_torch.data import mouse_data
    from sensorium_tpu_torch.utils.misc import get_best_model_path

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"mesh cards: 16c did not run: {cards} card visible (it needs 2 or more)", flush=True)
        record["mesh_cards"] = {"ran": False, "cards": cards}
        return
    data_dir = work / "train_cli_cards"
    data_dir.mkdir()
    (data_dir / "sensorium_all_2023").symlink_to(fit_root.resolve(), target_is_directory=True)
    env = {**os.environ, "SENSORIUM_DATA_DIR": str(data_dir),
           "SENSORIUM_CONFIGS_DIR": str(work / "train_cli_configs"), "SENSORIUM_FOLD_ASSIGNMENT": "trial",
           "PYTHONPATH": str(REPO)}
    out_path = work / "mesh_cards_child.out"
    code, _, wall, _ = run_cli_child([sys.executable, "-m", "sensorium_tpu_torch.cli.train", "-e", CLI_EXPERIMENT,
                                      "-f", "0"], env, out_path)
    output = out_path.read_text()
    if code != 0 or f"Data parallel over {cards} cards" not in output:
        fail(f"mesh cards: cli.train over {cards} cards gave exit code {code}:\n{output[-3000:]}")
    records = read_cli_logs(data_dir / "experiments" / CLI_EXPERIMENT / "fold_0")
    worst = close_logs("mesh cards", records, record["train_cli"]["runs"]["smoke_001 fold 0"]["epochs"])
    steps = 2 * record["train_cli"]["steps_per_epoch"][CLI_EXPERIMENT]
    rate = steps / sum(r["epoch_time"] for r in records)
    print(f"mesh cards: cli.train over {cards} cards: {wall:.2f} s wall, {rate:.3f} steps/s over its epochs; "
          f"largest loss difference from phase 15's one card {worst:.3g} relative", flush=True)

    trained = get_best_model_path(data_dir / "experiments" / CLI_EXPERIMENT / "fold_0")
    checkpoint = work / "mesh_cards_fp32" / trained.name
    checkpoint.parent.mkdir()
    fp32_checkpoint(trained, checkpoint)
    for fold in constants.folds_splits:
        fold_dir = data_dir / "experiments" / MESH_PREDICT / fold
        fold_dir.mkdir(parents=True)
        (fold_dir / checkpoint.name).symlink_to(checkpoint)
    saved = (constants.data_dir, constants.sensorium_dir, constants.experiments_dir, constants.predictions_dir)
    point_data_dir(data_dir)
    mouse_data.get_folds_tiers.cache_clear()
    walls = {}
    try:
        for label, flags in (("one card", []), ("mesh", ["--mesh"])):
            constants.predictions_dir = data_dir / f"predictions_{label.replace(' ', '_')}"
            torch.cuda.synchronize()
            start = time.perf_counter()
            predict.main(["-e", MESH_PREDICT, "-s", "folds", *flags])
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - start
        worst_rel, count = 0.0, 0
        for path in sorted((data_dir / "predictions_one_card").rglob("*.npy")):
            expected = np.load(path)
            got = np.load(data_dir / "predictions_mesh" / path.relative_to(data_dir / "predictions_one_card"))
            worst_rel = max(worst_rel, float(np.max(np.abs(got - expected)) / np.max(np.abs(expected))))
            count += 1
    finally:
        constants.data_dir, constants.sensorium_dir, constants.experiments_dir, constants.predictions_dir = saved
        mouse_data.get_folds_tiers.cache_clear()
    print(f"mesh cards: cli.predict -s folds in fp32 over {cards} cards ({walls['mesh']:.2f} s, loads included) "
          f"against one card ({walls['one card']:.2f} s): {count} trials, max |diff| / max |one card| "
          f"{worst_rel:.3g} (tolerance {CPU_REL_TOL})", flush=True)
    if count == 0 or not worst_rel <= CPU_REL_TOL:
        fail(f"mesh cards: the mesh prediction differs from one card by {worst_rel} ({count} trials)")
    record["mesh_cards"] = {"ran": True, "cards": cards, "wall_seconds": wall, "steps_per_second": rate,
                            "epochs": records, "max_loss_rel_diff": worst, "predict_seconds": walls,
                            "predict_max_rel_err": worst_rel}


def tp_checkpoints(model, mesh, work: Path, batch) -> dict:
    """Phase 18b on one rank: the sharded train state and a model checkpoint
    of ``model`` after its step, a fresh model resumed from the state, then
    TP_CONTINUED_STEPS steps of both; the TP forward that the one-card
    checkpoint is held to (saved by the first rank)."""
    import torch

    from sensorium_tpu_torch.engine.model import MouseModel

    state_dir, checkpoint = work / "tp_state.orbax", work / "tp_model.ckpt"
    torch.cuda.synchronize()
    start = time.perf_counter()
    model.save_train_state(state_dir, extra={"epoch": 0})
    save_s = time.perf_counter() - start
    start = time.perf_counter()
    model.save(checkpoint)
    save_model_s = time.perf_counter() - start
    prediction = model.predict(batch.inputs[:TP_PREDICT_ROWS], mouse_index=0)
    if mesh.index == 0:
        torch.save(prediction.cpu(), work / "tp_prediction.pt")
    fresh = MouseModel(model.params, mesh=mesh)
    fresh.build_state(seed=SEED + 1, learning_rate=MESH_LR)
    torch.cuda.synchronize()
    start = time.perf_counter()
    extra = fresh.load_train_state(state_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - start

    def same(a, b) -> bool:
        pairs = [(a.state.model.state_dict(), b.state.model.state_dict())]
        return all(torch.equal(x[k], y[k]) for x, y in pairs for k in x) and a.state.step == b.state.step and \
            torch.equal(a.state.generator.get_state(), b.state.generator.get_state())

    restored = same(model, fresh) and extra == {"epoch": 0}
    losses = [[float(m.train_step(batch)) for _ in range(TP_CONTINUED_STEPS)] for m in (model, fresh)]
    return {"save_seconds": save_s, "save_model_seconds": save_model_s, "load_seconds": load_s,
            "bytes": sum(f.stat().st_size for f in state_dir.rglob("*") if f.is_file()),
            "restored_bitwise": restored, "losses": losses,
            "continued_bitwise": losses[0] == losses[1] and same(model, fresh)}


def tp_rank(work: Path, rank: int, port: int) -> None:
    """Phase 18a (and 18b), in a child process: rank ``rank`` of a gloo group
    on card 0 over a {data: 1, model: 2} mesh, one step in each of
    MESH_DTYPES (the launches counted in bf16, the flagship's dtype)."""
    import gc

    import torch
    import torch.distributed as dist

    from sensorium_tpu_torch.engine.model import MouseModel
    from sensorium_tpu_torch.ops import dw_kernels
    from sensorium_tpu_torch.parallel import mesh as mesh_lib
    from sensorium_tpu_torch.parallel import tensor as tensor_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=TP_WORLD, rank=rank)
    try:
        mesh = mesh_lib.create_mesh(num_model=TP_WORLD, devices=["cuda:0"])
        result = {"rank": rank, "shape": mesh.shape, "collectives": check_gloo_collectives(mesh)}
        (work / f"tp_rank{rank}.json").write_text(json.dumps(result))
        if not all(result["collectives"].values()):
            return
        reference = torch.load(work / "tp_reference.pt") if rank == 0 else None
        batch = synthetic_batch(TP_BATCH)
        for dtype in MESH_DTYPES:
            model = MouseModel(mesh_params(dtype), mesh=mesh)
            model.build_state(seed=SEED, learning_rate=MESH_LR)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            start = time.perf_counter()
            loss = float(model.train_step(batch))
            step = {"step_seconds": time.perf_counter() - start, "launches": dict(dw_kernels.LAUNCHES),
                    "loss": loss, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
            module = model.state.model
            step["readout_slice"] = list(module.readout_kernel.shape)
            grads = tensor_lib.gather_tensors({name: p.grad for name, p in module.named_parameters()}, mesh)
            state = tensor_lib.gather_state_dict(module, mesh)
            replicated = [t for name, t in module.state_dict().items()
                          if tensor_lib.param_sharding_rules(name, t.shape) is None]
            sums = torch.stack([t.detach().double().sum() for t in replicated])
            high = mesh_lib.all_reduce(mesh, sums.clone(), "max", over="model")
            low = mesh_lib.all_reduce(mesh, sums.clone(), "min", over="model")
            step["replicas_identical"] = bool(torch.equal(high, low))
            if reference is not None:
                step.update(compare_with_reference(grads, state, loss, reference, dtype))
            del grads, state
            if dtype == "float32":
                step["sharded_state"] = tp_checkpoints(model, mesh, work, batch)
            result[dtype] = step
            del model, module
            gc.collect()
            torch.cuda.empty_cache()
        (work / f"tp_rank{rank}.json").write_text(json.dumps(result))
    finally:
        dist.destroy_process_group()


def mesh_tp(record: dict, work: Path) -> dict:
    """Phases 18a and 18b: two ranks of a model axis on this card against
    one card's step; the sharded state, its resume, and the TP-written
    checkpoint on one card. Returns each rank's launches."""
    import torch

    from sensorium_tpu_torch.cli.train import free_port
    from sensorium_tpu_torch.engine.model import load_model

    tp_dir = work / "tp"
    tp_dir.mkdir()
    start = time.perf_counter()
    script = str(Path(__file__).resolve())
    run_children([[sys.executable, script, "--mesh-child", "tp_reference", "--out", str(tp_dir)]], tp_dir,
                 "tp reference")
    reference_s = time.perf_counter() - start
    port = free_port()
    run_children([[sys.executable, script, "--mesh-child", f"tp_rank{rank}", "--port", str(port), "--out",
                   str(tp_dir)] for rank in range(TP_WORLD)], tp_dir, "tp ranks")
    ranks = [json.loads((tp_dir / f"tp_rank{rank}.json").read_text()) for rank in range(TP_WORLD)]
    (tp_dir / "tp_reference.pt").unlink()
    smi = nvidia_smi_line()
    for result in ranks:
        print(f"tp: rank {result['rank']} of {result['shape']}: gloo on CUDA tensors {result['collectives']}",
              flush=True)
        if not all(result["collectives"].values()):
            fail(f"tp: gloo does not take a CUDA tensor for {result['collectives']}")
    per_step = expected_train_launches()
    for dtype in MESH_DTYPES:
        for rank in ranks:
            step = rank[dtype]
            print(f"tp: {dtype}: rank {rank['rank']}: loss {step['loss']:.6f}, step {step['step_seconds']:.2f} s "
                  f"(the first, with the gloo collectives; two ranks share this card: not a TP speed), readout "
                  f"slice {step['readout_slice']}, peak memory {step['peak_gb']:.2f} GB against one card's "
                  f"{ranks[0][dtype]['reference_peak_gb']:.2f} GB at {TP_BATCH} rows ({smi}), launches "
                  f"{step['launches']}", flush=True)
        first = ranks[0][dtype]
        print(f"tp: {dtype}: one card at batch {TP_BATCH}: loss {first['reference_loss']:.6f}; the two ranks "
              f"against it, as fractions of their bounds: the loss {first['loss_ratio']:.3g} "
              f"({first['loss_rel_err']:.3g} relative), the worst gradient {first['grad_worst'][1]} "
              f"{first['grad_worst'][0]:.3g}, the worst weight or BN statistic {first['state_worst'][1]} "
              f"{first['state_worst'][0]:.3g}; replicated weights identical "
              f"{[r[dtype]['replicas_identical'] for r in ranks]}", flush=True)
        if "bf16_error" in first:
            print(f"tp: {dtype}: the two ranks against one card over its own bf16 error: median "
                  f"{first['ranks_over_bf16_error']['median']:.3g}, largest "
                  f"{first['ranks_over_bf16_error']['max']:.3g}", flush=True)
        if not all(r[dtype]["replicas_identical"] for r in ranks):
            fail(f"tp: {dtype}: the two ranks' replicated weights differ after the step")
        for key in ("loss_ratio", "grad_worst", "state_worst"):
            value = first[key] if key == "loss_ratio" else first[key][0]
            if not value <= 1.0:
                fail(f"tp: {dtype}: the two-rank step exceeds its bound: {key} {first[key]}")
    for rank in ranks:
        expected = {key: per_step.get(key, 0) for key in rank["bfloat16"]["launches"]}
        if rank["bfloat16"]["launches"] != expected:
            fail(f"tp: rank {rank['rank']} launched {rank['bfloat16']['launches']} in its step, expected {expected}")

    # 18b: the sharded state resumed bitwise, and the TP-written checkpoint on one card.
    for rank in ranks:
        sharded = rank["float32"]["sharded_state"]
        print(f"tp: float32: rank {rank['rank']}: train_state.orbax {sharded['bytes'] / 1e9:.3f} GB, saved in "
              f"{sharded['save_seconds']:.2f} s, loaded in {sharded['load_seconds']:.2f} s; the model checkpoint "
              f"gathered and saved in {sharded['save_model_seconds']:.2f} s; restored bitwise "
              f"{sharded['restored_bitwise']}; {TP_CONTINUED_STEPS} more steps {sharded['losses']}, bitwise "
              f"{sharded['continued_bitwise']}", flush=True)
        if not (sharded["restored_bitwise"] and sharded["continued_bitwise"]):
            fail(f"tp: rank {rank['rank']}: the resumed sharded state is not the uninterrupted run's: {sharded}")
    one_card = load_model(tp_dir / "tp_model.ckpt", device="cuda")
    expected = torch.load(tp_dir / "tp_prediction.pt")
    got = one_card.predict(synthetic_batch(TP_BATCH).inputs[:TP_PREDICT_ROWS], mouse_index=0).cpu()
    rel = float((got - expected).abs().max() / expected.abs().max())
    print(f"tp: the TP-written checkpoint on one card: {TP_PREDICT_ROWS} rows of mouse 0 within {rel:.3g} of the "
          f"TP forward's largest value (tolerance {CPU_REL_TOL})", flush=True)
    if got.shape != expected.shape or not rel <= CPU_REL_TOL:
        fail(f"tp: one card's forward of the TP-written checkpoint differs by {rel} ({tuple(got.shape)})")
    del one_card
    record["mesh_tp"] = {"ranks": ranks, "reference_seconds": reference_s, "one_card_rel_err": rel,
                         "seconds": time.perf_counter() - start}
    return {f"tp_rank{r['rank']}": r["bfloat16"]["launches"] for r in ranks}


def mesh_tp_cards(record: dict, fit_root: Path, work: Path) -> None:
    """Phase 18c, with two cards or more: CLI_TP_FP32's fold through
    ``cli.train --mesh data,model --sharded-checkpoint`` over every card,
    its logs held at 16b's tolerances to the same fold on one card
    (``--no-mesh``), both in fp32: in bf16 a forward's roundings depend on
    its size, which the data axis divides (PERF.md, phase 16c). Then the
    SIGTERM run with those flags -> 75 -> ``--resume`` -> 0. Reads the
    configs phase 15 wrote under ``work``."""
    import os
    from importlib.machinery import SourceFileLoader

    import torch

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"tp cards: 18c did not run: {cards} card visible (it needs 2 or more)", flush=True)
        record["mesh_tp_cards"] = {"ran": False, "cards": cards}
        return
    flags = ["--mesh", "data,model", "--sharded-checkpoint"]
    out_path = work / "mesh_tp_child.out"
    configs_dir = work / "train_cli_configs"
    config = SourceFileLoader(CLI_TP_FP32, str(configs_dir / f"{CLI_TP_FP32}.py")).load_module().config
    steps = sum(config["num_epochs"]) * cli_train_steps(config)
    folds = {}
    for label, data_name, run_flags in (("one card", "train_cli_tp_one", ["--no-mesh"]),
                                        ("model axis", "train_cli_tp", flags)):
        data_dir = work / data_name
        data_dir.mkdir()
        (data_dir / "sensorium_all_2023").symlink_to(fit_root.resolve(), target_is_directory=True)
        env = {**os.environ, "SENSORIUM_DATA_DIR": str(data_dir),
               "SENSORIUM_CONFIGS_DIR": str(configs_dir), "SENSORIUM_FOLD_ASSIGNMENT": "trial",
               "PYTHONPATH": str(REPO)}
        code, _, wall, _ = run_cli_child([sys.executable, "-m", "sensorium_tpu_torch.cli.train", "-e", CLI_TP_FP32,
                                          "-f", "0", *run_flags], env, out_path)
        output = out_path.read_text()
        fold = data_dir / "experiments" / CLI_TP_FP32 / "fold_0"
        if code != 0 or (run_flags == flags and ("'model': 2}" not in output
                                                 or not (fold / "train_state.orbax" / "meta.json").is_file())):
            fail(f"tp cards: cli.train {' '.join(run_flags)} ({label}) gave exit code {code}:\n{output[-3000:]}")
        records = read_cli_logs(fold)
        rate = steps / sum(r["epoch_time"] for r in records)
        folds[label] = {"wall_seconds": wall, "steps_per_second": rate, "epochs": records}
        print(f"tp cards: the fp32 smoke_001 fold, cli.train {' '.join(run_flags)} ({label}): {wall:.2f} s wall, "
              f"{rate:.3f} steps/s over its epochs", flush=True)
    worst = close_logs("tp cards", folds["model axis"]["epochs"], folds["one card"]["epochs"])
    corr = max(abs(a[k] - b[k]) for a, b in zip(folds["model axis"]["epochs"], folds["one card"]["epochs"])
               for k in b if k.startswith("val_corr"))
    print(f"tp cards: over {cards} cards against one card in fp32: largest loss difference {worst:.3g} relative "
          f"(tolerance {MESH_LOG_RTOL}), val_corr {corr:.3g} (tolerance {MESH_CORR_ATOL})", flush=True)

    # The SIGTERM run (bf16) in the model axis run's data directory and environment.
    sigterm_fold = data_dir / "experiments" / CLI_SIGTERM / "fold_0"
    command = [sys.executable, "-m", "sensorium_tpu_torch.cli.train", "-e", CLI_SIGTERM, "-f", "0", *flags]
    code, _, sigterm_wall, _ = run_cli_child(command, env, out_path, until=lambda: (
        sigterm_fold / "log.jsonl").exists() and '"stage": "warmup"' in (sigterm_fold / "log.jsonl").read_text())
    if code != 75 or not (sigterm_fold / "train_state.orbax" / "meta.json").is_file():
        fail(f"tp cards: SIGTERM gave exit code {code}, expected 75 and a train_state.orbax:\n"
             f"{out_path.read_text()[-3000:]}")
    code, _, resume_wall, _ = run_cli_child([*command, "--resume"], env, out_path)
    epochs = [r["epoch"] for r in read_cli_logs(sigterm_fold)]
    if code != 0 or epochs != list(range(2)) or "Resumed from epoch" not in out_path.read_text():
        fail(f"tp cards: the resume gave exit code {code}, epochs {epochs}:\n{out_path.read_text()[-3000:]}")
    print(f"tp cards: SIGTERM -> 75 in {sigterm_wall:.2f} s, --resume from train_state.orbax -> 0 in "
          f"{resume_wall:.2f} s, epochs logged {epochs}", flush=True)
    record["mesh_tp_cards"] = {"ran": True, "cards": cards, "folds": folds, "max_loss_rel_diff": worst,
                               "max_corr_diff": corr, "sigterm_seconds": sigterm_wall,
                               "resume_seconds": resume_wall}


def stored_bytes(path: Path) -> int:
    """The bytes of the tensors an exported artifact stores: its weights and
    buffers (``state_dict``) and its lifted constants."""
    import torch

    program = torch.export.load(path)
    tensors = [*program.state_dict.values(), *program.constants.values()]
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def archive_parts(path: Path) -> dict:
    """A ``.pt2`` archive's bytes (uncompressed) by part: the weights, the
    constants, the sample inputs, the graphs and their metadata (``models/``)
    and the rest."""
    import zipfile

    parts = {"weights": 0, "constants": 0, "sample_inputs": 0, "models": 0, "other": 0}
    with zipfile.ZipFile(path) as archive:
        for info in archive.infolist():
            names = info.filename.split("/")
            part = next((n for n in ("weights", "constants", "sample_inputs", "models") if n in names), "other")
            parts[part] += info.file_size
    return parts


def scan_body_calls(length: int) -> int:
    """How many times this torch's eager ``scan`` runs its body over
    ``length`` elements: ``length``, or one more where it runs the body on
    the first element once more to infer the output shapes (torch 2.11)."""
    import torch

    calls = []

    def body(carry, x):
        calls.append(None)
        return [carry + x, x.clone()]

    torch.ops.higher_order.scan(body, [torch.zeros(())], [torch.zeros(length)], ())
    return len(calls)


def serving_export(record: dict, checkpoint: Path, work: Path) -> dict:
    """Phase 17: ``infer/export.py`` on the card. The window forward (all
    mice) and the trial program (mouse 0) of phase 13's checkpoint are
    exported and loaded; the trial artifact serves phase 4's requests beside
    the live ``Predictor``; a card-traced fp32 window artifact runs on the
    card beside the live model and on the CPU."""
    import numpy as np
    import torch

    from sensorium_tpu_torch.data.indexes import WindowIndexer
    from sensorium_tpu_torch.engine.model import load_model
    from sensorium_tpu_torch.infer.export import export_model_file, load_exported
    from sensorium_tpu_torch.infer.predictor import Predictor, assemble_trial_stack, chunk_updates
    from sensorium_tpu_torch.ops import dw_kernels

    def timed(fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        return value, time.perf_counter() - start

    result: dict = {"card": nvidia_smi_line()}
    artifacts = {}
    for label, kwargs in (("window", {}),
                          ("trial", {"mouse_index": 0, "trial": True, "src_hw": tuple(FIT_VIDEO),
                                     "chunk_size": CHUNK, "length_bucket": EXPORT_BUCKET})):
        path = work / f"{label}.pt2"
        summary, export_s = timed(lambda: export_model_file(checkpoint, path, device="cuda", **kwargs))
        artifacts[label], load_s = timed(lambda: load_exported(path, device="cuda"))
        result[label] = {"export_seconds": export_s, "bytes": summary["bytes"], "load_seconds": load_s,
                         "input_shapes": summary["input_shapes"], "output_shape": summary["output_shape"]}
        print(f"export: {label} artifact {summary['input_shapes']} -> {summary['output_shape']}: exported in "
              f"{export_s:.1f} s (checkpoint read, trace and write), {summary['bytes'] / 1e9:.3f} GB, loaded "
              f"in {load_s:.1f} s", flush=True)
    del artifacts["window"]

    live = Predictor(checkpoint, chunk_size=CHUNK, length_bucket=EXPORT_BUCKET, device="cuda")
    rng = np.random.default_rng(SEED)  # phase 4's requests
    warm = make_trial(rng)
    trials = [make_trial(rng) for _ in range(REQUESTS)]
    padded = math.ceil(TRIAL_LENGTH / EXPORT_BUCKET) * EXPORT_BUCKET
    pad = padded - TRIAL_LENGTH

    def padded_args(video, behavior, pupil):
        args = (np.pad(video.transpose(2, 0, 1), ((0, pad), (0, 0), (0, 0))),
                np.pad(behavior, ((0, 0), (0, pad))), np.pad(pupil, ((0, 0), (0, pad))))
        return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in args]

    def through_artifact(video, behavior, pupil):
        with torch.inference_mode():
            out = artifacts["trial"](*padded_args(video, behavior, pupil),
                                     torch.tensor(TRIAL_LENGTH, dtype=torch.int32, device="cuda"))
        return out[:, :TRIAL_LENGTH].cpu().numpy()

    gen = live.indexes_generator

    @torch.inference_mode()
    def replay(video, behavior, pupil):
        """The trial program run eagerly on the live model: the same chunks
        of 32 windows as the artifact's, the zero-weight rows included."""
        stack = assemble_trial_stack(*padded_args(video, behavior, pupil), 64, 64, 0.0)
        anchors = gen.behind + torch.arange(padded, device="cuda")
        valid = (anchors < TRIAL_LENGTH - gen.ahead).float().view(-1, CHUNK)
        offsets = torch.arange(-gen.behind, gen.ahead + 1, gen.step, device="cuda")
        windows = (anchors[:, None] + offsets).clamp(0, padded - 1).view(-1, CHUNK, gen.size)
        resp = torch.zeros((live.model.readout_outputs[0], padded), device="cuda")
        blend = torch.zeros(padded, device="cuda")
        for chunk_windows, chunk_valid in zip(windows, valid):
            flat, r, b = chunk_updates([live.model], [stack], chunk_windows, live.blend_weights, 0, chunk_valid)
            resp.index_add_(1, flat, r)
            blend.index_add_(0, flat, b)
        return (resp / blend.clamp(min=1.0))[:, :TRIAL_LENGTH].cpu().numpy()

    through_artifact(*warm)
    live.predict_trial(*warm, mouse_index=0)
    reset_launches()
    got, artifact_s = timed(lambda: [through_artifact(*trial) for trial in trials])
    launches = dict(dw_kernels.LAUNCHES)
    expected, live_s = timed(lambda: [live.predict_trial(*trial, mouse_index=0) for trial in trials])
    diff_replay = max(float(np.max(np.abs(g - replay(*trial)))) for g, trial in zip(got, trials))
    windows = len(gen.valid_anchors(TRIAL_LENGTH))
    # Frames [0, same) see only windows of chunks that the artifact and the
    # live Predictor fill alike (32 valid anchors each); later frames also see
    # the last chunk, 14 windows in the live Predictor and 32 (18 of zero
    # weight) in the artifact, so its bf16 products may round otherwise.
    same = windows // CHUNK * CHUNK
    other = Predictor(checkpoint, chunk_size=EXPORT_OTHER_CHUNK, device="cuda")
    spread = max(float(np.max(np.abs(other.predict_trial(*trial, mouse_index=0)[:, same:] - e[:, same:])))
                 for trial, e in zip(trials, expected))
    del other
    scale = max(float(np.max(np.abs(e))) for e in expected)
    diff_same = max(float(np.max(np.abs(g[:, :same] - e[:, :same]))) for g, e in zip(got, expected))
    diff_rest = max(float(np.max(np.abs(g[:, same:] - e[:, same:]))) for g, e in zip(got, expected))
    chunks = padded // CHUNK
    body_calls = scan_body_calls(chunks)
    result["serve"] = {
        "requests": REQUESTS, "padded_length": padded, "chunks_per_request": chunks,
        "scan_body_calls_per_request": body_calls, "max_abs_live": scale, "max_abs_diff_replay": diff_replay,
        "max_abs_diff_same_chunks": diff_same, "max_abs_diff_other_frames": diff_rest,
        "relative_same_chunks": diff_same / scale, "relative_other_frames": diff_rest / scale,
        f"live_chunk_{EXPORT_OTHER_CHUNK}_max_abs_diff": spread,
        "artifact_windows_per_second": REQUESTS * windows / artifact_s,
        "live_windows_per_second": REQUESTS * windows / live_s, "launches": launches,
    }
    print(f"export: {REQUESTS} requests x {windows} windows through the trial artifact (padded to {padded} "
          f"frames, {chunks} chunks each, the eager scan runs its body {body_calls} times) at "
          f"{result['serve']['artifact_windows_per_second']:.1f} windows/s, the live Predictor at "
          f"{result['serve']['live_windows_per_second']:.1f} windows/s; max |live| {scale:.4g}; against the "
          f"program replayed eagerly on the live model max |diff| {diff_replay:.4g} (relative "
          f"{diff_replay / scale:.3g}, tolerance {EXPORT_REL_TOL}); against the live Predictor max |diff| on frames "
          f"0-{same - 1} {diff_same:.4g} (relative {diff_same / scale:.3g}, tolerance {EXPORT_REL_TOL}), on frames "
          f"{same}-{TRIAL_LENGTH - 1} {diff_rest:.4g} (relative {diff_rest / scale:.3g}; the live Predictor at chunk "
          f"{EXPORT_OTHER_CHUNK} against itself at chunk {CHUNK} there: {spread:.4g}, relative {spread / scale:.3g}); "
          f"launches {launches}", flush=True)
    for i, out in enumerate(got):
        if out.shape != expected[i].shape or not np.all(np.isfinite(out)):
            fail(f"export: request {i} gave {out.shape}, expected finite {expected[i].shape}")
    if not (diff_replay <= EXPORT_REL_TOL * scale and diff_same <= EXPORT_REL_TOL * scale):
        fail("export: the trial artifact differs from its program run eagerly or from the live Predictor")
    check_forward_launches("export", launches, REQUESTS * body_calls)
    del live, artifacts

    # The fp32 window forward of mouse 0, traced on the card: on the card
    # against the live model, and moved to the CPU.
    fp32 = work / "model-fp32.ckpt"
    fp32_checkpoint(checkpoint, fp32)
    path = work / "window_fp32.pt2"
    export_model_file(fp32, path, mouse_index=0, device="cuda")
    video, behavior, pupil = make_trial(np.random.default_rng(SEED + 1))  # phase 5's two windows
    stack = assemble_trial_stack(torch.from_numpy(np.ascontiguousarray(video.transpose(2, 0, 1))),
                                 torch.from_numpy(behavior), torch.from_numpy(pupil), 64, 64, 0.0)
    indexer = WindowIndexer(FRAMES, FLAGSHIP_ARGUS["frame_stack"]["step"])
    windows = torch.from_numpy(indexer.windows([indexer.behind, TRIAL_LENGTH - 1]))
    batch = stack.index_select(1, windows.reshape(-1)).view(5, 2, FRAMES, 64, 64).transpose(0, 1).contiguous()
    with torch.inference_mode():
        card = load_exported(path, device="cuda")(batch.cuda()).cpu()
        live_card = load_model(fp32, device="cuda").predict(batch.numpy(), mouse_index=0).cpu()
        cpu = load_exported(path, device="cpu")(batch)
    diff_live, diff, cpu_max = float((card - live_card).abs().max()), float((card - cpu).abs().max()), \
        float(cpu.abs().max())
    result["fp32_window"] = {"max_abs_diff_live_card": diff_live, "max_abs_diff_cpu": diff, "max_abs_cpu": cpu_max,
                             "relative_cpu": diff / cpu_max, "tolerance_cpu": CPU_REL_TOL}
    print(f"export: the card-traced fp32 window artifact, 2 windows: against the live model on the card max |diff| "
          f"{diff_live:.4g}; moved to the CPU, against the card max |diff| {diff:.4g}, max |cpu| {cpu_max:.4g}, "
          f"relative {diff / cpu_max:.3g} (tolerance {CPU_REL_TOL})", flush=True)
    if diff_live != 0.0:
        fail(f"export: the fp32 window artifact differs from the live model on the card by {diff_live}")
    if not (np.isfinite(diff) and diff <= CPU_REL_TOL * cpu_max):
        fail(f"export: the artifact on the CPU differs from the card by {diff / cpu_max} relative")
    record["serving_export"] = result
    torch.cuda.empty_cache()
    return launches


def mesh_devices(count: int, cards: int) -> list[str]:
    """``count`` devices of a mesh over ``cards`` cards: card i % cards."""
    return [f"cuda:{i % cards}" for i in range(count)]


def chunk_forwards(windows: int, chunk: int, replicas: int) -> int:
    """Window forwards a trial: each chunk split over the replicas."""
    return sum(min(replicas, windows - start, chunk) for start in range(0, windows, chunk))


def graph_devices(program) -> set[str]:
    """Every device an exported program's graphs name in their nodes' arguments."""
    import torch

    named = set()
    for module in program.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            for node in module.graph.nodes:
                named.update(str(v) for v in [*node.args, *node.kwargs.values()] if isinstance(v, torch.device))
    return named


def serving_mesh(record: dict, checkpoint: Path, work: Path, cards: int = 1) -> dict:
    """Phase 19 (the module docstring): 19a ``Predictor`` over a model axis,
    19b the multi-device trial artifact, 19c ``dryrun_multichip``, over
    ``cards`` cards (card 0 repeated where a mesh has more devices).
    Returns each part's kernel launches."""
    import numpy as np
    import torch

    from sensorium_tpu_torch.infer.export import export_trial, load_exported, save_exported
    from sensorium_tpu_torch.infer.predictor import Predictor, assemble_trial_stack, replica_forwards
    from sensorium_tpu_torch.ops import dw_kernels
    from sensorium_tpu_torch.parallel import mesh as mesh_lib
    from sensorium_tpu_torch.parallel.tensor import LocalSlices
    from sensorium_tpu_torch.tools.dryrun import dryrun_multichip

    def timed(fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        return value, time.perf_counter() - start

    result: dict = {"card": nvidia_smi_line(), "cards": cards}
    launches: dict = {}
    rng = np.random.default_rng(SEED)  # phase 4's requests
    warm = make_trial(rng)
    trials = [make_trial(rng) for _ in range(REQUESTS)]
    one = Predictor(checkpoint, chunk_size=CHUNK, length_bucket=EXPORT_BUCKET, device="cuda")
    windows = len(one.indexes_generator.valid_anchors(TRIAL_LENGTH))
    same = windows // CHUNK * CHUNK  # frames [0, same) see only windows of full chunks
    one.predict_trial(*warm, mouse_index=0)
    want, one_s = timed(lambda: [one.predict_trial(*trial, mouse_index=0) for trial in trials])
    scale = max(float(np.max(np.abs(w))) for w in want)
    result["one_card_windows_per_second"] = REQUESTS * windows / one_s
    staged = one.stage_trial(*warm)
    stack = assemble_trial_stack(*staged.trial_args, 64, 64, 0.0)
    chunk_windows = staged.windows[:CHUNK]

    def enqueue_ms(predictor) -> dict:
        """One chunk's replica forwards: the host's milliseconds until they
        are queued, and until every card has run them (medians of 5)."""
        models = [model for model, _ in predictor.replicas]
        inputs = [stack.to(device) for _, device in predictor.replicas]
        host, wall = [], []
        with torch.inference_mode():
            for _ in range(6):
                for card in range(cards):
                    torch.cuda.synchronize(card)
                start = time.perf_counter()
                replica_forwards(models, inputs, chunk_windows, 0)
                queued = time.perf_counter()
                for card in range(cards):
                    torch.cuda.synchronize(card)
                host.append((queued - start) * 1e3)
                wall.append((time.perf_counter() - start) * 1e3)
        return {"host_ms": statistics.median(host[1:]), "wall_ms": statistics.median(wall[1:])}

    result["one_card_chunk"] = enqueue_ms(one)

    # 19a: Predictor over (data, model) meshes.
    for num_data, num_model in SERVE_MESHES:
        label = f"data{num_data}_model{num_model}"
        mesh = mesh_lib.create_mesh(num_data, num_model, devices=mesh_devices(num_data * num_model, cards))
        sharded = Predictor(checkpoint, chunk_size=CHUNK, mesh=mesh)
        reference = one if num_data == 1 else Predictor(checkpoint, chunk_size=CHUNK // num_data, device="cuda")
        sharded.predict_trial(*warm, mouse_index=0)
        reset_launches()
        got, sharded_s = timed(lambda: [sharded.predict_trial(*trial, mouse_index=0) for trial in trials])
        counted = dict(dw_kernels.LAUNCHES)
        expected = [reference.predict_trial(*trial, mouse_index=0) for trial in trials] if num_data > 1 else want
        diff_same = max(float(np.max(np.abs(g[:, :same] - e[:, :same]))) for g, e in zip(got, expected))
        diff_rest = max(float(np.max(np.abs(g[:, same:] - e[:, same:]))) for g, e in zip(got, expected))
        diff_one = max(float(np.max(np.abs(g - w))) for g, w in zip(got, want))
        module = sharded.replicas[0][0]
        slices = {name: [{"device": str(piece.device), "bytes": piece.numel() * piece.element_size()} for piece in sub]
                  for name, sub in module.named_modules() if isinstance(sub, LocalSlices)}
        whole_bytes = {name: sum(p["bytes"] for p in pieces) for name, pieces in slices.items()}
        forwards = REQUESTS * chunk_forwards(windows, CHUNK, num_data)
        chunk_ms = enqueue_ms(sharded)
        entry = {"mesh": dict(mesh.shape), "devices": [str(d) for d in mesh.devices], "replicas": len(sharded.replicas),
                 "chunk": chunk_ms,
                 "windows_per_second": REQUESTS * windows / sharded_s, "reference_chunk": reference.chunk_size,
                 "max_abs_diff_same_chunks": diff_same, "max_abs_diff_other_frames": diff_rest,
                 "max_abs_diff_one_card_chunk_32": diff_one, "max_abs_one_card": scale,
                 "relative_same_chunks": diff_same / scale, "sliced_bytes": slices, "whole_bytes": whole_bytes,
                 "chunk_forwards": forwards, "launches": counted}
        result[label] = entry
        readout = slices["readout_kernel"]
        print(f"serve mesh 19a: {mesh.shape} over {entry['devices']}: {REQUESTS} requests x {windows} windows at "
              f"{entry['windows_per_second']:.1f} windows/s (one card, chunk {CHUNK}: "
              f"{result['one_card_windows_per_second']:.1f}); against one card at chunk {reference.chunk_size} max "
              f"|diff| on frames 0-{same - 1} {diff_same:.4g} (relative {diff_same / scale:.3g}, tolerance "
              f"{EXPORT_REL_TOL}), on frames {same}-{TRIAL_LENGTH - 1} {diff_rest:.4g}; against one card at chunk "
              f"{CHUNK} on every frame {diff_one:.4g} (relative {diff_one / scale:.3g}); readout_kernel "
              f"{whole_bytes['readout_kernel'] / 1e9:.4f} GB as {[(p['device'], p['bytes']) for p in readout]}, "
              f"cortex_2.kernel {[(p['device'], p['bytes']) for p in slices['cortex_2.kernel']]}; one chunk's "
              f"forwards queued by the host in {chunk_ms['host_ms']:.1f} ms, done in {chunk_ms['wall_ms']:.1f} ms "
              f"(one card's chunk-32 forward: {result['one_card_chunk']['host_ms']:.1f} / "
              f"{result['one_card_chunk']['wall_ms']:.1f} ms); launches {counted} over {forwards} window forwards",
              flush=True)
        for i, out in enumerate(got):
            if out.shape != want[i].shape or not np.all(np.isfinite(out)):
                fail(f"serve mesh 19a {label}: request {i} gave {out.shape}, expected finite {want[i].shape}")
        if not diff_same <= EXPORT_REL_TOL * scale:
            fail(f"serve mesh 19a {label}: {diff_same / scale:.3g} relative from one card, tolerance {EXPORT_REL_TOL}")
        if any(len(pieces) != num_model or len({p["bytes"] for p in pieces}) != 1 for pieces in slices.values()):
            fail(f"serve mesh 19a {label}: the sliced weights are not {num_model} equal slices: {slices}")
        check_forward_launches(f"serve mesh 19a {label}", counted, forwards)
        launches[f"serve_mesh_{label}"] = counted
        del sharded, reference
        torch.cuda.empty_cache()

    # 19b: the trial program over a data mesh as one artifact.
    padded = math.ceil(TRIAL_LENGTH / EXPORT_BUCKET) * EXPORT_BUCKET
    pad = padded - TRIAL_LENGTH
    body_calls = scan_body_calls(padded // CHUNK)
    one_card = work / "trial.pt2"  # phase 17's trial artifact
    if not one_card.exists():  # --cards runs phase 19 without phase 17
        save_exported(one_card, export_trial(one, 0, src_hw=tuple(FIT_VIDEO)))
    single_bytes, single_stored, single_parts = one_card.stat().st_size, stored_bytes(one_card), archive_parts(one_card)
    result["one_card_artifact"] = {"bytes": single_bytes, "stored_tensor_bytes": single_stored, "parts": single_parts}
    for num_data, num_model in ARTIFACT_MESHES + (((2, 2),) if cards > 1 else ()):
        label = f"artifact_data{num_data}_model{num_model}"
        mesh = mesh_lib.create_mesh(num_data, num_model, devices=mesh_devices(num_data * num_model, cards))
        live = Predictor(checkpoint, chunk_size=CHUNK, length_bucket=EXPORT_BUCKET, mesh=mesh)
        path = work / f"{label}.pt2"
        exported, export_s = timed(lambda: export_trial(live, 0, src_hw=tuple(FIT_VIDEO)))
        named = graph_devices(exported.program)
        _, save_s = timed(lambda: save_exported(path, exported))
        del exported
        stored, parts = stored_bytes(path), archive_parts(path)
        artifact, load_s = timed(lambda: load_exported(path, device="cuda"))

        def through_artifact(video, behavior, pupil):
            args = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
                np.pad(video.transpose(2, 0, 1), ((0, pad), (0, 0), (0, 0))), np.pad(behavior, ((0, 0), (0, pad))),
                np.pad(pupil, ((0, 0), (0, pad))))]
            with torch.inference_mode():
                out = artifact(*args, torch.tensor(TRIAL_LENGTH, dtype=torch.int32, device="cuda"))
            return out[:, :TRIAL_LENGTH].cpu().numpy()

        through_artifact(*warm)
        reset_launches()
        got, artifact_s = timed(lambda: [through_artifact(*trial) for trial in trials])
        counted = dict(dw_kernels.LAUNCHES)
        expected, live_s = timed(lambda: [live.predict_trial(*trial, mouse_index=0) for trial in trials])
        diff_same = max(float(np.max(np.abs(g[:, :same] - e[:, :same]))) for g, e in zip(got, expected))
        diff_rest = max(float(np.max(np.abs(g[:, same:] - e[:, same:]))) for g, e in zip(got, expected))
        forwards = REQUESTS * body_calls * num_data
        entry = {"mesh": dict(mesh.shape), "devices": [str(d) for d in mesh.devices], "nr_devices": artifact.nr_devices,
                 "graph_devices": sorted(named), "trace_seconds": export_s, "save_seconds": save_s,
                 "load_seconds": load_s, "bytes": path.stat().st_size, "one_card_bytes": single_bytes,
                 "stored_tensor_bytes": stored, "one_card_stored_tensor_bytes": single_stored, "parts": parts,
                 "artifact_windows_per_second": REQUESTS * windows / artifact_s,
                 "live_windows_per_second": REQUESTS * windows / live_s, "max_abs_diff_same_chunks": diff_same,
                 "max_abs_diff_other_frames": diff_rest, "relative_same_chunks": diff_same / scale,
                 "scan_body_calls_per_request": body_calls, "launches": counted}
        result[label] = entry
        print(f"serve mesh 19b: the trial artifact over {mesh.shape} ({entry['devices']}, nr_devices "
              f"{artifact.nr_devices}, graph devices {sorted(named)}): traced in {export_s:.1f} s, written in "
              f"{save_s:.1f} s, {entry['bytes'] / 1e9:.4f} GB (the one-card trial artifact: {single_bytes / 1e9:.4f} "
              f"GB), its stored tensors {stored:,} B (one card's: {single_stored:,} B), its archive by part {parts} "
              f"(one card's: {single_parts}), loaded in "
              f"{load_s:.1f} s; {REQUESTS} requests at {entry['artifact_windows_per_second']:.1f} windows/s, the "
              f"live sharded Predictor at {entry['live_windows_per_second']:.1f}; against it max |diff| on frames "
              f"0-{same - 1} {diff_same:.4g} (relative {diff_same / scale:.3g}, tolerance {EXPORT_REL_TOL}), on "
              f"frames {same}-{TRIAL_LENGTH - 1} {diff_rest:.4g}; launches {counted} ({body_calls} scan body calls "
              f"x {num_data} replica forwards a request)", flush=True)
        for i, out in enumerate(got):
            if out.shape != expected[i].shape or not np.all(np.isfinite(out)):
                fail(f"serve mesh 19b {label}: request {i} gave {out.shape}, expected finite {expected[i].shape}")
        if named != {str(d) for d in mesh.devices}:
            fail(f"serve mesh 19b {label}: the graph names {sorted(named)}, the mesh {entry['devices']}")
        if stored > single_stored:
            fail(f"serve mesh 19b {label}: the artifact stores {stored:,} B of tensors, the one-card one "
                 f"{single_stored:,} B: a replica's weights are stored twice")
        if artifact.nr_devices != num_data * num_model or not diff_same <= EXPORT_REL_TOL * scale:
            fail(f"serve mesh 19b {label}: nr_devices {artifact.nr_devices}, {diff_same / scale:.3g} relative from "
                 "the live sharded Predictor")
        check_forward_launches(f"serve mesh 19b {label}", counted, forwards)
        launches[f"serve_mesh_{label}"] = counted
        del artifact, live
        path.unlink()
        torch.cuda.empty_cache()
    del one
    torch.cuda.empty_cache()

    # 19c: one sharded flagship step from the dry run's entry point.
    ranks = DRYRUN_RANKS if cards == 1 else min(cards, 4)
    dry, dry_s = timed(lambda: dryrun_multichip(ranks, flagship=True, share_card=cards == 1))
    result["dryrun"] = {**dry, "seconds": dry_s}
    print(f"serve mesh 19c: dryrun_multichip({ranks}) over {'one card shared' if cards == 1 else f'{ranks} cards'}"
          f": mesh {dry['mesh']}, loss {dry['loss']!r} against unsharded {dry['unsharded_loss']!r}, the sharded "
          f"step {dry['step_seconds']:.2f} s (first step), the call {dry_s:.1f} s; launches a rank "
          f"{dry['launches']}", flush=True)
    launches["dryrun"] = dry["launches"]
    record["serving_mesh"] = result
    return launches


def bench_on_card(record: dict) -> None:
    """Phase 20 (the module docstring): ``tools/bench.py``'s headline and
    ``--infer`` as children, held to phases 7 and 4."""
    import torch

    torch.cuda.empty_cache()  # the children need the card's memory
    per_chunk = {"dw_spatial_fwd_bn": len(FLAGSHIP_NN_MODULE[1]["core_features"]),
                 "dw_temporal_fwd_bn": len(FLAGSHIP_NN_MODULE[1]["core_features"])}
    result = {}
    for label, flags, metric, launch_key, launches, reference, phase in (
        ("train", [], "train_clips_per_sec_per_chip_b32_fwd_bwd", "kernel_launches_per_step",
         expected_train_launches(), record["train"]["clips_per_second"], "phase 7"),
        ("infer", ["--infer"], "infer_window_forwards_per_sec", "kernel_launches_per_chunk_forward",
         per_chunk, record["serve"]["windows_per_second"], "phase 4"),
    ):
        command = [sys.executable, "-m", "sensorium_tpu_torch.tools.bench", *flags]
        start = time.perf_counter()
        try:
            proc = subprocess.run(command, cwd=REPO, capture_output=True, text=True, timeout=BENCH_TIMEOUT)
        except subprocess.TimeoutExpired:
            fail(f"bench {label}: no result within {BENCH_TIMEOUT} s")
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            fail(f"bench {label}: exit {proc.returncode}:\n{proc.stdout[-1500:]}\n{proc.stderr[-3000:]}")
        try:
            line = json.loads(proc.stdout.strip().splitlines()[-1])
        except (json.JSONDecodeError, IndexError):
            fail(f"bench {label}: the last line is not the contract's JSON:\n{proc.stdout[-1500:]}")
        detail = line.get("detail", {})
        print(f"bench: {label} in {seconds:.1f} s: {json.dumps(line)}", flush=True)
        numbers = [line.get("value"), line.get("vs_baseline"), detail.get("peak_memory_gb")]
        if line.get("metric") != metric or not all(isinstance(v, (int, float)) and math.isfinite(v) for v in numbers):
            fail(f"bench {label}: metric {line.get('metric')!r} (expected {metric!r}), value, vs_baseline and "
                 f"peak_memory_gb {numbers} must be finite numbers")
        if detail.get("dw_impl") != "cuda" or detail.get("card") != record["device"]["nvidia_smi"]:
            fail(f"bench {label}: dw_impl {detail.get('dw_impl')!r} (expected 'cuda'), card {detail.get('card')!r}")
        if detail.get(launch_key) != launches:
            fail(f"bench {label}: {launch_key} {detail.get(launch_key)}, expected {launches}")
        ratio = line["value"] / reference
        print(f"bench: {label}: {line['value']} {line['unit']} against {reference:.3f} in {phase}: ratio "
              f"{ratio:.3f}", flush=True)
        if ratio < BENCH_MIN_RATIO:
            fail(f"bench {label}: {ratio:.3f} of {phase}'s rate, below {BENCH_MIN_RATIO}: it measures another program")
        result[label] = {"line": line, "seconds": seconds, "ratio": ratio}
    record["bench"] = result


def cards_only(record: dict, out_dir: Path) -> None:
    """``--cards``: the parts that need two cards or more, alone: 18c on
    phase 11's dataset and phase 15's configs, then phase 19 over 2-4 cards
    from a checkpoint of the flagship's seeded weights; fails with fewer
    than two cards."""
    import os

    import torch

    from sensorium_tpu_torch.engine.model import MouseModel

    cards = torch.cuda.device_count()
    if cards < 2:
        fail(f"--cards needs two cards or more; {cards} visible")
    root = out_dir / "fit_data"
    write_fit_dataset(root)
    os.environ["SENSORIUM_FOLD_ASSIGNMENT"] = "trial"
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            work = Path(work)
            write_cli_configs(work / "train_cli_configs")
            mesh_tp_cards(record, root, work)
            model = MouseModel(FLAGSHIP_TRAIN_ARGUS, device="cuda")
            model.set_ema(EMA_DECAY)
            model.build_state(seed=SEED, learning_rate=FLAGSHIP_TRAIN_ARGUS["optimizer"][1]["lr"])
            model.save(work / EXPORT_CHECKPOINT)
            del model
            torch.cuda.empty_cache()
            serving_mesh(record, work / EXPORT_CHECKPOINT, work, cards=min(cards, 4))
    finally:
        shutil.rmtree(root)


def _summed(rows: list[dict], name: str) -> dict:
    """Times and bound of ``name`` summed over the flagship blocks' calls (bf16 rows)."""
    flagship = [r for r in rows if r["kernel"] == name and r["dtype"] == "bfloat16" and r["blocks"]]

    def total(key):
        return sum(r[key] * len(r["blocks"]) for r in flagship)

    summed = {
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == name),
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "bytes" if total("bytes_ms") >= total("ops_ms") else "operations",
        "library_ms": total("library_ms"),
    }
    if "library2d_ms" in flagship[0]:
        summed["library2d_ms"], summed["library3d_ms"] = total("library2d_ms"), total("library3d_ms")
    if "fwd_ms" in flagship[0]:
        summed["dw_spatial_fwd_ms"] = total("fwd_ms")
    return summed


def kernel_summary(rows: list[dict], launches: dict, serve_launches: dict, fused_rows: list[dict],
                   fused_launches: dict, path_launches: dict, bn: dict, prologue_rows: list[dict]) -> list[dict]:
    """One entry per kernel: sums over the calls of one flagship training step
    (batch 32 x 16 frames, the shapes of a 32-window chunk forward), bf16.
    ``launches`` counts the timed train steps, ``launches_serve`` the counted
    serving run, ``launches_<path>`` the runs of phases 12-18; the fused
    kernel's launches are the dwbench run's."""
    replaces = {
        "dw_spatial_fwd": ("dw_conv.cu", "sensorium_tpu/ops/pallas_dw.py:115"),
        "dw_temporal_fwd": ("dw_conv.cu", "sensorium_tpu/ops/pallas_dw.py:355"),
        "dw_spatial_dx": ("dw_conv_bwd.cu", "sensorium_tpu/ops/pallas_dw.py:313"),
        "dw_spatial_dw": ("dw_conv_bwd.cu", "sensorium_tpu/ops/pallas_dw.py:216"),
        "dw_temporal_dw": ("dw_conv_bwd.cu", "sensorium_tpu/ops/pallas_dw.py:404"),
    }
    out = []
    for name, (source, replaced) in replaces.items():
        out.append({
            "name": name,
            "route": "cuda",
            "source": f"sensorium_tpu_torch/csrc/{source}",
            "replaces": replaced,
            "launches": launches[name],
            **_summed(rows, name),
            "library_note": "library_ms is, per shape, the faster cuDNN lowering of the same op: the grouped "
                            "conv3d, or conv2d(groups=C) on the channels-last (B*T, C, H, W) view (temporal: "
                            "kernel (k, 1) on (B, C, T, H*W)); backward kernels through aten.convolution_backward "
                            "asked for that one gradient; both sums are recorded",
            "scope": "sum over the 9 blocks' calls of one flagship train step (32 clips x 16 frames), bf16; "
                     f"launches over {TIMED_STEPS} train steps",
            "launches_serve": serve_launches[name],
            **{f"launches_{path}": counts[name] for path, counts in path_launches.items()},
        })
    name = "fused_bn_silu_dw_spatial"
    out.append({
        "name": name,
        "route": "cuda",
        "source": "sensorium_tpu_torch/csrc/fused_bn_silu_dw.cu",
        "replaces": "sensorium_tpu/ops/pallas_fused.py:128",
        "launches": fused_launches[name],
        **_summed(fused_rows, name),
        "library_note": "no single PyTorch call computes this function: library_ms is, per shape, the faster "
                        "eager chain, silu(addcmul) -> F.conv3d(groups=C) or -> F.conv2d(groups=C); "
                        "dw_spatial_fwd_ms is the spatial forward kernel alone on the same x and w",
        "scope": "sum over the 9 blocks' BN -> SiLU -> spatial dw of one flagship chunk forward "
                 "(32 windows x 16 frames), bf16; launches in the dwbench run (phase 10)",
    })
    for name in ("dw_spatial_fwd_bn", "dw_temporal_fwd_bn"):
        flagship = [r for r in prologue_rows if r["kernel"] == name and r["dtype"] == "bfloat16"]
        out.append({
            "name": name,
            "route": "cuda",
            "source": "sensorium_tpu_torch/csrc/dw_conv.cu (with bn_act.cuh)",
            "replaces": "none: XLA fuses sensorium_tpu/ops/norm.py BatchNorm and nn.silu into the conv's input",
            **{key: sum(r[key] * len(r["blocks"]) for r in flagship)
               for key in ("ms", "plain_kernel_ms", "bn_ms", "chain_ms", "bound_ms")},
            "bitwise_chain": all(r["bitwise_chain"] for r in prologue_rows if r["kernel"] == name),
            "launches_serve": serve_launches[name],
            **{f"launches_{path}": counts[name] for path, counts in path_launches.items() if name in counts},
            "scope": "sum over the 9 blocks' calls of one flagship chunk forward (32 windows x 16 frames), bf16; "
                     "plain_kernel_ms is the plain conv alone on BN's output, chain_ms the BN pass and it",
        })
    out.append({
        "name": "bn_act",
        "route": "cuda",
        "source": "sensorium_tpu_torch/csrc/bn_act.cu",
        "replaces": "none: XLA fuses sensorium_tpu/ops/norm.py BatchNorm and nn.silu",
        "train_step": bn["step"],
        "chunk_forward": bn["chunk"],
        "library_note": "library_ms is F.batch_norm + F.silu on the (rows, C) view, forward and backward "
                        "through autograd for the step (block 1's rerun left out), the eval forward for the chunk",
        "scope": "sum over the 52 BNs of one flagship train step (with block 1's 5 rerun forwards) and of one "
                 "chunk forward (32 windows x 16 frames), bf16; kernels timed from CUDA graph replays",
    })
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=REPO / "build" / "chip_smoke",
                        help="directory for chip_smoke.json and chip_smoke_trace.json")
    parser.add_argument("--mesh-child", choices=["reference", *(f"rank{r}" for r in range(MESH_WORLD)),
                                                 "tp_reference", *(f"tp_rank{r}" for r in range(TP_WORLD))],
                        help=argparse.SUPPRESS)  # phases 16a's and 18a's child processes, which write into --out
    parser.add_argument("--port", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--cards", action="store_true",
                        help="run only the parts that need several cards: 18c (cli.train over a model axis of "
                             "every card against one card, in fp32) and phase 19 over 2-4 cards (serving over a "
                             "model axis, the multi-device artifact, the dry run); fails with fewer than two cards")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    if not (REPO / "sensorium_tpu_torch" / "csrc").is_dir():
        fail(f"no sensorium_tpu_torch/csrc beside {Path(__file__).name}: run it from a checkout of the repo")
    if args.mesh_child == "reference":
        mesh_reference(args.out)
        return 0
    if args.mesh_child == "tp_reference":
        mesh_reference(args.out, TP_BATCH, "tp_reference.pt")
        return 0
    if args.mesh_child:
        if args.mesh_child.startswith("tp_rank"):
            tp_rank(args.out, int(args.mesh_child.removeprefix("tp_rank")), args.port)
        else:
            mesh_rank(args.out, int(args.mesh_child.removeprefix("rank")), args.port)
        return 0
    torch.backends.cudnn.allow_tf32 = False  # every fp32 comparison runs without TF32
    torch.backends.cuda.matmul.allow_tf32 = False

    record: dict = {}
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {smi}", flush=True)
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
          f"{torch.cuda.device_count()} visible", flush=True)
    record["device"] = {"nvidia_smi": smi, "kind": kind, "torch": torch.__version__, "cuda": torch.version.cuda}
    peaks = card_peaks(kind)

    from sensorium_tpu_torch.ops import _build

    start = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - start
    for name, info in built.items():
        print(f"build: {name}.cu in {info['seconds']:.1f} s", flush=True)
        for line in ptxas_summary(info["log"]):
            print(f"build:   {line}", flush=True)
    print(f"build: {len(built)} sources compiled in {build_s:.1f} s", flush=True)
    record["build_seconds"] = build_s

    args.out.mkdir(parents=True, exist_ok=True)
    if args.cards:
        cards_only(record, args.out)
        (args.out / "chip_smoke.json").write_text(json.dumps(record, indent=1))
        print(f"device: {smi}")
        print("cards: only phase 18c and phase 19 ran", flush=True)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                                 "count": torch.cuda.device_count()}}))
        return 0
    rows = check_kernels(peaks)
    record["kernels"] = rows
    record["prologue_kernels"] = check_prologue_kernels(peaks)
    serve_launches = serve(record, args.out)
    card_against_cpu(record)
    backward_rows = check_backward_kernels(peaks)
    record["backward_kernels"] = backward_rows
    train_launches = train(record, args.out)
    train_card_against_cpu(record)
    fused_rows = check_fused_kernel(peaks)
    record["fused_kernel"] = fused_rows
    record["bn_kernels"] = check_bn_kernels(peaks)
    fused_launches = run_dwbench(record)
    fit_root = fit(record, args.out)
    # Checkpoints, train states and the prediction tree are written outside --out.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        work = Path(work)
        path_launches = {}
        for name, key, phase in (("import", "import_proof", lambda: import_proof(record, work)),
                                 ("resume", "checkpoints", lambda: checkpoints(record, work)),
                                 ("submission", "submission_flow", lambda: submission_flow(record, fit_root, work)),
                                 ("train_cli", "train_cli", lambda: train_cli(record, fit_root, work)),
                                 ("multihost_cli", "multihost_cli", lambda: multihost_cli(record, fit_root, work))):
            start = time.perf_counter()
            path_launches[name] = phase()
            record[key]["phase_seconds"] = time.perf_counter() - start
            print(f"{key}: phase took {record[key]['phase_seconds']:.1f} s", flush=True)
        path_launches["train_cli_distill"] = record["train_cli"]["distill_launches"]
        start = time.perf_counter()
        path_launches.update(mesh_library(record, work))
        mesh_cards_cli(record, fit_root, work)
        print(f"mesh: 16a and 16c took {time.perf_counter() - start:.1f} s", flush=True)
        start = time.perf_counter()
        path_launches["export"] = serving_export(record, work / EXPORT_CHECKPOINT, work)
        record["serving_export"]["phase_seconds"] = time.perf_counter() - start
        print(f"serving_export: phase took {record['serving_export']['phase_seconds']:.1f} s", flush=True)
        start = time.perf_counter()
        path_launches.update(mesh_tp(record, work))
        mesh_tp_cards(record, fit_root, work)
        print(f"tp: 18a, 18b and 18c took {time.perf_counter() - start:.1f} s", flush=True)
        start = time.perf_counter()
        path_launches.update(serving_mesh(record, work / EXPORT_CHECKPOINT, work))
        record["serving_mesh"]["phase_seconds"] = time.perf_counter() - start
        print(f"serve mesh: phase 19 took {record['serving_mesh']['phase_seconds']:.1f} s", flush=True)
    shutil.rmtree(fit_root)  # made anew from the seed by every run
    start = time.perf_counter()
    bench_on_card(record)
    record["bench"]["phase_seconds"] = time.perf_counter() - start
    print(f"bench: phase 20 took {record['bench']['phase_seconds']:.1f} s", flush=True)

    summary = kernel_summary(rows + backward_rows, train_launches, serve_launches, fused_rows, fused_launches,
                             path_launches, record["bn_kernels"], record["prologue_kernels"])
    record["summary"] = summary
    (args.out / "chip_smoke.json").write_text(json.dumps(record, indent=1))

    print(json.dumps({"kernels": summary}))
    print(f"device: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
