#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (ocl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits non-zero:
  1. device  — require CUDA; print the card and `nvidia-smi` name, power limit;
  2. build   — build the port's CUDA kernel (pairwise_sqdist) from the checkout,
               print nvcc's register, shared-memory and spill report, and hold
               the launch plan's blocks per SM against CUDA's occupancy
               calculator;
  3. kernel  — the kernel against its plain torch version (both TF32 switches
               off): max relative error <= 1e-5 and max absolute error <= 1e-3
               at the ASER shapes, a ragged D, a view that starts one float
               into its storage (both take 4-byte copies), D = 2048 (over
               48 KB of shared memory), D = 4096 and 4099 (slabs of D through
               a ring of two) and 1000 x 1000 x 640 (many waves); an exact 0
               on the diagonal of pairwise_sqdist(a, a); a non-contiguous
               input must raise. Then, per ASER shape, three times of the kernel, of its
               plain version, of the launch floor and of torch.cdist (the
               nearest library call: it returns the root), with the bound:
                 device  — 100 calls in one CUDA graph, replayed (card time);
                 enqueue — CUDA events around 100 eager calls (issue rate);
                 host    — host clock per eager call, no sync (Python cost);
               and the kernel's time by name from torch.profiler at one shape;
  4. main    — ER with ASER update + retrieval through the port's CLI at the
               full width of Reduced ResNet-18 (nf 20), 2 tasks x 100 steps
               of the synthetic stream (5 classes a task; cut from 5 tasks
               for the script's time); the kernel must have launched,
               and Avg_End_Acc must be finite and above 0.5. Then 20 steps
               with a full buffer (every step takes the SV paths) of the
               5-task stream under torch.profiler: the kernel's device time
               and launches per step;
  5. er      — one task of plain ER (random update + retrieval, two-pass) on
               the same stream; its accuracy on that task must exceed 0.5;
  6-12.      — the rest of the replay family through the port's agents on the
               same stream at nf 20, each on its own line: fused ER with the
               default flags (one task), ER + MIR (--subsample 50), ER + GSS
               (gss_mem_strength 10, gss_batch_size 10; how many full-buffer
               steps replaced a slot, which must be > 0), AGEM, EWC++, LwF, and
               ER with separated_softmax, kd_trick, review_trick and ncm_trick
               (two tasks each; fused ER, MIR, AGEM and the tricks at 250
               images a class, 50 steps a task: the script's time). Every accuracy must be finite and the latest
               task's above 0.5; each line gives images/s, then launches and
               device ms a step over more steps (20 fused, 5 in the others) under
               torch.profiler, and the phase's pairwise_sqdist launches.
  13-15.     — iCaRL (config/agent/icarl/icarl_1k.yml), GDumb
               (config/agent/gdumb/gdumb_1k.yml with config/general_1_gdumb.yml:
               batch 16, clip 10; mem_epoch cut 30 -> 3) and SCR
               (config_CVPR/agent/scr/scr_1k.yml: eps_mem_batch 100, temp 0.1,
               review_trick, fused views) on the same stream at nf 20, two
               tasks each (iCaRL and SCR at 250 images a class), with the
               same figures and checks. GDumb also
               prints its retrain steps/s and launches and device ms a
               retrain step; SCR its augmentation's launches a call and the
               review epoch's seconds;
  16. errors — one softmax eval of phase 6's model with --error_analysis, in
               a temporary working directory: the four counts must add up to
               the wrong predictions on the task they cover, and the
               `confusion` pickle must hold one label per test image.
  17. cndpm  — CN-DPM (config/agent/cndpm/cndpm.yml) at the published widths,
               K 10 and 16 z samples, two tasks of the same stream: task 0
               fills the 1,000-sample STM in its 100th step, so a sleep of
               4,000 VAE and 1,000 classifier steps (batch 50) runs before
               task 0 is evaluated. It prints the accuracies, the experts
               born, the sleeps' seconds, the wake step's host-clock time,
               and launches and device ms of 5 wake steps and of 20 VAE and
               20 classifier sleep steps under torch.profiler; at least one
               expert born, no saturated sleep, finite losses, sched_t >= 2
               for every born expert, task 0 above 0.5 after task 0, and no
               pairwise_sqdist launch.
18-20.     — the experiment layer at nf 20, batch 10, on the synthetic stream,
             each phase in a temporary working directory holding a copy of
             config/global.yml (the runner writes result/ and tables/ under
             it), each cut printed:
  18. resume — config/general_1.yml + synthetic_nc.yml +
               config_CVPR/agent/aser/aser_1k_cifar100.yml (ER + ASER)
               through the YAML CLI (ocl_tpu_torch.main_config), cut to 1
               run, 3 tasks, 200 images a class, with cuDNN's and torch's
               deterministic algorithms: uninterrupted; with
               --ckpt_dir and a crash inside train_learner in task 2; then
               resumed. Every tensor, the generator's and the host's state
               restored from the checkpoint must equal what was saved, bit
               for bit; the resumed accuracy matrix must match the
               uninterrupted one within 0.02 in every entry (the largest gap
               is printed); pairwise_sqdist must launch after the restore.
               Then the three once more on the default algorithms: the
               restore bit for bit, the accuracy gap printed, not gated;
  19. tune   — the tuner (ocl_tpu_torch.main_tune and
               experiment/tune.py::multiple_run_tune) on general_1 +
               synthetic_nc + config/agent/er/er_1k.yml over learning_rate
               {0.05, 0.1}, cut to 1 run, num_val 1, num_runs_val 1, 3
               tasks, 100 images a class; once more with --train_val True.
               The pickles' keys and shapes, the CSV's rows and a best point
               from the grid are required;
  20. modes  — offline: config/general_offline_1.yml + synthetic_nc +
               config/agent/er/offline.yml (mem_size 0), cut to 1 run, 3
               tasks, 200 images a class and 10 of its 70 epochs,
               Avg_End_Acc above 0.5; NI: synthetic_noise.yml, then
               synthetic_occlusion.yml, with er_1k.yml, their first 3
               factors (3 tasks), 300 images a class, --store and
               --buffer_tracker: each pickle's acc_array [1, 3, 3], a
               tracker line a task and no MISMATCH, and the undistorted
               task 0 above 0.5 after task 0 (the later, distorted tasks'
               accuracies are printed, not gated).
  21. stacked — --parallel_runs (experiment/parallel_run.py and
               parallel_tune.py) at nf 20: (a) fused ER from er_1k's flags,
               3 runs of 2 tasks x 50 steps through general_main, stacked
               and sequential: aggregate images/s of both, every run's
               Avg_End_Acc above 0.5, the largest per-run gap; launches,
               device ms (kernels summed and with a kernel running) and
               busy share of 5 stacked steps under torch.profiler; (b) ER +
               ASER, 3 runs stacked: pairwise_sqdist must launch 3 times a
               stacked SV step, for all runs; the batched kernel against
               its plain batched version at P 1, 3 and 84 (the synthetic
               shapes and 210 x 210 x 160; the same limits, an exact 0
               diagonal), its times by CUDA-graph replay beside P times the
               single call's bound, the launch floor and batched
               torch.cdist; (c) main_tune --parallel_runs True over
               er_tune.yml's 7 x 4 grid x num_runs_val 3 = 84 points
               (general_1 + synthetic_nc + er_1k, cut as phase 19 cuts
               them but num_runs_val): seconds, peak device memory, a best
               point from the grid, 5 stacked steps profiled; then phase
               19's 2-point grid stacked and sequential; (d) stacked tunes
               of GDumb (gdumb_tune.yml, mem_epoch 30 -> 3), iCaRL
               (icarl_tune.yml) and EWC++ (ewc_tune.yml, lambda_ {100}),
               each ending with a best point from its grid; (e) ER + MIR,
               GSS, match and mem_match, 3 runs stacked of 2 tasks x 100
               steps, each run's latest task above 0.5.
  22. data   — the dataset loaders at nf 20 on trees written here in each
               dataset's own format from --seed's default (class templates
               plus noise): (a) CIFAR-100 (50 train images a class of 500,
               the published 100 test images a class) through the YAML CLI
               with config_CVPR's general.yml, cifar100_nc.yml and
               aser_1k_cifar100.yml (ER + ASER), all 10 tasks: K1's
               launches and each (n, m, d) it ran at, images/s, each task's
               accuracy on its own test set after training it (every one
               above 0.5); (b) Mini-ImageNet's three cache pickles at full
               size with aser_1k_mini.yml, task 0 cut to MINI_STEPS (150)
               of its 500 steps, 150 images of each class (the script's
               time); (c) CORe50 ni
               (paths, LUP and labels pickles, 4,000 JPEGs at 128 px
               decoded once into the bin cache, then read from it) with
               config/general_1.yml and er_1k.yml, task 0 of 8, on
               deterministic algorithms (its accuracy spreads widely on the
               default ones: PERF.md §6). (b) and (c)
               print images/s, launches, device ms and busy share a step
               over DATA_PROFILE_STEPS profiled steps, the test sets' size
               resident on the card, peak device memory, and must read
               above 0.5 on the task trained; then the full CORe50 test set
               (44,972 images) made resident as the runner keeps it, its
               GiB; (d) OpenLORIS's occlusion factor through the flag CLI
               (general_main), plain ER, all 9 tasks of 10 objects (JPEGs
               by PIL, resized to 50 px by the loader): images/s and each
               task's accuracy on its own test set, every one above 0.5.
               Last the kernel against its plain version at every
               shape (a) and (b) launched it with (d = 160 and 640); phase
               3 checks d = 640 and 2,560 among its shapes. (b)'s task runs
               once more in bf16 on its tree, for phase 23 (d).
  23. bf16   — --compute_dtype bf16 (the model's forward under autocast,
               parameters, gradients, BN statistics and optimizer state in
               fp32) at nf 20: (a) ER + ASER through general_main, phase 4's
               flags cut to 2 tasks x 100 steps, with a forward hook on every
               convolution: K1 must launch, on fp32 inputs only, every
               convolution output must be bf16 and task 1 must read above
               0.5 after training it; images/s and a profiled SV step's
               launches and device ms beside phase 4's fp32 ones; (b) SCR with
               tools/parity_vs_reference.py's SCR_BF16 flags (eps_mem_batch
               50, temp 0.07, head mlp, two-pass views), 2 tasks x 50 steps,
               the same gate; (c) phase 21 (a)'s 3 fused-ER runs stacked in
               bf16, each run's task 1 above 0.5, aggregate images/s beside
               21 (a)'s fp32; (d) ER at batch 128 with 128 memory rows
               (bench.py's er_batch128_bf16 cell; one task of 78 steps), and
               phase 22 (b)'s Mini-ImageNet task (its 200 steps, on its tree),
               each in fp32 and in bf16: images/s, device ms a step over
               DATA_PROFILE_STEPS profiled steps, busy share, peak memory;
               (e) ResNet-18, -34, -50, -101 and -152 at nf 64, 32 px, batch
               10, in fp32 (TF32 off) and in bf16: ms a training step, peak
               memory, FLOPs a step by utils/flops.py and the TFLOP/s they
               imply; ResNet-18 and -50 in fp32 and ResNet18_pretrained at
               224 px from an .npz the phase writes must give the CPU's
               train-mode logits on the same weights within rtol 1e-3 /
               atol 1e-4; (f) utils/profiling.py::trace of 3 more SV steps of
               (a) must name K1's kernel, among its device events and in the
               Chrome trace file.
  24. dp     — --n_devices: two ranks of torch.distributed sharing cuda:0
               over gloo (NCCL refuses two ranks on one GPU), at nf 20 with
               TF32 off: (a) general_main --n_devices 2, ER + ASER, 2 tasks
               x 50 steps, with its layout line; rank 0's final state,
               checkpointed, evaluated by one process on every test row must
               give the fanned-out counts, or else the smallest top-2 logit
               margin must be under 1e-4; (b) 12 data-parallel ER + ASER
               steps over a slot-sharded buffer of 1,000 (batch 10 split
               5/5, 10 retrieved rows): K1 launches on every rank and agrees
               with its plain version at the shapes it was given (max abs
               error <= 1e-3, and <= 1e-5 of the largest ||a||^2 + ||b||^2,
               the terms it cancels: these features nearly coincide), the ranks'
               parameter checksums agree after every step, the first step
               is held against one rank's step (parameters within 1e-3,
               current_index and buffer labels equal); images/s,
               collectives and device ms a step per rank; (c)-(d)
               tools/dryrun.py's patterns at nf 20 (SCR, GSS, the CN-DPM
               wake step, the softmax and NCM fan-out on SCR's model, the
               grid tune): finite losses, ranks that agree, the NCM fan-out
               equal to the unsharded eval; (e) phase 21 (a)'s 3 stacked
               fused-ER runs dealt to the 2 ranks, each run above 0.5; (f)
               the DP ER step under NCCL at world size 1, and NCCL's answer
               to two ranks on one card; (g) in (b)'s launch, 3 DP steps
               each of ER + MIR (two-pass, subsample 50), ER + mem_match,
               ER + MIR retrieval + ASER update, AGEM + ASER retrieval,
               EWC++, LwF, ER with kd_trick + labels_trick (a teacher from
               other weights), SCR with scr_1k's flags and the ASER update,
               at nf 20 over (b)'s slot-sharded memory of 1,000: each first
               step held against one process's (parameters within 1e-3,
               current_index and labels equal; EWC++'s temporary Fisher
               within 1e-3 of its largest entry), the ranks' checksums
               equal every step, finite losses, on the ASER paths K1's
               launches a step on each rank as the path needs them (1 for
               the ASER update, 2 for ASER's asvm retrieval) and K1 against
               its plain version at every shape it ran; each configuration's
               step ms, collectives a step and their host ms.
Then one JSON line of kernel figures (K1's with its batched figures, the
data runs', the bf16 runs' and the DP runs' launches and shapes), the script's total
seconds, and last the result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

# the ASER shapes: update 30 x 30, retrieval 10 x 20 (adversarial) and
# 20 x 20 (cooperative) on the synthetic stream; 210 x 210, 10 x 200 and
# 200 x 200 on the CIFAR-100 recipe; D = 160 at nf 20 and 32 px. At 84 px
# (Mini-ImageNet, aser_1k_mini: n_smp_cls 3) D is 640 and the shapes 310 x
# 310, 10 x 300 and 300 x 300; at 128 px (CORe50's 50 classes at n_smp_cls
# 2) D is 2,560 and the update 110 x 110
SLICE_SHAPES = [(30, 30, 160), (10, 20, 160), (20, 20, 160),
                (210, 210, 160), (10, 200, 160), (200, 200, 160),
                (310, 310, 640), (10, 300, 640), (300, 300, 640), (110, 110, 2560)]
# ragged D (d % 4 != 0), tiny, over 48 KB of shared memory, slabs of D
# through the ring (one of them ragged), and many waves
CHECK_SHAPES = SLICE_SHAPES + [(13, 37, 50), (7, 5, 3), (1, 1, 1), (7, 5, 2048),
                               (3, 5, 4096), (33, 17, 4099), (1000, 1000, 640)]
MAX_REL, MAX_ABS = 1e-5, 1e-3
KERNEL = "pairwise_sqdist"
MAIN_FLAGS = ["--device", "cuda", "--data", "synthetic", "--agent", "ER",
              "--update", "ASER", "--retrieve", "ASER", "--aser_type", "asvm",
              "--k", "3", "--n_smp_cls", "2.0", "--mem_size", "1000",
              "--eps_mem_batch", "10", "--batch", "10", "--learning_rate", "0.1",
              "--nf", "20", "--num_tasks", "5", "--synthetic_size", "500",
              "--num_runs", "1", "--matmul_precision", "highest", "--verbose", "False"]
# phase 4's run and phase 23 (a)'s: 2 tasks of 5 classes x 200 images, 100
# steps a task (cut from MAIN_FLAGS' 5 tasks x 100 steps: the script's time)
MAIN_RUN_FLAGS = MAIN_FLAGS + ["--num_tasks", "2", "--synthetic_size", "200"]
PROFILE_STEPS = 10    # cut from 20: the script's time
# phases 6-12: (tag, label, flags over plain ER's, tasks, profiled steps).
# Reading a trace back takes time in proportion to its events, thousands a
# step, so phases 7-12 profile fewer steps than the fused schedule's
# PROFILE_STEPS.
ER_FLAGS = MAIN_FLAGS + ["--update", "random", "--retrieve", "random"]
FAMILY_PROFILE_STEPS = 3    # cut from 5: the script's time
# the script's time: fused ER, MIR, AGEM, the tricks, iCaRL and SCR stream
# 250 images a class (50 steps a task) of the 500; GSS keeps 500 (its check
# needs the buffer full in task 1), EWC++ and LwF at lr 0.01 too
HALF = ["--synthetic_size", "250"]
FAMILY = [
    ("fused", "ER, fused schedule (default flags)", HALF, 1, PROFILE_STEPS),
    ("mir", "ER + MIR", ["--retrieve", "MIR", "--subsample", "50"] + HALF, 2,
     FAMILY_PROFILE_STEPS),
    ("gss", "ER + GSS", ["--update", "GSS", "--gss_mem_strength", "10",
                         "--gss_batch_size", "10"], 2, FAMILY_PROFILE_STEPS),
    ("agem", "AGEM", ["--agent", "AGEM"] + HALF, 2, FAMILY_PROFILE_STEPS),
    # lambda 100 at lr 0.01, a point of config/agent/ewc/ewc_tune.yml: at lr
    # 0.1 the penalty's step (2 lr lambda F) overshoots and both packages
    # diverge to NaN on this stream from the second task on
    ("ewc", "EWC++ (lr 0.01)", ["--agent", "EWC", "--learning_rate", "0.01"], 2,
     FAMILY_PROFILE_STEPS),
    # lr 0.01, a point of config_CVPR/agent/lwf/lwf_tune.yml: at lwf.yml's 0.1
    # the distillation half of the loss holds the second task at or below 0.5
    ("lwf", "LwF (lr 0.01)", ["--agent", "LWF", "--learning_rate", "0.01"], 2,
     FAMILY_PROFILE_STEPS),
    ("tricks", "ER + separated_softmax, kd_trick, review_trick, ncm_trick",
     ["--separated_softmax", "True", "--kd_trick", "True", "--review_trick", "True",
      "--ncm_trick", "True"] + HALF, 2, FAMILY_PROFILE_STEPS),
]
# phases 13 and 15 (as FAMILY's entries), from the agents' recipes
ICARL = ("icarl", "iCaRL (icarl_1k)", ["--agent", "ICARL", "--eps_mem_batch", "10"] + HALF, 2,
         FAMILY_PROFILE_STEPS)
SCR = ("scr", "SCR (scr_1k: eps_mem_batch 100, temp 0.1, review_trick, fused views)",
       ["--agent", "SCR", "--eps_mem_batch", "100", "--temp", "0.1", "--weight_decay", "0",
        "--review_trick", "True"] + HALF, 2, FAMILY_PROFILE_STEPS)
# phase 14: gdumb_1k with general_1_gdumb's batch
# (mem_epoch cut 30 -> 3, 186 retrain steps a task: the script's time)
GDUMB_FLAGS = ["--agent", "GDUMB", "--batch", "16", "--mem_epoch", "3", "--clip", "10.0",
               "--minlr", "0.0005"]
GDUMB_PROFILE_STEPS = 10
# phase 17: CN-DPM, config/agent/cndpm/cndpm.yml with config/general_1.yml
# (SGD, batch 10) at the published widths (models/ndpm_vars.py), K 10 and
# 16 z samples, with the published 4,000 / 1,000-step sleep. --debug_nans
# makes the agent raise on a non-finite wake loss.
CNDPM_FLAGS = ["--agent", "CNDPM", "--optimizer", "SGD", "--learning_rate", "0.1",
               "--stm_capacity", "1000", "--weight_decay", "1e-5", "--classifier_chill", "0.01",
               "--log_alpha", "-300", "--max_experts", "10", "--debug_nans", "True"]
CNDPM_WAKE_PROFILE_STEPS = 5
CNDPM_SLEEP_PROFILE_STEPS = 20
# phases 18-20: the repository's recipes, cut as printed
REPO = os.path.dirname(os.path.abspath(__file__))
GENERAL = "config/general_1.yml"
GENERAL_OFFLINE = "config/general_offline_1.yml"
SYNTHETIC = "config/data/synthetic/synthetic_{}.yml"
ASER_RECIPE = "config_CVPR/agent/aser/aser_1k_cifar100.yml"
ER_RECIPE = "config/agent/er/er_1k.yml"
OFFLINE_RECIPE = "config/agent/er/offline.yml"
RESUME_GAP = 0.02
# phase 18's stream: 120 images a class, 36 steps a task (cut from 200 for the
# script's time, phase 24 having joined it)
RESUME_SIZE = 120
# phase 21: stacked runs and the stacked tuner. (a) fused ER from er_1k's
# flags, 3 runs of 2 tasks x 50 steps, stacked and sequential; (b) ER +
# ASER stacked, R = 3; the batched kernel at P points
STACKED_RUNS = 3
STACKED_FLAGS = ["--device", "cuda", "--data", "synthetic", "--agent", "ER",
                 "--update", "random", "--retrieve", "random", "--mem_size", "1000",
                 "--eps_mem_batch", "10", "--batch", "10", "--learning_rate", "0.1",
                 "--nf", "20", "--num_tasks", "2", "--synthetic_size", "200",
                 "--num_runs", str(STACKED_RUNS), "--matmul_precision", "highest",
                 "--verbose", "False"]
STACKED_ASER_FLAGS = STACKED_FLAGS + ["--update", "ASER", "--retrieve", "ASER", "--aser_type",
                                      "asvm", "--k", "3", "--n_smp_cls", "2.0"]
STACKED_PROFILE_STEPS = 3    # cut from 5: the script's time
# (e) the other strategies, 3 runs stacked: 2 tasks x 100 steps (STRATEGY_SIZE
# images a class) into a buffer of 200 (GSS then takes its gated
# replacements). Shorter tasks end inside the loss spikes of SGD at lr 0.1:
# at 25 steps ER + match read 0.028 to 1.0 from call to call (PR 7); at 50
# ER + GSS read <= 0.5 on a task just trained in 3 of 54 run-tasks on the
# default algorithms, every one finite and with no mislabelled slot, and in
# none of 36 at 100 (tools/spread.py; PERF.md §6)
STRATEGY_SIZE = 200
STACKED_STRATEGIES = [
    ("mir", ["--retrieve", "MIR", "--subsample", "50", "--fused_replay", "False"]),
    ("gss", ["--update", "GSS", "--gss_mem_strength", "10", "--gss_batch_size", "10"]),
    ("match", ["--retrieve", "match", "--warmup", "0"]),
    ("mem_match", ["--retrieve", "mem_match", "--warmup", "0", "--fused_replay", "False"]),
]
BATCHED_POINTS = (1, 3, 84)
BATCHED_SHAPES = [(30, 30, 160), (10, 20, 160), (20, 20, 160), (210, 210, 160)]
ER_TUNE = "config/agent/er/er_tune.yml"
# phase 22: the dataset loaders on trees written in each dataset's own format
# from --seed's default (class templates plus noise, as the synthetic stream
# makes them, so that a run learns). (a) CIFAR-100 through the YAML CLI, all
# 10 tasks of config_CVPR's ER + ASER recipe; (b) Mini-ImageNet at full size
# (the loader reshapes each cache pickle to [n_cls, 600, 84, 84, 3]), one
# task of 10; (c) CORe50 ni at 128 px, JPEGs decoded once into the bin
# cache, one task of 8 read from it
CVPR_GENERAL = "config_CVPR/general.yml"
CIFAR100_DATA = "config_CVPR/data/cifar100/cifar100_nc.yml"
MINI_DATA = "config_CVPR/data/mini_imagenet/mini_imagenet_nc.yml"
MINI_RECIPE = "config_CVPR/agent/aser/aser_1k_mini.yml"
# (b) trains MINI_STEPS of task 0's 500 steps (150 of each class's 500
# images, evenly spaced, in the stream's order; the buffer of 1,000 fills in
# the first 100 steps; the script's time), in fp32, then in bf16 for phase
# 23 (d)
MINI_STEPS = 150    # cut from 200: the script's time
CORE50_DATA = "config/data/core50/core50_ni.yml"
CIFAR100_TRAIN_PER_CLASS = 50       # of 500: the cut
CIFAR100_TEST_PER_CLASS = 100       # as published
CORE50_TRAIN, CORE50_TEST, CORE50_CLASSES = 3000, 1000, 50   # of ~15,000 and 44,972
CORE50_FULL_TEST = 44972
DATA_PROFILE_STEPS = 10    # cut from 20: the script's time
# (d) OpenLORIS's occlusion factor (the one the flag CLI names), 9 tasks of
# OPENLORIS_OBJECTS objects, OPENLORIS_TRAIN train and OPENLORIS_TEST test
# images an object a task; 10% of a task's train images go to its val set.
# At 50 train images (45 steps a task) task 0 read 0.1-0.2 in 3 of 5 runs
# on the card, its running BN statistics behind its weights (0.97-1.0 on
# batch statistics); at 100 (90 steps) every task of 3 runs read 1.0
# (tools/spread.py; PERF.md §6)
OPENLORIS_OBJECTS, OPENLORIS_TRAIN, OPENLORIS_TEST = 10, 100, 10
OPENLORIS_FLAGS = ["--device", "cuda", "--data", "openloris", "--cl_type", "ni", "--ns_type",
                   "occlusion", "--agent", "ER", "--nf", "20", "--mem_size", "1000",
                   "--num_runs", "1", "--verbose", "False", "--store", "True",
                   "--save-path", "openloris.pkl"]

# phase 23: --compute_dtype bf16 (the model's forward under autocast; K1 on
# fp32 features). (a) ER + ASER, MAIN_FLAGS cut to 2 tasks x 100 steps, and
# TRACE_STEPS SV steps under utils/profiling.py::trace (f); (b) SCR with
# tools/parity_vs_reference.py's SCR_BF16 flags, 2 tasks x 50 steps; (c)
# phase 21 (a)'s stacked runs; (d) ER at batch 128 with 128 memory rows
# (bench.py's er_batch128_bf16 cell), one task of B128_SIZE images a class,
# and phase 22 (b)'s Mini-ImageNet task, in fp32 and in bf16; (e) the
# ResNet family at nf 64, 32 px, batch RESNET_BATCH
BF16 = ["--compute_dtype", "bf16"]
BF16_RUN_FLAGS = MAIN_RUN_FLAGS + BF16
SCR_BF16 = ("scr_bf16", "SCR in bf16 (SCR_BF16: eps_mem_batch 50, temp 0.07, head mlp, "
            "two-pass views)",
            ["--agent", "SCR", "--eps_mem_batch", "50", "--temp", "0.07", "--head", "mlp",
             "--fused_replay", "False"] + BF16 + HALF, 2, FAMILY_PROFILE_STEPS)
TRACE_STEPS = 3
B128_SIZE = 2000
B128_FLAGS = ["--device", "cuda", "--data", "synthetic", "--agent", "ER", "--mem_size", "1000",
              "--batch", "128", "--eps_mem_batch", "128", "--learning_rate", "0.1", "--nf", "20",
              "--num_tasks", "2", "--synthetic_size", str(B128_SIZE), "--num_runs", "1",
              "--verbose", "False"]
RESNETS = ("ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152")
RESNET_BATCH, RESNET_STEPS = 10, 10
PRETRAINED_SIZE = 224


class CheckFailed(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise CheckFailed(msg)


class Tee(io.TextIOBase):
    """Write to the real stdout and keep a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def errors(torch, got, want):
    err = (got - want).abs()
    rel = err / want.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return err.max().item(), rel.max().item()


def check_kernel(torch, distance, device):
    """Phase 3's agreement checks; returns the largest absolute error."""
    pairwise_sqdist = distance.pairwise_sqdist
    pairwise_sqdist_plain = distance.pairwise_sqdist_plain
    g = torch.Generator(device=device).manual_seed(0)

    def check(label, a, b):
        got = pairwise_sqdist(a, b)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(torch, got, pairwise_sqdist_plain(a, b))
        n, d = a.shape
        plan = distance.launch_plan(n, b.shape[0], d,
                                    distance.load_width(d, a.data_ptr(), b.data_ptr()))
        print("[kernel] {}: max_abs_err {:.3e} max_rel_err {:.3e} | {}-byte copies, {} slab(s) "
              "of {}, {} B shared{}, {} blocks".format(
                  label, abs_err, rel_err, 4 * plan.vec, -(-d // plan.slab) if plan.slab else 0,
                  plan.slab, plan.smem_bytes, " (opted in)" if plan.opts_in else "", plan.grid))
        require(math.isfinite(abs_err) and rel_err <= MAX_REL and abs_err <= MAX_ABS,
                "kernel disagrees with plain at {}".format(label))
        return abs_err

    max_abs = 0.0
    for n, m, d in CHECK_SHAPES:
        # scaled so that a distance stays near 2 x 160 at every d: the fp32
        # rounding of either version then stays well under MAX_ABS
        scale = min(1.0, (160 / d) ** 0.5)
        a = torch.randn(n, d, device=device, generator=g) * scale
        b = torch.randn(m, d, device=device, generator=g) * scale
        max_abs = max(max_abs, check("{}x{}x{}".format(n, m, d), a, b))
    for n, m, d in [(30, 30, 160), (210, 210, 160)]:
        # contiguous views one float into their storage: not 16-byte aligned
        a = torch.randn(n * d + 1, device=device, generator=g)[1:].view(n, d)
        b = torch.randn(m * d + 1, device=device, generator=g)[1:].view(m, d)
        require(a.data_ptr() % 16 != 0, "the offset view is aligned")
        max_abs = max(max_abs, check("{}x{}x{} a misaligned".format(n, m, d), a, b.clone()))
        max_abs = max(max_abs, check("{}x{}x{} b misaligned".format(n, m, d), a.clone(), b))
    for n in (30, 210):
        a = torch.randn(n, 160, device=device, generator=g)
        diag = pairwise_sqdist(a, a).diagonal()
        require(bool((diag == 0).all()), "pairwise_sqdist(a, a) at {}x160 has a diagonal "
                "entry {} != 0".format(n, diag.abs().max().item()))
        print("[kernel] pairwise_sqdist(a, a) at {}x160: diagonal exactly 0".format(n))
    a = torch.randn(160, 30, device=device, generator=g)
    b = torch.randn(30, 160, device=device, generator=g)
    try:
        pairwise_sqdist(a.t(), b)
    except ValueError as e:
        print("[kernel] non-contiguous input raises: {}".format(e))
    else:
        raise CheckFailed("a non-contiguous input did not raise")
    return max_abs


def time_kernel(torch, pairwise_sqdist, pairwise_sqdist_plain, device):
    """Phase 3's times: one dict per slice shape, and the profiler cross-check."""
    from ocl_tpu_torch.tools import kernel_timing as kt

    floor = kt.launch_floor()
    print("[kernel] launch floor (t.zero_() on 1 element): device {:.5f} ms, enqueue {:.5f} ms, "
          "host {:.2f} us".format(floor["device_ms"], floor["enqueue_ms"], floor["host_us"]))
    g = torch.Generator(device=device).manual_seed(1)
    shapes = []
    for n, m, d in SLICE_SHAPES:
        a = torch.randn(n, d, device=device, generator=g)
        b = torch.randn(m, d, device=device, generator=g)
        kernel = kt.figures(lambda: pairwise_sqdist(a, b))
        plain = kt.figures(lambda: pairwise_sqdist_plain(a, b))
        library = kt.figures(lambda: torch.cdist(a, b, compute_mode="use_mm_for_euclid_dist"))
        bound_ms, bound_by = kt.sqdist_bound(n, m, d)
        row = {"shape": [n, m, d], **kernel, "plain": plain, "library": library,
               "floor_ms": floor["device_ms"], "bound_ms": bound_ms, "bound_by": bound_by}
        shapes.append(row)
        print("[kernel] {}x{}x{}: device {:.5f} ms (plain {:.5f}, cdist {:.5f}; {:.2f}x floor, "
              "roofline {:.2%} of {:.2e} ms by {}) | enqueue {:.5f} ms (plain {:.5f}, cdist {:.5f}) "
              "| host {:.2f} us (plain {:.2f}, cdist {:.2f})".format(
                  n, m, d, kernel["device_ms"], plain["device_ms"], library["device_ms"],
                  kernel["device_ms"] / floor["device_ms"], bound_ms / kernel["device_ms"],
                  bound_ms, bound_by, kernel["enqueue_ms"], plain["enqueue_ms"],
                  library["enqueue_ms"], kernel["host_us"], plain["host_us"], library["host_us"]))
    a = torch.randn(30, 160, device=device, generator=g)
    b = torch.randn(30, 160, device=device, generator=g)
    ms, count = kt.profiled_ms(lambda: pairwise_sqdist(a, b), KERNEL)
    if ms is None:
        print("[kernel] torch.profiler at 30x30x160: no device time for {} (not measured)".format(
            KERNEL))
    else:
        print("[kernel] torch.profiler at 30x30x160: {:.5f} ms a kernel over {} kernels".format(
            ms, count))
    return shapes, floor, ms


def profile_sv_steps(torch, device, flags=MAIN_FLAGS, tag="main", trace_dir=None):
    """Phase 4's profile (and phase 23 (a)'s with its flags): the ER + ASER
    agent fills its buffer with task 0, takes 5 warm steps of task 1, then
    PROFILE_STEPS steps under torch.profiler, each of them on the SV paths.
    With `trace_dir`, TRACE_STEPS more steps under utils/profiling.py::trace
    into it, whose profile is returned beside the figures."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from ocl_tpu_torch.config import build_parser, finalize
    from ocl_tpu_torch.data import continuum
    from ocl_tpu_torch.registry import agents
    from ocl_tpu_torch.tools.kernel_timing import kernel_times
    from ocl_tpu_torch.utils.profiling import trace

    params = finalize(build_parser().parse_args(flags))
    np.random.seed(params.seed)
    stream = continuum(params.data, params.cl_type, params)
    stream.new_run()
    agent = agents["ER"](params)
    state = agent.init_state(params.seed)
    x, y, _ = next(stream)
    state = agent.train_learner(state, x, y)
    x, y, _ = next(stream)
    ctx = agent.before_train(y)
    warm = 5 * params.batch
    agent.train_task(state, ctx, x[:warm], y[:warm])
    torch.cuda.synchronize()
    end = warm + PROFILE_STEPS * params.batch
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        agent.train_task(state, ctx, x[warm:end], y[warm:end])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = kernel_times(prof)
    k1 = [us for name, us in kernels if KERNEL in name]
    per_step = {"k1_launches": len(k1) / PROFILE_STEPS,
                "k1_device_ms": sum(k1) / 1e3 / PROFILE_STEPS,
                "kernels": len(kernels) / PROFILE_STEPS,
                "device_ms": sum(us for _, us in kernels) / 1e3 / PROFILE_STEPS,
                "wall_ms": wall * 1e3 / PROFILE_STEPS}
    print("[{}] {} profiled SV steps: {} {:.1f} launches, {:.5f} ms device a step; all kernels "
          "{:.0f} launches, {:.3f} ms device a step; {:.1f} ms a step on the host clock under the "
          "profiler".format(tag, PROFILE_STEPS, KERNEL,
                            per_step["k1_launches"], per_step["k1_device_ms"],
                            per_step["kernels"], per_step["device_ms"], per_step["wall_ms"]))
    require(per_step["k1_launches"] > 0, "the profiled SV steps ran no {} kernel".format(KERNEL))
    if trace_dir is None:
        return per_step
    with trace(trace_dir) as traced:
        agent.train_task(state, ctx, x[end:end + TRACE_STEPS * params.batch],
                         y[end:end + TRACE_STEPS * params.batch])
        torch.cuda.synchronize()
    return per_step, traced


def profile_steps(torch, agent, state, ctx, x, y, steps):
    """Per-step figures of `steps` steps of `agent` on (x, y) under
    torch.profiler: kernel launches, their device ms, and host-clock ms a
    step (with the profiler on)."""
    from torch.profiler import ProfilerActivity, profile

    from ocl_tpu_torch.tools.kernel_timing import kernel_times

    n = steps * agent.params.batch
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        agent.train_task(state, ctx, x[:n], y[:n])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = kernel_times(prof)
    return {"kernels": len(kernels) / steps,
            "device_ms": sum(us for _, us in kernels) / 1e3 / steps,
            "wall_ms": wall * 1e3 / steps}


def count_gss_replacements(torch, agent):
    """Wrap the GSS update so it counts the full-buffer steps that replaced a
    slot (one host read of the buffer a step; for this check only)."""
    counts = {"full": 0, "replaced": 0}
    run = agent.update.run

    def counted(model, buf, x, y, draws):
        if buf.current_index < buf.mem_size:
            return run(model, buf, x, y, draws)
        before = buf.slot_labels.clone(), buf.slot_imgs.clone()
        out = run(model, buf, x, y, draws)
        counts["full"] += 1
        counts["replaced"] += int(not (torch.equal(before[0], buf.slot_labels)
                                       and torch.equal(before[1], buf.slot_imgs)))
        return out

    agent.update = agent.update._replace(run=counted)
    return counts


def run_family_phase(torch, device, tag, label, flags, n_tasks, prof_steps, pairwise_sqdist,
                     agent_hook=None):
    """One phase of 6-13 or 15: `n_tasks` tasks of the synthetic stream
    through the port's agent, evaluated after each; then `prof_steps`
    profiled steps. `agent_hook(agent)` may instrument the agent first.
    Returns the phase's figures and (agent, state, test loaders)."""
    import numpy as np

    from ocl_tpu_torch.config import build_parser, finalize
    from ocl_tpu_torch.data import continuum, prepare_test_loaders
    from ocl_tpu_torch.registry import agents

    params = finalize(build_parser().parse_args(ER_FLAGS + flags))
    np.random.seed(params.seed)
    stream = continuum(params.data, params.cl_type, params)
    stream.new_run()
    agent = agents[params.agent](params)
    state = agent.init_state(params.seed)
    gss = count_gss_replacements(torch, agent) if params.update == "GSS" else None
    if agent_hook is not None:
        agent_hook(agent)
    loaders = prepare_test_loaders(stream.test_data(), params, device)
    pairwise_sqdist.launches = 0
    accs, images, train_s = [], 0, 0.0
    for _ in range(n_tasks):
        x, y, _ = next(stream)
        t0 = time.time()
        state = agent.train_learner(state, x, y)
        torch.cuda.synchronize()
        train_s += time.time() - t0
        images += (len(y) // params.batch) * params.batch
        accs.append(agent.evaluate(state, loaders))
    launches = pairwise_sqdist.launches
    gss = dict(gss) if gss is not None else None   # before the profiled steps add to it
    latest = float(accs[-1][n_tasks - 1])
    end_acc = float(np.mean(accs[-1][:n_tasks]))
    per_step = profile_steps(torch, agent, state, agent.before_train(y), x, y, prof_steps)
    extra = ""
    if gss is not None:
        extra = "; full-buffer steps {}, of which replaced a slot {}".format(
            gss["full"], gss["replaced"])
    print("[{}] {} nf {}, {} task(s) x {} steps: accuracy after each task on tasks 0-{} {}, "
          "Avg_End_Acc over them {:.4f}, latest task {:.4f}, {:.1f} images/s{}; {} profiled "
          "steps: {:.0f} launches, {:.3f} ms device, {:.1f} ms host clock a step; "
          "pairwise_sqdist launches {}".format(
              tag, label, params.nf, n_tasks, images // n_tasks // params.batch, n_tasks - 1,
              [[round(float(a), 4) for a in row[:n_tasks]] for row in accs], end_acc, latest,
              images / train_s, extra, prof_steps, per_step["kernels"],
              per_step["device_ms"], per_step["wall_ms"], launches))
    require(all(np.isfinite(row).all() for row in accs), "{}: a non-finite accuracy".format(tag))
    require(latest > 0.5, "{}: latest task accuracy {} is not above 0.5".format(tag, latest))
    if gss is not None:
        require(gss["replaced"] > 0, "gss: no full-buffer step replaced a slot")
    figures = {"images_per_s": images / train_s, "latest_acc": latest, "end_acc": end_acc,
               "launches": launches, **per_step, **({"gss": gss} if gss else {})}
    return figures, (agent, state, loaders)


def run_gdumb_phase(torch, device, pairwise_sqdist):
    """Phase 14: two tasks of GDumb; the retrain at each task's end is timed
    (host clock, synced), then GDUMB_PROFILE_STEPS retrain steps on the last
    memory run under torch.profiler."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from ocl_tpu_torch.config import build_parser, finalize
    from ocl_tpu_torch.data import continuum, prepare_test_loaders
    from ocl_tpu_torch.registry import agents
    from ocl_tpu_torch.tools.kernel_timing import kernel_times

    params = finalize(build_parser().parse_args(ER_FLAGS + GDUMB_FLAGS))
    np.random.seed(params.seed)
    stream = continuum(params.data, params.cl_type, params)
    stream.new_run()
    agent = agents["GDUMB"](params)
    state = agent.init_state(params.seed)
    loaders = prepare_test_loaders(stream.test_data(), params, device)
    retrain = agent.retrain
    timed = {"steps": 0, "s": 0.0}

    def timed_retrain(state, ctx, mem_x, mem_y, idx):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = retrain(state, ctx, mem_x, mem_y, idx)
        torch.cuda.synchronize()
        timed["s"] += time.perf_counter() - t0
        timed["steps"] += len(idx)
        timed["last"] = (ctx, mem_x, mem_y, idx)
        return out

    agent.retrain = timed_retrain
    pairwise_sqdist.launches = 0
    accs, images, train_s, n_tasks = [], 0, 0.0, 2
    for _ in range(n_tasks):
        x, y, _ = next(stream)
        t0 = time.time()
        state = agent.train_learner(state, x, y)
        torch.cuda.synchronize()
        train_s += time.time() - t0
        images += (len(y) // params.batch) * params.batch
        accs.append(agent.evaluate(state, loaders))
    launches = pairwise_sqdist.launches
    latest = float(accs[-1][n_tasks - 1])
    end_acc = float(np.mean(accs[-1][:n_tasks]))
    ctx, mem_x, mem_y, idx = timed["last"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        retrain(state, ctx, mem_x, mem_y, idx[:GDUMB_PROFILE_STEPS])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = kernel_times(prof)
    per_step = {"kernels": len(kernels) / GDUMB_PROFILE_STEPS,
                "device_ms": sum(us for _, us in kernels) / 1e3 / GDUMB_PROFILE_STEPS,
                "wall_ms": wall * 1e3 / GDUMB_PROFILE_STEPS}
    print("[gdumb] GDumb (gdumb_1k, batch 16, mem_epoch 30 -> 3, clip 10) nf {}, {} tasks: "
          "accuracy after each task on tasks 0-{} {}, Avg_End_Acc over them {:.4f}, latest task "
          "{:.4f}, "
          "{:.1f} images/s; retrain {} steps in {:.1f} s, {:.1f} steps/s ({} in the last task); "
          "{} profiled retrain steps: {:.0f} launches, {:.3f} ms device, {:.1f} ms host clock a "
          "step; pairwise_sqdist launches {}".format(
              params.nf, n_tasks, n_tasks - 1,
              [[round(float(a), 4) for a in row[:n_tasks]] for row in accs], end_acc, latest,
              images / train_s, timed["steps"], timed["s"], timed["steps"] / timed["s"], len(idx),
              GDUMB_PROFILE_STEPS, per_step["kernels"], per_step["device_ms"],
              per_step["wall_ms"], launches))
    require(all(np.isfinite(row).all() for row in accs), "gdumb: a non-finite accuracy")
    require(latest > 0.5, "gdumb: latest task accuracy {} is not above 0.5".format(latest))
    return {"images_per_s": images / train_s, "latest_acc": latest, "end_acc": end_acc,
            "launches": launches, "retrain_steps": timed["steps"], "retrain_s": timed["s"],
            "retrain": per_step}


def time_review(torch, review_s):
    """An agent hook: time each after_train (the review epoch, for SCR) on
    the host clock with a sync, into the list `review_s`."""
    def hook(agent):
        after_train = agent.after_train

        def timed(state, ctx):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = after_train(state, ctx)
            torch.cuda.synchronize()
            review_s.append(time.perf_counter() - t0)
            return out

        agent.after_train = timed

    return hook


def profile_augment(torch, device, state, rows):
    """Launches and device ms of one SCR augmentation call (draws included)
    on `rows` images, under torch.profiler after a warm call."""
    from torch.profiler import ProfilerActivity, profile

    from ocl_tpu_torch.ops.augment import draw_scr_transform, scr_transform
    from ocl_tpu_torch.tools.kernel_timing import kernel_times

    x = torch.rand(rows, 32, 32, 3, device=device, generator=state.generator)
    scr_transform(x, draw_scr_transform(state.generator, state.host, rows, (32, 32)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = scr_transform(x, draw_scr_transform(state.generator, state.host, rows, (32, 32)))
        torch.cuda.synchronize()
    require(bool(torch.isfinite(out).all()) and out.shape == x.shape,
            "scr: the augmentation's output is not finite or has another shape")
    kernels = kernel_times(prof)
    return {"kernels": len(kernels), "device_ms": sum(us for _, us in kernels) / 1e3}


def run_error_analysis(torch, agent, state, loaders):
    """Phase 16: `agent`'s softmax eval with --error_analysis, in a temporary
    working directory, held against its plain softmax eval."""
    import numpy as np

    accs = agent.evaluate(state, loaders)
    totals = [int(m.sum()) for _, _, m in loaders]
    wrong = [round((1 - a) * n) for a, n in zip(accs, totals)]
    agent.params.error_analysis = True
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            ea_accs = agent.evaluate(state, loaders)
            ea_s = time.perf_counter() - t0
            with open("confusion", "rb") as fp:
                correct_lb, predict_lb = pickle.load(fp)
        finally:
            os.chdir(cwd)
            agent.params.error_analysis = False
    no, nn_, oo, on = agent.error_list[-1]
    new_task = agent.task_seen - 1
    print("[errors] --error_analysis eval of phase 6's model ({} task(s) seen, {} test images): "
          "accuracies {}, (no, nn, oo, on) = {}, wrong on the last task {} and on older tasks "
          "{}; new/old class logit means {:.4f}/{:.4f}; confusion pickle {} labels; {:.2f} s".format(
              agent.task_seen, sum(totals), [round(float(a), 4) for a in ea_accs],
              (no, nn_, oo, on), wrong[new_task], sum(wrong[:new_task]),
              agent.new_class_score[-1], agent.old_class_score[-1], len(correct_lb), ea_s))
    require(np.array_equal(ea_accs, accs), "errors: accuracies differ from the softmax eval's")
    require(no + nn_ == wrong[new_task] and oo + on == sum(wrong[:new_task]),
            "errors: the counts do not add up to the wrong predictions")
    require(len(correct_lb) == len(predict_lb) == sum(totals),
            "errors: the confusion pickle does not hold one label per test image")
    return {"counts": [no, nn_, oo, on], "seconds": ea_s}


def profile_sleep(torch, agent, state, steps_g, steps_d):
    """Launches and device ms a sleep step of one profiled sleep of
    `steps_g` VAE and `steps_d` classifier steps on the full STM. It trains
    the next free slot, so it runs after the phase's accuracies are read."""
    from torch.profiler import ProfilerActivity, profile

    from ocl_tpu_torch.tools.kernel_timing import kernel_times

    agent.params.sleep_step_g, agent.params.sleep_step_d = steps_g, steps_d
    state.agent["stm_count"] = agent.stm_capacity
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        agent.sleep(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = kernel_times(prof)
    steps = steps_g + steps_d
    return {"kernels": len(kernels) / steps,
            "device_ms": sum(us for _, us in kernels) / 1e3 / steps,
            "wall_ms": wall * 1e3 / steps}


def run_cndpm_phase(torch, device, pairwise_sqdist):
    """Phase 17: two tasks of CN-DPM. Task 0 fills the STM (1,000 images)
    in its 100th step, so a sleep at the full budget runs before task 0 is
    evaluated. The sleeps are timed on the host clock with a sync, and the
    wake step is the rest of the training time over the wake steps. The
    first CNDPM_WAKE_PROFILE_STEPS wake steps of task 1 run under
    torch.profiler (outside those times) and, after the accuracies, one
    sleep of CNDPM_SLEEP_PROFILE_STEPS VAE steps and one of as many
    classifier steps."""
    import numpy as np

    from ocl_tpu_torch.config import build_parser, finalize
    from ocl_tpu_torch.data import continuum, prepare_test_loaders
    from ocl_tpu_torch.models import ndpm_vars
    from ocl_tpu_torch.registry import agents

    params = finalize(build_parser().parse_args(ER_FLAGS + CNDPM_FLAGS))
    np.random.seed(params.seed)
    stream = continuum(params.data, params.cl_type, params)
    stream.new_run()
    agent = agents["CNDPM"](params)
    state = agent.init_state(params.seed)
    loaders = prepare_test_loaders(stream.test_data(), params, device)
    sleep = agent.sleep
    sleeps = []

    def timed_sleep(state, draws=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sleep(state, draws)
        torch.cuda.synchronize()
        sleeps.append(time.perf_counter() - t0)

    agent.sleep = timed_sleep
    pairwise_sqdist.launches = 0
    accs, train_s, wake_steps, n_tasks = [], 0.0, 0, 2
    for task in range(n_tasks):
        x, y, _ = next(stream)
        ctx = agent.before_train(y)
        if task == 1:
            # the first steps of task 1, profiled and left out of the times
            n = CNDPM_WAKE_PROFILE_STEPS * params.batch
            wake = profile_steps(torch, agent, state, ctx, x[:n], y[:n], CNDPM_WAKE_PROFILE_STEPS)
            x, y = x[n:], y[n:]
        t0 = time.time()
        state = agent.train_task(state, ctx, x, y)
        state = agent.after_train(state, ctx)
        torch.cuda.synchronize()
        train_s += time.time() - t0
        wake_steps += len(y) // params.batch
        accs.append(agent.evaluate(state, loaders))
    launches = pairwise_sqdist.launches
    ag = state.agent
    born, saturated = ag["active"], ag["saturated_sleeps"]
    sched_t = ag["sched_t"][:born].tolist()
    acc0, latest = float(accs[0][0]), float(accs[-1][n_tasks - 1])
    wake_ms = (train_s - sum(sleeps)) * 1e3 / wake_steps
    steps_g = int(getattr(params, "sleep_step_g", ndpm_vars.SLEEP_STEP_G))
    steps_d = int(getattr(params, "sleep_step_d", ndpm_vars.SLEEP_STEP_D))
    agent.sleep = sleep
    sleep_g = profile_sleep(torch, agent, state, CNDPM_SLEEP_PROFILE_STEPS, 0)
    sleep_d = profile_sleep(torch, agent, state, 0, CNDPM_SLEEP_PROFILE_STEPS)
    print("[cndpm] CN-DPM (cndpm.yml: stm_capacity 1000, SGD lr 0.1, chill 0.01, log_alpha -300) "
          "K {}, z samples {}, sleep {} / {} steps at batch 50, {} tasks: accuracy after each task "
          "on tasks 0-{} {}; experts born {}, saturated sleeps {}, sched_t {}; sleeps {} s; wake "
          "step {:.1f} ms on the host clock over {} steps; pairwise_sqdist launches {}".format(
              agent.K, ndpm_vars.VAE_Z_SAMPLES, steps_g, steps_d, n_tasks, n_tasks - 1,
              [[round(float(a), 4) for a in row[:n_tasks]] for row in accs], born, saturated,
              sched_t, [round(t, 2) for t in sleeps], wake_ms, wake_steps, launches))
    print("[cndpm] profiled: {} wake steps of task 1 {:.0f} launches, {:.3f} ms device, "
          "{:.1f} ms host clock a step; {} VAE sleep steps {:.0f} launches, {:.3f} ms device, "
          "{:.2f} ms host clock a step; {} classifier sleep steps {:.0f} launches, {:.3f} ms "
          "device, {:.2f} ms host clock a step".format(
              CNDPM_WAKE_PROFILE_STEPS, wake["kernels"], wake["device_ms"], wake["wall_ms"],
              CNDPM_SLEEP_PROFILE_STEPS, sleep_g["kernels"], sleep_g["device_ms"],
              sleep_g["wall_ms"], CNDPM_SLEEP_PROFILE_STEPS, sleep_d["kernels"],
              sleep_d["device_ms"], sleep_d["wall_ms"]))
    require(born >= 1, "cndpm: no expert was born")
    require(saturated == 0, "cndpm: {} saturated sleep(s)".format(saturated))
    require(all(t >= 2 for t in sched_t), "cndpm: a born expert's sched_t {} < 2".format(sched_t))
    require(all(np.isfinite(row).all() for row in accs), "cndpm: a non-finite accuracy")
    require(acc0 > 0.5, "cndpm: task 0 accuracy after task 0 {} is not above 0.5".format(acc0))
    require(launches == 0, "cndpm: {} pairwise_sqdist launches".format(launches))
    return {"accs": [[float(a) for a in row[:n_tasks]] for row in accs], "acc0": acc0,
            "latest_acc": latest, "born": born, "saturated": saturated, "sleep_s": sleeps,
            "wake_ms": wake_ms, "launches": launches, "wake": wake, "sleep_g": sleep_g,
            "sleep_d": sleep_d}


@contextlib.contextmanager
def experiment_dir():
    """A temporary working directory holding a copy of config/global.yml,
    under which the runner writes result/ and tables/."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "config"))
        shutil.copy(os.path.join(REPO, "config", "global.yml"), os.path.join(tmp, "config"))
        os.chdir(tmp)
        try:
            yield tmp
        finally:
            os.chdir(cwd)


def cut_recipe(src, name, cuts, extra=()):
    """A copy of the recipe `src` (relative to the repository) in the working
    directory, each `old: new` text replacement of `cuts` made and the
    `extra` (key, value) lines added to its parameters; returns its path."""
    with open(os.path.join(REPO, src)) as f:
        text = f.read()
    for old, new in cuts.items():
        require(old in text, "{} has no {!r} to cut".format(src, old))
        text = text.replace(old, new)
    text += "".join("  {}: {}\n".format(k, v) for k, v in extra)
    with open(name, "w") as f:
        f.write(text)
    return os.path.abspath(name)


def quietly(fn, *args, **kwargs):
    """fn(*args, **kwargs) with its standard output captured; returns (its
    result, the output). On an error the output's tail goes to stderr."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            return fn(*args, **kwargs), out.getvalue()
    except Exception:
        sys.stderr.write(out.getvalue()[-4000:])
        raise


def resume_sequence(torch, pairwise_sqdist):
    """Phase 18's three runs of ER + ASER through the YAML CLI, in a
    temporary working directory: uninterrupted; with --ckpt_dir, crashing in
    task 2; resumed. Returns their accuracy matrices, seconds and launches,
    what the restore verified, the checkpoint's meta and the resumed run's
    output."""
    import numpy as np

    import ocl_tpu_torch.experiment.run as run_mod
    from ocl_tpu_torch.main_config import build_parser, main as config_main
    from ocl_tpu_torch.utils import checkpoint

    matrices, verified = [], {}
    compute_performance, new_agent = run_mod.compute_performance, run_mod._new_agent_and_state
    load_checkpoint = checkpoint.load_checkpoint

    def recorded(acc):
        matrices.append(np.array(acc))
        return compute_performance(acc)

    def crashing(params, seed):
        agent, state = new_agent(params, seed)
        train_learner, calls = agent.train_learner, {"n": 0}

        def train(state, x, y):
            calls["n"] += 1
            if calls["n"] == 3:
                raise KeyboardInterrupt("a crash in task 2")
            return train_learner(state, x, y)

        agent.train_learner = train
        return agent, state

    def verified_load(path, target):
        state, meta = load_checkpoint(path, target)
        saved = checkpoint.load_state_file(path, meta)
        verified.update(task=meta["task"], mismatches=checkpoint.mismatches(
            checkpoint.pack_state(state), saved), tensors=count_tensors(torch, saved),
            host=saved["host"] == state.host.getstate(),
            generator=torch.equal(saved["generator"], state.generator.get_state()))
        pairwise_sqdist.launches = 0     # from here on: the launches after the restore
        return state, meta

    with experiment_dir():
        cuts = {"num_runs: 5": "num_runs: 1"}
        general = cut_recipe(GENERAL, "general.yml", cuts)
        general_ckpt = cut_recipe(GENERAL, "general_ckpt.yml", cuts, [("ckpt_dir", "ckpt")])
        data = cut_recipe(SYNTHETIC.format("nc"), "data.yml", {"num_tasks: 5": "num_tasks: 3"},
                          [("synthetic_size", RESUME_SIZE)])

        def args(general_file):
            return build_parser().parse_args(["--general", general_file, "--data", data, "--agent",
                                              os.path.join(REPO, ASER_RECIPE), "--verbose",
                                              "False"])

        run_mod.compute_performance = recorded
        try:
            pairwise_sqdist.launches = 0
            t0 = time.time()
            quietly(config_main, args(general))
            times = [time.time() - t0]
            launches = [pairwise_sqdist.launches]
            run_mod._new_agent_and_state = crashing
            t0 = time.time()
            try:
                quietly(config_main, args(general_ckpt))
            except KeyboardInterrupt:
                pass
            else:
                raise CheckFailed("resume: the interrupted run did not crash")
            times.append(time.time() - t0)
            run_mod._new_agent_and_state = new_agent
            saved_meta = checkpoint.read_meta("ckpt")
            checkpoint.load_checkpoint = verified_load
            t0 = time.time()
            _, out = quietly(config_main, args(general_ckpt))
            times.append(time.time() - t0)
            launches.append(pairwise_sqdist.launches)
        finally:
            run_mod.compute_performance = compute_performance
            run_mod._new_agent_and_state = new_agent
            checkpoint.load_checkpoint = load_checkpoint
    want, got = matrices
    return {"want": want, "got": got, "gap": float(np.max(np.abs(got - want))), "times": times,
            "launches": launches, "verified": verified, "meta": saved_meta, "out": out}


def run_resume_phase(torch, pairwise_sqdist, card):
    """Phase 18: resume_sequence under deterministic algorithms, gated; then
    once more on the default algorithms, its gap printed. Deterministic
    algorithms give the uninterrupted and the resumed run the same sums, so
    the gate holds the restore alone: on the default algorithms ER + ASER's
    picks hang on rounding, and from a bit-for-bit restore task 1 read 0.94
    after task 2 in one run and 0.6667 in the other (PERF.md §6)."""
    import numpy as np

    from ocl_tpu_torch.tools.spread import deterministic

    print("[resume] {} + {} + {}, cut: num_runs 5 -> 1, num_tasks 5 -> 3, synthetic_size "
          "2000 -> {} a class ({} steps a task); nf 20, batch 10".format(
              GENERAL, SYNTHETIC.format("nc"), ASER_RECIPE, RESUME_SIZE, RESUME_SIZE * 3 // 10))
    with deterministic() as nondeterministic:
        det = resume_sequence(torch, pairwise_sqdist)
    want, got, verified = det["want"], det["got"], det["verified"]
    gap, times, launches = det["gap"], det["times"], det["launches"]
    print("[resume] deterministic algorithms (cuDNN and torch); ops without one: {}".format(
        sorted(nondeterministic) or "none"))
    print("[resume] uninterrupted {:.1f} s, interrupted in task 2 {:.1f} s, resumed {:.1f} s ({}); "
          "checkpoint after task {}; restored {} tensors, generator {}, host state {}: {}".format(
              *times, card, det["meta"]["task"], verified["tensors"],
              "equal" if verified["generator"] else "DIFFERENT",
              "equal" if verified["host"] else "DIFFERENT",
              "bit for bit" if not verified["mismatches"] else
              "MISMATCH at {}".format(verified["mismatches"][:5])))
    print("[resume] accuracy matrix uninterrupted {} resumed {}; largest gap {:.4f} (limit {}); "
          "pairwise_sqdist launches uninterrupted {}, after the restore {}".format(
              np.round(want[0], 4).tolist(), np.round(got[0], 4).tolist(), gap, RESUME_GAP,
              launches[0], launches[1]))
    require("resuming from checkpoint: run 0 after task 1" in det["out"],
            "resume: the third run did not resume after task 1")
    require(not verified["mismatches"] and verified["generator"] and verified["host"],
            "resume: the restored state differs from the saved one")
    require(want.shape == got.shape == (1, 3, 3), "resume: accuracy matrices of shape {} {}".format(
        want.shape, got.shape))
    require(gap <= RESUME_GAP, "resume: the resumed accuracies part by {} > {}".format(
        gap, RESUME_GAP))
    require(launches[1] > 0, "resume: no pairwise_sqdist launch after the restore")

    # the same on the default algorithms: the restore is bit for bit, the sums
    # after it are the card's own order, which ASER's picks can amplify
    default = resume_sequence(torch, pairwise_sqdist)
    print("[resume] default algorithms: uninterrupted {} resumed {}; largest gap {:.4f} (not "
          "gated); restore {}; {:.1f} s for the three runs".format(
              np.round(default["want"][0], 4).tolist(), np.round(default["got"][0], 4).tolist(),
              default["gap"], "bit for bit" if not default["verified"]["mismatches"] else
              "MISMATCH", sum(default["times"])))
    require(not default["verified"]["mismatches"] and default["verified"]["generator"] and
            default["verified"]["host"],
            "resume: on the default algorithms the restored state differs from the saved one")
    return {"seconds": times, "gap": gap, "tensors": verified["tensors"],
            "launches": launches[0], "launches_after_restore": launches[1],
            "acc": want[0].tolist(), "resumed_acc": got[0].tolist(),
            "default_gap": default["gap"], "default_acc": default["want"][0].tolist(),
            "default_resumed_acc": default["got"][0].tolist(),
            "default_seconds": default["times"]}


def count_tensors(torch, tree):
    if isinstance(tree, torch.Tensor):
        return 1
    if isinstance(tree, dict):
        return sum(count_tensors(torch, v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_tensors(torch, v) for v in tree)
    return 0


def run_tune_phase(torch, pairwise_sqdist, card):
    """Phase 19: the tuner over learning_rate {0.05, 0.1}: main_tune, once
    more with --train_val True, then multiple_run_tune's CSV."""
    import csv

    import numpy as np

    from ocl_tpu_torch.config import load_yaml, merge_yaml_params
    from ocl_tpu_torch.experiment.tune import multiple_run_tune
    from ocl_tpu_torch.main_tune import build_parser, main as tune_main

    grid = [0.05, 0.1]
    pairwise_sqdist.launches = 0
    with experiment_dir():
        general = cut_recipe(GENERAL, "general.yml", {
            "num_runs: 5": "num_runs: 1", "num_val: 2": "num_val: 1",
            "num_runs_val: 3": "num_runs_val: 1"})
        data = cut_recipe(SYNTHETIC.format("nc"), "data.yml", {"num_tasks: 5": "num_tasks: 3"},
                          [("synthetic_size", 100)])
        with open("tune.yml", "w") as f:
            f.write("parameters:\n  learning_rate:\n" + "".join("  - {}\n".format(v) for v in grid))
        print("[tune] {} + {} + {} over learning_rate {}, cut: num_runs 5 -> 1, num_val 2 -> 1, "
              "num_runs_val 3 -> 1, num_tasks 5 -> 3, synthetic_size 2000 -> 100 a class (30 "
              "steps a task); nf 20, batch 10".format(GENERAL, SYNTHETIC.format("nc"), ER_RECIPE,
                                                       grid))
        results, times = {}, []
        for train_val in ("False", "True"):
            t0 = time.time()
            results[train_val], _ = quietly(tune_main, build_parser().parse_args([
                "--general", general, "--data", data, "--default", os.path.join(REPO, ER_RECIPE),
                "--tune", "tune.yml", "--train_val", train_val, "--save-path",
                "tv{}.pkl".format(train_val)]))
            times.append(time.time() - t0)
        pickles = {}
        for train_val in ("False", "True"):
            with open("result/synthetic/nc/tv{}.pkl".format(train_val), "rb") as f:
                pickles[train_val] = pickle.load(f)
        params = merge_yaml_params(load_yaml(general), load_yaml(data),
                                   load_yaml(os.path.join(REPO, ER_RECIPE)), verbose=False)
        t0 = time.time()
        quietly(multiple_run_tune, params, {"learning_rate": grid}, "tune.csv")
        times.append(time.time() - t0)
        with open("tables/synthetic/tune.csv") as f:
            rows = list(csv.DictReader(f))
    for train_val, shape in (("False", (1, 2, 2)), ("True", (1, 3, 3))):
        saved = pickles[train_val]
        best = saved["best_params"]
        print("[tune] --train_val {}: {:.1f} s ({}), best {}, acc_array {} {}, RAM {:.0f} MB".format(
            train_val, times[train_val == "True"], card, best, saved["acc_array"].shape,
            [round(float(a), 4) for a in saved["acc_array"][0][-1]], saved["ram"]))
        require(set(saved) == {"seed", "time", "acc_array", "ram", "best_params"},
                "tune: the pickle's keys are {}".format(sorted(saved)))
        require(saved["acc_array"].shape == shape and np.isfinite(saved["acc_array"]).all(),
                "tune: acc_array {} is not a finite {}".format(saved["acc_array"].shape, shape))
        require(len(best) == 1 and best[0]["learning_rate"] in grid,
                "tune: best point {} is not from the grid".format(best))
    print("[tune] multiple_run_tune {:.1f} s ({}): CSV columns {}; rows {}".format(
        times[2], card, list(rows[0]), [(r["Run"], r["learning_rate"], r["Avg_End_Acc"][:8])
                                   for r in rows]))
    require([r["Run"] for r in rows] == ["0", "Final Result"] and
            float(rows[0]["learning_rate"]) in grid and
            {"Batch1", "Batch2", "Avg_End_Acc", "Avg_End_Fgt", "Time"} <= set(rows[0]),
            "tune: the CSV's rows are {}".format(rows))
    print("[tune] pairwise_sqdist launches {}".format(pairwise_sqdist.launches))
    return {"seconds": times, "best": [pickles[k]["best_params"][0]["learning_rate"]
                                       for k in ("False", "True")],
            "launches": pairwise_sqdist.launches}


def run_modes_phase(torch, pairwise_sqdist, card):
    """Phase 20: offline mode through the YAML CLI, then the NI stream
    (noise, occlusion) with --store and --buffer_tracker."""
    import numpy as np

    from ocl_tpu_torch.config import load_yaml, merge_yaml_params
    from ocl_tpu_torch.experiment.run import multiple_run
    from ocl_tpu_torch.main_config import build_parser, main as config_main

    pairwise_sqdist.launches = 0
    out = {}
    with experiment_dir():
        general = cut_recipe(GENERAL_OFFLINE, "general.yml",
                             {"num_runs: 10": "num_runs: 1", "epoch: 70": "epoch: 10"})
        data = cut_recipe(SYNTHETIC.format("nc"), "data.yml", {"num_tasks: 5": "num_tasks: 3"},
                          [("synthetic_size", 200)])
        t0 = time.time()
        acc, _ = quietly(config_main, build_parser().parse_args([
            "--general", general, "--data", data, "--agent", os.path.join(REPO, OFFLINE_RECIPE),
            "--verbose", "False"]))
        out["offline"] = {"acc": float(acc), "seconds": time.time() - t0}
        print("[modes] offline: {} + {} + {} (mem_size 0), cut: num_runs 10 -> 1, epoch 70 -> "
              "10, num_tasks 5 -> 3, synthetic_size 2000 -> 200 a class (1,800 images, 14 steps "
              "of 128 an epoch): avg_end_acc {:.4f}, {:.1f} s ({})".format(
                  GENERAL_OFFLINE, SYNTHETIC.format("nc"), OFFLINE_RECIPE, float(acc),
                  out["offline"]["seconds"], card))
        require(math.isfinite(acc) and acc > 0.5,
                "modes: offline avg_end_acc {} is not above 0.5".format(acc))

        general_ni = cut_recipe(GENERAL, "general_ni.yml", {"num_runs: 5": "num_runs: 1"})
        for ns_type in ("noise", "occlusion"):
            data = load_yaml(os.path.join(REPO, SYNTHETIC.format(ns_type)))
            factors = data["ns_factor"]
            data.update(ns_factor=factors[:3], synthetic_size=300)
            params = merge_yaml_params(load_yaml(general_ni), data,
                                       load_yaml(os.path.join(REPO, ER_RECIPE)),
                                       verbose=False, buffer_tracker=True)
            t0 = time.time()
            _, log = quietly(multiple_run, params, store=True, save_path="ni_{}.pkl".format(ns_type))
            seconds = time.time() - t0
            with open("result/synthetic/ni_{}.pkl".format(ns_type), "rb") as f:
                saved = pickle.load(f)
            tracker = [line for line in log.splitlines() if line.startswith("[buffer_tracker]")]
            acc = saved["acc_array"]
            print("[modes] NI {}: {} + {} + {}, cut: num_runs 5 -> 1, ns_factor {} -> {} (3 "
                  "tasks), synthetic_size 2000 -> 300 a class (100 steps a task): accuracy after "
                  "each task {}; {:.1f} s ({}); tracker: {}".format(
                      ns_type, GENERAL, SYNTHETIC.format(ns_type), ER_RECIPE, factors,
                      factors[:3], [[round(float(a), 4) for a in row] for row in acc[0]], seconds,
                      card, tracker[-1] if tracker else None))
            require(acc.shape == (1, 3, 3) and np.isfinite(acc).all(),
                    "modes: NI {} acc_array {}".format(ns_type, acc.shape))
            require(len(tracker) == 3 and not any("MISMATCH" in line for line in tracker),
                    "modes: NI {} buffer tracker lines {}".format(ns_type, tracker))
            require(acc[0][0][0] > 0.5, "modes: NI {} task 0 accuracy {} is not above 0.5".format(
                ns_type, acc[0][0][0]))
            out[ns_type] = {"acc": acc[0].tolist(), "seconds": seconds}
    print("[modes] pairwise_sqdist launches {}".format(pairwise_sqdist.launches))
    out["launches"] = pairwise_sqdist.launches
    return out


def check_batched_kernel(torch, distance, floor_ms):
    """Phase 21 (b), the kernel: the batched launch against the plain batched
    version at P in BATCHED_POINTS, an exact 0 diagonal of (a, a), vmap's
    route to one launch; then its times with the bound of P single calls and
    torch.cdist's batched call. Returns (rows, max_abs)."""
    from ocl_tpu_torch.tools import kernel_timing as kt

    batched, plain = distance.pairwise_sqdist_batched, distance.pairwise_sqdist_plain_batched
    g = torch.Generator(device="cuda").manual_seed(21)
    rows, max_abs = [], 0.0
    for p in BATCHED_POINTS:
        for n, m, d in BATCHED_SHAPES:
            a = torch.randn(p, n, d, device="cuda", generator=g)
            b = torch.randn(p, m, d, device="cuda", generator=g)
            got = batched(a, b)
            torch.cuda.synchronize()
            abs_err, rel_err = errors(torch, got, plain(a, b))
            require(math.isfinite(abs_err) and rel_err <= MAX_REL and abs_err <= MAX_ABS,
                    "batched kernel disagrees with plain at P {} {}x{}x{}: abs {} rel {}".format(
                        p, n, m, d, abs_err, rel_err))
            max_abs = max(max_abs, abs_err)
            kernel = kt.figures(lambda: batched(a, b))
            plain_f = kt.figures(lambda: plain(a, b))
            library = kt.figures(lambda: torch.cdist(a, b, compute_mode="use_mm_for_euclid_dist"))
            one_ms, bound_by = kt.sqdist_bound(n, m, d)
            rows.append({"points": p, "shape": [n, m, d], "max_abs_err": abs_err,
                         "max_rel_err": rel_err, **kernel, "plain_ms": plain_f["device_ms"],
                         "library_ms": library["device_ms"], "bound_ms": p * one_ms,
                         "bound_by": bound_by, "floor_ms": floor_ms})
            print("[stacked] batched kernel P {} {}x{}x{}: max_abs_err {:.3e} max_rel_err {:.3e}; "
                  "device {:.5f} ms (plain {:.5f}, batched cdist {:.5f}, bound {:.2e} ms by {}, "
                  "floor {:.5f}); host {:.2f} us".format(
                      p, n, m, d, abs_err, rel_err, kernel["device_ms"], plain_f["device_ms"],
                      library["device_ms"], p * one_ms, bound_by, floor_ms, kernel["host_us"]))
        for n in (30, 210):
            a = torch.randn(p, n, 160, device="cuda", generator=g)
            diag = batched(a, a).diagonal(dim1=1, dim2=2)
            require(bool((diag == 0).all()), "batched pairwise_sqdist(a, a) at P {} {}x160 has a "
                    "diagonal entry {} != 0".format(p, n, diag.abs().max().item()))
        print("[stacked] batched pairwise_sqdist(a, a) at P {}, 30 and 210 x 160: diagonal "
              "exactly 0".format(p))
    a = torch.randn(3, 30, 160, device="cuda", generator=g)
    b = torch.randn(3, 20, 160, device="cuda", generator=g)
    before = distance.pairwise_sqdist.launches
    got = torch.func.vmap(distance.pairwise_sqdist)(a, b)
    require(distance.pairwise_sqdist.launches == before + 1 and torch.equal(got, batched(a, b)),
            "vmap(pairwise_sqdist) did not make one batched launch")
    print("[stacked] vmap(pairwise_sqdist) over 3 points: one launch, equal to the batched call")
    return rows, max_abs


def profile_stacked_steps(torch, agent, ss, ctx, xs, ys, steps, pairwise_sqdist):
    """Per-step figures of `steps` stacked steps under torch.profiler:
    launches, device ms, host-clock ms a step, and pairwise_sqdist's
    launches by its counter and by the trace."""
    from torch.profiler import ProfilerActivity, profile

    from ocl_tpu_torch.tools.kernel_timing import busy_ms, kernel_times

    torch.cuda.synchronize()
    before = pairwise_sqdist.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            agent.stacked_step(ss, ctx, xs[:, i], ys[:, i])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = kernel_times(prof)
    counts = {}
    for name, us in kernels:
        n, t = counts.get(name[:60], (0, 0.0))
        counts[name[:60]] = (n + 1, t + us)
    top = sorted(counts.items(), key=lambda kv: -kv[1][1])[:4]
    busy = busy_ms(prof)
    return {"kernels": len(kernels) / steps,
            "device_ms": sum(us for _, us in kernels) / 1e3 / steps,
            "busy_ms": busy / steps, "wall_ms": wall * 1e3 / steps,
            "busy": busy / (wall * 1e3),
            "k1_launches": (pairwise_sqdist.launches - before) / steps,
            "k1_traced": sum(KERNEL in name for name, _ in kernels) / steps,
            "top": [(k, n / steps, t / 1e3 / steps) for k, (n, t) in top]}


def stacked_state_after_task0(torch, flags, grid=None):
    """The stacked state of `flags`' runs after task 0 of the synthetic
    stream, and task 1's batches [P, steps, B, ...] with its context. With
    `grid` (lrs, wds) of G points, the tuner's G x 3 points instead: val run
    r from seed + 1000 + r, each grid point with its own lr and wd."""
    import numpy as np
    from types import SimpleNamespace

    from ocl_tpu_torch.agents.base import stack_ctx
    from ocl_tpu_torch.config import build_parser, finalize
    from ocl_tpu_torch.data import continuum
    from ocl_tpu_torch.experiment.parallel_run import _stack
    from ocl_tpu_torch.registry import agents

    params = finalize(build_parser().parse_args(flags))
    np.random.seed(params.seed)
    stream = continuum(params.data, params.cl_type, params)
    stream.new_run()
    agent = agents[params.agent](params)
    if grid is None:
        ss = _stack([agent.init_state(params.seed + r) for r in range(params.num_runs)])
    else:
        states = [agent.init_state(params.seed + 1000 + r) for r in range(3)]
        ss = _stack([states[r] for _ in grid[0] for r in range(3)],
                    lr=[lr for lr in grid[0] for _ in range(3)],
                    wd=[wd for wd in grid[1] for _ in range(3)])
    p = ss.points
    tasks = []
    for _ in range(2):
        x, y, _ = next(stream)
        ctx = stack_ctx(agent.before_train(y), p)
        xs, ys = agent.batchify(SimpleNamespace(generator=ss.generators[0]), x, y)
        tasks.append((ctx, xs.expand(p, *xs.shape), ys.expand(p, *ys.shape)))
        if len(tasks) == 1:
            agent.stacked_train_task(ss, *tasks[0])
            agent.after_train_stacked(ss, tasks[0][0])
    torch.cuda.synchronize()
    return agent, ss, tasks[1]


def sequential_images_per_s(text, images_a_run):
    """The aggregate images/s of multiple_run's runs from their lines."""
    rates = [float(line.split("throughput")[1].split()[0]) for line in text.splitlines()
             if "stream throughput" in line and "-----------run" in line]
    return len(rates) * images_a_run / sum(images_a_run / r for r in rates)


def run_stacked_phase(torch, distance, card, floor_ms):
    """Phase 21: stacked runs and the stacked tuner (experiment/parallel_run.py,
    experiment/parallel_tune.py): (a) fused ER, 3 runs stacked and sequential;
    (b) ER + ASER stacked and the batched kernel; (c) the 84-point ER grid,
    then phase 19's 2-point grid stacked and sequential; (d) GDumb, iCaRL and
    EWC++ grids stacked."""
    import numpy as np

    from ocl_tpu_torch.config import build_parser, load_yaml, merge_yaml_params
    from ocl_tpu_torch.experiment import parallel_tune
    from ocl_tpu_torch.general_main import main as cli_main
    from ocl_tpu_torch.main_tune import build_parser as tune_parser, main as tune_main

    pairwise_sqdist = distance.pairwise_sqdist
    out = {}
    # (a) stacked against sequential runs through the CLI
    images_a_run = 2 * 50 * 10
    runs = {}
    with experiment_dir():
        for mode in ("stacked", "sequential"):
            flags = STACKED_FLAGS + ["--synthetic_size", "100", "--store", "True", "--save-path",
                                     mode + ".pkl"]
            if mode == "stacked":
                flags += ["--parallel_runs", "True"]
            t0 = time.time()
            _, text = quietly(cli_main, build_parser().parse_args(flags))
            secs = time.time() - t0
            with open("result/synthetic/{}.pkl".format(mode), "rb") as f:
                acc = pickle.load(f)["acc_array"]
            if mode == "stacked":
                line = [ln for ln in text.splitlines() if "aggregate stream throughput" in ln][0]
                ips = float(line.split("throughput")[1].split()[0])
            else:
                ips = sequential_images_per_s(text, images_a_run)
            runs[mode] = {"seconds": secs, "images_per_s": ips,
                          "end_acc": acc[:, -1].mean(axis=1).tolist()}
    gap = max(abs(a - b) for a, b in zip(runs["stacked"]["end_acc"], runs["sequential"]["end_acc"]))
    print("[stacked] (a) fused ER, {} runs x 2 tasks x 50 steps, nf 20 ({}): stacked {:.1f} "
          "images/s aggregate ({:.1f} s), sequential {:.1f} images/s ({:.1f} s), stacked / "
          "sequential {:.2f}x; Avg_End_Acc a run stacked {} sequential {}, largest gap "
          "{:.4f}".format(
              STACKED_RUNS, card, runs["stacked"]["images_per_s"], runs["stacked"]["seconds"],
              runs["sequential"]["images_per_s"], runs["sequential"]["seconds"],
              runs["stacked"]["images_per_s"] / runs["sequential"]["images_per_s"],
              [round(a, 4) for a in runs["stacked"]["end_acc"]],
              [round(a, 4) for a in runs["sequential"]["end_acc"]], gap))
    for mode in runs:
        require(all(a > 0.5 for a in runs[mode]["end_acc"]),
                "stacked (a): a {} run's Avg_End_Acc is not above 0.5: {}".format(
                    mode, runs[mode]["end_acc"]))
    agent, ss, (ctx, xs, ys) = stacked_state_after_task0(torch, STACKED_FLAGS)
    for i in range(2):
        agent.stacked_step(ss, ctx, xs[:, i], ys[:, i])
    prof = profile_stacked_steps(torch, agent, ss, ctx, xs[:, 2:], ys[:, 2:],
                                 STACKED_PROFILE_STEPS, pairwise_sqdist)
    step_ms = STACKED_RUNS * 10 / runs["stacked"]["images_per_s"] * 1e3
    print("[stacked] (a) {} profiled stacked steps of {} runs: {:.0f} launches, {:.3f} ms device "
          "(kernels summed; {:.3f} ms with a kernel running), {:.1f} ms host clock a step under "
          "the profiler (busy {:.1%}); unprofiled step {:.1f} ms (busy {:.1%}); top kernels "
          "{}".format(
              STACKED_PROFILE_STEPS, STACKED_RUNS, prof["kernels"], prof["device_ms"],
              prof["busy_ms"], prof["wall_ms"], prof["busy"], step_ms,
              prof["busy_ms"] / step_ms, prof["top"]))
    out["runs"] = dict(runs, profile=prof, step_ms=step_ms, gap=gap)
    del agent, ss

    # (b) stacked ER + ASER through the CLI, then 3 launches a stacked SV step
    pairwise_sqdist.launches = 0
    t0 = time.time()
    res, _ = quietly(cli_main, build_parser().parse_args(STACKED_ASER_FLAGS +
                                                         ["--parallel_runs", "True"]))
    aser_launches = pairwise_sqdist.launches
    print("[stacked] (b) ER + ASER, {} runs stacked, 2 tasks x 100 steps: Avg_End_Acc {:.4f}, "
          "pairwise_sqdist launches {} ({:.1f} s)".format(
              STACKED_RUNS, float(res[0][0]), aser_launches, time.time() - t0))
    require(aser_launches > 0 and float(res[0][0]) > 0.5,
            "stacked ER + ASER: {} launches, Avg_End_Acc {}".format(aser_launches, res[0][0]))
    agent, ss, (ctx, xs, ys) = stacked_state_after_task0(torch, STACKED_ASER_FLAGS)
    for i in range(2):   # the first step's retrieval is still random (n_seen = mem)
        agent.stacked_step(ss, ctx, xs[:, i], ys[:, i])
    sv = profile_stacked_steps(torch, agent, ss, ctx, xs[:, 2:], ys[:, 2:],
                               STACKED_PROFILE_STEPS, pairwise_sqdist)
    print("[stacked] (b) {} profiled stacked SV steps: pairwise_sqdist {:.1f} launches a step "
          "(counter; {:.1f} in the trace) for {} points; {:.0f} launches, {:.3f} ms device, {:.1f} "
          "ms host clock a step (busy {:.1%})".format(
              STACKED_PROFILE_STEPS, sv["k1_launches"], sv["k1_traced"], STACKED_RUNS,
              sv["kernels"], sv["device_ms"], sv["wall_ms"], sv["busy"]))
    require(sv["k1_launches"] == 3 and sv["k1_traced"] in (0, 3),
            "stacked SV steps launched pairwise_sqdist {} times a step, not 3".format(
                sv["k1_launches"]))
    del agent, ss
    rows, max_abs = check_batched_kernel(torch, distance, floor_ms)
    out["aser"] = {"launches": aser_launches, "per_sv_step": sv, "kernel_rows": rows,
                   "max_abs_err": max_abs}

    # (c) the full ER grid, 84 points, then phase 19's grid stacked and not
    tune_times = {}
    with experiment_dir():
        general = cut_recipe(GENERAL, "general.yml", {
            "num_runs: 5": "num_runs: 1", "num_val: 2": "num_val: 1"})
        general_1 = cut_recipe(GENERAL, "general_1.yml", {
            "num_runs: 5": "num_runs: 1", "num_val: 2": "num_val: 1",
            "num_runs_val: 3": "num_runs_val: 1"})
        data = cut_recipe(SYNTHETIC.format("nc"), "data.yml", {"num_tasks: 5": "num_tasks: 3"},
                          [("synthetic_size", 100)])
        grid = load_yaml(os.path.join(REPO, ER_TUNE))
        points = len(grid["learning_rate"]) * len(grid["weight_decay"]) * 3
        timed = parallel_tune.tune_hyper_parallel

        def timed_tune(*args, **kwargs):
            t = time.time()
            best = timed(*args, **kwargs)
            torch.cuda.synchronize()
            tune_times.setdefault("stacked_tune_s", []).append(time.time() - t)
            return best

        parallel_tune.tune_hyper_parallel = timed_tune
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            result, text = quietly(tune_main, tune_parser().parse_args([
                "--general", general, "--data", data, "--default", os.path.join(REPO, ER_RECIPE),
                "--tune", os.path.join(REPO, ER_TUNE), "--parallel_runs", "True",
                "--save-path", "grid.pkl"]))
            full_s = time.time() - t0
            peak = torch.cuda.max_memory_allocated()
            require("{} stacked tuning states".format(points) in text,
                    "the ER grid did not run its {} points stacked".format(points))
            best = result["best_params"][0]
            require(best["learning_rate"] in grid["learning_rate"] and
                    best["weight_decay"] in grid["weight_decay"],
                    "ER grid: best point {} is not from the grid".format(best))
            with open("tune2.yml", "w") as f:
                f.write("parameters:\n  learning_rate:\n  - 0.05\n  - 0.1\n")
            two = {}
            for stacked in ("True", "False"):
                t0 = time.time()
                r2, _ = quietly(tune_main, tune_parser().parse_args([
                    "--general", general_1, "--data", data, "--default",
                    os.path.join(REPO, ER_RECIPE), "--tune", "tune2.yml", "--parallel_runs",
                    stacked, "--save-path", "two{}.pkl".format(stacked)]))
                two[stacked] = (time.time() - t0, r2["best_params"][0]["learning_rate"])
        finally:
            parallel_tune.tune_hyper_parallel = timed
        params = merge_yaml_params(load_yaml(general), load_yaml(data),
                                   load_yaml(os.path.join(REPO, ER_RECIPE)), verbose=False)
    # the 84 points' stacked steps under the profiler, as the tuner stacks them
    lrs = [lr for lr in grid["learning_rate"] for _ in grid["weight_decay"]]
    wds = [wd for _ in grid["learning_rate"] for wd in grid["weight_decay"]]
    flags = STACKED_FLAGS + ["--num_tasks", "3", "--synthetic_size", "100", "--num_runs", "1"]
    agent, ss, (ctx, xs, ys) = stacked_state_after_task0(torch, flags, (lrs, wds))
    agent.stacked_step(ss, ctx, xs[:, 0], ys[:, 0])
    grid_prof = profile_stacked_steps(torch, agent, ss, ctx, xs[:, 1:], ys[:, 1:],
                                      STACKED_PROFILE_STEPS, pairwise_sqdist)
    del agent, ss
    print("[stacked] (c) {} + {} + {} over {} ({} points: 7 x 4 x num_runs_val 3), cut: num_runs "
          "5 -> 1, num_val 2 -> 1, num_tasks 5 -> 3, synthetic_size 2000 -> 100 a class; nf 20, "
          "batch {} ({}): main_tune {:.1f} s, of it the stacked tune {:.1f} s; peak device "
          "memory {:.2f} GiB; best {}; {} profiled stacked steps: {:.0f} launches, {:.3f} ms "
          "device (kernels summed; {:.3f} ms with a kernel running), {:.1f} ms host clock a step "
          "(busy {:.1%}); top kernels {}".format(
              GENERAL, SYNTHETIC.format("nc"), ER_RECIPE, ER_TUNE, points, params.batch, card,
              full_s, tune_times["stacked_tune_s"][0], peak / 2**30, best, STACKED_PROFILE_STEPS,
              grid_prof["kernels"], grid_prof["device_ms"], grid_prof["busy_ms"],
              grid_prof["wall_ms"], grid_prof["busy"], grid_prof["top"]))
    print("[stacked] (c) phase 19's grid learning_rate {{0.05, 0.1}}, num_runs_val 1: stacked "
          "{:.1f} s (best {}), sequential {:.1f} s (best {})".format(
              two["True"][0], two["True"][1], two["False"][0], two["False"][1]))
    out["grid"] = {"points": points, "seconds": full_s, "tune_s": tune_times["stacked_tune_s"][0],
                   "peak_gib": peak / 2**30, "best": best, "profile": grid_prof,
                   "two_point_s": {"stacked": two["True"][0], "sequential": two["False"][0]}}

    # (d) the other stacked tuners, small grids
    small = {}
    with experiment_dir():
        general = cut_recipe(GENERAL, "general.yml", {
            "num_runs: 5": "num_runs: 1", "num_val: 2": "num_val: 1",
            "num_runs_val: 3": "num_runs_val: 1"})
        general_gdumb = cut_recipe("config/general_1_gdumb.yml", "general_gdumb.yml", {
            "num_runs: 5": "num_runs: 1", "num_val: 2": "num_val: 1",
            "num_runs_val: 3": "num_runs_val: 1"})
        data = cut_recipe(SYNTHETIC.format("nc"), "data.yml", {"num_tasks: 5": "num_tasks: 3"},
                          [("synthetic_size", 100)])
        gdumb = cut_recipe("config/agent/gdumb/gdumb_1k.yml", "gdumb.yml",
                           {"mem_epoch: 30": "mem_epoch: 3"})
        ewc_tune = cut_recipe("config/agent/ewc/ewc_tune.yml", "ewc_tune.yml", {
            "  lambda_:\n  - 0\n  - 100\n  - 1000\n": "  lambda_:\n  - 100\n"})
        cases = [
            ("gdumb", general_gdumb, gdumb, "config/agent/gdumb/gdumb_tune.yml", None,
             "mem_epoch 30 -> 3"),
            ("icarl", general, os.path.join(REPO, "config/agent/icarl/icarl_1k.yml"),
             "config/agent/icarl/icarl_tune.yml", None, ""),
            ("ewc", general, os.path.join(REPO, "config/agent/ewc/ewc.yml"),
             "config/agent/ewc/ewc_tune.yml", ewc_tune, "lambda_ {0, 100, 1000} -> {100}"),
        ]
        for tag, gen, default, tune_file, tune_path, cut in cases:
            tune_path = tune_path or os.path.join(REPO, tune_file)
            grid = load_yaml(tune_path)
            t0 = time.time()
            result, text = quietly(tune_main, tune_parser().parse_args([
                "--general", gen, "--data", data, "--default", default, "--tune", tune_path,
                "--parallel_runs", "True", "--save-path", tag + ".pkl"]))
            secs = time.time() - t0
            best = result["best_params"][0]
            n = len(grid["learning_rate"]) * len(grid["weight_decay"])
            require("{} stacked tuning states".format(n) in text,
                    "{}: the grid did not run its {} points stacked".format(tag, n))
            require(best["learning_rate"] in grid["learning_rate"] and
                    best["weight_decay"] in grid["weight_decay"],
                    "{}: best point {} is not from the grid".format(tag, best))
            print("[stacked] (d) {} over {} ({} points, num_runs_val 1, num_val 1, 3 tasks of 100 "
                  "images a class{}): {:.1f} s ({}), best {}".format(
                      tag, tune_file, n, ", " + cut if cut else "", secs, card, best))
            small[tag] = {"points": n, "seconds": secs, "best": best}
    out["small"] = small

    # (e) the other strategies stacked, through the CLI
    out["strategies"] = run_stacked_strategies(torch)
    return out


def run_stacked_strategies(torch):
    """Phase 21 (e): ER + each strategy of STACKED_STRATEGIES, 3 runs stacked
    through the CLI on the default algorithms; each run's accuracy on its
    latest task (match retrieves the incoming batch's classes only, so the
    earlier task is forgotten by design). Returns them by strategy."""
    import numpy as np

    from ocl_tpu_torch.config import build_parser
    from ocl_tpu_torch.general_main import main as cli_main

    out = {}
    with experiment_dir():
        for tag, flags in STACKED_STRATEGIES:
            t0 = time.time()
            res, _ = quietly(cli_main, build_parser().parse_args(
                STACKED_FLAGS + ["--synthetic_size", str(STRATEGY_SIZE), "--mem_size", "200",
                                 "--parallel_runs", "True", "--store", "True", "--save-path",
                                 tag + ".pkl"] + flags))
            with open("result/synthetic/{}.pkl".format(tag), "rb") as f:
                latest = pickle.load(f)["acc_array"][:, -1, -1]
            print("[stacked] (e) ER + {}, {} runs stacked, 2 tasks x {} steps, mem 200: "
                  "Avg_End_Acc {:.4f}, latest task a run {} ({:.1f} s)".format(
                      tag, STACKED_RUNS, STRATEGY_SIZE * 5 // 10, float(res[0][0]),
                      [round(float(a), 4) for a in latest], time.time() - t0))
            require(np.isfinite(latest).all() and (latest > 0.5).all(),
                    "stacked ER + {}: latest-task accuracies {} not above 0.5".format(tag, latest))
            out[tag] = latest.tolist()
    return out


@contextlib.contextmanager
def k1_shapes(distance):
    """Within the block, a count of each (n, m, d, points) that the kernel
    is launched with (its wrapper's launch count is left as it is)."""
    import collections

    seen = collections.Counter()
    launch = distance._launch

    def recorded(a, b, out, n, m, d, points):
        seen[(n, m, d, points)] += 1
        return launch(a, b, out, n, m, d, points)

    distance._launch = recorded
    try:
        yield seen
    finally:
        distance._launch = launch


def class_images(g, templates, labels, noise, pool=600):
    """uint8 images: the label's template (floats in [0, 1]) plus Gaussian
    noise of `noise` x 255 grey levels, clipped. The noise is drawn for
    `pool` images once and shared round-robin (a 1.27 GB tree in seconds)."""
    import numpy as np

    base = np.round(templates * 255).astype(np.int16)
    pool = min(pool, len(labels))
    draws = np.round(g.normal(0, noise * 255, (pool,) + templates.shape[1:])).astype(np.int16)
    out = np.empty((len(labels),) + templates.shape[1:], np.uint8)
    for i in range(0, len(labels), pool):
        k = min(pool, len(labels) - i)
        out[i: i + k] = np.clip(base[labels[i: i + k]] + draws[:k], 0, 255)
    return out


def write_cifar100(root, seed):
    """cifar-100-python/{train,test} pickles: rows of 3,072 channel-major
    bytes and fine_labels."""
    import numpy as np

    g = np.random.RandomState(seed)
    templates = g.rand(100, 32, 32, 3).astype(np.float32)
    folder = os.path.join(root, "datasets", "cifar100", "cifar-100-python")
    os.makedirs(folder)
    for name, n in (("train", CIFAR100_TRAIN_PER_CLASS), ("test", CIFAR100_TEST_PER_CLASS)):
        y = np.repeat(np.arange(100), n)
        x = class_images(g, templates, y, 0.15)
        with open(os.path.join(folder, name), "wb") as f:
            pickle.dump({b"data": x.transpose(0, 3, 1, 2).reshape(len(y), 3072),
                         b"fine_labels": y.tolist()}, f, protocol=4)


def write_mini_imagenet(root, seed):
    """The three kaggle cache pickles, 64 / 16 / 20 classes of 600 images
    at 84 px: {"image_data": uint8 [n_cls * 600, 84, 84, 3]}, 1.27 GB."""
    import numpy as np

    g = np.random.RandomState(seed)
    templates = g.rand(100, 84, 84, 3).astype(np.float32)
    folder = os.path.join(root, "datasets", "mini_imagenet")
    os.makedirs(folder)
    first = 0
    for split, n_cls in (("train", 64), ("val", 16), ("test", 20)):
        y = np.repeat(np.arange(first, first + n_cls), 600)
        first += n_cls
        with open(os.path.join(folder, "mini-imagenet-cache-{}.pkl".format(split)), "wb") as f:
            pickle.dump({"image_data": class_images(g, templates, y, 0.15)}, f, protocol=4)


def write_core50(root, seed):
    """paths.pkl, LUP.pkl and labels.pkl of the ni protocol, one run: task 0
    names CORE50_TRAIN JPEGs of the 50 classes, tasks 1-7 none (the cut),
    the test set CORE50_TEST; the JPEGs at 128 px, written by PIL."""
    import numpy as np
    from PIL import Image

    g = np.random.RandomState(seed)
    templates = g.rand(CORE50_CLASSES, 128, 128, 3).astype(np.float32)
    folder = os.path.join(root, "datasets", "core50")
    n = CORE50_TRAIN + CORE50_TEST
    y = g.permutation(np.arange(n) % CORE50_CLASSES)
    x = class_images(g, templates, y, 0.15)
    paths = []
    for i in range(n):
        rel = os.path.join("imgs", "s{}".format(y[i]), "i{}.jpg".format(i))
        os.makedirs(os.path.join(folder, os.path.dirname(rel)), exist_ok=True)
        Image.fromarray(x[i]).save(os.path.join(folder, rel), quality=90)
        paths.append(rel)
    train, test = list(range(CORE50_TRAIN)), list(range(CORE50_TRAIN, n))
    lup = {"ni": [[train] + [[] for _ in range(7)] + [test]]}
    labels = {"ni": [[y[train].tolist()] + [[] for _ in range(7)] + [y[test].tolist()]]}
    for name, obj in (("paths.pkl", paths), ("LUP.pkl", lup), ("labels.pkl", labels)):
        with open(os.path.join(folder, name), "wb") as f:
            pickle.dump(obj, f)


def write_openloris(root, seed):
    """The occlusion factor's tree, datasets/openloris/occlusion/<split>/
    task<i>/<object>/*.jpg for the 9 tasks: DATAPATH's first
    OPENLORIS_OBJECTS objects, JPEGs of 64 x 64 written by PIL (the loader
    resizes them to 50 x 50). An image's label is its object's index, so
    0-9 here: from index 69 on a label passes the 69-class head, which
    neither package handles (ROADMAP.md §3)."""
    import numpy as np
    from PIL import Image

    from ocl_tpu_torch.data.openloris_objects import DATAPATH

    g = np.random.RandomState(seed)
    templates = g.rand(OPENLORIS_OBJECTS, 64, 64, 3).astype(np.float32)
    for task in range(1, 10):
        for split, n in (("train", OPENLORIS_TRAIN), ("test", OPENLORIS_TEST)):
            y = np.repeat(np.arange(OPENLORIS_OBJECTS), n)
            for i, (img, label) in enumerate(zip(class_images(g, templates, y, 0.15), y)):
                folder = os.path.join(root, "datasets", "openloris", "occlusion", split,
                                      "task{}".format(task), DATAPATH[label])
                os.makedirs(folder, exist_ok=True)
                Image.fromarray(img).save(os.path.join(folder, "{}.jpg".format(i)), quality=90)


@contextlib.contextmanager
def k1_inputs(distance):
    """Within the block, a count of each (a.dtype, b.dtype) that the kernel
    is launched with."""
    import collections

    seen = collections.Counter()
    launch = distance._launch

    def recorded(a, b, out, n, m, d, points):
        seen[(str(a.dtype), str(b.dtype))] += 1
        return launch(a, b, out, n, m, d, points)

    distance._launch = recorded
    try:
        yield seen
    finally:
        distance._launch = launch


def recipe_params(general, data, agent, **cuts):
    """The recipe's merged parameters (as main_config merges them) on the
    card, with `cuts` over them."""
    from ocl_tpu_torch.config import load_yaml, merge_yaml_params

    files = [load_yaml(os.path.join(REPO, f)) for f in (general, data, agent)]
    return merge_yaml_params(*files, verbose=False, device="cuda", **cuts)


def run_data_task(torch, distance, params, tag, steps=None):
    """One task of `params`' stream through the port's agent at nf 20 (cut
    to `steps` batches if given, evenly spaced over the task so that every
    class stays in it): the task trained (host clock, synced),
    evaluated on every task's test set (all resident on the card), then
    DATA_PROFILE_STEPS more steps of it under torch.profiler. Returns the
    figures."""
    import random

    import numpy as np

    from ocl_tpu_torch.data import continuum, prepare_test_loaders
    from ocl_tpu_torch.registry import agents

    device = torch.device(params.device)
    np.random.seed(params.seed)
    random.seed(params.seed)
    t0 = time.time()
    stream = continuum(params.data, params.cl_type, params)
    stream.new_run()
    x, y, labels = next(stream)
    if steps is not None:   # every class of the task, in the stream's order
        keep = np.linspace(0, len(y) - 1, steps * params.batch).round().astype(int)
        x, y = x[keep], y[keep]
    load_s = time.time() - t0
    agent = agents[params.agent](params)
    state = agent.init_state(params.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loaders = prepare_test_loaders(stream.test_data(), params, device)
    resident = sum(t.numel() * t.element_size() for loader in loaders for t in loader)
    n_test = sum(int(loader[2].sum()) for loader in loaders)
    distance.pairwise_sqdist.launches = 0
    with k1_shapes(distance) as shapes:
        t0 = time.time()
        state = agent.train_learner(state, x, y)
        torch.cuda.synchronize()
        train_s = time.time() - t0
    launches = distance.pairwise_sqdist.launches
    acc = agent.evaluate(state, loaders)
    images = (len(y) // params.batch) * params.batch
    per_step = profile_steps(torch, agent, state, agent.before_train(y), x, y, DATA_PROFILE_STEPS)
    peak = torch.cuda.max_memory_allocated()
    step_ms = params.batch / (images / train_s) * 1e3
    fig = {"images": images, "classes": len(labels), "images_per_s": images / train_s,
           "load_s": load_s, "acc": float(acc[0]), "acc_all": [float(a) for a in acc],
           "launches": launches, "shapes": sorted(shapes.items()), "test_images": n_test,
           "test_resident_gib": resident / 2 ** 30, "peak_gib": peak / 2 ** 30,
           "step_ms": step_ms, "busy": per_step["device_ms"] / step_ms, **per_step}
    print("[data] {} nf {}, task 0 ({} images, {} classes, {} steps; stream set up in {:.1f} "
          "s): accuracy on it {:.4f}, {:.1f} images/s; test sets {} images resident on the card, "
          "{:.3f} GiB; pairwise_sqdist launches {}, shapes (n, m, d, points): launches {}; {} "
          "profiled steps: {:.0f} launches, {:.3f} ms device, {:.1f} ms host clock a step, busy "
          "{:.1%} of the unprofiled {:.1f} ms step; peak device memory {:.3f} GiB".format(
              tag, params.nf, len(y), len(labels), images // params.batch, load_s, fig["acc"],
              fig["images_per_s"], n_test, fig["test_resident_gib"], launches,
              fig["shapes"], DATA_PROFILE_STEPS, per_step["kernels"], per_step["device_ms"],
              per_step["wall_ms"], fig["busy"], step_ms, fig["peak_gib"]))
    require(np.isfinite(acc).all(), "data: {} has a non-finite accuracy".format(tag))
    require(fig["acc"] > 0.5, "data: {} task 0 accuracy {} is not above 0.5".format(
        tag, fig["acc"]))
    return fig


def run_data_phase(torch, distance, card):
    """Phase 22: (a) CIFAR-100 through main_config, (b) Mini-ImageNet and
    (c) CORe50 one task each, on trees written here; then the full CORe50
    test set's residency on the card; (d) OpenLORIS through general_main."""
    import numpy as np

    import ocl_tpu_torch.experiment.run as run_mod
    from ocl_tpu_torch.config import build_parser as cli_parser
    from ocl_tpu_torch.data import continuum, prepare_test_loaders
    from ocl_tpu_torch.general_main import main as cli_main
    from ocl_tpu_torch.main_config import build_parser, main as config_main
    from ocl_tpu_torch.tools.spread import deterministic

    seed = cli_parser().get_default("seed")
    pairwise_sqdist = distance.pairwise_sqdist
    out = {}
    with experiment_dir() as tmp:
        # (a) CIFAR-100, all 10 tasks through the YAML CLI
        t0 = time.time()
        write_cifar100(tmp, seed)
        write_s = time.time() - t0
        general = cut_recipe(CVPR_GENERAL, "general.yml", {"num_runs: 10": "num_runs: 1"})
        matrices = []
        compute_performance = run_mod.compute_performance

        def recorded(acc):
            matrices.append(np.array(acc))
            return compute_performance(acc)

        run_mod.compute_performance = recorded
        pairwise_sqdist.launches = 0
        try:
            with k1_shapes(distance) as shapes:
                t0 = time.time()
                _, log = quietly(config_main, build_parser().parse_args([
                    "--general", general, "--data", os.path.join(REPO, CIFAR100_DATA),
                    "--agent", os.path.join(REPO, ASER_RECIPE), "--verbose", "False"]))
                run_s = time.time() - t0
        finally:
            run_mod.compute_performance = compute_performance
        launches = pairwise_sqdist.launches
        acc = matrices[0][0]
        own = np.diag(acc)
        tput = [line for line in log.splitlines() if "stream throughput" in line][0]
        ips = float(tput.split("throughput")[1].split()[0])
        out["cifar100"] = {"acc": acc.tolist(), "own": own.tolist(), "launches": launches,
                           "shapes": sorted(shapes.items()), "images_per_s": ips,
                           "seconds": run_s, "write_s": write_s}
        print("[data] (a) CIFAR-100: {} + {} + {} through main_config, nf 20, cut: num_runs 10 "
              "-> 1, {} of 500 train images a class ({} steps a task), test set as published "
              "({} a class; tree written in {:.1f} s): {:.1f} s ({}); {:.1f} images/s; each "
              "task's accuracy on its own test set after training it {}; Avg_End_Acc {:.4f}; "
              "pairwise_sqdist launches {}, shapes (n, m, d, points): launches {}".format(
                  CVPR_GENERAL, CIFAR100_DATA, ASER_RECIPE, CIFAR100_TRAIN_PER_CLASS,
                  CIFAR100_TRAIN_PER_CLASS, CIFAR100_TEST_PER_CLASS, write_s, run_s, card, ips,
                  [round(float(a), 4) for a in own], float(acc[-1].mean()), launches,
                  out["cifar100"]["shapes"]))
        require(acc.shape == (10, 10) and np.isfinite(acc).all(),
                "data: CIFAR-100 accuracy matrix {}".format(acc.shape))
        require(launches > 0, "data: the CIFAR-100 ASER run launched no pairwise_sqdist kernel")
        require(own.min() > 0.5, "data: a CIFAR-100 task read {} after training it".format(
            own.min()))

        # (b) Mini-ImageNet at full size, one task
        t0 = time.time()
        write_mini_imagenet(tmp, seed)
        write_s = time.time() - t0
        params = recipe_params(CVPR_GENERAL, MINI_DATA, MINI_RECIPE, num_runs=1)
        print("[data] (b) Mini-ImageNet: {} + {} + {}, cut: num_runs 10 -> 1, task 0 of 10, {} "
              "steps of 500 ({} images of each class's 500); "
              "the cache pickles at full size (60,000 images, written in {:.1f} s)".format(
                  CVPR_GENERAL, MINI_DATA, MINI_RECIPE, MINI_STEPS, MINI_STEPS, write_s))
        out["mini_imagenet"] = run_data_task(torch, distance, params, "(b) Mini-ImageNet",
                                             MINI_STEPS)
        require(out["mini_imagenet"]["launches"] > 0,
                "data: the Mini-ImageNet ASER run launched no pairwise_sqdist kernel")
        require(all(s[0][2] == 640 for s in out["mini_imagenet"]["shapes"]),
                "data: Mini-ImageNet's kernel shapes are not at d 640")
        # phase 23 (d): the same task in bf16 on this tree (printed there)
        params = recipe_params(CVPR_GENERAL, MINI_DATA, MINI_RECIPE, num_runs=1,
                               compute_dtype="bf16")
        t0 = time.time()
        with k1_inputs(distance) as dtypes:
            out["mini_imagenet_bf16"] = run_data_task(torch, distance, params,
                                                      "(23 d) Mini-ImageNet in bf16", MINI_STEPS)
        out["mini_imagenet_bf16"].update(seconds=time.time() - t0, k1_dtypes=dict(dtypes))
        shutil.rmtree(os.path.join(tmp, "datasets", "mini_imagenet"))

        # (c) CORe50 ni: decode once into the bin cache, then train from it
        t0 = time.time()
        write_core50(tmp, seed)
        write_s = time.time() - t0
        params = recipe_params(GENERAL, CORE50_DATA, ER_RECIPE, num_runs=1)
        t0 = time.time()
        first = continuum(params.data, params.cl_type, params)
        first.new_run()
        next(first)
        decode_s = time.time() - t0
        print("[data] (c) CORe50: {} + {} + {}, cut: num_runs 5 -> 1, task 0 of 8 ({} train "
              "images, 60 a class) and {} test images of 44,972; {} JPEGs written in {:.1f} s, "
              "decoded into the bin cache in {:.1f} s ({:.0f} images/s)".format(
                  GENERAL, CORE50_DATA, ER_RECIPE, CORE50_TRAIN, CORE50_TEST,
                  CORE50_TRAIN + CORE50_TEST, write_s, decode_s,
                  (CORE50_TRAIN + CORE50_TEST) / decode_s))
        # on deterministic algorithms: on the default ones the task's accuracy
        # with running BN statistics spreads from 0.15 to 1.00 between runs of
        # one seed (2 of 16 <= 0.5, each >= 0.97 on batch statistics; PERF.md §6)
        with deterministic() as nondeterministic:
            out["core50"] = run_data_task(torch, distance, params, "(c) CORe50 ni")
        print("[data] (c) ran on deterministic algorithms (cuDNN and torch); ops without one: "
              "{}".format(sorted(nondeterministic) or "none"))
        out["core50"].update(decode_s=decode_s)
        require(out["core50"]["launches"] == 0, "data: plain ER launched pairwise_sqdist")

        # the full CORe50 test set, resident on the card as the runner keeps it
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.time()
        big = prepare_test_loaders([(np.zeros((CORE50_FULL_TEST, 128, 128, 3), np.float32),
                                     np.zeros(CORE50_FULL_TEST, np.int64))], params,
                                   params.device)
        torch.cuda.synchronize()
        full_s = time.time() - t0
        full_gib = (torch.cuda.memory_allocated() - before) / 2 ** 30
        del big
        torch.cuda.empty_cache()
        out["core50"].update(full_test_gib=full_gib, full_test_s=full_s)
        print("[data] (c) the full CORe50 test set ({} images at 128 px, test_batch {}) resident "
              "on the card: {:.3f} GiB, prepared in {:.1f} s".format(
                  CORE50_FULL_TEST, params.test_batch, full_gib, full_s))
        shutil.rmtree(os.path.join(tmp, "datasets", "core50"))

        # (d) OpenLORIS through the flag CLI, all 9 tasks
        t0 = time.time()
        write_openloris(tmp, seed)
        write_s = time.time() - t0
        t0 = time.time()
        _, log = quietly(cli_main, cli_parser().parse_args(OPENLORIS_FLAGS))
        run_s = time.time() - t0
        with open(os.path.join("result", "openloris", "openloris.pkl"), "rb") as f:
            acc = pickle.load(f)["acc_array"][0]
        own = np.diag(acc)
        tput = [line for line in log.splitlines() if "stream throughput" in line][0]
        ips = float(tput.split("throughput")[1].split()[0])
        out["openloris"] = {"acc": acc.tolist(), "own": own.tolist(), "images_per_s": ips,
                            "seconds": run_s, "write_s": write_s}
        print("[data] (d) OpenLORIS occlusion through general_main ({}), ER, nf 20, mem 1000, "
              "cut: {} objects of 121 (labels 0-{}), {} train and {} test JPEGs of 64 px an "
              "object a task (written in {:.1f} s), 9 tasks of {} steps: {:.1f} s ({}); {:.1f} "
              "images/s; each task's accuracy on its own test set after training it {}".format(
                  " ".join(OPENLORIS_FLAGS), OPENLORIS_OBJECTS, OPENLORIS_OBJECTS - 1,
                  OPENLORIS_TRAIN, OPENLORIS_TEST, write_s,
                  OPENLORIS_OBJECTS * OPENLORIS_TRAIN * 9 // 10 // 10, run_s, card, ips,
                  [round(float(a), 4) for a in own]))
        require(acc.shape == (9, 9) and np.isfinite(acc).all(),
                "data: OpenLORIS accuracy matrix {}".format(acc.shape))
        require(own.min() > 0.5, "data: OpenLORIS's tasks read {} after training each".format(
            own.tolist()))
    return out


@contextlib.contextmanager
def conv_dtypes(torch):
    """Within the block, the set of output dtypes of every Conv2d."""
    seen = set()

    def hook(module, inputs, out):
        if isinstance(module, torch.nn.Conv2d):
            seen.add(out.dtype)

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        yield seen
    finally:
        handle.remove()


def stored_run(cli_main, parser, flags):
    """general_main on `flags` in a temporary working directory with --store:
    (accuracy array [runs, tasks, tasks], the run's printed text)."""
    with experiment_dir():
        _, text = quietly(cli_main, parser.parse_args(flags + ["--store", "True",
                                                               "--save-path", "run.pkl"]))
        with open(os.path.join("result", "synthetic", "run.pkl"), "rb") as f:
            acc = pickle.load(f)["acc_array"]
    return acc, text


def throughput(text, aggregate=False):
    """images/s of the run's 'stream throughput' line (the stacked runner's
    aggregate line if `aggregate`)."""
    key = "aggregate stream throughput" if aggregate else "stream throughput"
    line = [ln for ln in text.splitlines() if key in ln][0]
    return float(line.split("throughput")[1].split()[0])


def resnet_step(torch, name, dtype, device, flops=None):
    """Figures of one ResNet at nf 64, 32 px: ms a training step (SGD, CE;
    RESNET_STEPS steps after 3 warm, host clock, synced), the peak device
    memory of the model, its optimizer, inputs and steps above what was
    allocated before, and the FLOPs of one step by utils/flops.py (on
    copies; counted unless `flops` is given: autocast adds only casts,
    which count nothing)."""
    from ocl_tpu_torch.models import forward_train, init_model, resnet
    from ocl_tpu_torch.ops.losses import cross_entropy
    from ocl_tpu_torch.optim import setup_opt
    from ocl_tpu_torch.utils.flops import estimate_fn_flops

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = getattr(resnet, name)(10, input_size=32, compute_dtype=dtype)
    model = init_model(model, torch.Generator().manual_seed(0)).to(device)
    opt = setup_opt("SGD", model.parameters(), 0.1)
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.rand(RESNET_BATCH, 32, 32, 3, device=device, generator=g)
    y = torch.randint(0, 10, (RESNET_BATCH,), device=device, generator=g)

    def step(model, opt, x, y):
        opt.zero_grad()
        cross_entropy(forward_train(model, x), y).backward()
        opt.step()

    for _ in range(3):
        step(model, opt, x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS):
        step(model, opt, x, y)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / RESNET_STEPS
    peak = torch.cuda.max_memory_allocated() - base
    if flops is None:
        flops = estimate_fn_flops(step, model, opt, x, y)
    return {"ms": ms, "peak_gib": peak / 2 ** 30, "flops": flops, "gflop": flops / 1e9,
            "tflops": flops / (ms / 1e3) / 1e12}


def card_vs_cpu(torch, model, x, device):
    """(max abs, max rel) gap of `model`'s train-mode logits (batch
    statistics, no gradients) on the card against a CPU copy's, same
    weights and input."""
    import copy

    from ocl_tpu_torch.models import forward_train

    cpu = copy.deepcopy(model)
    with torch.no_grad():
        got = forward_train(model.to(device), x.to(device)).cpu()
        want = forward_train(cpu, x)
    err = (got - want).abs()
    return err.max().item(), (err / want.abs().clamp_min(1e-6)).max().item(), \
        bool(torch.allclose(got, want, rtol=1e-3, atol=1e-4))


def run_bf16_phase(torch, distance, card, fp32, device):
    """Phase 23: --compute_dtype bf16 on the card. `fp32` holds the fp32
    figures this call measured: phase 4's images/s and SV-step profile,
    phase 21 (a)'s stacked images/s, phase 22 (b)'s Mini-ImageNet task and
    its bf16 twin."""
    import tempfile

    from ocl_tpu_torch.config import build_parser, finalize
    from ocl_tpu_torch.general_main import main as cli_main
    from ocl_tpu_torch.models import init_model, resnet
    from ocl_tpu_torch.models.pretrained import ResNet18_pretrained, save_npz
    from ocl_tpu_torch.tools.kernel_timing import busy_ms, device_events, trace_events
    from ocl_tpu_torch.utils.profiling import TRACE_FILE

    pairwise_sqdist = distance.pairwise_sqdist
    parser = build_parser()
    out = {}

    # (a) ER + ASER through general_main; K1 on fp32 features, convs in bf16
    pairwise_sqdist.launches = 0
    with conv_dtypes(torch) as convs, k1_inputs(distance) as k1, k1_shapes(distance) as shapes:
        t0 = time.time()
        acc, text = stored_run(cli_main, parser, BF16_RUN_FLAGS)
        run_s = time.time() - t0
    launches = pairwise_sqdist.launches
    latest = float(acc[0, -1, -1])
    ips = throughput(text)
    with tempfile.TemporaryDirectory() as tmp:
        per_step, traced = profile_sv_steps(torch, device, MAIN_FLAGS + BF16, "bf16",
                                            os.path.join(tmp, "trace"))
        events = trace_events(os.path.join(tmp, "trace", TRACE_FILE), "kernel")
    print("[bf16] (a) ER + ASER in bf16 nf 20, phase 4's 2 tasks x 100 steps ({:.1f} s, {}): task 1 "
          "{:.4f} after training it, {:.1f} images/s (phase 4, fp32: {:.1f}); convolution "
          "outputs {}; pairwise_sqdist launches {}, inputs (dtype a, dtype b): launches {}, "
          "shapes (n, m, d, points): launches {}; a profiled SV step {:.0f} launches, {:.3f} ms "
          "device (phase 4, fp32: {:.0f}, {:.3f} ms)".format(
              run_s, card, latest, ips, fp32["main_ips"], sorted(str(d) for d in convs),
              launches, dict(k1), sorted(shapes.items()), per_step["kernels"],
              per_step["device_ms"], fp32["main_step"]["kernels"],
              fp32["main_step"]["device_ms"]))
    require(launches > 0, "bf16 (a): the run launched no pairwise_sqdist kernel")
    require(set(k1) == {("torch.float32", "torch.float32")},
            "bf16 (a): pairwise_sqdist got {}".format(dict(k1)))
    require(convs == {torch.bfloat16}, "bf16 (a): convolution outputs {}".format(convs))
    require(math.isfinite(latest) and latest > 0.5,
            "bf16 (a): task 1 read {} after training it".format(latest))
    out["er_aser"] = {"launches": launches, "shapes": sorted(shapes.items()),
                      "images_per_s": ips, "latest_acc": latest, **per_step}

    # (f) the trace of TRACE_STEPS more SV steps names K1
    names = [name for name, *_ in device_events(traced)]
    k1_events = [name for name, *_ in events if KERNEL in name]
    print("[bf16] (f) utils/profiling.py::trace of {} SV steps: {} device events ({:.3f} ms with "
          "a kernel running), {} {} kernels in the Chrome trace ({} kernel events)".format(
              TRACE_STEPS, len(names), busy_ms(traced), len(k1_events), KERNEL, len(events)))
    require(any(KERNEL in n for n in names) and k1_events,
            "bf16 (f): the trace names no {} kernel".format(KERNEL))

    # (b) SCR in bf16
    with conv_dtypes(torch) as convs:
        tag, label, flags, n_tasks, prof_steps = SCR_BF16
        out["scr"], _ = run_family_phase(torch, device, tag, label, flags, n_tasks, prof_steps,
                                         pairwise_sqdist)
    require(convs == {torch.bfloat16}, "bf16 (b): convolution outputs {}".format(convs))

    # (c) 3 fused-ER runs stacked in bf16, as phase 21 (a)
    with conv_dtypes(torch) as convs:
        t0 = time.time()
        acc, text = stored_run(cli_main, parser, STACKED_FLAGS + BF16 + [
            "--synthetic_size", "100", "--parallel_runs", "True"])
        run_s = time.time() - t0
    latest = acc[:, -1, -1]
    ips = throughput(text, aggregate=True)
    print("[bf16] (c) {} fused-ER runs stacked in bf16, 2 tasks x 50 steps ({:.1f} s, {}): "
          "{:.1f} images/s aggregate (phase 21 (a), fp32: {:.1f}); each run's task 1 after "
          "training it {}; convolution outputs {}".format(
              STACKED_RUNS, run_s, card, ips, fp32["stacked_ips"],
              [round(float(a), 4) for a in latest], sorted(str(d) for d in convs)))
    require(convs == {torch.bfloat16}, "bf16 (c): convolution outputs {}".format(convs))
    require(bool((latest > 0.5).all()), "bf16 (c): a run's task 1 read {}".format(latest))
    out["stacked"] = {"images_per_s": ips, "latest_acc": latest.tolist()}

    # (d) two runs that load the card, in fp32 and in bf16
    loads = {}
    for dtype in ("fp32", "bf16"):
        params = finalize(parser.parse_args(B128_FLAGS + ["--compute_dtype", dtype]))
        loads[dtype] = run_data_task(torch, distance, params,
                                     "(23 d) ER batch 128, 128 memory rows, {}".format(dtype))
    loads["mini_fp32"], loads["mini_bf16"] = fp32["mini"], fp32["mini_bf16"]
    for tag in ("", "mini_"):
        a, b = loads[tag + "fp32"], loads[tag + "bf16"]
        print("[bf16] (d) {} ({}): images/s {:.1f} fp32, {:.1f} bf16 ({:.2f}x); device ms a "
              "step {:.3f} / {:.3f} ({:.2f}x); busy {:.1%} / {:.1%}; peak {:.3f} / {:.3f} "
              "GiB".format(
                  "Mini-ImageNet task 0, ER + ASER, 84 px" if tag else
                  "ER, batch 128 + 128 memory rows, 32 px", card,
                  a["images_per_s"], b["images_per_s"], b["images_per_s"] / a["images_per_s"],
                  a["device_ms"], b["device_ms"], a["device_ms"] / b["device_ms"], a["busy"],
                  b["busy"], a["peak_gib"], b["peak_gib"]))
    require(set(fp32["mini_bf16"]["k1_dtypes"]) == {("torch.float32", "torch.float32")},
            "bf16 (d): Mini-ImageNet's pairwise_sqdist got {}".format(
                fp32["mini_bf16"]["k1_dtypes"]))
    out["loads"] = {k: {f: v[f] for f in ("images_per_s", "device_ms", "busy", "peak_gib")}
                    for k, v in loads.items()}

    # (e) the ResNet family at nf 64, fp32 and bf16; the card against the CPU
    rows = {}
    for name in RESNETS:
        f = resnet_step(torch, name, "fp32", device)
        b = resnet_step(torch, name, "bf16", device, f["flops"])
        rows[name] = {"fp32": f, "bf16": b}
        print("[bf16] (e) {} nf 64, 32 px, batch {} ({}): a training step {:.2f} ms fp32, {:.2f} "
              "ms bf16 ({:.2f}x); peak {:.3f} / {:.3f} GiB; {:.3f} GFLOP a step (utils/flops.py), "
              "{:.2f} / {:.2f} TFLOP/s".format(
                  name, RESNET_BATCH, card, f["ms"], b["ms"], f["ms"] / b["ms"], f["peak_gib"],
                  b["peak_gib"], f["gflop"], f["tflops"], b["tflops"]))
    g = torch.Generator().manual_seed(2)
    for name in ("ResNet18", "ResNet50"):
        model = init_model(getattr(resnet, name)(10, input_size=32), g)
        abs_err, rel_err, close = card_vs_cpu(torch, model, torch.rand(RESNET_BATCH, 32, 32, 3,
                                                                       generator=g), device)
        print("[bf16] (e) {} fp32 (TF32 off), card against CPU logits: max_abs_err {:.3e} "
              "max_rel_err {:.3e}".format(name, abs_err, rel_err))
        require(close, "bf16 (e): {}'s card logits are not within rtol 1e-3 / atol 1e-4 of the "
                       "CPU's".format(name))
        rows.setdefault(name, {})["card_vs_cpu"] = abs_err
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "trunk.npz")
        save_npz(init_model(resnet.ResNet18(10, input_size=PRETRAINED_SIZE), g), npz)
        model = ResNet18_pretrained(10, npz, torch.Generator().manual_seed(3), PRETRAINED_SIZE)
    abs_err, rel_err, close = card_vs_cpu(torch, model, torch.rand(
        2, PRETRAINED_SIZE, PRETRAINED_SIZE, 3, generator=g), device)
    print("[bf16] (e) ResNet18_pretrained from a written .npz at {} px, card against CPU logits: "
          "max_abs_err {:.3e} max_rel_err {:.3e}".format(PRETRAINED_SIZE, abs_err, rel_err))
    require(close, "bf16 (e): ResNet18_pretrained's card logits are not within rtol 1e-3 / "
                   "atol 1e-4 of the CPU's")
    out["resnets"] = rows
    return out


# phase 24: --n_devices on one card, two ranks sharing cuda:0 over gloo (NCCL
# refuses two ranks on one GPU). (a) general_main --n_devices 2, ER + ASER,
# MAIN_FLAGS cut to 2 tasks x 50 steps; (b) the data-parallel ER + ASER step
# over a slot-sharded buffer at nf 20, batch 10 split 5/5, 10 retrieved rows,
# from a memory of 1,000 filled from task 0: DP_STEPS steps, the first beside
# one rank's; (c)-(d) tools/dryrun.py's patterns at nf 20 (SCR, GSS, the
# CN-DPM wake step, the softmax and NCM fan-out on SCR's model, the grid
# tune); (e) phase 21 (a)'s 3 stacked fused-ER runs dealt to 2 ranks; (f) the
# DP ER step under NCCL at world size 1, and NCCL's answer to two ranks on
# one card; (g) in (b)'s launch, DP_FAMILY's agents and strategies over
# (b)'s memory, DP_FAMILY_STEPS steps each, the first beside one process's
DP_RANKS = 2
DP_CLI_FLAGS = MAIN_FLAGS + ["--num_tasks", "2", "--synthetic_size", "100",
                             "--n_devices", str(DP_RANKS)]
DP_FLAGS = MAIN_FLAGS + ["--num_tasks", "2"]
DP_STEPS = 9    # cut from 12: the script's time
DP_PROFILE_STEPS = 3    # cut from 4: the script's time
DP_DRAW_SEED = 24
MAX_MARGIN = 1e-4
# phase 24 (g): (tag, flags over DP_FLAGS, K1 launches a step). The ASER
# update launches K1 once a step, ASER's asvm retrieval twice (ER + ASER's
# 3 in (b) are both); scr_1k's flags as SCR's (phase 15)
DP_FAMILY_STEPS = 3
RANDOM_RANDOM = ["--update", "random", "--retrieve", "random"]
DP_FAMILY = [
    ("er_mir", ["--update", "random", "--retrieve", "MIR", "--subsample", "50"], 0),
    ("er_mem_match", ["--update", "random", "--retrieve", "mem_match"], 0),
    ("er_mir_aser", ["--update", "ASER", "--retrieve", "MIR", "--subsample", "50"], 1),
    ("agem_aser", ["--agent", "AGEM", "--update", "random", "--retrieve", "ASER"], 2),
    ("ewc", ["--agent", "EWC", "--learning_rate", "0.01"] + RANDOM_RANDOM, 0),
    ("lwf", ["--agent", "LWF", "--learning_rate", "0.01"] + RANDOM_RANDOM, 0),
    ("er_kd_labels", RANDOM_RANDOM + ["--kd_trick", "True", "--labels_trick", "True"], 0),
    ("scr_aser", SCR[2][:-len(HALF)] + ["--update", "ASER", "--retrieve", "random"], 1),
]
_DP_TASKS = {}   # the first two tasks of a stream, by its flags


def dp_tasks(params):
    """(x0, y0), (x1, y1): the first two tasks of the stream of `params`,
    made once a process."""
    import numpy as np

    from ocl_tpu_torch.data import continuum

    key = (params.data, params.cl_type, params.num_tasks, params.synthetic_size, params.seed)
    if key not in _DP_TASKS:
        np.random.seed(params.seed)
        stream = continuum(params.data, params.cl_type, params)
        np.random.seed(params.seed)
        stream.new_run()
        (x0, y0, _), (x1, y1, _) = next(stream), next(stream)
        _DP_TASKS[key] = (x0, y0), (x1, y1)
    return _DP_TASKS[key]


def dp_draws(agent, g, host, b):
    """One step's draws of `agent` (as its `step` takes them) from generator
    `g` and, for SCR's jitter order, `host`; None for EWC++ and LwF."""
    if hasattr(agent, "draw"):
        return agent.draw(g, b)
    if not hasattr(agent, "retrieve"):
        return None
    from ocl_tpu_torch.ops.augment import draw_scr_transform

    rows = agent.params.eps_mem_batch + b
    return {"iters": [{"retrieve": agent.retrieve.draw(g, b),
                       "aug": draw_scr_transform(g, host, rows, agent.image_hw)}
                      for _ in range(int(agent.params.mem_iters))],
            "update": agent.update.draw(g, b)}


def dp_setup(torch, device, flags, steps=DP_STEPS):
    """Phase 24 (b)'s and (g)'s agent, state, ctx, batches and draws, alike
    in every process: the weights of init_state(seed), a memory of 1,000
    drawn from task 0 (so every ASER step takes its SV paths), `steps`
    batches of task 1 at task_seen 1, each step's draws from a generator of
    its own; a distillation teacher with the weights of the next seed,
    switched on."""
    import random

    import numpy as np

    from ocl_tpu_torch.config import build_parser, finalize
    from ocl_tpu_torch.registry import agents

    params = finalize(build_parser().parse_args(flags + ["--device", str(device)]))
    (x0, y0), (x1, y1) = dp_tasks(params)
    agent = agents[params.agent](params)
    teacher = agent.init_state(params.seed + 1).model if agent.needs_kd else None
    state = agent.init_state(params.seed)
    if teacher is not None:
        state.agent["teacher"].load_state_dict(teacher.state_dict())
        state.agent["has_teacher"].fill_(1.0)
    buf = state.buffer
    if buf is not None:
        pick = np.random.RandomState(0).permutation(len(y0))[: buf.mem_size]
        buf.imgs.copy_(torch.from_numpy(x0[pick]))
        buf.labels.copy_(torch.from_numpy(y0[pick].astype(np.int64)))
        buf.class_counts.copy_(torch.bincount(buf.labels, minlength=buf.class_counts.shape[0]))
        buf.current_index, buf.n_seen_so_far = buf.mem_size, len(y0)
    agent.task_seen, agent.old_labels = 1, sorted(set(int(v) for v in y0))
    ctx = agent.before_train(y1)
    b = params.batch
    xs = torch.from_numpy(x1[: steps * b]).reshape(steps, b, *x1.shape[1:]).to(device)
    ys = torch.from_numpy(y1[: steps * b].astype(np.int64)).reshape(steps, b).to(device)
    g = torch.Generator(device=device).manual_seed(DP_DRAW_SEED)
    host = random.Random(DP_DRAW_SEED)
    draws = [dp_draws(agent, g, host, b) for _ in range(steps)]
    return agent, state, ctx, xs, ys, draws


def model_checksum(torch, model):
    return float(sum(t.double().sum() for t in model.state_dict().values()))


def scaled_errors(torch, a, b, got, want):
    """(max abs error, max abs error over the largest ||a_i||^2 + ||b_j||^2):
    K1 computes ||a||^2 + ||b||^2 - 2 a.b, so its rounding scales with the
    terms it cancels, not with the distance, which for features that nearly
    coincide is far smaller and makes a relative error meaningless."""
    err = (got - want).abs().max().item()
    scale = (a.square().sum(1).max() + b.square().sum(1).max()).item()
    return err, err / max(scale, torch.finfo(torch.float32).tiny)


def sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def first_step_state(torch, agent, state, loss):
    """What phase 24 (g) holds a first step by: weights, buffer labels and
    counter (whole), the loss, EWC++'s temporary Fisher."""
    from ocl_tpu_torch.parallel.sharded_buffer import ShardedBuffer, gather_buffer

    out = {"sd": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
           "loss": loss}
    buf = state.buffer
    if buf is not None:
        buf = gather_buffer(buf) if isinstance(buf, ShardedBuffer) else buf
        out["labels"], out["current_index"] = buf.labels.cpu().clone(), buf.current_index
    if isinstance(state.agent, dict) and "tmp_fisher" in state.agent:
        out["fisher"] = {k: v.cpu().clone() for k, v in state.agent["tmp_fisher"].items()}
    return out


def dp_family_rank(torch, mesh, flags):
    """Phase 24 (g) in one rank: DP_FAMILY_STEPS DP steps of each of
    DP_FAMILY over a slot-sharded buffer, the first under deterministic
    algorithms; their figures, K1's launches (the count set to 0 just
    before each configuration's steps, read just after) and K1 against its
    plain version at the shapes they gave it."""
    from ocl_tpu_torch.ops import distance, knn_sv
    from ocl_tpu_torch.parallel import dp
    from ocl_tpu_torch.parallel.sharded_buffer import shard_buffer
    from ocl_tpu_torch.tools.spread import deterministic

    kernel = knn_sv.pairwise_sqdist
    out = {}
    for tag, extra, _ in DP_FAMILY:
        agent, state, ctx, xs, ys, draws = dp_setup(torch, mesh.device, flags + extra,
                                                    DP_FAMILY_STEPS)
        if state.buffer is not None:
            state.buffer = shard_buffer(state.buffer, mesh)
        task = dp.make_dp_train_task(agent, mesh)
        shapes = {}

        def recording(a, b):
            shapes.setdefault((a.shape[0], b.shape[0], a.shape[1]), (a.clone(), b.clone()))
            return kernel(a, b)

        knn_sv.pairwise_sqdist = recording
        distance.pairwise_sqdist.launches = 0
        try:
            with deterministic():
                state, m = task(state, ctx, xs[:1], ys[:1], draws[:1])
            losses = m["loss"].tolist()
            first = first_step_state(torch, agent, state, losses[0])   # gathers: every rank
            fig = {"first": first if mesh.rank == 0 else None}
            sums = [model_checksum(torch, state.model)]
            sync(torch, mesh.device)
            calls, secs, t0 = mesh.calls, mesh.seconds, time.perf_counter()
            for i in range(1, DP_FAMILY_STEPS):
                state, m = task(state, ctx, xs[i:i + 1], ys[i:i + 1], draws[i:i + 1])
                losses += m["loss"].tolist()
                sums.append(model_checksum(torch, state.model))
            sync(torch, mesh.device)
            timed = DP_FAMILY_STEPS - 1
            fig.update(step_ms=(time.perf_counter() - t0) * 1e3 / timed,
                       collectives=(mesh.calls - calls) / timed,
                       collective_ms=(mesh.seconds - secs) * 1e3 / timed,
                       launches=distance.pairwise_sqdist.launches, losses=losses)
        finally:
            knn_sv.pairwise_sqdist = kernel
        every = mesh.all_gather(torch.tensor([sums], dtype=torch.float64, device=mesh.device))
        fig["checksums_agree"] = bool((every == every[0]).all())
        errs = []
        for (n, mm, d), (a, b) in sorted(shapes.items()):
            got = distance.pairwise_sqdist(a, b)
            sync(torch, mesh.device)
            errs.append(((n, mm, d),) + scaled_errors(torch, a, b, got,
                                                      distance.pairwise_sqdist_plain(a, b)))
        fig["kernel_checks"] = errs
        out[tag] = fig
    return out


def dp_rank(flags, nf, stacked_flags, workdir):
    """Phase 24 (b)-(e) and (g) in one rank: the DP ER + ASER steps of
    `flags`, their figures and checks, K1 against its plain version at the
    shapes they gave it, (g)'s configurations over `flags`,
    tools/dryrun.py's patterns at base width `nf`, then the stacked runs of
    `stacked_flags` dealt to the ranks, in `workdir`."""
    import torch

    from ocl_tpu_torch import parallel
    from ocl_tpu_torch.ops import distance, knn_sv
    from ocl_tpu_torch.parallel import dp
    from ocl_tpu_torch.parallel.sharded_buffer import gather_buffer, shard_buffer
    from ocl_tpu_torch.tools import dryrun
    from ocl_tpu_torch.tools.kernel_timing import kernel_times
    from ocl_tpu_torch.tools.spread import deterministic
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    mesh = parallel.get_mesh()
    agent, state, ctx, xs, ys, draws = dp_setup(torch, mesh.device, flags)
    state.buffer = shard_buffer(state.buffer, mesh)
    task = dp.make_dp_train_task(agent, mesh)
    shapes = {}
    kernel = knn_sv.pairwise_sqdist

    def recording(a, b):
        shapes.setdefault((a.shape[0], b.shape[0], a.shape[1]), (a.clone(), b.clone()))
        return kernel(a, b)

    knn_sv.pairwise_sqdist = recording
    out = {"rank": mesh.rank}
    sums = []
    distance.pairwise_sqdist.launches = 0
    with deterministic():
        state, m = task(state, ctx, xs[:1], ys[:1], draws[:1])
    whole = gather_buffer(state.buffer)
    out["one"] = {"sd": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
                  "labels": whole.labels.cpu().clone(), "current_index": whole.current_index,
                  "loss": float(m["loss"][0])}
    sums.append(model_checksum(torch, state.model))
    timed = DP_STEPS - 1 - DP_PROFILE_STEPS
    sync(torch, mesh.device)
    calls, secs, t0 = mesh.calls, mesh.seconds, time.perf_counter()
    for i in range(1, 1 + timed):
        state, m = task(state, ctx, xs[i:i + 1], ys[i:i + 1], draws[i:i + 1])
        sums.append(model_checksum(torch, state.model))
    sync(torch, mesh.device)
    wall = time.perf_counter() - t0
    out["images_per_s"] = timed * xs.shape[1] / wall
    out["collectives"] = (mesh.calls - calls) / timed
    out["collective_ms"] = (mesh.seconds - secs) * 1e3 / timed
    out["step_ms"] = wall * 1e3 / timed
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(1 + timed, DP_STEPS):
            state, m = task(state, ctx, xs[i:i + 1], ys[i:i + 1], draws[i:i + 1])
        sync(torch, mesh.device)
    kernels = kernel_times(prof)
    k1 = [us for name, us in kernels if KERNEL in name]
    out["launches"] = distance.pairwise_sqdist.launches
    knn_sv.pairwise_sqdist = kernel
    sums.append(model_checksum(torch, state.model))
    out["profile"] = {"kernels": len(kernels) / DP_PROFILE_STEPS,
                      "device_ms": sum(us for _, us in kernels) / 1e3 / DP_PROFILE_STEPS,
                      "k1_launches": len(k1) / DP_PROFILE_STEPS,
                      "k1_device_ms": sum(k1) / 1e3 / DP_PROFILE_STEPS}
    every = mesh.all_gather(torch.tensor([sums], dtype=torch.float64, device=mesh.device))
    out["checksums_agree"] = bool((every == every[0]).all())
    out["final_loss"] = float(m["loss"][-1])
    # K1 against its plain version at every shape the DP steps gave it
    # (these launches come after the count was read)
    errs = []
    for (n, mm, d), (a, b) in sorted(shapes.items()):
        got = distance.pairwise_sqdist(a, b)
        sync(torch, mesh.device)
        errs.append(((n, mm, d),) + scaled_errors(torch, a, b, got,
                                                  distance.pairwise_sqdist_plain(a, b)))
    out["kernel_checks"] = errs
    t0 = time.time()
    out["family"] = dp_family_rank(torch, mesh, flags)
    out["family_s"] = time.time() - t0
    out["dryrun"] = dryrun.run_patterns(nf)

    from ocl_tpu_torch.config import build_parser
    from ocl_tpu_torch.general_main import main as cli_main

    os.chdir(workdir)
    t0 = time.time()
    cli_main(build_parser().parse_args(stacked_flags + [
        "--synthetic_size", "100", "--parallel_runs", "True", "--n_devices", str(mesh.size),
        "--store", "True", "--save-path", "dp_stacked.pkl"]))
    mesh.barrier()   # rank 0 has written the accuracies
    with open("result/synthetic/dp_stacked.pkl", "rb") as f:
        acc = pickle.load(f)["acc_array"]
    out["stacked"] = {"seconds": time.time() - t0, "end_acc": acc[:, -1].mean(axis=1).tolist()}
    return out


def nccl_rank(flags):
    """Phase 24 (f): two DP steps of fused ER under the group's backend."""
    import torch

    from ocl_tpu_torch import parallel
    from ocl_tpu_torch.parallel import dp
    from ocl_tpu_torch.parallel.sharded_buffer import shard_buffer

    mesh = parallel.get_mesh()
    agent, state, ctx, xs, ys, draws = dp_setup(
        torch, mesh.device, flags + ["--update", "random", "--retrieve", "random"])
    state.buffer = shard_buffer(state.buffer, mesh)
    state, m = dp.make_dp_train_task(agent, mesh)(state, ctx, xs[:2], ys[:2], draws[:2])
    return {"backend": mesh.backend, "loss": m["loss"].tolist(),
            "checksum": model_checksum(torch, state.model)}


@contextlib.contextmanager
def launch_limit(seconds):
    """Within the block, a launch of ranks that outlasts `seconds` stops
    them and raises (parallel/mesh.py's LAUNCH_TIMEOUT_S)."""
    from ocl_tpu_torch.parallel import mesh

    old, mesh.LAUNCH_TIMEOUT_S = mesh.LAUNCH_TIMEOUT_S, seconds
    try:
        yield
    finally:
        mesh.LAUNCH_TIMEOUT_S = old


def top2_margin(torch, logits):
    """The gap between each row's two largest logits."""
    top = logits.topk(2, dim=1).values
    return top[:, 0] - top[:, 1]


def check_dp_family(torch, device, card, dp_flags, ranks):
    """Phase 24 (g)'s prints and gates, each configuration's first DP step
    held against one process's; returns each configuration's figures."""
    from ocl_tpu_torch.tools.spread import deterministic

    out = {}
    for tag, extra, per_step in DP_FAMILY:
        agent, state, ctx, xs, ys, draws = dp_setup(torch, device, dp_flags + extra,
                                                    DP_FAMILY_STEPS)
        with deterministic():
            agent.step(state, ctx, xs[0], ys[0], draws=draws[0])
        one = first_step_state(torch, agent, state, None)
        figs = [r["family"][tag] for r in ranks]
        first = figs[0]["first"]
        diff = max(float((v - first["sd"][k]).abs().max()) for k, v in one["sd"].items())
        buffer_equal = "labels" not in one or (
            torch.equal(one["labels"], first["labels"])
            and one["current_index"] == first["current_index"])
        fisher = None
        if "fisher" in one:
            scale = max(float(v.abs().max()) for v in one["fisher"].values())
            fisher = max(float((v - first["fisher"][k]).abs().max())
                         for k, v in one["fisher"].items()) / max(scale, 1e-30)
        out[tag] = {"param_diff": diff, "fisher_rel": fisher, "ranks": [
            {k: f[k] for k in ("step_ms", "collectives", "collective_ms", "launches",
                               "kernel_checks", "checksums_agree", "losses")} for f in figs]}
        print("[dp] (g) {} ({} ranks sharing one card, {}): {:.1f} ms a DP step, {:.0f} "
              "collectives a step ({:.1f} ms in them) on rank 0 ({:.1f} / {:.0f} / {:.1f} on "
              "rank 1); losses {}; first step against one process's: max parameter "
              "difference {:.3e}, buffer equal {}{}; K1 launches a rank {} in {} steps "
              "(expected {} a step); K1 against plain at {}; checksums agree {}".format(
                  tag, DP_RANKS, card, figs[0]["step_ms"], figs[0]["collectives"],
                  figs[0]["collective_ms"], figs[-1]["step_ms"], figs[-1]["collectives"],
                  figs[-1]["collective_ms"], [round(v, 4) for v in figs[0]["losses"]], diff,
                  buffer_equal, "" if fisher is None else
                  ", temporary Fisher within {:.2e} of its largest entry".format(fisher),
                  [f["launches"] for f in figs], DP_FAMILY_STEPS, per_step,
                  [(list(sh), "{:.2e}".format(a), "{:.2e}".format(q))
                   for sh, a, q in figs[0]["kernel_checks"]],
                  all(f["checksums_agree"] for f in figs)))
        require(diff < 1e-3 and buffer_equal and (fisher is None or fisher < 1e-3),
                "(g) {}: the DP step departs from one process's".format(tag))
        for r, f in enumerate(figs):
            require(f["checksums_agree"], "(g) {}: the ranks' parameters differ".format(tag))
            require(all(math.isfinite(v) for v in f["losses"]),
                    "(g) {}: a non-finite loss on rank {}".format(tag, r))
            require(device.type != "cuda" or f["launches"] == per_step * DP_FAMILY_STEPS,
                    "(g) {}: rank {} launched K1 {} times in {} steps, not {} a step".format(
                        tag, r, f["launches"], DP_FAMILY_STEPS, per_step))
            require(bool(f["kernel_checks"]) == (per_step > 0),
                    "(g) {}: K1 ran at shapes {} on rank {}".format(
                        tag, [c[0] for c in f["kernel_checks"]], r))
            for shape, abs_err, scaled in f["kernel_checks"]:
                require(math.isfinite(abs_err) and abs_err <= MAX_ABS and scaled <= MAX_REL,
                        "(g) {}: K1 disagrees with plain at {} on rank {}".format(tag, shape, r))
    print("[dp] (g) {} configurations in {:.1f} s on the ranks".format(
        len(DP_FAMILY), ranks[0]["family_s"]))
    return out


def run_dp_phase(torch, card, device, cli_flags=DP_CLI_FLAGS, dp_flags=DP_FLAGS,
                 stacked_flags=STACKED_FLAGS, nf=20):
    """Phase 24 (a)-(g) (see DP_CLI_FLAGS' comment); returns its figures.
    The flags and `nf` are the card's; a rehearsal on the CPU gives its own
    (and leaves (f), which needs NCCL, to the card)."""
    import numpy as np

    from ocl_tpu_torch import parallel
    from ocl_tpu_torch.config import build_parser, finalize
    from ocl_tpu_torch.data import continuum, prepare_test_loaders
    from ocl_tpu_torch.general_main import main as cli_main
    from ocl_tpu_torch.models import forward_eval
    from ocl_tpu_torch.registry import agents
    from ocl_tpu_torch.tools.spread import deterministic
    from ocl_tpu_torch.utils import checkpoint

    out = {}
    # (a) the CLI; then rank 0's final state, from its checkpoint, evaluated
    # by one process on every test row
    t0 = time.time()
    with experiment_dir() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        flags = cli_flags + ["--store", "True", "--save-path", "dp.pkl", "--ckpt_dir", ckpt]
        with launch_limit(600):
            res, text = quietly(cli_main, build_parser().parse_args(flags))
        layout = [ln for ln in text.splitlines() if ln.startswith("[parallel]")]
        with open("result/synthetic/dp.pkl", "rb") as f:
            acc = pickle.load(f)["acc_array"]
        params = finalize(build_parser().parse_args(flags[:-2] + ["--n_devices", "0"]))
        np.random.seed(params.seed)
        stream = continuum(params.data, params.cl_type, params)
        np.random.seed(params.seed)
        stream.new_run()
        loaders = prepare_test_loaders(stream.test_data(), params, device)
        agent = agents["ER"](params)
        state, meta = checkpoint.load_checkpoint(ckpt, agent.init_state(params.seed))
        checkpoint.restore_agent_meta(agent, meta["agent"])
        one = agent.evaluate(state, loaders)
        totals = np.array([int(m.sum()) for _, _, m in loaders])
        fan = np.rint(acc[0, -1] * totals).astype(int)
        single = np.rint(one * totals).astype(int)
        margin = min(float(top2_margin(torch, forward_eval(state.model, xb))[mb].min())
                     for x, _, m in loaders for xb, mb in zip(x, m))
    out["cli"] = {"seconds": time.time() - t0, "avg_end_acc": float(res[0][0]),
                  "fan_out_counts": fan.tolist(), "one_rank_counts": single.tolist(),
                  "smallest_margin": margin}
    print("[dp] (a) general_main --n_devices {}, ER + ASER nf {}, 2 tasks x 50 steps ({}): {}; "
          "Avg_End_Acc {:.4f}; final eval's correct counts fanned out {} / one rank on the same "
          "state {}; smallest top-2 logit margin {:.3e}; {:.1f} s".format(
              DP_RANKS, nf, card, layout[0] if layout else "no layout line", float(res[0][0]),
              fan.tolist(), single.tolist(), margin, out["cli"]["seconds"]))
    where = "cuda:0 x{}".format(DP_RANKS) if device.type == "cuda" else "on the CPU"
    require(layout and "backend gloo" in layout[0] and where in layout[0],
            "the CLI printed no layout line of {} ranks ({}) over gloo".format(DP_RANKS, where))
    require(np.array_equal(fan, single) or margin < MAX_MARGIN,
            "the fanned-out counts {} differ from one rank's {} with no logit margin under "
            "{}".format(fan.tolist(), single.tolist(), MAX_MARGIN))
    require(math.isfinite(float(res[0][0])) and acc[0, -1, -1] > 0.5,
            "the --n_devices run's last task reads {}".format(acc[0, -1]))

    # (b)-(e) the DP step, beside one rank's step; the dry run's patterns;
    # the stacked runs dealt to the ranks
    t0 = time.time()
    with experiment_dir() as tmp, launch_limit(600):
        ranks = parallel.launch(dp_rank, (dp_flags, nf, stacked_flags, tmp), DP_RANKS,
                                device.type)
    agent, state, ctx, xs, ys, draws = dp_setup(torch, device, dp_flags)
    with deterministic():
        agent.step(state, ctx, xs[0], ys[0], draws=draws[0])
    sd = state.model.state_dict()
    r0 = ranks[0]["one"]
    diff = max(float((sd[k].cpu() - r0["sd"][k]).abs().max()) for k in sd)
    labels_equal = torch.equal(state.buffer.labels.cpu(), r0["labels"])
    out["step"] = {"param_diff": diff, "ranks": [{k: r[k] for k in (
        "launches", "images_per_s", "step_ms", "collectives", "collective_ms", "profile",
        "checksums_agree", "kernel_checks")} for r in ranks], "seconds": time.time() - t0}
    for r in ranks:
        print("[dp] (b) rank {} of {} ranks sharing one card ({}): K1 launches {} in {} DP ER + "
              "ASER steps; {:.1f} images/s, {:.1f} ms a step, {:.0f} collectives a step ({:.2f} "
              "ms in them); profiled: {:.0f} kernels, {:.3f} ms device a step, K1 {:.1f} "
              "launches, {:.5f} ms a step; parameter checksums agree after every step: {}".format(
                  r["rank"], DP_RANKS, card, r["launches"], DP_STEPS, r["images_per_s"],
                  r["step_ms"], r["collectives"], r["collective_ms"], r["profile"]["kernels"],
                  r["profile"]["device_ms"], r["profile"]["k1_launches"],
                  r["profile"]["k1_device_ms"], r["checksums_agree"]))
        print("[dp] (b) rank {}: K1 against its plain version at the DP step's shapes (n, m, d): "
              "max abs error (limit {}) and its ratio to the largest ||a||^2 + ||b||^2 (limit "
              "{}): {}".format(r["rank"], MAX_ABS, MAX_REL,
                               [(list(sh), "{:.2e}".format(a), "{:.2e}".format(q))
                                for sh, a, q in r["kernel_checks"]]))
    for r in ranks:
        for shape, abs_err, scaled in r["kernel_checks"]:
            require(math.isfinite(abs_err) and abs_err <= MAX_ABS and scaled <= MAX_REL,
                    "rank {}: K1 disagrees with plain at the DP step's {}".format(r["rank"], shape))
        require(r["launches"] > 0 or device.type != "cuda",
                "rank {} launched no K1 in the DP ASER step".format(r["rank"]))
        require(r["checksums_agree"], "the ranks' parameters differ after a DP step")
    print("[dp] (b) one DP step against one rank's: max parameter difference {:.3e}, "
          "current_index {} / {}, buffer labels equal {}".format(
              diff, r0["current_index"], state.buffer.current_index, labels_equal))
    require(diff < 1e-3 and labels_equal and r0["current_index"] == state.buffer.current_index,
            "the DP step departs from one rank's step")
    out["family"] = check_dp_family(torch, device, card, dp_flags, ranks)
    dr = ranks[0]["dryrun"]
    print("[dp] (c)-(d) the dry run's patterns at nf {} on {} ranks: parameters agree {}, losses "
          "{}, NCM fan-out / unsharded accuracy on SCR's model {}; {:.1f} s".format(
              nf, DP_RANKS, dr["agree"], {k: round(v, 4) for k, v in dr["loss"].items()},
              dr["ncm"], dr["seconds"]))
    require(dr["ncm"][0] == dr["ncm"][1], "the NCM fan-out departs from the unsharded eval")

    # (e) phase 21 (a)'s stacked runs, dealt to the ranks (in the same launch)
    out["stacked"] = ranks[0]["stacked"]
    end_acc = out["stacked"]["end_acc"]
    print("[dp] (e) {} stacked fused-ER runs dealt to {} ranks, 2 tasks x 50 steps, nf {} ({}): "
          "Avg_End_Acc a run {}; {:.1f} s".format(STACKED_RUNS, DP_RANKS, nf, card,
                                                [round(a, 4) for a in end_acc],
                                                out["stacked"]["seconds"]))
    require(all(a > 0.5 for a in end_acc), "a dealt stacked run reads {}".format(end_acc))

    # (f) NCCL: world size 1, then two ranks on the one card
    if device.type != "cuda":
        return out
    t0 = time.time()
    with launch_limit(300):
        one = parallel.launch(nccl_rank, (dp_flags,), 1, "cuda", backend="nccl")[0]
        try:
            parallel.launch(nccl_rank, (dp_flags,), 2, "cuda", backend="nccl")
            answer = "NCCL ran two ranks on one card"
        except Exception as e:   # expected: NCCL refuses a duplicate GPU
            lines = [ln.strip() for ln in str(e).splitlines() if ln.strip()]
            answer = next((ln for ln in lines if "Duplicate GPU" in ln),
                          lines[-1] if lines else "")
    out["nccl"] = {"world_1": one, "two_ranks_one_card": answer, "seconds": time.time() - t0}
    print("[dp] (f) DP ER step under NCCL at world size 1: losses {}; two NCCL ranks on one card: "
          "{}; {:.1f} s".format([round(v, 4) for v in one["loss"]], answer,
                                out["nccl"]["seconds"]))
    require(one["backend"] == "nccl" and all(math.isfinite(v) for v in one["loss"]),
            "the NCCL step at world size 1 failed")
    return out


def main():
    script_t0 = time.time()
    import torch

    # 1. device
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print("[device] {} | count {} | torch {} cuda {}".format(
        kind, torch.cuda.device_count(), torch.__version__, torch.version.cuda))
    print(card)
    device = torch.device("cuda")

    # 2. build
    from ocl_tpu_torch.ops import _build, distance
    from ocl_tpu_torch.ops.distance import pairwise_sqdist, pairwise_sqdist_plain

    t0 = time.time()
    so = _build.build("pairwise_sqdist.cu")
    _build.load_library("pairwise_sqdist.cu")
    print("[build] pairwise_sqdist {} in {:.1f} s".format(so.name, time.time() - t0))
    log = so.with_suffix(".log")
    for line in (log.read_text().splitlines() if log.exists() else []):
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("[build] ptxas: " + line.strip())
    # the plan counts its waves at distance.BLOCKS_PER_SM blocks an SM: hold
    # that against CUDA's occupancy calculator for the kernel as built
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for vec in (4, 1):
        plan = distance.launch_plan(210, 210, 160, vec)
        blocks = _build.load_library("pairwise_sqdist.cu").ocl_pairwise_sqdist_blocks_per_sm(
            distance.c_plan(210, 210, 160, vec)[1])
        print("[build] {}-byte copies: {} blocks an SM ({} SMs); 210x210x160 is {} blocks, "
              "{} wave(s)".format(4 * vec, blocks, sms, plan.grid, -(-plan.grid // (sms * blocks))))
        require(blocks >= distance.BLOCKS_PER_SM and sms >= distance.SMS,
                "the plan's {} blocks an SM on {} SMs do not hold on this card".format(
                    distance.BLOCKS_PER_SM, distance.SMS))

    # 3. kernel against plain, then its times
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    max_abs = check_kernel(torch, distance, device)
    shapes, floor, profiler_ms = time_kernel(torch, pairwise_sqdist, pairwise_sqdist_plain, device)

    # 4. main path: ER + ASER through the CLI
    from ocl_tpu_torch.config import build_parser
    from ocl_tpu_torch.general_main import main as cli_main

    tee = Tee(sys.stdout)
    pairwise_sqdist.launches = 0
    t0 = time.time()
    with contextlib.redirect_stdout(tee):
        result = cli_main(build_parser().parse_args(MAIN_RUN_FLAGS))
    main_s = time.time() - t0
    launches = pairwise_sqdist.launches
    avg_end_acc = float(result[0][0])
    tput = [line for line in tee.buf.getvalue().splitlines() if "stream throughput" in line]
    print("[main] ER+ASER nf 20, 2 tasks x 100 steps: Avg_End_Acc {:.4f}, pairwise_sqdist "
          "launches {}, wall {:.1f} s".format(avg_end_acc, launches, main_s))
    print("[main] " + tput[0].strip("-"))
    require(launches > 0, "the main path launched no pairwise_sqdist kernel")
    require(math.isfinite(avg_end_acc) and avg_end_acc > 0.5,
            "Avg_End_Acc {} is not above 0.5".format(avg_end_acc))
    per_step = profile_sv_steps(torch, device)

    # 5. default ER (random update + retrieval, two-pass), one task
    import numpy as np

    from ocl_tpu_torch.config import finalize
    from ocl_tpu_torch.data import continuum, prepare_test_loaders
    from ocl_tpu_torch.registry import agents

    flags = MAIN_FLAGS + ["--update", "random", "--retrieve", "random", "--fused_replay", "False"]
    params = finalize(build_parser().parse_args(flags))
    np.random.seed(params.seed)
    stream = continuum(params.data, params.cl_type, params)
    stream.new_run()
    x, y, labels = next(stream)
    agent = agents["ER"](params)
    state = agent.init_state(params.seed)
    loaders = prepare_test_loaders(stream.test_data(), params, device)
    t0 = time.time()
    state = agent.train_learner(state, x, y)
    torch.cuda.synchronize()
    er_s = time.time() - t0
    acc0 = float(agent.evaluate(state, loaders)[0])
    print("[er] random/random two-pass nf 20, task 0 ({} images, labels {}): accuracy {:.4f}, "
          "{:.1f} images/s".format(len(y), sorted(int(v) for v in labels), acc0,
                                   (len(y) // params.batch) * params.batch / er_s))
    require(math.isfinite(acc0) and acc0 > 0.5, "ER task-0 accuracy {} is not above 0.5".format(acc0))

    # 6-12. the rest of the replay family
    family, runs = {}, {}
    for tag, label, flags, n_tasks, prof_steps in FAMILY + [ICARL]:
        t0 = time.time()
        family[tag], runs[tag] = run_family_phase(torch, device, tag, label, flags, n_tasks,
                                                  prof_steps, pairwise_sqdist)
        family[tag]["phase_s"] = time.time() - t0

    # 14. GDumb
    t0 = time.time()
    family["gdumb"] = run_gdumb_phase(torch, device, pairwise_sqdist)
    family["gdumb"]["phase_s"] = time.time() - t0

    # 15. SCR, with the review epochs timed and the augmentation profiled
    t0 = time.time()
    review_s = []
    tag, label, flags, n_tasks, prof_steps = SCR
    family[tag], runs[tag] = run_family_phase(torch, device, tag, label, flags, n_tasks,
                                              prof_steps, pairwise_sqdist,
                                              agent_hook=time_review(torch, review_s))
    scr_agent, scr_state, _ = runs[tag]
    rows = scr_agent.params.eps_mem_batch + scr_agent.params.batch
    aug = profile_augment(torch, device, scr_state, rows)
    family[tag].update(review_s=review_s, augment=aug, phase_s=time.time() - t0)
    print("[scr] augmentation on {} images: {} launches, {:.3f} ms device a call (draws "
          "included); review epoch after each task {} s".format(
              rows, aug["kernels"], aug["device_ms"], [round(t, 2) for t in review_s]))

    # 16. error analysis on phase 6's model
    family["errors"] = run_error_analysis(torch, *runs["fused"])

    # 17. CN-DPM
    t0 = time.time()
    family["cndpm"] = run_cndpm_phase(torch, device, pairwise_sqdist)
    family["cndpm"]["phase_s"] = time.time() - t0

    # 18-20. the experiment layer: resume, tuner, offline and NI
    for tag, run_phase in (("resume", run_resume_phase), ("tune", run_tune_phase),
                           ("modes", run_modes_phase)):
        t0 = time.time()
        family[tag] = run_phase(torch, pairwise_sqdist, card)
        family[tag]["phase_s"] = time.time() - t0

    # 21. stacked runs and the stacked tuner, the batched kernel
    t0 = time.time()
    stacked = run_stacked_phase(torch, distance, card, floor["device_ms"])
    family["stacked"] = {"phase_s": time.time() - t0}

    # 22. the dataset loaders: CIFAR-100, Mini-ImageNet, CORe50; the kernel
    # at every shape their runs launched it with
    t0 = time.time()
    data = run_data_phase(torch, distance, card)
    run_shapes = sorted({s[0][:3] for tag in ("cifar100", "mini_imagenet")
                         for s in data[tag]["shapes"]})
    g = torch.Generator(device=device).manual_seed(2)
    for n, m, d in run_shapes:
        scale = min(1.0, (160 / d) ** 0.5)
        a = torch.randn(n, d, device=device, generator=g) * scale
        b = torch.randn(m, d, device=device, generator=g) * scale
        got = pairwise_sqdist(a, b)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(torch, got, pairwise_sqdist_plain(a, b))
        max_abs = max(max_abs, abs_err)
        print("[data] kernel at the run's shape {}x{}x{}: max_abs_err {:.3e} max_rel_err "
              "{:.3e}".format(n, m, d, abs_err, rel_err))
        require(math.isfinite(abs_err) and rel_err <= MAX_REL and abs_err <= MAX_ABS,
                "kernel disagrees with plain at the run's shape {}x{}x{}".format(n, m, d))
    family["data"] = {"phase_s": time.time() - t0}
    print("[data] phase 22: {:.1f} s ({}), of which Mini-ImageNet in bf16 (23 d) {:.1f} s".format(
        family["data"]["phase_s"], card, data["mini_imagenet_bf16"]["seconds"]))

    # 23. --compute_dtype bf16: ER + ASER, SCR, stacked ER, two loads, the
    # ResNet family, a trace
    t0 = time.time()
    bf16 = run_bf16_phase(torch, distance, card, {
        "main_ips": throughput(tee.buf.getvalue()), "main_step": per_step,
        "stacked_ips": stacked["runs"]["stacked"]["images_per_s"],
        "mini": data["mini_imagenet"], "mini_bf16": data["mini_imagenet_bf16"]}, device)
    family["bf16"] = {"phase_s": time.time() - t0}
    print("[bf16] phase 23: {:.1f} s ({})".format(family["bf16"]["phase_s"], card))

    # 24. --n_devices: the eval fan-out through the CLI, the DP step over a
    # slot-sharded buffer, the dry run's patterns, dealt stacked runs, NCCL
    t0 = time.time()
    dp_figs = run_dp_phase(torch, card, device)
    family["dp"] = {"phase_s": time.time() - t0}
    print("[dp] phase 24: {:.1f} s ({})".format(family["dp"]["phase_s"], card))
    print("[family] seconds a phase ({}): {}".format(card, ", ".join(
        "{} {:.1f}".format(tag, f["phase_s"]) for tag, f in family.items() if "phase_s" in f)))

    main_shape = shapes[0]  # 30 x 30 x 160, the update's shape on the main path
    print(json.dumps({"kernels": [{
        "name": KERNEL, "route": "cuda",
        "source": "ocl_tpu_torch/csrc/pairwise_sqdist.cu",
        "replaces": "ocl_tpu/ops/pallas/distance.py:26",
        "launches": launches, "max_abs_err": max_abs,
        "shape": main_shape["shape"],
        "ms": main_shape["device_ms"], "device_ms": main_shape["device_ms"],
        "enqueue_ms": main_shape["enqueue_ms"], "host_us": main_shape["host_us"],
        "plain_ms": main_shape["plain"]["device_ms"], "floor_ms": floor["device_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library": "torch.cdist, use_mm_for_euclid_dist (the nearest call: it returns the root)",
        "library_ms": main_shape["library"]["device_ms"],
        "profiler_ms": profiler_ms, "per_sv_step": per_step, "shapes": shapes,
        "resume_launches": {"uninterrupted": family["resume"]["launches"],
                            "after_restore": family["resume"]["launches_after_restore"]},
        "batched": {"points": list(BATCHED_POINTS), "max_abs_err": stacked["aser"]["max_abs_err"],
                    "stacked_aser_launches": stacked["aser"]["launches"],
                    "launches_a_stacked_sv_step": stacked["aser"]["per_sv_step"]["k1_launches"],
                    "runs": STACKED_RUNS, "shapes": stacked["aser"]["kernel_rows"]},
        "data_runs": {tag: {"launches": data[tag]["launches"],
                            "shapes": [[list(k), c] for k, c in data[tag]["shapes"]]}
                      for tag in ("cifar100", "mini_imagenet")},
        "bf16_runs": {"er_aser": {"launches": bf16["er_aser"]["launches"],
                                  "launches_a_sv_step": bf16["er_aser"]["k1_launches"],
                                  "shapes": [[list(k), c] for k, c in bf16["er_aser"]["shapes"]]},
                      "mini_imagenet": {"launches": data["mini_imagenet_bf16"]["launches"],
                                        "shapes": [[list(k), c] for k, c in
                                                   data["mini_imagenet_bf16"]["shapes"]]},
                      "inputs": "float32"},
        "dp_runs": {"ranks_sharing_one_card": DP_RANKS, "backend": "gloo",
                    "launches_per_rank": [r["launches"] for r in dp_figs["step"]["ranks"]],
                    "steps": DP_STEPS,
                    "launches_a_step_per_rank": [r["profile"]["k1_launches"]
                                                 for r in dp_figs["step"]["ranks"]],
                    "device_ms_a_step_per_rank": [r["profile"]["device_ms"]
                                                  for r in dp_figs["step"]["ranks"]],
                    "max_abs_err": max(a for r in dp_figs["step"]["ranks"]
                                       for _, a, _ in r["kernel_checks"]),
                    "shapes": [list(s) for s, _, _ in
                               dp_figs["step"]["ranks"][0]["kernel_checks"]],
                    "family": {tag: {"steps": DP_FAMILY_STEPS,
                                     "launches_per_rank": [r["launches"] for r in f["ranks"]],
                                     "shapes": [list(c[0]) for c in f["ranks"][0]["kernel_checks"]],
                                     "max_abs_err": max((c[1] for r in f["ranks"]
                                                         for c in r["kernel_checks"]),
                                                        default=None)}
                               for tag, f in dp_figs["family"].items()
                               if f["ranks"][0]["kernel_checks"]}}}]}))
    print("[total] chip_smoke.py {:.1f} s ({})".format(time.time() - script_t0, card))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
