"""Configuration: the ocl_tpu flag surface plus ``--device``.

Counterpart of ``ocl_tpu/config.py``: the same flags and defaults, one
SimpleNamespace ("params") threaded through the port. Flags whose subsystem is
not ported yet are accepted for surface parity; the component that would use
them raises when they ask for anything but the ported behaviour.
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace

import torch

from ocl_tpu_torch.utils.io import load_yaml  # noqa: F401  (ocl_tpu.config's name)

DEFAULT_TRICK = {
    "labels_trick": False,
    "kd_trick": False,
    "separated_softmax": False,
    "review_trick": False,
    "ncm_trick": False,
    "kd_trick_star": False,
}

# Per-dataset input shapes, NHWC as in the JAX package.
input_size_match = {
    "cifar100": [32, 32, 3],
    "cifar10": [32, 32, 3],
    "core50": [128, 128, 3],
    "mini_imagenet": [84, 84, 3],
    "openloris": [50, 50, 3],
    "synthetic": [32, 32, 3],
}

n_classes_match = {
    "cifar100": 100,
    "cifar10": 10,
    "core50": 50,
    "mini_imagenet": 100,
    "openloris": 69,
    "synthetic": 10,
}


def boolean_string(s):
    if isinstance(s, bool):
        return s
    if s not in {"False", "True"}:
        raise ValueError("Not a valid boolean string")
    return s == "True"


def build_parser() -> argparse.ArgumentParser:
    """The ocl_tpu flags and defaults, plus --device."""
    parser = argparse.ArgumentParser(
        description="Online Continual Learning (PyTorch / CUDA port)")
    # General
    parser.add_argument("--num_runs", dest="num_runs", default=1, type=int)
    parser.add_argument("--seed", dest="seed", default=0, type=int)
    # Misc
    parser.add_argument("--val_size", dest="val_size", default=0.1, type=float)
    parser.add_argument("--num_val", dest="num_val", default=3, type=int)
    parser.add_argument("--num_runs_val", dest="num_runs_val", default=3, type=int)
    parser.add_argument("--error_analysis", dest="error_analysis", default=False, type=boolean_string)
    parser.add_argument("--verbose", type=boolean_string, default=True)
    parser.add_argument("--store", type=boolean_string, default=False)
    parser.add_argument("--save-path", dest="save_path", default=None)
    # Agent
    parser.add_argument("--agent", dest="agent", default="ER",
                        choices=["ER", "EWC", "AGEM", "CNDPM", "LWF", "ICARL", "GDUMB", "ASER", "SCR"])
    parser.add_argument("--update", dest="update", default="random", choices=["random", "GSS", "ASER"])
    parser.add_argument("--retrieve", dest="retrieve", default="random",
                        choices=["MIR", "random", "ASER", "match", "mem_match"])
    # Optimizer
    parser.add_argument("--optimizer", dest="optimizer", default="SGD", choices=["SGD", "Adam"])
    parser.add_argument("--learning_rate", dest="learning_rate", default=0.1, type=float)
    parser.add_argument("--epoch", dest="epoch", default=1, type=int)
    parser.add_argument("--batch", dest="batch", default=10, type=int)
    parser.add_argument("--test_batch", dest="test_batch", default=128, type=int)
    parser.add_argument("--weight_decay", dest="weight_decay", type=float, default=0)
    # Data
    parser.add_argument("--num_tasks", dest="num_tasks", default=10, type=int)
    parser.add_argument("--fix_order", dest="fix_order", default=False, type=boolean_string)
    parser.add_argument("--plot_sample", dest="plot_sample", default=False, type=boolean_string)
    parser.add_argument("--data", dest="data", default="cifar10")
    parser.add_argument("--cl_type", dest="cl_type", default="nc", choices=["nc", "ni"])
    parser.add_argument("--ns_factor", dest="ns_factor", nargs="+",
                        default=(0.0, 0.4, 0.8, 1.2, 1.6, 2.0, 2.4, 2.8, 3.2, 3.6), type=float)
    parser.add_argument("--ns_type", dest="ns_type", default="noise", type=str,
                        choices=["noise", "occlusion", "blur"])
    parser.add_argument("--ns_task", dest="ns_task", nargs="+", default=(1, 1, 2, 2, 2, 2), type=int)
    parser.add_argument("--online", dest="online", default=True, type=boolean_string)
    # ER
    parser.add_argument("--mem_size", dest="mem_size", default=10000, type=int)
    parser.add_argument("--eps_mem_batch", dest="eps_mem_batch", default=10, type=int)
    # EWC
    parser.add_argument("--lambda", dest="lambda_", default=100, type=float)
    parser.add_argument("--alpha", dest="alpha", default=0.9, type=float)
    parser.add_argument("--fisher_update_after", dest="fisher_update_after", type=int, default=50)
    # MIR
    parser.add_argument("--subsample", dest="subsample", default=50, type=int)
    # GSS
    parser.add_argument("--gss_mem_strength", dest="gss_mem_strength", default=10, type=int)
    parser.add_argument("--gss_batch_size", dest="gss_batch_size", default=10, type=int)
    # ASER
    parser.add_argument("--k", dest="k", default=5, type=int)
    parser.add_argument("--aser_type", dest="aser_type", default="asvm", type=str,
                        choices=["neg_sv", "asv", "asvm"])
    parser.add_argument("--n_smp_cls", dest="n_smp_cls", default=2.0, type=float)
    # CNDPM
    parser.add_argument("--stm_capacity", dest="stm_capacity", default=1000, type=int)
    parser.add_argument("--classifier_chill", dest="classifier_chill", default=0.01, type=float)
    parser.add_argument("--log_alpha", dest="log_alpha", default=-300, type=float)
    # GDumb
    parser.add_argument("--minlr", dest="minlr", default=0.0005, type=float)
    parser.add_argument("--clip", dest="clip", default=10.0, type=float)
    parser.add_argument("--mem_epoch", dest="mem_epoch", default=70, type=int)
    # Tricks
    parser.add_argument("--labels_trick", dest="labels_trick", default=False, type=boolean_string)
    parser.add_argument("--separated_softmax", dest="separated_softmax", default=False, type=boolean_string)
    parser.add_argument("--kd_trick", dest="kd_trick", default=False, type=boolean_string)
    parser.add_argument("--kd_trick_star", dest="kd_trick_star", default=False, type=boolean_string)
    parser.add_argument("--review_trick", dest="review_trick", default=False, type=boolean_string)
    parser.add_argument("--ncm_trick", dest="ncm_trick", default=False, type=boolean_string)
    parser.add_argument("--mem_iters", dest="mem_iters", default=1, type=int)
    # Early stopping
    parser.add_argument("--min_delta", dest="min_delta", default=0.0, type=float)
    parser.add_argument("--patience", dest="patience", default=0, type=int)
    parser.add_argument("--cumulative_delta", dest="cumulative_delta", default=False, type=boolean_string)
    # SupContrast
    parser.add_argument("--temp", type=float, default=0.07)
    parser.add_argument("--buffer_tracker", type=boolean_string, default=False,
                        help="print + consistency-check the buffer's per-class "
                             "counts after every task")
    parser.add_argument("--warmup", type=int, default=4)
    parser.add_argument("--head", type=str, default="mlp")
    # extensions of ocl_tpu (not in the original reference)
    parser.add_argument("--n_devices", dest="n_devices", default=0, type=int,
                        help="above 1: ranks of torch.distributed to start "
                             "(rank r on cuda:(r %% cards), or on the CPU under "
                             "--device cpu; NCCL when each rank has a card, else "
                             "gloo): rank 0 trains and evaluation fans out over "
                             "the ranks, as ocl_tpu shards its eval over devices; "
                             "with --parallel_runs the runs or tune points are "
                             "dealt to the ranks. 0 or 1: one process")
    parser.add_argument("--synthetic_size", dest="synthetic_size", default=2000, type=int,
                        help="train images per class for the synthetic dataset")
    parser.add_argument("--synthetic_difficulty", dest="synthetic_difficulty",
                        default=0.0, type=float,
                        help="0..1: shrinks class separation / raises noise")
    parser.add_argument("--nf", dest="nf", default=20, type=int,
                        help="backbone width (reference fixes nf=20; smaller for CPU tests)")
    parser.add_argument("--max_experts", dest="max_experts", default=10, type=int,
                        help="CN-DPM expert-slot capacity")
    parser.add_argument("--parallel_runs", dest="parallel_runs", default=False,
                        type=boolean_string,
                        help="train all runs stacked, one launch sequence for every run")
    parser.add_argument("--ckpt_dir", dest="ckpt_dir", default=None,
                        help="checkpoint directory: save after every task, resume "
                             "after the last saved one")
    parser.add_argument("--fused_replay", dest="fused_replay", default=True,
                        type=boolean_string,
                        help="ER with random/match retrieval: one fused "
                             "forward/backward over batch+memory (the ocl_tpu "
                             "default); False runs the reference's two-pass "
                             "schedule")
    parser.add_argument("--scr_review_dead_forward",
                        dest="scr_review_dead_forward", default=True,
                        type=boolean_string,
                        help="SCR + review_trick: each review batch first "
                             "runs a train-mode forward whose output is "
                             "dropped, folding its BN statistics once more "
                             "(the reference's order)")
    parser.add_argument("--scan_unroll", dest="scan_unroll", default=None, type=int,
                        help="unroll factor of ocl_tpu's per-task scan; the "
                             "port runs each step from Python and has no scan")
    parser.add_argument("--compute_dtype", dest="compute_dtype", default="fp32",
                        choices=["fp32", "bf16"],
                        help="forward/backward compute precision: bf16 runs "
                             "the model's forward under torch.autocast to "
                             "bfloat16 (convolutions and matmuls in bf16; BN "
                             "statistics, losses, parameters, gradients and "
                             "optimizer state stay fp32; CN-DPM stays fp32). "
                             "fp32 is the parity arithmetic.")
    parser.add_argument("--core50_cache", dest="core50_cache", default=True,
                        type=boolean_string,
                        help="CORe50: read and write decoded images in "
                             "datasets/core50/bin_cache/ (ocl_tpu's file "
                             "format)")
    parser.add_argument("--debug_nans", dest="debug_nans", default=False,
                        type=boolean_string,
                        help="raise FloatingPointError on any non-finite "
                             "task loss")
    parser.add_argument("--matmul_precision", dest="matmul_precision",
                        default="default",
                        choices=["default", "high", "highest"],
                        help="f32 convs/matmuls: 'highest' clears both TF32 "
                             "switches (torch.backends.cuda.matmul and "
                             "torch.backends.cudnn) for IEEE fp32 arithmetic, "
                             "'high' sets both, 'default' leaves torch's own "
                             "defaults (TF32 convs, fp32 matmuls). Under "
                             "--compute_dtype bf16 the model's convs and "
                             "matmuls run in bf16 and ignore it.")
    parser.add_argument("--device", dest="device", default="cuda",
                        help="torch device the port runs on (cuda, cuda:N or cpu)")
    return parser


def apply_runtime_flags(params) -> None:
    """Apply process-global torch flags derived from params
    (--matmul_precision). --debug_nans is a finite-loss check after every
    task (agents/base.py:ContinualLearner.train_task)."""
    prec = getattr(params, "matmul_precision", "default")
    if prec in ("high", "highest"):
        tf32 = prec == "high"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32


def finalize(params: SimpleNamespace) -> SimpleNamespace:
    """Fill derived fields (the trick dict, ``cuda``, missing defaults)."""
    if not hasattr(params, "trick") or params.trick is None:
        params.trick = {k: bool(getattr(params, k, False)) for k in DEFAULT_TRICK}
    for key, default in DEFAULT_TRICK.items():
        params.trick.setdefault(key, default)
    for key, val in default_params_ns().__dict__.items():
        if not hasattr(params, key):
            setattr(params, key, val)
    params.cuda = torch.device(params.device).type == "cuda"
    return params


def default_params_ns() -> SimpleNamespace:
    return SimpleNamespace(**{a.dest: a.default for a in build_parser()._actions
                              if a.dest != "help"})


def default_params(**overrides) -> SimpleNamespace:
    """A fully-populated params namespace; handy for tests and library use."""
    ns = default_params_ns()
    for key, val in overrides.items():
        setattr(ns, key, val)
    ns.trick = None
    return finalize(ns)


def merge_yaml_params(*yaml_dicts, **extra) -> SimpleNamespace:
    """Dict-union merge of layered YAML sections, later ones winning, then
    `extra` (counterpart of ocl_tpu/config.py:297-304; reference
    main_tune.py:13-23). Flags no section names take their defaults,
    `--device` among them: cuda."""
    merged = {}
    for d in yaml_dicts:
        if d:
            merged.update(d)
    merged.update(extra)
    return finalize(SimpleNamespace(**merged))
