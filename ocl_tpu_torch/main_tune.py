"""YAML-driven tuning of the port (counterpart of main_tune.py).

    python -m ocl_tpu_torch.main_tune --general config/general_1.yml \\
        --data config/data/synthetic/synthetic_nc.yml \\
        --default config/agent/er/er_1k.yml --tune config/agent/er/er_tune.yml \\
        [--trick labels_trick] [--train_val True] [--parallel_runs True] \
        [--device cpu]

Tunes every run on its first num_val tasks over the grid of the --tune
file, and pickles the result under config/global.yml's result path
(experiment/tune.py::multiple_run_tune_separate). With --parallel_runs
True (or `parallel_runs: true` in the general file) a learning-rate /
weight-decay grid trains all its points stacked
(experiment/parallel_tune.py).
"""

from __future__ import annotations

import argparse
import random

import numpy as np

from ocl_tpu_torch.config import DEFAULT_TRICK, boolean_string, load_yaml, merge_yaml_params
from ocl_tpu_torch.experiment.tune import multiple_run_tune_separate


def main(args):
    """Tune as the config files describe; returns the pickled result."""
    general_params = load_yaml(args.general)
    data_params = load_yaml(args.data)
    default_params = load_yaml(args.default)
    tune_params = load_yaml(args.tune)
    general_params["verbose"] = args.verbose
    general_params["train_val"] = args.train_val
    trick = dict(DEFAULT_TRICK)
    if args.trick:
        trick[args.trick] = True
    general_params["trick"] = trick
    if args.parallel_runs is not None:
        general_params["parallel_runs"] = args.parallel_runs
    extra = {"device": args.device}
    if args.nf is not None:
        extra["nf"] = args.nf
    final_default_params = merge_yaml_params(general_params, data_params, default_params,
                                             **extra)
    print(final_default_params)

    np.random.seed(final_default_params.seed)
    random.seed(final_default_params.seed)
    return multiple_run_tune_separate(final_default_params, tune_params, args.save_path)


def build_parser():
    parser = argparse.ArgumentParser("Continual Learning tuning (PyTorch / CUDA port)")
    parser.add_argument("--general", dest="general", default="config/general_1.yml")
    parser.add_argument("--data", dest="data", default="config/data/cifar100/cifar100_nc.yml")
    parser.add_argument("--default", dest="default", default="config/agent/er/er_1k.yml")
    parser.add_argument("--tune", dest="tune", default="config/agent/er/er_tune.yml")
    parser.add_argument("--save-path", dest="save_path", default=None)
    parser.add_argument("--verbose", type=boolean_string, default=False)
    parser.add_argument("--train_val", type=boolean_string, default=False)
    parser.add_argument("--trick", type=str, default=None)
    parser.add_argument("--parallel_runs", type=boolean_string, default=None,
                        help="train the grid's points stacked (default: the general file's)")
    parser.add_argument("--nf", dest="nf", default=None, type=int,
                        help="override the model's base width (for small CPU runs)")
    parser.add_argument("--device", dest="device", default="cuda",
                        help="torch device the port runs on (cuda, cuda:N or cpu)")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
