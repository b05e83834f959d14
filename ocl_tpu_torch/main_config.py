"""YAML-driven run of the port (counterpart of main_config.py).

    python -m ocl_tpu_torch.main_config --general config/general_1.yml \\
        --data config/data/synthetic/synthetic_nc.yml \\
        --agent config/agent/er/er_1k.yml [--device cpu --nf 4]

The three files' `parameters` sections merge in that order, later ones
winning; --verbose, --nf and --device override them.
"""

from __future__ import annotations

import argparse
import random

import numpy as np

from ocl_tpu_torch.config import boolean_string, load_yaml, merge_yaml_params
from ocl_tpu_torch.experiment.run import multiple_run


def main(args):
    """Run the experiment the config files describe; returns multiple_run's
    metrics."""
    general_params = load_yaml(args.general)
    data_params = load_yaml(args.data)
    agent_params = load_yaml(args.agent)
    general_params["verbose"] = args.verbose
    extra = {"device": args.device}
    if args.nf is not None:
        extra["nf"] = args.nf
    final_params = merge_yaml_params(general_params, data_params, agent_params, **extra)
    print(final_params)

    np.random.seed(final_params.seed)
    random.seed(final_params.seed)
    return multiple_run(final_params)


def build_parser():
    parser = argparse.ArgumentParser("Config-driven Continual Learning (PyTorch / CUDA port)")
    parser.add_argument("--general", dest="general", default="config/general.yml")
    parser.add_argument("--data", dest="data", default="config/data/cifar100/cifar100_nc.yml")
    parser.add_argument("--agent", dest="agent", default="config/agent/er.yml")
    parser.add_argument("--verbose", type=boolean_string, default=True)
    parser.add_argument("--nf", dest="nf", default=None, type=int,
                        help="override the model's base width (for small CPU runs)")
    parser.add_argument("--device", dest="device", default="cuda",
                        help="torch device the port runs on (cuda, cuda:N or cpu)")
    return parser


if __name__ == "__main__":
    main(build_parser().parse_args())
