"""Flag-based CLI of the port (counterpart of general_main.py).

    python -m ocl_tpu_torch.general_main --device cuda --data synthetic \\
        --agent ER --update ASER --retrieve ASER --mem_size 1000 ...
"""

from __future__ import annotations

import random

import numpy as np

from ocl_tpu_torch.config import build_parser, finalize
from ocl_tpu_torch.experiment.run import multiple_run


def main(args):
    """Run the experiment `args` asks for; returns multiple_run's metrics."""
    print(args)
    np.random.seed(args.seed)
    random.seed(args.seed)
    args = finalize(args)
    if getattr(args, "parallel_runs", False):
        from ocl_tpu_torch.experiment.parallel_run import multiple_run_parallel

        return multiple_run_parallel(args, store=args.store, save_path=args.save_path)
    return multiple_run(args, store=args.store, save_path=args.save_path)


if __name__ == "__main__":
    main(build_parser().parse_args())
