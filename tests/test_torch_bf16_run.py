"""--compute_dtype bf16 at run level: the port's ER in bf16 on the parity
streams is within the ER pin's band of the ER goldens, as
PARITY_RESULTS.md's ER_BF16 row (ocl_tpu in bf16) is; and the flag reaches
the models through general_main, --parallel_runs and main_config (every
convolution of the run computes in bf16). The op and step levels are in
tests/test_torch_bf16.py."""

import types

import numpy as np
import pytest
import torch

from ocl_tpu_torch import general_main, main_config
from ocl_tpu_torch.config import build_parser
from test_torch_run import G, pv, run_port_side, torch_threads

CLI = ["--device", "cpu", "--nf", "4", "--data", "synthetic", "--compute_dtype", "bf16",
       "--num_tasks", "2", "--synthetic_size", "20", "--mem_size", "20", "--verbose", "False"]


def conv_dtypes_of(run):
    """The dtypes of every Conv2d output while `run()` runs."""
    seen = set()

    def hook(module, inputs, out):
        if isinstance(module, torch.nn.Conv2d):
            seen.add(out.dtype)

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        run()
    finally:
        handle.remove()
    return seen


@pytest.mark.parametrize("flags", [["--num_runs", "1"],
                                   ["--num_runs", "2", "--parallel_runs", "True"],
                                   ["--agent", "SCR", "--num_runs", "1"]])
def test_general_main_runs_in_bf16(flags):
    args = build_parser().parse_args(CLI + flags)
    assert conv_dtypes_of(lambda: general_main.main(args)) == {torch.bfloat16}


def test_main_config_runs_in_bf16(tmp_path):
    general = tmp_path / "general.yml"
    general.write_text("parameters:\n  num_runs: 1\n  seed: 0\n  batch: 10\n"
                       "  test_batch: 128\n  compute_dtype: bf16\n")
    data = tmp_path / "data.yml"
    data.write_text("parameters:\n  data: synthetic\n  cl_type: nc\n  num_tasks: 2\n"
                    "  synthetic_size: 20\n")
    args = types.SimpleNamespace(general=str(general), data=str(data),
                                 agent="config/agent/er/er_1k.yml", verbose=False, nf=4,
                                 device="cpu")
    assert conv_dtypes_of(lambda: main_config.main(args)) == {torch.bfloat16}


def test_bf16_er_within_the_er_goldens_band():
    """Seeds 1-2 of the parity streams on one thread, as the ER pin of
    test_torch_run.py, with --compute_dtype bf16: |dAvg_End_Acc| < 0.08."""
    ref_rows, port_rows = [], []
    with torch_threads(1):
        for seed in (1, 2):
            ref_rows.append(np.load(G.golden_path("ER", seed)))
            tasks, tests = pv.make_stream(seed, G.CI_STREAM["per_class"],
                                          G.CI_STREAM["difficulty"], G.CI_STREAM["num_tasks"])
            port_rows.append(run_port_side(dict(G.GOLDEN_CONFIGS["ER"], compute_dtype="bf16"),
                                           tasks, tests, seed))
    ref_acc, port_acc = pv.summarize(ref_rows)[0], pv.summarize(port_rows)[0]
    print("ER goldens {:.4f}, port in bf16 {:.4f}".format(ref_acc, port_acc))
    assert abs(ref_acc - port_acc) < 0.08, (ref_acc, port_acc)
