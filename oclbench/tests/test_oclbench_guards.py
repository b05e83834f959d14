"""What the harness refuses: a machine without a card, a tree without the
port, and JAX or the JAX package in the process (whole top-level names)."""

import json
import shutil
import subprocess
import sys

import pytest

from oclbench_cells import ROOT

RUN = [sys.executable, "oclbench/run.py", "--workload", "mini84.aser", "--seed", "5",
       "--seconds", "1", "--trace", "0"]


def test_importing_the_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, {!r}); import oclbench.run, oclbench.harness, "
            "oclbench.calibrate, oclbench.loops.online, oclbench.loops.stacked_tune; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}} & "
            "{{'jax', 'jaxlib', 'flax', 'optax', 'ocl_tpu'}}))").format(str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_the_forbidden_names_compare_whole(monkeypatch):
    sys.path.insert(0, str(ROOT))
    from oclbench import run

    monkeypatch.setitem(sys.modules, "ocl_tpu_torch_like", sys)
    assert "ocl_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ocl_tpu.agents", sys)
    assert run.forbidden_modules() == ["ocl_tpu"]


def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")


def test_no_card_no_result():
    no_card()
    out = subprocess.run(RUN, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_a_tree_without_the_port_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "oclbench", tmp_path / "oclbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(RUN, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
