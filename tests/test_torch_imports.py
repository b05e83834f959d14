"""The port stands alone: every module of ocl_tpu_torch imports in a fresh
interpreter where `jax` cannot be imported, and afterwards no module of
ocl_tpu and none of jax is loaded. The machine with the card has no pyyaml,
pandas, sklearn, psutil or orbax either: with those blocked, every module
still imports, and the YAML reader, the CSV writer and the RAM probe run."""

import os
import pkgutil
import subprocess
import sys

import ocl_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import ocl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ocl_tpu_torch.__path__, "ocl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if (m == "ocl_tpu" or m.startswith(("ocl_tpu.", "jax.", "jaxlib", "flax", "optax")))
             and sys.modules[m] is not None)
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_ocl_tpu():
    names = [m.name for m in pkgutil.walk_packages(ocl_tpu_torch.__path__, "ocl_tpu_torch.")]
    for name in ("buffer.gss", "agents.lwf", "agents.icarl", "agents.gdumb", "agents.scr",
                 "ops.augment", "utils.meters", "agents.cndpm", "models.ndpm", "models.ndpm_vars",
                 "utils.io", "utils.profiling", "utils.checkpoint", "experiment.tune",
                 "main_config", "main_tune", "data.non_stationary", "data.datasets",
                 "data.native_io", "data.openloris_objects", "utils.plot", "tools.spread",
                 "parallel.mesh", "parallel.dp", "parallel.sharded_buffer", "tools.dryrun"):
        assert "ocl_tpu_torch." + name in names, name
    proc = subprocess.run([sys.executable, "-c", CHECK], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == [str(len(names)), "[]"], proc.stdout


CHECK_NO_LIBRARIES = """
import importlib, os, pkgutil, sys, tempfile
BLOCKED = ("yaml", "pandas", "sklearn", "psutil", "orbax")
for name in BLOCKED:
    sys.modules[name] = None       # any import of them now raises ImportError
import ocl_tpu_torch
for m in pkgutil.walk_packages(ocl_tpu_torch.__path__, "ocl_tpu_torch."):
    importlib.import_module(m.name)
from ocl_tpu_torch.config import load_yaml
from ocl_tpu_torch.utils.io import check_ram_usage, save_csv
assert load_yaml("config/agent/er/er_tune.yml")["learning_rate"][0] == 0.0001
with tempfile.TemporaryDirectory() as d:
    save_csv([{"Run": 0, "Avg_End_Acc": 0.5}], d, "t.csv")
    assert open(os.path.join(d, "t.csv")).read() == "Run,Avg_End_Acc\\n0,0.5\\n"
assert check_ram_usage() > 0
print(sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED and sys.modules[m] is not None))
"""


def test_port_runs_without_yaml_pandas_sklearn_psutil():
    proc = subprocess.run([sys.executable, "-c", CHECK_NO_LIBRARIES], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["[]"], proc.stdout
