"""The port stands alone: every module of ocl_tpu_torch imports in a fresh
interpreter where `jax` cannot be imported, and afterwards no module of
ocl_tpu and none of jax is loaded."""

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
                 "ops.augment", "utils.meters", "agents.cndpm", "models.ndpm", "models.ndpm_vars"):
        assert "ocl_tpu_torch." + name in names, name
    proc = subprocess.run([sys.executable, "-c", CHECK], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == [str(len(names)), "[]"], proc.stdout
