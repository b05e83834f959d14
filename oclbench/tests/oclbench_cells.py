"""Small cells for the CPU tests: the benchmark's two configurations cut to
32 px, nf 8, 10 classes in tasks of 2 and a 40-slot buffer, so a run takes
seconds on the CPU. Not a test file."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from oclbench import spec  # noqa: E402

# set from the small cells' CPU readings (12 seeds of the grid cell, 4 of the ASER cell,
# whose port and reference agree bit for bit on the CPU): sound runs read loss <= 2.1e-3,
# grad1 and change1 <= 4.2e-3 (the grid's first step with memory rows: on 8 seeds of 10 a
# lane's trunk gradient moves by 1e-3 in float64 when its weights move by 1e-7; under 4e-6
# on the other two), change3_median <= 2.6e-3, picks and exact 0; every planted fault reads 0.045 or
# more on loss, 0.78 or more on grad1 or change1, or exact > 0
LIMITS = {"loss": 1e-2, "grad1": 3e-2, "change1": 3e-2, "change3_median": 1e-2, "picks": 1e-3,
          "exact": 0}
E2E = [{"name": "images_per_s", "unit": "images/s"}, {"name": "step_ms_p95", "unit": "ms"},
       {"name": "setup_s", "unit": "s"}]
PER_LAYER = [{"name": n, "unit": "x", "moves": "images_per_s"}
             for n in ("step.launches", "step.host_ms", "aser.device_ms", "k1_roofline",
                       "step.mfu", "device.idle_pct")]


def _small(config, **recipe):
    cfg = dict(json.loads((ROOT / "oclbench" / "configs" / config).read_text()),
               nf=20, image_size=32, classes=10, tasks=5, classes_per_task=2, train_per_class=60)
    cfg["recipe"] = dict(cfg["recipe"], data="cifar10", nf=20, mem_size=40, num_tasks=5, **recipe)
    return cfg


def traffic(name, **over):
    t = json.loads((ROOT / "oclbench" / "traffic" / (name + ".json")).read_text())
    return dict(t, max_steps_per_s=20, **over)


def aser_cell():
    return spec.Cell.of("small.aser", _small("rrn18_mini84.json", n_smp_cls=2.0),
                        traffic("aser_online", trace_steps=3), LIMITS, E2E, PER_LAYER)


def grid_cell():
    cfg = _small("rrn18_cifar100.json")
    cfg["grid"] = {"learning_rate": [0.001, 0.01], "weight_decay": [0.0001, 0.1]}
    limits = {k: v for k, v in LIMITS.items() if k != "picks"}
    return spec.Cell.of("small.grid", cfg, traffic("er_grid84", trace_steps=2), limits, E2E,
                        PER_LAYER)


CELLS = {"aser": aser_cell, "grid": grid_cell}
FULL = {"aser": "mini84.aser", "grid": "cifar100.er_grid84"}   # the cell each stands for
