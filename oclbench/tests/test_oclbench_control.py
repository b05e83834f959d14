"""The control on the card: the reference itself, computed in TF32 (the
nearest precision below the configurations' IEEE fp32), put in the port's
place, has to come out not correct, while the port's own checked steps come
out correct, both held to the limits of the full cell that each small cell
stands for. TF32 exists on the card alone, so the test is marked `card` and
skips without one; `oclbench/calibrate.py` reads the same control at the
cells' own sizes."""

import pytest

from oclbench_cells import CELLS, FULL, ROOT
from oclbench import spec


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the TF32 control needs a CUDA device")
    from oclbench import calibrate

    c = CELLS[cell]()
    c.limits = spec.read_json(ROOT / "oclbench" / "limits" / (FULL[cell] + ".json"))
    for seed in (1, 2, 3):
        sound, _ = calibrate.reading(c, seed, "cuda:0")
        assert all(sound[k] <= limit for k, limit in c.limits.items()), sound
        control, _ = calibrate.reading(c, seed, "cuda:0", control=True)
        assert any(control[k] > limit for k, limit in c.limits.items()), control
