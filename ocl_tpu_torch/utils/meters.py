"""Small host-side helpers (counterpart of ocl_tpu/utils/meters.py;
reference utils/utils.py:25-134)."""

from __future__ import annotations


class AverageMeter:
    """Running mean of values added with their counts."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val, n):
        self.sum += val * n
        self.count += n

    def avg(self):
        if self.count == 0:
            return 0
        return float(self.sum) / self.count
