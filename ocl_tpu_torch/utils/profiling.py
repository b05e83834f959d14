"""Stream-throughput timing (counterpart of ocl_tpu/utils/profiling.py).

`Throughput` accumulates images and seconds over a run's `train_learner`
calls. ocl_tpu forces the pipeline to finish with a host fetch; here
`measure` synchronises the CUDA device it is given, so the seconds hold the
device's work and not only its enqueueing. ocl_tpu's `trace` is not ported
yet.
"""

from __future__ import annotations

import contextlib
import time

import torch


class Throughput:
    """Accumulates (images, seconds) across tasks; reports images/sec."""

    def __init__(self):
        self.images = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def measure(self, n_images: int, device=None):
        t0 = time.time()
        yield
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        self.seconds += time.time() - t0
        self.images += n_images

    def images_per_sec(self) -> float:
        return self.images / self.seconds if self.seconds else 0.0
