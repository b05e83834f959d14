"""Stream-throughput timing and traces (counterpart of
ocl_tpu/utils/profiling.py).

`Throughput` accumulates images and seconds over a run's `train_learner`
calls. ocl_tpu forces the pipeline to finish with a host fetch; here
`measure` synchronises the CUDA device it is given, so the seconds hold the
device's work and not only its enqueueing. `trace` is ocl_tpu's
`jax.profiler` trace as a `torch.profiler` one.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

TRACE_FILE = "trace.json"


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


@contextlib.contextmanager
def trace(log_dir: str):
    """`torch.profiler` over the block, with CPU activities and, where CUDA
    is available, CUDA ones; on leaving the block, the Chrome trace (for
    Perfetto or chrome://tracing) goes to `log_dir`/trace.json, `log_dir`
    made if missing. Yields the profile: after the block,
    `ocl_tpu_torch.tools.kernel_timing`'s `device_events`, `kernel_times`
    and `busy_ms` read its device events, and `trace_events` the file."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
