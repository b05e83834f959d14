"""tools/kernel_timing.py's trace readers on a stand-in for a finished
torch.profiler trace (the card's traces come from chip_smoke.py): they take
the device events alone, skip hidden ones, and busy_ms is the union of the
kernels' intervals."""

from types import SimpleNamespace

import pytest
import torch

from ocl_tpu_torch.tools.kernel_timing import busy_ms, device_events, kernel_times

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, start_ns, end_ns, device=CUDA, hidden=False):
        self._v = name, start_ns, end_ns, device, hidden

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_hidden_event(self):
        return self._v[4]


def trace(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_device_events_are_the_cuda_ones():
    prof = trace([Event("aten::conv2d", 0, 9000, CPU), Event("gemm", 1000, 3000),
                  Event("hidden", 1000, 2000, hidden=True), Event("Memset", 4000, 4500)])
    assert device_events(prof) == [("gemm", 1000, 3000), ("Memset", 4000, 4500)]
    assert kernel_times(prof) == [("gemm", 2.0), ("Memset", 0.5)]


@pytest.mark.parametrize("spans, want_ms", [
    ([], 0.0),
    ([(0, 2000)], 0.002),
    ([(0, 2000), (1000, 3000)], 0.003),           # overlapping streams
    ([(5000, 6000), (0, 4000), (1000, 2000)], 0.005),   # out of order, nested
    ([(0, 1000), (1000, 2000)], 0.002),           # end to end
])
def test_busy_ms_is_the_union_of_kernel_intervals(spans, want_ms):
    prof = trace([Event("k", s, e) for s, e in spans] + [Event("host", 0, 10 ** 6, CPU)])
    assert busy_ms(prof) == pytest.approx(want_ms)


@pytest.mark.card
def test_readers_match_prof_events_on_the_card():
    """On the card: the readers give the device events, names, device time
    and busy time that `prof.events()` lists for a real trace (a conv step
    and a matmul on a side stream, so that kernels overlap)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    model = torch.nn.Sequential(torch.nn.Conv2d(3, 20, 3), torch.nn.ReLU(),
                                torch.nn.Conv2d(20, 20, 3)).cuda()
    x = torch.randn(10, 3, 32, 32, device="cuda")
    side = torch.cuda.Stream()
    model(x).sum().backward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            model(x).sum().backward()
            with torch.cuda.stream(side):
                (x @ x.transpose(-1, -2)).sum()
        torch.cuda.synchronize()
    want = [e for e in prof.events() if e.device_type == CUDA]
    got = kernel_times(prof)
    assert sorted(name for name, _ in got) == sorted(e.name for e in want)
    assert sum(us for _, us in got) == pytest.approx(
        sum(e.time_range.elapsed_us() for e in want), rel=1e-6)
    union = trace([Event(e.name, round(e.time_range.start * 1e3), round(e.time_range.end * 1e3))
                   for e in want])
    assert busy_ms(prof) == pytest.approx(busy_ms(union), rel=1e-6)
