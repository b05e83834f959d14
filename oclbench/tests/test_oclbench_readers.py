"""The per-layer readers and the breakdown on a recorded synthetic profile:
two steps of 10 ms, kernels launched inside the benchmark's ranges."""

import pytest

from oclbench_cells import ROOT  # noqa: F401
from oclbench import flops, spec, trace
from oclbench.harness import Run
from oclbench.trace import Event

MS = 1_000_000


def profile():
    ev = [Event("range", "block", 0, 20 * MS)]
    corr = iter(range(1, 1000))

    def launch(t_host, t_dev, dur, name="k"):
        c = next(corr)
        ev.append(Event("runtime", "cudaLaunchKernel", t_host, t_host + 10_000, c))
        ev.append(Event("kernel", name, t_dev, t_dev + dur, c))

    for s in (0, 10 * MS):
        ev.append(Event("range", "step", s, s + 9 * MS))
        ev.append(Event("range", "aser.retrieve", s + 1 * MS, s + 3 * MS))
        ev.append(Event("range", "k1:310x310x640x1", s + 2 * MS, s + 2 * MS + 50_000))
        launch(s + 100_000, s + 1 * MS, 2 * MS)                          # step: 1-3 ms
        launch(s + 2 * MS + 10_000, s + 3 * MS, 10_000, "pairwise_sqdist_kernel<4>")
        launch(s + 2 * MS + 20_000, s + 3 * MS + 10_000, 990_000)         # retrieve: 3-4 ms
        launch(s + 5 * MS, s + 6 * MS, 2 * MS)                           # step: 6-8 ms
    ev.append(Event("memcpy", "Memcpy DtoH", 19 * MS, 19 * MS + 500_000, 0))
    return ev


def run():
    events = profile()
    return Run(events=events, span=trace.block_span(events), block_steps=2,
               host_step_s=[0.008, 0.010], intervals_s=[0.01, 0.01, 0.01], step_flops=10 ** 9)


def read(name):
    return spec.reader(name)(run())


def test_launches_a_step():
    assert read("step.launches") == 4


def test_host_ms():
    assert read("step.host_ms") == pytest.approx(9.0)


def test_aser_device_ms_takes_the_kernels_launched_inside_its_ranges():
    # the K1 kernel (10 us) and the 0.99 ms one, each step
    assert read("aser.device_ms") == pytest.approx(1.0)


def test_k1_roofline():
    least = flops.least_seconds(*flops.sqdist_ops_bytes(310, 310, 640))
    assert read("k1_roofline") == pytest.approx(100 * least / 10e-6)


def test_mfu():
    assert read("step.mfu") == pytest.approx(100 * 1e9 / 0.01 / 67e12)


def test_idle_share():
    # busy in the block: 1-4 and 6-8 ms each step, and the copy's 0.5 ms:
    # 10.5 ms over 2 steps, against the unprofiled steps' 10 ms intervals
    assert read("device.idle_pct") == pytest.approx(100 * (1 - 10.5 / 2 / 10))


def test_idle_gaps_are_labelled_by_the_launching_range():
    gaps = dict(trace.idle_gaps(profile(), (0, 20 * MS)))
    # 0-1, 4-6, 8-11 and 14-16 ms end in a kernel launched in "step" (outside
    # the retrieval range); 18-19 ms ends in a copy of no launch, at a time
    # inside the second step's range; 19.5-20 ms inside none
    assert gaps["step"] == pytest.approx((1 + 2 + 3 + 2 + 1) / 1e3)
    assert gaps["outside_ranges"] == pytest.approx(0.5 / 1e3)
    assert sum(gaps.values()) == pytest.approx(9.5 / 1e3)


def test_device_ops_sum_by_name():
    ops = dict(trace.device_ops(profile(), (0, 20 * MS)))
    assert ops["k"] == pytest.approx((2 + 0.99 + 2) * 2 / 1e3)
    assert ops["pairwise_sqdist_kernel<4>"] == pytest.approx(20e-6)


@pytest.mark.parametrize("name", ["step.launches", "aser.device_ms", "k1_roofline",
                                  "device.idle_pct"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    assert spec.reader(name)(Run()) is None


@pytest.mark.parametrize("device,name,kind", [
    ("cuda", "void at::native::elementwise_kernel<128, 2>", "kernel"),
    ("cuda", "Memcpy HtoD (Pageable -> Device)", "memcpy"),
    ("cuda", "Memset (Device)", "memset"),
    ("cuda", "step", None),                      # a host range's projection
    ("cuda", "k1:310x310x640x1", None),
    ("cpu", "cudaLaunchKernel", "runtime"),
    ("cpu", "cuLaunchKernel", "runtime"),
    ("cpu", "aser.update", "range"),
    ("cpu", "k1:10x300x640x1", "range"),
    ("cpu", "aten::conv2d", None),
])
def test_event_kinds(device, name, kind):
    assert trace.kind_of(device, name) == kind
