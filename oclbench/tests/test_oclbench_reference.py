"""The plain reference against the port on small cells on the CPU: a whole
run (set-up, a short window, the traced block, the judge) comes out correct,
and each fault a cell can have, planted under the timed path, comes out not
correct. The reference model alone matches the port's forward."""

import time

import pytest
import torch

from oclbench_cells import CELLS
from oclbench import faults, harness
from oclbench.reference import model as M


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace_on", [False, True])
def test_a_sound_run_is_correct(cell, trace_on):
    result, checks = harness.run_cell(CELLS[cell](), 2 ** 31 + 12345, 0.5, trace_on, "cpu",
                                      time.perf_counter())
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
    names = set(result["metrics"])
    if trace_on:
        assert {"step.host_ms", "step.mfu"} <= names
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert names == {"images_per_s", "step_ms_p95", "setup_s"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_is_not_correct(cell, fault):
    result, checks = harness.run_cell(CELLS[cell](), 77, 0.3, False, "cpu", time.perf_counter(),
                                      fault=faults.FAULTS[fault])
    assert not result["correct"], checks


def test_the_reference_forward_matches_the_ports():
    from ocl_tpu_torch.config import default_params
    from ocl_tpu_torch.models import forward_train, setup_architecture

    arch = {"nf": 8, "image_size": 32, "channels": 3, "classes": 10}
    model = setup_architecture(default_params(data="cifar10", nf=8, device="cpu"),
                               torch.Generator().manual_seed(1), "cpu")
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = M.init_running(arch, "cpu")
    x = torch.rand(6, 32, 32, 3)
    w = torch.tensor([1, 1, 0, 1, 0, 1], dtype=torch.bool)
    with torch.no_grad():
        want = forward_train(model, x, w)
        got = M.logits(params, stats, x, arch, train=True, w=w)
    assert torch.equal(got, want)
    for n, b in model.named_buffers():
        assert torch.equal(stats[n], b), n
