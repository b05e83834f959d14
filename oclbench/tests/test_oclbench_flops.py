"""The yardstick's arithmetic: the shape count of the Reduced ResNet-18's
FLOPs against the port's counter, and K1's operations and bytes."""

import pytest
import torch

from oclbench_cells import ROOT  # noqa: F401  (puts the checkout on the path)
from oclbench import flops
from oclbench.reference import model as M


@pytest.mark.parametrize("size,data", [(32, "cifar100"), (84, "mini_imagenet")])
def test_forward_count_equals_the_ports_counter(size, data):
    from ocl_tpu_torch.config import default_params
    from ocl_tpu_torch.models import forward_eval, setup_architecture
    from ocl_tpu_torch.utils.flops import FlopCount

    params = default_params(data=data, nf=20, device="cpu")
    model = setup_architecture(params, torch.Generator().manual_seed(0), "cpu")
    x = torch.rand(2, size, size, 3)
    with FlopCount() as counter:
        forward_eval(model, x)
    arch = {"nf": 20, "image_size": size, "channels": 3, "classes": 100}
    assert flops.forward_flops(arch) * 2 == counter.matmul


def test_forward_and_backward_count_equals_the_ports_counter():
    from ocl_tpu_torch.config import default_params
    from ocl_tpu_torch.models import forward_train, setup_architecture
    from ocl_tpu_torch.ops.losses import cross_entropy
    from ocl_tpu_torch.utils.flops import FlopCount

    params = default_params(data="cifar100", nf=20, device="cpu")
    model = setup_architecture(params, torch.Generator().manual_seed(0), "cpu")
    x, y = torch.rand(3, 32, 32, 3), torch.tensor([1, 2, 3])
    with FlopCount() as counter:
        cross_entropy(forward_train(model, x), y).backward()
    arch = {"nf": 20, "image_size": 32, "channels": 3, "classes": 100}
    assert (flops.forward_flops(arch) + flops.backward_flops(arch)) * 3 == counter.matmul


def test_per_image_forward_figures():
    assert flops.forward_flops({"nf": 20, "image_size": 32, "channels": 3,
                                "classes": 100}) == 109_272_320
    assert abs(flops.forward_flops({"nf": 20, "image_size": 84, "channels": 3,
                                    "classes": 100}) / 0.75e9 - 1) < 0.05


@pytest.mark.parametrize("n,m,d,points,ops,nbytes", [
    (310, 310, 640, 1, 2 * 310 * 310 * 640 + 2 * 620 * 640, 4 * (2 * 310 * 640 + 310 * 310)),
    (10, 300, 640, 1, 2 * 10 * 300 * 640 + 2 * 310 * 640, 4 * (310 * 640 + 3000)),
    (30, 30, 160, 84, 84 * (2 * 900 * 160 + 2 * 60 * 160), 84 * 4 * (60 * 160 + 900)),
])
def test_k1_operations_and_bytes(n, m, d, points, ops, nbytes):
    assert flops.sqdist_ops_bytes(n, m, d, points) == (ops, nbytes)


def test_k1_least_time_takes_the_larger_bound():
    ops, nbytes = flops.sqdist_ops_bytes(310, 310, 640)
    assert flops.least_seconds(ops, nbytes) == pytest.approx(ops / 67e12)   # operations bound
    ops, nbytes = flops.sqdist_ops_bytes(10, 20, 160)
    assert flops.least_seconds(ops, nbytes) == pytest.approx(nbytes / 3.35e12)


def test_step_flops_counts_points_and_passes():
    arch = {"nf": 20, "image_size": 32, "channels": 3, "classes": 100}
    one = flops.step_flops(arch, [{"rows": 20, "backward": True}])
    assert flops.step_flops(arch, [{"rows": 20, "backward": True}], 84) == 84 * one
    assert flops.step_flops(arch, [{"rows": 5, "head": False}]) == 5 * flops.forward_flops(
        arch, head=False)


def test_leaves_match_the_ports_model():
    from ocl_tpu_torch.config import default_params
    from ocl_tpu_torch.models import setup_architecture

    for data, size in (("cifar100", 32), ("mini_imagenet", 84)):
        model = setup_architecture(default_params(data=data, nf=20, device="cpu"),
                                   torch.Generator().manual_seed(0), "cpu")
        arch = {"nf": 20, "image_size": size, "channels": 3, "classes": 100}
        want = {n: tuple(p.shape) for n, p in model.named_parameters()}
        assert {n: s for n, s, _, _ in M.leaves(arch)} == want
