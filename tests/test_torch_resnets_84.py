"""ResNet-18, -34 and -50 at 84 px (Mini-ImageNet's size: the trunk pools
to 2 x 2 cells and crops the remainder) against ocl_tpu's, as
tests/test_torch_resnets.py holds them at 32 px: eval and train-mode
forward, BN statistics, one SGD step, at the same tolerances and learning
rates (that file says why)."""

import pytest

from test_torch_resnets import check_resnet


@pytest.mark.parametrize("name", ["ResNet18", "ResNet34", "ResNet50"])
def test_resnet_at_84_px_matches_ocl_tpu(name):
    check_resnet(name, 84)
