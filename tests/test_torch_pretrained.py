"""ResNet18_pretrained (ocl_tpu_torch/models/pretrained.py) against
ocl_tpu's (ocl_tpu/models/pretrained.py): an .npz of ocl_tpu's format
(flax parameter paths joined by "/", HWIO kernels, Dense kernels [in, out])
written from ocl_tpu's own init gives the same weights and logits in both
packages (rtol 1e-3 / atol 1e-4); a key of the wrong shape, and a missing
one, keep the drawn value; the BN running statistics keep their initial
values; `save_npz` writes a file both loaders read back. Nothing is fetched:
the files are written here."""

import jax
import numpy as np
import torch

from ocl_tpu.models import forward_eval as j_forward_eval
from ocl_tpu.models import forward_train as j_forward_train
from ocl_tpu.models import pretrained as j_pretrained
from ocl_tpu_torch import interop
from ocl_tpu_torch.models import forward_eval, forward_train
from ocl_tpu_torch.models.pretrained import ResNet18_pretrained, save_npz

TOL = dict(rtol=1e-3, atol=1e-4)


def _leaves(t):
    return jax.tree_util.tree_leaves(t)


def _npz_key(path):
    return "/".join(str(getattr(p, "key", p)) for p in path)


def test_pretrained_npz_gives_the_same_logits(tmp_path):
    size = 64
    module, params, stats = j_pretrained.ResNet18_pretrained(10, rng=jax.random.PRNGKey(1),
                                                             input_size=size)
    flat = {_npz_key(path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    npz = str(tmp_path / "trunk.npz")
    np.savez(npz, **flat)
    module, params, stats = j_pretrained.ResNet18_pretrained(10, npz, rng=jax.random.PRNGKey(2),
                                                             input_size=size)
    x = np.random.RandomState(4).rand(2, size, size, 3).astype(np.float32)
    model = ResNet18_pretrained(10, npz, torch.Generator().manual_seed(5), input_size=size)
    got_params, got_stats = interop.to_jax(model.state_dict())
    for a, b in zip(_leaves((got_params, got_stats)), _leaves((flat, stats))):
        np.testing.assert_array_equal(a, np.asarray(b))
    want = jax.jit(lambda p, st: (j_forward_eval(module, p, st, x),
                                  j_forward_train(module, p, st, x)[0]))(params, stats)
    np.testing.assert_allclose(forward_eval(model, torch.from_numpy(x)).numpy(),
                               np.asarray(want[0]), **TOL)
    with torch.no_grad():
        np.testing.assert_allclose(forward_train(model, torch.from_numpy(x)).numpy(),
                                   np.asarray(want[1]), **TOL)


def test_pretrained_keeps_the_draw_for_a_wrong_or_missing_key(tmp_path):
    drawn = ResNet18_pretrained(10, None, torch.Generator().manual_seed(5), input_size=32)
    params, _ = interop.to_jax(drawn.state_dict())
    flat = {_npz_key(path): leaf + 1.0
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    flat["linear/Dense_0/kernel"] = np.zeros((3, 3), np.float32)   # wrong shape
    del flat["conv1/Conv_0/kernel"]                                 # missing
    npz = str(tmp_path / "partial.npz")
    np.savez(npz, **flat)
    model = ResNet18_pretrained(10, npz, torch.Generator().manual_seed(5), input_size=32)
    got, want = model.state_dict(), drawn.state_dict()
    for key in ("linear.weight", "conv1.weight"):
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(got["linear.bias"], want["linear.bias"] + 1.0)
    assert torch.equal(got["stages.0.0.conv1.weight"], want["stages.0.0.conv1.weight"] + 1.0)
    assert torch.equal(got["bn1.running_var"], want["bn1.running_var"])


def test_save_npz_round_trips_through_both_loaders(tmp_path):
    drawn = ResNet18_pretrained(10, None, torch.Generator().manual_seed(6), input_size=32)
    npz = str(tmp_path / "saved.npz")
    save_npz(drawn, npz)
    model = ResNet18_pretrained(10, npz, torch.Generator().manual_seed(7), input_size=32)
    for (key, a), b in zip(model.named_parameters(), drawn.parameters()):
        assert torch.equal(a, b), key
    _, params, _ = j_pretrained.ResNet18_pretrained(10, npz, rng=jax.random.PRNGKey(3),
                                                    input_size=32)
    for a, b in zip(_leaves(params), _leaves(interop.to_jax(drawn.state_dict())[0])):
        np.testing.assert_array_equal(np.asarray(a), b)
