"""The models at the real datasets' input sizes against ocl_tpu, on the same
weights and inputs: 84 px (Mini-ImageNet, 100 classes), 128 px (CORe50, 50
classes) and 50 px (OpenLORIS, 69 classes). The trunk pools to 4, 16 and 1
cells there (`models/resnet.py::pooled_cells`), so its feature width is 4,
16 and 1 times the 32-pixel one, and `interop` maps ocl_tpu's
NHWC-flattened head onto the port's by a transpose alone.

* Reduced ResNet-18: `setup_architecture` and `feature_dim_for`, the
  parameter tree against ocl_tpu's `init_model`, the train-mode forward
  (with and without a row mask), the BN statistics it folds, the eval
  forward and features, and one masked-CE SGD step.
* SupConResNet at 84 px (dim_in 640 at nf 20): SCR's augmentation of the
  batch from the same draws, the two-view train-mode forward, its BN
  statistics, the SupCon loss and one SGD step; at 128 px (dim_in 2,560)
  its tree, train-mode output, BN statistics and encoder features.

CN-DPM at 84 px is tests/test_torch_input_sizes_cndpm.py's.

nf 4. Tolerances as tests/test_torch_model.py: rtol 1e-3 / atol 1e-4, BN
running statistics atol 1e-5, augmented images atol 1e-5
(tests/test_torch_augment.py).

A ReLU input within fp32 rounding of zero can fall on either side in XLA
and in torch, and then moves an early layer's gradient entry by 1e-3 to
2e-2; an 84- or 128-pixel trunk has 7 and 16 times the ReLU inputs of a
32-pixel one. `python tests/test_torch_input_sizes.py` prints each
package's fp32 gradient against the port's fp64 one, and ocl_tpu's in fp64
(within about 2e-6 of it), for data seed 8 and for the seeds below: at
seed 8 ocl_tpu's fp32 conv1 gradient at 128 px is 1.2e-2 off, the port's
2e-4. So each size draws its batch from a seed that keeps both packages
within 1e-5 of fp64 (DATA_SEEDS), as tests/test_torch_model.py draws
from a seed clear of such flips, and the step runs at lr 0.1. SCR's step,
whose two views of six images pass the trunk, runs at lr 0.01, as
tests/test_torch_er_step.py's does.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ocl_tpu.models as j_models
from ocl_tpu.models.resnet import Reduced_ResNet18 as JReducedResNet18
from ocl_tpu.models.resnet import SupConResNet as JSupConResNet
from ocl_tpu.ops import augment as j_aug
from ocl_tpu.ops.losses import cross_entropy as j_cross_entropy
from ocl_tpu.ops.losses import supcon_loss as j_supcon_loss
from ocl_tpu.optim import setup_opt as j_setup_opt
from ocl_tpu_torch import interop
from ocl_tpu_torch.config import default_params, input_size_match, n_classes_match
from ocl_tpu_torch.models import (
    feature_dim_for,
    features_eval,
    forward_eval,
    forward_train,
    setup_architecture,
)
from ocl_tpu_torch.models.layers import BatchNorm, torch_init_
from ocl_tpu_torch.models.resnet import Reduced_ResNet18, SupConResNet
from ocl_tpu_torch.ops import augment
from ocl_tpu_torch.ops.losses import cross_entropy, supcon_loss
from ocl_tpu_torch.optim import setup_opt
from test_torch_run import torch_threads

NF = 4
LR, WD = 0.1, 1e-3
SCR_LR = 0.01
DATA_SEEDS = {"mini_imagenet": 12, "core50": 12, "openloris": 9}   # clear of flips (above)
TOL = dict(rtol=1e-3, atol=1e-4)
STATS_TOL = dict(rtol=1e-3, atol=1e-5)
SIZES = {"mini_imagenet": 84, "core50": 128, "openloris": 50}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread: the same sums on every host, and no
    oversubscribed cores under pytest's workers."""
    with torch_threads(1):
        yield

def _leaves(t):
    return jax.tree_util.tree_leaves(t)


def weights(model, size, seed):
    """(params, batch_stats) pytrees of `model` with torch's default init,
    its running statistics those of 64 random images of `size` pixels (one
    train-mode fold at momentum 1)."""
    torch_init_(model, torch.Generator().manual_seed(seed))
    for bn in (m for m in model.modules() if isinstance(m, BatchNorm)):
        bn.momentum = 1.0
    g = np.random.RandomState(seed)
    with torch.no_grad():
        forward_train(model, torch.from_numpy(g.rand(64, size, size, 3).astype(np.float32)))
    for bn in (m for m in model.modules() if isinstance(m, BatchNorm)):
        bn.momentum = 0.1
    return interop.to_jax(model.state_dict())


def assert_tree_matches_init_model(module, params, stats, data):
    shapes = jax.eval_shape(lambda k: j_models.init_model(module, k, data),
                            jax.random.PRNGKey(0))
    for ours, theirs in zip((params, stats), shapes):
        assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(theirs)
        assert [a.shape for a in _leaves(ours)] == [a.shape for a in _leaves(theirs)]


@pytest.mark.parametrize("data", sorted(input_size_match))
@pytest.mark.parametrize("nf", [4, 20])
def test_feature_dims_and_architecture_match_ocl_tpu(data, nf):
    """Every dataset's feature width (160 / 640 / 2,560 at nf 20) and head."""
    assert feature_dim_for(data, nf) == j_models.feature_dim_for(data, nf)
    size = input_size_match[data][0]
    assert feature_dim_for(data, nf) == {32: 1, 84: 4, 128: 16, 50: 1}[size] * nf * 8
    for agent in ("ER", "SCR"):
        params = default_params(data=data, agent=agent, nf=nf, device="cpu")
        model = setup_architecture(params, torch.Generator().manual_seed(0), "cpu")
        if agent == "ER":
            assert model.linear.weight.shape == (n_classes_match[data], feature_dim_for(data, nf))
        else:
            assert model.head_layers[0].weight.shape[1] == feature_dim_for(data, nf)
        if nf == 4:
            x = torch.rand(2, size, size, 3)
            assert features_eval(model, x).shape == (2, feature_dim_for(data, nf))


def ocl_loss_and_grad(module, params, stats, x, y, mask):
    """ocl_tpu's masked-CE loss and gradient, one jitted program."""
    def loss_fn(p, st, x, y, w):
        logits, _ = j_models.forward_train(module, p, st, x, w=w)
        return j_cross_entropy(logits, y, mask=w)

    return jax.jit(jax.value_and_grad(loss_fn))(params, stats, x, y, mask)


@pytest.fixture(scope="module", params=sorted(SIZES))
def resnet_ref(request):
    data = request.param
    size, n_cls = SIZES[data], n_classes_match[data]
    module = JReducedResNet18(n_cls, nf=NF)
    params, stats = weights(Reduced_ResNet18(n_cls, nf=NF, feature_dim=feature_dim_for(data, NF)),
                            size, seed=3)
    g = np.random.RandomState(DATA_SEEDS[data])
    x = g.rand(6, size, size, 3).astype(np.float32)
    y = g.randint(0, n_cls, 6)
    mask = np.array([1] * 5 + [0], bool)

    @jax.jit
    def forwards(p, st, x, w):
        return dict(train=j_models.forward_train(module, p, st, x),
                    train_masked=j_models.forward_train(module, p, st, x, w=w),
                    eval=j_models.forward_eval(module, p, st, x),
                    features=j_models.features_eval(module, p, st, x))

    # the gradient in a program of its own, the one gradient_report checks
    # the data seed with; ocl_tpu's SGD applies it
    loss, grads = ocl_loss_and_grad(module, params, stats, x, y, mask)
    tx = j_setup_opt("SGD", LR, WD)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = dict(forwards(params, stats, x, mask), loss=loss,
                stepped=optax.apply_updates(params, updates))
    want = jax.tree_util.tree_map(np.asarray, want)
    return data, module, params, stats, x, y, mask, want


def port_resnet(data, params, stats):
    model = Reduced_ResNet18(n_classes_match[data], nf=NF, feature_dim=feature_dim_for(data, NF))
    model.load_state_dict(interop.from_jax(params, stats), strict=True)
    return model


def test_resnet_tree_and_interop(resnet_ref):
    data, module, params, stats, *_ = resnet_ref
    assert_tree_matches_init_model(module, params, stats, data)
    sd = port_resnet(data, params, stats).state_dict()
    for k, v in interop.from_jax(*interop.to_jax(sd)).items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("masked", [False, True])
def test_resnet_forward_train_and_bn_stats(resnet_ref, masked):
    data, module, params, stats, x, y, mask, want = resnet_ref
    want_logits, want_stats = want["train_masked" if masked else "train"]
    model = port_resnet(data, params, stats)
    with torch.no_grad():
        got = forward_train(model, torch.from_numpy(x),
                            torch.from_numpy(mask) if masked else None)
    assert got.shape == (6, n_classes_match[data])
    np.testing.assert_allclose(got.numpy(), want_logits, **TOL)
    for a, b in zip(_leaves(interop.to_jax(model.state_dict())[1]), _leaves(want_stats)):
        np.testing.assert_allclose(a, b, **STATS_TOL)


def test_resnet_forward_eval_and_features(resnet_ref):
    data, module, params, stats, x, y, mask, want = resnet_ref
    model = port_resnet(data, params, stats)
    np.testing.assert_allclose(forward_eval(model, torch.from_numpy(x)).numpy(), want["eval"],
                               **TOL)
    feats = features_eval(model, torch.from_numpy(x))
    assert feats.shape == (6, feature_dim_for(data, NF))
    np.testing.assert_allclose(feats.numpy(), want["features"], **TOL)


def test_resnet_masked_ce_sgd_step(resnet_ref):
    data, module, params, stats, x, y, mask, want = resnet_ref
    model = port_resnet(data, params, stats)
    opt = setup_opt("SGD", model.parameters(), LR, WD)
    loss = cross_entropy(forward_train(model, torch.from_numpy(x), torch.from_numpy(mask)),
                         torch.from_numpy(y), torch.from_numpy(mask))
    loss.backward()
    opt.step()
    np.testing.assert_allclose(loss.item(), float(want["loss"]), rtol=1e-5)
    got, _ = interop.to_jax(model.state_dict())
    for a, b in zip(_leaves(got), _leaves(want["stepped"])):
        np.testing.assert_allclose(a, b, **TOL)


# ----------------------------------------------------------- SCR at 84 px

def scr_draws(key, n, size, tries=10):
    """ocl_tpu's draws of scr_transform(key, x) for `size`-pixel images as
    the port's draw dict (the split layout of tests/test_torch_augment.py)."""
    def t(a):
        return torch.tensor(np.asarray(a))

    r1, r2, r3, r4 = jax.random.split(key, 4)
    r_box, r_y, r_x = jax.random.split(r1, 3)
    r_on, r_b, r_c, r_s, r_h, r_ord = jax.random.split(r3, 6)

    def factor(r):
        return t(jax.random.uniform(r, (n, 1, 1, 1), minval=0.6, maxval=1.4)).reshape(n)

    return {"area": t(jax.random.uniform(r_box, (n, tries), minval=0.2, maxval=1.0) * size * size),
            "log_r": t(jax.random.uniform(jax.random.fold_in(r_box, 1), (n, tries),
                                          minval=jnp.log(3.0 / 4.0), maxval=jnp.log(4.0 / 3.0))),
            "u_y": t(jax.random.uniform(r_y, (n,))), "u_x": t(jax.random.uniform(r_x, (n,))),
            "flip": t(jax.random.uniform(r2, (n,)) < 0.5),
            "on": t(jax.random.uniform(r_on, (n,)) < 0.8), "bf": factor(r_b), "cf": factor(r_c),
            "sf": factor(r_s),
            "hf": t(jax.random.uniform(r_h, (n, 1, 1), minval=-0.1, maxval=0.1)).reshape(n),
            "order": [int(i) for i in jax.random.permutation(r_ord, 4)],
            "gray": t(jax.random.uniform(r4, (n,)) < 0.2)}


def test_supcon_resnet_with_scr_augmentation():
    """SCR's step at 84 px: the batch augmented from the same draws (the
    crop's area scales with the image), both views through one masked
    train-mode forward, the SupCon loss at temp 0.1 and an SGD step (the
    agent's own draws of the crop's area at that size checked too)."""
    data = "mini_imagenet"
    size, dim_in = SIZES[data], feature_dim_for(data, NF)
    module = JSupConResNet(dim_in=dim_in, head="mlp", nf=NF)
    params, stats = weights(SupConResNet(dim_in=dim_in, nf=NF), size, seed=5)
    assert_tree_matches_init_model(module, params, stats, data)
    g = np.random.RandomState(9)
    x = g.rand(6, size, size, 3).astype(np.float32)
    y = g.randint(0, 3, 6)
    mask = np.array([1] * 5 + [0], bool)
    key = jax.random.PRNGKey(10)

    @jax.jit
    def reference(p, st, x, y, w):
        aug = j_aug.scr_transform(key, x)

        def loss_fn(p):
            out, new_st = j_models.forward_train(module, p, st, jnp.concatenate([x, aug]),
                                                 w=jnp.concatenate([w, w]))
            f1, f2 = jnp.split(out, 2)
            return j_supcon_loss(jnp.stack([f1, f2], axis=1), y, 0.1, mask=w), new_st

        (loss, new_st), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        tx = j_setup_opt("SGD", SCR_LR, 0.0)
        updates, _ = tx.update(grads, tx.init(p), p)
        return dict(aug=aug, loss=loss, stats=new_st, stepped=optax.apply_updates(p, updates))

    want = jax.tree_util.tree_map(np.asarray, reference(params, stats, x, y, mask))
    draws = scr_draws(key, 6, size)
    d = augment.draw_scr_transform(torch.Generator().manual_seed(0), random.Random(0), 6,
                                   (size, size))
    assert 0.2 * size * size <= d["area"].min() and d["area"].max() <= size * size
    aug = augment.scr_transform(torch.from_numpy(x), draws)
    np.testing.assert_allclose(aug.numpy(), want["aug"], rtol=0, atol=1e-5)

    model = SupConResNet(dim_in=dim_in, head="mlp", nf=NF)
    model.load_state_dict(interop.from_jax(params, stats), strict=True)
    opt = setup_opt("SGD", model.parameters(), SCR_LR, 0.0)
    w = torch.from_numpy(mask)
    f1, f2 = forward_train(model, torch.cat([torch.from_numpy(x), aug]),
                           torch.cat([w, w])).chunk(2)
    loss = supcon_loss(torch.stack([f1, f2], dim=1), torch.from_numpy(y), 0.1, mask=w)
    loss.backward()
    opt.step()
    np.testing.assert_allclose(loss.item(), float(want["loss"]), rtol=1e-4)
    got_params, got_stats = interop.to_jax(model.state_dict())
    for a, b in zip(_leaves(got_stats), _leaves(want["stats"])):
        np.testing.assert_allclose(a, b, **STATS_TOL)
    for a, b in zip(_leaves(got_params), _leaves(want["stepped"])):
        np.testing.assert_allclose(a, b, **TOL)


def test_supcon_resnet_at_128():
    """SupConResNet at CORe50's 128 px: dim_in 16 cells x nf x 8, the MLP
    head's tree, the masked train-mode output and BN statistics, and the
    encoder's eval features."""
    data = "core50"
    size, dim_in = SIZES[data], feature_dim_for(data, NF)
    module = JSupConResNet(dim_in=dim_in, head="mlp", nf=NF)
    params, stats = weights(SupConResNet(dim_in=dim_in, nf=NF), size, seed=6)
    assert_tree_matches_init_model(module, params, stats, data)
    g = np.random.RandomState(11)
    x = g.rand(4, size, size, 3).astype(np.float32)
    mask = np.array([1, 1, 1, 0], bool)

    @jax.jit
    def reference(p, st, x, w):
        return dict(train=j_models.forward_train(module, p, st, x, w=w),
                    features=j_models.features_eval(module, p, st, x))

    want = jax.tree_util.tree_map(np.asarray, reference(params, stats, x, mask))
    model = SupConResNet(dim_in=dim_in, head="mlp", nf=NF)
    model.load_state_dict(interop.from_jax(params, stats), strict=True)
    feats = features_eval(model, torch.from_numpy(x))
    assert feats.shape == (4, dim_in) == (4, 16 * NF * 8)
    np.testing.assert_allclose(feats.numpy(), want["features"], **TOL)
    with torch.no_grad():
        out = forward_train(model, torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), want["train"][0], **TOL)
    for a, b in zip(_leaves(interop.to_jax(model.state_dict())[1]), _leaves(want["train"][1])):
        np.testing.assert_allclose(a, b, **STATS_TOL)


def gradient_report():
    """Per input size and data seed, the largest gap of a few layers'
    gradients (one masked-CE backward of the fixture's weights on a batch
    drawn from the seed): the port in fp32 against the port in fp64, ocl_tpu
    in fp32 against the port in fp64, and ocl_tpu in fp64 (its fp32 casts
    patched to fp64, in this process only) against the port in fp64."""
    import ocl_tpu.models.layers as j_layers
    import ocl_tpu.models.resnet as j_resnet
    import ocl_tpu.ops.losses as j_losses

    layers = ["conv1.weight", "stages.0.0.conv1.weight", "stages.3.1.conv2.weight",
              "linear.weight"]
    cases = []
    for data in sorted(SIZES):
        size, n_cls = SIZES[data], n_classes_match[data]
        params, stats = weights(Reduced_ResNet18(n_cls, nf=NF,
                                                 feature_dim=feature_dim_for(data, NF)), size, 3)
        for seed in (8, DATA_SEEDS[data]):
            g = np.random.RandomState(seed)
            x = g.rand(6, size, size, 3).astype(np.float32)
            y, mask = g.randint(0, n_cls, 6), np.array([1] * 5 + [0], bool)
            cases.append(((data, seed), params, stats, x, y, mask))

    def port_grads(case, params, stats, x, y, mask, dtype):
        model = port_resnet(case[0], params, stats).to(dtype)
        cross_entropy(forward_train(model, torch.from_numpy(x).to(dtype), torch.from_numpy(mask)),
                      torch.from_numpy(y), torch.from_numpy(mask)).backward()
        return {k: p.grad.double() for k, p in model.named_parameters()}

    def ocl_grads(case, params, stats, x, y, mask, dtype):
        module = JReducedResNet18(n_classes_match[case[0]], nf=NF)
        cast = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), (params, stats, x))
        _, grads = ocl_loss_and_grad(module, *cast, y, mask)
        grads = jax.tree_util.tree_map(np.asarray, grads)
        return {k: torch.from_numpy(np.asarray(v)).double()
                for k, v in interop.from_jax(grads, stats).items()}

    rows = {c[0]: [port_grads(*c, torch.float32), port_grads(*c, torch.float64),
                   ocl_grads(*c, jnp.float32)] for c in cases}
    jax.config.update("jax_enable_x64", True)

    class F64:
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    for mod in (j_layers, j_resnet, j_losses, j_models):
        mod.jnp = F64()
    for c in cases:
        port32, port64, ocl32 = rows[c[0]]
        ocl64 = ocl_grads(*c, jnp.float64)
        for k in layers:
            print("{} seed {} {}: |port32 - port64| {:.3e}, |ocl32 - port64| {:.3e}, "
                  "|ocl64 - port64| {:.3e}".format(
                      *c[0], k, (port32[k] - port64[k]).abs().max(),
                      (ocl32[k] - port64[k]).abs().max(), (ocl64[k] - port64[k]).abs().max()))


if __name__ == "__main__":
    gradient_report()
