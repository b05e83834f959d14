"""The full-width ResNet family, `init_model`, `param_count` and the
pretrained trunk against ocl_tpu's (ocl_tpu/models/resnet.py,
models/__init__.py, models/pretrained.py), at nf 4.

* ResNet-18, -34 and -50 on the same weights (interop.from_jax), at 32 px
  (and at 84 px, which pools to 2 x 2 cells, its remainder cropped, in
  tests/test_torch_resnets_84.py): the
  train-mode forward with a row mask, the BN statistics it folds, the eval
  forward and one masked-CE SGD step, rtol 1e-3 / atol 1e-4 (atol 1e-5 on
  the statistics), as tests/test_torch_model.py. The JAX side is one jitted
  program a model and size.
* ResNet-101 and -152: the same parameter count as ocl_tpu's, and their
  pytrees through from_jax and back, bit for bit.
* The head's width: what flax infers at init, at 32, 50, 84, 128 and 224 px.
* ResNet18_pretrained: tests/test_torch_pretrained.py.

The SGD step of ResNet-18 runs at lr 0.01 for the reason
test_torch_er_step.py gives: at nf 4 a ReLU input within rounding of zero
may flip between XLA and torch; at lr 0.01 that stays under atol while a
missing or extra gradient term does not. A 34- or 50-layer trunk at nf 4
is worse conditioned: on these weights and batch ocl_tpu's fp32 gradient
of conv1 departs from its own fp64 one (its modules run with jnp.float32
patched to float64) by 3.8e-2 (ResNet-34, 32 px), 0.72 and 0.89 (ResNet-50,
32 and 84 px) at |g| <= 24, the port's by 9.1e-6, 2.7e-4 and 0.29, and a
tensor's gradient by up to 2.3% (ResNet-34) and 13.7% (ResNet-50) of its
norm between the packages; their steps run at lr 1e-4, where that stays
under atol and conv1's step (about 1e-3) does not. `python
tests/test_torch_resnets.py` prints those figures.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocl_tpu.models import forward_eval as j_forward_eval
from ocl_tpu.models import forward_train as j_forward_train
from ocl_tpu.models import init_model as j_init_model
from ocl_tpu.models import param_count as j_param_count
from ocl_tpu.models import resnet as j_resnet
from ocl_tpu.models import setup_architecture as j_setup_architecture
from ocl_tpu.ops.losses import cross_entropy as j_cross_entropy
from ocl_tpu.optim import setup_opt as j_setup_opt
from ocl_tpu_torch import interop
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.models import (
    forward_eval,
    forward_train,
    init_model,
    param_count,
    resnet,
    setup_architecture,
)
from ocl_tpu_torch.models.layers import BatchNorm
from ocl_tpu_torch.ops.losses import cross_entropy
from ocl_tpu_torch.optim import setup_opt

NF = 4
LR = {"ResNet18": 0.01, "ResNet34": 1e-4, "ResNet50": 1e-4}
WD = 1e-3
TOL = dict(rtol=1e-3, atol=1e-4)
STATS_TOL = dict(rtol=1e-3, atol=1e-5)


def _leaves(t):
    return jax.tree_util.tree_leaves(t)


def port_weights(name, size, seed):
    """(params, batch_stats) numpy pytrees of the port's `name` at nf 4 with
    torch's default init, its running statistics those of 16 random images
    (one train-mode fold at momentum 1), so that the eval forward is
    normalised as a trained model's is."""
    model = getattr(resnet, name)(10, nf=NF, input_size=size)
    init_model(model, torch.Generator().manual_seed(seed))
    for bn in (m for m in model.modules() if isinstance(m, BatchNorm)):
        bn.momentum = 1.0
    g = np.random.RandomState(seed)
    with torch.no_grad():
        forward_train(model, torch.from_numpy(g.rand(16, size, size, 3).astype(np.float32)))
    return interop.to_jax(model.state_dict())


def check_resnet(name, size):
    """The port's `name` against ocl_tpu's at `size` px: eval and train-mode
    forward, BN statistics, one SGD step."""
    module = getattr(j_resnet, name)(10, nf=NF)
    params, stats = port_weights(name, size, seed=3)
    g = np.random.RandomState(8)
    x = g.rand(6, size, size, 3).astype(np.float32)
    y = g.randint(0, 10, 6)
    mask = np.array([1] * 5 + [0], bool)

    @jax.jit
    def reference(p, st):
        def loss_fn(p):
            logits, _ = j_forward_train(module, p, st, x, w=mask)
            return j_cross_entropy(logits, y, mask=mask)

        grads = jax.grad(loss_fn)(p)
        tx = j_setup_opt("SGD", LR[name], WD)
        updates, _ = tx.update(grads, tx.init(p), p)
        return dict(train=j_forward_train(module, p, st, x, w=mask),
                    eval=j_forward_eval(module, p, st, x),
                    stepped=optax.apply_updates(p, updates))

    want = jax.tree_util.tree_map(np.asarray, reference(params, stats))
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, size, size, 3)), train=True))
    assert [a.shape for a in _leaves((params, stats))] == \
        [a.shape for a in _leaves((shapes["params"], shapes["batch_stats"]))]

    def model():
        m = getattr(resnet, name)(10, nf=NF, input_size=size)
        m.load_state_dict(interop.from_jax(params, stats), strict=True)
        return m

    m = model()
    np.testing.assert_allclose(forward_eval(m, torch.from_numpy(x)).numpy(), want["eval"], **TOL)
    with torch.no_grad():
        logits = forward_train(m, torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(logits.numpy(), want["train"][0], **TOL)
    for a, b in zip(_leaves(interop.to_jax(m.state_dict())[1]), _leaves(want["train"][1])):
        np.testing.assert_allclose(a, b, **STATS_TOL)

    m = model()
    opt = setup_opt("SGD", m.parameters(), LR[name], WD)
    cross_entropy(forward_train(m, torch.from_numpy(x), torch.from_numpy(mask)),
                  torch.from_numpy(y), torch.from_numpy(mask)).backward()
    opt.step()
    for a, b in zip(_leaves(interop.to_jax(m.state_dict())[0]), _leaves(want["stepped"])):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("name", ["ResNet18", "ResNet34", "ResNet50"])
def test_resnet_matches_ocl_tpu(name):
    check_resnet(name, 32)


@pytest.mark.parametrize("name", ["ResNet101", "ResNet152"])
def test_deep_resnets_count_and_round_trip(name):
    module = getattr(j_resnet, name)(10, nf=NF)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 32, 32, 3)), train=True))
    g = np.random.RandomState(0)
    params, stats = (jax.tree_util.tree_map(lambda s: g.randn(*s.shape).astype(np.float32), t)
                     for t in (shapes["params"], shapes["batch_stats"]))
    model = getattr(resnet, name)(10, nf=NF)
    model.load_state_dict(interop.from_jax(params, stats), strict=True)
    assert param_count(model) == j_param_count(shapes["params"])
    back = interop.to_jax(model.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure((params, stats))
    for a, b in zip(_leaves(back), _leaves((params, stats))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size", [32, 50, 84, 128, 224])
@pytest.mark.parametrize("name", ["ResNet18", "ResNet50"])
def test_head_width_is_what_flax_infers(name, size):
    module = getattr(j_resnet, name)(10, nf=NF)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, size, size, 3)), train=True))
    want = shapes["params"]["linear"]["Dense_0"]["kernel"].shape[0]
    assert getattr(resnet, name)(10, nf=NF, input_size=size).linear.in_features == want
    assert resnet.pooled_cells(size) * NF * 8 * (4 if name == "ResNet50" else 1) == want


@pytest.mark.parametrize("agent", ["ER", "SCR"])
def test_setup_architecture_and_param_count_match_ocl_tpu(agent):
    p = dict(data="synthetic", agent=agent, nf=NF)
    module = j_setup_architecture(j_default(**p))
    params, stats = j_init_model(module, jax.random.PRNGKey(0), "synthetic")
    model = setup_architecture(default_params(**p, device="cpu"), torch.Generator(), "cpu")
    assert param_count(model) == j_param_count(params)
    assert [a.shape for a in _leaves(interop.to_jax(model.state_dict()))] == \
        [a.shape for a in _leaves((params, stats))]


def j_default(**kw):
    from ocl_tpu.config import default_params as j_default_params

    return j_default_params(**kw)


def test_init_model_draws_weights_and_resets_bn():
    model = resnet.ResNet50(10, nf=NF)
    init_model(model, torch.Generator().manual_seed(1))
    with torch.no_grad():
        forward_train(model, torch.rand(4, 32, 32, 3))
        for p in model.parameters():
            p.add_(1.0)
    init_model(model, torch.Generator().manual_seed(1))
    fresh = init_model(resnet.ResNet50(10, nf=NF), torch.Generator().manual_seed(1))
    for (name, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), name
    for bn in (m for m in model.modules() if isinstance(m, BatchNorm)):
        assert bool((bn.weight == 1).all() and (bn.bias == 0).all())
        assert bool((bn.running_mean == 0).all() and (bn.running_var == 1).all())


def gradient_report():
    """Print, for each case of check_resnet, conv1's fp32 gradient of each
    package against ocl_tpu's fp64 one, and the largest relative gap of a
    tensor's gradient between the packages (in its norm)."""
    import ocl_tpu.models as j_models
    from ocl_tpu.models import layers as j_layers
    from ocl_tpu.ops import losses as j_losses

    cases = [(n, s) for n in ("ResNet18", "ResNet34", "ResNet50") for s in (32, 84)]

    def batch(size):
        g = np.random.RandomState(8)
        return (g.rand(6, size, size, 3).astype(np.float32), g.randint(0, 10, 6),
                np.array([1] * 5 + [0], bool))

    def ocl_grads(name, size, dtype):
        module = getattr(j_resnet, name)(10, nf=NF)
        params, stats = port_weights(name, size, seed=3)
        x, y, mask = batch(size)
        cast = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), (params, stats, x))

        def loss_fn(p):
            logits, _ = j_forward_train(module, p, cast[1], cast[2], w=mask)
            return j_cross_entropy(logits, y, mask=mask)

        return jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(cast[0]))

    def port_grads(name, size):
        params, stats = port_weights(name, size, seed=3)
        x, y, mask = batch(size)
        m = getattr(resnet, name)(10, nf=NF, input_size=size)
        m.load_state_dict(interop.from_jax(params, stats))
        cross_entropy(forward_train(m, torch.from_numpy(x), torch.from_numpy(mask)),
                      torch.from_numpy(y), torch.from_numpy(mask)).backward()
        return interop.to_jax({n: p.grad for n, p in m.named_parameters()})[0]

    rows = {c: (port_grads(*c), ocl_grads(*c, jnp.float32)) for c in cases}
    jax.config.update("jax_enable_x64", True)

    class F64:
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    for mod in (j_layers, j_resnet, j_losses, j_models):
        mod.jnp = F64()
    for c, (port32, ocl32) in rows.items():
        ocl64 = ocl_grads(*c, jnp.float64)
        conv1 = [t["conv1"]["Conv_0"]["kernel"] for t in (port32, ocl32, ocl64)]
        rel = max(np.linalg.norm(a - b) / np.linalg.norm(b)
                  for a, b in zip(_leaves(port32), _leaves(ocl32)))
        print("{} {} px: conv1 |g| {:.2f}, |port32 - ocl64| {:.2e}, |ocl32 - ocl64| {:.2e}; "
              "largest gap of a tensor's gradient between the packages {:.2%} of its "
              "norm".format(*c, np.abs(conv1[2]).max(), np.abs(conv1[0] - conv1[2]).max(),
                            np.abs(conv1[1] - conv1[2]).max(), rel))


if __name__ == "__main__":
    gradient_report()
