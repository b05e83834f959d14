"""The port's Reduced ResNet-18 against ocl_tpu.models on the same weights:
train-mode forward (with and without a row mask), eval forward and features,
BN running statistics, and one masked-CE SGD step; SupConResNet's forward
and features under each head. nf=4 keeps it cheap; the JAX side runs as one
jitted program.

Tolerances: rtol 1e-3 / atol 1e-4 (fp32 reduction order differs between XLA
and torch), atol 1e-5 for BN running statistics, as tests/test_torch_parity.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocl_tpu.models import features_eval as j_features_eval
from ocl_tpu.models import forward_eval as j_forward_eval
from ocl_tpu.models import forward_train as j_forward_train
from ocl_tpu.models import init_model
from ocl_tpu.models.resnet import Reduced_ResNet18 as JReducedResNet18
from ocl_tpu.models.resnet import SupConResNet as JSupConResNet
from ocl_tpu.ops.losses import cross_entropy as j_cross_entropy
from ocl_tpu.optim import setup_opt as j_setup_opt
from ocl_tpu_torch import interop
from ocl_tpu_torch.models import features_eval, forward_eval, forward_train
from ocl_tpu_torch.models.layers import BatchNorm, torch_init_
from ocl_tpu_torch.models.resnet import Reduced_ResNet18, SupConResNet
from ocl_tpu_torch.ops.losses import cross_entropy
from ocl_tpu_torch.optim import setup_opt
from test_torch_buffer import class_images

NF = 4
LR, WD = 0.1, 1e-3
TOL = dict(rtol=1e-3, atol=1e-4)
STATS_TOL = dict(rtol=1e-3, atol=1e-5)


def _leaves(t):
    return jax.tree_util.tree_leaves(t)


def random_weights(seed, nf=NF, model=None):
    """(params, batch_stats) numpy pytrees of a Reduced ResNet-18 (or of
    `model`) with torch's default init, its running statistics those of 200
    class images (one train-mode fold at momentum 1). Eval-mode features
    then spread as a trained model's do, and nearest-neighbour orders over
    them are decided by the data, not by rounding."""
    model = model if model is not None else Reduced_ResNet18(10, nf=nf)
    torch_init_(model, torch.Generator().manual_seed(seed))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.momentum = 1.0
    g = np.random.RandomState(seed)
    with torch.no_grad():
        forward_train(model, torch.from_numpy(class_images(g.randint(0, 10, 200), g)))
    return interop.to_jax(model.state_dict())


def port_model(params, stats, nf=NF):
    model = Reduced_ResNet18(10, nf=nf)
    model.load_state_dict(interop.from_jax(params, stats), strict=True)
    return model


@pytest.fixture(scope="module")
def ref():
    module = JReducedResNet18(10, nf=NF)
    params, stats = random_weights(3)
    # A ReLU input within fp32 rounding of zero can flip between XLA and
    # torch and move an early-layer gradient by ~1e-3; this data seed keeps
    # clear of that (seed 7 does not: one input sits 1.4e-6 from zero).
    g = np.random.RandomState(8)
    x = g.rand(12, 32, 32, 3).astype(np.float32)
    y = g.randint(0, 10, 12)
    mask = np.array([1] * 9 + [0] * 3, bool)

    @jax.jit
    def reference(p, st, x, y, w):
        def loss_fn(p):
            logits, _ = j_forward_train(module, p, st, x, w=w)
            return j_cross_entropy(logits, y, mask=w)

        loss, grads = jax.value_and_grad(loss_fn)(p)
        tx = j_setup_opt("SGD", LR, WD)
        updates, _ = tx.update(grads, tx.init(p), p)
        return dict(train=j_forward_train(module, p, st, x),
                    train_masked=j_forward_train(module, p, st, x, w=w),
                    eval=j_forward_eval(module, p, st, x),
                    features=j_features_eval(module, p, st, x),
                    loss=loss, stepped=optax.apply_updates(p, updates))

    want = jax.tree_util.tree_map(np.asarray, reference(params, stats, x, y, mask))
    return module, params, stats, x, y, mask, want


def test_interop_matches_jax_tree_and_round_trips(ref):
    module, params, stats, *_ = ref
    shapes = jax.eval_shape(lambda k: init_model(module, k, "synthetic"), jax.random.PRNGKey(0))
    for ours, theirs in zip((params, stats), shapes):
        assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(theirs)
        assert [a.shape for a in _leaves(ours)] == [a.shape for a in _leaves(theirs)]
    model = port_model(params, stats)
    sd = model.state_dict()
    for k, v in interop.from_jax(*interop.to_jax(sd)).items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("masked", [False, True])
def test_forward_train_and_bn_stats(ref, masked):
    module, params, stats, x, y, mask, want = ref
    want_logits, want_stats = want["train_masked" if masked else "train"]
    model = port_model(params, stats)
    with torch.no_grad():
        got = forward_train(model, torch.from_numpy(x),
                            torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(got.numpy(), want_logits, **TOL)
    _, got_stats = interop.to_jax(model.state_dict())
    for a, b in zip(_leaves(got_stats), _leaves(want_stats)):
        np.testing.assert_allclose(a, b, **STATS_TOL)
    if masked:  # masked rows must not move the statistics
        x2 = x.copy()
        x2[~mask] = 5.0
        model2 = port_model(params, stats)
        with torch.no_grad():
            forward_train(model2, torch.from_numpy(x2), torch.from_numpy(mask))
        for a, b in zip(model.buffers(), model2.buffers()):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_forward_eval_and_features(ref):
    module, params, stats, x, y, mask, want = ref
    model = port_model(params, stats)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    np.testing.assert_allclose(forward_eval(model, torch.from_numpy(x)).numpy(),
                               want["eval"], **TOL)
    feats = features_eval(model, torch.from_numpy(x))
    assert feats.shape == (x.shape[0], NF * 8)
    np.testing.assert_allclose(feats.numpy(), want["features"], **TOL)
    for k, v in model.state_dict().items():  # eval mode mutates nothing
        assert torch.equal(v, before[k]), k


def test_masked_ce_sgd_step(ref):
    module, params, stats, x, y, mask, want = ref
    model = port_model(params, stats)
    opt = setup_opt("SGD", model.parameters(), LR, WD)
    opt.zero_grad()
    loss = cross_entropy(forward_train(model, torch.from_numpy(x), torch.from_numpy(mask)),
                         torch.from_numpy(y), torch.from_numpy(mask))
    loss.backward()
    opt.step()
    np.testing.assert_allclose(loss.item(), float(want["loss"]), rtol=1e-5)
    got, _ = interop.to_jax(model.state_dict())
    for a, b in zip(_leaves(got), _leaves(want["stepped"])):
        np.testing.assert_allclose(a, b, **TOL)


def test_all_masked_forward_folds_nothing(ref):
    """A train-mode forward whose `w` is all False stands for no batch, as
    ocl_tpu's lax.cond skips such a pass: the running statistics stay as
    they were, the logits are finite, and a masked loss over them has zero
    gradients. A partly masked forward still folds (and matches ocl_tpu in
    test_forward_train_and_bn_stats)."""
    module, params, stats, x, y, mask, want = ref
    model = port_model(params, stats)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    none = torch.zeros(x.shape[0], dtype=torch.bool)
    logits = forward_train(model, torch.from_numpy(x), none)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert torch.isfinite(logits).all()
    cross_entropy(logits, torch.from_numpy(y), none).backward()
    assert all(not p.grad.any() for p in model.parameters())
    forward_train(model, torch.from_numpy(x), torch.from_numpy(mask))
    assert not torch.equal(model.bn1.running_mean, before["bn1.running_mean"])


@pytest.mark.parametrize("head", ["mlp", "linear", "None"])
def test_supcon_resnet_matches_ocl_tpu(head):
    """SupConResNet's tree (the trunk under `encoder`, no encoder head, the
    head's Dense layers) maps both ways; its L2-normalised train-mode output
    (masked), BN statistics, eval output and encoder features equal
    ocl_tpu's on the same weights."""
    module = JSupConResNet(dim_in=NF * 8, head=head, nf=NF)
    params, stats = random_weights(5, model=SupConResNet(dim_in=NF * 8, head=head, nf=NF))
    shapes = jax.eval_shape(lambda k: init_model(module, k, "synthetic"), jax.random.PRNGKey(0))
    for ours, theirs in zip((params, stats), shapes):
        assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(theirs)
        assert [a.shape for a in _leaves(ours)] == [a.shape for a in _leaves(theirs)]
    g = np.random.RandomState(9)
    x = g.rand(12, 32, 32, 3).astype(np.float32)
    mask = np.array([1] * 8 + [0] * 4, bool)

    @jax.jit
    def reference(p, st, x, w):
        return dict(train=j_forward_train(module, p, st, x, w=w),
                    eval=j_forward_eval(module, p, st, x),
                    features=j_features_eval(module, p, st, x))

    want = jax.tree_util.tree_map(np.asarray, reference(params, stats, x, mask))
    model = SupConResNet(dim_in=NF * 8, head=head, nf=NF)
    model.load_state_dict(interop.from_jax(params, stats), strict=True)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    for k, v in interop.from_jax(*interop.to_jax(sd)).items():
        assert torch.equal(v, sd[k]), k
    np.testing.assert_allclose(forward_eval(model, torch.from_numpy(x)).numpy(), want["eval"],
                               **TOL)
    feats = features_eval(model, torch.from_numpy(x))
    assert feats.shape == (12, NF * 8)
    np.testing.assert_allclose(feats.numpy(), want["features"], **TOL)
    with torch.no_grad():
        out = forward_train(model, torch.from_numpy(x), torch.from_numpy(mask))
    assert out.shape == (12, NF * 8 if head == "None" else 128)
    np.testing.assert_allclose(out.norm(dim=1).numpy(), 1.0, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), want["train"][0], **TOL)
    for a, b in zip(_leaves(interop.to_jax(model.state_dict())[1]), _leaves(want["train"][1])):
        np.testing.assert_allclose(a, b, **STATS_TOL)
