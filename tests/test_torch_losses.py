"""The port's losses and Adam against ocl_tpu's on the same inputs.

Each loss of ocl_tpu_torch.ops.losses against ocl_tpu.ops.losses, with and
without a row mask: the value at rtol 1e-5 and its gradient with respect to
the logits (or features) at rtol 1e-4 / atol 1e-6 (fp32, another order of
reduction). Adam: one step from a fresh state and one from a carried-over
state (moments and step count through `interop`), with and without weight
decay, against `ocl_tpu.optim.setup_opt("Adam", ...)`: parameters and the
new moments at rtol 1e-5 / atol 1e-6. torch divides sqrt(v) by
sqrt(1 - b2^t) where optax takes the root of the corrected moment, which
moves a parameter by a few 1e-7, 1e-4 of an lr-0.01 update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocl_tpu.ops import losses as jl
from ocl_tpu.optim import setup_opt as j_setup_opt
from ocl_tpu_torch import interop
from ocl_tpu_torch.ops import losses as tl
from ocl_tpu_torch.optim import setup_opt
from test_torch_model import port_model, random_weights

B, C = 12, 10
G = np.random.RandomState(0)
LOGITS = G.normal(0, 2, (B, C)).astype(np.float32)
TEACHER = G.normal(0, 2, (B, C)).astype(np.float32)
LABELS = G.randint(0, C, B)
MASK = np.array([1] * 8 + [0] * 4, bool)
OLD = np.zeros(C, bool)
OLD[[0, 2, 4, 6, 8]] = True
CLASS_MASK = np.arange(C) < 7
FEATS = G.normal(0, 1, (B, 2, 16)).astype(np.float32)
FEATS /= np.linalg.norm(FEATS, axis=-1, keepdims=True)
TARGETS = np.eye(C, dtype=np.float32)[LABELS]
SUPPORT = CLASS_MASK | np.eye(C, dtype=bool)[LABELS].any(0)  # a softmax support holding every label

# name -> (ocl_tpu loss of (x, mask), port loss of (x, mask), x)
LOSSES = {
    "cross_entropy": (lambda x, m: jl.cross_entropy(x, jnp.asarray(LABELS), mask=m),
                      lambda x, m: tl.cross_entropy(x, torch.from_numpy(LABELS), mask=m), LOGITS),
    "cross_entropy_class_mask": (
        lambda x, m: jl.cross_entropy(x, jnp.asarray(LABELS), mask=m,
                                      class_mask=jnp.asarray(SUPPORT)),
        lambda x, m: tl.cross_entropy(x, torch.from_numpy(LABELS), mask=m,
                                      class_mask=torch.from_numpy(SUPPORT)),
        LOGITS),
    "labels_trick_ce": (lambda x, m: jl.labels_trick_ce(x, jnp.asarray(LABELS), mask=m),
                        lambda x, m: tl.labels_trick_ce(x, torch.from_numpy(LABELS), mask=m), LOGITS),
    "separated_softmax_ce": (
        lambda x, m: jl.separated_softmax_ce(x, jnp.asarray(LABELS), jnp.asarray(OLD),
                                             jnp.asarray(~OLD), mask=m),
        lambda x, m: tl.separated_softmax_ce(x, torch.from_numpy(LABELS), torch.from_numpy(OLD),
                                             torch.from_numpy(~OLD), mask=m),
        LOGITS),
    "kd_loss": (lambda x, m: jl.kd_loss(x, jnp.asarray(TEACHER), mask=m),
                lambda x, m: tl.kd_loss(x, torch.from_numpy(TEACHER), mask=m), LOGITS),
    "supcon_loss": (lambda x, m: jl.supcon_loss(x, jnp.asarray(LABELS), mask=m),
                    lambda x, m: tl.supcon_loss(x, torch.from_numpy(LABELS), mask=m), FEATS),
    "bce_ohe": (lambda x, m: jl.bce_ohe(x, jnp.asarray(TARGETS), class_mask=jnp.asarray(CLASS_MASK),
                                        mask=m),
                lambda x, m: tl.bce_ohe(x, torch.from_numpy(TARGETS),
                                        class_mask=torch.from_numpy(CLASS_MASK), mask=m), LOGITS),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_ocl_tpu(name, masked):
    j_fn, t_fn, x = LOSSES[name]
    j_mask = jnp.asarray(MASK) if masked else None
    want, want_grad = jax.value_and_grad(lambda v: j_fn(v, j_mask))(jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    got = t_fn(xt, torch.from_numpy(MASK) if masked else None)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-6)


def test_masked_loss_of_no_valid_row_is_zero():
    """ER's memory loss of a retrieval with no valid row is 0 with zero
    gradients (ocl_tpu/agents/er.py:67)."""
    x = torch.from_numpy(LOGITS.copy()).requires_grad_(True)
    none = torch.zeros(B, dtype=torch.bool)
    loss = tl.cross_entropy(x, torch.from_numpy(LABELS), mask=none) + \
        tl.labels_trick_ce(x, torch.from_numpy(LABELS), mask=none)
    loss.backward()
    assert loss.item() == 0.0 and not x.grad.any()


def _adam_state(tx_state, count, mu, nu):
    return tuple(optax.ScaleByAdamState(count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu)
                 if isinstance(s, optax.ScaleByAdamState) else s for s in tx_state)


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("wd", [0.0, 1e-2])
def test_adam_step_matches_ocl_tpu(wd, carried):
    lr = 0.01
    params, stats = random_weights(5)
    g = np.random.RandomState(6)
    grads = jax.tree_util.tree_map(lambda a: g.normal(0, 0.1, a.shape).astype(np.float32), params)
    tx = j_setup_opt("Adam", lr, wd)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(j_params)
    model = port_model(params, stats)
    opt = setup_opt("Adam", model.parameters(), lr, wd)
    if carried:
        mu = jax.tree_util.tree_map(lambda a: g.normal(0, 0.05, a.shape).astype(np.float32), params)
        nu = jax.tree_util.tree_map(lambda a: g.uniform(0, 0.01, a.shape).astype(np.float32), params)
        state = _adam_state(state, 7, mu, nu)
        interop.adam_from_jax(7, mu, nu, opt, model)
    updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, j_params)
    want = optax.apply_updates(j_params, updates)

    for name, t in interop.from_jax(grads, {}).items():
        model.get_parameter(name).grad = t
    opt.step()
    got, _ = interop.to_jax(model.state_dict())
    tol = dict(rtol=1e-5, atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), **tol)
    adam = [s for s in state if isinstance(s, optax.ScaleByAdamState)][0]
    moments = interop.adam_to_jax(opt, model)
    assert moments["count"] == int(adam.count)
    for key in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(moments[key]),
                        jax.tree_util.tree_leaves(getattr(adam, key))):
            np.testing.assert_allclose(a, np.asarray(b), **tol)
