"""--compute_dtype bf16: the port's autocast policy against ocl_tpu's
`_policy_in` / `_policy_out` (ocl_tpu/models/__init__.py:57-73), at nf 4.

* Op level: the same weights (interop.from_jax) and inputs through ocl_tpu's
  bf16 model and the port's, for Reduced ResNet-18 (train-mode logits, the
  BN statistics that forward folds, the gradients of the masked CE, eval
  logits and features) and SupConResNet (embeddings, BN statistics, the
  gradients of a fixed projection of the embeddings).
* Step level: one fused-ER step and one ER + ASER SV step, from the same
  weights, buffer, batch and draws (rebuilt from ocl_tpu's key splits).
* Dtypes: inside, a convolution's output is bf16; after a step every
  parameter, gradient, BN buffer and optimizer state is fp32, and logits
  and features come out fp32; K1 (pairwise_sqdist) gets fp32 features.
* Run level: tests/test_torch_bf16_run.py.

The criterion of the op and step levels: for each quantity, the largest
absolute gap between the two packages' bf16 results is at most ocl_tpu's
own largest gap between its bf16 and fp32 results on the same inputs (the
size of bf16's rounding there). Each test prints both gaps.

ocl_tpu's side is jitted with XLA's excess precision off
(`per_op_rounding`), so that each op rounds to its output's dtype, as the
port's autocast does. With it on (XLA's default) fused elementwise chains
stay in fp32 between the casts, which moves a bf16 result by about as much
as bf16's rounding itself: the packages' gaps were then 0.86-1.75x ocl_tpu's
own bf16-versus-fp32 gap at op level over 4 seeds and 0.91-1.40x on a
fused-ER step over 8; with it off, 0.11-0.87x at op level and 0.31-0.61x
(fused ER) and 0.28-0.68x (ER + ASER) on steps, over 6 seeds each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocl_tpu.agents.base import TrainState as JTrainState
from ocl_tpu.config import default_params as j_default_params
from ocl_tpu.models import features_eval as j_features_eval
from ocl_tpu.models import forward_eval as j_forward_eval
from ocl_tpu.models import forward_train as j_forward_train
from ocl_tpu.models.resnet import Reduced_ResNet18 as JReducedResNet18
from ocl_tpu.models.resnet import SupConResNet as JSupConResNet
from ocl_tpu.ops.losses import cross_entropy as j_cross_entropy
from ocl_tpu.registry import agents as j_agents
from ocl_tpu_torch import interop
from ocl_tpu_torch.agents.base import TrainState
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.models import features_eval, forward_eval, forward_train
from ocl_tpu_torch.models.resnet import Reduced_ResNet18, SupConResNet
from ocl_tpu_torch.ops import knn_sv
from ocl_tpu_torch.ops.losses import cross_entropy
from ocl_tpu_torch.optim import setup_opt
from ocl_tpu_torch.registry import agents
from test_torch_agents import port_draws as fused_draws
from test_torch_aser import xla_summation_order
from test_torch_buffer import MEM, batch, make_buffers
from test_torch_er_step import CONFIGS as ER_STEP_CONFIGS
from test_torch_er_step import port_draws as er_step_draws
from test_torch_model import random_weights

NF = 4
PRECISIONS = ("fp32", "bf16")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def gap(a, b) -> float:
    """Largest absolute difference over every leaf of two pytrees."""
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(la) == len(lb)
    return max(float(np.max(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))))
               for x, y in zip(la, lb))


def assert_within_bf16(label, port_bf16, jax_bf16, jax_fp32):
    between, rounding = gap(port_bf16, jax_bf16), gap(jax_bf16, jax_fp32)
    print("{}: port vs ocl_tpu in bf16 {:.3e}; ocl_tpu bf16 vs fp32 {:.3e}".format(
        label, between, rounding))
    assert between <= rounding, (label, between, rounding)


def per_op_rounding(fn, *args):
    """`fn(*args)` jitted with XLA's excess precision off, so that every op
    rounds to its output's dtype, as the port's autocast does."""
    return jax.jit(fn).lower(*args).compile({"xla_allow_excess_precision": False})(*args)


def port_model(cls, params, stats, **kw):
    model = cls(**kw)
    model.load_state_dict(interop.from_jax(params, stats), strict=True)
    return model


# ------------------------------------------------------------------ op level


def test_reduced_resnet18_matches_ocl_tpu_in_bf16():
    params, stats = random_weights(3)
    g = np.random.RandomState(8)
    x = g.rand(12, 32, 32, 3).astype(np.float32)
    y = g.randint(0, 10, 12)
    mask = np.array([1] * 9 + [0] * 3, bool)

    want = {}
    for cdt in PRECISIONS:
        module = JReducedResNet18(10, nf=NF, compute_dtype=cdt)

        def reference(p, module=module):
            def loss_fn(p):
                logits, _ = j_forward_train(module, p, stats, x, w=mask)
                return j_cross_entropy(logits, y, mask=mask)

            logits, new_stats = j_forward_train(module, p, stats, x, w=mask)
            return dict(logits=logits, stats=new_stats, grads=jax.grad(loss_fn)(p),
                        eval=j_forward_eval(module, p, stats, x),
                        features=j_features_eval(module, p, stats, x))

        want[cdt] = _np(per_op_rounding(reference, params))

    model = port_model(Reduced_ResNet18, params, stats, nclasses=10, nf=NF, compute_dtype="bf16")
    eval_logits = forward_eval(model, torch.from_numpy(x))
    feats = features_eval(model, torch.from_numpy(x))
    logits = forward_train(model, torch.from_numpy(x), torch.from_numpy(mask))
    cross_entropy(logits, torch.from_numpy(y), mask=torch.from_numpy(mask)).backward()
    got_grads = interop.to_jax({n: p.grad for n, p in model.named_parameters()})[0]
    got = dict(logits=logits.detach().numpy(), stats=interop.to_jax(model.state_dict())[1],
               grads=got_grads, eval=eval_logits.numpy(), features=feats.numpy())
    for key in got:
        assert_within_bf16("reduced resnet-18 " + key, got[key], want["bf16"][key],
                           want["fp32"][key])


def test_supcon_resnet_matches_ocl_tpu_in_bf16():
    model = SupConResNet(dim_in=NF * 8, head="mlp", nf=NF)
    params, stats = random_weights(5, model=model)
    g = np.random.RandomState(9)
    x = g.rand(12, 32, 32, 3).astype(np.float32)
    proj = g.randn(12, 128).astype(np.float32)

    want = {}
    for cdt in PRECISIONS:
        module = JSupConResNet(dim_in=NF * 8, head="mlp", nf=NF, compute_dtype=cdt)

        def reference(p, module=module):
            def loss_fn(p):
                emb, _ = j_forward_train(module, p, stats, x)
                return jnp.sum(emb * proj)

            emb, new_stats = j_forward_train(module, p, stats, x)
            return dict(emb=emb, stats=new_stats, grads=jax.grad(loss_fn)(p))

        want[cdt] = _np(per_op_rounding(reference, params))

    model = port_model(SupConResNet, params, stats, dim_in=NF * 8, head="mlp", nf=NF,
                       compute_dtype="bf16")
    emb = forward_train(model, torch.from_numpy(x))
    (emb * torch.from_numpy(proj)).sum().backward()
    got = dict(emb=emb.detach().numpy(), stats=interop.to_jax(model.state_dict())[1],
               grads=interop.to_jax({n: p.grad for n, p in model.named_parameters()})[0])
    for key in got:
        assert_within_bf16("supcon " + key, got[key], want["bf16"][key], want["fp32"][key])


# ------------------------------------------------------------------- dtypes


@pytest.mark.parametrize("optimizer", ["SGD", "Adam"])
def test_bf16_step_keeps_master_state_fp32(optimizer):
    params = default_params(data="synthetic", agent="ER", nf=NF, mem_size=50, batch=10,
                            optimizer=optimizer, compute_dtype="bf16", verbose=False,
                            device="cpu")
    agent = agents["ER"](params)
    state = agent.init_state(0)
    conv_dtypes = []
    state.model.conv1.register_forward_hook(lambda m, i, out: conv_dtypes.append(out.dtype))
    x, y = batch(31, n=60)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    agent.train_task(state, agent.before_train(y), x, y)
    assert conv_dtypes and set(conv_dtypes) == {torch.bfloat16}
    for name, p in state.model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
    for name, b in state.model.named_buffers():
        assert b.dtype == torch.float32, name
    states = [t for s in state.optimizer.state.values() for t in s.values()
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    assert (optimizer == "SGD" and not states) or states
    assert all(t.dtype == torch.float32 for t in states)
    assert forward_eval(state.model, x[:4]).dtype == torch.float32
    assert features_eval(state.model, x[:4]).dtype == torch.float32
    assert forward_train(state.model, x[:4]).dtype == torch.float32


# --------------------------------------------------------------- step level

STEP_HP = dict(agent="ER", data="synthetic", mem_size=MEM, eps_mem_batch=10, batch=10,
               learning_rate=0.01, nf=NF, verbose=False)
STEPS = {"fused": dict(), "aser": ER_STEP_CONFIGS["aser"]}


def jax_step(name, cdt, params, stats, jbuf, x, y, key):
    """(params, batch_stats) after one ocl_tpu step of config `name` in `cdt`."""
    agent = j_agents["ER"](j_default_params(**STEP_HP, **STEPS[name], compute_dtype=cdt))
    p, st = (jax.tree_util.tree_map(jnp.asarray, t) for t in (params, stats))
    state = JTrainState(params=p, batch_stats=st, opt_state=agent.tx.init(p), buffer=jbuf,
                        agent=None, rng=key)
    state, _ = per_op_rounding(agent._build_train_task_fn(), state, agent.before_train(y),
                               jnp.asarray(x)[None], jnp.asarray(y, jnp.int32)[None])
    return _np((state.params, state.batch_stats))


@pytest.mark.parametrize("name", list(STEPS))
def test_er_step_matches_ocl_tpu_in_bf16(monkeypatch, name):
    xla_summation_order(monkeypatch)
    seen = []

    def recording(a, b, plain=knn_sv.pairwise_sqdist):
        seen.append((a.dtype, b.dtype))
        return plain(a, b)

    monkeypatch.setattr(knn_sv, "pairwise_sqdist", recording)
    params, stats = random_weights(21)
    x, y = batch(30)
    key = jax.random.PRNGKey(24)
    want = {}
    for cdt in PRECISIONS:
        jbuf, _ = make_buffers(MEM, MEM, 100, seed=23)
        want[cdt] = jax_step(name, cdt, params, stats, jbuf, x, y, key)

    _, tbuf = make_buffers(MEM, MEM, 100, seed=23)
    agent = agents["ER"](default_params(**STEP_HP, **STEPS[name], compute_dtype="bf16",
                                        device="cpu"))
    model = port_model(Reduced_ResNet18, params, stats, nclasses=10, nf=NF, compute_dtype="bf16")
    state = TrainState(model=model, optimizer=setup_opt("SGD", model.parameters(), 0.01),
                       buffer=tbuf, generator=torch.Generator())
    draws = er_step_draws("aser", key) if name == "aser" else fused_draws(agent, key)
    agent.step(state, agent.before_train(y), torch.from_numpy(x), torch.from_numpy(y), draws)
    got = interop.to_jax(model.state_dict())
    assert_within_bf16("{} step params".format(name), got[0], want["bf16"][0], want["fp32"][0])
    assert_within_bf16("{} step BN statistics".format(name), got[1], want["bf16"][1],
                       want["fp32"][1])
    if name == "aser":
        assert seen and set(seen) == {(torch.float32, torch.float32)}, seen
    else:
        assert not seen
