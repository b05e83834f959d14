"""One ER step on the port against ocl_tpu's two-pass step
(ocl_tpu/agents/er.py:96-137), from identical weights, BN statistics,
buffer, batch and random draws: ASER update + ASER retrieval (aser_mode),
and random update + random retrieval. The JAX side is
`ExperienceReplay._build_train_task_fn()` over one batch, jitted once per
configuration.

Params and BN statistics after the step: rtol 1e-3 / atol 1e-4 (fp32
reduction order). Buffer contents, labels and class_counts: exact.

At nf=4 a few of the ~50k ReLU inputs of a layer sit within fp32 rounding
of zero; XLA and torch may put them on opposite sides, which moves an
early-layer gradient entry by up to ~1e-2. The step therefore runs at lr 0.01,
where that stays under atol while a missing or extra gradient term (about
lr * |g| >= 1e-3) does not, on a batch whose step keeps clear of such flips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocl_tpu.agents.base import TrainState as JTrainState
from ocl_tpu.agents.er import ExperienceReplay as JExperienceReplay
from ocl_tpu.config import default_params as j_default_params
from ocl_tpu_torch import interop
from ocl_tpu_torch.agents.base import TrainState
from ocl_tpu_torch.agents.er import ExperienceReplay
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.optim import setup_opt
from test_torch_aser import xla_summation_order
from test_torch_buffer import MEM, N_CLS, assert_buffers_equal, batch, make_buffers
from test_torch_model import port_model, random_weights

NF = 4
TOL = dict(rtol=1e-3, atol=1e-4)
CONFIGS = {
    "aser": dict(update="ASER", retrieve="ASER", aser_type="asvm", k=3, n_smp_cls=2.0),
    "random": dict(update="random", retrieve="random", fused_replay=False),
}
HP = dict(agent="ER", data="synthetic", mem_size=MEM, eps_mem_batch=10, batch=10,
          learning_rate=0.01, nf=NF, verbose=False)


def _t(a):
    return torch.tensor(np.asarray(a))


def port_draws(name, key):
    """The draws ocl_tpu's step takes from `key` (er.py:97, er.py:133, then
    aser.py:130 / aser.py:44 or retrieve.py / reservoir.py)."""
    rng, r_ret, _ = jax.random.split(key, 3)
    _, r_upd = jax.random.split(rng)
    if name == "aser":
        r_rand, r_cand, r_coop = jax.random.split(r_ret, 3)
        r_thr, r_eval, r_ucand, _ = jax.random.split(r_upd, 4)
        ret = {"rand": _t(jax.random.gumbel(r_rand, (MEM,))),
               "cand": _t(jax.random.gumbel(r_cand, (N_CLS, MEM))),
               "coop": _t(jax.random.gumbel(r_coop, (N_CLS, MEM)))}
        upd = {"thr": _t(jax.random.uniform(r_thr, ())),
               "eval": _t(jax.random.gumbel(r_eval, (N_CLS, MEM))),
               "cand": _t(jax.random.gumbel(r_ucand, (MEM,)))}
    else:
        ret = {"g": _t(jax.random.gumbel(r_ret, (MEM,)))}
        upd = {"u": _t(jax.random.uniform(r_upd, (10,)))}
    return {"retrieve": [ret], "update": upd}


@pytest.fixture(scope="module")
def jax_steps():
    """name -> (jitted one-task fn, agent), built once per module."""
    out = {}
    for name, cfg in CONFIGS.items():
        agent = JExperienceReplay(j_default_params(**HP, **cfg))
        out[name] = (jax.jit(agent._build_train_task_fn()), agent)
    return out


@pytest.mark.parametrize("name,fill,n_seen", [
    ("aser", MEM, 100),    # SV retrieval, SV replacement
    ("aser", 35, 35),      # random retrieval, fill then SV replacement
    ("random", MEM, 100),  # reservoir over a full buffer
    ("random", 35, 35),    # fill then reservoir
])
def test_er_step_matches_ocl_tpu(jax_steps, monkeypatch, name, fill, n_seen):
    xla_summation_order(monkeypatch)
    fn, j_agent = jax_steps[name]
    params, stats = random_weights(21)
    x, y = batch(30)
    jbuf, tbuf = make_buffers(MEM, fill, n_seen, seed=23)
    key = jax.random.PRNGKey(24)

    j_params, j_stats = (jax.tree_util.tree_map(jnp.asarray, t) for t in (params, stats))
    ctx = j_agent.before_train(y)
    state = JTrainState(params=j_params, batch_stats=j_stats,
                        opt_state=j_agent.tx.init(j_params), buffer=jbuf, agent=None, rng=key)
    state, _ = fn(state, ctx, jnp.asarray(x)[None], jnp.asarray(y, jnp.int32)[None])

    agent = ExperienceReplay(default_params(**HP, **CONFIGS[name], device="cpu"))
    model = port_model(params, stats)
    tstate = TrainState(model=model, optimizer=setup_opt("SGD", model.parameters(), HP["learning_rate"]),
                        buffer=tbuf, generator=torch.Generator())
    agent.step(tstate, agent.before_train(y), torch.from_numpy(x), torch.from_numpy(y),
               draws=port_draws(name, key))

    got_params, got_stats = interop.to_jax(model.state_dict())
    want = jax.tree_util.tree_map(np.asarray, (state.params, state.batch_stats))
    for a, b in zip(jax.tree_util.tree_leaves((got_params, got_stats)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, **TOL)
    assert_buffers_equal(state.buffer, tbuf)
