"""ER with MIR retrieval and the ASER update (`--retrieve MIR --update ASER`)
on the port against ocl_tpu's `_build_train_task_fn()`, from the same
weights, BN statistics, buffer, batches and draws (rebuilt from ocl_tpu's
key splits).

The update makes it an ASER-mode step: the optimizer steps on one combined
[memory; batch] pass, while the batch pass still takes its gradients, which
MIR's virtual step reads (ocl_tpu/agents/er.py:97-107). The BN statistics
fold four times a step: batch, MIR's pre forward, memory, combined.

Params and BN statistics: rtol 1e-3 / atol 1e-4 (fp32 reduction order), at
lr 0.01 as test_torch_er_step.py explains. Buffer contents, labels, counts
and the counters: exact; the SV sums run in XLA's order of additions
(test_torch_aser.py::xla_summation_order), as ties in exact arithmetic are
ordered by rounding alone.

Over several steps at nf 4 the step is chaotic: a 1e-7 shift of every
weight changes ASER's replacements by the second or third step, and from
weights seed 21 ER + ASER and ER + MIR alone (one-step pins in
test_torch_er_step.py and test_torch_agents.py) depart from ocl_tpu by
1e-3 to 1e-2 within three steps. So the three-step case starts from data
(seed 31) on which the two packages' rounding keeps the same picks; the
one-step cases run from seed 21, as those files' do.
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

TOL = dict(rtol=1e-3, atol=1e-4)
HP = dict(agent="ER", data="synthetic", mem_size=MEM, eps_mem_batch=10, batch=10,
          learning_rate=0.01, nf=4, verbose=False, retrieve="MIR", subsample=20,
          update="ASER", aser_type="asvm", k=3, n_smp_cls=2.0)


def _t(a):
    return torch.tensor(np.asarray(a))


def mir_aser_draws(key, steps):
    """Each step's draws of ocl_tpu's two-pass step from its carried key: the
    three-way split (MIR takes r_ret), then the update's split into ASER's
    four (aser.py:44)."""
    out = []
    for _ in range(steps):
        rng, r_ret, _ = jax.random.split(key, 3)
        key, r_upd = jax.random.split(rng)
        r_thr, r_eval, r_cand, _ = jax.random.split(r_upd, 4)
        out.append({"retrieve": [{"g": _t(jax.random.gumbel(r_ret, (MEM,)))}],
                    "update": {"thr": _t(jax.random.uniform(r_thr, ())),
                               "eval": _t(jax.random.gumbel(r_eval, (N_CLS, MEM))),
                               "cand": _t(jax.random.gumbel(r_cand, (MEM,)))}})
    return out


@pytest.fixture(scope="module")
def jax_task():
    agent = JExperienceReplay(j_default_params(**HP))
    return jax.jit(agent._build_train_task_fn()), agent


@pytest.mark.parametrize("steps,fill,n_seen,seed", [
    (1, MEM, 100, 21),   # a full buffer: the SV replacement runs
    (1, 35, 35, 21),     # fill, then the SV replacement of the overflow
    (3, MEM, 100, 31),
])
def test_mir_aser_steps_match_ocl_tpu(jax_task, monkeypatch, steps, fill, n_seen, seed):
    xla_summation_order(monkeypatch)
    fn, j_agent = jax_task
    params, stats = random_weights(seed)
    xs, ys = (np.stack(t) for t in zip(*(batch(seed + 9 + i) for i in range(steps))))
    jbuf, tbuf = make_buffers(MEM, fill, n_seen, seed=23)
    key = jax.random.PRNGKey(24)

    j_params, j_stats = (jax.tree_util.tree_map(jnp.asarray, t) for t in (params, stats))
    state = JTrainState(params=j_params, batch_stats=j_stats, opt_state=j_agent.tx.init(j_params),
                        buffer=jbuf, agent=None, rng=key)
    state, _ = fn(state, j_agent.before_train(ys), jnp.asarray(xs), jnp.asarray(ys, jnp.int32))

    agent = ExperienceReplay(default_params(**HP, device="cpu"))
    assert agent.aser_mode and agent.mir and not agent.fused
    model = port_model(params, stats)
    tstate = TrainState(model=model, optimizer=setup_opt("SGD", model.parameters(),
                                                         HP["learning_rate"]),
                        buffer=tbuf, generator=torch.Generator())
    ctx = agent.before_train(ys)
    for x, y, d in zip(xs, ys, mir_aser_draws(key, steps)):
        agent.step(tstate, ctx, torch.from_numpy(x), torch.from_numpy(y), draws=d)

    got = interop.to_jax(model.state_dict())
    want = jax.tree_util.tree_map(np.asarray, (state.params, state.batch_stats))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, **TOL)
    assert_buffers_equal(state.buffer, tbuf)
