"""CN-DPM at 84 px (Mini-ImageNet, 100 classes; `config/general_2_cndpm_mini.yml`)
against ocl_tpu on the same weights (through `interop`), inputs and draws,
at K 3 and 2 z samples: the dummy's and the born experts' VAE and
classifier NLLs (the encoder's 21 x 21 feature map, the classifier's three
levels at 84, 42 and 21 px), and one wake step with one born expert (the
routing between the expert and the STM, the STM push, the expert's SGD
step). The sizes' counterpart of tests/test_torch_cndpm.py, whose
tolerances and draws it takes: NLLs rtol 1e-4 / atol 1e-3, weights rtol
1e-3 / atol 1e-4, routing and STM exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ocl_tpu.models.ndpm as j_ndpm
import ocl_tpu.models.ndpm_vars as JV
import ocl_tpu_torch.models.ndpm_vars as V
from ocl_tpu.config import default_params as j_default_params
from ocl_tpu.registry import agents as j_agents
from ocl_tpu_torch import interop
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.models import ndpm
from ocl_tpu_torch.registry import agents
from test_torch_cndpm import NLL_TOL, TOL, balanced_log_counts, column_noise
from test_torch_run import torch_threads

K, S = 3, 2
CNDPM_HP = dict(data="mini_imagenet", agent="CNDPM", max_experts=K, stm_capacity=20, batch=10,
                classifier_chill=0.01, log_alpha=-300.0, verbose=False, optimizer="SGD",
                learning_rate=0.01)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """torch on one CPU thread: the same sums on every host, and no
    oversubscribed cores under pytest's workers."""
    with torch_threads(1):
        yield

@pytest.fixture(scope="module")
def cndpm_84():
    """2 z samples (both packages read VAE_Z_SAMPLES at trace / call time),
    ocl_tpu's agent and its jitted one-task function at 84 px."""
    orig = JV.VAE_Z_SAMPLES, V.VAE_Z_SAMPLES
    JV.VAE_Z_SAMPLES = V.VAE_Z_SAMPLES = S
    p = j_default_params(**CNDPM_HP)
    p.sleep_step_g, p.sleep_step_d = 3, 2
    agent = j_agents["CNDPM"](p)
    yield agent, jax.jit(agent._build_train_task_fn())
    JV.VAE_Z_SAMPLES, V.VAE_Z_SAMPLES = orig


@pytest.fixture
def xla_subnormals():
    """torch's CPU arithmetic with subnormals flushed to zero, as XLA's
    (tests/test_torch_cndpm.py)."""
    assert torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def port_cndpm(j_state, seed):
    p = default_params(**CNDPM_HP, device="cpu")
    p.sleep_step_g, p.sleep_step_d = 3, 2
    agent = agents["CNDPM"](p)
    state = agent.init_state(seed)
    state.model.load_state_dict(interop.ndpm_from_jax(np_tree(j_state.params)))
    return agent, state


@pytest.mark.parametrize("n", [1, 2])
def test_cndpm_nlls_at_84(cndpm_84, n):
    """The VAE and classifier NLLs of the dummy and n born experts (the
    encoder's 84 / 4 = 21-cell feature map, the classifier's three levels)."""
    j_agent, _ = cndpm_84
    j_state = j_agent.init_state(jax.random.PRNGKey(1))
    _, state = port_cndpm(j_state, 1)
    g = np.random.RandomState(2)
    x = g.rand(6, 84, 84, 3).astype(np.float32)
    y = g.randint(0, 100, 6)
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(lambda p, x, r: j_ndpm.vae_collect_nll(p, x, r, K))(
        j_state.params, x, rng))
    got = ndpm.vae_collect_nll(state.model, torch.from_numpy(x), column_noise(rng, 6, range(1 + n)),
                               n)
    np.testing.assert_allclose(got.numpy(), want[:, : 1 + n], **NLL_TOL)
    want = np.asarray(jax.jit(lambda p, x, y: j_ndpm.cls_collect_nll(p, x, y, K, 100, 0.01))(
        j_state.params, x, jnp.asarray(y, jnp.int32)))
    got = ndpm.cls_collect_nll(state.model, torch.from_numpy(x), torch.from_numpy(y), n, 0.01)
    np.testing.assert_allclose(got.numpy(), want[:, : 1 + n], **NLL_TOL)


def test_cndpm_wake_step_at_84(cndpm_84, xla_subnormals):
    """One wake step with one born expert: the routing splits the batch
    between the expert and the STM, the STM takes its share, the expert
    takes an SGD step at its scheduled rate; no sleep."""
    j_agent, fn = cndpm_84
    g = np.random.RandomState(20)
    x = g.rand(10, 84, 84, 3).astype(np.float32)
    y = g.randint(0, 100, 10)
    rng = jax.random.PRNGKey(21)
    state = j_agent.init_state(jax.random.PRNGKey(22))
    nll = jax.jit(lambda p, x, y, r: j_ndpm.collect_nll(p, x, y, r, j_agent.params))(
        state.params, x, jnp.asarray(y, jnp.int32), jax.random.split(rng)[1])
    ag = np_tree(state.agent)
    ag["log_counts"] = balanced_log_counts(nll, 1)
    ag["active"] = np.int32(1)
    ag["stm_count"] = np.int32(5)
    ag["stm_x"][:5] = g.rand(5, 84, 84, 3)
    ag["stm_y"][:5] = g.randint(0, 100, 5)
    ag["sched_t"] = np.array([3, 0, 0], np.int32)
    jstate = state.replace(agent=jax.tree_util.tree_map(jnp.asarray, ag), rng=rng)
    new, metrics = fn(jstate, jnp.asarray(x)[None], jnp.asarray(y, jnp.int32)[None])

    agent, tstate = port_cndpm(state, 22)
    eval_seed = tstate.agent["eval_seed"]
    tstate.agent, tstate.optimizer = interop.cndpm_state_from_jax(ag, np_tree(state.opt_state))
    tstate.agent["eval_seed"] = eval_seed
    r_nll = jax.random.split(rng)[1]
    loss = agent.step(tstate, None, torch.from_numpy(x), torch.from_numpy(y),
                      draws={"noise": column_noise(r_nll, 10, range(2)), "sleep": None})
    np.testing.assert_allclose(loss.item(), float(metrics["loss"][0]), **NLL_TOL)
    got, _ = interop.cndpm_state_to_jax(tstate.agent, tstate.optimizer)
    want = np_tree(new.agent)
    assert 5 < int(want["stm_count"]) < 15 and int(want["active"]) == 1
    for key in ("active", "stm_count", "sched_t"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    count = int(want["stm_count"])
    np.testing.assert_array_equal(got["stm_x"][:count], want["stm_x"][:count])
    np.testing.assert_array_equal(got["stm_y"][:count], want["stm_y"][:count])
    got_params = interop.ndpm_to_jax(tstate.model.state_dict())
    want_params = dict(jax.tree_util.tree_leaves_with_path(new.params))
    for path, a in jax.tree_util.tree_leaves_with_path(got_params):
        np.testing.assert_allclose(a, np.asarray(want_params[path]),
                                   err_msg=jax.tree_util.keystr(path), **TOL)
