"""CN-DPM in the port against ocl_tpu on the CPU, at K 3 and 2 z samples.

ocl_tpu computes all K slots; the port computes only the born ones
(`active` = n < K), so every comparison here runs the port at n = 1 or 2 and
also checks that ocl_tpu's unborn columns and slots take no part. Both
packages get the same weights (through `interop`), inputs (np.random) and
draws, rebuilt from ocl_tpu's key splits: one key a column in
`vae_collect_nll` (ndpm.py:250-256), the wake step's split (cndpm.py:260)
and each sleep step's r_b / r_z (cndpm.py:213-218).

XLA's CPU backend flushes subnormal floats to zero and torch's does not, so
a routing posterior below 1.2e-38 (a sample routed to the STM by a wide
margin) is 0 in ocl_tpu and counts as usage in the port, as in the torch
reference: that expert's scheduler steps. The step-level tests run the port
with subnormals flushed (`xla_subnormals`), as XLA does.

Tolerances: NLLs, which run in the thousands, rtol 1e-4 / atol 1e-3;
log-softmax, gradients and updated weights rtol 1e-3 / atol 1e-4; routing,
STM contents and counts, `active` and `sched_t` exact.
"""

import warnings

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
from ocl_tpu_torch.agents.cndpm import multistep_lr
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.data import prepare_test_loaders
from ocl_tpu_torch.models import ndpm
from ocl_tpu_torch.registry import agents

K, S, Z, B, N_CLS, CHILL = 3, 2, V.VAE_Z_DIM, 6, 10, 0.01
NLL_TOL = dict(rtol=1e-4, atol=1e-3)
TOL = dict(rtol=1e-3, atol=1e-4)
HP = dict(data="synthetic", agent="CNDPM", max_experts=K, stm_capacity=20, batch=10,
          classifier_chill=CHILL, log_alpha=-300.0, verbose=False)
SLEEP = (3, 2)


@pytest.fixture(scope="module", autouse=True)
def small_z_samples():
    """Both packages read VAE_Z_SAMPLES at trace / call time."""
    orig = JV.VAE_Z_SAMPLES, V.VAE_Z_SAMPLES
    JV.VAE_Z_SAMPLES = V.VAE_Z_SAMPLES = S
    yield
    JV.VAE_Z_SAMPLES, V.VAE_Z_SAMPLES = orig


@pytest.fixture
def xla_subnormals():
    """torch's CPU arithmetic with subnormals flushed to zero, as XLA's."""
    assert torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)   # writable copies


def _t(a):
    return torch.tensor(np.asarray(a))


def j_params(seed=0):
    return j_ndpm.init_ndpm_params(jax.random.PRNGKey(seed), j_default_params(**HP))


def port_model(params):
    model = ndpm.NDPM(default_params(**HP, device="cpu"), torch.Generator().manual_seed(0))
    model.load_state_dict(interop.ndpm_from_jax(_np(params)))
    return model


def inputs(seed, batch=B):
    g = np.random.RandomState(seed)
    return g.rand(batch, 32, 32, 3).astype(np.float32), g.randint(0, N_CLS, batch)


def column_noise(rng, batch, cols):
    """The draws of vae_collect_nll(rng): one key a column, dummy first."""
    keys = jax.random.split(rng, K + 1)
    return [_t(jax.random.normal(keys[c], (batch, S, Z))) for c in cols]


@pytest.fixture(scope="module")
def jax_ops():
    ns = j_default_params(**HP)
    return {
        "vae": jax.jit(lambda p, x, r: j_ndpm.vae_collect_nll(p, x, r, K)),
        "cls_forward": jax.jit(lambda p, x: j_ndpm.cls_collect_forward(p, x, K, N_CLS)),
        "cls_nll": jax.jit(lambda p, x, y: j_ndpm.cls_collect_nll(p, x, y, K, N_CLS, CHILL)),
        "collect": jax.jit(lambda p, x, y, r: j_ndpm.collect_nll(p, x, y, r, ns)),
        "predict": jax.jit(lambda p, x, r, lc, a: j_ndpm.ndpm_predict(p, x, r, lc, a, ns)),
    }


# ------------------------------------------------------------------ op level

@pytest.mark.parametrize("n", [1, 2])
def test_vae_collect_nll(jax_ops, n):
    params, (x, _) = j_params(1), inputs(2)
    rng = jax.random.PRNGKey(3)
    want = np.asarray(jax_ops["vae"](params, x, rng))
    got = ndpm.vae_collect_nll(port_model(params), torch.from_numpy(x),
                               column_noise(rng, B, range(1 + n)), n)
    assert got.shape == (B, 1 + n)
    np.testing.assert_allclose(got.numpy(), want[:, : 1 + n], **NLL_TOL)


@pytest.mark.parametrize("n", [1, 2])
def test_cls_collect_forward_and_nll(jax_ops, n):
    params, (x, y) = j_params(4), inputs(5)
    model = port_model(params)
    want = np.asarray(jax_ops["cls_forward"](params, x))
    got = ndpm.cls_collect_forward(model, torch.from_numpy(x), n)
    np.testing.assert_allclose(got.numpy(), want[:, : 1 + n], **TOL)
    want = np.asarray(jax_ops["cls_nll"](params, x, jnp.asarray(y, jnp.int32)))
    got = ndpm.cls_collect_nll(model, torch.from_numpy(x), torch.from_numpy(y), n, CHILL)
    np.testing.assert_allclose(got.numpy(), want[:, : 1 + n], **NLL_TOL)


@pytest.mark.parametrize("n", [1, 2])
def test_collect_nll(jax_ops, n):
    params, (x, y) = j_params(6), inputs(7)
    rng = jax.random.PRNGKey(8)
    want = np.asarray(jax_ops["collect"](params, x, jnp.asarray(y, jnp.int32), rng))
    got = ndpm.collect_nll(port_model(params), torch.from_numpy(x), torch.from_numpy(y),
                           column_noise(rng, B, range(1 + n)), n, CHILL)
    np.testing.assert_allclose(got.numpy(), want[:, : 1 + n], **NLL_TOL)


@pytest.mark.parametrize("n", [1, 2])
def test_ndpm_predict(jax_ops, n):
    """ocl_tpu masks slots >= active out of the log joint; their log counts
    here are finite, so a port that read them would disagree."""
    params, (x, _) = j_params(9), inputs(10)
    rng = jax.random.PRNGKey(11)
    lc = np.array([-300.0, 2.0, 3.5, 1.0], np.float32)
    want = np.asarray(jax_ops["predict"](params, x, rng, lc, n))
    got = ndpm.ndpm_predict(port_model(params), torch.from_numpy(x),
                            column_noise(rng, B, range(1, 1 + n)), torch.from_numpy(lc), n)
    np.testing.assert_allclose(got.numpy(), want, **NLL_TOL)
    np.testing.assert_array_equal(got.argmax(1).numpy(), want.argmax(1))


def test_decoder_matches_conv_transpose():
    """The decoder alone: lax.conv_transpose does not flip its kernel and
    torch's does, so interop stores the kernel flipped; dec3's columns are
    reordered to (C, h, w)."""
    params = j_params(12)
    model = port_model(params)
    z = np.random.RandomState(13).normal(size=(5, Z)).astype(np.float32)
    for s in range(K):
        want = np.asarray(j_ndpm._vae_decode(j_ndpm._slot(params["vae"], s), z, (32, 32)))
        got = ndpm._vae_decode(ndpm.slots_of(model, "vae", K)[s], torch.from_numpy(z), (32, 32))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


@pytest.mark.parametrize("slot,size", [(0, 32), (1, 32), (1, 15)])
def test_stride2_classifier_level(slot, size):
    """Level 2 (3x3 stride 2, 1x1 stride-2 downsample): XLA's "SAME" pads
    an even input (0, 1), an odd one (1, 1). ocl_tpu reads a padded buffer
    whose unwritten channels are zero; the port reads the real ones."""
    params = j_params(14)
    p_j = j_ndpm._slot(params["cls"], slot)
    cin, width_out = ndpm.cls_cat(slot), 2 * ndpm.cls_w(slot)
    Cc = ndpm.cls_cat(K - 1)
    x = np.zeros((4, size, size, Cc), np.float32)
    x[..., :cin] = np.random.RandomState(15).normal(size=(4, size, size, cin))
    want = np.asarray(j_ndpm._cls_block(p_j, 2, x, width_out, 2, True))[..., :width_out]
    p_t = ndpm.slots_of(port_model(params), "cls", K)[slot]
    got = ndpm._cls_block(p_t, 2, torch.from_numpy(x[..., :cin]).permute(0, 3, 1, 2),
                          width_out, 2, True)
    assert got.shape == (4, width_out, -(-size // 2), -(-size // 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, **TOL)


def test_interop_round_trip():
    params = _np(j_params(16))
    back = interop.ndpm_to_jax(interop.ndpm_from_jax(params))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- step level

def balanced_log_counts(nll, n, to_stm=None):
    """[1 + K] log counts for which the routing splits: about half the
    samples to slot 1 against slot 2, about half to the STM (or all, with
    `to_stm="all"`), each decision clear of a tie by > 0.1."""
    nll = np.asarray(nll, np.float64)[:, : 1 + n]
    lc = np.zeros(n)

    def cut(v):
        v = np.sort(v)
        lo, hi = v[len(v) // 2 - 1], v[len(v) // 2]
        assert hi - lo > 0.1, (lo, hi)
        return (lo + hi) / 2

    if n == 2:
        lc[0] = cut(nll[:, 1] - nll[:, 2])
    d = nll[:, 0] - np.min(nll[:, 1:] - lc, axis=1)
    la = d.max() + 50.0 if to_stm == "all" else cut(d)
    return np.concatenate([[la], lc, np.full(K - n, -np.inf)]).astype(np.float32)


def j_wake_loss(params_ns):
    """ocl_tpu's wake loss (cndpm.py:158-170), for its gradients."""
    def loss(model_params, xb, yb, log_counts, rng):
        nll = j_ndpm.collect_nll(model_params, xb, yb, rng, params_ns)
        nl_joint = jax.lax.stop_gradient(nll) - log_counts[None, :]
        to_stm = jnp.argmin(nl_joint, axis=1) == 0
        to_expert = jnp.exp(-nl_joint + jnp.min(nl_joint, axis=1, keepdims=True))
        to_expert = to_expert.at[:, 0].set(0.0)
        to_expert = to_expert / (jnp.sum(to_expert, axis=1, keepdims=True) + 1e-7)
        nll_train = nll * (1.0 - to_stm.astype(jnp.float32))[:, None]
        return jnp.sum(jnp.sum(nll_train * to_expert, axis=0)), (to_stm, jnp.sum(to_expert, 0))
    return loss


@pytest.fixture(scope="module")
def jax_agents():
    """optimizer -> (ocl_tpu agent, its jitted one-task fn), built on first use."""
    cache = {}

    def get(opt):
        if opt not in cache:
            p = j_default_params(**HP, optimizer=opt, learning_rate=0.01)
            p.sleep_step_g, p.sleep_step_d = SLEEP
            agent = j_agents["CNDPM"](p)
            cache[opt] = agent, jax.jit(agent._build_train_task_fn())
        return cache[opt]

    return get


def port_agent(opt, **kw):
    p = default_params(**dict(HP, optimizer=opt, learning_rate=0.01, device="cpu", **kw))
    p.sleep_step_g, p.sleep_step_d = SLEEP
    return agents["CNDPM"](p)


def both_states(j_agent, n, opt, x, y, rng, stm_count, to_stm=None, seed=20):
    """An ocl_tpu state with n born experts, a partly filled STM and (under
    Adam) earlier optimizer steps, and the port's state made from it. The
    STM rows, the Adam moments and the log counts (`balanced_log_counts`)
    are the test's own."""
    g = np.random.RandomState(seed)
    state = j_agent.init_state(jax.random.PRNGKey(seed))
    r_nll = jax.random.split(rng)[1]
    nll = j_ndpm.collect_nll(state.params, x, jnp.asarray(y, jnp.int32), r_nll, j_agent.params)
    ag = _np(state.agent)
    ag["log_counts"] = balanced_log_counts(nll, n, to_stm)
    ag["active"] = np.int32(n)
    ag["stm_count"] = np.int32(stm_count)
    ag["stm_x"][:stm_count] = g.rand(stm_count, 32, 32, 3)
    ag["stm_y"][:stm_count] = g.randint(0, N_CLS, stm_count)
    ag["sched_t"] = np.array([3, 0, 0][:K], np.int32)
    opt_state = _np(state.opt_state)
    if opt == "Adam":
        for part in ("g", "d"):
            t = opt_state[part]
            t["t"] = np.array([4, 2, 0], np.int32)
            for name in t["m"]:
                shape = t["m"][name].shape
                t["m"][name] = np.zeros(shape, np.float32)
                t["v"][name] = np.zeros(shape, np.float32)
                t["m"][name][:n] = g.normal(0, 0.01, (n,) + shape[1:])
                # the newborn's v too: Adam's first steps from v = 0 move
                # each weight by about +-lr whatever the gradient's size, so
                # an entry that is zero but for rounding would step either
                # way in either package
                t["v"][name][:] = g.uniform(0.01, 0.1, shape)
    jstate = state.replace(agent=jax.tree_util.tree_map(jnp.asarray, ag),
                           opt_state=jax.tree_util.tree_map(jnp.asarray, opt_state), rng=rng)

    agent = port_agent(opt)
    tstate = agent.init_state(0)
    tstate.model.load_state_dict(interop.ndpm_from_jax(_np(state.params)))
    eval_seed = tstate.agent["eval_seed"]
    tstate.agent, tstate.optimizer = interop.cndpm_state_from_jax(ag, opt_state)
    tstate.agent["eval_seed"] = eval_seed
    return jstate, agent, tstate


def sleep_draws(rng, n, k):
    """The draws of ocl_tpu's sleep from the step's carried key: each step
    splits (rng, r_b, r_z); the VAE's noise is column 1 + k's of r_z."""
    out = {"g_idx": [], "g_noise": [], "d_idx": []}
    for key, steps in (("g", SLEEP[0]), ("d", SLEEP[1])):
        for _ in range(steps):
            rng, r_b, r_z = jax.random.split(rng, 3)
            out[key + "_idx"].append(_t(jax.random.randint(r_b, (V.SLEEP_BATCH_SIZE,), 0,
                                                           jnp.int32(n))).long())
            if key == "g":
                out["g_noise"].append(column_noise(r_z, V.SLEEP_BATCH_SIZE, [1 + k])[0])
    return {"g_idx": torch.stack(out["g_idx"]), "d_idx": torch.stack(out["d_idx"]),
            "g_noise": out["g_noise"]}


def step_both(jax_agents, opt, n, stm_count, to_stm=None, key=21):
    j_agent, fn = jax_agents(opt)
    x, y = inputs(22, 10)
    rng = jax.random.PRNGKey(key)
    jstate, agent, tstate = both_states(j_agent, n, opt, x, y, rng, stm_count, to_stm)
    new, metrics = fn(jstate, jnp.asarray(x)[None], jnp.asarray(y, jnp.int32)[None])
    carried, r_nll = jax.random.split(rng)
    draws = {"noise": column_noise(r_nll, 10, range(1 + n)),
             "sleep": sleep_draws(carried, stm_count + 10, n)}
    loss = agent.step(tstate, None, torch.from_numpy(x), torch.from_numpy(y), draws=draws)
    return new, metrics, tstate, loss


def assert_agent_states_match(new, tstate, opt):
    ag, opt_state = interop.cndpm_state_to_jax(tstate.agent, tstate.optimizer)
    want = _np(new.agent)
    for key in ("active", "stm_count", "saturated_sleeps", "sched_t"):
        np.testing.assert_array_equal(ag[key], want[key], err_msg=key)
    count = int(want["stm_count"])
    np.testing.assert_array_equal(ag["stm_x"][:count], want["stm_x"][:count])
    np.testing.assert_array_equal(ag["stm_y"][:count], want["stm_y"][:count])
    np.testing.assert_allclose(ag["log_counts"], want["log_counts"], **TOL)
    got_params = interop.ndpm_to_jax(tstate.model.state_dict())
    want_params = dict(jax.tree_util.tree_leaves_with_path(new.params))
    for path, a in jax.tree_util.tree_leaves_with_path(got_params):
        np.testing.assert_allclose(a, np.asarray(want_params[path]),
                                   err_msg=jax.tree_util.keystr(path), **TOL)
    if opt == "Adam":
        want_opt = _np(new.opt_state)
        for part in ("g", "d"):
            np.testing.assert_array_equal(opt_state[part]["t"], want_opt[part]["t"])
            for mv in ("m", "v"):
                for name, a in opt_state[part][mv].items():
                    np.testing.assert_allclose(a, want_opt[part][mv][name], err_msg=name, **TOL)


@pytest.mark.parametrize("n", [1, 2])
def test_wake_loss_gradient(jax_agents, xla_subnormals, n):
    """Loss, routing, usage and the gradient of every leaf of every born
    slot; ocl_tpu's gradient of the unborn slot is exactly zero."""
    j_agent, _ = jax_agents("SGD")
    x, y = inputs(23, 10)
    rng = jax.random.PRNGKey(24)
    jstate, agent, tstate = both_states(j_agent, n, "SGD", x, y, rng, 5)
    r_nll = jax.random.split(rng)[1]
    (j_loss, (j_stm, j_usage)), j_grads = jax.value_and_grad(j_wake_loss(j_agent.params),
                                                             has_aux=True)(
        jstate.params, x, jnp.asarray(y, jnp.int32), jstate.agent["log_counts"], r_nll)
    loss, to_stm, usage, leaves = agent.wake_loss(
        tstate, torch.from_numpy(x), torch.from_numpy(y), column_noise(r_nll, 10, range(1 + n)))
    assert 0 < int(j_stm.sum()) < 10
    np.testing.assert_array_equal(to_stm.numpy(), np.asarray(j_stm))
    np.testing.assert_allclose(usage.detach().numpy(), np.asarray(j_usage)[: 1 + n], **TOL)
    assert (np.asarray(j_usage)[1: 1 + n] > 0).all() and (np.asarray(j_usage)[1 + n:] == 0).all()
    np.testing.assert_allclose(loss.item(), float(j_loss), **NLL_TOL)
    for part in ("vae", "cls"):
        grads = torch.autograd.grad(loss, list(leaves[part].values()), retain_graph=True,
                                    materialize_grads=True)
        got = interop._ndpm_tree({k: g.numpy() for k, g in zip(leaves[part], grads)},
                                 interop._ndpm_leaf_to_jax)
        for name, g in got.items():
            want = np.asarray(j_grads[part][name])
            np.testing.assert_allclose(g, want[:n], err_msg=name, **TOL)
            assert not want[n:].any(), name


@pytest.mark.parametrize("opt", ["SGD", "Adam"])
def test_wake_step(jax_agents, xla_subnormals, opt):
    """One wake step at n 2: the STM push, the CRP usage update, the masked
    per-slot update at each slot's MultiStepLR rate, sched_t; no sleep."""
    new, metrics, tstate, loss = step_both(jax_agents, opt, 2, 5)
    assert 5 < int(new.agent["stm_count"]) < 15
    np.testing.assert_allclose(loss.item(), float(metrics["loss"][0]), **NLL_TOL)
    assert_agent_states_match(new, tstate, opt)


@pytest.mark.parametrize("opt", ["SGD", "Adam"])
def test_sleep(jax_agents, xla_subnormals, opt):
    """A wake step that fills the STM (every sample routed to it), then a
    3 / 2-step sleep of slot 2 over the lateral features of slots 0-1, with
    the sleep's weight decay, clip, the newborn's prior and sched_t."""
    new, _, tstate, _ = step_both(jax_agents, opt, 2, 15, to_stm="all")
    assert int(new.agent["active"]) == 3 and int(new.agent["stm_count"]) == 0
    assert int(new.agent["sched_t"][2]) == 2
    assert_agent_states_match(new, tstate, opt)


def test_saturated_sleep_warns(xla_subnormals):
    """K 1, every sample routed to the STM: the first fill births the one
    expert, the second finds no free slot, clears the STM and counts a
    saturated sleep, in both packages; the port warns."""
    hp = dict(HP, max_experts=1, log_alpha=1e4, optimizer="SGD", learning_rate=0.01)
    j_p = j_default_params(**hp)
    j_p.sleep_step_g = j_p.sleep_step_d = 1
    j_agent = j_agents["CNDPM"](j_p)
    jstate = j_agent.init_state(jax.random.PRNGKey(0))
    x, y = inputs(25, 40)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jstate = j_agent.train_learner(jstate, x, y)

    p = default_params(**hp, device="cpu")
    p.sleep_step_g = p.sleep_step_d = 1
    agent = agents["CNDPM"](p)
    tstate = agent.init_state(0)
    with pytest.warns(RuntimeWarning, match="max_experts=1 cap"):
        tstate = agent.train_learner(tstate, x, y)
    for key in ("active", "saturated_sleeps", "stm_count"):
        assert tstate.agent[key] == int(jstate.agent[key]) == {"active": 1, "saturated_sleeps": 1,
                                                                "stm_count": 0}[key], key


def test_multistep_lr_matches_torch():
    """multistep_lr == torch's MultiStepLR (reference component.py:53-55)
    for the reference's schedule and multi-milestone ones."""
    for milestones, gamma in [((1,), 0.2), ((1, 3), 0.5), ((2, 4, 6), 0.1)]:
        opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=0.1)
        sched = torch.optim.lr_scheduler.MultiStepLR(opt, milestones=list(milestones),
                                                     gamma=gamma)
        torch_lrs = []
        for _ in range(8):
            torch_lrs.append(opt.param_groups[0]["lr"])
            sched.step()
        got = multistep_lr(0.1, torch.arange(8), milestones=milestones, gamma=gamma)
        np.testing.assert_allclose(got.numpy(), torch_lrs, rtol=1e-6)


def test_evaluate_zeros_before_first_expert():
    agent = port_agent("SGD", test_batch=4)
    state = agent.init_state(0)
    x, y = inputs(26, 6)
    accs = agent.evaluate(state, prepare_test_loaders([(x, y), (x, y)], agent.params, "cpu"))
    np.testing.assert_array_equal(accs, [0.0, 0.0])


def test_evaluate_matches_ocl_tpu_predictions():
    """Accuracy after evaluate from the same state and evaluation noise
    (ocl_tpu's fold_in(rng, 99)), with a padded last test batch."""
    hp = dict(HP, test_batch=4, optimizer="SGD")
    j_agent = j_agents["CNDPM"](j_default_params(**hp))
    state = j_agent.init_state(jax.random.PRNGKey(27))
    lc = np.array([-300.0, 1.0, 2.0, -np.inf], np.float32)
    state = state.replace(agent=dict(state.agent, active=jnp.int32(2), log_counts=jnp.asarray(lc)))
    x, y = inputs(28, 10)
    from ocl_tpu.data import prepare_test_loaders as j_prepare_test_loaders

    want = j_agent.evaluate(state, j_prepare_test_loaders([(x, y)], j_agent.params))

    agent = port_agent("SGD", test_batch=4)
    tstate = agent.init_state(0)
    tstate.model.load_state_dict(interop.ndpm_from_jax(_np(state.params)))
    tstate.agent["active"], tstate.agent["log_counts"] = 2, torch.from_numpy(lc)
    noise = column_noise(jax.random.fold_in(state.rng, 99), 4, [1, 2])
    got = agent.evaluate(tstate, prepare_test_loaders([(x, y)], agent.params, "cpu"), noise=noise)
    np.testing.assert_array_equal(got, want)
