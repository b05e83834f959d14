"""One step of each ported agent and schedule against ocl_tpu's
`_build_train_task_fn()` over one batch, from the same weights, BN
statistics, optimizer and agent state (through `interop`), buffer, batch and
random draws (rebuilt from ocl_tpu's key splits). Also the review pass, the
EWC++ end-of-task normalisation and NCM evaluation, with the same
permutation and noise.

Params, BN statistics, Fisher trees: rtol 1e-3 / atol 1e-4 (fp32 reduction
order). Buffer contents, labels and counts: exact. lr 0.01 for the reason
given in test_torch_er_step.py: at nf 4 a ReLU input within rounding of zero
may flip between XLA and torch; at lr 0.01 that stays under atol while a
missing or extra gradient term does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocl_tpu.agents import review as j_review
from ocl_tpu.agents.base import TrainState as JTrainState
from ocl_tpu.config import default_params as j_default_params
from ocl_tpu.registry import agents as j_agents
from ocl_tpu_torch import interop
from ocl_tpu_torch.agents import review
from ocl_tpu_torch.agents.base import TrainState
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.data import prepare_test_loaders
from ocl_tpu_torch.optim import setup_opt
from ocl_tpu_torch.registry import agents
from test_torch_buffer import MEM, N_CLS, assert_buffers_equal, batch, class_images, make_buffers
from test_torch_model import port_model, random_weights

NF = 4
TOL = dict(rtol=1e-3, atol=1e-4)
HP = dict(data="synthetic", mem_size=MEM, eps_mem_batch=10, batch=10, learning_rate=0.01,
          nf=NF, verbose=False)
GSS = dict(update="GSS", gss_mem_strength=3, gss_batch_size=10)
CONFIGS = {
    "er_fused_random": dict(agent="ER"),
    "er_fused_match": dict(agent="ER", retrieve="match"),
    "er_mir": dict(agent="ER", retrieve="MIR", subsample=20),
    "er_gss": dict(agent="ER", **GSS),
    "agem": dict(agent="AGEM"),
    "ewc": dict(agent="EWC", fisher_update_after=3),
    "lwf": dict(agent="LWF"),
    "labels_trick": dict(agent="ER", labels_trick=True),
    "separated_softmax": dict(agent="ER", separated_softmax=True),
    "kd_trick": dict(agent="ER", kd_trick=True),
    "kd_trick_star": dict(agent="ER", kd_trick_star=True),
}
OLD_LABELS = [0, 2, 4, 6]   # classes of the finished tasks when task_seen = 1


def _t(a):
    return torch.tensor(np.asarray(a))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def port_draws(agent, key):
    """The draws ocl_tpu's step takes from `key`: the fused ER schedule and
    AGEM split it two ways per iteration (er.py:80, agem.py:53), the two-pass
    schedule three ways (er.py:97); then the update's split."""
    p = agent.params
    two_pass = p.agent == "ER" and not agent.fused
    if two_pass:
        rng, r_ret, _ = jax.random.split(key, 3)
    else:
        rng, r_ret = jax.random.split(key)
    _, r_upd = jax.random.split(rng)
    if p.retrieve == "match":
        ret = {"g": _t(jax.random.gumbel(r_ret, (N_CLS, MEM)))}
    else:   # random, MIR: one Gumbel draw over the slots
        ret = {"g": _t(jax.random.gumbel(r_ret, (MEM,)))}
    if p.update == "GSS":
        r_bank, r_cand, r_coin = jax.random.split(r_upd, 3)
        upd = {"bank": _t(jax.random.gumbel(r_bank, (MEM,))),
               "cand": _t(jax.random.gumbel(r_cand, (MEM,))),
               "coin": _t(jax.random.uniform(r_coin, (p.batch,)))}
    else:
        upd = {"u": _t(jax.random.uniform(r_upd, (p.batch,)))}
    return {"retrieve": [ret], "update": upd}


@pytest.fixture(scope="module")
def jax_steps():
    """config name -> (jitted one-task fn, ocl_tpu agent), built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            agent = j_agents[CONFIGS[name]["agent"]](j_default_params(**HP, **CONFIGS[name]))
            cache[name] = (jax.jit(agent._build_train_task_fn()), agent)
        return cache[name]

    return get


def agent_state(name, params, seed):
    """ocl_tpu's agent pytree (numpy leaves) for a config at task_seen 1:
    a teacher from other weights, or EWC's trees, all flags set."""
    g = np.random.RandomState(seed)
    cfg = CONFIGS[name]
    ag = {}
    if cfg["agent"] == "LWF" or cfg.get("kd_trick") or cfg.get("kd_trick_star"):
        ag["teacher_params"], ag["teacher_stats"] = random_weights(seed)
        ag["has_teacher"] = np.float32(1.0)
    if cfg["agent"] == "EWC":
        def tree(f):
            return jax.tree_util.tree_map(lambda a: f(a).astype(np.float32), params)

        ag.update(prev_params=tree(lambda a: a + g.normal(0, 0.05, a.shape)),
                  running_fisher=tree(lambda a: g.uniform(0, 1e-2, a.shape)),
                  tmp_fisher=tree(lambda a: g.uniform(0, 1e-2, a.shape)),
                  normalized_fisher=tree(lambda a: g.uniform(0, 1, a.shape)),
                  has_prev=np.float32(1.0), step_in_task=np.int32(0))
    return ag or None


def run_both(jax_steps, name, task_seen=1, fill=35, n_seen=35, labels=None, ag_edit=None,
             key=24):
    """One step of config `name` on both packages; returns (ocl_tpu state,
    port TrainState, port agent)."""
    fn, j_agent = jax_steps(name)
    params, stats = random_weights(21)
    x, y = batch(30)
    ag = agent_state(name, params, 22)
    if ag is not None and ag_edit:
        ag.update(ag_edit)
    key = jax.random.PRNGKey(key)
    uses_buffer = j_agent.uses_buffer
    jbuf, tbuf = make_buffers(MEM, fill, n_seen, seed=23, labels=labels) if uses_buffer \
        else (None, None)

    j_agent.task_seen, j_agent.old_labels = task_seen, OLD_LABELS[: 4 * task_seen]
    state = JTrainState(params=_jnp(params), batch_stats=_jnp(stats),
                        opt_state=j_agent.tx.init(_jnp(params)), buffer=jbuf,
                        agent=_jnp(ag) if ag is not None else None, rng=key)
    state, _ = fn(state, j_agent.before_train(y), jnp.asarray(x)[None],
                  jnp.asarray(y, jnp.int32)[None])

    agent = agents[CONFIGS[name]["agent"]](default_params(**HP, **CONFIGS[name], device="cpu"))
    agent.task_seen, agent.old_labels = task_seen, OLD_LABELS[: 4 * task_seen]
    model = port_model(params, stats)
    tstate = TrainState(model=model, optimizer=setup_opt("SGD", model.parameters(), HP["learning_rate"]),
                        buffer=tbuf, generator=torch.Generator(),
                        agent=interop.agent_from_jax(ag, model) if ag is not None else None)
    draws = port_draws(agent, key) if uses_buffer else None
    agent.step(tstate, agent.before_train(y), torch.from_numpy(x), torch.from_numpy(y), draws=draws)
    return state, tstate, agent


def assert_states_close(state, tstate):
    got = interop.to_jax(tstate.model.state_dict())
    want = jax.tree_util.tree_map(np.asarray, (state.params, state.batch_stats))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, **TOL)
    if tstate.buffer is not None:
        assert_buffers_equal(state.buffer, tstate.buffer)


STEP_CASES = [
    ("er_fused_random", 0, {}),
    ("er_fused_match", 0, dict(fill=MEM, n_seen=100, labels=np.arange(MEM) % N_CLS)),
    ("er_mir", 0, {}),
    # GSS scores are cosines of single-image gradients, taken after the
    # step: a weight that differs by rounding can put an image's ReLU input
    # on the other side of zero. This key's bank batches keep clear of that
    ("er_gss", 0, dict(key=25)),
    ("agem", 0, {}),
    ("agem", 1, {}),
    ("lwf", 0, dict(ag_edit={"has_teacher": np.float32(0.0)})),
    ("lwf", 1, {}),
    ("labels_trick", 1, {}),
    ("separated_softmax", 1, {}),
    ("kd_trick", 1, {}),
    ("kd_trick_star", 1, {}),
]


@pytest.mark.parametrize("name,task_seen,kw", STEP_CASES,
                         ids=["{}-t{}".format(n, t) for n, t, _ in STEP_CASES])
def test_step_matches_ocl_tpu(jax_steps, name, task_seen, kw):
    state, tstate, _ = run_both(jax_steps, name, task_seen, **kw)
    assert_states_close(state, tstate)
    if tstate.agent is not None and "teacher" in tstate.agent:
        # the teacher's forwards normalise with batch statistics and fold none
        teacher = interop.to_jax(tstate.agent["teacher"].state_dict())
        for a, b in zip(jax.tree_util.tree_leaves(teacher),
                        jax.tree_util.tree_leaves((state.agent["teacher_params"],
                                                   state.agent["teacher_stats"]))):
            np.testing.assert_array_equal(a, np.asarray(b))
    if name == "er_fused_match":
        assert tstate.buffer.n_seen_so_far > 40   # past the warmup: memory rows valid


@pytest.mark.parametrize("fold", [False, True])
def test_ewc_step_matches_ocl_tpu(jax_steps, fold):
    """A step that folds tmp_fisher into running_fisher first (the 3rd of
    the task, fisher_update_after 3) and one that does not."""
    state, tstate, _ = run_both(jax_steps, "ewc", ag_edit={"step_in_task": np.int32(2 if fold else 0)})
    assert_states_close(state, tstate)
    got = interop.agent_to_jax(tstate.agent)
    assert got["step_in_task"] == int(state.agent["step_in_task"]) == (3 if fold else 1)
    for tree in ("running_fisher", "tmp_fisher"):
        for a, b in zip(jax.tree_util.tree_leaves(got[tree]),
                        jax.tree_util.tree_leaves(state.agent[tree])):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_ewc_after_train_normalises_fisher(jax_steps):
    _, j_agent = jax_steps("ewc")
    params, stats = random_weights(21)
    ag = agent_state("ewc", params, 25)
    ag["has_prev"] = np.float32(0.0)
    state = JTrainState(params=_jnp(params), batch_stats=_jnp(stats), opt_state=None,
                        buffer=None, agent=_jnp(ag), rng=jax.random.PRNGKey(0))
    j_agent.task_seen, j_agent.old_labels, j_agent.new_labels = 0, [], [1, 3]
    state = j_agent.after_train(state, None)

    agent = agents["EWC"](default_params(**HP, **CONFIGS["ewc"], device="cpu"))
    agent.new_labels = [1, 3]
    model = port_model(params, stats)
    tstate = TrainState(model=model, optimizer=None, buffer=None, generator=torch.Generator(),
                        agent=interop.agent_from_jax(ag, model))
    agent.after_train(tstate, None)
    got = interop.agent_to_jax(tstate.agent)
    assert got["has_prev"] == 1.0 and agent.task_seen == 1 and agent.old_labels == [1, 3]
    for tree in ("normalized_fisher", "prev_params"):
        for a, b in zip(jax.tree_util.tree_leaves(got[tree]),
                        jax.tree_util.tree_leaves(state.agent[tree])):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    flat = np.concatenate([a.ravel() for a in jax.tree_util.tree_leaves(got["normalized_fisher"])])
    assert flat.min() == 0.0 and abs(flat.max() - 1.0) < 1e-6


@pytest.mark.parametrize("optimizer", ["SGD", "Adam"])
def test_review_pass_matches_ocl_tpu(optimizer):
    """One shuffled epoch over the buffer at gradients / 10, with the same
    permutation (ocl_tpu/agents/review.py:23-24); under Adam that differs
    from lr / 10. Adam's first steps move each weight by about ±lr whatever
    the gradient's size, so a gradient entry that is zero but for rounding
    takes a step of either sign in either package; this buffer's batches
    have none."""
    hp = dict(HP, agent="ER", review_trick=True, optimizer=optimizer)
    j_agent = j_agents["ER"](j_default_params(**hp))
    params, stats = random_weights(21)
    jbuf, tbuf = make_buffers(MEM, 35, 35, seed=28)
    key = jax.random.PRNGKey(27)
    state = JTrainState(params=_jnp(params), batch_stats=_jnp(stats),
                        opt_state=j_agent.tx.init(_jnp(params)), buffer=jbuf, agent=None, rng=key)
    ctx = j_agent.before_train(np.arange(N_CLS))
    state = j_review.review_pass(j_agent, state, ctx)
    perm = jax.random.permutation(jax.random.split(key)[1], 35)

    agent = agents["ER"](default_params(**hp, device="cpu"))
    model = port_model(params, stats)
    tstate = TrainState(model=model, optimizer=setup_opt(optimizer, model.parameters(), HP["learning_rate"]),
                        buffer=tbuf, generator=torch.Generator())
    review.review_pass(agent, tstate, agent.before_train(np.arange(N_CLS)), perm=_t(perm))
    assert_states_close(state, tstate)


@pytest.mark.parametrize("zero_empty", [False, True])
def test_ncm_eval_matches_ocl_tpu(zero_empty):
    """Nearest-class-mean accuracy with ncm_trick, a seen class with no
    exemplar in the buffer getting ocl_tpu's noise mean (or 1e6 with
    abl_ncm_zero_empty)."""
    hp = dict(HP, agent="ER", ncm_trick=True, test_batch=16)
    j_params = j_default_params(**hp)
    j_params.abl_ncm_zero_empty = zero_empty
    j_agent = j_agents["ER"](j_params)
    params, stats = random_weights(21)
    labels = np.arange(MEM) % 5
    jbuf, tbuf = make_buffers(MEM, 30, 30, seed=28, labels=labels)
    key = jax.random.PRNGKey(29)
    g = np.random.RandomState(30)
    tests = []
    for classes in ([0, 1, 2], [3, 4, 5]):   # class 5 is seen, with no exemplar
        y = np.repeat(classes, 12)
        tests.append((class_images(y, g), y))
    j_agent.old_labels = [0, 1, 2, 3, 4, 5]
    from ocl_tpu.data import prepare_test_loaders as j_prepare_test_loaders

    state = JTrainState(params=_jnp(params), batch_stats=_jnp(stats), opt_state=None,
                        buffer=jbuf, agent=None, rng=key)
    want = j_agent.evaluate(state, j_prepare_test_loaders(tests, j_params))
    noise = jax.random.normal(jax.random.fold_in(key, 7), (N_CLS, NF * 8))

    t_params = default_params(**hp, device="cpu")
    t_params.abl_ncm_zero_empty = zero_empty
    agent = agents["ER"](t_params)
    agent.old_labels = [0, 1, 2, 3, 4, 5]
    tstate = TrainState(model=port_model(params, stats), optimizer=None, buffer=tbuf,
                        generator=torch.Generator())
    got = agent._evaluate_ncm(tstate, prepare_test_loaders(tests, t_params, "cpu"), noise=_t(noise))
    np.testing.assert_array_equal(got, want)
    assert want[0] > 0.5
