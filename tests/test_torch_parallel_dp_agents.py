"""ER + ASER, SCR, GSS and the CN-DPM wake step data-parallel over two
ranks (ocl_tpu_torch/parallel/dp.py), as test_torch_parallel_dp.py holds
plain ER:
  * ER + ASER over a memory it overfills: the buffer (ASER's update picks)
    and the weights (its retrieval picks) equal the unsharded step's
    exactly, K1's plain version serving the CPU;
  * SCR, GSS and CN-DPM's wake step: one step against ocl_tpu's
    `make_dp_train_task` on two virtual CPU devices, at
    tests/test_parallel_equivalence.py:199-288's pins;
  * every rank's weights bit for bit the same.
The ranks run every case in one launch (one thread a rank, a 120 s limit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from ocl_tpu.config import default_params as j_default_params
from ocl_tpu.parallel.dp import make_dp_train_task
from ocl_tpu.parallel.mesh import get_mesh
from ocl_tpu.registry import agents as j_agents
from ocl_tpu_torch import interop
from test_torch_agents import supcon_weights
from test_torch_augment import port_draws as aug_draws
from test_torch_buffer import make_buffers
from test_torch_model import random_weights
from test_torch_parallel_dp import (NF, _max_diff, _sd_diff, _t, batches,
                                    buffer_spec, jax_dp, launch_cpu)


def aser_case(w):
    """ER + ASER from a memory 6 slots short of full over 3 steps of 2 W:
    the update's scored replacement and the SV retrieval both run."""
    mem, b = 8 * w, 2 * w
    hp = dict(data="synthetic", agent="ER", update="ASER", retrieve="ASER", aser_type="asvm",
              k=2, n_smp_cls=1.0, mem_size=mem, eps_mem_batch=w, batch=b, nf=NF,
              verbose=False)
    params, stats = random_weights(50)
    _, tbuf = make_buffers(mem, mem - 2, mem - 2, seed=51)
    xs, ys = batches(52, 3, b)
    g = torch.Generator().manual_seed(53)
    draws = []
    for _ in range(3):
        from ocl_tpu_torch.buffer.retrieve import gumbel

        draws.append({"retrieve": [{"rand": gumbel((mem,), g, "cpu"),
                                    "cand": gumbel((10, mem), g, "cpu"),
                                    "coop": gumbel((10, mem), g, "cpu")}],
                      "update": {"thr": torch.rand((), generator=g),
                                 "eval": gumbel((10, mem), g, "cpu"),
                                 "cand": gumbel((mem,), g, "cpu")}})
    return {"params": hp, "state_dict": interop.from_jax(params, stats),
            "buffer": buffer_spec(tbuf), "ctx_y": ys, "xs": xs, "ys": ys, "draws": draws}


def scr_case(w):
    """SCR at tests/test_parallel_equivalence.py:199's sizes, one step."""
    from test_torch_agents import reservoir_draws

    mem, b = 8 * w, 2 * w
    # lr 0.01, as test_torch_agents.py's SCR step: at nf 4 a ReLU input
    # within rounding of zero may flip between XLA and torch
    hp = dict(data="synthetic", agent="SCR", mem_size=mem, eps_mem_batch=w, batch=b, nf=NF,
              head="mlp", temp=0.07, learning_rate=0.01, verbose=False)
    params, stats = supcon_weights(60)
    jbuf, tbuf = make_buffers(mem, mem // 2, mem // 2, seed=61)
    xs, ys = batches(62, 1, b)
    key = jax.random.PRNGKey(63)
    j_agent = j_agents["SCR"](j_default_params(**hp, scan_unroll=1))
    jstate, jm = jax_dp(j_agent, params, stats, jbuf, key, xs, ys, w)
    rng, r_ret, r_aug = jax.random.split(key, 3)
    _, r_upd = jax.random.split(rng)
    draws = [{"iters": [{"retrieve": {"g": _t(jax.random.gumbel(r_ret, (mem,)))},
                         "aug": aug_draws(r_aug, n=w + b)}],
              "update": reservoir_draws(r_upd, b)}]
    spec = {"params": hp, "state_dict": interop.from_jax(params, stats),
            "buffer": buffer_spec(tbuf), "ctx_y": ys, "xs": xs, "ys": ys, "draws": draws}
    return spec, (jstate, jm)


def gss_case(w):
    """ER + GSS on a full memory (the gate and the gradient bank run), one
    step."""
    mem, b = 8 * w, 2 * w
    hp = dict(data="synthetic", agent="ER", update="GSS", gss_mem_strength=2,
              gss_batch_size=w, mem_size=mem, eps_mem_batch=w, batch=b, nf=NF,
              learning_rate=0.01, verbose=False)
    params, stats = random_weights(70)
    score = np.random.RandomState(74).uniform(-1, 1, mem).astype(np.float32)
    jbuf, tbuf = make_buffers(mem, mem, 3 * mem, seed=71, score=score)
    xs, ys = batches(72, 1, b)
    key = jax.random.PRNGKey(73)
    j_agent = j_agents["ER"](j_default_params(**hp, scan_unroll=1))
    jstate, jm = jax_dp(j_agent, params, stats, jbuf, key, xs, ys, w)
    rng, r_ret = jax.random.split(key)
    _, r_upd = jax.random.split(rng)
    r_bank, r_cand, r_coin = jax.random.split(r_upd, 3)
    draws = [{"retrieve": [{"g": _t(jax.random.gumbel(r_ret, (mem,)))}],
              "update": {"bank": _t(jax.random.gumbel(r_bank, (mem,))),
                         "cand": _t(jax.random.gumbel(r_cand, (mem,))),
                         "coin": _t(jax.random.uniform(r_coin, (b,)))}}]
    spec = {"params": hp, "state_dict": interop.from_jax(params, stats),
            "buffer": buffer_spec(tbuf), "ctx_y": ys, "xs": xs, "ys": ys, "draws": draws}
    return spec, (jstate, jm)


def cndpm_case(w):
    """CN-DPM's wake step with one born expert and a partly filled STM, at
    test_torch_cndpm.py's sizes (2 z samples), under SGD."""
    import test_torch_cndpm as tc

    b = 2 * w
    x, y = tc.inputs(80, b)
    rng = jax.random.PRNGKey(81)
    hp = dict(tc.HP, optimizer="SGD", learning_rate=0.01, batch=b)
    j_agent = j_agents["CNDPM"](j_default_params(**hp, scan_unroll=1))
    j_agent.params.sleep_step_g, j_agent.params.sleep_step_d = tc.SLEEP
    jstate, _, tstate = tc.both_states(j_agent, 1, "SGD", x, y, rng, 5)
    mesh = get_mesh(w)
    fn = make_dp_train_task(j_agent, mesh)
    with mesh:
        new, jm = fn(jstate, jnp.asarray(x)[None], jnp.asarray(y, jnp.int32)[None])
    r_nll = jax.random.split(rng)[1]
    spec = {"params": hp, "z_samples": tc.S, "flush_denormal": True,
            "attrs": {"sleep_step_g": tc.SLEEP[0], "sleep_step_d": tc.SLEEP[1]},
            "state_dict": {k: v.clone() for k, v in tstate.model.state_dict().items()},
            "cndpm": (tstate.agent, tstate.optimizer), "ctx_y": y,
            "xs": x[None], "ys": y[None],
            "draws": [{"noise": tc.column_noise(r_nll, b, range(2))}]}
    return spec, (new, jm)


@pytest.fixture(scope="module")
def cases():
    """name -> (spec, ocl_tpu's result or None), and the two ranks' results."""
    import test_torch_cndpm as tc
    from ocl_tpu.models import ndpm_vars as JV
    from ocl_tpu_torch.models import ndpm_vars as V

    old = JV.VAE_Z_SAMPLES, V.VAE_Z_SAMPLES
    JV.VAE_Z_SAMPLES = V.VAE_Z_SAMPLES = tc.S
    try:
        out = {"aser": (aser_case(2), None), "scr": scr_case(2), "gss": gss_case(2),
               "cndpm": cndpm_case(2)}
        ranks = launch_cpu(workers.run_specs, ({k: v[0] for k, v in out.items()},), 2)
        yield out, ranks
    finally:
        JV.VAE_Z_SAMPLES, V.VAE_Z_SAMPLES = old


def test_dp_aser_picks_match_unsharded(cases):
    """ASER's update and retrieval picks over a slot-sharded buffer, features
    computed on each rank's rows and gathered, K1 (its plain version here)
    on the full matrices on every rank: the unsharded step's, exactly."""
    out, ranks = cases
    spec, _ = out["aser"]
    want = workers.run_plain(spec)
    got = ranks[0]["aser"]
    assert want["buffer"]["n_seen"] > spec["params"]["mem_size"]   # the SV paths ran
    for k in ("labels", "imgs", "counts"):
        np.testing.assert_array_equal(got["buffer"][k], want["buffer"][k])
    assert got["buffer"]["current_index"] == want["buffer"]["current_index"]
    assert _sd_diff(got["sd"], want["sd"]) < 1e-4


@pytest.mark.parametrize("name", ["scr", "gss", "cndpm"])
def test_dp_step_matches_ocl_tpu_dp(cases, name):
    """SCR (loss 1e-4), GSS and CN-DPM's wake step (loss atol 1e-3) against
    ocl_tpu's DP step: parameters within 1e-3, the discrete state exact."""
    out, ranks = cases
    _, (jstate, jm) = out[name]
    got = ranks[0][name]
    if name == "cndpm":
        n = got["stm"]["count"]
        assert n == int(jstate.agent["stm_count"]) > 5   # rows were routed to the STM
        np.testing.assert_array_equal(got["stm"]["y"][:n], np.asarray(jstate.agent["stm_y"])[:n])
        assert np.max(np.abs(got["stm"]["x"][:n] - np.asarray(jstate.agent["stm_x"])[:n])) < 1e-6
        # as test_parallel_equivalence.py:285-287 holds it (the wake loss, a
        # sum over rows and slots, runs in the thousands)
        np.testing.assert_allclose(got["loss"][0], float(jm["loss"][0]), atol=1e-3)
        want = interop.ndpm_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
        assert _sd_diff({k: got["sd"][k] for k in want}, want) < 1e-3
        return
    assert abs(got["loss"][0] - float(jm["loss"][0])) < (1e-4 if name == "scr" else 1e-5)
    params, stats = interop.to_jax(got["sd"])
    assert _max_diff(params, jstate.params) < 1e-3
    assert got["buffer"]["current_index"] == int(jstate.buffer.current_index)
    np.testing.assert_array_equal(got["buffer"]["labels"], np.asarray(jstate.buffer.labels))
    assert np.max(np.abs(got["buffer"]["imgs"] - np.asarray(jstate.buffer.imgs))) < 1e-6
    if name == "gss":
        np.testing.assert_allclose(got["buffer"]["score"], np.asarray(jstate.buffer.score),
                                   rtol=1e-3, atol=1e-4)




def test_dp_agent_ranks_stay_bit_identical(cases):
    _, ranks = cases
    for name in ranks[0]:
        for k, v in ranks[0][name]["sd"].items():
            assert torch.equal(v, ranks[1][name]["sd"][k]), (name, k)
