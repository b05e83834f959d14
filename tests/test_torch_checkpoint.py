"""--ckpt_dir crash-resume of the port (counterpart of
tests/test_checkpoint.py and tests/test_resume_cli.py), on the CPU at nf 4.

For each agent a run of three tasks is interrupted in its third task,
through the runner's `_new_agent_and_state` seam, after the second task's
checkpoint; the resumed run must end with the uninterrupted run's accuracy
matrix and train state, bit for bit. GDumb keeps its memory on the agent
object: a checkpoint without it resumes into another run. The state file
loads with `weights_only=True`.
"""

import contextlib
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import ocl_tpu_torch.experiment.run as run_mod
from ocl_tpu_torch.config import default_params
from ocl_tpu_torch.models import ndpm_vars as V
from ocl_tpu_torch.utils import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(data="synthetic", num_runs=1, num_tasks=3, mem_size=40, synthetic_size=20, nf=4,
            test_batch=32, verbose=False, device="cpu", fix_order=True, learning_rate=0.05)
CNDPM = dict(agent="CNDPM", max_experts=3, stm_capacity=30, optimizer="Adam",
             learning_rate=0.001, classifier_chill=0.01, log_alpha=-300, test_batch=20)
CASES = {
    "er_fused": dict(agent="ER"),
    "er_aser": dict(agent="ER", update="ASER", retrieve="ASER", k=3),
    "gdumb": dict(agent="GDUMB", mem_epoch=2),
    "icarl": dict(agent="ICARL"),
    "lwf": dict(agent="LWF", learning_rate=0.01),
    "ewc": dict(agent="EWC", learning_rate=0.01, fisher_update_after=5),
    "scr": dict(agent="SCR", eps_mem_batch=20),
    "cndpm": CNDPM,
}


@contextlib.contextmanager
def run_env(tmp_path, z_samples=None):
    """One CPU thread, a working directory with config/global.yml (the
    runner's --store writes under it), and CN-DPM's z samples cut."""
    threads, cwd, z = torch.get_num_threads(), os.getcwd(), V.VAE_Z_SAMPLES
    (tmp_path / "config").mkdir(exist_ok=True)
    shutil.copy(os.path.join(REPO, "config", "global.yml"), tmp_path / "config")
    torch.set_num_threads(1)
    os.chdir(tmp_path)
    V.VAE_Z_SAMPLES = z_samples or z
    try:
        yield
    finally:
        V.VAE_Z_SAMPLES = z
        os.chdir(cwd)
        torch.set_num_threads(threads)


def params_for(name, **kw):
    params = default_params(**dict(BASE, **CASES[name], **kw))
    if name == "cndpm":
        params.sleep_step_g = params.sleep_step_d = 5
    return params


def run(monkeypatch, params, crash_at=None, edit_meta=None):
    """multiple_run with --store; returns (accuracy array, the last run's
    packed final state). With `crash_at`, train_learner raises on its
    crash_at-th call (counting from 1). `edit_meta(meta)` edits every agent
    meta the run saves."""
    made = []
    orig = run_mod._new_agent_and_state

    def wrapped(p, seed):
        agent, state = orig(p, seed)
        made.append((agent, state))
        real, calls = agent.train_learner, {"n": 0}

        def train_learner(state, x, y):
            calls["n"] += 1
            if calls["n"] == crash_at:
                raise KeyboardInterrupt("a crash in task {}".format(crash_at - 1))
            out = real(state, x, y)
            made[-1] = (agent, out)
            return out

        agent.train_learner = train_learner
        return agent, state

    monkeypatch.setattr(run_mod, "_new_agent_and_state", wrapped)
    if edit_meta is not None:
        snap = checkpoint.snapshot_agent_meta
        monkeypatch.setattr(checkpoint, "snapshot_agent_meta", lambda a: edit_meta(snap(a)))
    try:
        run_mod.multiple_run(params, store=True, save_path="run.pkl")
    finally:
        monkeypatch.setattr(run_mod, "_new_agent_and_state", orig)
        if edit_meta is not None:
            monkeypatch.setattr(checkpoint, "snapshot_agent_meta", snap)
    with open(os.path.join("result", "synthetic", "run.pkl"), "rb") as f:
        acc = pickle.load(f)["acc_array"]
    return acc, checkpoint.pack_state(made[-1][1])


def interrupted_then_resumed(monkeypatch, params, ckpt, edit_meta=None):
    params.ckpt_dir = str(ckpt)
    with pytest.raises(KeyboardInterrupt):
        run(monkeypatch, params, crash_at=3, edit_meta=edit_meta)
    meta = checkpoint.read_meta(str(ckpt))
    assert (meta["run"], meta["task"]) == (0, 1) and len(meta["tmp_acc"]) == 2
    return run(monkeypatch, params)


@pytest.mark.parametrize("name", list(CASES))
def test_resume_equals_uninterrupted(name, tmp_path, monkeypatch):
    with run_env(tmp_path, z_samples=2 if name == "cndpm" else None):
        want_acc, want_state = run(monkeypatch, params_for(name))
        got_acc, got_state = interrupted_then_resumed(monkeypatch, params_for(name),
                                                      tmp_path / "ckpt")
    assert want_acc.shape == (1, 3, 3)
    np.testing.assert_array_equal(got_acc, want_acc)
    assert checkpoint.mismatches(got_state, want_state) == []
    if name == "cndpm":
        assert want_state["agent"]["active"] >= 1   # a sleep ran before the checkpoint


def test_gdumb_resume_needs_the_memory(tmp_path, monkeypatch):
    """A checkpoint whose agent meta lacks GDumb's memory (as ocl_tpu's
    does) resumes into a run that retrains from the third task's images
    alone, and ends elsewhere."""
    def drop_memory(meta):
        return {k: v for k, v in meta.items() if k not in ("mem_img", "mem_c")}

    with run_env(tmp_path):
        want_acc, want_state = run(monkeypatch, params_for("gdumb"))
        got_acc, got_state = interrupted_then_resumed(
            monkeypatch, params_for("gdumb"), tmp_path / "ckpt", edit_meta=drop_memory)
    assert not np.array_equal(got_acc[0, 2], want_acc[0, 2])
    assert "state.model" in " ".join(checkpoint.mismatches(got_state, want_state))


def test_state_file_loads_weights_only_and_restores_bit_for_bit(tmp_path):
    """ER + ASER after one task: the state file loads with
    weights_only=True (a numpy array in it would be refused), and a fresh
    state restored from it packs to what was saved; the meta holds the
    numpy rows and the agent's bookkeeping."""
    from ocl_tpu_torch.data import continuum
    from ocl_tpu_torch.registry import agents

    params = params_for("er_aser")
    np.random.seed(0)
    stream = continuum("synthetic", "nc", params)
    stream.new_run()
    agent = agents["ER"](params)
    state = agent.init_state(0)
    x, y, _ = next(stream)
    state = agent.train_learner(state, x, y)
    accs = [np.array([0.5, 0.25, 0.0])]
    checkpoint.save_checkpoint(str(tmp_path), state, {
        "run": 0, "task": 0, "tmp_acc": accs, "accuracy_list": [],
        "agent": checkpoint.snapshot_agent_meta(agent)})
    assert sorted(os.listdir(tmp_path)) == ["meta.pkl", "state_r0_t0.pt"]
    saved = torch.load(tmp_path / "state_r0_t0.pt", weights_only=True)

    fresh_agent = agents["ER"](params)
    fresh, meta = checkpoint.load_checkpoint(str(tmp_path), fresh_agent.init_state(1))
    checkpoint.restore_agent_meta(fresh_agent, meta["agent"])
    assert checkpoint.mismatches(checkpoint.pack_state(fresh), saved) == []
    assert checkpoint.mismatches(checkpoint.pack_state(fresh), checkpoint.pack_state(state)) == []
    assert fresh.buffer.current_index == state.buffer.current_index > 0
    assert fresh_agent.old_labels == agent.old_labels and fresh_agent.task_seen == 1
    np.testing.assert_array_equal(meta["tmp_acc"][0], accs[0])
    # a generator draw after the restore is the one the saved run would draw
    assert torch.equal(torch.rand(4, generator=fresh.generator),
                       torch.rand(4, generator=state.generator))

    torch.save({"rows": accs[0]}, tmp_path / "numpy.pt")
    with pytest.raises(pickle.UnpicklingError):
        torch.load(tmp_path / "numpy.pt", weights_only=True)

    # the next checkpoint replaces the state file
    checkpoint.save_checkpoint(str(tmp_path), state, {"run": 0, "task": 1})
    assert sorted(os.listdir(tmp_path)) == ["meta.pkl", "numpy.pt", "state_r0_t1.pt"]
