"""Experiment runner (counterpart of ocl_tpu/experiment/run.py).

multiple_run: a fresh agent and state per run. Online mode streams the tasks
through agent.train_learner and evaluates every task's test set after each
task; offline mode concatenates all tasks first and trains once. Prints the
same metric lines as ocl_tpu and, with `store`, pickles {time, acc_array}
under config/global.yml's result path. --buffer_tracker checks the buffer's
class counts after every task; --ckpt_dir saves the whole train state after
every task and resumes a crashed run after the last saved one.

--n_devices W > 1 starts W ranks (parallel/mesh.py::launch) and fans the
evaluation out over them, as ocl_tpu's CLI keeps its train state on one
device and shards only the eval: every rank builds the same stream from the
seed and keeps only its rows of every test batch on its device; rank 0
trains, and before each evaluation broadcasts its model and BN buffers (for
NCM also its buffer) and its label bookkeeping; the correct counts are
summed over the ranks. Rank 0 alone prints, checkpoints and writes --store
output. --n_devices 0 or 1 is the single process.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from ocl_tpu_torch.buffer.state import valid_mask
from ocl_tpu_torch.data import continuum, prepare_test_loaders
from ocl_tpu_torch.experiment.metrics import compute_performance
from ocl_tpu_torch import parallel
from ocl_tpu_torch.parallel import dp
from ocl_tpu_torch.registry import agents
from ocl_tpu_torch.utils import checkpoint
from ocl_tpu_torch.utils.io import load_yaml
from ocl_tpu_torch.utils.profiling import Throughput

def check_supported(params):
    if params.agent not in agents:
        raise NotImplementedError("agent {!r} is not ported yet; available: {}".format(
            params.agent, ", ".join(sorted(agents))))


def n_devices(params) -> int:
    return int(getattr(params, "n_devices", 0) or 0)


def start_ranks(fn, params, *args):
    """Under --n_devices W > 1 outside the ranks: fn(params, *args) on W
    ranks (parallel/mesh.py::launch), each rank's result in a list. Else
    None: a single process, or a rank, whose params then name its device."""
    if n_devices(params) <= 1:
        return None
    mesh = parallel.current()
    if mesh is None:
        return parallel.launch(fn, (params,) + args, n_devices(params), params.device)
    params.device = str(mesh.device)
    return None


def fan_out_mesh(params):
    """The mesh the evaluation fans out over: this rank's, inside the ranks
    that --n_devices W > 1 starts; else None."""
    return parallel.current() if n_devices(params) > 1 else None


def rank_test_loaders(test_data, params, device):
    """prepare_test_loaders on `device`; fanned out (`fan_out_mesh`), this
    rank's rows of every test batch (dp.shard_loaders) alone."""
    mesh = fan_out_mesh(params)
    if mesh is None:
        return prepare_test_loaders(test_data, params, device)
    return [tuple(t.to(device) for t in loader) for loader in dp.shard_loaders(
        mesh, prepare_test_loaders(test_data, params, "cpu"))]


def train_for_eval(agent, state, x_train, y_train):
    """agent.train_learner; fanned out (the agent's `eval_mesh`), on rank 0
    alone, whose state then goes to every rank for the evaluation
    (dp.broadcast_state)."""
    mesh = agent.eval_mesh
    if mesh is None or mesh.rank == 0:
        state = agent.train_learner(state, x_train, y_train)
    if mesh is not None:
        dp.broadcast_state(mesh, agent, state)
    return state


def _new_agent_and_state(params, run_seed):
    agent = agents[params.agent](params)
    state = agent.init_state(run_seed)
    return agent, state


def _check_buffer_tracker(state):
    """--buffer_tracker (reference BufferClassTracker.check_tracker,
    buffer_utils.py:203-205): print the buffer's per-class counts, and a
    MISMATCH line if they disagree with a count of the filled slots'
    labels. The same lines as ocl_tpu for the same buffer."""
    buf = getattr(state, "buffer", None)
    if buf is None:
        return
    counts = buf.class_counts.cpu().numpy()
    labels = buf.labels.cpu().numpy()
    valid = valid_mask(buf).cpu().numpy()
    recomputed = np.bincount(labels[valid], minlength=counts.shape[0])
    print("[buffer_tracker] total {} per-class {}".format(
        int(counts.sum()), counts.astype(int).tolist()))
    if not np.array_equal(counts.astype(int), recomputed.astype(int)):
        print("[buffer_tracker] MISMATCH recomputed {}".format(recomputed.tolist()))


def multiple_run(params, store=False, save_path=None):
    from ocl_tpu_torch.config import apply_runtime_flags

    check_supported(params)
    ranks = start_ranks(multiple_run, params, store, save_path)
    if ranks is not None:
        return ranks[0]
    mesh = fan_out_mesh(params)
    lead = mesh is None or mesh.rank == 0
    apply_runtime_flags(params)
    device = torch.device(params.device)
    start = time.time()
    print("Setting up data stream")
    data_continuum = continuum(params.data, params.cl_type, params)
    print("data setup time: {}".format(time.time() - start))

    if store and lead:
        result_path = load_yaml("config/global.yml", key="path")["result"]
        table_path = result_path + params.data
        os.makedirs(table_path, exist_ok=True)
        if not save_path:
            save_path = getattr(params, "model_name", params.agent) + "_" + \
                getattr(params, "data_name", params.data) + ".pkl"

    # crash-resume: the run, task, accuracies and whole TrainState of the
    # last checkpoint, if there is one
    ckpt_dir = getattr(params, "ckpt_dir", None)
    resume_meta = None
    if ckpt_dir and os.path.exists(os.path.join(ckpt_dir, checkpoint.META_FILE)):
        resume_meta = checkpoint.read_meta(ckpt_dir)
        print("resuming from checkpoint: run {} after task {}".format(
            resume_meta["run"], resume_meta["task"]))

    np.random.seed(params.seed)
    accuracy_list = ([np.array(a) for a in resume_meta["accuracy_list"]]
                     if resume_meta else [])
    start_run = resume_meta["run"] if resume_meta else 0
    for run in range(params.num_runs):
        tmp_acc = []
        run_start = time.time()
        data_continuum.new_run()
        if run < start_run:
            continue  # the new_run() above keeps the np.random stream aligned
        agent, state = _new_agent_and_state(params, params.seed + run)
        agent.eval_mesh = mesh
        test_loaders = rank_test_loaders(data_continuum.test_data(), params, device)
        resume_task = -1
        if resume_meta and run == start_run:
            state, meta = checkpoint.load_checkpoint(ckpt_dir, state)
            checkpoint.restore_agent_meta(agent, meta["agent"])
            tmp_acc = [np.array(a) for a in meta["tmp_acc"]]
            resume_task = meta["task"]
        if params.online:
            tput = Throughput()
            for i, (x_train, y_train, labels) in enumerate(data_continuum):
                if i <= resume_task:
                    continue  # trained before the checkpoint
                if params.verbose:
                    print("-----------run {} training batch {}-------------".format(run, i))
                    print("size: {}, {}".format(x_train.shape, y_train.shape))
                if lead:
                    with tput.measure((x_train.shape[0] // params.batch) * params.batch, device):
                        state = agent.train_learner(state, x_train, y_train)
                if getattr(params, "buffer_tracker", False) and lead:
                    _check_buffer_tracker(state)
                if mesh is not None:
                    dp.broadcast_state(mesh, agent, state)
                tmp_acc.append(agent.evaluate(state, test_loaders))
                if ckpt_dir and lead:
                    checkpoint.save_checkpoint(ckpt_dir, state, {
                        "run": run, "task": i,
                        "tmp_acc": [np.asarray(a) for a in tmp_acc],
                        "accuracy_list": [np.asarray(a) for a in accuracy_list],
                        "agent": checkpoint.snapshot_agent_meta(agent),
                    })
            run_end = time.time()
            print("-----------run {}-----------avg_end_acc {}-----------train time {}"
                  .format(run, np.mean(tmp_acc[-1]), run_end - run_start))
            print("-----------run {} stream throughput {:.1f} images/sec-----------".format(
                run, tput.images_per_sec()))
            accuracy_list.append(np.array(tmp_acc))
        else:
            xs, ys = [], []
            for x_train, y_train, labels in data_continuum:
                xs.append(x_train)
                ys.append(y_train)
            print("----------run {} training-------------".format(run))
            state = train_for_eval(agent, state, np.concatenate(xs, axis=0),
                                   np.concatenate(ys, axis=0))
            accuracy_list.append(agent.evaluate(state, test_loaders))

    accuracy_array = np.array(accuracy_list)
    end = time.time()
    if store and lead:
        result = {"time": end - start, "acc_array": accuracy_array}
        with open(table_path + "/" + save_path, "wb") as f:
            pickle.dump(result, f)
    print("----------- Total {} run: {}s -----------".format(params.num_runs, end - start))
    if params.online:
        avg_end_acc, avg_end_fgt, avg_acc, avg_bwtp, avg_fwt = compute_performance(accuracy_array)
        print("----------- Avg_End_Acc {} Avg_End_Fgt {} Avg_Acc {} Avg_Bwtp {} Avg_Fwt {}-----------"
              .format(avg_end_acc, avg_end_fgt, avg_acc, avg_bwtp, avg_fwt))
        return avg_end_acc, avg_end_fgt, avg_acc, avg_bwtp, avg_fwt
    print("avg_end_acc {}".format(np.mean(accuracy_list)))
    return np.mean(accuracy_list)
