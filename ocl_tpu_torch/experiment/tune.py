"""Hyperparameter tuning: a grid search on the first num_val tasks
(counterpart of ocl_tpu/experiment/tune.py, sequential; reference
experiment/tune_hyperparam.py:10-41 and experiment/run.py:180-375).

Each grid point is a full (model, agent) run, `num_runs_val` times, on the
tuning tasks; the best Avg_End_Acc wins, then the run trains on the rest of
the stream with the winning params (`single_tune`), or on the whole stream
again (`--train_val`, `single_tune_train_val`). With `--parallel_runs`, a
grid of learning rates and weight decays trains every (grid point, val run)
pair at once (experiment/parallel_tune.py).

--n_devices W > 1 starts W ranks and fans every evaluation out over them,
as experiment/run.py::multiple_run does: rank 0 trains, each rank holds its
rows of the test sets, and rank 0 alone writes the results. With
--parallel_runs the ranks' rows of the tuning test sets are gathered back
and the stacked points are dealt to the ranks instead.
"""

from __future__ import annotations

import itertools
import os
import pickle
import time
from types import SimpleNamespace

import numpy as np
import torch

from ocl_tpu_torch.config import finalize
from ocl_tpu_torch.data import continuum
from ocl_tpu_torch.experiment.metrics import compute_performance, single_run_avg_end_fgt
from ocl_tpu_torch.experiment.run import (check_supported, fan_out_mesh, rank_test_loaders,
                                          start_ranks, train_for_eval)
from ocl_tpu_torch.parallel import gather_batch
from ocl_tpu_torch.registry import agents
from ocl_tpu_torch.utils.io import check_ram_usage, load_yaml, save_csv


def parameter_grid(tune_params: dict):
    """Every combination of the list-valued params, in sklearn
    ParameterGrid's order: keys sorted, the last key varying fastest. A
    scalar counts as a list of one."""
    keys = sorted(tune_params)
    vals = [tune_params[k] if isinstance(tune_params[k], (list, tuple)) else [tune_params[k]]
            for k in keys]
    return [dict(zip(keys, combo)) for combo in itertools.product(*vals)]


def _merged(default_params, overrides):
    final = dict(vars(default_params))
    final.update(overrides)
    return finalize(SimpleNamespace(**final))


def tune_hyper(tune_data, tune_test_loaders, default_params, tune_params):
    """The grid point with the best Avg_End_Acc over `num_runs_val` runs on
    `tune_data`, run r of a point seeded seed + 1000 + r."""
    grid = parameter_grid(tune_params)
    print(len(grid))
    if getattr(default_params, "parallel_runs", False):
        from ocl_tpu_torch.experiment.parallel_tune import (
            supports_parallel_grid,
            tune_hyper_parallel,
        )

        if supports_parallel_grid(default_params, tune_params):
            mesh = fan_out_mesh(default_params)
            if mesh is not None:   # every point evaluates on every row
                tune_test_loaders = [tuple(gather_batch(mesh, t, 1) for t in loader)
                                     for loader in tune_test_loaders]
            return tune_hyper_parallel(tune_data, tune_test_loaders, default_params,
                                       tune_params, grid, _merged)
        print("[parallel_runs] grid not vmappable (non-scalar hyperparams, "
              "agent, or over the stacked-state memory budget) — "
              "sequential tuning")
    tune_accs = []
    for param_set in grid:
        print(param_set)
        final_params = _merged(default_params, param_set)
        accuracy_list = []
        for run in range(final_params.num_runs_val):
            agent = agents[final_params.agent](final_params)
            agent.eval_mesh = fan_out_mesh(default_params)
            state = agent.init_state(final_params.seed + 1000 + run)
            tmp_acc = []
            for x_train, y_train, labels in tune_data:
                state = train_for_eval(agent, state, x_train, y_train)
                tmp_acc.append(agent.evaluate(state, tune_test_loaders))
            print("-----------tune run {}-----------avg_end_acc {}-----------"
                  .format(run, np.mean(tmp_acc[-1])))
            accuracy_list.append(np.array(tmp_acc))
        avg_end_acc, *_ = compute_performance(np.array(accuracy_list))
        tune_accs.append(avg_end_acc[0])
    return grid[int(np.argmax(tune_accs))]


def _best_agent(default_params, best, run):
    final_params = _merged(default_params, best)
    agent = agents[final_params.agent](final_params)
    agent.eval_mesh = fan_out_mesh(default_params)
    return agent, agent.init_state(final_params.seed + run)


def single_tune(data_continuum, default_params, tune_params, params_keep, tmp_acc, run):
    """Tune on the first num_val tasks, then train the rest of the stream
    with the best point (reference experiment/run.py:238-305); appends the
    accuracies on the later tasks' test sets to `tmp_acc`."""
    device = torch.device(default_params.device)
    test_loaders_full = rank_test_loaders(data_continuum.test_data(), default_params, device)
    tune_test_loaders = test_loaders_full[: default_params.num_val]
    test_loaders = test_loaders_full[default_params.num_val:]

    if default_params.online:
        tune_data = []
        agent = state = None
        for i, (x_train, y_train, labels) in enumerate(data_continuum):
            if i < default_params.num_val:
                tune_data.append((x_train, y_train, labels))
                if len(tune_data) == default_params.num_val:
                    best = tune_hyper(tune_data, tune_test_loaders, default_params, tune_params)
                    params_keep.append(best)
                    print("Tuning is done. Best hyper parameter set is {}".format(best))
                    agent, state = _best_agent(default_params, best, run)
            else:
                state = train_for_eval(agent, state, x_train, y_train)
                tmp_acc.append(agent.evaluate(state, test_loaders))
    else:
        xs, ys, tx, ty = [], [], [], []
        for i, (x_train, y_train, labels) in enumerate(data_continuum):
            if i < default_params.num_val:
                tx.append(x_train)
                ty.append(y_train)
            else:
                xs.append(x_train)
                ys.append(y_train)
        tune_data = [(np.concatenate(tx), np.concatenate(ty), None)]
        best = tune_hyper(tune_data, tune_test_loaders, default_params, tune_params)
        params_keep.append(best)
        print("Tuning is done. Best hyper parameter set is {}".format(best))
        agent, state = _best_agent(default_params, best, run)
        state = train_for_eval(agent, state, np.concatenate(xs), np.concatenate(ys))
        tmp_acc.append(agent.evaluate(state, test_loaders))


def single_tune_train_val(data_continuum, default_params, tune_params, params_keep,
                          tmp_acc, run):
    """Tune on the first num_val tasks, then restart the run and train on the
    whole stream (reference experiment/run.py:309-375)."""
    device = torch.device(default_params.device)
    test_loaders_full = rank_test_loaders(data_continuum.test_data(), default_params, device)
    tune_test_loaders = test_loaders_full[: default_params.num_val]
    tune_data = []
    best = None
    for i, (x_train, y_train, labels) in enumerate(data_continuum):
        if i >= default_params.num_val:
            break
        tune_data.append((x_train, y_train, labels))
        if len(tune_data) == default_params.num_val:
            best = tune_hyper(tune_data, tune_test_loaders, default_params, tune_params)
            params_keep.append(best)
            print("Tuning is done. Best hyper parameter set is {}".format(best))
            break
    data_continuum.reset_run()
    agent, state = _best_agent(default_params, best or {}, run)
    for x_train, y_train, labels in data_continuum:
        state = train_for_eval(agent, state, x_train, y_train)
        tmp_acc.append(agent.evaluate(state, test_loaders_full))


def multiple_run_tune_separate(default_params, tune_params, save_path):
    """Tune every run separately; pickle {seed, time, acc_array, ram,
    best_params} under config/global.yml's result path (reference
    experiment/run.py:180-236)."""
    from ocl_tpu_torch.config import apply_runtime_flags

    check_supported(default_params)
    ranks = start_ranks(multiple_run_tune_separate, default_params, tune_params, save_path)
    if ranks is not None:
        return ranks[0]
    mesh = fan_out_mesh(default_params)
    lead = mesh is None or mesh.rank == 0
    apply_runtime_flags(default_params)
    start = time.time()
    print("Setting up data stream")
    data_continuum = continuum(default_params.data, default_params.cl_type, default_params)
    if default_params.num_val == -1:
        default_params.num_val = data_continuum.data_object.task_nums

    result_path = load_yaml("config/global.yml", key="path")["result"]
    table_path = os.path.join(result_path + default_params.data, default_params.cl_type)
    for name, on in default_params.trick.items():
        if on:
            table_path = os.path.join(result_path + default_params.data,
                                      default_params.cl_type, name)
            break
    print(table_path)
    if lead:
        os.makedirs(table_path, exist_ok=True)
    if not save_path:
        save_path = "{}_{}_{}.pkl".format(
            getattr(default_params, "model_name", default_params.agent),
            getattr(default_params, "data_name", default_params.data),
            default_params.seed)

    accuracy_list = []
    params_keep = []
    run_list = (range(default_params.num_runs) if isinstance(default_params.num_runs, int)
                else default_params.num_runs)
    np.random.seed(default_params.seed)
    for run in run_list:
        tmp_acc = []
        run_start = time.time()
        data_continuum.new_run()
        if getattr(default_params, "train_val", False):
            single_tune_train_val(data_continuum, default_params, tune_params,
                                  params_keep, tmp_acc, run)
        else:
            single_tune(data_continuum, default_params, tune_params,
                        params_keep, tmp_acc, run)
        print("-----------run {}-----------avg_end_acc {}-----------train time {}"
              .format(run, np.mean(tmp_acc[-1]), time.time() - run_start))
        accuracy_list.append(np.array(tmp_acc))

    end = time.time()
    result = {
        "seed": default_params.seed,
        "time": end - start,
        "acc_array": np.array(accuracy_list),
        "ram": check_ram_usage(),
        "best_params": params_keep,
    }
    if lead:
        with open(os.path.join(table_path, save_path), "wb") as f:
            pickle.dump(result, f)
    print("----------- Total {} run: {}s -----------".format(default_params.num_runs,
                                                             end - start))
    print("----------- Seed {} RAM: {}s -----------".format(default_params.seed, result["ram"]))
    return result


def multiple_run_tune(default_params, tune_params, save_path):
    """Tune on the first num_val tasks, then train the rest, with a CSV
    table of a row a run and a final row under config/global.yml's tables
    path, rewritten after every run (reference experiment/run.py:92-176)."""
    from ocl_tpu_torch.config import apply_runtime_flags

    check_supported(default_params)
    ranks = start_ranks(multiple_run_tune, default_params, tune_params, save_path)
    if ranks is not None:
        return ranks[0]
    mesh = fan_out_mesh(default_params)
    lead = mesh is None or mesh.rank == 0
    apply_runtime_flags(default_params)
    start = time.time()
    print("Setting up data stream")
    data_continuum = continuum(default_params.data, default_params.cl_type, default_params)

    table_path = load_yaml("config/global.yml", key="path")["tables"] + default_params.data
    if lead:
        os.makedirs(table_path, exist_ok=True)
    if not save_path:
        save_path = "{}_{}.csv".format(
            getattr(default_params, "model_name", default_params.agent),
            getattr(default_params, "data_name", default_params.data))

    rows = []
    accuracy_list = []
    params_keep = []
    np.random.seed(default_params.seed)
    for run in range(default_params.num_runs):
        tmp_acc = []
        run_start = time.time()
        data_continuum.new_run()
        single_tune(data_continuum, default_params, tune_params, params_keep, tmp_acc, run)
        run_end = time.time()
        print("-----------run {}-----------avg_end_acc {}-----------train time {}"
              .format(run, np.mean(tmp_acc[-1]), run_end - run_start))
        accuracy_list.append(np.array(tmp_acc))

        row = {"Run": run}
        row.update(params_keep[-1])
        for i, a in enumerate(tmp_acc[-1]):
            row["Batch" + str(i + default_params.num_val)] = a
        row["Avg_End_Acc"] = np.mean(tmp_acc[-1])
        row["Avg_End_Fgt"] = single_run_avg_end_fgt(np.array(tmp_acc))
        row["Time"] = run_end - run_start
        rows.append(row)
        if lead:
            save_csv(rows, table_path, save_path)

    avg_end_acc, avg_end_fgt, avg_acc, avg_bwtp, avg_fwt = compute_performance(
        np.array(accuracy_list))
    end = time.time()
    rows.append({"Run": "Final Result", "Avg_End_Acc": avg_end_acc,
                 "Avg_End_Fgt": avg_end_fgt, "Time": end - start})
    if lead:
        save_csv(rows, table_path, save_path)
    print("----------- Total {} run: {}s -----------".format(default_params.num_runs, end - start))
    print("----------- Avg_End_Acc {} Avg_End_Fgt {} Avg_Acc {} Avg_Bwtp {} Avg_Fwt {}-----------"
          .format(avg_end_acc, avg_end_fgt, avg_acc, avg_bwtp, avg_fwt))
    return avg_end_acc
