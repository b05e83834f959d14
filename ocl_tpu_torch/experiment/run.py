"""Experiment runner (counterpart of ocl_tpu/experiment/run.py), online mode.

multiple_run: a fresh agent and state per run; tasks stream through
agent.train_learner, and every task's test set is evaluated after each
task. Prints the same metric lines as ocl_tpu, ending with the
`----------- Avg_End_Acc ...` line.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ocl_tpu_torch.data import continuum, prepare_test_loaders
from ocl_tpu_torch.experiment.metrics import compute_performance
from ocl_tpu_torch.registry import agents

# flags of ocl_tpu's runner whose subsystems are not ported yet, with the
# value that asks for nothing from them
_NOT_PORTED = {"online": True, "store": False, "ckpt_dir": None,
               "parallel_runs": False, "buffer_tracker": False}


def _check_supported(params):
    for flag, ok in _NOT_PORTED.items():
        if getattr(params, flag, ok) != ok:
            raise NotImplementedError("--{} {} is not ported yet".format(
                flag, getattr(params, flag)))
    if params.agent not in agents:
        raise NotImplementedError("agent {!r} is not ported yet; available: {}".format(
            params.agent, ", ".join(sorted(agents))))


def multiple_run(params):
    from ocl_tpu_torch.config import apply_runtime_flags

    _check_supported(params)
    apply_runtime_flags(params)
    device = torch.device(params.device)
    start = time.time()
    print("Setting up data stream")
    data_continuum = continuum(params.data, params.cl_type, params)
    print("data setup time: {}".format(time.time() - start))

    np.random.seed(params.seed)
    accuracy_list = []
    for run in range(params.num_runs):
        tmp_acc = []
        run_start = time.time()
        data_continuum.new_run()
        agent = agents[params.agent](params)
        state = agent.init_state(params.seed + run)
        test_loaders = prepare_test_loaders(data_continuum.test_data(), params, device)
        n_images, train_seconds = 0, 0.0
        for i, (x_train, y_train, labels) in enumerate(data_continuum):
            if params.verbose:
                print("-----------run {} training batch {}-------------".format(run, i))
                print("size: {}, {}".format(x_train.shape, y_train.shape))
            t0 = time.time()
            state = agent.train_learner(state, x_train, y_train)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            train_seconds += time.time() - t0
            n_images += (x_train.shape[0] // params.batch) * params.batch
            tmp_acc.append(agent.evaluate(state, test_loaders))
        run_end = time.time()
        print("-----------run {}-----------avg_end_acc {}-----------train time {}"
              .format(run, np.mean(tmp_acc[-1]), run_end - run_start))
        print("-----------run {} stream throughput {:.1f} images/sec-----------".format(
            run, n_images / train_seconds if train_seconds else 0.0))
        accuracy_list.append(np.array(tmp_acc))

    accuracy_array = np.array(accuracy_list)
    end = time.time()
    avg_end_acc, avg_end_fgt, avg_acc, avg_bwtp, avg_fwt = compute_performance(accuracy_array)
    print("----------- Total {} run: {}s -----------".format(params.num_runs, end - start))
    print("----------- Avg_End_Acc {} Avg_End_Fgt {} Avg_Acc {} Avg_Bwtp {} Avg_Fwt {}-----------"
          .format(avg_end_acc, avg_end_fgt, avg_acc, avg_bwtp, avg_fwt))
    return avg_end_acc, avg_end_fgt, avg_acc, avg_bwtp, avg_fwt
