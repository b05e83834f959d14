"""Continual-learning metrics, bit-compatible with the reference definitions
(counterpart of ocl_tpu/experiment/metrics.py).

Inputs are accuracy tensors `acc[r, t, j]` = accuracy on task j's test set
after training task t in run r (lower-triangular for online runs). Each
aggregate returns (mean over runs, 95% t-interval half-width) exactly as the
reference computes them (reference experiment/metrics.py:5-54).
"""

from __future__ import annotations

import numpy as np
from scipy import stats as sps


def _ci95(per_run: np.ndarray, n_run: int):
    t_coef = sps.t.ppf(0.975, n_run - 1)
    return float(np.mean(per_run)), t_coef * sps.sem(per_run)


def avg_end_accuracy(acc):
    """Mean accuracy over all tasks after the final task."""
    return np.mean(acc[:, -1, :], axis=1)


def avg_end_forgetting(acc):
    """Mean over tasks of (best accuracy ever − final accuracy)."""
    return np.mean(np.max(acc, axis=1) - acc[:, -1, :], axis=1)


def avg_accuracy(acc):
    """Running mean of lower-triangular accuracies (ACC over the stream)."""
    n_tasks = acc.shape[1]
    running = np.sum(np.tril(acc), axis=2) / (np.arange(n_tasks) + 1)
    return np.mean(running, axis=1)


def bwt_plus(acc):
    """Positive part of backward transfer: accuracy gained on old tasks."""
    n_tasks = acc.shape[1]
    pairs = n_tasks * (n_tasks - 1) / 2
    below_diag = np.sum(np.tril(acc, -1), axis=(1, 2))
    diag_weighted = np.sum(
        np.diagonal(acc, axis1=1, axis2=2) * (np.arange(n_tasks, 0, -1) - 1),
        axis=1)
    return np.maximum((below_diag - diag_weighted) / pairs, 0)


def fwt(acc):
    """Forward transfer: accuracy on not-yet-seen tasks."""
    n_tasks = acc.shape[1]
    pairs = n_tasks * (n_tasks - 1) / 2
    return np.sum(np.triu(acc, 1), axis=(1, 2)) / pairs


def compute_performance(end_task_acc_arr):
    """(Avg_End_Acc, Avg_End_Fgt, Avg_Acc, Avg_Bwtp, Avg_Fwt), each with CI."""
    acc = np.asarray(end_task_acc_arr)
    n_run = acc.shape[0]
    return tuple(_ci95(metric(acc), n_run) for metric in (
        avg_end_accuracy, avg_end_forgetting, avg_accuracy, bwt_plus, fwt))


def single_run_avg_end_fgt(acc_array):
    """Avg_End_Fgt of one run's accuracy matrix [t, j] (the tuner's CSV)."""
    acc = np.asarray(acc_array)
    return np.mean(np.max(acc, axis=1) - acc[-1])
