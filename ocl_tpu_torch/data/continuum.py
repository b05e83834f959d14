"""Task-stream iterator over a dataset object (counterpart of
ocl_tpu/data/continuum.py).

Iterate to get (x_train, y_train, labels) per task; `new_run()` re-shuffles
the task composition and resets the cursor; `reset_run()` rewinds without
re-shuffling; `test_data()` returns the per-task test sets.
"""

from __future__ import annotations

from ocl_tpu_torch.registry import data_objects


class continuum:
    """Stream of `task_nums` tasks drawn from a registered dataset."""

    def __init__(self, dataset, scenario, params):
        if dataset not in data_objects:
            raise ValueError(
                "unknown dataset {!r}; available: {}".format(
                    dataset, ", ".join(sorted(data_objects))))
        self.data_object = data_objects[dataset](scenario, params)
        self.task_nums = self.data_object.task_nums
        self.run = params.num_runs
        self.cur_run = -1
        self._cursor = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._cursor >= self.task_nums:
            raise StopIteration
        task = self.data_object.new_task(self._cursor, cur_run=self.cur_run)
        self._cursor += 1
        return task

    def new_run(self):
        """Advance to the next run: fresh task composition, cursor to zero."""
        self._cursor = 0
        self.cur_run += 1
        self.data_object.new_run(cur_run=self.cur_run)

    def reset_run(self):
        """Rewind the current run's stream without recomposing tasks."""
        self._cursor = 0

    def test_data(self):
        return self.data_object.get_test_set()

    def clean_mem_test_set(self):
        self.data_object.clean_mem_test_set()

    @property
    def cur_task(self):
        return self._cursor
