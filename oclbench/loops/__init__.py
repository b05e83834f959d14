"""The loops that drive the port through a cell. A traffic file names its
loop (`"loop"`), and the harness finds it by that name as the module
`oclbench/loops/<loop>.py`, whose class `Loop` subclasses `BaseLoop`:
`online` (one run, `agent.step` a batch, as `ContinualLearner.train_task`
calls it) and `stacked_tune` (the grid tuner's points stacked,
`agent.stacked_step` a batch, as `stacked_train_task` calls it). A loop
sets `reference_step`, the reference's step (oclbench/reference/) that
replays its checked steps; a new schedule is a new loop file with its
reference step beside it.

A loop's `setup` builds the port's state from the benchmark's inputs, runs
the checked steps through the window's own call with the benchmark's
draws, records what they produced (`record`, reference/judge.py's layout)
and what the reference starts from (`start`), and warms up. Set-up first
fills the buffer with task 0's classes to the traffic's `free_slots` short
of full; `step` runs one
window step, crossing a task boundary where the task ends; `finish` reads
back what the port reads back after a task; `free` drops the port's state.
"""

from __future__ import annotations

import contextlib
import math
import time

import torch

from oclbench import inputs
from oclbench.reference import model as M
from oclbench.reference.er import fingerprint


class RanOutOfTasks(RuntimeError):
    pass


class BaseLoop:
    def __init__(self, config: dict, traffic: dict, seed: int, device, seconds: float):
        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.arch = arch_of(config)
        self.seeds = inputs.part_seeds(seed)
        self.seconds = seconds
        self.names = [n for n, _, _, _ in M.leaves(self.arch)]
        self.failed = 0
        self.ranges = False
        self.split = {}
        self._t = time.perf_counter()

    def lap(self, name):
        """Seconds since the last lap of set-up, under `name`."""
        now = time.perf_counter()
        self.split[name] = now - self._t
        self._t = now

    def n_tasks(self, batch: int) -> int:
        """Tasks the window can reach at the traffic's highest step rate."""
        steps = (self.traffic["checked_steps"] + self.traffic["warmup_steps"]
                 + math.ceil(self.traffic["max_steps_per_s"] * self.seconds) + 1)
        per_task = self.config["classes_per_task"] * self.config["train_per_class"]
        return min(self.config["tasks"], math.ceil(steps * batch / per_task))

    def fill_buffer(self, buf, stream):
        """Fills the port's buffer `buf` to the traffic's `free_slots` short
        of full; returns the reference's start buffer (x [mem + 1, ...],
        y [mem + 1], cur, seen)."""
        from ocl_tpu_torch.buffer.state import write_slots

        x0, y0 = torch.zeros_like(buf.slot_imgs), torch.zeros_like(buf.slot_labels)
        n = buf.mem_size - self.traffic["free_slots"]
        fx, fy = stream.fill(n)
        write_slots(buf, torch.arange(n, device=self.device), fx, fy,
                    torch.ones(n, dtype=torch.bool, device=self.device))
        buf.current_index = buf.n_seen_so_far = n
        x0[:n], y0[:n] = fx, fy
        return x0, y0, n, n

    def range(self, name):
        return torch.profiler.record_function(name) if self.ranges else contextlib.nullcontext()

    @contextlib.contextmanager
    def instrumented(self):
        """Ranges for the traced block: the distance kernel's launches (with
        their shapes) and, where the agent runs ASER, its retrieval and
        update."""
        from ocl_tpu_torch.ops import distance

        launch = distance._launch

        def k1_launch(a, b, out, n, m, d, points):
            with torch.profiler.record_function("k1:{}x{}x{}x{}".format(n, m, d, points)):
                return launch(a, b, out, n, m, d, points)

        agent = self.agent
        saved = agent.retrieve, agent.update
        if agent.params.retrieve == "ASER":
            agent.retrieve = saved[0]._replace(run=ranged("aser.retrieve", saved[0].run))
        if agent.params.update == "ASER":
            agent.update = saved[1]._replace(run=ranged("aser.update", saved[1].run))
        distance._launch = k1_launch
        self.ranges = True
        try:
            yield
        finally:
            distance._launch = launch
            agent.retrieve, agent.update = saved
            self.ranges = False

    def load_weights(self, model, w):
        """The benchmark's initial weights into a port model, by name; BN
        running statistics at mean 0, variance 1."""
        named = dict(model.named_parameters())
        if set(named) != set(self.names):
            raise RuntimeError("the port's model and the reference differ in the leaves {}".format(
                sorted(set(named) ^ set(self.names))))
        with torch.no_grad():
            for n in self.names:
                named[n].copy_(w[n])
            for n, b in model.named_buffers():
                b.fill_(0.0 if n.endswith("running_mean") else 1.0)


def arch_of(config: dict) -> dict:
    """The reference model's sizes from a configuration file."""
    return {k: config[k] for k in ("nf", "image_size", "channels", "classes")}


def ranged(name, fn):
    def run(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return run


def grad_of(p):
    """The gradient the optimizer got for `p`: zeros where a step left none."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


def norms(tensors):
    """[P, L] float64 norms of [P, ...] tensors, one column a leaf."""
    return torch.stack([t.detach().flatten(1).double().norm(dim=1) for t in tensors], 1).cpu()


def buffer_record(imgs, labels, counts, chunk=8):
    """(fingerprints [P, mem], labels [P, mem], class counts [P, C]) of a
    [P, mem, ...] buffer."""
    fp = torch.cat([fingerprint(imgs[i: i + chunk]) for i in range(0, imgs.shape[0], chunk)])
    return fp, labels.clone(), counts.clone()
