"""The grid tuner's points stacked: every (grid point, val run) pair one point
of a `StackedState`, `agent.stacked_step` on each shared batch, as
`experiment/parallel_tune.py` and `stacked_train_task` run them. The grid
points of val run r share that run's initial weights and draws (a lane);
each point has its own lr and weight decay."""

from __future__ import annotations

import itertools
from types import SimpleNamespace

import torch

from oclbench import inputs
from oclbench.loops import BaseLoop, RanOutOfTasks, buffer_record, grad_of, norms
from oclbench.reference import er
from oclbench.reference.replay import Start


class Loop(BaseLoop):
    reference_step = staticmethod(er.fused_step)

    def setup(self, fault=None):
        from ocl_tpu_torch.agents.base import stack_ctx
        from ocl_tpu_torch.config import apply_runtime_flags, merge_yaml_params
        from ocl_tpu_torch.experiment.parallel_run import _stack
        from ocl_tpu_torch.registry import agents

        self.stack_ctx = stack_ctx
        recipe = self.config["recipe"]
        grid = self.config["grid"]
        keys = sorted(grid)
        combos = [dict(zip(keys, c)) for c in itertools.product(*(grid[k] for k in keys))]
        runs = int(recipe["num_runs_val"])
        params = merge_yaml_params(recipe, combos[0], device=str(self.device), verbose=False)
        apply_runtime_flags(params)
        self.agent = agent = agents[params.agent](params)
        if not agent.fused:
            raise ValueError("the stacked loop's reference is the fused ER step")
        self.batch = params.batch
        points = [(g, r) for g in range(len(combos)) for r in range(runs)]
        stream = inputs.Stream(self.config, self.arch, self.seeds, self.device)
        self.lap("agent")
        self.tasks = [stream.task(t) for t in range(self.n_tasks(self.batch))]
        self.lap("stream")
        w0 = inputs.weights(self.arch, self.seeds["weights"], runs, self.device)
        states = [agent.init_state(self.seeds["port"] + r) for r in range(runs)]
        self.lap("state")
        b0 = states[0].buffer
        start_buf = self.fill_buffer(b0, stream)   # every lane's buffer alike
        del stream
        for s in states[1:]:
            for name in ("slot_imgs", "slot_labels", "slot_score", "class_counts"):
                getattr(s.buffer, name).copy_(getattr(b0, name))
            s.buffer.current_index, s.buffer.n_seen_so_far = b0.current_index, b0.n_seen_so_far
        self.lap("fill")
        lr = [float(combos[g]["learning_rate"]) for g, _ in points]
        wd = [float(combos[g]["weight_decay"]) for g, _ in points]
        self.ss = ss = _stack([states[r] for _, r in points], lr=lr, wd=wd)
        del states
        self.lap("stack")
        self.points = ss.points
        self.images_per_step = self.batch * self.points
        lanes = ss.lane
        with torch.no_grad():
            for n in self.names:
                ss.model.params[n].copy_(torch.stack([w0[lanes[p]][n] for p in range(self.points)]))
            for n, b in ss.model.buffers.items():
                b.fill_(0.0 if n.endswith("running_mean") else 1.0)
        self.shuffle = SimpleNamespace(generator=inputs.generator(self.device, self.seeds["shuffle"]))
        self.task = -1
        self.begin_task(0)
        self.lap("batchify")
        self.undo = fault(self) if fault is not None else None
        self.record, steps = self.checked_steps(self.traffic["checked_steps"], w0)
        self.lap("checked_steps")
        self.start = Start(weights=w0, buffer=start_buf,
                           points=[(lanes[p], lr[p], wd[p]) for p in range(self.points)],
                           steps=steps)
        for _ in range(self.traffic["warmup_steps"]):
            self.step()
        self.lap("warmup")

    def checked_steps(self, n, w0):
        agent, ss = self.agent, self.ss
        gens = [inputs.generator(self.device, self.seeds["draws"] + r)
                for r in range(len(ss.generators))]
        lane_idx = ss.lane_index()
        losses, buffers, steps = [], [], []
        for t in range(n):
            xb, yb = self.xs[:, self.i], self.ys[:, self.i]
            trees = [agent.draw(g, self.batch) for g in gens]
            draws = torch.utils._pytree.tree_map(lambda *xs: torch.stack(xs), *trees)
            if lane_idx is not None:
                draws = torch.utils._pytree.tree_map(lambda v: v[lane_idx], draws)
            loss, _ = agent.stacked_step(ss, self.sctx, xb, yb, draws)
            self.i += 1
            losses.append(loss.detach())
            buffers.append(buffer_record(ss.buffer.imgs, ss.buffer.labels, ss.buffer.class_counts))
            steps.append((xb[0].clone(), yb[0].clone(), dict(enumerate(trees))))
            if t == 0:
                grad1 = norms([grad_of(ss.model.params[name]) for name in self.names])
                change1 = self.change(w0)
        record = {"loss": torch.stack(losses).double().cpu(), "grad1": grad1, "change1": change1,
                  "change3": self.change(w0), "buffer": buffers}
        return record, steps

    def change(self, w0):
        """[P, L] norms of each point's change from its lane's weights w0."""
        lanes = self.ss.lane
        return norms([self.ss.model.params[name] - torch.stack([w0[lanes[p]][name]
                                                                for p in range(self.points)])
                      for name in self.names])

    def begin_task(self, t):
        if t >= len(self.tasks):
            raise RanOutOfTasks("the window reached task {} of the {} made".format(
                t, len(self.tasks)))
        x, y = self.tasks[t]
        agent = self.agent
        self.ctx = agent.before_train(y)
        self.sctx = self.stack_ctx(self.ctx, self.points)
        self.ss = agent.before_task_stacked(self.ss)
        with self.range("batchify"):
            xs, ys = agent.batchify(self.shuffle, x, y)
        self.xs, self.ys = xs.expand(self.points, *xs.shape), ys.expand(self.points, *ys.shape)
        self.task, self.i = t, 0

    def step(self):
        if self.i == self.xs.shape[1]:
            with self.range("task_boundary"):
                self.ss = self.agent.after_train_stacked(self.ss, self.ctx)
                self.begin_task(self.task + 1)
        self.last = self.agent.stacked_step(self.ss, self.sctx, self.xs[:, self.i],
                                            self.ys[:, self.i])
        self.i += 1

    def finish(self):
        last = getattr(self, "last", None)
        if last is not None:
            self.failed += int((~torch.isfinite(last[0].detach().cpu())).sum())
        return self.failed

    def free(self):
        self.ss = self.agent = self.xs = self.ys = self.tasks = self.ctx = self.sctx = None
        self.last = None
