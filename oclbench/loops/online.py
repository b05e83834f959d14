"""One online run: `agent.step` on each batch of a task, as
`ContinualLearner.train_task` runs it, the losses read back once a task."""

from __future__ import annotations

import torch

from oclbench import inputs
from oclbench.loops import BaseLoop, RanOutOfTasks, buffer_record, grad_of, norms
from oclbench.reference import er
from oclbench.reference.replay import Start


class Loop(BaseLoop):
    points = 1

    def setup(self, fault=None):
        from ocl_tpu_torch.config import apply_runtime_flags, merge_yaml_params
        from ocl_tpu_torch.registry import agents

        params = merge_yaml_params(self.config["recipe"], device=str(self.device), verbose=False)
        apply_runtime_flags(params)
        self.agent = agent = agents[params.agent](params)
        if self.device.type == "cuda" and "ASER" in (params.update, params.retrieve):
            from ocl_tpu_torch.ops._build import load_library

            load_library("pairwise_sqdist.cu")   # K1: built at a checkout's first run
        self.lap("agent_k1_load")
        self.reference_step = er.aser_step if agent.aser_mode and not agent.mir else \
            er.fused_step if agent.fused else None
        if self.reference_step is None:
            raise ValueError("no reference for this ER schedule")
        self.batch = params.batch
        self.images_per_step = self.batch
        stream = inputs.Stream(self.config, self.arch, self.seeds, self.device)
        self.tasks = [stream.task(t) for t in range(self.n_tasks(self.batch))]
        self.lap("stream")
        w0 = inputs.weights(self.arch, self.seeds["weights"], 1, self.device)
        self.state = agent.init_state(self.seeds["port"])
        self.load_weights(self.state.model, w0[0])
        self.lap("state")
        start_buf = self.fill_buffer(self.state.buffer, stream)
        del stream
        self.lap("fill")
        self.task = -1
        self.begin_task(0)
        self.lap("batchify")
        self.undo = fault(self) if fault is not None else None
        self.record, steps = self.checked_steps(self.traffic["checked_steps"], w0[0])
        self.lap("checked_steps")
        self.start = Start(weights=w0, buffer=start_buf,
                           points=[(0, float(params.learning_rate), float(params.weight_decay))],
                           steps=steps)
        for _ in range(self.traffic["warmup_steps"]):
            self.step()
        self.lap("warmup")

    def checked_steps(self, n, w0):
        """n steps through `agent.step` with the benchmark's draws, recording
        each step's loss, what it retrieved and the buffer it left, the first
        gradient and the change of the weights."""
        agent, state = self.agent, self.state
        g = inputs.generator(self.device, self.seeds["draws"])
        retrieved, buffers, losses, steps = [], [], [], []
        retrieve, update = agent.retrieve, agent.update

        def recorded_retrieve(model, buf, x, y, draws, grads=None):
            out = retrieve.run(model, buf, x, y, draws, grads=grads)
            retrieved.append((er.fingerprint(out[0]), out[1].clone(), out[2].clone()))
            return out

        def recorded_update(model, buf, x, y, draws):
            out = update.run(model, buf, x, y, draws)
            buffers.append(buffer_record(buf.imgs[None], buf.labels[None], buf.class_counts[None]))
            return out

        agent.retrieve = retrieve._replace(run=recorded_retrieve)
        agent.update = update._replace(run=recorded_update)
        try:
            for t in range(n):
                xb, yb = self.xs[self.i], self.ys[self.i]
                draws = agent.draw(g, self.batch)
                out = agent.step(state, self.ctx, xb, yb, draws)
                self.task_losses.append(out)
                self.i += 1
                losses.append(out[0].detach().reshape(1))
                steps.append((xb.clone(), yb.clone(), {0: draws}))
                if t == 0:
                    grad1 = norms([grad_of(p)[None] for _, p in self.named_params()])
                    change1 = norms([(p - w0[n])[None] for n, p in self.named_params()])
        finally:
            agent.retrieve, agent.update = retrieve, update
        change = norms([(p - w0[n])[None] for n, p in self.named_params()])
        record = {"loss": torch.stack(losses).double().cpu(), "grad1": grad1, "change1": change1,
                  "change3": change,
                  "buffer": buffers, "retrieved": retrieved}
        return record, steps

    def named_params(self):
        named = dict(self.state.model.named_parameters())
        return [(n, named[n]) for n in self.names]

    def begin_task(self, t):
        if t >= len(self.tasks):
            raise RanOutOfTasks("the window reached task {} of the {} made".format(
                t, len(self.tasks)))
        x, y = self.tasks[t]
        self.ctx = self.agent.before_train(y)
        with self.range("batchify"):
            self.xs, self.ys = self.agent.batchify(self.state, x, y)
        self.task, self.i, self.task_losses = t, 0, []

    def read_losses(self):
        """The task's one readback of (loss, accuracy), as train_task makes
        it; counts the steps whose loss is not finite."""
        if self.task_losses:
            loss = torch.stack([torch.stack(la) for la in self.task_losses]).T.cpu()[0]
            self.failed += int((~torch.isfinite(loss)).sum())
        self.task_losses = []

    def step(self):
        if self.i == self.xs.shape[0]:
            with self.range("task_boundary"):
                self.read_losses()
                self.agent.after_train(self.state, self.ctx)
                self.begin_task(self.task + 1)
        self.task_losses.append(self.agent.step(self.state, self.ctx, self.xs[self.i],
                                                self.ys[self.i]))
        self.i += 1

    def finish(self):
        self.read_losses()
        return self.failed

    def free(self):
        self.state = self.agent = self.xs = self.ys = self.tasks = self.ctx = None
