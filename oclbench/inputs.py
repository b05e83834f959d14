"""The benchmark's inputs, made from `--seed` on the device: class templates,
the stream's tasks, the images that fill the buffer, the weights and the
draws of the checked steps.

An image is its class's template (uniform in [0, 1]) plus Gaussian noise,
clipped and quantised to whole multiples of 1/255, as the datasets' uint8
pixels are after the port's loaders divide them; a task holds
`train_per_class` images of each of its classes. Each stream of draws has a
generator of its own, seeded from a SeedSequence of the run's seed, so one
part can change its draws without moving another's.
"""

from __future__ import annotations

import numpy as np
import torch

from oclbench.reference import model as M

PARTS = ("templates", "order", "tasks", "fill", "weights", "draws", "shuffle", "port")


def part_seeds(seed: int) -> dict:
    """A 63-bit seed for each part of the inputs from any whole `seed`."""
    words = np.random.SeedSequence(abs(int(seed)) * 2 + (seed < 0)).generate_state(
        2 * len(PARTS), dtype=np.uint32)
    return {p: (int(words[2 * i]) << 31) ^ int(words[2 * i + 1]) for i, p in enumerate(PARTS)}


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def images(g, templates, labels, noise: float):
    t = templates[labels]
    x = t + noise * torch.randn(t.shape, generator=g, device=t.device)
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0) / 255.0


class Stream:
    """The seeded class-incremental stream of one run: task t holds the
    classes order[t * k: (t + 1) * k], each `train_per_class` times."""

    def __init__(self, data: dict, arch: dict, seeds: dict, device):
        self.data, self.arch, self.device = data, arch, device
        size, c = arch["image_size"], arch["channels"]
        self.templates = torch.rand((arch["classes"], size, size, c),
                                    generator=generator(device, seeds["templates"]), device=device)
        self.order = torch.randperm(arch["classes"], generator=generator(device, seeds["order"]),
                                    device=device)
        self.g_tasks = generator(device, seeds["tasks"])
        self.g_fill = generator(device, seeds["fill"])

    def task_classes(self, t: int):
        k = self.data["classes_per_task"]
        return self.order[t * k: (t + 1) * k]

    def task(self, t: int):
        """Task t as the continuum hands it to a learner: host float32 NHWC
        images and int64 labels."""
        labels = self.task_classes(t).repeat_interleave(self.data["train_per_class"])
        x = images(self.g_tasks, self.templates, labels, self.data["noise"])
        return x.cpu().numpy(), labels.cpu().numpy()

    def fill(self, n: int):
        """n images of task 0's classes in turn, on the device: what a
        buffer holds after the stream's first n images."""
        cls = self.task_classes(0)
        labels = cls[torch.arange(n, device=self.device) % cls.shape[0]]
        return images(self.g_fill, self.templates, labels, self.data["noise"]), labels


def weights(arch: dict, seed: int, lanes: int, device) -> list:
    """`lanes` sets of initial parameters (reference/model.py's leaves and
    init), each from one uniform draw on the device."""
    g = generator(device, seed)
    n = M.random_elements(arch)
    return [M.weights_from_uniform(arch, torch.rand(n, generator=g, device=device))
            for _ in range(lanes)]
