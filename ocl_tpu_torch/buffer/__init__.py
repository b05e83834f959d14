"""Buffer strategy registry and dispatch (counterpart of ocl_tpu/buffer/__init__.py).

`build_update` and `build_retrieve` return a `Strategy`:
`draw(generator, batch)` makes the random draws one call consumes, as a dict
of tensors, and `run` consumes them:

  retrieve.run(model, buf, batch_x, batch_y, draws, grads=None)
      -> (mem_x, mem_y, mem_mask)
  update.run(model, buf, batch_x, batch_y, draws) -> replaced slots [batch]

`grads` maps parameter names to the incoming batch's gradients; MIR needs
them for its virtual step, the other retrievals ignore them. MIR's scoring
forward folds its subsample's BN statistics into the live model, as
ocl_tpu's retrieval returns them. Updates change `buf` in place. Tests hand
both packages the same draws by building the dict themselves.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ocl_tpu_torch.buffer.reservoir import reservoir_update
from ocl_tpu_torch.buffer.retrieve import gumbel, random_retrieve


class Strategy(NamedTuple):
    draw: Callable[[torch.Generator, int], dict]
    run: Callable


def _no_draws(generator, batch):
    return {}


def build_update(agent) -> Strategy:
    name = agent.params.update
    device = agent.device
    if agent.params.mem_size == 0:
        def update(model, buf, x, y, draws):
            return torch.full((x.shape[0],), -1, device=x.device)

        return Strategy(_no_draws, update)
    if name == "random":
        def draw(generator, batch):
            return {"u": torch.rand(batch, generator=generator, device=device)}

        def update(model, buf, x, y, draws):
            return reservoir_update(buf, x, y, draws["u"])

        return Strategy(draw, update)
    if name == "GSS":
        from ocl_tpu_torch.buffer.gss import build_gss_update

        return build_gss_update(agent)
    if name == "ASER":
        from ocl_tpu_torch.buffer.aser import build_aser_update

        return build_aser_update(agent)
    raise NotImplementedError("update method {!r} is not ported yet".format(name))


def build_retrieve(agent) -> Strategy:
    name = agent.params.retrieve
    k = agent.params.eps_mem_batch
    device = agent.device
    mem_size = agent.params.mem_size
    if k == 0 or mem_size == 0:
        # finetune baseline (reference config_CVPR/agent/er/finetune.yml:
        # mem_size 0, eps_mem_batch 0): retrieval is always empty, a 1-wide
        # all-masked slice
        def retrieve(model, buf, x, y, draws, grads=None):
            return (torch.zeros((1,) + buf.imgs.shape[1:], device=x.device),
                    torch.zeros((1,), dtype=torch.int64, device=x.device),
                    torch.zeros((1,), dtype=torch.bool, device=x.device))

        return Strategy(_no_draws, retrieve)
    if name == "random":
        def draw(generator, batch):
            return {"g": gumbel((mem_size,), generator, device)}

        def retrieve(model, buf, x, y, draws, grads=None):
            mx, my, _, mask = random_retrieve(buf, k, draws["g"])
            return mx, my, mask

        return Strategy(draw, retrieve)
    if name == "MIR":
        from ocl_tpu_torch.buffer.mir import build_mir_retrieve

        return build_mir_retrieve(agent)
    if name == "ASER":
        from ocl_tpu_torch.buffer.aser import build_aser_retrieve

        return build_aser_retrieve(agent)
    if name == "match":
        from ocl_tpu_torch.buffer.match import build_match_retrieve

        return build_match_retrieve(agent)
    if name == "mem_match":
        from ocl_tpu_torch.buffer.match import build_mem_match_retrieve

        return build_mem_match_retrieve(agent)
    raise NotImplementedError("retrieve method {!r} is not ported yet".format(name))
