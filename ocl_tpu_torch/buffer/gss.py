"""GSS-Greedy buffer update (counterpart of ocl_tpu/buffer/gss.py; reference
utils/buffer/gss_greedy_update.py).

Scoring runs the model in eval mode (the reference calls model.eval()), so
BN uses its running statistics and per-sample gradients are exact: they are
`torch.func.vmap(torch.func.grad(...))` over `functional_forward`, flattened
in the order of `model.named_parameters()`.

While the buffer fills, each incoming item is written to the next slot with
its score, the max cosine between its gradient and a bank of
`gss_mem_strength` memory-batch gradients (0.1 while the buffer is empty).
Once it is full, a step replaces only where the batch gradient points
against memory, max_i <grad(L_i), g_batch> < 0 (the reference's
``batch_sim < 0``; the sign of the max cosine is that of the max dot). The
dots are one forward-mode `torch.func.jvp` of the bank batches' losses in the
batch-gradient direction, so the bank is built only on steps that replace.
That gate is a branch on device data: it costs one host read a full-buffer
step, the step's only one. Under vmap (stacked runs, agents/base.py::
point_map) each point has its own gate and the host cannot read it: every
point builds the bank and its gate masks its writes, which replaces exactly
where the branch would. Candidate slots are drawn in proportion to their
normalised score (Gumbel top-k on log w), and a candidate is replaced with
probability b/(s+b), s = (item_sim+1)/2, b = (slot_score+1)/2.

Draws: "bank" [mem_size] Gumbel noise for the bank batches, "cand"
[mem_size] Gumbel noise for the candidates, "coin" [batch] uniforms
(ocl_tpu's r_bank, r_cand, r_coin).
"""

from __future__ import annotations

import torch
from torch.func import grad, jvp, vmap

from ocl_tpu_torch.buffer.retrieve import gumbel, sample_slots, top_k_indices
from ocl_tpu_torch.buffer.state import valid_mask, write_slots
from ocl_tpu_torch.models import functional_forward
from ocl_tpu_torch.ops.losses import NEG_INF, cross_entropy


def _cosine_rows(a, b, eps=1e-8):
    """cos(a_i, b_j) for a [N, D], b [M, D] (reference buffer_utils.py:50-55)."""
    na = a.norm(dim=1, keepdim=True)
    nb = b.norm(dim=1, keepdim=True)
    return (a @ b.T) / torch.clamp(na * nb.T, min=eps)


def _flatten(tree, lead: int):
    return torch.cat([g.reshape(lead, -1) for g in tree.values()], dim=1)


def build_gss_update(agent):
    from ocl_tpu_torch.buffer import Strategy

    strength = int(agent.params.gss_mem_strength)
    gss_bsz = int(agent.params.gss_batch_size)
    mem_size = int(agent.params.mem_size)
    device = agent.device

    def draw(generator, batch):
        return {"bank": gumbel((mem_size,), generator, device),
                "cand": gumbel((mem_size,), generator, device),
                "coin": torch.rand(batch, generator=generator, device=device)}

    def ce_eval(model, params, x, y, mask=None):
        return cross_entropy(functional_forward(model, params, x), y, mask=mask)

    def sample_bank_batches(buf, g):
        """The `strength` random memory batches the bank is built from. A bank
        larger than the buffer (which ocl_tpu's top-k refuses) is padded with
        masked rows."""
        n = strength * gss_bsz
        idx, elem_mask = sample_slots(g, valid_mask(buf), min(n, buf.mem_size))
        if n > buf.mem_size:
            idx = torch.cat([idx, idx.new_zeros(n - buf.mem_size)])
            elem_mask = torch.cat([elem_mask, elem_mask.new_zeros(n - buf.mem_size)])
        xs, ys = buf.take(idx)
        xs = xs.reshape(strength, gss_bsz, *xs.shape[1:])
        ys = ys.reshape(strength, gss_bsz)
        ms = elem_mask.reshape(strength, gss_bsz)
        return xs, ys, ms, ms.any(1)

    def mem_grad_bank(model, params, xs, ys, ms):
        """[strength, D] gradients of the sampled memory batches."""
        g = vmap(grad(lambda p, x, y, m: ce_eval(model, p, x, y, m)),
                 in_dims=(None, 0, 0, 0))(params, xs, ys, ms)
        return _flatten(g, xs.shape[0])

    def bank_dots(model, params, xs, ys, ms, direction):
        """<grad(L_i), direction> for each bank batch i, by one jvp
        (`direction` is a dict shaped like `params`)."""
        def losses(p):
            return vmap(lambda x, y, m: ce_eval(model, p, x, y, m))(xs, ys, ms)

        return jvp(losses, (params,), (direction,))[1]

    def per_sample_sims(model, params, bank, row_valid, x, y):
        """Max over valid bank rows of cos(bank row, grad of sample i) -> [B]."""
        g = vmap(grad(lambda p, xi, yi: ce_eval(model, p, xi[None], yi[None])),
                 in_dims=(None, 0, 0))(params, x, y)
        sim = _cosine_rows(bank, _flatten(g, x.shape[0]))     # [strength, B]
        return torch.where(row_valid[:, None], sim, NEG_INF).amax(0)

    def full_branch(model, params, buf, x, y, draws):
        batch = x.shape[0]
        xs, ys, ms, row_valid = sample_bank_batches(buf, draws["bank"])
        bgrad = grad(lambda p: ce_eval(model, p, x, y))(params)
        dots = bank_dots(model, params, xs, ys, ms, bgrad)
        gate = torch.where(row_valid, dots, NEG_INF).amax() < 0
        if torch._C._functorch.is_batchedtensor(gate):
            pass   # one gate a point: it masks the writes below
        elif not bool(gate):   # the one host read of a full-buffer step
            return
        else:
            gate = None
        bank = mem_grad_bank(model, params, xs, ys, ms)
        score = buf.score
        w = (score - score.min()) / (score.max() - score.min() + 0.01)
        keys = torch.log(torch.clamp(w, min=1e-30)) + draws["cand"]
        cand = top_k_indices(keys, batch)
        item_sim = per_sample_sims(model, params, bank, row_valid, x, y)
        s = (item_sim + 1.0) / 2.0
        b = (score[cand] + 1.0) / 2.0
        repl = draws["coin"] < b / (s + b)
        if gate is not None:
            repl = repl & gate
        new_score = torch.where(repl, item_sim, score[cand])
        write_slots(buf, cand, x, y, repl)
        buf.write_score(cand, new_score)

    def fill_branch(model, params, buf, x, y, draws):
        batch = x.shape[0]
        cur = buf.current_index
        offset = min(buf.mem_size - cur, batch)
        if cur == 0:
            scores = torch.full((batch,), 0.1, device=x.device)
        else:
            xs, ys, ms, row_valid = sample_bank_batches(buf, draws["bank"])
            bank = mem_grad_bank(model, params, xs, ys, ms)
            scores = per_sample_sims(model, params, bank, row_valid, x, y)
        pos = torch.arange(batch, device=x.device)
        write = pos < offset
        write_slots(buf, cur + pos, x, y, write)
        buf.write_score(cur + pos, scores, write)
        buf.current_index = cur + offset

    def update(model, buf, x, y, draws):
        params = {n: p.detach() for n, p in model.named_parameters()}
        if buf.current_index >= buf.mem_size:
            full_branch(model, params, buf, x, y, draws)
        else:
            fill_branch(model, params, buf, x, y, draws)
        return torch.full((x.shape[0],), -1, device=x.device)

    # internals, for the test that holds the jvp gate against the bank
    update.sample_bank_batches = sample_bank_batches
    update.mem_grad_bank = mem_grad_bank
    update.bank_dots = bank_dots
    update.ce_eval = ce_eval
    return Strategy(draw, update)
