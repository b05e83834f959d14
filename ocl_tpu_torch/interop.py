"""Weights between ocl_tpu pytrees and the port's state dict.

`from_jax(params, batch_stats)` turns the pytrees of ocl_tpu's ResNets
(Reduced ResNet-18, ResNet18-152, SupConResNet; numpy leaves, e.g. after
`jax.tree_util.tree_map(np.asarray, ...)`) into a state dict for
`ocl_tpu_torch.models.resnet.ResNet` or `SupConResNet`; `to_jax` does the
reverse. A block's flax submodules are named by kind and order: a
BasicBlock's Conv3x3_0, Conv3x3_1 and Conv1x1_0 (the shortcut), a
Bottleneck's Conv1x1_0, Conv3x3_0, Conv1x1_1 and Conv1x1_2 (the shortcut),
each followed by its BatchNorm_<i>; a Bottleneck is told by its `conv3`
(Conv1x1_1). Conv kernels go HWIO <-> OIHW and Dense kernels [in, out] <->
Linear weights [out, in]. SupConResNet's trunk sits under `encoder` in both
(without a `linear`: ocl_tpu never calls the encoder's head, so Flax never
creates it), and its head's Dense layers are `head_layers_<i>` in ocl_tpu
and `head_layers.<i>` here.

Feature order: the port flattens pooled features in NHWC order, as the JAX
package does, so the Dense kernel needs only the transpose. A torch model
that flattens NCHW (the original reference) orders features (C, h, w)
instead; at 32x32 the trunk pools to one cell and the two orders agree, but
an 84- or 128-pixel input pools to 2x2 / 4x4 cells, and weights from such a
model need their input columns permuted from (C, h, w) to (h, w, C).

`agent_from_jax` / `agent_to_jax` carry an agent's state (the distillation
teacher, EWC's parameter-shaped trees and flags), and `adam_from_jax` /
`adam_to_jax` carry Adam's moments and step count, between optax's
`ScaleByAdamState` (count, mu, nu) and torch.optim.Adam's per-parameter
`step`, `exp_avg`, `exp_avg_sq`.

`stacked_from_jax` / `stacked_to_jax` and `stacked_agent_from_jax` /
`stacked_agent_to_jax` carry a stacked state (ocl_tpu's vmapped
TrainState, every leaf [P, ...]) point by point through the functions
above, to the port's `models.Stacked` and stacked agent dict and back.

`ndpm_from_jax` / `ndpm_to_jax` carry CN-DPM's mixture (the stacked `vae`
and `cls` trees and the dummy expert) between ocl_tpu's pytree and the
state dict of `ocl_tpu_torch.models.ndpm.NDPM`: convs HWIO -> OIHW, the
decoder's transposed convs HWIO -> (I, O, kh, kw) flipped along H and W, and
`enc3_w`'s rows and `dec3_w`'s columns (and `dec3_b`) from (h, w, C) to
(C, h, w) order; dense kernels stay [in, out]. `cndpm_state_from_jax` /
`cndpm_state_to_jax` carry its agent dict and per-slot optimizer state.

`buffer_shards_from_jax` / `buffer_from_shards` carry a slot-sharded
buffer (parallel/sharded_buffer.py): ocl_tpu's BufferState (numpy leaves)
maps to W ranks' slices of slots [r M / W, (r + 1) M / W), each with the
replicated counters and class counts, and the ranks' slices join back into
ocl_tpu's whole buffer.
"""

from __future__ import annotations

import numpy as np
import torch

# EWC's parameter-shaped trees in ocl_tpu's agent state
_PARAM_TREES = ("prev_params", "running_fisher", "tmp_fisher", "normalized_fisher")
_FLAGS = ("has_teacher", "has_prev")

# JAX submodule of a stage block <-> port attribute, by block kind
_BLOCK_MODS = {
    "basic": {"Conv3x3_0": "conv1", "Conv3x3_1": "conv2", "Conv1x1_0": "short_conv",
              "BatchNorm_0": "bn1", "BatchNorm_1": "bn2", "BatchNorm_2": "short_bn"},
    "bottleneck": {"Conv1x1_0": "conv1", "Conv3x3_0": "conv2", "Conv1x1_1": "conv3",
                   "Conv1x1_2": "short_conv", "BatchNorm_0": "bn1", "BatchNorm_1": "bn2",
                   "BatchNorm_2": "bn3", "BatchNorm_3": "short_bn"},
}
_BLOCK_MODS_INV = {kind: {v: k for k, v in mods.items()} for kind, mods in _BLOCK_MODS.items()}
# BatchNorm leaves: port name <-> (JAX tree, JAX leaf)
_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("stats", "mean"), "running_var": ("stats", "var")}
_BN_LEAVES_INV = {v: k for k, v in _BN_LEAVES.items()}


def _bottlenecks(keys, sep: str) -> set:
    """Names of the Bottleneck blocks among state-dict keys (sep ".", the
    port's "stages.<s>.<b>") or JAX paths joined by "/" ("stages_<s>_<b>")."""
    mark = ".conv3." if sep == "." else "/Conv1x1_1/"
    return {k.split(mark)[0].split(sep)[-1] if sep == "/" else
            ".".join(k.split(mark)[0].split(".")[-3:]) for k in keys if mark in k}


def _jax_entry(key: str, bottlenecks=frozenset()):
    """Port state-dict key -> (JAX tree 'params' or 'stats', path, kind).
    `bottlenecks` names the port's Bottleneck blocks ("stages.<s>.<b>")."""
    parts = key.split(".")
    if parts[0] == "encoder":
        tree, path, kind = _jax_entry(key[len("encoder."):], bottlenecks)
        return tree, ("encoder",) + path, kind
    if parts[0] == "head_layers":
        leaf = "kernel" if parts[2] == "weight" else "bias"
        return "params", ("head_layers_" + parts[1], "Dense_0", leaf), \
            "dense" if leaf == "kernel" else "plain"
    if parts[0] == "stages":
        block = "bottleneck" if ".".join(parts[:3]) in bottlenecks else "basic"
        prefix = ("stages_{}_{}".format(parts[1], parts[2]), _BLOCK_MODS_INV[block][parts[3]])
        mod, leaf = parts[3], parts[4]
    else:
        prefix, mod, leaf = (parts[0],), parts[0], parts[1]
    if mod == "linear":
        return "params", ("linear", "Dense_0", "kernel" if leaf == "weight" else "bias"), \
            "dense" if leaf == "weight" else "plain"
    if "conv" in mod:
        return "params", prefix + ("Conv_0", "kernel"), "conv"
    tree, jleaf = _BN_LEAVES[leaf]
    return tree, prefix + (jleaf,), "plain"


def _port_key(tree: str, path: tuple, bottlenecks=frozenset()) -> str:
    """Inverse of `_jax_entry`; `bottlenecks` names the JAX Bottleneck blocks
    ("stages_<s>_<b>")."""
    if path[0] == "encoder":
        return "encoder." + _port_key(tree, path[1:], bottlenecks)
    if path[0].startswith("head_layers_"):
        return "head_layers.{}.{}".format(path[0][len("head_layers_"):],
                                          "weight" if path[-1] == "kernel" else "bias")
    if path[0] == "linear":
        return "linear." + ("weight" if path[-1] == "kernel" else "bias")
    if path[0].startswith("stages_"):
        _, s, b = path[0].split("_")
        block = "bottleneck" if path[0] in bottlenecks else "basic"
        prefix = "stages.{}.{}.{}".format(s, b, _BLOCK_MODS[block][path[1]])
    else:
        prefix = path[0]
    if path[-1] == "kernel":
        return prefix + ".weight"
    return prefix + "." + _BN_LEAVES_INV[(tree, path[-1])]


def _to_torch(value, kind):
    a = np.asarray(value, np.float32)
    if kind == "conv":
        a = np.transpose(a, (3, 2, 0, 1))   # HWIO -> OIHW
    elif kind == "dense":
        a = a.T                             # [in, out] -> [out, in]
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _to_numpy(t, kind):
    a = t.detach().cpu().numpy()
    if kind == "conv":
        a = np.transpose(a, (2, 3, 1, 0))   # OIHW -> HWIO
    elif kind == "dense":
        a = a.T
    return np.ascontiguousarray(a).copy()


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def from_jax(params, batch_stats) -> dict:
    """ocl_tpu (params, batch_stats) pytrees -> port state dict."""
    jax_blocks = _bottlenecks(["/".join(p) for p, _ in _leaves(params)], "/")
    sd = {}
    for tree, leaves in (("params", params), ("stats", batch_stats)):
        for path, value in _leaves(leaves):
            sd[_port_key(tree, path, jax_blocks)] = value
    blocks = _bottlenecks(sd, ".")
    return {key: _to_torch(value, _jax_entry(key, blocks)[2]) for key, value in sd.items()}


def to_jax(state_dict) -> tuple[dict, dict]:
    """Port state dict -> ocl_tpu (params, batch_stats) pytrees of numpy arrays."""
    out = {"params": {}, "stats": {}}
    blocks = _bottlenecks(state_dict, ".")
    for key, value in state_dict.items():
        tree, path, kind = _jax_entry(key, blocks)
        node = out[tree]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _to_numpy(value, kind)
    return out["params"], out["stats"]


def agent_from_jax(ag, model) -> dict:
    """ocl_tpu agent pytree (numpy leaves) -> the port's agent state for
    `model`: a frozen teacher copy of `model` with the teacher's weights and
    statistics, EWC's trees as dicts by parameter name, flags as 0-d float
    tensors, `step_in_task` as an int."""
    from ocl_tpu_torch.models import snapshot

    device = next(model.parameters()).device
    out = {}
    if "teacher_params" in ag:
        teacher = snapshot(model)
        teacher.load_state_dict(from_jax(ag["teacher_params"], ag["teacher_stats"]))
        out["teacher"] = teacher
    for name in _PARAM_TREES:
        if name in ag:
            out[name] = {k: v.to(device) for k, v in from_jax(ag[name], {}).items()}
    for name in _FLAGS:
        if name in ag:
            out[name] = torch.tensor(float(np.asarray(ag[name])), device=device)
    if "step_in_task" in ag:
        out["step_in_task"] = int(np.asarray(ag["step_in_task"]))
    return out


def agent_to_jax(agent) -> dict:
    """The port's agent state -> ocl_tpu's agent pytree of numpy arrays."""
    out = {}
    if "teacher" in agent:
        out["teacher_params"], out["teacher_stats"] = to_jax(agent["teacher"].state_dict())
    for name in _PARAM_TREES:
        if name in agent:
            out[name] = to_jax(agent[name])[0]
    for name in _FLAGS:
        if name in agent:
            out[name] = np.float32(agent[name].item())
    if "step_in_task" in agent:
        out["step_in_task"] = np.int32(agent["step_in_task"])
    return out


def adam_from_jax(count, mu, nu, optimizer, model) -> None:
    """Set torch Adam's state for `model`'s parameters from optax's
    ScaleByAdamState fields (count [], mu and nu params-shaped trees)."""
    mu, nu = from_jax(mu, {}), from_jax(nu, {})
    for name, p in model.named_parameters():
        optimizer.state[p] = {"step": torch.tensor(float(np.asarray(count))),
                              "exp_avg": mu[name].to(p.device),
                              "exp_avg_sq": nu[name].to(p.device)}


def adam_to_jax(optimizer, model) -> dict:
    """torch Adam's state -> {"count", "mu", "nu"} as optax's
    ScaleByAdamState holds them (numpy leaves)."""
    named = list(model.named_parameters())
    states = [optimizer.state[p] for _, p in named]
    return {"count": np.int32(int(states[0]["step"])),
            "mu": to_jax({n: s["exp_avg"] for (n, _), s in zip(named, states)})[0],
            "nu": to_jax({n: s["exp_avg_sq"] for (n, _), s in zip(named, states)})[0]}


# ----------------------------------------------------------------- stacked


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _points(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.asarray(tree).shape[0]


def _point(tree, p):
    """Point p of a pytree of [P, ...] numpy leaves."""
    return _tree_map(lambda a: np.asarray(a)[p], tree)


def _stack_numpy(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_numpy([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(t) for t in trees])


def stacked_from_jax(params, batch_stats, model):
    """ocl_tpu's stacked (params, batch_stats) (numpy leaves [P, ...]) ->
    `models.Stacked` of copies of `model` holding each point's weights."""
    import copy

    from ocl_tpu_torch.models import stack_models

    models = []
    for p in range(_points(params)):
        m = copy.deepcopy(model)
        m.load_state_dict(from_jax(_point(params, p), _point(batch_stats, p)))
        models.append(m)
    return stack_models(models)


def stacked_to_jax(stacked) -> tuple[dict, dict]:
    """`models.Stacked` -> ocl_tpu's stacked (params, batch_stats), numpy
    leaves [P, ...]."""
    trees = [to_jax({**{k: v[p] for k, v in stacked.params.items()},
                     **{k: v[p] for k, v in stacked.buffers.items()}})
             for p in range(stacked.points)]
    return _stack_numpy([t[0] for t in trees]), _stack_numpy([t[1] for t in trees])


def stacked_agent_from_jax(ag, model) -> dict:
    """ocl_tpu's stacked agent pytree (numpy leaves [P, ...]) -> the port's
    stacked agent dict (as experiment/parallel_run.py::_stack builds it)."""
    from ocl_tpu_torch.experiment.parallel_run import _stack_agent

    return _stack_agent([agent_from_jax(_point(ag, p), model) for p in range(_points(ag))])


def stacked_agent_to_jax(agent) -> dict:
    """The port's stacked agent dict -> ocl_tpu's stacked agent pytree."""
    from ocl_tpu_torch.models import Stacked

    points = []
    p_count = next(v.points if isinstance(v, Stacked) else v.shape[0]
                   for v in agent.values() if isinstance(v, (Stacked, torch.Tensor)))
    for p in range(p_count):
        one = {}
        for k, v in agent.items():
            if isinstance(v, Stacked):
                one[k] = v.point(p)
            elif isinstance(v, torch.Tensor):
                one[k] = v[p]
            elif isinstance(v, dict):
                one[k] = {n: t[p] for n, t in v.items()}
            else:
                one[k] = v
        points.append(agent_to_jax(one))
    return _stack_numpy(points)


# ------------------------------------------------------------------ CN-DPM

_NDPM_CONV = ("enc1_w", "enc2_w", "l0_w")
_NDPM_DECONV = ("dec2_w", "dec1_w")


def _ndpm_kind(name):
    if name in _NDPM_CONV or (name.startswith("l") and name.endswith(("c1_w", "c2_w", "ds_w"))):
        return "conv"
    if name in _NDPM_DECONV:
        return "deconv"
    if name in ("enc3_w", "dec3_w", "dec3_b"):
        return name
    return "plain"


def _cells(rows, channels):
    """Side of the square (h, w) grid of `rows` = h * w * channels."""
    side = int(round((rows // channels) ** 0.5))
    assert side * side * channels == rows, (rows, channels)
    return side


def _ndpm_leaf_from_jax(name, a, tree):
    """One stacked leaf [K, ...] of ocl_tpu's layout -> the port's."""
    kind = _ndpm_kind(name)
    K = a.shape[0]
    if kind == "conv":
        return np.transpose(a, (0, 4, 3, 1, 2))
    if kind == "deconv":
        return np.transpose(a, (0, 3, 4, 1, 2))[..., ::-1, ::-1]
    if kind == "enc3_w":       # rows (h, w, 2 Cv) -> (2 Cv, h, w)
        c = 2 * tree["enc2_w"].shape[-2]
        s = _cells(a.shape[1], c)
        return a.reshape(K, s, s, c, -1).transpose(0, 3, 1, 2, 4).reshape(a.shape)
    if kind == "dec3_w":       # columns (h, w, 2 nfb) -> (2 nfb, h, w)
        c = tree["dec2_w"].shape[-2]
        s = _cells(a.shape[2], c)
        return a.reshape(K, -1, s, s, c).transpose(0, 1, 4, 2, 3).reshape(a.shape)
    if kind == "dec3_b":
        c = tree["dec2_w"].shape[-2]
        s = _cells(a.shape[1], c)
        return a.reshape(K, s, s, c).transpose(0, 3, 1, 2).reshape(a.shape)
    return a


def _ndpm_leaf_to_jax(name, a, tree):
    """Inverse of `_ndpm_leaf_from_jax`; `tree` holds the port's leaves."""
    kind = _ndpm_kind(name)
    K = a.shape[0]
    if kind == "conv":
        return np.transpose(a, (0, 3, 4, 2, 1))
    if kind == "deconv":
        return np.transpose(a[..., ::-1, ::-1], (0, 3, 4, 1, 2))
    if kind == "enc3_w":
        c = 2 * tree["enc2_w"].shape[2]
        s = _cells(a.shape[1], c)
        return a.reshape(K, c, s, s, -1).transpose(0, 2, 3, 1, 4).reshape(a.shape)
    if kind == "dec3_w":
        c = tree["dec2_w"].shape[1]
        s = _cells(a.shape[2], c)
        return a.reshape(K, -1, c, s, s).transpose(0, 1, 3, 4, 2).reshape(a.shape)
    if kind == "dec3_b":
        c = tree["dec2_w"].shape[1]
        s = _cells(a.shape[1], c)
        return a.reshape(K, c, s, s).transpose(0, 2, 3, 1).reshape(a.shape)
    return a


def _ndpm_tree(tree, convert, stacked=True):
    """Convert every leaf of one flat CN-DPM tree (a dummy's, unstacked,
    through a leading axis of 1); `convert` reads shapes from the tree."""
    ref = tree if stacked else {k: np.asarray(v)[None] for k, v in tree.items()}
    out = {}
    for name, value in tree.items():
        a = np.asarray(value, np.float32)
        a = convert(name, a if stacked else a[None], ref)
        out[name] = np.ascontiguousarray(a if stacked else a[0])
    return out


def ndpm_from_jax(params) -> dict:
    """ocl_tpu's CN-DPM pytree (numpy leaves) -> state dict of `NDPM`."""
    sd = {}
    for part, tree, stacked in (("vae", params["vae"], True), ("cls", params["cls"], True),
                                ("dummy_vae", params["dummy"]["vae"], False),
                                ("dummy_cls", params["dummy"]["cls"], False)):
        for name, a in _ndpm_tree(tree, _ndpm_leaf_from_jax, stacked).items():
            sd[part + "." + name] = torch.from_numpy(a.copy())
    return sd


def ndpm_to_jax(state_dict) -> dict:
    """State dict of `NDPM` -> ocl_tpu's CN-DPM pytree of numpy arrays."""
    parts = {}
    for key, value in state_dict.items():
        part, name = key.split(".")
        parts.setdefault(part, {})[name] = value.detach().cpu().numpy()
    conv = {part: _ndpm_tree(tree, _ndpm_leaf_to_jax, not part.startswith("dummy"))
            for part, tree in parts.items()}
    return {"vae": conv["vae"], "cls": conv["cls"],
            "dummy": {"vae": conv["dummy_vae"], "cls": conv["dummy_cls"]}}


def _opt_part_from_jax(opt, device):
    if not opt:
        return {}
    return {"m": {k: torch.from_numpy(v.copy()).to(device)
                  for k, v in _ndpm_tree(opt["m"], _ndpm_leaf_from_jax).items()},
            "v": {k: torch.from_numpy(v.copy()).to(device)
                  for k, v in _ndpm_tree(opt["v"], _ndpm_leaf_from_jax).items()},
            "t": torch.tensor(np.asarray(opt["t"]), dtype=torch.int64, device=device)}


def _opt_part_to_jax(opt):
    if not opt:
        return {}
    m = {k: v.cpu().numpy() for k, v in opt["m"].items()}
    v = {k: t.cpu().numpy() for k, t in opt["v"].items()}
    return {"m": _ndpm_tree(m, _ndpm_leaf_to_jax), "v": _ndpm_tree(v, _ndpm_leaf_to_jax),
            "t": opt["t"].cpu().numpy().astype(np.int32)}


def cndpm_state_from_jax(ag, opt_state, device="cpu"):
    """ocl_tpu's CN-DPM agent dict and opt_state ({"g", "d"}, each {m, v, t}
    under Adam, {} under SGD; numpy leaves) -> the port's (agent dict,
    optimizer dict). `active`, `stm_count` and `saturated_sleeps` become
    Python ints; `eval_seed` is the port's own and is left out."""
    agent = {
        "log_counts": torch.tensor(np.asarray(ag["log_counts"], np.float32), device=device),
        "active": int(np.asarray(ag["active"])),
        "stm_x": torch.tensor(np.asarray(ag["stm_x"], np.float32), device=device),
        "stm_y": torch.tensor(np.asarray(ag["stm_y"]), dtype=torch.int64, device=device),
        "stm_count": int(np.asarray(ag["stm_count"])),
        "saturated_sleeps": int(np.asarray(ag["saturated_sleeps"])),
        "sched_t": torch.tensor(np.asarray(ag["sched_t"]), dtype=torch.int64, device=device),
    }
    opt = {part: _opt_part_from_jax(opt_state[part], device) for part in ("g", "d")}
    return agent, opt


def cndpm_state_to_jax(agent, opt):
    """The port's CN-DPM (agent dict, optimizer dict) -> ocl_tpu's agent
    dict and opt_state of numpy arrays."""
    ag = {"log_counts": agent["log_counts"].cpu().numpy(),
          "active": np.int32(agent["active"]),
          "stm_x": agent["stm_x"].cpu().numpy(),
          "stm_y": agent["stm_y"].cpu().numpy().astype(np.int32),
          "stm_count": np.int32(agent["stm_count"]),
          "saturated_sleeps": np.int32(agent["saturated_sleeps"]),
          "sched_t": agent["sched_t"].cpu().numpy().astype(np.int32)}
    return ag, {part: _opt_part_to_jax(opt[part]) for part in ("g", "d")}


_SLOT_LEAVES = ("imgs", "labels", "score")
_REPLICATED = ("current_index", "n_seen_so_far", "class_counts")


def buffer_shards_from_jax(buf, world_size: int) -> list:
    """ocl_tpu's BufferState (numpy leaves, or an object with those
    attributes) -> each rank's shard as a dict: `imgs`, `labels`, `score`
    of its slots and the replicated `current_index`, `n_seen_so_far`,
    `class_counts`. M must be a multiple of W."""
    mem = np.asarray(buf.labels).shape[0]
    if mem % world_size:
        raise ValueError("{} buffer slots cannot be split over {} ranks: {} is not a multiple "
                         "of {}".format(mem, world_size, mem, world_size))
    per = mem // world_size
    whole = {k: np.asarray(getattr(buf, k)) for k in _SLOT_LEAVES + _REPLICATED}
    return [dict({k: whole[k][r * per:(r + 1) * per] for k in _SLOT_LEAVES},
                 **{k: whole[k] for k in _REPLICATED}) for r in range(world_size)]


def buffer_from_shards(shards: list) -> dict:
    """The ranks' shards (as buffer_shards_from_jax gives them, in rank
    order) -> ocl_tpu's whole buffer as a dict of numpy leaves."""
    out = {k: np.concatenate([np.asarray(s[k]) for s in shards]) for k in _SLOT_LEAVES}
    out.update({k: np.asarray(shards[0][k]) for k in _REPLICATED})
    return out
