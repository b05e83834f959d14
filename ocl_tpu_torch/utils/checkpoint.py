"""Checkpoint and crash-resume of a run's whole train state (counterpart of
ocl_tpu/utils/checkpoint.py, with `torch.save` in place of orbax).

A checkpoint directory holds two files:

* `state_r{run}_t{task}.pt`: every piece of the TrainState as tensors and
  Python values (`pack_state`): the model's and the optimizer's state
  dicts, the buffer's tensors and counters, the agent state (a teacher as
  its state dict), the device generator's state and the host
  `random.Random`'s. It is loaded with `weights_only=True`, which accepts
  exactly these types (torch >= 2.6 loads so by default);
* `meta.pkl`: the host metadata (task cursor, the accuracy rows so far and
  the agent's bookkeeping, `snapshot_agent_meta`), a plain pickle because
  it holds numpy arrays, which a weights-only load refuses. It names its
  state file, and is written last, so a crash mid-save leaves the previous
  checkpoint whole.

A state is restored into a fresh one built from the same params and seed:
tensors are copied into the target's (device and memory layout kept), the
generator and host states are set, and counters replaced.
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np
import torch

from ocl_tpu_torch.buffer.state import BufferState

META_FILE = "meta.pkl"
_BUFFER_TENSORS = ("slot_imgs", "slot_labels", "slot_score", "class_counts")
_MODULE = "__module_state_dict__"

# the agent's host-side bookkeeping that lives across tasks
_AGENT_LISTS = ("old_labels", "new_labels_zombie", "error_list", "new_class_score",
                "old_class_score", "fc_norm_new", "fc_norm_old", "bias_norm_new",
                "bias_norm_old")
_AGENT_DICTS = ("class_task_map", "compact", "mem_c")


def _pack(obj):
    """A module as its state dict, containers recursively, the rest as is."""
    if isinstance(obj, torch.nn.Module):
        return {_MODULE: obj.state_dict()}
    if isinstance(obj, torch.optim.Optimizer):
        return obj.state_dict()
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    return obj


def _restore(target, saved):
    """`saved` (from _pack) into `target`, a fresh value of the same
    structure: modules, optimizers and tensors in place (on the target's
    device), dicts key by key; returns the restored value."""
    if isinstance(target, torch.nn.Module):
        target.load_state_dict(saved[_MODULE])
        return target
    if isinstance(target, torch.optim.Optimizer):
        target.load_state_dict(saved)
        return target
    if isinstance(target, torch.Tensor):
        with torch.no_grad():
            target.copy_(saved)     # raises on a shape mismatch
        return target
    if isinstance(target, dict):
        for k, v in saved.items():
            target[k] = _restore(target.get(k), v)
        return target
    return saved


def pack_state(state) -> dict:
    """Every piece of a TrainState as tensors and Python values."""
    buf = state.buffer
    return {
        "model": state.model.state_dict(),
        "optimizer": _pack(state.optimizer),
        "buffer": None if buf is None else dict(
            {k: getattr(buf, k) for k in _BUFFER_TENSORS},
            current_index=buf.current_index, n_seen_so_far=buf.n_seen_so_far),
        "agent": _pack(state.agent),
        "generator": state.generator.get_state(),
        "host": None if state.host is None else state.host.getstate(),
    }


def restore_state(state, saved: dict):
    """`saved` (from pack_state) into `state`, a fresh TrainState of the same
    params; returns it."""
    state.model.load_state_dict(saved["model"])
    state.optimizer = _restore(state.optimizer, saved["optimizer"])
    if saved["buffer"] is not None:
        buf: BufferState = state.buffer
        for k in _BUFFER_TENSORS:
            _restore(getattr(buf, k), saved["buffer"][k])
        buf.current_index = saved["buffer"]["current_index"]
        buf.n_seen_so_far = saved["buffer"]["n_seen_so_far"]
    state.agent = _restore(state.agent, saved["agent"])
    state.generator.set_state(saved["generator"])
    if saved["host"] is not None:
        state.host.setstate(saved["host"])
    return state


def _bits(t):
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def mismatches(a, b, path="state") -> list:
    """Where two packed states (or parts of them) differ: a list of paths,
    empty when every tensor is bit for bit equal (dtype and shape included)
    and every other value equal."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        same = isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and \
            a.dtype == b.dtype and a.shape == b.shape and torch.equal(_bits(a), _bits(b))
        return [] if same else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        if list(a) != list(b):
            return [path + " (keys)"]
        return [m for k in a for m in mismatches(a[k], b[k], "{}.{}".format(path, k))]
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [path + " (length)"]
        return [m for i, (x, y) in enumerate(zip(a, b))
                for m in mismatches(x, y, "{}[{}]".format(path, i))]
    return [] if a == b else [path]


def save_checkpoint(path: str, state, host_meta: dict | None = None):
    """Write the TrainState and the host metadata (`run` and `task` name
    the state file); then drop the directory's older state files."""
    meta = dict(host_meta or {})
    os.makedirs(path, exist_ok=True)
    name = "state_r{}_t{}.pt".format(meta.get("run", 0), meta.get("task", 0))
    tmp = os.path.join(path, name + ".tmp")
    torch.save(pack_state(state), tmp)
    os.replace(tmp, os.path.join(path, name))
    meta["state_file"] = name
    tmp = os.path.join(path, META_FILE + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(meta, f)
    os.replace(tmp, os.path.join(path, META_FILE))
    for old in glob.glob(os.path.join(path, "state_r*_t*.pt")):
        if os.path.basename(old) != name:
            os.remove(old)


def read_meta(path: str) -> dict:
    with open(os.path.join(path, META_FILE), "rb") as f:
        return pickle.load(f)


def load_state_file(path: str, meta: dict) -> dict:
    """The packed state that `meta` names, on the CPU."""
    return torch.load(os.path.join(path, meta["state_file"]), map_location="cpu",
                      weights_only=True)


def load_checkpoint(path: str, target_state):
    """Restore (state, host_meta); `target_state` is a fresh TrainState of
    the same params, restored in place."""
    meta = read_meta(path)
    return restore_state(target_state, load_state_file(path, meta)), meta


def snapshot_agent_meta(agent) -> dict:
    """The agent's bookkeeping kept on the agent object across tasks: the
    label lists and maps, iCaRL's compact labels, the --error_analysis
    lists, and GDumb's memory (images as numpy arrays). ocl_tpu's snapshot
    leaves GDumb's memory out, so its resumed GDumb retrains from the
    memory of the tasks after the checkpoint only."""
    meta = {"task_seen": agent.task_seen}
    for name in _AGENT_LISTS:
        if hasattr(agent, name):
            meta[name] = list(getattr(agent, name))
    for name in _AGENT_DICTS:
        if hasattr(agent, name):
            meta[name] = dict(getattr(agent, name))
    if hasattr(agent, "mem_img"):
        meta["mem_img"] = {c: [np.array(x) for x in imgs] for c, imgs in agent.mem_img.items()}
    return meta


def restore_agent_meta(agent, meta: dict):
    agent.task_seen = int(meta.get("task_seen", 0))
    for name in _AGENT_LISTS:
        if name in meta:
            setattr(agent, name, list(meta[name]))
    for name in _AGENT_DICTS + ("mem_img",):
        if name in meta:
            setattr(agent, name, dict(meta[name]))
