"""Checkpoint and resume of fitted scene parameters.

Counterpart of `ray_tracer_tpu/opt/checkpoint.py` with its npz backend:
`<dir>/step_N/` (or `<dir>/latest/`) holds `meta.json` and `state.npz`,
whose `p_i` arrays are the SceneParams leaves in field order with the
absent (None) fields skipped, and whose `o_i` arrays are the optimizer's
state.  A save is written into `<tag>.tmp` and `os.replace`d into place
after meta.json lands, so an interrupted save never leaves a directory
that `latest_step` selects and `restore_checkpoint` cannot open.

The params cross between the packages: this module reads the params of a
checkpoint that the JAX package saved with its npz backend (and the JAX
package reads this module's).  The optimizer state does not: the JAX
package's is optax's pytree, the port's a `torch.optim` optimizer's
state (its `o_i` arrays are each parameter's state entries, parameter by
parameter in its state's key order, listed in meta.json's `optimizer`),
and a restore loads it only from a checkpoint that the port saved.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch


def _paths(directory: str, step_num: Optional[int]) -> str:
    return os.path.join(directory, f"step_{step_num}" if step_num is not None else "latest")


def _leaves(tree) -> list:
    """The tensors of a NamedTuple, dict, list or tuple, in order, None skipped."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor) or isinstance(tree, np.ndarray):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    return [x for v in tree for x in _leaves(v)]


def _unflatten(like, values):
    """`like` with its leaves replaced by `values`, in `_leaves` order."""
    it = iter(values)

    def rebuild(t):
        if t is None:
            return None
        if isinstance(t, (torch.Tensor, np.ndarray)):
            return next(it)
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        items = [rebuild(v) for v in t]
        return type(t)(*items) if hasattr(t, "_fields") else type(t)(items)

    return rebuild(like)


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _optimizer_state(opt: torch.optim.Optimizer):
    """(o_i arrays, their (parameter index, key) list)."""
    state = opt.state_dict()["state"]
    arrays, keys = [], []
    for i in sorted(state):
        for k in state[i]:
            arrays.append(_numpy(state[i][k]))
            keys.append([i, k])
    return arrays, keys


def save_checkpoint(directory: str, params: Any, opt_state: Optional[torch.optim.Optimizer] = None,
                    step_num: Optional[int] = None) -> str:
    path = _paths(directory, step_num)
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    arrays = {f"p_{i}": _numpy(x) for i, x in enumerate(_leaves(params))}
    meta = {"backend": "npz", "step": step_num}
    if opt_state is not None:
        o_arrays, keys = _optimizer_state(opt_state)
        arrays.update({f"o_{i}": x for i, x in enumerate(o_arrays)})
        meta["optimizer"] = {"class": type(opt_state).__name__, "keys": keys}
    np.savez(os.path.join(tmp, "state.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    # the commit point: a reader sees the whole checkpoint or the previous one
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def _complete(directory: str, name: str) -> bool:
    return os.path.exists(os.path.join(directory, name, "meta.json"))


def latest_step(directory: str) -> Optional[int]:
    """Highest complete step number checkpointed under `directory`, or
    None; directories without meta.json (an interrupted save, a foreign
    directory) are skipped."""
    steps = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return None
    for name in names:
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                n = int(name[5:])
            except ValueError:
                continue
            if _complete(directory, name):
                steps.append(n)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, like: Any,
                       step_num: Optional[int] = None) -> Tuple[Any, Optional[Any]]:
    """Restore (params, opt_state) with `like` = {"params": ...,
    "opt_state": ...} (opt_state may be None or absent): the params as
    `like`'s tensors (on their device and dtype), and a torch optimizer
    given as `like["opt_state"]` loaded in place from a checkpoint that
    the port saved with one (None otherwise).  With no step_num, the
    'latest' tag if present, else the highest step_N directory."""
    if step_num is None and not _complete(directory, "latest"):
        step_num = latest_step(directory)
    path = _paths(directory, step_num)
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    if meta.get("backend") != "npz":
        raise NotImplementedError(f"checkpoint backend {meta.get('backend')!r} is not read "
                                  "by the PyTorch port (npz only)")
    data = np.load(os.path.join(path, "state.npz"))
    p_like = _leaves(like["params"])
    values = []
    for i, x in enumerate(p_like):
        a = data[f"p_{i}"]
        values.append(torch.as_tensor(a).to(device=x.device, dtype=x.dtype)
                      if isinstance(x, torch.Tensor) else a)
    params = _unflatten(like["params"], values)
    opt = like.get("opt_state")
    if opt is None:
        return params, None
    if "optimizer" not in meta:
        if "o_0" in data:  # the JAX package's optax state: not carried over
            return params, None
        raise ValueError("checkpoint was saved without opt_state but the restore "
                         "template requests it")
    info = meta["optimizer"]
    if info["class"] != type(opt).__name__:
        raise ValueError(f"checkpoint holds a {info['class']} state, not {type(opt).__name__}")
    state = {}
    for j, (i, k) in enumerate(info["keys"]):
        state.setdefault(i, {})[k] = torch.as_tensor(data[f"o_{j}"])
    opt.load_state_dict({"state": state, "param_groups": opt.state_dict()["param_groups"]})
    return params, opt
