"""Checkpoint and resume of fitted scene parameters and the optimizer.

Counterpart of `ray_tracer_tpu/opt/checkpoint.py` with its npz backend:
`<dir>/step_N/` (or `<dir>/latest/`) holds `meta.json` and `state.npz`,
whose `p_i` arrays are the SceneParams leaves in field order with the
absent (None) fields skipped, and whose `o_i` arrays are the optimizer's
state.  A save is written into `<tag>.tmp` and `os.replace`d into place
after meta.json lands, so an interrupted save never leaves a directory
that `latest_step` selects and `restore_checkpoint` cannot open.

Both cross between the packages.  The `o_i` arrays of an Adam are the
leaves of optax's `adam(lr).init(params)` in its flatten order: `o_0` the
step count (an int32 scalar), then the first moment (`mu`) of each params
leaf, then the second (`nu`); a leaf the optimizer does not train gets
zeros, which is what the JAX package holds for a field whose gradient its
stop_gradient makes exactly zero.  meta.json names the class and marks
this layout.  `optax.sgd(lr)` has no leaves and a torch SGD without
momentum no state; an SGD save still writes `o_0`, an int32 zero, because
the JAX package's npz reader asks for `o_0` whenever its template holds an
optimizer state (and then takes as many leaves as optax's state has:
none).  A restore loads an Adam's moments and step from a port checkpoint,
from one the JAX package saved with its npz backend, or from one it saved
with orbax (its default wherever orbax imports); the port's checkpoints
from before this layout (`keys` in meta.json: each parameter's torch state
entries) still restore.  An orbax checkpoint (`<step>/orbax/`, OCDBT) is
read through `tensorstore`, imported only then, without orbax or jax; a
host without tensorstore cannot read one (the card's machine has none, so
that branch runs on the CPU hosts that wrote the JAX checkpoints).
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


def _fields_as(like, fields: dict):
    """`like` (a SceneParams) with each of its non-None fields replaced by
    fields[name] placed as like's tensor (device and dtype)."""
    missing = [k for k, x in like._asdict().items() if x is not None and k not in fields]
    if missing:
        raise ValueError(f"the checkpoint holds no params for {missing}")
    return like._replace(**{
        k: torch.as_tensor(fields[k]).to(device=x.device, dtype=x.dtype)
        for k, x in like._asdict().items() if x is not None})


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _opt_params(opt: torch.optim.Optimizer) -> list:
    """The optimizer's tensors in its state_dict's index order."""
    return [p for group in opt.param_groups for p in group["params"]]


def _slots(opt: torch.optim.Optimizer, leaves: list) -> list:
    """For each of the optimizer's tensors, the index of its params leaf
    (the same tensor: `make_train_step`'s init hands the optimizer the
    params' own tensors)."""
    slots = []
    for p in _opt_params(opt):
        j = next((j for j, x in enumerate(leaves) if x is p), None)
        if j is None:
            raise ValueError("the optimizer trains a tensor that is not among the params")
        slots.append(j)
    return slots


def _optax_kind(opt: torch.optim.Optimizer) -> str:
    """The optax state an optimizer of `opt.fit._make_optimizer` keeps:
    "adam" or "sgd"."""
    d = opt.defaults
    if type(opt) is torch.optim.Adam and not d.get("amsgrad") and not d.get("maximize"):
        return "adam"
    if type(opt) is torch.optim.SGD and not d.get("momentum"):
        return "sgd"
    raise NotImplementedError(f"a {type(opt).__name__} has no counterpart in optax's "
                              "adam or sgd state")


def _optax_state(opt: torch.optim.Optimizer, params) -> list:
    """The o_i arrays of optax's layout: [count, mu..., nu...] for an Adam
    over params' leaves, [int32 0] for an SGD."""
    if _optax_kind(opt) == "sgd":
        return [np.zeros((), np.int32)]
    leaves = _leaves(params)
    mu = [np.zeros(tuple(x.shape), _numpy(x).dtype) for x in leaves]
    nu = [m.copy() for m in mu]
    steps = set()
    for p, j in zip(_opt_params(opt), _slots(opt, leaves)):
        st = opt.state.get(p, {})
        if "step" in st:
            steps.add(int(float(st["step"])))
            mu[j], nu[j] = _numpy(st["exp_avg"]), _numpy(st["exp_avg_sq"])
    if len(steps) > 1:
        raise ValueError(f"the optimizer's tensors took different step counts {sorted(steps)}")
    return [np.asarray(steps.pop() if steps else 0, np.int32)] + mu + nu


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
        arrays.update({f"o_{i}": x for i, x in enumerate(_optax_state(opt_state, params))})
        meta["optimizer"] = {"class": type(opt_state).__name__, "layout": "optax"}
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


def _orbax_leaves(path: str) -> Tuple[dict, set]:
    """({key tuple: numpy array}, the top-level keys) of an orbax
    checkpoint at `path` (its `orbax/` directory): every entry its
    _METADATA's tree_metadata lists with a value (orbax records a None
    field, or optax's empty state, there and writes no array for it), each
    read from the OCDBT store's `<key>.<key>...` with tensorstore, e.g.
    ("params", "kd") and ("opt_state", "0", "mu", "kd")."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError("reading the JAX package's orbax checkpoint needs the "
                          "'tensorstore' package, which is not installed") from e
    root = os.path.abspath(os.path.join(path, "orbax"))
    with open(os.path.join(root, "_METADATA")) as fh:
        meta = json.load(fh)
    array_format = "zarr3" if meta.get("use_zarr3") else "zarr"
    leaves, tops = {}, set()
    for entry in meta["tree_metadata"].values():
        keys = tuple(str(k["key"]) for k in entry["key_metadata"])
        tops.add(keys[0])
        if not entry["value_metadata"].get("skip_deserialize", False):
            store = ts.open({"driver": array_format, "kvstore": {
                "driver": "ocdbt", "base": "file://" + root, "path": ".".join(keys)}},
                open=True).result()
            leaves[keys] = np.asarray(store.read().result())
    return leaves, tops


def _load_adam(opt: torch.optim.Optimizer, params, count, mu: list, nu: list) -> None:
    """Load optax's Adam state (count, and mu and nu a params leaf each)
    into the torch Adam over params' leaves: step = count, exp_avg = mu,
    exp_avg_sq = nu of each tensor it trains.  step takes the dtype torch
    gives it (float64 under a float64 default dtype, else float32), and
    load_state_dict its device."""
    step_dtype = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    leaves = _leaves(params)
    state = {}
    for i, (p, j) in enumerate(zip(_opt_params(opt), _slots(opt, leaves))):
        if tuple(np.shape(mu[j])) != tuple(p.shape) or tuple(np.shape(nu[j])) != tuple(p.shape):
            raise ValueError(f"the checkpoint's moments of leaf {j} have shape "
                             f"{np.shape(mu[j])}, not {tuple(p.shape)}")
        state[i] = {"step": torch.tensor(float(count), dtype=step_dtype),
                    "exp_avg": torch.as_tensor(np.asarray(mu[j])),
                    "exp_avg_sq": torch.as_tensor(np.asarray(nu[j]))}
    opt.load_state_dict({"state": state, "param_groups": opt.state_dict()["param_groups"]})


def _restore_orbax(path: str, like: dict):
    leaves, tops = _orbax_leaves(path)
    params = _fields_as(like["params"], {k[1]: v for k, v in leaves.items()
                                         if len(k) == 2 and k[0] == "params"})
    opt = like.get("opt_state")
    if opt is None or "opt_state" not in tops:  # as the JAX package's restore
        return params, None
    if _optax_kind(opt) == "sgd":
        return params, opt
    fields = [k for k, x in like["params"]._asdict().items() if x is not None]
    try:
        count = leaves[("opt_state", "0", "count")]
        mu = [leaves[("opt_state", "0", "mu", f)] for f in fields]
        nu = [leaves[("opt_state", "0", "nu", f)] for f in fields]
    except KeyError as e:
        raise ValueError(f"the checkpoint holds no Adam state for {e.args[0]}") from None
    _load_adam(opt, like["params"], count, mu, nu)
    return params, opt


def restore_checkpoint(directory: str, like: Any,
                       step_num: Optional[int] = None) -> Tuple[Any, Optional[Any]]:
    """Restore (params, opt_state) with `like` = {"params": ...,
    "opt_state": ...} (opt_state may be None or absent): the params as
    `like`'s tensors (on their device and dtype), and a torch optimizer
    given as `like["opt_state"]` loaded in place: an Adam from optax's
    layout (the port's, or the JAX package's npz or orbax state, or the
    port's earlier per-tensor entries), an SGD with nothing to load.  As in
    the JAX package, an orbax checkpoint without an optimizer state gives
    None for it and an npz one raises.  With no step_num, the 'latest' tag
    if present, else the highest step_N directory."""
    if step_num is None and not _complete(directory, "latest"):
        step_num = latest_step(directory)
    path = _paths(directory, step_num)
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    if meta.get("backend") == "orbax":  # the JAX package's default
        return _restore_orbax(path, like)
    if meta.get("backend") != "npz":
        raise NotImplementedError(f"checkpoint backend {meta.get('backend')!r} is not read "
                                  "by the PyTorch port (npz or orbax)")
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
    info = meta.get("optimizer")  # None in the JAX package's checkpoints
    if info is None and "o_0" not in data:
        raise ValueError("checkpoint was saved without opt_state but the restore "
                         "template requests it")
    if info is not None and info["class"] != type(opt).__name__:
        raise ValueError(f"checkpoint holds a {info['class']} state, not {type(opt).__name__}")
    if info is not None and "keys" in info:  # the port's per-tensor entries
        state = {}
        for j, (i, k) in enumerate(info["keys"]):
            state.setdefault(i, {})[k] = torch.as_tensor(data[f"o_{j}"])
        opt.load_state_dict({"state": state, "param_groups": opt.state_dict()["param_groups"]})
        return params, opt
    if _optax_kind(opt) == "sgd":
        return params, opt
    n = sum(1 for k in data.files if k.startswith("o_"))
    leaves = len(p_like)
    if n != 1 + 2 * leaves:
        raise ValueError(f"the checkpoint holds {n} optimizer arrays; optax's Adam over "
                         f"{leaves} params leaves has {1 + 2 * leaves}")
    o = [data[f"o_{i}"] for i in range(n)]
    _load_adam(opt, like["params"], o[0], o[1:1 + leaves], o[1 + leaves:])
    return params, opt
