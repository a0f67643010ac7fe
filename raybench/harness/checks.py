"""The comparison that decides `correct`: what the timed path produced,
held to the plain reference in `raybench/reference/`.

Frames: a sample of the last window frame's pixels, drawn from the seed,
against the reference's colors of the same pixels.  A pixel mismatches
where a channel differs by more than atol + rtol * |reference| (the
traffic file's `check`; a Whitted frame first clips both to [0, 255],
the range its image is written in, and allows 2 counts).  The number
compared is the share of the sampled pixels that either side lights
(any channel above zero) which mismatch.  A triangle missed or taken in
the traversal's place, a shadow or a bounce wrongly answered, a path
that draws other numbers, or a shading term gone wrong each move a pixel
by far more.

The fit: each checked step's loss, the first gradient's norm leaf by leaf
and the norm of each leaf's change after the checked steps, each as the
gap between the program's and the reference's, over the reference's norm
of that leaf or of the median leaf, whichever is larger.  A leaf whose
reference gradient lies under a thousandth of the median leaf's moves by
rounding alone under Adam, and is left out of the change."""

from __future__ import annotations

import statistics

import numpy as np
import torch

from raybench.harness.port import perturbed
from raybench.reference.fit import reference_fit
from raybench.reference.geometry import make_scene, with_verts
from raybench.reference.grid import build_grid
from raybench.reference.pathtrace import render_pixels as gi_pixels
from raybench.reference.whitted import render_pixels

SMALL_LEAF = 1e-3  # of the median leaf's gradient norm


def sample_pixels(seed: int, n: int, k: int, device) -> torch.Tensor:
    """k pixel indices of n drawn from the seed (sorted, distinct)."""
    rng = np.random.default_rng(int(seed))
    idx = np.unique(rng.integers(0, n, size=min(k, n)))
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def mismatch_share(colors: torch.Tensor, ref: torch.Tensor, check: dict) -> float:
    a, b = colors.float(), ref.float()
    if check.get("clip") is not None:
        a, b = a.clamp(0, check["clip"]), b.clamp(0, check["clip"])
    lit = (a > 0).any(1) | (b > 0).any(1)
    bad = ((a - b).abs() > check["atol"] + check["rtol"] * b.abs()).any(1) & lit
    return float(bad.sum()) / max(1, int(lit.sum()))


def reference_frame(config: dict, traffic: dict, size: int, pixels: torch.Tensor,
                    dtype=torch.float32):
    """The reference's colors of `pixels`, on their device."""
    scene = make_scene(config, pixels.device, dtype)
    grid = build_grid(scene.v0, scene.v1, scene.v2, device=pixels.device)
    r = traffic["render"]
    if r.get("gi_samples", 0) > 0:
        return gi_pixels(config, scene, grid, size, size, pixels, r["gi_samples"],
                         r["gi_depth"], dtype)
    return render_pixels(config, scene, grid, size, size, pixels, dtype)


def frame_numbers(config: dict, traffic: dict, size: int, pixels: torch.Tensor,
                  colors: torch.Tensor, ref_dtype=torch.float32) -> dict:
    ref = reference_frame(config, traffic, size, pixels, ref_dtype)
    return {"pixel_mismatch_share": mismatch_share(colors.to(ref.device), ref,
                                                   traffic["check"])}


def _worst(gaps) -> float:
    """The largest gap; NaN where any gap is NaN (a max would skip it)."""
    gaps = list(gaps)
    return float("nan") if any(g != g for g in gaps) else max(gaps, default=0.0)


def norm_gaps(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's |prog - ref| / max(ref, the median leaf's ref)."""
    names = [f for f in ref if keep is None or f in keep]
    med = statistics.median(ref[f] for f in ref)
    return _worst(abs(prog[f] - ref[f]) / max(ref[f], med) for f in names)


def fit_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses": [..], "first_grad": {leaf: norm},
    "change": {leaf: norm}}."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    g = ref["first_grad"]
    med = statistics.median(g.values())
    keep = [f for f in g if g[f] >= SMALL_LEAF * med]
    return {"loss_gap": _worst(losses),
            "grad_gap": norm_gaps(prog["first_grad"], g),
            "change_gap": norm_gaps(prog["change"], ref["change"], keep)}


def reference_fit_record(config: dict, traffic: dict, size: int, delta: dict, device,
                         dtype=torch.float32, half_batch: bool = False) -> dict:
    """The reference fit from the benchmark's own start (`delta` from
    `port.perturbation`): its losses, first gradient norms and changes."""
    true = make_scene(config, device, dtype)
    values = {"verts": true.verts, "base_color": true.base_color, "kd": true.kd,
              "ks": true.ks, "ka": true.ka, "light_pos": true.light_pos}
    start = perturbed(values, {k: v.to(device) for k, v in delta.items()})
    start = {k: v.to(dtype) for k, v in start.items()}
    s0 = with_verts(true._replace(**{k: v for k, v in start.items() if k != "verts"}),
                    start["verts"])
    fields = tuple(traffic["trainable"])
    losses, first, last = reference_fit(true, s0, config, size, fields, traffic["lr"],
                                        int(traffic["check_steps"]), half_batch=half_batch)

    def norm(x):
        return float(torch.sqrt(torch.sum(x.double() * x.double())))

    return {"losses": losses, "first_grad": {f: norm(first[f]) for f in fields},
            "change": {f: norm(last[f] - start[f]) for f in fields}}
