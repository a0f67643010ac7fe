"""Banded rendering with per-band retry.

Counterpart of `ray_tracer_tpu/render/resilient.py`: every stage is a pure
function of its rays, so re-running any slice of the image is safe.
`render_banded` splits the primary rays into horizontal bands, renders
each band (and each spp subsample of it) as its own call, retries a band
that raises, and reassembles the image.  A ray's color does not depend
on the batch it rides in, so the image is the bounce loop's, byte for
byte: `render()`'s wherever render takes the bounce loop.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ray_tracer_tpu_torch.ops.camera import camera_rays_subsample
from ray_tracer_tpu_torch.render.renderer import _DET_DTYPES, render_rays
from ray_tracer_tpu_torch.utils.log import get_logger


def render_banded(prep, bands: int = 8, retries: int = 2, backoff_s: float = 1.0,
                  band_fn: Optional[Callable] = None) -> np.ndarray:
    """Render `prep` in `bands` horizontal strips with per-band retry ->
    (H, W, 3) float32 numpy.  Each band is a slice of the subsample's full
    camera batch.  band_fn(band_rays) -> (rows*W, 3) colors defaults to
    the bounce loop (`render_rays`: one call a band on the card, ray_tile
    chunks on the CPU) and can be swapped to drive the retry path."""
    log = get_logger(__name__)
    cfg = prep.cfg
    rcfg = cfg.render
    h, w = cfg.camera.height, cfg.camera.width
    bands = max(1, min(bands, h))
    edges = np.linspace(0, h, bands + 1, dtype=int)
    if rcfg.traversal == "packed":
        garr, meta = prep.packed.arrays, prep.packed.meta
    else:
        garr, meta = prep.grid.arrays, prep.grid.meta
    setup = prep.frame()

    if band_fn is None:
        @torch.no_grad()
        def band_fn(band_rays):
            tile = band_rays.count if prep.device.type == "cuda" else max(1, rcfg.ray_tile)
            colors = band_rays.map_tiles(
                lambda rb: render_rays(rb, prep.scene, garr, meta, rcfg, dda=prep.dda,
                                       consts=setup.consts, vn=setup.vn), tile)
            return colors.cpu().numpy()

    # each (band, subsample) slice is its own retryable call; one
    # subsample's batch is made at a time, as accumulate_spp does
    n_sub = rcfg.spp * rcfg.spp
    out = np.zeros((h * w, 3), np.float32)
    for b in range(bands):
        lo, hi = int(edges[b]) * w, int(edges[b + 1]) * w
        if hi <= lo:
            continue
        acc = np.zeros((hi - lo, 3), np.float32)
        for s in range(n_sub):
            sub = camera_rays_subsample(cfg.camera, s, rcfg.spp, dtype=_DET_DTYPES[rcfg.dtype],
                                        device=prep.device)
            band = sub.slice(lo, hi)
            for attempt in range(retries + 1):
                try:
                    acc += band_fn(band)
                    break
                except Exception as e:  # noqa: BLE001 (retry any dispatch error)
                    if attempt == retries:
                        raise
                    log.warning("band %d sub %d attempt %d failed (%s); retrying",
                                b, s, attempt, e)
                    time.sleep(backoff_s * (attempt + 1))
        out[lo:hi] = acc / n_sub
    return out.reshape(h, w, 3)


__all__ = ["render_banded"]
