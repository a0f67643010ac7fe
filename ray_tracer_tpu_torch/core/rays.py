"""Ray batches as a NamedTuple of tensors (counterpart of
`ray_tracer_tpu/core/rays.py`)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class RayBatch(NamedTuple):
    """A batch of rays: orig/dirn are (R,3); mint/maxt are (R,)."""

    orig: torch.Tensor
    dirn: torch.Tensor
    mint: torch.Tensor
    maxt: torch.Tensor

    @property
    def count(self) -> int:
        return self.orig.shape[0]

    def at(self, t: torch.Tensor) -> torch.Tensor:
        """Point along each ray: orig + t*dir (reference: geometry.h:91)."""
        return self.orig + self.dirn * t[..., None]

    @staticmethod
    def make(orig, dirn, mint=0.0, maxt=float("inf")) -> "RayBatch":
        r = orig.shape[0]
        mint = torch.as_tensor(mint, dtype=orig.dtype, device=orig.device)
        maxt = torch.as_tensor(maxt, dtype=orig.dtype, device=orig.device)
        return RayBatch(orig, dirn, mint.expand(r).contiguous(),
                        maxt.expand(r).contiguous())

    def slice(self, lo: int, hi: int) -> "RayBatch":
        return RayBatch(*(x[lo:hi] for x in self))

    def map_tiles(self, fn, tile: int) -> torch.Tensor:
        """fn over consecutive chunks of at most `tile` rays, the results
        concatenated; one call on the whole batch when tile >= count."""
        r = self.count
        if tile >= r:
            return fn(self)
        return torch.cat([fn(self.slice(lo, min(lo + tile, r))) for lo in range(0, r, tile)])


def concatenate(batches) -> RayBatch:
    """The batches' rays one after another: each field concatenated along
    axis 0."""
    return RayBatch(*(torch.cat(fields, dim=0) for fields in zip(*batches)))
