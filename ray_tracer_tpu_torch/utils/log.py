"""Host-0 structured logging.

Counterpart of `ray_tracer_tpu/utils/log.py`: in a job of several
processes only process 0 narrates, and a record with `all_hosts=True`
logs everywhere.  The process index is torch.distributed's rank once a
process group is up, else 0.
"""

from __future__ import annotations

import logging
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class _Host0Filter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        if getattr(record, "all_hosts", False):
            return True
        try:
            return process_index() == 0
        except Exception:  # noqa: BLE001 (a broken group must not silence the log)
            return True


def get_logger(name: str = "ray_tracer_tpu_torch") -> logging.Logger:
    """A logger writing to stderr through the host-0 filter (set up once)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        handler.addFilter(_Host0Filter())
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
