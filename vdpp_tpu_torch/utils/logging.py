"""Logging setup (port of ``vdpp_tpu/utils/logging.py``).

One ``%(asctime)s %(levelname)s %(name)s`` format and a ``--log-level`` flag
in every entry point; a stage rank's records carry a ``[stage=N]`` prefix,
the original system's per-rank ``[rank=N]`` prefix under the JAX package's
name.
"""

from __future__ import annotations

import logging


def setup_logging(level: str = "INFO") -> None:
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
        force=True,
    )


def stage_logger(name: str, stage: int | None = None) -> logging.LoggerAdapter:
    logger = logging.getLogger(name)
    prefix = f"[stage={stage}] " if stage is not None else ""

    class _Adapter(logging.LoggerAdapter):
        def process(self, msg, kwargs):
            return prefix + msg, kwargs

    return _Adapter(logger, {})
