"""Mid-schedule snapshot and resume of the ticked step pipeline (port of
``vdpp_tpu/utils/resume.py``; numpy only).

The state between two ticks is ``(tick, buf)``: the last completed tick and
the ``(S, *payload)`` ring of payloads the stages step next. With one process
per stage the ring lives on S ranks; ``StepPipeline.run_ticked`` gathers it
to the last rank on the ticks that snapshot and hands it to ``on_tick``:

    def on_tick(t, buf):
        save_pipeline_state(path, t, buf, meta={...})
    pipe.run_ticked(params, inputs, on_tick=on_tick, on_tick_every=every)

    # after a preemption, on every rank:
    tick, buf, meta = load_pipeline_state(path)
    pipe.run_ticked(params, inputs, start_tick=tick + 1, initial_buf=buf)

The file is the JAX package's ``vdpp_pipeline_state_v1`` ``.npz`` (keys
``magic``, ``tick``, ``buf`` and a JSON ``meta``), so a snapshot written by
either package loads in the other. ``buf`` keeps the payload's raw words,
so packed solver and cache state survive byte for byte.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

_MAGIC = "vdpp_pipeline_state_v1"


def save_pipeline_state(path: str, tick: int, buf, meta: dict | None = None) -> None:
    """Write the state after tick ``tick`` (resume with ``start_tick = tick +
    1``) atomically: into a temporary file beside ``path``, then renamed over
    it, so a preemption mid-write leaves the previous snapshot whole."""
    buf_np = np.asarray(buf)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                magic=np.array(_MAGIC),
                tick=np.asarray(int(tick), np.int64),
                buf=buf_np,
                meta=np.array(json.dumps(meta or {})),
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_pipeline_state(path: str) -> tuple[int, np.ndarray, dict]:
    """A snapshot -> ``(last completed tick, buf, meta)``; a file that is not
    one raises ``ValueError``."""
    with np.load(path, allow_pickle=False) as z:
        if "magic" not in z.files or str(z["magic"]) != _MAGIC:
            raise ValueError(f"{path}: not a pipeline state file")
        return int(z["tick"]), z["buf"], json.loads(str(z["meta"]))
