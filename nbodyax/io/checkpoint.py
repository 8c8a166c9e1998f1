"""Checkpoint / resume.

The reference has no persistence at all — state lives only in RAM and a run
cannot resume (SURVEY.md section 5). Here the whole sim state is one small
pytree, so checkpointing is a single ``np.savez`` per snapshot: portable,
dependency-free, and bit-exact on restore (float32 arrays round-trip
losslessly). Needed for the long 10k-step configs (BASELINE config 5).

Files: ``{dir}/step_{step:09d}.npz`` holding pos/vel/mass/radius/step plus a
format version. ``latest_checkpoint`` finds the newest by step number.

Retention: long runs at checkpoint cadence would otherwise accumulate
unbounded snapshots (a 10k-step N=4M run at checkpointEvery=100 writes ~10 GB
of ~100 MB files). ``save_checkpoint`` therefore prunes after each save:
keep the newest ``keep_last`` snapshots (default 3 via SimConfig; 0 = keep
everything) plus every snapshot whose step is a multiple of
``milestone_every`` (0 = no milestones). Pruning only ever deletes files
matching the ``step_*.npz`` pattern in the checkpoint directory.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from nbodyax.state import SimState, make_state

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "prune_checkpoints", "load_checkpoint_extra"]

_FORMAT_VERSION = 1
_NAME_RE = re.compile(r"^step_(\d+)\.npz$")


def save_checkpoint(directory: str, state: SimState, *,
                    keep_last: int = 0, milestone_every: int = 0,
                    extra: Optional[dict] = None) -> str:
    """``extra``: scalar metadata persisted alongside the state under
    ``meta_``-prefixed keys (the driver stores its ADAPTED bh knobs here,
    so a fresh process resuming mid-merger jumps straight to the working
    knob set instead of re-walking every adapt recompile, several
    multi-minute recompiles per restart)."""
    os.makedirs(directory, exist_ok=True)
    step = int(np.asarray(state.step))
    path = os.path.join(directory, f"step_{step:09d}.npz")
    tmp = path + ".tmp.npz"  # .npz suffix so np.savez doesn't append one
    meta = {f"meta_{k}": np.asarray(v) for k, v in (extra or {}).items()}
    np.savez(tmp,
             version=np.int32(_FORMAT_VERSION),
             pos=np.asarray(state.pos),
             vel=np.asarray(state.vel),
             mass=np.asarray(state.mass),
             radius=np.asarray(state.radius),
             step=np.int32(step),
             sim_time=np.float32(np.asarray(state.sim_time)),
             **meta)
    os.replace(tmp, path)
    if keep_last:
        prune_checkpoints(directory, keep_last=keep_last,
                          milestone_every=milestone_every)
    return path


def prune_checkpoints(directory: str, *, keep_last: int,
                      milestone_every: int = 0) -> list[str]:
    """Delete all but the newest ``keep_last`` snapshots (by step number);
    snapshots at ``milestone_every`` multiples are always kept. The prune
    runs AFTER each save, so a just-written snapshot is never deleted
    (keep_last >= 1). Returns the deleted paths."""
    if keep_last <= 0 or not os.path.isdir(directory):
        return []
    entries = []
    for name in os.listdir(directory):
        m = _NAME_RE.match(name)
        if m:
            entries.append((int(m.group(1)), name))
    entries.sort()
    deleted = []
    for step, name in entries[:-keep_last]:
        if milestone_every and step % milestone_every == 0:
            continue
        p = os.path.join(directory, name)
        os.remove(p)
        deleted.append(p)
    return deleted


def load_checkpoint(path: str) -> SimState:
    with np.load(path) as z:
        version = int(z["version"])
        if version > _FORMAT_VERSION:
            raise ValueError(f"checkpoint {path} has newer format {version}")
        # sim_time absent in pre-adaptiveDt snapshots: resume at 0 (the
        # field is observability, not physics; fixed-dt time can be
        # reconstructed as step*dt if needed)
        t = float(z["sim_time"]) if "sim_time" in z.files else 0.0
        return make_state(z["pos"], z["vel"], z["mass"], z["radius"],
                          step=int(z["step"]), sim_time=t)


def load_checkpoint_extra(path: str) -> dict:
    """The ``extra`` metadata a snapshot was saved with (un-prefixed keys,
    Python scalars); empty for snapshots without any."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            if k.startswith("meta_"):
                out[k[len("meta_"):]] = z[k].item()
    return out


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        m = _NAME_RE.match(name)
        if m and int(m.group(1)) > best_step:
            best, best_step = name, int(m.group(1))
    return os.path.join(directory, best) if best else None
