"""Checkpoints with auto-resume (counterpart: ``irdu_tpu/train/checkpoints.py``,
which saves through orbax).

A save of step S writes ``<directory>/S/state.pt`` (``torch.save`` of
{"step", "model": state_dict, "optimizer": state_dict}) and, when there is
one, ``<directory>/S/data.json`` (the data position: epoch, stage and the
batches of the stage already taken). It writes into ``S.tmp`` and renames
that to ``S`` when both files are on disk, so that a run killed mid-save
leaves no step directory a resume would read. A step that already has a
directory is not written again (orbax skips it too), and at most
``max_to_keep`` step directories are kept, the newest. A directory is a
step's when its name ends in digits that parse to the step (JAX's rule for
step names other than ``str(step)``). Saves are synchronous; ``wait`` is
there for JAX's API.

On a mesh every rank calls ``save``: the state is gathered to the
single-device layout (``parallel.tensor.gather_train_state``), rank 0 alone
writes it, and every rank waits for the write before going on. Every rank
restores from the same files, into a state of the single-device layout
(which the trainer then cuts to its mesh), so that a checkpoint written
under any dp × tp resumes under any other, one process included.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any

import torch
import torch.distributed as dist

from irdu_tpu_torch.parallel.tensor import gather_train_state

STATE_FILE, DATA_FILE = "state.pt", "data.json"


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int | None = None, mesh=None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        os.makedirs(self.directory, exist_ok=True)

    def _step_dirs(self) -> dict[int, str]:
        """{step: directory} of every directory whose name ends in digits."""
        out = {}
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            m = re.search(r"(\d+)$", name)
            if m and os.path.isdir(path):
                out[int(m.group(1))] = path
        return out

    def save(self, step: int, state, data_state: dict[str, Any] | None = None) -> bool:
        """Write step ``step`` of ``state`` (a ``steps.TrainState``); False,
        and nothing written, when the step is already on disk (on a mesh:
        False on every rank but 0)."""
        model_sd, opt_sd = gather_train_state(state, self.mesh)
        written = False
        if self.mesh is None or self.mesh.rank == 0:
            written = self._write(step, model_sd, opt_sd, data_state)
        if dist.is_initialized():
            dist.barrier()
        return written

    def _write(self, step, model_sd, opt_sd, data_state) -> bool:
        if step in self._step_dirs():
            return False
        final = os.path.join(self.directory, str(step))
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"step": step, "model": model_sd, "optimizer": opt_sd},
                   os.path.join(tmp, STATE_FILE))
        if data_state is not None:
            with open(os.path.join(tmp, DATA_FILE), "w") as fh:
                json.dump(data_state, fh)
        os.rename(tmp, final)
        if self.max_to_keep:
            dirs = self._step_dirs()
            for old in sorted(dirs)[:-self.max_to_keep]:
                shutil.rmtree(dirs[old])
        return True

    def wait(self) -> None:
        """Saves finish before ``save`` returns: nothing to wait for."""

    def latest_step(self) -> int | None:
        dirs = self._step_dirs()
        return max(dirs) if dirs else None

    def restore(self, state, step: int | None = None):
        """Load step ``step`` (default: the latest) into ``state``'s model
        and optimizer, in place; returns (state,
        data_state), data_state None when the checkpoint has none. With no
        checkpoint, (state, None) unchanged."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return state, None
        step_dir = self._step_dirs()[step]
        # loaded on the host: load_state_dict copies into the model's tensors
        # and moves Adam's moments to their parameters' device, and Adam's
        # step counts stay on the host, where a run from scratch keeps them
        payload = torch.load(os.path.join(step_dir, STATE_FILE), map_location="cpu",
                             weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])
        data_path = os.path.join(step_dir, DATA_FILE)
        data_state = None
        if os.path.exists(data_path):
            with open(data_path) as fh:
                data_state = json.load(fh)
        return state, data_state
