"""Step checkpoints of the trainer (counterpart of
lass_tpu/train/checkpoint.py).

The cadence is the reference's: step 1 and every ``save_step_frequency``
steps. Each checkpoint is one file ``<directory>/<step>.ckpt`` written by
``torch.save``:

- ``state_dict``: the separator in the reference's Lightning layout
  (``ss_model.`` keys, per-path FiLM Linears), so
  ``lass_torch.convert.checkpoint_io.load_ss_model`` serves it as it is;
- ``optimizer``, ``scheduler``: their state dicts; ``step``: the number of
  updates done; ``generator``: the mixer generator's state.

``save_async`` copies the state to host memory on the caller's thread (the
next step updates the parameters in place) and writes the file on a
background thread; ``wait`` joins it and re-raises its error. Files are
written to a temporary name and renamed, so a reader never sees half a
checkpoint.
"""
from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, Optional

import torch

from lass_torch.convert.checkpoint_io import (
    separator_state_dict, unpack_film)

_NAME = re.compile(r"^(\d+)\.ckpt$")


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def snapshot(task, generator: torch.Generator) -> Dict[str, Any]:
    """The task's state (model, optimizer, scheduler, step) and the mixer
    generator's, copied to host memory."""
    sd = unpack_film(_to_cpu(task.model.state_dict()))
    return {
        "state_dict": {f"ss_model.{k}": v for k, v in sd.items()},
        "optimizer": _to_cpu(task.optimizer.state_dict()),
        "scheduler": task.scheduler.state_dict(),
        "step": int(task.step),
        "generator": generator.get_state(),
    }


class CheckpointManager:
    def __init__(self, directory: str, save_step_frequency: int = 20000):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_step_frequency = save_step_frequency
        self._saver: Optional[threading.Thread] = None
        self._saver_error: Optional[Exception] = None

    def should_save(self, step: int) -> bool:
        return step == 1 or (step > 0 and step % self.save_step_frequency == 0)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.ckpt")

    def _write(self, step: int, state: Dict[str, Any]) -> None:
        tmp = self.path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.path(step))

    def save_async(self, step: int, task, generator: torch.Generator) -> None:
        """Snapshot now, write in the background; at most one write is in
        flight (a second save waits for the first)."""
        self.wait()
        state = snapshot(task, generator)

        def work():
            try:
                self._write(step, state)
            except Exception as exc:  # re-raised by wait()
                self._saver_error = exc

        self._saver = threading.Thread(target=work, daemon=True,
                                       name=f"ckpt-save-{step}")
        self._saver.start()

    def wait(self) -> None:
        if self._saver is not None:
            self._saver.join()
            self._saver = None
        if self._saver_error is not None:
            exc, self._saver_error = self._saver_error, None
            raise RuntimeError("background checkpoint save failed") from exc

    def close(self) -> None:
        self.wait()

    def steps(self):
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, task, generator: torch.Generator,
                step: Optional[int] = None) -> int:
        """Load checkpoint ``step`` (the latest when None) into the task
        and the generator; returns the step."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return restore_file(self.path(step), task, generator)


def restore_file(path: str, task, generator: torch.Generator) -> int:
    """Load one checkpoint file into the task and the generator; returns
    its step."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    task.model.load_state_dict(separator_state_dict(path))
    task.optimizer.load_state_dict(blob["optimizer"])
    task.scheduler.load_state_dict(blob["scheduler"])
    task.step = int(blob["step"])
    generator.set_state(blob["generator"])
    return task.step
