"""Step checkpoints of the trainer (counterpart of
lass_tpu/train/checkpoint.py).

The cadence is the reference's: step 1 and every ``save_step_frequency``
steps. Each checkpoint is one file ``<directory>/<step>.ckpt`` written by
``torch.save``:

- ``state_dict``: the separator in the reference's Lightning layout
  (``ss_model.`` keys, per-path FiLM Linears cut by the model's own FiLM
  spec), so ``lass_torch.convert.checkpoint_io.load_ss_model`` serves a
  ResUNet30's as it is; a module the task trains beside it (the
  negative-query fusion) under its own name (``neg_query_fusion.``);
- ``optimizer``, ``scheduler``: their state dicts; ``step``: the number of
  updates done; ``generator``: the mixer generator's state (the trainer's;
  the precomputed-STFT variants mix offline and have none).

A task takes on ``TaskCheckpoint`` and gives the ``state_dict`` of its own
layout: ``SeparatorCheckpoint`` gives the separator tasks' above, the CLAP
tasks give their flat CLAP (or probe) state dict. A separator sharded over
a grid's model axis (the task's ``grid``) writes its whole model and whole
optimizer moments, gathered over the model group, so a checkpoint written
at any layout resumes at any other; restoring cuts each rank's slices.
Under a grid every rank of a model group takes the snapshot together
(``snapshot``), and one writes it (``write_async``).

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

from lass_torch.convert.checkpoint_io import separator_layout, unpack_film
from lass_torch.parallel import tensor

_NAME = re.compile(r"^(\d+)\.ckpt$")


def _to_cpu(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class TaskCheckpoint:
    """``checkpoint_state`` and ``load_checkpoint_state`` of a task with
    ``optimizer``, ``scheduler``, ``step`` and its own ``state_dict`` /
    ``load_state_dict``."""

    def checkpoint_state(self) -> Dict[str, Any]:
        return {"state_dict": self.state_dict(),
                "optimizer": self.optimizer_state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "step": int(self.step)}

    def load_checkpoint_state(self, blob: Dict[str, Any]) -> None:
        self.load_state_dict(blob["state_dict"])
        self.load_optimizer_state_dict(blob["optimizer"])
        self.scheduler.load_state_dict(blob["scheduler"])
        self.step = int(blob["step"])

    def optimizer_state_dict(self) -> Dict[str, Any]:
        return self.optimizer.state_dict()

    def load_optimizer_state_dict(self, state: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state)


class SeparatorCheckpoint(TaskCheckpoint):
    """The separator tasks' layout: ``model`` under ``ss_model.``, its FiLM
    cut per path by its own spec (``model.film.spec``); every other module
    of ``modules()`` (the negative-query fusion) under its own name.
    ``grid``: the grid ``model`` is sharded over (``make_grid(1)``: not
    sharded)."""

    def modules(self) -> Dict[str, torch.nn.Module]:
        """Everything the task trains, by checkpoint name."""
        return {"model": self.model}

    def state_dict(self) -> Dict[str, torch.Tensor]:
        sd = tensor.full_state_dict(self.model, self.model.state_dict(),
                                    self.grid)
        sd = unpack_film(sd, self.model.film.spec)
        state_dict = {f"ss_model.{k}": v for k, v in sd.items()}
        for name, module in self.modules().items():
            if name != "model":
                state_dict.update({f"{name}.{k}": v for k, v in
                                   module.state_dict().items()})
        return state_dict

    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        self.model.load_state_dict(tensor.local_state_dict(
            self.model, separator_layout(sd, self.model.film.spec),
            self.grid))
        for name, module in self.modules().items():
            if name != "model":
                prefix = f"{name}."
                module.load_state_dict({k[len(prefix):]: v for k, v in
                                        sd.items() if k.startswith(prefix)})

    def optimizer_state_dict(self) -> Dict[str, Any]:
        return tensor.full_optimizer_state(
            self.model, self.optimizer.state_dict(), self.grid)

    def load_optimizer_state_dict(self, state: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(tensor.local_optimizer_state(
            self.model, state, self.grid))


def snapshot(task: TaskCheckpoint,
             generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """The task's checkpoint state and the mixer generator's where it has
    one, copied to host memory."""
    state = _to_cpu(task.checkpoint_state())
    if generator is not None:
        state["generator"] = generator.get_state()
    return state


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

    def save_async(self, step: int, task,
                   generator: Optional[torch.Generator] = None) -> None:
        """Snapshot now, write in the background; at most one write is in
        flight (a second save waits for the first)."""
        self.wait()
        self.write_async(step, snapshot(task, generator))

    def write_async(self, step: int, state: Dict[str, Any]) -> None:
        """Write a ``snapshot`` in the background (after the write in
        flight, if any)."""
        self.wait()

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

    def restore(self, task, generator: Optional[torch.Generator] = None,
                step: Optional[int] = None) -> int:
        """Load checkpoint ``step`` (the latest when None) into the task
        and the generator; returns the step."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return restore_file(self.path(step), task, generator)


def restore_file(path: str, task,
                 generator: Optional[torch.Generator] = None) -> int:
    """Load one checkpoint file into the task (and the generator, where
    one is given); returns its step."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    task.load_checkpoint_state(blob)
    if generator is not None:
        generator.set_state(blob["generator"])
    return task.step
