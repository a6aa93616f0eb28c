"""The step loop of the training CLIs (``python -m lass_torch.clap_pretrain``,
``lass_torch.linear_probe`` and ``lass_torch.train_multistft``)."""
from __future__ import annotations

import json
import logging
import time
from typing import Callable, Dict, Iterator, Optional


def run_steps(task, batches: Iterator, ckpt, metrics, *, log_every: int,
              max_steps: Optional[int] = None,
              train_step: Optional[Callable] = None, eval_every: int = 0,
              evaluate: Optional[Callable[[], Dict]] = None,
              stats: Optional[Dict[str, float]] = None,
              launch_counts_path: Optional[str] = None) -> None:
    """``train_step`` (``task.train_step`` by default) on each batch from
    ``batches`` until ``task.step`` reaches ``max_steps`` (None: until the
    batches end). At step 1 and every ``log_every`` steps ``metrics`` gets
    the step's scalars, steps_per_sec over the steps since the last record,
    load_s (seconds waiting for ``batches``) and, with ``stats``, its
    decode_s (which the batches add to; reset here). ``evaluate()`` runs
    every ``eval_every`` steps, its dict logged and its time left out of
    steps/s; the ``CheckpointManager`` ``ckpt`` saves where it says (on
    rank 0 of a process group). On every way out: the last save is waited
    for, the metrics closed and the kernels' launch counts written to
    ``launch_counts_path`` (JSON); after a normal end every rank waits
    until rank 0's last checkpoint is on disk."""
    from lass_torch.parallel.host import barrier, host_info

    train_step = train_step or task.train_step
    main_process = host_info()[0] == 0
    pc = time.perf_counter
    t_last, steps_since, load_s = pc(), 0, 0.0
    try:
        while max_steps is None or task.step < max_steps:
            t0 = pc()
            batch = next(batches, None)
            if batch is None:
                break
            load_s += pc() - t0
            m = train_step(batch)
            step = task.step
            steps_since += 1
            if step == 1 or step % log_every == 0:
                row = {k: float(v) for k, v in m.items()}
                row.update(steps_per_sec=steps_since / (pc() - t_last),
                           load_s=load_s)
                if stats is not None:
                    row["decode_s"], stats["decode_s"] = stats["decode_s"], 0.0
                logging.info("step %d %s", step, row)
                metrics.log(step, row)
                t_last, steps_since, load_s = pc(), 0, 0.0
            if evaluate is not None and step % eval_every == 0:
                r = evaluate()
                logging.info("eval @ %d: %s", step, r)
                metrics.log(step, r)
                t_last = pc()
            if main_process and ckpt.should_save(step):
                ckpt.save_async(step, task)
    finally:
        ckpt.wait()
        metrics.finish()
        if launch_counts_path:
            from lass_torch.train.__main__ import launch_counts

            with open(launch_counts_path, "w") as f:
                json.dump(launch_counts(), f)
    barrier()
