"""Train CLI (counterpart of the repository's train.py):

    python -m lass_torch.train --workspace W --config_yaml C \
        --resume_checkpoint_path P [--max_steps N] [--device cuda] \
        [--eval_indexes CSV --eval_audio_dir DIR]

``--resume_checkpoint_path ""`` starts from scratch; a checkpoint file
(``.../<step>.ckpt``) or a checkpoint directory (its latest) resumes.
``--eval_indexes`` with ``--eval_audio_dir`` runs the DCASE evaluator
on that set every ``train.evaluate_step_frequency`` steps
(``make_dcase_eval_hook``): eval_SISDR, eval_SDRi and eval_SDR go to
metrics.jsonl and the statistics file. The CLI's query encoder has the
caption tower only, so ``model.use_text_ratio`` must be 1 here; hybrid
conditioning runs from Python, with a ``Trainer`` given a query encoder
after its ``attach_audio_encoder()``. ``--launch_counts PATH`` writes, at
exit, how many times each of the port's kernels was launched (JSON), so a
check can tell which kernels the run went through.

Several cards, one process each:

    python -m torch.distributed.run --nproc_per_node N -m lass_torch.train \
        --workspace W --config_yaml C --resume_checkpoint_path ""

(``train.batch_size_per_device`` rows per card; the directories end in
``,devices=N``; rank 0 writes ``--launch_counts``). ``--model_parallel M``
adds lass_tpu's model axis: the N ranks form an (N / M) x M grid and the
wide layers and their optimizer moments are sharded over each group of M
(``lass_torch.parallel.tensor``); the global batch stays N x
``batch_size_per_device``. On the CPU (gloo):

    python -m torch.distributed.run --nproc_per_node 2 -m lass_torch.train \
        --workspace W --config_yaml C --resume_checkpoint_path "" \
        --device cpu --model_parallel 2

On cards the ranks take NCCL, or gloo where more ranks than cards run on
one host. ``--profile PATH``
profiles rank 0's steps after the first and writes their wall time and
the device time of NCCL's kernels (and of BatchNorm's collectives apart)
as JSON.
"""
import argparse
import json
import time


def launch_counts() -> dict:
    from lass_torch.ops import (
        act_conv, convblock, convt, masking, timetap_conv)

    return {"apply_complex_mask_ri": masking.LAUNCHES,
            "apply_complex_mask": masking.B2_LAUNCHES,
            "fused_act_conv3x3": act_conv.LAUNCHES,
            "fused_residual_conv_block": convblock.LAUNCHES,
            "fused_act_convT": convt.LAUNCHES,
            "apply_head_mask": masking.HEAD_LAUNCHES,
            "timetap_conv": timetap_conv.LAUNCHES}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m lass_torch.train")
    parser.add_argument("--workspace", type=str, required=True,
                        help="Directory of workspace.")
    parser.add_argument("--config_yaml", type=str, required=True,
                        help="Path of config file for training.")
    parser.add_argument("--resume_checkpoint_path", type=str, required=True,
                        default="",
                        help="Checkpoint file or directory to resume from "
                             "('' starts from scratch).")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="Optional step cap (smoke runs).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu.")
    parser.add_argument("--log_every", type=int, default=50,
                        help="Steps between metric records (step 1 is "
                             "always recorded).")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="Tensor-parallel degree over the ranks (the "
                             "grid's model axis).")
    parser.add_argument("--eval_indexes", type=str, default=None,
                        help="DCASE eval CSV for periodic evaluation "
                             "(every train.evaluate_step_frequency steps).")
    parser.add_argument("--eval_audio_dir", type=str, default=None,
                        help="Directory of the eval CSV's wavs.")
    parser.add_argument("--launch_counts", type=str, default=None,
                        help="Write the kernels' launch counts here (JSON) "
                             "at exit.")
    parser.add_argument("--profile", type=str, default=None,
                        help="Profile rank 0's steps after the first and "
                             "write the collectives' device time here "
                             "(JSON).")
    args = parser.parse_args(argv)

    from lass_torch.parallel.host import host_info, initialize_distributed
    from lass_torch.train.loop import Trainer, make_dcase_eval_hook

    if bool(args.eval_indexes) != bool(args.eval_audio_dir):
        parser.error("--eval_indexes and --eval_audio_dir go together")
    device = initialize_distributed(device=args.device)
    trainer = Trainer(config_yaml=args.config_yaml, workspace=args.workspace,
                      resume_checkpoint_path=args.resume_checkpoint_path
                      or None, device=str(device),
                      log_every=args.log_every,
                      model_parallel=args.model_parallel)
    eval_hook = (make_dcase_eval_hook(args.eval_indexes, args.eval_audio_dir)
                 if args.eval_indexes else None)
    main_process = host_info()[0] == 0
    profiler = (StepProfiler(args.profile, device)
                if args.profile and main_process else None)
    try:
        trainer.fit(max_steps=args.max_steps, eval_hook=eval_hook,
                    step_hook=profiler)
    finally:
        if profiler is not None:
            profiler.close()
        if args.launch_counts and main_process:
            with open(args.launch_counts, "w") as f:
                json.dump(launch_counts(), f)


def _device_us(event) -> float:
    """Device time (us) of the kernels and copies an op launched, its
    children's included."""
    return (sum(k.duration for k in event.kernels)
            + sum(_device_us(c) for c in event.cpu_children))


class StepProfiler:
    """``Trainer.fit``'s step hook for ``--profile``: torch.profiler from
    the end of step 1 to the end of the last step; at ``close`` a JSON
    file of the window's steps and wall seconds (host clock between two
    synchronisations) and the device seconds of NCCL's kernels and of
    BatchNorm's collectives (``lass::bn_collective``: the statistics'
    all-gather, the grad sums' all-reduce), each also as a share of the
    wall time (gloo's collectives run on the host: no device time)."""

    def __init__(self, path: str, device):
        import torch

        self.path, self.device = path, device
        self.torch = torch
        self.prof = None
        self.first = self.last = None
        self.t0 = self.t1 = None

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def __call__(self, step: int) -> None:
        torch = self.torch
        self._sync()
        if self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.first, self.t0 = step, time.perf_counter()
        else:
            self.last, self.t1 = step, time.perf_counter()

    def close(self) -> None:
        if self.prof is None:
            return
        self._sync()
        self.prof.stop()
        if self.last is None:
            return
        from torch.autograd import DeviceType

        events = self.prof.events()
        # NCCL's kernels by name: under their host ranges DDP's all-reduces
        # showed no device time (a four-card run)
        comm = sum(e.time_range.elapsed_us() for e in events
                   if e.device_type == DeviceType.CUDA
                   and "nccl" in e.name.lower())
        # the host's ranges (each also has a device-side copy)
        bn = [e for e in events if e.device_type == DeviceType.CPU
              and e.name == "lass::bn_collective"]
        bn_calls, bn = len(bn), sum(_device_us(e) for e in bn)
        wall = self.t1 - self.t0
        out = {"steps": self.last - self.first, "wall_s": wall,
               "collective_device_s": comm / 1e6,
               "collective_share": comm / 1e6 / wall,
               "bn_collective_device_s": bn / 1e6,
               "bn_collective_share": bn / 1e6 / wall,
               "bn_collective_calls": bn_calls}
        with open(self.path, "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()
