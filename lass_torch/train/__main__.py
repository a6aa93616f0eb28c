"""Train CLI (counterpart of the repository's train.py):

    python -m lass_torch.train --workspace W --config_yaml C \
        --resume_checkpoint_path P [--max_steps N] [--device cuda]

``--resume_checkpoint_path ""`` starts from scratch; a checkpoint file
(``.../<step>.ckpt``) or a checkpoint directory (its latest) resumes.
``--launch_counts PATH`` writes, at exit, how many times each of the
port's kernels was launched (JSON), so a check can tell which kernels the
run went through.
"""
import argparse
import json


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
    parser.add_argument("--launch_counts", type=str, default=None,
                        help="Write the kernels' launch counts here (JSON) "
                             "at exit.")
    args = parser.parse_args(argv)

    from lass_torch.train.loop import Trainer

    trainer = Trainer(config_yaml=args.config_yaml, workspace=args.workspace,
                      resume_checkpoint_path=args.resume_checkpoint_path
                      or None, device=args.device,
                      log_every=args.log_every)
    try:
        trainer.fit(max_steps=args.max_steps)
    finally:
        if args.launch_counts:
            with open(args.launch_counts, "w") as f:
                json.dump(launch_counts(), f)


if __name__ == "__main__":
    main()
