"""DCASE 2024 Task 9 evaluation CLI (counterpart of the root
dcase_evaluator.py): a checkpoint over (csv, audio_dir) -> SDR, SDRi,
SI-SDR.

    python -m lass_torch.dcase_evaluator --checkpoint_path CKPT \\
        --eval_indexes lass_synthetic_validation.csv \\
        --audio_dir lass_validation [--config_yaml config/audiosep_base.yaml]
        [--batch_size 16] [--quantize] [--config {default,A,B}]
        [--dsp_precision {default,high,highest}] [--device cuda]
    python -m torch.distributed.run --nproc_per_node N \
        -m lass_torch.dcase_evaluator --data_parallel ...

Runs on the GPU unless ``--device cpu`` is given. ``--data_parallel``
under the launcher: one process per card, each separating a disjoint
share of the eval batches; the per-clip metrics are gathered and rank 0
prints the line one card would (not with ``--quantize``). ``--quantize`` runs the
int8 separator (lass_torch/ops/quant.py), calibrated on the first four
eval batches and packed on the last of them. As in the root CLI, the
caption encoder has random weights unless a CLAP pack is loaded.
"""
import argparse


def evaluate(evaluator, checkpoint_path: str,
             config_yaml: str = "config/audiosep_base.yaml",
             query_encoder=None, quantize: bool = False,
             config: str = "default", device: str = "cuda",
             dsp_precision=None):
    """Load the separator, calibrate it if ``quantize``, run the evaluator;
    returns (SI-SDR, SDRi, SDR). ``dsp_precision`` overrides the config's
    ``model.dsp_precision`` where given."""
    from lass_torch.config import load_config
    from lass_torch.convert.checkpoint_io import load_ss_model
    from lass_torch.parallel.host import host_info

    if quantize and evaluator.data_parallel:
        raise NotImplementedError("--quantize with --data_parallel (nor in "
                                  "the root CLI)")
    cfg = load_config(config_yaml)
    if dsp_precision:
        cfg.model.dsp_precision = dsp_precision
    pl_model = load_ss_model(cfg, checkpoint_path, query_encoder, device,
                             quantize=quantize, config=config)
    if quantize:
        evaluator.calibrate(pl_model)
    main_process = host_info()[0] == 0
    if main_process:
        print("-------  Start Evaluation  -------")
    sisdr, sdri, sdr = evaluator(pl_model)
    if main_process:
        print(f"SDR: {sdr:.3f}, SDRi: {sdri:.3f}, SISDR: {sisdr:.3f}")
        print("-------------------------  Done  ---------------------------")
    return sisdr, sdri, sdr


def main(argv=None):
    from lass_torch.models.resunet import CONFIGS

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint_path", required=True)
    parser.add_argument("--config_yaml", default="config/audiosep_base.yaml")
    parser.add_argument("--eval_indexes",
                        default="lass_synthetic_validation.csv")
    parser.add_argument("--audio_dir", default="lass_validation")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--quantize", action="store_true",
                        help="int8 separator, calibrated on the first four "
                             "eval batches")
    parser.add_argument("--config", default="default", choices=sorted(CONFIGS),
                        help="serving configuration (A and B run the fused "
                             "conv kernels; on the card they need "
                             "compute_dtype bfloat16)")
    parser.add_argument("--dsp_precision", default=None,
                        choices=["default", "high", "highest"],
                        help="accepted for parity with dcase_evaluator.py "
                             "(overrides config); the port's DSP always "
                             "runs in full float32")
    parser.add_argument("--data_parallel", action="store_true",
                        help="one process per card under python -m "
                             "torch.distributed.run, each separating its "
                             "share of the eval batches")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from lass_torch.evaluation.dcase import DCASEEvaluator
    from lass_torch.parallel.host import initialize_distributed

    device = (initialize_distributed(device=args.device)
              if args.data_parallel else args.device)
    evaluator = DCASEEvaluator(sampling_rate=16000,
                               eval_indexes=args.eval_indexes,
                               audio_dir=args.audio_dir,
                               batch_size=args.batch_size,
                               data_parallel=args.data_parallel)
    return evaluate(evaluator, args.checkpoint_path, args.config_yaml,
                    quantize=args.quantize, config=args.config,
                    device=str(device), dsp_precision=args.dsp_precision)


if __name__ == "__main__":
    main()
