"""Language-queried separation CLI: mixture wav + caption -> separated wav.

    python -m lass_torch.separate --checkpoint_path CKPT --input mix.wav \\
        --query "a dog barking" --output sep.wav \\
        [--config_yaml config/audiosep_base.yaml] [--device cuda] \
        [--chunked] [--quantize] [--config {default,A,B}]

CKPT is a reference/port ``.ckpt``/``.pt`` or an npz pack (see
lass_torch/convert/checkpoint_io.py). Runs on the GPU unless
``--device cpu`` is given. ``--chunked`` separates in overlapping 10 s
windows (``SeparationInference.separate_long``), for inputs longer than
one forward's memory allows. ``--quantize`` runs the int8 separator,
calibrated and packed on the input's first segment
(``data.segment_seconds``). As in separate.py, the caption encoder has
random weights (and, without roberta vocab assets, the hash fallback
tokenizer).
"""
import argparse


def main(argv=None):
    from lass_torch.models.resunet import CONFIGS

    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint_path", required=True)
    parser.add_argument("--input", required=True)
    parser.add_argument("--query", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--config_yaml", default="config/audiosep_base.yaml")
    parser.add_argument("--dsp_precision", default=None,
                        choices=["default", "high", "highest"],
                        help="accepted for parity with separate.py; the "
                             "port's DSP always runs in full float32")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--chunked", action="store_true",
                        help="overlapped-window inference for long audio")
    parser.add_argument("--quantize", action="store_true",
                        help="int8 separator, calibrated on the input's "
                             "first segment")
    parser.add_argument("--config", default="default",
                        choices=sorted(CONFIGS),
                        help="serving configuration (A and B run the fused "
                             "conv kernels; on the card they need "
                             "compute_dtype bfloat16)")
    args = parser.parse_args(argv)

    import numpy as np

    from lass_torch.audio.io import read_audio, write_wav
    from lass_torch.audio.resample import resample_np
    from lass_torch.config import load_config
    from lass_torch.convert.checkpoint_io import load_ss_model

    cfg = load_config(args.config_yaml)
    if args.dsp_precision:
        cfg.model.dsp_precision = args.dsp_precision
    model = load_ss_model(cfg, args.checkpoint_path, device=args.device,
                          quantize=args.quantize, config=args.config)

    audio, sr = read_audio(args.input, mono=True)
    wave = audio[0]
    if sr != cfg.data.sampling_rate:
        wave = resample_np(wave, sr, cfg.data.sampling_rate)

    condition = model.query_encoder.get_query_embed("text", text=[args.query])
    if args.quantize:
        head = np.zeros((1, 1, cfg.data.segment_samples), np.float32)
        n = min(len(wave), head.shape[-1])
        head[0, 0, :n] = wave[:n]
        model.calibrate(head, condition)
        model.pack(head, condition)
    mixture = wave[None, None, :].astype(np.float32)
    if args.chunked:
        separated = model.separate_long(mixture, condition)[0]
    else:
        separated = model.separate(mixture, condition)[0, 0]

    write_wav(args.output, separated[None, :], cfg.data.sampling_rate)
    duration = len(separated) / cfg.data.sampling_rate
    print(f"wrote {args.output} ({duration:.1f}s at "
          f"{cfg.data.sampling_rate} Hz)")


if __name__ == "__main__":
    main()
