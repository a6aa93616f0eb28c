"""Language-queried separation CLI: mixture wav + caption -> separated wav.

    python -m lass_torch.separate --checkpoint_path CKPT --input mix.wav \\
        --query "a dog barking" --output sep.wav \\
        [--config_yaml config/audiosep_base.yaml] [--device cuda]

CKPT is a reference/port ``.ckpt``/``.pt`` or an npz pack (see
lass_torch/convert/checkpoint_io.py). Runs on the GPU unless
``--device cpu`` is given. As in separate.py, the caption encoder has
random weights (and, without roberta vocab assets, the hash fallback
tokenizer).
"""
import argparse


def main(argv=None):
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
    args = parser.parse_args(argv)

    import numpy as np

    from lass_torch.audio.io import read_audio, write_wav
    from lass_torch.audio.resample import resample_np
    from lass_torch.config import load_config
    from lass_torch.convert.checkpoint_io import load_ss_model

    cfg = load_config(args.config_yaml)
    if args.dsp_precision:
        cfg.model.dsp_precision = args.dsp_precision
    model = load_ss_model(cfg, args.checkpoint_path, device=args.device)

    audio, sr = read_audio(args.input, mono=True)
    wave = audio[0]
    if sr != cfg.data.sampling_rate:
        wave = resample_np(wave, sr, cfg.data.sampling_rate)

    condition = model.query_encoder.get_query_embed("text", text=[args.query])
    separated = model.separate(wave[None, None, :].astype(np.float32),
                               condition)[0, 0]

    write_wav(args.output, separated[None, :], cfg.data.sampling_rate)
    duration = len(separated) / cfg.data.sampling_rate
    print(f"wrote {args.output} ({duration:.1f}s at "
          f"{cfg.data.sampling_rate} Hz)")


if __name__ == "__main__":
    main()
