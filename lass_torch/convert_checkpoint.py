"""Convert reference PyTorch checkpoints into npz parameter packs, without
JAX (the port's counterpart of scripts/convert_checkpoint.py: the same
kinds, flags and npz keys, the same pack for the same input).

    # AudioSep separation checkpoint (Lightning .ckpt with ss_model.* keys)
    python -m lass_torch.convert_checkpoint --kind audiosep \
        --input audiosep,baseline-16k,step=200000.ckpt --output audiosep.npz

    # CLAP checkpoint (RoBERTa text branch + HTSAT-base audio branch)
    python -m lass_torch.convert_checkpoint --kind clap \
        --input music_speech_audioset_epoch_15_esc_89.98.pt --output clap.npz

    # an HF RobertaModel state dict (12 layers)
    python -m lass_torch.convert_checkpoint --kind roberta \
        --input roberta.pt --output roberta.npz

The packs store flattened trees ('/'-joined paths):
``lass_torch.convert.checkpoint_io.load_npz_variables`` reads them back,
``load_ss_model`` serves an audiosep pack, ``CLAPQueryEncoder.from_npz``
builds the query encoder from a clap pack. A BERT or BART CLAP checkpoint
converts in Python: ``convert_clap_text_encoder(sd, num_layers,
model_type=...)`` from ``lass_torch.convert.torch_to_pack``.
"""
import argparse

import numpy as np


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--kind", required=True,
                   choices=["audiosep", "clap", "roberta"])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    return p


def main(argv=None):
    args = parser().parse_args(argv)

    from lass_torch.convert.checkpoint_io import load_torch_ckpt
    from lass_torch.convert.torch_to_pack import (
        convert_clap_audio_encoder, convert_clap_text_encoder,
        convert_hf_roberta_state, convert_resunet30)
    from lass_torch.models.film import resunet30_film_spec

    sd = load_torch_ckpt(args.input)
    if args.kind == "audiosep":
        variables = convert_resunet30(sd, resunet30_film_spec())
        payload = {**{f"params/{k}": v for k, v in
                      flatten(variables["params"]).items()},
                   **{f"batch_stats/{k}": v for k, v in
                      flatten(variables["batch_stats"]).items()}}
    elif args.kind == "clap":
        text = convert_clap_text_encoder(sd)
        audio = convert_clap_audio_encoder(sd)
        payload = {**{f"text/params/{k}": v for k, v in
                      flatten(text).items()},
                   **{f"audio/params/{k}": v for k, v in
                      flatten(audio["params"]).items()},
                   **{f"audio/batch_stats/{k}": v for k, v in
                      flatten(audio["batch_stats"]).items()}}
    else:
        payload = {f"params/{k}": v for k, v in
                   flatten(convert_hf_roberta_state(sd, 12)).items()}

    np.savez(args.output, **payload)
    print(f"wrote {len(payload)} arrays to {args.output}")


if __name__ == "__main__":
    main()
