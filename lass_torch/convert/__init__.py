"""Checkpoint converters: reference PyTorch checkpoints -> npz packs
(``torch_to_pack``), packs and JAX parameter trees -> the port's state
dicts (``from_jax``), and checkpoint IO (``checkpoint_io``)."""
from lass_torch.convert.torch_to_pack import (
    convert_clap_audio_encoder,
    convert_clap_text_encoder,
    convert_hf_bart_encoder_state,
    convert_hf_bert_state,
    convert_hf_roberta_state,
    convert_htsat,
    convert_pann,
    convert_pretrained_audio,
    convert_resunet30,
    rekey_pretrained_audio,
)

__all__ = [
    "convert_clap_audio_encoder",
    "convert_clap_text_encoder",
    "convert_hf_bart_encoder_state",
    "convert_hf_bert_state",
    "convert_hf_roberta_state",
    "convert_htsat",
    "convert_pann",
    "convert_pretrained_audio",
    "convert_resunet30",
    "rekey_pretrained_audio",
]
