"""lass_torch's checkpoint converters against lass_tpu's, on the CPU: every
``convert_*`` of ``lass_torch.convert.torch_to_pack`` and
``lass_tpu.convert.torch_to_jax`` on the same reference-layout state
dicts, ``rekey_pretrained_audio`` on each named layout,
``python -m lass_torch.convert_checkpoint`` against
scripts/convert_checkpoint.py for each ``--kind``, and the packs read back
by ``CLAPQueryEncoder.from_npz``.

Reference-layout dicts: transformers' random ``RobertaModel``,
``BertModel`` and ``BartModel`` (decoder and ``shared.weight`` kept) at a
small config, as tests/test_bert.py builds them, behind a CLAP
checkpoint's ``module.`` prefix and ``text_projection.{0,2}``, with keys
the converters must ignore; small HTSAT and PANN state dicts from the
port's own modules. Converter outputs and npz packs must be equal
bitwise; a pack read back must reproduce its source module's embedding
within 1e-6 (float32).
"""
import importlib.util
import subprocess
import sys

import numpy as np
import pytest
import torch

from lass_tpu.convert import torch_to_jax as jax_conv
from lass_torch.convert import torch_to_pack as conv
from lass_torch.convert.checkpoint_io import (
    load_torch_ckpt, save_ss_checkpoint)
from lass_torch.convert_checkpoint import flatten
from lass_torch.convert_checkpoint import main as port_cli
from lass_torch.dsp.mel import LogMelConfig
from lass_torch.models.clap.bert import BartConfig, BertConfig
from lass_torch.models.clap.htsat import HTSAT, HTSATConfig
from lass_torch.models.clap.model import (
    CLAPAudioEncoder, CLAPBartTextEncoder, CLAPBertTextEncoder,
    CLAPTextEncoder)
from lass_torch.models.clap.pann import PANN, PANNConfig
from lass_torch.models.clap.roberta import RobertaConfig
from lass_torch.models.clap.tokenizer import WhitespaceFallbackTokenizer
from lass_torch.models.query_encoder import CLAPQueryEncoder
from lass_torch.models.resunet import ResUNet30
from torch_threads import torch_threads_per_worker  # noqa: F401

transformers = pytest.importorskip("transformers")

REPO = __file__.rsplit("/tests/", 1)[0]
SMALL = dict(vocab_size=99, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=40)
JOINT = 16
MEL = LogMelConfig(n_fft=256, n_mels=32)
# the widths of tests/test_torch_htsat.py's TINY at HTSAT-base's depths,
# which convert_clap_audio_encoder and --kind clap assume
DEEP_TINY = HTSATConfig(spec_size=128, embed_dim=16, depths=(2, 2, 12, 2),
                        num_heads=(2, 2, 2, 2), window_size=4, mel=MEL)
# a 12-layer RoBERTa, as --kind clap and --kind roberta assume
ROBERTA12 = RobertaConfig(**{**SMALL, "num_hidden_layers": 12,
                             "max_position_embeddings": 42})
EXTRAS = ("logit_scale_a", "logit_scale_t",
          "text_transform.sequential.0.weight",
          "audio_transform.sequential.0.bias")


def assert_same_tree(got, want, path=""):
    assert isinstance(got, dict) and isinstance(want, dict), path
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            assert_same_tree(got[k], want[k], f"{path}/{k}")
        else:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.dtype == b.dtype and a.shape == b.shape, f"{path}/{k}"
            assert np.array_equal(a, b), f"{path}/{k}"


def hf_branch(model_type):
    """A random transformers model at SMALL, eval mode."""
    common = dict(vocab_size=SMALL["vocab_size"],
                  max_position_embeddings=SMALL["max_position_embeddings"])
    torch.manual_seed({"roberta": 0, "bert": 1, "bart": 2}[model_type])
    if model_type == "bart":
        cfg = transformers.BartConfig(
            d_model=32, encoder_layers=2, decoder_layers=1,
            encoder_attention_heads=4, decoder_attention_heads=4,
            encoder_ffn_dim=64, decoder_ffn_dim=64, pad_token_id=1,
            activation_function="gelu", scale_embedding=False, **common)
        return transformers.BartModel(cfg).eval()
    cls = {"roberta": (transformers.RobertaConfig, transformers.RobertaModel),
           "bert": (transformers.BertConfig, transformers.BertModel)}
    cfg = cls[model_type][0](
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, hidden_act="gelu", **common)
    return cls[model_type][1](cfg).eval()


def clap_text_dict(branch_sd, rng, width=32):
    """A CLAP checkpoint's text side: module.text_branch.*,
    module.text_projection.{0,2}, and keys no converter reads."""
    sd = {f"module.text_branch.{k}": v for k, v in branch_sd.items()}
    sd["module.text_branch.embeddings.position_ids"] = torch.arange(40)[None]
    for i, (d_in, d_out) in ((0, (width, JOINT)), (2, (JOINT, JOINT))):
        sd[f"module.text_projection.{i}.weight"] = torch.from_numpy(
            rng.randn(d_out, d_in).astype(np.float32))
        sd[f"module.text_projection.{i}.bias"] = torch.from_numpy(
            rng.randn(d_out).astype(np.float32))
    for k in EXTRAS:
        sd[f"module.{k}"] = torch.ones(3)
    return sd


@pytest.mark.parametrize("model_type", ["roberta", "bert", "bart"])
def test_text_converters_match_jax(model_type, rng):
    hf = hf_branch(model_type).state_dict()
    if model_type == "bart":
        assert "shared.weight" in hf and any(k.startswith("decoder.")
                                             for k in hf)
    sd = clap_text_dict(hf, rng)
    assert_same_tree(
        conv.convert_clap_text_encoder(sd, 2, model_type=model_type),
        jax_conv.convert_clap_text_encoder(sd, 2, model_type=model_type))
    branch = {"roberta": "convert_hf_roberta_state",
              "bert": "convert_hf_bert_state",
              "bart": "convert_hf_bart_encoder_state"}[model_type]
    assert_same_tree(getattr(conv, branch)(hf, 2),
                     getattr(jax_conv, branch)(hf, 2))
    if model_type == "bart":  # a 'model.' prefix, and no shared table
        wrapped = {f"model.{k}": v for k, v in hf.items()
                   if k != "shared.weight"}
        assert_same_tree(conv.convert_hf_bart_encoder_state(wrapped, 2),
                         jax_conv.convert_hf_bart_encoder_state(wrapped, 2))


def test_missing_keys_raise(rng):
    sd = clap_text_dict(hf_branch("bert").state_dict(), rng)
    del sd["module.text_projection.2.weight"]
    for package in (conv, jax_conv):
        with pytest.raises(KeyError):
            package.convert_clap_text_encoder(sd, 2, model_type="bert")
    with pytest.raises(NotImplementedError):
        conv.convert_clap_text_encoder(sd, 2, model_type="transformer")


def test_bart_pack_without_token_table_matches_jax():
    """Neither shared.weight nor encoder.embed_tokens.weight: both
    converters pack None for the token table and the rest alike."""
    bart = {k: v for k, v in hf_branch("bart").state_dict().items()
            if k not in ("shared.weight", "encoder.embed_tokens.weight")}
    got = conv.convert_hf_bart_encoder_state(bart, 2)
    want = jax_conv.convert_hf_bart_encoder_state(bart, 2)
    assert got["embed_tokens"]["embedding"] is None
    assert want["embed_tokens"]["embedding"] is None
    del got["embed_tokens"], want["embed_tokens"]
    assert_same_tree(got, want)


def _htsat_cfg(fusion_type):
    fusion = dict(enable_fusion=True, fusion_type=fusion_type) \
        if fusion_type else {}
    return HTSATConfig(spec_size=128, embed_dim=16, depths=(1, 1, 1, 1),
                       num_heads=(2, 2, 2, 2), window_size=4, mel=MEL,
                       **fusion)


def _randomized(module, seed):
    """A module's state dict with every float entry drawn from a seed (BN
    statistics positive), so that no two converted arrays coincide."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in module.state_dict().items():
        if v.is_floating_point():
            v = torch.from_numpy(rng.rand(*v.shape).astype(np.float32)
                                 + (0.5 if k.endswith("running_var")
                                    else -0.5))
        out[k] = v
    return out


@pytest.mark.parametrize("fusion_type", [None, "aff_1d", "iaff_2d"])
def test_audio_converters_match_jax(fusion_type):
    cfg = _htsat_cfg(fusion_type)
    sd = _randomized(CLAPAudioEncoder(cfg), 3)
    ckpt = {f"module.{k}": v for k, v in sd.items()}
    ckpt.update({f"module.{k}": torch.ones(2) for k in EXTRAS})
    assert_same_tree(
        conv.convert_clap_audio_encoder(ckpt, cfg.depths),
        jax_conv.convert_clap_audio_encoder(ckpt, cfg.depths))
    branch = {k[len("audio_branch."):]: v for k, v in sd.items()
              if k.startswith("audio_branch.")}
    assert_same_tree(conv.convert_htsat(branch, cfg.depths),
                     jax_conv.convert_htsat(branch, cfg.depths))


@pytest.mark.parametrize("fusion_type", [None, "iaff_2d"])
def test_pann_converter_matches_jax(fusion_type):
    fusion = dict(enable_fusion=True, fusion_type=fusion_type) \
        if fusion_type else {}
    sd = _randomized(PANN(PANNConfig("Cnn6", mel=MEL, **fusion)), 4)
    assert_same_tree(conv.convert_pann(sd, "Cnn6"),
                     jax_conv.convert_pann(sd, "Cnn6"))


def _layouts():
    """(amodel, filename, checkpoint) for each layout the reference's
    factory recognizes."""
    a, b, c = (np.full(2, float(i), np.float32) for i in range(3))
    front = "spectrogram_extractor.stft.conv_real.weight"
    return [
        ("PANN-14", "/w/Cnn14_mAP=0.431.pth",
         {"model": {front: a, "bn0.weight": b, "fc1.weight": c}}),
        ("PANN-10", "/w/PANN-10_fullset.ckpt",
         {"state_dict": {"sed_model.bn0.weight": a, "loss.w": b,
                         f"sed_model.{front}": c}}),
        ("HTSAT-base", "/w/HTSAT_AudioSet_Saved_1.ckpt",
         {"state_dict": {"sed_model.bn0.weight": a, "other.w": b,
                         f"sed_model.{front}": c}}),
        ("HTSAT-tiny", "/w/HTSAT-fullset-map=0.467.ckpt",
         {"state_dict": {"sed_model.norm.weight": a,
                         f"sed_model.{front}": c}}),
        ("HTSAT-base", "/w/finetuned_esc50.pt",
         {"audio_branch.bn0.weight": a, "lp.w": b}),
    ]


@pytest.mark.parametrize("case", range(5))
def test_rekey_pretrained_audio_matches_jax(case):
    amodel, filename, ckpt = _layouts()[case]
    got = conv.rekey_pretrained_audio(ckpt, amodel, filename)
    want = jax_conv.rekey_pretrained_audio(ckpt, amodel, filename)
    assert got.keys() == want.keys() and len(got) >= 2
    assert all(got[k] is want[k] for k in want)
    for package in (conv, jax_conv):
        with pytest.raises(ValueError):
            package.rekey_pretrained_audio(ckpt, amodel, "/w/other.ckpt")


def test_convert_pretrained_audio_matches_jax():
    pann = _randomized(PANN(PANNConfig("Cnn6", mel=MEL)), 5)
    ckpt = {"state_dict": {f"sed_model.{k}": v for k, v in pann.items()}}
    assert_same_tree(
        conv.convert_pretrained_audio(ckpt, "PANN-6", "/w/PANN-6.ckpt"),
        jax_conv.convert_pretrained_audio(ckpt, "PANN-6", "/w/PANN-6.ckpt"))
    htsat = _randomized(HTSAT(DEEP_TINY), 6)
    ckpt = {"state_dict": {f"sed_model.{k}": v for k, v in htsat.items()}}
    name = "/w/HTSAT_AudioSet_Saved_2.ckpt"
    assert_same_tree(
        conv.convert_pretrained_audio(ckpt, "HTSAT-base", name),
        jax_conv.convert_pretrained_audio(ckpt, "HTSAT-base", name))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "convert_ckpt", f"{REPO}/scripts/convert_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_same_npz(got, want):
    with np.load(got) as a, np.load(want) as b:
        assert sorted(a.files) == sorted(b.files) and a.files
        for k in b.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _both_clis(kind, src, tmp_path, monkeypatch, subprocess_run=False):
    """The npz of each CLI for ``src``: the port's in process (or as
    ``python -m``), the JAX script's through its main()."""
    port, ref = tmp_path / f"{kind}_port.npz", tmp_path / f"{kind}_jax.npz"
    args = ["--kind", kind, "--input", str(src)]
    if subprocess_run:
        done = subprocess.run(
            [sys.executable, "-m", "lass_torch.convert_checkpoint", *args,
             "--output", str(port)], cwd=REPO, capture_output=True,
            text=True, timeout=120)
        assert done.returncode == 0, done.stderr[-2000:]
        assert "wrote" in done.stdout
    else:
        port_cli(args + ["--output", str(port)])
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint.py", *args,
                                      "--output", str(ref)])
    _jax_script().main()
    _assert_same_npz(port, ref)
    return port


def test_cli_audiosep_matches_jax_script(tmp_path, monkeypatch):
    torch.manual_seed(7)
    src = tmp_path / "audiosep.ckpt"
    save_ss_checkpoint(ResUNet30(), str(src))
    _both_clis("audiosep", src, tmp_path, monkeypatch)


def _source_clap(seed=8):
    """A RoBERTa (12 layers, SMALL widths) + DEEP_TINY HTSAT CLAP pair with
    random weights and the reference checkpoint built from them."""
    torch.manual_seed(seed)
    text = CLAPTextEncoder(ROBERTA12).eval()
    audio = CLAPAudioEncoder(DEEP_TINY).eval()
    audio.load_state_dict(_randomized(audio, seed))
    sd = {**text.state_dict(), **audio.state_dict()}
    ckpt = {f"module.{k}": v for k, v in sd.items()}
    ckpt.update({f"module.{k}": torch.ones(2) for k in EXTRAS})
    return text, audio, {"epoch": 15, "state_dict": ckpt}


def test_cli_clap_matches_jax_script_and_loads(tmp_path, monkeypatch, rng):
    text, audio, ckpt = _source_clap()
    src = tmp_path / "clap.pt"
    torch.save(ckpt, src)
    pack = _both_clis("clap", src, tmp_path, monkeypatch)
    enc = CLAPQueryEncoder.from_npz(
        str(pack), roberta_cfg=ROBERTA12, htsat_cfg=DEEP_TINY, device="cpu",
        tokenizer=WhitespaceFallbackTokenizer(SMALL["vocab_size"]))
    assert enc.has_pretrained_text and enc.has_pretrained_audio
    tok = enc.tokenizer(["a dog barking", "rain"], pad_to=16)
    ids = torch.from_numpy(tok["input_ids"]).long()
    mask = torch.from_numpy(tok["attention_mask"]).long()
    wave = torch.from_numpy((0.1 * rng.randn(2, 48000)).astype(np.float32))
    with torch.no_grad():
        pairs = ((enc.text_model(ids, mask), text(ids, mask)),
                 (enc.audio_model(wave), audio(wave)))
    for got, want in pairs:
        assert (got - want).abs().max().item() <= 1e-6


def test_cli_roberta_matches_jax_script(tmp_path, monkeypatch):
    torch.manual_seed(9)
    src = tmp_path / "roberta.pt"
    torch.save(CLAPTextEncoder(ROBERTA12).text_branch.state_dict(), src)
    _both_clis("roberta", src, tmp_path, monkeypatch, subprocess_run=True)


@pytest.mark.parametrize("model_type", ["bert", "bart"])
def test_text_pack_reproduces_its_source(model_type, tmp_path, rng):
    """A reference-layout BERT or BART CLAP checkpoint (BART's with
    ``shared.weight`` and a decoder key) saved, read with load_torch_ckpt,
    converted by model_type, packed as the CLI packs, and read back by
    from_npz(tmodel=...): the source module's embedding."""
    torch.manual_seed(10)
    if model_type == "bert":
        cfg, source = BertConfig(**SMALL), CLAPBertTextEncoder
    else:
        cfg, source = BartConfig(**SMALL), CLAPBartTextEncoder
    source = source(cfg, JOINT).eval()
    sd = {f"module.{k}": v for k, v in source.state_dict().items()}
    if model_type == "bart":
        sd["module.text_branch.shared.weight"] = \
            sd["module.text_branch.encoder.embed_tokens.weight"]
        sd["module.text_branch.decoder.layers.0.fc1.weight"] = torch.ones(4)
    sd.update({f"module.{k}": torch.ones(2) for k in EXTRAS})
    torch.save({"state_dict": sd}, tmp_path / "clap.pt")
    params = conv.convert_clap_text_encoder(
        load_torch_ckpt(str(tmp_path / "clap.pt")), 2, model_type=model_type)
    assert set(params) == {model_type, "text_projection"}
    np.savez(tmp_path / "pack.npz", **{f"text/params/{k}": v
                                       for k, v in flatten(params).items()})
    enc = CLAPQueryEncoder.from_npz(
        str(tmp_path / "pack.npz"), tmodel=model_type, text_cfg=cfg,
        joint_embed_dim=JOINT, device="cpu", pad_to=16,
        tokenizer=WhitespaceFallbackTokenizer(SMALL["vocab_size"]))
    captions = ["a dog barking", "rain on a roof", "x"]
    tok = enc.tokenizer(captions, pad_to=16)
    with torch.no_grad():
        want = source(torch.from_numpy(tok["input_ids"]).long(),
                      torch.from_numpy(tok["attention_mask"]).long())
    got = enc.get_query_embed("text", text=captions)
    assert (got - want).abs().max().item() <= 1e-6
