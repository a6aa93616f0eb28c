"""lass_torch serving surface: SeparationInference vs the JAX forward,
checkpoint round trips, the host audio helpers and the CLI."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.audio import io as jax_io
from lass_tpu.audio.resample import resample_np as jax_resample_np
from lass_tpu.config import load_config as jax_load_config
from lass_tpu.convert.checkpoint_io import load_torch_ckpt
from lass_tpu.convert.torch_to_jax import convert_resunet30
from lass_tpu.models.film import resunet30_film_spec as jax_film_spec
from lass_tpu.models.resunet import ResUNet30 as JaxResUNet30
from lass_torch.audio import io as port_io
from lass_torch.audio.resample import resample_np
from lass_torch.config import Config, load_config
from lass_torch.convert import checkpoint_io
from lass_torch.convert.from_jax import resunet30_state_dict_from_jax
from lass_torch.models.clap.roberta import RobertaConfig
from lass_torch.models.clap.tokenizer import WhitespaceFallbackTokenizer
from lass_torch.models.query_encoder import CLAPQueryEncoder
from lass_torch.models.resunet import ResUNet30
from torch_threads import torch_threads_per_worker  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A port-written checkpoint (reference layout) with seeded weights and
    random BN statistics and FiLM bias."""
    torch.manual_seed(1)
    model = ResUNet30()
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.3, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
                mod.bias.normal_(0, 0.1, generator=gen)
        model.film.bias.normal_(0, 0.1, generator=gen)
    path = str(tmp_path_factory.mktemp("ckpt") / "sep.ckpt")
    checkpoint_io.save_ss_checkpoint(model, path)
    return path, model.state_dict()


def _small_query_encoder():
    cfg = RobertaConfig(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128)
    return CLAPQueryEncoder(roberta_cfg=cfg, device="cpu",
                            tokenizer=WhitespaceFallbackTokenizer(1000))


def test_separate_matches_jax_at_odd_length(checkpoint):
    """separate() pads 7001 samples to the hop multiple 7040, runs, crops;
    the JAX forward on the same padded input, cropped, must agree within
    rel err 1e-4 (tests/test_reference_parity.py's float32 bound)."""
    path, _ = checkpoint
    cfg = Config()
    cfg.model.compute_dtype = "float32"
    sep = checkpoint_io.load_ss_model(cfg, path, _small_query_encoder(),
                                      device="cpu")
    rng = np.random.RandomState(0)
    mix = (rng.randn(2, 1, 7001) * 0.1).astype(np.float32)
    cond = sep.query_encoder.get_query_embed(
        "text", text=["a dog barking", "rain"])
    got = sep.separate(mix, cond)
    assert got.shape == (2, 1, 7001) and got.dtype == np.float32

    variables = convert_resunet30(load_torch_ckpt(path), jax_film_spec())
    padded = np.pad(mix, ((0, 0), (0, 0), (0, 39)))
    ref = JaxResUNet30(freq_fold=1, dsp_precision=jax.lax.Precision.HIGHEST)
    ref = np.asarray(jax.jit(lambda v, m, c: ref.apply(
        v, {"mixture": m, "condition": c})["waveform"])(
        variables, jnp.asarray(padded), jnp.asarray(cond.numpy())))
    ref = ref[..., :7001]
    err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert err <= 1e-4


def test_checkpoint_round_trips_are_exact(checkpoint, tmp_path):
    path, port_sd = checkpoint
    # reference layout -> the port, through the torch file
    loaded = checkpoint_io.separator_state_dict(path)
    # reference layout -> JAX tree (convert_resunet30) -> the port
    via_jax = resunet30_state_dict_from_jax(
        convert_resunet30(load_torch_ckpt(path), jax_film_spec()))
    # ... and through an npz pack as scripts/convert_checkpoint.py writes it
    flat = {}

    def flatten(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}/{k}"
            if isinstance(v, dict):
                flatten(v, key)
            else:
                flat[key[1:]] = np.asarray(v)

    flatten(convert_resunet30(load_torch_ckpt(path), jax_film_spec()), "")
    npz = tmp_path / "sep.npz"
    np.savez(npz, **flat)
    via_npz = checkpoint_io.separator_state_dict(str(npz))
    for sd in (loaded, via_jax, via_npz):
        assert set(k for k in sd if not k.endswith("num_batches_tracked")) \
            == set(k for k in port_sd if not k.endswith("num_batches_tracked"))
        for k, v in sd.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, port_sd[k]), k
    # the file holds the per-path FiLM Linears the reference names
    on_disk = torch.load(path, weights_only=True)["state_dict"]
    unpacked = checkpoint_io.unpack_film(port_sd)
    assert set(on_disk) == {f"ss_model.{k}" for k in unpacked}
    offset = 0
    for path_keys, feat, _ in jax_film_spec():
        key = "ss_model.film." + "->".join(path_keys)
        assert torch.equal(on_disk[key + ".weight"],
                           port_sd["film.weight"][offset:offset + feat])
        assert torch.equal(on_disk[key + ".bias"],
                           port_sd["film.bias"][offset:offset + feat])
        offset += feat


def test_orbax_directory_and_bad_keys_raise(tmp_path, checkpoint):
    with pytest.raises(ValueError, match="orbax"):
        checkpoint_io.separator_state_dict(str(tmp_path))
    sd = torch.load(checkpoint[0], weights_only=True)["state_dict"]
    sd.pop("ss_model.base.after_conv.weight")
    bad = tmp_path / "bad.ckpt"
    torch.save({"state_dict": sd}, bad)
    with pytest.raises(KeyError):
        checkpoint_io.load_separator(ResUNet30(), str(bad))


def test_config_matches_jax():
    path = os.path.join(REPO, "config", "audiosep_base.yaml")
    assert dataclasses.asdict(load_config(path)) == \
        dataclasses.asdict(jax_load_config(path))


def test_wav_io_and_resample_match_jax(tmp_path, rng):
    x = (rng.randn(2, 3001) * 0.3).astype(np.float32)
    for bits in (16, 32):
        p = str(tmp_path / f"a{bits}.wav")
        port_io.write_wav(p, x, 22050, bits=bits)
        got, sr = port_io.read_audio(p, mono=True)
        ref, sr_ref = jax_io.read_audio(p, mono=True)
        assert sr == sr_ref == 22050
        np.testing.assert_allclose(got, ref, atol=1e-7)
    np.testing.assert_allclose(resample_np(x, 22050, 16000),
                               jax_resample_np(x, 22050, 16000), atol=1e-6)


def test_separate_cli_on_cpu(checkpoint, tmp_path, rng):
    path, _ = checkpoint
    cfg_yaml = tmp_path / "cfg.yaml"
    cfg_yaml.write_text("task_name: AudioSep\n"
                        "data:\n    sampling_rate: 16000\n"
                        "model:\n    compute_dtype: float32\n")
    mix = tmp_path / "mix.wav"
    port_io.write_wav(str(mix), rng.randn(1, 12345).astype(np.float32) * 0.1,
                      22050)
    out = tmp_path / "sep.wav"
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("LASS_TPU_ROBERTA_VOCAB_DIR", None)
    result = subprocess.run(
        [sys.executable, "-m", "lass_torch.separate",
         "--checkpoint_path", path, "--input", str(mix),
         "--query", "a dog barking", "--output", str(out),
         "--config_yaml", str(cfg_yaml), "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert result.returncode == 0, result.stderr[-2000:]
    audio, sr = port_io.read_wav(str(out))
    expect = int(np.ceil(12345 * 16000 / 22050))
    assert sr == 16000 and audio.shape == (1, expect)
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0
