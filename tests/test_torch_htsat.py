"""lass_torch's HTSAT (the CLAP audio tower) against lass_tpu's, on the CPU:
its parts (SwinBlock with and without the shifted window, PatchMerging,
the wav2img interleave), the whole TINY HTSAT (all four outputs), the
feature-fusion variants (a long clip and a short one), the converters'
round trip, and the host fusion features.

Same weights on both sides: random values in the JAX package's variable
tree (its init's shapes, ``jax.eval_shape``), through
``lass_torch.convert.from_jax`` into the port. Tolerance: rel err <= 1e-4 (the JAX
package's float32 bound against the torch reference,
tests/test_reference_parity.py); the host features are the same numpy
code and must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.convert.torch_to_jax import convert_clap_audio_encoder
from lass_tpu.dsp.mel import LogMelConfig as JaxMelConfig
from lass_tpu.models.clap import audio_features as jax_features
from lass_tpu.models.clap import htsat as jax_htsat
from lass_tpu.models.clap.fusion import build_mel_fusion as jax_mel_fusion
from lass_tpu.models.clap.model import CLAPAudioEncoder as JaxAudioEncoder
from lass_torch.convert import from_jax
from lass_torch.dsp.mel import LogMelConfig
from lass_torch.models.clap import audio_features, htsat
from lass_torch.models.clap.fusion import build_mel_fusion
from lass_torch.models.clap.model import (
    CLAPAudioEncoder, CLAPAudioProjection)
from torch_threads import torch_threads_per_worker  # noqa: F401

REL = 1e-4
# tests/test_audio_query.py's TINY HTSAT
TINY = dict(spec_size=128, embed_dim=16, depths=(1, 1, 1, 1),
            num_heads=(2, 2, 2, 2), window_size=4)
MEL = dict(n_fft=256, n_mels=32)
FUSIONS = ["daf_1d", "aff_1d", "iaff_1d", "aff_2d", "iaff_2d"]


def configs(fusion_type=None):
    fusion = dict(enable_fusion=True, fusion_type=fusion_type) \
        if fusion_type else {}
    return (htsat.HTSATConfig(mel=LogMelConfig(**MEL), **TINY, **fusion),
            jax_htsat.HTSATConfig(mel=JaxMelConfig(**MEL), **TINY, **fusion))


def random_tree(abstract, rng):
    """A tree of the JAX package's variable shapes (``jax.eval_shape`` of
    its init: no flax init runs, whose op-by-op compile takes longer than
    these tests) filled from ``rng``; running variances positive."""
    out = {}
    for k, v in abstract.items():
        if isinstance(v, dict):
            out[k] = random_tree(v, rng)
        elif k == "var":
            out[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
        else:
            scale = 1.0 if k == "mean" else 0.1
            out[k] = (scale * rng.randn(*v.shape)).astype(np.float32)
    return out


def jax_variables(module, rng, *args, **kwargs):
    abstract = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args,
                              **kwargs)
    return random_tree(jax.device_get(abstract), rng)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def mel_stack(rng, b=2, t=101):
    """(B, 4, T, M) log-mel-like stacks and longer = [True, False]."""
    mel = (-40 + 15 * rng.randn(b, 4, t, MEL["n_mels"])).astype(np.float32)
    return mel, np.array([True, False][:b])


def jax_encoder(fusion_type, rng):
    """The JAX audio encoder, random variables of its tree and inputs."""
    _, jcfg = configs(fusion_type)
    model = JaxAudioEncoder(htsat_cfg=jcfg)
    if fusion_type:
        mel, longer = mel_stack(rng)
        inputs = dict(mel_fusion=mel, longer=longer)
    else:
        t = np.arange(48000) / 48000.0
        inputs = dict(waveform=(0.2 * np.sin(2 * np.pi * 300 * t)
                                + 0.05 * rng.randn(2, 48000)
                                ).astype(np.float32))
    variables = jax_variables(model, rng, **{
        k: jnp.asarray(v) for k, v in inputs.items()})
    return model, variables, inputs


def port_encoder(fusion_type, variables):
    cfg, _ = configs(fusion_type)
    model = CLAPAudioEncoder(cfg).eval()
    model.load_state_dict(from_jax.clap_audio_state_dict_from_jax(
        variables, cfg.depths))
    return model


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_matches_jax(shift, rng):
    dim, res, heads, window = 16, (8, 8), 2, 4
    jblock = jax_htsat.SwinBlock(dim, res, heads, window, shift)
    x = rng.randn(2, 64, dim).astype(np.float32)
    params = jax_variables(jblock, rng, jnp.asarray(x))["params"]
    ref = np.asarray(jax.jit(jblock.apply)({"params": params},
                                           jnp.asarray(x)))
    block = htsat.SwinBlock(dim, res, heads, window, shift)
    sd = {}
    from_jax.swin_block_from_jax(sd, "b", params)
    block.load_state_dict({k[2:]: v for k, v in sd.items()})
    assert (block.attn_mask is not None) == (shift > 0)
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    assert rel(got, ref) <= REL


def test_patch_merging_matches_jax(rng):
    jmerge = jax_htsat.PatchMerging((8, 8), 16)
    x = rng.randn(2, 64, 16).astype(np.float32)
    params = jax_variables(jmerge, rng, jnp.asarray(x))["params"]
    ref = np.asarray(jax.jit(jmerge.apply)({"params": params},
                                           jnp.asarray(x)))
    merge = htsat.PatchMerging((8, 8), 16)
    sd = {}
    from_jax.patch_merging_from_jax(sd, "m", params)
    merge.load_state_dict({k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        got = merge(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 16, 32)
    assert rel(got, ref) <= REL


@pytest.mark.parametrize("shape", [(2, 101, 32), (1, 512, 20)])
def test_wav2img_matches_jax(shape, rng):
    """The bicubic stretch (time, and frequency when the mel is narrower
    than the image wants) and the interleave, without weights."""
    cfg, jcfg = configs()
    mel = rng.randn(*shape).astype(np.float32)
    ref = np.asarray(jax_htsat.HTSAT(jcfg)._reshape_wav2img(
        jnp.asarray(mel)))[..., 0]
    got = htsat.HTSAT(cfg)._reshape_wav2img(torch.from_numpy(mel))[:, 0]
    assert got.shape == (shape[0], 128, 128)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    np.testing.assert_array_equal(htsat._bicubic_matrix(1001, 1024),
                                  jax_htsat._bicubic_matrix(1001, 1024))
    np.testing.assert_array_equal(htsat._shift_attn_mask(16, 16, 8, 4),
                                  jax_htsat._shift_attn_mask(16, 16, 8, 4))


@pytest.mark.parametrize("fusion_type",
                         [None] + FUSIONS + ["daf_2d", "channel_map"])
def test_htsat_four_outputs_match_jax(fusion_type, rng):
    """The whole TINY HTSAT; with fusion, item 0 is long (the fused local
    branch) and item 1 short (the global mel alone); channel_map feeds the
    four mel channels to the patch embedding."""
    cfg, jcfg = configs(fusion_type)
    _, variables, inputs = jax_encoder(fusion_type, rng)
    branch = {"params": variables["params"]["audio_branch"],
              "batch_stats": variables["batch_stats"]["audio_branch"]}
    ref = jax.jit(jax_htsat.HTSAT(jcfg).apply)(branch, **{
        k: jnp.asarray(v) for k, v in inputs.items()})
    model = htsat.HTSAT(cfg).eval()
    model.load_state_dict(from_jax.htsat_state_dict_from_jax(branch,
                                                             cfg.depths))
    with torch.no_grad():
        got = model(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        assert rel(got[key].numpy(), ref[key]) <= REL, key
    assert got["framewise_output"].shape[1] == 512  # (128 // 32) ** 2 * 32


@pytest.mark.parametrize("fusion_type", [None, "iaff_1d", "iaff_2d"])
def test_converters_round_trip(fusion_type, rng):
    """from_jax of a tree of JAX's init shapes is the port's tree; the JAX
    package's own torch -> JAX converter takes the port's state dict back
    to the JAX variables exactly; CLAPAudioProjection is the encoder's
    head. (The embeddings against JAX's: tests/test_torch_audio_query.py.)
    """
    _, variables, inputs = jax_encoder(fusion_type, rng)
    cfg, _ = configs(fusion_type)
    sd = from_jax.clap_audio_state_dict_from_jax(variables, cfg.depths)
    own = CLAPAudioEncoder(cfg).state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in own.items()}
    model = port_encoder(fusion_type, variables)
    back = convert_clap_audio_encoder(model.state_dict(), depths=cfg.depths)
    flat = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(back)[0]}
    ref = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_flatten_with_path(variables)[0]}
    assert sorted(flat) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(flat[key], ref[key], err_msg=key)
    with torch.no_grad():
        got = model(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    assert got.shape == (2, 512)
    projection = CLAPAudioProjection(cfg.num_features)
    projection.load_state_dict({k: v for k, v in model.state_dict().items()
                                if k.startswith("audio_projection.")})
    with torch.no_grad():
        branch = model.audio_branch(**{k: torch.from_numpy(v)
                                       for k, v in inputs.items()})
        torch.testing.assert_close(projection(branch["embedding"]), got)


def test_train_mode_raises():
    """Train mode runs (CLAP pretraining: batch statistics, spec-augment
    from the forward's generator, the running statistics updated; held
    against JAX in tests/test_torch_clap_pretrain.py); what still raises
    is a fusion-enabled tower called without its mel stack, in train mode
    as in eval mode."""
    model = htsat.HTSAT(configs()[0]).train()
    wave = torch.from_numpy(0.1 * np.random.RandomState(0).randn(
        2, 48000).astype(np.float32))
    before = model.bn0.running_mean.clone()
    with torch.no_grad():
        a = model(wave, generator=torch.Generator().manual_seed(1))
        b = model(wave, generator=torch.Generator().manual_seed(1))
        c = model(wave, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a["embedding"], b["embedding"], rtol=0,
                               atol=0)
    assert not torch.equal(a["embedding"], c["embedding"])
    assert not torch.equal(model.bn0.running_mean, before)
    fused = htsat.HTSAT(configs("aff_1d")[0]).train()
    with pytest.raises(ValueError, match="mel_fusion"):
        fused(wave)


def test_build_mel_fusion_equals_jax(rng):
    mel = rng.randn(1000, 64).astype(np.float32)
    for chunk in (301, 1000):
        got = build_mel_fusion(mel, chunk, np.random.default_rng(4))
        ref = jax_mel_fusion(mel, chunk, np.random.default_rng(4))
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1] == (chunk < 1000)


@pytest.mark.parametrize("length", [70000, 48000, 20000])
def test_prepare_audio_fusion_equals_jax(length, rng):
    x = (0.1 * rng.randn(length)).astype(np.float32)
    got = audio_features.prepare_audio_fusion(
        x, 48000, mel_cfg=LogMelConfig(**MEL), rng=np.random.default_rng(7))
    ref = jax_features.prepare_audio_fusion(
        x, 48000, mel_cfg=JaxMelConfig(**MEL), rng=np.random.default_rng(7))
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1] == (length > 48000)
    np.testing.assert_array_equal(got[2], ref[2])
