"""The port's precomputed-STFT variants against lass_tpu's, on the CPU.

Same numpy-seeded inputs through both packages, the JAX side on weights
converted from the port's (no flax init: its compile costs more than the
forward's), one jitted JAX apply per case:

- ``MultiSTFTResUNet30`` eval forward, windows (256, 512, 2048) and (512,),
  B=2 x 0.3 s, float32: rel err <= 1e-4 (the bound the JAX package sets
  itself against the torch reference, tests/test_reference_parity.py:71);
- ``multistft_film_spec``, ``adapt_freq``, a ``skip_channels`` decoder
  block (float32, <= 1e-5 rel: one block), the 257-padded and
  256-truncated reconstructions (<= 1e-6 between the port's two, <= 1e-5
  against JAX's padded one);
- ``negative_captions``, ``get_query_embed(text_neg=)`` (2e-5 abs, the
  RoBERTa bound of tests/test_torch_clap_text.py), the fusion layer, the
  spec-checked FiLM packing of checkpoints.

The train steps are tests/test_torch_variant_steps.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.dsp.stft import STFTConfig as JaxSTFTConfig
from lass_tpu.models.clap.model import CLAPTextEncoder as JaxTextEncoder
from lass_tpu.models.clap.roberta import RobertaConfig as JaxRobertaConfig
from lass_tpu.models.clap.tokenizer import (
    WhitespaceFallbackTokenizer as JaxFallbackTokenizer)
from lass_tpu.models.film import multistft_film_spec as jax_film_spec
from lass_tpu.models.query_encoder import CLAPQueryEncoder as JaxQueryEncoder
from lass_tpu.models.resunet import (
    apply_mask_and_reconstruct as jax_mask_and_reconstruct)
from lass_tpu.models.resunet_multistft import MultiSTFTResUNet30 as JaxMulti
from lass_tpu.models.resunet_multistft import _adapt_freq as jax_adapt_freq
from lass_tpu.nn.blocks import DecoderBlockRes1B as JaxDecoder
from lass_tpu.tasks.audiosep_variants import (
    negative_captions as jax_negative_captions)
from lass_torch.convert.checkpoint_io import pack_film, unpack_film
from lass_torch.convert.from_jax import (
    clap_text_state_dict_from_jax, multistft_state_dict_from_jax)
from lass_torch.dsp.stft import STFTConfig
from lass_torch.models.clap.roberta import RobertaConfig
from lass_torch.models.clap.tokenizer import WhitespaceFallbackTokenizer
from lass_torch.models.film import multistft_film_spec, resunet30_film_spec
from lass_torch.models.query_encoder import CLAPQueryEncoder
from lass_torch.models.resunet import apply_mask_and_reconstruct
from lass_torch.models.resunet_multistft import adapt_freq
from lass_torch.nn.blocks import DecoderBlockRes1B
from lass_torch.tasks.audiosep_variants import (
    NegQueryFusion, negative_captions)
from variant_helpers import (
    BATCH, WINS, REL, jax_variables, model_input, rel_err, shake, stft_bank,
    port_model)
from torch_threads import torch_threads_per_worker  # noqa: F401

FORWARD_SAMPLES = 4800  # 31 frames, padded to 32
SMALL_TEXT = dict(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=128,
                  max_position_embeddings=80)


@pytest.fixture(scope="module")
def port_models():
    """One port model per window set (variant_helpers.port_model)."""
    return {wins: port_model(wins) for wins in (WINS, (512,))}


@pytest.mark.parametrize("wins", [WINS, (512,)], ids=["3win", "512"])
def test_forward_matches_jax(port_models, wins):
    model = port_models[wins]
    bank, cond = stft_bank(wins, FORWARD_SAMPLES, seed=2)
    variables = jax_variables(model.state_dict())
    ref = jax.jit(lambda v, x: JaxMulti(win_lengths=wins).apply(
        v, x, FORWARD_SAMPLES, train=False))(
        variables, model_input(bank, cond, wins, "jax"))["waveform"]
    with torch.no_grad():
        got = model(model_input(bank, cond, wins, "torch"),
                    FORWARD_SAMPLES)["waveform"]
    assert got.shape == (BATCH, 1, FORWARD_SAMPLES)
    assert rel_err(got.numpy(), ref) <= REL


@pytest.mark.parametrize("wins", [WINS, (512,)], ids=["3win", "512"])
def test_converter_inverts_the_jax_layout(port_models, wins):
    sd = port_models[wins].state_dict()
    back = multistft_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_variables(sd)))
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k


@pytest.mark.parametrize("wins", [WINS, (512,), (1024, 512)])
def test_film_spec_matches_jax(wins):
    assert multistft_film_spec(wins) == jax_film_spec(wins)


@pytest.mark.parametrize("freq", [128, 256, 1024])
def test_adapt_freq_matches_jax(freq):
    x = np.random.RandomState(freq).randn(2, 3, freq, 4).astype(np.float32)
    ref = np.asarray(jax_adapt_freq(jnp.asarray(x), 256))  # (B, T, F, C)
    got = adapt_freq(torch.from_numpy(x).permute(0, 3, 1, 2), 256)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("train", [False, True])
def test_skip_channels_decoder_matches_jax(train):
    torch.manual_seed(3)
    block = shake(DecoderBlockRes1B(64, 32, (2, 2), skip_channels=96), 4)
    block.train(train)
    assert block.conv_block2.conv1.in_channels == 32 + 96
    rng = np.random.RandomState(5)
    x = rng.randn(2, 64, 4, 8).astype(np.float32)
    skip = rng.randn(2, 96, 8, 16).astype(np.float32)
    film = {"beta1": rng.randn(2, 64), "beta2": rng.randn(2, 64),
            "conv_block2": {"beta1": rng.randn(2, 128),
                            "beta2": rng.randn(2, 32)}}
    film = jax.tree_util.tree_map(lambda a: a.astype(np.float32), film)
    variables = jax_variables(block.state_dict())
    out = JaxDecoder(64, 32, (2, 2), skip_channels=96).apply(
        variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
        jnp.asarray(skip.transpose(0, 2, 3, 1)),
        jax.tree_util.tree_map(jnp.asarray, film), train,
        mutable=["batch_stats"] if train else False)
    ref = np.asarray(out[0] if train else out).transpose(0, 3, 1, 2)
    got = block(torch.from_numpy(x), torch.from_numpy(skip),
                jax.tree_util.tree_map(torch.from_numpy, film))
    assert rel_err(got.detach().numpy(), ref) <= 1e-5


def test_truncated_and_padded_reconstructions_agree():
    """lass_tpu pads the 256 logit bins to 257; the port hands the mask
    kernel 256 bins and zeroes the Nyquist bin in the ISTFT."""
    rng = np.random.RandomState(6)
    t, length = FORWARD_SAMPLES // 160 + 1, FORWARD_SAMPLES
    logits = (2 * rng.randn(BATCH, 3, t, 256)).astype(np.float32)
    re, im = (rng.randn(2, BATCH, 1, t, 257).astype(np.float32))
    cfg = STFTConfig(n_fft=512, hop_length=160)
    truncated = apply_mask_and_reconstruct(
        torch.from_numpy(logits), torch.from_numpy(re), torch.from_numpy(im),
        length, cfg, 1)
    padded = apply_mask_and_reconstruct(
        torch.from_numpy(np.pad(logits, ((0, 0), (0, 0), (0, 0), (0, 1)))),
        torch.from_numpy(re), torch.from_numpy(im), length, cfg, 1)
    jax_padded = jax_mask_and_reconstruct(
        jnp.asarray(np.pad(logits, ((0, 0), (0, 0), (0, 0), (0, 1)))
                    .transpose(0, 2, 3, 1)),
        jnp.asarray(re.transpose(0, 2, 3, 1)),
        jnp.asarray(im.transpose(0, 2, 3, 1)), length,
        JaxSTFTConfig(n_fft=512, hop_length=160), 1, 3)
    assert rel_err(truncated.numpy(), padded.numpy()) <= 1e-6
    assert rel_err(truncated.numpy(), jax_padded) <= 1e-5


def test_multistft_snapshot_is_cut_by_its_own_spec(port_models):
    """The 3-window model's FiLM unpacks by its own spec and packs back
    bit for bit; ResUNet30's spec raises instead of slicing short."""
    sd = port_models[WINS].state_dict()
    spec = port_models[WINS].film.spec
    unpacked = unpack_film(sd, spec)
    assert "film.encoder_block1s->2048->conv_block1->beta2.weight" in unpacked
    packed = pack_film(unpacked, spec)
    assert set(packed) == set(sd)
    for k, v in sd.items():
        assert torch.equal(packed[k], v), k
    with pytest.raises(ValueError):
        unpack_film(sd)
    with pytest.raises(KeyError):
        pack_film(unpacked, resunet30_film_spec())
    with pytest.raises(KeyError):
        pack_film(unpack_film(sd, spec), multistft_film_spec((512,)))


@pytest.mark.parametrize("pos, comps", [
    (["a", "b"], None),
    (["a", "b"], [["a", "x"], ["b"]]),
    (["a", "b", "c"], [["a", "x", "y"], ("b", "z")]),
    (["a"], [["a", "x"], ["b", "y"]]),
    (["a", "b"], [["a", ""], "bz"]),
])
def test_negative_captions_match_jax(pos, comps):
    assert negative_captions(pos, comps) == jax_negative_captions(pos, comps)


def test_text_neg_matches_jax():
    """get_query_embed('text', text_neg=) -> the (pos, neg) pair, both
    packages on the same random small text tower."""
    jmodel = JaxTextEncoder(JaxRobertaConfig(**SMALL_TEXT))
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), ids,
                                        jnp.ones_like(ids))["params"])
    jenc = JaxQueryEncoder(
        text_params=params, roberta_cfg=JaxRobertaConfig(**SMALL_TEXT),
        tokenizer=JaxFallbackTokenizer(SMALL_TEXT["vocab_size"]))
    enc = CLAPQueryEncoder(
        text_state_dict=clap_text_state_dict_from_jax(
            params, SMALL_TEXT["num_hidden_layers"]),
        roberta_cfg=RobertaConfig(**SMALL_TEXT),
        tokenizer=WhitespaceFallbackTokenizer(SMALL_TEXT["vocab_size"]),
        device="cpu")
    pos, negs = ["a dog barking", "rain"], ["traffic noise", ""]
    got = enc.get_query_embed("text", text=pos, text_neg=negs)
    ref = jenc.get_query_embed("text", text=pos, text_neg=negs)
    assert isinstance(got, tuple) and len(got) == 2
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-5)
    np.testing.assert_allclose(
        enc.get_query_embed("text", text=pos).numpy(), got[0].numpy())


def test_fusion_is_unit_norm_and_trainable():
    torch.manual_seed(0)
    fusion = NegQueryFusion()
    pos, neg = torch.randn(3, 512), torch.zeros(3, 512)
    out = fusion(pos, neg)
    torch.testing.assert_close(out.norm(dim=-1), torch.ones(3))
    assert fusion.fusion.weight.shape == (512, 1024)
    assert fusion.fusion.bias is None
    bound = float(np.sqrt(6 / (512 + 1024)))  # xavier-uniform
    assert float(fusion.fusion.weight.abs().max()) <= bound
    out.sum().backward()
    assert fusion.fusion.weight.grad.abs().sum() > 0
    # a zero pair stays finite (the 1e-12 floor)
    assert torch.isfinite(fusion(torch.zeros(1, 512),
                                 torch.zeros(1, 512))).all()
