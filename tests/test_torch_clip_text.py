"""lass_torch's CLIP-style text branch against lass_tpu's, on the CPU: the
``CLIPTokenizer`` on a synthetic gzip BPE (tests/test_clip_text.py's), the
``CLIPTextTransformer`` on the same weights, its causality, and the ASCII
fallback pattern.

Same weights: random values in the JAX package's variable tree, through
``lass_torch.convert.from_jax.clip_text_state_dict_from_jax``. Small sizes
(width 32, 2 layers, 4 heads, B = 3, 16 tokens), float32. Tolerance: rel
err <= 1e-4 (the JAX package's float32 bound against the torch
reference); token ids equal.
"""
import gzip
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lass_tpu.models.clap import clip_text as jax_clip
from lass_torch.convert.from_jax import clip_text_state_dict_from_jax
from lass_torch.models.clap import clip_text
from test_torch_htsat import jax_variables, rel
from torch_threads import torch_threads_per_worker  # noqa: F401

REL = 1e-4
SMALL = dict(vocab_size=100, width=32, heads=4, layers=2, context_length=16)
TEXTS = ["hello world", "Hello, WORLD!! it's 2024", "héllo wörld &amp; 中",
         "  spaced\tout\n words  ", "x" * 40]


@pytest.fixture(scope="module")
def bpe_path(tmp_path_factory):
    merges = ["h e", "he l", "hel l", "hell o</w>", "w o", "wo r",
              "wor l", "worl d</w>"]
    path = tmp_path_factory.mktemp("clipbpe") / "bpe.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:  # line 0: header
        f.write("#version\n" + "\n".join(merges) + "\n")
    return str(path)


def test_tokenizer_matches_jax(bpe_path, monkeypatch):
    ours, ref = clip_text.CLIPTokenizer(bpe_path), \
        jax_clip.CLIPTokenizer(bpe_path)
    for context in (77, 8):
        np.testing.assert_array_equal(ours(TEXTS, context),
                                      ref(TEXTS, context))
    ids = ours(["hello world"])
    assert ids.shape == (1, 77) and ids.dtype == np.int32
    assert list(ids[0, :4]) == [ours.sot, ours.encoder["hello</w>"],
                                ours.encoder["world</w>"], ours.eot]
    monkeypatch.setenv("LASS_TPU_CLIP_BPE_PATH", bpe_path)
    assert clip_text.CLIPTokenizer().encode(TEXTS[1]) == ours.encode(TEXTS[1])
    monkeypatch.delenv("LASS_TPU_CLIP_BPE_PATH")
    with pytest.raises(FileNotFoundError):
        clip_text.CLIPTokenizer()


def test_ascii_fallback_pattern_matches_unicode_pattern():
    """Without ``regex`` the port splits with the ASCII pattern, which must
    split ASCII text as the Unicode one does."""
    regex = pytest.importorskip("regex")
    uni = regex.compile(clip_text.CLIP_PAT_UNICODE, regex.IGNORECASE)
    asc = re.compile(clip_text.CLIP_PAT_ASCII, re.IGNORECASE)
    for text in ["hello world", "it's 2024, isn't it?!",
                 "<|startoftext|>a b<|endoftext|>", "don't; we'll---see:42"]:
        assert uni.findall(text) == asc.findall(text), text
    assert clip_text.CLIP_PAT_UNICODE == jax_clip.CLIP_PAT_UNICODE
    assert clip_text.CLIP_PAT_ASCII == jax_clip.CLIP_PAT_ASCII


@pytest.fixture(scope="module")
def pair():
    jmodel = jax_clip.CLIPTextTransformer(**SMALL)
    ids = jnp.zeros((1, SMALL["context_length"]), jnp.int32)
    params = jax_variables(jmodel, np.random.RandomState(21), ids)["params"]
    port = clip_text.CLIPTextTransformer(**SMALL).eval()
    port.load_state_dict(clip_text_state_dict_from_jax(params,
                                                       SMALL["layers"]))
    return jmodel, params, port


def _ids(rng, b=3, s=16):
    """Token rows whose end-of-text (the highest id) sits at 5, 15, 9."""
    ids = rng.randint(1, 90, size=(b, s)).astype(np.int32)
    for row, eot in enumerate((5, 15, 9)):
        ids[row, eot] = 99
        ids[row, eot + 1:] = 0
    return ids


def test_transformer_matches_jax(pair, rng):
    jmodel, params, port = pair
    ids = _ids(rng)
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long()).numpy()
    assert got.shape == (3, SMALL["width"])
    assert rel(got, ref) <= REL
    # a shorter context takes the leading positional rows, as JAX does
    ref = np.asarray(jmodel.apply({"params": params},
                                  jnp.asarray(ids[:, :12])))
    with torch.no_grad():
        got = port(torch.from_numpy(ids[:, :12]).long()).numpy()
    assert rel(got, ref) <= REL


def test_transformer_is_causal(pair, rng):
    """Tokens after the end-of-text row leave its output unchanged; one
    before it changes it."""
    _, _, port = pair
    ids = torch.from_numpy(_ids(rng)).long()
    later, earlier = ids.clone(), ids.clone()
    later[0, 7:] = 42
    earlier[0, 2] = 42
    with torch.no_grad():
        base, after, before = port(ids), port(later), port(earlier)
    assert torch.equal(base[0], after[0])
    assert not torch.allclose(base[0], before[0])
    assert torch.equal(base[1:], before[1:])
