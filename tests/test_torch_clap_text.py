"""lass_torch CLAP text path vs lass_tpu: the text encoder, the tokenizers,
the npz pack loader and the query encoder's per-caption LRU.

Tolerance for embeddings: 2e-5 abs, the bound tests/test_roberta.py uses
for the JAX RoBERTa against HF torch (float32 matmuls summed in other
orders through 2 layers).
"""
import importlib.util
import json
import logging
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lass_tpu.models.clap import tokenizer as jax_tok
from lass_tpu.models.clap.model import CLAPTextEncoder as JaxTextEncoder
from lass_tpu.models.clap.roberta import RobertaConfig as JaxRobertaConfig
from lass_torch.convert.from_jax import clap_text_state_dict_from_jax
from lass_torch.models.clap import tokenizer as port_tok
from lass_torch.models.clap.model import CLAPTextEncoder
from lass_torch.models.clap.roberta import RobertaConfig
from lass_torch.models.query_encoder import CLAPQueryEncoder
from torch_threads import torch_threads_per_worker  # noqa: F401

SMALL = dict(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=80)
TOL = 2e-5


def _perturb(tree, rng):
    """Flax inits biases to 0 and LayerNorm to (1, 0); shake them."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("bias", "scale"):
            out[k] = np.asarray(v) + (0.1 * rng.randn(*v.shape)).astype(
                np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_text():
    model = JaxTextEncoder(JaxRobertaConfig(**SMALL))
    ids = jnp.zeros((1, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), ids, jnp.ones_like(ids))
    params = _perturb(jax.device_get(params["params"]),
                      np.random.RandomState(5))
    return model, params


def _ids(rng):
    ids = rng.randint(4, SMALL["vocab_size"], size=(3, 12)).astype(np.int32)
    ids[:, 0] = 0
    mask = np.ones_like(ids)
    for row, n in ((1, 7), (2, 3)):
        ids[row, n] = 2
        ids[row, n + 1:] = 1  # <pad>
        mask[row, n + 1:] = 0
    return ids, mask


def _port_text(params):
    enc = CLAPTextEncoder(RobertaConfig(**SMALL))
    enc.load_state_dict(clap_text_state_dict_from_jax(
        params, SMALL["num_hidden_layers"]))
    return enc.eval()


def test_text_encoder_matches_jax(jax_text, rng):
    model, params = jax_text
    ids, mask = _ids(rng)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(ids),
                                 jnp.asarray(mask)))
    with torch.no_grad():
        got = _port_text(params)(torch.from_numpy(ids).long(),
                                 torch.from_numpy(mask).long()).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_padding_length_invariance(jax_text):
    enc = _port_text(jax_text[1])
    body = [0, 17, 33, 99, 2]

    def run(pad_to):
        ids = torch.full((1, pad_to), 1, dtype=torch.long)
        mask = torch.zeros((1, pad_to), dtype=torch.long)
        ids[0, :len(body)] = torch.tensor(body)
        mask[0, :len(body)] = 1
        with torch.no_grad():
            return enc(ids, mask).numpy()

    np.testing.assert_allclose(run(8), run(64), atol=1e-6)


def _toy_vocab(tmp_path):
    """A byte-level vocab with merges built from a few words."""
    byte_chars = list(port_tok.bytes_to_unicode().values())
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3}
    for ch in byte_chars:
        vocab.setdefault(ch, len(vocab))
    merges = []
    for word in ("Ġdog", "Ġbarking", "Ġrain", "ing", "car"):
        cur = word[0]
        for ch in word[1:]:
            merges.append(f"{cur} {ch}")
            cur += ch
            vocab.setdefault(cur, len(vocab))
    vocab_path, merges_path = tmp_path / "vocab.json", tmp_path / "merges.txt"
    vocab_path.write_text(json.dumps(vocab))
    merges_path.write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    return str(vocab_path), str(merges_path)


CAPTIONS = ["a dog barking", "Rain on a car roof, singing!",
            "dog  dog\tdog's 42 cars", "café 中"]


def test_bpe_tokenizer_matches_jax(tmp_path):
    paths = _toy_vocab(tmp_path)
    ours, ref = port_tok.RobertaBPETokenizer(*paths), \
        jax_tok.RobertaBPETokenizer(*paths)
    for kwargs in ({"max_length": 512, "pad_to": None},
                   {"max_length": 512, "pad_to": 16},
                   {"max_length": 6, "pad_to": 4}):
        a, b = ours(CAPTIONS, **kwargs), ref(CAPTIONS, **kwargs)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(a[key], b[key])
    assert ours.encode(" dog") == [ours.encoder["Ġdog"]]


def test_bpe_tokenizer_reads_vocab_dir_env(tmp_path, monkeypatch):
    paths = _toy_vocab(tmp_path)
    monkeypatch.setenv("LASS_TPU_ROBERTA_VOCAB_DIR", str(tmp_path))
    assert port_tok.RobertaBPETokenizer().encode("a dog") == \
        port_tok.RobertaBPETokenizer(*paths).encode("a dog")
    monkeypatch.delenv("LASS_TPU_ROBERTA_VOCAB_DIR")
    with pytest.raises(FileNotFoundError):
        port_tok.RobertaBPETokenizer()


@pytest.mark.parametrize("pad_to", [64, 8, None])
def test_fallback_tokenizer_matches_jax(pad_to):
    a = port_tok.WhitespaceFallbackTokenizer(1000)(CAPTIONS, 512, pad_to)
    b = jax_tok.WhitespaceFallbackTokenizer(1000)(CAPTIONS, 512, pad_to)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(a[key], b[key])


def _small_encoder(params=None, **kwargs):
    sd = None if params is None else clap_text_state_dict_from_jax(
        params, SMALL["num_hidden_layers"])
    kwargs.setdefault("tokenizer", port_tok.WhitespaceFallbackTokenizer(
        SMALL["vocab_size"]))
    return CLAPQueryEncoder(text_state_dict=sd,
                            roberta_cfg=RobertaConfig(**SMALL),
                            device="cpu", **kwargs)


def test_from_npz_text_pack(jax_text, tmp_path, rng):
    """A pack written as scripts/convert_checkpoint.py --kind clap writes
    it reproduces the JAX text encoder's embeddings."""
    model, params = jax_text
    spec = importlib.util.spec_from_file_location(
        "convert_ckpt", "scripts/convert_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    pack = tmp_path / "clap.npz"
    np.savez(pack, **{f"text/params/{k}": v
                      for k, v in mod.flatten(params).items()})
    enc = CLAPQueryEncoder.from_npz(
        str(pack), roberta_cfg=RobertaConfig(**SMALL), device="cpu",
        tokenizer=port_tok.WhitespaceFallbackTokenizer(SMALL["vocab_size"]))
    assert enc.has_pretrained_text
    ids, mask = _ids(rng)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(ids),
                                 jnp.asarray(mask)))
    with torch.no_grad():
        got = enc.text_model(torch.from_numpy(ids).long(),
                             torch.from_numpy(mask).long()).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL)
    # the query path: fallback tokens -> same embedding as the JAX encoder
    tok = enc.tokenizer(["a dog barking"], pad_to=enc.pad_to)
    ref = np.asarray(model.apply({"params": params},
                                 jnp.asarray(tok["input_ids"]),
                                 jnp.asarray(tok["attention_mask"])))
    np.testing.assert_allclose(
        enc.get_query_embed("text", text=["a dog barking"]).numpy(), ref,
        atol=TOL)


def test_lru_hits_are_bit_equal_to_misses(jax_text):
    enc = _small_encoder(jax_text[1])
    fresh = _small_encoder(jax_text[1], text_embed_cache=0)
    warm = enc.get_query_embed("text", text=["a", "b", "c"])
    assert enc.embed_cache_misses == 1 and enc.embed_cache_hits == 0
    perm = ["c", "a", "b"]
    cached = enc.get_query_embed("text", text=perm)
    assert enc.embed_cache_hits == 1
    assert torch.equal(cached, warm[[2, 0, 1]])
    np.testing.assert_allclose(
        cached.numpy(), fresh.get_query_embed("text", text=perm).numpy(),
        atol=1e-6)
    assert not fresh._embed_cache and fresh.embed_cache_misses == 0


def test_lru_eviction():
    enc = _small_encoder(text_embed_cache=2)
    for t in ("t0", "t1", "t2"):
        enc.get_query_embed("text", text=[t])
    assert list(enc._embed_cache) == ["t1", "t2"]


def test_lru_waits_for_the_lock():
    enc = _small_encoder()
    enc.get_query_embed("text", text=["x"])
    done = threading.Event()
    worker = threading.Thread(target=lambda: (
        enc.get_query_embed("text", text=["x"]), done.set()))
    with enc._lock:
        worker.start()
        assert not done.wait(0.3)  # blocked while the lock is held
    worker.join(timeout=30)
    assert not worker.is_alive() and done.is_set()
    assert enc.embed_cache_hits == 1


def test_lru_under_concurrent_callers(jax_text):
    """More threads than cores, a short switch interval, a cache smaller
    than the caption pool: no lost update, every answer right."""
    enc = _small_encoder(jax_text[1], text_embed_cache=3)
    pool = [f"caption {i}" for i in range(6)]
    truth = {c: _small_encoder(jax_text[1], text_embed_cache=0)
             .get_query_embed("text", text=[c])[0] for c in pool}
    errors, calls = [], 20
    old = sys.getswitchinterval()

    def work(seed):
        r = np.random.RandomState(seed)
        try:
            for _ in range(calls):
                texts = list(r.choice(pool, size=2, replace=False))
                out = enc.get_query_embed("text", text=texts)
                for t, row in zip(texts, out):
                    if not torch.allclose(row, truth[t], atol=1e-6):
                        errors.append(t)
        except Exception as exc:  # surfaced by the assert below
            errors.append(repr(exc))

    threads = [threading.Thread(target=work, args=(s,)) for s in range(16)]
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert enc.embed_cache_hits + enc.embed_cache_misses == 16 * calls
    assert len(enc._embed_cache) <= 3


def test_random_weights_warn_and_audio_raises(caplog):
    with caplog.at_level(logging.WARNING, logger="lass_torch.query_encoder"):
        enc = _small_encoder()
    assert not enc.has_pretrained_text
    assert any("WITHOUT pretrained text weights" in r.message
               for r in caplog.records)
    for modality in ("audio", "hybird"):
        with pytest.raises(NotImplementedError):
            enc.get_query_embed(modality, audio=np.zeros((1, 16000)))


def test_fallback_tokenizer_chosen_without_vocab(monkeypatch):
    monkeypatch.delenv("LASS_TPU_ROBERTA_VOCAB_DIR", raising=False)
    enc = CLAPQueryEncoder(roberta_cfg=RobertaConfig(**SMALL), device="cpu")
    assert enc.using_fallback_tokenizer
    assert enc.get_query_embed("text", text=["a dog"]).shape == (1, 512)
