"""lass_torch's BERT and BART caption branches against lass_tpu's, on the
CPU: ``BertModel`` and ``BartEncoderModel``, ``CLAPBertTextEncoder`` and
``CLAPBartTextEncoder``, ``CLAPQueryEncoder(tmodel='bert' | 'bart')`` end
to end from one npz pack, and the ``WordPieceTokenizer`` and
``BartBPETokenizer``.

Same weights: random values in the JAX package's variable tree, through
``lass_torch.convert.from_jax``. Small sizes (hidden 32, 2 layers, 4
heads, B = 3, sequences of at most 16), float32. Tolerance: rel err <=
1e-4 (the JAX package's float32 bound against the torch reference,
tests/test_reference_parity.py); token ids equal.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from lass_tpu.models.clap import bert as jax_bert
from lass_tpu.models.clap import model as jax_model
from lass_tpu.models.clap import tokenizer as jax_tok
from lass_tpu.models.query_encoder import CLAPQueryEncoder as JaxQueryEncoder
from lass_torch.convert.from_jax import (
    bart_encoder_state_dict_from_jax, clap_text_state_dict_from_jax,
    roberta_state_dict_from_jax)
from lass_torch.convert_checkpoint import flatten
from lass_torch.models.clap import bert, model, tokenizer
from lass_torch.models.query_encoder import CLAPQueryEncoder
from test_torch_htsat import jax_variables, rel
from torch_threads import torch_threads_per_worker  # noqa: F401

REL = 1e-4
SMALL = dict(vocab_size=300, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=40)
CONFIGS = {
    "bert": (bert.BertConfig(**SMALL), jax_bert.BertConfig(**SMALL)),
    "bart": (bert.BartConfig(**SMALL), jax_bert.BartConfig(**SMALL)),
}
JOINT = 16


def ids_mask(branch, rng, b=3, s=12):
    """Ids with a closing token; row 1 padded after 7 tokens."""
    pad = CONFIGS[branch][0].pad_token_id
    ids = rng.randint(4, SMALL["vocab_size"], size=(b, s)).astype(np.int32)
    mask = np.ones_like(ids)
    ids[1, 7:], mask[1, 7:] = pad, 0
    return ids, mask


def jax_encoder(branch, rng):
    """The JAX CLAP text encoder of ``branch`` and random params."""
    jcfg = CONFIGS[branch][1]
    module = (jax_model.CLAPBertTextEncoder(bert_cfg=jcfg,
                                            joint_embed_dim=JOINT)
              if branch == "bert" else
              jax_model.CLAPBartTextEncoder(bart_cfg=jcfg,
                                            joint_embed_dim=JOINT))
    dummy = jnp.zeros((1, 8), jnp.int32)
    return module, jax_variables(module, rng, dummy, dummy)["params"]


def port_encoder(branch, params):
    cfg = CONFIGS[branch][0]
    cls = (model.CLAPBertTextEncoder if branch == "bert"
           else model.CLAPBartTextEncoder)
    enc = cls(cfg, joint_embed_dim=JOINT)
    enc.load_state_dict(clap_text_state_dict_from_jax(
        params, cfg.num_hidden_layers, branch))
    return enc.eval()


@pytest.fixture(scope="module", params=["bert", "bart"])
def pair(request):
    module, params = jax_encoder(request.param,
                                 np.random.RandomState(11))
    return request.param, module, params


def test_branch_matches_jax(pair, rng):
    """The bare branch: every position of the hidden state (padded ones
    too: both packages compute them alike) and BERT's pooler output."""
    branch, _, params = pair
    cfg, jcfg = CONFIGS[branch]
    ids, mask = ids_mask(branch, rng)
    if branch == "bert":
        jmod, port = jax_bert.BertModel(jcfg), bert.BertModel(cfg)
        port.load_state_dict(roberta_state_dict_from_jax(
            params["bert"], cfg.num_hidden_layers))
    else:
        jmod, port = jax_bert.BartEncoderModel(jcfg), \
            bert.BartEncoderModel(cfg)
        port.load_state_dict(bart_encoder_state_dict_from_jax(
            params["bart"], cfg.num_hidden_layers))
    ref = jmod.apply({"params": params[branch]}, jnp.asarray(ids),
                     jnp.asarray(mask))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(ids).long(),
                          torch.from_numpy(mask).long())
    if branch == "bert":
        (ref, ref_pooled), (got, got_pooled) = ref, got
        assert rel(got_pooled.numpy(), ref_pooled) <= REL
    assert got.shape == (3, 12, SMALL["hidden_size"])
    assert rel(got.numpy(), ref) <= REL


def test_clap_text_encoder_matches_jax(pair, rng):
    branch, module, params = pair
    ids, mask = ids_mask(branch, rng)
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(ids),
                                  jnp.asarray(mask)))
    with torch.no_grad():
        got = port_encoder(branch, params)(
            torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    assert got.shape == (3, JOINT)
    assert rel(got.numpy(), ref) <= REL
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-5)


def test_bert_token_types_and_positions(rng):
    """Zero token types are the default; positions are a plain arange, so
    a row's leading tokens do not depend on what follows them (no
    RoBERTa pad offset)."""
    cfg = CONFIGS["bert"][0]
    torch.manual_seed(0)
    port = bert.BertModel(cfg).eval()
    ids, mask = ids_mask("bert", rng)
    ids_t, mask_t = torch.from_numpy(ids).long(), torch.from_numpy(mask).long()
    with torch.no_grad():
        a, _ = port(ids_t, mask_t)
        b, _ = port(ids_t, mask_t, torch.zeros_like(ids_t))
        c, _ = port(ids_t, mask_t, torch.ones_like(ids_t))
    assert torch.equal(a, b) and not torch.allclose(a, c)


def _vocab_files(branch, tmp_path):
    """tests/test_query_encoder.py's synthetic vocabularies: WordPiece for
    BERT, a byte-level vocab without merges for BART."""
    if branch == "bert":
        vocab = tmp_path / "vocab.txt"
        vocab.write_text("\n".join(
            ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "dog", "rain", "##s",
             "bark", "##ing", ",", "!", "cafe", "中"]) + "\n")
        return (str(vocab),)
    import json

    b2u = tokenizer.bytes_to_unicode()
    tokens = ["<s>", "<pad>", "</s>", "<unk>"] + [b2u[b] for b in range(256)]
    (tmp_path / "vocab.json").write_text(
        json.dumps({t: i for i, t in enumerate(tokens)}))
    (tmp_path / "merges.txt").write_text("#version: 0.2\nd o\ndo g\n")
    return str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt")


def _tokenizers(branch, tmp_path):
    paths = _vocab_files(branch, tmp_path)
    if branch == "bert":
        return (tokenizer.WordPieceTokenizer(*paths),
                jax_tok.WordPieceTokenizer(*paths))
    return (tokenizer.BartBPETokenizer(*paths),
            jax_tok.BartBPETokenizer(*paths))


QUERY = ["a dog barking", "rain", "dogs, rain!"]


def test_query_encoder_from_one_pack(pair, tmp_path):
    """Both packages' CLAPQueryEncoder(tmodel=...) built from the same pack
    and vocab give the same caption embeddings; BART's at two pad_to
    buckets, where both packages move alike (its mean takes the padding
    in)."""
    branch, _, params = pair
    cfg, jcfg = CONFIGS[branch]
    pack = tmp_path / "clap.npz"
    np.savez(pack, **{f"text/params/{k}": v
                      for k, v in flatten(params).items()})
    out = {}
    for pad_to in ((16,) if branch == "bert" else (16, 32)):
        port_tok, jtok = _tokenizers(branch, tmp_path)
        port = CLAPQueryEncoder.from_npz(
            str(pack), tmodel=branch, text_cfg=cfg, tokenizer=port_tok,
            joint_embed_dim=JOINT, pad_to=pad_to, device="cpu")
        ref = JaxQueryEncoder.from_npz(
            str(pack), tmodel=branch, text_cfg=jcfg, tokenizer=jtok,
            joint_embed_dim=JOINT, pad_to=pad_to)
        assert port.has_pretrained_text and port.tmodel == branch
        got = port.get_query_embed("text", text=QUERY).numpy()
        want = np.asarray(ref.get_query_embed("text", text=QUERY))
        assert got.shape == (3, JOINT)
        assert rel(got, want) <= REL
        # a cached hit is bit-equal to the miss, within one bucket
        assert np.array_equal(
            port.get_query_embed("text", text=QUERY[::-1]).numpy(),
            got[::-1])
        out[pad_to] = got, want
    if branch == "bart":
        (a, ja), (b, jb) = out[16], out[32]
        assert rel(a, b) > 1e-3 and rel(ja, jb) > 1e-3
        assert rel(a - b, ja - jb) <= 1e-2


WORDPIECE_TEXT = ["A dog barking, rain!", "Café  DOGS\tbark",
                  "中a dog", "x" * 101 + " dog", "", "rain\u0000 dogs"]


def test_wordpiece_matches_jax(tmp_path):
    ours, ref = _tokenizers("bert", tmp_path)
    for kwargs in ({"max_length": 512, "pad_to": None},
                   {"max_length": 512, "pad_to": 8},
                   {"max_length": 5, "pad_to": 4}):
        a, b = ours(WORDPIECE_TEXT, **kwargs), ref(WORDPIECE_TEXT, **kwargs)
        assert a.keys() == b.keys() == {"input_ids", "attention_mask",
                                        "token_type_ids"}
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    for text in WORDPIECE_TEXT:
        assert ours.encode(text) == ref.encode(text), text
    v = ours.vocab
    assert ours.encode("Café dogs, 中") == [v["cafe"], v["dog"], v["##s"],
                                           v[","], v["中"]]
    assert ours.encode("x" * 101) == [v["[UNK]"]]


def test_bart_bpe_matches_jax(tmp_path):
    ours, ref = _tokenizers("bart", tmp_path)
    text = QUERY + ["Café 中 dog's", "x" * 101]
    for kwargs in ({"max_length": 512, "pad_to": None},
                   {"max_length": 512, "pad_to": 16},
                   {"max_length": 6, "pad_to": 4}):
        a, b = ours(text, **kwargs), ref(text, **kwargs)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(a[key], b[key])
    assert ours.encode(" dog") == ref.encode(" dog")


def test_tokenizers_read_their_environment(tmp_path, monkeypatch):
    bert_paths = _vocab_files("bert", tmp_path)
    bart_paths = _vocab_files("bart", tmp_path)
    monkeypatch.setenv("LASS_TPU_BERT_VOCAB", bert_paths[0])
    monkeypatch.setenv("LASS_TPU_BART_VOCAB_DIR", str(tmp_path))
    assert tokenizer.WordPieceTokenizer().encode("a dog") == \
        tokenizer.WordPieceTokenizer(*bert_paths).encode("a dog")
    assert tokenizer.BartBPETokenizer().encode("a dog") == \
        tokenizer.BartBPETokenizer(*bart_paths).encode("a dog")
    for branch, cls in (("bert", tokenizer.WordPieceTokenizer),
                        ("bart", tokenizer.BartBPETokenizer)):
        enc = CLAPQueryEncoder(tmodel=branch, text_cfg=CONFIGS[branch][0],
                               device="cpu")
        assert isinstance(enc.tokenizer, cls)
    monkeypatch.delenv("LASS_TPU_BERT_VOCAB")
    monkeypatch.delenv("LASS_TPU_BART_VOCAB_DIR")
    for cls in (tokenizer.WordPieceTokenizer, tokenizer.BartBPETokenizer):
        with pytest.raises(FileNotFoundError):
            cls()


@pytest.mark.parametrize("branch,size", [("bert", 30522), ("bart", 50265)])
def test_fallback_tokenizer_size(branch, size, monkeypatch):
    """Without the branch's vocab: the hash fallback over bert-base's
    30522 ids for BERT, the RoBERTa config's vocabulary otherwise, as the
    JAX encoder picks."""
    monkeypatch.delenv("LASS_TPU_BERT_VOCAB", raising=False)
    monkeypatch.delenv("LASS_TPU_BART_VOCAB_DIR", raising=False)
    enc = CLAPQueryEncoder(tmodel=branch, text_cfg=CONFIGS[branch][0],
                           device="cpu")
    assert enc.using_fallback_tokenizer
    assert enc.tokenizer.vocab_size == size
    with pytest.raises(ValueError, match="tmodel"):
        CLAPQueryEncoder(tmodel="transformer", device="cpu")
