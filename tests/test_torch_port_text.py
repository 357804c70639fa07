"""The PyTorch port's text tower and caption decoder against the JAX package's.

Same inputs on both sides: the tokenizer and the vocabulary on the same
strings (long captions, unicode, apostrophes, an empty corpus); the models
with numpy-seeded weights in the JAX trees' shapes, carried into the port
by ``from_jax_text_variables`` / ``from_jax_captioner_variables``. Small
sizes: vocab 50, d 32, 2 heads, 2 layers, FFN 64, L 8 with padding,
dropout 0 (flax broadcasts its attention-dropout mask and torch does not,
so only the deterministic forward can agree).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_active_ai_tpu.models import text as jtext
from multimodal_active_ai_tpu_torch.models import text as ttext
from multimodal_active_ai_tpu_torch.models.transformer import MultiheadAttention
from multimodal_active_ai_tpu_torch.utils import checkpoint as tckpt

VOCAB, D, HEADS, LAYERS, FFN, L, OUT, S, FEAT = 50, 32, 2, 2, 64, 8, 16, 4, 40

CAPTIONS = [
    "A man riding a horse.",
    "",
    "don't stop: it's O'Neil's café — naïve Ünïcödé 東京 2024!",
    "one two three four five six seven eight nine ten eleven twelve thirteen",
    "the the the THE tHe",
    "'''  ''' apostrophes ' alone",
    "x" * 40 + " y",
]
CORPUS = [
    "a cat on a mat", "a dog on a log", "the cat and the dog", "it's a dog's life",
    "zebra", "café café naïve", "a b c d e f g h i j k l m n o p",
]


def _numpy_tree(tree, rng):
    return jax.tree_util.tree_map(lambda x: rng.normal(0, 0.3, x.shape).astype(np.float32),
                                  tree)


def _normwise(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _ids():
    """(3, L) with padding: a half-full row, a full row, BOS EOS only."""
    ids = np.zeros((3, L), np.int32)
    ids[0, :5] = [1, 5, 9, 44, 2]
    ids[1] = [1, 3, 4, 5, 6, 7, 8, 2]
    ids[2, :2] = [1, 2]
    return ids


# ---------------------------------------------------------------------------
# tokenizer and vocabulary


@pytest.mark.parametrize("vocab_size,max_len", [(32768, 32), (50, 8), (4, 5)])
def test_tokenize_matches_jax(vocab_size, max_len):
    """FNV-1a bucket ids and masks identical, long captions truncated to
    ``max_len - 2`` words, unicode hashed over its UTF-8 bytes."""
    for cap in CAPTIONS:
        assert ttext.tokenize(cap, vocab_size, max_len) == jtext.tokenize(cap, vocab_size,
                                                                            max_len), cap


def test_constants_match_jax():
    assert (ttext.PAD_ID, ttext.BOS_ID, ttext.EOS_ID, ttext._RESERVED) == (
        jtext.PAD_ID, jtext.BOS_ID, jtext.EOS_ID, jtext._RESERVED)
    assert ttext._WORD_RE.pattern == jtext._WORD_RE.pattern
    assert (ttext.Vocabulary.OOV_ID, ttext.Vocabulary._BASE) == (3, 4)


@pytest.mark.parametrize("max_size,min_freq", [(32768, 1), (9, 1), (32768, 2)])
def test_vocabulary_matches_jax(max_size, min_freq):
    """``build`` (frequency order, ties by first appearance, the size cap,
    ``min_freq``), ``encode`` with its OOV count and rate, ``decode``,
    ``to_u8`` and ``from_u8``: identical to the JAX class."""
    port = ttext.Vocabulary.build(CORPUS, max_size=max_size, min_freq=min_freq, max_len=8)
    ref = jtext.Vocabulary.build(CORPUS, max_size=max_size, min_freq=min_freq, max_len=8)
    assert port.words == ref.words and port.size == ref.size
    for cap in CAPTIONS + CORPUS:
        ids = port.encode(cap)
        assert ids == ref.encode(cap), cap
        assert port.decode(ids[0]) == ref.decode(ids[0])
    assert (port.oov_words, port.total_words) == (ref.oov_words, ref.total_words)
    assert port.oov_rate == ref.oov_rate > 0
    u8 = port.to_u8()
    assert u8.dtype == np.uint8 and np.array_equal(u8, ref.to_u8())
    back = ttext.Vocabulary.from_u8(u8, max_len=8)
    assert back.words == jtext.Vocabulary.from_u8(ref.to_u8(), max_len=8).words == port.words
    assert ttext.Vocabulary.from_u8(torch.from_numpy(u8)).words == port.words


def test_empty_vocabulary_round_trip():
    """An empty corpus: no words, ``to_u8`` of zero length, ``from_u8`` of
    it gives ``[]`` (not ``['']``); everything encodes as OOV."""
    port, ref = ttext.Vocabulary.build([]), jtext.Vocabulary.build([])
    assert port.words == ref.words == [] and port.size == 4
    assert port.to_u8().shape == (0,) and ref.to_u8().shape == (0,)
    assert ttext.Vocabulary.from_u8(port.to_u8()).words == []
    assert jtext.Vocabulary.from_u8(ref.to_u8()).words == []
    assert port.encode("a b") == ref.encode("a b") and port.oov_rate == ref.oov_rate == 1.0
    assert port.decode(port.encode("a b")[0]) == "<unk> <unk>"


@pytest.mark.parametrize("length,dim", [(8, 32), (32, 256), (4, 7)])
def test_sinusoid_matches_jax(length, dim):
    """Same exponent ``2·(d // 2)/dim``, sin on even and cos on odd
    dimensions. XLA:CPU's float32 ``pow``/``sin``/``cos`` round some values
    one unit in the last place apart from torch's (measured: at most
    5.96e-8), so the check is two float32 ulps of 1."""
    got = ttext._sinusoid(length, dim)
    ref = np.asarray(jtext._sinusoid(length, dim, jnp.float32))
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2.4e-7)
    # not DETR's: odd dimensions are cos of the same frequency as their even twin
    assert torch.allclose(got[:, 1::2][:, : dim // 2] ** 2 + got[:, 0::2][:, : dim // 2] ** 2,
                          torch.ones(1), atol=1e-6)


# ---------------------------------------------------------------------------
# TextEncoder and GlimpseCaptioner


@pytest.fixture(scope="module")
def text_models():
    rng = np.random.default_rng(0)
    ids = _ids()
    enc = jtext.TextEncoder(vocab_size=VOCAB, d_model=D, nhead=HEADS, num_layers=LAYERS,
                            dim_feedforward=FFN, out_dim=OUT, dropout=0.0)
    enc_v = _numpy_tree(jax.eval_shape(enc.init, jax.random.PRNGKey(0), jnp.asarray(ids)), rng)
    cap = jtext.GlimpseCaptioner(vocab_size=VOCAB, d_model=D, nhead=HEADS, num_layers=LAYERS,
                                 dim_feedforward=FFN, dropout=0.0)
    feats = rng.normal(size=(3, S, FEAT)).astype(np.float32)
    cap_v = _numpy_tree(jax.eval_shape(cap.init, jax.random.PRNGKey(0), jnp.asarray(feats),
                                       jnp.asarray(ids)), rng)
    gmask = np.array([[False] * S, [False, False, True, True], [False, True, True, True]])
    return dict(ids=ids, feats=feats, gmask=gmask, enc=enc, enc_v=enc_v, cap=cap, cap_v=cap_v)


def _port_encoder(params, dropout=0.0):
    m = ttext.TextEncoder(vocab_size=VOCAB, d_model=D, nhead=HEADS, num_layers=LAYERS,
                          dim_feedforward=FFN, out_dim=OUT, dropout=dropout)
    m.load_state_dict(tckpt.from_jax_text_variables(params), strict=True)
    return m.eval()


def _port_captioner(params):
    m = ttext.GlimpseCaptioner(FEAT, vocab_size=VOCAB, d_model=D, nhead=HEADS,
                               num_layers=LAYERS, dim_feedforward=FFN, dropout=0.0)
    m.load_state_dict(tckpt.from_jax_captioner_variables(params), strict=True)
    return m.eval()


def test_text_encoder_matches_jax(text_models):
    """Embedding, sinusoid on q and k, two post-norm layers with the
    padding masked, masked mean-pool, projection: normwise 1e-5 (measured
    2.7e-7); float32 out."""
    t = text_models
    ref = np.asarray(t["enc"].apply(t["enc_v"], jnp.asarray(t["ids"])))
    got = _port_encoder(t["enc_v"]["params"])(torch.from_numpy(t["ids"]).long())
    assert got.shape == (3, OUT) and got.dtype == torch.float32
    assert _normwise(got.detach(), ref) <= 1e-5


def test_text_encoder_ignores_padding_and_trains_with_dropout(text_models):
    """What follows EOS under the padding never reaches the pooled output;
    in train mode dropout, drawn from the generator ``forward`` is given,
    changes it, in eval mode it is deterministic."""
    t = text_models
    m = _port_encoder(t["enc_v"]["params"], dropout=0.5)
    ids = torch.from_numpy(t["ids"]).long()
    longer = torch.cat([ids, torch.zeros(3, 4, dtype=torch.long)], 1)
    with torch.no_grad():
        a, b = m(ids), m(longer)
        assert torch.allclose(a, b, atol=1e-5) and torch.equal(a, m(ids))
        m.train()
        assert not torch.allclose(m(ids, torch.Generator().manual_seed(0)), a, atol=1e-3)


@pytest.mark.parametrize("masked", [False, True])
def test_glimpse_captioner_matches_jax(text_models, masked):
    """Memory projection, ``mem_pos`` on the cross-attention keys only,
    causal self-attention without a positional term, post-norm layers, the
    final LayerNorm and vocabulary head; with and without a glimpse padding
    mask: logits normwise 1e-5 (measured 2.1e-7)."""
    t = text_models
    mask = t["gmask"] if masked else None
    ref = np.asarray(t["cap"].apply(t["cap_v"], jnp.asarray(t["feats"]), jnp.asarray(t["ids"]),
                                    None if mask is None else jnp.asarray(mask)))
    got = _port_captioner(t["cap_v"]["params"])(
        torch.from_numpy(t["feats"]), torch.from_numpy(t["ids"]).long(),
        None if mask is None else torch.from_numpy(mask))
    assert got.shape == (3, L, VOCAB) and got.dtype == torch.float32
    assert _normwise(got.detach(), ref) <= 1e-5


def test_glimpse_captioner_is_causal(text_models):
    t = text_models
    m = _port_captioner(t["cap_v"]["params"])
    ids = torch.from_numpy(t["ids"]).long()
    later = ids.clone()
    later[:, -1] = 17
    with torch.no_grad():
        a, b = m(torch.from_numpy(t["feats"]), ids), m(torch.from_numpy(t["feats"]), later)
    assert torch.equal(a[:, :-1], b[:, :-1]) and not torch.allclose(a[:, -1], b[:, -1])


def test_carried_state_dicts_cover_the_port_modules(text_models):
    """Every tensor of both port modules comes from the JAX trees: the
    embedding passes straight through, attention and Dense kernels map."""
    t = text_models
    sd = tckpt.from_jax_text_variables(t["enc_v"]["params"])
    port = ttext.TextEncoder(VOCAB, D, HEADS, LAYERS, FFN, OUT)
    assert sorted(sd) == sorted(port.state_dict())
    np.testing.assert_array_equal(sd["embed.weight"].numpy(),
                                  t["enc_v"]["params"]["Embed_0"]["embedding"])
    sd = tckpt.from_jax_captioner_variables(t["cap_v"]["params"])
    assert sorted(sd) == sorted(ttext.GlimpseCaptioner(FEAT, VOCAB, D, HEADS, LAYERS,
                                                       FFN).state_dict())
    np.testing.assert_array_equal(sd["head.weight"].numpy(),
                                  t["cap_v"]["params"]["Dense_1"]["kernel"].T)


def test_attention_keep_mask():
    """The keep-mask (True = attend) broadcasts over batch and heads and
    fills with the dtype's minimum as flax does; leaving it out is the
    key-padding-only attention DETR calls, and an all-True mask changes
    nothing."""
    g = torch.Generator().manual_seed(0)
    attn = MultiheadAttention(D, HEADS, generator=g).eval()
    q, k = torch.randn(2, 5, D, generator=g), torch.randn(2, 6, D, generator=g)
    pad = torch.tensor([[False] * 6, [False] * 4 + [True] * 2])
    base = attn(q, k, k, pad)
    assert torch.equal(attn(q, k, k, pad, torch.ones(5, 6, dtype=torch.bool)), base)
    keep = torch.ones(5, 6, dtype=torch.bool).tril()
    masked = attn(q, k, k, None, keep)
    # row 0 attends to key 0 only: its output is v_0's projection
    only0 = attn(q[:, :1], k[:, :1], k[:, :1])
    assert torch.allclose(masked[:, :1], only0, atol=1e-6)
    assert not torch.allclose(masked, attn(q, k, k), atol=1e-3)
