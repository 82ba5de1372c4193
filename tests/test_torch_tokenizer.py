"""Port parity: the byte-level BPE tokenizer (kfunca_tpu_torch/models/
tokenizer.py) against the JAX package's, on both of the port's paths (the
native core's kf_bpe_* and the Python form under KFUNCA_NO_NATIVE=1):
the same merges from training, the same ids and bytes over multi-byte
UTF-8 and special tokens, files that load across packages, and ValueError
for an id outside the vocab on both paths."""

import numpy as np
import pytest

from kfunca_tpu.models.tokenizer import BPETokenizer as JaxBPE
from kfunca_tpu_torch.models.tokenizer import BPETokenizer
from kfunca_tpu_torch.runtime import _native

CORPUS = ("the quick brown fox jumps over the lazy dog. "
          "naïve café — résumé 日本語テキスト 🚀 "
          "pack my box with five dozen liquor jugs. ") * 20
SPECIALS = ["<|eos|>", "<|im_start|>", "<|im_start|>user"]
PROBES = ["", "hello world", "naïve café — résumé 日本語テキスト 🚀",
          "\x00\x01\xff binary-ish\ttabs\nnewlines", CORPUS[:500],
          "the sea<|eos|>the wind<|eos|>", "<|im_start|>user hello",
          "<|im_start|>x<|im_start|>user<|eos|>", "zzz unseen ✓ zzz"]


@pytest.fixture(scope="module")
def jax_tok():
    return JaxBPE.train(CORPUS, vocab_size=400).with_special_tokens(SPECIALS)


@pytest.fixture(params=["native", "python"])
def path(request, monkeypatch):
    """Which of the port's paths a tokenizer made now takes."""
    if request.param == "python":
        monkeypatch.setenv("KFUNCA_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("KFUNCA_NO_NATIVE", raising=False)
        assert _native.get_lib() is not None
    return request.param


def _port(jax_tok, path):
    tok = BPETokenizer(jax_tok.merges, SPECIALS)
    assert (tok._handle is not None) == (path == "native")
    return tok


def test_training_gives_the_jax_merges():
    got = BPETokenizer.train(CORPUS, vocab_size=400)
    want = JaxBPE.train(CORPUS, vocab_size=400)
    assert got.merges == want.merges and got.vocab_size == want.vocab_size
    with pytest.raises(ValueError, match="vocab_size"):
        BPETokenizer.train("abc", vocab_size=100)


@pytest.mark.parametrize("text", PROBES)
def test_encode_decode_match_jax(jax_tok, path, text):
    tok = _port(jax_tok, path)
    ids = tok.encode(text)
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, jax_tok.encode(text))
    np.testing.assert_array_equal(tok.encode(text, allow_special=False),
                                  jax_tok.encode(text, allow_special=False))
    assert tok.decode_bytes(ids) == jax_tok.decode_bytes(ids)
    assert tok.decode(ids) == text


def test_python_form_matches_native_and_jax(jax_tok):
    """The port's Python encode, its native encode and the JAX package's
    Python form give the same ids on raw bytes too."""
    tok = BPETokenizer(jax_tok.merges)
    blob = bytes(range(256)) * 3 + CORPUS.encode()
    for data in (blob, CORPUS.encode()[:777], "日本語 🚀".encode()):
        want = jax_tok._encode_py(data)
        np.testing.assert_array_equal(tok._encode_py(data), want)
        np.testing.assert_array_equal(tok.encode(data), want)
    assert tok.decode_bytes(tok.encode(blob)) == blob


def test_special_tokens_and_vocab(jax_tok, path):
    tok = _port(jax_tok, path)
    assert tok.vocab_size == jax_tok.vocab_size
    for lit in SPECIALS:
        assert tok.special_id(lit) == jax_tok.special_id(lit)
        assert tok.token_bytes(tok.special_id(lit)) == lit.encode()
    with pytest.raises(KeyError):
        tok.special_id("<|absent|>")
    with pytest.raises(ValueError, match="duplicate"):
        tok.with_special_tokens(["<|a|>", "<|a|>"])
    with pytest.raises(ValueError, match="dense"):
        BPETokenizer([(97, 98, 300)])


@pytest.mark.parametrize("bad", [-1, -257, "vocab", "vocab+7", 2 ** 31 - 1])
def test_decode_rejects_bad_ids_on_both_paths(jax_tok, path, bad):
    """An id outside [0, vocab) raises ValueError, also on the Python path
    (where the JAX package raises IndexError or wraps a negative id)."""
    tok = _port(jax_tok, path)
    v = tok.vocab_size
    bad = {"vocab": v, "vocab+7": v + 7}.get(bad, bad)
    for ids in ([bad], [5, bad, 6], [tok.special_id("<|eos|>"), bad]):
        with pytest.raises(ValueError):
            tok.decode_bytes(np.asarray(ids, np.int64))
        with pytest.raises(ValueError):
            tok.decode(ids)
    with pytest.raises(ValueError):
        tok.token_bytes(bad)


def test_files_load_across_packages(jax_tok, path, tmp_path):
    ours, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    tok = _port(jax_tok, path)
    tok.save(str(ours))
    jax_tok.save(str(theirs))
    assert ours.read_text() == theirs.read_text()
    back = JaxBPE.load(str(ours))
    mine = BPETokenizer.load(str(theirs))
    assert back.merges == tok.merges and mine.merges == jax_tok.merges
    assert mine.special_tokens == SPECIALS == back.special_tokens
    text = "the sea<|eos|>naïve"
    np.testing.assert_array_equal(mine.encode(text), back.encode(text))
    (tmp_path / "x.json").write_text('{"something": 1}')
    with pytest.raises(ValueError, match="not a kfunca bpe"):
        BPETokenizer.load(str(tmp_path / "x.json"))
