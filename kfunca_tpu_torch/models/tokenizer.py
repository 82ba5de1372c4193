"""Byte-level BPE tokenizer: trainable, native-accelerated, dependency-free.

Counterpart of kfunca_tpu/models/tokenizer.py.  The apply side (encode and
decode) runs in the port's native core (csrc/core.cpp, kf_bpe_*) when it is
built, and in a Python form that gives the same ids and bytes otherwise
(KFUNCA_NO_NATIVE=1, or a machine without g++).

Model: token ids 0..255 are the raw bytes; every merge (left, right ->
result) concatenates two existing tokens, so the merge list alone defines
the vocab: no separate vocab file, no unknown token, and any byte string
round-trips exactly.  Special tokens (chat markup and the like) take the
ids after the BPE vocab.  The file format ("kfunca-bpe-v1" JSON) is the JAX
package's, so a file saved by either package loads in the other.

A token id outside the vocab raises ValueError on both paths (the JAX
package's Python path raises IndexError for a large id and wraps a negative
one).
"""

from __future__ import annotations

import ctypes
import json

import numpy as np

from ..runtime import _native


class BPETokenizer:
    """merges: ordered list of (left, right, result) with result >= 256.

    `special_tokens`: ordered literal strings (e.g. "<|im_start|>") given
    the ids after the BPE vocab, in order.  encode() splits the input on the
    literals (longest first) and BPE-encodes only the text between them;
    decode() renders the literals back."""

    def __init__(self, merges, special_tokens=()):
        self.merges = [(int(l), int(r), int(t)) for l, r, t in merges]
        self._ranks = {(l, r): (rank, t)
                       for rank, (l, r, t) in enumerate(self.merges)}
        self._bytes = [bytes([i]) for i in range(256)]  # id -> bytes
        for l, r, t in self.merges:
            if t != len(self._bytes):
                raise ValueError(
                    f"merge result ids must be dense from 256; got {t}")
            self._bytes.append(self._bytes[l] + self._bytes[r])
        self.special_tokens = list(special_tokens)
        if len(set(self.special_tokens)) != len(self.special_tokens):
            raise ValueError("duplicate special tokens")
        self._special_id = {s: len(self._bytes) + i
                            for i, s in enumerate(self.special_tokens)}
        # longest first: overlapping literals resolve to the longest match
        self._special_order = sorted(self.special_tokens, key=len,
                                     reverse=True)
        self._lib = _native.get_lib()
        self._handle = None
        if self._lib is not None:
            h = self._lib.kf_bpe_create()
            for l, r, t in self.merges:
                if self._lib.kf_bpe_add_merge(h, l, r, t) < 0:
                    self._lib.kf_bpe_destroy(h)
                    raise ValueError(f"invalid merge ({l}, {r} -> {t})")
            self._handle = h

    # -- training ----------------------------------------------------------

    @classmethod
    def train(cls, corpus, vocab_size: int) -> "BPETokenizer":
        """Classic BPE training: repeatedly merge the most frequent
        adjacent pair until vocab_size (>= 256) tokens exist; ties break on
        the smaller pair."""
        if vocab_size < 256:
            raise ValueError("vocab_size must be >= 256 (byte-level)")
        data = (corpus.encode("utf-8") if isinstance(corpus, str)
                else bytes(corpus))
        ids = np.frombuffer(data, np.uint8).astype(np.int64)
        merges = []
        next_id = 256
        while next_id < vocab_size and len(ids) >= 2:
            pairs = ids[:-1] << 32 | ids[1:]
            uniq, counts = np.unique(pairs, return_counts=True)
            best = np.lexsort((uniq, -counts))[0]
            if counts[best] < 2:
                break
            key = int(uniq[best])
            left, right = key >> 32, key & 0xFFFFFFFF
            merges.append((left, right, next_id))
            # replace every non-overlapping occurrence, left to right
            idx = np.flatnonzero((ids[:-1] == left) & (ids[1:] == right))
            if len(idx) > 1:
                keep = [idx[0]]
                for j in idx[1:]:
                    if j > keep[-1] + 1:
                        keep.append(j)
                idx = np.asarray(keep)
            out = ids.copy()
            out[idx] = next_id
            mask = np.ones(len(ids), bool)
            mask[idx + 1] = False
            ids = out[mask]
            next_id += 1
        return cls(merges)

    # -- apply -------------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return len(self._bytes) + len(self.special_tokens)

    def special_id(self, literal: str) -> int:
        """Token id of a registered special literal (KeyError if absent)."""
        return self._special_id[literal]

    def token_bytes(self, tok: int) -> bytes:
        tok = int(tok)
        if not 0 <= tok < self.vocab_size:
            raise ValueError(f"token id {tok} outside the vocab of "
                             f"{self.vocab_size}")
        if tok >= len(self._bytes):
            return self.special_tokens[tok - len(self._bytes)].encode("utf-8")
        return self._bytes[tok]

    def encode(self, text, allow_special: bool = True) -> np.ndarray:
        """str (utf-8) or bytes -> int32 ids.  With allow_special (the
        default) registered special literals become their single ids and
        never merge across their boundaries; allow_special=False treats
        them as plain text."""
        if allow_special and self.special_tokens and isinstance(text, str):
            parts = self._split_special(text)
            if len(parts) > 1 or (parts and isinstance(parts[0], int)):
                out = [np.asarray([p], np.int32) if isinstance(p, int)
                       else self.encode(p, allow_special=False)
                       for p in parts]
                return (np.concatenate(out) if out
                        else np.zeros((0,), np.int32))
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        if not data:
            return np.zeros((0,), np.int32)
        if self._handle is None:
            return self._encode_py(data)
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        out = np.empty(len(data), np.int32)
        n = self._lib.kf_bpe_encode(
            self._handle, buf, len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out[:n].copy()

    def _split_special(self, text: str):
        """[str | special id] pieces, literals matched longest first."""
        parts = [text]
        for lit in self._special_order:
            nxt = []
            for p in parts:
                if isinstance(p, int) or lit not in p:
                    nxt.append(p)
                    continue
                for i, seg in enumerate(p.split(lit)):
                    if i:
                        nxt.append(self._special_id[lit])
                    if seg:
                        nxt.append(seg)
            parts = nxt
        return parts

    def decode(self, ids, errors: str = "replace") -> str:
        return self.decode_bytes(ids).decode("utf-8", errors=errors)

    def decode_bytes(self, ids) -> bytes:
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size == 0:
            return b""
        bad = (ids < 0) | (ids >= self.vocab_size)
        if bad.any():
            raise ValueError(f"token id {int(ids[bad][0])} outside the vocab "
                             f"of {self.vocab_size}")
        ids = ids.astype(np.int32)
        if self.special_tokens and bool((ids >= len(self._bytes)).any()):
            # BPE-decode the runs between special ids, splice the literals
            out, run = [], []
            for t in ids.tolist():
                if t >= len(self._bytes):
                    if run:
                        out.append(self.decode_bytes(run))
                        run = []
                    out.append(self.token_bytes(t))
                else:
                    run.append(t)
            if run:
                out.append(self.decode_bytes(run))
            return b"".join(out)
        if self._handle is None:
            return b"".join(self._bytes[t] for t in ids.tolist())
        idp = ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        need = self._lib.kf_bpe_decode(self._handle, idp, ids.size, None, 0)
        if need < 0:
            raise ValueError("token id out of range")
        out = (ctypes.c_uint8 * need)()
        self._lib.kf_bpe_decode(self._handle, idp, ids.size, out, need)
        return bytes(out)

    def _encode_py(self, data: bytes) -> np.ndarray:
        ids = list(data)
        while len(ids) >= 2:
            ranks = [self._ranks.get((ids[i], ids[i + 1]))
                     for i in range(len(ids) - 1)]
            live = [r[0] for r in ranks if r is not None]
            if not live:
                break
            best = min(live)
            nxt, i = [], 0
            while i < len(ids):
                hit = ranks[i] if i + 1 < len(ids) else None
                if hit is not None and hit[0] == best:
                    nxt.append(hit[1])
                    i += 2
                else:
                    nxt.append(ids[i])
                    i += 1
            ids = nxt
        return np.asarray(ids, np.int32)

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"format": "kfunca-bpe-v1", "merges": self.merges,
                       "special_tokens": self.special_tokens}, f)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            d = json.load(f)
        if d.get("format") != "kfunca-bpe-v1":
            raise ValueError(f"not a kfunca bpe file: {path}")
        return cls(d["merges"], d.get("special_tokens", ()))

    def with_special_tokens(self, special_tokens) -> "BPETokenizer":
        """A new tokenizer with the same merges and `special_tokens` after
        the BPE vocab (the ids of text tokens are unchanged)."""
        return BPETokenizer(self.merges, special_tokens)

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.kf_bpe_destroy(self._handle)
