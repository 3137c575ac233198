"""Tokenizers for the AI expression layer (port of
``daft_tpu/utils/tokenizer.py``; host code, ids equal to the JAX package's).

The default is a deterministic hashing word tokenizer, stable across hosts
and with no vocab files. A local HF checkpoint directory brings its own
vocabulary (``tokenizer_from_dir``): BERT's WordPiece over ``vocab.txt``, or
merges BPE over ``vocab.json`` + ``merges.txt`` in the CLIP or GPT-2
dialect. ``BPETokenizer`` segments greedily over a one-token-per-line or
tiktoken vocab file.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence

import numpy as np

_WORD_RE = re.compile(r"\w+|[^\w\s]")


def _pad_encode_batch(texts: Sequence[Optional[str]], max_length: int,
                      encode_one) -> "tuple[np.ndarray, np.ndarray]":
    """Shared (tokens, lengths) batch shape: (B, max_length) int32
    zero-padded + per-row lengths, from a per-text ``encode_one``."""
    B = len(texts)
    out = np.zeros((B, max_length), dtype=np.int32)
    lengths = np.zeros(B, dtype=np.int32)
    for i, text in enumerate(texts):
        if not text:
            continue
        ids = encode_one(text)
        out[i, : len(ids)] = ids
        lengths[i] = len(ids)
    return out, lengths


class HashingTokenizer:
    """Deterministic word-hash tokenizer: token id = FNV(word) % (vocab-2) + 2.

    Reserves 0 = pad, 1 = BOS, 2 = EOS semantics are caller-defined. Suitable
    for throughput benchmarking and tests; real weights need their own
    vocab-file tokenizer.
    """

    def __init__(self, vocab_size: int, max_length: int, lowercase: bool = True):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.lowercase = lowercase

    def encode_batch(self, texts: Sequence[Optional[str]]) -> "tuple[np.ndarray, np.ndarray]":
        """Returns (tokens (B, max_length) int32 zero-padded, lengths (B,))."""
        from daft_tpu_torch.kernels.hashing import hash_bytes_batch

        B = len(texts)
        out = np.zeros((B, self.max_length), dtype=np.int32)
        lengths = np.zeros(B, dtype=np.int32)
        mod = max(self.vocab_size - 2, 1)
        for i, text in enumerate(texts):
            if not text:
                continue
            if self.lowercase:
                text = text.lower()
            words = _WORD_RE.findall(text)[: self.max_length]
            if not words:
                continue
            data = "\x00".join(words).encode()
            lens = np.array([len(w.encode()) for w in words], dtype=np.int64)
            starts = np.concatenate([[0], np.cumsum(lens[:-1] + 1)]).astype(np.int64)
            hashes = hash_bytes_batch(np.frombuffer(data, dtype=np.uint8), starts, lens)
            ids = (hashes % np.uint64(mod)).astype(np.int32) + 2
            out[i, : len(ids)] = ids
            lengths[i] = len(ids)
        return out, lengths


class WordPieceTokenizer:
    """BERT WordPiece over a local ``vocab.txt`` — tokenizer-parity with HF
    ``BertTokenizer`` for the converted-checkpoint text path (reference:
    src/daft-functions-tokenize; HF wordpiece semantics: basic tokenization
    with lowercase + accent stripping, greedy longest-prefix subwords with
    ``##`` continuation, [CLS]/[SEP] wrapping, [PAD]=0 padding)."""

    def __init__(self, vocab_path: str, max_length: int, lowercase: bool = True):
        self.max_length = max_length
        self.lowercase = lowercase
        self.vocab: dict = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.vocab_size = len(self.vocab)
        self.unk = self.vocab.get("[UNK]", 0)
        self.cls = self.vocab.get("[CLS]")
        self.sep = self.vocab.get("[SEP]")

    @staticmethod
    def _is_cjk(cp: int) -> bool:
        # HF BasicTokenizer._is_chinese_char ranges.
        return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
                or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
                or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
                or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)

    def _basic(self, text: str) -> List[str]:
        import unicodedata

        if self.lowercase:
            text = text.lower()
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        out: List[str] = []
        word = []

        def flush():
            if word:
                out.append("".join(word))
                word.clear()

        for ch in text:
            if ch.isspace():
                flush()
            elif unicodedata.category(ch).startswith("P") or ch in "$+<=>^`|~" \
                    or self._is_cjk(ord(ch)):
                # Punctuation AND CJK characters are standalone tokens (HF
                # BasicTokenizer space-pads each CJK codepoint).
                flush()
                out.append(ch)
            else:
                word.append(ch)
        flush()
        return out

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > 100:
            return [self.unk]
        ids: List[int] = []
        i = 0
        while i < len(word):
            for j in range(len(word), i, -1):
                piece = ("##" if i else "") + word[i:j]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    i = j
                    break
            else:
                return [self.unk]  # any unmatchable chunk -> whole word UNK
        return ids

    def encode_one(self, text: str) -> List[int]:
        ids: List[int] = [] if self.cls is None else [self.cls]
        for w in self._basic(text):
            ids.extend(self._wordpiece(w))
            if len(ids) >= self.max_length - 1:
                break
        ids = ids[: self.max_length - (1 if self.sep is not None else 0)]
        if self.sep is not None:
            ids.append(self.sep)
        return ids

    def encode_batch(self, texts: Sequence[Optional[str]]):
        return _pad_encode_batch(texts, self.max_length, self.encode_one)


def _bytes_to_unicode():
    """GPT-2's reversible byte <-> printable-unicode table."""
    bs = list(range(ord("!"), ord("~") + 1)) + \
        list(range(ord("\xa1"), ord("\xac") + 1)) + \
        list(range(ord("\xae"), ord("\xff") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class MergesBPETokenizer:
    """Rank-ordered pair-merge BPE over local ``vocab.json`` + ``merges.txt``
    (reference: src/daft-functions-tokenize tiktoken-parity BPE; HF
    GPT2Tokenizer / CLIPTokenizer semantics).

    Two dialects:
    * ``style="clip"`` — lowercase, whitespace-collapsed words, each word's
      last character carries ``</w>``, bos/eos wrapping
      (<|startoftext|>/<|endoftext|>); zero-padded.
    * ``style="gpt2"`` — byte-level: text maps through the reversible
      byte->unicode table, no bos/eos.
    """

    def __init__(self, vocab_path: str, merges_path: str, max_length: int,
                 style: str = "clip"):
        import json

        self.max_length = max_length
        self.style = style
        with open(vocab_path, encoding="utf-8") as f:
            self.vocab = json.load(f)
        self.vocab_size = max(self.vocab.values()) + 1
        self.ranks: dict = {}
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split()
                self.ranks[(a, b)] = len(self.ranks)
        self.bos = self.vocab.get("<|startoftext|>")
        self.eos = self.vocab.get("<|endoftext|>")
        # HF GPT2/CLIP tokenizers default unk to <|endoftext|>; mapping
        # missing pieces there (instead of dropping them) keeps token
        # POSITIONS aligned with the reference tokenization.
        self.unk = self.eos
        self._byte_map = _bytes_to_unicode()
        self._cache: dict = {}

    def _bpe(self, word: tuple) -> List[str]:
        if word in self._cache:
            return self._cache[word]
        parts = list(word)
        while len(parts) > 1:
            pairs = [(self.ranks.get((parts[i], parts[i + 1]), 1 << 30), i)
                     for i in range(len(parts) - 1)]
            rank, i = min(pairs)
            if rank == 1 << 30:
                break
            a, b = parts[i], parts[i + 1]
            # Merge EVERY occurrence of this pair left-to-right (HF semantics).
            out, j = [], 0
            while j < len(parts):
                if j < len(parts) - 1 and parts[j] == a and parts[j + 1] == b:
                    out.append(a + b)
                    j += 2
                else:
                    out.append(parts[j])
                    j += 1
            parts = out
        self._cache[word] = parts
        return parts

    def _words(self, text: str) -> List[tuple]:
        bm = self._byte_map
        if self.style == "gpt2":
            pat = re.compile(
                r"'s|'t|'re|'ve|'m|'ll|'d| ?\w+| ?[^\s\w]+|\s+(?!\S)|\s+")
            return [tuple(bm[b] for b in tok.encode("utf-8"))
                    for tok in pat.findall(text)]
        # CLIP: lowercase + whitespace cleanup, contraction splits, letter
        # runs / single digits / symbol runs; each token is BYTE-LEVEL
        # (utf-8 bytes through the reversible byte->unicode table — printable
        # ASCII maps to itself) with the last byte-char carrying </w>.
        text = " ".join(text.lower().strip().split())
        # HF classes: letters [\p{L}]+, single digits [\p{N}], symbol runs
        # [^\s\p{L}\p{N}]+ (which INCLUDE apostrophes and underscores —
        # contraction alternatives win by alternation order).
        pat = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+")
        out = []
        for tok in pat.findall(text):
            chars = [bm[b] for b in tok.encode("utf-8")]
            out.append(tuple(chars[:-1] + [chars[-1] + "</w>"]))
        return out

    def encode_one(self, text: str) -> List[int]:
        ids: List[int] = [] if self.bos is None or self.style == "gpt2" else [self.bos]
        for word in self._words(text):
            for piece in self._bpe(word):
                pid = self.vocab.get(piece, self.unk)
                if pid is not None:
                    ids.append(pid)
            if len(ids) >= self.max_length - 1:
                break
        if self.eos is not None and self.style != "gpt2":
            ids = ids[: self.max_length - 1] + [self.eos]
        return ids[: self.max_length]

    def encode_batch(self, texts: Sequence[Optional[str]]):
        return _pad_encode_batch(texts, self.max_length, self.encode_one)


def tokenizer_from_dir(path: str, max_length: int):
    """Best local tokenizer for an HF checkpoint dir: WordPiece when
    vocab.txt exists, merges BPE (clip or gpt2 dialect, detected from
    tokenizer_config.json / the vocab's special tokens) when
    vocab.json + merges.txt exist."""
    import json
    import os

    tok_cfg = {}
    cfgp = os.path.join(path, "tokenizer_config.json")
    if os.path.exists(cfgp):
        with open(cfgp) as f:
            tok_cfg = json.load(f)
    vt = os.path.join(path, "vocab.txt")
    if os.path.exists(vt):
        return WordPieceTokenizer(vt, max_length,
                                  lowercase=tok_cfg.get("do_lower_case", True))
    vj, mt = os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt")
    if os.path.exists(vj) and os.path.exists(mt):
        cls = tok_cfg.get("tokenizer_class", "")
        if "GPT2" in cls:
            style = "gpt2"
        elif "CLIP" in cls:
            style = "clip"
        else:
            with open(vj, encoding="utf-8") as f:
                vocab = json.load(f)
            style = "clip" if "<|startoftext|>" in vocab else "gpt2"
        return MergesBPETokenizer(vj, mt, max_length, style=style)
    return None


class BPETokenizer:
    """Greedy byte-pair tokenizer over a local vocab file (one token per line
    or tiktoken-style base64 ranks)."""

    def __init__(self, vocab_path: str, max_length: int):
        self.max_length = max_length
        self.vocab: dict = {}
        with open(vocab_path, "rb") as f:
            for i, line in enumerate(f):
                line = line.rstrip(b"\n")
                if b" " in line:  # tiktoken: base64 rank
                    import base64

                    tok, rank = line.split(b" ", 1)
                    self.vocab[base64.b64decode(tok)] = int(rank)
                else:
                    self.vocab[line] = i
        self.vocab_size = max(self.vocab.values()) + 1

    def _encode_word(self, word: bytes) -> List[int]:
        # Greedy longest-match segmentation.
        out = []
        i = 0
        while i < len(word):
            for j in range(len(word), i, -1):
                piece = word[i:j]
                if piece in self.vocab:
                    out.append(self.vocab[piece])
                    i = j
                    break
            else:
                i += 1  # unknown byte: skip
        return out

    def encode_batch(self, texts: Sequence[Optional[str]]):
        B = len(texts)
        out = np.zeros((B, self.max_length), dtype=np.int32)
        lengths = np.zeros(B, dtype=np.int32)
        for i, text in enumerate(texts):
            if not text:
                continue
            ids: List[int] = []
            for w in _WORD_RE.findall(text):
                ids.extend(self._encode_word(w.encode()))
                if len(ids) >= self.max_length:
                    break
            ids = ids[: self.max_length]
            out[i, : len(ids)] = ids
            lengths[i] = len(ids)
        return out, lengths
