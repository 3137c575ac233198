"""The hashing word tokenizer (port of ``daft_tpu/utils/tokenizer.py``).

Zero-egress default: a deterministic hashing word tokenizer, stable across
hosts and with no vocab files, whose ids equal the JAX package's bit for bit.
Not ported yet: the vocab-file tokenizers (WordPiece, merges BPE, greedy BPE,
``tokenizer_from_dir``), which come with HF checkpoint conversion (ROADMAP
Queue A, item 5).
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np

_WORD_RE = re.compile(r"\w+|[^\w\s]")


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
