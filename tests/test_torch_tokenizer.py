"""The port's byte hash and hashing tokenizer against the JAX package's, on
the CPU.

Every comparison is exact: the hashing tokenizer's ids come from
``hash_bytes_batch``, so one bit of difference would change a token. The
reference hash runs both through its own dispatch (the native library where
it is built) and through its numpy path.
"""

import numpy as np
import pytest

from daft_tpu.kernels import hashing as jhash
from daft_tpu.utils import tokenizer as jtok
from daft_tpu_torch.kernels import hashing as thash
from daft_tpu_torch.utils import tokenizer as ttok

TEXTS = [
    "hello world",
    "The quick brown fox jumps over the lazy dog.",
    "naïve café, déjà vu — Straße",
    "日本語のテキストと中文",
    "emoji 🙂🚀 and symbols $+<=>^`|~ #hash_tag 3.14",
    "",
    None,
    "   ",
    "!!!",
    "UPPER lower MiXeD",
    " ".join(f"w{i}" for i in range(400)),        # more words than any max_length
    "x" * 5000,                                   # one over-long word
    "tab\tseparated\nnew lines",
]


@pytest.fixture(params=["dispatch", "numpy"])
def reference_hash(request, monkeypatch):
    """The JAX package's hash as it dispatches, or forced onto its numpy path."""
    if request.param == "numpy":
        import daft_tpu._native as native

        monkeypatch.setattr(native, "native_hash_bytes", lambda *a: None)
    return jhash.hash_bytes_batch


@pytest.mark.parametrize("case", ["random", "gaps", "empty_values", "no_values", "one_long"])
def test_hash_bytes_batch_is_bit_identical(reference_hash, case):
    rng = np.random.default_rng(7)
    if case == "random":
        lengths = rng.integers(0, 40, 300).astype(np.int64)
        data = rng.integers(0, 256, int(lengths.sum()), dtype=np.uint8)
        starts = (np.cumsum(lengths) - lengths).astype(np.int64)
    elif case == "gaps":  # values scattered through the buffer, out of order
        data = rng.integers(0, 256, 4096, dtype=np.uint8)
        lengths = rng.integers(0, 64, 100).astype(np.int64)
        starts = rng.integers(0, 4096 - 64, 100).astype(np.int64)
    elif case == "empty_values":
        data = np.zeros(0, np.uint8)
        lengths = np.zeros(5, np.int64)
        starts = np.zeros(5, np.int64)
    elif case == "no_values":
        data = np.zeros(0, np.uint8)
        lengths = starts = np.zeros(0, np.int64)
    else:  # longer than the default power table
        data = rng.integers(0, 256, 10000, dtype=np.uint8)
        lengths = np.array([10000, 0, 3], np.int64)
        starts = np.array([0, 5, 9000], np.int64)
    ref = reference_hash(data, starts, lengths)
    out = thash.hash_bytes_batch(data, starts, lengths)
    assert out.dtype == ref.dtype == np.uint64
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("vocab,max_length", [(30522, 256), (49408, 77), (512, 16), (3, 4)])
def test_hashing_tokenizer_ids_are_identical(reference_hash, vocab, max_length):
    ref_ids, ref_len = jtok.HashingTokenizer(vocab, max_length).encode_batch(TEXTS)
    ids, lengths = ttok.HashingTokenizer(vocab, max_length).encode_batch(TEXTS)
    assert ids.dtype == ref_ids.dtype == np.int32 and ids.shape == (len(TEXTS), max_length)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(lengths, ref_len)
    # Empty, None and blank rows carry no token; a long row fills max_length.
    assert lengths[5] == lengths[6] == lengths[7] == 0
    assert lengths[10] == max_length


@pytest.mark.parametrize("lowercase", [True, False])
def test_hashing_tokenizer_keeps_case_when_asked(lowercase):
    ref = jtok.HashingTokenizer(1000, 8, lowercase=lowercase).encode_batch(["Hello HELLO"])
    out = ttok.HashingTokenizer(1000, 8, lowercase=lowercase).encode_batch(["Hello HELLO"])
    np.testing.assert_array_equal(out[0], ref[0])
    assert (out[0][0, 0] == out[0][0, 1]) == lowercase


# Code points the random words draw from: ASCII, Latin-1 and Greek letters,
# CJK, emoji, combining marks and punctuation (multi-byte UTF-8 throughout).
ALPHABET = ("abcxyzABCXYZ0189_éüßñΩλж日本語中文한글🙂🚀\u0301.,!?-'$%" + "\t\n ")


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("vocab,max_length", [(30522, 256), (49408, 77)])
def test_hashing_tokenizer_ids_are_identical_on_random_strings(reference_hash, seed, vocab,
                                                               max_length):
    """Seeded strings of 0-2000 characters drawn from ``ALPHABET``, at the
    widths the MiniLM-L6 and CLIP text towers tokenize to; every id lies in
    [2, vocab) and padding is zero."""
    rng = np.random.default_rng(seed)
    texts = ["".join(rng.choice(list(ALPHABET), rng.integers(0, 2000))) for _ in range(64)]
    ref_ids, ref_len = jtok.HashingTokenizer(vocab, max_length).encode_batch(texts)
    ids, lengths = ttok.HashingTokenizer(vocab, max_length).encode_batch(texts)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(lengths, ref_len)
    valid = np.arange(max_length)[None, :] < lengths[:, None]
    assert (ids[valid] >= 2).all() and (ids[valid] < vocab).all() and not ids[~valid].any()
