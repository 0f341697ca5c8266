"""CLIP BPE tokenizer (self-contained) + a deterministic fallback.

A stdlib+numpy counterpart of ``vidtome_tpu/models/tokenizer.py`` (the port
does not import the JAX package); ``tests/test_torch_core.py`` pins
identical ids.

The reference uses HuggingFace's CLIPTokenizer (`invert.py:72-73`), whose
vocab/merges ship with every SD checkpoint.  This is an owned
implementation of the same byte-level BPE scheme: lowercase, whitespace
split with punctuation isolation, bytes->unicode mapping, BPE merges with
an end-of-word marker, then ``<|startoftext|> ids... <|endoftext|>`` padded
to 77 with the EOT token.

When no vocab files are available (e.g. weight-free testing in a zero-
egress environment) :class:`HashTokenizer` provides a deterministic stand-in
with the same interface and shapes.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
import zlib

import numpy as np


@functools.lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    """Map bytes to printable unicode chars (GPT-2/CLIP convention)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
    .replace(r"\p{L}", r"a-zA-Z").replace(r"\p{N}", r"0-9"),
    re.IGNORECASE,
)


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip().lower()


class CLIPTokenizer:
    """Byte-level BPE with CLIP's end-of-word convention."""

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 max_length: int = 77):
        self.encoder = vocab
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.max_length = max_length
        self.bos = vocab["<|startoftext|>"]
        self.eos = vocab["<|endoftext|>"]
        self.model_max_length = max_length
        self._cache: dict[str, list[str]] = {}

    @classmethod
    def from_dir(cls, path: str, max_length: int = 77) -> "CLIPTokenizer":
        """Load from a checkpoint's tokenizer dir: vocab.json + merges.txt
        (plain or .gz), the layout shipped with SD checkpoints."""
        vocab_path = os.path.join(path, "vocab.json")
        with open(vocab_path) as f:
            vocab = json.load(f)
        merges_path = os.path.join(path, "merges.txt")
        if os.path.exists(merges_path):
            with open(merges_path, encoding="utf-8") as f:
                lines = f.read().split("\n")
        else:
            with gzip.open(merges_path + ".gz", "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
        merges = []
        for line in lines:
            if not line or line.startswith("#version"):
                continue
            parts = tuple(line.split())
            if len(parts) == 2:
                merges.append(parts)
        return cls(vocab, merges, max_length)

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: list[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for token in _PAT.findall(_basic_clean(text)):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token)
                       if t in self.encoder)
        return ids

    def __call__(self, prompts: str | list[str]) -> np.ndarray:
        """Tokenize to [B, max_length] int32, BOS + ids + EOS, EOS-padded,
        truncated like the reference (padding='max_length', truncation=True)."""
        if isinstance(prompts, str):
            prompts = [prompts]
        out = np.full((len(prompts), self.max_length), self.eos, np.int32)
        for i, p in enumerate(prompts):
            ids = [self.bos] + self.encode(p)[: self.max_length - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic stand-in when no vocab files exist (testing only)."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.model_max_length = max_length
        self.bos = vocab_size - 2
        self.eos = vocab_size - 1

    def __call__(self, prompts: str | list[str]) -> np.ndarray:
        if isinstance(prompts, str):
            prompts = [prompts]
        out = np.full((len(prompts), self.max_length), self.eos, np.int32)
        for i, p in enumerate(prompts):
            words = _basic_clean(p).split()[: self.max_length - 2]
            ids = [self.bos] + [
                (zlib.crc32(w.encode("utf-8")) % (self.vocab_size - 2))
                for w in words] + [self.eos]
            out[i, : len(ids)] = ids
        return out


def load_tokenizer(model_dir: str | None, vocab_size: int = 49408,
                   max_length: int = 77):
    """Tokenizer from ``<model_dir>/tokenizer`` if present, else fallback
    (``tokenizer_2`` covers SDXL-refiner checkpoints, which ship only the
    second tokenizer)."""
    if model_dir:
        for sub in ("tokenizer", "tokenizer_2", "."):
            path = os.path.join(model_dir, sub)
            if os.path.exists(os.path.join(path, "vocab.json")):
                return CLIPTokenizer.from_dir(path, max_length)
    return HashTokenizer(vocab_size, max_length)
