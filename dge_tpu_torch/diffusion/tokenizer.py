"""CLIP BPE tokenizer (self-contained).

JAX counterpart: ``dge_tpu/diffusion/tokenizer.py`` (a copy: the port
imports nothing of the JAX package). Loads the standard CLIP vocab.json +
merges.txt when available (the files shipped with every SD checkpoint's
``tokenizer/`` dir); without them, a hash fallback keeps smoke runs going
(its ids are stable but not meaningful: real editing needs the vocab
files). The fallback hashes words with ``zlib.crc32``, which is the same in
every process; the JAX package uses Python's ``hash``, which is salted per
process (ROADMAP.md §3).
"""

from __future__ import annotations

import html
import json
import os
import zlib
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np


@lru_cache()
def bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return " ".join(text.strip().lower().split())


class CLIPTokenizer:
    """Byte-level BPE matching openai/CLIP; encode() pads/truncates to
    max_length with <start>/<end> tokens like transformers' CLIPTokenizer."""

    def __init__(self, vocab_path: str, merges_path: str, max_length: int = 77,
                 pad_token: Optional[str] = None):
        self.max_length = max_length
        with open(vocab_path) as f:
            self.encoder: Dict[str, int] = json.load(f)
        merges = open(merges_path, encoding="utf-8").read().split("\n")
        merges = [m for m in merges if m and not m.startswith("#")]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.cache: Dict[str, str] = {}
        self.bos = self.encoder.get("<|startoftext|>", 49406)
        self.eos = self.encoder.get("<|endoftext|>", 49407)
        # SDXL's second tokenizer pads with "!" instead of the end token
        self.pad = (self.eos if pad_token is None
                    else self.encoder.get(pad_token, self.eos))

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        import re

        # openai/CLIP's pattern with ASCII classes (``re`` has no \p{L})
        pat = re.compile(
            r"""'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""")
        ids: List[int] = []
        for token in re.findall(pat, basic_clean(text)):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.max_length), self.pad, np.int64)
        for i, t in enumerate(texts):
            ids = [self.bos] + self.encode_text(t)[: self.max_length - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """Fallback when no vocab files exist (smoke runs and tests): a word's
    id is its crc32 modulo the vocabulary, the same in every process."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos, self.eos = 49406 % vocab_size, 49407 % vocab_size

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.max_length), self.eos, np.int64)
        for i, t in enumerate(texts):
            words = basic_clean(t).split()[: self.max_length - 2]
            ids = [self.bos] + [
                zlib.crc32(w.encode("utf-8")) % (self.vocab_size - 3) + 1
                for w in words
            ] + [self.eos]
            out[i, : len(ids)] = ids
        return out


def _pad_token(tokenizer_dir: str) -> Optional[str]:
    p = os.path.join(tokenizer_dir, "tokenizer_config.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        pad = json.load(f).get("pad_token")
    return pad.get("content") if isinstance(pad, dict) else pad


# vocab.json + merges.txt vendored here are found without configuration
# (the repository holds none)
ASSETS_TOKENIZER_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "assets", "tokenizer"
)


def load_tokenizer(
    tokenizer_dir: Optional[str] = None, max_length: int = 77
):
    """CLIPTokenizer when vocab files exist (in ``tokenizer_dir`` or the
    vendored assets dir), else HashTokenizer. The pad token is the
    directory's ``tokenizer_config.json`` ``pad_token`` where it names one
    (``"!"`` in SDXL's ``tokenizer_2/``), else the end token."""
    for d in (tokenizer_dir, ASSETS_TOKENIZER_DIR):
        if not d:
            continue
        vp = os.path.join(d, "vocab.json")
        mp = os.path.join(d, "merges.txt")
        if os.path.exists(vp) and os.path.exists(mp):
            return CLIPTokenizer(vp, mp, max_length, _pad_token(d))
    return HashTokenizer(max_length=max_length)
