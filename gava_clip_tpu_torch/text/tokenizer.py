"""CLIP byte-level BPE tokenizer (pure Python, host-side; the port's own
copy of gava_clip_tpu/text/tokenizer.py).

Token-for-token compatible with the OpenAI CLIP tokenizer: vocab 49408,
<|startoftext|>=49406, <|endoftext|>=49407, context length 77, zero
padding.

The merge table is the public `bpe_simple_vocab_16e6.txt.gz` asset shipped
in gava_clip_tpu_torch/assets/. `regex` and `ftfy` are used when importable;
without them the split pattern falls back to ASCII classes and the cleaning
to NFC normalization, which give the same ids for ASCII class names and
prompts (held by tests/test_torch_text.py).
"""

import functools
import gzip
import html
import os
import unicodedata
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

try:
    import regex as _re
except ImportError:
    _re = None

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
DEFAULT_BPE_PATH = os.path.join(_ASSET_DIR, "bpe_simple_vocab_16e6.txt.gz")

SOT_TOKEN = 49406
EOT_TOKEN = 49407
CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408


@functools.lru_cache()
def _byte_to_unicode() -> Dict[int, str]:
    """GPT-2 style reversible byte<->unicode table (printable-range passthrough)."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    table = {b: chr(b) for b in keep}
    offset = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + offset)
            offset += 1
    return table


def _clean_text(text: str) -> str:
    try:
        import ftfy
        text = ftfy.fix_text(text)
    except ImportError:
        text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    text = " ".join(text.split())
    return text.strip()


def _adjacent_pairs(word: Tuple[str, ...]):
    return set(zip(word[:-1], word[1:]))


class ClipBpeTokenizer:
    """Byte-level BPE encoder/decoder with the CLIP merge table."""

    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self.byte_encoder = _byte_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        with gzip.open(bpe_path, "rb") as f:
            lines = f.read().decode("utf-8").split("\n")
        # line 0 is a header; the usable merge list is capped at the canonical
        # count so vocab size lands exactly at 49408.
        n_merges = 49152 - 256 - 2
        merges = [tuple(line.split()) for line in lines[1:n_merges + 1]]

        base = list(self.byte_encoder.values())
        vocab: List[str] = base + [tok + "</w>" for tok in base]
        vocab += ["".join(pair) for pair in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        assert len(vocab) == VOCAB_SIZE

        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self.merge_rank: Dict[Tuple[str, str], int] = {p: i for i, p in enumerate(merges)}
        self._cache: Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        if _re is not None:
            self._pattern = _re.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
                _re.IGNORECASE,
            )
        else:
            import re as _stdre
            self._pattern = _stdre.compile(
                r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+""",
                _stdre.IGNORECASE,
            )

    def _bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            return token + "</w>"
        pairs = _adjacent_pairs(word)
        while pairs:
            best = min(pairs, key=lambda p: self.merge_rank.get(p, 1 << 30))
            if best not in self.merge_rank:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if word[i] == first and i + 1 < len(word) and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _adjacent_pairs(word)
        result = " ".join(word)
        self._cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _clean_text(text).lower()
        for chunk in self._pattern.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._bpe(mapped).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def _default_tokenizer() -> ClipBpeTokenizer:
    return ClipBpeTokenizer()


def tokenize(texts: Union[str, Sequence[str]],
             context_length: int = CONTEXT_LENGTH,
             truncate: bool = False) -> np.ndarray:
    """Tokenize text(s) to a zero-padded (N, context_length) int32 array:
    [SOT] + bpe(text) + [EOT], error on overflow unless truncate."""
    if isinstance(texts, str):
        texts = [texts]
    tok = _default_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [SOT_TOKEN] + tok.encode(text) + [EOT_TOKEN]
        if len(ids) > context_length:
            if truncate:
                ids = ids[:context_length]
                ids[-1] = EOT_TOKEN
            else:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length {context_length}")
        out[i, :len(ids)] = ids
    return out
