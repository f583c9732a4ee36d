"""WordLevel / WordPiece tokenizer with HF-`tokenizers`-compatible JSON persistence.

The port's own copy of ``evoke_tpu/data/tokenizer.py`` ``WordTokenizer`` (the
port imports nothing of ``evoke_tpu``). Same ids, same JSON format: a vocab
saved by either package loads in the other. Host-side pure Python: a dict
lookup per word at the data edge, never on the model's hot path.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

# HF `Whitespace` pre-tokenizer: runs of word chars, or runs of non-word non-space.
_WHITESPACE_RE = re.compile(r"\w+|[^\w\s]+")

SPECIAL_TOKENS = ["[PAD]", "[CLS]", "[SEP]", "[MASK]", "[UNK]"]
ADDED_TOKENS = ["[BOS]", "[EOS]"]


class WordTokenizer:
    """WordLevel (default) or WordPiece tokenizer.

    ids: [PAD]=0, [CLS]=1, [SEP]=2, [MASK]=3, [UNK]=4, then corpus vocab,
    then [BOS], [EOS] appended (matching the reference's add_special_tokens order).
    """

    def __init__(self, vocab: Dict[str, int], model: str = "wordlevel", lowercase: bool = True):
        self.model = model
        self.lowercase = lowercase
        self.vocab = dict(vocab)
        for tok in SPECIAL_TOKENS + ADDED_TOKENS:
            if tok not in self.vocab:
                self.vocab[tok] = len(self.vocab)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.unk_id = self.vocab["[UNK]"]
        self.pad_id = self.vocab["[PAD]"]
        self.bos_id = self.vocab["[BOS]"]
        self.eos_id = self.vocab["[EOS]"]
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        self._special_ids = {self.vocab[t] for t in SPECIAL_TOKENS + ADDED_TOKENS}

    # ---- core API (mirrors the subset of `tokenizers.Tokenizer` the reference uses) ----

    def get_vocab_size(self) -> int:
        return len(self.vocab)

    def token_to_id(self, token: str) -> Optional[int]:
        return self.vocab.get(token)

    def pre_tokenize(self, text: str) -> List[str]:
        return _WHITESPACE_RE.findall(text)

    def encode(self, text: str) -> List[int]:
        """Text -> ids. Special-token literals in the text map to their ids."""
        if self.lowercase:
            # specials are uppercase literals; split them out before lowering
            parts = re.split(r"(\[(?:PAD|CLS|SEP|MASK|UNK|BOS|EOS)\])", text)
        else:
            parts = [text]
        ids: List[int] = []
        for part in parts:
            if not part:
                continue
            if part in self.vocab and part.startswith("["):
                ids.append(self.vocab[part])
                continue
            words = self.pre_tokenize(part.lower() if self.lowercase else part)
            for w in words:
                if self.model == "wordpiece":
                    ids.extend(self._encode_wordpiece(w))
                else:
                    ids.append(self.vocab.get(w, self.unk_id))
        return ids

    def _encode_wordpiece(self, word: str, max_chars: int = 100) -> List[int]:
        if len(word) > max_chars:
            return [self.unk_id]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            out.append(cur)
            start = end
        return out

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self._special_ids:
                continue
            tok = self.id_to_token.get(i)
            if tok is None:
                continue
            toks.append(tok)
        if self.model == "wordpiece":
            text = ""
            for t in toks:
                if t.startswith("##"):
                    text += t[2:]
                else:
                    text += (" " if text else "") + t
            return text
        return " ".join(toks)

    def decode_batch(self, batch: Iterable[Sequence[int]], skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    def encode_padded(self, text: str, max_len: int, add_bos_eos: bool = False,
                      add_cls: bool = False) -> np.ndarray:
        """Static-shape encode: [max_len] int32 ids + implicit mask (ids != pad)."""
        ids = self.encode(text)
        if add_cls:
            ids = [self.cls_id] + ids
        if add_bos_eos:
            ids = [self.bos_id] + ids + [self.eos_id]
        ids = ids[:max_len]
        out = np.full((max_len,), self.pad_id, dtype=np.int32)
        out[: len(ids)] = ids
        return out

    # ---- persistence (HF tokenizers JSON) ----

    def save(self, path: str) -> None:
        base_vocab = {t: i for t, i in self.vocab.items() if t not in ADDED_TOKENS}
        added = [
            {"id": self.vocab[t], "content": t, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True}
            for t in SPECIAL_TOKENS
        ]
        model: Dict = {"type": "WordLevel" if self.model == "wordlevel" else "WordPiece",
                       "vocab": base_vocab, "unk_token": "[UNK]"}
        if self.model == "wordpiece":
            model["continuing_subword_prefix"] = "##"
            model["max_input_chars_per_word"] = 100
        blob = {
            "version": "1.0",
            "truncation": None,
            "padding": None,
            "added_tokens": added,
            "normalizer": None,
            "pre_tokenizer": {"type": "Whitespace"},
            "post_processor": None,
            "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True}
            if self.model == "wordpiece" else None,
            "model": model,
        }
        with open(path, "w") as f:
            json.dump(blob, f, indent=2)

    @classmethod
    def from_file(cls, path: str, lowercase: bool = True) -> "WordTokenizer":
        with open(path) as f:
            blob = json.load(f)
        mtype = blob["model"]["type"].lower()
        vocab = dict(blob["model"]["vocab"])
        # added_tokens may carry ids outside the model vocab
        for at in blob.get("added_tokens", []):
            vocab.setdefault(at["content"], at["id"])
        return cls(vocab, model="wordlevel" if mtype == "wordlevel" else "wordpiece",
                   lowercase=lowercase)

    # ---- training ----

    @classmethod
    def train(cls, corpus: Iterable[str], model: str = "wordlevel", lowercase: bool = True,
              min_frequency: int = 0, vocab_size: Optional[int] = None) -> "WordTokenizer":
        """Train a WordLevel vocab: specials first, then words by freq desc
        (ties by first occurrence). WordPiece training is not needed by the
        reference's default path (wordlevel); load pretrained wordpiece vocabs instead.
        """
        if model != "wordlevel":
            raise NotImplementedError("training supports wordlevel; load wordpiece vocabs from file")
        counts: Dict[str, int] = {}
        order: Dict[str, int] = {}
        tmp = cls({t: i for i, t in enumerate(SPECIAL_TOKENS)}, lowercase=lowercase)
        for line in corpus:
            for w in tmp.pre_tokenize(line.lower() if lowercase else line):
                if w not in counts:
                    order[w] = len(order)
                    counts[w] = 0
                counts[w] += 1
        words = [w for w in counts if counts[w] >= max(min_frequency, 1)]
        words.sort(key=lambda w: (-counts[w], order[w]))
        if vocab_size is not None:
            words = words[: max(0, vocab_size - len(SPECIAL_TOKENS))]
        vocab = {t: i for i, t in enumerate(SPECIAL_TOKENS)}
        for w in words:
            vocab[w] = len(vocab)
        return cls(vocab, model=model, lowercase=lowercase)



def build_tokenizer(tokenizer_dir: str, data_name: str, ann_path: Optional[str] = None,
                    model: str = "wordlevel", tokenizer_type: str = "uncased",
                    is_same_tokenizer: bool = False) -> WordTokenizer:
    """Train-or-load, with the reference's file layout
    ``{dir}/{data}_{model}_{type}_tokenizer.json``: an existing file is
    loaded, else a wordlevel vocab is trained on the train split's reports
    (each study id once) and saved there."""
    if is_same_tokenizer:
        data_name = "mimic_cxr"
    os.makedirs(tokenizer_dir, exist_ok=True)
    path = os.path.join(tokenizer_dir, f"{data_name}_{model}_{tokenizer_type}_tokenizer.json")
    lowercase = tokenizer_type == "uncased"
    if os.path.exists(path):
        return WordTokenizer.from_file(path, lowercase=lowercase)
    if not ann_path:
        raise FileNotFoundError(f"no tokenizer at {path} and no ann_path to train from")
    with open(ann_path) as f:
        ann = json.load(f)
    seen, corpus = set(), []
    for item in ann["train"]:
        if item["id"] in seen:
            continue
        seen.add(item["id"])
        corpus.append(item["report"].lower() if lowercase else item["report"])
    tok = WordTokenizer.train(corpus, model=model, lowercase=lowercase)
    tok.save(path)
    return tok
