"""The benchmark's tokenizer: made-up words that decode as their ids.

The served reports spell their token ids up to and including EOS, so the
harness reads back every served token and its length. ``decode_batch`` is
what a server calls when it makes a batch's records: ``on_batch`` (if set)
receives the host clock at that moment, which is when those records exist.
Ids follow the port's word-level layout: [PAD] 0, [CLS] 1, [SEP] 2,
[MASK] 3, [UNK] 4, the words, then [BOS] and [EOS].
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np

N_SPECIAL = 5


class SpelledIds:
    def __init__(self, vocab_size: int):
        self.vocab_size = int(vocab_size)
        self.pad_id, self.unk_id = 0, N_SPECIAL - 1
        self.bos_id = self.vocab_size - 2
        self.eos_id = self.vocab_size - 1
        self.on_batch: Optional[Callable[[float], None]] = None

    def get_vocab_size(self) -> int:
        return self.vocab_size

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out = []
        for i in map(int, ids):
            out.append(str(i))
            if i == self.eos_id:
                break
        return " ".join(out)

    def decode_batch(self, batch: Iterable[Sequence[int]],
                     skip_special_tokens: bool = True) -> List[str]:
        if self.on_batch is not None:
            self.on_batch(time.perf_counter())
        return [self.decode(ids) for ids in batch]

    @staticmethod
    def tokens(report: str) -> np.ndarray:
        """A served report's token ids."""
        return np.asarray([int(x) for x in report.split()], np.int64)
