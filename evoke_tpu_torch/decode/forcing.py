"""Forced report lengths for load tests: random weights never emit EOS, so a
load test forces each study's length through the decode hooks
(``train/steps.make_generate_step(logits_hook=, topk_hook=)``,
``decode/continuous.ContinuousServer(step_wrapper=, topk_wrapper=)``) and reads
it back through a tokenizer that spells the ids it decodes.
"""

from __future__ import annotations

import torch

# what a forced EOS scores, and what every other candidate scores beside it
_FORCE = 3e4


def force_logits(scores, age_rows, tgt_rows, eos):
    """Raw logits [N, V] with each row's length forced: EOS at +3e4 where the
    row's age reaches its target length ``tgt_rows`` [N] minus 1, -3e4 before."""
    is_eos = torch.arange(scores.shape[1], device=scores.device) == eos
    at_end = (age_rows == tgt_rows - 1)[:, None] & is_eos[None]
    before = (age_rows < tgt_rows - 1)[:, None] & is_eos[None]
    return torch.where(at_end, _FORCE, torch.where(before, -_FORCE, scores))


def force_topk(vals, idx, age_rows, tgt_rows, eos):
    """The same forcing on the fused tail's [N, k] candidates: EOS out of
    contention before the target; at it candidate 0 becomes EOS at +3e4 and
    the rest -3e4, so every beam ends there."""
    at_end = (age_rows == tgt_rows - 1)[:, None]
    vals = torch.where((idx == eos) & ~at_end, -_FORCE, vals)
    col0 = torch.arange(idx.shape[1], device=idx.device)[None, :] == 0
    vals = torch.where(at_end, torch.where(col0, _FORCE, -_FORCE), vals)
    return vals, torch.where(at_end & col0, eos, idx)


def synthetic_tokenizer(vocab_size: int = 30000, spell_ids: bool = False):
    """A ``vocab_size``-word tokenizer of made-up words. ``spell_ids``: its
    ``decode`` spells a report's ids up to and including EOS, so a record shows
    every token and its length (what a forced-length check reads)."""
    from evoke_tpu_torch.data.tokenizer import SPECIAL_TOKENS, WordTokenizer

    class SpelledTokenizer(WordTokenizer):
        def decode(self, ids, skip_special_tokens=True):
            out = []
            for i in map(int, ids):
                out.append(str(i))
                if i == self.eos_id:
                    break
            return " ".join(out)

    vocab = {t: i for i, t in enumerate(SPECIAL_TOKENS)}
    for i in range(vocab_size - len(vocab) - 2):   # [BOS], [EOS] are appended
        vocab[f"w{i}"] = len(vocab)
    tok = (SpelledTokenizer if spell_ids else WordTokenizer)(vocab)
    if tok.get_vocab_size() != vocab_size:
        raise ValueError(f"made {tok.get_vocab_size()} words, not {vocab_size}")
    return tok
