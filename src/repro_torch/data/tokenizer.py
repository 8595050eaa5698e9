"""Tiny deterministic tokenizer for the synthetic reasoning task.

Character-level over digits/operators plus the special reasoning markers the
STEP paper keys on: <think>, </think> and the step delimiter "\n\n" (a
single token, so the boundary detector fires exactly at step ends).
"""
from __future__ import annotations

from typing import List

SPECIALS = ["<pad>", "<bos>", "<eos>", "<think>", "</think>", "\n\n",
            "boxed{", "}"]
CHARS = list("0123456789+-*=() ")


class ReasonTokenizer:
    def __init__(self):
        self.vocab: List[str] = SPECIALS + CHARS
        self.tok2id = {t: i for i, t in enumerate(self.vocab)}
        self.pad_id = self.tok2id["<pad>"]
        self.bos_id = self.tok2id["<bos>"]
        self.eos_id = self.tok2id["<eos>"]
        self.think_open_id = self.tok2id["<think>"]
        self.think_close_id = self.tok2id["</think>"]
        self.step_id = self.tok2id["\n\n"]       # the "\n\n" boundary token
        self.boxed_id = self.tok2id["boxed{"]
        self.close_id = self.tok2id["}"]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids: List[int] = [self.bos_id] if add_bos else []
        i = 0
        while i < len(text):
            for sp in SPECIALS[3:]:  # multi-char specials
                if text.startswith(sp, i):
                    ids.append(self.tok2id[sp])
                    i += len(sp)
                    break
            else:
                ch = text[i]
                if ch in self.tok2id:
                    ids.append(self.tok2id[ch])
                i += 1
        if add_eos:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: List[int]) -> str:
        return "".join(self.vocab[i] for i in ids
                       if 0 <= i < len(self.vocab)
                       and i not in (self.pad_id, self.bos_id, self.eos_id))


_TOKENIZER = None


def get_tokenizer() -> ReasonTokenizer:
    global _TOKENIZER
    if _TOKENIZER is None:
        _TOKENIZER = ReasonTokenizer()
    return _TOKENIZER
