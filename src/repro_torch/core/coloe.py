"""Colocation-mode (ColoE) line layout — paper §3.2 + Figure 6. Port of
``repro/core/coloe.py``.

A line is a 32-word (128 B) record; the ColoE buffer packs
[32 data words | counter word | flag word] so a sealed tensor streams as one
dense read, where counter mode needs a second stream for its counter table.
Flag bit 0 marks an encrypted line (the paper's emalloc bit). Words are int32
bit patterns (see ``repro_torch.u32``).
"""
from __future__ import annotations

from typing import Tuple

import torch

WORDS_PER_LINE = 32          # 128 B of data
COLOE_LINE_WORDS = 34        # + counter word + flag word
FLAG_ENCRYPTED = 1


def pad_to_lines(words: torch.Tensor):
    """(m,) int32 -> ((L, 32) int32, original length)."""
    m = words.shape[0]
    lines = -(-m // WORDS_PER_LINE)
    pad = lines * WORDS_PER_LINE - m
    if pad:
        words = torch.cat([words, words.new_zeros((pad,))])
    return words.reshape(lines, WORDS_PER_LINE), m


def unpad_lines(lines: torch.Tensor, orig_len: int) -> torch.Tensor:
    return lines.reshape(-1)[:orig_len]


def coloe_pack(data_lines, counters, flags) -> torch.Tensor:
    """(L,32), (L,), (L,) -> (L, 34) colocated buffer."""
    return torch.cat([data_lines, counters.to(torch.int32)[:, None],
                      flags.to(torch.int32)[:, None]], dim=1)


def coloe_unpack(packed) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(L, 34) -> data (L,32), counters (L,), flags (L,)."""
    return (packed[:, :WORDS_PER_LINE], packed[:, WORDS_PER_LINE],
            packed[:, WORDS_PER_LINE + 1])


def counter_mode_layout(data_lines, counters):
    """Counter-mode storage: two independent buffers (paper Fig 6a)."""
    return {"data": data_lines, "counters": counters.to(torch.int32)}


def coloe_bytes(n_lines: int) -> int:
    return n_lines * COLOE_LINE_WORDS * 4


def counter_mode_bytes(n_lines: int) -> Tuple[int, int]:
    """(data bytes, counter-table bytes)."""
    return n_lines * WORDS_PER_LINE * 4, n_lines * 8
