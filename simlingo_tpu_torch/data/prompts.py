"""Chat-template construction + tokenization into static-shape LanguageLabels.

Copy of `simlingo_tpu/data/prompts.py` over the port's torch structs: the
internlm2-chat template with `<image>` expanded to `<img>` + N x
`<IMG_CONTEXT>` + `</img>`, assistant-only loss masking, left or right
padding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from simlingo_tpu_torch.core.structs import LanguageLabel
from simlingo_tpu_torch.data.tokenizer import (IM_END, IM_START,
                                               IMG_CONTEXT_TOKEN,
                                               IMG_END_TOKEN, IMG_START_TOKEN,
                                               SimLingoTokenizer)

USER_PREFIX = f"{IM_START}user\n"
ASSISTANT_PREFIX = f"{IM_START}assistant\n"
SEP = f"{IM_END}"


def image_token_block(num_image_tokens: int) -> str:
    return IMG_START_TOKEN + IMG_CONTEXT_TOKEN * num_image_tokens + IMG_END_TOKEN


@dataclasses.dataclass
class TokenizedChat:
    ids: np.ndarray          # [T] int32
    loss_mask: np.ndarray    # [T] bool (assistant answer tokens + final sep)


def tokenize_chat(tok: SimLingoTokenizer, question: str,
                  answer: Optional[str], num_image_tokens: int
                  ) -> TokenizedChat:
    """Tokenize piecewise so the assistant span is known exactly."""
    prefix = (f"{USER_PREFIX}{image_token_block(num_image_tokens)}\n"
              f"{question}{SEP}{ASSISTANT_PREFIX}")
    prefix_ids = tok.encode(prefix)
    if answer is None:
        ids = np.asarray(prefix_ids, np.int32)
        return TokenizedChat(ids=ids, loss_mask=np.zeros(len(ids), bool))
    ans_ids = tok.encode(f"{answer}{SEP}")
    ids = np.asarray(prefix_ids + ans_ids, np.int32)
    mask = np.zeros(len(ids), bool)
    mask[len(prefix_ids):] = True
    return TokenizedChat(ids=ids, loss_mask=mask)


def find_placeholder_slots(ids: np.ndarray,
                           placeholder_values: Dict[int, np.ndarray],
                           max_placeholders: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """{token_id: coords [N, 2]} -> flat (slot, coord) lists: coordinates
    overwrite embeddings from the FIRST occurrence of the token id on."""
    slots = np.full(max_placeholders, -1, np.int32)
    coords = np.zeros((max_placeholders, 2), np.float32)
    cursor = 0
    for token_id, value in placeholder_values.items():
        value = np.asarray(value, np.float32).reshape(-1, 2)
        occ = np.nonzero(ids == token_id)[0]
        if len(occ) == 0:
            continue
        for j in range(len(value)):
            if cursor >= max_placeholders:
                break
            slots[cursor] = occ[0] + j
            coords[cursor] = value[j]
            cursor += 1
    return slots, coords


def batch_language_label(chats: Sequence[TokenizedChat],
                         placeholder_values: Sequence[Dict[int, np.ndarray]],
                         pad_id: int, max_len: int, pad_side: str = "right",
                         max_placeholders: int = 8) -> LanguageLabel:
    """Pad tokenized chats into one static-shape LanguageLabel (CPU tensors)."""
    B = len(chats)
    ids = np.full((B, max_len), pad_id, np.int64)
    valid = np.zeros((B, max_len), bool)
    loss_mask = np.zeros((B, max_len), bool)
    ph_slots = np.full((B, max_placeholders), -1, np.int64)
    ph_coords = np.zeros((B, max_placeholders, 2), np.float32)
    for b, chat in enumerate(chats):
        n = len(chat.ids)
        if n > max_len:
            raise ValueError(f"sample {b}: {n} tokens > max_len {max_len}")
        off = 0 if pad_side == "right" else max_len - n
        ids[b, off:off + n] = chat.ids
        valid[b, off:off + n] = True
        loss_mask[b, off:off + n] = chat.loss_mask
        slots, coords = find_placeholder_slots(
            chat.ids, placeholder_values[b] or {}, max_placeholders)
        ph_slots[b] = np.where(slots >= 0, slots + off, -1)
        ph_coords[b] = coords
    return LanguageLabel(ids=torch.from_numpy(ids), valid=torch.from_numpy(valid),
                         loss_mask=torch.from_numpy(loss_mask),
                         ph_slots=torch.from_numpy(ph_slots),
                         ph_coords=torch.from_numpy(ph_coords))
