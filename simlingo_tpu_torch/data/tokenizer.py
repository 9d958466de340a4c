"""Tokenizer wrapper: HF tokenizer when available, byte-level fallback.

Copy of `simlingo_tpu/data/tokenizer.py` (the port imports nothing of the
JAX package).

The reference uses the InternVL2-1B tokenizer (Qwen2 BPE + InternVL special
tokens) and adds 8 placeholder special tokens (datamodule.py:130-136). This
environment has no network/HF cache, so:

  * `SimLingoTokenizer(path=...)` loads a local HF tokenizer directory when
    one is provided (production path, exact token parity);
  * `SimLingoTokenizer()` falls back to a deterministic byte-level tokenizer
    with the same special-token API (tests, synthetic training).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

# InternVL2 specials (reference internvl2_utils.py:103-106)
IMG_START_TOKEN = "<img>"
IMG_END_TOKEN = "</img>"
IMG_CONTEXT_TOKEN = "<IMG_CONTEXT>"
IM_START = "<|im_start|>"
IM_END = "<|im_end|>"

# simlingo placeholder tokens (reference datamodule.py:130-136)
PLACEHOLDER_TOKENS = (
    "<WAYPOINTS>", "<WAYPOINTS_DIFF>", "<ORG_WAYPOINTS_DIFF>",
    "<ORG_WAYPOINTS>", "<WAYPOINT_LAST>", "<ROUTE>",
    "<ROUTE_DIFF>", "<TARGET_POINT>",
)


class ByteFallbackTokenizer:
    """Deterministic byte-level tokenizer with special-token support.

    ids 0..255 = raw bytes; specials get ids >= 256. Not BPE -- used only
    where the real InternVL2 tokenizer files are unavailable.
    """

    def __init__(self, extra_specials: Sequence[str] = ()):
        self._specials: Dict[str, int] = {}
        base = [IM_START, IM_END, IMG_START_TOKEN, IMG_END_TOKEN,
                IMG_CONTEXT_TOKEN, "<pad>"]
        for tok in list(base) + list(extra_specials):
            if tok not in self._specials:
                self._specials[tok] = 256 + len(self._specials)
        self._id_to_special = {v: k for k, v in self._specials.items()}
        self.pad_token_id = self._specials["<pad>"]
        self.eos_token_id = self._specials[IM_END]
        self.vocab_size = 256 + len(self._specials)

    def add_special_tokens(self, tokens: Sequence[str]) -> None:
        for tok in tokens:
            if tok not in self._specials:
                self._specials[tok] = 256 + len(self._specials)
        self._id_to_special = {v: k for k, v in self._specials.items()}
        self.vocab_size = 256 + len(self._specials)

    def convert_tokens_to_ids(self, token: str) -> int:
        return self._specials[token]

    def encode(self, text: str) -> List[int]:
        """Greedy special-token segmentation, bytes elsewhere."""
        ids: List[int] = []
        i = 0
        # longest-first so <WAYPOINTS_DIFF> wins over <WAYPOINTS>
        specials = sorted(self._specials, key=len, reverse=True)
        while i < len(text):
            matched = False
            if text[i] == "<":
                for tok in specials:
                    if text.startswith(tok, i):
                        ids.append(self._specials[tok])
                        i += len(tok)
                        matched = True
                        break
            if not matched:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True
               ) -> str:
        out: List[str] = []
        buf = bytearray()
        for t in ids:
            t = int(t)
            if t < 256:
                buf.append(t)
            else:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                if not skip_special_tokens:
                    out.append(self._id_to_special.get(t, ""))
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)


class SimLingoTokenizer:
    """Unified tokenizer facade used by the data pipeline and the agent."""

    def __init__(self, path: Optional[str] = None):
        self.is_fallback = path is None
        if path is not None:
            from transformers import AutoTokenizer
            self.tk = AutoTokenizer.from_pretrained(
                path, trust_remote_code=True, use_fast=True)
            self.tk.add_special_tokens(
                {"additional_special_tokens": list(PLACEHOLDER_TOKENS)})
        else:
            self.tk = ByteFallbackTokenizer(extra_specials=PLACEHOLDER_TOKENS)

        self.img_context_id = self.tk.convert_tokens_to_ids(IMG_CONTEXT_TOKEN)
        self.placeholder_ids = {
            t: self.tk.convert_tokens_to_ids(t) for t in PLACEHOLDER_TOKENS}
        self.eos_token_id = self.tk.eos_token_id
        pad = getattr(self.tk, "pad_token_id", None)
        self.pad_token_id = pad if pad is not None else self.eos_token_id

    def encode(self, text: str) -> List[int]:
        if self.is_fallback:
            return self.tk.encode(text)
        return self.tk(text, add_special_tokens=False)["input_ids"]

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return self.tk.decode(ids, skip_special_tokens=skip_special_tokens)

    def convert_tokens_to_ids(self, token: str) -> int:
        return self.tk.convert_tokens_to_ids(token)
