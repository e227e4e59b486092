"""Tokenizer loading: HF tokenizer when available, byte fallback otherwise.

The byte tokenizer keeps demos/tests hermetic (no downloads): ids 0-255 are
raw bytes, 256 = BOS, 257 = EOS — matching LlamaConfig.tiny-scale vocabs.
"""

from __future__ import annotations

from typing import List, Optional


class ByteTokenizer:
    bos_id = 256
    eos_id = 257
    vocab_size = 258

    def encode(self, text: str) -> List[int]:
        return [self.bos_id] + list(text.encode("utf-8", errors="replace"))

    def decode(self, ids: List[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: List[dict]) -> str:
        parts = [f"{m.get('role', 'user')}: {m.get('content', '')}"
                 for m in messages]
        return "\n".join(parts) + "\nassistant:"


class HFTokenizer:
    def __init__(self, name_or_path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(name_or_path)
        self.bos_id = self._tok.bos_token_id
        self.eos_id = self._tok.eos_token_id
        self.vocab_size = len(self._tok)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text)

    def decode(self, ids: List[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: List[dict]) -> str:
        try:
            return self._tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True
            )
        except Exception:
            return ByteTokenizer.apply_chat_template(self, messages)  # type: ignore


def load_tokenizer(name_or_path: Optional[str]):
    if name_or_path:
        try:
            return HFTokenizer(name_or_path)
        except Exception:
            pass
    return ByteTokenizer()
