"""T5 embedder: captions -> (B, 120, 2048) features and their mask (the JAX
package's `text/embedder.py`).

Each caption is cleaned twice (`cleaning.text_preprocess`), tokenized to
120 tokens with right padding and truncation, and encoded. The tokenizer is
a callable `(texts, max_length) -> (ids, mask)` given by the caller
(`from_pretrained` builds HF's AutoTokenizer from a local flan-t5-xl
checkout when `transformers` can be imported); token ids can also be
encoded directly (`encode`). Runs on the card unless the encoder is on the
CPU and `device="cpu"` is asked.
"""
from __future__ import annotations

import importlib.util
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from controlar_tpu_torch import check_on, resolve_device
from controlar_tpu_torch.models.t5 import T5_XL, T5Config, T5Encoder, t5_encode
from controlar_tpu_torch.text.cleaning import text_preprocess

Tokenizer = Callable[[List[str], int], Tuple[np.ndarray, np.ndarray]]


def hf_tokenizer(path: str, max_length: int = 120) -> Tokenizer:
    """HF's AutoTokenizer of a local checkout as a tokenizer callable
    (right padding to max_length, truncation); needs `transformers`."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(path, model_max_length=max_length)

    def tokenize(texts: List[str], n: int) -> Tuple[np.ndarray, np.ndarray]:
        enc = tok(texts, max_length=n, padding="max_length", truncation=True,
                  return_tensors="np")
        return enc["input_ids"], enc["attention_mask"]

    return tokenize


class T5Embedder:
    def __init__(self, model: T5Encoder, tokenizer: Optional[Tokenizer] = None,
                 cfg: T5Config = T5_XL, model_max_length: int = 120,
                 use_text_preprocessing: bool = True, device="cuda"):
        self.device = resolve_device(device)
        check_on(model, self.device)
        self.model, self.tokenizer, self.cfg = model, tokenizer, cfg
        self.model_max_length = model_max_length
        self.use_text_preprocessing = use_text_preprocessing

    @classmethod
    def from_pretrained(cls, path: str, tokenizer: Optional[Tokenizer] = None,
                        cfg: T5Config = T5_XL, dtype: torch.dtype = torch.bfloat16,
                        device="cuda", model_max_length: int = 120,
                        use_text_preprocessing: bool = True) -> "T5Embedder":
        """A local HF flan-t5-xl checkout: the encoder's weights
        (`checkpoint.load_t5_encoder`) cast to bf16, as the JAX package
        casts them, and, unless one is given, its tokenizer when
        `transformers` can be imported (else the embedder encodes token ids
        only)."""
        from controlar_tpu_torch.checkpoint import load_t5_encoder

        model = load_t5_encoder(path, cfg, dtype, device)
        if tokenizer is None and importlib.util.find_spec("transformers") is not None:
            tokenizer = hf_tokenizer(path, model_max_length)
        return cls(model, tokenizer, cfg, model_max_length, use_text_preprocessing, device)

    @torch.inference_mode()
    def encode(self, input_ids, attention_mask) -> Tuple[torch.Tensor, torch.Tensor]:
        """Token ids and mask (B, T) -> fp32 features (B, T, d_model) and the
        mask, on the embedder's device."""
        ids = torch.as_tensor(input_ids, device=self.device)
        mask = torch.as_tensor(attention_mask, device=self.device)
        return t5_encode(self.model, self.cfg, ids, mask).float(), mask

    def get_text_embeddings(self, texts: List[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Captions -> fp32 features (B, 120, d_model) and mask (B, 120)."""
        if self.tokenizer is None:
            raise ValueError("this T5Embedder has no tokenizer: pass one, or call encode() "
                             "with token ids")
        texts = [text_preprocess(t, self.use_text_preprocessing) for t in texts]
        ids, mask = self.tokenizer(texts, self.model_max_length)
        return self.encode(ids, mask)
