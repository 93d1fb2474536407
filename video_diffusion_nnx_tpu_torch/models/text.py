"""Text conditioning: caption tokens and their 768-wide embeddings (counterpart of the JAX package's
models/text.py:31-122).

``tokenize`` turns captions into a padded ``(b, seq)`` int64 array of token
ids and ``bert_embed`` turns those into ``(b, BERT_MODEL_DIM)`` float32
conditioning vectors: the mean over a row's tokens, or its first token's
vector under ``return_cls_repr``. Both run on the host, once per batch of
captions.

Where a HuggingFace ``bert-base-cased`` is cached on the machine (weights
read with ``local_files_only``; nothing is downloaded) it is used through
``transformers``. Otherwise, as in the JAX package and logged the same way,
a deterministic hashed bag of words stands in: a token's id is a hash of the
lowercased word, and its vector a standard normal draw seeded with that id.
The stand-in is bit-equal to the JAX package's, so a recipe trained and
evaluated there with it is the same recipe here. Its embeddings are distinct
and consistent per caption, which is what conditioning needs; they carry no
meaning beyond that. :func:`embedding_name` says which of the two ran, for a
stats file.
"""

from __future__ import annotations

import hashlib
import logging
from typing import List, Sequence

import numpy as np

logger = logging.getLogger(__name__)

BERT_MODEL_DIM = 768
_MAX_LENGTH = 256
_PAD_ID = 0

_hf = None  # the (tokenizer, model) pair once loaded, False where none is available, None before the first try


def _try_load_hf():
    """The local ``bert-base-cased`` (tokenizer, model), or False; tried once per process."""
    global _hf
    if _hf is not None:
        return _hf
    try:
        from transformers import BertModel, BertTokenizerFast

        tok = BertTokenizerFast.from_pretrained("bert-base-cased", local_files_only=True)
        model = BertModel.from_pretrained("bert-base-cased", local_files_only=True)
        model.eval()
        _hf = (tok, model)
        logger.info("text conditioning: using local HuggingFace bert-base-cased")
    except Exception as e:  # no cached weights, or no transformers
        logger.warning(
            "text conditioning: bert-base-cased unavailable (%s); "
            "falling back to deterministic hashed embeddings",
            e,
        )
        _hf = False
    return _hf


def embedding_name() -> str:
    """Which embedding ``bert_embed`` uses in this process (for stats files)."""
    return "bert-base-cased (local HuggingFace weights)" if _try_load_hf() else "hashed bag of words (no local BERT weights)"


def _hash_token_id(token: str) -> int:
    digest = hashlib.sha256(token.encode("utf-8")).digest()
    return 1 + int.from_bytes(digest[:4], "little") % 30000


def tokenize(texts: str | Sequence[str]) -> np.ndarray:
    """Caption(s) as a ``(b, seq)`` int64 array of token ids, padded with 0 to the longest row."""
    if isinstance(texts, str):
        texts = [texts]
    hf = _try_load_hf()
    if hf:
        tok, _ = hf
        enc = tok(list(texts), padding="longest", truncation=True, max_length=_MAX_LENGTH)
        return np.asarray(enc["input_ids"], dtype=np.int64)
    rows: List[List[int]] = [[_hash_token_id(w) for w in t.lower().split()][:_MAX_LENGTH] for t in texts]
    width = max((len(r) for r in rows), default=1) or 1
    out = np.full((len(rows), width), _PAD_ID, dtype=np.int64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def bert_embed(token_ids: np.ndarray, return_cls_repr: bool = False) -> np.ndarray:
    """Token ids as ``(b, BERT_MODEL_DIM)`` float32 vectors: the mean over each row's non-pad tokens, or the
    first token's vector under ``return_cls_repr``. A row of padding alone gives zeros."""
    token_ids = np.asarray(token_ids)
    hf = _try_load_hf()
    if hf:
        import torch

        _, model = hf
        ids = torch.as_tensor(token_ids)
        mask = ids != _PAD_ID
        with torch.no_grad():
            hidden = model(input_ids=ids, attention_mask=mask.float()).last_hidden_state
        if return_cls_repr:
            return hidden[:, 0].numpy().astype(np.float32)
        m = mask[:, :, None].float()
        pooled = (hidden * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
        return pooled.numpy().astype(np.float32)

    # One standard normal vector per token, seeded with its id; averaged in float64, stored in float32.
    b, _ = token_ids.shape
    out = np.zeros((b, BERT_MODEL_DIM), dtype=np.float32)
    for i in range(b):
        vecs = [np.random.default_rng(int(t)).standard_normal(BERT_MODEL_DIM) for t in token_ids[i] if t != _PAD_ID]
        if return_cls_repr and vecs:
            out[i] = vecs[0]
        elif vecs:
            out[i] = np.mean(vecs, axis=0)
    return out


def embed_captions(captions: Sequence[str], return_cls_repr: bool = False) -> np.ndarray:
    """``bert_embed(tokenize(captions))``: captions as ``(b, BERT_MODEL_DIM)`` float32 vectors."""
    return bert_embed(tokenize(list(captions)), return_cls_repr=return_cls_repr)
