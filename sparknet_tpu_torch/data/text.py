"""Text data layer for the BERT family: corpus -> MLM batches.

Counterpart of ``sparknet_tpu/data/text.py``, numpy only, so its batches
are the JAX feed's bit for bit for the same seed. Partitions are pure
functions and masking is a deterministic per-batch transform keyed by
the feed rng, so every batch is recomputable after preemption. The
sequence-parallel feed ``mlm_feed_tokens`` is not ported.

Two corpus sources:
- plain-text files: whitespace tokenization over a vocab built from the
  corpus (deterministic: sorted by frequency then token);
- synthetic: a fixed-transition Markov chain over the vocab — learnable
  structure (MLM loss drops fast) with zero bytes on disk.

Special token ids follow BERT convention: 0=[PAD] 1=[UNK] 2=[CLS]
3=[SEP] 4=[MASK]; real tokens start at 5.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .rdd import ShardedDataset

PAD, UNK, CLS, SEP, MASK = 0, 1, 2, 3, 4
NUM_SPECIAL = 5


class Vocab:
    def __init__(self, tokens: Sequence[str]):
        self.itos = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list(tokens)
        self.stoi = {t: i for i, t in enumerate(self.itos)}

    def __len__(self) -> int:
        return len(self.itos)

    def encode(self, words: Sequence[str]) -> List[int]:
        return [self.stoi.get(w, UNK) for w in words]

    @classmethod
    def from_corpus(cls, texts: Sequence[str], max_size: int = 30000) -> "Vocab":
        counts: Dict[str, int] = {}
        for t in texts:
            for w in t.split():
                counts[w] = counts.get(w, 0) + 1
        ordered = sorted(counts, key=lambda w: (-counts[w], w))
        return cls(ordered[: max_size - NUM_SPECIAL])


def synthetic_token_stream(
    n_tokens: int, vocab_size: int, seed: int = 0
) -> np.ndarray:
    """Markov chain over real-token ids [NUM_SPECIAL, vocab_size): each
    token strongly predicts a successor — structure MLM can learn."""
    real = vocab_size - NUM_SPECIAL
    if real < 2:
        raise ValueError(f"vocab_size {vocab_size}: want at least {NUM_SPECIAL + 2}")
    rng = np.random.default_rng(seed)
    # deterministic successor table + noise
    succ = (np.arange(real) * 17 + 3) % real
    toks = np.empty(n_tokens, np.int64)
    t = 0
    for i in range(n_tokens):
        toks[i] = t + NUM_SPECIAL
        t = succ[t] if rng.random() < 0.8 else rng.integers(0, real)
    return toks


def mlm_mask(
    tokens: np.ndarray,
    rng: np.random.Generator,
    vocab_size: int,
    max_preds: int,
    mask_prob: float = 0.15,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """BERT masking on one sequence (no [CLS]/[SEP]/[PAD] positions):
    of chosen positions 80% -> [MASK], 10% -> random token, 10% kept.
    Returns (masked_tokens, positions, labels, weights), fixed length
    ``max_preds`` (zero-padded)."""
    maskable = np.flatnonzero(tokens >= NUM_SPECIAL)
    n = min(max_preds, max(1, int(round(len(maskable) * mask_prob))))
    if len(maskable) == 0:
        n = 0
    chosen = (
        rng.choice(maskable, size=n, replace=False) if n else np.empty(0, np.int64)
    )
    out = tokens.copy()
    labels = np.zeros(max_preds, np.int64)
    positions = np.zeros(max_preds, np.int64)
    weights = np.zeros(max_preds, np.float32)
    for j, p in enumerate(sorted(chosen)):
        positions[j] = p
        labels[j] = tokens[p]
        weights[j] = 1.0
        r = rng.random()
        if r < 0.8:
            out[p] = MASK
        elif r < 0.9:
            out[p] = rng.integers(NUM_SPECIAL, vocab_size)
        # else keep original
    return out, positions, labels, weights


def mlm_dataset(
    *,
    text_files: Optional[Sequence[str]] = None,
    vocab: Optional[Vocab] = None,
    vocab_size: int = 1024,
    n_tokens: int = 1 << 16,
    seq_len: int = 128,
    num_partitions: int = 8,
    seed: int = 0,
) -> Tuple[ShardedDataset, int]:
    """Dataset of {"tokens": (seq_len,) int sequences with [CLS]/[SEP]}.
    Returns (dataset, vocab_size)."""
    if text_files:
        texts = []
        for path in text_files:
            with open(path) as f:
                texts.append(f.read())
        vocab = vocab or Vocab.from_corpus(texts, max_size=vocab_size)
        ids: List[int] = []
        for t in texts:
            ids.extend(vocab.encode(t.split()))
        stream = np.asarray(ids, np.int64)
        vsize = len(vocab)
    else:
        stream = synthetic_token_stream(n_tokens, vocab_size, seed)
        vsize = vocab_size
    body = seq_len - 2  # room for [CLS] ... [SEP]
    n_seq = len(stream) // body
    seqs = np.full((n_seq, seq_len), PAD, np.int64)
    seqs[:, 0] = CLS
    seqs[:, 1 : body + 1] = stream[: n_seq * body].reshape(n_seq, body)
    seqs[:, body + 1] = SEP
    ds = ShardedDataset.from_arrays({"tokens": seqs}, num_partitions)
    return ds, vsize


def mlm_feed(
    ds: ShardedDataset,
    batch_size: int,
    vocab_size: int,
    max_preds: int,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Batches in the BertMLM blob layout (host numpy)."""

    def transform(batch, rng):
        toks = batch["tokens"]
        b, s = toks.shape
        ids = np.empty((b, s), np.int32)
        positions = np.empty((b, max_preds), np.int32)
        labels = np.empty((b, max_preds), np.int32)
        weights = np.empty((b, max_preds), np.float32)
        for i in range(b):
            o, p, l, w = mlm_mask(toks[i], rng, vocab_size, max_preds)
            ids[i], positions[i], labels[i], weights[i] = o, p, l, w
        return {
            "input_ids": ids,
            "token_type_ids": np.zeros((b, s), np.int32),
            "attention_mask": (toks != PAD).astype(np.int32),
            "mlm_positions": positions,
            "mlm_labels": labels,
            "mlm_weights": weights,
        }

    return ds.batches(batch_size, shuffle=True, seed=seed, transform=transform)

