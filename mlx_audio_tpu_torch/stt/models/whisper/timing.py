"""Word-level timestamps via cross-attention DTW alignment.

Counterpart of mlx_audio_tpu/stt/models/whisper/timing.py (`median_filter`,
`dtw`, `find_alignment`, `merge_punctuations`, `add_word_timestamps`). The
decoder pass that yields the alignment heads' cross-attention runs on the
model's device (`decoder_forward_with_cross_qk`); its scores come back to
the host once, and the rest (softmax, normalisation, median filter, the
DTW dynamic program, word grouping) is host numpy, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .audio import TOKENS_PER_SECOND


def median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Median-filter the last axis with reflect padding."""
    if width <= 1 or x.shape[-1] <= width:
        return x
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.stack([xp[..., i: i + x.shape[-1]] for i in range(width)],
                       axis=-1)
    return np.median(windows, axis=-1).astype(np.float32)


def dtw(cost_matrix: np.ndarray):
    """Monotonic DTW path through cost (N, M) -> (text_idx, time_idx)."""
    n, m = cost_matrix.shape
    cost = np.full((n + 1, m + 1), np.inf, dtype=np.float32)
    trace = np.full((n + 1, m + 1), -1, dtype=np.int8)
    cost[0, 0] = 0.0
    for j in range(1, m + 1):
        diag = cost[:-1, j - 1]
        up = cost[:-1, j]  # filled progressively; do rows sequentially
        left = cost[1:, j - 1]
        # rows are data-dependent within a column -> fall back to row loop
        for i in range(1, n + 1):
            c0, c1, c2 = cost[i - 1, j - 1], cost[i - 1, j], cost[i, j - 1]
            if c0 <= c1 and c0 <= c2:
                c, t = c0, 0
            elif c1 <= c0 and c1 <= c2:
                c, t = c1, 1
            else:
                c, t = c2, 2
            cost[i, j] = cost_matrix[i - 1, j - 1] + c
            trace[i, j] = t
    # backtrace
    trace[0, :] = 2
    trace[:, 0] = 1
    i, j = n, m
    path = []
    while i > 0 or j > 0:
        path.append((i - 1, j - 1))
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    path = np.asarray(path)[::-1]
    return path[:, 0], path[:, 1]


@dataclass
class WordTiming:
    word: str
    tokens: List[int]
    start: float
    end: float
    probability: float


def find_alignment(model, tokenizer, text_tokens: List[int], mel_segment,
                   num_frames: int, medfilt_width: int = 7,
                   qk_scale: float = 1.0) -> List[WordTiming]:
    """Align text tokens to audio frames through alignment-head attention."""
    from .whisper import cross_kv, decoder_forward_with_cross_qk

    if not text_tokens:
        return []
    tokens = list(tokenizer.sot_sequence) + [tokenizer.no_timestamps] + \
        list(text_tokens) + [tokenizer.eot]
    with torch.inference_mode():
        feats = model.embed_audio(mel_segment)
        ckv = cross_kv(model, feats)
        logits, qks = decoder_forward_with_cross_qk(
            model, torch.tensor([tokens], dtype=torch.long,
                                device=model.device), ckv)
        logits = logits.float().cpu().numpy()
        qks = [q.cpu().numpy() for q in qks]

    sot_len = len(tokenizer.sot_sequence)
    sampled = np.asarray(logits[0][sot_len:-2, : tokenizer.eot],
                         dtype=np.float64)
    probs = np.exp(sampled - sampled.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    text_token_probs = probs[np.arange(len(text_tokens)), text_tokens]

    heads = model.alignment_heads
    weights = np.stack([np.asarray(qks[l][0, h], np.float64)
                        for l, h in heads])  # (H, T, S)
    weights = weights[:, :, : num_frames // 2]
    w = np.exp(weights * qk_scale
               - (weights * qk_scale).max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True)
    mean = w.mean(-2, keepdims=True)
    std = np.sqrt(w.var(-2, keepdims=True)) + 1e-8
    w = median_filter(((w - mean) / std).astype(np.float32), medfilt_width)

    matrix = w.mean(axis=0)[sot_len:-1]
    text_indices, time_indices = dtw(-matrix)

    words, word_tokens = tokenizer.split_to_word_tokens(
        list(text_tokens) + [tokenizer.eot])
    if len(word_tokens) <= 1:
        return []
    word_boundaries = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]),
                             (1, 0))
    jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1).astype(bool)
    jump_times = time_indices[jumps] / TOKENS_PER_SECOND
    starts = jump_times[word_boundaries[:-1]]
    ends = jump_times[word_boundaries[1:]]
    probs_w = [float(np.mean(text_token_probs[i:j]))
               for i, j in zip(word_boundaries[:-1], word_boundaries[1:])]
    return [WordTiming(word, toks, float(s), float(e), p)
            for word, toks, s, e, p in zip(words, word_tokens, starts, ends,
                                           probs_w)]


def merge_punctuations(alignment: List[WordTiming], prepended: str,
                       appended: str) -> None:
    i, j = len(alignment) - 2, len(alignment) - 1
    while i >= 0:
        prev, follow = alignment[i], alignment[j]
        if prev.word.startswith(" ") and prev.word.strip() in prepended:
            follow.word = prev.word + follow.word
            follow.tokens = prev.tokens + follow.tokens
            prev.word, prev.tokens = "", []
        else:
            j = i
        i -= 1
    i, j = 0, 1
    while j < len(alignment):
        prev, follow = alignment[i], alignment[j]
        if not prev.word.endswith(" ") and follow.word in appended:
            prev.word = prev.word + follow.word
            prev.tokens = prev.tokens + follow.tokens
            follow.word, follow.tokens = "", []
        else:
            i = j
        j += 1


def add_word_timestamps(*, segments: List[dict], model, tokenizer,
                        mel_segment, num_frames: int, time_offset: float,
                        prepend_punctuations: str = "\"'“¿([{-",
                        append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
                        ) -> None:
    """Attach per-word timings to decoded segments (in place)."""
    if not segments:
        return
    text_tokens = [t for seg in segments for t in seg["tokens"]
                   if t < tokenizer.eot]
    alignment = find_alignment(model, tokenizer, text_tokens, mel_segment,
                               num_frames)
    merge_punctuations(alignment, prepend_punctuations, append_punctuations)

    idx = 0
    for seg in segments:
        seg_tokens = [t for t in seg["tokens"] if t < tokenizer.eot]
        seg_words = []
        consumed = 0
        while idx < len(alignment) and consumed < len(seg_tokens):
            wt = alignment[idx]
            idx += 1
            consumed += len(wt.tokens)
            if not wt.word:
                continue
            seg_words.append({
                "word": wt.word,
                "start": round(time_offset + wt.start, 2),
                "end": round(time_offset + wt.end, 2),
                "probability": wt.probability,
            })
        seg["words"] = seg_words
        if seg_words:
            seg["start"] = seg_words[0]["start"]
            seg["end"] = seg_words[-1]["end"]
