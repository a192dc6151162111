"""The port's NeMo alignment (`stt/models/nemo`) and Parakeet's long-file
path: the cases of tests/test_nemo_alignment.py on the port, then both
merges and the sentence split held to the JAX package's on seeded random
token streams (equal results). Host code only; the chunked decode runs the
tiny Parakeet of tests/test_torch_parakeet.py.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from mlx_audio_tpu.stt.models import nemo as jnemo  # noqa: E402
from mlx_audio_tpu_torch.stt.models.nemo import (  # noqa: E402
    AlignedToken,
    merge_longest_common_subsequence,
    merge_longest_contiguous,
    sentences_to_result,
    tokens_to_sentences,
)


def _tok(i, text, start, dur=0.1):
    return AlignedToken(id=i, text=text, start=start, duration=dur)


class TestSentences:
    def test_split_on_punctuation(self):
        toks = [_tok(0, "Hi", 0.0), _tok(1, "!", 0.1),
                _tok(2, " Bye", 0.2), _tok(3, ".", 0.3)]
        sents = tokens_to_sentences(toks)
        assert len(sents) == 2
        assert sents[0].text == "Hi!"
        assert sents[1].text == " Bye."
        assert sents[0].start == 0.0 and sents[0].end == pytest.approx(0.2)

    def test_period_mid_word_does_not_split(self):
        toks = [_tok(0, "3", 0.0), _tok(1, ".", 0.1), _tok(2, "5", 0.2)]
        assert len(tokens_to_sentences(toks)) == 1

    def test_result_text(self):
        toks = [_tok(0, " a", 0.0), _tok(1, ".", 0.1)]
        res = sentences_to_result(tokens_to_sentences(toks))
        assert res.text == "a."


def _stream(ids, t0, spf=0.1):
    return [_tok(i, chr(97 + i % 26), t0 + k * spf) for k, i in enumerate(ids)]


class TestMerge:
    def test_disjoint_concatenates(self):
        a = _stream([1, 2, 3], 0.0)
        b = _stream([4, 5], 1.0)
        for merge in (merge_longest_contiguous,
                      merge_longest_common_subsequence):
            out = merge(a, b, overlap_duration=0.5)
            assert [t.id for t in out] == [1, 2, 3, 4, 5]

    def test_overlap_dedup(self):
        a = _stream([1, 2, 3, 4, 5, 6, 7, 8], 0.0)
        b = _stream([5, 6, 7, 8, 9, 10, 11, 12], 0.4)
        for merge in (merge_longest_contiguous,
                      merge_longest_common_subsequence):
            out = merge(a, b, overlap_duration=0.4)
            assert [t.id for t in out] == list(range(1, 13))

    def test_lcs_with_disagreement(self):
        a = _stream([1, 2, 3, 4, 5, 6], 0.0)
        b = [_tok(3, "c", 0.2), _tok(5, "e", 0.4), _tok(6, "f", 0.5),
             _tok(7, "g", 0.6), _tok(8, "h", 0.7)]
        out = merge_longest_common_subsequence(a, b, overlap_duration=0.4)
        ids = [t.id for t in out]
        assert ids[-2:] == [7, 8]
        assert ids == sorted(ids)

    def test_empty_sides(self):
        a = _stream([1], 0.0)
        assert merge_longest_contiguous(a, [], overlap_duration=1.0) == a
        assert merge_longest_contiguous([], a, overlap_duration=1.0) == a


class TestParakeetChunked:
    def test_chunked_matches_single_shape(self):
        from test_torch_parakeet import pair

        _, m = pair("tdt")
        audio = np.random.RandomState(0).randn(48000).astype(np.float32) * 0.1
        calls = []
        out = m.generate(audio, chunk_duration=1.5, overlap_duration=0.5,
                         chunk_callback=lambda cur, tot: calls.append(
                             (cur, tot)))
        assert isinstance(out.text, str)
        assert calls and calls[-1][0] == calls[-1][1] == 48000
        for seg in out.segments:
            assert seg["end"] >= seg["start"] >= 0


# ------------------------------------------------------- against JAX


def _random_streams(seed):
    """Two windows of a seeded stream that overlap by 0.4-1.0 s, the second
    re-decoding the overlap with a few tokens dropped, changed or shifted,
    and some sentence punctuation."""
    rng = np.random.RandomState(seed)
    pieces = list("abcdefgh") + [" x", " y", ".", "!", "?"]
    n = int(rng.randint(12, 30))
    ids = rng.randint(0, len(pieces), n)
    starts = np.cumsum(rng.uniform(0.04, 0.12, n))
    toks = [(int(i), pieces[i], float(s)) for i, s in zip(ids, starts)]
    cut = float(starts[n // 2])
    overlap = float(rng.uniform(0.4, 1.0))
    a = [(i, p, s) for i, p, s in toks if s < cut + overlap / 2]
    b = []
    for i, p, s in toks:
        if s < cut - overlap / 2:
            continue
        r = rng.rand()
        if r < 0.1:
            continue
        if r < 0.2:
            i = (i + 1) % len(pieces)
            p = pieces[i]
        b.append((i, p, s + float(rng.uniform(-0.02, 0.02))))
    return a, b, overlap


@pytest.mark.parametrize("seed", range(6))
def test_merges_and_sentences_match_jax(seed):
    a, b, overlap = _random_streams(seed)
    mine = [[AlignedToken(i, p, s, 0.04) for i, p, s in w] for w in (a, b)]
    theirs = [[jnemo.AlignedToken(i, p, s, 0.04) for i, p, s in w]
              for w in (a, b)]
    for name in ("merge_longest_contiguous",
                 "merge_longest_common_subsequence"):
        try:
            want = getattr(jnemo, name)(*theirs, overlap_duration=overlap)
        except RuntimeError as e:
            with pytest.raises(RuntimeError, match=str(e)):
                globals()[name](*mine, overlap_duration=overlap)
            continue
        got = globals()[name](*mine, overlap_duration=overlap)
        assert [dataclasses.asdict(t) for t in got] == \
            [dataclasses.asdict(t) for t in want]
        assert dataclasses.asdict(sentences_to_result(
            tokens_to_sentences(got))) == dataclasses.asdict(
            jnemo.sentences_to_result(jnemo.tokens_to_sentences(want)))
