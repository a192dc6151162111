"""NeMo-style token alignment (counterpart of mlx_audio_tpu/stt/models/nemo):
the containers and the two overlap merges that Parakeet's long-file path
stitches its windows with. Host numpy only."""

from .alignment import (
    AlignedResult,
    AlignedSentence,
    AlignedToken,
    merge_longest_common_subsequence,
    merge_longest_contiguous,
    sentences_to_result,
    tokens_to_sentences,
)

__all__ = [
    "AlignedToken",
    "AlignedSentence",
    "AlignedResult",
    "tokens_to_sentences",
    "sentences_to_result",
    "merge_longest_contiguous",
    "merge_longest_common_subsequence",
]
