"""Eval samples from local manifests (jsonl/tsv) or mapping rows.

The port's copy of mlx_audio_tpu/stt/eval/manifest.py (reference
mlx_audio/stt/eval/standard.py's column aliases, and the Seed-TTS English
eval set's `meta.lst` parser).

Departure: `iter_seed_tts_english_samples` reads a local copy of the
Seed-TTS eval set with the hub's layout (`en/meta.lst`, `en/wavs/`) from
a directory, and raises with that message when given a hub id; the JAX
package's (:112-154) downloads each file with huggingface_hub. The port
never downloads.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Any, Iterable, Iterator, Mapping, Optional, Union

from .schema import STTEvalSample

ID_COLUMNS = ("utt_id", "id", "sample_id")
AUDIO_COLUMNS = ("audio_path", "path", "audio")
REFERENCE_COLUMNS = ("reference_text", "text", "transcript")


def _first(row: Mapping[str, Any], cols: tuple) -> Any:
    for c in cols:
        if c in row:
            return row[c]
    return None


def sample_from_row(row: Mapping[str, Any], *,
                    base_dir: Optional[Union[str, Path]] = None
                    ) -> STTEvalSample:
    utt_id = _first(row, ID_COLUMNS)
    audio = _first(row, AUDIO_COLUMNS)
    ref = _first(row, REFERENCE_COLUMNS)
    if isinstance(audio, Mapping):
        audio = audio.get("path")
    if not utt_id:
        raise ValueError(f"row missing an ID column {ID_COLUMNS}")
    if not audio:
        raise ValueError(f"row missing an audio column {AUDIO_COLUMNS}")
    if ref is None:
        raise ValueError(f"row missing a reference column {REFERENCE_COLUMNS}")
    path = Path(str(audio))
    if base_dir is not None and not path.is_absolute():
        path = Path(base_dir) / path
    skip = {*ID_COLUMNS, *AUDIO_COLUMNS, *REFERENCE_COLUMNS}
    return STTEvalSample(
        utt_id=str(utt_id), audio_path=path, reference_text=str(ref),
        source_path=str(audio),
        metadata={k: v for k, v in row.items() if k not in skip})


def iter_samples_from_rows(rows: Iterable[Mapping[str, Any]], *,
                           base_dir: Optional[Union[str, Path]] = None
                           ) -> Iterator[STTEvalSample]:
    for row in rows:
        yield sample_from_row(row, base_dir=base_dir)


def iter_samples_from_manifest(path: Union[str, Path], *,
                               base_dir: Optional[Union[str, Path]] = None
                               ) -> Iterator[STTEvalSample]:
    """jsonl (one object/line) or tsv/csv (header row) manifest on disk.
    Audio paths resolve relative to `base_dir` (default: manifest's dir)."""
    path = Path(path)
    if base_dir is None:
        base_dir = path.parent
    suffix = path.suffix.lower()
    if suffix in (".jsonl", ".json"):
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    yield sample_from_row(json.loads(line), base_dir=base_dir)
    elif suffix in (".tsv", ".csv"):
        delim = "\t" if suffix == ".tsv" else ","
        with open(path, encoding="utf-8", newline="") as f:
            for row in csv.DictReader(f, delimiter=delim):
                yield sample_from_row(row, base_dir=base_dir)
    else:
        raise ValueError(f"unsupported manifest format: {path}")


# ---------------------------------------------------------------- seed-tts

DEFAULT_DATASET_REPO = "zhaochenyang20/seed-tts-eval"
EN_META_FILE = "en/meta.lst"
EN_TARGET_PREFIX = "en/wavs/"


def parse_seed_tts_meta_line(line: str) -> Optional[dict]:
    """One `utt|prompt_text|prompt_wav|target_text[|target_wav]` record
    (reference seed_tts.py parse_seed_tts_meta_line)."""
    line = line.strip()
    if not line:
        return None
    parts = line.split("|")
    if len(parts) not in (4, 5):
        raise ValueError(f"expected 4/5 pipe-delimited fields: {line!r}")
    utt_id = parts[0]
    if utt_id.endswith(".wav"):
        utt_id = utt_id[:-4]
    target_wav = parts[4] if len(parts) == 5 and parts[4] else \
        f"{EN_TARGET_PREFIX}{utt_id}.wav"
    return {"utt_id": utt_id, "prompt_text": parts[1],
            "prompt_wav": parts[2], "target_text": parts[3],
            "target_wav": target_wav}


def iter_seed_tts_english_samples(dataset_repo: str = DEFAULT_DATASET_REPO,
                                  revision: str = "main",
                                  audio_cache_dir: Optional[Union[str, Path]]
                                  = None,
                                  limit: Optional[int] = None,
                                  fail_on_missing_audio: bool = True
                                  ) -> Iterator[STTEvalSample]:
    """The Seed-TTS English eval set from a local copy: `dataset_repo` is
    a directory holding `en/meta.lst` and the target WAVs under
    `en/wavs/`. A hub id raises (the port never downloads); `revision` and
    `audio_cache_dir` are the JAX signature's and unused. A target WAV
    that is missing raises, or is skipped with `fail_on_missing_audio`
    False."""
    root = Path(dataset_repo).expanduser()
    meta = root / EN_META_FILE
    if not meta.is_file():
        raise FileNotFoundError(
            f"{dataset_repo!r} is not a local copy of the Seed-TTS eval set "
            f"({meta} not found): the port never downloads; copy the "
            f"dataset's en/meta.lst and en/wavs/ into a directory and pass "
            f"it, or use iter_samples_from_manifest with a local manifest")
    count = 0
    with open(meta, encoding="utf-8") as f:
        for line in f:
            entry = parse_seed_tts_meta_line(line)
            if entry is None or not entry["target_wav"].startswith(
                    EN_TARGET_PREFIX):
                continue
            if limit is not None and count >= limit:
                return
            wav = root / entry["target_wav"]
            if not wav.is_file():
                if fail_on_missing_audio:
                    raise FileNotFoundError(f"Seed-TTS target {wav} not "
                                            f"found")
                continue
            count += 1
            yield STTEvalSample(
                utt_id=entry["utt_id"], audio_path=wav,
                reference_text=entry["target_text"],
                source_path=entry["target_wav"],
                metadata={"prompt_text": entry["prompt_text"],
                          "prompt_wav": entry["prompt_wav"]})
