"""WER eval loop: transcribe samples, score, write predictions + summary.

The port's copy of mlx_audio_tpu/stt/eval/runner.py; a model given by its
directory loads through the port's STT loader on `device` (the card by
default; without CUDA it raises unless given "cpu"). Parity: reference mlx_audio/stt/eval/runner.py:29 (run_stt_wer_eval) /
:162 (run_seed_tts_eval). Same on-disk artifacts — predictions.jsonl (one
record per utterance with raw + normalized texts and op counts),
summary.json, summary.txt — and the same resumability via --skip-existing.
Progress goes to stderr without a tqdm dependency.
"""

from __future__ import annotations

import inspect
import json
import sys
import time
import wave
from pathlib import Path
from typing import Any, Dict, Iterable, Optional, Union

from .manifest import iter_seed_tts_english_samples
from .normalize import normalize_for_wer
from .schema import STTEvalSample
from .wer import WERResult, aggregate_wer, compute_wer

SUPPORTED_METRICS = ("wer",)


def run_stt_wer_eval(model: Any, samples: Iterable[STTEvalSample],
                     output_dir: Union[str, Path], *,
                     dataset_name: str,
                     dataset_revision: Optional[str] = None,
                     dataset_split: Optional[str] = None,
                     summary_metadata: Optional[Dict[str, Any]] = None,
                     limit: Optional[int] = None,
                     language: Optional[str] = None,
                     gen_kwargs: Optional[Dict[str, Any]] = None,
                     skip_existing: bool = False,
                     metrics: Optional[Iterable[str]] = None,
                     verbose: bool = False,
                     device: str = "cuda") -> Dict[str, Any]:
    metrics = _validate_metrics(metrics)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    pred_path = out / "predictions.jsonl"

    model_id = model if isinstance(model, str) else type(model).__name__
    if isinstance(model, str):
        from ..utils import load_model
        model = load_model(model, device=device)
    existing = _read_predictions(pred_path) if skip_existing else {}

    records, wers = [], []
    skipped = 0
    wall_total = 0.0
    mode = "a" if skip_existing else "w"
    with open(pred_path, mode, encoding="utf-8") as pf:
        for i, sample in enumerate(samples):
            if limit is not None and i >= limit:
                break
            if sample.utt_id in existing:
                rec = existing[sample.utt_id]
                records.append(rec)
                wers.append(_wer_from_record(rec))
                wall_total += float(rec.get("wall_time_sec") or 0.0)
                skipped += 1
                continue
            t0 = time.perf_counter()
            hyp = _transcribe(model, sample.audio_path, language,
                              gen_kwargs or {}, verbose)
            wall = time.perf_counter() - t0
            wall_total += wall

            ref_n = normalize_for_wer(sample.reference_text)
            hyp_n = normalize_for_wer(hyp)
            w = compute_wer(ref_n, hyp_n)
            wers.append(w)
            rec = {"utt_id": sample.utt_id,
                   "audio_path": str(sample.audio_path),
                   "source_path": sample.source_path,
                   "reference": sample.reference_text, "hypothesis": hyp,
                   "reference_normalized": ref_n,
                   "hypothesis_normalized": hyp_n, **w.to_dict(),
                   "wall_time_sec": wall,
                   "audio_duration_sec": _wav_seconds(sample.audio_path),
                   "metadata": dict(sample.metadata)}
            records.append(rec)
            pf.write(json.dumps(rec, ensure_ascii=False) + "\n")
            pf.flush()
            print(f"\r[stt-eval] {len(records)} utts "
                  f"wer_micro={aggregate_wer(wers)['wer_micro']:.3f}",
                  end="", file=sys.stderr)
    print(file=sys.stderr)

    if not records:
        raise RuntimeError("no samples were evaluated")
    if all(not r.get("hypothesis_normalized") for r in records):
        raise RuntimeError("all model hypotheses were empty")

    agg = aggregate_wer(wers)
    audio_total = sum(float(r["audio_duration_sec"]) for r in records
                      if r.get("audio_duration_sec") is not None)
    summary = {"model": str(model_id), "dataset_name": dataset_name,
               "dataset_revision": dataset_revision,
               "dataset_split": dataset_split,
               "num_samples": len(records), "num_skipped": skipped,
               "metrics": metrics, "generation_kwargs": gen_kwargs or {},
               "language": language, **agg,
               "total_wall_time_sec": wall_total,
               "total_audio_duration_sec": audio_total,
               "rtf": wall_total / audio_total if audio_total else None}
    if summary_metadata:
        summary.update(summary_metadata)
    _write_summary(out, summary)
    return summary


def run_seed_tts_eval(model: Any, output_dir: Union[str, Path],
                      dataset_repo: str = "zhaochenyang20/seed-tts-eval",
                      revision: str = "main",
                      limit: Optional[int] = None, **kw) -> Dict[str, Any]:
    out = Path(output_dir)
    samples = iter_seed_tts_english_samples(
        dataset_repo=dataset_repo, revision=revision,
        audio_cache_dir=out / "audio-cache", limit=limit,
        fail_on_missing_audio=kw.pop("fail_on_missing_audio", True))
    return run_stt_wer_eval(
        model, samples, out, dataset_name="seed-tts",
        dataset_revision=revision, dataset_split="en/standard",
        summary_metadata={"dataset_repo": dataset_repo, "locale": "en",
                          "set": "standard"}, limit=limit, **kw)


def _validate_metrics(metrics: Optional[Iterable[str]]) -> list:
    ms = [m.lower() for m in (metrics or ["wer"])]
    bad = sorted(set(ms) - set(SUPPORTED_METRICS))
    if bad:
        raise ValueError(f"unsupported metric(s): {', '.join(bad)}; "
                         f"supported: {', '.join(SUPPORTED_METRICS)}")
    return list(dict.fromkeys(ms))


def _transcribe(model: Any, audio_path: Path, language: Optional[str],
                gen_kwargs: Dict[str, Any], verbose: bool) -> str:
    sig = inspect.signature(model.generate)
    kw = dict(gen_kwargs)
    if language is not None:
        kw["language"] = language
    if "verbose" in sig.parameters:
        kw["verbose"] = verbose
    kw = {k: v for k, v in kw.items() if k in sig.parameters}
    return _extract_text(model.generate(str(audio_path), **kw))


def _extract_text(result: Any) -> str:
    if hasattr(result, "text"):
        return str(result.text).strip()
    if isinstance(result, str):
        return result.strip()
    if isinstance(result, dict) and "text" in result:
        return str(result["text"]).strip()
    if hasattr(result, "__iter__"):
        parts = []
        for item in result:
            if hasattr(item, "text"):
                parts.append(str(item.text))
            elif isinstance(item, dict) and "text" in item:
                parts.append(str(item["text"]))
            else:
                parts.append(str(item))
        return "".join(parts).strip()
    return str(result).strip()


def _read_predictions(path: Path) -> Dict[str, dict]:
    if not path.exists():
        return {}
    recs = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                r = json.loads(line)
                if r.get("utt_id"):
                    recs[str(r["utt_id"])] = r
    return recs


def _wer_from_record(r: dict) -> WERResult:
    return WERResult(substitutions=int(r["substitutions"]),
                     deletions=int(r["deletions"]),
                     insertions=int(r["insertions"]),
                     reference_tokens=int(r["reference_tokens"]),
                     hypothesis_tokens=int(r["hypothesis_tokens"]),
                     wer=float(r["wer"]))


def _wav_seconds(path: Path) -> Optional[float]:
    try:
        with wave.open(str(path), "rb") as w:
            sr = w.getframerate()
            return w.getnframes() / sr if sr else None
    except Exception:
        return None


def _write_summary(out: Path, s: Dict[str, Any]) -> None:
    (out / "summary.json").write_text(
        json.dumps(s, ensure_ascii=False, indent=2) + "\n", encoding="utf-8")
    lines = [f"Model: {s['model']}"]
    label = s.get("dataset_repo") or s["dataset_name"]
    if s.get("dataset_revision"):
        label = f"{label}@{s['dataset_revision']}"
    lines += [f"Dataset: {label}", f"Samples: {s['num_samples']}",
              f"WER micro: {s['wer_micro'] * 100:.3f}%",
              f"WER macro: {s['wer_macro'] * 100:.3f}%",
              ("Sub/Del/Ins: "
               f"{s['substitution_rate'] * 100:.3f}% / "
               f"{s['deletion_rate'] * 100:.3f}% / "
               f"{s['insertion_rate'] * 100:.3f}%")]
    if s.get("rtf") is not None:
        lines.append(f"RTF: {s['rtf']:.3f}")
    (out / "summary.txt").write_text("\n".join(lines) + "\n",
                                     encoding="utf-8")
