"""The WER eval harness of the PyTorch port against the JAX package, on the
CPU: the cases of tests/test_stt_eval.py (the WER counts and tie-breaks,
the aggregate, the normaliser, the Seed-TTS meta lines, the runner's
artifacts, resuming, the manifest loader, an unsupported metric), each
equal to the JAX package's output on the same input, WER on random token
strings among them; the departure pinned (the Seed-TTS set read from a
local copy, a hub id raising); the CLI on a two-row local manifest with a
tiny Whisper directory.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: E402,F401
from test_stt_eval import _EchoModel  # noqa: E402


def _pkgs():
    import mlx_audio_tpu.stt.eval as jeval
    import mlx_audio_tpu_torch.stt.eval as peval

    return jeval, peval


PAIRS = [("the cat sat", "the cat sat"), ("the cat sat", "the dog sat"),
         ("a b c", "a c"), ("a c", "a b c"), ("", ""), ("", "hello world"),
         ("hello world", ""), ("a", "b"), ("a b a b", "b a b a"),
         ("x y z w", "w z y x v")]


@pytest.mark.parametrize("ref,hyp", PAIRS)
def test_wer_cases_equal_jax(ref, hyp):
    """Counts, rate and the tie-break (substitution over a deletion and an
    insertion) equal JAX's."""
    jeval, peval = _pkgs()
    assert peval.compute_wer(ref, hyp).to_dict() == \
        jeval.compute_wer(ref, hyp).to_dict()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wer_on_random_strings_equals_jax(seed):
    """40 random token strings over a 5-word vocabulary: every count and
    rate, and the aggregate over them, equal JAX's."""
    jeval, peval = _pkgs()
    rng = np.random.RandomState(seed)
    got, want = [], []
    for _ in range(40):
        ref = [str(t) for t in rng.randint(0, 5, rng.randint(0, 12))]
        hyp = [str(t) for t in rng.randint(0, 5, rng.randint(0, 12))]
        got.append(peval.compute_wer(ref, hyp))
        want.append(jeval.compute_wer(" ".join(ref), " ".join(hyp)))
        assert got[-1].to_dict() == want[-1].to_dict()
    assert peval.aggregate_wer(got) == jeval.aggregate_wer(want)


@pytest.mark.parametrize("text", [
    "Hello, World!", "Don’t stop.", "  a \t b\nc ", "", "‘Quoted’ — dash…",
    "It's 5:30 p.m.; O'Brien's (café)", "UPPER lower MiXeD ?!"])
def test_normalize_equals_jax(text):
    jeval, peval = _pkgs()
    assert peval.normalize_for_wer(text) == jeval.normalize_for_wer(text)


@pytest.mark.parametrize("line", [
    "utt1|prompt|p.wav|target text", "u2.wav|p|p.wav|t|en/wavs/custom.wav",
    "  \n", "u3|p|p.wav|t|"])
def test_seed_tts_meta_lines_equal_jax(line):
    jeval, peval = _pkgs()
    assert peval.parse_seed_tts_meta_line(line) == \
        jeval.parse_seed_tts_meta_line(line)


def test_bad_meta_line_raises_as_jax():
    jeval, peval = _pkgs()
    for mod in (jeval, peval):
        with pytest.raises(ValueError, match="pipe-delimited"):
            mod.parse_seed_tts_meta_line("a|b")


def _write_wav(path, seconds=0.5, sr=16000, seed=None):
    from mlx_audio_tpu_torch.audio_io import write

    x = (np.zeros(int(seconds * sr), np.float32) if seed is None else
         (np.random.RandomState(seed).randn(int(seconds * sr)) * 0.1
          ).astype(np.float32))
    write(str(path), x, sr)
    return path


def _samples(pkg, wavs):
    return [pkg.STTEvalSample("u1", wavs / "u1.wav", "the cat sat"),
            pkg.STTEvalSample("u2", wavs / "u2.wav", "hello world")]


TIMED = ("wall_time_sec", "total_wall_time_sec", "rtf")


def _untimed(d):
    return {k: v for k, v in d.items() if k not in TIMED}


def test_runner_artifacts_equal_jax(tmp_path):
    """Both runners on the same canned model and two WAVs: the summary,
    each prediction record and the summary text equal JAX's but for the
    wall times."""
    jeval, peval = _pkgs()
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for u in ("u1", "u2"):
        _write_wav(wavs / f"{u}.wav")
    model = _EchoModel({"u1": "The cat sat!", "u2": "hello word"})
    out = {}
    for name, mod in (("jax", jeval), ("port", peval)):
        d = tmp_path / name
        s = mod.run_stt_wer_eval(model, _samples(mod, wavs), d,
                                 dataset_name="unit-test")
        preds = [_untimed(json.loads(line)) for line in
                 (d / "predictions.jsonl").read_text().splitlines()]
        lines = [ln for ln in (d / "summary.txt").read_text().splitlines()
                 if not ln.startswith("RTF")]
        out[name] = (_untimed(s), preds, lines)
    assert out["port"] == out["jax"]
    assert out["port"][0]["wer_micro"] == pytest.approx(1 / 5)


def test_skip_existing_resumes(tmp_path):
    _, peval = _pkgs()
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for u in ("u1", "u2"):
        _write_wav(wavs / f"{u}.wav")
    samples = [peval.STTEvalSample("u1", wavs / "u1.wav", "a"),
               peval.STTEvalSample("u2", wavs / "u2.wav", "b")]
    out = tmp_path / "out"
    peval.run_stt_wer_eval(_EchoModel({"u1": "a", "u2": "b"}), samples[:1],
                           out, dataset_name="t")

    class Boom:
        def generate(self, audio, language=None):
            from pathlib import Path
            if Path(audio).stem == "u1":
                raise AssertionError("should have been skipped")
            return "b"

    s = peval.run_stt_wer_eval(Boom(), samples, out, dataset_name="t",
                               skip_existing=True)
    assert s["num_samples"] == 2 and s["num_skipped"] == 1
    assert s["wer_micro"] == 0.0


@pytest.mark.parametrize("suffix", [".jsonl", ".tsv", ".csv"])
def test_manifest_loader_equals_jax(tmp_path, suffix):
    """jsonl, tsv and csv manifests with column aliases and an extra
    column: the same samples as JAX's loader gives."""
    jeval, peval = _pkgs()
    _write_wav(tmp_path / "x.wav")
    rows = [{"id": "x", "audio": "x.wav", "text": "hi", "extra": "1"},
            {"utt_id": "y", "path": "x.wav", "transcript": "yo",
             "extra": "2"}]
    man = tmp_path / f"data{suffix}"
    if suffix == ".jsonl":
        man.write_text("".join(json.dumps(r) + "\n" for r in rows))
    else:
        sep = "\t" if suffix == ".tsv" else ","
        man.write_text(f"id{sep}audio{sep}text{sep}extra\n"
                       + "".join(f"{r.get('id', r.get('utt_id'))}{sep}"
                                 f"x.wav{sep}"
                                 f"{r.get('text', r.get('transcript'))}{sep}"
                                 f"{r['extra']}\n" for r in rows))
    got = list(peval.iter_samples_from_manifest(man))
    want = list(jeval.iter_samples_from_manifest(man))
    assert [vars(g) for g in got] == [vars(w) for w in want]
    assert got[0].audio_path == tmp_path / "x.wav"
    assert got[0].metadata == {"extra": "1"}


def test_unsupported_metric_raises(tmp_path):
    _, peval = _pkgs()
    with pytest.raises(ValueError, match="unsupported metric"):
        peval.run_stt_wer_eval(_EchoModel({}), [], tmp_path,
                               dataset_name="t", metrics=["bleu"])


def _seed_tts_copy(root):
    (root / "en" / "wavs").mkdir(parents=True)
    lines = ["u1|p one|p1.wav|the cat sat", "u2.wav|p two|p2.wav|hello world",
             "u3|p|p3.wav|not here"]
    (root / "en" / "meta.lst").write_text("\n".join(lines) + "\n")
    for u in ("u1", "u2"):
        _write_wav(root / "en" / "wavs" / f"{u}.wav")
    return root


def test_seed_tts_from_a_local_copy(tmp_path):
    """The departure: the Seed-TTS set is read from a local copy with the
    hub's layout (the JAX package downloads it): the meta lines parsed as
    JAX parses them, a missing target skipped or raised, `limit` kept; the
    runner scores it."""
    jeval, peval = _pkgs()
    root = _seed_tts_copy(tmp_path / "seed-tts-eval")
    with pytest.raises(FileNotFoundError, match="u3.wav"):
        list(peval.iter_seed_tts_english_samples(str(root)))
    got = list(peval.iter_seed_tts_english_samples(
        str(root), fail_on_missing_audio=False))
    assert [(s.utt_id, s.reference_text, s.source_path) for s in got] == [
        (e["utt_id"], e["target_text"], e["target_wav"]) for e in
        (jeval.parse_seed_tts_meta_line(ln) for ln in
         (root / "en" / "meta.lst").read_text().splitlines()[:2])]
    assert got[0].metadata == {"prompt_text": "p one", "prompt_wav": "p1.wav"}
    assert len(list(peval.iter_seed_tts_english_samples(
        str(root), limit=1))) == 1
    s = peval.run_seed_tts_eval(
        _EchoModel({"u1": "the cat sat", "u2": "hello"}), tmp_path / "out",
        dataset_repo=str(root), fail_on_missing_audio=False)
    assert s["dataset_name"] == "seed-tts" and s["num_samples"] == 2
    assert s["wer_micro"] == pytest.approx(1 / 5)


def test_a_hub_id_raises_without_the_network():
    """A hub id is no local copy: it raises, saying so, before any
    download is tried."""
    _, peval = _pkgs()
    with pytest.raises(FileNotFoundError, match="never downloads"):
        next(peval.iter_seed_tts_english_samples())


def test_loading_defaults_to_the_card(tmp_path):
    """A model given by its directory loads on the card by default: without
    CUDA the runner raises before reading it."""
    _, peval = _pkgs()
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        peval.run_stt_wer_eval(str(tmp_path), [], tmp_path / "o",
                               dataset_name="t")


def test_cli_on_a_local_manifest(tmp_path, capsys):
    """`python -m mlx_audio_tpu_torch.stt.eval --manifest m.jsonl --model
    <tiny Whisper> --device cpu`: two rows transcribed greedily, each
    hypothesis equal to the model's own `generate` of that file, the
    printed summary equal to summary.json and its WER to the records'."""
    import chip_smoke
    from mlx_audio_tpu_torch.stt.eval.__main__ import main
    from mlx_audio_tpu_torch.stt.utils import load_model

    d = tmp_path / "whisper-tiny"
    chip_smoke.write_whisper_checkpoint(chip_smoke.whisper_eval_small("cpu"),
                                        d)
    for u in ("a", "b"):
        _write_wav(tmp_path / f"{u}.wav", seconds=1.0, seed=ord(u))
    man = tmp_path / "m.jsonl"
    man.write_text("".join(json.dumps({"id": u, "audio": f"{u}.wav",
                                       "text": t}) + "\n"
                           for u, t in (("a", "one two"), ("b", "three"))))
    out = tmp_path / "out"
    kw = {"temperature": 0.0, "return_timestamps": False}
    main(["--manifest", str(man), "--model", str(d), "--output-dir",
          str(out), "--device", "cpu", "--gen-kwargs", json.dumps(kw)])
    summary = json.loads(capsys.readouterr().out)
    assert summary == json.loads((out / "summary.json").read_text())
    recs = [json.loads(line) for line in
            (out / "predictions.jsonl").read_text().splitlines()]
    m = load_model(d, device="cpu")
    for r in recs:
        want = m.generate(r["audio_path"], **kw).text.strip()
        assert r["hypothesis"] == want
    assert summary["num_samples"] == 2 and summary["model"] == str(d)
    edits = sum(r["edits"] for r in recs)
    assert summary["wer_micro"] == pytest.approx(edits / 3)
