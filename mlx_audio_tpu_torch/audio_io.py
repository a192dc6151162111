"""Audio file I/O with zero hard dependencies.

The port's own copy of mlx_audio_tpu/audio_io.py (all but its soundfile
shims `sf_read` / `sf_write`), kept equal to it (the port imports nothing
of the JAX package): a native RIFF/WAVE codec (PCM
8/16/24/32-bit and IEEE float32/64, vectorized numpy), and an ffmpeg
subprocess only for compressed formats (mp3/flac/ogg/opus/m4a/webm) when
the binary exists.
"""

from __future__ import annotations

import io
import shutil
import struct
import subprocess
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

__all__ = ["read", "write", "detect_format"]

_FFMPEG_FORMATS = {"mp3", "flac", "ogg", "opus", "vorbis", "m4a", "aac", "webm", "mp4"}


def detect_format(data: bytes) -> str:
    """Detect audio format from leading bytes (reference audio_io.py:37-55)."""
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return "wav"
    if data[:3] == b"ID3" or data[0:2] in (b"\xff\xfb", b"\xff\xfa", b"\xff\xf3", b"\xff\xf2"):
        return "mp3"
    if data[:4] == b"fLaC":
        return "flac"
    if data[:4] == b"OggS":
        return "vorbis"
    if data[4:8] == b"ftyp":
        return "m4a"
    if data[:4] == b"\x1a\x45\xdf\xa3":
        return "webm"
    raise ValueError("Unable to detect audio format from bytes")


# ---------------------------------------------------------------------------
# Native WAV codec
# ---------------------------------------------------------------------------


def _decode_wav(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode RIFF/WAVE bytes -> (float64 array (samples,) or (samples, ch), rate)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("Not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    n = len(data)
    while pos + 8 <= n:
        chunk_id = data[pos : pos + 4]
        (chunk_size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + chunk_size]
        if chunk_id == b"fmt ":
            audio_format, nch, rate, _, block_align, bits = struct.unpack(
                "<HHIIHH", body[:16]
            )
            if audio_format == 0xFFFE and chunk_size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                (audio_format,) = struct.unpack("<H", body[24:26])
            fmt = (audio_format, nch, rate, block_align, bits)
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_size + (chunk_size & 1)
        if fmt is not None and raw is not None:
            break
    if fmt is None or raw is None:
        raise ValueError("Malformed WAV: missing fmt/data chunk")

    audio_format, nch, rate, _, bits = fmt
    if audio_format == 1:  # PCM
        if bits == 8:
            x = (raw_arr(raw, np.uint8).astype(np.float64) - 128.0) / 128.0
        elif bits == 16:
            x = raw_arr(raw, np.int16).astype(np.float64) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            b = b[: (len(b) // 3) * 3].reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals & 0x800000, vals - 0x1000000, vals)
            x = vals.astype(np.float64) / 8388608.0
        elif bits == 32:
            x = raw_arr(raw, np.int32).astype(np.float64) / 2147483648.0
        else:
            raise ValueError(f"Unsupported PCM bit depth: {bits}")
    elif audio_format == 3:  # IEEE float
        dt = np.float32 if bits == 32 else np.float64
        x = raw_arr(raw, dt).astype(np.float64)
    else:
        raise ValueError(f"Unsupported WAV audio format tag: {audio_format}")

    if nch > 1:
        x = x[: (len(x) // nch) * nch].reshape(-1, nch)
    return x, rate


def raw_arr(raw: bytes, dtype) -> np.ndarray:
    item = np.dtype(dtype).itemsize
    usable = (len(raw) // item) * item
    return np.frombuffer(raw[:usable], dtype=dtype)


def _encode_wav(data: np.ndarray, samplerate: int, subtype: str = "int16") -> bytes:
    """Encode (samples,) or (samples, ch) float/-int data as WAV bytes."""
    if data.ndim == 1:
        nch = 1
        flat = data
    else:
        nch = data.shape[1]
        flat = data.reshape(-1)

    if subtype == "float32":
        payload = flat.astype(np.float32).tobytes()
        bits, fmt_tag = 32, 3
    else:
        if flat.dtype in (np.float32, np.float64):
            flat = np.clip(
                np.round(flat * 32768.0), -32768.0, 32767.0
            ).astype(np.int16)
        elif flat.dtype != np.int16:
            flat = flat.astype(np.int16)
        payload = flat.tobytes()
        bits, fmt_tag = 16, 1

    byte_rate = samplerate * nch * bits // 8
    block_align = nch * bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, fmt_tag, nch, samplerate, byte_rate, block_align, bits
    )
    hdr += b"data" + struct.pack("<I", len(payload))
    return hdr + payload


# ---------------------------------------------------------------------------
# ffmpeg fallback (optional)
# ---------------------------------------------------------------------------


def _ffmpeg_path() -> Optional[str]:
    return shutil.which("ffmpeg")


def _decode_ffmpeg(
    input_data: Union[str, Path, bytes],
    sample_rate: Optional[int] = None,
    nchannels: Optional[int] = None,
) -> Tuple[np.ndarray, int, int]:
    ffmpeg = _ffmpeg_path()
    if ffmpeg is None:
        raise RuntimeError(
            "This audio format requires ffmpeg, which is not installed."
        )
    probe_rate = sample_rate or 0
    cmd = [ffmpeg, "-v", "error"]
    if isinstance(input_data, bytes):
        cmd += ["-i", "pipe:0"]
        stdin = input_data
    else:
        cmd += ["-i", str(input_data)]
        stdin = None
    if sample_rate:
        cmd += ["-ar", str(sample_rate)]
    if nchannels:
        cmd += ["-ac", str(nchannels)]
    cmd += ["-f", "f32le", "pipe:1"]
    proc = subprocess.run(cmd, input=stdin, capture_output=True, check=True)
    # Determine actual rate/channels if not forced: re-probe via ffprobe-less
    # trick — request wav header instead when unknown.
    if not sample_rate or not nchannels:
        cmd2 = [ffmpeg, "-v", "error"]
        if isinstance(input_data, bytes):
            cmd2 += ["-i", "pipe:0"]
        else:
            cmd2 += ["-i", str(input_data)]
        cmd2 += ["-f", "wav", "-c:a", "pcm_s16le", "-frames:a", "1", "pipe:1"]
        hdr = subprocess.run(cmd2, input=stdin, capture_output=True, check=True).stdout
        _, nch0, rate0, _, _, _ = struct.unpack("<HHIIHH", hdr[20:36])
        sample_rate = sample_rate or rate0
        nchannels = nchannels or nch0
    x = np.frombuffer(proc.stdout, dtype=np.float32)
    return x, int(sample_rate), int(nchannels)


def _encode_ffmpeg(
    data: np.ndarray, samplerate: int, nchannels: int, fmt: str
) -> bytes:
    ffmpeg = _ffmpeg_path()
    if ffmpeg is None:
        raise RuntimeError(f"Writing format '{fmt}' requires ffmpeg (not installed).")
    codec = {
        "mp3": ["-f", "mp3"],
        "flac": ["-f", "flac"],
        "ogg": ["-f", "ogg", "-c:a", "libvorbis"],
        "vorbis": ["-f", "ogg", "-c:a", "libvorbis"],
        "opus": ["-f", "ogg", "-c:a", "libopus"],
        "webm": ["-f", "webm", "-c:a", "libopus"],
        "m4a": ["-f", "ipod", "-c:a", "aac"],
        "aac": ["-f", "adts", "-c:a", "aac"],
    }[fmt]
    cmd = [
        ffmpeg, "-v", "error",
        "-f", "f32le", "-ar", str(samplerate), "-ac", str(nchannels), "-i", "pipe:0",
        *codec, "pipe:1",
    ]
    proc = subprocess.run(
        cmd, input=data.astype(np.float32).tobytes(), capture_output=True, check=True
    )
    return proc.stdout


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _convert_channels(x: np.ndarray, nchannels: Optional[int]) -> np.ndarray:
    if nchannels is None:
        return x
    cur = 1 if x.ndim == 1 else x.shape[1]
    if cur == nchannels:
        return x
    if nchannels == 1:
        return x.mean(axis=1) if x.ndim == 2 else x
    if cur == 1:
        mono = x if x.ndim == 1 else x[:, 0]
        return np.tile(mono[:, None], (1, nchannels))
    raise ValueError(f"Cannot convert {cur} channels to {nchannels}")


def _resample_linear(x: np.ndarray, src: int, dst: int) -> np.ndarray:
    """Cheap linear resample used only inside read() rate coercion.

    Model paths use `mlx_audio_tpu_torch.utils.resample_audio` (polyphase) instead.
    """
    if src == dst:
        return x
    n_out = int(round(x.shape[0] * dst / src))
    t = np.linspace(0, x.shape[0] - 1, n_out)
    if x.ndim == 1:
        return np.interp(t, np.arange(x.shape[0]), x)
    return np.stack(
        [np.interp(t, np.arange(x.shape[0]), x[:, c]) for c in range(x.shape[1])],
        axis=1,
    )


def read(
    file: Union[str, Path, io.BytesIO],
    always_2d: bool = False,
    dtype: str = "float64",
    sample_rate: Optional[int] = None,
    nchannels: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """Read an audio file. Native WAV path; ffmpeg fallback for compressed.

    Returns (audio, sample_rate); audio is (samples,) mono or (samples, ch).
    Parity with reference audio_io.read (audio_io.py:188-301).
    """
    if sample_rate is not None and sample_rate <= 0:
        raise ValueError(f"sample_rate must be positive, got {sample_rate}")
    if nchannels is not None and nchannels <= 0:
        raise ValueError(f"nchannels must be positive, got {nchannels}")

    if isinstance(file, io.BytesIO):
        file.seek(0)
        data = file.read()
    else:
        data = Path(file).expanduser().read_bytes()

    fmt = detect_format(data[:16])
    if fmt == "wav":
        x, rate = _decode_wav(data)
        x = _convert_channels(x, nchannels)
        if sample_rate is not None and sample_rate != rate:
            x = _resample_linear(x, rate, sample_rate)
            rate = sample_rate
    else:
        x, rate, nch = _decode_ffmpeg(data, sample_rate=sample_rate, nchannels=nchannels)
        if nch > 1:
            x = x.reshape(-1, nch)

    if always_2d and x.ndim == 1:
        x = x[:, None]
    if dtype == "float32":
        x = x.astype(np.float32)
    elif dtype == "float64":
        x = x.astype(np.float64)
    elif dtype == "int16":
        if np.issubdtype(x.dtype, np.floating):
            x = np.clip(np.round(x * 32768.0), -32768.0, 32767.0).astype(np.int16)
    else:
        raise ValueError(f"Unsupported dtype: {dtype}")
    return x, rate


def write(
    file: Union[str, Path, io.BytesIO],
    data: np.ndarray,
    samplerate: int,
    format: Optional[str] = None,
) -> None:
    """Write audio to file. Native WAV; ffmpeg for compressed formats.

    Parity with reference audio_io.write (audio_io.py:418-534).
    """
    if format is None:
        if isinstance(file, (str, Path)):
            format = Path(file).suffix.lstrip(".").lower() or "wav"
        else:
            format = "wav"
    format = format.lower()

    if not isinstance(data, np.ndarray):
        data = np.asarray(data)
    if data.dtype not in (np.float32, np.float64, np.int16):
        data = np.asarray(data, dtype=np.float32)

    nch = 1 if data.ndim == 1 else data.shape[1]
    if format == "wav":
        payload = _encode_wav(data, samplerate)
    elif format in _FFMPEG_FORMATS:
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        payload = _encode_ffmpeg(np.asarray(data), samplerate, nch, format)
    else:
        raise ValueError(f"Unsupported output format: {format}")

    if isinstance(file, io.BytesIO):
        file.write(payload)
    else:
        Path(file).expanduser().write_bytes(payload)
