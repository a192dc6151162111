"""Live streaming for Voxtral Realtime.

Counterpart of mlx_audio_tpu/stt/models/voxtral_realtime/streaming.py:
feed()/close() queue raw samples under a lock (the server feeds from
another thread), step() does bounded work and returns StreamingEvents. The
mel is host numpy (copied from the JAX package); the conv stem carries a
2-frame and a 1-frame history; the encoder runs in ENC_CHUNK-frame steps
over per-layer ring caches of RING_CAP slots (`encoder_stream_step`); the
adapter groups every downsample_factor encoder frames; the decoder prefills
once the prompt's frames exist, then decodes up to DEC_BUCKET lockstep
tokens per chunk, with the live, EOS and advance flags on the device and
one read per chunk.

The JAX package shares its jitted programs between sessions at the model
level (`model._stream_fns`) so that a new session does not re-trace them;
eager PyTorch traces nothing, so there is no counterpart. Where the JAX
session copies the conv, encoder and adapter outputs to host numpy, this
one keeps them on the device (their shapes are known on the host), so a
step reads the device only for the decoded tokens.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch

from ....dsp import mel_filters
from ....nn import gelu
from ....ops.kvcache import KVCache, ring_mask, ring_update
from ....ops.rope import rope_cis
from ..base import StreamingEvent
from .voxtral_realtime import (RAW_AUDIO_LENGTH_PER_TOK, SAMPLE_RATE,
                               _num_delay_tokens, decoder_forward,
                               downsample_project, encoder_block, logits,
                               sdpa)

ENC_CHUNK = 64          # conv frames per encoder step
RING_CAP = 1024         # >= sliding_window 750 + ENC_CHUNK
DEC_BUCKET = 16         # most lockstep decode steps per chunk (>= the ~13
                        # adapter frames a 1-s feed produces: one read per
                        # second of audio)


def encoder_stream_step(model, x: torch.Tensor, caches: KVCache,
                        offset: int, n_valid: int) -> torch.Tensor:
    """One streaming-encoder step over (1, ENC_CHUNK, dim) at absolute conv
    frames offset..: each layer writes its k/v into its ring cache (f32)
    and attends in f32 through the sliding window; the frames past
    `n_valid` are padding, excluded by the ring mask's write count."""
    e = model.config.encoder_args
    t = x.shape[1]
    cap = caches.k.shape[2]
    mask = ring_mask(cap, e.sliding_window, offset, n_valid, t, x.device)
    cis = rope_cis(torch.arange(offset, offset + t, device=x.device),
                   model.enc_inv_freq)
    for i, blk in enumerate(model.encoder.transformer_layers):
        def attend(q, k, v, c=caches.layer(i)):
            ring_update(c, k, v, offset)
            return sdpa(q.float(), c.k, c.v, mask).to(q.dtype)

        x = encoder_block(blk, e, x, cis, attend)
    return model.encoder.transformer_norm(x)


class VoxtralStreamingSession:
    """feed()/close()/step() live transcription.

    step() drains queued audio through mel -> conv -> ring-cached encoder
    -> adapter frames, prefills the decoder once enough frames exist, then
    decodes up to max_decode_tokens lockstep tokens and returns the text
    deltas (and one final event when the turn completes)."""

    @torch.inference_mode()
    def __init__(self, model, *, max_tokens: int = 4096,
                 transcription_delay_ms: Optional[int] = None,
                 max_session_tokens: int = 2048):
        self.model = model
        cfg = model.config
        self.max_tokens = max_tokens
        delay_ms = transcription_delay_ms or cfg.transcription_delay_ms
        self._n_delay = _num_delay_tokens(delay_ms)
        self._n_left = cfg.n_left_pad_tokens
        self._prompt_len = 1 + self._n_left + self._n_delay
        self._cap = max_session_tokens

        e = cfg.encoder_args
        dev, dtype = model.device, model.dtype
        self._ring_cap = max(RING_CAP, e.sliding_window + ENC_CHUNK)
        self._enc_caches = KVCache.init(1, self._ring_cap, e.n_heads,
                                        e.head_dim, dtype=torch.float32,
                                        device=dev, n_layers=e.n_layers)
        self._dec_caches: Optional[KVCache] = None
        self._ffn_w = model.ffn_norm_weights(self._n_delay)

        # host stream state
        self._audio_q: List[np.ndarray] = []
        self._lock = threading.Lock()
        self._closed = False
        self._flushed = False
        self._raw = np.zeros(0, np.float32)       # unconsumed samples
        self._mel_hist = np.zeros((0, cfg.audio_encoding_args
                                   .num_mel_bins), np.float32)
        self._mel_lead = 0
        self._seeded = False
        # device stream state (host-known shapes)
        self._mel_hist2 = torch.zeros(
            2, cfg.audio_encoding_args.num_mel_bins, dtype=dtype, device=dev)
        self._y1_hist1 = torch.zeros(1, e.dim, dtype=dtype, device=dev)
        self._conv_buf = torch.zeros(0, e.dim, dtype=dtype, device=dev)
        self._enc_buf = torch.zeros(0, e.dim, dtype=dtype, device=dev)
        self._enc_off = 0                          # conv frames encoded
        self._adapter: List[torch.Tensor] = []
        self._n_adapter = 0
        # decoder state
        self._prefilled = False
        self._pos = self._prompt_len
        self._next_tok: Optional[torch.Tensor] = None   # (1,) on the device
        self.generated: List[int] = []
        self._prev_text = ""
        self._done = False

    # -------------------------------------------------------- public

    @property
    def input_sample_rate(self) -> int:
        """The rate feed() expects."""
        return SAMPLE_RATE

    @property
    def done(self) -> bool:
        return self._done

    @property
    def text(self) -> str:
        """Committed transcript so far."""
        return self._prev_text

    def feed(self, samples: np.ndarray) -> None:
        if samples is None:
            return
        samples = np.asarray(samples, np.float32).reshape(-1)
        if samples.size == 0:
            return
        with self._lock:
            self._audio_q.append(samples)

    def close(self) -> None:
        with self._lock:
            self._closed = True

    @torch.inference_mode()
    def step(self, *, max_decode_tokens: int = 4) -> List[StreamingEvent]:
        """Bounded work; returns delta events, plus one final event when
        the turn completes."""
        if self._done:
            return []
        self._ingest()
        events: List[StreamingEvent] = []
        if not self._prefilled:
            if self._n_adapter < self._prompt_len:
                if self._flushed:
                    self._done = True
                    events.append(StreamingEvent("final", self._prev_text))
                return events
            self._prefill()
        events.extend(StreamingEvent("delta", d)
                      for d in self._decode_some(max_decode_tokens))
        if self._done:
            events.append(StreamingEvent("final", self._prev_text))
        return events

    # --------------------------------------------------------- audio

    def _ingest(self) -> None:
        if not self._seeded:
            # the stream starts with the left pad; the offline reflect pad
            # is zeros because the pad is silence
            self._raw = np.zeros(200 + self._n_left
                                 * RAW_AUDIO_LENGTH_PER_TOK, np.float32)
            self._seeded = True
        while True:
            with self._lock:
                if not self._audio_q:
                    closed = self._closed
                    break
                chunk = self._audio_q.pop(0)
            self._raw = np.concatenate([self._raw, chunk])
        self._emit_mel(final=False)
        if closed and not self._flushed:
            self._flushed = True
            n_right = (self._n_delay + 1) + 10
            fed = len(self._raw) - 200 + self._mel_lead
            align = (RAW_AUDIO_LENGTH_PER_TOK
                     - fed % RAW_AUDIO_LENGTH_PER_TOK) \
                % RAW_AUDIO_LENGTH_PER_TOK
            self._raw = np.concatenate([
                self._raw,
                np.zeros(align + n_right * RAW_AUDIO_LENGTH_PER_TOK + 200,
                         np.float32)])
            self._emit_mel(final=True)
        self._run_encoder(flush=self._flushed)

    def _emit_mel(self, final: bool) -> None:
        """Turn buffered raw samples into mel frames (hop 160, window 400),
        in host numpy as the JAX package does. self._raw always begins at
        the window start of the next frame to emit; each frame consumes one
        hop."""
        n_frames = max(0, (len(self._raw) - 240) // 160)  # full windows
        if final:
            # offline drops the trailing centred frame: emit one fewer
            n_frames = max(0, n_frames - 1)
        if n_frames == 0:
            return
        seg = self._raw[: (n_frames - 1) * 160 + 400]
        if len(seg) < (n_frames - 1) * 160 + 400:
            seg = np.pad(seg, (0, (n_frames - 1) * 160 + 400 - len(seg)))
        frames = np.lib.stride_tricks.sliding_window_view(
            seg, 400)[:: 160][:n_frames]
        nwin = np.arange(400, dtype=np.float32)
        win = 0.5 * (1 - np.cos(2 * np.pi * nwin / 400))
        spec = np.fft.rfft(frames * win, axis=-1)
        power = np.abs(spec) ** 2
        aec = self.model.config.audio_encoding_args
        fb = mel_filters(aec.sampling_rate, 400, aec.num_mel_bins, f_min=0,
                         f_max=8000, norm="slaney",
                         mel_scale="slaney").numpy()
        mel = power @ fb.T
        log = np.log10(np.maximum(mel, 1e-10))
        log = np.maximum(log, aec.global_log_mel_max - 8.0)
        mel = ((log + 4.0) / 4.0).astype(np.float32)
        self._raw = self._raw[n_frames * 160:]
        self._mel_lead += n_frames * 160
        self._mel_hist = np.concatenate([self._mel_hist, mel])
        # feed the conv stem even frame counts (stride-2 parity)
        usable = (self._mel_hist.shape[0] // 2) * 2
        if usable == 0:
            return
        seg = self._mel_hist[:usable]
        self._mel_hist = self._mel_hist[usable:]
        self._conv_step(seg)

    def _conv_step(self, mel: np.ndarray) -> None:
        """Causal conv stem over an even chunk of new mel frames. conv1
        (k3 s1, left pad 2) needs the previous 2 mel frames, conv2 (k3 s2,
        left pad 1) the previous conv1 frame; both start as zeros, which
        are the offline zero pads, so streamed equals offline."""
        enc = self.model.encoder
        m = torch.from_numpy(mel).to(self._mel_hist2.device,
                                     self._mel_hist2.dtype)
        x = torch.cat([self._mel_hist2, m])[None]
        y1 = gelu(enc.conv_layers_0_conv.conv(x))[0]
        z = torch.cat([self._y1_hist1, y1])[None]
        y2 = gelu(enc.conv_layers_1_conv.conv(z, stride=2))[0]
        self._mel_hist2 = x[0, -2:]
        self._y1_hist1 = y1[-1:]
        self._conv_buf = torch.cat([self._conv_buf, y2])

    def _run_encoder(self, flush: bool) -> None:
        model = self.model
        e = model.config.encoder_args
        while self._conv_buf.shape[0] >= ENC_CHUNK or \
                (flush and self._conv_buf.shape[0] > 0):
            n = min(ENC_CHUNK, self._conv_buf.shape[0])
            chunk = self._conv_buf[:n]
            self._conv_buf = self._conv_buf[n:]
            padded = torch.nn.functional.pad(chunk, (0, 0, 0, ENC_CHUNK - n))
            out = encoder_stream_step(model, padded[None], self._enc_caches,
                                      self._enc_off, n)
            self._enc_off += n
            self._enc_buf = torch.cat([self._enc_buf, out[0, :n]])
            usable = (self._enc_buf.shape[0]
                      // e.downsample_factor) * e.downsample_factor
            if usable:
                grp = self._enc_buf[:usable]
                self._enc_buf = self._enc_buf[usable:]
                ad = downsample_project(model.encoder, e, grp[None])[0]
                self._adapter.append(ad)
                self._n_adapter += ad.shape[0]
            if flush and self._conv_buf.shape[0] == 0:
                break

    # -------------------------------------------------------- decoder

    def _adapter_cat(self) -> torch.Tensor:
        if len(self._adapter) > 1:
            self._adapter = [torch.cat(self._adapter)]
        return self._adapter[0]

    def _prefill(self) -> None:
        model = self.model
        self._dec_caches = model.decoder_caches(self._cap)
        prefix = self._adapter_cat()[:self._prompt_len] \
            + model.token_embeddings(model.prompt_ids(self._prompt_len))
        h = decoder_forward(model, prefix[None], self._ffn_w,
                            self._dec_caches, 0)
        self._next_tok = logits(model, h[0, -1:]).argmax(-1)
        self._prefilled = True

    def _decode_some(self, max_decode_tokens: int) -> List[str]:
        """Decode up to max_decode_tokens lockstep tokens in chunks of at
        most DEC_BUCKET. k, the live steps of a chunk, is known on the host
        from the adapter frames, so exactly k steps run; only EOS depends
        on the data, and it is masked on the device: an emitted token is
        the carried one while live, -1 after EOS, and the carried token
        advances only on a live non-EOS step. One read per chunk."""
        model = self.model
        eos = model.config.eos_token_id
        deltas: List[str] = []

        def emit_text() -> None:
            text = model._tokenizer.decode(
                [t for t in self.generated if t != eos])
            if len(text) > len(self._prev_text):
                deltas.append(text[len(self._prev_text):])
                self._prev_text = text

        budget = max_decode_tokens
        while budget > 0 and not self._done:
            if self._n_adapter <= self._pos and not self._flushed:
                break                      # pause until more audio arrives
            k = min(budget, DEC_BUCKET, self._n_adapter - self._pos,
                    self.max_tokens - len(self.generated),
                    (self._cap - 1) - self._pos)
            if k <= 0:
                # flushed tail, session cap or token budget: emit the
                # pending token, and the turn is over
                self.generated.append(int(self._next_tok.item()))
                emit_text()
                self._done = True
                break
            adapter = self._adapter_cat()
            tok = self._next_tok
            eos_seen = torch.zeros(1, dtype=torch.bool, device=tok.device)
            emits = []
            for i in range(k):
                live = ~eos_seen
                emits.append(torch.where(live, tok, -1))
                is_eos = tok == eos
                eos_seen = eos_seen | (live & is_eos)
                embed = adapter[self._pos + i] + model.token_embeddings(tok)
                h = decoder_forward(model, embed[None], self._ffn_w,
                                    self._dec_caches, self._pos + i)
                nxt = logits(model, h[0]).argmax(-1)
                tok = torch.where(live & ~is_eos, nxt, tok)
            out = torch.cat(emits + [tok]).tolist()   # the chunk's one read
            emitted = [t for t in out[:k] if t != -1]
            self.generated.extend(emitted)
            emit_text()
            if emitted and emitted[-1] == eos:
                self._pos += len(emitted) - 1      # the EOS step's KV is moot
                self._done = True
                break
            self._pos += k
            self._next_tok = tok
            budget -= k
            if len(self.generated) >= self.max_tokens:
                self._done = True
        return deltas


__all__ = ["VoxtralStreamingSession", "StreamingEvent",
           "encoder_stream_step", "ENC_CHUNK", "DEC_BUCKET", "RING_CAP"]
