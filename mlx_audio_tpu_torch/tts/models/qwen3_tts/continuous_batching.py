"""Continuous batching for Qwen3-TTS serving: a fixed-slot session.

Counterpart of mlx_audio_tpu/tts/models/qwen3_tts/continuous_batching.py
(`Qwen3TTSBatchSession`). The session owns `max_batch_size` fixed slots over
one shared timeline: every slot writes its talker KV at the same global
column `t` of one stacked buffer (L, B, cache_len, H, D), a per-row validity
mask says which columns each row attends to, and RoPE rotates each row at
its own length `row_len`. Admission splices a batched prompt prefill into
the slots' rows (each at its own timeline offset, `ops.kvcache.kv_update_row`);
retirement clears the slot's mask. A step runs one k-frame chunk for every
slot with static shapes and no read of a device value inside it, then reads
the packed (k, B, G+1) codes and finished flags once, and decodes the
slots' pending frames through at most two row-masked batched streaming
codec steps (per-row stream offsets).

Departures from the JAX session (ROADMAP.md section 3):
* the codec's stream KV buffer holds STREAM_CACHE_LEN frames; a session
  whose streams could outrun it (max_tokens + 2 * frames_per_step > 4096)
  raises ValueError instead of corrupting late audio;
* sampling draws from one torch.Generator per session, which
  `reset_timeline` does not reseed, so a reused warm session does not
  repeat the random draws of its earlier bursts (the JAX session folds its
  key with the timeline step, which `reset_timeline` sets back to 0);
* a first frame whose code 0 is EOS is not decoded (the JAX session feeds
  it to the codec, whose codebooks it indexes past).
`shard_for_mesh` (multi-device) is not ported.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ....ops.kvcache import kv_update_row
from ....ops.sampling import apply_repetition_penalty, sample
from ...continuous import TTSBatchEvent, TTSBatchItem, TTSBatchOptions
from .qwen3_tts import _HostCopy
from .speech_tokenizer import (STREAM_CACHE_LEN, init_stream_state,
                               reset_rows)

MAX_SESSION_STEPS = 4096
HISTORY_LEN = 64
# steps warmup() runs its request for before cancelling it
WARMUP_STEPS = 8


class Qwen3TTSBatchSession:
    """Fixed-slot continuous batch decode for one model instance."""

    @torch.inference_mode()
    def __init__(self, model, options: TTSBatchOptions):
        self.model = model
        self.options = options
        self.B = options.max_batch_size
        tcfg = model.tcfg
        dev = model.device
        self._dtype = model.talker.model.codec_embedding.weight.dtype
        # session timeline capacity: decode attention reads the whole fixed
        # buffer every frame, so it is sized to the deployment's horizon
        self.cache_len = int(options.max_cache_len or MAX_SESSION_STEPS)
        # frames advanced per step(): one read of the device per chunk
        self.frames_per_step = max(
            1, min(int(options.streaming_interval * 12.5) or 8, 25))
        need = options.max_tokens + 2 * self.frames_per_step
        if need > STREAM_CACHE_LEN:
            raise ValueError(
                f"max_tokens={options.max_tokens} with {self.frames_per_step}"
                f" frames per step needs {need} frames of codec stream KV; "
                f"the stream state holds {STREAM_CACHE_LEN}")
        self.caches = model.talker.make_cache(self.B, self.cache_len,
                                              self._dtype, dev)
        d = tcfg.hidden_size
        self.embed = torch.zeros(self.B, 1, d, dtype=self._dtype, device=dev)
        self.valid = torch.zeros(self.B, self.cache_len, dtype=torch.bool,
                                 device=dev)
        self.active = np.zeros(self.B, bool)
        self.finished = torch.ones(self.B, dtype=torch.bool, device=dev)
        self.finished_np = np.ones(self.B, bool)
        self.history = torch.full((self.B, HISTORY_LEN), -1,
                                  dtype=torch.long, device=dev)
        self.generator = torch.Generator(device=dev).manual_seed(0)
        self.t = 0                      # global timeline column
        self.row_len = torch.zeros(self.B, dtype=torch.long, device=dev)
        # per-row trailing text embeds on the device, so the chunk advances
        # each row's next input without the host
        self._tb = 16
        self.trailing = torch.zeros(self.B, self._tb, d, dtype=self._dtype,
                                    device=dev)
        self.t_idx = torch.zeros(self.B, dtype=torch.long, device=dev)
        self.t_len = torch.zeros(self.B, dtype=torch.long, device=dev)
        self.pad_embeds = torch.zeros(self.B, d, dtype=self._dtype,
                                      device=dev)
        self.requests: List[Optional[object]] = [None] * self.B
        self.codes: List[List[np.ndarray]] = [[] for _ in range(self.B)]
        # one batched codec stream state for the whole session, per-row
        # offsets; its KV buffer right-sized to the per-stream frame cap
        codec_cache = min(STREAM_CACHE_LEN, max(128, -(-need // 128) * 128))
        codec_dtype = next(model.speech_tokenizer.parameters()).dtype
        self.codec_state = init_stream_state(
            model.dcfg, batch=self.B, dtype=codec_dtype, device=dev,
            per_row_offset=True, cache_len=codec_cache)
        self.decoded = [0] * self.B
        # admitted rows' first-frame codes awaiting one host read
        self._first_pending: List[tuple] = []
        # (slot, input_embeds, trailing, pad_embed) waiting for admission
        self._admit_queue: List[tuple] = []
        self._suppress = model._suppress_mask()
        self._sample = partial(sample, temperature=options.temperature,
                               top_k=options.top_k, top_p=options.top_p,
                               generator=self.generator)

    # -- protocol ------------------------------------------------------------

    @property
    def idle(self) -> bool:
        return not self.active.any()

    @property
    def available_slots(self) -> int:
        return int((~self.active).sum())

    @torch.inference_mode()
    def submit(self, request) -> None:
        """Reserve a free slot and queue the prompt for admission (the
        prefill runs inside step(), at most admits_per_step per call while
        streams are live)."""
        slot = int(np.argmax(~self.active))
        if self.active[slot]:
            raise RuntimeError("no free continuous-batch slots")
        text = request.payload
        kwargs = request.normalized_kwargs
        input_embeds, trailing, pad_embed = self.model.prepare_inputs(
            text=text if isinstance(text, str) else None,
            text_ids=kwargs.get("text_ids")
            if not isinstance(text, str) else None,
            language=kwargs.get("language", "auto"),
            speaker=kwargs.get("voice") or kwargs.get("speaker"),
            instruct=kwargs.get("instruct"))
        self.requests[slot] = request
        self.codes[slot] = []
        self.decoded[slot] = 0
        self.active[slot] = True
        self._admit_queue.append((slot, input_embeds, trailing, pad_embed))

    def add(self, item: TTSBatchItem) -> None:  # protocol alias
        self.submit(item)

    def warmup(self) -> None:
        """Run one tiny request through the session and reset the timeline:
        the session's buffers and the first calls' set-up are paid before
        the first real burst."""

        class _Req:
            request_id = "__warmup__"
            payload = None
            normalized_kwargs = {"text_ids": np.arange(100, 108)[None]}

            def emit_data(self, *_a, **_k):
                pass

            def emit_done(self, *_a, **_k):
                pass

            def emit_error(self, *_a, **_k):
                pass

        self.submit(_Req())
        for _ in range(WARMUP_STEPS):
            self.step()
            if self.idle:
                break
        if not self.idle:
            self.cancel("__warmup__")
        self.reset_timeline()

    @torch.inference_mode()
    def reset_timeline(self) -> None:
        """Zero the shared timeline of an idle session so its whole
        cache_len is available again (KV at invalid columns is masked).
        The sampling generator runs on."""
        if self.active.any():
            raise RuntimeError("reset_timeline requires an idle session")
        self.t = 0
        self.valid.zero_()
        self.row_len.zero_()

    def cancel(self, request_id: str) -> None:
        for slot, req in enumerate(self.requests):
            if req is not None and getattr(req, "request_id", None) == \
                    request_id:
                self._retire(slot)

    def fail(self, error: BaseException) -> None:
        for slot in range(self.B):
            req = self.requests[slot]
            if req is not None:
                req.emit_error(error)
                req.emit_done()
            self._retire(slot)

    # -- internals -----------------------------------------------------------

    def _admit_many(self, group) -> None:
        """Prefill a group of queued prompts in one batched talker pass and
        splice each row's KV into its slot at its own timeline offset
        (_admit_many, :300-433): the same shared-timeline layout for one
        prompt or many; columns >= t stay invalid until a chunk writes
        them. Then the first frame of every admitted row (batched step 0)."""
        model = self.model
        dev = model.device
        n = len(group)
        slots = [s for s, *_ in group]
        plens = [ie.shape[1] for _, ie, _, _ in group]
        pb = 1 << max(4, (max(plens) - 1).bit_length())
        t0s, t = [], self.t
        for plen in plens:
            if t + pb + 1 + self.frames_per_step > self.cache_len:
                raise RuntimeError(
                    f"session timeline exhausted (t={t}, cap="
                    f"{self.cache_len}): recycle the session or raise "
                    "TTSBatchOptions.max_cache_len")
            t0s.append(t)
            t += plen
        embeds = torch.stack([F.pad(ie[0], (0, 0, 0, pb - ie.shape[1]))
                              for _, ie, _, _ in group]).to(self._dtype)
        tbs = [tr.shape[1] for _, _, tr, _ in group]
        tbb = 1 << max(4, (max(tbs) - 1).bit_length())
        if tbb > self._tb:          # grow the session's trailing buffer
            self.trailing = F.pad(self.trailing, (0, 0, 0, tbb - self._tb))
            self._tb = tbb
        trail = torch.stack([F.pad(tr[0], (0, 0, 0, self._tb - tr.shape[1]))
                             for _, _, tr, _ in group]).to(self._dtype)
        pads = torch.stack([pe.reshape(-1) for *_, pe in group]
                           ).to(self._dtype)
        idx = torch.tensor([slots, plens, tbs], dtype=torch.long, device=dev)
        slots_t, plens_t, tlens_t = idx
        # one batched prefill of the whole group (the weights stream once)
        small = model.talker.make_cache(n, pb, self._dtype, dev)
        pmask = torch.zeros(n, 1, 1, pb, device=dev).masked_fill(
            torch.arange(pb, device=dev) >= plens_t[:, None, None, None],
            float("-inf"))
        logits, hidden = model.talker(embeds, small, 0, lengths_mask=pmask)
        for i, slot in enumerate(slots):
            kv_update_row(self.caches, slot, small.k[:, i], small.v[:, i],
                          t0s[i])
            self.valid[slot, t0s[i]:t0s[i] + plens[i]] = True
        # batched step 0: the first frame of every admitted row
        rows = torch.arange(n, device=dev)
        tok0 = self._sample(logits[rows, plens_t - 1].float()
                            + self._suppress)
        codes, codec_e = model._code_predictor(
            hidden[rows, plens_t - 1][:, None], tok0, self._sample)
        text_e = torch.where((tlens_t > 0)[:, None, None], trail[:, 0:1],
                             pads[:, None])
        self.embed[slots_t] = (text_e + codec_e).to(self._dtype)
        self.finished[slots_t] = tok0 == model.tcfg.codec_eos_token_id
        hist = torch.full((n, HISTORY_LEN), -1, dtype=torch.long, device=dev)
        hist[:, -1] = tok0
        self.history[slots_t] = hist
        self.trailing[slots_t] = trail
        self.t_idx[slots_t] = 1     # step 0 used trailing[0]
        self.t_len[slots_t] = tlens_t
        self.pad_embeds[slots_t] = pads
        self.row_len[slots_t] = plens_t
        reset_rows(self.codec_state, slots_t)   # a fresh codec stream each
        # the first frames are read once, after the next chunk's read
        self._first_pending.append((slots, _HostCopy(codes)))
        for slot in slots:
            self.codes[slot] = []
            self.finished_np[slot] = False
        # the next chunk writes these rows' frame-1 KV at column t, right
        # after the last splice
        self.t = t

    def _chunk(self, k: int) -> torch.Tensor:
        """k frames for every slot (_make_step, :435-516): talker forward
        (write column t, RoPE at row_len, attention over valid | column
        t), code predictor, history, validity and the trailing-text embed
        advance. Static shapes, and nothing read back inside. -> packed
        (k, B, G+1) int64: the codes and each frame's finished flag."""
        model = self.model
        eos = model.tcfg.codec_eos_token_id
        rp = self.options.repetition_penalty
        dev = self.embed.device
        rows = torch.arange(self.B, device=dev)
        embed, finished, history = self.embed, self.finished, self.history
        row_len, t_idx = self.row_len, self.t_idx
        codes_seq, fins = [], []
        for f in range(k):
            t = self.t + f
            attend = self.valid.clone()
            attend[:, t] = True
            logits, hidden = model.talker(embed, self.caches, t,
                                          lengths_mask=attend,
                                          positions=row_len[:, None])
            lg = logits[:, -1].float() + self._suppress
            if rp != 1.0:
                lg = apply_repetition_penalty(lg, history, rp)
            tok0 = self._sample(lg)
            codes, codec_e = model._code_predictor(hidden[:, -1:], tok0,
                                                   self._sample)
            now_fin = finished | (tok0 == eos)
            rolled = torch.cat([history[:, 1:], tok0[:, None]], dim=1)
            history = torch.where(finished[:, None], history, rolled)
            self.valid[:, t] |= ~finished
            text_e = self.trailing[rows, t_idx.clamp(max=self._tb - 1)]
            text_e = torch.where((t_idx < self.t_len)[:, None], text_e,
                                 self.pad_embeds)
            embed = (text_e[:, None] + codec_e).to(self._dtype)
            row_len = row_len + (~finished).long()
            t_idx = t_idx + 1
            finished = now_fin
            codes_seq.append(codes)
            fins.append(now_fin)
        self.embed, self.finished, self.history = embed, finished, history
        self.row_len, self.t_idx = row_len, t_idx
        return torch.cat([torch.stack(codes_seq),
                          torch.stack(fins)[..., None].long()], dim=-1)

    def _materialize_first_codes(self) -> None:
        """Read admitted rows' first-frame codes (one copy per admission
        group) and put them ahead of the rows' chunk codes."""
        eos = self.model.tcfg.codec_eos_token_id
        for slots, copy in self._first_pending:
            (arr,) = copy.read()
            for i, slot in enumerate(slots):
                if self.active[slot] and arr[i, 0] != eos:
                    self.codes[slot].insert(0, arr[i][None])
        self._first_pending = []

    def _decode_batch(self, rows) -> np.ndarray:
        """Decode `rows` = [(slot, n_frames)] (n_frames <= frames_per_step)
        in one row-masked batched streaming step -> (B, k * spf) audio on
        the host. Rows not in `rows` keep their stream state. Short final
        blocks are zero-padded to k: the codec is causal, so the first
        n_frames * spf samples are exact, and the row's state is reset at
        its next admission."""
        model = self.model
        k = self.frames_per_step
        g = model.tcfg.num_code_groups
        blocks = np.zeros((self.B, g, k), np.int64)
        mask = np.zeros((self.B,), bool)
        for slot, nf in rows:
            blk = np.concatenate(self.codes[slot], axis=0)[
                self.decoded[slot]: self.decoded[slot] + nf]
            blocks[slot, :, :nf] = blk.T
            mask[slot] = True
            self.decoded[slot] += nf
        dev = self.embed.device
        self.codec_state, audio = \
            model.speech_tokenizer.decoder.streaming_step(
                self.codec_state, torch.as_tensor(blocks, device=dev),
                torch.as_tensor(mask, device=dev))
        return audio.float().cpu().numpy()

    @torch.inference_mode()
    def step(self) -> List[TTSBatchEvent]:
        """Admission, one k-frame chunk for every slot, then the codec.

        At most options.admits_per_step queued prompts are prefilled first
        while streams are live (a burst with none live is admitted whole),
        then every slot advances k frames."""
        if self.idle:
            return []
        model = self.model
        n_admit = max(1, self.options.admits_per_step)
        if self._admit_queue:
            live = any(self.active[s] and len(self.codes[s]) > 0
                       and not self.finished_np[s] for s in range(self.B))
            take = min(n_admit, len(self._admit_queue)) if live \
                else len(self._admit_queue)
            group = []
            for _ in range(take):
                slot, ie, tr, pe = self._admit_queue.pop(0)
                if not self.active[slot]:  # cancelled while queued
                    continue
                group.append((slot, ie, tr, pe))
            if group:
                self._admit_many(group)
        k_frames = self.frames_per_step
        spf = model.total_upsample
        if self.t + k_frames > self.cache_len:
            return self._flush_exhausted(k_frames, spf)
        packed_np = self._chunk(k_frames).cpu().numpy()   # the one read
        self._materialize_first_codes()
        g = model.tcfg.num_code_groups
        codes_np = packed_np[..., :g]          # (K, B, G)
        fin_traj = packed_np[..., g].astype(bool)
        # finished state at the start of each frame (frame 0 = pre-chunk)
        starts = np.vstack([self.finished_np[None], fin_traj[:-1]])
        prev_fin = self.finished_np
        self.finished_np = fin_traj[-1].copy()
        self.t += k_frames
        events = []
        finals: Dict[int, bool] = {}
        to_finish: List[tuple] = []            # (slot, req)
        full_rows: List[tuple] = []            # (slot, k) regular blocks
        tail_rows: List[tuple] = []            # (slot, nf < k) final tails
        for slot in range(self.B):
            if not self.active[slot]:
                continue
            req = self.requests[slot]
            n_before = sum(c.shape[0] for c in self.codes[slot])
            keep = ~starts[:, slot] & ~fin_traj[:, slot]
            allowed = max(0, self.options.max_tokens - n_before)
            block = codes_np[keep, slot][:allowed]
            if len(block):
                self.codes[slot].append(block)
            n_valid = n_before + len(block)
            newly_fin = fin_traj[-1, slot] and not prev_fin[slot]
            hit_max = n_valid >= self.options.max_tokens
            fin = newly_fin or hit_max
            pend = n_valid - self.decoded[slot]
            if pend >= k_frames:
                full_rows.append((slot, k_frames))
                pend -= k_frames
            if fin and pend > 0:
                tail_rows.append((slot, pend))
            if fin:
                finals[slot] = True
            if hit_max and not fin_traj[-1, slot]:
                self.finished[slot] = True
                self.finished_np[slot] = True
            if fin:
                to_finish.append((slot, req))
        # one batched decode for the regular k-frame blocks, one more for
        # the short tails of the rows that end this step
        chunks: Dict[int, List[np.ndarray]] = {}
        for rows in (full_rows, tail_rows):
            if not rows:
                continue
            audio_np = self._decode_batch(rows)
            for slot, nf in rows:
                chunks.setdefault(slot, []).append(audio_np[slot, :nf * spf])
        for slot, parts in chunks.items():
            req = self.requests[slot]
            audio = parts[0] if len(parts) == 1 else np.concatenate(parts)
            if len(audio) and req is not None:
                req.emit_data({"audio": audio,
                               "sample_rate": model.sample_rate,
                               "is_final": bool(finals.get(slot))})
                events.append(TTSBatchEvent(
                    request_id=getattr(req, "request_id", str(slot)),
                    kind="chunk", audio=audio,
                    sample_rate=model.sample_rate,
                    token_count=self.decoded[slot]))
        # retire finishing slots only after their final audio was emitted
        for slot, req in to_finish:
            self._finish_slot(slot)
            events.append(TTSBatchEvent(
                request_id=getattr(req, "request_id", str(slot))
                if req else str(slot), kind="done"))
        return events

    def _flush_exhausted(self, k_frames: int, spf: int
                         ) -> List[TTSBatchEvent]:
        """The timeline cannot take another chunk: decode every active
        row's pending frames (at most about k + 1 each, in k-frame
        batched passes) and finish them all."""
        model = self.model
        events: List[TTSBatchEvent] = []
        self._materialize_first_codes()
        chunks: Dict[int, List[np.ndarray]] = {}
        while True:
            rows = []
            for slot in range(self.B):
                if not self.active[slot]:
                    continue
                pend = (sum(c.shape[0] for c in self.codes[slot])
                        - self.decoded[slot])
                if pend > 0:
                    rows.append((slot, min(pend, k_frames)))
            if not rows:
                break
            audio_np = self._decode_batch(rows)
            for slot, nf in rows:
                chunks.setdefault(slot, []).append(audio_np[slot, :nf * spf])
        for slot in range(self.B):
            if not self.active[slot]:
                continue
            req = self.requests[slot]
            parts = chunks.get(slot)
            if parts and req is not None:
                req.emit_data({"audio": np.concatenate(parts),
                               "sample_rate": model.sample_rate,
                               "is_final": True})
            self.finished[slot] = True
            self.finished_np[slot] = True
            self._finish_slot(slot)
            events.append(TTSBatchEvent(
                request_id=getattr(req, "request_id", str(slot))
                if req else str(slot), kind="done"))
        return events

    def _finish_slot(self, slot: int) -> None:
        req = self.requests[slot]
        if req is not None:
            req.emit_done()
        self._retire(slot)

    @torch.inference_mode()
    def _retire(self, slot: int) -> None:
        self.active[slot] = False
        self.requests[slot] = None
        self.row_len[slot] = 0
        self.valid[slot] = False
        self.finished[slot] = True
        self.finished_np[slot] = True
        self.t_len[slot] = 0
        self.codes[slot] = []
