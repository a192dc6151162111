"""Qwen3-TTS: autoregressive codec-token TTS (talker + code predictor) with
a 12.5 Hz codec decoder.

Counterpart of mlx_audio_tpu/tts/models/qwen3_tts/qwen3_tts.py, text ids ->
audio:

* `prepare_inputs` from `text_ids` and `_prompt_static` (language "auto",
  an optional `spk_id` speaker; no speaker encoder);
* prefill over the right-padded prompt bucket into a cache sized for the
  request (:666-691, :1110-1111);
* `_step0` samples the first frame from the prefill logits (:1440-1476);
* the AR chunk (:693-775) runs FIRST_CHUNK, then CHUNK_TOKENS steps as a
  Python loop. Each step's finished flag is copied to the host without
  blocking; before step i+1 the loop waits for step i-1's flag only, so the
  host still runs ahead of the device, and a chunk stops at most
  STEPS_AFTER_EOS steps after the step that sampled EOS (the JAX
  `while_loop` stops at once, :759-772). The kept codes are the same;
* `stream=False`: the codes of a chunk are read once, after it, as the JAX
  host loop reads them (:1163-1181); `decode_full` of the valid codes ->
  one `GenerationResult`;
* `stream=True`: the fused AR + codec superstep (`_make_stream_stepper`,
  :787-858, and `_stream_generate`, :1209-1314). Each chunk appends its
  valid codes to a pending ring on the device, decodes every full BLOCK of
  it through the streaming codec (all of it when every row has finished or
  on the final chunk), and copies its audio and a meta triple (frames
  generated, frames decoded, all finished) into pinned host memory without
  blocking. The host reads chunk N only once chunk N+1 is enqueued: one
  read per chunk. The number of blocks a chunk decodes is known on the
  device only, so the host runs as many as the chunk can need (its
  no-EOS bound, ceil for a flush) and each block's state update is taken
  only if the device's count reaches it;
* `create_tts_batch_session` -> the fixed-slot continuous-batching session
  (continuous_batching.py).

Weights: `init_params(seed)` (random, the JAX package's distributions),
`load_jax_params` (the JAX package's tree, dense or quantized) or `bind`
(a sanitized torch-layout checkpoint). `utils.apply_quantization` with
`model_quant_predicate` turns the AR path's linears into quantized ones,
whose forward on a CUDA tensor is kernel K2.

Not ported yet (they raise NotImplementedError): voice cloning (ICL,
speaker encoder), instruct / voice design, batch generation from strings,
and text given as a string (the HF tokenizer is not available to the port).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ....model import TorchModel, check_device
from ....ops.host_flags import FinishedFlags
from ....ops.kvcache import KVCache
from ....ops.sampling import apply_repetition_penalty, sample
from ..base import GenerationResult, format_duration, peak_memory_gb
from .config import ModelConfig
from .speech_tokenizer import (STREAM_CACHE_LEN, SpeechTokenizer,
                               init_stream_state, total_upsample)
from .talker import Talker

MAX_CACHE_LEN = 4096
HISTORY_LEN = 64
FIRST_CHUNK = 8
CHUNK_TOKENS = 25
PROMPT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)
CACHE_BUCKETS = (256, 512, 1024, 2048, 4096)
# steps a chunk may launch after the one whose finished flag is set: the
# loop reads the flag of step i-1 before launching step i+1
STEPS_AFTER_EOS = 1
# streaming (:90-92): frames per codec decode block, the pending ring, and
# the most blocks one chunk decodes
BLOCK = 8
PEND = CHUNK_TOKENS + BLOCK
MAX_DEC_BLOCKS = PEND // BLOCK


def _run(steps):
    """Run a generator to its end; -> the value it returns."""
    while True:
        try:
            next(steps)
        except StopIteration as done:
            return done.value


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class GenCarry:
    """State carried from one AR step to the next (GenCarry, :70-78). The
    cache is written in place; offset and trailing_idx are host ints."""

    caches: KVCache
    embed: torch.Tensor          # (B, 1, D) next talker input
    offset: int                  # cache write position
    finished: torch.Tensor       # (B,) bool
    history: torch.Tensor        # (B, HISTORY_LEN) recent code-0 tokens
    trailing_idx: int


@dataclass
class StreamCarry:
    """GenCarry plus the streaming codec's device state (StreamCarry,
    :81-88)."""

    gen: GenCarry
    pending: torch.Tensor        # (PEND, G) codes not yet decoded
    n_pending: torch.Tensor      # 0-dim int64
    n_generated: torch.Tensor    # 0-dim int64, frames sampled before EOS
    codec: dict                  # speech_tokenizer.init_stream_state


class _HostCopy:
    """Device tensors copied into host memory without blocking (pinned
    memory and an event on a GPU); `read` waits for the copy only."""

    def __init__(self, *tensors: torch.Tensor):
        cuda = tensors[0].device.type == "cuda"
        self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
                     for t in tensors]
        for h, t in zip(self.host, tensors):
            h.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event() if cuda else None
        if cuda:
            self.event.record()

    def ready(self) -> bool:
        """Whether the copy has landed (never waits)."""
        return self.event is None or self.event.query()

    def read(self):
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


class Model(TorchModel):
    """Qwen3-TTS (talker + code predictor + codec decoder) on `device`: the
    card by default; without CUDA the constructor raises unless given
    `device="cpu"`."""

    # JAX layer stacks with a leading L axis, unstacked by load_jax_params
    JAX_STACKED = ("talker.model.layers", "talker.code_predictor.model.layers")

    def __init__(self, config: ModelConfig, device="cuda"):
        device = check_device(device)
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        self.tcfg = config.talker_config
        self.cpcfg = self.tcfg.code_predictor_config
        self.dcfg = config.tokenizer_config.decoder_config
        self.total_upsample = total_upsample(self.dcfg)
        with torch.device(device):
            self.talker = Talker(self.tcfg)
            self.speech_tokenizer = SpeechTokenizer(self.dcfg)
        self.requires_grad_(False)
        self.eval()
        self._prompt_cache: Dict[tuple, tuple] = {}
        self._text_projection_calls = 0
        # what the last generate() ran, for callers that count launches
        self.last_run: Dict[str, int] = {}

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------

    @staticmethod
    def model_quant_predicate(path: str, w=None) -> bool:
        """Quantize the AR hot path only (:112-129): the talker and code
        predictor projections, codec_head and text_projection. The codec,
        norms, embeddings and the gathered code-predictor heads stay
        dense."""
        p = path.lower()
        if not p.startswith("talker"):
            return False
        if "lm_head" in p or "norm" in p or "embed" in p:
            return False
        leaf = p.rsplit(".", 1)[-1]
        return (leaf.endswith("_proj") or leaf in (
            "qkv_proj", "gateup_proj", "linear_fc1", "linear_fc2",
            "codec_head"))

    def bind(self, state) -> "Model":
        self._prompt_cache.clear()
        return super().bind(state)

    def init_params(self, seed: int = 0, on_device: bool = False) -> "Model":
        self._prompt_cache.clear()
        return super().init_params(seed, on_device=on_device)

    def sanitize(self, weights: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Map a published torch-layout checkpoint onto this model's names.

        Talker keys are per layer in the checkpoint, as here, and pass
        through; per-group code-predictor tables are stacked into
        (G-1, V, D). The codec's convolutions keep their torch layout;
        its codebooks are rebuilt from embedding_sum / cluster_usage
        (:165-189). Encoder and speaker-encoder keys are dropped."""
        import re

        out: Dict[str, np.ndarray] = {}
        codebooks: Dict[str, dict] = {}
        groups: Dict[str, Dict[int, np.ndarray]] = {}
        stacked = re.compile(r"^(talker\.code_predictor\.(?:model\."
                             r"codec_embedding|lm_head))\.(\d+)\.weight$")
        for k, w in weights.items():
            if k.startswith(("encoder.", "speaker_encoder.",
                             "speech_tokenizer.encoder.")):
                continue
            if "_codebook.cluster_usage" in k or "_codebook.embedding_sum" in k:
                base = k.rsplit("._codebook.", 1)[0]
                codebooks.setdefault(base, {})[k.rsplit(".", 1)[1]] = w
                continue
            if "codebook.initialized" in k:
                continue
            m = stacked.match(k)
            if m:
                groups.setdefault(m.group(1), {})[int(m.group(2))] = w
                continue
            out[k] = w
        for base, d in codebooks.items():
            emb = np.asarray(d["embedding_sum"], np.float32) / np.clip(
                np.asarray(d["cluster_usage"], np.float32)[:, None], 1e-5,
                None)
            out[f"{base}.codebook.embed.weight"] = emb
        for base, table in groups.items():
            out[f"{base}.weight"] = np.stack([table[i] for i in sorted(table)])
        return out

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    # ------------------------------------------------------------------
    # prompt assembly (:391-509)
    # ------------------------------------------------------------------

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids), dtype=torch.long,
                               device=self.device)

    def _embed_text_ids(self, text_ids) -> torch.Tensor:
        t = self.talker.model.text_embedding(self._ids(text_ids))
        self._text_projection_calls += 1
        return self.talker.text_projection(t)

    def _codec_embed(self, ids) -> torch.Tensor:
        return self.talker.model.codec_embedding(self._ids(ids))

    def prepare_inputs(self, text: Optional[str] = None,
                       text_ids: Optional[np.ndarray] = None,
                       language: str = "auto",
                       speaker: Optional[str] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (input_embeds (1, P, D), trailing text (1, T, D), pad embed).

        The port has no text tokenizer: pass `text_ids` (the chat-templated
        ids, `<|im_start|>assistant\\n ... <|im_end|>\\n<|im_start|>
        assistant\\n`)."""
        if text_ids is None:
            raise ValueError("No text tokenizer available in the port; pass "
                             "text_ids")
        text_ids = np.asarray(text_ids).reshape(1, -1)
        text_embed = self._embed_text_ids(text_ids)
        combined, codec_last, tts_eos, tts_pad = self._prompt_static(
            language, speaker)
        first_text = text_embed[:, 3:4] + codec_last
        input_embeds = torch.cat([text_embed[:, :3], combined, first_text],
                                 dim=1)
        trailing = torch.cat([text_embed[:, 4:-5], tts_eos], dim=1)
        return input_embeds, trailing, tts_pad

    def _prompt_static(self, language: str, speaker: Optional[str]):
        """Text-independent prompt pieces, cached per (language, speaker):
        (combined (1, C-1, D) codec prefix summed with the tts pad/bos
        embeds, codec_last (1, 1, D), tts_eos, tts_pad)."""
        cfg, tcfg = self.config, self.tcfg
        key = (language.lower(), (speaker or "").lower())
        hit = self._prompt_cache.get(key)
        if hit is not None:
            return hit
        tts = self._embed_text_ids([[cfg.tts_bos_token_id,
                                     cfg.tts_eos_token_id,
                                     cfg.tts_pad_token_id]])
        tts_bos, tts_eos, tts_pad = tts[:, 0:1], tts[:, 1:2], tts[:, 2:3]
        speaker_embed = None
        if speaker and speaker.lower() in (tcfg.spk_id or {}):
            speaker_embed = self._codec_embed(
                np.asarray(tcfg.spk_id[speaker.lower()]).reshape(1, 1))
        language_id = None
        if language.lower() != "auto" and (tcfg.codec_language_id or {}):
            language_id = tcfg.codec_language_id.get(language.lower())
        if (language.lower() in ("chinese", "auto") and speaker
                and (tcfg.spk_is_dialect or {}).get(speaker.lower())):
            dialect = tcfg.spk_is_dialect[speaker.lower()]
            if dialect in (tcfg.codec_language_id or {}):
                language_id = tcfg.codec_language_id[dialect]
        if language_id is None:
            prefill = [tcfg.codec_nothink_id, tcfg.codec_think_bos_id,
                       tcfg.codec_think_eos_id]
        else:
            prefill = [tcfg.codec_think_id, tcfg.codec_think_bos_id,
                       language_id, tcfg.codec_think_eos_id]
        parts = [self._codec_embed([prefill])]
        if speaker_embed is not None:
            parts.append(speaker_embed.reshape(1, 1, -1))
        parts.append(self._codec_embed([[tcfg.codec_pad_id,
                                         tcfg.codec_bos_id]]))
        codec_embed = torch.cat(parts, dim=1)
        pads = tts_pad.expand(1, codec_embed.shape[1] - 2, -1)
        combined = torch.cat([pads, tts_bos], dim=1) + codec_embed[:, :-1]
        out = (combined, codec_embed[:, -1:], tts_eos, tts_pad)
        self._prompt_cache[key] = out
        return out

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------

    def _suppress_mask(self) -> torch.Tensor:
        """-inf on codec special tokens except EOS (:658-664)."""
        mask = torch.zeros(self.tcfg.vocab_size, device=self.device)
        mask[self.dcfg.codebook_size:] = float("-inf")
        mask[self.tcfg.codec_eos_token_id] = 0.0
        return mask

    def _prefill(self, embeds: torch.Tensor, plen: int, cache_len: int):
        """Prompt (B, pb, D), right-padded from plen -> (logits (B, V),
        hidden (B, D)) at plen-1, and the filled cache (:666-691)."""
        b, pb, _ = embeds.shape
        caches = self.talker.make_cache(b, cache_len, embeds.dtype,
                                        embeds.device)
        pad = torch.zeros(b, cache_len, device=embeds.device)
        pad[:, plen:] = float("-inf")
        logits, hidden = self.talker(embeds, caches, 0,
                                     lengths_mask=pad[:, None, None, :])
        return logits[:, plen - 1], hidden[:, plen - 1], caches

    def _code_predictor(self, hidden, tok0, sampler):
        """Groups 1..G-1 for code 0 `tok0` (B,) -> (all codes (B, G),
        summed codec embedding of the frame (B, 1, D))."""
        code0_embed = self.talker.model.codec_embedding(tok0[:, None])
        cp_codes, cp_emb_sum = self.talker.code_predictor.sample(
            hidden, code0_embed, sampler)
        codes = torch.cat([tok0[:, None], cp_codes], dim=-1)
        return codes, code0_embed + cp_emb_sum

    def _step0(self, logits0, hidden0, caches, trailing, tl, pad_embed, plen,
               sampler, suppress) -> Tuple[GenCarry, torch.Tensor]:
        """First frame from the prefill logits (:1440-1476)."""
        tok0 = sampler(logits0.float() + suppress)
        codes, codec_e = self._code_predictor(hidden0[:, None], tok0, sampler)
        text_e = trailing[:, 0:1] if tl > 0 else pad_embed
        finished = tok0 == self.tcfg.codec_eos_token_id
        history = torch.full((tok0.shape[0], HISTORY_LEN), -1,
                             dtype=torch.long, device=tok0.device)
        history[:, -1] = tok0
        carry = GenCarry(caches=caches, embed=text_e + codec_e, offset=plen,
                         finished=finished, history=history, trailing_idx=1)
        return carry, codes

    def _ar_step(self, c: GenCarry, trailing, tl, pad_embed, sampler,
                 suppress, repetition_penalty) -> Tuple[GenCarry, torch.Tensor]:
        """One talker frame + its code-predictor sub-steps (:718-753)."""
        logits, hidden = self.talker(c.embed, c.caches, c.offset)
        lg = logits[:, -1].float() + suppress
        if repetition_penalty != 1.0:
            lg = apply_repetition_penalty(lg, c.history, repetition_penalty)
        tok0 = sampler(lg)
        codes, codec_e = self._code_predictor(hidden[:, -1:], tok0, sampler)
        text_e = (trailing[:, c.trailing_idx:c.trailing_idx + 1]
                  if c.trailing_idx < tl else pad_embed)
        now_finished = c.finished | (tok0 == self.tcfg.codec_eos_token_id)
        rolled = torch.cat([c.history[:, 1:], tok0[:, None]], dim=1)
        history = torch.where(c.finished[:, None], c.history, rolled)
        return GenCarry(caches=c.caches, embed=text_e + codec_e,
                        offset=c.offset + 1, finished=now_finished,
                        history=history,
                        trailing_idx=c.trailing_idx + 1), codes

    def _ar_steps(self, carry: GenCarry, n_steps: int, flags: FinishedFlags,
                  trailing, tl, pad_embed, sampler, suppress,
                  repetition_penalty):
        """Up to n_steps AR steps; before step i (i > STEPS_AFTER_EOS) the
        loop waits for step i-1-STEPS_AFTER_EOS's finished flags and stops
        if every row had finished. A generator that yields after each step
        launched (so that a caller can do host work between steps) and
        returns (carry, [codes (B, G)], [finished (B,)]) of the steps that
        ran."""
        codes_seq, fins = [], []
        lag = STEPS_AFTER_EOS + 1
        for i in range(n_steps):
            if i >= lag and bool(flags.read(i - lag).all()):
                break
            carry, codes = self._ar_step(carry, trailing, tl, pad_embed,
                                         sampler, suppress,
                                         repetition_penalty)
            codes_seq.append(codes)
            fins.append(carry.finished)
            flags.record(i, carry.finished)
            yield
        return carry, codes_seq, fins

    def _begin(self, text, text_ids, language, speaker, max_tokens, sampler,
               suppress):
        """Prompt, prefill and step 0 -> (carry, first codes (1, G),
        trailing, tl, pad_embed, prompt bucket)."""
        input_embeds, trailing, pad_embed = self.prepare_inputs(
            text=text, text_ids=text_ids, language=language, speaker=speaker)
        plen = input_embeds.shape[1]
        pb = _bucket(plen, PROMPT_BUCKETS)
        input_embeds = torch.nn.functional.pad(input_embeds,
                                               (0, 0, 0, pb - plen))
        tl = trailing.shape[1]
        if pb + max_tokens > MAX_CACHE_LEN:
            raise ValueError(
                f"max_tokens={max_tokens}: with a {pb}-position prompt "
                f"bucket it does not fit the talker's {MAX_CACHE_LEN}-column "
                f"KV cache (at most {MAX_CACHE_LEN - pb}); the JAX package "
                f"would clamp the writes and corrupt the late audio")
        cache_len = min(_bucket(pb + max_tokens + CHUNK_TOKENS,
                                CACHE_BUCKETS), MAX_CACHE_LEN)
        logits0, hidden0, caches = self._prefill(input_embeds, plen,
                                                 cache_len)
        carry, first_codes = self._step0(logits0, hidden0, caches, trailing,
                                         tl, pad_embed, plen, sampler,
                                         suppress)
        return carry, first_codes, trailing, tl, pad_embed, pb

    def generate(self, text: Optional[str] = None, *,
                 text_ids: Optional[np.ndarray] = None,
                 speaker: Optional[str] = None,
                 language: str = "auto",
                 instruct: Optional[str] = None,
                 ref_audio: Optional[np.ndarray] = None,
                 ref_text: Optional[str] = None,
                 temperature: float = 0.9, top_k: int = 50,
                 top_p: float = 1.0, repetition_penalty: float = 1.05,
                 max_tokens: int = 1200, stream: bool = False,
                 streaming_interval: float = 2.0, seed: int = 0):
        """Yield GenerationResults for `text_ids`: one, or with
        `stream=True` one per decoded chunk (FIRST_CHUNK frames first, then
        round(streaming_interval * 12.5)), the last with is_final_chunk."""
        if ref_audio is not None or ref_text is not None:
            raise NotImplementedError(
                "voice cloning (ICL, speaker encoder) is not ported yet")
        if instruct:
            raise NotImplementedError(
                "instruct / voice design prompts need the text tokenizer, "
                "which the port does not have yet")
        if text_ids is not None and np.asarray(text_ids).ndim == 2 \
                and np.asarray(text_ids).shape[0] > 1:
            raise NotImplementedError(
                "batch generation takes one request per row of a "
                "continuous-batching session (create_tts_batch_session)")
        if stream and -(-max_tokens // BLOCK) * BLOCK > STREAM_CACHE_LEN:
            raise ValueError(
                f"max_tokens={max_tokens}: a stream decodes at most "
                f"{STREAM_CACHE_LEN} frames (its codec KV buffer); the JAX "
                f"package would corrupt the audio past them")
        t_start = time.time()
        suppress = self._suppress_mask()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        sampler = partial(sample, temperature=temperature, top_k=top_k,
                          top_p=top_p, generator=gen)
        tp_before = self._text_projection_calls
        if stream:
            yield from self._stream_generate(
                text, text_ids, language, speaker, max_tokens, sampler,
                suppress, repetition_penalty, streaming_interval, tp_before)
            return
        with torch.inference_mode():
            carry, first_codes, trailing, tl, pad_embed, pb = self._begin(
                text, text_ids, language, speaker, max_tokens, sampler,
                suppress)
            finished = bool(carry.finished.all())
            # a first frame whose code 0 is EOS ends the request with no
            # audio (EOS lies past the codec's codebooks), as the stream
            # and the session do
            gen_codes = ([] if finished
                         else [first_codes[0].cpu().numpy()[None]])
            total_tokens = 0 if finished else 1
            steps = 0
            flags = FinishedFlags(CHUNK_TOKENS, carry.finished)
            while not finished and total_tokens < max_tokens:
                chunk = FIRST_CHUNK if total_tokens <= 1 else CHUNK_TOKENS
                chunk = min(chunk, max_tokens - total_tokens)
                carry, codes_seq, _ = _run(self._ar_steps(
                    carry, chunk, flags, trailing, tl, pad_embed, sampler,
                    suppress, repetition_penalty))
                n_run = len(codes_seq)
                steps += n_run
                # the one read of this chunk's codes
                codes_np = torch.stack(codes_seq).cpu().numpy()[:, 0]
                fin_np = np.array([bool(flags.read(i)[0])
                                   for i in range(n_run)])
                n_new = n_run
                if fin_np.any():
                    n_new = int(np.argmax(fin_np))   # EOS frame excluded
                    finished = True
                gen_codes.append(codes_np[:n_new])
                total_tokens += n_new
            if gen_codes:
                codes = np.concatenate(gen_codes, axis=0).T[None]  # (1, G, T)
                audio = self.speech_tokenizer.decoder(
                    torch.as_tensor(codes, device=self.device))[0]
                audio = audio.float().cpu().numpy()
            else:
                codes = np.zeros((1, self.tcfg.num_code_groups, 0), np.int64)
                audio = np.zeros((0,), np.float32)
        self.last_run = {
            "prompt_bucket": pb, "step0": 1, "decode_steps": steps,
            "text_projection_calls": self._text_projection_calls - tp_before}
        dur = len(audio) / self.sample_rate
        yield self._result(audio, 0, codes.shape[-1], time.time() - t_start,
                           dur, final=True)

    @torch.inference_mode()
    def _stream_generate(self, text, text_ids, language, speaker, max_tokens,
                         sampler, suppress, repetition_penalty,
                         streaming_interval, tp_before):
        """Streaming decode over the fused AR + codec superstep
        (_stream_generate, :1209-1314): one dispatch and one read per
        chunk. The JAX host reads chunk N once chunk N+1 is enqueued, which
        takes it no time; here enqueueing a chunk is the host's launches of
        its AR steps, seconds at full size, so between those steps the host
        also hands out every earlier chunk whose copy has landed (an event
        query, no wait), and reads the oldest with a wait only where the
        JAX host reads it. `_last_stream_stats` records the reads and the
        host's total wait in them."""
        spf = self.total_upsample
        t_seg = time.time()
        carry, first_codes, trailing, tl, pad_embed, pb = self._begin(
            text, text_ids, language, speaker, max_tokens, sampler, suppress)
        dec = self.speech_tokenizer.decoder
        dtype = next(dec.parameters()).dtype
        pending = torch.zeros(PEND, self.tcfg.num_code_groups,
                              dtype=torch.long, device=self.device)
        pending[0] = first_codes[0]
        n_pend0 = (~carry.finished[0]).long()
        sc = StreamCarry(carry, pending, n_pend0, n_pend0.clone(),
                         init_stream_state(self.dcfg, 1, dtype, self.device))
        chunk_frames = max(1, min(int(round(streaming_interval * 12.5)),
                                  CHUNK_TOKENS))
        stats = {"n_fetches": 0, "stall_s": 0.0}
        self._last_stream_stats = stats
        host = {"tokens": 1, "fin": False, "pend_ub": 1, "ar_fin": False,
                "steps": 0, "blocks": 0}
        inflight = []                  # [(_HostCopy, frames it can hold)]
        seg = {"start": t_seg, "idx": 0}
        flags = FinishedFlags(CHUNK_TOKENS, carry.finished)

        def dispatch(sc, n_steps, final):
            """Enqueue one chunk; yields the results of earlier chunks
            whose copies land meanwhile; returns the new carry."""
            # the host's no-EOS bound on pending frames (an EOS only ever
            # leaves fewer); a flush may come on any chunk, so the blocks
            # run and the fetch use the ceil bound (fix 6ec2fe7, :1248-1259)
            pend = host["pend_ub"] + n_steps
            nb_fetch = min(-(-pend // BLOCK), MAX_DEC_BLOCKS)
            nb = nb_fetch if final else pend // BLOCK
            host["pend_ub"] = max(pend - nb * BLOCK, 0)
            step = self._stream_superstep(
                sc, 0 if host["ar_fin"] else n_steps, final, nb_fetch, flags,
                trailing, tl, pad_embed, sampler, suppress,
                repetition_penalty, host)
            while True:
                try:
                    next(step)
                except StopIteration as done:
                    sc, audio, meta = done.value
                    break
                while inflight and inflight[0][0].ready():
                    audio_np = fetch()
                    if len(audio_np):
                        yield result(audio_np)
            inflight.append((_HostCopy(audio, meta), nb_fetch * BLOCK))
            return sc

        def fetch():
            copy, cap = inflight.pop(0)
            t0 = time.perf_counter()
            audio, meta = copy.read()
            stats["stall_s"] += time.perf_counter() - t0
            stats["n_fetches"] += 1
            host["tokens"] = max(host["tokens"], int(meta[0]))
            host["fin"] = host["fin"] or bool(meta[2])
            if int(meta[1]) > cap:
                raise RuntimeError(f"the stream decoded {int(meta[1])} "
                                   f"frames; the host ran {cap}")
            return audio[:int(meta[1]) * spf]

        def result(audio, final=False):
            now = time.time()
            r = self._result(audio, seg["idx"], host["tokens"],
                             now - seg["start"],
                             len(audio) / self.sample_rate, streaming=True,
                             final=final)
            seg["start"] = now
            seg["idx"] += 1
            return r

        remaining = max_tokens - 1
        if remaining <= 0:
            # budget fully consumed by step 0: flush-only superstep
            sc = yield from dispatch(sc, 0, True)
        first = True
        while remaining > 0 and not host["fin"]:
            chunk = min(FIRST_CHUNK if first else chunk_frames, remaining)
            final = chunk == remaining
            sc = yield from dispatch(sc, chunk, final)
            remaining -= chunk
            first = False
            if final:
                break
            if len(inflight) >= 2:
                audio = fetch()
                if len(audio):
                    yield result(audio)
        # drain: the EOS or final chunk flushed every pending frame; chunks
        # dispatched after it decode nothing
        tail = np.zeros((0,), np.float32)
        while inflight:
            audio = fetch()
            if len(audio) and inflight:
                yield result(audio)
            elif len(audio):
                tail = audio
        self.last_run = {
            "prompt_bucket": pb, "step0": 1, "decode_steps": host["steps"],
            "codec_blocks": host["blocks"],
            "text_projection_calls": self._text_projection_calls - tp_before}
        yield result(tail, final=True)

    def _stream_superstep(self, sc: StreamCarry, n_steps: int, final: bool,
                          n_decode: int, flags, trailing, tl, pad_embed,
                          sampler, suppress, repetition_penalty, host):
        """One chunk of the fused superstep (stream_chunk, :808-856): up to
        n_steps AR steps, their valid codes appended to the pending ring,
        then the codec over every full BLOCK of it (every frame of it on a
        flush: all rows finished, or `final`). The block count is a device
        value; the host runs `n_decode` blocks, and block i's state is kept
        only where the count exceeds i. No read of a device value. A
        generator that yields after each AR step (`_ar_steps`) and returns
        (carry, audio (n_decode * BLOCK * spf,) f32, meta [frames
        generated, frames decoded, all finished])."""
        dev = sc.pending.device
        gen, codes_seq, fins = yield from self._ar_steps(
            sc.gen, n_steps, flags, trailing, tl, pad_embed, sampler,
            suppress, repetition_penalty)
        host["steps"] += len(codes_seq)
        host["ar_fin"] = host["ar_fin"] or len(codes_seq) < n_steps
        pending, n_pending, n_generated = sc.pending, sc.n_pending, \
            sc.n_generated
        if codes_seq:
            fin_run = torch.stack(fins)[:, 0]
            n_new = (~fin_run).sum()
            ar = torch.arange(len(codes_seq), device=dev)
            # steps after EOS go to a scratch row past the ring
            idx = torch.where(ar < n_new, n_pending + ar,
                              torch.full_like(ar, PEND)).clamp(max=PEND)
            ring = torch.cat([pending, pending.new_zeros(1, pending.shape[1])])
            ring[idx] = torch.stack(codes_seq)[:, 0]
            pending = ring[:PEND]
            n_pending = n_pending + n_new
            n_generated = n_generated + n_new
        all_fin = gen.finished.all()
        flush = all_fin | final
        n_blocks = torch.where(flush, (n_pending + BLOCK - 1) // BLOCK,
                               n_pending // BLOCK)
        n_out = torch.where(flush, n_pending, n_blocks * BLOCK)
        rows = torch.arange(PEND, device=dev)
        codes_dec = torch.where(rows[:, None] < n_pending, pending, 0)
        codes_dec = codes_dec.T[None]                     # (1, G, PEND)
        state, audio = sc.codec, []
        dec = self.speech_tokenizer.decoder
        for i in range(n_decode):
            state, a = dec.streaming_step(
                state, codes_dec[:, :, i * BLOCK:(i + 1) * BLOCK],
                mask=(n_blocks > i).reshape(1))
            audio.append(a[0].float())
        host["blocks"] += n_decode
        consumed = n_blocks * BLOCK
        pending = pending[(rows + consumed).clamp(max=PEND - 1)]
        n_pending = (n_pending - consumed).clamp(min=0)
        meta = torch.stack([n_generated, n_out, all_fin.long()])
        audio = (torch.cat(audio) if audio
                 else torch.zeros(0, device=dev))
        return StreamCarry(gen, pending, n_pending, n_generated, state), \
            audio, meta

    def _result(self, audio, segment_idx, token_count, seg_time, dur,
                streaming=False, final=False) -> GenerationResult:
        return GenerationResult(
            audio=audio, samples=len(audio), sample_rate=self.sample_rate,
            segment_idx=segment_idx, token_count=token_count,
            audio_duration=format_duration(dur),
            real_time_factor=round(dur / seg_time, 3) if seg_time > 0
            else 0.0,
            prompt={"tokens": token_count,
                    "tokens-per-sec": round(token_count / seg_time, 2)
                    if seg_time > 0 else 0},
            audio_samples={"samples": len(audio),
                           "samples-per-sec": round(len(audio) / seg_time, 2)
                           if seg_time > 0 else 0},
            processing_time_seconds=seg_time,
            peak_memory_usage=peak_memory_gb(),
            is_streaming_chunk=streaming, is_final_chunk=final)

    # ------------------------------------------------------------------
    # continuous batching (server path, :375-382)
    # ------------------------------------------------------------------

    def supports_tts_continuous_batch(self, **kwargs) -> bool:
        return True

    def create_tts_batch_session(self, options=None):
        from ...continuous import TTSBatchOptions
        from .continuous_batching import Qwen3TTSBatchSession

        return Qwen3TTSBatchSession(self, options or TTSBatchOptions())
