"""Qwen3-TTS: autoregressive codec-token TTS (talker + code predictor) with
a 12.5 Hz codec decoder.

Counterpart of mlx_audio_tpu/tts/models/qwen3_tts/qwen3_tts.py, text ->
audio:

* `prepare_inputs` from `text` (chat-templated through the model
  directory's tokenizer, bound by `post_load_hook`) or `text_ids`, an
  optional `instruct` (a user-role prompt before the assistant's: instruct,
  CustomVoice and VoiceDesign) and `_prompt_static` (language, an optional
  `spk_id` speaker, or with `ref_audio` the speaker encoder's x-vector,
  which bypasses the cache; :446-500);
* voice cloning (:515-652, :1085-1204): `ref_audio` + `ref_text` build the
  ICL prompt (`prepare_icl_inputs`: the reference transcript and the
  target text over codec pads, then the reference clip's codes from the
  Mimi reference encoder, `encode_ref_audio`, over tts pads, and the
  x-vector in the codec prefix); `ref_audio` alone takes the x-vector
  path. The whole path decodes [reference; generated] codes and cuts the
  reference's samples off; the streamed path decodes the generated codes
  only, as in JAX. The encoders (`attach_ref_encoder`,
  `attach_speaker_encoder`, or `bind` of a state holding their weights)
  stay in f32 whatever the talker's dtype, and run under
  `mimi.exact_f32()`;
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
  (continuous_batching.py), which `batch_generate` also runs.

Weights: `init_params(seed)` (random, the JAX package's distributions),
`load_jax_params` (the JAX package's tree, dense or quantized) or `bind`
(a sanitized torch-layout checkpoint). `utils.apply_quantization` with
`model_quant_predicate` turns the AR path's linears into quantized ones,
whose forward on a CUDA tensor is kernel K2.

Departures from the JAX package, each pinned by a test in
tests/test_torch_qwen3_tts_icl.py:

* the ICL reference cache is keyed by a digest of the clip's f32 samples
  and `ref_text`, where JAX's key (ref_text, size, sum) hands a second clip
  of the same length and sum the first clip's codes; it keeps the
  ICL_CACHE_SIZE latest clips;
* the whole path cuts exactly ref_frames x total_upsample samples (the
  decoder returns T x total_upsample), where JAX's float cut
  `int(ref_len / T * len(audio))` keeps one reference sample for some
  lengths.

Text without a tokenizer raises ValueError: the tokenizer is read from the
model directory only (`local_tokenizer`), never downloaded.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ....model import TorchModel, check_device
from ....ops.host_flags import FinishedFlags
from ....ops.kvcache import KVCache
from ....ops.sampling import apply_repetition_penalty, sample
from ..base import (BatchGenerationResult, GenerationResult, format_duration,
                    local_tokenizer, peak_memory_gb)
from .config import ModelConfig
from .speaker_encoder import (SpeakerEncoder, sanitize_speaker_encoder,
                              speaker_mel)
from .speech_tokenizer import (STREAM_CACHE_LEN, SpeechTokenizer,
                               encoder_mimi_config, init_stream_state,
                               total_upsample)
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
# reference clips whose codes (and x-vector) the ICL cache keeps
ICL_CACHE_SIZE = 16
REF_ENCODER = "speech_tokenizer.encoder."
SPEAKER_ENCODER = "speaker_encoder."


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
        self._icl_cache: Dict[tuple, tuple] = {}
        self._text_projection_calls = 0
        # the text tokenizer, bound by post_load_hook (None: text_ids only)
        self.tokenizer = None
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
        """Bind a torch-layout state; a state holding reference-encoder or
        speaker-encoder weights attaches those encoders first."""
        if any(k.startswith(REF_ENCODER) for k in state):
            self.attach_ref_encoder()
        if any(k.startswith(SPEAKER_ENCODER) for k in state):
            self.attach_speaker_encoder()
        self._prompt_cache.clear()
        self._icl_cache.clear()
        return super().bind(state)

    def init_params(self, seed: int = 0, on_device: bool = False) -> "Model":
        self._prompt_cache.clear()
        self._icl_cache.clear()
        return super().init_params(seed, on_device=on_device)

    def astype(self, dtype) -> "Model":
        """Cast the talker and the codec decoder; the reference and speaker
        encoders stay in f32 (a clip is encoded once a request, and its
        codes are an argmin)."""
        keep = {id(p) for m in (self._ref_encoder(), self._speaker_encoder())
                if m is not None for p in m.parameters()}
        for p in self.parameters():
            if p.is_floating_point() and id(p) not in keep:
                p.data = p.data.to(dtype)
        self._prompt_cache.clear()
        return self

    # ------------------------------------------------------------------
    # reference encoders (voice cloning, :515-561)
    # ------------------------------------------------------------------

    def _ref_encoder(self):
        return self.speech_tokenizer._modules.get("encoder")

    def _speaker_encoder(self):
        return self._modules.get("speaker_encoder")

    @property
    def has_ref_encoder(self) -> bool:
        return self._ref_encoder() is not None

    @property
    def has_speaker_encoder(self) -> bool:
        return self._speaker_encoder() is not None

    def attach_ref_encoder(self):
        """Build the Mimi reference encoder (encode path only, f32) from the
        tokenizer's `encoder_config` (None: the published dims) under
        `speech_tokenizer.encoder`, unless one is attached. Its weights are
        then bound, drawn by `init_params` or loaded by `load_jax_params`."""
        enc = self._ref_encoder()
        if enc is None:
            from ....codec.models.mimi import Mimi

            enc = Mimi(encoder_mimi_config(
                self.config.tokenizer_config.encoder_config),
                device=self.device, decoder=False)
            self.speech_tokenizer.encoder = enc
            self._icl_cache.clear()
        return enc

    def attach_speaker_encoder(self) -> SpeakerEncoder:
        """Build the ECAPA speaker encoder (f32) at the config's
        `speaker_encoder_config` under `speaker_encoder`, unless one is
        attached."""
        spk = self._speaker_encoder()
        if spk is None:
            with torch.device(self.device):
                spk = SpeakerEncoder(self.config.speaker_encoder_config)
            spk.requires_grad_(False)
            self.speaker_encoder = spk
            self._icl_cache.clear()
        return spk

    def _get_ref_encoder(self):
        enc = self._ref_encoder()
        if enc is None:
            raise ValueError(
                "this checkpoint has no speech-tokenizer encoder; ICL voice "
                "cloning is unavailable")
        return enc

    def encode_ref_audio(self, ref_audio) -> torch.Tensor:
        """A 24 kHz waveform -> codes (1, valid_nq, T) int64 on the device:
        the first encoder_valid_num_quantizers books of the reference
        encoder's."""
        valid_nq = self.config.tokenizer_config.encoder_valid_num_quantizers
        codes = self._get_ref_encoder().encode(
            np.asarray(ref_audio, np.float32).reshape(1, -1))
        return codes[:, :valid_nq]

    @torch.inference_mode()
    def extract_speaker_embedding(self, audio) -> torch.Tensor:
        """A reference clip -> its x-vector (1, enc_dim), f32 on the
        device."""
        from ....codec.models.mimi import exact_f32

        spk = self._speaker_encoder()
        if spk is None:
            raise ValueError("speaker encoder not available for this model")
        with exact_f32():
            mels = speaker_mel(audio, sample_rate=self.config.sample_rate,
                               device=self.device)
            return spk(mels)

    def sanitize(self, weights: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Map a published torch-layout checkpoint onto this model's names.

        Talker keys are per layer in the checkpoint, as here, and pass
        through; per-group code-predictor tables are stacked into
        (G-1, V, D). The codec's convolutions keep their torch layout;
        its codebooks are rebuilt from embedding_sum / cluster_usage
        (:165-189). The reference encoder's HF keys map onto the Mimi tree
        under `speech_tokenizer.encoder` (`_sanitize_ref_encoder`) and the
        speaker encoder's pass through (:143-192); `bind` attaches both
        when the state holds them."""
        import re

        out: Dict[str, np.ndarray] = {}
        out.update(self._sanitize_ref_encoder(weights))
        out.update(sanitize_speaker_encoder(weights))
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

    def _sanitize_ref_encoder(self, weights) -> Dict[str, np.ndarray]:
        """The reference encoder's HF keys (bare `encoder.*`, or
        `speech_tokenizer.encoder.*` as the loader merges the published
        speech_tokenizer/ folder) -> `speech_tokenizer.encoder.<Mimi
        tree>` (:224-333). Under `encoder.` they are an HF `MimiModel`'s
        names, so the Mimi's own mapping applies (`sanitize_mimi`, its
        SEANet index maps from this config's `encoder_config`; q/k/v fused;
        codebooks rebuilt from cluster_usage / embedding_sum); the
        quantizer's output projections, which encoding does not use, are
        dropped. Kernels keep torch's layouts."""
        from ....codec.models.mimi.mimi import sanitize_mimi

        enc = {}
        for k, w in weights.items():
            if k.startswith(REF_ENCODER):
                k = k[len("speech_tokenizer."):]
            if k.startswith("encoder."):
                # the codebooks sit under `vq.layers` or `layers`
                enc[k[len("encoder."):].replace(
                    "_vector_quantizer.vq.layers.",
                    "_vector_quantizer.layers.")] = w
        if not enc:
            return {}
        seanet = encoder_mimi_config(
            self.config.tokenizer_config.encoder_config).seanet
        return {REF_ENCODER + k: v
                for k, v in sanitize_mimi(enc, seanet, decoder=False).items()}

    @classmethod
    def post_load_hook(cls, model: "Model", model_path) -> "Model":
        """Bind the text tokenizer saved in the model directory (None
        without tokenizer files or `transformers`; never downloaded)."""
        model.tokenizer = local_tokenizer(model_path)
        return model

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    def get_supported_speakers(self) -> List[str]:
        return sorted((self.tcfg.spk_id or {}).keys())

    def get_supported_languages(self) -> List[str]:
        return sorted((self.tcfg.codec_language_id or {}).keys())

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

    def _encode(self, text: str) -> np.ndarray:
        if self.tokenizer is None:
            raise ValueError(
                "No text tokenizer: the model directory holds no tokenizer "
                "files (or transformers is not installed); pass text_ids, or "
                "set model.tokenizer")
        return np.asarray(self.tokenizer.encode(text)).reshape(1, -1)

    def prepare_inputs(self, text: Optional[str] = None,
                       text_ids: Optional[np.ndarray] = None,
                       language: str = "auto",
                       speaker: Optional[str] = None,
                       instruct: Optional[str] = None,
                       ref_audio=None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (input_embeds (1, P, D), trailing text (1, T, D), pad embed).

        `text` goes through the chat template
        (`<|im_start|>assistant\\n ... <|im_end|>\\n<|im_start|>assistant\\n`)
        and the tokenizer; `text_ids` are such ids already. `instruct`
        prepends a user-role prompt (instruct, CustomVoice, VoiceDesign);
        `ref_audio` puts its x-vector where a speaker's embedding goes."""
        if text_ids is None:
            text_ids = self._encode(f"<|im_start|>assistant\n{text}<|im_end|>\n"
                                    f"<|im_start|>assistant\n")
        text_ids = np.asarray(text_ids).reshape(1, -1)
        text_embed = self._embed_text_ids(text_ids)
        combined, codec_last, tts_eos, tts_pad = self._prompt_static(
            language, speaker, ref_audio)
        parts = [text_embed[:, :3], combined]
        if instruct:
            parts.insert(0, self._embed_text_ids(self._encode(
                f"<|im_start|>user\n{instruct}<|im_end|>\n")))
        first_text = text_embed[:, 3:4] + codec_last
        input_embeds = torch.cat(parts + [first_text], dim=1)
        trailing = torch.cat([text_embed[:, 4:-5], tts_eos], dim=1)
        return input_embeds, trailing, tts_pad

    def _prompt_static(self, language: str, speaker: Optional[str],
                       ref_audio=None):
        """Text-independent prompt pieces, cached per (language, speaker):
        (combined (1, C-1, D) codec prefix summed with the tts pad/bos
        embeds, codec_last (1, 1, D), tts_eos, tts_pad). With `ref_audio`
        and a speaker encoder, the clip's x-vector is the speaker embedding,
        and the cache is neither read nor written."""
        cfg, tcfg = self.config, self.tcfg
        key = (language.lower(), (speaker or "").lower())
        if ref_audio is None:
            hit = self._prompt_cache.get(key)
            if hit is not None:
                return hit
        tts = self._embed_text_ids([[cfg.tts_bos_token_id,
                                     cfg.tts_eos_token_id,
                                     cfg.tts_pad_token_id]])
        tts_bos, tts_eos, tts_pad = tts[:, 0:1], tts[:, 1:2], tts[:, 2:3]
        speaker_embed = None
        if ref_audio is not None and self.has_speaker_encoder:
            speaker_embed = self.extract_speaker_embedding(ref_audio).to(
                tts.dtype)
        elif speaker and speaker.lower() in (tcfg.spk_id or {}):
            speaker_embed = self._codec_embed(
                np.asarray(tcfg.spk_id[speaker.lower()]).reshape(1, 1))
        language_id = self._language_id(language)
        if (language.lower() in ("chinese", "auto") and speaker
                and (tcfg.spk_is_dialect or {}).get(speaker.lower())):
            dialect = tcfg.spk_is_dialect[speaker.lower()]
            if dialect in (tcfg.codec_language_id or {}):
                language_id = tcfg.codec_language_id[dialect]
        parts = [self._codec_embed([self._codec_prefill_ids(language_id)])]
        if speaker_embed is not None:
            parts.append(speaker_embed.reshape(1, 1, -1))
        parts.append(self._codec_embed([[tcfg.codec_pad_id,
                                         tcfg.codec_bos_id]]))
        codec_embed = torch.cat(parts, dim=1)
        pads = tts_pad.expand(1, codec_embed.shape[1] - 2, -1)
        combined = torch.cat([pads, tts_bos], dim=1) + codec_embed[:, :-1]
        out = (combined, codec_embed[:, -1:], tts_eos, tts_pad)
        if ref_audio is None:
            self._prompt_cache[key] = out
        return out

    def _language_id(self, language: str) -> Optional[int]:
        tcfg = self.tcfg
        if language.lower() != "auto" and (tcfg.codec_language_id or {}):
            return tcfg.codec_language_id.get(language.lower())
        return None

    def _codec_prefill_ids(self, language_id: Optional[int]) -> List[int]:
        """The codec prefix's think / language ids (:636-645)."""
        tcfg = self.tcfg
        if language_id is None:
            return [tcfg.codec_nothink_id, tcfg.codec_think_bos_id,
                    tcfg.codec_think_eos_id]
        return [tcfg.codec_think_id, tcfg.codec_think_bos_id, language_id,
                tcfg.codec_think_eos_id]

    def _icl_reference(self, ref_audio, ref_text: str):
        """(ref codes (1, nq, T), ref text ids (1, R), x-vector (1, 1, D) or
        None) of a reference clip, cached by a digest of its f32 samples and
        ref_text (JAX's key, its length and sum, collides)."""
        audio = np.ascontiguousarray(np.asarray(ref_audio, np.float32)
                                     .reshape(-1))
        key = (hashlib.sha256(audio.tobytes()).hexdigest(), ref_text)
        hit = self._icl_cache.get(key)
        if hit is not None:
            return hit
        codes = self.encode_ref_audio(audio)
        ref_ids = self._encode(
            f"<|im_start|>assistant\n{ref_text}<|im_end|>\n")[:, 3:-2]
        xvec = (self.extract_speaker_embedding(audio).reshape(1, 1, -1)
                if self.has_speaker_encoder else None)
        while len(self._icl_cache) >= ICL_CACHE_SIZE:
            self._icl_cache.pop(next(iter(self._icl_cache)))
        self._icl_cache[key] = hit = (codes, ref_ids, xvec)
        return hit

    def prepare_icl_inputs(self, text: str, ref_audio, ref_text: str,
                           language: str = "auto"
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
        """The ICL voice-clone prompt (:563-652): the role, the codec
        prefix (with the x-vector when there is a speaker encoder), the
        reference transcript and the target text plus tts EOS over codec
        pads, then codec BOS and the reference clip's summed codec
        embeddings over tts pads. -> (input_embeds (1, P, D), trailing
        (1, 1, D) = tts pad, pad embed = tts pad, ref codes (1, nq, T))."""
        cfg, tcfg = self.config, self.tcfg
        if self.tokenizer is None:
            raise ValueError("ICL voice cloning requires the text tokenizer")
        ref_codes, ref_ids, xvec = self._icl_reference(ref_audio, ref_text)
        target_ids = self._encode(
            f"<|im_start|>assistant\n{text}<|im_end|>\n"
            f"<|im_start|>assistant\n")
        tts = self._embed_text_ids([[cfg.tts_bos_token_id,
                                     cfg.tts_eos_token_id,
                                     cfg.tts_pad_token_id]])
        tts_bos, tts_eos, tts_pad = tts[:, 0:1], tts[:, 1:2], tts[:, 2:3]
        text_embed = torch.cat([self._embed_text_ids(np.concatenate(
            [ref_ids, target_ids[:, 3:-5]], axis=1)), tts_eos], dim=1)
        # the codec side: BOS, then each reference frame's embeddings of
        # code 0 (talker table) and codes 1..G-1 (code-predictor tables)
        cp_emb = self.talker.code_predictor.model.codec_embedding.weight
        ref_codec = self.talker.model.codec_embedding(ref_codes[:, 0])
        for gi in range(tcfg.num_code_groups - 1):
            ref_codec = ref_codec + cp_emb[gi][ref_codes[:, gi + 1]].to(
                ref_codec.dtype)
        codec_icl = torch.cat([self._codec_embed([[tcfg.codec_bos_id]]),
                               ref_codec], dim=1)
        codec_pad = self._codec_embed([[tcfg.codec_pad_id]])
        icl_embed = torch.cat([text_embed + codec_pad, codec_icl + tts_pad],
                              dim=1)
        parts = [self._codec_embed([self._codec_prefill_ids(
            self._language_id(language))])]
        if xvec is not None:
            parts.append(xvec.to(tts.dtype))
        parts.append(self._codec_embed([[tcfg.codec_pad_id,
                                         tcfg.codec_bos_id]]))
        codec_prefix = torch.cat(parts, dim=1)
        pads = tts_pad.expand(1, codec_prefix.shape[1] - 2, -1)
        combined = torch.cat([pads, tts_bos], dim=1) + codec_prefix[:, :-1]
        input_embeds = torch.cat([self._embed_text_ids(target_ids[:, :3]),
                                  combined, icl_embed], dim=1)
        return input_embeds, tts_pad, tts_pad, ref_codes

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

    def _prompt(self, text, text_ids, language, speaker, instruct,
                ref_audio, ref_text):
        """-> (input_embeds, trailing, pad_embed, ref codes or None): the ICL
        prompt for ref_audio + ref_text (:1085-1100), else prepare_inputs
        (with ref_audio, its x-vector)."""
        if ref_audio is not None and ref_text is not None:
            return self.prepare_icl_inputs(text, ref_audio, ref_text,
                                           language=language)
        if ref_audio is not None and not self.has_speaker_encoder:
            raise ValueError(
                "ref_audio was passed but this checkpoint has no speaker "
                "encoder; pass ref_text as well for ICL voice cloning "
                "(requires the tokenizer encoder) or drop ref_audio")
        return self.prepare_inputs(
            text=text, text_ids=text_ids, language=language, speaker=speaker,
            instruct=instruct, ref_audio=ref_audio) + (None,)

    def _begin(self, text, text_ids, language, speaker, instruct, max_tokens,
               sampler, suppress, ref_audio=None, ref_text=None):
        """Prompt, prefill and step 0 -> (carry, first codes (1, G),
        trailing, tl, pad_embed, prompt bucket, ref codes or None)."""
        input_embeds, trailing, pad_embed, ref_codes = self._prompt(
            text, text_ids, language, speaker, instruct, ref_audio, ref_text)
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
        return carry, first_codes, trailing, tl, pad_embed, pb, ref_codes

    def generate(self, text: Optional[str] = None, *,
                 text_ids: Optional[np.ndarray] = None,
                 voice: Optional[str] = None,
                 speaker: Optional[str] = None,
                 language: str = "auto",
                 lang_code: Optional[str] = None,
                 speed: float = 1.0,
                 split_pattern: Optional[str] = "\n",
                 instruct: Optional[str] = None,
                 ref_audio: Optional[np.ndarray] = None,
                 ref_text: Optional[str] = None,
                 temperature: float = 0.9, top_k: int = 50,
                 top_p: float = 1.0, repetition_penalty: float = 1.05,
                 max_tokens: int = 1200, stream: bool = False,
                 streaming_interval: float = 2.0, seed: int = 0, **kwargs):
        """Yield GenerationResults for `text` (or `text_ids`): one, or with
        `stream=True` one per decoded chunk (FIRST_CHUNK frames first, then
        round(streaming_interval * 12.5)), the last with is_final_chunk.
        `voice` aliases `speaker` and `lang_code` `language`; text with
        several `split_pattern` segments yields each segment's results in
        turn (seed + segment index); `speed` is accepted and not used, as
        in the JAX package. `ref_audio` (a 24 kHz clip) with `ref_text`
        clones its voice by ICL; `ref_audio` alone by its x-vector (a
        checkpoint without a speaker encoder raises ValueError)."""
        if text_ids is not None and np.asarray(text_ids).ndim == 2 \
                and np.asarray(text_ids).shape[0] > 1:
            raise NotImplementedError(
                "batch generation takes one request per row of a "
                "continuous-batching session (create_tts_batch_session)")
        if lang_code is not None:
            language = lang_code
        speaker = speaker or voice
        if text is not None and text_ids is None and split_pattern:
            segments = [t.strip() for t in text.split(split_pattern)
                        if t.strip()]
            if len(segments) > 1:
                for seg_idx, seg in enumerate(segments):
                    for r in self.generate(
                            seg, speaker=speaker, language=language,
                            split_pattern=None, instruct=instruct,
                            ref_audio=ref_audio, ref_text=ref_text,
                            temperature=temperature, top_k=top_k,
                            top_p=top_p,
                            repetition_penalty=repetition_penalty,
                            max_tokens=max_tokens, stream=stream,
                            streaming_interval=streaming_interval,
                            seed=seed + seg_idx):
                        r.segment_idx = seg_idx
                        yield r
                return
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
                text, text_ids, language, speaker, instruct, max_tokens,
                sampler, suppress, repetition_penalty, streaming_interval,
                tp_before, ref_audio, ref_text)
            return
        with torch.inference_mode():
            carry, first_codes, trailing, tl, pad_embed, pb, ref_codes = \
                self._begin(text, text_ids, language, speaker, instruct,
                            max_tokens, sampler, suppress, ref_audio,
                            ref_text)
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
            ref_len = 0 if ref_codes is None else ref_codes.shape[-1]
            if gen_codes:
                codes = np.concatenate(gen_codes, axis=0).T[None]  # (1, G, T)
                dec_codes = torch.as_tensor(codes, device=self.device)
                if ref_len:
                    # decode [reference; generated] and cut the reference's
                    # samples, exactly ref_len frames of them (:1188-1204)
                    dec_codes = torch.cat([ref_codes, dec_codes], dim=-1)
                audio = self.speech_tokenizer.decoder(dec_codes)[0]
                audio = audio[ref_len * self.total_upsample:]
                audio = audio.float().cpu().numpy()
            else:
                codes = np.zeros((1, self.tcfg.num_code_groups, 0), np.int64)
                audio = np.zeros((0,), np.float32)
        self.last_run = {
            "prompt_bucket": pb, "step0": 1, "decode_steps": steps,
            "ref_frames": ref_len,
            "text_projection_calls": self._text_projection_calls - tp_before}
        dur = len(audio) / self.sample_rate
        yield self._result(audio, 0, codes.shape[-1], time.time() - t_start,
                           dur, final=True)

    @torch.inference_mode()
    def _stream_generate(self, text, text_ids, language, speaker, instruct,
                         max_tokens, sampler, suppress, repetition_penalty,
                         streaming_interval, tp_before, ref_audio=None,
                         ref_text=None):
        """Streaming decode over the fused AR + codec superstep
        (_stream_generate, :1209-1314): one dispatch and one read per
        chunk. The JAX host reads chunk N once chunk N+1 is enqueued, which
        takes it no time; here enqueueing a chunk is the host's launches of
        its AR steps, seconds at full size, so between those steps the host
        also hands out every earlier chunk whose copy has landed (an event
        query, no wait), and reads the oldest with a wait only where the
        JAX host reads it. `_last_stream_stats` records the reads and the
        host's total wait in them. An ICL request streams the generated
        codes only (:1131-1135)."""
        spf = self.total_upsample
        t_seg = time.time()
        carry, first_codes, trailing, tl, pad_embed, pb, ref_codes = \
            self._begin(text, text_ids, language, speaker, instruct,
                        max_tokens, sampler, suppress, ref_audio, ref_text)
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
            "ref_frames": 0 if ref_codes is None else ref_codes.shape[-1],
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

    def generate_custom_voice(self, text: str, speaker: str,
                              language: str = "auto",
                              instruct: Optional[str] = None, **kwargs):
        """CustomVoice checkpoints: a predefined speaker and an optional
        style instruction (the 0.6B ones take none)."""
        if self.config.tts_model_type != "custom_voice":
            raise ValueError(
                f"model type '{self.config.tts_model_type}' does not "
                "support generate_custom_voice (need a CustomVoice "
                "checkpoint)")
        speakers = [s.lower() for s in self.get_supported_speakers()]
        if speaker.lower() not in speakers:
            raise ValueError(f"Speaker '{speaker}' not supported. "
                             f"Available: {self.get_supported_speakers()}")
        if self.config.tts_model_size == "0b6":
            instruct = None
        yield from self.generate(text, speaker=speaker, language=language,
                                 instruct=instruct, **kwargs)

    def generate_voice_design(self, text: str, instruct: str,
                              language: str = "auto", **kwargs):
        """VoiceDesign checkpoints: the voice described in words."""
        if self.config.tts_model_type != "voice_design":
            raise ValueError(
                f"model type '{self.config.tts_model_type}' does not "
                "support generate_voice_design (need a VoiceDesign "
                "checkpoint)")
        yield from self.generate(text, language=language, instruct=instruct,
                                 **kwargs)

    def batch_generate(self, texts: List[str], *,
                       speakers: Optional[List[Optional[str]]] = None,
                       language: str = "auto", temperature: float = 0.9,
                       top_k: int = 50, top_p: float = 1.0,
                       repetition_penalty: float = 1.05,
                       max_tokens: int = 1200, seed: int = 0, **kwargs):
        """Generate `texts` together through a continuous-batching session
        of len(texts) slots (:1351-1419); yields one BatchGenerationResult
        per text, in input order. `seed` is accepted and not used (the
        session's sampler has its own generator), as in the JAX package."""
        from ...continuous import TTSBatchOptions
        from .continuous_batching import Qwen3TTSBatchSession

        t0 = time.time()

        class _Req:
            def __init__(self, idx):
                self.request_id = f"batch-{idx}"
                self.normalized_kwargs = {
                    "language": language,
                    "speaker": speakers[idx] if speakers else None}
                self.chunks: List[np.ndarray] = []
                self.error = None
                self.payload = texts[idx]

            def emit_data(self, data):
                self.chunks.append(np.asarray(data["audio"]))

            def emit_error(self, err):
                self.error = err

            def emit_done(self):
                pass

        options = TTSBatchOptions(
            max_batch_size=len(texts), temperature=temperature, top_k=top_k,
            top_p=top_p, repetition_penalty=repetition_penalty,
            max_tokens=max_tokens)
        session = Qwen3TTSBatchSession(self, options)
        reqs = [_Req(i) for i in range(len(texts))]
        for r in reqs:
            session.submit(r)
        steps = 0
        while not session.idle and steps < max_tokens + 4:
            session.step()
            steps += 1
        elapsed = time.time() - t0
        for i, r in enumerate(reqs):
            if r.error is not None:
                raise r.error
            audio = (np.concatenate(r.chunks)
                     if r.chunks else np.zeros((0,), np.float32))
            dur = len(audio) / self.sample_rate
            yield BatchGenerationResult(
                audio=audio, sequence_idx=i, samples=len(audio),
                sample_rate=self.sample_rate,
                token_count=int(round(dur * 12.5)),
                audio_duration=format_duration(dur),
                processing_time_seconds=elapsed,
                peak_memory_usage=peak_memory_gb())

    def supports_tts_continuous_batch(self, **kwargs) -> bool:
        return True

    def create_tts_batch_session(self, options=None):
        from ...continuous import TTSBatchOptions
        from .continuous_batching import Qwen3TTSBatchSession

        return Qwen3TTSBatchSession(self, options or TTSBatchOptions())
