"""Fun-ASR-Nano: SenseVoice's SANM encoder, a transformer adaptor and a
Qwen3 LM.

Counterpart of mlx_audio_tpu/stt/models/fun_asr_nano/fun_asr_nano.py:

* the config (:78-124, the `llm_config` alias, `sanm_shfit`) and
  `fake_token_length` (:127-132);
* the audio encoder, `sensevoice.SANMEncoder` (`encoder_forward`
  :192-214), and the adaptor (`adaptor_forward` :217-248): window
  reshape by `downsample_rate`, ReLU projector, transformer blocks;
* the prompt (`_map_language`, `_resolve_hotwords`, `_prompt_text`,
  `_build_prompt_ids` :313-369, copied), the splice of the first
  `min(fake_len, rows)` adaptor rows at the audio placeholders
  (:446-476), chunking through Qwen3-ASR's `split_audio_into_chunks`;
* the decode on `stt.models.qwen3_lm`'s stepper over the port's Qwen3 LM
  (`llm.model`, `llm.lm_head` unless tied): EOS ids 151643 and 151645,
  f32 caches, greedy or seeded sampling;
* `model_quant_predicate` (`llm.model`), `sanitize` and `post_load_hook`
  (:538-566).

The tied table under q8: `llm.model.embed_tokens` passes the predicate,
but quantization takes linears only and an MLX-packed table is unpacked
to a dense one (as the JAX package's `maybe_quantize_tree` does), so the
head is one dense product against the table; a q8 model runs its 7 x
num_hidden_layers LM linears a token on K2.

Departures from the JAX package:

* the encoder and adaptor run the frames the audio has; JAX pads them to
  an `ENC_BUCKETS` length under a mask, and its masked result on the
  valid rows is the unpadded one (`test_torch_fun_asr_nano.py::
  test_tower_unpadded_equals_jax_bucketed`);
* the decode is the Qwen3 stepper's: draws from a `torch.Generator` (only
  greedy decoding compares token for token), each audio chunk seeded
  `seed + index`, a stop at most one step after EOS with the same kept
  tokens, f32 caches that grow with the decode, and a step that reads
  only the columns written;
* `post_load_hook` raises where the directory's tokenizer files fail to
  load; JAX's swallows the error and leaves no tokenizer.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, holder
from ....nn import LayerNorm, Linear
from ....ops.attention import attention
from ....tts.models.base import local_tokenizer
from ....tts.models.moss_tts.moss_tts import (Qwen3LM, lm_logits,
                                              qwen3_lm_forward)
from ...models.base import STTOutput
from ...models.llm_stt import as_audio
from ...models.qwen3_lm import iter_decode, make_decode_fns, prompt_bucket
from ..qwen3_asr.config import TextConfig
from ..qwen3_asr.qwen3_asr import split_audio_into_chunks
from ..sensevoice.sensevoice import (EncoderConfig as SenseVoiceEncoderConfig,
                                     SANMEncoder, kaldi_lfr_features,
                                     sanm_sanitize)

ISO_TO_PROMPT_LANGUAGE = {
    "zh": "中文", "zh-cn": "中文", "zh-hans": "中文", "zh-tw": "中文",
    "zh-hant": "中文", "cmn": "中文", "cjy": "中文", "gan": "中文",
    "hak": "中文", "hsn": "中文", "nan": "中文", "wuu": "中文",
    "yue": "中文",
    "en": "英文", "eng": "英文",
    "ja": "日文", "jpn": "日文", "jp": "日文",
}
SUPPORTED_ISO_LANGUAGES = ", ".join(sorted(
    {"cjy", "cmn", "en", "gan", "hak", "hsn", "ja", "nan", "wuu", "yue",
     "zh"}))
EOS_IDS = (151643, 151645)


@dataclass
class FrontendConfig(BaseModelArgs):
    fs: int = 16000
    window: str = "hamming"
    n_mels: int = 80
    frame_length: int = 25
    frame_shift: int = 10
    lfr_m: int = 7
    lfr_n: int = 6


@dataclass
class AdaptorConfig(BaseModelArgs):
    downsample_rate: int = 1
    ffn_dim: int = 2048
    llm_dim: int = 1024
    encoder_dim: int = 512
    n_layer: int = 2
    attention_heads: int = 8


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "fun_asr_nano"
    input_size: int = 560
    qwen_tokenizer_path: str = "Qwen3-0.6B"
    frontend_conf: Optional[dict] = None
    audio_encoder_conf: Optional[dict] = None
    audio_adaptor_conf: Optional[dict] = None
    text_config: Optional[dict] = None
    llm_config: Optional[dict] = None
    default_max_tokens: int = 512
    model_path: str = ""

    def __post_init__(self):
        self.frontend = FrontendConfig.from_dict(self.frontend_conf or {})
        self.enc = SenseVoiceEncoderConfig.from_dict(
            self.audio_encoder_conf or {})
        self.adaptor = AdaptorConfig.from_dict(
            self.audio_adaptor_conf or {})
        self.text = TextConfig.from_dict(
            self.text_config or self.llm_config or {})


def fake_token_length(speech_length: int) -> int:
    """The audio placeholder count of `speech_length` LFR frames."""
    olens = 1 + (int(speech_length) - 3 + 2) // 2
    olens = 1 + (olens - 3 + 2) // 2
    return max(1, (olens - 1) // 2 + 1)


def _normalise_text_for_join(text: str) -> str:
    return re.sub(r"\s+", " ", text.replace("/sil", " ")).strip()


# ---------------------------------------------------------------- adaptor

class AdaptorBlock(nn.Module):
    def __init__(self, a: AdaptorConfig):
        super().__init__()
        d = a.llm_dim
        self.self_attn = holder(linear_q=Linear(d, d), linear_k=Linear(d, d),
                                linear_v=Linear(d, d),
                                linear_out=Linear(d, d))
        self.feed_forward = holder(w_1=Linear(d, d // 4),
                                   w_2=Linear(d // 4, d))
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)


class Adaptor(nn.Module):
    def __init__(self, a: AdaptorConfig):
        super().__init__()
        self.cfg = a
        self.linear1 = Linear(a.encoder_dim * a.downsample_rate, a.ffn_dim)
        self.linear2 = Linear(a.ffn_dim, a.llm_dim)
        self.blocks = nn.ModuleList(AdaptorBlock(a)
                                    for _ in range(a.n_layer))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, encoder_dim), every row valid -> (B, ceil(T / k),
        llm_dim): the rows zero-padded to a multiple of k, as JAX's masked
        encoder rows are."""
        a = self.cfg
        b, t, d = x.shape
        k = a.downsample_rate
        x = F.pad(x, (0, 0, 0, (-t) % k)).reshape(b, -1, d * k)
        x = self.linear2(F.relu(self.linear1(x)))
        t2, nh = x.shape[1], a.attention_heads
        dh = a.llm_dim // nh
        for blk in self.blocks:
            sa = blk.self_attn
            h = blk.norm1(x)
            o = attention(sa.linear_q(h).reshape(b, t2, nh, dh),
                          sa.linear_k(h).reshape(b, t2, nh, dh),
                          sa.linear_v(h).reshape(b, t2, nh, dh))
            x = x + sa.linear_out(o.reshape(b, t2, a.llm_dim))
            ff = blk.feed_forward
            x = x + ff.w_2(F.relu(ff.w_1(blk.norm2(x))))
        return x


# ------------------------------------------------------------------ model

class Model(TorchModel):
    """Fun-ASR-Nano on `device`: the card by default; without CUDA the
    constructor raises unless given `device="cpu"`."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = ModelConfig.from_dict(kwargs) if kwargs else \
                ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        t = config.text
        with torch.device(device):
            self.audio_encoder = SANMEncoder(config.input_size, config.enc)
            self.audio_adaptor = Adaptor(config.adaptor)
            self.llm = holder(model=Qwen3LM(t))
            if not t.tie_word_embeddings:
                self.llm.lm_head = Linear(t.hidden_size, t.vocab_size,
                                          bias=False)
        self._tokenizer = None
        self._fns: Dict = {}
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return self.config.frontend.fs

    @property
    def dtype(self) -> torch.dtype:
        return self.llm.model.norm.weight.dtype

    # --------------------------------------------------------- features

    def _extract_features(self, audio: np.ndarray
                          ) -> Tuple[np.ndarray, int, int]:
        feats = kaldi_lfr_features(audio, self.config.frontend, self.device)
        return feats, feats.shape[0], fake_token_length(feats.shape[0])

    @torch.inference_mode()
    def get_audio_embeds(self, feats) -> torch.Tensor:
        """(T, input_size) LFR features -> (ceil(T / k), llm_dim) adaptor
        rows on the device."""
        x = torch.as_tensor(np.asarray(feats, np.float32),
                            device=self.device)[None]
        enc = self.audio_encoder(x.to(self.audio_encoder.tp_norm.weight
                                      .dtype))
        return self.audio_adaptor(enc)[0]

    # ----------------------------------------------------------- prompt

    @staticmethod
    def _map_language(language: Optional[str]) -> Optional[str]:
        if language is None:
            return None
        normalized = language.lower().replace("_", "-")
        if normalized in {"", "auto"}:
            return None
        if normalized in ISO_TO_PROMPT_LANGUAGE:
            return ISO_TO_PROMPT_LANGUAGE[normalized]
        if re.fullmatch(r"[a-z]{2,3}(?:-[a-z0-9]+)*", normalized):
            raise ValueError(
                "Unsupported ISO language for Fun-ASR-Nano: "
                f"{language!r}. Supported: {SUPPORTED_ISO_LANGUAGES}.")
        return language

    @staticmethod
    def _resolve_hotwords(hotwords: Optional[Iterable[str]],
                          context: Optional[str]) -> Optional[List[str]]:
        resolved = [w.strip() for w in (hotwords or []) if w.strip()]
        context = (context or "").strip()
        if resolved and context:
            raise ValueError("Pass either hotwords or context, not both.")
        if resolved:
            return resolved
        return [context] if context else None

    @staticmethod
    def _prompt_text(hotwords: Optional[Iterable[str]] = None,
                     language: Optional[str] = None,
                     itn: bool = True) -> str:
        hotwords = list(hotwords or [])
        prompt = ""
        if hotwords:
            prompt += ("请结合上下文信息，更加准确地完成语音转写任务。"
                       "如果没有相关信息，我们会留空。\n\n\n"
                       "**上下文信息：**\n\n\n")
            prompt += f"热词列表：[{', '.join(hotwords)}]\n"
        prompt += "语音转写" if language is None else f"语音转写成{language}"
        if not itn:
            prompt += "，不进行文本规整"
        return prompt + "："

    def _build_prompt_ids(self, fake_len: int, *, language, hotwords,
                          itn) -> Tuple[List[int], int]:
        label = self._map_language(language)
        user_prompt = self._prompt_text(hotwords, label, itn)
        before = ("<|im_start|>system\nYou are a helpful assistant."
                  f"<|im_end|>\n<|im_start|>user\n{user_prompt}")
        after = "<|im_end|>\n<|im_start|>assistant\n"
        if self._tokenizer is None:
            before_ids, after_ids = [1], [2]
        else:
            before_ids = list(self._tokenizer.encode(before))
            after_ids = list(self._tokenizer.encode(after))
        fbank_beg = len(before_ids)
        return before_ids + [0] * fake_len + after_ids, fbank_beg

    # ----------------------------------------------------------- decode

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.llm.model.embed_tokens(ids)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return lm_logits(self.llm, hidden)

    def _lm_forward(self, embeds, caches, offset, pad_mask):
        return qwen3_lm_forward(self.llm.model, embeds, caches, offset,
                                pad_mask)

    def _decode_fns(self, bucket: int, max_tokens: int, sampling):
        key = ("lm", bucket, max_tokens, tuple(sampling))
        fns = self._fns.get(key)
        if fns is None:
            (temperature, top_k, top_p, min_p, repetition_penalty,
             repetition_context_size, min_tokens_to_keep) = sampling
            t = self.config.text
            fns = make_decode_fns(
                text_config=t, embed_fn=self.embed, logits_fn=self.logits,
                forward_fn=self._lm_forward,
                make_caches=lambda cols: self.llm.model.make_caches(
                    t, 1, cols),
                bucket=bucket, max_new=max_tokens, temperature=temperature,
                top_k=top_k, top_p=top_p, min_p=min_p,
                min_tokens_to_keep=min_tokens_to_keep, eos_ids=EOS_IDS,
                repetition_penalty=repetition_penalty,
                repetition_context_size=repetition_context_size)
            self._fns = {key: fns}
        return fns

    @torch.inference_mode()
    def prompt_embeds(self, ids: List[int], fbank_beg: int,
                      audio_rows: torch.Tensor, fake_len: int,
                      bucket: int) -> torch.Tensor:
        """The prompt's token embeddings (1, bucket, D), right-padded with
        id 0, the first min(fake_len, rows) adaptor rows written at
        `fbank_beg`."""
        tok = torch.zeros(1, bucket, dtype=torch.long)
        tok[0, :len(ids)] = torch.as_tensor(ids, dtype=torch.long)
        embeds = self.embed(tok.to(self.device))
        m = min(fake_len, audio_rows.shape[0])
        embeds[0, fbank_beg:fbank_beg + m] = audio_rows[:m].to(embeds.dtype)
        return embeds

    def _decode_chunk(self, audio: np.ndarray, *, max_tokens, language,
                      hotwords, itn, sampling, seed):
        """One audio chunk: features, encoder and adaptor, prompt,
        prefill -> (the decode's generator of each chunk's kept tokens,
        prompt length); `last_run` gets the tower's ms and the decode's
        numbers."""
        t0 = time.perf_counter()
        feats, _, fake_len = self._extract_features(audio)
        rows = self.get_audio_embeds(feats)
        ids, fbank_beg = self._build_prompt_ids(
            fake_len, language=language, hotwords=hotwords, itn=itn)
        n = len(ids)
        pb = prompt_bucket(n)
        fns = self._decode_fns(pb, max_tokens, sampling)
        embeds = self.prompt_embeds(ids, fbank_beg, rows, fake_len, pb)
        self.last_run = {"audio_tokens": fake_len, "frames": feats.shape[0],
                         "encode_ms": (time.perf_counter() - t0) * 1e3}
        return iter_decode(fns, embeds, n, max_tokens=max_tokens, seed=seed,
                           run=self.last_run), n

    def _transcribe_chunk(self, audio: np.ndarray, **kw
                          ) -> Tuple[str, int, List[int]]:
        gen, n = self._decode_chunk(audio, **kw)
        toks: List[int] = []
        for new in gen:
            toks.extend(new)
        toks = toks[:kw["max_tokens"]]
        text = (self._tokenizer.decode(toks, skip_special_tokens=True)
                if self._tokenizer is not None
                else " ".join(map(str, toks)))
        return _normalise_text_for_join(text), n, toks

    def generate(self, audio, *, max_tokens: Optional[int] = None,
                 language: Optional[str] = None,
                 hotwords: Optional[Iterable[str]] = None,
                 context: Optional[str] = None, itn: bool = True,
                 chunk_duration: float = 1200.0,
                 min_chunk_duration: float = 1.0,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, min_p: float = 0.0,
                 repetition_penalty: float = 1.0,
                 repetition_context_size: int = 20,
                 min_tokens_to_keep: int = 1, seed: int = 0,
                 verbose: bool = False, **kwargs) -> STTOutput:
        t0 = time.time()
        sampling = (float(temperature), int(top_k), float(top_p),
                    float(min_p), float(repetition_penalty),
                    int(repetition_context_size), int(min_tokens_to_keep))
        max_tokens = int(max_tokens or self.config.default_max_tokens)
        hotwords = self._resolve_hotwords(hotwords, context)
        wav = as_audio(audio, self.sample_rate)
        chunks = split_audio_into_chunks(
            wav, sr=self.sample_rate, chunk_duration=chunk_duration,
            min_chunk_duration=min_chunk_duration)
        texts, segments = [], []
        p_toks = g_toks = 0
        remaining = max_tokens
        for i, (chunk_audio, offset_sec) in enumerate(chunks):
            if remaining <= 0:
                break
            text, p, toks = self._transcribe_chunk(
                chunk_audio, max_tokens=remaining, language=language,
                hotwords=hotwords, itn=itn, sampling=sampling, seed=seed + i)
            segments.append({
                "text": text, "start": offset_sec,
                "end": offset_sec + len(chunk_audio) / self.sample_rate,
                "language": language})
            texts.append(text)
            p_toks += p
            g_toks += len(toks)
            remaining -= len(toks)
        dt = time.time() - t0
        text = " ".join(t for t in texts if t).strip()
        if verbose:
            print(text)
        return STTOutput(
            text=text, segments=segments, language=language,
            prompt_tokens=p_toks, generation_tokens=g_toks,
            total_tokens=p_toks + g_toks, total_time=dt,
            prompt_tps=p_toks / dt if dt > 0 else 0.0,
            generation_tps=g_toks / dt if dt > 0 else 0.0)

    __call__ = generate

    # ---------------------------------------------------------- loading

    def model_quant_predicate(self, path: str, leaf) -> bool:
        return path.startswith("llm.model")

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """The `module.` prefix dropped, a tied `llm.lm_head.weight`
        dropped, the memory convs to WIO (from the layout their shape
        shows); `load_jax_params` takes it from there."""
        tied = self.config.text.tie_word_embeddings
        out = {}
        for k, v in weights.items():
            if k.startswith("module."):
                k = k[len("module."):]
            if k == "llm.lm_head.weight" and tied:
                continue
            out[k] = v
        return sanm_sanitize(self, out)

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The Qwen3 tokenizer from `<dir>/<qwen_tokenizer_path>` (else the
        directory): None without tokenizer files or `transformers`; files
        that fail to load raise."""
        path = Path(model_path) / model.config.qwen_tokenizer_path
        if not path.exists():
            path = Path(model_path)
        model._tokenizer = local_tokenizer(path, trust_remote_code=True)
        return model


__all__ = ["Model", "ModelConfig", "Adaptor", "fake_token_length",
           "EOS_IDS"]
