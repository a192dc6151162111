"""Sesame CSM-1B: a llama backbone and a llama depth decoder over Mimi's
32 codebooks, with voice cloning from a reference segment.

Counterpart of mlx_audio_tpu/tts/models/sesame/sesame.py:

* `ModelConfig` with the HF `csm` schema and `llama_configs` (:44-121), on
  the port's llama backbone (`llama_forward`);
* `sanitize` / `_remap_hf` for torchtune and HF
  `CsmForConditionalGeneration` names; an embedded `codec_model.*` is
  stashed, and `post_load_hook` builds it into a Mimi (:165-252);
* `Segment`, `build_prompt`, `_audio_rows`, `_text_rows`, `_segment_rows`,
  `default_speaker_prompt` and voice_match (:358-457): a prompt row holds
  32 audio codes and one text token, with a mask of which are present;
* `prefill` (:654-706): the prompt over its power-of-two bucket into f32
  backbone caches of MAX_CACHE_LEN columns under an additive pad mask, then
  the first frame;
* a frame (:270-312): a backbone step, codebook 0 from `codebook0_head`,
  then 31 depth-decoder steps on a 34-column cache of their own (the
  first takes the backbone's hidden state and codebook 0's embedding; the
  table is `decoder_audio_embeddings` when the checkpoint has one, else
  the backbone's audio table), each sampled from `audio_head`;
* `chunk` (:314-356, 459-497): up to CHUNK_FRAMES eager frames in place of
  JAX's `lax.scan`, every frame's state on the device; each frame's
  finished flag is copied to the host without blocking
  (`ops/host_flags.py`) and a chunk stops STEPS_AFTER_EOS frames after
  the one that samples EOS on codebook 0; the frames are read once a
  chunk;
* `generate` and `_run_segment` (:499-652): ref_audio/ref_text become the
  context segment (through the Mimi encoder), `voice` a local
  prompts/{voice}.wav preset, voice_match merges the context's text with
  the prompt over its audio without an EOS frame, `split_pattern` yields
  one result stream per segment; audio by Mimi `decode`, or streamed by
  `decode_step` every `streaming_interval`, into a stream state sized
  (max_frames + 8) x downsample_stride.

The codec is a separate Mimi (`set_codec`, or `post_load_hook` from the
checkpoint's codec_model.*, or `generate(mimi=...)`), kept in f32 whatever
the backbone's dtype. Without one, `generate` returns the code frames in
`result.prompt["codes"]` and silence of their length.

Departures from the JAX package:

* the prompt-length check (a prompt of MAX_CACHE_LEN - max_frames rows or
  more raises ValueError) applies to `text_ids` too, which JAX lets write
  past its cache;
* a chunk runs at most the frames the request has left (JAX runs whole
  chunks of 16 and drops the frames past `max_audio_length_ms`);
* an HF checkpoint without a `codec_config` builds its Mimi at
  `mimi_202407(audio_num_codebooks)` (JAX: the 16-book default);
* the audio vocabulary (2,051) is wider than Mimi's codebooks (2,048): a
  sampled code past them is clamped to the last codebook row before the
  decode, explicitly, where JAX's gather clamps it silently (the same
  audio);
* a bf16 model computes in bf16 against its f32 caches (attended in f32),
  where JAX promotes the residual stream to f32;
* draws come from a torch.Generator, so only greedy runs compare with JAX;
* a backbone or depth-decoder config whose `rope_scaling` names llama3
  (the HF csm checkpoint's) rotates by Llama-3's scaled frequencies
  (`llama.llama_inv_freq`), where JAX keeps only the flavour's fields and
  rotates by the plain ones.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device
from ....nn import Embedding, Linear, RMSNorm
from ....ops.host_flags import FinishedFlags
from ....ops.kvcache import KVCache
from ....ops.sampling import sample
from ..base import (GenerationResult, format_duration, local_tokenizer,
                    peak_memory_gb)
from ..llama.llama import DecoderLayer, llama_forward, llama_inv_freq
from ..llama.llama import ModelConfig as LlamaConfig

MAX_CACHE_LEN = 2048
CHUNK_FRAMES = 16      # about 1.28 s of audio at 12.5 Hz
# frames a chunk may run past the one whose finished flag is set: the loop
# reads the flag of frame i-1 before launching frame i+1
STEPS_AFTER_EOS = 1


@dataclass
class Segment:
    speaker: int
    text: str
    audio: Optional[np.ndarray] = None  # (T,) at 24 kHz


_FLAVORS = {
    "llama-1B": dict(hidden_size=2048, num_hidden_layers=16,
                     intermediate_size=8192, num_attention_heads=32,
                     num_key_value_heads=8, head_dim=64,
                     rope_theta=500000.0),
    "llama-100M": dict(hidden_size=1024, num_hidden_layers=4,
                       intermediate_size=8192, num_attention_heads=8,
                       num_key_value_heads=2, head_dim=128,
                       rope_theta=500000.0),
}


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "sesame"
    backbone_flavor: str = "llama-1B"
    decoder_flavor: str = "llama-100M"
    text_vocab_size: int = 128256
    audio_vocab_size: int = 2051
    audio_num_codebooks: int = 32
    audio_eos_token_id: int = 0
    codebook_eos_token_id: int = 0
    sample_rate: int = 24000
    backbone_config: Optional[dict] = None
    depth_decoder_config: Optional[dict] = None
    codec_config: Optional[dict] = None
    model_path: str = ""
    # generation-policy flags (the reference's sesame.py:459-466)
    voice_match: bool = True
    use_default_voice_prompt: bool = True
    speaker_prefix_space: bool = False

    @classmethod
    def from_dict(cls, config: dict):
        """This package's schema, or the HF transformers `CsmConfig` flat
        one (the sesame/csm-1b hub repo: backbone dims at the top level,
        nested depth_decoder_config and codec_config, vocab_size the audio
        codebooks' vocabulary)."""
        if isinstance(config, dict) and (
                config.get("model_type") == "csm"
                or "num_codebooks" in config):
            bb_keys = ("hidden_size", "num_hidden_layers",
                       "num_attention_heads", "num_key_value_heads",
                       "head_dim", "intermediate_size", "rope_theta",
                       "rms_norm_eps", "max_position_embeddings",
                       "rope_scaling")
            return cls(
                text_vocab_size=config.get("text_vocab_size", 128256),
                audio_vocab_size=config.get("vocab_size", 2051),
                audio_num_codebooks=config.get("num_codebooks", 32),
                codebook_eos_token_id=config.get("codebook_eos_token_id", 0),
                audio_eos_token_id=config.get("codebook_eos_token_id", 0),
                backbone_config={k: config[k] for k in bb_keys
                                 if config.get(k) is not None},
                depth_decoder_config=config.get("depth_decoder_config"),
                codec_config=config.get("codec_config"),
                model_path=config.get("model_path", ""),
                voice_match=config.get("voice_match", True),
                use_default_voice_prompt=config.get(
                    "use_default_voice_prompt", True),
                speaker_prefix_space=config.get("speaker_prefix_space",
                                                False))
        return super().from_dict(config)

    def llama_configs(self) -> Tuple[LlamaConfig, LlamaConfig]:
        bb = dict(_FLAVORS[self.backbone_flavor])
        dec = dict(_FLAVORS[self.decoder_flavor])
        if self.backbone_config:
            bb.update({k: v for k, v in self.backbone_config.items()
                       if k in LlamaConfig.__dataclass_fields__})
        if self.depth_decoder_config:
            dec.update({k: v for k, v in self.depth_decoder_config.items()
                        if k in LlamaConfig.__dataclass_fields__})
        bb["vocab_size"] = 1  # the embeddings are the model's own
        dec["vocab_size"] = 1
        return LlamaConfig(**bb), LlamaConfig(**dec)


class Stack(nn.Module):
    """A llama layer stack and final norm without a token table or head
    (init_llama's "model" tree less embed_tokens): what `llama_forward`
    takes, under the names backbone.layers.N... / decoder.layers.N..."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.config = cfg
        self.layers = nn.ModuleList(DecoderLayer(cfg)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.register_buffer("inv_freq", llama_inv_freq(cfg),
                             persistent=False)

    @property
    def model(self) -> "Stack":
        return self


@dataclass
class FrameCarry:
    """The frame loop's state, all of it on the device but the write
    position."""

    caches: KVCache              # backbone, f32, MAX_CACHE_LEN columns
    dec_caches: KVCache          # depth decoder, audio_num_codebooks + 2
    embed: torch.Tensor          # (B, 1, D) the next backbone input
    pos: int                     # backbone cache write position
    finished: torch.Tensor       # (B,) bool


class Model(TorchModel):
    """CSM voice-cloning TTS on `device`: the card by default; without CUDA
    the constructor raises unless given `device="cpu"`."""

    def __init__(self, config: Union[ModelConfig, dict, None] = None,
                 device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = ModelConfig.from_dict(kwargs) if kwargs else \
                ModelConfig()
        elif isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config)
        c = config
        self.bb_cfg, self.dec_cfg = c.llama_configs()
        d_bb, d_dec = self.bb_cfg.hidden_size, self.dec_cfg.hidden_size
        with torch.device(device):
            self.backbone = Stack(self.bb_cfg)
            self.decoder = Stack(self.dec_cfg)
            self.text_embeddings = Embedding(c.text_vocab_size, d_bb)
            self.audio_embeddings = Embedding(
                c.audio_vocab_size * c.audio_num_codebooks, d_bb)
            self.projection = Linear(d_bb, d_dec, bias=False)
            self.codebook0_head = Linear(d_bb, c.audio_vocab_size,
                                         bias=False)
            self.audio_head = nn.Parameter(torch.empty(
                c.audio_num_codebooks - 1, d_dec, c.audio_vocab_size))
        self.requires_grad_(False)
        self.eval()
        self.tokenizer = None
        # the codec and the HF checkpoint's codec weights, outside the
        # module tree (the JAX package keeps the Mimi apart from params)
        self.__dict__["_mimi"] = None
        self.__dict__["_hf_codec_weights"] = None
        self.last_run: Dict[str, float] = {}

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    def set_codec(self, mimi) -> "Model":
        """Use `mimi` (a codec.models.mimi.Mimi) to encode reference
        segments and decode audio."""
        self.__dict__["_mimi"] = mimi
        return self

    @torch.no_grad()
    def init_params(self, seed: int = 0, on_device: bool = False) -> "Model":
        """As TorchModel's, with `audio_head` N(0, 0.02) (init_params,
        :159-162)."""
        super().init_params(seed, on_device=on_device)
        dev = self.audio_head.device if on_device else torch.device("cpu")
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        self.audio_head.copy_(0.02 * torch.randn(
            self.audio_head.shape, generator=g, device=dev,
            dtype=self.audio_head.dtype if on_device else torch.float32))
        return self

    def bind(self, state) -> "Model":
        """A state holding `decoder_audio_embeddings` (an untied HF
        fine-tune's depth-decoder table) adds that table first."""
        if "decoder_audio_embeddings.weight" in state \
                and "decoder_audio_embeddings" not in self._modules:
            with torch.device(self.device):
                self.decoder_audio_embeddings = Embedding(
                    *np.shape(state["decoder_audio_embeddings.weight"]))
            self.decoder_audio_embeddings.requires_grad_(False)
        return super().bind(state)

    # -- weights -------------------------------------------------------------

    def _remap_hf(self, weights: Dict) -> Dict:
        """HF `CsmForConditionalGeneration` names -> this tree; the embedded
        Mimi (codec_model.*) is stashed for post_load_hook."""
        out, codec = {}, {}
        for k, w in weights.items():
            if k.startswith("codec_model."):
                codec[k[len("codec_model."):]] = w
            elif k == "backbone_model.embed_tokens.embed_audio_tokens.weight":
                out["audio_embeddings.weight"] = w
            elif k == "embed_text_tokens.weight":
                out["text_embeddings.weight"] = w
            elif k == "lm_head.weight":
                out["codebook0_head.weight"] = w
            elif k == "depth_decoder.model.inputs_embeds_projector.weight":
                out["projection.weight"] = w
            elif k == "depth_decoder.codebooks_head.weight":
                out["audio_head"] = w
            elif k == "depth_decoder.model.embed_tokens.weight":
                out["decoder_audio_embeddings.weight"] = w
            elif k.startswith("depth_decoder.model."):
                out["decoder." + k[len("depth_decoder.model."):]] = w
            elif k.startswith("backbone_model."):
                out["backbone." + k[len("backbone_model."):]] = w
            else:
                out[k] = w
        self.__dict__["_hf_codec_weights"] = codec or None
        return out

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """CSM checkpoint names -> this tree: the torchtune layout
        (attn/output_proj, mlp.w1/w2/w3, sa_norm/mlp_norm `scale`) and the
        HF CSM one (backbone_model/depth_decoder/codec_model); a converted
        tree passes through. Rotary buffers and KV caches are dropped."""
        if any(k.startswith(("backbone_model.", "depth_decoder."))
               for k in weights):
            weights = self._remap_hf(weights)
        out = {}
        for k, w in weights.items():
            if "rotary_emb" in k or k.endswith((".kv_cache.k_cache",
                                                ".kv_cache.v_cache")):
                continue
            if k.startswith("model."):
                k = k[len("model."):]
            if ".attn." in k:
                k = k.replace(".attn.", ".self_attn.").replace(
                    ".output_proj.", ".o_proj.")
            if ".mlp." in k:
                k = (k.replace(".mlp.w1.", ".mlp.gate_proj.")
                      .replace(".mlp.w2.", ".mlp.down_proj.")
                      .replace(".mlp.w3.", ".mlp.up_proj."))
            if ".sa_norm." in k:
                k = k.replace(".sa_norm.", ".input_layernorm.").replace(
                    ".scale", ".weight")
            elif ".mlp_norm." in k:
                k = k.replace(".mlp_norm.", ".post_attention_layernorm.") \
                    .replace(".scale", ".weight")
            elif k in ("backbone.norm.scale", "decoder.norm.scale"):
                k = k.replace(".scale", ".weight")
            out[k] = np.asarray(w)
        return out

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The tokenizer from the model directory (never downloaded), and
        the checkpoint's embedded Mimi, built in f32 on the model's
        device."""
        model.tokenizer = local_tokenizer(model_path)
        codec = model._hf_codec_weights
        if codec is not None and model._mimi is None:
            from ....codec.models.mimi import Mimi, mimi_202407

            cfg = (model.config.codec_config
                   or mimi_202407(model.config.audio_num_codebooks))
            mimi = Mimi(cfg, device=model.device)
            model.set_codec(mimi.bind(mimi.sanitize(codec)))
            model.__dict__["_hf_codec_weights"] = None
        return model

    # -- embeddings ----------------------------------------------------------

    def _dtype(self) -> torch.dtype:
        return self.text_embeddings.weight.dtype

    def _embed_frame_tokens(self, tokens: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
        """tokens (B, T, ncb + 1) int, mask (B, T, ncb + 1) bool -> the
        masked sum of their embeddings (B, T, D). Slots :ncb are audio
        codes (codebook i at rows i * vocab ...), the last a text token
        (:254-266)."""
        c = self.config
        text = self.text_embeddings(tokens[:, :, -1])
        offsets = torch.arange(c.audio_num_codebooks,
                               device=tokens.device) * c.audio_vocab_size
        audio = self.audio_embeddings(tokens[:, :, :-1] + offsets)
        embeds = torch.cat([audio, text[:, :, None]], dim=2)
        return (embeds * mask[..., None].to(embeds.dtype)).sum(dim=2)

    def _frame_embed(self, frame: torch.Tensor) -> torch.Tensor:
        """A generated frame (B, ncb) as the next backbone input (B, 1, D):
        its audio slots, the text slot masked."""
        b, ncb = frame.shape
        toks = torch.cat([frame, frame.new_zeros(b, 1)], dim=-1)[:, None]
        mask = torch.ones(b, 1, ncb + 1, dtype=torch.bool,
                          device=frame.device)
        mask[..., -1] = False
        return self._embed_frame_tokens(toks, mask)

    # -- the frame -----------------------------------------------------------

    def _decode_frame(self, last_h: torch.Tensor, c0: torch.Tensor,
                      dec_caches: KVCache, sampler) -> torch.Tensor:
        """Codebooks 1..ncb-1 from the backbone's hidden state (B, D) and
        codebook 0 (B,) -> the frame (B, ncb) (:270-312). The 34-column
        cache is rewritten from column 0 each frame; no step reads a column
        this frame did not write."""
        c = self.config
        table = self._modules.get("decoder_audio_embeddings",
                                  self.audio_embeddings)
        curr = torch.cat([last_h[:, None], table(c0[:, None])], dim=1)
        samples, offset = [c0], 0
        for i in range(1, c.audio_num_codebooks):
            h, _ = llama_forward(self.decoder, self.projection(curr),
                                 caches=dec_caches, offset=offset)
            offset += curr.shape[1]
            logits = h[:, -1] @ self.audio_head[i - 1].to(h.dtype)
            ci = sampler(logits)
            samples.append(ci)
            curr = table((ci + i * c.audio_vocab_size)[:, None])
        return torch.stack(samples, dim=-1)

    def _frame(self, carry: FrameCarry, last_h: torch.Tensor, sampler):
        """Codebook 0 from last_h (B, D), the depth decoder, the next
        embed; advances `carry` in place. -> the frame (B, ncb)."""
        c0 = sampler(self.codebook0_head(last_h))
        frame = self._decode_frame(last_h, c0, carry.dec_caches, sampler)
        carry.finished = carry.finished | (c0 == self.config
                                           .codebook_eos_token_id)
        carry.embed = self._frame_embed(frame)
        return frame

    @torch.no_grad()
    def prefill(self, tokens: np.ndarray, mask: np.ndarray, sampler
                ) -> Tuple[FrameCarry, torch.Tensor]:
        """The prompt rows (B, P, ncb + 1) and mask, right-padded to their
        power-of-two bucket, through the backbone into f32 caches under an
        additive pad mask over all MAX_CACHE_LEN columns, then the first
        frame (:654-706). -> (carry, frame (B, ncb))."""
        c, bb, dec = self.config, self.bb_cfg, self.dec_cfg
        b, plen = tokens.shape[:2]
        pb = 1 << max(4, (plen - 1).bit_length())
        if pb > MAX_CACHE_LEN:
            raise ValueError(f"a prompt of {plen} rows exceeds the "
                             f"{MAX_CACHE_LEN}-column cache")
        dev = self.device
        toks = torch.zeros(b, pb, tokens.shape[2], dtype=torch.long)
        msk = torch.zeros(b, pb, tokens.shape[2], dtype=torch.bool)
        toks[:, :plen] = torch.as_tensor(np.asarray(tokens), dtype=torch.long)
        msk[:, :plen] = torch.as_tensor(np.asarray(mask), dtype=torch.bool)
        embeds = self._embed_frame_tokens(toks.to(dev), msk.to(dev))
        caches = KVCache.init(b, MAX_CACHE_LEN, bb.num_key_value_heads,
                              bb.resolved_head_dim, torch.float32, dev,
                              n_layers=bb.num_hidden_layers)
        pad = torch.zeros(b, MAX_CACHE_LEN, device=dev)
        pad[:, plen:] = float("-inf")
        h, _ = llama_forward(self.backbone, embeds, caches=caches, offset=0,
                             mask=pad)
        carry = FrameCarry(
            caches=caches,
            dec_caches=KVCache.init(b, c.audio_num_codebooks + 2,
                                    dec.num_key_value_heads,
                                    dec.resolved_head_dim, h.dtype, dev,
                                    n_layers=dec.num_hidden_layers),
            embed=embeds[:, :1], pos=plen,
            finished=torch.zeros(b, dtype=torch.bool, device=dev))
        return carry, self._frame(carry, h[:, plen - 1], sampler)

    @torch.no_grad()
    def chunk(self, carry: FrameCarry, n: int, sampler):
        """Up to n frames from `carry` (advanced in place): before frame i
        (i > STEPS_AFTER_EOS) the host waits for frame i-1-STEPS_AFTER_EOS's
        finished flags and stops if every row had finished. -> (frames
        (k, B, ncb), finished (k, B)) on the device, k the frames run."""
        frames, fins = [], []
        flags = FinishedFlags(n, carry.finished)
        lag = STEPS_AFTER_EOS + 1
        for i in range(n):
            if i >= lag and bool(flags.read(i - lag).all()):
                break
            h, _ = llama_forward(self.backbone, carry.embed,
                                 caches=carry.caches, offset=carry.pos)
            carry.pos += 1
            frames.append(self._frame(carry, h[:, -1], sampler))
            fins.append(carry.finished)
            flags.record(i, carry.finished)
        return torch.stack(frames), torch.stack(fins)

    def _sampler(self, temperature: float, top_k: int, seed: int):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return lambda logits: sample(logits, temperature, top_k=top_k,
                                     generator=gen)

    def _frame_stream(self, tokens, mask, temperature: float, top_k: int,
                      max_frames: int, seed: int):
        """The frame loop; yields numpy code-frame batches (k, ncb), one
        read a chunk."""
        sampler = self._sampler(temperature, top_k, seed)
        carry, first = self.prefill(tokens, mask, sampler)
        chunks = 0
        done = bool(carry.finished.any())
        n = 0
        if not done:
            yield first.cpu().numpy()
            n = 1
        while not done and n < max_frames:
            frames, fins = self.chunk(carry, min(CHUNK_FRAMES,
                                                 max_frames - n), sampler)
            chunks += 1
            fr = frames.cpu().numpy()[:, 0]          # the chunk's one read
            fi = fins.cpu().numpy()[:, 0]
            k = int(np.argmax(fi)) if fi.any() else len(fr)
            if k > 0:
                yield fr[:k]
            n += k
            done = bool(fi.any())
        self.last_run.update(prompt_len=tokens.shape[1], frames=n,
                            chunks=chunks)

    # -- prompt assembly -----------------------------------------------------

    def _tokenize_text_segment(self, text: str, speaker: int) -> np.ndarray:
        if self.tokenizer is None:
            raise ValueError("No tokenizer; pass text_ids instead.")
        if self.config.speaker_prefix_space:
            return np.asarray(self.tokenizer.encode(
                f"[{speaker}] {text.lstrip()}"))
        return np.asarray(self.tokenizer.encode(f"[{speaker}]{text}"))

    def build_prompt(self, text_ids: np.ndarray,
                     context_frames: Optional[np.ndarray] = None):
        """-> (tokens (1, T, ncb + 1) int32, mask (1, T, ncb + 1) bool):
        voice-clone context frames (T_ctx, ncb) in the audio slots, then
        the text tokens in the text slot (:367-391)."""
        rows, masks = [], []
        if context_frames is not None:
            r, m = self._audio_rows(context_frames, add_eos=False)
            rows.append(r)
            masks.append(m)
        ids = np.asarray(text_ids, np.int32).reshape(-1)
        r = np.zeros((len(ids), self.config.audio_num_codebooks + 1),
                     np.int32)
        r[:, -1] = ids
        m = np.zeros_like(r, bool)
        m[:, -1] = True
        return (np.concatenate(rows + [r], axis=0)[None],
                np.concatenate(masks + [m], axis=0)[None])

    def _audio_rows(self, frames: np.ndarray, add_eos: bool = True):
        """Code frames (T, ncb) -> prompt rows and mask (T[+1], ncb + 1) in
        the audio slots, with an all-zero EOS frame if `add_eos`
        (:395-409)."""
        c = self.config
        frames = np.asarray(frames, np.int32)
        if add_eos:
            frames = np.concatenate(
                [frames, np.zeros((1, frames.shape[1]), np.int32)], axis=0)
        rows = np.zeros((frames.shape[0], c.audio_num_codebooks + 1),
                        np.int32)
        rows[:, :c.audio_num_codebooks] = frames
        mask = np.zeros_like(rows, bool)
        mask[:, :c.audio_num_codebooks] = True
        return rows, mask

    def _text_rows(self, text: str, speaker: int):
        ids = np.asarray(self._tokenize_text_segment(text, speaker),
                         np.int32).reshape(-1)
        rows = np.zeros((len(ids), self.config.audio_num_codebooks + 1),
                        np.int32)
        rows[:, -1] = ids
        mask = np.zeros_like(rows, bool)
        mask[:, -1] = True
        return rows, mask

    def _encode_frames(self, audio) -> np.ndarray:
        """A clip -> its Mimi code frames (T, ncb)."""
        if self._mimi is None:
            raise RuntimeError(
                "voice-clone context requires the Mimi codec (load a "
                "checkpoint that embeds it, or set_codec)")
        return self._mimi.encode(audio)[0].T.cpu().numpy()

    def _segment_rows(self, segment: Segment, add_eos: bool = True):
        """[the segment's text rows, its audio rows (+ EOS)] (:421-434)."""
        tr, tm = self._text_rows(segment.text, segment.speaker)
        if segment.audio is None:
            return tr, tm
        ar, am = self._audio_rows(self._encode_frames(segment.audio),
                                  add_eos=add_eos)
        return (np.concatenate([tr, ar], axis=0),
                np.concatenate([tm, am], axis=0))

    def default_speaker_prompt(self, voice: str) -> List[Segment]:
        """An offline voice preset: prompts/{voice}.wav and its .txt
        transcript in the model directory (:436-457)."""
        base = Path(self.config.model_path or ".") / "prompts"
        wav, txt = base / f"{voice}.wav", base / f"{voice}.txt"
        if not wav.exists():
            raise ValueError(
                f"voice preset '{voice}' not found: place {wav} (and "
                f"{txt.name}) in the model directory, or pass "
                "ref_audio/ref_text")
        if not txt.exists():
            raise ValueError(
                f"voice preset '{voice}' is missing its transcript {txt}")
        from ....utils import load_audio

        audio = load_audio(str(wav), sample_rate=self.sample_rate)
        return [Segment(speaker=0, text=txt.read_text().strip(),
                        audio=np.asarray(audio))]

    # -- generation ----------------------------------------------------------

    def generate(self, text=None, voice: Optional[str] = None, *,
                 text_ids: Optional[np.ndarray] = None, speaker: int = 0,
                 context: Optional[List[Segment]] = None,
                 context_frames: Optional[np.ndarray] = None,
                 split_pattern: Optional[str] = r"\n+",
                 temperature: float = 0.9, top_k: int = 50,
                 max_audio_length_ms: float = 90_000, ref_audio=None,
                 ref_text: Optional[str] = None, stream: bool = False,
                 streaming_interval: float = 0.5,
                 voice_match: Optional[bool] = None, seed: int = 0,
                 mimi=None, **kwargs):
        """Yield GenerationResults (:499-594): `ref_audio` + `ref_text`
        become the context segment; `voice` loads a local prompts/{voice}
        preset; voice_match merges the context's and the prompt's text over
        the context audio (no EOS frame); `split_pattern` yields one
        result stream per segment (seed + segment index); `stream=True`
        yields audio every `streaming_interval` seconds through Mimi's
        causal streaming decoder, equal to the whole decode. `mimi`
        overrides the model's codec; the code frames ride
        `result.prompt["codes"]`. `text_ids` skips the tokenizer (context
        segments' audio, or `context_frames`, before them)."""
        if voice_match is None:
            voice_match = self.config.voice_match
        mimi = mimi or self._mimi
        max_frames = int(max_audio_length_ms / 80)
        interval_frames = max(1, int(streaming_interval * 12.5))
        self.last_run = {}
        if text_ids is not None:
            if context and context_frames is None and self._mimi is not None:
                enc = [self._encode_frames(s.audio) for s in context
                       if s.audio is not None]
                if enc:
                    context_frames = np.concatenate(enc, axis=0)
            tokens, mask = self.build_prompt(text_ids, context_frames)
            yield from self._run_segment(tokens, mask, 0, temperature, top_k,
                                         max_frames, seed, stream,
                                         interval_frames, mimi)
            return
        if ref_audio is not None and not isinstance(ref_audio, np.ndarray):
            from ....utils import load_audio

            ref_audio = np.asarray(load_audio(ref_audio,
                                              sample_rate=self.sample_rate))
        context = list(context or [])
        if not context and ref_audio is not None and ref_text is not None:
            context = [Segment(speaker=speaker, text=ref_text,
                               audio=ref_audio)]
        elif (not context and ref_audio is None
              and self.config.use_default_voice_prompt and voice is not None):
            context = self.default_speaker_prompt(voice)
        if isinstance(text, str):
            prompts = ([p for p in re.split(split_pattern, text.strip())
                        if p.strip()] if split_pattern else [text])
        else:
            prompts = list(text)
        for seg_idx, prompt in enumerate(prompts):
            current = list(context)
            if voice_match and current:
                current = [Segment(speaker=speaker,
                                   text=(current[0].text + " " + prompt)
                                   .strip(), audio=current[0].audio)]
            rows, masks = [], []
            for s in current:
                r, m = self._segment_rows(s, add_eos=not voice_match)
                rows.append(r)
                masks.append(m)
            if not voice_match or not current:
                r, m = self._text_rows(prompt, speaker)
                rows.append(r)
                masks.append(m)
            tokens = np.concatenate(rows, axis=0)[None]
            mask = np.concatenate(masks, axis=0)[None]
            yield from self._run_segment(tokens, mask, seg_idx, temperature,
                                         top_k, max_frames, seed + seg_idx,
                                         stream, interval_frames, mimi)

    def _run_segment(self, tokens, mask, seg_idx, temperature, top_k,
                     max_frames, seed, stream, interval_frames, mimi):
        if tokens.shape[1] >= MAX_CACHE_LEN - max_frames:
            raise ValueError("Inputs too long, must be below "
                             f"{MAX_CACHE_LEN - max_frames} frames")
        t0 = time.time()
        plen = tokens.shape[1]
        ncb = self.config.audio_num_codebooks
        pending: List[np.ndarray] = []
        all_codes: List[np.ndarray] = []
        state = None

        def result(audio, codes_n, final):
            nonlocal t0
            seg_time = time.time() - t0
            dur = len(audio) / self.sample_rate
            r = GenerationResult(
                audio=audio, samples=len(audio),
                sample_rate=self.sample_rate, segment_idx=seg_idx,
                token_count=codes_n, audio_duration=format_duration(dur),
                real_time_factor=round(seg_time / dur, 3) if dur else 0.0,
                prompt={"tokens": int(plen), "tokens-per-sec":
                        round(plen / seg_time, 2) if seg_time else 0,
                        "codes": np.concatenate(all_codes, axis=0)
                        if all_codes else np.zeros((0, ncb), np.int32)},
                audio_samples={"samples": len(audio), "samples-per-sec":
                               round(len(audio) / seg_time, 2)
                               if seg_time else 0},
                processing_time_seconds=seg_time,
                peak_memory_usage=peak_memory_gb(),
                is_streaming_chunk=stream and not final,
                is_final_chunk=final)
            t0 = time.time()
            return r

        def codec_codes(frames):
            """(T, ncb) frames -> (1, ncb, T) codes inside Mimi's
            codebooks."""
            return np.clip(frames, 0, mimi.config.quantizer_bins - 1).T[None]

        def decode_pending(final):
            nonlocal state, pending
            frames = np.concatenate(pending, axis=0)
            if state is None:
                # counted in transformer frames, after the upsample
                state = mimi.init_decode_stream_state(
                    1, (max_frames + 8) * mimi.downsample_stride)
            state, audio = mimi.decode_step(state, codec_codes(frames))
            pending = []
            return result(audio[0, 0].float().cpu().numpy(), len(frames),
                          final)

        for batch in self._frame_stream(tokens, mask, temperature, top_k,
                                        max_frames, seed):
            all_codes.append(batch)
            pending.append(batch)
            if stream and mimi is not None and \
                    sum(len(p) for p in pending) >= interval_frames:
                yield decode_pending(False)
        if stream and mimi is not None:
            if pending:
                yield decode_pending(True)
            return
        codes = (np.concatenate(all_codes, axis=0) if all_codes
                 else np.zeros((0, ncb), np.int32))
        if mimi is not None and len(codes):
            audio = mimi.decode(codec_codes(codes))[0, 0].float().cpu() \
                .numpy()
        else:
            audio = np.zeros((len(codes) * 1920,), np.float32)
        yield result(audio, len(codes), final=True)


__all__ = ["Model", "ModelConfig", "Segment", "Stack", "FrameCarry",
           "MAX_CACHE_LEN", "CHUNK_FRAMES"]
