"""LFM2.5-Audio: an omni-modal audio LM (text and audio in; text and
audio out, interleaved or in turn).

Counterpart of mlx_audio_tpu/sts/models/lfm_audio/lfm_audio.py:

* the configs and the special tokens (copied);
* the audio encoder, the port's FastConformer
  (`stt/models/parakeet/conformer.py`), and the MLP adapter
  (`encode_audio` :317); the LFM2 backbone (`lfm2.py`);
  `_build_embeddings` (:341), which places the text, audio-in and
  audio-out embeddings by modality;
* the depthformer frame sampler (`sample_audio_frame` :186): JAX's
  `lax.scan` over the 8 codebooks with an 8-slot KV cache is an eager loop
  over the codebooks here, the cache allocated once a request;
  `embed_audio_codes` (:227);
* `generate_interleaved` (:464; 6 text and 12 audio tokens in turn),
  `generate_sequential` (:533), `generate_from_chat_state` (:583),
  `generate` (:593), `sanitize` (:666), `post_load_hook` (:759) and
  `offset_cap` (:770).

The decode keeps its state on the device: the LFM2 caches (the KV cache
through `ops/kvcache.py`, the conv taps), the last hidden row and the
drawn tokens. The host plans up to DEC_CHUNK steps at a time as if no
token changed the schedule (no <|im_end|>, <|text_end|>, <|audio_start|>
or audio EOS), the device runs them, each step snapshotting the conv taps
and its hidden row, and the chunk's tokens come back in one read. The
host then replays JAX's schedule on them: at the first token that changes
it, the steps after it are dropped, the taps and the hidden row restored
from that step's snapshot (the KV columns past it are rewritten before
any step reads them) and the next chunk planned from there. So the kept
tokens are JAX's (greedy decoding compares token for token; draws come
from a `torch.Generator`) and the stop is read once a chunk. Chunks start
at one step and double up to DEC_CHUNK, so the first text and audio come
back after one step. An audio EOS drawn as a frame's first code is fed
back as a frame of EOS codes, as in JAX, by a select on the device.

Departures, from JAX faults:
* `post_load_hook` swallows every error (:759-767) and leaves no
  processor; here a processor or tokenizer that fails to load raises.
* A q8 directory: JAX's `maybe_quantize_tree` takes each short conv's
  dict for a linear (its `weight` (3, D) is 2-D) and quantizes the taps,
  leaving that conv's `in_proj` and `out_proj` dense, and its forward then
  fails on the missing `weight`. Here the taps are no linear: every
  `Linear` is quantized (K2), the taps stay dense.
* `sanitize` reads each conv's layout from this model's shapes (the
  conformer's conv2d and conv1d weights, the short convs' taps) where
  JAX's transposes every 3-D and 4-D conformer weight and reads every short
  conv as torch's (D, 1, K), so a converted or MLX checkpoint is misread;
  the leaves of the Mimi's `tokenizer-*.safetensors`, which the loader
  reads with the model's files, are left to the processor, which reads
  that file itself (JAX binds them into the model's tree unused).
* The prefill runs the prompt's rows unpadded (JAX pads to a power-of-two
  bucket and masks the tail), and the caches hold prompt + max_new_tokens
  + 1 columns.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Generator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import (TorchModel, check_device, conv2d_to_hwio,
                       convs_to_wio, holder)
from ....nn import Embedding, LayerNorm, Linear, RMSNorm
from ....ops.attention import attention
from ....ops.kvcache import KVCache, kv_update
from ....ops.rope import apply_rotary_interleaved, rope_cis, rope_freqs
from ....ops.sampling import sample
from ....stt.models.parakeet.conformer import (ConformerArgs, Conformer,
                                               conformer_forward)
from .detokenizer import short_conv_taps
from .lfm2 import (LFM2, LFM2Config, SwiGLU, _generator, _normal,
                   init_short_convs, lfm2_forward, lfm2_logits,
                   make_lfm2_caches)
from .processor import LFMModality, PreprocessorConfig

DEC_CHUNK = 8

# Special token IDs (reference model.py:37-41)
AUDIO_START_TOKEN = 128  # <|audio_start|>
IM_END_TOKEN = 7         # <|im_end|>
TEXT_END_TOKEN = 130     # <|text_end|>
AUDIO_EOS_TOKEN = 2048


@dataclass
class GenerationConfig:
    max_new_tokens: int = 512
    temperature: float = 1.0
    top_k: int = 50
    top_p: float = 1.0
    audio_temperature: float = 1.0
    audio_top_k: int = 4


@dataclass
class DepthformerConfig(BaseModelArgs):
    layers: int = 6
    dim: int = 1024
    num_heads: int = 32
    num_kv_heads: int = 8
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def ff_dim(self) -> int:
        # dim*4 SwiGLU with 2/3 shrink rounded to 256 (ref transformer.py:74)
        ff = int(2 * (self.dim * 4) / 3)
        return 256 * ((ff + 255) // 256)


@dataclass
class LFM2AudioConfig(BaseModelArgs):
    model_type: str = "lfm_audio"
    sample_rate: int = 24000
    codebooks: int = 8
    tie_audio_embeddings: bool = False
    audio_vocab_size: int = 2049  # 2048 + audio EOS
    interleaved_n_text: int = 6
    interleaved_n_audio: int = 12
    preprocessor: dict = field(default_factory=dict)
    encoder: dict = field(default_factory=dict)
    lfm: dict = field(default_factory=dict)
    depthformer: dict = field(default_factory=dict)
    adapter_hidden_dims: List[int] = field(default_factory=lambda: [2048])
    adapter_use_layer_norm: bool = True
    max_decode_len: int = 4096
    model_path: str = ""

    def __post_init__(self):
        self.preprocessor_config = PreprocessorConfig.from_dict(
            self.preprocessor or {})
        enc = {k: v for k, v in (self.encoder or {}).items()
               if k in ConformerArgs.__dataclass_fields__}
        enc.setdefault("feat_in", 128)
        enc.setdefault("n_layers", 17)
        enc.setdefault("d_model", 512)
        enc.setdefault("n_heads", 8)
        enc.setdefault("subsampling_factor", 8)
        enc.setdefault("subsampling_conv_channels", 256)
        enc.setdefault("conv_kernel_size", 9)
        self.encoder_args = ConformerArgs(**enc)
        self.lfm_config = LFM2Config.from_dict(self.lfm or {})
        self.depthformer_config = DepthformerConfig.from_dict(
            self.depthformer or {})


# ------------------------------------------------------------ depthformer

class DepthAttention(nn.Module):
    def __init__(self, d: DepthformerConfig):
        super().__init__()
        hd = d.head_dim
        self.q_proj = Linear(d.dim, d.num_heads * hd, bias=False)
        self.k_proj = Linear(d.dim, d.num_kv_heads * hd, bias=False)
        self.v_proj = Linear(d.dim, d.num_kv_heads * hd, bias=False)
        self.o_proj = Linear(d.num_heads * hd, d.dim, bias=False)
        self.q_norm = RMSNorm(hd, d.norm_eps)
        self.k_norm = RMSNorm(hd, d.norm_eps)


class DepthBlock(nn.Module):
    def __init__(self, d: DepthformerConfig):
        super().__init__()
        self.attn_norm = RMSNorm(d.dim, d.norm_eps)
        self.attn = DepthAttention(d)
        self.ffn_norm = RMSNorm(d.dim, d.norm_eps)
        self.ffn = SwiGLU(d.dim, d.ff_dim)


class DepthTables(nn.Module):
    """The per-codebook input embeddings and output heads, stacked (K, V,
    dim), and their norms (K, dim): raw leaves of the JAX tree."""

    def __init__(self, k: int, v: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(k, v, dim))
        self.embedding_norm = nn.Parameter(torch.empty(k, dim))
        self.to_logits = nn.Parameter(torch.empty(k, v, dim))


def _depth_block_step(blk: DepthBlock, d: DepthformerConfig,
                      x: torch.Tensor, cache: KVCache, i: int,
                      cis: torch.Tensor) -> torch.Tensor:
    """Position i (B, 1, dim) through a depthformer block; keys and values
    written at column i, attention over columns 0..i."""
    b = x.shape[0]
    a = blk.attn
    xn = blk.attn_norm(x)
    q = a.q_norm(a.q_proj(xn).view(b, 1, d.num_heads, d.head_dim))
    k = a.k_norm(a.k_proj(xn).view(b, 1, d.num_kv_heads, d.head_dim))
    v = a.v_proj(xn).view(b, 1, d.num_kv_heads, d.head_dim)
    # interleaved-pairs rotation (reference transformer.py:25-60)
    q = apply_rotary_interleaved(q, cis[i:i + 1])
    k = apply_rotary_interleaved(k, cis[i:i + 1])
    kv_update(cache, k, v, i)
    out = attention(q, cache.k[:, :i + 1], cache.v[:, :i + 1])
    x = x + a.o_proj(out.reshape(b, 1, -1))
    return x + blk.ffn(blk.ffn_norm(x))


# ------------------------------------------------------------------ model

def _greedy(temperature, top_k) -> bool:
    return temperature is None or temperature <= 0 or top_k == 1


class Model(TorchModel):
    """LFM2.5-Audio (reference LFM2AudioModel :217) on `device`: the card by
    default; without CUDA the constructor raises unless given
    `device="cpu"`. `last_run` holds the prompt rows, the prefill's ms, the
    chunks (steps, ms), the steps run and kept, and the rollbacks of the
    last decode."""

    def __init__(self, config: Union[LFM2AudioConfig, dict, None] = None,
                 device="cuda", **kwargs):
        device = check_device(device)
        if config is None:
            config = LFM2AudioConfig.from_dict(kwargs) if kwargs else \
                LFM2AudioConfig()
        elif isinstance(config, dict):
            config = LFM2AudioConfig.from_dict(config)
        super().__init__(config)
        c = config
        lfm, d = c.lfm_config, c.depthformer_config
        dims = ([c.encoder_args.d_model] + list(c.adapter_hidden_dims)
                + [lfm.hidden_size])
        total_av = c.audio_vocab_size * c.codebooks
        with torch.device(device):
            self.audio_encoder = Conformer(c.encoder_args)
            adapter = {f"fc{i + 1}": Linear(dims[i], dims[i + 1])
                       for i in range(len(dims) - 1)}
            if c.adapter_use_layer_norm:
                adapter["norm"] = LayerNorm(c.encoder_args.d_model)
            self.audio_adapter = holder(**adapter)
            self.lfm = LFM2(lfm)
            self.audio_embedding = holder(
                embedding=Embedding(total_av, lfm.hidden_size),
                embedding_norm=RMSNorm(lfm.hidden_size),
                to_logits=Linear(lfm.hidden_size, total_av, bias=False))
            self.depth_linear = Linear(lfm.hidden_size, c.codebooks * d.dim)
            self.depth_embeddings = DepthTables(c.codebooks,
                                                c.audio_vocab_size, d.dim)
            self.audio_head = holder(blocks=nn.ModuleList(
                DepthBlock(d) for _ in range(d.layers)))
        self.register_buffer("depth_cis", rope_cis(
            torch.arange(c.codebooks), rope_freqs(d.head_dim, d.rope_theta)
        ).to(device), persistent=False)
        self._processor = None
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @torch.no_grad()
    def init_params(self, seed: int = 0, on_device: bool = False) -> "Model":
        """`TorchModel.init_params`, then the leaves it does not know drawn
        as the JAX package draws them: the short convs' taps N(0, 1) / K,
        the depth tables N(0, 0.02), their norms 1."""
        super().init_params(seed, on_device)
        init_short_convs(self, seed, on_device)
        t = self.depth_embeddings
        gen = _generator(t.embedding, seed + 3, on_device)
        for p in (t.embedding, t.to_logits):
            p.copy_(_normal(p, gen, on_device) * 0.02)
        t.embedding_norm.fill_(1.0)
        return self

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    @property
    def dtype(self) -> torch.dtype:
        return self.lfm.embed_tokens.weight.dtype

    @property
    def processor(self):
        if self._processor is None:
            from .processor import LFM2AudioProcessor

            self._processor = LFM2AudioProcessor.from_pretrained(
                self.config.model_path, config=self.config,
                device=self.device)
        return self._processor

    # ---------------------------------------------------------- embedding

    def embed_audio_codes(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (B, T, K) or (B, K) -> the summed shared-table embeddings
        (reference AudioEmbedding :110-135)."""
        c = self.config
        squeeze = codes.ndim == 2
        if squeeze:
            codes = codes[:, None]
        offs = torch.arange(c.codebooks, device=codes.device) \
            * c.audio_vocab_size
        out = self.audio_embedding.embedding(codes + offs).sum(dim=2)
        return out[:, 0] if squeeze else out

    @torch.inference_mode()
    def encode_audio(self, mel) -> torch.Tensor:
        """mel (B, T, feat) -> adapted LFM-space embeddings (B, T', D)."""
        c = self.config
        mel = torch.as_tensor(np.asarray(mel, np.float32) if not isinstance(
            mel, torch.Tensor) else mel, device=self.device).to(self.dtype)
        h = conformer_forward(self.audio_encoder, c.encoder_args, mel)
        a = self.audio_adapter
        if hasattr(a, "norm"):
            h = a.norm(h)
        n_fc = len(c.adapter_hidden_dims) + 1
        for i in range(n_fc):
            h = getattr(a, f"fc{i + 1}")(h)
            if i != n_fc - 1:
                h = F.gelu(h, approximate="tanh")
        return h

    def _tensor(self, x, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x, device=self.device).to(dtype)

    @torch.inference_mode()
    def _build_embeddings(self, text_tokens, audio_features, audio_codes,
                          modalities) -> torch.Tensor:
        """Interleave per-modality embeddings by flag (reference
        _build_interleaved_embeddings :569-657) -> (1, L, D) on the
        device."""
        parts = [
            None if text_tokens is None
            else self.lfm.embed_tokens(self._tensor(text_tokens)),
            None if audio_features is None
            else self.encode_audio(audio_features),
            None if audio_codes is None
            else self.embed_audio_codes(self._tensor(audio_codes))]
        if modalities is None:
            return torch.cat([p.to(self.dtype) for p in parts
                              if p is not None], dim=1)
        mods = np.asarray(modalities)[0]
        out = torch.zeros(1, len(mods), self.config.lfm_config.hidden_size,
                          dtype=self.dtype, device=self.device)
        for flag, emb in zip((LFMModality.TEXT, LFMModality.AUDIO_IN,
                              LFMModality.AUDIO_OUT), parts):
            if emb is None:
                continue
            pos = np.nonzero(mods == int(flag))[0]
            n = min(len(pos), emb.shape[1])
            out[:, torch.as_tensor(pos[:n], device=self.device)] = \
                emb[:, :n].to(self.dtype)
        return out

    # ------------------------------------------------------------ samplers

    def _sample_text(self, hidden: torch.Tensor, temperature: float,
                     top_k: int, gen: torch.Generator) -> torch.Tensor:
        logits = lfm2_logits(self.lfm, hidden[:, -1])
        if temperature <= 0:
            return logits.argmax(dim=-1)
        return sample(logits, temperature, top_k=top_k, generator=gen)

    def sample_audio_frame(self, hidden: torch.Tensor, temperature: float,
                           top_k: int, gen: Optional[torch.Generator] = None,
                           cache: Optional[KVCache] = None) -> torch.Tensor:
        """hidden (B, 1, D) -> codes (B, codebooks), each codebook
        conditioned on the ones before it (reference _sample_audio_frame
        :684-764); `cache` the depthformer's (layers, B, codebooks, KVH,
        hd) KV cache, allocated when not given."""
        c, d = self.config, self.config.depthformer_config
        b = hidden.shape[0]
        if cache is None:
            cache = KVCache.init(b, c.codebooks, d.num_kv_heads, d.head_dim,
                                 hidden.dtype, hidden.device,
                                 n_layers=d.layers)
        din = self.depth_linear(hidden)[:, 0].view(b, c.codebooks, d.dim)
        tables = self.depth_embeddings
        greedy = _greedy(temperature, top_k)
        prev = torch.zeros(b, d.dim, dtype=hidden.dtype,
                           device=hidden.device)
        codes = []
        for i in range(c.codebooks):
            x = (din[:, i] + prev)[:, None]
            for li, blk in enumerate(self.audio_head.blocks):
                x = _depth_block_step(blk, d, x, cache.layer(li), i,
                                      self.depth_cis)
            logits = F.linear(x[:, 0], tables.to_logits[i].to(x.dtype))
            if greedy:
                code = logits.float().argmax(dim=-1)
            else:
                code = sample(logits.float(), temperature, top_k=top_k,
                              generator=gen)
            prev = tables.embedding[i].to(x.dtype)[code]  # raw (ref :760)
            codes.append(code)
        return torch.stack(codes, dim=1)

    # ----------------------------------------------------------- decoding

    @torch.inference_mode()
    def _prefill(self, text_tokens=None, audio_features=None,
                 audio_codes=None, modalities=None, max_new_tokens: int = 0):
        t0 = time.perf_counter()
        emb = self._build_embeddings(text_tokens, audio_features,
                                     audio_codes, modalities)
        b, t, _ = emb.shape
        caches = make_lfm2_caches(self.lfm, b, t + max_new_tokens + 1,
                                  self.dtype)
        hidden = lfm2_forward(self.lfm, emb, caches, 0)[:, -1:]
        hidden.sum().item()             # the prefill's end
        self.last_run = {"prompt": t, "prefill_ms":
                         (time.perf_counter() - t0) * 1e3}
        return hidden, caches, t

    @torch.inference_mode()
    def _decode(self, schedule, hidden: torch.Tensor, caches, offset: int,
                temperature: float, top_k: int, audio_temperature: float,
                audio_top_k: int, seed: int):
        """Run `schedule` (an _Interleaved or _Sequential) from the
        prefill's `hidden` and `caches` at `offset` in chunks (see the
        module's docstring); yields (token, modality) as JAX does."""
        c, d = self.config, self.config.depthformer_config
        dev, b, kk = self.device, hidden.shape[0], c.codebooks
        gen = torch.Generator(device=dev).manual_seed(seed)
        depth_cache = KVCache.init(b, kk, d.num_kv_heads, d.head_dim,
                                   hidden.dtype, dev, n_layers=d.layers)
        toks = torch.zeros(DEC_CHUNK, b, kk, dtype=torch.long, device=dev)
        conv_hist = caches.conv.new_empty((DEC_CHUNK,) + caches.conv.shape)
        hid_hist = hidden.new_empty((DEC_CHUNK,) + hidden.shape)
        run = self.last_run
        run.update(chunks=[], steps=0, kept=0, rollbacks=0)
        state, n = schedule.initial, 1
        while True:
            plan = _plan(schedule, state, n)
            if not plan:
                return
            t0 = time.perf_counter()
            for i, (mod, _) in enumerate(plan):
                if mod == LFMModality.TEXT:
                    tok = self._sample_text(hidden, temperature, top_k, gen)
                    toks[i, :, 0] = tok
                    emb = self.lfm.embed_tokens(tok[:, None])
                else:
                    frame = self.sample_audio_frame(
                        hidden, audio_temperature, audio_top_k, gen,
                        depth_cache)
                    frame = torch.where(frame[:, :1] == AUDIO_EOS_TOKEN,
                                        AUDIO_EOS_TOKEN, frame)
                    toks[i] = frame
                    emb = self.embed_audio_codes(frame)[:, None]
                hidden = lfm2_forward(self.lfm, emb.to(self.dtype), caches,
                                      offset + i)
                conv_hist[i].copy_(caches.conv)
                hid_hist[i].copy_(hidden)
            # the chunk's one read
            host = toks[:len(plan)].to(torch.int32).cpu().numpy()
            run["chunks"].append((len(plan),
                                  (time.perf_counter() - t0) * 1e3))
            run["steps"] += len(plan)
            for i, (mod, assumed) in enumerate(plan):
                state, emit, stop = schedule.advance(state, mod,
                                                     int(host[i, 0, 0]))
                if emit:
                    run["kept"] += 1
                    yield ((host[i, :, 0], mod) if mod == _TEXT
                           else (host[i, 0], mod))
                if stop:
                    return
                if state != assumed:
                    # a token changed the schedule: drop the steps after it
                    caches.conv.copy_(conv_hist[i])
                    hidden = hid_hist[i].clone()
                    offset += i + 1
                    run["rollbacks"] += 1
                    break
            else:
                offset += len(plan)
            n = min(2 * n, DEC_CHUNK)

    def generate_interleaved(
        self, text_tokens=None, audio_features=None, audio_codes=None,
        modalities=None, max_new_tokens: int = 512,
        temperature: float = 1.0, top_k: int = 50,
        audio_temperature: float = 1.0, audio_top_k: int = 4,
        interleaved_n_text: Optional[int] = None,
        interleaved_n_audio: Optional[int] = None, seed: int = 0,
    ) -> Generator[Tuple[np.ndarray, LFMModality], None, None]:
        """Fixed text/audio alternation (reference :766-903)."""
        c = self.config
        sched = _Interleaved(interleaved_n_text or c.interleaved_n_text,
                             interleaved_n_audio or c.interleaved_n_audio,
                             max_new_tokens)
        hidden, caches, offset = self._prefill(
            text_tokens, audio_features, audio_codes, modalities,
            max_new_tokens)
        yield from self._decode(sched, hidden, caches, offset, temperature,
                                top_k, audio_temperature, audio_top_k, seed)

    def generate_sequential(
        self, text_tokens=None, audio_features=None, audio_codes=None,
        modalities=None, max_new_tokens: int = 512,
        temperature: float = 1.0, top_k: int = 50,
        audio_temperature: float = 1.0, audio_top_k: int = 4,
        seed: int = 0,
    ) -> Generator[Tuple[np.ndarray, LFMModality], None, None]:
        """Model-driven switching on <|audio_start|> (reference :905)."""
        audio_first = text_tokens is not None and int(
            np.asarray(text_tokens)[0, -1]) == AUDIO_START_TOKEN
        sched = _Sequential(audio_first, max_new_tokens)
        hidden, caches, offset = self._prefill(
            text_tokens, audio_features, audio_codes, modalities,
            max_new_tokens)
        yield from self._decode(sched, hidden, caches, offset, temperature,
                                top_k, audio_temperature, audio_top_k, seed)

    def generate_from_chat_state(self, chat_state, mode: str = "interleaved",
                                 **kwargs):
        gen = (self.generate_interleaved if mode == "interleaved"
               else self.generate_sequential)
        yield from gen(text_tokens=chat_state.get_text_tokens(),
                       audio_features=chat_state.get_audio_features(),
                       modalities=chat_state.get_modalities(), **kwargs)

    # -------------------------------------------------- high-level surface

    def generate(self, text: Optional[str] = None, audio=None,
                 sample_rate: int = 24000, system_prompt: Optional[str]
                 = None, max_new_tokens: int = 512,
                 temperature: float = 0.7, top_k: int = 50,
                 audio_temperature: float = 0.8, audio_top_k: int = 4,
                 mode: str = "interleaved", seed: int = 0, **kwargs):
        """Chat-driven generate: text and/or audio in, text + audio out.
        Needs the processor's tokenizer (the directory's, or one set);
        `generate_interleaved` works without. `last_run` gains the ms to
        the first text token and to the first audio frame."""
        from ....tts.models.base import (GenerationResult, format_duration,
                                         peak_memory_gb)
        from .processor import ChatState

        t0 = time.perf_counter()
        proc = self.processor
        chat = ChatState(proc)
        if system_prompt:
            chat.new_turn("system")
            chat.add_text(system_prompt)
            chat.end_turn()
        chat.new_turn("user")
        if audio is not None:
            if isinstance(audio, str):
                from ....utils import load_audio

                audio = np.asarray(load_audio(
                    audio, proc.audio_preprocessor.config.sample_rate))
                sample_rate = proc.audio_preprocessor.config.sample_rate
            chat.add_audio(audio, sample_rate)
        if text:
            chat.add_text(text)
        chat.end_turn()
        chat.new_turn("assistant")

        text_out: List[int] = []
        audio_out: List[np.ndarray] = []
        first = {}
        for token, mod in self.generate_from_chat_state(
                chat, mode=mode, max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k,
                audio_temperature=audio_temperature,
                audio_top_k=audio_top_k, seed=seed):
            key = "first_text_ms" if mod == LFMModality.TEXT \
                else "first_audio_ms"
            first.setdefault(key, (time.perf_counter() - t0) * 1e3)
            if mod == LFMModality.TEXT:
                text_out.append(int(np.asarray(token).reshape(-1)[0]))
            else:
                if int(np.asarray(token)[0]) == AUDIO_EOS_TOKEN:
                    continue
                audio_out.append(np.asarray(token))
        self.last_run.update(first)
        waveform = np.zeros(0, np.float32)
        if audio_out:
            codes = np.stack(audio_out, axis=1)[None]  # (1, K, T)
            waveform = np.asarray(proc.decode_with_detokenizer(codes))[0]
        dt = time.perf_counter() - t0
        self.last_run.update(total_ms=dt * 1e3, text_tokens=len(text_out),
                             audio_frames=len(audio_out))

        dur = len(waveform) / self.sample_rate
        return GenerationResult(
            audio=waveform, samples=len(waveform),
            sample_rate=self.sample_rate, segment_idx=0,
            token_count=len(text_out) + len(audio_out),
            audio_duration=format_duration(dur),
            real_time_factor=(dt / dur if dur else 0.0),
            prompt={"tokens": len(text_out),
                    "text": proc.decode_text(text_out) if text_out else "",
                    "tokens-per-sec": (len(text_out) / dt if dt else 0.0)},
            audio_samples={"samples": len(waveform),
                           "samples-per-sec": (len(waveform) / dt
                                               if dt else 0.0)},
            processing_time_seconds=dt, peak_memory_usage=peak_memory_gb(),
            is_final_chunk=True)

    # ------------------------------------------------------------ loading

    _TOP = ("conformer.", "audio_adapter.", "lfm.", "depthformer.",
            "depth_embeddings.", "depth_linear.", "audio_embedding.",
            "audio_encoder.", "audio_head.", "audio_loss_weights",
            "codebook_offsets")

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """The release's names -> the JAX tree's (reference :666-756): the
        conformer's, the adapter's Sequential, the LFM's feed-forward and
        short convs, the depthformer's fused qkv split and its per-codebook
        tables stacked. Each conv's layout read from this model's shapes;
        leaves outside the model's names (the Mimi's) left out."""
        c = self.config
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        lfm = c.lfm_config
        out: Dict[str, np.ndarray] = {}
        depth_tables: Dict[str, Dict[int, np.ndarray]] = {
            "embedding": {}, "embedding_norm": {}, "to_logits": {}}
        sub_map = {"conv.0.": "layers.00_conv.", "conv.2.": "layers.01_dw.",
                   "conv.3.": "layers.02_pw.", "conv.5.": "layers.03_dw.",
                   "conv.6.": "layers.04_pw."}
        skip = ("audio_loss_weights", "codebook_offsets",
                ".num_batches_tracked", "pos_enc.pe", ".freqs",
                "downsample.", "upsample.", "istft.window")
        for k, v in weights.items():
            if not k.startswith(self._TOP) or any(s in k for s in skip):
                continue
            v = np.asarray(v)
            if k.startswith("depth_embeddings."):
                parts = k.split(".")
                if len(parts) >= 3 and parts[1].isdigit():
                    depth_tables[parts[2]][int(parts[1])] = v
                    continue
            if k.startswith("conformer."):
                k = k.replace("conformer.", "audio_encoder.")
                if ".pre_encode." in k:
                    for old, new in sub_map.items():
                        k = k.replace("pre_encode." + old,
                                      "pre_encode." + new)
            if k.startswith("audio_encoder.") and v.ndim == 4 and k in shapes:
                v = conv2d_to_hwio(k, v, shapes[k])
            elif k.startswith("audio_adapter.model."):
                parts = k.split(".")
                idx = int(parts[2])
                # Sequential: 0 = LayerNorm, then Linear/GELU pairs
                if c.adapter_use_layer_norm and idx == 0:
                    k = f"audio_adapter.norm.{parts[3]}"
                else:
                    base = 1 if c.adapter_use_layer_norm else 0
                    fc = (idx - base) // 2 + 1
                    k = f"audio_adapter.fc{fc}.{parts[3]}"
            elif k.startswith("lfm."):
                k = k.replace(".feed_forward.linear1.", ".feed_forward.w1.")
                k = k.replace(".feed_forward.linear2.", ".feed_forward.w2.")
                k = k.replace(".feed_forward.linear3.", ".feed_forward.w3.")
                if k.endswith("conv.conv.weight"):
                    k = k.replace("conv.conv.weight", "conv.weight")
                if k.endswith(".conv.weight"):
                    v = short_conv_taps(k, v, lfm.conv_L_cache,
                                        lfm.hidden_size)
                elif k.endswith("conv.conv.bias"):
                    k = k.replace("conv.conv.bias", "conv.bias")
            elif k.startswith("depthformer.layers."):
                parts = k.split(".")
                base = f"audio_head.blocks.{parts[2]}"
                rest = ".".join(parts[3:])
                if rest == "operator.qkv_proj.weight":
                    d = c.depthformer_config
                    q_dim = d.num_heads * d.head_dim
                    kv_dim = d.num_kv_heads * d.head_dim
                    out[f"{base}.attn.q_proj.weight"] = v[:q_dim]
                    out[f"{base}.attn.k_proj.weight"] = \
                        v[q_dim:q_dim + kv_dim]
                    out[f"{base}.attn.v_proj.weight"] = v[q_dim + kv_dim:]
                    continue
                mapping = {
                    "operator.out_proj.weight": "attn.o_proj.weight",
                    "operator.bounded_attention.q_layernorm.weight":
                        "attn.q_norm.weight",
                    "operator.bounded_attention.k_layernorm.weight":
                        "attn.k_norm.weight",
                }
                if rest in mapping:
                    k = f"{base}.{mapping[rest]}"
                elif rest.startswith("operator_norm."):
                    k = f"{base}.attn_norm.{rest.split('.', 1)[1]}"
                elif rest.startswith("feed_forward."):
                    k = f"{base}.ffn.{rest.split('.', 1)[1]}"
                else:
                    k = f"{base}.{rest}"
            out[k] = v
        for name, table in depth_tables.items():
            if table:
                out[f"depth_embeddings.{name}"] = np.stack(
                    [table[i] for i in sorted(table)], axis=0)
        return convs_to_wio(out, shapes, lambda k, v: np.ndim(v) == 3 and (
            k.startswith("audio_encoder.") and "conv" in k))

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The processor of the directory on the model's device, with the
        directory's text tokenizer (`local_tokenizer`: None without
        tokenizer files or `transformers`); either failing to load
        raises."""
        from ....tts.models.base import local_tokenizer
        from .processor import LFM2AudioProcessor

        proc = LFM2AudioProcessor.from_pretrained(
            str(model_path), config=model.config, device=model.device)
        proc._tokenizer = local_tokenizer(model_path, trust_remote_code=True)
        model._processor = proc
        return model


# ------------------------------------------------------------- schedules

_TEXT, _AUDIO = LFMModality.TEXT, LFMModality.AUDIO_OUT


class _Interleaved:
    """JAX's `generate_interleaved` loop as a state machine over (modality,
    left in this turn, text done, generated)."""

    def __init__(self, n_text: int, n_audio: int, max_new: int):
        self.n_text, self.n_audio, self.max_new = n_text, n_audio, max_new
        self.initial = (_TEXT, n_text, False, 0)

    def done(self, state) -> bool:
        return state[3] >= self.max_new

    def advance(self, state, mod, tok):
        """-> (next state, whether the step's token is yielded, stop);
        `tok` the step's token or its frame's first code, None for one
        that changes nothing."""
        _, left, text_done, generated = state
        generated += 1
        if mod == _TEXT:
            if tok == IM_END_TOKEN:
                return state, False, True
            text_done = text_done or tok == TEXT_END_TOKEN
            left -= 1
            nxt = (_AUDIO, self.n_audio) if left <= 0 or text_done \
                else (_TEXT, left)
        elif tok == AUDIO_EOS_TOKEN:
            if text_done:
                return state, True, True
            nxt = (_TEXT, self.n_text)
        else:
            left -= 1
            nxt = (_TEXT, self.n_text) if left <= 0 and not text_done \
                else (_AUDIO, left)
        return (*nxt, text_done, generated), True, generated >= self.max_new


class _Sequential:
    """JAX's `generate_sequential` loop as a state machine over (modality,
    steps)."""

    def __init__(self, audio_first: bool, max_new: int):
        self.max_new = max_new
        self.initial = (_AUDIO if audio_first else _TEXT, 0)

    def done(self, state) -> bool:
        return state[1] >= self.max_new

    def advance(self, state, mod, tok):
        steps = state[1] + 1
        stop = steps >= self.max_new
        if mod == _TEXT:
            if tok == IM_END_TOKEN:
                return (mod, steps), True, True
            if tok == AUDIO_START_TOKEN:
                return (_AUDIO, steps), False, stop
            return (_TEXT, steps), True, stop
        return (_TEXT if tok == AUDIO_EOS_TOKEN else _AUDIO, steps), True, \
            stop


def _plan(schedule, state, n: int):
    """Up to n steps of `schedule` from `state` if no token changes it:
    [(modality, the state after the step)]."""
    out = []
    for _ in range(0 if schedule.done(state) else n):
        mod = state[0]
        state, _, stop = schedule.advance(state, mod, None)
        out.append((mod, state))
        if stop:
            break
    return out


def offset_cap(max_new_tokens: int) -> int:
    return max(256, 1 << (max_new_tokens + 64 - 1).bit_length())


LFM2AudioModel = Model
ModelConfig = LFM2AudioConfig

__all__ = ["Model", "LFM2AudioModel", "ModelConfig", "LFM2AudioConfig",
           "DepthformerConfig", "GenerationConfig", "LFMModality",
           "AUDIO_START_TOKEN", "IM_END_TOKEN", "TEXT_END_TOKEN",
           "AUDIO_EOS_TOKEN", "DEC_CHUNK", "offset_cap"]
