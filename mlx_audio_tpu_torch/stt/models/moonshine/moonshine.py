"""Moonshine: an encoder-decoder ASR model on the raw waveform.

Counterpart of mlx_audio_tpu/stt/models/moonshine/moonshine.py:

* `ModelConfig` (:45-87) with HF's `inv_freq` (an odd rotary dimension
  kept odd in the exponent's divisor);
* `encoder_forward` (:187-237): the stem (a tanh conv of 127 taps at stride
  64 without bias, GroupNorm(1) over channels and time as
  `_masked_global_norm` :171, exact-GELU convs 7/3 and 3/2), then pre-norm
  layers with partial interleaved RoPE, GQA attention and a GELU MLP, and a
  bias-free final LayerNorm;
* the decoder (`_cross_kv` :243, `decode_step` :260): cross K/V made once
  from the encoder's rows, pre-norm layers of self attention (RoPE at the
  step's position), cross attention and a SiLU-gated MLP, tied logits (or
  `proj_out`);
* `greedy_decode` (:304-348) and `generate` (:390-430): tokens before the
  first EOS, at most `max_tokens`; `sanitize` (:430, the `model.` prefix
  and the conv layouts) and `post_load_hook`.

Departures from the JAX package:

* the encoder runs the samples the audio has. JAX pads them to an
  `AUDIO_BUCKETS` length and masks the norm, the convs' inputs and the
  attention, which gives the same rows on the valid frames
  (`tests/test_torch_moonshine.py::test_unpadded_encoder_equals_jax_bucket`);
* the decode is an eager loop in place of one `lax.while_loop`: the self
  caches are f32 buffers of max_tokens + 1 columns written at a device
  offset (`ops/kvcache.py::kv_update_rows`), the step's position is a
  device tensor and its attention masks the columns not yet written, so
  no step reads a host value; EOS is masked on the device; each step's
  stop flag is copied to the host without blocking and read two steps
  later, so the loop runs at most one step past EOS (Whisper's
  `decoding.py::_decode`); the kept tokens come back in one read a
  chunk of DEC_CHUNK steps. The kept tokens are JAX's. A step's draw at
  temperature > 0 comes from a `torch.Generator` (only greedy decoding
  compares with JAX token for token);
* a bf16 model computes in bf16 against f32 self caches, its attention
  scores in f32;
* `sanitize` reads each conv weight's layout (torch, MLX or the JAX tree's
  WIO) from the model's own shapes, where JAX's recognises the stem's
  kernel sizes;
* `post_load_hook` reads only the directory's tokenizer files and raises
  when they fail to load, where JAX's swallows any error and leaves none.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....model import TorchModel, check_device, convs_to_wio, holder
from ....nn import Conv1d, Embedding, LayerNorm, Linear, gelu, layer_norm
from ....ops.attention import attention, decode_attention
from ....ops.host_flags import FinishedFlags
from ....ops.kvcache import KVCache, kv_update_rows
from ....ops.rope import apply_rope_interleaved
from ....tts.models.base import local_tokenizer
from ...models.base import STTOutput
from ..llm_stt import as_audio

DEC_CHUNK = 32
STEPS_AFTER_EOS = 1
# the fewest samples the stem turns into one frame; shorter audio is
# zero-padded to it (JAX's masked bucket leaves such audio no frame)
MIN_SAMPLES = 127 + 64 * 12


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "moonshine"
    vocab_size: int = 32768
    hidden_size: int = 288
    intermediate_size: int = 1152
    encoder_num_hidden_layers: int = 6
    decoder_num_hidden_layers: int = 6
    encoder_num_attention_heads: int = 8
    decoder_num_attention_heads: int = 8
    encoder_num_key_value_heads: Optional[int] = None
    decoder_num_key_value_heads: Optional[int] = None
    max_position_embeddings: int = 512
    attention_bias: bool = False
    partial_rotary_factor: float = 0.9
    rope_theta: float = 10000.0
    bos_token_id: int = 1
    eos_token_id: int = 2
    decoder_start_token_id: int = 1
    tie_word_embeddings: bool = True

    def __post_init__(self):
        if self.encoder_num_key_value_heads is None:
            self.encoder_num_key_value_heads = \
                self.encoder_num_attention_heads
        if self.decoder_num_key_value_heads is None:
            self.decoder_num_key_value_heads = \
                self.decoder_num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.encoder_num_attention_heads

    def inv_freq(self) -> torch.Tensor:
        """HF's: the rotary dimension int(head_dim * factor), odd or not,
        divides the exponents; the rotated span is 2 x len(inv_freq)."""
        dim = int(self.head_dim * self.partial_rotary_factor)
        return 1.0 / (self.rope_theta ** (
            torch.arange(0, dim, 2, dtype=torch.float32) / dim))


def encoder_frames(n: int) -> int:
    n = (n - 127) // 64 + 1
    n = (n - 7) // 3 + 1
    return (n - 3) // 2 + 1


class BiasFreeNorm(nn.Module):
    """A LayerNorm of weight only (`init_layer_norm(dim, bias=False)`)."""

    init_fill = {"weight": 1.0}

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, None, self.eps)


def _attn(cfg: ModelConfig, heads: int, kv_heads: int) -> nn.Module:
    h, hd, b = cfg.hidden_size, cfg.head_dim, cfg.attention_bias
    return holder(q_proj=Linear(h, heads * hd, bias=b),
                  k_proj=Linear(h, kv_heads * hd, bias=b),
                  v_proj=Linear(h, kv_heads * hd, bias=b),
                  o_proj=Linear(heads * hd, h, bias=False))


def _heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, n, -1)


def encoder_forward(model: "Model", wave: torch.Tensor) -> torch.Tensor:
    """(B, T) raw audio, every sample valid -> (B, F, hidden)."""
    cfg = model.config
    p = model.encoder
    x = torch.tanh(p.conv1(wave[..., None], stride=64))
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mean).pow(2).mean(dim=(1, 2), keepdim=True)
    x = ((xf - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype) \
        * p.groupnorm.weight.to(x.dtype) + p.groupnorm.bias.to(x.dtype)
    x = gelu(p.conv2(x, stride=3))
    x = gelu(p.conv3(x, stride=2))
    pos = torch.arange(x.shape[1], device=x.device)
    inv = model.inv_freq
    heads = cfg.encoder_num_attention_heads
    kv_heads = cfg.encoder_num_key_value_heads
    for lp in p.layers:
        h = lp.input_layernorm(x)
        a = lp.self_attn
        q = apply_rope_interleaved(_heads(a.q_proj(h), heads), pos, inv)
        k = apply_rope_interleaved(_heads(a.k_proj(h), kv_heads), pos, inv)
        v = _heads(a.v_proj(h), kv_heads)
        o = attention(q, k, v)
        x = x + a.o_proj(o.reshape(o.shape[0], o.shape[1], -1))
        h = lp.post_attention_layernorm(x)
        x = x + lp.mlp.fc2(gelu(lp.mlp.fc1(h)))
    return p.layer_norm(x)


class Model(TorchModel):
    """Moonshine on `device`: the card by default; without CUDA the
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
        c = config
        h, inter = c.hidden_size, c.intermediate_size
        with torch.device(device):
            self.encoder = holder(
                conv1=Conv1d(1, h, 127, bias=False), groupnorm=LayerNorm(h),
                conv2=Conv1d(h, 2 * h, 7), conv3=Conv1d(2 * h, h, 3),
                layers=nn.ModuleList(holder(
                    self_attn=_attn(c, c.encoder_num_attention_heads,
                                    c.encoder_num_key_value_heads),
                    mlp=holder(fc1=Linear(h, inter), fc2=Linear(inter, h)),
                    input_layernorm=BiasFreeNorm(h),
                    post_attention_layernorm=BiasFreeNorm(h))
                    for _ in range(c.encoder_num_hidden_layers)),
                layer_norm=BiasFreeNorm(h))
            self.decoder = holder(
                embed_tokens=Embedding(c.vocab_size, h),
                layers=nn.ModuleList(holder(
                    self_attn=_attn(c, c.decoder_num_attention_heads,
                                    c.decoder_num_key_value_heads),
                    encoder_attn=_attn(c, c.decoder_num_attention_heads,
                                       c.decoder_num_key_value_heads),
                    mlp=holder(fc1=Linear(h, 2 * inter),
                               fc2=Linear(inter, h)),
                    input_layernorm=BiasFreeNorm(h),
                    post_attention_layernorm=BiasFreeNorm(h),
                    final_layernorm=BiasFreeNorm(h))
                    for _ in range(c.decoder_num_hidden_layers)),
                norm=BiasFreeNorm(h))
            if not c.tie_word_embeddings:
                self.proj_out = Linear(h, c.vocab_size, bias=False)
        self.register_buffer("inv_freq", config.inv_freq().to(device),
                             persistent=False)
        self._tokenizer = None
        self.last_run: dict = {}
        self.requires_grad_(False)
        self.eval()

    @property
    def sample_rate(self) -> int:
        return 16000

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.embed_tokens.weight.dtype

    # ------------------------------------------------------------ encoder

    @torch.inference_mode()
    def encode(self, audio) -> torch.Tensor:
        """Audio (16 kHz) -> (1, F, hidden) encoder rows."""
        wave = torch.as_tensor(as_audio(audio, 16000))
        if wave.shape[0] < MIN_SAMPLES:
            wave = F.pad(wave, (0, MIN_SAMPLES - wave.shape[0]))
        return encoder_forward(self, wave[None].to(self.device, self.dtype))

    # ------------------------------------------------------------ decoder

    def cross_kv(self, enc: torch.Tensor) -> List[Tuple[torch.Tensor, ...]]:
        """Each decoder layer's cross K and V (B, F, kv heads, head_dim),
        made once (`_cross_kv`)."""
        n = self.config.decoder_num_key_value_heads
        return [(_heads(lp.encoder_attn.k_proj(enc), n),
                 _heads(lp.encoder_attn.v_proj(enc), n))
                for lp in self.decoder.layers]

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        if self.config.tie_word_embeddings:
            return h @ self.decoder.embed_tokens.weight.to(h.dtype).T
        return self.proj_out(h)

    def decode_step(self, token: torch.Tensor, t: torch.Tensor,
                    caches: KVCache, cross: List) -> torch.Tensor:
        """token (B, 1) at the device position t (B,) -> (B, vocab) f32
        logits; each layer's K and V written into `caches` at t."""
        cfg = self.config
        heads = cfg.decoder_num_attention_heads
        kv_heads = cfg.decoder_num_key_value_heads
        p = self.decoder
        x = p.embed_tokens(token)
        pos = t[:, None]
        for i, lp in enumerate(p.layers):
            a = lp.self_attn
            h = lp.input_layernorm(x)
            q = apply_rope_interleaved(_heads(a.q_proj(h), heads), pos,
                                       self.inv_freq)
            k = apply_rope_interleaved(_heads(a.k_proj(h), kv_heads), pos,
                                       self.inv_freq)
            v = _heads(a.v_proj(h), kv_heads)
            cache = kv_update_rows(caches.layer(i), k, v, t)
            o = decode_attention(q.float(), cache.k, cache.v, t + 1)
            x = x + a.o_proj(o.to(x.dtype).reshape(o.shape[0], 1, -1))
            ca = lp.encoder_attn
            h = lp.post_attention_layernorm(x)
            ck, cv = cross[i]
            o = attention(_heads(ca.q_proj(h), heads), ck, cv)
            x = x + ca.o_proj(o.reshape(o.shape[0], 1, -1))
            g, gate = lp.mlp.fc1(lp.final_layernorm(x)).chunk(2, dim=-1)
            x = x + lp.mlp.fc2(F.silu(gate) * g)
        return self.logits(p.norm(x))[:, 0].float()

    @torch.inference_mode()
    def greedy_decode(self, enc: torch.Tensor, max_tokens: int,
                      temperature: float = 0.0, seed: int = 0,
                      run: Optional[dict] = None) -> List[int]:
        """The decode from the start token -> the tokens before the first
        EOS, at most `max_tokens` (see the module's departures). `run`
        gets the steps, reads, tokens and each read's wall ms since the
        last (the first's from the decode's start)."""
        cfg = self.config
        dev = enc.device
        cross = self.cross_kv(enc)
        caches = KVCache.init(1, max_tokens + 1,
                              cfg.decoder_num_key_value_heads, cfg.head_dim,
                              torch.float32, dev,
                              n_layers=cfg.decoder_num_hidden_layers)
        cur = torch.full((1, 1), cfg.decoder_start_token_id,
                         dtype=torch.long, device=dev)
        t = torch.zeros(1, dtype=torch.long, device=dev)
        done = torch.zeros(1, dtype=torch.bool, device=dev)
        flags = FinishedFlags(max(max_tokens, 1), done)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        lag = STEPS_AFTER_EOS + 1
        out: List[int] = []
        pending: List[torch.Tensor] = []
        steps = reads = 0
        chunk_ms: List[float] = []
        t_last = time.perf_counter()

        def read():
            nonlocal pending, reads, t_last
            if pending:
                toks = torch.cat(pending).tolist()
                out.extend(x for x in toks if x >= 0)
                pending, reads = [], reads + 1
                now = time.perf_counter()
                chunk_ms.append((now - t_last) * 1e3)
                t_last = now

        for s in range(max_tokens):
            if s >= lag and bool(flags.read(s - lag)[0]):
                break
            logits = self.decode_step(cur, t, caches, cross)
            if temperature > 0.0:
                probs = torch.softmax(logits / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                nxt = logits.argmax(-1)
            done = done | (nxt == cfg.eos_token_id)
            pending.append(torch.where(done, -1, nxt))
            flags.record(s, done)
            cur, t = nxt[:, None], t + 1
            steps += 1
            if len(pending) == DEC_CHUNK:
                read()
        read()
        if run is not None:
            run.update(steps=steps, reads=reads, tokens=len(out),
                       chunk_ms=chunk_ms)
        return out

    # ----------------------------------------------------------- generate

    def _decode_tokens(self, tokens: List[int]) -> str:
        if self._tokenizer is not None:
            return self._tokenizer.decode(tokens, skip_special_tokens=True)
        return "".join(chr(t) if t < 128 else f"<{t}>" for t in tokens)

    def generate(self, audio, *, max_tokens: int = 200,
                 temperature: float = 0.0, seed: int = 0,
                 stream: bool = False, verbose: bool = False,
                 **kwargs) -> STTOutput:
        """`stream` is accepted and ignored, as in the JAX package."""
        t0 = time.time()
        t_enc = time.perf_counter()
        enc = self.encode(audio)
        run = {"frames": int(enc.shape[1]),
               "encode_ms": (time.perf_counter() - t_enc) * 1e3}
        t_dec = time.perf_counter()
        generated = self.greedy_decode(enc, int(max_tokens),
                                       float(temperature), seed, run)
        run["decode_ms"] = (time.perf_counter() - t_dec) * 1e3
        self.last_run = run
        text = self._decode_tokens(generated).strip()
        dt = time.time() - t0
        if verbose:
            print(f"Generated {len(generated)} tokens in {dt:.2f}s")
            print(f"Text: {text}")
        return STTOutput(
            text=text, segments=[{"text": text, "start": 0.0, "end": 0.0}],
            prompt_tokens=1, generation_tokens=len(generated),
            total_tokens=1 + len(generated), total_time=dt,
            prompt_tps=1 / dt if dt > 0 else 0,
            generation_tps=len(generated) / dt if dt > 0 else 0)

    __call__ = generate

    # ------------------------------------------------------------ loading

    def sanitize(self, weights: Dict) -> Dict[str, np.ndarray]:
        """The `model.` prefix dropped, a tied `proj_out` dropped, the
        stem's conv weights to WIO from the layout their shape shows."""
        shapes = {k: tuple(v.shape) for k, v in self.state_dict().items()}
        out = {}
        for k, v in weights.items():
            if k.startswith("model."):
                k = k[len("model."):]
            if k.startswith("proj_out.") and self.config.tie_word_embeddings:
                continue
            out[k] = np.asarray(v)
        return convs_to_wio(out, shapes, lambda k, v: np.ndim(v) == 3
                            and k.startswith("encoder.conv")
                            and k.endswith("weight"))

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        """The directory's HF tokenizer (None without tokenizer files or
        `transformers`); tokenizer files that fail to load raise."""
        model._tokenizer = local_tokenizer(Path(model_path))
        return model


__all__ = ["Model", "ModelConfig", "encoder_forward", "encoder_frames",
           "DEC_CHUNK"]
