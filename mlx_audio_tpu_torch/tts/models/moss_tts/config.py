"""MOSS-TTS configuration (counterpart of
mlx_audio_tpu/tts/models/moss_tts/config.py): the Qwen3 text-LM config
`Qwen3LMConfig` (:23-56: `rope_theta` read from a `rope_parameters` dict
when the config has none of its own, `head_dim` from the width when
absent), shared by the Qwen3 LM families, and the MOSS-TTS `ModelConfig`
(:55-185) of its three checkpoint layouts: the delay pattern
(`moss_tts_delay`), the legacy local transformer (a small Qwen3 local
stack and per-channel MLPs) and the v1.5 local transformer
(`moss_tts_local`, a one-layer GPT-2 local head), with their predicates,
`from_dict` and `local_transformer_config` / `local_gpt2_config`. A copy
of the JAX module's."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional

from ....base import BaseModelArgs
from ..moss_tts_nano.gpt2 import GPT2Config

DEFAULT_AUDIO_TOKENIZER_REPO = "OpenMOSS-Team/MOSS-Audio-Tokenizer"
DEFAULT_AUDIO_TOKENIZER_V2_REPO = "OpenMOSS-Team/MOSS-Audio-Tokenizer-v2"


@dataclass
class Qwen3LMConfig(BaseModelArgs):
    """Qwen3 text-LM subset used as the MOSS global transformer."""

    model_type: str = "qwen3"
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 6144
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    max_position_embeddings: int = 65536
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = False
    rope_theta: float = 1000000.0
    attention_bias: bool = False

    @classmethod
    def from_dict(cls, params):
        params = dict(params or {})
        rp = params.get("rope_parameters")
        if "rope_theta" not in params and isinstance(rp, dict):
            if "rope_theta" in rp:
                params["rope_theta"] = rp["rope_theta"]
        if "head_dim" not in params and {"hidden_size",
                                         "num_attention_heads"} <= set(params):
            params["head_dim"] = (int(params["hidden_size"])
                                  // int(params["num_attention_heads"]))
        return super().from_dict(params)


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "moss_tts_delay"
    model_path: Optional[str] = None
    language_config: Optional[Qwen3LMConfig] = None
    initializer_range: float = 0.02
    n_vq: int = 32
    audio_vocab_size: int = 1024
    audio_codebook_sizes: Optional[List[int]] = None
    audio_user_slot_token_id: int = 151654
    audio_assistant_slot_token_id: int = 151656
    audio_assistant_gen_slot_token_id: int = 151656
    audio_assistant_delay_slot_token_id: int = 151662
    audio_start_token_id: int = 151652
    audio_end_token_id: int = 151653
    audio_pad_token_id: int = 1024
    audio_pad_code: int = 1024
    pad_token_id: int = 151643
    im_start_token_id: int = 151644
    im_end_token_id: int = 151645
    sampling_rate: int = 24000
    audio_tokenizer_pretrained_name_or_path: Optional[str] = None
    additional_mlp_ffn_hidden_size: Optional[int] = None
    local_ffn_hidden_size: Optional[int] = None
    local_hidden_size: Optional[int] = None
    local_num_layers: Optional[int] = None
    gpt2_config: Optional[GPT2Config] = None
    local_transformer_layers: int = 1
    local_text_head_mode: str = "full_vocab"

    def __post_init__(self):
        if isinstance(self.language_config, dict):
            self.language_config = Qwen3LMConfig.from_dict(
                self.language_config)
        if isinstance(self.gpt2_config, dict):
            self.gpt2_config = GPT2Config.from_dict(self.gpt2_config)
        if self.audio_codebook_sizes is not None:
            self.audio_codebook_sizes = [int(s)
                                         for s in self.audio_codebook_sizes]
            if len(self.audio_codebook_sizes) != self.n_vq:
                raise ValueError(
                    "audio_codebook_sizes must have one entry per VQ channel "
                    f"(expected {self.n_vq}, "
                    f"got {len(self.audio_codebook_sizes)})")
        if self.audio_tokenizer_pretrained_name_or_path is None:
            self.audio_tokenizer_pretrained_name_or_path = (
                DEFAULT_AUDIO_TOKENIZER_V2_REPO
                if self.model_type == "moss_tts_local"
                else DEFAULT_AUDIO_TOKENIZER_REPO)

    @property
    def hidden_size(self) -> int:
        if self.language_config is None:
            raise ValueError("language_config is not initialized")
        return int(self.language_config.hidden_size)

    @property
    def vocab_size(self) -> int:
        if self.language_config is None:
            raise ValueError("language_config is not initialized")
        return int(self.language_config.vocab_size)

    @property
    def is_legacy_local_transformer(self) -> bool:
        return (self.additional_mlp_ffn_hidden_size is not None
                and self.local_ffn_hidden_size is not None
                and self.local_hidden_size is not None
                and self.local_num_layers is not None)

    @property
    def is_v15_local_transformer(self) -> bool:
        return (self.model_type == "moss_tts_local"
                or self.gpt2_config is not None)

    @property
    def is_local_transformer(self) -> bool:
        return self.is_legacy_local_transformer or self.is_v15_local_transformer

    def local_transformer_config(self) -> Qwen3LMConfig:
        if not self.is_legacy_local_transformer:
            raise ValueError("local transformer configuration missing")
        # head_dim / head counts intentionally inherit the global LM values
        # (ref config.py:81-86 replaces only sizes and depth)
        return replace(
            self.language_config,
            hidden_size=int(self.local_hidden_size),
            intermediate_size=int(self.local_ffn_hidden_size),
            num_hidden_layers=int(self.local_num_layers),
        )

    def local_gpt2_config(self) -> GPT2Config:
        if self.gpt2_config is None:
            raise ValueError("gpt2_config is not initialized")
        return replace(
            self.gpt2_config,
            n_positions=self.n_vq + 1,
            n_ctx=self.n_vq + 1,
            n_layer=self.local_transformer_layers,
            pad_token_id=self.pad_token_id,
        )

    @classmethod
    def from_dict(cls, params: Dict[str, Any]) -> "ModelConfig":
        params = dict(params or {})
        lang = dict(params.get("language_config")
                    or params.get("qwen3_config") or {})
        lang.setdefault("model_type", "qwen3")
        # upstream checkpoints carry an explicit text head at lm_heads.0
        lang.setdefault("tie_word_embeddings", False)
        params["language_config"] = lang
        params.pop("qwen3_config", None)
        pad = params.get("audio_pad_token_id",
                         params.get("audio_pad_code", 1024))
        params["audio_pad_token_id"] = int(pad)
        params.setdefault("audio_pad_code", int(pad))
        slot = params.get("audio_assistant_slot_token_id",
                          params.get("audio_assistant_gen_slot_token_id"))
        if slot is None:
            slot = 151656
        params["audio_assistant_slot_token_id"] = int(slot)
        params["audio_assistant_gen_slot_token_id"] = int(slot)
        if params.get("audio_assistant_delay_slot_token_id") is None:
            params["audio_assistant_delay_slot_token_id"] = 151662
        if "sampling_rate" not in params and "sample_rate" in params:
            params["sampling_rate"] = params["sample_rate"]
        tok = (params.get("audio_tokenizer_pretrained_name_or_path")
               or params.get("audio_tokenizer_name_or_path"))
        if tok is not None:
            params["audio_tokenizer_pretrained_name_or_path"] = tok
        return super().from_dict(params)


__all__ = ["ModelConfig", "Qwen3LMConfig", "GPT2Config",
           "DEFAULT_AUDIO_TOKENIZER_REPO", "DEFAULT_AUDIO_TOKENIZER_V2_REPO"]
