"""The Qwen3 text-LM config (counterpart of `Qwen3LMConfig` in
mlx_audio_tpu/tts/models/moss_tts/config.py:23-56): `rope_theta` read from
a `rope_parameters` dict when the config has none of its own, `head_dim`
from the width when absent."""

from __future__ import annotations

from dataclasses import dataclass

from ....base import BaseModelArgs


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


__all__ = ["Qwen3LMConfig"]
