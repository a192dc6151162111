"""MegaASR: Qwen3-ASR with an audio-quality router and a LoRA adapter.

Counterpart of mlx_audio_tpu/stt/models/mega_asr/mega_asr.py: each
request (`generate`, `stream_transcribe`) first goes through the
`AudioQualityRouter`, and degraded audio runs with the LoRA deltas on the
ASR weights (:151-170); `post_load_hook` reads `extras/router.safetensors`
and `extras/lora.safetensors` beside the checkpoint (:172-184).

Departures: the adapter's factors are moved to the model's device once, at
`set_lora`, and each delta is computed there when a request switches the
adapter on; switching it off restores the weights saved on the device
when it was switched on (a copy of each adapted linear's weight), so
removal is exact in any dtype, where subtracting the delta again (JAX's
way) is not exact in bf16; a request routes once, streamed or not; an
adapter whose path is no dense linear of the model (a
quantized one, say) or whose delta has the wrong shape raises at load,
naming the path; the router runs on the model's device, outside the
model's module tree (a cast or a quantization of the model leaves it in
f32); `last_route` holds the latest request's route.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import torch

from ..qwen3_asr.config import ModelConfig as Qwen3Config
from ..qwen3_asr.qwen3_asr import Model as Qwen3ASRModel
from .lora import (_leaf, apply_deltas, check_deltas, load_lora_factors,
                   to_device)
from .router import AudioQualityRouter


class ModelConfig(Qwen3Config):
    pass


class Model(Qwen3ASRModel):
    def __init__(self, config=None, device="cuda", **kwargs):
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config, device=device, **kwargs)
        self.config.model_type = "mega_asr"
        self._router: Optional[AudioQualityRouter] = None
        self._deltas: Dict = {}
        self._saved: Dict[str, torch.Tensor] = {}
        self._lora_active = False
        self.last_route: Optional[dict] = None
        self.router_weights = "extras/router.safetensors"
        self.lora_weights = "extras/lora.safetensors"

    def __setattr__(self, name, value):
        if name == "_router":
            # kept out of the module tree: `astype`, quantization and
            # `state_dict` leave the router alone
            object.__setattr__(self, name, value)
            return
        super().__setattr__(name, value)

    def set_lora(self, deltas: Dict) -> None:
        """Take an adapter (`load_lora_factors`' dict), checked against the
        model's linears and moved to the model's device; the adapter is
        off until a request routes to it."""
        self._set_lora(False)
        check_deltas(self, deltas)
        self._deltas = to_device(deltas, self.device)

    @torch.no_grad()
    def _set_lora(self, want: bool) -> None:
        if not self._deltas or want == self._lora_active:
            return
        if want:
            self._saved = {p: _leaf(self, p).weight.detach().clone()
                           for p in self._deltas}
            apply_deltas(self, self._deltas, 1.0)
        else:
            for p, w in self._saved.items():
                _leaf(self, p).weight.copy_(w)
            self._saved = {}
        self._lora_active = want

    def _route(self, audio) -> None:
        if self._router is None:
            return
        self.last_route = self._router.route(self._load(audio))
        self._set_lora(bool(self.last_route["use_lora"]))

    def generate(self, audio, **kwargs):
        if not kwargs.get("stream"):
            # a streamed request routes in `stream_transcribe`
            self._route(audio)
        return super().generate(audio, **kwargs)

    def stream_transcribe(self, audio, **kwargs):
        self._route(audio)
        return super().stream_transcribe(audio, **kwargs)

    @staticmethod
    def post_load_hook(model: "Model", model_path) -> "Model":
        model = Qwen3ASRModel.post_load_hook(model, model_path)
        model_path = Path(model_path)
        rp = model_path / model.router_weights
        if rp.exists():
            from safetensors.numpy import load_file

            model._router = AudioQualityRouter.from_converted(
                load_file(str(rp)), device=model.device)
        lp = model_path / model.lora_weights
        if lp.exists():
            model.set_lora(load_lora_factors(lp))
        return model


__all__ = ["Model", "ModelConfig"]
