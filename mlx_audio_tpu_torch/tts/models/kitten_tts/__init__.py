from .kitten_tts import Model, ModelConfig, fake_quant_dynamic_u8

__all__ = ["Model", "ModelConfig", "fake_quant_dynamic_u8"]
