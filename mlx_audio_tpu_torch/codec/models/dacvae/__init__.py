from .dacvae import DACVAE, Model, ModelConfig, dacvae_decode, dacvae_encode

__all__ = ["DACVAE", "Model", "ModelConfig", "dacvae_decode",
           "dacvae_encode"]
