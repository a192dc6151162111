from .mossformer2_se import Model, MossFormer2SEConfig, MossFormer2SEModel

ModelConfig = MossFormer2SEConfig

__all__ = ["Model", "ModelConfig", "MossFormer2SEConfig",
           "MossFormer2SEModel"]
