from .ecapa_tdnn import EcapaBackbone, EcapaTdnnConfig, ecapa_backbone

__all__ = ["EcapaBackbone", "EcapaTdnnConfig", "ecapa_backbone"]
