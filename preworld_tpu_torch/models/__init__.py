from .preworld import PreWorld, PreWorldConfig, TinyBackbone
from .swin import SwinTransformer

__all__ = ["PreWorld", "PreWorldConfig", "SwinTransformer", "TinyBackbone"]
