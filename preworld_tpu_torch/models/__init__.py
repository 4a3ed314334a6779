from .bevstereo_occ import BEVStereoOCC
from .preworld import PreWorld, PreWorldConfig, TinyBackbone
from .swin import SwinTransformer

__all__ = ["BEVStereoOCC", "PreWorld", "PreWorldConfig", "SwinTransformer",
           "TinyBackbone"]
