from .config import Config
from .flax_bridge import flax_to_torch_state, load_flax_params, torch_state
from .fold_bn import fold_conv_bn, fold_model_conv_bn
from .torch_port import convert_full_model, merge_trees, overlay_flax_params
from .weights import init_weights

__all__ = ["Config", "convert_full_model", "flax_to_torch_state",
           "fold_conv_bn", "fold_model_conv_bn", "init_weights",
           "load_flax_params", "merge_trees", "overlay_flax_params",
           "torch_state"]
