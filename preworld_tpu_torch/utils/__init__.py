from .config import Config
from .flax_bridge import flax_to_torch_state, load_flax_params, torch_state
from .weights import init_weights

__all__ = ["Config", "flax_to_torch_state", "init_weights",
           "load_flax_params", "torch_state"]
