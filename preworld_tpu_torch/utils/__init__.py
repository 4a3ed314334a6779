from .config import Config
from .flax_bridge import flax_to_torch_state, load_flax_params, torch_state

__all__ = ["Config", "flax_to_torch_state", "load_flax_params", "torch_state"]
