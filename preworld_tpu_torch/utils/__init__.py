from .flax_bridge import flax_to_torch_state, load_flax_params

__all__ = ["flax_to_torch_state", "load_flax_params"]
