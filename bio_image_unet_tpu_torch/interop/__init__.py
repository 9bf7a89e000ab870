from .torch_ckpt import (export_torch_checkpoint, load_torch_checkpoint, torch_key_to_flax,
                         torch_state_dict_to_variables)
from .weights import state_dict_from_jax, variables_to_torch_state_dict

__all__ = ["state_dict_from_jax", "variables_to_torch_state_dict", "torch_key_to_flax",
           "torch_state_dict_to_variables", "load_torch_checkpoint", "export_torch_checkpoint"]
