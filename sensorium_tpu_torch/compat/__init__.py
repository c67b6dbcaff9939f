"""Moving weights and training state into and out of the port."""

from sensorium_tpu_torch.compat.jax_weights import from_jax_state, from_jax_variables, to_jax_variables  # noqa: F401
from sensorium_tpu_torch.compat.torch_weights import convert_torch_state_dict, to_torch_state_dict  # noqa: F401
