"""Moving weights and training state into the port."""

from sensorium_tpu_torch.compat.jax_weights import from_jax_state, from_jax_variables  # noqa: F401
