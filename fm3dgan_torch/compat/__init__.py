from fm3dgan_torch.compat.from_jax import from_jax

__all__ = ["from_jax"]
