from fm3dgan_torch.compat.from_jax import discriminator_from_jax, from_jax

__all__ = ["discriminator_from_jax", "from_jax"]
