"""tpinn_torch.utils — checkpointing and JAX-pytree conversion."""
