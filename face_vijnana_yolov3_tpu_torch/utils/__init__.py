"""Image IO and box drawing (copies of the JAX package's jax-free utils)."""
