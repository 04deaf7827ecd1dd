"""nn.Module twins of the JAX package's models."""
