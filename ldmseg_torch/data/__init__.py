"""The port's data path: numpy transforms, the synthetic DVPS dataset,
collation and a single-process loader (own copies of the JAX package's
numpy modules)."""
