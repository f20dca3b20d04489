"""The plain float32 reference of the benchmark's model families. It
imports neither JAX, the JAX package nor the port."""
