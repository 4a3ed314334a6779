"""The plain float32 reference of the benchmark's configurations. It imports
nothing of the program or of JAX."""
