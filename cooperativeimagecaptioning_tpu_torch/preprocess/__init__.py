"""Preprocessing the port keeps its own copy of (the JAX package's
preprocess/ modules that import no JAX)."""
