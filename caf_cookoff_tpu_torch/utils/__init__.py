"""Utilities: signal I/O, fixture generation, JAX-package conversion."""
