"""Experimental APIs (the cluster state API under ``state``).

The port's copy of the JAX package's ``ray_tpu/experimental/__init__.py``."""
