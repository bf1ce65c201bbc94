"""The command line (``cli``).

The port's copy of the JAX package's ``ray_tpu/scripts/__init__.py``."""
