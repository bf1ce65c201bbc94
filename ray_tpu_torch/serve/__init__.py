"""Serving pieces of the port (counterparts of ``ray_tpu/serve``)."""
