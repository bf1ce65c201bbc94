"""Models of the port (counterparts of ``ray_tpu/models``)."""
