"""Tensor ops of the port (counterparts of ``ray_tpu/ops``)."""
