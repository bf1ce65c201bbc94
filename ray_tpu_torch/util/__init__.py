"""ray_tpu_torch.util — the runtime's user utilities."""
