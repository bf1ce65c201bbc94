"""Training steps of the port (``spmd.make_causal_lm_trainer``)."""
