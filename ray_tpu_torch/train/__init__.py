"""Training steps of the port (``spmd.make_causal_lm_trainer``,
``spmd.make_pipelined_lm_trainer``, ``spmd.make_image_classifier_trainer``),
on one device or a mesh."""
