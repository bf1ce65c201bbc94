from ray_tpu_torch.rllib.execution.learner_thread import \
    LearnerThread  # noqa: F401
