"""Parallelism of the port: ``mesh`` (``MeshSpec``, the sharding rules),
``collectives`` (the facade over ``torch.distributed``) and ``dryrun``
(multi-rank runs on the CPU)."""
