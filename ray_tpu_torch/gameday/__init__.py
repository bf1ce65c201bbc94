"""Game-day state (counterpart of ``ray_tpu/gameday``): only ``store``,
which the serve replicas flush their request and token ledgers into.
"""
