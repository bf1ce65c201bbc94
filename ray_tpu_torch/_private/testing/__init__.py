"""Interface mocks for unit tests.

Role-equivalent to the reference's ``src/mock/ray/**`` gmock library
(header-for-header doubles of gcs_client, raylet_client, core_worker,
pubsub, rpc — used by the C++ unit tests to test components in
isolation) and ``core_worker/test/mock_worker.cc``. The integration
suite drives real local clusters; these mocks let the *logic* inside a
component (ordering, admission, scheduling, validation) be unit-tested
without processes, sockets, or shared memory.

Copied from the JAX package's ``ray_tpu/_private/testing/__init__.py``.
"""

from ray_tpu_torch._private.testing.mocks import (  # noqa: F401
    MockConnection, MockStore, make_bare)
