"""Repository-wide pytest configuration, loaded before tests/conftest.py.

The Pallas TPU interpreter (the demod engine "pallas-fused-interpret", and
the fused halo of the sharded chain with ``interpret``) runs jnp ops from
io_callback threads.  With JAX's asynchronous CPU dispatch such an op can
queue behind the caller's next eager op while the kernel waits on it, and
the test hangs.  The flag is read when the CPU client is created, and its
environment variable is not honoured, so it is set through jax.config once
tests/conftest.py has imported jax and before any test runs.  A session
that never imports jax (the port's benchmark tests) is left alone.
"""
import sys


def pytest_configure(config):
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.config.update("jax_cpu_enable_async_dispatch", False)
