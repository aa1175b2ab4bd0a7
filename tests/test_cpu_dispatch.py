"""The test process runs JAX's CPU work synchronously (conftest.py at the
repository root), so the Pallas TPU interpreter's io_callback threads cannot
deadlock against the caller's next eager op."""
import jax


def test_interpret_engine_runs_with_sync_cpu_dispatch():
    assert jax.config.values["jax_cpu_enable_async_dispatch"] is False
