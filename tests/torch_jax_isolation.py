"""Restore the JAX process state that the JAX package's own tests pin, for
the port's test files that run JAX code under ``repro.obs.trace.capture()``.

Under ``--dist loadfile`` a port test file shares its worker process with
JAX test files. While a recorder is enabled, JAX's multi-source ``bfs``
steps through a traced-only jit entry point,
``repro.core.bfs._multi_superstep_jit``, and
``tests/test_obs.py::test_disabled_tracing_adds_zero_jit_retraces`` pins
that entry point's cache at size 0. A port test file that runs JAX under
``capture()`` calls ``clear_traced_only_jits`` from its ``teardown_module``.
Only these caches are cleared, not ``jax.clear_caches()``: every later JAX
test would compile again.
"""
from repro.core.bfs import _multi_superstep_jit

TRACED_ONLY_JITS = (_multi_superstep_jit,)


def clear_traced_only_jits() -> None:
    for fn in TRACED_ONLY_JITS:
        fn.clear_cache()
