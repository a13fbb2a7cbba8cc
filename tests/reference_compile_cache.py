"""A module fixture for the port's parity suites: the JAX package's
programs compile without JAX's persistent compilation cache.

TPUScheduler points every test worker at one shared cache directory
(karpenter_tpu/utils/accel.py enable_persistent_compile_cache), and under
pytest-xdist a worker that writes an entry while another reads or writes
it can die with a segmentation fault inside the cache
(jax/_src/compilation_cache.py put_executable_and_time). A suite that
compiles the reference's programs imports the fixture:

    from reference_compile_cache import no_persistent_compile_cache  # noqa: F401

and compiles in memory for the module's duration; the setting and the
cache's state are restored after it. The compiled programs are dropped
(jax.clear_caches) when the module starts and when it ends. Each compiled
program holds memory mappings of its own: a worker that kept every
module's programs reached tens of thousands of them, near the kernel's
limit per process (vm.max_map_count, 65530), where a mapping fails and
the worker raises MemoryError or dies inside XLA. The JAX package's own
suites keep theirs (tests/test_shard.py alone left a worker at 61k), so
a port suite drops them before it compiles.
"""

import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def no_persistent_compile_cache():
    from jax._src import compilation_cache

    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    jax.clear_caches()
    yield
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()
    jax.clear_caches()
