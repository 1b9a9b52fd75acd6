"""Test harness: force the CPU backend with a virtual 8-device mesh.

The reference's de-facto distributed test is ``mpirun -np K`` on localhost
(README.md:26); ours is an 8-device host-platform mesh, which exercises the
same shard-count-invariance properties without a GPU.  The GPU kernels run
here in the Pallas interpreter (backend "interpret"); what only a card can
run is marked ``gpu``, skips here, and is covered by ``python chip_smoke.py``
on the card.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU: run python chip_smoke.py on the card")
    return devs[0]
