import dataclasses

import jax
import pytest

# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# single real CPU device; only launch/dryrun.py forces 512 host devices.

jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="session")
def rng():
    return jax.random.key(0)


def f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with nvcc (skips elsewhere)")
