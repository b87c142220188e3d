"""Platform predicate and compile-cache directory (runlmc_tpu.config)."""

import os

import pytest

from runlmc_tpu import config


@pytest.mark.parametrize(
    "platform, native", [("cpu", True), ("gpu", True), ("emulated", False)]
)
def test_native_f64_by_platform(platform, native):
    assert config.native_f64(platform) is native


def test_native_f64_defaults_to_the_running_backend():
    assert config.native_f64() is True  # the tests run on the CPU


def test_compile_cache_dir_honours_the_environment(tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    assert config.compile_cache_dir(env) == str(tmp_path)


@pytest.mark.parametrize("env", [{}, {"JAX_COMPILATION_CACHE_DIR": ""}])
def test_compile_cache_dir_defaults_into_the_checkout(env):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert config.compile_cache_dir(env) == os.path.join(root, ".jax_cache")
