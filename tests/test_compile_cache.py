"""Where the persistent XLA compilation cache lives: JAX_COMPILATION_CACHE_DIR
when it is set (and no other directory is set in code), else one fixed,
gitignored directory inside the checkout."""

import json
import os
import subprocess
import sys

import quickstep_tpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import json, jax
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
import quickstep_tpu
jax.jit(lambda x: x * 3 + 1)(jax.numpy.arange(7)).block_until_ready()
print(json.dumps(jax.config.jax_compilation_cache_dir))
"""


def _child_cache_dir(env_dir):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_checkout_cache_dir_is_in_the_checkout():
    assert quickstep_tpu.CHECKOUT_CACHE_DIR == \
        os.path.join(REPO, ".jax_cache")


def test_checkout_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_env_var_set_cache_lands_there(tmp_path):
    assert _child_cache_dir(tmp_path) == str(tmp_path)
    assert any(os.scandir(tmp_path)), "nothing was cached"


def test_env_var_unset_uses_checkout_dir():
    assert _child_cache_dir(None) == os.path.join(REPO, ".jax_cache")
