"""
Installation and start-up behaviour: the flagship path needs only numpy,
scipy and JAX; the compilation cache goes where JAX_COMPILATION_CACHE_DIR
says; the CSV reader that replaced pandas; chip_smoke.py refuses to pass
without a GPU.
"""

import bz2
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from pisa_tpu.utils.fileio import read_csv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_extra=None, drop=(), cwd=REPO, timeout=600):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=cwd, env=env, timeout=timeout,
    )


_BLOCK_OPTIONAL = """
import sys
class _Block:
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("pandas", "h5py"):
            raise ImportError("blocked " + name)
sys.meta_path.insert(0, _Block())
"""


def test_flagship_without_pandas_h5py():
    """With pandas and h5py unimportable, the flagship pipeline builds and
    evaluates on the CPU."""
    code = _BLOCK_OPTIONAL + """
import numpy as np
from pisa_tpu.config.parser import parse_pipeline_config
from pisa_tpu.core.pipeline import Pipeline
cfg = parse_pipeline_config("settings/pipeline/IceCube_3y_neutrinos.cfg")
cfg[("data", "csv_loader")]["fraction_events_to_keep"] = 0.01
maps = Pipeline(cfg).get_outputs()
total = sum(float(np.sum(m.hist)) for m in maps)
assert np.isfinite(total) and total > 0, total
assert not [m for m in sys.modules if m.startswith(("pandas", "h5py"))]
print("OK", len(maps), total)
"""
    r = _run(code)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("OK 12 ")


def test_compilation_cache_follows_env(tmp_path):
    """JAX_COMPILATION_CACHE_DIR moves the persistent cache there: compiled
    programs are written into it and no other directory is set."""
    code = """
import jax, jax.numpy as jnp
import pisa_tpu
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
print(jax.config.jax_compilation_cache_dir)
print(pisa_tpu.COMPILATION_CACHE_DIR)
jax.jit(lambda x: jnp.sin(x) * 2)(jnp.arange(5.0)).block_until_ready()
"""
    cache = tmp_path / "xla_cache"
    r = _run(code, {"JAX_COMPILATION_CACHE_DIR": str(cache)})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split() == [str(cache), str(cache)]
    assert cache.is_dir() and any(cache.iterdir())


def test_compilation_cache_default_in_checkout():
    """Without the variable the cache is one fixed directory in the
    checkout, with no host hash in its name."""
    r = _run(
        "import jax, pisa_tpu; print(jax.config.jax_compilation_cache_dir)",
        drop=("JAX_COMPILATION_CACHE_DIR",),
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == os.path.join(REPO, ".jax_cache")


def test_compilation_cache_none_when_installed(tmp_path):
    """A package outside a source checkout (no pyproject.toml beside it,
    as in site-packages) sets no cache directory of its own."""
    site = tmp_path / "site-packages"
    shutil.copytree(
        os.path.join(REPO, "pisa_tpu"), site / "pisa_tpu",
        ignore=shutil.ignore_patterns("resources", "__pycache__"),
    )
    r = _run(
        "import jax, pisa_tpu; print(pisa_tpu.__file__);"
        " print(jax.config.jax_compilation_cache_dir,"
        " pisa_tpu.COMPILATION_CACHE_DIR)",
        {"PYTHONPATH": str(site)}, drop=("JAX_COMPILATION_CACHE_DIR",),
        cwd=str(tmp_path),
    )
    assert r.returncode == 0, r.stderr[-3000:]
    where, cache = r.stdout.strip().splitlines()
    assert where.startswith(str(site))
    assert cache == "None None"


@pytest.mark.parametrize("compressed", [False, True])
def test_read_csv(tmp_path, compressed):
    text = "pdg,type,energy,label\n12,1,1.5,a\n-14,0,2.25e1,b\n"
    path = tmp_path / ("t.csv.bz2" if compressed else "t.csv")
    if compressed:
        path.write_bytes(bz2.compress(text.encode()))
    else:
        path.write_text(text)
    table = read_csv(str(path))
    assert list(table) == ["pdg", "type", "energy", "label"]
    np.testing.assert_array_equal(table["pdg"], [12.0, -14.0])
    np.testing.assert_array_equal(table["energy"], [1.5, 22.5])
    assert table["pdg"].dtype == np.float64
    assert list(table["label"]) == ["a", "b"]


def test_read_csv_numeric_fast_path(tmp_path):
    path = tmp_path / "n.csv"
    path.write_text("a,b\n1,2\n3,4\n5,6\n")
    table = read_csv(str(path))
    np.testing.assert_array_equal(table["a"], [1.0, 3.0, 5.0])
    np.testing.assert_array_equal(table["b"], [2.0, 4.0, 6.0])


@pytest.mark.parametrize("case", ["no_driver", "fake_driver", "lone_script"])
def test_chip_smoke_fails_without_gpu(tmp_path, case):
    """chip_smoke.py exits nonzero and prints no ok line without a GPU:
    with no nvidia-smi, with a fake one (JAX finds only the CPU, so the
    card-only test lane skips), and alone in a directory."""
    env = {}
    cwd = REPO
    script = os.path.join(REPO, "chip_smoke.py")
    if case != "no_driver":
        bindir = tmp_path / "bin"
        bindir.mkdir()
        fake = bindir / "nvidia-smi"
        fake.write_text("#!/bin/sh\necho 'Fake Card, 700.00 W'\n")
        fake.chmod(0o755)
        env["PATH"] = f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}"
    else:
        env["PATH"] = os.pathsep.join(
            d for d in os.environ.get("PATH", "").split(os.pathsep)
            if not os.path.exists(os.path.join(d, "nvidia-smi"))
        )
    if case == "lone_script":
        lone = tmp_path / "lone"
        lone.mkdir()
        shutil.copy(script, lone / "chip_smoke.py")
        cwd = str(lone)
        script = str(lone / "chip_smoke.py")
    envs = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    envs.update(env)
    envs["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, script], capture_output=True, text=True,
        cwd=cwd, env=envs, timeout=600,
    )
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(rec, dict) and rec.get("ok")), line
