"""What the program needs from the machine it runs on: the compile cache's
place, multi-process launch from the environment, the packages the main
path imports, and chip_smoke.py's refusal to run without a GPU."""

import os
import subprocess
import sys

import pytest

from open_pandora_tpu.core import cache
from open_pandora_tpu.parallel import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_config():
    import jax
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield jax
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_cache_defaults_to_repo_dir(monkeypatch, restore_cache_config):
    jax = restore_cache_config
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compilation_cache()
    assert path == os.path.join(REPO, ".jax_cache") == cache.cache_dir()
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)


def test_cache_honours_env_dir(monkeypatch, tmp_path, restore_cache_config):
    jax = restore_cache_config
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    assert cache.enable_compilation_cache() == str(tmp_path / "jc")
    # JAX reads the variable itself: the program sets no directory
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_dir_is_ignored_by_git():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.fixture
def no_launch_env(monkeypatch):
    for name in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    calls = []
    import jax
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    return monkeypatch, calls


def test_launch_single_process_is_noop(no_launch_env):
    _, calls = no_launch_env
    assert launch.init_distributed() is False and calls == []


def test_launch_reads_env(no_launch_env):
    mp, calls = no_launch_env
    mp.setenv("COORDINATOR_ADDRESS", "localhost:12355")
    mp.setenv("NUM_PROCESSES", "4")
    mp.setenv("PROCESS_ID", "2")
    assert launch.init_distributed() is True
    assert calls == [{"coordinator_address": "localhost:12355",
                      "num_processes": 4, "process_id": 2}]


def test_launch_arguments_beat_env(no_launch_env):
    mp, calls = no_launch_env
    mp.setenv("COORDINATOR_ADDRESS", "localhost:1")
    mp.setenv("NUM_PROCESSES", "4")
    mp.setenv("PROCESS_ID", "2")
    launch.init_distributed("localhost:2", 2, 0)
    assert calls == [{"coordinator_address": "localhost:2",
                      "num_processes": 2, "process_id": 0}]


def test_launch_incomplete_env_and_failure_raise(no_launch_env, monkeypatch):
    mp, _ = no_launch_env
    mp.setenv("COORDINATOR_ADDRESS", "localhost:12355")
    with pytest.raises(ValueError, match="NUM_PROCESSES"):
        launch.init_distributed()
    mp.setenv("NUM_PROCESSES", "2")
    mp.setenv("PROCESS_ID", "0")

    def fail(**kw):
        raise RuntimeError("coordinator unreachable")

    import jax
    monkeypatch.setattr(jax.distributed, "initialize", fail)
    with pytest.raises(RuntimeError, match="unreachable"):
        launch.init_distributed()


# Packages the machine with the card is not sure to have. The main path
# must import without them.
BLOCKED = ("flax", "PIL", "cv2", "yaml", "orbax", "torch", "triton")
_BLOCKER = f"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
"""


def _run(code, cwd=REPO, timeout=240):
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": REPO if cwd == REPO else "",
           "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", cwd)}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("module", [
    "chip_smoke", "open_pandora_tpu.pipeline.chat_wm",
    "open_pandora_tpu.pipeline.cli", "open_pandora_tpu.models.world_model",
    "open_pandora_tpu.train.step", "open_pandora_tpu.parallel.sharded_infer",
])
def test_main_path_imports_without_optional_packages(module):
    r = _run(_BLOCKER + f"import {module}\n"
             "bad = sorted(m for m in sys.modules "
             f"if m.split('.')[0] in {BLOCKED!r})\n"
             "assert not bad, bad\n")
    assert r.returncode == 0, r.stderr[-3000:]


def test_chip_smoke_fails_without_gpu():
    r = _run("import sys, chip_smoke; sys.exit(chip_smoke.main([]))")
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=240,
                       env={"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
                            "JAX_PLATFORMS": "cpu",
                            "HOME": str(tmp_path)})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("call,words", [
    ("from open_pandora_tpu.core.config import load_config\n"
     "load_config(['cfg.yaml'])", "--config"),
    ("from open_pandora_tpu.core.checkpoint import restore_params\n"
     "restore_params('ckpt')", "--ckpt"),
    ("import numpy as np\n"
     "from open_pandora_tpu.utils.video_io import write_video\n"
     "write_video('o.mp4', np.zeros((1, 8, 8, 3), np.uint8))", "OpenCV"),
    ("from open_pandora_tpu.pipeline.cli import read_image\n"
     "read_image('a.png')", "--image"),
], ids=["yaml", "orbax", "cv2", "pil"])
def test_optional_package_missing_names_the_option(call, words):
    r = _run(_BLOCKER + "try:\n" + "".join(
        f"    {ln}\n" for ln in call.splitlines())
        + "except ImportError as e:\n    print(e)\n")
    assert r.returncode == 0, r.stderr[-3000:]
    assert words in r.stdout, r.stdout
