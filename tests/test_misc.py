"""Small-surface tests: config presets, image grids, checkpoint discovery,
compilation-cache hook."""

import os

import numpy as np

from open_pandora_tpu.core.config import load_config
from open_pandora_tpu.train.trainer import find_latest_checkpoint
from open_pandora_tpu.utils.image_grid import save_sample_grid, video_grid


def test_config_presets_load():
    ft = load_config(["configs/finetune.yaml"])
    assert ft.train.stage == "finetune" and ft.train.frame_stride == 6
    al = load_config(["configs/alignment.yaml"])
    assert al.train.lr_schedule == "cosine" and al.do_alignment
    hi = load_config(["configs/finetune_1024.yaml"])
    assert (hi.train.height, hi.train.width) == (576, 1024)
    assert hi.train.fixed_fps == 8
    # presets merge left-to-right with overrides on top
    both = load_config(["configs/finetune.yaml"],
                       overrides=["train.max_steps=5"])
    assert both.train.max_steps == 5


def test_video_grid_and_save(tmp_path):
    vid = np.random.RandomState(0).uniform(-1, 1, (2, 6, 8, 8, 3))
    g = video_grid(vid[0], max_frames=3)
    assert g.shape == (8, 8 * 3, 3) and g.dtype == np.uint8
    p = save_sample_grid(str(tmp_path / "g.png"), vid)
    assert os.path.exists(p)


def test_find_latest_checkpoint(tmp_path):
    assert find_latest_checkpoint(str(tmp_path / "nope")) is None
    for s in (10, 200, 30):
        os.makedirs(tmp_path / f"step_{s}")
    os.makedirs(tmp_path / "garbage")
    latest = find_latest_checkpoint(str(tmp_path))
    assert latest.endswith("step_200")


def test_cache_hook_env_off(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the hook leaves the directory to
    JAX and returns it."""
    import jax
    from open_pandora_tpu.core.cache import enable_compilation_cache
    saved = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    try:
        assert enable_compilation_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == saved
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
