"""CLI smoke for the measurement tools: argument surfaces parse and the
modules import cleanly on a CPU-only host (the heavy GPU bodies are
behind main()); prevents bit-rot of the perf harnesses between rounds."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _help(mod):
    return subprocess.run(
        [sys.executable, "-m", mod, "--help"], cwd=REPO,
        capture_output=True, text=True, timeout=240,
        env={"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
             "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", "HOME": REPO})


def test_profile_unet_help():
    r = _help("open_pandora_tpu.tools.profile_unet")
    assert r.returncode == 0, r.stderr
    assert "--profile" in r.stdout and "--iters" in r.stdout


def test_attention_bench_help():
    r = _help("open_pandora_tpu.tools.attention_bench")
    assert r.returncode == 0, r.stderr
    assert "--in-eval" in r.stdout and "--sites" in r.stdout


def test_clip_ab_help():
    r = _help("open_pandora_tpu.tools.clip_ab")
    assert r.returncode == 0, r.stderr
    assert "--iters" in r.stdout


def test_scienceqa_help():
    r = _help("open_pandora_tpu.eval.scienceqa")
    assert r.returncode == 0, r.stderr
    assert "run" in r.stdout and "score" in r.stdout


def test_consistency_help():
    r = _help("open_pandora_tpu.eval.consistency")
    assert r.returncode == 0, r.stderr
    assert "--video-folder" in r.stdout
