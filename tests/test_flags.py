"""core/flags.py — the single PANDORA_* knob registry."""

import os

import pytest

from open_pandora_tpu.core import flags


def test_defaults():
    assert flags.flag("PANDORA_DISABLE_TCONV_DOT") is False
    assert flags.flag("PANDORA_FINE_REMAT") is False
    assert flags.flag("PANDORA_CLIP_BPE") == ""


def test_env_override(monkeypatch):
    monkeypatch.setenv("PANDORA_DISABLE_TCONV_DOT", "1")
    assert flags.flag("PANDORA_DISABLE_TCONV_DOT") is True
    monkeypatch.setenv("PANDORA_DISABLE_TCONV_DOT", "0")
    assert flags.flag("PANDORA_DISABLE_TCONV_DOT") is False
    monkeypatch.setenv("PANDORA_CKPT_DIR", "/ckpt")
    assert flags.flag("PANDORA_CKPT_DIR") == "/ckpt"


def test_programmatic_override_beats_env(monkeypatch):
    monkeypatch.setenv("PANDORA_FINE_REMAT", "")
    with flags.overridden(FINE_REMAT=True):
        assert flags.flag("PANDORA_FINE_REMAT") is True
        assert flags.snapshot() == {"PANDORA_FINE_REMAT": True}
    assert flags.flag("PANDORA_FINE_REMAT") is False


def test_undeclared_flag_rejected():
    with pytest.raises(KeyError):
        flags.set_flag("PANDORA_NOT_A_FLAG", 1)
    with pytest.raises(KeyError):
        flags.flag("PANDORA_NOT_A_FLAG")


def test_snapshot_reflects_env(monkeypatch):
    monkeypatch.setenv("PANDORA_DISABLE_TCONV_DOT", "1")
    snap = flags.snapshot()
    assert snap.get("PANDORA_DISABLE_TCONV_DOT") is True


def test_table_covers_registry():
    t = flags.table()
    for name in flags.REGISTRY:
        assert name in t


def test_no_raw_env_reads_in_models_ops():
    """The verdict's done-criterion: grep for os.environ under models/ and
    ops/ finds only the flags shim (which lives in core/)."""
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "open_pandora_tpu")
    offenders = []
    for sub in ("models", "ops", "diffusion"):
        d = os.path.join(root, sub)
        for fn in os.listdir(d):
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(d, fn)) as f:
                if "os.environ" in f.read():
                    offenders.append(f"{sub}/{fn}")
    assert offenders == []
