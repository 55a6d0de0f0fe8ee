"""Checkpoint IO: Orbax for native save/load + one-way torch import.

Replaces the reference's three-dialect checkpoint stack (SURVEY.md §5.4):
PL ModelCheckpoint / DeepSpeed writers (utils_train.py:35-88) -> Orbax;
HF/PL/DeepSpeed readers (model.py:487, utils_train.py:136-158) ->
load_torch_flat + core.convert.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import jax
import numpy as np


def _to_np(t) -> np.ndarray:
    # torch tensor (possibly bf16) -> numpy
    import torch

    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.float().numpy()
        return t.numpy()
    return np.asarray(t)


def load_torch_flat(path: str) -> Dict[str, np.ndarray]:
    """Load a torch checkpoint file (or a directory of HF shards) into a
    flat {key: ndarray}. Handles .bin/.pt/.ckpt (torch.load) and
    .safetensors."""
    files = []
    if os.path.isdir(path):
        for f in sorted(os.listdir(path)):
            if f.endswith((".bin", ".safetensors", ".pt", ".ckpt")):
                files.append(os.path.join(path, f))
    else:
        files = [path]
    flat: Dict[str, np.ndarray] = {}
    for f in files:
        if f.endswith(".safetensors"):
            from safetensors.numpy import load_file

            flat.update(load_file(f))
        else:
            import torch

            raw = torch.load(f, map_location="cpu", weights_only=False)
            if isinstance(raw, dict):
                for wrapper in ("state_dict", "module"):
                    if wrapper in raw and isinstance(raw[wrapper], dict):
                        raw = raw[wrapper]
                        break
                flat.update({k: _to_np(v) for k, v in raw.items()
                             if hasattr(v, "shape") or np.isscalar(v)})
    return flat


# -- orbax ------------------------------------------------------------------


def _orbax():
    """Orbax, imported on first use: only checkpoint directories need it."""
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError("Orbax checkpoint directories (--ckpt, saving "
                          "checkpoints) need orbax-checkpoint, which is not "
                          "installed") from e
    return ocp


def save_params(path: str, params: Any, step: Optional[int] = None):
    """Async-capable Orbax save of a params pytree."""
    ocp = _orbax()

    path = os.path.abspath(path)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.join(path, f"step_{step}") if step is not None else path,
               params, force=True)
    ckptr.wait_until_finished()


def restore_params(path: str, like: Any = None) -> Any:
    ocp = _orbax()

    ckptr = ocp.StandardCheckpointer()
    if like is not None:
        target = jax.tree_util.tree_map(ocp.utils.to_shape_dtype_struct, like)
        return ckptr.restore(os.path.abspath(path), target)
    return ckptr.restore(os.path.abspath(path))


def load_params(path: str, wm, *, height: int = 320, width: int = 512):
    """CLI loader: Orbax dir -> restore; torch file/HF dir -> convert.

    `wm` is a WorldModel (used for config + to build the target structure).
    When wm.quantize_llm is set, the converted LLaMA subtree is int8
    weight-only quantized (models/quant.py) so the composite fits one chip."""
    from open_pandora_tpu.core.convert import convert_world_model

    if os.path.isdir(path) and any(
            f.startswith(("checkpoint", "step_", "_METADATA", "d",))
            or f == "manifest.ocdbt" for f in os.listdir(path)):
        try:
            return restore_params(path)
        except Exception:
            pass
    flat = load_torch_flat(path)
    params = convert_world_model(flat, wm.cfg)
    qmode = getattr(wm, "quantize_llm", False)
    if qmode:
        from open_pandora_tpu.models.quant import quantize_llama_params

        params["llama"] = quantize_llama_params(
            params["llama"], mode=qmode if isinstance(qmode, str) else "int8")
    dtype = getattr(wm, "dtype", None)

    def put(x):
        x = np.asarray(x)
        # big float tensors to the compute dtype; 1-D leaves (norm scales,
        # int8 quantization scales) stay fp32 for accuracy
        if dtype is not None and x.ndim >= 2 and x.dtype in (np.float32,
                                                             np.float64):
            return jax.numpy.asarray(x, dtype=dtype)
        return jax.numpy.asarray(x)

    return jax.tree_util.tree_map(put, params)
