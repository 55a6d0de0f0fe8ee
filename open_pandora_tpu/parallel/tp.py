"""Tensor-parallel sharding rules (the ('model',) mesh axis).

New capability vs the reference (SURVEY.md §2.7: no TP exists there) —
Megatron-style column/row partitioning of the LLaMA projections expressed
as GSPMD sharding specs; XLA inserts the all-reduces:

  q/k/v/gate/up kernels (in, out)  -> P(None, 'model')   (column parallel)
  o/down kernels        (in, out)  -> P('model', None)   (row parallel)
  embeddings / norms / lm_head     -> replicated

Because attention heads = 32 and mlp intermediate = 11008 are divisible by
any practical model-axis size, activations shard head-wise automatically
via propagation.
"""

from __future__ import annotations

from typing import Any

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from open_pandora_tpu.parallel.mesh import MeshSpec

_COLUMN = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW = ("o_proj", "down_proj")


def llama_param_shardings(ms: MeshSpec, llama_params: Any):
    """Pytree of NamedShardings for a LlamaForCausalLM params tree (works
    for both fp and int8-quantized layouts)."""
    axis = ms.model_axis

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        parent = path[-2] if len(path) >= 2 else ""
        leaf = path[-1]
        if parent in _COLUMN and leaf in ("kernel", "kernel_q"):
            return ms.named(None, axis)
        if parent in _COLUMN and leaf == "scale" and node.ndim == 1:
            return ms.named(axis)
        if parent in _ROW and leaf in ("kernel", "kernel_q"):
            return ms.named(axis, None)
        return ms.named()  # replicated (norms, embeds, row-parallel scales)

    return walk(llama_params, ())


def shard_llama_params(ms: MeshSpec, llama_params: Any):
    """device_put the LLaMA subtree with TP shardings applied."""
    specs = llama_param_shardings(ms, llama_params)
    return jax.tree_util.tree_map(jax.device_put, llama_params, specs)
