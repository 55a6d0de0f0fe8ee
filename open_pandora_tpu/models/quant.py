"""Weight-only int8 quantization for the frozen LLaMA trunk.

Why: the 7B LLM's projection matrices are most of a WorldModel's weights
(bf16: 13.5 GB of ~19 GB). Per-output-channel symmetric int8 on them
brings the composite to ~12.3 GB, for devices or deployments where memory
is short.

The LLM is FROZEN in every Open-Pandora training stage
(model.py:517-553 freeze_sub_models), so quantization error is a pure
inference trade-off, applied after conversion from the released weights.
(The reference's bitsandbytes 4/8-bit option at ChatUniVi/train/train.py:
869-884 is the analogous capability.)
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

# 2D kernels under these path components get quantized
_QUANT_PARENT_KEYS = ("self_attn", "mlp")
_QUANT_LEAF_MODULES = ("q_proj", "k_proj", "v_proj", "o_proj",
                       "gate_proj", "up_proj", "down_proj", "lm_head")


def quantize_kernel(w) -> Dict[str, Any]:
    """(in, out) float -> {'kernel_q': int8, 'scale': fp32 (out,)}."""
    w = np.asarray(w, dtype=np.float32)
    scale = np.abs(w).max(axis=0) / 127.0
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {"kernel_q": q, "scale": scale.astype(np.float32)}


def dequantize_kernel(q: jnp.ndarray, scale: jnp.ndarray,
                      dtype=jnp.bfloat16) -> jnp.ndarray:
    return (q.astype(jnp.float32) * scale).astype(dtype)


# 16-entry normalized-float-4 codebook (QLoRA appendix E / bitsandbytes
# functional.py create_normal_map): quantiles of N(0,1) scaled to [-1, 1].
NF4_CODE = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0], dtype=np.float32)

NF4_BLOCK = 64  # bitsandbytes default blocksize for nf4


def quantize_kernel_nf4(w, block: int = NF4_BLOCK) -> Dict[str, Any]:
    """(in, out) float -> {'kernel_p': uint8 (in//2, out) two codes/byte,
    'absmax': fp32 (in//block, out)}. Blockwise along the INPUT axis (the
    2D analog of bitsandbytes' flat 64-element blocks): each block of 64
    input rows per output column shares one absmax; values normalize to
    [-1, 1] and snap to the nearest NF4 codebook entry.

    Reference capability: ChatUniVi/model/builder.py:36-47 load_in_4bit
    (bitsandbytes nf4). in must be even (all LLaMA dims are)."""
    w = np.asarray(w, dtype=np.float32)
    n_in, n_out = w.shape
    assert n_in % 2 == 0, "input dim must be even to pack two codes/byte"
    n_blk = -(-n_in // block)
    pad = n_blk * block - n_in
    wp = np.pad(w, ((0, pad), (0, 0))).reshape(n_blk, block, n_out)
    absmax = np.abs(wp).max(axis=1)                       # (n_blk, out)
    absmax = np.where(absmax == 0, 1.0, absmax)
    norm = wp / absmax[:, None, :]                        # [-1, 1]
    # nearest codebook entry (NF4_CODE is sorted; 16 entries -> argmin ok)
    codes = np.abs(norm.reshape(n_blk * block, n_out)[..., None]
                   - NF4_CODE).argmin(axis=-1).astype(np.uint8)[:n_in]
    packed = (codes[0::2] | (codes[1::2] << 4)).astype(np.uint8)
    return {"kernel_p": packed, "absmax": absmax.astype(np.float32)}


def dequantize_kernel_nf4(kernel_p, absmax, dtype=jnp.bfloat16,
                          block: int = NF4_BLOCK) -> jnp.ndarray:
    """Inverse of quantize_kernel_nf4 — unpack nibbles, codebook lookup,
    per-block rescale. XLA fuses this into the consuming matmul's read."""
    n_half, n_out = kernel_p.shape
    n_in = 2 * n_half
    lo = (kernel_p & 0xF).astype(jnp.int32)
    hi = (kernel_p >> 4).astype(jnp.int32)
    codes = jnp.stack([lo, hi], axis=1).reshape(n_in, n_out)
    vals = jnp.asarray(NF4_CODE)[codes]                   # (in, out) fp32
    scale = jnp.repeat(absmax, block, axis=0)[:n_in]
    return (vals * scale).astype(dtype)


def quantize_llama_params(params: dict, mode: str = "int8") -> dict:
    """Full-precision LlamaForCausalLM params -> weight-only-quantized tree
    matching the quantized-module structure: every projection Dense's
    {kernel} becomes {kernel_q, scale} (mode='int8') or {kernel_p, absmax}
    (mode='nf4', the bitsandbytes load_in_4bit analog)."""
    assert mode in ("int8", "nf4"), mode
    qfn = quantize_kernel if mode == "int8" else quantize_kernel_nf4

    def walk(node, name=""):
        if isinstance(node, dict):
            if name in _QUANT_LEAF_MODULES and "kernel" in node:
                return qfn(node["kernel"])
            return {k: walk(v, k) for k, v in node.items()}
        return node

    return walk(params)


def tree_nbytes(params) -> int:
    return sum(x.size * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(params)
               if hasattr(x, "dtype"))
