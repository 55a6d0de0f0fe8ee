"""Compute ops: the attention dispatcher and the norm primitives.

Replaces the reference's CUDA dependency layer (SURVEY.md §2.6):
  - xformers memory_efficient_attention  -> ops.attention (Pallas flash)
  - flash-attn varlen (LLaMA)            -> ops.attention(causal=True)
  - cuDNN GroupNorm/SiLU                 -> ops.norms (fp32-accum XLA, fused)
Every kernel has a pure-XLA twin used on CPU and as the parity oracle.
"""

from open_pandora_tpu.ops.attention import attention  # noqa: F401
from open_pandora_tpu.ops.norms import group_norm, layer_norm, rms_norm  # noqa: F401
