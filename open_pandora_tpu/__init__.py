"""Open-Pandora in JAX — a world-model video generation framework with the
capabilities of OpenSparseLLMs/Open-Pandora, run on an NVIDIA GPU.

Architecture (vs. reference /root/reference, see SURVEY.md):
  - frozen multimodal LLM (LLaMA-7B + CLIP ViT-L tower + DPC-KNN token
    clustering) reads image + action text -> hidden states
  - trainable connector (learned prefix rows + BLIP-2 Q-Former + projections)
    maps hidden states into the diffusion cross-attention space
  - DynamiCrafter-style latent video diffusion (UNet3D + SD VAE + OpenCLIP
    encoders + DDIM) denoises 16-frame latent videos
  - up to 5 autoregressive rounds chain last frames into the next round.

All compute paths are JAX: `lax.scan` DDIM with batched CFG, cuDNN fused
attention through one dispatcher (ops/attention.py), bf16 matmuls, fp32
schedules/softmax, sharding via `jax.sharding.Mesh` + NamedSharding
(DP/ZeRO-2 as sharding specs, not a library).
"""

__version__ = "0.1.0"
