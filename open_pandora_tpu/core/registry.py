"""Name -> constructor registry: the JAX resolution of the
reference's `instantiate_from_config` reflection grammar.

The reference builds its whole diffusion graph from yaml
`{target: dotted.torch.path, params: {...}}` nodes
(DynamiCrafter/utils/utils.py:27-42; used throughout
configs/inference_512_v1.0.yaml). This framework replaces reflection with
a typed config tree (core/config.py), but keeps the target GRAMMAR
resolvable so reference yamls and checkpoint configs can be mapped
mechanically: every dotted target the reference tree can name resolves to
the corresponding JAX module/class here.

    resolve_target("lvdm.modules.networks.openaimodel3d.UNetModel")
        -> open_pandora_tpu.models.unet3d.UNetModel

`build_from_target` instantiates, forwarding params; dataclass-config
modules (UNetModel(cfg)) accept a pre-built config object via cfg=.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

# reference dotted target -> "module_path:attr" here. Lazy import keeps
# torch-dependent modules (none today) and heavy towers out of cold paths.
_TARGETS: Dict[str, str] = {
    # composite / diffusion stack
    "lvdm.models.ddpm3d.LatentDiffusion":
        "open_pandora_tpu.models.dynamicrafter:DynamiCrafter",
    "lvdm.models.ddpm3d.LatentVisualDiffusion":
        "open_pandora_tpu.models.dynamicrafter:DynamiCrafter",
    "lvdm.modules.networks.openaimodel3d.UNetModel":
        "open_pandora_tpu.models.unet3d:UNetModel",
    "lvdm.models.autoencoder.AutoencoderKL":
        "open_pandora_tpu.models.vae:AutoencoderKL",
    "lvdm.modules.encoders.resampler.Resampler":
        "open_pandora_tpu.models.encoders:Resampler",
    # conditioning encoders (shipped pair)
    "lvdm.modules.encoders.condition.FrozenOpenCLIPEmbedder":
        "open_pandora_tpu.models.encoders:CLIPTextEncoder",
    "lvdm.modules.encoders.condition.FrozenOpenCLIPImageEmbedderV2":
        "open_pandora_tpu.models.encoders:CLIPVisionEncoder",
    # conditioning encoders (alternative set, encoders_extra)
    "lvdm.modules.encoders.condition.FrozenT5Embedder":
        "open_pandora_tpu.models.encoders_extra:T5Encoder",
    "lvdm.modules.encoders.condition.FrozenCLIPEmbedder":
        "open_pandora_tpu.models.encoders_extra:HFCLIPTextEncoder",
    "lvdm.modules.encoders.condition.ClassEmbedder":
        "open_pandora_tpu.models.encoders_extra:ClassEmbedder",
    "lvdm.modules.encoders.condition.ClipImageEmbedder":
        "open_pandora_tpu.models.encoders_extra:PooledCLIPImageEncoder",
    "lvdm.modules.encoders.condition.FrozenCLIPT5Encoder":
        "open_pandora_tpu.models.encoders_extra:CLIPT5Pair",
    "lvdm.modules.encoders.condition.IdentityEncoder":
        "open_pandora_tpu.core.registry:_identity",
    "torch.nn.Identity":
        "open_pandora_tpu.core.registry:_identity",
    # samplers
    "lvdm.models.samplers.ddim.DDIMSampler":
        "open_pandora_tpu.diffusion.ddim:ddim_sample",
}


def _identity(x: Any = None, **_: Any) -> Any:
    return x


def resolve_target(target: str) -> Callable:
    """Reference dotted target string -> the equivalent class/function."""
    try:
        spec = _TARGETS[target]
    except KeyError:
        raise KeyError(
            f"unknown reference target {target!r}; known: "
            f"{sorted(_TARGETS)}") from None
    mod, attr = spec.split(":")
    return getattr(importlib.import_module(mod), attr)


def build_from_target(node: Dict[str, Any], **overrides: Any) -> Any:
    """Instantiate a `{target: ..., params: {...}}` yaml node.

    `overrides` win over the node's params. Modules whose constructor
    takes a typed config (UNetModel(cfg), CLIPTextEncoder(cfg), ...) get
    it via a `cfg=` override; raw reference params for those are NOT
    auto-translated (field names differ by design — see core/config.py).
    """
    ctor = resolve_target(node["target"])
    params = dict(node.get("params", {}))
    params.update(overrides)
    return ctor(**params) if params else ctor()
