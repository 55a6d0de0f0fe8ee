"""ChatWM's round-1 conditioning frames: the image repeated COND_FRAMES
times, the shape rounds 2+ pass, gives the latents of one frame tiled."""

import jax
import jax.numpy as jnp
import numpy as np

from open_pandora_tpu.models.dynamicrafter import DynamiCrafter
from open_pandora_tpu.pipeline.chat_wm import ChatWM
from tests.test_dynamicrafter import TINY, H, W


def test_round1_cond_frames_match_one_frame_tiled():
    model = DynamiCrafter(TINY)
    params = {"vae": model.vae.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, H, W, 3)))}
    frame = jax.random.uniform(jax.random.PRNGKey(1), (H, W, 3)) * 2 - 1
    one = model.get_latent_z(params, frame[None, None])
    rep = model.get_latent_z(params, jnp.broadcast_to(
        frame, (1, ChatWM.COND_FRAMES, H, W, 3)))
    assert rep.shape == one.shape == (1, TINY.unet.temporal_length,
                                      H // 2, W // 2, 4)
    np.testing.assert_allclose(np.asarray(rep), np.asarray(one), atol=1e-6)
