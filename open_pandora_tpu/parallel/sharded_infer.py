"""Multi-chip synthesis: shard the DDIM denoise and the VAE decode over a
device mesh.

The reference scales inference by running independent prompts on separate
GPUs (ddp_wrapper.py + inference.py:276-282 rank sharding). Here we
additionally shard a SINGLE synthesis call over the mesh's data axis:

  - UNet denoise: the batched-CFG eval has leading dim b * n_streams
    (2 for 2-way CFG, 3 for 3-way; times the clip batch). `shard_map` over
    that axis runs each guidance stream / batch entry on its own chip with
    replicated weights — zero cross-device communication inside the step,
    so the cuDNN attention custom calls run unchanged per shard (a plain
    GSPMD sharding could force them to replicate).
  - VAE decode: frames are independent (perframe_ae, model.py:996);
    `shard_map` over the t axis decodes 16 frames on up to 16 chips.

Exactness: both paths compute bit-identical math to the unsharded versions
(tests/test_sharded_infer.py asserts equality on the CPU mesh).

Spec: SURVEY.md §2.7 SP row / §5.7 (sharding b·t over devices).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from open_pandora_tpu.parallel.mesh import MeshSpec


def _shard_map(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def sharded_apply_model(dc, ms: MeshSpec):
    """Returns apply(params, x, t, ctx, concat, fs) -> eps with the leading
    (b * n_streams) axis sharded over the data axis. Weights replicated.

    Drop-in for the `apply` closure inside image_guided_synthesis: divides
    the CFG-stream batch across chips; each chip evaluates the full UNet on
    its local streams (attention kernels intact)."""
    axis = ms.data_axis

    def local(params, x, t, ctx, concat, fs):
        return dc.apply_model(params, x, t, ctx, concat, fs=fs)

    def apply(params, x, t, ctx, concat, fs):
        n = ms.n_data
        if x.shape[0] % n != 0:
            raise ValueError(
                f"CFG-stream batch {x.shape[0]} not divisible by data "
                f"axis {n}; pick dp in {{1,2,..}} dividing b*n_streams")
        return _shard_map(
            local, ms.mesh,
            in_specs=(P(), P(axis), P(axis), P(axis), P(axis), P(axis)),
            out_specs=P(axis))(params, x, t, ctx, concat, fs)

    return apply


def sharded_synthesis(dc, ms: MeshSpec, params, **kw):
    """image_guided_synthesis with the CFG-stream batch sharded over the
    mesh. Same signature/semantics as DynamiCrafter.image_guided_synthesis
    (models/dynamicrafter.py:123)."""
    apply = sharded_apply_model(dc, ms)
    return dc.image_guided_synthesis(params, _apply_model=apply, **kw)


def sharded_decode(dc, ms: MeshSpec, params, z: jnp.ndarray,
                   frame_chunk: Optional[int] = None) -> jnp.ndarray:
    """decode_video with frames sharded over the data axis.

    z (b, T, hz, wz, 4); T must divide by the data axis size. Each chip
    decodes its local frames with the full VAE (perframe_ae semantics —
    frames never mix in the decoder)."""
    from open_pandora_tpu.models.vae import decode_video
    axis = ms.data_axis
    n = ms.n_data
    if z.shape[1] % n != 0:
        raise ValueError(f"temporal length {z.shape[1]} % mesh {n} != 0")
    chunk = frame_chunk or max(z.shape[1] // n, 1)

    def local(p, z_local):
        return decode_video(dc.vae, p["vae"], z_local,
                            scale_factor=dc.cfg.diffusion.scale_factor,
                            frame_chunk=chunk)

    return _shard_map(local, ms.mesh,
                      in_specs=(P(), P(None, axis)),
                      out_specs=P(None, axis))(params, z)
