"""Sequence-parallel model execution, the counterpart of
``pianobart_tpu/parallel/sp.py``.

Runs a PianoBart module with the SEQUENCE axis sharded over the mesh's
``sp`` axis: attention becomes ring attention (``ops/ring.py``), positional
embeddings take the shard's global offset, and the position-wise compute
(LayerNorm, FFN, embeddings, heads) runs on the local shard as it is.
Sequences of ``sp * local_len`` flow through the same weights.
"""
from __future__ import annotations

import torch

from .mesh import Mesh, all_gather, use_mesh

__all__ = ["encode_sp"]


def encode_sp(model, encoder_ids: torch.Tensor, encoder_mask: torch.Tensor,
              mesh: Mesh, axis_name: str = "sp") -> torch.Tensor:
    """The encoder's output ``(B, S, d_model)`` for ``encoder_ids (B, S, 8)``
    with the sequence sharded over ``axis_name``: each rank encodes its
    columns, the shards are gathered, so every rank returns the whole
    output (the reference returns the global array).  ``model`` (a
    ``PianoBart`` or ``PianoBartLM``) must be built with
    ``cfg.ring_axis == axis_name``; S must divide by the axis size."""
    if model.cfg.ring_axis != axis_name:
        raise ValueError(f"the model's cfg.ring_axis is {model.cfg.ring_axis!r}, "
                         f"not {axis_name!r}")
    ids, mask = mesh.cols(encoder_ids), mesh.cols(encoder_mask)
    with use_mesh(mesh):
        out = model.encode(ids, mask)
    return all_gather(out, mesh.axis(axis_name), dim=1)
