"""Tensor parallelism for the frozen wav2vec2 encoder (Megatron layout).

Port of ``paa_tpu/parallel/tp.py`` against the port's HF parameter names.
Each rank of a ``model`` slice holds ``num_heads / tp`` attention heads and
``intermediate_size / tp`` FFN columns: q/k/v and ``intermediate_dense`` are
column-parallel (weight and bias split on dim 0, the output features),
``out_proj`` and ``output_dense`` row-parallel (weight split on dim 1, the
input features; the bias is replicated and added once, after the reduce).
Everything else (the feature extractor, the positional conv, the
LayerNorms, ``lm_head``) is replicated. The reference lets XLA partition
the matmuls from parameter shardings; here two autograd functions carry the
collectives of each residual branch:

  * :func:`copy_to_model` at the branch's input: identity forward,
    all-reduce of the gradient backward. The attack differentiates with
    respect to the *waveform*: without it ∂loss/∂p would hold this rank's
    heads only.
  * :func:`reduce_from_model` at the branch's output: all-reduce of the
    row-parallel partial sums forward, identity backward.

Both reduce in float32 and cast back to the compute dtype, so the gloo
route and the NCCL route give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

# HF module names → how the layer's parameters split over ``model``
_COL_SUFFIXES = ("q_proj", "k_proj", "v_proj", "intermediate_dense")
_ROW_SUFFIXES = ("out_proj", "output_dense")


def param_spec(name: str) -> int | None:
    """The dim of parameter ``name`` (an HF state-dict key) split over the
    ``model`` axis, or None where it is replicated."""
    parts = name.split(".")
    if len(parts) >= 2:
        owner, leaf = parts[-2], parts[-1]
        if owner in _COL_SUFFIXES:
            return 0  # weight (out, in) and bias (out,): the output features
        if owner in _ROW_SUFFIXES and leaf == "weight":
            return 1  # weight (out, in): the contraction dim
    return None


def check_model_axis(mcfg, n_model: int) -> None:
    """Validate that ``n_model`` tensor-parallel shards divide the model's
    sharded dimensions (attention heads and FFN hidden)."""
    if n_model <= 1:
        return
    if mcfg.family != "wav2vec2":  # the Megatron layout below is wav2vec2's
        raise ValueError(f"tensor-parallel size {n_model}: the {mcfg.family} family has no "
                         "tensor-parallel layout")
    if mcfg.num_attention_heads % n_model != 0:
        raise ValueError(
            f"tensor-parallel size {n_model} must divide "
            f"num_attention_heads={mcfg.num_attention_heads}"
        )
    if mcfg.intermediate_size % n_model != 0:
        raise ValueError(
            f"tensor-parallel size {n_model} must divide "
            f"intermediate_size={mcfg.intermediate_size}"
        )


def shard_params(state_dict: dict, rank: int, n_model: int) -> dict:
    """Rank ``rank``'s slice of a full state dict on an ``n_model``-way
    model axis (each split tensor a contiguous copy)."""
    out = {}
    for name, t in state_dict.items():
        dim = param_spec(name)
        if dim is None or n_model == 1:
            out[name] = t
        else:
            if t.shape[dim] % n_model:
                raise ValueError(f"{name} {tuple(t.shape)}: dim {dim} does not split "
                                 f"over {n_model}")
            out[name] = torch.chunk(t, n_model, dim)[rank].contiguous()
    return out


class ModelAxis(NamedTuple):
    """This rank's place on the ``model`` axis: the slice's process group,
    its size and this rank's coordinate."""

    group: object
    size: int
    rank: int


def model_axis(mesh) -> ModelAxis | None:
    """The ``model`` axis of ``mesh``, or None without one (or at size 1)."""
    if mesh is None or mesh.shape.get("model", 1) <= 1:
        return None
    return ModelAxis(mesh.group("model"), mesh.shape["model"], mesh.coords["model"])


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    t = x.to(torch.float32, copy=True)
    dist.all_reduce(t, group=group)
    return t.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """Identity forward; the gradient summed over the model axis backward."""
    return _CopyToModel.apply(x, axis.group)


def reduce_from_model(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The partial sums of every rank of the model axis, summed in float32;
    identity backward."""
    return _ReduceFromModel.apply(x, axis.group)


def row_parallel(x: torch.Tensor, layer: torch.nn.Linear, axis: ModelAxis, dtype) -> torch.Tensor:
    """A row-parallel linear layer: the local partial product, reduced over
    the model axis, then the replicated bias added once."""
    partial = F.linear(x.to(dtype), layer.weight.to(dtype))
    return reduce_from_model(partial, axis) + layer.bias.to(dtype)


def shard_model(model, mesh):
    """A copy of the full ``Wav2Vec2ForCTC`` ``model`` that holds this rank's
    slice on the mesh's ``model`` axis, on the same device, with each
    parameter's storage dtype kept; the model itself if the mesh has no
    model axis."""
    from paa_tpu_torch.models import wav2vec2

    axis = model_axis(mesh)
    if axis is None:
        return model
    check_model_axis(model.cfg, axis.size)
    device = next(model.parameters()).device
    sharded = wav2vec2.Wav2Vec2ForCTC(model.cfg, model_axis=axis)
    sharded.load_state_dict(shard_params(model.state_dict(), axis.rank, axis.size), assign=True)
    return sharded.to(device).requires_grad_(False).eval()
