"""Layout rules of sharded training state (counterpart of the JAX package's parallel/sharding.py:49-193).

The JAX trainer stores its parameters, Adam's moments and the EMA under
PartitionSpecs: the tensor-parallel rule shards the last dim of every
kernel and bias over the ``'model'`` axis (:49-81), the FSDP rule shards
each large tensor's largest dividing dim over ``'data'`` (:98-143), the
moments and the EMA mirror their parameter and scalars replicate
(:146-185). Here the same rules are pure functions of the port's state:
each returns, for one tensor, the dim of the **port's** tensor that the
rule shards, or None.

The rules speak of JAX shapes, and the port holds some tensors in another
layout (``convert.py``): a ``Linear`` kernel ``(in, out)`` is ``(out, in)``
here, the attention's ``(c, H, D)`` and ``(H, D, c)`` kernels are
``(H*D, c)`` and ``(c, H*D)``, a 1x1 conv's ``(1, in, out)`` is ``(out,
in)``, a conv's ``(1, kh, kw, cin, cout)`` is ``(cout, cin, kh, kw)``, the
transposed conv's ``(cin, cout, kh, kw)``. So :func:`jax_layout` gives each
state key its JAX leaf kind, its JAX shape and the port dim each JAX dim
lands in, and every rule runs on the JAX shape and maps its answer through
that table. JAX's leaf-name test (``kernel`` and ``w`` are weights, ``bias``
a bias, and ``b`` a bias under a path holding ``Linear`` or ``mlp``) becomes
a test of the port's module types: a ``Linear``, 1x1 conv, conv or
transposed conv holds a kernel in ``weight``, a norm's ``weight`` is JAX's
``scale`` and an embedding's its ``embedding`` (neither sharded by the
tensor-parallel rule), every ``bias`` is a bias.

The rules take the leaf names as JAX's own tests/test_parallel.py gives
them. The JAX trainer maps the rule over an ``nnx.State``, whose flattened
paths under flax 0.12 end in the Variable's ``value``: there its leaf-name
test never matches, and its model-shard layout replicates every tensor
(FSDP, which reads no names, shards as stated). The port stores state by the
rule as it is written.
"""

from __future__ import annotations

from dataclasses import dataclass

from torch import nn

from video_diffusion_nnx_tpu_torch.models.attention import MultiheadAttention
from video_diffusion_nnx_tpu_torch.models.layers import Linear, PointwiseConv, PseudoConv3d, PseudoConvTranspose3d

MIN_SIZE_TO_SHARD = 2**14  # the FSDP rule's default, JAX fsdp_partition_spec


@dataclass(frozen=True)
class Leaf:
    """A state tensor as the JAX package holds it: its leaf kind, its shape, and the port dim of each JAX dim."""

    kind: str  # "kernel" (JAX kernel or w), "bias", or "other" (norm scales, embeddings, buffers, ...)
    shape: tuple[int, ...]
    dims: tuple[int | None, ...]  # dims[i]: the port dim JAX dim i lands in (None: a dim of one the port drops)


def _kernel_leaf(module: nn.Module, parent: nn.Module | None, name: str, port_shape) -> Leaf:
    if isinstance(parent, MultiheadAttention):  # nnx.LinearGeneral kernels
        h, d, c = parent.heads, parent.dim, port_shape[1] if name != "out" else port_shape[0]
        if name == "out":  # (H, D, c) -> (c, H*D)
            return Leaf("kernel", (h, d, c), (1, 1, 0))
        return Leaf("kernel", (c, h, d), (1, 0, 0))  # (c, H, D) -> (H*D, c)
    if isinstance(module, PointwiseConv):  # (1, in, out) -> (out, in)
        out_f, in_f = port_shape
        return Leaf("kernel", (1, in_f, out_f), (None, 1, 0))
    if isinstance(module, Linear):  # (in, out) -> (out, in)
        out_f, in_f = port_shape
        return Leaf("kernel", (in_f, out_f), (1, 0))
    if isinstance(module, PseudoConvTranspose3d):  # (1, kh, kw, cin, cout) -> (cin, cout, kh, kw)
        cin, cout, kh, kw = port_shape
        return Leaf("kernel", (1, kh, kw, cin, cout), (None, 2, 3, 0, 1))
    if isinstance(module, PseudoConv3d):  # (1, kh, kw, cin, cout) -> (cout, cin, kh, kw)
        cout, cin, kh, kw = port_shape
        return Leaf("kernel", (1, kh, kw, cin, cout), (None, 2, 3, 1, 0))
    return Leaf("other", tuple(port_shape), tuple(range(len(port_shape))))  # a norm's scale, an embedding


def jax_layout(model: nn.Module) -> dict[str, Leaf]:
    """Every ``state_dict`` key of ``model`` with its JAX leaf (the inverse of ``convert.state_dict_from_nnx``)."""
    modules = dict(model.named_modules())
    out = {}
    for key, value in model.state_dict().items():
        owner, _, leaf = key.rpartition(".")
        module = modules[owner]
        parent_name, _, name = owner.rpartition(".")
        parent = modules.get(parent_name) if owner else None
        shape = tuple(value.shape)
        identity = tuple(range(len(shape)))
        if leaf == "weight":
            out[key] = _kernel_leaf(module, parent, name, shape)
        elif leaf == "bias" and isinstance(parent, MultiheadAttention) and name != "out":
            out[key] = Leaf("bias", (parent.heads, parent.dim), (0, 0))  # (H, D) -> (H*D,)
        elif leaf == "bias" or (leaf == "b" and any("Linear" in p or "mlp" in p for p in key.split("."))):
            out[key] = Leaf("bias", shape, identity)
        elif leaf == "w":
            out[key] = Leaf("kernel", shape, identity)
        else:
            out[key] = Leaf("other", shape, identity)
    return out


def param_partition_spec(leaf: Leaf, model_axis_size: int) -> int | None:
    """The tensor-parallel rule (JAX ``param_partition_spec``): a kernel's or bias's last JAX dim over ``'model'``,
    where it divides. Returns the port dim it shards, or None."""
    if model_axis_size <= 1 or leaf.kind == "other" or not leaf.shape:
        return None
    if leaf.shape[-1] % model_axis_size:
        return None  # replicated: the last dim does not divide
    return leaf.dims[-1]


def fsdp_partition_spec(leaf: Leaf, data_axis_size: int, min_size_to_shard: int = MIN_SIZE_TO_SHARD) -> int | None:
    """The FSDP rule (JAX ``fsdp_partition_spec``): a tensor of at least ``min_size_to_shard`` elements over
    ``'data'`` along its largest JAX dim that divides, ties to the last. Returns the port dim it shards, or None."""
    if data_axis_size <= 1 or not leaf.shape:
        return None
    size = 1
    for d in leaf.shape:
        size *= d
    if size < min_size_to_shard:
        return None
    best = None
    for i, d in enumerate(leaf.shape):
        if d % data_axis_size == 0 and (best is None or d >= leaf.shape[best]):
            best = i
    return None if best is None else leaf.dims[best]


def state_partition_specs(model: nn.Module, param_sharding: str, axis_size: int,
                          min_size_to_shard: int = MIN_SIZE_TO_SHARD) -> dict[str, int | None]:
    """The sharded port dim of every state key under ``param_sharding`` ("tensor": over a model axis of
    ``axis_size``; "fsdp": over a data axis of ``axis_size``). Adam's two moments and the EMA of a key mirror
    it (JAX ``mirror_partition_spec``); Adam's step count is a scalar and replicates."""
    layout = jax_layout(model)
    if param_sharding == "tensor":
        return {k: param_partition_spec(leaf, axis_size) for k, leaf in layout.items()}
    if param_sharding == "fsdp":
        return {k: fsdp_partition_spec(leaf, axis_size, min_size_to_shard) for k, leaf in layout.items()}
    raise ValueError(f"param_sharding must be 'tensor' or 'fsdp'; got {param_sharding!r}")
