"""The port's layout rules of sharded state (``parallel/sharding.py``) against the JAX package's, on the CPU.

The JAX rules (parallel/sharding.py: ``param_partition_spec``, the last dim
of kernels and biases over ``'model'``; ``fsdp_partition_spec``, the largest
dividing dim over ``'data'`` at ``min_size_to_shard`` elements or more;
``optimizer_partition_specs``, Adam's moments mirroring their parameter)
run on the JAX state of the fixture Unet3D and of a conditioned VideoDiT,
as a tree keyed by the state's paths (``kernel``, ``bias``, ``scale`` ...
as the leaf names, the form JAX's own tests/test_parallel.py gives the
rules); the port's on the same state converted. Where JAX shards dim i of a leaf,
a probe array holding each element's shard index along dim i is converted
by ``convert.state_dict_from_nnx``: the one port dim along which it varies is
the dim the layout map carries dim i to, and the port's rule must name that
dim; where JAX replicates, the port must too. Every tensor at model sizes 2,
4 and 8, and data sizes 2, 4 and 8 at min sizes 256 and 2**14.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from flax import nnx
from jax.sharding import PartitionSpec as P

from torch_port_helpers import DIT_ARCH, flat_nnx_state, jax_fixture_model, port_model
from video_diffusion_nnx_tpu.diffusion import GaussianDiffusion as JaxDiffusion
from video_diffusion_nnx_tpu.models import VideoDiT as JaxVideoDiT
from video_diffusion_nnx_tpu.parallel.sharding import (
    fsdp_partition_specs,
    optimizer_partition_specs,
    params_partition_specs,
    path_to_names,
)
from video_diffusion_nnx_tpu_torch.convert import state_dict_from_nnx
from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
from video_diffusion_nnx_tpu_torch.models import VideoDiT
from video_diffusion_nnx_tpu_torch.parallel.sharding import state_partition_specs

DIT = dict(image_size=8, num_frames=3, channels=1, timesteps=10, loss_type="l2")
CASES = [("tensor", n, None) for n in (2, 4, 8)] + [("fsdp", n, m) for n in (2, 4, 8) for m in (256, 2**14)]


@pytest.fixture(scope="module")
def models():
    """(JAX state, port model) of each architecture."""
    unet = jax_fixture_model()
    dit = JaxDiffusion(JaxVideoDiT(rngs=nnx.Rngs(0), cond_dim=16, **DIT_ARCH), **DIT)
    return {"unet": (nnx.split(unet)[1], port_model(unet)),
            "dit": (nnx.split(dit)[1], GaussianDiffusion(VideoDiT(cond_dim=16, **DIT_ARCH), **DIT))}


def _flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(path_to_names(path)): leaf for path, leaf in leaves}


def _abstract(state) -> dict:
    """The state as a nested dict of shapes, keyed by its paths (leaf names last)."""
    out = {}
    for path, value in flat_nnx_state(state).items():
        *parents, leaf = path.split("/")
        node = out
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = jax.ShapeDtypeStruct(value.shape, value.dtype)
    return out


def _jax_specs(state, rule: str, size: int, min_size):
    abstract = _abstract(state)
    if rule == "tensor":
        return params_partition_specs(abstract, "model", size), "model"
    return fsdp_partition_specs(abstract, "data", size, min_size_to_shard=min_size), "data"


def _varying_dims(t: torch.Tensor) -> list[int]:
    return [d for d in range(t.ndim) if not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]


@pytest.mark.parametrize("arch", ["unet", "dit"])
@pytest.mark.parametrize("rule,size,min_size", CASES)
def test_port_rule_shards_the_dim_jax_shards(models, arch, rule, size, min_size):
    state, port = models[arch]
    specs, axis = _jax_specs(state, rule, size, min_size)
    flat_specs = _flat(specs)
    shapes = {k: v.shape for k, v in flat_nnx_state(state).items()}
    probes, sharded = {}, {}
    for path, spec in flat_specs.items():
        shape = shapes[path]
        dims = [i for i, name in enumerate(tuple(spec)) if name == axis]
        probe = np.zeros(shape, np.float32)
        if dims and size > 1:
            (i,) = dims
            ids = np.arange(shape[i]) // (shape[i] // size)
            probe = np.broadcast_to(ids.reshape([-1 if j == i else 1 for j in range(len(shape))]), shape)
            sharded[path] = i
        probes[path] = np.array(probe, np.float32)
    converted = state_dict_from_nnx(probes, port)
    got = state_partition_specs(port, rule, size, min_size if min_size is not None else 2**14)
    assert set(got) == set(converted)
    key_of = {path: path.replace("/", ".").replace(".kernel", ".weight").replace(".scale", ".weight")
              .replace(".embedding", ".weight") for path in flat_specs}
    assert set(key_of.values()) == set(got)
    n_sharded = 0
    for path, key in key_of.items():
        if path in sharded:
            (want,) = _varying_dims(converted[key])
            assert got[key] == want, (path, key, got[key], want)
            n_sharded += 1
        else:
            assert got[key] is None, (path, key, got[key])
    assert n_sharded > 0 or (rule == "fsdp" and min_size == 2**14)


@pytest.mark.parametrize("rule,size,min_size", CASES)
def test_moments_and_ema_mirror_their_parameter(models, rule, size, min_size):
    """JAX's Adam specs mirror the parameter specs leaf by leaf and replicate the count: the port keeps each
    moment and EMA shard along its parameter's dim (tests/test_torch_sharded_state.py holds the shapes)."""
    state, _ = models["unet"]
    specs, _ = _jax_specs(state, rule, size, min_size)
    opt = jax.eval_shape(optax.adam(1e-3).init, _abstract(state))
    opt_specs = optimizer_partition_specs(specs, opt)
    adam = opt_specs[0]
    assert adam.count == P()
    assert _flat(adam.mu) == _flat(specs) == _flat(adam.nu)
