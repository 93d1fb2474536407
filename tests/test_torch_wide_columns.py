"""Wide temporal columns: f <= 64 at widths whose one-token dense tile does not fit, on the CPU.

The bottleneck of a dim-128 Unet3D attends 8x8 = 64 tokens at c = 1024 through the temporal op. The
JAX package keeps every f <= 64 on its dense Pallas kernels, whatever c; on the card the port takes
the streaming kernel in mode DENSE there (``temporal_plan`` family "wide"; the float32 backward takes the
tensor-core design of csrc/temporal_tf32x3.cu), which has the dense kernels' rounding points; on the CPU it takes the dense plain versions. Covered: the route choice as a
pure function of (f, c, D, dtype, SMs), never a plain version; the dense plain versions (forward by
autograd, and the backward oracle) against the JAX dense Pallas kernels in interpret mode at f = 64,
c = 320, all gradients, biased too. Tolerances as tests/test_ops.py: float32 forward atol 5e-5,
gradients 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import seeded
from video_diffusion_nnx_tpu.ops import temporal_attention as jta
from video_diffusion_nnx_tpu_torch import ops
from video_diffusion_nnx_tpu_torch.ops import temporal_attention as pta

HEADS, DIM, C = 2, 8, 320
GRAD_NAMES = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dbias")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jta, "FORCE_INTERPRET", True)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("sms", [66, 132])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("c", [320, 512, 1024])
def test_wide_route_is_the_dense_streaming_mode(c, bf16, sms):
    """At f = 64 and head dim 32 the dense tile holds no token from c = 309 (backward) and c = 374 (forward):
    there the plan is the wide family, whose route is the streaming kernel, in either type; the float32
    backward takes the tensor-core design of csrc/temporal_tf32x3.cu instead."""
    for backward in (False, True):
        plan = pta.temporal_plan(2 * 10, 64, c, 32, 8, bf16, sms, backward)
        wide = pta.wide_needed(64, c, 32, backward)
        assert wide == (c >= (309 if backward else 374))
        # a float32 forward the staged tile cannot hold takes the streaming kernel by the measured rule
        wide = wide or (not (bf16 or backward) and pta._f32_fwd_takes_stream(64, c, 32))
        assert plan["family"] == ("wide" if wide else "dense")
        if wide and backward and not bf16:
            assert plan["route"] == "tf32x3" and plan["smem"] <= pta._SMEM_MAX and plan["grid"] == 20
        elif wide:  # the streaming kernel, in float32 in 3xTF32
            assert plan["route"] == ("staged" if bf16 else pta.STAGED_3XTF32) and plan["smem"] <= pta._SMEM_MAX
            assert plan["kv_block"] == 64 and plan["grid"] == min(20, sms)
        else:
            with pytest.raises(NotImplementedError):  # what the dense planner alone would say at the wide widths
                pta.bwd_plan(20, 64, 1024, 32, 8, bf16, sms)


@pytest.mark.parametrize("f,c,dim", [(64, 1024, 32), (64, 1024, 64), (40, 2048, 16), (64, 4096, 32), (10, 3000, 32)])
def test_wide_plans_cover_the_widths_the_dense_tile_refuses(f, c, dim):
    """Every width the dense planners refuse has a streaming plan, in both types and directions: the c-chunks
    keep shared memory independent of c. Head dims pad to 32 or 64. The op launches it but for the float32
    backward, which takes the tensor-core design (its shared memory independent of c too)."""
    for bf16 in (True, False):
        for backward in (False, True):
            plan = pta.temporal_plan(8, f, c, dim, 2, bf16, 132, backward)
            stream = pta.stream_plan(f, c, dim, 2 if bf16 else 4, backward, True)
            assert plan["family"] == "wide"
            assert stream["dim_padded"] == (32 if dim <= 32 else 64) and stream["ck"] % 16 == 0 and stream["ck"] < c
            if backward and not bf16:
                assert plan == {"family": "wide", **pta.tf32x3_plan(8, f, c, dim, 2, 132)}
            else:
                assert plan == {**plan, **stream} and plan["route"] == ("staged" if bf16 else pta.STAGED_3XTF32)


def test_wide_plan_refuses_head_dims_over_64():
    with pytest.raises(NotImplementedError, match="exceed shared memory"):
        pta.temporal_plan(8, 64, 1024, 128, 2, True, 132, True)


def _inputs(b=1, s=2, f=64, bias=False):
    hd = HEADS * DIM
    w = (seeded((C, 3 * hd), 2, C ** -0.5), seeded((3 * hd,), 3, 0.1), seeded((hd, C), 4, hd ** -0.5),
         seeded((C,), 5, 0.1))
    return seeded((b, s, f, C), 1), w, (seeded((HEADS, f, f), 7, 0.5) if bias else None)


@pytest.mark.parametrize("bias", [False, True])
def test_wide_plain_versions_match_the_dense_pallas_kernels(bias):
    x, w, pos_bias = _inputs(bias=bias)
    assert jta._route(jnp.asarray(x), 64) == "dense"  # the reference keeps f = 64 on its dense kernel at any c
    extra = () if pos_bias is None else (pos_bias,)
    op = jta.fused_temporal_attention_block_biased if bias else jta.fused_temporal_attention_block

    def loss(*args):
        return jnp.sum(op(*args, HEADS, DIM).astype(jnp.float32) ** 2)

    jargs = [jnp.asarray(a) for a in (x, *w, *extra)]
    want_out = np.asarray(op(*jargs, HEADS, DIM))
    want = [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(len(jargs))))(*jargs)]

    leaves = [_t(a).requires_grad_() for a in (x, *w, *extra)]
    ops.reset_launch_counts()
    out = pta._block(*leaves[:5], leaves[5] if bias else None, HEADS, DIM)
    assert set(ops.launch_counts().values()) == {0}  # a CPU tensor takes the plain version
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=5e-5, rtol=0)
    out.square().sum().backward()
    oracle = pta.temporal_attention_bwd(_t(x), 2 * out.detach(), *map(_t, w), HEADS, DIM,
                                        pos_bias=None if pos_bias is None else _t(pos_bias))
    assert len(oracle) == len(want)
    for name, leaf, o, g in zip(GRAD_NAMES, leaves, oracle, want):
        np.testing.assert_allclose(leaf.grad.numpy(), g, rtol=2e-4, atol=2e-4, err_msg=f"autograd {name}")
        np.testing.assert_allclose(o.numpy(), g, rtol=2e-4, atol=2e-4, err_msg=f"oracle {name}")
