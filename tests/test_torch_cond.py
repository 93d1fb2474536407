"""The port's conditioned Unet3D against the JAX package's, on the CPU.

The fixture recipe (tests/torch_port_helpers.py) conditioned two ways: ``cond_dim`` 16 and
``use_bert_text_cond`` (768-wide caption embeddings, hashed on both sides: no HuggingFace cache is
read). JAX weights, ``null_cond_emb`` among them, come across through ``convert.py``. The JAX
dropout draws come from ``split(key)`` and cannot match the port's generator, so the masks are
injected (``null_cond_mask``) or the probabilities are 0 and 1. Tolerances: forward float32 5e-5
(max-abs); bf16 0.05 of the output's largest magnitude, and no further from the float32 model than
1.5x JAX's bf16 distance to it plus 1% (at this recipe the unconditioned bf16 models of the two
packages already part by 0.07 absolute, each about 0.1 from float32); gradients 2e-4 of
max(1, each tensor's largest magnitude). The loss, the trainer and checkpoints are in
tests/test_torch_cond_train.py, the samplers in tests/test_torch_cond_samplers.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from torch_port_helpers import FRAMES, IMAGE_SIZE, flat_nnx_state, jax_fixture_model, port_model, seeded
from video_diffusion_nnx_tpu.models import text as jtext
from video_diffusion_nnx_tpu_torch.convert import state_dict_from_nnx
from video_diffusion_nnx_tpu_torch.models import Unet3D, text
from video_diffusion_nnx_tpu_torch.utils.functional import prob_mask_like

B = 3
KINDS = {"cond16": {"cond_dim": 16}, "bert": {"use_bert_text_cond": True}}
MASKS = {"none": [False] * B, "mixed": [True, False, True], "all": [True] * B}


@pytest.fixture(autouse=True)
def hashed(monkeypatch):
    monkeypatch.setattr(text, "_hf", False)
    monkeypatch.setattr(jtext, "_hf", False)


@pytest.fixture(scope="module", params=list(KINDS))
def models(request):
    kw = KINDS[request.param]
    jm = jax_fixture_model(**kw)
    return kw, jm, port_model(jm, **kw)


def _cond_dim(kw) -> int:
    return kw.get("cond_dim") or 768


def _inputs(kw, seed: int = 1):
    x = seeded((B, 1, FRAMES, IMAGE_SIZE, IMAGE_SIZE), seed)
    t = np.array([1, 5, 9], np.int32)
    return x, t, seeded((B, _cond_dim(kw)), seed + 1)


def _port(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("mask", list(MASKS))
def test_conditioned_forward_matches_jax(models, mask):
    kw, jm, pm = models
    x, t, c = _inputs(kw)
    m = np.array(MASKS[mask])
    want = jm.denoise_fn(jnp.asarray(x), jnp.asarray(t), cond=jnp.asarray(c), null_cond_mask=jnp.asarray(m))
    with torch.no_grad():
        got = pm.denoise_fn(*_port(x, t.astype(np.int64)), cond=torch.from_numpy(c), null_cond_mask=torch.from_numpy(m))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)


def test_conditioned_forward_bf16_matches_jax(models):
    """The bf16 policy on both sides, against each other and against the float32 model (``models``, same weights)."""
    kind, jm32, _ = models
    kw = {**kind, "compute_dtype": "bfloat16"}
    jm = jax_fixture_model(**kw)
    pm = port_model(jm, **kw)
    x, t, c = _inputs(kw, seed=4)
    for mask in MASKS.values():
        m = np.array(mask)
        args = (jnp.asarray(x), jnp.asarray(t))
        want = np.asarray(jm.denoise_fn(*args, cond=jnp.asarray(c), null_cond_mask=jnp.asarray(m)))
        ref = np.asarray(jm32.denoise_fn(*args, cond=jnp.asarray(c), null_cond_mask=jnp.asarray(m)))
        with torch.no_grad():
            got = pm.denoise_fn(*_port(x, t.astype(np.int64)), cond=torch.from_numpy(c),
                                null_cond_mask=torch.from_numpy(m)).numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 0.05 * scale
        assert np.abs(got - ref).max() <= 1.5 * np.abs(want - ref).max() + 0.01 * scale


def test_condition_stays_float32_under_bf16():
    """The time MLP's input is float32 under the bf16 policy: the null embedding's integers (up to 767, which bf16
    cannot hold above 256) reach every ResNet block exactly."""
    unet = Unet3D(dim=8, dim_mults=(1, 2), channels=1, use_bert_text_cond=True, compute_dtype="bfloat16")
    unet.reset_parameters(torch.Generator().manual_seed(0))
    seen = []
    unet.downs[0][0].mlp.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    x = torch.from_numpy(seeded((2, 1, FRAMES, IMAGE_SIZE, IMAGE_SIZE), 3))
    with torch.no_grad():
        unet(x, torch.tensor([2, 3]), cond=torch.zeros(2, 768), null_cond_mask=torch.tensor([True, False]))
    emb = seen[0]
    assert emb.dtype == torch.float32 and emb.shape == (2, 32 + 768)
    assert torch.equal(emb[0, 32:], unet.null_cond_emb[0]) and not emb[1, 32:].any()
    assert unet.null_cond_emb.max().item() > 256
    assert unet.downs[0][0].mlp.layers[1].weight.shape == (2 * 8, 32 + 768)


@pytest.mark.parametrize("cond_scale", [1.0, 3.0])
def test_forward_with_cond_scale_matches_jax(models, cond_scale):
    kw, jm, pm = models
    x, t, c = _inputs(kw, seed=7)
    want = jm.denoise_fn.forward_with_cond_scale(jnp.asarray(x), jnp.asarray(t), cond=jnp.asarray(c),
                                                 cond_scale=cond_scale)
    with torch.no_grad():
        got = pm.denoise_fn.forward_with_cond_scale(*_port(x, t.astype(np.int64)), cond=torch.from_numpy(c),
                                                    cond_scale=cond_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=0)
    # The batched form is a conditioned and a null forward of b rows each, combined.
    with torch.no_grad():
        xs, ts = _port(x, t.astype(np.int64))
        cond_out = pm.denoise_fn(xs, ts, cond=torch.from_numpy(c), null_cond_mask=torch.zeros(B, dtype=torch.bool))
        null = pm.denoise_fn(xs, ts, cond=torch.from_numpy(c), null_cond_mask=torch.ones(B, dtype=torch.bool))
    torch.testing.assert_close(got, null + (cond_out - null) * cond_scale, rtol=0, atol=2e-5)


def test_gradients_match_jax(models):
    """Every parameter's gradient of a weighted sum of the output, ``null_cond_emb``'s included (mixed mask)."""
    kw, jm, pm = models
    x, t, c = _inputs(kw, seed=11)
    m = np.array(MASKS["mixed"])
    g = seeded((B, FRAMES, IMAGE_SIZE, IMAGE_SIZE, 1), 13)
    graphdef, params = nnx.split(jm.denoise_fn, nnx.Param)

    def loss(p):
        out = nnx.merge(graphdef, p)(jnp.asarray(x), jnp.asarray(t), cond=jnp.asarray(c),
                                     null_cond_mask=jnp.asarray(m))
        return jnp.sum(out * jnp.asarray(g))

    grads = jax.grad(loss)(params)
    unet = pm.denoise_fn
    want = state_dict_from_nnx(flat_nnx_state(grads), unet)
    unet.zero_grad(set_to_none=True)
    xs, ts = _port(x, t.astype(np.int64))
    (unet(xs, ts, cond=torch.from_numpy(c), null_cond_mask=torch.from_numpy(m)) * torch.from_numpy(g)).sum().backward()
    got = dict(unet.named_parameters())
    for k, w in want.items():
        grad = got[k].grad if got[k].grad is not None else torch.zeros_like(w)  # unused in compat math
        assert (grad - w).abs().max().item() <= 2e-4 * max(1.0, w.abs().max().item()), k
    assert got["null_cond_emb"].grad.abs().max().item() > 0


def test_only_dropped_rows_train_the_null_embedding(models):
    kw, _, pm = models
    x, t, c = _inputs(kw, seed=15)
    unet = pm.denoise_fn
    xs, ts = _port(x, t.astype(np.int64))
    unet.zero_grad(set_to_none=True)
    unet(xs, ts, cond=torch.from_numpy(c), null_cond_mask=torch.zeros(B, dtype=torch.bool)).sum().backward()
    assert unet.null_cond_emb.grad is None or not unet.null_cond_emb.grad.any()
    unet.zero_grad(set_to_none=True)


def test_conditioned_model_needs_its_condition(models):
    kw, jm, pm = models
    x, t, _ = _inputs(kw)
    with pytest.raises(AssertionError, match="cond must be passed"):
        jm.denoise_fn(jnp.asarray(x), jnp.asarray(t))
    for call in (pm.denoise_fn, pm.denoise_fn.forward_with_cond_scale):
        with pytest.raises(ValueError, match="cond must be passed"):
            call(*_port(x, t.astype(np.int64)))


@pytest.mark.parametrize("kind", list(KINDS))
def test_null_embedding_init_holds_integers(kind):
    """PARITY #5: random integers in [1, cond_dim) as float32, on both sides; the port draws them from the caller's
    generator, the same for one seed."""
    kw = KINDS[kind]
    d = _cond_dim(kw)
    jm = jax_fixture_model(**kw)
    unets = []
    for seed in (0, 0, 1):
        unet = Unet3D(dim=8, dim_mults=(1, 2), channels=1, **kw)
        unet.reset_parameters(torch.Generator().manual_seed(seed))
        unets.append(unet.null_cond_emb.detach())
    for values in (*unets, torch.from_numpy(np.array(jm.denoise_fn.null_cond_emb[...]))):
        assert values.dtype == torch.float32 and values.shape == (1, d)
        assert torch.equal(values, values.round()) and values.min() >= 1 and values.max() <= d - 1
    assert torch.equal(unets[0], unets[1]) and not torch.equal(unets[0], unets[2])


def test_dropout_rate_and_its_draws():
    """``null_cond_prob`` drops each row with that probability, from the given generator: at 0.2 over many draws,
    reproducibly from one seed, and in the model the same rows as ``prob_mask_like`` draws from that seed."""
    draws = prob_mask_like((200_000,), 0.2, torch.Generator().manual_seed(3))
    assert abs(draws.float().mean().item() - 0.2) < 0.005
    assert torch.equal(draws, prob_mask_like((200_000,), 0.2, torch.Generator().manual_seed(3)))
    assert not prob_mask_like((64,), 0.0).any() and prob_mask_like((64,), 1.0).all()

    unet = Unet3D(dim=8, dim_mults=(1, 2), channels=1, cond_dim=16)
    unet.reset_parameters(torch.Generator().manual_seed(0))
    x, t = torch.from_numpy(seeded((8, 1, FRAMES, IMAGE_SIZE, IMAGE_SIZE), 1)), torch.arange(8)
    c = torch.from_numpy(seeded((8, 16), 2))
    with torch.no_grad():
        dropped = unet(x, t, cond=c, null_cond_prob=0.5, generator=torch.Generator().manual_seed(9))
        mask = prob_mask_like((8,), 0.5, torch.Generator().manual_seed(9))
        assert 0 < int(mask.sum()) < 8
        torch.testing.assert_close(dropped, unet(x, t, cond=c, null_cond_mask=mask), rtol=0, atol=0)
        torch.testing.assert_close(unet(x, t, cond=c, null_cond_prob=1.0),
                                   unet(x, t, cond=c, null_cond_mask=torch.ones(8, dtype=torch.bool)), rtol=0, atol=0)


def test_fixed_math_draws_the_focus_mask_before_the_condition():
    """Both masks come from one generator in fixed math: the focus mask first, the condition's second (JAX splits
    its key in the same order); under guidance the focus mask is drawn once for b rows and shared by both halves."""
    unet = Unet3D(dim=8, dim_mults=(1, 2), channels=1, cond_dim=16, reference_compat=False)
    unet.reset_parameters(torch.Generator().manual_seed(0))
    x, t = torch.from_numpy(seeded((4, 1, FRAMES, IMAGE_SIZE, IMAGE_SIZE), 1)), torch.arange(4)
    c = torch.from_numpy(seeded((4, 16), 2))
    g = torch.Generator().manual_seed(5)
    focus, null = prob_mask_like((4,), 0.5, g), prob_mask_like((4,), 0.5, g)
    with torch.no_grad():
        drawn = unet(x, t, cond=c, null_cond_prob=0.5, prob_focus_present=0.5, generator=torch.Generator().manual_seed(5))
        torch.testing.assert_close(drawn, unet(x, t, cond=c, null_cond_mask=null, focus_present_mask=focus),
                                   rtol=0, atol=0)
        guided = unet.forward_with_cond_scale(x, t, cond=c, cond_scale=2.0, prob_focus_present=0.5,
                                              generator=torch.Generator().manual_seed(5))
        cond_out = unet(x, t, cond=c, null_cond_mask=torch.zeros(4, dtype=torch.bool), focus_present_mask=focus)
        null_out = unet(x, t, cond=c, null_cond_mask=torch.ones(4, dtype=torch.bool), focus_present_mask=focus)
    torch.testing.assert_close(guided, null_out + (cond_out - null_out) * 2.0, rtol=0, atol=2e-5)
