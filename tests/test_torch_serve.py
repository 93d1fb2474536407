"""The port's sampling server on the CPU: the cases of tests/test_serve.py against
``video_diffusion_nnx_tpu_torch.serve`` (the HTTP surface runs the real
samplers in-process on an ephemeral port), and one served request's rows
against the JAX package's ``ddim_sample`` from the same x_T.

``TestConditionedServerText`` serves a text-conditioned model (hashed caption
embeddings): text and cond_scale over HTTP, each 400 of ``_validate_text``,
coalesced text requests against their solo runs, and a served DDIM-3 text
request against JAX ``ddim_sample`` from the same x_T and captions.
``TestConditionedServer`` serves a ``guidance_embed`` model: text and
cond_scale over HTTP, each step one forward of b rows with the request's
scale folded in, and requests at two scales never coalesced.
"""

import base64
import io
import json
import re
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_fixture_model, port_model
from video_diffusion_nnx_tpu.models import text as jtext
from video_diffusion_nnx_tpu_torch import serve as serve_mod
from video_diffusion_nnx_tpu_torch.diffusion import GaussianDiffusion
from video_diffusion_nnx_tpu_torch.models import Unet3D, text


def _tiny_model(timesteps: int = 6) -> GaussianDiffusion:
    unet = Unet3D(dim=8, dim_mults=(1,), channels=1, attn_heads=2)
    unet.reset_parameters(torch.Generator().manual_seed(0))
    return GaussianDiffusion(unet, image_size=8, num_frames=2, channels=1, timesteps=timesteps,
                             loss_type="l2").eval()


def _serve(model, **kwargs):
    httpd = serve_mod.create_server(model, host="127.0.0.1", port=0, **kwargs)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread, "http://%s:%d" % httpd.server_address[:2]


def _stop(httpd, thread):
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


@pytest.fixture(scope="module")
def server_url():
    httpd, thread, url = _serve(_tiny_model())
    yield url
    _stop(httpd, thread)


def _post_path(url, path, payload):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _post(url, payload):
    return _post_path(url, "/sample", payload)


class TestServer:
    def test_health(self, server_url):
        with urllib.request.urlopen(server_url + "/health", timeout=30) as r:
            info = json.loads(r.read())
        assert info["status"] == "ok"
        assert info["device"] == "cpu"
        assert info["model"]["image_size"] == 8
        assert info["model"]["timesteps"] == 6
        assert info["batching"] == {"window_s": 0.05, "max_rows": 8}

    def test_sample_ddim_returns_gifs(self, server_url):
        out = _post(server_url, {"batch_size": 2, "sampler": "ddim", "num_steps": 3, "seed": 1})
        assert out["shape"] == [2, 1, 2, 8, 8]
        assert len(out["gifs"]) == 2
        for g in out["gifs"]:
            assert base64.b64decode(g)[:6] in (b"GIF87a", b"GIF89a")
        assert out["time_s"] > 0

    def test_sample_stride_grid_and_dpm(self, server_url):
        for payload in ({"sampler": "ddim", "num_steps": 2, "grid": "stride"}, {"sampler": "dpm", "num_steps": 2}):
            out = _post(server_url, payload)
            assert len(out["gifs"]) == 1

    def test_sample_ddpm_runs_the_full_chain(self, server_url):
        out = _post(server_url, {"sampler": "ddpm", "batch_size": 1})
        assert out["shape"] == [1, 1, 2, 8, 8]
        assert "coalesced" not in out  # DDPM draws noise every step: never coalesced

    def test_bad_request_400(self, server_url):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server_url, {"sampler": "karras"})
        assert ei.value.code == 400
        assert "sampler" in json.loads(ei.value.read())["error"]

    def test_unknown_path_404(self, server_url):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(server_url + "/nope", timeout=30)
        assert ei.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post_path(server_url, "/nope", {})
        assert ei.value.code == 404


class TestValidation:
    """Requests whose parameters would silently not run as asked are refused."""

    def test_ddpm_rejects_num_steps(self, server_url):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server_url, {"sampler": "ddpm", "num_steps": 3})
        assert ei.value.code == 400

    def test_dpm_rejects_eta_and_grid(self, server_url):
        for extra in ({"eta": 0.5}, {"grid": "stride"}):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(server_url, {"sampler": "dpm", "num_steps": 2, **extra})
            assert ei.value.code == 400

    def test_text_on_unconditional_model_400(self, server_url):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server_url, {"sampler": "ddim", "num_steps": 2, "text": ["x"]})
        assert ei.value.code == 400
        assert "unconditional" in json.loads(ei.value.read())["error"]

    def test_nonfinite_eta_rejected(self, server_url):
        req = urllib.request.Request(server_url + "/sample",
                                     data=b'{"sampler": "ddim", "num_steps": 2, "eta": NaN}',
                                     headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 400

    def test_text_count_vs_batch_size_mismatch_400(self, server_url):
        with pytest.raises(urllib.error.HTTPError):
            _post(server_url, {"batch_size": 3, "text": ["a", "b"]})

    @pytest.mark.parametrize("payload", [
        {"batch_size": 0}, {"batch_size": 65}, {"num_steps": 7}, {"num_steps": None}, {"grid": "cosine"},
        {"seed": [1]},
    ])
    def test_out_of_range_and_malformed_400(self, server_url, payload):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(server_url, payload)
        assert ei.value.code == 400

    def test_default_sampler_is_ddim(self, server_url):
        out = _post(server_url, {"num_steps": 2})
        assert len(out["gifs"]) == 1
        assert out["coalesced"] >= 1


class TestExtendEndpoint:
    @staticmethod
    def _known_b64(shape=(1, 2, 8, 8)):
        buf = io.BytesIO()
        np.save(buf, np.random.default_rng(0).random(shape, dtype=np.float32))
        return base64.b64encode(buf.getvalue()).decode()

    def test_extend_returns_gifs(self, server_url):
        out = _post_path(server_url, "/extend", {
            "known_npy_b64": self._known_b64(), "frame_mask": [True, False], "batch_size": 2, "num_steps": 2,
        })
        assert out["shape"] == [2, 1, 2, 8, 8]
        assert len(out["gifs"]) == 2
        for g in out["gifs"]:
            assert base64.b64decode(g)[:6] in (b"GIF87a", b"GIF89a")

    def test_extend_ddpm_and_guidance(self, server_url):
        for extra in ({"num_steps": None}, {"num_steps": 2, "recon_guidance": 2.0, "grid": "stride"}):
            out = _post_path(server_url, "/extend", {
                "known_npy_b64": self._known_b64(), "frame_mask": [False, True], **extra})
            assert out["shape"] == [1, 1, 2, 8, 8]

    def test_extend_validations(self, server_url):
        cases = [
            {},  # missing array
            {"known_npy_b64": "not base64 of an npy", "frame_mask": [True, False]},
            {"known_npy_b64": self._known_b64(), "frame_mask": [True, True]},
            {"known_npy_b64": self._known_b64(), "frame_mask": [True]},
            {"known_npy_b64": self._known_b64((2, 2, 8, 8)), "frame_mask": [True, False]},
            {"known_npy_b64": self._known_b64(), "frame_mask": [True, False],
             "recon_guidance": 1.0, "num_steps": None},  # DDPM chain + wr
            {"known_npy_b64": self._known_b64(), "frame_mask": [True, False], "grid": "stride", "num_steps": None},
            {"known_npy_b64": self._known_b64(), "frame_mask": [True, False], "recon_guidance": -1.0},
            {"known_npy_b64": self._known_b64(), "frame_mask": [True, False], "batch_size": 17},
            {"known_npy_b64": self._known_b64(), "frame_mask": [True, False], "text": ["x"]},
        ]
        for payload in cases:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post_path(server_url, "/extend", payload)
            assert ei.value.code == 400, payload


class TestMicroBatcher:
    """Unit tests of the request coalescer with a stub runner (no model)."""

    @staticmethod
    def _make(calls, max_rows=8, window_s=0.15):
        def run_batch(key, batch):
            rows = sum(p.n for p in batch)
            calls.append((key, rows, len(batch)))
            return np.concatenate([np.asarray(p.item) for p in batch])

        return serve_mod.MicroBatcher(run_batch, max_rows=max_rows, window_s=window_s)

    @staticmethod
    def _join(threads):
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)

    def test_concurrent_same_key_coalesce(self):
        calls, outs = [], {}
        b = self._make(calls)

        def go(i):
            outs[i] = b.submit(("k",), np.full((1, 2), float(i), np.float32), 1)

        self._join([threading.Thread(target=go, args=(i,)) for i in range(3)])
        b.close()
        # All three landed in ONE call of 3 rows, and each got its own rows back with the group size.
        assert len(calls) == 1 and calls[0][1] == 3 and calls[0][2] == 3
        for i in range(3):
            rows, group, wait = outs[i]
            np.testing.assert_array_equal(rows, np.full((1, 2), float(i)))
            assert group == 3
            assert wait >= 0

    def test_different_keys_do_not_coalesce(self):
        calls, done = [], []
        b = self._make(calls, window_s=0.05)

        def go(key):
            done.append(b.submit(key, np.zeros((1, 2), np.float32), 1))

        self._join([threading.Thread(target=go, args=(("ddim", n),)) for n in (2, 3)])
        b.close()
        assert len(calls) == 2
        assert all(c[2] == 1 for c in calls)

    def test_max_rows_splits_batches(self):
        calls = []
        b = self._make(calls, max_rows=2, window_s=0.15)
        self._join([threading.Thread(target=lambda: b.submit(("k",), np.zeros((1, 2), np.float32), 1))
                    for _ in range(4)])
        b.close()
        assert len(calls) >= 2
        assert all(rows <= 2 for _, rows, _ in calls)
        assert sum(rows for _, rows, _ in calls) == 4

    def test_oversize_request_runs_alone(self):
        calls = []
        b = self._make(calls, max_rows=2, window_s=0.01)
        rows, group, _ = b.submit(("k",), np.zeros((5, 2), np.float32), 5)
        b.close()
        assert rows.shape == (5, 2)
        assert group == 1
        assert calls == [(("k",), 5, 1)]

    def test_runner_error_propagates_to_all_waiters(self):
        def boom(key, batch):
            raise RuntimeError("device on fire")

        b = serve_mod.MicroBatcher(boom, max_rows=8, window_s=0.1)
        errs = []

        def go():
            try:
                b.submit(("k",), np.zeros((1, 2), np.float32), 1)
            except RuntimeError as e:
                errs.append(str(e))

        self._join([threading.Thread(target=go) for _ in range(2)])
        b.close()
        assert errs == ["device on fire", "device on fire"]


class TestServerBatching:
    """Coalesced HTTP requests return what solo runs would (the init_noise ODE contract), and report the
    coalescing."""

    @pytest.fixture(scope="class")
    def batching_setup(self):
        model = _tiny_model()
        # A long window, so that concurrent test requests coalesce reliably.
        httpd, thread, url = _serve(model, batch_window_s=0.5)
        solo = serve_mod.SamplingService(model, batch_window_s=None)
        yield url, solo, httpd.service
        _stop(httpd, thread)

    @staticmethod
    def _gif_pixels(b64gif):
        from PIL import Image, ImageSequence

        im = Image.open(io.BytesIO(base64.b64decode(b64gif)))
        return np.stack([np.asarray(f.convert("L")) for f in ImageSequence.Iterator(im)])

    def test_concurrent_requests_coalesce_and_match_solo(self, batching_setup):
        url, solo, _ = batching_setup
        payloads = [{"sampler": "ddim", "num_steps": 3, "seed": s, "batch_size": 1} for s in (11, 22, 33)]
        outs = [None] * 3

        def go(i):
            outs[i] = _post(url, payloads[i])

        threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert all(o is not None for o in outs)
        assert max(o["coalesced"] for o in outs) >= 2  # the window is 0.5 s
        # Each request's pixels match its solo (no-batcher) run: floats ~1e-6 apart, <= 1 uint8 level.
        for payload, out in zip(payloads, outs):
            ref = solo.sample(dict(payload))
            got = self._gif_pixels(out["gifs"][0]).astype(np.int16)
            want = self._gif_pixels(ref["gifs"][0]).astype(np.int16)
            assert got.shape == want.shape
            assert np.max(np.abs(got - want)) <= 1, payload

    @staticmethod
    def _coalesced_against_solo(model, atol) -> None:
        """Three concurrent requests (seeds 1-3) through a coalescing service, each against its solo run, for
        DDIM-3 and DPM-3; ``atol(sampler)`` gives the tolerance."""
        service = serve_mod.SamplingService(model, batch_window_s=0.5)
        solo = serve_mod.SamplingService(model, batch_window_s=None)
        for sampler in ("ddim", "dpm"):
            payloads = [{"sampler": sampler, "num_steps": 3, "seed": s} for s in (1, 2, 3)]
            outs = [None] * 3

            def go(i, payloads=payloads, outs=outs):
                outs[i] = service.sample_rows(payloads[i])

            threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            for payload, (rows, _, extra) in zip(payloads, outs):
                want, _, _ = solo.sample_rows(dict(payload))
                np.testing.assert_allclose(rows, want, atol=atol(sampler), rtol=0)
                assert extra["coalesced"] >= 1

    def test_coalesced_rows_equal_solo_rows(self):
        """Three rows padded to a batch of 4, against each request's solo DDIM-3 and DPM-3, in floats.

        The model runs in float64, where the rows differ only where the coalescer maps them wrongly (its float32
        forward at 4 rows and at 1 parts by rounding: ``test_coalesced_float32_rows_within_the_batching_control``).
        """
        self._coalesced_against_solo(_tiny_model().double(), lambda sampler: 1e-5)

    def test_coalesced_float32_rows_within_the_batching_control(self):
        """The float32 model: each coalesced row within 1e-5 plus twice the control, where the control is the
        largest gap between the same requests' x_T sampled as one padded batch of 4 (rows 1, 2, 3, 1, as the
        coalescer pads) and each alone, straight through the model. CPU matrix products block by batch, so the
        float32 forward at 4 rows and at 1 parts by a few ulps, which DDIM-3 and DPM-3 carry to up to about 5e-5
        on [0, 1] for some rows; a row mapped wrongly parts by far more."""
        model = _tiny_model()
        shape = (model.channels, model.num_frames, model.image_size, model.image_size)
        noise = torch.cat([torch.randn((1, *shape), generator=torch.Generator().manual_seed(s)) for s in (1, 2, 3, 1)])

        def run(sampler, x):
            with torch.no_grad():
                if sampler == "ddim":
                    return model.ddim_sample(batch_size=x.shape[0], num_steps=3, eta=0.0, init_noise=x)
                return model.dpm_solver_sample(batch_size=x.shape[0], num_steps=3, init_noise=x)

        control = {}
        for sampler in ("ddim", "dpm"):
            batched = run(sampler, noise)
            control[sampler] = max((batched[i:i + 1] - run(sampler, noise[i:i + 1])).abs().max().item()
                                   for i in range(3))
            assert control[sampler] <= 1e-4, control  # batching moves a row by rounding alone
        self._coalesced_against_solo(model, lambda sampler: 1e-5 + 2 * control[sampler])

    def test_solo_batched_path_shape_metadata(self, batching_setup):
        url, _, _ = batching_setup
        out = _post(url, {"sampler": "dpm", "num_steps": 2, "batch_size": 3})
        assert out["shape"] == [3, 1, 2, 8, 8]
        assert len(out["gifs"]) == 3
        assert out["coalesced"] >= 1
        assert "queue_wait_s" in out


def test_served_rows_match_jax_ddim_from_the_same_x_T():
    """A served DDIM-3 request's float rows against the JAX package's ``ddim_sample`` with that request's x_T
    (the first draw of a generator seeded with its seed), 2e-4 as in tests/test_torch_diffusion.py."""
    jm = jax_fixture_model(prediction_type="v")
    service = serve_mod.SamplingService(port_model(jm, prediction_type="v"), batch_window_s=0.01)
    try:
        rows, _, extra = service.sample_rows({"sampler": "ddim", "num_steps": 3, "seed": 5, "batch_size": 2})
    finally:
        service.close()
    assert extra["coalesced"] == 1
    x_T = torch.randn(rows.shape, generator=torch.Generator().manual_seed(5)).numpy()
    want = jm.ddim_sample(jax.random.PRNGKey(0), batch_size=2, num_steps=3, eta=0.0, init_noise=jnp.asarray(x_T))
    np.testing.assert_allclose(rows, np.asarray(want), atol=2e-4, rtol=0)


def _tiny_cond_model(timesteps: int = 6) -> GaussianDiffusion:
    unet = Unet3D(dim=8, dim_mults=(1,), channels=1, attn_heads=2, use_bert_text_cond=True)
    unet.reset_parameters(torch.Generator().manual_seed(0))
    return GaussianDiffusion(unet, image_size=8, num_frames=2, channels=1, timesteps=timesteps,
                             loss_type="l2").eval()


@pytest.fixture
def hashed(monkeypatch):
    """The hashed caption embedding on both sides: no HuggingFace cache is read."""
    monkeypatch.setattr(text, "_hf", False)
    monkeypatch.setattr(jtext, "_hf", False)


@pytest.fixture(scope="module")
def cond_server():
    model = _tiny_cond_model()
    httpd, thread, url = _serve(model, batch_window_s=0.5)
    yield url, model, httpd.service
    _stop(httpd, thread)


@pytest.mark.usefixtures("hashed")
class TestConditionedServerText:
    def test_health_reports_the_condition(self, cond_server, server_url):
        for url, has_cond in ((cond_server[0], True), (server_url, False)):
            with urllib.request.urlopen(url + "/health", timeout=30) as r:
                model = json.loads(r.read())["model"]
            assert model["has_cond"] is has_cond and model["guidance_embed"] is False

    def test_text_and_cond_scale_over_http(self, cond_server):
        url, model, _ = cond_server
        out = _post(url, {"batch_size": 2, "sampler": "ddim", "num_steps": 2, "text": ["a bouncing ball"],
                          "cond_scale": 3.0, "seed": 4})
        assert out["shape"] == [2, 1, 2, 8, 8] and len(out["gifs"]) == 2
        for payload in ({"sampler": "dpm", "num_steps": 2, "text": ["a", "b", "c"]},
                        {"sampler": "ddpm", "text": ["a"], "cond_scale": 2.0},
                        {"sampler": "ddim", "num_steps": 2, "eta": 0.5, "text": ["a"], "cond_scale": 3.0}):
            out = _post(url, payload)
            assert out["shape"][0] == len(payload["text"])
        ext = _post_path(url, "/extend", {"known_npy_b64": TestExtendEndpoint._known_b64(), "frame_mask": [True, False],
                                          "num_steps": 2, "recon_guidance": 1.0, "text": ["one", "two"],
                                          "cond_scale": 3.0})
        assert ext["shape"] == [2, 1, 2, 8, 8]

    @pytest.mark.parametrize("payload,message", [
        ({}, "this model is conditioned; provide 'text'"),
        ({"text": "not a list"}, "text must be a list of strings"),
        ({"text": ["a", 3]}, "text must be a list of strings"),
        ({"text": []}, r"text must have 1\.\.64 entries"),
        ({"text": ["x"] * 65}, r"text must have 1\.\.64 entries"),
        ({"text": ["a", "b"], "batch_size": 3}, "text has 2 entries but batch_size is 3"),
        ({"text": ["a"], "cond_scale": "x"}, "cond_scale must be a float"),
    ])
    def test_validate_text_400(self, cond_server, payload, message):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(cond_server[0], {"num_steps": 2, **payload})
        assert ei.value.code == 400
        assert re.search(message, json.loads(ei.value.read())["error"])

    def test_validate_text_broadcasts_and_sets_the_batch(self, cond_server):
        service = cond_server[2]
        assert service._validate_text({"text": ["a"]}, 3) == (["a"] * 3, 3)
        assert service._validate_text({"text": ["a", "b"]}, 1) == (["a", "b"], 2)
        assert service._validate_text({"text": ["a", "b"], "batch_size": 2}, 2) == (["a", "b"], 2)
        with pytest.raises(ValueError, match="batch_size .incl. inferred from text. must be <= 16"):
            service.extend_rows({"known_npy_b64": TestExtendEndpoint._known_b64(), "frame_mask": [True, False],
                                 "num_steps": 2, "text": ["x"] * 17})

    def test_coalesced_text_requests_equal_their_solo_runs(self, cond_server):
        """Each row is a function of its own x_T and its own caption: two text requests coalesced into one batch
        (padded to a power of two) give what each gives alone (``ddim_sample`` from its seed and caption)."""
        _, model, service = cond_server
        payloads = [{"sampler": "ddim", "num_steps": 3, "seed": s, "text": [p], "cond_scale": 3.0}
                    for s, p in ((1, "one digit"), (2, "three digits"), (3, "two digits"))]
        outs = [None] * len(payloads)

        def go(i):
            outs[i] = service.sample_rows(payloads[i])

        threads = [threading.Thread(target=go, args=(i,)) for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert max(extra["coalesced"] for _, _, extra in outs) >= 2
        for payload, (rows, _, _) in zip(payloads, outs):
            solo = model.ddim_sample(num_steps=3, generator=torch.Generator().manual_seed(payload["seed"]),
                                     cond=payload["text"], cond_scale=3.0)
            np.testing.assert_allclose(rows, solo.numpy(), atol=1e-5, rtol=0)
        # An unconditioned and a conditioned request never share a group key.
        groups = {(p["sampler"], p["num_steps"], "linspace", p["cond_scale"], True) for p in payloads}
        assert len(groups) == 1

    def test_served_text_rows_match_jax_ddim(self):
        """A served DDIM-3 text request at cond_scale 3 against the JAX package's ``ddim_sample`` with that
        request's x_T and captions, 2e-4 as the unconditioned case."""
        jm = jax_fixture_model(prediction_type="v", use_bert_text_cond=True)
        service = serve_mod.SamplingService(port_model(jm, prediction_type="v", use_bert_text_cond=True),
                                            batch_window_s=0.01)
        captions = ["one digit", "two digits"]
        try:
            rows, _, extra = service.sample_rows({"sampler": "ddim", "num_steps": 3, "seed": 5, "text": captions,
                                                  "cond_scale": 3.0})
        finally:
            service.close()
        assert extra["coalesced"] == 1 and rows.shape[0] == 2
        x_T = torch.randn(rows.shape, generator=torch.Generator().manual_seed(5)).numpy()
        want = jm.ddim_sample(jax.random.PRNGKey(0), cond=captions, cond_scale=3.0, num_steps=3, eta=0.0,
                              init_noise=jnp.asarray(x_T))
        np.testing.assert_allclose(rows, np.asarray(want), atol=2e-4, rtol=0)


class TestConditionedServer:
    def test_text_cond_sampling_over_http(self, hashed):
        """A guidance-distilled (``guidance_embed``) model serves text + cond_scale through the same endpoint, with
        one forward of b rows a step (tests/test_serve.py:88-103); requests at two scales never share a group."""
        unet = Unet3D(dim=8, dim_mults=(1,), channels=1, attn_heads=2, cond_dim=text.BERT_MODEL_DIM,
                      guidance_embed=True)
        unet.reset_parameters(torch.Generator().manual_seed(0))
        model = GaussianDiffusion(unet, image_size=8, num_frames=2, channels=1, timesteps=4, loss_type="l2").eval()
        rows = []
        unet.register_forward_pre_hook(
            lambda m, args, kw: rows.append((args[0].shape[0], kw["guidance_scale"].tolist())), with_kwargs=True)
        httpd, thread, url = _serve(model)
        try:
            with urllib.request.urlopen(url + "/health", timeout=30) as r:
                assert json.loads(r.read())["model"]["guidance_embed"] is True
            out = _post(url, {"batch_size": 2, "sampler": "ddim", "num_steps": 2, "text": ["a bouncing ball"],
                              "cond_scale": 3.0})
            assert out["shape"] == [2, 1, 2, 8, 8] and len(out["gifs"]) == 2
            assert rows == [(2, [3.0, 3.0])] * 2
            rows.clear()
            outs = [None, None]

            def go(i, scale):
                outs[i] = httpd.service.sample_rows({"sampler": "ddim", "num_steps": 2, "seed": i, "text": ["x"],
                                                     "cond_scale": scale})

            threads = [threading.Thread(target=go, args=(i, cs)) for i, cs in enumerate((1.0, 3.0))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert [o[2]["coalesced"] for o in outs] == [1, 1]
            assert sorted(rows) == [(1, [1.0])] * 2 + [(1, [3.0])] * 2
        finally:
            _stop(httpd, thread)
