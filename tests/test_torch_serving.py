"""The port's serving engine and HTTP front end (``serving/``, ``cli.serve``)
on the CPU, at the tiny converging configuration (32px, style_dim 64,
channel_max 64, key bits at shift 56, mse) with the key planted at 3 sigma:
the engine cases of the reference package's ``tests/test_serving.py`` except
the mesh ones, and every HTTP route on an ephemeral port.

One served identification runs the converging solve (60 steps of 4
restarts, which recover the key) and the recovery cases read its result;
every case that checks routing, shapes, status codes or the wiring of the
solve runs 2-step solves.
"""

import dataclasses

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu.utils.image import make_image as jax_make_image

from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.cli import serve as cli_serve
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.config import (
    AttributionConfig,
    FingerprintConfig,
    ModelConfig,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    attribute as attr,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    encoder as enc_mod,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint import (
    pipeline as pl,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.fingerprint.keys import KeyRegistry
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.serving import (
    EngineMisconfigured,
    EngineUnavailable,
    InferenceEngine,
    ServeConfig,
    make_server,
    serve_forever_in_thread,
)
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.serving.server import _finite
from attributing_image_generative_models_using_latent_fingerprints_sg2_tpu_torch.utils.image import make_image_np

MCFG = ModelConfig(img_size=32, channel_max=64, n_mlp=3, style_dim=64)
FPCFG = FingerprintConfig(key_len=8, shift=56, sigma=3.0, sd_moved=1.0, n_pca_samples=2000)
ACFG = AttributionConfig(steps=60, n_starts=4, lr=0.2, loss="mse")  # recovers the planted key
FAST = dataclasses.replace(ACFG, steps=2)  # the same kernels and wiring, not converged


@pytest.fixture(scope="module")
def pipe():
    return pl.build_pipeline(MCFG, FPCFG, generator=torch.Generator().manual_seed(0), device="cpu",
                             want_lpips=False)


@pytest.fixture(scope="module")
def engine(pipe):
    eng = InferenceEngine(pipe, acfg=FAST, cfg=ServeConfig(buckets=(1, 4), max_wait_ms=20.0), seed=0).start()
    yield eng
    eng.stop()


@pytest.fixture(scope="module")
def served(pipe):
    """The one converging solve: an 8-user registry behind HTTP, an image
    generated for user_00002, identified through ``/v1/identify``."""
    eng = InferenceEngine(pipe, acfg=ACFG, cfg=ServeConfig(buckets=(1,), aot_warmup=False), seed=0,
                          registry=KeyRegistry.issue(8, key_len=FPCFG.key_len, min_distance=4, seed=1)).start()
    server = make_server(eng, "127.0.0.1", 0)
    serve_forever_in_thread(server)
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        _, gen = _post(base + "/v1/generate", {"seed": 9, "user": "user_00002", "encoding": "float_list"})
        status, out = _post(base + "/v1/identify", {"image": gen["image"]})
        yield {"registry": eng.registry, "gen": gen, "status": status, "out": out}
    finally:
        server.shutdown()
        server.server_close()
        eng.stop()


def test_generate_deterministic_per_seed(engine):
    a, b, c = engine.generate(seed=7), engine.generate(seed=7), engine.generate(seed=8)
    np.testing.assert_array_equal(a["image"], b["image"])
    np.testing.assert_array_equal(a["key_bits"], b["key_bits"])
    assert np.abs(a["image"] - c["image"]).max() > 1e-3
    assert a["image"].shape == (32, 32, 3) and a["seed"] == 7


def test_generate_with_planted_key_and_synthesis_parity(engine, pipe):
    """Planted key_bits come back verbatim, and the returned latent gives the
    returned image through the pipeline's synthesize."""
    bits = [1, 0, 1, 1, 0, 0, 1, 0]
    out = engine.generate(seed=3, key_bits=bits)
    np.testing.assert_array_equal(out["key_bits"], np.asarray(bits))
    re = pl.synthesize(pipe, torch.from_numpy(out["w"][None]))[0].numpy()
    np.testing.assert_allclose(re, out["image"], atol=1e-4)


def test_generate_batching_coalesces(engine):
    """Concurrent requests share batches, and a row's image does not depend on the batch."""
    solo = {s: engine.generate(seed=s)["image"] for s in range(20, 24)}
    before = engine.stats()["generate"]["batches"]
    futs = {s: engine.generate(seed=s, sync=False) for s in range(20, 24)}
    outs = {s: f.result(timeout=120) for s, f in futs.items()}
    assert engine.stats()["generate"]["batches"] - before < 4  # at least one multi-request batch
    for s, img in solo.items():
        np.testing.assert_allclose(outs[s]["image"], img, atol=1e-4)


def test_attribute_roundtrip(served):
    """The served 60-step decode recovers the planted key."""
    gen, out = served["gen"], served["out"]
    assert (np.asarray(out["key_bits"]) == np.asarray(gen["key_bits"])).mean() >= 0.75
    assert np.isfinite(out["loss"])


def test_attribute_is_the_solvers_answer(engine, pipe):
    """A served decode is ``attribute`` run directly with the generator of the
    engine's next attribute batch (seed * 7919 + batch index)."""
    gen = engine.generate(seed=11)
    batch_index = engine.stats()["attribute"]["batches"] + 1
    dec = engine.attribute(gen["image"])
    assert dec["confidence"].shape == (FPCFG.key_len,) and np.isfinite(dec["loss"])
    direct = attr.attribute(pipe.gen_params, None, pipe.basis, pipe.noise, torch.from_numpy(gen["image"][None]),
                            mcfg=MCFG, acfg=FAST, generator=torch.Generator().manual_seed(engine.seed * 7919 + batch_index))
    np.testing.assert_array_equal(dec["key_bits"], direct.key_bits[0].numpy().astype(np.int32))
    assert dec["loss"] == float(direct.loss[0])


def test_input_validation(engine):
    with pytest.raises(ValueError):
        engine.generate(key_bits=[1, 0])  # wrong length
    with pytest.raises(ValueError):
        engine.generate(key_bits=[2] * FPCFG.key_len)  # not 0/1
    with pytest.raises(ValueError):
        engine.attribute(np.zeros((16, 16, 3), np.float32))  # wrong size
    with pytest.raises(ValueError, match="ascending"):
        InferenceEngine(engine.pipe, cfg=ServeConfig(buckets=(4, 1)))


def test_out_of_range_seed_reduced_not_overflow(engine):
    big = 3_000_000_000
    a, b = engine.generate(seed=big), engine.generate(seed=big % (2**31))
    np.testing.assert_array_equal(a["image"], b["image"])
    assert a["seed"] == big % (2**31)


def test_stopped_engine_raises_unavailable(pipe):
    eng = InferenceEngine(pipe, cfg=ServeConfig(buckets=(1,), aot_warmup=False)).start()
    eng.stop()
    with pytest.raises(EngineUnavailable):
        eng.generate(seed=1)


def test_attribute_disabled_without_acfg(pipe):
    eng = InferenceEngine(pipe, acfg=None, cfg=ServeConfig(buckets=(1,), aot_warmup=False)).start()
    try:
        with pytest.raises(EngineMisconfigured):
            eng.attribute(np.zeros((32, 32, 3), np.float32))
        assert eng.generate(seed=1)["image"].shape == (32, 32, 3)
        assert eng.stats()["compiled"] == ["generate:1"]  # run once, by that request
    finally:
        eng.stop()


def test_stats_shape(engine):
    st = engine.stats()
    assert st["buckets"] == [1, 4]
    assert st["compiled"] == ["attribute:1", "attribute:4", "generate:1", "generate:4"]  # warmed at start
    assert st["generate"]["requests"] > 0 and st["generate"]["batches"] > 0
    assert 0 < st["generate"]["mean_batch_occupancy"] <= 1
    assert st["generate"]["latency_ms_p50"] > 0


def test_identify_end_to_end(served, engine):
    """Issue keys, generate as a registered user, identify the user back (the
    converging solve); in process, the same calls and their refusals."""
    reg, out = served["registry"], served["out"]
    assert served["gen"]["key_bits"] == reg.keys[2].tolist()
    assert out["user"] == "user_00002" and out["user_index"] == 2
    assert out["margin_nats"] > 0 and out["hard_distance"] <= 2
    reg = KeyRegistry.issue(8, key_len=FPCFG.key_len, min_distance=4, seed=0)
    engine.registry = reg
    try:
        gen = engine.generate(seed=77, user="user_00003")
        np.testing.assert_array_equal(gen["key_bits"], reg.keys[3])
        out = engine.identify(gen["image"], sync=False).result(timeout=300)
        assert out["user"] in reg.names and reg.names[out["user_index"]] == out["user"]
        assert out["hard_match_user"] in reg.names and 0 <= out["hard_distance"] <= FPCFG.key_len
        with pytest.raises(ValueError):
            engine.generate(user="nobody")
        with pytest.raises(ValueError):
            engine.generate(user="user_00001", key_bits=[0] * FPCFG.key_len)
    finally:
        engine.registry = None


def test_identify_requires_registry(engine):
    with pytest.raises(EngineMisconfigured, match="KeyRegistry"):
        engine.identify(np.zeros((32, 32, 3), np.float32))


def test_registry_setter_validates_key_len(engine):
    with pytest.raises(ValueError, match="key_len"):
        engine.registry = KeyRegistry.issue(4, key_len=FPCFG.key_len * 2, min_distance=4, seed=0)
    assert engine.registry is None


def test_json_finite_sanitizer_and_png_conversion():
    x = np.random.default_rng(0).uniform(-1.3, 1.3, (8, 8, 3)).astype(np.float32)
    x[0, 0] = [-1.0, 1.0, 0.5 / 127.5 - 1.0]  # the ends and a value at a rounding half
    np.testing.assert_array_equal(make_image_np(x), np.asarray(jax_make_image(x[None]))[0])
    assert _finite(1.5) == 1.5
    assert _finite(float("inf")) is None and _finite(float("nan")) is None
    assert json.loads(json.dumps({"m": _finite(float("inf"))})) == {"m": None}


def test_engine_with_encoder_init(pipe):
    """Restarts seeded by an (8-step, weak) encoder: the served solve is
    ``attribute`` from ``encoder_solve_init``'s restarts, both drawn from the
    batch's generator."""
    enc_params, _ = enc_mod.train_encoder(
        pipe.gen_params, pipe.basis, pipe.noise, mcfg=MCFG,
        ecfg=enc_mod.EncoderConfig(steps=8, batch=8, width=16, max_width=32, head_dim=32),
        generator=torch.Generator().manual_seed(3))
    eng = InferenceEngine(pipe, acfg=FAST, cfg=ServeConfig(buckets=(1,), max_wait_ms=5.0, aot_warmup=False),
                          seed=0, encoder_params=enc_params, encoder_jitter=0.3).start()
    try:
        gen = eng.generate(seed=11)
        dec = eng.attribute(gen["image"])
    finally:
        eng.stop()
    assert dec["key_bits"].shape == (FPCFG.key_len,) and np.isfinite(dec["loss"])
    g = torch.Generator().manual_seed(1)  # engine seed 0 * 7919 + the first attribute batch
    targets = torch.from_numpy(gen["image"][None])
    a0, k0 = enc_mod.encoder_solve_init(enc_params, pipe.basis, targets, FAST.n_starts, g, jitter=0.3)
    direct = attr.attribute(pipe.gen_params, None, pipe.basis, pipe.noise, targets, mcfg=MCFG, acfg=FAST,
                            generator=g, alpha_init=a0, key_init=k0)
    np.testing.assert_array_equal(dec["key_bits"], direct.key_bits[0].numpy().astype(np.int32))
    assert dec["loss"] == float(direct.loss[0])


# HTTP front end
def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=180) as r:
        return r.status, json.loads(r.read())


def _post_error(url, payload):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, payload)
    return e.value.code, json.loads(e.value.read())


@pytest.fixture(scope="module")
def http_base(engine):
    server = make_server(engine, "127.0.0.1", 0)
    serve_forever_in_thread(server)
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()


def test_http_healthz_stats_and_png(http_base):
    with urllib.request.urlopen(http_base + "/healthz", timeout=30) as r:
        body = json.loads(r.read())
    assert body == {"ok": True, "model": "sg2", "img_size": 32, "key_len": FPCFG.key_len}
    with urllib.request.urlopen(http_base + "/v1/stats", timeout=30) as r:
        assert json.loads(r.read())["buckets"] == [1, 4]
    status, body = _post(http_base + "/v1/generate", {"seed": 42, "return_latent": True})
    assert status == 200 and len(body["key_bits"]) == FPCFG.key_len and len(body["w"]) == 64
    assert base64.b64decode(body["image_png_b64"])[:8] == b"\x89PNG\r\n\x1a\n"


def test_http_generate_attribute_roundtrip(http_base):
    status, gen = _post(http_base + "/v1/generate", {"seed": 5, "encoding": "float_list", "key_bits": [0, 1] * 4})
    assert status == 200 and gen["key_bits"] == [0, 1] * 4
    buf = io.BytesIO()
    np.save(buf, np.asarray(gen["image"], np.float32))
    status, dec = _post(http_base + "/v1/attribute", {"image_npy_b64": base64.b64encode(buf.getvalue()).decode()})
    assert status == 200 and len(dec["confidence"]) == FPCFG.key_len and len(dec["key_bits"]) == FPCFG.key_len
    assert set(dec["key_bits"]) <= {0, 1} and np.isfinite(dec["loss"])


def test_http_errors(http_base, engine):
    code, err = _post_error(http_base + "/v1/attribute", {"image": [[0.0]]})
    assert code == 400 and "image" in err["error"]
    code, err = _post_error(http_base + "/v1/nowhere", {})
    assert code == 404
    # a valid request the server is not set up for (no registry) is 501, not 400
    code, err = _post_error(http_base + "/v1/identify", {"image": np.zeros((32, 32, 3)).tolist()})
    assert code == 501 and "KeyRegistry" in err["error"]
    before = engine.stats()["generate"]["requests"]
    code, err = _post_error(http_base + "/v1/generate", {"seed": 1, "encoding": "jpeg"})
    assert code == 400 and "encoding" in err["error"]
    assert engine.stats()["generate"]["requests"] == before  # never reached the queue


def test_http_device_failure_is_500(http_base, engine, monkeypatch):
    """A failure on the device (a kernel's launch error is a RuntimeError) is
    the server's fault, 500, never the 501 of a misconfiguration."""
    def launch_failure(*args, **kwargs):
        raise RuntimeError("CUDA kernel blur4 failed to launch: unspecified launch failure")

    monkeypatch.setattr(engine, "run_bucket", launch_failure)
    code, err = _post_error(http_base + "/v1/generate", {"seed": 1})
    assert code == 500 and "launch failure" in err["error"]
    monkeypatch.undo()
    assert _post(http_base + "/v1/generate", {"seed": 1})[0] == 200  # the worker goes on serving


def test_http_identify(served):
    assert served["status"] == 200 and served["out"]["user"] == "user_00002"
    assert set(served["out"]) == {"user", "user_index", "log_likelihood", "margin_nats", "hard_match_user",
                                  "hard_distance", "key_bits", "loss"}


def test_concurrent_http_load(http_base):
    """Parallel HTTP clients all get per-seed-stable answers."""
    results, errs = {}, []

    def hit(seed):
        try:
            _, body = _post(http_base + "/v1/generate", {"seed": seed, "encoding": "float_list"})
            results[seed] = np.asarray(body["image"], np.float32)
        except Exception as e:  # noqa: BLE001 - collected and asserted below
            errs.append(e)

    threads = [threading.Thread(target=hit, args=(s,)) for s in range(40, 48)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs and len(results) == 8 and not any(t.is_alive() for t in threads)
    for s in (40, 47):
        _, again = _post(http_base + "/v1/generate", {"seed": s, "encoding": "float_list"})
        np.testing.assert_allclose(np.asarray(again["image"], np.float32), results[s], atol=1e-4)


def test_cli_serve_builds_a_working_server(tmp_path):
    """``cli.serve`` on the CPU: a registry from disk, generation only, port 0.
    Without ``--device cpu`` it asks for the card, and there is none here."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_serve.build_server(["--random_init", "--img_size", "32", "--no_attribute"])
    path = str(tmp_path / "reg.json")
    KeyRegistry.issue(4, key_len=8, min_distance=3, seed=0).save(path)
    engine, server = cli_serve.build_server([
        "--device", "cpu", "--random_init", "--img_size", "32", "--style_dim", "64", "--n_mlp", "3",
        "--channel_max", "64", "--key_len", "8", "--shift", "56", "--buckets", "1,2", "--port", "0",
        "--no_attribute", "--registry", path])
    serve_forever_in_thread(server)
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        status, gen = _post(base + "/v1/generate", {"user": "user_00001"})
        assert status == 200 and gen["key_bits"] == engine.registry.keys[1].tolist()
        code, err = _post_error(base + "/v1/attribute", {"image": np.zeros((32, 32, 3)).tolist()})
        assert code == 501
        assert engine.stats()["compiled"] == ["generate:1", "generate:2"]
        assert server.request_queue_size >= 128  # a burst of clients is not dropped at connect
    finally:
        server.shutdown()
        server.server_close()
        engine.stop()
