"""The serving surface on the CPU: int8 ``SegServer`` against the JAX
package's, and the ``cli.serve`` daemon end to end over HTTP.

  - int8: served logits against the JAX int8 ``SegServer`` on the same
    weights, fp32, at the tiny config (only ``image_proj`` is large enough to
    quantize among the served linears) and at widths 64 (every linear
    quantizes), to 2e-4, the serving tolerance of
    ``tests/test_torch_serving.py``: both sides dequantize the same int8 codes
    with the same fp32 scales, so the bits of the weights agree and only the
    summation order differs.  Quantized linears stay int8 on the device.
  - the daemon, started on port 0: its network input equals the JAX daemon's
    ``_preprocess`` bit for bit (PIL's decode and bilinear resize) for every
    PNG colour type and for JPEG files (gray, RGB at 4:2:0, 4:2:2 and
    4:4:4, progressive, ``assets/cat_dog.jpeg``); a PNG answer is the argmax
    of the served forward on the request's zero-padded batch, resized to the
    input's size as PIL's nearest resize does, for a JPEG body as for a PNG
    one; JSON areas sum to grid²; concurrent requests are batched; a GIF or
    broken body gets 400, a failing worker 500.
"""

import io
import json
import threading
import types
import urllib.request
from http.server import ThreadingHTTPServer

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageFile

import chip_smoke
import ifseg_tpu.cli.serve as jserve
from ifseg_torch.cli import serve as tserve
from ifseg_torch.eval.serving import SegServer as TorchSegServer
from ifseg_torch.ops.quantization import Int8Linear
from ifseg_tpu.eval.serving import SegServer as JaxSegServer

from torch_port_utils import make_pair, serving_inputs, torch_tiny

WIDE = dict(encoder_embed_dim=64, encoder_ffn_embed_dim=128, decoder_embed_dim=64,
            decoder_ffn_embed_dim=128)


@pytest.mark.parametrize("widths,int8_linears", [({}, 1), (WIDE, 33)], ids=["tiny", "width64"])
def test_int8_served_logits_match_jax(widths, int8_linears):
    jmodel, params, tmodel = make_pair(seed=0, **widths)
    src, img, bos = serving_inputs(seed=1)
    jserver = JaxSegServer(jmodel, params, src_len=10, quantize="int8")
    want = np.asarray(jserver(jnp.asarray(src), jnp.asarray(img), jnp.asarray(bos)))
    server = TorchSegServer(tmodel, src_len=10, device="cpu", quantize="int8")
    assert server.quant_report == jserver.quant_report
    linears = [m for m in server.model.modules() if isinstance(m, Int8Linear)]
    assert len(linears) == int8_linears
    assert all(m.q.dtype == torch.int8 and m.scale.dtype == torch.float32 for m in linears)
    got = server(torch.from_numpy(src), torch.from_numpy(img), torch.from_numpy(bos))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_unknown_quantize_mode_raises():
    with pytest.raises(ValueError, match="unknown quantize mode"):
        TorchSegServer(torch_tiny(), src_len=10, device="cpu", quantize="int4")


CATEGORIES = "cat, dog, grass"
SIZE = 32


@pytest.fixture(scope="module")
def daemon(bpe_dir):
    model = torch_tiny(patch_image_size=SIZE, orig_patch_image_size=SIZE, num_seg_tokens=3)
    args, svc = tserve.build_service(
        [f"--category-list={CATEGORIES}", "--arch=segofa_tiny", f"--patch-image-size={SIZE}",
         "--max-batch=4", "--batch-timeout-ms=200", "--port=0", f"--bpe-dir={bpe_dir}",
         "--device=cpu"], model=model)
    svc.warmup()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tserve._make_handler(svc))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", svc
    httpd.shutdown()
    httpd.server_close()
    svc.close()
    t.join(30)


def _png(h=30, w=40, seed=0):
    rgb = np.random.default_rng(seed).integers(0, 256, size=(h, w, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _direct(svc, data):
    """The class ids of ``data`` from the served forward on its own
    zero-padded batch, as the worker runs a batch of one."""
    imgs = np.zeros((svc.max_batch, SIZE, SIZE, 3), np.float32)
    imgs[0] = svc._preprocess(data)[0]
    return svc.forward(imgs)[0].reshape(svc.grid, svc.grid)


def test_prompt_is_the_jax_daemons(daemon, bpe_dir, monkeypatch):
    captured = {}

    class Capture:
        def __init__(self, cfg, params, categories, src_tokens, **kw):
            captured["src"] = src_tokens

    monkeypatch.setattr(jserve, "SegService", Capture)
    jserve.build_service([f"--category-list={CATEGORIES}", "--arch=segofa_tiny",
                          f"--patch-image-size={SIZE}", f"--bpe-dir={bpe_dir}"], params={})
    _, svc = daemon
    np.testing.assert_array_equal(svc.src[0].numpy(), captured["src"][0])


@pytest.mark.parametrize("mode,shape", [("RGB", (30, 40)), ("L", (50, 20)), ("RGBA", (16, 16)),
                                        ("LA", (31, 33)), ("1", (9, 70)), ("P", (64, 48))])
def test_net_input_equals_jax_preprocess(daemon, mode, shape):
    _, svc = daemon
    rng = np.random.default_rng(len(mode))
    c = {"RGB": 3, "L": 1, "RGBA": 4, "LA": 2, "1": 1, "P": 1}[mode]
    arr = rng.integers(0, 256, size=shape + (c,), dtype=np.uint8)
    if mode == "P":
        img = Image.frombytes("P", shape[::-1], arr.tobytes())
        img.putpalette(rng.integers(0, 256, size=768).tolist())
    else:
        img = Image.fromarray(arr[..., 0] > 127 if mode == "1" else arr[..., 0] if c == 1 else arr)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    got, orig = svc._preprocess(buf.getvalue())
    jax_service = types.SimpleNamespace(size=SIZE)  # all _preprocess reads of its service
    want, want_orig = jserve.SegService._preprocess(jax_service, buf.getvalue())
    assert orig == want_orig == shape
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _jpeg(h=30, w=41, seed=0, mode="RGB", **kw):
    rgb = np.random.default_rng(seed).integers(0, 256, size=(h // 3 + 1, w // 3 + 1, 3),
                                               dtype=np.uint8)
    rgb = np.repeat(np.repeat(rgb, 3, 0), 3, 1)[:h, :w]
    buf = io.BytesIO()
    Image.fromarray(rgb[:, :, 0] if mode == "L" else rgb).save(buf, format="JPEG", **kw)
    return buf.getvalue()


JPEG_BODIES = {"rgb_420": dict(), "rgb_422": dict(subsampling=1),
               "rgb_444_progressive": dict(subsampling=0, progressive=True),
               "gray": dict(mode="L"), "rgb_restarts": dict(restart_marker_blocks=3, quality=95)}


@pytest.mark.parametrize("kind", [*JPEG_BODIES, "cat_dog"])
def test_jpeg_net_input_equals_jax_preprocess(daemon, kind):
    _, svc = daemon
    if kind == "cat_dog":
        data = (chip_smoke.REPO / "assets" / "cat_dog.jpeg").read_bytes()
    else:
        data = _jpeg(seed=len(kind), **JPEG_BODIES[kind])
    got, orig = svc._preprocess(data)
    want, want_orig = jserve.SegService._preprocess(types.SimpleNamespace(size=SIZE), data)
    assert orig == want_orig
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_jpeg_answer_is_the_png_answer_of_its_pixels(daemon):
    """A JPEG body gets the mask a PNG body of the pixels PIL decodes from it
    gets: the argmax of the served forward, resized to the input's size."""
    base, svc = daemon
    data = _jpeg(seed=7)
    status, ctype, body = _post(base + "/segment", data)
    assert status == 200 and ctype == "image/png"
    buf = io.BytesIO()
    Image.open(io.BytesIO(data)).save(buf, format="PNG")
    status, _, from_png = _post(base + "/segment", buf.getvalue())
    assert status == 200
    mask = np.asarray(Image.open(io.BytesIO(body)))
    grid = _direct(svc, data)
    want = np.asarray(Image.fromarray(grid.astype(np.uint8), mode="L").resize((41, 30),
                                                                              Image.NEAREST))
    np.testing.assert_array_equal(mask, want)
    np.testing.assert_array_equal(mask, np.asarray(Image.open(io.BytesIO(from_png))))
    status, _, out = _post(base + "/segment?format=json", data)
    assert status == 200 and sum(json.loads(out)["areas"].values()) == svc.grid ** 2


def test_healthz_and_png_answer(daemon):
    base, svc = daemon
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"ok": True, "ready": True}
    data = _png()
    status, ctype, body = _post(base + "/segment", data)
    assert status == 200 and ctype == "image/png"
    mask = np.asarray(Image.open(io.BytesIO(body)))
    grid = _direct(svc, data)
    want = np.asarray(Image.fromarray(grid.astype(np.uint8), mode="L").resize((40, 30),
                                                                              Image.NEAREST))
    assert mask.shape == (30, 40)  # the input's size
    np.testing.assert_array_equal(mask, want)


def test_json_answer(daemon):
    base, svc = daemon
    data = _png(seed=1)
    status, _, body = _post(base + "/segment?format=json", data)
    out = json.loads(body)
    assert status == 200 and out["grid"] == svc.grid
    assert sum(out["areas"].values()) == svc.grid ** 2
    grid = _direct(svc, data)
    names = [c.strip() for c in CATEGORIES.split(",")]
    assert out["areas"] == {names[c]: int((grid == c).sum()) for c in np.unique(grid)}


def test_concurrent_requests_are_batched(daemon):
    base, svc = daemon
    before = dict(svc.stats)
    results = []

    def hit(i):
        results.append(_post(base + "/segment?format=json", _png(seed=i))[0])

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert results == [200] * 4
    assert svc.stats["requests"] == before["requests"] + 4
    # with a 200 ms window at least one batch of several requests formed
    assert svc.stats["batched_requests"] > before["batched_requests"]


def test_bad_bodies_get_400(daemon, monkeypatch):
    base, _ = daemon
    gif = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(gif, format="GIF")
    for body in (gif.getvalue(), b"not an image", _jpeg()[:200]):
        status, _, out = _post(base + "/segment", body)
        assert status == 400, out
    # a PNG cut inside its image data is what the JAX daemon decodes under
    # LOAD_TRUNCATED_IMAGES: the rows it lacks black, here all of them, so it
    # answers a segmentation, the one of the black image
    monkeypatch.setattr(ImageFile, "LOAD_TRUNCATED_IMAGES", True)  # as the JAX package sets it
    cut = _png()[:60]
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(cut))), np.zeros((30, 40, 3), np.uint8))
    status, _, out = _post(base + "/segment", cut)
    black = io.BytesIO()
    Image.fromarray(np.zeros((30, 40, 3), np.uint8)).save(black, format="PNG")
    assert status == 200 and out == _post(base + "/segment", black.getvalue())[2]
    assert _post(base + "/nowhere", b"")[0] == 404


def test_a_failing_worker_gets_500_and_the_worker_survives(daemon, monkeypatch):
    base, svc = daemon
    errors = svc.stats.get("errors", 0)

    def broken(images):
        raise RuntimeError("device lost")

    monkeypatch.setattr(svc, "forward", broken)
    status, _, body = _post(base + "/segment", _png())
    assert status == 500 and "device lost" in json.loads(body)["error"]
    assert svc.stats["errors"] == errors + 1
    monkeypatch.undo()
    assert _post(base + "/segment", _png())[0] == 200


def test_without_a_card_the_daemon_needs_device_cpu(monkeypatch, bpe_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.build_service([f"--category-list={CATEGORIES}", "--arch=segofa_tiny",
                              f"--patch-image-size={SIZE}", f"--bpe-dir={bpe_dir}"],
                             model=torch_tiny(patch_image_size=SIZE, orig_patch_image_size=SIZE,
                                              num_seg_tokens=3))
