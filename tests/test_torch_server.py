"""The port's HTTP server (vrgdg_tpu_torch.server) against the JAX
package's (vrgdg_tpu.server) on the CPU.

The same requests go to JAX's ``create_app`` and to the port's
``create_app(device="cpu")``, both through aiohttp's ``TestClient`` (as
tests/test_server.py runs it, over a socket on 127.0.0.1).  Status codes, ``ok`` and
the JSON keys and values must agree, leaving out paths, timings,
``device``, ``backend`` and ``version``.  Media written by routes without
grain decode within one uint8 level on at most 0.1% of values
(tests/test_torch_images.py's bound); with grain on, frame count and size
agree and two identical requests give the same bytes.
"""

import asyncio
import base64
import functools
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
import zipfile

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
aiohttp = pytest.importorskip("aiohttp")

from aiohttp.test_utils import TestClient, TestServer

from vrgdg_tpu.server import create_app as jax_create_app
from vrgdg_tpu_torch import server as tserver
from vrgdg_tpu_torch.kernels import build
from vrgdg_tpu_torch.ops import resize as trz
from vrgdg_tpu_torch.server import routes as troutes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# route groups of the JAX server the port does not register, by path
# prefix: none are left
NOT_PORTED = ()
# the groups ported last, with their path counts
LATEST_GROUPS = {"/vrgdg/lyrics/": 2, "/vrgdg/llm_batches/": 8,
                 "/vrgdg/text_tools/": 2, "/vrgdg/graph/": 2}

# timings, the device, and the byte size of encoded files (their pixels
# may differ by a level)
VOLATILE = {"elapsed_seconds", "processed_fps", "stage_seconds",
            "stage_seconds_total", "device", "backend", "version",
            "created_at", "updated_at", "mtime", "fps_per_chip",
            "mesh_devices", "mesh_shape", "size"}


# --------------------------------------------------------------------------
# two clients with one interface
# --------------------------------------------------------------------------

def _multipart(fields):
    """``fields``: (name, filename or None, bytes) -> (body, content type)."""
    boundary = "vrgdgboundary7MA4YWxkTrZu0gW"
    lines = []
    for name, filename, data in fields:
        disposition = f'form-data; name="{name}"'
        if filename is not None:
            disposition += f'; filename="{filename}"'
        lines.append(f"--{boundary}\r\nContent-Disposition: {disposition}"
                     "\r\nContent-Type: application/octet-stream\r\n\r\n"
                     .encode() + data + b"\r\n")
    body = b"".join(lines) + f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _decoded(status, raw, content_type):
    if content_type.startswith("application/json"):
        return status, json.loads(raw)
    return status, raw


class AioClient:
    """A sync face over aiohttp's TestClient (a real socket on 127.0.0.1)
    on an event loop of its own."""

    def __init__(self, app):
        async def start():
            client = TestClient(TestServer(app))
            await client.start_server()
            return client

        self.loop = asyncio.new_event_loop()
        self.client = self.loop.run_until_complete(start())
        self.host = f"{self.client.host}:{self.client.port}"

    async def arequest(self, method, path, *, json_body=None, params=None,
                       data=None, headers=None):
        resp = await self.client.request(
            method, path, json=json_body, params=params, data=data,
            headers=headers, allow_redirects=False)
        return _decoded(resp.status, await resp.read(),
                        resp.headers.get("Content-Type", ""))

    def request(self, method, path, **kwargs):
        return self.loop.run_until_complete(
            self.arequest(method, path, **kwargs))

    def close(self):
        self.loop.run_until_complete(self.client.close())
        self.loop.close()


def JaxClient(base):
    return AioClient(jax_create_app(base_folder=base))


def PortClient(base):
    return AioClient(tserver.create_app(base_folder=base, device="cpu"))


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """tests/test_server.py's 10-frame 64x48 clip, a second clip, a still
    and a click track."""
    folder = tmp_path_factory.mktemp("torch_srv_media")
    clips = []
    for name, seed in (("clip.mp4", 0), ("other.mp4", 1)):
        path = str(folder / name)
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                                 (64, 48))
        rng = np.random.default_rng(seed)
        for _ in range(10):
            writer.write(rng.integers(0, 255, (48, 64, 3), np.uint8))
        writer.release()
        clips.append(path)
    still = str(folder / "still.png")
    yy, xx = np.mgrid[0:48, 0:64]
    noise = np.random.default_rng(5).normal(0, 12, (48, 64, 3))
    image = np.stack([xx * 3, yy * 4, xx + yy], -1) + noise + 20
    cv2.imwrite(still, np.clip(image, 0, 255).astype(np.uint8))
    from vrgdg_tpu.runtime import audio_toolkit as at

    sr = 22050
    rng = np.random.default_rng(3)
    n = 10 * sr
    y = rng.normal(0, 0.003, n).astype(np.float32)
    burst = np.exp(-np.linspace(0, 6, int(0.02 * sr))).astype(np.float32)
    for start in range(0, n, sr // 2):
        end = min(n, start + burst.size)
        y[start:end] += 0.9 * burst[:end - start] * rng.normal(
            0, 1, end - start).astype(np.float32)
    wav = str(folder / "mix.wav")
    at.save_wav(wav, at.make_audio(np.tile(y, (1, 2, 1)), sr))
    return {"clip": clips[0], "other": clips[1], "still": still, "wav": wav,
            "folder": str(folder)}


@pytest.fixture()
def pair(tmp_path):
    """A JAX client and a port client, each on a base folder of its own."""
    clients = {}
    try:
        clients["jax"] = JaxClient(str(tmp_path / "jax"))
        clients["port"] = PortClient(str(tmp_path / "port"))
        yield clients, tmp_path
    finally:
        for client in clients.values():
            client.close()


# --------------------------------------------------------------------------
# comparison
# --------------------------------------------------------------------------

_STAMP = re.compile(r"\d{8}_\d{6}|\d{10,}|[0-9a-f]{8,32}")


def _norm(value, roots, volatile=VOLATILE):
    """Paths relative to the client's folder, stamps and ids blanked,
    volatile keys dropped."""
    if isinstance(value, dict):
        return {k: _norm(v, roots, volatile) for k, v in value.items()
                if k not in volatile}
    if isinstance(value, list):
        return [_norm(v, roots, volatile) for v in value]
    if isinstance(value, str):
        for root, tag in roots:
            value = value.replace(root, tag)
        return _STAMP.sub("#", value)
    return value


def _differences(ours, theirs, where=""):
    """Where two JSON values differ: ``[(key path, ours, theirs)]``."""
    if isinstance(ours, dict) and isinstance(theirs, dict):
        found = []
        for key in sorted(set(ours) | set(theirs)):
            found += _differences(ours.get(key, "<missing>"),
                                  theirs.get(key, "<missing>"),
                                  f"{where}.{key}")
        return found
    if isinstance(ours, list) and isinstance(theirs, list) \
            and len(ours) == len(theirs):
        return [d for i, (a, b) in enumerate(zip(ours, theirs))
                for d in _differences(a, b, f"{where}[{i}]")]
    return [] if ours == theirs else [(where, ours, theirs)]


def _agree(jax_reply, port_reply, tmp_path, shared=(), volatile=VOLATILE):
    """Both replies' status, ok and normalized JSON; ``shared`` lists
    folders both clients read from."""
    (j_status, j_body), (p_status, p_body) = jax_reply, port_reply
    assert (p_status, type(p_body)) == (j_status, type(j_body)), \
        (port_reply, jax_reply)
    if not isinstance(j_body, dict):
        return
    roots = [(str(tmp_path / "jax"), "<base>"), (str(tmp_path / "port"),
                                                  "<base>")]
    roots += [(folder, "<shared>") for folder in shared]
    differences = _differences(_norm(p_body, roots, volatile),
                               _norm(j_body, roots, volatile))
    assert not differences, differences


def both(clients, tmp_path, method, path, shared=(), volatile=VOLATILE,
         **kwargs):
    """Send one request to both servers; ``kwargs`` may hold ``{base}`` in
    string values of ``json_body``, replaced per client."""
    replies = {}
    for name, client in clients.items():
        body = kwargs.get("json_body")
        if body is not None:
            body = json.loads(json.dumps(body).replace(
                "{base}", str(tmp_path / name)))
        replies[name] = client.request(
            method, path, **{**kwargs, "json_body": body})
    _agree(replies["jax"], replies["port"], tmp_path, shared, volatile)
    return replies["jax"], replies["port"]


def _levels_apart(got, want, share=1e-3):
    """One uint8 level on at most ``share`` of values (0.1%:
    test_torch_images.py's bound)."""
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert int(diff.max()) <= 1
    assert float((diff > 0).mean()) <= share


def _close_after_codec(got, want):
    """Frames whose sources differ by a level on a few values (above the
    0.1% of :func:`_levels_apart`): mp4v's lossy blocks spread such a
    change over its block, so only the frame count, the size and a mean
    difference under half a level are held."""
    assert got.shape == want.shape
    assert float(np.abs(got.astype(np.int16)
                        - want.astype(np.int16)).mean()) < 0.5


def _decode(path):
    capture = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(frame)
    capture.release()
    return np.stack(frames)


def _read(path):
    return _decode(path) if path.endswith(".mp4") else cv2.imread(path)


# --------------------------------------------------------------------------
# the route table
# --------------------------------------------------------------------------

def _routes(app):
    table = set()
    for route in app.router.routes():
        info = route.resource.get_info() if route.resource else {}
        path = info.get("path") or info.get("formatter")
        if path and route.method in ("GET", "POST"):
            table.add((route.method, path))
    return table


def _ported(path):
    return not path.startswith(NOT_PORTED)


def test_route_table_equals_the_jax_groups_it_ports():
    jax_table = _routes(jax_create_app())
    port_table = _routes(tserver.create_app(device="cpu"))
    assert port_table == {r for r in jax_table if _ported(r[1])}
    left_out = {r for r in jax_table if not _ported(r[1])}
    # every group is ported: the two route tables are equal
    assert not left_out and not NOT_PORTED
    assert port_table == jax_table and len(port_table) > 190


def test_route_table_of_the_latest_groups_equals_the_jax_apps():
    jax_table = _routes(jax_create_app())
    port_table = _routes(tserver.create_app(device="cpu"))
    for prefix, count in LATEST_GROUPS.items():
        ours = {r for r in port_table if r[1].startswith(prefix)}
        assert ours == {r for r in jax_table if r[1].startswith(prefix)}
        assert len(ours) == count, prefix
    assert sum(LATEST_GROUPS.values()) == 14


def test_panel_routes_of_the_ported_groups_are_registered():
    with open(troutes.PANEL_PATH, encoding="utf-8") as handle:
        panel = set(re.findall(r'"(/vrgdg/[a-z_/]+)"', handle.read()))
    registered = {path for _, path in _routes(tserver.create_app(device="cpu"))}
    assert {r for r in panel if _ported(r)} <= registered


# --------------------------------------------------------------------------
# scenarios, each against the JAX server
# --------------------------------------------------------------------------

def test_catalog_health_and_ui(pair):
    clients, tmp = pair
    for path in ("/vrgdg/health", "/vrgdg/music_builder/luts",
                 "/vrgdg/update/status", "/vrgdg/node_canvas/status",
                 "/vrgdg/music_builder/post_process/adjust_presets"):
        (_, body), _ = both(clients, tmp, "GET", path)
        assert body["ok"]
    _, (_, body) = both(clients, tmp, "GET", "/vrgdg/health")
    assert body["backend"] == "cpu"
    (_, jax_ui), (_, port_ui) = both(clients, tmp, "GET", "/vrgdg/ui")
    assert port_ui == jax_ui and b"vrgdg_tpu" in port_ui
    (status, _), _ = both(clients, tmp, "GET", "/")
    assert status == 302
    (_, example), (_, ours) = both(clients, tmp, "GET",
                                   "/vrgdg/music_builder/luts/example",
                                   params={"name": "teal_orange.jpg"})
    assert ours == example
    (status, _), _ = both(clients, tmp, "GET",
                          "/vrgdg/music_builder/luts/example",
                          params={"name": "../../etc/passwd"})
    assert status == 404
    # a path no group registers, and a method a route does not take
    (status, _), _ = both(clients, tmp, "POST", "/vrgdg/no_such_group/plan",
                          json_body={})
    assert status == 404
    assert clients["port"].request("GET", "/vrgdg/compare/video")[0] == 405


def test_enhancer_routes(pair, media):
    clients, tmp = pair
    clip = media["clip"]
    shared = (media["folder"],)
    (_, body), _ = both(clients, tmp, "POST", "/vrgdg/video_enhancer/load",
                        json_body={"path": clip}, shared=shared)
    assert body["ok"] and body["video"]["frame_count"] == 10
    with open(clip, "rb") as handle:
        data, content_type = _multipart([("note", None, b"x"),
                                         ("video", "up load.mp4",
                                          handle.read())])
    (_, body), (_, ours) = both(
        clients, tmp, "POST", "/vrgdg/video_enhancer/upload", data=data,
        headers={"Content-Type": content_type})
    assert body["ok"] and ours["video"]["name"].endswith("_up_load.mp4")
    with open(ours["video"]["path"], "rb") as a, open(clip, "rb") as b:
        assert a.read() == b.read()
    data, content_type = _multipart([("video", "x.txt", b"nope")])
    (status, _), _ = both(clients, tmp, "POST",
                          "/vrgdg/video_enhancer/upload", data=data,
                          headers={"Content-Type": content_type})
    assert status == 400
    data, content_type = _multipart([("other", "x.mp4", b"nope")])
    both(clients, tmp, "POST", "/vrgdg/video_enhancer/upload", data=data,
         headers={"Content-Type": content_type})

    (_, jax_prev), (_, port_prev) = both(
        clients, tmp, "POST", "/vrgdg/video_enhancer/preview",
        json_body={"source_path": clip, "timestamp": 0.2,
                   "settings": {"sharpen_strength": 2.0}}, shared=shared)
    assert port_prev["ok"] and os.path.isfile(port_prev["after_path"])
    np.testing.assert_array_equal(cv2.imread(port_prev["before_path"]),
                                  cv2.imread(jax_prev["before_path"]))
    # the enhancer's preview quantizes float frames on the host by
    # truncation (array_to_frames, both packages), so the step's float32
    # differences (<= 1e-5, test_torch_enhancer.py) move a level wherever
    # a value sits on an integer: 0.71% of this frame's values
    _levels_apart(cv2.imread(port_prev["after_path"]),
                  cv2.imread(jax_prev["after_path"]), share=1e-2)
    for name, body in (("jax", jax_prev), ("port", port_prev)):
        status, served = clients[name].request(
            "GET", "/vrgdg/video_enhancer/media",
            params={"path": body["after_path"]})
        with open(body["after_path"], "rb") as handle:
            assert status == 200 and served == handle.read()
    for path in ("/etc/passwd", clip):
        (status, _), _ = both(clients, tmp, "GET",
                              "/vrgdg/video_enhancer/media",
                              params={"path": path})
        assert status == 404

    outputs = {}
    for name, client in clients.items():
        status, body = client.request(
            "POST", "/vrgdg/video_enhancer/render/start",
            json_body={"source_path": clip,
                       "settings": {"sharpen_strength": 1.0,
                                    "output_name": "served.mp4"}})
        assert status == 200 and body["ok"], body
        job_id = body["job"]["job_id"]
        for _ in range(600):
            status, body = client.request(
                "GET", "/vrgdg/video_enhancer/render/status",
                params={"job_id": job_id})
            if body["job"]["status"] in {"complete", "failed", "canceled"}:
                break
            time.sleep(0.1)
        assert body["job"]["status"] == "complete", body["job"].get("error")
        outputs[name] = body
    _agree((200, outputs["jax"]), (200, outputs["port"]), tmp, shared)
    # the enhance step is one level from JAX's on 0.32% of this clip's
    # values (test_torch_enhancer.py holds the step itself)
    _close_after_codec(_decode(outputs["port"]["job"]["output_path"]),
                       _decode(outputs["jax"]["job"]["output_path"]))
    (status, _), _ = both(clients, tmp, "GET",
                          "/vrgdg/video_enhancer/render/status",
                          params={"job_id": "nope"})
    assert status == 404
    (status, _), _ = both(clients, tmp, "POST",
                          "/vrgdg/video_enhancer/render/cancel",
                          json_body={"job_id": "nope"})
    assert status == 400
    job_id = outputs["port"]["job"]["job_id"]
    status, body = clients["port"].request(
        "POST", "/vrgdg/video_enhancer/render/cancel",
        json_body={"job_id": job_id})
    assert status == 200 and body["job"]["status"] == "complete"


def test_enhancer_cancel_and_resume(pair, media):
    """A job canceled after its first segment commits is resumable through
    ``resume_job_id``, and the resumed job completes, on both servers."""
    clients, tmp = pair
    settings = {"segment_seconds": 1, "output_name": "cut.mp4"}
    for name, client in clients.items():
        status, body = client.request(
            "POST", "/vrgdg/video_enhancer/render/start",
            json_body={"source_path": media["clip"], "settings": settings})
        job_id = body["job"]["job_id"]
        client.request("POST", "/vrgdg/video_enhancer/render/cancel",
                       json_body={"job_id": job_id})
        for _ in range(600):
            status, body = client.request(
                "GET", "/vrgdg/video_enhancer/render/status",
                params={"job_id": job_id})
            if body["job"]["status"] in {"complete", "failed", "canceled"}:
                break
            time.sleep(0.05)
        assert body["job"]["status"] in {"complete", "canceled"}, body
        status, body = client.request(
            "POST", "/vrgdg/video_enhancer/render/start",
            json_body={"resume_job_id": job_id})
        assert status == 200 and body["ok"], (name, body)
        for _ in range(600):
            status, body = client.request(
                "GET", "/vrgdg/video_enhancer/render/status",
                params={"job_id": job_id})
            if body["job"]["status"] in {"complete", "failed", "canceled"}:
                break
            time.sleep(0.05)
        assert body["job"]["status"] == "complete", (name, body)
        assert _decode(body["job"]["output_path"]).shape[0] == 10


def _outputs(name, tmp, stem, ext):
    return str(tmp / name / f"{stem}{ext}")


@pytest.mark.parametrize("route,payload,ext", [
    ("/vrgdg/music_builder/luts/apply_video",
     {"lut": "teal_orange.cube", "strength": 8.0}, ".mp4"),
    ("/vrgdg/music_builder/luts/apply_image",
     {"lut": "teal_orange.cube", "strength": 8.0, "input_key": "still"},
     ".png"),
    ("/vrgdg/music_builder/post_process/apply_adjust_video",
     {"settings": {"contrast": 25, "vignette": 20}}, ".mp4"),
    ("/vrgdg/music_builder/post_process/apply_adjust_image",
     {"settings": {"contrast": 25, "fade": 10}, "input_key": "still"},
     ".png"),
    ("/vrgdg/music_builder/post_process/grade_video",
     {"lut": "teal_orange.cube", "strength": 8.0,
      "adjust": {"contrast": 12, "vignette": 20}, "match_strength": 0.7,
      "sharpen_strength": 1.5, "reference_key": "still"}, ".mp4"),
    ("/vrgdg/music_builder/post_process/grade_video",
     {"lut": "teal_orange.cube", "sharpen_strength": 1.5,
      "fused_mode": "xla", "batch_size": 3}, ".mp4"),
], ids=["lut_video", "lut_image", "adjust_video", "adjust_image",
        "grade_flagship_xla", "grade_lut_sharpen_xla"])
def test_grain_off_appliers_agree(pair, media, route, payload, ext):
    clients, tmp = pair
    payload = dict(payload)
    source = media[payload.pop("input_key", "clip")]
    if "reference_key" in payload:
        payload["reference_image"] = media[payload.pop("reference_key")]
    replies = {}
    for name, client in clients.items():
        replies[name] = client.request("POST", route, json_body={
            **payload, "input": source,
            "output": _outputs(name, tmp, "out", ext)})
    _agree(replies["jax"], replies["port"], tmp, (media["folder"],))
    assert replies["port"][1]["ok"], replies["port"]
    _levels_apart(_read(_outputs("port", tmp, "out", ext)),
                  _read(_outputs("jax", tmp, "out", ext)))


@pytest.mark.parametrize("route,payload,ext", [
    ("/vrgdg/music_builder/post_process/apply_film_grain_video",
     {"grain_intensity": 0.08, "seed": 3, "batch_size": 4}, ".mp4"),
    ("/vrgdg/music_builder/post_process/apply_film_grain_image",
     {"grain_intensity": 0.08, "seed": 3, "input_key": "still"}, ".png"),
    ("/vrgdg/music_builder/post_process/grade_video",
     {"lut": "teal_orange.cube", "grain_intensity": 0.05, "seed": 42,
      "fused_mode": "xla"}, ".mp4"),
], ids=["grain_video", "grain_image", "grade_grain"])
def test_grain_on_appliers_agree_in_shape_and_rerun(pair, media, route,
                                                    payload, ext):
    clients, tmp = pair
    payload = dict(payload)
    source = media[payload.pop("input_key", "clip")]
    replies = {}
    for name, client in clients.items():
        replies[name] = client.request("POST", route, json_body={
            **payload, "input": source,
            "output": _outputs(name, tmp, "grain", ext)})
    _agree(replies["jax"], replies["port"], tmp, (media["folder"],))
    again = clients["port"].request("POST", route, json_body={
        **payload, "input": source,
        "output": _outputs("port", tmp, "again", ext)})
    assert again[1]["ok"]
    ours = _read(_outputs("port", tmp, "grain", ext))
    assert ours.shape == _read(_outputs("jax", tmp, "grain", ext)).shape
    np.testing.assert_array_equal(ours,
                                  _read(_outputs("port", tmp, "again", ext)))


@pytest.mark.parametrize("route,payload", [
    ("/vrgdg/music_builder/post_process/preview_adjust",
     {"settings": {"contrast": 30}}),
    ("/vrgdg/music_builder/luts/preview",
     {"lut": "teal_orange.cube", "strength": 6.0}),
    ("/vrgdg/music_builder/post_process/preview_film_grain",
     {"grain_intensity": 0.05, "seed": 4}),
], ids=["adjust", "lut", "grain"])
@pytest.mark.parametrize("input_key", ["clip", "still"])
def test_previews_agree(pair, media, route, payload, input_key):
    clients, tmp = pair
    (_, jax_body), (_, port_body) = both(
        clients, tmp, "POST", route,
        json_body={**payload, "input": media[input_key]},
        shared=(media["folder"],))
    assert port_body["ok"], port_body
    before = [cv2.imread(body["result"]["before"])
              for body in (port_body, jax_body)]
    _levels_apart(*before)
    after = [cv2.imread(body["result"]["after"])
             for body in (port_body, jax_body)]
    if "grain" in route:
        assert after[0].shape == after[1].shape
    else:
        _levels_apart(*after)
    for name, body in (("port", port_body), ("jax", jax_body)):
        status, deleted = clients[name].request(
            "POST", "/vrgdg/music_builder/post_process/delete_preview",
            json_body={"path": body["result"]["after"]})
        assert deleted["result"]["deleted"]
        status, deleted = clients[name].request(
            "POST", "/vrgdg/music_builder/luts/delete_preview",
            json_body={"path": body["result"]["before"]})
        assert deleted["result"]["deleted"]


def test_adjust_presets_agree(pair, media):
    clients, tmp = pair
    route = "/vrgdg/music_builder/post_process/"
    both(clients, tmp, "POST", route + "save_adjust_preset",
         json_body={"name": "srv look!", "settings": {"fade": 10}})
    (_, body), _ = both(clients, tmp, "GET", route + "adjust_presets")
    assert [p["name"] for p in body["presets"]] == ["srv look"]
    preset = os.path.join(media["folder"], "imported.json")
    with open(preset, "w", encoding="utf-8") as handle:
        json.dump({"name": "imported", "settings": {"contrast": 5}}, handle)
    both(clients, tmp, "POST", route + "import_adjust_preset",
         json_body={"path": preset}, shared=(media["folder"],))
    both(clients, tmp, "POST", route + "delete_adjust_preset",
         json_body={"name": "srv look"})
    both(clients, tmp, "POST", route + "delete_adjust_preset",
         json_body={"name": "../../escape"})
    both(clients, tmp, "GET", route + "adjust_presets")


def test_fused_mode_names(pair, media, monkeypatch):
    """``xla`` runs the port's eager chain, ``pallas`` its fused kernels'
    path (their plain versions on the CPU); the reply names the mode as
    asked; anything else is JAX's 400."""
    clients, tmp = pair
    ran = []
    real = troutes.appliers.grade_video

    def spy(*args, **kwargs):
        ran.append(kwargs["fused_mode"])
        return real(*args, **kwargs)

    monkeypatch.setattr(troutes.appliers, "grade_video", spy)
    flagship = {"lut": "teal_orange.cube", "strength": 8.0,
                "adjust": {"contrast": 12, "vignette": 20},
                "reference_image": media["still"], "match_strength": 0.7,
                "sharpen_strength": 1.5, "input": media["clip"]}
    for mode in ("xla", "pallas"):
        replies = {}
        for name, client in clients.items():
            replies[name] = client.request(
                "POST", "/vrgdg/music_builder/post_process/grade_video",
                json_body={**flagship, "fused_mode": mode,
                           "output": _outputs(name, tmp, mode, ".mp4")})
        _agree(replies["jax"], replies["port"], tmp, (media["folder"],))
        assert replies["port"][1]["result"]["fused_mode"] == mode
        # xla: one level on <= 0.1%; pallas: JAX's interpret mode against
        # the port's plain fused versions, a level apart on a few more
        check = _levels_apart if mode == "xla" else _close_after_codec
        check(_decode(_outputs("port", tmp, mode, ".mp4")),
              _decode(_outputs("jax", tmp, mode, ".mp4")))
    assert ran == ["eager", "fused"]
    for mode in ("eager", "fused", "XLA"):
        (status, body), _ = both(
            clients, tmp, "POST",
            "/vrgdg/music_builder/post_process/grade_video",
            json_body={**flagship, "fused_mode": mode,
                       "output": "{base}/bad.mp4"},
            shared=(media["folder"],))
        assert status == 400 and "Unknown fused_mode" in body["error"]
    # a stack the fused mode cannot run is refused, never run eager; the
    # port's reason names its own mode
    replies = {name: client.request(
        "POST", "/vrgdg/music_builder/post_process/grade_video",
        json_body={"input": media["clip"], "lut": "teal_orange.cube",
                   "fused_mode": "pallas",
                   "output": str(tmp / name / "no.mp4")})
        for name, client in clients.items()}
    assert replies["jax"][0] == replies["port"][0] == 400
    assert replies["jax"][1]["error"] == replies["port"][1]["error"].replace(
        "fused_mode='fused'", "fused_mode='pallas'")
    assert ran == ["eager", "fused", "fused"]


def test_compare_routes_agree(pair, media):
    clients, tmp = pair
    shared = (media["folder"],)
    for mode in ("side_by_side", "difference"):
        replies = {}
        for name, client in clients.items():
            replies[name] = client.request("POST", "/vrgdg/compare/image",
                                           json_body={
                "input_a": media["still"], "input_b": media["still"],
                "mode": mode, "difference_gain": 2.0,
                "output": _outputs(name, tmp, mode, ".png")})
        _agree(replies["jax"], replies["port"], tmp, shared)
        _levels_apart(cv2.imread(_outputs("port", tmp, mode, ".png")),
                      cv2.imread(_outputs("jax", tmp, mode, ".png")))
    for mode in ("side_by_side", "blink", "slider"):
        replies = {}
        for name, client in clients.items():
            replies[name] = client.request("POST", "/vrgdg/compare/video",
                                           json_body={
                "input_a": media["clip"], "input_b": media["other"],
                "mode": mode, "batch_size": 4,
                "output": _outputs(name, tmp, mode, ".mp4")})
        _agree(replies["jax"], replies["port"], tmp, shared)
        ours = _decode(_outputs("port", tmp, mode, ".mp4"))
        _levels_apart(ours, _decode(_outputs("jax", tmp, mode, ".mp4")))
        if mode == "side_by_side":
            assert ours.shape[1:3] == (48, 2 * 64 + 2)
    # the default output lands under the served root
    (_, body), _ = both(clients, tmp, "POST", "/vrgdg/compare/image",
                        json_body={"input_a": media["still"],
                                   "input_b": media["still"]}, shared=shared)
    assert body["ok"]
    for payload in ({"paths": [media["clip"], media["other"]],
                     "labels": ["a", "b"]}, {"folder": media["folder"],
                                              "label_tiles": False}):
        replies = {}
        for name, client in clients.items():
            replies[name] = client.request("POST", "/vrgdg/compare/grid",
                                           json_body={
                **payload, "output": _outputs(name, tmp, "grid", ".mp4")})
        _agree(replies["jax"], replies["port"], tmp, shared)
        assert replies["port"][1]["result"]["tiles"] == 2
        _levels_apart(_decode(_outputs("port", tmp, "grid", ".mp4")),
                      _decode(_outputs("jax", tmp, "grid", ".mp4")))
    (status, _), _ = both(clients, tmp, "POST", "/vrgdg/compare/image",
                          json_body={"input_a": media["still"],
                                     "input_b": media["still"],
                                     "mode": "nope"}, shared=shared)
    assert status == 400


def test_face_fix_routes(pair, media):
    """tests/test_server.py's face-fix scenario on both servers."""
    clients, tmp = pair
    (_, body), _ = both(clients, tmp, "POST",
                        "/vrgdg/face_fix/estimate_anchors",
                        json_body={"video_path": media["clip"],
                                   "whole_scene": True,
                                   "anchor_interval": 4},
                        shared=(media["folder"],))
    assert body["ok"] and body["frame_count"] == 10
    assert all(i % 8 != 1 for i in body["anchor_indices"])
    (status, body), _ = both(clients, tmp, "POST", "/vrgdg/face_fix/prepare",
                             json_body={"video_path": media["clip"],
                                        "whole_scene": True},
                             shared=(media["folder"],))
    assert status == 400 and body["ok"] is False
    for route in ("accept_enhanced", "accept_enhanced_anchor",
                  "build_ltx_prompt", "build_ltx_inputs",
                  "accept_ltx_frames", "finalize"):
        (_, body), _ = both(clients, tmp, "POST", f"/vrgdg/face_fix/{route}",
                            json_body={"manifest_path": "{base}/x"})
        assert body["ok"] is False


def test_audio_routes(pair, media):
    clients, tmp = pair
    shared = (media["folder"],)
    (_, body), _ = both(clients, tmp, "POST",
                        "/vrgdg/music_builder/beats/analyze",
                        json_body={"mix_path": media["wav"],
                                   "drums_path": media["wav"]},
                        shared=shared)
    assert body["ok"] and abs(body["result"]["bpm"] - 120.0) < 6.0
    data = body["result"]
    for preset in ("impact_weighted", "varied_no_repeat",
                   "clustered_no_repeat"):
        (_, body), _ = both(clients, tmp, "POST",
                            "/vrgdg/music_builder/beats/scene_srt",
                            json_body={"beat_data": data,
                                       "min_duration": 1.5,
                                       "max_duration": 4.0, "seed": 2,
                                       "duration_preset": preset,
                                       "output_path": "{base}/s.srt"})
        assert body["ok"] and "-->" in body["result"]["srt_text"]
    (_, body), _ = both(clients, tmp, "POST",
                        "/vrgdg/music_builder/audio/peaks",
                        json_body={"path": media["wav"],
                                   "target_peaks": 700}, shared=shared)
    assert body["ok"] and len(body["result"]["peaks"]) >= 500
    for payload in ({"project_folder": "{base}/proj", "duration": 2.5},
                    {"project_folder": "{base}/proj", "duration": 1.0,
                     "scope": "scene", "scene_number": 2},
                    {"duration": 1.0}, {"project_folder": "{base}/p",
                                        "duration": -1}):
        both(clients, tmp, "POST", "/vrgdg/music_builder/create_silent_audio",
             json_body=payload)
    with open(tmp / "port" / "proj" / "project_audio"
              / "project_silence_2_5s.wav", "rb") as a, \
            open(tmp / "jax" / "proj" / "project_audio"
                 / "project_silence_2_5s.wav", "rb") as b:
        assert a.read() == b.read()
    (status, _), _ = both(clients, tmp, "POST",
                          "/vrgdg/music_builder/beats/analyze",
                          json_body={})
    assert status == 400


# --------------------------------------------------------------------------
# the host-only stores: builder, text files, storyboard, editor, LoRA
# --------------------------------------------------------------------------

# the file-system times in the stores' answers (their clocks are frozen)
STORE_VOLATILE = VOLATILE | {"updated", "modified"}


@pytest.fixture()
def stores(pair, media, monkeypatch):
    """The pair with both packages' store clocks frozen at one instant
    (so time-stamped backups get the same names on both sides), an empty
    CapCut home, and seeded media the stores read."""
    from tests.test_torch_builder import PAIRS, freeze_clocks

    freeze_clocks(monkeypatch, [m for pair_ in PAIRS for m in pair_])
    clients, tmp = pair
    monkeypatch.setenv("LOCALAPPDATA", str(tmp / "capcut_home"))
    folder = tmp / "store_media"
    folder.mkdir()
    ok, png = cv2.imencode(".png", cv2.imread(media["still"]))
    assert ok
    data_url = "data:image/png;base64," + base64.b64encode(
        png.tobytes()).decode()
    with open(media["wav"], "rb") as handle:
        wav_bytes = handle.read()
    return clients, tmp, {"data_url": data_url, "wav_bytes": wav_bytes,
                          "shared": (media["folder"], str(folder)),
                          "folder": str(folder)}


def store_call(clients, tmp, method, path, shared, **kwargs):
    return both(clients, tmp, method, path, shared=shared,
                volatile=STORE_VOLATILE, **kwargs)


def test_builder_routes_agree(stores, media):
    clients, tmp, extra = stores
    shared = extra["shared"]

    def call(method, path, **kwargs):
        time.sleep(0.012)  # distinct file times for the mtime orderings
        return store_call(clients, tmp, method, path, shared, **kwargs)

    def post(name, payload):
        return call("POST", "/vrgdg/music_builder/" + name,
                    json_body=payload)

    project = "{base}/Http Clip"
    segments = [{"id": f"s{n}", "start": 1.5 * (n - 1), "end": 1.5 * n,
                 "label": f"Scene {n}", "lyric_text": f"line {n}",
                 "t2i_prompt": f"shot {n}", "timeline_note": f"note {n}"}
                for n in range(1, 5)]
    (_, body), _ = post("new_project", {"project_name": "Http Clip"})
    assert body["ok"] and body["project_folder"].endswith("Http Clip")
    (_, body), _ = post("save_session", {
        "project_folder": project, "audio_path": media["wav"],
        "session": {"segments": segments}})
    assert body["ok"]
    post("save_session", {"project_folder": project,
                          "session": {"segments": segments}})
    post("load_session", {"project_folder": project})
    post("save_project_as", {"project_folder": project,
                             "project_name": "Http Copy",
                             "session": {"segments": segments[:2]}})
    for path in ("list_projects", "model_defaults", "default_context_paths",
                 "default_audio_srt_paths", "instruction_keys"):
        (_, body), _ = call("GET", "/vrgdg/music_builder/" + path)
        assert body["ok"], (path, body)
    assert len(body["keys"]) > 10
    (_, body), _ = post("save_scene_image", {
        "project_folder": project, "scene_number": 2,
        "image_data": extra["data_url"]})
    assert body["saved_path"].endswith("image_0002.png")
    post("archive_scene_image", {"project_folder": project,
                                 "scene_number": 2,
                                 "source_path": media["still"]})
    post("save_flux_reference_image", {
        "project_folder": project, "reference_type": "location",
        "name": "Pier", "image_data": extra["data_url"]})
    post("import_reference_subjects", {"project_folder": project})
    post("import_reference_locations", {"project_folder": project})
    (_, body), _ = post("save_scene_audio", {
        "project_folder": project, "scene_number": 1,
        "source_path": media["wav"]})
    scene_audio = body["saved_path"]
    post("save_project_audio", {"project_folder": project,
                                "audio_name": "mix.m4a",
                                "source_path": media["wav"]})
    (_, body), _ = post("prepare_scene_audio_mix", {
        "project_folder": project,
        "segments": [{**segments[0], "custom_audio_path": media["wav"]},
                     *segments[1:]],
        "global_audio_path": media["wav"]})
    assert body["ok"] and body["scene_count"] == 4
    post("prepare_scene_audio_mix", {"project_folder": project,
                                     "segments": segments})
    post("trim_scene_audio", {"project_folder": project,
                              "source_path": media["wav"],
                              "scene_number": 2, "start": 0.5,
                              "duration": 1.75})
    (_, body), _ = post("analyze_audio", {"audio_path": media["wav"],
                                          "target_peaks": 200})
    assert body["ok"] and len(body["peaks"]) == 200
    post("analyze_audio", {"audio_path": media["still"]})
    post("import_capcut_beats", {"audio_duration": 10})
    post("save_project_srt", {"project_folder": project,
                              "srt_text": "1\n00:00:00,000 --> "
                                          "00:00:02,500\nHello\n"})
    post("save_single_scene_srt", {"project_folder": project,
                                   "scene_number": 3, "start_time": 3.0,
                                   "duration": 1.5, "label": "Bridge"})
    post("load_srt", {"srt_path": project + "/builder_segments.srt"})
    post("load_prompt_json", {"path": project + "/missing.json"})
    post("save_render_log", {"project_folder": project,
                             "log": {"id": "r1", "status": "complete"}})
    post("save_wizard_draft", {"project_folder": project,
                               "draft": {"step": 1}, "lyrics": "la"})
    post("load_wizard_draft", {"project_folder": project})
    post("project_prompt_creator_paths", {"project_folder": project})
    post("import_latest_prompt_creator_outputs", {"project_folder": project})
    post("copy_prompt_creator_outputs", {
        "project_folder": project, "source_project_folder": "{base}/none"})

    # scene videos: the final frame, the scan, the restore
    for name in ("jax", "port"):
        videos = tmp / name / "Http Clip" / "rendered_scene_videos"
        videos.mkdir()
        shutil.copyfile(media["clip"], videos / "video_0001-audio.mp4")
    (_, body), _ = post("extract_video_final_frame", {
        "project_folder": project, "scene_number": 1,
        "source_path": project + "/rendered_scene_videos/"
                                 "video_0001-audio.mp4"})
    assert body["ok"] and body["saved_path"].endswith(".png")
    post("scan_scene_videos", {"project_folder": project})
    post("restore_scene_video", {"project_folder": project,
                                 "scene_number": 1,
                                 "source_path": media["other"]})
    post("delete_project_media", {"project_folder": project,
                                  "path": body["saved_path"].replace(
                                      str(tmp / "jax"), "{base}")})

    # the instruction store
    base = {"project_folder": project, "key": "t2v", "scene_id": "s1"}
    post("get_instruction", base)
    post("save_instruction", {**base, "scope": "all_scenes", "text": "all"})
    post("save_instruction", {**base, "text": "one"})
    post("reset_instruction", {**base, "scope": "scene"})
    post("save_instruction_preset", {"key": "krea2_t2i", "name": "Look",
                                     "text": "body"})
    post("list_instruction_presets", {"key": "zimage_t2i"})
    post("load_instruction_preset", {"key": "ernie_t2i", "name": "Look"})

    # the audio route: the managed root only, audio only
    for name, client in clients.items():
        path = scene_audio.replace(str(tmp / "jax"), str(tmp / name))
        status, served = client.request(
            "GET", "/vrgdg/music_builder/audio", params={"path": path})
        with open(path, "rb") as handle:
            assert status == 200 and served == handle.read()
    for path in (media["wav"], "{base}/Http Clip/vrgdg_builder_session.json"):
        status = [client.request(
            "GET", "/vrgdg/music_builder/audio",
            params={"path": path.replace("{base}", str(tmp / name))})[0]
            for name, client in clients.items()]
        assert status[0] == status[1] in (400, 404)
    # beside it, the peaks route it is a prefix of
    (_, body), _ = call("POST", "/vrgdg/music_builder/audio/peaks",
                        json_body={"path": media["wav"],
                                   "target_peaks": 50})
    assert body["ok"]

    # the streamed export, then the multipart import of each one's ZIP
    members = {}
    for name, client in clients.items():
        status, data = client.request(
            "GET", "/vrgdg/music_builder/export_project",
            params={"project_folder": str(tmp / name / "Http Clip")})
        assert status == 200 and data[:2] == b"PK"
        with zipfile.ZipFile(io.BytesIO(data)) as archive:
            members[name] = {
                info.filename: archive.read(info).replace(
                    str(tmp / name).encode(), b"<base>")
                for info in archive.infolist()}
        data_zip, content_type = _multipart([
            ("project_name", None, b"Back Again"),
            ("project_zip", "pack.vrgdg.zip", data)])
        members[name + " import"] = client.request(
            "POST", "/vrgdg/music_builder/import_project", data=data_zip,
            headers={"Content-Type": content_type})
    assert sorted(members["port"]) == sorted(members["jax"])
    for member, content in members["jax"].items():
        if member.endswith(".json"):
            assert _norm(json.loads(members["port"][member]), [],
                         STORE_VOLATILE) == _norm(json.loads(content), [],
                                                  STORE_VOLATILE), member
        else:
            assert members["port"][member] == content, member
    _agree(members["jax import"], members["port import"], tmp,
           shared, STORE_VOLATILE)
    assert members["port import"][1]["ok"]
    # no ZIP part, a cross-site export, a missing project
    data, content_type = _multipart([("project_name", None, b"x")])
    (status, _), _ = call("POST", "/vrgdg/music_builder/import_project",
                          data=data, headers={"Content-Type": content_type})
    assert status == 400
    (status, _), _ = call("GET", "/vrgdg/music_builder/export_project",
                          params={"project_folder": str(tmp / "nowhere")},
                          headers={"Origin": "http://evil.example"})
    assert status == 403
    (status, _), _ = call("GET", "/vrgdg/music_builder/export_project",
                          params={"project_folder": str(tmp / "nowhere")})
    assert status == 404
    post("delete_project", {"project_folder": "{base}/Http Copy"})
    post("delete_project", {"project_folder": media["folder"]})
    for name in ("Http Clip", "Back Again"):
        assert _tree_bytes(tmp / "port" / name, tmp / "port") == \
            _tree_bytes(tmp / "jax" / name, tmp / "jax")


def _tree_bytes(folder, base):
    """``{relative name: bytes}`` with the base folder's path blanked and
    session JSON's times dropped."""
    found = {}
    for root, _, names in os.walk(folder):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as handle:
                data = handle.read().replace(str(base).encode(), b"<base>")
            if name.endswith(".json"):
                data = _norm(json.loads(data), [], STORE_VOLATILE)
            found[os.path.relpath(path, folder)] = data
    return found


def test_text_storyboard_editor_and_lora_routes_agree(stores, media):
    clients, tmp, extra = stores
    shared = extra["shared"]

    def call(method, path, **kwargs):
        time.sleep(0.012)
        return store_call(clients, tmp, method, path, shared, **kwargs)

    # text files and the audio library
    (_, body), _ = call("POST", "/vrgdg/music_builder/save_text_file",
                        json_body={"path": "{base}/notes.txt",
                                   "content": "hello"})
    assert body["ok"]
    (_, body), _ = call("POST", "/vrgdg/music_builder/load_text_file",
                        json_body={"path": "{base}/notes.txt"})
    assert body["content"] == "hello"
    call("POST", "/vrgdg/music_builder/save_text_file",
         json_body={"path": "{base}/x.sh", "content": "x"})
    (_, body), _ = call("POST", "/vrgdg/text_files/save_advanced",
                        json_body={"folder_name": "story",
                                   "file_name": "scene", "text": "one"})
    assert body["result"]["file_path"].endswith("scene_001.txt")
    for text in ("chapter one\n", "\nchapter two"):
        (_, body), _ = call("POST", "/vrgdg/text_files/save_concat",
                            json_body={"folder_name": "story",
                                       "file_name": "tale", "concat": True,
                                       "text": text})
    assert body["result"]["json"] == {"Prompt1": "chapter one",
                                      "Prompt2": "chapter two"}
    call("GET", "/vrgdg/text_files/list", params={"category": "scene2"})
    call("GET", "/vrgdg/text_files/folders")
    for params in ({"folder": "story"},
                   {"folder": "story", "use_most_recent": "true"},
                   {"folder": "story", "use_custom_base_path": "yes",
                    "custom_base_path": extra["folder"]}):
        call("GET", "/vrgdg/text_files/files", params=params)
    call("GET", "/vrgdg/part2/load_concept_prompts")
    for overwrite in (b"false", b"false", b"on"):
        data, content_type = _multipart([
            ("overwrite", None, overwrite),
            ("audio", "My Song!.wav", extra["wav_bytes"])])
        (_, body), _ = call("POST", "/vrgdg/audio/upload", data=data,
                            headers={"Content-Type": content_type})
    assert body["ok"] and body["files"] == ["My Song (1).wav",
                                            "My Song.wav"]
    data, content_type = _multipart([("overwrite", None, b"1")])
    (status, _), _ = call("POST", "/vrgdg/audio/upload", data=data,
                          headers={"Content-Type": content_type})
    assert status == 400
    call("GET", "/vrgdg/audio/list")
    call("GET", "/vrgdg/test_popup/config")
    (_, body), _ = call("POST", "/vrgdg/test_popup/save_text",
                        json_body={"full_lyrics": "oh", "concept": "dusk"})
    assert body["ok"]
    data, content_type = _multipart([("audio", "drop.wav",
                                      extra["wav_bytes"])])
    call("POST", "/vrgdg/test_popup/upload_audio", data=data,
         headers={"Content-Type": content_type})
    call("GET", "/vrgdg/part2/load_concept_prompts")

    # storyboard
    board = "{base}/board"
    call("POST", "/vrgdg/storyboard/load",
         json_body={"project_folder": board, "cameraMotionSpeed": 9})
    (_, body), _ = call("POST", "/vrgdg/storyboard/save", json_body={
        "project_folder": board, "storyboard": {
            "projectVideoEngine": "ltx",
            "scenes": [{"label": "Open", "image_prompt": "dawn",
                        "video_prompt": "she sings to the camera"}]}})
    assert body["ok"] and body["storyboard"]["scenes"][0]["label"] == "Open"
    call("POST", "/vrgdg/storyboard/import_reference_image", json_body={
        "project_folder": board, "kind": "subject", "name": "Ann",
        "image_data": extra["data_url"]})
    call("POST", "/vrgdg/storyboard/import_reference_image",
         json_body={"project_folder": board, "kind": "subject"})
    call("POST", "/vrgdg/storyboard/export_prompts", json_body={
        "project_folder": board, "storyboard": {"scenes": [
            {"label": "One", "image_prompt": "a red door",
             "video_prompt": "door opens"}]}})

    # video editor, with the remake queue drained
    for name in ("jax", "port"):
        edit = tmp / name / "edit"
        edit.mkdir()
        for number in (1, 2):
            shutil.copyfile(media["clip"], edit / f"video_{number:04d}.mp4")
        (edit / "cut.srt").write_text(
            "1\n00:00:00,000 --> 00:00:00,500\nA\n\n"
            "2\n00:00:00,500 --> 00:00:01,000\nB\n")
    edit = "{base}/edit"
    (_, body), _ = call("POST", "/vrgdg/video_editor/list_clips",
                        json_body={"folder_path": edit})
    assert len(body["clips"]) == 2
    session = {"project_folder": edit, "clips": {
        f"video_{n:04d}.mp4": {"name": f"video_{n:04d}.mp4",
                               "clip_number": n,
                               "path": f"{edit}/video_{n:04d}.mp4",
                               "selected_for_remake": n == 2}
        for n in (1, 2)}}
    call("POST", "/vrgdg/video_editor/save_session",
         json_body={"folder_path": edit, "session": session})
    call("POST", "/vrgdg/video_editor/load_session",
         json_body={"folder_path": edit})
    (_, body), _ = call("POST", "/vrgdg/video_editor/save_frame",
                        json_body={"folder_path": edit,
                                   "clip_name": "video_0001.mp4",
                                   "frame_time": 0.25,
                                   "image_data": extra["data_url"]})
    frame = body["frame_path"]
    call("POST", "/vrgdg/video_editor/load_clip",
         json_body={"session_path": edit + "/vrgdg_temp/editor_session.json",
                    "clip_number": 2})
    for _ in range(2):
        (_, body), _ = call("POST", "/vrgdg/video_editor/remake/next",
                            json_body={
                                "session_path":
                                    edit + "/vrgdg_temp/editor_session.json",
                                "srt_file": edit + "/cut.srt",
                                "audio_path": media["wav"], "fps": 24,
                                "audio_output": "{base}/remake.wav"})
    assert body["ok"] and body["is_valid"] is False
    with open(tmp / "port" / "remake.wav", "rb") as a, \
            open(tmp / "jax" / "remake.wav", "rb") as b:
        assert a.read() == b.read()
    for name, client in clients.items():
        mine = frame.replace(str(tmp / "jax"), str(tmp / name))
        status, served = client.request(
            "GET", "/vrgdg/video_editor/image", params={"path": mine})
        with open(mine, "rb") as handle:
            assert status == 200 and served == handle.read()
        status, served = client.request(
            "GET", "/vrgdg/video_editor/video",
            params={"path": str(tmp / name / "edit" / "video_0001.mp4")})
        assert status == 200 and served[4:8] == b"ftyp"
    for path, route in ((media["clip"], "video"), (frame, "video"),
                        ("/etc/passwd", "image")):
        (status, _), _ = call("GET", f"/vrgdg/video_editor/{route}",
                              params={"path": path.replace(
                                  str(tmp / "jax"), str(tmp))})
        assert status in (400, 404)

    # LoRA dataset
    dataset = "{base}/dataset"
    (_, body), _ = call("POST", "/vrgdg/lora_dataset/save_pair", json_body={
        "dataset_folder": dataset, "index": 1, "image": media["still"],
        "caption": "cap"})
    assert body["ok"] and body["image_path"].endswith("image_001.png")
    call("POST", "/vrgdg/lora_dataset/save_ic_pair", json_body={
        "dataset_folder": dataset, "index": 2, "reference": media["still"],
        "target": extra["data_url"], "instruction": "make it night"})
    call("POST", "/vrgdg/lora_dataset/list",
         json_body={"dataset_folder": dataset})
    call("POST", "/vrgdg/lora_dataset/save_pair",
         json_body={"dataset_folder": ""})
    assert _tree_bytes(tmp / "port", tmp / "port") == \
        _tree_bytes(tmp / "jax", tmp / "jax")


def test_route_error_paths(pair, media):
    """tests/test_server.py's error paths on both servers."""
    clients, tmp = pair
    shared = (media["folder"],)
    both(clients, tmp, "POST", "/vrgdg/music_builder/luts/apply_video",
         json_body={"input": media["clip"], "lut": "../../etc/passwd"},
         shared=shared)
    (status, body), _ = both(clients, tmp, "POST",
                             "/vrgdg/music_builder/luts/apply_image",
                             data=b"not json")
    assert body["ok"] is False
    (status, body), _ = both(clients, tmp, "POST",
                             "/vrgdg/music_builder/luts/preview",
                             json_body={"input": "/nonexistent.png",
                                        "lut": "teal_orange.cube"})
    assert status in (400, 404) and body["ok"] is False
    (status, _), _ = both(clients, tmp, "POST", "/vrgdg/video_enhancer/load",
                          json_body={"path": "/nonexistent.mp4"})
    assert status == 404
    (status, _), _ = both(clients, tmp, "POST",
                          "/vrgdg/video_enhancer/load",
                          json_body=[1, 2])
    assert status == 400
    # accepted, then failing on its thread (or refused): the snapshot in
    # the reply depends on how far the thread got, so only status and ok
    replies = [client.request("POST", "/vrgdg/video_enhancer/render/start",
                              json_body={"settings": {}})
               for client in clients.values()]
    assert replies[0][0] == replies[1][0]
    assert replies[0][1]["ok"] == replies[1][1]["ok"]


def test_mutation_guard_and_token(pair, media, monkeypatch):
    """tests/test_server.py's guard scenario on both servers."""
    clients, tmp = pair
    shared = (media["folder"],)
    load = dict(json_body={"path": media["clip"]}, shared=shared)
    (status, body), _ = both(clients, tmp, "POST",
                             "/vrgdg/video_enhancer/load",
                             headers={"Origin": "http://evil.example"},
                             **load)
    assert status == 403 and body["ok"] is False
    for name, client in clients.items():
        status, body = client.request(
            "POST", "/vrgdg/video_enhancer/load",
            json_body={"path": media["clip"]},
            headers={"Origin": f"http://{client.host}"})
        assert status == 200 and body["ok"], name
    (status, _), _ = both(clients, tmp, "GET", "/vrgdg/health",
                          headers={"Origin": "http://evil.example"})
    assert status == 200
    (status, _), _ = both(clients, tmp, "POST", "/vrgdg/not/a/route",
                          headers={"Origin": "http://evil.example"},
                          json_body={})
    assert status == 403
    monkeypatch.setenv("VRGDG_TPU_TOKEN", "sekrit")
    (status, _), _ = both(clients, tmp, "POST", "/vrgdg/video_enhancer/load",
                          **load)
    assert status == 403
    (_, body), _ = both(clients, tmp, "POST", "/vrgdg/video_enhancer/load",
                        headers={"X-VRGDG-Token": "sekrit"}, **load)
    assert body["ok"] is True
    (status, _), _ = both(clients, tmp, "GET", "/vrgdg/health")
    assert status == 200


def test_health_degrades_on_malformed_release_notes(pair, monkeypatch):
    """tests/test_server.py's malformed release notes on both servers."""
    import vrgdg_tpu.release_notes as jrn
    import vrgdg_tpu_torch.release_notes as trn

    clients, tmp = pair
    bad = tmp / "update_notes.json"
    bad.write_text("{not json")
    monkeypatch.setattr(jrn, "_notes_path", lambda: str(bad))
    monkeypatch.setattr(trn, "_notes_path", lambda: str(bad))
    (status, body), _ = both(clients, tmp, "GET", "/vrgdg/health")
    assert status == 200 and body["ok"] and body["latest_release"] is None
    (status, _), _ = both(clients, tmp, "GET", "/vrgdg/update/status")
    assert status == 400


# --------------------------------------------------------------------------
# the port's own contract
# --------------------------------------------------------------------------

def test_health_leaves_cuda_uninitialized():
    code = ("import asyncio, torch\n"
            "from aiohttp.test_utils import TestClient, TestServer\n"
            "from vrgdg_tpu_torch import server\n"
            "async def main():\n"
            "    client = TestClient(TestServer(server.create_app("
            "device='cpu')))\n"
            "    await client.start_server()\n"
            "    body = await (await client.get('/vrgdg/health')).json()\n"
            "    await client.close()\n"
            "    return body\n"
            "body = asyncio.run(main())\n"
            "assert body['ok'] and body['backend'] == 'cpu', body\n"
            "assert not torch.cuda.is_initialized()\n"
            "print('OK')\n")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120, check=False,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert done.returncode == 0 and "OK" in done.stdout, done.stderr


def test_refusals_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        tserver.create_app(device="cuda")
    done = subprocess.run(
        [sys.executable, "-m", "vrgdg_tpu_torch.cli", "serve", "--port", "0"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=120,
        check=False, env={**os.environ, "PYTHONPATH": REPO})
    assert done.returncode == 2
    assert "no CUDA device is available" in done.stderr


def test_serve_command_answers_health(tmp_path):
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    process = subprocess.Popen(
        [sys.executable, "-m", "vrgdg_tpu_torch.cli", "serve", "--port",
         str(port), "--device", "cpu"], cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env={**os.environ, "PYTHONPATH": REPO,
             "VRGDG_TPU_OUTPUT": str(tmp_path / "out")})
    try:
        deadline = time.time() + 60
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/vrgdg/health",
                        timeout=5) as resp:
                    body = json.loads(resp.read())
                break
            except OSError:
                assert process.poll() is None, process.communicate()
                assert time.time() < deadline
                time.sleep(0.2)
        assert body["ok"] and body["backend"] == "cpu"
    finally:
        process.terminate()
        process.wait(timeout=30)


def test_head_range_and_body_limit_as_jax(pair):
    clients, tmp = pair
    (status, _), (_, head) = both(clients, tmp, "HEAD", "/vrgdg/ui")
    assert status == 200 and head == b""
    (status, jax_part), (_, part) = both(clients, tmp, "GET", "/vrgdg/ui",
                                         headers={"Range": "bytes=5-14"})
    with open(troutes.PANEL_PATH, "rb") as handle:
        assert status == 206 and part == jax_part == handle.read()[5:15]
    assert clients["port"].client.app._client_max_size == \
        clients["jax"].client.app._client_max_size == 1024 ** 3


# --------------------------------------------------------------------------
# state shared by request threads
# --------------------------------------------------------------------------

def test_launch_count_keeps_every_update_across_threads():
    """The launch counter is read-modify-write: under a lock, no thread's
    count is lost (more threads than cores, a short switch interval)."""
    class Ok:
        pass

    lib = Ok()
    switch = sys.getswitchinterval()
    build.reset_launch_counts()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [build.check_launch(lib, 0, "film_grain")
                            for _ in range(2000)])
            for _ in range(4 * (os.cpu_count() or 1))]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=120)
        assert not any(thread.is_alive() for thread in threads)
        assert build.LAUNCHES["film_grain"] == 2000 * len(threads)
    finally:
        sys.setswitchinterval(switch)
        build.reset_launch_counts()


def test_ieee_fp32_blocks_overlap_across_threads():
    """Two threads in ``_ieee_fp32_matmul`` at once: the first to leave
    does not restore TF32 under the other; the last restores it."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    entered, release = threading.Event(), threading.Event()
    seen = []

    def second():
        with trz._ieee_fp32_matmul():
            entered.set()
            release.wait(timeout=30)
            seen.append(flags.allow_tf32)

    try:
        flags.allow_tf32 = True
        thread = threading.Thread(target=second)
        with trz._ieee_fp32_matmul():
            thread.start()
            assert entered.wait(timeout=30)
        assert flags.allow_tf32 is False     # the other block is still open
        release.set()
        thread.join(timeout=30)
        assert not thread.is_alive() and seen == [False]
        assert flags.allow_tf32 is True
    finally:
        flags.allow_tf32 = saved


def test_concurrent_requests_give_their_lone_bytes(tmp_path, media):
    """A render and a grade sent at once give the same files as alone."""
    client = PortClient(str(tmp_path / "port"))
    grade = {"input": media["clip"], "lut": "teal_orange.cube",
             "strength": 8.0, "reference_image": media["still"],
             "match_strength": 0.7, "sharpen_strength": 1.5,
             "grain_intensity": 0.05, "seed": 42, "fused_mode": "pallas",
             "batch_size": 4}
    settings = {"grain_enabled": True, "grain_intensity": 0.08,
                "batch_size": 3}

    async def render(name):
        body = (await client.arequest(
            "POST", "/vrgdg/video_enhancer/render/start",
            json_body={"source_path": media["clip"],
                       "settings": {**settings, "output_name": name}}))[1]
        job_id = body["job"]["job_id"]
        for _ in range(3000):
            body = (await client.arequest(
                "GET", "/vrgdg/video_enhancer/render/status",
                params={"job_id": job_id}))[1]
            if body["job"]["status"] in {"complete", "failed"}:
                break
            await asyncio.sleep(0.05)
        assert body["job"]["status"] == "complete", body
        return body["job"]["output_path"]

    async def graded(out):
        body = (await client.arequest(
            "POST", "/vrgdg/music_builder/post_process/grade_video",
            json_body={**grade, "output": out}))[1]
        assert body["ok"], body
        return out

    async def both_at_once():
        return await asyncio.gather(
            render("both.mp4"), graded(str(tmp_path / "both_grade.mp4")))

    try:
        lone = (client.loop.run_until_complete(render("alone.mp4")),
                client.loop.run_until_complete(
                    graded(str(tmp_path / "alone_grade.mp4"))))
        together = client.loop.run_until_complete(both_at_once())
        for got, want in zip(together, lone):
            np.testing.assert_array_equal(_decode(got), _decode(want))
    finally:
        client.close()


# --------------------------------------------------------------------------
# the workflow runner, prompt creator, start storyboard and Krea2 groups
# --------------------------------------------------------------------------

@pytest.fixture()
def latest(pair, media, monkeypatch, tmp_path):
    """The pair with the new groups' clocks frozen, one fake model root
    for both default catalogs, and no ingest folder from the
    environment."""
    import chip_smoke as cs
    from tests.test_torch_builder import freeze_clocks
    from vrgdg_tpu.api import (krea2_studio, prompt_creator,
                               start_storyboard, workflow_runner)
    from vrgdg_tpu.runtime import text_tools
    from vrgdg_tpu_torch.api import krea2_studio as t_k2s
    from vrgdg_tpu_torch.api import prompt_creator as t_pcr
    from vrgdg_tpu_torch.api import start_storyboard as t_ssb
    from vrgdg_tpu_torch.api import workflow_runner as t_wr
    from vrgdg_tpu_torch.runtime import text_tools as t_tt

    freeze_clocks(monkeypatch, [krea2_studio, prompt_creator,
                                start_storyboard, workflow_runner,
                                text_tools, t_k2s, t_pcr, t_ssb, t_wr, t_tt])
    models = cs.workflow_model_root(str(tmp_path / "models"), 3)
    monkeypatch.setenv("VRGDG_TPU_MODELS", models)
    monkeypatch.delenv("VRGDG_TPU_INPUT", raising=False)
    for module in (workflow_runner, t_wr):
        module.set_default_catalog(None)
    clients, tmp = pair
    yield clients, tmp, models
    for module in (workflow_runner, t_wr):
        module.set_default_catalog(None)


# file times, and the Krea2 dataset's hash over them
LATEST_VOLATILE = STORE_VOLATILE | {"signature"}


def _each(clients, tmp, method, path, body_for, shared=()):
    """One request to each server with a body of its own
    (``body_for(name) -> (data, content type)``), answers compared."""
    replies = {}
    for name, client in clients.items():
        data, content_type = body_for(name)
        replies[name] = client.request(method, path, data=data,
                                       headers={"Content-Type":
                                                content_type})
    _agree(replies["jax"], replies["port"], tmp, shared, LATEST_VOLATILE)
    return replies["jax"], replies["port"]


def test_workflow_runner_and_prompt_creator_routes_agree(latest, media):
    clients, tmp, models = latest
    shared = (media["folder"], models)
    call = functools.partial(both, clients, tmp, shared=shared,
                             volatile=LATEST_VOLATILE)
    (_, body), _ = call("GET", "/vrgdg/workflow_runner/builders")
    assert len(body["builders"]) == 17
    (_, body), _ = call("GET", "/vrgdg/workflow_runner/model_root")
    assert body["source"] == "env" and body["registered"]
    (_, body), _ = call("GET", "/vrgdg/workflow_runner/lora_list")
    assert body["loras"][0] == "[none]" and len(body["loras"]) == 9
    (_, body), (_, ours) = call(
        "POST", "/vrgdg/workflow_runner/build_flux_klein_prompt",
        json_body={"prompt": "two subjects dancing", "seed": 7,
                   "width": 640, "height": 360,
                   "image_ingredients": [{"path": media["still"]}],
                   "use_custom_loras": True, "lora_count": 1,
                   "lora_1": "a.safetensors"})
    assert body["ok"] and ours["prompt"] == body["prompt"]
    # a refusal: its 400 error body
    (status, body), _ = call("POST", "/vrgdg/workflow_runner/model_root",
                             json_body={"models_root": "{base}/missing"})
    assert status == 400 and "not a directory" in body["error"]
    (status, body), _ = call(
        "POST", "/vrgdg/workflow_runner/trim_scene_video",
        json_body={"source_path": "{base}/none.mp4",
                   "project_folder": "{base}/p"})
    assert status == 404 and not body["ok"]

    # the prompt creator's multipart audio import, then its drafts
    with open(media["wav"], "rb") as handle:
        wav = handle.read()

    def upload(name):
        return _multipart([("project_folder", None, str(
            tmp / name / "Http Prompts").encode()),
            ("audio", "My Song!.wav", wav)])

    (_, body), _ = _each(clients, tmp, "POST",
                         "/vrgdg/music_prompt_creator/import_audio", upload)
    assert body["audio_name"] == "My Song.wav"
    (_, body), _ = call("POST", "/vrgdg/music_prompt_creator/save_draft",
                        json_body={"project_folder": "{base}/Http Prompts",
                                   "full_lyrics": "la la",
                                   "srt_text": "1\n00:00:00,000 --> "
                                               "00:00:02,000\nla la\n"})
    assert body["ok"]
    (_, body), _ = call("GET", "/vrgdg/music_prompt_creator/list_drafts")
    assert [p["name"] for p in body["projects"]] == ["Http Prompts"]
    (_, body), _ = call("POST",
                        "/vrgdg/music_prompt_creator/get_instruction",
                        json_body={"project_folder": "{base}/Http Prompts",
                                   "key": "style_theme"})
    assert body["ok"]


def test_start_storyboard_and_krea2_routes_agree(latest, media):
    clients, tmp, models = latest
    shared = (media["folder"],)
    call = functools.partial(both, clients, tmp, shared=shared,
                             volatile=LATEST_VOLATILE)
    # a builder project, then its start storyboard
    call("POST", "/vrgdg/music_builder/new_project",
         json_body={"project_name": "Http Board"})
    call("POST", "/vrgdg/music_builder/save_session",
         json_body={"project_folder": "{base}/Http Board", "session": {
             "segments": [{"id": f"s{n}", "lyric_text": f"line {n}"}
                          for n in range(1, 4)]}})
    (_, body), _ = call("POST", "/vrgdg/start_storyboard/load",
                        json_body={"project_folder": "{base}/Http Board"})
    assert len(body["storyboard"]["scenes"]) == 3
    (_, body), _ = call("POST", "/vrgdg/start_storyboard/import_latest",
                        json_body={"project_folder": "{base}/Http Board",
                                   "scene_number": 2,
                                   "source_path": media["still"]})
    image = body["saved_path"]
    (_, theirs), (_, ours) = [
        (client.request("GET", "/vrgdg/start_storyboard/image", params={
            "project_folder": str(tmp / name / "Http Board"),
            "path": image.replace(str(tmp / "jax"), str(tmp / name))}))
        for name, client in clients.items()]
    assert ours == theirs and ours[:4] == b"\x89PNG"
    (status, body), _ = call("POST", "/vrgdg/start_storyboard/load",
                             json_body={"project_folder": media["folder"]})
    assert status == 400 and "not a Video Builder project" in body["error"]

    # Krea2: a project, edit pairs by multipart (two sizes, no image)
    call("POST", "/vrgdg/krea2_studio/create_project",
         json_body={"project_name": "Http Lora"})
    ok, png = cv2.imencode(".png", np.zeros((24, 32, 3), np.uint8))
    ok, tall = cv2.imencode(".png", np.zeros((30, 32, 3), np.uint8))

    def pairs(role, files):
        def body(name):
            return _multipart(
                [("project_dir", None, str(tmp / name / "VRGDG_Krea2_Studio"
                                           / "Http_Lora").encode()),
                 ("role", None, role.encode())]
                + [("files", filename, data) for filename, data in files])
        return body

    _each(clients, tmp, "POST", "/vrgdg/krea2_studio/import_edit_files",
          pairs("control", [("a.png", png.tobytes()),
                            ("b.png", b"no image here")]))
    (_, body), (_, ours) = _each(
        clients, tmp, "POST", "/vrgdg/krea2_studio/import_edit_files",
        pairs("target", [("a.png", tall.tobytes()), ("a.txt", b"x"),
                         ("b.png", png.tobytes()), ("b.txt", b"y")]))
    problems = ours["dataset_sync"]["problems"]
    assert problems[0] == "a: control (32, 24) and target (32, 30) " \
        "dimensions differ"
    assert problems[1].startswith("b: could not validate image dimensions "
                                  "(cannot identify image file")
    (_, body), _ = call("POST",
                        "/vrgdg/krea2_studio/build_clear_memory_prompt")
    assert body["prompt"]
    (status, _), _ = call("GET", "/vrgdg/krea2_studio/file",
                          params={"path": media["still"]})
    assert status == 404
