"""PyTorch port, the HTTP viewer (apps/viewer_torch.py) on the CPU:
tests/test_viewer.py's behaviours -- frame streaming, event routing
(CameraManip, TFE, uiParams), accumulation resets, the edit-latency metric
-- with the port's preview tier on (the viewer's default, 4), its first
frame against the JAX viewer's, and apps/interactive_demo_torch.py against
apps/interactive_demo.py."""
import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "apps"))

import icon_rt  # noqa: E402
import interactive_demo  # noqa: E402
import interactive_demo_torch  # noqa: E402
import viewer  # noqa: E402
import viewer_torch  # noqa: E402

from icon_rt_tpu_torch import app  # noqa: E402
from icon_rt_tpu_torch.utils.png import read_png  # noqa: E402
from test_torch_fast import FB_MISMATCH_BOUND  # noqa: E402

torch.set_num_threads(1)

#: tests/test_viewer.py's scene: 6 samples, 2 a launch (frames at accum
#: 0, 2, 4), so a run spans three presented full-res frames
ARGS = ["--synthetic", "1:3", "--size", "32", "32", "--sample-limit", "6",
        "--samples", "2"]


@pytest.fixture(scope="module")
def live():
    """The port's viewer on a thread (port 0, --device cpu) and a log of its
    launches, one entry a presented frame: (frame_id, samples_per_launch,
    whether the fb came back as a host array, i.e. a preview)."""
    pl = app.build(["--device", "cpu", *ARGS])
    log = []
    launch = pl.launch

    def logged():
        launch()
        log.append((pl.frame_id, pl.samples_per_launch,
                    isinstance(pl._last_fb, np.ndarray)))
    pl.launch = logged
    st = viewer_torch.ViewerState()
    th = threading.Thread(target=viewer_torch.serve, args=(pl,),
                          kwargs=dict(port=0, state=st), daemon=True)
    th.start()
    for _ in range(600):
        if hasattr(st, "port"):
            break
        time.sleep(0.05)
    assert hasattr(st, "port"), "server did not start"
    yield st, f"http://127.0.0.1:{st.port}", pl, log
    st.stop = True
    th.join(timeout=30)


def _get(url, timeout=120):
    """GET, retrying the long-poll's 204 (no newer frame within 15 s)."""
    deadline = time.time() + timeout
    while True:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            if r.status != 204 or time.time() > deadline:
                return r.status, dict(r.headers), r.read()


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status


def _png(data, tmp_path, name):
    path = str(tmp_path / f"{name}.png")
    with open(path, "wb") as f:
        f.write(data)
    return read_png(path)


def _converged(base, log, timeout=120):
    """Wait until the run reached its last frame (accum 4) and the loop has
    gone idle; returns that frame's (headers, png)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        _, h, png = _get(base + "/frame.png?since=-1")
        if int(h["X-Accum-Id"]) >= 4 and int(h["X-Frame-Id"]) == \
                len(log) - 1:
            return h, png
        time.sleep(0.1)
    raise AssertionError("the viewer did not converge")


def _after(log, fid, timeout=60):
    """The log entries of the frames presented after frame `fid`, once the
    run that they start has converged."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        new = log[fid + 1:]
        if new and new[-1][0] + new[-1][1] >= 6:
            return new
        time.sleep(0.05)
    raise AssertionError(f"no converged run after frame {fid}: {log}")


def test_torch_viewer_page_and_first_frame(live):
    st, base, _, _ = live
    status, _, body = _get(base + "/")
    assert status == 200 and b"icon_rt_tpu viewer" in body
    status, heads, png = _get(base + "/frame.png?since=-1")
    assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
    assert int(heads["X-Frame-Id"]) >= 0 and float(heads["X-Fps"]) > 0
    _, _, body = _get(base + "/stats")
    stats = json.loads(body)
    assert stats["launch_ms"] > 0 and stats["encode_ms"] > 0


def test_torch_viewer_progressive_accumulation_advances(live):
    """Frames advance 0, 2, 4 to the sample limit, then the loop idles."""
    st, base, _, log = live
    h, _ = _converged(base, log)
    assert [e[:2] for e in log[:3]] == [(0, 2), (2, 2), (4, 2)]
    fid = int(h["X-Frame-Id"])
    time.sleep(0.3)
    assert len(log) == fid + 1                # idle once converged


def test_torch_viewer_drag_resets_to_a_preview(live, tmp_path):
    """A camera drag restarts accumulation: the first frame after it is a
    preview (constant 4 x 4 blocks, X-Accum-Id 0), then full-res frames at
    accum 0, 2, 4; the converged image equals a direct render of the same
    camera and samples through a fresh pipeline, bit for bit, and differs
    from the image before the drag."""
    st, base, pl, log = live
    _, png_before = _converged(base, log)
    fid = len(log) - 1
    for etype, x in (("down", 16), ("move", 24), ("up", 24)):
        _post(base + "/event", {"type": "view", "etype": etype, "x": x,
                                "y": 16 if etype == "down" else 18,
                                "button": 0, "alt": False})
    _, h2, png2 = _get(base + f"/frame.png?since={fid}")
    new = _after(log, fid)
    assert new == [(0, 0, True), (0, 2, False), (2, 2, False),
                   (4, 2, False)], new
    if int(h2["X-Frame-Id"]) == fid + 1:      # the preview itself
        assert int(h2["X-Accum-Id"]) == 0
        img = _png(png2, tmp_path, "preview").reshape(8, 4, 8, 4, 4)
        assert (img == img[:, :1, :, :1]).all()
    _, png_after = _converged(base, log)
    assert png_after != png_before
    ref = app.build(["--device", "cpu", *ARGS, "-o", str(tmp_path / "ref")])
    cam = pl.camera
    ref.camera.set_orientation(cam.position.copy(), cam.get_poi().copy(),
                               cam.up_vector.copy(), cam.fovy)
    while True:
        ref.launch()
        if not ref.is_running():
            break
    ref.present()
    np.testing.assert_array_equal(_png(png_after, tmp_path, "after"),
                                  read_png(str(tmp_path / "ref.png")))


def test_torch_viewer_tfe_stroke_edit_latency(live):
    """A TFE stroke resets accumulation through the editor's dirty flags
    (the first frame a preview at accum 0) and sets the edit latency."""
    st, base, _, log = live
    _converged(base, log)
    fid = len(log) - 1
    _post(base + "/event", {"type": "tfe", "etype": "down", "x": 10,
                            "y": 148, "button": 0})
    for x in range(20, 150, 10):
        _post(base + "/event", {"type": "tfe", "etype": "move", "x": x,
                                "y": 148, "button": 0})
    _post(base + "/event", {"type": "tfe", "etype": "up", "x": 150,
                            "y": 148, "button": 0})
    new = _after(log, fid)
    assert new[0] == (0, 0, True) and new[-1][0] == 4
    deadline = time.time() + 60
    lat = -1.0
    while time.time() < deadline:
        lat = json.loads(_get(base + "/stats")[2])["edit_latency_ms"]
        if lat >= 0:
            break
        time.sleep(0.1)
    assert lat >= 0, "edit latency was never measured"
    _, _, tfe_png = _get(base + "/tfe.png")
    assert tfe_png[:8] == b"\x89PNG\r\n\x1a\n"


def test_torch_viewer_param_toggle(live):
    """A uiParam change resets accumulation: the first frame after it has
    X-Accum-Id 0 (the JAX viewer's test accepts <= 1: its pipeline advances
    over a reset, fault F2's twin); the parity raygen renders no preview."""
    st, base, _, log = live
    _converged(base, log)
    fid = len(log) - 1
    _post(base + "/event", {"type": "param", "name": "Raygen", "value": "ae"})
    _, h2, _ = _get(base + f"/frame.png?since={fid}")
    if int(h2["X-Frame-Id"]) == fid + 1:
        assert int(h2["X-Accum-Id"]) == 0
    deadline = time.time() + 60
    while len(log) <= fid + 1 and time.time() < deadline:
        time.sleep(0.02)
    assert log[fid + 1] == (0, 1, False)
    _post(base + "/event", {"type": "param", "name": "Raygen",
                            "value": "fast"})
    names = [p["name"] for p in json.loads(_get(base + "/params")[2])]
    assert "Raygen" in names and "Sampler mode" in names
    new = _after(log, fid)
    ae = [e for e in new if e[1] == 1]         # one sample a launch
    assert ae == [(k, 1, False) for k in range(len(ae))], new
    assert new[len(ae):] == [(0, 0, True), (0, 2, False), (2, 2, False),
                             (4, 2, False)], new


def test_torch_viewer_first_png_matches_jax(tmp_path):
    """The first presented frame (full-res sample 0, two samples) of the
    port's viewer and the JAX viewer on the same arguments agree per pixel
    within FB_MISMATCH_BOUND (measured: the PNG bytes are equal)."""
    pngs = []
    for mod, pl in ((viewer_torch, app.build(["--device", "cpu", *ARGS])),
                    (viewer, icon_rt.build(ARGS))):
        st = mod.serve(pl, port=0, max_frames=1)
        assert st.accum_id == 0 and pl.preview_scale == 4
        pngs.append(st.png)
    a, b = (_png(p, tmp_path, f"v{k}") for k, p in enumerate(pngs))
    differ = (a != b).any(axis=-1)
    assert differ.sum() <= FB_MISMATCH_BOUND, differ.sum()
    assert (a[..., :3] != a[0, 0, :3]).any(axis=-1).sum() > 50


def test_torch_demo_matches_jax(tmp_path, capsys):
    """apps/interactive_demo_torch.py at subdivision 2 writes the JAX demo's
    files: the five steps' PNGs within the f32 tier's bound (measured 0, 0,
    0, 0 and 1 of 4096 pixels), the TFE widget and session.xf byte for
    byte, and the same camera CLI string."""
    args = ["--synthetic", "2", "--size", "64"]
    out_t, out_j = str(tmp_path / "t"), str(tmp_path / "j")
    assert interactive_demo_torch.main([*args, "--device", "cpu",
                                        "-o", out_t]) == 0
    cli_t = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("--camera")]
    assert interactive_demo.main([*args, "-o", out_j]) == 0
    cli_j = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("--camera")]
    assert cli_t == cli_j and len(cli_t) == 1
    names = sorted(os.listdir(out_t))
    assert names == sorted(os.listdir(out_j)) and len(names) == 7
    for name in names:
        a, b = os.path.join(out_t, name), os.path.join(out_j, name)
        if name.startswith("step"):
            differ = (read_png(a) != read_png(b)).any(axis=-1)
            assert differ.sum() <= FB_MISMATCH_BOUND, (name, differ.sum())
            assert (read_png(a)[..., 3] > 0).mean() > 0.1
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
