"""CLI coverage: every subcommand driven in-process.

The CLI is the reference's app entry (`src/main.rs`, `src/lib.rs:28-48`)
re-cast headless.  Tests call `cli.main(argv)` in-process rather than via
subprocess: the conftest has already pinned the CPU backend, and the
kernel backend runs with `--interpret`.
"""

import os

import numpy as np
import pytest

from bevy_raytrace_tpu import cli


def test_render_writes_png_and_metrics(tmp_path, capsys):
    out = str(tmp_path / "img.png")
    cli.main([
        "render", "--scene", "config1", "--width", "64", "--height", "32",
        "--spp", "2", "--depth", "3", "-o", out,
    ])
    cap = capsys.readouterr()
    assert cap.out.strip() == out
    assert "rays/s" in cap.err
    assert os.path.exists(out) and os.path.getsize(out) > 100


def test_render_camera_override_changes_image(tmp_path):
    a = str(tmp_path / "a.png")
    b = str(tmp_path / "b.png")
    base = ["render", "--scene", "config1", "--width", "48", "--height",
            "24", "--spp", "1", "--depth", "2"]
    cli.main(base + ["-o", a])
    cli.main(base + ["--lookfrom", "0", "4", "8", "-o", b])
    ia = np.fromfile(a, np.uint8)
    ib = np.fromfile(b, np.uint8)
    assert ia.shape != ib.shape or not np.array_equal(ia, ib)


def test_render_sharded_flag(tmp_path, capsys):
    out = str(tmp_path / "s.png")
    cli.main([
        "render", "--scene", "config1", "--width", "64", "--height", "32",
        "--spp", "1", "--depth", "2", "--sharded", "-o", out,
    ])
    cap = capsys.readouterr()
    assert "mesh:" in cap.err
    assert os.path.exists(out)


def test_animate_writes_frames(tmp_path, capsys):
    outdir = str(tmp_path / "seq")
    cli.main([
        "animate", "--scene", "config1", "--width", "48", "--height", "24",
        "--spp", "1", "--depth", "2", "--frames", "3", "-o", outdir,
    ])
    cap = capsys.readouterr()
    assert cap.out.strip() == outdir
    frames = sorted(os.listdir(outdir))
    assert frames == ["frame_0000.png", "frame_0001.png", "frame_0002.png"]
    assert "s/frame" in cap.err


def test_inverse_improves_and_checkpoints(tmp_path, capsys):
    out = str(tmp_path / "inv.png")
    ckpt = str(tmp_path / "ck.npz")
    cli.main([
        "inverse", "--width", "48", "--height", "27", "--spp", "2",
        "--depth", "3", "--steps", "6", "--checkpoint", ckpt,
        "--checkpoint-every", "3", "-o", out,
    ])
    cap = capsys.readouterr()
    assert os.path.exists(out)
    assert os.path.exists(ckpt)
    assert "recovered center" in cap.err
    losses = [float(line.split("loss")[1])
              for line in cap.err.splitlines() if "loss" in line]
    assert losses, "no loss lines logged"


def test_bad_scene_flag_exits_nonzero():
    with pytest.raises(SystemExit) as e:
        cli.main(["render", "--scene", "nope"])
    assert e.value.code != 0


@pytest.mark.parametrize("backend", ["mxu", "cuda"])
def test_unknown_backend_flag_exits_nonzero(backend, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["render", "--backend", backend])
    assert e.value.code != 0
    assert "xla" in capsys.readouterr().err


def test_render_pallas_backend_interpret(tmp_path, capsys):
    out = str(tmp_path / "k.png")
    cli.main([
        "render", "--scene", "config2", "--width", "40", "--height", "24",
        "--spp", "1", "--depth", "3", "--backend", "pallas", "--interpret",
        "-o", out,
    ])
    assert capsys.readouterr().out.strip() == out
    assert os.path.getsize(out) > 100


def test_render_pallas_without_interpret_names_it(tmp_path):
    """Off the GPU the kernel backend fails loudly instead of silently
    running the interpreter."""
    with pytest.raises(ValueError, match="interpret"):
        cli.main([
            "render", "--scene", "config1", "--width", "16", "--height",
            "8", "--spp", "1", "--depth", "1", "--backend", "pallas",
            "-o", str(tmp_path / "x.png"),
        ])


def test_inverse_fast_backend(tmp_path, capsys):
    """cli inverse --backend pallas drives the residual-replay fast path
    (inverse/fast_grad.py) end-to-end."""
    out = str(tmp_path / "rec.png")
    cli.main([
        "inverse", "--width", "48", "--height", "32", "--spp", "1",
        "--depth", "2", "--steps", "2", "--backend", "pallas",
        "--interpret", "-o", out,
    ])
    cap = capsys.readouterr()
    assert "loss" in cap.err and os.path.exists(out)


def test_inverse_sharded_fast_backend(tmp_path, capsys):
    """cli inverse --sharded --backend pallas drives the SHARDED fast
    path (inverse/shard_grad.py): recording forward + replay backward per
    device stripe, cotangents psum'd over the virtual 8-device mesh."""
    out = str(tmp_path / "rec.png")
    cli.main([
        "inverse", "--width", "48", "--height", "32", "--spp", "1",
        "--depth", "2", "--steps", "2", "--sharded", "--backend", "pallas",
        "--interpret", "-o", out,
    ])
    cap = capsys.readouterr()
    assert "mesh" in cap.err and "loss" in cap.err and os.path.exists(out)


def test_render_sharded_pallas_composes(tmp_path, capsys):
    """--sharded --backend pallas renders each device stripe with the
    kernel; the stripes compose into the single-device kernel image."""
    a = str(tmp_path / "k.png")
    b = str(tmp_path / "k_sharded.png")
    base = ["render", "--scene", "config1", "--width", "64", "--height",
            "32", "--spp", "1", "--depth", "2", "--backend", "pallas",
            "--interpret"]
    cli.main(base + ["-o", a])
    cli.main(base + ["--sharded", "-o", b])
    assert "mesh:" in capsys.readouterr().err
    assert np.array_equal(np.fromfile(a, np.uint8), np.fromfile(b, np.uint8))


def test_serve_live_viewer():
    """cli serve: the headless-compatible interactive session (r5).  The
    HTTP endpoints stand in for the reference's window/input layer:
    GET / is the presentation page, GET /frame.png?yaw=... renders a
    frame through the live session camera (the WASD fly-camera path),
    POST /quit is ESC.  Runs the real server in-process (so the
    conftest's CPU pinning applies) and drives it over HTTP."""
    import socket
    import threading
    import time
    import urllib.error
    import urllib.request

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    t = threading.Thread(target=cli.main, args=([
        "serve", "--scene", "config1", "--width", "64", "--height", "32",
        "--spp", "1", "--depth", "2", "--port", str(port)],), daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    page = None
    for _ in range(100):  # wait for the server to come up
        try:
            page = urllib.request.urlopen(f"{base}/", timeout=30).read()
            break
        except (urllib.error.URLError, ConnectionError):
            time.sleep(0.1)
    assert page is not None, "server never came up"
    assert b"<html" in page and b"frame.png" in page
    # Two different camera poses must both render valid PNGs.
    p1 = urllib.request.urlopen(
        f"{base}/frame.png?yaw=0.2&pitch=0.1&dist=13", timeout=600).read()
    p2 = urllib.request.urlopen(
        f"{base}/frame.png?yaw=1.2&pitch=0.1&dist=9", timeout=600).read()
    assert p1[:8] == b"\x89PNG\r\n\x1a\n" and p2[:8] == p1[:8]
    assert p1 != p2  # the camera really moved
    r = urllib.request.urlopen(
        urllib.request.Request(f"{base}/quit", method="POST"), timeout=60)
    assert r.read() == b"bye"
    t.join(timeout=60)
    assert not t.is_alive(), "server did not shut down on /quit"
