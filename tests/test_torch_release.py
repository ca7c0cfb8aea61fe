"""The port's packaging tool (particle_sim_tpu_torch/app/release.py): the
counterparts of tests/test_release.py, and the port's copy of the viewer
against the JAX package's."""

import filecmp
import json
import os
import subprocess

import pytest
import torch

import particle_sim_tpu_torch
from particle_sim_tpu_torch.app import release, server
from particle_sim_tpu_torch.ops import step_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_VIEWER = os.path.join(REPO, "particle_sim_tpu", "app", "viewer")


def test_web_bundle_default_url(tmp_path):
    written = release.build_web(str(tmp_path / "dist"))
    names = {os.path.basename(p) for p in written}
    assert names == {"index.html", "sw.js", "manifest.json",
                     "icon-1024.png", "icon-256.png",
                     "icon_ios_touch_192.png", "maskable_icon_x512.png",
                     "favicon.png"}
    sw = (tmp_path / "dist" / "web" / "sw.js").read_text()
    # the cache name is stamped with a content hash, not the dev default
    assert 'const CACHE = "psim-tpu-v1"' not in sw
    assert 'const CACHE = "psim-tpu-' in sw


def test_web_bundle_public_url_rewrite(tmp_path):
    release.build_web(str(tmp_path / "dist"), public_url="/psim")
    web = tmp_path / "dist" / "web"
    html = (web / "index.html").read_text()
    assert '"/psim/manifest.json"' in html
    assert 'register("/psim/sw.js")' in html
    assert "{location.host}/psim/ws" in html
    assert json.loads((web / "manifest.json").read_text())[
        "start_url"] == "/psim/"
    sw = (web / "sw.js").read_text()
    assert '"/psim/"' in sw and '"/psim/manifest.json"' in sw


def test_native_build_and_manifest(tmp_path):
    try:
        subprocess.run(["g++", "--version"], capture_output=True, check=True)
    except (OSError, subprocess.SubprocessError):
        pytest.skip("no g++ toolchain")
    out = str(tmp_path / "dist")
    assert release.main(["--out", out, "--web", "--native", "--ci"]) == 0
    assert os.path.exists(os.path.join(out, "native", "libpsimpack.so"))
    manifest = json.loads(open(os.path.join(out, "MANIFEST.json")).read())
    assert manifest["version"] == particle_sim_tpu_torch.__version__
    assert manifest["ci"] is True
    digest = manifest["artifacts"]["native/libpsimpack.so"]
    assert digest == release.sha256(os.path.join(out, "native",
                                                 "libpsimpack.so"))
    assert len(manifest["artifacts"]) == 9


def test_aot_export_cpu(tmp_path):
    """The exported step loads and gives the plain step's outputs bit for
    bit."""
    out = str(tmp_path / "dist")
    assert release.main(["--out", out, "--aot", "--counts", "1024",
                         "--device", "cpu"]) == 0
    path = os.path.join(out, "aot", "step_torch_n1024.pt2")
    assert os.path.getsize(path) > 1000
    manifest = json.loads(open(os.path.join(out, "MANIFEST.json")).read())
    assert manifest["artifacts"]["aot/step_torch_n1024.pt2"] == \
        release.sha256(path)
    args = release.step_example(1024)
    got = torch.export.load(path).module()(*args)
    want = step_ref.step(*args)
    assert args[0].shape == (3, 8, 128)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_warm_kernels_cpu(tmp_path, monkeypatch):
    """--warm builds the kernels with nvcc and never skips: with no nvcc
    to be found it raises an error that names nvcc."""
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        release.main(["--out", str(tmp_path / "dist"), "--warm"])
    assert not (tmp_path / "dist" / "MANIFEST.json").exists()


def test_viewer_copy_matches_jax_viewer():
    """The port serves its own copy of the viewer; the shared wire
    protocol cannot drift while both trees hold the same files, byte for
    byte."""
    port_viewer = server.VIEWER_DIR
    assert port_viewer == release.VIEWER_DIR
    assert os.path.commonpath([port_viewer, particle_sim_tpu_torch.__path__[
        0]]) == particle_sim_tpu_torch.__path__[0]
    for sub in ("", "assets"):
        a, b = os.path.join(port_viewer, sub), os.path.join(JAX_VIEWER, sub)
        names = sorted(f for f in os.listdir(b)
                       if os.path.isfile(os.path.join(b, f)))
        assert names == sorted(f for f in os.listdir(a)
                               if os.path.isfile(os.path.join(a, f)))
        match, mismatch, errors = filecmp.cmpfiles(a, b, names,
                                                   shallow=False)
        assert mismatch == [] and errors == [] and match == names
