"""Release / packaging tool: the port's deployable artifacts.

Counterpart of ``particle_sim_tpu/app/release.py``, with its flags and
its ``MANIFEST.json``:

  web bundle   ``--web``:    the thin-client viewer (the port's
               ``app/viewer/``: index.html, sw.js, manifest.json and the
               icons) copied into ``<out>/web``, absolute paths prefixed
               with ``--public-url`` and the service worker's cache name
               stamped with a content hash of the bundle, so deployed
               clients pick up a new version.
  native lib   ``--native``: the C++ frame packer (native/packer.cpp)
               compiled with g++ into ``<out>/native``; ``--ci`` drops
               ``-march=native`` for a portable artifact.
  kernel warm  ``--warm``:   the CUDA kernels of ``csrc/`` built with nvcc
               (utils/cuda_build.build) into ``<out>/torch-kernels``, so a
               deployment loads them (cuda_build.load) instead of
               compiling at first use. The JAX package fills an XLA
               compile cache here. Without nvcc this raises.
  AOT export   ``--aot``:    ``torch.export`` of the plain step
               (ops/step_ref.step) at each ``--counts`` capacity, traced
               on ``--device`` (the program runs on that device type
               only), saved to ``<out>/aot/step_torch_n{n}.pt2``, as the
               JAX package exports its jnp step through ``jax.export``.

Everything lands under ``--out`` (default ``dist/``), with a
MANIFEST.json listing each artifact's sha256 and the package version.

Example:
    python -m particle_sim_tpu_torch.app.release --out dist --web \\
        --native --warm --aot --counts 100000 1000000 --public-url /psim
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import torch

from ..ops import step_ref

VIEWER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "viewer")
WEB_ASSETS = ("index.html", "sw.js", "manifest.json")
WEB_ICONS = ("icon-1024.png", "icon-256.png", "icon_ios_touch_192.png",
             "maskable_icon_x512.png", "favicon.png")


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 16), b""):
            h.update(chunk)
    return h.hexdigest()


def rewrite_public_url(text: str, public_url: str) -> str:
    """Prefix the viewer's absolute paths (``/manifest.json``,
    ``/sw.js``, ``/ws``, the cached ``/``) with the deploy prefix."""
    pu = "/" + public_url.strip("/")
    if pu == "/":
        return text
    for path in ("/manifest.json", "/sw.js", "/ws"):
        text = text.replace(f'"{path}"', f'"{pu}{path}"')
        text = text.replace(f"`{path}`", f"`{pu}{path}`")
        # the template-literal WebSocket URL: `ws://${location.host}/ws`
        text = text.replace(f"{{location.host}}{path}",
                            f"{{location.host}}{pu}{path}")
    text = text.replace('"start_url": "/"', f'"start_url": "{pu}/"')
    return text.replace('ASSETS = ["/"', f'ASSETS = ["{pu}/"')


def build_web(out_dir: str, public_url: str = "/") -> list:
    """The viewer bundle in ``<out>/web``. -> the files written."""
    web = os.path.join(out_dir, "web")
    os.makedirs(os.path.join(web, "assets"), exist_ok=True)
    texts = {}
    for name in WEB_ASSETS:
        with open(os.path.join(VIEWER_DIR, name), encoding="utf-8") as f:
            texts[name] = rewrite_public_url(f.read(), public_url)
    bundle_hash = hashlib.sha256(
        "".join(texts[n] for n in WEB_ASSETS).encode()).hexdigest()[:12]
    texts["sw.js"] = texts["sw.js"].replace(
        'const CACHE = "psim-tpu-v1";',
        f'const CACHE = "psim-tpu-{bundle_hash}";')
    written = []
    for name in WEB_ASSETS:
        path = os.path.join(web, name)
        with open(path, "w", encoding="utf-8") as f:
            f.write(texts[name])
        written.append(path)
    for name in WEB_ICONS:
        path = os.path.join(web, "assets", name)
        shutil.copyfile(os.path.join(VIEWER_DIR, "assets", name), path)
        written.append(path)
    return written


def build_native(out_dir: str, ci: bool = False) -> list:
    """The frame packer compiled into ``<out>/native/libpsimpack.so``;
    ``ci`` drops ``-march=native``."""
    from ..native.build import SRC

    nat = os.path.join(out_dir, "native")
    os.makedirs(nat, exist_ok=True)
    lib = os.path.join(nat, "libpsimpack.so")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
    if not ci:
        cmd.append("-march=native")
    subprocess.run(cmd + [str(SRC), "-o", lib], check=True,
                   capture_output=True, timeout=300)
    return [lib]


def warm_kernels(out_dir: str) -> list:
    """The CUDA kernel library built into ``<out>/torch-kernels``
    (cuda_build.build: one nvcc a source, then one link). Raises when
    nvcc is missing: a release never ships without its kernels."""
    from ..utils import cuda_build

    path, secs = cuda_build.build(os.path.join(out_dir, "torch-kernels"))
    print(f"  built {os.path.basename(path)} in {secs:.1f} s",
          file=sys.stderr)
    return [str(path)]


class StepModule(torch.nn.Module):
    """The plain attractor step (ops/step_ref.step) as a module, for
    torch.export."""

    def forward(self, pos, vel, param_vec):
        return step_ref.step(pos, vel, param_vec)


def step_example(n: int, device="cpu"):
    """(pos, vel, param_vec) on ``device`` at ``n`` particles: the hollow
    sphere and a dragged attractor, the inputs the step is exported
    with."""
    from ..core import generate
    from ..core.params import SimParams
    from ..core.state import ParticleState

    pos, vel, col = generate.generate(n)
    st = ParticleState.from_arrays(pos, vel, col, device=device)
    pv = torch.from_numpy(SimParams(
        gravity=1.0, is_mouse_dragging=True,
        mouse_position=(0.0, 0.0, 48.0)).pack()).to(device)
    return st.pos, st.vel, pv


def aot_export(out_dir: str, counts, device="cuda") -> list:
    """``torch.export`` of the plain step at each count, traced on
    ``device``, saved to ``<out>/aot/step_torch_n{n}.pt2`` (load with
    torch.export.load and call ``.module()`` on tensors of that
    device)."""
    aot = os.path.join(out_dir, "aot")
    os.makedirs(aot, exist_ok=True)
    written = []
    for n in counts:
        ep = torch.export.export(StepModule(), step_example(n, device))
        path = os.path.join(aot, f"step_torch_n{n}.pt2")
        torch.export.save(ep, path)
        written.append(path)
    return written


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="particle_sim_tpu_torch.release",
        description="Package the port's deployable artifacts")
    p.add_argument("--out", default="dist")
    p.add_argument("--web", action="store_true",
                   help="bundle the thin-client viewer")
    p.add_argument("--public-url", default="/",
                   help="deploy path prefix for web assets")
    p.add_argument("--native", action="store_true",
                   help="compile the C++ frame packer")
    p.add_argument("--warm", action="store_true",
                   help="build the CUDA kernels into <out>/torch-kernels "
                        "(needs nvcc)")
    p.add_argument("--aot", action="store_true",
                   help="torch.export the plain step to <out>/aot")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the device --aot exports the step for")
    p.add_argument("--counts", type=int, nargs="+",
                   default=[100_000, 1_000_000],
                   help="capacities the step is exported at")
    p.add_argument("--ci", action="store_true",
                   help="portable artifacts: no -march=native")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (args.web or args.native or args.warm or args.aot):
        args.web = args.native = True      # the default artifact set
    os.makedirs(args.out, exist_ok=True)

    artifacts: list = []
    t0 = time.perf_counter()
    if args.web:
        artifacts += build_web(args.out, args.public_url)
    if args.native:
        artifacts += build_native(args.out, ci=args.ci)
    if args.warm:
        artifacts += warm_kernels(args.out)
    if args.aot:
        artifacts += aot_export(args.out, args.counts, args.device)

    from .. import __version__

    manifest = {
        "version": __version__,
        "public_url": args.public_url,
        "ci": args.ci,
        "artifacts": {os.path.relpath(p, args.out): sha256(p)
                      for p in artifacts},
    }
    with open(os.path.join(args.out, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    print(json.dumps({"out": args.out, "artifacts": len(artifacts),
                      "wall_s": round(time.perf_counter() - t0, 2)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
