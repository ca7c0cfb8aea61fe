"""The persistent PM's ``two_tier`` flag in the port: kept on the Engine,
carried through checkpoints both ways between the packages, set by the
CLI's and the server's ``--no-two-tier`` and by a ``"pm"`` solver event,
and reported in the server's hello, as the JAX package does."""

import json

import numpy as np
import pytest
import torch

from particle_sim_tpu.core.params import Method as JMethod
from particle_sim_tpu.engine import Engine as JEngine
from particle_sim_tpu.io import checkpoint as jckpt

from particle_sim_tpu_torch.app import cli, server
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.io import checkpoint as ckpt

torch.set_num_threads(1)


def saved_flag(path):
    with np.load(path) as z:
        return json.loads(str(z["meta"]))["two_tier"]


def test_engine_default_and_flag():
    assert Engine(particle_count=500, device="cpu").two_tier is True
    assert Engine(particle_count=500, device="cpu",
                  two_tier=False).two_tier is False


@pytest.mark.parametrize("two_tier", [False, True])
def test_checkpoint_jax_to_port_and_back(tmp_path, two_tier):
    """A JAX checkpoint's flag survives a load and a save by the port, and
    the port's file loads in the JAX package with the same flag."""
    path_j, path_t = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save(path_j, JEngine(particle_count=1000, method=JMethod.JNP,
                               two_tier=two_tier), step_index=2)
    te, idx = ckpt.load(path_j, device="cpu")
    assert idx == 2 and te.two_tier is two_tier
    ckpt.save(path_t, te, step_index=idx)
    assert saved_flag(path_j) is saved_flag(path_t) is two_tier
    je, _ = jckpt.load(path_t)
    assert je.two_tier is two_tier


def test_checkpoint_without_the_field_loads_true(tmp_path):
    """Files from before the field existed resume with the default, as
    particle_sim_tpu/io/checkpoint.py reads them."""
    path = str(tmp_path / "c.npz")
    ckpt.save(path, Engine(particle_count=600, device="cpu",
                           two_tier=False))
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays["meta"]))
    del meta["two_tier"]
    arrays["meta"] = json.dumps(meta)
    np.savez(path, **arrays)
    assert ckpt.load(path, device="cpu")[0].two_tier is True
    assert jckpt.load(path)[0].two_tier is True


@pytest.mark.parametrize("flag", [False, True])
def test_cli_no_two_tier_reaches_the_engine(tmp_path, capsys, flag):
    path = str(tmp_path / "c.npz")
    argv = ["--device", "cpu", "--count", "1024", "--steps", "2",
            "--checkpoint-every", "2", "--checkpoint", path,
            "--stats-every", "0"]
    assert cli.main(argv + (["--no-two-tier"] if flag else [])) == 0
    capsys.readouterr()
    assert saved_flag(path) is (not flag)
    assert ckpt.load(path, device="cpu")[0].two_tier is (not flag)


def test_server_flag_and_pm_events():
    s = server.make_server(["--device", "cpu", "--count", "1024",
                            "--no-two-tier"])
    assert s.engine.two_tier is False and s.hello()["two_tier"] is False
    srv = server.StreamServer(Engine(particle_count=1500, device="cpu"),
                              port=0)
    eng = srv.engine
    assert eng.two_tier is True and srv.hello()["two_tier"] is True
    srv.handle_event({"type": "solver", "name": "pm", "g": 0.5,
                      "softening": 3.0, "two_tier": False})
    assert eng.two_tier is False and srv.hello()["two_tier"] is False
    # an event without the field keeps the flag
    srv.handle_event({"type": "solver", "name": "pm", "g": 0.5,
                      "softening": 2.0})
    assert eng.two_tier is False
    srv.handle_event({"type": "solver", "name": "pm", "g": 0.5,
                      "softening": 2.0, "two_tier": True})
    assert eng.two_tier is True and srv.hello()["two_tier"] is True
    # a rejected event commits none of its fields
    srv.handle_event({"type": "solver", "name": "pm", "g": 0.5,
                      "softening": 2.0, "two_tier": False,
                      "pmx_size": 8.0, "pmx_softening": 5.0})
    assert eng.two_tier is True and srv.hello()["two_tier"] is True
