"""The port's engine in mesh mode (``Engine(mesh=)``, ``--mesh auto``) on
a gloo group of two CPU processes, beside the single-device engine of the
same configuration: the counterparts of tests/test_engine_mesh.py's
tests and of tests/test_engine_persist.py's three mesh tests
(``test_persist_with_mesh``, ``test_persist_with_mesh_two_level``,
``test_mesh_pm2_auto_promotes_persist``), at their bars, plus the mesh's
checkpoint, pmx counts and server refusals. Every scenario runs once, on
both ranks, in tests/torch_mesh_workers.py (the module fixture); one test
holds the mesh ring against the JAX engine on two of the 8 virtual
devices, and the CLI also runs a world of one in this process."""

import json

import jax
import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from particle_sim_tpu.core.params import Method as JMethod
from particle_sim_tpu.core.params import PairwiseParams as JPairwise
from particle_sim_tpu.core.params import SimParams as JSimParams
from particle_sim_tpu.engine import Engine as JEngine
from particle_sim_tpu.parallel import mesh as jml

from particle_sim_tpu_torch.app import cli
from particle_sim_tpu_torch.core.params import PMConfig
from particle_sim_tpu_torch.engine import Engine
from particle_sim_tpu_torch.io import checkpoint as ckpt

torch.set_num_threads(1)

WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return W.run_group(WORLD, "engine", str(tmp_path_factory.mktemp("eng")))


@pytest.fixture(scope="module")
def r0(ranks):
    return ranks[0]


def test_sharded_step_matches_single(r0):
    p1, pm, v1, vm = r0["step"]
    np.testing.assert_allclose(pm, p1, rtol=0, atol=1e-5)
    np.testing.assert_allclose(vm, v1, rtol=0, atol=1e-5)


def test_sharded_state_is_sharded(r0):
    local_rows, global_rows = r0["rows"]
    assert global_rows == WORLD * local_rows == 4096 // 128


def test_sharded_pairwise_ring(r0):
    single, sharded = r0["ring"]
    np.testing.assert_allclose(sharded, single, rtol=1e-4, atol=1e-4)


def test_sharded_pairwise_ring_matches_jax_mesh_engine(r0):
    """The JAX engine's ring on a mesh of two devices, same scene."""
    je = JEngine(particle_count=2048, method=JMethod.JNP,
                 pairwise=JPairwise(2.0, 0.5),
                 mesh=jml.make_mesh(jax.devices()[:WORLD]))
    for _ in range(3):
        je.step(JSimParams())
    pos, vel = r0["ring_state"]
    np.testing.assert_allclose(pos, np.asarray(je.state.pos), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(vel, np.asarray(je.state.vel), rtol=1e-4,
                               atol=1e-4)


def test_sharded_pm_with_masses(r0):
    single, sharded, masses = r0["pm_masses"]
    np.testing.assert_allclose(sharded, single, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        masses, np.linspace(0.5, 3.0, 3000).astype(np.float32))


def test_sharded_lifecycle(r0):
    evolved, grown, count_shrunk, vel_reset = r0["lifecycle"]
    count, capacity, local_rows, kept = grown
    assert count == 5000 and capacity % (WORLD * 8 * 128) == 0
    assert local_rows * WORLD * 128 == capacity
    np.testing.assert_allclose(kept, evolved, atol=1e-6)
    assert count_shrunk == 1000
    assert (vel_reset == 0).all()
    # grown particles get mass 1
    m = r0["grown_masses"]
    assert (m[:1000] == 2.0).all() and (m[1000:] == 1.0).all()


def test_cli_mesh_auto(ranks):
    """Inside the group: rank 0 prints the mesh line, the stats and the
    done line; rank 1 prints nothing."""
    rc, out, err = ranks[0]["cli"]
    assert rc == 0
    assert json.loads(out.strip().splitlines()[-1])["done"]
    assert f"mesh: dp over {WORLD} devices" in err
    assert ranks[1]["cli"] == (0, "", "")


def test_cli_mesh_auto_world_of_one(capsys):
    """Without a group or torchrun's env, --device cpu runs a world of
    one in this process (and leaves no group behind)."""
    rc = cli.main(["--device", "cpu", "--count", "2000", "--steps", "10",
                   "--method", "torch", "--mesh", "auto", "--gravity",
                   "1.0", "--stats-every", "0"])
    assert rc == 0
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1])["done"]
    assert "mesh: dp over 1 devices" in out.err
    assert not torch.distributed.is_initialized()


def test_mesh_render_and_stream(r0):
    """Output paths read the gathered state."""
    img = r0["scatter"]
    assert img.shape == (720, 1280, 4) and (img[..., :3] > 0).any()
    pos_shape, rgba_shape = r0["stream"]
    assert pos_shape[0] == 3 and rgba_shape[1] == 4


def test_mesh_render_psum_composite(ranks):
    """Each rank draws its rows and one all-reduce of the tile planes
    composites the frame: the single engine's compact frame within 2 u8
    levels, the same on every rank; an untiled frame falls back to the
    gathered state."""
    single, sharded = ranks[0]["composite"]
    assert (sharded[..., :3] > 0).any()
    assert np.abs(sharded.astype(int) - single.astype(int)).max() <= 2
    np.testing.assert_array_equal(ranks[1]["composite"][1], sharded)
    single, sharded = ranks[0]["untiled"]
    assert np.abs(sharded.astype(int) - single.astype(int)).max() <= 2


def test_mesh_persist_render_from_carry(r0):
    """Persist + mesh: the frame comes from the sorted carry without the
    identity rebuild and matches the scatter frame of the identity order
    within 3 u8 levels."""
    fast, dirty_after_fast, ref, dirty_after_scatter = r0["persist_frames"]
    assert dirty_after_fast and not dirty_after_scatter
    assert (fast[..., :3] > 0).any()
    assert np.abs(fast.astype(int) - ref.astype(int)).max() <= 3


def test_persist_with_mesh(r0):
    persist, per_frame = r0["persist_mesh"]
    np.testing.assert_allclose(persist, per_frame, rtol=0, atol=5e-3)


def test_persist_with_mesh_two_level(r0):
    single, sharded = r0["persist_two_level"]
    np.testing.assert_allclose(sharded, single, rtol=0, atol=5e-3)


def test_mesh_pm2_auto_promotes_persist(r0):
    assert r0["auto_promotes"] == (True, True)
    auto_box, explicit_false, pmx_no_stack, pmx_capacity = r0["refused"]
    assert "static box" in auto_box
    assert "pm_persist" in explicit_false
    assert "tuple pm2" in pmx_no_stack
    assert "512 * 2" in pmx_capacity


def test_mesh_pmx_counts_match_one_device(r0):
    (c1, p1), (cm, pm) = r0["pmx"]
    assert c1 == cm and cm[0] > 0
    np.testing.assert_allclose(pm, p1, rtol=0, atol=1e-4)


def test_server_refuses_per_frame_pm2_on_a_mesh(ranks):
    assert all(r["server_pm2"] is None for r in ranks)


def test_mesh_checkpoint_written_by_rank_zero(r0):
    path, positions, count = r0["checkpoint"]
    e, step = ckpt.load(path, device="cpu")
    assert step == 7 and e.particle_count == count
    np.testing.assert_array_equal(e.state.positions(), positions)


def test_engine_rejects_a_mesh_of_another_device():
    with pytest.raises(TypeError, match="DeviceMesh"):
        Engine(particle_count=1024, device="cpu", mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        Engine(particle_count=1024, device="cpu", pm=PMConfig(grid=32),
               pm_persist=True, mesh="dp")
