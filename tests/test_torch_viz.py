"""The port's HTML trajectory viewer, the env's render API, the runner's
viewer artifact and ``--serve``, and the glue profiler, on the CPU.

Counterparts of tests/test_viz.py's four tests, and the port's payload
against the JAX package's ``render_trajectory`` on the same model and
trajectory. ``mujoco`` is installed here; the runner's behaviour without it
(the GPU machine has none) is shown by hiding it from ``sys.modules``.

Run with:  python -m pytest tests/test_torch_viz.py -q
"""

import json
import os
import re
import sys
import threading
import urllib.request

import mujoco
import numpy as np
import pytest
import torch
import yaml

import dial_mpc_tpu_torch.envs as torch_envs
from dial_mpc_tpu_torch.core import runner
from dial_mpc_tpu_torch.envs.base_env import expand_state
from dial_mpc_tpu_torch.utils.io_utils import get_example_path, get_model_path
from dial_mpc_tpu_torch.viz.html_viewer import _decimate, _geoms, _mesh_library, render_trajectory

F64 = torch.float64


@pytest.fixture(autouse=True)
def one_thread():
    """The CPU physics at these batches is launch-bound: one thread is faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _go2_model():
    return mujoco.MjModel.from_xml_path(str(get_model_path("unitree_go2", "mjx_scene_force.xml")))


def _extract_payload(path):
    with open(path) as f:
        html = f.read()
    m = re.search(r"const DATA = (\{.*?\});\nconst cv", html, re.S)
    assert m, "payload not found in viewer HTML"
    return json.loads(m.group(1))


def _env(name="unitree_go2_walk", dtype=F64):
    return torch_envs.get_environment(name, torch_envs.get_config(name)(), device="cpu", dtype=dtype)


def test_viewer_embeds_real_meshes(tmp_path):
    mj = _go2_model()
    traj = np.tile(mj.key_qpos[0], (5, 1))
    out = render_trajectory(mj, traj, str(tmp_path / "v.html"))
    data = _extract_payload(out)

    mesh_geoms = [g for g in data["geoms"] if g["type"] == "mesh"]
    assert len(mesh_geoms) >= 30  # Go2 visual model is mesh-based
    for g in mesh_geoms:
        flat = data["meshlib"][str(g["mid"])]
        assert len(flat) % 18 == 0 and len(flat) >= 18 * 50  # real triangles
    assert len(data["frames"]) == 5
    assert all(len(f) == len(data["geoms"]) for f in data["frames"])


def test_decimation_preserves_shape_and_bounds():
    mj = _go2_model()
    mid = 0
    va, vn = int(mj.mesh_vertadr[mid]), int(mj.mesh_vertnum[mid])
    fa, fn = int(mj.mesh_faceadr[mid]), int(mj.mesh_facenum[mid])
    verts = mj.mesh_vert[va : va + vn].astype(np.float64)
    faces = mj.mesh_face[fa : fa + fn].astype(np.int64)
    dv, df = _decimate(verts, faces, 1500)
    assert len(df) <= 1500
    assert len(df) > 200  # did not collapse to nothing
    # clustered vertices stay inside the original bounding box
    assert (dv.min(0) >= verts.min(0) - 1e-9).all()
    assert (dv.max(0) <= verts.max(0) + 1e-9).all()
    # no degenerate faces
    assert ((df[:, 0] != df[:, 1]) & (df[:, 1] != df[:, 2]) & (df[:, 0] != df[:, 2])).all()


def test_env_render_html(tmp_path):
    env = _env()
    # raw qpos rows are accepted alongside States and Datas
    traj = [env.mj_model.key_qpos[0] for _ in range(3)]
    out = env.render_html(traj, str(tmp_path / "env.html"))
    data = _extract_payload(out)
    assert len(data["frames"]) == 3 and data["fps"] == 1.0 / env.dt
    assert any(g["type"] == "mesh" for g in data["geoms"])


def test_mesh_library_shared_across_geoms():
    mj = _go2_model()
    geoms = _geoms(mj)
    mids = [g["mid"] for g in geoms if g["type"] == "mesh"]
    # legs reuse the same meshes: library must be keyed by mesh id, not geom
    assert len(set(mids)) < len(mids)
    lib = _mesh_library(mj, set(mids))
    assert set(lib.keys()) == {str(m) for m in set(mids)}


@pytest.mark.parametrize("env_name", ["unitree_go2_walk", "unitree_h1_walk", "allegro_reorient"])
def test_payload_equals_the_jax_viewers(tmp_path, env_name):
    """The same model and trajectory give the JAX package's payload, byte for
    byte: the env's render_html (viewer model compiled from the env's scene,
    States in) against the JAX env's on the same qpos rows."""
    import dial_mpc_tpu.envs as jax_envs

    env = _env(env_name)
    jenv = jax_envs.get_environment(env_name, jax_envs.get_config(env_name)())
    rng = np.random.default_rng(0)
    st = env.reset()
    traj = []
    for _ in range(4):
        q = st.pipeline_state.qpos.clone()
        q[0, 7:] += torch.tensor(rng.uniform(-0.2, 0.2, q.shape[1] - 7))
        traj.append(st.replace(pipeline_state=st.pipeline_state.replace(qpos=q)))
    got = env.render_html(traj, str(tmp_path / "port.html"), decimate=2)
    want = jenv.render_html([t.pipeline_state.qpos[0].numpy() for t in traj], str(tmp_path / "jax.html"), decimate=2)
    a, b = _extract_payload(got), _extract_payload(want)
    assert a == b and len(a["frames"]) == 2
    with open(got) as f1, open(want) as f2:
        assert f1.read() == f2.read()


def test_env_render_html_refuses_a_batch(tmp_path):
    env = _env()
    big = expand_state(env.reset(), 2)
    with pytest.raises(ValueError, match="one state"):
        env.render_html([big], str(tmp_path / "x.html"))


def test_viewer_model_is_the_envs_scene():
    """The viewer's model is the env's MJCF compiled by MuJoCo (meshes and
    colours in), at the env's timestep; a model not loaded from a shipped
    scene has no MJCF to compile."""
    env = _env("unitree_h1_loco")
    model = env.viewer_model()
    assert env.mj_model.source == ("unitree_h1", "mjx_scene_h1_loco.xml")
    assert (model.nq, model.nbody, model.ngeom) == (env.mj_model.nq, env.mj_model.nbody, env.mj_model.ngeom)
    assert model.opt.timestep == env.mj_model.opt.timestep and model.nmesh > 0
    env.mj_model.source = None
    with pytest.raises(ValueError, match="shipped scene"):
        env.viewer_model()


def test_env_render_feeds_each_state_to_the_renderer(monkeypatch):
    """``render`` rasterizes through ``mujoco.Renderer`` (no GL here: a stand-in
    records what it was given); each State's qpos and qvel reach the MjData,
    and mj_forward has run on them."""
    seen = []

    class Renderer:
        def __init__(self, model, height, width):
            self.shape = (height, width, 3)

        def update_scene(self, data, camera=None):
            seen.append((data.qpos.copy(), data.qvel.copy(), data.xpos.copy(), camera))

        def render(self):
            return np.zeros(self.shape, np.uint8)

        def close(self):
            seen.append("closed")

    monkeypatch.setattr(mujoco, "Renderer", Renderer)
    env = _env()
    st = env.reset()
    rng = np.random.default_rng(1)
    q = st.pipeline_state.qpos + torch.tensor(np.r_[np.zeros(7), rng.uniform(-0.3, 0.3, 12)])
    other = env.pipeline_init(q, torch.tensor(rng.uniform(-1, 1, (1, 18))))
    frames = env.render([st, other], camera="track", width=8, height=6)
    assert len(frames) == 2 and frames[0].shape == (6, 8, 3) and seen[-1] == "closed"
    for (qpos, qvel, xpos, camera), s in zip(seen, (st.pipeline_state, other)):
        np.testing.assert_array_equal(qpos, s.qpos[0].numpy())
        np.testing.assert_array_equal(qvel, s.qvel[0].numpy())
        np.testing.assert_allclose(xpos[1:], s.x_pos[0].numpy(), atol=1e-9)  # forward ran
        assert camera == "track"


# ---------------------------------------------------------------------------
# the runner's artifacts
# ---------------------------------------------------------------------------

def _tiny_run(tmp_path, **kw):
    with open(get_example_path("unitree_go2_trot.yaml")) as f:
        cfgd = yaml.safe_load(f)
    cfgd.update(Nsample=4, n_steps=2, Ndiffuse=1, Ndiffuse_init=1, output_dir=str(tmp_path / "out"))
    return runner.run(cfgd, progress=False, device="cpu", dtype=F64, **kw)


def test_runner_writes_the_viewer(tmp_path, capsys):
    summary = _tiny_run(tmp_path)
    assert summary["planner"] == "MBDPI"
    assert sorted(os.listdir(tmp_path / "out")) == sorted(
        os.path.basename(p) for p in (summary["states_path"], summary["predictions_path"], summary["html_path"])
    )
    data = _extract_payload(summary["html_path"])
    assert len(data["frames"]) == 2 and data["fps"] == 50.0
    states = np.load(summary["states_path"])
    np.testing.assert_allclose(np.array(data["frames"])[0, 0, :3], _first_geom_pos(states[0, 1:20]), atol=1e-4)
    assert "visualization written to" in capsys.readouterr().out


def _first_geom_pos(qpos):
    """The first drawn geom's position at qpos, by MuJoCo's kinematics."""
    mj = _go2_model()
    d = mujoco.MjData(mj)
    d.qpos[:] = qpos
    mujoco.mj_kinematics(mj, d)
    return d.geom_xpos[_geoms(mj)[0]["id"]]


def test_runner_without_mujoco_writes_the_states_and_says_so(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "mujoco", None)  # import mujoco now fails
    summary = _tiny_run(tmp_path)
    written = sorted(os.listdir(tmp_path / "out"))
    assert len(written) == 2 and all(n.endswith(".npy") for n in written) and summary["html_path"] is None
    out = capsys.readouterr().out
    assert "the HTML viewer needs the mujoco package" in out and summary["states_path"] in out


@pytest.mark.parametrize("error", [ValueError("bad qpos"), ModuleNotFoundError("no module", name="scipy")])
def test_runner_raises_any_other_viewer_error(tmp_path, error):
    class Env:
        def render_html(self, qpos, path, fps):
            raise error

    with pytest.raises(type(error)):
        runner.write_viewer(Env(), np.zeros((2, 19)), str(tmp_path), "t", "states.npy")
    assert not os.listdir(tmp_path)


def test_runner_serve_answers_with_the_viewer(tmp_path, monkeypatch):
    """--serve: the run hands its HTML to serve_html; the handler answers a
    GET with the file."""
    served = []
    monkeypatch.setattr(runner, "serve_html", lambda path: served.append(path))
    summary = _tiny_run(tmp_path, serve=True)
    assert served == [summary["html_path"]]

    import http.server

    server = http.server.HTTPServer(("127.0.0.1", 0), runner.html_handler(summary["html_path"]))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{server.server_port}/", timeout=30) as r:
            body = r.read()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    with open(summary["html_path"], "rb") as f:
        assert body == f.read()


# ---------------------------------------------------------------------------
# the glue profiler
# ---------------------------------------------------------------------------

def test_glue_profile_on_the_cpu(capsys):
    from dial_mpc_tpu_torch.tools import glue_profile

    glue_profile.main(["--device", "cpu", "--nsample", "2", "--trials", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["Nsample"] == 2 and out["device_name"] is None
    for key in ("control_step_ms", "rollouts_ms", "reverse_once_ms"):
        assert out[key]["host"] > 0 and out[key]["device"] is None  # no device time on the CPU
    assert out["glue_per_level_host_ms"] == out["reverse_once_ms"]["host"] - out["rollouts_ms"]["host"]
    if not torch.cuda.is_available():  # it runs on the card by default, or raises
        with pytest.raises(RuntimeError, match="cuda"):
            glue_profile.main([])
