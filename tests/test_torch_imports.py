"""The PyTorch port stands on its own: it imports neither ``jax`` nor the
JAX package, and its entry points run on the card or raise.

Run with:  python -m pytest tests/test_torch_*.py -q
"""

import ast
import glob
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dial_mpc_tpu_torch")
SOURCES = sorted(glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True)) + [
    os.path.join(ROOT, "chip_smoke.py")
]
FORBIDDEN = ("jax", "jaxlib", "flax", "dial_mpc_tpu")


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_sources_found():
    names = {os.path.relpath(p, ROOT) for p in SOURCES}
    for expected in ("chip_smoke.py", "dial_mpc_tpu_torch/core/runner.py",
                     "dial_mpc_tpu_torch/physics/engine_cuda.py", "dial_mpc_tpu_torch/envs/unitree_go2_env.py",
                     "dial_mpc_tpu_torch/physics/solver_cuda.py", "dial_mpc_tpu_torch/physics/cuda_build.py",
                     "dial_mpc_tpu_torch/tools/solver_cases.py", "dial_mpc_tpu_torch/tools/deploy_bench.py",
                     "dial_mpc_tpu_torch/tools/plain_sim.py"):
        assert expected in names
    deploy = ("shm", "planner_proc", "sim_server", "sim2sim", "sim2real", "real", "localization/__init__",
              "localization/base_plugin", "localization/vicon_shm_plugin", "localization/ros2_odometry_plugin")
    for module in deploy:
        assert f"dial_mpc_tpu_torch/deploy/{module}.py" in names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"
        assert not (top == "triton"), f"{path} imports triton at module level"


def test_no_torch_compile():
    for path in SOURCES:
        with open(path) as f:
            assert "torch.compile" not in f.read(), path


# The localization plugins import their hardware SDKs when they are loaded
# (deploy/localization/__init__.py loads a plugin by importing its module), so
# where an SDK is missing their import may fail, and only for that SDK.
HARDWARE_SDKS = {
    "dial_mpc_tpu_torch.deploy.localization.ros2_odometry_plugin": ("rclpy", "nav_msgs"),
    "dial_mpc_tpu_torch.deploy.localization.vicon_shm_plugin": ("pyvicon_datastream",),
}


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys, pkgutil, importlib, dial_mpc_tpu_torch\n"
        f"sdks = {HARDWARE_SDKS!r}\n"
        "for m in pkgutil.walk_packages(dial_mpc_tpu_torch.__path__, 'dial_mpc_tpu_torch.'):\n"
        "    try:\n"
        "        importlib.import_module(m.name)\n"
        "    except ModuleNotFoundError as e:\n"
        "        assert e.name.split('.')[0] in sdks.get(m.name, ()), (m.name, e.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dial_mpc_tpu', 'mujoco', 'triton')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr[-2000:]


def test_planner_process_and_bus_import_no_mujoco():
    """The planner runs on the GPU machine, which has no mujoco: neither the
    planner process nor the bus may import it (the sim server and the
    real-robot host import it when they are built)."""
    code = (
        "import sys\n"
        "import dial_mpc_tpu_torch.deploy.planner_proc, dial_mpc_tpu_torch.deploy.shm\n"
        "import dial_mpc_tpu_torch.deploy.sim_server, dial_mpc_tpu_torch.deploy.real\n"
        "import dial_mpc_tpu_torch.tools.deploy_bench, dial_mpc_tpu_torch.tools.plain_sim\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('mujoco', 'jax', 'dial_mpc_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr[-2000:]


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def _small_config(tmp_path):
    from dial_mpc_tpu_torch.utils.io_utils import get_example_path

    with open(get_example_path("unitree_go2_trot.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(Nsample=4, n_steps=2, Ndiffuse=1, Ndiffuse_init=1, output_dir=str(tmp_path / "out"))
    return cfg


def test_entry_points_default_to_the_card_and_raise_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    import dial_mpc_tpu_torch.envs as envs
    from dial_mpc_tpu_torch.core import runner
    from dial_mpc_tpu_torch.physics import engine_cuda, solver_cuda

    cfg = _small_config(tmp_path)
    before = engine_cuda.step_core.launches
    with pytest.raises(RuntimeError, match="cuda"):
        runner.run(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        runner.run(cfg, engine="unfused")
    with pytest.raises(RuntimeError, match="cuda"):
        envs.get_environment("unitree_go2_seq_jump")
    assert solver_cuda.solve_batched.launches == 0
    with pytest.raises(RuntimeError, match="cuda"):
        runner.run(cfg)  # the default device is the card
    with pytest.raises(RuntimeError, match="cuda"):
        envs.get_environment("unitree_go2_walk")
    assert not os.path.exists(cfg["output_dir"]) and engine_cuda.step_core.launches == before


def test_runner_on_cpu_writes_the_two_artifacts(tmp_path, capsys):
    from dial_mpc_tpu_torch.core import runner

    cfg = _small_config(tmp_path)
    summary = runner.run(cfg, progress=False, device="cpu", dtype=torch.float64)
    states = np.load(summary["states_path"])
    preds = np.load(summary["predictions_path"])
    assert states.shape == (2, 1 + 19 + 18 + 12) and preds.shape == (2, 17, 13, 3)
    assert states[:, 0].tolist() == [0.0, 1.0] and np.isfinite(states).all() and np.isfinite(preds).all()
    assert len(summary["rews"]) == 2 and summary["latency"]["n"] == 1
    # the two artifacts, and the HTML viewer where mujoco is installed (it says which)
    viewer = importlib.util.find_spec("mujoco") is not None
    kinds = ("states_path", "predictions_path", "html_path")[: 2 + viewer]
    assert sorted(os.listdir(cfg["output_dir"])) == sorted(os.path.basename(summary[k]) for k in kinds)
    out = capsys.readouterr().out
    assert ("visualization written to" in out) if viewer else ("the HTML viewer needs the mujoco package" in out)


def test_runner_cli(capsys):
    from dial_mpc_tpu_torch.core import runner

    runner.main(["--list-examples"])
    out = capsys.readouterr().out
    assert "unitree_go2_trot" in out and "unitree_go2_seq_jump" in out
    with pytest.raises(SystemExit):
        runner.main([])
    with pytest.raises(SystemExit):
        runner.main(["--example", "unitree_go2_trot", "--engine", "xla"])


@pytest.mark.parametrize("example,engine", [("unitree_go2_trot", "unfused"), ("unitree_go2_seq_jump", "fused")])
def test_runner_cli_runs_an_example_on_the_cpu(tmp_path, monkeypatch, capsys, example, engine):
    """The CLI passes --engine and --device through; the example's YAML is
    read in place, cut down through a copy."""
    from dial_mpc_tpu_torch.core import runner
    from dial_mpc_tpu_torch.utils.io_utils import get_example_path

    with open(get_example_path(example + ".yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(Nsample=4, n_steps=2, Ndiffuse=1, Ndiffuse_init=1, output_dir=str(tmp_path / "out"))
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    seen = {}
    real = runner.dial_envs.get_environment
    monkeypatch.setattr(runner.dial_envs, "get_environment",
                        lambda *a, **kw: seen.update(kw) or real(*a, **kw))
    runner.main(["--config", str(path), "--device", "cpu", "--engine", engine])
    assert seen["engine"] == engine and str(seen["device"]) == "cpu"
    # the states and the predictions, and the HTML viewer where mujoco is installed
    written = os.listdir(cfg["output_dir"])
    viewer = importlib.util.find_spec("mujoco") is not None
    assert "mean reward" in capsys.readouterr().out and sum(n.endswith(".npy") for n in written) == 2
    assert len(written) == 2 + viewer


def test_registry():
    import dial_mpc_tpu_torch.envs as envs
    from dial_mpc_tpu_torch.envs.unitree_go2_env import (
        UnitreeGo2Env, UnitreeGo2EnvConfig, UnitreeGo2SeqJumpEnv, UnitreeGo2SeqJumpEnvConfig,
    )

    assert envs.get_env_class("unitree_go2_walk") is UnitreeGo2Env
    assert envs.get_config("unitree_go2_walk") is UnitreeGo2EnvConfig
    assert envs.get_env_class("unitree_go2_seq_jump") is UnitreeGo2SeqJumpEnv
    assert envs.get_config("unitree_go2_seq_jump") is UnitreeGo2SeqJumpEnvConfig
    with pytest.raises(ValueError, match="engine"):
        envs.get_environment("unitree_go2_walk", device="cpu", engine="xla")
    assert envs.get_environment("unitree_go2_walk", device="cpu", engine="unfused").engine == "unfused"
    from dial_mpc_tpu_torch.envs.unitree_go2_env import UnitreeGo2CrateEnv
    from dial_mpc_tpu_torch.envs.unitree_h1_env import (
        UnitreeH1LocoEnv, UnitreeH1PushCrateEnv, UnitreeH1WalkEnv,
    )

    assert envs.get_env_class("unitree_go2_crate_climb") is UnitreeGo2CrateEnv
    assert envs.get_env_class("unitree_h1_walk") is UnitreeH1WalkEnv
    assert envs.get_env_class("unitree_h1_loco") is UnitreeH1LocoEnv
    assert envs.get_env_class("unitree_h1_push_crate") is UnitreeH1PushCrateEnv
    from dial_mpc_tpu_torch.envs.manipulation import AllegroReorientEnv, AllegroReorientEnvConfig

    assert envs.get_env_class("allegro_reorient") is AllegroReorientEnv
    assert envs.get_config("allegro_reorient") is AllegroReorientEnvConfig
    with pytest.raises(ValueError):  # every task of the JAX package is registered; an unknown name raises
        envs.get_env_class("no_such_task")
    envs.register_env("alias_for_test", UnitreeGo2Env, UnitreeGo2EnvConfig)
    assert isinstance(envs.get_environment("alias_for_test", device="cpu"), UnitreeGo2Env)
