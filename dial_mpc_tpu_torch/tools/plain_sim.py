"""A plain-physics actuation side for the deploy planner, where there is no
``mujoco``.

    python -m dial_mpc_tpu_torch.tools.plain_sim --example unitree_go2_trot_deploy --out states.npz \
        --bus-prefix P

It creates the shm bus as ``deploy/sim_server.py`` does, under the segment
names ``--bus-prefix`` gives (the planner attaches with the same prefix; a
run makes one with ``deploy.shm.run_prefix``), and refuses segments that
already exist. It follows the sim server's sync-mode rule
(``DialSim.main_loop``): step while t <= plan_time + ctrl_dt
under the first planned torques (the compiled scenes' actuators are motors),
publishing [qpos, qvel] and the clock after every step, then wait for the
next plan. The physics is this package's
plain PyTorch step (``physics/forward.step`` with the plain solve) on the
CPU in float64 at a batch of one, on the planner env's compiled scene with
``opt.timestep = sim_dt``: no kernel runs here, so the simulated robot does
not depend on the kernels the planner runs. It stops on SIGTERM or SIGINT,
then writes every step's time, qpos,
qvel and ctrl to ``--out`` and unlinks the bus.

It is harness code for the closed loop of ``chip_smoke.py``, not a mode of
the sim server, which steps ``mujoco`` on the deploy scenes.
"""

from __future__ import annotations

import argparse
import signal
import time

import numpy as np
import torch
import yaml

import dial_mpc_tpu_torch.envs as dial_envs
from dial_mpc_tpu_torch.core.dial_config import DialConfig
from dial_mpc_tpu_torch.deploy.shm import ShmBus
from dial_mpc_tpu_torch.deploy.sim_server import DialSimConfig
from dial_mpc_tpu_torch.physics import make_data, put_model, solver, step
from dial_mpc_tpu_torch.utils.io_utils import get_example_path, load_dataclass_from_dict

F64 = torch.float64


def plain_scene(config_dict):
    """(compiled scene, model, dial_config, sim_config, ctrl_dt): the planner
    env's scene, its model float64 on the CPU, stepped at the YAML's sim_dt."""
    dial_config = load_dataclass_from_dict(DialConfig, config_dict)
    sim_config = load_dataclass_from_dict(DialSimConfig, config_dict)
    env_config = load_dataclass_from_dict(
        dial_envs.get_config(dial_config.env_name), config_dict, convert_list_to_array=True
    )
    env = dial_envs.get_environment(dial_config.env_name, env_config, device="cpu", dtype=F64)
    mj = env.make_system(env_config)  # a fresh copy: the env's own model keeps its timestep
    mj.opt.timestep = sim_config.sim_dt
    return mj, put_model(mj, device="cpu", dtype=F64), dial_config, sim_config, env_config.dt


def run(config_dict, out_path, bus_prefix):
    torch.set_num_threads(1)  # batch one: more threads only add overhead
    mj, m, dial_config, sim_config, ctrl_dt = plain_scene(config_dict)
    if sim_config.sim_leg_control != "torque":
        raise ValueError(f"sim_leg_control {sim_config.sim_leg_control!r}: the plain sim applies torques only")
    n_acts = dial_config.Hsample + 1
    d = make_data(m, 1).replace(qpos=torch.tensor(mj.keyframe_qpos("home"), dtype=F64)[None])

    stop = []
    signal.signal(signal.SIGTERM, lambda *_: stop.append(True))
    bus = ShmBus(mj.nq + mj.nv, mj.nu, n_acts, create=True, prefix=bus_prefix, reclaim=False)
    t, rows = 0.0, []
    try:
        bus.time[0] = 0.0
        bus.state[: mj.nq] = d.qpos[0].numpy()
        bus.state[mj.nq :] = d.qvel[0].numpy()
        bus.acts[:] = mj.keyframe_ctrl("home")
        bus.refs[:] = 0.0
        bus.plan_time[0] = -ctrl_dt
        print("PLAIN_SIM_READY", flush=True)
        while not stop:
            while t <= bus.plan_time[0] + ctrl_dt and not stop:
                ctrl = torch.tensor(bus.tau[0], dtype=F64)[None]
                rows.append(np.concatenate([[t], d.qpos[0].numpy(), d.qvel[0].numpy(), ctrl[0].numpy()]))
                d = step(m, d.replace(ctrl=ctrl), solver.solve_reference)
                t += sim_config.sim_dt
                bus.state[: mj.nq] = d.qpos[0].numpy()
                bus.state[mj.nq :] = d.qvel[0].numpy()
                bus.time[0] = t
            time.sleep(sim_config.sim_dt * 0.1)
    except KeyboardInterrupt:
        pass
    finally:
        np.savez(out_path, states=np.array(rows).reshape(len(rows), -1), nq=mj.nq, nv=mj.nv)
        bus.close()
    return len(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--example", type=str, required=True)
    ap.add_argument("--out", type=str, required=True, help=".npz of every step's (t, qpos, qvel, ctrl)")
    ap.add_argument("--bus-prefix", type=str, required=True, help="prefix of the bus's segment names")
    args = ap.parse_args(argv)
    with open(get_example_path(args.example + ".yaml")) as f:
        config_dict = yaml.safe_load(f)
    steps = run(config_dict, args.out, args.bus_prefix)
    print(f"PLAIN_SIM_DONE steps={steps}", flush=True)


if __name__ == "__main__":
    main()
