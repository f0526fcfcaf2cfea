"""Asynchronous actuation host: CPU MuJoCo sim consuming planner output.

Counterpart of the reference's ``dial-mpc-sim`` (dial_mpc/deploy/
dial_sim.py:30-361). The sim runs at sim_dt, publishes [qpos, qvel] and the
clock over the shm bus, and plays back the planner's action *buffer*:

- sync mode: block until the planner has solved from the current time
  (steps while t <= plan_time + ctrl_dt), always executing the first
  action — lock-step operation for slow planners;
- async real-time mode: index into the latest plan by elapsed wall time
  (delta_step = (t - plan_time)/ctrl_dt, clamped to the horizon) so control
  degrades gracefully when the planner overruns its budget.

The viewer (passive MuJoCo GUI + predicted-trajectory capsule overlay) is
optional so the server runs headless; recording dumps the same
states.npy layout as the reference.

The port's counterpart of the JAX package's ``deploy/sim_server.py``. It
steps ``mujoco`` on the CPU, so it runs where ``mujoco`` is installed (the
planner it serves runs on the card); ``mujoco`` is imported when a server is
built, not with this module.

    python -m dial_mpc_tpu_torch.deploy.sim_server --example unitree_go2_trot_deploy
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import yaml

from dial_mpc_tpu_torch.config.base_env_config import BaseEnvConfig
from dial_mpc_tpu_torch.core.dial_config import DialConfig
from dial_mpc_tpu_torch.deploy.shm import ShmBus
from dial_mpc_tpu_torch.examples import deploy_examples
from dial_mpc_tpu_torch.utils.io_utils import (
    get_example_path,
    get_model_path,
    load_dataclass_from_dict,
)


@dataclass
class DialSimConfig:
    robot_name: str = "unitree_go2"
    scene_name: str = "mjx_scene_force.xml"
    sim_leg_control: str = "torque"
    plot: bool = False
    record: bool = False
    real_time_factor: float = 1.0
    sim_dt: float = 0.005
    sync_mode: bool = False
    headless: bool = False  # extension: run without the GUI viewer


class DialSim:
    """The sim server; it creates the bus. ``bus_prefix`` prefixes the bus's
    segment names (``shm.ShmBus``), empty by default as the planner's is."""

    def __init__(
        self,
        sim_config: DialSimConfig,
        env_config: BaseEnvConfig,
        dial_config: DialConfig,
        max_steps: int | None = None,
        bus_prefix: str = "",
    ):
        self.cfg = sim_config
        self.record = sim_config.record
        self.data = []
        self.ctrl_dt = env_config.dt
        self.sim_dt = sim_config.sim_dt
        self.n_acts = dial_config.Hsample + 1
        self.t = 0.0
        self.max_steps = max_steps
        self.leg_control = sim_config.sim_leg_control

        import mujoco

        self.mj_model = mujoco.MjModel.from_xml_path(
            str(get_model_path(sim_config.robot_name, sim_config.scene_name))
        )
        self.mj_model.opt.timestep = self.sim_dt
        self.mj_data = mujoco.MjData(self.mj_model)
        mujoco.mj_resetDataKeyframe(self.mj_model, self.mj_data, 0)
        mujoco.mj_forward(self.mj_model, self.mj_data)

        self.q_history = np.zeros((self.n_acts, self.mj_model.nu))
        self.qref_history = np.zeros((self.n_acts, self.mj_model.nu))
        self._plot = None

        nx = self.mj_model.nq + self.mj_model.nv
        self.bus = ShmBus(nx, self.mj_model.nu, self.n_acts, create=True, prefix=bus_prefix)
        self.bus.time[0] = 0.0
        self.bus.state[: self.mj_model.nq] = self.mj_data.qpos
        self.bus.state[self.mj_model.nq :] = self.mj_data.qvel
        self.bus.acts[:] = self.mj_model.keyframe("home").ctrl
        self.bus.refs[:] = 0.0
        self.bus.plan_time[0] = -self.ctrl_dt

        self.viewer = None
        if not sim_config.headless:
            try:
                from mujoco import viewer as mj_viewer

                self.viewer = mj_viewer.launch_passive(
                    self.mj_model,
                    self.mj_data,
                    show_left_ui=False,
                    show_right_ui=False,
                )
                self._init_ref_overlay()
                self._init_env_overlay(dial_config, env_config)
            except Exception as e:  # headless environment
                print(f"[WARN] viewer unavailable ({e}); running headless")

    # -- env-specific static overlay (e.g. seq-jump contact targets) --------

    def _init_env_overlay(self, dial_config, env_config):
        """Call the env's ``update_viewer`` hook, if it defines one.

        The reference declares the same hook (contact-target cylinders,
        reference unitree_go2_env.py:633-646) but never calls it from any
        process. Here the actuation host invokes it once at viewer setup so
        sim2sim seq-jump shows the staged jump targets.

        The env is built on the CPU: the sim process must never take the
        card the planner process owns (and the overlay math is a handful of
        floats).
        """
        try:
            import dial_mpc_tpu_torch.envs as dial_envs

            try:
                env_cls = dial_envs.get_env_class(dial_config.env_name)
            except ValueError:
                return
            if getattr(env_cls, "update_viewer", None) is None:
                return
            env = env_cls(env_config, device="cpu")
            env.update_viewer(self.viewer)
        except Exception as e:
            print(f"[WARN] env viewer overlay unavailable ({e})")

    # -- predicted-trajectory overlay (reference: dial_sim.py:156-198) ------

    def _init_ref_overlay(self):
        import mujoco

        scn = self.viewer.user_scn
        cnt = 0
        for i in range(self.n_acts - 1):
            for j in range(self.mj_model.nu):
                color = np.array(
                    [i / (self.n_acts - 1), j / self.mj_model.nu, 0.0, 1.0]
                )
                mujoco.mjv_initGeom(
                    scn.geoms[cnt],
                    type=mujoco.mjtGeom.mjGEOM_CAPSULE,
                    size=np.zeros(3),
                    rgba=color,
                    pos=self.bus.refs[i, j, :],
                    mat=np.eye(3).flatten(),
                )
                cnt += 1
        scn.ngeom = cnt

    def _update_ref_overlay(self):
        if self.viewer is None:
            return
        import mujoco

        for i in range(self.n_acts - 1):
            for j in range(self.mj_model.nu):
                mujoco.mjv_connector(
                    self.viewer.user_scn.geoms[i * self.mj_model.nu + j],
                    mujoco.mjtGeom.mjGEOM_CAPSULE,
                    0.02,
                    self.bus.refs[i, j, :],
                    self.bus.refs[i + 1, j, :],
                )

    # -- stepping -----------------------------------------------------------

    def _apply_ctrl(self, idx: int):
        if self.leg_control == "position":
            self.mj_data.ctrl[:] = self.bus.acts[idx]
        else:
            self.mj_data.ctrl[:] = self.bus.tau[idx]

    def _step_and_publish(self):
        import mujoco

        if self.record:
            self.data.append(
                np.concatenate(
                    [[self.t], self.mj_data.qpos, self.mj_data.qvel, self.mj_data.ctrl]
                )
            )
        mujoco.mj_step(self.mj_model, self.mj_data)
        self.t += self.sim_dt
        self.bus.state[: self.mj_model.nq] = self.mj_data.qpos
        self.bus.state[self.mj_model.nq :] = self.mj_data.qvel
        self.bus.time[0] = self.t

    def _init_plot(self):
        # live joint-tracking plots (reference: dial_sim.py:126-154)
        try:
            import matplotlib.pyplot as plt
        except ImportError:
            print("[WARN] matplotlib unavailable; plotting disabled")
            return
        n = min(4, self.mj_model.nu)
        fig, axs = plt.subplots(n, 1, figsize=(10, 2 * n))
        axs = np.atleast_1d(axs)
        colors = plt.cm.rainbow(np.linspace(0, 1, n))
        handles, handles_ref = [], []
        q0 = self.mj_model.keyframe("home").qpos
        for i in range(n):
            handles.append(axs[i].plot(self.q_history[:, i], color=colors[i])[0])
            handles_ref.append(
                axs[i].plot(self.qref_history[:, i], color=colors[i], linestyle="--")[0]
            )
            axs[i].set_ylim(-1.0 + q0[i + 7], 1.0 + q0[i + 7])
            axs[i].set_ylabel(f"joint {i + 1}")
        plt.show(block=False)
        self._plot = (plt, handles, handles_ref, n)

    def _update_plot(self):
        if self._plot is None:
            return
        plt, handles, handles_ref, n = self._plot
        for j in range(n):
            handles[j].set_ydata(self.bus.acts[:, j])
            handles_ref[j].set_ydata(self.qref_history[:, j])
        plt.pause(0.001)

    def _record_history(self):
        self.q_history = np.roll(self.q_history, -1, axis=0)
        self.q_history[-1, :] = self.mj_data.qpos[7 : 7 + self.mj_model.nu]
        self.qref_history = np.roll(self.qref_history, -1, axis=0)
        self.qref_history[-1, :] = self.mj_data.ctrl

    def main_loop(self):
        if self.cfg.plot:
            self._init_plot()
        steps = 0
        while self.max_steps is None or steps < self.max_steps:
            self._update_ref_overlay()
            self._update_plot()
            if self.cfg.sync_mode:
                # lock-step: advance only through the window the planner has
                # already planned from (reference: dial_sim.py:199-228)
                while self.t <= self.bus.plan_time[0] + self.ctrl_dt:
                    self._apply_ctrl(0)
                    self._step_and_publish()
                    steps += 1
                    if self.max_steps is not None and steps >= self.max_steps:
                        return
                self._record_history()
                if self.viewer is not None:
                    self.viewer.sync()
                time.sleep(self.sim_dt * 0.1)
            else:
                t0 = time.time()
                if self.bus.plan_time[0] < 0.0:
                    time.sleep(0.01)
                    continue
                delta_time = self.t - self.bus.plan_time[0]
                delta_step = int(delta_time / self.ctrl_dt)
                if delta_time > self.ctrl_dt / self.cfg.real_time_factor:
                    print(f"[WARN] Delayed by {delta_time * 1000.0:.1f} ms")
                if delta_step >= self.n_acts or delta_step < 0:
                    delta_step = self.n_acts - 1
                self._apply_ctrl(delta_step)
                self._step_and_publish()
                self._record_history()
                steps += 1
                if self.viewer is not None:
                    self.viewer.sync()
                duration = time.time() - t0
                budget = self.sim_dt / self.cfg.real_time_factor
                if duration < budget:
                    time.sleep(budget - duration)
                else:
                    print("[WARN] Sim loop overruns")

    def close(self):
        self.bus.close()


def main(args=None):
    parser = argparse.ArgumentParser()
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--config", type=str, default=None)
    group.add_argument("--example", type=str, default=None)
    group.add_argument("--list-examples", action="store_true")
    parser.add_argument("--custom-env", type=str, default=None)
    args = parser.parse_args(args)

    if args.custom_env is not None:
        sys.path.append(os.getcwd())
        importlib.import_module(args.custom_env)
    if args.list_examples:
        print("Available examples:")
        for example in deploy_examples:
            print(f"  - {example}")
        return
    if args.example is not None:
        if args.example not in deploy_examples:
            print(f"Example {args.example} not found.")
            return
        config_path = get_example_path(args.example + ".yaml")
    else:
        config_path = args.config
    with open(config_path) as f:
        config_dict = yaml.safe_load(f)

    sim_config = load_dataclass_from_dict(DialSimConfig, config_dict)
    env_config = load_dataclass_from_dict(BaseEnvConfig, config_dict)
    dial_config = load_dataclass_from_dict(DialConfig, config_dict)
    sim = DialSim(sim_config, env_config, dial_config)
    try:
        sim.main_loop()
    except KeyboardInterrupt:
        pass
    finally:
        if sim.record and sim.data:
            timestamp = time.strftime("%Y%m%d-%H%M%S")
            output_dir = os.path.join(
                dial_config.output_dir,
                f"sim_{dial_config.env_name}_{env_config.task_name}_{timestamp}",
            )
            os.makedirs(output_dir, exist_ok=True)
            np.save(os.path.join(output_dir, "states"), np.array(sim.data))
        sim.close()


if __name__ == "__main__":
    main()
