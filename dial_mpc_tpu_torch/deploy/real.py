"""Real-robot driver for the Unitree Go2 (the reference's ``dial-mpc-real``).

Behavioral parity target: dial_mpc/deploy/dial_real.py:45-382 — LowState
fusion (localization pose/linvel + IMU gyro rotated body->world + 12 motor
encoders), 500 Hz LowCmd publishing with CRC, smooth stand-up via a kp
ramp (+0.005 per tick), torque mode sending tau + kd damping only, and the
same shm action-buffer consumer semantics as the sim server.

The Unitree SDK (unitree_sdk2py / CycloneDDS) is an optional hardware
dependency: this module imports without it and raises a clear error from
``main`` when it is missing; ``DialReal`` refuses to start without it.

The port's counterpart of the JAX package's ``deploy/real.py``. Its state
mirror and viewer step ``mujoco``, so it runs where ``mujoco`` is installed;
``mujoco`` is imported when a host is built, not with this module.

    python -m dial_mpc_tpu_torch.deploy.real --example unitree_go2_trot_deploy
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from threading import Thread
from typing import List, Union

import numpy as np
import yaml

try:  # optional hardware dependency
    from scipy.spatial.transform import Rotation as R
except ImportError:  # pragma: no cover
    R = None

try:  # pragma: no cover - hardware only
    from unitree_sdk2py.core.channel import (
        ChannelFactoryInitialize,
        ChannelPublisher,
        ChannelSubscriber,
    )
    from unitree_sdk2py.idl.default import unitree_go_msg_dds__LowCmd_
    from unitree_sdk2py.idl.unitree_go.msg.dds_ import LowCmd_, LowState_
    from unitree_sdk2py.utils.crc import CRC
    import unitree_sdk2py.comm.motion_switcher_client  # noqa: F401

    _HAVE_UNITREE = True
    _POS_STOP_F = 2.146e9
    _VEL_STOP_F = 16000.0
except ImportError:  # pragma: no cover
    _HAVE_UNITREE = False

from dial_mpc_tpu_torch.config.base_env_config import BaseEnvConfig
from dial_mpc_tpu_torch.core.dial_config import DialConfig
from dial_mpc_tpu_torch.deploy.localization import get_available_plugins, load_plugin
from dial_mpc_tpu_torch.deploy.shm import ShmBus
from dial_mpc_tpu_torch.examples import deploy_examples
from dial_mpc_tpu_torch.utils.io_utils import (
    get_example_path,
    get_model_path,
    load_dataclass_from_dict,
)


@dataclass
class DialRealConfig:
    robot_name: str = "unitree_go2"
    scene_name: str = "mjx_scene_force.xml"
    real_leg_control: str = "torque"
    record: bool = False
    network_interface: str = "eth0"
    real_kp: Union[float, List[float]] = 30.0
    real_kd: Union[float, List[float]] = 0.65
    initial_position_ctrl: List[float] = None
    low_cmd_pub_dt: float = 0.002
    localization_plugin: str = ""
    localization_timeout_sec: float = 0.1


class DialReal:
    def __init__(
        self,
        real_config: DialRealConfig,
        env_config: BaseEnvConfig,
        dial_config: DialConfig,
        plugin_config: dict,
    ):
        if not _HAVE_UNITREE:
            raise RuntimeError(
                "DialReal drives the robot through unitree_sdk2py (CycloneDDS), which is "
                "not installed; install the Unitree SDK to drive hardware"
            )
        import mujoco

        if real_config.real_leg_control not in ("position", "torque"):
            raise ValueError("Invalid leg control mode")
        self.leg_control = real_config.real_leg_control
        self.record = real_config.record
        self.data = []
        self.kp = real_config.real_kp
        self.kd = real_config.real_kd
        self.current_kp = 0.0
        self.ctrl_dt = env_config.dt
        self.n_acts = dial_config.Hsample + 1
        self.t = 0.0
        self.stand_ctrl = np.array(
            real_config.initial_position_ctrl, dtype=np.float32
        )
        self.low_cmd_pub_dt = real_config.low_cmd_pub_dt

        plugin_cls = load_plugin(real_config.localization_plugin)
        if plugin_cls is None:
            raise ValueError(
                f"Failed to load localization plugin "
                f"{real_config.localization_plugin!r}; valid plugins: "
                f"{get_available_plugins()}"
            )
        self.localization_plugin = plugin_cls(plugin_config)
        self.localization_timeout_sec = real_config.localization_timeout_sec

        # mujoco state mirror + viewer
        self.mj_model = mujoco.MjModel.from_xml_path(
            str(get_model_path(real_config.robot_name, real_config.scene_name))
        )
        self.mj_model.opt.timestep = real_config.low_cmd_pub_dt
        self.mj_data = mujoco.MjData(self.mj_model)
        mujoco.mj_resetDataKeyframe(self.mj_model, self.mj_data, 0)
        mujoco.mj_forward(self.mj_model, self.mj_data)
        try:
            from mujoco import viewer as mj_viewer

            self.viewer = mj_viewer.launch_passive(
                self.mj_model, self.mj_data, show_left_ui=False, show_right_ui=True
            )
        except Exception:
            self.viewer = None

        nx = self.mj_model.nq + self.mj_model.nv
        self.bus = ShmBus(nx, self.mj_model.nu, self.n_acts, create=True)
        self.bus.acts[:] = self.mj_model.keyframe("home").ctrl
        self.bus.refs[:] = 1.0
        self.bus.plan_time[0] = -self.ctrl_dt

        # unitree DDS pub/sub (reference: dial_real.py:157-174)
        self.crc = CRC()
        ChannelFactoryInitialize(0, real_config.network_interface)
        self.low_pub = ChannelPublisher("rt/lowcmd", LowCmd_)
        self.low_pub.Init()
        self.low_cmd = unitree_go_msg_dds__LowCmd_()
        self.low_cmd.head[0] = 0xFE
        self.low_cmd.head[1] = 0xEF
        self.low_cmd.level_flag = 0xFF
        self.low_cmd.gpio = 0
        for i in range(20):
            self.low_cmd.motor_cmd[i].mode = 0x01  # PMSM servo mode
            self.low_cmd.motor_cmd[i].q = _POS_STOP_F
            self.low_cmd.motor_cmd[i].kp = 0
            self.low_cmd.motor_cmd[i].dq = _VEL_STOP_F
            self.low_cmd.motor_cmd[i].kd = 0
            self.low_cmd.motor_cmd[i].tau = 0
        self.low_sub = ChannelSubscriber("rt/lowstate", LowState_)
        self.low_sub.Init(self.on_low_state, 1)

        self.vis_thread = Thread(target=self.visualize, daemon=True)
        self.vis_thread.start()

    def visualize(self):
        import mujoco

        while True:
            mujoco.mj_step(self.mj_model, self.mj_data)
            if self.viewer is not None:
                self.viewer.sync()
            time.sleep(0.05)

    # -- state fusion (reference: dial_real.py:186-218) ---------------------

    def on_low_state(self, msg):
        localization_output = self.localization_plugin.get_state()
        if localization_output is None:
            return
        now = time.time()
        localization_time = self.localization_plugin.get_last_update_time()
        if now - localization_time > self.localization_timeout_sec:
            print(f"[WARN] Localization plugin timeout: {now - localization_time} s")
            return

        q = np.zeros(self.mj_model.nq)
        dq = np.zeros(self.mj_model.nv)
        q[:7] = localization_output[:7]
        dq[0:3] = localization_output[7:10]
        # IMU gyro is body-frame; rotate to world
        rot = R.from_quat([q[4], q[5], q[6], q[3]]).as_matrix()
        ang_vel_body = np.array([msg.imu_state.gyroscope]).flatten()
        dq[3:6] = rot @ ang_vel_body
        for i in range(12):
            q[7 + i] = msg.motor_state[i].q
            dq[6 + i] = msg.motor_state[i].dq

        self.bus.state[:] = np.concatenate([q, dq])
        self.mj_data.qpos = q
        self.mj_data.qvel = dq

    # -- 500 Hz command loop (reference: dial_real.py:220-282) --------------

    def main_loop(self):
        while True:
            t0 = time.time()
            if self.bus.plan_time[0] < 0.0:
                self.mj_data.ctrl = self.stand_ctrl
                taus = None
            else:
                delta_time = self.t - self.bus.plan_time[0]
                delta_step = int(delta_time / self.ctrl_dt)
                if delta_step >= self.n_acts or delta_step < 0:
                    delta_step = self.n_acts - 1
                self.mj_data.ctrl = self.bus.acts[delta_step]
                taus = self.bus.tau[delta_step].copy()
                self.t += self.low_cmd_pub_dt
                self.bus.time[0] = self.t

            for i in range(12):
                if self.bus.plan_time[0] < 0.0 or self.leg_control == "position":
                    self.low_cmd.motor_cmd[i].q = float(self.mj_data.ctrl[i])
                    self.low_cmd.motor_cmd[i].kp = (
                        min(self.current_kp, self.kp)
                        if isinstance(self.kp, float)
                        else min(self.current_kp, self.kp[i])
                    )
                    self.low_cmd.motor_cmd[i].dq = 0
                    self.low_cmd.motor_cmd[i].kd = (
                        self.kd if isinstance(self.kd, float) else self.kd[i]
                    )
                    self.low_cmd.motor_cmd[i].tau = 0
                    # ramp kp for a smooth stand-up
                    self.current_kp += 0.005
                else:
                    self.low_cmd.motor_cmd[i].q = 0.0
                    self.low_cmd.motor_cmd[i].kp = 0.0
                    self.low_cmd.motor_cmd[i].dq = 0.0
                    self.low_cmd.motor_cmd[i].kd = (
                        self.kd if isinstance(self.kd, float) else self.kd[i]
                    )
                    self.low_cmd.motor_cmd[i].tau = float(taus[i])
            self.low_cmd.crc = self.crc.Crc(self.low_cmd)
            self.low_pub.Write(self.low_cmd)

            if self.bus.plan_time[0] >= 0.0 and self.record:
                self.data.append(
                    np.concatenate(
                        [
                            [time.time()],
                            self.mj_data.qpos,
                            self.mj_data.qvel,
                            self.mj_data.ctrl,
                        ]
                    )
                )

            duration = time.time() - t0
            if duration < self.low_cmd_pub_dt:
                time.sleep(self.low_cmd_pub_dt - duration)
            else:
                print(f"[WARN] Real loop overruns: {duration * 1000:.1f} ms")

    def close(self):
        self.bus.close()


def main(args=None):
    if not _HAVE_UNITREE:
        raise SystemExit(
            "dial-mpc-real requires unitree_sdk2py (CycloneDDS); install the "
            "Unitree SDK to drive hardware."
        )
    parser = argparse.ArgumentParser()
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--config", type=str, default=None)
    group.add_argument("--example", type=str, default=None)
    group.add_argument("--list-examples", action="store_true")
    parser.add_argument("--network-interface", type=str, default=None)
    parser.add_argument("--plugin", type=str, default=None)
    args = parser.parse_args(args)

    if args.list_examples:
        print("Available examples:")
        for example in deploy_examples:
            print(f"  - {example}")
        return
    if args.example is not None:
        config_path = get_example_path(args.example + ".yaml")
    else:
        config_path = args.config
    with open(config_path) as f:
        config_dict = yaml.safe_load(f)

    real_config = load_dataclass_from_dict(DialRealConfig, config_dict)
    env_config = load_dataclass_from_dict(BaseEnvConfig, config_dict)
    dial_config = load_dataclass_from_dict(DialConfig, config_dict)
    if args.network_interface is not None:
        real_config.network_interface = args.network_interface
    if args.plugin is not None:
        real_config.localization_plugin = args.plugin
    plugin_config = config_dict

    real = DialReal(real_config, env_config, dial_config, plugin_config)
    try:
        real.main_loop()
    except KeyboardInterrupt:
        pass
    finally:
        if real.record and real.data:
            timestamp = time.strftime("%Y%m%d-%H%M%S")
            import os

            output_dir = os.path.join(
                dial_config.output_dir,
                f"real_{dial_config.env_name}_{env_config.task_name}_{timestamp}",
            )
            os.makedirs(output_dir, exist_ok=True)
            np.save(os.path.join(output_dir, "states"), np.array(real.data))
        real.close()


if __name__ == "__main__":
    main()
