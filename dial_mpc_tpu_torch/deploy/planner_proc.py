"""Asynchronous planner process.

    python -m dial_mpc_tpu_torch.deploy.planner_proc --example unitree_go2_trot_deploy [--device cpu]
    torchrun --nproc-per-node N -m dial_mpc_tpu_torch.deploy.planner_proc --example ...  (sharding: mesh)

Counterpart of the JAX package's ``deploy/planner_proc.py`` (reference:
dial_mpc/deploy/dial_plan.py:45-294): attach to the shm bus, inject the
measured [q, qd] into the planner state, warm-start the plan by the
*wall-clock* elapsed time via spline resampling (not integer steps), run
Ndiffuse annealing levels, and publish the action buffer (joint targets and
torques) with the predicted body positions and the plan timestamp.

A tick only enqueues device work (the spline shift, the annealing levels
with their rollouts on the step kernel, the control extraction) and then
makes ONE device-to-host copy of a packed float32 tensor holding everything
the bus needs; the plan and the noise generator stay on the device between
ticks. The planner runs on the card unless the caller asks for the CPU.

With ``sharding: mesh`` under ``torchrun`` (a process group of more than one
rank), the levels run on ``ShardedMBDPI`` over the ranks. Rank 0 alone
attaches the bus: each tick it broadcasts the measured state, the bus time
and whether to stop, every rank injects the state and plans, and rank 0
publishes the plan and writes the checkpoint.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time

import numpy as np
import torch
import yaml

import dial_mpc_tpu_torch.envs as dial_envs
from dial_mpc_tpu_torch.config.base_env_config import BaseEnvConfig
from dial_mpc_tpu_torch.core.dial_config import DialConfig
from dial_mpc_tpu_torch.core.dial_core import MBDPI
from dial_mpc_tpu_torch.deploy.shm import ShmBus
from dial_mpc_tpu_torch.envs.base_env import require_device
from dial_mpc_tpu_torch.examples import deploy_examples
from dial_mpc_tpu_torch.parallel import ShardedMBDPI, distributed, global_sample_mesh
from dial_mpc_tpu_torch.utils.io_utils import get_example_path, load_dataclass_from_dict
from dial_mpc_tpu_torch.utils.spline import FixedSpline
from dial_mpc_tpu_torch.utils.telemetry import LatencyRecorder


class MBDPublisher:
    """The asynchronous planner on a shm bus that the actuation side created.

    The device and dtype are the env's. Noise comes from a
    ``torch.Generator`` on that device seeded from ``dial_config.seed``.
    ``checkpoint_path`` names an ``.npz`` that holds the plan ``Y`` and the
    generator's state; it is written every 250 ticks and on exit, and read
    back at start. Such a checkpoint resumes a run of this package only: the
    JAX package's checkpoints hold a JAX key instead of a generator state
    and are not read.

    ``sharding``: ``"none"`` plans on the env's device; ``"mesh"`` splits the
    sample axis over the ranks of the process group (``ShardedMBDPI``) where
    it has more than one, and plans as ``"none"`` otherwise. In a group, rank
    0 alone attaches the bus (``bus`` is None on the others); every rank
    reads a checkpoint, rank 0 alone writes it.

    ``bus_prefix`` is the prefix of the bus's segment names (``shm.ShmBus``);
    the default, empty, is the names every sim server and robot host uses.
    """

    def __init__(
        self,
        env,
        env_config: BaseEnvConfig,
        dial_config: DialConfig,
        checkpoint_path: str | None = None,
        sharding: str = "none",
        bus_prefix: str = "",
    ):
        self.dial_config = dial_config
        self.env = env
        self.env_config = env_config
        self.checkpoint_path = checkpoint_path
        self.device, self.dtype = env.device, env.dtype

        self.generator = torch.Generator(device=self.device).manual_seed(dial_config.seed)
        # the group that shares each tick; None plans alone
        self.mesh = global_sample_mesh() if sharding == "mesh" and distributed.world_size() > 1 else None
        if self.mesh is None:
            self.mbdpi = MBDPI(dial_config, env, self.generator)
        else:
            self.mbdpi = ShardedMBDPI(dial_config, env, self.mesh, self.generator)
        self.lead = self.mesh is None or self.mesh.rank == 0
        # wall-clock warm-start resampler over the node grid
        # (reference: dial_plan.py:136-139)
        self.node_shift = FixedSpline(
            self.mbdpi.step_nodes, self.mbdpi.step_nodes, device=self.device, dtype=self.dtype
        )

        self.Y = torch.zeros(dial_config.Hnode + 1, self.mbdpi.nu, device=self.device, dtype=self.dtype)
        self.ctrl_dt = env_config.dt
        self.n_acts = dial_config.Hsample + 1
        mj = env.mj_model
        self.nq, self.nv, self.nu = mj.nq, mj.nv, mj.nu
        self.default_q = mj.keyframe_qpos("home")
        self.default_u = mj.keyframe_ctrl("home")

        # viz-ref body count for the packed per-tick transfer: xbar covers
        # nbody-1 bodies (world excluded); the refs segment wants nu rows
        # starting after the trunk
        self._nb = min(mj.nu, mj.nbody - 2)

        self.bus = None
        if self.lead:
            self.bus = ShmBus(self.nq + self.nv, self.nu, self.n_acts, create=False, prefix=bus_prefix)
            self.bus.acts[:] = self.default_u
            self.bus.refs[:] = 1.0
            self.bus.plan_time[0] = -self.ctrl_dt
            self.bus.state[: self.nq] = self.default_q

        if checkpoint_path and os.path.exists(checkpoint_path):
            try:
                with np.load(checkpoint_path) as z:
                    Y, generator_state = z["Y"], z["generator"]
                if Y.shape == tuple(self.Y.shape):
                    self.generator.set_state(torch.from_numpy(generator_state))
                    self.Y = torch.tensor(Y, device=self.device, dtype=self.dtype)
                    print(f"resumed planner state from {checkpoint_path}")
            except (OSError, KeyError, ValueError, RuntimeError) as e:
                print(f"[WARN] checkpoint restore failed: {e}")

    def save_checkpoint(self):
        if self.checkpoint_path and self.lead:
            np.savez(
                self.checkpoint_path,
                Y=self.Y.cpu().numpy(),
                generator=self.generator.get_state().numpy(),
            )

    # -- one tick's solve ------------------------------------------------------

    def _plan(self, state, Y, shift_time, n_diffuse, eps=None):
        """Shift, anneal and extract the controls; returns (Y', packed).

        Everything the bus needs is packed into ONE flat float32 tensor on
        the device, so that a tick makes one device-to-host copy (each copy
        waits for the device and crosses PCIe); the host unpacks it by the
        static layout (n_acts*nu | n_acts*nu | n_acts*nb*3). ``eps``
        optionally gives every level's standard-normal draw, (n_diffuse,
        Nsample, Hnode+1, nu), as ``MBDPI.control_step`` takes it; without
        it the levels draw from the planner's generator.
        """
        Y = self.node_shift.shift(Y, shift_time)
        factors = self.mbdpi.diffuse_factors(n_diffuse)
        for i in range(n_diffuse):
            Y, info = self.mbdpi.reverse_once(state, Y, factors[i], None if eps is None else eps[i])
        us = self.mbdpi.node2u(Y)
        joint_targets = self.env.act2joint(us)
        taus = self.env.act2tau(us, state.pipeline_state)
        refs = info["xbar"][: self.n_acts, 1 : 1 + self._nb, :3]
        packed = torch.cat(
            [
                joint_targets[: self.n_acts].reshape(-1),
                taus[: self.n_acts].reshape(-1),
                refs.reshape(-1),
            ]
        ).to(torch.float32)
        return Y, packed

    # -- state injection (reference: dial_plan.py:141-155) ---------------------

    def _tensor(self, x) -> torch.Tensor:
        """A (1, n) tensor of the env's device and dtype from a host vector."""
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)[None]

    def init_state(self, q, qd):
        """The B = 1 planner state at (q, qd): the env's reset state with its
        pipeline state and observation taken at (q, qd)."""
        state = self.env.reset(torch.Generator(device=self.device).manual_seed(0))
        d = self.env.pipeline_init(self._tensor(q), self._tensor(qd))
        obs = self.env._get_obs(d, state.info)
        return state.replace(pipeline_state=d, obs=obs)

    def update_state(self, state, q, qd, t):
        """The measured (q, qd) and the step count at time t, written into the
        state; no forward pass (the rollouts' first step computes one)."""
        d = state.pipeline_state.replace(qpos=self._tensor(q), qvel=self._tensor(qd))
        info = dict(state.info)
        info["step"] = torch.full((1,), int(t / self.ctrl_dt), dtype=torch.int32, device=self.device)
        return state.replace(pipeline_state=d, info=info)

    # -- host loop -------------------------------------------------------------

    def read_bus(self, stop=False):
        """(measured state, bus time, stop) as rank 0 reads them from the bus
        and decides to stop; in a group, broadcast from rank 0 to every rank
        (one float64 tensor on the planner's device)."""
        nx = self.nq + self.nv
        if self.lead:
            x, t = self.bus.state.copy(), float(self.bus.time[0])
        if self.mesh is None:
            return x, t, stop
        packet = torch.zeros(nx + 2, dtype=torch.float64, device=self.device)
        if self.lead:
            packet.copy_(torch.from_numpy(np.concatenate([x, [t, float(stop)]]).astype(np.float64)))
        torch.distributed.broadcast(packet, src=0, group=self.mesh.group)
        host = packet.cpu().numpy()
        return host[:nx], float(host[nx]), bool(host[nx + 1])

    def main_loop(self, max_iters=None, verbose=True):
        """Tick until ``max_iters`` ticks (rank 0 decides; forever if None)."""
        verbose = verbose and self.lead
        latency = LatencyRecorder()
        x, last_plan_time, _ = self.read_bus()
        state = self.init_state(x[: self.nq], x[self.nq :])
        na, nu, nb = self.n_acts, self.nu, self._nb
        first_time = True
        iters = 0
        while True:
            t0 = time.time()
            x, plan_time, stop = self.read_bus(stop=max_iters is not None and iters >= max_iters)
            if stop:
                break
            state = self.update_state(state, x[: self.nq], x[self.nq :], plan_time)
            shift_time = plan_time - last_plan_time
            if shift_time > self.ctrl_dt + 1e-3 and verbose:
                print(f"[WARN] sim overtime {(shift_time - self.ctrl_dt) * 1000:.1f} ms")
            if shift_time > self.ctrl_dt * self.n_acts:
                if verbose:
                    print(
                        f"[WARN] long time unplanned {shift_time * 1000:.1f} ms,"
                        " reset control"
                    )
                self.Y = self.Y * 0.0
                shift_time = 0.0

            is_first = first_time
            first_time = False
            if is_first and verbose:
                print("First DIAL-MPC solve (Ndiffuse_init levels; builds the step kernel on first use)")
            n_diffuse = self.dial_config.Ndiffuse_init if is_first else self.dial_config.Ndiffuse
            self.Y, packed = self._plan(state, self.Y, shift_time, n_diffuse)

            # ONE device-to-host copy for everything the bus needs; it also
            # waits for the tick's device work (Y and the generator stay there)
            packed = packed.cpu().numpy()
            if self.lead:
                self.bus.acts[:] = packed[: na * nu].reshape(na, nu)
                self.bus.tau[:] = packed[na * nu : 2 * na * nu].reshape(na, nu)
                self.bus.refs[:, :nb, :] = packed[2 * na * nu :].reshape(na, nb, 3)
                self.bus.plan_time[0] = plan_time
            last_plan_time = plan_time
            iters += 1
            if self.checkpoint_path and iters % 250 == 0:
                self.save_checkpoint()
            if not is_first:
                # steady-state ticks only: the first runs Ndiffuse_init levels
                # and may build the kernel
                latency.add(time.time() - t0)
            if time.time() - t0 > self.ctrl_dt and verbose:
                print(f"[WARN] real overtime {(time.time() - t0) * 1000:.1f} ms")
        if verbose:
            print(latency.report("plan latency"))
        self.last_latency = latency.summary()

    def close(self):
        if self.bus is not None:
            self.bus.close()


def main(argv=None):
    parser = argparse.ArgumentParser()
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--config", type=str, default=None)
    group.add_argument("--example", type=str, default=None)
    group.add_argument("--list-examples", action="store_true")
    parser.add_argument("--custom-env", type=str, default=None)
    parser.add_argument(
        "--checkpoint",
        type=str,
        default=None,
        help="path of the periodic (Y, generator state) checkpoint; resumes if present",
    )
    parser.add_argument(
        "--device", type=str, default="cuda", help="cuda (default) or cpu; there is no fallback"
    )
    parser.add_argument(
        "--bus-prefix", type=str, default="", help="prefix of the bus's segment names (the sim server's)"
    )
    parser.add_argument("--ticks", type=int, default=None, help="stop after this many ticks (default: never)")
    args = parser.parse_args(argv)

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

    # a group under torchrun (its variables set), else a single process
    started = distributed.init_distributed(device=args.device)
    device = require_device(args.device)
    dial_config = load_dataclass_from_dict(DialConfig, config_dict)
    env_config_type = dial_envs.get_config(dial_config.env_name)
    env_config = load_dataclass_from_dict(
        env_config_type, config_dict, convert_list_to_array=True, device=device
    )
    env = dial_envs.get_environment(dial_config.env_name, env_config, device=device)

    publisher = MBDPublisher(
        env,
        env_config,
        dial_config,
        checkpoint_path=args.checkpoint,
        sharding=config_dict.get("sharding", "none"),
        bus_prefix=args.bus_prefix,
    )
    try:
        publisher.main_loop(max_iters=args.ticks)
    except KeyboardInterrupt:
        pass
    finally:
        publisher.save_checkpoint()
        publisher.close()
        if started:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
