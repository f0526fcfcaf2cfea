"""Synchronous receding-horizon control loop.

Load a flat YAML into DialConfig + env config, build the env and planner,
run n_steps of receding-horizon control, dump artifacts:

    python -m dial_mpc_tpu_torch.core.runner --example unitree_go2_trot [--engine unfused] [--serve]
    torchrun --nproc-per-node N -m dial_mpc_tpu_torch.core.runner --example unitree_go2_trot

Each control step (MBDPI.control_step) only enqueues work on the device;
the host loop then reads ONE packed tensor back per step for telemetry. The
run is on the card unless the caller passes ``device="cpu"``.

With ``sharding: mesh`` in the config and a process group of more than one
rank (``torchrun``; ``parallel.init_distributed``), the planner is
``ShardedMBDPI``, the sample axis split over the ranks, each on its card
``cuda:LOCAL_RANK``; otherwise it is ``MBDPI``. Every rank runs the loop;
rank 0 alone prints, shows progress and writes the artifacts.
"""

from __future__ import annotations

import argparse
import http.server
import importlib
import os
import sys
import time

import numpy as np
import torch
import yaml

import dial_mpc_tpu_torch.envs as dial_envs
from dial_mpc_tpu_torch.core.dial_config import DialConfig
from dial_mpc_tpu_torch.core.dial_core import MBDPI
from dial_mpc_tpu_torch.envs.base_env import ENGINES, require_device
from dial_mpc_tpu_torch.examples import examples
from dial_mpc_tpu_torch.parallel import ShardedMBDPI, distributed, global_sample_mesh
from dial_mpc_tpu_torch.utils.io_utils import get_example_path, load_dataclass_from_dict
from dial_mpc_tpu_torch.utils.telemetry import LatencyRecorder


def pack_telemetry(state, u_exec, info) -> torch.Tensor:
    """All per-step telemetry as one flat tensor: a single readback."""
    ps = state.pipeline_state
    return torch.cat(
        [
            ps.qpos[0],
            ps.qvel[0],
            ps.ctrl[0],
            u_exec,
            state.reward,
            info["rews"][-1].mean()[None],
            info["n_dropped"].sum()[None].to(ps.qpos.dtype),
            info["xbar"][-1].reshape(-1),
        ]
    )


def run(config_dict, progress=True, device="cuda", dtype=torch.float32, engine="fused", serve=False):
    """Run the sync receding-horizon loop; returns a summary dict.

    ``engine`` is the env's physics route: ``"fused"`` (the whole-step
    kernel) or ``"unfused"`` (stage by stage, the solve on its own kernel).
    ``serve`` serves the HTML viewer at :5000 after the run, until Ctrl-C.
    """
    device = require_device(device)
    dial_config = load_dataclass_from_dict(DialConfig, config_dict)
    generator = torch.Generator(device=device).manual_seed(dial_config.seed)

    env_config_type = dial_envs.get_config(dial_config.env_name)
    env_config = load_dataclass_from_dict(
        env_config_type, config_dict, convert_list_to_array=True, device=device, dtype=dtype
    )
    env = dial_envs.get_environment(
        dial_config.env_name, env_config, device=device, dtype=dtype, engine=engine
    )
    # sharding: "none" (one device) or "mesh" (the sample axis over every
    # rank of the process group; one rank plans as "none" does)
    if config_dict.get("sharding", "none") == "mesh" and distributed.world_size() > 1:
        mbdpi = ShardedMBDPI(dial_config, env, global_sample_mesh(), generator)
    else:
        mbdpi = MBDPI(dial_config, env, generator)
    lead = distributed.rank() == 0

    state = env.reset(generator)
    Y0 = torch.zeros(dial_config.Hnode + 1, mbdpi.nu, device=device, dtype=dtype)

    rollout_states = []
    ctrls = []
    rews = []
    rews_plan = []
    dropped = []
    predictions = []
    freqs = []
    latency = LatencyRecorder()

    try:
        from tqdm import tqdm

        iterator = tqdm(range(dial_config.n_steps), desc="Rollout", disable=not (progress and lead))
    except ImportError:  # pragma: no cover
        iterator = range(dial_config.n_steps)

    nq, nv, nu = env.mj_model.nq, env.mj_model.nv, env.mj_model.nu
    xbar_shape = (dial_config.Hsample + 1, env.mj_model.nbody - 1, 3)

    for t in iterator:
        n_diffuse = dial_config.Ndiffuse_init if t == 0 else dial_config.Ndiffuse
        u_exec = Y0[0]
        t0 = time.time()
        state, Y0, info = mbdpi.control_step(state, Y0, n_diffuse)
        # the one readback of the step; it also waits for the device
        host = pack_telemetry(state, u_exec, info).cpu().numpy()
        elapsed = time.time() - t0

        o = 0
        qpos_h = host[o : o + nq]; o += nq
        qvel_h = host[o : o + nv]; o += nv
        ctrl_h = host[o : o + nu]; o += nu
        u_h = host[o : o + nu]; o += nu
        reward_h = host[o]; o += 1
        rew_plan_h = host[o]; o += 1
        dropped_h = host[o]; o += 1
        xbar_h = host[o:].reshape(xbar_shape)
        rollout_states.append((qpos_h, qvel_h, ctrl_h))
        ctrls.append(u_h)
        rews.append(float(reward_h))
        rews_plan.append(float(rew_plan_h))
        dropped.append(int(dropped_h))
        predictions.append(xbar_h)
        freqs.append(1.0 / max(elapsed, 1e-9))
        if t > 0:  # the first step runs Ndiffuse_init levels and builds the kernel
            latency.add(elapsed)
        if hasattr(iterator, "set_postfix") and lead:
            iterator.set_postfix({"rew": f"{rews[-1]:.2e}", "freq": f"{freqs[-1]:.2f}"})

    mean_rew = float(np.mean(rews))
    states_path = predictions_path = html_path = None
    if lead:
        print(f"mean reward = {mean_rew:.2e}")
        print(latency.report("solve latency"))

        # ---- artifacts: (step, qpos, qvel, ctrl) rows, predicted body positions, viewer ----
        os.makedirs(dial_config.output_dir, exist_ok=True)
        timestamp = time.strftime("%Y%m%d-%H%M%S")
        data = np.array(
            [np.concatenate([[i], q, qd, ctrl]) for i, (q, qd, ctrl) in enumerate(rollout_states)]
        )
        xdata = np.array(predictions)
        states_path = os.path.join(dial_config.output_dir, f"{timestamp}_states.npy")
        predictions_path = os.path.join(dial_config.output_dir, f"{timestamp}_predictions.npy")
        np.save(states_path, data)
        np.save(predictions_path, xdata)
        html_path = write_viewer(env, data[:, 1 : 1 + nq], dial_config.output_dir, timestamp, states_path)
        if serve and html_path:
            serve_html(html_path)

    return {
        "mean_reward": mean_rew,
        "rews": rews,
        "rews_plan": rews_plan,
        "rollouts_dropped": dropped,  # a step's rollouts of non-finite reward, over its levels
        "freqs": freqs,
        "latency": latency.summary(),
        "states_path": states_path,
        "predictions_path": predictions_path,
        "html_path": html_path,
        "planner": type(mbdpi).__name__,
        "state": state,  # the last env State (on the run's device)
    }


def write_viewer(env, qpos, output_dir, timestamp, states_path):
    """The HTML trajectory viewer of the qpos rows; returns its path, or None
    where the ``mujoco`` package it needs is not installed (then it says so).
    Any other error of the viewer is raised."""
    path = os.path.join(output_dir, f"{timestamp}_visualization.html")
    try:
        env.render_html(qpos, path, fps=50.0)
    except ModuleNotFoundError as e:
        if e.name != "mujoco":
            raise
        print(f"the HTML viewer needs the mujoco package, which is not installed; the states are in {states_path}")
        return None
    print(f"visualization written to {path}")
    return path


def serve_html(path, port=5000):
    """Serve one HTML file at http://localhost:<port> until Ctrl-C."""
    server = http.server.HTTPServer(("", port), html_handler(path))
    print(f"serving visualization at http://localhost:{port} (Ctrl-C to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


def html_handler(path):
    """A request handler that answers every GET with the file at ``path``."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            with open(path, "rb") as f:
                body = f.read()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser()
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--config", type=str, default=None)
    group.add_argument("--example", type=str, default=None)
    group.add_argument("--list-examples", action="store_true")
    parser.add_argument(
        "--custom-env", type=str, default=None,
        help="import path of a module that self-registers envs",
    )
    parser.add_argument(
        "--device", type=str, default="cuda", help="cuda (default) or cpu; there is no fallback"
    )
    parser.add_argument(
        "--engine", type=str, default="fused", choices=ENGINES,
        help="fused: the whole-step kernel; unfused: stage by stage with the solver kernel",
    )
    parser.add_argument(
        "--serve", action="store_true", help="serve the HTML viewer at :5000 after the run"
    )
    args = parser.parse_args(argv)

    if args.list_examples:
        print("Examples:")
        for example in examples:
            print(f"  {example}")
        return

    if args.custom_env is not None:
        sys.path.append(os.getcwd())
        importlib.import_module(args.custom_env)

    if args.example is not None:
        config_path = get_example_path(args.example + ".yaml")
    else:
        config_path = args.config
    with open(config_path) as f:
        config_dict = yaml.safe_load(f)

    # a group under torchrun (its variables set), else a single process
    started = distributed.init_distributed(device=args.device)
    try:
        run(config_dict, device=args.device, engine=args.engine, serve=args.serve)
    finally:
        if started:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
