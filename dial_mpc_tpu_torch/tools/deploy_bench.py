"""Deploy-tick latency: the asynchronous planner's tick against a static state
on the shm bus.

    python -m dial_mpc_tpu_torch.tools.deploy_bench [example] [ticks] [nsample]

Runs ``deploy.planner_proc.MBDPublisher.main_loop`` for ``ticks`` + 1 ticks
(default: unitree_go2_seq_jump_deploy, 300, the YAML's Nsample) on a bus this
script creates under segment names of its own (``shm.run_prefix``) and seeds
with the home keyframe, float32 on the card. The sim
host is replaced by that static state: a tick's cost does not depend on the
state's values, and the loop reads state and clock afresh every tick either
way. The first tick (Ndiffuse_init levels, the kernel's build) is left out of
every statistic, as ``MBDPublisher`` leaves it out of its own.

It prints one JSON object: the tick's host time (p50, p90, p99, max; measured
after the tick's one readback, which waits for the device), for the same
ticks the span of their device work between two CUDA events, the device's
busy time a tick summed over kernels by ``torch.profiler`` over a few more
ticks and its idle share of a tick's host time, the step kernel's launches,
and the card's name and power limit. It needs a CUDA device: every number is a device metric.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import numpy as np
import torch
import yaml

import dial_mpc_tpu_torch.envs as dial_envs
from dial_mpc_tpu_torch.core.dial_config import DialConfig
from dial_mpc_tpu_torch.deploy.planner_proc import MBDPublisher
from dial_mpc_tpu_torch.deploy.shm import ShmBus, run_prefix
from dial_mpc_tpu_torch.physics import engine_cuda
from dial_mpc_tpu_torch.utils.io_utils import get_example_path, load_dataclass_from_dict


def card() -> str:
    return subprocess.run(
        "nvidia-smi --query-gpu=name,power.limit --format=csv,noheader",
        shell=True, capture_output=True, text=True,
    ).stdout.strip()


def load_example(example, device="cuda", dtype=torch.float32, nsample=None):
    """(config_dict, dial_config, env_config, env) of a deploy example."""
    with open(get_example_path(example + ".yaml")) as f:
        config_dict = yaml.safe_load(f)
    dial_config = load_dataclass_from_dict(DialConfig, config_dict)
    if nsample is not None:
        dial_config = dataclasses.replace(dial_config, Nsample=nsample)
    env_config = load_dataclass_from_dict(
        dial_envs.get_config(dial_config.env_name), config_dict, convert_list_to_array=True,
        device=device, dtype=dtype,
    )
    env = dial_envs.get_environment(dial_config.env_name, env_config, device=device, dtype=dtype)
    return config_dict, dial_config, env_config, env


def static_bus(env, dial_config, prefix) -> ShmBus:
    """A bus created here (the actuation side's role) under segment names
    that start with ``prefix``, holding the home keyframe at rest and the
    clock at 0. Segments of those names that exist already are refused."""
    mj = env.mj_model
    bus = ShmBus(mj.nq + mj.nv, mj.nu, dial_config.Hsample + 1, create=True, prefix=prefix, reclaim=False)
    bus.state[:] = 0.0
    bus.state[: mj.nq] = mj.keyframe_qpos("home")
    return bus


def record_device_spans(pub: MBDPublisher) -> list:
    """Wrap ``pub._plan`` so that every call records a pair of CUDA events
    around the device work it enqueues; returns the list the pairs go into.
    The events add no synchronisation: the tick's readback already waits."""
    spans = []
    plan = pub._plan

    def timed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = plan(*args, **kwargs)
        end.record()
        spans.append((start, end))
        return out

    pub._plan = timed
    return spans


PROFILE_TICKS = 5


def device_busy_ms(pub: MBDPublisher, host_ms: float) -> dict:
    """Device time a warm tick, summed over its kernels by torch.profiler,
    over PROFILE_TICKS ticks of ``_plan`` and its readback from the bus's state,
    and the device's idle share of an untraced tick of ``host_ms`` (the
    profiler slows the host several times, so its own wall is no base)."""
    q, qd = pub.bus.state[: pub.nq].copy(), pub.bus.state[pub.nq :].copy()
    state = pub.update_state(pub.init_state(q, qd), q, qd, float(pub.bus.time[0]))
    Y = pub.Y
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILE_TICKS):
            Y, packed = pub._plan(state, Y, 0.0, pub.dial_config.Ndiffuse)
            packed.cpu()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / PROFILE_TICKS
    step_ms = sum(dev_us(e) for e in kernels if "engine_step_kernel" in e.key) / 1e3 / PROFILE_TICKS
    return dict(
        device_busy_ms=busy_ms, step_kernel_device_ms=step_ms,
        device_kernels_a_tick=sum(e.count for e in kernels) / PROFILE_TICKS,
        device_idle_share=1.0 - busy_ms / host_ms,
    )


def tick_stats(pub: MBDPublisher, spans: list) -> dict:
    """Host and device-span statistics of the warm ticks of the last main_loop."""
    s = pub.last_latency
    span_ms = np.array([a.elapsed_time(b) for a, b in spans[1:]])
    return dict(
        ticks=s["n"], host_ms_p50=s["p50_ms"], host_ms_p90=s["p90_ms"], host_ms_p99=s["p99_ms"],
        host_ms_max=s["max_ms"], device_span_ms_p50=float(np.percentile(span_ms, 50)),
        device_span_ms_max=float(span_ms.max()), first_tick_device_span_ms=spans[0][0].elapsed_time(spans[0][1]),
    )


def bench(example, ticks, nsample=None):
    _, dial_config, env_config, env = load_example(example, nsample=nsample)
    prefix = run_prefix()
    bus = static_bus(env, dial_config, prefix)
    try:
        pub = MBDPublisher(env, env_config, dial_config, bus_prefix=prefix)
        try:
            spans = record_device_spans(pub)
            launches0 = engine_cuda.step_core.launches
            pub.main_loop(max_iters=ticks + 1, verbose=False)
            launches = engine_cuda.step_core.launches - launches0
            out = dict(
                example=example, Nsample=dial_config.Nsample, Hsample=dial_config.Hsample,
                Ndiffuse=dial_config.Ndiffuse, Ndiffuse_init=dial_config.Ndiffuse_init,
                step_kernel_launches=launches, **tick_stats(pub, spans),
            )
            out.update(device_busy_ms(pub, out["host_ms_p50"]))
        finally:
            pub.close()
    finally:
        bus.close()
    out["card"] = card()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("example", nargs="?", default="unitree_go2_seq_jump_deploy")
    ap.add_argument("ticks", nargs="?", type=int, default=300)
    ap.add_argument("nsample", nargs="?", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("deploy_bench needs a CUDA device: every number it prints is a device metric")
    print(json.dumps(bench(args.example, args.ticks, args.nsample)), flush=True)


if __name__ == "__main__":
    main()
