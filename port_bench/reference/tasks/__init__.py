"""The reference's tasks, one module each: ``tasks/<env_name>.py`` holds a
class ``Task`` (built on ``port_bench.reference.task.BaseTask``) for the
configurations whose ``env_name`` it is. A task of a new env is a new file
here; no file that exists is edited."""

from __future__ import annotations

import importlib.util
import os

import torch

TASKS_DIR = os.path.dirname(os.path.abspath(__file__))


def task_class(env_name: str, tasks_dir: str = TASKS_DIR):
    """The ``Task`` class of ``<tasks_dir>/<env_name>.py``."""
    path = os.path.join(tasks_dir, f"{env_name}.py")
    if not os.path.exists(path):
        known = sorted(f[:-3] for f in os.listdir(tasks_dir) if f.endswith(".py") and f != "__init__.py")
        raise ValueError(f"the reference has no task {env_name!r} (no {path}); known: {known}")
    spec = importlib.util.spec_from_file_location(f"port_bench_task_{env_name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Task


def make_task(config: dict, device="cpu", dtype=torch.float64, tasks_dir: str = TASKS_DIR):
    """The task of a configuration's ``env_name``."""
    return task_class(config["env_name"], tasks_dir)(config, device, dtype)
