"""The JAX package's outputs on fixed inputs, stored as data.

The port's tests hold it against the JAX package, the frozen reference. Where
the reference's inputs are fixed (seeded batches, fixed ctrls, the shipped
YAMLs), its float64 CPU outputs never change: tests/reference_data/generate.py
computes them once into tests/reference_data/<name>.npz, and the tests load
the arrays instead of compiling the JAX programs again. The slow test
tests/test_torch_reference_data.py computes every file anew and requires it
bit-equal to the stored one.

Each file's function lives beside the tests that read it (FILES), runs under
the conftest environment (CPU, x64, XLA engine) and returns a flat dict of
numpy arrays. Keys that start with ``in.`` are the inputs the function was
given; ``load`` checks them against the inputs the tests make now, so a
change to the port's seeded inputs asks for the data to be made again
instead of comparing against another batch's outputs.
"""

import functools
import importlib
import os

import numpy as np

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "reference_data")

# name -> (module, function, argument)
FILES = {
    **{f"physics_{key}": ("tests.test_torch_physics", "jax_scene_reference", key)
       for key in ("go2", "h1_walk", "h1_loco", "go2_crate", "h1_push_crate", "allegro")},
    "solver_go2_rows": ("tests.test_torch_solver", "jax_go2_rows_reference", None),
    "solver_synthetic": ("tests.test_torch_solver", "jax_synthetic_reference", None),
    "solver_elliptic": ("tests.test_torch_solver", "jax_elliptic_reference", None),
    "planner_seq_jump_reset": ("tests.test_torch_planner", "jax_seq_jump_reset_reference", None),
    **{f"planner_float64_{example}": ("tests.test_torch_envs", "jax_float64_reference", example)
       for example in ("unitree_h1_loco", "unitree_go2_crate_climb")},
    "deploy_schedule": ("tests.test_torch_deploy", "jax_schedule_reference", None),
    "parallel_sharded": ("tests.test_torch_parallel", "jax_sharded_reference", None),
}


def path(name, directory=DATA_DIR):
    return os.path.join(directory, name + ".npz")


def build(name):
    """The file's arrays, computed now from the JAX package."""
    module, function, arg = FILES[name]
    fn = getattr(importlib.import_module(module), function)
    arrays = fn() if arg is None else fn(arg)
    return {k: np.asarray(v) for k, v in arrays.items()}


def save(name, arrays, directory=DATA_DIR):
    os.makedirs(directory, exist_ok=True)
    np.savez_compressed(path(name, directory), **arrays)


@functools.lru_cache(maxsize=None)
def _stored(name):
    p = path(name)
    assert os.path.exists(p), f"missing {p}; run python tests/reference_data/generate.py {name}"
    with np.load(p) as z:
        return {k: z[k] for k in z.files}


def load(name, **inputs):
    """The stored arrays of a file, once ``inputs`` (given without the
    ``in.`` prefix) are shown equal, bit for bit, to those it was made from."""
    stored = _stored(name)
    for k, v in inputs.items():
        want = stored.get("in." + k)
        v = np.asarray(v)
        assert want is not None and bit_equal(v, want), (
            f"{name}: input {k} is not the one the stored outputs were made from; "
            f"run python tests/reference_data/generate.py {name}"
        )
    return stored


def bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def flat(prefix, tree, out=None):
    """A nested dict's leaves as ``prefix.a.b`` -> array (None leaves left out)."""
    out = {} if out is None else out
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(f"{prefix}.{k}", v, out)
        elif v is not None:
            out[f"{prefix}.{k}"] = np.asarray(v)
    return out


def nested(arrays, prefix):
    """The arrays under ``prefix.`` as a nested dict (``prefix.a.b`` -> d[a][b])."""
    out = {}
    for k, v in arrays.items():
        if k.startswith(prefix + "."):
            *parents, leaf = k[len(prefix) + 1 :].split(".")
            d = out
            for p in parents:
                d = d.setdefault(p, {})
            d[leaf] = v
    return out
