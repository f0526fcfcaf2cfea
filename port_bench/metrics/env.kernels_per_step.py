"""Task env layer (``envs/*``, ``envs/base_env.py``): the device kernels a
control step of the traced stretch launched outside the ``physics`` span,
per step (the profiler's count)."""


def read(data):
    t = data.traced
    n = sum(1 for o in t.ops if o.cat == "kernel" and not o.in_physics)
    return n / t.steps
