"""Physics layer (``BaseEnv.pipeline_step`` -> ``physics/engine_cuda.py::
step_core`` -> ``csrc/engine_step.cu``): the device time per control step of
every operation launched inside a ``physics`` span of the traced stretch, in
milliseconds."""


def read(data):
    t = data.traced
    s = data.physics_device_s()
    if s <= 0.0:
        return None
    return 1000.0 * s / t.steps
