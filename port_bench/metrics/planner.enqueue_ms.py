"""Planner layer (``core/dial_core.py::MBDPI.control_step``): host time per
control step inside ``control_step``, where it enqueues the levels, the
rollouts and their glue; the mean over the measured window's steps, in
milliseconds."""


def read(data):
    if not data.enqueue_s:
        return None
    return 1000.0 * sum(data.enqueue_s) / len(data.enqueue_s)
