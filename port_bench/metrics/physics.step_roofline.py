"""Physics layer: the share of the roofline, in percent. The least time of
the stretch's physics launches (each the larger of its operations over the
device's float32 peak and its bytes over its memory bandwidth; operations
and bytes from the frozen counts of ``harness/counts.py``) over the device
time of the operations inside the ``physics`` spans. None on a device kind
that ``harness/peaks.json`` does not list."""


def read(data):
    least = data.least_physics_s()
    s = data.physics_device_s()
    if least is None or s <= 0.0:
        return None
    return 100.0 * least / s
