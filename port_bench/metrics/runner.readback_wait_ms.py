"""Runner layer (``core/runner.py``'s loop): the host's wait per control
step from ``control_step``'s return to the end of the one readback, the mean
over the measured window's steps, in milliseconds."""


def read(data):
    if not data.readback_s:
        return None
    return 1000.0 * sum(data.readback_s) / len(data.readback_s)
