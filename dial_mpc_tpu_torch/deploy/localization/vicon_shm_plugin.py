"""Vicon motion-capture localization plugin (optional dependency: pyvicon).

Behavioral parity with the reference plugin (dial_mpc/deploy/localization/
vicon_shm_plugin.py:13-221): a background thread polls the Vicon
DataStream at ~100 Hz, finite-differences the pose for velocities, smooths
them with a 2nd-order Butterworth low-pass, and publishes the fused 13-d
state through a small shared-memory segment that the plugin proper reads.
"""

import struct
import threading
import time
from multiprocessing import shared_memory

import numpy as np
from scipy.signal import butter, lfilter, lfilter_zi
from scipy.spatial.transform import Rotation as R

from pyvicon_datastream import tools as vicon_tools

from dial_mpc_tpu_torch.deploy.localization.base_plugin import BaseLocalizationPlugin

_STATE_FMT = "13dd"  # qpos(7) + qvel(6) + timestamp
_STATE_SIZE = struct.calcsize(_STATE_FMT)
_SHM_NAME = "mocap_state_shm"


class ViconDemo:
    """Poll Vicon, estimate velocities, publish to mocap_state_shm."""

    def __init__(self, host, object_name, rate_hz=100.0, cutoff_hz=10.0):
        self.tracker = vicon_tools.ObjectTracker(host)
        self.object_name = object_name
        self.rate = rate_hz
        self.dt = 1.0 / rate_hz
        b, a = butter(2, cutoff_hz / (rate_hz / 2.0))
        self._ba = (b, a)
        self._zi = [lfilter_zi(b, a) * 0.0 for _ in range(6)]
        self.shm = shared_memory.SharedMemory(
            name=_SHM_NAME, create=True, size=_STATE_SIZE
        )
        self._last = None
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _loop(self):
        b, a = self._ba
        while not self._stop.is_set():
            t0 = time.time()
            res = self.tracker.get_position(self.object_name)
            if res:
                _, _, segments = res
                if segments:
                    seg = segments[0]
                    pos = np.array(seg[2:5]) / 1000.0  # mm -> m
                    quat_xyzw = np.array(seg[5:9])
                    quat = np.array(
                        [quat_xyzw[3], quat_xyzw[0], quat_xyzw[1], quat_xyzw[2]]
                    )
                    now = time.time()
                    if self._last is not None:
                        lp, lq, lt = self._last
                        dt = max(now - lt, 1e-4)
                        linvel = (pos - lp) / dt
                        drot = (
                            R.from_quat(quat_xyzw) * R.from_quat(lq).inv()
                        ).as_rotvec() / dt
                        vel = np.concatenate([linvel, drot])
                        filt = np.zeros(6)
                        for i in range(6):
                            y, self._zi[i] = lfilter(
                                b, a, [vel[i]], zi=self._zi[i]
                            )
                            filt[i] = y[0]
                        state = np.concatenate([pos, quat, filt])
                        self.shm.buf[:_STATE_SIZE] = struct.pack(
                            _STATE_FMT, *state, now
                        )
                    self._last = (pos, quat_xyzw, now)
            elapsed = time.time() - t0
            if elapsed < self.dt:
                time.sleep(self.dt - elapsed)

    def close(self):
        self._stop.set()
        self.thread.join(timeout=1.0)
        self.shm.close()
        self.shm.unlink()


class ViconPlugin(BaseLocalizationPlugin):
    def __init__(self, config):
        super().__init__(config)
        self.shm = shared_memory.SharedMemory(name=_SHM_NAME, create=False)

    def get_state(self):
        vals = struct.unpack(_STATE_FMT, bytes(self.shm.buf[:_STATE_SIZE]))
        if vals[-1] == 0.0:
            return None
        return np.array(vals[:13])

    def get_last_update_time(self):
        vals = struct.unpack(_STATE_FMT, bytes(self.shm.buf[:_STATE_SIZE]))
        return vals[-1] if vals[-1] > 0.0 else None
