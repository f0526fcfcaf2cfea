"""Lock-free shared-memory IPC bus between sim/real and the planner.

A copy of the JAX package's bus (``dial_mpc_tpu/deploy/shm.py``), kept
byte-for-byte compatible so that either package's sim server or robot host
can drive either package's planner: the same segment names, shapes, float32
last-writer-wins semantics and the plan_time timestamp convention
(reference: dial_mpc/deploy/dial_sim.py:82-123, dial_plan.py:91-134):

  time_shm       f32[1]                 sim/robot clock (writer: actuation side)
  state_shm      f32[nq+nv]             current [qpos, qvel]
  acts_shm       f32[Hsample+1, nu]     planned joint-position targets
  tau_shm        f32[Hsample+1, nu]     planned torques
  refs_shm       f32[Hsample+1, nu, 3]  predicted body positions (viz)
  plan_time_shm  f32[1]                 timestamp the current plan solves from

Each segment is allocated at its exact size; attach interoperates with a
producer that allocated more, since POSIX shm maps whatever exists.

With the default empty ``prefix`` these are the segments' names, as the JAX
package names them. A run that must not meet another run's bus on the same
host (a test, a benchmark) passes a prefix of its own (``run_prefix()``) to
both sides, and creates with ``reclaim=False``, so that a live segment of
another process is refused and never taken over.
"""

from __future__ import annotations

import os
import secrets
from multiprocessing import shared_memory

import numpy as np


def run_prefix() -> str:
    """A segment-name prefix unique to this run: the process id and random
    bits, so that runs in other process namespaces on one host differ too."""
    return f"dmpc{os.getpid()}_{secrets.token_hex(4)}_"


class ShmBus:
    """Owns (create=True) or attaches (create=False) the six segments.

    Attaching retries until the producer has created the segments
    (attach_timeout seconds), and unregisters attached segments from
    Python's multiprocessing resource tracker — otherwise a consumer
    process exiting would unlink the producer's live segments.

    ``prefix`` goes before each segment's name. A creator finding a segment
    of that name reclaims it (a crashed producer's leak) unless ``reclaim``
    is False: then it raises FileExistsError and unlinks what it created.
    """

    def __init__(
        self, nx: int, nu: int, n_acts: int, create: bool, attach_timeout: float = 30.0,
        prefix: str = "", reclaim: bool = True,
    ):
        import time as _time

        self._create = create
        self._segs = []

        def seg(name, shape):
            name = prefix + name
            size = int(np.prod(shape)) * 4
            if create:
                try:
                    s = shared_memory.SharedMemory(name=name, create=True, size=size)
                except FileExistsError:
                    if not reclaim:
                        raise
                    # reclaim a segment leaked by a crashed producer
                    stale = shared_memory.SharedMemory(name=name, create=False)
                    stale.close()
                    stale.unlink()
                    s = shared_memory.SharedMemory(name=name, create=True, size=size)
            else:
                deadline = _time.time() + attach_timeout
                while True:
                    try:
                        s = shared_memory.SharedMemory(
                            name=name, create=False, size=size
                        )
                        break
                    except FileNotFoundError:
                        if _time.time() > deadline:
                            raise
                        _time.sleep(0.2)
                try:  # consumers must never unlink the producer's segments
                    from multiprocessing import resource_tracker

                    resource_tracker.unregister(s._name, "shared_memory")
                except Exception:
                    pass
            self._segs.append(s)
            return np.ndarray(shape, dtype=np.float32, buffer=s.buf)

        try:
            self.time = seg("time_shm", (1,))
            self.state = seg("state_shm", (nx,))
            self.acts = seg("acts_shm", (n_acts, nu))
            self.tau = seg("tau_shm", (n_acts, nu))
            self.refs = seg("refs_shm", (n_acts, nu, 3))
            self.plan_time = seg("plan_time_shm", (1,))
        except BaseException:
            self.close()
            raise

    def close(self):
        for s in self._segs:
            s.close()
            if self._create:
                try:
                    s.unlink()
                except FileNotFoundError:
                    pass
