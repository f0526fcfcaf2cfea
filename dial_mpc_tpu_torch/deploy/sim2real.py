"""sim2real launcher: real-robot driver + planner as subprocesses.

The reference declares a ``dial-mpc-sim2real`` console script pointing at a
module that does not exist (reference setup.py:27); this implements it.

    python -m dial_mpc_tpu_torch.deploy.sim2real --example unitree_go2_trot_deploy
"""

from __future__ import annotations

import subprocess
import sys
import time


def main(args=None):
    argv = sys.argv[1:] if args is None else args
    real = subprocess.Popen(
        [sys.executable, "-m", "dial_mpc_tpu_torch.deploy.real"] + argv
    )
    time.sleep(2.0)
    plan = subprocess.Popen(
        [sys.executable, "-m", "dial_mpc_tpu_torch.deploy.planner_proc"] + argv
    )
    try:
        plan.wait()
    except KeyboardInterrupt:
        pass
    finally:
        for p in (plan, real):
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()


if __name__ == "__main__":
    main()
