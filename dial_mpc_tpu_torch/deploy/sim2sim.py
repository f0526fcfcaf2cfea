"""sim2sim launcher: run the sim server and planner as subprocesses.

Counterpart of dial_mpc/core/dial_sim2sim.py:6-12 — with the reference's
bug fixed: the sim is launched in the background (the reference blocked on
the first subprocess), and both processes are torn down on Ctrl-C.

    python -m dial_mpc_tpu_torch.deploy.sim2sim --example unitree_go2_trot_deploy
"""

from __future__ import annotations

import subprocess
import sys
import time


def main(args=None):
    argv = sys.argv[1:] if args is None else args
    sim = subprocess.Popen(
        [sys.executable, "-m", "dial_mpc_tpu_torch.deploy.sim_server"] + argv
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
        for p in (plan, sim):
            if p.poll() is None:
                p.terminate()
                try:
                    p.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    p.kill()


if __name__ == "__main__":
    main()
