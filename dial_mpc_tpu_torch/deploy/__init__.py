"""Asynchronous deploy runtime: the shm bus, the planner process, the sim
server, the real-robot host and their launchers.

The planner (``planner_proc``) runs on the card; the sim server and the
real-robot host step ``mujoco`` and run where it is installed.
"""
