"""Localization plugin ABI (kept verbatim from the reference:
dial_mpc/deploy/localization/base_plugin.py:4-22)."""

from typing import Any, Dict


class BaseLocalizationPlugin:
    def __init__(self, config: Dict[str, Any]):
        self.config = config

    def get_state(self):
        """Base qpos (3+4) and qvel (3+3) as a 1D array of size 13, or None
        if no update has been received. ALL VELOCITIES IN WORLD FRAME."""
        raise NotImplementedError

    def get_last_update_time(self):
        """Timestamp (float) of the last update, or None. Used as the
        staleness watchdog by the consumer."""
        raise NotImplementedError
