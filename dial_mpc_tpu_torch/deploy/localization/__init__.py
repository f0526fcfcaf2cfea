"""Localization plugin registry with lazy builtin discovery.

The port's own copy of ``dial_mpc_tpu/deploy/localization`` (the port
imports nothing of the JAX package). API parity with the reference (dial_mpc/deploy/localization/__init__.py):
``register_plugin(name, plugin_cls=... | module_path=...)``,
``load_plugin(name)``, ``get_available_plugins()``. Builtin plugin modules
in this package are discovered lazily so optional dependencies (rclpy,
pyvicon) are only imported when a plugin is actually loaded.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import pkgutil
import threading

plugin_registry: dict = {}
_registry_lock = threading.Lock()


def get_available_plugins():
    with _registry_lock:
        return list(plugin_registry.keys())


def discover_builtin_plugins():
    plugin_path = os.path.dirname(__file__)
    for _, name, _ in pkgutil.iter_modules([plugin_path]):
        if name not in plugin_registry and name != "base_plugin":
            plugin_registry[name] = None  # lazy-load placeholder


discover_builtin_plugins()


def register_plugin(name, plugin_cls=None, module_path=None):
    from dial_mpc_tpu_torch.deploy.localization.base_plugin import (
        BaseLocalizationPlugin,
    )

    with _registry_lock:
        if name in plugin_registry:
            raise ValueError(f"Plugin {name!r} is already registered.")
        if plugin_cls is not None:
            if not issubclass(plugin_cls, BaseLocalizationPlugin):
                raise TypeError(
                    "plugin class must inherit from BaseLocalizationPlugin"
                )
            plugin_registry[name] = plugin_cls
        elif module_path is not None:
            spec = importlib.util.spec_from_file_location(name, module_path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            candidates = [
                attr
                for attr in vars(module).values()
                if isinstance(attr, type)
                and issubclass(attr, BaseLocalizationPlugin)
                and attr is not BaseLocalizationPlugin
            ]
            if len(candidates) != 1:
                raise AttributeError(
                    f"module {module_path!r} must define exactly one "
                    "BaseLocalizationPlugin subclass"
                )
            plugin_registry[name] = candidates[0]
        else:
            raise ValueError("provide either plugin_cls or module_path")


def load_plugin(plugin_name):
    from dial_mpc_tpu_torch.deploy.localization.base_plugin import (
        BaseLocalizationPlugin,
    )

    with _registry_lock:
        plugin_cls = plugin_registry.get(plugin_name)
        if plugin_cls is None:
            if plugin_name not in plugin_registry:
                print(f"Plugin {plugin_name!r} is not registered.")
                return None
            try:
                module = importlib.import_module(
                    f".{plugin_name}", package=__package__
                )
            except ImportError as e:
                print(f"Failed to import plugin {plugin_name!r}: {e}")
                return None
            candidates = [
                attr
                for attr in vars(module).values()
                if isinstance(attr, type)
                and issubclass(attr, BaseLocalizationPlugin)
                and attr is not BaseLocalizationPlugin
            ]
            if len(candidates) != 1:
                print(
                    f"Plugin module {plugin_name!r} must contain exactly one "
                    "plugin class."
                )
                return None
            plugin_cls = candidates[0]
            plugin_registry[plugin_name] = plugin_cls
    return plugin_cls
