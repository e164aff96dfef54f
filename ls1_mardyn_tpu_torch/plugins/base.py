"""Plugin base class and factory registry.

Hook points and call order follow the reference
(src/plugins/PluginBase.h:88-130; invoked from the main
loop at src/Simulation.cpp:986-1080, 1167).  Host-side plugins observe
device state; they should read back only at their own write frequency
to avoid forcing per-step syncs.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional


class PluginBase:
    """Subclass and override the hooks you need."""

    name: str = "PluginBase"

    def __init__(self, params: Optional[dict] = None):
        self.params = params or {}
        self.write_frequency = int(float(self.params.get("writefrequency", 1)))
        self.output_prefix = self.params.get("outputprefix", self.name)

    # lifecycle -----------------------------------------------------------
    def init(self, sim) -> None:  # PluginBase.h:69
        pass

    def site_wise_forces_fn(self, table, box):
        """The siteWiseForces hook slot (PluginBase.h:88-130): a
        `(mol, pp) -> (u, F [N,3], M [N,3])` force-field contribution
        (torch tensors on the state's device) that the engine adds
        inside every force evaluation, so that it enters U_pot and the
        integration like any other force; or None.  Called once when the
        engine is built, before init(sim)."""
        return None

    def finish(self, sim) -> None:  # PluginBase.h:139
        pass

    # per-step hooks --------------------------------------------------
    def before_event_new_timestep(self, sim, step: int) -> None:
        pass

    def before_forces(self, sim, step: int) -> None:
        pass

    def after_forces(self, sim, step: int) -> None:
        pass

    def end_step(self, sim, step: int) -> None:
        pass


class PluginFactory:
    """Name -> constructor registry (PluginFactory.cpp:79-128)."""

    _registry: Dict[str, Callable[[dict], PluginBase]] = {}

    @classmethod
    def register(cls, name: str):
        def deco(klass):
            cls._registry[name] = klass
            klass.name = name
            return klass

        return deco

    @classmethod
    def create(cls, name: str, params: dict) -> PluginBase:
        if name not in cls._registry:
            raise KeyError(
                f"unknown plugin {name!r}; registered: {sorted(cls._registry)}"
            )
        return cls._registry[name](params)
