"""Plugin hook interface (PluginBase), registry (PluginFactory) and the
observer plugins (the counterpart of ls1_mardyn_tpu/plugins): the
writers (writers.py) and the diagnostics (diagnostics.py).  The other
plugins of the JAX package's registry come with ROADMAP slice 6b; the
driver refuses a config that names one (driver.LATER_PLUGINS)."""

from ls1_mardyn_tpu_torch.plugins.base import PluginBase, PluginFactory  # noqa: F401
from ls1_mardyn_tpu_torch.plugins import writers  # noqa: F401  (registers)
from ls1_mardyn_tpu_torch.plugins import diagnostics  # noqa: F401
