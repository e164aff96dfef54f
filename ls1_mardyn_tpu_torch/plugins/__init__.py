"""Plugin hook interface (PluginBase), registry (PluginFactory) and the
plugins ported so far (the counterpart of ls1_mardyn_tpu/plugins): the
writers (writers.py) and diagnostics (diagnostics.py), the plugins that
change the state (nemd.py, nemd2.py, mettdeamon.py, extra.py), Widom
sampling (widom.py) and CavityWriter (ensemble/cavity.py).  The other
plugins of the JAX package's registry (the observers of ROADMAP slice
6b) are refused by the driver (driver.LATER_PLUGINS)."""

from ls1_mardyn_tpu_torch.plugins.base import PluginBase, PluginFactory  # noqa: F401
from ls1_mardyn_tpu_torch.plugins import writers  # noqa: F401  (registers)
from ls1_mardyn_tpu_torch.plugins import diagnostics  # noqa: F401
from ls1_mardyn_tpu_torch.plugins import nemd  # noqa: F401
from ls1_mardyn_tpu_torch.plugins import nemd2  # noqa: F401
from ls1_mardyn_tpu_torch.plugins import mettdeamon  # noqa: F401
from ls1_mardyn_tpu_torch.plugins import extra  # noqa: F401
from ls1_mardyn_tpu_torch.plugins import widom  # noqa: F401
from ls1_mardyn_tpu_torch.ensemble import cavity  # noqa: F401  (CavityWriter)
