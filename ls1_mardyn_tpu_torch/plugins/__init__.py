"""Plugin hook interface (PluginBase) and registry (PluginFactory).
No plugin is ported yet: the writers come with ROADMAP slice 6."""

from ls1_mardyn_tpu_torch.plugins.base import PluginBase, PluginFactory  # noqa: F401
