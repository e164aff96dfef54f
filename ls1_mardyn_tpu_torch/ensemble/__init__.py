"""Ensembles: NVT/NVE bookkeeping lives in the step itself (thermostat
and global values); this package holds the grand-canonical machinery
(grand_canonical.py) and cavity sampling (cavity.py), the counterparts
of ls1_mardyn_tpu/ensemble."""
