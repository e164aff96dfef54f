"""Device ops: cell grid, global values, LRC, the RMM engine and the
CUDA kernel wrappers (cuda_lj, cuda_rebin)."""
