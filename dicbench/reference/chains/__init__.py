"""One module a sequence mode, named <deformation>_<reference> in lower
case: run(pair_solver, frames, pairs, num_params) -> {params, chi,
iterations, error} as NumPy arrays [pairs, S, ...]."""
