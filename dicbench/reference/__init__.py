"""The plain reference of the benchmark (solver.py) and its sequence
chains (chains/<deformation>_<reference>.py, found by the mix's modes).
Imports neither jax nor anything of the program."""
