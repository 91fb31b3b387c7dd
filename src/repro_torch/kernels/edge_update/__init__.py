"""B9 and B5: the dense and the packed lane-ordered edge writes (kernel.cu,
ref.py, ops.py). As in the JAX package, no path calls them: the mutation
engines write both mirrors themselves (ROADMAP.md queue C, "Missing
mirror")."""
