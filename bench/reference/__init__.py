"""Plain NumPy reference of the deployments the benchmark serves. It imports
nothing of the program; the builders here are frozen copies of the port's
host builders, kept apart so that no change to the program can move them."""
