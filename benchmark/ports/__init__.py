"""How the port runs each model family: its model configuration and its
parameter tree, built from a configuration file and the benchmark's
weights. The only modules of the harness besides the drivers that import
the port."""
