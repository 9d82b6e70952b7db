"""Tools of the port: measurement scripts, which run on a CUDA device, and
the synthetic scene writer."""
